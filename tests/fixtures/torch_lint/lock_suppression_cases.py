"""Lint fixture: LCK suppressions honored when they carry a reason.

Never imported — linted as source by tests/test_torch_lock_rules.py
(through both packages).  Both unlocked mutations below are silenced by
reasoned suppressions (one inline, one on the standalone line above), so
the whole file must lint clean.
"""

import threading


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def locked_add(self, n):
        with self._lock:
            self.total += n

    def add_inline(self, n):
        self.total += n  # lint: disable=LCK002 -- fixture: callers hold _lock

    def add_above(self, n):
        # lint: disable=LCK002 -- fixture: a standalone suppression covers the next line
        self.total += n
