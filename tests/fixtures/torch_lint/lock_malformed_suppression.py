"""Lint fixture: an LCK suppression WITHOUT a reason is itself a violation.

Never imported — checked by a dedicated test in
tests/test_torch_lock_rules.py (not the annotation table): the reasonless
disable comment below must produce LNT001 on its own line AND fail to
silence the LCK002 it tried to cover.
"""

import threading


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def locked_add(self, n):
        with self._lock:
            self.total += n

    def racy_add(self, n):
        self.total += n  # lint: disable=LCK002
