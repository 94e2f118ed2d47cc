"""Lint fixture: lock-order & shared-state safety (LCK001–LCK002).

Never imported — linted as source by tests/test_torch_lock_rules.py (through both packages).  The
two classes are independent lock graphs: ``Pair`` holds the A->B / B->A
cycle, ``Counter`` the mixed locked/unlocked attribute mutation.
"""

import threading


class Pair:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
        self.value = 0

    def forward(self):
        with self._a:
            with self._b:
                self.value += 1

    def backward(self):
        with self._b:
            with self._a:  # expect: LCK001
                self.value -= 1


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0
        self.label = ""

    def locked_add(self, n):
        with self._lock:
            self.total += n

    def racy_add(self, n):
        self.total += n  # expect: LCK002

    def rename(self, label):
        # Only ever assigned outside the lock: single-writer attribute,
        # not flagged (the rule needs BOTH locked and unlocked sites).
        self.label = label
