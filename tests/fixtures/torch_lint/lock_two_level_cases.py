"""Lint fixture: second-level call resolution + context-managed callees
(the LCK001 resolution the runtime sanitizer relies on).

Never imported — linted as source by tests/test_torch_lock_rules.py (through both packages).

``Ring``/``Driver`` form a cycle only visible at TWO call levels: Ring's
flush holds Ring._lock and calls ``DRV.commit``, whose own helper
``commit_impl`` takes Driver._lock (level 2), while Driver's exchange
holds Driver._lock and calls ``RING.inner_acquire`` (level 1).

``Gate`` forms a cycle only through a CONTEXT-MANAGED callee: ``forward``
enters ``self.locked_ops()`` as a with-item — holding Gate._lock for the
body exactly like the plain-call form — then takes Gate._state, while
``backward`` nests the opposite way.

``Pipeline`` is the negative: the same two-level resolution in one
consistent order must stay quiet.
"""

import threading


class Ring:
    def __init__(self):
        self._lock = threading.Lock()

    def inner_acquire(self):
        with self._lock:
            pass

    def flush(self):
        with self._lock:
            DRV.commit()  # expect: LCK001


class Driver:
    def __init__(self):
        self._lock = threading.Lock()

    def commit_impl(self):
        with self._lock:
            pass

    def commit(self):
        self.commit_impl()

    def exchange(self):
        with self._lock:
            RING.inner_acquire()


class Gate:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = threading.Lock()

    def locked_ops(self):
        with self._lock:
            return object()

    def forward(self):
        with self.locked_ops():
            with self._state:
                pass

    def backward(self):
        with self._state:
            with self._lock:  # expect: LCK001
                pass


class Pipeline:
    def __init__(self):
        self._lock = threading.Lock()

    def stage_impl(self):
        with self._lock:
            pass

    def stage(self):
        self.stage_impl()

    def run(self):
        with OUTER:
            DRIVE.stage()  # consistent OUTER -> Pipeline._lock order only


OUTER = threading.Lock()
RING = Ring()
DRV = Driver()
DRIVE = Pipeline()
