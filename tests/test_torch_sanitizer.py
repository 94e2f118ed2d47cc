"""The port's runtime concurrency sanitizer
(``orion_tpu_torch.analysis.sanitizer``) against ``orion_tpu``'s.

The same threaded fixture programs, their sizes drawn from a numpy seed,
run under each package's ``TSAN`` with the same explorer seed, one package
at a time (both patch ``threading.Lock``): both must report the same races
(cells and access kinds, the sites of both accesses), the same observed
lock-order edges and cycles, and the same count of forced switches.  The
port's own parts follow: the instrumented-lock and access counts, the
report merge across processes, the singletons it wraps (the step-graph
cache's lock among them), the disabled path, the env hook at package
import, and the ``torch_tsan`` marker over real port code — a ``tpu_bo``
bucket crossing on the CPU with the prewarmer's thread racing the round.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
from torch_tsan import torch_tsan_marked  # noqa: F401

from orion_tpu.analysis import sanitizer as ref_sanitizer
from orion_tpu_torch.analysis import sanitizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL_LOCK = threading.Lock


@pytest.fixture
def both():
    """Neither sanitizer on before or after; threading unpatched after."""
    assert not sanitizer.TSAN.enabled and not ref_sanitizer.TSAN.enabled
    yield
    for module in (sanitizer, ref_sanitizer):
        if module.TSAN.enabled:
            module.TSAN.disable()
    assert threading.Lock is REAL_LOCK
    assert threading.Lock is sanitizer._REAL_LOCK is ref_sanitizer._REAL_LOCK


def _run_threads(*targets):
    threads = [threading.Thread(target=t) for t in targets]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=30)
        assert not thread.is_alive()


# --- fixture programs: each takes the sanitizer under test and its sizes ---


class _Pair:
    """Two locks, acquirable in either order — the deadlock fixture."""

    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def forward(self):
        with self._a:
            with self._b:
                pass

    def backward(self):
        with self._b:
            with self._a:
                pass


class _Counters:
    """The tenant-counter pattern: bare increments against locked reads
    (``locked=False``, the race) or both under the lock (clean)."""

    def __init__(self, tsan, locked):
        self._lock = threading.Lock()
        self.tsan = tsan
        self.locked = locked
        self.value = 0

    def bump(self):
        if self.locked:
            with self._lock:
                self.tsan.write("counters.value", self)
                self.value += 1
        else:
            self.tsan.write("counters.value", self)
            self.value += 1

    def read(self):
        with self._lock:
            self.tsan.read("counters.value", self)
            return self.value


class _Reentrant:
    def __init__(self, tsan):
        self._lock = threading.RLock()
        self.tsan = tsan

    def outer(self):
        with self._lock:
            self.inner()

    def inner(self):
        with self._lock:
            self.tsan.write("cell.reentrant", self)


class _Queue:
    """A condition-guarded handoff: the notifier->waiter edge orders the
    consumer's read after the producer's write."""

    def __init__(self, tsan):
        self._cond = threading.Condition()
        self.tsan = tsan
        self.items = []

    def put(self, item):
        with self._cond:
            self.tsan.write("queue.items", self)
            self.items.append(item)
            self._cond.notify()

    def get(self):
        with self._cond:
            while not self.items:
                self._cond.wait(5)
            self.tsan.read("queue.items", self)
            return self.items.pop(0)


def _unlocked_writers(tsan, threads, iters):
    holder = {}

    def racer():
        for _ in range(iters):
            tsan.write("cell.racy", holder)

    _run_threads(*[racer] * threads)


def _locked_writers(tsan, threads, iters):
    lock = threading.Lock()
    holder = {}

    def worker():
        for _ in range(iters):
            with lock:
                tsan.write("cell.locked", holder)

    _run_threads(*[worker] * threads)


def _event_handoff(tsan, threads, iters):
    holder = {}
    event = threading.Event()

    def setter():
        tsan.write("cell.event", holder)
        event.set()

    def waiter():
        assert event.wait(5)
        for _ in range(iters):
            tsan.read("cell.event", holder)

    _run_threads(setter, *[waiter] * (threads - 1))


def _bare_handoff(tsan, threads, iters):
    holder = {}

    def setter():
        tsan.write("cell.bare", holder)

    def reader():
        for _ in range(iters):
            tsan.read("cell.bare", holder)

    _run_threads(setter, *[reader] * (threads - 1))


def _fork_join(tsan, threads, iters):
    holder = {}
    tsan.write("cell.fork", holder)

    def child():
        tsan.read("cell.fork", holder)

    for _ in range(threads):
        thread = threading.Thread(target=child)
        thread.start()
        thread.join(timeout=30)
    for _ in range(iters):
        tsan.write("cell.fork", holder)


def _counters(tsan, threads, iters, locked):
    counters = _Counters(tsan, locked)

    def dispatcher():
        for _ in range(iters):
            counters.bump()

    def handler():
        for _ in range(iters):
            counters.read()

    _run_threads(dispatcher, *[handler] * (threads - 1))


def _instance_cells(tsan, threads, iters):
    class _Conn:
        def touch(self):
            tsan.write("conn.state", self)

    def user():
        conn = _Conn()
        for _ in range(iters):
            conn.touch()

    _run_threads(*[user] * threads)


def _deadlock(tsan, threads, iters):
    pair = _Pair()
    for _ in range(iters):
        _run_threads(pair.forward)
        _run_threads(pair.backward)


def _consistent_order(tsan, threads, iters):
    pair = _Pair()
    _run_threads(*[pair.forward] * threads)


def _reentrant(tsan, threads, iters):
    obj = _Reentrant(tsan)
    _run_threads(*[obj.outer] * threads)


def _condition(tsan, threads, iters):
    queue = _Queue(tsan)

    def producer():
        for i in range(iters):
            queue.put(i)

    def consumer():
        for _ in range(iters):
            queue.get()

    _run_threads(consumer, producer)


PROGRAMS = {
    "unlocked_writers": _unlocked_writers,
    "locked_writers": _locked_writers,
    "event_handoff": _event_handoff,
    "bare_handoff": _bare_handoff,
    "fork_join": _fork_join,
    "racy_counters": lambda tsan, t, i: _counters(tsan, t, i, locked=False),
    "locked_counters": lambda tsan, t, i: _counters(tsan, t, i, locked=True),
    "instance_cells": _instance_cells,
    "deadlock": _deadlock,
    "consistent_order": _consistent_order,
    "reentrant": _reentrant,
    "condition": _condition,
}

#: Violations each program must show, on any schedule.
VIOLATIONS = {"unlocked_writers": 1, "bare_handoff": 1, "racy_counters": 1, "deadlock": 1}


def _normalized(report):
    """What must agree between the packages: races by (cell without its
    instance token, kind, sites), edges, cycles, switches.  Sites are
    compared as a set: which thread is ``a`` depends on the schedule."""
    races = sorted((re.sub(r"#\d+$", "", r["cell"]), r["kind"],
                    tuple(sorted((r["site_a"], r["site_b"])))) for r in report.races)
    return {
        "races": races,
        "edges": sorted((e["outer"], e["inner"]) for e in report.edges),
        "cycles": sorted(sorted(set(c["cycle"])) for c in report.cycles),
        "violations": report.violation_count(),
        "cells": sorted(re.sub(r"#\d+$", "", c) for c in report.cells),
    }


def test_interleaving_explorer_is_seeded_as_the_reference(both):
    """One seed, one forced-switch schedule: the same acquisitions draw the
    same switches in both packages, all of them at rate 1, none at 0."""
    counts = []
    for rate, module in ((0.5, ref_sanitizer), (0.5, sanitizer), (1.0, sanitizer),
                         (0.0, sanitizer)):
        module.TSAN.enable(seed=21, switch_rate=rate, switch_delay=0.0)
        lock = threading.Lock()
        for _ in range(40):
            with lock:
                pass
        counts.append(module.TSAN.disable().switches)
    assert counts[0] == counts[1] and 0 < counts[0] < 40
    assert counts[2:] == [40, 0]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_fixture_programs_report_as_the_reference(both, program, seed):
    rng = np.random.default_rng(seed)
    threads, iters = int(rng.integers(2, 5)), int(rng.integers(1, 5))
    tsan_seed, rate = int(rng.integers(0, 1000)), float(rng.choice([0.0, 0.5, 1.0]))
    out = []
    for module in (ref_sanitizer, sanitizer):
        module.TSAN.enable(seed=tsan_seed, switch_rate=rate, switch_delay=0.0)
        try:
            PROGRAMS[program](module.TSAN, threads, iters)
        finally:
            report = module.TSAN.disable()
        out.append(_normalized(report))
    assert out[0] == out[1]
    assert out[1]["violations"] == VIOLATIONS.get(program, 0)
    if program == "deadlock":
        assert out[1]["cycles"] == [["_Pair._a", "_Pair._b"]]
    if program == "consistent_order":
        assert out[1]["edges"] == [("_Pair._a", "_Pair._b")]


def test_disabled_path_leaves_threading_unpatched_and_takes_no_lock(both):
    """Off: the factories are the real ones and an annotation or a
    pre-acquire touches not even the sanitizer's own lock."""
    assert threading.Lock is sanitizer._REAL_LOCK
    assert threading.Event is sanitizer._REAL_EVENT
    assert threading.Thread.start is sanitizer._REAL_THREAD_START

    class _Tripwire:
        def __enter__(self):
            raise AssertionError("disabled sanitizer touched its lock")

        def __exit__(self, *exc):  # pragma: no cover
            return False

    real = sanitizer.TSAN._lock
    sanitizer.TSAN._lock = _Tripwire()
    try:
        sanitizer.TSAN.write("cell.x")
        sanitizer.TSAN.read("cell.x", sanitizer.TSAN)
        sanitizer.TSAN.pre_acquire()
    finally:
        sanitizer.TSAN._lock = real
    sanitizer.TSAN.enable(seed=0)
    with pytest.raises(RuntimeError):
        sanitizer.TSAN.enable(seed=1)
    assert threading.Lock is not REAL_LOCK
    sanitizer.TSAN.disable()
    assert threading.Lock is REAL_LOCK


def test_report_counts_instrumented_locks_and_annotated_accesses(both):
    import orion_tpu_torch.telemetry  # noqa: F401  (its registry's lock is a singleton)

    sanitizer.TSAN.enable(seed=0, switch_rate=0.0)
    _counters(sanitizer.TSAN, 2, 3, locked=True)
    report = sanitizer.TSAN.disable().to_dict()
    assert report["locks"]["_Counters._lock"] == 1
    assert report["accesses"] == 6
    assert report["locks"]["Telemetry._lock"] == 1  # a wrapped singleton
    assert json.loads(json.dumps(report)) == report


def test_singletons_are_wrapped_and_restored(both):
    """The port's import-time locks, the step-graph cache's and the
    compiler plane's among them, are wrapped under their static ids while
    enabled and restored after."""
    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS
    from orion_tpu_torch.compiler_plane import COMPILE_REGISTRY
    from orion_tpu_torch.diagnosis import watch
    from orion_tpu_torch.telemetry import TELEMETRY

    before = (TELEMETRY._lock, STEP_GRAPHS.lock, COMPILE_REGISTRY._lock, watch._last_lock)
    sanitizer.TSAN.enable(seed=0)
    try:
        keys = [lock.tsan_key for lock in (TELEMETRY._lock, STEP_GRAPHS.lock,
                                           COMPILE_REGISTRY._lock, watch._last_lock)]
        assert keys == ["Telemetry._lock", "StepGraphs.lock", "CompileRegistry._lock",
                        "watch._last_lock"]
    finally:
        sanitizer.TSAN.disable()
    assert (TELEMETRY._lock, STEP_GRAPHS.lock, COMPILE_REGISTRY._lock,
            watch._last_lock) == before


def test_shim_identities_are_the_lint_graphs_lock_ids():
    """Every lock the shims name after a ``self._x = threading.Lock()``
    site in the port is a lock id the static LCK graph knows: LCK003 can
    only cross-check edges whose endpoints both graphs name alike."""
    from orion_tpu_torch.analysis.engine import iter_python_files, load_module
    from orion_tpu_torch.analysis.lock_rules import known_lock_ids, project_index

    modules = [load_module(p)[0] for p in iter_python_files([os.path.join(ROOT,
                                                                          "orion_tpu_torch")])]
    known = known_lock_ids(project_index(modules))
    for key in ("Telemetry._lock", "FlightRecorder._lock", "StepGraphs.lock",
                "CompileRegistry._lock", "BucketPrewarmer._lock", "prewarm._completed_lock",
                "prewarm._prewarmers_lock", "history._registry_lock", "devmem._lock",
                "metrics._worker_lock", "watch._last_lock", "NetworkDB._lock",
                "DBServer._persist_lock", "MemoryDB._lock"):
        assert key in known, key


@pytest.mark.parametrize("seed", range(2))
def test_merged_report_is_the_union_of_the_processes(seed):
    """Two processes' reports merged: edges and races deduplicated, cells
    unioned, switches, accesses and lock counts summed."""
    rng = np.random.default_rng(seed)
    reports = []
    for _ in range(2):
        edges = [{"outer": f"L{a}", "inner": f"L{b}", "path": "p", "line": 1}
                 for a, b in rng.integers(0, 4, size=(3, 2)) if a != b]
        races = [{"cell": f"c{c}", "kind": "write/write", "site_a": "s", "site_b": "t",
                  "thread_a": 1, "thread_b": 2, "stack_a": [], "stack_b": []}
                 for c in rng.integers(0, 3, size=2)]
        reports.append(sanitizer.TsanReport(
            edges, races, {f"c{c}" for c in rng.integers(0, 5, size=3)},
            int(rng.integers(0, 9)), 7, {"A._lock": int(rng.integers(1, 3))},
            int(rng.integers(0, 50))).to_dict())
    merged = sanitizer.merge_report_dicts(sanitizer.merge_report_dicts(None, reports[0]),
                                          reports[1])
    assert merged["processes"] == 2
    assert {(e["outer"], e["inner"]) for e in merged["edges"]} == {
        (e["outer"], e["inner"]) for r in reports for e in r["edges"]}
    assert {r["cell"] for r in merged["races"]} == {x["cell"] for r in reports
                                                    for x in r["races"]}
    assert len(merged["races"]) == len({x["cell"] for r in reports for x in r["races"]})
    assert set(merged["cells"]) == set(reports[0]["cells"]) | set(reports[1]["cells"])
    for key in ("switches", "accesses"):
        assert merged[key] == reports[0][key] + reports[1][key]
    assert merged["locks"] == {"A._lock": reports[0]["locks"]["A._lock"]
                               + reports[1]["locks"]["A._lock"]}


def test_env_hook_at_import_instruments_and_every_process_merges_its_report(tmp_path):
    """``ORION_TPU_TSAN=1``: importing ``orion_tpu_torch`` enables the
    sanitizer before any subsystem makes its locks, and each process of the
    run (here a parent and the child it starts with the same env) merges
    its report into ``ORION_TPU_TSAN_REPORT`` at exit."""
    script = tmp_path / "scenario.py"
    script.write_text(
        "import subprocess, sys, threading\n"
        "import orion_tpu_torch  # noqa: F401\n"
        "from orion_tpu_torch.analysis.sanitizer import TSAN\n"
        "from orion_tpu_torch.telemetry import TELEMETRY\n"
        "assert TSAN.enabled and TELEMETRY._lock.tsan_key == 'Telemetry._lock'\n"
        "holder = {}\n"
        "cell = 'cell.child' if len(sys.argv) > 1 else 'cell.parent'\n"
        "def racer():\n"
        "    TSAN.write(cell, holder)\n"
        "threads = [threading.Thread(target=racer) for _ in range(2)]\n"
        "for t in threads: t.start()\n"
        "for t in threads: t.join()\n"
        "if len(sys.argv) == 1:\n"
        "    subprocess.run([sys.executable, __file__, 'child'], check=True)\n"
    )
    report = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=ROOT, ORION_TPU_TSAN="1", ORION_TPU_TSAN_SEED="3",
               ORION_TPU_TSAN_REPORT=str(report))
    proc = subprocess.run([sys.executable, str(script)], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    merged = json.loads(report.read_text())
    assert merged["processes"] == 2 and merged["seed"] == 3
    assert sorted(r["cell"].split("#")[0] for r in merged["races"]) == ["cell.child",
                                                                        "cell.parent"]
    assert merged["locks"]["Telemetry._lock"] == 2


@contextlib.contextmanager
def _fresh_registry(registry):
    """The compiler plane's registry and the step graphs are process-wide:
    empty for the block and after it, so its captures neither publish a
    gauge into a later test nor turn a later test's capture into a
    replay."""
    registry.reset()
    try:
        yield registry
    finally:
        registry.reset()


@pytest.mark.torch_tsan(seed=4)
def test_tpu_bo_bucket_crossing_with_the_prewarmer_racing_runs_clean():
    """Real port code under the marker: ``tpu_bo`` on the CPU crossing
    64 -> 128 with the prewarmer on, its capture thread racing the next
    rounds (nobody waits for it), telemetry on, so the round, the
    prewarmer, the step-graph cache, the compiler plane and the registry
    all touch their annotated cells from two threads."""
    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS
    from orion_tpu_torch.compiler_plane import COMPILE_REGISTRY
    from orion_tpu_torch.space.dsl import build_space
    from torch_parity import isolated_telemetry

    with isolated_telemetry(True), _fresh_registry(COMPILE_REGISTRY), \
            _fresh_registry(STEP_GRAPHS):
        space = build_space({f"x{i}": "uniform(0, 1)" for i in range(3)})
        algo = create_algo(space, {"tpu_bo": {"n_init": 8, "n_candidates": 256,
                                              "fit_steps": 2, "local_frac": 0.25,
                                              "prewarm": True}}, seed=5, device="cpu")
        rng = np.random.default_rng(5)
        x = rng.uniform(size=(40, 3)).astype(np.float32)
        algo.observe_arrays(x, x.sum(axis=1))
        for _ in range(4):  # 40 -> 56 (the prewarm starts at 48 of 64) -> ... -> 104
            rows = algo.suggest_batch(16).cube
            algo.observe_arrays(rows, rows.sum(axis=1))
        algo._prewarmer.wait()
        assert algo._prewarmer.completed_count() >= 1
        report = sanitizer.TSAN.snapshot_report()
        captured = STEP_GRAPHS.entries()
    cells = {c.split("#")[0] for c in report.cells}
    assert {"StepGraphs._entries", "BucketPrewarmer._threads", "Telemetry._metrics",
            "CompileRegistry._entries"} <= cells
    assert report.locks["StepGraphs.lock"] >= 1
    assert captured
