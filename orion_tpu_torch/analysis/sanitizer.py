"""Runtime concurrency sanitizer (``orion-tpu-torch tsan``; port of
``orion_tpu/analysis/sanitizer.py``).

The ``LCK*`` rules (:mod:`orion_tpu_torch.analysis.lock_rules`) check the
lock discipline *statically*: they resolve a bounded number of call levels
and cannot see dynamically-formed edges (a lock-owning object passed as a
parameter, a callback registered at runtime) or unsynchronized data access
at all.  This module is the dynamic half of that pairing — an opt-in
instrumented run that *observes* what the threads actually did:

- **Lock shims.**  ``TSAN.enable()`` (or env ``ORION_TPU_TSAN``) patches
  ``threading.Lock``/``RLock``/``Condition``/``Event`` so locks created by
  project code (never the stdlib's or third-party packages' — torch's own
  locks stay raw; the factory checks the creating frame's file) are
  wrapped in recording shims.  Each shim derives the same static identity
  the lint lock graph uses (``Class._attr`` / ``module._var``) from its
  creation site, so runtime findings and static findings speak one naming
  scheme.  Per-thread held-lock sets build the **observed lock-order
  graph**; a cycle is a potential deadlock, reported with the acquisition
  stacks of both edges.

- **Happens-before race detection.**  Threads carry vector clocks; shims
  create release→acquire edges, patched ``Thread.start``/``join`` and the
  ``Event`` shim create fork/join/signal edges.  Hot shared state is
  *annotated* at its access sites (``TSAN.write("Telemetry._ring")`` /
  ``TSAN.read(...)`` — one attribute check when disabled, constant-string
  args): two accesses to a cell from different threads with no
  happens-before path, at least one a write, are a data race — detected
  from the clocks alone, whether or not the racy interleaving happened to
  corrupt anything on this run.

- **Seeded interleaving explorer.**  A deterministic RNG draws at every
  instrumented acquisition and forces a thread switch (a short sleep
  before the acquire) on a hit, so schedules that need an unlucky
  preemption reproduce under a pinned seed.  Detection itself never
  depends on the perturbation — the clocks flag unordered accesses on ANY
  schedule — the explorer just widens the set of orders a short run
  actually exercises.  A forced switch sleeps while the thread may
  already hold other locks, so rounds under instrumentation run slower:
  never take timings from an instrumented run.

- **Static↔dynamic cross-check.**  :func:`cross_check_static` compares the
  observed lock graph against the lint pass's static graph: runtime edges
  the static resolver missed become ``LCK003`` findings, and static cycles
  whose every edge was observed at runtime are escalated from
  "theoretically possible" to "runtime-confirmed".

The DISABLED path costs what the telemetry registry's does: ``threading.*``
stays unpatched, and every annotation call early-returns on one attribute
check with no locks and no allocations.

Entry points: ``orion-tpu-torch tsan -- <cmd>`` (subprocess with the env
knobs + a JSON report, ``cli/tsan.py``) and the ``torch_tsan`` pytest
marker (``tests/torch_tsan.py`` wraps marked tests in enable/disable and
fails them on violations).  Knobs, spelled as the reference spells them:
``ORION_TPU_TSAN`` (enable), ``ORION_TPU_TSAN_SEED``,
``ORION_TPU_TSAN_SWITCH`` (switch rate), ``ORION_TPU_TSAN_REPORT`` (JSON
dump path, written at process exit).  Every process of one run (``hunt
--n-workers`` spawns its workers with the same env) merges its report into
that one file under an exclusive file lock, so the report covers the
whole cohort.
"""

import atexit
import itertools
import json
import linecache
import os
import random
import re
import sys
import threading
import time

#: Real factories, captured at import so enable/disable can swap them.
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition
_REAL_EVENT = threading.Event
_REAL_THREAD_START = threading.Thread.start
_REAL_THREAD_JOIN = threading.Thread.join

#: Files under these prefixes (the stdlib dir, plus every
#: site-/dist-packages on sys.path — in a venv those do NOT share the
#: stdlib prefix) create RAW locks even while the sanitizer is on:
#: instrumenting queue/socketserver internals or torch's own locks would
#: bury the project's discipline in noise and risk breaking third-party
#: lock-protocol assumptions.
_FOREIGN_PREFIXES = tuple(
    sorted(
        {os.path.dirname(threading.__file__)}
        | {
            entry
            for entry in sys.path
            if entry.rstrip("/\\").endswith(("site-packages", "dist-packages"))
        }
    )
)


def _is_foreign(path):
    return (
        path.startswith(_FOREIGN_PREFIXES)
        or "site-packages" in path
        or "dist-packages" in path
    )

_THIS_FILE = os.path.abspath(__file__)

#: ``self._lock = threading.Lock()`` / ``_completed_lock = Lock()`` — the
#: assignment-target sniff that maps a creation site to the static lock id
#: the lint graph uses.
_ASSIGN_RE = re.compile(r"^\s*(self\.[A-Za-z_]\w*|[A-Za-z_]\w*)\s*=")

DEFAULT_SWITCH_RATE = 0.05
DEFAULT_SWITCH_DELAY = 0.0005  # 500 µs: long enough to yield, short enough to soak

#: Frames kept per captured acquisition/access site.
_SITE_DEPTH = 8


def _capture_site(skip=2):
    """(frames, anchor) of the current call site.

    ``frames`` is a short outermost-last list of ``file:line in fn``
    strings (sanitizer frames skipped); ``anchor`` is the ``(path, line)``
    of the innermost PROJECT frame — what an LCK003 diagnostic anchors to.
    """
    frame = sys._getframe(skip)
    frames = []
    anchor = None
    while frame is not None and len(frames) < _SITE_DEPTH:
        code = frame.f_code
        path = code.co_filename
        if os.path.abspath(path) != _THIS_FILE:
            frames.append(f"{path}:{frame.f_lineno} in {code.co_name}")
            if anchor is None and not _is_foreign(path):
                anchor = (path, frame.f_lineno)
        frame = frame.f_back
    return frames, anchor


def _derive_identity(frame):
    """Static lock id + creation site for a lock made at ``frame``.

    Mirrors the lint graph's naming: ``self._x = threading.Lock()`` inside
    a method names ``Type._x`` (the runtime type, so subclasses get their
    own node), a module-level ``_x = Lock()`` names ``module._x``.  A lock
    made some other way (local variable, comprehension) falls back to
    ``module.fn:line`` — still stable across runs of the same source.
    """
    code = frame.f_code
    path = code.co_filename
    line = frame.f_lineno
    site = f"{path}:{line}"
    mod = os.path.splitext(os.path.basename(path))[0]
    match = _ASSIGN_RE.match(linecache.getline(path, line))
    if match:
        target = match.group(1)
        if target.startswith("self."):
            owner = frame.f_locals.get("self")
            if owner is not None:
                return f"{_defining_class(owner, code)}.{target[5:]}", site
        elif code.co_name == "<module>":
            return f"{mod}.{target}", site
    return f"{mod}.{code.co_name}:{line}", site


def _defining_class(owner, code):
    """The class whose method ``code`` belongs to — the static lock graph
    names locks after the class that DECLARES them, so an instance of a
    subclass must not mint a differently-named node."""
    for cls in type(owner).__mro__:
        fn = cls.__dict__.get(code.co_name)
        if getattr(fn, "__code__", None) is code:
            return cls.__name__
    return type(owner).__name__


def _merge_clock(into, other):
    for tid, epoch in other.items():
        if into.get(tid, 0) < epoch:
            into[tid] = epoch


#: Unique per-Thread tokens for the vector clocks.  OS thread idents are
#: RECYCLED the moment a thread exits — keying clocks on them would alias
#: a fresh thread with a dead one and silently drop races between them.
_TID_COUNTER = itertools.count(1)


#: Per-instance cell tokens (id() would be recycled by the allocator).
_CELL_COUNTER = itertools.count(1)

#: The attributes this sanitizer stamps on threads and owners: its own
#: names, not the reference sanitizer's, so that a process holding both
#: packages (the parity tests) never reads one's tokens as the other's.
_TID_ATTR = "orion_torch_tsan_tid"
_CLOCK0_ATTR = "orion_torch_tsan_clock0"
_TOKEN_ATTR = "orion_torch_tsan_cell_token"


def _tsan_tid():
    current = threading.current_thread()
    tid = current.__dict__.get(_TID_ATTR)
    if tid is None:
        tid = next(_TID_COUNTER)  # atomic under the GIL
        setattr(current, _TID_ATTR, tid)
    return tid


class _TsanLock:
    """Recording shim around one real lock (Lock or RLock).

    Forwards the lock protocol; successful acquisitions/releases feed the
    sanitizer's held-set, lock-order graph, and vector clocks.  Unknown
    attributes forward to the inner lock so RLock internals keep working.
    """

    def __init__(self, inner, key, site):
        self._tsan_inner = inner
        self.tsan_key = key
        self.tsan_site = site
        self.tsan_clock = {}
        TSAN.note_lock(key)

    def acquire(self, blocking=True, timeout=-1):
        TSAN.pre_acquire()
        ok = self._tsan_inner.acquire(blocking, timeout)
        if ok:
            TSAN.note_acquire(self)
        return ok

    def release(self):
        TSAN.note_release(self)
        self._tsan_inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def locked(self):
        return self._tsan_inner.locked()

    # --- Condition protocol ---------------------------------------------
    # The real Condition captures these bound methods at construction; if
    # __getattr__ forwarded them to the raw inner lock, cond.wait() would
    # release/reacquire INVISIBLY and the notifier->waiter happens-before
    # edge would be lost (annotated state correctly guarded by a Condition
    # would read as racy).  Recursion bookkeeping is approximate across a
    # saved-state restore (we record depth 1); the CLOCK edges — the part
    # race detection rests on — are exact.

    def _release_save(self):
        TSAN.note_release_save(self)
        return self._tsan_inner._release_save()

    def _acquire_restore(self, state):
        self._tsan_inner._acquire_restore(state)
        TSAN.note_acquire(self)

    def _is_owned(self):
        return self._tsan_inner._is_owned()

    def __getattr__(self, name):
        return getattr(self._tsan_inner, name)


class _TsanEvent:
    """Recording shim around ``threading.Event``: ``set()`` publishes the
    setter's clock, a successful ``wait()`` joins it — the signal edge a
    stop flag or a reply handoff synchronizes on."""

    def __init__(self, inner):
        self._tsan_inner = inner
        self.tsan_clock = {}

    def set(self):
        TSAN.note_publish(self)
        self._tsan_inner.set()

    def wait(self, timeout=None):
        ok = self._tsan_inner.wait(timeout)
        if ok:
            TSAN.note_join_clock(self)
        return ok

    def is_set(self):
        return self._tsan_inner.is_set()

    def clear(self):
        return self._tsan_inner.clear()

    def __getattr__(self, name):
        return getattr(self._tsan_inner, name)


def _instrumentable(frame):
    """True when the factory call at ``frame`` came from project code (not
    the stdlib / site-packages, whose locks must stay raw)."""
    return not _is_foreign(frame.f_code.co_filename)


def _lock_factory(real):
    def make():
        inner = real()
        if not TSAN.enabled:
            return inner
        frame = sys._getframe(1)
        if not _instrumentable(frame):
            return inner
        key, site = _derive_identity(frame)
        return _TsanLock(inner, key, site)

    return make


def _condition_factory(lock=None):
    """Patched ``threading.Condition``: a project-created condition with no
    explicit lock gets an instrumented RLock, so state guarded by the
    condition's mutex still gets happens-before edges.  (The real Condition
    drives our shim through its acquire/release fallback protocol.)"""
    if lock is None and TSAN.enabled and _instrumentable(sys._getframe(1)):
        frame = sys._getframe(1)
        key, site = _derive_identity(frame)
        lock = _TsanLock(_REAL_RLOCK(), key, site)
    return _REAL_CONDITION(lock)


def _event_factory():
    inner = _REAL_EVENT()
    if TSAN.enabled and _instrumentable(sys._getframe(1)):
        return _TsanEvent(inner)
    return inner


def _thread_start(thread):
    TSAN.note_thread_start(thread)
    return _REAL_THREAD_START(thread)


def _thread_join(thread, timeout=None):
    result = _REAL_THREAD_JOIN(thread, timeout)
    TSAN.note_thread_join(thread)
    return result


class TsanReport:
    """One instrumented run's findings: observed lock-order graph (+
    cycles), data races over the annotated cells, explorer bookkeeping,
    and the coverage a clean report rests on: the instrumented locks (by
    static id, with how many were made) and the annotated accesses."""

    def __init__(self, edges, races, cells, switches, seed, locks=None, accesses=0):
        self.edges = edges  # [{"outer","inner","path","line",stacks...}]
        self.races = races
        self.cells = cells
        self.switches = switches
        self.seed = seed
        self.locks = dict(locks or {})
        self.accesses = int(accesses)
        self.cycles = _cycles_in_edges(edges)

    def violation_count(self):
        return len(self.races) + len(self.cycles)

    def to_dict(self):
        return {
            "type": "tsan-report",
            "seed": self.seed,
            "switches": self.switches,
            "cells": sorted(self.cells),
            "edges": list(self.edges),
            "lock_order_cycles": list(self.cycles),
            "races": list(self.races),
            "violations": self.violation_count(),
            "locks": dict(sorted(self.locks.items())),
            "accesses": self.accesses,
        }

    def format_human(self):
        lines = []
        for cycle in self.cycles:
            lines.append(
                "POTENTIAL DEADLOCK: lock-order cycle "
                + " -> ".join(cycle["cycle"])
            )
            for edge in cycle["edges"]:
                lines.append(f"  edge {edge['outer']} -> {edge['inner']}:")
                lines.append(f"    outer acquired at: {edge['outer_stack'][0]}")
                lines.append(f"    inner acquired at: {edge['inner_stack'][0]}")
        for race in self.races:
            lines.append(
                f"DATA RACE ({race['kind']}) on {race['cell']}: "
                f"thread {race['thread_a']} at {race['site_a']} vs "
                f"thread {race['thread_b']} at {race['site_b']}"
            )
        n = self.violation_count()
        lines.append(
            f"{n} violation{'s' if n != 1 else ''} "
            f"({len(self.races)} race(s), {len(self.cycles)} cycle(s)), "
            f"{len(self.edges)} observed edge(s), {self.switches} forced "
            "switch(es)"
        )
        return "\n".join(lines)


def _cycles_in_edges(edge_list):
    """Cycles in an observed edge list, each reported once with its edges'
    stacks.  Rides the SAME traversal as the static LCK001 pass
    (``lock_rules.iter_edge_cycles``) so the runtime and static halves can
    never disagree on what counts as a cycle.  Imported lazily: report
    building is a cold path, and the lock_rules/engine import must stay
    off the instrumentation hot path."""
    from orion_tpu_torch.analysis.lock_rules import iter_edge_cycles

    meta = {}
    graph = {}
    for edge in edge_list:
        graph.setdefault(edge["outer"], {}).setdefault(edge["inner"], edge)
        meta[(edge["outer"], edge["inner"])] = edge
    cycles = []
    for cycle, _node, _child in iter_edge_cycles(graph):
        pairs = list(zip(cycle, cycle[1:]))
        cycles.append(
            {
                "cycle": list(cycle),
                "edges": [meta[p] for p in pairs if p in meta],
            }
        )
    return cycles


class Tsan:
    """The process-wide sanitizer.  All mutable analysis state lives behind
    ONE internal (never-instrumented) lock; the disabled path never touches
    it — every public recording entry early-returns on ``self.enabled``.
    """

    #: Singleton locks created at import time, re-wrapped on enable so the
    #: observability layer's own discipline is observable too.  Each entry
    #: is (module, attribute-holder attr chain, lock attr, static id).
    _SINGLETON_LOCKS = (
        ("orion_tpu_torch.telemetry", "TELEMETRY", "_lock", "Telemetry._lock"),
        ("orion_tpu_torch.health", "FLIGHT", "_lock", "FlightRecorder._lock"),
        ("orion_tpu_torch.algo.prewarm", None, "_completed_lock", "prewarm._completed_lock"),
        ("orion_tpu_torch.algo.prewarm", None, "_prewarmers_lock", "prewarm._prewarmers_lock"),
        ("orion_tpu_torch.algo.history", None, "_registry_lock", "history._registry_lock"),
        # The memory sampler's rate-limit cell and the worker metrics-server
        # singleton guard (both annotated shared cells).
        ("orion_tpu_torch.devmem", None, "_lock", "devmem._lock"),
        ("orion_tpu_torch.metrics", None, "_worker_lock", "metrics._worker_lock"),
        # The doctor's last-published-summary slot (read by /healthz
        # handler threads, written by the watchdog/CLI watch loop), named
        # as the lint graph names a module-level lock: after its file.
        ("orion_tpu_torch.diagnosis.watch", None, "_last_lock", "watch._last_lock"),
        # The port's own: the step-graph cache's one lock (the round's
        # thread against the prewarmer's capture thread) and the compiler
        # plane's registry, which both of them record into.
        ("orion_tpu_torch.algo.step_graphs", "STEP_GRAPHS", "lock", "StepGraphs.lock"),
        ("orion_tpu_torch.compiler_plane", "COMPILE_REGISTRY", "_lock",
         "CompileRegistry._lock"),
    )

    def __init__(self):
        self.enabled = False
        self._lock = _REAL_LOCK()
        self._tls = threading.local()
        self._generation = 0
        self._seed = 0
        self._switch_rate = 0.0
        self._switch_delay = DEFAULT_SWITCH_DELAY
        self._rng = random.Random(0)
        self._swapped = []  # (owner_or_module, attr, wrapper) to unwrap
        self._reset_state()

    def _reset_state(self):
        self._clocks = {}  # tsan tid -> vector clock dict
        self._owner_tokens = {}  # id(owner) -> token, for ownerless-__dict__ objects
        self._owner_refs = []  # pins those owners so ids stay stable this run
        self._edges = {}  # (outer, inner) -> first-observation dict
        self._cells = {}  # name -> {"writes": {tid: (epoch, site, frames)}, "reads": ...}
        self._races = []
        self._race_keys = set()
        self._switches = 0
        self._lock_counts = {}  # static id -> shims made this run
        self._accesses = 0

    # --- lifecycle -----------------------------------------------------------
    def enable(self, seed=0, switch_rate=None, switch_delay=None):
        """Patch the factories and start recording.  Not reentrant: two
        owners flipping the sanitizer independently would unpatch each
        other's shims mid-run."""
        if self.enabled:
            raise RuntimeError("sanitizer already enabled")
        with self._lock:
            self._reset_state()
            # New enable window: per-thread held/recursion state from a
            # previous window is stale (a lock held across disable() was
            # released invisibly) — _state() drops it lazily per thread.
            self._generation += 1
            self._seed = int(seed)
            self._rng = random.Random(self._seed)
            if switch_rate is None:
                switch_rate = DEFAULT_SWITCH_RATE
            self._switch_rate = float(switch_rate)
            if switch_delay is not None:
                self._switch_delay = float(switch_delay)
        # Wrap the import-time singletons BEFORE patching the factories:
        # their modules import here with the RAW factories, so the wrap is
        # explicit and recorded — and therefore restored on disable.
        self._wrap_singletons()
        threading.Lock = _lock_factory(_REAL_LOCK)
        threading.RLock = _lock_factory(_REAL_RLOCK)
        threading.Condition = _condition_factory
        threading.Event = _event_factory
        threading.Thread.start = _thread_start
        threading.Thread.join = _thread_join
        self.enabled = True

    def disable(self):
        """Unpatch and return this run's :class:`TsanReport`.  Shims created
        while enabled keep working (their hooks early-return), so objects
        outliving the run are safe — just no longer observed."""
        if not self.enabled:
            return self.snapshot_report()
        self._unwrap_singletons()
        self.enabled = False
        threading.Lock = _REAL_LOCK
        threading.RLock = _REAL_RLOCK
        threading.Condition = _REAL_CONDITION
        threading.Event = _REAL_EVENT
        threading.Thread.start = _REAL_THREAD_START
        threading.Thread.join = _REAL_THREAD_JOIN
        return self.snapshot_report()

    def enable_from_env(self):
        """The ``orion-tpu-torch tsan -- <cmd>`` child-process entry: seed/rate
        from env, report merged into ``ORION_TPU_TSAN_REPORT`` at exit."""
        seed = int(os.environ.get("ORION_TPU_TSAN_SEED", "0") or 0)
        try:
            rate = float(
                os.environ.get("ORION_TPU_TSAN_SWITCH", "")
                or DEFAULT_SWITCH_RATE
            )
        except ValueError:
            rate = DEFAULT_SWITCH_RATE
        self.enable(seed=seed, switch_rate=rate)
        path = os.environ.get("ORION_TPU_TSAN_REPORT")
        if path:
            atexit.register(self._dump_report, path)

    def _dump_report(self, path):
        """Merge this process's report into ``path`` under an exclusive
        file lock: every process of one instrumented run (``hunt
        --n-workers`` children inherit the env) adds its edges, races,
        cells and switches, so no worker's findings are overwritten by
        the last one to exit."""
        import fcntl

        try:
            with open(path, "a+") as handle:
                fcntl.flock(handle, fcntl.LOCK_EX)
                handle.seek(0)
                try:
                    merged = json.loads(handle.read() or "null")
                except ValueError:
                    merged = None
                report = merge_report_dicts(merged, self.snapshot_report().to_dict())
                handle.seek(0)
                handle.truncate()
                json.dump(report, handle)
        except OSError:  # pragma: no cover - report path unwritable
            pass

    def _wrap_singletons(self):
        """Wrap the singletons of the modules already imported.  A module
        imported later makes its locks through the patched factories,
        which name them alike; importing it here would make a user script
        that imports only the client (``hunt`` runs one per trial, and
        each inherits the env) import torch for nothing."""
        for mod_name, holder_attr, lock_attr, key in self._SINGLETON_LOCKS:
            module = sys.modules.get(mod_name)
            if module is None:
                continue
            try:
                owner = getattr(module, holder_attr) if holder_attr else module
                current = getattr(owner, lock_attr)
            except AttributeError:  # pragma: no cover - a partly imported module
                continue
            if isinstance(current, _TsanLock):
                # Already a shim (created natively under a previous enabled
                # window): record it so disable still restores the raw lock.
                self._swapped.append((owner, lock_attr, current))
                continue
            wrapper = _TsanLock(current, key, f"<singleton {key}>")
            setattr(owner, lock_attr, wrapper)
            self._swapped.append((owner, lock_attr, wrapper))

    def _unwrap_singletons(self):
        for owner, attr, wrapper in self._swapped:
            if getattr(owner, attr, None) is wrapper:
                setattr(owner, attr, wrapper._tsan_inner)
        self._swapped = []

    # --- per-thread state ----------------------------------------------------
    def _state(self):
        tls = self._tls
        if getattr(tls, "generation", None) != self._generation:
            tls.held = []  # [(lock id(), key, frames), ...]
            tls.rec = {}  # id(lock) -> recursion depth
            tls.generation = self._generation
        return tls

    def _clock_locked(self, tid):
        clock = self._clocks.get(tid)
        if clock is None:
            inherited = getattr(threading.current_thread(), _CLOCK0_ATTR, None)
            clock = dict(inherited) if inherited else {}
            clock[tid] = clock.get(tid, 0) + 1
            self._clocks[tid] = clock
        return clock

    def _bump_locked(self, clock, tid):
        clock[tid] = clock.get(tid, 0) + 1

    # --- lock hooks ----------------------------------------------------------
    def note_lock(self, key):
        """Count one instrumented lock (a shim is only ever made while
        enabling or enabled)."""
        with self._lock:
            self._lock_counts[key] = self._lock_counts.get(key, 0) + 1

    def pre_acquire(self):
        """The seeded interleaving explorer: called BEFORE the real acquire
        so a forced switch hands the lock race to another thread."""
        if not self.enabled or self._switch_rate <= 0.0:
            return
        with self._lock:
            hit = self._rng.random() < self._switch_rate
            if hit:
                self._switches += 1
        if hit:
            time.sleep(self._switch_delay)

    def note_acquire(self, lock):
        if not self.enabled:
            return
        state = self._state()
        lock_id = id(lock)
        depth = state.rec.get(lock_id, 0)
        if depth:  # reentrant re-acquire: no new edges, no clock movement
            state.rec[lock_id] = depth + 1
            return
        frames, _anchor = _capture_site(skip=3)
        tid = _tsan_tid()
        with self._lock:
            clock = self._clock_locked(tid)
            _merge_clock(clock, lock.tsan_clock)
            for _outer_id, outer_key, outer_frames in state.held:
                if outer_key == lock.tsan_key:
                    continue
                pair = (outer_key, lock.tsan_key)
                if pair not in self._edges:
                    anchor = _anchor_of(frames)
                    self._edges[pair] = {
                        "outer": outer_key,
                        "inner": lock.tsan_key,
                        "path": anchor[0],
                        "line": anchor[1],
                        "outer_stack": list(outer_frames),
                        "inner_stack": list(frames),
                        "thread": tid,
                    }
        state.rec[lock_id] = 1
        state.held.append((lock_id, lock.tsan_key, frames))

    def note_release(self, lock):
        if not self.enabled:
            return
        state = self._state()
        lock_id = id(lock)
        depth = state.rec.get(lock_id, 0)
        if depth > 1:
            state.rec[lock_id] = depth - 1
            return
        state.rec.pop(lock_id, None)
        for index in range(len(state.held) - 1, -1, -1):
            if state.held[index][0] == lock_id:
                del state.held[index]
                break
        tid = _tsan_tid()
        with self._lock:
            clock = self._clock_locked(tid)
            _merge_clock(lock.tsan_clock, clock)
            self._bump_locked(clock, tid)

    def note_release_save(self, lock):
        """A Condition's wait() releasing ALL recursion levels at once:
        clear the recursion count, drop the hold, publish the clock."""
        if not self.enabled:
            return
        state = self._state()
        state.rec.pop(id(lock), None)
        for index in range(len(state.held) - 1, -1, -1):
            if state.held[index][0] == id(lock):
                del state.held[index]
                break
        tid = _tsan_tid()
        with self._lock:
            clock = self._clock_locked(tid)
            _merge_clock(lock.tsan_clock, clock)
            self._bump_locked(clock, tid)

    # --- event / thread hooks ------------------------------------------------
    def note_publish(self, event):
        if not self.enabled:
            return
        tid = _tsan_tid()
        with self._lock:
            clock = self._clock_locked(tid)
            _merge_clock(event.tsan_clock, clock)
            self._bump_locked(clock, tid)

    def note_join_clock(self, event):
        if not self.enabled:
            return
        tid = _tsan_tid()
        with self._lock:
            _merge_clock(self._clock_locked(tid), event.tsan_clock)

    def note_thread_start(self, thread):
        if not self.enabled:
            return
        tid = _tsan_tid()
        with self._lock:
            clock = self._clock_locked(tid)
            setattr(thread, _CLOCK0_ATTR, dict(clock))
            self._bump_locked(clock, tid)

    def note_thread_join(self, thread):
        if not self.enabled or thread.is_alive():
            return
        child_tid = getattr(thread, _TID_ATTR, None)
        if child_tid is None:
            return  # the child never touched instrumented state
        tid = _tsan_tid()
        with self._lock:
            child = self._clocks.get(child_tid)
            if child:
                _merge_clock(self._clock_locked(tid), child)

    # --- annotated shared cells ----------------------------------------------
    def write(self, cell, owner=None):
        """Record a write to annotated cell ``cell`` (a constant string).
        ``owner`` scopes the cell to one instance — two NetworkDB clients'
        sockets are different cells, not one.  One attribute check when
        disabled — no locks, no allocations."""
        if not self.enabled:
            return
        self._access(cell, "w", owner)

    def read(self, cell, owner=None):
        """Record a read of annotated cell ``cell``."""
        if not self.enabled:
            return
        self._access(cell, "r", owner)

    def _access(self, cell, kind, owner):
        frames, anchor = _capture_site(skip=3)
        site = frames[0] if frames else "?"
        tid = _tsan_tid()
        with self._lock:
            if owner is not None:
                cell = f"{cell}#{self._owner_token_locked(owner)}"
            clock = self._clock_locked(tid)
            self._accesses += 1
            entry = self._cells.setdefault(cell, {"w": {}, "r": {}})
            opposing = list(entry["w"].items())
            if kind == "w":
                opposing += list(entry["r"].items())
            for other_tid, (epoch, other_site, other_frames, other_kind) in opposing:
                if other_tid == tid:
                    continue
                if clock.get(other_tid, 0) >= epoch:
                    continue  # ordered before this access
                self._record_race_locked(
                    cell, kind, other_kind, tid, site, frames, other_tid,
                    other_site, other_frames,
                )
            entry[kind][tid] = (clock.get(tid, 1), site, frames, kind)

    def _owner_token_locked(self, owner):
        """Stable per-instance token.  Stored as an attribute where the
        owner allows it; slotted/builtin owners fall back to an id-keyed
        map whose keys are pinned alive for the run (a recycled id must
        not alias two owners within one report)."""
        attrs = getattr(owner, "__dict__", None)
        if attrs is not None:
            token = attrs.get(_TOKEN_ATTR)
            if token is None:
                token = next(_CELL_COUNTER)
                try:
                    setattr(owner, _TOKEN_ATTR, token)
                    return token
                except AttributeError:
                    pass  # read-only __dict__ (class/mappingproxy)
            else:
                return token
        token = self._owner_tokens.get(id(owner))
        if token is None:
            token = next(_CELL_COUNTER)
            self._owner_tokens[id(owner)] = token
            self._owner_refs.append(owner)
        return token

    def _record_race_locked(self, cell, kind, other_kind, tid, site, frames,
                            other_tid, other_site, other_frames):
        label = "write/write" if kind == "w" and other_kind == "w" else "read/write"
        key = (cell, label, site, other_site)
        if key in self._race_keys or (cell, label, other_site, site) in self._race_keys:
            return
        self._race_keys.add(key)
        self._races.append(
            {
                "cell": cell,
                "kind": label,
                "thread_a": tid,
                "site_a": site,
                "stack_a": list(frames),
                "thread_b": other_tid,
                "site_b": other_site,
                "stack_b": list(other_frames),
            }
        )

    # --- reporting -----------------------------------------------------------
    def snapshot_report(self):
        with self._lock:
            edges = [dict(meta) for meta in self._edges.values()]
            races = [dict(race) for race in self._races]
            cells = list(self._cells)
            switches = self._switches
            locks = dict(self._lock_counts)
            accesses = self._accesses
        return TsanReport(edges, races, cells, switches, self._seed, locks, accesses)


def _anchor_of(frames):
    """(path, line) of the innermost project frame in a captured site."""
    for entry in frames:
        path, _, rest = entry.partition(":")
        if not _is_foreign(path):
            line = rest.split(" ", 1)[0]
            try:
                return path, int(line)
            except ValueError:  # pragma: no cover - malformed frame text
                continue
    return "<unknown>", 0


def merge_report_dicts(first, second):
    """Two ``TsanReport.to_dict()`` documents (``first`` may be None) as
    one: edges deduplicated on (outer, inner) keeping the first
    observation, races on (cell, kind, sites), cells unioned, switches
    summed.  Thread ids are per process, so a merged race's threads name
    threads of its own process."""
    if not first:
        return dict(second, processes=1)
    edges = {}
    for edge in list(first.get("edges") or []) + list(second.get("edges") or []):
        edges.setdefault((edge["outer"], edge["inner"]), edge)
    races = {}
    for race in list(first.get("races") or []) + list(second.get("races") or []):
        races.setdefault((race["cell"], race["kind"], race["site_a"], race["site_b"]), race)
    locks = dict(first.get("locks") or {})
    for key, count in (second.get("locks") or {}).items():
        locks[key] = locks.get(key, 0) + count
    report = TsanReport(
        list(edges.values()),
        list(races.values()),
        set(first.get("cells") or []) | set(second.get("cells") or []),
        int(first.get("switches") or 0) + int(second.get("switches") or 0),
        second.get("seed", first.get("seed")),
        locks,
        int(first.get("accesses") or 0) + int(second.get("accesses") or 0),
    ).to_dict()
    report["processes"] = int(first.get("processes") or 1) + 1
    return report


# --- static <-> dynamic cross-check ------------------------------------------

#: In-process override for the LCK003 rule's runtime-edge source (tests,
#: the tsan CLI); None = fall back to the ORION_TPU_TSAN_EDGES env file.
_LINT_RUNTIME_EDGES = None


def set_lint_runtime_edges(edges):
    """Feed observed runtime edges to the ``LCK003`` lint rule in-process
    (``None`` restores the env-file fallback)."""
    global _LINT_RUNTIME_EDGES
    _LINT_RUNTIME_EDGES = list(edges) if edges is not None else None


def lint_runtime_edges():
    """The runtime edges the LCK003 rule checks: the in-process override
    when set, else the JSON report/edge-list named by the
    ``ORION_TPU_TSAN_EDGES`` env var, else nothing (the rule stays silent
    on plain lint runs)."""
    if _LINT_RUNTIME_EDGES is not None:
        return list(_LINT_RUNTIME_EDGES)
    path = os.environ.get("ORION_TPU_TSAN_EDGES", "").strip()
    if not path or not os.path.exists(path):
        return []
    try:
        with open(path) as handle:
            data = json.load(handle)
    except (OSError, ValueError):
        return []
    if isinstance(data, dict):
        data = data.get("edges") or []
    return [e for e in data if isinstance(e, dict)]


def cross_check_static(edges, paths):
    """Compare observed runtime lock edges against the static LCK graph.

    Returns ``{"unmodeled_edges": [...], "confirmed_static_cycles": [...]}``:
    runtime edges between locks the static pass KNOWS but whose ordering it
    never derived (the LCK003 findings — a resolver blind spot, usually a
    lock-owning object reached through a parameter or callback), and static
    LCK001 cycles whose every edge was actually observed at runtime
    (escalated: the deadlock is one unlucky schedule away, not a
    theoretical artifact of over-approximation)."""
    from orion_tpu_torch.analysis.engine import iter_python_files, load_module
    from orion_tpu_torch.analysis.lock_rules import (
        build_static_edges,
        known_lock_ids,
        iter_edge_cycles,
        project_index,
    )

    modules = []
    for path in iter_python_files(paths):
        module, _error = load_module(path)
        if module is not None:
            modules.append(module)
    index = project_index(modules)
    static_edges = build_static_edges(index)
    static_pairs = {
        (outer, inner) for outer in static_edges for inner in static_edges[outer]
    }
    known = known_lock_ids(index)
    unmodeled = [
        dict(edge)
        for edge in edges
        if (edge["outer"], edge["inner"]) not in static_pairs
        and edge["outer"] in known
        and edge["inner"] in known
    ]
    runtime_pairs = {(edge["outer"], edge["inner"]) for edge in edges}
    confirmed = []
    for cycle, _node, _child in iter_edge_cycles(static_edges):
        pairs = list(zip(cycle, cycle[1:]))
        if pairs and all(pair in runtime_pairs for pair in pairs):
            confirmed.append(list(cycle))
    return {"unmodeled_edges": unmodeled, "confirmed_static_cycles": confirmed}


#: THE process-wide sanitizer, next to telemetry.TELEMETRY/health.FLIGHT.
#: Enabled via ORION_TPU_TSAN at orion_tpu_torch import (see
#: orion_tpu_torch/__init__), TSAN.enable(), or the ``torch_tsan`` marker.
TSAN = Tsan()

