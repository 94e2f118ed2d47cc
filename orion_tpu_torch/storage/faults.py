"""Deterministic fault injection for the storage layer (port of
``orion_tpu/storage/faults.py``: the same seeded schedule, so one seed over
one op order injects the same faults in both packages).

Two instruments, both driven by a seeded :class:`FaultSchedule` so a chaos
run is REPLAYABLE (same seed + same op order = same faults):

- :class:`FaultyDB` wraps any document backend (memory/pickled/sqlite/
  network client, or a third-party AbstractDB) and executes the schedule
  at the op boundary — raise-before-apply, apply-then-drop-reply (the
  applied-and-reply-lost ambiguity the retry policy must converge
  through), latency spikes, and mid-batch kills on
  ``apply_batch``/``pipeline`` (a prefix applies, then the "server dies").
  Interception is capability-preserving: ``FaultyDB`` only exposes the
  batch primitives its inner backend has, so ``DocumentStorage``'s
  capability probes see the wrapped backend exactly as they would the
  real one.

- :class:`FaultProxy` is a byte-level TCP proxy for the network backend:
  it sits between :class:`~orion_tpu_torch.storage.netdb.NetworkDB` and a real
  :class:`~orion_tpu_torch.storage.netdb.DBServer` and drops, stalls,
  black-holes, or mid-line-cuts connections — so chaos tests exercise the
  client's REAL reconnect/resend/idle-probe paths against a live server,
  not mocks.  One-shot ``fail_next`` modes make server-restart-mid-batch
  scenarios deterministic (never-applied vs. applied-and-reply-lost).

:func:`orion_tpu_torch.testing.drive_chaos_experiment` composes both with
the invariant auditor (``storage/audit.py``): an experiment must run to
completion under a seeded schedule on every backend with zero duplicated
trials and zero lost observations.
"""

import logging
import random
import socket
import threading
import time

from orion_tpu_torch.utils.exceptions import DatabaseError

log = logging.getLogger(__name__)

#: The round classes a schedule can inject, in the storage layer's terms.
FAULT_KINDS = ("error", "reply_lost", "latency", "kill")

#: Ops FaultyDB intercepts — the write/read cycle of the AbstractDB
#: contract.  Index management and snapshots stay clean: they are
#: startup-time work, and faulting them would test construction, not the
#: coordination protocol.
FAULTABLE_OPS = frozenset(
    {"write", "read", "read_and_write", "count", "remove", "update_many"}
)
#: Batch primitives: the only ops a ``kill`` (mid-batch death) can hit.
BATCH_OPS = frozenset({"apply_batch", "pipeline"})


class InjectedFault(DatabaseError):
    """A fault the schedule injected (never a real backend failure).

    Transient by classification (a DatabaseError that is not one of the
    semantic subtypes), so the retry policy treats it exactly like the
    outage it simulates."""


class FaultSchedule:
    """Seeded, deterministic plan of which intercepted op faults and how.

    ``plan`` pins faults to exact op indices (``{op_index: kind}``) — the
    chaos tests use this to guarantee every round class fires at least
    once on a short run.  ``rates`` adds seeded random faults on top
    (``{kind: probability}``), drawn ONCE per intercepted op in call
    order, so the whole schedule is a pure function of (seed, op order).
    ``max_faults`` bounds the total so a run always converges.

    A ``kill`` drawn while a non-batch op is executing is DEFERRED to the
    next batch op (a mid-batch death needs a batch to die in the middle
    of) — deferral keeps the plan meaningful without making it
    op-shape-aware.
    """

    def __init__(self, seed=0, plan=None, rates=None, latency=0.01, max_faults=None):
        self._rng = random.Random(seed)
        self.plan = dict(plan or {})
        self.rates = dict(rates or {})
        for kind in list(self.plan.values()) + list(self.rates):
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r}; one of {FAULT_KINDS}")
        self.latency = float(latency)
        self.max_faults = max_faults
        self.op_count = 0
        self.injected = {kind: 0 for kind in FAULT_KINDS}
        self._pending_kill = False
        self._lock = threading.Lock()

    @property
    def total_injected(self):
        return sum(self.injected.values())

    def _budget_left(self):
        return self.max_faults is None or self.total_injected < self.max_faults

    def draw(self, op, batchable):
        """The fault (or None) for the next intercepted op.  Called once
        per op in execution order; thread-safe so a multi-worker chaos run
        stays well-defined (though only single-writer runs are strictly
        replayable)."""
        with self._lock:
            index = self.op_count
            self.op_count += 1
            kind = self.plan.get(index)
            if kind is None and self.rates:
                # One draw per rate entry, in fixed key order, EVERY op —
                # the stream position depends only on op index, never on
                # which faults happened to fire.
                for rate_kind in FAULT_KINDS:
                    rate = self.rates.get(rate_kind)
                    if rate is None:
                        continue
                    hit = self._rng.random() < rate
                    if hit and kind is None:
                        kind = rate_kind
            if kind == "kill" and not batchable:
                self._pending_kill = True
                kind = None
            elif kind is None and self._pending_kill and batchable:
                kind = "kill"
            if kind is None or not self._budget_left():
                return None
            if kind == "kill":
                self._pending_kill = False
            self.injected[kind] += 1
            return kind


def _raise_injected(op, kind, maybe_applied=False):
    exc = InjectedFault(f"injected fault ({kind}) during {op!r}")
    exc.maybe_applied = maybe_applied
    raise exc


class FaultyDB:
    """Schedule-executing wrapper around a document backend.

    Delegates everything (attributes, counters, ``cheap_counts``, index
    management) to the inner backend; the FAULTABLE_OPS and whichever
    BATCH_OPS the inner backend actually has are intercepted through
    ``__getattr__``-built wrappers, so capability probes
    (``getattr(db, "apply_batch", None)``) see exactly the inner
    backend's surface.
    """

    def __init__(self, inner, schedule=None):
        self._inner = inner
        self.schedule = schedule or FaultSchedule()

    @property
    def inner(self):
        return self._inner

    @property
    def faults_injected(self):
        return dict(self.schedule.injected)

    def __getattr__(self, name):
        inner = self.__dict__.get("_inner")
        if inner is None:
            # Mid-unpickle (or a half-built instance) has no __dict__ yet;
            # recursing through self._inner here is a stack overflow.
            raise AttributeError(name)
        target = getattr(inner, name)  # AttributeError propagates
        if name in FAULTABLE_OPS:
            return self._wrap_op(name, target)
        if name in BATCH_OPS:
            return self._wrap_batch(name, target)
        return target

    def _wrap_op(self, op, target):
        schedule = self.schedule

        def faulted(*args, **kwargs):
            kind = schedule.draw(op, batchable=False)
            if kind == "error":
                _raise_injected(op, kind)
            if kind == "latency":
                time.sleep(schedule.latency)
            result = target(*args, **kwargs)
            if kind == "reply_lost":
                _raise_injected(op, kind, maybe_applied=True)
            return result

        return faulted

    def _wrap_batch(self, op, target):
        schedule = self.schedule

        def faulted(ops):
            kind = schedule.draw(op, batchable=True)
            if kind == "error":
                _raise_injected(op, kind)
            if kind == "latency":
                time.sleep(schedule.latency)
            if kind == "kill":
                # The server died mid-batch: a prefix applied durably, the
                # rest never arrived, and the caller cannot know the split.
                applied = len(ops) // 2
                if applied:
                    target(list(ops)[:applied])
                _raise_injected(op, kind, maybe_applied=True)
            result = target(ops)
            if kind == "reply_lost":
                _raise_injected(op, kind, maybe_applied=True)
            return result

        return faulted


class _ProxyConnection:
    """One client<->upstream pair with its two pump threads."""

    def __init__(self, proxy, client):
        self.proxy = proxy
        self.client = client
        self.upstream = socket.create_connection(
            (proxy.upstream_host, proxy.upstream_port), timeout=proxy.timeout
        )
        self.drop_reply_armed = False
        self._closed = threading.Event()

    def start(self):
        for fn in (self._pump_up, self._pump_down):
            threading.Thread(target=fn, daemon=True).start()

    def close(self):
        if self._closed.is_set():
            return
        self._closed.set()
        for sock in (self.client, self.upstream):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self.proxy._forget(self)

    def _pump_up(self):
        """client -> upstream, where the one-shot fault modes fire."""
        proxy = self.proxy
        try:
            while not self._closed.is_set():
                data = self.client.recv(65536)
                if not data:
                    break
                if proxy.capture:
                    with proxy._lock:
                        proxy.captured_up.extend(data)
                mode = proxy._take_mode()
                if mode == "drop_request":
                    # Nothing reaches the server: the never-applied case.
                    proxy._fired(mode)
                    break
                if mode == "cut_first_line":
                    # Exactly the first request line survives the "crash":
                    # deterministic mid-batch partial delivery (the
                    # server's readline guard drops the torn remainder).
                    newline = data.find(b"\n")
                    if newline >= 0:
                        self.upstream.sendall(data[: newline + 1])
                    proxy._fired(mode)
                    break
                if mode == "drop_reply":
                    # Forward the request fully; the down pump will eat
                    # the server's reply: applied-and-reply-lost.
                    self.drop_reply_armed = True
                    proxy._fired(mode)
                if proxy.blackhole:
                    continue  # swallow bytes; the client times out
                if proxy.stall_s:
                    time.sleep(proxy.stall_s)
                self.upstream.sendall(data)
        except OSError:
            pass
        finally:
            self.close()

    def _pump_down(self):
        """upstream -> client."""
        proxy = self.proxy
        try:
            while not self._closed.is_set():
                data = self.upstream.recv(65536)
                if not data:
                    break
                if self.drop_reply_armed:
                    break  # reply eaten; connection dies with it
                if proxy.blackhole:
                    continue
                if proxy.stall_s:
                    time.sleep(proxy.stall_s)
                self.client.sendall(data)
        except OSError:
            pass
        finally:
            self.close()


class FaultProxy:
    """TCP fault proxy between a NetworkDB client and a real DBServer.

    Point the client at ``serve_background()``'s address; bytes flow
    through unmodified until a fault is requested:

    - ``fail_next(mode)`` arms a ONE-SHOT fault against the next client
      transmission: ``"drop_request"`` (connection dies before anything
      reaches the server — never applied), ``"drop_reply"`` (request
      forwarded whole, reply eaten — applied but unknowable),
      ``"cut_first_line"`` (only the first request line of a batch/
      pipeline survives — deterministic partial application);
    - ``set_stall(seconds)`` / ``set_blackhole(on)`` shape every
      connection until cleared (latency spikes / a black-holed link);
    - ``drop_all()`` kills every live connection now (a server restart's
      client-side signature).

    ``faults_fired`` counts by mode; ``connections_accepted`` and
    ``connections_dropped`` track churn — the chaos suite correlates
    these with the client's ``reconnects`` counter.
    """

    def __init__(self, upstream_host, upstream_port, listen_host="127.0.0.1",
                 timeout=60.0):
        self.upstream_host = upstream_host
        self.upstream_port = int(upstream_port)
        self.listen_host = listen_host
        self.timeout = timeout
        self.stall_s = 0.0
        self.blackhole = False
        self.connections_accepted = 0
        self.connections_dropped = 0
        #: Wall-clock of every accepted connection (monotonic): the
        #: reconnect-herd tests assert the SPREAD of these after a
        #: drop_all() — lockstep re-handshakes all land within one jitter
        #: window, spread ones don't.
        self.accept_times = []
        #: When True, every client->upstream byte is appended to
        #: ``captured_up`` (across connections, in order): the router
        #: pass-through differential compares these byte streams.
        self.capture = False
        self.captured_up = bytearray()
        self.faults_fired = {}
        self._mode = None
        self._lock = threading.Lock()
        self._conns = set()
        self._listener = None
        self._stopped = threading.Event()
        self.address = None

    # --- lifecycle ----------------------------------------------------------
    def serve_background(self):
        """Bind + accept on a daemon thread; returns (host, port)."""
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.listen_host, 0))
        listener.listen()
        self._listener = listener
        self.address = listener.getsockname()[:2]
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self.address

    def _accept_loop(self):
        while not self._stopped.is_set():
            try:
                client, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            try:
                conn = _ProxyConnection(self, client)
            except OSError:
                # Upstream down: refuse by closing, the client sees a
                # connection error exactly as with a dead server.
                try:
                    client.close()
                except OSError:
                    pass
                continue
            with self._lock:
                self._conns.add(conn)
                self.connections_accepted += 1
                self.accept_times.append(time.monotonic())
            conn.start()

    def stop(self):
        self._stopped.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        self.drop_all()

    # --- fault controls -----------------------------------------------------
    def fail_next(self, mode):
        if mode not in ("drop_request", "drop_reply", "cut_first_line"):
            raise ValueError(f"unknown proxy fault mode {mode!r}")
        with self._lock:
            self._mode = mode

    def set_stall(self, seconds):
        self.stall_s = float(seconds)

    def set_blackhole(self, on=True):
        self.blackhole = bool(on)

    def drop_all(self):
        with self._lock:
            doomed = list(self._conns)
        for conn in doomed:
            conn.close()

    # --- internals ----------------------------------------------------------
    def _take_mode(self):
        with self._lock:
            mode, self._mode = self._mode, None
            return mode

    def _fired(self, mode):
        with self._lock:
            self.faults_fired[mode] = self.faults_fired.get(mode, 0) + 1

    def _forget(self, conn):
        with self._lock:
            if conn in self._conns:
                self._conns.discard(conn)
                self.connections_dropped += 1
