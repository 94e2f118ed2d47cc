"""The suggest gateway: one long-lived process, one card, N experiments
(port of ``orion_tpu/serve/gateway.py``).

A :class:`GatewayServer` owns the algorithm instances for every attached
tenant and runs a **coalescing dispatcher**: suggest requests arriving
within a small window (or already queued) whose fused-step signatures
match are dispatched together (``orion_tpu_torch.serve.coalesce``: each
tenant's standalone round, one graph replay each, back to back), then
demultiplexed back to per-tenant replies — the window, the wire and the
host orchestration are shared across tenants instead of being paid per
experiment.  The gateway owns the card: ``device`` (None means ``cuda``,
and the constructor raises where no card is present) goes
to every tenant's ``create_algo``, while its workers' processes never
touch the card.

Discipline reused from ``storage/netdb.py``'s server: a
``ThreadingTCPServer`` whose handler threads speak the newline-framed JSON
wire (one request line, one reply line, torn lines dropped), plus an
optional rate-limited persist snapshot (atomic tempfile + rename) so a
restarted gateway resumes its tenants — here the snapshot is the tenants'
``state_dict``s, which restore history, trust-region box AND the RNG
stream, so persisted restarts keep suggestion streams intact.  Without
persist, a restart surfaces as ``UnknownTenant`` and the client-side
adapter re-attaches and replays.

**Tenancy**: per-tenant quotas (``max_inflight`` concurrent suggests,
``max_q`` rows per ask), fair-share interleaving inside the coalescer
(round-robin across tenants, so one chatty tenant cannot monopolize a
dispatch), and backpressure — a bounded admission queue and quota refusals
answer with a structured RETRY-AFTER reply the client's retry policy backs
off on.  Tenant eviction (LRU-idle, on attach overflow) and backpressure
are flight-recorder events.

**Observability**: ``serve.*`` counters/gauges/histograms through the
process-wide telemetry registry (``serve.coalesce.width``,
``serve.queue_depth``, per-tenant request latency histograms), and every
suggest reply carries a health record (tenant algorithm health + serve
fields) the client-side adapter hands to its producer's health channel —
gateway rounds thereby show up in ``orion-tpu-torch top``/``info`` with no
storage access from the gateway itself.
"""

import base64
import copy
import logging
import os
import pickle
import queue
import socket
import socketserver
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from orion_tpu_torch.algo.base import BaseAlgorithm, create_algo
from orion_tpu_torch.analysis.sanitizer import TSAN
from orion_tpu_torch.core.producer import _advance_rng
from orion_tpu_torch.device import resolve_device
from orion_tpu_torch.health import FLIGHT
from orion_tpu_torch.serve.coalesce import LAST_STACK_PLACEMENT, run_coalesced_plans
from orion_tpu_torch.serve.fleet import (
    HANDOFF_TTL_S,
    FleetState,
    TenantStore,
    ring_key,
)
from orion_tpu_torch.serve.protocol import (
    GATEWAY_OPS,
    GatewayError,
    dumps_line,
    error_reply,
    ok_reply,
    read_line,
)
from orion_tpu_torch.space.dsl import build_space
from orion_tpu_torch.storage.backends import atomic_pickle_dump
from orion_tpu_torch.storage.netdb import ServerHandshake, _derive_key
from orion_tpu_torch.telemetry import TELEMETRY, TraceContext

log = logging.getLogger(__name__)

#: Per-tenant ledgers are bounded: applied-id memory (observe/register
#: dedup) and the suggest reply cache only need to cover the client's
#: retry horizon, not the experiment's lifetime.
APPLIED_IDS_CAP = 4096
REPLY_CACHE_CAP = 32


def _host_rows(rows):
    """A round's rows as a host float32 array (one device->host copy)."""
    if torch.is_tensor(rows):
        rows = rows.detach().cpu()
    return np.asarray(rows, dtype=np.float32)


class _Tenant:
    """One hosted experiment: its algorithm, quotas, ledgers, counters."""

    def __init__(self, name, space, priors, algo_config, seed, algo,
                 max_inflight, max_q):
        self.name = name
        self.space = space
        self.priors = dict(priors)
        self.algo_config = algo_config
        self.seed = seed
        self.algo = algo
        self.max_inflight = max_inflight
        self.max_q = max_q
        self.created_at = time.time()
        self.last_active = time.monotonic()
        self.inflight = 0  # mutated under the gateway lock only
        # Handoff fence (fleet mode): monotonic fence time while this
        # tenant's state is in flight to another member.  A fenced tenant
        # answers RETRY-AFTER — never a second suggestion stream.
        self.fenced = None
        self.naive_algo = None
        self.naive_epoch = None
        self.reply_cache = OrderedDict()
        self.applied_ids = set()
        self.applied_order = deque()
        self.suggests = 0
        self.observes = 0
        # Computed ONCE so the per-request hot path books its latency
        # histogram without building a metric name per call.
        self.metric_request = f"serve.tenant.{name}.request"
        # Whether register_suggestion forwarding is worth the wire bytes:
        # only algorithms that actually override the hook want it.
        self.wants_register = (
            type(algo).register_suggestion
            is not BaseAlgorithm.register_suggestion
        )

    def remember_applied(self, applied_id):
        TSAN.write("GatewayServer.tenant_ledgers", self)
        self.applied_ids.add(applied_id)
        self.applied_order.append(applied_id)
        while len(self.applied_order) > APPLIED_IDS_CAP:
            self.applied_ids.discard(self.applied_order.popleft())

    def cache_reply(self, req_id, reply):
        if not req_id:
            return
        TSAN.write("GatewayServer.tenant_ledgers", self)
        self.reply_cache[req_id] = reply
        while len(self.reply_cache) > REPLY_CACHE_CAP:
            self.reply_cache.popitem(last=False)

    def state_snapshot(self):
        """Persistable description (config + ``state_dict``): restoring it
        rebuilds the algorithm with history, box and RNG stream intact.
        The applied-id ledger rides along — a client replaying its log
        against a restored-but-stale tenant must have the already-
        snapshotted batches dedup, not double-observe.  So does the
        suggest reply cache: a client whose reply was lost to the CRASH
        re-asks the restored tenant with the same req_id and must get the
        SAME rows back, not a second RNG draw — the fleet failover's
        bit-identity hinges on it."""
        TSAN.read("GatewayServer.tenant_ledgers", self)
        return {
            "priors": dict(self.priors),
            "algo_config": self.algo_config,
            "seed": self.seed,
            "max_inflight": self.max_inflight,
            "max_q": self.max_q,
            "state": self.algo.state_dict(),
            "applied_ids": list(self.applied_order),
            "reply_cache": list(self.reply_cache.items()),
        }


class _WorkItem:
    """One queued request: payload in, reply out, a handler thread parked
    on ``done`` in between."""

    __slots__ = ("op", "tenant_name", "payload", "reply", "done", "counted",
                 "enqueued_at", "ctx")

    def __init__(self, op, payload):
        self.op = op
        self.tenant_name = str(payload.get("tenant") or "")
        self.payload = payload
        self.reply = None
        self.done = threading.Event()
        self.counted = False  # holds an inflight-quota slot
        self.enqueued_at = time.perf_counter()
        # Distributed-trace adoption: the client's injected context (only
        # present when the CLIENT ran with telemetry on) parents this
        # request's gateway-side spans and is what the coalesced dispatch
        # span links back to.  Absent/malformed -> None, zero cost.
        self.ctx = TraceContext.from_wire(payload.get("ctx"))


def _encode_snapshot(snapshot):
    """Tenant snapshot -> JSON-safe string for the handoff wire.  Pickle
    is acceptable HERE because the surface is gateway→gateway inside one
    authenticated credential domain (the mutual-HMAC handshake gates it)
    — it is never fed client input."""
    return base64.b64encode(
        pickle.dumps(snapshot, protocol=pickle.HIGHEST_PROTOCOL)
    ).decode("ascii")


def _decode_snapshot(encoded):
    return pickle.loads(base64.b64decode(str(encoded)))


#: Sentinel reply meaning "hang up instead of answering": a stopping
#: gateway must CLOSE the connection, not send an error — the client's
#: reconnect then lands on whatever replaced this gateway on the address
#: (the restart-transparency contract).
_CLOSE = object()


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        # Per-connection mutual-HMAC handshake state — the SAME
        # PBKDF2/HMAC-SHA256 challenge-response the netdb wire runs
        # (storage/netdb.py), so the two surfaces cannot drift on the
        # credential contract.  ping stays open for health probes.
        auth = ServerHandshake(self.server.auth_key)
        while True:
            try:
                request = read_line(self.rfile)
            except (ValueError, OSError) as exc:
                log.warning(
                    "bad gateway request from %s: %s", self.client_address, exc
                )
                return
            if request is None:
                return
            op = request.get("op")
            if op in ServerHandshake.AUTH_OPS:
                reply = auth.step(request)
            elif not auth.authenticated and op != "ping":
                reply = error_reply(
                    "AuthenticationError",
                    "authentication required (gateway started with a secret)",
                )
            else:
                reply = self.server.handle_request(request)
            if reply is _CLOSE:
                return
            self.wfile.write(dumps_line(reply))
            if auth.hangup:
                # Failed credential check: force a reconnect (and a fresh
                # nonce) per guess — brute force pays a TCP handshake each.
                return


class GatewayServer(socketserver.ThreadingTCPServer):
    """Serve suggest/observe traffic for many experiments over one card.

    Knobs (constructor args = `orion-tpu-torch serve` flags = ``serve:``
    config):

    - ``window``: seconds the dispatcher waits after the first queued
      suggest for more same-signature traffic to coalesce with;
    - ``max_width``: the most tenants in one coalesced dispatch;
    - ``max_tenants`` / ``max_inflight`` / ``max_q`` / ``pending_limit``:
      the tenancy quotas (see module docstring);
    - ``persist`` / ``persist_interval``: optional tenant-state snapshot;
    - ``device``: the tenants' device (None means ``cuda``; no fallback).
    """

    allow_reuse_address = True
    daemon_threads = True

    def __init__(
        self,
        host="127.0.0.1",
        port=0,
        window=0.004,
        max_width=8,
        max_tenants=256,
        max_inflight=4,
        max_q=4096,
        pending_limit=256,
        request_timeout=120.0,
        persist=None,
        persist_interval=5.0,
        metrics_port=None,
        secret=None,
        fleet=None,
        advertise=None,
        handoff_ttl=HANDOFF_TTL_S,
        device=None,
    ):
        self.device = resolve_device(device)
        # Shared-secret authentication, reusing the netdb wire's PBKDF2
        # key stretch + mutual HMAC handshake.  None = open gateway
        # (localhost development, --no-auth).
        self.secret = secret
        self.auth_key = _derive_key(secret) if secret is not None else None
        self.window = float(window)
        self.max_width = max(1, int(max_width))
        self.max_tenants = int(max_tenants)
        self.max_inflight = int(max_inflight)
        self.max_q = int(max_q)
        self.pending_limit = int(pending_limit)
        self.request_timeout = float(request_timeout)
        self.persist = persist
        self.persist_interval = float(persist_interval)
        self._tenants = {}
        self._lock = threading.Lock()
        self._queue = queue.Queue()
        self._stop = threading.Event()
        self._dirty = False  # persist snapshot pending (dispatcher-owned)
        self._last_persist = 0.0
        self._stats = {
            "suggests": 0,
            "observes": 0,
            "dispatches": 0,
            "coalesced_dispatches": 0,
            "coalesced_suggests": 0,
            "backpressure": 0,
            "evictions": 0,
            "max_width": 0,
            "widths": {},
            "handoffs": 0,
            "handoff_failures": 0,
            "imports": 0,
            "wrong_gateway": 0,
        }
        # --- fleet mode ---------------------------------------------------
        # ``fleet`` is the member address list (this gateway included,
        # identified by ``advertise``); placement is the shared hash ring
        # (fleet.FleetState) every client computes identically.  In fleet
        # mode ``persist`` is a DIRECTORY of per-tenant snapshots
        # (TenantStore) and persistence turns SYNCHRONOUS: the round's
        # dirty tenants are written before the round's replies are
        # released, so a kill -9 can lose a reply but never an
        # acknowledged observation or a cached suggest draw.
        self.handoff_ttl = float(handoff_ttl)
        self.advertise = None
        self._fleet = None
        self._store = None
        self._moved = OrderedDict()  # tenant -> destination tombstone
        self._dirty_tenants = set()  # sync-persist worklist (dispatcher)
        self._deferred = None  # reply-release buffer while sync persisting
        self._peers = {}  # member address -> GatewayClient (handoff push)
        if fleet:
            if advertise is None:
                raise GatewayError(
                    "fleet mode needs --advertise (this gateway's own "
                    "address as the OTHER members and clients dial it)"
                )
            self._fleet = FleetState(fleet)
            try:
                self.advertise = self._fleet.addresses[
                    self._fleet.index_of(advertise)
                ]
            except ValueError:
                raise GatewayError(
                    f"advertise address {advertise!r} is not in the fleet "
                    f"member list {list(self._fleet.addresses)}"
                )
            if persist:
                self._store = TenantStore(persist)
        # Track label for this gateway's own spans: a distinct Perfetto
        # track even when the gateway runs in-process with its clients.
        self._span_track = f"gateway:{socket.gethostname()}:{os.getpid()}"
        if self._store is not None:
            self._restore_store()
        elif persist and os.path.exists(persist):
            self._restore(persist)
        super().__init__((host, int(port)), _Handler)
        # Optional pull-based metrics plane: /metrics (Prometheus text
        # exposition of the process registry) + /healthz (queue depth,
        # tenant count) on a stdlib http.server daemon thread.  A bind
        # failure fails the CONSTRUCTOR (the operator explicitly asked for
        # a scrape endpoint; a gateway silently missing its monitoring is
        # worse than one that won't start) — but never leaks the already-
        # bound gateway socket.
        self._metrics_server = None
        if metrics_port is not None:
            from orion_tpu_torch.metrics import MetricsServer

            try:
                self._metrics_server = MetricsServer(
                    port=int(metrics_port), healthz=self._healthz_snapshot
                )
            except OSError:
                self.server_close()
                raise
            self._metrics_server.start()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="orion-tpu-torch-gateway", daemon=True
        )
        self._dispatcher.start()

    def _healthz_snapshot(self):
        """The /healthz payload: liveness plus the two saturation signals
        an external prober needs (bounded queue depth, hosted tenants),
        plus the DOCTOR summary block (orion_tpu_torch.diagnosis — a fresh pass
        over this process's registry: queue saturation, backpressure,
        retrace storms all read from local counters) so k8s-style probes
        key off diagnosis, not bare socket liveness.  Runs on the metrics
        server's handler threads — the tenant-table read rides the
        gateway lock like every other cross-thread read."""
        with self._lock:
            TSAN.read("GatewayServer._tenants", self)
            tenants = len(self._tenants)
        from orion_tpu_torch.diagnosis import doctor_summary

        return {
            "ok": True,
            "queue_depth": self._queue.qsize(),
            "tenants": tenants,
            "stopping": self._stop.is_set(),
            "doctor": doctor_summary(),
        }

    # --- lifecycle -----------------------------------------------------------
    @property
    def address(self):
        return self.server_address[:2]

    def serve_background(self):
        """Start accepting on a daemon thread; returns (host, port)."""
        thread = threading.Thread(target=self.serve_forever, daemon=True)
        thread.start()
        return self.address

    def shutdown(self):
        self._stop.set()
        super().shutdown()
        self._dispatcher.join(timeout=5.0)
        if self._metrics_server is not None:
            self._metrics_server.stop()
        for peer in self._peers.values():
            peer.close()
        # Final durable snapshot — same exit discipline as DBServer.
        if self._store is not None:
            self._persist_dirty_tenants()
        elif self.persist and self._dirty:
            self._write_snapshot()

    def kill(self):
        """Simulated crash (tests/bench): stop serving WITHOUT the final
        snapshot or any orderly reply drain — in-flight requests see their
        connections die exactly as a ``kill -9`` would leave them.  What
        survives is whatever the sync-persist discipline already put on
        disk, which is precisely the fleet's failover contract."""
        self._stop.set()
        super().shutdown()
        self.server_close()
        self._dispatcher.join(timeout=5.0)
        if self._metrics_server is not None:
            self._metrics_server.stop()
        for peer in self._peers.values():
            peer.close()

    def _tenant_from_snapshot(self, name, saved):
        """Rebuild one tenant from a persisted ``state_snapshot()`` — the
        shared restore path for boot-time snapshots, lazy store restores
        and handoff imports.  ``set_state`` reinstates history, box AND
        the RNG stream, so the rebuilt tenant's next draw is the exact
        draw the snapshotted one would have made."""
        space = build_space(saved["priors"])
        algo = create_algo(space, saved["algo_config"], seed=saved.get("seed"),
                           device=self.device)
        algo.set_state(saved["state"])
        tenant = _Tenant(
            name,
            space,
            saved["priors"],
            saved["algo_config"],
            saved.get("seed"),
            algo,
            saved.get("max_inflight", self.max_inflight),
            saved.get("max_q", self.max_q),
        )
        for applied_id in saved.get("applied_ids") or ():
            tenant.remember_applied(applied_id)
        for req_id, reply in saved.get("reply_cache") or ():
            tenant.cache_reply(req_id, reply)
        return tenant

    def _restore(self, path):
        try:
            with open(path, "rb") as handle:
                snapshot = pickle.load(handle)
        except Exception:
            log.exception("could not restore gateway snapshot %s", path)
            return
        for name, saved in (snapshot.get("tenants") or {}).items():
            try:
                tenant = self._tenant_from_snapshot(name, saved)
                # _restore runs from __init__ (pre-thread), but tenant-map
                # writes stay under the lock everywhere for one invariant.
                with self._lock:
                    TSAN.write("GatewayServer._tenants", self)
                    self._tenants[name] = tenant
            except Exception:
                log.exception("could not restore tenant %r", name)
        if self._tenants:
            log.info(
                "gateway restored %d tenant(s) from %s", len(self._tenants),
                path,
            )

    def _restore_store(self):
        """Boot-time fleet restore: adopt the store's tenants THIS member
        owns per the ring.  Foreign tenants stay on disk — their owners
        restore them lazily on first touch, and eagerly adopting them
        here would fork tenants the rest of the fleet is still serving."""
        restored = 0
        for name, saved in self._store.items():
            if self._fleet.owner(ring_key(name)) != self.advertise:
                continue
            try:
                tenant = self._tenant_from_snapshot(name, saved)
            except Exception:
                log.exception("could not restore tenant %r", name)
                continue
            with self._lock:
                TSAN.write("GatewayServer._tenants", self)
                self._tenants[name] = tenant
            restored += 1
        if restored:
            log.info(
                "gateway %s restored %d owned tenant(s) from %s",
                self.advertise, restored, self._store.root,
            )

    def _write_snapshot(self):
        """Build + write the tenant snapshot atomically.  The build holds
        the gateway lock: the dispatcher owns it in steady state, but
        ``shutdown()`` (and tests) call it from OTHER threads, and the
        sanitizer flagged the bare tenant-table/ledger reads racing the
        dispatcher's mutations.  The rate limit keeps the O(history)
        ``state_dict`` walk off every round; the file write stays outside
        the lock."""
        with self._lock:
            TSAN.read("GatewayServer._tenants", self)
            snapshot = {
                "tenants": {
                    name: tenant.state_snapshot()
                    for name, tenant in self._tenants.items()
                }
            }
        atomic_pickle_dump(self.persist, snapshot)
        self._dirty = False
        self._last_persist = time.monotonic()

    def _mark_dirty(self, tenant_name=None):
        """Persist bookkeeping: the legacy whole-snapshot flag plus the
        fleet store's per-tenant worklist (the sync-persist set drained
        before the cycle's replies release)."""
        self._dirty = True
        if self._store is not None and tenant_name:
            self._dirty_tenants.add(tenant_name)

    def _persist_dirty_tenants(self):
        """Write every dirty tenant's snapshot file (fleet store mode).
        Runs on the dispatcher between processing a cycle and releasing
        its replies — the write happening BEFORE the release is the whole
        durability contract: an acknowledged observation or a delivered
        suggest draw is always on disk before any client can act on it."""
        dirty, self._dirty_tenants = self._dirty_tenants, set()
        if not dirty:
            return
        for name in dirty:
            with self._lock:
                TSAN.read("GatewayServer._tenants", self)
                tenant = self._tenants.get(name)
                snapshot = tenant.state_snapshot() if tenant else None
            if snapshot is not None:
                self._store.save(name, snapshot)
        self._dirty = False
        self._last_persist = time.monotonic()

    def _maybe_persist(self):
        if self._store is not None:
            # Fleet mode persists synchronously per cycle; nothing rides
            # the rate-limited path.
            return
        if not (self.persist and self._dirty):
            return
        if time.monotonic() - self._last_persist < self.persist_interval:
            return
        self._write_snapshot()

    # --- request admission (handler threads) ---------------------------------
    def handle_request(self, request):
        if self._stop.is_set():
            # A stopping gateway hangs up rather than queueing work its
            # dispatcher will never run — the client reconnects and finds
            # the restarted gateway on this address.
            return _CLOSE
        op = request.get("op")
        if op not in GATEWAY_OPS:
            return error_reply("GatewayError", f"bad op {op!r}")
        if op == "ping":
            return ok_reply("pong")
        if op == "stats":
            return ok_reply(self.stats_snapshot())
        if op == "fleet":
            # Membership/occupancy probe: answered inline like stats (the
            # `top --all` header and the router bootstrap read it — a
            # probe must not queue behind the dispatch backlog it is
            # trying to measure).
            return ok_reply(self.fleet_snapshot())
        item = _WorkItem(op, request)
        refused = self._admit(item)
        if refused is not None:
            return refused
        if not item.done.wait(self.request_timeout):
            # A backlog the dispatcher could not drain in time is OVERLOAD,
            # not a protocol failure: answer transiently (RetryAfter) so
            # the client backs off instead of crashing its worker.  The
            # orphaned item still executes when the dispatcher reaches it
            # — safe by the same id-dedup contracts a lost reply rides:
            # the re-asked suggest hits the req_id reply cache, a re-sent
            # observe/register dedups on its minted id.
            return self._retry_after_reply(
                f"gateway did not answer {op!r} within "
                f"{self.request_timeout}s (dispatcher backlog)"
            )
        return item.reply

    def _retry_after_reply(self, message):
        delay = round(max(4 * self.window, 0.02), 3)
        if FLIGHT.enabled:
            FLIGHT.record("serve.backpressure", args={"message": message})
        TELEMETRY.count("serve.backpressure")
        return error_reply(
            "RetryAfter", message, retry_after=delay
        )

    def _admit(self, item):
        """Admission control, under the gateway lock: bounded queue +
        per-tenant inflight quota.  Returns a refusal reply, or None when
        the item was queued."""
        with self._lock:
            TSAN.read("GatewayServer._tenants", self)
            if self._queue.qsize() >= self.pending_limit:
                self._stats["backpressure"] += 1
                refused = True
                message = (
                    f"gateway queue full ({self.pending_limit} pending)"
                )
            else:
                refused = False
                if item.op == "suggest":
                    tenant = self._tenants.get(item.tenant_name)
                    if tenant is not None:
                        TSAN.write("GatewayServer.tenant_counters", self)
                        if tenant.inflight >= tenant.max_inflight:
                            self._stats["backpressure"] += 1
                            refused = True
                            message = (
                                f"tenant {item.tenant_name!r} already has "
                                f"{tenant.inflight} suggest(s) in flight"
                            )
                        else:
                            tenant.inflight += 1
                            item.counted = True
                if not refused:
                    self._queue.put(item)
        if refused:
            return self._retry_after_reply(message)
        return None

    # --- the coalescing dispatcher -------------------------------------------
    def _dispatch_loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if self._stop.is_set():
                self._queue.put(first)
                break
            batch = [first]
            while True:  # opportunistic drain of everything already queued
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            if any(item.op == "suggest" for item in batch):
                # Coalescing window: wait a beat for other tenants' suggest
                # traffic to arrive so it can ride THIS device dispatch.
                deadline = time.monotonic() + self.window
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._queue.get(timeout=remaining))
                    except queue.Empty:
                        break
            TELEMETRY.set_gauge("serve.queue_depth", self._queue.qsize())
            if self._store is not None:
                # Sync-persist cycle: replies computed below are BUFFERED
                # (``_finish`` parks them on ``_deferred``) and released
                # only after the dirty tenants' snapshots hit disk.
                self._deferred = []
            try:
                self._process(batch)
            except Exception:  # pragma: no cover - per-item paths catch first
                log.exception("gateway dispatch cycle failed")
                for item in batch:
                    if not item.done.is_set():
                        self._finish(
                            item,
                            error_reply(
                                "GatewayError", "internal dispatch failure"
                            ),
                        )
            if self._deferred is not None:
                deferred, self._deferred = self._deferred, None
                try:
                    self._persist_dirty_tenants()
                finally:
                    for item in deferred:
                        item.done.set()
            self._maybe_persist()
            self._publish_fleet_gauges()
        # Stopping: anything still queued gets the hang-up sentinel so its
        # handler closes the connection and the client re-asks elsewhere.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            self._finish(item, _CLOSE)

    def _finish(self, item, reply):
        if item.counted:
            with self._lock:
                TSAN.write("GatewayServer.tenant_counters", self)
                tenant = self._tenants.get(item.tenant_name)
                if tenant is not None:
                    tenant.inflight = max(0, tenant.inflight - 1)
            item.counted = False
        item.reply = reply
        if self._deferred is not None and reply is not _CLOSE:
            # Sync-persist deferral: the handler thread stays parked until
            # the cycle's snapshots are durable (_dispatch_loop releases).
            self._deferred.append(item)
        else:
            item.done.set()
        if TELEMETRY.enabled and item.ctx is not None:
            # The gateway-side half of the request's distributed trace:
            # queue wait + execution, parented at the client's injected
            # context, on this gateway's own track.  histogram=False — the
            # observe() below is the sample's one histogram home.
            TELEMETRY.record_span(
                "serve.request",
                start=item.enqueued_at,
                args={"op": item.op},
                parent_ctx=item.ctx,
                track=self._span_track,
                histogram=False,
            )
        TELEMETRY.observe(
            "serve.request", time.perf_counter() - item.enqueued_at
        )

    def _process(self, batch):
        suggests = []
        for item in batch:
            if item.op == "suggest":
                suggests.append(item)
                continue
            try:
                reply = self._apply(item)
            except GatewayError as exc:
                reply = error_reply(type(exc).__name__, str(exc))
            except Exception as exc:
                log.exception("gateway op %r failed", item.op)
                reply = error_reply(type(exc).__name__, str(exc))
            self._finish(item, reply)
        if suggests:
            self._run_suggests(suggests)

    # --- non-suggest ops ------------------------------------------------------
    def _apply(self, item):
        payload = item.payload
        if item.op == "fleet_set":
            return self._fleet_set(payload)
        if item.op == "handoff_import":
            return self._handoff_import(payload)
        if item.op == "attach":
            return self._attach(payload)
        if item.op == "detach":
            with self._lock:
                TSAN.write("GatewayServer._tenants", self)
                self._tenants.pop(item.tenant_name, None)
                self._moved.pop(item.tenant_name, None)
            if self._store is not None:
                self._store.delete(item.tenant_name)
            self._dirty = True
            return ok_reply({"detached": True})
        tenant, refusal = self._route(item.tenant_name, payload)
        if refusal is not None:
            return refusal
        if tenant is None:
            return error_reply(
                "UnknownTenant", f"no tenant {item.tenant_name!r} attached"
            )
        tenant.last_active = time.monotonic()
        if item.op == "observe":
            return self._observe(tenant, payload)
        if item.op == "register":
            return self._register(tenant, payload)
        return error_reply("GatewayError", f"bad op {item.op!r}")

    def _wrong_gateway_reply(self, name, owner):
        """The structured off-ring refusal: carries the authoritative
        membership + epoch so one bounce teaches the client the fleet."""
        with self._lock:
            TSAN.write("GatewayServer.tenant_counters", self)
            self._stats["wrong_gateway"] += 1
        TELEMETRY.count("serve.fleet.wrong_gateway")
        return error_reply(
            "WrongGateway",
            f"tenant {name!r} belongs to gateway {owner} "
            f"(fleet epoch {self._fleet.epoch})",
            owner=owner,
            addresses=list(self._fleet.addresses),
            epoch=self._fleet.epoch,
        )

    def _restore_tenant_from_store(self, name):
        """Lazy store restore (fleet mode): first touch of a tenant this
        member owns whose state a previous owner (or a previous life of
        this one) persisted.  Returns the installed tenant or None."""
        if self._store is None:
            return None
        saved = self._store.load(name)
        if saved is None:
            return None
        try:
            tenant = self._tenant_from_snapshot(name, saved)
        except Exception:
            log.exception("could not restore tenant %r from store", name)
            return None
        with self._lock:
            TSAN.write("GatewayServer._tenants", self)
            self._tenants[name] = tenant
            self._moved.pop(name, None)  # we hold it again: drop the tombstone
        TELEMETRY.count("serve.fleet.store_restores")
        log.info(
            "gateway %s restored tenant %r from the fleet store "
            "(n_observed=%d)", self.advertise, name, int(tenant.algo.n_observed),
        )
        return tenant

    def _route(self, name, payload):
        """Fleet-aware tenant resolution: ``(tenant, refusal_reply)``.

        The who-wins ladder (see docs/serving.md):

        1. A member HOLDING the tenant serves it whatever the ring says
           (pinned — the holder's state is the live stream), unless the
           tenant is fenced mid-handoff (RETRY-AFTER: the state is in
           flight, answering would fork the stream).
        2. A moved tombstone, or ring ownership elsewhere, answers
           ``WrongGateway`` with the authoritative membership — except
           when the client declared a ``takeover`` (its router marked the
           ring owner down; refusing would bounce the pair forever).
        3. Owned-but-absent falls through to the lazy store restore, then
           to the caller's UnknownTenant / create path."""
        TSAN.read("GatewayServer._tenants", self)
        tenant = self._tenants.get(name)
        if self._fleet is None:
            return tenant, None
        if tenant is not None:
            if tenant.fenced is not None:
                return None, self._retry_after_reply(
                    f"tenant {name!r} is fenced for a handoff"
                )
            return tenant, None
        takeover = bool(payload.get("takeover"))
        dest = self._moved.get(name)
        if dest is not None and not takeover:
            return None, self._wrong_gateway_reply(name, dest)
        owner = self._fleet.owner(ring_key(name))
        if owner != self.advertise and not takeover:
            return None, self._wrong_gateway_reply(name, owner)
        return self._restore_tenant_from_store(name), None

    def _attach(self, payload):
        name = str(payload.get("tenant") or "")
        if not name:
            return error_reply("GatewayError", "attach requires a tenant name")
        tenant, refusal = self._route(name, payload)
        if refusal is not None:
            return refusal
        if tenant is not None:
            tenant.last_active = time.monotonic()
            return ok_reply(
                {
                    "created": False,
                    "n_observed": int(tenant.algo.n_observed),
                    "wants_register": tenant.wants_register,
                }
            )
        TSAN.read("GatewayServer._tenants", self)
        if len(self._tenants) >= self.max_tenants:
            evicted = self._evict_idle()
            if not evicted:
                return self._retry_after_reply(
                    f"gateway at max_tenants={self.max_tenants} with every "
                    "tenant busy"
                )
        priors = dict(payload.get("priors") or {})
        if not priors:
            return error_reply("GatewayError", "attach requires priors")
        quotas = dict(payload.get("quotas") or {})
        space = build_space(priors)
        algo = create_algo(space, payload.get("algo"), seed=payload.get("seed"),
                           device=self.device)
        tenant = _Tenant(
            name,
            space,
            priors,
            payload.get("algo"),
            payload.get("seed"),
            algo,
            # Client quotas may only tighten the server caps, never raise
            # them — the caps are the operator's protection.
            min(self.max_inflight, int(quotas.get("max_inflight") or self.max_inflight)),
            min(self.max_q, int(quotas.get("max_q") or self.max_q)),
        )
        with self._lock:
            TSAN.write("GatewayServer._tenants", self)
            self._tenants[name] = tenant
            self._moved.pop(name, None)
        self._mark_dirty(name)
        TELEMETRY.count("serve.attaches")
        log.info("gateway attached tenant %r (%s)", name, payload.get("algo"))
        return ok_reply(
            {
                "created": True,
                "n_observed": 0,
                "wants_register": tenant.wants_register,
            }
        )

    def _evict_idle(self):
        """Drop the least-recently-active tenant with nothing in flight.
        Its durable truth lives in the experiment's storage and the
        client-side replay log — eviction costs a re-attach + replay, not
        data."""
        with self._lock:
            TSAN.write("GatewayServer._tenants", self)
            idle = [t for t in self._tenants.values() if t.inflight == 0]
            if not idle:
                return None
            victim = min(idle, key=lambda t: t.last_active)
            del self._tenants[victim.name]
            self._stats["evictions"] += 1
        if self._store is not None:
            # Fleet mode: write-through before forgetting, so the next
            # touch lazily restores the full state instead of costing the
            # client a replay.
            self._store.save(victim.name, victim.state_snapshot())
        self._dirty = True
        TELEMETRY.count("serve.evictions")
        if FLIGHT.enabled:
            FLIGHT.record("serve.evict", args={"tenant": victim.name})
        log.info("gateway evicted idle tenant %r", victim.name)
        return victim

    def _observe(self, tenant, payload):
        obs_id = payload.get("obs_id")
        TSAN.read("GatewayServer.tenant_ledgers", tenant)
        if obs_id is not None and obs_id in tenant.applied_ids:
            # Applied-and-reply-lost resend: ack without re-feeding the
            # algorithm — THE convergence contract mode="always" rides on.
            return ok_reply(
                {"applied": False, "n_observed": int(tenant.algo.n_observed)}
            )
        params = payload.get("params") or []
        objectives = payload.get("objectives") or []
        if len(params) != len(objectives):
            raise GatewayError(
                f"observe carries {len(params)} params for "
                f"{len(objectives)} objectives"
            )
        results = [{"objective": float(v)} for v in objectives]
        cube = payload.get("cube")
        cube_rows = (
            np.asarray(cube, dtype=np.float32) if cube is not None else None
        )
        tenant.algo.observe(params, results, cube=cube_rows)
        # Under the gateway lock: stats_snapshot reads the counters from
        # handler threads and _write_snapshot reads the applied ledger from
        # the shutdown thread — the bare mutations were sanitizer-found
        # data races.
        with self._lock:
            if obs_id is not None:
                tenant.remember_applied(obs_id)
            TSAN.write("GatewayServer.tenant_counters", self)
            tenant.observes += 1
            self._stats["observes"] += 1
        self._mark_dirty(tenant.name)
        TELEMETRY.count("serve.observes")
        return ok_reply(
            {"applied": True, "n_observed": int(tenant.algo.n_observed)}
        )

    def _register(self, tenant, payload):
        reg_id = payload.get("reg_id")
        TSAN.read("GatewayServer.tenant_ledgers", tenant)
        if reg_id is not None and reg_id in tenant.applied_ids:
            return ok_reply({"applied": False})
        for params in payload.get("params") or []:
            tenant.algo.register_suggestion(params)
        if reg_id is not None:
            # Ledger writes ride the gateway lock (see _observe).
            with self._lock:
                tenant.remember_applied(reg_id)
        self._mark_dirty(tenant.name)
        return ok_reply({"applied": True})

    # --- fleet membership + handoff ------------------------------------------
    def fleet_snapshot(self):
        """The ``fleet`` op payload: membership, epoch, and this member's
        occupancy — what `top --all` probes once per frame and what a
        router bootstraps its ring from.  A single (non-fleet) gateway
        answers a one-member fleet so the probe path never branches."""
        with self._lock:
            TSAN.read("GatewayServer._tenants", self)
            tenants = len(self._tenants)
            fenced = [t.fenced for t in self._tenants.values()
                      if t.fenced is not None]
            moved = len(self._moved)
        now = time.monotonic()
        fenced_age = max((now - f for f in fenced), default=0.0)
        if self._fleet is None:
            member = f"{self.address[0]}:{self.address[1]}"
            addresses, epoch = [member], 0
        else:
            member = self.advertise
            addresses = list(self._fleet.addresses)
            epoch = self._fleet.epoch
        return {
            "fleet": self._fleet is not None,
            "self": member,
            "addresses": addresses,
            "epoch": epoch,
            "tenants": tenants,
            "queue_depth": self._queue.qsize(),
            "fenced": len(fenced),
            "fenced_age_s": round(fenced_age, 3),
            "moved": moved,
            "handoffs": self._stats["handoffs"],
            "handoff_failures": self._stats["handoff_failures"],
        }

    def _publish_fleet_gauges(self):
        """The fleet's doctor surface: this member's tenant count under
        its stable ring index (``serve.fleet.tenants.g{i}`` — DX007 reads
        the spread) and the oldest fence age (``serve.fleet.fenced_age_s``
        — DX008's handoff-stuck signal).  A member the new membership
        leaves out has no ring index: it publishes the rest (the reference
        raises there, failing the ``fleet_set`` that removed it)."""
        if self._fleet is None or not TELEMETRY.enabled:
            return
        with self._lock:
            TSAN.read("GatewayServer._tenants", self)
            tenants = len(self._tenants)
            fenced = [t.fenced for t in self._tenants.values()
                      if t.fenced is not None]
        now = time.monotonic()
        if self.advertise in self._fleet.addresses:
            index = self._fleet.index_of(self.advertise)
            TELEMETRY.set_gauge(f"serve.fleet.tenants.g{index}", float(tenants))
        TELEMETRY.set_gauge("serve.fleet.members", float(len(self._fleet.addresses)))
        TELEMETRY.set_gauge("serve.fleet.epoch", float(self._fleet.epoch))
        TELEMETRY.set_gauge(
            "serve.fleet.fenced_age_s",
            round(max((now - f for f in fenced), default=0.0), 3),
        )

    def _peer_client(self, address):
        """The gateway→gateway client for handoff pushes: one cached
        connection per peer, the SAME shared secret (a fleet is one
        credential domain), and a tight policy — a push that cannot land
        inside it unfences the tenant and keeps serving locally."""
        client = self._peers.get(address)
        if client is None:
            from orion_tpu_torch.serve.client import GatewayClient, parse_address

            host, port = parse_address(address)
            client = GatewayClient(
                host=host, port=port, timeout=30.0, secret=self.secret,
                retry={"max_attempts": 3, "deadline": 15.0, "base_delay": 0.1},
            )
            self._peers[address] = client
        return client

    def _fleet_set(self, payload):
        """Operator membership change (`orion-tpu-torch serve` peers):
        adopt the new epoch, then hand off every held tenant the new ring
        assigns elsewhere.  Runs on the dispatcher — membership flips and
        handoffs are serialized against the request stream, so no suggest
        can interleave with a tenant's fence→export→flip."""
        if self._fleet is None:
            return error_reply(
                "GatewayError",
                "this gateway was not started in fleet mode (--fleet)",
            )
        addresses = payload.get("addresses") or []
        if not addresses:
            return error_reply("GatewayError", "fleet_set requires addresses")
        old_epoch = self._fleet.epoch if self._fleet is not None else 0
        epoch = int(payload.get("epoch") or old_epoch + 1)
        if epoch <= old_epoch and self._fleet is not None:
            return error_reply(
                "GatewayError",
                f"fleet_set epoch {epoch} is not newer than {old_epoch}",
            )
        fleet = FleetState(addresses, epoch=epoch)
        leaving = self.advertise not in fleet.addresses
        self._fleet = fleet
        with self._lock:
            TSAN.read("GatewayServer._tenants", self)
            held = list(self._tenants)
        moves = []
        for name in held:
            owner = fleet.owner(ring_key(name))
            if leaving or owner != self.advertise:
                moves.append((name, owner))
        failed = []
        for name, owner in moves:
            if not self._handoff(name, owner):
                failed.append(name)
        self._publish_fleet_gauges()
        log.info(
            "gateway %s adopted fleet epoch %d (%d member(s), %d handoff(s)"
            ", %d failed)", self.advertise, epoch, len(fleet.addresses),
            len(moves), len(failed),
        )
        return ok_reply(
            {
                "epoch": epoch,
                "addresses": list(fleet.addresses),
                "moved": len(moves) - len(failed),
                "failed": failed,
                "leaving": leaving,
            }
        )

    def _handoff(self, name, destination):
        """One tenant's pinned→fenced→moved migration (the storage
        rebalancer's phases on tenant state): fence (RETRY-AFTER, the stream
        freezes), export the snapshot, push it into the destination, then
        flip (drop locally, leave a moved-tombstone answering
        ``WrongGateway``).  Any push failure unfences and keeps serving —
        the failure mode is a stale placement, never a fork."""
        with self._lock:
            TSAN.write("GatewayServer._tenants", self)
            tenant = self._tenants.get(name)
            if tenant is None:
                return True
            tenant.fenced = time.monotonic()
        snapshot = tenant.state_snapshot()
        try:
            encoded = _encode_snapshot(snapshot)
            self._peer_client(destination).request(
                "handoff_import",
                {"tenant": name, "snapshot": encoded,
                 "epoch": self._fleet.epoch},
            )
        except Exception:
            log.exception(
                "handoff of %r to %s failed; unfencing", name, destination
            )
            with self._lock:
                TSAN.write("GatewayServer._tenants", self)
                if self._tenants.get(name) is tenant:
                    tenant.fenced = None
                self._stats["handoff_failures"] += 1
            TELEMETRY.count("serve.fleet.handoff_failures")
            return False
        with self._lock:
            TSAN.write("GatewayServer._tenants", self)
            self._tenants.pop(name, None)
            self._moved[name] = destination
            while len(self._moved) > APPLIED_IDS_CAP:
                self._moved.popitem(last=False)
            self._stats["handoffs"] += 1
        self._dirty_tenants.discard(name)
        TELEMETRY.count("serve.fleet.handoffs")
        if FLIGHT.enabled:
            FLIGHT.record(
                "serve.handoff", args={"tenant": name, "to": destination}
            )
        log.info("gateway %s handed tenant %r to %s",
                 self.advertise, name, destination)
        return True

    def _handoff_import(self, payload):
        """Destination side of a handoff: rebuild the tenant from the
        pushed snapshot and make it durable HERE before acking — the
        source drops its copy on this ack, so the ack must mean 'I can
        survive my own kill with it'.  An import overwrites any local
        copy: the source's state is the authoritative stream (a racing
        fresh attach here was a client ahead of the migration; its
        observations replay and dedup against the imported ledger)."""
        name = str(payload.get("tenant") or "")
        if not name:
            return error_reply("GatewayError", "handoff_import needs a tenant")
        try:
            snapshot = _decode_snapshot(payload.get("snapshot"))
            tenant = self._tenant_from_snapshot(name, snapshot)
        except Exception as exc:
            log.exception("could not import handed-off tenant %r", name)
            return error_reply(type(exc).__name__, str(exc))
        if self._store is not None:
            self._store.save(name, snapshot)
        with self._lock:
            TSAN.write("GatewayServer._tenants", self)
            self._tenants[name] = tenant
            self._moved.pop(name, None)
            self._stats["imports"] += 1
        TELEMETRY.count("serve.fleet.imports")
        self._publish_fleet_gauges()
        log.info(
            "gateway %s imported tenant %r (n_observed=%d)",
            self.advertise or self.address, name,
            int(tenant.algo.n_observed),
        )
        return ok_reply(
            {"imported": True, "n_observed": int(tenant.algo.n_observed)}
        )

    # --- suggest execution ----------------------------------------------------
    def _run_suggests(self, items):
        """Resolve, group, coalesce, dispatch, demultiplex."""
        jobs = []
        in_cycle = {}  # (tenant, req_id) -> True: originals in THIS cycle
        deferred = []  # re-asks of an in-cycle original: answer from cache
        for item in items:
            payload = item.payload
            tenant, refusal = self._route(item.tenant_name, payload)
            if refusal is not None:
                self._finish(item, refusal)
                continue
            if tenant is None:
                self._finish(
                    item,
                    error_reply(
                        "UnknownTenant",
                        f"no tenant {item.tenant_name!r} attached",
                    ),
                )
                continue
            tenant.last_active = time.monotonic()
            req_id = payload.get("req_id")
            TSAN.read("GatewayServer.tenant_ledgers", tenant)
            cached = tenant.reply_cache.get(req_id) if req_id else None
            if cached is not None:
                # Idempotent re-ask after a lost reply: hand back the SAME
                # suggestions — no second RNG draw, no forked stream.
                with self._lock:
                    TSAN.write("GatewayServer.tenant_counters", self)
                    tenant.suggests += 1
                    self._stats["suggests"] += 1
                self._finish(item, cached)
                continue
            if req_id and in_cycle.get((tenant.name, req_id)):
                # The ORIGINAL of this re-ask is queued in this very cycle
                # (a timed-out-then-retried request): executing both would
                # draw twice.  Answer from the reply cache after the
                # original dispatches.
                deferred.append((item, tenant, req_id))
                continue
            num = int(payload.get("num", 1))
            if num > tenant.max_q:
                self._finish(
                    item,
                    error_reply(
                        "GatewayError",
                        f"suggest num={num} exceeds tenant max_q="
                        f"{tenant.max_q}",
                    ),
                )
                continue
            try:
                exec_algo = self._resolve_exec_algo(tenant, payload)
                plan_fn = getattr(exec_algo, "fused_step_plan", None)
                plan = plan_fn(num) if plan_fn is not None else None
            except Exception as exc:
                log.exception("suggest prep failed for %r", tenant.name)
                self._finish(item, error_reply(type(exc).__name__, str(exc)))
                continue
            if req_id:
                in_cycle[(tenant.name, req_id)] = True
            jobs.append(_SuggestJob(item, tenant, exec_algo, plan, num))
        fused = [job for job in jobs if job.plan is not None]
        plain = [job for job in jobs if job.plan is None]
        groups = OrderedDict()
        for job in fused:
            groups.setdefault(job.plan.signature, []).append(job)
        for group in groups.values():
            for chunk in _fair_chunks(group, self.max_width):
                self._dispatch_chunk(chunk)
        for job in plain:
            self._dispatch_plain(job)
        for item, tenant, req_id in deferred:
            reply = tenant.reply_cache.get(req_id)
            if reply is None:
                # The original errored/opted out and cached nothing: back
                # the re-ask off rather than minting a second draw here.
                reply = self._retry_after_reply(
                    f"original of re-asked suggest {req_id!r} cached no reply"
                )
            else:
                with self._lock:
                    TSAN.write("GatewayServer.tenant_counters", self)
                    tenant.suggests += 1
                    self._stats["suggests"] += 1
            self._finish(item, reply)

    def _resolve_exec_algo(self, tenant, payload):
        """The instance this suggest runs on: the real tenant algorithm, or
        — for a producer's naive round — a server-side clone rebuilt once
        per clone epoch with the round's constant-liar lies observed, so N
        suggests within one producer round share one conditioned copy
        exactly as they do locally."""
        if not payload.get("naive"):
            return tenant.algo
        epoch = int(payload.get("epoch", 0))
        if tenant.naive_algo is None or tenant.naive_epoch != epoch:
            tenant.naive_algo = copy.deepcopy(tenant.algo)
            tenant.naive_epoch = epoch
            for lie in payload.get("lies") or []:
                results = [
                    {"objective": float(v)} for v in lie.get("objectives", [])
                ]
                cube = lie.get("cube")
                cube_rows = (
                    np.asarray(cube, dtype=np.float32)
                    if cube is not None
                    else None
                )
                tenant.naive_algo.observe(
                    lie.get("params") or [], results, cube=cube_rows
                )
        return tenant.naive_algo

    def _dispatch_chunk(self, chunk):
        """One coalesced (or singleton) fused dispatch + demux: each
        tenant's standalone round, exactly what its own _suggest_cube would
        run."""
        width = len(chunk)
        t0 = time.perf_counter() if TELEMETRY.enabled else None
        try:
            results = run_coalesced_plans([job.plan for job in chunk])
        except Exception as exc:
            log.exception("coalesced dispatch of width %d failed", width)
            for job in chunk:
                self._finish(
                    job.item, error_reply(type(exc).__name__, str(exc))
                )
            return
        if t0 is not None:
            # The shared dispatch belongs to EVERY coalesced
            # tenant's trace at once — it records LINKS to each request's
            # context instead of a single parent, and the trace exporter
            # draws one flow arrow per link.
            links = [job.item.ctx for job in chunk if job.item.ctx is not None]
            TELEMETRY.record_span(
                "serve.dispatch",
                start=t0,
                args={"width": width},
                links=links or None,
                track=self._span_track,
            )
        self._book_dispatch(width)
        for job, (rows, state) in zip(chunk, results):
            job.exec_algo.consume_fused_step(state)
            finish = getattr(job.exec_algo, "finish_fused_rows", None)
            if finish is not None:
                # Multi-fidelity algorithms (asha_bo): raw cube rows would
                # bypass fidelity assignment and rung pre-registration —
                # the hook runs the algorithm's own point-assignment path
                # and the reply carries full params, exactly as the plain
                # dispatch would have.
                try:
                    params = finish(rows)
                except Exception as exc:
                    log.exception(
                        "finish_fused_rows failed for %r", job.tenant.name
                    )
                    self._finish(
                        job.item, error_reply(type(exc).__name__, str(exc))
                    )
                    continue
                self._finish_suggest(job, params=params)
            else:
                self._finish_suggest(job, cube=_host_rows(rows))

    def _dispatch_plain(self, job):
        """Non-fused suggest (random-init phase, host-scheduled algorithms,
        plugins): the universal ``suggest_batch`` entry, one tenant per
        dispatch."""
        try:
            batch = job.exec_algo.suggest_batch(job.num)
        except Exception as exc:
            log.exception("suggest failed for %r", job.tenant.name)
            self._finish(job.item, error_reply(type(exc).__name__, str(exc)))
            return
        if batch is None:
            self._finish_suggest(job, optout=True)
            return
        self._book_dispatch(1)
        if batch.cube is not None:
            self._finish_suggest(job, cube=_host_rows(batch.cube)[: job.num])
        else:
            # The wire boundary: replies are JSON, so a lazy ParamBatch
            # materializes its dicts here (list() is a no-op for the
            # host-scheduled algorithms that already produced a list).
            self._finish_suggest(job, params=list(batch.params[: job.num]))

    def _book_dispatch(self, width):
        with self._lock:
            TSAN.write("GatewayServer.tenant_counters", self)
            self._stats["dispatches"] += 1
            if width > 1:
                self._stats["coalesced_dispatches"] += 1
                self._stats["coalesced_suggests"] += width
            self._stats["max_width"] = max(self._stats["max_width"], width)
            key = str(width)
            self._stats["widths"][key] = self._stats["widths"].get(key, 0) + 1
        TELEMETRY.count("serve.dispatches")
        TELEMETRY.observe("serve.coalesce.width", width)

    def _finish_suggest(self, job, cube=None, params=None, optout=False):
        tenant, payload = job.tenant, job.item.payload
        if payload.get("naive"):
            # Mirror Producer._produce: the real streams advance to the
            # naive copy's — the next clone epoch must not replay draws the
            # clone already made.
            _advance_rng(tenant.algo, job.exec_algo)
        result = {"optout": True} if optout else {}
        if cube is not None:
            result["cube"] = np.asarray(cube, dtype=np.float32).tolist()
        if params is not None:
            result["params"] = params
        result["health"] = self._health_fields(job)
        reply = ok_reply(result)
        with self._lock:
            if not optout:
                # Opt-outs are NOT cached: the producer's re-ask after a
                # backoff is a genuinely new question against fresher
                # state.  Cached under the gateway lock: _write_snapshot
                # reads the reply ledger from the shutdown thread.
                tenant.cache_reply(payload.get("req_id"), reply)
            TSAN.write("GatewayServer.tenant_counters", self)
            tenant.suggests += 1
            self._stats["suggests"] += 1
        TELEMETRY.count("serve.suggests")
        if TELEMETRY.enabled:
            TELEMETRY.observe(
                tenant.metric_request,
                time.perf_counter() - job.item.enqueued_at,
            )
        self._mark_dirty(tenant.name)
        self._finish(job.item, reply)

    def _health_fields(self, job):
        """Tenant-algorithm health + the serve layer's own fields — the
        record the client-side adapter surfaces through its producer's
        health channel (``orion-tpu-torch top``/``info``)."""
        try:
            health = dict(job.exec_algo.health_record() or {})
        except Exception:  # pragma: no cover - observability never breaks serve
            health = {}
        TSAN.read("GatewayServer._tenants", self)
        health["serve_width"] = job.width
        health["serve_queue_depth"] = self._queue.qsize()
        health["serve_tenants"] = len(self._tenants)
        # The coalescer's placement over a mesh (only after a mesh-mode
        # dispatch: single-device serving keeps the record as it was).
        if LAST_STACK_PLACEMENT:
            health["serve_mesh_devices"] = LAST_STACK_PLACEMENT.get("devices")
            if "util_min_frac" in LAST_STACK_PLACEMENT:
                health["serve_mesh_util_min_frac"] = LAST_STACK_PLACEMENT["util_min_frac"]
                health["serve_mesh_util_max_frac"] = LAST_STACK_PLACEMENT["util_max_frac"]
        return health

    # --- stats ----------------------------------------------------------------
    def stats_snapshot(self):
        with self._lock:
            TSAN.read("GatewayServer._tenants", self)
            TSAN.read("GatewayServer.tenant_counters", self)
            stats = {
                key: (dict(value) if isinstance(value, dict) else value)
                for key, value in self._stats.items()
            }
            stats["tenants"] = len(self._tenants)
            stats["queue_depth"] = self._queue.qsize()
            stats["per_tenant"] = {
                name: {
                    "suggests": tenant.suggests,
                    "observes": tenant.observes,
                    "inflight": tenant.inflight,
                    "n_observed": int(tenant.algo.n_observed),
                }
                for name, tenant in self._tenants.items()
            }
        if stats["suggests"]:
            stats["dispatches_per_suggest"] = round(
                stats["dispatches"] / stats["suggests"], 4
            )
        else:
            stats["dispatches_per_suggest"] = None
        if self._fleet is not None:
            stats["fleet"] = self.fleet_snapshot()
        return stats


class _SuggestJob:
    __slots__ = ("item", "tenant", "exec_algo", "plan", "num", "width")

    def __init__(self, item, tenant, exec_algo, plan, num):
        self.item = item
        self.tenant = tenant
        self.exec_algo = exec_algo
        self.plan = plan
        self.num = num
        self.width = 1


def _fair_chunks(group, max_width):
    """Fair-share interleave: round-robin across tenants (arrival order
    within each tenant) before slicing into ``max_width`` dispatches, so a
    tenant with a deep backlog cannot push other tenants' single requests
    out of the first (widest) dispatch."""
    per_tenant = OrderedDict()
    for job in group:
        per_tenant.setdefault(job.tenant.name, deque()).append(job)
    ordered = []
    while per_tenant:
        for name in list(per_tenant):
            ordered.append(per_tenant[name].popleft())
            if not per_tenant[name]:
                del per_tenant[name]
    chunks = [
        ordered[i : i + max_width] for i in range(0, len(ordered), max_width)
    ]
    for chunk in chunks:
        for job in chunk:
            job.width = len(chunk)
    return chunks


def serve(  # pragma: no cover - CLI entry
    host="127.0.0.1", port=8777, **knobs
):
    """Blocking gateway entry point (`orion-tpu-torch serve`)."""
    server = GatewayServer(host=host, port=port, **knobs)
    log.info("serving orion-tpu-torch suggest gateway on %s:%s", *server.address)
    print(
        f"orion-tpu-torch suggest gateway listening on "
        f"{server.address[0]}:{server.address[1]} "
        f"(window={server.window * 1e3:g}ms, max_width={server.max_width}, "
        f"device={server.device})",
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
