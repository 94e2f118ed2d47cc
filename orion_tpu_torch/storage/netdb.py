"""Networked document database: TCP server + client (port of
``orion_tpu/storage/netdb.py``; the wire is the reference's byte for byte,
so a client of either package talks to a server of either package).

Capability parity: reference `src/orion/core/io/database/mongodb.py` — the
networked, multi-node storage backend.  The wire protocol is
newline-delimited JSON requests against a server-side document store — a
locked in-memory :class:`~orion_tpu_torch.storage.documents.MemoryDB`, or in
``--persist x.sqlite`` mode a :class:`~orion_tpu_torch.storage.sqlitedb.SQLiteDB`
whose IMMEDIATE transactions serialize writers across per-thread
connections.  Either way ``read_and_write`` (find-one-and-update) is atomic
across every connected worker.

Workers on different hosts coordinate through one server:

    host A$ orion-tpu-torch db serve --port 8765 --persist shared.sqlite
    host B$ ORION_DB_TYPE=network ORION_DB_ADDRESS=hostA:8765 orion-tpu-torch hunt ...

The server optionally persists so it can restart without losing the
experiment: a ``--persist x.sqlite`` path backs it with the durable SQLite
store (every mutation committed, WAL); any other path uses rate-limited
pickle snapshots (atomic tempfile + rename, same pattern as PickledDB).  A
snapshot holds only the store's plain documents (the wire delivers JSON
values, never tensors); it loads through the ``pickled`` backend's
unpickler, so a snapshot ``orion_tpu`` wrote opens here too.

The server is a host process: nothing here touches the GPU.
"""

import functools
import hashlib
import hmac
import json
import logging
import os
import random
import secrets as _secrets
import socket
import socketserver
import threading
import time
from collections import deque

from orion_tpu_torch.analysis.sanitizer import TSAN
from orion_tpu_torch.health import FLIGHT
from orion_tpu_torch.storage.backends import _DBUnpickler, atomic_pickle_dump
from orion_tpu_torch.storage.documents import MemoryDB
from orion_tpu_torch.telemetry import (
    TELEMETRY,
    Telemetry,
    TraceContext,
    current_trace_context,
)
from orion_tpu_torch.tracing import SERVER_EXPERIMENT
from orion_tpu_torch.utils.exceptions import (
    AuthenticationError,
    DatabaseError,
    DuplicateKeyError,
)

log = logging.getLogger(__name__)

_TERM = b"\n"
_MAX_LINE = 64 * 1024 * 1024
#: A client's cap on one REPLY line.  The reference reads replies under the
#: request cap above, so reading back an experiment past 64 MiB (2048
#: q=1024 trials carrying their round's lineage are ~74 MB) fails as a lost
#: connection; the server writes such a line, and the port's client reads it.
_REPLY_MAX_LINE = 1024 * 1024 * 1024

# Ops a client may invoke — anything else is rejected (the wire protocol is
# not a generic RPC surface).
_DB_OPS = frozenset(
    {
        "write",
        "read",
        "read_and_write",
        "count",
        "remove",
        "ensure_index",
        "ensure_indexes",
        "index_information",
        "drop_index",
        "ping",
        "batch",
    }
)

# Sub-ops a batch request may carry: the write-cycle subset — ONE
# whitelist shared with every in-process backend (index management and
# ping stay per-request).
_BATCH_OPS = MemoryDB.BATCH_OPS

# Ops (and batch sub-ops) that dirty the persisted snapshot.
_MUTATING_OPS = frozenset(
    {"write", "read_and_write", "remove", "ensure_index", "ensure_indexes",
     "drop_index"}
)

# Server-level ops outside the document contract: the replication stream a
# primary pushes to its read replicas, the applied-sequence probe the
# pushers (and operators) use to measure replica lag, the promotion op a
# router's election sends to the most-caught-up replica, the
# replica-adoption op auto-reprovisioning sends to a short primary, and the
# consistent-snapshot export behind `db backup`.  All require
# authentication — the replication stream is a full write channel, and
# promotion/adoption/snapshot reshape or export the whole store.
_SERVER_OPS = frozenset({"replicate", "seq", "promote", "adopt_replica", "snapshot"})

# Collections whose writes are SYNC under quorum mode (`storage.quorum`):
# the registration ground truth whose loss the async replication contract
# would otherwise permit on a kill -9 of the primary.  Telemetry, metrics,
# spans and health stay async — they are observability volume, re-emitted
# or tolerably lossy by contract, and gating them on replica acks would put
# the whole heartbeat path behind the slowest replica.
SYNC_COLLECTIONS = frozenset(
    {"experiments", "trials", "lying_trials", "_placement"}
)

# Mutating ops (wire AND batch sub-ops) whose first positional argument
# names the collection — the quorum gate classifies sync vs async through
# it.  Index management carries no collection data worth gating: its
# replay converges identically either way.
_COLLECTION_MUTATORS = frozenset({"write", "read_and_write", "remove"})


def _quorum_sync(op, args):
    """True when ``op(args...)`` mutates a SYNC collection (quorum-gated)."""
    return op in _COLLECTION_MUTATORS and bool(args) and args[0] in SYNC_COLLECTIONS

#: Bounded primary-side replication log (ops, not bytes).  A replica that
#: falls further behind than this gets a full snapshot resync instead of an
#: op replay — the log is a fast path, never the source of truth.
REPL_LOG_CAP = 4096


class _JSONEncoder(json.JSONEncoder):
    """Tolerate numpy scalars/arrays leaking into documents."""

    def default(self, o):
        for attr in ("item",):  # numpy scalar -> python scalar
            if hasattr(o, attr) and not isinstance(o, (list, dict)):
                try:
                    return o.item()
                except Exception:  # pragma: no cover - exotic objects
                    break
        if hasattr(o, "tolist"):
            return o.tolist()
        return super().default(o)


def _dumps(obj):
    return json.dumps(obj, cls=_JSONEncoder).encode() + _TERM


@functools.lru_cache(maxsize=8)
def _derive_key(secret):
    """PBKDF2-stretched key from the shared secret (100k iterations, once
    per process): a captured handshake MAC then costs an offline attacker
    100k hashes per password guess instead of one — the standard defense
    for human-chosen secrets, same idea as MongoDB's SCRAM iteration
    count."""
    return hashlib.pbkdf2_hmac(
        "sha256", secret.encode(), b"orion-tpu-netdb-v1", 100_000
    )


def _mac(key, *parts):
    """HMAC-SHA256 over the concatenated handshake parts — the secret itself
    never crosses the wire, and per-connection nonces kill replay."""
    return hmac.new(key, "|".join(parts).encode(), "sha256").hexdigest()


def _read_line(sock_file, limit=None):
    line = sock_file.readline(_MAX_LINE if limit is None else limit)
    if not line:
        return None
    if not line.endswith(_TERM):
        # Truncated line (the connection died mid-send): treat as closed,
        # never dispatch.  A payload cut ONE byte short of its terminator
        # is still complete JSON, and applying it would break the client's
        # send-phase retry contract — the resend would double-apply.
        return None
    return json.loads(line)


def _encode_outcome(result):
    """One batch-slot outcome as a wire response dict — the same encoding
    ``_dispatch``'s except clauses produce for a standalone request, so the
    client translates both through one path (``_translate``)."""
    if not isinstance(result, Exception):
        return {"ok": True, "result": result}
    if isinstance(result, DuplicateKeyError):
        error = "DuplicateKeyError"
    elif isinstance(result, KeyError):
        error = "KeyError"
    else:
        error = type(result).__name__
    out = {"ok": False, "error": error, "message": str(result)}
    if getattr(result, "maybe_applied", False):
        # The applied-or-not-unknowable marker must survive the wire, or
        # the client-side retry policy would blind-resend non-converging
        # mutations a failing server may already have applied.
        out["maybe_applied"] = True
    return out


class ServerHandshake:
    """Server side of the two-step mutual handshake, CLIENT proves first:
    hello -> nonces, auth -> client proof, verified before the server's own
    proof is released.  Handing out a server MAC pre-verification would give
    any port-scanner a free chosen-nonce sample to brute-force offline.

    Extracted so BOTH wire surfaces authenticate identically — the netdb
    handler below and the suggest gateway (``serve/gateway.py``) each hold
    one per connection; ``hangup`` tells the owner to drop the connection
    after a failed credential check (a fresh nonce per guess, so brute
    force pays a TCP handshake each)."""

    AUTH_OPS = frozenset({"auth_hello", "auth"})

    def __init__(self, auth_key):
        self.auth_key = auth_key
        # No server secret -> open server (localhost dev, --no-auth).
        self.authenticated = auth_key is None
        self.hangup = False
        self._nonce = None
        self._client_nonce = ""

    def step(self, request):
        op = request["op"]
        key = self.auth_key
        if op == "auth_hello":
            if key is None:
                return {"ok": True, "result": {"nonce": None}}
            self._client_nonce = str(request.get("nonce", ""))
            self._nonce = _secrets.token_hex(32)
            return {"ok": True, "result": {"nonce": self._nonce}}
        # op == "auth"
        nonce, self._nonce = self._nonce, None  # one-shot
        client_nonce = self._client_nonce
        expected = (
            None
            if (key is None or nonce is None)
            else _mac(key, "client", client_nonce, nonce)
        )
        if expected is not None and hmac.compare_digest(
            str(request.get("mac", "")), expected
        ):
            self.authenticated = True
            return {
                "ok": True,
                "result": {
                    "status": "authenticated",
                    # Mutual: released only to a proven client, so an
                    # impostor server (or mismatched secret files) is
                    # detected client-side before any data flows.
                    "server_mac": _mac(key, "server", client_nonce, nonce),
                },
            }
        self.hangup = True
        return {
            "ok": False,
            "error": "AuthenticationError",
            "message": "bad credentials (wrong or missing shared secret)",
        }


def perform_client_handshake(exchange, secret, peer):
    """Client side of the mutual handshake on a FRESH connection.

    ``exchange`` is a callable taking one encoded request line and
    returning the decoded response dict; ``peer`` labels error messages
    (``host:port``).  Shared by :class:`NetworkDB` and the gateway client
    (``serve/client.py``) so the downgrade/impostor refusals cannot drift
    between the two wire surfaces.  Raises :class:`AuthenticationError`;
    the caller closes its connection."""
    key = _derive_key(secret)
    client_nonce = _secrets.token_hex(16)
    hello = exchange(_dumps({"op": "auth_hello", "nonce": client_nonce}))
    result = hello.get("result") or {}
    nonce = result.get("nonce")
    if nonce is None:
        # This client was configured with a secret; silently proceeding
        # against a server that refuses to authenticate would hand every
        # read AND write to whoever answered on this address (DNS/IP
        # hijack, typoed port).  No downgrade.
        raise AuthenticationError(
            f"server {peer} does not require authentication, but this "
            "client is configured with a secret — refusing to proceed "
            "(remove the secret only if you trust the network path)"
        )
    reply = exchange(
        _dumps({"op": "auth", "mac": _mac(key, "client", client_nonce, nonce)})
    )
    if not reply.get("ok"):
        raise AuthenticationError(reply.get("message", "authentication failed"))
    server_mac = str((reply.get("result") or {}).get("server_mac", ""))
    if not hmac.compare_digest(server_mac, _mac(key, "server", client_nonce, nonce)):
        raise AuthenticationError(
            f"server {peer} failed to prove knowledge of the shared secret "
            "(impostor server, or mismatched secret files)"
        )


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        db = self.server.db
        self._auth = ServerHandshake(self.server.auth_key)
        while True:
            try:
                request = _read_line(self.rfile)
            except (json.JSONDecodeError, OSError) as exc:
                log.warning("bad request from %s: %s", self.client_address, exc)
                return
            if request is None:
                return
            self.wfile.write(_dumps(self._dispatch(db, request)))
            if self._auth.hangup:
                return

    def _dispatch(self, db, request):
        op = request.get("op")
        if op in ServerHandshake.AUTH_OPS:
            return self._auth.step(request)
        if op not in _DB_OPS and op not in _SERVER_OPS:
            return {"ok": False, "error": "DatabaseError", "message": f"bad op {op!r}"}
        if op == "ping":
            # Health checks stay open: ping reveals nothing and monitoring
            # should not need the experiment secret.
            return {"ok": True, "result": "pong"}
        if not self._auth.authenticated:
            return {
                "ok": False,
                "error": "AuthenticationError",
                "message": "authentication required (server started with a secret)",
            }
        if op == "seq":
            return {"ok": True, "result": self.server.seq_info()}
        if op == "snapshot":
            return {"ok": True, "result": self.server.snapshot_payload()}
        if op in ("replicate", "promote", "adopt_replica"):
            try:
                args = request.get("args") or []
                payload = args[0] if args else None
                handler = {
                    "replicate": self.server.handle_replicate,
                    "promote": self.server.handle_promote,
                    "adopt_replica": self.server.handle_adopt_replica,
                }[op]
                return {"ok": True, "result": handler(payload)}
            except Exception as exc:  # pragma: no cover - defensive
                log.exception("%s failed", op)
                return _encode_outcome(exc)
        if op == "batch":
            return self._batch_dispatch(db, request)
        if op in _MUTATING_OPS and self.server.refuses_mutations():
            # Epoch fencing, server side: a replica (including a demoted
            # stale primary) must never apply a client mutation — accepting
            # one would fork it from the authoritative primary's timeline
            # and the divergence would be silently erased by the next
            # resync.  Refused BEFORE any apply, so nothing was applied and
            # the router's retry can safely re-route to the real primary.
            return self.server.not_primary_reply()
        # Distributed tracing: a request may carry an optional `ctx` field
        # (the client's ambient TraceContext) — adopted as the parent of
        # this server's apply span.  Pre-upgrade clients simply omit it;
        # pre-upgrade servers ignored unknown top-level keys, so the field
        # is wire-compatible in both directions.
        t0, ctx = self.server.adopt_begin(request)
        try:
            method = getattr(db, op)
            args = request.get("args", [])
            kwargs = request.get("kwargs", {})
            if op in _MUTATING_OPS:
                result, seq = self.server.apply_replicated(op, args, kwargs, method)
                self.server.persist_snapshot()
                if _quorum_sync(op, args) and not self.server.await_quorum(seq):
                    return self.server.quorum_timeout_reply(op, seq)
                out = {"ok": True, "result": result}
            else:
                # A read replica stamps its applied replication sequence on
                # read replies so clients can tell a fresh answer from a
                # lagging one (the sharded router's staleness contract).
                # Stamped BEFORE the read executes: the stamp must be a
                # LOWER bound on the state the read observed — sampling
                # after could stamp a pre-apply read with a post-apply
                # sequence and launder a stale answer as fresh.  Plain
                # servers stamp nothing — zero wire change.
                seq = self.server.read_stamp()
                result = method(*args, **kwargs)
                out = {"ok": True, "result": result}
            if seq is not None:
                out["seq"] = seq
                # The epoch rides next to the seq so routers can fence a
                # stale primary's replies (shard.py's promotion protocol);
                # epoch 0 = replication never configured, nothing stamped.
                epoch = self.server.epoch
                if epoch:
                    out["epoch"] = epoch
            return out
        except Exception as exc:
            if not isinstance(exc, (DuplicateKeyError, KeyError)):
                log.exception("op %s failed", op)  # pragma: no cover - defensive
            return _encode_outcome(exc)
        finally:
            self.server.adopt_finish(op, t0, ctx)

    def _batch_dispatch(self, db, request):
        """ONE request carrying N sub-operations: applied as one atomic
        unit against the store (one lock hold on MemoryDB, one transaction
        on a SQLite-persisted server) and answered with ONE response line
        holding per-slot outcomes.  Next to ``pipeline`` (N request lines
        in one send) this drops the server's per-op dispatch/persist cycle
        and, in SQLite persist mode, q fsyncs down to one."""
        try:
            args = request.get("args") or [[]]
            ops = args[0] if args else []
            normalized = []
            for entry in ops:
                op = (
                    entry[0]
                    if isinstance(entry, (list, tuple)) and entry
                    else None
                )
                if op not in _BATCH_OPS:
                    return {
                        "ok": False,
                        "error": "DatabaseError",
                        "message": f"bad batch sub-op {op!r}",
                    }
                sub_args = list(entry[1]) if len(entry) > 1 and entry[1] else []
                sub_kwargs = dict(entry[2]) if len(entry) > 2 and entry[2] else {}
                normalized.append((op, sub_args, sub_kwargs))
        except (TypeError, ValueError, KeyError) as exc:
            # A malformed payload must get a structured refusal, never kill
            # the handler without a response line — the client would read
            # that as applied-or-not-unknowable when nothing was applied.
            return {
                "ok": False,
                "error": "DatabaseError",
                "message": f"malformed batch request: {exc}",
            }
        mutating = any(op in _MUTATING_OPS for op, _, _ in normalized)
        if mutating and self.server.refuses_mutations():
            # Same epoch fence as the single-op path: nothing applied.
            return self.server.not_primary_reply()
        t0, ctx = self.server.adopt_begin(request)
        try:
            # All-read batch (the producer's fetch_update_view pair): the
            # replica stamp is taken BEFORE the batch runs — a lower bound
            # on the observed state, same rationale as the single-op path.
            pre_stamp = None if mutating else self.server.read_stamp()
            results, seq = self.server.apply_batch_replicated(db, normalized)
            if mutating:
                self.server.persist_snapshot()
                if any(
                    _quorum_sync(op, sub_args)
                    for op, sub_args, _ in normalized
                ) and not self.server.await_quorum(seq):
                    return self.server.quorum_timeout_reply("batch", seq)
            else:
                seq = pre_stamp
            out = {"ok": True, "result": [_encode_outcome(r) for r in results]}
            if seq is not None:
                out["seq"] = seq
                epoch = self.server.epoch
                if epoch:
                    out["epoch"] = epoch
            return out
        except Exception as exc:
            # Whole-batch failure (e.g. a fault-injected mid-batch kill):
            # encode through the one shared path so markers like
            # maybe_applied survive the wire.
            log.exception("batch of %d ops failed", len(normalized))
            return _encode_outcome(exc)
        finally:
            # In a finally like the single-op path: a FAILED batch is the
            # one whose server-side span the post-mortem needs most.
            self.server.adopt_finish("batch", t0, ctx)


def _parse_addr(addr):
    """``"host:port"`` / ``(host, port)`` -> (host, int(port))."""
    if isinstance(addr, str):
        host, _, port = addr.rpartition(":")
        if not host or not port:
            raise DatabaseError(f"bad replica address {addr!r}; expected host:port")
        return host, int(port)
    host, port = addr
    return host, int(port)


class _ReplicaLink:
    """Asynchronous primary -> replica pusher: one background thread per
    replica streams the primary's ORDERED mutation log over the ordinary
    wire (``replicate`` requests carrying ``[(seq, op, args, kwargs), ...]``
    chunks); a replica that restarted empty, answered with a sequence gap,
    or fell behind the bounded log gets a full snapshot resync.  Pushes
    retry forever with backoff — a dead replica must never stall the
    primary (writes are acknowledged before replication: the replica tier
    is a read-scaling plane, not a quorum)."""

    #: Operations per push: a ``batch`` entry counts its sub-operations, so
    #: one push carries at most this many operations, or one entry when a
    #: single batch holds more.  The reference cuts pushes at 256 ENTRIES:
    #: two q=1024 rounds of documents carrying their lineage (~37 MB each)
    #: then ride one line past the server's 64 MiB line cap, the replica
    #: drops it as truncated, and replication stalls for good.
    PUSH_BATCH = 256

    #: Upper bound of the jittered pre-resync sleep: spreads the (gated,
    #: serialized) snapshot dumps of a replica restart storm so the
    #: primary's lock sees breathing room between them.
    RESYNC_JITTER_S = 0.05

    def __init__(self, server, addr, secret=None):
        self.server = server
        self.host, self.port = _parse_addr(addr)
        self.client = NetworkDB(
            host=self.host, port=self.port, timeout=10.0, secret=secret
        )
        self.acked_seq = None  # unknown until the first probe
        #: Set when the replica's last reply demanded a resync (an epoch
        #: change or a fork repair): the next cycle must ship a snapshot
        #: even if the bounded log happens to cover the replica's position
        #: — entry replay across a fork corrupts silently.
        self.force_resync = False
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"netdb-repl-{self.host}:{self.port}",
            daemon=True,
        )

    def start(self):
        self._thread.start()

    def notify(self):
        self._wake.set()

    def stop(self, flush=True):
        """Stop pushing; ``flush`` attempts one final best-effort push so a
        clean primary shutdown leaves reachable replicas fully caught up."""
        if flush and not self._stopped.is_set():
            try:
                self._push_pending()
            except Exception:  # replica down at shutdown: nothing owed
                log.debug("final replica flush failed", exc_info=True)
        self._stopped.set()
        self._wake.set()
        self.client.close()

    #: Consecutive push failures before the pusher escalates to WARNING:
    #: a replica riding out a restart fails a handful of times (debug
    #: noise); a PERMANENT failure — wrong secret, wrong address — would
    #: otherwise leave the replica tier silently empty forever.
    WARN_AFTER_FAILURES = 10

    def _run(self):
        backoff = 0.05
        failures = 0
        while not self._stopped.is_set():
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            if self._stopped.is_set():
                return
            try:
                self._push_pending()
                backoff = 0.05
                failures = 0
            except Exception as exc:
                # Usually a down/partitioned replica (transient); jittered
                # backoff so a fleet of pushers doesn't hammer a
                # restarting replica in lockstep.  A persistent streak is
                # escalated: auth/config mistakes are NOT transient and
                # must reach the operator, not the debug log.
                failures += 1
                TELEMETRY.count("netdb.replication.push_failures")
                if failures % self.WARN_AFTER_FAILURES == 0:
                    log.warning(
                        "replica %s:%s has refused %d consecutive pushes "
                        "(latest: %s: %s) — replication to it is STALLED",
                        self.host, self.port, failures,
                        type(exc).__name__, exc,
                    )
                else:
                    log.debug(
                        "replica %s:%s push failed", self.host, self.port,
                        exc_info=True,
                    )
                self.acked_seq = None  # re-probe after the outage
                self._stopped.wait(backoff * (0.5 + random.random()))
                backoff = min(backoff * 2, 2.0)

    @classmethod
    def _chunk(cls, entries):
        """The leading entries of one push: at most :attr:`PUSH_BATCH`
        operations, and always at least one entry."""
        ops = 0
        for count, entry in enumerate(entries):
            ops += len(entry[2][0]) if entry[1] == "batch" else 1
            if ops > cls.PUSH_BATCH and count:
                return entries[:count]
        return entries

    def _push_pending(self):
        """Drain everything the replica has not acknowledged yet."""
        while not self._stopped.is_set():
            if self.acked_seq is None:
                info = self.client._call("seq") or {}
                peer_epoch = int(info.get("epoch", 0) or 0)
                if peer_epoch > self.server.epoch:
                    # The peer lives in a NEWER epoch: this server is a
                    # stale reborn primary — demote instead of pushing a
                    # forked history (split-brain guard, docs/multi_node.md).
                    self.server.demote(peer_epoch)
                    return
                self.acked_seq = int(info.get("seq", 0))
                self.server.ack_notify()
            with self.server._repl_lock:
                entries = [
                    list(e) for e in self.server._repl_log
                    if e[0] > self.acked_seq
                ]
                epoch = self.server.epoch
                behind = self.server.seq > self.acked_seq
                covered = bool(entries) and entries[0][0] == self.acked_seq + 1
            if (behind and not covered) or self.force_resync:
                # The gap fell off the bounded log (or the replica
                # restarted empty / demanded an epoch resync): full resync.
                # Resyncs are BOUNDED to one replica at a time per primary
                # (jittered): each snapshot is an O(DB-size) dump under the
                # replication lock, and a restart storm of R replicas
                # re-probing at once would otherwise stampede the primary
                # with R back-to-back dumps, starving client mutations of
                # ``_repl_lock`` for R full copies.
                if not self.server._resync_gate.acquire(timeout=2.0):
                    continue  # re-check _stopped, then wait our turn again
                try:
                    if self._stopped.is_set():
                        return
                    self._stopped.wait(random.random() * self.RESYNC_JITTER_S)
                    with self.server._repl_lock:
                        # Re-read from a consistent point — the log may
                        # have grown while we waited for the gate.
                        snapshot = self.server._snapshot_payload_locked()
                    result = self.client._call(
                        "replicate", {"snapshot": snapshot, "epoch": epoch}
                    )
                    TELEMETRY.count("netdb.replication.resyncs")
                finally:
                    self.server._resync_gate.release()
                result = result or {}
                if result.get("fenced"):
                    # Promoted between our probe and this push: same
                    # demotion as a fenced entry push.
                    self.server.demote(int(result.get("epoch", 0) or 0))
                    return
                self.force_resync = False
                self.acked_seq = int(result.get("seq", 0))
                self.server.ack_notify()
                continue
            if not entries:
                return
            chunk = self._chunk(entries)
            result = self.client._call(
                "replicate", {"entries": chunk, "epoch": epoch}
            ) or {}
            TELEMETRY.count("netdb.replication.pushes")
            if result.get("fenced"):
                # The replica refused this epoch: a newer primary owns the
                # stream now.  Demote; never push a stale fork.
                self.server.demote(int(result.get("epoch", 0) or 0))
                return
            self.acked_seq = int(result.get("seq", 0))
            self.server.ack_notify()
            if result.get("resync"):
                # The replica saw a sequence gap (or an epoch change /
                # fork) mid-chunk; ship a snapshot next cycle — the log
                # may well still "cover" the reported position, but the
                # replica has declared entry replay unsafe.
                self.force_resync = True
                continue


class DBServer(socketserver.ThreadingTCPServer):
    """Serve a document DB over TCP; one request = one atomic DB operation
    (MemoryDB per-op lock, or SQLiteDB transactions in x.sqlite persist
    mode).

    **Replication** (the sharded control plane's read tier,
    docs/multi_node.md): a primary started with ``replicate_to=[addr,...]``
    assigns every applied mutation a monotonically increasing sequence
    number under one lock (log order IS apply order), stamps that ``seq``
    on the mutating reply, and streams the log to each replica from a
    background :class:`_ReplicaLink`.  A replica (any server that receives
    ``replicate`` ops, or one started with ``replica=True``) replays the
    stream in order and stamps its APPLIED seq on read replies — which is
    what lets :class:`~orion_tpu_torch.storage.shard.ShardedNetworkDB` detect a
    lagging replica and fail a read over to the primary.  Replication is
    asynchronous by default: writes are acknowledged before they reach any
    replica.  **Quorum mode** (``quorum=N``, `storage.quorum`) tightens the
    contract for the registration collections (:data:`SYNC_COLLECTIONS`):
    a mutating reply waits until at least N replica links have acknowledged
    the write's sequence — the log is ordered, so a replica acking seq S
    holds every write ≤ S, which is exactly why a max-seq election winner
    carries every quorum-acked write and a kill -9 loses nothing sync by
    construction.  An ack that never comes within ``quorum_timeout`` fails
    the reply with ``maybe_applied`` (the write DID apply locally; the
    retry layer's MODE_UNAPPLIED ops give up, MODE_ALWAYS ops converge
    through their duplicate-key/absolute-id discipline)."""

    allow_reuse_address = True
    daemon_threads = True

    #: Seconds between flushes of the server's OWN adopted-ctx spans into
    #: its spans collection (under the reserved ``__server__`` experiment
    #: id) — what `orion-tpu-torch trace --distributed` joins back by trace_id.
    SPAN_FLUSH_INTERVAL = 1.0
    #: Retention cap for the __server__ span channel (same unbounded-growth
    #: guard as DocumentStorage.SPANS_CAP; pruned with hysteresis to 90%).
    SERVER_SPANS_CAP = 20000

    def __init__(
        self,
        host="127.0.0.1",
        port=0,
        persist=None,
        persist_interval=1.0,
        secret=None,
        replicate_to=None,
        replica=False,
        quorum=0,
        quorum_timeout=2.0,
    ):
        self.persist = persist
        self.persist_interval = persist_interval
        #: Per-write replication-ack floor for SYNC_COLLECTIONS mutations
        #: (0 = classic async replication).  Configured on every server of
        #: a shard — replicas carry it dormant so a promoted one enforces
        #: the same contract its predecessor did.
        self.quorum = int(quorum or 0)
        self.quorum_timeout = float(quorum_timeout)
        # Server-side span recording rides a PRIVATE registry, not the
        # process-global one: an in-process loopback server sharing the
        # global ring would have its spans drained (exactly-once) by
        # whichever worker flush ran next, splitting them unpredictably
        # between the experiment channel and the __server__ channel.
        # Mutations are gated on the GLOBAL TELEMETRY.enabled switch.
        self._span_tel = Telemetry(enabled=True, span_capacity=2048)
        self._span_flush_lock = threading.Lock()
        self._last_span_flush = 0.0
        self._span_track = f"netdb:{socket.gethostname()}:{os.getpid()}"
        # Shared-secret authentication (reference parity: the networked
        # backend takes username/password credentials,
        # `mongodb.py:86,289`).  None = open server for localhost dev.
        self.secret = secret
        self.auth_key = _derive_key(secret) if secret is not None else None
        self._persist_lock = threading.Lock()
        self._dirty = threading.Event()
        self._stop_flusher = threading.Event()
        self._flusher = None
        # A .sqlite/.db persist path backs the server with the SQLite store:
        # durable per-mutation by design (WAL), so no snapshot machinery —
        # handler threads each get their own connection (thread-local).
        # Header-sniffed so a legacy pickle snapshot named *.db keeps
        # loading as a snapshot.
        from orion_tpu_torch.storage.sqlitedb import SQLiteDB, sqlite_path_selected

        self._snapshotting = bool(persist) and not sqlite_path_selected(persist)
        if persist and not self._snapshotting:
            self.db = SQLiteDB(persist)
        else:
            self.db = MemoryDB()
            if persist and os.path.exists(persist):
                with open(persist, "rb") as handle:
                    self.db = _DBUnpickler(handle).load()
        # Live client sockets, tracked so shutdown can force-drop them: an
        # in-process "restart" must look like a killed process to clients
        # and replication pushers — otherwise a handler thread keeps
        # serving the DISCARDED store over the old connection (a zombie the
        # soak harness's shard-restart scenarios would silently talk to).
        self._conn_lock = threading.Lock()
        self._open_conns = set()
        # --- replication state (primary AND replica roles) -------------------
        # RLock: handle_replicate applies ops through the same locked window
        # apply_replicated uses, and a snapshot resync applies indexes via
        # the same db surface.
        self._repl_lock = threading.RLock()
        #: Pusher threads notify here whenever a replica's acked position
        #: advances; the quorum gate waits on it.  Sharing _repl_lock means
        #: the ack predicate is always read consistently with the link set.
        self._ack_cond = threading.Condition(self._repl_lock)
        self._is_replica = bool(replica)
        self._repl_log = deque(maxlen=REPL_LOG_CAP)
        self._repl_links = []
        #: Serializes full snapshot resyncs across this primary's pusher
        #: threads (see _ReplicaLink._push_pending).
        self._resync_gate = threading.BoundedSemaphore(1)
        #: Set when this server's history may have FORKED from the
        #: authoritative stream (a demoted stale primary, or a replica that
        #: observed an epoch change): seq probes report 0 until a full
        #: snapshot overwrites the fork — entry replay on top of diverged
        #: state would corrupt silently.
        self._resync_pending = False
        #: True for any server that ever served as a primary (constructed
        #: replicating, or promoted): its local history may contain writes
        #: no other node has, so an epoch change can never be absorbed by
        #: entry replay — only by a snapshot.
        self._was_primary = bool(replicate_to)
        # The applied/assigned sequence AND the replication epoch survive
        # restarts THROUGH the store itself (a meta doc): a restarted
        # primary must keep numbering where it left off or replicas would
        # silently discard its new mutations as already-seen; a restarted
        # STALE primary must come back knowing which epoch it last served
        # so a single contact with a newer-epoch peer demotes it.
        self.seq, self.epoch = self._load_replmeta()
        if replicate_to and self.epoch == 0:
            # A replicating primary always serves a concrete epoch (>= 1):
            # epoch 0 means "replication never configured" and is never
            # stamped on the wire.
            with self._repl_lock:
                self.epoch = 1
                self._persist_seq_locked()
        super().__init__((host, port), _Handler)
        for addr in replicate_to or ():
            link = _ReplicaLink(self, addr, secret=secret)
            self._repl_links.append(link)
            link.start()
        if self._snapshotting:
            self._flusher = threading.Thread(target=self._flush_loop, daemon=True)
            self._flusher.start()

    @property
    def address(self):
        return self.server_address[:2]

    # --- connection tracking -------------------------------------------------
    def process_request(self, request, client_address):
        with self._conn_lock:
            self._open_conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conn_lock:
            self._open_conns.discard(request)
        super().shutdown_request(request)

    def close_connections(self):
        """Force-drop every live client connection (see ``_open_conns``)."""
        with self._conn_lock:
            doomed = list(self._open_conns)
        for sock in doomed:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    # --- replication ---------------------------------------------------------
    @property
    def _replicating(self):
        """True when this server participates in the replication protocol:
        it pushes to live links, OR it carries a concrete epoch (a
        promoted primary whose peers are all currently dead must still
        number and epoch-stamp its mutations — its log is what a reborn
        peer replays, and the stamp is the routers' fencing signal)."""
        return bool(self._repl_links) or self.epoch > 0

    def apply_replicated(self, op, args, kwargs, method):
        """Apply one mutating op; when this server replicates, the apply and
        its log append happen under ONE lock so the log order IS the apply
        order (replicas replay the log and must converge on identical
        state).  Only a SUCCESSFUL apply is logged — a refused op
        (DuplicateKeyError) changed nothing and replaying it would at best
        waste a wire trip.  Returns ``(result, seq_or_None)``."""
        if not self._replicating:
            return method(*args, **kwargs), None
        with self._repl_lock:
            result = method(*args, **kwargs)
            seq = self._log_entry_locked(op, list(args), dict(kwargs or {}))
        self._notify_links()
        return result, seq

    @staticmethod
    def _run_batch(db, normalized):
        """Apply one normalized batch against ``db`` with per-slot
        outcomes — shared by the primary's logged path and the replica's
        stream replay (which manages seq itself)."""
        apply_batch = getattr(db, "apply_batch", None)
        if apply_batch is not None:
            return apply_batch(normalized)
        results = []  # pragma: no cover - every in-tree store has apply_batch
        for op, sub_args, sub_kwargs in normalized:
            try:
                results.append(getattr(db, op)(*sub_args, **sub_kwargs))
            except Exception as exc:
                results.append(exc)
        return results

    def apply_batch_replicated(self, db, normalized):
        """The batch-op sibling of :meth:`apply_replicated`: the whole batch
        is ONE log entry (per-slot outcomes are deterministic replays of the
        same op stream, so a slot the primary refused is refused identically
        on the replica).  All-read batches are never logged."""
        mutating = any(op in _MUTATING_OPS for op, _, _ in normalized)
        if not self._replicating or not mutating:
            return self._run_batch(db, normalized), None
        with self._repl_lock:
            results = self._run_batch(db, normalized)
            seq = self._log_entry_locked(
                "batch",
                [[[op, list(a), dict(k)] for op, a, k in normalized]],
                {},
            )
        self._notify_links()
        return results, seq

    def handle_replicate(self, payload):
        """Apply a pusher's ``replicate`` request: an ordered entry chunk
        (seqs at or below the applied position are dropped — resends
        converge), or a full ``snapshot``.  A mid-chunk sequence GAP stops
        the replay and reports ``resync`` so the pusher falls back to a
        snapshot instead of applying out of order.

        **Epoch discipline** (the promotion protocol's replication half):
        a push from a LOWER epoch is fenced — refused outright with the
        current epoch in the reply, so a stale reborn primary demotes
        itself instead of overwriting the promoted timeline.  A push from
        a HIGHER epoch demotes this server if it ever was a primary (its
        unreplicated tail is a condemned fork) and, for any server with
        state, demands a full snapshot instead of entry replay — entries
        replayed across an epoch boundary could land on top of a fork and
        corrupt silently.  Epoch-less pushes (pre-upgrade primaries) are
        treated as same-epoch."""
        payload = payload or {}
        has_epoch = "epoch" in payload
        push_epoch = int(payload.get("epoch", 0) or 0)
        doomed_links = []
        demoted = False
        own_epoch = 0
        with self._repl_lock:
            if has_epoch and self.epoch and push_epoch < self.epoch:
                return {
                    "seq": self.seq,
                    "resync": False,
                    "fenced": True,
                    "epoch": self.epoch,
                }
            epoch_advanced = has_epoch and push_epoch > self.epoch
            if epoch_advanced and (self._was_primary or self._repl_links):
                # A primary (current or former) hearing a newer epoch:
                # demote NOW — every local write since the election is a
                # fork no other node acknowledges.
                doomed_links, self._repl_links = self._repl_links, []
                self._resync_pending = True
                demoted = True
                own_epoch = self.epoch
            self._is_replica = True
            snapshot = payload.get("snapshot")
            if snapshot is not None:
                self._apply_snapshot_locked(snapshot)
                self._resync_pending = False
                applied, resync = self.seq, False
            elif self._resync_pending or (epoch_advanced and self.seq > 0):
                # A fork is pending repair (or this replica's tail may
                # extend past the new primary's fork point): only a
                # snapshot is safe.  Report position 0 so the pusher's
                # gap logic takes the resync path.
                self._resync_pending = True
                applied, resync = 0, True
            else:
                if epoch_advanced:
                    # Fresh follower (no state): adopt the stream's epoch.
                    self.epoch = push_epoch  # under _repl_lock
                applied, resync = self.seq, False
                for entry in payload.get("entries") or []:
                    seq = int(entry[0])
                    op = entry[1]
                    args = entry[2] or []
                    kwargs = entry[3] if len(entry) > 3 and entry[3] else {}
                    if seq <= applied:
                        continue  # resend of an already-applied entry
                    if seq != applied + 1:
                        resync = True
                        break
                    try:
                        if op == "batch":
                            normalized = [
                                (e[0], list(e[1]), dict(e[2])) for e in args[0]
                            ]
                            # Direct apply: the stream replay manages seq
                            # itself — the logged path would double-number.
                            self._run_batch(self._meta_db, normalized)
                        else:
                            getattr(self._meta_db, op)(*args, **kwargs)
                    except (DuplicateKeyError, KeyError):
                        # The primary logged this op as a SUCCESS; a
                        # semantic refusal here means the replica diverged
                        # (e.g. it took direct writes).  Keep going — the
                        # stream stays ordered — but say so loudly.
                        log.warning(
                            "replicated op %r refused at seq %d — replica "
                            "state diverged from its primary", op, seq,
                        )
                    applied = seq
                self.seq = applied
                self._persist_seq_locked()
        for link in doomed_links:
            link.stop(flush=False)
        if demoted:
            self._note_demotion(push_epoch, own_epoch)
        self.persist_snapshot()
        return {"seq": applied, "resync": resync, "epoch": self.epoch}

    def handle_promote(self, payload):
        """The ``promote`` wire op: flip replica -> primary at a NEW epoch.

        Sent by a router's election (``storage/shard.py``) to the
        most-caught-up replica of a shard whose primary died.  Idempotent
        and concurrent-router safe: a promotion at or below the current
        epoch changes nothing and reports the standing state, so every
        router converges on the same winner; a mid-resync server refuses
        (its state is a fork in repair, not electable)."""
        payload = payload or {}
        new_epoch = int(payload.get("epoch", 0) or 0)
        peers = payload.get("replicate_to") or []
        with self._repl_lock:
            if self._resync_pending:
                return {
                    "promoted": False, "primary": False,
                    "epoch": self.epoch, "seq": 0,
                }
            if new_epoch <= self.epoch:
                return {
                    "promoted": False,
                    "primary": not self._is_replica,
                    "epoch": self.epoch,
                    "seq": self.seq,
                }
            self.epoch = new_epoch  # under _repl_lock
            self._is_replica = False
            self._was_primary = True
            self._persist_seq_locked()
            seq = self.seq
            known = {(link.host, link.port) for link in self._repl_links}
        self_addr = tuple(self.address)
        for addr in peers:
            parsed = _parse_addr(addr)
            if parsed in known or parsed == self_addr:
                continue
            known.add(parsed)
            link = _ReplicaLink(self, parsed, secret=self.secret)
            with self._repl_lock:
                self._repl_links.append(link)
            link.start()
        TELEMETRY.count("netdb.promotions")
        if FLIGHT.enabled:
            FLIGHT.record(
                "promote",
                args={"epoch": new_epoch, "seq": seq, "peers": len(peers)},
            )
        log.warning(
            "PROMOTED to primary at epoch %d (seq %d), replicating to %d "
            "peer(s)", new_epoch, seq, len(peers),
        )
        self.persist_snapshot()
        return {"promoted": True, "primary": True, "epoch": new_epoch, "seq": seq}

    def handle_adopt_replica(self, payload):
        """The ``adopt_replica`` wire op: start pushing this primary's
        stream to a freshly provisioned replica (auto-reprovisioning,
        ``storage/shard.py``).  Idempotent: an address already linked (or
        this server's own) reports ``existing`` instead of double-pushing.
        A replica refuses — adoption reshapes the replication fan-out and
        only the shard's current primary owns that."""
        payload = payload or {}
        addr = payload.get("address")
        if not addr:
            raise DatabaseError("adopt_replica needs an 'address'")
        parsed = _parse_addr(addr)
        with self._repl_lock:
            if self._is_replica:
                return {
                    "adopted": False,
                    "primary": False,
                    "epoch": self.epoch,
                }
            known = {(link.host, link.port) for link in self._repl_links}
            if parsed in known or parsed == tuple(self.address):
                return {"adopted": True, "existing": True, "epoch": self.epoch}
            if self.epoch == 0:
                # Adopting a replica makes this server a replicating
                # primary; it must stamp a concrete epoch from here on
                # (same floor a replicate_to construction applies).
                self.epoch = 1  # under _repl_lock
                self._persist_seq_locked()
            self._was_primary = True
            link = _ReplicaLink(self, parsed, secret=self.secret)
            self._repl_links.append(link)
            epoch = self.epoch
        # Outside the lock: the empty (or stale) replica snapshot-resyncs
        # through the pusher's ordinary gap logic — bounded by _resync_gate
        # like any replica restart.
        link.start()
        link.notify()
        TELEMETRY.count("netdb.adoptions")
        log.warning(
            "ADOPTED replica %s:%s at epoch %d (reprovision)", *parsed, epoch
        )
        return {"adopted": True, "existing": False, "epoch": epoch}

    # --- quorum gate (storage.quorum) ----------------------------------------
    def ack_notify(self):
        """A pusher advanced a replica's acked position: wake quorum waits."""
        with self._ack_cond:
            self._ack_cond.notify_all()

    def await_quorum(self, seq, timeout=None):
        """Block until at least ``quorum`` replica links acknowledge
        ``seq`` (or every link has, when fewer links than the floor
        exist — a shard mid-reprovision must not refuse all writes for
        asking more acks than replicas).  True on success, False on
        timeout.  Vacuously true with quorum off, no seq, or no links.
        Books the wait as the ``storage.quorum.wait`` histogram."""
        if self.quorum <= 0 or seq is None:
            return True
        timeout = self.quorum_timeout if timeout is None else timeout
        t0 = time.perf_counter()
        deadline = time.monotonic() + timeout
        with self._ack_cond:
            while True:
                links = self._repl_links
                floor = min(self.quorum, len(links))
                acked = sum(
                    1 for link in links
                    if link.acked_seq is not None and link.acked_seq >= seq
                )
                if acked >= floor:
                    TELEMETRY.observe(
                        "storage.quorum.wait", time.perf_counter() - t0
                    )
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    TELEMETRY.observe(
                        "storage.quorum.wait", time.perf_counter() - t0
                    )
                    TELEMETRY.count("storage.quorum.timeouts")
                    return False
                self._ack_cond.wait(remaining)

    def quorum_timeout_reply(self, op, seq):
        """The reply for a sync write whose replica acks never arrived:
        the op DID apply locally, so the wire carries ``maybe_applied`` —
        transient for the retry classifier (MODE_ALWAYS ops converge via
        their duplicate-key discipline; MODE_UNAPPLIED ops give up instead
        of double-applying)."""
        with self._repl_lock:
            epoch = self.epoch
        return {
            "ok": False,
            "error": "DatabaseError",
            "message": (
                f"quorum not reached for {op!r} at seq {seq}: fewer than "
                f"{self.quorum} replica(s) acknowledged within "
                f"{self.quorum_timeout:.1f}s — the write applied locally "
                "but its replication guarantee is not met"
            ),
            "maybe_applied": True,
            "quorum_timeout": True,
        }

    def demote(self, peer_epoch):
        """Runtime primary -> replica demotion: a peer proved a NEWER epoch
        exists, so every local write since that election is a condemned
        fork.  Mutations refuse from here on (``refuses_mutations``), the
        pushers stop, and every seq probe reports 0 until the new
        primary's snapshot overwrites the fork (``_resync_pending``)."""
        with self._repl_lock:
            if self._is_replica and self._resync_pending:
                return  # already demoted and awaiting repair
            doomed, self._repl_links = self._repl_links, []
            self._is_replica = True
            self._resync_pending = True
            own_epoch = self.epoch
        for link in doomed:
            link.stop(flush=False)
        self._note_demotion(peer_epoch, own_epoch)

    def _note_demotion(self, peer_epoch, own_epoch):
        TELEMETRY.count("netdb.demotions")
        if FLIGHT.enabled:
            FLIGHT.record(
                "demote", args={"peer_epoch": peer_epoch, "epoch": own_epoch}
            )
        log.warning(
            "DEMOTED: a peer serves epoch %d, newer than ours (%d) — now a "
            "read replica awaiting snapshot resync",
            peer_epoch, own_epoch,
        )

    def refuses_mutations(self):
        """Server half of the epoch fence: replicas — including a stale
        primary demoted by a newer epoch — never apply client mutations."""
        return self._is_replica

    def not_primary_reply(self):
        with self._repl_lock:
            epoch = self.epoch
        return {
            "ok": False,
            "error": "DatabaseError",
            "message": (
                f"not primary (epoch {epoch}): this server is a read "
                "replica — mutations must go to the shard's current primary"
            ),
            "not_primary": True,
            "epoch": epoch,
        }

    def snapshot_payload(self):
        """The ``snapshot`` wire op behind ``db backup``: the same
        consistent full-state dump replica resyncs ship (taken under the
        replication lock — no mutation interleaves), seq/epoch-stamped so
        the backup manifest records exactly which position it captured."""
        with self._repl_lock:
            return self._snapshot_payload_locked()

    def seq_info(self):
        """The ``seq`` wire op: applied/assigned position, role, epoch.
        A server awaiting a fork repair reports position 0 — it is neither
        electable nor a valid resume point for entry replay."""
        with self._repl_lock:
            return {
                "seq": 0 if self._resync_pending else self.seq,
                "replica": self._is_replica,
                "epoch": self.epoch,
                "resyncing": self._resync_pending,
                # The ack floor rides the probe so `db status` can render
                # each shard's write contract; pre-upgrade clients ignore
                # unknown keys — wire-compatible both ways.
                "quorum": self.quorum,
            }

    def read_stamp(self):
        """Applied seq to stamp on read replies — replicas only (plain and
        primary servers stamp reads with nothing; their answers are
        authoritative by construction)."""
        if not self._is_replica:
            return None
        with self._repl_lock:
            return 0 if self._resync_pending else self.seq

    def replication_status(self):
        """Operator view: position, role, epoch, and per-replica acked lag."""
        with self._repl_lock:
            status = {
                "seq": self.seq,
                "replica": self._is_replica,
                "epoch": self.epoch,
            }
        status["links"] = [
            {
                "address": f"{link.host}:{link.port}",
                "acked_seq": link.acked_seq,
            }
            for link in self._repl_links
        ]
        return status

    @property
    def _meta_db(self):
        """The UNWRAPPED store for replication bookkeeping (the seq doc,
        resync snapshots, stream replay): a chaos harness's FaultyDB wraps
        ``self.db`` to fault the COORDINATION protocol at the op boundary;
        replication internals fault through the protocol ops they serve,
        never independently — a fault injected into the seq upkeep would
        fail a client op AFTER it durably applied without the
        ``maybe_applied`` marking real wire losses carry."""
        return getattr(self.db, "inner", self.db)

    def _log_entry_locked(self, op, args, kwargs):
        self.seq += 1  # lint: disable=LCK002 -- caller holds _repl_lock (_locked contract)
        self._repl_log.append((self.seq, op, args, kwargs))
        self._persist_seq_locked()
        return self.seq

    def _persist_seq_locked(self):
        # The meta doc lives in the store so the sequence AND epoch ride
        # the same durability the data has (SQLite persist commits it;
        # snapshot mode pickles it with everything else).
        db = self._meta_db
        meta = {"seq": self.seq, "epoch": self.epoch}
        if not db.write("_replmeta", meta, query={"_id": "seq"}):
            db.write("_replmeta", dict(meta, _id="seq"))

    def _load_replmeta(self):
        """``(seq, epoch)`` from the persisted meta doc (0, 0 fresh)."""
        try:
            docs = self._meta_db.read("_replmeta", {"_id": "seq"})
        except Exception:  # pragma: no cover - a fresh store never raises
            return 0, 0
        if not docs:
            return 0, 0
        return int(docs[0].get("seq", 0)), int(docs[0].get("epoch", 0))

    def _snapshot_payload_locked(self):
        """Full-state resync payload from a consistent point (the caller
        holds the replication lock, so no mutation interleaves with the
        dump): every collection's raw documents plus the index specs."""
        db = self._meta_db
        collections = {}
        for name in db.collection_names():
            if name == "_replmeta":
                continue
            collections[name] = db.read(name, {})
        return {
            "seq": self.seq,
            "epoch": self.epoch,
            "collections": collections,
            "indexes": [list(spec) for spec in db.index_specs()],
        }

    def _apply_snapshot_locked(self, snapshot):
        db = self._meta_db
        for name in db.collection_names():
            db.remove(name, {})
        for col, keys, unique in snapshot.get("indexes") or []:
            db.ensure_index(col, keys, unique=unique)
        for name, docs in (snapshot.get("collections") or {}).items():
            if docs:
                db.write(name, docs)
        self.seq = int(snapshot.get("seq", 0))  # lint: disable=LCK002 -- caller holds _repl_lock (_locked contract)
        self.epoch = int(snapshot.get("epoch", self.epoch))  # lint: disable=LCK002 -- caller holds _repl_lock (_locked contract)
        self._persist_seq_locked()

    def _notify_links(self):
        for link in self._repl_links:
            link.notify()

    # --- distributed-trace adoption ------------------------------------------
    def adopt_begin(self, request):
        """``(t0, ctx)`` when this request carries a sampled trace context
        and telemetry is on — the handler's apply span window opens here;
        ``(None, None)`` otherwise (zero-cost beyond one dict get)."""
        if not TELEMETRY.enabled:
            return None, None
        wire = request.get("ctx")
        if wire is None:
            return None, None
        ctx = TraceContext.from_wire(wire)
        if ctx is None or not ctx.sampled:
            return None, None
        return time.perf_counter(), ctx

    def adopt_finish(self, op, t0, ctx):
        """Record the server-side ``netdb.apply`` span parented at the
        client's injected context, on this server's own trace track."""
        if t0 is None:
            return
        self._span_tel.record_span(
            "netdb.apply",
            start=t0,
            args={"op": op},
            parent_ctx=ctx,
            track=self._span_track,
        )
        self.flush_server_spans()

    def flush_server_spans(self, force=False):
        """Drain the private span ring into this server's own ``spans``
        collection under :data:`~orion_tpu_torch.tracing.SERVER_EXPERIMENT`
        (rate-limited; the server has no experiment identity, so the merge
        joins these back by trace_id).  Never raises — observability must
        not break the wire."""
        now = time.monotonic()
        with self._span_flush_lock:
            TSAN.write("DBServer._span_flush", self)
            if not force and now - self._last_span_flush < self.SPAN_FLUSH_INTERVAL:
                return
            self._last_span_flush = now
        spans = self._span_tel.drain_spans()
        if not spans:
            return
        try:
            self.db.write(
                "spans",
                [
                    {"experiment": SERVER_EXPERIMENT, "worker": self._span_track, **s}
                    for s in spans
                ],
            )
            # Bounded retention (runs at most once per flush gate): prune
            # the oldest down to 90% of the cap, same hysteresis rationale
            # as DocumentStorage._prune_spans.
            query = {"experiment": SERVER_EXPERIMENT}
            if self.db.count("spans", query) > self.SERVER_SPANS_CAP:
                docs = self.db.read("spans", query)
                keep = max(1, int(self.SERVER_SPANS_CAP * 0.9))
                if len(docs) > keep:
                    docs.sort(key=lambda d: d.get("ts") or 0.0)
                    cutoff = docs[len(docs) - keep].get("ts") or 0.0
                    self.db.remove(
                        "spans",
                        {"experiment": SERVER_EXPERIMENT, "ts": {"$lt": cutoff}},
                    )
        except Exception:  # pragma: no cover - observability never breaks serving
            log.debug("could not flush server spans", exc_info=True)

    def persist_snapshot(self):
        """Mark the DB dirty; the flusher thread writes at most one snapshot
        per ``persist_interval`` — a per-mutation dump would hold the DB lock
        for an O(DB-size) pickle on every heartbeat at multi-worker scale."""
        self._dirty.set()

    def _flush_loop(self):
        while not self._stop_flusher.wait(self.persist_interval):
            self._flush_if_dirty()

    def _flush_if_dirty(self):
        if not (self._snapshotting and self._dirty.is_set()):
            return
        self._dirty.clear()
        t0 = time.perf_counter() if TELEMETRY.enabled else None
        # Snapshot the UNWRAPPED store: a chaos harness's FaultyDB wrapper
        # must never be pickled into the restart image (and faults never
        # fire on the flusher's internal dump).
        db = self._meta_db
        with self._persist_lock:
            # Hold the DB lock while pickling: handler threads mutate the
            # collections concurrently and pickle iterating a changing dict
            # raises mid-dump.  The ordering is one-directional by
            # construction — no MemoryDB op calls back into the server, so
            # persist_lock is always the outer lock.
            with db._lock:
                atomic_pickle_dump(self.persist, db)
        if t0 is not None:
            # The persist span rides the server track (no parent: the
            # flusher batches many requests' dirt into one dump).  Recorded
            # OUTSIDE the persist lock — span bookkeeping must never mint a
            # persist_lock -> registry-lock ordering edge.
            self._span_tel.record_span(
                "netdb.persist", start=t0, track=self._span_track
            )

    def serve_forever(self, *args, **kwargs):
        # Direct callers (the blocking `serve()` entry) mark the flag too.
        self._serving = True
        super().serve_forever(*args, **kwargs)

    def shutdown(self):
        self._stop_flusher.set()
        # BaseServer.shutdown() waits on a flag only serve_forever sets at
        # exit — calling it on a server that never served deadlocks
        # forever.  A constructed-but-never-served server still owns
        # sockets/links worth closing below.
        if getattr(self, "_serving", False):
            super().shutdown()
        self.close_connections()
        # Replica links drain after the accept loop stops (one best-effort
        # final push), so a clean primary shutdown leaves reachable
        # replicas caught up.
        for link in self._repl_links:
            link.stop(flush=True)
        # Span flush BEFORE the final snapshot so adopted spans recorded
        # since the last gate land in the persisted image too.
        if TELEMETRY.enabled:
            self.flush_server_spans(force=True)
        self._flush_if_dirty()  # final durable snapshot

    def serve_background(self):
        """Start serving on a daemon thread; returns (host, port).  The
        serving flag is set BEFORE the thread starts: a shutdown() racing
        the thread's entry into serve_forever must still run the real
        BaseServer.shutdown handshake, or the accept loop would start
        against a server its owner already believes stopped."""
        self._serving = True
        thread = threading.Thread(target=self.serve_forever, daemon=True)
        thread.start()
        return self.address


def serve(host="127.0.0.1", port=8765, persist=None, secret=None,
          replicate_to=None, replica=False, quorum=0, quorum_timeout=2.0):
    """Blocking server entry point (`orion-tpu-torch db serve`)."""
    server = DBServer(
        host=host, port=port, persist=persist, secret=secret,
        replicate_to=replicate_to, replica=replica, quorum=quorum,
        quorum_timeout=quorum_timeout,
    )
    log.info("serving orion-tpu-torch DB on %s:%s", *server.address)
    auth = "shared-secret auth" if secret else "NO auth (open server)"
    role = ""
    if replicate_to:
        role = f", replicating to {len(list(replicate_to))} replica(s)"
    elif replica:
        role = ", read replica"
    if quorum:
        role += f", quorum={int(quorum)}, quorum timeout {float(quorum_timeout):g}s"
    print(
        f"orion-tpu-torch db server listening on "
        f"{server.address[0]}:{server.address[1]} ({auth}{role})"
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


def _translate(response, raise_errors=True):
    """Wire response -> result, or the mapped exception (raised, or returned
    as an instance when ``raise_errors=False`` for pipelined batches)."""
    if response.get("ok"):
        return response.get("result")
    error = response.get("error")
    message = response.get("message", "")
    exc_cls = {
        "DuplicateKeyError": DuplicateKeyError,
        "KeyError": KeyError,
        "AuthenticationError": AuthenticationError,
    }.get(error)
    exc = exc_cls(message) if exc_cls else DatabaseError(f"{error}: {message}")
    if response.get("maybe_applied") and isinstance(exc, DatabaseError):
        exc.maybe_applied = True
    if response.get("not_primary") and isinstance(exc, DatabaseError):
        # The server refused a mutation because it is (now) a replica —
        # the epoch fence's wire form.  Nothing was applied; the sharded
        # router uses the marker to refresh its view of who the primary is
        # before the op-level retry re-runs.
        exc.not_primary = True
        exc.epoch = int(response.get("epoch", 0) or 0)
    if raise_errors:
        raise exc
    return exc


class NetworkDB:
    """AbstractDB-contract client for a :class:`DBServer`.

    Thread-safe: one socket guarded by a lock (requests are tiny; contention
    is on the server's DB lock anyway).  Idempotent reads reconnect and
    retry transparently across a server restart (``--persist``).  Mutations
    are never blindly re-sent; instead, a connection idle longer than
    ``idle_probe`` seconds is ping-probed (and re-established if dead)
    before a mutation uses it, so the common restart-while-idle case also
    succeeds.  Only a server death in the middle of an in-flight mutation
    surfaces as DatabaseError — the one case where applied-or-not is
    genuinely unknowable without server-side request ids.
    """

    #: A count is one small request/reply, vastly cheaper than shipping the
    #: full trial history over the wire (the producer's count-gated sync
    #: keys on this).
    cheap_counts = True

    def __init__(
        self, host="127.0.0.1", port=8765, timeout=60.0, idle_probe=1.0,
        secret=None, reconnect_jitter=0.1, jitter_seed=None,
    ):
        self.host = host
        self.port = int(port)
        self.timeout = timeout
        self.idle_probe = idle_probe
        self.secret = secret
        #: Herd control: a RE-connect (never the first connect) sleeps a
        #: full-jittered uniform draw in [0, reconnect_jitter) first, so N
        #: workers dropped by one server restart do not re-handshake in
        #: lockstep (op-level backoff was already jittered; the reconnect
        #: itself was not).  ``jitter_seed`` pins the stream for tests.
        self.reconnect_jitter = float(reconnect_jitter)
        self._jitter_rng = random.Random(jitter_seed)
        self._lock = threading.Lock()
        self._sock = None
        self._file = None
        self._last_used = 0.0
        #: Replication sequence stamped by the last response that carried
        #: one (mutations answered by a replicating primary; reads answered
        #: by a replica).  None until such a response arrives — plain
        #: servers never stamp.  Read via :meth:`seq_snapshot`.
        self.last_seq = None
        #: Replication epoch stamped next to the seq (promotion protocol);
        #: None until a stamped response arrives.
        self.last_epoch = None
        #: Socket send/receive cycles since construction (one per _call,
        #: one per pipeline/batch regardless of op count) — bench.py's
        #: storage breakdown reads this to prove a q-batch round costs O(1)
        #: wire round trips.
        self.round_trips = 0
        #: Request lines put on the wire: a pipeline of N ops writes N (the
        #: server runs N dispatch/persist cycles), the batch op writes 1.
        #: This is the per-round "wire operations" count the breakdown
        #: reports — the quantity the batch op takes from O(q) to O(1).
        self.wire_requests = 0
        #: Re-established connections (any _connect after the first):
        #: restarts, idle-probe failures, send-phase EPIPE resends.  A
        #: rising rate is THE first symptom of a flapping server/link —
        #: exported as the ``storage.network.reconnects`` telemetry counter.
        self.reconnects = 0
        self._ever_connected = False
        # Flipped when a server rejects the batch wire op (pre-batch
        # server); apply_batch then rides pipeline() instead.
        self._batch_unsupported = False

    # --- wire ----------------------------------------------------------------
    def _connect(self):
        TSAN.write("NetworkDB._conn", self)
        self._close()
        if self._ever_connected and self.reconnect_jitter > 0.0:
            # Full jitter BEFORE the dial: after a drop_all()-style restart
            # every client wakes at once, and without this spread they all
            # hit the listener (and redo the PBKDF2 handshake) in lockstep.
            time.sleep(self._jitter_rng.random() * self.reconnect_jitter)
        sock = socket.create_connection((self.host, self.port), timeout=self.timeout)
        if self._ever_connected:
            self.reconnects += 1
            # Reconnects are flight-recorder events (orion_tpu_torch.health):
            # the first symptom of a flapping link belongs on the crash
            # timeline.  Guarded — no args allocation when disabled.
            if FLIGHT.enabled:
                FLIGHT.record(
                    "storage.reconnect",
                    args={"host": self.host, "port": self.port},
                )
        self._ever_connected = True
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._file = sock.makefile("rb")
        # lint: disable=LCK002 -- every caller of _connect holds _lock
        self._last_used = time.monotonic()
        if self.secret is not None:
            self._authenticate()

    def _authenticate(self):
        """Mutual HMAC handshake on a fresh connection (reconnects redo it):
        client proves first, then verifies the server proof released with
        the auth-ok reply — the shared :func:`perform_client_handshake`
        flow both wire surfaces use."""
        try:
            perform_client_handshake(
                self._exchange, self.secret, f"{self.host}:{self.port}"
            )
        except AuthenticationError:
            self._close()
            raise

    def _close(self):
        TSAN.write("NetworkDB._conn", self)
        for closer in (self._file, self._sock):
            if closer is not None:
                try:
                    closer.close()
                except OSError:  # pragma: no cover
                    pass
        self._sock = self._file = None

    def close(self):
        """Public teardown: ``_close`` is the internal caller-holds-_lock
        form — external owners (bench, tests, pools) must come through the
        lock or a concurrent request could race the socket teardown (the
        runtime sanitizer flags the bare form)."""
        with self._lock:
            self._close()

    def __getstate__(self):
        # Sockets don't cross fork/pickle; children reconnect lazily.
        return {
            "host": self.host,
            "port": self.port,
            "timeout": self.timeout,
            "secret": self.secret,
            "reconnect_jitter": self.reconnect_jitter,
        }

    def __setstate__(self, state):
        self.__init__(**state)

    # Ops safe to re-send after a dropped connection.  Mutating ops must NOT
    # be retried blindly: the server may have applied the request before the
    # reply was lost, and a re-send would double-apply it (a second trial
    # reserved, a spurious DuplicateKeyError on an insert that succeeded).
    # `snapshot` is a read; `promote` is idempotent by construction (a
    # resend at the same epoch reports the standing state, never re-flips).
    _IDEMPOTENT = frozenset(
        {"read", "count", "index_information", "ping", "seq", "snapshot",
         "promote"}
    )

    def _exchange(self, payload):
        """One request/response on the current socket; raises on any break.
        Round-trip latency feeds the ``storage.network.rtt`` telemetry
        histogram when the registry is enabled."""
        t0 = time.perf_counter() if TELEMETRY.enabled else None
        TSAN.write("NetworkDB._conn", self)
        self._sock.sendall(payload)
        response = _read_line(self._file, _REPLY_MAX_LINE)
        if response is None:
            raise ConnectionError("server closed the connection")
        self._last_used = time.monotonic()  # lint: disable=LCK002 -- caller holds _lock
        self.round_trips += 1  # lint: disable=LCK002 -- caller holds _lock
        self.wire_requests += 1  # lint: disable=LCK002 -- caller holds _lock
        self._note_seq(response)  # caller holds _lock
        if t0 is not None:
            TELEMETRY.observe("storage.network.rtt", time.perf_counter() - t0)
        return response

    def _note_seq(self, response):
        """Track the replication sequence/epoch optionally stamped on a
        reply (see :attr:`last_seq`).  Callers hold ``_lock``."""
        if not isinstance(response, dict):
            return
        seq = response.get("seq")
        if seq is not None:
            self.last_seq = int(seq)  # caller holds _lock
        epoch = response.get("epoch")
        if epoch is not None:
            self.last_epoch = int(epoch)  # caller holds _lock

    def seq_snapshot(self):
        """Thread-safe read of :attr:`last_seq` (the sharded router compares
        a replica's read stamp against its primary's write stamp)."""
        with self._lock:
            return self.last_seq

    def stamp_snapshot(self):
        """Thread-safe ``(last_seq, last_epoch)`` — the router's fencing
        check reads both with one lock hold."""
        with self._lock:
            return self.last_seq, self.last_epoch

    def _probe_idle_connection(self):
        """Ping a connection that has sat idle so a mutation never rides a
        half-open socket from a restarted server."""
        if self._sock is None:
            return
        if time.monotonic() - self._last_used <= self.idle_probe:
            return
        try:
            self._exchange(_dumps({"op": "ping"}))
        except (OSError, ConnectionError, json.JSONDecodeError):
            self._close()  # mutation path will reconnect fresh

    @staticmethod
    def _wire_request(op, args, kwargs):
        """The request envelope, with the ambient TraceContext injected as
        the optional ``ctx`` field when telemetry is on — the server adopts
        it as the parent of its apply span.  Pre-upgrade servers ignore the
        key (wire-compatible), and a disabled registry pays one attribute
        check."""
        request = {"op": op, "args": list(args), "kwargs": kwargs}
        if TELEMETRY.enabled:
            ctx = current_trace_context()
            if ctx is not None and ctx.sampled:
                request["ctx"] = ctx.to_wire()
        return request

    def _call(self, op, *args, **kwargs):
        payload = _dumps(self._wire_request(op, args, kwargs))
        retriable = op in self._IDEMPOTENT
        with self._lock:
            for attempt in range(2):
                sent = False
                try:
                    if not retriable:
                        self._probe_idle_connection()
                    if self._sock is None:
                        self._connect()
                    response = self._exchange(payload)
                    break
                except (OSError, ConnectionError, json.JSONDecodeError) as exc:
                    sent = self._sock is not None
                    self._close()
                    if attempt or (sent and not retriable):
                        error = DatabaseError(
                            f"connection to {self.host}:{self.port} lost during "
                            f"{op!r}: {exc}"
                        )
                        # The request may have reached the server before the
                        # connection died: applied-or-not is unknowable, and
                        # the unified retry policy must not blindly re-send
                        # non-converging mutations (storage/retry.py).
                        error.maybe_applied = sent
                        raise error from exc
        return _translate(response)

    def pipeline(self, ops):
        """Execute ``[(op, args, kwargs), ...]`` over ONE round trip.

        All requests are written in a single send; the server's handler loop
        consumes them back-to-back off the stream (each op individually
        atomic, exactly as if sent one by one), and the responses are read in
        order afterwards.  This is what makes q-batch reservation affordable
        over the wire: q pipelined find-one-and-updates cost ~1 RTT instead
        of q serialized ones (the role MongoDB's wire batching plays for the
        reference, `mongodb.py:229-247`).

        Returns a list the same length as ``ops``: each element is the op's
        result, or an *exception instance* (DuplicateKeyError/KeyError/...)
        for that op — per-op failures must not abort the batch (a duplicate
        in slot 3 says nothing about slot 4).  A connection drop mid-batch
        raises DatabaseError: mutations may or may not have applied, same
        contract as a lost in-flight ``_call``.
        """
        if not ops:
            return []
        payload = b"".join(
            _dumps(self._wire_request(op, args, kwargs))
            for op, args, kwargs in ops
        )
        with self._lock:
            # Mirror _call's connect contract: nothing has been sent yet, so
            # one reconnect retry is safe, and a dead server surfaces as
            # DatabaseError (the type the CLI handles), never a raw OSError.
            try:
                self._probe_idle_connection()
                if self._sock is None:
                    self._connect()
            except (OSError, ConnectionError):
                self._close()
                try:
                    self._connect()
                except (OSError, ConnectionError) as exc:
                    # lint: disable=STO003 -- connect failed pre-send: nothing applied
                    raise DatabaseError(
                        f"cannot connect to {self.host}:{self.port} for "
                        f"pipeline of {len(ops)} ops: {exc}"
                    ) from exc
            # Responses are drained CONCURRENTLY with the send (reads and
            # writes ride opposite socket directions): a send-then-read
            # pipeline deadlocks once a big batch fills both kernel socket
            # buffers — the server blocks writing responses nobody reads,
            # stops consuming requests, and the client's sendall blocks too.
            rtt_t0 = time.perf_counter() if TELEMETRY.enabled else None
            responses, reader_error = [], []

            def _drain():
                try:
                    for _ in ops:
                        response = _read_line(self._file, _REPLY_MAX_LINE)
                        if response is None:
                            raise ConnectionError("server closed the connection")
                        responses.append(response)
                except Exception as exc:  # surfaced after join
                    reader_error.append(exc)

            reader = threading.Thread(target=_drain, daemon=True)
            reader.start()
            try:
                self._sock.sendall(payload)
            except OSError as exc:
                reader_error.append(exc)
            # No join deadline: the socket timeout already bounds each READ
            # (60s of silence = dead server, surfaced by the reader), so the
            # reader always terminates — while a big batch whose responses
            # are steadily streaming in may legitimately take longer than
            # any single-op timeout and must not be declared lost mid-flight.
            reader.join()
            if reader_error:
                exc = reader_error[0]
                self._close()
                error = DatabaseError(
                    f"connection to {self.host}:{self.port} lost during "
                    f"pipeline of {len(ops)} ops: {exc}"
                )
                # A prefix of the pipelined ops may have applied before the
                # connection died (the server dispatches line by line).
                error.maybe_applied = True
                raise error from exc
            self._last_used = time.monotonic()
            self.round_trips += 1
            self.wire_requests += len(ops)
            for r in responses:
                self._note_seq(r)
            if rtt_t0 is not None:
                # One histogram sample per socket round trip, same as
                # _exchange — the batch paths are the produce round's
                # dominant wire ops and must not be invisible in the rtt
                # signal.
                TELEMETRY.observe(
                    "storage.network.rtt", time.perf_counter() - rtt_t0
                )
        return [_translate(r, raise_errors=False) for r in responses]

    def apply_batch(self, ops):
        """Execute ``[(op, args, kwargs), ...]`` as ONE wire request/response.

        Tighter than :meth:`pipeline` (N request lines, N response lines,
        N server dispatch/persist cycles in ~1 RTT): the batch rides one
        request line, the server applies it as one atomic unit against the
        store — one lock hold, and in ``--persist x.sqlite`` mode ONE
        transaction/fsync for the whole q-batch — and answers with one
        response line of per-slot outcomes (results or exception
        instances, same contract as pipeline).

        The request reuses this instance's persistent socket.  A send-phase
        failure (EPIPE/ECONNRESET against a socket a restarted server
        closed) means the request line never fully reached the server, so
        nothing was applied and a reconnect + single resend is safe; only a
        failure AFTER the payload was handed off is genuinely unknowable
        and surfaces as DatabaseError.  Talking to a pre-batch server, the
        rejected op falls back to :meth:`pipeline` transparently (and stops
        re-trying the batch op on that instance)."""
        if not ops:
            return []
        if self._batch_unsupported:
            return self.pipeline(ops)
        # The batch's single RESPONSE line aggregates every sub-op result;
        # document-returning ops (read / read_and_write, e.g. a q-batch
        # reservation's claimed trial docs) at large op counts could push
        # it past the server's line cap — which the request-side guard
        # below cannot see.  Chunk those through pipeline's per-op
        # response lines (still ~1 RTT).
        if len(ops) > 512 and any(
            op in ("read", "read_and_write") for op, _, _ in ops
        ):
            return self.pipeline(ops)
        payload = _dumps(
            self._wire_request(
                "batch",
                [[[op, list(args), kwargs] for op, args, kwargs in ops]],
                {},
            )
        )
        if len(payload) > _MAX_LINE:
            # One line over the server's readline cap would be read as a
            # truncated request and silently dropped (surfacing as a
            # misleading "connection lost").  pipeline ships one line per
            # op, so an oversized batch rides it instead.
            return self.pipeline(ops)
        with self._lock:
            response = None
            for attempt in range(2):
                try:
                    # Shrink the applied-or-not window: a socket that sat
                    # idle across a server restart is ping-probed (and
                    # reconnected) before the batch rides it — sendall can
                    # succeed into the kernel buffer of a dead connection.
                    self._probe_idle_connection()
                    if self._sock is None:
                        self._connect()
                    rtt_t0 = time.perf_counter() if TELEMETRY.enabled else None
                    self._sock.sendall(payload)
                except (OSError, ConnectionError) as exc:
                    # Send phase: the request line was not fully delivered
                    # (a partial line is dropped by the server's readline),
                    # so retrying on a fresh connection cannot double-apply.
                    self._close()
                    if attempt:
                        # lint: disable=STO003 -- send-phase loss: nothing applied
                        raise DatabaseError(
                            f"cannot send batch of {len(ops)} ops to "
                            f"{self.host}:{self.port}: {exc}"
                        ) from exc
                    continue
                try:
                    response = _read_line(self._file, _REPLY_MAX_LINE)
                    if response is None:
                        raise ConnectionError("server closed the connection")
                except (OSError, ConnectionError, json.JSONDecodeError) as exc:
                    # Read phase: the server may or may not have applied the
                    # batch — same contract as a lost in-flight _call.
                    self._close()
                    error = DatabaseError(
                        f"connection to {self.host}:{self.port} lost during "
                        f"batch of {len(ops)} ops: {exc}"
                    )
                    error.maybe_applied = True
                    raise error from exc
                self._last_used = time.monotonic()
                self.round_trips += 1
                self.wire_requests += 1
                self._note_seq(response)
                if rtt_t0 is not None:
                    TELEMETRY.observe(
                        "storage.network.rtt", time.perf_counter() - rtt_t0
                    )
                break
        try:
            outcomes = _translate(response)
        except DatabaseError as exc:
            if "bad op 'batch'" in str(exc):
                # Pre-batch server: nothing was applied (the op was
                # rejected before dispatch) — downgrade to pipeline.
                self._batch_unsupported = True
                return self.pipeline(ops)
            raise
        return [_translate(r, raise_errors=False) for r in outcomes]

    # --- AbstractDB contract --------------------------------------------------
    def ping(self):
        return self._call("ping") == "pong"

    def ensure_index(self, collection, keys, unique=False):
        return self._call("ensure_index", collection, keys, unique=unique)

    def ensure_indexes(self, specs):
        return self._call("ensure_indexes", [list(s) for s in specs])

    def index_information(self, collection):
        return self._call("index_information", collection)

    def drop_index(self, collection, name):
        return self._call("drop_index", collection, name)

    def write(self, collection, data, query=None):
        return self._call("write", collection, data, query=query)

    def update_many(self, collection, pairs):
        """One pipelined round trip (see MemoryDB.update_many); the first
        per-op failure is raised after the whole batch has been drained."""
        results = self.pipeline(
            [("write", [collection, data], {"query": query})
             for query, data in pairs]
        )
        total = 0
        for result in results:
            if isinstance(result, Exception):
                raise result
            total += result
        return total

    def read(self, collection, query=None, projection=None):
        return self._call("read", collection, query=query, projection=projection)

    def read_and_write(self, collection, query, data):
        return self._call("read_and_write", collection, query, data)

    def count(self, collection, query=None):
        return self._call("count", collection, query=query)

    def remove(self, collection, query=None):
        return self._call("remove", collection, query=query)
