"""Gateway client: wire driver + the ``BaseAlgorithm`` adapter (port of
``orion_tpu/serve/client.py``; it speaks the reference's wire, so a port
client can drive a reference gateway and back).

:class:`GatewayClient` owns one socket to a gateway (same discipline as
``storage/netdb.py``'s driver: lock-guarded persistent connection,
idle-probe before reuse, send-phase reconnect-and-resend, read-phase loss
marked ``maybe_applied``) and runs every request under the unified
:class:`~orion_tpu_torch.storage.retry.RetryPolicy`.

The per-op retry modes are all ``"always"`` — by construction, not by
optimism:

- **suggest** is an idempotent re-ask: the request carries a client-minted
  ``req_id`` and the gateway caches the computed reply per tenant, so a
  resend after a lost reply returns the SAME suggestions instead of
  burning a second RNG draw (and the worker registers exactly one set of
  trials).
- **observe**/**register** converge on client-minted ids: the gateway
  keeps a per-tenant applied-id ledger and acks a duplicate without
  re-feeding the algorithm, so an applied-but-reply-lost resend cannot
  double-observe.
- **attach** is a natural upsert.

:class:`RemoteAlgorithm` implements the ``BaseAlgorithm`` suggest/observe
surface over that wire, so ``Producer``/``workon`` drive a gateway tenant
transparently (config ``serve: {address: host:port}``).  Producer
semantics are mirrored exactly: its per-round deepcopy becomes a
lightweight *naive* clone that buffers constant-liar lies client-side and
ships them with the round's suggest; the gateway rebuilds its server-side
naive copy once per clone epoch, suggests from it, and syncs the RNG
stream back to the real tenant — the same sequence ``Producer._produce``
runs locally.  A gateway restart surfaces as ``UnknownTenant``; the
adapter re-attaches and replays its client-side observation log.

The adapter is a host object: it builds its (unused) random streams on the
CPU and never calls into CUDA, so a worker process that drives a gateway
tenant creates no CUDA context — the gateway owns the card.
"""

import json
import logging
import socket
import threading
import time
import uuid
from collections import deque

import numpy as np

from orion_tpu_torch.algo.base import BaseAlgorithm
from orion_tpu_torch.analysis.sanitizer import TSAN
from orion_tpu_torch.serve.fleet import (
    FLEET_MAX_HOPS,
    FLEET_RETRY_DEFAULTS,
    FleetRouter,
    parse_serve_addresses,
    ring_key,
)
from orion_tpu_torch.serve.protocol import (
    GatewayError,
    RetryAfterError,
    UnknownTenantError,
    WrongGatewayError,
    dumps_line,
    read_line,
)
from orion_tpu_torch.storage.netdb import perform_client_handshake
from orion_tpu_torch.storage.retry import MODE_ALWAYS, create_retry_policy
from orion_tpu_torch.telemetry import TELEMETRY
from orion_tpu_torch.utils.exceptions import AuthenticationError, DatabaseError

log = logging.getLogger(__name__)

#: Per-op client span names, precomputed so the request hot path never
#: builds a metric key — these are the CLIENT half of a distributed trace
#: hop: the gateway adopts the injected context as the parent of its
#: ``serve.request`` span, so wire time = client span − gateway span.
_CLIENT_SPAN_NAMES = {
    "suggest": "serve.client.suggest",
    "observe": "serve.client.observe",
    "register": "serve.client.register",
    "attach": "serve.client.attach",
}

#: Replay-log bound (observe/register batches, not rows).  Far beyond any
#: normal run's round count; hitting it degrades the GATEWAY-LOSS recovery
#: to the most recent batches (with a warning) — normal operation, worker
#: restarts (fresh tenant, producer re-feeds from storage) and persisted
#: gateway restarts are unaffected.
OBS_LOG_CAP = 4096


class GatewayClient:
    """Thread-safe wire client for a :class:`GatewayServer`.

    ``retry`` takes the same knobs as the ``storage.retry`` config section
    (``create_retry_policy``); the default policy is widened (more
    attempts, longer deadline) because riding out a gateway restart is a
    first-class path here, not an edge case.
    """

    def __init__(
        self, host="127.0.0.1", port=8777, timeout=60.0, idle_probe=1.0,
        retry=None, secret=None,
    ):
        self.host = host
        self.port = int(port)
        self.timeout = timeout
        self.idle_probe = idle_probe
        #: Shared secret for the mutual HMAC handshake (netdb discipline:
        #: runs on every fresh connection, reconnects redo it; a no-auth
        #: gateway is refused when a secret is configured — no downgrade).
        self.secret = secret
        if retry is None:
            retry = {"max_attempts": 8, "deadline": 60.0, "base_delay": 0.05}
        self._policy = create_retry_policy(retry)
        self._lock = threading.Lock()
        self._sock = None
        self._file = None
        self._last_used = 0.0
        self._ever_connected = False
        #: Socket request/response cycles + re-established connections —
        #: the same first-symptom counters the netdb driver exports.
        self.round_trips = 0
        self.reconnects = 0
        #: Backpressure refusals honored (each slept the gateway's
        #: retry_after hint before the policy re-asked).
        self.backpressure_honored = 0

    # --- wire ----------------------------------------------------------------
    def _connect(self):
        TSAN.write("GatewayClient._conn", self)
        self._close()
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        if self._ever_connected:
            self.reconnects += 1
        self._ever_connected = True
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._file = sock.makefile("rb")
        self._last_used = time.monotonic()
        if self.secret is not None:
            try:
                perform_client_handshake(
                    self._handshake_exchange, self.secret,
                    f"{self.host}:{self.port}",
                )
            except AuthenticationError:
                self._close()
                raise

    def _handshake_exchange(self, payload):
        """One raw request/response for the handshake (pre-protocol: no
        retry, no translation — a torn line is a dead connection)."""
        self._sock.sendall(payload)
        response = read_line(self._file)
        if response is None:
            raise ConnectionError("gateway closed the connection")
        return response

    def _close(self):
        TSAN.write("GatewayClient._conn", self)
        for closer in (self._file, self._sock):
            if closer is not None:
                try:
                    closer.close()
                except OSError:  # pragma: no cover
                    pass
        self._sock = self._file = None

    def close(self):
        with self._lock:
            self._close()

    def _probe_idle_connection(self):
        """Ping a connection that sat idle so a request never rides a
        half-open socket from a restarted gateway (netdb's idle-probe
        discipline — shrinks the applied-or-not window to genuinely
        in-flight losses)."""
        if self._sock is None:
            return
        if time.monotonic() - self._last_used <= self.idle_probe:
            return
        try:
            self._sock.sendall(dumps_line({"op": "ping"}))
            if read_line(self._file) is None:
                raise ConnectionError("gateway closed the connection")
            self._last_used = time.monotonic()
        except (OSError, ConnectionError, json.JSONDecodeError):
            self._close()  # the request path below reconnects fresh

    def _exchange_once(self, op, line):
        """One request/response cycle.  A send-phase failure reconnects and
        resends ONCE (the request line never fully reached the gateway — a
        torn line is dropped by its readline, so nothing was applied); a
        read-phase failure is the genuinely ambiguous in-flight loss and
        carries ``maybe_applied`` for the retry policy."""
        for attempt in range(2):
            try:
                TSAN.write("GatewayClient._conn", self)
                self._probe_idle_connection()
                if self._sock is None:
                    self._connect()
                self._sock.sendall(line)
            except (OSError, ConnectionError) as exc:
                self._close()
                if attempt:
                    error = DatabaseError(
                        f"cannot send {op!r} to gateway "
                        f"{self.host}:{self.port}: {exc}"
                    )
                    # Send phase: nothing was applied; resends are safe in
                    # every retry mode.
                    error.maybe_applied = False
                    raise error from exc
                continue
            try:
                response = read_line(self._file)
                if response is None:
                    raise ConnectionError("gateway closed the connection")
            except (OSError, ConnectionError, json.JSONDecodeError) as exc:
                self._close()
                error = DatabaseError(
                    f"connection to gateway {self.host}:{self.port} lost "
                    f"during {op!r}: {exc}"
                )
                # Read phase: the gateway may or may not have applied the
                # request — the op-level id dedup (req_id/obs_id) is what
                # makes the policy's re-ask converge.
                error.maybe_applied = True
                raise error from exc
            self._last_used = time.monotonic()
            self.round_trips += 1
            return response

    def _translate(self, op, response):
        if response.get("ok"):
            return response.get("result")
        error = response.get("error")
        message = response.get("message", "")
        if error == "RetryAfter":
            delay = float(response.get("retry_after", 0.05))
            # Under the client lock: _translate runs after request()
            # released it, and the counter is shared client state (the
            # bare increment was a sanitizer-found lost-update race).
            with self._lock:
                TSAN.write("GatewayClient._conn", self)
                self.backpressure_honored += 1
            TELEMETRY.count("serve.client.backpressure")
            # Honor the gateway's pacing hint BEFORE surfacing the
            # transient refusal — the retry policy then adds its own
            # jittered backoff on top, so a saturated gateway sees the
            # fleet thin out instead of stampede.
            time.sleep(delay)
            raise RetryAfterError(
                f"gateway backpressure on {op!r}: {message}", retry_after=delay
            )
        if error == "UnknownTenant":
            raise UnknownTenantError(message)
        if error == "WrongGateway":
            # Fleet placement refusal: fatal to the retry policy (this
            # member will keep refusing), handled by the router one level
            # up — the reply carries the authoritative membership.
            raise WrongGatewayError(
                message,
                owner=response.get("owner"),
                addresses=response.get("addresses"),
                epoch=response.get("epoch"),
            )
        if error == "AuthenticationError":
            # Fatal to the retry policy — re-sending the same credentials
            # can only repeat the refusal.
            raise AuthenticationError(message)
        raise GatewayError(f"{error}: {message}")

    def request(self, op, payload=None, mode=MODE_ALWAYS):
        """One gateway op under the retry policy.  ``mode`` declares the
        applied-or-not contract exactly as the storage layer's decorators
        do; every current op is ``"always"`` because each carries a
        client-minted id the gateway dedups on (see module docstring).

        Each attempt (including re-asks) runs as its own ``serve.client.*``
        span and injects that span's :class:`TraceContext` as the request's
        optional ``ctx`` field — the gateway adopts it, so the distributed
        merge draws client request -> gateway -> coalesced dispatch.
        Pre-upgrade gateways ignore the key."""
        body = dict(payload or {})
        body["op"] = op
        span_name = _CLIENT_SPAN_NAMES.get(op, "serve.client.request")

        def call():
            if TELEMETRY.enabled:
                with TELEMETRY.span(span_name) as span:
                    # span.ctx is None when no ambient trace exists (a bare
                    # client outside a producer round): nothing to inject.
                    ctx = span.ctx
                    if ctx is not None and ctx.sampled:
                        body["ctx"] = ctx.to_wire()
                    line = dumps_line(body)
                    with self._lock:
                        response = self._exchange_once(op, line)
            else:
                line = dumps_line(body)
                with self._lock:
                    response = self._exchange_once(op, line)
            return self._translate(op, response)

        if self._policy is None:
            return call()
        return self._policy.run(call, op=f"serve.{op}", mode=mode)

    @property
    def address(self):
        return f"{self.host}:{self.port}"

    def ping(self):
        return self.request("ping") == "pong"

    def stats(self):
        return self.request("stats")

    def fleet(self):
        return self.request("fleet")


class RemoteAlgorithm(BaseAlgorithm):
    """``BaseAlgorithm`` adapter for a gateway tenant.

    The real instance forwards observes (with replayable client-side
    logging) and re-asks suggests idempotently; the producer's per-round
    deepcopy yields a *naive clone* that buffers lies and ships them with
    its suggest requests (``naive=True`` + a clone-epoch counter, so the
    gateway rebuilds its server-side naive copy exactly once per producer
    round no matter how many suggests the round issues).
    """

    supports_async_suggest = False
    speculation_safe = False
    uses_observe_cube = True

    def __init__(
        self, space, priors, algo_config, client, tenant, seed=None,
        quotas=None, router=None,
    ):
        # Host-only: the streams live on the CPU and are never drawn from
        # here (the gateway-side tenant owns the real ones).
        super().__init__(space, seed=seed, device="cpu")
        self._priors = dict(priors)
        self._algo_config = algo_config
        self._client = client
        self._tenant = tenant
        self._quotas = dict(quotas or {})
        # Fleet routing (None = single gateway, the pre-fleet path
        # verbatim): the router owns one client + one retry policy per
        # member; ``_resolve`` re-points ``_client`` at the ring owner
        # before every logical op, and ``_rpc``'s hop loop handles
        # WrongGateway adoption and dead-member failover.
        self._router = router
        self._ring_key = ring_key(tenant)
        self._takeover = False
        self._naive = False
        self._naive_epoch = 0
        self._lies = []
        # Shared BY REFERENCE with every naive clone: one client-side
        # ledger per tenant, whatever instance is doing the talking.
        # obs_log is the replay source for gateway restarts/evictions —
        # bounded (the gateway's ledgers are too), entries stored WITHOUT
        # their cube rows (the replay recomputes them through the same
        # Space codec, bit-identically, instead of duplicating the whole
        # observed history in RAM for the run's lifetime).
        self._shared = {
            "uid": uuid.uuid4().hex[:12],  # req_id namespace per process
            "epoch": 0,
            "seq": 0,
            "obs_log": deque(maxlen=OBS_LOG_CAP),
            "obs_log_truncated": False,
            "health": None,  # last gateway-reported health record
            "attached": False,
            "wants_register": False,
            "gateway": getattr(client, "address", None),
        }

    # --- naive-clone protocol ----------------------------------------------
    def __deepcopy__(self, memo):
        # Producer's per-round naive copy: share the wire client and the
        # durable ledgers by reference, buffer lies locally, and mint a
        # fresh clone epoch — the gateway key for "rebuild your server-side
        # naive copy from the real tenant now".
        clone = type(self).__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone._naive = True
        clone._lies = []
        self._shared["epoch"] += 1
        clone._naive_epoch = self._shared["epoch"]
        memo[id(self)] = clone
        return clone

    def _next_seq(self):
        self._shared["seq"] += 1
        return self._shared["seq"]

    # --- wire plumbing -------------------------------------------------------
    def _resolve(self):
        """Point ``_client`` at the ring owner (fleet mode).  Sets the
        takeover flag when the owner is only reachable off-ring (the real
        owner is marked down) — the next attach must declare it."""
        if self._router is None:
            return
        address, takeover = self._router.resolve(self._ring_key)
        self._takeover = takeover
        client = self._router.client(address)
        if client is not self._client:
            self._client = client
            self._shared["gateway"] = address
            self._shared["attached"] = False

    def _rpc(self, op, payload, mode=MODE_ALWAYS):
        """One logical op.  Single-gateway mode is the plain gateway's
        contract: UnknownTenant -> re-attach + replay + one re-ask.  Fleet
        mode wraps that in a bounded re-resolve loop: ``WrongGateway``
        adopts the reply's membership and re-routes; a transport failure
        that exhausted the member's own retry policy marks it down and
        fails over to the ring's survivor (re-attaching there restores
        the persisted snapshot or replays the log — ledger dedup makes
        either path convergent)."""
        payload = dict(payload, tenant=self._tenant)
        hops = FLEET_MAX_HOPS if self._router is not None else 1
        last_error = None
        for _ in range(hops):
            self._resolve()
            try:
                self._ensure_attached()
                try:
                    return self._client.request(op, payload, mode=mode)
                except UnknownTenantError:
                    # Gateway restarted without persist (or evicted this
                    # tenant): re-attach and replay the client-side
                    # observation log, then re-ask the original op once.
                    log.info(
                        "gateway lost tenant %r; re-attaching and replaying "
                        "%d observation batches",
                        self._tenant,
                        len(self._shared["obs_log"]),
                    )
                    self._attach(replay=True)
                    return self._client.request(op, payload, mode=mode)
            except WrongGatewayError as exc:
                if self._router is None:
                    raise
                self._router.adopt(exc.addresses, exc.epoch)
                if exc.owner:
                    # The refusing member vouches for the owner: clear any
                    # stale down-mark so the re-resolve can reach it.
                    self._router.mark_up(exc.owner)
                self._shared["attached"] = False
                last_error = exc
                continue
            except RetryAfterError:
                # Saturation/fence backpressure that outlived the member's
                # whole policy is not death — surface it, don't fail over
                # (the tenant's state is THERE; a takeover would fork it).
                raise
            except AuthenticationError:
                raise
            except DatabaseError as exc:
                # Transport failure after the member's own policy gave up:
                # mark it down and fail over to the ring's survivor.
                if self._router is None:
                    raise
                self._router.mark_down(self._client.address)
                self._shared["attached"] = False
                TELEMETRY.count("serve.client.failovers")
                log.warning(
                    "gateway %s unreachable for tenant %r (%s); failing "
                    "over", self._client.address, self._tenant, exc,
                )
                last_error = exc
                continue
        raise last_error

    def _ensure_attached(self):
        if not self._shared["attached"]:
            self._attach(replay=bool(self._shared["obs_log"]))

    def _attach(self, replay=False):
        payload = {
            "tenant": self._tenant,
            "algo": self._algo_config,
            "priors": self._priors,
            "seed": self._seed,
            "quotas": self._quotas,
        }
        if self._takeover:
            # The ring owner is marked down and this member is the
            # live-ring fallback: declare the off-ring attach explicitly,
            # or the member (which may still believe the owner alive)
            # would answer WrongGateway and the pair would bounce.
            payload["takeover"] = True
        result = self._client.request("attach", payload, mode=MODE_ALWAYS)
        self._shared["wants_register"] = bool(result.get("wants_register"))
        behind = int(result.get("n_observed", 0)) < self._logged_observations()
        if replay and (result.get("created") or behind):
            # The gateway-side tenant is missing history (fresh after a
            # restart/eviction, or a PREVIOUS replay died partway): replay
            # every logged batch in order.  Each entry keeps its original
            # minted id, so a batch the gateway DID see (persisted ahead
            # of the log, or applied by the partial replay) dedups instead
            # of double-observing — replaying the whole log is always
            # convergent.
            for entry in self._shared["obs_log"]:
                self._client.request(
                    entry["_op"],
                    {k: v for k, v in entry.items() if k != "_op"}
                    | {"tenant": self._tenant},
                    mode=MODE_ALWAYS,
                )
        # Only a COMPLETED attach+replay counts: marking earlier would let
        # a mid-replay failure strand the tenant on truncated history (the
        # next op would skip the replay it still needs).
        self._shared["attached"] = True

    def _logged_observations(self):
        """Rows the replay log would feed a fresh tenant — the client-side
        truth the attach reply's ``n_observed`` is compared against."""
        return sum(
            len(entry["params"])
            for entry in self._shared["obs_log"]
            if entry["_op"] == "observe"
        )

    # --- BaseAlgorithm surface ----------------------------------------------
    def suggest(self, num=1):
        payload = {
            "num": int(num),
            "req_id": f"{self._shared['uid']}:{self._next_seq()}",
        }
        if self._naive:
            payload["naive"] = True
            payload["epoch"] = self._naive_epoch
            payload["lies"] = self._lies
        result = self._rpc("suggest", payload, mode=MODE_ALWAYS)
        self._shared["health"] = result.get("health")
        if result.get("optout"):
            return None
        cube = result.get("cube")
        if cube is not None:
            # Decode client-side through the SAME Space codec a standalone
            # run uses — float32 rows round-trip JSON exactly, so params
            # are bit-identical to the standalone decode.
            return self._materialize_batch(
                np.asarray(cube, dtype=np.float32)
            ).params
        return result.get("params")

    def observe(self, params_list, results, cube=None):
        if not params_list:
            return
        if cube is None:
            cube = self.space.params_to_cube(params_list)
        cube_rows = np.asarray(cube, dtype=np.float32).tolist()
        objectives = [float(r["objective"]) for r in results]
        if self._naive:
            # Constant-liar fantasies: buffered on the clone and shipped
            # with its suggest requests; the real tenant never sees them.
            self._lies.append(
                {
                    "params": [dict(p) for p in params_list],
                    "objectives": objectives,
                    "cube": cube_rows,
                }
            )
            return
        entry = {
            "_op": "observe",
            "obs_id": f"{self._shared['uid']}:{self._next_seq()}",
            "params": [dict(p) for p in params_list],
            "objectives": objectives,
        }
        self._log_entry(entry)
        self._rpc(
            "observe",
            # The wire carries the producer's already-encoded cube rows;
            # the LOG does not — a replay omits them and the gateway
            # re-encodes through the same codec, bit-identically.
            {k: v for k, v in entry.items() if k != "_op"} | {"cube": cube_rows},
            mode=MODE_ALWAYS,
        )
        self._n_observed += len(params_list)

    def _log_entry(self, entry):
        obs_log = self._shared["obs_log"]
        if len(obs_log) == obs_log.maxlen and not self._shared["obs_log_truncated"]:
            self._shared["obs_log_truncated"] = True
            log.warning(
                "tenant %r replay log reached its %d-batch cap; recovery "
                "from an UNPERSISTED gateway loss would resume with the "
                "most recent batches only",
                self._tenant,
                obs_log.maxlen,
            )
        obs_log.append(entry)

    def register_suggestion(self, params):
        # Only forwarded for algorithms that actually override the hook
        # (the gateway reports that at attach): for the fused GP family it
        # is a no-op, and shipping q param dicts per round for a no-op
        # would tax the exact hot path the gateway exists to amortize.
        if self._naive or not self._shared["wants_register"]:
            return
        entry = {
            "_op": "register",
            "reg_id": f"{self._shared['uid']}:{self._next_seq()}",
            "params": [dict(params)],
        }
        self._log_entry(entry)
        self._rpc(
            "register",
            {k: v for k, v in entry.items() if k != "_op"},
            mode=MODE_ALWAYS,
        )

    def health_record(self):
        """The gateway-reported record from the last suggest reply: the
        tenant algorithm's own health fields plus the serve-layer ones
        (``serve_width``, ``serve_queue_depth``, ``serve_tenants``) — the
        channel that makes gateway rounds visible in ``orion-tpu-torch top`` and
        ``info`` without the gateway needing the experiment's storage."""
        health = self._shared.get("health")
        return dict(health) if health else None

    def placement(self):
        """The fleet-placement record (None in single-gateway mode): the
        gateway currently serving this tenant, the membership epoch, and
        the failover/adoption counters — the producer mirrors these into
        ``serve.client.*`` gauges so `orion-tpu-torch top` shows where each
        experiment's tenant lives."""
        if self._router is None:
            return None
        return {
            "gateway": self._shared.get("gateway"),
            "epoch": self._router.epoch,
            "members": len(self._router.addresses),
            "failovers": self._router.failovers,
            "adoptions": self._router.adoptions,
        }

    def detach(self):
        """Explicitly release the gateway-side tenant (tests/shutdown)."""
        if self._shared["attached"]:
            self._rpc("detach", {}, mode=MODE_ALWAYS)
            self._shared["attached"] = False


def parse_address(address):
    """``host[:port]`` -> (host, port); the gateway default port is 8777."""
    host, _, port = str(address).partition(":")
    return host or "127.0.0.1", int(port) if port else 8777


def connect_remote_algorithm(
    space, priors, algo_config, serve_config, tenant, seed=None
):
    """Build a :class:`RemoteAlgorithm` from a ``serve:`` config section
    ({"address": "host:port", "retry": {...}, "quotas": {...}, "timeout":
    s, "secret"/"secret_file": ...}) and attach it eagerly so a bad
    address (or refused credential) fails at instantiation, not
    mid-hunt.  The ORION_SERVE_SECRET / ORION_SERVE_SECRET_FILE env vars
    carry the secret when the config omits it.

    A multi-member ``addresses`` list (or the ORION_SERVE_ADDRESSES env,
    comma-separated) builds the FLEET path instead: a
    :class:`~orion_tpu_torch.serve.fleet.FleetRouter` with one client + one
    retry policy per member and consistent-hash tenant placement — the
    tenant attaches on its ring-designated gateway."""
    from orion_tpu_torch.storage.base import resolve_wire_secret

    addresses = parse_serve_addresses(serve_config)
    secret = resolve_wire_secret(
        serve_config, env_prefix="ORION_SERVE", what="serve gateway"
    )
    timeout = float(serve_config.get("timeout", 60.0))
    router = None
    if len(addresses) > 1:
        retry = serve_config.get("retry") or dict(FLEET_RETRY_DEFAULTS)

        def factory(address):
            host, port = parse_address(address)
            return GatewayClient(
                host=host, port=port, timeout=timeout, retry=dict(retry),
                secret=secret,
            )

        router = FleetRouter(addresses, factory)
        client = router.client(router.resolve(ring_key(tenant))[0])
    else:
        host, port = parse_address(addresses[0])
        client = GatewayClient(
            host=host,
            port=port,
            timeout=timeout,
            retry=serve_config.get("retry"),
            secret=secret,
        )
    algo = RemoteAlgorithm(
        space,
        priors,
        algo_config,
        client,
        tenant,
        seed=seed,
        quotas=serve_config.get("quotas"),
        router=router,
    )
    algo._ensure_attached()
    return algo
