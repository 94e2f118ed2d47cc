"""Sharded, replicated network storage: the scale-out control plane (port
of ``orion_tpu/storage/shard.py``: the same ring, routing, failover and
promotion, so a router of either package places every experiment on the
same shard).

One :class:`~orion_tpu_torch.storage.netdb.NetworkDB` talks to one server — the
last single point of failure in the stack.  :class:`ShardedNetworkDB` is
an AbstractDB-contract router over N independent netdb shards, slotting
UNDER :class:`~orion_tpu_torch.storage.base.DocumentStorage` exactly where a
single client would sit (Oríon's design keeps all coordination behind the
storage protocol, so nothing above this layer changes):

- **Consistent-hash routing on experiment id** (Dynamo-style ring with
  virtual nodes for balance): every document and query that names an
  experiment — trial registration, reservation CAS, status polls, the
  telemetry/health channels — routes to exactly one shard, so the hot
  paths cost what they cost today regardless of shard count.  Experiment
  ids are deterministic hashes of the experiment's unique identity
  (``core.experiment.experiment_id``; the router mints the same way for
  raw inserts that arrive without one), so two racing creators of the
  same experiment land on the SAME shard and collide on its unique
  index, exactly as they would on one server.
- **Cross-experiment fan-out**: ops that span experiments
  (``fetch_experiments``, fleet audits, id-only lookups that miss the
  owner cache) run on every shard CONCURRENTLY and merge.  A fan-out leg
  rides its shard's own :class:`~orion_tpu_torch.storage.retry.RetryPolicy`
  (reads only — mutations keep the op-level policy's applied-or-not
  discipline), so one slow or dead shard never serializes the rest.
- **Read-replica fan-out with staleness failover**: when a shard declares
  replicas, reads (``read``/``count`` and all-read batches — the
  ``fetch_trials``/status-poll/``fetch_health`` hot path) go to a replica
  round-robin.  Replication is asynchronous, so every replica reply
  carries the replica's applied sequence (``netdb.py``); the router
  compares it against the highest sequence ITS writes ever got from that
  shard's primary and fails the read over to the primary when the replica
  is behind — monotonic read-your-writes per router, counted as
  ``storage.shard.replica_stale_reads``.  Transport errors fail over too
  (``storage.shard.failovers``) and bench the replica briefly.
- **Degraded mode**: shards are independent connections with independent
  retry state, so ops routed to healthy shards proceed while ops on a
  dead shard ride the ordinary retry/deadline policy — no global stall.
  Aggregated fan-out failures propagate the STRICTEST ``maybe_applied``
  of their parts (:func:`merge_maybe_applied`).
- **Provable pass-through**: a single-shard, no-replica config delegates
  every op verbatim to the one underlying ``NetworkDB`` — no minting, no
  fan-out machinery, byte-identical wire traffic.

The placement collection's read side (``placement_doc_id``, fences) is
here; the day-2 tools that write it are ``storage/rebalance.py`` and
``storage/drain.py``, and the soak harness (``storage/soak.py``) drives
many simulated workers against a topology of real servers under
fault-proxy partitions and shard restarts: the pass bar is a clean
``orion-tpu-torch audit --all`` on every shard and zero lost observations.
"""

import functools
import hashlib
import logging
import threading
import weakref
from bisect import bisect_right
from collections import OrderedDict

from orion_tpu_torch.analysis.sanitizer import TSAN
from orion_tpu_torch.health import FLIGHT
from orion_tpu_torch.storage.netdb import NetworkDB
from orion_tpu_torch.storage.retry import MODE_ALWAYS, create_retry_policy, is_transient
from orion_tpu_torch.telemetry import TELEMETRY
from orion_tpu_torch.utils.exceptions import DatabaseError

log = logging.getLogger(__name__)

#: Virtual nodes per shard on the hash ring.  Enough that removing/adding
#: one shard moves ~1/N of the keyspace with low variance; small enough
#: that ring construction stays trivial.
DEFAULT_VNODES = 64

#: Bounded (collection, _id) -> shard map harvested from routed results, so
#: id-only queries (``set_trial_status``'s CAS, ``get_trial``) route
#: directly instead of fanning out.  A miss is never wrong — it just costs
#: a fan-out that re-populates the entry.
OWNER_CACHE_CAP = 65536

#: Per-shard policy for fan-out READ legs: tighter than the op-level
#: policy (which still wraps the whole op above this layer) — its job is
#: riding out a blip on ONE shard without re-running the healthy ones.
DEFAULT_SHARD_RETRY = {
    "max_attempts": 3,
    "base_delay": 0.02,
    "max_delay": 0.25,
    "deadline": 5.0,
}

#: Seconds a replica sits out after a transport failure before reads try
#: it again (connection state is per shard, per replica).
REPLICA_RETRY_S = 1.0

#: Timeout for election/health ``seq`` probes (dedicated short-lived
#: connections): a hung node must cost a probe this much, never the data
#: path's full client timeout.
PROBE_TIMEOUT_S = 2.0

#: Confirmation window before automatic replica promotion: a shard's
#: primary must fail CONTINUOUSLY for this long before a router runs an
#: election.  Long enough to ride out a same-port restart (a
#: restarting server is back well under a second); short enough that a dead
#: box heals inside one op-level retry deadline.
DEFAULT_PROMOTE_AFTER_S = 1.5

#: Confirmation window before automatic replica REPROVISIONING: a shard's
#: replica must fail probes continuously for this long before the router
#: provisions and adopts a replacement.  Longer than the promotion window
#: on purpose — a replica rebooting in place is cheaper than a fresh
#: snapshot resync, so reprovisioning waits out ordinary restarts.
DEFAULT_REPROVISION_AFTER_S = 5.0

#: Collection holding per-experiment placement override docs (live ring
#: rebalancing, storage/rebalance.py).  Routers consult it BEFORE the
#: ring; the docs live on the experiment's RING shard so any router can
#: find them without knowing the answer.
PLACEMENT_COLLECTION = "_placement"

#: Seconds a placement lookup (override or its absence) stays cached per
#: router.  Also the floor a migrator must hold an experiment FENCED
#: before flipping it: once every router's cache entry has expired, every
#: router re-reads the override and observes the fence.
PLACEMENT_TTL_S = 5.0

#: Bounded placement cache (same rationale as the owner cache).
PLACEMENT_CACHE_CAP = 65536


def placement_doc_id(experiment_id):
    """``_placement`` doc id for one experiment's override."""
    return f"placement:{experiment_id}"


@functools.lru_cache(maxsize=512)
def _lag_gauge_name(index):
    """Per-shard gauge names, interned once per index (no
    per-iteration key building on the probe loop)."""
    return f"netdb.replication.lag.s{index}"


@functools.lru_cache(maxsize=512)
def _epoch_gauge_name(index):
    return f"netdb.replication.epoch.s{index}"


#: Routers registered for replication-lag sampling (the /metrics plane
#: scrape hook calls :func:`sample_replication_lag`).
_ROUTER_REGISTRY = weakref.WeakSet()
_SAMPLE_GATE_LOCK = threading.Lock()
_last_lag_sample = 0.0

#: Seconds between /metrics-driven replication probes (each probe is one
#: tiny ``seq`` request per node — cheap, but a hot scrape loop must not
#: turn it into load).
LAG_SAMPLE_INTERVAL_S = 5.0


def sample_replication_lag(force=False):
    """Publish ``netdb.replication.lag.s{i}`` / ``.epoch.s{i}`` gauges for
    every live router (rate-limited).  Called from the /metrics scrape
    path; never raises — metrics must not break serving."""
    global _last_lag_sample
    import time as _time

    now = _time.monotonic()
    with _SAMPLE_GATE_LOCK:
        if not force and now - _last_lag_sample < LAG_SAMPLE_INTERVAL_S:
            return
        _last_lag_sample = now
    for router in list(_ROUTER_REGISTRY):
        try:
            router.replication_health()
        except Exception:  # pragma: no cover - observability never raises
            log.debug("replication lag sample failed", exc_info=True)


def merge_maybe_applied(errors):
    """The STRICTEST applied-or-not verdict of a fan-out's parts: if ANY
    leg may have applied, the aggregate may have applied — anything weaker
    would let the retry policy blind-resend a non-converging mutation one
    shard already executed."""
    return any(getattr(error, "maybe_applied", False) for error in errors)


def shard_fanout_error(message, errors):
    """The one blessed way to aggregate per-shard ``DatabaseError``s:
    build the summary error and stamp the merged verdict."""
    parts = "; ".join(f"{type(e).__name__}: {e}" for e in errors) or "no detail"
    error = DatabaseError(f"{message}: {parts}")
    error.maybe_applied = merge_maybe_applied(errors)
    return error


def mint_experiment_id(doc):
    """Deterministic experiment id from the unique identity the
    experiments collection enforces — ``(name, version, metadata.user)``
    — computed by THE framework formula (``core.experiment
    .experiment_id``), not a lookalike: an experiment created through the
    ``build_experiment`` (which pre-sets ``_id`` with that formula) and a raw
    ``create_experiment`` for the same identity must mint the SAME id,
    land on the SAME shard, and collide on its unique index exactly as on
    one server.  A divergent formula would silently split one experiment
    across two shards."""
    from orion_tpu_torch.core.experiment import experiment_id

    return experiment_id(
        doc.get("name"),
        doc.get("version", 1),
        (doc.get("metadata") or {}).get("user"),
    )


class HashRing:
    """Consistent-hash ring with virtual nodes.

    Each shard contributes ``vnodes`` md5 points keyed by its stable
    identity (the primary's ``host:port``); a key hashes once and lands on
    the first point clockwise.  Every router instance built from the same
    shard list computes identical placement — there is no coordination
    channel, the ring IS the agreement.
    """

    def __init__(self, identities, vnodes=DEFAULT_VNODES):
        if not identities:
            raise DatabaseError("a hash ring needs at least one shard")
        self.vnodes = int(vnodes)
        points = []
        for index, identity in enumerate(identities):
            for v in range(self.vnodes):
                points.append((self._hash(f"{identity}#{v}"), index))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._indices = [i for _, i in points]

    @staticmethod
    def _hash(key):
        return int.from_bytes(
            hashlib.md5(str(key).encode("utf-8")).digest()[:8], "big"
        )

    def lookup(self, key):
        """Shard index owning ``key``."""
        position = bisect_right(self._hashes, self._hash(key))
        if position == len(self._hashes):
            position = 0
        return self._indices[position]


def parse_shard_specs(shards, default_secret=None):
    """Normalize a ``storage.shards`` config list into
    ``[{"host", "port", "replicas": [(host, port), ...]}, ...]``.  Entries
    may be ``"host:port"`` strings or dicts with ``host``/``port`` or
    ``address`` plus an optional ``replicas`` list of the same shapes."""

    def addr_of(entry):
        if isinstance(entry, str):
            host, _, port = entry.rpartition(":")
            if not host or not port:
                raise DatabaseError(
                    f"bad shard address {entry!r}; expected host:port"
                )
            return host, int(port)
        if isinstance(entry, (tuple, list)):
            host, port = entry
            return host, int(port)
        host = entry.get("host", "127.0.0.1")
        port = entry.get("port")
        address = entry.get("address")
        if address:
            return addr_of(str(address))
        if port is None:
            raise DatabaseError(f"shard entry {entry!r} needs a port or address")
        return host, int(port)

    specs = []
    for entry in shards or ():
        host, port = addr_of(entry)
        replicas = []
        if isinstance(entry, dict):
            replicas = [addr_of(r) for r in entry.get("replicas") or ()]
        specs.append(
            {
                "host": host,
                "port": port,
                "replicas": replicas,
                "secret": (
                    entry.get("secret", default_secret)
                    if isinstance(entry, dict)
                    else default_secret
                ),
            }
        )
    if not specs:
        raise DatabaseError("storage.shards is empty")
    return specs


class _Shard:
    """One shard's connections + read-path state: the primary client, its
    replica clients, the write-sequence floor replica reads are checked
    against, and the per-shard fan-out retry policy."""

    def __init__(self, index, spec, client_kwargs, policy):
        self.index = index
        self.host = spec["host"]
        self.port = int(spec["port"])
        self.primary = NetworkDB(host=self.host, port=self.port, **client_kwargs)
        self.replicas = [
            NetworkDB(host=h, port=p, **client_kwargs)
            for h, p in spec.get("replicas") or ()
        ]
        #: The replica addresses this shard was CONFIGURED with (identity
        #: comparison for live topology swaps — the live ``replicas`` list
        #: reorders on promotion).
        self.replica_addrs = frozenset(
            f"{h}:{int(p)}" for h, p in spec.get("replicas") or ()
        )
        self.policy = policy
        self._lock = threading.Lock()
        self._write_floor = 0
        self._rr = 0
        self._down_until = [0.0] * len(self.replicas)
        #: Read-path health counters, exported per shard as
        #: ``storage.shard.s{i}.failovers`` / ``.replica_stale_reads``.
        self.failovers = 0
        self.replica_stale_reads = 0
        #: Promotion state: the highest replication epoch this router ever
        #: saw from this shard (the fencing floor), the monotonic start of
        #: the current consecutive primary-failure streak, and a guard so
        #: one thread per router runs an election at a time.
        self._epoch = 0
        self._fail_since = None
        self._promote_guard = threading.Lock()
        self.promotions = 0

    @property
    def identity(self):
        """The shard's STABLE ring identity: the address of its original
        primary.  Never changes on promotion — the ring (and therefore
        experiment placement) must not move because a replica took over."""
        return f"{self.host}:{self.port}"

    @property
    def reconnects(self):
        return self.primary.reconnects + sum(r.reconnects for r in self.replicas)

    def note_write(self, client=None):
        """Raise the staleness floor to the primary's latest stamped seq
        (replicating primaries stamp mutating replies; plain ones never do,
        and the floor stays 0 = every replica read is acceptable), and the
        epoch floor to its stamped epoch.  Returns True when the reply came
        from a LOWER epoch than this router has already seen on the shard —
        a stale primary the caller must fence (the write landed on a
        condemned fork that the promoted timeline will erase).
        ``client`` pins the stamp to the connection the mutation actually
        rode: a concurrent promotion may swap ``self.primary`` between the
        call and this check, and the swapped-in client's stamp would miss
        exactly the stale-epoch reply the fence exists to catch."""
        seq, epoch = (client or self.primary).stamp_snapshot()
        stale = False
        with self._lock:
            TSAN.write("ShardedNetworkDB._shard_state", self)
            if epoch is not None:
                if epoch < self._epoch:
                    stale = True
                elif epoch > self._epoch:
                    self._epoch = epoch
            if not stale and seq is not None and seq > self._write_floor:
                self._write_floor = seq
        return stale

    def note_epoch(self, epoch):
        """Lift the epoch floor (a not-primary refusal or probe reported a
        newer epoch than any stamped reply so far)."""
        if not epoch:
            return
        with self._lock:
            TSAN.write("ShardedNetworkDB._shard_state", self)
            if epoch > self._epoch:
                self._epoch = epoch

    def epoch_floor(self):
        with self._lock:
            TSAN.write("ShardedNetworkDB._shard_state", self)
            return self._epoch

    # --- primary failure detection / promotion ------------------------------
    def note_primary_failure(self, now):
        """Mark one failed primary op; the streak starts at the FIRST
        consecutive failure and clears on any success."""
        with self._lock:
            TSAN.write("ShardedNetworkDB._shard_state", self)
            if self._fail_since is None:
                self._fail_since = now

    def clear_primary_failure(self):
        with self._lock:
            TSAN.write("ShardedNetworkDB._shard_state", self)
            self._fail_since = None

    def failing_for(self, now):
        """Seconds the primary has been failing continuously (0 if healthy)."""
        with self._lock:
            TSAN.write("ShardedNetworkDB._shard_state", self)
            return 0.0 if self._fail_since is None else now - self._fail_since

    def promote_swap(self, replica_index, epoch, now):
        """Swap the shard's primary client for the promoted replica's; the
        old primary client takes the replica's slot (briefly benched — when
        the dead box is reborn it comes back demoted, a legitimate read
        replica).  The shard's ring identity does NOT change."""
        with self._lock:
            TSAN.write("ShardedNetworkDB._shard_state", self)
            winner = self.replicas[replica_index]
            self.replicas[replica_index] = self.primary
            self.primary = winner
            self._down_until[replica_index] = now + REPLICA_RETRY_S
            if epoch > self._epoch:
                self._epoch = epoch
            self._fail_since = None
            self.promotions += 1
        return winner

    def promote_in_place(self, epoch):
        """The primary-slot client itself won the election (a promoted
        node that restarted back into its configured replica role): no
        swap, just the epoch/streak/counter bookkeeping."""
        with self._lock:
            TSAN.write("ShardedNetworkDB._shard_state", self)
            if epoch > self._epoch:
                self._epoch = epoch
            self._fail_since = None
            self.promotions += 1

    def write_floor(self):
        with self._lock:
            TSAN.write("ShardedNetworkDB._shard_state", self)
            return self._write_floor

    def pick_replica(self, now):
        """Round-robin replica index skipping benched ones, or None."""
        if not self.replicas:
            return None
        with self._lock:
            TSAN.write("ShardedNetworkDB._shard_state", self)
            n = len(self.replicas)
            for offset in range(n):
                candidate = (self._rr + offset) % n
                if self._down_until[candidate] <= now:
                    self._rr = (candidate + 1) % n
                    return candidate
        return None

    def bench_replica(self, index, now):
        with self._lock:
            TSAN.write("ShardedNetworkDB._shard_state", self)
            self._down_until[index] = now + REPLICA_RETRY_S
            self.failovers += 1

    def note_stale(self):
        with self._lock:
            TSAN.write("ShardedNetworkDB._shard_state", self)
            self.replica_stale_reads += 1

    def adopt_replacement(self, replica_index, client, dead_addr, now):
        """Swap a dead replica's client for a freshly provisioned one
        (auto-reprovisioning).  The replacement is benched briefly — it
        starts empty and must snapshot-resync before serving reads — and
        the declared ``replica_addrs`` identity follows the swap, so a
        later ``set_topology`` matching on it compares against the set
        this shard ACTUALLY runs.  Returns the replaced client (closed by
        the caller, outside this lock)."""
        addr = f"{client.host}:{client.port}"
        with self._lock:
            TSAN.write("ShardedNetworkDB._shard_state", self)
            old = self.replicas[replica_index]
            self.replicas[replica_index] = client
            self._down_until[replica_index] = now + REPLICA_RETRY_S
            self.replica_addrs = frozenset(
                (self.replica_addrs - {dead_addr}) | {addr}
            )
        return old

    def close(self):
        self.primary.close()
        for replica in self.replicas:
            replica.close()


#: Query/doc values that can route: concrete scalars, never operator dicts.
def _concrete(value):
    if value is None or isinstance(value, (dict, list, tuple)):
        return None
    return value


class ShardedNetworkDB:
    """AbstractDB-contract consistent-hash router over N netdb shards.

    See the module docstring for the full contract.  Constructed by
    ``create_storage`` from a ``storage.shards`` config stanza; sits under
    ``DocumentStorage`` exactly like a single ``NetworkDB``.
    """

    #: Counts and targeted reads are one small request on one shard.
    cheap_counts = True

    def __init__(
        self,
        shards,
        vnodes=DEFAULT_VNODES,
        timeout=60.0,
        idle_probe=1.0,
        secret=None,
        reconnect_jitter=0.1,
        shard_retry=None,
        replica_reads=True,
        auto_promote=True,
        promote_after=DEFAULT_PROMOTE_AFTER_S,
        placement_ttl=PLACEMENT_TTL_S,
        replica_provisioner=None,
        reprovision_after=DEFAULT_REPROVISION_AFTER_S,
    ):
        specs = parse_shard_specs(shards, default_secret=secret)
        self._client_base = {
            "timeout": timeout,
            "idle_probe": idle_probe,
            "reconnect_jitter": reconnect_jitter,
        }
        self._default_secret = secret
        self._retry_config = (
            dict(DEFAULT_SHARD_RETRY) if shard_retry is None else shard_retry
        )
        #: Automatic replica promotion: after ``promote_after`` seconds of
        #: continuous primary failure, elect the most-caught-up replica
        #: (deterministic: highest seq, address tie-break — concurrent
        #: routers converge on the SAME winner).
        self.auto_promote = bool(auto_promote)
        self.promote_after = float(promote_after)
        #: Placement-override lookup cache TTL (0 disables overrides —
        #: single-topology deployments that never rebalance).
        self.placement_ttl = float(placement_ttl)
        self._topology_lock = threading.Lock()
        self._shards = [
            # Each shard gets its OWN policy instance: independent jitter
            # streams and deadlines, so one shard's outage never consumes
            # another's retry budget.
            _Shard(
                index,
                spec,
                dict(self._client_base, secret=spec.get("secret")),
                create_retry_policy(self._retry_config),
            )
            for index, spec in enumerate(specs)
        ]
        self._ring = HashRing([s.identity for s in self._shards], vnodes=vnodes)
        self._identity_index = {s.identity: s.index for s in self._shards}
        self.replica_reads = bool(replica_reads)
        #: Pure pass-through mode: one shard, no replicas — every op
        #: delegates verbatim to the single NetworkDB (bit-identical wire
        #: traffic; differential-pinned).
        self._passthrough = (
            len(self._shards) == 1 and not self._shards[0].replicas
        )
        self._owner_lock = threading.Lock()
        self._owners = OrderedDict()  # (collection, _id) -> shard index
        self._placement_lock = threading.Lock()
        #: experiment key -> (shard identity or None, state, expires_at).
        self._placements = OrderedDict()
        self._stats_lock = threading.Lock()
        self.fan_outs = 0
        self._monotonic = None  # injectable clock for tests
        #: Replica auto-reprovisioning (day-2 operations): with a
        #: ``replica_provisioner`` callable — ``provisioner(shard_index) ->
        #: "host:port"`` of a freshly started empty server — a background
        #: sweep detects a replica that has failed probes continuously for
        #: ``reprovision_after`` seconds on a PROMOTED shard (the
        #: one-replica-short-forever state a permanent primary loss leaves
        #: behind), provisions a replacement, has the current primary adopt
        #: it over the ``adopt_replica`` wire op (bounded snapshot resync),
        #: and swaps the dead client out of the shard's replica set.
        self.replica_provisioner = replica_provisioner
        self.reprovision_after = float(reprovision_after)
        self.reprovisions = 0
        self._reprovision_lock = threading.Lock()
        #: (shard identity, replica address) -> monotonic first-failure
        #: time; shared between the sweep thread and close() — every
        #: access under _reprovision_lock.
        self._replica_down_since = {}
        self._reprovision_stop = threading.Event()
        self._reprovision_thread = None
        self._register_shard_counters()
        _ROUTER_REGISTRY.add(self)
        if replica_provisioner is not None:
            self._reprovision_thread = threading.Thread(
                target=self._reprovision_loop,
                name="shard-reprovision",
                daemon=True,
            )
            self._reprovision_thread.start()

    _SHARD_COUNTER_ATTRS = (
        "reconnects", "failovers", "replica_stale_reads", "promotions",
    )

    def _register_shard_counters(self):
        for shard in self._shards:
            prefix = f"storage.shard.s{shard.index}"
            for attr in self._SHARD_COUNTER_ATTRS:
                TELEMETRY.register_external_counter(
                    f"{prefix}.{attr}", shard, attr
                )

    def _unregister_shard_counters(self, shards):
        """Drop ``shards``' registrations at their CURRENT indices — run
        before a topology change reindexes/removes them, or a surviving
        shard would keep exporting under its old ``s{i}`` name too."""
        for shard in shards:
            prefix = f"storage.shard.s{shard.index}"
            for attr in self._SHARD_COUNTER_ATTRS:
                TELEMETRY.unregister_external_counter(
                    f"{prefix}.{attr}", shard
                )

    # --- aggregate counters (DocumentStorage re-exports these) ---------------
    @property
    def reconnects(self):
        return sum(s.reconnects for s in self._shards)

    @property
    def round_trips(self):
        return sum(
            s.primary.round_trips + sum(r.round_trips for r in s.replicas)
            for s in self._shards
        )

    @property
    def wire_requests(self):
        return sum(
            s.primary.wire_requests + sum(r.wire_requests for r in s.replicas)
            for s in self._shards
        )

    @property
    def failovers(self):
        return sum(s.failovers for s in self._shards)

    @property
    def replica_stale_reads(self):
        return sum(s.replica_stale_reads for s in self._shards)

    @property
    def promotions(self):
        return sum(s.promotions for s in self._shards)

    # --- topology surface (CLI: db ring, audit, info) ------------------------
    @property
    def n_shards(self):
        return len(self._shards)

    def shard_for(self, experiment_id):
        """Ring placement of an experiment id (audit/CLI surface)."""
        return self._ring.lookup(str(experiment_id))

    def describe_topology(self):
        return {
            "shards": [
                {
                    "index": s.index,
                    "address": s.identity,
                    "replicas": [f"{r.host}:{r.port}" for r in s.replicas],
                    "primary": f"{s.primary.host}:{s.primary.port}",
                    "epoch": s.epoch_floor(),
                    "promotions": s.promotions,
                }
                for s in self._shards
            ],
            "vnodes": self._ring.vnodes,
            "replica_reads": self.replica_reads,
        }

    def replication_health(self):
        """Probe every shard node's ``seq`` op: per-shard epoch, primary
        position, per-replica applied position and lag (primary − replica).
        Publishes the ``netdb.replication.lag.s{i}`` / ``.epoch.s{i}``
        gauges the /metrics plane exports; ``info --all``, ``db status``
        and ``db ring`` render the same structure in their topology
        headers.  Probes are tiny one-line requests, run CONCURRENTLY per
        shard (a dark, partitioned shard costs the whole view one
        PROBE_TIMEOUT_S, never a stall per node); a dead node reports an
        ``error`` instead of failing the whole view."""
        shards = list(self._shards)
        health = [None] * len(shards)

        def probe_shard(slot, shard):
            entry = {
                "index": shard.index,
                "address": shard.identity,
                "primary": f"{shard.primary.host}:{shard.primary.port}",
                "replicas": [],
            }
            primary_seq = None
            try:
                info = self._probe_seq(shard.primary)
            except Exception as exc:
                entry["error"] = f"{type(exc).__name__}: {exc}"
            else:
                primary_seq = int(info.get("seq", 0))
                entry["seq"] = primary_seq
                entry["epoch"] = int(info.get("epoch", 0) or 0)
                entry["role"] = "replica" if info.get("replica") else "primary"
                entry["quorum"] = int(info.get("quorum", 0) or 0)
                shard.note_epoch(entry["epoch"])
            lags = []
            for replica in shard.replicas:
                row = {"address": f"{replica.host}:{replica.port}"}
                try:
                    info = self._probe_seq(replica)
                except Exception as exc:
                    row["error"] = f"{type(exc).__name__}: {exc}"
                else:
                    row["seq"] = int(info.get("seq", 0))
                    row["epoch"] = int(info.get("epoch", 0) or 0)
                    if info.get("resyncing"):
                        row["resyncing"] = True
                    if primary_seq is not None:
                        row["lag"] = max(0, primary_seq - row["seq"])
                        lags.append(row["lag"])
                entry["replicas"].append(row)
            entry["max_lag"] = max(lags) if lags else None
            health[slot] = entry

        if len(shards) == 1:
            probe_shard(0, shards[0])
        else:
            threads = [
                threading.Thread(
                    target=probe_shard, args=(slot, shard), daemon=True
                )
                for slot, shard in enumerate(shards)
            ]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join()
        if TELEMETRY.enabled:
            for entry, shard in zip(health, shards):
                # Interned per-index names (lru_cache): no per-iteration
                # key building, same discipline as devmem's bucket gauges.
                lag_name = _lag_gauge_name(shard.index)
                epoch_name = _epoch_gauge_name(shard.index)
                if entry["max_lag"] is not None:
                    TELEMETRY.set_gauge(lag_name, entry["max_lag"])
                if entry.get("epoch") is not None:
                    TELEMETRY.set_gauge(epoch_name, entry.get("epoch", 0))
        return health

    def shard_connections(self):
        """``[(index, primary NetworkDB), ...]`` — the per-shard direct
        surface the soak/audit tooling uses to verify every shard alone."""
        return [(s.index, s.primary) for s in self._shards]

    def set_topology(self, shards, vnodes=None):
        """Rebuild the ring and shard set IN PLACE for a new topology —
        the router half of live rebalancing (``orion-tpu-torch db rebalance``).

        Shards whose identity (original primary ``host:port``) AND replica
        set survive keep their connections, counters, epoch floors and
        failure state; new shards connect fresh; removed (or reshaped)
        shards close.  The owner and placement caches reset — both may
        point across the topology change.  Ops in flight on a removed
        shard fail transiently and re-route through the new ring on their
        op-level retry."""
        specs = parse_shard_specs(shards, default_secret=self._default_secret)
        with self._topology_lock:
            # Old-name registrations go first: a surviving shard may land
            # on a NEW index and must not keep exporting under the old one.
            self._unregister_shard_counters(self._shards)
            old = {s.identity: s for s in self._shards}
            rebuilt = []
            for index, spec in enumerate(specs):
                identity = f"{spec['host']}:{int(spec['port'])}"
                survivor = old.get(identity)
                replica_addrs = frozenset(
                    f"{h}:{int(p)}" for h, p in spec.get("replicas") or ()
                )
                if survivor is not None and survivor.replica_addrs == replica_addrs:
                    del old[identity]
                    survivor.index = index
                    rebuilt.append(survivor)
                else:
                    rebuilt.append(
                        _Shard(
                            index,
                            spec,
                            dict(self._client_base, secret=spec.get("secret")),
                            create_retry_policy(self._retry_config),
                        )
                    )
            self._shards = rebuilt
            self._ring = HashRing(
                [s.identity for s in rebuilt],
                vnodes=self._ring.vnodes if vnodes is None else vnodes,
            )
            self._identity_index = {s.identity: s.index for s in rebuilt}
            self._passthrough = len(rebuilt) == 1 and not rebuilt[0].replicas
            with self._owner_lock:
                TSAN.write("ShardedNetworkDB._owners", self)
                self._owners.clear()
            with self._placement_lock:
                TSAN.write("ShardedNetworkDB._placements", self)
                self._placements.clear()
            self._register_shard_counters()
        for shard in old.values():
            shard.close()

    def close(self):
        _ROUTER_REGISTRY.discard(self)
        self._reprovision_stop.set()
        if self._reprovision_thread is not None:
            self._reprovision_thread.join(timeout=2.0)
        for shard in self._shards:
            shard.close()

    # --- routing core --------------------------------------------------------
    def _now(self):
        if self._monotonic is not None:
            return self._monotonic()
        import time

        return time.monotonic()

    def _route(self, collection, doc=None, query=None):
        """Shard index for a doc/query, or None (fan out).  Experiments
        route by their own ``_id``; everything else routes by the
        ``experiment`` field, falling back to the owner cache for id-only
        queries and to the id's own ring point for id-carrying docs.
        Experiment-keyed routes consult the per-experiment placement
        override (live rebalancing) before the ring."""
        if collection == "experiments":
            key = None
            if query is not None:
                key = _concrete(query.get("_id"))
            if key is None and doc is not None:
                key = _concrete(doc.get("_id"))
            return None if key is None else self._placed_index(str(key))
        exp = None
        if query is not None:
            exp = _concrete(query.get("experiment"))
        if exp is None and doc is not None:
            exp = _concrete(doc.get("experiment"))
        if exp is not None:
            return self._placed_index(str(exp))
        if doc is not None:
            _id = _concrete(doc.get("_id"))
            if _id is not None:
                return self._ring.lookup(str(_id))
        if query is not None:
            _id = _concrete(query.get("_id"))
            if _id is not None:
                return self._owner_of(collection, _id)
        return None

    def _shard_at(self, index):
        """Indexed shard access that tolerates a concurrent
        :meth:`set_topology`: the ring and the shard list are swapped in
        two assignments, so an op that routed against the OLD ring may
        briefly hold an index past the NEW list.  Surface it as the
        transient it is — the op-level retry re-routes through the new
        ring — instead of an IndexError no retry policy classifies."""
        shards = self._shards
        if index >= len(shards):
            error = DatabaseError(
                f"shard index {index} routed against a topology of "
                f"{len(shards)} shard(s) — the ring changed mid-route; "
                "retrying re-routes"
            )
            error.maybe_applied = merge_maybe_applied(())
            raise error
        return shards[index]

    # --- placement overrides (live rebalancing) ------------------------------
    def _placed_index(self, key):
        """Ring placement with the per-experiment override consulted first.

        The override doc lives on the experiment's RING shard (the one
        place any router can find without knowing the answer); a cached
        lookup costs a dict read, a miss costs one tiny primary read that
        is then cached for :attr:`placement_ttl` seconds.  A FENCED
        experiment (mid-flip migration window) raises a transient error —
        the op-level retry re-routes after the flip."""
        ring_index = self._ring.lookup(key)
        if self.placement_ttl <= 0 or self._passthrough:
            return ring_index
        entry = self._placement_cached(key)
        if entry is None:
            entry = self._placement_read(key, ring_index)
        identity, state = entry
        if state == "fenced":
            error = DatabaseError(
                f"experiment {key} is fenced mid-migration "
                "(placement flip in progress); the op will re-route on retry"
            )
            # Pre-flight refusal: the op never ran anywhere.
            error.maybe_applied = merge_maybe_applied(())
            raise error
        if identity is None:
            return ring_index
        index = self._identity_index.get(identity)
        if index is None:
            # The override names a shard this topology doesn't carry —
            # a half-rolled-out topology change.  The ring is the best
            # remaining answer; say so once per TTL (the cache holds it).
            log.warning(
                "placement override for %s names unknown shard %s; "
                "falling back to the ring", key, identity,
            )
            return ring_index
        return index

    def _placement_cached(self, key):
        now = self._now()
        with self._placement_lock:
            TSAN.write("ShardedNetworkDB._placements", self)
            entry = self._placements.get(key)
            if entry is None or entry[2] <= now:
                return None
            return entry[0], entry[1]

    def _placement_read(self, key, ring_index):
        try:
            docs = self._shard_at(ring_index).primary.read(
                PLACEMENT_COLLECTION, {"_id": placement_doc_id(key)}
            )
        except Exception:
            # The ring shard is unreachable: route by the ring — the op
            # itself will surface (and retry) the outage through its own
            # path; a placement probe must not add a second failure mode.
            return None, None
        doc = docs[0] if docs else None
        identity = doc.get("shard") if doc else None
        state = doc.get("state") if doc else None
        if state == "fenced":
            # Never cached: re-read until the migrator flips it.
            return identity, state
        with self._placement_lock:
            TSAN.write("ShardedNetworkDB._placements", self)
            placements = self._placements
            placements[key] = (identity, state, self._now() + self.placement_ttl)
            placements.move_to_end(key)
            while len(placements) > PLACEMENT_CACHE_CAP:
                placements.popitem(last=False)
        return identity, state

    def _invalidate_placement(self, collection, query):
        """Drop the placement cache entry behind an empty ROUTED answer —
        but only when an override (not the ring) routed it: a router whose
        cache still points at a migrated-away source would otherwise keep
        reading deleted ground until the TTL expired.  Ring-routed empties
        (a fresh experiment with no trials yet) invalidate nothing, so the
        hot status-poll path never pays an extra probe."""
        key = None
        if query is not None:
            if collection == "experiments":
                key = _concrete(query.get("_id"))
            else:
                key = _concrete(query.get("experiment"))
        if key is None:
            return
        with self._placement_lock:
            TSAN.write("ShardedNetworkDB._placements", self)
            entry = self._placements.get(str(key))
            if entry is not None and entry[0] is not None:
                del self._placements[str(key)]

    def _owner_of(self, collection, _id):
        with self._owner_lock:
            TSAN.write("ShardedNetworkDB._owners", self)
            return self._owners.get((collection, _id))

    def _remember_owner(self, collection, _id, index):
        if _id is None:
            return
        with self._owner_lock:
            TSAN.write("ShardedNetworkDB._owners", self)
            owners = self._owners
            owners[(collection, _id)] = index
            owners.move_to_end((collection, _id))
            while len(owners) > OWNER_CACHE_CAP:
                owners.popitem(last=False)

    def _harvest_owners(self, collection, docs, index):
        """Remember the shard of every id-bearing doc a routed/fanned read
        returned, so later id-only CAS ops route directly."""
        for doc in docs or ():
            if isinstance(doc, dict):
                self._remember_owner(collection, doc.get("_id"), index)

    # --- fan-out machinery ---------------------------------------------------
    def _collect_shards(self, fn, read_only=False, op="fan_out"):
        """Run ``fn(shard)`` on every shard CONCURRENTLY; returns
        ``(results, errors)`` as per-shard lists (exactly one of the pair
        is non-None per slot).  Read legs ride the shard's own policy so a
        blip on one shard heals locally; mutation legs run bare — the
        op-level policy above owns their applied-or-not discipline."""
        shards = self._shards
        with self._stats_lock:
            TSAN.write("ShardedNetworkDB._stats", self)
            self.fan_outs += 1
        TELEMETRY.count("storage.shard.fan_outs")
        results = [None] * len(shards)
        errors = [None] * len(shards)

        def leg(i, shard):
            try:
                if read_only and shard.policy is not None:
                    results[i] = shard.policy.run(
                        lambda: fn(shard), op=f"shard.s{i}.{op}", mode=MODE_ALWAYS
                    )
                else:
                    results[i] = fn(shard)
            except Exception as exc:
                errors[i] = exc

        if len(shards) == 1:
            leg(0, shards[0])
        else:
            threads = [
                threading.Thread(target=leg, args=(i, shard), daemon=True)
                for i, shard in enumerate(shards)
            ]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join()
        return results, errors

    def _each_shard(self, fn, read_only=False, op="fan_out"):
        """Fan out and REQUIRE every shard: aggregated failures raise with
        the strictest ``maybe_applied`` of the parts."""
        results, errors = self._collect_shards(fn, read_only=read_only, op=op)
        failed = [e for e in errors if e is not None]
        if failed:
            raise shard_fanout_error(
                f"{op} failed on {len(failed)}/{len(self._shards)} shard(s)",
                failed,
            )
        return results

    # --- replica read path ---------------------------------------------------
    def _shard_read(self, shard, op, *args, **kwargs):
        """One read on one shard: replica round-robin with staleness check,
        failover to the primary on transport error or lag."""
        if self.replica_reads and shard.replicas:
            now = self._now()
            index = shard.pick_replica(now)
            if index is not None:
                replica = shard.replicas[index]
                try:
                    result = getattr(replica, op)(*args, **kwargs)
                except Exception as exc:
                    if not is_transient(exc):
                        raise
                    # Dead/partitioned replica: bench it briefly and take
                    # the primary — a failover, the first-class signal a
                    # flapping replica tier emits.
                    shard.bench_replica(index, now)
                    TELEMETRY.count("storage.shard.failovers")
                else:
                    stamp = replica.seq_snapshot()
                    floor = shard.write_floor()
                    if not floor or (stamp is not None and stamp >= floor):
                        return result
                    # The replica answered from BEFORE this router's last
                    # acknowledged write on the shard (the stamp check is
                    # per connection, so a concurrent reader can only make
                    # it stricter-to-pass, never falsely fresh for the
                    # floor it read).  Re-read from the primary.
                    shard.note_stale()
                    TELEMETRY.count("storage.shard.replica_stale_reads")
        try:
            # Reads never CLEAR the failure streak: a demoted node serves
            # reads happily while refusing every mutation — read successes
            # resetting the streak would starve the re-election the
            # refusals are feeding.
            return getattr(shard.primary, op)(*args, **kwargs)
        except Exception as exc:
            self._note_primary_error(shard, exc)
            raise

    def _shard_mutate(self, shard, op, *args, **kwargs):
        """One mutation on one shard's PRIMARY; lifts the staleness floor
        from the stamped reply.  Failures feed the promotion detector;
        a reply stamped with a LOWER epoch than this router has seen is
        FENCED — refused after the fact, because it landed on a stale
        primary whose fork the promoted timeline will erase."""
        # Capture the client once: a concurrent promotion may swap
        # shard.primary mid-call, and the fence below must stamp-check the
        # connection this op actually rode.
        primary = shard.primary
        try:
            result = getattr(primary, op)(*args, **kwargs)
        except Exception as exc:
            self._note_primary_error(shard, exc)
            raise
        # Fence BEFORE clearing the failure streak: a wire-successful write
        # answered from a stale epoch is a FAILURE of the shard (it landed
        # on a condemned fork), and repeated fenced writes must accumulate
        # the same streak dead sockets do — that streak is the only road
        # back to an election when a stale claimant is the one answering.
        self._fence_stale_write(shard, primary, op)
        shard.clear_primary_failure()
        return result

    def _fence_stale_write(self, shard, primary, op):
        """Raise when the mutating reply on ``primary`` carried a LOWER
        epoch than this router has seen on the shard."""
        if not shard.note_write(primary):
            return
        shard.note_primary_failure(self._now())
        TELEMETRY.count("storage.shard.fenced_writes")
        error = DatabaseError(
            f"shard {shard.index} answered {op!r} from a stale epoch "
            f"(below {shard.epoch_floor()}): the write landed on a "
            "demoting primary and will not survive its resync — "
            "retrying against the promoted primary"
        )
        # The stale primary DID apply it, but that application is a
        # condemned fork the next resync erases: in the surviving
        # timeline nothing was applied, so the op-level retry must
        # re-run it (maybe_applied=True would make non-converging ops
        # give up and lose the write for real).
        error.maybe_applied = merge_maybe_applied(())
        self._refresh_shard_primary(shard)
        raise error

    def _note_primary_error(self, shard, exc):
        """Feed one failed primary op into the promotion detector."""
        now = self._now()
        if getattr(exc, "not_primary", False):
            # The node we call primary answered as a REPLICA.  Usually a
            # concurrent router promoted — adopt its winner.  But when
            # NOBODY claims primary (the promoted node itself restarted
            # back into its configured replica role), adoption finds
            # nothing — so the refusals feed the same confirmation window
            # and a real election re-promotes the caught-up node IN PLACE.
            shard.note_epoch(getattr(exc, "epoch", 0))
            shard.note_primary_failure(now)
            if (
                self.auto_promote
                and shard.failing_for(now) >= self.promote_after
            ):
                self._run_election(shard)
            else:
                self._refresh_shard_primary(shard)
            return
        if not is_transient(exc):
            return
        shard.note_primary_failure(now)
        if (
            self.auto_promote
            and shard.replicas
            and shard.failing_for(now) >= self.promote_after
        ):
            self._run_election(shard)

    def _refresh_shard_primary(self, shard):
        """Re-discover which node serves the shard (post-promotion or
        post-fence): probe all nodes, adopt whichever claims primary at
        the highest epoch.  Never elects — that needs the confirmation
        window; this only catches up with an election someone else ran."""
        if not shard.replicas:
            return
        if not shard._promote_guard.acquire(blocking=False):
            return  # someone on this router is already sorting it out
        try:
            self._elect(shard, adopt_only=True)
        finally:
            shard._promote_guard.release()

    def _run_election(self, shard):
        """Confirmation window expired: elect and promote (one thread per
        router at a time; concurrent routers converge via the
        deterministic winner + the idempotent promote op)."""
        if not shard._promote_guard.acquire(blocking=False):
            return
        try:
            # Re-check under the guard: a concurrent thread may have just
            # promoted and cleared the streak.
            if shard.failing_for(self._now()) < self.promote_after:
                return
            self._elect(shard, adopt_only=False)
        finally:
            shard._promote_guard.release()

    def _probe_seq(self, client):
        """One ``seq`` probe over a short-lived, SHORT-timeout connection:
        elections and health views must not borrow the data path's (long)
        timeout or contend its connection lock — a hung node costs at
        most PROBE_TIMEOUT_S here, not a data-timeout-long stall."""
        probe = NetworkDB(
            host=client.host, port=client.port, timeout=PROBE_TIMEOUT_S,
            secret=client.secret, reconnect_jitter=0,
        )
        try:
            return probe._call("seq") or {}
        finally:
            probe.close()

    def _elect(self, shard, adopt_only):
        max_epoch = shard.epoch_floor()
        candidates = []
        promoted_elsewhere = None
        # The primary slot gets one last probe: a box that answers AS A
        # PRIMARY mid-window was merely slow/restarting — no election.
        # One that answers as a REPLICA is itself the leading candidate:
        # a previously promoted node that restarted back into its
        # configured replica role sits in this slot precisely because an
        # earlier election chose it (its seq decides like any other's).
        floor = shard.epoch_floor()
        try:
            info = self._probe_seq(shard.primary)
        except Exception:
            pass
        else:
            epoch = int(info.get("epoch", 0) or 0)
            max_epoch = max(max_epoch, epoch)
            if not info.get("replica"):
                if epoch >= floor:
                    shard.note_epoch(epoch)
                    shard.clear_primary_failure()
                    return
                # A primary claimant BELOW this router's epoch floor is a
                # stale fork that never heard of its own demotion (its
                # newer-epoch peer may be dead too).  Never honored, never
                # electable: blessing the fork would silently discard the
                # newer timeline — that trade-off belongs to an operator.
            elif not info.get("resyncing") and epoch >= floor:
                # Electable only at/above the floor: a replica still on an
                # OLDER epoch missed writes a newer primary acknowledged.
                candidates.append(
                    (int(info.get("seq", 0)), shard.primary, None)
                )
        for index, replica in enumerate(shard.replicas):
            try:
                info = self._probe_seq(replica)
            except Exception:
                continue  # unreachable: not electable from here
            epoch = int(info.get("epoch", 0) or 0)
            max_epoch = max(max_epoch, epoch)
            if not info.get("replica"):
                # Already a primary (a concurrent router won the race):
                # adopt the highest-epoch claimant — but never one BELOW
                # the epoch floor (a stale fork, see above).
                if epoch >= floor and (
                    promoted_elsewhere is None or epoch > promoted_elsewhere[1]
                ):
                    promoted_elsewhere = (index, epoch)
                continue
            if info.get("resyncing") or epoch < floor:
                # A fork mid-repair, or a replica still on an older epoch
                # (it missed writes a newer primary acknowledged): not
                # electable.
                continue
            candidates.append((int(info.get("seq", 0)), replica, index))
        if promoted_elsewhere is not None:
            index, epoch = promoted_elsewhere
            self._adopt_primary(shard, index, epoch, elected=False)
            return
        if adopt_only or not candidates:
            return
        # Deterministic winner: most caught-up wins; ties break on address
        # so every router probing the same fleet elects the SAME replica.
        candidates.sort(key=lambda c: (-c[0], f"{c[1].host}:{c[1].port}"))
        seq, winner, index = candidates[0]
        winner_addr = f"{winner.host}:{winner.port}"
        peers = [
            addr
            for addr in [shard.identity]
            + [f"{r.host}:{r.port}" for r in shard.replicas]
            if addr != winner_addr
        ]
        new_epoch = max_epoch + 1
        try:
            # Rides the shard policy with an explicit mode: the
            # promote op is idempotent by construction — a resend at the
            # same epoch reports the standing state, never re-flips.
            result = shard.policy.run(
                lambda: winner._call(
                    "promote", {"epoch": new_epoch, "replicate_to": peers}
                ),
                op=f"shard.s{shard.index}.promote",
                mode=MODE_ALWAYS,
            ) or {}
        except Exception as exc:
            log.warning(
                "promotion of %s:%s (shard %d) failed: %s",
                winner.host, winner.port, shard.index, exc,
            )
            return
        if not result.get("primary"):
            # Lost a cross-router race (the winner already heard a higher
            # epoch as a replica) — the next failure cycle adopts.
            shard.note_epoch(int(result.get("epoch", 0) or 0))
            return
        self._adopt_primary(
            shard, index, int(result.get("epoch", new_epoch)), elected=True
        )

    def _adopt_primary(self, shard, replica_index, epoch, elected):
        if replica_index is None:
            winner = shard.primary
            shard.promote_in_place(epoch)
        else:
            winner = shard.promote_swap(replica_index, epoch, self._now())
        TELEMETRY.count("storage.shard.promotions")
        if FLIGHT.enabled:
            FLIGHT.record(
                "promote",
                args={
                    "shard": shard.index,
                    "winner": f"{winner.host}:{winner.port}",
                    "epoch": epoch,
                    "elected": elected,
                },
            )
        log.warning(
            "shard %d: %s %s:%s as primary at epoch %d (was %s)",
            shard.index,
            "promoted" if elected else "adopted",
            winner.host, winner.port, epoch, shard.identity,
        )

    # --- replica auto-reprovisioning (day-2 operations) ----------------------
    def _reprovision_loop(self):
        """Background sweep: probe replica health and replace the dead.
        Runs only when a ``replica_provisioner`` is configured; never
        raises — replica repair must not take the router down with it."""
        interval = max(0.25, min(1.0, self.reprovision_after / 4.0))
        while not self._reprovision_stop.wait(interval):
            try:
                self._reprovision_sweep()
            except Exception:  # pragma: no cover - defensive
                log.debug("reprovision sweep failed", exc_info=True)

    def _reprovision_sweep(self):
        shards = list(self._shards)
        now = self._now()
        live = {s.identity for s in shards}
        with self._reprovision_lock:
            TSAN.write("ShardedNetworkDB._replica_down", self)
            # Entries for shards a topology change removed never fire.
            for key in [
                k for k in self._replica_down_since if k[0] not in live
            ]:
                del self._replica_down_since[key]
        for shard in shards:
            if self._reprovision_stop.is_set():
                return
            if shard.epoch_floor() == 0:
                # Never promoted: the configured replica set is authoritative
                # and a down replica is expected to come back AS ITSELF (a
                # reboot) — reprovisioning belongs to the post-promotion
                # one-short-forever state.
                continue
            if shard.failing_for(now) > 0:
                # The PRIMARY is failing: adoption has nobody to talk to,
                # and the election machinery owns this phase.
                continue
            for replica_index, replica in enumerate(list(shard.replicas)):
                addr = f"{replica.host}:{replica.port}"
                key = (shard.identity, addr)
                try:
                    self._probe_seq(replica)
                except Exception:
                    with self._reprovision_lock:
                        TSAN.write("ShardedNetworkDB._replica_down", self)
                        since = self._replica_down_since.setdefault(key, now)
                    if now - since >= self.reprovision_after:
                        self._reprovision(shard, replica_index, addr)
                else:
                    with self._reprovision_lock:
                        TSAN.write("ShardedNetworkDB._replica_down", self)
                        self._replica_down_since.pop(key, None)

    def _reprovision(self, shard, replica_index, dead_addr):
        """Provision and adopt a replacement for one dead replica: ask the
        provisioner for a fresh empty server, tell the shard's CURRENT
        primary to adopt it (``adopt_replica`` — the pusher's ordinary gap
        logic snapshot-resyncs it, bounded by the server's resync gate),
        then swap the dead client out of the router's replica set."""
        TELEMETRY.set_gauge("storage.reprovision.in_progress", 1)
        if FLIGHT.enabled:
            FLIGHT.record(
                "reprovision.start",
                args={"shard": shard.index, "dead": dead_addr},
            )
        try:
            address = self.replica_provisioner(shard.index)
            host, _, port = str(address).rpartition(":")
            if not host or not port:
                raise DatabaseError(  # lint: disable=STO004 -- caught by this method's own except; retried next sweep, never a client reply
                    f"provisioner returned {address!r}; expected host:port"
                )
            result = shard.primary._call(
                "adopt_replica", {"address": f"{host}:{int(port)}"}
            ) or {}
            if not result.get("adopted"):
                raise DatabaseError(  # lint: disable=STO004 -- caught by this method's own except; retried next sweep, never a client reply
                    f"shard {shard.index} primary refused to adopt "
                    f"{address!r}: {result}"
                )
            client = NetworkDB(
                host=host, port=int(port),
                **dict(self._client_base, secret=shard.primary.secret),
            )
            old = shard.adopt_replacement(
                replica_index, client, dead_addr, self._now()
            )
            old.close()
            with self._reprovision_lock:
                TSAN.write("ShardedNetworkDB._replica_down", self)
                self._replica_down_since.pop((shard.identity, dead_addr), None)
                self.reprovisions += 1
            TELEMETRY.count("storage.shard.reprovisions")
            if FLIGHT.enabled:
                FLIGHT.record(
                    "reprovision.done",
                    args={
                        "shard": shard.index,
                        "dead": dead_addr,
                        "replica": f"{host}:{port}",
                    },
                )
            log.warning(
                "shard %d: reprovisioned dead replica %s -> %s",
                shard.index, dead_addr, f"{host}:{port}",
            )
        except Exception as exc:
            # The window keeps running: the NEXT sweep past the threshold
            # retries (a provisioner outage must not wedge repair forever).
            log.warning(
                "shard %d: reprovisioning replica %s failed: %s",
                shard.index, dead_addr, exc,
            )
        finally:
            TELEMETRY.set_gauge("storage.reprovision.in_progress", 0)

    # --- AbstractDB contract -------------------------------------------------
    def ping(self):
        if self._passthrough:
            return self._shards[0].primary.ping()
        results = self._each_shard(
            lambda shard: shard.primary.ping(), read_only=True, op="ping"
        )
        return all(results)

    def ensure_index(self, collection, keys, unique=False):
        if self._passthrough:
            return self._shards[0].primary.ensure_index(
                collection, keys, unique=unique
            )
        self._ensure_through_promotion(
            lambda shard: self._shard_mutate(
                shard, "ensure_index", collection, keys, unique=unique
            ),
            op="ensure_index",
        )

    def ensure_indexes(self, specs):
        if self._passthrough:
            return self._shards[0].primary.ensure_indexes(specs)
        specs = [list(s) for s in specs]
        self._ensure_through_promotion(
            lambda shard: self._shard_mutate(shard, "ensure_indexes", specs),
            op="ensure_indexes",
        )

    def _ensure_through_promotion(self, leg, op):
        """Index setup runs at CONSTRUCTION time — before any op has fed
        the failure detector — so a dead primary would otherwise crash
        every fresh process (CLI command, new worker) even though a
        caught-up replica is one election away.  Re-run the fan-out
        (idempotent) long enough for the per-leg failures to accumulate a
        promotion streak and for the election to heal the shard; a shard
        that stays dead past the window raises exactly as before."""
        import time

        deadline = (
            self._now() + self.promote_after * 2 + 2.0
            if self.auto_promote
            else None
        )
        while True:
            try:
                return self._each_shard(leg, op=op)
            except DatabaseError:
                if deadline is None or self._now() >= deadline:
                    raise
                time.sleep(0.2)

    def index_information(self, collection):
        if self._passthrough:
            return self._shards[0].primary.index_information(collection)
        merged = {}
        for info in self._each_shard(
            lambda shard: shard.primary.index_information(collection),
            read_only=True,
            op="index_information",
        ):
            merged.update(info or {})
        return merged

    def drop_index(self, collection, name):
        if self._passthrough:
            return self._shards[0].primary.drop_index(collection, name)
        results, errors = self._collect_shards(
            lambda shard: shard.primary.drop_index(collection, name),
            op="drop_index",
        )
        key_errors = [e for e in errors if isinstance(e, KeyError)]
        hard = [e for e in errors if e is not None and not isinstance(e, KeyError)]
        if hard:
            raise shard_fanout_error(
                f"drop_index({collection!r}, {name!r}) failed", hard
            )
        if key_errors and len(key_errors) == len(self._shards):
            # Missing EVERYWHERE is the single-server "index not found";
            # missing somewhere is a partially-applied earlier drop that
            # this call just finished converging.
            raise key_errors[0]

    def write(self, collection, data, query=None):
        if self._passthrough:
            return self._shards[0].primary.write(collection, data, query=query)
        if query is not None:
            index = self._route(collection, query=query)
            if index is not None:
                return self._shard_mutate(
                    self._shard_at(index), "write", collection, data, query=query
                )
            results = self._each_shard(
                lambda shard: self._shard_mutate(
                    shard, "write", collection, data, query=query
                ),
                op="write",
            )
            return sum(r or 0 for r in results)
        return self._insert(collection, data)

    def _insert(self, collection, data):
        single = isinstance(data, dict)
        docs = [data] if single else list(data)
        if collection == "experiments":
            docs = [self._with_minted_id(doc) for doc in docs]
        groups = OrderedDict()  # shard index -> [(position, doc)]
        for position, doc in enumerate(docs):
            index = self._route(collection, doc=doc)
            if index is None:
                # No experiment, no id: an auto-id document with no routable
                # identity (third-party collections).  Ring-place by the
                # collection name so placement stays deterministic.
                index = self._ring.lookup(collection)
            groups.setdefault(index, []).append((position, doc))
        if single:
            # One document, one shard: preserve the single-insert return
            # shape (the inserted id, minted or server-assigned).
            (index, members), = groups.items()
            doc = members[0][1]
            result = self._shard_mutate(self._shard_at(index), "write", collection, doc)
            self._remember_owner(collection, doc.get("_id"), index)
            return result
        out = [None] * len(docs)
        for index, members in groups.items():
            payload = [doc for _, doc in members]
            ids = self._shard_mutate(
                self._shard_at(index), "write", collection, payload
            )
            for (position, doc), _id in zip(members, ids):
                out[position] = _id
                self._remember_owner(collection, doc.get("_id"), index)
        return out

    def _with_minted_id(self, doc):
        if "_id" in doc:
            return doc
        doc = dict(doc)
        doc["_id"] = mint_experiment_id(doc)
        return doc

    def update_many(self, collection, pairs):
        if self._passthrough:
            return self._shards[0].primary.update_many(collection, pairs)
        routed = OrderedDict()
        broadcast = []
        for query, update in pairs:
            index = self._route(collection, query=query)
            if index is None:
                broadcast.append((query, update))
            else:
                routed.setdefault(index, []).append((query, update))
        total = 0
        for index, shard_pairs in routed.items():
            total += self._shard_mutate(
                self._shard_at(index), "update_many", collection, shard_pairs
            )
        if broadcast:
            # Un-keyed updates apply to matching docs WHEREVER they live —
            # the correct cross-shard semantics of a query-driven update.
            results = self._each_shard(
                lambda shard: self._shard_mutate(
                    shard, "update_many", collection, broadcast
                ),
                op="update_many",
            )
            total += sum(r or 0 for r in results)
        return total

    def read(self, collection, query=None, projection=None):
        if self._passthrough:
            return self._shards[0].primary.read(
                collection, query=query, projection=projection
            )
        index = self._route(collection, query=query)
        if index is not None:
            docs = self._shard_read(
                self._shard_at(index), "read", collection, query=query,
                projection=projection,
            )
            self._harvest_owners(collection, docs, index)
            if not docs:
                # Invalidated-on-miss: an override-routed empty answer may
                # mean the experiment moved on (post-delete stale cache).
                self._invalidate_placement(collection, query)
            return docs
        merged = []
        results = self._each_shard(
            lambda shard: self._shard_read(
                shard, "read", collection, query=query, projection=projection
            ),
            read_only=True,
            op="read",
        )
        for shard, docs in zip(self._shards, results):
            self._harvest_owners(collection, docs, shard.index)
            merged.extend(docs or [])
        return merged

    def count(self, collection, query=None):
        if self._passthrough:
            return self._shards[0].primary.count(collection, query=query)
        index = self._route(collection, query=query)
        if index is not None:
            result = self._shard_read(
                self._shard_at(index), "count", collection, query=query
            )
            if not result:
                self._invalidate_placement(collection, query)
            return result
        results = self._each_shard(
            lambda shard: self._shard_read(shard, "count", collection, query=query),
            read_only=True,
            op="count",
        )
        return sum(r or 0 for r in results)

    def read_and_write(self, collection, query, data):
        if self._passthrough:
            return self._shards[0].primary.read_and_write(collection, query, data)
        index = self._route(collection, query=query)
        if index is not None:
            doc = self._shard_mutate(
                self._shard_at(index), "read_and_write", collection, query, data
            )
            if isinstance(doc, dict):
                self._remember_owner(collection, doc.get("_id"), index)
            else:
                self._invalidate_placement(collection, query)
            return doc
        if _concrete((query or {}).get("_id")) is None:
            # A find-ONE-and-update keyed by neither _id nor experiment has
            # no correct cross-shard spelling: running it on every shard
            # would CAS up to N documents where one server swaps exactly
            # one.  Refuse loudly (pre-flight: nothing ran anywhere).
            error = DatabaseError(
                f"read_and_write({collection!r}) query {query!r} carries "
                "neither an _id nor an experiment key — a single-document "
                "CAS cannot be routed (and must not run on every shard)"
            )
            error.maybe_applied = merge_maybe_applied(())
            raise error
        # Id-only owner-cache miss: ids are globally unique, so at most
        # ONE shard matches; the others no-op to None.  Each leg rides
        # _shard_mutate so failures feed the promotion detector and the
        # fence stamps the connection the CAS actually rode.
        results, errors = self._collect_shards(
            lambda shard: self._shard_mutate(
                shard, "read_and_write", collection, query, data
            ),
            op="read_and_write",
        )
        winner = None
        for shard, doc in zip(self._shards, results):
            if isinstance(doc, dict):
                winner = doc
                self._remember_owner(collection, doc.get("_id"), shard.index)
        failed = [e for e in errors if e is not None]
        if winner is not None:
            # The unique-id invariant (the query carries a concrete _id,
            # enforced above) means the matching shard answered; an error
            # on a NON-matching shard cannot have applied this CAS (its
            # query matched nothing there).
            return winner
        if failed:
            raise shard_fanout_error(
                f"read_and_write({collection!r}) failed on "
                f"{len(failed)}/{len(self._shards)} shard(s)",
                failed,
            )
        return None

    def remove(self, collection, query=None):
        if self._passthrough:
            return self._shards[0].primary.remove(collection, query=query)
        index = self._route(collection, query=query)
        if index is not None:
            return self._shard_mutate(
                self._shard_at(index), "remove", collection, query=query
            )
        results = self._each_shard(
            lambda shard: self._shard_mutate(shard, "remove", collection, query=query),
            op="remove",
        )
        return sum(r or 0 for r in results)

    # --- batch primitives ----------------------------------------------------
    def apply_batch(self, ops):
        if self._passthrough:
            return self._shards[0].primary.apply_batch(ops)
        return self._batch(ops, "apply_batch")

    def pipeline(self, ops):
        if self._passthrough:
            return self._shards[0].primary.pipeline(ops)
        return self._batch(ops, "pipeline")

    def _route_sub_op(self, op, args, kwargs):
        collection = args[0] if args else None
        if op == "write":
            data = args[1] if len(args) > 1 else None
            query = (kwargs or {}).get("query")
            if query is None and len(args) > 2:
                query = args[2]
            if query is not None:
                return self._route(collection, query=query)
            doc = None
            if isinstance(data, dict):
                doc = data
            elif isinstance(data, (list, tuple)) and data:
                doc = data[0] if isinstance(data[0], dict) else None
            return self._route(collection, doc=doc)
        query = args[1] if len(args) > 1 else (kwargs or {}).get("query")
        if not isinstance(query, dict):
            query = None
        return self._route(collection, query=query)

    def _batch(self, ops, primitive):
        """Split a batch by target shard, dispatch the per-shard
        sub-batches CONCURRENTLY through the shard's own batch primitive,
        and reassemble per-slot outcomes in the original order.
        Unroutable slots execute through the op-level router methods
        (which fan out) and land their outcome — or their exception — in
        place.  A shard whose whole sub-batch died raises the aggregated
        error with the strictest ``maybe_applied``: healthy shards' slots
        applied durably, and the op-level retry's re-run converges through
        the same dedup contracts a single server's retry does."""
        ops = list(ops)
        if not ops:
            return []
        groups = OrderedDict()  # shard index -> [(position, sub_op)]
        loose = []  # [(position, sub_op)] — unroutable
        for position, (op, args, kwargs) in enumerate(ops):
            index = self._route_sub_op(op, list(args), kwargs)
            if index is None:
                loose.append((position, (op, args, kwargs)))
            else:
                groups.setdefault(index, []).append((position, (op, args, kwargs)))
        out = [None] * len(ops)
        errors = []

        def run_group(index, members):
            shard = self._shard_at(index)
            sub_ops = [sub for _, sub in members]
            mutating = any(
                op not in ("read", "count") for op, _, _ in sub_ops
            )
            try:
                if mutating:
                    # Same discipline as _shard_mutate: the client is
                    # captured once (fence-stamps the connection the batch
                    # rode), failures feed the promotion detector — the
                    # producer's q-round rides THIS path, so a dead
                    # primary must trip the election from here too.
                    primary = shard.primary
                    try:
                        outcomes = getattr(primary, primitive)(sub_ops)
                    except Exception as exc:
                        self._note_primary_error(shard, exc)
                        raise
                    self._fence_stale_write(shard, primary, primitive)
                    shard.clear_primary_failure()
                else:
                    outcomes = self._shard_read(shard, primitive, sub_ops)
            except Exception as exc:
                errors.append(exc)
                return
            for (position, sub), outcome in zip(members, outcomes):
                out[position] = outcome
                if sub[0] in ("read", "read_and_write"):
                    docs = outcome if isinstance(outcome, list) else [outcome]
                    self._harvest_owners(sub[1][0] if sub[1] else None, [
                        d for d in docs if isinstance(d, dict)
                    ], index)

        if len(groups) <= 1:
            for index, members in groups.items():
                run_group(index, members)
        else:
            threads = [
                threading.Thread(
                    target=run_group, args=(index, members), daemon=True
                )
                for index, members in groups.items()
            ]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join()
        for position, (op, args, kwargs) in loose:
            try:
                out[position] = getattr(self, op)(*args, **kwargs)
            except Exception as exc:
                # Slot containment, same contract as a server-side refused
                # slot: the exception IS the outcome.
                out[position] = exc
        if errors:
            raise shard_fanout_error(
                f"{primitive} failed on {len(errors)} shard(s)", errors
            )
        return out
