"""Storage- and replication-plane doctor rules (``DX02x``, ``DX06x``; port
of ``orion_tpu/diagnosis/rules_storage.py``).

Failure signatures this family covers are exactly the ones the retry
policy, the netdb reconnect path, the sharded/replicated control plane and
the day-2 migrator already count: absorbed transient retries,
exhausted policies, reconnect herds, replica lag, epoch-fence refusals,
and dead primaries.  Threshold rules read the merged counters; the lag
GROWTH rule is a trend over the accumulated replication-probe series
(watch mode appends one probe per frame — a single one-shot probe can
only trip the absolute-lag bar, never the growth bar).
"""

from orion_tpu_torch.diagnosis.engine import DoctorRule
from orion_tpu_torch.diagnosis.trend import robust_slope


class StorageRetrySpike(DoctorRule):
    id = "DX020"
    name = "storage-retry-spike"
    severity = "warn"
    runbook = "dx020-storage-retry-spike"
    description = (
        "storage.retries is climbing far faster than rounds complete: the "
        "backoff policy is absorbing a struggling store — latency is being "
        "paid in sleeps, and give-ups are the next stop."
    )

    MIN_RETRIES = 20
    RETRIES_PER_ROUND = 5.0

    def evaluate(self, snapshot):
        retries = snapshot.counter("storage.retries")
        rounds = max(snapshot.rounds(), 1)
        if retries >= self.MIN_RETRIES and retries >= (
            self.RETRIES_PER_ROUND * rounds
        ):
            yield self.finding(
                f"{retries} storage retries over {rounds} rounds "
                f"(> {self.RETRIES_PER_ROUND:g}/round) — the store is "
                "failing transiently at a rate backoff can barely absorb",
                value=retries,
            )


class StorageGaveUp(DoctorRule):
    id = "DX021"
    name = "storage-gave-up"
    severity = "critical"
    runbook = "dx021-storage-gave-up"
    description = (
        "storage.gave_up > 0: a retry policy exhausted its budget and "
        "surfaced the failure — operations actually failed upward, the "
        "line between 'slow' and 'losing work'."
    )

    def evaluate(self, snapshot):
        gave_up = snapshot.counter("storage.gave_up")
        if gave_up > 0:
            yield self.finding(
                f"{gave_up} storage operation(s) exhausted their retry "
                "policy and failed upward — check the store's health and "
                "the audit (`orion-tpu-torch audit`) for lost work",
                value=gave_up,
            )


class ReconnectStorm(DoctorRule):
    id = "DX022"
    name = "reconnect-storm"
    severity = "warn"
    runbook = "dx022-reconnect-storm"
    description = (
        "wire drivers are re-dialing far more often than rounds complete: "
        "a flapping server, a mid-path network fault, or a restart herd."
    )

    MIN_RECONNECTS = 10
    RECONNECTS_PER_ROUND = 1.0

    def evaluate(self, snapshot):
        reconnects = snapshot.counter_sum(".reconnects")
        rounds = max(snapshot.rounds(), 1)
        if reconnects >= self.MIN_RECONNECTS and reconnects >= (
            self.RECONNECTS_PER_ROUND * rounds
        ):
            yield self.finding(
                f"{reconnects} wire reconnects over {rounds} rounds — a "
                "server (or the path to it) is flapping; reconnect jitter "
                "is spreading the herd but the cause needs an operator",
                value=reconnects,
            )


class ReplicationLagGrowth(DoctorRule):
    id = "DX023"
    name = "replication-lag-growth"
    severity = "critical"
    runbook = "dx023-replication-lag-growth"
    description = (
        "a replica's applied position is falling ever further behind its "
        "primary (or is already an epoch behind by a large margin): the "
        "shard's failover capital is draining — a promotion now would "
        "lose the unreplicated tail."
    )

    #: Absolute bar a single probe can trip; growth bar needs a series.
    MAX_LAG = 64
    MIN_PROBES = 3
    MIN_GROWTH = 8

    def evaluate(self, snapshot):
        series = snapshot.replication_series
        if not series:
            return
        # Worst replica lag per probe, per shard.
        per_shard = {}
        for probe in series:
            for entry in probe or ():
                lag = entry.get("max_lag")
                if lag is None:
                    continue
                per_shard.setdefault(entry.get("index"), []).append(int(lag))
        for index, lags in sorted(per_shard.items()):
            latest = lags[-1]
            if latest >= self.MAX_LAG:
                yield self.finding(
                    f"shard {index} replica lag at {latest} entries (>= "
                    f"{self.MAX_LAG}) — replication is stalled or the "
                    "replica is resyncing forever; a promotion now loses "
                    "the tail",
                    value=latest,
                    subject=index,
                )
                continue
            if (
                len(lags) >= self.MIN_PROBES
                and robust_slope(lags) > 0
                and latest - lags[0] >= self.MIN_GROWTH
            ):
                yield self.finding(
                    f"shard {index} replica lag grew {lags[0]} -> {latest} "
                    f"across {len(lags)} probes (robust slope "
                    f"{robust_slope(lags):.2f}/probe) — the replica is "
                    "falling behind a live write load",
                    value=latest,
                    subject=index,
                )


class FencedWriteSpike(DoctorRule):
    id = "DX024"
    name = "fenced-write-spike"
    severity = "warn"
    runbook = "dx024-fenced-write-spike"
    description = (
        "storage.shard.fenced_writes keeps climbing: routers are still "
        "reaching a stale-epoch primary — a promotion is stuck half-done "
        "(the fence is saving correctness, at a retry per write)."
    )

    FENCED = 8

    def evaluate(self, snapshot):
        fenced = snapshot.counter("storage.shard.fenced_writes")
        if fenced >= self.FENCED:
            yield self.finding(
                f"{fenced} epoch-fenced writes — some router (or a reborn "
                "stale primary) is behind the promotion; check `orion-tpu-torch "
                "db ring` for who holds the current epoch",
                value=fenced,
            )


class DegradedShard(DoctorRule):
    id = "DX025"
    name = "degraded-shard"
    severity = "critical"
    runbook = "dx025-degraded-shard"
    description = (
        "a shard's serving primary answers no probe (and no promoted "
        "replica has taken over): every experiment the ring placed there "
        "is down."
    )

    def evaluate(self, snapshot):
        for entry in snapshot.replication or ():
            if entry.get("error"):
                yield self.finding(
                    f"shard {entry.get('index')} primary "
                    f"{entry.get('primary')} is unreachable "
                    f"({entry.get('error')}) — degraded until a replica is "
                    "promoted or the primary returns",
                    value=entry.get("index"),
                    subject=entry.get("index"),
                )


class DrainStuck(DoctorRule):
    id = "DX060"
    name = "drain-stuck"
    severity = "warn"
    runbook = "dx060-drain-stuck"
    description = (
        "a `db drain` phase has made no progress for minutes "
        "(storage.drain.phase_age_s): the migrator is wedged on a dead "
        "destination, an endless retry loop, or a crashed operator "
        "session that left experiments pinned/fenced."
    )

    #: A healthy drain progresses per move in well under this; a fenced
    #: experiment stuck past it is blocking writes.
    MAX_PHASE_AGE_S = 120.0

    def evaluate(self, snapshot):
        age = snapshot.gauge("storage.drain.phase_age_s")
        if age is not None and age >= self.MAX_PHASE_AGE_S:
            yield self.finding(
                f"drain phase stalled for {age:.0f}s (>= "
                f"{self.MAX_PHASE_AGE_S:g}s) — fenced experiments refuse "
                "writes until it finishes; re-run `orion-tpu-torch db drain` "
                "(crash-resumable) or check the destination shard",
                value=age,
            )


class ReplicaShort(DoctorRule):
    id = "DX061"
    name = "replica-short"
    severity = "warn"
    runbook = "dx061-replica-short"
    description = (
        "a promoted primary is running below its declared replica count "
        "with no reprovision in flight: the shard's failover capital is "
        "gone — the next primary loss has no caught-up replica to elect "
        "(and a quorum floor would refuse writes outright)."
    )

    def evaluate(self, snapshot):
        if (snapshot.gauge("storage.reprovision.in_progress", 0.0) or 0.0) > 0:
            return  # repair underway — the gauge drops when it lands
        for entry in snapshot.replication or ():
            if entry.get("error"):
                continue  # a dead PRIMARY is DX025's finding
            if int(entry.get("epoch", 0) or 0) <= 0:
                continue  # never promoted: a down replica reboots as itself
            dead = [
                row.get("address")
                for row in entry.get("replicas", ())
                if row.get("error")
            ]
            if dead:
                yield self.finding(
                    f"shard {entry.get('index')} promoted primary "
                    f"{entry.get('primary')} is short {len(dead)} "
                    f"replica(s) ({', '.join(map(str, dead))}) with no "
                    "reprovision in flight — configure a "
                    "replica_provisioner or start/adopt a replacement "
                    "manually",
                    value=len(dead),
                    subject=entry.get("index"),
                )


STORAGE_RULES = (
    StorageRetrySpike,
    StorageGaveUp,
    ReconnectStorm,
    ReplicationLagGrowth,
    FencedWriteSpike,
    DegradedShard,
    DrainStuck,
    ReplicaShort,
)
