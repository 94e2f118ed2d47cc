"""Systems-plane doctor rules (``DX00x``; port of
``orion_tpu/diagnosis/rules_system.py``): device dispatch hygiene, worker
liveness, the wall≈device budget, and serve-plane saturation.

Each rule reads only signals the stack already emits (docs/monitoring.md
names every one); thresholds live as class attributes, the reference's
own, so seeded pathology snapshots can construct unambiguous extremes.
DX001 reads the compiler plane's ``cuda_graph.recaptures`` where the
reference reads ``jax.retraces``.  DX005, DX007 and DX008 read what the
serve gateway and its fleet publish (``serve.queue_depth`` and the
``serve.backpressure`` counter; the ``serve.fleet.tenants.g<i>`` gauges;
``serve.fleet.fenced_age_s``).  DX006 reads the placement fields a
``use_mesh`` algorithm adds to its health records (``mesh_devices``,
``mesh_util_*_frac``: bytes per slot of the newest pool it sharded) and
their ``serve_`` twins, which the gateway copies from the coalescer's
tenant-parallel dispatch.
"""

from orion_tpu_torch.diagnosis.engine import DoctorRule


class RecaptureStorm(DoctorRule):
    id = "DX001"
    name = "retrace-storm"
    severity = "critical"
    runbook = "dx001-retrace-storm"
    description = (
        "cuda_graph.recaptures climbing round over round means a "
        "suggest-step signature fork: every produce round pays a "
        "synchronous CUDA-graph capture (an eager round, the capture and "
        "its instantiation) instead of a replay."
    )

    #: A healthy hunt pays a handful of captures (initial signatures +
    #: pow-2 bucket growths); a fork recaptures per ROUND.  Both bars must
    #: hold: enough rounds to judge, and recaptures keeping pace with them.
    MIN_ROUNDS = 10
    MIN_RETRACES = 10
    RETRACES_PER_ROUND = 0.5

    def evaluate(self, snapshot):
        rounds = snapshot.rounds()
        recaptures = snapshot.counter("cuda_graph.recaptures")
        if rounds >= self.MIN_ROUNDS and recaptures >= max(
            self.MIN_RETRACES, self.RETRACES_PER_ROUND * rounds
        ):
            yield self.finding(
                f"{recaptures} synchronous CUDA-graph captures over {rounds} "
                "rounds (healthy: a handful total) — a static argument is "
                "forking the suggest-step signature every round",
                value=recaptures,
            )


class HeartbeatLag(DoctorRule):
    id = "DX002"
    name = "heartbeat-lag"
    severity = "warn"
    runbook = "dx002-heartbeat-lag"
    description = (
        "pacemaker.heartbeat_lag_s approaching the heartbeat threshold: "
        "live reserved trials are about to be swept as lost and re-run."
    )

    #: Fire at half the sweep threshold — early enough to act, late
    #: enough that ordinary scheduling jitter stays quiet.
    LAG_FRACTION = 0.5
    DEFAULT_HEARTBEAT = 120.0

    def evaluate(self, snapshot):
        lag = snapshot.gauge("pacemaker.heartbeat_lag_s")
        if lag is None:
            return
        heartbeat = float(snapshot.heartbeat or self.DEFAULT_HEARTBEAT)
        if lag > self.LAG_FRACTION * heartbeat:
            yield self.finding(
                f"worst heartbeat lag {lag:.1f}s exceeds "
                f"{self.LAG_FRACTION:g}x the {heartbeat:g}s sweep threshold "
                "— reserved trials risk being swept as lost (gauges merge "
                "by MAX, so this is the worst worker's number)",
                value=lag,
            )


class StaleWorker(DoctorRule):
    id = "DX003"
    name = "stale-worker"
    severity = "warn"
    runbook = "dx003-stale-worker"
    description = (
        "a worker stopped flushing metrics/health while the rest of the "
        "fleet is live: crashed, hung, or partitioned — its MAX-merged "
        "gauges are fossils."
    )

    def evaluate(self, snapshot):
        ages = snapshot.worker_ages()
        if len(ages) < 2:
            return
        freshest = min(ages.values())
        # The "fleet is live" gate: when EVERY worker is quiet the hunt
        # ended (or the store is an archive) — that is not a stale-worker
        # pathology, and firing on finished runs would make one-shot
        # diagnosis over old experiments permanently noisy.
        if freshest > snapshot.stale_after:
            return
        stale = sorted(
            worker
            for worker, age in ages.items()
            if age > snapshot.stale_after
        )
        if stale:
            worst = max(ages[worker] for worker in stale)
            yield self.finding(
                f"{len(stale)} worker(s) stopped flushing for > "
                f"{snapshot.stale_after:g}s while the fleet is live: "
                f"{', '.join(stale)}",
                value=worst,
                # Subject = WHICH workers: another worker going quiet is
                # a new alert; the same set aging further is not.
                subject=tuple(stale),
            )


class HostBudgetBreach(DoctorRule):
    id = "DX004"
    name = "host-budget-breach"
    severity = "warn"
    runbook = "dx004-host-budget-breach"
    description = (
        "the mean producer round runs far longer than the mean device "
        "window: host work (codec, storage, Python) dominates the round "
        "again — the wall-=-device contract is regressing."
    )

    #: Mean producer.round vs mean device.dispatch.  The round CONTAINS
    #: the device window, so a host budget of F x device bounds a healthy
    #: round at (1 + F) x device — the threshold is DERIVED from the same
    #: ``orion_tpu_torch.hostbudget`` knob ``orion-tpu-torch top`` and
    #: ``info`` read (ORION_TPU_HOST_BUDGET_FACTOR overrides them at once),
    #: so the doctor can never drift from them.
    MIN_SAMPLES = 4

    @property
    def FACTOR(self):
        from orion_tpu_torch.hostbudget import round_budget_factor

        return round_budget_factor()

    def evaluate(self, snapshot):
        round_mean = snapshot.histogram_mean("producer.round")
        device_mean = snapshot.histogram_mean("device.dispatch")
        if round_mean is None or device_mean is None or device_mean <= 0:
            return
        if (
            int(snapshot.histogram("producer.round").get("count", 0))
            < self.MIN_SAMPLES
        ):
            return
        factor = self.FACTOR
        if round_mean > factor * device_mean:
            yield self.finding(
                f"mean round {round_mean * 1e3:.1f}ms vs mean device window "
                f"{device_mean * 1e3:.1f}ms (> {factor:g}x = 1 + host-budget "
                "factor): the round is host-dominated — see breakdown_ms / "
                "`orion-tpu-torch trace --attribute` for which stage grew",
                value=round_mean / device_mean,
            )


class ServeQueueSaturation(DoctorRule):
    id = "DX005"
    name = "serve-queue-saturation"
    severity = "warn"
    runbook = "dx005-serve-queue-saturation"
    description = (
        "the suggest gateway's admission queue is backing up or tenants "
        "are being told to retry: the device (or the coalescing window) "
        "can no longer keep up with offered load."
    )

    QUEUE_DEPTH = 64
    BACKPRESSURE = 20

    def evaluate(self, snapshot):
        depth = snapshot.gauge("serve.queue_depth", default=0.0)
        latest = snapshot.latest_health() or {}
        depth = max(depth, float(latest.get("serve_queue_depth") or 0.0))
        if depth >= self.QUEUE_DEPTH:
            yield self.finding(
                f"gateway admission queue depth {depth:g} >= "
                f"{self.QUEUE_DEPTH} — suggests are waiting on the "
                "dispatcher; widen max_width, shorten the window, or shard "
                "the gateway",
                value=depth,
                subject="queue",
            )
        backpressure = snapshot.counter("serve.backpressure")
        if backpressure >= self.BACKPRESSURE:
            yield self.finding(
                f"{backpressure} backpressure (RETRY-AFTER) replies — "
                "tenants exceed their inflight quotas or the dispatcher "
                "backlog timer is firing; raise quotas or add capacity",
                value=backpressure,
                subject="backpressure",
            )


class MeshUtilizationSkew(DoctorRule):
    id = "DX006"
    name = "mesh-utilization-skew"
    severity = "warn"
    runbook = "dx006-mesh-utilization-skew"
    description = (
        "a sharded (use_mesh) run whose per-device byte placement is "
        "lopsided: one device holds far more than its even share of the "
        "sharded buffers — candidate sharding has silently regressed "
        "toward single-device execution and the other chips idle."
    )

    #: Worst device's fraction vs the even 1/n share.  Replicated leaves
    #: (GP state) contribute equally everywhere, so a healthy sharded
    #: round sits AT the even share; 2x means at least half the sharded
    #: bytes collapsed onto one device.
    SKEW_FACTOR = 2.0

    def evaluate(self, snapshot):
        latest = snapshot.latest_health() or {}
        # Algo-level fields first (the producer's own fused round), then
        # the gateway's serve_-prefixed twins (coalesced dispatch).
        for prefix in ("", "serve_"):
            devices = latest.get(prefix + "mesh_devices")
            max_frac = latest.get(prefix + "mesh_util_max_frac")
            if not devices or max_frac is None or int(devices) < 2:
                continue
            even = 1.0 / int(devices)
            if float(max_frac) >= self.SKEW_FACTOR * even:
                plane = "gateway" if prefix else "producer"
                yield self.finding(
                    f"{plane} mesh placement skew: worst device holds "
                    f"{float(max_frac):.0%} of sharded bytes vs the even "
                    f"{even:.0%} share over {int(devices)} devices — "
                    "candidate sharding is collapsing onto one chip (check "
                    "pool divisibility and the sharded placement)",
                    value=float(max_frac),
                    subject=plane,
                )


class FleetTenantSkew(DoctorRule):
    id = "DX007"
    name = "tenant-skew"
    severity = "warn"
    runbook = "dx007-tenant-skew"
    description = (
        "the gateway fleet's tenant placement is lopsided: one member "
        "hosts far more than its even share of tenants — its device "
        "serializes the coalesced dispatches the other members' idle "
        "devices should be absorbing."
    )

    #: Worst member's tenant count vs the even total/members share.  The
    #: consistent-hash ring balances to within small factors at scale;
    #: sustained 2x means hot experiments hash-collided onto one member
    #: (or the membership list drifted between clients and gateways).
    SKEW_FACTOR = 2.0
    #: Judgement gate: tiny fleets are lumpy by nature (3 tenants over 3
    #: members CAN land 2/1/0 legitimately).
    MIN_TENANTS = 8

    def evaluate(self, snapshot):
        gauges = snapshot.metrics.get("gauges") or {}
        per_member = {
            name: float(value)
            for name, value in gauges.items()
            if name.startswith("serve.fleet.tenants.g")
        }
        if len(per_member) < 2:
            return
        total = sum(per_member.values())
        if total < self.MIN_TENANTS:
            return
        worst_member, worst = max(per_member.items(), key=lambda kv: kv[1])
        even = total / len(per_member)
        if worst >= self.SKEW_FACTOR * even:
            yield self.finding(
                f"fleet member {worst_member.rsplit('.', 1)[-1]} hosts "
                f"{worst:g} of {total:g} tenants vs the even "
                f"{even:g}-per-member share over {len(per_member)} members "
                "— placement is collapsing onto one gateway (check that "
                "every client and member agrees on the fleet list, then "
                "rebalance with fleet_set)",
                value=worst,
                subject=worst_member,
            )


class HandoffStuck(DoctorRule):
    id = "DX008"
    name = "handoff-stuck"
    severity = "critical"
    runbook = "dx008-handoff-stuck"
    description = (
        "a fenced tenant is older than the handoff TTL: a fleet "
        "migration froze mid-flight and the tenant answers RETRY-AFTER "
        "forever — its workers are stalled, not failing over (the state "
        "still lives on the fenced member)."
    )

    #: The reference gateway's own --handoff-ttl default
    #: (``orion_tpu/serve/fleet.py::HANDOFF_TTL_S``).  A handoff is one
    #: snapshot push — milliseconds to seconds; half a minute fenced means
    #: the destination hung or died mid-import.
    TTL_S = 30.0

    def evaluate(self, snapshot):
        age = snapshot.gauge("serve.fleet.fenced_age_s", default=0.0)
        if age > self.TTL_S:
            yield self.finding(
                f"a tenant has been fenced for {age:g}s (> {self.TTL_S:g}s "
                "handoff TTL) — the migration's destination never acked "
                "the import; restart the fenced member (its store/persist "
                "snapshot unfences on boot) or re-run fleet_set",
                value=age,
            )


SYSTEM_RULES = (
    RecaptureStorm,
    HeartbeatLag,
    StaleWorker,
    HostBudgetBreach,
    ServeQueueSaturation,
    MeshUtilizationSkew,
    FleetTenantSkew,
    HandoffStuck,
)
