"""The port's soak harness (``orion_tpu_torch/storage/soak.py``): its
name spreading and busiest shard are the reference's on the same ring, and
the reference's tiny soaks run through the port's topology of real port
servers behind fault proxies: seeded server-side faults with a shard
restart, a reconnect storm and replica kills; a rebalance onto a grown
topology; a drain and removal of the busiest shard; a permanent primary
kill healed by promotion; a quorum kill without catch-up; and a replica
auto-reprovisioned after a promotion.  Each ends with zero lost
observations, the router's count equal to the sum of the shards', and
clean audits through the router and on every shard.  Each has its own
deadline; the thousand-worker soaks stay with the reference's ``slow``
suite."""

import time

import pytest

from orion_tpu.storage import soak as ref_soak
from orion_tpu_torch.core.experiment import experiment_id
from orion_tpu_torch.storage.faults import FaultSchedule, FaultyDB
from orion_tpu_torch.storage.soak import (
    ReplicaProvisioner,
    SoakTopology,
    busiest_shard,
    drain_and_remove,
    drive_soak,
    grow_and_rebalance,
    soak_experiment_names,
)
from orion_tpu_torch.telemetry import TELEMETRY
from torch_parity import isolated_telemetry

TINY_PLAN = {3: "error", 8: "latency", 13: "reply_lost", 17: "kill"}
TINY_RATES = {"error": 0.02, "reply_lost": 0.01}
TINY = {"n_workers": 12, "trials_per_worker": 4, "n_routers": 4, "chaos": False,
        "deadline": 120.0}


@pytest.fixture
def topology(tmp_path):
    """``make(**kwargs)``: a :class:`SoakTopology` persisted under
    ``tmp_path``, stopped at teardown (with telemetry isolated)."""
    made = []

    def make(**kwargs):
        kwargs.setdefault("persist_dir", str(tmp_path))
        topo = SoakTopology(**kwargs)
        made.append(topo)
        return topo

    with isolated_telemetry():
        yield make
    for topo in made:
        topo.stop()


def _assert_soak(result, schedules=(), restarts=0):
    assert result.lost_observations == 0, result.summary()
    assert result.completed == result.registered == TINY["n_workers"] * TINY["trials_per_worker"]
    assert result.audits_clean, result.summary()
    assert sum(result.completed_per_shard.values()) == result.completed
    for schedule in schedules:
        assert schedule.total_injected > 0, schedule.injected
    assert result.restarts == restarts


def test_name_spreading_and_busiest_shard_match_the_reference(topology):
    topo = topology(n_shards=3, replicas=0, persist_dir=None)
    router = topo.make_router()
    ref_router = ref_soak.ShardedNetworkDB(topo.specs(), timeout=5.0)
    try:
        for count in (6, 8, 24):
            assert soak_experiment_names(router, count, 3) == \
                ref_soak.soak_experiment_names(ref_router, count, 3)
            assert busiest_shard(topo, router, count) == \
                ref_soak.busiest_shard(topo, ref_router, count)
    finally:
        router.close()
        ref_router.close()


def test_seeded_faults_with_a_restart_storm_and_replica_kills(topology):
    """Seeded faults on every primary, then at the workers' barrier a
    reconnect storm, a shard restart and a replica killed on every shard:
    each schedule fires, the storm reconnects, a read fails over, the
    policy retries."""
    topo = topology(n_shards=3, replicas=1)
    schedules = []
    for shard in topo.shards:
        schedule = FaultSchedule(seed=7 + shard.index, plan=dict(TINY_PLAN), rates=TINY_RATES,
                                 latency=0.005, max_faults=12)
        schedules.append(schedule)
        shard.install_faults(lambda db, s=schedule: FaultyDB(db, s))

    def chaos_once():
        topo.drop_all()
        topo.shards[1].restart_primary()
        for shard in topo.shards:
            shard.kill_replica(0)

    result = drive_soak(topo, n_experiments=6, mid_hook=chaos_once, **TINY)
    _assert_soak(result, schedules, restarts=1)
    assert result.reconnects >= 1 and result.failovers >= 1
    assert TELEMETRY.counter_value("storage.retries") > 0


def test_rebalance_soak(topology):
    """The topology grows by a shard at the barrier, every live router
    takes the new ring, the rebalancer moves about a quarter of the
    experiments, and the workers finish on the new ring."""
    topo = topology(n_shards=3, replicas=1)
    outcome = {}
    result = drive_soak(topo, n_experiments=8,
                        mid_hook=lambda storages: outcome.update(
                            grow_and_rebalance(topo, storages)), **TINY)
    _assert_soak(result)
    assert outcome.get("executed") is True and outcome["planned"]["moves"] >= 1
    assert outcome["planned"]["move_fraction"] <= 2.5 / len(topo.shards)
    assert set(result.completed_per_shard) == {s.index for s in topo.shards}


def test_drain_soak(topology):
    """The busiest shard is drained and removed at the barrier; the
    workers finish on the two survivors."""
    topo = topology(n_shards=3, replicas=1)
    outcome = {}
    result = drive_soak(topo, n_experiments=8,
                        mid_hook=lambda storages: outcome.update(
                            drain_and_remove(topo, storages)), **TINY)
    _assert_soak(result)
    assert outcome.get("executed") is True and outcome["residual"] == 0
    assert outcome["planned"]["moves"] >= 1 and outcome["n_shards"] == 2
    assert outcome["planned"]["move_fraction"] <= 2.0 * outcome["ring_share"]
    assert set(result.completed_per_shard) == {0, 1}


@pytest.mark.parametrize("quorum", [0, 1], ids=["promotion", "quorum-no-catchup"])
def test_a_killed_primary_is_healed_by_promotion(topology, quorum):
    """The busiest shard's primary dies for good at the barrier (after
    its replica caught up, or with quorum 1 over two replicas and no
    catch-up: the ack floor is then what loses nothing); the routers
    elect a replica."""
    topo = topology(n_shards=3, replicas=1 + quorum, quorum=quorum)

    def chaos_once(storages):
        victim = busiest_shard(topo, storages[0].db, 6)
        topo.shards[victim].kill_primary(wait_catchup=not quorum)

    result = drive_soak(topo, n_experiments=6, mid_hook=chaos_once, **TINY)
    _assert_soak(result)
    assert result.primary_kills == 1 and result.promotions >= 1, result.summary()


def test_replica_auto_reprovision_heals_a_promoted_shard(topology):
    """A replica and then the primary of one shard die; the router elects
    the surviving replica, its provisioner starts a fresh replica, the
    promoted primary adopts it, and the shard reports every replica
    healthy."""
    topo = topology(n_shards=2, replicas=2)
    provisioner = ReplicaProvisioner()
    router = topo.make_router(replica_reads=False, replica_provisioner=provisioner,
                              reprovision_after=0.5, promote_after=0.3)
    try:
        eid = experiment_id("repro-0", 1, "soak")
        victim = router.shard_for(eid)
        router.write("experiments", {"_id": eid, "name": "repro-0", "version": 1,
                                     "metadata": {"user": "soak"}})
        assert topo.shards[victim].wait_replicated()
        topo.shards[victim].kill_replica(0)
        topo.shards[victim].kill_primary(wait_catchup=False)
        deadline = time.monotonic() + 30.0
        n = 0
        while time.monotonic() < deadline and router.promotions < 1:
            n += 1
            try:
                router.write("trials", {"_id": f"{eid}-t{n}", "experiment": eid,
                                        "status": "new", "params": {"/x": float(n)}})
            except Exception:
                time.sleep(0.05)
        assert router.promotions >= 1, "the election never healed the primary"
        while time.monotonic() < deadline and router.reprovisions < 1:
            time.sleep(0.1)
        assert router.reprovisions >= 1 and provisioner.servers
        assert TELEMETRY.counter_value("storage.shard.reprovisions") >= 1

        def healed():
            for entry in router.replication_health():
                if entry["index"] == victim and not entry.get("error"):
                    rows = entry.get("replicas", [])
                    return bool(rows) and all(not r.get("error") for r in rows)
            return False

        while time.monotonic() < deadline and not healed():
            time.sleep(0.1)
        assert healed(), router.replication_health()
        assert TELEMETRY.gauge_value("storage.reprovision.in_progress", 0.0) == 0.0
    finally:
        router.close()
        provisioner.stop()
