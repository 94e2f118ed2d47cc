"""The port's sharded router (``orion_tpu_torch.storage.shard``) against
``orion_tpu.storage.shard``: the md5 ring's placements, the shard specs and
minted ids, routing and fan-out over the same servers, the single-shard
pass-through on the wire, replica reads (stale-read and failover counters),
degraded mode, promotion and the replication-lag gauges.

Servers bind port 0 and are shut down by the ``servers`` fixture; every
wait has a deadline, and promotion runs with a short ``promote_after``."""

import socketserver
import time

import pytest
from test_torch_netdb import _client, _stop, _wait_for, servers  # noqa: F401

from orion_tpu.storage import shard as ref_shard
from orion_tpu.storage.faults import FaultProxy
from orion_tpu_torch.core.experiment import experiment_id
from orion_tpu_torch.storage import shard
from orion_tpu_torch.storage.base import DocumentStorage
from orion_tpu_torch.storage.netdb import NetworkDB
from orion_tpu_torch.storage.shard import HashRing
from orion_tpu_torch.utils.exceptions import DatabaseError

ROUTERS = {"port": shard.ShardedNetworkDB, "ref": ref_shard.ShardedNetworkDB}


def _router(specs, package="port", **kwargs):
    kwargs.setdefault("reconnect_jitter", 0)
    kwargs.setdefault("timeout", 5.0)
    return ROUTERS[package](specs, **kwargs)


def _addresses(started):
    return ["%s:%s" % s.address for s in started]


def _hard_kill(server):
    """Kill without the graceful final replica flush — a crashed box."""
    server._stop_flusher.set()
    for link in server._repl_links:
        link.stop(flush=False)
    if getattr(server, "_serving", False):
        socketserver.ThreadingTCPServer.shutdown(server)
    server.close_connections()
    server.server_close()


# --- the ring, the specs, the minted ids -------------------------------------


def test_ring_places_every_key_like_the_reference():
    """1000 experiment ids over 3 shards land where the reference's ring
    puts them; with a 4th shard they land where its 4-shard ring does, and
    only the keys the new shard takes move (about a quarter)."""
    ids = [experiment_id(f"exp-{i}", 1 + i % 3, "user") for i in range(1000)]
    three = ["127.0.0.1:7001", "127.0.0.1:7002", "127.0.0.1:7003"]
    before = [HashRing(three).lookup(k) for k in ids]
    assert before == [ref_shard.HashRing(three).lookup(k) for k in ids]
    after = [HashRing(three + ["127.0.0.1:7004"]).lookup(k) for k in ids]
    assert after == [ref_shard.HashRing(three + ["127.0.0.1:7004"]).lookup(k) for k in ids]
    moved = [i for i, (b, a) in enumerate(zip(before, after)) if a != b]
    assert all(after[i] == 3 for i in moved)
    assert 180 < len(moved) < 320
    for vnodes in (1, 8, 128):
        assert ([HashRing(three, vnodes).lookup(k) for k in ids[:100]]
                == [ref_shard.HashRing(three, vnodes).lookup(k) for k in ids[:100]])


def test_shard_specs_and_minted_ids_match_the_reference():
    stanza = ["10.0.0.1:7001",
              {"address": "10.0.0.2:7002", "replicas": ["10.0.0.3:8001", ("10.0.0.4", 8002)]},
              {"host": "10.0.0.5", "port": 7003, "secret": "s"}]
    assert (shard.parse_shard_specs(stanza, default_secret="d")
            == ref_shard.parse_shard_specs(stanza, default_secret="d"))
    for bad in (["no-port"], [], [{"host": "x"}]):
        with pytest.raises(DatabaseError):
            shard.parse_shard_specs(bad)
    for doc in ({"name": "exp", "version": 2, "metadata": {"user": "alice"}},
                {"name": "exp"}, {"name": "é", "metadata": {}}):
        assert shard.mint_experiment_id(doc) == ref_shard.mint_experiment_id(doc)
    dirty = DatabaseError("y")
    dirty.maybe_applied = True
    error = shard.shard_fanout_error("boom", [DatabaseError("x"), dirty])
    assert error.maybe_applied is True and "boom" in str(error)
    assert shard.placement_doc_id("e1") == ref_shard.placement_doc_id("e1")
    assert (shard.PLACEMENT_COLLECTION, shard.DEFAULT_PROMOTE_AFTER_S, shard.PLACEMENT_TTL_S) \
        == (ref_shard.PLACEMENT_COLLECTION, ref_shard.DEFAULT_PROMOTE_AFTER_S,
            ref_shard.PLACEMENT_TTL_S)


# --- routing and fan-out ------------------------------------------------------


def test_routers_of_both_packages_agree_over_the_same_servers(servers):
    """Experiments and trials written through the port's router live on the
    shard the reference's router names; each router reads the other's
    writes; the fan-out ``fetch_experiments`` and every count agree."""
    started = [servers("port") for _ in range(3)]
    port = _router(_addresses(started))
    ref = _router(_addresses(started), "ref")
    exp_ids = [experiment_id(f"exp-{i}", 1, "u") for i in range(8)]
    for i, exp_id in enumerate(exp_ids):
        writer = port if i % 2 else ref
        writer.write("experiments", {"_id": exp_id, "name": f"exp-{i}", "version": 1,
                                     "metadata": {"user": "u"}})
        writer.write("trials", [{"_id": f"t{i}-{k}", "experiment": exp_id,
                                 "status": "new"} for k in range(3)])
    for exp_id in exp_ids:
        assert port.shard_for(exp_id) == ref.shard_for(exp_id)
        direct = _client(started[port.shard_for(exp_id)])
        assert direct.count("trials", {"experiment": exp_id}) == 3
    assert len({port.shard_for(e) for e in exp_ids}) > 1
    key = lambda d: d["_id"]  # noqa: E731
    assert (sorted(DocumentStorage(port).fetch_experiments({}), key=key)
            == sorted(ref.read("experiments", {}), key=key))
    assert port.count("trials", {}) == ref.count("trials", {}) == 24
    doc = port.read_and_write("trials", {"experiment": exp_ids[0], "status": "new"},
                              {"status": "reserved"})
    assert ref.read("trials", {"_id": doc["_id"]})[0]["status"] == "reserved"
    assert port.describe_topology() == ref.describe_topology()


def test_router_batches_split_by_shard_in_slot_order(servers):
    started = [servers("port") for _ in range(3)]
    router = _router(_addresses(started))
    exp_ids = [experiment_id(f"b{i}", 1, "u") for i in range(6)]
    assert len({router.shard_for(e) for e in exp_ids}) > 1
    ops = ([("write", ["trials", {"_id": f"t{i}", "experiment": e}], {})
            for i, e in enumerate(exp_ids)]
           + [("count", ["trials", {"experiment": e}], {}) for e in exp_ids])
    assert router.apply_batch(ops)[6:] == [1] * 6
    # An id-only CAS on a cold router finds the doc by fan-out, then routes.
    cold = _router(_addresses(started))
    assert cold.read_and_write("trials", {"_id": "t0"}, {"status": "x"})["status"] == "x"
    fan_outs = cold.fan_outs
    cold.read_and_write("trials", {"_id": "t0"}, {"status": "y"})
    assert cold.fan_outs == fan_outs
    with pytest.raises(DatabaseError) as err:
        router.read_and_write("trials", {"status": "y"}, {"status": "z"})  # unroutable
    assert err.value.maybe_applied is False


def _drive_contract(db):
    db.ensure_indexes([["trials", ["experiment"], False], ["experiments", ["name"], True]])
    db.write("experiments", {"_id": "e1", "name": "n"})
    db.write("trials", [{"_id": "t1", "experiment": "e1", "status": "new"}])
    db.read("trials", {"experiment": "e1"})
    db.read_and_write("trials", {"_id": "t1", "status": "new"}, {"status": "reserved"})
    db.count("trials", {"experiment": "e1", "status": "reserved"})
    db.apply_batch([("write", ["trials", {"_id": "t2", "experiment": "e1"}], {}),
                    ("read", ["trials", {"experiment": "e1"}], {})])
    db.pipeline([("count", ["trials", {"experiment": "e1"}], {}),
                 ("read", ["trials", {"_id": "t2"}], {})])
    db.update_many("trials", [({"experiment": "e1"}, {"tag": 1})])
    db.remove("trials", {"_id": "t2"})
    db.index_information("trials")
    db.ping()


def test_single_shard_router_puts_the_reference_bytes_on_the_wire(servers):
    """A one-shard, replica-less router sends exactly what a plain client
    sends, and both are what the reference's router sends."""
    streams = []
    for make in (lambda h, p: NetworkDB(host=h, port=p, reconnect_jitter=0),
                 lambda h, p: _router([f"{h}:{p}"]),
                 lambda h, p: _router([f"{h}:{p}"], "ref")):
        proxy = FaultProxy(*servers("port").address)
        proxy.capture = True
        db = make(*proxy.serve_background())
        _drive_contract(db)
        db.close()
        size = -1
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and len(proxy.captured_up) != size:
            size = len(proxy.captured_up)
            time.sleep(0.05)
        streams.append(bytes(proxy.captured_up))
        proxy.stop()
    assert streams[0] == streams[1] == streams[2]


# --- replica reads --------------------------------------------------------------


@pytest.mark.parametrize("package", ["port", "ref"])
def test_stale_replica_reads_fail_over_and_count_like_the_reference(servers, package):
    """A replica outside the stream is stale once the router wrote through
    the replicating primary: each read comes from the primary and counts a
    stale read; a dead replica counts a failover and is benched.  The port's
    router and the reference's give the same counts."""
    live = servers("port", replica=True)
    stale = servers("port", replica=True)
    primary = servers("port", replicate_to=[live.address])
    router = _router([{"host": primary.address[0], "port": primary.address[1],
                       "replicas": [stale.address]}], package)
    router.write("trials", [{"_id": "t1", "experiment": "e1"}])
    for _ in range(3):
        assert [d["_id"] for d in router.read("trials", {"experiment": "e1"})] == ["t1"]
    counts = [router.replica_stale_reads, router.failovers]
    dead = servers("port", serve=False, replica=True)
    dead_addr = dead.address
    _stop(dead)
    plain = servers("port")
    router2 = _router([{"host": plain.address[0], "port": plain.address[1],
                        "replicas": [dead_addr]}], package, timeout=2.0)
    router2.write("trials", [{"_id": "t1", "experiment": "e1"}])
    router2.read("trials", {"experiment": "e1"})
    router2.read("trials", {"experiment": "e1"})  # benched: no second failover
    counts += [router2.failovers, router2.replica_stale_reads]
    assert counts == [3, 0, 1, 0]


def test_caught_up_replica_serves_reads(servers):
    replica = servers("port", replica=True)
    primary = servers("port", replicate_to=[replica.address])
    router = _router([{"host": primary.address[0], "port": primary.address[1],
                       "replicas": [replica.address]}])
    router.write("trials", [{"_id": "t1", "experiment": "e1"}])
    _wait_for(lambda: replica.seq_info()["seq"] == 1)
    before = router.replica_stale_reads
    assert [d["_id"] for d in router.read("trials", {"experiment": "e1"})] == ["t1"]
    assert router.replica_stale_reads == before


def test_dead_shard_degrades_without_a_global_stall(servers):
    started = [servers("port") for _ in range(3)]
    router = _router(_addresses(started), timeout=1.0,
                     shard_retry={"max_attempts": 2, "base_delay": 0.01, "deadline": 1.0})
    exp_ids = [experiment_id(f"d{i}", 1, "u") for i in range(9)]
    for exp_id in exp_ids:
        router.write("trials", [{"_id": f"t-{exp_id}", "experiment": exp_id}])
    dead = router.shard_for(exp_ids[0])
    _stop(started[dead])
    healthy = [e for e in exp_ids if router.shard_for(e) != dead]
    assert healthy
    for exp_id in healthy:
        assert router.count("trials", {"experiment": exp_id}) == 1
    with pytest.raises((DatabaseError, OSError)):
        router.count("trials", {"experiment": exp_ids[0]})
    with pytest.raises(DatabaseError) as err:
        router.read("experiments", {})
    assert getattr(err.value, "maybe_applied", False) is False


# --- promotion --------------------------------------------------------------


def _heal(router, doc, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            router.write("trials", doc)
            return True
        except Exception:
            time.sleep(0.05)
    return False


def test_router_elects_the_most_caught_up_replica(servers):
    behind = servers("port", replica=True)
    ahead = servers("port", replica=True)
    primary = servers("port", replicate_to=[behind.address, ahead.address])
    router = _router([{"host": primary.address[0], "port": primary.address[1],
                       "replicas": [behind.address, ahead.address]}],
                     timeout=2.0, promote_after=0.2)
    router.write("trials", [{"_id": f"t{i}", "experiment": "e"} for i in range(4)])
    _wait_for(lambda: ahead.seq_info()["seq"] == behind.seq_info()["seq"] == 1)
    _stop(behind)
    _hard_kill(primary)
    assert _heal(router, {"_id": "t-heal", "experiment": "e"}), "no promotion"
    assert router.promotions >= 1
    assert ahead.seq_info()["replica"] is False and ahead.seq_info()["epoch"] == 2
    assert len(router.read("trials", {"experiment": "e"})) == 5
    assert router.describe_topology()["shards"][0]["primary"] == "%s:%s" % ahead.address


def test_reborn_stale_primary_demotes_and_resyncs(servers, tmp_path):
    persist = str(tmp_path / "p.pkl")
    replica = servers("port", replica=True)
    primary = servers("port", persist=persist, persist_interval=0.05,
                      replicate_to=[replica.address])
    port = primary.address[1]
    writer = _client(primary)
    writer.write("trials", [{"_id": f"t{i}", "experiment": "e"} for i in range(3)])
    _wait_for(lambda: replica.seq_info()["seq"] == primary.seq_info()["seq"])
    writer.close()
    time.sleep(0.15)  # the flusher's snapshot
    _hard_kill(primary)
    promoter = _client(replica)
    assert promoter._call("promote", {"epoch": 2,
                                      "replicate_to": [("127.0.0.1", port)]})["promoted"]
    promoter.write("trials", {"_id": "t-after", "experiment": "e"})
    reborn = servers("port", serve=False, host="127.0.0.1", port=port, persist=persist,
                     persist_interval=0.05, replicate_to=[replica.address])
    assert reborn.seq_info()["epoch"] == 1
    reborn.serve_background()
    _wait_for(lambda: reborn.seq_info()["replica"], message="never demoted")
    stale = _client(reborn)
    with pytest.raises(DatabaseError) as err:
        stale.write("trials", {"_id": "fork", "experiment": "e"})
    assert err.value.not_primary is True
    _wait_for(lambda: not reborn.seq_info()["resyncing"]
              and reborn.seq_info()["epoch"] == 2
              and reborn.seq_info()["seq"] == replica.seq_info()["seq"],
              message="demoted primary never resynced")
    assert sorted(d["_id"] for d in stale.read("trials", {"experiment": "e"})) == [
        "t-after", "t0", "t1", "t2"]


# --- replication-lag gauges -----------------------------------------------------


def test_replication_health_and_lag_gauges(servers):
    from torch_parity import isolated_telemetry

    with isolated_telemetry() as (telemetry, *_):
        replica = servers("port", replica=True)
        primary = servers("port", replicate_to=[replica.address], quorum=1)
        router = _router([{"host": primary.address[0], "port": primary.address[1],
                           "replicas": [replica.address]}])
        ref = _router([{"host": primary.address[0], "port": primary.address[1],
                        "replicas": [replica.address]}], "ref")
        router.write("trials", [{"_id": "t1", "experiment": "e"}])
        health = router.replication_health()
        assert health == ref.replication_health()
        [entry] = health
        assert entry["quorum"] == 1 and entry["replicas"][0]["lag"] == 0
        shard.sample_replication_lag(force=True)
        gauges = telemetry.snapshot()["gauges"]
        assert gauges["netdb.replication.lag.s0"] == 0
        assert gauges["netdb.replication.epoch.s0"] == 1
