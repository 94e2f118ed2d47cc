"""The port's live rebalancer (``orion_tpu_torch/storage/rebalance.py``)
against ``orion_tpu.storage.rebalance``, both driven over ONE topology of
port servers: shard identities carry the ports the OS picked, so two
topologies would place experiments differently.  Each comparison saves the
servers' stores, runs the reference's tool (its router over the port's
servers: the wire is the same), reads every shard's canonical documents,
loads the saved stores back into the same servers, runs the port's tool and
compares.  Covered: the plan (moves, stays, strays, summary), a full run,
a crash after each of pin, copy, fence, verify and flip resumed to the same
documents, the fence's transient error, the placement TTL cache and its
invalidation on a miss.

Every server binds port 0 and is stopped by the ``servers`` fixture; every
wait has a deadline.  ``test_torch_drain.py`` and ``test_torch_backup.py``
use the helpers here."""

import copy
import time

import pytest
from test_torch_netdb import servers  # noqa: F401

from orion_tpu.storage import rebalance as ref_rebalance
from orion_tpu.storage import shard as ref_shard
from orion_tpu.storage.retry import is_transient as ref_is_transient
from orion_tpu_torch.core.experiment import experiment_id
from orion_tpu_torch.storage import rebalance, shard
from orion_tpu_torch.storage.audit import audit_storage
from orion_tpu_torch.storage.base import DocumentStorage
from orion_tpu_torch.storage.documents import dumps_canonical
from orion_tpu_torch.storage.retry import is_transient
from orion_tpu_torch.storage.shard import PLACEMENT_COLLECTION, HashRing, placement_doc_id

ROUTERS = {"port": shard, "ref": ref_shard}
REBALANCERS = {"port": rebalance, "ref": ref_rebalance}
N_EXPERIMENTS = 12
TRIALS_PER_EXP = 4
STAGES = ["after_pin", "after_copy", "after_fence", "after_verify", "after_flip"]


class Crash(RuntimeError):
    pass


def crash_once(stage):
    """A ``crash_at`` hook raising :class:`Crash` the first time ``stage``
    is reached."""
    fired = []

    def hook(at, exp_id):
        if at == stage and not fired:
            fired.append(exp_id)
            raise Crash(f"injected crash {at} for {exp_id}")

    hook.fired = fired
    return hook


def spec(server):
    return {"host": server.address[0], "port": server.address[1]}


def identity(server):
    return "%s:%s" % server.address


def router(package, specs, **kwargs):
    kwargs.setdefault("reconnect_jitter", 0)
    kwargs.setdefault("timeout", 5.0)
    kwargs.setdefault("placement_ttl", 0.2)
    return ROUTERS[package].ShardedNetworkDB(specs, **kwargs)


def exp_ids(names):
    return [experiment_id(name, 1, "u") for name in names]


def populate(db, names, trials=TRIALS_PER_EXP):
    """Each experiment with its trials and two auto-id telemetry rows."""
    for name, eid in zip(names, exp_ids(names)):
        db.write("experiments", {"_id": eid, "name": name, "version": 1,
                                 "metadata": {"user": "u"}})
        db.write("trials", [{
            "_id": f"{eid}-t{i}", "experiment": eid, "status": "completed",
            "objective": float(i), "params": {"/x": float(i)},
            "results": [{"name": "obj", "type": "objective", "value": float(i)}],
            "submit_time": 1.0, "start_time": 1.0, "end_time": 2.0, "heartbeat": 2.0,
        } for i in range(trials)])
        db.write("telemetry", [{"experiment": eid, "worker": "w0", "kind": "t", "n": i}
                               for i in range(2)])


def save(started):
    """Every server's store, deep-copied (auto-id counters included), with
    its replication position."""
    out = []
    for server in started:
        with server._repl_lock, server.db._lock:
            out.append((copy.deepcopy(server.db._collections), server.seq, server.epoch))
    return out


def load(started, saved):
    for server, (collections, seq, epoch) in zip(started, saved):
        with server._repl_lock, server.db._lock:
            server.db._collections = copy.deepcopy(collections)
            server.seq, server.epoch = seq, epoch


def shard_state(started):
    """Every server's canonical documents by collection (placement docs
    without their wall-clock ``ts``; the replication bookkeeping left out)."""
    out = []
    for server in started:
        state = {}
        for name in server.db.collection_names():
            if name == "_replmeta":
                continue
            docs = server.db.read(name, {})
            if name == PLACEMENT_COLLECTION:
                docs = [{k: v for k, v in d.items() if k != "ts"} for d in docs]
            state[name] = sorted(dumps_canonical(d) for d in docs)
        out.append(state)
    return out


def both(started, saved, run):
    """``run(package)`` for the reference, then (the stores loaded back) for
    the port; returns ``(reference state, port state, reference result,
    port result)``."""
    load(started, saved)
    ref_out = run("ref")
    want = shard_state(started)
    load(started, saved)
    port_out = run("port")
    return want, shard_state(started), ref_out, port_out


def plan_rows(plan):
    return ([(m.exp_id, m.name, m.version, m.src_index, m.dst_index, m.state, m.describe())
             for m in plan.moves], plan.stays, plan.strays, plan.summary())


def snapshot_docs(db, names):
    """Canonical documents of ``names`` read through ``db``; telemetry as a
    per-experiment content multiset (it moves by content, not by id)."""
    by_id = {}
    for eid in exp_ids(names):
        for collection, query in (("trials", {"experiment": eid}), ("experiments", {"_id": eid})):
            for doc in db.read(collection, query):
                by_id[doc["_id"]] = dumps_canonical(doc)
        by_id[f"telemetry:{eid}"] = sorted(
            dumps_canonical({k: v for k, v in doc.items() if k != "_id"})
            for doc in db.read("telemetry", {"experiment": eid}))
    return by_id


def assert_exactly_once(db, count, trials=TRIALS_PER_EXP):
    """Every experiment on exactly its ring home with all its trials, no
    placement doc left, every shard's audit clean."""
    homes = {}
    for index, conn in db.shard_connections():
        assert conn.read(PLACEMENT_COLLECTION, {}) == []
        for doc in conn.read("experiments", {}):
            assert doc["_id"] not in homes, f"{doc['_id']} on two shards"
            homes[doc["_id"]] = index
            assert index == db.shard_for(doc["_id"])
            assert len(conn.read("trials", {"experiment": doc["_id"]})) == trials
        reports = audit_storage(DocumentStorage(conn), lost_timeout=3600.0)
        assert all(r.ok for r in reports), [r.violations for r in reports]
    assert len(homes) == count


def pick_names(identities3, identities4, count=N_EXPERIMENTS):
    """Names whose 3-ring and 4-ring homes differ for at least two and
    agree for the rest: ports are random, so a fixed list could hash
    entirely onto the survivors."""
    ring3, ring4 = HashRing(identities3), HashRing(identities4)
    movers, stayers = [], []
    for e in range(400):
        eid = experiment_id(f"exp-{e}", 1, "u")
        (movers if ring3.lookup(eid) != ring4.lookup(eid) else stayers).append(f"exp-{e}")
        if len(movers) >= 2 and len(stayers) >= count - 2:
            break
    assert len(movers) >= 2, "no movers in 400 draws"
    return movers[:2] + stayers[:count - 2]


@pytest.fixture
def plane(servers):  # noqa: F811
    """Four port servers; twelve experiments written through a three-shard
    router, at least two of which the four-shard ring moves.  Returns
    ``(servers, spec3, spec4, names, saved stores)``."""
    started = [servers("port") for _ in range(4)]
    specs = [spec(s) for s in started]
    names = pick_names([identity(s) for s in started[:3]], [identity(s) for s in started])
    db = router("port", specs[:3])
    populate(db, names)
    db.close()
    return started, specs[:3], specs, names, save(started)


def _rebalance(package, specs, crash=None, fence_grace=0.05):
    db = router(package, specs)
    try:
        rebalancer = REBALANCERS[package].Rebalancer(db, fence_grace=fence_grace,
                                                     crash_at=crash)
        plan = rebalancer.plan()
        rows = plan_rows(plan)
        try:
            rebalancer.run(plan)
        except Crash:
            return rows, "crashed"
        return rows, "done"
    finally:
        db.close()


def test_plan_and_full_run_match_the_reference(plane):
    """The four-shard plan is the reference's (moves, stays, strays,
    summary, each move's description); the full run leaves every shard
    with the reference's documents, moves nothing else, keeps every
    experiment's documents byte-identical (telemetry by content) and
    leaves each experiment on exactly its ring home; a second plan is
    empty."""
    started, spec3, spec4, names, saved = plane
    db = router("port", spec3)
    before = snapshot_docs(db, names)
    db.close()
    want, got, ref_out, port_out = both(started, saved, lambda p: _rebalance(p, spec4))
    assert port_out == ref_out and port_out[1] == "done"
    moves, stays, strays, summary = port_out[0]
    assert len(moves) >= 2 and stays == N_EXPERIMENTS - len(moves) and not strays
    assert summary["move_fraction"] <= 2.5 / 4
    assert got == want
    db = router("port", spec4)
    try:
        assert snapshot_docs(db, names) == before
        assert_exactly_once(db, N_EXPERIMENTS)
        again = rebalance.Rebalancer(db, fence_grace=0).plan()
        assert not again.moves and not again.strays and again.stays == N_EXPERIMENTS
    finally:
        db.close()


@pytest.mark.parametrize("stage", STAGES)
def test_crash_and_resume_match_the_reference(plane, stage):
    """The migrator crashes the first time it reaches ``stage``: the
    standing placement docs and copies are the reference's, the next run
    plans from them as the reference's does, and the resumed run ends with
    the reference's documents, byte-identical to those before the move."""
    started, spec3, spec4, names, saved = plane
    db = router("port", spec3)
    before = snapshot_docs(db, names)
    db.close()
    crashed = {}

    def run(package):
        hook = crash_once(stage)
        first = _rebalance(package, spec4, crash=hook)
        crashed[package] = shard_state(started)
        resumed = _rebalance(package, spec4)
        return hook.fired, first, resumed

    want, got, ref_out, port_out = both(started, saved, run)
    assert port_out == ref_out
    fired, first, resumed = port_out
    assert fired and first[1] == "crashed" and resumed[1] == "done"
    assert crashed["port"] == crashed["ref"]
    assert got == want
    db = router("port", spec4)
    try:
        assert snapshot_docs(db, names) == before
        assert_exactly_once(db, N_EXPERIMENTS)
    finally:
        db.close()


def _fence(package, specs, move, started):
    db = router(package, specs)
    conns = dict(db.shard_connections())
    try:
        conns[move[4]].write(PLACEMENT_COLLECTION, {
            "_id": placement_doc_id(move[0]), "experiment": move[0], "state": "fenced",
            "shard": identity(started[move[3]]), "ts": time.time()})
        with pytest.raises(Exception) as err:
            db.read("trials", {"experiment": move[0]})
        transient = (is_transient if package == "port" else ref_is_transient)(err.value)
        # Lifting the fence (back to pinned) heals at once: fenced lookups
        # are never cached.
        conns[move[4]].write(PLACEMENT_COLLECTION, {"state": "pinned"},
                             query={"_id": placement_doc_id(move[0])})
        healed = len(db.read("trials", {"experiment": move[0]}))
        return (type(err.value).__name__, str(err.value), transient,
                getattr(err.value, "maybe_applied", True), healed)
    finally:
        db.close()


def test_a_fenced_experiment_gets_a_transient_error_like_the_reference(plane):
    started, spec3, spec4, names, saved = plane
    db = router("port", spec4)
    move = plan_rows(rebalance.Rebalancer(db, fence_grace=0).plan())[0][0]
    db.close()
    want, got, ref_out, port_out = both(started, saved,
                                        lambda p: _fence(p, spec4, move, started))
    assert port_out == ref_out and got == want
    assert port_out[0] == "DatabaseError" and "fenced" in port_out[1]
    assert port_out[2:] == (True, False, TRIALS_PER_EXP)


def test_placement_cache_ttl_and_invalidation_on_a_miss(plane):
    """A router routes by a cached override until its TTL expires or an
    override-routed read comes back empty; then it reads the placement
    again and finds the moved documents."""
    started, spec3, spec4, names, saved = plane
    db = router("port", spec4)
    try:
        exp_id, _, _, src, dst = plan_rows(rebalance.Rebalancer(db, fence_grace=0).plan())[0][0][:5]
        conns = dict(db.shard_connections())
        conns[dst].write(PLACEMENT_COLLECTION, {
            "_id": placement_doc_id(exp_id), "experiment": exp_id, "state": "pinned",
            "shard": identity(started[src]), "ts": time.time()})
        assert len(db.read("trials", {"experiment": exp_id})) == TRIALS_PER_EXP
        for collection in ("trials", "telemetry"):
            for doc in conns[src].read(collection, {"experiment": exp_id}):
                conns[dst].write(collection, doc)
            conns[src].remove(collection, {"experiment": exp_id})
        for doc in conns[src].read("experiments", {"_id": exp_id}):
            conns[dst].write("experiments", doc)
        conns[src].remove("experiments", {"_id": exp_id})
        conns[dst].remove(PLACEMENT_COLLECTION, {"_id": placement_doc_id(exp_id)})
        first = db.read("trials", {"experiment": exp_id})
        healed = db.read("trials", {"experiment": exp_id})
        assert first == [] and len(healed) == TRIALS_PER_EXP
    finally:
        db.close()


def test_a_stray_is_planned_and_refused_like_the_reference(plane):
    """An experiment found on two shards with no placement record is a
    stray in both packages' plans, and ``run`` refuses to start."""
    started, spec3, spec4, names, saved = plane
    eid = exp_ids(names)[-1]
    db = router("port", spec4)
    home = db.shard_for(eid)
    other = (home + 1) % 4
    dict(db.shard_connections())[other].write(
        "experiments", {"_id": eid, "name": names[-1], "version": 1, "metadata": {"user": "u"}})
    db.close()
    strays = {}

    def run(package):
        db = router(package, spec4)
        try:
            migrator = REBALANCERS[package].Rebalancer(db, fence_grace=0)
            plan = migrator.plan()
            strays[package] = plan_rows(plan)
            with pytest.raises(Exception, match="stray") as err:
                migrator.run(plan)
            return type(err.value).__name__
        finally:
            db.close()

    stored = save(started)
    want, got, ref_out, port_out = both(started, stored, run)
    assert port_out == ref_out == "DatabaseError" and got == want
    assert strays["port"] == strays["ref"]
    assert [s[0] for s in strays["port"][2]] == [eid]
