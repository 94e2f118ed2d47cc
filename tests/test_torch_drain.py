"""The port's shard drain (``orion_tpu_torch/storage/drain.py``) against
``orion_tpu.storage.drain``, both over one topology of port servers (the
save / run the reference / load back / run the port discipline of
``test_torch_rebalance.py``): the survivor-ring plan and each shard's ring
share, a full drain and its kept ``moved`` overrides, a crash after each of
pin, copy, verify and flip resumed to the same documents, the refusals,
colliding auto-id telemetry moved by content, the phase gauge, and readers
through a shared router while the drain runs losing nothing."""

import threading
import time

import pytest
from test_torch_netdb import servers  # noqa: F401
from test_torch_rebalance import (
    Crash,
    both,
    crash_once,
    exp_ids,
    plan_rows,
    populate,
    router,
    save,
    shard_state,
    snapshot_docs,
    spec,
)

from orion_tpu.storage import drain as ref_drain
from orion_tpu_torch.core.experiment import experiment_id
from orion_tpu_torch.storage import drain
from orion_tpu_torch.storage.audit import audit_storage
from orion_tpu_torch.storage.base import DocumentStorage
from orion_tpu_torch.storage.documents import dumps_canonical
from orion_tpu_torch.storage.drain import DRAIN_PHASE_AGE_GAUGE, Drainer
from orion_tpu_torch.storage.retry import is_transient
from orion_tpu_torch.storage.shard import PLACEMENT_COLLECTION
from orion_tpu_torch.telemetry import TELEMETRY
from torch_parity import isolated_telemetry

DRAINERS = {"port": drain, "ref": ref_drain}
N_EXPERIMENTS = 12
TRIALS_PER_EXP = 3
NAMES = [f"exp-{e}" for e in range(N_EXPERIMENTS)]


@pytest.fixture
def plane(servers):  # noqa: F811
    """Three port servers holding twelve experiments; the drain targets the
    shard the ring loaded most (ports are random, so a fixed pick could be
    an empty shard).  Returns ``(servers, specs, drained index, saved
    stores)``."""
    started = [servers("port") for _ in range(3)]
    specs = [spec(s) for s in started]
    db = router("port", specs)
    populate(db, NAMES, trials=TRIALS_PER_EXP)
    loads = {index: 0 for index in range(3)}
    for eid in exp_ids(NAMES):
        loads[db.shard_for(eid)] += 1
    db.close()
    return started, specs, max(loads, key=lambda index: loads[index]), save(started)


def _drain(package, specs, index, crash=None, fence_grace=0.05):
    db = router(package, specs)
    try:
        drainer = DRAINERS[package].Drainer(db, index, fence_grace=fence_grace, crash_at=crash)
        plan = drainer.plan()
        rows = plan_rows(plan)
        try:
            drainer.run(plan)
        except Crash:
            return rows, "crashed", None
        return rows, "done", drainer.residual_experiments()
    finally:
        db.close()


def assert_drained(specs, index, names=NAMES, trials=TRIALS_PER_EXP):
    """On the survivor topology every experiment lives on exactly its ring
    home with all its trials, and every survivor's audit is clean."""
    db = router("port", [s for position, s in enumerate(specs) if position != index])
    try:
        homes = {}
        for shard_index, conn in db.shard_connections():
            for doc in conn.read("experiments", {}):
                assert doc["_id"] not in homes, f"{doc['_id']} on two shards"
                homes[doc["_id"]] = shard_index
                assert shard_index == db.shard_for(doc["_id"])
                assert len(conn.read("trials", {"experiment": doc["_id"]})) == trials
            reports = audit_storage(DocumentStorage(conn), lost_timeout=3600.0)
            assert all(r.ok for r in reports), [r.violations for r in reports]
        assert len(homes) == len(names)
        return snapshot_docs(db, names)
    finally:
        db.close()


def test_plan_ring_share_and_full_drain_match_the_reference(plane):
    """Every resident of the drained shard moves to its survivor-ring home
    as in the reference's plan; each shard's ring share is the
    reference's, and the shares sum to 1; the drain leaves the reference's
    documents, ``moved`` overrides on the drained shard that keep routing
    on the old topology, and, once the shard is dropped, every experiment
    on exactly its survivor home with byte-identical documents."""
    started, specs, index, saved = plane
    db = router("port", specs)
    ref_db = router("ref", specs)
    try:
        before = snapshot_docs(db, NAMES)
        shares = [Drainer(db, i, fence_grace=0).ring_share() for i in range(3)]
        assert shares == [ref_drain.Drainer(ref_db, i, fence_grace=0).ring_share()
                          for i in range(3)]
        assert all(s > 0 for s in shares) and sum(shares) == pytest.approx(1.0, abs=1e-12)
        resident = sum(1 for eid in exp_ids(NAMES) if db.shard_for(eid) == index)
    finally:
        db.close()
        ref_db.close()
    want, got, ref_out, port_out = both(started, saved, lambda p: _drain(p, specs, index))
    assert port_out == ref_out and got == want
    moves, stays, strays, _summary = port_out[0]
    assert len(moves) == resident > 0 and stays == N_EXPERIMENTS - resident and not strays
    assert port_out[1:] == ("done", [])
    overrides = started[index].db.read(PLACEMENT_COLLECTION, {})
    assert len(overrides) == resident and all(d["state"] == "moved" for d in overrides)
    db = router("port", specs)
    try:
        assert snapshot_docs(db, NAMES) == before
    finally:
        db.close()
    assert assert_drained(specs, index) == before


@pytest.mark.parametrize("stage", ["after_pin", "after_copy", "after_verify", "after_flip"])
def test_crash_and_resume_match_the_reference(plane, stage):
    """The drain crashes the first time it reaches ``stage``; a fresh
    drainer plans from the standing placement docs and resumes: the
    crashed and the final documents are the reference's, and the survivors
    end byte-identical to the documents before the drain."""
    started, specs, index, saved = plane
    db = router("port", specs)
    before = snapshot_docs(db, NAMES)
    db.close()
    crashed = {}

    def run(package):
        hook = crash_once(stage)
        first = _drain(package, specs, index, crash=hook)
        crashed[package] = shard_state(started)
        return hook.fired, first, _drain(package, specs, index)

    want, got, ref_out, port_out = both(started, saved, run)
    assert port_out == ref_out and got == want
    fired, first, resumed = port_out
    assert fired and first[1] == "crashed" and resumed[1:] == ("done", [])
    assert crashed["port"] == crashed["ref"]
    assert assert_drained(specs, index) == before


def _refusals(package, specs, index):
    module = DRAINERS[package]
    out = []
    db = router(package, specs[:1])
    try:
        for bad in (0, 7):
            with pytest.raises(Exception) as err:
                module.Drainer(db, bad)
            out.append((type(err.value).__name__, str(err.value)))
    finally:
        db.close()
    db = router(package, specs)
    try:
        drainer = module.Drainer(db, index, fence_grace=0)
        plan = drainer.plan()
        with pytest.raises(Exception, match="stray") as err:
            drainer.run(plan)
        out.append((plan_rows(plan), type(err.value).__name__))
    finally:
        db.close()
    return out


def test_refusals_match_the_reference(plane):
    """Both packages refuse the only shard and an index past the topology
    with the same error, list a resident experiment ring-homed elsewhere
    (a pending rebalance) as a stray, and refuse to run until it is
    resolved."""
    started, specs, index, saved = plane
    db = router("port", specs)
    e = 0
    while db.shard_for(experiment_id(f"stray-{e}", 1, "u")) == index:
        e += 1
    stray_id = experiment_id(f"stray-{e}", 1, "u")
    dict(db.shard_connections())[index].write(
        "experiments", {"_id": stray_id, "name": f"stray-{e}", "version": 1,
                        "metadata": {"user": "u"}})
    db.close()
    want, got, ref_out, port_out = both(started, save(started),
                                        lambda p: _refusals(p, specs, index))
    assert port_out == ref_out and got == want
    assert port_out[0][0] == "DatabaseError" and "only shard" in port_out[0][1]
    assert "no shard at index 7" in port_out[1][1]
    rows, raised = port_out[2]
    assert [s[0] for s in rows[2]] == [stray_id] and raised == "DatabaseError"
    assert all(m[0] != stray_id for m in rows[0])


def _colliding(package, specs, index, exp_id):
    db = router(package, specs)
    try:
        drainer = DRAINERS[package].Drainer(db, index, fence_grace=0)
        plan = drainer.plan()
        drainer.run(plan)
        move = next(m for m in plan.moves if m.exp_id == exp_id)
        conns = dict(db.shard_connections())
        return (sorted(dumps_canonical({k: v for k, v in d.items() if k != "_id"})
                       for d in conns[move.dst_index].read(
                           "telemetry", {"experiment": move.exp_id})),
                conns[move.src_index].read("telemetry", {"experiment": move.exp_id}))
    finally:
        db.close()


def test_colliding_auto_id_telemetry_moves_by_content_like_the_reference(plane):
    """Telemetry ids are per-shard auto-increment counters, so a moved row
    can collide on ``_id`` with another experiment's row on the
    destination: both packages move the rows by content (the destination
    gives them fresh ids), losing and duplicating none."""
    started, specs, index, _saved = plane
    db = router("port", specs)
    conns = dict(db.shard_connections())
    # A move whose destination already holds an experiment (ports are
    # random, so the first move's destination may hold none).
    move, resident = next(
        (m, docs[0]["_id"]) for m in Drainer(db, index, fence_grace=0).plan().moves
        for docs in [conns[m.dst_index].read("experiments", {})] if docs)
    rows = [{"experiment": move.exp_id, "op": "suggest", "duration": 0.25 * (i + 1),
             "count": i + 1, "time": 100.0 + i} for i in range(3)]
    for row in rows:
        conns[move.src_index].write("telemetry", dict(row))
    for i in range(3):
        conns[move.dst_index].write("telemetry", {"experiment": resident, "op": "observe",
                                                  "duration": 0.5, "count": i,
                                                  "time": 200.0 + i})
    db.close()
    want, got, ref_out, port_out = both(started, save(started),
                                        lambda p: _colliding(p, specs, index, move.exp_id))
    assert port_out == ref_out and got == want
    moved, left = port_out
    expected = sorted(dumps_canonical(row) for row in rows)
    assert [m for m in moved if m in expected] == expected and left == []
    assert assert_drained(specs, index)


def test_phase_gauge_resets_on_each_phase_and_grows_with_a_stall(plane):
    started, specs, index, _saved = plane
    db = router("port", specs)
    try:
        with isolated_telemetry():
            drainer = Drainer(db, index, fence_grace=0)
            drainer._note_phase("pin_copy")
            assert TELEMETRY.gauge_value(DRAIN_PHASE_AGE_GAUGE) == 0.0
            name, age = drainer.phase()
            assert name == "pin_copy" and age >= 0.0
            time.sleep(0.05)
            drainer._note_progress()
            assert TELEMETRY.gauge_value(DRAIN_PHASE_AGE_GAUGE) >= 0.05
            drainer._note_phase("verify_flip")
            assert TELEMETRY.gauge_value(DRAIN_PHASE_AGE_GAUGE) == 0.0
            drainer.run()
            assert drainer.phase()[0] is None
    finally:
        db.close()


def test_readers_through_a_shared_router_lose_nothing_while_a_drain_runs(plane):
    """Four threads read and count through the router the drainer uses
    while it migrates, the fence grace covering the placement TTL: every
    error they see is transient (the fence), every read finds all of its
    experiment's trials, and every document survives byte-identical."""
    started, specs, index, _saved = plane
    db = router("port", specs)
    before = snapshot_docs(db, NAMES)
    stop, errors, reads = threading.Event(), [], []

    def traffic(seed):
        eids = exp_ids(NAMES)
        n = 0
        while not stop.is_set():
            eid = eids[(seed + n) % len(eids)]
            n += 1
            try:
                docs = db.read("trials", {"experiment": eid})
                if len(docs) != TRIALS_PER_EXP:
                    errors.append(("short read", eid, len(docs)))
                reads.append(db.count("experiments", {"_id": eid}))
            except Exception as exc:
                if not is_transient(exc):
                    errors.append(exc)
                    return
                time.sleep(0.01)

    threads = [threading.Thread(target=traffic, args=(seed,), daemon=True) for seed in range(4)]
    for thread in threads:
        thread.start()
    try:
        drainer = Drainer(db, index, fence_grace=0.25)
        drainer.run(drainer.plan())
        assert drainer.residual_experiments() == []
    finally:
        stop.set()
        for thread in threads:
            thread.join(timeout=10.0)
        assert not any(thread.is_alive() for thread in threads)
    try:
        assert not errors, errors[:3]
        assert reads and set(reads) == {1}
        assert snapshot_docs(db, NAMES) == before
    finally:
        db.close()
    assert assert_drained(specs, index) == before
