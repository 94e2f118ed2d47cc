"""The port's ``IdMigrator`` (``orion_tpu_torch.storage.migrate_ids``) and
``db migrate-ids`` against ``orion_tpu``'s: on copies of one store the two
migrators plan the same rows and leave the same documents (the reference's
new ids, lineage remapped), from a clean run and from a crash at each stage
boundary; through both CLIs on one SQLite file; and through the port's
sharded router, where every op lands on the experiment's shard."""

import copy
import json
import sqlite3

import pytest
from test_torch_netdb import servers  # noqa: F401

from orion_tpu.cli import main as ref_main
from orion_tpu.core.experiment import build_experiment as ref_build_experiment
from orion_tpu.core.producer import Producer as RefProducer
from orion_tpu.core.trial import Result as RefResult
from orion_tpu.core.trial import compute_scheme_ids as ref_compute_scheme_ids
from orion_tpu.space.dsl import build_space as ref_build_space
from orion_tpu.storage import migrate_ids as ref_migrate_ids
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu_torch.cli import main
from orion_tpu_torch.core.trial import compute_scheme_ids
from orion_tpu_torch.space.dsl import build_space
from orion_tpu_torch.storage import migrate_ids
from orion_tpu_torch.storage.audit import audit_experiment
from orion_tpu_torch.storage.base import DocumentStorage, create_storage
from orion_tpu_torch.storage.shard import ShardedNetworkDB

PRIORS = {"x0": "uniform(0, 1)", "x1": "uniform(0, 1)", "x2": "uniform(0, 1)"}
COLLECTIONS = ("experiments", "trials", "lying_trials", migrate_ids.MIGRATION_COLLECTION)


def _seed(storage, name="mig-exp", rounds=2, q=4):
    """A random-search experiment written by the reference's producer: one
    round completed, one in flight, and a lie."""
    exp = ref_build_experiment(storage, name, priors=dict(PRIORS), max_trials=100,
                               algorithms="random", pool_size=q).instantiate(seed=7)
    producer = RefProducer(exp)
    for round_ in range(rounds):
        producer.update()
        assert producer.produce(q) == q
        if round_ == 0:
            for trial in exp.fetch_trials():
                storage.set_trial_status(trial, "reserved", was="new")
                storage.update_completed_trial(trial, [RefResult("obj", "objective", 0.5)])
    lie = dict(storage.db.read("trials", {"experiment": exp.id})[0])
    lie["_id"] = ref_compute_scheme_ids(exp.id, [lie["params"]], lie=True)[0]
    storage.db.write("lying_trials", lie)
    return exp.id


def _copies():
    """The same documents in a port and a reference memory store."""
    ref = ref_create_storage({"type": "memory"})
    exp_id = _seed(ref)
    port = create_storage({"type": "memory"})
    for collection in ("experiments", "trials", "lying_trials"):
        port.db.write(collection, copy.deepcopy(ref.db.read(collection)))
    return port, ref, exp_id


def _state(storage):
    out = {}
    for collection in COLLECTIONS:
        docs = sorted(storage.db.read(collection), key=lambda d: d["_id"])
        out[collection] = [{k: v for k, v in d.items() if k != "ts"} for d in docs]
    return json.dumps(out, sort_keys=True)


class _Crash(RuntimeError):
    pass


@pytest.mark.parametrize("stage", [None, "after_copy", "after_verify", "after_flip"])
def test_migration_leaves_the_reference_documents(stage):
    port, ref, exp_id = _copies()
    plans = [[r.describe() for r in m.IdMigrator(s).plan()]
             for m, s in ((migrate_ids, port), (ref_migrate_ids, ref))]
    assert plans[0] == plans[1] and len(plans[0]) == 1

    def crash(at, _exp_id):
        if at == stage:
            raise _Crash(at)

    if stage is not None:
        for module, storage in ((migrate_ids, port), (ref_migrate_ids, ref)):
            with pytest.raises(_Crash):
                module.IdMigrator(storage, crash_at=crash).run()
        assert _state(port) == _state(ref)
        assert port.db.read(migrate_ids.MIGRATION_COLLECTION, {}) != []
    rows = migrate_ids.IdMigrator(port).run()
    ref_rows = ref_migrate_ids.IdMigrator(ref).run()
    assert [r.rewritten for r in rows] == [r.rewritten for r in ref_rows]
    assert _state(port) == _state(ref)
    docs = port.db.read("trials", {"experiment": exp_id})
    space = build_space(dict(PRIORS))
    assert {d["_id"] for d in docs} == set(compute_scheme_ids(
        exp_id, [d["params"] for d in docs], id_scheme="cube_hash", space=space))
    [exp_doc] = port.db.read("experiments", {"_id": exp_id})
    assert exp_doc["id_scheme"] == "cube_hash"
    assert audit_experiment(port, exp_doc, lost_timeout=3600.0).ok
    assert migrate_ids.IdMigrator(port).plan() == []


def test_db_migrate_ids_through_both_clis(tmp_path, capsys):
    outputs, states = [], []
    seeded = str(tmp_path / "ref.sqlite")
    _seed(ref_create_storage({"type": "sqlite", "path": seeded}))
    with sqlite3.connect(seeded) as src, sqlite3.connect(str(tmp_path / "port.sqlite")) as dst:
        src.backup(dst)
    for fn, name in ((main, "port.sqlite"), (ref_main, "ref.sqlite")):
        path = str(tmp_path / name)
        argv = ["db", "migrate-ids", "--storage-path", path]
        outputs.append([(fn(argv + extra), capsys.readouterr().out)
                        for extra in (["--dry-run"], [], [])])
        states.append(_state(create_storage({"type": "sqlite", "path": path})))
    assert outputs[0] == [(rc, out.replace("orion-tpu ", "orion-tpu-torch "))
                          for rc, out in outputs[1]]
    assert outputs[0][2][1].startswith("nothing to migrate")
    assert states[0] == states[1]


def test_sharded_migration_lands_on_each_experiments_shard(servers):
    started = [servers("port") for _ in range(3)]
    router = ShardedNetworkDB(["%s:%s" % s.address for s in started], reconnect_jitter=0,
                              timeout=5.0)
    storage = DocumentStorage(router)
    # The servers' ports are ephemeral, so the ring differs from run to run:
    # three experiments share one shard about one run in nine.  Seed more
    # (up to twelve) until they span two shards.
    exp_ids = []
    for i in range(12):
        exp_ids.append(_seed(storage, name=f"mig-{i}", rounds=1))
        if len(exp_ids) >= 3 and len({router.shard_for(e) for e in exp_ids}) > 1:
            break
    assert len({router.shard_for(e) for e in exp_ids}) > 1
    assert len(migrate_ids.IdMigrator(storage).run()) == len(exp_ids)
    space = ref_build_space(dict(PRIORS))
    for exp_id in exp_ids:
        docs = router.read("trials", {"experiment": exp_id})
        assert {d["_id"] for d in docs} == set(ref_compute_scheme_ids(
            exp_id, [d["params"] for d in docs], id_scheme="cube_hash", space=space))
        home = started[router.shard_for(exp_id)]
        assert home.db.count("trials", {"experiment": exp_id}) == len(docs)
    for server in started:
        assert server.db.read(migrate_ids.MIGRATION_COLLECTION, {}) == []
