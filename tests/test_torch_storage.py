"""The port's storage against ``orion_tpu``'s: the document store, the
storage protocol, the reference's pickled files and cross-process
reservation.

Trial documents are compared after removing only the wall-clock fields
``WALL_CLOCK`` (each package stamps its own ``time.time()``)."""

import json
import os
import random
import subprocess
import sys

import pytest

from orion_tpu.core.trial import Result as RefResult
from orion_tpu.core.trial import Trial as RefTrial
from orion_tpu.core.trial import TrialBatch as RefTrialBatch
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu.storage.documents import MemoryDB as RefMemoryDB
from orion_tpu_torch import convert
from orion_tpu_torch.core.trial import Result, Trial, TrialBatch
from orion_tpu_torch.storage.base import create_storage
from orion_tpu_torch.storage.documents import MemoryDB
from orion_tpu_torch.utils.exceptions import DatabaseError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL_CLOCK = ("submit_time", "start_time", "end_time", "heartbeat")
STATUSES = ["new", "reserved", "completed", "interrupted", "broken"]


# --- MemoryDB: a seeded random op sequence ---------------------------------


def _random_doc(rng, i):
    doc = {
        "_id": f"t{i}",
        "experiment": rng.choice(["e1", "e2"]),
        "status": rng.choice(STATUSES),
        "params": {"x": round(rng.random(), 3), "opt.lr": rng.choice([0.1, 0.01]),
                   "n": rng.randint(0, 5)},
        "nested": {"a": {"b": rng.randint(0, 3)}},
        "tags": rng.choice([[1, 2], ["a"], []]),
    }
    if rng.random() < 0.5:
        doc["key"] = rng.randint(0, 40)  # a sparse field under a unique index
    return doc


def _random_query(rng):
    return rng.choice([
        {},
        {"status": {"$in": rng.sample(STATUSES, 2)}},
        {"status": {"$ne": rng.choice(STATUSES)}},
        {"params.n": {"$gte": rng.randint(0, 5)}},
        {"params.x": {"$lt": rng.random()}},
        {"nested.a.b": rng.randint(0, 3)},
        {"experiment": rng.choice(["e1", "e2"]), "status": rng.choice(STATUSES)},
        {"experiment": rng.choice(["e1", "e2"]),
         "status": {"$in": rng.sample(STATUSES, 3) + ["new"]}},
        {"_id": f"t{rng.randint(0, 60)}"},
        {"_id": {"$in": [f"t{rng.randint(0, 60)}" for _ in range(3)]}},
        {"tags": {"$gte": 1}},
        {"params": {"$ne": None}, "key": {"$gt": 20}},
    ])


def _random_projection(rng):
    return rng.choice([None, {"status": 1}, {"params.n": 1, "_id": 0},
                       {"nested.a": 1, "params.opt.lr": 1}, {"key": 1, "experiment": 1}])


def _random_update(rng, step):
    return rng.choice([
        {"status": rng.choice(STATUSES), "heartbeat": step},
        {"$set": {"params.n": rng.randint(0, 5), "nested.a.c": step}},
        {"$unset": {"key": 1}},
        {"key": rng.randint(0, 40)},
    ])


def _op_sequence(seed, n_ops=160):
    """``(method, args)`` pairs, the same for both stores."""
    rng = random.Random(seed)
    ops, n_docs = [], 0

    def new_doc():
        nonlocal n_docs
        n_docs += 1
        # Now and then an _id already taken: a DuplicateKeyError slot.
        index = rng.randint(0, n_docs - 1) if rng.random() < 0.1 else n_docs
        return _random_doc(rng, index)

    for step in range(n_ops):
        kind = rng.choice(["write", "write", "write_many", "read", "read", "read_and_write",
                           "update_many", "apply_batch", "count", "remove", "write_query"])
        if kind == "write":
            ops.append(("write", ("trials", new_doc())))
        elif kind == "write_many":
            ops.append(("write", ("trials", [new_doc() for _ in range(rng.randint(1, 3))])))
        elif kind == "write_query":
            ops.append(("write", ("trials", _random_update(rng, step), _random_query(rng))))
        elif kind == "read":
            ops.append(("read", ("trials", _random_query(rng), _random_projection(rng))))
        elif kind == "read_and_write":
            ops.append(("read_and_write", ("trials", _random_query(rng),
                                           _random_update(rng, step))))
        elif kind == "update_many":
            ops.append(("update_many", ("trials", [(_random_query(rng),
                                                     _random_update(rng, step))
                                                    for _ in range(rng.randint(1, 3))])))
        elif kind == "apply_batch":
            doc = new_doc()
            ops.append(("apply_batch", ([
                ("write", ["trials", doc], {}),
                ("write", ["trials", dict(doc)], {}),  # the duplicate slot
                ("read_and_write", ["trials", _random_query(rng),
                                    _random_update(rng, step)], {}),
                ("count", ["trials", _random_query(rng)], {}),
                ("read", ["trials", _random_query(rng)], {"projection": {"status": 1}}),
            ],)))
        elif kind == "count":
            ops.append(("count", ("trials", _random_query(rng))))
        else:
            if rng.random() < 0.3:
                ops.append(("remove", ("trials", _random_query(rng))))
            else:
                ops.append(("count", ("trials", {"status": "new"})))
    return ops


def _outcome(fn, *args):
    try:
        return _plain(fn(*args))
    except Exception as exc:  # both stores must raise the same error
        return ("raised", type(exc).__name__, str(exc))


def _plain(value):
    if isinstance(value, Exception):
        return ("raised", type(value).__name__, str(value))
    if isinstance(value, list):
        return [_plain(v) for v in value]
    return value


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_memorydb_random_op_sequence_matches_reference(seed):
    port, ref = MemoryDB(), RefMemoryDB()
    for db in (port, ref):
        db.ensure_indexes([("trials", ["status"], False),
                           ("trials", ["experiment", "status"], False),
                           ("trials", ["key"], True)])
    assert port.index_specs() == ref.index_specs()
    for step, (method, args) in enumerate(_op_sequence(seed)):
        got = _outcome(getattr(port, method), *args)
        want = _outcome(getattr(ref, method), *args)
        assert got == want, (step, method, args)
        assert port.read("trials") == ref.read("trials"), (step, method)
    assert port.collection_names() == ref.collection_names()
    assert port.index_information("trials") == ref.index_information("trials")


def test_memorydb_rejects_bad_batch_op_like_reference():
    for db in (MemoryDB(), RefMemoryDB()):
        with pytest.raises(Exception, match="bad batch op"):
            db.apply_batch([("write", ["c", {"_id": 1}], {}), ("drop", [], {})])
        assert db.read("c") == []


# --- DocumentStorage: the trial protocol ------------------------------------


def _strip(doc):
    return {k: v for k, v in doc.items() if k not in WALL_CLOCK}


def _trial_docs(trials):
    return [None if t is None else _strip(t.to_dict()) for t in trials]


def _protocol_run(storage, trial_cls, result_cls, batch_cls):
    """One scripted protocol sequence; returns every observable outcome."""
    out = []
    exp = storage.create_experiment({"name": "proto", "_id": "exp-id", "priors": {},
                                     "metadata": {"timestamp": 0.0}})
    out.append(exp)

    def new_trial(i, t=None):
        return trial_cls(experiment="exp-id", params={"x": i / 10, "n": i},
                         submit_time=float(i) if t is None else t)

    out.append(_trial_docs([storage.register_trial(new_trial(i)) for i in range(3)]))
    outcomes = storage.register_trials([new_trial(i) for i in range(2, 6)])  # 2 duplicates
    out.append([_plain(o) if isinstance(o, Exception) else _strip(o.to_dict())
                for o in outcomes])
    batch = batch_cls([{"x": i / 10, "n": i} for i in range(5, 9)]).prepare(
        "exp-id", parents=["p0"], submit_time=10.0)
    out.append([_plain(o) if isinstance(o, Exception) else "ok"
                for o in storage.register_trial_docs(batch.to_docs())])
    one = storage.reserve_trial("exp-id")
    many = storage.reserve_trials("exp-id", 3)
    out.append(_trial_docs([one] + many))
    storage.update_heartbeat(one)
    with pytest.raises(Exception, match="no longer reserved"):
        storage.update_heartbeat(new_trial(99))  # never registered
    out.append(_strip(storage.set_trial_status(many[0], "interrupted", was="reserved")
                      .to_dict()))
    with pytest.raises(Exception, match="not updated"):
        storage.set_trial_status(many[0], "broken", was="reserved")  # stale guard
    one.results = [result_cls("loss", "statistic", 1.5)]
    out.append(_strip(storage.push_trial_results(one).to_dict()))
    out.append(_strip(storage.update_completed_trial(
        one, [result_cls("objective", "objective", 0.25)]).to_dict()))
    pairs = [(t, [result_cls("objective", "objective", float(k))])
             for k, t in enumerate(many[1:])]
    out.append([_plain(o) if isinstance(o, Exception) else _strip(o.to_dict())
                for o in storage.update_completed_trials(pairs)])
    lie = trial_cls(experiment="exp-id", params={"x": 0.7, "n": 7},
                    results=[{"name": "lie", "type": "lie", "value": 9.0}], submit_time=1.0)
    storage.register_lie(lie)
    out.append(_trial_docs(storage.fetch_lies("exp-id")))
    out.append(_trial_docs(storage.reserve_trials("exp-id", 10)))
    out.append(_trial_docs(storage.fetch_lost_trials("exp-id", timeout=-60.0)))
    out.append(_trial_docs(storage.fetch_trials_by_status("exp-id", ["completed"])))
    out.append(_trial_docs(storage.fetch_noncompleted_trials("exp-id")))
    trials, n_completed = storage.fetch_update_view("exp-id", known_completed=-1)
    out.append((_trial_docs(trials), n_completed))
    out.append(_trial_docs(storage.fetch_trials(uid="exp-id")))
    out.append((storage.count_completed_trials("exp-id"),
                storage.count_broken_trials("exp-id")))
    out.append(_trial_docs([storage.get_trial(uid=one.id)]))
    return out


@pytest.mark.parametrize("backend", ["memory", "pickled"])
def test_document_storage_protocol_matches_reference(tmp_path, backend):
    def config(tag):
        return {"type": backend, "path": str(tmp_path / f"{tag}.pkl")}

    got = _protocol_run(create_storage(config("port")), Trial, Result, TrialBatch)
    want = _protocol_run(ref_create_storage(config("ref")), RefTrial, RefResult,
                         RefTrialBatch)
    assert got == want


@pytest.mark.parametrize("backend", ["memory", "pickled"])
def test_register_lies_batch_writes_the_reference_documents(tmp_path, backend):
    """The port registers a round's lies in one storage round; the
    documents are those of the reference's one-write-per-lie
    ``register_lie``, and a lie registered before comes back as its
    slot's DuplicateKeyError."""
    def lies(trial_cls):
        return [trial_cls(experiment="exp-id", params={"x": i / 10},
                          results=[{"name": "lie", "type": "lie", "value": 1.0 + i}])
                for i in (0, 1, 0)]

    def docs(storage):
        return sorted((_strip(d) for d in storage.db.read("lying_trials")),
                      key=lambda d: d["_id"])

    port = create_storage({"type": backend, "path": str(tmp_path / "port.pkl")})
    outcomes = port.register_lies(lies(Trial))
    assert [type(o).__name__ for o in outcomes] == ["Trial", "Trial", "DuplicateKeyError"]
    ref = ref_create_storage({"type": backend, "path": str(tmp_path / "ref.pkl")})
    ref_outcomes = []
    for lie in lies(RefTrial):
        try:
            ref_outcomes.append(type(ref.register_lie(lie)).__name__)
        except Exception as exc:
            ref_outcomes.append(type(exc).__name__)
    assert ref_outcomes == ["Trial", "Trial", "DuplicateKeyError"]
    assert docs(port) == docs(ref) and len(docs(port)) == 2


def test_retry_policy_matches_reference():
    """Same backoff delays for the same jitter seed, the same
    transient/fatal split, and the same give-up points."""
    from orion_tpu.storage import retry as ref_retry
    from orion_tpu.utils import exceptions as ref_exc
    from orion_tpu_torch.storage import retry
    from orion_tpu_torch.utils import exceptions as exc

    port = retry.RetryPolicy(seed=3, sleep=lambda s: None)
    ref = ref_retry.RetryPolicy(seed=3, sleep=lambda s: None)
    assert [port.delay(a) for a in range(70)] == [ref.delay(a) for a in range(70)]
    for name in ("DatabaseError", "DuplicateKeyError", "FailedUpdate",
                 "AuthenticationError", "RaceCondition"):
        assert (retry.is_transient(getattr(exc, name)())
                == ref_retry.is_transient(getattr(ref_exc, name)())), name
    for error in (OSError(), ConnectionError(), TimeoutError(), KeyError("k"), ValueError()):
        assert retry.is_transient(error) == ref_retry.is_transient(error)

    def attempts(policy, error_cls, mode, maybe_applied=False):
        calls = []

        def fn():
            calls.append(1)
            error = error_cls("x")
            error.maybe_applied = maybe_applied
            raise error

        with pytest.raises(error_cls):
            policy.run(fn, mode=mode)
        return len(calls)

    for mode in ("always", "unapplied"):
        for applied in (False, True):
            assert (attempts(port, exc.DatabaseError, mode, applied)
                    == attempts(ref, ref_exc.DatabaseError, mode, applied))
        assert (attempts(port, exc.DuplicateKeyError, mode)
                == attempts(ref, ref_exc.DuplicateKeyError, mode) == 1)


def test_unported_backends_raise_not_implemented():
    """Every storage type the reference names is ported now: ``network``
    (and its ``netdb`` alias, and ``shards:``) builds over a live server
    instead of raising; an unknown type is still refused."""
    from orion_tpu_torch.storage.netdb import DBServer, NetworkDB
    from orion_tpu_torch.storage.shard import ShardedNetworkDB

    server = DBServer(port=0)
    host, port = server.serve_background()
    try:
        for db_type in ("network", "netdb"):
            db = create_storage({"type": db_type, "host": host, "port": port}).db
            assert type(db) is NetworkDB and (db.host, db.port) == (host, port)
        db = create_storage({"type": "network", "shards": [f"{host}:{port}"]}).db
        assert type(db) is ShardedNetworkDB and db.n_shards == 1
    finally:
        server.shutdown()
        server.server_close()
    with pytest.raises(DatabaseError):
        create_storage({"type": "nosuch"})


# --- a pickled file that orion_tpu wrote ------------------------------------

PRIORS = {"x": "uniform(0, 1)", "n": "randint(1, 5)"}


def _objective(params):
    return (params["x"] - 0.3) ** 2 + params["n"]


def write_reference_db(path):
    """A ``pickled`` file written by ``orion_tpu``: an optimize() of 12
    random trials, then 4 trials reserved by a client and left running.
    Returns the reference's experiments and trial documents."""
    from orion_tpu.client.experiment import ExperimentClient as RefClient
    from orion_tpu.client.experiment import optimize as ref_optimize
    from orion_tpu.core.experiment import build_experiment as ref_build

    storage = ref_create_storage({"type": "pickled", "path": str(path)})
    ref_optimize(_objective, PRIORS, max_trials=12, batch_size=4, algorithm="random",
                 seed=3, storage=storage, name="resume")
    exp = ref_build(storage, "resume", priors=PRIORS, max_trials=24).instantiate(seed=4)
    RefClient(exp).suggest(4)
    return storage.fetch_experiments({}), storage.db.read("trials")


def test_reference_pickled_db_resumes_in_port(tmp_path):
    from orion_tpu_torch.client.experiment import ExperimentClient
    from orion_tpu_torch.core.experiment import build_experiment

    path = tmp_path / "ref.pkl"
    experiments, trial_docs = write_reference_db(path)
    storage = convert.storage_from_jax(str(path))
    assert storage.fetch_experiments({}) == experiments
    assert storage.db.read("trials") == trial_docs
    assert {d["status"] for d in trial_docs} == {"completed", "reserved"}
    exp = build_experiment(storage, "resume", priors=PRIORS, max_trials=24)
    assert exp.id == experiments[0]["_id"]
    assert [t.to_dict() for t in exp.fetch_trials()] == [
        t.to_dict() for t in (Trial.from_dict(d) for d in
                              sorted(trial_docs, key=lambda d: (d["submit_time"],
                                                                d["_id"])))]
    client = ExperimentClient(exp.instantiate(seed=5, device="cpu"))
    trials = client.suggest(4)
    client.observe_all(trials, [_objective(t.params) for t in trials])
    assert storage.count_completed_trials(exp.id) == 16
    ids = [d["_id"] for d in storage.db.read("trials")]
    assert len(ids) == len(set(ids)) == 20
    # The real algorithm observed the reference's completed trials and ours.
    assert client.producer.algorithm.n_observed == 12
    client.producer.update()
    assert client.producer.algorithm.n_observed == 16


def test_storage_from_jax_refuses_foreign_classes(tmp_path):
    import pickle

    path = tmp_path / "foreign.pkl"
    with open(path, "wb") as handle:
        pickle.dump({"trial": RefTrial(params={"x": 1})}, handle)
    before = path.read_bytes()
    with pytest.raises(DatabaseError, match="orion_tpu.core.trial.Trial"):
        convert.storage_from_jax(str(path))
    assert path.read_bytes() == before
    with pytest.raises(FileNotFoundError):
        convert.storage_from_jax(str(tmp_path / "missing.pkl"))


# --- two port processes on one pickled file ---------------------------------

_RESERVE_WORKER = """
import json, sys
from orion_tpu_torch.storage.base import create_storage
storage = create_storage({"type": "pickled", "path": sys.argv[1]})
claimed = []
while True:
    batch = storage.reserve_trials("exp-id", int(sys.argv[2]))
    if not batch:
        break
    claimed.extend(t.id for t in batch)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "orion_tpu"))
print(json.dumps({"claimed": claimed, "bad": bad}))
"""


def test_two_port_processes_never_claim_a_trial_twice(tmp_path):
    """The twin of ``tests/unit/test_storage.py::test_concurrent_reservation_no_double_claims``:
    two processes reserve from one port ``pickled`` file, one trial a call
    in one and batches of 3 in the other, until the queue is empty."""
    path = str(tmp_path / "db.pkl")
    storage = create_storage({"type": "pickled", "path": path})
    batch = TrialBatch([{"x": i / 100} for i in range(60)]).prepare("exp-id", submit_time=0.0)
    assert not any(isinstance(o, Exception) for o in storage.register_trial_docs(batch.to_docs()))
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _RESERVE_WORKER, path, str(num)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for num in (1, 3)]
    results = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    claimed = [tid for r in results for tid in r["claimed"]]
    assert sorted(claimed) == sorted(batch.ids)
    assert all(r["bad"] == [] for r in results)
    assert {t.status for t in storage.fetch_trials(uid="exp-id")} == {"reserved"}
