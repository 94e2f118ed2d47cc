"""The port's SQLite backend against ``orion_tpu``'s: a seeded op sequence
through both ``SQLiteDB`` classes, the storage protocol on SQLite, files
crossing between the packages in both directions, and processes of both
packages reserving from one file."""

import json
import os
import subprocess
import sys

import pytest
from test_torch_storage import _op_sequence, _outcome, _protocol_run, _strip

from orion_tpu.core.trial import Result as RefResult
from orion_tpu.core.trial import Trial as RefTrial
from orion_tpu.core.trial import TrialBatch as RefTrialBatch
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu.storage.sqlitedb import SQLiteDB as RefSQLiteDB
from orion_tpu.storage.sqlitedb import sqlite_path_selected as ref_sqlite_path_selected
from orion_tpu.utils import exceptions as ref_exc
from orion_tpu_torch.core.trial import Result, Trial, TrialBatch
from orion_tpu_torch.storage import sqlitedb
from orion_tpu_torch.storage.base import create_storage
from orion_tpu_torch.storage.sqlitedb import SQLiteDB, sqlite_path_selected

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INDEXES = [("trials", ["status"], False), ("trials", ["experiment", "status"], False),
           ("trials", ["key"], True)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sqlitedb_random_op_sequence_matches_reference(tmp_path, seed):
    """Every op's outcome (results and raised errors alike), the whole
    collection after each op, the index metadata and the transaction count
    agree with the reference's index-less file, the port's file carrying
    its field indexes."""
    port = SQLiteDB(str(tmp_path / "port.sqlite"))
    ref = RefSQLiteDB(str(tmp_path / "ref.sqlite"))
    for db in (port, ref):
        db.ensure_indexes(INDEXES)
    assert port.index_specs() == ref.index_specs()
    for step, (method, args) in enumerate(_op_sequence(seed, n_ops=120)):
        got = _outcome(getattr(port, method), *args)
        want = _outcome(getattr(ref, method), *args)
        assert got == want, (step, method, args)
        assert port.read("trials") == ref.read("trials"), (step, method)
    assert port.collection_names() == ref.collection_names()
    assert port.index_information("trials") == ref.index_information("trials")
    assert port.txn_count == ref.txn_count > 0
    assert SQLiteDB.cheap_counts is RefSQLiteDB.cheap_counts is True
    indexes = {row[0] for row in port._conn().execute(
        "SELECT name FROM sqlite_master WHERE type = 'index' AND tbl_name = 'docs'")}
    assert FIELD_INDEX_NAMES.issubset(indexes)


FIELD_INDEX_NAMES = {"docs_valid_experiment_status", "docs_nonstandard_json"}


def test_field_index_serves_the_worker_loop_queries(tmp_path):
    """The status count and the reservation claim read the field index,
    the documents SQLite cannot parse (Python's NaN and Infinity) are read
    through the second index, and both exist on every SQLite, this one
    included."""
    db = SQLiteDB(str(tmp_path / "x.sqlite"))
    for query in ({"experiment": "e", "status": "completed"},
                  {"experiment": "e", "status": {"$in": ["new", "suspended", "interrupted"]}}):
        clauses, params = db._sql_prefilter(query)
        plan = db._conn().execute(
            "EXPLAIN QUERY PLAN SELECT COUNT(*) FROM docs WHERE collection = ? AND "
            + " AND ".join([sqlitedb._VALID_JSON, *clauses]), ("trials", *params)).fetchall()
        assert "USING INDEX docs_valid_experiment_status" in plan[0][-1], plan
    sql, params = db._nonstandard_sql("SELECT id, doc", {"experiment": "e", "status": "new"})
    plan = db._conn().execute("EXPLAIN QUERY PLAN " + sql + " ORDER BY id",
                              ("trials", *params)).fetchall()
    assert "USING INDEX docs_nonstandard_json" in plan[0][-1], plan


def _nan_docs(rng):
    """Trial documents of two experiments, a few with NaN or infinite
    values in their results and params, in a shuffled insertion order."""
    docs = []
    for i in rng.permutation(24):
        value = [float("nan"), float("inf"), -float("inf"), float(rng.normal())][i % 4]
        docs.append({"_id": f"t{i:02d}", "experiment": "e" if i % 3 else "f",
                     "status": ["new", "completed", "reserved"][i % 3],
                     "params": {"/x": float(rng.uniform()) if i % 5 else value},
                     "results": [{"name": "o", "type": "objective", "value": value}]})
    return docs


def _nan_ops(rng):
    """The worker loop's queries and updates over :func:`_nan_docs`: the
    reservation claim, completions that write NaN and inf objectives, the
    status counts and reads."""
    ops = []
    for step in range(12):
        value = [float("nan"), float("inf"), 0.5][step % 3]
        ops.append(("read_and_write", ("trials", {"experiment": "e", "status": {
            "$in": ["new", "interrupted"]}}, {"$set": {"status": "reserved"}})))
        ops.append(("read_and_write", ("trials", {"experiment": "e", "status": "reserved"}, {
            "$set": {"status": "completed",
                     "results": [{"name": "o", "type": "objective", "value": value}]}})))
        ops.append(("write", ("trials", {"_id": f"n{step:02d}", "experiment": "e",
                                         "status": "new", "params": {"/x": value},
                                         "results": []})))
        ops.append(("count", ("trials", {"experiment": "e", "status": "completed"})))
        ops.append(("count", ("trials", {"experiment": "e", "status": {
            "$in": ["new", "reserved"]}})))
        ops.append(("read", ("trials", {"experiment": "e", "status": {
            "$in": ["new", "reserved", "completed"]}})))
        ops.append(("read", ("trials", {"status": "completed"}, {"results": 1})))
    ops.append(("write", ("trials", {"$set": {"status": "broken"}},
                          {"experiment": "f", "status": "completed"})))
    ops.append(("read", ("trials",)))
    return ops


@pytest.mark.parametrize("created_by", ["port", "reference"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_non_finite_values_write_and_update_on_a_port_file(tmp_path, writer, created_by):
    """A file the port opened takes documents holding NaN and infinite
    values through either package's ``SQLiteDB``, on this SQLite (below
    3.42, where ``json_extract`` cannot parse them): inserts, the
    reservation claim and completions with non-finite objectives give the
    outcomes, the documents and their order of the reference on a file of
    its own.  The file is the port's from the start, or the reference's,
    holding the NaN documents before the port builds its indexes on it."""
    import numpy as np

    path = str(tmp_path / "port.sqlite")
    first = SQLiteDB(path) if created_by == "port" else RefSQLiteDB(path)
    first.ensure_indexes(INDEXES[:2])
    ref = RefSQLiteDB(str(tmp_path / "ref.sqlite"))
    ref.ensure_indexes(INDEXES[:2])
    rng = np.random.default_rng(0)
    docs = _nan_docs(rng)

    def dump(value):  # NaN != NaN: compare the JSON text
        return json.dumps(_outcome(lambda: value), sort_keys=True)

    for doc in docs:
        assert dump(first.write("trials", dict(doc))) == dump(ref.write("trials", dict(doc)))
    db = SQLiteDB(path) if writer == "port" else RefSQLiteDB(path)
    SQLiteDB(path)  # the port's indexes, over the documents already there
    for method, args in _nan_ops(rng):
        got = dump(_outcome(getattr(db, method), *args))
        assert got == dump(_outcome(getattr(ref, method), *args)), (method, args)
        assert "raised" not in got, got
    port_read = SQLiteDB(path).read("trials")
    assert dump(port_read) == dump(ref.read("trials"))
    assert sum("NaN" in json.dumps(d) for d in port_read) > 4
    indexes = {row[0] for row in SQLiteDB(path)._conn().execute(
        "SELECT name FROM sqlite_master WHERE type = 'index' AND tbl_name = 'docs'")}
    assert FIELD_INDEX_NAMES.issubset(indexes)


class _CountingJson:
    """``json`` for ``sqlitedb``, counting the documents it parses."""

    def __init__(self):
        self.loads_calls = 0

    def loads(self, text):
        self.loads_calls += 1
        return json.loads(text)

    dumps = staticmethod(json.dumps)


NONSTANDARD_QUERIES = {
    "count_one_status": ("count", {"experiment": "e", "status": "completed"}, 4),
    "count_status_in": ("count", {"experiment": "e", "status": {"$in": ["new", "reserved"]}}, 8),
    "count_no_match": ("count", {"experiment": "f", "status": "broken"}, 0),
    # The update's own round trip, then t03 alone (t00-t02 would come first).
    "reservation_claim": ("read_and_write", {"experiment": "f", "status": {
        "$in": ["new", "interrupted"]}}, 2),
    # Pushes the status only: the eight documents that are new.
    "escaped_value": ("count", {"experiment": 'e"', "status": "new"}, 8),
}


@pytest.mark.parametrize("case", list(NONSTANDARD_QUERIES))
def test_nonstandard_documents_are_narrowed_by_their_text(tmp_path, monkeypatch, case):
    """Documents holding NaN, which SQLite cannot index, are parsed only
    where their text holds every string the query asks for (the value of
    a string that JSON escapes is not pushed, and all are parsed), and the
    outcome and the documents are the reference's."""
    method, query, parses = NONSTANDARD_QUERIES[case]
    port = SQLiteDB(str(tmp_path / "port.sqlite"))
    ref = RefSQLiteDB(str(tmp_path / "ref.sqlite"))
    for i in range(24):
        doc = {"_id": f"t{i:02d}", "experiment": "ef"[i % 2],
               "status": ["new", "reserved", "completed"][i % 3],
               "results": [{"name": "o", "type": "objective", "value": float("nan")}]}
        port.write("trials", dict(doc))
        ref.write("trials", dict(doc))
    args = ("trials", query) + (({"$set": {"status": "reserved"}},)
                                if method == "read_and_write" else ())
    counting = _CountingJson()
    monkeypatch.setattr(sqlitedb, "json", counting)
    got = getattr(port, method)(*args)
    assert counting.loads_calls == parses
    monkeypatch.undo()
    assert json.dumps(got) == json.dumps(getattr(ref, method)(*args))
    assert json.dumps(port.read("trials")) == json.dumps(ref.read("trials"))


def test_port_drops_the_full_field_index_of_earlier_files(tmp_path):
    """A file that carries the earlier full index over ``json_extract``
    (created where SQLite parses NaN) loses it when the port opens it, and
    then takes a NaN objective on this SQLite through either package."""
    import sqlite3

    path = str(tmp_path / "old.sqlite")
    RefSQLiteDB(path)
    with sqlite3.connect(path) as conn:
        conn.execute("CREATE INDEX docs_experiment_status ON docs (collection, "
                     "json_extract(doc, '$.experiment'), json_extract(doc, '$.status'), id)")
    nan_doc = {"_id": "a", "experiment": "e", "status": "completed",
               "results": [{"name": "o", "type": "objective", "value": float("nan")}]}
    with pytest.raises(ref_exc.DatabaseError, match="malformed JSON"):
        RefSQLiteDB(path).write("trials", dict(nan_doc))
    port = SQLiteDB(path)
    assert port.write("trials", dict(nan_doc)) == "a"
    assert RefSQLiteDB(path).write("trials", dict(nan_doc, _id="b")) == "b"
    assert [d["_id"] for d in port.read("trials", {"experiment": "e"})] == ["a", "b"]


def test_document_storage_protocol_on_sqlite_matches_reference(tmp_path):
    got = _protocol_run(create_storage({"type": "sqlite", "path": str(tmp_path / "p.db")}),
                        Trial, Result, TrialBatch)
    want = _protocol_run(ref_create_storage({"type": "sqlite3",
                                             "path": str(tmp_path / "r.db")}),
                         RefTrial, RefResult, RefTrialBatch)
    assert got == want


def _create(package, path):
    make = create_storage if package == "port" else ref_create_storage
    return make({"type": "sqlite", "path": str(path)})


def _classes(package):
    return (Trial, Result, TrialBatch) if package == "port" else (RefTrial, RefResult,
                                                                  RefTrialBatch)


@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port")])
def test_sqlite_file_crosses_between_packages(tmp_path, writer, reader):
    """A file one package wrote opens in the other with the same documents
    and the same protocol reads; what the reader then writes, the writer
    reads back."""
    path = tmp_path / "x.sqlite"
    written = _create(writer, path)
    _protocol_run(written, *_classes(writer))
    read = _create(reader, path)
    for collection in ("experiments", "trials", "lying_trials"):
        assert read.db.read(collection) == written.db.read(collection), collection
    assert read.db.index_specs() == written.db.index_specs()
    for fetch in ("fetch_trials", "fetch_noncompleted_trials"):
        kwargs = {"uid": "exp-id"} if fetch == "fetch_trials" else {}
        args = () if kwargs else ("exp-id",)
        got = [_strip(t.to_dict()) for t in getattr(read, fetch)(*args, **kwargs)]
        want = [_strip(t.to_dict()) for t in getattr(written, fetch)(*args, **kwargs)]
        assert got == want, fetch
    trial_cls, result_cls, _ = _classes(reader)
    trial = read.register_trial(trial_cls(experiment="exp-id", params={"x": 0.55, "n": 55}))
    claimed = read.reserve_trials("exp-id", 10)
    assert trial.id in {t.id for t in claimed}
    read.update_completed_trial(next(t for t in claimed if t.id == trial.id),
                                [result_cls("objective", "objective", 0.5)])
    back = written.get_trial(uid=trial.id)
    assert back.status == "completed" and back.objective.value == 0.5
    assert written.count_completed_trials("exp-id") == read.count_completed_trials("exp-id")


def test_sqlite_path_selection_matches_reference(tmp_path):
    """``--storage-path`` routing: new files by extension, existing ones by
    their header (a pickle named ``.db`` stays pickled)."""
    import pickle

    (tmp_path / "pickle.db").write_bytes(pickle.dumps({"a": 1}))
    (tmp_path / "empty.sqlite").write_bytes(b"")
    SQLiteDB(str(tmp_path / "real.pkl"))  # an SQLite file with another extension
    paths = ["new.sqlite", "new.sqlite3", "new.db", "new.pkl", "new", "pickle.db",
             "empty.sqlite", "real.pkl"]
    got = [sqlite_path_selected(str(tmp_path / p)) for p in paths]
    assert got == [ref_sqlite_path_selected(str(tmp_path / p)) for p in paths]
    assert got == [True, True, True, False, False, False, True, True]


_RESERVE_WORKER = """
import json, sys
if sys.argv[3] == "port":
    from orion_tpu_torch.storage.base import create_storage
else:
    from orion_tpu.storage.base import create_storage
storage = create_storage({"type": "sqlite", "path": sys.argv[1]})
claimed = []
while True:
    batch = storage.reserve_trials("exp-id", int(sys.argv[2]))
    if not batch:
        break
    claimed.extend(t.id for t in batch)
print(json.dumps({"claimed": claimed}))
"""


def test_processes_of_both_packages_never_claim_a_sqlite_trial_twice(tmp_path):
    """Two port processes (one trial a call, batches of 3) and one
    reference process (batches of 2) reserve from one SQLite file until
    the queue is empty: every trial is claimed exactly once."""
    path = str(tmp_path / "db.sqlite")
    storage = create_storage({"type": "sqlite", "path": path})
    batch = TrialBatch([{"x": i / 100} for i in range(90)]).prepare("exp-id", submit_time=0.0)
    assert not any(isinstance(o, Exception) for o in storage.register_trial_docs(batch.to_docs()))
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _RESERVE_WORKER, path, str(num), package],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for num, package in ((1, "port"), (3, "port"), (2, "reference"))]
    claimed = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        claimed.extend(json.loads(out.strip().splitlines()[-1])["claimed"])
    assert sorted(claimed) == sorted(batch.ids)
    assert {t.status for t in storage.fetch_trials(uid="exp-id")} == {"reserved"}
