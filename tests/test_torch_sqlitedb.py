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
from orion_tpu_torch.core.trial import Result, Trial, TrialBatch
from orion_tpu_torch.storage import sqlitedb
from orion_tpu_torch.storage.base import create_storage
from orion_tpu_torch.storage.sqlitedb import SQLiteDB, sqlite_path_selected

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INDEXES = [("trials", ["status"], False), ("trials", ["experiment", "status"], False),
           ("trials", ["key"], True)]


@pytest.mark.parametrize("field_index", [False, True], ids=["scan", "field_index"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sqlitedb_random_op_sequence_matches_reference(tmp_path, monkeypatch, seed,
                                                       field_index):
    """Every op's outcome (results and raised errors alike), the whole
    collection after each op, the index metadata and the transaction count
    agree, with the port's field index (SQLite 3.42+) and without it."""
    monkeypatch.setattr(sqlitedb, "FIELD_INDEX", field_index)
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
    assert ("docs_experiment_status" in indexes) is field_index


def test_field_index_serves_the_worker_loop_queries(tmp_path, monkeypatch):
    """The status count and the reservation claim read the field index,
    and it exists exactly where SQLite parses JSON5 (Python's NaN and
    Infinity)."""
    import sqlite3

    assert sqlitedb.FIELD_INDEX is (sqlite3.sqlite_version_info >= (3, 42, 0))
    monkeypatch.setattr(sqlitedb, "FIELD_INDEX", True)
    db = SQLiteDB(str(tmp_path / "x.sqlite"))
    for query in ({"experiment": "e", "status": "completed"},
                  {"experiment": "e", "status": {"$in": ["new", "suspended", "interrupted"]}}):
        clauses, params = db._sql_prefilter(query)
        plan = db._conn().execute(
            "EXPLAIN QUERY PLAN SELECT COUNT(*) FROM docs WHERE collection = ? AND "
            + " AND ".join(clauses), ("trials", *params)).fetchall()
        assert "USING INDEX docs_experiment_status" in plan[0][-1], plan


@pytest.mark.parametrize("field_index", [False, True], ids=["scan", "field_index"])
def test_document_storage_protocol_on_sqlite_matches_reference(tmp_path, monkeypatch,
                                                                field_index):
    monkeypatch.setattr(sqlitedb, "FIELD_INDEX", field_index)
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
