"""The port's ``db`` commands (``orion_tpu_torch/cli/db.py``) against
``orion_tpu``'s, run in process through both CLIs on the same stores:
``dump`` byte for byte, ``load`` of the reference's dumps, mongoexport
arrays and reference-Oríon pickles, ``copy``, ``setup``/``test``/``upgrade``
and their aliases, ``ring`` and ``status --json`` over a replicated
two-shard plane, ``db serve`` as a process, the day-2 commands (``ring
--diff``, ``rebalance``, ``drain``, ``backup``, ``restore``) on one plane of
port servers, and a two-worker ``tpu_bo`` hunt on the CPU over a port
server."""

import json
import math
import os
import pickle
import re
import signal
import subprocess
import sys

import pytest
import yaml
from test_torch_netdb import _client, servers  # noqa: F401
from test_torch_rebalance import load, pick_names, populate, router, save, shard_state

from orion_tpu.cli import main as ref_main
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu_torch.cli import main
from orion_tpu_torch.storage.base import create_storage
from torch_parity import FakeOrionCollection, FakeOrionDB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(fn, argv, capsys):
    rc = fn(argv)
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def _fill(db):
    """Experiments, trials (one holding NaN), lies and telemetry, written
    through a document store of either package."""
    db.write("experiments", [{"_id": f"exp{i}", "name": f"e{i}", "version": 1,
                              "metadata": {"user": "u", "datetime": 1.5},
                              "priors": {"x": "uniform(0, 1)"}} for i in range(2)])
    db.write("trials", [{"_id": f"t{i}", "experiment": f"exp{i % 2}", "status": "completed",
                         "params": {"x": i / 7}, "parents": [],
                         "results": [{"name": "o", "type": "objective",
                                      "value": math.nan if i == 3 else i * 0.25}]}
                        for i in range(6)])
    db.write("lying_trials", {"_id": "l0", "experiment": "exp0", "params": {"x": 0.5}})
    db.write("telemetry", {"_id": "m0", "experiment": "exp0", "op": "suggest",
                           "duration": 0.01, "count": 4})


def _read_all(storage):
    return json.dumps({c: sorted(storage.db.read(c), key=lambda d: d["_id"])
                       for c in ("experiments", "trials", "lying_trials", "telemetry")},
                      sort_keys=True)


@pytest.mark.parametrize("backend", ["sqlite", "pkl", "network"])
def test_db_dump_matches_reference_byte_for_byte(tmp_path, capsys, servers, backend):
    if backend == "network":
        server = servers("port")
        src = "%s:%s" % server.address
        _fill(_client(server))
    else:
        src = str(tmp_path / f"src.{backend}")
        kind = "sqlite" if backend == "sqlite" else "pickled"
        _fill(ref_create_storage({"type": kind, "path": src}).db)
    port_out, ref_out = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    rc, out, _ = _run(main, ["db", "dump", "--src", src, "--out", str(port_out)], capsys)
    ref_rc, ref_text, _ = _run(ref_main, ["db", "dump", "--src", src, "--out", str(ref_out)],
                               capsys)
    assert rc == ref_rc == 0 and out.replace("port", "ref") == ref_text
    assert port_out.read_bytes() == ref_out.read_bytes()
    assert b"NaN" in port_out.read_bytes()
    assert main(["db", "dump", "--src", str(tmp_path / "typo.sqlite")]) == 1


def _loaded(tmp_path, fn, name, extra, capsys):
    dst = str(tmp_path / name)
    rc, out, err = _run(fn, ["db", "load", "--dst", dst, *extra], capsys)
    return rc, out, err, dst


def test_db_load_reads_the_reference_dumps_like_the_reference(tmp_path, capsys):
    """A reference ``db dump`` file, a mongoexport array and a
    reference-Oríon pickle load into the port with the documents the
    reference's ``db load`` stores; loading again merges idempotently and a
    collision aborts before any write, as there."""
    src = str(tmp_path / "src.sqlite")
    _fill(ref_create_storage({"type": "sqlite", "path": src}).db)
    dump = str(tmp_path / "ref.jsonl")
    assert _run(ref_main, ["db", "dump", "--src", src, "--out", dump], capsys)[0] == 0
    mongo = tmp_path / "mongo.json"
    mongo.write_text(json.dumps([
        {"_id": {"$oid": "5f1"}, "experiment": {"$oid": "exp0"}, "status": "completed",
         "submit_time": {"$date": "2020-05-01T10:00:00Z"},
         "end_time": {"$date": {"$numberLong": "1588327200000"}},
         "params": [{"name": "/x", "type": "real", "value": {"$numberDouble": "0.5"}}],
         "count": {"$numberInt": "3"}}]))
    orion_pickle = tmp_path / "orion.pkl"
    import datetime

    with open(orion_pickle, "wb") as handle:
        pickle.dump(FakeOrionDB({
            "experiments": FakeOrionCollection([{"_id": 1, "name": "legacy",
                                                 "metadata": {"datetime": datetime.datetime(
                                                     2020, 1, 2, 3, 4, 5)}}]),
            "trials": FakeOrionCollection([{"_id": "a", "experiment": 1,
                                            "params": ({"name": "/x", "value": 1.0},)}]),
            "benchmarks": FakeOrionCollection([{"_id": "skipped"}]),
        }), handle)
    for extra, name in ((["--src", dump], "dump"),
                        (["--src", str(mongo), "--collection", "trials"], "mongo"),
                        (["--src", str(orion_pickle)], "orion")):
        port = _loaded(tmp_path, main, f"port-{name}.sqlite", extra, capsys)
        ref = _loaded(tmp_path, ref_main, f"ref-{name}.sqlite", extra, capsys)
        assert port[:3] == ref[:3] and port[0] == 0, name
        assert (_read_all(create_storage({"type": "sqlite", "path": port[3]}))
                == _read_all(ref_create_storage({"type": "sqlite", "path": ref[3]})))
        again = _loaded(tmp_path, main, f"port-{name}.sqlite", extra, capsys)
        assert again[0] == 0 and "loaded 0" in again[1]
    clash = tmp_path / "clash.jsonl"
    clash.write_text(json.dumps({"collection": "trials", "doc": {"_id": "t0", "x": 1}}) + "\n")
    port = _loaded(tmp_path, main, "port-dump.sqlite", ["--src", str(clash)], capsys)
    ref = _loaded(tmp_path, ref_main, "ref-dump.sqlite", ["--src", str(clash)], capsys)
    assert port[:3] == ref[:3] and port[0] == 1 and "NOTHING was loaded" in port[2]
    # An orion-tpu pickled file (either package's) goes through `db copy`.
    ref_pickled = str(tmp_path / "ref.pkl")
    _fill(ref_create_storage({"type": "pickled", "path": ref_pickled}).db)
    port = _loaded(tmp_path, main, "x.sqlite", ["--src", ref_pickled], capsys)
    assert port[0] == 1 and "use `db copy`" in port[2]


def test_db_copy_matches_reference(tmp_path, capsys):
    src = str(tmp_path / "ref.pkl")
    _fill(ref_create_storage({"type": "pickled", "path": src}).db)
    outputs = []
    for fn, dst in ((main, "port.sqlite"), (ref_main, "ref.sqlite")):
        outputs.append(_run(fn, ["db", "copy", "--src", src, "--dst", str(tmp_path / dst)],
                            capsys))
    assert outputs[0] == outputs[1] and outputs[0][0] == 0
    assert (_read_all(create_storage({"type": "sqlite", "path": str(tmp_path / "port.sqlite")}))
            == _read_all(ref_create_storage({"type": "pickled", "path": src})))
    assert main(["db", "copy", "--src", src, "--dst", str(tmp_path / "port.sqlite")]) == 0


def test_setup_test_and_upgrade_match_reference(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "xdg"))
    config_path = tmp_path / "xdg" / "orion_tpu" / "config.yaml"
    written = []
    for fn, argv in ((main, ["db", "setup"]), (ref_main, ["db", "setup"]),
                     (main, ["setup", "--storage-type", "network", "--port", "7001"]),
                     (ref_main, ["setup", "--storage-type", "network", "--port", "7001"])):
        rc, out, _ = _run(fn, argv, capsys)
        assert rc == 0
        written.append((out, config_path.read_text()))
        config_path.unlink()
    assert written[0] == written[1] and written[2] == written[3]
    db = str(tmp_path / "legacy.pkl")
    legacy = ref_create_storage({"type": "pickled", "path": db}).db
    legacy.write("experiments", {"_id": "old", "name": "old", "metadata": {"user": "u"},
                                 "producer": {"strategy": "MaxParallelStrategy"}})
    legacy.write("trials", [{"_id": f"t{i}", "experiment": "old",
                             "params": [{"name": "/x", "type": "real", "value": i}]}
                            for i in range(3)])
    ref_db = str(tmp_path / "legacy-ref.pkl")
    with open(db, "rb") as src, open(ref_db, "wb") as dst:
        dst.write(src.read())
    port = [_run(main, [cmd, *sub, "--storage-path", db], capsys)
            for cmd, sub in (("db", ["test"]), ("test-db", []), ("db", ["upgrade"]))]
    ref = [_run(ref_main, [cmd, *sub, "--storage-path", ref_db], capsys)
           for cmd, sub in (("db", ["test"]), ("test-db", []), ("db", ["upgrade"]))]
    assert port == ref and port[2][1] == "Upgraded 1 experiments, 6 trials.\n"
    assert (_read_all(create_storage({"type": "pickled", "path": db}))
            == _read_all(ref_create_storage({"type": "pickled", "path": ref_db})))


# --- the sharded plane --------------------------------------------------------


def _plane(servers, tmp_path):
    """Two primaries, each with one replica and quorum 1, and a config file
    with their ``shards:`` stanza."""
    stanza = []
    for _ in range(2):
        replica = servers("port", replica=True, quorum=1)
        primary = servers("port", replicate_to=[replica.address], quorum=1)
        stanza.append({"address": "%s:%s" % primary.address,
                       "replicas": ["%s:%s" % replica.address]})
    conf = tmp_path / "shards.yaml"
    conf.write_text(yaml.safe_dump({"storage": {"type": "network", "shards": stanza}}))
    return str(conf)


def test_ring_and_status_match_reference(tmp_path, capsys, servers):
    conf = _plane(servers, tmp_path)
    storage = create_storage(yaml.safe_load(open(conf))["storage"])
    for i in range(4):
        storage.create_experiment({"name": f"r{i}", "version": 1, "priors": {},
                                   "metadata": {"user": "u"}})
    # Each command opens the storage, whose index set-up is one more
    # replicated write: the seqs move between runs, nothing else does.
    results = [tuple(re.sub(r'(seq"?:? )\d+', r"\g<1>0", part) if isinstance(part, str)
                     else part for part in _run(fn, ["db", *argv, "-c", conf], capsys))
               for argv in (["ring"], ["status"], ["status", "--json"])
               for fn in (main, ref_main)]
    for port, ref in zip(results[::2], results[1::2]):
        assert port == ref and port[0] == 0
    status = json.loads(results[4][1])
    assert [s["quorum"] for s in status["shards"]] == [1, 1]
    assert [s["role"] for s in status["shards"]] == ["primary", "primary"]
    assert [r["lag"] for s in status["shards"] for r in s["replicas"]] == [0, 0]
    assert "storage: 2 shard(s)" in results[0][1] and "4 experiment(s):" in results[0][1]


def test_ring_and_status_refuse_an_unsharded_store(tmp_path, capsys):
    db = str(tmp_path / "x.sqlite")
    for argv in (["ring"], ["status"]):
        port = _run(main, ["db", *argv, "--storage-path", db], capsys)
        assert port == _run(ref_main, ["db", *argv, "--storage-path", db], capsys)
        assert port[0] == 1 and "not sharded" in port[1]


@pytest.mark.parametrize("argv", [["rebalance"], ["drain", "0"], ["backup", "--out", "b"],
                                  ["restore", "--src", "b"], ["ring", "--diff"]])
def test_day2_commands_raise_naming_item_7b(tmp_path, capsys, argv):
    """The day-2 commands are ported: on an unsharded SQLite store each
    refuses as the reference's does (same exit code and output, but the
    program's name), where it raised ``NotImplementedError`` before."""
    db = str(tmp_path / "x.sqlite")
    port = _run(main, ["db", *argv, "--storage-path", db], capsys)
    ref = _run(ref_main, ["db", *argv, "--storage-path", db], capsys)
    assert port[0] == ref[0] == 1
    assert [text.replace("orion-tpu-torch", "orion-tpu") for text in port[1:]] == list(ref[1:])
    assert (port[1] + port[2]).strip()


def _both(started, saved, argv, capsys):
    """``argv`` through the reference's CLI and, the servers' stores loaded
    back, through the port's: each one's exit code, output (the program's
    name folded) and the servers' documents after it."""
    out = {}
    for name, fn in (("ref", ref_main), ("port", main)):
        load(started, saved)
        rc, text, err = _run(fn, argv, capsys)
        out[name] = (rc, text.replace("orion-tpu-torch", "orion-tpu"),
                     err.replace("orion-tpu-torch", "orion-tpu"), shard_state(started))
    return out["port"], out["ref"]


def _config(tmp_path, name, started):
    conf = tmp_path / name
    conf.write_text(yaml.safe_dump({"storage": {"type": "network", "shards": [
        {"address": "%s:%s" % s.address} for s in started]}}))
    return str(conf)


def test_day2_commands_match_the_reference_on_a_sharded_plane(tmp_path, capsys, servers):
    """Over one plane of port servers, both CLIs on the same stores:
    ``ring --diff`` and ``rebalance --dry-run`` print the reference's plan
    for a grown ring; ``rebalance`` moves the same experiments to the same
    documents; ``drain`` of the busiest shard, then its ``--dry-run``
    showing nothing resident; ``backup`` and a ``restore`` onto a fresh
    two-shard plane."""
    started = [servers("port") for _ in range(4)]
    names = pick_names(["%s:%s" % s.address for s in started[:3]],
                       ["%s:%s" % s.address for s in started])
    db = router("port", [{"host": s.address[0], "port": s.address[1]} for s in started[:3]])
    populate(db, names)
    db.remove("telemetry", {})
    db.close()
    conf4 = _config(tmp_path, "four.yaml", started)
    saved = save(started)
    for argv in (["ring", "--diff"], ["rebalance", "--dry-run"]):
        port, ref = _both(started, saved, ["db", *argv, "-c", conf4], capsys)
        assert port == ref and port[0] == 0
    assert "rebalance plan: " in port[1] and " -> " in port[1]
    port, ref = _both(started, saved, ["db", "rebalance", "--fence-grace", "0.05",
                                       "-c", conf4], capsys)
    assert port == ref and port[0] == 0
    assert "placement == ring again" in port[1]
    again = _run(main, ["db", "ring", "--diff", "-c", conf4], capsys)
    assert again[0] == 0 and "rebalance plan: 0 of 12" in again[1]
    saved = save(started)
    busiest = max(range(4), key=lambda i: started[i].db.count("experiments", {}))
    port, ref = _both(started, saved, ["db", "drain", str(busiest), "--fence-grace", "0.05",
                                       "-c", conf4], capsys)
    assert port == ref and port[0] == 0 and f"shard {busiest} drained" in port[1]
    dry = _run(main, ["db", "drain", str(busiest), "--dry-run", "-c", conf4], capsys)
    moves = dry[1].splitlines()[1:]
    assert dry[0] == 0 and moves and all(line.endswith(" [moved]") for line in moves)
    assert started[busiest].db.count("experiments", {}) == 0
    survivors = [s for i, s in enumerate(started) if i != busiest]
    conf3 = _config(tmp_path, "survivors.yaml", survivors)
    backups = {}
    for name, fn in (("ref", ref_main), ("port", main)):
        backups[name] = str(tmp_path / f"backup-{name}")
        rc, text, _ = _run(fn, ["db", "backup", "--out", backups[name], "-c", conf3], capsys)
        backups[name, "out"] = (rc, text.replace(backups[name], "DIR"))
    assert backups["port", "out"] == backups["ref", "out"] and backups["port", "out"][0] == 0
    fresh = [servers("port") for _ in range(2)]
    conf2 = _config(tmp_path, "fresh.yaml", fresh)
    port, ref = _both(fresh, save(fresh), ["db", "restore", "--src", backups["port"],
                                           "-c", conf2], capsys)
    assert port == ref and port[0] == 0
    assert "restored " in port[1] and "trials: 48" in port[1]


# --- db serve as a process, and a hunt over it ------------------------------


def _serve(tmp_path, *extra):
    """``python -m orion_tpu_torch.cli db serve`` on a port the OS picks,
    with the package root on ``PYTHONPATH``; returns the process and its
    ``host:port`` from the listening line."""
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "orion_tpu_torch.cli", "db", "serve", "--host", "127.0.0.1",
         "--port", "0", *extra], cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    line = proc.stdout.readline()
    if "listening on" not in line:
        proc.kill()
        raise AssertionError(line + proc.stdout.read())
    return proc, line.split("listening on ")[1].split(" ")[0]


def _end(proc):
    proc.send_signal(signal.SIGINT)
    try:
        return proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise


def test_db_serve_refuses_without_auth_and_serves_with_a_secret(tmp_path, capsys):
    assert _run(main, ["db", "serve", "--port", "0"], capsys)[2].startswith(
        "ERROR: refusing to serve without authentication")
    secret = tmp_path / "net.secret"
    secret.write_text("s3cret\n")
    proc, address = _serve(tmp_path, "--secret-file", str(secret), "--persist",
                           str(tmp_path / "net.sqlite"))
    try:
        storage = create_storage({"type": "network", "address": address, "secret": "s3cret"})
        storage.db.write("trials", {"_id": "t", "experiment": "e"})
        assert storage.db.count("trials") == 1
    finally:
        assert _end(proc) == 0
    assert create_storage({"type": "sqlite", "path": str(tmp_path / "net.sqlite")}) \
        .db.count("trials") == 1


LOGGING_BOX = """\
import json, os, sys
x = float(sys.argv[sys.argv.index("-x") + 1])
with open(os.environ["EXEC_LOG"], "a") as log:
    log.write(os.environ["ORION_TRIAL_ID"] + "\\n")
with open(os.environ["ORION_RESULTS_PATH"], "w") as out:
    json.dump([{"name": "objective", "type": "objective", "value": (x - 0.3) ** 2}], out)
"""


def test_two_workers_hunt_tpu_bo_over_a_port_server(tmp_path, capsys, monkeypatch):
    """``hunt --n-workers 2`` with ``ORION_DB_TYPE=network`` over a port
    server started as ``db serve``: a small ``tpu_bo`` runs GP rounds in
    both workers, nothing runs twice, every completion reads back and the
    audit is clean."""
    secret = tmp_path / "net.secret"
    secret.write_text("s3cret\n")
    proc, address = _serve(tmp_path, "--secret-file", str(secret))
    try:
        box = tmp_path / "box.py"
        box.write_text(LOGGING_BOX)
        conf = tmp_path / "bo.yaml"
        conf.write_text(yaml.safe_dump({"algorithms": {"tpu_bo": {
            "n_init": 4, "n_candidates": 256, "fit_steps": 3}}}))
        log = tmp_path / "exec.log"
        for key, value in (("ORION_DB_TYPE", "network"), ("ORION_DB_ADDRESS", address),
                           ("ORION_DB_SECRET_FILE", str(secret)), ("EXEC_LOG", str(log))):
            monkeypatch.setenv(key, value)
        rc, out, err = _run(main, ["hunt", "-n", "net", "--device", "cpu", "-c", str(conf),
                                   "--max-trials", "16", "--pool-size", "4", "--n-workers",
                                   "2", "--working-dir", str(tmp_path / "w"), str(box),
                                   "-x~uniform(0, 1)"], capsys)
        assert rc == 0, out + err
        executed = log.read_text().split()
        storage = create_storage({"type": "network", "address": address})
        [exp] = storage.fetch_experiments({"name": "net"})
        completed = [t.id for t in storage.fetch_trials(uid=exp["_id"])
                     if t.status == "completed"]
        assert len(executed) == len(set(executed)), "a trial ran twice"
        assert sorted(completed) == sorted(executed) and len(completed) >= 16
        rc, out, _ = _run(main, ["audit", "-n", "net"], capsys)
        assert rc == 0 and "ok" in out.lower()
    finally:
        assert _end(proc) == 0
