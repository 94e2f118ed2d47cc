"""The port's CLI against ``orion_tpu``'s: the user-commandline parser, the
config layers, the versioning metadata, and the commands (``hunt``,
``init-only``, ``status``, ``insert``) run through both packages on the same
command lines and the same storage files.

Each hunt here runs at most 12 trials of a user script, one subprocess a
trial; the scripts are copied out of the repository so that its git state
(which other tests may touch) never enters the experiments' metadata."""

import copy
import json
import os
import shutil
import subprocess
import types

import pytest
import yaml

from orion_tpu import config as ref_config
from orion_tpu.cli import base as ref_base
from orion_tpu.cli import main as ref_main
from orion_tpu.io import cmdline as ref_cmdline
from orion_tpu.io import versioning as ref_versioning
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu_torch import config
from orion_tpu_torch.cli import base
from orion_tpu_torch.cli import main
from orion_tpu_torch.io import cmdline, versioning
from orion_tpu_torch.storage.base import create_storage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUNCTIONAL = os.path.join(ROOT, "tests", "functional")
WALL_CLOCK = ("submit_time", "start_time", "end_time", "heartbeat")


# --- CommandLineParser -------------------------------------------------------

YAML_TEMPLATE = {"lr": "~loguniform(1e-5, 1)",
                 "model": {"layers": "~randint(1, 5)", "act": "relu"}, "batch": 32}
GENERIC_TEMPLATE = "lr = lr~loguniform(1e-5, 1)\nact: act~choices(['relu', 'tanh'])\nn 3\n"


def _config_files(tmp_path):
    (tmp_path / "conf.yaml").write_text(yaml.safe_dump(YAML_TEMPLATE))
    (tmp_path / "conf.json").write_text(json.dumps(YAML_TEMPLATE))
    (tmp_path / "conf.txt").write_text(GENERIC_TEMPLATE)


#: argv forms: dashed priors with and without ``=``, positional priors,
#: placeholders, and a config file given each way the parser accepts.
ARGV_FORMS = {
    "dashed": ["train.py", "-x~uniform(-50, 50)", "--lr~loguniform(1e-5, 1)", "--epochs", "3"],
    "eq_positional_placeholders": [
        "train.py", "--lr=~loguniform(1e-5, 1)", "act~choices(['relu', 'tanh'])",
        "--out", "{trial.working_dir}/out", "--id={trial.id}", "--exp", "{exp.name}"],
    "yaml_config": ["train.py", "--config", "conf.yaml", "-x~uniform(0, 1)"],
    "json_config_eq": ["train.py", "--config=conf.json"],
    "generic_config_short": ["train.py", "-c", "conf.txt", "--seed", "1"],
}


def _fake_trial(priors):
    values = {"uniform(-50, 50)": 12.5, "uniform(0, 1)": 0.25, "loguniform(1e-5, 1)": 0.001,
              "choices(['relu', 'tanh'])": "tanh", "randint(1, 5)": 3}
    return types.SimpleNamespace(
        params={ns: values[expr] for ns, expr in priors.items()}, id="abc123",
        working_dir="/work/abc123", hash_params="h")


@pytest.mark.parametrize("form", sorted(ARGV_FORMS))
def test_cmdline_parser_matches_reference(tmp_path, monkeypatch, form):
    """``parse``, ``state_dict`` (stored as ``metadata.parser_state``: equal
    dict for dict), ``format`` of a trial, ``from_state`` and the per-trial
    config file of each template kind."""
    _config_files(tmp_path)
    monkeypatch.chdir(tmp_path)
    argv = ARGV_FORMS[form]
    port, ref = cmdline.CommandLineParser(), ref_cmdline.CommandLineParser()
    priors = port.parse(list(argv))
    assert priors == ref.parse(list(argv)) and priors
    state = port.state_dict()
    assert state == ref.state_dict()
    assert json.loads(json.dumps(state)) == state  # storable as it is
    trial = _fake_trial(priors)
    experiment = types.SimpleNamespace(name="exp")
    conf = str(tmp_path / "trial.conf") if port.has_config_file else None
    assert port.format(trial, experiment, config_path=conf) == ref.format(
        trial, experiment, config_path=conf)
    restored = cmdline.CommandLineParser.from_state(copy.deepcopy(state))
    assert restored.state_dict() == state
    assert restored.format(trial, experiment, config_path=conf) == port.format(
        trial, experiment, config_path=conf)
    if port.has_config_file:
        restored.generate_config(str(tmp_path / "port.conf"), trial)
        ref_cmdline.CommandLineParser.from_state(copy.deepcopy(state)).generate_config(
            str(tmp_path / "ref.conf"), trial)
        text = (tmp_path / "port.conf").read_text()
        assert text == (tmp_path / "ref.conf").read_text()
        assert "0.001" in text


def test_cmdline_parser_refuses_what_the_reference_refuses(tmp_path):
    _config_files(tmp_path)
    for argv in (["t.py", "-x~uniform(0, 1)", "x~uniform(0, 2)"],
                 ["t.py", "-c", str(tmp_path / "conf.yaml"), "--config",
                  str(tmp_path / "conf.json")]):
        with pytest.raises(ValueError) as port_exc:
            cmdline.CommandLineParser().parse(argv)
        with pytest.raises(ValueError) as ref_exc:
            ref_cmdline.CommandLineParser().parse(argv)
        assert str(port_exc.value) == str(ref_exc.value)


# --- configuration layers ----------------------------------------------------

LAYERS = {
    "defaults_only": ({}, {}, None, {}),
    "file_sections": (
        {"experiment": {"algorithms": {"tpe": {}}, "max_trials": 9},
         "producer": {"strategy": "NoParallelStrategy"},
         "database": {"type": "sqlite", "path": "f.sqlite"}},
        {"name": "e", "pool_size": 4}, None, {}),
    "env_and_cmd": (
        {"max_trials": 9, "storage": {"retry": {"max_attempts": 2}}},
        {"name": "e", "max_trials": 11, "heartbeat": 5.0}, None,
        {"ORION_DB_TYPE": "sqlite", "ORION_DB_ADDRESS": "env.sqlite",
         "ORION_MAX_TRIALS": "7", "ORION_POOL_SIZE": "3", "ORION_MAX_BROKEN": "2"}),
    "override": ({"storage": {"type": "sqlite"}}, {"name": "e"},
                 {"type": "memory"}, {"ORION_DB_TYPE": "pickled"}),
}


@pytest.mark.parametrize("layers", sorted(LAYERS))
def test_resolve_config_matches_reference(tmp_path, monkeypatch, layers):
    """defaults < user config file < env < -c file < command line, with the
    reference's sectioned spellings, through both packages."""
    file_config, cmd_config, override, env = LAYERS[layers]
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    (tmp_path / "orion_tpu").mkdir()
    (tmp_path / "orion_tpu" / "config.yaml").write_text(yaml.safe_dump(
        {"database": {"type": "pickled", "path": "user.pkl"}, "max_broken": 5}))
    for key in ("ORION_DB_TYPE", "ORION_DB_ADDRESS", "ORION_DB_SHARDS", "ORION_MAX_TRIALS",
                "ORION_POOL_SIZE", "ORION_MAX_BROKEN", "ORION_SERVE_ADDRESS",
                "ORION_SERVE_ADDRESSES"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = config.resolve_config(copy.deepcopy(file_config), dict(cmd_config), override)
    want = ref_config.resolve_config(copy.deepcopy(file_config), dict(cmd_config), override)
    assert got == want
    assert config.DEFAULTS == ref_config.DEFAULTS


@pytest.mark.parametrize("key,value", [("telemetry", True), ("metrics_port", 9100),
                                       ("doctor_interval", 5.0)])
def test_telemetry_keys_raise_naming_item_9(key, value):
    """Of the reference's telemetry keys only ``doctor_interval`` still
    raises, naming item 9: it starts the diagnosis watchdog, which is not
    ported.  ``telemetry`` and ``metrics_port`` resolve as the reference
    resolves them.  Null is accepted for all three."""
    assert ref_config.resolve_config({key: value})[key] == value
    if key == "doctor_interval":
        with pytest.raises(NotImplementedError, match="item 9"):
            config.resolve_config({key: value})
    else:
        assert config.resolve_config({key: value})[key] == value
    assert config.resolve_config({key: None}).get(key) is None


@pytest.mark.parametrize("argv", [
    ["-n", "e", "--storage-path", "x.sqlite", "--max-trials", "5", "--pool-size", "2"],
    ["-n", "e", "--debug", "--heartbeat", "9", "--max-idle-time", "3"],
    ["-n", "e", "--storage-path", "x.pkl", "-u", "alice", "--exp-version", "2"],
], ids=["sqlite", "debug", "pickled_user"])
def test_load_cli_config_matches_reference(argv, monkeypatch, tmp_path):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    for key in ("ORION_DB_TYPE", "ORION_DB_ADDRESS", "ORION_MAX_TRIALS"):
        monkeypatch.delenv(key, raising=False)
    from orion_tpu.cli import build_parser as ref_build_parser
    from orion_tpu_torch.cli import build_parser

    got = base.load_cli_config(build_parser().parse_args(["hunt", *argv, "s.py"]))
    want = ref_base.load_cli_config(ref_build_parser().parse_args(["hunt", *argv, "s.py"]))
    assert got == want


# --- versioning metadata -----------------------------------------------------


def _git(repo, *argv):
    subprocess.run(["git", "-C", str(repo), "-c", "user.name=t", "-c", "user.email=t@t",
                    *argv], check=True, capture_output=True, timeout=30)


CONFIG_BOX = """import argparse

from orion_tpu.client import report_results

parser = argparse.ArgumentParser()
parser.add_argument("-x", type=float, required=True)
parser.add_argument("--config", required=True)
args = parser.parse_args()
report_results([{"name": "objective", "type": "objective", "value": (args.x - 34.56) ** 2}])
"""


def make_script_repo(tmp_path):
    """A git repository holding a user script that takes ``--config`` and a
    user-script config; returns (repo, script path)."""
    repo = tmp_path / "repo"
    repo.mkdir()
    script = "config_box.py"
    (repo / script).write_text(CONFIG_BOX)
    (repo / "conf.yaml").write_text(yaml.safe_dump({"lr": "~loguniform(1e-5, 1)"}))
    _git(repo, "init", "-q")
    _git(repo, "add", ".")
    _git(repo, "commit", "-q", "-m", "init")
    return repo, str(repo / script)


def test_versioning_metadata_matches_reference(tmp_path):
    """Clean, dirty (a tracked edit), an untracked helper, and outside any
    repository: the same dict from both packages, and the same config-file
    hash."""
    repo, script = make_script_repo(tmp_path)
    states = []
    for step in ("clean", "dirty", "untracked"):
        if step == "dirty":
            with open(script, "a") as handle:
                handle.write("# edit\n")
        if step == "untracked":
            (repo / "helper.py").write_text("X = 1\n")
        got = versioning.infer_versioning_metadata(script)
        assert got == ref_versioning.infer_versioning_metadata(script), step
        states.append(got)
    assert states[0]["is_dirty"] is False and states[1]["is_dirty"] is True
    assert len({s["diff_sha"] for s in states}) == 3
    outside = tmp_path / "outside.py"
    outside.write_text("")
    assert versioning.infer_versioning_metadata(str(outside)) is None
    assert ref_versioning.infer_versioning_metadata(str(outside)) is None
    conf = str(repo / "conf.yaml")
    assert versioning.hash_config_file(conf) == ref_versioning.hash_config_file(conf)
    assert versioning.hash_config_file(str(tmp_path / "missing")) is None


# --- the commands ------------------------------------------------------------


def _scripts(tmp_path):
    """Copies of the functional-test black boxes (outside any git
    repository) and a grid_search YAML."""
    for name in ("black_box.py", "broken_box.py"):
        shutil.copy(os.path.join(FUNCTIONAL, name), tmp_path / name)
    (tmp_path / "grid.yaml").write_text(yaml.safe_dump(
        {"algorithms": {"grid_search": {"n_values": 4}}}))
    return str(tmp_path / "black_box.py"), str(tmp_path / "grid.yaml")


def _trials(storage, name):
    [exp] = storage.fetch_experiments({"name": name})
    trials = sorted(storage.fetch_trials(uid=exp["_id"]), key=lambda t: t.id)
    return [(t.id, t.params, t.objective.value if t.objective else None, t.status)
            for t in trials]


def _run(fn, argv, capsys):
    rc = fn(argv)
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


@pytest.mark.parametrize("backend", ["sqlite", "pkl"])
def test_hunt_grid_search_stores_the_reference_trials(tmp_path, capsys, backend):
    """The same ``hunt`` command line (plus ``--device cpu``) through both
    CLIs over the reference's own functional-test script, unchanged: the
    same trials (ids, params, objectives, statuses) and the same summary."""
    box, grid = _scripts(tmp_path)
    argv = ["hunt", "-n", "grid", "-c", grid, "--max-trials", "6", box, "-x~uniform(-50, 50)"]
    port_db, ref_db = str(tmp_path / f"port.{backend}"), str(tmp_path / f"ref.{backend}")
    rc, out, _ = _run(main, argv[:1] + ["--storage-path", port_db, "--device", "cpu"]
                      + argv[1:], capsys)
    ref_rc, ref_out, _ = _run(ref_main, argv[:1] + ["--storage-path", ref_db] + argv[1:],
                              capsys)
    assert rc == ref_rc == 0
    assert out == ref_out and "trials completed: 4" in out
    kind = "sqlite" if backend == "sqlite" else "pickled"
    got = _trials(create_storage({"type": kind, "path": port_db}), "grid")
    assert got == _trials(ref_create_storage({"type": kind, "path": ref_db}), "grid")
    assert len(got) == 4 and {t[3] for t in got} == {"completed"}


def test_hunt_broken_box_stops_like_reference(tmp_path, capsys):
    box, grid = _scripts(tmp_path)
    broken = str(tmp_path / "broken_box.py")
    results = []
    for fn, extra in ((main, ["--device", "cpu"]), (ref_main, [])):
        db = str(tmp_path / f"{len(results)}.sqlite")
        rc, _, err = _run(fn, ["hunt", "-n", "broken", "--storage-path", db, *extra, "-c", grid,
                               "--max-broken", "2", "--max-trials", "4", broken,
                               "-x~uniform(-50, 50)"], capsys)
        results.append((rc, _trials(create_storage({"type": "sqlite", "path": db}), "broken")))
        assert "too many broken trials" in err
    assert results[0] == results[1]
    assert results[0][0] == 1 and [t[3] for t in results[0][1]] == ["broken", "broken"]


def test_reference_experiment_resumes_in_port_with_argless_hunt(tmp_path, capsys):
    """``orion-tpu hunt`` creates the experiment on ``pickled`` from a script
    in a git repository; ``orion-tpu-torch hunt -n NAME`` resumes it with no
    script and no priors: the stored parser state, script path, git
    metadata and config hash must equal what the port computes, or its
    build would report a conflict.  It then runs the trials the reference
    would have run next."""
    repo, script = make_script_repo(tmp_path)
    _, grid = _scripts(tmp_path)
    db = str(tmp_path / "db.pkl")
    rc, _, _ = _run(ref_main, ["hunt", "-n", "resume", "--storage-path", db, "-c", grid,
                               "--max-trials", "2", script, "--config",
                               str(repo / "conf.yaml"), "-x~uniform(-50, 50)"], capsys)
    assert rc == 0
    [stored] = ref_create_storage({"type": "pickled", "path": db}).fetch_experiments({})
    assert stored["metadata"]["vcs"]["HEAD_sha"] and stored["metadata"]["script_config_hash"]
    shutil.copy(db, tmp_path / "ref-continued.pkl")
    rc, out, _ = _run(main, ["hunt", "-n", "resume", "--storage-path", db, "--max-trials", "4",
                             "--device", "cpu"], capsys)
    assert rc == 0 and "trials completed: 4" in out
    ref_rc, _, _ = _run(ref_main, ["hunt", "-n", "resume", "--storage-path",
                                   str(tmp_path / "ref-continued.pkl"), "--max-trials", "4"],
                        capsys)
    assert ref_rc == 0
    port_storage = create_storage({"type": "pickled", "path": db})
    [resumed] = port_storage.fetch_experiments({})
    assert resumed == stored  # the resume changed nothing of the experiment
    got = _trials(port_storage, "resume")
    assert got == _trials(create_storage({"type": "pickled",
                                          "path": str(tmp_path / "ref-continued.pkl")}),
                          "resume")
    assert len(got) == 4 and {t[3] for t in got} == {"completed"}


def _copy_sqlite(src, dst):
    """A copy of a live SQLite file (its WAL included) through the backup
    API."""
    import sqlite3

    with sqlite3.connect(src) as source, sqlite3.connect(dst) as target:
        source.backup(target)


def _strip_doc(doc):
    return {k: v for k, v in doc.items() if k not in WALL_CLOCK}


def test_init_only_status_and_insert_print_the_reference_text(tmp_path, capsys):
    """``init-only`` stores the reference's experiment document (git
    metadata, parser state and config hash included); ``status`` in each of
    its forms and ``insert`` print the reference's text on the same file,
    and the inserted trial is the reference's."""
    repo, script = make_script_repo(tmp_path)
    box, grid = _scripts(tmp_path)
    init = ["init-only", "-n", "init", "-c", grid, script, "--config",
            str(repo / "conf.yaml"), "-x~uniform(-50, 50)"]
    port_db, ref_db = str(tmp_path / "port.sqlite"), str(tmp_path / "ref.sqlite")
    rc, out, _ = _run(main, init[:1] + ["--storage-path", port_db] + init[1:], capsys)
    ref_rc, ref_out, _ = _run(ref_main, init[:1] + ["--storage-path", ref_db] + init[1:], capsys)
    assert rc == ref_rc == 0 and out == ref_out == "Initialized experiment init (v1)\n"
    [got] = create_storage({"type": "sqlite", "path": port_db}).fetch_experiments({})
    [want] = ref_create_storage({"type": "sqlite", "path": ref_db}).fetch_experiments({})
    for doc in (got, want):
        doc["metadata"].pop("timestamp")
    assert got == want and got["metadata"]["vcs"] and got["metadata"]["script_config_hash"]

    rc, _, _ = _run(ref_main, ["hunt", "-n", "st", "--storage-path", ref_db, "-c", grid,
                               "--max-trials", "3", box, "-x~uniform(-50, 50)"], capsys)
    assert rc == 0
    for argv in (["status"], ["status", "--all"], ["status", "-n", "st", "--expand-versions"],
                 ["status", "--collapse"], ["status", "-n", "nosuch"]):
        db = ["--storage-path", ref_db]
        port_result = _run(main, argv + db, capsys)
        assert port_result == _run(ref_main, argv + db, capsys), argv
        assert port_result[0] == 0
    dbs = {}
    for tag, fn in (("port", main), ("ref", ref_main)):
        dbs[tag] = str(tmp_path / f"insert-{tag}.sqlite")
        _copy_sqlite(ref_db, dbs[tag])
        dbs[tag + "_out"] = _run(fn, ["insert", "-n", "st", "--storage-path", dbs[tag],
                                      "x=1.5"], capsys)
    assert dbs["port_out"] == dbs["ref_out"]
    assert dbs["port_out"][:2] == (0, "Inserted 1 trial into st (v1)\n")

    def inserted(make, path):
        return sorted((_strip_doc(d) for d in make({"type": "sqlite", "path": path})
                       .db.read("trials", {"status": "new"})), key=lambda d: d["_id"])

    assert inserted(create_storage, dbs["port"]) == inserted(ref_create_storage, dbs["ref"])
    assert len(inserted(create_storage, dbs["port"])) == 1


def test_hunt_without_device_fails_where_no_card_is_present(tmp_path, capsys, monkeypatch):
    """No silent CPU run: ``--device`` defaults to ``cuda`` and, with no
    card, the command exits non-zero with ``resolve_device``'s error and
    stores no experiment."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    box, _ = _scripts(tmp_path)
    db = str(tmp_path / "db.sqlite")
    rc, _, err = _run(main, ["hunt", "-n", "nocard", "--storage-path", db, "--max-trials", "1",
                             box, "-x~uniform(-50, 50)"], capsys)
    assert rc == 1 and "no CUDA device" in err
    assert create_storage({"type": "sqlite", "path": db}).fetch_experiments({}) == []


def test_cli_lists_only_the_ported_commands(capsys):
    from orion_tpu_torch.cli import build_parser

    commands = build_parser()._subparsers._group_actions[0].choices
    assert sorted(commands) == ["audit", "flight-record", "hunt", "init-only", "insert",
                                "list", "metrics", "status", "trace"]
    with pytest.raises(SystemExit):
        main(["--version"])
    assert capsys.readouterr().out.startswith("orion-tpu-torch ")


def test_hunt_refuses_unported_storage_and_memory_workers(tmp_path, capsys, monkeypatch):
    box, _ = _scripts(tmp_path)
    rc, _, err = _run(main, ["hunt", "-n", "nw", "--debug", "--device", "cpu", "--max-trials",
                             "2", "--n-workers", "2", box, "-x~uniform(-5, 5)"], capsys)
    assert rc == 1 and "in-memory storage is per-process" in err
    monkeypatch.setenv("ORION_DB_TYPE", "network")
    with pytest.raises(NotImplementedError, match="item 7"):
        main(["hunt", "-n", "net", "--device", "cpu", box, "-x~uniform(-5, 5)"])
