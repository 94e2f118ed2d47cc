"""The port's storage audit (``orion_tpu_torch.storage.audit``) against
``orion_tpu``'s: ``audit_experiment`` and ``audit_storage`` over the same
trial documents on each backend, clean and with seeded violations, give the
same report; ``Experiment.audit`` and the ``audit`` command (its text and
exit codes) match the reference's on one file."""

import json

import numpy as np
import pytest

from orion_tpu.cli import main as ref_main
from orion_tpu.core.trial import Trial as RefTrial
from orion_tpu.storage import audit as ref_audit
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu_torch.cli import main
from orion_tpu_torch.core.experiment import build_experiment
from orion_tpu_torch.core.trial import Result, Trial
from orion_tpu_torch.storage import audit
from orion_tpu_torch.storage.base import create_storage

#: Seeded violations, one case each, and all of them at once.
VIOLATIONS = ("duplicate_point", "lost_observation", "stale_reservation", "no_heartbeat",
              "unknown_status")
CASES = ("clean", *VIOLATIONS, "all")
NOW = 1000.0


def _seed(storage, trial_cls, case, seed=0):
    """Two experiments: one clean, one carrying ``case``'s violations;
    numpy-seeded points, the same documents for both packages."""
    rng = np.random.default_rng(seed)
    ids = []
    for name, heartbeat in (("exp", 30.0), ("other", None)):
        config = {"name": name, "metadata": {}}
        if heartbeat is not None:
            config["heartbeat"] = heartbeat
        exp_id = storage.create_experiment(config)["_id"]
        ids.append(exp_id)
        for _ in range(6):
            storage.register_trial(trial_cls(
                experiment=exp_id, status="completed", params={"/x": float(rng.uniform())},
                results=[{"name": "o", "type": "objective", "value": float(rng.normal())}],
                submit_time=1.0, end_time=2.0))
    exp_id = ids[0]
    todo = VIOLATIONS if case == "all" else (case,) if case != "clean" else ()
    x = float(rng.uniform())
    if "duplicate_point" in todo:
        first = storage.fetch_trials(uid=exp_id)[0].to_dict()
        storage.db.write("trials", dict(first, _id="not-the-md5"))
    if "lost_observation" in todo:
        storage.register_trial(trial_cls(experiment=exp_id, status="completed",
                                         params={"/x": x + 1}, end_time=2.0))
        storage.register_trial(trial_cls(
            experiment=exp_id, status="completed", params={"/x": x + 2},
            results=[{"name": "o", "type": "objective", "value": 1.0}]))
    if "stale_reservation" in todo:
        storage.register_trial(trial_cls(experiment=exp_id, status="reserved",
                                         params={"/x": x + 3}, start_time=1.0, heartbeat=1.0))
        storage.register_trial(trial_cls(experiment=exp_id, status="reserved",
                                         params={"/x": x + 4}, start_time=NOW - 5,
                                         heartbeat=NOW - 5))
    if "no_heartbeat" in todo:
        storage.register_trial(trial_cls(experiment=exp_id, status="reserved",
                                         params={"/x": x + 5}))
    if "unknown_status" in todo:
        doc = trial_cls(experiment=exp_id, params={"/x": x + 6}).to_dict()
        storage.db.write("trials", dict(doc, status="zombie"))
    return ids


def _report(report):
    return (report.experiment_id, report.n_trials, report.status_counts, report.violations,
            report.ok, report.summary())


def _audits(module, storage, ids):
    exp_doc = storage.fetch_experiments({"_id": ids[0]})[0]
    return {
        "by_id": _report(module.audit_experiment(storage, ids[0], lost_timeout=60.0, now=NOW)),
        # The experiment document's heartbeat (30 s) is the threshold.
        "by_doc": _report(module.audit_experiment(storage, exp_doc, now=NOW)),
        "storage": [_report(r) for r in module.audit_storage(storage, now=NOW)],
        "storage_timeout": [_report(r) for r in module.audit_storage(storage, lost_timeout=1e4,
                                                                     now=NOW)],
    }


def _storages(tmp_path, backend):
    if backend == "memory":
        return create_storage({"type": "memory"}), ref_create_storage({"type": "memory"})
    ext = "sqlite" if backend == "sqlite" else "pkl"
    return (create_storage({"type": backend, "path": str(tmp_path / f"port.{ext}")}),
            ref_create_storage({"type": backend, "path": str(tmp_path / f"ref.{ext}")}))


@pytest.mark.parametrize("backend", ["memory", "pickled", "sqlite"])
@pytest.mark.parametrize("case", CASES)
def test_audit_reports_match_reference(tmp_path, backend, case):
    """The same report from both packages (ids, counts by status, every
    violation and its message, ``ok``, the summary text), by id, by the
    experiment's document, and over the whole storage."""
    port, ref = _storages(tmp_path, backend)
    got = _audits(audit, port, _seed(port, Trial, case))
    want = _audits(ref_audit, ref, _seed(ref, RefTrial, case))
    assert got == want
    checks = {v["check"] for v in got["by_id"][3]}
    expected = {"duplicate_point": {"duplicate-point"},
                "lost_observation": {"lost-observation"},
                "stale_reservation": {"orphaned-reservation"}, "no_heartbeat": {"heartbeat"},
                "unknown_status": {"status"}}
    want_checks = (set().union(*expected.values()) if case == "all"
                   else expected.get(case, set()))
    assert checks == want_checks
    assert got["by_id"][4] is (case == "clean")
    if case == "stale_reservation":  # the heartbeat 5 s old is inside both thresholds
        assert len(got["by_id"][3]) == 1 and len(got["by_doc"][3]) == 1
    assert [r[4] for r in got["storage"]] == [case == "clean", True]


def _cli_store(tmp_path):
    """An experiment built by the port on SQLite with six completed
    trials; returns (path, experiment)."""
    db = str(tmp_path / "audit.sqlite")
    storage = create_storage({"type": "sqlite", "path": db})
    exp = build_experiment(storage, "aud", priors={"/x": "uniform(0, 1)"},
                           metadata={"user": "u"})
    rng = np.random.default_rng(3)
    for _ in range(6):
        exp.register_trial(Trial(params={"/x": float(rng.uniform())}))
        exp.update_completed_trial(exp.reserve_trial(),
                                   [Result("o", "objective", float(rng.normal()))])
    return db, exp


def _run(fn, argv, capsys):
    rc = fn(argv)
    captured = capsys.readouterr()
    return rc, captured.out


def test_audit_command_text_and_exit_codes_match_reference(tmp_path, capsys):
    """``audit -n NAME`` and ``audit --all``: exit 0 and the same report
    on a clean file, exit 1 and the same report once a completed trial
    lost its objective; an unknown name exits 1 in both.  ``Experiment.audit``
    gives the report the command prints."""
    db, exp = _cli_store(tmp_path)
    runs = [["audit", "-n", "aud"], ["audit", "--all"], ["audit", "-n", "aud", "--timeout", "1"]]
    for argv in runs:
        got = _run(main, argv + ["--storage-path", db], capsys)
        assert got == _run(ref_main, argv + ["--storage-path", db], capsys)
        assert got[0] == 0 and "audit: OK" in got[1]
    assert exp.audit().summary() + "\n" == _run(main, runs[0] + ["--storage-path", db],
                                                capsys)[1]
    storage = create_storage({"type": "sqlite", "path": db})
    storage.db.write("trials", {"results": []}, query={"experiment": exp.id, "status": "completed"})
    for argv in runs[:2]:
        got = _run(main, argv + ["--storage-path", db], capsys)
        want = _run(ref_main, argv + ["--storage-path", db], capsys)
        # The reference's failed audit adds a hint about its flight recorder.
        assert got[0] == want[0] == 1
        assert got[1] == want[1][:len(got[1])] and "6 violation(s)" in got[1]
        assert "lost-observation" in got[1]
    assert not exp.audit().ok
    assert _run(main, ["audit", "-n", "nosuch", "--storage-path", db], capsys)[0] == 1
    assert _run(ref_main, ["audit", "-n", "nosuch", "--storage-path", db], capsys)[0] == 1


def test_audit_flight_out_raises_until_the_flight_recorder_is_ported(tmp_path, capsys):
    """The flight recorder is ported: a clean audit writes nothing at
    ``--flight-out``, a failed one exits 1 and writes the dump, whose
    ``audit.violation`` events equal the reference's on the same file
    (exact, without their wall-clock ``ts``), after the reference's
    header layout.  The name dates from when ``--flight-out`` raised and
    is kept so that the test's record runs on under one name."""
    db, exp = _cli_store(tmp_path)
    outs = {pkg: tmp_path / f"flight-{pkg}.jsonl" for pkg in ("port", "ref")}
    argv = ["audit", "-n", "aud", "--storage-path", db, "--flight-out"]
    assert _run(main, argv + [str(outs["port"])], capsys)[0] == 0
    assert not outs["port"].exists()
    storage = create_storage({"type": "sqlite", "path": db})
    storage.db.write("trials", {"results": []}, query={"experiment": exp.id, "status": "completed"})
    got = _run(main, argv + [str(outs["port"])], capsys)
    want = _run(ref_main, argv + [str(outs["ref"])], capsys)
    assert got == (1, want[1].replace(str(outs["ref"]), str(outs["port"])))
    lines = {pkg: [json.loads(line) for line in path.read_text().splitlines()]
             for pkg, path in outs.items()}
    header = {pkg: lines[pkg][0] for pkg in lines}
    assert header["port"]["type"] == "flight-record" and header["port"]["reason"] == "audit-failure"
    assert set(header["port"]) == set(header["ref"])
    events = {pkg: [{k: v for k, v in e.items() if k != "ts"} for e in lines[pkg][1:]]
              for pkg in lines}
    assert events["port"] == events["ref"] and len(events["port"]) == 6
    assert {e["kind"] for e in events["port"]} == {"audit.violation"}
