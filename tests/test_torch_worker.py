"""The port's worker runtime against ``orion_tpu``'s: the consumer (the
``ORION_*`` environment contract and every way a trial can end), the
pacemaker, ``reserve_trial``, ``workon``'s storage-degrade path and the
summary; then the port's own worker paths: ``--n-workers`` on SQLite,
``--profile``, and a ``tpu_bo`` hunt reaching the fused cross-gram."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import yaml

from orion_tpu.core import consumer as ref_consumer
from orion_tpu.core import pacemaker as ref_pacemaker
from orion_tpu.core import worker as ref_worker
from orion_tpu.core.experiment import build_experiment as ref_build_experiment
from orion_tpu.core.trial import Trial as RefTrial
from orion_tpu.io.cmdline import CommandLineParser as RefCommandLineParser
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu.utils import exceptions as ref_exceptions
from orion_tpu_torch.cli import main
from orion_tpu_torch.core import consumer, pacemaker, worker
from orion_tpu_torch.core.experiment import build_experiment
from orion_tpu_torch.core.trial import Trial
from orion_tpu_torch.io.cmdline import CommandLineParser
from orion_tpu_torch.storage.base import create_storage
from orion_tpu_torch.utils import exceptions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUNCTIONAL = os.path.join(ROOT, "tests", "functional")

PORT = types.SimpleNamespace(consumer=consumer, pacemaker=pacemaker, worker=worker,
                             build=build_experiment, Trial=Trial, Parser=CommandLineParser,
                             storage=create_storage, exc=exceptions)
REF = types.SimpleNamespace(consumer=ref_consumer, pacemaker=ref_pacemaker, worker=ref_worker,
                            build=ref_build_experiment, Trial=RefTrial,
                            Parser=RefCommandLineParser, storage=ref_create_storage,
                            exc=ref_exceptions)

#: User scripts for each way a trial ends.
SCRIPTS = {
    "completed": "from orion_tpu.client import report_results\n"
                 "report_results([{'name': 'objective', 'type': 'objective', 'value': 2.5},"
                 " {'name': 'acc', 'type': 'statistic', 'value': 0.9}])\n",
    "nonzero_exit": "import sys\nsys.exit(3)\n",
    "no_results": "pass\n",
    "invalid_json": "import os\nopen(os.environ['ORION_RESULTS_PATH'], 'w').write('{oops')\n",
    "no_objective": "from orion_tpu.client import report_results\n"
                    "report_results([{'name': 'acc', 'type': 'statistic', 'value': 0.9}])\n",
}


def _experiment(pkg, script, name="w"):
    parser = pkg.Parser()
    priors = parser.parse([script, "-x~uniform(-50, 50)"])
    exp = pkg.build(pkg.storage({"type": "memory"}), name, priors=priors, max_trials=10,
                    metadata={"user": "u"})
    return exp, parser


def _reserved(pkg, exp, x=1.5):
    exp.register_trial(pkg.Trial(params={"/x": x}))
    return exp.reserve_trial()


def test_consumer_environment_matches_reference(tmp_path):
    """The env contract user scripts rely on, key for key, the package root
    on ``PYTHONPATH`` included (both packages live at the repo root)."""
    envs = []
    for pkg in (PORT, REF):
        exp, parser = _experiment(pkg, "s.py")
        trial = _reserved(pkg, exp)
        trial.working_dir = str(tmp_path)
        envs.append(pkg.consumer.Consumer(exp, parser)._execution_environment(
            trial, str(tmp_path / "results.log")))
    assert envs[0] == envs[1]
    assert envs[0]["ORION_TRIAL_ID"] and envs[0]["ORION_EXPERIMENT_NAME"] == "w"
    assert ROOT in envs[0]["PYTHONPATH"].split(os.pathsep)


@pytest.mark.parametrize("ending", sorted(SCRIPTS))
def test_consumer_outcome_matches_reference(tmp_path, ending):
    """Success stores the results; a nonzero exit, no results, malformed
    results and no objective each leave the trial ``broken``."""
    script = tmp_path / "box.py"
    script.write_text(SCRIPTS[ending])
    outcomes = []
    for pkg in (PORT, REF):
        exp, parser = _experiment(pkg, str(script))
        trial = _reserved(pkg, exp)
        ok = pkg.consumer.Consumer(exp, parser).consume(trial)
        [stored] = exp.fetch_trials()
        outcomes.append((ok, stored.id, stored.status,
                         [(r.name, r.type, r.value) for r in stored.results]))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][2] == ("completed" if ending == "completed" else "broken")


_SIGTERM_RUN = """
import json, sys
from orion_tpu_torch.core.consumer import Consumer
from orion_tpu_torch.core.experiment import build_experiment
from orion_tpu_torch.core.trial import Trial
from orion_tpu_torch.io.cmdline import CommandLineParser
from orion_tpu_torch.storage.base import create_storage

parser = CommandLineParser()
priors = parser.parse([sys.argv[1], "-x~uniform(-50, 50)"])
exp = build_experiment(create_storage({"type": "memory"}), "sig", priors=priors)
exp.register_trial(Trial(params={"/x": 1.0}))
trial = exp.reserve_trial()
try:
    Consumer(exp, parser).consume(trial)
    outcome = "returned"
except KeyboardInterrupt:
    outcome = "interrupted"
print(json.dumps([outcome, exp.fetch_trials()[0].status]))
"""

_SIGTERM_BOX = """import os, signal, time
time.sleep(0.5)  # past the consumer's installing its handler
os.kill(os.getppid(), signal.SIGTERM)
time.sleep(30)
"""


def test_sigterm_interrupts_the_trial(tmp_path):
    """SIGTERM to the worker while a trial runs terminates the user's
    process, marks the trial ``interrupted`` and re-raises (run in its own
    process: the signal goes to the worker)."""
    script = tmp_path / "sigterm_box.py"
    script.write_text(_SIGTERM_BOX)
    proc = subprocess.run([sys.executable, "-c", _SIGTERM_RUN, str(script)], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == ["interrupted", "interrupted"]


class _BeatStorage:
    """``update_heartbeat`` fails ``failures`` times (storage errors), then
    succeeds ``beats`` times, then reports the trial gone."""

    def __init__(self, exc, failures, beats):
        self.exc, self.failures, self.beats, self.calls = exc, failures, beats, 0

    def update_heartbeat(self, trial):
        self.calls += 1
        if self.calls <= self.failures:
            raise self.exc.DatabaseError("down")
        if self.calls <= self.failures + self.beats:
            return
        raise self.exc.FailedUpdate("no longer reserved")


@pytest.mark.parametrize("failures,beats", [(0, 3), (4, 2)])
def test_pacemaker_matches_reference(failures, beats):
    """Beats until the trial is no longer reserved; storage failures are
    swallowed and counted, reset by the next good beat."""
    seen = []
    for pkg in (PORT, REF):
        storage = _BeatStorage(pkg.exc, failures, beats)
        beat = pkg.pacemaker.TrialPacemaker(storage, types.SimpleNamespace(id="t"),
                                            wait_time=0.005, max_failed_beats=2)
        beat.start()
        beat.join(timeout=30)
        assert not beat.is_alive()
        seen.append((storage.calls, beat.consecutive_failures))
    assert seen[0] == seen[1] == (failures + beats + 1, 0)


class _Policy:
    def __init__(self):
        self.sleeps = []

    def sleep(self, attempt, **_):
        self.sleeps.append(attempt)


@pytest.mark.parametrize("registers_on", [1, 3, None])
def test_reserve_trial_matches_reference(registers_on):
    """Produce when the queue is dry, back off between empty-handed rounds,
    give up with ``WaitingForTrials`` after ``max_rounds``."""
    seen = []
    for pkg in (PORT, REF):
        exp, _ = _experiment(pkg, "s.py")
        rounds = []

        class Producer:
            def update(self):
                pass

            def produce(self):
                rounds.append(1)
                if len(rounds) == registers_on:
                    exp.register_trial(pkg.Trial(params={"/x": 2.0}))

        policy = _Policy()
        try:
            trial = pkg.worker.reserve_trial(exp, Producer(), max_rounds=4, policy=policy)
            outcome = trial.params
        except pkg.exc.WaitingForTrials as exc:
            outcome = str(exc)
        seen.append((outcome, len(rounds), policy.sleeps))
    assert seen[0] == seen[1]


def test_workon_absorbs_a_transient_storage_failure_like_reference(tmp_path):
    """One failed status read backs the worker off instead of killing it;
    the loop then runs its trials as without the failure."""
    script = tmp_path / "box.py"
    script.write_text(SCRIPTS["completed"])
    seen = []
    for pkg in (PORT, REF):
        exp, parser = _experiment(pkg, str(script))
        exp.max_trials = 2
        exp.instantiate(**({"device": "cpu"} if pkg is PORT else {}))
        storage = exp.storage
        real = storage.count_broken_trials
        calls = []

        def flaky(*args, real=real, calls=calls, exc=pkg.exc):
            calls.append(1)
            if len(calls) == 1:
                raise exc.DatabaseError("transient")
            return real(*args)

        storage.count_broken_trials = flaky
        iterations = pkg.worker.workon(exp, parser, max_idle_time=30.0)
        seen.append((iterations, sorted(t.status for t in exp.fetch_trials())))
    assert seen[0] == seen[1] == (2, ["completed", "completed"])


def test_format_stats_matches_reference():
    for stats in ({"trials_completed": 0, "best_evaluation": None},
                  {"trials_completed": 3, "best_evaluation": 0.5, "best_trials_id": "abc",
                   "best_params": {"/y": 2, "/x": 1.5}}):
        exp = types.SimpleNamespace(name="e", version=2, stats=lambda s=stats: dict(s))
        text = worker.format_stats(exp)
        assert text == ref_worker.format_stats(exp)
    assert text.endswith("best trial: abc\nbest params:\n  /x: 1.5\n  /y: 2\n")


def _box(tmp_path):
    shutil.copy(os.path.join(FUNCTIONAL, "black_box.py"), tmp_path / "black_box.py")
    return str(tmp_path / "black_box.py")


def test_n_workers_share_the_budget_on_sqlite(tmp_path, capsys):
    """``--n-workers 2`` spawns one more hunt (``python -m
    orion_tpu_torch.cli``, ``--device cpu`` replayed) on the shared SQLite
    file; the pair completes the global budget once (a final trial in
    flight in the second worker may land past it, as in the reference)."""
    db = str(tmp_path / "db.sqlite")
    rc = main(["hunt", "-n", "nw", "--storage-path", db, "--device", "cpu", "--max-trials", "8",
               "--n-workers", "2", "--working-dir", str(tmp_path / "w"), _box(tmp_path),
               "-x~uniform(-5, 5)"])
    assert rc == 0
    assert "trials completed:" in capsys.readouterr().out
    storage = create_storage({"type": "sqlite", "path": db})
    [exp] = storage.fetch_experiments({"name": "nw"})
    completed = [t for t in storage.fetch_trials(uid=exp["_id"]) if t.status == "completed"]
    assert 8 <= len(completed) <= 9
    assert len({t.id for t in completed}) == len(completed)


def test_profile_writes_one_trace_per_worker(tmp_path, capsys):
    """``--profile DIR``: the worker's loop traced by ``torch.profiler`` into
    ``DIR/trace-<pid>.json`` (Chrome trace), its extent the
    ``hunt.workon`` span, the file named on stderr."""
    prof = tmp_path / "prof"
    rc = main(["hunt", "-n", "prof", "--debug", "--device", "cpu", "--max-trials", "2",
               "--profile", str(prof), _box(tmp_path), "-x~uniform(-5, 5)"])
    assert rc == 0
    path = prof / f"trace-{os.getpid()}.json"
    assert f"profile: wrote {path}" in capsys.readouterr().err
    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    [loop] = [e for e in events
              if e.get("name") == "hunt.workon" and e.get("cat") == "user_annotation"]
    assert loop["dur"] > 0


def test_tpu_bo_hunt_reaches_the_fused_cross_gram(tmp_path, capsys, monkeypatch):
    """A ``tpu_bo`` hunt whose GP rounds score 2^17 candidates against the
    64-row fit buffer (work 8.4e6, above the 8e6 threshold) goes through
    ``cross_kernel_matrix``'s fused route, on the CPU its plain version."""
    from orion_tpu_torch.algo.gp import kernels
    from orion_tpu_torch.ops import gram

    calls = []

    def spy(xa, xb, *args, **kwargs):
        calls.append((tuple(xa.shape), tuple(xb.shape)))
        return gram.fused_gram(xa, xb, *args, **kwargs)

    monkeypatch.setattr(kernels, "fused_gram", spy)
    conf = tmp_path / "bo.yaml"
    conf.write_text(yaml.safe_dump({"algorithms": {"tpu_bo": {
        "n_init": 4, "n_candidates": 2**17, "fit_steps": 5, "seed": 0}}}))
    rc = main(["hunt", "-n", "bo", "--debug", "--device", "cpu", "-c", str(conf),
               "--max-trials", "6", _box(tmp_path), "-x~uniform(-50, 50)"])
    assert rc == 0 and "trials completed: 6" in capsys.readouterr().out
    assert calls and all(c == ((2**17, 1), (64, 1)) for c in calls)
