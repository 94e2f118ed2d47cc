"""Consumer: execute one trial of the user's black box across a process
boundary (port of ``orion_tpu/core/consumer.py``).

Capability parity: reference `src/orion/core/worker/consumer.py` — per-trial
working dir, temp config/results files, concrete cmdline from the parser
template, the ``ORION_*`` environment contract of the client (a script
written against ``orion_tpu.client`` runs unchanged under the port),
subprocess launch with SIGTERM forwarding, heartbeat pacemaker during the
run, JSON results parsing on success, `interrupted` on Ctrl-C (re-raised),
`broken` on nonzero exit.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import tempfile

from orion_tpu_torch.core.pacemaker import TrialPacemaker
from orion_tpu_torch.core.trial import Result
from orion_tpu_torch.utils.exceptions import (
    ExecutionError,
    FailedUpdate,
    InvalidResult,
    MissingResultFile,
)
from orion_tpu_torch.utils.working_dir import WorkingDir

log = logging.getLogger(__name__)


class Consumer:
    def __init__(self, experiment, cmdline_parser, heartbeat_interval=60.0):
        self.experiment = experiment
        self.parser = cmdline_parser
        self.heartbeat_interval = heartbeat_interval

    def consume(self, trial):
        """Run the user script for one reserved trial; returns True on success."""
        temp_dir = self.experiment.working_dir is None
        prefix = f"{self.experiment.name}-{self.experiment.version}-"
        with WorkingDir(
            self.experiment.working_dir, temp=temp_dir, prefix=prefix, suffix=trial.id
        ) as workdir:
            trial.working_dir = workdir
            try:
                self._consume(trial, workdir)
            except KeyboardInterrupt:
                self._safe_status(trial, "interrupted")
                raise
            except (ExecutionError, MissingResultFile, InvalidResult) as exc:
                log.warning("Trial %s broken: %s", trial.id, exc)
                self._safe_status(trial, "broken")
                return False
        return True

    def _safe_status(self, trial, status):
        try:
            self.experiment.set_trial_status(trial, status, was="reserved")
        except FailedUpdate:  # pragma: no cover - concurrent transition
            pass

    def _consume(self, trial, workdir):
        results_file = tempfile.NamedTemporaryFile(
            mode="w", prefix="results_", suffix=".log", dir=workdir, delete=False
        )
        results_file.close()
        config_path = None
        if self.parser.has_config_file:
            conf = tempfile.NamedTemporaryFile(
                mode="w", prefix="trial_", suffix=".conf", dir=workdir, delete=False
            )
            conf.close()
            config_path = conf.name
            self.parser.generate_config(config_path, trial)

        env = self._execution_environment(trial, results_file.name)
        command = self.parser.format(trial, self.experiment, config_path=config_path)
        self._execute_process(command, env, trial)
        self._retrieve_results(trial, results_file.name)

    def _execution_environment(self, trial, results_path):
        """The env contract user scripts rely on (reference `consumer.py:108-159`)."""
        env = dict(os.environ)
        env["ORION_EXPERIMENT_ID"] = str(self.experiment.id)
        env["ORION_EXPERIMENT_NAME"] = str(self.experiment.name)
        env["ORION_EXPERIMENT_VERSION"] = str(self.experiment.version)
        env["ORION_TRIAL_ID"] = str(trial.id)
        env["ORION_WORKING_DIR"] = str(trial.working_dir)
        env["ORION_RESULTS_PATH"] = str(results_path)
        # Guarantee `orion_tpu_torch.client` is importable in the user script
        # even when the framework runs from a source checkout (not
        # pip-installed) and the trial's working dir is elsewhere.
        return with_package_on_path(env)

    def _execute_process(self, command, env, trial):
        command = list(command)
        if command and command[0].endswith(".py") and not os.access(command[0], os.X_OK):
            command = [sys.executable] + command
        pacemaker = TrialPacemaker(
            self.experiment.storage, trial, wait_time=self.heartbeat_interval
        )
        pacemaker.start()
        try:
            process = subprocess.Popen(command, env=env)
            previous = signal.signal(signal.SIGTERM, _make_sigterm_handler(process))
            try:
                return_code = process.wait()
            finally:
                signal.signal(signal.SIGTERM, previous)
            if return_code != 0:
                raise ExecutionError(
                    f"{' '.join(command)} exited with code {return_code}"
                )
        finally:
            pacemaker.stop()

    def _retrieve_results(self, trial, results_path):
        if not os.path.exists(results_path) or os.path.getsize(results_path) == 0:
            raise MissingResultFile(
                "script exited 0 but reported no results (did it call "
                "report_results?)"
            )
        with open(results_path) as handle:
            try:
                raw = json.load(handle)
            except json.JSONDecodeError as exc:
                raise InvalidResult(f"results file is not valid JSON: {exc}") from exc
        results = [Result(r["name"], r["type"], r["value"]) for r in raw]
        if not any(r.type == "objective" for r in results):
            raise InvalidResult("no result of type 'objective' was reported")
        self.experiment.update_completed_trial(trial, results)


def with_package_on_path(env):
    """``env`` with the directory that holds ``orion_tpu_torch`` on its
    ``PYTHONPATH``, appended (not prepended) so the user's own entries keep
    priority."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    existing = env.get("PYTHONPATH")
    if not existing:
        env["PYTHONPATH"] = pkg_root
    elif pkg_root not in existing.split(os.pathsep):
        env["PYTHONPATH"] = existing + os.pathsep + pkg_root
    return env


def _make_sigterm_handler(process):
    def handler(signum, frame):  # pragma: no cover - signal path
        process.terminate()
        raise KeyboardInterrupt("SIGTERM received; trial interrupted")

    return handler
