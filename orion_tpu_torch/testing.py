"""Shipped test harness for algorithm/plugin authors (port of
``orion_tpu/testing.py``).

Capability parity: Oríon's ``OrionState`` (`src/orion/core/utils/tests.py`)
and its scriptable ``DumbAlgo`` fake — shipped *in the package* so a
third-party algorithm plugin can test suggest/observe against the full
producer/worker stack using only the published distribution:

    from orion_tpu_torch.testing import DumbAlgo, OrionState

    def test_my_plugin():
        with OrionState(
            experiments=[{"name": "exp", "priors": {"/x": "uniform(0, 1)"}}],
        ) as state:
            exp = state.get_experiment("exp").instantiate(device="cpu")
            producer = Producer(exp)
            producer.update(); producer.produce(4)
            ...

``OrionState`` installs a fresh storage (in-memory by default, or a
file-locked pickled DB in a tempdir with ``pickled=True`` for multi-process
scenarios), preloads experiments/trials/lies, swaps the process-wide storage
singleton, and restores everything on exit.
"""

import contextlib
import os
import shutil
import tempfile

import numpy as np

import orion_tpu_torch.storage.base as _storage_base
from orion_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from orion_tpu_torch.core.experiment import Experiment, build_experiment
from orion_tpu_torch.core.trial import Trial
from orion_tpu_torch.storage import create_storage


@algo_registry.register("dumbalgo")
class DumbAlgo(BaseAlgorithm):
    """Fully scriptable fake algorithm (Oríon's ``DumbAlgo`` test fake).

    - suggests a constant unit-cube ``value`` (so resulting params are
      deterministic), counting every request;
    - records every observation it receives;
    - ``opt_out=True`` makes ``suggest`` return None (the temporary opt-out
      contract of ``BaseAlgorithm.suggest``);
    - ``done=True`` drives the ``is_done`` early-stop path.
    """

    def __init__(self, space, value=0.5, possible_values=None, seed=None, device=None):
        super().__init__(space, seed=seed, device=device, value=value)
        self.value = value
        # Scriptable distinct suggestions (reference DumbAlgo's
        # possible_values): successive suggested points consume successive
        # values, so a producer asking for q unique trials gets them.
        self.possible_values = list(possible_values or [])
        self._value_cursor = 0
        self.n_suggested = 0
        self.observed_params = []
        self.observed_results = []
        self.opt_out = False
        self.done = False

    def _suggest_cube(self, num):
        if self.opt_out:
            return None
        self.n_suggested += num
        if self.possible_values:
            rows = []
            for _ in range(num):
                v = self.possible_values[
                    self._value_cursor % len(self.possible_values)
                ]
                self._value_cursor += 1
                rows.append(np.full((self.space.n_cols,), v))
            return np.stack(rows)
        return np.full((num, self.space.n_cols), self.value)

    def observe_arrays(self, cube, objectives, params_list=None, fidelities=None):
        self.observed_params.extend(params_list or [])
        self.observed_results.extend(np.asarray(objectives).tolist())

    def register_suggestion(self, params):
        # The producer suggests through a fresh deepcopy every round; advance
        # the REAL instance's cursor per durably-registered trial so the next
        # naive copy starts at the first unconsumed value.
        if self.possible_values:
            self._value_cursor += 1

    @property
    def is_done(self):
        return self.done


def drive_chaos_experiment(
    storage,
    name="chaos",
    priors=None,
    algorithms=None,
    max_trials=9,
    pool_size=3,
    seed=1,
    heartbeat=2.0,
    max_idle_time=30.0,
    proxy=None,
    drop_every=0,
    deadline=120.0,
    device=None,
):
    """THE shared chaos-run harness: drive an experiment to completion the
    way a worker does — reserve, complete, tolerate transient storage
    failures with a short backoff — against a (typically fault-injected)
    storage, then sweep lost trials and audit.

    Shipped in the package so third-party backend authors can chaos-test
    their own storage the same way.  ``proxy``/``drop_every`` schedule
    connection drops through a
    :class:`~orion_tpu_torch.storage.faults.FaultProxy` every N
    iterations; ``deadline`` bounds the whole run (TimeoutError on
    non-convergence — a hung chaos run must fail loudly, not spin).
    ``device`` is the algorithm's (None means ``cuda``).

    Returns ``(experiment, audit_report)``.
    """
    import time

    from orion_tpu_torch.core.producer import Producer
    from orion_tpu_torch.core.trial import Result
    from orion_tpu_torch.core.worker import reserve_trial
    from orion_tpu_torch.storage.audit import audit_experiment
    from orion_tpu_torch.storage.retry import is_transient

    experiment = build_experiment(
        storage,
        name,
        priors=dict(priors or {"/x": "uniform(0, 1)", "/y": "uniform(0, 1)"}),
        algorithms=algorithms or {"random": {"seed": seed}},
        max_trials=max_trials,
        pool_size=pool_size,
        metadata={"user": "chaos"},
    ).instantiate(seed=seed, device=device)
    experiment.heartbeat = heartbeat  # reply-lost orphans recover fast
    producer = Producer(experiment, max_idle_time=max_idle_time)
    producer.update()
    stop_at = time.monotonic() + deadline
    iterations = 0
    while not experiment.is_done:
        if time.monotonic() >= stop_at:
            raise TimeoutError(
                f"chaos run failed to converge within {deadline}s "
                f"({iterations} iterations)"
            )
        iterations += 1
        if proxy is not None and drop_every and iterations % drop_every == 0:
            proxy.drop_all()  # scheduled "server restart"
        try:
            trial = reserve_trial(experiment, producer)
            value = float(next(iter(trial.params.values())))
            experiment.update_completed_trial(
                trial, [Result("obj", "objective", value)]
            )
        except Exception as exc:
            # The worker loop's degradation contract: transient failures
            # that exhausted the storage policy back off and retry; real
            # bugs raise.
            if not is_transient(exc):
                raise
            time.sleep(0.01)
    # Recover any reply-lost orphaned reservations the run left behind —
    # the sweep is the production path for exactly this state.
    time.sleep(0.05)
    experiment.fix_lost_trials()
    report = audit_experiment(
        experiment.storage, experiment, lost_timeout=experiment.heartbeat
    )
    return experiment, report


class OrionState(contextlib.AbstractContextManager):
    """Temporary, fully-populated orion-tpu-torch stack for tests.

    Parameters
    ----------
    experiments : list of dict
        Experiment configs for :func:`build_experiment` (each needs at least
        ``name``; ``priors`` defaults to a 1-D uniform space and
        ``algorithms`` to the scriptable ``dumbalgo``).
    trials / lies : list of dict or Trial
        Preloaded into the FIRST experiment unless a dict carries an
        explicit ``experiment`` id.
    pickled : bool
        Use a file-locked pickled DB in a private tempdir instead of the
        in-memory store — reach for this in multi-process tests.
    """

    def __init__(self, experiments=(), trials=(), lies=(), pickled=False):
        self._experiment_configs = list(experiments)
        self._trial_docs = list(trials)
        self._lie_docs = list(lies)
        self._pickled = pickled
        self._tempdir = None
        self._saved_singleton = None
        self.storage = None
        self.experiments = []

    # --- setup / teardown ---------------------------------------------------
    def __enter__(self):
        if self._pickled:
            self._tempdir = tempfile.mkdtemp(prefix="orion_tpu_torch_state_")
            self.storage = create_storage(
                {"type": "pickled", "path": os.path.join(self._tempdir, "db.pkl")}
            )
        else:
            self.storage = create_storage({"type": "memory"})
        self._saved_singleton = _storage_base._storage_singleton
        _storage_base._storage_singleton = self.storage

        for config in self._experiment_configs:
            config = dict(config)
            name = config.pop("name")
            config.setdefault("priors", {"/x": "uniform(0, 1)"})
            config.setdefault("algorithms", {"dumbalgo": {}})
            self.experiments.append(
                build_experiment(self.storage, name, **config)
            )
        default_exp = self.experiments[0].id if self.experiments else None
        for doc in self._trial_docs:
            self.storage.register_trial(self._as_trial(doc, default_exp))
        for doc in self._lie_docs:
            self.storage.register_lie(self._as_trial(doc, default_exp))
        return self

    def __exit__(self, exc_type, exc, tb):
        _storage_base._storage_singleton = self._saved_singleton
        if self._tempdir:
            shutil.rmtree(self._tempdir, ignore_errors=True)
        return False

    # --- helpers ------------------------------------------------------------
    def _as_trial(self, doc, default_experiment):
        if isinstance(doc, Trial):
            if doc.experiment is None and default_experiment is not None:
                doc.experiment = default_experiment
            return doc
        doc = dict(doc)
        doc.setdefault("experiment", default_experiment)
        return Trial(**doc)

    def get_experiment(self, name, version=None):
        """Reload an experiment from the temporary storage."""
        query = {"name": name}
        if version is not None:
            query["version"] = version
        docs = self.storage.fetch_experiments(query)
        if not docs:
            raise KeyError(f"no experiment {name!r} in OrionState")
        return Experiment(self.storage, max(docs, key=lambda d: d.get("version", 1)))
