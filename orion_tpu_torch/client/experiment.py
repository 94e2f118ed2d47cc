"""Library-level optimization API — no subprocess, no CLI (port of
``orion_tpu/client/experiment.py``).

The reference exposes `workon` as a library (used in
tests/functional/demo/test_demo.py "workon as library"); here that surface is
a first-class `optimize()` driving a python callable directly, plus an
`ExperimentClient` with suggest/observe for external loops (e.g. evaluating
a whole q-batch on the device at once).

Both build the algorithm on ``cuda`` unless ``device="cpu"`` is passed, and
raise where no card is present.
"""

import numpy as np
import torch

from orion_tpu_torch.core.experiment import build_experiment
from orion_tpu_torch.core.producer import Producer
from orion_tpu_torch.core.trial import Result
from orion_tpu_torch.storage.base import create_storage
from orion_tpu_torch.utils.exceptions import AlgorithmExhausted, WaitingForTrials


class ExperimentClient:
    """suggest/observe handle over a built experiment.  An experiment not
    yet instantiated is instantiated on ``device`` (``None`` means
    ``cuda``)."""

    def __init__(self, experiment, max_idle_time=60.0, device=None):
        self.experiment = experiment
        if experiment.algorithm is None:
            experiment.instantiate(device=device)
        self.producer = Producer(experiment, max_idle_time=max_idle_time)

    @property
    def space(self):
        return self.experiment.space

    def suggest(self, num=1):
        """Reserve ``num`` trials, producing fresh ones as needed.  Batched:
        a q-batch reservation is one storage round (one lock/load/dump
        cycle on the pickled file) instead of q."""
        out = []
        self.producer.update()
        while len(out) < num:
            got = self.experiment.reserve_trials(num - len(out))
            if not got:
                try:
                    # Tell the producer how many reserved trials WE hold:
                    # an opt-out must not wait on our own reservations (we
                    # are the one who would complete them — deadlock), but
                    # must still wait on other workers' in-flight trials.
                    self.producer.produce(num - len(out), own_in_flight=len(out))
                except AlgorithmExhausted:
                    if out:
                        # Hand back the partial batch; the next call (with
                        # nothing reserved) re-raises for the caller to stop.
                        return out
                    raise
                got = self.experiment.reserve_trials(num - len(out))
            if not got:
                if out:
                    return out  # partial batch: a finite algorithm ran dry
                raise WaitingForTrials("could not reserve after producing")
            out.extend(got)
        return out

    def observe(self, trial, objective, **aux_results):
        results = [Result("objective", "objective", float(objective))]
        for name, value in aux_results.items():
            results.append(Result(name, "statistic", value))
        self.experiment.update_completed_trial(trial, results)

    def observe_all(self, trials, objectives):
        """Batch completion: one storage round.  Raises the first per-trial
        failure after applying the whole batch (matching ``observe``'s
        FailedUpdate contract)."""
        pairs = [
            (trial, [Result("objective", "objective", float(objective))])
            for trial, objective in zip(trials, objectives)
        ]
        outcomes = self.experiment.update_completed_trials(pairs)
        for outcome in outcomes:
            if isinstance(outcome, Exception):
                raise outcome

    @property
    def is_done(self):
        return self.experiment.is_done

    def stats(self):
        return self.experiment.stats()


def _evaluate_batch(batch_eval, space, trials, device):
    """``batch_eval`` over the trials' unit-cube rows, handed over as one
    ``(n, D)`` float32 tensor on ``device``; its ``(n,)`` result comes back
    to the host in one copy."""
    cube = space.params_to_cube([t.params for t in trials])
    values = batch_eval(torch.as_tensor(cube, device=device))
    if torch.is_tensor(values):
        values = values.detach().cpu().numpy()
    return np.asarray(values, dtype=np.float64).reshape(-1).tolist()


def optimize(
    fn,
    priors,
    max_trials=100,
    batch_size=1,
    algorithm="random",
    strategy=None,
    seed=None,
    storage=None,
    name="optimize",
    batch_eval=None,
    device=None,
):
    """Minimize ``fn(params_dict) -> float`` over a prior-DSL space.

    ``batch_eval``: optional vectorized evaluator taking the (n, D) unit-cube
    rows as a float32 ``torch.Tensor`` on the algorithm's device and
    returning (n,) objectives — keeps whole q-batches on the device (used
    for analytic benchmarks).  ``device``: where the algorithm runs;
    ``None`` means ``cuda`` and raises where no card is present.
    """
    storage = storage or create_storage({"type": "memory"})
    experiment = build_experiment(
        storage,
        name,
        priors=dict(priors),
        max_trials=max_trials,
        algorithms=algorithm,
        strategy=strategy,
        pool_size=batch_size,
    ).instantiate(seed=seed, device=device)
    client = ExperimentClient(experiment)

    n_done = 0
    while n_done < max_trials and not client.is_done:
        want = min(batch_size, max_trials - n_done)
        try:
            trials = client.suggest(want)
        except AlgorithmExhausted:
            # Finite algorithm ran dry before max_trials — a clean finish.
            break
        if batch_eval is not None:
            values = _evaluate_batch(
                batch_eval, experiment.space, trials, experiment.algorithm.device
            )
        else:
            values = [float(fn(t.params)) for t in trials]
        client.observe_all(trials, values)
        n_done += len(trials)
    return client.stats()
