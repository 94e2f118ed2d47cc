"""Programmatic trial insertion (port of ``orion_tpu/client/manual.py``).

Capability parity: reference `src/orion/client/manual.py` — validate points
against the experiment space and register them as new trials.
"""

from orion_tpu_torch.core.trial import Trial


def insert_trials(experiment, params_list, validate=True):
    """Register fixed-parameter trials on an experiment."""
    trials = []
    for params in params_list:
        params = dict(params)
        if validate and experiment.space is not None:
            if not experiment.space.contains_point(params):
                raise ValueError(
                    f"Point {params} is not contained in space "
                    f"{experiment.space}"
                )
        trial = Trial(params=params)
        experiment.register_trial(trial)
        trials.append(trial)
    return trials
