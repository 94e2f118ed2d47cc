"""Domain model (port of ``orion_tpu/core``): trials, parallel strategies,
experiments, the producer, and the worker runtime of the CLI path (the
consumer, the pacemaker and ``workon``)."""

from orion_tpu_torch.core.experiment import (
    Experiment,
    ExperimentView,
    build_experiment,
    experiment_id,
)
from orion_tpu_torch.core.producer import Producer
from orion_tpu_torch.core.strategy import create_strategy
from orion_tpu_torch.core.trial import (
    ID_SCHEMES,
    Result,
    Trial,
    TrialBatch,
    compute_batch_ids,
    compute_cube_ids,
    compute_scheme_ids,
)

__all__ = [
    "Experiment",
    "ExperimentView",
    "ID_SCHEMES",
    "Producer",
    "Result",
    "Trial",
    "TrialBatch",
    "build_experiment",
    "compute_batch_ids",
    "compute_cube_ids",
    "compute_scheme_ids",
    "create_strategy",
    "experiment_id",
]
