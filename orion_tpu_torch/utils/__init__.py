"""Shared utilities: exceptions, dict flattening, plugin registry."""

from orion_tpu_torch.utils.exceptions import (
    BrokenExperiment,
    CheckError,
    DatabaseError,
    DuplicateKeyError,
    ExecutionError,
    FailedUpdate,
    InvalidResult,
    NoConfigurationError,
    OrionTPUError,
    RaceCondition,
)
from orion_tpu_torch.utils.flatten import flatten, unflatten
from orion_tpu_torch.utils.registry import Registry

__all__ = [
    "BrokenExperiment",
    "CheckError",
    "DatabaseError",
    "DuplicateKeyError",
    "ExecutionError",
    "FailedUpdate",
    "InvalidResult",
    "NoConfigurationError",
    "OrionTPUError",
    "RaceCondition",
    "Registry",
    "flatten",
    "unflatten",
]
