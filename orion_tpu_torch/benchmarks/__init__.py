"""Analytic benchmark functions + harness (port of ``orion_tpu/benchmarks``)."""

from orion_tpu_torch.benchmarks.functions import (
    ackley,
    branin,
    hartmann6,
    rosenbrock,
    BENCHMARKS,
)

__all__ = ["ackley", "branin", "hartmann6", "rosenbrock", "BENCHMARKS"]
