"""Gaussian-process machinery of the port (mirrors ``orion_tpu.algo.gp``)."""

from orion_tpu_torch.algo.gp.gp import GPState, fit_gp, posterior
from orion_tpu_torch.algo.gp.kernels import kernel_matrix

__all__ = ["GPState", "fit_gp", "posterior", "kernel_matrix"]
