"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``)."""

from orion_tpu_torch.ops.gram import fused_gram, fused_gram_reference

__all__ = ["fused_gram", "fused_gram_reference"]
