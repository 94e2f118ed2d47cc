"""orion-tpu's optimizer core in PyTorch, for one NVIDIA H100.

The port of ``orion_tpu``'s GP-BO suggest/observe path: the search-space
codecs, the device history buffers, the GP fit and posterior, the
acquisitions and the fused suggest step of ``tpu_bo``, with the candidate
cross-gram as a CUDA kernel written by hand for Hopper
(:mod:`orion_tpu_torch.ops.gram`).  Module paths mirror ``orion_tpu``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
