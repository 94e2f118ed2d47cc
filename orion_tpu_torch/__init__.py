"""orion-tpu's optimizer core in PyTorch, for one NVIDIA H100.

The port of ``orion_tpu``'s GP-BO suggest/observe path: the search-space
codecs, the device history buffers, the GP fit and posterior, the
acquisitions and the fused suggest step of ``tpu_bo``, with the candidate
cross-gram as a CUDA kernel written by hand for Hopper
(:mod:`orion_tpu_torch.ops.gram`).  Module paths mirror ``orion_tpu``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

# Opt-in runtime concurrency sanitizer (`orion-tpu-torch tsan -- <cmd>` sets
# the env in the child): instrumentation must patch the threading factories
# BEFORE the subsystem modules create their locks, so the hook lives at
# package import.  Without the env var this costs one dict lookup.
import os as _os

if _os.environ.get("ORION_TPU_TSAN", "").strip().lower() in ("1", "on", "true", "yes"):
    from orion_tpu_torch.analysis.sanitizer import TSAN as _TSAN

    _TSAN.enable_from_env()
