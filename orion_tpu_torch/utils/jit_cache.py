"""The persistent build cache of the port's hand-written kernels (port of
``orion_tpu/utils/jit_cache.py``).

The reference points jax at an on-disk XLA compilation cache: its fused
suggest step compiles once per signature, a TPU compile costs tens of
seconds, and without the cache every fresh process pays it again.

The port's counterpart of a compiled signature is a captured CUDA graph
(:mod:`orion_tpu_torch.algo.step_graphs`), and a CUDA graph cannot outlive
its process: it holds device addresses of its own memory pool and of the
static input buffers, which a new process does not have.  Each worker
process therefore captures anew, paying one eager warm-up round and a
capture per signature (about a second on an H100), and this cache does not
try to persist graphs.  What does persist is the expensive step before
them: ``nvcc`` building ``csrc/*.cu`` for ``sm_90a`` (seconds per source),
cached by :mod:`orion_tpu_torch.ops._build` keyed by a hash of the source
and the flags, under the checkout's ``build/orion_tpu_torch/`` or, for an
installed package, ``$XDG_CACHE_HOME/orion_tpu_torch``.  This module
reports that directory.

The reference's switch keeps its meaning: ``ORION_TPU_JIT_CACHE=off``
reports the cache as disabled (the build still happens, at first use,
into the same directory), and a path moves it.
"""

import logging
import os

log = logging.getLogger(__name__)

_DISABLE = ("0", "off", "false", "no")


def enable_persistent_compilation_cache():
    """Idempotent; returns the kernel build directory in effect (None when
    disabled).  A path in ``ORION_TPU_JIT_CACHE`` becomes the build
    directory of this process's later builds."""
    from orion_tpu_torch.ops import _build

    override = os.environ.get("ORION_TPU_JIT_CACHE", "").strip()
    if override.lower() in _DISABLE:
        return None
    if override and override.lower() not in ("1", "on", "true", "yes"):
        _build.BUILD_DIR = os.path.join(override, "orion_tpu_torch")
    try:
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
    except OSError as exc:  # unwritable directory, read-only fs
        log.debug("kernel build cache unavailable: %s", exc)
        return None
    return _build.BUILD_DIR
