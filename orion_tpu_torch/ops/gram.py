"""Fused candidate-by-observation kernel matrix on Hopper.

Replaces the Pallas kernel ``orion_tpu/ops/gram.py:68`` (``fused_gram``):
``out[i, j] = amp * phi(r2)`` with ``r2 = max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j,
0)`` on the lengthscale-scaled rows ``a = xa * inv_ls``, ``b = xb * inv_ls``,
and ``phi`` the Matern-5/2 or RBF profile.  Forward only: no gradient is
defined, and the autodiff paths (the MLL fit, the polish step) stay on
:func:`orion_tpu_torch.algo.gp.kernels.kernel_matrix`.

On an H100 the kernel is bound by writing its (m, n) float32 output (16.8 MB
at the main path's 16384 x 256, 5.1 us at 3.35 TB/s); the depth-d cross
term must be IEEE float32, so it runs on FMAs, not tensor cores.  One call
is one launch of ``csrc/gram.cu``:

* the scaling by ``inv_ls`` happens inside the kernel, as it stages the
  rows, so no torch op runs before it (only ``torch.empty`` for ``out``);
* its blocks are persistent: one block per SM stages the scaled ``b`` into
  shared memory once, when it fits, and its four 256-thread groups walk the
  row tiles, each loading its next tile's ``a`` rows while the current
  tile's epilogue runs (larger ``b`` goes through a chunked path);
* each thread writes 4 consecutive columns with one 16-byte store when
  ``n % 4 == 0`` and ``out`` is 16-byte aligned, else scalar stores, with
  the ragged edges masked in the kernel.

:func:`_launch_plan` picks the path, the tile and the shared-memory bytes
on the host; the kernel refuses a plan that is not its own rule's.

A tensor on the CPU goes to :func:`fused_gram_reference`, the plain PyTorch
version.  A CUDA tensor launches the kernel or raises: there is no fallback.

Launch counts under CUDA graphs: a call made while its stream is being
captured launches nothing and is not counted.  Inside
:func:`recorded_launches` (the step graphs' captures,
:mod:`orion_tpu_torch.algo.step_graphs`) it records its shape; each replay
of that graph launches the kernel again, and :func:`replayed_launches`
counts it then, under the same profiler range.  A graph captured elsewhere
(a timing loop) counts nothing.
"""

import contextlib
import ctypes
import threading
from typing import NamedTuple

import torch

_KINDS = {"matern52": 0, "rbf": 1}

# The kernel's layout constants (``csrc/gram.cu``): the output tile of the
# resident path (whole rows at n = 256) and its groups per block, the tile
# and feature chunk of the chunked path, the padding of shared rows, and the
# shared memory one block may use.
_RESIDENT_TILE = (16, 256)
_GROUPS = 4
_CHUNKED_TILE = (64, 64)
_CHUNK = 16
_ROW_PAD = 4
SMEM_BUDGET = 48 * 1024

#: Under ``torch.profiler`` each launch sits in a range named
#: ``"fused_gram MxNxD"``, so a trace shows the shape every launch ran at.
#: Outside a profile this costs one check of the profiler's state.
PROFILE_RANGE = "fused_gram"


class LaunchPlan(NamedTuple):
    """How ``csrc/gram.cu`` computes one call: ``resident`` keeps all of
    ``b`` in shared memory for every tile (else it is staged ``_CHUNK``
    features at a time), ``vec`` writes 16-byte stores (else scalar
    stores), ``tile_rows`` x ``tile_cols`` is the output tile of one
    256-thread group and ``smem_bytes`` a block's dynamic shared memory."""

    resident: bool
    vec: bool
    tile_rows: int
    tile_cols: int
    smem_bytes: int


def _launch_plan(m, n, d, out_aligned):
    """The kernel's plan for an (m, d) x (n, d) call whose output is
    16-byte aligned or not.  Resident when the scaled ``b`` (rows padded to
    whole tiles), its norms and two ``a`` tiles for each group fit
    :data:`SMEM_BUDGET`."""
    rows, cols = _RESIDENT_TILE
    ldb = -(-n // cols) * cols + _ROW_PAD
    smem = 4 * (d * ldb + ldb + _GROUPS * 2 * d * rows)
    resident = smem <= SMEM_BUDGET
    if not resident:
        rows, cols = _CHUNKED_TILE
        smem = 4 * _CHUNK * (rows + cols + 2 * _ROW_PAD)
    return LaunchPlan(resident, n % 4 == 0 and out_aligned, rows, cols, smem)


_PLAN_RULE = _launch_plan


def _epilogue(kind, r2, amp):
    if kind == "rbf":
        return amp * torch.exp(-0.5 * r2)
    if kind == "matern52":
        r = torch.sqrt(r2)
        sqrt5_r = 5.0**0.5 * r
        return amp * (1.0 + sqrt5_r + (5.0 / 3.0) * r2) * torch.exp(-sqrt5_r)
    raise ValueError(f"unknown kernel {kind!r}")


def fused_gram_reference(xa, xb, inv_lengthscales, amplitude, *, kind="matern52"):
    """Plain PyTorch version of the kernel: the same expansion, the same
    association, any device.  The CPU path and the yardstick the kernel is
    held to on the card."""
    a = (xa * inv_lengthscales).to(torch.float32)
    b = (xb * inv_lengthscales).to(torch.float32)
    aa = torch.sum(a * a, dim=1)[:, None]
    bb = torch.sum(b * b, dim=1)[None, :]
    r2 = torch.clamp(aa + bb - 2.0 * (a @ b.T), min=0.0)
    return _epilogue(kind, r2, amplitude)


def ensure_loaded():
    """Build and load the kernel's library now, if this process has not
    yet.  The step graphs call it before they take their lock, so that no
    round or prewarm holds the step-graph lock while the build lock is
    taken (the order the concurrency sanitizer observed, and the static
    lock graph cannot see through the round's callable)."""
    _lib()


def _lib():
    from orion_tpu_torch.ops import _build

    lib = _build.load("gram")
    if not getattr(lib, "_orion_typed", False):
        ptr = ctypes.c_void_p
        cint = ctypes.c_int
        lib.orion_fused_gram_f32.argtypes = [
            ptr, ptr, ptr, ptr, ptr, cint, cint, cint, cint, cint, cint, cint, cint, cint, ptr,
        ]
        lib.orion_fused_gram_f32.restype = ctypes.c_int
        lib.orion_cuda_error_string.argtypes = [ctypes.c_int]
        lib.orion_cuda_error_string.restype = ctypes.c_char_p
        lib._orion_typed = True
    return lib


def fused_gram(xa, xb, inv_lengthscales, amplitude, *, kind="matern52"):
    """Kernel matrix ``k(xa, xb)`` -> (m, n) float32, forward only.

    ``xa`` (m, d), ``xb`` (n, d), ``inv_lengthscales`` (d,) and
    ``amplitude`` (a 0-d or 1-element tensor) are float32 on one device.
    On CUDA the amplitude goes to the kernel as a device pointer, so no
    value crosses to the host.  Raises on a wrong dtype, shape or device,
    on an input that requires grad, and on a failed launch."""
    if kind not in _KINDS:
        raise ValueError(f"unknown kernel {kind!r}")
    if not torch.is_tensor(amplitude):
        # A fill on the device, not a host copy: this runs inside captures.
        amplitude = torch.full((), amplitude, dtype=torch.float32, device=xa.device)
    inputs = (xa, xb, inv_lengthscales, amplitude)
    if any(t.requires_grad for t in inputs):
        raise ValueError("fused_gram is forward-only; an input requires grad")
    if xa.dim() != 2 or xb.dim() != 2 or xa.shape[1] != xb.shape[1]:
        raise ValueError(f"fused_gram needs (m, d) and (n, d), got {tuple(xa.shape)}, "
                         f"{tuple(xb.shape)}")
    d = xa.shape[1]
    if inv_lengthscales.shape != (d,) or amplitude.numel() != 1:
        raise ValueError("fused_gram needs inv_lengthscales (d,) and a scalar amplitude")
    if any(t.device != xa.device for t in inputs):
        raise ValueError("fused_gram inputs lie on different devices")
    if xa.device.type == "cpu":
        return fused_gram_reference(xa, xb, inv_lengthscales, amplitude, kind=kind)
    if xa.device.type != "cuda":
        raise ValueError(f"fused_gram runs on cuda or cpu, not {xa.device}")
    if any(t.dtype != torch.float32 for t in inputs):
        raise TypeError("fused_gram takes float32 inputs")
    # A no-op, and no launch, on contiguous inputs such as the main path's.
    xa, xb = xa.contiguous(), xb.contiguous()
    ils = inv_lengthscales.contiguous()
    amp = amplitude.reshape(1).contiguous()
    m, n = xa.shape[0], xb.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=xa.device)
    if m == 0 or n == 0:
        return out
    aligned = out.data_ptr() % 16 == 0
    capturing = torch.cuda.is_current_stream_capturing()
    # A capture records a launch and runs none: it takes the rule without
    # going through the module's ``_launch_plan``, which sees real launches,
    # and opens no range (each replay opens its own).
    plan = (_PLAN_RULE if capturing else _launch_plan)(m, n, d, aligned)
    lib = _lib()
    scope = (torch.profiler.record_function(f"{PROFILE_RANGE} {m}x{n}x{d}")
             if torch._C._autograd._profiler_enabled() and not capturing
             else contextlib.nullcontext())
    with scope, torch.cuda.device(xa.device):
        rc = lib.orion_fused_gram_f32(
            xa.data_ptr(), xb.data_ptr(), ils.data_ptr(), amp.data_ptr(), out.data_ptr(),
            m, n, d, _KINDS[kind], *plan, torch.cuda.current_stream(xa.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_gram launch failed: {lib.orion_cuda_error_string(rc).decode()} ({rc})"
        )
    if not capturing:
        fused_gram.launches += 1
    elif getattr(_capturing, "launches", None) is not None:
        _capturing.launches.append((m, n, d, aligned))
    return out


#: Kernel launches since the last reset (a plain integer; callers zero it).
fused_gram.launches = 0

_capturing = threading.local()


@contextlib.contextmanager
def recorded_launches():
    """Collect ``(m, n, d, aligned)`` of every call this thread makes into a
    capturing stream (a launch recorded in a graph, not run)."""
    previous = getattr(_capturing, "launches", None)
    _capturing.launches = launches = []
    try:
        yield launches
    finally:
        _capturing.launches = previous


@contextlib.contextmanager
def replayed_launches(launches):
    """Around one replay of a graph whose capture recorded ``launches``:
    under ``torch.profiler`` each launch gets its ``fused_gram MxNxD`` range,
    as an eager launch does; after the replay each counts one launch and
    goes through :func:`_launch_plan` again, as an eager launch does, so a
    hook on the plan sees every launch."""
    with contextlib.ExitStack() as scopes:
        if launches and torch._C._autograd._profiler_enabled():
            for m, n, d, _aligned in launches:
                scopes.enter_context(
                    torch.profiler.record_function(f"{PROFILE_RANGE} {m}x{n}x{d}"))
        yield
    for m, n, d, aligned in launches:
        _launch_plan(m, n, d, aligned)
        fused_gram.launches += 1
