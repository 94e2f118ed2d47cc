"""Fused candidate-by-observation kernel matrix on Hopper.

Replaces the Pallas kernel ``orion_tpu/ops/gram.py:68`` (``fused_gram``):
``out[i, j] = amp * phi(r2)`` with ``r2 = max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j,
0)`` on the lengthscale-scaled rows ``a = xa * inv_ls``, ``b = xb * inv_ls``,
and ``phi`` the Matern-5/2 or RBF profile.  Forward only: no gradient is
defined, and the autodiff paths (the MLL fit, the polish step) stay on
:func:`orion_tpu_torch.algo.gp.kernels.kernel_matrix`.

On an H100 the kernel is bound by writing its (m, n) float32 output (16.8 MB
at the main path's 16384 x 256, about 5 us at 3.35 TB/s); the depth-d cross
term must be IEEE float32, so it runs on FMAs, not tensor cores.  The kernel
(``csrc/gram.cu``) writes each output once, straight from registers, with
coalesced stores and in-kernel edge masks; see the source for the tiling.

A tensor on the CPU goes to :func:`fused_gram_reference`, the plain PyTorch
version.  A CUDA tensor launches the kernel or raises: there is no fallback.
"""

import ctypes

import torch

_KINDS = {"matern52": 0, "rbf": 1}


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


def _lib():
    from orion_tpu_torch.ops import _build

    lib = _build.load("gram")
    if not getattr(lib, "_orion_typed", False):
        ptr = ctypes.c_void_p
        lib.orion_fused_gram_f32.argtypes = [
            ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr,
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
        amplitude = torch.tensor(amplitude, dtype=torch.float32, device=xa.device)
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
    # The scaling runs in torch, outside the kernel, as the reference
    # scales outside its pallas_call.
    a = (xa * inv_lengthscales).contiguous()
    b = (xb * inv_lengthscales).contiguous()
    amp = amplitude.reshape(1).contiguous()
    m, n = a.shape[0], b.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        rc = lib.orion_fused_gram_f32(
            a.data_ptr(), b.data_ptr(), amp.data_ptr(), out.data_ptr(),
            m, n, d, _KINDS[kind], torch.cuda.current_stream(a.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_gram launch failed: {lib.orion_cuda_error_string(rc).decode()} ({rc})"
        )
    fused_gram.launches += 1
    return out


#: Kernel launches since the last reset (a plain integer; callers zero it).
fused_gram.launches = 0
