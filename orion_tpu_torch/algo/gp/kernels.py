"""GP kernels with ARD lengthscales (port of ``orion_tpu/algo/gp/kernels.py``).

Pairwise distances use the ||a-b||^2 = ||a||^2 + ||b||^2 - 2ab expansion,
the same as the reference, so ``k(x, x)`` comes out at the amplitude and
the two packages agree to float32 rounding.  The cross term must run at
full float32: ``orion_tpu_torch.device`` turns TF32 off for that reason.
"""

import torch

from orion_tpu_torch import device as _device  # noqa: F401  (precision switches)
from orion_tpu_torch.ops.gram import fused_gram


def sq_dists(xa, xb, inv_lengthscales):
    """Squared scaled euclidean distances, matmul-dominant."""
    a = xa * inv_lengthscales
    b = xb * inv_lengthscales
    aa = torch.sum(a * a, dim=-1)[:, None]
    bb = torch.sum(b * b, dim=-1)[None, :]
    r2 = aa + bb - 2.0 * (a @ b.T)
    # torch.maximum splits the gradient at a tie, as jnp.maximum does.
    return torch.maximum(r2, torch.zeros_like(r2))


def rbf(xa, xb, inv_lengthscales, amplitude):
    return amplitude * torch.exp(-0.5 * sq_dists(xa, xb, inv_lengthscales))


def matern52(xa, xb, inv_lengthscales, amplitude):
    r2 = sq_dists(xa, xb, inv_lengthscales)
    # Double-where keeps d(sqrt)/d(r2) finite at r2=0 (the diagonal): without
    # it the 1/(2 sqrt(r2)) gradient is inf there and one MLL step NaNs every
    # hyperparameter.
    positive = r2 > 1e-12
    safe = torch.where(positive, r2, torch.ones_like(r2))
    r = torch.where(positive, torch.sqrt(safe), torch.zeros_like(r2))
    sqrt5_r = 5.0**0.5 * r
    return amplitude * (1.0 + sqrt5_r + (5.0 / 3.0) * r2) * torch.exp(-sqrt5_r)


_KERNELS = {"rbf": rbf, "matern52": matern52}

#: Work (m * n * d) from which the forward-only cross-gram goes to the
#: fused kernel; the reference's threshold, kept so both packages route the
#: same shapes the same way.  The main path's 16384 x 256 x 6 is above it,
#: the polish step's 64 x 256 x 6 and the MLL fit's 256 x 256 x 6 below.
_FUSED_MIN_WORK = 8 * 10**6


def kernel_matrix(kind, xa, xb, inv_lengthscales, amplitude):
    return _KERNELS[kind](xa, xb, inv_lengthscales, amplitude)


def cross_kernel_matrix(kind, xa, xb, inv_lengthscales, amplitude, *, route_m=None):
    """Forward-only gram for candidate scoring: ``m*n*max(d,1) >=
    _FUSED_MIN_WORK`` goes to :func:`orion_tpu_torch.ops.fused_gram` (on a
    CUDA tensor the hand-written kernel, which runs or raises), anything
    smaller to the differentiable :func:`kernel_matrix`.  Never use above
    the threshold under autograd: the fused kernel has no gradient.

    ``route_m``: the rows the route is decided on, where ``xa`` is one
    slot's chunk of a sharded pool: the round's whole pool, as the
    reference decides at trace time on the global shape (4 slots of the
    main path's 16384 x 256 x 6 are chunks under the threshold)."""
    m, d = xa.shape
    n = xb.shape[0]
    rows = m if route_m is None else route_m
    # lint: disable=JIT002 -- route_m is a row count (ShardedArray.rows), a Python int
    if rows * n * max(d, 1) >= _FUSED_MIN_WORK:
        return fused_gram(xa, xb, inv_lengthscales, amplitude, kind=kind)
    return _KERNELS[kind](xa, xb, inv_lengthscales, amplitude)
