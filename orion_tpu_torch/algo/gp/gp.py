"""GP on masked static-shape buffers: Cholesky posterior, marginal-likelihood
fit by a fixed number of adam steps (port of ``orion_tpu/algo/gp/gp.py``).

- Observations live in power-of-2 padded buffers with a validity mask.
  Padded rows are made inert in the Cholesky by pinning their diagonal to 1
  and off-diagonals to 0, and their targets to 0 — they then contribute
  nothing to the solve, the quad form, or the logdet (log 1 = 0).
- Everything is float32, with a jitter floor for the Cholesky.
- A failed Cholesky gives NaNs, as ``jnp.linalg.cholesky`` does, and the fit
  scrubs NaN gradients; ``torch.linalg.cholesky`` would raise instead and
  ``cholesky_ex`` alone returns a finite but wrong factor (see
  :func:`cholesky`).
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from orion_tpu_torch.algo.gp.kernels import cross_kernel_matrix, kernel_matrix
from orion_tpu_torch.algo.sampling import masked_copula_transform
from orion_tpu_torch.algo.sharding import ShardedArray
from orion_tpu_torch.device import resolve_device

JITTER = 1e-5

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def _f32log(value):
    """log in float32, as the reference's ``jnp.log`` of a python float."""
    return float(np.log(np.float32(value)))


# Hyperparameter clip ranges (orion_tpu/algo/gp/gp.py:119-130).
_LOG_LS_RANGE = (_f32log(1e-3), _f32log(1e2))
_LOG_AMP_RANGE = (_f32log(0.05), _f32log(5.0))
_LOG_NOISE_RANGE = (_f32log(1e-4), _f32log(1.0))


class GPHypers(NamedTuple):
    log_lengthscales: torch.Tensor  # (d,)
    log_amplitude: torch.Tensor  # ()
    log_noise: torch.Tensor  # ()


class GPState(NamedTuple):
    x: torch.Tensor  # (n_pad, d) in the unit cube
    y: torch.Tensor  # (n_pad,) objectives (copula-transformed when asked)
    mask: torch.Tensor  # (n_pad,) 1.0 for real rows
    hypers: GPHypers
    chol: torch.Tensor  # (n_pad, n_pad) lower Cholesky of masked K + noise
    alpha: torch.Tensor  # (n_pad,) chol^-T chol^-1 y_norm
    y_mean: torch.Tensor  # ()
    y_std: torch.Tensor  # ()
    mll: Optional[torch.Tensor] = None  # () marginal log-likelihood per obs
    health: Optional[torch.Tensor] = None  # (len(DEVICE_HEALTH_FIELDS),)


def init_hypers(n_dims, device=None):
    """The reference's starting hyperparameters on ``device`` (``None``
    means ``cuda``, see :func:`~orion_tpu_torch.device.resolve_device`)."""
    device = resolve_device(device)
    return GPHypers(
        log_lengthscales=torch.full((n_dims,), _f32log(0.3), dtype=torch.float32,
                                    device=device),
        log_amplitude=torch.full((), 0.0, dtype=torch.float32, device=device),
        log_noise=torch.full((), _f32log(1e-3), dtype=torch.float32, device=device),
    )


def cholesky(a):
    """Lower Cholesky factor with the reference's failure behaviour.

    Symmetrizes its input as ``jnp.linalg.cholesky`` does, and where the
    factorization fails fills the lower triangle with NaN as it does
    (``cholesky_ex`` reports the failure in ``info`` but leaves a finite,
    wrong factor).  No host sync."""
    factor, info = torch.linalg.cholesky_ex(0.5 * (a + a.mT))
    lower = torch.ones(factor.shape[-2:], dtype=torch.bool, device=factor.device).tril()
    failed = (info > 0)[..., None, None] & lower
    return torch.where(failed, torch.full_like(factor, float("nan")), factor)


def cho_solve(chol, b):
    """Solve ``(L L^T) x = b`` for a vector ``b`` given the lower factor."""
    return torch.cholesky_solve(b[:, None], chol, upper=False)[:, 0]


def _normalize_y(y, mask):
    n = torch.clamp(torch.sum(mask), min=1.0)
    mean = torch.sum(y * mask) / n
    var = torch.sum(((y - mean) ** 2) * mask) / n
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    return (y - mean) * mask / std, mean, std


def _masked_kernel(kind, x, mask, hypers):
    inv_ls = torch.exp(-hypers.log_lengthscales)
    amp = torch.exp(hypers.log_amplitude)
    noise = torch.exp(hypers.log_noise)
    k = kernel_matrix(kind, x, x, inv_ls, amp)
    outer = mask[:, None] * mask[None, :]
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    # Real block keeps K + noise*I; padded rows/cols become identity.  The
    # jitter scales with the amplitude: long-lengthscale fits make K nearly
    # rank-1 at magnitude `amp`, and an absolute 1e-5 is then below f32
    # resolution — the Cholesky fails.
    return k * outer + eye * (noise + JITTER * (1.0 + amp)) * mask + eye * (1.0 - mask)


def _mll_terms(chol, y_norm, mask):
    alpha = cho_solve(chol, y_norm)
    quad = torch.dot(y_norm, alpha)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)) * mask)
    n = torch.clamp(torch.sum(mask), min=1.0)
    return alpha, quad, logdet, n


def _neg_mll(hypers, kind, x, y_norm, mask):
    chol = cholesky(_masked_kernel(kind, x, mask, hypers))
    _alpha, quad, logdet, n = _mll_terms(chol, y_norm, mask)
    return 0.5 * (quad + logdet) / n


class Adam:
    """optax.adam's update on a list of tensors, elementwise: moments
    ``(1-b)*g^k + b*m``, bias correction by ``1 - b**t``, eps outside the
    square root, then ``p - lr * mu_hat / (sqrt(nu_hat) + eps)``."""

    def __init__(self, params, lr):
        self.lr = lr
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def step(self, params, grads):
        self.count += 1
        bc1 = 1.0 - ADAM_B1**self.count
        bc2 = 1.0 - ADAM_B2**self.count
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = (1.0 - ADAM_B1) * g + ADAM_B1 * self.mu[i]
            self.nu[i] = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu[i]
            mu_hat = self.mu[i] / bc1
            nu_hat = self.nu[i] / bc2
            out.append(p + (-self.lr) * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)))
        return out


def fit_gp(x, y, mask, kind="matern52", n_steps=50, lr=0.08, init=None,
           y_transform="none"):
    """Fit hyperparameters by adam on the marginal likelihood; returns
    GPState with the posterior factorization cached (Cholesky + alpha).

    ``y_transform="copula"`` rank-Gaussianizes the masked targets before
    normalization (``sampling.masked_copula_transform``); the returned
    ``GPState.y`` then holds the transformed targets.  The hyperparameters
    come back detached: nothing downstream differentiates through them."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    mask = mask.to(torch.float32)
    if y_transform == "copula":
        y = masked_copula_transform(y, mask)
    y_norm, y_mean, y_std = _normalize_y(y, mask)
    hypers = init if init is not None else init_hypers(x.shape[1], device=x.device)
    params = [t.detach().to(torch.float32) for t in hypers]
    opt = Adam(params, lr)
    ranges = (_LOG_LS_RANGE, _LOG_AMP_RANGE, _LOG_NOISE_RANGE)
    for _ in range(n_steps):
        leaves = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            loss = _neg_mll(GPHypers(*leaves), kind, x, y_norm, mask)
            grads = torch.autograd.grad(loss, leaves)
        # A transiently ill-conditioned Cholesky must not poison the whole fit.
        grads = [torch.nan_to_num(g) for g in grads]
        params = opt.step(params, grads)
        # Keep hypers in sane ranges (lengthscale in cube units, amplitude
        # around the unit-variance targets, noise floor 1e-4).
        params = [torch.clamp(p, lo, hi) for p, (lo, hi) in zip(params, ranges)]
    hypers = GPHypers(*params)

    chol = cholesky(_masked_kernel(kind, x, mask, hypers))
    alpha, quad, logdet, n = _mll_terms(chol, y_norm, mask)
    mll = -0.5 * (quad + logdet) / n
    return GPState(
        x=x, y=y, mask=mask, hypers=hypers, chol=chol, alpha=alpha,
        y_mean=y_mean, y_std=y_std, mll=mll,
    )


def _cross_terms(state, xq, kind, *, route_m=None):
    inv_ls = torch.exp(-state.hypers.log_lengthscales)
    amp = torch.exp(state.hypers.log_amplitude)
    kqx = cross_kernel_matrix(kind, xq.to(torch.float32), state.x, inv_ls, amp,
                              route_m=route_m)
    kqx = kqx * state.mask[None, :]
    mean = kqx @ state.alpha
    v = torch.linalg.solve_triangular(state.chol, kqx.T, upper=False)
    var = torch.clamp(amp - torch.sum(v * v, dim=0), min=1e-10)
    return mean, var


def posterior(state, xq, kind="matern52"):
    """Predictive mean/std at query points ``xq`` (m, d): one (m, n) kernel
    matmul and one triangular solve."""
    mean_norm, var_norm = _cross_terms(state, xq, kind)
    mean = mean_norm * state.y_std + state.y_mean
    std = torch.sqrt(var_norm) * state.y_std
    return mean, std


def posterior_norm(state, xq, kind="matern52"):
    """Predictive mean/std in normalized target units (for acquisitions).

    ``xq`` may be a :class:`~orion_tpu_torch.algo.sharding.ShardedArray`:
    each slot scores its chunk against a copy of ``state`` (the cross-gram
    routed on the whole pool's rows), and the per-candidate mean and std
    come back to the pool's home device."""
    if isinstance(xq, ShardedArray):
        parts = xq.map(lambda chunk, st: _cross_terms(st, chunk, kind, route_m=xq.rows), state)
        mean = xq.gather([mean for mean, _ in parts])
        var = xq.gather([var for _, var in parts])
        return mean, torch.sqrt(var)
    mean, var = _cross_terms(state, xq, kind)
    return mean, torch.sqrt(var)

