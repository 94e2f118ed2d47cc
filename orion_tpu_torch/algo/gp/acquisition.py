"""Acquisition functions over candidate sets (port of
``orion_tpu/algo/gp/acquisition.py``).

Torch cannot reproduce JAX's threefry streams, so every acquisition that
draws takes its random numbers as arguments: :class:`RFFDraws` for
``rff_thompson``, an ``eps`` tensor for the marginal and joint Thompson
draws.  ``sample_rff_draws`` draws them from a ``torch.Generator``; the
parity tests build them from ``jax.random`` instead.

- ``thompson``: q correlated posterior draws by random Fourier features,
  argmin each — diverse batches at O(m*F).
- ``ei`` / ``ucb``: score all candidates, take the top-q distinct ones.
"""

import math
from typing import NamedTuple

import torch

from orion_tpu_torch.algo.gp.gp import cho_solve, cholesky, posterior_norm
from orion_tpu_torch.algo.gp.kernels import cross_kernel_matrix
from orion_tpu_torch.algo.sharding import ShardedArray

_SQRT2 = 1.4142135623730951
_MATERN_DF = 5.0


def _norm_cdf(z):
    return 0.5 * (1.0 + torch.erf(z / _SQRT2))


def _norm_pdf(z):
    return torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def expected_improvement(mean, std, best):
    """EI for minimization, in normalized units."""
    z = (best - mean) / std
    return std * (z * _norm_cdf(z) + _norm_pdf(z))


def upper_confidence_bound(mean, std, beta=2.0):
    """Negated LCB for minimization (higher is better)."""
    return -(mean - beta * std)


def thompson_scores(eps, mean, std):
    """(q, m) marginal posterior draws from standard-normal ``eps`` (q, m),
    negated: higher is better."""
    return -(mean[None, :] + std[None, :] * eps)


class RFFDraws(NamedTuple):
    """The random numbers of one :func:`rff_thompson` call."""

    z: torch.Tensor  # (F, d) standard normal
    gamma: torch.Tensor  # (F, 1) Gamma(df/2) (Matern's Student-t scale)
    b: torch.Tensor  # (F,) uniform on [0, 2*pi)
    eps: torch.Tensor  # (F, q) standard normal


def sample_rff_draws(generator, n_features, d, q, device):
    """Draw :class:`RFFDraws` from ``generator`` on ``device``."""
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    z = torch.randn((n_features, d), **kw)
    gamma = torch._standard_gamma(
        torch.full((n_features, 1), _MATERN_DF / 2.0, device=device), generator=generator
    )
    b = torch.rand((n_features,), **kw) * (2.0 * math.pi)
    eps = torch.randn((n_features, q), **kw)
    return RFFDraws(z, gamma, b, eps)


def _rff_posterior(draws, state, kind, n_features):
    """The random-feature map and the q jointly drawn weight vectors of
    :func:`rff_thompson`: ``(w, b, scale, thetas)``, on the state's device."""
    ls = torch.exp(state.hypers.log_lengthscales)
    amp = torch.exp(state.hypers.log_amplitude)
    noise = torch.exp(state.hypers.log_noise)

    z = draws.z
    if kind == "matern52":
        g = 2.0 * draws.gamma
        z = z * torch.sqrt(_MATERN_DF / g)
    w = z / ls[None, :]
    b = draws.b
    scale = torch.sqrt(2.0 * amp / n_features)

    y_norm = (state.y - state.y_mean) / state.y_std * state.mask
    phi = _features(state.x, w, b, scale) * state.mask[:, None]  # (n_pad, F)
    # Ridge floor 1e-3 keeps the f32 (F, F) Cholesky conditioned.
    ridge = noise + 1e-3
    a = phi.T @ phi + ridge * torch.eye(n_features, dtype=torch.float32, device=phi.device)
    chol_a = cholesky(a)
    theta_mean = cho_solve(chol_a, phi.T @ y_norm)
    # theta ~ N(theta_mean, ridge * A^-1):  theta = mean + sqrt(ridge) L^-T eps
    delta = torch.linalg.solve_triangular(chol_a.T, draws.eps, upper=True)
    thetas = theta_mean[:, None] + torch.sqrt(ridge) * delta  # (F, q)
    return w, b, scale, thetas


def _features(x, w, b, scale):
    return scale * torch.cos(x @ w.T + b[None, :])


def rff_thompson(draws, state, candidates, q, kind="matern52", n_features=512):
    """Correlated q-batch Thompson sampling via random Fourier features.

    Approximate the kernel with F cosine features, form the Bayesian linear
    regression posterior over feature weights (an (F, F) Cholesky), draw q
    weight vectors jointly, and score ALL candidates with one (m, F) x
    (F, q) matmul.  Matern-5/2's spectral density is a multivariate
    Student-t with 5 dof; RBF's is gaussian.  Returns (q,) indices.

    On a sharded pool each slot scores its chunk and returns each column's
    minimum and its first index; the lead slot takes, per column, the first
    chunk holding the minimum (NaN first, as ``torch.argmin``), so the
    indices are ``torch.argmin`` over the whole pool."""
    params = _rff_posterior(draws, state, kind, n_features)
    if isinstance(candidates, ShardedArray):
        def chunk_min(chunk, w, b, scale, thetas):
            scores = _features(chunk, w, b, scale) @ thetas  # (m_chunk, q)
            local = torch.argmin(scores, dim=0)
            return torch.gather(scores, 0, local[None])[0], local

        return _first_extreme(candidates, candidates.map(chunk_min, *params), torch.argmin)
    scores = _features(candidates, *params[:3]) @ params[3]  # (m, q)
    return torch.argmin(scores, dim=0)  # minimization: best draw per sample


def _first_extreme(pool, parts, arg):
    """Join per-chunk ``(values (q,), local indices (q,))`` of a sharded
    pool into the global ``arg`` (``torch.argmin``/``argmax``) indices: the
    first chunk holding the extreme, its first index there."""
    values = pool.gather_stats([v for v, _ in parts])  # (slots, q)
    index = pool.gather_stats([i + off for (_, i), off in zip(parts, pool.offsets())])
    chunk = arg(values, dim=0)
    return torch.gather(index, 0, chunk[None])[0]


def select_q(scores, q):
    """Top-q candidate indices from an (m,) score vector, ties to the lowest
    index (as ``lax.top_k``): a stable descending sort, sliced.  EI
    underflows to exactly 0 over much of a pool, so ties are common."""
    return torch.sort(scores, descending=True, stable=True).indices[:q]


def acquire(draws, state, candidates, q, kind="matern52", acq="thompson", best=None,
            beta=2.0):
    """Pick q candidate indices by the requested acquisition.  ``draws`` is
    :class:`RFFDraws` for ``thompson``, a (q, m) normal ``eps`` for
    ``marginal_thompson``, unused for ``ei``/``ucb``.  ``candidates`` may be
    a :class:`~orion_tpu_torch.algo.sharding.ShardedArray`: each slot scores
    its chunk and the indices equal the whole pool's."""
    if acq == "thompson":
        return rff_thompson(draws, state, candidates, q, kind=kind)
    mean, std = posterior_norm(state, candidates, kind=kind)
    if acq == "marginal_thompson":
        if isinstance(candidates, ShardedArray):
            def chunk_max(eps, mean_c, std_c):
                scores = thompson_scores(eps, mean_c, std_c)  # (q, m_chunk)
                local = torch.argmax(scores, dim=1)
                return torch.gather(scores, 1, local[:, None])[:, 0], local

            means, stds = candidates.split(mean, 0), candidates.split(std, 0)
            parts = [chunk_max(eps, mc, sc) for eps, mc, sc in
                     zip(candidates.split(draws, 1), means, stds)]
            return _first_extreme(candidates, parts, torch.argmax)
        return torch.argmax(thompson_scores(draws, mean, std), dim=1)
    if acq == "ei":
        if best is None:
            y_norm = (state.y - state.y_mean) / state.y_std
            best = torch.min(torch.where(state.mask > 0, y_norm, torch.full_like(y_norm,
                                                                               float("inf"))))
        return select_q(expected_improvement(mean, std, best), q)
    if acq == "ucb":
        return select_q(upper_confidence_bound(mean, std, beta=beta), q)
    raise ValueError(f"unknown acquisition {acq!r}")


def joint_thompson(eps, state, candidates, q, kind="matern52"):
    """Joint posterior Thompson draws (correlated) from standard-normal
    ``eps`` (q, m): Cholesky of the full candidate covariance — for m small
    enough for an (m, m) factor."""
    inv_ls = torch.exp(-state.hypers.log_lengthscales)
    amp = torch.exp(state.hypers.log_amplitude)
    xq = candidates.to(torch.float32)
    kqx = cross_kernel_matrix(kind, xq, state.x, inv_ls, amp) * state.mask[None, :]
    mean = kqx @ state.alpha
    v = torch.linalg.solve_triangular(state.chol, kqx.T, upper=False)
    kqq = cross_kernel_matrix(kind, xq, xq, inv_ls, amp)
    cov = kqq - v.T @ v
    cov = cov + torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device) * 1e-5
    chol = cholesky(cov)
    draws = -(mean[None, :] + eps @ chol.T)
    return torch.argmax(draws, dim=1)
