"""TPE, the tree-structured Parzen estimator (port of ``orion_tpu/algo/tpe.py``).

Split the observations at the gamma quantile into good and bad sets, model
each with a product of univariate kernel density estimates, and pick the
candidates maximizing l(x)/g(x).  Candidates come from the good-set KDE:
each dimension independently picks a good point (rank-weighted) and
jitters it by that dimension's bandwidth; every 4th candidate is uniform.

:func:`_tpe_suggest` is a function of its random draws (:class:`TPEDraws`),
so the parity tests can replay the reference's ``jax.random`` calls; the
algorithms draw them from their ``torch.Generator`` with
:func:`sample_tpe_draws`.
"""

from typing import NamedTuple

import numpy as np
import torch

from orion_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from orion_tpu_torch.algo.gp.acquisition import select_q
from orion_tpu_torch.algo.sampling import clamp_objectives, reflect_unit


class TPEDraws(NamedTuple):
    """The random arrays of one :func:`_tpe_suggest` call, all (m, d)."""

    pick_idx: torch.Tensor  # int: the good point each candidate coordinate jitters
    noise: torch.Tensor  # standard normal jitter
    uniform: torch.Tensor  # uniform rows of the exploration quarter


def _pool_size(n_candidates, num):
    # top-k needs k <= pool size: grow the pool to fit a large request.
    return max(n_candidates, num)


def sample_tpe_draws(generator, n_good, m, d, device):
    """Draw a :class:`TPEDraws` from ``generator``: the picks from the
    rank-weighted categorical over the ``n_good`` good points."""
    probs = torch.exp(_rank_log_weights(n_good, device))
    pick = torch.multinomial(probs, m * d, replacement=True, generator=generator)
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    return TPEDraws(pick.reshape(m, d), torch.randn((m, d), **kw), torch.rand((m, d), **kw))


def good_bad_split(x, y, gamma):
    """Split observations at the gamma quantile into (good, bad) host arrays;
    the bad set falls back to the good one when everything is good.  The
    good set comes BEST-FIRST, so rank weights line up with it."""
    n = y.shape[0]
    n_good = max(1, int(np.ceil(gamma * n)))
    order = np.argsort(y, kind="stable")
    good = x[order[:n_good]]
    bad = x[order[n_good:]]
    if len(bad) == 0:
        bad = good
    return good, bad


def _bandwidth_1d(points):
    """Per-dimension univariate bandwidths: std_j * n^(-1/5) (the 1-D Scott
    rate: the density is a product of 1-D KDEs, so d enters nowhere)."""
    n = points.shape[0]
    std = torch.clamp(torch.std(points, dim=0, correction=0), min=1e-3)
    return std * (n ** (-0.2))


def _rank_log_weights(n, device):
    """CMA-style log-rank weights (normalized), best-first order."""
    ranks = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    w = torch.log(torch.full((), n + 0.5, dtype=torch.float32, device=device)) - torch.log(ranks)
    return torch.log(w / torch.sum(w))


def _log_kde_product(x, points, bandwidth, log_w=None):
    """(m,) log density of the product of univariate KDEs over ``points``,
    with optional per-point mixture weights ``log_w``.

    Accumulated one dimension at a time, as the reference's scan, so peak
    memory is one (m, n) slab, never (m, n, d).  Inputs are centred on the
    KDE points first: with bandwidths near their 1e-3 floor, uncentred
    coordinates over the bandwidth reach ~1e3 and float32 squaring loses
    the distances."""
    center = torch.mean(points, dim=0, keepdim=True)
    xc = x - center
    pc = points - center
    if log_w is None:
        n = points.shape[0]
        log_w = torch.zeros(n, dtype=x.dtype, device=x.device) - torch.log(
            torch.full((), n, dtype=x.dtype, device=x.device))
    total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    log_bw = torch.log(bandwidth)
    for j in range(x.shape[1]):
        z = (xc[:, j, None] - pc[None, :, j]) / bandwidth[j]
        log_k = -0.5 * z**2 - log_bw[j] + log_w[None, :]
        total = total + torch.logsumexp(log_k, dim=1)
    return total


def _tpe_pool(draws, good, bad, bw_factor=1.0):
    """The candidate pool ``(m, d)`` of ``draws`` and its (m,) scores
    log l(x) - log g(x)."""
    m = draws.noise.shape[0]
    # bw_factor < 1 sharpens the good-set KDE below the 1-D Scott rate.
    bw_good = _bandwidth_1d(good) * bw_factor
    log_w = _rank_log_weights(good.shape[0], good.device)
    picked = torch.gather(good, 0, draws.pick_idx.long())
    cands = reflect_unit(picked + draws.noise * bw_good[None, :])
    take_uniform = (torch.arange(m, device=good.device) % 4) == 3
    cands = torch.where(take_uniform[:, None], draws.uniform, cands)
    score = _log_kde_product(cands, good, bw_good, log_w=log_w) - _log_kde_product(
        cands, bad, _bandwidth_1d(bad)
    )
    return cands, score


def _tpe_suggest(draws, good, bad, num, bw_factor=1.0):
    """The ``num`` best candidates of the pool (``m`` = the draws' rows) by
    l(x)/g(x), as (num, d) rows on the device of ``good``.  Ties in the
    score go to the lower index, as ``lax.top_k``."""
    cands, score = _tpe_pool(draws, good, bad, bw_factor)
    return cands[select_q(score, num)]


def tpe_round(generator, good, bad, n_candidates, num, bw_factor, device):
    """One TPE suggestion batch from host ``good``/``bad`` arrays: upload,
    draw, score.  Shared by :class:`TPE` and ``bohb``."""
    good = torch.from_numpy(np.ascontiguousarray(good, dtype=np.float32)).to(device)
    bad = torch.from_numpy(np.ascontiguousarray(bad, dtype=np.float32)).to(device)
    m = _pool_size(n_candidates, num)
    draws = sample_tpe_draws(generator, good.shape[0], m, good.shape[1], device)
    return _tpe_suggest(draws, good, bad, num, bw_factor=bw_factor)


@algo_registry.register("tpe")
class TPE(BaseAlgorithm):
    """``n_devices``/``use_mesh`` belong to the multi-device mesh, which is
    not ported (``use_mesh=True`` raises)."""

    def __init__(self, space, seed=None, n_init=20, gamma=0.25, n_candidates=1024,
                 bw_factor=1.0, n_devices=None, use_mesh=False, device=None):
        if use_mesh:
            raise NotImplementedError("orion_tpu_torch: the multi-device mesh is not ported yet")
        super().__init__(
            space, seed=seed, device=device, n_init=n_init, gamma=gamma,
            n_candidates=n_candidates, bw_factor=bw_factor
        )
        self.n_init = n_init
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.bw_factor = float(bw_factor)
        self._x = np.zeros((0, space.n_cols), dtype=np.float32)
        self._y = np.zeros((0,), dtype=np.float32)

    # The observation arrays are rebound on append, never mutated.
    _share_by_ref = ("space", "_x", "_y")

    def observe_arrays(self, cube, objectives, params_list=None, fidelities=None):
        objectives = clamp_objectives(objectives, self._y)
        if objectives is None:
            return
        self._x = np.concatenate([self._x, np.asarray(cube, dtype=np.float32)])
        self._y = np.concatenate([self._y, np.asarray(objectives, dtype=np.float32)])

    def _suggest_cube(self, num):
        if len(self._y) < self.n_init:
            return torch.rand((num, self.space.n_cols), generator=self._generator,
                              device=self.device)
        good, bad = good_bad_split(self._x, self._y, self.gamma)
        return tpe_round(self._generator, good, bad, self.n_candidates, num,
                         self.bw_factor, self.device)

    def state_dict(self):
        out = super().state_dict()
        out["x"] = self._x.tolist()
        out["y"] = self._y.tolist()
        return out

    def set_state(self, state):
        super().set_state(state)
        self._x = np.asarray(state["x"], dtype=np.float32).reshape(-1, self.space.n_cols)
        self._y = np.asarray(state["y"], dtype=np.float32)

