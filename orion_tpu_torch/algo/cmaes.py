"""CMA-ES on the device (port of ``orion_tpu/algo/cmaes.py``).

The search distribution N(m, sigma^2 C) lives on the algorithm's device as
the tuple ``(m, sigma, C, B, D, pc, ps, gen)`` (B, D: C's eigenvectors and
the square roots of its eigenvalues).  ``suggest`` is one draw of the whole
batch (one matmul against B·diag(D)); the rank-mu/rank-1 update is a
handful of ops around a (d, d) ``torch.linalg.eigh``.

Observations arrive in arbitrary batches: they accumulate in a host buffer,
and each time ``popsize`` of them are there one generation update runs.
Suggestions beyond ``popsize`` a round are extra i.i.d. draws.

:func:`_cma_sample` takes its normal draws ``z`` as an argument, so the
parity tests can inject the reference's.  Eigenvectors are defined only up
to sign (and rotation inside repeated eigenvalues), so the carried B may
differ from the reference's while B·diag(D²)·Bᵀ = C holds in both.
"""

import math

import numpy as np
import torch

from orion_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from orion_tpu_torch.algo.sampling import clamp_objectives, reflect_unit


def _cma_sample(z, state):
    """Candidates ``m + sigma * (z * D) @ B^T`` from (num, d) standard
    normal ``z``, reflected into [0,1]^d."""
    m, sigma, _C, B, D, _pc, _ps, _gen = state
    x = m[None, :] + sigma * (z * D[None, :]) @ B.T
    return reflect_unit(x)


def _init_state(d, sigma0, device):
    kw = dict(dtype=torch.float32, device=device)
    return (
        torch.full((d,), 0.5, **kw),  # m: mean
        torch.tensor(sigma0, **kw),  # sigma: global step size
        torch.eye(d, **kw),  # C: covariance
        torch.eye(d, **kw),  # B: eigenvectors of C
        torch.ones((d,), **kw),  # D: sqrt eigenvalues of C
        torch.zeros((d,), **kw),  # p_c: covariance path
        torch.zeros((d,), **kw),  # p_sigma: step-size path
        torch.tensor(0, dtype=torch.int32, device=device),  # generation counter
    )


def _eig_factors(C):
    eigval, B = torch.linalg.eigh(C)
    return B, torch.sqrt(torch.clamp(eigval, min=1e-20))


def _cma_update(state, X, y):
    """One generation from the (lam, d) points ``X`` and their objectives
    ``y``: rank, shift the mean, adapt the paths, C and sigma (Hansen's
    (mu/mu_w, lambda) update with rank-1 + rank-mu adaptation, the 2016
    tutorial's constants)."""
    m, sigma, C, B, D, pc, ps, gen = state
    d = m.shape[0]
    lam = X.shape[0]
    mu = lam // 2
    dev = m.device
    # Recombination weights (positive half, log-linear).
    w = torch.log(torch.full((), mu + 0.5, dtype=torch.float32, device=dev)) - torch.log(
        torch.arange(1, mu + 1, dtype=torch.float32, device=dev))
    w = w / torch.sum(w)
    mueff = 1.0 / torch.sum(w**2)

    cs = (mueff + 2.0) / (d + mueff + 5.0)
    ds = 1.0 + 2.0 * torch.clamp(torch.sqrt((mueff - 1.0) / (d + 1.0)) - 1.0, min=0.0) + cs
    cc = (4.0 + mueff / d) / (d + 4.0 + 2.0 * mueff / d)
    c1 = 2.0 / ((d + 1.3) ** 2 + mueff)
    cmu = torch.minimum(
        1.0 - c1, 2.0 * (mueff - 2.0 + 1.0 / mueff) / ((d + 2.0) ** 2 + mueff)
    )
    chi_d = math.sqrt(d) * (1.0 - 1.0 / (4.0 * d) + 1.0 / (21.0 * d * d))

    order = torch.argsort(y, stable=True)
    X_mu = X[order[:mu]]  # (mu, d) best points
    m_new = w @ X_mu
    shift = (m_new - m) / sigma

    # C^{-1/2} from the carried eigendecomposition.
    inv_sqrt = (B * (1.0 / D)[None, :]) @ B.T
    ps_new = (1.0 - cs) * ps + torch.sqrt(cs * (2.0 - cs) * mueff) * (inv_sqrt @ shift)
    gen_new = gen + 1
    hs = (
        torch.linalg.vector_norm(ps_new)
        / torch.sqrt(1.0 - (1.0 - cs) ** (2.0 * gen_new.to(torch.float32)))
        / chi_d
    ) < (1.4 + 2.0 / (d + 1.0))
    hs = hs.to(torch.float32)
    pc_new = (1.0 - cc) * pc + hs * torch.sqrt(cc * (2.0 - cc) * mueff) * shift

    Y_mu = (X_mu - m[None, :]) / sigma
    rank_mu = (Y_mu * w[:, None]).T @ Y_mu  # weighted scatter matrix
    delta_hs = (1.0 - hs) * cc * (2.0 - cc)
    C_new = (
        (1.0 - c1 - cmu) * C
        + c1 * (torch.outer(pc_new, pc_new) + delta_hs * C)
        + cmu * rank_mu
    )
    C_new = 0.5 * (C_new + C_new.T)

    sigma_new = sigma * torch.exp((cs / ds) * (torch.linalg.vector_norm(ps_new) / chi_d - 1.0))
    # Keep the distribution inside sane bounds for the unit cube.
    sigma_new = torch.clamp(sigma_new, 1e-12, 1.0)

    B_new, D_new = _eig_factors(C_new)
    return (m_new, sigma_new, C_new, B_new, D_new, pc_new, ps_new, gen_new)


@algo_registry.register("cmaes")
class CMAES(BaseAlgorithm):
    """Covariance matrix adaptation evolution strategy on the unit cube.

    ``popsize``: generation size lambda (default ``4 + floor(3 ln d)``);
    ``sigma0``: initial step size; ``tol_sigma``: ``is_done`` once sigma
    falls below it (clamped to the update's 1e-12 floor)."""

    def __init__(self, space, seed=None, popsize=None, sigma0=0.3, tol_sigma=1e-10,
                 device=None):
        d = space.n_cols
        if popsize is None:
            popsize = 4 + int(3 * math.log(max(d, 2)))
        popsize = max(int(popsize), 4)
        super().__init__(
            space, seed=seed, device=device, popsize=popsize, sigma0=sigma0,
            tol_sigma=tol_sigma
        )
        self.popsize = popsize
        self.sigma0 = float(sigma0)
        self.tol_sigma = max(float(tol_sigma), 1e-12)
        self._state = _init_state(d, self.sigma0, self.device)
        # Host generation buffer (observations arrive in arbitrary batches).
        self._buf_x = np.zeros((0, d), dtype=np.float32)
        self._buf_y = np.zeros((0,), dtype=np.float32)
        # Worst finite objective ever seen: the clamp baseline for
        # non-finite objectives (the buffer is transient).
        self._worst_finite = None

    # --- suggestion ---------------------------------------------------------
    def _suggest_cube(self, num):
        z = torch.randn((int(num), self.space.n_cols), generator=self._generator,
                        device=self.device, dtype=torch.float32)
        return _cma_sample(z, self._state)

    # --- observation --------------------------------------------------------
    def observe_arrays(self, cube, objectives, params_list=None, fidelities=None):
        history = (
            np.asarray([self._worst_finite]) if self._worst_finite is not None
            else np.zeros((0,))
        )
        objectives = clamp_objectives(objectives, history)
        if objectives is None:
            return
        batch_worst = float(np.max(objectives))
        if self._worst_finite is None or batch_worst > self._worst_finite:
            self._worst_finite = batch_worst
        self._buf_x = np.concatenate([self._buf_x, np.asarray(cube, dtype=np.float32)])
        self._buf_y = np.concatenate([self._buf_y, np.asarray(objectives, dtype=np.float32)])
        lam = self.popsize
        while self._buf_x.shape[0] >= lam:
            X = torch.from_numpy(self._buf_x[:lam].copy()).to(self.device)
            y = torch.from_numpy(self._buf_y[:lam].copy()).to(self.device)
            self._state = _cma_update(self._state, X, y)
            self._buf_x = self._buf_x[lam:]
            self._buf_y = self._buf_y[lam:]

    # --- lifecycle ----------------------------------------------------------
    @property
    def is_done(self):
        return float(self._state[1]) <= self.tol_sigma

    # --- state --------------------------------------------------------------
    def state_dict(self):
        out = super().state_dict()
        m, sigma, C, _B, _D, pc, ps, gen = (t.detach().cpu() for t in self._state)
        out["cma"] = {
            "m": m.tolist(),
            "sigma": float(sigma),
            "C": C.tolist(),
            "pc": pc.tolist(),
            "ps": ps.tolist(),
            "gen": int(gen),
        }
        out["buf_x"] = self._buf_x.tolist()
        out["buf_y"] = self._buf_y.tolist()
        out["worst_finite"] = self._worst_finite
        return out

    def set_state(self, state):
        super().set_state(state)
        cma = state["cma"]
        d = self.space.n_cols

        def leaf(value, shape=None):
            out = torch.tensor(np.asarray(value, dtype=np.float32), device=self.device)
            return out.reshape(shape) if shape is not None else out

        C = leaf(cma["C"], (d, d))
        B, D = _eig_factors(C)
        self._state = (
            leaf(cma["m"]), leaf(cma["sigma"]), C, B, D, leaf(cma["pc"]), leaf(cma["ps"]),
            torch.tensor(int(cma["gen"]), dtype=torch.int32, device=self.device),
        )
        self._buf_x = np.asarray(state["buf_x"], dtype=np.float32).reshape(-1, d)
        self._buf_y = np.asarray(state["buf_y"], dtype=np.float32)
        self._worst_finite = state.get("worst_finite")
