"""Batched GP-BO on the card (port of ``orion_tpu/algo/tpu_bo.py``).

One suggest round is :func:`_suggest_step`: a warm-started GP refit with the
copula y-transform, trust-region candidate generation with gradient polish,
RFF-Thompson acquisition, an EI ranking of the whole pool (where the
candidate cross-gram runs in the hand-written ``fused_gram`` kernel),
on-device dedup with EI backfill, and the gather of the q rows plus a packed
health vector.  Everything stays on the algorithm's device; the only host
copies are the (q, d) rows and, when asked for, the health vector.

The reference compiles the round into one jitted function with threefry
keys.  Here the round runs eagerly and is a function of its random draws
(:class:`SuggestDraws`): :func:`sample_suggest_draws` draws them from the
instance's ``torch.Generator``, and the parity tests replay the reference's
key schedule through ``jax.random`` and pass the same numbers to both.

Each stage of a round runs inside a ``torch.profiler.record_function`` span
named ``suggest.<stage>`` (draws, fit_gp, candidates, polish, acquire,
ei_rank, select), so a profiled round reads as its own breakdown.

Telemetry (:func:`dispatch_suggest_step`, also ``asha_bo``'s entry): with
the registry on, each round books one ``suggest_step.dispatch`` span with
``{"q", "n"}`` args — the host's cost of dispatching the step, as the
reference's ``jax.suggest_step.dispatch``.  Eager PyTorch has no trace
cache, so there is no ``jax.suggest_step.compile`` span and no
``jax.retraces`` counter; their counterpart comes with the compiler plane
(ROADMAP queue A item 6).

Not ported yet: the fused-plan and serve-coalescing machinery (``FusedPlan``,
``make_fused_plan``, ``run_fused_plan``, ``PlanPrepToken``), the jit prewarmer
(``prewarm`` is accepted and has no effect) and the device mesh
(``use_mesh=True`` raises ``NotImplementedError``).
"""

import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from orion_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from orion_tpu_torch.algo.gp.acquisition import (
    acquire,
    expected_improvement,
    joint_thompson,
    sample_rff_draws,
    select_q,
)
from orion_tpu_torch.algo.gp.gp import (
    Adam,
    GPHypers,
    cholesky,
    fit_gp,
    init_hypers,
    posterior_norm,
)
from orion_tpu_torch.algo.history import DeviceHistory, HostHistory, _next_pow2
from orion_tpu_torch.algo.sampling import clamp_objectives, reflect_unit
from orion_tpu_torch.telemetry import TELEMETRY

#: Random Fourier features of the Thompson acquisition.
N_FEATURES = 512
#: Adam steps and rate of the candidate polish.
POLISH_STEPS = 30
POLISH_LR = 0.02


class WarmStart(NamedTuple):
    """Restored GP warm start: the slice of GPState the suggest path reads
    before the first post-restore fit (``hypers`` for the refit init)."""

    hypers: GPHypers
    mll: None = None
    health: None = None


def copula_transform(y):
    """Rank -> normal quantile on host (monotone: argmin preserved); the
    host twin of ``sampling.masked_copula_transform``.  The inner sort is
    stable, so duplicate objectives get first-occurrence ranks."""
    from scipy.special import ndtri

    order = np.argsort(np.argsort(y, kind="stable"))
    return ndtri((order + 0.5) / y.shape[0]).astype(np.float32)


def tr_update(length, succ, fail, improved, *, succ_tol, fail_tol,
              length_init, length_min, length_max):
    """One trust-region bookkeeping step (TuRBO schedule): expand after
    ``succ_tol`` consecutive improving rounds, halve after ``fail_tol``
    stagnating ones, restart wide on collapse.  Returns
    ``(length, succ, fail, restarted)``."""
    if improved:
        succ, fail = succ + 1, 0
    else:
        succ, fail = 0, fail + 1
    if succ >= succ_tol:
        length, succ = min(2.0 * length, length_max), 0
    elif fail >= fail_tol:
        length, fail = length / 2.0, 0
    restarted = length < length_min
    if restarted:
        length, succ, fail = length_init, 0, 0
    return length, succ, fail, restarted


def tr_update_batch(length, succ, fail, prev_best, objectives, *, chunk,
                    succ_tol, fail_tol, length_init, length_min, length_max,
                    improve_tol):
    """Run the TuRBO schedule over ONE observe round, splitting a batch
    larger than ``chunk`` into sequential sub-rounds (arrival order, running
    incumbent), so the box's cadence does not depend on the batch size."""
    y = np.asarray(objectives, dtype=np.float64).ravel()
    best = float(prev_best)
    n_restarts = 0
    for i in range(0, y.shape[0], chunk):
        chunk_best = float(np.min(y[i : i + chunk]))
        improved = chunk_best < best - improve_tol * abs(best)
        length, succ, fail, restarted = tr_update(
            length, succ, fail, improved,
            succ_tol=succ_tol, fail_tol=fail_tol, length_init=length_init,
            length_min=length_min, length_max=length_max,
        )
        n_restarts += restarted
        best = min(best, chunk_best)
    return length, succ, fail, n_restarts


# --- random draws of one round ----------------------------------------------


class SuggestDraws(NamedTuple):
    """Every random array one :func:`_suggest_step` consumes.  Fields a
    configuration does not use are None."""

    global_u: torch.Tensor  # (n_global, d) uniform: the global candidates
    box_u: Optional[torch.Tensor] = None  # (n_box, d) uniform: trust box
    perturb_mask: Optional[torch.Tensor] = None  # (n_box, d) bool, d > perturb dims
    forced_dim: Optional[torch.Tensor] = None  # (n_box,) int in [0, d)
    cov_z: Optional[torch.Tensor] = None  # (n_cov, d) normal
    dir_t: Optional[torch.Tensor] = None  # (n_dir, 1) normal
    dir_z: Optional[torch.Tensor] = None  # (n_dir, d) normal
    cem_z: Optional[torch.Tensor] = None  # (n_cem, d) normal
    polish_z: Optional[torch.Tensor] = None  # (n_polish, d) normal
    local_z: Optional[torch.Tensor] = None  # (n_local, d) normal, no trust region
    acq: object = None  # RFFDraws, or (q, m) normal for the other Thompsons


def _candidate_split(n_candidates, local_frac):
    """``(n_global, n_box, n_cov, n_dir, n_cem, n_local)`` of a pool."""
    n_local = int(n_candidates * local_frac)
    n_cov = n_dir = n_cem = n_local // 6
    n_box = n_local - n_cov - n_dir - n_cem
    return n_candidates - n_local, n_box, n_cov, n_dir, n_cem, n_local


def _n_polish(q, n_candidates):
    # Scale the exploiter count with the batch, clamped to half the pool.
    return max(1, min(64, max(8, q // 16), n_candidates // 2))


def sample_suggest_draws(generator, *, q, n_candidates, d_free, d, acq, local_frac,
                         trust_region, tr_perturb_dims=20, device):
    """Draw a round's :class:`SuggestDraws` from ``generator`` on ``device``.

    ``d_free`` is the width of the generated candidates, ``d`` the width the
    acquisition scores (``d_free`` plus any fixed tail columns)."""
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    n_global, n_box, n_cov, n_dir, n_cem, n_local = _candidate_split(n_candidates, local_frac)
    fields = {"global_u": torch.rand((n_global, d_free), **kw)}
    if trust_region:
        fields["box_u"] = torch.rand((n_box, d_free), **kw)
        p_perturb = min(1.0, tr_perturb_dims / d_free)
        if p_perturb < 1.0:
            fields["perturb_mask"] = torch.rand((n_box, d_free), **kw) < p_perturb
            fields["forced_dim"] = torch.randint(
                0, d_free, (n_box,), generator=generator, device=device
            )
        fields["cov_z"] = torch.randn((n_cov, d_free), **kw)
        fields["dir_t"] = torch.randn((n_dir, 1), **kw)
        fields["dir_z"] = torch.randn((n_dir, d_free), **kw)
        fields["cem_z"] = torch.randn((n_cem, d_free), **kw)
        fields["polish_z"] = torch.randn((_n_polish(q, n_candidates), d_free), **kw)
    else:
        fields["local_z"] = torch.randn((n_local, d_free), **kw)
    if acq == "thompson":
        fields["acq"] = sample_rff_draws(generator, N_FEATURES, d, q, device)
    elif acq in ("marginal_thompson", "joint_thompson"):
        fields["acq"] = torch.randn((q, n_candidates), **kw)
    return SuggestDraws(**fields)


# --- candidate generation ---------------------------------------------------


def _make_candidates(draws, n_candidates, best_x, local_frac, local_sigma):
    """Candidate set: global uniform + gaussian ball around the incumbent,
    folded back into the cube by reflection (clipping would pile points on
    the exact floats 0.0/1.0)."""
    n_local = int(n_candidates * local_frac)
    local_c = best_x[None, :] + local_sigma * draws.local_z[:n_local]
    return torch.cat([draws.global_u, reflect_unit(local_c)], dim=0)


def _topk_cov_chol(x, y, mask, n_dims, k=64):
    """Cholesky factor and mean of the (log-weighted) covariance of the k
    best observed points: a rotated sampling distribution that follows the
    local geometry of the descent."""
    keyed = torch.where(mask > 0, y, torch.full_like(y, float("inf")))
    top = torch.argsort(keyed, stable=True)[:k]
    elite = x[top]
    # CMA-style log weights; padded rows that land in the top k get weight 0.
    ranks = torch.arange(1, k + 1, dtype=x.dtype, device=x.device)
    # torch.full, not torch.tensor: no host-to-device copy (and so no wait
    # on the queued fit) in the middle of the round.
    w = torch.log(torch.full((), k + 0.5, dtype=x.dtype, device=x.device)) - torch.log(ranks)
    w = w * mask[top]
    w = w / torch.clamp(torch.sum(w), min=1e-12)
    mu = torch.sum(elite * w[:, None], dim=0)
    centered = elite - mu[None, :]
    cov = (centered * w[:, None]).T @ centered
    # Ridge: elite sets collapsed to a subspace must still factorize.
    eye = torch.eye(n_dims, dtype=x.dtype, device=x.device)
    return cholesky(cov + 1e-6 * eye), mu


def _tr_box(center, tr_length, lengthscales):
    """Trust-box bounds: per-dimension half-widths follow the GP
    lengthscales normalized to geometric mean 1, clipped to the cube."""
    scale = lengthscales / torch.exp(torch.mean(torch.log(lengthscales)))
    half = 0.5 * tr_length * scale
    lb = torch.clamp(center - half, 0.0, 1.0)
    ub = torch.clamp(center + half, 0.0, 1.0)
    return lb, ub


def _polish_candidates(state, kernel, starts, lb, ub, n_steps=POLISH_STEPS,
                       lr=POLISH_LR, fixed_tail_cols=0):
    """Multi-start adam descent on the GP posterior mean, box-clipped every
    step.  The reference vmaps ``grad`` over the starts; the rows are
    independent and adam is elementwise, so one gradient of the summed
    means does all starts at once."""
    x = starts
    opt = Adam([x], lr)
    tail = None
    if fixed_tail_cols:
        tail = torch.ones((x.shape[0], fixed_tail_cols), dtype=x.dtype, device=x.device)
    for _ in range(n_steps):
        leaf = x.detach().requires_grad_(True)
        with torch.enable_grad():
            x_full = leaf if tail is None else torch.cat([leaf, tail], dim=1)
            mean, _ = posterior_norm(state, x_full, kind=kernel)
            (grad,) = torch.autograd.grad(mean.sum(), leaf)
        (x,) = opt.step([x], [torch.nan_to_num(grad)])
        x = torch.clamp(x, lb, ub)
    return x


def _make_tr_candidates(draws, n_candidates, n_dims, center, tr_length, lengthscales,
                        local_frac, cov_chol, elite_mu, perturb_dims=20):
    """TuRBO-style candidates: the local fraction split between the trust
    box and elite-covariance gaussian steps, the remainder global uniform.

    Each box candidate perturbs a random ~min(perturb_dims, d) subset of
    coordinates and keeps the incumbent elsewhere (TuRBO's perturbation
    mask).  The covariance, directional and CEM sources step along the
    elite set's principal directions."""
    _n_global, _n_box, n_cov, _n_dir, _n_cem, _n_local = _candidate_split(
        n_candidates, local_frac
    )
    lb, ub = _tr_box(center, tr_length, lengthscales)
    box = lb[None, :] + draws.box_u * (ub - lb)[None, :]
    if min(1.0, perturb_dims / n_dims) < 1.0:
        forced = torch.nn.functional.one_hot(draws.forced_dim.long(), n_dims) > 0
        mask = torch.where(
            torch.any(draws.perturb_mask, dim=1, keepdim=True), draws.perturb_mask, forced
        )
        box = torch.where(mask, box, center[None, :])
    # Half unit-scale steps, half double.
    even = (torch.arange(n_cov, device=center.device) % 2 == 0)[:, None]
    sigma = torch.where(even, 1.0, 2.0).to(center.dtype)
    cov_c = reflect_unit(center[None, :] + sigma * (draws.cov_z @ cov_chol.T))
    t = draws.dir_t * 2.0
    dir_c = reflect_unit(
        center[None, :] + t * (center - elite_mu)[None, :] + 0.5 * (draws.dir_z @ cov_chol.T)
    )
    cem_c = reflect_unit(elite_mu[None, :] + draws.cem_z @ cov_chol.T)
    return torch.cat([draws.global_u, box, cov_c, dir_c, cem_c], dim=0)


def _dedup_fill_device(idx, ei_rank, q):
    """On-device first-occurrence dedup of ``idx`` with EI-ranked backfill.

    Unique draws keep their draw position as sort key, duplicates and
    already-drawn fill candidates are pushed past everything usable, EI
    fills slot in after the draws; one stable sort puts equal draws next to
    each other (first occurrence first) and a searchsorted probe tests
    membership."""
    k = ei_rank.shape[0]
    dev = idx.device
    pos_q = torch.arange(q, device=dev)
    pos_k = torch.arange(k, device=dev)
    sort_perm = torch.argsort(idx, stable=True)
    sorted_idx = idx[sort_perm]
    dup_sorted = torch.cat(
        [torch.zeros((1,), dtype=torch.bool, device=dev), sorted_idx[1:] == sorted_idx[:-1]]
    )
    is_dup = torch.zeros((q,), dtype=torch.bool, device=dev).scatter(0, sort_perm, dup_sorted)
    probe = torch.searchsorted(sorted_idx, ei_rank)
    is_member = sorted_idx[torch.clamp(probe, 0, q - 1)] == ei_rank
    big = q + k + 1
    key_draws = torch.where(is_dup, big + pos_q, pos_q)
    key_fills = torch.where(is_member, big + q + pos_k, q + pos_k)
    all_idx = torch.cat([idx, ei_rank])
    order = torch.argsort(torch.cat([key_draws, key_fills]))
    return all_idx[order][:q]


def _suggest_step(draws, x, y, mask, best_x, warm_hypers, tr_length=None, *, q,
                  n_candidates, kernel, acq, fit_steps, local_frac, local_sigma, beta,
                  trust_region=False, tr_perturb_dims=20, y_transform="none",
                  fixed_tail_cols=0):
    """The whole GP-BO suggest round, on the device of ``x``: returns the
    (q, d_free) rows and the fitted GPState with its health vector.

    ``y`` arrives raw; ``y_transform="copula"`` rank-Gaussianizes it inside
    the fit.  ``fixed_tail_cols``: the last k input columns are context,
    pinned to 1.0 when scoring; candidates and returned rows cover the
    leading columns only.  No host sync happens in here."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    mask = mask.to(torch.float32)
    best_x = best_x.to(torch.float32)
    with record_function("suggest.fit_gp"):
        state = fit_gp(
            x, y, mask, kind=kernel, n_steps=fit_steps, init=warm_hypers,
            y_transform=y_transform,
        )
    d_free = x.shape[1] - fixed_tail_cols
    if trust_region:
        with record_function("suggest.candidates"):
            cov_chol, elite_mu = _topk_cov_chol(
                x[:, :d_free], y, mask, d_free, k=min(64, x.shape[0])
            )
            lengthscales = torch.exp(state.hypers.log_lengthscales[:d_free])
            free_candidates = _make_tr_candidates(
                draws, n_candidates, d_free, best_x[:d_free], tr_length, lengthscales,
                local_frac, cov_chol, elite_mu, perturb_dims=tr_perturb_dims,
            )
        # Gradient-polish elite-covariance-jittered incumbent copies on the
        # posterior mean and splice them over the pool's tail.
        with record_function("suggest.polish"):
            lb, ub = _tr_box(best_x[:d_free], tr_length, lengthscales)
            n_polish = _n_polish(q, n_candidates)
            starts = torch.clamp(
                best_x[None, :d_free] + (0.5 * draws.polish_z) @ cov_chol.T, lb, ub
            )
            polished = _polish_candidates(
                state, kernel, starts, lb, ub, fixed_tail_cols=fixed_tail_cols
            )
            free_candidates = torch.cat([free_candidates[:-n_polish], polished], dim=0)
    else:
        with record_function("suggest.candidates"):
            free_candidates = _make_candidates(
                draws, n_candidates, best_x[:d_free], local_frac, local_sigma
            )
    if fixed_tail_cols:
        tail = torch.ones((free_candidates.shape[0], fixed_tail_cols),
                          dtype=free_candidates.dtype, device=free_candidates.device)
        candidates = torch.cat([free_candidates, tail], dim=1)
    else:
        candidates = free_candidates
    inf = torch.full((), float("inf"), dtype=torch.float32, device=x.device)
    y_norm = (state.y - state.y_mean) / state.y_std
    if fixed_tail_cols:
        # The EI incumbent is the best observation at the top context tier.
        s_col = x[:, -1]
        s_max = torch.max(torch.where(mask > 0, s_col, -inf))
        top = (mask > 0) & (s_col >= s_max - 1e-6)
        best = torch.min(torch.where(top, y_norm, inf))
    else:
        best = torch.min(torch.where(state.mask > 0, y_norm, inf))
    with record_function("suggest.acquire"):
        if acq == "joint_thompson":
            idx = joint_thompson(draws.acq, state, candidates, q, kind=kernel)
        else:
            idx = acquire(draws.acq, state, candidates, q, kind=kernel, acq=acq, best=best,
                          beta=beta)
    with record_function("suggest.ei_rank"):
        mean, std = posterior_norm(state, candidates, kind=kernel)
        ei = expected_improvement(mean, std, best)
        ei_rank = select_q(ei, min(4 * q, n_candidates))
    with record_function("suggest.select"):
        if trust_region:
            # One pure-exploitation member per batch: the pool's posterior-mean
            # minimizer, unless it is already observed (then re-suggesting it
            # would loop on duplicate trials).
            exploit_idx = torch.argmin(mean)
            exploit_cand = free_candidates[exploit_idx]
            d2_obs = torch.sum((x[:, :d_free] - exploit_cand[None, :]) ** 2, dim=1)
            already_observed = torch.any((d2_obs < 1e-12) & (mask > 0))
            injected = torch.where(already_observed, idx[0], exploit_idx)
            idx = torch.cat([injected[None], idx])[:q]
        final_idx = _dedup_fill_device(idx, ei_rank, q)
        # Packed health vector (health.DEVICE_HEALTH_FIELDS), from intermediates
        # already on the device.
        ls = torch.exp(state.hypers.log_lengthscales[:d_free])
        sorted_idx = torch.sort(final_idx).values
        n_unique = 1.0 + torch.sum((sorted_idx[1:] != sorted_idx[:-1]).to(ls.dtype))
        health = torch.stack(
            [
                state.mll,
                torch.min(ls),
                torch.mean(ls),
                torch.max(ls),
                torch.exp(state.hypers.log_noise),
                torch.max(ei),
                torch.mean(ei),
                n_unique / q,
            ]
        ).to(torch.float32)
        state = state._replace(health=health)
        return free_candidates[final_idx], state


def dispatch_suggest_step(num, draws, x, *args, **kwargs):
    """:func:`_suggest_step` for ``num`` requested rows, booked as one
    ``suggest_step.dispatch`` span (``{"q": num, "n": rows of x}``) when
    telemetry is on.  No device sync inside the span: like the reference's
    dispatch span it measures the host's cost of issuing the step, and a
    sync would change the round it observes."""
    t0 = time.perf_counter() if TELEMETRY.enabled else None
    out = _suggest_step(draws, x, *args, **kwargs)
    if t0 is not None:
        TELEMETRY.record_span(
            "suggest_step.dispatch",
            start=t0,
            args={"q": int(num), "n": int(x.shape[0])},
        )
    return out


@algo_registry.register("tpu_bo")
class TPUBO(BaseAlgorithm):
    """Batched GP-BO on the card; the constructor takes the reference's
    keyword arguments (see ``orion_tpu.algo.tpu_bo.TPUBO``) plus ``device``
    (None means ``cuda``; raises where no card is present).

    ``prewarm``/``prewarm_fill`` configure a jit prewarmer the port does
    not need (it runs eagerly) and are accepted and ignored; ``n_devices``
    and ``use_mesh`` belong to the multi-device mesh, which is not ported
    (``use_mesh=True`` raises)."""

    supports_async_suggest = True

    def __init__(
        self,
        space,
        seed=None,
        n_init=16,
        n_candidates=8192,
        acq="thompson",
        kernel="matern52",
        fit_steps=50,
        refit_steps=None,
        beta=2.0,
        local_frac=0.5,
        local_sigma=0.1,
        y_transform="copula",
        trust_region=True,
        tr_length_init=0.8,
        tr_length_min=0.5**7,
        tr_length_max=1.6,
        tr_succ_tol=3,
        tr_fail_tol=4,
        tr_improve_tol=1e-3,
        tr_local_m=256,
        tr_perturb_dims=20,
        tr_update_every=8,
        speculative_suggest=False,
        prewarm=True,
        prewarm_fill=0.75,
        n_devices=None,
        use_mesh=False,
        device=None,
    ):
        if use_mesh:
            raise NotImplementedError("orion_tpu_torch: the multi-device mesh is not ported yet")
        super().__init__(
            space,
            seed=seed,
            device=device,
            n_init=n_init,
            n_candidates=n_candidates,
            acq=acq,
            kernel=kernel,
            fit_steps=fit_steps,
            refit_steps=refit_steps,
            beta=beta,
            local_frac=local_frac,
            local_sigma=local_sigma,
            y_transform=y_transform,
            trust_region=trust_region,
            tr_length_init=tr_length_init,
            tr_length_min=tr_length_min,
            tr_length_max=tr_length_max,
            tr_succ_tol=tr_succ_tol,
            tr_fail_tol=tr_fail_tol,
            tr_improve_tol=tr_improve_tol,
            tr_local_m=tr_local_m,
            tr_perturb_dims=tr_perturb_dims,
            tr_update_every=tr_update_every,
            speculative_suggest=speculative_suggest,
            prewarm=prewarm,
            prewarm_fill=prewarm_fill,
        )
        self.n_init = n_init
        self.n_candidates = n_candidates
        self.acq = acq
        self.kernel = kernel
        self.fit_steps = fit_steps
        self.refit_steps = refit_steps
        self.beta = beta
        self.local_frac = local_frac
        self.local_sigma = local_sigma
        self.y_transform = y_transform
        self.trust_region = trust_region
        self.tr_length_init = tr_length_init
        self.tr_length_min = tr_length_min
        self.tr_length_max = tr_length_max
        self.tr_succ_tol = tr_succ_tol
        self.tr_fail_tol = tr_fail_tol
        self.tr_improve_tol = tr_improve_tol
        self.tr_local_m = tr_local_m
        self.tr_perturb_dims = tr_perturb_dims
        self.tr_update_every = tr_update_every
        self.speculation_safe = bool(speculative_suggest)
        d = space.n_cols
        self._host = HostHistory(d)
        self._hist = DeviceHistory(d, device=self.device)
        self._gp_state = None
        self._tr_length = tr_length_init
        self._tr_succ = 0
        self._tr_fail = 0
        # Fresh-restart override: row index the trust box centers on after a
        # collapse with no progress (None = the global incumbent).
        self._tr_center = None

    # The fitted GP state is immutable-by-rebinding; `_hist` and `_host`
    # implement copy-on-write in their own __deepcopy__.
    _share_by_ref = ("space", "_gp_state")

    @property
    def _x(self):
        return self._host.x

    @property
    def _y(self):
        return self._host.y

    # --- observation --------------------------------------------------------
    def observe_arrays(self, cube, objectives, params_list=None, fidelities=None):
        objectives = clamp_objectives(objectives, self._y)
        if objectives is None:
            return
        prev_n = self._host.count
        prev_best = self._host.best_y
        rows32 = np.asarray(cube, dtype=np.float32)
        y32 = np.asarray(objectives, dtype=np.float32)
        self._host.append(rows32, y32)
        self._hist.append(rows32, y32)
        # Trust-region bookkeeping counts MODEL rounds only.
        if self.trust_region and prev_n >= self.n_init:
            (self._tr_length, self._tr_succ, self._tr_fail,
             n_restarts) = tr_update_batch(
                self._tr_length, self._tr_succ, self._tr_fail,
                prev_best, objectives, chunk=self.tr_update_every,
                succ_tol=self.tr_succ_tol, fail_tol=self.tr_fail_tol,
                length_init=self.tr_length_init,
                length_min=self.tr_length_min,
                length_max=self.tr_length_max,
                improve_tol=self.tr_improve_tol,
            )
            new_best = self._host.best_y
            if new_best < prev_best - self.tr_improve_tol * abs(prev_best):
                self._tr_center = None
            elif n_restarts:
                # Collapse without progress: restart around the best
                # observation usefully far from the stuck incumbent.
                self._tr_center = self._fresh_restart_center()

    def _fresh_restart_center(self):
        """Index of the best observation at least a quarter of the mean
        distance away from the incumbent; None when nothing qualifies."""
        best_idx = self._host.best_idx
        d = np.sqrt(((self._x - self._x[best_idx]) ** 2).sum(axis=1))
        far = d >= max(float(d.mean()) / 4.0, 1e-6)
        if not far.any():
            return None
        candidates = np.where(far)[0]
        return int(candidates[np.argmin(self._y[candidates])])

    # --- suggestion ---------------------------------------------------------
    def _step_kw(self):
        return dict(
            n_candidates=self.n_candidates,
            kernel=self.kernel,
            acq=self.acq,
            local_frac=self.local_frac,
            local_sigma=self.local_sigma,
            beta=self.beta,
            trust_region=self.trust_region,
            tr_perturb_dims=self.tr_perturb_dims,
            y_transform=self.y_transform,
        )

    def _suggest_cube(self, num):
        n = self._host.count
        if n < self.n_init:
            return torch.rand((num, self.space.n_cols), generator=self._generator,
                              device=self.device)
        q = _next_pow2(num, floor=8)
        center_idx = (
            self._tr_center
            if self._tr_center is not None and self._tr_center < n
            else self._host.best_idx
        )
        best_x = torch.from_numpy(self._host.x[center_idx].copy()).to(self.device)
        if self.trust_region and n > self.tr_local_m:
            # LOCAL GP (the TuRBO design): fit only the tr_local_m nearest
            # observations to the incumbent, gathered on the device.
            x_dev, y_dev, mask_dev, _ = self._hist.local_view(best_x, self.tr_local_m)
        else:
            x_dev, y_dev, mask_dev, _ = self._hist.fit_view()
        warm = self._gp_state
        if warm is None:
            hypers = init_hypers(x_dev.shape[1], device=self.device)
            steps = self.fit_steps
        else:
            hypers = warm.hypers
            steps = self.refit_steps if self.refit_steps is not None else self.fit_steps
        step_kw = self._step_kw()
        with record_function("suggest.draws"):
            draws = sample_suggest_draws(
                self._generator, q=q, n_candidates=self.n_candidates, d_free=x_dev.shape[1],
                d=x_dev.shape[1], acq=self.acq, local_frac=self.local_frac,
                trust_region=self.trust_region, tr_perturb_dims=self.tr_perturb_dims,
                device=self.device,
            )
        tr = torch.tensor(self._tr_length, dtype=torch.float32, device=self.device)
        rows, state = dispatch_suggest_step(
            num, draws, x_dev, y_dev, mask_dev, best_x, hypers, tr, q=q, fit_steps=steps,
            **step_kw,
        )
        self._gp_state = state
        return rows[:num]

    # --- health -------------------------------------------------------------
    def health_record(self):
        """Per-round optimization health: incumbent and trust-region box
        from the host trackers, GP fit / acquisition / dedup fields from
        the packed vector the last suggest step attached to its GPState."""
        from orion_tpu_torch.health import unpack_device_health

        record = {
            "algo": type(self).__name__.lower(),
            "n_obs": int(self._host.count),
            "tr_length": float(self._tr_length),
            "tr_succ": int(self._tr_succ),
            "tr_fail": int(self._tr_fail),
        }
        if self._host.count:
            record["best_y"] = float(self._host.best_y)
        state = self._gp_state
        if state is not None and state.health is not None:
            record.update(unpack_device_health(state.health))
        return record

    # --- state --------------------------------------------------------------
    def state_dict(self):
        out = super().state_dict()
        out["x"] = self._x.tolist()
        out["y"] = self._y.tolist()
        out["tr"] = [self._tr_length, self._tr_succ, self._tr_fail]
        out["tr_center"] = self._tr_center
        # GP warm start: without it a restored instance cold-fits and the
        # suggestion stream forks at the restore point.
        if self._gp_state is not None:
            hypers = self._gp_state.hypers
            out["gp_hypers"] = [
                hypers.log_lengthscales.detach().cpu().tolist(),
                float(hypers.log_amplitude),
                float(hypers.log_noise),
            ]
        return out

    def set_state(self, state):
        super().set_state(state)
        d = self.space.n_cols
        x = np.asarray(state["x"], dtype=np.float32).reshape(-1, d)
        y = np.asarray(state["y"], dtype=np.float32)
        self._host = HostHistory.from_host(x, y)
        self._hist = DeviceHistory.from_host(x, y, device=self.device)
        saved = state.get("gp_hypers")
        if saved is not None:
            def leaf(value):
                return torch.tensor(value, dtype=torch.float32, device=self.device)

            self._gp_state = WarmStart(
                hypers=GPHypers(leaf(saved[0]), leaf(saved[1]), leaf(saved[2]))
            )
        else:
            self._gp_state = None
        tr = state.get("tr")
        if tr is not None:
            self._tr_length, self._tr_succ, self._tr_fail = tr[0], int(tr[1]), int(tr[2])
        center = state.get("tr_center")
        self._tr_center = int(center) if center is not None else None


@algo_registry.register("turbo")
class TuRBO(TPUBO):
    """Trust-region GP-BO: :class:`TPUBO` with the trust region on by
    default and a 90/10 local/global candidate split."""

    def __init__(self, space, seed=None, **kwargs):
        kwargs.setdefault("trust_region", True)
        kwargs.setdefault("local_frac", 0.9)
        kwargs.setdefault("y_transform", "copula")
        super().__init__(space, seed=seed, **kwargs)

