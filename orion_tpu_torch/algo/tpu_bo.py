"""Batched GP-BO on the card (port of ``orion_tpu/algo/tpu_bo.py``).

One suggest round is :func:`_suggest_step`: a warm-started GP refit with the
copula y-transform, trust-region candidate generation with gradient polish,
RFF-Thompson acquisition, an EI ranking of the whole pool (where the
candidate cross-gram runs in the hand-written ``fused_gram`` kernel),
on-device dedup with EI backfill, and the gather of the q rows plus a packed
health vector.  Everything stays on the algorithm's device; the only host
copies are the (q, d) rows and, when asked for, the health vector.

The reference compiles the round into one jitted function with threefry
keys.  Here the round is a function of its random draws
(:class:`SuggestDraws`): :func:`sample_suggest_draws` draws them from the
instance's model stream (``BaseAlgorithm.model_generator``, apart from the
random rounds' stream, as the reference folds a purpose into each key), and
the parity tests replay the reference's key schedule through ``jax.random``
and pass the same numbers to both.

Every GP round of ``tpu_bo``, ``turbo`` and ``asha_bo`` goes through ONE
dispatch path: :func:`make_fused_plan` folds the round's dynamics (warm
against cold fit steps, the pow-2 q bucket) into a :class:`FusedPlan`, and
:func:`run_fused_plan` runs it through
:data:`~orion_tpu_torch.algo.step_graphs.STEP_GRAPHS`, the counterpart of
the reference's jit cache: on CUDA the round is captured once per plan
signature as a CUDA graph and replayed after that.  With telemetry on, a
replay books one ``suggest_step.dispatch`` span (``{"q", "n"}`` args: the
host's cost of issuing the round), a miss a ``suggest_step.capture`` span,
the ``cuda_graph.recaptures`` counter and the compiler plane's attributed
recapture (:mod:`orion_tpu_torch.compiler_plane`).

Each stage of a round runs inside a ``torch.profiler.record_function`` span
named ``suggest.<stage>`` (draws, fit_gp, candidates, polish, acquire,
ei_rank, select).  A replayed graph runs no Python, so only an eager round
(a signature's first, or :func:`_suggest_step` called directly) shows them.

The bucket prewarmer (``prewarm``, ``prewarm_fill``;
:func:`maybe_prewarm_fused_step`) captures the next pow-2 history bucket's
signature on a background thread before the history gets there.

:func:`make_fused_plan` caches the signature-invariant part of a plan per
(shape bucket, statics, device); the serve gateway (``orion_tpu_torch.serve``)
builds its tenants' plans through the same function and dispatches
same-signature plans together.

``use_mesh=True`` shards the round's candidate pool over a mesh of device
slots (:mod:`orion_tpu_torch.algo.sharding`; ``mesh`` in the plan's statics
and signature): the fit, pool generation and selection stay on the
algorithm's device, each slot scores its chunk, and the rows are bitwise
the unsharded round's.  A mesh of logical slots on one card is captured
like any round; a mesh over distinct cards or processes runs eagerly
(:mod:`orion_tpu_torch.algo.step_graphs`).
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
from orion_tpu_torch.algo.prewarm import (
    DEFAULT_PREWARM_FILL,
    BucketPrewarmer,
    plan_fused_step_bucket,
)
from orion_tpu_torch.algo.sampling import clamp_objectives, reflect_unit
from orion_tpu_torch.algo.sharding import Placement, mesh_health_fields, shard_candidates
from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS
from orion_tpu_torch.compiler_plane import (
    COMPILE_REGISTRY,
    fields_from_plan_signature,
    signature_fields,
)
from orion_tpu_torch.parallel import device_mesh
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
                  fixed_tail_cols=0, mesh=None):
    """The whole GP-BO suggest round, on the device of ``x``: returns the
    (q, d_free) rows and the fitted GPState with its health vector.

    ``y`` arrives raw; ``y_transform="copula"`` rank-Gaussianizes it inside
    the fit.  ``fixed_tail_cols``: the last k input columns are context,
    pinned to 1.0 when scoring; candidates and returned rows cover the
    leading columns only.  No host sync happens in here.

    ``mesh`` (:mod:`~orion_tpu_torch.algo.sharding`): the fit, the pool and
    the polish run on the device of ``x`` as without it; the pool is then
    split over the mesh's slots for the acquisition scores and the
    posterior (``fused_gram`` launched once a slot), and only reductions
    come back, so selection, dedup and the gather see what the unsharded
    round sees.  ``joint_thompson`` (an (m, m) Cholesky of the whole pool)
    stays on the device of ``x``."""
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
    # The pool the scores run over: contiguous chunks on the mesh's slots.
    pool = candidates if mesh is None else shard_candidates(candidates, mesh)
    with record_function("suggest.acquire"):
        if acq == "joint_thompson":
            idx = joint_thompson(draws.acq, state, candidates, q, kind=kernel)
        else:
            idx = acquire(draws.acq, state, pool, q, kind=kernel, acq=acq, best=best,
                          beta=beta)
    with record_function("suggest.ei_rank"):
        mean, std = posterior_norm(state, pool, kind=kernel)
        ei = expected_improvement(mean, std, best)
        ei_rank = select_q(ei, min(4 * q, n_candidates))
    with record_function("suggest.select"):
        if trust_region:
            # One pure-exploitation member per batch: the pool's posterior-mean
            # minimizer, unless it is already observed (then re-suggesting it
            # would loop on duplicate trials).
            exploit_idx = torch.argmin(mean)
            # index_select, not free_candidates[exploit_idx]: indexing by a
            # 0-d tensor reads it to the host, a sync no capture allows.
            exploit_cand = torch.index_select(free_candidates, 0, exploit_idx[None])[0]
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


class FusedPlan(NamedTuple):
    """One prepared (not yet run) suggest round.

    ``arrays`` holds :func:`_suggest_step`'s tensor inputs in call order
    (draws, x, y, mask, best_x, warm hypers, tr_length); ``statics`` its
    keyword arguments, with warm against cold fit steps and the pow-2 q
    bucket folded in.  ``signature`` (the fit buffer's shape and every
    static, stringified) keys the captured graph: two plans with equal
    signatures replay the same graph."""

    signature: tuple
    arrays: tuple
    statics: dict
    num: int


def plan_statics(num_or_q, warm, *, n_candidates, kernel, acq, fit_steps,
                 refit_steps=None, local_frac, local_sigma, beta, trust_region=False,
                 tr_perturb_dims=20, y_transform="none", fixed_tail_cols=0, mesh=None):
    """The static keyword arguments of a round for ``num_or_q`` rows: the
    q bucket, and ``refit_steps`` in place of ``fit_steps`` on a warm refit
    when it is set.  :func:`make_fused_plan` and the prewarmer build their
    signatures from this one function.  A ``mesh`` joins the statics (its
    string, the fingerprint and slot layout, joins the signature); an
    unsharded round's statics have no ``mesh`` key."""
    steps = refit_steps if warm and refit_steps is not None else fit_steps
    statics = dict(
        q=_next_pow2(num_or_q, floor=8), n_candidates=n_candidates, kernel=kernel,
        acq=acq, fit_steps=steps, local_frac=local_frac, local_sigma=local_sigma,
        beta=beta, trust_region=trust_region, tr_perturb_dims=tr_perturb_dims,
        y_transform=y_transform, fixed_tail_cols=fixed_tail_cols,
    )
    if mesh is not None:
        statics["mesh"] = mesh
    return statics


def plan_signature(shape, statics):
    """``(tuple(shape), sorted (key, str(value)) statics)``: the reference's
    format, so ``compiler_plane.fields_from_plan_signature`` reads it."""
    return (tuple(shape), tuple(sorted((k, str(v)) for k, v in statics.items())))


class _PlanPrep(NamedTuple):
    """The signature-invariant part of a :class:`FusedPlan`, cached per
    distinct (shape bucket, statics, device) so a steady round skips
    rebuilding it: the statics dict, the stringified signature, the cold
    start's hypers and the default tr_length, both already on the device.
    (The reference's ``split_fit``/``host_fit_steps`` move the fit out of
    its sharded jit; the port's sharded round fits on the lead slot inside
    the same function, so it needs neither.)"""

    statics: dict
    signature: tuple
    cold_hypers: object
    default_tr: object


_PLAN_PREP_CACHE = {}
_PLAN_PREP_STATS = {"hits": 0, "misses": 0, "hit_ns": 0, "miss_ns": 0}


def plan_prep_stats():
    """The prep cache's effect: mean prep cost on a miss and on a hit (the
    whole of :func:`make_fused_plan`, the round's draws included), and the
    microseconds the cache saved overall."""
    stats = _PLAN_PREP_STATS
    hits, misses = stats["hits"], stats["misses"]
    hit_us = stats["hit_ns"] / 1e3 / hits if hits else 0.0
    miss_us = stats["miss_ns"] / 1e3 / misses if misses else 0.0
    return {
        "hits": hits,
        "misses": misses,
        "hit_us_mean": hit_us,
        "miss_us_mean": miss_us,
        "saved_us": hits * max(0.0, miss_us - hit_us),
    }


def reset_plan_prep_stats():
    _PLAN_PREP_STATS.update(hits=0, misses=0, hit_ns=0, miss_ns=0)


def make_fused_plan(generator, x, y, mask, best_x, warm_state, num, *, tr_length=None,
                    **step_kw):
    """This round as a :class:`FusedPlan`: its draws from ``generator`` (the
    model stream), the warm hypers (or the cold start), tr_length as a
    device scalar, and the statics of :func:`plan_statics`.  ``step_kw`` is
    the algorithm's ``_step_kw()`` without ``tr_length``.

    The signature-invariant leaves are cached per :class:`_PlanPrep` key,
    which folds in everything they depend on (``warm_state is None``
    included), so a hit cannot change the plan.  Re-passing the cached
    tensors round after round is safe: the step graphs copy a round's
    inputs into their own static buffers, and :func:`_suggest_step` writes
    none of its inputs.  The standalone round (:func:`run_fused_plan`) and
    the gateway's coalesced dispatch (``serve.coalesce``) both take plans
    built here."""
    t0 = time.perf_counter_ns()
    warm_is_none = warm_state is None
    prep_key = (tuple(x.shape), _next_pow2(num, floor=8), warm_is_none, x.device,
                tuple(sorted(step_kw.items())))
    prep = _PLAN_PREP_CACHE.get(prep_key)
    hit = prep is not None
    if not hit:
        statics = plan_statics(num, not warm_is_none, **step_kw)
        prep = _PlanPrep(
            statics,
            plan_signature(x.shape, statics),
            init_hypers(x.shape[1], device=x.device) if warm_is_none else None,
            torch.full((), 1.0, dtype=torch.float32, device=x.device),
        )
        _PLAN_PREP_CACHE[prep_key] = prep
    statics = prep.statics
    width = x.shape[1]
    with record_function("suggest.draws"):
        draws = sample_suggest_draws(
            generator, q=statics["q"], n_candidates=statics["n_candidates"],
            d_free=width - statics["fixed_tail_cols"], d=width, acq=statics["acq"],
            local_frac=statics["local_frac"], trust_region=statics["trust_region"],
            tr_perturb_dims=statics["tr_perturb_dims"], device=x.device,
        )
    hypers = prep.cold_hypers if warm_is_none else warm_state.hypers
    if tr_length is None:
        tr = prep.default_tr
    else:
        # torch.full, not torch.tensor: a fill on the device, no host copy.
        tr = torch.full((), float(tr_length), dtype=torch.float32, device=x.device)
    arrays = (draws, x, y, mask, best_x, hypers, tr)
    plan = FusedPlan(prep.signature, arrays, statics, int(num))
    count, ns = ("hits", "hit_ns") if hit else ("misses", "miss_ns")
    _PLAN_PREP_STATS[count] += 1
    _PLAN_PREP_STATS[ns] += time.perf_counter_ns() - t0
    return plan


def flop_analysis_fn(arrays, statics):
    """Zero-argument FLOP count of one eager round at this plan's shapes,
    for :meth:`CompileRegistry.analyze_all`.  Keeps shapes only, never the
    arrays (an analysis entry must not pin device buffers)."""
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten(arrays)
    specs = [(t.shape, t.dtype, t.device) if torch.is_tensor(t) else t for t in leaves]
    statics = dict(statics)

    def analyze():
        from torch.utils.flop_counter import FlopCounterMode

        dummies = [torch.zeros(s[0], dtype=s[1], device=s[2]) if isinstance(s, tuple) else s
                   for s in specs]
        # lint: disable=PERF003 -- this closure runs only inside
        # CompileRegistry.analyze_all (the profile command, tests), never on
        # a round: the compiler plane's cold path, handed its shapes here.
        counter = FlopCounterMode(display=False)
        with counter:
            _suggest_step(*pytree.tree_unflatten(dummies, spec), **statics)
        return {"flops": float(counter.get_total_flops())}

    return analyze


def _entry_stats(entry):
    """What the compiler plane keeps of a captured entry."""
    if entry.graph is None:
        return {}
    return {
        "instantiate_ms": entry.instantiate_ms,
        "graph_nodes": entry.graph_nodes,
        "pool_bytes": entry.pool_bytes,
        "hbm_bytes": entry.pool_bytes + entry.static_bytes,
    }


def run_fused_plan(plan):
    """Run ONE :class:`FusedPlan` through the step graphs, with the
    reference's telemetry bracket: a ``suggest_step.dispatch`` span on a
    replay; on a miss (this signature had no entry yet) a
    ``suggest_step.capture`` span, the ``cuda_graph.recaptures`` counter
    and the compiler plane's attributed recapture.  Returns
    ``(rows[:num], state)``."""
    num = plan.num
    t0 = time.perf_counter() if TELEMETRY.enabled else None
    (rows, state), entry, missed = STEP_GRAPHS.run(
        _suggest_step, plan.signature, plan.arrays, plan.statics)
    if t0 is not None:
        TELEMETRY.record_span(
            "suggest_step.capture" if missed else "suggest_step.dispatch",
            start=t0,
            args={"q": int(num), "n": int(plan.arrays[1].shape[0])},
        )
        if missed:
            TELEMETRY.count("cuda_graph.recaptures")
            COMPILE_REGISTRY.record_retrace(
                "fused_plan",
                fields_from_plan_signature(plan.signature),
                seconds=time.perf_counter() - t0,
                analysis_fn=flop_analysis_fn(plan.arrays, plan.statics),
                stats=_entry_stats(entry),
            )
    # Dedup puts the unique draws first, so the first `num` rows are the
    # ones an un-padded round would have returned.
    return rows[:num], state


# --- the bucket prewarmer's hooks ---------------------------------------------


def maybe_prewarm_fused_step(algo, batch=0):
    """Observe-side prewarm trigger shared by ``tpu_bo`` and ``asha_bo``:
    when the history nears the next pow-2 bucket, capture that bucket's
    round on the prewarmer's thread, so the crossing replays a graph
    instead of paying a synchronous capture.  Needs one prior suggest to
    know the q bucket.

    Past ``tr_local_m`` the trust region's local GP pins the fit shape:
    nothing is left to warm (the reference also warms its on-device subset
    gather there, a jitted function of its own; the port's gather is
    eager)."""
    if not algo.prewarm or algo._last_q_bucket is None:
        return
    count = algo._host.count
    if count < algo.n_init:
        return
    target_m = plan_fused_step_bucket(
        count, floor=algo._hist.floor, fill=algo.prewarm_fill, batch=batch,
        trust_region=algo.trust_region, tr_local_m=algo.tr_local_m,
    )
    if target_m is not None:
        start_bucket_prewarm(
            algo._prewarmer, target_m, algo._hist.n_cols, algo._last_q_bucket,
            algo._step_kw(), warm_refit=algo._gp_state is not None, device=algo.device,
        )


def start_bucket_prewarm(prewarmer, target_m, width, q_bucket, step_kw, *, device,
                         warm_refit=False):
    """Hand the prewarmer a capture of the round at the ``(target_m,
    width)`` bucket with the EXACT statics a real round there will have
    (:func:`plan_statics`; ``warm_refit`` bakes in ``refit_steps``), keyed
    by them, so each signature is captured at most once per prewarmer."""
    kw = dict(step_kw)
    kw.pop("tr_length", None)
    statics = plan_statics(q_bucket, warm_refit, **kw)
    signature = plan_signature((target_m, width), statics)

    def capture_and_record():
        t0 = time.perf_counter()
        entry = prewarm_suggest_step(target_m, width, statics, signature, device=device)
        if TELEMETRY.enabled:
            COMPILE_REGISTRY.record_prewarm(
                "fused_plan", signature_fields((target_m, width), statics),
                seconds=time.perf_counter() - t0,
                stats=_entry_stats(entry) if entry is not None else None,
            )

    return prewarmer.maybe_start(signature, capture_and_record)


def prewarm_suggest_step(m, width, statics, signature, *, device):
    """Capture the round for an ``(m, width)`` fit buffer from dummies:
    zeros for the history (every row masked out), the cold hypers and
    draws of a throwaway generator (with a mesh in ``statics``, the sharded
    round).  Deliberately not through
    :func:`run_fused_plan`: a prewarm never books a
    ``cuda_graph.recaptures`` sample (that counter reports the synchronous
    captures a suggest paid).  Returns the new entry, or None when the
    signature was already captured."""
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(0)
    draws = sample_suggest_draws(
        generator, q=statics["q"], n_candidates=statics["n_candidates"],
        d_free=width - statics["fixed_tail_cols"], d=width, acq=statics["acq"],
        local_frac=statics["local_frac"], trust_region=statics["trust_region"],
        tr_perturb_dims=statics["tr_perturb_dims"], device=device,
    )
    zeros = torch.zeros((m, width), dtype=torch.float32, device=device)
    arrays = (
        draws, zeros, zeros[:, 0].clone(), zeros[:, 0].clone(),
        torch.zeros((width - statics["fixed_tail_cols"],), dtype=torch.float32, device=device),
        init_hypers(width, device=device),
        torch.full((), 1.0, dtype=torch.float32, device=device),
    )
    return STEP_GRAPHS.prewarm(_suggest_step, signature, arrays, statics)


def mesh_record(mesh):
    """A mesh round's health fields: the slot count, and the byte placement
    of the newest pool :func:`shard_candidates` laid on the mesh (recorded
    when a round runs eagerly or is captured; a replay lays it out the
    same way)."""
    placed = mesh.last_placement
    return mesh_health_fields(mesh, *(() if placed is None else (Placement(placed),)))


@algo_registry.register("tpu_bo")
class TPUBO(BaseAlgorithm):
    """Batched GP-BO on the card; the constructor takes the reference's
    keyword arguments (see ``orion_tpu.algo.tpu_bo.TPUBO``) plus ``device``
    (None means ``cuda``; raises where no card is present).

    ``prewarm`` captures the next pow-2 history bucket's round on a
    background thread before the history crosses into it, once the current
    bucket is ``prewarm_fill`` full (or one more batch of the size just
    observed would cross it).  ``use_mesh`` shards each round's candidate
    pool over ``n_devices`` slots of ``device``
    (:func:`~orion_tpu_torch.algo.sharding.get_mesh`: distinct cards for
    ``cuda``, logical slots for ``cuda:k`` or ``cpu``)."""

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
        prewarm_fill=DEFAULT_PREWARM_FILL,
        n_devices=None,
        use_mesh=False,
        device=None,
    ):
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
        self.prewarm = bool(prewarm)
        self.prewarm_fill = float(prewarm_fill)
        self.use_mesh = use_mesh
        self._mesh = device_mesh(n_devices, device=self.device) if use_mesh else None
        d = space.n_cols
        self._host = HostHistory(d)
        self._hist = DeviceHistory(d, device=self.device)
        self._gp_state = None
        # Captures the next bucket's round before the history gets there;
        # the q bucket of the last GP round says which round to capture.
        self._prewarmer = BucketPrewarmer()
        self._last_q_bucket = None
        self._tr_length = tr_length_init
        self._tr_succ = 0
        self._tr_fail = 0
        # Fresh-restart override: row index the trust box centers on after a
        # collapse with no progress (None = the global incumbent).
        self._tr_center = None

    # The fitted GP state is immutable-by-rebinding; `_hist` and `_host`
    # implement copy-on-write in their own __deepcopy__.  The prewarmer's
    # threads and lock cannot be copied, and the graphs it captures are
    # process-wide: one warm covers every clone.  The mesh is a cached
    # singleton: a clone's rounds must name the same object.
    _share_by_ref = ("space", "_mesh", "_gp_state", "_prewarmer")

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
        self._maybe_prewarm(batch=y32.shape[0])
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
        kw = dict(
            n_candidates=self.n_candidates,
            kernel=self.kernel,
            acq=self.acq,
            fit_steps=self.fit_steps,
            refit_steps=self.refit_steps,
            local_frac=self.local_frac,
            local_sigma=self.local_sigma,
            beta=self.beta,
            trust_region=self.trust_region,
            tr_length=self._tr_length,
            tr_perturb_dims=self.tr_perturb_dims,
            y_transform=self.y_transform,
        )
        if self._mesh is not None:
            kw["mesh"] = self._mesh
        return kw

    def _maybe_prewarm(self, batch=0):
        maybe_prewarm_fused_step(self, batch=batch)

    def fused_step_plan(self, num):
        """This round's :class:`FusedPlan`, or None while the random-init
        phase runs.  Consuming: it draws from the model stream and stamps
        the q bucket as a suggest does, so a caller holding a plan must run
        it (:func:`run_fused_plan`) and hand the state back through
        :meth:`consume_fused_step`, as ``_suggest_cube`` does."""
        n = self._host.count
        if n < self.n_init:
            return None
        self._last_q_bucket = _next_pow2(num, floor=8)
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
        step_kw = self._step_kw()
        tr_length = step_kw.pop("tr_length")
        return make_fused_plan(
            self.model_generator, x_dev, y_dev, mask_dev, best_x, self._gp_state, num,
            tr_length=tr_length, **step_kw,
        )

    def consume_fused_step(self, state):
        """Take the GPState a plan's round produced: the next round's warm
        start and the packed health."""
        self._gp_state = state

    def _suggest_cube(self, num):
        plan = self.fused_step_plan(num)
        if plan is None:
            return torch.rand((num, self.space.n_cols), generator=self._generator,
                              device=self.device)
        rows, state = run_fused_plan(plan)
        self.consume_fused_step(state)
        return rows

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
        if self._mesh is not None:
            record.update(mesh_record(self._mesh))
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

