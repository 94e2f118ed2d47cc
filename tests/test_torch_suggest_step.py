"""The port's whole suggest round against ``orion_tpu.algo.tpu_bo._suggest_step``
on replayed draws (``torch_parity.jax_suggest_draws``).

Setup, fixed in advance: n_pad 64 (40 observed), 512 candidates, q 16, 10
fit steps, trust region, RFF-Thompson, copula targets, seeds 0, 1 and 2 at
d=6, and one d=24 case whose trust box uses the perturbation mask.

Pass: the returned rows equal to 1e-5 (a float32 candidate computed by two
libraries; the selection must agree exactly), the health vector within
rtol 1e-3 (fitted hyperparameters after 10 adam steps, as in
``test_torch_gp``).

At d=24 the whole round does not meet the row tolerance, and the reason is
the 10-step float32 fit, not the round: the MLL gradient there carries
~3e-3 relative float32 noise in BOTH packages (measured against a float64
evaluation below; its source is the ``aa + bb - 2ab`` diagonal, which two
BLAS libraries round differently), so the fitted log-lengthscales differ
(at seed 1 by more than the fit tolerance of 1e-3), and the trust box, whose
sides follow them, moves its candidates by more than the row tolerance.  The d=24 case therefore holds the round to the stated
tolerances downstream of one shared fit (both packages start from the
reference's fitted hyperparameters with ``fit_steps=0``), for seeds 0, 1
and 2.  Two more tests show that the fit divergence is float32 noise: at
seed 0 the fits agree to the fit tolerance and the gradients differ by no
more than each differs from float64; at seeds 0, 1 and 2 the same 10 adam
steps through each package's own ``_neg_mll`` in float64 agree to 1e-9.

The port's own sampler, ``sample_suggest_draws``, is held to the replayed
draws in distribution: the same fields, shapes and dtypes, and the same
first two moments, at the main path's sizes.
"""

import math


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from orion_tpu.algo import tpu_bo as jbo
from orion_tpu.algo.gp.gp import GPHypers as JaxGPHypers
from orion_tpu.algo.gp.gp import _neg_mll as jax_neg_mll
from orion_tpu.algo.gp.gp import _normalize_y as jax_normalize_y
from orion_tpu.algo.gp.gp import fit_gp as jax_fit_gp
from orion_tpu.algo.gp.gp import init_hypers as jax_init_hypers
from orion_tpu.algo.sampling import masked_copula_transform as jax_copula
from orion_tpu_torch.algo import tpu_bo as tbo
from orion_tpu_torch.algo.gp import gp as tgp
from orion_tpu_torch.algo.gp.gp import GPHypers, fit_gp
from orion_tpu_torch.algo.gp.gp import _neg_mll as neg_mll

from torch_parity import jax_suggest_draws, padded_history, to_torch

STEP = dict(q=16, n_candidates=512, kernel="matern52", acq="thompson", fit_steps=10,
            local_frac=0.3, local_sigma=0.1, beta=2.0, trust_region=True,
            tr_perturb_dims=20, y_transform="copula")


def run_both(seed, d, tr_length=0.8, n=40, n_pad=64, warm=None, **overrides):
    """One round through both packages on the same buffers and draws,
    warm-started from ``warm`` (reference hypers; default the cold init)."""
    kw = dict(STEP, **overrides)
    x, y, mask = padded_history(seed, n, n_pad, d)
    best_x = x[int(np.argmin(np.where(mask > 0, y, np.inf)))]
    key = jax.random.PRNGKey(seed)
    warm = jax_init_hypers(d) if warm is None else warm
    rows_j, state_j = jbo._suggest_step(
        key, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jnp.asarray(best_x),
        warm, jnp.asarray(tr_length, jnp.float32), **kw,
    )
    d_free = d - kw.get("fixed_tail_cols", 0)
    draws = jax_suggest_draws(
        key, q=kw["q"], n_candidates=kw["n_candidates"], d_free=d_free, d=d, acq=kw["acq"],
        local_frac=kw["local_frac"], trust_region=kw["trust_region"],
        tr_perturb_dims=kw["tr_perturb_dims"],
    )
    rows_t, state_t = tbo._suggest_step(
        draws, to_torch(x), to_torch(y), to_torch(mask), to_torch(best_x),
        GPHypers(*(to_torch(np.asarray(h)) for h in warm)), torch.tensor(tr_length), **kw,
    )
    return (np.asarray(rows_j), np.asarray(state_j.health)), (
        rows_t.numpy(), state_t.health.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_suggest_step_matches_reference(seed):
    (rows_j, health_j), (rows_t, health_t) = run_both(seed, 6)
    assert rows_t.shape == rows_j.shape == (16, 6)
    np.testing.assert_allclose(rows_t, rows_j, atol=1e-5)
    np.testing.assert_allclose(health_t, health_j, rtol=1e-3)


@pytest.mark.parametrize(
    "overrides",
    [
        dict(trust_region=False, acq="ei"),
        dict(acq="ucb", fixed_tail_cols=1),
        dict(acq="marginal_thompson", kernel="rbf", y_transform="none"),
        dict(acq="joint_thompson", n_candidates=128),
    ],
    ids=["global-ei", "ucb-fixed-tail", "marginal-rbf-raw", "joint"],
)
def test_suggest_step_branches_match_reference(overrides):
    """The step's other branches (no trust region, EI/UCB/marginal/joint
    acquisitions, a pinned context column, RBF, raw targets), seed 0,
    d=6, same tolerances."""
    (rows_j, health_j), (rows_t, health_t) = run_both(0, 6, **overrides)
    assert rows_t.shape == rows_j.shape
    np.testing.assert_allclose(rows_t, rows_j, atol=1e-5)
    np.testing.assert_allclose(health_t, health_j, rtol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_suggest_step_perturb_mask_d24_matches_reference(seed):
    """d=24 > tr_perturb_dims: the perturbation-mask box, downstream of one
    shared fit (see the module docstring)."""
    x, y, mask = padded_history(seed, 40, 64, 24)
    fitted = jax_fit_gp(x, y, mask, n_steps=STEP["fit_steps"], y_transform="copula").hypers
    (rows_j, health_j), (rows_t, health_t) = run_both(seed, 24, warm=fitted, fit_steps=0)
    assert rows_t.shape == rows_j.shape == (16, 24)
    np.testing.assert_allclose(rows_t, rows_j, atol=1e-5)
    np.testing.assert_allclose(health_t, health_j, rtol=1e-3)


def test_d24_fit_divergence_is_float32_noise():
    """The 10-step d=24 fits agree to the fit tolerance (rtol 1e-3), and at
    the start of the fit the two packages' MLL gradients differ by no more
    than each differs from a float64 evaluation of the same formula."""
    x, y, mask = padded_history(0, 40, 64, 24)
    want = jax_fit_gp(x, y, mask, n_steps=10, y_transform="copula")
    got = fit_gp(to_torch(x), to_torch(y), to_torch(mask), n_steps=10, y_transform="copula")
    for g_t, g_j in zip(got.hypers, want.hypers):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-3)

    y_norm = np.asarray(jax_normalize_y(jax_copula(jnp.asarray(y), jnp.asarray(mask)),
                                        jnp.asarray(mask))[0])
    hypers = jax_init_hypers(24)
    grads_j = jax.grad(jax_neg_mll)(hypers, "matern52", x, y_norm, mask)

    def torch_grads(dtype):
        leaves = [to_torch(np.asarray(h), dtype).requires_grad_(True) for h in hypers]
        loss = neg_mll(GPHypers(*leaves), "matern52", to_torch(x, dtype),
                       to_torch(y_norm, dtype), to_torch(mask, dtype))
        return [g.detach().numpy() for g in torch.autograd.grad(loss, leaves)]

    for g_t, g_j, g_64 in zip(torch_grads(torch.float32), grads_j, torch_grads(torch.float64)):
        g_j = np.asarray(g_j)
        scale = np.abs(g_64).max()
        noise = max(np.abs(g_t - g_64).max(), np.abs(g_j - g_64).max())
        assert np.abs(g_t - g_j).max() <= 2.0 * noise
        assert noise <= 1e-2 * scale


def _copula_y_norm(y, mask):
    """The fit's targets: copula-transformed and normalized, as float32."""
    return np.asarray(jax_normalize_y(jax_copula(jnp.asarray(y), jnp.asarray(mask)),
                                      jnp.asarray(mask))[0])


def _jax_fit_float64(x, y_norm, mask, n_steps=10, lr=0.08):
    """``orion_tpu``'s fit loop (optax adam, NaN scrub, clip ranges of
    ``fit_gp``) around its own ``_neg_mll``, in float64."""
    with jax.enable_x64(True):
        x, y_norm, mask = (jnp.asarray(a, jnp.float64) for a in (x, y_norm, mask))
        hypers = JaxGPHypers(*(jnp.asarray(np.asarray(h), jnp.float64)
                               for h in jax_init_hypers(x.shape[1])))
        optimizer = optax.adam(lr)
        opt_state = optimizer.init(hypers)
        for _ in range(n_steps):
            grads = jax.grad(jax_neg_mll)(hypers, "matern52", x, y_norm, mask)
            updates, opt_state = optimizer.update(jax.tree.map(jnp.nan_to_num, grads),
                                                  opt_state)
            hypers = optax.apply_updates(hypers, updates)
            hypers = JaxGPHypers(
                jnp.clip(hypers.log_lengthscales, math.log(1e-3), math.log(1e2)),
                jnp.clip(hypers.log_amplitude, math.log(0.05), math.log(5.0)),
                jnp.clip(hypers.log_noise, math.log(1e-4), math.log(1.0)),
            )
        return [np.asarray(h) for h in hypers]


def _torch_fit_float64(x, y_norm, mask, n_steps=10, lr=0.08):
    """The port's fit loop (its ``Adam``, NaN scrub and clip ranges, as in
    its ``fit_gp``) around its own ``_neg_mll``, in float64."""
    x, y_norm, mask = (to_torch(a, torch.float64) for a in (x, y_norm, mask))
    params = [to_torch(np.asarray(h), torch.float64) for h in jax_init_hypers(x.shape[1])]
    opt = tgp.Adam(params, lr)
    ranges = (tgp._LOG_LS_RANGE, tgp._LOG_AMP_RANGE, tgp._LOG_NOISE_RANGE)
    for _ in range(n_steps):
        leaves = [p.detach().requires_grad_(True) for p in params]
        grads = torch.autograd.grad(neg_mll(GPHypers(*leaves), "matern52", x, y_norm, mask),
                                    leaves)
        params = opt.step(params, [torch.nan_to_num(g) for g in grads])
        params = [torch.clamp(p, lo, hi) for p, (lo, hi) in zip(params, ranges)]
    return [p.numpy() for p in params]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_d24_fit_float64_witness(seed):
    """Float64 witness for the d=24 fit divergence: the same 10 adam steps
    through each package's own ``_neg_mll`` agree to 1e-9 in float64, so
    the two packages compute the same fit, and each package's float32 fit
    lies within 1e-2 of that float64 fit (the float32 rounding of one
    trajectory; at seed 1 the two float32 fits differ by more than the
    fit tolerance of rtol 1e-3)."""
    x, y, mask = padded_history(seed, 40, 64, 24)
    y_norm = _copula_y_norm(y, mask)
    fit_j = _jax_fit_float64(x, y_norm, mask)
    fit_t = _torch_fit_float64(x, y_norm, mask)
    f32_j = jax_fit_gp(x, y, mask, n_steps=10, y_transform="copula").hypers
    f32_t = fit_gp(to_torch(x), to_torch(y), to_torch(mask), n_steps=10,
                   y_transform="copula").hypers
    for h_t, h_j, h32_t, h32_j in zip(fit_t, fit_j, f32_t, f32_j):
        np.testing.assert_allclose(h_t, h_j, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(h32_t.numpy(), h_j, atol=1e-2)
        np.testing.assert_allclose(np.asarray(h32_j), h_j, atol=1e-2)


def _assert_same_distribution(got, want, name):
    """Two samples of one draw: the same first two moments, each within 5
    standard errors (from the samples' own second and fourth moments)."""
    a = got.double().numpy().ravel()
    b = want.double().numpy().ravel()
    moments = []
    for s in (a, b):
        mean = s.mean()
        var = s.var()
        moments.append((s.size, mean, var, ((s - mean) ** 4).mean()))
    (n_a, mean_a, var_a, m4_a), (n_b, mean_b, var_b, m4_b) = moments
    se_mean = math.sqrt(var_a / n_a + var_b / n_b)
    se_var = math.sqrt((m4_a - var_a**2) / n_a + (m4_b - var_b**2) / n_b)
    assert abs(mean_a - mean_b) <= 5.0 * se_mean, (name, mean_a, mean_b, se_mean)
    assert abs(var_a - var_b) <= 5.0 * se_var, (name, var_a, var_b, se_var)


@pytest.mark.parametrize(
    "d, acq, trust_region, q",
    [(6, "thompson", True, 1024), (24, "thompson", True, 1024),
     (6, "marginal_thompson", False, 64)],
    ids=["main-path", "perturb-d24", "global-marginal"],
)
def test_sampled_draws_match_replayed_draws_in_distribution(d, acq, trust_region, q):
    """``sample_suggest_draws`` (the normal path) against the reference's
    draws (``jax_suggest_draws``) at the main path's pool: 16384 candidates,
    local_frac 0.3, q 1024, 512 features.  Same fields, shapes and dtype
    kinds (the port's ``forced_dim`` is int64, JAX's int32), and the same
    mean and variance per field."""
    kw = dict(q=q, n_candidates=16384, d_free=d, d=d, acq=acq, local_frac=0.3,
              trust_region=trust_region, tr_perturb_dims=STEP["tr_perturb_dims"])
    got = tbo.sample_suggest_draws(torch.Generator().manual_seed(0), device="cpu", **kw)
    want = jax_suggest_draws(jax.random.PRNGKey(0), **kw)

    def leaves(draws):
        out = {}
        for field, value in draws._asdict().items():
            if isinstance(value, tuple):
                out.update({f"acq.{k}": v for k, v in value._asdict().items()})
            elif value is not None:
                out[field] = value
        return out

    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys()
    for name in got:
        g, w = got[name], want[name]
        assert g.shape == w.shape, name
        assert (g.is_floating_point(), g.dtype == torch.bool) == (
            w.is_floating_point(), w.dtype == torch.bool), name
        if g.is_floating_point():
            assert g.dtype == w.dtype == torch.float32, name
        _assert_same_distribution(g, w, name)


def test_dedup_fill_matches_reference():
    """First-occurrence dedup with EI backfill on heavy duplication."""
    rng = np.random.default_rng(3)
    jax_dedup = jax.jit(jbo._dedup_fill_device, static_argnums=2)
    for q in (8, 16, 64):
        idx = rng.integers(0, q // 2, size=(q,))
        ei_rank = rng.permutation(4 * q)
        want = jax_dedup(jnp.asarray(idx), jnp.asarray(ei_rank), q)
        got = tbo._dedup_fill_device(torch.from_numpy(idx), torch.from_numpy(ei_rank), q)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tr_bookkeeping_is_shared_code():
    args = dict(chunk=8, succ_tol=3, fail_tol=4, length_init=0.8, length_min=0.5**7,
                length_max=1.6, improve_tol=1e-3)
    y = np.random.default_rng(4).normal(size=(40,))
    assert tbo.tr_update_batch(0.8, 0, 0, 0.0, y, **args) == jbo.tr_update_batch(
        0.8, 0, 0, 0.0, y, **args)
    np.testing.assert_array_equal(tbo.copula_transform(y), jbo.copula_transform(y))
