"""The port's GP core (kernels, MLL, fit, posterior) against
``orion_tpu.algo.gp`` on the same numpy inputs.

Tolerances: kernel values atol 1e-5 (float32, same expansion; the
``aa + bb - 2ab`` cancellation scales ulp-level differences of the norms by
their magnitude, as in the reference's own kernel tests); the MLL and its
gradient rtol 1e-4 (a Cholesky of a 64x64 float32 matrix in two LAPACK call
paths); fitted hyperparameters after 10 adam steps
rtol 1e-3 (per-step rounding compounds through the optimizer); posterior
atol 1e-4 (triangular solve of a fitted factor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.algo.gp import gp as jgp
from orion_tpu.algo.gp import kernels as jkernels
from orion_tpu_torch.algo.gp import gp as tgp
from orion_tpu_torch.algo.gp import kernels as tkernels
from orion_tpu_torch.convert import gp_state_from_numpy

from torch_parity import padded_history, to_torch


def _jax_hypers(d):
    return jgp.init_hypers(d)


def _torch_hypers_from(hypers):
    return tgp.GPHypers(*(to_torch(np.asarray(h)) for h in hypers))


@pytest.mark.parametrize("kind", ["matern52", "rbf"])
def test_kernel_matrix_matches(kind):
    rng = np.random.default_rng(0)
    xa = rng.uniform(size=(40, 5)).astype(np.float32)
    xb = rng.uniform(size=(30, 5)).astype(np.float32)
    ils = rng.uniform(0.5, 3.0, size=(5,)).astype(np.float32)
    want = jkernels.kernel_matrix(kind, xa, xb, ils, jnp.float32(1.3))
    got = tkernels.kernel_matrix(kind, to_torch(xa), to_torch(xb), to_torch(ils),
                                 torch.tensor(1.3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        tkernels.sq_dists(to_torch(xa), to_torch(xb), to_torch(ils)).numpy(),
        np.asarray(jkernels.sq_dists(xa, xb, ils)), atol=1e-5,
    )


def test_matern_gradient_finite_at_zero_distance():
    """The double-where guard: d k(x, x) / d lengthscale is finite on the
    diagonal and equals jax.grad's (rtol 1e-5)."""
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(6, 3)).astype(np.float32)
    log_ls = np.log(np.full((3,), 0.4, np.float32))

    def jax_f(v):
        return jnp.sum(jkernels.matern52(x, x, jnp.exp(-v), 1.0))

    want = jax.jit(jax.grad(jax_f))(log_ls)
    leaf = to_torch(log_ls).requires_grad_(True)
    torch.sum(tkernels.matern52(to_torch(x), to_torch(x), torch.exp(-leaf), 1.0)).backward()
    assert torch.isfinite(leaf.grad).all()
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("kind", ["matern52", "rbf"])
def test_neg_mll_value_and_grad(kind):
    x, y, mask = padded_history(2, 40, 64, 4)
    y_norm, _, _ = jgp._normalize_y(jnp.asarray(y), jnp.asarray(mask))
    hypers = jgp.GPHypers(jnp.log(jnp.asarray([0.3, 0.5, 0.2, 0.7], jnp.float32)),
                          jnp.asarray(0.1, jnp.float32), jnp.asarray(-5.0, jnp.float32))
    val, grads = jax.jit(jax.value_and_grad(jgp._neg_mll), static_argnums=1)(
        hypers, kind, x, y_norm, mask)
    leaves = [to_torch(np.asarray(h)).requires_grad_(True) for h in hypers]
    got = tgp._neg_mll(tgp.GPHypers(*leaves), kind, to_torch(x), to_torch(np.asarray(y_norm)),
                       to_torch(mask))
    got_grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(val), rtol=1e-4)
    for g_t, g_j in zip(got_grads, grads):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n_pad,n", [(64, 40), (256, 130)])
@pytest.mark.parametrize("y_transform", ["none", "copula"])
def test_fit_gp_matches(n_pad, n, y_transform):
    x, y, mask = padded_history(3, n, n_pad, 6)
    want = jgp.fit_gp(x, y, mask, kind="matern52", n_steps=10, y_transform=y_transform)
    got = tgp.fit_gp(to_torch(x), to_torch(y), to_torch(mask), kind="matern52", n_steps=10,
                     y_transform=y_transform)
    for g_t, g_j in zip(got.hypers, want.hypers):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-3)
    np.testing.assert_allclose(float(got.mll), float(want.mll), rtol=1e-3)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), atol=1e-5)


def test_posterior_norm_matches():
    x, y, mask = padded_history(4, 40, 64, 6)
    state_j = jgp.fit_gp(x, y, mask, kind="matern52", n_steps=10, y_transform="copula")
    state_t = gp_state_from_numpy(state_j, device="cpu")
    xq = np.random.default_rng(5).uniform(size=(300, 6)).astype(np.float32)
    mean_j, std_j = jgp.posterior_norm(state_j, xq)
    mean_t, std_t = tgp.posterior_norm(state_t, to_torch(xq))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=1e-4)
    np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), atol=1e-4)
    mean_j, std_j = jgp.posterior(state_j, xq)
    mean_t, std_t = tgp.posterior(state_t, to_torch(xq))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=1e-4)
    np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), atol=1e-4)


def test_failed_cholesky_is_nan_then_scrubbed():
    """A non-PD kernel: both Cholesky factors are NaN on the lower triangle
    (``cholesky_ex`` alone would give a finite wrong factor), both losses
    NaN, and after ``nan_to_num`` both gradients are exactly 0 — the
    reference's NaN-then-scrub behaviour, which keeps a fit alive through a
    bad step."""
    bad = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
    np.testing.assert_array_equal(tgp.cholesky(to_torch(bad)).numpy(),
                                  np.asarray(jnp.linalg.cholesky(bad)))

    # Duplicate rows minus 3*I: the masked kernel turns indefinite.
    x = np.tile(np.random.default_rng(6).uniform(size=(1, 3)).astype(np.float32), (8, 1))
    mask = np.ones((8,), np.float32)
    hypers = jgp.GPHypers(jnp.zeros((3,), jnp.float32), jnp.asarray(0.0, jnp.float32),
                          jnp.asarray(0.0, jnp.float32))

    def jax_loss(h):
        k = jgp._masked_kernel("matern52", x, mask, h) - 3.0 * jnp.eye(8)
        return jnp.sum(jnp.log(jnp.diagonal(jnp.linalg.cholesky(k))))

    def torch_loss(h):
        k = tgp._masked_kernel("matern52", to_torch(x), to_torch(mask), h) - 3.0 * torch.eye(8)
        return torch.sum(torch.log(torch.diagonal(tgp.cholesky(k))))

    val_j, grads_j = jax.jit(jax.value_and_grad(jax_loss))(hypers)
    leaves = [to_torch(np.asarray(h)).requires_grad_(True) for h in hypers]
    val_t = torch_loss(tgp.GPHypers(*leaves))
    grads_t = torch.autograd.grad(val_t, leaves)
    assert np.isnan(float(val_j)) and torch.isnan(val_t.detach())
    for g_t, g_j in zip(grads_t, grads_j):
        np.testing.assert_array_equal(torch.nan_to_num(g_t).numpy(),
                                      np.nan_to_num(np.asarray(g_j)))
        np.testing.assert_array_equal(torch.nan_to_num(g_t).numpy(), 0.0)
    # A fit on the duplicate rows (K singular up to the noise) stays finite.
    y = np.linspace(-1.0, 1.0, 8).astype(np.float32)
    got = tgp.fit_gp(to_torch(x), to_torch(y), to_torch(mask), n_steps=5)
    assert all(torch.isfinite(h).all() for h in got.hypers)
