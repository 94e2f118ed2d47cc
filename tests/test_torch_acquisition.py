"""The port's acquisitions and copula transform against
``orion_tpu.algo.gp.acquisition`` / ``orion_tpu.algo.sampling``.

Tolerances: EI/UCB atol 1e-6 (elementwise float32 formulas); index results
exactly equal (ties resolved to the lowest index on both sides); the copula
transform atol 1e-6 (float32 ``ndtri`` of identical ranks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.algo import sampling as jsampling
from orion_tpu.algo.gp import acquisition as jacq
from orion_tpu.algo.gp import gp as jgp
from orion_tpu_torch.algo import sampling as tsampling
from orion_tpu_torch.algo.gp import acquisition as tacq
from orion_tpu_torch.convert import gp_state_from_numpy

from torch_parity import jax_rff_draws, padded_history, to_torch


def _pool(seed, m=400):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(m,)).astype(np.float32)
    std = rng.uniform(0.05, 1.0, size=(m,)).astype(np.float32)
    return mean, std


def test_ei_and_ucb_match():
    mean, std = _pool(0)
    best = np.float32(-1.2)
    np.testing.assert_allclose(
        tacq.expected_improvement(to_torch(mean), to_torch(std), torch.tensor(best)).numpy(),
        np.asarray(jacq.expected_improvement(mean, std, best)), atol=1e-6,
    )
    np.testing.assert_allclose(
        tacq.upper_confidence_bound(to_torch(mean), to_torch(std), beta=2.0).numpy(),
        np.asarray(jacq.upper_confidence_bound(mean, std, beta=2.0)), atol=1e-6,
    )


def test_select_q_breaks_ties_like_top_k():
    """EI underflows to exactly 0 over much of a pool: the top-k must pick
    the lowest indices among equal scores, as ``lax.top_k`` does."""
    rng = np.random.default_rng(1)
    scores = np.zeros((512,), np.float32)
    scores[rng.choice(512, size=20, replace=False)] = rng.uniform(size=20)
    scores[[3, 9, 40]] = 0.5  # ties above zero too
    want = np.asarray(jacq.select_q(jnp.asarray(scores), 64))
    got = tacq.select_q(to_torch(scores), 64).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["matern52", "rbf"])
def test_rff_thompson_on_injected_draws(kind):
    x, y, mask = padded_history(2, 40, 64, 6)
    state_j = jgp.fit_gp(x, y, mask, kind=kind, n_steps=10, y_transform="copula")
    state_t = gp_state_from_numpy(state_j, device="cpu")
    cands = np.random.default_rng(3).uniform(size=(512, 6)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jax.jit(jacq.rff_thompson, static_argnames=("q", "kind"))(
        key, state_j, cands, q=16, kind=kind)
    draws = jax_rff_draws(key, 512, 6, 16)
    got = tacq.rff_thompson(draws, state_t, to_torch(cands), 16, kind=kind)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_acquire_ei_ucb_and_marginal_thompson():
    x, y, mask = padded_history(5, 40, 64, 4)
    state_j = jgp.fit_gp(x, y, mask, n_steps=10)
    state_t = gp_state_from_numpy(state_j, device="cpu")
    cands = np.random.default_rng(6).uniform(size=(256, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jax_acquire = jax.jit(jacq.acquire, static_argnames=("q", "kind", "acq"))
    for acq in ("ei", "ucb"):
        want = jax_acquire(key, state_j, cands, q=8, acq=acq)
        got = tacq.acquire(None, state_t, to_torch(cands), 8, acq=acq)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax_acquire(key, state_j, cands, q=8, acq="marginal_thompson")
    eps = to_torch(jax.random.normal(key, (8, 256)))
    got = tacq.acquire(eps, state_t, to_torch(cands), 8, acq="marginal_thompson")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.jit(jacq.joint_thompson, static_argnames=("q",))(key, state_j, cands[:64], q=8)
    eps = to_torch(jax.random.normal(key, (8, 64)))
    got = tacq.joint_thompson(eps, state_t, to_torch(cands[:64]), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masked_copula_transform_ties_and_padding():
    y = np.array([0.5, -1.0, 0.5, 2.0, -1.0, 0.5, 3.0, 0.0, 9.0, 9.0], np.float32)
    mask = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    want = np.asarray(jsampling.masked_copula_transform(jnp.asarray(y), jnp.asarray(mask)))
    got = tsampling.masked_copula_transform(to_torch(y), to_torch(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got[8:] == 0.0).all()


def test_reflect_unit_matches():
    x = np.random.default_rng(8).normal(scale=3.0, size=(1000,)).astype(np.float32)
    np.testing.assert_array_equal(
        tsampling.reflect_unit(to_torch(x)).numpy(), np.asarray(jsampling.reflect_unit(x))
    )
