"""The port's fused gram (``orion_tpu_torch.ops.gram``) against the Pallas
kernel it replaces and the reference's plain kernel matrix.

On the CPU the wrapper runs its plain PyTorch version, so these tests hold
that version to ``orion_tpu``'s ``fused_gram`` (Pallas interpret mode, as
``tests/unit/test_ops.py`` runs it) and ``kernel_matrix``.  The CUDA kernel
itself is held to the same plain version on the card by ``chip_smoke.py``
and by ``test_torch_cuda.py``.

Tolerance: atol 1e-5, the reference's own kernel-vs-XLA tolerance — both
sides are float32 with the same expansion; only summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.algo.gp.kernels import kernel_matrix as jax_kernel_matrix
from orion_tpu.ops.gram import fused_gram as jax_fused_gram
from orion_tpu_torch.algo.gp import kernels
from orion_tpu_torch.ops.gram import fused_gram, fused_gram_reference

SHAPES = [
    (300, 70, 6),  # ragged on every axis
    (256, 256, 4),  # exact tiles
    (513, 129, 130),  # just past tile boundaries, feature axis included
    (2048, 256, 6),  # the main path's n and d
]


def _inputs(m, n, d, seed=0):
    rng = np.random.default_rng(seed)
    xa = rng.uniform(size=(m, d)).astype(np.float32)
    xb = rng.uniform(size=(n, d)).astype(np.float32)
    ils = rng.uniform(0.5, 3.0, size=(d,)).astype(np.float32)
    return xa, xb, ils, np.float32(1.7)


@pytest.mark.parametrize("kind", ["matern52", "rbf"])
@pytest.mark.parametrize("m,n,d", SHAPES)
def test_fused_gram_matches_pallas_and_xla(kind, m, n, d):
    xa, xb, ils, amp = _inputs(m, n, d)
    got = fused_gram(torch.from_numpy(xa), torch.from_numpy(xb), torch.from_numpy(ils),
                     torch.tensor(amp), kind=kind).numpy()
    pallas = jax_fused_gram(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(ils),
                            jnp.asarray(amp), kind=kind, interpret=True)
    xla = jax_kernel_matrix(kind, jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(ils),
                            jnp.asarray(amp))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-5)


def test_fused_gram_diagonal_is_amplitude():
    """k(x, x) equals the amplitude: the cancellation the full-precision
    cross term exists to prevent (atol 1e-4, as the reference's test)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(size=(64, 8)).astype(np.float32))
    ils = torch.from_numpy(rng.uniform(0.5, 3.0, size=(8,)).astype(np.float32))
    g = fused_gram(x, x, ils, torch.tensor(2.5), kind="matern52")
    np.testing.assert_allclose(torch.diagonal(g).numpy(), 2.5, atol=1e-4)


def test_fused_gram_is_forward_only():
    x = torch.rand(8, 3)
    with pytest.raises(ValueError, match="forward-only"):
        fused_gram(x.requires_grad_(True), x, torch.ones(3), torch.tensor(1.0))


def test_cross_kernel_matrix_routes_by_work(monkeypatch):
    """``m*n*max(d,1) >= 8e6`` goes to fused_gram, anything smaller to the
    differentiable kernel_matrix: the reference's dispatch rule."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return fused_gram_reference(*args, **kwargs)

    monkeypatch.setattr(kernels, "fused_gram", spy)
    ils, amp = torch.ones(6), torch.tensor(1.0)
    small = torch.rand(64, 6)
    obs = torch.rand(256, 6)
    out = kernels.cross_kernel_matrix("matern52", small, obs, ils, amp)
    assert calls == []
    np.testing.assert_array_equal(
        out.numpy(), kernels.kernel_matrix("matern52", small, obs, ils, amp).numpy()
    )
    below = torch.rand(5208, 6)  # 5208 * 256 * 6 = 7,999,488 < 8e6
    kernels.cross_kernel_matrix("matern52", below, obs, ils, amp)
    assert calls == []
    at = torch.rand(5209, 6)  # 8,001,024 >= 8e6
    kernels.cross_kernel_matrix("matern52", at, obs, ils, amp)
    assert calls == [(5209, 6)]
