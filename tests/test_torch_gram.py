"""The port's fused gram (``orion_tpu_torch.ops.gram``) against the Pallas
kernel it replaces and the reference's plain kernel matrix.

On the CPU the wrapper runs its plain PyTorch version, so these tests hold
that version to ``orion_tpu``'s ``fused_gram`` (Pallas interpret mode, as
``tests/unit/test_ops.py`` runs it) and ``kernel_matrix``.  The CUDA kernel
itself is held to the same plain version on the card by ``chip_smoke.py``
and by ``test_torch_cuda.py``; here the host-side launch plan that picks
its path is checked at every shape the card runs.

Tolerance: atol 1e-5, the reference's own kernel-vs-XLA tolerance — both
sides are float32 with the same expansion; only summation order differs.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import CASES
from orion_tpu.algo.gp.kernels import kernel_matrix as jax_kernel_matrix
from orion_tpu.ops.gram import fused_gram as jax_fused_gram
from orion_tpu_torch.algo.gp import kernels
from orion_tpu_torch.ops import gram
from orion_tpu_torch.ops.gram import SMEM_BUDGET, _launch_plan, fused_gram, fused_gram_reference

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


def _float64_gram(kind, xa, xb, ils, amp):
    """The kernel matrix in float64 from the differences themselves (no
    ``aa + bb - 2ab`` cancellation): a witness that neither package's
    float32 arithmetic, nor any process-wide precision switch, can move."""
    a = xa.astype(np.float64) * ils.astype(np.float64)
    b = xb.astype(np.float64) * ils.astype(np.float64)
    r2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    if kind == "rbf":
        return float(amp) * np.exp(-0.5 * r2)
    s5 = np.sqrt(5.0 * r2)
    return float(amp) * (1.0 + s5 + (5.0 / 3.0) * r2) * np.exp(-s5)


@pytest.mark.parametrize("kind", ["matern52", "rbf"])
@pytest.mark.parametrize("m,n,d", SHAPES)
def test_fused_gram_matches_pallas_and_xla(kind, m, n, d):
    """The port against the Pallas kernel and the XLA path, and each of the
    three against the float64 witness first, so that a failure names the
    side that moved."""
    xa, xb, ils, amp = _inputs(m, n, d)
    got = fused_gram(torch.from_numpy(xa), torch.from_numpy(xb), torch.from_numpy(ils),
                     torch.tensor(amp), kind=kind).numpy()
    pallas = jax_fused_gram(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(ils),
                            jnp.asarray(amp), kind=kind, interpret=True)
    xla = jax_kernel_matrix(kind, jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(ils),
                            jnp.asarray(amp))
    witness = _float64_gram(kind, xa, xb, ils, amp)
    for name, value in (("port", got), ("pallas", pallas), ("xla", xla)):
        np.testing.assert_allclose(np.asarray(value, np.float64), witness, atol=1e-5,
                                   err_msg=f"{name} against the float64 witness")
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


def test_fused_gram_on_the_cpu_counts_no_launch():
    before = fused_gram.launches
    fused_gram(torch.rand(8, 3), torch.rand(5, 3), torch.ones(3), torch.tensor(1.0))
    assert fused_gram.launches == before


# The card's shapes (chip_smoke.CASES, the main path's first) and the card
# tests' edge shapes.
PLAN_SHAPES = sorted(set(CASES) | {(16384, 257, 6), (1, 1, 1), (64, 4, 6), (100000, 256, 6),
                                   (4096, 256, 8), (8192, 512, 50), (513, 129, 130)})


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("m,n,d", PLAN_SHAPES)
def test_launch_plan_stays_in_budget(m, n, d, aligned):
    plan = _launch_plan(m, n, d, aligned)
    assert 0 < plan.smem_bytes <= SMEM_BUDGET
    assert plan.vec == (n % 4 == 0 and aligned)
    if plan.resident:
        # Scaled b with rows padded to whole tiles plus 4, its norms, and two a
        # tiles for each of the block's 4 groups.
        ldb = -(-n // 256) * 256 + 4
        assert (plan.tile_rows, plan.tile_cols) == (16, 256)
        assert plan.smem_bytes == 4 * (d * ldb + ldb + 4 * 2 * d * 16)
    else:
        # A 16-feature chunk of a 64-row a tile and a 64-column b tile, rows padded by 4.
        assert (plan.tile_rows, plan.tile_cols) == (64, 64)
        assert plan.smem_bytes == 4 * 2 * 16 * (64 + 4)


def test_launch_plan_reaches_every_path():
    """The card's shapes cover resident/chunked x float4/scalar."""
    paths = {(p.resident, p.vec) for p in (_launch_plan(*s, True) for s in CASES)}
    assert paths == {(True, True), (True, False), (False, True), (False, False)}


@pytest.mark.parametrize("m,n,d,resident,vec", [
    (16384, 256, 6, True, True),  # the main path: b is 6 KB
    (16384, 1024, 6, True, True),  # b 24 KB, still resident
    (16384, 257, 6, True, False),  # n odd: scalar stores
    (64, 4, 6, True, True),  # a single tile
    (1, 1, 1, True, False),
    (8192, 512, 50, False, True),  # b 100 KB: chunked
    (513, 129, 130, False, False),  # d = 130: b 67 KB
    (300, 70, 6, True, False),
])
def test_launch_plan_paths(m, n, d, resident, vec):
    plan = _launch_plan(m, n, d, True)
    assert (plan.resident, plan.vec) == (resident, vec)


@pytest.mark.parametrize("n,d_max", [(4, 31), (256, 31), (1024, 9), (2048, 4)])
def test_launch_plan_edges_of_the_resident_rule(n, d_max):
    """Resident exactly while 4 (d ldb + ldb + 128 d) bytes fit 48 KB, with
    ldb = n rounded up to 256, plus 4."""
    assert _launch_plan(100, n, d_max, True).resident
    assert not _launch_plan(100, n, d_max + 1, True).resident


def test_launch_plan_constants_match_the_kernel_source():
    """The Python plan mirrors the layout constants of ``csrc/gram.cu``
    (which refuses any other plan at launch)."""
    path = os.path.join(os.path.dirname(gram.__file__), "csrc", "gram.cu")
    with open(path) as handle:
        source = handle.read()
    const = {name: int(eval(expr, {}, {}))  # plain integer products only
             for name, expr in re.findall(r"constexpr int (k\w+) = ([\d\s*]+);", source)}
    tiles = {name: int(threads) for name, threads in
             re.findall(r"using (\w+) = Tile<(\d+)>;", source)}
    threads, micro = const["kThreads"], const["kMicroRows"]
    for name, tile in (("Wide", gram._RESIDENT_TILE), ("Square", gram._CHUNKED_TILE)):
        assert (threads // tiles[name] * micro, 4 * tiles[name]) == tile
    assert const["kGroups"] == gram._GROUPS
    assert const["kChunk"] == gram._CHUNK
    assert const["kRowPad"] == gram._ROW_PAD
    assert const["kSmemBudget"] == SMEM_BUDGET
