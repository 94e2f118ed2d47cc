"""The port's sharded rounds: a mesh-built algorithm against the unsharded
one, bit for bit, and the 8-slot round against the reference's 8-device
mesh round.

Setup, as the reference's ``tests/unit/test_sharded_parity.py``: 4
uniform dimensions (plus a fidelity for ``asha_bo``/``bohb``), 20
observations from seed 3, the reference's ``GP_CFG`` (8 random points, a
512-candidate pool, 8 fit steps), logical CPU slots.  512 divides by 8, so
``tpe``'s rounding of the pool to a multiple of the slots leaves it as it
is; one ``tpe`` case takes a pool of 500, rounded up to the reference's
504.

Pass: for 1 and 8 slots, the suggested rows, every GP-state leaf and
every health field equal to the unsharded round's, bitwise (the sharded
round scores the same pool in chunks and selects by the same indices);
against ``orion_tpu``'s ``_suggest_step`` with ``get_mesh(8)`` on replayed
draws, rows to 1e-5 and health to rtol 1e-3 (the tolerance of
``test_torch_suggest_step.py``: the reference's own 8-device round differs
from its unsharded one by an ulp, so the port is held to its own unsharded
round bitwise and to the reference at the packages' tolerance).
"""

import copy
import queue
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from orion_tpu.algo import tpu_bo as jbo
from orion_tpu.algo.gp.gp import init_hypers as jax_init_hypers
from orion_tpu.algo.sharding import get_mesh as jax_get_mesh
from orion_tpu_torch.algo import sharding
from orion_tpu_torch.algo import tpu_bo as tbo
from orion_tpu_torch.algo.base import create_algo
from orion_tpu_torch.algo.gp import gp as tgp
from orion_tpu_torch.algo.gp import kernels
from orion_tpu_torch.algo.gp.gp import GPHypers
from orion_tpu_torch.serve import coalesce
from orion_tpu_torch.serve.gateway import GatewayServer
from orion_tpu_torch.space.dsl import build_space

from torch_parity import jax_suggest_draws, padded_history, to_torch

GP_CFG = {"n_init": 8, "n_candidates": 512, "fit_steps": 8}
ALGOS = [
    ("tpu_bo", GP_CFG, False),
    ("turbo", GP_CFG, False),
    ("asha_bo", dict(GP_CFG, trust_region=True), True),
    ("bohb", {"n_candidates": 512, "min_points": 8}, True),
    ("tpe", {"n_candidates": 512, "n_init": 8}, False),
]
ACQS = ["ei", "ucb", "marginal_thompson", "joint_thompson"]


def _space(fidelity, d=4):
    priors = {f"x{i}": "uniform(0, 1)" for i in range(d)}
    if fidelity:
        priors["budget"] = "fidelity(1, 16, 4)"
    return build_space(priors)


def _observed(name, cfg, fidelity, seed=3, n_obs=20, **mesh_kw):
    space = _space(fidelity)
    rows = np.random.default_rng(0).uniform(size=(n_obs, 4))
    params = [{f"x{i}": float(v) for i, v in enumerate(r)} for r in rows]
    if fidelity:
        for p in params:
            p["budget"] = 1
    objs = [{"objective": float(v)} for v in np.random.default_rng(seed).normal(size=n_obs)]
    algo = create_algo(space, {name: dict(cfg, **mesh_kw)}, seed=seed, device="cpu")
    algo.observe(params, objs)
    return algo


def _bits(tree):
    """Every tensor leaf as its raw bits (NaN-safe equality)."""
    out = []
    for leaf in pytree.tree_leaves(tree):
        if torch.is_tensor(leaf):
            out.append(leaf.view(torch.int32) if leaf.dtype == torch.float32 else leaf)
    return out


def _assert_bitwise(a, b):
    la, lb = _bits(a), _bits(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _health_equal(got, want):
    for key, value in want.items():
        other = got[key]
        if isinstance(value, (dict, list, tuple)):
            assert other == value, key
        else:
            assert np.array_equal(np.asarray(other), np.asarray(value)), key


@pytest.mark.parametrize("n_slots", [1, 8])
@pytest.mark.parametrize("name,cfg,fidelity", ALGOS, ids=[a[0] for a in ALGOS])
def test_mesh_round_is_bitwise_the_unsharded_round(name, cfg, fidelity, n_slots):
    meshed = _observed(name, cfg, fidelity, use_mesh=True, n_devices=n_slots)
    plain = _observed(name, cfg, fidelity)
    assert meshed.suggest(8) == plain.suggest(8)
    if hasattr(plain, "_gp_state"):
        assert plain._gp_state is not None
        _assert_bitwise(meshed._gp_state, plain._gp_state)
    health_m, health_p = meshed.health_record(), plain.health_record() or {}
    _health_equal(health_m, health_p)
    assert health_m["mesh_devices"] == n_slots
    if name in ("tpu_bo", "turbo", "asha_bo"):
        assert health_m["mesh_util_min_frac"] == health_m["mesh_util_max_frac"] == 1 / n_slots


@pytest.mark.parametrize("acq", ACQS)
def test_every_acquisition_shards_bitwise(acq):
    """The other acquisitions' cross-shard reductions (marginal Thompson's
    per-row argmax, EI/UCB's top-q over the gathered scores; the joint
    Thompson draw stays on the lead slot) at 8 uneven-free slots and at 3,
    whose chunks differ by a row."""
    cfg = dict(GP_CFG, acq=acq)
    plain = _observed("tpu_bo", cfg, False)
    want = plain._suggest_cube(8)
    for n_slots in (8, 3):
        meshed = _observed("tpu_bo", cfg, False, use_mesh=True, n_devices=n_slots)
        assert torch.equal(meshed._suggest_cube(8), want)
        _assert_bitwise(meshed._gp_state, plain._gp_state)


def test_tpe_pool_is_rounded_up_to_the_reference_size():
    n_slots, pool = 8, 500
    rounded = -(-pool // n_slots) * n_slots  # orion_tpu/algo/tpe.py:157-161
    assert rounded == 504
    cfg = {"n_candidates": pool, "n_init": 8}
    meshed = _observed("tpe", cfg, False, use_mesh=True, n_devices=n_slots)
    plain = _observed("tpe", dict(cfg, n_candidates=rounded), False)
    assert meshed.suggest(8) == plain.suggest(8)
    assert meshed.health_record() == {"mesh_devices": n_slots}


@pytest.mark.parametrize("seed", [0, 1])
def test_eight_slot_round_matches_the_reference_mesh_round(seed):
    step = dict(q=16, n_candidates=512, kernel="matern52", acq="thompson", fit_steps=10,
                local_frac=0.3, local_sigma=0.1, beta=2.0, trust_region=True,
                tr_perturb_dims=20, y_transform="copula")
    x, y, mask = padded_history(seed, 40, 64, 6)
    best_x = x[int(np.argmin(np.where(mask > 0, y, np.inf)))]
    key = jax.random.PRNGKey(seed)
    warm = jax_init_hypers(6)
    rows_j, state_j = jbo._suggest_step(
        key, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jnp.asarray(best_x), warm,
        jnp.asarray(0.8, jnp.float32), mesh=jax_get_mesh(8), **step)
    draws = jax_suggest_draws(key, q=16, n_candidates=512, d_free=6, d=6, acq="thompson",
                              local_frac=0.3, trust_region=True)
    args = (draws, to_torch(x), to_torch(y), to_torch(mask), to_torch(best_x),
            GPHypers(*(to_torch(np.asarray(h)) for h in warm)), torch.tensor(0.8))
    rows_t, state_t = tbo._suggest_step(*args, mesh=sharding.get_mesh(8, device="cpu"),
                                        **step)
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), atol=1e-5)
    np.testing.assert_allclose(state_t.health.numpy(), np.asarray(state_j.health), rtol=1e-3)
    rows_u, state_u = tbo._suggest_step(*args, **step)
    assert torch.equal(rows_t, rows_u)
    _assert_bitwise(state_t, state_u)


def test_fused_gram_is_routed_on_the_whole_pool():
    """At 8 slots a 32768-row pool's chunks (4096 x 64 x 6) are under the
    fused threshold (8e6); the chunks still take the fused route, one call
    a slot, as the whole pool does, and the posterior is the whole pool's
    bitwise."""
    calls = []
    real = kernels.fused_gram

    def counted(xa, *args, **kwargs):
        calls.append(tuple(xa.shape))
        return real(xa, *args, **kwargs)

    x, y, mask = padded_history(0, 40, 64, 6)
    state = tgp.fit_gp(to_torch(x), to_torch(y), to_torch(mask), n_steps=2)
    pool = torch.from_numpy(np.random.default_rng(1).uniform(size=(32768, 6)).astype(np.float32))
    mesh = sharding.get_mesh(8, device="cpu")
    assert 4096 * 64 * 6 < kernels._FUSED_MIN_WORK <= 32768 * 64 * 6
    kernels.fused_gram = counted
    try:
        whole = tgp.posterior_norm(state, pool)
        assert calls == [(32768, 6)]
        del calls[:]
        sharded = tgp.posterior_norm(state, sharding.shard_candidates(pool, mesh))
        assert calls == [(4096, 6)] * 8
        del calls[:]
        tgp.posterior_norm(state, pool[:4096])
        assert calls == []  # a pool of one chunk's size alone stays off the kernel
    finally:
        kernels.fused_gram = real
    for a, b in zip(sharded, whole):
        assert torch.equal(a, b)


def _tenants(n_tenants, n_slots, seed0=0):
    space = _space(False)
    algos = []
    rng = np.random.default_rng(5)
    for lane in range(n_tenants):
        algo = create_algo(space, {"tpu_bo": dict(GP_CFG, use_mesh=True, n_devices=n_slots)},
                           seed=seed0 + lane, device="cpu")
        rows = np.random.default_rng(lane).uniform(size=(16, 4))
        algo.observe([{f"x{i}": float(v) for i, v in enumerate(r)} for r in rows],
                     [{"objective": float(v)} for v in rng.normal(size=16)])
        algos.append(algo)
    return algos


def test_coalesced_tenant_parallel_dispatch_is_each_standalone_round():
    algos = _tenants(8, 4)
    twins = [copy.deepcopy(a) for a in algos]
    want = [tbo.run_fused_plan(a.fused_step_plan(4)) for a in twins]
    coalesce.LAST_STACK_PLACEMENT.clear()
    got = coalesce.run_coalesced_plans([a.fused_step_plan(4) for a in algos])
    assert coalesce.LAST_STACK_PLACEMENT == {
        "devices": 4, "width": 8, "tenant_parallel": True,
        "util_min_frac": 0.25, "util_max_frac": 0.25}
    for (rows, state), (rows_w, state_w) in zip(got, want):
        assert rows.shape == (4, 4)
        assert torch.equal(rows, rows_w)
        _assert_bitwise(state, state_w)
    # The gateway publishes the dispatch's placement beside the tenant's own.
    algos[0].consume_fused_step(got[0][1])
    fake = types.SimpleNamespace(_queue=queue.Queue(), _tenants={})
    health = GatewayServer._health_fields(fake, types.SimpleNamespace(exec_algo=algos[0],
                                                                      width=8))
    assert (health["serve_mesh_devices"], health["serve_mesh_util_min_frac"],
            health["serve_mesh_util_max_frac"]) == (4, 0.25, 0.25)
    assert health["mesh_devices"] == 4 and health["serve_width"] == 8


def test_a_narrow_stack_keeps_each_plans_candidate_mesh():
    algos = _tenants(2, 4, seed0=10)
    twins = [copy.deepcopy(a) for a in algos]
    want = [tbo.run_fused_plan(a.fused_step_plan(4)) for a in twins]
    got = coalesce.run_coalesced_plans([a.fused_step_plan(4) for a in algos])
    assert coalesce.LAST_STACK_PLACEMENT["tenant_parallel"] is False
    assert "util_max_frac" not in coalesce.LAST_STACK_PLACEMENT
    for (rows, state), (rows_w, state_w) in zip(got, want):
        assert torch.equal(rows, rows_w)
        _assert_bitwise(state, state_w)


def test_mesh_signature_carries_the_fingerprint_and_prewarm_captures_it():
    """The mesh's string joins the plan signature (an unsharded plan's
    statics have no ``mesh``), and the prewarmer's signature for the next
    bucket is the one the sharded round then asks for."""
    meshed = _observed("tpu_bo", GP_CFG, False, use_mesh=True, n_devices=4)
    plain = _observed("tpu_bo", GP_CFG, False)
    plan_m, plan_p = meshed.fused_step_plan(8), plain.fused_step_plan(8)
    assert dict(plan_m.signature[1])["mesh"] == "4×candidates@cpu"
    assert "mesh" not in dict(plan_p.signature[1])
    assert {k: v for k, v in plan_m.signature[1] if k != "mesh"} == dict(plan_p.signature[1])
    statics = tbo.plan_statics(8, True, **{k: v for k, v in meshed._step_kw().items()
                                           if k != "tr_length"})
    assert tbo.plan_signature(plan_m.arrays[1].shape, statics) == plan_m.signature
