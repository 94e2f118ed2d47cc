"""The port's coalescer (``orion_tpu_torch.serve.coalesce``) against its own
standalone round and against ``orion_tpu.serve.coalesce``.

Setup, fixed in advance as in ``test_torch_suggest_step.py``: n_pad 64 (40
observed), 512 candidates, q 16, 10 fit steps, trust region, RFF-Thompson,
copula targets, d=6; three plans.

- Coalesced and standalone are the same round: each lane's rows and every
  GPState leaf are bit for bit equal to that plan run alone
  (``run_fused_plan``), for ``tpu_bo`` and ``asha_bo``, over two rounds
  (the second warm-started from the first's state).
- The port matches the reference: for seeds 0-2, the same three lanes
  through the reference's ``run_coalesced_plans`` and through the port's,
  fed the reference's draws (``torch_parity.jax_suggest_draws``), agree on
  rows to 1e-5 and on the health vector to rtol 1e-3 (the suggest-step
  test's tolerances).
- A coalesced dispatch adds no step-graph signature to the standalone one.
- A plan-prep cache hit builds the plan a miss builds.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from orion_tpu.algo import tpu_bo as jbo
from orion_tpu.algo.gp.gp import init_hypers as jax_init_hypers
from orion_tpu.serve import coalesce as jco
from orion_tpu_torch.algo import tpu_bo as tbo
from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS
from orion_tpu_torch.algo.base import create_algo
from orion_tpu_torch.algo.gp.gp import GPHypers
from orion_tpu_torch.serve import coalesce as tco
from orion_tpu_torch.space.dsl import build_space

from torch_parity import jax_suggest_draws, padded_history, to_torch

STEP = dict(q=16, n_candidates=512, kernel="matern52", acq="thompson", fit_steps=10,
            local_frac=0.3, local_sigma=0.1, beta=2.0, trust_region=True,
            tr_perturb_dims=20, y_transform="copula")
D = 6
PRIORS = {f"x{i}": "uniform(0, 1)" for i in range(D)}
TPU_BO = {"tpu_bo": {"n_init": 8, "n_candidates": 512, "fit_steps": 10, "local_frac": 0.3,
                     "trust_region": True, "acq": "thompson", "y_transform": "copula",
                     "prewarm": False}}
ASHA_PRIORS = {**{f"x{i}": "uniform(0, 1)" for i in range(D)}, "epochs": "fidelity(1, 9, 3)"}
ASHA_BO = {"asha_bo": {"n_init": 8, "n_candidates": 512, "fit_steps": 10, "local_frac": 0.3,
                       "trust_region": True, "acq": "thompson", "y_transform": "copula",
                       "prewarm": False}}


def _bits(t):
    """A tensor's bits (a float's NaN compares equal to the same NaN)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _leaves_equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        else:
            assert x == y


def _tpu_bo(seed):
    algo = create_algo(build_space(PRIORS), TPU_BO, seed=seed, device="cpu")
    x, y, mask = padded_history(seed, 40, 64, D)
    algo.observe_arrays(x[:40], y[:40].astype(np.float64))
    return algo


def _asha_bo(seed):
    algo = create_algo(build_space(ASHA_PRIORS), ASHA_BO, seed=seed, device="cpu")
    # One objective sequence for every seed: the same rung promotions and
    # local-radius ladder, so the tenants' plans share a signature.
    rng = np.random.default_rng(0)
    while algo._host.count < 40:
        params = algo.suggest(8)
        algo.observe(params, [{"objective": float(v)} for v in rng.uniform(size=len(params))])
    return algo


@pytest.mark.parametrize("make", [_tpu_bo, _asha_bo], ids=["tpu_bo", "asha_bo"])
def test_coalesced_round_is_the_standalone_round(make):
    """Three tenants, two rounds: rows and every GPState leaf bit for bit
    equal to each plan run alone."""
    alone = [make(seed) for seed in (0, 1, 2)]
    twins = [copy.deepcopy(algo) for algo in alone]
    for _ in range(2):
        plans = [algo.fused_step_plan(16) for algo in twins]
        assert all(plan is not None for plan in plans)
        assert plans[0].arrays[1].shape == (64, D + (make is _asha_bo))
        results = tco.run_coalesced_plans(plans)
        for algo, twin, (rows, state) in zip(alone, twins, results):
            plan = algo.fused_step_plan(16)
            ref_rows, ref_state = tbo.run_fused_plan(plan)
            assert torch.equal(rows, ref_rows)
            _leaves_equal(state, ref_state)
            algo.consume_fused_step(ref_state)
            twin.consume_fused_step(state)
            if make is _asha_bo:
                assert twin.finish_fused_rows(rows) == algo.finish_fused_rows(ref_rows)


def test_coalesced_dispatch_adds_no_signature():
    """Three tenants' dispatch books the one standalone signature their
    plans share, and nothing else (on the CPU an entry marks a signature as
    seen, as a capture does on the card)."""
    STEP_GRAPHS.reset()
    plans = [_tpu_bo(seed).fused_step_plan(16) for seed in (0, 1, 2)]
    tco.run_coalesced_plans(plans)
    assert [sig for _dev, sig, _entry in STEP_GRAPHS.entries()] == [plans[0].signature]


def test_coalesce_rejects_mixed_signatures():
    small = _tpu_bo(0)
    big = create_algo(build_space(PRIORS),
                      {"tpu_bo": {**TPU_BO["tpu_bo"], "n_candidates": 1024}}, seed=0,
                      device="cpu")
    x, y, _ = padded_history(0, 40, 64, D)
    big.observe_arrays(x[:40], y[:40].astype(np.float64))
    with pytest.raises(ValueError, match="signatures"):
        tco.run_coalesced_plans([small.fused_step_plan(16), big.fused_step_plan(16)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coalesced_round_matches_the_reference(seed):
    """Lanes seed, seed+10 and seed+20 (three histories, three keys)
    through both packages' ``run_coalesced_plans``."""
    lanes = [seed, seed + 10, seed + 20]
    statics = tbo.plan_statics(16, False, **{k: v for k, v in STEP.items() if k != "q"})
    ref_plans, port_plans = [], []
    for lane in lanes:
        x, y, mask = padded_history(lane, 40, 64, D)
        best_x = x[int(np.argmin(np.where(mask > 0, y, np.inf)))]
        key = jax.random.PRNGKey(lane)
        ref_plans.append(jbo.make_fused_plan(
            key, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), best_x, None, 16,
            tr_length=0.8, **{k: v for k, v in STEP.items() if k != "q"}))
        draws = jax_suggest_draws(
            key, q=16, n_candidates=STEP["n_candidates"], d_free=D, d=D, acq=STEP["acq"],
            local_frac=STEP["local_frac"], trust_region=True,
            tr_perturb_dims=STEP["tr_perturb_dims"])
        hypers = GPHypers(*(to_torch(np.asarray(h)) for h in jax_init_hypers(D)))
        arrays = (draws, to_torch(x), to_torch(y), to_torch(mask), to_torch(best_x), hypers,
                  torch.tensor(0.8, dtype=torch.float32))
        port_plans.append(tbo.FusedPlan(tbo.plan_signature(x.shape, statics), arrays,
                                        statics, 16))
    ref = jco.run_coalesced_plans(ref_plans)
    port = tco.run_coalesced_plans(port_plans)
    for (rows_j, state_j), (rows_t, state_t) in zip(ref, port):
        assert rows_t.shape == (16, D)
        np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), atol=1e-5)
        np.testing.assert_allclose(state_t.health.numpy(), np.asarray(state_j.health),
                                   rtol=1e-3)


def test_prep_cache_hit_builds_the_miss_plan():
    """A prep-cache hit (the warm round of an instance whose prep is
    cached) against the same round of a twin built after the cache was
    emptied (a miss)."""
    algo = _tpu_bo(3)
    rows, state = tbo.run_fused_plan(algo.fused_step_plan(16))
    algo.consume_fused_step(state)
    twin = copy.deepcopy(algo)
    algo.fused_step_plan(16)  # caches the warm prep
    twin.fused_step_plan(16)
    tbo.reset_plan_prep_stats()
    hit_plan = algo.fused_step_plan(16)
    assert tbo.plan_prep_stats()["hits"] == 1
    tbo._PLAN_PREP_CACHE.clear()
    miss_plan = twin.fused_step_plan(16)
    stats = tbo.plan_prep_stats()
    assert stats["hits"] == 1 and stats["misses"] == 1
    assert hit_plan.signature == miss_plan.signature
    assert hit_plan.statics == miss_plan.statics and hit_plan.num == miss_plan.num
    _leaves_equal(hit_plan.arrays, miss_plan.arrays)
