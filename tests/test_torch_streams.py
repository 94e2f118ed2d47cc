"""The random rounds and the model rounds draw from separate streams.

The reference derives each purpose's draws from its round key by ``split``
and ``fold_in`` (``orion_tpu/algo/tpu_bo.py:711,756,1620``), so a GP
round's candidates never replay the numbers of the random round before it.
The port keeps two ``torch.Generator`` streams per instance, both seeded
from the seed (``orion_tpu_torch/algo/base.py``).  With one stream, a fresh
instance at the seed of an earlier run proposed the points that run had
already observed as its global candidates, and a resumed ``optimize`` paid
a second GP round for the duplicates.
"""

import copy

import numpy as np
import pytest
import torch

from orion_tpu_torch.algo.base import create_algo, model_seed
from orion_tpu_torch.algo.tpu_bo import TPUBO
from orion_tpu_torch.client.experiment import optimize
from orion_tpu_torch.core.producer import _advance_rng
from orion_tpu_torch.space.dsl import build_space
from orion_tpu_torch.storage.base import create_storage

PRIORS = {f"x{i}": "uniform(0, 1)" for i in range(3)}


def _objective(cube):
    return ((np.asarray(cube, dtype=np.float64) - 0.3) ** 2).sum(axis=1)


def _tpu_bo(name="tpu_bo", **kw):
    return {name: dict({"n_init": 32, "n_candidates": 256, "fit_steps": 3}, **kw)}


@pytest.mark.parametrize("name", ["tpu_bo", "turbo"])
def test_seed_0_instance_proposes_no_point_of_its_own_random_round(name):
    space = build_space(PRIORS)
    first = create_algo(space, _tpu_bo(name), seed=0, device="cpu")
    rows = first.suggest_batch(32).cube  # the random round
    resumed = create_algo(space, _tpu_bo(name), seed=0, device="cpu")
    resumed.observe_arrays(rows, _objective(rows))
    plan = resumed.fused_step_plan(32)
    observed = {tuple(r) for r in rows.tolist()}
    candidates = {tuple(r) for r in plan.arrays[0].global_u.numpy().tolist()}
    assert not observed & candidates
    suggested = resumed.suggest_batch(32).cube
    assert not observed & {tuple(r) for r in suggested.tolist()}


def test_seeded_optimize_resume_needs_one_gp_suggest(monkeypatch):
    """A seed-0 ``optimize`` resumed at seed 0 on its own store: one GP
    suggest fills the round, as in the reference."""
    plans = []
    fused_step_plan = TPUBO.fused_step_plan

    def counting(self, num):
        plan = fused_step_plan(self, num)
        if plan is not None:
            plans.append(num)
        return plan

    def batch_eval(x):
        return torch.from_numpy(_objective(x.numpy())).to(torch.float32)

    storage = create_storage({"type": "memory"})
    # At q=128 from 4096 candidates one stream gave two GP suggests here.
    algorithm = _tpu_bo(n_init=128, n_candidates=4096)
    kw = dict(batch_size=128, algorithm=algorithm, seed=0, storage=storage, name="resume",
              batch_eval=batch_eval, device="cpu")
    assert optimize(None, PRIORS, max_trials=128, **kw)["trials_completed"] == 128
    monkeypatch.setattr(TPUBO, "fused_step_plan", counting)
    assert optimize(None, PRIORS, max_trials=256, **kw)["trials_completed"] == 256
    assert plans == [128]


def test_both_streams_are_seeded_saved_restored_and_handed_off():
    space = build_space(PRIORS)
    algo = create_algo(space, _tpu_bo(), seed=5, device="cpu")
    assert algo.generator.initial_seed() == 5
    assert algo.model_generator.initial_seed() == model_seed(5) != 5
    rows = algo.suggest_batch(32).cube
    algo.observe_arrays(rows, _objective(rows))
    algo.suggest_batch(8)
    state = algo.state_dict()
    restored = create_algo(space, _tpu_bo(), seed=9, device="cpu")
    restored.set_state(state)
    for name in ("generator", "model_generator"):
        assert torch.equal(getattr(restored, name).get_state(), getattr(algo, name).get_state())
    algo.seed_rng(7)
    assert algo.generator.initial_seed() == 7
    assert algo.model_generator.initial_seed() == model_seed(7)
    naive = copy.deepcopy(restored)
    naive.suggest_batch(8)
    _advance_rng(restored, naive)
    for name in ("generator", "model_generator"):
        assert torch.equal(getattr(restored, name).get_state(), getattr(naive, name).get_state())
        assert getattr(restored, name) is not getattr(naive, name)
