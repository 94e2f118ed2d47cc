"""The port's library entry points against ``orion_tpu``'s:
``ExperimentClient`` suggest / observe / ``observe_all`` / ``stats()`` and
``insert_trials`` with the scripted algorithm of ``test_torch_producer``,
``optimize()`` with ``tpu_bo`` on the CPU, and the ``cuda`` default.

``stats()`` is compared after removing only its wall-clock fields
(``start_time``, ``finish_time``, ``duration``)."""

import pytest
import torch

from orion_tpu.client.manual import insert_trials as ref_insert_trials
from orion_tpu_torch.benchmarks.functions import branin
from orion_tpu_torch.client.experiment import ExperimentClient, optimize
from orion_tpu_torch.client.manual import insert_trials
from orion_tpu_torch.core.experiment import build_experiment
from orion_tpu_torch.storage.base import create_storage

from test_torch_producer import PRIORS, _client, _objective

STATS_WALL_CLOCK = ("start_time", "finish_time", "duration")


def _strip_stats(stats):
    return {k: v for k, v in stats.items() if k not in STATS_WALL_CLOCK}


def _session(port):
    """suggest / observe / observe_all / stats, two rounds with one trial
    left reserved; returns every outcome."""
    client, storage = _client(port, depth=1, speculative=False)
    out = [sorted(client.stats())]
    first = client.suggest(5)
    out.append([(t.id, t.status, dict(t.params)) for t in first])
    client.observe(first[0], 0.5, loss=3)
    client.observe_all(first[1:4], [_objective(t.params) for t in first[1:4]])
    out.append(_strip_stats(client.stats()))
    second = client.suggest(3)
    out.append([(t.id, t.status, dict(t.params)) for t in second])
    client.observe_all(second, [-1.0, 2.0, 0.25])
    stats = client.stats()
    out.append((sorted(stats), _strip_stats(stats), client.is_done))
    best = storage.get_trial(uid=stats["best_trials_id"])
    out.append((best.objective.value, [(r.name, r.type, r.value) for r in best.results]))
    aux = storage.get_trial(uid=first[0].id)
    out.append([(r.name, r.type, r.value) for r in aux.statistics])
    return out


def test_experiment_client_matches_reference():
    got, want = _session(True), _session(False)
    assert got == want
    final = got[-3][1]
    assert final["trials_completed"] == 7 and final["best_evaluation"] == -1.0


def test_insert_trials_matches_reference():
    points = [{"x0": 0.25, "x1": 0.5}, {"x0": 0.75, "x1": 0.125}]
    outs = []
    for port, insert in ((True, insert_trials), (False, ref_insert_trials)):
        client, storage = _client(port, depth=1, speculative=False)
        trials = insert(client.experiment, points)
        with pytest.raises(ValueError, match="not contained"):
            insert(client.experiment, [{"x0": 2.0, "x1": 0.5}])
        reserved = client.suggest(3)
        outs.append(([t.id for t in trials], [(t.id, dict(t.params)) for t in reserved]))
    assert outs[0] == outs[1]


def test_optimize_tpu_bo_on_cpu_beats_random_with_tensor_batch_eval():
    """The twin of ``tests/unit/test_client.py::test_optimize_with_tpu_bo_converges_better_than_random``
    at the sizes the port's tests run."""
    seen = []

    def batch_eval(x):
        seen.append((type(x), x.device.type, x.dtype, tuple(x.shape)))
        return branin(x)

    priors = {"x0": "uniform(0, 1)", "x1": "uniform(0, 1)"}
    r = optimize(None, priors, max_trials=64, batch_size=8, algorithm="random", seed=7,
                 batch_eval=batch_eval, device="cpu")
    b = optimize(None, priors, max_trials=64, batch_size=8,
                 algorithm={"tpu_bo": {"n_init": 8, "n_candidates": 256, "fit_steps": 5}},
                 seed=7, batch_eval=batch_eval, device="cpu")
    assert r["trials_completed"] == b["trials_completed"] == 64
    assert b["best_evaluation"] <= r["best_evaluation"] + 1.0
    assert b["best_evaluation"] < 2.0
    assert set(seen) == {(torch.Tensor, "cpu", torch.float32, (8, 2))}


def test_optimize_resumes_on_pickled_storage(tmp_path):
    config = {"type": "pickled", "path": str(tmp_path / "db.pkl")}
    first = optimize(_objective, PRIORS, max_trials=6, batch_size=3, seed=1,
                     storage=create_storage(config), device="cpu")
    again = optimize(_objective, PRIORS, max_trials=12, batch_size=3, seed=2,
                     storage=create_storage(config), device="cpu")
    assert first["trials_completed"] == 6 and again["trials_completed"] == 12
    assert again["best_evaluation"] <= first["best_evaluation"]


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the raise without a card")
    storage = create_storage({"type": "memory"})
    exp = build_experiment(storage, "dev", priors=PRIORS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp.instantiate(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExperimentClient(build_experiment(storage, "dev", priors=PRIORS))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize(_objective, PRIORS, max_trials=2)
