"""The port's public path on the CPU: ``build_space`` -> ``create_algo`` ->
observe / suggest, its state round trip, and a reference ``TPUBO`` state
restored into the port (``orion_tpu_torch.convert``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.algo.base import create_algo as jax_create_algo
from orion_tpu.algo import tpu_bo as jbo
from orion_tpu.space.dsl import build_space as jax_build_space
from orion_tpu_torch.algo import tpu_bo as tbo
from orion_tpu_torch.algo.base import create_algo
from orion_tpu_torch.benchmarks.functions import hartmann6
from orion_tpu_torch.convert import algo_state_from_jax, seed_from_rng_key
from orion_tpu_torch.space.dsl import build_space

from torch_parity import jax_suggest_draws, to_torch

CONFIG = {"tpu_bo": {"n_init": 16, "n_candidates": 512, "fit_steps": 10, "local_frac": 0.3}}
PRIORS = {f"x{i}": "uniform(0, 1)" for i in range(6)}


def _observe(algo, x):
    y = hartmann6(torch.from_numpy(x)).numpy()
    algo.observe([{f"x{i}": float(r[i]) for i in range(6)} for r in x],
                 [{"objective": float(v)} for v in y])


def test_public_path_on_cpu():
    algo = create_algo(build_space(PRIORS), CONFIG, seed=0, device="cpu")
    _observe(algo, np.random.default_rng(0).uniform(size=(40, 6)).astype(np.float32))
    params = algo.suggest(16)
    cube = np.asarray([[p[f"x{i}"] for i in range(6)] for p in params])
    assert cube.shape == (16, 6)
    assert np.isfinite(cube).all() and (cube >= 0).all() and (cube <= 1).all()
    assert len({tuple(row) for row in cube}) == 16
    record = algo.health_record()
    assert record["n_obs"] == 40 and np.isfinite(record["gp_mll"])
    batch = algo.finalize_suggest_batch(algo.dispatch_suggest(10))
    assert batch.cube.shape == (10, 6) and len(batch.params) == 10


def test_turbo_is_registered_with_its_defaults():
    algo = create_algo(build_space(PRIORS), {"turbo": {"n_candidates": 256}}, seed=3,
                       device="cpu")
    assert isinstance(algo, tbo.TuRBO) and algo.local_frac == 0.9 and algo.trust_region
    assert algo.configuration == {"turbo": dict(
        jax_create_algo(jax_build_space(PRIORS), {"turbo": {"n_candidates": 256}},
                        seed=3).configuration["turbo"])}


def test_entry_points_default_to_cuda():
    """No silent CPU: without a device, the entry points ask for CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_algo(build_space(PRIORS), CONFIG, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbo.TPUBO(build_space(PRIORS), use_mesh=True)


def test_building_blocks_default_to_cuda():
    """The public building blocks take ``device=None`` too, meaning CUDA:
    the history buffers, the starting hyperparameters and a converted
    reference GP state all raise here rather than land on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from orion_tpu.algo.gp.gp import fit_gp as jax_fit_gp
    from orion_tpu_torch.algo.gp.gp import init_hypers
    from orion_tpu_torch.algo.history import DeviceHistory
    from orion_tpu_torch.convert import gp_state_from_numpy

    x = np.random.default_rng(5).uniform(size=(8, 3)).astype(np.float32)
    state_j = jax_fit_gp(x, np.sum(x, axis=1), np.ones(8, np.float32), n_steps=1)
    for build in (lambda: DeviceHistory(3), lambda: DeviceHistory.from_host(x, x[:, 0]),
                  lambda: init_hypers(3), lambda: gp_state_from_numpy(state_j)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert gp_state_from_numpy(state_j, device="cpu").x.device.type == "cpu"


def test_state_dict_round_trip():
    space = build_space(PRIORS)
    algo = create_algo(space, CONFIG, seed=1, device="cpu")
    _observe(algo, np.random.default_rng(1).uniform(size=(30, 6)).astype(np.float32))
    algo.suggest(8)
    state = algo.state_dict()
    twin = create_algo(space, CONFIG, seed=99, device="cpu")
    twin.set_state(state)
    a = algo.suggest(8)
    b = twin.suggest(8)
    assert a.materialize() == b.materialize()


def test_reference_state_restored_into_port_gives_same_step():
    """A JAX TPUBO's state, converted: the port's next suggest step (on the
    reference's replayed draws) returns the reference's rows (atol 1e-5,
    as ``test_torch_suggest_step``)."""
    ref = jax_create_algo(jax_build_space(PRIORS), CONFIG, seed=2)
    x = np.random.default_rng(2).uniform(size=(40, 6)).astype(np.float32)
    y = np.asarray(hartmann6(torch.from_numpy(x)))
    ref.observe([{f"x{i}": float(r[i]) for i in range(6)} for r in x],
                [{"objective": float(v)} for v in y])
    ref.suggest(16)  # leaves fitted hypers (the warm start) in the state
    state = ref.state_dict()
    port = create_algo(build_space(PRIORS), CONFIG, seed=0, device="cpu")
    port.set_state(algo_state_from_jax(state))
    assert port._host.count == 40 and port._tr_length == state["tr"][0]
    assert port.n_observed == ref.n_observed

    key = jax.random.PRNGKey(5)
    x_j, y_j, m_j, _ = ref._hist.fit_view()
    best_x = ref._host.x[ref._host.best_idx]
    statics = dict(q=16, n_candidates=512, kernel="matern52", acq="thompson", fit_steps=10,
                   local_frac=0.3, local_sigma=0.1, beta=2.0, trust_region=True,
                   tr_perturb_dims=20, y_transform="copula")
    rows_j, _ = jbo._suggest_step(key, x_j, y_j, m_j, jnp.asarray(best_x),
                                  ref._gp_state.hypers, jnp.asarray(ref._tr_length, jnp.float32),
                                  **statics)
    draws = jax_suggest_draws(key, q=16, n_candidates=512, d_free=6, d=6, acq="thompson",
                              local_frac=0.3, trust_region=True)
    x_t, y_t, m_t, _ = port._hist.fit_view()
    best_t = to_torch(port._host.x[port._host.best_idx])
    rows_t, _ = tbo._suggest_step(draws, x_t, y_t, m_t, best_t, port._gp_state.hypers,
                                  torch.tensor(port._tr_length), **statics)
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), atol=1e-5)
    assert seed_from_rng_key(state["rng_key"]) == algo_state_from_jax(state)["seed"]
