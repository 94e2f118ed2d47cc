"""The port's TPE, CMA-ES, DE, grid and random search against ``orion_tpu``,
and every registry name through the port's entry point.

The same numpy inputs and the reference's replayed draws
(``torch_parity.jax_*``) go through each ``orion_tpu`` function and its
port.  Tolerances, fixed in advance: TPE rows within 1e-5 and the same
top-k indices; log densities and bandwidths within rtol 1e-5; CMA-ES over
5 generations at d=8 m, sigma, pc and ps within 1e-5, C within 1e-5 +
rtol 1e-4, gen equal, and B·diag(D²)·Bᵀ within 1e-4 of C; ``_cma_sample``
on the reference's state and z within 1e-6; DE proposals within 1e-6; the
grid and its sweep equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.algo import cmaes as jcma
from orion_tpu.algo import de as jde
from orion_tpu.algo import tpe as jtpe
from orion_tpu.algo.base import create_algo as jax_create_algo
from orion_tpu.space.dsl import build_space as jax_build_space
from orion_tpu_torch.algo import cmaes as tcma
from orion_tpu_torch.algo import de as tde
from orion_tpu_torch.algo import tpe as ttpe
from orion_tpu_torch.algo.base import algo_registry, create_algo
from orion_tpu_torch.convert import algo_state_from_jax, seed_from_rng_key
from orion_tpu_torch.space.dsl import build_space

from torch_parity import jax_cma_z, jax_de_draws, jax_tpe_draws, to_torch

PRIORS = {"a": "uniform(0, 1)", "b": "uniform(0, 1)"}
FIDELITY_PRIORS = {"x": "uniform(0, 1)", "y": "uniform(0, 1)", "epochs": "fidelity(1, 9, 3)"}
NEEDS_FIDELITY = ("asha", "asha_bo", "bohb", "hyperband")


def _sphere(x, center=0.3):
    return np.sum((np.asarray(x, np.float64) - center) ** 2, axis=1)


# --- TPE ----------------------------------------------------------------------


def _kde_sets(seed, n_good=12, n_bad=30, d=5):
    rng = np.random.default_rng(seed)
    good = (0.4 + 0.1 * rng.normal(size=(n_good, d))).clip(0, 1).astype(np.float32)
    bad = rng.uniform(size=(n_bad, d)).astype(np.float32)
    return good, bad


def test_good_bad_split_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(41, 4)).astype(np.float32)
    y = np.round(rng.normal(size=41), 1).astype(np.float32)  # ties: stable order
    for gamma in (0.1, 0.25, 1.0):
        for got, want in zip(ttpe.good_bad_split(x, y, gamma), jtpe.good_bad_split(x, y, gamma)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_kde_pieces_match_reference(seed):
    good, bad = _kde_sets(seed)
    x = np.random.default_rng(seed + 10).uniform(size=(64, 5)).astype(np.float32)
    for points in (good, bad):
        np.testing.assert_allclose(ttpe._bandwidth_1d(to_torch(points)).numpy(),
                                   np.asarray(jtpe._bandwidth_1d(jnp.asarray(points))),
                                   rtol=1e-5)
    np.testing.assert_allclose(ttpe._rank_log_weights(12, "cpu").numpy(),
                               np.asarray(jtpe._rank_log_weights(12)), rtol=1e-5)
    bw = np.asarray(jtpe._bandwidth_1d(jnp.asarray(good)))
    log_w = np.asarray(jtpe._rank_log_weights(12))
    for weights in (None, log_w):
        want = jtpe._log_kde_product(jnp.asarray(x), jnp.asarray(good), jnp.asarray(bw),
                                     log_w=None if weights is None else jnp.asarray(weights))
        got = ttpe._log_kde_product(to_torch(x), to_torch(good), to_torch(bw),
                                    log_w=None if weights is None else to_torch(weights))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("seed,n_candidates,num,bw_factor",
                         [(0, 256, 16, 1.0), (1, 128, 32, 0.5), (2, 16, 40, 1.0)],
                         ids=["pool256", "sharpened", "pool-grows-to-q"])
def test_tpe_suggest_matches_reference(seed, n_candidates, num, bw_factor):
    good, bad = _kde_sets(seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jtpe._tpe_suggest(key, jnp.asarray(good), jnp.asarray(bad),
                                        n_candidates, num, bw_factor=bw_factor))
    draws = jax_tpe_draws(key, n_good=len(good), n_candidates=n_candidates, num=num, d=5)
    cands, score = ttpe._tpe_pool(draws, to_torch(good), to_torch(bad), bw_factor)
    top = ttpe.select_q(score, num).numpy()
    got = ttpe._tpe_suggest(draws, to_torch(good), to_torch(bad), num, bw_factor).numpy()
    assert got.shape == want.shape == (num, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # The reference's picks are the same candidates of the same pool.
    dist = np.abs(want[:, None, :] - cands.numpy()[None, :, :]).max(axis=2)
    assert (dist.min(axis=1) <= 1e-5).all()
    np.testing.assert_array_equal(np.argmin(dist, axis=1), top)


def test_tpe_sampled_draws_have_the_reference_shapes():
    draws = ttpe.sample_tpe_draws(torch.Generator().manual_seed(0), 12, 256, 5, "cpu")
    want = jax_tpe_draws(jax.random.PRNGKey(0), n_good=12, n_candidates=256, num=16, d=5)
    for got, ref in zip(draws, want):
        assert got.shape == ref.shape and got.is_floating_point() == ref.is_floating_point()
    assert 0 <= int(draws.pick_idx.min()) and int(draws.pick_idx.max()) < 12
    # Rank weighting: the best good point is picked more often than the worst.
    counts = torch.bincount(draws.pick_idx.ravel(), minlength=12)
    assert counts[0] > counts[-1]


# --- CMA-ES -------------------------------------------------------------------


def _numpy_state(state):
    return [np.asarray(leaf) for leaf in state]


def test_cma_update_matches_reference_over_five_generations():
    d, lam = 8, 12
    state_j = jcma._init_state(d, 0.3)
    state_t = tcma._init_state(d, 0.3, "cpu")
    for gen in range(5):
        X = np.asarray(jcma._cma_sample(jax.random.PRNGKey(gen), state_j, lam))
        y = _sphere(X).astype(np.float32)
        state_j = jcma._cma_update(state_j, jnp.asarray(X), jnp.asarray(y))
        state_t = tcma._cma_update(state_t, to_torch(X), to_torch(y))
        m_j, s_j, C_j, _B, _D, pc_j, ps_j, g_j = _numpy_state(state_j)
        m_t, s_t, C_t, B_t, D_t, pc_t, ps_t, g_t = _numpy_state(state_t)
        for got, want in ((m_t, m_j), (s_t, s_j), (pc_t, pc_j), (ps_t, ps_j)):
            np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(C_t, C_j, rtol=1e-4, atol=1e-5)
        assert int(g_t) == int(g_j) == gen + 1
        # Eigenvectors only up to sign and rotation: compare through C.
        np.testing.assert_allclose((B_t * D_t**2) @ B_t.T, C_t, atol=1e-4)


def test_cma_sample_matches_reference_on_its_state():
    d = 8
    state_j = jcma._init_state(d, 0.3)
    for gen in range(3):
        X = np.asarray(jcma._cma_sample(jax.random.PRNGKey(gen), state_j, 12))
        state_j = jcma._cma_update(state_j, jnp.asarray(X), jnp.asarray(_sphere(X), jnp.float32))
    key = jax.random.PRNGKey(7)
    want = np.asarray(jcma._cma_sample(key, state_j, 20))
    carried = tuple(to_torch(np.asarray(leaf)) for leaf in state_j)
    got = tcma._cma_sample(jax_cma_z(key, 20, d), carried).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# --- DE -----------------------------------------------------------------------


@pytest.mark.parametrize("mutation", ["rand1", "best1"])
@pytest.mark.parametrize("num", [7, 20])
def test_de_propose_matches_reference(mutation, num):
    rng = np.random.default_rng(num)
    P, d = 12, 5
    pop = rng.uniform(size=(P, d)).astype(np.float32)
    fit = rng.normal(size=P).astype(np.float32)
    key = jax.random.PRNGKey(num)
    want = np.asarray(jde._de_propose(key, jnp.asarray(pop), jnp.asarray(fit), num, mutation,
                                      0.5, 1.0, 0.9))
    draws = jax_de_draws(key, P=P, num=num, d=d, f_lo=0.5, f_hi=1.0, cr=0.9)
    got = tde._de_propose(draws, to_torch(pop), to_torch(fit), mutation).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_de_sampled_draws_have_the_reference_ranges():
    draws = tde.sample_de_draws(torch.Generator().manual_seed(0), 12, 500, 5, 0.5, 1.0, 0.9,
                                "cpu")
    want = jax_de_draws(jax.random.PRNGKey(0), P=12, num=500, d=5, f_lo=0.5, f_hi=1.0, cr=0.9)
    for got, ref in zip(draws, want):
        assert got.shape == ref.shape and got.dtype.is_floating_point == ref.dtype.is_floating_point
    assert 0 <= int(draws.offset) < 12
    assert int(draws.r1.min()) >= 0 and int(draws.r1.max()) <= 10
    assert 0.5 <= float(draws.F.min()) and float(draws.F.max()) < 1.0
    assert 0.85 < float(draws.cross.float().mean()) < 0.95


def test_de_crowding_and_state_shape_check():
    """Seeding, crowding (nearest member replaced only if better), the
    non-finite drop and the ``set_state`` shape check, as the reference."""
    space = build_space(PRIORS)
    algo = create_algo(space, {"de": {"popsize": 4}}, seed=0, device="cpu")
    ref = jax_create_algo(jax_build_space(PRIORS), {"de": {"popsize": 4}}, seed=0)
    rng = np.random.default_rng(0)
    for _ in range(4):
        x = rng.uniform(size=(3, 2)).astype(np.float32)
        y = _sphere(x)
        y[1] = np.inf
        for a in (algo, ref):
            a.observe_arrays(x, y)
    np.testing.assert_array_equal(algo._pop, ref._pop)
    np.testing.assert_array_equal(algo._fit, ref._fit)
    assert algo._n_filled == ref._n_filled == 4
    state = algo.state_dict()
    state["fit"] = state["fit"][:3]
    with pytest.raises(ValueError, match="inconsistent DE state"):
        algo.set_state(state)


# --- grid and random search ---------------------------------------------------

MIXED = {"lr": "loguniform(1e-4, 1e-1)", "width": "uniform(1, 4, discrete=True)",
         "act": "choices(['relu', 'tanh', 'gelu'])", "drop": "uniform(0, 0.5)"}


def test_grid_search_matches_reference_on_a_mixed_space():
    port = create_algo(build_space(MIXED), {"grid_search": {"n_values": 5}}, seed=0,
                       device="cpu")
    ref = jax_create_algo(jax_build_space(MIXED), {"grid_search": {"n_values": 5}}, seed=0)
    np.testing.assert_array_equal(port._grid, ref._grid)
    assert port.configuration == ref.configuration
    while True:
        got, want = port.suggest(7), ref.suggest(7)
        if want is None:
            assert got is None
            break
        assert [dict(p) for p in got] == [dict(p) for p in want]
        assert port._cursor == ref._cursor
        port.observe(got, [{"objective": 0.0}] * len(got))
        ref.observe(want, [{"objective": 0.0}] * len(want))
    assert port.is_done and ref.is_done and port._cursor == len(port._grid) == 5 * 4 * 3 * 5


def test_grid_search_register_suggestion_advances_cursor_as_reference():
    port = create_algo(build_space(MIXED), {"grid_search": {"n_values": 3}}, device="cpu")
    ref = jax_create_algo(jax_build_space(MIXED), {"grid_search": {"n_values": 3}})
    points = list(ref.suggest(10))
    ref._cursor = 0
    for p in (points[4], points[2], points[9]):
        port.register_suggestion(p)
        ref.register_suggestion(p)
        assert port._cursor == ref._cursor
    assert port._cursor == 10


def test_grid_search_covers_and_finishes():
    space = build_space({"a": "uniform(0, 1)", "c": "choices(['x', 'y'])"})
    algo = create_algo(space, {"grid_search": {"n_values": 4}}, seed=0, device="cpu")
    seen = []
    while True:
        batch = algo.suggest(3)
        if batch is None:
            break
        algo.observe(batch, [{"objective": 0.0} for _ in batch])
        seen.extend(batch)
    assert len(seen) == 8 and algo.is_done
    assert {p["c"] for p in seen} == {"x", "y"}


def test_random_search_draws_the_unit_cube_from_its_generator():
    space = build_space(PRIORS)
    a = create_algo(space, "random", seed=3, device="cpu")
    b = create_algo(space, None, seed=3, device="cpu")
    assert type(a).__name__ == "RandomSearch" and a.speculation_safe
    batch = a.suggest_batch(64)
    assert batch.cube.shape == (64, 2) and ((batch.cube >= 0) & (batch.cube < 1)).all()
    assert batch.params.materialize() == b.suggest(64).materialize()


# --- every registry name --------------------------------------------------------

SMALL = {"tpu_bo": {"n_candidates": 64}, "turbo": {"n_candidates": 64},
         "asha_bo": {"n_candidates": 64}, "tpe": {"n_candidates": 64},
         "bohb": {"n_candidates": 64}}


def _space_for(name):
    return build_space(FIDELITY_PRIORS if name in NEEDS_FIDELITY else PRIORS)


def _all_names():
    import orion_tpu_torch.algo.base as base

    base._import_builtins()
    return algo_registry.names()


def test_registry_holds_every_reference_name():
    """The reference's built-in algorithms (not plugins other tests
    register, such as ``orion_tpu.testing``'s) all have a port."""
    from orion_tpu.algo.base import _import_builtins as jax_import_builtins
    from orion_tpu.algo.base import algo_registry as jax_registry

    jax_import_builtins()
    builtins = [name for name in jax_registry.names()
                if jax_registry.get(name).__module__.startswith("orion_tpu.algo.")]
    assert _all_names() == builtins and len(builtins) == 11


@pytest.mark.parametrize("name", _all_names())
def test_every_algorithm_runs_on_cpu_and_defaults_to_cuda(name):
    """``device="cpu"`` builds the algorithm and runs a suggest/observe
    round; without a device it asks for CUDA and raises here."""
    space = _space_for(name)
    config = {name: SMALL.get(name, {})}
    algo = create_algo(space, config, seed=0, device="cpu")
    assert algo.configuration == jax_create_algo(
        jax_build_space(FIDELITY_PRIORS if name in NEEDS_FIDELITY else PRIORS), config, seed=0
    ).configuration
    params = algo.suggest(4)
    assert params is not None and len(params) == 4
    for p in params:
        assert space.contains_point(dict(p))
    algo.observe(params, [{"objective": float(i)} for i in range(len(params))])
    assert algo.n_observed == 4
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_algo(space, config, seed=0)


@pytest.mark.parametrize("name", ["tpu_bo", "tpe", "bohb", "asha_bo"])
def test_mesh_is_not_ported(name):
    with pytest.raises(NotImplementedError):
        create_algo(_space_for(name), {name: {"use_mesh": True}}, device="cpu")


# --- reference state restored into the port -------------------------------------


def _restored(config, space_priors, n_rounds, seed=0):
    """A reference instance after ``n_rounds`` rounds of suggest(8) and
    observe (sphere objective), and the port restored from its state."""
    space_j = jax_build_space(space_priors)
    ref = jax_create_algo(space_j, config, seed=seed)
    for _ in range(n_rounds):
        params = ref.suggest(8)
        ref.observe(params, [{"objective": float(v)}
                             for v in _sphere(space_j.params_to_cube(params))])
    port = create_algo(build_space(space_priors), config, seed=99, device="cpu")
    state = ref.state_dict()
    port.set_state(algo_state_from_jax(state))
    assert port.n_observed == ref.n_observed
    assert port._generator.initial_seed() == seed_from_rng_key(state["rng_key"])
    return ref, port


def test_tpe_state_restored_gives_the_reference_step():
    config = {"tpe": {"n_init": 8, "n_candidates": 64}}
    ref, port = _restored(config, PRIORS, 3)
    good_j, bad_j = jtpe.good_bad_split(ref._x, ref._y, ref.gamma)
    good_t, bad_t = ttpe.good_bad_split(port._x, port._y, port.gamma)
    key = jax.random.PRNGKey(11)
    want = jtpe._tpe_suggest(key, jnp.asarray(good_j), jnp.asarray(bad_j), 64, 8)
    draws = jax_tpe_draws(key, n_good=len(good_t), n_candidates=64, num=8, d=2)
    got = ttpe._tpe_suggest(draws, to_torch(good_t), to_torch(bad_t), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cmaes_state_restored_gives_the_reference_update():
    config = {"cmaes": {"popsize": 6}}
    ref, port = _restored(config, PRIORS, 3)  # 24 observed: 4 generations
    assert len(port._buf_y) == len(ref._buf_y)
    X = np.random.default_rng(5).uniform(size=(6, 2)).astype(np.float32)
    y = _sphere(X).astype(np.float32)
    want = _numpy_state(jcma._cma_update(ref._state, jnp.asarray(X), jnp.asarray(y)))
    got = _numpy_state(tcma._cma_update(port._state, to_torch(X), to_torch(y)))
    for i in (0, 1, 5, 6):  # m, sigma, pc, ps
        np.testing.assert_allclose(got[i], want[i], atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-5)
    assert int(got[7]) == int(want[7]) == 5


def test_de_state_restored_gives_the_reference_proposal():
    config = {"de": {"popsize": 8, "mutation": "best1"}}
    ref, port = _restored(config, PRIORS, 3)
    key = jax.random.PRNGKey(3)
    want = jde._de_propose(key, jnp.asarray(ref._pop), jnp.asarray(ref._fit), 8, "best1",
                           0.5, 1.0, 0.9)
    draws = jax_de_draws(key, P=8, num=8, d=2, f_lo=0.5, f_hi=1.0, cr=0.9)
    got = tde._de_propose(draws, to_torch(port._pop), to_torch(port._fit), "best1")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_grid_and_random_state_restored():
    ref, port = _restored({"grid_search": {"n_values": 5}}, PRIORS, 2)
    assert port._cursor == ref._cursor == 16
    assert [dict(p) for p in port.suggest(5)] == [dict(p) for p in ref.suggest(5)]
    ref, port = _restored("random", PRIORS, 1)
    assert port.suggest(3) is not None
