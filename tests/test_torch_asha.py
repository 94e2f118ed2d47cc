"""The port's multi-fidelity family (ASHA, Hyperband, BOHB, ASHA-BO) against
``orion_tpu``.

Host bookkeeping: both packages get the same fresh rows, the reference's
bracket uniforms (``torch_parity.jax_asha_uniforms``) and the same results;
the suggested params, rung contents, ``rung_occupancy``, promotions,
``is_done`` and ``state_dict`` must be equal.  One ASHA-BO model round at
d=6+1 (512 candidates, 5 fit steps, trust region): the same
``_suggest_step`` inputs as the reference's plan, then the rows within 1e-5
of the reference's step on replayed draws.  The behaviour tests of
``tests/unit/test_asha.py`` are mirrored against the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orion_tpu.algo import tpe as jtpe
from orion_tpu.algo import tpu_bo as jbo
from orion_tpu.algo.base import create_algo as jax_create_algo
from orion_tpu.space.dsl import build_space as jax_build_space
from orion_tpu_torch.algo import tpe as ttpe
from orion_tpu_torch.algo import tpu_bo as tbo
from orion_tpu_torch.algo.base import create_algo
from orion_tpu_torch.convert import algo_state_from_jax
from orion_tpu_torch.space.dsl import build_space

from torch_parity import jax_asha_uniforms, jax_suggest_draws, jax_tpe_draws, to_torch


def _priors(dims, fidelity="fidelity(1, 27, 3)"):
    out = {f"x{i}": "uniform(0, 1)" for i in range(dims)}
    out["epochs"] = fidelity
    return out


def _objective(cube):
    return np.sum((np.asarray(cube, np.float64) - 0.3) ** 2, axis=1)


def _pair(config, priors, seed=0):
    return (jax_create_algo(jax_build_space(priors), config, seed=seed),
            create_algo(build_space(priors), config, seed=seed, device="cpu"))


def _suggest_both(ref, port, num, key):
    """One suggest round through both: promotions first, then fresh rows
    (uniform, from ``key``) through each package's ``_assign_new_points``
    with the reference's bracket uniforms."""
    out_r, out_p = [], []
    while len(out_r) < num:
        promoted_r, promoted_p = ref._promote_one(), port._promote_one()
        assert promoted_r == promoted_p
        if promoted_r is None:
            break
        out_r.append(promoted_r)
        out_p.append(promoted_p)
    remaining = num - len(out_r)
    if remaining:
        k_bracket, k_rows = jax.random.split(key)
        u = np.asarray(jax.random.uniform(k_rows, (remaining, ref.space.n_cols)))
        out_r += ref._assign_new_points(u, k_bracket)
        out_p += port._assign_new_points(u, jax_asha_uniforms(k_bracket, remaining))
    return out_r, out_p


def _run_both(ref, port, rounds, batch, seed=0):
    key = jax.random.PRNGKey(seed)
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        params_r, params_p = _suggest_both(ref, port, batch, sub)
        assert [dict(p) for p in params_p] == [dict(p) for p in params_r]
        cube = ref.space.params_to_cube(params_r)
        results = [{"objective": float(v)} for v in _objective(cube)]
        ref.observe(params_r, results)
        port.observe(params_p, results)
        assert port.rung_occupancy() == ref.rung_occupancy()
        assert port.is_done == ref.is_done
        if ref.is_done:
            break
    state_r, state_p = ref.state_dict(), port.state_dict()
    for key in ("brackets", "bracket_of", "n_observed"):
        assert state_p[key] == state_r[key], key
    return state_r, state_p


@pytest.mark.parametrize("config,priors", [
    ({"asha": {}}, _priors(3, "fidelity(1, 9, 3)")),
    ({"asha": {"num_brackets": 3}}, _priors(4)),
    ({"hyperband": {}}, _priors(4)),
    ({"hyperband": {"num_rungs": 3, "reduction_factor": 4}}, _priors(2, "fidelity(1, 256, 4)")),
], ids=["asha", "asha-3-brackets", "hyperband", "hyperband-rungs"])
def test_rung_bookkeeping_matches_reference(config, priors):
    ref, port = _pair(config, priors)
    assert [[r["resources"] for r in b.rungs] for b in port.brackets] == [
        [r["resources"] for r in b.rungs] for b in ref.brackets]
    _run_both(ref, port, rounds=40, batch=6)
    assert port.health_record() == ref.health_record()


def test_bohb_bookkeeping_and_model_match_reference():
    config = {"bohb": {"n_candidates": 64, "min_points": 8}}
    ref, port = _pair(config, _priors(3))
    state_r, state_p = _run_both(ref, port, rounds=12, batch=8)
    assert state_p["tiers"] == state_r["tiers"]
    assert port._model_tier() == ref._model_tier() is not None
    tier = ref._model_tier()
    good_r, bad_r = jtpe.good_bad_split(ref._tier_x[tier], ref._tier_y[tier], ref.gamma)
    good_r = ref._boost_top_rungs(tier, good_r)
    good_p, bad_p = ttpe.good_bad_split(port._tier_x[tier], port._tier_y[tier], port.gamma)
    good_p = port._boost_top_rungs(tier, good_p)
    np.testing.assert_array_equal(good_p, good_r)
    key = jax.random.PRNGKey(4)
    want = jtpe._tpe_suggest(key, jnp.asarray(good_r), jnp.asarray(bad_r), 64, 8)
    draws = jax_tpe_draws(key, n_good=len(good_p), n_candidates=64, num=8, d=3)
    got = ttpe._tpe_suggest(draws, to_torch(good_p), to_torch(bad_p), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    record_r, record_p = ref.health_record(), port.health_record()
    for key in ("model_tier", "tier_counts", "rung_occupancy", "best_y"):
        assert record_p[key] == record_r[key]


def test_point_hash_matches_reference_on_decoded_params():
    """The same decoded row hashes the same in both packages: the codecs
    hand out values of the same Python types (the hash is over ``repr``)."""
    priors = {"lr": "loguniform(1e-4, 1e-1)", "width": "uniform(1, 4, discrete=True)",
              "act": "choices(['relu', 'tanh'])", "epochs": "fidelity(1, 9, 3)"}
    ref, port = _pair({"asha": {}}, priors)
    u = np.random.default_rng(0).uniform(size=(16, ref.space.n_cols)).astype(np.float32)
    for p_r, p_p in zip(ref.space.arrays_to_params(ref.space.decode_flat_np(u)),
                        port.space.arrays_to_params(port.space.decode_flat_np(u))):
        assert [type(v) for v in p_p.values()] == [type(v) for v in p_r.values()]
        assert port._point_hash(p_p) == ref._point_hash(p_r)


@pytest.mark.parametrize("config", [{"asha": {"num_brackets": 2}}, {"hyperband": {}},
                                    {"bohb": {"n_candidates": 64, "min_points": 4}}],
                         ids=["asha", "hyperband", "bohb"])
def test_reference_state_restored_promotes_the_same_points(config):
    """A reference instance's state, converted: the port holds the same
    rungs (and BOHB tiers) and promotes the same points next."""
    ref, port = _pair(config, _priors(2))
    _run_both(ref, port, rounds=6, batch=5)
    restored = create_algo(build_space(_priors(2)), config, seed=5, device="cpu")
    restored.set_state(algo_state_from_jax(ref.state_dict()))
    assert restored.rung_occupancy() == ref.rung_occupancy()
    assert restored.state_dict().get("tiers") == ref.state_dict().get("tiers")
    assert restored._bracket_of == ref._bracket_of
    for _ in range(3):
        assert restored._promote_one() == ref._promote_one()


# --- ASHA-BO ------------------------------------------------------------------

ASHA_BO = {"asha_bo": {"n_init": 24, "n_candidates": 512, "fit_steps": 5, "refit_steps": 3,
                       "local_frac": 0.8, "trust_region": True, "y_transform": "copula",
                       "tr_perturb_dims": 4, "num_brackets": 2, "tr_local_m": 32}}


def _asha_bo_pair(rounds, seed=0):
    ref, port = _pair(ASHA_BO, _priors(6, "fidelity(1, 16, 4)"), seed=seed)
    _run_both(ref, port, rounds=rounds, batch=12, seed=seed)
    np.testing.assert_array_equal(port._host.x, ref._host.x)
    np.testing.assert_array_equal(port._host.y, ref._host.y)
    for name in ("_sigma", "_best_seen", "_tr_length", "_tr_succ", "_tr_fail",
                 "_top_best_idx", "_s_top"):
        assert getattr(port, name) == getattr(ref, name), name
    return ref, port


@pytest.mark.parametrize("rounds", [2, 7], ids=["full-history", "local-view"])
def test_asha_bo_model_round_matches_reference(rounds):
    """d=6 + the fidelity column, trust region on: 24 observations fit on
    the whole (pow-2 padded) history, 60 on the 32 nearest (the local
    view).  The port's ``_suggest_step`` inputs equal the reference plan's,
    and its rows on the replayed draws are the reference step's."""
    ref, port = _asha_bo_pair(rounds)
    assert (port._host.count > port.tr_local_m) == (rounds == 7)
    plan = ref._gp_plan(12)
    inputs, kw = port._model_inputs(12)
    statics = {k: v for k, v in plan.statics.items() if k != "mesh"}
    assert kw == statics and kw["q"] == 16 and kw["fixed_tail_cols"] == 1
    key, *arrays = plan.arrays
    for got, want in zip(inputs[:4], arrays[:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(inputs[4], arrays[4]):  # the cold hypers
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(inputs[5]) == float(arrays[5])
    rows_j, _ = jbo._suggest_step(*plan.arrays, **plan.statics)
    draws = jax_suggest_draws(key, q=16, n_candidates=512, d_free=6, d=7, acq="thompson",
                              local_frac=0.8, trust_region=True, tr_perturb_dims=4)
    rows_t, state_t = tbo._suggest_step(draws, *inputs, **kw)
    assert rows_t.shape == (16, 6)
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), atol=1e-5)
    # Warm rounds refit with refit_steps from the last hypers.
    port._gp_state = state_t
    _, kw_warm = port._model_inputs(12)
    assert kw_warm["fit_steps"] == 3


def test_reference_asha_bo_state_restored_gives_the_same_inputs():
    ref, _port = _asha_bo_pair(4)
    restored = create_algo(build_space(_priors(6, "fidelity(1, 16, 4)")), ASHA_BO, seed=9,
                           device="cpu")
    restored.set_state(algo_state_from_jax(ref.state_dict()))
    ref.set_state(ref.state_dict())  # the reference restores cold, as the port
    plan = ref._gp_plan(8)
    inputs, kw = restored._model_inputs(8)
    assert kw == {k: v for k, v in plan.statics.items() if k != "mesh"}
    for got, want in zip(inputs[:4], plan.arrays[1:5]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert restored.rung_occupancy() == ref.rung_occupancy()
    assert restored._top_best_idx == ref._top_best_idx


def test_asha_bo_suggests_through_the_model_and_keeps_rungs():
    algo = create_algo(build_space(_priors(6, "fidelity(1, 16, 4)")), ASHA_BO, seed=0,
                       device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(5):
        params = algo.suggest(12)
        assert params and all(p["epochs"] in (1, 4, 16) for p in params)
        cube = algo.space.params_to_cube(params)
        algo.observe(params, [{"objective": float(v) + 0.01 * rng.normal()}
                              for v in _objective(cube)])
    assert algo._gp_state is not None
    record = algo.health_record()
    assert record["n_obs"] == 60 and np.isfinite(record["gp_mll"])
    assert len({tuple(sorted(dict(p).items())) for p in params}) == len(params)


def test_asha_bo_low_fidelity_feeds_the_model():
    algo = create_algo(build_space(_priors(4, "fidelity(1, 16, 4)")),
                       {"asha_bo": {"n_init": 100}}, seed=0, device="cpu")
    for fid, s_expect in ((1, 0.0), (4, 0.5), (16, 1.0)):
        params = {f"x{i}": 0.5 for i in range(4)}
        params["epochs"] = fid
        algo.observe([params], [{"objective": 1.0}])
        assert algo._mf_s[-1] == pytest.approx(s_expect, abs=1e-6)
    assert algo._mf_x.shape == (3, 4)


def test_asha_bo_trust_region_shrinks_on_stagnation_and_round_trips():
    cfg = {"asha_bo": {"n_init": 8, "n_candidates": 256, "fit_steps": 5,
                       "trust_region": True, "y_transform": "copula",
                       "tr_fail_tol": 2, "tr_length_init": 0.4}}
    space = build_space(_priors(4, "fidelity(1, 16, 4)"))
    algo = create_algo(space, cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    params = algo.suggest(8)
    algo.observe(params, [{"objective": float(rng.normal())} for _ in params])
    assert algo._tr_length == 0.4  # init batch: no trust-region bookkeeping
    for value in (5.0, 5.0):
        params = algo.suggest(4)
        assert params and all(0.0 <= p["x0"] <= 1.0 for p in params)
        algo.observe(params, [{"objective": value} for _ in params])
    assert algo._tr_length == 0.2
    clone = create_algo(space, cfg, seed=1, device="cpu")
    clone.set_state(algo.state_dict())
    assert clone._tr_length == algo._tr_length and clone._sigma == algo._sigma
    assert clone.suggest(4)


# --- behaviour, as tests/unit/test_asha.py ----------------------------------------


@pytest.fixture
def asha():
    return create_algo(build_space({"x": "uniform(0, 1)", "epochs": "fidelity(1, 9, 3)"}),
                       {"asha": {}}, seed=0, device="cpu")


def test_requires_fidelity():
    with pytest.raises(RuntimeError):
        create_algo(build_space({"x": "uniform(0, 1)"}), "asha", device="cpu")


def test_promotion_needs_reduction_factor_points(asha):
    assert [r["resources"] for r in asha.brackets[0].rungs] == [1, 3, 9]
    pts = [asha.suggest(1)[0] for _ in range(2)]
    asha.observe(pts, [{"objective": float(i)} for i in range(2)])
    nxt = asha.suggest(1)[0]
    assert nxt["epochs"] == 1  # still sampling, no promotion yet
    asha.observe([nxt], [{"objective": 2.0}])
    promoted = asha.suggest(1)[0]
    assert promoted["epochs"] == 3 and promoted["x"] == pts[0]["x"]


def test_promotion_chain_to_top_and_is_done(asha):
    seen = []
    for _ in range(50):
        p = asha.suggest(1)[0]
        seen.append(p["epochs"])
        if p["epochs"] == 9:
            assert not asha.is_done  # promoted but unevaluated top-rung point
        asha.observe([p], [{"objective": p["x"]}])
        if asha.is_done:
            break
    assert asha.is_done and 3 in seen and 9 in seen and len(seen) <= 15


def test_no_double_promotion(asha):
    pts = [asha.suggest(1)[0] for _ in range(3)]
    asha.observe(pts, [{"objective": float(i)} for i in range(3)])
    a, b = asha.suggest(1)[0], asha.suggest(1)[0]
    assert a["epochs"] == 3
    assert not (b["epochs"] == 3 and b["x"] == a["x"])


def test_state_roundtrip_promotes_the_same_point(asha):
    pts = [asha.suggest(1)[0] for _ in range(3)]
    asha.observe(pts, [{"objective": float(i)} for i in range(3)])
    fresh = create_algo(asha.space, {"asha": {}}, seed=42, device="cpu")
    fresh.set_state(asha.state_dict())
    assert asha.suggest(1)[0] == fresh.suggest(1)[0]


def test_unknown_point_routes_to_bottom_rung_bracket():
    hb = create_algo(build_space({"x": "uniform(0, 1)", "epochs": "fidelity(1, 9, 3)"}),
                     "hyperband", seed=0, device="cpu")
    hb.register_suggestion({"x": 0.42, "epochs": 3})
    assert len(hb.brackets[1].rungs[0]["results"]) == 1  # NOT bracket 0 rung 1
    assert len(hb.brackets[0].rungs[1]["results"]) == 0


def test_hyperband_brackets_receive_observations_and_finish():
    hb = create_algo(build_space({"x": "uniform(0, 1)", "epochs": "fidelity(1, 9, 3)"}),
                     "hyperband", seed=0, device="cpu")
    assert len(hb.brackets) == 3
    for _ in range(200):
        p = hb.suggest(1)[0]
        hb.observe([p], [{"objective": p["x"]}])
        if hb.is_done:
            break
    assert hb.is_done and all(b.rungs[-1]["results"] for b in hb.brackets)
