"""The bucket prewarmer (``orion_tpu_torch/algo/prewarm.py`` and the
``tpu_bo``/``asha_bo`` hooks) against ``orion_tpu.algo.prewarm``: the bucket
planners on the same inputs, the runner's dedup and failure counting with
fake closures, the inventory, and on the CPU (where a prewarm marks the
signature as seen) the crossings a prewarm covers: zero recaptures with
``prewarm=True``, one attributed ``fit_bucket 64→128`` without, and a
fixed-tail (``asha_bo``) signature warmed exactly as its rounds need it."""

import itertools

import numpy as np
import pytest
from torch_parity import isolated_telemetry

from orion_tpu.algo import prewarm as ref_prewarm
from orion_tpu_torch.algo import prewarm
from orion_tpu_torch.algo.base import create_algo
from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS
from orion_tpu_torch.compiler_plane import COMPILE_REGISTRY
from orion_tpu_torch.space.dsl import build_space

COUNTS = [0, 1, 20, 40, 47, 48, 60, 64, 65, 90, 96, 100, 127, 250, 300, 1500, 4000]
BATCHES = [0, 8, 16, 64, 1024]


@pytest.mark.parametrize("fill", [0.75, 0.25])
def test_plan_next_bucket_matches_the_reference(fill):
    for count, batch in itertools.product(COUNTS, BATCHES):
        assert prewarm.plan_next_bucket(count, floor=64, fill=fill, batch=batch) == \
            ref_prewarm.plan_next_bucket(count, floor=64, fill=fill, batch=batch), (count, batch)


@pytest.mark.parametrize("trust_region,tr_local_m",
                         [(True, 256), (True, 300), (True, 20), (False, None), (False, 256)])
def test_plan_fused_step_bucket_matches_the_reference(trust_region, tr_local_m):
    for count, batch in itertools.product(COUNTS, BATCHES):
        kw = dict(floor=64, batch=batch, trust_region=trust_region, tr_local_m=tr_local_m)
        assert prewarm.plan_fused_step_bucket(count, **kw) == \
            ref_prewarm.plan_fused_step_bucket(count, **kw), (count, batch)


def test_prewarmer_dedups_and_counts_failures():
    warmer = prewarm.BucketPrewarmer()
    base = prewarm.completed_prewarm_count()
    calls = []
    assert warmer.maybe_start("k1", lambda: calls.append(1)) is True
    warmer.wait()
    assert warmer.maybe_start("k1", lambda: calls.append(2)) is False
    warmer.wait()
    assert calls == [1]

    def boom():
        raise RuntimeError("capture failed")

    assert warmer.maybe_start("k2", boom) is True
    warmer.wait()  # must not raise
    assert not warmer.in_flight
    assert warmer.completed_count() == 2 and warmer.failed_count() == 1
    assert prewarm.completed_prewarm_count() == base + 2
    inventory = prewarm.prewarm_inventory()
    assert inventory["started"] >= 2 and inventory["completed"] >= base + 2


def test_a_prewarm_books_its_counter_span_and_flight_event():
    with isolated_telemetry() as (telemetry, flight, _ref_tel, _ref_flight):
        warmer = prewarm.BucketPrewarmer()
        warmer.maybe_start(("sig", 1), lambda: None)
        warmer.wait()
        warmer.maybe_start(("sig", 2), lambda: 1 / 0)
        warmer.wait()
        assert telemetry.counter_value("cuda_graph.prewarms") == 1
        assert [s["name"] for s in telemetry.drain_spans()] == ["cuda_graph.prewarm.capture"]
        assert [e["kind"] for e in flight.events()] == ["cuda_graph.prewarm"]


def _tpu_bo(prewarm_on, **kw):
    space = build_space({f"x{i}": "uniform(0, 1)" for i in range(3)})
    config = {"tpu_bo": dict({"n_init": 16, "n_candidates": 256, "fit_steps": 3,
                              "local_frac": 0.25, "prewarm": prewarm_on}, **kw)}
    return create_algo(space, config, seed=1, device="cpu")


def _observe(algo, rng, n):
    rows = rng.uniform(size=(n, algo.space.n_cols)).astype(np.float32)
    algo.observe_arrays(rows, ((rows - 0.3) ** 2).sum(axis=1))
    algo._prewarmer.wait()


@pytest.fixture
def telemetry():
    with isolated_telemetry() as owners:
        COMPILE_REGISTRY.reset()
        STEP_GRAPHS.reset()
        yield owners
        COMPILE_REGISTRY.reset()


@pytest.mark.parametrize("prewarm_on", [True, False], ids=["prewarm", "no-prewarm"])
def test_crossing_64_to_128_pays_a_recapture_only_without_prewarm(telemetry, prewarm_on):
    telemetry_port = telemetry[0]
    algo = _tpu_bo(prewarm_on)
    rng = np.random.default_rng(2)
    _observe(algo, rng, 40)
    algo.suggest_batch(16)  # the q bucket the prewarmer warms
    before = telemetry_port.counter_value("cuda_graph.recaptures")
    _observe(algo, rng, 16)  # 56 of 64: the prewarm starts at 48
    algo.suggest_batch(16)
    _observe(algo, rng, 16)  # 72: the fit buffer is 128
    assert algo._hist.fit_view()[0].shape[0] == 128
    algo.suggest_batch(16)
    recaptures = [e for e in COMPILE_REGISTRY.entries() if e.kind == "recapture"]
    if prewarm_on:
        assert telemetry_port.counter_value("cuda_graph.recaptures") == before
        assert [e.fields["fit_bucket"] for e in COMPILE_REGISTRY.entries()
                if e.kind == "prewarm"] == [128]
    else:
        assert telemetry_port.counter_value("cuda_graph.recaptures") == before + 1
        changes = [e["args"]["changed"] for e in telemetry[1].events()
                   if e["kind"] == "cuda_graph.recapture"]
        assert changes[-1] == "fit_bucket 64→128"
        assert recaptures[-1].fields["fit_bucket"] == 128


def test_asha_bo_prewarm_covers_its_fixed_tail_signature(telemetry):
    """``asha_bo``'s rounds score with the fidelity column pinned
    (``fixed_tail_cols=1``, best_x without it): a prewarm captures the
    signature its rounds ask for, so no recapture is ever of a warmed
    signature, and a round at the warmed 128-row buffer replays it."""
    space = build_space({"x0": "uniform(0, 1)", "x1": "uniform(0, 1)",
                         "budget": "fidelity(1, 16, 4)"})
    algo = create_algo(space, {"asha_bo": {"n_init": 8, "n_candidates": 128, "fit_steps": 2,
                                           "prewarm": True}}, seed=3, device="cpu")
    for _round in range(12):
        params = algo.suggest(8)
        cube = space.params_to_cube(params)
        algo.observe(params, [{"objective": float(v)} for v in (cube ** 2).sum(axis=1)],
                     cube=cube)
        algo._prewarmer.wait()
    warmed = [e.fields for e in COMPILE_REGISTRY.entries() if e.kind == "prewarm"]
    assert any(fields["fit_bucket"] == 128 for fields in warmed)
    assert all(fields["fixed_tail_cols"] == "1" and fields["width"] == 3 for fields in warmed)
    assert COMPILE_REGISTRY.summary()["retraces_prewarm_covered"] == 0
    hits = [s["args"]["n"] for s in telemetry[0].drain_spans()
            if s["name"] == "suggest_step.dispatch"]
    assert 128 in hits
