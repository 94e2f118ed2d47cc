"""The compiler plane (``orion_tpu_torch/compiler_plane.py``) against
``orion_tpu.compiler_plane`` on the same inputs: the signature helpers, the
registry's recapture attribution (nearest prior, warm/cold flips, cold
start, identical fallback, prewarm coverage), the disabled no-op, the lazy
deduplicated analysis, the memory prediction, and the shared profiler
capture.  Then the acceptance pin: both packages' ``tpu_bo`` run the same
observe/suggest schedule on the CPU, with telemetry on, across fit buckets
64 -> 128 -> 256, q buckets and the warm refit, and the port's registry
entries (family, kind, signature fields, the attributed diffs) equal the
reference's ``COMPILE_REGISTRY``'s.  The history's pow-2 buffers start at
64 rows in both packages, so 64 is the first fit bucket."""

import json
import os

import numpy as np
import pytest
from torch_parity import isolated_telemetry

from orion_tpu import compiler_plane as ref_cp
from orion_tpu_torch import compiler_plane as cp

#: The port's kind for each of the reference's.
KINDS = {"compile": "capture", "prewarm": "prewarm", "retrace": "recapture"}
#: The reference's counter for each of the port's.
COUNTERS = {"cuda_graph.captures": "jax.compiles",
            "cuda_graph.recaptures.attributed": "jax.retraces.attributed",
            "cuda_graph.recaptures.prewarm_covered": "jax.retraces.prewarm_covered"}


@pytest.fixture
def telemetry():
    with isolated_telemetry() as owners:
        cp.COMPILE_REGISTRY.reset()
        ref_cp.COMPILE_REGISTRY.reset()
        yield owners
        cp.COMPILE_REGISTRY.reset()
        ref_cp.COMPILE_REGISTRY.reset()


SHAPES_AND_STATICS = [
    ((64, 3), {"q": 8, "kernel": "matern52", "fit_steps": 40}),
    ((256, 6), {"q": 1024, "trust_region": True, "local_sigma": 0.1, "y_transform": "copula"}),
    ((512, 51), (("fixed_tail_cols", "1"), ("acq", "thompson"))),
]


@pytest.mark.parametrize("shape,statics", SHAPES_AND_STATICS)
def test_signature_helpers_match_the_reference(shape, statics):
    fields = cp.signature_fields(shape, statics)
    assert fields == ref_cp.signature_fields(shape, statics)
    items = tuple(sorted((k, str(v)) for k, v in dict(statics).items()))
    assert cp.fields_from_plan_signature((shape, items)) == \
        ref_cp.fields_from_plan_signature((shape, items))
    assert cp.format_fields(fields) == ref_cp.format_fields(fields)
    other = dict(fields, fit_bucket=2 * fields["fit_bucket"], q="16", warm="False")
    assert cp.diff_fields(fields, other) == ref_cp.diff_fields(fields, other)
    assert cp.diff_fields(fields, dict(fields)) == []


@pytest.mark.parametrize("args", [({"q": "256"}, 4e9, 16e9), ({}, 4e9, 16e9),
                                  ({"q": "256"}, None, 16e9), ({"q": "256"}, 4e9, None),
                                  ({"q": "0"}, 4e9, 16e9), ({"q": "x"}, 4e9, 16e9),
                                  ({"q": "1024"}, 7.1e8, 8.5e10)])
def test_predict_hbm_bound_q_matches_the_reference(args):
    assert cp.predict_hbm_bound_q(*args) == ref_cp.predict_hbm_bound_q(*args)


def _drive(reg):
    """One sequence of recordings; returns every attribution and the
    entries as (family, kind, fields)."""
    out = [
        reg.record_retrace("stacked", {"t_pad": "4"}),
        reg.record_retrace("stacked", {"t_pad": "4"}),
        reg.record_retrace("fused_plan", {"fit_bucket": 64}),
    ]
    reg.record_compile("fused_plan", {"fit_bucket": 64, "q": "256"}, seconds=0.25)
    reg.record_compile("fused_plan", {"fit_bucket": 32, "q": "512"})
    out.append(reg.record_retrace("fused_plan", {"fit_bucket": 128, "q": "256"}, seconds=0.1))
    reg.record_compile("fused_plan", {"fit_bucket": 64, "warm": "True"})
    out.append(reg.record_retrace("fused_plan", {"fit_bucket": 64, "warm": "False"}))
    fields = {"fit_bucket": 64, "q": "256", "warm": "False"}
    reg.record_prewarm("fused_plan", fields, seconds=0.2)
    out.append(reg.record_retrace("fused_plan", dict(fields)))
    out.append(reg.record_retrace("fused_plan", {**fields, "fit_bucket": 128}))
    entries = [(e.family, e.kind, e.fields) for e in reg.entries()]
    summary = reg.summary()
    counts = {k: summary[k] for k in ("compiles", "compile_ms_total", "retraces",
                                      "retraces_attributed", "retraces_prewarm_covered")}
    return out, entries, counts


def test_registry_attributes_as_the_reference(telemetry):
    port_tel, port_flight, ref_tel, ref_flight = telemetry
    got = _drive(cp.CompileRegistry())
    want = _drive(ref_cp.CompileRegistry())
    for mine, theirs in zip(got[0], want[0]):
        changed = [c.replace("jit cache", "graph cache") for c in theirs["changed"]]
        assert mine == dict(theirs, changed=changed)
    assert got[1] == [(family, KINDS[kind], fields) for family, kind, fields in want[1]]
    assert got[2] == want[2]
    for port_name, ref_name in COUNTERS.items():
        assert port_tel.counter_value(port_name) == ref_tel.counter_value(ref_name), port_name
    events = [(e["args"]["changed"], e["args"]["covered_by_prewarm"])
              for e in port_flight.events() if e["kind"] == "cuda_graph.recapture"]
    ref_events = [(e["args"]["changed"].replace("jit cache", "graph cache"),
                   e["args"]["covered_by_prewarm"])
                  for e in ref_flight.events() if e["kind"] == "jax.retrace"]
    assert events == ref_events and len(events) == 7
    spans = [s for s in port_tel.drain_spans() if s["name"] == "cuda_graph.capture"]
    assert [s["args"]["kind"] for s in spans][:3] == ["recapture"] * 3
    assert spans[3]["args"]["signature"] == "fit_bucket=64 q=256"


def test_disabled_telemetry_records_nothing():
    with isolated_telemetry(enabled=False) as (port_tel, *_):
        reg = cp.CompileRegistry()
        assert reg.record_compile("fused_plan", {"fit_bucket": 64}) is None
        assert reg.record_prewarm("fused_plan", {"fit_bucket": 64}) is None
        assert reg.record_retrace("fused_plan", {"fit_bucket": 64}) is None
        assert reg.entries() == []
        assert reg.summary()["compiles"] == 0
        reg.publish_gauges()
        assert port_tel.counter_value("cuda_graph.captures") == 0


def test_analyze_all_dedups_caches_and_honors_the_limit(telemetry):
    reg = cp.CompileRegistry()
    calls = []

    def probe(tag, result):
        def run():
            calls.append(tag)
            return result
        return run

    shared = {"fit_bucket": 64, "q": "256"}
    reg.record_prewarm("fused_plan", shared, analysis_fn=probe("warm", {"flops": 10.0}))
    reg.record_retrace("fused_plan", dict(shared), analysis_fn=probe("retrace", {"flops": 10.0}))
    reg.record_compile("append", {"fit_bucket": 64, "batch": "8"},
                       analysis_fn=probe("append", {"flops": 1.0}))
    assert reg.analyze_all(limit=0) == {"analyzed": 0, "skipped": 2}
    assert calls == []
    assert reg.analyze_all(families=("fused_plan",)) == {"analyzed": 1, "skipped": 0}
    assert calls == ["warm"]
    assert all(e.cost == {"flops": 10.0} for e in reg.entries("fused_plan"))
    assert reg.analyze_all() == {"analyzed": 1, "skipped": 0}
    assert calls == ["warm", "append"]

    def boom():
        raise RuntimeError("analysis failed")

    reg.record_compile("fused_plan", {"fit_bucket": 512}, analysis_fn=boom)
    assert reg.analyze_all() == {"analyzed": 1, "skipped": 0}
    assert reg.entries()[-1].cost is None


def test_summary_predicts_the_memory_bound_q(telemetry, monkeypatch):
    port_tel = telemetry[0]
    monkeypatch.setattr(cp, "device_hbm_capacity", lambda device=None: 16_000_000_000)
    reg = cp.CompileRegistry()
    reg.record_compile("fused_plan", {"fit_bucket": 64, "q": "256"}, seconds=0.5,
                       stats={"pool_bytes": 3e9, "hbm_bytes": 4e9, "graph_nodes": 12})
    summary = reg.summary()
    assert summary["plan_hbm_bytes_max"] == 4e9
    assert summary["hbm_bound_q"] == 1024  # 256 * 16e9 / 4e9
    assert summary["per_plan"][0]["pool_bytes"] == 3e9
    assert summary["per_plan"][0]["graph_nodes"] == 12
    reg.publish_gauges()
    assert port_tel.gauge_value("compiler.hbm_bytes_max") == 4e9
    assert port_tel.gauge_value("compiler.hbm_bound_q") == 1024
    assert port_tel.gauge_value("compiler.capture_ms_total") == 500.0
    # A q=8 round captured later into the same pool reports the pool the
    # q=256 round sized: the prediction still reads the largest-q round.
    reg.record_retrace("fused_plan", {"fit_bucket": 64, "q": "8"},
                       stats={"pool_bytes": 3e9, "hbm_bytes": 4.1e9})
    assert reg.summary()["hbm_bound_q"] == 1024


def test_capacity_is_none_without_an_initialized_card():
    assert cp.device_hbm_capacity() is None


def test_profiler_capture_writes_the_trace_and_its_line(tmp_path, capsys):
    import torch

    directory = str(tmp_path / "trace")
    with pytest.raises(RuntimeError):
        with cp.profiler_capture(directory, device="cpu", span="hunt.workon"):
            torch.ones((4,)).sum()
            raise RuntimeError("the body fails")
    path = os.path.join(directory, f"trace-{os.getpid()}.json")
    assert f"profile: wrote {path}" in capsys.readouterr().err
    with open(path) as handle:
        names = {e.get("name") for e in json.load(handle)["traceEvents"]}
    assert "hunt.workon" in names


# --- the recapture attribution of a real schedule, against the reference ----

ALGO = {"n_init": 16, "n_candidates": 256, "fit_steps": 3, "refit_steps": 2,
        "local_frac": 0.25, "tr_local_m": 1000}
#: (rows observed before the suggest, q): cold at 64 and q 8, warm, q 16,
#: then the fit buckets 128 and 256.
SCHEDULE = [(20, 8), (28, 8), (36, 16), (52, 16), (70, 16), (90, 8), (140, 16)]


def _run_schedule(package, prewarm):
    """Both packages' ``tpu_bo`` through :data:`SCHEDULE` on the CPU
    (Hartmann-like sphere objective, random rows observed before each
    suggest); returns the fused_plan family's entries as (kind, fields)
    and the attributions' changes."""
    rng = np.random.default_rng(0)
    config = {"tpu_bo": dict(ALGO, prewarm=prewarm)}
    if package == "ref":
        import jax

        from orion_tpu.algo.base import create_algo as ref_create_algo
        from orion_tpu.space.dsl import build_space as ref_build_space

        jax.clear_caches()
        algo = ref_create_algo(ref_build_space({f"x{i}": "uniform(0, 1)" for i in range(3)}),
                               config, seed=0)
        registry = ref_cp.COMPILE_REGISTRY
    else:
        from orion_tpu_torch.algo.base import create_algo
        from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS
        from orion_tpu_torch.space.dsl import build_space

        STEP_GRAPHS.reset()
        algo = create_algo(build_space({f"x{i}": "uniform(0, 1)" for i in range(3)}), config,
                           seed=0, device="cpu")
        registry = cp.COMPILE_REGISTRY
    observed = 0
    for target, q in SCHEDULE:
        rows = rng.uniform(size=(target - observed, 3)).astype(np.float32)
        algo.observe_arrays(rows, ((rows - 0.3) ** 2).sum(axis=1))
        algo._prewarmer.wait()
        observed = target
        algo.suggest_batch(q)
        algo._prewarmer.wait()
    entries = []
    for entry in registry.entries("fused_plan"):
        fields = {k: v for k, v in entry.fields.items() if k != "mesh"}
        entries.append((entry.kind, fields))
    return entries


@pytest.mark.parametrize("prewarm", [False, True], ids=["no-prewarm", "prewarm"])
def test_recapture_attribution_matches_the_reference(telemetry, prewarm):
    port_tel, port_flight, ref_tel, ref_flight = telemetry
    got = _run_schedule("port", prewarm)
    want = _run_schedule("ref", prewarm)
    assert got == [(KINDS[kind], fields) for kind, fields in want]
    changes = [e["args"]["changed"] for e in port_flight.events()
               if e["kind"] == "cuda_graph.recapture"]
    ref_changes = [e["args"]["changed"] for e in ref_flight.events()
                   if e["kind"] == "jax.retrace" and e["args"]["family"] == "fused_plan"]
    assert changes == ref_changes
    buckets = [fields["fit_bucket"] for _kind, fields in got]
    assert {64, 128, 256} <= set(buckets)
    if prewarm:
        # The 64 -> 128 crossing was warmed at 52 of 64 rows; the jump from
        # 90 to 140 rows lands at 256 with no warm in either package.
        assert ("prewarm", {**got[2][1], "fit_bucket": 128}) in got
        assert "fit_bucket 64→128" not in changes and "fit_bucket 128→256" in changes
    else:
        assert "fit_bucket 64→128" in changes and "fit_bucket 128→256" in changes
    assert port_tel.counter_value("cuda_graph.recaptures") == \
        ref_tel.counter_value("jax.retraces")
