"""The port's benchmark library (``orion_tpu_torch/benchmarks``) against the
reference's (``orion_tpu/benchmarks``) on the CPU.

- The runner's presets equal the reference's key by key; ``run_preset``
  hands ``optimize`` the reference's arguments for every preset, with and
  without ``algo_overrides={"use_mesh": True}`` (the objective compared by
  name), and prints the same stderr skip lines; ``run_preset_seeds``
  aggregates the same injected rows to the same numbers; ``main`` refuses
  the same argument mixes with ``SystemExit(2)`` and dispatches ``--op``.
- ``suggest_bench``: the shapes, ``_step_kwargs`` and the inputs of
  ``_make_args`` equal the reference's; one round at d=6, 40 observed, 512
  candidates, 5 fit steps and q=16 through both ``_suggest_step``s on the
  reference's draws (replayed by ``torch_parity.jax_suggest_draws``): rows
  within 1e-5, the bar ``test_torch_suggest_step.py`` holds at d=6; the
  bench itself runs at a reduced shape on the CPU.
- ``gram_bench``: rows with the port's keys, and the kernel path's outputs
  within 1e-5 of the reference's ``kernel_matrix`` on the same draws.
- ``mixed-lenet`` at 48 trials reaches regret < 1.0 (the reference's bar,
  ``tests/unit/test_algos.py``); the reference's runner smoke test and a
  ``host_profile`` run at 40 trials, beside the reference's.
- ``chip_smoke.py`` takes every run named like a preset from ``PRESETS``.
"""

import ast
import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.algo import tpu_bo as jbo
from orion_tpu.algo.gp.kernels import kernel_matrix as jax_kernel_matrix
from orion_tpu.benchmarks import host_profile as jhp
from orion_tpu.benchmarks import runner as jrun
from orion_tpu.benchmarks import suggest_bench as jsb
from orion_tpu_torch import benchmarks as tbench
from orion_tpu_torch.algo import tpu_bo as tbo
from orion_tpu_torch.benchmarks import gram_bench as tgb
from orion_tpu_torch.benchmarks import host_profile as thp
from orion_tpu_torch.benchmarks import runner as trun
from orion_tpu_torch.benchmarks import suggest_bench as tsb

from torch_parity import jax_suggest_draws

PRESET_NAMES = list(jrun.PRESETS)


def test_package_reexports_the_reference_names():
    from orion_tpu import benchmarks as jbench

    assert tbench.__all__ == jbench.__all__
    assert sorted(tbench.BENCHMARKS) == sorted(jbench.BENCHMARKS)
    for name in tbench.__all__[:-1]:
        assert getattr(tbench, name).__name__ == getattr(jbench, name).__name__


def test_presets_equal_the_reference_key_by_key():
    assert list(trun.PRESETS) == PRESET_NAMES and len(PRESET_NAMES) == 11
    for name in PRESET_NAMES:
        ref, port = jrun.PRESETS[name], trun.PRESETS[name]
        assert list(port) == list(ref), name
        for key, value in ref.items():
            if callable(value):
                assert port[key].__name__ == value.__name__, (name, key)
            else:
                assert port[key] == value, (name, key)
    assert trun._ackley50_priors() == jrun._ackley50_priors()


@pytest.mark.parametrize("act", ["relu", "tanh", "gelu"])
def test_mixed_lenet_objective_equals_the_reference_on_a_grid(act):
    for lr in (1e-4, 3e-4, 1e-3, 1e-2, 5e-2, 1e-1):
        for batch_size in (32, 100, 128, 200, 256):
            for width in (1, 2, 3, 4):
                params = {"lr": lr, "batch_size": batch_size, "width": width, "act": act}
                assert (trun._mixed_lenet_objective(params)
                        == jrun._mixed_lenet_objective(params))


STATS = {"best_evaluation": 1.25, "trials_completed": 40}
#: The presets' algorithms whose constructors take no ``use_mesh``.
MESHLESS = {"random", "asha", "cmaes", "de"}


def _recorder(calls):
    def optimize(**kwargs):
        calls.append(kwargs)
        return dict(STATS)

    return optimize


def _comparable(kwargs):
    out = dict(kwargs)
    for key in ("fn", "batch_eval"):
        out[key] = None if out[key] is None else out[key].__name__
    return out


@pytest.mark.parametrize("use_mesh", [False, True], ids=["plain", "use_mesh"])
@pytest.mark.parametrize("name", PRESET_NAMES)
def test_run_preset_passes_the_reference_arguments_to_optimize(name, use_mesh, monkeypatch,
                                                               capsys):
    ref_calls, port_calls = [], []
    monkeypatch.setattr(jrun, "optimize", _recorder(ref_calls))
    monkeypatch.setattr(trun, "optimize", _recorder(port_calls))
    overrides = {"use_mesh": True} if use_mesh else None
    ref = jrun.run_preset(name, seed=3, algo_overrides=overrides)
    ref_err = capsys.readouterr().err
    port = trun.run_preset(name, seed=3, algo_overrides=overrides, device="cpu")
    port_err = capsys.readouterr().err
    (ref_kw,), (port_kw,) = ref_calls, port_calls
    assert port_kw.pop("device") == "cpu"
    assert _comparable(port_kw) == _comparable(ref_kw)
    assert port_err == ref_err
    algorithm = ref_kw["algorithm"]
    (algo,) = algorithm if isinstance(algorithm, dict) else [algorithm]
    assert bool(port_err) == (use_mesh and algo in MESHLESS)
    for key in ("preset", "best", "simple_regret", "trials"):
        assert port[key] == ref[key]


ROWS = [
    [{"simple_regret": 2.5, "suggestions_per_sec": 10.0, "wall_s": 1.0}],
    [{"simple_regret": r, "suggestions_per_sec": s, "wall_s": w}
     for r, s, w in [(3.0, 5.0, 1.5), (1.0, 7.0, 2.0), (4.5, 6.0, 0.5), (2.0, 9.0, 1.25),
                     (9.75, 8.0, 3.0)]],
    [{"simple_regret": r, "suggestions_per_sec": s, "wall_s": 1.0}
     for r, s in [(0.5, 1.0), (None, 2.0), (0.125, 3.0), (7.0, 4.0), (0.25, 5.0), (1.5, 6.0),
                  (3.25, 7.0)]],
]


@pytest.mark.parametrize("rows", ROWS, ids=["one", "five", "seven-with-none"])
def test_run_preset_seeds_aggregates_as_the_reference(rows, monkeypatch):
    def fake(name, seed=0, algo_overrides=None, device=None, **overrides):
        return dict(rows[seed], preset=name)

    monkeypatch.setattr(jrun, "run_preset", fake)
    monkeypatch.setattr(trun, "run_preset", fake)
    ref = jrun.run_preset_seeds("random-branin", len(rows))
    port = trun.run_preset_seeds("random-branin", len(rows), device="cpu")
    assert port == ref


@pytest.mark.parametrize("argv", [
    ["--op", "gram", "random-branin"],
    ["--op", "suggest", "mixed-lenet", "random-branin"],
    ["--kind", "rbf"],
    ["--reps", "3", "random-branin"],
    ["--seeds", "0"],
    ["--seeds", "-2", "random-branin"],
    ["no-such-preset"],
], ids=["op-with-preset", "op-with-presets", "kind-without-op", "reps-without-op", "seeds-0",
        "seeds-negative", "unknown-preset"])
def test_main_refuses_the_reference_argument_mixes(argv, capsys):
    with pytest.raises(SystemExit) as ref:
        jrun.main(argv)
    with pytest.raises(SystemExit) as port:
        trun.main(argv + ["--device", "cpu"])
    assert ref.value.code == port.value.code == 2
    assert capsys.readouterr().err.count("error:") == 2


@pytest.mark.parametrize("op", ["gram", "suggest"])
def test_main_dispatches_op_with_kind_reps_and_device(op, monkeypatch):
    calls = []
    module = tgb if op == "gram" else tsb
    target = "run_gram_bench" if op == "gram" else "run_suggest_bench"
    monkeypatch.setattr(module, target, lambda **kw: calls.append(kw))
    trun.main(["--op", op, "--kind", "rbf", "--reps", "3", "--device", "cpu"])
    key = "kind" if op == "gram" else "kernel"
    assert calls == [{key: "rbf", "reps": 3, "device": "cpu"}]


def test_main_prints_a_line_per_preset_as_the_reference(capsys):
    trun.main(["random-branin", "--seeds", "2", "--device", "cpu"])
    port = json.loads(capsys.readouterr().out)
    jrun.main(["random-branin", "--seeds", "2"])
    ref = json.loads(capsys.readouterr().out)
    assert sorted(port) == sorted(ref)
    assert port["seeds"] == ref["seeds"] == 2 and len(port["regret_per_seed"]) == 2


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: trun.run_preset("random-branin", max_trials=10, batch_size=10),
                 lambda: tgb.run_gram_bench(shapes=[(8, 4, 2)]),
                 lambda: tsb.device_seconds("hartmann6-q1024"),
                 lambda: tsb.run_suggest_bench()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("shape", list(jsb.SHAPES))
def test_suggest_bench_shapes_step_kwargs_and_inputs_equal_the_reference(shape):
    assert tsb.SHAPES == jsb.SHAPES
    cfg = tsb.SHAPES[shape]
    for kernel in ("matern52", "rbf"):
        assert tsb._step_kwargs(cfg, kernel=kernel) == jsb._step_kwargs(cfg, kernel=kernel)
    ref = jsb._make_args(cfg, np.random.default_rng(0))
    port = tsb._make_args(cfg, np.random.default_rng(0))
    for got, want in zip(port[1:5], ref[1:5]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert port[6] == pytest.approx(float(ref[6]))
    plan = tsb._plan(port, tsb._step_kwargs(cfg))
    hypers = plan.arrays[5]
    for got, want in zip(hypers, ref[5]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(plan.arrays[6]) == pytest.approx(float(ref[6]))
    assert plan.statics["q"] == cfg["q"] and plan.statics["fit_steps"] == cfg["fit_steps"]


SMALL = dict(d=6, n_obs=40, q=16, n_candidates=512, fit_steps=5, fixed_tail_cols=0,
             rounds_per_run=None)


@pytest.mark.parametrize("kernel", ["matern52", "rbf"])
def test_suggest_bench_round_matches_the_reference(kernel):
    """One round of the bench's plan at a reduced shape through both
    packages' ``_suggest_step`` on the reference's draws of ``PRNGKey(0)``."""
    ref_args = jsb._make_args(SMALL, np.random.default_rng(0))
    step_j = jsb._step_kwargs(SMALL, kernel=kernel)
    rows_j, _ = jbo._suggest_step(*ref_args, **step_j)
    plan = tsb._plan(tsb._make_args(SMALL, np.random.default_rng(0)),
                     tsb._step_kwargs(SMALL, kernel=kernel))
    draws = jax_suggest_draws(
        ref_args[0], q=SMALL["q"], n_candidates=SMALL["n_candidates"], d_free=SMALL["d"],
        d=SMALL["d"], acq="thompson", local_frac=0.5, trust_region=True, tr_perturb_dims=20)
    rows_t, _ = tbo._suggest_step(draws, *plan.arrays[1:], **plan.statics)
    assert rows_t.shape == (SMALL["q"], SMALL["d"])
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), atol=1e-5)


SUGGEST_ROW_KEYS = {
    "shape", "n_obs", "q", "n_candidates", "fit_steps", "device_ms", "wall_ms", "host_ms",
    "public_api_ms", "gflops_per_call", "gflops_label", "achieved_tflops", "mfu_vs_f32_peak",
    "plan_hbm_bytes", "hbm_bound_q", "backend", "device",
}


def test_suggest_bench_runs_on_the_cpu_at_a_reduced_shape(monkeypatch, capsys):
    tiny = dict(SMALL, n_obs=64)
    monkeypatch.setattr(tsb, "SHAPES", {"tiny": tiny, "tiny-tail": dict(tiny, d=7,
                                                                          fixed_tail_cols=1)})
    rows = tsb.run_suggest_bench(reps=2, device="cpu")
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows and [r["shape"] for r in rows] == ["tiny", "tiny-tail"]
    for row in rows:
        assert set(row) == SUGGEST_ROW_KEYS
        assert row["backend"] == row["device"] == "cpu"
        assert row["device_ms"] > 0 and row["wall_ms"] > 0 and row["gflops_per_call"] > 0
        assert row["mfu_vs_f32_peak"] is None and row["plan_hbm_bytes"] is None
    assert rows[0]["public_api_ms"] > 0 and rows[1]["public_api_ms"] is None
    assert tsb.device_seconds("tiny", reps=2, device="cpu") > 0


GRAM_ROW_KEYS = {"op", "kind", "m", "n", "d", "backend", "device", "plain_ms", "kernel_ms",
                 "speedup", "max_abs_err", "bound_ms", "bound_by", "bound_share"}
GRAM_SHAPES = [(64, 16, 8), (96, 40, 50)]


@pytest.mark.parametrize("kind", ["matern52", "rbf"])
def test_gram_bench_rows_and_outputs_match_the_reference(kind, monkeypatch, capsys):
    outputs, original = {}, tgb.fused_gram

    def recording(xa, xb, inv_ls, amp, *, kind):
        out = original(xa, xb, inv_ls, amp, kind=kind)
        outputs.setdefault((xa.shape[0], xb.shape[0], xa.shape[1]), out)
        return out

    monkeypatch.setattr(tgb, "fused_gram", recording)
    rows = tgb.run_gram_bench(kind=kind, reps=1, device="cpu", shapes=GRAM_SHAPES)
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == rows
    rng = np.random.default_rng(0)
    for row, (m, n, d) in zip(rows, GRAM_SHAPES):
        assert set(row) == GRAM_ROW_KEYS
        assert (row["m"], row["n"], row["d"], row["kind"]) == (m, n, d, kind)
        assert row["backend"] == row["device"] == "cpu" and row["bound_share"] is None
        assert row["max_abs_err"] <= 1e-5
        xa, xb = rng.uniform(size=(m, d)), rng.uniform(size=(n, d))
        rng.normal(size=(n,))
        want = jax_kernel_matrix(kind, jnp.asarray(xa, jnp.float32), jnp.asarray(xb, jnp.float32),
                                 jnp.ones((d,), jnp.float32) * 2.0, jnp.asarray(1.0, jnp.float32))
        np.testing.assert_allclose(outputs[(m, n, d)].numpy(), np.asarray(want), atol=1e-5)


def test_gram_bound_is_the_larger_of_bytes_and_operations():
    ms, by = tgb.gram_bound(16384, 256, 6)
    assert by == "bytes" and ms == pytest.approx(tgb.gram_bytes(16384, 256, 6) / 3.35e12 * 1e3)
    ms, by = tgb.gram_bound(8192, 512, 51)
    assert by == "operations"
    assert ms == pytest.approx(8192 * 512 * (2 * 51 + 24) / 67e12 * 1e3)


def test_mixed_lenet_preset_converges_small_on_the_cpu():
    out = trun.run_preset("mixed-lenet", seed=0, max_trials=48, batch_size=16, device="cpu")
    assert out["trials"] == 48
    assert out["simple_regret"] < 1.0


def test_runner_preset_smoke_as_the_reference():
    trun.PRESETS["smoke"] = dict(
        priors={"x0": "uniform(0, 1)", "x1": "uniform(0, 1)"},
        fn="branin", algorithm="random", max_trials=20, batch_size=10,
    )
    try:
        out = trun.run_preset("smoke", device="cpu")
    finally:
        del trun.PRESETS["smoke"]
    assert out["trials"] == 20
    assert out["simple_regret"] is not None


def _profile_output(main, argv):
    stream = io.StringIO()
    with contextlib.redirect_stdout(stream):
        main(argv)
    return stream.getvalue()


def test_host_profile_prints_the_result_and_a_tottime_table():
    argv = ["random-branin", "--trials", "40", "--batch", "10", "--top", "5"]
    port = _profile_output(thp.main, argv + ["--device", "cpu"])
    ref = _profile_output(jhp.main, argv)
    for text in (port, ref):
        first, rest = text.split("\n", 1)
        result = ast.literal_eval(first)  # the result dict, printed as the reference does
        assert result["preset"] == "random-branin" and result["trials"] == 40
        assert "tottime" in rest
        header = rest.index("tottime")
        table = [line for line in rest[header:].splitlines()[1:] if line.strip()]
        assert 1 <= len(table) <= 5


def test_chip_smoke_runs_named_like_presets_equal_the_presets():
    import chip_smoke

    named = 0
    for run, priors, fn_name, config, max_trials, batch, _seeds in chip_smoke.algo_runs():
        if run not in trun.PRESETS:
            continue
        named += 1
        preset = trun.PRESETS[run]
        algorithm = preset["algorithm"]
        if not isinstance(algorithm, dict):
            algorithm = {algorithm: {}}
        assert (priors, fn_name, config, max_trials, batch) == (
            preset["priors"], preset["fn"], algorithm, preset["max_trials"],
            preset["batch_size"]), run
    assert named == 6
    for run, priors, fn_name, config, batch, _rounds in chip_smoke.mesh_algo_runs():
        preset = trun.PRESETS.get(f"{run}-ackley50")
        if preset is not None:
            assert (priors, fn_name, config, batch) == (
                preset["priors"], preset["fn"], preset["algorithm"], preset["batch_size"])


def _profiled_trace(path):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("hunt.workon"):
            a = torch.randn(64, 64)
            for m in (16, 32):
                with record_function(f"fused_gram {m}x8x2"):
                    a = a @ a
            with record_function("void f<{lambda(float)#1}, 4>(float, float)"):
                torch.relu(a)
    prof.export_chrome_trace(str(path))


def test_chip_smoke_scans_a_trace_as_the_json_parse_reads_it(tmp_path):
    """``chip_smoke.trace_events`` (a scan for the kernel and user_annotation
    events) returns what parsing the whole trace returns, on the profiler's
    own output and on a trace whose fields come in another order (the scan
    finds fewer than the text holds, and the JSON parse is used)."""
    import chip_smoke

    path = tmp_path / "trace-1.json"
    _profiled_trace(path)
    text = path.read_text()
    want = chip_smoke.json_trace_events(text)
    names = {name for _cat, name, _ts, _dur in want}
    assert {"hunt.workon", "fused_gram 16x8x2",
            "void f<{lambda(float)#1}, 4>(float, float)"} <= names
    assert chip_smoke.trace_events(str(path)) == want
    events = json.loads(text)["traceEvents"]
    kernel = {"ph": "X", "cat": "kernel", "name": "void gram_kernel<0>(float)", "pid": 0,
              "tid": 7, "ts": 12.5, "dur": 3.25, "args": {"grid": [1, 1, 1]}}
    reordered = [{"dur": e["dur"], **{k: v for k, v in e.items() if k != "dur"}}
                 if e.get("cat") == "user_annotation" else e for e in events] + [kernel]
    other = tmp_path / "trace-2.json"
    other.write_text(json.dumps({"traceEvents": reordered}, indent=1))
    got = chip_smoke.trace_events(str(other))
    assert got == chip_smoke.json_trace_events(other.read_text())
    assert ("kernel", kernel["name"], 12.5, 3.25) in got and len(got) == len(want) + 1
    # No kernel ran on the CPU: two ranges and no launch are a mismatch.
    with pytest.raises(AssertionError, match="0 gram_kernel launches, 2 fused_gram ranges"):
        chip_smoke.read_worker_trace(str(path))
