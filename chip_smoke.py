#!/usr/bin/env python3
"""Drive the PyTorch port (``orion_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and the script exits
non-zero; nothing is caught and passed over):

1. ``device``: the card, its power limit, torch/CUDA and nvcc versions.
2. ``build``: every CUDA source of the port compiled by nvcc for sm_90a,
   all at once (one nvcc per source), with ptxas' register report.
3. kernel checks: each kernel against its plain PyTorch version on the card
   at the main path's shape and the others of ``CASES`` (fails above
   1e-5 * max(1, amplitude)), with CUDA-event times and the card's bound.
4. ``main_path``: the headline round through the public API, at full width
   -- Hartmann6, 130 observed, ``tpu_bo`` with 16384 candidates, 40 fit
   steps, local_frac 0.3, trust region, RFF-Thompson, Matern-5/2, copula --
   one warm-up ``suggest(1024)``, then 5 rounds of observe-16 +
   ``suggest(1024)`` with every kernel's launch count zeroed just before and
   read just after.
5. ``profile``: one more round under ``torch.profiler``: launches, device
   busy time and idle share, each stage's host and device ms from the
   round's own ``suggest.*`` spans, and the top ops.
6. ``regret``: the regret gate's scenario (``BENCH_REGRET_BASELINE.json``)
   through the port, seeds 0-4, judged by the port's copy of the gate.
7. The ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, "device": ...}`` line.

Without a CUDA device it exits with code 1 before printing any result.
"""

import bisect
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and float32
#: rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

#: fused_gram shapes (m, n, d): the main path's first.
CASES = [(16384, 256, 6), (16384, 1024, 6), (4096, 256, 8), (8192, 512, 50),
         (300, 70, 6), (513, 129, 130)]
KINDS = ("matern52", "rbf")

Q = 1024
N_HISTORY = 130
ROUNDS = 5
ALGO = {"n_init": 16, "n_candidates": 16384, "fit_steps": 40, "local_frac": 0.3,
        "prewarm": False}
GLOBAL_MIN = -3.32237  # Hartmann6


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def phase_device():
    from orion_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[-1]
    emit("device", smi=smi_line(), name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc, python=sys.version.split()[0])


def phase_build():
    """Compile every ``csrc/*.cu`` at once, one nvcc each.  ``cached`` names
    the sources whose library this checkout already held (not rebuilt)."""
    from concurrent.futures import ThreadPoolExecutor

    from orion_tpu_torch.ops import _build

    sources = sorted(f[:-3] for f in os.listdir(_build._CSRC) if f.endswith(".cu"))
    cached = [s for s in sources if os.path.exists(_build.library_path(s))]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        paths = list(pool.map(_build.build, sources))
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, path in zip(sources, paths):
        with open(path + ".log") as handle:
            ptxas[name] = [line.strip() for line in handle
                           if "registers" in line or "spill" in line]
    emit("build", seconds=seconds, sources=sources, cached=cached, ptxas=ptxas)


def _graph_ms(fn, calls=20, reps=15):
    """Median device ms of one ``fn()`` call: ``calls`` calls captured in a
    CUDA graph (no host launch overhead), each output kept alive so every
    call writes fresh memory (no L2 reuse), timed by CUDA events over
    ``reps`` replays after a warm-up."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    keep = []
    with torch.cuda.graph(graph):
        for _ in range(calls):
            keep.append(fn())
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph, keep
    return statistics.median(times)


def _eager_ms(fn, reps=30):
    """Median CUDA-event ms of one eager call (host launch cost included)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gram_bound(m, n, d):
    """Least time for ``fused_gram`` on an H100: inputs read once and the
    output written once at 3.35 TB/s, against its float32 operations
    (2d for the cross term, 2 per norm, ~20 for the epilogue) at 67 TFLOP/s."""
    nbytes = 4 * (m * d + n * d + d + 1 + m * n)
    flops = m * n * (2 * d + 4 + 20)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_fused_gram(device):
    from orion_tpu_torch.ops.gram import fused_gram, fused_gram_reference

    gen = torch.Generator(device=device).manual_seed(0)
    cases = []
    for m, n, d in CASES:
        for kind in KINDS:
            xa = torch.rand((m, d), generator=gen, device=device)
            xb = torch.rand((n, d), generator=gen, device=device)
            ils = 0.5 + 2.5 * torch.rand((d,), generator=gen, device=device)
            amp = 0.2 + 2.8 * torch.rand((), generator=gen, device=device)
            got = fused_gram(xa, xb, ils, amp, kind=kind)
            want = fused_gram_reference(xa, xb, ils, amp, kind=kind)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            limit = 1e-5 * max(1.0, float(amp))
            if not err <= limit:
                raise AssertionError(f"fused_gram {kind} {(m, n, d)}: max_abs_err {err} > {limit}")
            bound_ms, bound_by = gram_bound(m, n, d)
            kernel_ms = _graph_ms(lambda: fused_gram(xa, xb, ils, amp, kind=kind))
            cases.append({
                "m": m, "n": n, "d": d, "kind": kind, "max_abs_err": err, "tolerance": limit,
                "ms": kernel_ms, "kernel_ms": kernel_ms,
                "plain_ms": _graph_ms(lambda: fused_gram_reference(xa, xb, ils, amp, kind=kind)),
                "eager_ms": _eager_ms(lambda: fused_gram(xa, xb, ils, amp, kind=kind)),
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            })
    emit("kernel_checks", kernel="fused_gram", cases=cases)
    return cases


def _hartmann6(x):
    from orion_tpu_torch.benchmarks.functions import hartmann6

    return hartmann6(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def _observe(algo, x, y):
    algo.observe([{f"x{i}": float(r[i]) for i in range(6)} for r in x],
                 [{"objective": float(v)} for v in y])


def _make_algo(seed, device, **overrides):
    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.space.dsl import build_space

    space = build_space({f"x{i}": "uniform(0, 1)" for i in range(6)})
    return create_algo(space, {"tpu_bo": dict(ALGO, **overrides)}, seed=seed, device=device)


def phase_main_path(device, q=Q, rounds=ROUNDS, **overrides):
    """bench.py's throughput recipe through the port; returns the launch
    counts of the timed rounds."""
    from orion_tpu_torch.health import DEVICE_HEALTH_FIELDS
    from orion_tpu_torch.ops.gram import fused_gram

    rng = np.random.default_rng(0)
    algo = _make_algo(0, device, **overrides)
    x = rng.uniform(size=(N_HISTORY, 6)).astype(np.float32)
    _observe(algo, x, _hartmann6(x))
    t0 = time.perf_counter()
    algo.suggest(q)  # warm-up: first fit at pad 256, allocator, kernel load
    warmup_ms = (time.perf_counter() - t0) * 1e3
    times = []
    fused_gram.launches = 0
    for _ in range(rounds):
        xn = rng.uniform(size=(16, 6)).astype(np.float32)
        _observe(algo, xn, _hartmann6(xn))
        t0 = time.perf_counter()
        batch = algo.suggest_batch(q)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        cube = batch.cube
        if cube.shape != (q, 6) or not np.isfinite(cube).all():
            raise AssertionError(f"bad rows: shape {cube.shape}")
        if not ((cube >= 0).all() and (cube <= 1).all()):
            raise AssertionError("rows outside the unit cube")
        health = algo.health_record()
        if not all(np.isfinite(health[f]) for f in DEVICE_HEALTH_FIELDS):
            raise AssertionError(f"non-finite health: {health}")
    launches = {"fused_gram": fused_gram.launches}
    if launches["fused_gram"] < rounds:
        raise AssertionError(f"fused_gram launched {launches['fused_gram']} times "
                             f"in {rounds} rounds")
    median = statistics.median(times)
    emit("main_path", q=q, rounds=rounds, round_ms=times, median_round_ms=median,
         suggestions_per_s=q / (median / 1e3), warmup_ms=warmup_ms, launches=launches,
         unique_rows=int(len({tuple(r) for r in cube})),
         health={f: health[f] for f in DEVICE_HEALTH_FIELDS})
    return algo, launches


def phase_profile(algo, q=Q):
    """One more main-path round under ``torch.profiler``: kernels launched,
    the device's busy time (the union of its kernel intervals) against the
    round's wall time, each ``suggest.*`` stage's host and device ms (the
    ``record_function`` spans of ``TPUBO._suggest_cube`` and
    ``_suggest_step``; a kernel counts for the span it starts in), and the
    ops that take the most device and host time.  ``idle_share`` is None
    when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    xn = rng.uniform(size=(16, 6)).astype(np.float32)
    _observe(algo, xn, _hartmann6(xn))
    _sync(algo.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        algo.suggest_batch(q)
        _sync(algo.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # Device-side copies of the spans cover the gaps between their kernels:
    # leave them out of the busy time.
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CUDA and not e.name.startswith("suggest."))
    busy_us, end = 0.0, float("-inf")
    for start, stop in kernels:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    # A stage's device time is that of the kernels that start inside its
    # span.  Not the profiler's per-op tree: the backward passes run on
    # autograd's device thread, outside the main thread's spans.
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CPU and e.name.startswith("suggest."))
    stages = {name: [0.0, 0.0] for _, _, name in spans}
    stages["outside_spans"] = [None, 0.0]
    for start, stop, name in spans:
        stages[name][0] += (stop - start) / 1e3
    starts = [span[0] for span in spans]
    for start, stop in kernels:
        i = bisect.bisect_right(starts, start) - 1
        inside = i >= 0 and start < spans[i][1]
        stages[spans[i][2] if inside else "outside_spans"][1] += (stop - start) / 1e3
    for name in ("suggest.draws", "suggest.fit_gp", "suggest.candidates", "suggest.polish",
                 "suggest.acquire", "suggest.ei_rank", "suggest.select"):
        if name not in stages:
            raise AssertionError(f"the profiled round recorded no {name} span")
    averages = prof.key_averages()

    def top(attr):
        rows = sorted(averages, key=lambda e: getattr(e, attr), reverse=True)[:12]
        return [[e.key, e.count, getattr(e, attr) / 1e3] for e in rows]

    emit("profile", q=q, wall_ms=wall_ms, device_events=len(kernels),
         device_busy_ms=busy_us / 1e3,
         idle_share=(1.0 - busy_us / 1e3 / wall_ms) if kernels else None,
         stage_host_device_ms=stages,
         top_self_device_ms=top("self_device_time_total"),
         top_self_cpu_ms=top("self_cpu_time_total"))


def regret_curve(seed, device, budget=192, q=16, n_init=16, algo_kwargs=None):
    """bench.py's ``run_regret_curve`` through the port."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(size=(n_init, 6)).astype(np.float32)
    y0 = _hartmann6(x0)
    algo = _make_algo(seed, device, **(algo_kwargs or {}))
    _observe(algo, x0, y0)
    best, n_evals = float(np.min(y0)), len(y0)
    curve = [best - GLOBAL_MIN]
    while n_evals < budget:
        step_q = min(q, budget - n_evals)
        params = algo.suggest(step_q)
        xn = np.asarray([[p[f"x{i}"] for i in range(6)] for p in params], np.float32)
        yn = _hartmann6(xn)
        _observe(algo, xn, yn)
        best = min(best, float(np.min(yn)))
        n_evals += step_q
        curve.append(best - GLOBAL_MIN)
    return curve


def phase_regret(device):
    from orion_tpu_torch.benchmarks.regret_gate import evaluate_regret_gate, load_baseline

    path = os.path.join(ROOT, "BENCH_REGRET_BASELINE.json")
    with open(path) as handle:
        config = json.load(handle)["config"]
    baseline = load_baseline(path)
    kwargs = dict(config["algo"]["tpu_bo"])
    curves = [regret_curve(seed, device, budget=config["budget"], q=config["q"],
                           n_init=config["n_init"], algo_kwargs=kwargs)
              for seed in range(len(baseline))]
    verdict = evaluate_regret_gate(curves, baseline)
    emit("regret", final=[c[-1] for c in curves],
         baseline_final=[c[-1] for c in baseline], gate=verdict)
    if not verdict["pass"]:
        raise AssertionError("regret gate failed against BENCH_REGRET_BASELINE.json")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    import orion_tpu_torch.device  # noqa: F401  (precision switches)

    device = torch.device("cuda")
    seconds = {}

    def run(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
        return out

    run("device", phase_device)
    run("build", phase_build)
    cases = run("kernel_checks", check_fused_gram, device)
    algo, launches = run("main_path", phase_main_path, device)
    run("profile", phase_profile, algo)
    run("regret", phase_regret, device)
    emit("seconds", **seconds)

    main_case = next(c for c in cases if (c["m"], c["n"], c["d"]) == CASES[0]
                     and c["kind"] == "matern52")
    kernels = [{
        "name": "fused_gram",
        "route": "cuda",
        "source": "orion_tpu_torch/ops/csrc/gram.cu",
        "replaces": "orion_tpu/ops/gram.py:68",
        "launches": launches["fused_gram"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "shape": list(CASES[0]),
        "cases": cases,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
