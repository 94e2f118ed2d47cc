#!/usr/bin/env python3
"""Drive the PyTorch port (``orion_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--fleet-off-first]

Phases, one JSON line each (any failure raises and the script exits
non-zero; nothing is caught and passed over):

1. ``device``: the card, its power limit, torch/CUDA and nvcc versions.
2. ``build``: every CUDA source of the port compiled by nvcc for sm_90a,
   all at once (one nvcc per source), with ptxas' register report.
3. kernel checks: each kernel against its plain PyTorch version on the card
   at the main path's shape and the others of ``CASES`` (fails above
   1e-5 * max(1, amplitude)), with CUDA-event times, the card's bound, the
   achieved bytes/s and share of that bound, and ``fill_ms``: one
   ``fill_`` of an output of the same size, the card's practical floor for
   writing that many bytes in one launch (a yardstick only).
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
7. ``algorithms``: every other algorithm of the registry on the card, each
   at its benchmark preset (``ALGO_RUNS``), in a plain loop of
   ``suggest(batch)``, host evaluation and ``observe`` until the trial
   budget or ``is_done``; one JSON line per run with its trials, rounds,
   wall time, median suggest ms, suggestions/s and final simple regret
   (beside the reference's median regret where ``BENCH_SEEDS.json`` has the
   preset).  It checks that every row decodes inside the space, that no
   round repeats a point, that ``asha_bo`` on Ackley-50D launched
   ``fused_gram`` on its chunked path (8192 x 512 x 51), and that each
   ``asha_bo`` seed ends below regret 20.0.
8. ``hunt``: the library entry point, ``optimize()``, through the producer
   and storage at the main path's full width -- Hartmann6, ``tpu_bo`` as in
   4., q=1024, 5 rounds (one random, four GP) -- once on ``pickled`` storage
   and once on ``memory``, each a JSON line with the per-round median ms of
   the producer's suggest, register and observe, of its sync with storage,
   reserve, ``batch_eval`` and completion, the round, suggestions/s and the
   final regret, beside the plain loop's round of 4.; ``fused_gram`` zeroed
   before each run and launched at least once per GP round (at 16384 x 256
   x 6).  Then two worker processes run ``ExperimentClient`` loops at
   q=1024 on one ``pickled`` file, 6144 trials, each keeping one batch in
   evaluation while it asks for the next, so that from the third round on
   each producer lies about the batches in flight: no trial reserved
   twice, each completed once, ids unique.  Last the regret gate's
   scenario through ``optimize()``, judged by the port's gate.
9. ``cli``: ``orion-tpu-torch hunt`` over a pure-Python Hartmann6 user
   script (one subprocess a trial) with the main path's ``tpu_bo``.  First
   one worker in this process on SQLite, ``--pool-size 1024``, 1280 trials
   (a random round of 1024, then a GP round of which 256 run), the
   kernel's launch shapes counted over the call (a launch at 16384 x 256
   x 6), with each trial's subprocess, reservation, completion and status
   reads timed.  Then ``--n-workers 8 --profile`` as a subprocess on a
   fresh SQLite file, 3072 trials: no trial run twice (the script logs
   each execution), lies registered, the kernel counted in the workers'
   profiler traces, with each worker's device busy time and idle share.
   Last the regret gate's scenario through the CLI on ``pickled``, the
   five seeds at once, judged by the port's gate.  Every objective the
   script reported must equal the port's Hartmann6 on the card.
10. ``evc``: experiment version control through the CLI on the ``cli``
   phase's one-worker store.  ``hunt -n cli`` again with ``x0 ~ uniform(0,
   0.5)`` branches version 2 (a prior change), then with ``x1`` narrowed as
   well version 3; each runs 256 trials of its own at ``--pool-size 1024``.
   Each child's producer fetches its ancestors' trials through the EVC
   tree, adapted hop by hop, so its first round is a GP round (a
   ``fused_gram`` launch at 16384 x 256 x 6).  Checks the ``refers`` chain,
   the adapted trial counts against the stored params, each child's rows
   inside its prior and their objectives, ``audit --all`` clean and the tree
   ``list`` prints; reports the tree fetch, suggest and GP round ms,
   trials/s and the audit ms.  Then a NaN and an infinite objective through
   the port's ``SQLiteDB`` on this host's SQLite.
11. ``telemetry``: the telemetry plane (``telemetry.py``, ``metrics.py``,
   ``tracing.py``, the flight recorder of ``health.py``).  (a) The main
   path's ``tpu_bo`` (130 observed, q=1024) for 6 rounds with
   ``TELEMETRY``/``FLIGHT`` off and 6 on, alternating, each pair drawn from
   one copy of the algorithm: their rows must be equal; the median round ms
   of each and their ratio, the ``suggest_step.dispatch`` spans.  (b)
   ``orion-tpu-torch hunt --n-workers 4 --profile`` on a fresh SQLite file
   (the ``cli`` phase's script and unseeded ``tpu_bo``, ``--pool-size
   1024``, 2048 trials), twice: with ``telemetry: false``, and with
   ``telemetry: true`` and a free ``metrics_port``, on first unless
   ``--fleet-off-first`` is given.  While the telemetry run goes,
   ``/metrics`` (Prometheus text, a growing ``storage_sqlite_txn``
   histogram) and ``/healthz`` are scraped; then ``metrics`` (four
   snapshots merged, completions equal to the trials run), ``trace`` (a
   Chrome trace with ``producer.round`` on four tracks, storage spans
   parented inside them, ``suggest_step.dispatch``), ``trace --attribute``
   and ``flight-record``.  In each run the kernel's launches and their
   (m, n, d) are read from the workers' profiler traces (the wrapper's
   ``fused_gram MxNxD`` range around each launch): at least one at 16384 x
   256 x 6.  Trials/s of both runs, beside the ``cli`` phase's eight
   workers.  (c) A single-worker hunt with telemetry
   on, interrupted by SIGINT: its crash dump holds ``producer.round``
   events; ``audit --flight-out`` on a copy of (b)'s store with one
   violation planted exits 1 and dumps an ``audit.violation`` event.
12. The ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, "device": ...}`` line.

Without a CUDA device it exits with code 1 before printing any result.
"""

import bisect
import collections
import json
import multiprocessing
import os
import queue
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and float32
#: rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

#: fused_gram shapes (m, n, d): the main path's first, then one for each
#: path of the kernel's launch plan and the edges: n odd (scalar stores), a
#: single element, a single tile, and 100000 rows (many tiles per block);
#: last the asha_bo path's EI cross-gram (chunked).
ASHA_BO_SHAPE = (8192, 512, 51)
CASES = [(16384, 256, 6), (16384, 1024, 6), (4096, 256, 8), (8192, 512, 50),
         (300, 70, 6), (513, 129, 130), (16384, 257, 6), (1, 1, 1), (64, 4, 6),
         (100000, 256, 6), ASHA_BO_SHAPE]
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


def gram_bytes(m, n, d):
    """Bytes ``fused_gram`` must move: each input read once, the output
    written once."""
    return 4 * (m * d + n * d + d + 1 + m * n)


def gram_bound(m, n, d):
    """Least time for ``fused_gram`` on an H100: its bytes at 3.35 TB/s,
    against its float32 operations (2d for the cross term, 2 per norm, ~20
    for the epilogue) at 67 TFLOP/s."""
    nbytes = gram_bytes(m, n, d)
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
                "gbytes_per_s": gram_bytes(m, n, d) / (kernel_ms * 1e-3) / 1e9,
                "bound_share": bound_ms / kernel_ms,
                "fill_ms": _graph_ms(lambda: torch.empty((m, n), device=device).fill_(1.0)),
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
    return algo, launches, median


def profile_round(round_fn, device):
    """One call of ``round_fn`` under ``torch.profiler``: kernels launched,
    the device's busy time (the union of its kernel intervals) against the
    call's wall time, each ``suggest.*`` stage's host and device ms (the
    ``record_function`` spans of the algorithms' suggest paths and
    ``_suggest_step``; a kernel counts for the span it starts in), and the
    ops that take the most device and host time.  ``idle_share`` is None
    when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from orion_tpu_torch.ops.gram import PROFILE_RANGE

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        round_fn()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # Device-side copies of the spans (and of ``fused_gram``'s launch range)
    # cover the gaps between their kernels: leave them out of the busy time.
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CUDA
                     and not e.name.startswith(("suggest.", PROFILE_RANGE + " ")))
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

    return dict(wall_ms=wall_ms, device_events=len(kernels), device_busy_ms=busy_us / 1e3,
                idle_share=(1.0 - busy_us / 1e3 / wall_ms) if kernels else None,
                stage_host_device_ms=stages,
                top_self_device_ms=top("self_device_time_total"),
                top_self_cpu_ms=top("self_cpu_time_total"))


def phase_profile(algo, q=Q):
    """One more main-path round under the profiler (:func:`profile_round`)."""
    rng = np.random.default_rng(1)
    xn = rng.uniform(size=(16, 6)).astype(np.float32)
    _observe(algo, xn, _hartmann6(xn))
    emit("profile", q=q, **profile_round(lambda: algo.suggest_batch(q), algo.device))


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


def _uniform_priors(n_dims):
    return {f"x{i:02d}": "uniform(0, 1)" for i in range(n_dims)}


ACKLEY50 = {**_uniform_priors(50), "budget": "fidelity(1, 256, 4)"}
ASHA_BO = {"n_init": 128, "n_candidates": 8192, "fit_steps": 30, "refit_steps": 10,
           "local_frac": 0.8, "trust_region": True, "y_transform": "copula",
           "tr_perturb_dims": 12, "num_brackets": 3}

#: The ``algorithms`` phase: (run, priors, function, algorithm config,
#: trials, batch, seeds).  The configs are the reference's benchmark
#: presets (``orion_tpu/benchmarks/runner.py``) where it has one; a run
#: named like a preset reads that preset's reference regret from
#: ``BENCH_SEEDS.json``.
ALGO_RUNS = [
    ("random-branin", _uniform_priors(2), "branin", {"random": {}}, 200, 50, (0,)),
    ("grid-branin", _uniform_priors(2), "branin", {"grid_search": {"n_values": 14}}, 200, 50,
     (0,)),
    ("tpe-hartmann6", _uniform_priors(6), "hartmann6", {"tpe": {}}, 192, 16, (0,)),
    ("cmaes-rosenbrock20", _uniform_priors(20), "rosenbrock20", {"cmaes": {"popsize": 16}},
     1024, 16, (0,)),
    ("de-rosenbrock20", _uniform_priors(20), "rosenbrock20",
     {"de": {"popsize": 32, "mutation": "best1"}}, 1024, 32, (0,)),
    ("asha-ackley50", ACKLEY50, "ackley50", {"asha": {"num_brackets": 3}}, 4096, 512, (0,)),
    ("hyperband-ackley50", ACKLEY50, "ackley50", {"hyperband": {}}, 4096, 512, (0,)),
    ("bohb-ackley50", ACKLEY50, "ackley50", {"bohb": {"n_candidates": 8192, "min_points": 64}},
     4096, 512, (0,)),
    ("asha_bo-ackley50", ACKLEY50, "ackley50", {"asha_bo": ASHA_BO}, 4096, 512, (0, 1)),
]
#: Each asha_bo-ackley50 seed must end below this regret: plain ASHA sits at
#: 20.35-20.70 on this preset, the reference asha_bo's worst of 15 seeds at
#: 18.93 (``BENCH_SEEDS.json``).
ASHA_BO_REGRET_LIMIT = 20.0


def _reference_regret(preset):
    """The reference's median regret for ``preset``: its latest row in
    ``BENCH_SEEDS.json`` (one JSON object per line), or None."""
    row = None
    with open(os.path.join(ROOT, "BENCH_SEEDS.json")) as handle:
        for line in handle:
            entry = json.loads(line)
            if entry.get("preset") == preset:
                row = entry
    if row is None:
        return None
    return {"regret_median": row["regret_median"], "seeds": row["seeds"],
            "sweep": row["sweep"]}


def run_algorithm(device, priors, fn_name, config, max_trials, batch, seed):
    """One run through the public API: ``suggest(batch)``, evaluate on the
    host, ``observe``, until ``max_trials`` or ``is_done``.  Checks every
    row against the space and each round for repeated points."""
    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.benchmarks.functions import BENCHMARKS
    from orion_tpu_torch.space.dsl import build_space

    spec = BENCHMARKS[fn_name]
    space = build_space(priors)
    fid = space.fidelity
    algo = create_algo(space, config, seed=seed, device=device)
    n_done, best, suggest_ms = 0, float("inf"), []
    t0 = time.perf_counter()
    while n_done < max_trials and not algo.is_done:
        t1 = time.perf_counter()
        params = algo.suggest(min(batch, max_trials - n_done))
        _sync(device)
        suggest_ms.append((time.perf_counter() - t1) * 1e3)
        if params is None:
            break
        points = [dict(p) for p in params]
        bad = [p for p in points if not space.contains_point(p)]
        if bad:
            raise AssertionError(f"{config}: {len(bad)} rows outside the space, e.g. {bad[0]}")
        keys = [tuple(v for k, v in sorted(p.items()) if fid is None or k != fid.name)
                for p in points]
        if len(set(keys)) != len(keys):
            raise AssertionError(f"{config}: a round repeats a point")
        cube = space.params_to_cube(params)
        values = spec["fn"](torch.from_numpy(cube)).numpy()
        if not np.isfinite(values).all():
            raise AssertionError(f"{config}: non-finite objective")
        algo.observe(params, [{"objective": float(v)} for v in values])
        best = min(best, float(values.min()))
        n_done += len(points)
    wall = time.perf_counter() - t0
    return algo, {"trials": n_done, "rounds": len(suggest_ms), "wall_s": wall,
                  "median_suggest_ms": statistics.median(suggest_ms),
                  "suggestions_per_s": n_done / wall, "regret": best - spec["optimum"],
                  "is_done": bool(algo.is_done)}


def phase_algorithms(device, runs=ALGO_RUNS):
    """Every run of ``runs``; returns ``fused_gram``'s launches over the
    asha_bo runs (zeroed just before each, read just after).  After the
    first asha_bo run, one more model round of 512 fresh points runs under
    the profiler (:func:`profile_round`)."""
    from orion_tpu_torch.ops import gram

    plan = gram._launch_plan(*ASHA_BO_SHAPE, True)
    if plan.resident:
        raise AssertionError(f"{ASHA_BO_SHAPE} is expected on the chunked path: {plan}")
    asha_bo_launches = 0
    for name, priors, fn_name, config, max_trials, batch, seeds in runs:
        reference = _reference_regret(name)
        for seed in seeds:
            gram.fused_gram.launches = 0
            algo, out = run_algorithm(device, priors, fn_name, config, max_trials, batch,
                                      seed)
            launches = gram.fused_gram.launches
            emit("algorithms", run=name, seed=seed, config=config, batch=batch,
                 **out, fused_gram_launches=launches, reference=reference)
            if "asha_bo" in config:
                asha_bo_launches += launches
                if launches == 0:
                    raise AssertionError(f"{name} seed {seed}: fused_gram never launched")
                if not out["regret"] < ASHA_BO_REGRET_LIMIT:
                    raise AssertionError(f"{name} seed {seed}: regret {out['regret']} "
                                         f">= {ASHA_BO_REGRET_LIMIT}")
                if seed == seeds[0]:
                    emit("profile", run=name, q=batch,
                         **profile_round(lambda: algo._sample_new(batch), device))
    return asha_bo_launches


#: The ``hunt`` phase: the main path's algorithm through ``optimize()``.
HUNT_ALGO = {"tpu_bo": {"n_init": 16, "n_candidates": 16384, "fit_steps": 40,
                        "local_frac": 0.3}}
HUNT_ROUNDS = 5
HUNT_PRIORS = {f"x{i}": "uniform(0, 1)" for i in range(6)}
MAIN_SHAPE = (16384, 256, 6)
WORKERS = 2
WORKER_ROUNDS = 3  # 2 workers x 3 rounds x 1024 = 6144 trials


def _median(values):
    return statistics.median(values) if values else None


def _timed(fn, samples):
    """``fn`` recording ``(start, wall ms)`` of each call into ``samples``."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            samples.append((t0, (time.perf_counter() - t0) * 1e3))
    return wrapper


def _per_round(samples, edges):
    """The ms of ``samples`` summed per round, round ``k`` being the calls
    that start between ``edges[k]`` and ``edges[k + 1]``."""
    out = [0.0] * (len(edges) - 1)
    for start, ms in samples:
        k = bisect.bisect_right(edges, start) - 1
        if 0 <= k < len(out):
            out[k] += ms
    return out


class _LaunchShapes:
    """Counts the (m, n, d) of every ``fused_gram`` launch plan while
    active (the plan is made just before each launch)."""

    def __enter__(self):
        from orion_tpu_torch.ops import gram

        self.shapes = collections.Counter()
        self._plan = gram._launch_plan

        def plan(m, n, d, aligned):
            self.shapes[(m, n, d)] += 1
            return self._plan(m, n, d, aligned)

        gram._launch_plan = plan
        return self

    def __exit__(self, *exc):
        from orion_tpu_torch.ops import gram

        gram._launch_plan = self._plan


def run_hunt(device, storage, q=Q, rounds=HUNT_ROUNDS, algo=HUNT_ALGO, name="hunt"):
    """``optimize(tpu_bo)`` on ``storage``: ``rounds`` rounds of ``q`` on
    Hartmann6, ``batch_eval`` on the card.  Returns its timings, launches
    and checks as a dict."""
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.client.experiment import optimize
    from orion_tpu_torch.ops import gram

    samples = {"sync": [], "reserve": [], "batch_eval": [], "complete": []}
    storage.fetch_update_view = _timed(storage.fetch_update_view, samples["sync"])
    storage.reserve_trials = _timed(storage.reserve_trials, samples["reserve"])
    storage.update_completed_trials = _timed(storage.update_completed_trials,
                                             samples["complete"])
    ends, best = [], []

    def batch_eval(x):
        t0 = time.perf_counter()
        values = hartmann6(x)
        best.append(float(values.min()))  # one copy; also the sync
        samples["batch_eval"].append((t0, (time.perf_counter() - t0) * 1e3))
        if x.device.type != device.type or tuple(x.shape) != (q, 6):
            raise AssertionError(f"batch_eval got {x.device} {tuple(x.shape)}")
        ends.append(time.perf_counter())
        return values

    gram.fused_gram.launches = 0
    with _LaunchShapes() as launch_shapes:
        t0 = time.perf_counter()
        stats = optimize(None, HUNT_PRIORS, max_trials=rounds * q, batch_size=q,
                         algorithm=algo, seed=0, storage=storage, name=name,
                         batch_eval=batch_eval)
        wall_s = time.perf_counter() - t0
    launches = gram.fused_gram.launches
    exp_id = storage.fetch_experiments({"name": name})[0]["_id"]
    trials = storage.fetch_trials(uid=exp_id)
    values = [t.objective.value for t in trials if t.objective is not None]
    if not (stats["trials_completed"] == len(trials) == len(values) == rounds * q):
        raise AssertionError(f"{name}: {stats['trials_completed']} completed of "
                             f"{len(trials)} trials, expected {rounds * q}")
    if len({t.id for t in trials}) != len(trials) or not np.isfinite(values).all():
        raise AssertionError(f"{name}: repeated ids or non-finite objectives")
    if any(not 0.0 <= v <= 1.0 for t in trials for v in t.params.values()):
        raise AssertionError(f"{name}: a point outside the space")
    gp_rounds = rounds - 1  # round 1 is random: fewer than n_init observed
    if launches < gp_rounds or launch_shapes.shapes[MAIN_SHAPE] < gp_rounds:
        raise AssertionError(f"{name}: fused_gram launched {launches} times "
                             f"({dict(launch_shapes.shapes)}) in {gp_rounds} GP rounds")
    timings = collections.defaultdict(list)
    for doc in storage.fetch_timings(exp_id):
        timings[doc["op"]].append(doc["duration"] * 1e3)
    # Round k runs from the end of batch_eval k - 1 (the start of the run
    # for the first) to the end of batch_eval k: completion of the previous
    # round, the producer's sync with storage (``fetch_update_view``), its
    # observe, naive copy, suggest and register, reserve, and batch_eval.
    edges = [t0] + ends
    round_ms = list(np.diff(edges) * 1e3)
    # GP rounds only: the producer's suggest and register of rounds 2-5, its
    # observe of rounds 1-4's results (made at the start of rounds 2-5).
    gp = {"suggest": timings["suggest"][1:], "register": timings["register"][1:],
          "observe": timings["observe"]}
    gp.update({op: _per_round(samples[op], edges)[1:] for op in samples})
    return {
        "trials": len(trials), "gp_rounds": gp_rounds, "wall_s": wall_s,
        "round_ms": round_ms, "median_gp_round_ms": _median(round_ms[1:]),
        "suggestions_per_s": q / (_median(round_ms[1:]) / 1e3),
        "median_ms": {op: _median(v) for op, v in gp.items()},
        "samples_ms": gp, "regret": min(best) - GLOBAL_MIN,
        "fused_gram_launches": launches,
        "launch_shapes": {"x".join(map(str, k)): v for k, v in launch_shapes.shapes.items()},
    }


def _hunt_worker(path, seed, rounds, q, barrier, results, device=None, algo=HUNT_ALGO):
    """One worker process: an ``ExperimentClient`` loop at ``q`` on the
    ``pickled`` file at ``path`` that keeps one batch in evaluation while
    it asks for the next, completing a batch only once every worker has
    reserved its next one (``barrier``).  From its third round on, each
    producer so fits the GP to the completed batches and lies about the
    batches in flight, its own and the other worker's."""
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.client.experiment import ExperimentClient
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.ops import gram
    from orion_tpu_torch.storage.base import create_storage
    from orion_tpu_torch.utils.exceptions import WaitingForTrials

    import orion_tpu_torch.device  # noqa: F401  (precision switches)

    storage = create_storage({"type": "pickled", "path": path})
    exp = build_experiment(storage, "workers", priors=HUNT_PRIORS,
                           max_trials=WORKERS * rounds * q, algorithms=algo,
                           pool_size=q).instantiate(seed=seed, device=device)
    client = ExperimentClient(exp)
    space = exp.space
    reserved, completed, suggest_ms, held, waits = [], [], [], None, 0

    def complete(trials):
        cube = torch.as_tensor(space.params_to_cube([t.params for t in trials]),
                               device=exp.algorithm.device)
        client.observe_all(trials, hartmann6(cube).cpu().numpy().tolist())
        completed.extend(t.id for t in trials)

    gram.fused_gram.launches = 0
    for _ in range(rounds):
        t0 = time.perf_counter()
        while True:
            try:
                trials = client.suggest(q)
                break
            except WaitingForTrials:
                # The other worker reserved the batch this one had just
                # registered, before this one reserved it: the client's
                # signal to ask again, which produces a fresh batch.
                waits += 1
                if waits > 2 * rounds:
                    raise
        suggest_ms.append((time.perf_counter() - t0) * 1e3)
        reserved.extend(t.id for t in trials)
        barrier.wait(timeout=300)
        if held is not None:
            complete(held)
        held = trials
    complete(held)
    results.put({"seed": seed, "reserved": reserved, "completed": completed,
                 "suggest_ms": suggest_ms, "waits": waits,
                 "fused_gram_launches": gram.fused_gram.launches,
                 "observed": exp.algorithm.n_observed})


def run_workers(tmp_dir, q=Q, rounds=WORKER_ROUNDS, workers=WORKERS, device=None,
                algo=HUNT_ALGO):
    """``workers`` spawned processes on one ``pickled`` file (their
    algorithms on ``device``, ``None`` meaning ``cuda``); checks that no
    trial was reserved twice and each was completed once."""
    from orion_tpu_torch.storage.base import create_storage

    path = os.path.join(tmp_dir, "workers.pkl")
    ctx = multiprocessing.get_context("spawn")
    barrier, results = ctx.Barrier(workers), ctx.Queue()
    procs = [ctx.Process(target=_hunt_worker,
                         args=(path, seed, rounds, q, barrier, results, device, algo))
             for seed in range(workers)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    out = []
    try:
        while len(out) < len(procs):
            try:
                out.append(results.get(timeout=5))
            except queue.Empty:
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed or time.perf_counter() - t0 > 600:
                    raise AssertionError(f"workers failed or hung: exit codes {failed}")
        for proc in procs:
            proc.join(timeout=120)
            if proc.exitcode != 0:
                raise AssertionError(f"worker exited with {proc.exitcode}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join()
    wall_s = time.perf_counter() - t0
    storage = create_storage({"type": "pickled", "path": path})
    exp_id = storage.fetch_experiments({"name": "workers"})[0]["_id"]
    trials = storage.fetch_trials(uid=exp_id)
    reserved = [tid for r in out for tid in r["reserved"]]
    completed = [tid for r in out for tid in r["completed"]]
    total = workers * rounds * q
    ids = [t.id for t in trials]
    out = {"workers": workers, "q": q, "rounds_each": rounds, "trials": len(ids),
           "lies": len(storage.fetch_lies(exp_id)), "wall_s": wall_s,
           "fused_gram_launches": sum(r["fused_gram_launches"] for r in out),
           "per_worker": [{k: r[k] for k in ("seed", "suggest_ms", "waits",
                                             "fused_gram_launches", "observed")}
                          for r in out],
           "reserved": len(reserved), "reserved_distinct": len(set(reserved)),
           "completed": len(completed), "completed_distinct": len(set(completed)),
           "statuses": sorted({t.status for t in trials})}
    emit("hunt", run="workers", storage="pickled", **out)
    if not (len(reserved) == len(set(reserved)) == len(completed) == len(set(completed))
            == len(ids) == len(set(ids)) == total and set(reserved) == set(ids)):
        raise AssertionError(f"workers: {len(reserved)} reserved ({len(set(reserved))} "
                             f"distinct), {len(completed)} completed, {len(ids)} trials "
                             f"({len(set(ids))} ids), expected {total}")
    if out["statuses"] != ["completed"]:
        raise AssertionError(f"workers: statuses {out['statuses']}")
    if out["lies"] == 0 or out["fused_gram_launches"] < workers:
        raise AssertionError("workers: no lie registered or no GP round launched fused_gram")
    return out


def regret_curve_optimize(seed, budget, q, algo_kwargs):
    """The regret gate's scenario through ``optimize()``: the incumbent's
    regret after each round (the first round is the random initial design
    of ``n_init`` points)."""
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.client.experiment import optimize

    curve, best = [], float("inf")

    def batch_eval(x):
        nonlocal best
        values = hartmann6(x)
        best = min(best, float(values.min()))
        curve.append(best - GLOBAL_MIN)
        return values

    optimize(None, HUNT_PRIORS, max_trials=budget, batch_size=q,
             algorithm={"tpu_bo": algo_kwargs}, seed=seed, batch_eval=batch_eval)
    return curve


def phase_hunt(device, plain_round_ms):
    """The library path through the producer and storage: both backends,
    two workers, the regret gate through ``optimize()``.  Returns
    ``fused_gram``'s launches over all of it (zeroed before each run, read
    after it)."""
    from orion_tpu_torch.benchmarks.regret_gate import evaluate_regret_gate, load_baseline
    from orion_tpu_torch.ops import gram
    from orion_tpu_torch.storage.base import create_storage

    launches = 0
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for backend in ("pickled", "memory"):
            storage = create_storage({"type": backend, "path": os.path.join(tmp, "hunt.pkl")})
            out = run_hunt(device, storage)
            launches += out["fused_gram_launches"]
            emit("hunt", storage=backend, q=Q, plain_round_ms=plain_round_ms, **out)
        launches += run_workers(tmp)["fused_gram_launches"]
    path = os.path.join(ROOT, "BENCH_REGRET_BASELINE.json")
    with open(path) as handle:
        config = json.load(handle)["config"]
    baseline = load_baseline(path)
    gram.fused_gram.launches = 0
    curves = [regret_curve_optimize(seed, config["budget"], config["q"],
                                    dict(config["algo"]["tpu_bo"]))
              for seed in range(len(baseline))]
    launches += gram.fused_gram.launches
    verdict = evaluate_regret_gate(curves, baseline)
    emit("hunt", run="regret", final=[c[-1] for c in curves],
         baseline_final=[c[-1] for c in baseline], gate=verdict,
         fused_gram_launches=gram.fused_gram.launches)
    if not verdict["pass"]:
        raise AssertionError("regret gate through optimize() failed against "
                             "BENCH_REGRET_BASELINE.json")
    return launches


#: The ``cli`` phase: the main path's algorithm through ``orion-tpu-torch
#: hunt`` over a user script, one trial a subprocess.
CLI_PRIORS = [f"-x{i}~uniform(0, 1)" for i in range(6)]
CLI_ALGO = {"n_init": 16, "n_candidates": 16384, "fit_steps": 40, "local_frac": 0.3, "seed": 0}
CLI_Q = 1024
CLI_TRIALS = 1280  # one random round of 1024, then a GP round of which 256 are consumed
CLI_WORKERS = 8
CLI_WORKER_TRIALS = 3072
#: The kernel's name in a profiler trace (``ops/csrc/gram.cu``).
GRAM_KERNEL = "gram_kernel"

#: The user script: executable, started as ``python -S`` (on the card's host
#: the interpreter's ``site`` start-up costs most of a trial's process:
#: ``interpreter_start_ms`` in the ``cli`` line) and importing only the
#: client.
USER_SCRIPT = r"""#!%s -S
# Hartmann6 on [0, 1]^6 as the user script of `orion-tpu-torch hunt`, in pure
# Python: a trial's process imports neither numpy nor torch.  Arguments are
# `-x0 V ... -x5 V [--log PATH [--hold-after N --hold-seconds S]]`; `--log`
# appends the trial's id to PATH, one line an execution; with `--hold-after`,
# the first trial to start after N others writes its id to PATH.held and
# runs S seconds longer.
import math
import os
import sys
import time

from orion_tpu_torch.client import report_results

ALPHA = %r
A = %r
P = %r

args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
x = [float(args[f"-x{i}"]) for i in range(6)]
y = -sum(ALPHA[j] * math.exp(-sum(A[j][k] * (x[k] - 1e-4 * P[j][k]) ** 2 for k in range(6)))
         for j in range(4))
if "--log" in args:
    with open(args["--log"], "a") as handle:
        handle.write(os.environ["ORION_TRIAL_ID"] + "\n")
if "--hold-after" in args:
    with open(args["--log"]) as handle:
        started = sum(1 for _ in handle)
    if started > int(args["--hold-after"]):
        try:
            held = os.open(args["--log"] + ".held", os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            held = None
        if held is not None:
            os.write(held, os.environ["ORION_TRIAL_ID"].encode())
            os.close(held)
            time.sleep(float(args["--hold-seconds"]))
report_results([{"name": "objective", "type": "objective", "value": y}])
"""


def write_cli_files(tmp, algo=CLI_ALGO, name="cli"):
    """The user script and a ``-c`` YAML holding ``algo`` as ``tpu_bo``'s
    config; returns their paths."""
    import yaml

    from orion_tpu_torch.benchmarks import functions

    script = os.path.join(tmp, "hartmann6.py")
    if not os.path.exists(script):
        with open(script, "w") as handle:
            handle.write(USER_SCRIPT % (sys.executable, functions._H6_ALPHA, functions._H6_A,
                                        functions._H6_P))
        os.chmod(script, 0o755)
    config = os.path.join(tmp, f"{name}.yaml")
    with open(config, "w") as handle:
        yaml.safe_dump({"algorithms": {"tpu_bo": dict(algo)}}, handle)
    return script, config


def _trial_rows(trials):
    """(n, 6) float32 rows and (n,) objectives of completed trials."""
    trials = [t for t in trials if t.status == "completed"]
    rows = np.asarray([[t.params[f"/x{i}"] for i in range(6)] for t in trials], np.float32)
    return trials, rows, np.asarray([t.objective.value for t in trials], np.float64)


def check_cli_trials(name, trials, expected, device):
    """At least ``expected`` completed trials, unique ids, every parameter
    in [0, 1], and each objective the user script reported equal to the
    port's Hartmann6 on the card at the trial's point (atol 1e-5: float64
    in the script, float32 here)."""
    from orion_tpu_torch.benchmarks.functions import hartmann6

    done, rows, values = _trial_rows(trials)
    if len(done) < expected:
        raise AssertionError(f"{name}: {len(done)} completed trials, expected {expected}")
    if len({t.id for t in trials}) != len(trials):
        raise AssertionError(f"{name}: repeated trial ids")
    if not ((rows >= 0.0) & (rows <= 1.0)).all():
        raise AssertionError(f"{name}: a point outside the space")
    want = hartmann6(torch.from_numpy(rows).to(device)).cpu().numpy()
    err = float(np.abs(want - values).max())
    if not err <= 1e-5:
        raise AssertionError(f"{name}: objectives differ from hartmann6 by {err}")
    return done, values, err


def _fetch_trials(storage, name):
    [exp] = storage.fetch_experiments({"name": name})
    return exp["_id"], storage.fetch_trials(uid=exp["_id"])


def run_cli_hunt(tmp, device, q=CLI_Q, max_trials=CLI_TRIALS, algo=CLI_ALGO):
    """``orion-tpu-torch hunt`` in this process, one worker, on SQLite:
    ``max_trials`` trials of the user script at ``--pool-size q``, the
    kernel's launch shapes counted over the whole call.  Each trial's
    consumption (working dir, files, subprocess, results) and within it the
    subprocess, its reservation and completion and the loop's status reads
    are timed by wrapping their calls."""
    from orion_tpu_torch import cli
    from orion_tpu_torch.core.consumer import Consumer
    from orion_tpu_torch.core.experiment import Experiment
    from orion_tpu_torch.core.producer import Producer
    from orion_tpu_torch.ops import gram
    from orion_tpu_torch.storage.base import DocumentStorage, create_storage

    script, config = write_cli_files(tmp, algo)
    db = os.path.join(tmp, "cli.sqlite")
    samples = {"consume": [], "trial_process": [], "reserve": [], "complete": [], "status": [],
               "produce": []}
    patches = [(Consumer, "consume", "consume"), (Consumer, "_execute_process", "trial_process"),
               (DocumentStorage, "reserve_trial", "reserve"),
               (DocumentStorage, "update_completed_trial", "complete"),
               (Producer, "produce", "produce")]
    saved = [(cls, attr, cls.__dict__[attr]) for cls, attr, _ in patches]
    saved += [(Experiment, attr, Experiment.__dict__[attr]) for attr in ("is_done", "is_broken")]
    for cls, attr, key in patches:
        setattr(cls, attr, _timed(getattr(cls, attr), samples[key]))
    for attr in ("is_done", "is_broken"):
        setattr(Experiment, attr, property(_timed(Experiment.__dict__[attr].fget,
                                                  samples["status"])))
    gram.fused_gram.launches = 0
    try:
        with _LaunchShapes() as launch_shapes:
            t0 = time.perf_counter()
            rc = cli.main(["hunt", "-n", "cli", "-c", config, "--storage-path", db,
                           "--pool-size", str(q), "--max-trials", str(max_trials),
                           "--device", device.type, script, *CLI_PRIORS])
            wall_s = time.perf_counter() - t0
    finally:
        for cls, attr, value in saved:
            setattr(cls, attr, value)
    launches = gram.fused_gram.launches
    if rc != 0:
        raise AssertionError(f"cli hunt: exit code {rc}")
    storage = create_storage({"type": "sqlite", "path": db})
    exp_id, trials = _fetch_trials(storage, "cli")
    done, values, err = check_cli_trials("cli hunt", trials, max_trials, device)
    if launches < 1 or launch_shapes.shapes[MAIN_SHAPE] < 1:
        raise AssertionError(f"cli hunt: fused_gram launched {launches} times "
                             f"({dict(launch_shapes.shapes)})")
    suggest_ms = [doc["duration"] * 1e3 for doc in storage.fetch_timings(exp_id)
                  if doc["op"] == "suggest"]
    produce_ms = [ms for _, ms in samples["produce"]]
    return {
        "trials": len(trials), "completed": len(done), "wall_s": wall_s,
        "trials_per_s": len(done) / wall_s,
        "median_ms_per_trial": {k: _median([ms for _, ms in samples[k]])
                                for k in ("consume", "trial_process", "reserve", "complete")},
        "median_status_ms_per_trial": 2 * _median([ms for _, ms in samples["status"]]),
        "calls": {k: len(v) for k, v in samples.items()},
        "produce_ms": produce_ms, "gp_round_ms": produce_ms[1:],
        "producer_suggest_ms": suggest_ms,
        "regret": float(values.min()) - GLOBAL_MIN, "objective_max_abs_err": err,
        "fused_gram_launches": launches,
        "launch_shapes": {"x".join(map(str, k)): v for k, v in launch_shapes.shapes.items()},
    }


def read_worker_trace(path):
    """From one ``hunt --profile`` trace: the ``gram.cu`` kernel's launches
    and the (m, n, d) of each, read from the profiler range the wrapper
    opens around every launch (``"fused_gram MxNxD"``), every kernel's
    count, the device's busy ms (the union of the kernel intervals) and its
    idle share over the worker's loop (the host-side ``hunt.workon``
    span).  Raises unless every kernel launch has its range."""
    from orion_tpu_torch.ops.gram import PROFILE_RANGE

    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel")
    gram_launches = sum(1 for e in events
                        if e.get("cat") == "kernel" and GRAM_KERNEL in e.get("name", ""))
    shapes = collections.Counter(
        e["name"][len(PROFILE_RANGE) + 1:] for e in events
        if e.get("cat") == "user_annotation"
        and e.get("name", "").startswith(PROFILE_RANGE + " "))
    if sum(shapes.values()) != gram_launches:
        raise AssertionError(f"{path}: {gram_launches} {GRAM_KERNEL} launches, "
                             f"{sum(shapes.values())} {PROFILE_RANGE} ranges {dict(shapes)}")
    loops = [e for e in events
             if e.get("name") == "hunt.workon" and e.get("cat") == "user_annotation"]
    if len(loops) != 1:
        raise AssertionError(f"{path}: {len(loops)} hunt.workon spans")
    busy_us, end = 0.0, float("-inf")
    for start, stop in kernels:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    loop_ms = loops[0]["dur"] / 1e3
    return {"fused_gram_launches": gram_launches, "launch_shapes": dict(shapes),
            "kernels": len(kernels),
            "loop_ms": loop_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / loop_ms}


def _cli_command(*args):
    return [sys.executable, "-m", "orion_tpu_torch.cli", "hunt", *args]


def run_cohort(commands, timeout):
    """Run each ``(argv, cwd)`` of ``commands`` at once, each in a session of
    its own; wait for all.  Any process still running at ``timeout`` (or
    after a failure here) is killed with everything it started.  Returns
    the wall seconds; raises on a nonzero exit code."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(argv, env=env, cwd=cwd, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True, start_new_session=True)
             for argv, cwd in commands]
    t0 = time.perf_counter()
    try:
        errors = [proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))[1]
                  for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    wall_s = time.perf_counter() - t0
    failed = [(proc.returncode, err[-3000:]) for proc, err in zip(procs, errors)
              if proc.returncode != 0]
    if failed:
        raise AssertionError(f"cli: exit codes and stderr {failed}")
    return wall_s


def read_traces(prof):
    """:func:`read_worker_trace` of every trace in ``prof``, with its pid."""
    return [dict(pid=int(f[6:-5]), **read_worker_trace(os.path.join(prof, f)))
            for f in sorted(os.listdir(prof)) if f.startswith("trace-")]


def run_cli_workers(tmp, device, workers=CLI_WORKERS, max_trials=CLI_WORKER_TRIALS, q=CLI_Q,
                    algo=CLI_ALGO, timeout=600, hold_s=5.0):
    """``python3 -m orion_tpu_torch.cli hunt --n-workers W --profile DIR`` on
    a fresh SQLite file: checks that no trial ran twice (the user script
    logs each execution's trial id), that every completed trial ran, and
    that a GP round lied about a trial another worker held: one of the
    random round's last five trials runs ``hold_s`` seconds longer, so the
    workers that find the queue empty meanwhile lie about it.  Counts the
    kernel in the workers' traces.  The config has no seed: processes that
    share one suggest the same points, and their producers spin on
    duplicate keys."""
    from orion_tpu_torch.storage.base import create_storage

    run_dir = os.path.join(tmp, "workers")
    os.makedirs(run_dir)
    unseeded = {k: v for k, v in algo.items() if k != "seed"}
    script, config = write_cli_files(run_dir, unseeded)
    db, log = os.path.join(run_dir, "workers.sqlite"), os.path.join(run_dir, "executions.log")
    prof = os.path.join(run_dir, "profile")
    wall_s = run_cohort([(_cli_command(
        "-n", "cli-workers", "-c", config, "--storage-path", db, "--pool-size", str(q),
        "--max-trials", str(max_trials), "--n-workers", str(workers), "--profile", prof,
        "--device", device.type, script, *CLI_PRIORS, "--log", log,
        "--hold-after", str(q - 5), "--hold-seconds", str(hold_s)), run_dir)], timeout)
    storage = create_storage({"type": "sqlite", "path": db})
    exp_id, trials = _fetch_trials(storage, "cli-workers")
    done, values, err = check_cli_trials("cli workers", trials, max_trials, device)
    with open(log) as handle:
        executed = handle.read().split()
    lies = storage.fetch_lies(exp_id)
    with open(log + ".held") as handle:
        held_id = handle.read()
    held = next(t for t in trials if t.id == held_id)
    per_worker = read_traces(prof)
    launches = sum(w["fused_gram_launches"] for w in per_worker)
    suggest_ms = [doc["duration"] * 1e3 for doc in storage.fetch_timings(exp_id)
                  if doc["op"] == "suggest"]
    out = {"workers": workers, "q": q, "trials": len(trials), "completed": len(done),
           "executed": len(executed), "executed_distinct": len(set(executed)),
           "lies": len(lies), "held_trial_lied_about": any(t.params == held.params for t in lies),
           "wall_s": wall_s, "trials_per_s": len(done) / wall_s,
           "statuses": dict(collections.Counter(t.status for t in trials)),
           "producer_suggest_ms": suggest_ms,
           "regret": float(values.min()) - GLOBAL_MIN, "fused_gram_launches": launches,
           "per_worker": per_worker}
    if len(executed) != len(set(executed)):
        raise AssertionError(f"cli workers: {len(executed)} executions of "
                             f"{len(set(executed))} distinct trials")
    if not {t.id for t in done} <= set(executed):
        raise AssertionError("cli workers: a completed trial never ran")
    if len(per_worker) != workers or not out["held_trial_lied_about"] or launches < 1:
        raise AssertionError(f"cli workers: {len(per_worker)} traces, {len(lies)} lies "
                             f"(held trial among them: {out['held_trial_lied_about']}), "
                             f"{launches} fused_gram launches")
    return out


def run_cli_regret(tmp, device, seeds=None, timeout=600):
    """The regret gate's scenario through ``orion-tpu-torch hunt`` on the
    default backend (``pickled``, in each run's working directory):
    ``--pool-size q``, budget ``--max-trials``, the seed in the YAML; the
    seeds run at once, one process each, traced (``--profile``) to count
    the kernel's launches.  A curve is the incumbent's regret after each
    ``q`` trials in submit order."""
    from orion_tpu_torch.benchmarks.regret_gate import evaluate_regret_gate, load_baseline
    from orion_tpu_torch.storage.base import create_storage

    path = os.path.join(ROOT, "BENCH_REGRET_BASELINE.json")
    with open(path) as handle:
        config = json.load(handle)["config"]
    baseline = load_baseline(path)
    budget, q = config["budget"], config["q"]
    seeds = list(seeds if seeds is not None else range(len(baseline)))
    commands, run_dirs = [], []
    for seed in seeds:
        run_dir = os.path.join(tmp, f"regret-{seed}")
        os.makedirs(run_dir)
        script, cfg = write_cli_files(run_dir, dict(config["algo"]["tpu_bo"], seed=seed))
        commands.append((_cli_command("-n", "regret", "-c", cfg, "--pool-size", str(q),
                                      "--max-trials", str(budget), "--device", device.type,
                                      "--profile", os.path.join(run_dir, "profile"),
                                      script, *CLI_PRIORS), run_dir))
        run_dirs.append(run_dir)
    wall_s = run_cohort(commands, timeout)
    curves, launches = [], 0
    for seed, run_dir in zip(seeds, run_dirs):
        storage = create_storage({"type": "pickled",
                                  "path": os.path.join(run_dir, "orion_tpu_db.pkl")})
        _, trials = _fetch_trials(storage, "regret")
        trials.sort(key=lambda t: (t.submit_time or 0.0, t.id))
        done, values, _ = check_cli_trials(f"cli regret seed {seed}", trials, budget, device)
        curves.append([float(values[: k + q].min()) - GLOBAL_MIN
                       for k in range(0, budget, q)])
        launches += sum(w["fused_gram_launches"]
                        for w in read_traces(os.path.join(run_dir, "profile")))
    verdict = evaluate_regret_gate(curves, baseline)
    return curves, baseline, verdict, launches, wall_s


def interpreter_start_ms(runs=10):
    """Median wall ms of starting this interpreter to run nothing, with its
    ``site`` start-up and with ``-S``: the floor of a trial's process."""
    def median_ms(argv):
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            subprocess.run(argv, check=True, timeout=60)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    return {"site": median_ms([sys.executable, "-c", "pass"]),
            "no_site": median_ms([sys.executable, "-S", "-c", "pass"])}


def phase_cli(device, tmp):
    """The CLI worker path: one worker in process, ``CLI_WORKERS`` workers as
    a subprocess, the regret gate through the CLI.  The one-worker hunt's
    store stays in ``tmp`` for the ``evc`` phase.  Returns ``fused_gram``'s
    launches in each run and the eight workers' trials/s."""
    one = run_cli_hunt(tmp, device)
    emit("cli", run="hunt", storage="sqlite", q=CLI_Q,
         interpreter_start_ms=interpreter_start_ms(), **one)
    many = run_cli_workers(tmp, device)
    emit("cli", run="workers", storage="sqlite", **many)
    curves, baseline, verdict, regret_launches, wall_s = run_cli_regret(tmp, device)
    emit("cli", run="regret", storage="pickled", wall_s=wall_s, final=[c[-1] for c in curves],
         baseline_final=[c[-1] for c in baseline], gate=verdict,
         fused_gram_launches=regret_launches)
    if not verdict["pass"]:
        raise AssertionError("regret gate through the CLI failed against "
                             "BENCH_REGRET_BASELINE.json")
    return ({"hunt": one["fused_gram_launches"], "workers": many["fused_gram_launches"],
             "regret": regret_launches}, many["trials_per_s"])


#: The ``evc`` phase: the ``cli`` phase's one-worker hunt (v1) resumed twice
#: with a narrower prior, each branching a child that runs ``EVC_TRIALS``
#: trials of its own: v2 with ``x0 ~ uniform(0, 0.5)``, v3 with ``x1`` too.
EVC_NARROWED = (0, 1)
EVC_TRIALS = 256
EVC_TREE = "cli-v1\n└── cli-v2\n    └── cli-v3\n"


def _cli_output(argv):
    """``orion-tpu-torch`` in this process: (exit code, stdout, wall ms)."""
    import contextlib
    import io

    from orion_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue(), (time.perf_counter() - t0) * 1e3


def run_evc_chain(tmp, device, q=CLI_Q, max_trials=EVC_TRIALS, narrowed=EVC_NARROWED,
                  algo=CLI_ALGO):
    """``orion-tpu-torch hunt -n cli`` on the ``cli`` phase's SQLite store,
    once for each dimension of ``narrowed``, each time with that prior
    narrowed to [0, 0.5] as well: every call branches a child of the last
    version, whose producer fetches the family's trials through the EVC tree
    (adapted hop by hop) before its first suggest.  Checks the ``refers``
    chain; that each child's first tree fetch held exactly the ancestors'
    trials inside the child's prior (counted here from the stored params);
    that its first round was a GP round (a ``fused_gram`` launch at the main
    path's shape, no random round); that its rows lie in its prior and its
    objectives are Hartmann6's; then ``audit --all`` and ``list``."""
    from orion_tpu_torch.core.producer import Producer
    from orion_tpu_torch.evc.experiment import TreeTrialsFetcher
    from orion_tpu_torch.ops import gram
    from orion_tpu_torch.storage.base import create_storage

    script, config = write_cli_files(tmp, algo)
    db = os.path.join(tmp, "cli.sqlite")
    fetch, produce = TreeTrialsFetcher.__dict__["fetch"], Producer.__dict__["produce"]
    fetches, produced = [], []

    def counted_fetch(self):
        t0 = time.perf_counter()
        trials = fetch(self)
        family = [t for t in trials if t.experiment != self.node_id]
        fetches.append({"ms": (time.perf_counter() - t0) * 1e3, "trials": len(trials),
                        "family": len(family),
                        "family_completed": sum(t.status == "completed" for t in family)})
        return trials

    bounds, generations = {}, []
    for version, dim in enumerate(narrowed, start=2):
        bounds[dim] = 0.5
        priors = [f"-x{i}~uniform(0, {bounds.get(i, 1)})" for i in range(6)]
        fetches.clear()
        produced.clear()
        TreeTrialsFetcher.fetch = counted_fetch
        Producer.produce = _timed(produce, produced)
        gram.fused_gram.launches = 0
        try:
            with _LaunchShapes() as launch_shapes:
                t0 = time.perf_counter()
                rc, _, _ = _cli_output(["hunt", "-n", "cli", "-c", config, "--storage-path", db,
                                        "--pool-size", str(q), "--max-trials", str(max_trials),
                                        "--device", device.type, script, *priors])
                wall_s = time.perf_counter() - t0
        finally:
            TreeTrialsFetcher.fetch, Producer.produce = fetch, produce
        launches = gram.fused_gram.launches
        if rc != 0:
            raise AssertionError(f"evc v{version}: exit code {rc}")
        storage = create_storage({"type": "sqlite", "path": db})
        exps = {e["version"]: e for e in storage.fetch_experiments({"name": "cli"})}
        child, parent, root = exps[version], exps[version - 1], exps[1]
        if (child["refers"].get("parent_id") != parent["_id"]
                or child["refers"].get("root_id") != root["_id"]):
            raise AssertionError(f"evc v{version}: refers {child['refers']}")
        trials = storage.fetch_trials(uid=child["_id"])
        done, values, err = check_cli_trials(f"evc v{version}", trials, max_trials, device)
        if any(t.params[f"/x{i}"] > hi for t in trials for i, hi in bounds.items()):
            raise AssertionError(f"evc v{version}: a row outside the prior {bounds}")
        ancestors = [t for v in range(1, version) for t in storage.fetch_trials(uid=exps[v]["_id"])]
        inside = [t for t in ancestors
                  if all(0.0 <= t.params[f"/x{i}"] <= hi for i, hi in bounds.items())]
        first = fetches[0] if fetches else {}
        if first.get("family") != len(inside) or first.get("trials") != len(inside):
            raise AssertionError(f"evc v{version}: first tree fetch {first}, expected "
                                 f"{len(inside)} adapted ancestor trials and none of its own")
        if launches < 1 or launch_shapes.shapes[MAIN_SHAPE] < 1:
            raise AssertionError(f"evc v{version}: first round not a GP round: fused_gram "
                                 f"launched {launches} times ({dict(launch_shapes.shapes)})")
        suggest_ms = [doc["duration"] * 1e3 for doc in storage.fetch_timings(child["_id"])
                      if doc["op"] == "suggest"]
        generations.append({
            "version": version, "priors": priors, "wall_s": wall_s,
            "trials": len(trials), "completed": len(done), "trials_per_s": len(done) / wall_s,
            "family_trials_observed": first["family"],
            "family_completed_observed": first["family_completed"],
            "tree_fetch_ms": [f["ms"] for f in fetches],
            "median_tree_fetch_ms": _median([f["ms"] for f in fetches]),
            "producer_suggest_ms": suggest_ms, "median_suggest_ms": _median(suggest_ms),
            "gp_round_ms": produced[0][1], "produce_ms": [ms for _, ms in produced],
            "regret": float(values.min()) - GLOBAL_MIN, "objective_max_abs_err": err,
            "fused_gram_launches": launches,
            "launch_shapes": {"x".join(map(str, k)): v for k, v in launch_shapes.shapes.items()},
        })
    rc, report, audit_ms = _cli_output(["audit", "--all", "--storage-path", db])
    if rc != 0 or "violation(s)" in report:
        raise AssertionError(f"evc: audit --all exited {rc}:\n{report}")
    rc, tree, list_ms = _cli_output(["list", "--storage-path", db])
    if rc != 0 or tree != EVC_TREE:
        raise AssertionError(f"evc: list exited {rc} and printed {tree!r}")
    return {"generations": generations, "audit_ms": audit_ms, "audit": report.splitlines(),
            "list_ms": list_ms, "list": tree.splitlines()}


def check_sqlite_non_finite(tmp):
    """On this host's SQLite: a trial holding NaN, and a reservation claim
    completing another with an infinite objective, through the port's
    ``SQLiteDB`` with its partial field indexes; the worker loop's count
    reads the field index and ``json_valid`` rejects NaN, as the indexes
    assume on every SQLite."""
    import sqlite3

    from orion_tpu_torch.storage import sqlitedb

    db = sqlitedb.SQLiteDB(os.path.join(tmp, "non-finite.sqlite"))
    doc = {"_id": "a", "experiment": "e", "status": "reserved", "results": []}
    db.write("trials", dict(doc))
    db.write("trials", dict(doc, _id="b", results=[
        {"name": "o", "type": "objective", "value": float("nan")}]))
    done = db.read_and_write("trials", {"experiment": "e", "status": "reserved"}, {
        "$set": {"status": "completed",
                 "results": [{"name": "o", "type": "objective", "value": float("inf")}]}})
    completed = db.count("trials", {"experiment": "e", "status": "completed"})
    conn = db._conn()
    nonstandard = conn.execute(
        f"SELECT COUNT(*) FROM docs WHERE NOT {sqlitedb._VALID_JSON}").fetchone()[0]
    clauses, params = db._sql_prefilter({"experiment": "e", "status": "completed"})
    plan = conn.execute("EXPLAIN QUERY PLAN SELECT COUNT(*) FROM docs WHERE collection = ? AND "
                        + " AND ".join([sqlitedb._VALID_JSON, *clauses]),
                        ("trials", *params)).fetchall()[0][-1]
    json_valid_nan = conn.execute("SELECT json_valid('[NaN]')").fetchone()[0]
    out = {"sqlite": sqlite3.sqlite_version, "json_valid_nan": json_valid_nan,
           "completed": completed, "nonstandard_docs": nonstandard, "count_plan": plan}
    if (done["_id"] != "a" or completed != 1 or nonstandard != 2 or json_valid_nan != 0
            or "docs_valid_experiment_status" not in plan):
        raise AssertionError(f"sqlite non-finite check: {out}")
    return out


def phase_evc(device, tmp):
    """EVC branching through the CLI on the ``cli`` phase's store, and the
    SQLite non-finite check.  Returns ``fused_gram``'s launches."""
    chain = run_evc_chain(tmp, device)
    emit("evc", storage="sqlite", q=CLI_Q, sqlite_non_finite=check_sqlite_non_finite(tmp),
         **chain)
    return sum(g["fused_gram_launches"] for g in chain["generations"])


#: The ``telemetry`` phase: (a) main-path rounds with the registry off and
#: on, alternating; (b) a four-worker CLI hunt with ``telemetry: true`` and
#: a ``/metrics`` port; (c) the flight recorder's dumps.
TELEMETRY_ROUNDS = 6
TELEMETRY_WORKERS = 4
TELEMETRY_TRIALS = 2048
PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*",?)*\})? '
    r'(-?[0-9.eE+-]+|\+Inf|-Inf|NaN)$')


def run_telemetry_cost(device, q=Q, rounds=TELEMETRY_ROUNDS):
    """The main path's ``tpu_bo`` (130 observed, q=1024) for ``2 * rounds``
    rounds, one of each pair with ``TELEMETRY``/``FLIGHT`` off, the other on,
    alternating which goes first: both draw from one copy of the algorithm
    (its generator state included), so their rows must be equal.  Returns
    the median round ms of each, their ratio, the ``suggest_step.dispatch``
    spans, and the kernel's launches over the rounds."""
    import copy

    from orion_tpu_torch.health import FLIGHT
    from orion_tpu_torch.ops.gram import fused_gram
    from orion_tpu_torch.telemetry import TELEMETRY

    rng = np.random.default_rng(1)
    algo = _make_algo(1, device)
    x = rng.uniform(size=(N_HISTORY, 6)).astype(np.float32)
    _observe(algo, x, _hartmann6(x))
    algo.suggest(q)  # warm-up
    TELEMETRY.reset()
    FLIGHT.clear()
    times = {"off": [], "on": []}
    fused_gram.launches = 0
    try:
        for k in range(rounds):
            xn = rng.uniform(size=(16, 6)).astype(np.float32)
            _observe(algo, xn, _hartmann6(xn))
            twin = copy.deepcopy(algo)
            rows = {}
            for mode in (("off", "on") if k % 2 == 0 else ("on", "off")):
                target = algo if mode == "off" else twin
                if mode == "on":
                    TELEMETRY.enable()
                    FLIGHT.enable()
                _sync(device)
                t0 = time.perf_counter()
                rows[mode] = target.suggest_batch(q).cube
                _sync(device)
                times[mode].append((time.perf_counter() - t0) * 1e3)
                TELEMETRY.disable()
                FLIGHT.disable()
            if not np.array_equal(rows["off"], rows["on"]):
                raise AssertionError(f"telemetry: round {k} rows differ with telemetry on "
                                     f"({int((rows['off'] != rows['on']).any(1).sum())} rows)")
    finally:
        TELEMETRY.disable()
        FLIGHT.disable()
    launches = fused_gram.launches
    spans = [s for s in TELEMETRY.iter_spans() if s["name"] == "suggest_step.dispatch"]
    TELEMETRY.reset()
    if len(spans) != rounds or launches < 2 * rounds:
        raise AssertionError(f"telemetry: {len(spans)} dispatch spans over {rounds} rounds on, "
                             f"fused_gram launched {launches} times in {2 * rounds} rounds")
    off, on = statistics.median(times["off"]), statistics.median(times["on"])
    return {"q": q, "rounds_each": rounds, "round_ms": times, "median_round_ms_off": off,
            "median_round_ms_on": on, "on_over_off": on / off, "rows_equal": True,
            "dispatch_spans": len(spans),
            "median_dispatch_ms": statistics.median(s["dur"] * 1e3 for s in spans),
            "dispatch_args": spans[0].get("args"), "fused_gram_launches": launches}


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http_get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read().decode()


def parse_exposition(text):
    """Prometheus text exposition (0.0.4) -> ``{sample name with labels:
    value}``; raises on a line that is neither a ``# TYPE`` line nor a
    sample."""
    samples = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            if len(line.split()) != 4:
                raise AssertionError(f"bad TYPE line {line!r}")
            continue
        if not PROM_LINE.match(line):
            raise AssertionError(f"not Prometheus text: {line!r}")
        name, value = line.rsplit(" ", 1)
        samples[name] = float(value)
    return samples


def _scrape(port, until, period=2.0):
    """Scrape ``/metrics`` and ``/healthz`` every ``period`` s while
    ``until()`` is false; a refused connection (the worker's server not up
    yet) is skipped.  Returns ``(t, txn count, samples, healthz)`` per
    scrape."""
    scrapes = []
    t0 = time.perf_counter()
    while not until():
        try:
            status, ctype, text = _http_get(port, "/metrics")
            hstatus, _, health = _http_get(port, "/healthz")
        except OSError:
            time.sleep(0.2)
            continue
        if status != 200 or hstatus != 200 or "version=0.0.4" not in (ctype or ""):
            raise AssertionError(f"telemetry: /metrics {status} {ctype}, /healthz {hstatus}")
        samples = parse_exposition(text)
        scrapes.append((time.perf_counter() - t0,
                        samples.get("orion_tpu_storage_sqlite_txn_seconds_count", 0.0),
                        len(samples), json.loads(health)))
        time.sleep(period)
    return scrapes


def run_fleet(tmp, device, telemetry, workers=TELEMETRY_WORKERS, max_trials=TELEMETRY_TRIALS,
              q=CLI_Q, algo=CLI_ALGO, timeout=400):
    """``hunt --n-workers 4 --profile`` on a fresh SQLite file with
    ``telemetry:`` on or off in the config; on, with a free
    ``metrics_port`` that is scraped while the hunt runs.  Checks the
    trials, and reads ``fused_gram``'s launches and their shapes from the
    workers' traces: at least one at ``MAIN_SHAPE``."""
    import threading

    import yaml

    from orion_tpu_torch.storage.base import create_storage

    run_dir = os.path.join(tmp, "telemetry" if telemetry else "telemetry-off")
    os.makedirs(run_dir)
    unseeded = {k: v for k, v in algo.items() if k != "seed"}
    script, _ = write_cli_files(run_dir, unseeded)
    port = _free_port() if telemetry else None
    config = os.path.join(run_dir, "telemetry.yaml")
    with open(config, "w") as handle:
        yaml.safe_dump({"telemetry": telemetry, "algorithms": {"tpu_bo": unseeded},
                        **({"metrics_port": port} if telemetry else {})}, handle)
    db, prof = os.path.join(run_dir, "telemetry.sqlite"), os.path.join(run_dir, "profile")
    done_event, result = threading.Event(), {}

    def hunt():
        try:
            result["wall_s"] = run_cohort([(_cli_command(
                "-n", "tel", "-c", config, "--storage-path", db, "--pool-size", str(q),
                "--max-trials", str(max_trials), "--n-workers", str(workers), "--profile", prof,
                "--device", device.type, script, *CLI_PRIORS), run_dir)], timeout)
        except BaseException as exc:  # re-raised below, in the phase's thread
            result["error"] = exc
        finally:
            done_event.set()

    thread = threading.Thread(target=hunt)
    thread.start()
    scrapes = _scrape(port, done_event.is_set) if telemetry else []
    thread.join()
    if "error" in result:
        raise result["error"]
    storage = create_storage({"type": "sqlite", "path": db})
    exp_id, trials = _fetch_trials(storage, "tel")
    done, values, err = check_cli_trials(f"telemetry fleet ({'on' if telemetry else 'off'})",
                                         trials, max_trials, device)
    per_worker = read_traces(prof)
    shapes = collections.Counter()
    for w in per_worker:
        shapes.update(w["launch_shapes"])
    main = "x".join(map(str, MAIN_SHAPE))
    if len(per_worker) != workers or shapes[main] < 1:
        raise AssertionError(f"telemetry fleet: {len(per_worker)} traces, fused_gram launched "
                             f"at {dict(shapes)} (none at {main})")
    return {"telemetry": telemetry, "db": db, "storage": storage, "exp_id": exp_id,
            "trials": trials, "done": done, "values": values, "err": err,
            "wall_s": result["wall_s"], "scrapes": scrapes, "per_worker": per_worker,
            "launches": sum(w["fused_gram_launches"] for w in per_worker),
            "launch_shapes": dict(shapes), "unseeded": unseeded, "run_dir": run_dir}


def run_telemetry_fleet(tmp, device, off_first=False, workers=TELEMETRY_WORKERS,
                        max_trials=TELEMETRY_TRIALS):
    """:func:`run_fleet` with telemetry off and on, in the order
    ``off_first`` says; then over the telemetry run's store, ``metrics``,
    ``trace`` (Chrome and ``--attribute``) and ``flight-record``, each
    checked."""
    from orion_tpu_torch.algo.gp.kernels import _FUSED_MIN_WORK
    from orion_tpu_torch.storage.base import DocumentStorage

    runs = {}
    for telemetry in ((False, True) if off_first else (True, False)):
        runs[telemetry] = run_fleet(tmp, device, telemetry, workers, max_trials)
    on, off = runs[True], runs[False]
    scrapes, run_dir, storage, exp_id = on["scrapes"], on["run_dir"], on["storage"], on["exp_id"]
    done = on["done"]
    cmd = ["--storage-path", on["db"], "-n", "tel"]

    rc, body, metrics_ms = _cli_output(["metrics", *cmd])
    merged = parse_exposition(body)
    docs = storage.fetch_metrics(exp_id)
    completions = merged.get("orion_tpu_storage_sqlite_update_completed_trial_seconds_count")
    reserves = merged.get("orion_tpu_storage_sqlite_reserve_trial_seconds_count", 0.0)
    if rc != 0 or len(docs) != workers or completions != len(done) or reserves < len(done):
        raise AssertionError(f"telemetry: metrics exited {rc} over {len(docs)} snapshots, "
                             f"{completions} completions and {reserves} reservations for "
                             f"{len(done)} completed trials")

    chrome = os.path.join(run_dir, "trace.json")
    rc, out, trace_ms = _cli_output(["trace", *cmd, "--out", chrome])
    with open(chrome) as handle:
        events = json.load(handle)["traceEvents"]
    spans = storage.fetch_spans(exp_id)
    rounds = [e for e in events if e.get("name") == "producer.round" and e.get("ph") == "X"]
    round_ids = {s["span_id"] for s in spans if s["name"] == "producer.round"}
    nested = [s for s in spans if s["name"].startswith("storage.")
              and s.get("parent_span_id") in round_ids]
    contained = sum(
        1 for e in events if e.get("ph") == "X" and e["name"].startswith("storage.")
        and any(r["pid"] == e["pid"] and r["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= r["ts"] + r["dur"] for r in rounds))
    dispatch = [s for s in spans if s["name"] == "suggest_step.dispatch"]
    if (rc != 0 or len({e["pid"] for e in rounds}) != workers or not nested or not contained
            or not dispatch):
        raise AssertionError(f"telemetry: trace exited {rc}: producer.round on "
                             f"{len({e['pid'] for e in rounds})} pids, {len(nested)} storage "
                             f"spans parented in a round ({contained} contained), "
                             f"{len(dispatch)} suggest_step.dispatch")
    rc, table, _ = _cli_output(["trace", *cmd, "--out", os.path.join(run_dir, "t2.json"),
                                "--attribute"])
    if rc != 0 or "producer.round" not in table or "mean of" not in table:
        raise AssertionError(f"telemetry: trace --attribute exited {rc}:\n{table}")

    flight = os.path.join(run_dir, "flight.jsonl")
    rc, _, _ = _cli_output(["flight-record", *cmd, "--out", flight])
    with open(flight) as handle:
        lines = [json.loads(line) for line in handle]
    kinds = collections.Counter(e.get("kind") for e in lines[1:])
    if rc != 0 or lines[0].get("type") != "flight-record" or not kinds["producer.round"]:
        raise AssertionError(f"telemetry: flight-record exited {rc}, events {dict(kinds)}")

    # The pool's cross-gram is n_candidates x (rows of the GP's buffer) x d:
    # the dispatch span's ``n`` names the buffer, and each GP round whose
    # work reaches the fused route launches the kernel once.
    d = MAIN_SHAPE[2]
    fused = [s for s in dispatch
             if on["unseeded"]["n_candidates"] * s["args"]["n"] * d >= _FUSED_MIN_WORK]
    # Below the cap nothing was pruned, so every GP round's span is here.
    pruned = len(spans) >= int(DocumentStorage.SPANS_CAP * 0.9)
    launches = on["launches"]
    if launches < len(fused) or (not pruned and launches != len(fused)):
        raise AssertionError(f"telemetry: fused_gram launched {launches} times in the traces "
                             f"({on['launch_shapes']}), {len(fused)} GP rounds on the fused "
                             "route by their dispatch spans")
    names = collections.Counter(s["name"] for s in spans)

    def rate(run):
        return len(run["done"]) / run["wall_s"]

    return {
        "workers": workers, "q": CLI_Q, "trials": len(on["trials"]), "completed": len(done),
        "order": ["off", "on"] if off_first else ["on", "off"],
        "wall_s": on["wall_s"], "trials_per_s": rate(on),
        "off": {"trials": len(off["trials"]), "completed": len(off["done"]),
                "wall_s": off["wall_s"], "trials_per_s": rate(off),
                "regret": float(off["values"].min()) - GLOBAL_MIN,
                "fused_gram_launches": off["launches"], "launch_shapes": off["launch_shapes"],
                "per_worker": off["per_worker"]},
        "on_over_off_trials_per_s": rate(on) / rate(off),
        "regret": float(on["values"].min()) - GLOBAL_MIN, "objective_max_abs_err": on["err"],
        "scrapes": [{"t_s": t, "sqlite_txn_count": c, "samples": n} for t, c, n, _ in scrapes],
        "merged_snapshots": len(docs), "completions": completions, "reservations": reserves,
        "metrics_ms": metrics_ms, "trace_ms": trace_ms,
        "stored_spans": len(spans), "pruned": pruned, "spans_by_name": dict(names.most_common(12)),
        "round_pids": len({e["pid"] for e in rounds}), "storage_spans_in_rounds": len(nested),
        "dispatch_spans": len(dispatch), "dispatch_n": sorted({s["args"]["n"] for s in dispatch}),
        "dispatch_fused_rounds": len(fused),
        "flight_events": dict(kinds),
        "merged": {k: merged[k] for k in sorted(merged) if k.endswith(("_total", "_count"))},
        "fused_gram_launches": launches,
        "launch_shapes": on["launch_shapes"],
        "per_worker": on["per_worker"],
    }


def run_telemetry_dumps(tmp, device, fleet_db, algo=CLI_ALGO, timeout=120):
    """A single-worker ``hunt`` with ``telemetry: true`` interrupted by
    SIGINT mid-run must leave ``flight-<name>-<pid>.jsonl`` holding
    ``producer.round`` events; ``audit --flight-out`` on a copy of the
    fleet's store with one completed trial's results removed must exit 1
    and write a dump holding an ``audit.violation`` event."""
    import signal
    import sqlite3

    import yaml

    from orion_tpu_torch.storage.base import create_storage

    run_dir = os.path.join(tmp, "sigint")
    os.makedirs(run_dir)
    script, _ = write_cli_files(run_dir, algo)
    config = os.path.join(run_dir, "sigint.yaml")
    with open(config, "w") as handle:
        yaml.safe_dump({"telemetry": True, "algorithms": {"tpu_bo": dict(algo)}}, handle)
    db = os.path.join(run_dir, "sigint.sqlite")
    proc = subprocess.Popen(_cli_command(
        "-n", "sig", "-c", config, "--storage-path", db, "--pool-size", "64",
        "--max-trials", "100000", "--device", device.type, script, *CLI_PRIORS),
        env=dict(os.environ, PYTHONPATH=ROOT), cwd=run_dir, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    t0 = time.perf_counter()
    try:
        completed = 0
        while completed < 80:
            if proc.poll() is not None or time.perf_counter() - t0 > timeout:
                raise AssertionError(f"telemetry: the interrupted hunt ended early "
                                     f"({proc.poll()}) or never ran 80 trials")
            time.sleep(0.5)
            if os.path.exists(db):
                completed = create_storage({"type": "sqlite", "path": db}).db.count(
                    "trials", {"status": "completed"})
        os.kill(proc.pid, signal.SIGINT)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    dump = os.path.join(run_dir, f"flight-sig-{proc.pid}.jsonl")
    if not os.path.exists(dump):
        raise AssertionError(f"telemetry: no crash dump after SIGINT (exit {proc.returncode}): "
                             f"{err[-2000:]}")
    with open(dump) as handle:
        crash = [json.loads(line) for line in handle]
    crash_kinds = collections.Counter(e.get("kind") for e in crash[1:])
    if crash[0].get("reason") != "crash" or not crash_kinds["producer.round"]:
        raise AssertionError(f"telemetry: crash dump {crash[0]} with {dict(crash_kinds)}")

    copy_db = os.path.join(run_dir, "audit-copy.sqlite")
    src, dst = sqlite3.connect(fleet_db), sqlite3.connect(copy_db)
    src.backup(dst)
    src.close()
    dst.close()
    storage = create_storage({"type": "sqlite", "path": copy_db})
    [exp] = storage.fetch_experiments({"name": "tel"})
    victim = storage.db.read("trials", {"experiment": exp["_id"], "status": "completed"})[0]
    storage.db.write("trials", {"results": []}, query={"_id": victim["_id"]})
    flight = os.path.join(run_dir, "audit-flight.jsonl")
    rc, report, audit_ms = _cli_output(["audit", "-n", "tel", "--storage-path", copy_db,
                                        "--flight-out", flight])
    with open(flight) as handle:
        audit_lines = [json.loads(line) for line in handle]
    violations = [e for e in audit_lines[1:] if e.get("kind") == "audit.violation"]
    if rc == 0 or audit_lines[0].get("reason") != "audit-failure" or not violations:
        raise AssertionError(f"telemetry: audit --flight-out exited {rc}, "
                             f"{len(violations)} violation events:\n{report}")
    return {"sigint": {"exit_code": proc.returncode, "completed_before": completed,
                       "dump_events": dict(crash_kinds)},
            "audit": {"exit_code": rc, "ms": audit_ms, "violations": len(violations),
                      "first": violations[0]["args"]}}


def phase_telemetry(device, tmp, cli_workers_trials_per_s, fleet_off_first=False):
    """The telemetry plane: its cost on the main path, a four-worker hunt
    with it off and on, and its dumps.  Returns ``fused_gram``'s
    launches."""
    cost = run_telemetry_cost(device)
    emit("telemetry", run="cost", **cost)
    fleet = run_telemetry_fleet(tmp, device, off_first=fleet_off_first)
    emit("telemetry", run="fleet", storage="sqlite",
         cli_eight_workers_trials_per_s=cli_workers_trials_per_s, **fleet)
    dumps = run_telemetry_dumps(tmp, device, os.path.join(tmp, "telemetry", "telemetry.sqlite"))
    emit("telemetry", run="dumps", **dumps)
    return {"cost": cost["fused_gram_launches"], "fleet": fleet["fused_gram_launches"],
            "fleet_off": fleet["off"]["fused_gram_launches"]}


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
    algo, launches, plain_round_ms = run("main_path", phase_main_path, device)
    run("profile", phase_profile, algo)
    run("regret", phase_regret, device)
    asha_bo_launches = run("algorithms", phase_algorithms, device)
    hunt_launches = run("hunt", phase_hunt, device, plain_round_ms)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        cli_launches, cli_workers_trials_per_s = run("cli", phase_cli, device, tmp)
        evc_launches = run("evc", phase_evc, device, tmp)
        telemetry_launches = run("telemetry", phase_telemetry, device, tmp,
                                 cli_workers_trials_per_s,
                                 fleet_off_first="--fleet-off-first" in sys.argv[1:])
    emit("seconds", **seconds)

    def case(shape):
        return next(c for c in cases if (c["m"], c["n"], c["d"]) == shape
                    and c["kind"] == "matern52")

    main_case, asha_bo_case = case(CASES[0]), case(ASHA_BO_SHAPE)
    kernels = [{
        "name": "fused_gram",
        "route": "cuda",
        "source": "orion_tpu_torch/ops/csrc/gram.cu",
        "replaces": "orion_tpu/ops/gram.py:68",
        "launches": (launches["fused_gram"] + asha_bo_launches + hunt_launches
                     + sum(cli_launches.values()) + evc_launches
                     + sum(telemetry_launches.values())),
        "launches_by_path": {"main_path": launches["fused_gram"], "asha_bo": asha_bo_launches,
                             "hunt": hunt_launches, "cli": sum(cli_launches.values()),
                             "cli_runs": cli_launches, "evc": evc_launches,
                             "telemetry": sum(telemetry_launches.values()),
                             "telemetry_runs": telemetry_launches},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "bound_share": main_case["bound_share"],
        "fill_ms": main_case["fill_ms"],
        "library_ms": None,
        "shape": list(CASES[0]),
        "asha_bo_case": {k: asha_bo_case[k] for k in ("m", "n", "d", "max_abs_err", "ms",
                                                       "plain_ms", "bound_ms", "bound_by",
                                                       "bound_share")},
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
