"""Device time, host time and FLOP rate of the GP suggest round (port of
``orion_tpu/benchmarks/suggest_bench.py``).

The round is the one the algorithms run: a :class:`FusedPlan` built by
:func:`~orion_tpu_torch.algo.tpu_bo.make_fused_plan` from a seeded
``torch.Generator`` (the reference's ``PRNGKey(0)``) and the reference's
numpy draws of the history, captured once as a CUDA graph by the step
graphs (:mod:`orion_tpu_torch.algo.step_graphs`, the capture and replay
that :func:`~orion_tpu_torch.algo.tpu_bo.run_fused_plan` goes through)
and replayed.  Each shape's round is captured into a :class:`StepGraphs` of
its own, released after it: its pool then holds that round alone, so its
footprint is measured exactly, and the process's own step graphs are left
as they were.  At the three headline shapes it separates:

- ``device_ms`` -- the median CUDA-event ms of one replay of the round's
  graph, timed over ``k_hi`` replays back to back (:func:`device_seconds`,
  the instrument the port's bench decomposition reads);
- ``wall_ms`` -- the median of one round from plan to rows on the host:
  the draws, the input copies, the replay, the copy-out and the rows'
  transfer;
- ``host_ms`` -- ``wall_ms - device_ms`` (the reference's ``tunnel_ms``: a
  CUDA launch has no tunnel, what is left is the host's share);
- ``public_api_ms`` -- the best of five observe-16 + ``suggest(q)``
  rounds through ``create_algo(...).suggest``, replays of its own capture
  (the best, as the reference's: at ``rosenbrock20-q256`` the observations
  cross a fit bucket, and that round's capture is not the steady state; None
  at ``ackley50-q512``, as in the reference: ``asha_bo``'s public round is
  rung-scheduled, not shape-stable).

FLOPs come from the compiler plane's cold path
(:func:`~orion_tpu_torch.algo.tpu_bo.flop_analysis_fn`: one eager round
under ``FlopCounterMode``, run before the capture, labelled with
:data:`~orion_tpu_torch.compiler_plane.FLOPS_LABEL`).  That mode counts
the matmul family and not the triangular solves, so ``gflops_per_call``
is a lower bound, and so are ``achieved_tflops`` and ``mfu_vs_f32_peak``
(against the H100's 67 TFLOP/s float32 peak: the round runs float32 with
TF32 off, so the reference's bf16 peak of another chip means nothing here).
``plan_hbm_bytes`` is the captured round's pool footprint plus its static
inputs, and ``hbm_bound_q`` the q at which that footprint would fill the
card (:func:`~orion_tpu_torch.compiler_plane.predict_hbm_bound_q`).

On the CPU (only where the caller names it) no graph is captured: the times
are ``perf_counter`` ms of eager rounds, ``mfu_vs_f32_peak``,
``plan_hbm_bytes`` and ``hbm_bound_q`` are None, and the row's ``backend``
says ``cpu``.

Run: ``python -m orion_tpu_torch.benchmarks.runner --op suggest``.
One JSON line per headline shape.
"""

import json
import statistics
import time

import numpy as np
import torch

from orion_tpu_torch.algo.step_graphs import StepGraphs
from orion_tpu_torch.algo.tpu_bo import _suggest_step, flop_analysis_fn, make_fused_plan
from orion_tpu_torch.benchmarks.gram_bench import PEAK_F32_FLOPS
from orion_tpu_torch.compiler_plane import (
    FLOPS_LABEL,
    device_hbm_capacity,
    predict_hbm_bound_q,
)
from orion_tpu_torch.device import resolve_device

# The three headline shapes.  n_obs is the steady-state fit-buffer size:
# hartmann6's history pads to 256 through the whole timed loop; the
# trust-region presets cap the fit set at tr_local_m.  fit_steps is the
# steady-state (warm-refit) count each preset actually runs.
SHAPES = {
    "hartmann6-q1024": dict(
        d=6, n_obs=192, q=1024, n_candidates=16384, fit_steps=40,
        fixed_tail_cols=0, rounds_per_run=None,
    ),
    "rosenbrock20-q256": dict(
        d=20, n_obs=256, q=256, n_candidates=16384, fit_steps=30,
        fixed_tail_cols=0, rounds_per_run=4,
    ),
    "ackley50-q512": dict(
        # asha_bo: 50 free dims + 1 pinned fidelity-context column.
        d=51, n_obs=512, q=512, n_candidates=8192, fit_steps=10,
        fixed_tail_cols=1, rounds_per_run=7,
    ),
}

#: Replays back to back between the two events of one ``device_seconds``
#: sample (the reference's name for its longer chain).
_K_HI = 4


def _step_kwargs(cfg, kernel="matern52"):
    return dict(
        q=cfg["q"],
        n_candidates=cfg["n_candidates"],
        kernel=kernel,
        acq="thompson",
        fit_steps=cfg["fit_steps"],
        local_frac=0.5,
        local_sigma=0.1,
        beta=2.0,
        trust_region=True,
        tr_perturb_dims=20,
        fixed_tail_cols=cfg["fixed_tail_cols"],
        mesh=None,
    )


def _make_args(cfg, rng, device="cpu"):
    """The round's inputs: a seeded generator for its draws (the
    reference's ``PRNGKey(0)``), the reference's numpy draws of x, y and
    the mask in a pow-2 buffer, the incumbent, ``None`` for the cold start
    (``init_hypers``, as the reference passes) and the trust-region
    length."""
    n, d = cfg["n_obs"], cfg["d"]
    n_pad = 1 << (n - 1).bit_length()
    x = np.zeros((n_pad, d), dtype=np.float32)
    y = np.zeros((n_pad,), dtype=np.float32)
    mask = np.zeros((n_pad,), dtype=np.float32)
    x[:n] = rng.uniform(size=(n, d))
    y[:n] = rng.normal(size=n)
    mask[:n] = 1.0
    best_x = x[int(np.argmin(y[:n]))]
    generator = torch.Generator(device=device).manual_seed(0)
    return (
        generator,
        torch.as_tensor(x, device=device),
        torch.as_tensor(y, device=device),
        torch.as_tensor(mask, device=device),
        torch.as_tensor(best_x, device=device),
        None,
        0.8,
    )


def _plan(args, step_kw):
    """The next round's :class:`FusedPlan` (fresh draws from the args'
    generator)."""
    generator, x, y, mask, best_x, warm, tr_length = args
    kw = {k: v for k, v in step_kw.items() if k != "q"}
    return make_fused_plan(generator, x, y, mask, best_x, warm, step_kw["q"],
                           tr_length=tr_length, **kw)


def _capture(graphs, plan):
    """The round's first run through ``graphs`` (on the card its warm-up
    round and capture); returns the entry."""
    graphs.run(_suggest_step, plan.signature, plan.arrays, plan.statics)
    ((_device, _signature, entry),) = graphs.entries()
    return entry


def _device_seconds(graphs, plan, reps, k_hi):
    device = plan.arrays[1].device
    if device.type != "cuda":
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            graphs.run(_suggest_step, plan.signature, plan.arrays, plan.statics)
            samples.append(time.perf_counter() - t0)
        return statistics.median(samples)
    samples = [graphs.replay_ms(device, plan.signature, k_hi) / k_hi / 1e3
               for _ in range(reps)]
    return statistics.median(samples)


def device_seconds(shape, reps=8, k_hi=_K_HI, kernel="matern52", device=None):
    """Median device seconds of one replay of the fused suggest round's
    graph at a :data:`SHAPES` entry: ``reps`` samples of ``k_hi`` replays
    back to back between two CUDA events (on the CPU, where the caller
    names it: the median ``perf_counter`` seconds of an eager round).
    ``device`` ``None`` means ``cuda``."""
    dev = resolve_device(device)
    cfg = SHAPES[shape]
    step_kw = _step_kwargs(cfg, kernel=kernel)
    plan = _plan(_make_args(cfg, np.random.default_rng(0), dev), step_kw)
    graphs = StepGraphs()
    try:
        _capture(graphs, plan)
        return _device_seconds(graphs, plan, reps, k_hi)
    finally:
        graphs.reset()


def _wall_ms(graphs, args, step_kw, reps):
    """Median ms of one round from plan to rows on the host."""
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        plan = _plan(args, step_kw)
        (rows, _state), _entry, _missed = graphs.run(
            _suggest_step, plan.signature, plan.arrays, plan.statics)
        rows[:plan.num].cpu()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def _public_round_ms(cfg, device, reps=5):
    """One observe+suggest round through the public algorithm API at the
    same steady-state shape (hartmann6's is the main path's loop)."""
    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.space.dsl import build_space

    if cfg["fixed_tail_cols"]:
        return None  # asha_bo's public round is rung-scheduled, not shape-stable
    d = cfg["d"]
    rng = np.random.default_rng(0)
    space = build_space({f"x{i:02d}": "uniform(0, 1)" for i in range(d)})
    algo = create_algo(
        space,
        {"tpu_bo": {"n_init": 16, "n_candidates": cfg["n_candidates"],
                     "fit_steps": cfg["fit_steps"]}},
        seed=0, device=device,
    )
    n0 = cfg["n_obs"] - 32
    names = sorted(space.keys())

    def observe(rows):
        params = [dict(zip(names, map(float, row))) for row in rows]
        algo.observe(params, [{"objective": float(v)} for v in rng.normal(size=len(rows))])

    observe(rng.uniform(size=(n0, d)).astype(np.float32))
    algo.suggest(cfg["q"])  # the signature's capture
    best = float("inf")
    for _ in range(reps):
        observe(rng.uniform(size=(16, d)).astype(np.float32))  # mark GP stale
        t0 = time.perf_counter()
        algo.suggest(cfg["q"])
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def run_suggest_bench(reps=8, shapes=None, kernel="matern52", device=None):
    """One row per :data:`SHAPES` entry (those named in ``shapes``, default
    all) on ``device`` (``None`` means ``cuda``); prints and returns
    them."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(0)
    rows = []
    for name, cfg in SHAPES.items():
        if shapes and name not in shapes:
            continue
        step_kw = _step_kwargs(cfg, kernel=kernel)
        args = _make_args(cfg, rng, dev)
        plan = _plan(args, step_kw)
        # The compiler plane's FLOP count: one eager round of its own, off
        # every captured path (a bench is a declared cold path).
        flops = flop_analysis_fn(plan.arrays, plan.statics)()["flops"]
        graphs = StepGraphs()
        try:
            entry = _capture(graphs, plan)
            device_s = _device_seconds(graphs, plan, reps, _K_HI)
            wall_ms = _wall_ms(graphs, args, step_kw, reps)
            # The first capture of a cache of its own: its pool measured alone.
            hbm_bytes = entry.alone_bytes + entry.static_bytes if on_card else None
        finally:
            graphs.reset()
        public_ms = _public_round_ms(cfg, dev)
        achieved = flops / device_s if device_s > 0 else float("nan")
        row = {
            "shape": name,
            "n_obs": cfg["n_obs"],
            "q": cfg["q"],
            "n_candidates": cfg["n_candidates"],
            "fit_steps": cfg["fit_steps"],
            "device_ms": device_s * 1e3,
            "wall_ms": wall_ms,
            "host_ms": wall_ms - device_s * 1e3,
            "public_api_ms": public_ms,
            "gflops_per_call": flops / 1e9,
            "gflops_label": FLOPS_LABEL + "; a lower bound: triangular solves are not counted",
            "achieved_tflops": achieved / 1e12,
            "mfu_vs_f32_peak": achieved / PEAK_F32_FLOPS if on_card else None,
            "plan_hbm_bytes": hbm_bytes,
            "hbm_bound_q": predict_hbm_bound_q(
                {"q": cfg["q"]}, hbm_bytes, device_hbm_capacity(dev)
            ),
            "backend": dev.type,
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    run_suggest_bench()
