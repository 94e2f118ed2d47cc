"""Measurements of ``chip_smoke.py``'s paths on one CUDA card.

``legs`` times, one after the other in one process, each leg of
``chip_smoke.py`` that a depth cut shortened, at its depth before the cut
and at its depth after it (``hunt``'s two backends, ``cli``'s one worker,
``evc``, ``network`` (a) and (b), ``serve`` (b)): one JSON line a leg and
depth, with its seconds.

``drain`` runs ``chip_smoke.py``'s ``day2`` phase (on a fresh ``network``
(b) plane) twice: as the script runs it, and with the live drain's workers
started 40 s after the drain (``DAY2_WORKERS_LATE_S``), as on a host whose
first GP round registers that much later; one JSON line each with the
phase's seconds and the live drain's timeline (drain window, the gates,
the GP round's registration, the fence, trials ended in and after it).

``traces`` runs ``chip_smoke.py``'s ``cli`` workers cohort (eight profiled
``hunt`` processes) with this checkout's package and, given ``--parent
DIR``, with the package of the checkout in DIR, in turns (this, parent,
parent, this), then its regret cohort, then reads the kernel and range
events of the last two cohorts' traces four times, by parsing each whole trace and by the
script's scan (``chip_smoke.trace_events``) in turns (parse, scan, scan,
parse; both must agree): one JSON line a reading with its seconds, one
line a cohort with its wall seconds, and one line a cohort process with
its ``hunt.workon`` loop's start and end against the cohort's start and
end (from the trace's own clock, ``baseTimeNanoseconds`` plus ``ts``).

``bytecode`` times a fresh process importing the CLI's ``hunt`` with and
without ``chip_smoke.py``'s bytecode cache (``chip_smoke.warm_bytecode``,
whose warming process it times too), then the ``cli`` workers cohort
without and with the cache in turns (without, with, with, without): one
JSON line a process or cohort, each cohort with its processes' loop starts.

``mix`` runs the main path's ``tpu_bo`` through an ``ExperimentClient`` on
memory storage whose q bucket changes from round to round, as a hunt's does
when its workers ask for different batch sizes: one JSON line with each
round's ms, the captures (``cuda_graph.recaptures``), and the step graphs'
pool beside every graph pool of the process.  It uses only the package's
entry points, so another checkout of the package can run it too, to compare
two versions on one card in one call::

    python3 tests/torch_chip_legs.py legs
    python3 tests/torch_chip_legs.py drain
    python3 tests/torch_chip_legs.py traces [--parent build/parent]
    python3 tests/torch_chip_legs.py bytecode
    PYTHONPATH=. python3 tests/torch_chip_legs.py mix --label change
    PYTHONPATH=<other checkout> python3 tests/torch_chip_legs.py mix --label parent
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The mix's q for each round after the first, random, one.
MIX_QS = (1024, 256, 1024, 64, 512, 1024, 128, 1024, 256, 1024)
MIX_ALGO = {"n_init": 16, "n_candidates": 16384, "fit_steps": 40, "local_frac": 0.3, "seed": 0}


def _graph_pool_bytes():
    """Every private (graph) pool's reserved bytes, from the allocator."""
    return sum(int(seg["total_size"]) for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id") or (0, 0)) != (0, 0))


def mix(label):
    import gc

    import orion_tpu_torch.device  # noqa: F401  (precision switches)
    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.client.experiment import ExperimentClient
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.storage.base import create_storage
    from orion_tpu_torch.telemetry import TELEMETRY

    device = torch.device("cuda")
    TELEMETRY.enabled = True
    storage = create_storage({"type": "memory"})
    exp = build_experiment(storage, "mix", priors={f"x{i}": "uniform(0, 1)" for i in range(6)},
                           max_trials=100000, pool_size=8,
                           algorithms={"tpu_bo": dict(MIX_ALGO)}).instantiate(seed=0,
                                                                              device=device)
    client = ExperimentClient(exp)
    rounds = []
    for q in (72,) + MIX_QS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trials = client.suggest(q)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cube = torch.as_tensor(exp.space.params_to_cube([t.params for t in trials]),
                               device=exp.algorithm.device)
        client.observe_all(trials, hartmann6(cube).cpu().numpy().tolist())
        rounds.append({"q": q, "suggest_ms": ms,
                       "captures": TELEMETRY.snapshot()["counters"].get(
                           "cuda_graph.recaptures", 0)})
    gc.collect()
    torch.cuda.empty_cache()  # the dead graphs' pools: only live ones stay
    gp = rounds[1:]
    print(json.dumps({
        "label": label, "package": os.path.dirname(orion_tpu_torch.device.__file__),
        "rounds": rounds, "gp_suggest_ms_total": sum(r["suggest_ms"] for r in gp),
        "captures": rounds[-1]["captures"], "signatures": len(STEP_GRAPHS.entries()),
        "step_graphs_pool_bytes": STEP_GRAPHS.pool_bytes(),
        "process_graph_pool_bytes": _graph_pool_bytes(),
        "fresh_pools": getattr(STEP_GRAPHS, "fresh_pools", None),
        "alone_captures": getattr(STEP_GRAPHS, "alone_captures", None),
        "smi": _smi()}), flush=True)


def _smi():
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip()


def legs():
    sys.path.append(ROOT)
    import chip_smoke as cs
    import orion_tpu_torch.device  # noqa: F401  (precision switches)
    from orion_tpu_torch.storage.base import create_storage

    device = torch.device("cuda")
    cs.phase_build()
    print(json.dumps({"smi": _smi()}), flush=True)

    def timed(leg, depth, fn):
        t0 = time.perf_counter()
        fn()
        print(json.dumps({"leg": leg, "depth": depth,
                          "seconds": time.perf_counter() - t0}), flush=True)

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        def fresh(name):
            path = os.path.join(tmp, name)
            os.makedirs(path)
            return path

        for rounds in (5, 4):
            run_dir = fresh(f"hunt{rounds}")
            for backend in ("pickled", "memory"):
                storage = create_storage({"type": backend,
                                          "path": os.path.join(run_dir, "hunt.pkl")})
                timed(f"hunt {backend}", rounds,
                      lambda: cs.run_hunt(device, storage, rounds=rounds))
        for trials, evc in ((128, 32), (32, 16)):
            run_dir = fresh(f"cli{trials}")
            timed("cli one worker", trials,
                  lambda: cs.run_cli_hunt(run_dir, device, max_trials=trials))
            timed("evc", evc, lambda: cs.run_evc_chain(run_dir, device, max_trials=evc))
        for trials in (64, 32):
            run_dir = fresh(f"server{trials}")
            timed("network server", trials,
                  lambda: cs.run_network_server(run_dir, device, max_trials=trials))
            run_dir = fresh(f"shards{trials}")
            timed("network shards", trials,
                  lambda: cs.run_network_shards(run_dir, device, max_trials=trials))
        for trials in (16, 8):
            run_dir = fresh(f"serve{trials}")
            gateway = cs._ServeProcess(run_dir, cs._free_port(),
                                       os.path.join(run_dir, "gateway.pkl"))
            gateway.start()
            try:
                timed("serve workers", trials,
                      lambda: cs.run_serve_workers(run_dir, device, gateway, max_trials=trials))
            finally:
                gateway.kill()


def drain(lates=(0.0, 40.0)):
    sys.path.append(ROOT)
    import chip_smoke as cs
    import orion_tpu_torch.device  # noqa: F401  (precision switches)

    device = torch.device("cuda")
    cs.phase_build()
    print(json.dumps({"smi": _smi()}), flush=True)
    lines = []
    real_emit = cs.emit
    cs.emit = lambda phase, **fields: lines.append(fields) or real_emit(phase, **fields)
    try:
        for late in lates:
            cs.DAY2_WORKERS_LATE_S = late
            with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
                plane, _admin = cs.run_network_shards(tmp, device)
                del lines[:]
                t0 = time.perf_counter()
                cs.phase_day2(device, tmp, plane.pop("plane"))
                seconds = time.perf_counter() - t0
            run = next(line for line in lines if line.get("run") == "drain")
            keys = ("drain_window_s", "migrator_started_s", "gates_opened_s",
                    "gp_round_registered_s", "fence_window_ms", "trials_ended_before_fence",
                    "trials_ended_in_fence", "trials_ended_after_flip", "workers_wall_s")
            print(json.dumps({"leg": "day2", "workers_late_s": late, "seconds": seconds,
                              **{k: run[k] for k in keys}}), flush=True)
    finally:
        cs.emit = real_emit


def _loop_window(path):
    """Wall-clock seconds (epoch) of the ``hunt.workon`` span of a trace."""
    with open(path) as handle:
        trace = json.load(handle)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    (loop,) = [e for e in trace["traceEvents"]
               if e.get("name") == "hunt.workon" and e.get("cat") == "user_annotation"]
    return (base_us + loop["ts"]) / 1e6, (base_us + loop["ts"] + loop["dur"]) / 1e6


def traces(parent=None):
    sys.path.append(ROOT)
    import chip_smoke as cs
    import orion_tpu_torch.device  # noqa: F401  (precision switches)

    device = torch.device("cuda")
    cs.phase_build()
    print(json.dumps({"smi": _smi()}), flush=True)
    cohorts = []
    real_cohort = cs.run_cohort
    package = {"root": ROOT}

    def timed_cohort(commands, timeout, env=None):
        start = time.time()
        # Both packages load the kernel this checkout built (the same source).
        wall_s = real_cohort(commands, timeout, env=dict(
            env or {}, PYTHONPATH=package["root"],
            ORION_TPU_JIT_CACHE=os.path.join(ROOT, "build")))
        cohorts.append((package["label"], start, start + wall_s, [cwd for _argv, cwd in commands]))
        print(json.dumps({"leg": "cohort", "cohort": package["label"], "wall_s": wall_s}),
              flush=True)
        return wall_s

    arms = [("this checkout", ROOT)]
    if parent:
        arms.append(("parent", os.path.abspath(parent)))
    cs.run_cohort = timed_cohort
    try:
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
            for i, (label, root) in enumerate(arms + arms[::-1]):
                package.update(root=root, label=f"cli workers, {label}")
                run_dir = os.path.join(tmp, f"workers{i}")
                os.makedirs(run_dir)
                cs.run_cli_workers(run_dir, device)
            package.update(root=ROOT, label="cli regret, this checkout")
            cs.run_cli_regret(tmp, device)
            paths = []  # the last workers cohort's and the regret cohort's: read below
            for label, start, end, cwds in cohorts:
                for cwd in cwds:
                    prof = os.path.join(cwd, "profile")
                    for name in sorted(f for f in os.listdir(prof) if f.startswith("trace-")):
                        path = os.path.join(prof, name)
                        if (label, start) in [(c[0], c[1]) for c in cohorts[-2:]]:
                            paths.append(path)
                        loop_start, loop_end = _loop_window(path)
                        print(json.dumps({"leg": "cohort process", "cohort": label,
                                          "trace": name, "cohort_wall_s": end - start,
                                          "loop_start_s": loop_start - start,
                                          "loop_end_s": loop_end - start,
                                          "after_loop_s": end - loop_end}), flush=True)
            nbytes = sum(os.path.getsize(p) for p in paths)
            readings = {}
            for mode in ("parse", "scan", "scan", "parse"):
                t0 = time.perf_counter()
                if mode == "scan":
                    events = [cs.trace_events(p) for p in paths]
                else:
                    events = []
                    for p in paths:
                        with open(p) as handle:
                            events.append(cs.json_trace_events(handle.read()))
                seconds = time.perf_counter() - t0
                readings.setdefault(mode, events)
                print(json.dumps({"leg": "trace reads", "mode": mode, "traces": len(paths),
                                  "bytes": nbytes, "events": sum(map(len, events)),
                                  "seconds": seconds}), flush=True)
            if readings["scan"] != readings["parse"]:
                raise AssertionError("the scan and the parse read different events")
    finally:
        cs.run_cohort = real_cohort


def bytecode():
    sys.path.append(ROOT)
    import chip_smoke as cs
    import orion_tpu_torch.device  # noqa: F401  (precision switches)

    device = torch.device("cuda")
    cs.phase_build()
    print(json.dumps({"smi": _smi()}), flush=True)
    shutil.rmtree(cs.PYCACHE, ignore_errors=True)

    def start_ms(cache):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPYCACHEPREFIX"}
        if cache:
            env["PYTHONPYCACHEPREFIX"] = cs.PYCACHE
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import orion_tpu_torch.cli.hunt, torch"],
                       env=dict(env, PYTHONPATH=ROOT), check=True)
        return (time.perf_counter() - t0) * 1e3

    print(json.dumps({"leg": "process", "cache": False, "ms": start_ms(False)}), flush=True)
    t0 = time.perf_counter()
    warm = cs.warm_bytecode()
    warm.wait()
    print(json.dumps({"leg": "warm", "rc": warm.returncode,
                      "seconds": time.perf_counter() - t0}), flush=True)
    for cache in (True, False, True):
        print(json.dumps({"leg": "process", "cache": cache, "ms": start_ms(cache)}), flush=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for i, cache in enumerate((False, True, True, False)):
            if cache:
                os.environ["PYTHONPYCACHEPREFIX"] = cs.PYCACHE
            else:
                os.environ.pop("PYTHONPYCACHEPREFIX", None)
            run_dir = os.path.join(tmp, f"workers{i}")
            os.makedirs(run_dir)
            start = time.time()
            out = cs.run_cli_workers(run_dir, device)
            prof = os.path.join(run_dir, "workers", "profile")
            starts = sorted(_loop_window(os.path.join(prof, f))[0] - start
                            for f in os.listdir(prof) if f.startswith("trace-"))
            print(json.dumps({"leg": "cli workers", "cache": cache, "wall_s": out["wall_s"],
                              "loop_starts_s": starts}), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("legs", "mix", "drain", "traces", "bytecode"))
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--parent", default=None,
                        help="traces: a checkout whose package the cli workers cohort "
                             "also runs, in turns with this one's")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_chip_legs: no CUDA device", file=sys.stderr)
        return 1
    if args.what == "mix":
        mix(args.label)
    else:
        {"legs": legs, "drain": drain, "bytecode": bytecode,
         "traces": lambda: traces(args.parent)}[args.what]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
