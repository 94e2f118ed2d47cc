"""Benchmark runner for the BASELINE.md configurations (port of
``orion_tpu/benchmarks/runner.py``).

Measures, per (algorithm, function) pair: best objective, simple regret,
suggestions/sec, wall-clock.  The five BASELINE configs map to presets:

1. random / Branin 2D, 200 trials
2. (anchor — sequential CPU GP-EI, implemented in the reference's bench.py)
3. tpu_bo q=256 Thompson / Rosenbrock-20D
4. mixed Real/Integer/Categorical space (LeNet-style hparams, synthetic
   objective standing in for MNIST training — see examples/)
5. ASHA-style multi-fidelity / Ackley-50D, q=4096

Run as ``python -m orion_tpu_torch.benchmarks.runner [preset ...]
[--device cpu]``: the algorithms run on ``cuda`` unless ``--device``
names another device, and a run raises where no card is present.
``--op gram`` and ``--op suggest`` run the micro-benchmarks of
:mod:`~orion_tpu_torch.benchmarks.gram_bench` and
:mod:`~orion_tpu_torch.benchmarks.suggest_bench` instead.
"""

import json
import time

from orion_tpu_torch.benchmarks.functions import BENCHMARKS
from orion_tpu_torch.client.experiment import optimize


def _uniform_priors(n_dims):
    return {f"x{i:02d}": "uniform(0, 1)" for i in range(n_dims)}


def _ackley50_priors():
    """BASELINE config #5 search space, shared by all four ackley50 presets
    so the variants can never drift onto different spaces."""
    return {**_uniform_priors(50), "budget": "fidelity(1, 256, 4)"}


def _mixed_lenet_objective(params):
    """Cheap deterministic stand-in for the LeNet hparam landscape of
    BASELINE config #4 (the real trainable example is examples/mnist_lenet.py;
    the runner preset measures the mixed-space suggest machinery itself).
    Optimum: lr=1e-2, batch_size=128, width=3, act='relu' -> 0."""
    import math

    act_penalty = {"relu": 0.0, "gelu": 0.1, "tanh": 0.3}[params["act"]]
    return (
        (math.log10(params["lr"]) + 2.0) ** 2
        + ((params["batch_size"] - 128) / 96.0) ** 2
        + (params["width"] - 3) ** 2 / 4.0
        + act_penalty
    )


PRESETS = {
    "random-branin": dict(
        priors=_uniform_priors(2), fn="branin", algorithm="random",
        max_trials=200, batch_size=50,
    ),
    "tpu_bo-hartmann6": dict(
        priors=_uniform_priors(6), fn="hartmann6",
        # local_frac 0.3: smooth MULTIMODAL landscapes reward global
        # exploration — 15-seed A/B vs the 0.5 default: median 0.123 ->
        # 0.015, deep-basin seeds 6/15 -> 12/15.  The default stays 0.5
        # because categorical-heavy spaces invert the trade (mixed-lenet's
        # tail blows up below it: max 1.2e-3 -> 0.25); docs/algorithms.md
        # documents the knob per landscape class.
        algorithm={"tpu_bo": {"n_init": 16, "n_candidates": 8192,
                               "fit_steps": 40, "local_frac": 0.3}},
        max_trials=192, batch_size=16,
    ),
    "mixed-lenet": dict(
        priors={
            "lr": "loguniform(1e-4, 1e-1)",
            "batch_size": "uniform(32, 256, discrete=True)",
            "width": "uniform(1, 4, discrete=True)",
            "act": "choices(['relu', 'tanh', 'gelu'])",
        },
        fn_params=_mixed_lenet_objective, optimum=0.0,
        algorithm={"tpu_bo": {"n_init": 16, "n_candidates": 4096, "fit_steps": 30}},
        max_trials=128, batch_size=16,
    ),
    "thompson-rosenbrock20": dict(
        priors=_uniform_priors(20), fn="rosenbrock20",
        algorithm={"tpu_bo": {"n_init": 256, "n_candidates": 16384, "fit_steps": 30}},
        max_trials=1024, batch_size=256,
    ),
    # BASELINE config #5's literal shape: ONE q=4096 batch through the ASHA
    # machinery — a pure scheduling/throughput measurement (every point is
    # pre-model by construction).  The multi-round presets below are the
    # model-quality measurements at the same trial budget.
    "asha-ackley50-q4096": dict(
        priors=_ackley50_priors(),
        fn="ackley50", algorithm={"asha": {"num_brackets": 3}},
        strategy="NoParallelStrategy",
        max_trials=4096, batch_size=4096,
    ),
    # Multi-round schedule (q=512 under a 5-rung fidelity ladder, same
    # 4096-trial budget as round 2's single q=4096 shot) so the model-based
    # variants below actually get observation rounds to learn from — a
    # single-batch run measures scheduling only, and a shallow ladder lets
    # ASHA's is-done (first top-rung completion, reference parity
    # `asha.py:312-314`) fire before the models can act on what they saw.
    "asha-ackley50": dict(
        priors=_ackley50_priors(),
        fn="ackley50", algorithm={"asha": {"num_brackets": 3}},
        strategy="NoParallelStrategy",
        max_trials=4096, batch_size=512,
    ),
    # Config #5 model-based (round-1 verdict #10): fidelity-aware GP sampling
    # under the same ASHA scheduling/budget — compare against asha-ackley50.
    "asha_bo-ackley50": dict(
        priors=_ackley50_priors(),
        fn="ackley50",
        algorithm={"asha_bo": {"n_init": 128, "n_candidates": 8192,
                               "fit_steps": 30, "refit_steps": 10,
                               "local_frac": 0.8, "trust_region": True,
                               "y_transform": "copula",
                               "tr_perturb_dims": 12, "num_brackets": 3}},
        strategy="NoParallelStrategy",
        max_trials=4096, batch_size=512,
    ),
    # Trust-region GP-BO (TuRBO-style + elite-covariance/directional
    # candidates + posterior-mean polish) on the same 20-D valley and trial
    # budget as thompson-rosenbrock20/cmaes-rosenbrock20.  Small batches on
    # purpose: rounds of real success/failure signal are what walk the box
    # down the valley — measured by the reference on its TPU, batch 8
    # (128 rounds) more than halves batch 16's median (258 -> 47.5 over 5
    # seeds), and
    # round 5's fresh-region restarts take the 15-seed median to 35.8
    # [23.0-344] p90 218, ahead of cmaes' 43.6; see BENCH_SEEDS.json.
    "turbo-rosenbrock20": dict(
        priors=_uniform_priors(20), fn="rosenbrock20",
        algorithm={"turbo": {"n_init": 64, "n_candidates": 8192,
                             "fit_steps": 25, "refit_steps": 6,
                             "tr_fail_tol": 2, "tr_perturb_dims": 4,
                             "tr_length_init": 0.4, "tr_length_max": 0.8}},
        max_trials=1024, batch_size=8,
    ),
    # Evolution-strategy family on a hard multimodal landscape where GP
    # lengthscales saturate — same budget as thompson-rosenbrock20.
    "cmaes-rosenbrock20": dict(
        priors=_uniform_priors(20), fn="rosenbrock20",
        # Canonical generational cadence (batch == popsize): generations are
        # the scarce axis for ES, and each update wants samples drawn from
        # the freshly-updated distribution.  5 of the reference's TPU
        # seeds at 1024 trials: median regret 46 [42-408] vs 673 for the (round-4 robust-default)
        # GP preset and 258 for turbo — valley landscapes reward covariance
        # adaptation.
        algorithm={"cmaes": {"popsize": 16}},
        max_trials=1024, batch_size=16,
    ),
    # Differential evolution on the same valley/budget, for the honest
    # family comparison: DE's sweet spot is large-budget/low-D/noisy
    # problems, and at 1024 evals in 20-D it is NOT competitive — 15
    # reference TPU seeds: median 22,880 [14,840-43,378] vs turbo 35.8, cmaes 43.6
    # (BENCH_SEEDS.json r5-sweep5; best/1 chosen over rand/1 by a 5-seed
    # CPU A/B, ~2.9e4 vs ~5.3e4).  The published row is what routes
    # users to turbo/cmaes for this landscape class.
    "de-rosenbrock20": dict(
        priors=_uniform_priors(20), fn="rosenbrock20",
        algorithm={"de": {"popsize": 32, "mutation": "best1"}},
        max_trials=1024, batch_size=32,
    ),
    # TPE-under-Hyperband on the multi-fidelity config, comparable against
    # asha-ackley50 / asha_bo-ackley50 at equal trial budget.
    "bohb-ackley50": dict(
        priors=_ackley50_priors(),
        fn="ackley50",
        algorithm={"bohb": {"n_candidates": 8192, "min_points": 64}},
        strategy="NoParallelStrategy",
        max_trials=4096, batch_size=512,
    ),
}


def run_preset(name, seed=0, algo_overrides=None, device=None, **overrides):
    """``algo_overrides`` merge into the algorithm's OWN config dict (e.g.
    ``{"use_mesh": True}`` to shard an ackley50 preset's suggest step over
    the visible devices); ``overrides`` replace top-level preset keys
    (max_trials, batch_size, ...).  ``device``: where the algorithm runs
    (``None`` means ``cuda``, and raises where no card is present)."""
    cfg = {**PRESETS[name], **overrides}
    if algo_overrides:
        import inspect

        from orion_tpu_torch.algo.base import _import_builtins, algo_registry

        _import_builtins()
        algorithm = cfg["algorithm"]
        if not isinstance(algorithm, dict):
            algorithm = {algorithm: {}}
        merged = {}
        for algo, params in algorithm.items():
            accepted = inspect.signature(algo_registry.get(algo).__init__).parameters
            # A **kwargs constructor (turbo forwards everything to tpu_bo)
            # accepts any override.
            has_var_kw = any(
                p.kind is inspect.Parameter.VAR_KEYWORD for p in accepted.values()
            )
            extra = {
                k: v for k, v in algo_overrides.items()
                if has_var_kw or k in accepted
            }
            skipped = set(algo_overrides) - set(extra)
            if skipped:
                import sys

                # Loud, not fatal: `--use-mesh` over the full preset list must
                # not crash on the algorithms that have no mesh to use.  On
                # stderr — stdout is a machine-readable JSONL stream.
                print(
                    f"# {name}: {algo} does not accept {sorted(skipped)}; skipped",
                    file=sys.stderr,
                )
            merged[algo] = {**params, **extra}
        cfg["algorithm"] = merged
    if "fn_params" in cfg:
        # Host-side params-dict objective (mixed spaces with categoricals).
        fn, batch_eval = cfg.pop("fn_params"), None
        optimum = cfg.pop("optimum")
    else:
        spec = BENCHMARKS[cfg.pop("fn")]
        fn, batch_eval = None, spec["fn"]
        optimum = spec["optimum"]

    t0 = time.perf_counter()
    stats = optimize(
        fn=fn,
        priors=cfg["priors"],
        max_trials=cfg["max_trials"],
        batch_size=cfg["batch_size"],
        algorithm=cfg["algorithm"],
        strategy=cfg.get("strategy"),
        seed=seed,
        name=f"bench-{name}-{seed}",
        batch_eval=batch_eval,
        device=device,
    )
    wall = time.perf_counter() - t0
    best = stats["best_evaluation"]
    return {
        "preset": name,
        "best": best,
        "simple_regret": (best - optimum) if best is not None else None,
        "trials": stats["trials_completed"],
        "wall_s": round(wall, 2),
        "suggestions_per_sec": round(stats["trials_completed"] / wall, 2),
    }


def run_preset_seeds(name, n_seeds, algo_overrides=None, device=None, **overrides):
    """Run a preset over seeds 0..n_seeds-1 and aggregate.

    Single-seed numbers on these landscapes sit on >2x seed variance
    (BASELINE.md's own admissions) — any headline claim must be a
    median +/- range, so the aggregate carries per-seed regrets verbatim
    alongside median/min/max.
    """
    import statistics

    per_seed = [
        run_preset(name, seed=s, algo_overrides=algo_overrides, device=device, **overrides)
        for s in range(n_seeds)
    ]
    regrets = [r["simple_regret"] for r in per_seed if r["simple_regret"] is not None]
    rates = [r["suggestions_per_sec"] for r in per_seed]
    ordered = sorted(regrets)
    out = {
        "preset": name,
        "seeds": n_seeds,
        "regret_median": round(statistics.median(regrets), 6) if regrets else None,
        "regret_min": round(min(regrets), 6) if regrets else None,
        "regret_max": round(max(regrets), 6) if regrets else None,
        # Tail quantile, nearest-rank (ceil(0.9 n)-th order statistic):
        # heavy-tailed presets are the rule on valley landscapes, and a
        # min-max range is dominated by one seed.  At n=5 this IS the max —
        # small samples have no tail information to understate.
        "regret_p90": (
            round(ordered[-(-9 * len(ordered) // 10) - 1], 6) if ordered else None
        ),
        "regret_per_seed": [round(r, 6) for r in regrets],
        "suggestions_per_sec_median": round(statistics.median(rates), 2),
        "wall_s_total": round(sum(r["wall_s"] for r in per_seed), 2),
    }
    return out


def main(argv=None):
    import sys

    argv = list(argv if argv is not None else sys.argv[1:])
    import argparse

    parser = argparse.ArgumentParser(prog="orion_tpu_torch.benchmarks.runner")
    parser.add_argument("--op", choices=["gram", "suggest"],
                        help="run an op micro-benchmark instead of presets")
    parser.add_argument("--kind", default="matern52",
                        choices=["matern52", "rbf"])
    parser.add_argument("--reps", type=int, default=8)
    parser.add_argument("--seeds", type=int, default=None, metavar="N",
                        help="run each preset over seeds 0..N-1 and print "
                             "the median [min-max] aggregate (N >= 1)")
    parser.add_argument("--use-mesh", action="store_true",
                        help="shard each preset's suggest step over the "
                             "visible devices (mesh-capable algorithms only)")
    parser.add_argument("--device", default=None,
                        help="where the algorithms and the micro-benchmarks "
                             "run (default: cuda; no fallback to the CPU)")
    parser.add_argument("presets", nargs="*", metavar="preset",
                        choices=[[]] + list(PRESETS),
                        help=f"presets to run (default: all). {list(PRESETS)}")
    args = parser.parse_args(argv)
    if args.op:
        # Explicit guard (parse_args accepts both): a user combining --op
        # with preset names must not believe the presets silently ran.
        if args.presets:
            parser.error("--op and preset names are mutually exclusive")
        if args.op == "suggest":
            from orion_tpu_torch.benchmarks.suggest_bench import run_suggest_bench

            run_suggest_bench(reps=args.reps, kernel=args.kind, device=args.device)
            return
        from orion_tpu_torch.benchmarks.gram_bench import run_gram_bench

        run_gram_bench(kind=args.kind, reps=args.reps, device=args.device)
        return
    if args.kind != "matern52" or args.reps != 8:
        # --kind/--reps configure the --op micro-bench only; dropping them
        # silently would let the user believe they shaped the preset runs.
        parser.error("--kind/--reps require --op")
    if args.seeds is not None and args.seeds < 1:
        parser.error("--seeds must be >= 1")
    algo_overrides = {"use_mesh": True} if args.use_mesh else None
    for name in args.presets or list(PRESETS):
        if args.seeds is not None:
            print(json.dumps(run_preset_seeds(
                name, args.seeds, algo_overrides=algo_overrides, device=args.device)))
        else:
            print(json.dumps(run_preset(name, algo_overrides=algo_overrides,
                                        device=args.device)))


if __name__ == "__main__":
    main()
