"""Host-side profiler for the full hunt loop (port of
``orion_tpu/benchmarks/host_profile.py``).

The device decomposition (``runner --op suggest``) answers "what is the
card doing"; this tool answers "what is the HOST doing" — the producer/
storage/codec cycle that bounds trials/sec on the q-batch presets.  It
runs the preset once at a quarter of the budget first, so that the kernel
build, the step graphs' captures and import time don't drown the
steady-state signal, then profiles a second run with ``cProfile``.

Run: ``python -m orion_tpu_torch.benchmarks.host_profile [preset]
[--trials N] [--batch B] [--device cpu]`` (defaults: asha-ackley50, 2048
trials, batch 512, on ``cuda``; ``--device cpu`` profiles the host logic
with the algorithms on the CPU).
"""

import argparse
import cProfile
import io
import pstats


def main(argv=None):
    from orion_tpu_torch.benchmarks.runner import PRESETS, run_preset

    parser = argparse.ArgumentParser(prog="orion_tpu_torch.benchmarks.host_profile")
    parser.add_argument("preset", nargs="?", default="asha-ackley50",
                        choices=list(PRESETS))
    parser.add_argument("--trials", type=int, default=2048)
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--top", type=int, default=20,
                        help="rows of the tottime table to print")
    parser.add_argument("--device", default=None,
                        help="where the algorithm runs (default: cuda; no "
                             "fallback to the CPU)")
    args = parser.parse_args(argv)

    # Warm pass: absorbs the kernel build, captures and import time at a
    # quarter budget.
    run_preset(args.preset, seed=0, max_trials=max(args.trials // 4, args.batch),
               batch_size=args.batch, device=args.device)

    profiler = cProfile.Profile()
    profiler.enable()
    out = run_preset(args.preset, seed=1, max_trials=args.trials,
                     batch_size=args.batch, device=args.device)
    profiler.disable()

    print(out)
    stream = io.StringIO()
    pstats.Stats(profiler, stream=stream).sort_stats("tottime").print_stats(args.top)
    print(stream.getvalue())


if __name__ == "__main__":
    main()
