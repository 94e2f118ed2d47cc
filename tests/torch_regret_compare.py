"""Final simple regret of ``orion_tpu`` and of the port, run through the
same plain loop on the CPU over seeds 0..n-1, at a run of
``chip_smoke.ALGO_RUNS``:

    JAX_PLATFORMS=cpu python tests/torch_regret_compare.py tpe-hartmann6 10

The loop is ``chip_smoke.run_algorithm``'s: ``suggest(batch)``, evaluate,
``observe``, until the run's trials or ``is_done``.  The two packages'
random streams differ, so the comparison is between distributions: one
line per package with its per-seed regrets and their median.
"""

import os
import statistics
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from orion_tpu.algo.base import create_algo as jax_create_algo  # noqa: E402
from orion_tpu.space.dsl import build_space as jax_build_space  # noqa: E402
from orion_tpu_torch.algo.base import create_algo  # noqa: E402
from orion_tpu_torch.benchmarks.functions import BENCHMARKS  # noqa: E402
from orion_tpu_torch.space.dsl import build_space  # noqa: E402


def final_regret(algo, space, fn_name, max_trials, batch):
    spec = BENCHMARKS[fn_name]
    best, n_done = float("inf"), 0
    while n_done < max_trials and not algo.is_done:
        params = algo.suggest(min(batch, max_trials - n_done))
        if params is None:
            break
        cube = np.asarray(space.params_to_cube(params), np.float32)
        values = spec["fn"](torch.from_numpy(cube)).numpy()
        algo.observe(params, [{"objective": float(v)} for v in values])
        best = min(best, float(values.min()))
        n_done += len(params)
    return best - spec["optimum"]


def main(run, n_seeds):
    name, priors, fn_name, config, max_trials, batch, _seeds = next(
        r for r in chip_smoke.ALGO_RUNS if r[0] == run)
    out = {}
    for label, make in (
        ("reference", lambda s: (jax_create_algo(jax_build_space(priors), config, seed=s),
                                 jax_build_space(priors))),
        ("port", lambda s: (create_algo(build_space(priors), config, seed=s, device="cpu"),
                            build_space(priors))),
    ):
        regrets = [final_regret(*make(s), fn_name, max_trials, batch) for s in range(n_seeds)]
        out[label] = regrets
        print(f"{name} {label}: median {statistics.median(regrets):.6g} "
              f"per seed {[round(r, 6) for r in regrets]}", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
