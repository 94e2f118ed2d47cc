#!/usr/bin/env python
"""Multi-fidelity sweep example on the PyTorch port.

The counterpart of ``examples/fidelity_sweep.py`` for ``orion_tpu_torch``:
a training run whose cost scales with ``--epochs`` and whose validation
loss approaches the truth as epochs grow, exactly the structure a
``fidelity(...)`` dimension exploits.  ASHA (or its model-based variants)
evaluates many cheap low-epoch configurations and promotes only the
promising ones to full budget.  The script itself is pure Python.

Run under the framework (any of asha / hyperband / asha_bo / bohb):

    orion-tpu-torch hunt -n fid-sweep --storage-path db.sqlite --max-trials 60 \\
        -c <(echo 'algorithms: {asha_bo: {num_brackets: 2}}') \\
        examples/torch_fidelity_sweep.py \\
        --lr~'loguniform(1e-4, 1e-1)' \\
        --width~'uniform(16, 256, discrete=True)' \\
        --epochs~'fidelity(1, 27, 3)'

Then inspect promotions: `orion-tpu-torch info -n fid-sweep --storage-path
db.sqlite` — the same (lr, width) point re-appears at rising epochs.
"""

import argparse
import math

from orion_tpu_torch.client import report_objective


def noisy_validation_loss(lr, width, epochs):
    """Stand-in for a real training curve: the asymptotic loss depends on
    the hyperparameters; finite epochs add an optimistic-bias term that
    shrinks as 1/epochs (the classic multi-fidelity correlation)."""
    asymptote = (math.log10(lr) + 2.0) ** 2 + (width - 96) ** 2 / 128.0**2
    finite_budget_bias = 0.5 / epochs
    return asymptote + finite_budget_bias


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--lr", type=float, required=True)
    parser.add_argument("--width", type=int, required=True)
    parser.add_argument("--epochs", type=int, required=True)
    args = parser.parse_args()
    report_objective(noisy_validation_loss(args.lr, args.width, args.epochs))


if __name__ == "__main__":
    main()
