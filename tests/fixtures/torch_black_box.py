#!/usr/bin/env python
"""Quadratic black box of the port's plugin tests: known optimum
f(34.56) = 23.4; reports the objective and its gradient through
``orion_tpu_torch.client`` and checks the worker's environment contract."""

import argparse
import os

from orion_tpu_torch.client import report_results


def main():
    assert os.environ.get("ORION_TRIAL_ID"), "env contract missing: ORION_TRIAL_ID"
    assert os.environ.get("ORION_EXPERIMENT_NAME"), "env contract missing"
    parser = argparse.ArgumentParser()
    parser.add_argument("-x", type=float, required=True)
    args = parser.parse_args()
    y = (args.x - 34.56) ** 2 + 23.4
    report_results(
        [
            {"name": "objective", "type": "objective", "value": y},
            {"name": "gradient", "type": "gradient", "value": [2 * (args.x - 34.56)]},
        ]
    )


if __name__ == "__main__":
    main()
