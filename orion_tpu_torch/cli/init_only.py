"""`orion-tpu-torch init-only`: register the experiment without running
trials (port of ``orion_tpu/cli/init_only.py``).

Capability parity: reference `src/orion/core/cli/init_only.py`.
"""

from orion_tpu_torch.cli.base import add_experiment_args, build_from_args


def add_subparser(subparsers):
    parser = subparsers.add_parser(
        "init-only", help="create the experiment without executing trials"
    )
    add_experiment_args(parser)
    parser.add_argument("--max-trials", type=int, default=None)
    parser.set_defaults(func=main)
    return parser


def main(args):
    experiment, _parser = build_from_args(args)
    print(f"Initialized experiment {experiment.name} (v{experiment.version})")
    return 0
