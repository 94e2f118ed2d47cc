"""`orion-tpu-torch setup` — top-level alias for `db setup` (port of
``orion_tpu/cli/setup_cmd.py``).

Capability parity: reference `src/orion/core/cli/setup.py` keeps the
historical `orion setup` spelling alongside `orion db setup`; both write
the user-level storage configuration.
"""

from orion_tpu_torch.cli.db import add_setup_args, main_setup


def add_subparser(subparsers):
    parser = subparsers.add_parser(
        "setup", help="write the user configuration file (alias for `db setup`)"
    )
    add_setup_args(parser)
    parser.set_defaults(func=main_setup)
    return parser
