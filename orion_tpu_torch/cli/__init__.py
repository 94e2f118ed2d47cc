"""`orion-tpu-torch` command-line interface (port of ``orion_tpu/cli``).

Capability parity: reference `src/orion/core/cli/__init__.py` + `cli/base.py`
— subcommand modules are auto-discovered (any module in this package exposing
``add_subparser``), so only the commands the port has appear; global
verbosity/version flags, and common experiment argument groups shared across
commands.
"""

import argparse
import importlib
import logging
import pkgutil
import sys

import orion_tpu_torch

log = logging.getLogger(__name__)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="orion-tpu-torch",
        description="Asynchronous hyperparameter optimization on one NVIDIA GPU "
        "(the PyTorch port of orion-tpu)",
    )
    parser.add_argument(
        "-V", "--version", action="version",
        version=f"orion-tpu-torch {orion_tpu_torch.__version__}",
    )
    parser.add_argument(
        "-v",
        "--verbose",
        action="count",
        default=0,
        help="logging level: -v info, -vv debug",
    )
    subparsers = parser.add_subparsers(dest="command", metavar="COMMAND")

    import orion_tpu_torch.cli as cli_pkg

    for module_info in sorted(pkgutil.iter_modules(cli_pkg.__path__), key=lambda m: m.name):
        if module_info.name.startswith("_") or module_info.name == "base":
            continue
        module = importlib.import_module(f"orion_tpu_torch.cli.{module_info.name}")
        if hasattr(module, "add_subparser"):
            module.add_subparser(subparsers)
    return parser


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    parser = build_parser()
    args = parser.parse_args(argv)
    # Raw argv: commands that re-spawn themselves (hunt --n-workers) need
    # the exact invocation, not a reconstruction from parsed args.
    args._argv = argv
    level = {0: logging.WARNING, 1: logging.INFO}.get(args.verbose, logging.DEBUG)
    logging.basicConfig(level=level, format="%(levelname)s %(name)s: %(message)s")
    if not getattr(args, "func", None):
        parser.print_help()
        return 1
    from orion_tpu_torch.utils.exceptions import (
        CheckError,
        DatabaseError,
        NoConfigurationError,
    )

    try:
        return args.func(args) or 0
    except (NoConfigurationError, DatabaseError, CheckError) as exc:
        # Expected operational failures (misconfigured storage, a missing
        # experiment) get a one-line error, not a traceback; -v re-raises
        # for debugging.
        if args.verbose:
            raise
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
