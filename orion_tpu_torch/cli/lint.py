"""`orion-tpu-torch lint`: check the port's own invariants statically
(port of ``orion_tpu/cli/lint.py``).

The port's conventions (a GP round that stays capturable as a CUDA graph,
retry-covered storage ops, allocation-free disabled telemetry, vectorized
producer rounds, acyclic lock order) are enforceable from the AST, and
this command is how they are enforced (``orion_tpu_torch.analysis``;
``--list-rules`` prints the catalog).  Exit code 0 = clean, 1 =
violations found, 2 = bad path argument or an unknown rule prefix.
"""


def add_subparser(subparsers):
    parser = subparsers.add_parser(
        "lint", help="statically check the port's invariant conventions"
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=None,
        metavar="path",
        help="files or directories to lint (default: the installed "
        "orion_tpu_torch package)",
    )
    parser.add_argument(
        "--select",
        default=None,
        metavar="RULES",
        help="comma-separated rule-id prefixes to run (e.g. JIT,STO002)",
    )
    parser.add_argument(
        "--ignore",
        default=None,
        metavar="RULES",
        help="comma-separated rule-id prefixes to skip",
    )
    parser.add_argument(
        "--format",
        choices=("human", "json"),
        default="human",
        help="output format (default: human)",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalog and exit",
    )
    parser.set_defaults(func=main)
    return parser


def _split(value):
    return [part.strip() for part in value.split(",") if part.strip()] if value else None


def main(args):
    import os
    import sys

    from orion_tpu_torch.analysis import format_human, format_json, rule_catalog, run_lint
    from orion_tpu_torch.analysis.engine import UNREADABLE_PATH

    if args.list_rules:
        for rule_id, name, description in rule_catalog():
            print(f"{rule_id}  {name}")
            print(f"    {description}")
        return 0

    paths = args.paths
    if not paths:
        import orion_tpu_torch

        paths = [os.path.dirname(os.path.abspath(orion_tpu_torch.__file__))]
    try:
        diagnostics = run_lint(
            paths, select=_split(args.select), ignore=_split(args.ignore)
        )
    except ValueError as exc:  # typo'd --select/--ignore prefix
        print(f"ERROR: {exc}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(format_json(diagnostics))
    else:
        print(format_human(diagnostics))
    # A bad ARGUMENT (missing path, non-Python file, empty directory) is a
    # usage error, not a lint verdict: exit 2, keyed off the engine's own
    # LNT003 findings so path validation lives in ONE place (run_lint).  An
    # LNT003 on a file merely discovered under a valid directory argument
    # is a lint finding like any other: exit 1.
    arg_paths = set(paths)
    if any(d.rule_id == UNREADABLE_PATH and d.path in arg_paths for d in diagnostics):
        return 2
    return 1 if diagnostics else 0
