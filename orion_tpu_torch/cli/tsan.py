"""`orion-tpu-torch tsan`: run a command under the runtime concurrency
sanitizer (port of ``orion_tpu/cli/tsan.py``).

The port's multithreaded stack (the step-graph cache against the bucket
prewarmer's capture threads, the doctor watchdog, the telemetry registry,
the netdb driver, the pacemaker) needs its lock discipline *proved at
runtime*, not just statically screened
(``orion_tpu_torch.analysis.sanitizer``; the static half is the ``LCK*``
rules of ``orion_tpu_torch.analysis``).  The child process runs with
instrumented lock/event shims, vector-clock race detection over the
annotated shared cells, and the seeded interleaving explorer; every
process of the run (``hunt --n-workers`` children inherit the env) merges
its report into one file.  The observed lock graph is then cross-checked
against the static LCK graph of ``orion_tpu_torch/`` (runtime edges the
static resolver missed = ``LCK003``; static cycles confirmed at runtime
are escalated).  Exit code 0 = clean, 1 = violations (data races,
lock-order cycles, or cross-check findings), 2 = usage error / no report
produced; a clean report over a FAILING command propagates the command's
exit code (a CI gate must not read swallowed test failures as success).
"""


def add_subparser(subparsers):
    import argparse

    parser = subparsers.add_parser(
        "tsan",
        help="run a command under the runtime concurrency sanitizer",
    )
    parser.add_argument(
        "--seed",
        type=int,
        default=0,
        help="interleaving-explorer seed (default: 0; same seed = same "
        "forced-switch schedule)",
    )
    parser.add_argument(
        "--switch-rate",
        type=float,
        default=None,
        metavar="RATE",
        help="probability of a forced thread switch at each instrumented "
        "lock acquisition (default: sanitizer default)",
    )
    parser.add_argument(
        "--out",
        default=None,
        metavar="PATH",
        help="also write the merged JSON report to PATH",
    )
    parser.add_argument(
        "--format",
        choices=("human", "json"),
        default="human",
        help="stdout format (default: human)",
    )
    parser.add_argument(
        "--paths",
        nargs="*",
        default=None,
        metavar="PATH",
        help="files/directories for the static cross-check (default: the "
        "orion_tpu_torch package)",
    )
    parser.add_argument(
        "--no-cross-check",
        action="store_true",
        help="skip the static LCK-graph cross-check",
    )
    parser.add_argument(
        "cmd",
        nargs=argparse.REMAINDER,
        metavar="-- CMD [ARG...]",
        help="command to run instrumented (everything after --)",
    )
    parser.set_defaults(func=main)
    return parser


def _merged_report(report, args):
    """The child's tsan report + the static cross-check block.

    The LCK003 leg runs through ``run_lint`` so suppressions at the
    acquisition site (`# lint: disable=LCK003 -- reason`) argue an edge
    away exactly like any other lint finding; ``unmodeled_edges`` keeps
    the raw pre-suppression list for the report's audit trail."""
    from orion_tpu_torch.analysis import run_lint
    from orion_tpu_torch.analysis.sanitizer import (
        cross_check_static,
        set_lint_runtime_edges,
    )

    if args.no_cross_check:
        report["cross_check"] = None
        return report
    paths = args.paths
    if not paths:
        import os

        import orion_tpu_torch

        paths = [os.path.dirname(os.path.abspath(orion_tpu_torch.__file__))]
    check = cross_check_static(report.get("edges") or [], paths)
    set_lint_runtime_edges(report.get("edges") or [])
    try:
        check["lck003"] = [
            d.to_dict() for d in run_lint(paths, select=["LCK003"])
        ]
    finally:
        set_lint_runtime_edges(None)
    report["cross_check"] = check
    return report


def _format_human(report):
    lines = []
    for cycle in report.get("lock_order_cycles") or []:
        lines.append(
            "POTENTIAL DEADLOCK: lock-order cycle "
            + " -> ".join(cycle["cycle"])
        )
        for edge in cycle["edges"]:
            lines.append(f"  edge {edge['outer']} -> {edge['inner']}:")
            for label, stack in (
                ("outer", edge.get("outer_stack") or ["?"]),
                ("inner", edge.get("inner_stack") or ["?"]),
            ):
                lines.append(f"    {label} acquired at: {stack[0]}")
    for race in report.get("races") or []:
        lines.append(
            f"DATA RACE ({race['kind']}) on {race['cell']}: "
            f"{race['site_a']} vs {race['site_b']}"
        )
    check = report.get("cross_check")
    if check:
        for finding in check.get("lck003") or []:
            lines.append(
                f"{finding['path']}:{finding['line']}: LCK003 "
                f"{finding['message']}"
            )
        for cycle in check.get("confirmed_static_cycles") or []:
            lines.append(
                "RUNTIME-CONFIRMED static cycle: " + " -> ".join(cycle)
            )
    lines.append(
        f"{len(report.get('races') or [])} race(s), "
        f"{len(report.get('lock_order_cycles') or [])} cycle(s), "
        f"{len(report.get('edges') or [])} observed edge(s), "
        f"{report.get('switches', 0)} forced switch(es)"
    )
    return "\n".join(lines)


def _violations(report):
    check = report.get("cross_check") or {}
    return (
        len(report.get("races") or [])
        + len(report.get("lock_order_cycles") or [])
        # Suppression-aware LCK003 findings count; the raw unmodeled-edge
        # list is audit context (a suppressed edge was argued, not missed).
        + len(check.get("lck003") or [])
        + len(check.get("confirmed_static_cycles") or [])
    )


def main(args):
    import json
    import os
    import subprocess
    import sys
    import tempfile

    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print(
            "ERROR: no command given; usage: orion-tpu-torch tsan [options] -- "
            "CMD [ARG...]",
            file=sys.stderr,
        )
        return 2

    handle = tempfile.NamedTemporaryFile(
        prefix="orion-tsan-", suffix=".json", delete=False
    )
    handle.close()
    env = dict(os.environ)
    env["ORION_TPU_TSAN"] = "1"
    env["ORION_TPU_TSAN_SEED"] = str(args.seed)
    env["ORION_TPU_TSAN_REPORT"] = handle.name
    # The child must import THIS orion_tpu_torch (the env hook lives in
    # its __init__), but `python /path/to/script.py` puts the SCRIPT's dir
    # at sys.path[0], not our cwd — from an uninstalled checkout the child
    # would silently run uninstrumented (and write no report).  Prepend
    # the package root to PYTHONPATH so the child resolves the same tree.
    import orion_tpu_torch

    package_root = os.path.dirname(
        os.path.dirname(os.path.abspath(orion_tpu_torch.__file__))
    )
    existing = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (
        package_root + os.pathsep + existing if existing else package_root
    )
    if args.switch_rate is not None:
        env["ORION_TPU_TSAN_SWITCH"] = str(args.switch_rate)
    try:
        proc = subprocess.run(cmd, env=env)
        try:
            with open(handle.name) as report_file:
                report = json.load(report_file)
        except (OSError, ValueError):
            print(
                f"ERROR: instrumented command wrote no tsan report "
                f"(exit code {proc.returncode}) — does it import orion_tpu_torch?",
                file=sys.stderr,
            )
            return 2
    finally:
        try:
            os.unlink(handle.name)
        except OSError:  # pragma: no cover
            pass

    report["command"] = cmd
    report["command_returncode"] = proc.returncode
    report = _merged_report(report, args)
    if args.out:
        with open(args.out, "w") as out_file:
            json.dump(report, out_file, indent=2)
    if args.format == "json":
        print(json.dumps(report))
    else:
        print(_format_human(report))
        if proc.returncode:
            print(f"(command exited {proc.returncode})")
    if _violations(report):
        return 1
    if proc.returncode:
        # Signals/exotic codes clamp to 1; 2 is reserved for usage errors
        # of THIS command, but a child's own 2 still must not read clean.
        return proc.returncode if 0 < proc.returncode < 128 else 1
    return 0
