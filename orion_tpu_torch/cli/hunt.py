"""`orion-tpu-torch hunt`: run the optimization loop (port of
``orion_tpu/cli/hunt.py``).

Capability parity: reference `src/orion/core/cli/hunt.py` — build the
experiment from args, then `workon` it.  The port adds ``--device``: the
algorithm runs on ``cuda`` unless ``--device cpu`` is given, and the command
fails where no card is present rather than running on the CPU.
``--profile DIR`` traces each worker's loop with ``torch.profiler`` into
``DIR/trace-<pid>.json``.
"""

import os
import sys

from orion_tpu_torch.cli.base import add_experiment_args, build_from_args
from orion_tpu_torch.core.worker import format_stats, workon
from orion_tpu_torch.utils.exceptions import BrokenExperiment


def add_subparser(subparsers):
    parser = subparsers.add_parser("hunt", help="run optimization")
    add_experiment_args(parser)
    group = parser.add_argument_group("worker")
    group.add_argument("--max-trials", type=int, default=None, help="total completed-trial budget")
    group.add_argument(
        "--worker-trials",
        type=int,
        default=None,
        help="trials this worker executes before exiting (default: unlimited)",
    )
    group.add_argument("--pool-size", type=int, default=None,
                       help="suggestions per producer round")
    group.add_argument("--working-dir", default=None, help="permanent trial working directory")
    group.add_argument("--max-broken", type=int, default=None, help="broken-trial budget")
    group.add_argument(
        "--heartbeat",
        type=float,
        default=None,
        help="seconds before a silent reserved trial counts as lost",
    )
    group.add_argument(
        "--max-idle-time",
        type=float,
        default=None,
        help="seconds the producer may go without registering a new point",
    )
    group.add_argument(
        "--pipeline-depth",
        type=int,
        default=None,
        help="speculative producer rounds kept in flight on the device while "
        "host work (storage commit, codec) runs underneath (default 1)",
    )
    group.add_argument(
        "--n-workers",
        type=int,
        default=1,
        help="run this many asynchronous workers against the shared storage "
        "(this process plus N-1 spawned ones; same semantics as launching "
        "the identical hunt command N times)",
    )
    group.add_argument(
        "--profile",
        metavar="DIR",
        default=None,
        help="trace each worker's loop with torch.profiler (CPU and CUDA "
        "activities) into DIR/trace-<pid>.json (Chrome trace format)",
    )
    group.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="device of the algorithm (default cuda; the command fails where "
        "no CUDA device is present unless cpu is given).  Ignored with a "
        "serve: section: the gateway's algorithm runs on the gateway's card",
    )
    parser.set_defaults(func=main)
    return parser


# Children must never re-spawn.  Argv surgery is unsound both ways: flag
# stripping misses argparse prefix abbreviations (--n-worker), and an
# appended override lands inside the user_args REMAINDER, so the child
# still parses the original count — either way a fork bomb.  An env
# sentinel is immune to every argv form and leaves user args untouched.
_SPAWNED_ENV = "ORION_TPU_SPAWNED_WORKER"


def _spawn_workers(args, experiment):
    """N-1 child processes running the identical hunt (the reference's
    'submit the same command N times' cluster recipe, built in).  The
    experiment is built BEFORE spawning so children resume it."""
    import subprocess

    from orion_tpu_torch.core.consumer import with_package_on_path
    from orion_tpu_torch.storage.documents import MemoryDB
    from orion_tpu_torch.utils.exceptions import CheckError

    if isinstance(getattr(experiment.storage, "db", None), MemoryDB):
        raise CheckError(
            "--n-workers needs storage processes can share (--storage-path "
            "file or sqlite); in-memory storage is per-process."
        )
    argv = list(getattr(args, "_argv", []) or [])
    if not argv:
        # Programmatic callers building args by hand have no invocation to
        # replay; spawning bare children would print help and "fail".
        raise CheckError(
            "--n-workers requires the CLI invocation (argv) to replay in "
            "child processes; call through orion_tpu_torch.cli.main, or "
            "launch workers yourself."
        )
    env = dict(os.environ)
    env[_SPAWNED_ENV] = "1"
    # The children import the package whatever their cwd.
    with_package_on_path(env)
    return [
        subprocess.Popen([sys.executable, "-m", "orion_tpu_torch.cli", *argv], env=env)
        for _ in range(args.n_workers - 1)
    ]


def _run_worker(experiment, parser, args, device):
    def run():
        workon(
            experiment,
            parser,
            worker_trials=args.worker_trials,
            max_idle_time=experiment.max_idle_time,
            # Pacemaker must beat the sweep threshold comfortably or live
            # trials get recovered as lost.
            heartbeat_interval=experiment.heartbeat / 2.0,
        )

    if not args.profile:
        run()
        return
    from orion_tpu_torch.compiler_plane import profiler_capture

    # The span marks the loop's extent in the trace: the wall time the
    # device's busy time is read against.  `profile --capture` shares it.
    with profiler_capture(args.profile, device, span="hunt.workon"):
        run()


def main(args):
    import torch

    from orion_tpu_torch.cli.base import load_cli_config
    from orion_tpu_torch.device import resolve_device

    if load_cli_config(args).get("serve"):
        # The suggest gateway owns the card: a worker that drives a gateway
        # tenant is a host process and never calls into CUDA (not even to
        # ask whether a card is present).
        device = torch.device("cpu")
    else:
        try:
            device = resolve_device(args.device)
        except RuntimeError as exc:
            print(f"ERROR: {exc}", file=sys.stderr)
            return 1
    experiment, parser = build_from_args(args)
    experiment.instantiate(device=device)
    workers = []
    if getattr(args, "n_workers", 1) > 1 and not os.environ.get(_SPAWNED_ENV):
        workers = _spawn_workers(args, experiment)
    try:
        try:
            _run_worker(experiment, parser, args, device)
        except BrokenExperiment as exc:
            print(f"Error: {exc}", file=sys.stderr)
            # Children hit the same broken budget and stop on their own.
            for proc in workers:
                proc.wait()
            return 1
    except BaseException:
        # Any other parent failure (storage errors, Ctrl-C): the cohort
        # must not be orphaned to keep consuming the budget in the
        # background after the command "exited".
        for proc in workers:
            proc.terminate()
        for proc in workers:
            proc.wait()
        raise
    # Stats must reflect the WHOLE cohort's work, so join EVERY child first
    # (a list, not a short-circuiting any(): stragglers would outlive the
    # command and keep consuming budget).
    codes = [proc.wait() for proc in workers]
    if not os.environ.get(_SPAWNED_ENV):
        # Only the parent reports; N interleaved copies of the same stats
        # block from the children would drown the terminal.
        print(format_stats(experiment))
    return 1 if any(code != 0 for code in codes) else 0
