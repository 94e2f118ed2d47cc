"""`orion-tpu-torch trace`: export an experiment's merged telemetry trace
(port of ``orion_tpu/cli/trace.py``).

Workers running with telemetry enabled flush their span records through
the storage channel every producer round; this command merges every
worker's spans into one Chrome trace-event JSON (load it in Perfetto /
chrome://tracing — each worker process appears as its own track, the
storage ops nested inside their ``producer.round``) or, with ``--format
jsonl``, one span per line for ad-hoc tooling.

``--distributed`` additionally joins the SERVER side of the experiment's
traces (spans flushed under the reserved ``__server__`` id, matched back
by trace_id); the port has no server until ``netdb`` (ROADMAP queue A item
7), so today it adds nothing.  ``--attribute`` additionally prints the
per-trace critical-path table: each sampled round's wall time bucketed
into client-host / wire / server-host / device
(``orion_tpu_torch.tracing``).
"""
import json

from orion_tpu_torch.cli.base import add_experiment_args, build_from_args


def add_subparser(subparsers):
    parser = subparsers.add_parser(
        "trace", help="export the merged telemetry trace of an experiment"
    )
    add_experiment_args(parser, with_user_args=False)
    parser.add_argument(
        "--out",
        default="trace.json",
        metavar="path",
        help="output file (default: trace.json)",
    )
    parser.add_argument(
        "--format",
        choices=("chrome", "jsonl"),
        default="chrome",
        help="chrome = trace-event JSON for Perfetto (default); "
        "jsonl = one span object per line",
    )
    parser.add_argument(
        "--distributed",
        action="store_true",
        help="merge server-side spans (netdb __server__ channel) into the "
        "experiment's traces by trace_id — cross-process flow arrows",
    )
    parser.add_argument(
        "--attribute",
        action="store_true",
        help="print the per-trace critical-path attribution table "
        "(client-host / wire / server-host / device) in addition to "
        "writing the trace file",
    )
    parser.set_defaults(func=main)
    return parser


def main(args):
    from orion_tpu_torch.telemetry import write_chrome_trace
    from orion_tpu_torch.tracing import collect_distributed_spans, format_attribution

    experiment, _parser = build_from_args(
        args, need_user_args=False, allow_create=False, view=True
    )
    if args.distributed or args.attribute:
        spans = collect_distributed_spans(experiment.storage, experiment)
    else:
        spans = experiment.storage.fetch_spans(experiment)
    if not spans:
        print(
            f"no spans recorded for experiment {experiment.name!r} — run the "
            "hunt with ORION_TPU_TELEMETRY=1 (or `telemetry: true` in the "
            "config) to collect them"
        )
        return 1
    if args.format == "jsonl":
        with open(args.out, "w") as handle:
            for span in spans:
                handle.write(json.dumps(span) + "\n")
    else:
        write_chrome_trace(args.out, spans)
    workers = {s.get("worker") for s in spans if s.get("worker")}
    print(
        f"wrote {len(spans)} spans from {max(len(workers), 1)} worker(s) "
        f"to {args.out}"
    )
    if args.attribute:
        # Next to the file, never instead of it: a scripted pipeline that
        # passed --out must still find its artifact.
        print(format_attribution(spans))
    return 0
