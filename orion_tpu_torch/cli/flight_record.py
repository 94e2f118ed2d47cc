"""`orion-tpu-torch flight-record`: dump an experiment's flight-recorder
events (port of ``orion_tpu/cli/flight_record.py``).

Workers running with the flight recorder enabled mirror their ring events
into the spans storage channel every producer round (as ``flight.*``
records); this command reconstructs that timeline from storage, merges
this process's own ring (usually empty for a plain CLI invocation), and
writes one JSONL artifact — the same format a worker crash or a failed
``orion-tpu-torch audit`` dumps automatically, and the reference's.
"""
from orion_tpu_torch.cli.base import add_experiment_args, build_from_args


def add_subparser(subparsers):
    parser = subparsers.add_parser(
        "flight-record",
        help="dump an experiment's flight-recorder events to a JSONL artifact",
    )
    add_experiment_args(parser, with_user_args=False)
    parser.add_argument(
        "--out",
        default=None,
        metavar="path",
        help="output file (default: flight-<experiment>.jsonl)",
    )
    parser.set_defaults(func=main)
    return parser


def main(args):
    from orion_tpu_torch.health import FLIGHT, spans_as_flight_events

    experiment, _parser = build_from_args(
        args, need_user_args=False, allow_create=False, view=True
    )
    stored = spans_as_flight_events(experiment.storage.fetch_spans(experiment))
    local = FLIGHT.events()
    if not stored and not local:
        print(
            f"no flight events recorded for experiment {experiment.name!r} — "
            "run the hunt with ORION_TPU_TELEMETRY=1 (or `telemetry: true` "
            "in the config) to collect them"
        )
        return 1
    out = args.out or f"flight-{experiment.name}.jsonl"
    path = FLIGHT.dump(out, reason="on-demand", extra_events=stored)
    workers = {e.get("worker") for e in stored if e.get("worker")}
    print(
        f"wrote {len(stored) + len(local)} events "
        f"({len(stored)} from storage, {max(len(workers), 1)} worker(s)) "
        f"to {path}"
    )
    return 0
