"""`orion-tpu-torch metrics`: the merged cross-worker snapshot as Prometheus
text (port of ``orion_tpu/cli/metrics.py``).

Workers flush their telemetry snapshots through the storage metrics
channel; this command merges them (``telemetry.merge_snapshots`` —
counters/buckets sum, gauges MAX) and renders the result in Prometheus
text exposition format, the same body a live ``/metrics`` endpoint serves.
For airgapped scraping: no open port on any worker — run this against the
shared store and hand the output to a Pushgateway, a node-exporter
textfile collector, or a file the scraper reads.
"""
from orion_tpu_torch.cli.base import add_experiment_args, build_from_args


def add_subparser(subparsers):
    parser = subparsers.add_parser(
        "metrics",
        help="merged cross-worker metrics in Prometheus exposition format",
    )
    add_experiment_args(parser, with_user_args=False)
    parser.add_argument(
        "--out",
        default=None,
        metavar="path",
        help="write the exposition to a file instead of stdout (textfile-"
        "collector handoff)",
    )
    parser.set_defaults(func=main)
    return parser


def main(args):
    from orion_tpu_torch.metrics import render_exposition
    from orion_tpu_torch.telemetry import merge_snapshots

    experiment, _parser = build_from_args(
        args, need_user_args=False, allow_create=False, view=True
    )
    docs = experiment.storage.fetch_metrics(experiment)
    if not docs:
        print(
            f"no metrics recorded for experiment {experiment.name!r} — run "
            "the hunt with ORION_TPU_TELEMETRY=1 (or `telemetry: true` in "
            "the config) to collect them"
        )
        return 1
    body = render_exposition(merge_snapshots(docs))
    if args.out:
        with open(args.out, "w") as handle:
            handle.write(body)
        print(f"wrote exposition of {len(docs)} worker snapshot(s) to {args.out}")
    else:
        print(body, end="")
    return 0
