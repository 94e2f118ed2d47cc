"""`orion-tpu-torch doctor`: SLO watchdog and automated diagnosis over every
telemetry plane (port of ``orion_tpu/cli/doctor.py``).

The diagnosis layer (``orion_tpu_torch.diagnosis``) joins the storage
telemetry/health/flight channels and the sharded control plane's
replication probes into one snapshot and evaluates the severity-ranked
rule catalog (docs/monitoring.md, "Diagnosis & runbook").

Exit-code contract for automation: 0 = healthy (info/warn findings are
advice), 1 = at least one CRITICAL finding.  ``--watch`` re-diagnoses
every interval, deduplicating repeat findings into one alert each
(published as ``flight.alert`` events into the experiment's spans channel
and as the ``doctor.findings.*`` gauges), and accumulates replication
probes so the lag-growth trend rule has a series to work with.
"""

import json
import sys
import time

from orion_tpu_torch.cli.base import (
    add_experiment_args,
    build_all_experiments,
    build_from_args,
)


def add_subparser(subparsers):
    parser = subparsers.add_parser(
        "doctor",
        help="diagnose a hunt: severity-ranked findings with runbook links",
    )
    add_experiment_args(parser, with_user_args=False)
    parser.add_argument(
        "--all",
        action="store_true",
        help="diagnose every experiment in the store, not just -n NAME",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="print machine-readable findings (one report per experiment)",
    )
    parser.add_argument(
        "--watch",
        action="store_true",
        help="re-diagnose every interval; repeat findings alert once and "
        "re-alert only after clearing",
    )
    parser.add_argument(
        "-i",
        "--interval",
        type=float,
        default=10.0,
        metavar="seconds",
        help="watch-mode interval (default: 10s)",
    )
    parser.add_argument(
        "--iterations",
        type=int,
        default=0,
        metavar="N",
        help="watch mode: run N passes then exit with the last status "
        "(default 0 = until interrupted)",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the registered rule catalog and exit",
    )
    parser.set_defaults(func=main)
    return parser


def _resolve_experiments(args, view=True):
    """One-shot diagnosis is read-only (a view); ``--watch`` publishes
    alert spans into the storage channel, so it builds real experiments —
    the write is the point, not an accident a view should block."""
    if getattr(args, "all", False):
        return build_all_experiments(args, view=view)
    experiment, _parser = build_from_args(
        args, need_user_args=False, allow_create=False, view=view
    )
    return [experiment]


def _diagnose(experiments, replication_series):
    """(label, experiment, report) per experiment; the per-experiment
    replication probe history is threaded through ``replication_series``
    (a dict the watch loop owns) so trend rules see a series."""
    from orion_tpu_torch.diagnosis import collect_snapshot, run_rules

    out = []
    for experiment in experiments:
        label = f"{experiment.name} v{experiment.version}"
        snapshot = collect_snapshot(
            experiment, replication_series=replication_series.get(label)
        )
        if snapshot.replication is not None:
            history = replication_series.setdefault(label, [])
            history.append(snapshot.replication)
            del history[:-32]
        out.append((label, experiment, run_rules(snapshot)))
    return out


def main(args):
    if getattr(args, "list_rules", False):
        from orion_tpu_torch.diagnosis import doctor_catalog

        for rule_id, name, severity, runbook, description in doctor_catalog():
            print(f"{rule_id} [{severity}] {name}: {description}")
            print(f"    runbook: docs/monitoring.md#{runbook}")
        return 0

    replication_series = {}
    if not args.watch:
        experiments = _resolve_experiments(args)
        results = _diagnose(experiments, replication_series)
        exit_code = 0
        outputs = []
        for label, _experiment, report in results:
            exit_code = max(exit_code, report.exit_code)
            if args.json:
                outputs.append({"experiment": label, **report.to_dict()})
            else:
                outputs.append(report.format_human(label))
        if args.json:
            print(json.dumps(outputs if getattr(args, "all", False) else outputs[0]))
        else:
            print("\n\n".join(outputs))
        return exit_code

    from orion_tpu_torch.diagnosis import publish_report
    from orion_tpu_torch.diagnosis.watch import AlertDeduper

    dedupers = {}
    passes = 0
    exit_code = 0
    try:
        while True:
            # --all re-resolves each pass: a watch on a shared store must
            # pick up experiments created after it started.
            experiments = _resolve_experiments(args, view=False)
            frames = []
            reports = []
            exit_code = 0
            for label, experiment, report in _diagnose(
                experiments, replication_series
            ):
                deduper = dedupers.setdefault(label, AlertDeduper())
                publish_report(
                    report,
                    new_findings=deduper.new_findings(report.findings),
                    storage=experiment.storage,
                    experiment=experiment,
                )
                exit_code = max(exit_code, report.exit_code)
                frames.append(report.format_human(label))
                reports.append({"experiment": label, **report.to_dict()})
            # Per-experiment watch state lives only as long as the
            # experiment does: a store with tenant churn must not grow
            # dedupers/probe history without bound, and a deleted-then-
            # recreated experiment must not inherit its predecessor's
            # dedup state (its first alert would be silently swallowed).
            current = {r["experiment"] for r in reports}
            for stale in set(dedupers) - current:
                del dedupers[stale]
            for stale in set(replication_series) - current:
                del replication_series[stale]
            if args.json:
                sys.stdout.write(
                    json.dumps(
                        {
                            "pass": passes + 1,
                            "time": time.time(),
                            "status": "critical" if exit_code else "ok",
                            # The full findings, not just the verdict: the
                            # JSON stream is the automation surface, and a
                            # consumer must learn WHICH rule fired where.
                            "experiments": reports,
                        }
                    )
                    + "\n"
                )
            else:
                sys.stdout.write("\x1b[2J\x1b[H" + "\n\n".join(frames) + "\n")
            sys.stdout.flush()
            passes += 1
            if args.iterations and passes >= args.iterations:
                return exit_code
            time.sleep(max(args.interval, 0.5))
    except KeyboardInterrupt:
        return exit_code
