"""`orion-tpu-torch audit`: check an experiment's storage invariants (port
of ``orion_tpu/cli/audit.py``).

Walks the experiment's raw trial documents and reports every violation of
the cross-trial invariants (unique ids, no duplicated parameter points,
status/heartbeat consistency, completed ⇒ objective present, no orphaned
reservations past the sweep threshold).  Exit code 0 = clean, 1 =
violations found — cron-able as a fleet health check next to
`orion-tpu-torch status`.

A failed audit dumps a flight-record artifact (``--flight-out PATH``, or
``flight-audit-<experiment>.jsonl`` with the flight recorder on): the
recent event ring plus one ``audit.violation`` event per violation.

``--all`` over a sharded store prints the topology line first and labels
each report with the shard its experiment lives on.
"""

from orion_tpu_torch.cli.base import add_experiment_args, build_from_args


def add_subparser(subparsers):
    parser = subparsers.add_parser(
        "audit", help="check an experiment's storage invariants"
    )
    add_experiment_args(parser, with_user_args=False)
    parser.add_argument(
        "--timeout",
        type=float,
        default=None,
        metavar="seconds",
        help="orphaned-reservation threshold (default: the experiment's "
        "heartbeat setting)",
    )
    parser.add_argument(
        "--all",
        action="store_true",
        help="audit every experiment in the storage, not just -n NAME",
    )
    parser.add_argument(
        "--flight-out",
        default=None,
        metavar="path",
        help="where a failed audit dumps its flight-record artifact "
        "(default: flight-audit-<experiment>.jsonl)",
    )
    parser.set_defaults(func=main)
    return parser


def _dump_failure(report, out=None, suffix=False):
    """A failed audit leaves a flight-record JSONL artifact: the recent
    event ring (when this process recorded any) plus every violation as a
    structured event — the post-mortem starts from the artifact, not from
    scrollback.  Violations ride ``extra_events`` so this cold path needs
    no guarded hot-path ``record`` calls.

    Only dumps when the operator asked for observability: the flight
    recorder is enabled, or ``--flight-out`` names a path explicitly — a
    cron audit that never opted in must not scatter artifacts into its
    cwd (same rule as ``FlightRecorder.dump_crash``).  ``suffix=True``
    (the ``--all`` sweep with an explicit path) keys the file by
    experiment so multiple failing experiments don't overwrite each
    other's dumps."""
    import os
    import time

    from orion_tpu_torch.health import FLIGHT

    if out is None and not FLIGHT.enabled:
        print(
            "audit failed; pass --flight-out PATH (or enable the flight "
            "recorder) to dump a flight-record artifact"
        )
        return None
    events = [
        {
            "kind": "audit.violation",
            "ts": time.time(),
            "args": dict(violation),
        }
        for violation in report.violations
    ]
    path = out or f"flight-audit-{report.experiment_id}.jsonl"
    if suffix and out is not None:
        root, ext = os.path.splitext(out)
        path = f"{root}-{report.experiment_id}{ext or '.jsonl'}"
    FLIGHT.dump(path, reason="audit-failure", extra_events=events)
    print(f"audit failed; flight record written to {path}")
    return path


def main(args):
    from orion_tpu_torch.storage.audit import audit_experiment, audit_storage

    if getattr(args, "all", False):
        # Whole-storage sweep needs the raw storage, not one experiment;
        # reuse the name-less config/storage bootstrap path.
        from orion_tpu_torch.cli.base import load_cli_config
        from orion_tpu_torch.storage.base import setup_storage

        config = load_cli_config(args)
        storage = setup_storage(config["storage"], force=True)
        # heartbeat is a worker-level knob, never part of the stored
        # experiment identity (cli/base.py) — resolve the threshold from
        # the same config layers the -n NAME path applies to
        # experiment.heartbeat, so --all and -n agree on what "orphaned"
        # means.
        timeout = args.timeout
        if timeout is None:
            timeout = config.get("heartbeat")
        from orion_tpu_torch.cli.base import describe_storage_topology

        topology = describe_storage_topology()
        if topology is not None:
            # The --all sweep resolved through the sharded router: every
            # shard's experiments are in the report set, and each one is
            # labeled with its ring placement below.
            print(topology)
        reports = audit_storage(storage, lost_timeout=timeout)
        if not reports:
            print("no experiments in storage")
            return 0
        shard_for = getattr(storage.db, "shard_for", None)
        for report in reports:
            if shard_for is not None:
                print(f"[shard {shard_for(report.experiment_id)}]", end=" ")
            print(report.summary())
        failed = [r for r in reports if not r.ok]
        for report in failed:
            # Per-experiment suffixing when several fail: one shared
            # --flight-out path must not have each dump overwrite the last.
            _dump_failure(
                report,
                getattr(args, "flight_out", None),
                suffix=len(failed) > 1,
            )
        return 0 if all(r.ok for r in reports) else 1

    experiment, _parser = build_from_args(
        args, need_user_args=False, allow_create=False, view=True
    )
    report = audit_experiment(
        experiment.storage, experiment, lost_timeout=args.timeout
    )
    print(report.summary())
    if not report.ok:
        _dump_failure(report, getattr(args, "flight_out", None))
    return 0 if report.ok else 1
