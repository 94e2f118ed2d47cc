"""`orion-tpu-torch audit`: check an experiment's storage invariants (port
of ``orion_tpu/cli/audit.py``).

Walks the experiment's raw trial documents and reports every violation of
the cross-trial invariants (unique ids, no duplicated parameter points,
status/heartbeat consistency, completed ⇒ objective present, no orphaned
reservations past the sweep threshold).  Exit code 0 = clean, 1 =
violations found — cron-able as a fleet health check next to
`orion-tpu-torch status`.

Left out: a failed audit's flight-record dump (``--flight-out``; the
flight recorder is ROADMAP queue A item 5, and naming the option raises
:class:`NotImplementedError`; without it no dump is made, as in the
reference with its recorder off) and the ``--all`` shard-topology line,
which none of the port's storages has (ROADMAP queue A item 7).
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
        "(not ported yet: ROADMAP queue A item 5)",
    )
    parser.set_defaults(func=main)
    return parser


def main(args):
    from orion_tpu_torch.storage.audit import audit_experiment, audit_storage

    if getattr(args, "flight_out", None) is not None:
        raise NotImplementedError(
            "audit --flight-out needs the flight recorder, which is not "
            "ported yet: ROADMAP queue A item 5"
        )
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
        reports = audit_storage(storage, lost_timeout=timeout)
        if not reports:
            print("no experiments in storage")
            return 0
        for report in reports:
            print(report.summary())
        return 0 if all(r.ok for r in reports) else 1

    experiment, _parser = build_from_args(
        args, need_user_args=False, allow_create=False, view=True
    )
    report = audit_experiment(
        experiment.storage, experiment, lost_timeout=args.timeout
    )
    print(report.summary())
    return 0 if report.ok else 1
