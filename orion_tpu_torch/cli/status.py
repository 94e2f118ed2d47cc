"""`orion-tpu-torch status`: trial counts by status per experiment / EVC tree
(port of ``orion_tpu/cli/status.py``).

Capability parity: reference `src/orion/core/cli/status.py` — all
experiments by default or one via ``-n``; ``--all`` lists individual trials,
``--collapse`` aggregates an EVC tree into its root, versions shown as an
indented forest.
"""

from orion_tpu_torch.cli.base import add_experiment_args, load_cli_config
from orion_tpu_torch.core.trial import ALL_STATUSES
from orion_tpu_torch.storage.base import setup_storage


def add_subparser(subparsers):
    parser = subparsers.add_parser("status", help="trial counts by status")
    add_experiment_args(parser, with_user_args=False)
    parser.add_argument("-a", "--all", action="store_true", help="list every trial")
    parser.add_argument(
        "-C", "--collapse", action="store_true",
        help="aggregate each EVC tree into its root experiment",
    )
    parser.add_argument(
        "-e", "--expand-versions", action="store_true",
        help="one section per experiment version instead of aggregating a "
        "name's versions together (reference `cli/status.py:41`)",
    )
    parser.set_defaults(func=main)
    return parser


def _status_table(trials):
    counts = {}
    for trial in trials:
        counts[trial.status] = counts.get(trial.status, 0) + 1
    lines = [f"{'status':<14}{'quantity':<10}"]
    lines.append(f"{'-' * 12:<14}{'-' * 8:<10}")
    for status in ALL_STATUSES:
        if status in counts:
            lines.append(f"{status:<14}{counts[status]:<10}")
    if not counts:
        lines.append("(no trials)")
    return lines


def _trial_lines(trials):
    lines = [f"{'id':<34}{'status':<14}{'best objective':<16}"]
    for trial in sorted(trials, key=lambda t: t.submit_time or 0):
        obj = trial.objective.value if trial.objective else ""
        lines.append(f"{trial.id:<34}{trial.status:<14}{obj!s:<16}")
    return lines


def main(args):
    config = load_cli_config(args)
    storage = setup_storage(config["storage"], force=True)

    query = {}
    if config.get("name"):
        query["name"] = config["name"]
    if config.get("user"):
        query["metadata.user"] = config["user"]
    experiments = sorted(
        storage.fetch_experiments(query),
        key=lambda e: (e["name"], e.get("version", 1)),
    )
    if not experiments:
        print("No experiment found")
        return 0

    if getattr(args, "collapse", False):
        # Group by EVC root (refers.root_id), not by name — a branch created
        # under a different name still belongs to its original tree.
        by_id = {e["_id"]: e for e in experiments}
        by_root = {}
        for exp in experiments:
            root_id = (exp.get("refers") or {}).get("root_id") or exp["_id"]
            by_root.setdefault(root_id, []).append(exp)
        for root_id, family in sorted(
            by_root.items(), key=lambda kv: by_id.get(kv[0], kv[1][0])["name"]
        ):
            name = by_id.get(root_id, family[0])["name"]
            print(f"{name}")
            print("=" * len(name))
            trials = []
            for exp in family:
                trials.extend(storage.fetch_trials(uid=exp["_id"]))
            body = _trial_lines(trials) if args.all else _status_table(trials)
            print("\n".join(body) + "\n")
        return 0

    by_name = {}
    for exp in experiments:
        by_name.setdefault(exp["name"], []).append(exp)

    expand = getattr(args, "expand_versions", False)
    for name, versions in sorted(by_name.items()):
        if expand:
            # One section per version (reference --expand-versions).
            for exp in versions:
                title = f"{name}-v{exp.get('version', 1)}"
                print(title)
                print("=" * len(title))
                trials = storage.fetch_trials(uid=exp["_id"])
                body = _trial_lines(trials) if args.all else _status_table(trials)
                print("\n".join(body) + "\n")
        else:
            # Default: a name's versions aggregate into one section
            # (reference shows only the latest/aggregated unless expanded).
            print(name)
            print("=" * len(name))
            trials = []
            for exp in versions:
                trials.extend(storage.fetch_trials(uid=exp["_id"]))
            body = _trial_lines(trials) if args.all else _status_table(trials)
            print("\n".join(body) + "\n")
    return 0
