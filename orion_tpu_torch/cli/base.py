"""Shared CLI argument groups and experiment bootstrapping (port of
``orion_tpu/cli/base.py``; the ``--all`` fleet helpers wait for the commands
that use them, ROADMAP queue A item 7).  ``load_cli_config`` layers the
``telemetry:`` and ``metrics_port:`` keys onto the process, as the
reference does.

Capability parity: reference `src/orion/core/cli/base.py` — the common
``-n/--name``, ``--version``, ``-c/--config``, ``--debug`` group plus the
trailing ``user_args`` remainder, and the helper that turns parsed args into
a built Experiment (storage setup -> prior extraction -> build/branch).
"""

import os

import yaml

from orion_tpu_torch.config import resolve_config
from orion_tpu_torch.core.experiment import build_experiment
from orion_tpu_torch.io.cmdline import CommandLineParser
from orion_tpu_torch.io.versioning import hash_config_file, infer_versioning_metadata
from orion_tpu_torch.storage.base import setup_storage
from orion_tpu_torch.utils.exceptions import NoConfigurationError


def add_experiment_args(parser, with_user_args=True):
    group = parser.add_argument_group("experiment")
    group.add_argument("-n", "--name", help="experiment name")
    group.add_argument("--exp-version", type=int, default=None, help="experiment version")
    group.add_argument(
        "-u",
        "--user",
        default=None,
        help="user namespace (defaults to the system user; experiments are "
        "stored under metadata.user and -u filters lookups to that user)",
    )
    group.add_argument(
        "-c", "--config", metavar="path", help="orion-tpu configuration file (yaml)"
    )
    group.add_argument(
        "--debug", action="store_true", help="use an in-memory non-persistent storage"
    )
    group.add_argument(
        "--storage-path", default=None,
        help="path of the local storage file (.sqlite/.db selects the "
        "SQLite backend, anything else the pickled one)"
    )
    group.add_argument(
        "--manual-resolution",
        action="store_true",
        help="resolve branching conflicts interactively instead of automatically",
    )
    group.add_argument(
        "--branch-to",
        default=None,
        metavar="name",
        help="on a branching event, give the child experiment this name "
        "instead of a version bump under the same name",
    )
    if with_user_args:
        import argparse

        parser.add_argument(
            "user_args",
            nargs=argparse.REMAINDER,
            metavar="command",
            help="user script and its arguments, with priors as name~'expr'",
        )
    return group


def _storage_type_for_path(path):
    """Backend for --storage-path (header-sniffed; see sqlite_path_selected)."""
    from orion_tpu_torch.storage.sqlitedb import sqlite_path_selected

    return "sqlite" if sqlite_path_selected(path) else "pickled"


def load_cli_config(args):
    """Merge config sources: defaults < env < config file < cmdline.
    Sectioned spellings (`experiment:`, `producer:`, `database:`) are
    normalized inside resolve_config — for every file layer, not just -c."""
    file_config = {}
    if getattr(args, "config", None):
        with open(args.config) as handle:
            file_config = yaml.safe_load(handle) or {}
    cmd_config = {
        key: value
        for key, value in {
            "name": getattr(args, "name", None),
            "version": getattr(args, "exp_version", None),
            "user": getattr(args, "user", None),
            "max_trials": getattr(args, "max_trials", None),
            "pool_size": getattr(args, "pool_size", None),
            "working_dir": getattr(args, "working_dir", None),
            "max_broken": getattr(args, "max_broken", None),
            "heartbeat": getattr(args, "heartbeat", None),
            "max_idle_time": getattr(args, "max_idle_time", None),
            "pipeline_depth": getattr(args, "pipeline_depth", None),
        }.items()
        if value is not None
    }
    storage_override = None
    if getattr(args, "debug", False):
        storage_override = {"type": "memory"}
    elif getattr(args, "storage_path", None):
        storage_override = {
            "type": _storage_type_for_path(args.storage_path),
            "path": args.storage_path,
        }
    # resolve_config raises for `doctor_interval:` (the diagnosis watchdog,
    # ROADMAP queue A item 9).
    config = resolve_config(file_config, cmd_config, storage_override)
    # `telemetry:` in any config layer flips the process-wide registry AND
    # the flight recorder (one switch for the whole observability layer); a
    # None (unset) leaves whatever ORION_TPU_TELEMETRY / ORION_TPU_FLIGHT
    # decided at import.
    if config.get("telemetry") is not None:
        from orion_tpu_torch.health import FLIGHT
        from orion_tpu_torch.telemetry import TELEMETRY

        if config["telemetry"]:
            TELEMETRY.enable()
            FLIGHT.enable()
        else:
            TELEMETRY.disable()
            FLIGHT.disable()
    # `metrics_port:` requests the worker-side /metrics + /healthz daemon
    # (orion_tpu_torch.metrics).  Resolved to the env spelling here (so
    # `hunt --n-workers` children inherit it too) and STARTED only where a
    # worker loop actually runs (workon) — read-only commands must not bind
    # the port just because the config names it.
    if config.get("metrics_port") is not None:
        os.environ.setdefault(
            "ORION_TPU_METRICS_PORT", str(int(config["metrics_port"]))
        )
    return config


def _default_user():
    import getpass

    try:
        return getpass.getuser()
    except Exception:  # pragma: no cover - no passwd entry
        return os.environ.get("USER", "unknown")


def build_from_args(args, need_user_args=True, allow_create=True, view=False):
    """CLI args -> (experiment, cmdline_parser), with storage wired up.

    ``allow_create=False`` (lookup commands: audit, insert) only loads
    existing experiments — a typo'd name must never persist a ghost.
    ``view=True`` additionally wraps the result in a read-only
    :class:`ExperimentView` (the audit path).
    """
    config = load_cli_config(args)
    if not config.get("name"):
        raise NoConfigurationError("an experiment name is required (-n/--name)")
    storage = setup_storage(config["storage"], force=True)

    parser = CommandLineParser(config_prefix=config.get("user_script_config", "config"))
    user_args = list(getattr(args, "user_args", []) or [])
    priors = parser.parse(user_args)
    existing = []
    if not allow_create or (need_user_args and not user_args):
        # Check BEFORE build_experiment would persist an empty experiment —
        # including the requested version, or a typo'd --exp-version would
        # pass the name check and still create a ghost.
        query = {"name": config["name"]}
        if config.get("version") is not None:
            query["version"] = config["version"]
        if config.get("user"):
            # -u/--user namespacing (reference `cli/base.py:94`): an
            # explicit user restricts the lookup to that user's experiments.
            query["metadata.user"] = config["user"]
        existing = storage.fetch_experiments(query)
        if not existing:
            if not allow_create:
                raise NoConfigurationError(
                    f"no experiment matching {query} found"
                )
            raise NoConfigurationError(
                "a user script command is required for a new experiment"
            )

    if not allow_create:
        # A lookup must never branch: its user_args are not a command line
        # (insert passes `x=1.2` assignments) and it must not mutate the
        # experiment tree — so pass NO config at all, only the identity.
        latest = max(existing, key=lambda d: d.get("version", 1))
        experiment = build_experiment(
            storage,
            config["name"],
            version=latest.get("version"),
            user=config.get("user"),
        )
        if view:
            from orion_tpu_torch.core.experiment import ExperimentView

            experiment = ExperimentView(experiment)
        return experiment, parser

    metadata = {
        "user_args": user_args,
        "parser_state": parser.state_dict(),
        # Experiments are namespaced per user (reference stores
        # metadata.user on every experiment, `resolve_config.py`).
        "user": config.get("user") or _default_user(),
    }
    script_path = None
    config_file_path = parser.config_file_path
    if user_args:
        script_path = os.path.abspath(user_args[0])
        metadata["user_script"] = script_path
    else:
        # Argless resume (`hunt -n name`): the code identity must still be
        # checked, or edits to the stored script silently contaminate the
        # old version.  Recover the script/config paths from the stored
        # experiment (fetched above when user_args is empty; resume targets
        # the latest version).
        stored_meta = {}
        if existing:
            latest = max(existing, key=lambda d: d.get("version", 1))
            stored_meta = latest.get("metadata") or {}
        script_path = stored_meta.get("user_script")
        stored_parser = stored_meta.get("parser_state") or {}
        config_file_path = config_file_path or stored_parser.get("config_file_path")
    if script_path:
        vcs = infer_versioning_metadata(script_path)
        if vcs is not None:
            metadata["vcs"] = vcs
    if config_file_path:
        config_hash = hash_config_file(config_file_path)
        if config_hash is not None:
            metadata["script_config_hash"] = config_hash
    experiment = build_experiment(
        storage,
        config["name"],
        version=config.get("version"),
        user=config.get("user"),
        priors=priors or None,
        metadata=metadata,
        max_trials=config.get("max_trials"),
        pool_size=config.get("pool_size"),
        working_dir=config.get("working_dir"),
        max_broken=config.get("max_broken"),
        algorithms=config.get("algorithms"),
        strategy=config.get("strategy"),
        branch_config={
            "manual_resolution": getattr(args, "manual_resolution", False),
            "branch_to": getattr(args, "branch_to", None),
        },
    )
    # Worker-level knobs, not part of the experiment's stored identity
    # (reference keeps them in the global worker config, `core/__init__.py:93`):
    # heartbeat governs this worker's lost-trial sweep threshold,
    # max_idle_time its producer stall budget (consumed by workon).
    experiment.heartbeat = float(config.get("heartbeat", experiment.heartbeat))
    experiment.max_idle_time = float(
        config.get("max_idle_time", experiment.max_idle_time)
    )
    # Speculative-pipeline depth rides the same worker-level channel (the
    # Producer resolves None through ORION_TPU_PIPELINE_DEPTH to 1).
    if config.get("pipeline_depth") is not None:
        experiment.pipeline_depth = int(config["pipeline_depth"])
    # Suggest-gateway selection is a worker-level knob too (the same
    # experiment may run served on one box and local on another):
    # instantiate() builds a RemoteAlgorithm when this is set.
    if config.get("serve") is not None:
        experiment.serve_config = config.get("serve")
    # Resuming: rebuild the parser from the stored experiment metadata so the
    # original template (and config file) is used even without user args.
    if not user_args:
        state = experiment.metadata.get("parser_state")
        if state and (state.get("template") or state.get("priors")):
            parser = CommandLineParser.from_state(state)
        elif experiment.metadata.get("user_args"):
            # Reference-Oríon experiments (db load migration) store the raw
            # command instead of parser state — same prior DSL, so reparse
            # it (reference metadata schema: experiment.py:120-155).
            parser = CommandLineParser()
            parser.parse(list(experiment.metadata["user_args"]))
        elif need_user_args:
            raise NoConfigurationError(
                f"experiment {experiment.name!r} has no stored command to resume; "
                "provide the user script on the command line"
            )
    return experiment, parser
