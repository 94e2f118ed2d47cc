"""Branch builder: drive conflict resolution and create the child experiment
(port of ``orion_tpu/evc/builder.py``).

Capability parity: reference `src/orion/core/io/experiment_branch_builder.py`
+ `evc_builder.py` — automatic resolution by default (markers honored),
interactive prompt with ``--manual-resolution``, child registered with
``refers = {root_id, parent_id, adapter}`` and a DuplicateKeyError ->
RaceCondition retry (a concurrent worker may branch first; reference
`experiment.py:516-517`).
"""

import logging
import time

from orion_tpu_torch.evc.conflicts import ExperimentNameConflict, detect_conflicts
from orion_tpu_torch.evc.adapters import CompositeAdapter
from orion_tpu_torch.space.dsl import split_marker
from orion_tpu_torch.utils.exceptions import DuplicateKeyError, RaceCondition

log = logging.getLogger(__name__)


class ExperimentBranchBuilder:
    """Resolution API used programmatically and by the interactive prompt
    (reference `experiment_branch_builder.py:62-80` + per-conflict methods)."""

    def __init__(self, conflicts, manual_resolution=False, branch_to=None):
        self.conflicts = conflicts
        self.manual_resolution = manual_resolution
        self.branch_to = branch_to

    # --- per-conflict-type resolution API -----------------------------------
    def change_experiment_name(self, name):
        for conflict in self.conflicts.get([ExperimentNameConflict]):
            conflict.try_resolve(branch_to=name)

    def add_dimension(self, name, default_value=None):
        from orion_tpu_torch.evc.conflicts import NewDimensionConflict
        from orion_tpu_torch.space.dims import NotSet

        for conflict in self.conflicts.get([NewDimensionConflict]):
            if conflict.name == name:
                conflict.try_resolve(
                    default_value=default_value if default_value is not None else NotSet
                )

    def remove_dimension(self, name, default_value=None):
        from orion_tpu_torch.evc.conflicts import MissingDimensionConflict
        from orion_tpu_torch.space.dims import NotSet

        for conflict in self.conflicts.get([MissingDimensionConflict]):
            if conflict.name == name:
                conflict.try_resolve(
                    default_value=default_value if default_value is not None else NotSet
                )

    def rename_dimension(self, old_name, new_name):
        from orion_tpu_torch.evc.conflicts import MissingDimensionConflict

        for conflict in self.conflicts.get([MissingDimensionConflict]):
            if conflict.name == old_name:
                conflict.try_resolve(rename_to=new_name)

    def set_code_change_type(self, change_type):
        from orion_tpu_torch.evc.conflicts import CodeConflict

        for conflict in self.conflicts.get([CodeConflict]):
            conflict.try_resolve(change_type=change_type)

    def set_cli_change_type(self, change_type):
        from orion_tpu_torch.evc.conflicts import CommandLineConflict

        for conflict in self.conflicts.get([CommandLineConflict]):
            conflict.try_resolve(change_type=change_type)

    def set_script_config_change_type(self, change_type):
        from orion_tpu_torch.evc.conflicts import ScriptConfigConflict

        for conflict in self.conflicts.get([ScriptConfigConflict]):
            conflict.try_resolve(change_type=change_type)

    def reset(self):
        for conflict in self.conflicts.conflicts:
            conflict.resolution = None

    # --- driving -------------------------------------------------------------
    def resolve(self):
        if self.branch_to:
            self.change_experiment_name(self.branch_to)
        if self.manual_resolution:
            # The user's decisions (including leaving conflicts unresolved
            # via `abort`) are final — no automatic pass afterwards.
            from orion_tpu_torch.evc.branching_prompt import BranchingPrompt

            BranchingPrompt(self).cmdloop()
        else:
            self.conflicts.try_resolve_all()
        return self.conflicts

    def create_adapters(self):
        return CompositeAdapter(*self.conflicts.get_adapters())


def branch_experiment(storage, parent, new_priors, branch_config=None, **config):
    """Create a child experiment from ``parent`` with the changed config."""
    from orion_tpu_torch.core.experiment import Experiment

    branch_config = dict(branch_config or {})
    old_config = parent.configuration()
    new_config = {
        "priors": dict(new_priors),
        "algorithms": config.get("algorithms"),
        "metadata": config.get("metadata", {}),
        "name": parent.name,
    }
    conflicts = detect_conflicts(old_config, new_config)
    if not conflicts.conflicts:
        return parent

    builder = ExperimentBranchBuilder(
        conflicts,
        manual_resolution=branch_config.get("manual_resolution", False),
        branch_to=branch_config.get("branch_to"),
    )
    builder.resolve()
    remaining = conflicts.get_remaining()
    if remaining:
        raise ValueError(
            "unresolved branching conflicts: "
            + "; ".join(c.diff() for c in remaining)
            + " — add branching markers (+ - >) or default_value=..., or use "
            "--manual-resolution"
        )

    name_res = next(
        (
            c.resolution
            for c in conflicts.get([ExperimentNameConflict])
            if c.is_resolved
        ),
        None,
    )
    child_name = name_res.info["name"] if name_res else parent.name
    child_version = name_res.info["version"] if name_res else parent.version + 1

    adapter = builder.create_adapters()
    old_priors = dict(old_config.get("priors", {}))
    clean_priors = {}
    renamed_targets = {}
    for name, expr in new_priors.items():
        marker, clean = split_marker(expr)
        if marker == ">":
            # `/old~>/new`: the renamed dimension keeps its old prior unless
            # the new name is also given its own prior expression.
            renamed_targets[clean.strip()] = old_priors.get(name)
            continue
        if marker == "-" and not clean.strip():
            continue
        clean_priors[name] = clean
    for target, old_expr in renamed_targets.items():
        if target not in clean_priors and old_expr is not None:
            clean_priors[target] = old_expr
    if not clean_priors:
        raise ValueError(
            "branching produced an empty search space — a rename-only config "
            "must still leave at least one dimension"
        )

    # A branch created without a fresh command line (argless resume that hit
    # a CodeConflict) must inherit the parent's command metadata or the child
    # could never be run.
    new_meta = dict(config.get("metadata") or {})
    if not new_meta.get("user_args"):
        parent_meta = parent.metadata or {}
        for key in ("user_args", "parser_state", "user_script"):
            if parent_meta.get(key) is not None:
                new_meta[key] = parent_meta[key]
    child_config = {
        "name": child_name,
        "version": child_version,
        "priors": clean_priors,
        "metadata": {"timestamp": time.time(), **new_meta},
        "max_trials": config.get("max_trials", parent.max_trials),
        "max_broken": config.get("max_broken", parent.max_broken),
        "pool_size": config.get("pool_size", parent.pool_size),
        "working_dir": config.get("working_dir", parent.working_dir),
        "algorithms": config.get("algorithms") or parent.algo_config,
        "strategy": config.get("strategy") or parent.strategy_config,
        "refers": {
            "root_id": parent.refers.get("root_id") or parent.id,
            "parent_id": parent.id,
            "adapter": adapter.to_dict(),
        },
    }
    from orion_tpu_torch.core.experiment import experiment_id

    child_user = child_config["metadata"].get("user")
    child_config["_id"] = experiment_id(child_name, child_version, child_user)
    for attempt in range(2):
        try:
            created = storage.create_experiment(child_config)
            log.info(
                "Branched experiment %s v%s -> %s v%s",
                parent.name, parent.version, child_name, child_version,
            )
            return Experiment(storage, created)
        except DuplicateKeyError:
            # Concurrent branch to the same (name, version): bump and retry.
            child_version += 1
            child_config["version"] = child_version
            child_config["_id"] = experiment_id(child_name, child_version, child_user)
    raise RaceCondition(
        f"lost branching race for experiment {child_name!r} twice"
    )
