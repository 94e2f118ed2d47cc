"""Conflict detection and resolution between experiment configurations
(port of ``orion_tpu/evc/conflicts.py``).

Capability parity: reference `src/orion/core/evc/conflicts.py` (1638 LoC) —
when re-running an experiment whose configuration changed, every difference
becomes a typed Conflict; each conflict resolves (automatically, via cmdline
markers ``+ - >``, or interactively) into a Resolution that may carry a trial
Adapter.  Conflict classes: NewDimension (`conflicts.py:513`),
ChangedDimension (`:650`), MissingDimension (remove or rename, `:727`),
Algorithm (`:1025`), Code (`:1083`), CommandLine (`:1202`), ScriptConfig
(`:1334`), ExperimentName (version bump or rename, `:1463`).
"""

import logging

from orion_tpu_torch.evc.adapters import (
    AlgorithmChange,
    CodeChange,
    CommandLineChange,
    DimensionAddition,
    DimensionDeletion,
    DimensionPriorChange,
    DimensionRenaming,
    ScriptConfigChange,
)
from orion_tpu_torch.space.dims import NotSet
from orion_tpu_torch.space.dsl import build_dimension, split_marker

log = logging.getLogger(__name__)


class Resolution:
    def __init__(self, conflict, adapter=None, **info):
        self.conflict = conflict
        self.adapter = adapter
        self.info = info

    def __repr__(self):
        return f"Resolution({type(self.conflict).__name__}, {self.info})"


class Conflict:
    """One difference between the parent and the branching configuration."""

    def __init__(self):
        self.resolution = None

    @property
    def is_resolved(self):
        return self.resolution is not None

    def try_resolve(self, **kwargs):
        raise NotImplementedError

    def diff(self):
        raise NotImplementedError

    def _resolve(self, adapter=None, **info):
        self.resolution = Resolution(self, adapter=adapter, **info)
        return self.resolution


class NewDimensionConflict(Conflict):
    """A dimension exists in the new config but not the parent."""

    def __init__(self, name, prior_expr):
        super().__init__()
        self.name = name
        marker, clean = split_marker(prior_expr)
        self.marked_add = marker == "+"
        self.prior_expr = clean
        self.dimension = build_dimension(name, clean)

    def try_resolve(self, default_value=NotSet, **_kwargs):
        if default_value is NotSet:
            default_value = self.dimension.default_value
        if default_value is NotSet:
            # No default -> parent trials cannot be mapped into the child
            # (None params would corrupt model warm-starts); refuse so the
            # user supplies `default_value=` in the prior expression.
            raise ValueError(
                f"new dimension {self.name!r} needs a default_value to branch"
            )
        return self._resolve(
            adapter=DimensionAddition(self.name, default_value),
            default_value=default_value,
        )

    def diff(self):
        return f"+ {self.name}~{self.prior_expr}"


class ChangedDimensionConflict(Conflict):
    """Same dimension name, different prior expression."""

    def __init__(self, name, old_expr, new_expr):
        super().__init__()
        self.name = name
        self.old_expr = old_expr
        _, self.new_expr = split_marker(new_expr)

    def try_resolve(self, **_kwargs):
        return self._resolve(
            adapter=DimensionPriorChange(self.name, self.old_expr, self.new_expr)
        )

    def diff(self):
        return f"~ {self.name}: {self.old_expr} -> {self.new_expr}"


class MissingDimensionConflict(Conflict):
    """A parent dimension is absent from the new config: removed or renamed."""

    def __init__(self, name, old_expr, rename_to=None, marked_remove=False):
        super().__init__()
        self.name = name
        self.old_expr = old_expr
        self.rename_to = rename_to
        self.marked_remove = marked_remove

    def try_resolve(self, rename_to=None, default_value=NotSet, **_kwargs):
        rename_to = rename_to or self.rename_to
        if rename_to:
            return self._resolve(
                adapter=DimensionRenaming(self.name, rename_to), rename_to=rename_to
            )
        if default_value is NotSet:
            dim = build_dimension(self.name, self.old_expr)
            default_value = (
                dim.default_value if dim.default_value is not NotSet else None
            )
        return self._resolve(
            adapter=DimensionDeletion(self.name, default_value),
            default_value=default_value,
        )

    def diff(self):
        if self.rename_to:
            return f"> {self.name} -> {self.rename_to}"
        return f"- {self.name}~{self.old_expr}"


class AlgorithmConflict(Conflict):
    def __init__(self, old_config, new_config):
        super().__init__()
        self.old_config = old_config
        self.new_config = new_config

    def try_resolve(self, **_kwargs):
        return self._resolve(adapter=AlgorithmChange())

    def diff(self):
        return f"algorithm: {self.old_config} -> {self.new_config}"


class _ChangeConflict(Conflict):
    adapter_cls = None
    what = ""

    def __init__(self, old, new):
        super().__init__()
        self.old = old
        self.new = new

    def try_resolve(self, change_type="unsure", **_kwargs):
        return self._resolve(
            adapter=self.adapter_cls(change_type), change_type=change_type
        )

    def diff(self):
        return f"{self.what}: {self.old!r} -> {self.new!r}"


class CodeConflict(_ChangeConflict):
    adapter_cls = CodeChange
    what = "code"


class CommandLineConflict(_ChangeConflict):
    adapter_cls = CommandLineChange
    what = "commandline"


class ScriptConfigConflict(_ChangeConflict):
    adapter_cls = ScriptConfigChange
    what = "script config"


class ExperimentNameConflict(Conflict):
    """Branching always needs a new identity: version bump or new name."""

    def __init__(self, name, version):
        super().__init__()
        self.name = name
        self.version = version

    def try_resolve(self, branch_to=None, **_kwargs):
        if branch_to and branch_to != self.name:
            return self._resolve(name=branch_to, version=1)
        return self._resolve(name=self.name, version=self.version + 1)

    def diff(self):
        return f"experiment: {self.name} v{self.version} -> branch"


class Conflicts:
    """Container with resolution bookkeeping (reference `conflicts.py:104-274`)."""

    def __init__(self, conflicts=()):
        self.conflicts = list(conflicts)

    def add(self, conflict):
        self.conflicts.append(conflict)

    def get(self, conflict_types=None):
        if conflict_types is None:
            return list(self.conflicts)
        return [c for c in self.conflicts if isinstance(c, tuple(conflict_types))]

    def get_remaining(self):
        return [c for c in self.conflicts if not c.is_resolved]

    def get_resolved(self):
        return [c for c in self.conflicts if c.is_resolved]

    @property
    def are_resolved(self):
        return not self.get_remaining()

    def try_resolve_all(self, **kwargs):
        for conflict in self.get_remaining():
            try:
                conflict.try_resolve(**kwargs)
            except Exception as exc:  # pragma: no cover - defensive
                log.warning("Could not auto-resolve %r: %s", conflict, exc)

    def get_adapters(self):
        out = []
        for conflict in self.get_resolved():
            if conflict.resolution.adapter is not None:
                out.append(conflict.resolution.adapter)
        return out

    def diffs(self):
        return [c.diff() for c in self.conflicts]


def detect_conflicts(old_config, new_config):
    """Compare parent/new experiment configs (reference `conflicts.py:94-101`).

    ``old_config`` is the stored configuration (clean priors); ``new_config``
    may carry branching markers in its prior expressions.
    """
    conflicts = Conflicts()
    old_priors = dict(old_config.get("priors", {}))
    raw_new = dict(new_config.get("priors", {}))

    renames = {}  # old_name -> new_name, from `old~>new` markers
    removed_marks = set()
    new_priors = {}
    for name, expr in raw_new.items():
        marker, clean = split_marker(expr)
        if marker == ">":
            renames[name] = clean.strip()
            continue
        if clean.strip() == "" and marker == "-":
            removed_marks.add(name)
            continue
        new_priors[name] = expr

    for name, expr in new_priors.items():
        _, clean = split_marker(expr)
        if name not in old_priors:
            if name not in renames.values():
                conflicts.add(NewDimensionConflict(name, expr))
        elif _normalized(old_priors[name]) != _normalized(clean):
            conflicts.add(ChangedDimensionConflict(name, old_priors[name], expr))

    for name, old_expr in old_priors.items():
        if name in new_priors:
            continue
        if name in renames:
            target = renames[name]
            conflict = MissingDimensionConflict(name, old_expr, rename_to=target)
            conflicts.add(conflict)
            # The renamed target may also change its prior.
            if target in new_priors:
                _, target_expr = split_marker(new_priors[target])
                if _normalized(old_expr) != _normalized(target_expr):
                    conflicts.add(
                        ChangedDimensionConflict(target, old_expr, target_expr)
                    )
        else:
            conflicts.add(
                MissingDimensionConflict(
                    name, old_expr, marked_remove=name in removed_marks
                )
            )

    old_algo = old_config.get("algorithms")
    new_algo = new_config.get("algorithms")
    if new_algo is not None and old_algo is not None and old_algo != new_algo:
        conflicts.add(AlgorithmConflict(old_algo, new_algo))

    old_meta = old_config.get("metadata", {})
    new_meta = new_config.get("metadata", {})
    old_vcs = old_meta.get("vcs") or {}
    new_vcs = new_meta.get("vcs") or {}
    # Code identity = (HEAD sha, uncommitted-diff sha): two dirty checkouts at
    # the same HEAD with different edits are different code (reference
    # `resolve_config.py:270-282`, `conflicts.py:1083`).
    old_sig = (old_vcs.get("HEAD_sha"), old_vcs.get("diff_sha"))
    new_sig = (new_vcs.get("HEAD_sha"), new_vcs.get("diff_sha"))
    if any(old_sig) and any(new_sig) and old_sig != new_sig:
        conflicts.add(CodeConflict(old_sig, new_sig))

    old_cli = _non_prior_args(old_meta.get("user_args", []))
    new_cli = _non_prior_args(new_meta.get("user_args", []))
    if new_meta.get("user_args") and old_cli != new_cli:
        conflicts.add(CommandLineConflict(old_cli, new_cli))

    old_conf = old_meta.get("script_config_hash")
    new_conf = new_meta.get("script_config_hash")
    if old_conf and new_conf and old_conf != new_conf:
        conflicts.add(ScriptConfigConflict(old_conf, new_conf))

    if conflicts.conflicts:
        conflicts.add(
            ExperimentNameConflict(
                old_config["name"], old_config.get("version", 1)
            )
        )
    return conflicts


def _normalized(expr):
    return "".join(str(expr).split())


def _non_prior_args(user_args):
    return [a for a in user_args if "~" not in a]
