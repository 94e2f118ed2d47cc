"""Trial adapters: bidirectional compatibility between parent/child
experiments (port of ``orion_tpu/evc/adapters.py``).

Capability parity: reference `src/orion/core/evc/adapters.py` — one adapter
per resolved conflict; ``forward(trials)`` converts parent-experiment trials
for use in the child, ``backward(trials)`` converts child trials for the
parent (reference `evc/experiment.py:190-226` applies forward on parents and
backward on children); serializable via ``to_dict``/``build_adapter``.
"""

import logging

from orion_tpu_torch.core.trial import Trial
from orion_tpu_torch.space.dsl import build_dimension
from orion_tpu_torch.utils.registry import Registry

log = logging.getLogger(__name__)

adapter_registry = Registry("adapter")

#: Change severities for code/cmdline/config conflicts.
CHANGE_TYPES = ("noeffect", "unsure", "break")


class Adapter:
    """Base adapter; stateless transforms over lists of Trials."""

    def forward(self, trials):
        """Parent trials -> child experiment's space."""
        raise NotImplementedError

    def backward(self, trials):
        """Child trials -> parent experiment's space."""
        raise NotImplementedError

    def to_dict(self):
        return {"of_type": type(self).__name__.lower(), **self._config()}

    def _config(self):
        return {}


def build_adapter(config):
    """Rebuild an adapter from its to_dict form (composites recurse)."""
    config = dict(config)
    of_type = config.pop("of_type")
    if of_type == "compositeadapter":
        return adapter_registry.get(of_type)(*config.get("adapters", []))
    return adapter_registry.get(of_type)(**config)


def _clone_with_params(trial, params):
    return Trial(
        experiment=trial.experiment,
        status=trial.status,
        params=params,
        results=[r.to_dict() for r in trial.results],
        submit_time=trial.submit_time,
        start_time=trial.start_time,
        end_time=trial.end_time,
        heartbeat=trial.heartbeat,
        working_dir=trial.working_dir,
        parents=trial.parents,
    )


@adapter_registry.register("dimensionaddition")
class DimensionAddition(Adapter):
    """Child gained dimension ``name``; parent trials get ``default_value``
    (reference `adapters.py:232`: a parent trial is valid in the child iff
    the new dimension is pinned at its default)."""

    def __init__(self, name, default_value=None):
        self.name = name
        self.default_value = default_value

    def forward(self, trials):
        out = []
        for trial in trials:
            params = dict(trial.params)
            params[self.name] = self.default_value
            out.append(_clone_with_params(trial, params))
        return out

    def backward(self, trials):
        out = []
        for trial in trials:
            if trial.params.get(self.name) == self.default_value:
                params = {k: v for k, v in trial.params.items() if k != self.name}
                out.append(_clone_with_params(trial, params))
        return out

    def _config(self):
        return {"name": self.name, "default_value": self.default_value}


@adapter_registry.register("dimensiondeletion")
class DimensionDeletion(Adapter):
    """Child lost dimension ``name`` — the inverse of DimensionAddition
    (reference `adapters.py:327`)."""

    def __init__(self, name, default_value=None):
        self._inverse = DimensionAddition(name, default_value)

    @property
    def name(self):
        return self._inverse.name

    @property
    def default_value(self):
        return self._inverse.default_value

    def forward(self, trials):
        return self._inverse.backward(trials)

    def backward(self, trials):
        return self._inverse.forward(trials)

    def _config(self):
        return {"name": self.name, "default_value": self.default_value}


@adapter_registry.register("dimensionpriorchange")
class DimensionPriorChange(Adapter):
    """Prior of ``name`` changed; only trials inside the *target* prior's
    support survive the hop (reference `adapters.py:398`)."""

    def __init__(self, name, old_prior, new_prior):
        self.name = name
        self.old_prior = old_prior
        self.new_prior = new_prior
        self._old_dim = build_dimension(name, old_prior)
        self._new_dim = build_dimension(name, new_prior)

    def _filter(self, trials, dim):
        return [t for t in trials if self.name in t.params and t.params[self.name] in dim]

    def forward(self, trials):
        return self._filter(trials, self._new_dim)

    def backward(self, trials):
        return self._filter(trials, self._old_dim)

    def _config(self):
        return {
            "name": self.name,
            "old_prior": self.old_prior,
            "new_prior": self.new_prior,
        }


@adapter_registry.register("dimensionrenaming")
class DimensionRenaming(Adapter):
    """``old_name`` in the parent is ``new_name`` in the child
    (reference `adapters.py:480`)."""

    def __init__(self, old_name, new_name):
        self.old_name = old_name
        self.new_name = new_name

    def _rename(self, trials, src, dst):
        out = []
        for trial in trials:
            params = dict(trial.params)
            if src in params:
                params[dst] = params.pop(src)
            out.append(_clone_with_params(trial, params))
        return out

    def forward(self, trials):
        return self._rename(trials, self.old_name, self.new_name)

    def backward(self, trials):
        return self._rename(trials, self.new_name, self.old_name)

    def _config(self):
        return {"old_name": self.old_name, "new_name": self.new_name}


@adapter_registry.register("algorithmchange")
class AlgorithmChange(Adapter):
    """Algorithm changed: trials remain valid — pass-through
    (reference `adapters.py:557`)."""

    def forward(self, trials):
        return list(trials)

    def backward(self, trials):
        return list(trials)


class _ChangeTypeAdapter(Adapter):
    """Shared behavior for code/cmdline/script-config changes: ``break``
    drops trials across the hop, ``noeffect``/``unsure`` pass through
    (reference `adapters.py:596,677,758`)."""

    def __init__(self, change_type):
        if change_type not in CHANGE_TYPES:
            raise ValueError(
                f"change_type must be one of {CHANGE_TYPES}, got {change_type!r}"
            )
        self.change_type = change_type

    def _apply(self, trials):
        if self.change_type == "break":
            return []
        if self.change_type == "unsure":
            log.debug("%s with change_type=unsure: passing trials through",
                      type(self).__name__)
        return list(trials)

    def forward(self, trials):
        return self._apply(trials)

    def backward(self, trials):
        return self._apply(trials)

    def _config(self):
        return {"change_type": self.change_type}


@adapter_registry.register("codechange")
class CodeChange(_ChangeTypeAdapter):
    pass


@adapter_registry.register("commandlinechange")
class CommandLineChange(_ChangeTypeAdapter):
    pass


@adapter_registry.register("scriptconfigchange")
class ScriptConfigChange(_ChangeTypeAdapter):
    pass


@adapter_registry.register("compositeadapter")
class CompositeAdapter(Adapter):
    """Sequential application (reference `adapters.py:116-193`)."""

    def __init__(self, *adapters):
        self.adapters = [
            a if isinstance(a, Adapter) else build_adapter(a) for a in adapters
        ]

    def forward(self, trials):
        for adapter in self.adapters:
            trials = adapter.forward(trials)
        return trials

    def backward(self, trials):
        for adapter in reversed(self.adapters):
            trials = adapter.backward(trials)
        return trials

    def to_dict(self):
        return {
            "of_type": "compositeadapter",
            "adapters": [a.to_dict() for a in self.adapters],
        }
