"""EVC — experiment version control (port of ``orion_tpu/evc``).

Capability parity: reference `src/orion/core/evc/` + branching builders: when
an experiment is re-run with a changed configuration, detect every conflict
between the old and new configs, resolve each into a bidirectional trial
adapter, and branch a child experiment (version bump or rename) linked
through ``refers = {root_id, parent_id, adapter}``.  Trials then flow through
the whole experiment tree, adapted in each hop.
"""

from orion_tpu_torch.evc.adapters import Adapter, CompositeAdapter, build_adapter
from orion_tpu_torch.evc.conflicts import detect_conflicts
from orion_tpu_torch.evc.builder import branch_experiment

__all__ = [
    "Adapter",
    "CompositeAdapter",
    "build_adapter",
    "branch_experiment",
    "detect_conflicts",
]
