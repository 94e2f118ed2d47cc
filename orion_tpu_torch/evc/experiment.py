"""Experiment tree: fetch trials across the whole version-control lineage
(port of ``orion_tpu/evc/experiment.py``).

Capability parity: reference `src/orion/core/evc/experiment.py` —
`ExperimentNode` with lazy parent/children discovery through
``refers.parent_id`` links in storage, and tree-wide trial fetching that
applies ``adapter.forward`` to parent trials and ``adapter.backward`` to
children trials on each hop (`evc/experiment.py:154-226`).
"""

import logging

from orion_tpu_torch.evc.adapters import build_adapter
from orion_tpu_torch.evc.tree import TreeNode

log = logging.getLogger(__name__)


class ExperimentNode(TreeNode):
    """Tree node lazily materialized from storage experiment documents."""

    def __init__(self, storage, config, parent=None, children=()):
        super().__init__(config, parent=parent, children=children)
        self.storage = storage
        self._parent_loaded = parent is not None
        self._children_loaded = False

    @property
    def config(self):
        return self.item

    @property
    def exp_id(self):
        return self.config["_id"]

    @property
    def name(self):
        return self.config["name"]

    @property
    def version(self):
        return self.config.get("version", 1)

    @property
    def adapter(self):
        spec = (self.config.get("refers") or {}).get("adapter")
        return build_adapter(spec) if spec else None

    @property
    def parent(self):
        if not self._parent_loaded:
            self._parent_loaded = True
            parent_id = (self.config.get("refers") or {}).get("parent_id")
            if parent_id:
                docs = self.storage.fetch_experiments({"_id": parent_id})
                if docs:
                    node = ExperimentNode(self.storage, docs[0])
                    self.set_parent(node)
        return self._parent

    @property
    def children(self):
        if not self._children_loaded:
            self._children_loaded = True
            docs = self.storage.fetch_experiments(
                {"refers.parent_id": self.exp_id}
            )
            for doc in docs:
                if doc["_id"] not in [c.exp_id for c in self._children]:
                    self.add_children(
                        ExperimentNode(self.storage, doc, parent=self)
                    )
        return list(self._children)

    @property
    def root(self):
        node = self
        while node.parent is not None:
            node = node.parent
        return node

    def tree_name(self):
        return f"{self.name}-v{self.version}"


def build_node(storage, experiment):
    docs = storage.fetch_experiments({"_id": experiment.id})
    if not docs:
        raise ValueError(f"experiment {experiment.id} not in storage")
    return ExperimentNode(storage, docs[0])


class TreeTrialsFetcher:
    """Incremental tree-wide trial fetch for the producer's hot loop.

    The reference re-walks the whole tree and re-adapts every ancestor /
    descendant trial list on every producer round (`evc/experiment.py:154-226`
    — quadratic-ish as rounds accumulate).  This fetcher:

    - resolves the tree topology and per-node adapter hop-chains ONCE
      (family membership is fixed for a producer's lifetime, matching the
      producer's one-shot `_has_evc_family` probe);
    - per round reads only a (status, end_time) signature projection per
      family node, re-fetching and re-adapting ONLY trials that are new or
      whose signature changed (adapters act element-wise, so per-trial
      adaptation composes into the same result as whole-list adaptation);
    - keeps the experiment's OWN trials un-cached — that collection is the
      hot one and always fetched fresh.

    Storage reads per round: 1 (own) + 1 signature read per family node,
    + 1 bulk read per node only when something actually changed.
    """

    def __init__(self, experiment):
        self.experiment = experiment
        self.storage = experiment.storage
        node = build_node(self.storage, experiment)
        self.node_id = node.exp_id
        self.root_id = (node.config.get("refers") or {}).get("root_id") or node.exp_id
        self.family = self._family_chains(node)
        self._family_ids = self._probe_family_ids()
        # exp_id -> {"sig": {trial_id: sig}, "adapted": {trial_id: [trials]}}
        self._cache = {}

    def _probe_family_ids(self):
        """Cheap membership snapshot: ids of every experiment in this tree."""
        docs = self.storage.fetch_experiments(
            {"refers.root_id": self.root_id}, projection={"_id": 1}
        )
        ids = {d["_id"] for d in docs}
        ids.add(self.root_id)
        return ids

    @staticmethod
    def _family_chains(node):
        """[(exp_id, adapter_hop_chain, direction)] for every other node."""
        chains = []
        child = node
        chain = []  # adapters from the immediate hop outward
        while child.parent is not None:
            chain.append(child.adapter)
            parent = child.parent
            chains.append((parent.exp_id, list(chain), "forward"))
            child = parent

        def walk(n, adapters):
            for ch in n.children:
                hop = adapters + [ch.adapter]
                chains.append((ch.exp_id, list(hop), "backward"))
                walk(ch, hop)

        walk(node, [])
        return chains

    def fetch(self):
        # Branches can appear mid-run (another user branching this tree):
        # one cheap projected read of the tiny experiments collection per
        # round detects membership changes and rebuilds the hop chains.
        current_ids = self._probe_family_ids()
        if current_ids != self._family_ids:
            self._family_ids = current_ids
            node = build_node(self.storage, self.experiment)
            self.family = self._family_chains(node)
            self._cache = {
                k: v for k, v in self._cache.items()
                if k in {exp_id for exp_id, _, _ in self.family}
            }
        trials = list(self.storage.fetch_trials(uid=self.node_id))
        for exp_id, chain, direction in self.family:
            trials.extend(self._fetch_node(exp_id, chain, direction))
        seen, out = set(), []
        for trial in trials:
            if trial.id not in seen:
                seen.add(trial.id)
                out.append(trial)
        return out

    def _fetch_node(self, exp_id, chain, direction):
        cache = self._cache.setdefault(exp_id, {"sig": {}, "adapted": {}})
        sig_docs = self.storage.read_trial_docs(
            exp_id,
            projection={"status": 1, "end_time": 1, "submit_time": 1},
        )
        sigs = {
            d["_id"]: (d.get("status"), d.get("end_time")) for d in sig_docs
        }
        changed = [
            tid for tid, sig in sigs.items() if cache["sig"].get(tid) != sig
        ]
        if changed:
            docs = self.storage.read_trial_docs(exp_id, ids=changed)
            from orion_tpu_torch.core.trial import Trial

            for doc in docs:
                trial = Trial.from_dict(doc)
                adapted = [trial]
                for adapter in reversed(chain):
                    if adapter is not None:
                        if direction == "forward":
                            adapted = adapter.forward(adapted)
                        else:
                            adapted = adapter.backward(adapted)
                cache["adapted"][trial.id] = adapted
                cache["sig"][trial.id] = sigs[trial.id]
        for tid in list(cache["sig"]):
            if tid not in sigs:  # removed from storage
                cache["sig"].pop(tid)
                cache["adapted"].pop(tid, None)
        # Stable order: by (submit_time, id), matching fetch_trials sorting.
        submit_times = {d["_id"]: d.get("submit_time") or 0.0 for d in sig_docs}
        order = sorted(sigs, key=lambda tid: (submit_times[tid], str(tid)))
        out = []
        for tid in order:
            out.extend(cache["adapted"].get(tid, []))
        return out


def fetch_tree_trials(experiment):
    """One-shot tree-wide fetch (CLI status/info paths); the producer holds a
    persistent :class:`TreeTrialsFetcher` instead."""
    return TreeTrialsFetcher(experiment).fetch()
