"""ASHA, asynchronous successive halving (port of ``orion_tpu/algo/asha.py``).

Brackets of rungs with geometric budgets: ``suggest`` first promotes the top
1/reduction_factor of a filled rung to the next rung, else samples new points
at a bracket's bottom-rung fidelity (the bracket chosen by a softmax over
negative bottom-rung occupancy); points dedup by a hash of their
non-fidelity params; ``observe`` records objectives into rungs; done when
every bracket's top rung holds an evaluated point.

Rung bookkeeping is sequential pointer-chasing and stays on the host.
Sampling new points is one uniform draw on the algorithm's device.  Two
draws per round, in this order: the bracket uniforms, then the new rows
(``_sample_new``); :meth:`ASHA._assign_new_points` takes the bracket
uniforms as an array, so the parity tests can inject the reference's.
"""

import hashlib
import logging

import numpy as np
import torch

from orion_tpu_torch.algo.base import BaseAlgorithm, algo_registry

log = logging.getLogger(__name__)


def _geometric_budgets(low, high, factor, num_rungs=None):
    budgets = []
    b = low
    while b < high:
        budgets.append(int(b))
        b *= factor
    budgets.append(int(high))
    if num_rungs is not None and len(budgets) > num_rungs:
        # Keep the extremes, thin the middle evenly.
        idx = np.linspace(0, len(budgets) - 1, num_rungs).round().astype(int)
        budgets = [budgets[i] for i in sorted(set(idx.tolist()))]
    return budgets


class Bracket:
    """One successive-halving ladder."""

    def __init__(self, budgets, reduction_factor):
        self.rungs = [{"resources": b, "results": {}} for b in budgets]
        self.reduction_factor = reduction_factor

    def register(self, point_hash, params, objective, fidelity):
        for rung in self.rungs:
            if rung["resources"] == fidelity:
                rung["results"][point_hash] = (objective, params)
                return True
        return False

    def get_candidate(self, rung_index):
        """Top-1/rf point of rung not yet present in the next rung."""
        rung = self.rungs[rung_index]["results"]
        next_rung = self.rungs[rung_index + 1]["results"]
        scored = [(h, o, p) for h, (o, p) in rung.items() if o is not None]
        scored.sort(key=lambda t: t[1])
        k = len(rung) // self.reduction_factor
        for h, _objective, params in scored[:k]:
            if h not in next_rung:
                return h, params
        return None, None

    def promote(self):
        """Find a promotable point; returns (hash, params, next_fidelity)."""
        for i in range(len(self.rungs) - 1):
            point_hash, params = self.get_candidate(i)
            if point_hash is not None:
                # Reserve the slot so concurrent suggests don't double-promote.
                self.rungs[i + 1]["results"][point_hash] = (None, params)
                return point_hash, params, self.rungs[i + 1]["resources"]
        return None, None, None

    def holds(self, point_hash):
        return any(point_hash in rung["results"] for rung in self.rungs)

    @property
    def is_filled(self):
        return len(self.rungs[0]["results"]) >= self.reduction_factor ** (
            len(self.rungs) - 1
        )

    @property
    def is_done(self):
        # Pending slots (objective None) do NOT finish a bracket: the
        # top-fidelity trial must be evaluated.
        return any(entry[0] is not None for entry in self.rungs[-1]["results"].values())

    def state(self):
        return [
            {"resources": r["resources"], "results": dict(r["results"])}
            for r in self.rungs
        ]

    def __deepcopy__(self, memo):
        """Rung entries are immutable-by-rebinding (whole ``(objective,
        params)`` tuples are assigned, never mutated), so a clone needs
        fresh results dicts only."""
        cls = type(self)
        clone = cls.__new__(cls)
        memo[id(self)] = clone
        clone.reduction_factor = self.reduction_factor
        clone.rungs = self.state()
        return clone


@algo_registry.register("asha")
class ASHA(BaseAlgorithm):
    requires_fidelity = True

    # Rung bookkeeping is dict-keyed: observe() ignores the columnar rows.
    # The model-based subclasses (asha_bo, bohb) flip this back on.
    uses_observe_cube = False

    # str -> int with immutable values; a copy only needs its own dict.
    _share_dicts = ("_bracket_of",)

    def __init__(
        self,
        space,
        seed=None,
        num_rungs=None,
        num_brackets=1,
        reduction_factor=None,
        device=None,
    ):
        super().__init__(
            space,
            seed=seed,
            device=device,
            num_rungs=num_rungs,
            num_brackets=num_brackets,
            reduction_factor=reduction_factor,
        )
        fid = space.fidelity
        if fid is None:
            raise RuntimeError(
                "ASHA requires a fidelity dimension (e.g. epochs~fidelity(1, 81, 3))"
            )
        self.fidelity_name = fid.name
        rf = int(reduction_factor or max(fid.base, 2))
        if rf < 2:
            raise ValueError(f"reduction_factor must be >= 2, got {rf}")
        self.reduction_factor = rf
        budgets = _geometric_budgets(fid.low, fid.high, rf, num_rungs)
        # Bracket s skips the s lowest rungs (ASHA paper).
        num_brackets = min(num_brackets, len(budgets))
        self.brackets = [Bracket(budgets[s:], rf) for s in range(num_brackets)]
        # point_hash -> bracket index: a fidelity alone cannot identify the
        # bracket with num_brackets > 1, so assignment is tracked at suggest.
        self._bracket_of = {}

    # --- health --------------------------------------------------------------
    def rung_occupancy(self):
        """Per-bracket rung fill: ``[[[resources, occupied, evaluated], ...],
        ...]`` (``occupied`` counts pending slots too)."""
        return [
            [
                [
                    rung["resources"],
                    len(rung["results"]),
                    sum(1 for entry in rung["results"].values() if entry[0] is not None),
                ]
                for rung in bracket.rungs
            ]
            for bracket in self.brackets
        ]

    def health_record(self):
        """Rung occupancy and the best evaluated objective across rungs."""
        best = None
        for bracket in self.brackets:
            for rung in bracket.rungs:
                for objective, _params in rung["results"].values():
                    if objective is not None and (best is None or objective < best):
                        best = objective
        record = {
            "algo": type(self).__name__.lower(),
            "n_obs": int(self._n_observed),
            "rung_occupancy": self.rung_occupancy(),
        }
        if best is not None:
            record["best_y"] = float(best)
        return record

    # --- identity ------------------------------------------------------------
    def _point_hash(self, params):
        """md5 over the ``repr`` of the non-fidelity items, sorted by key
        only (values are never compared)."""
        items = sorted(
            ((k, v) for k, v in params.items() if k != self.fidelity_name),
            key=lambda kv: kv[0],
        )
        return hashlib.md5(repr(items).encode()).hexdigest()

    # --- suggest/observe -------------------------------------------------------
    def suggest(self, num=1):
        """Promotions first, then new points in one device draw."""
        out = []
        while len(out) < num:
            promoted = self._promote_one()
            if promoted is None:
                break
            out.append(promoted)
        remaining = num - len(out)
        if remaining:
            out.extend(self._sample_new(remaining))
        return out or None

    def _resolve_bracket(self, point_hash, fidelity):
        """Bracket for a point: tracked assignment, else the bracket already
        holding it, else -- for an unknown point -- the bracket whose BOTTOM
        rung is this fidelity, else the first with any rung at it."""
        if point_hash in self._bracket_of:
            return self.brackets[self._bracket_of[point_hash]]
        for i, bracket in enumerate(self.brackets):
            if bracket.holds(point_hash):
                self._bracket_of[point_hash] = i
                return bracket
        for i, bracket in enumerate(self.brackets):
            if bracket.rungs[0]["resources"] == fidelity:
                self._bracket_of[point_hash] = i
                return bracket
        for i, bracket in enumerate(self.brackets):
            if any(r["resources"] == fidelity for r in bracket.rungs):
                self._bracket_of[point_hash] = i
                return bracket
        return None

    def _promote_one(self):
        for bracket_idx, bracket in enumerate(self.brackets):
            point_hash, params, fidelity = bracket.promote()
            if params is not None:
                self._bracket_of[point_hash] = bracket_idx
                promoted = dict(params)
                promoted[self.fidelity_name] = fidelity
                return promoted
        return None

    def _new_cube(self, num):
        """Unit-cube rows for fresh bottom-rung points: one uniform draw on
        the device (``asha_bo`` and ``bohb`` override it with a model)."""
        return torch.rand((num, self.space.n_cols), generator=self._generator,
                          device=self.device)

    def _sample_new(self, num):
        # The bracket uniforms are drawn BEFORE the new rows, as the
        # reference draws its bracket key before its sampling key.
        bracket_u = torch.rand((num,), generator=self._generator, device=self.device)
        u = self._new_cube(num)
        return self._assign_new_points(u, bracket_u)

    def _assign_new_points(self, u, bracket_u):
        """Decode fresh bottom-rung rows into full params: per point, a
        bracket by the softmax over negative bottom-rung occupancy (inverse
        CDF of ``bracket_u``), its bottom fidelity stamped on, and the slot
        pre-registered (objective pending) so the point is never
        re-suggested."""
        u = np.asarray(u.cpu() if torch.is_tensor(u) else u, dtype=np.float32)
        bracket_u = np.asarray(bracket_u.cpu() if torch.is_tensor(bracket_u) else bracket_u)
        sizes = np.asarray([len(b.rungs[0]["results"]) for b in self.brackets],
                           dtype=np.float64)
        logits = -sizes  # fewer points -> more likely
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        bracket_ids = np.minimum(
            np.searchsorted(np.cumsum(probs), bracket_u), len(self.brackets) - 1
        )
        arrays = self.space.decode_flat_np(u)
        out = []
        for i, params in enumerate(self.space.arrays_to_params(arrays)):
            bracket_idx = int(bracket_ids[i])
            bracket = self.brackets[bracket_idx]
            fidelity = bracket.rungs[0]["resources"]
            params[self.fidelity_name] = fidelity
            point_hash = self._point_hash(params)
            self._bracket_of[point_hash] = bracket_idx
            bracket.register(point_hash, params, None, fidelity)
            out.append(params)
        return out

    def register_suggestion(self, params):
        """Mark a registered point as pending in its rung so a later round
        (from a fresh copy) cannot re-promote it."""
        fidelity = int(params.get(self.fidelity_name, 0))
        point_hash = self._point_hash(params)
        bracket = self._resolve_bracket(point_hash, fidelity)
        if bracket is None:
            return
        for rung in bracket.rungs:
            if rung["resources"] == fidelity and point_hash not in rung["results"]:
                rung["results"][point_hash] = (None, dict(params))
                return

    def observe(self, params_list, results, cube=None):
        # ``cube`` is accepted for the base contract; rungs are dict-keyed.
        for params, result in zip(params_list, results):
            objective = result["objective"]
            fidelity = int(params.get(self.fidelity_name, 0))
            point_hash = self._point_hash(params)
            bracket = self._resolve_bracket(point_hash, fidelity)
            if bracket is None or not bracket.register(
                point_hash, dict(params), objective, fidelity
            ):
                log.debug("Observed point with unknown fidelity %s; no rung matched",
                          fidelity)
            self._n_observed += 1

    @property
    def is_done(self):
        return all(b.is_done for b in self.brackets)

    # --- state -------------------------------------------------------------
    def state_dict(self):
        out = super().state_dict()
        out["brackets"] = [b.state() for b in self.brackets]
        out["bracket_of"] = dict(self._bracket_of)
        return out

    def set_state(self, state):
        super().set_state(state)
        for bracket, saved in zip(self.brackets, state["brackets"]):
            bracket.rungs = [
                {"resources": r["resources"], "results": dict(r["results"])}
                for r in saved
            ]
        self._bracket_of = dict(state.get("bracket_of", {}))
