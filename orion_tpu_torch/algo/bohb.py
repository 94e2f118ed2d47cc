"""BOHB, a per-budget TPE model under Hyperband scheduling (port of
``orion_tpu/algo/bohb.py``).

Observations are kept per budget tier; new bottom-rung points come from
TPE (:func:`orion_tpu_torch.algo.tpe.tpe_round`) fit on the HIGHEST tier
with at least ``min_points`` observations, with the good splits of every
tier above it prepended; until a tier qualifies, points are uniform.
"""

import numpy as np

from orion_tpu_torch.algo.base import algo_registry
from orion_tpu_torch.algo.hyperband import Hyperband
from orion_tpu_torch.algo.sampling import clamp_objectives
from orion_tpu_torch.algo.sharding import mesh_health_fields
from orion_tpu_torch.algo.tpe import good_bad_split, tpe_round
from orion_tpu_torch.parallel import device_mesh


@algo_registry.register("bohb")
class BOHB(Hyperband):
    """Hyperband scheduling + TPE sampling from the highest informative budget.

    Parameters beyond Hyperband's: ``gamma`` (good/bad split quantile),
    ``n_candidates`` (KDE-ratio candidate pool per round), ``min_points``
    (observations a tier needs before it is modelled; default ``dims + 2``)
    and ``bw_factor``.  ``use_mesh=True`` scores each TPE round's pool over
    ``n_devices`` slots, as ``tpe`` does.
    """

    # Unlike plain ASHA/Hyperband, observe() feeds cube rows to the tiers.
    uses_observe_cube = True

    def __init__(
        self,
        space,
        seed=None,
        num_rungs=None,
        reduction_factor=None,
        gamma=0.25,
        n_candidates=1024,
        min_points=None,
        bw_factor=1.0,
        n_devices=None,
        use_mesh=False,
        device=None,
    ):
        super().__init__(space, seed=seed, num_rungs=num_rungs,
                         reduction_factor=reduction_factor, device=device)
        d = space.n_cols
        self.gamma = float(gamma)
        self.n_candidates = int(n_candidates)
        self.min_points = int(min_points) if min_points is not None else d + 2
        self.bw_factor = float(bw_factor)
        self._params.update(
            gamma=self.gamma, n_candidates=self.n_candidates,
            min_points=self.min_points, bw_factor=self.bw_factor,
        )
        # Candidate-axis sharding of the KDE-ratio scores (as TPE's).
        self.use_mesh = use_mesh
        self._mesh = device_mesh(n_devices, device=self.device) if use_mesh else None
        # budget tier -> (x (n, d) unit-cube rows, y (n,)) observation arrays.
        self._tier_x = {}
        self._tier_y = {}

    # The per-tier arrays are append-only (rebound); their dicts are
    # shallow-copied so a clone's inserts don't leak back.  The mesh is a
    # cached singleton.
    _share_by_ref = ("_mesh",)
    _share_dicts = ("_tier_x", "_tier_y")

    # --- observation --------------------------------------------------------
    def observe(self, params_list, results, cube=None):
        super().observe(params_list, results)  # rung/promotion bookkeeping
        by_tier = {}
        for i, (params, result) in enumerate(zip(params_list, results)):
            objective = result.get("objective")
            if objective is None:
                continue
            tier = int(params.get(self.fidelity_name, 1))
            by_tier.setdefault(tier, ([], [], []))
            by_tier[tier][0].append(params)
            by_tier[tier][1].append(float(objective))
            by_tier[tier][2].append(i)
        for tier, (valid, yvals, idx) in by_tier.items():
            prev_y = self._tier_y.get(tier, np.zeros((0,), dtype=np.float32))
            y = clamp_objectives(np.asarray(yvals, dtype=np.float64), prev_y)
            if y is None:
                continue
            if cube is not None:
                rows = np.asarray(cube, dtype=np.float32)[idx]
            else:
                rows = self.space.params_to_cube(valid)
            prev_x = self._tier_x.get(tier, np.zeros((0, self.space.n_cols), dtype=np.float32))
            self._tier_x[tier] = np.concatenate([prev_x, np.asarray(rows, dtype=np.float32)])
            self._tier_y[tier] = np.concatenate([prev_y, y.astype(np.float32)])

    # --- model-based sampling -----------------------------------------------
    def _model_tier(self):
        """Highest budget whose observation count can support the KDE pair."""
        for tier in sorted(self._tier_y, reverse=True):
            if self._tier_y[tier].shape[0] >= self.min_points:
                return tier
        return None

    def _new_cube(self, num):
        tier = self._model_tier()
        if tier is None:
            return super()._new_cube(num)
        good, bad = good_bad_split(self._tier_x[tier], self._tier_y[tier], self.gamma)
        good = self._boost_top_rungs(tier, good)
        return tpe_round(self._generator, good, bad, self.n_candidates, int(num),
                         self.bw_factor, self.device, mesh=self._mesh)

    def _boost_top_rungs(self, tier, good):
        """Prepend the good splits of every budget ABOVE the model tier,
        highest budget first, so the rank-weighted good set puts the
        promoted survivors (too few to model alone) at its top.  A config
        promoted through several budgets appears once per tier."""
        boost = []
        for upper in sorted((t for t in self._tier_y if t > tier), reverse=True):
            ys = self._tier_y[upper]
            n_good = max(1, int(np.ceil(self.gamma * ys.shape[0])))
            order = np.argsort(ys, kind="stable")[:n_good]
            boost.append(self._tier_x[upper][order])
        if not boost:
            return good
        return np.concatenate(boost + [good])

    # --- health -------------------------------------------------------------
    def health_record(self):
        """Hyperband's rung occupancy plus the KDE side: per-tier
        observation counts, the tier modelled (None while random), and the
        incumbent over every tier."""
        record = super().health_record()
        tier = self._model_tier()
        record["model_tier"] = int(tier) if tier is not None else None
        record["tier_counts"] = {
            str(t): int(self._tier_y[t].shape[0]) for t in sorted(self._tier_y)
        }
        best = None
        for ys in self._tier_y.values():
            if ys.shape[0]:
                tier_best = float(np.min(ys))
                best = tier_best if best is None else min(best, tier_best)
        if best is not None:
            record["best_y"] = best
        if self._mesh is not None:
            record.update(mesh_health_fields(self._mesh))
        return record

    # --- state --------------------------------------------------------------
    def state_dict(self):
        out = super().state_dict()
        out["tiers"] = {
            str(t): {"x": self._tier_x[t].tolist(), "y": self._tier_y[t].tolist()}
            for t in self._tier_y
        }
        return out

    def set_state(self, state):
        super().set_state(state)
        d = self.space.n_cols
        self._tier_x, self._tier_y = {}, {}
        for key, obs in state.get("tiers", {}).items():
            tier = int(key)
            self._tier_x[tier] = np.asarray(obs["x"], dtype=np.float32).reshape(-1, d)
            self._tier_y[tier] = np.asarray(obs["y"], dtype=np.float32)
