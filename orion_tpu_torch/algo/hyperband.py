"""Hyperband (port of ``orion_tpu/algo/hyperband.py``): successive halving
over ALL bracket offsets -- ASHA with one bracket per rung offset."""

from orion_tpu_torch.algo.asha import ASHA, _geometric_budgets
from orion_tpu_torch.algo.base import algo_registry


@algo_registry.register("hyperband")
class Hyperband(ASHA):
    def __init__(self, space, seed=None, num_rungs=None, reduction_factor=None,
                 device=None):
        fid = space.fidelity
        if fid is None:
            raise RuntimeError("Hyperband requires a fidelity dimension")
        rf = int(reduction_factor or max(fid.base, 2))
        n_brackets = len(_geometric_budgets(fid.low, fid.high, rf, num_rungs))
        super().__init__(
            space,
            seed=seed,
            num_rungs=num_rungs,
            num_brackets=n_brackets,
            reduction_factor=reduction_factor,
            device=device,
        )
