"""Random search (port of ``orion_tpu/algo/random_search.py``): a
suggestion batch of any size is one uniform draw on the algorithm's device;
the prior shaping happens in the Space codec's decode (inverse CDF)."""

import torch

from orion_tpu_torch.algo.base import BaseAlgorithm, algo_registry


@algo_registry.register("random")
class RandomSearch(BaseAlgorithm):
    """Uniform prior sampling; seeded, resumable."""

    supports_async_suggest = True
    speculation_safe = True  # suggestions ignore observations entirely

    def __init__(self, space, seed=None, device=None):
        super().__init__(space, seed=seed, device=device)

    def _suggest_cube(self, num):
        return torch.rand((num, self.space.n_cols), generator=self._generator,
                          device=self.device)
