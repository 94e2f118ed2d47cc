"""Grid search (port of ``orion_tpu/algo/grid_search.py``): a deterministic
sweep over a cartesian lattice of the unit cube, so every dimension type
(real/int/categorical) gets an even sweep through the codec's inverse-CDF
decode.  Host numpy only: the grid never touches the device."""

import itertools

import numpy as np

from orion_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from orion_tpu_torch.space.dims import Categorical, Integer


@algo_registry.register("grid_search")
class GridSearch(BaseAlgorithm):
    """``n_values`` points per dimension (categoricals: one per category)."""

    # The sweep order never depends on observations.
    supports_async_suggest = True
    speculation_safe = True

    MAX_GRID = 1_000_000

    def __init__(self, space, n_values=10, seed=None, device=None):
        super().__init__(space, seed=seed, device=device, n_values=n_values)
        axes = []
        for dim in space:
            if dim.n_cols == 0:
                continue
            for _ in range(dim.n_cols):
                if isinstance(dim, Categorical):
                    k = dim.n_choices
                elif isinstance(dim, Integer):
                    k = min(n_values, int(dim.high - dim.low + 1))
                else:
                    k = n_values
                axes.append((np.arange(k) + 0.5) / k)
        size = int(np.prod([len(a) for a in axes])) if axes else 0
        if size > self.MAX_GRID:
            raise ValueError(
                f"grid of {size} points exceeds MAX_GRID={self.MAX_GRID}; "
                "reduce n_values or the number of dimensions"
            )
        self._grid = np.asarray(list(itertools.product(*axes)), dtype=np.float32)
        self._cursor = 0

    def _suggest_cube(self, num):
        if self._cursor >= len(self._grid):
            return None
        batch = self._grid[self._cursor : self._cursor + num]
        self._cursor += len(batch)
        return batch

    def register_suggestion(self, params):
        """Advance the cursor past a registered grid point, so a caller that
        suggests from a discarded copy does not re-suggest the same rows."""
        cube = self.space.encode_flat_np(self.space.params_to_arrays([params]))[0]
        idx = int(np.argmin(np.sum((self._grid - cube) ** 2, axis=1)))
        self._cursor = max(self._cursor, idx + 1)

    @property
    def is_done(self):
        return self._cursor >= len(self._grid) and self.n_observed >= len(self._grid)

    def state_dict(self):
        out = super().state_dict()
        out["cursor"] = self._cursor
        return out

    def set_state(self, state):
        super().set_state(state)
        self._cursor = state["cursor"]
