"""The Space container and its flat unit-cube codec, on the host.

Port of ``orion_tpu/space/space.py``: a name-sorted collection of
dimensions with one shape-static codec between structured params and a
flat ``(n, D)`` unit-cube array, which is what the algorithms operate on.
Only the host (numpy) codec is ported: the suggest path moves the (q, D)
rows to the host once and decodes there.  Prior sampling draws the
uniform cube with a ``torch.Generator`` (on its device) and decodes it on
the host the same way; torch is imported there, so that the codec alone
(the CLI's prior parsing, the lint) does not load it.
"""

import numpy as np

from orion_tpu_torch.space.dims import Categorical, Dimension, Fidelity, NotSet
from orion_tpu_torch.space.params import ParamBatch


class Space:
    """Ordered (name-sorted) collection of dimensions."""

    def __init__(self, dims=()):
        self._dims = {}
        for dim in dims:
            self.register(dim)

    # --- container protocol ----------------------------------------------
    def register(self, dim):
        if not isinstance(dim, Dimension):
            raise TypeError(f"Expected Dimension, got {type(dim)}")
        if dim.name in self._dims:
            raise ValueError(f"Duplicate dimension name {dim.name!r}")
        self._dims[dim.name] = dim
        self._dims = dict(sorted(self._dims.items()))

    def __iter__(self):
        return iter(self._dims.values())

    def __len__(self):
        return len(self._dims)

    def __getitem__(self, key):
        if isinstance(key, int):
            return list(self._dims.values())[key]
        return self._dims[key]

    def __contains__(self, key):
        if isinstance(key, str):
            return key in self._dims
        return self.contains_point(key)

    def keys(self):
        return list(self._dims.keys())

    def values(self):
        return list(self._dims.values())

    def items(self):
        return list(self._dims.items())

    # --- semantics --------------------------------------------------------
    @property
    def fidelity(self):
        """The fidelity dimension if any (at most one is supported)."""
        for dim in self:
            if isinstance(dim, Fidelity):
                return dim
        return None

    @property
    def opt_dims(self):
        """Dimensions that algorithms actually optimize (fidelity excluded)."""
        return [d for d in self if not isinstance(d, Fidelity)]

    @property
    def n_cols(self):
        """Total flat unit-cube columns."""
        return sum(d.n_cols for d in self)

    def interval(self):
        return [d.interval() for d in self.opt_dims]

    def contains_point(self, params):
        """Host membership test of a params dict (fidelity included if present)."""
        if set(params) != set(self._dims):
            return False
        return all(params[name] in dim for name, dim in self._dims.items())

    def cast(self, params):
        return {name: self._dims[name].cast(value) for name, value in params.items()}

    def defaults(self):
        return {
            d.name: d.default_value for d in self if d.default_value is not NotSet
        }

    def configuration(self):
        """Prior-string form — the identity used by EVC comparisons."""
        return {d.name: d.get_prior_string() for d in self}

    def __repr__(self):
        inner = ", ".join(d.get_string() for d in self)
        return f"Space([{inner}])"

    def __eq__(self, other):
        return isinstance(other, Space) and self.configuration() == other.configuration()

    def _col_slices(self):
        out, start = {}, 0
        for dim in self:
            out[dim.name] = (start, start + dim.n_cols)
            start += dim.n_cols
        return out

    # --- host codec -----------------------------------------------------------
    def decode_flat_np(self, u):
        u = np.asarray(u)
        slices = self._col_slices()
        out = {}
        for dim in self:
            if dim.n_cols == 0:
                continue
            a, b = slices[dim.name]
            vals = dim.decode_np(u[:, a:b])
            if dim.shape:
                vals = vals.reshape((u.shape[0],) + dim.shape)
            else:
                vals = vals[:, 0]
            out[dim.name] = vals
        return out

    def encode_flat_np(self, arrays):
        cols = []
        for dim in self:
            if dim.n_cols == 0:
                continue
            vals = np.asarray(arrays[dim.name])
            cols.append(
                dim.encode_np(vals.reshape(vals.shape[0], dim.size)).astype(
                    np.float32
                )
            )
        if not cols:
            return np.zeros((0, 0), dtype=np.float32)
        return np.concatenate(cols, axis=1)

    def sample_flat(self, generator, n):
        """Prior sampling = uniform cube (encode is each prior's CDF): an
        ``(n, n_cols)`` float32 tensor on ``generator``'s device."""
        import torch

        return torch.rand((n, self.n_cols), generator=generator, device=generator.device)

    # --- host <-> device boundary ------------------------------------------
    def arrays_to_params(self, arrays, fidelity_value=None):
        """Decoded arrays -> :class:`~orion_tpu_torch.space.params.ParamBatch`
        (a lazy columnar sequence of structured param dicts).

        Categorical indices become category objects; a fidelity value (or the
        dim's high) is attached when the space has a fidelity dimension.
        Columns are built eagerly in one vectorized pass per dimension
        (clamp/cast semantics must be fixed at decode time); the per-trial
        dicts materialize lazily at the plugin-compat boundary.
        """
        host = {k: np.asarray(v) for k, v in arrays.items()}
        n = next(iter(host.values())).shape[0] if host else 0
        names, columns = [], []
        for dim in self:
            names.append(dim.name)
            if isinstance(dim, Fidelity):
                fv = int(fidelity_value if fidelity_value is not None else dim.high)
                columns.append([fv] * n)
                continue
            col = host[dim.name]
            if isinstance(dim, Categorical):
                # Lookup-table pass (dims.from_index_column): no python
                # from_index/int() call per value.
                columns.append(dim.from_index_column(col))
            elif dim.shape:
                # cast_decoded is elementwise (round-to-precision + clamp):
                # one call over the whole (n, *shape) block, then split
                # into the per-trial rows the dict view hands out.
                columns.append(list(dim.cast_decoded(col)))
            else:
                columns.append(dim.cast_column(col))
        return ParamBatch(names, columns)

    def params_to_cube(self, params_list):
        """Param dicts (list or :class:`ParamBatch`) -> (n, D) float32
        unit-cube rows.

        The one dict->cube pipeline (``params_to_arrays`` +
        ``encode_flat_np``), so every observe-side caller produces
        bit-identical rows for the same params.
        """
        return self.encode_flat_np(self.params_to_arrays(params_list))

    def params_to_arrays(self, params_list):
        """Param dicts -> dict of host numpy arrays.

        Columnar fast path: a :class:`ParamBatch` input hands its columns
        over directly — zero per-trial work.  A plain list of dicts (the
        plugin-compat boundary) pays one gather pass per dimension, with
        categorical values resolved through the per-dim lookup table
        (``dims.to_index_column``) instead of a ``list.index`` per value."""
        columnar = isinstance(params_list, ParamBatch)
        out = {}
        for dim in self:
            if isinstance(dim, Fidelity):
                continue
            if columnar and params_list.has_column(dim.name):
                col = params_list.column(dim.name)
            else:
                # lint: disable=PERF001 -- plugin-compat boundary: a plain
                # dict list has no columns to pull; one gather per dim.
                col = [p[dim.name] for p in params_list]
            if isinstance(dim, Categorical):
                vals = np.asarray(dim.to_index_column(col))
            else:
                vals = np.asarray(col, dtype=float)
            out[dim.name] = vals
        return out

    def sample(self, generator_or_seed, n=1, fidelity_value=None):
        """End-to-end prior sampling returning structured params (a lazy
        :class:`~orion_tpu_torch.space.params.ParamBatch`).  An int seed
        draws on a CPU generator; a ``torch.Generator`` draws on its
        device.  The cube is decoded on the host."""
        import torch

        if isinstance(generator_or_seed, torch.Generator):
            generator = generator_or_seed
        else:
            generator = torch.Generator().manual_seed(int(generator_or_seed))
        u = self.sample_flat(generator, n).cpu().numpy()
        return self.arrays_to_params(self.decode_flat_np(u), fidelity_value=fidelity_value)
