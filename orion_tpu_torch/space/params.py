"""ParamBatch: a lazy columnar view of a suggestion round's param dicts.

The steady-state round never needs per-trial ``{name: value}`` dicts: the
producer registers trials from columns (``core.trial.TrialBatch`` builds the
storage documents in one pass) and the observe side re-encodes through
``Space.params_to_cube``, which pulls columns straight out of this view.
Per-trial dicts exist only for the *plugin-compat boundary* — third-party
algorithms with ``observe(params_list, ...)`` overrides, ``register_suggestion``
hooks, user scripts indexing ``suggest()`` results — and materialize lazily,
one row at a time, exactly when that boundary touches them.

Equivalence contract: ``list(batch)`` is bit-identical to the eager
``[dict(zip(names, row)) for row in zip(*columns)]`` build the pre-columnar
``Space.arrays_to_params`` performed (same column values, same key order),
pinned by tests/unit/test_space_codec_diff.py.
"""

from collections.abc import Sequence


class ParamBatch(Sequence):
    """``n`` param dicts stored as per-dimension columns.

    ``names`` is the dict key order (the Space's name-sorted dimension
    order); ``columns`` one python list per name, all of length ``n``.
    Row dicts are built on demand and cached, so repeated boundary access
    (a plugin observing the same batch twice) pays the build once.
    """

    __slots__ = ("names", "columns", "_n", "_rows")

    def __init__(self, names, columns):
        self.names = tuple(names)
        self.columns = list(columns)
        self._n = len(self.columns[0]) if self.columns else 0
        self._rows = {}

    # --- columnar surface ---------------------------------------------------
    def column(self, name):
        """The raw column for dimension ``name`` (the codec fast path —
        ``Space.params_to_arrays`` pulls these instead of probing n dicts)."""
        return self.columns[self.names.index(name)]

    def has_column(self, name):
        return name in self.names

    # --- sequence-of-dicts surface (plugin-compat boundary) -----------------
    def __len__(self):
        return self._n

    def __getitem__(self, index):
        if isinstance(index, slice):
            return ParamBatch(
                self.names, [col[index] for col in self.columns]
            )
        if index < 0:
            index += self._n
        if not 0 <= index < self._n:
            raise IndexError(index)
        row = self._rows.get(index)
        if row is None:
            row = dict(zip(self.names, (col[index] for col in self.columns)))
            self._rows[index] = row
        return row

    def __iter__(self):
        for i in range(self._n):
            yield self[i]

    def materialize(self):
        """Eager list of per-trial dicts — the explicit plugin-compat exit.
        Wire layers (the serve gateway's JSON replies) and pre-columnar
        plugins call this; everything framework-internal stays columnar."""
        return list(self)

    def __add__(self, other):
        """List concat compat (plugin code does ``[seed_point] + batch``):
        concatenation is a materializing boundary by definition."""
        if isinstance(other, (list, tuple, ParamBatch)):
            return self.materialize() + list(other)
        return NotImplemented

    def __radd__(self, other):
        if isinstance(other, (list, tuple)):
            return list(other) + self.materialize()
        return NotImplemented

    def __eq__(self, other):
        if isinstance(other, ParamBatch):
            return self.names == other.names and self.columns == other.columns
        if isinstance(other, (list, tuple)):
            return len(other) == self._n and all(
                self[i] == other[i] for i in range(self._n)
            )
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __repr__(self):
        return f"ParamBatch(n={self._n}, names={list(self.names)})"
