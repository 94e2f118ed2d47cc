"""Search-space dimensions and their unit-cube column codecs, on the host.

Port of ``orion_tpu/space/dims.py``.  Every dimension lowers to a pair of
maps between its value domain and unit-cube columns:

    decode_np: [0,1]^m -> value domain      (prior inverse-CDF)
    encode_np: value domain -> [0,1]^m      (prior CDF)

The reference also has device (jnp) twins of these maps; the port's
suggest/observe boundary uses only the host codecs (one bulk transfer of
the (q, D) rows, then numpy), so only they are ported.  ``scipy.special``'s
``ndtr``/``ndtri`` stand in for ``jax.scipy.special``'s.
"""

import math
from dataclasses import dataclass, field

import numpy as np
from scipy.special import ndtr, ndtri

_EPS = 1e-7


class _NotSet:
    def __repr__(self):
        return "<NotSet>"


NotSet = _NotSet()


def _size(shape):
    out = 1
    for s in shape:
        out *= int(s)
    return out


@dataclass(frozen=True)
class Dimension:
    """Base spec for one named dimension.

    ``prior_expr`` is the canonical DSL string (e.g. ``uniform(-3, 5)``); it is
    the identity used by experiment version control to compare spaces.
    """

    name: str
    prior_expr: str
    shape: tuple = ()
    default_value: object = field(default=NotSet)

    @property
    def size(self):
        return _size(self.shape)

    @property
    def n_cols(self):
        """Number of unit-cube columns this dimension occupies."""
        return self.size

    @property
    def type(self):
        return type(self).__name__.lower()

    def get_prior_string(self):
        return self.prior_expr

    def get_string(self):
        return f"{self.name}~{self.prior_expr}"

    def decode_np(self, u):
        """Map ``u`` in [0,1]^(n, size) to values."""
        raise NotImplementedError

    def encode_np(self, x):
        """Inverse of :meth:`decode_np` (values -> unit cube)."""
        raise NotImplementedError

    def interval(self):
        raise NotImplementedError

    def cast(self, value):
        raise NotImplementedError

    def cast_decoded(self, value):
        """Cast for values coming out of the codec (subclasses may clamp
        f32 rounding back into bounds; user-input `cast` never clamps)."""
        return self.cast(value)

    def __contains__(self, value):
        raise NotImplementedError

    def _shaped(self, value):
        """Validate/broadcast a scalar-or-array value to this dim's shape."""
        arr = np.asarray(value)
        if arr.shape != self.shape:
            raise ValueError(
                f"Dimension {self.name}: value shape {arr.shape} != {self.shape}"
            )
        return arr

    def sample_host(self, rng, n=1):
        """``n`` prior draws on the host from the numpy Generator ``rng``:
        uniform cells decoded through :meth:`decode_np`."""
        u = rng.uniform(size=(n, self.size))
        return np.asarray(self.decode_np(u)).reshape((n,) + self.shape)

    def __repr__(self):
        return (f"{type(self).__name__}(name={self.name}, "
                f"prior={self.prior_expr}, shape={self.shape})")


@dataclass(frozen=True, repr=False)
class Real(Dimension):
    """Continuous dimension with a named prior.

    Supported priors (``dist``): ``uniform(low, high)``, ``loguniform(low,
    high)``, ``normal(loc, scale)`` and ``normal`` truncated to [low, high]
    when explicit bounds are given.
    """

    dist: str = "uniform"
    low: float = 0.0
    high: float = 1.0
    loc: float = 0.0
    scale: float = 1.0
    precision: int = 0  # significant digits to round to on cast; 0 = off

    def interval(self):
        return (self.low, self.high)

    def decode_np(self, u):
        u = np.clip(np.asarray(u, dtype=np.float64), _EPS, 1.0 - _EPS)
        if self.dist == "uniform":
            return self.low + u * (self.high - self.low)
        if self.dist == "loguniform":
            lo, hi = math.log(self.low), math.log(self.high)
            return np.exp(lo + u * (hi - lo))
        if self.dist == "normal":
            if math.isfinite(self.low) or math.isfinite(self.high):
                # Truncated normal via CDF renormalization — no rejection loop.
                a = ndtr((self.low - self.loc) / self.scale)
                b = ndtr((self.high - self.loc) / self.scale)
                u = np.clip(a + u * (b - a), _EPS, 1.0 - _EPS)
            return self.loc + self.scale * ndtri(u)
        raise NotImplementedError(f"prior {self.dist!r}")

    def encode_np(self, x):
        x = np.asarray(x, dtype=np.float64)
        if self.dist == "uniform":
            u = (x - self.low) / (self.high - self.low)
        elif self.dist == "loguniform":
            lo, hi = math.log(self.low), math.log(self.high)
            u = (np.log(x) - lo) / (hi - lo)
        elif self.dist == "normal":
            u = ndtr((x - self.loc) / self.scale)
            if math.isfinite(self.low) or math.isfinite(self.high):
                a = ndtr((self.low - self.loc) / self.scale)
                b = ndtr((self.high - self.loc) / self.scale)
                u = (u - a) / (b - a)
        else:
            raise NotImplementedError(f"prior {self.dist!r}")
        return np.clip(u, 0.0, 1.0)

    def cast(self, value):
        arr = self._cast_arr(value)
        return arr.reshape(self.shape) if self.shape else float(arr)

    def _cast_arr(self, value):
        arr = np.asarray(value, dtype=float)
        if self.precision:
            with np.errstate(divide="ignore"):
                mag = np.where(arr != 0, np.floor(np.log10(np.abs(arr))), 0.0)
            factor = 10.0 ** (self.precision - 1 - mag)
            arr = np.round(arr * factor) / factor
        return arr

    def cast_decoded(self, value):
        """Cast for DECODED values only: additionally clamps to the bounds
        (a decode at u -> 1 can land an epsilon past a bound that float32
        cannot represent).  The user-input `cast` must NOT clamp."""
        return np.clip(self._cast_arr(value), self.low, self.high)

    def cast_column(self, col):
        """Vectorized decoded-cast of a length-n column -> python list."""
        return self.cast_decoded(col).tolist()

    def __contains__(self, value):
        try:
            arr = self._shaped(np.asarray(value, dtype=float))
        except (TypeError, ValueError):
            return False
        lo, hi = self.interval()
        return bool(np.all(arr >= lo) and np.all(arr <= hi))


@dataclass(frozen=True, repr=False)
class Integer(Real):
    """Integer dimension = floor discretization of the underlying prior:
    ``uniform(low, high, discrete=True)`` covers the inclusive integer
    range [low, high]."""

    def cast(self, value):
        arr = np.floor(np.asarray(value, dtype=float)).astype(int)
        return arr.reshape(self.shape) if self.shape else int(arr)

    def cast_column(self, col):
        return np.floor(np.asarray(col, dtype=float)).astype(int).tolist()

    def decode_np(self, u):
        u = np.clip(np.asarray(u, dtype=np.float64), _EPS, 1.0 - _EPS)
        if self.dist == "uniform":
            span = self.high - self.low + 1
            x = np.floor(self.low + u * span)
        elif self.dist == "loguniform":
            lo, hi = math.log(self.low), math.log(self.high + 1)
            x = np.floor(np.exp(lo + u * (hi - lo)))
        else:
            x = np.floor(super().decode_np(u))
        return np.clip(x, self.low, self.high).astype(np.int32)

    def encode_np(self, x):
        x = np.asarray(x, dtype=np.float64)
        if self.dist == "uniform":
            span = self.high - self.low + 1
            u = (x - self.low + 0.5) / span
        elif self.dist == "loguniform":
            lo, hi = math.log(self.low), math.log(self.high + 1)
            u = (np.log(x + 0.5) - lo) / (hi - lo)
        else:
            u = super().encode_np(x + 0.5)
        return np.clip(u, 0.0, 1.0)

    def __contains__(self, value):
        try:
            arr = np.asarray(self._shaped(value), dtype=float)
        except (TypeError, ValueError):
            return False
        if not np.all(np.equal(np.mod(arr, 1), 0)):
            return False
        return bool(np.all(arr >= self.low) and np.all(arr <= self.high))


@dataclass(frozen=True, repr=False)
class Categorical(Dimension):
    """Categorical dimension over arbitrary python objects.

    The cube holds the integer index; the vocabulary lives on the host.
    The codec maps a unit-cube column through the categorical CDF, so
    prior probabilities are honored by uniform sampling.
    """

    categories: tuple = ()
    probs: tuple = ()

    def __post_init__(self):
        if not self.probs:
            k = len(self.categories)
            object.__setattr__(self, "probs", tuple([1.0 / k] * k))

    @property
    def n_choices(self):
        return len(self.categories)

    def interval(self):
        return tuple(self.categories)

    def decode_np(self, u):
        u = np.clip(np.asarray(u, dtype=np.float64), _EPS, 1.0 - _EPS)
        cum = np.cumsum(np.asarray(self.probs, dtype=np.float64))
        idx = np.searchsorted(cum, u)
        return np.clip(idx, 0, self.n_choices - 1).astype(np.int32)

    def encode_np(self, idx):
        cum = np.concatenate([[0.0], np.cumsum(np.asarray(self.probs))])
        mid = (cum[:-1] + cum[1:]) / 2.0
        return mid[np.asarray(idx, dtype=np.int32)]

    def to_index(self, value):
        """Host: category object -> index."""
        arr = np.asarray(value)
        if arr.shape == self.shape and self.shape:
            return np.vectorize(lambda v: self.categories.index(v))(arr)
        return self.categories.index(value if not isinstance(value, np.generic) else value.item())

    def from_index(self, idx):
        """Host: index -> category object."""
        arr = np.asarray(idx)
        if self.shape:
            flat = [self.categories[int(i)] for i in arr.reshape(-1)]
            return np.asarray(flat, dtype=object).reshape(self.shape)
        return self.categories[int(arr)]

    # One lookup-table pass per column instead of a python to_index /
    # from_index call per value; first occurrence wins, as in list.index.
    def _index_lut(self):
        lut = self.__dict__.get("_index_lut_cache")
        if lut is None:
            lut = {}
            for i, cat in enumerate(self.categories):
                lut.setdefault(cat, i)
            object.__setattr__(self, "_index_lut_cache", lut)
        return lut

    def _category_array(self):
        arr = self.__dict__.get("_category_array_cache")
        if arr is None:
            # np.asarray(categories) would coerce tuple/list categories
            # into extra array dimensions; fill an object array instead.
            arr = np.empty(len(self.categories), dtype=object)
            arr[:] = list(self.categories)
            object.__setattr__(self, "_category_array_cache", arr)
        return arr

    def to_index_column(self, values):
        """Vectorized ``[to_index(v) for v in values]`` for scalar dims."""
        lut = self._index_lut()
        out = []
        for value in values:
            try:
                out.append(lut[value])
            except (KeyError, TypeError):
                # Unhashable or unknown: list.index semantics, and its error.
                out.append(self.to_index(value))
        return out

    def from_index_column(self, col):
        """Vectorized ``[from_index(i)...]`` over an index column."""
        table = self._category_array()
        if self.shape:
            n = np.asarray(col).shape[0]
            block = table[np.asarray(col, dtype=np.intp).reshape(n, -1)]
            return [row.reshape(self.shape) for row in block]
        return table[np.asarray(col, dtype=np.intp)].tolist()

    def sample_host(self, rng, n=1):
        u = rng.uniform(size=(n, self.size))
        idx = self.decode_np(u)
        if self.shape:
            return np.asarray(
                [self.from_index(row.reshape(self.shape)) for row in idx], dtype=object
            )
        return np.asarray([self.from_index(i) for i in idx[:, 0]], dtype=object)

    def cast(self, value):
        # Accept either a category literal or its string form.
        if value in self.categories:
            return value
        by_str = {str(c): c for c in self.categories}
        if str(value) in by_str:
            return by_str[str(value)]
        raise ValueError(f"{value!r} is not a category of {self.name}")

    def __contains__(self, value):
        if self.shape:
            arr = np.asarray(value, dtype=object)
            if arr.shape != self.shape:
                return False
            return all(v in self.categories for v in arr.reshape(-1))
        try:
            self.cast(value)
            return True
        except (ValueError, TypeError):
            return False


@dataclass(frozen=True, repr=False)
class Fidelity(Dimension):
    """Budget dimension — never optimized, assigned by multi-fidelity algos.
    Contributes **zero** unit-cube columns; the fidelity value rides
    host-side in the trial params."""

    low: int = 1
    high: int = 1
    base: int = 2

    @property
    def n_cols(self):
        return 0

    def interval(self):
        return (self.low, self.high)

    def budgets(self):
        """Geometric rung budgets low * base^k capped at high."""
        if self.base < 2:
            return [int(self.low), int(self.high)] if self.low < self.high else [int(self.high)]
        out = []
        b = self.low
        while b < self.high:
            out.append(int(b))
            b *= self.base
        out.append(int(self.high))
        return out

    def decode_np(self, u):  # pragma: no cover - zero columns
        return u

    def encode_np(self, x):  # pragma: no cover - zero columns
        return x

    def cast(self, value):
        return int(value)

    def __contains__(self, value):
        try:
            v = float(value)
        except (TypeError, ValueError):
            return False
        return self.low <= v <= self.high
