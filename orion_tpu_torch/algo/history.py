"""Observation history buffers (port of ``orion_tpu/algo/history.py``):
device-resident pow-2 buffers with in-place appends (:class:`DeviceHistory`)
and their amortized-growth host twin (:class:`HostHistory`).

Only the new rows of an observe batch cross to the device; the GP fit set
is sliced (``fit_view``) or gathered (``local_view``) from the resident
buffers.

Invariants, as in the reference:

- Buffer capacity is a power of 2 (floor 64, the GP pad floor) and only
  grows; every row at index >= ``count`` is exactly 0.0 in x and y with
  mask 0.0 — identical to the zero-padding a host re-pad produces.
- :meth:`DeviceHistory.fit_view` returns views sliced to
  ``_next_pow2(count)``, the exact shape a host re-pad produces.

Copy-on-write: ``__deepcopy__`` hands the clone the same buffers and marks
both sides; the next append on either side first copies the buffers, so
the other side's rows survive.  An algorithm that is never cloned appends
in place (``copy_`` into a slice) on every observe.

Telemetry: each device append counts ``history.appends.donated`` when it
wrote into the resident buffers and ``history.appends.copied`` when it
rebuilt them first (growth or copy-on-write) — the reference's names for
an append that aliased its donated buffers or paid an O(capacity) copy.
"""

import numpy as np
import torch

from orion_tpu_torch.device import resolve_device
from orion_tpu_torch.telemetry import TELEMETRY


def _next_pow2(n, floor=64):
    out = floor
    while out < n:
        out *= 2
    return out


def _local_subset(x, y, mask, center, m, m_pad, dist_cols):
    """Gather the ``m`` nearest real rows to ``center`` (squared euclidean
    over the leading ``dist_cols`` columns), padded to ``m_pad``.  Ties
    break by lowest index, as the reference's ``lax.top_k`` does: a stable
    ascending sort of the distances, sliced."""
    d2 = torch.sum((x[:, :dist_cols] - center[None, :dist_cols]) ** 2, dim=1)
    d2 = torch.where(mask > 0, d2, torch.full_like(d2, float("inf")))
    idx = torch.sort(d2, stable=True).indices[:m]
    xs = torch.zeros((m_pad, x.shape[1]), dtype=x.dtype, device=x.device)
    ys = torch.zeros((m_pad,), dtype=y.dtype, device=y.device)
    ms = torch.zeros((m_pad,), dtype=x.dtype, device=x.device)
    xs[:m] = x[idx]
    ys[:m] = y[idx]
    ms[:m] = 1.0
    return xs, ys, ms


class DeviceHistory:
    """Pow-2-padded device buffers ``(x, y, mask)`` for one observation set
    on ``device`` (``None`` means ``cuda`` and raises where no card is
    present).

    ``append`` is the only mutator; ``count`` is the number of real rows;
    everything past it is zero.
    """

    def __init__(self, n_cols, floor=64, device=None):
        self.n_cols = int(n_cols)
        self.floor = int(floor)
        self.device = resolve_device(device)
        self.count = 0
        self.cap = 0
        self._x = None
        self._y = None
        self._mask = None
        # True while the buffers may be visible to another DeviceHistory
        # (a clone): the next append must copy them first.
        self._cow = False

    @classmethod
    def from_host(cls, x, y, floor=64, device=None):
        """Bulk-build from host arrays (state restore / resume)."""
        x = np.asarray(x, dtype=np.float32)
        hist = cls(x.shape[1] if x.ndim == 2 else 0, floor=floor, device=device)
        if x.shape[0]:
            hist.append(x, np.asarray(y, dtype=np.float32))
        return hist

    def __deepcopy__(self, memo):
        clone = DeviceHistory.__new__(DeviceHistory)
        clone.__dict__.update(self.__dict__)
        clone._cow = True
        self._cow = True
        memo[id(self)] = clone
        return clone

    def _own_with_capacity(self, need):
        """Exclusively-owned buffers covering ``need`` rows (grow and/or
        copy-on-write in one copy).  Returns whether the buffers were
        rebuilt."""
        new_cap = max(_next_pow2(need, floor=self.floor), self.cap)
        if new_cap == self.cap and not self._cow:
            return False
        x = torch.zeros((new_cap, self.n_cols), dtype=torch.float32, device=self.device)
        y = torch.zeros((new_cap,), dtype=torch.float32, device=self.device)
        mask = torch.zeros((new_cap,), dtype=torch.float32, device=self.device)
        if self._x is not None:
            x[: self.cap].copy_(self._x)
            y[: self.cap].copy_(self._y)
            mask[: self.cap].copy_(self._mask)
        self._x, self._y, self._mask = x, y, mask
        self.cap = new_cap
        self._cow = False
        return True

    def append(self, rows, ys):
        """Write an observe batch at ``count``: one upload of the new rows,
        written in place into the resident buffers."""
        rows = np.asarray(rows, dtype=np.float32).reshape(-1, self.n_cols)
        ys = np.asarray(ys, dtype=np.float32).reshape(-1)
        b = rows.shape[0]
        if b == 0:
            return
        copied = self._own_with_capacity(self.count + b)
        # Constant names, one enabled check — hot-path clean.
        TELEMETRY.count(
            "history.appends.copied" if copied else "history.appends.donated"
        )
        end = self.count + b
        self._x[self.count:end].copy_(torch.from_numpy(rows))
        self._y[self.count:end].copy_(torch.from_numpy(ys))
        self._mask[self.count:end] = 1.0
        self.count = end

    def fit_view(self):
        """``(x, y, mask, m)`` sliced to ``m = _next_pow2(count)``."""
        m = _next_pow2(max(self.count, 1), floor=self.floor)
        return self._x[:m], self._y[:m], self._mask[:m], m

    def local_view(self, center, m, dist_cols=None):
        """``(x, y, mask, m_pad)`` of the ``m`` rows nearest to ``center``
        (over the leading ``dist_cols`` columns; default all), gathered on
        the device and padded to ``m_pad = _next_pow2(m)``.  Only
        ``center`` (one row) crosses to the device.  Requires
        ``count >= m``."""
        m = int(m)
        m_pad = _next_pow2(m, floor=self.floor)
        x, y, mask, _ = self.fit_view()
        center = torch.as_tensor(center, dtype=torch.float32, device=self.device)
        xs, ys, ms = _local_subset(
            x, y, mask, center, m=m, m_pad=m_pad,
            dist_cols=int(dist_cols) if dist_cols is not None else self.n_cols,
        )
        return xs, ys, ms, m_pad


class HostHistory:
    """Amortized-growth host mirrors ``(x, y)`` with O(batch) appends.

    ``x``/``y`` are views sliced to ``count``.  The incumbent is tracked
    incrementally: ``best_idx``/``best_y`` are the FIRST-occurrence
    argmin/min over the history (what ``np.argmin`` returns).  Copy-on-write
    after ``__deepcopy__``, as :class:`DeviceHistory`."""

    def __init__(self, n_cols, floor=64):
        self.n_cols = int(n_cols)
        self.floor = max(int(floor), 1)
        self.count = 0
        self._x = np.zeros((self.floor, self.n_cols), dtype=np.float32)
        self._y = np.zeros((self.floor,), dtype=np.float32)
        self._cow = False
        self.best_idx = -1
        self.best_y = np.inf

    @classmethod
    def from_host(cls, x, y, floor=64):
        """Bulk-build from materialized arrays (state restore / resume)."""
        x = np.asarray(x, dtype=np.float32)
        hist = cls(x.shape[1] if x.ndim == 2 else 0, floor=floor)
        if x.shape[0]:
            hist.append(x, np.asarray(y, dtype=np.float32))
        return hist

    @property
    def x(self):
        """(count, n_cols) view — rows [:count] are never mutated in place."""
        return self._x[: self.count]

    @property
    def y(self):
        return self._y[: self.count]

    def __deepcopy__(self, memo):
        clone = HostHistory.__new__(HostHistory)
        clone.__dict__.update(self.__dict__)
        clone._cow = True
        self._cow = True
        memo[id(self)] = clone
        return clone

    def _own_with_capacity(self, need):
        cap = self._x.shape[0]
        new_cap = _next_pow2(need, floor=cap)  # cap is always a pow-2
        if new_cap == cap and not self._cow:
            return
        x = np.zeros((new_cap, self.n_cols), dtype=np.float32)
        y = np.zeros((new_cap,), dtype=np.float32)
        x[: self.count] = self._x[: self.count]
        y[: self.count] = self._y[: self.count]
        self._x, self._y = x, y
        self._cow = False

    def append(self, rows, ys):
        rows = np.asarray(rows, dtype=np.float32).reshape(-1, self.n_cols)
        ys = np.asarray(ys, dtype=np.float32).reshape(-1)
        b = rows.shape[0]
        if b == 0:
            return
        self._own_with_capacity(self.count + b)
        self._x[self.count : self.count + b] = rows
        self._y[self.count : self.count + b] = ys
        batch_arg = int(np.argmin(ys))
        # Strict <: ties keep the earliest index, as np.argmin does.
        if float(ys[batch_arg]) < self.best_y:
            self.best_y = float(ys[batch_arg])
            self.best_idx = self.count + batch_arg
        self.count += b
