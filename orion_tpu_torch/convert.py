"""Carry optimizer state from ``orion_tpu`` into the port.

Nothing here imports ``orion_tpu`` or JAX: the functions read any object
whose leaves ``numpy.asarray`` can convert (a JAX ``GPState``, an
algorithm's ``state_dict()``), so a checkpoint of the reference can be
restored on the card; :func:`storage_from_jax` opens the reference's
``pickled`` storage file, so its experiments resume in the port.
"""

import os

import numpy as np
import torch

from orion_tpu_torch.algo.gp.gp import GPHypers, GPState
from orion_tpu_torch.device import resolve_device


def _tensor(value, device, dtype=torch.float32):
    if value is None:
        return None
    # A copy: JAX hands out read-only buffers, which torch will not wrap.
    return torch.as_tensor(np.array(value), dtype=dtype, device=device)


def gp_state_from_numpy(state, device=None):
    """A reference ``GPState`` (x, y, mask, hypers, chol, alpha, y_mean,
    y_std, mll, health) as the port's :class:`GPState` on ``device``
    (``None`` means ``cuda`` and raises where no card is present)."""
    device = resolve_device(device)
    hypers = GPHypers(*(_tensor(leaf, device) for leaf in state.hypers))
    return GPState(
        x=_tensor(state.x, device),
        y=_tensor(state.y, device),
        mask=_tensor(state.mask, device),
        hypers=hypers,
        chol=_tensor(state.chol, device),
        alpha=_tensor(state.alpha, device),
        y_mean=_tensor(state.y_mean, device),
        y_std=_tensor(state.y_std, device),
        mll=_tensor(getattr(state, "mll", None), device),
        health=_tensor(getattr(state, "health", None), device),
    )


def seed_from_rng_key(rng_key):
    """A 64-bit seed from a threefry key's two uint32 words."""
    hi, lo = (int(w) & 0xFFFFFFFF for w in np.asarray(rng_key, dtype=np.uint32).ravel()[:2])
    return (hi << 32) | lo


def _plain(value):
    """``value`` with its arrays as (nested) lists and numpy scalars as
    Python numbers, containers copied."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    if hasattr(value, "tolist"):
        return value.tolist()
    return value


def algo_state_from_jax(state):
    """An ``orion_tpu`` algorithm's ``state_dict()`` -> a state for the
    port's ``set_state`` of the same algorithm.

    Every field but the key carries over as it is, with arrays as lists:
    the observations of ``tpu_bo`` (``x``, ``y``, ``tr``, ``tr_center``,
    ``gp_hypers``) and ``tpe`` (``x``, ``y``); ``cmaes``'s distribution
    (``cma``: m, sigma, C, pc, ps, gen) and generation buffer; ``de``'s
    ``pop``/``fit``/``n_filled``; the rungs of ``asha``/``hyperband``
    (``brackets``, ``bracket_of``) and, on top of them, ``bohb``'s
    ``tiers`` and ``asha_bo``'s ``mf_x``/``mf_s``/``mf_y``, ``sigma``,
    ``best_seen`` and ``tr``; ``grid_search``'s ``cursor``; and
    ``n_observed``.

    The threefry ``rng_key`` cannot seed a ``torch.Generator``
    equivalently: the port reseeds from a seed derived from the key's two
    words (``seed_from_rng_key``), so the restored instance's random stream
    differs from the reference's.  Given the same draws, its next device
    step is the reference's."""
    out = {k: _plain(v) for k, v in state.items() if k != "rng_key"}
    out["seed"] = seed_from_rng_key(state["rng_key"])
    out["n_observed"] = int(state["n_observed"])
    return out


def storage_from_jax(path, retry=None):
    """A :class:`~orion_tpu_torch.storage.base.DocumentStorage` over the
    ``pickled`` file at ``path`` that ``orion_tpu`` wrote: the same
    experiments and trial documents, ids included, so an experiment the
    reference created resumes here (``build_experiment`` with its name).

    The file is read without importing ``orion_tpu``
    (``storage/backends.py::_DBUnpickler``, which refuses, and leaves
    unchanged, a file holding any other ``orion_tpu`` class).  One way only: the port's
    first write (opening it here already writes its indexes) stores the
    port's class paths, and the reference cannot read the file after
    that; copy the file first to keep a version the reference reads."""
    from orion_tpu_torch.storage.backends import PickledDB
    from orion_tpu_torch.storage.base import DocumentStorage

    if not os.path.isfile(path):
        raise FileNotFoundError(f"no storage file at {path!r}")
    return DocumentStorage(PickledDB(path), retry=retry)
