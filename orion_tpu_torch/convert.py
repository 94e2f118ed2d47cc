"""Carry optimizer state from ``orion_tpu`` into the port.

Nothing here imports ``orion_tpu`` or JAX: the functions read any object
whose leaves ``numpy.asarray`` can convert (a JAX ``GPState``, a
``TPUBO.state_dict()``), so a checkpoint of the reference can be restored
on the card.
"""

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


def algo_state_from_jax(state):
    """``orion_tpu`` ``TPUBO.state_dict()`` -> a state for the port's
    ``TPUBO.set_state``: the observations (``x``, ``y``), the trust region
    (``tr``, ``tr_center``), the GP warm start (``gp_hypers``) and
    ``n_observed`` carry over as they are.

    The threefry ``rng_key`` cannot seed a ``torch.Generator``
    equivalently: the port reseeds from a seed derived from the key's two
    words (``seed_from_rng_key``), so the restored instance's random stream
    differs from the reference's.  Given the same draws, its suggest step is
    the reference's."""
    out = {
        "seed": seed_from_rng_key(state["rng_key"]),
        "n_observed": int(state["n_observed"]),
        "x": [list(map(float, row)) for row in state["x"]],
        "y": [float(v) for v in state["y"]],
    }
    for key in ("tr", "tr_center", "gp_hypers"):
        if key in state:
            out[key] = state[key]
    return out
