"""Shared sampling helpers for algorithms (port of
``orion_tpu/algo/sampling.py``)."""

import numpy as np
import torch


def reflect_unit(x):
    """Fold values back into [0, 1] by reflection at the boundaries.

    Hard clipping creates an atom at exactly 0.0/1.0 — a gaussian-perturbed
    candidate lands on the same float over and over, which the storage's
    unique trial index rejects.  ``fmod`` of the non-negative ``|x|`` is
    exact and equals ``jnp.mod`` there.
    """
    r = torch.fmod(torch.abs(x), 2.0)
    return torch.where(r > 1.0, 2.0 - r, r)


def masked_copula_transform(y, mask):
    """Rank -> normal-quantile (copula) transform over the masked rows.

    Real rows (mask 1) get rank r in first-occurrence order (a stable sort,
    as ``jnp.argsort`` is) and map to ``ndtri((r + 0.5) / n)``; padded rows
    sort last (key +inf) and come back exactly 0.0.  Monotone, so the
    argmin row is preserved."""
    n = torch.clamp(torch.sum(mask), min=1.0)
    keyed = torch.where(mask > 0, y, torch.full_like(y, float("inf")))
    order = torch.argsort(keyed, stable=True)
    rank = torch.argsort(order, stable=True)
    q = (rank.to(torch.float32) + 0.5) / n
    out = torch.special.ndtri(torch.clamp(q, 1e-7, 1.0 - 1e-7))
    return torch.where(mask > 0, out, torch.zeros_like(out)).to(torch.float32)


def clamp_objectives(objectives, history):
    """Replace non-finite objectives with the worst finite value known.

    Lies may carry inf sentinels before any real completion; model-based
    algorithms need finite targets.  Returns None when nothing finite is
    known at all (caller should skip the batch).
    """
    objectives = np.asarray(objectives)
    finite = np.isfinite(objectives)
    if np.all(finite):
        return objectives
    if not np.any(finite) and history.size == 0:
        return None
    worst = (
        float(np.max(objectives[finite])) if np.any(finite) else float(np.max(history))
    )
    return np.where(finite, objectives, worst)
