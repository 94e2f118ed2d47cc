"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

Torch cannot reproduce JAX's threefry streams, so the port's suggest step
is a function of its random draws.  :func:`jax_suggest_draws` replays the
exact key schedule of ``orion_tpu.algo.tpu_bo._suggest_step`` through the
same ``jax.random`` calls and hands the numbers to the port as
:class:`~orion_tpu_torch.algo.tpu_bo.SuggestDraws`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orion_tpu_torch.algo.gp.acquisition import RFFDraws
from orion_tpu_torch.algo.tpu_bo import SuggestDraws, _candidate_split, _n_polish


def to_torch(array, dtype=None):
    out = torch.from_numpy(np.array(array))
    return out if dtype is None else out.to(dtype)


def jax_rff_draws(key, n_features, d, q):
    """The draws of ``orion_tpu``'s ``rff_thompson(key, ...)``."""
    k_w, k_g, k_b, k_theta = jax.random.split(key, 4)
    return RFFDraws(
        z=to_torch(jax.random.normal(k_w, (n_features, d), dtype=jnp.float32)),
        gamma=to_torch(jax.random.gamma(k_g, 2.5, (n_features, 1), dtype=jnp.float32)),
        b=to_torch(jax.random.uniform(k_b, (n_features,), dtype=jnp.float32,
                                      maxval=2.0 * jnp.pi)),
        eps=to_torch(jax.random.normal(k_theta, (n_features, q), dtype=jnp.float32)),
    )


def jax_suggest_draws(key, *, q, n_candidates, d_free, d, acq, local_frac, trust_region,
                      tr_perturb_dims=20, n_features=512):
    """Every random array ``orion_tpu``'s ``_suggest_step(key, ...)`` draws,
    from the same keys: ``split(key)`` into the candidate and acquisition
    keys, ``split(k_cand, 7)`` for the trust-region sources with
    ``fold_in(k1, 1)`` for the global ones, ``fold_in(k_cand, 7)`` for the
    polish starts, ``split(k_acq, 4)`` inside ``rff_thompson``."""
    k_cand, k_acq = jax.random.split(key)
    n_global, n_box, n_cov, n_dir, n_cem, n_local = _candidate_split(n_candidates, local_frac)
    fields = {}
    if trust_region:
        k1, k2, k3, k4, k5, k6, k7 = jax.random.split(k_cand, 7)
        fields["box_u"] = to_torch(jax.random.uniform(k1, (n_box, d_free)))
        p_perturb = min(1.0, tr_perturb_dims / d_free)
        if p_perturb < 1.0:
            fields["perturb_mask"] = to_torch(
                jax.random.bernoulli(k2, p_perturb, (n_box, d_free))
            )
            fields["forced_dim"] = to_torch(jax.random.randint(k3, (n_box,), 0, d_free))
        fields["cov_z"] = to_torch(jax.random.normal(k4, (n_cov, d_free)))
        fields["dir_t"] = to_torch(jax.random.normal(k5, (n_dir, 1)))
        fields["dir_z"] = to_torch(jax.random.normal(k6, (n_dir, d_free)))
        fields["cem_z"] = to_torch(jax.random.normal(k7, (n_cem, d_free)))
        fields["global_u"] = to_torch(
            jax.random.uniform(jax.random.fold_in(k1, 1), (n_global, d_free))
        )
        fields["polish_z"] = to_torch(
            jax.random.normal(jax.random.fold_in(k_cand, 7),
                              (_n_polish(q, n_candidates), d_free))
        )
    else:
        k1, k2 = jax.random.split(k_cand)
        fields["global_u"] = to_torch(jax.random.uniform(k1, (n_global, d_free)))
        fields["local_z"] = to_torch(jax.random.normal(k2, (n_local, d_free)))
    if acq == "thompson":
        fields["acq"] = jax_rff_draws(k_acq, n_features, d, q)
    elif acq in ("marginal_thompson", "joint_thompson"):
        fields["acq"] = to_torch(jax.random.normal(k_acq, (q, n_candidates)))
    return SuggestDraws(**fields)


def padded_history(seed, n, n_pad, d, fn=None):
    """``(x, y, mask)`` numpy buffers: ``n`` seeded uniform rows padded with
    zeros to ``n_pad``; ``y`` from ``fn`` (default: a smooth bowl)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n_pad, d), np.float32)
    y = np.zeros((n_pad,), np.float32)
    mask = np.zeros((n_pad,), np.float32)
    x[:n] = rng.uniform(size=(n, d))
    if fn is None:
        y[:n] = np.sum((x[:n] - 0.3) ** 2, axis=1) + 0.1 * np.sin(7.0 * x[:n, 0])
    else:
        y[:n] = fn(x[:n])
    mask[:n] = 1.0
    return x, y, mask
