"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

Torch cannot reproduce JAX's threefry streams, so the port's device steps
are functions of their random draws.  The ``jax_*`` helpers replay a
reference function's key schedule through the same ``jax.random`` calls and
hand the numbers to the port: :func:`jax_suggest_draws` for
``tpu_bo._suggest_step`` (:class:`~orion_tpu_torch.algo.tpu_bo.SuggestDraws`),
:func:`jax_tpe_draws` for ``tpe._tpe_suggest``, :func:`jax_de_draws` for
``de._de_propose``, :func:`jax_cma_z` for ``cmaes._cma_sample`` and
:func:`jax_asha_uniforms` for ASHA's bracket draw.
:func:`isolated_telemetry` sets both packages' telemetry registries and
flight recorders aside for a test.
"""

import contextlib
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orion_tpu.algo.tpe import _rank_log_weights as jax_rank_log_weights
from orion_tpu_torch.algo.de import DEDraws
from orion_tpu_torch.algo.gp.acquisition import RFFDraws
from orion_tpu_torch.algo.tpe import TPEDraws
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


@partial(jax.jit, static_argnums=(1, 2, 3))
def _tpe_draws(key, n_good, m, d):
    k_pick, k_noise, k_mix = jax.random.split(key, 3)
    idx = jax.random.categorical(k_pick, jax_rank_log_weights(n_good), shape=(m, d))
    return idx, jax.random.normal(k_noise, (m, d)), jax.random.uniform(k_mix, (m, d))


def jax_tpe_draws(key, *, n_good, n_candidates, num, d):
    """The draws of ``orion_tpu``'s ``_tpe_suggest(key, good, ...)`` with
    ``n_good`` good points: ``split(key, 3)`` into the pick (a categorical
    over the rank log-weights, computed under jit as the reference does),
    noise and uniform keys; the pool is ``max(n_candidates, num)``."""
    m = max(n_candidates, num)
    idx, noise, uniform = _tpe_draws(key, n_good, m, d)
    return TPEDraws(to_torch(idx), to_torch(noise), to_torch(uniform))


def jax_de_draws(key, *, P, num, d, f_lo, f_hi, cr):
    """The draws of ``orion_tpu``'s ``_de_propose(key, pop, ...)``:
    ``split(key, 7)`` into the target offset, r1, r2, r3, F, the
    crossover mask and the forced coordinate."""
    k0, k1, k2, k3, k4, k5, k6 = jax.random.split(key, 7)
    return DEDraws(
        offset=to_torch(jax.random.randint(k0, (), 0, P)),
        r1=to_torch(jax.random.randint(k1, (num,), 0, P - 1)),
        r2=to_torch(jax.random.randint(k2, (num,), 0, P - 1)),
        r3=to_torch(jax.random.randint(k3, (num,), 0, P - 1)),
        F=to_torch(jax.random.uniform(k4, (num, 1), minval=f_lo, maxval=f_hi)),
        cross=to_torch(jax.random.bernoulli(k5, cr, (num, d))),
        jrand=to_torch(jax.random.randint(k6, (num,), 0, d)),
    )


def jax_cma_z(key, num, d):
    """The normal draws of ``orion_tpu``'s ``_cma_sample(key, state, num)``."""
    return to_torch(jax.random.normal(key, (num, d)))


def jax_asha_uniforms(bracket_key, num):
    """The bracket uniforms of ``orion_tpu``'s
    ``ASHA._assign_new_points(u, bracket_key)``."""
    return np.asarray(jax.random.uniform(bracket_key, (num,)))


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


@contextlib.contextmanager
def isolated_telemetry(enabled=True):
    """Both packages' process-wide ``TELEMETRY`` registry and ``FLIGHT``
    recorder, reset and switched ``enabled`` for the block, then reset and
    put back as they were (the registries are globals shared with every
    other test of the process).  ``ORION_TPU_METRICS_PORT``, which a
    ``metrics_port:`` config sets, is put back too.  Yields ``(port
    telemetry, port flight, reference telemetry, reference flight)``."""
    from orion_tpu.health import FLIGHT as REF_FLIGHT
    from orion_tpu.telemetry import TELEMETRY as REF_TELEMETRY
    from orion_tpu_torch.health import FLIGHT
    from orion_tpu_torch.telemetry import TELEMETRY

    owners = (TELEMETRY, FLIGHT, REF_TELEMETRY, REF_FLIGHT)
    was = [owner.enabled for owner in owners]
    port_env = os.environ.get("ORION_TPU_METRICS_PORT")

    def clean():
        for telemetry in (TELEMETRY, REF_TELEMETRY):
            telemetry.reset()
        for flight in (FLIGHT, REF_FLIGHT):
            flight.clear()

    clean()
    for owner in owners:
        owner.enabled = bool(enabled)
    try:
        yield owners
    finally:
        clean()
        for owner, state in zip(owners, was):
            owner.enabled = state
        if port_env is None:
            os.environ.pop("ORION_TPU_METRICS_PORT", None)
        else:
            os.environ["ORION_TPU_METRICS_PORT"] = port_env


class FakeOrionCollection:
    """Stands in for a collection of a reference-Oríon pickled database
    (``db load`` reads its ``find()``)."""

    def __init__(self, docs):
        self._docs = list(docs)

    def find(self):
        return [dict(doc) for doc in self._docs]


class FakeOrionDB:
    """Stands in for a reference-Oríon ``PickledDB`` file's database: its
    collections by name under ``_db``."""

    def __init__(self, collections):
        self._db = dict(collections)
