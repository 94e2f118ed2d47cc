"""Cross-tenant coalescing of GP suggest rounds (port of
``orion_tpu/serve/coalesce.py``).

Tenants whose :class:`~orion_tpu_torch.algo.tpu_bo.FusedPlan` signatures
match (the same fit-buffer bucket, q bucket and statics) are dispatched
together: :func:`run_coalesced_plans` runs each plan's standalone round
(:func:`~orion_tpu_torch.algo.tpu_bo.run_fused_plan`, one replay of the
signature's CUDA graph) one after the other, all enqueued on the stream
before the gateway reads any result back.

**Bit-identity is the design constraint**: a tenant gets the rows and
GPState it would get served alone.  The reference keeps it with
``jax.lax.map`` over lanes of the unchanged ``_suggest_step`` (not
``vmap``: batched linear algebra changes the order of reductions).  The
port runs the standalone round itself, so the equality holds by
construction, and a coalesced dispatch needs no graph, pool bytes or
prewarm of its own.  A stacked graph of t_pad lanes (the reference's
shape, one replay for t_pad tenants) does the same device work and was no
faster on an H100: a width-8 replay took 1.002-1.003x eight standalone
replays, and its ~96,000-node capture added seconds to the first round at
each width (``PERF.md`` §6).

Left out: the reference's tenant-parallel mesh branch, which belongs to the
multi-device mesh (ROADMAP queue A item 10): a port plan never carries a
mesh.
"""

from orion_tpu_torch.algo.tpu_bo import run_fused_plan


def run_coalesced_plans(plans):
    """Run same-signature plans as one dispatch.  Returns ``[(rows, state),
    ...]`` aligned with ``plans``: each exactly what
    :func:`~orion_tpu_torch.algo.tpu_bo.run_fused_plan` returns for that
    plan alone (it is that call).  Raises on a mix of signatures, as the
    reference does: the gateway groups its chunks by signature."""
    signature = plans[0].signature
    for plan in plans[1:]:
        if plan.signature != signature:
            raise ValueError("cannot coalesce plans with differing fused-step signatures")
    return [run_fused_plan(plan) for plan in plans]
