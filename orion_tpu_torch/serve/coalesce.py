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

**Tenant-parallel** (the reference's ``_tenant_mesh_for`` and
``_tenant_parallel_suggest_step``).  When the plans carry a mesh of n >= 2
slots in one process and at least n tenants come together, the tenants
become the mesh's axis instead of the candidates: lane i runs its round
unsharded (the plan without its mesh) on slot ``i % n``, and rows and
GPState come back to the tenant's own device.  The lanes' rounds are
queued one after the other without a host sync between them, so lanes on
distinct cards run at once; logical slots on one card share its step
stream.  The unsharded round equals the sharded one bitwise (the sharded
round's contract), so each tenant still gets its standalone answer.
:data:`LAST_STACK_PLACEMENT` records the dispatch's slot count and the
lanes' byte placement; the gateway publishes them as ``serve_mesh_*``
health fields for doctor rule DX006.  A narrower stack keeps each plan's
own candidate mesh.
"""

import torch
from torch.utils import _pytree as pytree

from orion_tpu_torch.algo.sharding import (
    TENANT_AXIS,
    Placement,
    get_mesh,
    mesh_utilization,
)
from orion_tpu_torch.algo.tpu_bo import FusedPlan, plan_signature, run_fused_plan

#: Placement of the newest mesh-mode coalesced dispatch: ``devices`` (the
#: mesh's slots), ``width`` (tenants), ``tenant_parallel``, and for a
#: tenant-parallel one ``util_min_frac``/``util_max_frac`` of the lanes'
#: input bytes over the slots.
LAST_STACK_PLACEMENT = {}


def _tenant_mesh_for(mesh, width):
    """The tenant-axis mesh ``width`` lanes spread over, or None when the
    lanes keep their candidate mesh: no mesh, a one-slot mesh, a cohort
    across processes (its ranks run every round together), or fewer lanes
    than slots."""
    if mesh is None or mesh.size <= 1 or mesh.world > 1 or width < mesh.size:
        return None
    slots = mesh.slots
    device = slots[0] if len(set(slots)) == 1 else slots[0].type
    return get_mesh(mesh.size, TENANT_AXIS, device=device)


def _lane_on(plan, slot):
    """``plan`` as an unsharded round on ``slot``."""
    statics = {k: v for k, v in plan.statics.items() if k != "mesh"}
    arrays = pytree.tree_map(lambda t: t.to(slot) if torch.is_tensor(t) else t, plan.arrays)
    return FusedPlan(plan_signature(arrays[1].shape, statics), arrays, statics, plan.num)


def _lane_bytes(plan):
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(plan.arrays)
               if torch.is_tensor(t))


def run_coalesced_plans(plans):
    """Run same-signature plans as one dispatch.  Returns ``[(rows, state),
    ...]`` aligned with ``plans``: each exactly what
    :func:`~orion_tpu_torch.algo.tpu_bo.run_fused_plan` returns for that
    plan alone, on the plan's device.  Raises on a mix of signatures, as
    the reference does: the gateway groups its chunks by signature."""
    signature = plans[0].signature
    for plan in plans[1:]:
        if plan.signature != signature:
            raise ValueError("cannot coalesce plans with differing fused-step signatures")
    mesh = plans[0].statics.get("mesh")
    tenant_mesh = _tenant_mesh_for(mesh, len(plans))
    if tenant_mesh is None:
        if mesh is not None and mesh.size > 1:
            LAST_STACK_PLACEMENT.update(devices=int(mesh.size), width=len(plans),
                                        tenant_parallel=False)
            LAST_STACK_PLACEMENT.pop("util_min_frac", None)
            LAST_STACK_PLACEMENT.pop("util_max_frac", None)
        return [run_fused_plan(plan) for plan in plans]
    n = tenant_mesh.size
    lanes = [_lane_on(plan, tenant_mesh.slots[i % n]) for i, plan in enumerate(plans)]
    per_slot = [0] * n
    for i, lane in enumerate(lanes):
        per_slot[i % n] += _lane_bytes(lane)
    lo, hi = mesh_utilization(tenant_mesh, Placement(tuple(per_slot)))
    LAST_STACK_PLACEMENT.update(devices=n, width=len(plans), tenant_parallel=True,
                                util_min_frac=lo, util_max_frac=hi)
    outs = [run_fused_plan(lane) for lane in lanes]
    home = [plan.arrays[1].device for plan in plans]
    return [pytree.tree_map(lambda t, dev=dev: t.to(dev) if torch.is_tensor(t) else t, out)
            for out, dev in zip(outs, home)]
