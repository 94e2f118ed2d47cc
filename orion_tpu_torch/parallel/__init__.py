"""Device-mesh parallelism of the port (port of ``orion_tpu/parallel``).

The reference's only parallelism is N worker processes around a shared
store; that layer survives as it is.  This one shards ONE suggest round's
candidate pool over a mesh of device slots
(:mod:`orion_tpu_torch.algo.sharding`): each slot scores its chunk, and the
round's cross-shard reductions (the Thompson argmins, the per-candidate
mean, std and EI) come back to the lead slot, which selects as the
unsharded round does.

Within one process the reductions are device copies.  Across processes,
:func:`init_distributed` forms a ``torch.distributed`` cohort; after it
:func:`device_mesh` spans every rank's local slots and the reductions go
through ``all_gather``.
"""

from orion_tpu_torch.algo.sharding import (
    CANDIDATE_AXIS,
    TENANT_AXIS,
    Cohort,
    candidate_spec,
    cohort,
    get_mesh,
    get_stacked_mesh,
    replicated_spec,
    set_cohort,
    shard_candidates,
)

__all__ = [
    "CANDIDATE_AXIS",
    "TENANT_AXIS",
    "device_mesh",
    "candidate_sharding",
    "replicated",
    "shard_candidates",
    "get_stacked_mesh",
    "init_distributed",
]


def device_mesh(n_devices=None, axis_name=CANDIDATE_AXIS, device=None):
    """1-D mesh of candidate slots (:func:`~orion_tpu_torch.algo.sharding.get_mesh`):
    cached, so repeated calls with one topology return the SAME object and
    the round's signature probe is an identity hit (lint rule JIT004)."""
    return get_mesh(n_devices, axis_name, device)


def candidate_sharding(mesh, axis_name=CANDIDATE_AXIS):
    """Split an (m, d) candidate matrix along m, one chunk a slot (cached)."""
    return candidate_spec(mesh, axis_name)


def replicated(mesh):
    """A copy on every slot (cached)."""
    return replicated_spec(mesh)


def _init_method(coordinator):
    if coordinator is None:
        return "env://"
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     local_device_ids=None, device=None):
    """Join a ``torch.distributed`` cohort so ONE logical worker spans
    several processes (one per host, or per group of cards).

    Call it in every process of the cohort with the same ``coordinator``
    (``"host:port"`` or ``"tcp://host:port"``; None reads torch's ``env://``
    variables) and ``num_processes``, each with its ``process_id``.
    ``local_device_ids`` are this process's slots: card indices on
    ``device="cuda"`` (None: every visible card), logical slots on
    ``device="cpu"`` (None: one).  The backend is ``nccl`` for cards and
    ``gloo`` for CPU slots.  Afterwards :func:`device_mesh` spans every
    rank's slots, and every rank must run the same suggest calls (SPMD):
    each computes the same fit and selection, and only the scoring is
    split.  Independent workers around a shared store must NOT call this.
    Idempotent: a second call in a live cohort returns at once."""
    import torch
    import torch.distributed as dist

    from orion_tpu_torch.device import resolve_device

    if cohort() is not None and dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        ids = list(range(torch.cuda.device_count())) if local_device_ids is None else list(
            local_device_ids)
        slots = tuple(torch.device("cuda", int(i)) for i in ids)
        backend = "nccl"
    else:
        count = 1 if local_device_ids is None else len(list(local_device_ids))
        slots = (torch.device("cpu"),) * count
        backend = "gloo"
    if not slots:
        raise ValueError("init_distributed: no local slots")
    if not dist.is_initialized():
        kwargs = {}
        if num_processes is not None:
            kwargs["world_size"] = int(num_processes)
        if process_id is not None:
            kwargs["rank"] = int(process_id)
        if backend == "nccl":
            torch.cuda.set_device(slots[0])
        dist.init_process_group(backend, init_method=_init_method(coordinator), **kwargs)
    rank, world = dist.get_rank(), dist.get_world_size()
    # Every rank must bring as many slots: the global slots are rank-major.
    count_dev = slots[0] if backend == "nccl" else torch.device("cpu")
    counts = [torch.zeros(1, dtype=torch.int64, device=count_dev) for _ in range(world)]
    dist.all_gather(counts, torch.full((1,), len(slots), dtype=torch.int64, device=count_dev))
    if len({int(c.item()) for c in counts}) != 1:
        raise ValueError(f"init_distributed: ranks bring different slot counts "
                         f"{[int(c.item()) for c in counts]}")
    set_cohort(Cohort(rank, world, slots, backend))
