"""The device mesh of the port: a tuple of device slots driven by one
process (port of ``orion_tpu/algo/sharding.py``).

The reference's mesh is single-controller SPMD: one process drives every
local device and XLA inserts the collectives.  Here a :class:`Mesh` is an
ordered tuple of device *slots* and the collectives are written out: the
sharded GP round (``tpu_bo._suggest_step`` with ``mesh=``) fits the GP once
on the round's own device (the lead slot), draws and generates the pool
there from the same draws as the unsharded round, splits it into
contiguous chunks, one per slot (:func:`shard_candidates`), scores each
chunk on its slot against a copy of the fitted state, and brings back only
reductions (:meth:`ShardedArray.gather`).  Selection then runs on the lead
slot unchanged, so the rows are the pool entries the unsharded round picks.

How slots resolve (:func:`get_mesh`), with no configuration key beyond the
reference's ``n_devices``:

- ``device="cuda"`` (no index): the distinct cards ``cuda:0 .. n-1``;
  raises where fewer than n exist.
- a device with an index (``"cuda:0"``): n logical slots on that card.
- ``device="cpu"``: n logical CPU slots (the tests' counterpart of the
  reference suite's 8 virtual CPU devices).
- after :func:`orion_tpu_torch.parallel.init_distributed`: every rank's
  local slots, rank r owning the r-th block of the global slots; the
  reductions cross ranks through ``torch.distributed.all_gather``.

Every dispatch names its mesh from here, never by constructing one at the
call site: meshes are cached per topology, so repeated calls return the
same object (the port's lint rule JIT004 flags a per-call
``Mesh(...)`` in a captured function), and the mesh's string form (its
fingerprint and slot layout) is part of the round's graph signature.

Placement is counted by slot, not by device: 8 CPU slots report 8
fractions.  The mesh class is the port's own, not
``torch.distributed.DeviceMesh``: one process drives every slot.

This module imports only torch: ``orion_tpu_torch.parallel`` and the
algorithm modules import it.
"""

import threading
from typing import NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

CANDIDATE_AXIS = "candidates"
TENANT_AXIS = "tenants"

# Written once per distinct topology; a leaf lock (nothing else is taken
# while holding it).
_CACHE_LOCK = threading.Lock()
_MESH_CACHE = {}
_SPEC_CACHE = {}


class Cohort(NamedTuple):
    """A ``torch.distributed`` process group this process belongs to (set by
    :func:`orion_tpu_torch.parallel.init_distributed`)."""

    rank: int
    world: int
    local_slots: tuple  # this rank's slot devices
    backend: str


_COHORT = None


def set_cohort(cohort):
    """Record the process group every later :func:`get_mesh` spans."""
    global _COHORT
    _COHORT = cohort


def cohort():
    """The process group set by ``init_distributed``, or None."""
    return _COHORT


class Mesh:
    """Device slots under axis names.

    ``slots`` are this process's slot devices in slot order; ``size`` counts
    the slots of every rank (``world * len(slots)``), this rank's being
    ``first_slot .. first_slot + len(slots) - 1``.  Construct through
    :func:`get_mesh` / :func:`get_stacked_mesh`."""

    def __init__(self, slots, axis_names, shape, rank=0, world=1):
        self.slots = tuple(torch.device(s) for s in slots)
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.rank = int(rank)
        self.world = int(world)
        self.size = self.world * len(self.slots)
        self.first_slot = self.rank * len(self.slots)
        if int(np.prod(self.shape)) != self.size:
            raise ValueError(f"mesh shape {self.shape} does not hold {self.size} slots")
        #: Bytes per slot of the newest pool :func:`shard_candidates` placed
        #: on this mesh (recorded when the round runs eagerly or is captured).
        self.last_placement = None

    @property
    def lead(self):
        """This process's first slot."""
        return self.slots[0]

    @property
    def one_device(self):
        """Every slot of the mesh on one device of this process (logical
        slots): the sharded round needs no copy and no collective, and a
        CUDA graph can capture it."""
        return self.world == 1 and len(set(self.slots)) == 1

    def layout(self):
        """The slots as a short string: ``cuda:0`` for logical slots on one
        device, else every slot's device; ``/rank r of w`` in a cohort."""
        names = [str(s) for s in self.slots]
        text = names[0] if len(set(names)) == 1 else ",".join(names)
        return text if self.world == 1 else f"{text}/rank {self.rank} of {self.world}"

    def __repr__(self):
        # Part of every plan signature that carries the mesh (str(static)).
        return f"{mesh_fingerprint(self)}@{self.layout()}"

    # --- the collectives ---------------------------------------------------
    def gather_rows(self, parts, sizes, device):
        """Concatenate ``parts`` (one tensor per local slot, ``sizes[i]`` rows
        for global slot i) over EVERY slot of the mesh, on ``device``; across
        ranks through ``all_gather``."""
        local = torch.cat([p.to(device) for p in parts]) if len(parts) > 1 else parts[0].to(device)
        if self.world == 1:
            return local
        import torch.distributed as dist

        per_rank = len(self.slots)
        rank_rows = [sum(sizes[r * per_rank:(r + 1) * per_rank]) for r in range(self.world)]
        width = max(rank_rows)
        if local.shape[0] < width:
            pad = torch.zeros((width - local.shape[0],) + tuple(local.shape[1:]),
                              dtype=local.dtype, device=device)
            local = torch.cat([local, pad])
        bufs = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(bufs, local)
        return torch.cat([buf[:rows] for buf, rows in zip(bufs, rank_rows)])


def _resolve_slots(n_devices, device):
    """``(local slot devices, rank, world)`` of a mesh over ``n_devices``
    slots of ``device`` (module docstring)."""
    from orion_tpu_torch.device import resolve_device

    group = _COHORT
    if group is not None:
        per_rank = len(group.local_slots)
        total = group.world * per_rank
        if n_devices is not None and int(n_devices) != total:
            raise ValueError(f"a mesh in a cohort of {group.world} ranks spans all {total} "
                             f"slots; n_devices={n_devices} asks for another count")
        return group.local_slots, group.rank, group.world
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if n > count:
            raise RuntimeError(f"orion_tpu_torch: a mesh over {n} cards, but only {count} "
                               "are visible (name one card, e.g. 'cuda:0', for logical "
                               "slots on it)")
        slots = tuple(torch.device("cuda", i) for i in range(n))
    else:
        n = 1 if n_devices is None else int(n_devices)
        slots = (dev,) * n
    if n < 1:
        raise ValueError(f"a mesh needs at least one slot, not {n}")
    return slots, 0, 1


def _cached_mesh(key, build):
    with _CACHE_LOCK:
        mesh = _MESH_CACHE.get(key)
        if mesh is None:
            mesh = _MESH_CACHE[key] = build()
    return mesh


def get_mesh(n_devices=None, axis_name=CANDIDATE_AXIS, device=None):
    """Cached 1-D mesh of ``n_devices`` slots of ``device`` (None means
    ``cuda``; every slot of a cohort once one is formed).  The key holds the
    resolved slots, so a changed topology never serves a stale mesh."""
    slots, rank, world = _resolve_slots(n_devices, device)
    key = (tuple(str(s) for s in slots), rank, world, (axis_name,), None)
    return _cached_mesh(
        key, lambda: Mesh(slots, (axis_name,), (world * len(slots),), rank, world))


def get_stacked_mesh(n_tenants, n_devices=None, device=None):
    """Cached 2-D ``(tenants, candidates)`` mesh for coalesced dispatch: the
    tenant axis takes the largest power of 2 dividing both the tenant count
    and the slot count, the candidate axis the rest (8 slots, 2 tenants:
    a (2, 4) mesh)."""
    slots, rank, world = _resolve_slots(n_devices, device)
    n = world * len(slots)
    t = _gcd_pow2(max(1, int(n_tenants)), n)
    key = (tuple(str(s) for s in slots), rank, world, (TENANT_AXIS, CANDIDATE_AXIS), t)
    return _cached_mesh(
        key, lambda: Mesh(slots, (TENANT_AXIS, CANDIDATE_AXIS), (t, n // t), rank, world))


def _gcd_pow2(a, b):
    """Largest power of 2 dividing both a and b (>= 1)."""
    g = 1
    while a % 2 == 0 and b % 2 == 0 and g < b:
        a //= 2
        b //= 2
        g *= 2
    return g


class Sharding(NamedTuple):
    """How an array lies on a mesh: split along dim 0 over every slot
    (``axis`` set) or replicated (``axis`` None)."""

    mesh: Mesh
    axis: object


def _cached_spec(mesh, axis):
    key = (id(mesh), axis)
    with _CACHE_LOCK:
        spec = _SPEC_CACHE.get(key)
        if spec is None or spec.mesh is not mesh:
            spec = _SPEC_CACHE[key] = Sharding(mesh, axis)
    return spec


def candidate_spec(mesh, axis_name=CANDIDATE_AXIS):
    """(m, d) candidate matrix: contiguous row chunks, one per slot."""
    return _cached_spec(mesh, axis_name)


def replicated_spec(mesh):
    """A copy on every slot (the fitted GP state)."""
    return _cached_spec(mesh, None)


def split_sizes(rows, n):
    """Rows of each of ``n`` contiguous chunks of ``rows`` (as
    ``torch.tensor_split``: the first ``rows % n`` chunks one longer)."""
    base, extra = divmod(int(rows), int(n))
    return tuple(base + (1 if i < extra else 0) for i in range(n))


class ShardedArray:
    """An array laid out on a mesh: ``shards`` are this process's chunks,
    one per local slot and on that slot's device; ``sizes`` the rows of
    every global slot's chunk; ``home`` the device the array came from and
    reductions return to."""

    def __init__(self, sharding, shards, sizes, rows, row_bytes, home):
        self.sharding = sharding
        self.shards = tuple(shards)
        self.sizes = tuple(sizes)
        self.rows = int(rows)
        self.row_bytes = int(row_bytes)
        self.home = home

    @property
    def mesh(self):
        return self.sharding.mesh

    def offsets(self):
        """The global row index of each local shard's first row."""
        mesh = self.mesh
        start = sum(self.sizes[:mesh.first_slot])
        out = []
        for size in self.sizes[mesh.first_slot:mesh.first_slot + len(mesh.slots)]:
            out.append(start)
            start += size
        return out

    def slot_bytes(self):
        """Bytes this array holds on each global slot."""
        return [size * self.row_bytes for size in self.sizes]

    def map(self, fn, *args):
        """``[fn(shard, *args on the shard's device) for each local shard]``:
        tensors in ``args`` (pytrees of them: a GPState) are copied to each
        distinct slot device once; on the home device they are passed as
        they are."""
        on_device = {}
        out = []
        for shard in self.shards:
            dev = shard.device
            if dev not in on_device:
                on_device[dev] = args if dev == self.home else pytree.tree_map(
                    lambda t, dev=dev: t.to(dev) if torch.is_tensor(t) else t, args)
            out.append(fn(shard, *on_device[dev]))
        return out

    def split(self, tensor, dim):
        """``tensor`` (on home, the pool's length along ``dim``) cut like the
        pool: one piece per local shard, on the shard's device."""
        pieces = []
        for shard, start in zip(self.shards, self.offsets()):
            piece = tensor.narrow(dim, start, shard.shape[0])
            pieces.append(piece if shard.device == self.home else piece.to(shard.device))
        return pieces

    def gather(self, parts):
        """The per-shard ``parts`` (each with its shard's rows along dim 0)
        joined over every slot, on home."""
        return self.mesh.gather_rows(parts, self.sizes, self.home)

    def gather_stats(self, parts):
        """Per-shard ``(q,)`` statistics stacked over every slot:
        ``(mesh.size, q)`` on home."""
        return self.mesh.gather_rows([p[None] for p in parts], (1,) * self.mesh.size,
                                     self.home)


def place(tensor, sharding):
    """``tensor`` (on its home device) laid out by ``sharding``: row chunks
    on the slots (views where a slot is the home device), or a copy on each
    slot.  Records the placement on the mesh."""
    mesh = sharding.mesh
    rows = tensor.shape[0]
    row_bytes = tensor.element_size() * (tensor.numel() // rows if rows else 0)
    if sharding.axis is None:
        sizes = (rows,) * mesh.size
        starts = [0] * len(mesh.slots)
    else:
        sizes = split_sizes(rows, mesh.size)
        starts = [sum(sizes[:mesh.first_slot + i]) for i in range(len(mesh.slots))]
    shards = []
    for i, slot in enumerate(mesh.slots):
        piece = tensor.narrow(0, starts[i], sizes[mesh.first_slot + i])
        shards.append(piece if slot == tensor.device else piece.to(slot))
    out = ShardedArray(sharding, shards, sizes, rows, row_bytes, tensor.device)
    mesh.last_placement = tuple(out.slot_bytes())
    return out


def shard_candidates(candidates, mesh, axis_name=CANDIDATE_AXIS):
    """The candidate pool in contiguous chunks over the mesh's slots."""
    return place(candidates, candidate_spec(mesh, axis_name))


def gather_candidates(array):
    """A (possibly sharded) array back as one host ndarray."""
    if isinstance(array, ShardedArray):
        if array.sharding.axis is None:
            array = array.shards[0]
        else:
            array = array.gather(list(array.shards))
    return np.asarray(array.detach().to("cpu"))


def clear_caches():
    """Drop cached meshes and specs (tests that change the topology)."""
    with _CACHE_LOCK:
        _MESH_CACHE.clear()
        _SPEC_CACHE.clear()


# --------------------------------------------------------------------------
# Placement: the observability side.  Counted from shard sizes, so nothing
# transfers and a rank counts the other ranks' slots too.


class Placement(NamedTuple):
    """Bytes per global slot (what :func:`place` records on the mesh)."""

    slot_bytes: tuple


def _slot_bytes(array):
    if isinstance(array, ShardedArray):
        return array.slot_bytes()
    if isinstance(array, Placement):
        return list(array.slot_bytes)
    return None  # a plain tensor: no slot layout


def placement_fractions(*arrays):
    """slot index -> fraction of the arrays' bytes on that slot.  A
    replicated array adds its full size to every slot, a sharded one its
    chunk to each: a well-sharded round shows near 1/n everywhere, one that
    silently stayed on a slot shows that slot at 1.0."""
    per_slot = {}
    for array in arrays:
        counts = _slot_bytes(array)
        if counts is None:
            continue
        for slot, nbytes in enumerate(counts):
            per_slot[slot] = per_slot.get(slot, 0) + nbytes
    total = sum(per_slot.values())
    if not total:
        return {}
    return {slot: nbytes / total for slot, nbytes in per_slot.items()}


def mesh_utilization(mesh, *arrays):
    """(min_frac, max_frac) of the byte fractions over the mesh's slots; a
    slot holding nothing counts 0.0 (the signal doctor rule DX006 reads)."""
    fractions = placement_fractions(*arrays)
    per = [fractions.get(slot, 0.0) for slot in range(mesh.size)]
    return (min(per), max(per)) if per else (0.0, 0.0)


def mesh_fingerprint(mesh):
    """``"4×candidates"``: a mesh's compact identity for signature fields and
    span args; ``"none"`` for no mesh."""
    if mesh is None:
        return "none"
    try:
        return f"{int(mesh.size)}×{','.join(str(name) for name in mesh.axis_names)}"
    except Exception:  # a foreign object: its repr
        return str(mesh)


def mesh_health_fields(mesh, *arrays):
    """Health-record fields of the mesh: its slot count, and with sample
    arrays the measured per-slot placement."""
    fields = {"mesh_devices": int(mesh.size)}
    if arrays:
        lo, hi = mesh_utilization(mesh, *arrays)
        fields["mesh_util_min_frac"] = float(lo)
        fields["mesh_util_max_frac"] = float(hi)
    return fields
