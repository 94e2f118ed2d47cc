"""The GP suggest round captured once per signature as a CUDA graph.

This is the port's counterpart of ``jax.jit``'s cache on the reference's
``_suggest_step`` (``orion_tpu/algo/tpu_bo.py:1562``): one entry per plan
signature (the fit buffer's shape and every static of the round, as
:func:`orion_tpu_torch.algo.tpu_bo.make_fused_plan` builds it), filled by the
first round at that signature and replayed by every later one.

On CUDA an entry holds a ``torch.cuda.CUDAGraph`` of :func:`_suggest_step`,
its static input buffers (the draws, x, y, mask, best_x, the warm hypers and
tr_length; made before the capture and outside the graph pool), its static
outputs, and the ``fused_gram`` launches its capture recorded.  A miss runs
three things on the step's stream: an eager warm-up round (this round's
answer; it also fills ``fused_gram``'s occupancy caches and creates the
cuBLAS and cuSOLVER handles and workspaces, none of which may happen inside
a capture), the capture, and the instantiation.  The kernel library is
built and loaded before the lock is taken (``gram.ensure_loaded``).  A
capture or instantiation that fails raises to the caller: there is no eager
fallback.  A hit copies the inputs into the static buffers, replays, and
copies the rows and every leaf of the GPState out of the static outputs.

**One pool a card.**  Every capture on a card allocates from the same
``torch.cuda.graph_pool_handle()``, so the pool holds about the largest
round's working set there, not the sum over signatures.  (After a capture
fails, the allocator refuses to record into that pool again, so the
captures after it take a new one.)  Each card has a pool of its own, held
to the bound below on its own signatures: rounds of several algorithms on
several cards (the coalescer's tenant-parallel lanes) never add one card's
segments to another's.  ``pool_bytes`` counts the allocator's segments of
the current pools and of every pool the cache gave up whose segments are
still reserved; :func:`graph_pool_bytes` counts every graph pool of the
process, whoever made it.

The pool's segments are sized by the captures that made them: the largest
block a round asks for grows with q (32 MiB at q=8, 512 MiB at q=1024 at
the main path's 16384 candidates), and a later, larger capture cannot
assemble its block from the free segments of smaller ones.  Captures in
ascending size therefore leave the pool near the sum of a doubling series
(q = 8 ... 1024 at the main path's width: about 1.55x the q=1024 signature
alone, ``tests/test_torch_cuda.py``'s ascending-q test), where a pool the
largest signature starts holds the others within its own segments.  So the
pool is held to ``POOL_BOUND`` times the largest signature's footprint, the
pool that signature needs alone.  A footprint is exact where it was
measured (a pool's first capture, or a capture alone) and otherwise its
capture's growth of the pool, a lower bound.  A capture that leaves the
pool over the bound on those figures is captured again, alone, into a pool
of its own, which measures its footprint exactly.  If the shared pool is
still over the bound, the signature's own pool replaces it: every entry is
dropped, their graphs and static outputs are freed (whoever still holds the
entry), and the old pool is released; a dropped signature is captured again
at its next round, into segments the larger one already made.  Otherwise
the alone capture is freed and its pool released.  A release is checked
against the allocator: a pool whose segments it still holds stays counted
in ``pool_bytes`` (``stranded_bytes``).

That is safe only while
two graphs of the pool never run at once and each replay's outputs are read
before the next replay reuses their memory: one lock covers every capture
(a prewarm's included) and every replay with its copy-out, and all of them
run on the one step stream.  The next round's warm hypers come from the
copy, never from a static output.  Every access to the cache and to the
pool's memory is annotated for the concurrency sanitizer
(``StepGraphs._entries``, ``StepGraphs._pool``): under ``orion-tpu-torch
tsan`` a round and a prewarm capture that touched either without the lock
between them would report a race.

On the CPU (the caller named it) an entry only marks the signature as seen
and the eager round runs: the signature bookkeeping, and with it the
compiler plane's recapture attribution, is the same on both devices.

**A mesh** (``statics["mesh"]``, :mod:`orion_tpu_torch.algo.sharding`).  A
mesh of logical slots on one card is captured like any round: its chunks
are views of the pool, every launch is on the card's step stream, and the
mesh's string (fingerprint and layout) keeps its signature apart.  A mesh
over distinct cards or ranks runs eagerly and marks its signature as on
the CPU: its round copies the fitted state to each card and gathers the
reductions back (and across ranks, ``all_gather``), which one graph on one
card's stream cannot hold; a graph per slot would split the round into as
many captures with the copies between them on the host's side, and the
shard scoring it would replay is a small share of the round (the fit
dominates, ``PERF.md`` §5).

Launch counts: the ``fused_gram`` wrapper runs in Python only at capture.
The capture records each launch's shape instead of counting it, and every
replay counts those launches again (:func:`orion_tpu_torch.ops.gram.replayed_launches`),
so ``fused_gram.launches`` counts one launch per GP round as the eager path
did.
"""

import ctypes
import threading
import time
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from orion_tpu_torch.analysis.sanitizer import TSAN
from orion_tpu_torch.ops import gram


class StepEntry(NamedTuple):
    """One captured signature on CUDA (``graph`` None: a CPU marker)."""

    graph: object
    static_in: list  # flattened input leaves: the graph's tensors, others as given
    in_spec: object
    statics: dict  # the round's keyword arguments
    static_out: object
    launches: tuple  # (m, n, d, aligned) of each fused_gram launch in the graph
    capture_ms: float
    instantiate_ms: object  # None where capture_end instantiated
    graph_nodes: object  # None where the torch build keeps no graph
    pool_bytes: int  # the bytes of the pool it was recorded into, after this capture
    static_bytes: int  # the static input buffers' bytes (outside the pool)
    grew_bytes: int  # what this capture added to that pool
    alone_bytes: object  # the pool its signature needs alone (exact); None: not measured


#: The step graphs' pool is held to this many times the largest
#: signature's footprint (``PERF.md``'s bound).
POOL_BOUND = 1.5


def _footprint(entry):
    """A lower bound of the pool ``entry``'s signature needs alone: exact
    where it was measured, else what its capture added to the pool."""
    return entry.grew_bytes if entry.alone_bytes is None else entry.alone_bytes


def _over_bound(pool_bytes, footprints):
    """Whether a pool of ``pool_bytes`` is over ``POOL_BOUND`` times the
    largest of ``footprints``."""
    return pool_bytes > POOL_BOUND * max(footprints, default=0)


def _segments(pools):
    """The allocator snapshot's segments of ``pools`` (pool ids as tuples),
    or of every graph pool where ``pools`` is None."""
    if not torch.cuda.is_initialized():
        return []
    return [
        # lint: disable=PERF003 -- walked at a capture (a signature's first
        # round, before and after it), a release and by measurements, never
        # on a replay; the metrics sampler reads last_pool_bytes instead.
        seg for seg in torch.cuda.memory_snapshot()
        if (tuple(seg.get("segment_pool_id") or (0, 0)) != (0, 0) if pools is None
            else tuple(seg.get("segment_pool_id") or ()) in pools)
    ]


def graph_pool_bytes():
    """The reserved bytes of every CUDA-graph pool of the process, whoever
    made it (the allocator's segments of a private pool): the independent
    reading the step graphs' own ``pool_bytes`` is held against."""
    return sum(int(seg["total_size"]) for seg in _segments(None))


def _release(entries, pools, card=None):
    """Free ``entries``' graphs and their static outputs in ``pools`` (on
    ``card``; every card: None), whoever still holds the entries, and hand
    the pools' free segments back to the device.  Returns ``{pool: bytes
    the allocator still holds}``."""
    # No replay of these graphs still running.
    for dev in ([card] if card is not None else
                range(torch.cuda.device_count()) if torch.cuda.is_initialized() else []):
        torch.cuda.synchronize(dev)
    ranges = [(seg["address"], seg["address"] + seg["total_size"]) for seg in _segments(pools)]
    for entry in entries:
        if entry.graph is None:
            continue
        entry.graph.reset()
        for leaf in pytree.tree_leaves(entry.static_out):
            if torch.is_tensor(leaf):
                storage = leaf.untyped_storage()
                if any(lo <= storage.data_ptr() < hi for lo, hi in ranges):
                    storage.resize_(0)
    torch.cuda.empty_cache()
    held = dict.fromkeys(pools, 0)
    for seg in _segments(pools):
        held[tuple(seg["segment_pool_id"])] += int(seg["total_size"])
    return held


def _tensor_bytes(leaves):
    return sum(t.numel() * t.element_size() for t in leaves if torch.is_tensor(t))


def _graph_nodes(graph):
    """Node count of a kept graph, through the driver's ``cuGraphGetNodes``;
    None where the build does not expose the graph."""
    raw = getattr(graph, "raw_cuda_graph", None)
    if raw is None:
        return None
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        count = ctypes.c_size_t(0)
        rc = lib.cuGraphGetNodes(ctypes.c_void_p(raw()), None, ctypes.byref(count))
        return int(count.value) if rc == 0 else None
    except Exception:
        return None


def _new_graph():
    """A graph that keeps its template past ``capture_end``, so capture and
    instantiation are timed apart and its nodes can be counted; a plain one
    on builds without ``keep_graph``."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True), True
    except TypeError:
        return torch.cuda.CUDAGraph(), False


class StepGraphs:
    """Signature -> :class:`StepEntry`, with the one pool, stream and lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self._entries = {}
        self._pool = {}  # card -> the pool the next capture there records into
        self._given_up = {}  # card -> pools given up whose segments were still held
        self._streams = {}
        self.fresh_pools = 0  # shared pools replaced by a signature's own
        self.alone_captures = 0  # signatures captured alone to measure their footprint
        self.stranded_bytes = 0  # what the newest release left reserved

    # --- bookkeeping -------------------------------------------------------
    def has(self, device, signature):
        with self.lock:
            TSAN.read("StepGraphs._entries", self)
            return (_device_key(device), signature) in self._entries

    def entries(self):
        """``[(device, signature, entry), ...]`` in capture order."""
        with self.lock:
            TSAN.read("StepGraphs._entries", self)
            return [(dev, sig, entry) for (dev, sig), entry in self._entries.items()]

    def captured_count(self):
        """Captured graphs (CPU markers excluded): devmem's counterpart of
        the reference's ``memory.fused_cache_entries``."""
        with self.lock:
            TSAN.read("StepGraphs._entries", self)
            return sum(1 for entry in self._entries.values() if entry.graph is not None)

    @property
    def pool(self):
        """The pool the next capture on the first card captured records
        into (None before the first capture)."""
        with self.lock:
            TSAN.read("StepGraphs._pool", self)
            return self._pool[min(self._pool, key=str)] if self._pool else None

    def _pools(self, device=None):
        """The current and given-up pools of ``device`` (every card: None)."""
        cards = list(self._pool.keys() | self._given_up.keys()) if device is None else [device]
        pools = set()
        for card in cards:
            pools |= self._given_up.get(card, set())
            if card in self._pool:
                pools.add(tuple(self._pool[card]))
        return pools

    def pool_bytes(self, device=None):
        """The reserved bytes of the current pool and of every pool the
        cache gave up that the allocator still holds, on ``device`` (every
        card: None; 0 before the first capture)."""
        pools = self._pools(None if device is None else _device_key(device))
        return sum(int(seg["total_size"]) for seg in _segments(pools)) if pools else 0

    def last_pool_bytes(self):
        """The pool's bytes as the newest capture left them (no allocator
        walk: a metrics sampler's read; it waits out a capture in flight)."""
        with self.lock:
            TSAN.read("StepGraphs._entries", self)
            sizes = [e.pool_bytes for e in self._entries.values() if e.graph is not None]
        return max(sizes) if sizes else 0

    def reset(self):
        """Drop every entry and release every pool (tests; a fresh
        measurement)."""
        with self.lock:
            TSAN.write("StepGraphs._entries", self)
            TSAN.write("StepGraphs._pool", self)
            entries, pools = list(self._entries.values()), self._pools()
            self._entries = {}
            self._pool = {}
            self._given_up = {}
            self.fresh_pools = self.alone_captures = self.stranded_bytes = 0
            if pools:
                _release(entries, pools)

    def replay_ms(self, device, signature, replays):
        """Device ms of ``replays`` back-to-back replays of ``signature``'s
        captured graph on ``device``, between two CUDA events on the step
        stream, under the lock: the graph alone, no input copied in and no
        output copied out (a bench's reading,
        ``orion_tpu_torch/benchmarks/suggest_bench.py``).  Each replay
        counts its ``fused_gram`` launches, as a round's does."""
        device = _device_key(device)
        with self.lock:
            TSAN.write("StepGraphs._pool", self)  # the replays rewrite the static outputs
            entry = self._entries[(device, signature)]
            stream = self._stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                start.record(stream)
                for _ in range(replays):
                    with gram.replayed_launches(entry.launches):
                        entry.graph.replay()
                end.record(stream)
            end.synchronize()
        return start.elapsed_time(end)

    def _stream(self, device):
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        return stream

    # --- the round ---------------------------------------------------------
    def run(self, fn, signature, arrays, statics):
        """``fn(*arrays, **statics)`` for this signature: on a miss the
        eager round (and, on CUDA, the capture); on a hit the replay.
        Returns ``(out, entry, missed)``."""
        device = arrays[1].device
        key = (_device_key(device), signature)
        if device.type == "cuda":
            gram.ensure_loaded()
        with self.lock:
            TSAN.read("StepGraphs._entries", self)
            entry = self._entries.get(key)
            if device.type != "cuda" or not _capturable(statics):
                missed = entry is None
                if missed:
                    TSAN.write("StepGraphs._entries", self)
                    entry = self._entries[key] = _CPU_MARKER
                return fn(*arrays, **statics), entry, missed
            if entry is not None:
                return self._replay(entry, arrays, device), entry, False
            out, entry = self._capture(fn, arrays, statics, device)
            TSAN.write("StepGraphs._entries", self)
            self._entries[key] = entry
            return out, entry, True

    def prewarm(self, fn, signature, arrays, statics):
        """Capture ``signature`` ahead of the round that needs it, from
        dummy ``arrays`` (the prewarmer's thread).  Returns the new entry,
        or None when the signature is already captured."""
        device = arrays[1].device
        key = (_device_key(device), signature)
        if device.type == "cuda":
            gram.ensure_loaded()
        with self.lock:
            TSAN.read("StepGraphs._entries", self)
            if key in self._entries:
                return None
            if device.type != "cuda" or not _capturable(statics):
                entry = _CPU_MARKER
            else:
                _, entry = self._capture(fn, arrays, statics, device)
            TSAN.write("StepGraphs._entries", self)
            self._entries[key] = entry
            return entry

    # The methods below run only inside run and prewarm, under self.lock.
    def _capture(self, fn, arrays, statics, device):
        """Warm-up round, capture and instantiation on the step stream, and
        the pool bound.  Returns ``(warm-up output, entry)``."""
        stream = self._stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        leaves, in_spec = pytree.tree_flatten(arrays)
        with torch.cuda.stream(stream):
            out = fn(*arrays, **statics)
            # Outside the pool: allocated before the capture begins.
            static_in = [t.clone() if torch.is_tensor(t) else t for t in leaves]
        TSAN.write("StepGraphs._pool", self)
        card = _device_key(device)
        if card not in self._pool:
            # lint: disable=LCK002 -- runs only inside run/prewarm's lock
            self._pool[card] = torch.cuda.graph_pool_handle()
        entry = self._record(fn, static_in, in_spec, statics, device, self._pool[card])
        others = [_footprint(e) for (dev, _), e in self._entries.items() if dev == card]
        if _over_bound(entry.pool_bytes, others + [_footprint(entry)]):
            entry = self._bound(fn, static_in, in_spec, statics, device, entry, others)
        current.wait_stream(stream)
        _record_stream(out, current)
        return out, entry

    def _record(self, fn, static_in, in_spec, statics, device, pool):
        """Capture ``fn`` over the static inputs into ``pool`` and
        instantiate it, on the step stream (the warm-up already ran)."""
        before = sum(int(seg["total_size"]) for seg in _segments({tuple(pool)}))
        stream = self._stream(device)
        with torch.cuda.stream(stream):
            graph, kept = _new_graph()
            t0 = time.perf_counter()
            try:
                with gram.recorded_launches() as launches, torch.cuda.graph(
                    graph, pool=pool, stream=stream, capture_error_mode="thread_local"
                ):
                    static_out = fn(*pytree.tree_unflatten(static_in, in_spec), **statics)
            except BaseException:
                # capture_end raised before it ended the allocator's routing
                # into the pool: end it, and give the pool up (the allocator
                # refuses it from now on; its segments stay counted).
                _end_allocating_to(device, pool)
                card = _device_key(device)
                self._given_up.setdefault(card, set()).add(tuple(pool))
                if pool is self._pool.get(card):
                    del self._pool[card]
                raise
            capture_ms = (time.perf_counter() - t0) * 1e3
            nodes = instantiate_ms = None
            if kept:
                nodes = _graph_nodes(graph)
                t0 = time.perf_counter()
                graph.instantiate()
                instantiate_ms = (time.perf_counter() - t0) * 1e3
        after = sum(int(seg["total_size"]) for seg in _segments({tuple(pool)}))
        return StepEntry(
            graph, static_in, in_spec, dict(statics), static_out, tuple(launches), capture_ms,
            instantiate_ms, nodes, after, _tensor_bytes(static_in), after - before,
            after if before == 0 else None,
        )

    def _bound(self, fn, static_in, in_spec, statics, device, shared, others):
        """``shared`` left the pool over the bound on the footprints known:
        capture its signature again, alone, into a pool of its own, which
        measures its footprint.  If the shared pool is over the bound on
        that figure too, the alone pool replaces it (every entry dropped,
        the shared pool released); else the alone capture is released."""
        pool = torch.cuda.graph_pool_handle()
        alone = self._record(fn, static_in, in_spec, statics, device, pool)
        # lint: disable=LCK002 -- runs only inside run/prewarm's lock
        self.alone_captures += 1
        shared = shared._replace(alone_bytes=alone.alone_bytes)
        if not _over_bound(shared.pool_bytes, others + [alone.alone_bytes]):
            self._give_up([alone], {tuple(pool)}, _device_key(device))
            return shared
        TSAN.write("StepGraphs._entries", self)
        card = _device_key(device)
        mine = [key for key in self._entries if key[0] == card]
        dropped, old = [self._entries.pop(key) for key in mine] + [shared], self._pools(card)
        # lint: disable=LCK002 -- runs only inside run/prewarm's lock
        self._pool[card] = pool
        # lint: disable=LCK002 -- runs only inside run/prewarm's lock
        self.fresh_pools += 1
        self._give_up(dropped, old, card)
        return alone

    def _give_up(self, entries, pools, card):
        """Release ``pools`` (of ``card``) with ``entries``; a pool whose
        segments the allocator still holds stays counted."""
        held = _release(entries, pools, card)
        given_up = self._given_up.setdefault(card, set())
        for pool, nbytes in held.items():
            if nbytes:
                given_up.add(pool)
            else:
                given_up.discard(pool)
        # lint: disable=LCK002 -- runs only inside run/prewarm's lock
        self.stranded_bytes = sum(held.values())

    def _replay(self, entry, arrays, device):
        """Inputs in, replay, rows and state out — all on the step stream,
        under the lock."""
        TSAN.write("StepGraphs._pool", self)  # the replay rewrites the static outputs
        stream = self._stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        leaves = pytree.tree_leaves(arrays)
        with torch.cuda.stream(stream):
            for buf, value in zip(entry.static_in, leaves):
                if torch.is_tensor(buf):
                    buf.copy_(value)
            with gram.replayed_launches(entry.launches):
                entry.graph.replay()
            out = pytree.tree_map(
                lambda t: t.clone() if torch.is_tensor(t) else t, entry.static_out)
        current.wait_stream(stream)
        _record_stream(out, current)
        return out


def _capturable(statics):
    """Whether a round with these statics can be one CUDA graph: no mesh, or
    a mesh of logical slots on one card."""
    mesh = statics.get("mesh")
    return mesh is None or mesh.one_device


def _device_key(device):
    """``device`` with its index (``cuda`` means the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _end_allocating_to(device, pool):
    try:
        torch._C._cuda_endAllocateToPool(device.index or 0, pool)
    except Exception:  # already ended: the failure came after capture_end
        pass


def _record_stream(tree, stream):
    """Tensors made on the step stream and used on the caller's: their
    blocks are not reused until the caller's stream is past them."""
    for leaf in pytree.tree_leaves(tree):
        if torch.is_tensor(leaf):
            leaf.record_stream(stream)


#: A CPU entry: the signature was seen, nothing was captured.
_CPU_MARKER = StepEntry(None, [], None, {}, None, (), 0.0, None, None, 0, 0, 0, None)

#: THE process-wide cache: one pool, one lock.
STEP_GRAPHS = StepGraphs()
