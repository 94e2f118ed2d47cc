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

**One pool.**  Every capture of the process allocates from the same
``torch.cuda.graph_pool_handle()``, so the pool holds about the largest
round's working set, not the sum over signatures.  (After a capture fails,
the allocator refuses to record into that pool again, so the captures after
it take a new one; ``pool_bytes`` counts every pool the cache used.)  That is safe only while
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
    pool_bytes: int  # the shared pool's bytes after this capture
    static_bytes: int  # the static input buffers' bytes (outside the pool)


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
        self._pools = []
        self._streams = {}

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
        """The pool the next capture records into (None before the first)."""
        with self.lock:
            TSAN.read("StepGraphs._pool", self)
            return self._pools[-1] if self._pools else None

    def pool_bytes(self):
        """The reserved bytes of the cache's pools, summed over the
        allocator snapshot's segments of those pools (0 before the first
        capture)."""
        pools = {tuple(pool) for pool in self._pools}
        if not pools:
            return 0
        return sum(
            int(seg["total_size"]) for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id") or ()) in pools
        )

    def last_pool_bytes(self):
        """The pool's bytes as the newest capture left them (no allocator
        walk: a metrics sampler's read; it waits out a capture in flight)."""
        with self.lock:
            TSAN.read("StepGraphs._entries", self)
            sizes = [e.pool_bytes for e in self._entries.values() if e.graph is not None]
        return max(sizes) if sizes else 0

    def reset(self):
        """Drop every entry and the pool (tests; a fresh measurement)."""
        with self.lock:
            TSAN.write("StepGraphs._entries", self)
            TSAN.write("StepGraphs._pool", self)
            self._entries = {}
            self._pools = []

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
            if device.type != "cuda":
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
            if device.type != "cuda":
                entry = _CPU_MARKER
            else:
                _, entry = self._capture(fn, arrays, statics, device)
            TSAN.write("StepGraphs._entries", self)
            self._entries[key] = entry
            return entry

    def _capture(self, fn, arrays, statics, device):
        """Warm-up round, capture and instantiation on the step stream; the
        lock is held.  Returns ``(warm-up output, entry)``."""
        TSAN.write("StepGraphs._pool", self)
        if not self._pools:
            self._pools.append(torch.cuda.graph_pool_handle())
        pool = self._pools[-1]
        stream = self._stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        leaves, in_spec = pytree.tree_flatten(arrays)
        with torch.cuda.stream(stream):
            out = fn(*arrays, **statics)
            # Outside the pool: allocated before the capture begins.
            static_in = [t.clone() if torch.is_tensor(t) else t for t in leaves]
            graph, kept = _new_graph()
            t0 = time.perf_counter()
            try:
                with gram.recorded_launches() as launches, torch.cuda.graph(
                    graph, pool=pool, stream=stream, capture_error_mode="thread_local"
                ):
                    static_out = fn(*pytree.tree_unflatten(static_in, in_spec), **statics)
            except BaseException:
                # capture_end raised before it ended the allocator's routing
                # into the pool: end it, and record later captures into a new
                # pool (the allocator refuses this one from now on).
                _end_allocating_to(device, pool)
                self._pools.append(torch.cuda.graph_pool_handle())
                raise
            capture_ms = (time.perf_counter() - t0) * 1e3
            nodes = instantiate_ms = None
            if kept:
                nodes = _graph_nodes(graph)
                t0 = time.perf_counter()
                graph.instantiate()
                instantiate_ms = (time.perf_counter() - t0) * 1e3
        current.wait_stream(stream)
        _record_stream(out, current)
        entry = StepEntry(
            graph, static_in, in_spec, dict(statics), static_out, tuple(launches), capture_ms,
            instantiate_ms, nodes, self.pool_bytes(), _tensor_bytes(static_in),
        )
        return out, entry

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
_CPU_MARKER = StepEntry(None, [], None, {}, None, (), 0.0, None, None, 0, 0)

#: THE process-wide cache: one pool, one lock.
STEP_GRAPHS = StepGraphs()
