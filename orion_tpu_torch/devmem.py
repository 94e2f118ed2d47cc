"""Device-memory and graph-cache accounting: a low-frequency gauge sampler
(port of ``orion_tpu/devmem.py``).

Publishes, into the process-wide telemetry registry (so the numbers flow
through the storage metrics channel into ``info``/``top`` and out of
``/metrics`` like every other gauge):

- ``memory.device_live_bytes`` / ``memory.device_live_arrays`` — the
  caching allocator's bytes held by live tensors
  (``torch.cuda.memory_allocated``) and its count of live blocks
  (``active.all.current``): the counterpart of the reference's walk over
  ``jax.live_arrays()``;
- ``memory.device_bytes_in_use`` / ``memory.device_peak_bytes`` — the
  allocator's reserved bytes and its peak of allocated bytes
  (``torch.cuda.memory_stats``), the reference's ``bytes_in_use`` and
  ``peak_bytes_in_use``;
- ``memory.device_live_bytes.d<id>`` — the live bytes per card;
- ``memory.history_device_bytes.b<cap>`` — resident observation-history
  bytes per pow-2 capacity bucket, ``memory.history_device_bytes`` the
  total, ``memory.history_host_bytes`` the :class:`HostHistory` mirror
  total, ``memory.history_count`` live instances;
- ``memory.fused_cache_entries`` — the captured suggest rounds (the
  counterpart of the reference's jit-cache entry count) and
  ``memory.graph_pool_bytes`` their shared pool's bytes as the newest
  capture left them;
- ``memory.prewarm_started`` / ``memory.prewarm_completed`` — the prewarm
  inventory;
- the compiler plane's ``compiler.*`` gauges (the largest captured round's
  footprint against the card's memory), which the reference publishes
  only on a scrape or after its analysis pass.

All of it reads the allocator's own statistics, never the driver
(``torch.cuda.mem_get_info`` would call into it), so a sample taken while a
capture is in flight on another thread cannot disturb the capture.  A
process whose tensors live on the CPU (or that never initialized CUDA)
publishes no device gauges, as the reference publishes none for a backend
without ``memory_stats``.

Callers: the producer's metrics flush, the health record's ``mem_bytes``
stamp (through the gauge), and every ``/metrics`` scrape (forced).
"""

import logging
import os
import threading
import time

from orion_tpu_torch.analysis.sanitizer import TSAN
from orion_tpu_torch.telemetry import TELEMETRY

log = logging.getLogger(__name__)

#: Seconds between samples (env-tunable, the reference's variable).
try:
    SAMPLE_INTERVAL = float(os.environ.get("ORION_TPU_MEMORY_INTERVAL", "") or 10.0)
except ValueError:
    SAMPLE_INTERVAL = 10.0

_lock = threading.Lock()
_last_sample = 0.0

_BUCKET_GAUGE_NAMES = {}
_DEVICE_GAUGE_NAMES = {}


def _bucket_gauge_name(cap):
    name = _BUCKET_GAUGE_NAMES.get(cap)
    if name is None:
        name = _BUCKET_GAUGE_NAMES[cap] = f"memory.history_device_bytes.b{int(cap)}"
    return name


def _device_gauge_name(dev):
    name = _DEVICE_GAUGE_NAMES.get(dev)
    if name is None:
        name = _DEVICE_GAUGE_NAMES[dev] = f"memory.device_live_bytes.d{int(dev)}"
    return name


def device_stats():
    """``{index: torch.cuda.memory_stats(index)}`` of every card this
    process has initialized; ``{}`` without CUDA.  The seam the tests
    inject allocator statistics through."""
    import torch

    # is_initialized first: is_available would call into the driver of a
    # process (a gateway's worker) that never touched the card.
    if not torch.cuda.is_initialized():
        return {}
    return {i: torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}


def sample_memory(force=False):
    """Publish the memory and graph-cache gauges; rate-limited to
    :data:`SAMPLE_INTERVAL` unless ``force``.  Returns True when a sample
    ran.  Never raises: accounting must not break a run."""
    if not TELEMETRY.enabled:
        return False
    global _last_sample
    now = time.monotonic()
    with _lock:
        TSAN.write("devmem._state")
        if not force and now - _last_sample < SAMPLE_INTERVAL:
            return False
        _last_sample = now
    try:
        _sample_device(device_stats())
        _sample_histories()
        _sample_graph_cache()
        _sample_prewarm_inventory()
    except Exception:  # observability never breaks a run
        log.debug("memory sample failed", exc_info=True)
    return True


def _sample_device(stats):
    """Allocator accounting per card; nothing without a card.  Guarded here
    as well as in :func:`sample_memory`: its arguments are built by
    generators, which must not run with telemetry off."""
    if not stats or not TELEMETRY.enabled:
        return
    live = {dev: int(s.get("allocated_bytes.all.current", 0)) for dev, s in stats.items()}
    TELEMETRY.set_gauge("memory.device_live_bytes", sum(live.values()))
    TELEMETRY.set_gauge("memory.device_live_arrays",
                        sum(int(s.get("active.all.current", 0)) for s in stats.values()))
    TELEMETRY.set_gauge("memory.device_bytes_in_use",
                        sum(int(s.get("reserved_bytes.all.current", 0)) for s in stats.values()))
    TELEMETRY.set_gauge("memory.device_peak_bytes",
                        sum(int(s.get("allocated_bytes.all.peak", 0)) for s in stats.values()))
    # A card that held bytes once but holds none now publishes 0, not its
    # last value.  Each card's gauge name is minted once (_device_gauge_name).
    for dev, name in list(_DEVICE_GAUGE_NAMES.items()):
        if dev not in live:
            TELEMETRY.set_gauge(name, 0)
    for dev, nbytes in live.items():
        name = _device_gauge_name(dev)
        TELEMETRY.set_gauge(name, nbytes)


def _sample_histories():
    from orion_tpu_torch.algo.history import history_memory_stats

    stats = history_memory_stats()
    TELEMETRY.set_gauge("memory.history_device_bytes", stats["device_bytes"])
    TELEMETRY.set_gauge("memory.history_host_bytes", stats["host_bytes"])
    TELEMETRY.set_gauge("memory.history_count", stats["device_count"])
    buckets = stats["device_buckets"]
    # Gauges are never deleted: a bucket every history has grown out of is
    # zeroed, or its stale count would outlive it.  Each bucket's gauge
    # name is minted once (_bucket_gauge_name).
    for cap, name in list(_BUCKET_GAUGE_NAMES.items()):
        if cap not in buckets:
            TELEMETRY.set_gauge(name, 0)
    for cap, nbytes in buckets.items():
        name = _bucket_gauge_name(cap)
        TELEMETRY.set_gauge(name, nbytes)


def _sample_graph_cache():
    """The captured rounds and their pool, from the step graphs' own
    records (no allocator walk), and the compiler plane's ``compiler.*``
    gauges: a capture's footprint is measured when it is captured, so,
    unlike the reference's XLA footprints, it needs no analysis pass."""
    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS
    from orion_tpu_torch.compiler_plane import COMPILE_REGISTRY

    TELEMETRY.set_gauge("memory.fused_cache_entries", STEP_GRAPHS.captured_count())
    if STEP_GRAPHS.pool is not None:
        TELEMETRY.set_gauge("memory.graph_pool_bytes", STEP_GRAPHS.last_pool_bytes())
    COMPILE_REGISTRY.publish_gauges()


def _sample_prewarm_inventory():
    from orion_tpu_torch.algo.prewarm import prewarm_inventory

    inventory = prewarm_inventory()
    TELEMETRY.set_gauge("memory.prewarm_started", inventory["started"])
    TELEMETRY.set_gauge("memory.prewarm_completed", inventory["completed"])
