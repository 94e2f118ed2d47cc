"""Pow-2 shape-bucket prewarming of the captured suggest round (port of
``orion_tpu/algo/prewarm.py``).

The GP history lives in power-of-2-padded buffers: when the observation
count crosses a bucket boundary (64 -> 65 means the fit shape jumps 64 ->
128), the suggest round has a new signature and its first round pays a
warm-up round and a CUDA-graph capture in the middle of a run.

The prewarmer captures the NEXT bucket before the history gets there: when
``count`` nears the boundary (``prewarm_fill`` of the current bucket, or one
more batch of the size just seen would cross it), the algorithm hands a
zero-argument closure — a capture of the round at the next bucket's exact
signature, from dummy inputs — to a :class:`BucketPrewarmer`, which runs it
on a background thread.  The capture takes the step graphs' lock
(:mod:`orion_tpu_torch.algo.step_graphs`), so it never runs beside a replay
of the shared pool.

CUDA forbids synchronizing a whole device or context while one of its
streams is capturing, so while a prewarm captures, another thread must not
call ``torch.cuda.synchronize()`` (the port itself never does; stream and
event waits are fine).  A caller that must, waits for the prewarmer first
(:meth:`BucketPrewarmer.wait`) or runs with ``prewarm=False``.

Honest accounting: prewarm captures count under ``cuda_graph.prewarms`` and
the ``cuda_graph.prewarm.capture`` span, NEVER under
``cuda_graph.recaptures``, which counts only the synchronous captures a
suggest paid.  A failed prewarm is logged and counted as finished, and the
crossing round then captures synchronously (and raises if that fails).
"""

import logging
import threading
import time
import weakref

from orion_tpu_torch.analysis.sanitizer import TSAN
from orion_tpu_torch.algo.history import _next_pow2
from orion_tpu_torch.health import FLIGHT
from orion_tpu_torch.telemetry import TELEMETRY

log = logging.getLogger(__name__)

#: Fraction of the current bucket the history must fill before the next
#: bucket's capture starts.
DEFAULT_PREWARM_FILL = 0.75

_completed_lock = threading.Lock()
_completed_count = 0


def completed_prewarm_count():
    """Monotonic count of finished prewarm attempts (success or failure),
    process-wide."""
    with _completed_lock:
        TSAN.read("prewarm._completed_count")
        return _completed_count


# Live prewarmers (weak), for the prewarm inventory of the device-memory
# sampler (orion_tpu_torch.devmem).
_prewarmers_lock = threading.Lock()
_prewarmers = weakref.WeakSet()


def prewarm_inventory():
    """``{"started", "completed"}``: distinct signatures launched across
    every live :class:`BucketPrewarmer`, and attempts finished
    process-wide."""
    with _prewarmers_lock:
        live = list(_prewarmers)
    return {
        "started": sum(p.started_count() for p in live),
        "completed": completed_prewarm_count(),
    }


def _note_prewarm_completed():
    global _completed_count
    with _completed_lock:
        TSAN.write("prewarm._completed_count")
        _completed_count += 1


def plan_next_bucket(count, *, floor, fill=DEFAULT_PREWARM_FILL, batch=0,
                     next_pow2=_next_pow2):
    """The bucket worth prewarming for a history at ``count`` rows, or None.

    Two triggers, whichever fires first:

    - **batch anticipation**: if one more observe of the size just seen
      (``batch``) would cross the current bucket, warm the bucket that
      observe LANDS in (possibly several buckets ahead);
    - **fill**: the current bucket is at least ``fill`` full."""
    if count <= 0:
        return None
    m = next_pow2(count, floor=floor)
    if batch and count + batch > m:
        return next_pow2(count + batch, floor=floor)
    if count < fill * m:
        return None
    return 2 * m


def plan_fused_step_bucket(count, *, floor, fill=DEFAULT_PREWARM_FILL,
                           batch=0, trust_region=False, tr_local_m=None):
    """Target fit shape for the GP algorithms' round, or None.

    Past ``tr_local_m`` the round's fit shape is pinned at
    ``next_pow2(tr_local_m)``: no boundary left.  A crossing that LANDS past
    the switch targets that pad instead of the raw next bucket, unless the
    pad is at most the current fit shape, which is already captured."""
    if trust_region and tr_local_m is not None and count > tr_local_m:
        return None
    target = plan_next_bucket(count, floor=floor, fill=fill, batch=batch)
    if target is None:
        return None
    if trust_region and tr_local_m is not None and target > tr_local_m:
        target = _next_pow2(tr_local_m, floor=floor)
        if target <= _next_pow2(count, floor=floor):
            return None
    return target


class BucketPrewarmer:
    """Deduplicated background capture runner.

    One instance per algorithm, shared by reference with its naive copies
    (the step graphs are process-wide: one warm covers every clone).  Each
    distinct signature key is attempted at most once; failures are logged
    and swallowed (the crossing then pays the capture it would have paid
    anyway)."""

    def __init__(self):
        self._started = set()
        self._threads = {}
        self._lock = threading.Lock()
        self._completed = 0
        self._failed = 0
        with _prewarmers_lock:
            _prewarmers.add(self)

    def maybe_start(self, key, capture_fn):
        """Run ``capture_fn`` on a background thread unless ``key`` was
        already started.  Returns True when a new prewarm was launched."""
        with self._lock:
            TSAN.write("BucketPrewarmer._threads", self)
            if key in self._started:
                return False
            self._started.add(key)
            thread = threading.Thread(
                target=self._run, args=(key, capture_fn),
                name="orion-tpu-torch-prewarm", daemon=True,
            )
            self._threads[key] = thread
        thread.start()
        return True

    def _run(self, key, capture_fn):
        t0 = time.perf_counter()
        try:
            capture_fn()
        except Exception:  # never raise out of a daemon thread
            log.warning("prewarm capture failed for %r", key, exc_info=True)
            with self._lock:
                self._failed += 1
            return
        finally:
            _note_prewarm_completed()
            with self._lock:
                TSAN.write("BucketPrewarmer._threads", self)
                self._completed += 1
        TELEMETRY.count("cuda_graph.prewarms")
        TELEMETRY.record_span("cuda_graph.prewarm.capture", start=t0)
        if FLIGHT.enabled:
            FLIGHT.record("cuda_graph.prewarm", args={"key": str(key)})

    def started_count(self):
        """Distinct signatures this instance has launched."""
        with self._lock:
            TSAN.read("BucketPrewarmer._threads", self)
            return len(self._started)

    def completed_count(self):
        """Prewarm attempts THIS instance finished (success or failure)."""
        with self._lock:
            TSAN.read("BucketPrewarmer._threads", self)
            return self._completed

    def failed_count(self):
        """Prewarm attempts THIS instance finished with an exception."""
        with self._lock:
            return self._failed

    def wait(self, timeout=None):
        """Join every launched prewarm thread (tests; deterministic
        crossings).  ``timeout`` is per thread."""
        for thread in self._thread_snapshot():
            thread.join(timeout)

    @property
    def in_flight(self):
        """True while any prewarm capture is still running."""
        return any(t.is_alive() for t in self._thread_snapshot())

    def _thread_snapshot(self):
        with self._lock:
            TSAN.read("BucketPrewarmer._threads", self)
            return list(self._threads.values())
