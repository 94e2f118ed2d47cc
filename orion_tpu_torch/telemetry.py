"""Unified telemetry: metrics registry + span tracer + exporters (port of
``orion_tpu/telemetry.py``, same names, same record schema, same env
switches ``ORION_TPU_TELEMETRY`` and ``ORION_TPU_TELEMETRY_SPANS``).

One process-wide :class:`Telemetry` registry holds:

- **counters** (monotonic ints), **gauges** (last-set floats), and
  **histograms** (fixed log2 buckets over seconds — mergeable across
  workers by summing buckets, percentile-queryable without storing samples);
- a **span tracer**: monotonic-clock ``(name, ts, dur, pid, tid)`` records
  in a preallocated ring buffer, exported as JSONL or Chrome trace-event
  JSON (loads directly in Perfetto / chrome://tracing).

The registry is near-zero-cost when disabled: every mutator early-returns
on one attribute check, and ``span()`` returns a shared no-op context
manager — no locks, no allocations, no clock reads.  Toggle with the
``ORION_TPU_TELEMETRY`` env var (``1/on/true/yes``), the ``telemetry:``
config key, or programmatically via ``TELEMETRY.enable()``.

Contract shared with the producer's ``_flush_timings``: telemetry must
never raise into a hot path.  Mutators swallow their own failures; only
the explicit exporters propagate I/O errors.

Cross-worker story: each worker flushes ``snapshot()`` (metrics) and
``drain_spans()`` (new span records) through the storage channel
(``DocumentStorage.record_metrics`` / ``record_spans``) every producer
round; ``orion-tpu-torch metrics`` merges the snapshots with
:func:`merge_snapshots`, and ``orion-tpu-torch trace`` merges every
worker's spans into one Chrome trace (span timestamps are wall-anchored
monotonic readings, so processes line up on a shared timeline).

Distributed tracing: a :class:`TraceContext` (128-bit ``trace_id``, 64-bit
``span_id``, ``sampled`` flag) rides a thread-local ambient slot.  With
telemetry enabled, a ``with``-managed span minted under an ambient context
becomes a CHILD of it (fresh ``span_id``, same ``trace_id``) and installs
itself as the ambient for its body, so nesting builds a real tree; span
records carry ``trace_id``/``span_id``/``parent_span_id``.
:func:`chrome_trace_events` turns cross-process parent/link edges into
Perfetto flow events (``s``/``f`` phases).  The wire clients that inject
the context into their requests are ``storage.netdb``'s and
``serve.client``'s.

Every access to the registry's shared state under its lock is annotated
for the concurrency sanitizer (``TSAN.read``/``TSAN.write``, one attribute
check when it is off), as in the reference.
"""

import json
import os
import threading
import time
import weakref

# Annotated-cell hooks for the runtime concurrency sanitizer
# (orion-tpu-torch tsan): one attribute check when disabled,
# constant-string args — the same cost discipline the registry keeps.
from orion_tpu_torch.analysis.sanitizer import TSAN

_ENABLE_VALUES = ("1", "on", "true", "yes")

#: Histogram shape: bucket ``i`` counts durations in ``[2**(i-1), 2**i)``
#: microseconds (bucket 0 is < 1 µs).  48 buckets reach ~1.6 days — far
#: past any single operation this framework times.  FIXED across versions:
#: merged snapshots sum buckets elementwise, so every writer must agree.
N_BUCKETS = 48

DEFAULT_SPAN_CAPACITY = 4096


# --- distributed trace context ----------------------------------------------
class TraceContext:
    """One hop of a distributed trace: ``trace_id`` names the end-to-end
    request (128-bit hex), ``span_id`` the CURRENT span within it (64-bit
    hex), ``sampled`` whether downstream hops should record at all.

    Immutable by convention: crossing into a new span mints a :meth:`child`
    (same trace, fresh span id) rather than mutating in place, so a context
    captured into a wire payload or a buffered span entry stays valid."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id=None, span_id=None, sampled=True):
        self.trace_id = trace_id or os.urandom(16).hex()
        self.span_id = span_id or os.urandom(8).hex()
        self.sampled = bool(sampled)

    def child(self):
        """Same trace, fresh span id — the context a nested span runs as."""
        return TraceContext(self.trace_id, os.urandom(8).hex(), self.sampled)

    def to_wire(self):
        """The optional ``ctx`` field of a wire envelope.  Peers that
        predate distributed tracing ignore unknown top-level keys, so
        injecting this is compatible in both directions."""
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "sampled": self.sampled,
        }

    @staticmethod
    def from_wire(payload):
        """Adopt a wire ``ctx`` field; tolerant — anything malformed (or
        absent) yields None so a hostile/buggy peer can never break the
        server's dispatch path."""
        if not isinstance(payload, dict):
            return None
        trace_id = payload.get("trace_id")
        span_id = payload.get("span_id")
        if not isinstance(trace_id, str) or not isinstance(span_id, str):
            return None
        return TraceContext(trace_id, span_id, bool(payload.get("sampled", True)))


_AMBIENT = threading.local()


def current_trace_context():
    """This thread's ambient :class:`TraceContext`, or None."""
    return getattr(_AMBIENT, "ctx", None)


def set_trace_context(ctx):
    """Install ``ctx`` (or None) as the ambient context; returns the
    previous one so callers can restore it."""
    prev = getattr(_AMBIENT, "ctx", None)
    _AMBIENT.ctx = ctx
    return prev


class trace_scope:
    """``with trace_scope(ctx):`` — adopt an explicit context (e.g. one
    decoded off the wire) for a block, restoring the previous ambient on
    exit.  ``ctx=None`` is a no-op scope."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx):
        self._ctx = ctx
        self._prev = None

    def __enter__(self):
        if self._ctx is not None:
            self._prev = set_trace_context(self._ctx)
        return self._ctx

    def __exit__(self, exc_type, exc, tb):
        if self._ctx is not None:
            set_trace_context(self._prev)
        return False


def _bucket_of(seconds):
    """Index of the log2-µs bucket holding ``seconds``."""
    micros = int(seconds * 1e6)
    if micros <= 0:
        return 0
    return min(micros.bit_length(), N_BUCKETS - 1)


def bucket_upper_seconds(index):
    """Upper bound (seconds) of bucket ``index`` — what percentile queries
    report (conservative: the true sample is at most this)."""
    return float(2**index) / 1e6


class _NullSpan:
    """The disabled-path span: ONE shared instance, allocation-free."""

    __slots__ = ()

    #: Same surface as _Span: a caller that checked ``enabled`` and then
    #: raced a concurrent disable() gets this singleton from span() — its
    #: ``.ctx`` read must degrade to "untraced", never AttributeError.
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """An enabled span: records itself into the registry on exit.

    Trace threading: a ``root=True`` span mints a FRESH :class:`TraceContext`
    (a new distributed trace — the producer round); otherwise, when an
    ambient sampled context exists, the span runs as its child and installs
    itself as the ambient for the body, so nested spans (and wire
    injections inside the body) parent here."""

    __slots__ = ("_telemetry", "name", "args", "_t0", "_root", "_ctx", "_prev")

    def __init__(self, telemetry, name, args, root=False):
        self._telemetry = telemetry
        self.name = name
        self.args = args
        self._root = root
        self._t0 = None
        self._ctx = None
        self._prev = None

    @property
    def ctx(self):
        """This span's own :class:`TraceContext` (None when untraced)."""
        return self._ctx

    def __enter__(self):
        self._t0 = time.perf_counter()
        prev = current_trace_context()
        if self._root:
            self._ctx = TraceContext()
        elif prev is not None and prev.sampled:
            self._ctx = prev.child()
        if self._ctx is not None:
            self._prev = set_trace_context(self._ctx)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._ctx is not None:
            set_trace_context(self._prev)
        self._telemetry.record_span(
            self.name,
            start=self._t0,
            args=self.args,
            span_ctx=self._ctx,
            # A root span STARTS its trace: the enclosing ambient (an
            # embedder's unrelated trace) must not become its parent, or
            # the record's parent_span_id points into a foreign trace and
            # attribution finds no root.
            parent_ctx=None if self._root else self._prev,
        )
        return False


class Telemetry:
    """Process-wide counters/gauges/histograms + span ring buffer.

    Thread-safe: one registry lock guards every mutation.  Recording rates
    are per-operation (a handful per producer round), so lock contention is
    not a concern — the DISABLED path is the one that must stay free, and
    it never touches the lock.
    """

    def __init__(self, enabled=None, span_capacity=None):
        if enabled is None:
            enabled = (
                os.environ.get("ORION_TPU_TELEMETRY", "").strip().lower()
                in _ENABLE_VALUES
            )
        if span_capacity is None:
            try:
                span_capacity = int(
                    os.environ.get("ORION_TPU_TELEMETRY_SPANS", "")
                    or DEFAULT_SPAN_CAPACITY
                )
            except ValueError:
                span_capacity = DEFAULT_SPAN_CAPACITY
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        # name -> [buckets list, count, sum, min, max]
        self._histograms = {}
        # name -> list of (weakref, attr): external monotonic counters
        # (SQLiteDB.txn_count) sampled at
        # snapshot time — zero hot-path cost for the owning backend.
        self._external = {}
        # Preallocated span ring: slot i%capacity holds span seq i.
        self._capacity = max(int(span_capacity), 8)
        self._ring = [None] * self._capacity
        self._seq = 0
        self._drained = 0
        # Wall anchor: ts_wall = _anchor + perf_counter reading.  Spans use
        # the monotonic clock for start/duration; the anchor puts every
        # process on one comparable wall timeline at export/merge time.
        self._anchor = time.time() - time.perf_counter()

    # --- toggling -----------------------------------------------------------
    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    # --- metrics ------------------------------------------------------------
    def count(self, name, n=1):
        """Increment counter ``name`` by ``n``."""
        if not self.enabled:
            return
        with self._lock:
            TSAN.write("Telemetry._metrics", self)
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def counter_value(self, name, default=0):
        """Current value of counter ``name`` (``default`` when never
        incremented).  Reader for in-process assertions (the tests check
        counter deltas through this)."""
        with self._lock:
            TSAN.read("Telemetry._metrics", self)
            return self._counters.get(name, default)

    def set_gauge(self, name, value):
        """Set gauge ``name`` to ``value`` (last write wins)."""
        if not self.enabled:
            return
        with self._lock:
            TSAN.write("Telemetry._metrics", self)
            self._gauges[name] = float(value)

    def gauge_value(self, name, default=None):
        """Current value of gauge ``name`` (``default`` when never set).
        In-process reader, companion to :meth:`counter_value` — the
        producer stamps the device-memory gauge into each round's health
        record through this, so the doctor's trend rules get a stored
        time series out of a last-write-wins gauge."""
        with self._lock:
            TSAN.read("Telemetry._metrics", self)
            return self._gauges.get(name, default)

    def observe(self, name, seconds):
        """Record one duration sample into histogram ``name``."""
        if not self.enabled:
            return
        seconds = float(seconds)
        with self._lock:
            self._observe_locked(name, seconds)

    def _observe_locked(self, name, seconds):
        """THE histogram update — callers hold the registry lock.  Shared
        by observe() and record_span() so the two sample sources can never
        drift apart."""
        TSAN.write("Telemetry._metrics", self)
        hist = self._histograms.get(name)
        if hist is None:
            hist = [[0] * N_BUCKETS, 0, 0.0, seconds, seconds]
            self._histograms[name] = hist
        hist[0][_bucket_of(seconds)] += 1
        hist[1] += 1
        hist[2] += seconds
        hist[3] = min(hist[3], seconds)
        hist[4] = max(hist[4], seconds)

    def register_external_counter(self, name, obj, attr):
        """Expose ``obj.attr`` (a monotonic int the owner already maintains,
        e.g. ``SQLiteDB.txn_count``) as counter ``name``.  Sampled lazily at
        snapshot time; held by weakref so registration never extends the
        owner's lifetime.  Multiple registrations under one name sum —
        but re-registering the SAME object+attr is a no-op, so callers
        that re-run their registration loop don't double-count."""
        try:
            ref = weakref.ref(obj)
        except TypeError:  # pragma: no cover - exotic objects without weakref
            return
        with self._lock:
            TSAN.write("Telemetry._metrics", self)
            entries = self._external.setdefault(name, [])
            for existing_ref, existing_attr in entries:
                if existing_ref() is obj and existing_attr == attr:
                    return
            entries.append((ref, attr))

    def unregister_external_counter(self, name, obj):
        """Drop ``obj``'s registration under ``name`` (other objects'
        registrations under the same name stay): for an owner whose
        counters move to a new name and must stop exporting under the old
        one."""
        with self._lock:
            TSAN.write("Telemetry._metrics", self)
            entries = self._external.get(name)
            if not entries:
                return
            kept = [e for e in entries if e[0]() is not obj]
            if kept:
                self._external[name] = kept
            else:
                self._external.pop(name, None)

    def _external_counts(self):
        out = {}
        with self._lock:
            TSAN.write("Telemetry._metrics", self)  # prunes dead registrations
            for name, entries in list(self._external.items()):
                live = [(ref, attr) for ref, attr in entries if ref() is not None]
                if not live:
                    del self._external[name]
                    continue
                self._external[name] = live
                total = 0
                for ref, attr in live:
                    owner = ref()
                    if owner is not None:
                        try:
                            total += int(getattr(owner, attr, 0))
                        except Exception:  # pragma: no cover - hostile attr
                            pass
                out[name] = total
        return out

    # --- spans --------------------------------------------------------------
    def span(self, name, args=None, root=False):
        """Context manager timing a block.  Disabled: the shared no-op
        singleton (no allocation, no clock read).  Enabled: records a span
        AND a duration sample into the histogram of the same name.
        ``root=True`` starts a NEW distributed trace for the body (the
        producer-round entry point); otherwise the span becomes a child of
        any ambient :class:`TraceContext`."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args, root=root)

    def record_span(
        self,
        name,
        start=None,
        duration=None,
        args=None,
        histogram=True,
        span_ctx=None,
        parent_ctx=None,
        links=None,
        track=None,
    ):
        """Record one finished span explicitly.

        ``start``/``duration`` are ``time.perf_counter()`` readings/deltas;
        give either or both (a missing start is back-computed from now, a
        missing duration runs to now).  Callers that already measured a
        phase (the producer's ``_record_timing``) route through here so the
        span and its histogram sample come from the same clock reading.
        ``histogram=False`` records the span only — for call sites that
        feed a differently-keyed histogram themselves (the storage layer's
        per-backend op histograms) and must not double-book the sample.

        Trace stamping: ``span_ctx`` is this span's OWN identity (its
        ``span_id``), ``parent_ctx`` its parent; pass only ``parent_ctx``
        (the adopting-server case — a context decoded off the wire) and a
        fresh ``span_id`` is minted.  With neither, the thread's ambient
        context (if sampled) parents the record.  ``links`` is a list of
        contexts/{trace_id, span_id} dicts joined non-hierarchically (the
        gateway's coalesced dispatch links every stacked tenant's request
        context).  ``track`` overrides the record's worker/track label so
        in-process servers (gateway, loopback netdb) render as their own
        Perfetto track."""
        if not self.enabled:
            return
        try:
            record, duration = self._build_span_record(
                name,
                start,
                duration,
                args,
                time.perf_counter(),
                span_ctx=span_ctx,
                parent_ctx=parent_ctx,
                links=links,
                track=track,
            )
            with self._lock:
                TSAN.write("Telemetry._ring", self)
                self._ring[self._seq % self._capacity] = record
                self._seq += 1
                if histogram:
                    self._observe_locked(name, duration)
        except Exception:  # pragma: no cover - must never raise into hot path
            pass

    def _build_span_record(
        self,
        name,
        start,
        duration,
        args,
        now,
        span_ctx=None,
        parent_ctx=None,
        links=None,
        track=None,
    ):
        """THE span-record factory — shared by :meth:`record_span` and
        :meth:`record_spans_batch` so the None-start back-computation and
        the record schema cannot drift between the per-call and batched
        paths.  Returns ``(record, duration_seconds)``."""
        if start is None:
            duration = float(duration or 0.0)
            start = now - duration
        elif duration is None:
            duration = now - start
        record = {
            "name": name,
            "ts": self._anchor + start,
            "dur": float(duration),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if args:
            # Clamp long string values (compiler-plane signatures are the
            # worst case: every static of a plan on one line) — the ring
            # holds a bounded record count, not bounded bytes, and a
            # pathological arg would bloat every export of the window.
            record["args"] = {
                k: (v[:253] + "..." if isinstance(v, str) and len(v) > 256 else v)
                for k, v in args.items()
            }
        if span_ctx is None and parent_ctx is None:
            ambient = current_trace_context()
            if ambient is not None and ambient.sampled:
                parent_ctx = ambient
        if span_ctx is not None:
            record["trace_id"] = span_ctx.trace_id
            record["span_id"] = span_ctx.span_id
            if parent_ctx is not None:
                record["parent_span_id"] = parent_ctx.span_id
        elif parent_ctx is not None and parent_ctx.sampled:
            record["trace_id"] = parent_ctx.trace_id
            record["span_id"] = os.urandom(8).hex()
            record["parent_span_id"] = parent_ctx.span_id
        if links:
            record["links"] = [
                {"trace_id": link.trace_id, "span_id": link.span_id}
                if isinstance(link, TraceContext)
                else dict(link)
                for link in links
            ]
        if track is not None:
            record["worker"] = track
        return record, float(duration)

    def record_spans_batch(self, entries):
        """Record many finished spans under ONE lock acquisition.

        ``entries`` is ``[(name, start, duration, args), ...]`` with the
        same semantics as :meth:`record_span` (``start`` a perf_counter
        reading; a None start is back-computed from ``duration`` against
        the batch's shared "now").  An optional fifth element carries the
        :class:`TraceContext` that was ambient when the sample was taken
        (``parent_ctx`` semantics — buffering must not re-read the ambient
        at flush time, which may belong to a later round).  The producer
        buffers its per-sample spans across a round and flushes them here —
        per-sample ``record_span`` calls each paid a lock round-trip and a
        clock read inside the hot loop."""
        if not self.enabled or not entries:
            return
        try:
            now = time.perf_counter()
            records = [
                (entry[0],)
                + self._build_span_record(
                    entry[0],
                    entry[1],
                    entry[2],
                    entry[3],
                    now,
                    parent_ctx=entry[4] if len(entry) > 4 else None,
                )
                for entry in entries
            ]
            with self._lock:
                TSAN.write("Telemetry._ring", self)
                for name, record, duration in records:
                    self._ring[self._seq % self._capacity] = record
                    self._seq += 1
                    self._observe_locked(name, duration)
        except Exception:  # pragma: no cover - must never raise into hot path
            pass

    def iter_spans(self):
        """Every span currently in the ring, oldest first (wraparound has
        dropped anything older than ``capacity`` records)."""
        with self._lock:
            TSAN.read("Telemetry._ring", self)
            start = max(0, self._seq - self._capacity)
            return [self._ring[i % self._capacity] for i in range(start, self._seq)]

    def drain_spans(self):
        """Spans recorded since the last drain (each span is returned
        exactly once — the worker flush channel).  Wraparound between
        drains loses the overwritten oldest records, by design."""
        with self._lock:
            TSAN.write("Telemetry._ring", self)  # advances the drain cursor
            start = max(self._drained, self._seq - self._capacity)
            out = [self._ring[i % self._capacity] for i in range(start, self._seq)]
            self._drained = self._seq
            return out

    # --- snapshots / merging ------------------------------------------------
    def snapshot(self):
        """One mergeable metrics snapshot: counters (external ones sampled
        now), gauges, histograms.  This is the document a worker flushes
        through ``DocumentStorage.record_metrics`` every round."""
        external = self._external_counts()
        with self._lock:
            TSAN.read("Telemetry._metrics", self)
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = {
                name: {
                    "buckets": list(hist[0]),
                    "count": hist[1],
                    "sum": hist[2],
                    "min": hist[3],
                    "max": hist[4],
                }
                for name, hist in self._histograms.items()
            }
        for name, value in external.items():
            counters[name] = counters.get(name, 0) + value
        return {"counters": counters, "gauges": gauges, "histograms": histograms}

    def reset(self):
        """Drop every metric and span, INCLUDING external-counter
        registrations (test/bench isolation: a still-alive backend's
        monotonic txn/wire totals must not bleed into a fresh measurement;
        a backend created after the reset re-registers on construction)."""
        with self._lock:
            TSAN.write("Telemetry._metrics", self)
            TSAN.write("Telemetry._ring", self)
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._external.clear()
            self._ring = [None] * self._capacity
            self._seq = 0
            self._drained = 0

    # --- exporters ----------------------------------------------------------
    def export_jsonl(self, path):
        """One JSON object per line: every span in the ring, then one
        ``{"type": "metrics", ...}`` snapshot line."""
        spans = self.iter_spans()
        with open(path, "w") as handle:
            for span in spans:
                handle.write(json.dumps({"type": "span", **span}) + "\n")
            handle.write(json.dumps({"type": "metrics", **self.snapshot()}) + "\n")
        return path

    def export_chrome_trace(self, path):
        """Chrome trace-event JSON of the ring (loads in Perfetto)."""
        return write_chrome_trace(path, self.iter_spans())


def histogram_percentile(hist, p):
    """Nearest-rank percentile (seconds) from a snapshot histogram dict —
    the upper bound of the bucket holding the rank, so the report is
    conservative within one 2x bucket."""
    count = int(hist.get("count", 0))
    if count <= 0:
        return 0.0
    rank = max(1, -(-int(p * count) // 100))  # ceil(p/100 * count)
    seen = 0
    for index, n in enumerate(hist.get("buckets", ())):
        seen += n
        if seen >= rank:
            return min(bucket_upper_seconds(index), float(hist.get("max", 0.0)))
    return float(hist.get("max", 0.0))


def merge_snapshots(snapshots):
    """Aggregate worker snapshot docs into one: counters and histogram
    buckets SUM (they are per-worker monotonic totals); gauges merge by
    MAX — they are risk signals (heartbeat lag), and the worker whose
    gauge matters is exactly the stalled one that stopped flushing, so
    freshest-write-wins would mask it behind a healthy worker's ~0.
    Accepts raw ``snapshot()`` dicts or storage docs carrying extra keys
    (``experiment``/``worker``/``time``)."""
    counters = {}
    gauges = {}
    histograms = {}
    for doc in snapshots:
        for name, value in (doc.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + int(value)
        for name, value in (doc.get("gauges") or {}).items():
            value = float(value)
            gauges[name] = max(gauges[name], value) if name in gauges else value
        for name, hist in (doc.get("histograms") or {}).items():
            merged = histograms.get(name)
            if merged is None:
                histograms[name] = {
                    "buckets": list(hist.get("buckets") or [0] * N_BUCKETS),
                    "count": int(hist.get("count", 0)),
                    "sum": float(hist.get("sum", 0.0)),
                    "min": float(hist.get("min", 0.0)),
                    "max": float(hist.get("max", 0.0)),
                }
                continue
            buckets = hist.get("buckets") or ()
            for index, n in enumerate(buckets):
                if index < len(merged["buckets"]):
                    merged["buckets"][index] += n
            merged["count"] += int(hist.get("count", 0))
            merged["sum"] += float(hist.get("sum", 0.0))
            merged["min"] = min(merged["min"], float(hist.get("min", 0.0)))
            merged["max"] = max(merged["max"], float(hist.get("max", 0.0)))
    return {"counters": counters, "gauges": gauges, "histograms": histograms}


def chrome_trace_events(spans):
    """Span records -> Chrome trace-event dicts (complete 'X' events, µs).

    Spans may come from one process's ring or from the storage channel
    (several workers).  Tracks are keyed by the WORKER identity (host:pid
    when present — a bare OS pid collides across hosts, e.g. two
    containerized workers both running as pid 1), mapped to synthetic
    sequential pids; each track gets a process_name metadata event so
    Perfetto labels the rows.

    Distributed-trace records additionally produce Perfetto FLOW events
    (``s`` start / ``f`` finish pairs, bound by ``id``): one arrow per
    cross-track parent→child edge (a client span whose ``span_id`` a
    server span names as ``parent_span_id``), and one per recorded link
    (the gateway's coalesced dispatch → every stacked tenant's request
    context).  Each flow carries its ``trace_id`` in ``args`` so arrows
    can be grepped back to the request they belong to."""
    events = []
    tracks = {}  # worker label -> synthetic pid
    by_span_id = {}  # span_id -> its X event (for flow binding)
    traced = []  # (span record, X event) pairs carrying trace fields
    for span in spans:
        if not span:
            continue
        label = str(span.get("worker") or f"orion-tpu:{span.get('pid', 0)}")
        if label not in tracks:
            tracks[label] = len(tracks) + 1
        event = {
            "name": str(span.get("name", "?")),
            "cat": str(span.get("name", "?")).split(".", 1)[0],
            "ph": "X",
            "ts": float(span.get("ts", 0.0)) * 1e6,
            "dur": float(span.get("dur", 0.0)) * 1e6,
            "pid": tracks[label],
            "tid": int(span.get("tid", 0)),
        }
        args = span.get("args")
        if args:
            event["args"] = dict(args)
        trace_id = span.get("trace_id")
        if trace_id:
            event.setdefault("args", {})["trace_id"] = trace_id
        events.append(event)
        span_id = span.get("span_id")
        if span_id:
            by_span_id[span_id] = event
        if (trace_id and span.get("parent_span_id")) or span.get("links"):
            traced.append((span, event))
    flow_seq = 0
    for span, event in traced:
        sources = []  # (source event, trace_id the arrow belongs to)
        parent = by_span_id.get(span.get("parent_span_id"))
        # Parent arrows only across tracks: intra-track nesting is already
        # visible as slice containment, and drawing it would bury the
        # cross-process arrows the merge exists to show.
        if parent is not None and parent["pid"] != event["pid"]:
            sources.append((parent, span.get("trace_id")))
        for link in span.get("links") or ():
            target = by_span_id.get((link or {}).get("span_id"))
            if target is not None and target is not parent:
                sources.append((target, (link or {}).get("trace_id")))
        for source, flow_trace in sources:
            flow_seq += 1
            flow = {
                "name": "trace",
                "cat": "flow",
                "id": flow_seq,
                "args": {"trace_id": flow_trace},
            }
            events.append(
                {
                    **flow,
                    "ph": "s",
                    "ts": source["ts"],
                    "pid": source["pid"],
                    "tid": source["tid"],
                }
            )
            events.append(
                {
                    **flow,
                    "ph": "f",
                    "bp": "e",
                    "ts": event["ts"],
                    "pid": event["pid"],
                    "tid": event["tid"],
                }
            )
    for label, pid in tracks.items():
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": label},
            }
        )
    return events


def write_chrome_trace(path, spans):
    """Write ``spans`` as a Chrome trace-event JSON file (Perfetto-ready)."""
    payload = {
        "traceEvents": chrome_trace_events(spans),
        "displayTimeUnit": "ms",
    }
    with open(path, "w") as handle:
        json.dump(payload, handle)
    return path


#: THE process-wide registry every subsystem records into.  Enabled state
#: comes from ORION_TPU_TELEMETRY at import; the CLI layers the
#: ``telemetry:`` config key on top (cli/base.py).
TELEMETRY = Telemetry()
