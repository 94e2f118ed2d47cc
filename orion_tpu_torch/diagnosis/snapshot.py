"""The joined telemetry view the doctor rules evaluate (port of
``orion_tpu/diagnosis/snapshot.py``).

One :class:`Snapshot` merges every signal plane the stack already emits:

- the MERGED cross-worker metrics snapshot (counters/gauges/histograms,
  ``telemetry.merge_snapshots`` semantics) plus the raw per-worker docs
  (their flush timestamps are the staleness signal);
- the per-round health-record time series (``fetch_health`` order) — the
  ONLY stored series, so every trend rule (regret stagnation, memory
  growth, EI flatline) reads it;
- recent flight events (the ``flight.*`` mirror in the spans channel);
- the sharded control plane's replication probe (``replication_health()``)
  and, in watch mode, the accumulated probe SERIES — lag growth needs
  more than one point, and the lag gauges are last-write-wins.

Rules never reach around the snapshot to storage: a snapshot can be built
from storage (:func:`collect_snapshot`), from the in-process registry
alone (:func:`local_snapshot` — the worker ``/healthz`` path), or
literally in a test fixture — which is what makes every rule pinnable by a
seeded-pathology snapshot.
"""

import time

#: A worker whose last metrics/health flush is older than this is stale:
#: 3x the producer's snapshot-upsert interval (``Producer
#: .METRICS_FLUSH_INTERVAL`` = 2s) — kept as a literal here so building a
#: snapshot never imports the producer (and torch underneath it); the
#: cli/top dashboard derives its marker from the same product.
STALE_AFTER_DEFAULT = 6.0

_EMPTY_HIST = {"buckets": (), "count": 0, "sum": 0.0, "min": 0.0, "max": 0.0}


class Snapshot:
    """One joined, immutable-by-convention view for a diagnosis pass."""

    def __init__(
        self,
        metrics=None,
        per_worker=None,
        health=None,
        flight=None,
        replication=None,
        replication_series=None,
        heartbeat=None,
        stale_after=None,
        now=None,
    ):
        self.metrics = metrics or {"counters": {}, "gauges": {}, "histograms": {}}
        self.per_worker = list(per_worker or ())
        self.health = list(health or ())
        self.flight = list(flight or ())
        self.replication = replication
        # Watch mode appends each frame's probe; a one-shot sees a
        # single-point series (trend rules then stay quiet by design).
        if replication_series is not None:
            self.replication_series = list(replication_series)
        else:
            self.replication_series = [replication] if replication else []
        self.heartbeat = heartbeat
        self.stale_after = (
            float(stale_after) if stale_after is not None else STALE_AFTER_DEFAULT
        )
        self.now = time.time() if now is None else float(now)

    # --- metrics accessors ---------------------------------------------------
    def counter(self, name, default=0):
        return int((self.metrics.get("counters") or {}).get(name, default))

    def counter_sum(self, *needles):
        """Sum every counter whose name contains one of ``needles`` (the
        reconnects counters are per-backend-prefixed, same join the top
        dashboard performs)."""
        total = 0
        for name, value in (self.metrics.get("counters") or {}).items():
            if any(needle in name for needle in needles):
                total += int(value)
        return total

    def gauge(self, name, default=None):
        value = (self.metrics.get("gauges") or {}).get(name)
        return default if value is None else float(value)

    def histogram(self, name):
        return (self.metrics.get("histograms") or {}).get(name) or _EMPTY_HIST

    def histogram_mean(self, name):
        """Mean seconds of one histogram, or None when it has no samples."""
        hist = self.histogram(name)
        count = int(hist.get("count", 0))
        if count <= 0:
            return None
        return float(hist.get("sum", 0.0)) / count

    def rounds(self):
        """Producer rounds covered by this snapshot: the ``producer.round``
        histogram count when the metrics plane saw any, else the length of
        the health series (snapshots built from records alone)."""
        count = int(self.histogram("producer.round").get("count", 0))
        return count if count else len(self.health)

    # --- health-series accessors ---------------------------------------------
    def series(self, field, last=None):
        """The health-record time series of one field, records missing it
        dropped; ``last`` keeps only the trailing window."""
        values = [
            record.get(field)
            for record in self.health
            if record.get(field) is not None
        ]
        if last is not None:
            values = values[-int(last):]
        return values

    def latest_health(self):
        return self.health[-1] if self.health else None

    # --- staleness -----------------------------------------------------------
    def worker_ages(self):
        """worker -> seconds since its freshest metrics/health flush (the
        same min-of-channels age the top dashboard marks STALE)."""
        freshest = {}
        for doc in self.per_worker:
            worker = str(doc.get("worker") or "?")
            stamp = float(doc.get("time") or 0.0)
            freshest[worker] = max(freshest.get(worker, 0.0), stamp)
        for record in self.health:
            worker = str(record.get("worker") or "?")
            stamp = float(record.get("time") or 0.0)
            freshest[worker] = max(freshest.get(worker, 0.0), stamp)
        return {
            worker: max(0.0, self.now - stamp)
            for worker, stamp in freshest.items()
            if stamp > 0.0
        }


def collect_snapshot(experiment, now=None, replication_series=None):
    """Build a :class:`Snapshot` from an experiment's storage channels —
    the ``orion-tpu-torch doctor`` / watchdog path.  ``replication_series`` lets
    watch mode thread its accumulated probe history back in (the fresh
    probe taken here is appended to it)."""
    from orion_tpu_torch.health import spans_as_flight_events

    storage = experiment.storage
    metrics_docs = storage.fetch_metrics(experiment)
    health_docs = storage.fetch_health(experiment)
    try:
        flight = spans_as_flight_events(storage.fetch_spans(experiment))
    except Exception:  # pragma: no cover - channel optional on 3rd-party stores
        flight = []
    replication = probe_replication(storage)
    series = list(replication_series or ())
    if replication:
        series.append(replication)
    stale_after = None
    try:
        from orion_tpu_torch.core.producer import Producer

        stale_after = 3.0 * Producer.METRICS_FLUSH_INTERVAL
    except Exception:  # pragma: no cover - keep the doctor importable alone
        pass
    return Snapshot(
        metrics=_merge(metrics_docs),
        per_worker=metrics_docs,
        health=health_docs,
        flight=flight,
        replication=replication,
        replication_series=series or None,
        heartbeat=getattr(experiment, "heartbeat", None),
        stale_after=stale_after,
        now=now,
    )


def probe_replication(storage):
    """The sharded router's ``replication_health()`` probe, or None when
    the storage is not the consistent-hash control plane (or the probe
    fails — a diagnosis pass must never die on a dark fleet)."""
    db = getattr(storage, "_db", None)
    replication_health = getattr(db, "replication_health", None)
    if replication_health is None:
        return None
    try:
        return replication_health()
    except Exception:  # pragma: no cover - a dead fleet still diagnoses
        return None


def local_snapshot(health=None, now=None):
    """A snapshot of THIS process's registry alone — the worker ``/healthz``
    doctor block.  No storage round trips:
    counter/gauge/histogram rules see the live process, series rules see
    whatever ``health`` records the caller hands in (none by default)."""
    from orion_tpu_torch.telemetry import TELEMETRY

    return Snapshot(metrics=TELEMETRY.snapshot(), health=health, now=now)


def _merge(metrics_docs):
    from orion_tpu_torch.telemetry import merge_snapshots

    return merge_snapshots(metrics_docs)
