"""Publishing and watching: findings -> alerts, gauges, /healthz, workon
(port of ``orion_tpu/diagnosis/watch.py``).

Four consumers share one publishing path (:func:`publish_report`):

- the ``orion-tpu-torch doctor --watch`` loop (new findings become
  ``flight.alert`` events written straight into the experiment's spans
  channel, deduplicated so a persistent condition alerts once and
  re-alerts only after it clears);
- the in-process watchdog ``workon`` starts when ``doctor_interval:`` /
  ``ORION_TPU_DOCTOR_INTERVAL`` is set (same dedup, alerts ride the
  process FLIGHT ring and reach storage through the producer's ordinary
  mirror flush);
- the /metrics plane: every registered rule's finding count is published
  as its ``doctor.findings.<ID>`` gauge (zeros included, so a resolved
  finding CLEARS its gauge — exported as the
  ``orion_tpu_doctor_findings{rule,severity}`` family);
- ``/healthz``: the most recent report's summary is held in a process-wide
  slot (:func:`doctor_summary`) so the worker metrics server answers
  probes from diagnosis, not bare process liveness.

Cost discipline matches the rest of the observability layer: alert
emission guards its allocating args on ``FLIGHT.enabled``, gauge names are
precomputed per rule class, and the last-report slot is one tsan-annotated
cell behind its own registered lock.  A pass never synchronises the
device: it reads storage channels and the process registry (counters,
gauges, the allocator statistics ``devmem`` already sampled), never a
tensor — a read on the watchdog's thread would stall the round being
captured or replayed, and fail a capture outright.
"""

import logging
import threading
import time

from orion_tpu_torch.analysis.sanitizer import TSAN
from orion_tpu_torch.diagnosis.engine import run_rules
from orion_tpu_torch.diagnosis.snapshot import collect_snapshot, local_snapshot
from orion_tpu_torch.health import FLIGHT
from orion_tpu_torch.telemetry import TELEMETRY

log = logging.getLogger(__name__)

#: Most recent published report summary (the /healthz doctor block),
#: stored WITH its publish timestamp: a watchdog whose passes started
#: failing (storage outage) stops publishing, and /healthz must not keep
#: answering the pre-outage verdict forever.
_last_lock = threading.Lock()
_last_summary = None
_last_published = 0.0

#: A published summary older than this is stale: fall back to a fresh
#: local-registry pass (or "unknown") instead of serving a fossil.
SUMMARY_TTL_S = 120.0


class AlertDeduper:
    """Watch-mode alert dedup: a finding alerts when it APPEARS, stays
    silent while it persists, and re-alerts if it clears and comes back.
    Keyed by each finding's ``fingerprint`` — (rule id, subject), NEVER
    the message: messages embed live counter/trend values that change
    every pass while the condition persists, and keying on them would
    re-alert the same retry spike every interval forever."""

    def __init__(self):
        self._active = set()

    def new_findings(self, findings):
        current = {f.fingerprint: f for f in findings}
        fresh = [
            finding
            for key, finding in current.items()
            if key not in self._active
        ]
        self._active = set(current)
        return fresh


def publish_report(report, new_findings=None, storage=None, experiment=None):
    """Publish one diagnosis report: gauges for every rule (zeros clear),
    the /healthz summary slot, and — for ``new_findings`` (the deduper's
    output; None publishes none) — ``flight.alert`` events into the
    process FLIGHT ring and, when ``storage``/``experiment`` are given
    (the CLI watch path, which has no producer to mirror its ring), the
    same events written directly into the spans channel."""
    global _last_summary, _last_published
    if TELEMETRY.enabled:
        for rule_id, count in report.rule_counts.items():
            name = report.gauge_names.get(rule_id)
            if name is not None:
                TELEMETRY.set_gauge(name, count)
    with _last_lock:
        TSAN.write("diagnosis._last_summary")
        _last_summary = report.summary()
        _last_published = time.time()
    events = findings_as_events(new_findings or ())
    if FLIGHT.enabled:
        for event in events:
            FLIGHT.record("alert", args=event["args"])
    if events and storage is not None and experiment is not None:
        from orion_tpu_torch.health import flight_events_as_spans

        try:
            storage.record_spans(experiment, flight_events_as_spans(events))
        except Exception:  # pragma: no cover - alerts must not kill the watch
            log.debug("could not record doctor alerts", exc_info=True)


def findings_as_events(findings):
    """Findings -> flight-recorder event dicts (``kind: alert``) — the
    shape ``flight_events_as_spans`` mirrors into the spans channel as
    ``flight.alert`` records."""
    import os

    now = time.time()
    pid = os.getpid()
    return [
        {
            "kind": "alert",
            "ts": now,
            "pid": pid,
            "args": {
                "rule": finding.rule_id,
                "severity": finding.severity,
                "message": finding.message,
            },
        }
        for finding in findings
    ]


def doctor_summary(evaluate_local=True):
    """The /healthz doctor block: the last published report's summary
    (stamped with its age) while it is FRESH, or — with ``evaluate_local``
    — a fresh pass over this process's own registry (counters/gauges
    rules only; there is no health series locally).  A published summary
    past :data:`SUMMARY_TTL_S` is a fossil — the watchdog that minted it
    stopped publishing (its passes are failing, or it is gone) — so it is
    NOT served as current truth.  Never raises: probes must get an
    answer."""
    now = time.time()
    with _last_lock:
        TSAN.read("diagnosis._last_summary")
        summary = _last_summary
        age = now - _last_published
    if summary is not None and age <= SUMMARY_TTL_S:
        return {**summary, "age_s": round(age, 1)}
    if not evaluate_local:
        if summary is not None:
            # Too old to trust, too informative to hide: degrade the
            # status to unknown but keep the counts + age for the prober.
            return {**summary, "status": "unknown", "age_s": round(age, 1)}
        return {"status": "unknown", "critical": 0, "warn": 0, "info": 0}
    try:
        return run_rules(local_snapshot()).summary()
    except Exception:  # pragma: no cover - a probe must get an answer
        return {"status": "unknown", "critical": 0, "warn": 0, "info": 0}


def _reset_last_summary():
    """Test isolation hook: forget the published slot."""
    global _last_summary, _last_published
    with _last_lock:
        TSAN.write("diagnosis._last_summary")
        _last_summary = None
        _last_published = 0.0


class DoctorWatchdog:
    """The in-process watchdog ``workon`` runs next to the worker loop:
    every ``interval`` seconds, join the experiment's channels into a
    snapshot, evaluate the rule catalog, and publish (gauges + deduped
    ``flight.alert`` events that reach storage through the producer's
    ordinary flight mirror).  Daemon thread; a diagnosis failure is logged
    and the loop continues — observability must never kill a worker."""

    def __init__(self, experiment, interval):
        self.experiment = experiment
        self.interval = max(float(interval), 1.0)
        self._stop = threading.Event()
        self._thread = None
        self._deduper = AlertDeduper()
        #: Accumulated replication probes so the lag-GROWTH trend rule has
        #: a series to work with (bounded window).
        self._replication_series = []

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="orion-tpu-torch-doctor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def tick(self):
        """One diagnosis pass (also the unit-test entry point)."""
        snapshot = collect_snapshot(
            self.experiment, replication_series=self._replication_series
        )
        if snapshot.replication:
            self._replication_series.append(snapshot.replication)
            del self._replication_series[:-32]
        report = run_rules(snapshot)
        publish_report(report, new_findings=self._deduper.new_findings(report.findings))
        return report

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:  # pragma: no cover - watchdog never kills workon
                log.debug("doctor watchdog pass failed", exc_info=True)


def maybe_start_watchdog(experiment):
    """Start the workon watchdog when ``ORION_TPU_DOCTOR_INTERVAL`` asks
    for one (the ``doctor_interval:`` config key resolves to the same env
    spelling in cli/base.py, so ``hunt --n-workers`` children inherit it).
    Absent/invalid/non-positive means "not requested" -> None.  Failures
    are logged, never raised."""
    import os

    raw = os.environ.get("ORION_TPU_DOCTOR_INTERVAL", "").strip()
    if not raw:
        return None
    try:
        interval = float(raw)
    except ValueError:
        log.warning("ignoring non-numeric ORION_TPU_DOCTOR_INTERVAL=%r", raw)
        return None
    if interval <= 0:
        return None
    try:
        watchdog = DoctorWatchdog(experiment, interval).start()
    except Exception:  # pragma: no cover - observability never kills workon
        log.warning("could not start doctor watchdog", exc_info=True)
        return None
    log.info("doctor watchdog running every %.1fs", interval)
    return watchdog
