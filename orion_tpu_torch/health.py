"""Optimization-health observability (port of ``orion_tpu/health.py``):
the layout of the packed per-round health vector, and the flight recorder.

- **Health records.**  The fused suggest step attaches a packed health
  vector to ``GPState.health``; ``unpack_device_health`` turns it into
  named fields (layout below) for the producer's per-round record.

  - ``gp_mll``: marginal log-likelihood per observation of the final fit;
  - ``gp_ls_min`` / ``gp_ls_mean`` / ``gp_ls_max``: fitted lengthscales
    over the free dims;
  - ``gp_noise``: fitted noise level;
  - ``acq_ei_max`` / ``acq_ei_mean``: expected improvement over the pool;
  - ``q_unique_frac``: fraction of distinct rows in the selected q-batch.

- **Flight recorder.**  A bounded ring of recent structured events (round
  boundaries, storage retries, trial status transitions) dumped as a JSONL
  artifact when it matters: on a worker crash, on an ``orion-tpu-torch
  audit`` failure, and on demand via ``orion-tpu-torch flight-record``.
  Producers also mirror drained events into the spans storage channel (as
  ``flight.*`` span records), so the CLI can reconstruct another process's
  recent history.  The dump's JSONL layout is the reference's line for
  line, so either package's ``flight-record`` reads the other's artifacts.
  Switched on by ``ORION_TPU_FLIGHT`` alone or ``ORION_TPU_TELEMETRY``
  (with the registry), ring size ``ORION_TPU_FLIGHT_EVENTS``.

Contract shared with the telemetry registry: emission must never raise
into a hot path, and the DISABLED path must not allocate — call sites
building args dicts guard on ``FLIGHT.enabled``.

Left out: the reference's dump header carries the doctor's last verdict
and its ring lock is annotated for the concurrency sanitizer; both belong
to ROADMAP queue A item 9.
"""

import json
import os
import threading
import time
import traceback

import numpy as np

_ENABLE_VALUES = ("1", "on", "true", "yes")

DEFAULT_FLIGHT_CAPACITY = 512

#: FIXED order — the vector is unpacked positionally.
DEVICE_HEALTH_FIELDS = (
    "gp_mll",
    "gp_ls_min",
    "gp_ls_mean",
    "gp_ls_max",
    "gp_noise",
    "acq_ei_max",
    "acq_ei_mean",
    "q_unique_frac",
)


def unpack_device_health(vec):
    """Packed ``(len(DEVICE_HEALTH_FIELDS),)`` vector (tensor or array) ->
    field dict.  Read it after the round's rows reached the host, so the
    values are ready and the copy does not wait on the device."""
    if hasattr(vec, "detach"):
        vec = vec.detach().cpu().numpy()
    values = np.asarray(vec, dtype=np.float64).ravel()
    if values.shape[0] < len(DEVICE_HEALTH_FIELDS):
        return {}
    return {name: float(values[i]) for i, name in enumerate(DEVICE_HEALTH_FIELDS)}


def _env_enabled():
    """Flight recording rides the observability toggle: ORION_TPU_FLIGHT
    enables it alone, ORION_TPU_TELEMETRY enables it together with the
    metrics/span registry (one switch for the whole observability layer)."""
    for var in ("ORION_TPU_FLIGHT", "ORION_TPU_TELEMETRY"):
        if os.environ.get(var, "").strip().lower() in _ENABLE_VALUES:
            return True
    return False


class FlightRecorder:
    """Bounded ring of recent structured events, dumpable as JSONL.

    Same cost discipline as the telemetry registry: ``record`` is one
    attribute check when disabled (no lock, no clock read, no allocation
    — provided the call site guards its args construction),
    and never raises into a hot path.  Thread-safe: one lock guards the
    ring.
    """

    def __init__(self, enabled=None, capacity=None):
        if enabled is None:
            enabled = _env_enabled()
        if capacity is None:
            try:
                capacity = int(
                    os.environ.get("ORION_TPU_FLIGHT_EVENTS", "")
                    or DEFAULT_FLIGHT_CAPACITY
                )
            except ValueError:
                capacity = DEFAULT_FLIGHT_CAPACITY
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._capacity = max(int(capacity), 8)
        self._ring = [None] * self._capacity
        self._seq = 0
        self._drained = 0

    # --- toggling -----------------------------------------------------------
    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    # --- recording ----------------------------------------------------------
    def record(self, kind, args=None):
        """Append one event ``{"kind", "ts", "pid", "args"?}`` to the ring.

        ``kind`` is a short dotted label (``"producer.round"``,
        ``"storage.retry"``, ``"trial.status"``); ``args`` an optional
        small dict of context.  Oldest events past capacity are dropped —
        a flight recorder keeps the *recent* past."""
        if not self.enabled:
            return
        try:
            event = {"kind": str(kind), "ts": time.time(), "pid": os.getpid()}
            if args:
                event["args"] = dict(args)
            with self._lock:
                self._ring[self._seq % self._capacity] = event
                self._seq += 1
        except Exception:  # pragma: no cover - must never raise into hot path
            pass

    def events(self):
        """Every event currently in the ring, oldest first."""
        with self._lock:
            start = max(0, self._seq - self._capacity)
            return [self._ring[i % self._capacity] for i in range(start, self._seq)]

    def drain(self):
        """Events recorded since the last drain, each returned exactly once
        (the producer's storage-mirror channel; wraparound between drains
        drops the overwritten oldest, by design)."""
        with self._lock:
            start = max(self._drained, self._seq - self._capacity)
            out = [self._ring[i % self._capacity] for i in range(start, self._seq)]
            self._drained = self._seq
            return out

    def clear(self):
        with self._lock:
            self._ring = [None] * self._capacity
            self._seq = 0
            self._drained = 0

    # --- dumping ------------------------------------------------------------
    def dump(self, path, reason="on-demand", extra_events=None):
        """Write the ring (oldest first) as a JSONL artifact.

        First line is a header record (``type: flight-record`` with the
        reason, host identity, and wall time); every following line is one
        event.  ``extra_events`` lets cold-path callers (the audit CLI's
        violation dump, the crash handler's traceback) append context that
        never went through the hot-path ring.  Returns ``path``.  Dumping
        is deliberately NOT gated on ``enabled``: the artifact of a
        disabled recorder is just its header + extras, and a post-mortem
        with partial data beats none."""
        import socket

        events = self.events()
        with open(path, "w") as handle:
            header = {
                "type": "flight-record",
                "reason": reason,
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "time": time.time(),
                "events": len(events) + len(extra_events or ()),
                "enabled": self.enabled,
            }
            # The reference adds the doctor's last verdict here ("doctor");
            # the diagnosis package is ROADMAP queue A item 9, so the port's
            # header goes without it, as the reference's does when that
            # import fails.
            handle.write(json.dumps(header) + "\n")
            for event in events:
                handle.write(json.dumps(event) + "\n")
            for event in extra_events or ():
                handle.write(json.dumps(event) + "\n")
        return path

    def dump_crash(self, name, exc, directory=None):
        """Crash-path dump: ``flight-<name>-<pid>.jsonl`` in ``directory``
        (default cwd), with the exception and traceback as the final
        event.  Returns the path, or None when the recorder is disabled
        (a run that never asked for observability should not scatter
        artifacts on every failure).  Never raises — this runs inside
        exception handlers."""
        if not self.enabled:
            return None
        try:
            path = os.path.join(
                directory or os.getcwd(), f"flight-{name}-{os.getpid()}.jsonl"
            )
            crash_event = {
                "kind": "crash",
                "ts": time.time(),
                "pid": os.getpid(),
                "args": {
                    "error": repr(exc),
                    "traceback": "".join(
                        traceback.format_exception(type(exc), exc, exc.__traceback__)
                    )[-4000:],
                },
            }
            return self.dump(path, reason="crash", extra_events=[crash_event])
        except Exception:  # pragma: no cover - crash path must not re-crash
            return None


def flight_events_as_spans(events):
    """Ring events -> span-shaped records for the spans storage channel.

    The producer mirrors drained flight events through
    ``DocumentStorage.record_spans`` as zero-duration ``flight.<kind>``
    spans, so ``orion-tpu-torch flight-record -n NAME`` can reconstruct another
    process's recent history from storage and a Perfetto trace shows the
    events on the worker's timeline."""
    spans = []
    for event in events:
        if not event:
            continue
        span = {
            "name": f"flight.{event.get('kind', '?')}",
            "ts": float(event.get("ts", 0.0)),
            "dur": 0.0,
            "pid": int(event.get("pid", 0)),
            "tid": 0,
        }
        args = event.get("args")
        if args:
            span["args"] = dict(args)
        spans.append(span)
    return spans


def spans_as_flight_events(spans):
    """Inverse of :func:`flight_events_as_spans` for the CLI read path:
    keep only ``flight.*`` span docs and strip them back to event form."""
    events = []
    for span in spans:
        name = str(span.get("name", ""))
        if not name.startswith("flight."):
            continue
        event = {
            "kind": name[len("flight."):],
            "ts": float(span.get("ts", 0.0)),
            "pid": int(span.get("pid", 0)),
        }
        if span.get("worker") is not None:
            event["worker"] = span["worker"]
        args = span.get("args")
        if args:
            event["args"] = dict(args)
        events.append(event)
    return events


#: THE process-wide flight recorder, next to telemetry.TELEMETRY.  Enabled
#: state comes from ORION_TPU_FLIGHT / ORION_TPU_TELEMETRY at import; the
#: CLI layers the ``telemetry:`` config key on top (cli/base.py).
FLIGHT = FlightRecorder()
