"""Pull-based metrics export plane: Prometheus text exposition + /metrics
(port of ``orion_tpu/metrics.py``).

Two consumers, one renderer:

- :class:`MetricsServer` — a stdlib ``http.server`` daemon thread serving
  ``/metrics`` (the process-wide :data:`~orion_tpu_torch.telemetry.TELEMETRY`
  registry as Prometheus text exposition, format 0.0.4) and ``/healthz``
  (a small JSON liveness document).  Workers attach it with the
  ``metrics_port:`` config key or the ``ORION_TPU_METRICS_PORT`` env var.

- ``orion-tpu-torch metrics -n NAME`` (``cli/metrics.py``) — renders the
  MERGED cross-worker snapshot (the storage metrics channel +
  :func:`~orion_tpu_torch.telemetry.merge_snapshots`) in the same
  exposition format, for airgapped scraping.

Mapping (the registry's primitives are Prometheus-shaped on purpose):

- counters  -> ``orion_tpu_<name>_total`` (monotonic);
- gauges    -> ``orion_tpu_<name>``;
- log2-µs histograms -> ``orion_tpu_<name>_seconds`` with CUMULATIVE
  ``le`` buckets at each bucket's upper bound in seconds, plus
  ``_sum``/``_count`` — merged snapshots sum buckets elementwise, so the
  cumulative conversion commutes with :func:`merge_snapshots`;
- per-tenant request histograms (``serve.tenant.<name>.request``) export
  as ONE ``orion_tpu_serve_tenant_request_seconds`` family with a
  ``tenant`` label (values escaped per the exposition spec).

The metric names keep the reference's ``orion_tpu_`` prefix, so one
scrape configuration reads either package's workers.

Left out, each with the ROADMAP queue A item that brings it:

- a scrape's refresh of the device-memory and compiler-plane gauges
  (item 6) and of the replication-lag gauges (item 7);
- the doctor: ``doctor.findings.<RULE>`` gauges still export as one
  labelled family, but every rule's severity reads ``unknown`` (the
  reference's answer when its diagnosis package fails to import), and the
  worker's ``/healthz`` answers ``{"ok": true}`` without the reference's
  ``doctor`` block (item 9).
"""

import http.server
import json
import logging
import os
import re
import threading

from orion_tpu_torch.telemetry import TELEMETRY, bucket_upper_seconds

log = logging.getLogger(__name__)

PREFIX = "orion_tpu_"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: Registry names matching this pattern export as a labeled family
#: instead of one metric per tenant (unbounded tenant cardinality would
#: mint unbounded metric names — the exposition-format antipattern).
_TENANT_RE = re.compile(r"^serve\.tenant\.(?P<tenant>.+)\.request$", re.DOTALL)

#: Doctor findings gauges (``doctor.findings.<RULE>``, published by
#: the reference's ``diagnosis/watch.py``) export as ONE
#: ``orion_tpu_doctor_findings{rule,severity}`` family — rule ids are a
#: closed registry, and the severity label comes from each rule's own
#: declaration.
_DOCTOR_RE = re.compile(r"^doctor\.findings\.(?P<rule>[A-Za-z0-9_]+)$")


def _doctor_severities():
    """rule id -> declared severity.  The rule catalog is the diagnosis
    package (ROADMAP queue A item 9), not ported yet: no rule has a
    declared severity, so every id labels as ``unknown`` rather than
    dropping the sample, as the reference's failed import does."""
    return {}


def sanitize_name(name):
    """Registry key -> Prometheus metric name component."""
    out = _NAME_RE.sub("_", str(name))
    if out and out[0].isdigit():  # metric names must not start with a digit
        out = "_" + out
    return out


def escape_label_value(value):
    """Exposition-format label escaping: backslash, double quote, newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _format_value(value):
    """Floats render without trailing noise; +Inf per the spec."""
    if value == float("inf"):
        return "+Inf"
    formatted = repr(float(value))
    return formatted[:-2] if formatted.endswith(".0") else formatted


def _histogram_lines(metric, hist, labels=""):
    """Cumulative-``le`` lines for one snapshot histogram dict.  Only
    buckets up to the last occupied one are emitted (48 log2 buckets per
    histogram would bloat every scrape ~10x for zero information — the
    ``+Inf`` bucket always closes the family), and cumulative counts are
    monotone non-decreasing by construction."""
    buckets = list(hist.get("buckets") or ())
    last = 0
    for index, count in enumerate(buckets):
        if count:
            last = index + 1
    sep = "," if labels else ""
    lines = []
    cumulative = 0
    for index in range(last):
        cumulative += int(buckets[index])
        upper = _format_value(bucket_upper_seconds(index))
        lines.append(f'{metric}_bucket{{{labels}{sep}le="{upper}"}} {cumulative}')
    total = int(hist.get("count", 0))
    lines.append(f'{metric}_bucket{{{labels}{sep}le="+Inf"}} {total}')
    suffix = f"{{{labels}}}" if labels else ""
    lines.append(f"{metric}_sum{suffix} {_format_value(hist.get('sum', 0.0))}")
    lines.append(f"{metric}_count{suffix} {total}")
    return lines


def render_exposition(snapshot, prefix=PREFIX):
    """One metrics snapshot (``Telemetry.snapshot()`` or a
    ``merge_snapshots`` result) as Prometheus text exposition 0.0.4."""
    lines = []
    for name, value in sorted((snapshot.get("counters") or {}).items()):
        metric = f"{prefix}{sanitize_name(name)}_total"
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {int(value)}")
    doctor_rows = []
    plain_gauges = []
    for name, value in sorted((snapshot.get("gauges") or {}).items()):
        match = _DOCTOR_RE.match(name)
        if match:
            doctor_rows.append((match.group("rule"), value))
        else:
            plain_gauges.append((name, value))
    for name, value in plain_gauges:
        metric = f"{prefix}{sanitize_name(name)}"
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {_format_value(value)}")
    if doctor_rows:
        severities = _doctor_severities()
        metric = f"{prefix}doctor_findings"
        lines.append(f"# TYPE {metric} gauge")
        for rule, value in doctor_rows:
            severity = severities.get(rule, "unknown")
            lines.append(
                f'{metric}{{rule="{escape_label_value(rule)}",'
                f'severity="{escape_label_value(severity)}"}} '
                f"{_format_value(value)}"
            )
    tenant_families = {}
    plain = []
    for name, hist in sorted((snapshot.get("histograms") or {}).items()):
        match = _TENANT_RE.match(name)
        if match:
            metric = f"{prefix}serve_tenant_request_seconds"
            tenant_families.setdefault(metric, []).append(
                (match.group("tenant"), hist)
            )
        else:
            plain.append((f"{prefix}{sanitize_name(name)}_seconds", hist))
    for metric, hist in plain:
        lines.append(f"# TYPE {metric} histogram")
        lines.extend(_histogram_lines(metric, hist))
    for metric, families in sorted(tenant_families.items()):
        lines.append(f"# TYPE {metric} histogram")
        for tenant, hist in families:
            labels = f'tenant="{escape_label_value(tenant)}"'
            lines.extend(_histogram_lines(metric, hist, labels=labels))
    return "\n".join(lines) + "\n"


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    server_version = "orion-tpu-torch-metrics"

    def do_GET(self):  # noqa: N802 - http.server contract
        if self.path.split("?", 1)[0] == "/metrics":
            body = render_exposition(self.server.registry.snapshot()).encode()
            content_type = "text/plain; version=0.0.4; charset=utf-8"
        elif self.path.split("?", 1)[0] == "/healthz":
            healthz = self.server.healthz
            try:
                payload = healthz() if healthz is not None else {"ok": True}
            except Exception:  # pragma: no cover - prober must get an answer
                payload = {"ok": False}
            body = (json.dumps(payload) + "\n").encode()
            content_type = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes must not spam stderr
        log.debug("metrics http: " + fmt, *args)


class _HTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class MetricsServer:
    """``/metrics`` + ``/healthz`` on a daemon thread.

    ``registry`` defaults to the process-wide TELEMETRY; ``healthz`` is an
    optional zero-arg callable returning the health JSON (the gateway
    passes queue depth / tenant count)."""

    def __init__(self, port=0, host="127.0.0.1", registry=None, healthz=None):
        self._httpd = _HTTPServer((host, int(port)), _MetricsHandler)
        self._httpd.registry = registry if registry is not None else TELEMETRY
        self._httpd.healthz = healthz
        self._thread = None

    @property
    def address(self):
        return self._httpd.server_address[:2]

    @property
    def port(self):
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="orion-tpu-torch-metrics",
            daemon=True,
        )
        self._thread.start()
        return self.address

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


#: Process-wide worker metrics server (workers opt in via env/config; one
#: port per process, idempotent across repeated workon() calls).
_worker_server = None
_worker_lock = threading.Lock()


def _worker_healthz():
    """The worker /healthz payload: liveness.  The reference adds the
    doctor's summary block (``doctor``); the diagnosis package is ROADMAP
    queue A item 9, and the block comes with it."""
    return {"ok": True}


def ensure_worker_metrics_server(port=None):
    """Start (once) the worker-side metrics server.

    ``port`` falls back to the ``ORION_TPU_METRICS_PORT`` env var; absent/
    invalid/empty means "not requested" and returns None.  Failures are
    logged, never raised — observability must not kill a worker.  Two
    worker-fleet realities are handled here:

    - requesting a scrape endpoint IS requesting metrics, so a successful
      start enables the telemetry registry (an endpoint over a disabled
      registry would serve an empty exposition forever);
    - ``hunt --n-workers N`` children all inherit ONE configured port —
      the first binds it, the rest fall back to an EPHEMERAL port (logged
      with the bound address) instead of silently exporting nothing.

    The worker's ``/healthz`` answers bare liveness (see
    :func:`_worker_healthz`)."""
    global _worker_server
    if port is None:
        raw = os.environ.get("ORION_TPU_METRICS_PORT", "").strip()
        if not raw:
            return None
        try:
            port = int(raw)
        except ValueError:
            log.warning("ignoring non-numeric ORION_TPU_METRICS_PORT=%r", raw)
            return None
    with _worker_lock:
        if _worker_server is not None:
            return _worker_server
        try:
            server = MetricsServer(port=int(port), healthz=_worker_healthz)
        except OSError as exc:
            try:
                server = MetricsServer(port=0, healthz=_worker_healthz)
                log.warning(
                    "metrics port %s unavailable (%s); falling back to an "
                    "ephemeral port", port, exc,
                )
            except OSError as fallback_exc:  # pragma: no cover - no sockets
                log.warning(
                    "could not start worker metrics server: %s", fallback_exc
                )
                return None
        server.start()
        TELEMETRY.enable()
        _worker_server = server
        log.info("worker metrics server on %s:%s", *server.address)
        return server
