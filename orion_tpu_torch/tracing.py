"""Distributed-trace analysis: cross-process merge + critical-path
attribution (port of ``orion_tpu/tracing.py``).

``orion_tpu_torch.telemetry`` records the spans and stamps the
:class:`~orion_tpu_torch.telemetry.TraceContext` fields; this module
answers the two questions the merged records exist for:

- **merge** (:func:`collect_distributed_spans`): one causally-linked span
  set per experiment.  Worker processes flush their spans through the
  storage channel keyed by experiment; adopting SERVERS have no experiment
  identity, so they flush under the reserved :data:`SERVER_EXPERIMENT` id
  and the merge joins them back by ``trace_id``: a server span is included
  exactly when its trace appears in the experiment's own spans.  The
  port's ``db serve`` (``orion_tpu_torch/storage/netdb.py``) flushes its
  spans that way, and :func:`is_server_span` recognizes its tracks.

- **attribution** (:func:`attribute_traces` / :func:`summarize_attribution`):
  the per-trace critical-path split behind ``orion-tpu-torch trace
  --attribute``.  Each sampled round's wall time (the trace's root span,
  normally ``producer.round``) buckets into client-host / wire /
  server-host / device:

  - **device**: spans named in :data:`DEVICE_SPAN_NAMES` (async device
    windows such as the speculative ring's ``device.dispatch``).  The
    port's ``suggest_step.dispatch`` is not one of them: it times the
    host issuing the round (a CUDA-graph replay and its copy-out, or an
    eager round's launches), so it books to client-host;
  - **server-host**: spans recorded on server tracks (worker label with a
    ``netdb:``/``gateway:`` prefix) minus their own device children;
  - **wire**: for every client span that has server-track children, the
    client-observed duration minus the server-side time;
  - **client-host**: the remainder of the root span.

  The split is an approximation over OVERLAPPING spans (the pipelined
  commit deliberately runs under the device window), so buckets are
  clamped non-negative and the residual lands in client-host.
"""

#: Reserved experiment id server-side spans are flushed under (the netdb
#: server adopts trace contexts but has no experiment identity).
SERVER_EXPERIMENT = "__server__"

#: Track-label prefixes that mark a span as SERVER-side host work.
SERVER_TRACK_PREFIXES = ("netdb:", "gateway:")

#: Span names booked to the device bucket: the reference's set.  The
#: ``jax.*`` names stay so that spans of a store the reference wrote
#: attribute alike.
DEVICE_SPAN_NAMES = frozenset(
    {
        "device.dispatch",
        "jax.suggest_step.dispatch",
        "jax.suggest_step.compile",
        "serve.dispatch",
    }
)


def is_server_span(span):
    """True when the record was produced by an adopting server (netdb /
    gateway) rather than a worker — keyed off the track label the server
    stamps into its own records."""
    worker = str(span.get("worker") or "")
    return worker.startswith(SERVER_TRACK_PREFIXES)


def collect_distributed_spans(storage, experiment):
    """The experiment's spans plus every server-side span belonging to one
    of its traces, time-ordered — the input ``orion-tpu-torch trace
    --distributed`` renders and ``--attribute`` analyzes."""
    spans = list(storage.fetch_spans(experiment))
    trace_ids = {s.get("trace_id") for s in spans if s.get("trace_id")}
    if trace_ids:
        try:
            server_spans = storage.fetch_spans(SERVER_EXPERIMENT)
        except Exception:  # third-party protocol without the channel
            server_spans = []
        spans.extend(
            s for s in server_spans if s.get("trace_id") in trace_ids
        )
    spans.sort(key=lambda s: s.get("ts") or 0.0)
    return spans


def _group_traces(spans):
    """trace_id -> member spans.  A span with LINKS but no trace identity
    of its own (the gateway's shared coalesced dispatch) belongs to EVERY
    linked trace — each tenant's round genuinely waited on that dispatch,
    so each trace's device bucket must see it."""
    traces = {}
    for span in spans:
        trace_id = span.get("trace_id")
        if trace_id:
            traces.setdefault(trace_id, []).append(span)
        for link in span.get("links") or ():
            linked = (link or {}).get("trace_id")
            if linked and linked != trace_id:
                traces.setdefault(linked, []).append(span)
    return traces


def attribute_traces(spans):
    """Per-trace critical-path buckets (ms), keyed by trace_id.

    Only traces with an identifiable ROOT span (no ``parent_span_id`` —
    the producer round) are attributed: a trace whose root was evicted
    from the ring has no honest total to split."""
    out = {}
    for trace_id, members in _group_traces(spans).items():
        roots = [s for s in members if not s.get("parent_span_id")]
        if not roots:
            continue
        root = max(roots, key=lambda s: float(s.get("dur") or 0.0))
        total = float(root.get("dur") or 0.0)
        device = sum(
            float(s.get("dur") or 0.0)
            for s in members
            if s.get("name") in DEVICE_SPAN_NAMES
        )
        server_spans = [s for s in members if is_server_span(s)]
        server_host = sum(
            float(s.get("dur") or 0.0)
            for s in server_spans
            if s.get("name") not in DEVICE_SPAN_NAMES
        )
        # Wire: client-observed op time minus the server-side time nested
        # under it, summed per client parent of a server span.
        by_id = {s.get("span_id"): s for s in members if s.get("span_id")}
        server_under = {}
        for s in server_spans:
            parent = by_id.get(s.get("parent_span_id"))
            if parent is not None and not is_server_span(parent):
                server_under.setdefault(id(parent), [parent, 0.0])
                server_under[id(parent)][1] += float(s.get("dur") or 0.0)
        wire = sum(
            max(float(parent.get("dur") or 0.0) - nested, 0.0)
            for parent, nested in server_under.values()
        )
        device = min(device, total) if total else device
        client_host = max(total - wire - server_host - device, 0.0)
        out[trace_id] = {
            "root": root.get("name"),
            "total_ms": round(total * 1e3, 3),
            "client_host_ms": round(client_host * 1e3, 3),
            "wire_ms": round(wire * 1e3, 3),
            "server_host_ms": round(server_host * 1e3, 3),
            "device_ms": round(device * 1e3, 3),
            "spans": len(members),
        }
    return out


def summarize_attribution(spans, root_name=None):
    """Mean per-trace bucket split (ms) over every attributed trace — the
    footer of ``orion-tpu-torch trace --attribute``.  ``root_name``
    restricts to traces rooted at one span name (``producer.round``) so a
    stray ad-hoc trace cannot skew the round numbers."""
    traces = attribute_traces(spans)
    if root_name is not None:
        traces = {k: v for k, v in traces.items() if v["root"] == root_name}
    n = len(traces)
    keys = ("total_ms", "client_host_ms", "wire_ms", "server_host_ms", "device_ms")
    summary = {"traces": n}
    for key in keys:
        summary[key] = (
            round(sum(t[key] for t in traces.values()) / n, 3) if n else None
        )
    return summary


def format_attribution(spans, root_name=None):
    """Human table for ``orion-tpu-torch trace --attribute``."""
    traces = attribute_traces(spans)
    if root_name is not None:
        traces = {k: v for k, v in traces.items() if v["root"] == root_name}
    header = (
        f"{'trace':<18} {'root':<18} {'total':>9} {'client':>9} "
        f"{'wire':>9} {'server':>9} {'device':>9}"
    )
    lines = [header, "-" * len(header)]
    for trace_id, row in sorted(traces.items(), key=lambda kv: -kv[1]["total_ms"]):
        lines.append(
            f"{trace_id[:16]:<18} {str(row['root'])[:18]:<18} "
            f"{row['total_ms']:>9.3f} {row['client_host_ms']:>9.3f} "
            f"{row['wire_ms']:>9.3f} {row['server_host_ms']:>9.3f} "
            f"{row['device_ms']:>9.3f}"
        )
    summary = summarize_attribution(spans, root_name=root_name)
    lines.append("-" * len(header))
    if summary["traces"]:
        lines.append(
            f"{'mean of ' + str(summary['traces']):<18} {'':<18} "
            f"{summary['total_ms']:>9.3f} {summary['client_host_ms']:>9.3f} "
            f"{summary['wire_ms']:>9.3f} {summary['server_host_ms']:>9.3f} "
            f"{summary['device_ms']:>9.3f}"
        )
    else:
        lines.append("(no attributable traces — run with telemetry enabled)")
    return "\n".join(lines)
