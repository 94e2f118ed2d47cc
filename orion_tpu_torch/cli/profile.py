"""`orion-tpu-torch profile`: the compiler plane of one experiment (port of
``orion_tpu/cli/profile.py``).

Workers running with telemetry enabled record every CUDA-graph capture of
the suggest round as a ``cuda_graph.capture`` span (family, kind — capture,
prewarm or recapture —, wall ms, the full signature in args) and every
attributed recapture as a flight ``cuda_graph.recapture`` event (mirrored
into the span channel as ``flight.cuda_graph.recapture``, naming the changed
statics); both flush through the storage channel like every other span.
This command merges them back into:

- the **capture table** — one row per recorded capture, with family, kind,
  wall ms, and signature;
- the **recapture attribution table** — one row per synchronous capture a
  suggest paid, naming the changed statics (``fit_bucket 64→128``) and
  whether a completed prewarm recorded that exact signature (a yes is a
  prewarm bug);
- the **memory line** — the largest captured round's footprint (its graph
  pool and static inputs) against the card's memory, and the predicted q
  at which it would fill the card, from the ``compiler.*`` gauges the
  workers flushed;
- the local :data:`~orion_tpu_torch.compiler_plane.COMPILE_REGISTRY`
  summary, when THIS process captured anything.

``--capture DIR`` runs the local registry's FLOP-count pass (an eager
round per signature) under the shared
:func:`~orion_tpu_torch.compiler_plane.profiler_capture`, the same helper
``hunt --profile`` uses, writing ``DIR/trace-<pid>.json``; it traces the
card unless ``--device cpu`` is given, and exits 1 where no card is
present, as ``hunt`` does.
"""

import json
import sys

from orion_tpu_torch.cli.base import add_experiment_args, build_from_args


def add_subparser(subparsers):
    parser = subparsers.add_parser(
        "profile", help="show the compiler plane of an experiment"
    )
    add_experiment_args(parser, with_user_args=False)
    parser.add_argument(
        "--json",
        action="store_true",
        help="machine-readable JSON instead of the tables",
    )
    parser.add_argument(
        "--capture",
        metavar="DIR",
        default=None,
        help="run the local registry's FLOP-count pass under a torch.profiler "
        "trace written to DIR (the same capture helper as `hunt --profile`)",
    )
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="device the --capture trace records (default cuda; the command "
        "fails where no CUDA device is present unless cpu is given)",
    )
    parser.set_defaults(func=main)
    return parser


#: The compiler-plane names this command extracts from the span channel.
_COMPILE_SPAN = "cuda_graph.capture"
_RETRACE_SPAN = "flight.cuda_graph.recapture"


def _compile_rows(spans):
    """Capture-table rows off the flushed ``cuda_graph.capture`` spans."""
    rows = []
    for span in spans:
        if span.get("name") != _COMPILE_SPAN:
            continue
        args = span.get("args") or {}
        rows.append(
            {
                "worker": str(span.get("worker") or "?"),
                "family": args.get("family", "?"),
                "kind": args.get("kind", "?"),
                "capture_ms": round(float(span.get("dur") or 0.0) * 1e3, 3),
                "signature": args.get("signature", ""),
            }
        )
    return rows


def _retrace_rows(spans):
    """Attribution rows off the mirrored flight ``cuda_graph.recapture``
    events."""
    rows = []
    for span in spans:
        if span.get("name") != _RETRACE_SPAN:
            continue
        args = span.get("args") or {}
        rows.append(
            {
                "worker": str(span.get("worker") or "?"),
                "family": args.get("family", "?"),
                "changed": args.get("changed", "?"),
                "covered_by_prewarm": bool(args.get("covered_by_prewarm")),
                "signature": args.get("signature", ""),
            }
        )
    return rows


def _format_table(rows, columns):
    """Fixed-width table; column order and headers from ``columns``."""
    if not rows:
        return []
    widths = {
        key: max(len(key), *(len(str(row.get(key, ""))) for row in rows))
        for key in columns
    }
    lines = ["  ".join(key.ljust(widths[key]) for key in columns)]
    for row in rows:
        lines.append(
            "  ".join(str(row.get(key, "")).ljust(widths[key]) for key in columns)
        )
    return lines


def _gb(value):
    return f"{float(value) / 1e9:.2f}GB"


def hbm_line(gauges):
    """``HBM: plan max <GB> of <GB> (<%>) — predicted HBM-bound q <q>`` from
    merged ``compiler.*`` gauges, or None without footprints."""
    footprint = gauges.get("compiler.hbm_bytes_max")
    if not footprint:
        return None
    capacity = gauges.get("compiler.hbm_capacity_bytes")
    parts = [f"HBM: plan max {_gb(footprint)}"]
    if capacity:
        parts.append(
            f"of {_gb(capacity)} ({100.0 * footprint / capacity:.1f}%)"
        )
    bound_q = gauges.get("compiler.hbm_bound_q")
    if bound_q:
        parts.append(f"— predicted HBM-bound q {int(bound_q)}")
    return " ".join(parts)


def _merged_metrics(experiment):
    from orion_tpu_torch.telemetry import merge_snapshots

    try:
        docs = experiment.storage.fetch_metrics(experiment)
    except Exception:
        docs = None
    if not docs:
        return {}, {}
    merged = merge_snapshots(docs)
    return merged.get("counters") or {}, merged.get("gauges") or {}


def _local_registry_block(capture_dir, device):
    """The in-process registry summary — empty unless THIS process
    captured rounds.  With ``capture_dir``, the analysis pass (an eager
    round per signature) runs under the shared profiler capture of
    ``device``."""
    from orion_tpu_torch.compiler_plane import COMPILE_REGISTRY, profiler_capture

    summary = COMPILE_REGISTRY.summary()
    if not summary["compiles"] and capture_dir is None:
        return None
    if capture_dir is not None:
        with profiler_capture(capture_dir, device):
            analysis = COMPILE_REGISTRY.analyze_all()
    else:
        analysis = COMPILE_REGISTRY.analyze_all()
    summary = COMPILE_REGISTRY.summary()
    summary["analysis"] = analysis
    return summary


def main(args):
    device = None
    if args.capture is not None:
        from orion_tpu_torch.device import resolve_device

        try:
            device = resolve_device(args.device)
        except RuntimeError as exc:
            print(f"ERROR: {exc}", file=sys.stderr)
            return 1
    experiment, _parser = build_from_args(
        args, need_user_args=False, allow_create=False, view=True
    )
    try:
        spans = experiment.storage.fetch_spans(experiment) or []
    except Exception:
        spans = []
    compiles = _compile_rows(spans)
    retraces = _retrace_rows(spans)
    counters, gauges = _merged_metrics(experiment)
    registry = _local_registry_block(args.capture, device)
    if args.json:
        print(
            json.dumps(
                {
                    "experiment": experiment.name,
                    "counters": {
                        key: counters[key]
                        for key in sorted(counters)
                        if key.startswith(("cuda_graph.", "compiler."))
                    },
                    "gauges": {
                        key: gauges[key]
                        for key in sorted(gauges)
                        if key.startswith("compiler.")
                    },
                    "compiles": compiles,
                    "retraces": retraces,
                    "registry": registry,
                },
                default=str,
            )
        )
        return 0
    out = [f"compiler plane — experiment {experiment.name!r}"]
    totals = " ".join(
        f"{key}={counters[key]}"
        for key in (
            "cuda_graph.captures",
            "cuda_graph.recaptures",
            "cuda_graph.recaptures.attributed",
            "cuda_graph.recaptures.prewarm_covered",
        )
        if key in counters
    )
    if totals:
        out.append(totals)
    line = hbm_line(gauges)
    if line:
        out.append(line)
    if compiles:
        out.append("")
        out.append("captures:")
        out.extend(
            _format_table(
                compiles, ("worker", "family", "kind", "capture_ms", "signature")
            )
        )
    if retraces:
        out.append("")
        out.append("recapture attribution:")
        out.extend(
            _format_table(
                retraces, ("worker", "family", "changed", "covered_by_prewarm")
            )
        )
    if registry:
        out.append("")
        out.append(
            "local registry: "
            f"{registry['compiles']} captures, "
            f"{registry['retraces_attributed']}/{registry['retraces']} "
            "recaptures attributed; flops: "
            f"{registry['flops_label']}"
        )
        per_plan = registry.get("per_plan") or []
        out.extend(
            _format_table(
                per_plan,
                ("family", "kind", "capture_ms", "instantiate_ms", "graph_nodes",
                 "pool_bytes", "hbm_bytes", "flops", "signature"),
            )
        )
    if not (compiles or retraces or registry):
        out.append(
            "no compiler-plane data — run the hunt with ORION_TPU_TELEMETRY=1 "
            "(or `telemetry: true` in the config) to collect it"
        )
        print("\n".join(out))
        return 1
    print("\n".join(out))
    return 0
