"""`orion-tpu-torch info`: pretty-print one experiment (port of
``orion_tpu/cli/info.py``).

Capability parity: reference `src/orion/core/cli/info.py` — sections for
commandline, config, algorithm, space, metadata, refers (EVC lineage), and
stats, plus the producer's timings, the merged telemetry and health
snapshots with each snapshot's host/device ratio against the host budget,
the compiler plane's digest (CUDA-graph captures), and the doctor's
verdict; ``--all`` heads its list with the storage topology and the serve
fleet (one ``fleet`` probe per configured gateway).
"""

import time

from orion_tpu_torch.cli.base import (
    add_experiment_args,
    build_all_experiments,
    build_from_args,
)
from orion_tpu_torch.core.producer import Producer


#: A worker's snapshot is stale past three metrics flush intervals (the
#: reference's ``cli/top.py::STALE_AFTER``).
STALE_AFTER = 3.0 * Producer.METRICS_FLUSH_INTERVAL


def add_subparser(subparsers):
    parser = subparsers.add_parser("info", help="show experiment details")
    add_experiment_args(parser, with_user_args=False)
    parser.add_argument(
        "--per-worker",
        action="store_true",
        help="show each worker's telemetry/health snapshot separately "
        "instead of only the merged view (MAX-merged gauges hide WHICH "
        "worker is lagging)",
    )
    parser.add_argument(
        "--all",
        action="store_true",
        help="show every experiment in the store (a serve gateway hosts "
        "many tenants), not just -n NAME",
    )
    parser.set_defaults(func=main)
    return parser


def _section(title):
    return f"\n{title}\n{'=' * len(title)}"


def format_info(experiment, per_worker=False):
    out = [_section("Commandline")]
    out.append(" ".join(experiment.metadata.get("user_args", [])) or "(none)")

    out.append(_section("Config"))
    for key in ("pool_size", "max_trials", "max_broken", "working_dir"):
        out.append(f"{key}: {getattr(experiment, key)}")

    out.append(_section("Algorithm"))
    out.append(repr(experiment.algo_config))
    out.append(f"strategy: {experiment.strategy_config!r}")

    out.append(_section("Space"))
    for name, prior in sorted(experiment.priors.items()):
        out.append(f"{name}: {prior}")

    out.append(_section("Meta-data"))
    out.append(f"name: {experiment.name}")
    out.append(f"version: {experiment.version}")
    ts = experiment.metadata.get("timestamp")
    if ts:
        out.append(f"datetime: {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(ts))}")
    if experiment.metadata.get("user_script"):
        out.append(f"user_script: {experiment.metadata['user_script']}")

    out.append(_section("Parent experiment"))
    refers = experiment.refers or {}
    out.append(f"root: {refers.get('root_id') or experiment.id}")
    out.append(f"parent: {refers.get('parent_id') or '(none)'}")

    out.append(_section("Stats"))
    stats = experiment.stats()
    out.append(f"trials completed: {stats['trials_completed']}")
    if stats.get("best_evaluation") is not None:
        out.append(f"best evaluation: {stats['best_evaluation']}")
        out.append(f"best trial: {stats['best_trials_id']}")
        for key, value in sorted(stats.get("best_params", {}).items()):
            out.append(f"  {key}: {value}")
    if stats.get("start_time"):
        started = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(stats["start_time"]))
        out.append(f"start time: {started}")
    if stats.get("duration") is not None:
        out.append(f"duration: {stats['duration']:.1f}s")

    perf = _perf_section(experiment)
    if perf:
        out.append(_section("Performance"))
        out.extend(perf)

    # ONE fetch per channel for the three sections below — the telemetry,
    # health, and doctor blocks all read the same two collections, and a
    # sharded store pays a fan-out per fetch.  Each fetch is guarded
    # separately so one sick channel costs only its own sections.
    metrics_docs = _fetch_guarded(experiment, "fetch_metrics")
    health_docs = _fetch_guarded(experiment, "fetch_health")

    tele = _telemetry_section(experiment, per_worker=per_worker, docs=metrics_docs)
    if tele:
        out.append(_section("Telemetry"))
        out.extend(tele)

    compiler = _compiler_section(metrics_docs)
    if compiler:
        out.append(_section("Compiler"))
        out.extend(compiler)

    health = _health_section(experiment, per_worker=per_worker, docs=health_docs)
    if health:
        out.append(_section("Health"))
        out.extend(health)

    doctor = _doctor_line(experiment, metrics_docs, health_docs)
    if doctor:
        out.append(_section("Doctor"))
        out.append(doctor)
    return "\n".join(out) + "\n"


def _doctor_line(experiment, metrics_docs, health_docs):
    """The diagnosis badge (orion_tpu_torch.diagnosis): one line leading
    with the verdict, naming the firing rules — `orion-tpu-torch doctor` is
    the full report.  Reads the docs format_info already fetched.  Guarded
    like the telemetry/health sections."""
    if metrics_docs is None and health_docs is None:
        # Both fetches failed: no data is not "healthy" — drop the badge
        # rather than print an OK verdict over nothing.
        return None
    try:
        from orion_tpu_torch.cli.top import _doctor_block, doctor_badge

        return doctor_badge(
            _doctor_block(
                experiment, metrics_docs or [], health_docs or [], time.time()
            )
        )
    except Exception:
        return None


def _fetch_guarded(experiment, op):
    """One storage-channel fetch, degraded to None on any failure (a
    malformed doc or a sick store drops the dependent sections, never
    takes down ``info``)."""
    try:
        return getattr(experiment.storage, op)(experiment)
    except Exception:
        return None


def _perf_section(experiment):
    """suggest/observe/register latency percentiles from producer telemetry
    (no counterpart in the Oríon reference).  ``register`` is the batched
    storage commit of a produce round."""
    lines = []
    for op in ("suggest", "observe", "register"):
        try:
            docs = experiment.storage.fetch_timings(experiment, op=op)
        except Exception:
            return []
        if not docs:
            continue
        durations = sorted(d["duration"] for d in docs)
        n_points = sum(d.get("count", 1) for d in docs)

        def pct(p):
            # Nearest-rank percentile: ceil(p/100 * n) - 1 (0-indexed).
            idx = max(0, -(-int(p * len(durations)) // 100) - 1)
            return durations[min(idx, len(durations) - 1)]

        lines.append(
            f"{op}: {len(durations)} rounds, {n_points} points | "
            f"p50 {pct(50) * 1e3:.1f}ms  p90 {pct(90) * 1e3:.1f}ms  "
            f"p99 {pct(99) * 1e3:.1f}ms  max {durations[-1] * 1e3:.1f}ms"
        )
    return lines


def _compiler_section(docs):
    """The compiler-plane digest (orion_tpu_torch.compiler_plane): CUDA-graph
    captures and recapture-attribution coverage from the merged counters,
    plus the memory line ``profile`` and ``top`` also render.  Empty unless
    some worker recorded captures; guarded like the telemetry block."""
    if not docs:
        return []
    try:
        from orion_tpu_torch.cli.profile import hbm_line
        from orion_tpu_torch.telemetry import merge_snapshots

        merged = merge_snapshots(docs)
        counters = merged.get("counters") or {}
        gauges = merged.get("gauges") or {}
        captures = counters.get("cuda_graph.captures")
        if not captures:
            return []
        lines = [
            f"captures: {int(captures)}  "
            f"recaptures: {int(counters.get('cuda_graph.recaptures', 0))} "
            f"({int(counters.get('cuda_graph.recaptures.attributed', 0))} attributed, "
            f"{int(counters.get('cuda_graph.recaptures.prewarm_covered', 0))} "
            "prewarm-covered)"
        ]
        ms_total = gauges.get("compiler.capture_ms_total")
        if ms_total:
            lines.append(f"capture time total: {float(ms_total):.1f}ms")
        headroom = hbm_line(gauges)
        if headroom:
            lines.append(headroom)
        lines.append("details: `orion-tpu-torch profile -n NAME`")
        return lines
    except Exception:
        return []


def _snapshot_lines(snapshot):
    """Histogram/counter/gauge lines for one (merged or per-worker)
    metrics snapshot dict."""
    from orion_tpu_torch.telemetry import histogram_percentile

    lines = []
    for name, hist in sorted((snapshot.get("histograms") or {}).items()):
        if not hist.get("count"):
            continue
        p50, p90, p99 = (
            histogram_percentile(hist, p) * 1e3 for p in (50, 90, 99)
        )
        lines.append(
            f"{name}: {hist['count']} samples | "
            f"p50 {p50:.1f}ms  p90 {p90:.1f}ms  p99 {p99:.1f}ms  "
            f"max {hist.get('max', 0.0) * 1e3:.1f}ms"
        )
    for name, value in sorted((snapshot.get("counters") or {}).items()):
        lines.append(f"{name}: {value}")
    for name, value in sorted((snapshot.get("gauges") or {}).items()):
        lines.append(f"{name}: {float(value):.4g}")
    return lines


def _telemetry_section(experiment, per_worker=False, docs=None):
    """The unified-telemetry block: per-op latency percentiles from the
    merged cross-worker histogram snapshots (orion_tpu_torch.telemetry), plus
    the counters ( storage transactions/wire requests/
    reconnects, lost-trial sweeps) and gauges each worker flushed through
    the storage metrics channel.  Empty unless a hunt ran with
    ``ORION_TPU_TELEMETRY=1`` (or ``telemetry: true``).  ``per_worker``
    keeps each worker's snapshot separate instead of merging — the merged
    view's MAX-combined gauges say only that SOME worker lags, never which
    one.  ``docs`` lets format_info share one fetch across sections.  The
    WHOLE section is guarded, not just the fetch: a malformed doc
    (third-party backend, corruption) must drop this block, never take
    down ``info``."""
    from orion_tpu_torch.telemetry import merge_snapshots

    try:
        if docs is None:
            docs = experiment.storage.fetch_metrics(experiment)
        if not docs:
            return []
        now = time.time()
        if per_worker:
            lines = [f"workers reporting: {len(docs)}"]
            for doc in docs:
                lines.append(
                    f"--- worker {doc.get('worker') or '?'}"
                    + _flush_age_suffix(doc, now)
                )
                lines.extend(_snapshot_lines(doc))
                ratio_line = _ratio_line(doc.get("histograms"))
                if ratio_line:
                    lines.append(ratio_line)
            return lines
        merged = merge_snapshots(docs)
        stale = [
            str(doc.get("worker") or "?")
            for doc in docs
            if _flush_age(doc, now) is not None
            and _flush_age(doc, now) > _stale_after()
        ]
        lines = [f"workers reporting: {len(docs)}"] + _snapshot_lines(merged)
        ratio_line = _ratio_line(merged.get("histograms"))
        if ratio_line:
            lines.append(ratio_line)
        if stale:
            # The merged view MAX-combines gauges, so a quiet worker's
            # numbers survive indefinitely — name who went quiet.
            lines.append(
                f"STALE workers (no flush for > {_stale_after():g}s): "
                + ", ".join(stale)
            )
        return lines
    except Exception:
        return []


def _stale_after():
    return STALE_AFTER


def _ratio_line(histograms):
    """``host/device ratio: 1.12 (budget 2.25x)`` from the round vs
    device-window histogram means — the same per-worker number ``top``
    shows in its ``h/d`` column, against the same
    ``orion_tpu_torch.hostbudget`` bar."""
    from orion_tpu_torch.cli.top import _host_device_ratio
    from orion_tpu_torch.hostbudget import round_budget_factor

    ratio = _host_device_ratio(histograms)
    if ratio is None:
        return None
    budget = round_budget_factor()
    marker = "  HOST-BUDGET BREACH" if ratio > budget else ""
    return f"host/device ratio: {ratio:g} (budget {budget:g}x){marker}"


def _flush_age(doc, now):
    ts = doc.get("time")
    return round(now - float(ts), 1) if ts else None


def _flush_age_suffix(doc, now):
    """`` (last flush 3.2s ago)`` — with a STALE marker past 3× the
    metrics flush interval, so the un-merged per-worker blocks carry the
    liveness signal the MAX-merged view hides."""
    age = _flush_age(doc, now)
    if age is None:
        return ""
    marker = " STALE" if age > _stale_after() else ""
    return f" (last flush {age:g}s ago{marker})"


def _health_section(experiment, per_worker=False, docs=None):
    """The optimization-health block (orion_tpu_torch.health): the fleet-wide
    incumbent over the recorded regret trajectory and, per worker, the
    latest per-round health record — GP marginal likelihood, lengthscale
    spread, acquisition level, trust-region box, rung occupancy.
    ``docs`` lets format_info share one fetch across sections.  Guarded
    like the telemetry block; empty when no hunt recorded health."""
    try:
        if docs is None:
            docs = experiment.storage.fetch_health(experiment)
        if not docs:
            return []
        best = None
        for doc in docs:
            y = doc.get("best_y")
            if y is not None and (best is None or y < best):
                best = y
        by_worker = {}
        for doc in docs:  # time-ordered: the last doc per worker wins
            by_worker[str(doc.get("worker") or "?")] = doc
        lines = [f"health records: {len(docs)} from {len(by_worker)} worker(s)"]
        if best is not None:
            lines.append(f"incumbent best_y: {best:.6g}")
        now = time.time()
        for worker, doc in sorted(by_worker.items()):
            fields = []
            age = _flush_age(doc, now)
            if age is not None:
                marker = " STALE" if age > _stale_after() else ""
                fields.append(f"age {age:g}s{marker}")
            for key, spec in (
                ("round", "d"),
                ("n_obs", "d"),
                ("best_y", ".5g"),
                ("gp_mll", ".3f"),
                ("gp_ls_mean", ".3g"),
                ("gp_noise", ".3g"),
                ("acq_ei_max", ".3g"),
                ("q_unique_frac", ".2f"),
                ("tr_length", ".3f"),
                ("model_tier", "d"),
                # Serve-gateway fields (orion_tpu_torch.serve): the coalesce
                # width this worker's rounds rode and the gateway queue.
                ("serve_width", "d"),
                ("serve_queue_depth", "d"),
                ("serve_tenants", "d"),
            ):
                value = doc.get(key)
                if value is not None:
                    if spec == "d":
                        value = int(value)
                    fields.append(f"{key} {format(value, spec)}")
            occupancy = doc.get("rung_occupancy")
            if occupancy:
                # Every bracket, not just the first: the starved rung the
                # signal exists to expose can sit in any ladder.  Per rung:
                # ``resources:occupied(evaluated)`` — occupied counts
                # pending promotion slots too, evaluated only real
                # objectives.
                for index, bracket in enumerate(occupancy):
                    rungs = " ".join(
                        f"{resources}:{occupied}({evaluated})"
                        for resources, occupied, evaluated in bracket
                    )
                    fields.append(f"rungs[b{index}] {rungs}")
            header = f"{worker}: " if per_worker or len(by_worker) > 1 else ""
            lines.append(header + "  ".join(fields))
        return lines
    except Exception:
        return []


def main(args):
    per_worker = getattr(args, "per_worker", False)
    if getattr(args, "all", False):
        experiments = build_all_experiments(args)
        # Fleet view over a sharded control plane: say which topology
        # answered (build_all_experiments resolved through the router, so
        # experiments from EVERY shard are in the list).
        from orion_tpu_torch.cli.base import (
            describe_serve_fleet,
            describe_storage_topology,
            load_cli_config,
        )

        topology = describe_storage_topology(probe=True)
        if topology is not None:
            print(topology)
        # Serve-plane twin of the storage header: one `fleet` probe per
        # configured gateway (per-member tenant counts, queue depth, and
        # the membership epoch — epoch=SPLIT is the drift smell DX007's
        # runbook starts from).
        gateways = describe_serve_fleet(load_cli_config(args).get("serve"))
        if gateways is not None:
            print(gateways)
        if not experiments:
            print("no experiments in storage")
            return 0
        for experiment in experiments:
            print(format_info(experiment, per_worker=per_worker))
        return 0
    experiment, _parser = build_from_args(
        args, need_user_args=False, allow_create=False, view=True
    )
    print(format_info(experiment, per_worker=per_worker))
    return 0
