"""`orion-tpu-torch top`: live per-worker optimization-health dashboard
(port of ``orion_tpu/cli/top.py``).

Polls the storage telemetry + health channels and renders, per worker:
producer round rate, heartbeat lag, storage p99 latency, device memory, the
host/device ratio against the host budget (``orion_tpu_torch.hostbudget``),
CUDA-graph captures, retries/reconnects, and the latest health record
(incumbent, GP marginal likelihood, trust-region length); plus a merged
regret-curve sparkline across the fleet.  ``--json`` is the one-shot
scripting mode: print one JSON snapshot and exit; ``--all`` one row per
experiment.

The doctor's badge leads each frame, from the snapshot's ``doctor`` block
(the rule catalog of ``orion_tpu_torch.diagnosis`` over the docs the frame
already fetched).  ``--all`` heads its table with the storage topology and
the serve fleet (``describe_serve_fleet``: one ``fleet`` probe per gateway).
"""

import json
import sys
import time

from orion_tpu_torch.cli.base import (
    add_experiment_args,
    build_all_experiments,
    build_from_args,
)
from orion_tpu_torch.core.producer import Producer

SPARK_CHARS = "▁▂▃▄▅▆▇█"

#: A worker whose last metrics/health flush is older than this is marked
#: STALE: 3× the producer's snapshot-upsert interval — MAX-merged gauges
#: keep a quiet worker's last numbers alive, so the AGE (not the values)
#: is the liveness signal.
STALE_AFTER = 3.0 * Producer.METRICS_FLUSH_INTERVAL


def add_subparser(subparsers):
    parser = subparsers.add_parser(
        "top", help="live per-worker optimization-health dashboard"
    )
    add_experiment_args(parser, with_user_args=False)
    parser.add_argument(
        "--json",
        action="store_true",
        help="print ONE machine-readable snapshot and exit (scripting mode)",
    )
    parser.add_argument(
        "-i",
        "--interval",
        type=float,
        default=2.0,
        metavar="seconds",
        help="refresh interval in live mode (default: 2s)",
    )
    parser.add_argument(
        "--iterations",
        type=int,
        default=0,
        metavar="N",
        help="render N frames then exit (default 0 = until interrupted)",
    )
    parser.add_argument(
        "--all",
        action="store_true",
        help="dashboard every experiment in the store (a serve gateway "
        "hosts many tenants), not just -n NAME",
    )
    parser.set_defaults(func=main)
    return parser


def sparkline(values, width=40):
    """Unicode sparkline of ``values`` downsampled to ``width`` columns."""
    values = [float(v) for v in values if v is not None]
    if not values:
        return ""
    if len(values) > width:
        # Keep the last point exact (the current incumbent) and stride the
        # rest — a regret curve's tail is the part being watched.
        stride = len(values) / float(width)
        values = [values[int(i * stride)] for i in range(width - 1)] + [values[-1]]
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    return "".join(
        SPARK_CHARS[int((v - lo) / span * (len(SPARK_CHARS) - 1))] for v in values
    )


def _merged_percentile(histograms, prefix, p):
    """Worst p-th percentile (ms) over every histogram named under
    ``prefix`` — the per-worker "storage p99" number."""
    from orion_tpu_torch.telemetry import histogram_percentile

    worst = None
    for name, hist in (histograms or {}).items():
        if not name.startswith(prefix) or not hist.get("count"):
            continue
        value = histogram_percentile(hist, p) * 1e3
        worst = value if worst is None else max(worst, value)
    return worst


def _host_device_ratio(histograms):
    """Mean ``producer.round`` / mean ``device.dispatch`` for one worker —
    the live wall-vs-device number next to the mem column.  The round
    CONTAINS the device window, so a healthy worker sits near 1.0 and the
    budget bar is ``1 + host_budget_factor()`` (orion_tpu_torch.hostbudget,
    the knob ``info`` reads too).  None when either histogram has no
    samples yet."""
    ratio = None
    round_hist = (histograms or {}).get("producer.round") or {}
    device_hist = (histograms or {}).get("device.dispatch") or {}
    round_count = int(round_hist.get("count", 0))
    device_count = int(device_hist.get("count", 0))
    if round_count > 0 and device_count > 0:
        round_mean = float(round_hist.get("sum", 0.0)) / round_count
        device_mean = float(device_hist.get("sum", 0.0)) / device_count
        if device_mean > 0:
            ratio = round(round_mean / device_mean, 2)
    return ratio


def _counter_sum(counters, *needles):
    """Sum every counter whose name contains one of ``needles`` (the
    reconnects counter is per-backend-prefixed: ``storage.network
    .reconnects``)."""
    total = 0
    found = False
    for name, value in (counters or {}).items():
        if any(needle in name for needle in needles):
            total += int(value)
            found = True
    return total if found else None


def snapshot_top(experiment, now=None):
    """One dashboard snapshot dict from the storage channels.

    ``workers`` merges the metrics-snapshot docs (rates, lags, p99s,
    retries) with each worker's LATEST health record (incumbent, GP fit,
    trust region); ``incumbent``/``regret_curve`` aggregate health records
    across the fleet in time order.  Round rate is derived from each
    worker's health-record timestamps (rounds per second over the window
    the records span), so a one-shot ``--json`` call needs no second poll.
    """
    now = time.time() if now is None else now
    storage = experiment.storage
    metrics_docs = storage.fetch_metrics(experiment)
    health_docs = storage.fetch_health(experiment)

    workers = {}
    for doc in metrics_docs:
        worker = str(doc.get("worker") or "?")
        counters = doc.get("counters") or {}
        gauges = doc.get("gauges") or {}
        histograms = doc.get("histograms") or {}
        rounds_hist = histograms.get("producer.round") or {}
        mem_bytes = gauges.get("memory.device_live_bytes")
        if mem_bytes is None:
            mem_bytes = gauges.get("memory.history_device_bytes")
        workers[worker] = {
            "rounds": int(rounds_hist.get("count", 0)),
            "round_rate": None,
            "heartbeat_lag_s": gauges.get("pacemaker.heartbeat_lag_s"),
            "storage_p99_ms": _merged_percentile(histograms, "storage.", 99),
            "retries": int(counters.get("storage.retries", 0)),
            "gave_up": int(counters.get("storage.gave_up", 0)),
            "reconnects": _counter_sum(counters, ".reconnects") or 0,
            "retraces": int(counters.get("cuda_graph.recaptures", 0)),
            # Compiler plane (orion_tpu_torch.compiler_plane): every CUDA
            # graph this worker captured — recaptures and prewarms.
            "compiles": int(counters.get("cuda_graph.captures", 0)),
            # Device-memory accounting (orion_tpu_torch.devmem): the
            # allocator's live bytes, falling back to the resident-history
            # gauge on a worker without a card.
            "mem_mb": (
                round(float(mem_bytes) / 1e6, 3) if mem_bytes is not None else None
            ),
            # Live wall-vs-device: mean producer round over mean device
            # window — the per-worker view of the bench's host-budget gate.
            "host_device_ratio": _host_device_ratio(histograms),
            "last_seen_s": round(now - float(doc.get("time") or now), 3),
            # Age of the last metrics flush specifically (last_seen_s is
            # min-merged with health below): the staleness signal.
            "metrics_age_s": round(now - float(doc.get("time") or now), 3),
            "health_age_s": None,
            "stale": None,
            "health": None,
        }

    by_worker = {}
    for doc in health_docs:
        by_worker.setdefault(str(doc.get("worker") or "?"), []).append(doc)
    curve = []
    best = None
    best_doc = None
    for doc in health_docs:  # already time-ordered
        y = doc.get("best_y")
        if y is None:
            continue
        best = y if best is None else min(best, y)
        best_doc = doc if best == y else best_doc
        curve.append(best)
    for worker, docs in by_worker.items():
        entry = workers.setdefault(
            worker,
            {
                "rounds": len(docs),
                "round_rate": None,
                "heartbeat_lag_s": None,
                "storage_p99_ms": None,
                "retries": 0,
                "gave_up": 0,
                "reconnects": 0,
                "retraces": 0,
                "compiles": 0,
                "mem_mb": None,
                "host_device_ratio": None,
                "last_seen_s": None,
                "metrics_age_s": None,
                "health_age_s": None,
                "stale": None,
                "health": None,
            },
        )
        latest = docs[-1]
        entry["health"] = {
            key: latest.get(key)
            for key in (
                "round",
                "n_obs",
                "best_y",
                "gp_mll",
                "gp_ls_mean",
                "gp_noise",
                "acq_ei_max",
                "q_unique_frac",
                "tr_length",
                "tr_succ",
                "tr_fail",
                "rung_occupancy",
                "model_tier",
                "algo",
                # Serve-gateway fields (orion_tpu_torch.serve): rounds produced
                # through a gateway report their coalesce width and the
                # gateway queue depth alongside the algorithm health.
                "serve_width",
                "serve_queue_depth",
                "serve_tenants",
            )
            if latest.get(key) is not None
        }
        entry["health_age_s"] = round(now - float(latest.get("time") or now), 3)
        entry["last_seen_s"] = round(
            now - float(latest.get("time") or now), 3
        )
        times = [float(d.get("time") or 0.0) for d in docs]
        window = max(times) - min(times)
        if len(docs) >= 2 and window > 0:
            entry["round_rate"] = round((len(docs) - 1) / window, 4)

    # Staleness: the freshest of the two flush channels is the worker's
    # liveness age; past 3× METRICS_FLUSH_INTERVAL the worker stopped
    # flushing (crash, hang, partition) and its MAX-merged gauges are
    # fossils — the marker says WHICH worker went quiet.
    for entry in workers.values():
        ages = [
            a for a in (entry["metrics_age_s"], entry["health_age_s"])
            if a is not None
        ]
        entry["flush_age_s"] = min(ages) if ages else None
        entry["stale"] = (
            entry["flush_age_s"] > STALE_AFTER
            if entry["flush_age_s"] is not None
            else None
        )

    # Doctor badge (orion_tpu_torch.diagnosis): the same joined channels
    # this snapshot already fetched, run through the diagnosis rule catalog
    # — the dashboard leads with the verdict, not just the raw numbers.
    doctor = _doctor_block(experiment, metrics_docs, health_docs, now)

    # Compiler-plane gauges, MAX-merged across workers (the headroom line
    # cares about the worst plan anywhere in the fleet).
    compiler = {}
    for doc in metrics_docs:
        for key, value in (doc.get("gauges") or {}).items():
            if key.startswith("compiler."):
                compiler[key] = max(compiler.get(key, 0.0), float(value))

    return {
        "experiment": experiment.name,
        "version": experiment.version,
        "time": now,
        "workers": workers,
        "incumbent": {
            "best_y": best,
            "round": best_doc.get("round") if best_doc else None,
            "worker": best_doc.get("worker") if best_doc else None,
        },
        "regret_curve": curve,
        "health_records": len(health_docs),
        "doctor": doctor,
        "compiler": compiler,
    }


def _doctor_block(experiment, metrics_docs, health_docs, now):
    """Evaluate the doctor rules over the docs the snapshot already
    fetched (no second storage pass per frame); degrades to None rather
    than ever failing a dashboard frame."""
    try:
        from orion_tpu_torch.diagnosis import Snapshot, run_rules
        from orion_tpu_torch.diagnosis.snapshot import probe_replication
        from orion_tpu_torch.telemetry import merge_snapshots

        snapshot = Snapshot(
            metrics=merge_snapshots(metrics_docs),
            per_worker=metrics_docs,
            health=health_docs,
            replication=probe_replication(experiment.storage),
            heartbeat=getattr(experiment, "heartbeat", None),
            stale_after=STALE_AFTER,
            now=now,
        )
        report = run_rules(snapshot)
        return {
            **report.summary(),
            "findings": [
                {
                    "rule": f.rule_id,
                    "severity": f.severity,
                    "message": f.message,
                }
                for f in report.findings
            ],
        }
    except Exception:  # pragma: no cover - a frame must render regardless
        return None


def doctor_badge(doctor):
    """One-line doctor verdict for the top/info headers."""
    if not doctor:
        return None
    if doctor["status"] == "ok":
        return "doctor: OK"
    rules = ", ".join(
        sorted({f["rule"] for f in doctor.get("findings") or ()})
    )
    return (
        f"doctor: {doctor['status'].upper()} "
        f"(critical: {doctor['critical']}, warn: {doctor['warn']}, "
        f"info: {doctor['info']}) [{rules}] — see `orion-tpu-torch doctor`"
    )


def render_top(snap):
    """Human frame for one snapshot."""
    lines = [
        f"orion-tpu-torch top — {snap['experiment']} v{snap['version']}   "
        f"workers: {len(snap['workers'])}   "
        f"health records: {snap['health_records']}"
    ]
    badge = doctor_badge(snap.get("doctor"))
    if badge:
        lines.append(badge)
    incumbent = snap["incumbent"]
    if incumbent["best_y"] is not None:
        lines.append(
            f"incumbent: {incumbent['best_y']:.6g} "
            f"(worker {incumbent['worker']}, round {incumbent['round']})"
        )
    if snap["regret_curve"]:
        lines.append(f"objective  {sparkline(snap['regret_curve'])}")
    lines.append("")
    from orion_tpu_torch.hostbudget import round_budget_factor

    budget = round_budget_factor()
    header = (
        f"{'worker':<24} {'rounds':>6} {'rate/s':>7} {'age':>7} {'hb lag':>7} "
        f"{'sto p99':>8} {'mem MB':>8} {'h/d':>6} {'cmpl':>5} {'retry':>5} "
        f"{'reconn':>6} {'best_y':>12} {'gp_mll':>8} {'tr_len':>6}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    stale_workers = []
    over_budget = []
    for worker, row in sorted(snap["workers"].items()):
        health = row.get("health") or {}

        def fmt(value, spec):
            return format(value, spec) if value is not None else "-"

        # `!` marks a stale worker: no metrics/health flush for 3× the
        # flush interval — its row is the last thing it said, not news.
        age = row.get("flush_age_s")
        age_cell = (fmt(age, "6.1f") + ("!" if row.get("stale") else " "))[:7]
        if row.get("stale"):
            stale_workers.append(worker)
        # `!` marks a worker whose mean round exceeds the host-budget bar
        # (1 + host_budget_factor(), same knob as the bench gate / DX004).
        ratio = row.get("host_device_ratio")
        breached = ratio is not None and ratio > budget
        ratio_cell = (fmt(ratio, "5.2f") + ("!" if breached else " "))[:6]
        if breached:
            over_budget.append(worker)
        lines.append(
            f"{worker:<24} {row['rounds']:>6} "
            f"{fmt(row['round_rate'], '7.2f'):>7} "
            f"{age_cell:>7} "
            f"{fmt(row['heartbeat_lag_s'], '6.1f'):>7} "
            f"{fmt(row['storage_p99_ms'], '7.1f'):>8} "
            f"{fmt(row.get('mem_mb'), '8.1f'):>8} "
            f"{ratio_cell:>6} "
            f"{row.get('compiles', 0):>5} "
            f"{row['retries']:>5} {row['reconnects']:>6} "
            f"{fmt(health.get('best_y'), '12.5g'):>12} "
            f"{fmt(health.get('gp_mll'), '8.3f'):>8} "
            f"{fmt(health.get('tr_length'), '6.3f'):>6}"
        )
    if stale_workers:
        lines.append(
            f"STALE (no flush for > {STALE_AFTER:g}s): "
            + ", ".join(stale_workers)
        )
    if over_budget:
        lines.append(
            f"HOST-BUDGET BREACH (round > {budget:g}x device window): "
            + ", ".join(over_budget)
        )
    # HBM-headroom line from the MAX-merged compiler.* gauges — the same
    # rendering `profile` leads with.
    from orion_tpu_torch.cli.profile import hbm_line

    headroom = hbm_line(snap.get("compiler") or {})
    if headroom:
        lines.append(headroom)
    return "\n".join(lines)


def render_fleet(snaps, serve_config=None):
    """The ``--all`` frame: one row per experiment — the operator's view of
    a gateway hosting many tenants (who is producing, who is stalled, where
    the fleet incumbents sit) without running N ``top`` processes."""
    header = (
        f"{'experiment':<28} {'workers':>7} {'records':>7} {'rounds':>6} "
        f"{'best_y':>12} {'retry':>5} {'reconn':>6}"
    )
    lines = [f"orion-tpu-torch top --all   experiments: {len(snaps)}"]
    from orion_tpu_torch.cli.base import describe_serve_fleet, describe_storage_topology

    # probe=True: the fleet header shows per-shard epoch + replication lag
    # (one tiny seq request per node per frame — the operator's first
    # question when a shard looks wrong is "who is primary and how far
    # behind are the replicas").
    topology = describe_storage_topology(probe=True)
    if topology is not None:
        # The fleet the table shows spans every shard (the router resolved
        # it); the header says so.
        lines.append(topology)
    # The serve plane gets the same treatment: one `fleet` probe per
    # gateway per frame (answered inline by the handler, so it renders
    # even when a member's dispatcher is saturated).
    gateways = describe_serve_fleet(serve_config)
    if gateways is not None:
        lines.append(gateways)
    lines += ["", header, "-" * len(header)]
    for snap in snaps:
        rounds = sum(row["rounds"] for row in snap["workers"].values())
        retries = sum(row["retries"] for row in snap["workers"].values())
        reconnects = sum(
            row["reconnects"] for row in snap["workers"].values()
        )
        best = snap["incumbent"]["best_y"]
        lines.append(
            f"{snap['experiment'] + ' v' + str(snap['version']):<28} "
            f"{len(snap['workers']):>7} {snap['health_records']:>7} "
            f"{rounds:>6} "
            f"{format(best, '12.5g') if best is not None else '-':>12} "
            f"{retries:>5} {reconnects:>6}"
        )
    if not snaps:
        lines.append("(no experiments in storage)")
    return "\n".join(lines)


def main(args):
    if getattr(args, "all", False):
        # Re-resolved EVERY frame: a fleet dashboard watching a gateway
        # must pick up experiments attached after it started.
        snapshot = lambda: [  # noqa: E731
            snapshot_top(e) for e in build_all_experiments(args)
        ]
        from orion_tpu_torch.cli.base import load_cli_config

        serve_config = load_cli_config(args).get("serve")
        render = lambda snaps: render_fleet(  # noqa: E731
            snaps, serve_config=serve_config
        )
        as_json = lambda snaps: {"experiments": snaps}  # noqa: E731
    else:
        experiment, _parser = build_from_args(
            args, need_user_args=False, allow_create=False, view=True
        )
        snapshot = lambda: snapshot_top(experiment)  # noqa: E731
        render = render_top
        as_json = lambda snap: snap  # noqa: E731
    if args.json:
        print(json.dumps(as_json(snapshot())))
        return 0
    frames = 0
    try:
        while True:
            # ANSI clear + home, one frame per interval.
            sys.stdout.write("\x1b[2J\x1b[H" + render(snapshot()) + "\n")
            sys.stdout.flush()
            frames += 1
            if args.iterations and frames >= args.iterations:
                return 0
            time.sleep(max(args.interval, 0.1))
    except KeyboardInterrupt:
        return 0
