"""The port's doctor (``orion_tpu_torch.diagnosis``, ``cli/doctor.py``)
against ``orion_tpu``'s.

- Every rule, DX001 to DX061: the reference's seeded-pathology snapshots
  (its ``tests/unit/test_doctor.py`` table, a firing and a quiet snapshot
  per rule) and random snapshots made from a numpy seed go through both
  packages' rules; the port's copy has the compiler plane's counters under
  the port's names (``cuda_graph.*`` for ``jax.*``).  The findings must be
  the same: id, severity, value and subject, in order.
- ``trend`` gives the same numbers to 1e-12 in float64; ``AlertDeduper``
  the same alerts over the same reports.
- ``doctor`` exits 0 healthy and 1 on a critical finding as the reference
  does; ``--watch`` publishes one alert over repeat passes.
- ``doctor_interval:`` starts the workon watchdog; unset or non-positive
  does not.  ``/healthz`` carries the doctor block; the findings gauges
  label their declared severities.
- A reference store carried across by ``convert.storage_from_jax``: both
  doctors give the same findings outside the rules that read the renamed
  compiler counters.
- DX001 on real rounds: ``tpu_bo`` through an ``ExperimentClient`` on the
  CPU, each round at a new q bucket, trips it in the process and in the
  store, and ``doctor`` exits 1 naming it.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import time

import numpy as np
import pytest
from test_torch_cli import _scripts
from torch_parity import isolated_telemetry

from orion_tpu import diagnosis as ref_diagnosis
from orion_tpu.cli import main as ref_main
from orion_tpu.diagnosis import trend as ref_trend
from orion_tpu.diagnosis import watch as ref_watch
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu_torch import diagnosis
from orion_tpu_torch.cli import main
from orion_tpu_torch.diagnosis import trend, watch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1_000_000.0

#: The reference's counter names and the port's (compiler_plane's table).
RENAMED = {"jax.compiles": "cuda_graph.captures",
           "jax.retraces": "cuda_graph.recaptures",
           "jax.retraces.attributed": "cuda_graph.recaptures.attributed",
           "jax.retraces.prewarm_covered": "cuda_graph.recaptures.prewarm_covered"}

#: Rules whose inputs carry a renamed counter.
READS_RENAMED = {"DX001", "DX050", "DX051", "DX052"}


def _reference_table():
    """The reference test module's ``FIXTURES``: rule id -> (firing, quiet)."""
    path = os.path.join(ROOT, "tests", "unit", "test_doctor.py")
    spec = importlib.util.spec_from_file_location("reference_test_doctor", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FIXTURES


REFERENCE = _reference_table()


def _port_snapshot(snap):
    """The port's Snapshot of a reference one: the same planes, counters
    renamed."""
    metrics = dict(snap.metrics)
    metrics["counters"] = {RENAMED.get(k, k): v for k, v in
                           (snap.metrics.get("counters") or {}).items()}
    return diagnosis.Snapshot(
        metrics=metrics, per_worker=snap.per_worker, health=snap.health, flight=snap.flight,
        replication=snap.replication, replication_series=snap.replication_series,
        heartbeat=snap.heartbeat, stale_after=snap.stale_after, now=snap.now)


def _findings(report):
    return [(f.rule_id, f.severity, f.value, f.subject) for f in report.findings]


@pytest.mark.parametrize("which", ["firing", "quiet"])
@pytest.mark.parametrize("rule_id", sorted(REFERENCE))
def test_reference_pathology_snapshots_give_the_reference_findings(rule_id, which):
    snap = REFERENCE[rule_id][0 if which == "firing" else 1]
    got = diagnosis.run_rules(_port_snapshot(snap))
    want = ref_diagnosis.run_rules(snap)
    assert _findings(got) == _findings(want)
    assert got.summary() == want.summary() and got.rule_counts == want.rule_counts
    fired = {f.rule_id for f in got.findings}
    if which == "firing":
        assert fired == {rule_id}
        assert {f.severity for f in got.findings} == {diagnosis.rule_severities()[rule_id]}
    else:
        assert rule_id not in fired


def test_catalog_is_the_reference_catalog():
    """Every rule of the reference, with its id, name, severity and runbook
    anchor; the descriptions of the rules reading the compiler plane speak
    of CUDA-graph captures, not of XLA."""
    got, want = diagnosis.doctor_catalog(), ref_diagnosis.doctor_catalog()
    assert [r[:4] for r in got] == [r[:4] for r in want]
    assert diagnosis.rule_severities() == ref_diagnosis.rule_severities()
    assert len(got) == 25 and set(REFERENCE) == {r[0] for r in got}
    for rule_id, _name, _sev, _runbook, description in got:
        if rule_id in READS_RENAMED:
            assert "captur" in description and "XLA" not in description
            assert "jax" not in description


def _random_snapshot(seed):
    """Every signal plane a rule reads, drawn so that each rule fires on
    some seeds and stays quiet on others: counters, gauges, histograms,
    a health series, worker flush times and a replication probe series."""
    rng = np.random.default_rng(seed)

    def maybe(p=0.6):
        return rng.uniform() < p

    counters = {}
    for name, high in (("storage.retries", 400), ("storage.gave_up", 2),
                       ("storage.network.reconnects", 60), ("storage.shard.reconnects", 30),
                       ("storage.shard.fenced_writes", 20), ("serve.backpressure", 40),
                       ("jax.compiles", 60), ("jax.retraces", 40),
                       ("jax.retraces.attributed", 40), ("jax.retraces.prewarm_covered", 2)):
        if maybe():
            counters[name] = int(rng.integers(0, high + 1))
    gauges = {}
    for name, low, high in (("pacemaker.heartbeat_lag_s", 0.0, 120.0),
                            ("serve.queue_depth", 0.0, 128.0),
                            ("serve.fleet.tenants.g0", 0.0, 20.0),
                            ("serve.fleet.tenants.g1", 0.0, 20.0),
                            ("serve.fleet.fenced_age_s", 0.0, 60.0),
                            ("storage.drain.phase_age_s", 0.0, 240.0),
                            ("storage.reprovision.in_progress", 0.0, 1.0),
                            ("compiler.hbm_bytes_max", 1e9, 16e9)):
        if maybe():
            gauges[name] = float(rng.uniform(low, high))
    if "compiler.hbm_bytes_max" in gauges:
        gauges["compiler.hbm_capacity_bytes"] = 16e9
    histograms = {}
    rounds = int(rng.integers(0, 40))
    for name, mean in (("producer.round", float(rng.uniform(0.001, 0.2))),
                       ("device.dispatch", float(rng.uniform(0.001, 0.1)))):
        if maybe(0.8):
            buckets = [0] * 48
            buckets[20] = rounds
            histograms[name] = {"buckets": buckets, "count": rounds, "sum": mean * rounds,
                                "min": mean, "max": mean}
    n = int(rng.integers(0, 30))
    flat = maybe(0.3)
    health = []
    for i in range(n):
        record = {"round": i + 1, "time": NOW - (n - i), "worker": f"w{i % 2}:1"}
        if maybe(0.9):
            record["best_y"] = float(1.0 if flat else 1.0 / (i + 1))
        if maybe(0.8):
            record["acq_ei_max"] = float(rng.choice([1e-10, 1e-3]))
        if maybe(0.8):
            record["q_unique_frac"] = float(rng.choice([0.2, 1.0]))
        if maybe(0.8):
            record["mem_bytes"] = float(1e8 * (1.0 + (0.2 * i if flat else 0.0)))
        if maybe(0.5):
            record["gp_mll"] = float(rng.choice([-1.5, math.nan, -0.3]))
        if maybe(0.5):
            record["gp_ls_max"] = float(rng.choice([1e-4, 0.5]))
        if maybe(0.3):
            record["mesh_devices"] = int(rng.integers(1, 5))
            record["mesh_util_max_frac"] = float(rng.uniform(0.1, 1.0))
        if maybe(0.2):
            record["serve_queue_depth"] = float(rng.uniform(0, 100))
        health.append(record)
    per_worker = [{"worker": f"w{k}:1", "time": NOW - float(rng.choice([1.0, 300.0]))}
                  for k in range(int(rng.integers(0, 4)))]
    series = []
    for _ in range(int(rng.integers(0, 5))):
        probe = []
        for index in range(2):
            entry = {"index": index, "primary": f"h:{7000 + index}",
                     "max_lag": int(rng.integers(0, 80)), "epoch": int(rng.integers(0, 2)),
                     "replicas": [{"address": f"r:{index}", **(
                         {"error": "down"} if maybe(0.2) else {})}]}
            if maybe(0.1):
                entry["error"] = "unreachable"
                entry.pop("max_lag")
            probe.append(entry)
        series.append(probe)
    return dict(metrics={"counters": counters, "gauges": gauges, "histograms": histograms},
                per_worker=per_worker, health=health, replication=series[-1] if series else None,
                replication_series=series or None, heartbeat=float(rng.choice([60.0, 120.0])),
                now=NOW)


@pytest.mark.parametrize("seed", range(24))
def test_random_snapshots_give_the_reference_findings(seed):
    kwargs = _random_snapshot(seed)
    want = ref_diagnosis.run_rules(ref_diagnosis.Snapshot(**kwargs))
    got = diagnosis.run_rules(_port_snapshot(ref_diagnosis.Snapshot(**kwargs)))
    assert [f for f in _findings(got) if not (isinstance(f[2], float) and math.isnan(f[2]))] \
        == [f for f in _findings(want) if not (isinstance(f[2], float) and math.isnan(f[2]))]
    assert [f.rule_id for f in got.findings] == [f.rule_id for f in want.findings]
    assert got.exit_code == want.exit_code


def test_random_snapshots_reach_every_rule():
    """The random table is not vacuous: across its seeds every rule but
    the engine's broken-rule marker fires at least once."""
    fired = set()
    for seed in range(24):
        kwargs = _random_snapshot(seed)
        fired |= {f.rule_id for f in diagnosis.run_rules(
            _port_snapshot(ref_diagnosis.Snapshot(**kwargs))).findings}
    assert len(fired) >= 18 and fired >= {"DX001", "DX002", "DX004", "DX020", "DX021",
                                          "DX040", "DX041", "DX043", "DX044", "DX050",
                                          "DX051", "DX052", "DX053"}


@pytest.mark.parametrize("seed", range(6))
def test_trend_detectors_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 3, 7, 12, 25):
        values = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 4) + rng.uniform(-1, 1)).tolist()
        for fn in ("robust_slope", "relative_change"):
            got, want = getattr(trend, fn)(values), getattr(ref_trend, fn)(values)
            assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
        assert trend.ewma(values) == pytest.approx(ref_trend.ewma(values), rel=1e-12) \
            if values else trend.ewma(values) is None


@pytest.mark.parametrize("seed", range(3))
def test_alert_dedup_gives_the_reference_alerts(seed):
    """A watch over a sequence of snapshots: each new finding alerts once,
    a persisting one stays quiet, a cleared one re-alerts on return."""
    rng = np.random.default_rng(100 + seed)
    seeds = rng.integers(0, 24, size=12)
    got_dedup, want_dedup = watch.AlertDeduper(), ref_watch.AlertDeduper()
    for s in seeds:
        kwargs = _random_snapshot(int(s))
        want = ref_diagnosis.run_rules(ref_diagnosis.Snapshot(**kwargs))
        got = diagnosis.run_rules(_port_snapshot(ref_diagnosis.Snapshot(**kwargs)))
        assert [f.fingerprint for f in got_dedup.new_findings(got.findings)] == \
            [f.fingerprint for f in want_dedup.new_findings(want.findings)]


def _seed_store(path, critical):
    """A SQLite store the reference wrote: one worker's counters and four
    health records (an exhausted retry policy when ``critical``)."""
    storage = ref_create_storage({"type": "sqlite", "path": path})
    exp = storage.create_experiment({"name": "doc-exp", "metadata": {"user": "u"}})
    counters = {"jax.retraces": 1, "cuda_graph.recaptures": 1}
    if critical:
        counters["storage.gave_up"] = 2
    storage.record_metrics(exp, {"counters": counters, "gauges": {}, "histograms": {}},
                           worker="w:1")
    for i in range(4):
        storage.record_health(exp, {"round": i + 1, "best_y": 1.0 / (i + 1),
                                    "time": 100.0 + i}, worker="w:1")
    return exp


def _cli(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("critical", [False, True])
def test_doctor_exits_as_the_reference(tmp_path, critical):
    path = str(tmp_path / "doctor.sqlite")
    _seed_store(path, critical)
    base = ["doctor", "-n", "doc-exp", "--storage-path", path]
    for extra in ([], ["--json"]):
        (rc, out), (ref_rc, ref_out) = _cli(main, base + extra), _cli(ref_main, base + extra)
        assert rc == ref_rc == int(critical)
        if extra:
            got, want = json.loads(out), json.loads(ref_out)
            assert [(f["rule"], f["severity"], f.get("value")) for f in got["findings"]] == \
                [(f["rule"], f["severity"], f.get("value")) for f in want["findings"]]
            assert {k: v for k, v in got.items() if k != "findings"} == \
                {k: v for k, v in want.items() if k != "findings"}
        else:
            assert out.replace("orion-tpu-torch", "orion-tpu") == ref_out
    rc, out = _cli(main, ["doctor", "--all", "--storage-path", path, "--json"])
    assert rc == int(critical) and json.loads(out)[0]["experiment"] == "doc-exp v1"


def test_doctor_watch_alerts_once_and_lists_the_catalog(tmp_path):
    path = str(tmp_path / "doctor.sqlite")
    _seed_store(path, critical=True)
    with isolated_telemetry(False):
        rc, out = _cli(main, ["doctor", "-n", "doc-exp", "--storage-path", path, "--watch",
                              "--json", "--iterations", "2", "-i", "0.5"])
    assert rc == 1
    passes = [json.loads(line) for line in out.splitlines()]
    assert [p["status"] for p in passes] == ["critical", "critical"]
    assert [[f["rule"] for f in p["experiments"][0]["findings"]] for p in passes] == \
        [["DX021"], ["DX021"]]
    storage = ref_create_storage({"type": "sqlite", "path": path})
    exp = storage.fetch_experiments({"name": "doc-exp"})[0]
    alerts = [s for s in storage.fetch_spans(exp) if s.get("name") == "flight.alert"]
    assert len(alerts) == 1 and alerts[0]["args"]["rule"] == "DX021"
    rc, out = _cli(main, ["doctor", "--list-rules"])
    ref_rc, ref_out = _cli(ref_main, ["doctor", "--list-rules"])
    assert rc == ref_rc == 0
    assert [line.split(":")[0] for line in out.splitlines() if line.startswith("DX")] == \
        [line.split(":")[0] for line in ref_out.splitlines() if line.startswith("DX")]
    watch._reset_last_summary()


def test_publish_report_sets_gauges_alerts_and_the_healthz_slot():
    """Publishing one report in each package: the same findings gauges
    (zeros clear), one ``flight.alert`` per new finding in the ring, the
    same ``/healthz`` summary, and an exposition whose every doctor sample
    carries its rule's declared severity."""
    from orion_tpu import metrics as ref_metrics
    from orion_tpu_torch import metrics

    firing = REFERENCE["DX021"][0]
    reports = (diagnosis.run_rules(_port_snapshot(firing)), ref_diagnosis.run_rules(firing))
    watch._reset_last_summary()
    ref_watch._reset_last_summary()
    try:
        with isolated_telemetry(True) as (tel, flight, ref_tel, ref_flight):
            watch.publish_report(reports[0], new_findings=reports[0].findings)
            ref_watch.publish_report(reports[1], new_findings=reports[1].findings)
            snap = tel.snapshot()
            assert snap["gauges"] == ref_tel.snapshot()["gauges"]
            assert snap["gauges"]["doctor.findings.DX021"] == 1.0
            alerts = [e["args"] for e in flight.events() if e["kind"] == "alert"]
            assert [dict(a, message=a["message"].replace("orion-tpu-torch", "orion-tpu"))
                    for a in alerts] == [e["args"] for e in ref_flight.events()
                                         if e["kind"] == "alert"]
            assert [a["rule"] for a in alerts] == ["DX021"]
            text = metrics.render_exposition(snap)
            assert text == ref_metrics.render_exposition(snap)
            assert 'severity="unknown"' not in text
            assert 'orion_tpu_doctor_findings{rule="DX021",severity="critical"} 1' in text
            got, want = diagnosis.doctor_summary(), ref_diagnosis.doctor_summary()
            assert got.pop("age_s") >= 0.0 and want.pop("age_s") >= 0.0
            assert got == want == reports[0].summary()
            healthz = metrics._worker_healthz()
            assert healthz["doctor"].pop("age_s") >= 0.0
            assert healthz == {"ok": True, "doctor": reports[0].summary()}
            watch._last_published -= watch.SUMMARY_TTL_S + 1.0
            stale = diagnosis.doctor_summary(evaluate_local=False)
            assert stale["status"] == "unknown" and stale["critical"] == 1
    finally:
        watch._reset_last_summary()
        ref_watch._reset_last_summary()


def test_local_snapshot_reads_the_process_registry():
    with isolated_telemetry(True) as (tel, _flight, _ref_tel, _ref_flight):
        tel.count("storage.gave_up", 3)
        report = diagnosis.run_rules(diagnosis.local_snapshot())
        assert [(f.rule_id, f.value) for f in report.findings] == [("DX021", 3)]


class _Exp:
    def __init__(self, storage, exp_id):
        self.storage = storage
        self.name = "doc-exp"
        self.version = 1
        self.id = exp_id
        self.heartbeat = 120.0


def test_watchdog_tick_publishes_and_dedups(tmp_path):
    from orion_tpu_torch.storage.base import create_storage

    path = str(tmp_path / "doctor.sqlite")
    exp = _seed_store(path, critical=True)
    storage = create_storage({"type": "sqlite", "path": path})
    with isolated_telemetry(True) as (_tel, flight, _ref_tel, _ref_flight):
        watch._reset_last_summary()
        try:
            watchdog = watch.DoctorWatchdog(_Exp(storage, exp["_id"]), interval=60.0)
            assert watchdog.tick().status == "critical"
            watchdog.tick()
            assert [e["args"]["rule"] for e in flight.events() if e["kind"] == "alert"] == \
                ["DX021"]
            assert diagnosis.doctor_summary()["status"] == "critical"
        finally:
            watch._reset_last_summary()


@pytest.mark.parametrize("raw,starts", [(None, False), ("", False), ("nope", False),
                                        ("0", False), ("-2", False), ("30", True)])
def test_watchdog_env_knob(monkeypatch, tmp_path, raw, starts):
    from orion_tpu_torch.storage.base import create_storage

    path = str(tmp_path / "doctor.sqlite")
    exp = _seed_store(path, critical=False)
    monkeypatch.delenv("ORION_TPU_DOCTOR_INTERVAL", raising=False)
    if raw is not None:
        monkeypatch.setenv("ORION_TPU_DOCTOR_INTERVAL", raw)
    experiment = _Exp(create_storage({"type": "sqlite", "path": path}), exp["_id"])
    got = watch.maybe_start_watchdog(experiment)
    assert (got is not None) == starts == (ref_watch.maybe_start_watchdog(experiment)
                                           is not None if not starts else True)
    if starts:
        try:
            assert got.interval == 30.0 and got._thread.is_alive()
        finally:
            got.stop()
        assert not got._thread.is_alive()


@pytest.mark.parametrize("interval", [None, 0, 0.5])
def test_doctor_interval_key_starts_the_watchdog_in_workon(tmp_path, capsys, monkeypatch,
                                                           interval):
    """``doctor_interval:`` in the ``-c`` YAML reaches
    ``ORION_TPU_DOCTOR_INTERVAL`` (so ``--n-workers`` children inherit it)
    and a positive value starts one watchdog in the worker loop, stopped at
    its end; unset or zero starts none."""
    import yaml

    started = []
    real_start = watch.DoctorWatchdog.start

    def start(self):
        started.append(self)
        return real_start(self)

    monkeypatch.setattr(watch.DoctorWatchdog, "start", start)
    monkeypatch.setenv("ORION_TPU_DOCTOR_INTERVAL", "placeholder")
    monkeypatch.delenv("ORION_TPU_DOCTOR_INTERVAL")
    box, _grid = _scripts(tmp_path)
    config = tmp_path / "doctor.yaml"
    config.write_text(yaml.safe_dump({"algorithms": {"random": {"seed": 1}},
                                      "doctor_interval": interval}))
    argv = ["hunt", "-n", "dr", "-c", str(config), "--storage-path", str(tmp_path / "dr.sqlite"),
            "--max-trials", "3", "--device", "cpu", box, "-x~uniform(-50, 50)"]
    assert main(argv) == 0
    capsys.readouterr()
    if interval is None:
        assert "ORION_TPU_DOCTOR_INTERVAL" not in os.environ
    else:
        assert os.environ["ORION_TPU_DOCTOR_INTERVAL"] == str(float(interval))
    if interval:
        [watchdog] = started
        assert watchdog.interval == 1.0 and not watchdog._thread.is_alive()
    else:
        assert started == []


def test_reference_store_carried_across_gives_the_reference_findings(tmp_path):
    """A pickled store the reference wrote (seeded counters, gauges and a
    health series) opened by ``convert.storage_from_jax``: both doctors'
    ``collect_snapshot`` over it give the same findings, the rules that
    read the renamed compiler counters aside."""
    from orion_tpu.core.experiment import build_experiment as ref_build_experiment
    from orion_tpu.diagnosis.snapshot import collect_snapshot as ref_collect
    from orion_tpu_torch.convert import storage_from_jax
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.diagnosis.snapshot import collect_snapshot

    path = str(tmp_path / "ref.pkl")
    storage = ref_create_storage({"type": "pickled", "path": path})
    ref_exp = ref_build_experiment(storage, "carried", priors={"x": "uniform(0, 1)"})
    kwargs = _random_snapshot(3)
    now = time.time()
    for worker in ("w0:1", "w1:1"):
        storage.record_metrics(ref_exp, dict(kwargs["metrics"]), worker=worker)
    for record in kwargs["health"]:
        storage.record_health(ref_exp, dict(record, time=now - 1.0), worker=record["worker"])
    port_storage = storage_from_jax(path)
    port_exp = build_experiment(port_storage, "carried")
    got = diagnosis.run_rules(collect_snapshot(port_exp, now=now))
    want = ref_diagnosis.run_rules(ref_collect(ref_exp, now=now))

    def outside(report):
        return [f for f in _findings(report) if f[0] not in READS_RENAMED
                and not (isinstance(f[2], float) and math.isnan(f[2]))]

    assert outside(got) == outside(want) and outside(got)


def test_signature_fork_on_real_rounds_is_dx001(tmp_path):
    """``tpu_bo`` through an ``ExperimentClient`` on the CPU with telemetry
    on, twelve GP rounds each at a q bucket or fit bucket no earlier round
    had: every round pays a capture the compiler plane books as a
    recapture, and writes one health record; DX001 fires critical over the
    process's registry and over the store, and ``doctor`` exits 1."""
    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.client.experiment import ExperimentClient
    from orion_tpu_torch.compiler_plane import COMPILE_REGISTRY
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.storage.base import create_storage

    import torch

    path = str(tmp_path / "fork.sqlite")
    COMPILE_REGISTRY.reset()
    STEP_GRAPHS.reset()
    with isolated_telemetry(True) as (tel, _flight, _ref_tel, _ref_flight), \
            contextlib.ExitStack() as cleanup:
        cleanup.callback(COMPILE_REGISTRY.reset)
        cleanup.callback(STEP_GRAPHS.reset)
        storage = create_storage({"type": "sqlite", "path": path})
        exp = build_experiment(
            storage, "fork", priors={f"x{i}": "uniform(0, 1)" for i in range(6)},
            max_trials=100000, pool_size=8,
            algorithms={"tpu_bo": {"n_init": 8, "n_candidates": 512, "fit_steps": 2,
                                   "local_frac": 0.3, "prewarm": False, "seed": 0}},
        ).instantiate(seed=0, device="cpu")
        client = ExperimentClient(exp, device="cpu")
        for q in [8] + [8, 16, 32, 64, 128] * 3:
            trials = client.suggest(q)
            cube = torch.as_tensor(exp.space.params_to_cube([t.params for t in trials]))
            client.observe_all(trials, hartmann6(cube).numpy().tolist())
            if tel.snapshot()["counters"].get("cuda_graph.recaptures", 0) >= 12:
                break
        client.producer._flush_timings(force_metrics=True)
        snapshot = diagnosis.local_snapshot(health=storage.fetch_health(exp))
        report = diagnosis.run_rules(snapshot)
        recaptures = tel.snapshot()["counters"]["cuda_graph.recaptures"]
    assert recaptures >= 10 and snapshot.rounds() >= 10
    assert len(storage.fetch_health(exp)) == snapshot.rounds()
    assert ("DX001", "critical") in [(f.rule_id, f.severity) for f in report.findings]
    rc, out = _cli(main, ["doctor", "-n", "fork", "--storage-path", path, "--json"])
    assert rc == 1 and "DX001" in [f["rule"] for f in json.loads(out)["findings"]]
