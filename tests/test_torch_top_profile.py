"""The ``top`` and ``profile`` commands (``orion_tpu_torch/cli/top.py``,
``cli/profile.py``) against ``orion_tpu``'s on one store.

The store holds two workers' metrics snapshots, health records and
compiler-plane spans.  Each compiler-plane record is written twice, under the
reference's names (``jax.compiles``, ``jax.compile``, ``flight.jax.retrace``)
and under the port's (``cuda_graph.captures``, ``cuda_graph.capture``,
``flight.cuda_graph.recapture``), so each package reads its own: the
documents each renders must then be the same up to the names, the doctor's
block included (its findings' rules, severities and counts; the messages
name each package's counters)."""

import json

import pytest
from test_torch_migrate_ids import _seed

from orion_tpu.cli import main as ref_main
from orion_tpu.cli import top as ref_top
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu_torch.cli import main, top

@pytest.fixture(autouse=True)
def empty_registries():
    """The local registry block renders whatever this process captured:
    start each test from empty registries (they are process-wide)."""
    from orion_tpu import compiler_plane as ref_cp
    from orion_tpu_torch import compiler_plane as cp

    for registry in (cp.COMPILE_REGISTRY, ref_cp.COMPILE_REGISTRY):
        registry.reset()
    yield
    for registry in (cp.COMPILE_REGISTRY, ref_cp.COMPILE_REGISTRY):
        registry.reset()


HIST = {"buckets": [0] * 20 + [9] + [0] * 27, "count": 9, "sum": 0.009, "min": 1e-3,
        "max": 2e-3}
#: (reference name, port name) of each compiler-plane counter.
COUNTER_NAMES = [("jax.compiles", "cuda_graph.captures"),
                 ("jax.retraces", "cuda_graph.recaptures"),
                 ("jax.retraces.attributed", "cuda_graph.recaptures.attributed"),
                 ("jax.retraces.prewarm_covered", "cuda_graph.recaptures.prewarm_covered")]


def _spans(worker, t0):
    out = []
    for i, (kind, dur, signature) in enumerate((
            ("retrace", 0.6375, "fit_bucket=256 width=6 q=1024"),
            ("prewarm", 0.5, "fit_bucket=512 width=6 q=1024"),
            ("retrace", 0.41, "fit_bucket=512 width=6 q=16"))):
        for name, port_kind in (("jax.compile", kind),
                                ("cuda_graph.capture", {"retrace": "recapture"}.get(kind, kind))):
            out.append({"name": name, "worker": worker, "ts": t0 + i, "dur": dur,
                        "args": {"family": "fused_plan", "kind": port_kind,
                                 "signature": signature}})
    for name in ("flight.jax.retrace", "flight.cuda_graph.recapture"):
        out.append({"name": name, "worker": worker, "ts": t0 + 5.0, "dur": 0.0,
                    "args": {"family": "fused_plan", "changed": "fit_bucket 256→512",
                             "covered_by_prewarm": False,
                             "signature": "fit_bucket=512 width=6 q=16"}})
    return out


def _store(tmp_path):
    path = str(tmp_path / "top.sqlite")
    storage = ref_create_storage({"type": "sqlite", "path": path})
    exp_id = _seed(storage, name="top")
    for t0, (worker, lag, retries, scale) in enumerate((("host-a:1", 0.4, 2, 1.0),
                                                       ("host-b:2", 7.5, 11, 3.0))):
        counters = {"storage.retries": retries, "storage.network.reconnects": 1}
        for i, (ref_name, port_name) in enumerate(COUNTER_NAMES):
            counters[ref_name] = counters[port_name] = 3 - i
        gauges = {"pacemaker.heartbeat_lag_s": lag, "memory.device_live_bytes": 7.5e8 * scale,
                  "compiler.hbm_bytes_max": 7.1e8, "compiler.hbm_capacity_bytes": 8.5e10,
                  "compiler.hbm_bound_q": 122000}
        round_hist = dict(HIST, count=6, sum=0.6 * scale)
        storage.record_metrics(exp_id, {
            "counters": counters, "gauges": gauges,
            "histograms": {"producer.round": round_hist, "device.dispatch": dict(HIST),
                           "storage.sqlite.register_trials": HIST}}, worker=worker)
        storage.record_spans(exp_id, _spans(worker, 10.0 * t0))
    for i in range(6):
        worker = "host-a:1" if i % 2 == 0 else "host-b:2"
        storage.record_health(exp_id, {
            "algo": "tpubo", "round": i + 1, "n_obs": 8 * (i + 1), "best_y": 1.0 / (i + 1),
            "gp_mll": -0.2, "tr_length": 0.8, "q_unique_frac": 1.0, "mem_bytes": 7.5e8,
            "time": 100.0 + 2.0 * i}, worker=worker)
    return path


def _json(fn, argv, capsys):
    assert fn(argv) == 0
    return json.loads(capsys.readouterr().out)


def _doctor_verdict(doctor):
    """A doctor block less its findings' messages."""
    return dict(doctor, findings=[(f["rule"], f["severity"]) for f in doctor["findings"]])


def _mask_ages(snap):
    for row in snap["workers"].values():
        for key in ("last_seen_s", "metrics_age_s", "health_age_s", "flush_age_s"):
            row[key] = None
        row["stale"] = None
    snap.pop("time")
    return snap


def test_top_json_is_the_reference_snapshot(tmp_path, capsys):
    path = _store(tmp_path)
    argv = ["top", "-n", "top", "--storage-path", path, "--json"]
    got = _mask_ages(_json(main, argv, capsys))
    want = _mask_ages(_json(ref_main, argv, capsys))
    doctor = _doctor_verdict(got.pop("doctor"))
    assert doctor == _doctor_verdict(want.pop("doctor"))
    assert doctor["findings"] == [("DX004", "warn"), ("DX051", "warn")]
    assert got == want
    row = got["workers"]["host-b:2"]
    assert row["compiles"] == 3 and row["retraces"] == 2
    assert row["mem_mb"] == 2250.0 and row["host_device_ratio"] == 300.0


def test_top_all_json_and_frames(tmp_path, capsys):
    path = _store(tmp_path)
    argv = ["top", "--all", "--storage-path", path, "--json"]
    got = _json(main, argv, capsys)["experiments"]
    want = _json(ref_main, argv, capsys)["experiments"]
    assert [_mask_ages(dict(s, doctor=_doctor_verdict(s["doctor"]))) for s in got] == \
        [_mask_ages(dict(s, doctor=_doctor_verdict(s["doctor"]))) for s in want]
    assert main(["top", "-n", "top", "--storage-path", path, "--iterations", "1",
                 "--interval", "0.1"]) == 0
    frame = capsys.readouterr().out
    assert ref_main(["top", "-n", "top", "--storage-path", path, "--iterations", "1",
                     "--interval", "0.1"]) == 0
    ref_frame = capsys.readouterr().out
    lines = frame.splitlines()
    ref_lines = ref_frame.splitlines()
    assert lines[0].replace("orion-tpu-torch", "orion-tpu") == ref_lines[0]
    assert lines[1].replace("orion-tpu-torch", "orion-tpu") == ref_lines[1]
    assert lines[1].startswith("doctor: WARN (critical: 0, warn: 2, info: 0) [DX004, DX051]")
    # The table (ages masked), the budget breach and the memory line.
    strip = [line.split()[0:3] + line.split()[4:] for line in lines[4:7]]
    ref_strip = [line.split()[0:3] + line.split()[4:] for line in ref_lines[4:7]]
    assert strip == ref_strip
    assert lines[-2:] == ref_lines[-2:]
    assert lines[-2].startswith("HOST-BUDGET BREACH") and lines[-1].startswith("HBM: plan max")
    assert main(["top", "--all", "--storage-path", path, "--iterations", "1"]) == 0
    fleet = capsys.readouterr().out
    assert ref_main(["top", "--all", "--storage-path", path, "--iterations", "1"]) == 0
    assert fleet.replace("orion-tpu-torch", "orion-tpu") == capsys.readouterr().out


def test_sparkline_and_ratio_are_the_reference_functions():
    for values in ([], [1.0], [3, 2, 1, 0.5], list(range(100)), [None, 2.0, 1.0]):
        assert top.sparkline(values) == ref_top.sparkline(values)
    hists = {"producer.round": dict(HIST, count=4, sum=0.4),
             "device.dispatch": dict(HIST, count=8, sum=0.16)}
    assert top._host_device_ratio(hists) == ref_top._host_device_ratio(hists) == 5.0
    assert top._host_device_ratio({}) is None


def _renamed(rows, key="compile_ms"):
    out = []
    for row in rows:
        row = dict(row)
        if "capture_ms" in row:
            row[key] = row.pop("capture_ms")
        if row.get("kind") == "recapture":
            row["kind"] = "retrace"
        out.append(row)
    return out


def test_profile_json_is_the_reference_document(tmp_path, capsys):
    path = _store(tmp_path)
    argv = ["profile", "-n", "top", "--storage-path", path, "--json"]
    got = _json(main, argv, capsys)
    want = _json(ref_main, argv, capsys)
    assert _renamed(got["compiles"]) == want["compiles"]
    assert _renamed(got["retraces"]) == want["retraces"]
    assert len(got["compiles"]) == 6 and got["retraces"][0]["changed"] == "fit_bucket 256→512"
    assert got["gauges"] == want["gauges"]
    assert {port: got["counters"][port] for _, port in COUNTER_NAMES} == \
        {port: want["counters"][ref] for ref, port in COUNTER_NAMES}
    assert got["registry"] is None


def test_profile_tables_and_memory_line(tmp_path, capsys):
    path = _store(tmp_path)
    argv = ["profile", "-n", "top", "--storage-path", path]
    assert main(argv) == 0
    text = capsys.readouterr().out
    assert ref_main(argv) == 0
    ref_text = capsys.readouterr().out
    assert text.splitlines()[2] == ref_text.splitlines()[2]  # the HBM line
    assert "captures:" in text and "recapture attribution:" in text
    assert "fit_bucket 256→512" in text
    assert text.splitlines()[1] == ("cuda_graph.captures=6 cuda_graph.recaptures=4 "
                                    "cuda_graph.recaptures.attributed=2 "
                                    "cuda_graph.recaptures.prewarm_covered=0")


def test_profile_with_no_data_exits_1_and_capture_runs_the_analysis(tmp_path, capsys):
    path = str(tmp_path / "empty.sqlite")
    storage = ref_create_storage({"type": "sqlite", "path": path})
    _seed(storage, name="empty")
    assert main(["profile", "-n", "empty", "--storage-path", path]) == 1
    assert "no compiler-plane data" in capsys.readouterr().out
    trace_dir = str(tmp_path / "trace")
    assert main(["profile", "-n", "empty", "--storage-path", path, "--capture",
                 trace_dir, "--json", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out)["registry"]["analysis"] == {"analyzed": 0, "skipped": 0}
    assert "profile: wrote" in out.err


@pytest.mark.parametrize("command", ["top", "profile"])
def test_commands_are_registered(command, capsys):
    with pytest.raises(SystemExit):
        main([command, "--help"])
    assert "usage:" in capsys.readouterr().out


def test_profile_capture_refuses_to_trace_the_cpu_in_place_of_the_card(tmp_path, capsys):
    """``profile --capture`` traces the card unless ``--device cpu`` is
    given: where no card is present it exits 1 with ``resolve_device``'s
    error and writes no trace, and ``profiler_capture`` without a device
    raises; with ``--device cpu`` it writes one."""
    import os

    import torch

    from orion_tpu_torch.compiler_plane import profiler_capture

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device traces it")
    path = str(tmp_path / "empty.sqlite")
    _seed(ref_create_storage({"type": "sqlite", "path": path}), name="empty")
    trace_dir = tmp_path / "trace"
    argv = ["profile", "-n", "empty", "--storage-path", path, "--capture", str(trace_dir)]
    assert main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not trace_dir.exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiler_capture(str(trace_dir)):
            pass
    assert not trace_dir.exists()
    assert main(argv + ["--device", "cpu", "--json"]) == 0
    assert os.listdir(trace_dir) == [f"trace-{os.getpid()}.json"]
