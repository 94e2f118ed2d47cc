"""``orion-tpu-torch tsan -- <cmd>`` (``orion_tpu_torch/cli/tsan.py``)
against ``orion-tpu tsan``.

The same scenario — two threads writing one annotated cell with no
ordering, and a lock reached through an attribute-held object that the
static graph cannot see — run under each package's command reports the
same race (cell, kind), the same observed edge and the same ``LCK003``
finding, and exits 1.  The port's command also: refuses a missing command
(2), propagates a failing command's exit code over a clean report, merges
the reports of every process of the run, and runs a two-worker ``hunt`` of
``tpu_bo`` on the CPU with telemetry, the watchdog and the prewarmer on —
the CPU's rehearsal of ``chip_smoke.py``'s ``diagnosis`` (c) — with no
race, no cycle and no LCK003, every worker's GP rounds through the
annotated step-graph cache.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENARIO = """
import threading

import {package}  # noqa: F401 - the env hook enables the sanitizer
from {package}.analysis.sanitizer import TSAN

assert TSAN.enabled


class Store:
    def __init__(self):
        self._lock = threading.RLock()


class Server:
    def __init__(self):
        self._persist_lock = threading.Lock()
        self.db = Store()

    def flush(self):
        with self._persist_lock:
            with self.db._lock:
                pass


server = Server()
server.flush()

holder = {{}}


def racer():
    TSAN.write("cell.racy", holder)


threads = [threading.Thread(target=racer) for _ in range(2)]
for t in threads:
    t.start()
for t in threads:
    t.join()
"""


def _tsan(package, tmp_path, *args, timeout=180):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("ORION_TPU_TSAN", None)
    return subprocess.run([sys.executable, "-m", f"{package}.cli", "tsan", *args],
                          capture_output=True, text=True, timeout=timeout, env=env,
                          cwd=str(tmp_path))


def test_tsan_requires_a_command():
    from orion_tpu.cli import main as ref_main
    from orion_tpu_torch.cli import main

    for fn in (main, ref_main):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert fn(["tsan"]) == 2
        assert "no command given" in err.getvalue()


def test_race_and_runtime_only_edge_are_reported_as_the_reference(tmp_path):
    reports = {}
    for package in ("orion_tpu_torch", "orion_tpu"):
        script = tmp_path / f"scenario_{package}.py"
        script.write_text(textwrap.dedent(SCENARIO.format(package=package)))
        out = tmp_path / f"report_{package}.json"
        proc = _tsan(package, tmp_path, "--seed", "5", "--format", "json", "--out", str(out),
                     "--paths", str(script), "--", sys.executable, str(script))
        assert proc.returncode == 1, proc.stderr[-2000:]
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        assert json.load(open(out))["races"] == report["races"]
        reports[package] = report
    got, want = reports["orion_tpu_torch"], reports["orion_tpu"]
    for report in (got, want):
        assert report["command_returncode"] == 0 and report["seed"] == 5
        assert report["lock_order_cycles"] == []
    assert [(r["cell"].split("#")[0], r["kind"]) for r in got["races"]] == \
        [(r["cell"].split("#")[0], r["kind"]) for r in want["races"]] == \
        [("cell.racy", "write/write")]
    assert [(e["outer"], e["inner"]) for e in got["edges"]] == \
        [(e["outer"], e["inner"]) for e in want["edges"]] == \
        [("Server._persist_lock", "Store._lock")]
    assert [(f["rule"], f["line"], f["message"]) for f in got["cross_check"]["lck003"]] == \
        [(f["rule"], f["line"], f["message"]) for f in want["cross_check"]["lck003"]]
    assert [f["rule"] for f in got["cross_check"]["lck003"]] == ["LCK003"]
    assert got["processes"] == 1 and got["locks"] == {"Server._persist_lock": 1,
                                                      "Store._lock": 1}
    assert got["accesses"] == 2


@pytest.mark.parametrize("code,expected", [(0, 0), (3, 3)])
def test_clean_report_propagates_the_commands_exit_code(tmp_path, code, expected):
    """A clean run over the port's own tree: a cross-check block with no
    finding; the command's own failure is the exit code."""
    proc = _tsan("orion_tpu_torch", tmp_path, "--format", "json", "--", sys.executable, "-c",
                 f"import orion_tpu_torch, sys; sys.exit({code})")
    assert proc.returncode == expected, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["violations"] == 0 and report["command_returncode"] == code
    assert report["cross_check"] == {"unmodeled_edges": [], "confirmed_static_cycles": [],
                                     "lck003": []}


def test_a_command_that_never_imports_the_port_writes_no_report(tmp_path):
    proc = _tsan("orion_tpu_torch", tmp_path, "--", sys.executable, "-c", "pass")
    assert proc.returncode == 2 and "wrote no tsan report" in proc.stderr


USER_SCRIPT = """
import sys

from orion_tpu_torch.client import report_results

x = [float(v) for v in sys.argv[2::2]]
report_results([{"name": "objective", "type": "objective",
                 "value": sum((v - 0.3) ** 2 for v in x)}])
"""


def test_two_worker_hunt_with_watchdog_and_prewarmer_runs_clean(tmp_path):
    """``tsan -- hunt --n-workers 2`` of ``tpu_bo`` with ``prewarm``,
    ``telemetry: true`` and ``doctor_interval:``: every process of the
    run merges into one report — the two workers and each trial's user
    script — with no race, no lock-order cycle and no LCK003; the workers'
    step-graph cache, prewarmer, compiler plane, registry and doctor slot
    are among the annotated cells and instrumented locks."""
    import yaml

    script = tmp_path / "box.py"
    script.write_text(f"#!{sys.executable}\n" + USER_SCRIPT)
    script.chmod(0o755)
    config = tmp_path / "hunt.yaml"
    config.write_text(yaml.safe_dump({
        "telemetry": True, "doctor_interval": 1.0,
        "algorithms": {"tpu_bo": {"n_init": 8, "n_candidates": 256, "fit_steps": 2,
                                  "local_frac": 0.3, "prewarm": True}}}))
    priors = [f"-x{i}~uniform(0, 1)" for i in range(3)]
    proc = _tsan("orion_tpu_torch", tmp_path, "--seed", "1", "--format", "json", "--",
                 sys.executable, "-m", "orion_tpu_torch.cli", "hunt", "-n", "tsan-hunt", "-c",
                 str(config), "--storage-path", str(tmp_path / "hunt.sqlite"),
                 "--max-trials", "56", "--pool-size", "8", "--n-workers", "2",
                 "--device", "cpu", str(script), *priors, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["races"] == [] and report["lock_order_cycles"] == []
    assert report["cross_check"]["lck003"] == []
    assert report["cross_check"]["confirmed_static_cycles"] == []
    assert report["processes"] >= 2 + 56
    cells = {c.split("#")[0] for c in report["cells"]}
    assert {"StepGraphs._entries", "StepGraphs._pool", "Telemetry._metrics",
            "Telemetry._ring", "FlightRecorder._ring", "CompileRegistry._entries",
            "diagnosis._last_summary", "BucketPrewarmer._threads"} <= cells
    assert {"StepGraphs.lock", "Telemetry._lock", "FlightRecorder._lock",
            "CompileRegistry._lock", "watch._last_lock",
            "BucketPrewarmer._lock"} <= set(report["locks"])
