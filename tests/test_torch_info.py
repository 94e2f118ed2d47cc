"""The port's ``info`` (``orion_tpu_torch/cli/info.py``) against
``orion_tpu``'s on the same stores: the experiment's sections, the
producer's timings, the merged telemetry snapshots with their host/device
ratio lines, the compiler digest (the port's CUDA-graph counters under the
reference's layout), the health records and the doctor's verdict print as
the reference prints them; ``info --all`` over a sharded plane leads with
the reference's topology line."""

import re
import time

import yaml
from test_torch_migrate_ids import _seed
from test_torch_netdb import servers  # noqa: F401

from orion_tpu.cli import main as ref_main
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu.telemetry import Telemetry as RefTelemetry
from orion_tpu_torch.cli import info, main
from orion_tpu_torch.storage.base import create_storage


def _sections(text):
    """``{title: body}`` of an ``info`` printout, ages (wall clock) masked."""
    text = re.sub(r"(age |last flush )[0-9.]+s", r"\1Ts", text)
    out = {}
    for match in re.finditer(r"\n([^\n]+)\n=+\n(.*?)(?=\n[^\n]+\n=+\n|\Z)", text, re.S):
        out[match.group(1)] = match.group(2)
    return out


#: The compiler plane's counters and gauges, the reference's name and the
#: port's, with one value each.
COMPILER_NAMES = [("jax.compiles", "cuda_graph.captures", 3),
                  ("jax.retraces", "cuda_graph.recaptures", 2),
                  ("jax.retraces.attributed", "cuda_graph.recaptures.attributed", 2),
                  ("jax.retraces.prewarm_covered", "cuda_graph.recaptures.prewarm_covered", 0)]
COMPILER_GAUGES = [("compiler.compile_ms_total", "compiler.capture_ms_total", 812.5),
                   ("compiler.hbm_bytes_max", "compiler.hbm_bytes_max", 7.1e8),
                   ("compiler.hbm_capacity_bytes", "compiler.hbm_capacity_bytes", 8.5e10),
                   ("compiler.hbm_bound_q", "compiler.hbm_bound_q", 122000)]


def _fill_channels(storage, exp_id):
    """Producer timings, two workers' metrics snapshots (with the round and
    device-window histograms of the host/device ratio, and the compiler
    plane's counters under both packages' names) and health records,
    written as the reference's producer writes them."""
    storage.record_timings(exp_id, [("suggest", 0.011, 4), ("observe", 0.002, 4),
                                    ("register", 0.004, 4), ("suggest", 0.013, 4)])
    for worker, scale in (("w1", 1.0), ("w2", 2.0)):
        telemetry = RefTelemetry(enabled=True)
        for k in range(5):
            telemetry.observe("storage.network.reserve_trial", 0.001 * scale * (k + 1))
        for k in range(4):
            telemetry.observe("producer.round", 0.05 * scale * (k + 1))
            telemetry.observe("device.dispatch", 0.03 * (k + 1))
        telemetry.count("storage.retries", int(scale))
        telemetry.set_gauge("pacemaker.heartbeat_lag_s", 0.5 * scale)
        for ref_name, port_name, value in COMPILER_NAMES:
            telemetry.count(ref_name, value)
            telemetry.count(port_name, value)
        for ref_name, port_name, value in COMPILER_GAUGES:
            telemetry.set_gauge(ref_name, value)
            telemetry.set_gauge(port_name, value)
        snapshot = telemetry.snapshot()
        storage.record_metrics(exp_id, snapshot, worker=worker)
        storage.record_health(exp_id, {"round": 3, "n_obs": 12, "best_y": 0.25 * scale,
                                       "gp_mll": -1.5, "q_unique_frac": 1.0,
                                       "time": time.time()}, worker=worker)


def test_info_prints_the_reference_sections(tmp_path, capsys):
    path = str(tmp_path / "db.sqlite")
    storage = ref_create_storage({"type": "sqlite", "path": path})
    exp_id = _seed(storage, name="inf")
    _fill_channels(storage, exp_id)
    argv = ["info", "-n", "inf", "--storage-path", path]
    outputs = []
    for fn in (main, ref_main):
        for extra in ([], ["--per-worker"]):
            assert fn(argv + extra) == 0
            outputs.append(capsys.readouterr().out)
    for port_text, ref_text in ((outputs[0], outputs[2]), (outputs[1], outputs[3])):
        port, ref = _sections(port_text), _sections(ref_text)
        for title in ("Commandline", "Config", "Algorithm", "Space", "Meta-data",
                      "Parent experiment", "Stats", "Performance", "Telemetry", "Health"):
            assert port[title] == ref[title], title
        # Each snapshot block ends with its host/device ratio line.
        blocks = port["Telemetry"].count("--- worker ") or 1
        assert port["Telemetry"].count("host/device ratio: ") == blocks
        assert "storage.network.reserve_trial: 10 samples" in outputs[0]
        renamed = (port["Compiler"].replace("recaptures", "retraces")
                   .replace("captures:", "compiles:").replace("capture time", "compile time")
                   .replace("orion-tpu-torch profile", "orion-tpu profile"))
        assert renamed == ref["Compiler"]
        assert port["Compiler"].startswith("captures: 6  recaptures: 4 (4 attributed, ")
        assert port["Doctor"].replace("orion-tpu-torch", "orion-tpu") == ref["Doctor"]
        assert port["Doctor"].startswith("doctor: ")
    assert "workers reporting: 2" in outputs[1] and "--- worker w2" in outputs[1]


def test_info_all_over_a_sharded_plane(tmp_path, capsys, servers):
    started = [servers("port") for _ in range(2)]
    stanza = ["%s:%s" % s.address for s in started]
    conf = tmp_path / "shards.yaml"
    conf.write_text(yaml.safe_dump({"storage": {"type": "network", "shards": stanza},
                                    "serve": {"address": "127.0.0.1:1"}}))
    storage = create_storage({"type": "network", "shards": stanza})
    for name in ("a", "b", "c"):
        _seed(storage, name=name, rounds=1)
    assert main(["info", "--all", "-c", str(conf)]) == 0
    out = capsys.readouterr().out
    assert ref_main(["info", "--all", "-c", str(conf)]) == 0
    ref_out = capsys.readouterr().out
    assert out.splitlines()[:2] == ref_out.splitlines()[:2]
    assert out.splitlines()[0].startswith("storage: 2 shard(s) [s0=")
    # Nothing listens on port 1: the serve fleet's probe renders it DOWN.
    assert out.splitlines()[1] == "serve: 1 gateway(s) [g0=127.0.0.1:1 DOWN]"
    assert [line for line in out.splitlines() if line.startswith("name: ")] == [
        "name: a", "name: b", "name: c"]
