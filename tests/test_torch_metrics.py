"""The port's metrics export plane (``orion_tpu_torch.metrics``) against
``orion_tpu.metrics``: the Prometheus text of the same snapshots byte for
byte, the name and label escaping, and the worker's ``/metrics`` +
``/healthz`` server (the registry's exposition, ``{"ok": true}`` with the
doctor's summary block on a worker's server, the ephemeral-port fallback
for a second worker, and the ``metrics_port:`` key through the CLI
config).  The
snapshots come from seeded numpy sequences; every comparison is exact."""

import json
import os
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

from orion_tpu import metrics as ref
from orion_tpu import telemetry as ref_telemetry
from orion_tpu_torch import metrics, telemetry
from orion_tpu_torch.cli import base
from orion_tpu_torch.cli import build_parser
from torch_parity import isolated_telemetry

SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*",?)*\})? '
    r'(-?[0-9.eE+-]+|\+Inf)$')


def _snapshot(seed):
    """A snapshot with counters, gauges (a doctor findings gauge of an
    unknown rule among them), plain and per-tenant histograms, and names
    that need sanitizing."""
    rng = np.random.default_rng(seed)
    reg = ref_telemetry.Telemetry(enabled=True)
    names = ["storage.sqlite.txn", "producer.round", "9lives", "a-b c",
             'serve.tenant.t"1\\x\ny.request', "serve.tenant.plain.request"]
    for _ in range(200):
        name = str(rng.choice(names))
        kind = rng.integers(0, 3)
        if kind == 0:
            reg.count(name, int(rng.integers(1, 4)))
        elif kind == 1:
            reg.set_gauge(name, float(rng.normal()))
        else:
            reg.observe(name, float(10.0 ** rng.uniform(-7, 2)))
    reg.set_gauge("doctor.findings.NOSUCH1", 2.0)
    reg.set_gauge("pacemaker.heartbeat_lag_s", float("inf"))
    return reg.snapshot()


def parse(text):
    """Each line a ``# TYPE`` line or a sample; returns the samples."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            assert len(line.split()) == 4, line
            continue
        assert SAMPLE.match(line), line
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_matches_reference_byte_for_byte(seed):
    snap = _snapshot(seed)
    text = metrics.render_exposition(snap)
    assert text == ref.render_exposition(snap)
    samples = parse(text)
    assert 'orion_tpu_doctor_findings{rule="NOSUCH1",severity="unknown"}' in samples
    assert any(k.startswith("orion_tpu_serve_tenant_request_seconds_bucket{tenant=")
               for k in samples)
    assert any(k.startswith("orion_tpu__9lives") for k in samples)  # no leading digit


def test_merged_exposition_matches_reference():
    """Four workers' snapshots merged, then rendered: the same text, and the
    cumulative buckets end at the merged count."""
    snaps = [_snapshot(seed) for seed in range(5, 9)]
    merged = telemetry.merge_snapshots(snaps)
    text = metrics.render_exposition(merged)
    assert text == ref.render_exposition(ref_telemetry.merge_snapshots(snaps))
    samples = parse(text)
    count = merged["histograms"]["producer.round"]["count"]
    assert samples['orion_tpu_producer_round_seconds_bucket{le="+Inf"}'] == count
    assert samples["orion_tpu_producer_round_seconds_count"] == count


def test_doctor_rules_label_unknown_until_the_diagnosis_is_ported():
    """A known rule id labels with its declared severity in both packages
    (the name dates from when the port labelled every rule ``unknown``);
    an id no catalog knows still labels ``unknown``."""
    from orion_tpu.diagnosis import rule_severities as ref_rule_severities

    assert metrics._doctor_severities() == ref_rule_severities()
    snap = {"gauges": {"doctor.findings.DX021": 1.0, "doctor.findings.DX043": 0.0,
                       "doctor.findings.NOSUCH1": 2.0}}
    text = metrics.render_exposition(snap)
    assert text == ref.render_exposition(snap)
    assert text == ('# TYPE orion_tpu_doctor_findings gauge\n'
                    'orion_tpu_doctor_findings{rule="DX021",severity="critical"} 1\n'
                    'orion_tpu_doctor_findings{rule="DX043",severity="info"} 0\n'
                    'orion_tpu_doctor_findings{rule="NOSUCH1",severity="unknown"} 2\n')


@pytest.mark.parametrize("name", ["storage.sqlite.txn", "9x", "a-b.c d", "ok_1", ""])
def test_name_sanitizing_matches_reference(name):
    assert metrics.sanitize_name(name) == ref.sanitize_name(name)


@pytest.mark.parametrize("value", ['a"b', "back\\slash", "new\nline", "plain", 3])
def test_label_escaping_matches_reference(value):
    assert metrics.escape_label_value(value) == ref.escape_label_value(value)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read().decode()


def test_metrics_server_serves_the_registry_and_healthz():
    reg = telemetry.Telemetry(enabled=True)
    reg.count("storage.retries", 2)
    reg.observe("storage.sqlite.txn", 0.003)
    server = metrics.MetricsServer(port=0, registry=reg)
    server.start()
    try:
        status, ctype, body = _get(server.port, "/metrics")
        assert status == 200 and ctype == "text/plain; version=0.0.4; charset=utf-8"
        assert body == metrics.render_exposition(reg.snapshot())
        reg.observe("storage.sqlite.txn", 0.001)
        assert parse(_get(server.port, "/metrics?x=1")[2])[
            "orion_tpu_storage_sqlite_txn_seconds_count"] == 2
        status, ctype, body = _get(server.port, "/healthz")
        assert (status, ctype, json.loads(body)) == (200, "application/json", {"ok": True})
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(server.port, "/other")
        assert err.value.code == 404
    finally:
        server.stop()


def test_worker_server_from_env_enables_telemetry_and_falls_back(monkeypatch):
    """``ORION_TPU_METRICS_PORT`` starts one server a process, which turns
    the registry on; a second process finding the port taken (here a
    second start after the module's slot is cleared) takes an ephemeral
    one; no env, no server; a bad value is ignored."""
    taken = metrics.MetricsServer(port=0)
    taken.start()
    started = []
    with isolated_telemetry(False) as (tel, _, _, _):
        try:
            monkeypatch.setattr(metrics, "_worker_server", None)
            monkeypatch.delenv("ORION_TPU_METRICS_PORT", raising=False)
            assert metrics.ensure_worker_metrics_server() is None
            monkeypatch.setenv("ORION_TPU_METRICS_PORT", "nope")
            assert metrics.ensure_worker_metrics_server() is None
            monkeypatch.setenv("ORION_TPU_METRICS_PORT", str(taken.port))
            server = metrics.ensure_worker_metrics_server()
            started.append(server)
            assert server.port not in (0, taken.port) and tel.enabled
            assert metrics.ensure_worker_metrics_server() is server
            payload = json.loads(_get(server.port, "/healthz")[2])
            assert payload["ok"] is True
            assert set(payload["doctor"]) >= {"status", "critical", "warn", "info"}
            assert payload["doctor"]["status"] in ("ok", "warn", "critical", "unknown")
        finally:
            for server in started:
                server.stop()
            taken.stop()


def test_metrics_port_key_reaches_the_env_and_telemetry_key_switches_both(monkeypatch, tmp_path):
    """``telemetry: true`` switches the registry and the flight recorder on
    (``false`` off), ``metrics_port:`` lands in ``ORION_TPU_METRICS_PORT``
    for the children of ``--n-workers``, as the reference's CLI does; no
    server starts outside a worker loop."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    for on in (True, False):
        conf = tmp_path / f"c{on}.yaml"
        conf.write_text(f"telemetry: {str(on).lower()}\nmetrics_port: 9477\n")
        with isolated_telemetry(not on) as (tel, flight, _, _):
            monkeypatch.delenv("ORION_TPU_METRICS_PORT", raising=False)
            monkeypatch.setattr(metrics, "_worker_server", None)
            args = build_parser().parse_args(["status", "-n", "e", "-c", str(conf)])
            config = base.load_cli_config(args)
            assert config["telemetry"] is on and config["metrics_port"] == 9477
            assert tel.enabled is on and flight.enabled is on
            assert os.environ["ORION_TPU_METRICS_PORT"] == "9477"
            assert metrics._worker_server is None
