"""The port's trace export and analysis (``orion_tpu_torch.telemetry``'s
Chrome exporter, ``orion_tpu_torch.tracing``) and the storage channel the
workers flush through, against ``orion_tpu``'s; then the ``metrics``,
``trace`` and ``flight-record`` commands of both CLIs over one store.

Span records are injected from a numpy seed: several workers, traces with
parents inside and across tracks, links, server-track spans and device
spans.  ``chrome_trace_events``, ``attribute_traces``,
``summarize_attribution`` and ``format_attribution`` must be equal
(exact).  The channel's ``record_metrics``/``fetch_metrics``/
``record_spans`` (pruned at a small ``SPANS_CAP``)/``fetch_spans`` give the
same documents on ``memory`` and ``pickled`` as the reference's, and the
port's ``sqlite`` the same as its ``memory`` (NaN values included).  A
reference ``hunt`` with ``telemetry: true`` writes a ``pickled`` file; the
port's three commands over it print and write what the reference's do."""

import json
import time

import numpy as np
import pytest

from orion_tpu import telemetry as ref_telemetry
from orion_tpu import tracing as ref_tracing
from orion_tpu.cli import main as ref_main
from orion_tpu.storage.base import DocumentStorage as RefDocumentStorage
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu_torch import telemetry, tracing
from orion_tpu_torch.cli import main
from orion_tpu_torch.storage.base import DocumentStorage, create_storage
from test_torch_cli import _scripts
from torch_parity import isolated_telemetry

WORKERS = ("host-a:11", "host-b:11", "netdb:127.0.0.1:9", "gateway:g")
NAMES = ("producer.round", "storage.commit", "storage.reserve_trial", "device.dispatch",
         "netdb.apply", "serve.dispatch", "producer.suggest")


def _spans(seed, n=120):
    """Seeded span records as the storage channel returns them."""
    rng = np.random.default_rng(seed)
    spans, ids = [], []
    for i in range(n):
        span = {"name": str(rng.choice(NAMES)), "ts": float(1e9 + rng.uniform(0, 100)),
                "dur": float(rng.uniform(0, 0.5)), "pid": int(rng.integers(1, 4)),
                "tid": int(rng.integers(0, 3))}
        if rng.uniform() < 0.8:
            span["worker"] = str(rng.choice(WORKERS))
        if rng.uniform() < 0.5:
            span["args"] = {"count": int(rng.integers(0, 9))}
        if rng.uniform() < 0.8:
            trace = f"t{int(rng.integers(0, 6)):031d}"
            span["trace_id"] = trace
            span["span_id"] = f"s{i:015d}"
            if ids and rng.uniform() < 0.7:
                span["parent_span_id"] = str(rng.choice(ids))
            ids.append(span["span_id"])
        if rng.uniform() < 0.1 and ids:
            span["links"] = [{"trace_id": f"t{int(rng.integers(0, 6)):031d}",
                              "span_id": str(rng.choice(ids))}]
        spans.append(span)
    spans.append({})
    return spans


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chrome_trace_events_match_reference(seed):
    spans = _spans(seed)
    events = telemetry.chrome_trace_events(spans)
    assert events == ref_telemetry.chrome_trace_events(spans)
    phases = {e["ph"] for e in events}
    assert {"X", "M", "s", "f"} <= phases


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribution_matches_reference(seed):
    spans = _spans(seed)
    assert tracing.attribute_traces(spans) == ref_tracing.attribute_traces(spans)
    for root in (None, "producer.round"):
        assert (tracing.summarize_attribution(spans, root_name=root)
                == ref_tracing.summarize_attribution(spans, root_name=root))
        assert (tracing.format_attribution(spans, root_name=root)
                == ref_tracing.format_attribution(spans, root_name=root))
    assert tracing.format_attribution([]) == ref_tracing.format_attribution([])
    assert [tracing.is_server_span(s) for s in spans] == [
        ref_tracing.is_server_span(s) for s in spans]


def test_port_dispatch_span_books_to_the_client_host():
    """The port's ``suggest_step.dispatch`` wraps the eager round, which
    Python launches from the host: it is client-host time, as every host
    span is in the reference's attribution, and the device set is the
    reference's."""
    spans = [{"name": "producer.round", "ts": 0.0, "dur": 1.0, "trace_id": "t",
              "span_id": "r"},
             {"name": "suggest_step.dispatch", "ts": 0.1, "dur": 0.25, "trace_id": "t",
              "span_id": "d", "parent_span_id": "r"}]
    got = tracing.attribute_traces(spans)["t"]
    assert got["device_ms"] == 0.0
    assert got["client_host_ms"] == 1000.0
    assert got == ref_tracing.attribute_traces(spans)["t"]
    assert tracing.DEVICE_SPAN_NAMES == ref_tracing.DEVICE_SPAN_NAMES


def test_collect_distributed_spans_and_chrome_file_match_reference(tmp_path):
    spans = _spans(4)
    own = [s for s in spans if s and not tracing.is_server_span(s)]
    server = [s for s in spans if s and tracing.is_server_span(s)] + [
        {"name": "netdb.apply", "ts": 5.0, "trace_id": "elsewhere"}]

    class Store:
        def fetch_spans(self, experiment):
            return list(server if experiment == tracing.SERVER_EXPERIMENT else own)

    got = tracing.collect_distributed_spans(Store(), "exp")
    assert got == ref_tracing.collect_distributed_spans(Store(), "exp")
    assert all(s.get("trace_id") != "elsewhere" for s in got)
    paths = [telemetry.write_chrome_trace(str(tmp_path / "port.json"), got),
             ref_telemetry.write_chrome_trace(str(tmp_path / "ref.json"), got)]
    loaded = [json.load(open(p)) for p in paths]
    assert loaded[0] == loaded[1] and loaded[0]["displayTimeUnit"] == "ms"


# --- the storage channel -----------------------------------------------------


def _channel(storage, exp, seed):
    """Snapshots from two workers upserted twice each, then span batches
    past the cap; returns what the fetchers give, less the ids the backend
    made."""
    rng = np.random.default_rng(seed)
    for rep in range(2):
        for worker in ("w1", "w2"):
            storage.record_metrics(exp, {"counters": {"c": rep + 1}, "gauges": {"g": 0.5},
                                         "histograms": {}}, worker=worker)
    for batch in range(4):
        storage.record_spans(exp, [
            {"name": f"s{batch}", "ts": float(batch * 10 + i + rng.uniform()),
             "dur": 0.0, "pid": 1, "tid": 0, "args": {"i": i}} for i in range(5)])
    storage.record_spans(exp, [])

    def strip(docs):
        return [{k: v for k, v in d.items() if k != "_id"} for d in docs]

    return strip(storage.fetch_metrics(exp)), strip(storage.fetch_spans(exp))


@pytest.mark.parametrize("backend", ["memory", "pickled"])
def test_storage_channel_matches_reference(tmp_path, monkeypatch, backend):
    """Cap 10: each flush past it prunes to 9 by ``ts``, as the
    reference's does."""
    monkeypatch.setattr(DocumentStorage, "SPANS_CAP", 10)
    monkeypatch.setattr(RefDocumentStorage, "SPANS_CAP", 10)
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    out = []
    for name, create in (("port", create_storage), ("ref", ref_create_storage)):
        config = {"type": backend}
        if backend == "pickled":
            config["path"] = str(tmp_path / f"{name}.pkl")
        out.append(_channel(create(config), {"_id": "exp"}, 7))
    assert out[0] == out[1]
    metrics, spans = out[0]
    assert [(d["worker"], d["counters"]) for d in metrics] == [("w1", {"c": 2}), ("w2", {"c": 2})]
    assert len(spans) == 9 and [s["name"] for s in spans] == ["s2"] * 4 + ["s3"] * 5


def test_sqlite_channel_matches_memory_nan_included(tmp_path, monkeypatch):
    """The port's SQLite file against its memory store: the same documents
    and the same prune; a NaN ``ts`` and a NaN argument go through the
    ``json_valid`` partial indexes like any other document (the NaN-``ts``
    span is never below the cutoff, so it survives the prune on both)."""
    monkeypatch.setattr(DocumentStorage, "SPANS_CAP", 10)
    monkeypatch.setattr(time, "time", lambda: 99.0)
    nan_spans = [{"name": "nan-ts", "ts": float("nan"), "dur": 0.0},
                 {"name": "nan-arg", "ts": 0.5, "dur": 0.0, "args": {"v": float("nan")}}]
    out = []
    for config in ({"type": "memory"}, {"type": "sqlite", "path": str(tmp_path / "c.sqlite")}):
        storage = create_storage(config)
        storage.record_spans({"_id": "exp"}, nan_spans)
        metrics, spans = _channel(storage, {"_id": "exp"}, 8)
        out.append((metrics, sorted(json.dumps(s, sort_keys=True) for s in spans)))
    assert out[0] == out[1]
    names = [json.loads(s)["name"] for s in out[0][1]]
    assert "nan-ts" in names and "nan-arg" not in names and len(names) == 10


def test_read_only_view_reads_the_channel():
    from orion_tpu_torch.storage.base import ReadOnlyStorage

    storage = create_storage({"type": "memory"})
    storage.record_spans({"_id": "e"}, [{"name": "s", "ts": 1.0, "dur": 0.0}])
    view = ReadOnlyStorage(storage)
    assert [s["name"] for s in view.fetch_spans("e")] == ["s"] and view.fetch_metrics("e") == []
    with pytest.raises(AttributeError):
        view.record_spans


# --- the commands ------------------------------------------------------------


def _cli(fn, argv, capsys):
    rc = fn(argv)
    return rc, capsys.readouterr().out


def test_commands_read_a_reference_store_as_the_reference_does(tmp_path, capsys,
                                                               monkeypatch):
    """``orion-tpu hunt`` with ``telemetry: true`` over the functional
    black box on ``pickled``; the reference's ``metrics``, ``trace``
    (Chrome, JSONL, ``--attribute``) and ``flight-record`` first, then the
    port's over the same file (which it opens as
    ``convert.storage_from_jax`` does): the same exposition byte for byte,
    the same trace files and table, the same flight events."""
    monkeypatch.chdir(tmp_path)
    box, grid = _scripts(tmp_path)
    conf = tmp_path / "tel.yaml"
    conf.write_text("telemetry: true\nalgorithms:\n  grid_search: {n_values: 4}\n")
    db = str(tmp_path / "ref.pkl")
    with isolated_telemetry(False) as (_, _, ref_tel, ref_flight):
        rc, _ = _cli(ref_main, ["hunt", "-n", "tel", "--storage-path", db, "-c", str(conf),
                                "--max-trials", "6", box, "-x~uniform(-50, 50)"], capsys)
        assert rc == 0
        # The commands run as a fresh process would: nothing in the ring.
        ref_flight.clear()
        ref_tel.reset()
        outs = {}
        for name, fn in (("ref", ref_main), ("port", main)):
            base = ["-n", "tel", "--storage-path", db]
            outs[name] = {
                "metrics": _cli(fn, ["metrics", *base], capsys),
                "trace": _cli(fn, ["trace", *base, "--out", f"{name}.json", "--attribute"],
                              capsys),
                "jsonl": _cli(fn, ["trace", *base, "--out", f"{name}.jsonl", "--format",
                                   "jsonl"], capsys),
                "flight": _cli(fn, ["flight-record", *base, "--out", f"{name}-f.jsonl"],
                               capsys),
                "files": [open(f"{name}.json").read(), open(f"{name}.jsonl").read(),
                          [json.loads(line) for line in open(f"{name}-f.jsonl")]],
            }
    ref_out, port_out = outs["ref"], outs["port"]
    assert port_out["metrics"] == ref_out["metrics"] and port_out["metrics"][0] == 0
    assert "orion_tpu_storage_pickled_update_completed_trial_seconds_count 4" in \
        port_out["metrics"][1]
    for key in ("trace", "jsonl", "flight"):
        assert port_out[key][0] == ref_out[key][0] == 0
        assert port_out[key][1] == ref_out[key][1].replace("ref", "port")
    assert port_out["files"][:2] == ref_out["files"][:2]
    flight_ref, flight_port = ref_out["files"][2], port_out["files"][2]
    assert flight_port[1:] == flight_ref[1:] and flight_port[0]["type"] == "flight-record"
    assert {e["kind"] for e in flight_port[1:]} >= {"producer.round"}
    assert "producer.round" in port_out["trace"][1]


def test_port_hunt_with_telemetry_books_what_the_reference_hunt_books(tmp_path, capsys,
                                                                      monkeypatch):
    """The same grid hunt through both CLIs with ``telemetry: true``: the
    same counters, histograms (sample counts) and span names stored, and
    the port's three commands succeed over its own file."""
    monkeypatch.chdir(tmp_path)
    box, _ = _scripts(tmp_path)
    conf = tmp_path / "tel.yaml"
    conf.write_text("telemetry: true\nalgorithms:\n  grid_search: {n_values: 4}\n")
    booked = []
    with isolated_telemetry(False):
        for name, fn, create, extra in (("port", main, create_storage, ["--device", "cpu"]),
                                        ("ref", ref_main, ref_create_storage, [])):
            db = str(tmp_path / f"{name}.pkl")
            rc, out = _cli(fn, ["hunt", "-n", "tel", "--storage-path", db, *extra, "-c",
                                str(conf), "--max-trials", "6", box, "-x~uniform(-50, 50)"],
                           capsys)
            assert rc == 0 and "trials completed: 4" in out
            storage = create({"type": "pickled", "path": db})
            [exp] = storage.fetch_experiments({"name": "tel"})
            merged = telemetry.merge_snapshots(storage.fetch_metrics(exp["_id"]))
            booked.append((merged["counters"],
                           {k: v["count"] for k, v in merged["histograms"].items()},
                           sorted(s["name"] for s in storage.fetch_spans(exp["_id"]))))
        for command in (["metrics"], ["trace", "--out", "t.json", "--attribute"],
                        ["flight-record", "--out", "f.jsonl"]):
            rc, _ = _cli(main, [command[0], "-n", "tel", "--storage-path", "port.pkl",
                                *command[1:]], capsys)
            assert rc == 0
    assert booked[0] == booked[1]
    assert "producer.round" in booked[0][2] and booked[0][1]["storage.pickled.reserve_trial"]
