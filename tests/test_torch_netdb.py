"""The port's network storage (``orion_tpu_torch.storage.netdb``) against
``orion_tpu.storage.netdb``: the wire byte for byte, clients and servers of
the two packages crossed in both directions, the HMAC handshake, the
storage protocol over the wire, snapshots and SQLite files crossing between
the packages, replication (ordered stream, seq stamps, snapshot resync,
quorum, adoption) and the server's spans.

Every server binds port 0 and is shut down by the ``servers`` fixture's
finalizer; every wait has a deadline."""

import json
import math
import pickletools
import socket
import sqlite3
import threading
import time

import numpy as np
import pytest
import torch
from test_torch_storage import _op_sequence, _outcome, _plain, _protocol_run

from orion_tpu.core.trial import Result as RefResult
from orion_tpu.core.trial import Trial as RefTrial
from orion_tpu.core.trial import TrialBatch as RefTrialBatch
from orion_tpu.storage import netdb as ref_netdb
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu.utils import exceptions as ref_exc
from orion_tpu_torch.core.trial import Result, Trial, TrialBatch
from orion_tpu_torch.storage import netdb
from orion_tpu_torch.storage.base import create_storage
from orion_tpu_torch.storage.netdb import NetworkDB
from orion_tpu_torch.utils import exceptions as exc
from torch_parity import isolated_telemetry

PACKAGES = {"port": netdb, "ref": ref_netdb}


def _wait_for(predicate, timeout=8.0, message="condition never held"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(message)


def _stop(server):
    try:
        server.shutdown()
    finally:
        server.server_close()


@pytest.fixture
def servers():
    """``start(package, **kwargs)``: a ``DBServer`` of ``"port"`` or
    ``"ref"`` on port 0, serving in the background; every server started
    is shut down at teardown."""
    started = []

    def start(package="port", serve=True, **kwargs):
        kwargs.setdefault("port", 0)
        server = PACKAGES[package].DBServer(**kwargs)
        started.append(server)
        if serve:
            server.serve_background()
        return server

    yield start
    stop_all(started)


def stop_all(started):
    """Shut servers down side by side (each waits out its accept loop's
    poll interval)."""
    def stop(server):
        try:
            _stop(server)
        except Exception:
            pass

    threads = [threading.Thread(target=stop, args=(server,)) for server in started]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(30.0)


def _client(server, package="port", **kwargs):
    kwargs.setdefault("reconnect_jitter", 0)
    kwargs.setdefault("timeout", 10.0)
    host, port = server.address
    return PACKAGES[package].NetworkDB(host=host, port=port, **kwargs)


# --- the wire, byte for byte ------------------------------------------------


def _wire_ops():
    """A request of every op the wire carries, documents holding NaN and
    infinities, nested values, an index spec and a batch."""
    nan_doc = {"_id": "n1", "experiment": "e", "status": "completed",
               "results": [{"name": "o", "type": "objective", "value": math.nan}],
               "params": {"x": math.inf, "y": -math.inf, "z": 0.1}}
    return [
        ("ping", [], {}),
        ("ensure_index", ["trials", ["experiment", "status"]], {"unique": False}),
        ("ensure_indexes", [[["trials", ["key"], True], ["experiments", ["name"], True]]], {}),
        ("index_information", ["trials"], {}),
        ("write", ["trials", nan_doc], {"query": None}),
        ("write", ["trials", [{"_id": f"t{i}", "experiment": "e", "status": "new",
                               "key": i, "params": {"x": i / 7}} for i in range(4)]],
         {"query": None}),
        ("write", ["trials", {"_id": "t0", "experiment": "e"}], {"query": None}),
        ("write", ["trials", {"key": 2, "_id": "dup"}], {"query": None}),
        ("read", ["trials"], {"query": {"experiment": "e"}, "projection": None}),
        ("read", ["trials"], {"query": {"status": {"$in": ["new"]}},
                              "projection": {"params.x": 1}}),
        ("read_and_write", ["trials", {"status": "new"}, {"status": "reserved"}], {}),
        ("read_and_write", ["trials", {"status": "nosuch"}, {"status": "x"}], {}),
        ("count", ["trials"], {"query": {"status": "new"}}),
        ("write", ["trials", {"$set": {"params.x": math.nan}}], {"query": {"_id": "t1"}}),
        ("batch", [[["write", ["trials", {"_id": "b1", "experiment": "e"}], {}],
                    ["write", ["trials", {"_id": "b1", "experiment": "e"}], {}],
                    ["read_and_write", ["trials", {"_id": "t2"}, {"status": "done"}], {}],
                    ["count", ["trials", {"experiment": "e"}], {}],
                    ["read", ["trials", {"_id": "n1"}], {"projection": {"results": 1}}]]],
         {}),
        ("batch", [[["ensure_index", ["trials", ["x"]], {}]]], {}),
        ("drop_index", ["trials", "key_1"], {}),
        ("remove", ["trials"], {"query": {"status": "reserved"}}),
        ("nosuch", [], {}),
        ("read", ["trials"], {"query": {"experiment": "e"}, "projection": None}),
    ]


def test_requests_encode_like_the_reference():
    """The port's request lines are the reference's: the same envelope and
    JSON, and a torch scalar or a numpy float32 in a document encodes as
    the Python float the reference would send for it."""
    for op, args, kwargs in _wire_ops():
        got = netdb._dumps(NetworkDB._wire_request(op, args, kwargs))
        want = ref_netdb._dumps(ref_netdb.NetworkDB._wire_request(op, args, kwargs))
        assert got == want, op
    values = np.float32([0.1, 0.5, 1e-8, 3.25])
    port_doc = {"a": torch.tensor(values[0]), "b": values[1], "c": torch.tensor(values),
                "d": np.int64(3), "e": torch.tensor(7), "f": torch.tensor(True)}
    ref_doc = {"a": float(values[0]), "b": float(values[1]),
               "c": [float(v) for v in values], "d": 3, "e": 7, "f": True}
    assert netdb._dumps(port_doc) == ref_netdb._dumps(ref_doc)
    assert netdb._dumps({"x": math.nan, "y": -math.inf}) == b'{"x": NaN, "y": -Infinity}\n'


def _raw_exchange(server, lines):
    sock = socket.create_connection(server.address, timeout=10.0)
    reader = sock.makefile("rb")
    try:
        out = []
        for line in lines:
            sock.sendall(line)
            out.append(reader.readline())
        return out
    finally:
        reader.close()
        sock.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_server_replies_byte_for_byte(servers, seed):
    """The same request lines to a reference server and to the port's give
    the same reply lines, byte for byte: every op of the wire, then a
    seeded op sequence (``update_many`` sent as the writes a client
    pipelines), with NaN and infinite values."""
    lines = [ref_netdb._dumps({"op": op, "args": args, "kwargs": kwargs})
             for op, args, kwargs in _wire_ops()]
    for method, args in _op_sequence(seed, n_ops=80):
        if method == "update_many":
            for query, data in args[1]:
                lines.append(ref_netdb._dumps({"op": "write", "args": [args[0], data],
                                               "kwargs": {"query": query}}))
        elif method == "apply_batch":
            lines.append(ref_netdb._dumps({"op": "batch", "args": [[list(o) for o in args[0]]],
                                           "kwargs": {}}))
        else:
            lines.append(ref_netdb._dumps({"op": method, "args": list(args), "kwargs": {}}))
    ref_replies = _raw_exchange(servers("ref"), lines)
    port_replies = _raw_exchange(servers("port"), lines)
    assert len(port_replies) == len(lines)
    for line, got, want in zip(lines, port_replies, ref_replies):
        assert got == want, line


def _client_run(client):
    """The seeded op sequence and every wire method through one client."""
    out = [_outcome(client.ensure_indexes, [("trials", ["key"], True)])]
    for method, args in _op_sequence(3, n_ops=90):
        out.append(_outcome(getattr(client, method), *args))
    nan_doc = {"_id": "nan", "experiment": "e9", "status": "completed",
               "objective": math.nan, "params": {"x": math.inf}}
    out.append(_outcome(client.write, "trials", nan_doc))
    out.append(json.dumps(client.read("trials", {"_id": "nan"})))
    out.append(_plain(client.pipeline([
        ("count", ["trials", {"experiment": "e9"}], {}),
        ("write", ["trials", dict(nan_doc)], {}),
        ("read_and_write", ["trials", {"_id": "nan"}, {"status": "broken"}], {}),
    ])))
    out.append(client.index_information("trials"))
    out.append(_outcome(client.drop_index, "trials", "key_1"))
    out.append(client.ping())
    out.append(json.dumps(sorted(client.read("trials", {}), key=lambda d: d["_id"]),
                          sort_keys=True))
    return out


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "ref"), ("ref", "port")])
def test_clients_and_servers_cross_packages(servers, client_pkg, server_pkg):
    """A client of one package against the other's server gives the
    replies, raised errors and final documents of the reference's client
    against the reference's server."""
    want = _client_run(_client(servers("ref"), "ref"))
    got = _client_run(_client(servers(server_pkg), client_pkg))
    assert got == want


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "ref"), ("ref", "port"),
                                                   ("port", "port")])
def test_handshake_crosses_packages_and_refuses_a_wrong_secret(servers, client_pkg,
                                                               server_pkg):
    errors = {"port": exc.AuthenticationError, "ref": ref_exc.AuthenticationError}
    secured = servers(server_pkg, secret="right")
    assert _client(secured, client_pkg, secret="right").count("trials") == 0
    with pytest.raises(errors[client_pkg], match="bad credentials"):
        _client(secured, client_pkg, secret="wrong").count("trials")
    with pytest.raises(errors[client_pkg], match="authentication required"):
        _client(secured, client_pkg).count("trials")  # no secret at all
    assert _client(secured, client_pkg).ping()  # ping stays open
    open_server = servers(server_pkg)
    with pytest.raises(errors[client_pkg], match="does not require authentication"):
        _client(open_server, client_pkg, secret="right").count("trials")


def test_storage_protocol_over_the_wire_matches_reference(servers):
    """The whole storage protocol through ``create_storage({"type":
    "network"})`` on a port server gives the reference's outcomes on a
    reference server; a round's lies ride one wire request."""
    def config(server):
        host, port = server.address
        return {"type": "network", "address": f"{host}:{port}", "secret": "s"}

    port_storage = create_storage(config(servers("port", secret="s")))
    got = _protocol_run(port_storage, Trial, Result, TrialBatch)
    want = _protocol_run(ref_create_storage(config(servers("ref", secret="s"))),
                         RefTrial, RefResult, RefTrialBatch)
    assert got == want
    requests = port_storage.db.wire_requests
    lies = [Trial(experiment="exp-id", params={"x": i / 10, "n": 9},
                  results=[{"name": "lie", "type": "lie", "value": 1.0}]) for i in range(8)]
    assert len(port_storage.register_lies(lies)) == 8
    assert port_storage.db.wire_requests == requests + 1


def test_network_addresses_and_secrets_resolve_like_the_reference(tmp_path, monkeypatch,
                                                                  servers):
    from orion_tpu.storage import base as ref_base
    from orion_tpu_torch.storage import base

    for config in ({"address": "10.0.0.1:1234"}, {"path": "10.0.0.1:1234"},
                   {"host": "10.0.0.1", "port": 1234, "path": "x.pkl"}, {"address": "h"},
                   {}):
        assert base._parse_network_address(config) == ref_base._parse_network_address(config)
    secret_file = tmp_path / "net.secret"
    secret_file.write_text("s3cret\n")
    monkeypatch.setenv("ORION_DB_SECRET_FILE", str(secret_file))
    assert base._resolve_network_secret({}) == ref_base._resolve_network_secret({}) == "s3cret"
    host, port = servers("port", secret="s3cret").address
    db = create_storage({"type": "netdb", "address": f"{host}:{port}"}).db
    assert (type(db), db.host, db.port, db.secret) == (NetworkDB, host, port, "s3cret")
    secret_file.write_text("")
    with pytest.raises(exc.DatabaseError, match="empty"):
        create_storage({"type": "network", "address": f"{host}:{port}"})


def test_the_client_reads_replies_past_the_request_cap(servers, monkeypatch):
    """A reply may pass the 64 MiB request cap (2048 q=1024 trials carrying
    their round's lineage read back at once are ~74 MB): either package's
    server writes the line, and the port's client reads it.  The cap is
    shrunk to 100 kB here."""
    monkeypatch.setattr(netdb, "_MAX_LINE", 100_000)
    monkeypatch.setattr(ref_netdb, "_MAX_LINE", 100_000)
    parents = [f"{i:032x}" for i in range(30)]
    for package in ("port", "ref"):
        client = _client(servers(package))
        for chunk in range(10):
            client.write("trials", [{"_id": f"t{chunk}-{i}", "experiment": "e",
                                     "parents": parents} for i in range(30)])
        docs = client.read("trials", {"experiment": "e"})
        assert len(docs) == 300 and len(netdb._dumps(docs)) > 3 * netdb._MAX_LINE
        assert client.count("trials") == 300


# --- persistence crossing between the packages ------------------------------


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_pickle_snapshots_cross_packages(servers, tmp_path, writer, reader):
    """A server's pickle snapshot holds plain documents (no torch object):
    the other package's server restarts from it with equal documents."""
    path = str(tmp_path / "snap.pkl")
    first = servers(writer, persist=path, persist_interval=0.05)
    client = _client(first, writer)
    client.write("trials", [{"_id": f"t{i}", "experiment": "e", "x": i / 3,
                             "y": math.nan if i == 1 else i} for i in range(5)])
    client.ensure_index("trials", ["experiment"])
    want = json.dumps(client.read("trials", {}))
    client.close()
    _stop(first)
    with open(path, "rb") as handle:
        names = {arg for _, arg, _ in pickletools.genops(handle.read())
                 if isinstance(arg, str)}
    assert not {name for name in names if "torch" in name and name != "orion_tpu_torch.storage.documents"}
    second = servers(reader, persist=path)
    assert json.dumps(_client(second, reader).read("trials", {})) == want


def test_sqlite_persist_keeps_the_partial_indexes_and_crosses_packages(servers, tmp_path):
    """``--persist x.sqlite`` backs the server with the port's SQLite store:
    its partial ``json_valid`` indexes are on the file, NaN documents write
    and read back, and the reference's server reopens the file."""
    path = str(tmp_path / "net.sqlite")
    server = servers("port", persist=path)
    client = _client(server)
    client.write("trials", [{"_id": f"t{i}", "experiment": "e", "status": "new",
                             "objective": math.nan if i % 2 else float(i)} for i in range(6)])
    assert client.read_and_write("trials", {"experiment": "e", "status": "new"},
                                 {"status": "reserved"})["_id"] == "t0"
    want = json.dumps(client.read("trials", {"experiment": "e"}))
    client.close()
    _stop(server)
    names = {row[0] for row in sqlite3.connect(path).execute(
        "SELECT name FROM sqlite_master WHERE type = 'index'")}
    assert {"docs_valid_experiment_status", "docs_nonstandard_json"} <= names
    ref_server = servers("ref", persist=path)
    assert json.dumps(_client(ref_server, "ref").read("trials", {"experiment": "e"})) == want


def test_reservations_stay_atomic_across_threads(servers, tmp_path):
    """Eight client threads reserving from one SQLite-persisted server claim
    every trial exactly once."""
    server = servers("port", persist=str(tmp_path / "r.sqlite"))
    _client(server).write("trials", [{"_id": f"t{i}", "experiment": "e", "status": "new"}
                                     for i in range(80)])
    claimed = []

    def worker():
        client = _client(server)
        while True:
            doc = client.read_and_write("trials", {"experiment": "e", "status": "new"},
                                        {"status": "reserved"})
            if doc is None:
                return
            claimed.append(doc["_id"])

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(30.0)
    assert sorted(claimed) == sorted(f"t{i}" for i in range(80))


# --- replication --------------------------------------------------------------


@pytest.mark.parametrize("primary_pkg,replica_pkg", [("port", "port"), ("port", "ref"),
                                                     ("ref", "port")])
def test_mutations_stream_in_order_and_stamp_seqs(servers, primary_pkg, replica_pkg):
    replica = servers(replica_pkg, replica=True)
    primary = servers(primary_pkg, replicate_to=[replica.address])
    writer = _client(primary)
    writer.write("trials", {"_id": "t1", "experiment": "e1", "v": 0})
    assert writer.seq_snapshot() == 1
    writer.write("trials", {"v": 1}, query={"_id": "t1"})
    writer.write("trials", {"v": 2}, query={"_id": "t1"})
    outcomes = writer.apply_batch([("write", ["trials", {"_id": "a", "experiment": "e1"}], {}),
                                   ("write", ["trials", {"_id": "a", "experiment": "e1"}], {})])
    assert isinstance(outcomes[1], exc.DuplicateKeyError)
    assert writer.seq_snapshot() == 4  # the whole batch is one log entry
    reader = _client(replica)
    _wait_for(lambda: len(reader.read("trials", {"experiment": "e1"})) == 2
              and reader.read("trials", {"_id": "t1"})[0]["v"] == 2,
              message="replica never converged")
    assert reader.seq_snapshot() == 4
    assert replica.seq_info()["replica"] is True


def test_replica_restart_and_log_overflow_resync_from_a_snapshot(servers, monkeypatch):
    """A replica that restarts empty converges; one that comes back behind
    a bounded log longer gone converges through a snapshot."""
    monkeypatch.setattr(netdb, "REPL_LOG_CAP", 4)
    replica = servers("port", replica=True)
    address = replica.address
    _stop(replica)
    primary = servers("port", replicate_to=[address])
    writer = _client(primary)
    for i in range(12):
        writer.write("trials", {"_id": f"t{i}", "experiment": "e"})
    assert len(primary._repl_log) == 4
    fresh = servers("port", host=address[0], port=address[1])
    reader = _client(fresh)
    _wait_for(lambda: len(reader.read("trials", {"experiment": "e"})) == 12,
              message="overflowed log never snapshot-resynced")
    assert fresh.seq_info()["seq"] == primary.seq_info()["seq"] == 12
    assert fresh.seq_info()["replica"] is True


def test_pushes_split_by_operations_so_big_batches_replicate(servers, monkeypatch):
    """Two batches a replica missed push one at a time: the reference cuts
    pushes at 256 entries, and two batches that together pass the line cap
    (here shrunk to 300 kB, at q=1024 with lineage two rounds are ~74 MB
    against 64 MiB) would make one line the replica drops, for good."""
    monkeypatch.setattr(netdb, "_MAX_LINE", 300_000)
    assert netdb._ReplicaLink._chunk([[1, "batch", [[["write"]] * 200], {}],
                                      [2, "batch", [[["write"]] * 200], {}],
                                      [3, "write", [], {}]]) == [
        [1, "batch", [[["write"]] * 200], {}]]
    replica = servers("port", replica=True)
    address = replica.address
    _stop(replica)
    primary = servers("port", replicate_to=[address])
    writer = _client(primary)
    parents = [f"{i:032x}" for i in range(30)]
    for round_ in range(2):
        outcomes = writer.apply_batch([
            ("write", ["trials", {"_id": f"r{round_}-{i}", "experiment": "e",
                                  "parents": parents}], {}) for i in range(200)])
        assert not any(isinstance(o, Exception) for o in outcomes)
    assert len(netdb._dumps(list(primary._repl_log))) > netdb._MAX_LINE
    fresh = servers("port", host=address[0], port=address[1], replica=True)
    _wait_for(lambda: fresh.seq_info()["seq"] == 2, message="replication stalled")
    assert _client(fresh).count("trials", {"experiment": "e"}) == 400


def test_primary_restart_resumes_sequence_numbering(servers, tmp_path):
    persist = str(tmp_path / "primary.pkl")
    replica = servers("port", replica=True)
    primary = servers("port", persist=persist, persist_interval=0.05,
                      replicate_to=[replica.address])
    port = primary.address[1]
    writer = _client(primary)
    for i in range(3):
        writer.write("trials", {"_id": f"t{i}", "experiment": "e"})
    _wait_for(lambda: replica.seq_info()["seq"] == 3)
    writer.close()
    _stop(primary)
    reborn = servers("port", serve=False, host="127.0.0.1", port=port, persist=persist,
                     replicate_to=[replica.address])
    assert reborn.seq_info()["seq"] == 3
    reborn.serve_background()
    _client(reborn).write("trials", {"_id": "t-after", "experiment": "e"})
    reader = _client(replica)
    _wait_for(lambda: len(reader.read("trials", {"experiment": "e"})) == 4)


def test_quorum_write_returns_only_after_the_replica_holds_it(servers):
    with isolated_telemetry() as (telemetry, *_):
        replica = servers("port", replica=True)
        primary = servers("port", replicate_to=[replica.address], quorum=1)
        writer = _client(primary)
        for i in range(5):
            writer.write("trials", {"_id": f"t{i}", "experiment": "e", "v": i})
            # No wait: the quorum gate already guaranteed delivery.
            assert replica.seq_info()["seq"] == i + 1
        writer.apply_batch([("write", ["trials", {"_id": "b", "experiment": "e"}], {})])
        assert replica.seq_info()["seq"] == 6
        assert primary.seq_info()["quorum"] == 1
        assert telemetry.snapshot()["histograms"]["storage.quorum.wait"]["count"] >= 6


def test_quorum_timeout_is_maybe_applied_and_telemetry_stays_async(servers):
    from orion_tpu_torch.storage.retry import is_transient

    probe = servers("port", serve=False)
    dead = probe.address
    _stop(probe)
    primary = servers("port", replicate_to=[dead], quorum=1, quorum_timeout=0.3)
    writer = _client(primary, timeout=5.0)
    with pytest.raises(exc.DatabaseError, match="quorum") as err:
        writer.write("trials", {"_id": "t1", "experiment": "e"})
    assert err.value.maybe_applied is True and is_transient(err.value)
    assert len(writer.read("trials", {"_id": "t1"})) == 1
    t0 = time.monotonic()
    writer.write("telemetry", {"_id": "m1", "experiment": "e"})
    writer.write("health", {"_id": "h1", "experiment": "e"})
    assert time.monotonic() - t0 < 0.25


def test_adopt_replica_is_idempotent_and_replicas_refuse(servers):
    survivor = servers("port", replica=True)
    primary = servers("port", replicate_to=[survivor.address])
    writer = _client(primary)
    for i in range(4):
        writer.write("trials", {"_id": f"t{i}", "experiment": "e"})
    fresh = servers("port", replica=True)
    addr = "%s:%s" % fresh.address
    assert primary.handle_adopt_replica({"address": addr}) == {
        "adopted": True, "existing": False, "epoch": 1}
    assert primary.handle_adopt_replica({"address": addr})["existing"] is True
    reader = _client(fresh)
    _wait_for(lambda: len(reader.read("trials", {"experiment": "e"})) == 4)
    assert fresh.handle_adopt_replica({"address": "127.0.0.1:1"})["adopted"] is False


def test_replica_refuses_client_mutations_with_the_not_primary_marker(servers):
    client = _client(servers("port", replica=True))
    with pytest.raises(exc.DatabaseError) as err:
        client.write("trials", {"_id": "t1", "experiment": "e"})
    assert err.value.not_primary is True and not getattr(err.value, "maybe_applied", False)
    with pytest.raises(exc.DatabaseError):
        client.apply_batch([("write", ["trials", {"_id": "t2"}], {})])
    assert client.read("trials", {}) == []


def test_promote_op_is_idempotent_and_survives_restart(servers, tmp_path):
    persist = str(tmp_path / "r.pkl")
    replica = servers("port", replica=True, persist=persist, persist_interval=0.05)
    client = _client(replica)
    assert client._call("promote", {"epoch": 3, "replicate_to": []})["promoted"] is True
    assert client._call("promote", {"epoch": 3, "replicate_to": []})["promoted"] is False
    assert client._call("promote", {"epoch": 2, "replicate_to": []})["epoch"] == 3
    client.write("trials", {"_id": "t1", "experiment": "e"})
    assert client.stamp_snapshot() == (1, 3)
    fenced = client._call("replicate", {"entries": [[1, "write", ["trials", {"_id": "z"}], {}]],
                                        "epoch": 2})
    assert fenced["fenced"] is True and client.count("trials") == 1
    client.close()
    _stop(replica)
    reborn = servers("port", serve=False, persist=persist)
    assert (reborn.seq_info()["epoch"], reborn.seq_info()["seq"]) == (3, 1)


# --- the server's spans ------------------------------------------------------


def test_server_spans_flush_under_the_server_experiment(servers):
    """With telemetry on, a request carrying a sampled trace context books
    a ``netdb.apply`` span on the server, flushed to its own store under
    ``__server__`` and parented at the client's span."""
    from orion_tpu_torch.telemetry import TELEMETRY
    from orion_tpu_torch.tracing import SERVER_EXPERIMENT

    with isolated_telemetry():
        server = servers("port")
        client = _client(server)
        with TELEMETRY.span("producer.round", root=True):
            client.write("trials", {"_id": "t", "experiment": "e"})
            client.apply_batch([("count", ["trials", {}], {})])
        server.flush_server_spans(force=True)
        spans = server.db.read("spans", {"experiment": SERVER_EXPERIMENT})
        assert [s["name"] for s in spans] == ["netdb.apply", "netdb.apply"]
        assert [s["args"]["op"] for s in spans] == ["write", "batch"]
        assert all(s["parent_span_id"] for s in spans)
        assert spans[0]["worker"].startswith("netdb:")
