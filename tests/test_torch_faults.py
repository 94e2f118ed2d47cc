"""The port's fault harness (``orion_tpu_torch/storage/faults.py`` and
``drive_chaos_experiment`` of ``orion_tpu_torch/testing.py``) against
``orion_tpu``'s: one ``FaultSchedule`` seed over one op stream injects the
same faults in both packages; ``FaultyDB`` on ``memory``, ``pickled`` and
``sqlite`` gives the reference's outcomes op for op; ``FaultProxy``'s modes
in front of a port server give the reference proxy's; the tiny seeded chaos
schedule completes on every backend with nothing duplicated and nothing
lost; a writer killed with SIGKILL mid-write leaves a ``pickled`` or
``sqlite`` store whole.

Every server binds port 0 and is stopped by the ``servers`` fixture; every
wait has a deadline."""

import os
import random
import signal
import subprocess
import sys
import time

import pytest
from test_torch_netdb import servers  # noqa: F401
from test_torch_storage import _op_sequence, _plain

from orion_tpu.storage import faults as ref_faults
from orion_tpu.storage.backends import PickledDB as RefPickledDB
from orion_tpu.storage.documents import MemoryDB as RefMemoryDB
from orion_tpu.storage.sqlitedb import SQLiteDB as RefSQLiteDB
from orion_tpu_torch.storage import faults
from orion_tpu_torch.storage.backends import PickledDB
from orion_tpu_torch.storage.base import DocumentStorage
from orion_tpu_torch.storage.documents import MemoryDB
from orion_tpu_torch.storage.netdb import NetworkDB
from orion_tpu_torch.storage.sqlitedb import SQLiteDB
from orion_tpu_torch.telemetry import TELEMETRY
from orion_tpu_torch.testing import drive_chaos_experiment
from orion_tpu_torch.utils.exceptions import DatabaseError, DuplicateKeyError
from torch_parity import isolated_telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": faults, "ref": ref_faults}

#: One pinned fault per class early in the run, seeded extras on top (the
#: reference chaos suite's tiny schedule).
TINY_PLAN = {3: "error", 8: "latency", 13: "reply_lost", 17: "kill"}
TINY_RATES = {"error": 0.03, "reply_lost": 0.02, "latency": 0.03, "kill": 0.02}
RETRY = {"max_attempts": 6, "base_delay": 0.005, "max_delay": 0.05, "deadline": 30.0}

SCHEDULES = [
    {"seed": 7, "plan": TINY_PLAN, "rates": TINY_RATES, "max_faults": 10},
    {"seed": 23, "rates": {"error": 0.08, "reply_lost": 0.05, "latency": 0.08,
                           "kill": 0.04}, "max_faults": 60},
    {"seed": 3, "plan": {0: "kill", 1: "kill", 5: "error"}, "rates": {"latency": 0.5}},
]


def _schedule(package, config):
    return PACKAGES[package].FaultSchedule(latency=0.0, **config)


@pytest.mark.parametrize("config", SCHEDULES, ids=["tiny", "soak", "deferred-kill"])
def test_schedule_draws_like_the_reference(config):
    """The same seed over the same op stream (batch ops and single ops
    mixed) draws the same fault at every index, defers a ``kill`` drawn on
    a single op to the next batch op, and stops at ``max_faults``."""
    rng = random.Random(config["seed"])
    stream = [(rng.choice(sorted(faults.FAULTABLE_OPS | faults.BATCH_OPS))) for _ in range(400)]
    port, ref = _schedule("port", config), _schedule("ref", config)
    got = [port.draw(op, op in faults.BATCH_OPS) for op in stream]
    want = [ref.draw(op, op in ref_faults.BATCH_OPS) for op in stream]
    assert got == want
    assert port.injected == ref.injected and port.op_count == ref.op_count == len(stream)
    assert port.total_injected == ref.total_injected > 0
    assert (faults.FAULT_KINDS, faults.FAULTABLE_OPS, faults.BATCH_OPS) == (
        ref_faults.FAULT_KINDS, ref_faults.FAULTABLE_OPS, ref_faults.BATCH_OPS)
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultSchedule(plan={0: "meteor"})


def _stores(backend, tmp_path):
    if backend == "memory":
        return MemoryDB(), RefMemoryDB(), None
    if backend == "pickled":
        return (PickledDB(str(tmp_path / "port.pkl")), RefPickledDB(str(tmp_path / "ref.pkl")),
                None)
    port, ref = SQLiteDB(str(tmp_path / "port.sqlite")), RefSQLiteDB(str(tmp_path / "ref.sqlite"))
    return port, ref, lambda: (port.close(), ref.close())


def _faulted(fn, *args):
    """The op's outcome, and for a raised error its type, message and
    ``maybe_applied`` mark."""
    try:
        return _plain(fn(*args))
    except Exception as exc:
        return ("raised", type(exc).__name__, str(exc), getattr(exc, "maybe_applied", None))


@pytest.mark.parametrize("backend", ["memory", "pickled", "sqlite"])
def test_faulty_db_matches_the_reference_op_for_op(tmp_path, backend):
    """One schedule seed wrapped around a port store and around the
    reference's store of the same backend: every op of a seeded sequence
    gives the same result or the same injected fault (raise-before-apply,
    applied-then-reply-lost, a latency spike, a mid-batch kill applying
    the first half), and the stores hold the same documents after each
    op.  The wrapper exposes exactly the inner store's batch primitives."""
    port_inner, ref_inner, close = _stores(backend, tmp_path)
    config = {"seed": 11, "plan": TINY_PLAN, "rates": TINY_RATES}
    port = faults.FaultyDB(port_inner, _schedule("port", config))
    ref = ref_faults.FaultyDB(ref_inner, _schedule("ref", config))
    try:
        for db in (port, ref):
            db.ensure_indexes([("trials", ["status"], False), ("trials", ["key"], True)])
        for primitive in ("apply_batch", "pipeline"):
            assert hasattr(port, primitive) == hasattr(port_inner, primitive) \
                == hasattr(ref, primitive)
        for step, (method, args) in enumerate(_op_sequence(5, n_ops=100)):
            got = _faulted(getattr(port, method), *args)
            want = _faulted(getattr(ref, method), *args)
            assert got == want, (step, method)
            assert port_inner.read("trials") == ref_inner.read("trials"), (step, method)
        assert port.faults_injected == ref.faults_injected
        assert all(port.faults_injected[kind] >= 1 for kind in faults.FAULT_KINDS), \
            port.faults_injected
        assert port.inner is port_inner
        assert getattr(port, "cheap_counts", None) == getattr(port_inner, "cheap_counts", None)
    finally:
        if close is not None:
            close()


def _batch(n, start=0):
    return [("write", ["docs", {"_id": start + i, "payload": "x" * 64}], {}) for i in range(n)]


def _proxy_run(package, server):
    """Each proxy mode in front of ``server``, driven by a port client:
    what reached the server, what the client saw, and the proxy's own
    counts."""
    proxy = PACKAGES[package].FaultProxy(*server.address)
    host, port = proxy.serve_background()
    client = NetworkDB(host=host, port=port, timeout=10.0, reconnect_jitter=0)
    out = []
    try:
        client.ensure_index("docs", ["_id"], unique=False)
        for mode, start in (("drop_request", 0), ("drop_reply", 10), ("cut_first_line", 20)):
            proxy.fail_next(mode)
            call = client.pipeline if mode == "cut_first_line" else client.apply_batch
            with pytest.raises(DatabaseError) as err:
                call(_batch(3, start))
            deadline = time.monotonic() + 5.0
            applied = server.db.read("docs", {"_id": {"$gte": start, "$lt": start + 3}})
            while mode != "drop_request" and not applied and time.monotonic() < deadline:
                time.sleep(0.01)
                applied = server.db.read("docs", {"_id": {"$gte": start, "$lt": start + 3}})
            if mode == "drop_reply":
                # The whole line reached the server: wait until it applied.
                while len(applied) < 3 and time.monotonic() < deadline:
                    time.sleep(0.01)
                    applied = server.db.read("docs", {"_id": {"$gte": start, "$lt": start + 3}})
            resent = call(_batch(3, start))
            out.append((mode, err.value.maybe_applied, sorted(d["_id"] for d in applied),
                        [type(o).__name__ if isinstance(o, Exception) else "ok" for o in resent]))
        proxy.set_stall(0.05)
        t0 = time.monotonic()
        client.count("docs")
        stalled = time.monotonic() - t0 >= 0.05
        proxy.set_stall(0)
        proxy.drop_all()
        time.sleep(0.05)
        out.append(("drop_all", client.count("docs"), stalled))
        out.append(("fired", dict(sorted(proxy.faults_fired.items())),
                    proxy.connections_accepted >= 4,
                    proxy.connections_accepted - len(proxy._conns) <= proxy.connections_dropped))
        with pytest.raises(ValueError):
            proxy.fail_next("meteor")
    finally:
        client.close()
        proxy.stop()
    return out, client.reconnects


def test_fault_proxy_modes_against_a_port_server_match_the_reference(servers):
    """``drop_request`` (nothing applied, a resend applies once),
    ``drop_reply`` (applied, the reply lost: the resend is all duplicates),
    ``cut_first_line`` (exactly the first pipelined line applied), a stall
    and ``drop_all`` (the client reconnects): the port's proxy and the
    reference's give the same outcomes in front of port servers."""
    got, port_reconnects = _proxy_run("port", servers("port"))
    want, ref_reconnects = _proxy_run("ref", servers("port"))
    assert got == want
    assert got[0] == ("drop_request", True, [], ["ok", "ok", "ok"])
    assert got[1] == ("drop_reply", True, [10, 11, 12], ["DuplicateKeyError"] * 3)
    assert got[2] == ("cut_first_line", True, [20], ["DuplicateKeyError", "ok", "ok"])
    assert got[3] == ("drop_all", 9, True)
    assert port_reconnects == ref_reconnects >= 3


def test_fault_proxy_blackhole_times_out_and_refuses_a_dead_upstream(servers):
    server = servers("port")
    proxy = faults.FaultProxy(*server.address)
    host, port = proxy.serve_background()
    client = NetworkDB(host=host, port=port, timeout=0.5, reconnect_jitter=0)
    try:
        client.write("docs", {"_id": 1})
        proxy.set_blackhole(True)
        with pytest.raises(DatabaseError):
            client.count("docs")
        proxy.set_blackhole(False)
        proxy.drop_all()
        assert client.count("docs") == 1
        proxy.upstream_port = 1  # nothing listens there: each accept is refused
        proxy.drop_all()
        with pytest.raises(DatabaseError):
            client.count("docs")
    finally:
        client.close()
        proxy.stop()


def _chaos_storage(backend, tmp_path, schedule, start_server):
    if backend == "memory":
        return DocumentStorage(faults.FaultyDB(MemoryDB(), schedule), retry=RETRY), None, None
    if backend == "pickled":
        db = faults.FaultyDB(PickledDB(str(tmp_path / "chaos.pkl")), schedule)
        return DocumentStorage(db, retry=RETRY), None, None
    if backend == "sqlite":
        inner = SQLiteDB(str(tmp_path / "chaos.sqlite"))
        return DocumentStorage(faults.FaultyDB(inner, schedule), retry=RETRY), inner.close, None
    server = start_server("port", serve=False)
    server.db = faults.FaultyDB(server.db, schedule)
    server.serve_background()
    proxy = faults.FaultProxy(*server.address)
    host, port = proxy.serve_background()
    client = NetworkDB(host=host, port=port, timeout=10.0, idle_probe=0.05)
    return DocumentStorage(client, retry=RETRY), lambda: (client.close(), proxy.stop()), proxy


@pytest.mark.parametrize("backend", ["memory", "pickled", "sqlite", "network"])
def test_tiny_seeded_chaos_schedule_completes_on_every_backend(tmp_path, servers, backend):
    """The reference chaos suite's tiny schedule (one fault of each class
    pinned, seeded extras) through the port's ``drive_chaos_experiment``
    on a CPU ``random`` experiment: every class fires, retries absorb
    them, the experiment completes with no point duplicated and no
    observation lost, and the audit is clean; on ``network`` the proxy's
    scheduled drops force real reconnects."""
    with isolated_telemetry():
        TELEMETRY.enable()
        retries_before = TELEMETRY.counter_value("storage.retries")
        schedule = faults.FaultSchedule(seed=7, plan=dict(TINY_PLAN), rates=TINY_RATES,
                                        latency=0.005, max_faults=10)
        storage, close, proxy = _chaos_storage(backend, tmp_path, schedule, servers)
        try:
            exp, report = drive_chaos_experiment(
                storage, max_trials=9, seed=1, proxy=proxy,
                drop_every=4 if proxy is not None else 0, device="cpu")
            assert report.ok, report.summary()
            completed = exp.fetch_trials_by_status("completed")
            trials = exp.fetch_trials()
            assert len(completed) >= 9 and all(t.objective is not None for t in completed)
            assert len({t.hash_params for t in trials}) == len(trials)
            for kind in faults.FAULT_KINDS:
                assert schedule.injected[kind] >= 1, schedule.injected
            assert TELEMETRY.counter_value("storage.retries") > retries_before
            if proxy is not None:
                assert storage.db.reconnects >= 1
        finally:
            if close is not None:
                close()


HAMMER = r"""
import sys
backend, path, base = sys.argv[1], sys.argv[2], int(sys.argv[3])
if backend == "pickled":
    from orion_tpu_torch.storage.backends import PickledDB as DB
else:
    from orion_tpu_torch.storage.sqlitedb import SQLiteDB as DB
print("ready", flush=True)
sys.stdin.readline()
db = DB(path)
i = base
while True:
    db.write("docs", {"seq": i, "payload": "x" * 256, "ok": True})
    i += 1
"""


def _open(backend, path):
    return PickledDB(path) if backend == "pickled" else SQLiteDB(path)


def _count(backend, path):
    db = _open(backend, path)
    count = db.count("docs")
    if backend == "sqlite":
        db.close()
    return count


@pytest.mark.parametrize("backend", ["pickled", "sqlite"])
def test_sigkill_mid_write_leaves_the_store_whole(tmp_path, backend):
    """A port writer killed with SIGKILL at three offsets into its write
    loop: each time the store reopens with every document whole, its unique
    index intact, and fresh writes accepted (the reference's crash test,
    on the port's stores).  The three writers import side by side and
    start writing one after another."""
    path = str(tmp_path / f"db.{backend}")
    db = _open(backend, path)
    db.ensure_index("docs", ["seq"], unique=True)
    db.write("docs", {"seq": -1, "payload": "x" * 256, "ok": True})
    if backend == "sqlite":
        db.close()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", HAMMER, backend, path,
                               str(round_ * 1_000_000)], env=env, stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, text=True) for round_ in range(3)]
    try:
        for round_, proc in enumerate(procs):
            assert proc.stdout.readline().strip() == "ready"
            before = _count(backend, path)
            proc.stdin.write("go\n")
            proc.stdin.flush()
            deadline = time.monotonic() + 60.0
            while _count(backend, path) <= before and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.02 + 0.07 * round_)
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
            db = _open(backend, path)
            docs = db.read("docs")
            assert len(docs) > before, "the writer never wrote"
            assert all(d["ok"] is True and d["payload"] == "x" * 256 for d in docs)
            seqs = [d["seq"] for d in docs]
            assert len(seqs) == len(set(seqs))
            with pytest.raises(DuplicateKeyError):
                db.write("docs", {"seq": -1, "payload": "x" * 256, "ok": True})
            db.write("docs", {"seq": -100 - round_, "payload": "x" * 256, "ok": True})
            if backend == "sqlite":
                db.close()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
            proc.stdin.close()
            proc.stdout.close()
