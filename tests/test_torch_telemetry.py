"""The port's telemetry registry (``orion_tpu_torch.telemetry``) against
``orion_tpu.telemetry``, and the hooks that record into it.

The same calls, made from a numpy seed, go to a registry of each package:
the snapshots must be equal key for key, histogram buckets, sums, minima
and maxima exact (both packages do the same float64 arithmetic in the same
order); ``histogram_percentile`` and ``merge_snapshots`` exact; span
records equal field for field once the two registries share their wall
anchor.  The disabled path records nothing and reaches no lock and no
clock.  Then the hooks: the same producer rounds through each package's
``ExperimentClient`` with telemetry on book the same counters, the same
histograms (names and sample counts; durations are wall-clock), the same
span tree and the same flight events; the retry policy, the pacemaker,
the lost-trial sweep, the history buffers and ``tpu_bo``'s dispatch span
book theirs."""

import threading
import time

import numpy as np
import pytest

from orion_tpu import telemetry as ref
from orion_tpu.core.pacemaker import TrialPacemaker as RefPacemaker
from orion_tpu.storage import retry as ref_retry
from orion_tpu_torch import telemetry
from orion_tpu_torch.algo.history import DeviceHistory
from orion_tpu_torch.core.pacemaker import TrialPacemaker
from orion_tpu_torch.storage import retry
from orion_tpu_torch.utils.exceptions import DatabaseError
from orion_tpu.utils.exceptions import DatabaseError as RefDatabaseError
from test_torch_producer import _client, _objective
from torch_parity import isolated_telemetry

NAMES = ("storage.commit", "producer.round", "a.b", "x")


def _mutations(seed, n=300):
    """A seeded sequence of ``(method, name, value)`` registry calls, the
    durations spread over every bucket (0, sub-microsecond, hours)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = rng.choice(["count", "set_gauge", "observe"])
        name = str(rng.choice(NAMES))
        if kind == "count":
            value = int(rng.integers(0, 5))
        elif kind == "set_gauge":
            value = float(rng.normal() * 10.0)
        else:
            value = float(10.0 ** rng.uniform(-8, 4)) * float(rng.integers(0, 2) or 1)
            if rng.uniform() < 0.05:
                value = 0.0
        out.append((str(kind), name, value))
    return out


def _apply(registry, mutations):
    for method, name, value in mutations:
        getattr(registry, method)(name, value)
    return registry


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_matches_reference_after_the_same_mutations(seed):
    muts = _mutations(seed)
    got = _apply(telemetry.Telemetry(enabled=True), muts).snapshot()
    want = _apply(ref.Telemetry(enabled=True), muts).snapshot()
    assert got == want
    assert len(got["histograms"]["x"]["buckets"]) == telemetry.N_BUCKETS == ref.N_BUCKETS


def test_bucket_edges_match_reference():
    seconds = [0.0, -1.0, 1e-7, 1e-6, 1.5e-6, 2e-6, 3.9e-3, 1.0, 86400.0, 1e9]
    seconds += list(10.0 ** np.random.default_rng(3).uniform(-7, 6, 200))
    assert [telemetry._bucket_of(s) for s in seconds] == [ref._bucket_of(s) for s in seconds]
    assert ([telemetry.bucket_upper_seconds(i) for i in range(telemetry.N_BUCKETS)]
            == [ref.bucket_upper_seconds(i) for i in range(ref.N_BUCKETS)])


def test_percentiles_and_merge_match_reference():
    """Exact: four workers' snapshots (one raw, three as storage documents
    with extra keys) merged, and every percentile of every merged
    histogram."""
    snaps = [_apply(ref.Telemetry(enabled=True), _mutations(seed)).snapshot()
             for seed in range(10, 14)]
    for i, snap in enumerate(snaps[1:]):
        snap.update(experiment="e", worker=f"host:{i}", time=float(i))
    merged = telemetry.merge_snapshots(snaps)
    assert merged == ref.merge_snapshots(snaps)
    assert merged["counters"]["x"] == sum(s["counters"].get("x", 0) for s in snaps)
    for hist in merged["histograms"].values():
        for p in (0, 1, 10, 50, 90, 99, 99.9, 100):
            assert (telemetry.histogram_percentile(hist, p)
                    == ref.histogram_percentile(hist, p))
    assert telemetry.histogram_percentile({"count": 0}, 50) == 0.0


def test_disabled_registry_records_nothing_and_touches_no_lock_or_clock(monkeypatch):
    """Off: one attribute check.  ``span()`` hands back the one shared null
    span, and no mutator takes the lock or reads the clock."""
    reg = telemetry.Telemetry(enabled=False)

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"disabled path touched {name}")

    lock = reg._lock
    reg._lock = Untouchable()
    monkeypatch.setattr(telemetry, "time", Untouchable())
    span = reg.span("producer.round", root=True)
    assert span is telemetry._NULL_SPAN and reg.span("x", args={"a": 1}) is span
    with span as entered:
        assert entered is span and entered.ctx is None
    reg.count("c")
    reg.set_gauge("g", 1.0)
    reg.observe("h", 0.5)
    reg.record_span("s", duration=1.0)
    reg.record_spans_batch([("s", 0.0, 1.0, None)])
    monkeypatch.undo()
    reg._lock = lock
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert reg.iter_spans() == [] and reg.drain_spans() == []


def _trace(registry):
    """Nested spans under a root: one ``with`` child, an explicit record
    inside it, a batch, and one record after the root closed."""
    with registry.span("producer.round", args={"k": 1}, root=True):
        with registry.span("storage.commit"):
            registry.record_span("storage.retry.backoff", duration=0.25,
                                 args={"op": "x", "attempt": 0}, histogram=False)
        registry.record_spans_batch([("producer.suggest", None, 0.5, {"count": 3})])
    registry.record_span("after", duration=0.125, args={"long": "z" * 300})


def test_span_tree_matches_reference():
    """The same nesting gives the same tree in both packages: names, args
    (long strings clamped), durations given explicitly, trace and parent
    links, and the histograms the spans feed."""
    reg, other = telemetry.Telemetry(enabled=True), ref.Telemetry(enabled=True)
    for r in (reg, other):
        _trace(r)
    got, want = reg.drain_spans(), other.drain_spans()

    def shape(records):
        by_id = {r["span_id"]: r["name"] for r in records if r.get("span_id")}
        return [(r["name"], r.get("args"), by_id.get(r.get("parent_span_id")),
                 "trace_id" in r, r["dur"] if r["name"] in ("after", "storage.retry.backoff")
                 else None) for r in records]

    assert shape(got) == shape(want)
    names = [r["name"] for r in got]
    assert names == ["storage.retry.backoff", "storage.commit", "producer.suggest",
                     "producer.round", "after"]
    root = got[3]
    assert "parent_span_id" not in root and all(
        r["trace_id"] == root["trace_id"] for r in got[:3])
    assert got[4]["args"]["long"] == "z" * 253 + "..."
    assert set(reg.snapshot()["histograms"]) == set(other.snapshot()["histograms"])
    assert telemetry.current_trace_context() is None and ref.current_trace_context() is None


def test_span_records_ring_and_drain_match_reference():
    """Records equal field for field with a shared wall anchor; a ring of
    8 wraps the same way; each record drains once."""
    regs = [telemetry.Telemetry(enabled=True, span_capacity=3),
            ref.Telemetry(enabled=True, span_capacity=3)]
    rng = np.random.default_rng(4)
    starts = np.cumsum(rng.uniform(0, 1, 20))
    drained = []
    for reg in regs:
        reg._anchor = 1.0e9
        assert reg._capacity == 8
        for i, start in enumerate(starts[:6]):
            reg.record_span(f"s{i}", start=float(start), duration=float(i) / 8, args={"i": i})
        first = reg.drain_spans()
        reg.record_spans_batch([(f"b{i}", float(s), 0.5, {"i": i})
                                for i, s in enumerate(starts[6:])])
        drained.append((first, reg.drain_spans(), reg.iter_spans(), reg.drain_spans(),
                        reg.snapshot()))
    assert drained[0] == drained[1]
    first, second, ring, again, _ = drained[0]
    assert [r["name"] for r in first] == [f"s{i}" for i in range(6)]
    assert [r["name"] for r in second] == [f"b{i}" for i in range(6, 14)]
    assert ring == second and again == []


@pytest.mark.parametrize("value,spans", [("1", ""), ("on", "3"), (" TRUE ", "100"),
                                         ("yes", "bad"), ("0", ""), ("off", "9")])
def test_env_switches_match_reference(monkeypatch, value, spans):
    monkeypatch.setenv("ORION_TPU_TELEMETRY", value)
    monkeypatch.setenv("ORION_TPU_TELEMETRY_SPANS", spans)
    got, want = telemetry.Telemetry(), ref.Telemetry()
    assert (got.enabled, got._capacity) == (want.enabled, want._capacity)


def test_external_counters_match_reference():
    class Owner:
        def __init__(self, n):
            self.txn_count = n

    owners = [Owner(3), Owner(4)]
    snaps = []
    for mod in (telemetry, ref):
        reg = mod.Telemetry(enabled=True)
        for owner in owners:
            reg.register_external_counter("storage.sqlite.txn_count", owner, "txn_count")
        reg.register_external_counter("storage.sqlite.txn_count", owners[0], "txn_count")
        reg.count("storage.sqlite.txn_count", 2)
        snaps.append(reg.snapshot()["counters"])
        reg.unregister_external_counter("storage.sqlite.txn_count", owners[1])
        snaps.append(reg.snapshot()["counters"])
    assert snaps[0] == snaps[2] == {"storage.sqlite.txn_count": 9}
    assert snaps[1] == snaps[3] == {"storage.sqlite.txn_count": 5}


# --- the hooks ---------------------------------------------------------------


def _producer_run(port, depth, speculative):
    """Three rounds of 6 through one package's client: 4 of each round's
    trials completed, 2 held a round."""
    client, storage = _client(port, depth, speculative)
    held = []
    for _ in range(3):
        trials = client.suggest(6)
        client.observe_all(trials[:4], [_objective(t.params) for t in trials[:4]])
        if held:
            client.observe_all(held, [_objective(t.params) for t in held])
        held = trials[4:]
    client.producer._flush_timings(force_metrics=True)
    return client, storage


def _telemetry_record(registry, flight, storage, exp_id):
    """What a run booked: counters, gauges, histogram sample counts, the
    span tree as (name, parent name, args) in record order, flight events
    as (kind, args), and the stored metrics and span documents."""
    snap = registry.snapshot()
    spans = storage.fetch_spans(exp_id)
    by_id = {s["span_id"]: s["name"] for s in spans if s.get("span_id")}
    return {
        "counters": snap["counters"],
        # The reference's gauges add the device-memory sampler's
        # (``memory.*``), which comes with the device plane.
        "gauges": sorted(k for k in snap["gauges"] if not k.startswith("memory.")),
        "histograms": {k: v["count"] for k, v in snap["histograms"].items()},
        "spans": [(s["name"], by_id.get(s.get("parent_span_id")), s.get("args"))
                  for s in spans if not s["name"].startswith("flight.")],
        "flight": [(s["name"], s.get("args")) for s in spans
                   if s["name"].startswith("flight.")],
        "metrics_docs": len(storage.fetch_metrics(exp_id)),
    }


@pytest.mark.parametrize("depth,speculative", [(1, False), (2, True)],
                         ids=["plain", "speculative"])
def test_producer_rounds_book_the_reference_telemetry(depth, speculative):
    """The same rounds through both packages with telemetry on: the same
    counters, histograms (sample counts), span tree (the producer's rounds
    as roots, storage ops nested, the speculative ring's
    ``device.dispatch``/``producer.speculative_dispatch``) and flight events
    (``producer.round`` with its round and count, ``trial.status``), all in
    storage after the final flush."""
    records = []
    with isolated_telemetry(True) as (tel, flight, ref_tel, ref_flight):
        for port in (True, False):
            client, storage = _producer_run(port, depth, speculative)
            reg, rec = (tel, flight) if port else (ref_tel, ref_flight)
            records.append(_telemetry_record(reg, rec, storage, client.experiment.id))
    got, want = records
    assert got == want
    names = {name for name, _, _ in got["spans"]}
    assert {"producer.round", "storage.commit", "producer.suggest",
            "storage.reserve_trials"} <= names
    assert ("storage.commit", "producer.round", {"backend": "memory"}) in got["spans"]
    assert [args for kind, args in got["flight"] if kind == "flight.producer.round"] == [
        {"round": i + 1, "registered": 6} for i in range(3)]
    if speculative:
        assert {"device.dispatch", "producer.speculative_dispatch"} <= names
    assert got["metrics_docs"] == 1 and got["histograms"]["storage.memory.reserve_trials"]


def test_producer_off_books_nothing():
    """Off: the same rounds leave no span, metric or flight document and
    an empty registry."""
    with isolated_telemetry(False) as (tel, flight, _, _):
        client, storage = _producer_run(True, 2, True)
        exp_id = client.experiment.id
        assert storage.fetch_spans(exp_id) == [] and storage.fetch_metrics(exp_id) == []
        assert tel.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
        assert tel.iter_spans() == [] and flight.events() == []


@pytest.mark.parametrize("failures,mode", [(2, "always"), (5, "always"), (1, "unapplied")])
def test_retry_books_the_reference_counters_spans_and_flight_events(failures, mode):
    """A storage op failing ``failures`` times under each package's policy
    (4 attempts, no sleep): the same outcome, ``storage.retries`` /
    ``storage.gave_up`` counters, backoff spans and flight events."""
    out = []
    with isolated_telemetry(True) as (tel, flight, ref_tel, ref_flight):
        for mod, error, reg, rec in ((retry, DatabaseError, tel, flight),
                                     (ref_retry, RefDatabaseError, ref_tel, ref_flight)):
            calls = []

            def op():
                calls.append(1)
                if len(calls) <= failures:
                    exc = error("flaky")
                    exc.maybe_applied = True
                    raise exc
                return "ok"

            policy = mod.RetryPolicy(seed=0, sleep=lambda s: None, deadline=None)
            try:
                result = policy.run(op, op="reserve_trial", mode=mode)
            except error:
                result = "gave up"
            out.append((result, len(calls), reg.snapshot()["counters"],
                        [(s["name"], s.get("args"), s["dur"]) for s in reg.drain_spans()],
                        [(e["kind"], e.get("args")) for e in rec.drain()]))
    assert out[0] == out[1]


def test_pacemaker_books_the_reference_gauge_and_failed_beats():
    """Heartbeats that fail: each package's pacemaker sets the lag gauge
    and counts ``pacemaker.beats_failed``; stopping it ends the beats."""
    class Failing:
        def __init__(self, error):
            self.error, self.beats = error, 0

        def update_heartbeat(self, trial):
            self.beats += 1
            raise self.error("down")

    out = []
    with isolated_telemetry(True) as (tel, _, ref_tel, _):
        for cls, error, reg in ((TrialPacemaker, DatabaseError, tel),
                                (RefPacemaker, RefDatabaseError, ref_tel)):
            storage = Failing(error)
            beat = cls(storage, type("T", (), {"id": "t"})(), wait_time=0.01,
                       max_failed_beats=1000)
            beat.start()
            deadline = time.monotonic() + 10
            while storage.beats < 3 and time.monotonic() < deadline:
                time.sleep(0.01)
            beat.stop()
            beat.join(5)
            snap = reg.snapshot()
            out.append((set(snap["counters"]), set(snap["gauges"]),
                        snap["counters"]["pacemaker.beats_failed"] == storage.beats))
    assert out[0] == out[1] == ({"pacemaker.beats_failed"}, {"pacemaker.heartbeat_lag_s"},
                                True)


def test_lost_trial_sweep_counts_like_reference():
    """One reserved trial gone stale: the sweep counts itself and the
    recovered trial, as the reference's does."""
    out = []
    with isolated_telemetry(True) as (tel, _, ref_tel, _):
        for port, reg in ((True, tel), (False, ref_tel)):
            client, storage = _client(port, 1, False)
            trials = client.suggest(2)
            exp = client.experiment
            storage.db.write("trials", {"heartbeat": 0.0}, query={"_id": trials[0].id})
            reg.reset()
            exp.heartbeat = 1.0
            exp.fix_lost_trials()
            out.append(reg.snapshot()["counters"])
    assert out[0] == out[1] == {"experiment.lost_trial_sweeps": 1,
                                "experiment.lost_trials_recovered": 1}


def test_history_appends_count_donated_and_copied():
    """The device buffers' appends: a rebuild (first allocation, growth,
    copy-on-write after a clone) counts ``history.appends.copied``, an
    append into the resident buffers ``history.appends.donated``."""
    import copy

    with isolated_telemetry(True) as (tel, _, _, _):
        hist = DeviceHistory(2, device="cpu")
        rows = np.random.default_rng(5).uniform(size=(100, 2)).astype(np.float32)
        hist.append(rows[:10], rows[:10, 0])   # allocation: copied
        hist.append(rows[10:20], rows[10:20, 0])  # in place: donated
        clone = copy.deepcopy(hist)
        clone.append(rows[20:30], rows[20:30, 0])  # copy-on-write: copied
        hist.append(rows[30:100], rows[30:100, 0])  # growth past 64: copied
        hist.append(rows[:1], rows[:1, 0])  # donated
        assert tel.snapshot()["counters"] == {"history.appends.copied": 3,
                                              "history.appends.donated": 2}


def test_tpu_bo_dispatch_span_and_rows_unchanged_by_telemetry():
    """``tpu_bo`` on the CPU: a GP round with telemetry on books one
    ``suggest_step.dispatch`` span (``{"q", "n"}``) and returns the rows of
    the same round with it off, from one copy of the algorithm (exact)."""
    import copy

    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.space.dsl import build_space

    space = build_space({"x0": "uniform(0, 1)", "x1": "uniform(0, 1)"})
    algo = create_algo(space, {"tpu_bo": {"n_init": 4, "n_candidates": 256, "fit_steps": 3}},
                       seed=0, device="cpu")
    x = np.random.default_rng(6).uniform(size=(12, 2))
    algo.observe([{"x0": a, "x1": b} for a, b in x],
                 [{"objective": float(a + b)} for a, b in x])
    twin = copy.deepcopy(algo)
    with isolated_telemetry(False):
        off = algo.suggest_batch(5).cube
    with isolated_telemetry(True) as (tel, _, _, _):
        on = twin.suggest_batch(5).cube
        spans = tel.drain_spans()
    assert np.array_equal(off, on)
    assert [(s["name"], s["args"]) for s in spans] == [
        ("suggest_step.dispatch", {"q": 5, "n": 64})]


def test_sqlite_transactions_feed_the_txn_histogram(tmp_path):
    """Each ``BEGIN IMMEDIATE … COMMIT`` is one ``storage.sqlite.txn``
    sample, and the backend's ``txn_count`` is exported as a counter."""
    from orion_tpu_torch.storage.base import create_storage

    with isolated_telemetry(True) as (tel, _, _, _):
        storage = create_storage({"type": "sqlite", "path": str(tmp_path / "t.sqlite")})
        before = storage.db.txn_count
        tel.reset()
        storage.record_metrics({"_id": "e"}, {"counters": {"c": 1}})
        storage.record_spans({"_id": "e"}, [{"name": "s", "ts": 1.0, "dur": 0.0}])
        snap = tel.snapshot()
        assert snap["histograms"]["storage.sqlite.txn"]["count"] == storage.db.txn_count - before
        assert storage.db.txn_count > before
        del storage
        tel.reset()


def test_span_is_safe_across_threads():
    """Spans recorded from several threads land whole, each on its own
    thread's context."""
    reg = telemetry.Telemetry(enabled=True, span_capacity=4096)

    def work(i):
        for _ in range(50):
            with reg.span(f"t{i}", root=True):
                reg.count("n")

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = reg.drain_spans()
    assert len(spans) == 200 and reg.counter_value("n") == 200
    assert len({s["span_id"] for s in spans}) == 200
