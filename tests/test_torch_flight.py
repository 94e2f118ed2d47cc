"""The port's flight recorder (``orion_tpu_torch.health``) against
``orion_tpu.health``: the same events, made from a numpy seed, recorded
with one injected clock into a recorder of each package give the same
ring (wrap included), the same drains and the same dump, line for line
(the reference's header adds its doctor's verdict, which comes with the
diagnosis package); the crash dump, the env switches, the span mirror
both ways, the disabled path, and a crashed worker loop's dump."""

import json
import os
import time

import numpy as np
import pytest

from orion_tpu import health as ref
from orion_tpu_torch import health
from torch_parity import isolated_telemetry

KINDS = ("producer.round", "storage.retry", "trial.status", "storage.gave_up")


class Clock:
    """``time.time`` stand-in: 1000.0, 1000.25, 1000.5, ..."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        self.now += 0.25
        return self.now


def _events(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = str(rng.choice(KINDS))
        args = None if rng.uniform() < 0.3 else {"round": i, "x": float(rng.normal())}
        out.append((kind, args))
    return out


def _record(recorder, events):
    for kind, args in events:
        recorder.record(kind, args)


def _read(path):
    with open(path) as handle:
        return [json.loads(line) for line in handle]


def _same_dump(got, want):
    """Header equal less the reference's ``doctor`` block; events equal."""
    assert {k: v for k, v in want[0].items() if k != "doctor"} == got[0]
    assert got[1:] == want[1:]


@pytest.mark.parametrize("seed,n", [(0, 5), (1, 20), (2, 1030)])
def test_ring_drain_and_dump_match_reference(monkeypatch, tmp_path, seed, n):
    recorders = [health.FlightRecorder(enabled=True, capacity=8),
                 ref.FlightRecorder(enabled=True, capacity=8)]
    out = []
    for recorder in recorders:
        monkeypatch.setattr(time, "time", Clock())
        events = _events(seed, n)
        _record(recorder, events[: n // 2])
        first = recorder.drain()
        _record(recorder, events[n // 2:])
        ring = recorder.events()
        second = recorder.drain()
        out.append((first, ring, second, recorder.drain()))
    assert out[0] == out[1]
    first, ring, second, again = out[0]
    assert len(ring) == min(8, n) and len(second) == min(8, n - n // 2) and again == []
    assert [e["kind"] for e in ring] == [k for k, _ in _events(seed, n)[-len(ring):]]
    extra = [{"kind": "audit.violation", "ts": 1.0, "args": {"check": "x"}}]
    dumps = []
    for name, recorder in zip(("port", "ref"), recorders):
        monkeypatch.setattr(time, "time", lambda: 5000.0)
        dumps.append(_read(recorder.dump(str(tmp_path / f"{name}.jsonl"), reason="on-demand",
                                         extra_events=extra)))
    _same_dump(*dumps)
    assert dumps[0][0] == {"type": "flight-record", "reason": "on-demand",
                           "host": dumps[0][0]["host"], "pid": os.getpid(), "time": 5000.0,
                           "events": len(ring) + 1, "enabled": True}
    for recorder in recorders:
        recorder.clear()
    assert recorders[0].events() == recorders[1].events() == []


def test_crash_dump_matches_reference(monkeypatch, tmp_path):
    """Off: no artifact.  On: ``flight-<name>-<pid>.jsonl`` in the given
    directory, the ring then the crash event (repr and traceback)."""
    assert health.FlightRecorder(enabled=False).dump_crash("w", ValueError(), str(tmp_path)) \
        is None
    assert os.listdir(tmp_path) == []
    try:
        raise RuntimeError("worker died")
    except RuntimeError as caught:
        exc = caught
    dumps = []
    for name, mod in (("port", health), ("ref", ref)):
        monkeypatch.setattr(time, "time", Clock())
        recorder = mod.FlightRecorder(enabled=True)
        _record(recorder, _events(3, 4))
        directory = tmp_path / name
        directory.mkdir()
        path = recorder.dump_crash("exp", exc, directory=str(directory))
        assert path == str(directory / f"flight-exp-{os.getpid()}.jsonl")
        dumps.append(_read(path))
    _same_dump(*dumps)
    crash = dumps[0][-1]
    assert crash["kind"] == "crash" and crash["args"]["error"] == "RuntimeError('worker died')"
    assert "worker died" in crash["args"]["traceback"] and dumps[0][0]["reason"] == "crash"


@pytest.mark.parametrize("env", [{}, {"ORION_TPU_FLIGHT": "1"}, {"ORION_TPU_TELEMETRY": "on"},
                                 {"ORION_TPU_FLIGHT": "0", "ORION_TPU_FLIGHT_EVENTS": "3"},
                                 {"ORION_TPU_FLIGHT": "yes", "ORION_TPU_FLIGHT_EVENTS": "64"},
                                 {"ORION_TPU_FLIGHT_EVENTS": "many"}])
def test_env_switches_match_reference(monkeypatch, env):
    for var in ("ORION_TPU_FLIGHT", "ORION_TPU_TELEMETRY", "ORION_TPU_FLIGHT_EVENTS"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    got, want = health.FlightRecorder(), ref.FlightRecorder()
    assert (got.enabled, got._capacity) == (want.enabled, want._capacity)
    assert health._env_enabled() == ref._env_enabled()


def test_span_mirror_matches_reference_both_ways(monkeypatch):
    """Events -> ``flight.*`` span records -> events, as stored docs carrying
    a worker label; non-flight spans are skipped on the way back."""
    monkeypatch.setattr(time, "time", Clock())
    recorder = health.FlightRecorder(enabled=True)
    _record(recorder, _events(4, 12))
    events = recorder.drain() + [None]
    spans = health.flight_events_as_spans(events)
    assert spans == ref.flight_events_as_spans(events)
    docs = [dict(s, worker="host:1") for s in spans] + [{"name": "storage.commit", "ts": 1.0}]
    back = health.spans_as_flight_events(docs)
    assert back == ref.spans_as_flight_events(docs)
    assert [{k: v for k, v in e.items() if k != "worker"} for e in back] == events[:-1]


def test_disabled_recorder_touches_no_lock_or_clock(monkeypatch):
    recorder = health.FlightRecorder(enabled=False)

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"disabled path touched {name}")

    lock = recorder._lock
    recorder._lock = Untouchable()
    monkeypatch.setattr(health, "time", Untouchable())
    recorder.record("producer.round", {"round": 1})
    monkeypatch.undo()
    recorder._lock = lock
    assert recorder.events() == [] and recorder.drain() == []


def test_crashed_worker_loop_leaves_a_flight_record(tmp_path, monkeypatch):
    """``workon`` whose consumer dies on its fourth trial: the exception
    propagates, and the working directory holds the dump with the loop's
    producer rounds and the crash; the final flush stored the spans."""
    from orion_tpu_torch.core import worker
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.core.trial import Result
    from orion_tpu_torch.storage.base import create_storage

    class DyingConsumer:
        def __init__(self, experiment, *args, **kwargs):
            self.experiment, self.calls = experiment, 0

        def consume(self, trial):
            self.calls += 1
            if self.calls == 4:
                raise RuntimeError("consumer died")
            self.experiment.storage.update_completed_trial(
                trial, [Result("o", "objective", 1.0)])
            return True

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(worker, "Consumer", DyingConsumer)
    storage = create_storage({"type": "memory"})
    exp = build_experiment(storage, "crash", priors={"x": "uniform(0, 1)"}, max_trials=10,
                           pool_size=2, algorithms={"random": {"seed": 1}})
    exp.instantiate(device="cpu")
    with isolated_telemetry(True) as (tel, flight, _, _):
        with pytest.raises(RuntimeError, match="consumer died"):
            worker.workon(exp, None)
        [dump] = [f for f in os.listdir(tmp_path) if f.startswith("flight-crash-")]
        lines = _read(tmp_path / dump)
        kinds = [e["kind"] for e in lines[1:]]
        assert lines[0]["reason"] == "crash" and kinds[-1] == "crash"
        assert kinds.count("producer.round") == 2
        stored = {s["name"] for s in storage.fetch_spans(exp.id)}
        assert {"producer.round", "flight.producer.round", "storage.reserve_trial"} <= stored
        assert storage.fetch_metrics(exp.id)


def test_recorder_off_worker_crash_writes_nothing(tmp_path, monkeypatch):
    from orion_tpu_torch.core import worker
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.storage.base import create_storage

    class Dying:
        def __init__(self, *args, **kwargs):
            pass

        def consume(self, trial):
            raise KeyboardInterrupt

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(worker, "Consumer", Dying)
    storage = create_storage({"type": "memory"})
    exp = build_experiment(storage, "quiet", priors={"x": "uniform(0, 1)"}, max_trials=4,
                           algorithms={"random": {"seed": 1}})
    exp.instantiate(device="cpu")
    with isolated_telemetry(False):
        with pytest.raises(KeyboardInterrupt):
            worker.workon(exp, None)
    assert os.listdir(tmp_path) == []
