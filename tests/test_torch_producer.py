"""The port's producer against ``orion_tpu``'s live behaviour.

A scripted algorithm — a subclass of each package's ``BaseAlgorithm`` that
hands out fixed unit-cube rows in order (a cursor, like grid search) and
records what it observes — runs under each package's ``Producer`` through
each package's ``ExperimentClient``, three rounds with trials left in
flight.  After every round the trial and lie documents in storage (less
their wall-clock fields), and the rows the naive copy and the real
instance observed, must be equal.  Then the port's ``tpu_bo`` on the CPU:
lies reach the naive copy and never the real instance's history buffers,
and the real instance's generator moves on with the naive copy's draws.
"""

import copy

import numpy as np
import pytest
import torch

from orion_tpu.algo.base import BaseAlgorithm as RefBase
from orion_tpu.client.experiment import ExperimentClient as RefClient
from orion_tpu.core.experiment import build_experiment as ref_build
from orion_tpu.core.strategy import create_strategy as ref_strategy
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu_torch.algo.base import BaseAlgorithm, create_algo
from orion_tpu_torch.client.experiment import ExperimentClient
from orion_tpu_torch.core.experiment import build_experiment
from orion_tpu_torch.core.producer import Producer, _advance_rng
from orion_tpu_torch.core.strategy import create_strategy
from orion_tpu_torch.storage.base import create_storage

PRIORS = {"x0": "uniform(0, 1)", "x1": "uniform(0, 1)"}
ROWS = np.random.default_rng(0).uniform(size=(96, 2)).astype(np.float32)
WALL_CLOCK = ("submit_time", "start_time", "end_time", "heartbeat")


def _scripted(base):
    """A scripted algorithm over ``base``: ``_suggest_cube`` hands out the
    next rows of ``ROWS`` and advances its cursor; ``register_suggestion``
    moves the real instance's cursor past a registered row (the naive copy
    that suggested is thrown away each round); observations are recorded."""

    class Scripted(base):
        def __init__(self, space, **kwargs):
            super().__init__(space, **kwargs)
            self.cursor = 0
            self.observed = []

        def _suggest_cube(self, num):
            rows = ROWS[self.cursor:self.cursor + num]
            self.cursor += len(rows)
            return rows if len(rows) else None

        def register_suggestion(self, params):
            row = self.space.params_to_cube([params])[0]
            idx = int(np.argmin(((ROWS - row) ** 2).sum(axis=1)))
            self.cursor = max(self.cursor, idx + 1)

        def observe_arrays(self, cube, objectives, params_list=None, fidelities=None):
            self.observed.append((np.asarray(cube).tolist(),
                                  np.asarray(objectives).tolist()))

        def health_record(self):
            return {"algo": "scripted", "cursor": self.cursor,
                    "n_obs": sum(len(cube) for cube, _ in self.observed)}

    class SpeculationSafe(Scripted):
        supports_async_suggest = True
        speculation_safe = True

    return Scripted, SpeculationSafe


RefScripted, RefSpeculative = _scripted(RefBase)
PortScripted, PortSpeculative = _scripted(BaseAlgorithm)


def _objective(params):
    return float((params["x0"] - 0.4) ** 2 + params["x1"])


def _client(port, depth, speculative):
    """A client over an experiment whose algorithm is the scripted one."""
    if port:
        storage = create_storage({"type": "memory"})
        exp = build_experiment(storage, "prod", priors=PRIORS, max_trials=1000,
                               pipeline_depth=depth)
        cls = PortSpeculative if speculative else PortScripted
        exp.algorithm = cls(exp.space, seed=0, device="cpu")
        exp.strategy = create_strategy("MaxParallelStrategy")
        return ExperimentClient(exp), storage
    storage = ref_create_storage({"type": "memory"})
    exp = ref_build(storage, "prod", priors=PRIORS, max_trials=1000, pipeline_depth=depth)
    cls = RefSpeculative if speculative else RefScripted
    exp.algorithm = cls(exp.space, seed=0)
    exp.strategy = ref_strategy("MaxParallelStrategy")
    return RefClient(exp), storage


def _snapshot(client, storage):
    def docs(collection):
        rows = [{k: v for k, v in d.items() if k not in WALL_CLOCK}
                for d in storage.db.read(collection)]
        return sorted(rows, key=lambda d: d["_id"])

    producer = client.producer
    return {
        "trials": docs("trials"),
        "lies": docs("lying_trials"),
        "real_observed": copy.deepcopy(producer.algorithm.observed),
        "naive_observed": copy.deepcopy(producer.naive_algorithm.observed),
        "real_cursor": producer.algorithm.cursor,
        "ring": len(producer._spec_ring),
    }


def _run(port, depth, speculative):
    """Three rounds of 6: complete the first 4 of each round's trials and
    leave 2 reserved until the round after next."""
    client, storage = _client(port, depth, speculative)
    snapshots, held = [], []
    for _ in range(3):
        trials = client.suggest(6)
        ids = [t.id for t in trials]
        done, keep = trials[:4], trials[4:]
        client.observe_all(done, [_objective(t.params) for t in done])
        if len(held) >= 2:  # the oldest held pair completes now
            old = held[:2]
            client.observe_all(old, [_objective(t.params) for t in old])
            held = held[2:]
        held.extend(keep)
        snapshots.append((ids, _snapshot(client, storage)))
    client.producer.update()
    snapshots.append(([], _snapshot(client, storage)))
    return snapshots


@pytest.mark.parametrize("depth,speculative", [(1, False), (2, True)])
def test_producer_rounds_match_reference(depth, speculative):
    got = _run(True, depth, speculative)
    want = _run(False, depth, speculative)
    for round_index, ((got_ids, got_snap), (want_ids, want_snap)) in enumerate(zip(got, want)):
        assert got_ids == want_ids, round_index
        for key in want_snap:
            assert got_snap[key] == want_snap[key], (round_index, key)
    last = got[-1][1]
    # The run did what it claims: lies were made and observed by the naive
    # copy only, trials stayed in flight, nothing was registered twice.
    assert last["lies"] and last["naive_observed"] != last["real_observed"]
    assert {d["status"] for d in last["trials"]} == {"completed", "reserved"}
    # The naive copy is a copy of the real instance: its first entries are
    # the real instance's, the rest are this round's lies.
    assert last["naive_observed"][:len(last["real_observed"])] == last["real_observed"]
    lie_rows = {tuple(r) for cube, _ in last["naive_observed"][len(last["real_observed"]):]
                for r in cube}
    assert lie_rows
    real_rows = [tuple(r) for cube, _ in last["real_observed"] for r in cube]
    assert len(real_rows) == len(set(real_rows)) == sum(
        d["status"] == "completed" for d in last["trials"])
    assert lie_rows.isdisjoint(real_rows)
    if speculative:
        assert any(snap["ring"] for _, snap in got)


def _tpu_bo_client(storage, seed=0):
    exp = build_experiment(storage, "bo", priors=PRIORS, max_trials=64,
                           algorithms={"tpu_bo": {"n_init": 4, "n_candidates": 256,
                                                  "fit_steps": 3}})
    return ExperimentClient(exp.instantiate(seed=seed, device="cpu"))


def test_tpu_bo_lies_stay_out_of_the_real_history_and_the_stream_moves_on():
    storage = create_storage({"type": "memory"})
    client = _tpu_bo_client(storage)
    first = client.suggest(8)  # random round (fewer than n_init observed)
    done = first[:6]
    client.observe_all(done, [_objective(t.params) for t in done])  # 2 left in flight
    producer = client.producer
    real = producer.algorithm
    before = real.generator.get_state().clone()
    second = client.suggest(4)  # a GP round, 6 observed + 2 lies
    naive = producer.naive_algorithm
    assert len(second) == 4
    assert len(storage.fetch_lies(client.experiment.id)) == 2
    # The naive copy observed the 6 completed rows and 2 lies; the real
    # instance only the 6, on the host and in its device buffers.
    assert naive._host.count == naive._hist.count == 8
    assert real._host.count == real._hist.count == 6
    completed = client.experiment.space.params_to_cube([t.params for t in done])
    x, y, mask, _ = real._hist.fit_view()
    # (in storage order: by submit time, then id)
    assert sorted(map(tuple, x[:6].tolist())) == sorted(map(tuple, completed.tolist()))
    assert not x[6:].any() and not y[6:].any() and mask.sum() == 6
    assert real._hist._x is not naive._hist._x
    # The real generator moved on to where the naive copy's stands, as a
    # copy of its state, not a shared object.
    after = real.generator.get_state()
    assert not torch.equal(before, after)
    assert torch.equal(after, naive.generator.get_state())
    assert real.generator is not naive.generator
    # The next round's draws differ from this one's.
    third = client.suggest(4)
    assert {tuple(t.params.values()) for t in third}.isdisjoint(
        {tuple(t.params.values()) for t in second})


def test_advance_rng_copies_state_and_keeps_objects_apart():
    from orion_tpu_torch.space.dsl import build_space

    space = build_space(PRIORS)
    real = create_algo(space, "random", seed=1, device="cpu")
    naive = copy.deepcopy(real)
    naive.suggest(3)
    _advance_rng(real, naive)
    assert torch.equal(real.generator.get_state(), naive.generator.get_state())
    assert real.generator is not naive.generator
    # Drawing on one no longer moves the other.
    naive.suggest(2)
    assert not torch.equal(real.generator.get_state(), naive.generator.get_state())


def test_evc_family_and_remote_algorithm_raise_not_implemented():
    """Only the remote algorithm still raises: an experiment with an EVC
    family builds its producer over the tree fetch, a changed configuration
    branches, and the audit runs (``tests/test_torch_evc.py`` and
    ``tests/test_torch_audit.py`` hold them to the reference)."""
    storage = create_storage({"type": "memory"})
    exp = build_experiment(storage, "child", priors=PRIORS, refers={"parent_id": "p"})
    exp.instantiate(seed=0, device="cpu")
    assert Producer(exp)._tree_fetcher is not None
    assert exp.fetch_trials(with_evc_tree=True) == []
    child = build_experiment(storage, "child", priors={"x0": "uniform(0, 2)", "x1": "uniform(0, 1)"})
    assert child.version == 2 and child.refers["parent_id"] == exp.id
    remote = build_experiment(storage, "remote", priors=PRIORS, serve={"address": "h:1"})
    with pytest.raises(NotImplementedError, match="item 8"):
        remote.instantiate(device="cpu")
    assert exp.audit().ok


@pytest.mark.parametrize("config", [
    None, "NoParallelStrategy", "MeanParallelStrategy", "StubParallelStrategy",
    {"StubParallelStrategy": {"stub_value": 5.0}},
    {"MaxParallelStrategy": {"default_result": 1.0}},
])
def test_strategies_lie_like_the_reference(config):
    from orion_tpu.core.trial import Trial as RefTrial
    from orion_tpu_torch.core.trial import Trial

    def lies(strategy, trial_cls):
        def lie_of(trial):
            lie = strategy.lie(trial)
            return None if lie is None else (lie.name, lie.type, lie.value)

        out = [strategy.configuration]
        trial = trial_cls(params={"x0": 0.5})
        out.append(lie_of(trial))
        strategy.observe([{"x0": 0.1}, {"x0": 0.2}], [{"objective": 3.0}, {"objective": None}])
        strategy.observe([{"x0": 0.3}], [{"objective": -1.0}])
        out.append(lie_of(trial))
        carried = trial_cls(params={"x0": 0.5},
                            results=[{"name": "lie", "type": "lie", "value": 7.0}])
        out.append(strategy.lie(carried).value)
        return out

    got = lies(create_strategy(config), Trial)
    want = lies(ref_strategy(config), RefTrial)
    assert got == want


def test_health_records_match_reference():
    """One health record a round: the naive copy's fields under the real
    instance's, with the round and its registered count.  Both packages
    write them with their telemetry on; compared without ``time`` and the
    reference's ``mem_bytes`` gauge stamp, which the port leaves out."""
    from torch_parity import isolated_telemetry

    records = []
    for port in (True, False):
        client, storage = _client(port, depth=1, speculative=False)
        with isolated_telemetry(True):
            for _ in range(3):
                trials = client.suggest(4)
                client.observe_all(trials[:3], [_objective(t.params) for t in trials[:3]])
            client.producer.update()
        docs = storage.fetch_health(client.experiment.id)
        records.append([{k: v for k, v in d.items()
                         if k not in ("_id", "time", "worker", "mem_bytes")} for d in docs])
    assert records[0] == records[1]
    assert [r["round"] for r in records[0]] == [1, 2, 3]
    assert records[0][-1]["n_obs"] == 6 and records[0][-1]["registered"] == 4
