"""The port's shipped plugin-author harness (``orion_tpu_torch/testing.py``)
against ``orion_tpu.testing``: ``OrionState`` swaps the port's storage
singleton and puts it back, preloads the same experiment, trial and lie
documents the reference's preloads, and its ``pickled`` mode serves a
second process; ``DumbAlgo`` drives the port's producer to the trials the
reference's drives its producer to."""

import os
import subprocess
import sys

import pytest

import orion_tpu.storage.base as ref_storage_base
import orion_tpu_torch.storage.base as storage_base
from orion_tpu.core.producer import Producer as RefProducer
from orion_tpu.testing import DumbAlgo as RefDumbAlgo
from orion_tpu.testing import OrionState as RefOrionState
from orion_tpu_torch.core.producer import Producer
from orion_tpu_torch.testing import DumbAlgo, OrionState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL_CLOCK = ("submit_time", "start_time", "end_time", "heartbeat")

PRELOAD = {
    "experiments": [{"name": "exp", "max_trials": 10}],
    "trials": [
        {"params": {"/x": 0.1}, "status": "completed",
         "results": [{"name": "o", "type": "objective", "value": 1.0}]},
        {"params": {"/x": 0.2}, "status": "new"},
    ],
    "lies": [{"params": {"/x": 0.3}, "results": [{"name": "o", "type": "lie", "value": 9.0}]}],
}


def _docs(storage, collection):
    return sorted(({k: v for k, v in d.items() if k not in WALL_CLOCK}
                   for d in storage.db.read(collection)), key=lambda d: str(d["_id"]))


def test_orion_state_swaps_and_restores_the_singleton():
    before, ref_before = storage_base._storage_singleton, ref_storage_base._storage_singleton
    with OrionState(experiments=[{"name": "exp"}]) as state:
        assert storage_base.get_storage() is state.storage
        assert ref_storage_base._storage_singleton is ref_before
        assert state.get_experiment("exp").name == "exp"
        with pytest.raises(KeyError, match="no experiment"):
            state.get_experiment("missing")
    assert storage_base._storage_singleton is before


def test_orion_state_preloads_the_reference_documents():
    """The same experiments, trials and lies give the same trial and lie
    documents (ids included) in both packages' states."""
    with OrionState(**PRELOAD) as state, RefOrionState(**PRELOAD) as ref_state:
        exp, ref_exp = state.get_experiment("exp"), ref_state.get_experiment("exp")
        assert exp.id == ref_exp.id
        for collection in ("trials", "lying_trials"):
            assert _docs(state.storage, collection) == _docs(ref_state.storage, collection)
        assert {t.status for t in state.storage.fetch_trials(uid=exp.id)} == {"completed", "new"}
        assert len(state.storage.fetch_lies(exp.id)) == 1


@pytest.mark.parametrize("config", [{}, {"possible_values": [0.1, 0.4, 0.7, 0.9]}],
                         ids=["constant", "possible_values"])
def test_dumb_algo_drives_the_producer_like_the_reference(config):
    """``DumbAlgo`` through the port's producer registers the points the
    reference's ``DumbAlgo`` registers through its producer, round after
    round (``possible_values`` gives distinct points, and the next round's
    naive copy resumes at the first unconsumed value)."""
    experiments = [{"name": "exp", "max_trials": 10, "algorithms": {"dumbalgo": config}}]
    rounds = (3, 1) if config else (1,)
    with OrionState(experiments=experiments) as state, \
            RefOrionState(experiments=experiments) as ref_state:
        exp = state.get_experiment("exp").instantiate(device="cpu")
        ref_exp = ref_state.get_experiment("exp").instantiate()
        assert isinstance(exp.algorithm, DumbAlgo) and isinstance(ref_exp.algorithm, RefDumbAlgo)
        producer, ref_producer = Producer(exp), RefProducer(ref_exp)
        for q in rounds:
            producer.update()
            ref_producer.update()
            assert producer.produce(q) == ref_producer.produce(q) == q
        ids = sorted(t.id for t in exp.fetch_trials())
        assert ids == sorted(t.id for t in ref_exp.fetch_trials())
        xs = sorted(t.params["/x"] for t in exp.fetch_trials())
        assert xs == pytest.approx([0.1, 0.4, 0.7, 0.9] if config else [0.5])
        algo = exp.algorithm
        assert algo.suggest(3) is not None and algo.n_suggested == 3


def test_dumb_algo_opt_out_and_done():
    with OrionState(experiments=[{"name": "exp"}]) as state:
        algo = state.get_experiment("exp").instantiate(device="cpu").algorithm
        algo.opt_out = True
        assert algo.suggest(2) is None
        algo.done = True
        assert algo.is_done is True
        algo.observe([{"/x": 0.25}], [{"objective": 1.5}])
        assert algo.observed_results == [1.5] and algo.observed_params == [{"/x": 0.25}]


CHILD = r"""
import sys
from orion_tpu_torch.storage import create_storage
storage = create_storage({"type": "pickled", "path": sys.argv[1]})
[exp] = storage.fetch_experiments({"name": "exp"})
print(exp["_id"], storage.count_completed_trials(exp["_id"]))
"""


def test_orion_state_pickled_mode_serves_another_process():
    with OrionState(experiments=[{"name": "exp"}], trials=PRELOAD["trials"],
                    pickled=True) as state:
        path = state.storage.db.path
        exp_id = state.get_experiment("exp").id
        proc = subprocess.run([sys.executable, "-c", CHILD, path], capture_output=True,
                              text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.split() == [str(exp_id), "1"]
    assert not os.path.exists(path)
