"""The port's trial identity and trial documents against ``orion_tpu``'s.

The same seeded unit-cube rows decode through each package's space into
param rows; both packages' ids (``Trial.compute_id``, ``compute_batch_ids``,
``compute_cube_ids``, ``compute_scheme_ids``) and ``TrialBatch`` documents
must then be equal, exactly, under both ``ID_SCHEMES``: an id is a hash of
a ``repr`` (md5) or of float32 cube bytes (``cube_hash``), so any
difference in a decoded value's Python type or in one bit of a cube row
shows as a different id."""

import numpy as np
import pytest

from orion_tpu.core import trial as ref_trial
from orion_tpu.space.dsl import build_space as ref_build_space
from orion_tpu_torch.core import trial as port_trial
from orion_tpu_torch.space.dsl import build_space

#: One space per kind of dimension the ids must agree on, and all together.
SPACES = {
    "real": {"x": "uniform(-3, 5)", "y": "uniform(0, 1)"},
    "loguniform": {"lr": "loguniform(1e-5, 1.0)", "wd": "loguniform(1, 1000, discrete=True)"},
    "integer": {"n": "randint(2, 9)", "k": "uniform(0, 10, discrete=True)"},
    "categorical": {"opt": "choices(['adam', 'sgd', 3, 4.5])",
                    "act": "choices({'relu': 0.5, 'gelu': 0.5})"},
    "fidelity": {"x": "uniform(0, 1)", "epochs": "fidelity(1, 64, 4)"},
    "mixed": {"x": "uniform(-3, 5)", "lr": "loguniform(1e-5, 1.0)", "n": "randint(2, 9)",
              "opt": "choices(['adam', 'sgd', 3, 4.5])", "epochs": "fidelity(1, 64, 4)"},
}
EXPERIMENT = "0123456789abcdef0123456789abcdef"


def _params(priors, n=16, seed=0):
    """The same cube rows decoded by each package: (port rows, reference
    rows, port space, reference space)."""
    port_space, ref_space = build_space(priors), ref_build_space(priors)
    cube = np.random.default_rng(seed).uniform(size=(n, port_space.n_cols)).astype(np.float32)
    fid = port_space.fidelity
    fv = fid.high if fid is not None else None
    port = port_space.arrays_to_params(port_space.decode_flat_np(cube), fidelity_value=fv)
    ref = ref_space.arrays_to_params(ref_space.decode_flat_np(cube), fidelity_value=fv)
    return port, ref, port_space, ref_space


def _typed(rows):
    return [{k: (type(v), v) for k, v in dict(row).items()} for row in rows]


@pytest.mark.parametrize("kind", sorted(SPACES))
def test_decoded_params_equal_in_value_and_type(kind):
    port, ref, _, _ = _params(SPACES[kind])
    assert _typed(port) == _typed(ref)


@pytest.mark.parametrize("lie", [False, True])
@pytest.mark.parametrize("kind", sorted(SPACES))
def test_md5_ids_equal(kind, lie):
    port, ref, _, _ = _params(SPACES[kind])
    want = [ref_trial.Trial.compute_id(EXPERIMENT, dict(p), lie=lie) for p in ref]
    assert [port_trial.Trial.compute_id(EXPERIMENT, dict(p), lie=lie) for p in port] == want
    # Columnar (ParamBatch) and plain-dict rows through the batch twin.
    assert port_trial.compute_batch_ids(EXPERIMENT, port, lie=lie) == want
    assert port_trial.compute_batch_ids(EXPERIMENT, [dict(p) for p in port], lie=lie) == want
    assert ref_trial.compute_batch_ids(EXPERIMENT, ref, lie=lie) == want


@pytest.mark.parametrize("lie", [False, True])
@pytest.mark.parametrize("kind", sorted(SPACES))
def test_cube_hash_ids_equal(kind, lie):
    port, ref, port_space, ref_space = _params(SPACES[kind])
    port_cube, ref_cube = port_space.params_to_cube(port), ref_space.params_to_cube(ref)
    assert port_cube.tobytes() == ref_cube.tobytes()
    assert (port_trial.compute_cube_ids(EXPERIMENT, port_cube, lie=lie)
            == ref_trial.compute_cube_ids(EXPERIMENT, ref_cube, lie=lie))


@pytest.mark.parametrize("scheme", ref_trial.ID_SCHEMES)
@pytest.mark.parametrize("kind", sorted(SPACES))
def test_scheme_ids_and_batch_documents_equal(kind, scheme):
    assert port_trial.ID_SCHEMES == ref_trial.ID_SCHEMES
    port, ref, port_space, ref_space = _params(SPACES[kind])
    assert (port_trial.compute_scheme_ids(EXPERIMENT, port, id_scheme=scheme, space=port_space)
            == ref_trial.compute_scheme_ids(EXPERIMENT, ref, id_scheme=scheme, space=ref_space))
    parents = ["a" * 32, "b" * 32]
    port_batch = port_trial.TrialBatch(port).prepare(
        EXPERIMENT, parents=parents, submit_time=0.0, id_scheme=scheme, space=port_space)
    ref_batch = ref_trial.TrialBatch(ref).prepare(
        EXPERIMENT, parents=parents, submit_time=0.0, id_scheme=scheme, space=ref_space)
    port_docs = [dict(d, params=dict(d["params"])) for d in port_batch.to_docs()]
    ref_docs = [dict(d, params=dict(d["params"])) for d in ref_batch.to_docs()]
    assert port_docs == ref_docs
    # One id per distinct point (the categorical space repeats points).
    points = {repr(sorted(d["params"].items())) for d in port_docs}
    assert len({d["_id"] for d in port_docs}) == len(points)
    # The Trial views carry the same ids and serialize to the same documents.
    assert ([t.to_dict() for t in port_batch.trials()]
            == [t.to_dict() for t in ref_batch.trials()])


def test_trial_round_trip_and_status_machine_equal():
    results = [{"name": "objective", "type": "objective", "value": 0.5},
               {"name": "lie", "type": "lie", "value": 2.0}]
    doc = {"experiment": EXPERIMENT, "status": "reserved", "params": {"x": 0.25, "n": 3},
           "results": results, "worker": "h:1", "submit_time": 1.0, "start_time": 2.0,
           "end_time": None, "heartbeat": 2.5, "working_dir": None, "parents": ["p"],
           "exp_working_dir": "/ignored"}
    port, ref = port_trial.Trial.from_dict(doc), ref_trial.Trial.from_dict(doc)
    assert port.to_dict() == ref.to_dict()
    assert port.id == ref.id and port.hash_params == ref.hash_params
    assert (port.objective.value, port.lie.value) == (ref.objective.value, ref.lie.value)
    for bad in ("done", "Reserved"):
        with pytest.raises(ValueError):
            port_trial.Trial(status=bad)
        with pytest.raises(ValueError):
            ref_trial.Trial(status=bad)
    assert port_trial.RESERVABLE_STATUSES == ref_trial.RESERVABLE_STATUSES
    assert port_trial.STOPPED_STATUSES == ref_trial.STOPPED_STATUSES
