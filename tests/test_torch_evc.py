"""The port's experiment version control (``orion_tpu_torch.evc``) against
``orion_tpu``'s.

Three parts:

- module parity: the same experiment configurations and trial documents
  (numpy-seeded params) through both packages' ``detect_conflicts``, every
  adapter's ``forward``/``backward``, ``CompositeAdapter`` serialization,
  ``branch_experiment``'s child document and ``TreeTrialsFetcher.fetch`` over
  a three-generation chain (an addition, a prior change, a renaming), and
  the producer fed by a branched child's tree;
- the scenarios of the reference's ``tests/unit/test_evc.py``, each run
  through the port and, with the same assertions, through the reference;
- the three-generation ``hunt`` chain of ``tests/functional/test_branching.py``
  through both CLIs (``--device cpu``) on ``pickled`` and ``sqlite``, ending
  in the same experiment and trial documents; a store the reference branched
  continued by the port; ``--branch-to`` and ``--manual-resolution``.
"""

import os
import shutil
import types

import numpy as np
import pytest
import yaml

from orion_tpu.algo.base import BaseAlgorithm as RefBase
from orion_tpu.cli import main as ref_main
from orion_tpu.core import experiment as ref_experiment
from orion_tpu.core.producer import Producer as RefProducer
from orion_tpu.core.strategy import create_strategy as ref_create_strategy
from orion_tpu.core.trial import Result as RefResult
from orion_tpu.core.trial import Trial as RefTrial
from orion_tpu.evc import adapters as ref_adapters
from orion_tpu.evc import branching_prompt as ref_branching_prompt
from orion_tpu.evc import builder as ref_builder
from orion_tpu.evc import conflicts as ref_conflicts
from orion_tpu.evc import experiment as ref_evc_experiment
from orion_tpu.evc import tree as ref_tree
from orion_tpu.storage.base import create_storage as ref_create_storage
from orion_tpu_torch.algo.base import BaseAlgorithm
from orion_tpu_torch.cli import main
from orion_tpu_torch.core import experiment
from orion_tpu_torch.core.producer import Producer
from orion_tpu_torch.core.strategy import create_strategy
from orion_tpu_torch.core.trial import Result, Trial
from orion_tpu_torch.evc import adapters, branching_prompt, builder, conflicts, tree
from orion_tpu_torch.evc import experiment as evc_experiment
from orion_tpu_torch.storage.base import create_storage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUNCTIONAL = os.path.join(ROOT, "tests", "functional")
WALL_CLOCK = ("submit_time", "start_time", "end_time", "heartbeat")


def _recording(base):
    """An algorithm over ``base`` that records what it observes and
    suggests seeded rows of the space's width (the same in both
    packages)."""

    class Recording(base):
        def __init__(self, space, **kwargs):
            super().__init__(space, **kwargs)
            self.cursor = 0
            self.observed = []

        def _suggest_cube(self, num):
            rng = np.random.default_rng(self.cursor)
            self.cursor += num
            return rng.uniform(size=(num, self.space.n_cols)).astype(np.float32)

        def observe_arrays(self, cube, objectives, params_list=None, fidelities=None):
            self.observed.append((np.asarray(cube).tolist(), np.asarray(objectives).tolist()))

    return Recording


PKG = {
    "port": types.SimpleNamespace(
        name="port", adapters=adapters, conflicts=conflicts, builder=builder, tree=tree,
        evc=evc_experiment, prompt=branching_prompt, experiment=experiment,
        build_experiment=experiment.build_experiment, Trial=Trial, Result=Result,
        Producer=Producer, create_storage=create_storage, create_strategy=create_strategy,
        Recording=_recording(BaseAlgorithm), main=main,
        instantiate=lambda exp: exp.instantiate(device="cpu"),
        algo_kwargs={"device": "cpu"}),
    "reference": types.SimpleNamespace(
        name="reference", adapters=ref_adapters, conflicts=ref_conflicts, builder=ref_builder,
        tree=ref_tree, evc=ref_evc_experiment, prompt=ref_branching_prompt,
        experiment=ref_experiment, build_experiment=ref_experiment.build_experiment,
        Trial=RefTrial, Result=RefResult, Producer=RefProducer,
        create_storage=ref_create_storage, create_strategy=ref_create_strategy,
        Recording=_recording(RefBase), main=ref_main,
        instantiate=lambda exp: exp.instantiate(), algo_kwargs={}),
}
BOTH = pytest.mark.parametrize("pkg", ["port", "reference"])


def _doc(trial):
    return {k: v for k, v in trial.to_dict().items() if k not in WALL_CLOCK}


def _strip_experiment(doc):
    doc = dict(doc)
    doc["metadata"] = {k: v for k, v in doc.get("metadata", {}).items() if k != "timestamp"}
    return doc


# --- module parity -----------------------------------------------------------


def _seeded_trial_docs(seed, n=12, experiment_id="parent-id"):
    """Trial documents over ``/x`` in [0, 10] and ``/y``, which sits on its
    default 0.5 for a third of them; mixed statuses, objectives on the
    completed ones."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        status = ["completed", "new", "reserved", "broken"][i % 4]
        params = {"/x": float(rng.uniform(0, 10)),
                  "/y": 0.5 if i % 3 == 0 else float(rng.uniform(0, 1))}
        results = ([{"name": "o", "type": "objective", "value": float(rng.normal())}]
                   if status == "completed" else [])
        docs.append({"experiment": experiment_id, "status": status, "params": params,
                     "results": results, "submit_time": float(i), "parents": ["p0"]})
    return docs


ADAPTER_SPECS = {
    "addition": {"of_type": "dimensionaddition", "name": "/z", "default_value": 3},
    "deletion": {"of_type": "dimensiondeletion", "name": "/y", "default_value": 0.5},
    "prior_change": {"of_type": "dimensionpriorchange", "name": "/x",
                     "old_prior": "uniform(0, 10)", "new_prior": "uniform(0, 5)"},
    "renaming": {"of_type": "dimensionrenaming", "old_name": "/y", "new_name": "/w"},
    "algorithm": {"of_type": "algorithmchange"},
    "code_break": {"of_type": "codechange", "change_type": "break"},
    "code_noeffect": {"of_type": "codechange", "change_type": "noeffect"},
    "commandline_unsure": {"of_type": "commandlinechange", "change_type": "unsure"},
    "script_config_break": {"of_type": "scriptconfigchange", "change_type": "break"},
}


@pytest.mark.parametrize("spec", sorted(ADAPTER_SPECS))
def test_adapter_forward_and_backward_match_reference(spec):
    """Each adapter built from its document in both packages maps the same
    seeded trials to the same trials (ids, params, every field) forward
    and backward, and serializes to the same document."""
    config = ADAPTER_SPECS[spec]
    port = adapters.build_adapter(config)
    ref = ref_adapters.build_adapter(config)
    assert port.to_dict() == ref.to_dict() == config
    docs = _seeded_trial_docs(0)
    # Backward sees child trials: for the addition they carry /z.
    child_docs = [dict(d, params={**d["params"], "/z": 3 if i % 2 else 4})
                  for i, d in enumerate(docs)]
    for direction, source in (("forward", docs), ("backward", child_docs)):
        got = [_doc(t) for t in getattr(port, direction)([Trial(**d) for d in source])]
        want = [_doc(t) for t in getattr(ref, direction)([RefTrial(**d) for d in source])]
        assert got == want, direction
    assert (got == []) is spec.endswith("break")


def test_composite_adapter_serialization_matches_reference():
    chain = [ADAPTER_SPECS[k] for k in ("renaming", "addition", "prior_change", "code_noeffect")]
    port = adapters.CompositeAdapter(*chain)
    ref = ref_adapters.CompositeAdapter(*chain)
    assert port.to_dict() == ref.to_dict()
    assert adapters.build_adapter(port.to_dict()).to_dict() == port.to_dict()
    docs = _seeded_trial_docs(1)
    for direction in ("forward", "backward"):
        got = [_doc(t) for t in getattr(port, direction)([Trial(**d) for d in docs])]
        want = [_doc(t) for t in getattr(ref, direction)([RefTrial(**d) for d in docs])]
        assert got == want, direction
    with pytest.raises(ValueError, match="change_type"):
        adapters.CodeChange("wat")
    with pytest.raises(ValueError, match="change_type"):
        ref_adapters.CodeChange("wat")


def _old(**over):
    base = {"name": "exp", "version": 1,
            "priors": {"/x": "uniform(0, 10)", "/y": "uniform(0, 1)"},
            "algorithms": "random", "metadata": {}}
    base.update(over)
    return base


VCS = {"type": "git", "HEAD_sha": "a" * 40, "diff_sha": None, "is_dirty": False}
CONFLICT_CASES = {
    "same": (_old(), {"priors": {"/x": "uniform(0,10)", "/y": "uniform(0, 1)"}}),
    "new_changed_missing": (_old(), {"priors": {"/x": "uniform(0, 5)",
                                                "/z": "+normal(0, 1, default_value=0.1)"}}),
    "new_without_default": (_old(), {"priors": {"/x": "uniform(0, 10)", "/y": "uniform(0, 1)",
                                                "/z": "uniform(0, 5)"}}),
    "rename": (_old(), {"priors": {"/x": "uniform(0, 10)", "/y": ">/w",
                                   "/w": "uniform(0, 1)"}}),
    "rename_and_change": (_old(), {"priors": {"/x": "uniform(0, 10)", "/y": ">/w",
                                              "/w": "uniform(0, 2)"}}),
    "remove_marker": (_old(), {"priors": {"/x": "uniform(0, 10)", "/y": "-"}}),
    "algorithm": (_old(), {"priors": {"/x": "uniform(0, 10)", "/y": "uniform(0, 1)"},
                           "algorithms": {"tpe": {"n_init": 4}}}),
    "code": (_old(metadata={"vcs": VCS}),
             {"priors": _old()["priors"], "metadata": {"vcs": dict(VCS, HEAD_sha="b" * 40)}}),
    "commandline": (_old(metadata={"user_args": ["s.py", "-x~uniform(0, 10)", "--lr", "1"]}),
                    {"priors": _old()["priors"],
                     "metadata": {"user_args": ["s.py", "-x~uniform(0, 10)", "--lr", "2"]}}),
    "script_config": (_old(metadata={"script_config_hash": "h1"}),
                      {"priors": _old()["priors"], "metadata": {"script_config_hash": "h2"}}),
    "argless_resume": (_old(metadata={"user_args": ["s.py", "--lr", "1"]}),
                       {"priors": _old()["priors"], "metadata": {}}),
}


def _conflict_summary(pkg, old, new):
    found = pkg.conflicts.detect_conflicts(old, new)
    before = [(type(c).__name__, c.diff(), c.is_resolved) for c in found.conflicts]
    found.try_resolve_all()
    after = [(type(c).__name__, c.resolution.info if c.resolution else None,
              c.resolution.adapter.to_dict() if c.resolution and c.resolution.adapter else None)
             for c in found.conflicts]
    return before, after, found.are_resolved, [a.to_dict() for a in found.get_adapters()]


@pytest.mark.parametrize("case", sorted(CONFLICT_CASES))
def test_detect_conflicts_and_resolutions_match_reference(case):
    old, new = CONFLICT_CASES[case]
    got = _conflict_summary(PKG["port"], old, new)
    assert got == _conflict_summary(PKG["reference"], old, new)
    if case in ("same", "argless_resume"):
        assert got[0] == []
    else:
        assert got[0][-1][0] == "ExperimentNameConflict"


BRANCH_CASES = {
    "prior_change": ({"/x": "uniform(0, 5)", "/y": "uniform(0, 1)"}, {}),
    "addition": ({"/x": "uniform(0, 10)", "/y": "uniform(0, 1)",
                  "/z": "+uniform(0, 1, default_value=0.3)"}, {}),
    "rename_only": ({"/x": "uniform(0, 10)", "/y": ">/w"}, {}),
    "branch_to": ({"/x": "uniform(0, 5)", "/y": "uniform(0, 1)"},
                  {"branch_config": {"branch_to": "forked"}}),
    "algorithm": ({"/x": "uniform(0, 10)", "/y": "uniform(0, 1)"},
                  {"algorithms": {"tpe": {"n_init": 4}}, "max_trials": 7}),
}


def _branch(pkg, case):
    priors, kwargs = BRANCH_CASES[case]
    storage = pkg.create_storage({"type": "memory"})
    parent = pkg.build_experiment(storage, "br", priors=_old()["priors"], algorithms="random",
                                  max_trials=5, metadata={"user": "u"})
    child = pkg.build_experiment(storage, "br", priors=priors, metadata={"user": "u"},
                                 **kwargs)
    # Twice: a second build resumes the branched child, it does not branch.
    again = pkg.build_experiment(storage, kwargs.get("branch_config", {}).get(
        "branch_to", "br"), priors=child.priors, metadata={"user": "u"})
    docs = sorted((_strip_experiment(d) for d in storage.fetch_experiments({})),
                  key=lambda d: (d["name"], d["version"]))
    return parent.id, child.id, again.id, docs


@pytest.mark.parametrize("case", sorted(BRANCH_CASES))
def test_branch_experiment_child_document_matches_reference(case):
    """``build_experiment`` on a changed configuration branches the same
    child in both packages: its ``_id``, name, version, priors, ``refers``
    (root, parent, adapter) and every other stored field."""
    got = _branch(PKG["port"], case)
    assert got == _branch(PKG["reference"], case)
    parent_id, child_id, again_id, docs = got
    assert child_id == again_id != parent_id and len(docs) == 2
    assert docs[-1]["refers"]["parent_id"] == parent_id


def _chain(pkg, seed=0):
    """A three-generation chain in memory storage: v1 over (/x, /y); v2
    adds /z (default 0.3); v3 narrows /x to [0, 5] and renames /y to /w.
    Each generation holds seeded trials, registered as documents."""
    storage = pkg.create_storage({"type": "memory"})
    v1 = pkg.build_experiment(storage, "chain", priors={"/x": "uniform(0, 10)",
                                                        "/y": "uniform(0, 1)"})
    v2 = pkg.build_experiment(storage, "chain", priors={
        "/x": "uniform(0, 10)", "/y": "uniform(0, 1)", "/z": "+uniform(0, 1, default_value=0.3)"})
    v3 = pkg.build_experiment(storage, "chain", priors={
        "/x": "uniform(0, 5)", "/y": ">/w", "/w": "uniform(0, 1)",
        "/z": "uniform(0, 1, default_value=0.3)"})
    rng = np.random.default_rng(seed)
    names = {v1.id: ("/x", "/y"), v2.id: ("/x", "/y", "/z"), v3.id: ("/x", "/w", "/z")}
    for exp in (v1, v2, v3):
        for i, doc in enumerate(_seeded_trial_docs(int(rng.integers(1 << 30)), 10, exp.id)):
            params = dict(doc["params"])
            if "/z" in names[exp.id]:
                params["/z"] = 0.3 if i % 2 else float(rng.uniform())
            if "/w" in names[exp.id]:
                params["/w"] = params.pop("/y")
                params["/x"] = params["/x"] / 2
            storage.register_trial(pkg.Trial(**dict(doc, params=params)))
    return storage, (v1, v2, v3)


def test_tree_fetch_over_three_generations_matches_reference():
    """``TreeTrialsFetcher.fetch`` from each generation of the chain (the
    grandchild adapting v1's trials over two hops, the root adapting its
    descendants' backward): the same trials, ids, params and order; and
    after a new root trial, the same incremental result."""
    out = {}
    for name, pkg in PKG.items():
        storage, versions = _chain(pkg)
        fetchers = [pkg.evc.TreeTrialsFetcher(v) for v in versions]
        rounds = [[[_doc(t) for t in f.fetch()] for f in fetchers]]
        storage.register_trial(pkg.Trial(
            experiment=versions[0].id, status="completed", params={"/x": 1.5, "/y": 0.25},
            results=[{"name": "o", "type": "objective", "value": 2.0}], submit_time=99.0))
        rounds.append([[_doc(t) for t in f.fetch()] for f in fetchers])
        rounds.append([_doc(t) for t in versions[2].fetch_trials(with_evc_tree=True)])
        out[name] = rounds
    assert out["port"] == out["reference"]
    first, second, oneshot = out["port"]
    # v3 sees its own 10, v2's inside /x <= 5, and v1's inside /x <= 5.
    assert len(first[2]) > 10 and all(t["params"]["/x"] <= 5 for t in first[2])
    assert all(set(t["params"]) == {"/x", "/w", "/z"} for t in first[2])
    assert len(second[2]) == len(first[2]) + 1 and oneshot == second[2]


def _producer_run(pkg):
    """A branched child whose algorithm records what it observes, under
    the package's producer: two rounds, the first fed only by the tree."""
    storage, (v1, v2, _) = _chain(pkg)
    v2.algorithm = pkg.Recording(v2.space, seed=0, **pkg.algo_kwargs)
    v2.strategy = pkg.create_strategy("MaxParallelStrategy")
    producer = pkg.Producer(v2)
    producer.update()
    reservable = (producer._n_reservable, producer._n_in_flight)
    producer.produce(3)
    producer.update()
    trials = sorted((_doc(t) for t in storage.fetch_trials(uid=v2.id)), key=lambda d: d["_id"])
    lies = sorted((_doc(t) for t in storage.fetch_lies(v2.id)), key=lambda d: d["_id"])
    return (reservable, v2.algorithm.observed, producer.naive_algorithm.observed, trials, lies)


def test_producer_observes_the_adapted_family_like_reference():
    """The producer of a branched child observes its family's completed
    trials through the tree (adapted), counts only its own trials as
    reservable or in flight, lies about the in-flight ones, and registers
    the same trials as the reference's producer."""
    got = _producer_run(PKG["port"])
    assert got == _producer_run(PKG["reference"])
    (reservable, real_observed, naive_observed, trials, lies) = got
    own_new = sum(1 for d in _seeded_trial_docs(0, 10) if d["status"] == "new")
    assert reservable[0] >= 1 and reservable[0] <= own_new + 10
    assert sum(len(rows) for rows, _ in real_observed) > 3 and lies


# --- the reference's scenarios, replayed -------------------------------------


def _make_trials(pkg, params_list):
    return [pkg.Trial(experiment="p", params=p) for p in params_list]


def _run_trials(pkg, exp, values):
    producer = pkg.Producer(exp)
    for value in values:
        producer.update()
        producer.produce(1)
        trial = exp.reserve_trial()
        exp.update_completed_trial(trial, [pkg.Result("o", "objective", value)])


def _memory(pkg):
    return pkg.create_storage({"type": "memory"})


@BOTH
def test_tree_structure_and_traversals(pkg):
    T = PKG[pkg].tree
    root = T.TreeNode("a")
    b = T.TreeNode("b", parent=root)
    c = T.TreeNode("c", parent=root)
    d = T.TreeNode("d", parent=b)
    assert root.children == [b, c]
    assert d.root is root
    assert [n.item for n in T.PreOrderTraversal(root)] == ["a", "b", "d", "c"]
    assert [n.item for n in T.DepthFirstTraversal(root)] == ["d", "b", "c", "a"]
    assert root.flattened == ["a", "b", "d", "c"]
    assert {n.item for n in root.leafs} == {"d", "c"}
    c.set_parent(b)
    assert root.children == [b]
    assert c.parent is b


@BOTH
def test_dimension_addition_roundtrip(pkg):
    P = PKG[pkg]
    adapter = P.adapters.DimensionAddition("/y", default_value=3)
    fwd = adapter.forward(_make_trials(P, [{"/x": 1.0}]))
    assert fwd[0].params == {"/x": 1.0, "/y": 3}
    assert adapter.backward(fwd)[0].params == {"/x": 1.0}
    assert adapter.backward(_make_trials(P, [{"/x": 1.0, "/y": 9}])) == []


@BOTH
def test_dimension_deletion_is_inverse(pkg):
    P = PKG[pkg]
    adapter = P.adapters.DimensionDeletion("/y", default_value=3)
    fwd = adapter.forward(_make_trials(P, [{"/x": 1.0, "/y": 3}, {"/x": 2.0, "/y": 5}]))
    assert len(fwd) == 1 and fwd[0].params == {"/x": 1.0}
    assert adapter.backward(_make_trials(P, [{"/x": 1.0}]))[0].params == {"/x": 1.0, "/y": 3}


@BOTH
def test_prior_change_filters_support(pkg):
    P = PKG[pkg]
    adapter = P.adapters.DimensionPriorChange("/x", "uniform(0, 10)", "uniform(0, 5)")
    fwd = adapter.forward(_make_trials(P, [{"/x": 3.0}, {"/x": 8.0}]))
    assert [t.params["/x"] for t in fwd] == [3.0]
    assert len(adapter.backward(_make_trials(P, [{"/x": 4.0}]))) == 1


@BOTH
def test_renaming_roundtrip(pkg):
    P = PKG[pkg]
    adapter = P.adapters.DimensionRenaming("/x", "/z")
    fwd = adapter.forward(_make_trials(P, [{"/x": 1.0}]))
    assert fwd[0].params == {"/z": 1.0}
    assert adapter.backward(fwd)[0].params == {"/x": 1.0}


@BOTH
def test_change_type_break_drops(pkg):
    P = PKG[pkg]
    assert P.adapters.CodeChange("break").forward(_make_trials(P, [{"/x": 1}])) == []
    assert len(P.adapters.CodeChange("noeffect").forward(_make_trials(P, [{"/x": 1}]))) == 1
    with pytest.raises(ValueError):
        P.adapters.CodeChange("wat")


@BOTH
def test_composite_serialization_roundtrip(pkg):
    P = PKG[pkg]
    comp = P.adapters.CompositeAdapter(P.adapters.DimensionRenaming("/a", "/b"),
                                       P.adapters.DimensionAddition("/c", default_value=1))
    rebuilt = P.adapters.build_adapter(comp.to_dict())
    fwd = rebuilt.forward(_make_trials(P, [{"/a": 2.0}]))
    assert fwd[0].params == {"/b": 2.0, "/c": 1}
    assert rebuilt.backward(fwd)[0].params == {"/a": 2.0}


def _old_config(**over):
    base = {"name": "exp", "version": 1, "priors": {"/x": "uniform(0, 10)"},
            "algorithms": "random", "metadata": {}}
    base.update(over)
    return base


@BOTH
def test_detect_no_conflicts_on_same_config(pkg):
    C = PKG[pkg].conflicts
    assert C.detect_conflicts(_old_config(), {"priors": {"/x": "uniform(0, 10)"}}).conflicts == []


@BOTH
def test_detect_whitespace_insensitive(pkg):
    C = PKG[pkg].conflicts
    assert C.detect_conflicts(_old_config(), {"priors": {"/x": "uniform(0,10)"}}).conflicts == []


@BOTH
def test_detect_new_changed_missing(pkg):
    C = PKG[pkg].conflicts
    found = C.detect_conflicts(
        _old_config(priors={"/x": "uniform(0, 10)", "/y": "uniform(0, 1)"}),
        {"priors": {"/x": "uniform(0, 5)", "/z": "+normal(0, 1)"}})
    assert {type(c) for c in found.conflicts} == {
        C.NewDimensionConflict, C.ChangedDimensionConflict, C.MissingDimensionConflict,
        C.ExperimentNameConflict}


@BOTH
def test_rename_marker_detection(pkg):
    C = PKG[pkg].conflicts
    found = C.detect_conflicts(_old_config(), {"priors": {"/x": ">/y", "/y": "uniform(0, 10)"}})
    missing = found.get([C.MissingDimensionConflict])
    assert len(missing) == 1 and missing[0].rename_to == "/y"
    assert found.get([C.NewDimensionConflict]) == []


@BOTH
def test_algorithm_conflict(pkg):
    C = PKG[pkg].conflicts
    found = C.detect_conflicts(_old_config(), {"priors": {"/x": "uniform(0, 10)"},
                                               "algorithms": "tpe"})
    assert len(found.get([C.AlgorithmConflict])) == 1


@BOTH
def test_auto_resolution_produces_adapters_and_bump(pkg):
    P = PKG[pkg]
    found = P.conflicts.detect_conflicts(
        _old_config(),
        {"priors": {"/x": "uniform(0, 10)", "/y": "+uniform(0, 1, default_value=0.5)"}})
    found.try_resolve_all()
    assert found.are_resolved
    [adapter] = found.get_adapters()
    assert isinstance(adapter, P.adapters.DimensionAddition) and adapter.default_value == 0.5
    name = found.get([P.conflicts.ExperimentNameConflict])[0]
    assert name.resolution.info == {"name": "exp", "version": 2}


@BOTH
def test_build_experiment_branches_on_prior_change(pkg):
    P = PKG[pkg]
    storage = _memory(P)
    e1 = P.instantiate(P.build_experiment(storage, "b", priors={"/x": "uniform(0, 10)"},
                                          algorithms="random"))
    _run_trials(P, e1, [1.0, 2.0])
    e2 = P.build_experiment(storage, "b", priors={"/x": "uniform(0, 5)"}, algorithms="random")
    assert e2.version == 2
    assert e2.refers["parent_id"] == e2.refers["root_id"] == e1.id
    assert e2.priors == {"/x": "uniform(0, 5)"}
    in_range = [t for t in storage.fetch_trials(uid=e1.id) if t.params["/x"] <= 5]
    assert len(e2.fetch_trials(with_evc_tree=True)) == len(in_range)


@BOTH
def test_branch_adds_dimension_with_default(pkg):
    P = PKG[pkg]
    storage = _memory(P)
    e1 = P.instantiate(P.build_experiment(storage, "c", priors={"/x": "uniform(0, 10)"}))
    _run_trials(P, e1, [1.0])
    e2 = P.build_experiment(storage, "c", priors={
        "/x": "uniform(0, 10)", "/y": "+uniform(0, 1, default_value=0.3)"})
    assert e2.version == 2
    [trial] = e2.fetch_trials(with_evc_tree=True)
    assert trial.params["/y"] == 0.3
    assert set(e2.space.keys()) == {"/x", "/y"}


@BOTH
def test_branch_rename_dimension(pkg):
    P = PKG[pkg]
    storage = _memory(P)
    e1 = P.instantiate(P.build_experiment(storage, "d", priors={"/x": "uniform(0, 10)"}))
    _run_trials(P, e1, [4.0])
    e2 = P.build_experiment(storage, "d", priors={"/x": ">/z", "/z": "uniform(0, 10)"})
    assert e2.version == 2
    [trial] = e2.fetch_trials(with_evc_tree=True)
    assert "/z" in trial.params and "/x" not in trial.params


@BOTH
def test_branch_children_backward(pkg):
    P = PKG[pkg]
    storage = _memory(P)
    e1 = P.instantiate(P.build_experiment(storage, "e", priors={"/x": "uniform(0, 10)"}))
    _run_trials(P, e1, [1.0])
    e2 = P.instantiate(P.build_experiment(storage, "e", priors={"/x": "uniform(0, 5)"}))
    _run_trials(P, e2, [2.0])
    e1b = P.build_experiment(storage, "e", version=1)
    assert len(e1b.fetch_trials(with_evc_tree=True)) == 2


@BOTH
def test_concurrent_branching_bumps_version(pkg):
    P = PKG[pkg]
    storage = _memory(P)
    P.build_experiment(storage, "f", priors={"/x": "uniform(0, 10)"})
    a = P.build_experiment(storage, "f", priors={"/x": "uniform(0, 6)"})
    b = P.build_experiment(storage, "f", priors={"/x": "uniform(0, 7)"})
    assert {a.version, b.version} == {2, 3}


@BOTH
def test_rename_only_branch_keeps_dimension(pkg):
    P = PKG[pkg]
    storage = _memory(P)
    e1 = P.instantiate(P.build_experiment(storage, "ro", priors={"/x": "uniform(0, 10)"}))
    _run_trials(P, e1, [2.0])
    e2 = P.build_experiment(storage, "ro", priors={"/x": ">/z"})
    assert e2.version == 2 and e2.priors == {"/z": "uniform(0, 10)"}
    assert e2.space is not None
    tree_trials = e2.fetch_trials(with_evc_tree=True)
    assert tree_trials and "/z" in tree_trials[0].params


@BOTH
def test_algorithm_change_branches(pkg):
    P = PKG[pkg]
    storage = _memory(P)
    e1 = P.build_experiment(storage, "ac", priors={"/x": "uniform(0, 1)"})
    assert e1.algo_config == "random"
    assert P.build_experiment(storage, "ac", priors={"/x": "uniform(0, 1)"}).version == 1
    e3 = P.build_experiment(storage, "ac", priors={"/x": "uniform(0, 1)"},
                            algorithms={"tpe": {"n_init": 4}})
    assert e3.version == 2 and e3.algo_config == {"tpe": {"n_init": 4}}


@BOTH
def test_branched_child_warm_starts_from_parent(pkg):
    """The producer feeds adapted ancestor trials to the child's algorithm
    (the reference's scenario with a recording algorithm in place of its
    ``dumbalgo``)."""
    P = PKG[pkg]
    storage = _memory(P)
    e1 = P.instantiate(P.build_experiment(storage, "ws", priors={"/x": "uniform(0, 10)"},
                                          algorithms="random"))
    _run_trials(P, e1, [1.0, 2.0, 3.0])
    e2 = P.build_experiment(storage, "ws", priors={"/x": "uniform(0, 5)"})
    assert e2.version == 2
    e2.algorithm = P.Recording(e2.space, seed=0, **P.algo_kwargs)
    e2.strategy = P.create_strategy("MaxParallelStrategy")
    P.Producer(e2).update()
    parent_xs = [t.params["/x"] for t in storage.fetch_trials(uid=e1.id) if t.params["/x"] <= 5]
    assert sum(len(rows) for rows, _ in e2.algorithm.observed) == len(parent_xs)


@BOTH
def test_new_dimension_without_default_refuses_branch(pkg):
    P = PKG[pkg]
    storage = _memory(P)
    e1 = P.instantiate(P.build_experiment(storage, "nd", priors={"/x": "uniform(0, 10)"}))
    _run_trials(P, e1, [1.0])
    with pytest.raises(ValueError, match="default_value"):
        P.build_experiment(storage, "nd", priors={"/x": "uniform(0, 10)", "/y": "+uniform(0, 1)"})
    assert len(storage.fetch_experiments({"name": "nd"})) == 1


@BOTH
def test_tree_fetcher_incremental_reads_and_adaptation(pkg, monkeypatch):
    """Unchanged rounds read one signature per family node and adapt
    nothing; a new or changed parent trial is read and adapted alone."""
    P = PKG[pkg]
    storage = _memory(P)
    parent = P.build_experiment(storage, "tree", priors={"/x": "uniform(0, 1)"}, version=1)
    for i in range(5):
        storage.register_trial(P.Trial(experiment=parent.id, params={"/x": i / 10},
                                       results=[P.Result("o", "objective", float(i))],
                                       status="completed"))
    storage.create_experiment({
        "name": "tree", "version": 2, "priors": {"/x": "uniform(0, 1)", "/y": "uniform(0, 1)"},
        "refers": {"root_id": parent.id, "parent_id": parent.id, "adapter": {
            "of_type": "compositeadapter", "adapters": [
                {"of_type": "dimensionaddition", "name": "/y", "default_value": 0.5}]}},
        "_id": "child-id"})
    child = P.experiment.Experiment(storage, storage.fetch_experiments({"version": 2})[0])
    fetcher = P.evc.TreeTrialsFetcher(child)
    reads, adaptations = {"n": 0}, {"n": 0}
    read, forward = storage.db.read, P.adapters.DimensionAddition.forward

    def counting_read(collection, query=None, projection=None):
        if collection == "trials" and projection is None:
            reads["n"] += 1
        return read(collection, query=query, projection=projection)

    def counting_forward(self, trials):
        adaptations["n"] += len(trials)
        return forward(self, trials)

    monkeypatch.setattr(storage.db, "read", counting_read)
    monkeypatch.setattr(P.adapters.DimensionAddition, "forward", counting_forward)
    first = fetcher.fetch()
    assert len(first) == 5 and all("/y" in t.params for t in first)
    assert adaptations["n"] == 5
    before = reads["n"]
    for _ in range(10):
        assert len(fetcher.fetch()) == 5
    assert adaptations["n"] == 5 and reads["n"] - before == 10
    new = P.Trial(experiment=parent.id, params={"/x": 0.9},
                  results=[P.Result("o", "objective", 9.0)], status="completed")
    storage.register_trial(new)
    assert len(fetcher.fetch()) == 6 and adaptations["n"] == 6
    storage.db.write("trials", {"status": "broken"}, query={"_id": new.id})
    fetcher.fetch()
    assert adaptations["n"] == 7


@BOTH
def test_tree_fetcher_picks_up_midrun_branches(pkg):
    P = PKG[pkg]
    storage = _memory(P)
    parent = P.build_experiment(storage, "mid", priors={"/x": "uniform(0, 1)"})
    fetcher = P.evc.TreeTrialsFetcher(parent)
    assert fetcher.fetch() == []
    storage.create_experiment({
        "name": "mid", "version": 2, "priors": {"/x": "uniform(0, 1)"},
        "refers": {"root_id": parent.id, "parent_id": parent.id,
                   "adapter": {"of_type": "compositeadapter", "adapters": []}},
        "_id": "mid-child"})
    storage.register_trial(P.Trial(experiment="mid-child", params={"/x": 0.4},
                                   results=[P.Result("o", "objective", 1.0)],
                                   status="completed"))
    assert [t.params["/x"] for t in fetcher.fetch()] == [0.4]


def _prompt(pkg, priors, old=None):
    P = PKG[pkg]
    found = P.conflicts.detect_conflicts(old or _old_config(), {"priors": priors})
    builder_ = P.builder.ExperimentBranchBuilder(found, manual_resolution=True)
    return found, P.prompt.BranchingPrompt(builder_)


@BOTH
def test_branching_prompt_scripted_session(pkg, capsys):
    found, prompt = _prompt(pkg, {"/x": "uniform(0, 10)", "/y": "uniform(0, 5)"})
    prompt.cmdqueue = ["status", "add /y 2.5", "name exp2", "status", "commit"]
    prompt.cmdloop(intro="")
    assert "PENDING" in capsys.readouterr().out
    assert found.are_resolved
    assert "NewDimensionConflict" in {type(c).__name__ for c in found.conflicts}


@BOTH
def test_branching_prompt_bad_input_keeps_session(pkg, capsys):
    found, prompt = _prompt(pkg, {"/x": "uniform(0, 10)", "/y": "uniform(0, 5)"})
    prompt.cmdqueue = ["add /y", "add /y 1.0", "name exp2", "commit"]
    prompt.cmdloop(intro="")
    assert "cannot resolve" in capsys.readouterr().out
    assert found.are_resolved


@BOTH
def test_branching_prompt_per_command_completion(pkg):
    found, prompt = _prompt(pkg, {"/x": "uniform(0, 10)", "/y": "uniform(0, 5)"},
                            old=_old_config(priors={"/x": "uniform(0, 10)",
                                                    "/old": "uniform(0, 1)"}))
    assert prompt.complete_add("/", "add /", 4, 5) == ["/y"]
    assert prompt.complete_add("/z", "add /z", 4, 6) == []
    assert prompt.complete_remove("/", "remove /", 7, 8) == ["/old"]
    assert prompt.complete_rename("/", "rename /", 7, 8) == ["/old"]
    assert prompt.complete_rename("/", "rename /old /", 12, 13) == ["/y"]
    assert prompt.complete_code("un", "code un", 5, 7) == ["unsure"]
    assert prompt.complete_commandline("", "commandline ", 12, 12) == [
        "noeffect", "unsure", "break"]
    prompt.do_add("/y 2.5")
    assert prompt.complete_add("/", "add /", 4, 5) == []


@BOTH
def test_readonly_view_fetches_evc_tree(pkg):
    P = PKG[pkg]
    storage = _memory(P)
    e1 = P.instantiate(P.build_experiment(storage, "ro", priors={"/x": "uniform(0, 10)"},
                                          algorithms="random"))
    _run_trials(P, e1, [1.0, 2.0])
    e2 = P.build_experiment(storage, "ro", priors={"/x": "uniform(0, 5)"}, algorithms="random")
    assert e2.version == 2
    view = P.experiment.ExperimentView(e2)
    in_range = [t for t in storage.fetch_trials(uid=e1.id) if t.params["/x"] <= 5]
    assert len(view.fetch_trials(with_evc_tree=True)) == len(in_range)
    with pytest.raises(AttributeError):
        view.storage.db


# --- the CLI -------------------------------------------------------------------


def _box(tmp_path):
    """A copy of the functional tests' black box (outside any git
    repository) and a grid_search YAML: both packages suggest the same
    points."""
    shutil.copy(os.path.join(FUNCTIONAL, "black_box.py"), tmp_path / "black_box.py")
    (tmp_path / "grid.yaml").write_text(yaml.safe_dump(
        {"algorithms": {"grid_search": {"n_values": 4}}}))
    return str(tmp_path / "black_box.py"), str(tmp_path / "grid.yaml")


def _hunt(pkg, db, box, grid, prior, *extra, name="chain"):
    device = ["--device", "cpu"] if pkg == "port" else []
    return PKG[pkg].main(["hunt", "-n", name, "--storage-path", db, *device, "-c", grid,
                          "--max-trials", "4", "--worker-trials", "4", *extra, box,
                          f"-x~{prior}"])


def _store(db):
    kind = "sqlite" if db.endswith(".sqlite") else "pickled"
    storage = create_storage({"type": kind, "path": db})
    experiments = sorted((_strip_experiment(d) for d in storage.fetch_experiments({})),
                         key=lambda d: (d["name"], d["version"]))
    trials = {d["version"]: sorted(((t.id, t.params, t.objective.value if t.objective else None,
                                     t.status) for t in storage.fetch_trials(uid=d["_id"])))
              for d in experiments}
    return storage, experiments, trials


CHAIN = ("uniform(-50, 50)", "uniform(-30, 30)", "uniform(-10, 10)")


@pytest.mark.parametrize("backend", ["pkl", "sqlite"])
def test_three_generation_hunt_chain_through_both_clis(tmp_path, capsys, backend):
    """Three ``hunt`` calls, each narrowing the prior, branch v1 <- v2 <- v3
    in both CLIs: the same experiment documents (ids, ``refers`` and
    adapters), the same trials, the same ``status --expand-versions`` and
    ``list`` text; v3's tree holds its own trials and its ancestors'
    inside its prior, adapted over two hops."""
    box, grid = _box(tmp_path)
    dbs = {pkg: str(tmp_path / f"{pkg}.{backend}") for pkg in PKG}
    texts = {}
    for pkg, db in dbs.items():
        for prior in CHAIN:
            assert _hunt(pkg, db, box, grid, prior) == 0
        capsys.readouterr()
        texts[pkg] = []
        for argv in (["status", "-n", "chain", "--expand-versions"], ["list"]):
            assert PKG[pkg].main(argv + ["--storage-path", db]) == 0
            texts[pkg].append(capsys.readouterr().out)
    assert texts["port"] == texts["reference"]
    assert texts["port"][1] == "chain-v1\n└── chain-v2\n    └── chain-v3\n"
    storage, experiments, trials = _store(dbs["port"])
    assert (experiments, trials) == _store(dbs["reference"])[1:]
    v1, v2, v3 = experiments
    assert v3["refers"]["parent_id"] == v2["_id"] and v2["refers"]["parent_id"] == v1["_id"]
    assert v3["refers"]["root_id"] == v1["_id"] and v3["priors"] == {"/x": "uniform(-10, 10)"}
    tree = experiment.build_experiment(storage, "chain", version=3).fetch_trials(
        with_evc_tree=True)
    in_range = [t for v in (1, 2) for t in trials[v] if -10 <= t[1]["/x"] <= 10]
    assert len(tree) == len(trials[3]) + len(in_range) and len(trials[3]) == 4


@pytest.mark.parametrize("backend", ["pkl", "sqlite"])
def test_port_continues_a_chain_the_reference_branched(tmp_path, capsys, backend):
    """The reference hunts v1 and branches v2 on one file; the port's
    ``hunt`` with a narrower prior resumes there and branches v3 from the
    reference's v2: the same documents as the reference branching v3 on a
    copy of the file."""
    box, grid = _box(tmp_path)
    db = str(tmp_path / f"ref.{backend}")
    for prior in CHAIN[:2]:
        assert _hunt("reference", db, box, grid, prior) == 0
    copy = str(tmp_path / f"copy.{backend}")
    if backend == "sqlite":
        import sqlite3

        with sqlite3.connect(db) as source, sqlite3.connect(copy) as target:
            source.backup(target)
    else:
        shutil.copy(db, copy)
    assert _hunt("port", db, box, grid, CHAIN[2]) == 0
    assert _hunt("reference", copy, box, grid, CHAIN[2]) == 0
    capsys.readouterr()
    _, experiments, trials = _store(db)
    assert (experiments, trials) == _store(copy)[1:]
    assert [e["version"] for e in experiments] == [1, 2, 3]
    assert experiments[2]["refers"]["parent_id"] == experiments[1]["_id"]


def test_branch_to_and_manual_resolution_through_the_cli(tmp_path, capsys, monkeypatch):
    """``--branch-to`` names the child; ``--manual-resolution`` runs the
    branching prompt on the standard input (here a scripted session that
    renames the child and commits), in both CLIs alike."""
    import io

    box, grid = _box(tmp_path)
    out = {}
    for pkg in PKG:
        db = str(tmp_path / f"{pkg}.sqlite")
        assert _hunt(pkg, db, box, grid, CHAIN[0], name="orig") == 0
        assert _hunt(pkg, db, box, grid, CHAIN[1], "--branch-to", "forked", name="orig") == 0
        monkeypatch.setattr("sys.stdin", io.StringIO("status\nname manual\nauto\ncommit\n"))
        assert _hunt(pkg, db, box, grid, CHAIN[2], "--manual-resolution", name="forked") == 0
        capsys.readouterr()
        out[pkg] = _store(db)[1:]
    assert out["port"] == out["reference"]
    experiments, trials = out["port"]
    assert [(e["name"], e["version"]) for e in experiments] == [
        ("forked", 1), ("manual", 1), ("orig", 1)]
    forked, manual, orig = experiments
    assert forked["refers"]["parent_id"] == orig["_id"]
    assert manual["refers"]["parent_id"] == forked["_id"]
    assert manual["refers"]["root_id"] == forked["refers"]["root_id"] == orig["_id"]
    assert manual["priors"] == {"/x": "uniform(-10, 10)"} and len(trials[1]) == 4
