"""The port's lock rules and rule engine (``orion_tpu_torch.analysis``:
``engine``, ``lock_rules``) against ``orion_tpu.analysis``'s.

Both packages' ``LCK`` rules run over the same fixture sources — the
reference's lint fixtures, every file of ``tests/fixtures/lint/``, and the
lock fixtures copied beside the port's two suppression fixtures in
``tests/fixtures/torch_lint/`` — and must give the same diagnostics (path,
line, column, rule, message).  The port's fixtures' ``# expect:``
annotations are matched exactly; LCK003 fires on a runtime edge the static
graph lacks in both; the static<->dynamic cross-check agrees; and the
port's own tree lints clean under LCK001/LCK002 (each finding there carries
a reasoned suppression).
"""

import os
import re

import pytest

from orion_tpu.analysis import engine as ref_engine
from orion_tpu.analysis import lock_rules as ref_lock_rules
from orion_tpu.analysis import sanitizer as ref_sanitizer
from orion_tpu_torch.analysis import engine, format_human, format_json, rule_catalog, run_lint
from orion_tpu_torch.analysis import lock_rules, sanitizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "lint")
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_lint")
_EXPECT_RE = re.compile(r"#\s*expect:\s*([A-Z0-9_,\s]+?)\s*$")


def _fixture_paths():
    return sorted(os.path.join(d, f) for d in (REF_FIXTURES, FIXTURES)
                  for f in os.listdir(d) if f.endswith(".py"))


def _diags(diagnostics):
    return [d.to_dict() for d in diagnostics]


def _ref_lck(paths, **kwargs):
    return _diags(ref_engine.run_lint(paths, rules=[cls() for cls in ref_lock_rules.LOCK_RULES],
                                      **kwargs))


def _expected(path):
    expected = {}
    with open(path) as handle:
        for lineno, line in enumerate(handle, start=1):
            match = _EXPECT_RE.search(line)
            if match:
                expected[lineno] = {p.strip() for p in match.group(1).split(",") if p.strip()}
    return expected


@pytest.mark.parametrize("path", _fixture_paths(), ids=lambda p: os.path.relpath(p, ROOT))
def test_lock_rules_give_the_reference_diagnostics(path):
    """Every fixture, the engine's own LNT findings included (malformed
    suppressions, always reported), under the LCK family: selected by
    prefix, and run alone."""
    got = _diags(run_lint([path], select=["LCK"]))
    assert got == _ref_lck([path])
    assert got == _diags(run_lint([path], rules=[cls() for cls in lock_rules.LOCK_RULES]))


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(FIXTURES)
                                        if f.endswith(".py") and f not in (
                                            "tsan_edge_cases.py",
                                            "lock_malformed_suppression.py")))
def test_fixture_produces_exactly_the_annotated_diagnostics(name):
    path = os.path.join(FIXTURES, name)
    actual = {}
    for diag in run_lint([path]):
        actual.setdefault(diag.line, set()).add(diag.rule_id)
    assert actual == _expected(path)


def test_reasonless_suppression_is_flagged_and_not_honored():
    path = os.path.join(FIXTURES, "lock_malformed_suppression.py")
    got = [(d.rule_id, d.line) for d in run_lint([path])]
    line = len(open(path).read().splitlines())
    assert got == [("LCK002", line), ("LNT001", line)]


def test_every_lock_rule_has_a_firing_fixture():
    annotated = set()
    for name in os.listdir(FIXTURES):
        for ids in _expected(os.path.join(FIXTURES, name)).values():
            annotated |= ids
    catalog = [r for r in rule_catalog() if r[0].startswith("LCK")]
    assert [rule_id for rule_id, _, _ in catalog] == ["LCK001", "LCK002", "LCK003"]
    assert {rule_id for rule_id, _, _ in catalog} <= annotated
    ref = {r[0]: r for r in ref_engine.rule_catalog()}
    assert [(i, n) for i, n, _ in catalog] == [(i, ref[i][1]) for i, _, _ in catalog]


@pytest.mark.parametrize("edges_from", ["report_paths", "linted_paths"])
def test_lck003_fires_on_runtime_edge_the_static_graph_lacks(edges_from, tmp_path):
    """A lock-order edge observed at runtime between two statically
    declared locks that the static graph never derived is an LCK003 at the
    observed acquisition site, in both packages; a modeled edge and one
    between locks the tree does not declare stay quiet; a reasoned
    suppression at the acquisition argues the edge away."""
    path = os.path.join(FIXTURES, "tsan_edge_cases.py")
    (line,) = [n for n, ids in _expected(path).items() if "LCK003" in ids]
    assert run_lint([path], select=["LCK"]) == []
    target = path if edges_from == "linted_paths" else os.path.realpath(path)
    edges = [{"outer": "Server._persist_lock", "inner": "Store._lock", "path": target,
              "line": line},
             {"outer": "Server._persist_lock", "inner": "tsan_edge_cases.OTHER",
              "path": target, "line": line},
             {"outer": "Elsewhere._lock", "inner": "Other._lock", "path": target,
              "line": line}]
    got = []
    for module, lint in ((sanitizer, run_lint), (ref_sanitizer, ref_engine.run_lint)):
        module.set_lint_runtime_edges(edges)
        try:
            got.append(_diags(lint([path], select=["LCK"])))
        finally:
            module.set_lint_runtime_edges(None)
    assert got[0] == got[1]
    assert [(d["rule"], d["line"]) for d in got[0]] == [("LCK003", line)]
    suppressed = tmp_path / "suppressed.py"
    suppressed.write_text(open(path).read().replace(
        "            with self.db._lock:  # expect: LCK003\n",
        "            # lint: disable=LCK003 -- test: one-directional\n"
        "            with self.db._lock:  # expect: LCK003\n"))
    sanitizer.set_lint_runtime_edges([dict(edges[0], path=str(suppressed), line=line + 1)])
    try:
        assert run_lint([str(suppressed)], select=["LCK"]) == []
    finally:
        sanitizer.set_lint_runtime_edges(None)


def test_runtime_edges_come_from_the_env_file(monkeypatch, tmp_path):
    """Without an in-process override, the ``ORION_TPU_TSAN_EDGES`` file (a
    tsan report or a bare edge list) feeds LCK003, as in the reference."""
    report = tmp_path / "report.json"
    edges = [{"outer": "A", "inner": "B", "path": "p", "line": 3}, "junk"]
    report.write_text('{"edges": %s}' % str(edges).replace("'", '"'))
    monkeypatch.setenv("ORION_TPU_TSAN_EDGES", str(report))
    assert sanitizer.lint_runtime_edges() == ref_sanitizer.lint_runtime_edges() == edges[:1]
    monkeypatch.setenv("ORION_TPU_TSAN_EDGES", str(tmp_path / "missing.json"))
    assert sanitizer.lint_runtime_edges() == []


def test_cross_check_matches_the_reference(tmp_path):
    source = ("import threading\n\n\nclass A:\n    def __init__(self):\n"
              "        self._lock = threading.Lock()\n\n    def fwd(self):\n"
              "        with self._lock:\n            with B_LOCK:\n                pass\n\n\n"
              "class Hidden:\n    def __init__(self):\n        self._lock = threading.Lock()\n\n\n"
              "class P:\n    def __init__(self):\n        self._a = threading.Lock()\n"
              "        self._b = threading.Lock()\n\n    def fwd(self):\n        with self._a:\n"
              "            with self._b:\n                pass\n\n    def bwd(self):\n"
              "        with self._b:\n            with self._a:\n                pass\n\n\n"
              "B_LOCK = threading.Lock()\n")
    path = tmp_path / "scenario.py"
    path.write_text(source)
    cases = [
        [{"outer": "A._lock", "inner": "scenario.B_LOCK", "path": str(path), "line": 10},
         {"outer": "scenario.B_LOCK", "inner": "Hidden._lock", "path": str(path), "line": 12},
         {"outer": "Elsewhere._x", "inner": "Elsewhere._y", "path": str(path), "line": 1}],
        [{"outer": "P._a", "inner": "P._b", "path": str(path), "line": 26},
         {"outer": "P._b", "inner": "P._a", "path": str(path), "line": 31}],
        [{"outer": "P._a", "inner": "P._b", "path": str(path), "line": 26}],
    ]
    got = [sanitizer.cross_check_static(edges, [str(path)]) for edges in cases]
    assert got == [ref_sanitizer.cross_check_static(edges, [str(path)]) for edges in cases]
    assert [(e["outer"], e["inner"]) for e in got[0]["unmodeled_edges"]] == [
        ("scenario.B_LOCK", "Hidden._lock")]
    assert [set(c) for c in got[1]["confirmed_static_cycles"]] == [{"P._a", "P._b"}]
    assert got[2]["confirmed_static_cycles"] == []


def test_engine_reports_bad_paths_and_refuses_unknown_prefixes(tmp_path):
    """A missing path, a non-Python file, an empty directory and a file
    that does not parse are findings, as in the reference; a select
    prefix no registered rule matches raises, as a misspelt family does."""
    (tmp_path / "empty").mkdir()
    (tmp_path / "notes.txt").write_text("x")
    (tmp_path / "broken.py").write_text("def f(:\n")
    paths = [str(tmp_path / "missing.py"), str(tmp_path / "notes.txt"),
             str(tmp_path / "empty"), str(tmp_path / "broken.py")]
    got = _diags(run_lint(paths))
    assert got == _ref_lck(paths)
    assert sorted(d["rule"] for d in got) == ["LNT002", "LNT003", "LNT003", "LNT003"]
    for prefix in ("LK", "JT", "ST0", "PREF"):
        with pytest.raises(ValueError, match="matches no rule id"):
            run_lint([str(tmp_path / "broken.py")], select=[prefix])


def test_overlapping_paths_are_linted_once_and_formats_match():
    path = os.path.join(FIXTURES, "lock_cases.py")
    assert engine.iter_python_files([FIXTURES, path]) == ref_engine.iter_python_files(
        [FIXTURES, path])
    diags = run_lint([FIXTURES, path], select=["LCK"])
    assert _diags(diags) == _ref_lck([FIXTURES, path])
    assert format_human(diags) == ref_engine.format_human(
        ref_engine.run_lint([FIXTURES, path],
                            rules=[cls() for cls in ref_lock_rules.LOCK_RULES]))
    assert format_json(diags) == ref_engine.format_json(
        ref_engine.run_lint([FIXTURES, path],
                            rules=[cls() for cls in ref_lock_rules.LOCK_RULES]))


def test_port_tree_is_clean_under_lck001_and_lck002():
    """``run_lint(["orion_tpu_torch"], select=["LCK001", "LCK002"])``: no
    finding; the sites the rules would flag carry a reasoned suppression
    (the netdb server's and client's ``_locked``-contract mutations)."""
    tree = os.path.join(ROOT, "orion_tpu_torch")
    assert _diags(run_lint([tree], select=["LCK001", "LCK002"])) == []
    suppressed = 0
    for path in engine.iter_python_files([tree]):
        module, error = engine.load_module(path)
        assert error is None and module.engine_diagnostics == []
        suppressed += sum(1 for ids, reason in module._suppressions.values()
                          if ids & {"LCK001", "LCK002", "LCK003"} and reason)
    assert suppressed >= 7
