"""The port's static rule families (``orion_tpu_torch.analysis``:
``storage_rules``, ``telemetry_rules``, ``perf_rules``, ``jit_rules``),
the ``lint`` and ``docgen`` commands, and the port's self-lint.

- The families whose meaning carries over (``STO*``, ``TEL*``,
  ``PERF001``, ``PERF002``) give the reference's diagnostics (path, line,
  column, rule, message) on every reference fixture.
- The capture rules (``JIT*``, rewritten for CUDA-graph captures) and the
  rewritten ``PERF003`` are held to the port's own fixtures in
  ``tests/fixtures/torch_lint/`` (``# expect:`` annotations, both
  directions), to a call tree across modules, to the 0-d index fault, and
  to ``_suggest_step``'s Python statics staying quiet where the
  reference's jit rules flag them.
- ``orion-tpu-torch lint orion_tpu_torch chip_smoke.py`` is clean.
"""

import json
import os
import re

import pytest

from orion_tpu.analysis import engine as ref_engine
from orion_tpu_torch.analysis import engine, rule_catalog, run_lint
from orion_tpu_torch.analysis.jit_rules import captured_spans
from orion_tpu_torch.cli import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "lint")
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_lint")
TREE = os.path.join(ROOT, "tests", "fixtures", "torch_capture_tree")
TORCH_FIXTURES = ("capture_cases.py", "capture_rules_cases.py", "capture_sites_cases.py",
                  "perf003_cases.py")
_EXPECT_RE = re.compile(r"#\s*expect:\s*([A-Z0-9_,\s]+?)\s*$")


def _diags(diagnostics):
    return [d.to_dict() for d in diagnostics]


def _expected(path, prefixes=("",)):
    out = {}
    with open(path) as handle:
        for lineno, line in enumerate(handle, start=1):
            match = _EXPECT_RE.search(line)
            if match:
                ids = {p.strip() for p in match.group(1).split(",") if p.strip()}
                ids = {i for i in ids if i.startswith(prefixes)}
                if ids:
                    out[(os.path.realpath(path), lineno)] = ids
    return out


def _actual(diagnostics):
    out = {}
    for d in diagnostics:
        out.setdefault((os.path.realpath(d.path), d.line), set()).add(d.rule_id)
    return out


@pytest.mark.parametrize("family", ["STO", "TEL", "PERF001", "PERF002"])
@pytest.mark.parametrize("name", sorted(f for f in os.listdir(REF_FIXTURES) if f.endswith(".py")))
def test_carried_over_families_give_the_reference_diagnostics(name, family):
    path = os.path.join(REF_FIXTURES, name)
    assert _diags(run_lint([path], select=[family])) == _diags(
        ref_engine.run_lint([path], select=[family]))


def test_carried_over_families_fire_on_the_reference_fixtures():
    """Every STO, TEL, PERF001 and PERF002 rule fires somewhere in the
    reference fixtures (so the parity above compares findings, not
    silence), and the port's rules keep the reference's ids and names."""
    fired = {d.rule_id for d in run_lint([REF_FIXTURES], select=["STO", "TEL", "PERF00"])}
    ours = {r[0]: r[1] for r in rule_catalog()}
    ref = {r[0]: r[1] for r in ref_engine.rule_catalog()}
    carried = sorted(i for i in ours if i.startswith(("STO", "TEL")) or i in ("PERF001",
                                                                                 "PERF002"))
    assert carried == sorted(i for i in ref if i.startswith(("STO", "TEL"))
                             or i in ("PERF001", "PERF002"))
    assert set(carried) <= fired
    assert {i: ours[i] for i in carried} == {i: ref[i] for i in carried}


@pytest.mark.parametrize("name", TORCH_FIXTURES)
def test_capture_fixture_gives_exactly_its_annotations(name):
    """JIT and PERF003 findings of each torch fixture, annotated line by
    line, both directions."""
    path = os.path.join(FIXTURES, name)
    got = _actual(run_lint([path], select=["JIT", "PERF003"]))
    assert got == _expected(path, ("JIT", "PERF003"))


def test_every_capture_rule_and_perf003_fires_in_a_fixture():
    annotated = set()
    for name in TORCH_FIXTURES:
        for ids in _expected(os.path.join(FIXTURES, name)).values():
            annotated |= ids
    ids = [r[0] for r in rule_catalog() if r[0].startswith("JIT") or r[0] == "PERF003"]
    assert ids == ["JIT001", "JIT002", "JIT003", "JIT004", "PERF003"]
    assert set(ids) <= annotated


def test_call_tree_is_resolved_across_modules():
    """``_suggest_step`` in one module reaches helpers in another through a
    ``from`` import, a module alias and a re-export from a third: their
    hazards are findings only when the whole tree is linted; a helper no
    captured function reaches stays quiet."""
    files = sorted(os.path.join(TREE, f) for f in os.listdir(TREE) if f.endswith(".py"))
    expected = {}
    for path in files:
        expected.update(_expected(path))
    assert expected and _actual(run_lint([TREE])) == expected
    for path in files:  # alone, a module's callers or callees are unseen
        assert run_lint([path], select=["JIT"]) == []
    spans = {name for _path, name, _first, _last in captured_spans([TREE])}
    assert spans == {"_suggest_step", "fit", "_finish", "acquire", "rank"}


def test_the_port_round_is_captured_with_its_whole_call_tree():
    """The port's captured functions include ``_suggest_step`` and what it
    calls in other modules: the fit, the acquisition, the pool posterior
    and the kernel's wrapper."""
    names = {(os.path.relpath(path, ROOT), name)
             for path, name, _first, _last in captured_spans([os.path.join(ROOT,
                                                                          "orion_tpu_torch")])}
    for want in [("orion_tpu_torch/algo/tpu_bo.py", "_suggest_step"),
                 ("orion_tpu_torch/algo/gp/gp.py", "fit_gp"),
                 ("orion_tpu_torch/algo/gp/gp.py", "posterior_norm"),
                 ("orion_tpu_torch/algo/gp/acquisition.py", "rff_thompson"),
                 ("orion_tpu_torch/algo/gp/kernels.py", "cross_kernel_matrix"),
                 ("orion_tpu_torch/ops/gram.py", "fused_gram")]:
        assert want in names, want
    assert ("orion_tpu_torch/algo/tpu_bo.py", "make_fused_plan") not in names


@pytest.mark.parametrize("index,flagged", [
    ("x[torch.argmin(y)]", True),
    ("x[i]", True),
    ("x[y.sum()]", True),
    ("x[i + 1]", True),
    ("x[:, torch.argmax(y)]", True),
    ("x[torch.full((), 0, dtype=torch.long)]", True),
    ("torch.index_select(x, 0, i[None])[0]", False),
    ("x[i[None]]", False),
    ("x[torch.argmin(y, dim=0)]", False),
    ("x[0]", False),
    ("x[torch.argsort(y)[:4]]", False),
])
def test_indexing_by_a_zero_d_tensor_is_a_host_sync(tmp_path, index, flagged):
    """The fault that once broke every capture of the round:
    ``free_candidates[exploit_idx]`` with ``exploit_idx = torch.argmin(mean)``
    read the index to the host; ``index_select`` with a 1-element index
    does not."""
    path = tmp_path / "zero_d.py"
    path.write_text(
        "import torch\n\n\n"
        "def _suggest_step(x, y, *, q):\n"
        "    i = torch.argmin(y)\n"
        f"    return {index}\n"
    )
    got = [(d.rule_id, d.line) for d in run_lint([str(path)], select=["JIT"])]
    assert got == ([("JIT001", 6)] if flagged else [])


def test_suggest_step_statics_stay_quiet_where_the_reference_flags_them():
    """The reference's jit rules read ``_suggest_step``'s ``trust_region``,
    ``fixed_tail_cols`` and ``acq`` as traced and flag five branches
    (JIT002); a capture bakes those statics in, and the port's capture
    rules leave them quiet (the whole tree lints clean)."""
    tpu_bo = os.path.join(ROOT, "orion_tpu_torch", "algo", "tpu_bo.py")
    reference = ref_engine.run_lint([tpu_bo], select=["JIT002"])
    with open(tpu_bo) as handle:
        source = handle.read().splitlines()
    assert len(reference) == 5
    for d in reference:
        assert re.match(r"\s*if (trust_region|fixed_tail_cols|acq ==)", source[d.line - 1])
    assert run_lint([tpu_bo], select=["JIT"]) == []


def test_static_branch_convention_keyword_only_statics_and_positional_tensors(tmp_path):
    """A captured root's keyword-only parameters are statics and its
    positional ones tensors, and tensor-ness follows a callee's parameter
    by keyword as well as by position."""
    path = tmp_path / "convention.py"
    path.write_text(
        "def _suggest_step(x, flag, *, static):\n"
        "    if static:\n"
        "        x = x + 1\n"
        "    if flag:\n"
        "        x = x - 1\n"
        "    return helper(x, scale=flag, mode=static)\n\n\n"
        "def helper(x, *, scale, mode):\n"
        "    if mode:\n"
        "        return x\n"
        "    return x * scale.item()\n"
    )
    got = [(d.rule_id, d.line) for d in run_lint([str(path)], select=["JIT"])]
    assert got == [("JIT002", 4), ("JIT001", 12)]


def test_self_lint_of_the_port_is_clean(capsys):
    """``orion-tpu-torch lint orion_tpu_torch chip_smoke.py`` exits 0 and
    prints ``clean``: every finding of every family is repaired or carries
    a reasoned suppression."""
    rc = main(["lint", os.path.join(ROOT, "orion_tpu_torch"), os.path.join(ROOT,
                                                                           "chip_smoke.py")])
    out = capsys.readouterr().out
    assert (rc, out.strip()) == (0, "clean")


def test_lint_command_exit_codes_and_json(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("def f(x):\n    return x\n")
    path = os.path.join(FIXTURES, "capture_rules_cases.py")
    assert main(["lint", str(clean)]) == 0
    assert capsys.readouterr().out.strip() == "clean"
    assert main(["lint", path]) == 1
    human = capsys.readouterr().out.splitlines()
    assert main(["lint", "--format", "json", path]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["count"] == len(report["violations"]) == len(human) - 1
    assert report["violations"] == _diags(run_lint([path]))
    assert main(["lint", "--select", "JIT002", "--format", "json", path]) == 1
    assert {v["rule"] for v in json.loads(capsys.readouterr().out)["violations"]} == {"JIT002"}
    assert main(["lint", "--ignore", "JIT,PERF", path]) == 0
    capsys.readouterr()
    assert main(["lint", str(tmp_path / "missing.py")]) == 2
    capsys.readouterr()
    assert main(["lint", "--select", "JT", path]) == 2
    assert "matches no rule id" in capsys.readouterr().err


def test_lint_list_rules_shows_every_family(capsys):
    assert main(["lint", "--list-rules"]) == 0
    ids = [line.split()[0] for line in capsys.readouterr().out.splitlines()
           if line and not line.startswith(" ")]
    assert ids == [r[0] for r in rule_catalog()]
    assert {i.rstrip("0123456789") for i in ids} == {"JIT", "STO", "TEL", "LCK", "PERF"}
    families = [r.id.rstrip("0123456789") for r in engine.default_rules()]
    ref_families = [r[0].rstrip("0123456789") for r in ref_engine.rule_catalog()]
    assert list(dict.fromkeys(families)) == list(dict.fromkeys(ref_families))


def test_lint_default_path_is_the_installed_package(monkeypatch):
    """No path: the installed ``orion_tpu_torch`` (the engine is stubbed
    to record the paths; the tree itself is linted above)."""
    import orion_tpu_torch.analysis as analysis

    seen = []
    monkeypatch.setattr(analysis, "run_lint", lambda paths, **kw: seen.append(paths) or [])
    assert main(["lint"]) == 0
    assert seen == [[os.path.join(ROOT, "orion_tpu_torch")]]


def test_torch_commands_md_is_current():
    """``docs/torch_commands.md`` is ``python -m orion_tpu_torch.cli.docgen``'s
    output; the reference's ``docs/commands.md`` is left alone."""
    from orion_tpu_torch.cli.docgen import DEFAULT_OUT, generate_markdown

    with open(os.path.join(ROOT, DEFAULT_OUT)) as handle:
        assert handle.read() == generate_markdown()
    assert "## `lint`" in generate_markdown()


def test_docgen_writes_the_reference_to_a_path(tmp_path, capsys):
    from orion_tpu_torch.cli import docgen

    out = tmp_path / "commands.md"
    docgen.main([str(out)])
    assert out.read_text() == docgen.generate_markdown()
    assert capsys.readouterr().out.startswith(f"wrote {out} ")
