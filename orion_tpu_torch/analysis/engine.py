"""Rule-engine core for the port's static analysis (port of
``orion_tpu/analysis/engine.py``).

The port's fast paths rest on conventions nothing in Python enforces: the
GP round must stay capturable as a CUDA graph, every storage protocol op
must ride the unified retry policy with a declared applied-or-not mode,
telemetry must be allocation-free when disabled, the producer's round must
stay vectorized, and the cross-thread objects must keep one lock
discipline.  This engine machine-checks them, so a change that breaks one
fails a test instead of a review.

Design:

- A :class:`Module` is one parsed file (source, AST with parent links,
  comment map, suppressions).  Parsing happens once; every rule shares it.
- A :class:`Rule` sees the whole project first (``begin``), then each module
  (``check``), then gets a project-wide ``finalize`` — so cross-file
  analyses (the static lock graph) ride the same protocol as single-file
  checks.
- Suppressions are per-line comments ``# lint: disable=RULE1,RULE2 -- reason``.
  The trailing reason is MANDATORY (enforced here as ``LNT001``): a silenced
  rule must say why, or the suppression is itself a violation.  A standalone
  suppression comment applies to the next line as well, so multi-line
  statements can be annotated above.

Rule identifiers are grouped by family: ``JIT*`` (CUDA-graph capture
hazards, ``jit_rules``), ``STO*`` (storage retry coverage,
``storage_rules``), ``TEL*`` (telemetry discipline, ``telemetry_rules``),
``LCK*`` (lock order and shared state, ``lock_rules``), ``PERF*`` (hot-path
vectorization and cold-path introspection, ``perf_rules``), and ``LNT*``
(the engine's own checks).  ``orion-tpu-torch lint --list-rules`` prints
the catalog.
"""

import ast
import io
import json
import os
import re
import tokenize

#: ``# lint: disable=RULE1,RULE2 -- reason`` — the reason clause is
#: mandatory; LNT001 fires on a suppression without one.
_SUPPRESS_RE = re.compile(
    # Anchored to the START of the comment: prose that merely MENTIONS the
    # syntax mid-sentence must not mint a live suppression.
    r"^#+\s*lint:\s*disable=([A-Za-z0-9_*,\s]+?)(?:\s*--\s*(.*\S))?\s*$"
)

#: Engine-level rule ids (not pluggable rules — always on).
MALFORMED_SUPPRESSION = "LNT001"
SYNTAX_ERROR = "LNT002"
UNREADABLE_PATH = "LNT003"


class Diagnostic:
    """One finding: file/line/col position, rule id, human message."""

    __slots__ = ("path", "line", "col", "rule_id", "message")

    def __init__(self, path, line, col, rule_id, message):
        self.path = path
        self.line = int(line)
        self.col = int(col)
        self.rule_id = rule_id
        self.message = message

    def format(self):
        return f"{self.path}:{self.line}:{self.col}: {self.rule_id} {self.message}"

    def to_dict(self):
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule_id,
            "message": self.message,
        }

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<Diagnostic {self.format()}>"


class Rule:
    """Base class for lint rules.

    Subclasses set ``id``/``name``/``description`` and implement ``check``.
    Cross-file rules collect global state in ``begin`` (called once with
    every parsed module, before any ``check``) and report project-wide
    findings from ``finalize``.  One rule instance lints one project run —
    instances are created fresh per :func:`run_lint` call, so state needs
    no reset discipline.
    """

    id = "LNT000"
    name = "abstract"
    description = ""

    def begin(self, modules):
        """Project-wide pre-pass; ``modules`` is every parsed Module."""

    def check(self, module):
        """Yield Diagnostics for one module."""
        return ()

    def finalize(self):
        """Yield project-wide Diagnostics after every module was checked."""
        return ()


class Module:
    """One parsed source file shared by every rule."""

    def __init__(self, path, source):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.engine_diagnostics = []
        # line -> (frozenset of rule ids, reason or None)
        self._suppressions = {}
        self._collect_comments()
        self._extend_suppressions_past_decorators()
        annotate_parents(self.tree)

    def _collect_comments(self):
        source_lines = self.source.splitlines()
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                line = tok.start[0]
                match = _SUPPRESS_RE.search(tok.string)
                if not match:
                    continue
                ids = frozenset(
                    part.strip() for part in match.group(1).split(",") if part.strip()
                )
                reason = match.group(2)
                if "*" in ids:
                    # One wildcard would mute every current AND future rule
                    # with a single reason — the opposite of an audited
                    # list of argued exceptions.
                    self.engine_diagnostics.append(
                        Diagnostic(
                            self.path,
                            line,
                            tok.start[1],
                            MALFORMED_SUPPRESSION,
                            "wildcard suppression '*' is not allowed: "
                            "name the specific rule id(s)",
                        )
                    )
                    continue
                if not reason:
                    self.engine_diagnostics.append(
                        Diagnostic(
                            self.path,
                            line,
                            tok.start[1],
                            MALFORMED_SUPPRESSION,
                            "suppression without a reason: write "
                            "'# lint: disable=RULE -- why it is safe here'",
                        )
                    )
                    continue
                self._add_suppression(line, ids, reason)
                # A standalone comment line annotates the next CODE line:
                # skip stacked comment lines and blanks so several reasoned
                # suppressions can sit above one statement (each merges via
                # _add_suppression), and multi-line statements can carry
                # the suppression above.
                before = source_lines[line - 1][: tok.start[1]]
                if not before.strip():
                    target = line + 1
                    while target <= len(source_lines):
                        text = source_lines[target - 1].strip()
                        if text and not text.startswith("#"):
                            break
                        target += 1
                    self._add_suppression(target, ids, reason)
        except tokenize.TokenError:  # pragma: no cover - parse already passed
            pass

    def _add_suppression(self, line, ids, reason):
        # Merge, never overwrite: a line can be covered both by its own
        # inline comment and by a standalone comment above, each naming
        # different rules — both suppressions must hold.
        existing = self._suppressions.get(line)
        if existing is not None:
            ids = existing[0] | ids
            if existing[1] != reason:
                reason = f"{existing[1]}; {reason}"
        self._suppressions[line] = (ids, reason)

    def _extend_suppressions_past_decorators(self):
        # A suppression landing on a decorator line (standalone comment
        # above the decorator, or inline on it) must also reach the
        # def/class line, where the rules anchor their diagnostics —
        # otherwise the documented above-the-statement form is silently
        # ineffective on decorated functions.
        for node in ast.walk(self.tree):
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            for deco in node.decorator_list:
                entry = self._suppressions.get(deco.lineno)
                if entry is not None:
                    self._add_suppression(node.lineno, *entry)

    def suppressed(self, line, rule_id):
        entry = self._suppressions.get(line)
        if entry is None:
            return False
        ids, _reason = entry
        return rule_id in ids


# --- shared AST helpers ------------------------------------------------------


def annotate_parents(tree):
    """Attach ``.lint_parent`` links so rules can walk upward."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.lint_parent = node
    return tree


def ancestors(node):
    """Yield parent chain from the immediate parent to the module root."""
    node = getattr(node, "lint_parent", None)
    while node is not None:
        yield node
        node = getattr(node, "lint_parent", None)


def enclosing_function(node):
    """The innermost FunctionDef/AsyncFunctionDef containing ``node``."""
    for parent in ancestors(node):
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return parent
    return None


def enclosing_class(node):
    """The innermost ClassDef containing ``node``."""
    for parent in ancestors(node):
        if isinstance(parent, ast.ClassDef):
            return parent
    return None


def dotted_name(node):
    """Dotted source form of a Name/Attribute chain, or None.

    ``self._lock`` -> "self._lock", ``tel.TELEMETRY.count`` ->
    "tel.TELEMETRY.count".  Subscripts/calls in the chain yield None —
    rules match on static attribute paths only."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_functions(tree):
    """Every function/method in the module, including nested ones."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def arg_names(fn):
    """All parameter names of a function def, in positional order first."""
    args = fn.args
    ordered = [a.arg for a in args.posonlyargs + args.args]
    extra = [a.arg for a in args.kwonlyargs]
    if args.vararg:
        extra.append(args.vararg.arg)
    if args.kwarg:
        extra.append(args.kwarg.arg)
    return ordered, extra


# --- discovery / running -----------------------------------------------------

_SKIP_DIRS = {"__pycache__", ".git", "node_modules", ".ruff_cache"}


def iter_python_files(paths):
    """Expand files/directories into a list of .py files, sorted within
    each argument and deduplicated across them — overlapping arguments
    (``orion_tpu_torch orion_tpu_torch/storage/netdb.py``) must not lint a file
    twice and double its diagnostics."""
    out = []
    seen = set()

    def add(candidate):
        real = os.path.realpath(candidate)
        if real not in seen:
            seen.add(real)
            out.append(candidate)

    for path in paths:
        if os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(
                    d for d in dirs if d not in _SKIP_DIRS and not d.startswith(".")
                )
                for name in sorted(files):
                    if name.endswith(".py"):
                        add(os.path.join(root, name))
        elif path.endswith(".py") and os.path.isfile(path):
            add(path)
    return out


def load_module(path):
    """Parse one file; an unparsable file becomes a Diagnostic, not a
    crash — ast.parse raises ValueError (not SyntaxError) on null bytes,
    and a non-UTF-8 file fails at read time."""
    try:
        with open(path, encoding="utf-8") as handle:
            source = handle.read()
        return Module(path, source), None
    except SyntaxError as exc:
        return None, Diagnostic(
            path,
            exc.lineno or 1,
            exc.offset or 0,
            SYNTAX_ERROR,
            f"syntax error: {exc.msg}",
        )
    except (ValueError, UnicodeDecodeError) as exc:
        return None, Diagnostic(path, 1, 0, SYNTAX_ERROR, f"unparsable file: {exc}")
    except OSError as exc:
        return None, Diagnostic(path, 1, 0, UNREADABLE_PATH, f"cannot read file: {exc}")


def default_rules():
    """Fresh instances of every registered rule family."""
    from orion_tpu_torch.analysis.jit_rules import JIT_RULES
    from orion_tpu_torch.analysis.lock_rules import LOCK_RULES
    from orion_tpu_torch.analysis.perf_rules import PERF_RULES
    from orion_tpu_torch.analysis.storage_rules import STORAGE_RULES
    from orion_tpu_torch.analysis.telemetry_rules import TELEMETRY_RULES

    rules = []
    for family in (
        JIT_RULES, STORAGE_RULES, TELEMETRY_RULES, LOCK_RULES, PERF_RULES
    ):
        rules.extend(cls() for cls in family)
    return rules


def rule_catalog():
    """(id, name, description) for every registered rule — docs and --help."""
    return [(r.id, r.name, r.description) for r in default_rules()]


def _selected(rule_id, select, ignore):
    """Prefix filtering: --select JIT keeps the family, --ignore JIT002
    drops one rule.  Ignore wins over select."""
    if ignore and any(rule_id.startswith(pat) for pat in ignore):
        return False
    if select:
        return any(rule_id.startswith(pat) for pat in select)
    return True


def run_lint(paths, select=None, ignore=None, rules=None):
    """Lint ``paths`` (files or directories) and return sorted Diagnostics.

    ``select``/``ignore`` are iterables of rule-id prefixes.  Engine
    diagnostics (``LNT*``: malformed suppressions, syntax errors) are
    ALWAYS reported — filtering or suppressing the suppression checker
    would be a self-licensing loophole.  Suppressed findings are dropped;
    the suppression's reason is the audit trail."""
    select = [s for s in (select or []) if s]
    ignore = [s for s in (ignore or []) if s]
    modules = []
    diagnostics = []
    files = iter_python_files(paths)
    # run_lint is the whole API for direct callers (CI wrappers, hooks) —
    # a typo'd path must surface as an LNT003 finding, never as a silent
    # clean run.  Emptiness is derived from the one collected file list
    # rather than re-walking each directory argument.
    reals = {os.path.realpath(f) for f in files}
    for path in paths:
        if not os.path.exists(path):
            diagnostics.append(Diagnostic(path, 1, 0, UNREADABLE_PATH, "no such path"))
        elif os.path.isfile(path) and not path.endswith(".py"):
            diagnostics.append(
                Diagnostic(path, 1, 0, UNREADABLE_PATH, "not a Python file")
            )
        elif os.path.isdir(path):
            root = os.path.realpath(path)
            prefix = root + os.sep
            if not any(r == root or r.startswith(prefix) for r in reals):
                diagnostics.append(
                    Diagnostic(
                        path, 1, 0, UNREADABLE_PATH, "no Python files under directory"
                    )
                )
    for path in files:
        module, error = load_module(path)
        if error is not None:
            diagnostics.append(error)
            continue
        modules.append(module)
        diagnostics.extend(module.engine_diagnostics)
    if rules is None:
        rules = default_rules()
    # A typo'd prefix must be loud: `select=["LK"]` matching nothing would
    # otherwise lint zero lock rules and report the tree clean.
    known = [rule.id for rule in rules] + [
        MALFORMED_SUPPRESSION,
        SYNTAX_ERROR,
        UNREADABLE_PATH,
    ]
    for prefix in (*select, *ignore):
        if not any(rule_id.startswith(prefix) for rule_id in known):
            raise ValueError(
                f"select/ignore prefix {prefix!r} matches no rule id"
            )
    # Filter the rules themselves, not just their findings: a deselected
    # rule must not pay its cross-file pass (the lock graph, the captured
    # call tree) only to have every diagnostic dropped afterwards.
    rules = [rule for rule in rules if _selected(rule.id, select, ignore)]
    for rule in rules:
        rule.begin(modules)
    module_by_path = {m.path: m for m in modules}
    for rule in rules:
        for module in modules:
            for diag in rule.check(module):
                if not module.suppressed(diag.line, diag.rule_id):
                    diagnostics.append(diag)
        for diag in rule.finalize():
            module = module_by_path.get(diag.path)
            if module is None or not module.suppressed(diag.line, diag.rule_id):
                diagnostics.append(diag)
    diagnostics = [
        d
        for d in diagnostics
        if d.rule_id.startswith("LNT") or _selected(d.rule_id, select, ignore)
    ]
    diagnostics.sort(key=lambda d: (d.path, d.line, d.col, d.rule_id))
    return diagnostics


def format_human(diagnostics):
    lines = [d.format() for d in diagnostics]
    n = len(diagnostics)
    lines.append(f"{n} violation{'s' if n != 1 else ''} found" if n else "clean")
    return "\n".join(lines)


def format_json(diagnostics):
    return json.dumps(
        {
            "violations": [d.to_dict() for d in diagnostics],
            "count": len(diagnostics),
        }
    )
