"""Lock-order & shared-state safety rules (``LCK001``–``LCK003``; port of
``orion_tpu/analysis/lock_rules.py``).

The process hosts a set of cross-thread objects — the telemetry ring, the
flight recorder, the step-graph cache and the bucket prewarmer's capture
threads, the network driver's socket, the shard router's tables — each
with its own lock.  Deadlock needs only two of them acquired in opposite
orders on two threads, and the hang reproduces only under production
concurrency.  So the checker builds the static lock graph: every declared
lock (``self._x = threading.Lock()`` in a class, ``_x =
threading.Lock()`` at module level), every ``with <lock>:`` nesting (one
edge per outer→inner pair), plus **two levels** of call resolution — a
call made while holding lock A resolves through the callee AND the
callee's own direct callees, so ``with self._lock: self._flush()`` where
``_flush`` calls ``TELEMETRY.count`` still finds the ``NetworkDB._lock →
Telemetry._lock`` edge.  A **context-managed callee** (``with
self._guard():``) contributes the locks it acquires as held for the
with-body, exactly like the plain call form.  A cycle in the graph is
``LCK001``.

``LCK002`` is the simpler data-race screen: within a class that owns a
lock, an attribute assigned both inside and outside ``with <lock>:``
scopes is flagged at its unlocked sites (lifecycle methods are exempt —
``__init__``/``__setstate__`` run before the object is shared).

``LCK003`` closes the static↔dynamic loop with the runtime sanitizer
(``orion_tpu_torch.analysis.sanitizer``, ``orion-tpu-torch tsan``): a
lock-order edge *observed at runtime* between two statically-known locks
that the static graph never derived is a resolver blind spot — usually a
lock-owning object reached through a parameter or callback the AST cannot
follow.  The rule is silent unless runtime edges are supplied (in-process
via ``sanitizer.set_lint_runtime_edges`` or the ``ORION_TPU_TSAN_EDGES``
env file), so plain lint runs are unaffected.
"""

import ast
import os

from orion_tpu_torch.analysis.engine import Diagnostic, Rule, dotted_name

_LOCK_FACTORIES = frozenset(
    {
        "threading.Lock",
        "threading.RLock",
        "threading.Condition",
        "Lock",
        "RLock",
        "Condition",
    }
)

_EXEMPT_METHODS = frozenset(
    {"__init__", "__new__", "__getstate__", "__setstate__", "__del__"}
)

#: Non-stmt AST children whose ``body`` is a statement list executed in the
#: enclosing scope (so lock holds carry into it).
_STMT_LIST_CHILDREN = (ast.ExceptHandler,) + (
    (ast.match_case,) if hasattr(ast, "match_case") else ()
)


def _module_name(path):
    return os.path.splitext(os.path.basename(path))[0]


def _is_lock_factory(value):
    return (
        isinstance(value, ast.Call)
        and (dotted_name(value.func) or "") in _LOCK_FACTORIES
    )


class _FunctionScan:
    """With-nesting walk of one function body: direct acquisitions, nested
    lock edges, calls made while holding locks, and the full callee set
    (for the second resolution level).

    Edge/held entries are *tokens*: either a lock id string, or
    ``("call", name)`` for a context-managed callee — the with-item
    ``with self._guard():`` holds whatever ``_guard`` acquires, which only
    the project index can expand (``build_static_edges`` does)."""

    def __init__(self, resolve):
        self._resolve = resolve  # expr -> lock id or None
        self.acquired = set()  # lock ids directly acquired
        self.call_names = set()  # every dotted callee name in the body
        self.edges = []  # (outer token, inner token, lineno)
        self.calls_under_lock = []  # (held token frozenset, callee name, lineno)
        self.assignment_sites = []  # (attr, under_lock, node)

    def walk(self, fn, class_locks):
        self._class_locks = class_locks
        self._visit_block(fn.body, [])

    def _visit_block(self, stmts, held):
        for stmt in stmts:
            self._visit(stmt, held)

    def _visit(self, node, held):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            pushed = []
            for item in node.items:
                lock = self._resolve(item.context_expr)
                if lock is not None:
                    self.acquired.add(lock)
                    for outer in held + pushed:
                        self.edges.append((outer, lock, node.lineno))
                    pushed.append(lock)
                    continue
                # A non-lock with-item is a call made under the current
                # holds ('with lock: with obj.enter():' acquires whatever
                # the callee acquires) — scanned BEFORE its own token is
                # pushed, so the callee is not recorded under itself.
                self._scan_calls(item.context_expr, held + pushed)
                if isinstance(item.context_expr, ast.Call):
                    name = dotted_name(item.context_expr.func)
                    if name:
                        # Context-managed callee: its acquired locks are
                        # HELD for the body (the idiom LCK001 must see
                        # through) — expanded at finalize time.
                        token = ("call", name)
                        for outer in held + pushed:
                            self.edges.append((outer, token, node.lineno))
                        pushed.append(token)
            self._visit_block(node.body, held + pushed)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested def's body runs later, not under the current holds.
            self._visit_block(node.body, [])
            return
        self._note_assignments(node, held)
        # Record calls in this statement's expression children — under the
        # current holds for edge formation, and unconditionally into
        # call_names for the second resolution level.  (Nested with-bodies
        # are re-visited below with the fuller held set — recording them
        # here too is redundant but still sound: the outer lock IS held
        # there.)
        for sub in ast.iter_child_nodes(node):
            if not isinstance(sub, (ast.stmt,) + _STMT_LIST_CHILDREN):
                self._scan_calls(sub, held)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._visit(child, held)
            elif isinstance(child, _STMT_LIST_CHILDREN):
                # except handlers / match cases are not ast.stmt themselves,
                # but their bodies run under the same holds — error paths are
                # exactly where netdb mutates shared reconnect state.
                self._visit_block(child.body, held)

    def _scan_calls(self, node, held):
        # Recursive so deferred bodies PRUNE: a lambda/def created under a
        # lock runs later, not under it — ast.walk's flat iteration would
        # still descend and mint phantom lock-graph edges.
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name:
                self.call_names.add(name)
                if held:
                    self.calls_under_lock.append(
                        (frozenset(held), name, node.lineno)
                    )
        for child in ast.iter_child_nodes(node):
            self._scan_calls(child, held)

    def _note_assignments(self, node, held):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        under_class_lock = any(
            isinstance(lock, str) and lock in self._class_locks for lock in held
        )
        for target in targets:
            base = target
            if isinstance(base, ast.Subscript):
                base = base.value
            if (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
            ):
                self.assignment_sites.append(
                    (base.attr, under_class_lock, node)
                )


class _ProjectIndex:
    """Cross-file lock inventory shared by the LCK rules and the runtime
    sanitizer's cross-check."""

    def __init__(self, modules):
        self.class_locks = {}  # class name -> set of lock ids "Class.attr"
        self.module_locks = {}  # module name -> {var name -> lock id}
        self.instance_of = {}  # module-level instance var -> class name
        self.fn_acquired = {}  # callee key -> set of lock ids
        self.fn_callees = {}  # callee key -> set of callee keys it calls
        self.fn_scans = []  # (module, class name or None, fn node, scan)
        self._collect_declarations(modules)
        self._scan_functions(modules)

    def _collect_declarations(self, modules):
        class_names = set()
        for module in modules:
            mod = _module_name(module.path)
            for node in ast.walk(module.tree):
                if isinstance(node, ast.ClassDef):
                    class_names.add(node.name)
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Assign) and _is_lock_factory(
                            sub.value
                        ):
                            for target in sub.targets:
                                name = dotted_name(target)
                                if name and name.startswith("self."):
                                    self.class_locks.setdefault(
                                        node.name, set()
                                    ).add(f"{node.name}.{name[5:]}")
            for node in module.tree.body:
                if isinstance(node, ast.Assign) and _is_lock_factory(node.value):
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            self.module_locks.setdefault(mod, {})[
                                target.id
                            ] = f"{mod}.{target.id}"
        for module in modules:
            for node in module.tree.body:
                if (
                    isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Name)
                    and node.value.func.id in class_names
                ):
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            self.instance_of[target.id] = node.value.func.id

    def _resolver(self, module, class_name):
        mod = _module_name(module.path)

        def resolve(expr):
            name = dotted_name(expr)
            if not name:
                return None
            if name.startswith("self.") and class_name is not None:
                candidate = f"{class_name}.{name[5:]}"
                if candidate in self.class_locks.get(class_name, ()):
                    return candidate
                return None
            return self.module_locks.get(mod, {}).get(name)

        return resolve

    def _scan_functions(self, modules):
        for module in modules:
            mod = _module_name(module.path)
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self._scan_one(module, mod, node.name, item)
            for item in module.tree.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._scan_one(module, mod, None, item)

    def _scan_one(self, module, mod, class_name, fn):
        scan = _FunctionScan(self._resolver(module, class_name))
        scan.walk(fn, self.class_locks.get(class_name, set()))
        self.fn_scans.append((module, class_name, fn, scan))
        if class_name is not None:
            key = ("method", class_name, fn.name)
        else:
            key = ("fn", mod, fn.name)
        self.fn_acquired.setdefault(key, set()).update(scan.acquired)
        callees = self.fn_callees.setdefault(key, set())
        for name in scan.call_names:
            callee = self.callee_key(module, class_name, name)
            if callee is not None and callee != key:
                callees.add(callee)

    def callee_key(self, module, class_name, call_name):
        """Map a dotted call like 'self._close' / '_note_done' /
        'TELEMETRY.count' to a key in fn_acquired, or None."""
        mod = _module_name(module.path)
        parts = call_name.split(".")
        if parts[0] == "self" and len(parts) == 2 and class_name is not None:
            return ("method", class_name, parts[1])
        if len(parts) == 1:
            return ("fn", mod, parts[0])
        owner = self.instance_of.get(parts[-2])
        if owner is not None:
            return ("method", owner, parts[-1])
        return None

    def acquired_through(self, key, depth=2):
        """Locks acquired by ``key`` resolved through ``depth`` call
        levels: its own direct acquisitions plus (at depth 2) those of its
        direct callees — 'a call under lock A to a method whose helper
        takes lock B' now contributes A→B."""
        acquired = set(self.fn_acquired.get(key, ()))
        if depth > 1:
            for callee in self.fn_callees.get(key, ()):
                acquired |= self.fn_acquired.get(callee, set())
        return acquired


def _project_index(modules):
    """Build the whole-project scan once per run: the LCK rules receive
    the same modules list from one run_lint call, so the index is cached on
    the first Module and dies with the run — a process-global cache would
    pin every parsed AST for the life of the process (the tsan command's
    cross-check runs in the same process as its caller)."""
    if not modules:
        return _ProjectIndex(modules)
    key = tuple(id(m) for m in modules)
    cached = getattr(modules[0], "lint_lck_index", None)
    if cached is None or cached[0] != key:
        cached = (key, _ProjectIndex(modules))
        modules[0].lint_lck_index = cached
    return cached[1]


def project_index(modules):
    """Public entry for the runtime sanitizer's cross-check
    (``sanitizer.cross_check_static``)."""
    return _project_index(modules)


def _expand_token(index, module, class_name, token):
    """A scan token -> the set of lock ids it stands for: a lock id is
    itself; a ``("call", name)`` context-managed callee expands to the
    locks the callee acquires through two resolution levels."""
    if isinstance(token, str):
        return {token}
    key = index.callee_key(module, class_name, token[1])
    if key is None:
        return set()
    return index.acquired_through(key)


def build_static_edges(index):
    """THE static lock-order graph: ``{outer: {inner: (path, line)}}``,
    from with-nesting, two-level call resolution, and context-managed
    callees.  Shared by LCK001, LCK003 and the sanitizer cross-check so
    "the static graph" means one thing everywhere."""
    edges = {}

    def add(outer, inner, module, line):
        if inner != outer:
            edges.setdefault(outer, {}).setdefault(inner, (module.path, line))

    for module, class_name, _fn, scan in index.fn_scans:
        for outer_token, inner_token, line in scan.edges:
            for outer in _expand_token(index, module, class_name, outer_token):
                for inner in _expand_token(index, module, class_name, inner_token):
                    add(outer, inner, module, line)
        for held, call_name, line in scan.calls_under_lock:
            key = index.callee_key(module, class_name, call_name)
            if key is None:
                continue
            inners = index.acquired_through(key)
            if not inners:
                continue
            for token in held:
                for outer in _expand_token(index, module, class_name, token):
                    for inner in inners:
                        add(outer, inner, module, line)
    return edges


def known_lock_ids(index):
    """Every declared lock id the index knows (class + module locks)."""
    known = set()
    for locks in index.class_locks.values():
        known |= locks
    for locks in index.module_locks.values():
        known |= set(locks.values())
    return known


def iter_edge_cycles(edges):
    """Cycles in a ``{outer: {inner: meta}}`` graph, yielded once each as
    ``(cycle_tuple, closing_node, closing_child)`` — the closing edge is
    where LCK001 anchors its diagnostic.  Iterative DFS with a recursion
    stack."""
    seen_cycles = set()
    visited = set()
    for start in sorted(edges):
        stack = [(start, iter(sorted(edges.get(start, {}))))]
        on_path = [start]
        while stack:
            node, children = stack[-1]
            advanced = False
            for child in children:
                if child in on_path:
                    cycle = tuple(on_path[on_path.index(child):] + [child])
                    key = frozenset(cycle)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        yield cycle, node, child
                    continue
                if (node, child) not in visited:
                    visited.add((node, child))
                    stack.append(
                        (child, iter(sorted(edges.get(child, {}))))
                    )
                    on_path.append(child)
                    advanced = True
                    break
            if not advanced:
                stack.pop()
                on_path.pop()


class LockOrderCycle(Rule):
    id = "LCK001"
    name = "lock-order-cycle"
    description = (
        "The static lock graph (with-nesting plus two levels of call "
        "resolution, including context-managed callees) must stay acyclic: "
        "a cycle means two threads can acquire the same locks in opposite "
        "orders and deadlock under production concurrency."
    )

    def begin(self, modules):
        self._index = _project_index(modules)

    def finalize(self):
        edges = build_static_edges(self._index)
        for cycle, node, child in iter_edge_cycles(edges):
            path, line = edges[node][child]
            yield Diagnostic(
                path,
                line,
                0,
                self.id,
                "lock-order cycle: "
                + " -> ".join(cycle)
                + " (another thread may acquire these in "
                "the opposite order and deadlock)",
            )


class UnlockedSharedMutation(Rule):
    id = "LCK002"
    name = "unlocked-shared-mutation"
    description = (
        "Within a class that owns a lock, an attribute assigned both "
        "inside and outside 'with <lock>:' scopes is a data race waiting "
        "for a second thread; take the lock at the unlocked site (or "
        "suppress with the reason the site is single-threaded)."
    )

    def begin(self, modules):
        self._index = _project_index(modules)

    def finalize(self):
        # attr sites grouped per class across the whole project (a class's
        # methods may span files only in pathological cases, but grouping
        # is per class name either way).
        sites = {}  # (class, attr) -> list of (under_lock, module, node, fn)
        for module, class_name, fn, scan in self._index.fn_scans:
            if class_name is None or class_name not in self._index.class_locks:
                continue
            if fn.name in _EXEMPT_METHODS:
                continue
            for attr, under_lock, node in scan.assignment_sites:
                sites.setdefault((class_name, attr), []).append(
                    (under_lock, module, node, fn)
                )
        for (class_name, attr), entries in sorted(sites.items()):
            locked = [e for e in entries if e[0]]
            unlocked = [e for e in entries if not e[0]]
            if not locked or not unlocked:
                continue
            for _under, module, node, fn in unlocked:
                yield Diagnostic(
                    module.path,
                    node.lineno,
                    node.col_offset,
                    self.id,
                    f"'self.{attr}' is assigned under "
                    f"{class_name}'s lock elsewhere but without it in "
                    f"'{fn.name}'; take the lock here or document why "
                    "this site is single-threaded",
                )


class UnmodeledRuntimeEdge(Rule):
    id = "LCK003"
    name = "runtime-edge-missing-from-static-graph"
    description = (
        "A lock-order edge the runtime sanitizer observed between two "
        "statically-declared locks must exist in the static lock graph — "
        "an unmodeled edge is a resolver blind spot (a lock-owning object "
        "reached through a parameter or callback) that silently exempts "
        "that acquisition path from LCK001 cycle checking.  Silent unless "
        "runtime edges are supplied (orion-tpu-torch tsan's cross-check, "
        "sanitizer.set_lint_runtime_edges, or ORION_TPU_TSAN_EDGES)."
    )

    def begin(self, modules):
        self._index = _project_index(modules)
        # Runtime reports carry absolute paths; linted modules whatever the
        # caller passed.  Re-anchoring a finding to the LINTED path is what
        # lets a suppression comment at the acquisition site argue it away.
        self._by_realpath = {os.path.realpath(m.path): m.path for m in modules}
        from orion_tpu_torch.analysis.sanitizer import lint_runtime_edges

        self._runtime = lint_runtime_edges()

    def finalize(self):
        if not self._runtime:
            return
        edges = build_static_edges(self._index)
        static_pairs = {
            (outer, inner) for outer in edges for inner in edges[outer]
        }
        known = known_lock_ids(self._index)
        for edge in self._runtime:
            outer = edge.get("outer")
            inner = edge.get("inner")
            if not outer or not inner or (outer, inner) in static_pairs:
                continue
            # Both endpoints must be locks the linted tree DECLARES —
            # otherwise the report came from code outside this lint run
            # (e.g. a fixture dir checked against a full-app report) and
            # there is no graph to extend here.
            if outer not in known or inner not in known:
                continue
            path = str(edge.get("path", "<runtime>"))
            path = self._by_realpath.get(os.path.realpath(path), path)
            yield Diagnostic(
                path,
                int(edge.get("line", 1) or 1),
                0,
                self.id,
                f"runtime-observed lock edge {outer} -> {inner} is missing "
                "from the static lock graph: the static resolver cannot "
                "see this acquisition path, so LCK001 cannot check it for "
                "cycles — restructure the acquisition so the resolver sees "
                "it, or suppress here with the reason the ordering is safe",
            )


LOCK_RULES = (LockOrderCycle, UnlockedSharedMutation, UnmodeledRuntimeEdge)
