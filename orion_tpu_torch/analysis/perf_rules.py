"""Hot-path vectorization and cold-path introspection rules (``PERF001``,
``PERF002``, ``PERF003``; port of ``orion_tpu/analysis/perf_rules.py``,
with ``PERF003`` rewritten for the port's compiler plane).

The steady-state producer round does no per-trial python work: the
cube<->params codec runs one numpy/lookup-table pass per DIMENSION, trial
documents build in one columnar pass, and per-trial dicts materialize only
at the plugin-compat boundary.  Nothing in python keeps it that way — the
natural way to write the next feature is a ``for trial in trials:`` loop,
and one q=1024 loop re-opens the host tax.  ``PERF001`` pins the
discipline: inside the declared hot-path functions, a ``for`` loop or
comprehension that iterates a batch-sized value (a q-round of
trials/params/docs) is flagged.  The argued exceptions — per-point plugin
APIs (``register_suggestion``, lie strategies), the storage-document edge
where one doc per trial IS the output shape, dict-list fallbacks for
pre-columnar plugins — carry suppressions-with-reason, which is exactly
the audit trail a hot-path loop should leave behind.

Detection is structural so fixtures (and future hot paths) participate by
shape, not by file path: methods named in ``HOT_METHODS`` on classes named
in ``HOT_CLASSES`` (base-class names count), plus the module-level
functions in ``HOT_FUNCTIONS``.  A loop is batch-sized when its iterable
resolves — through ``enumerate``/``zip``/``reversed``/slices — to one of
the function's parameters with a batch-shaped name (``BATCH_NAMES``), or
to a local assigned from one.

``PERF002`` pins the dispatch-prep discipline the same way: inside the
declared hot-path PREP functions (the per-round plan preparation between
``suggest`` and the step-graph dispatch), rebuilding a
signature-invariant product — a statics/kwargs dict, a signature
string/tuple — from scratch every round is flagged unless the build rides
a cache: lexically guarded by a conditional on a value loaded from a
``*cache*``/``*token*`` attribute or global (``_PLAN_PREP_CACHE`` in
``orion_tpu_torch/algo/tpu_bo.py::make_fused_plan`` is the exemplar: the
statics and the signature are built once per prep key and read back on
every later round).  Per-round ARRAY tuples (the device operands copied
into a captured graph's static inputs) are not rebuild products — they
change every round by definition — so the rule keys on the declared
product names, not on every tuple literal.

``PERF003`` pins the compiler plane's cost discipline
(``orion_tpu_torch/compiler_plane.py``).  Its introspection is cold by
design: a ``FlopCounterMode`` FLOP count runs one whole eager round under
a dispatch-mode hook, ``torch.cuda.memory_snapshot()`` walks every block
the caching allocator holds, and a CUDA-graph capture (``torch.cuda.graph``,
``CUDAGraph(...)``, ``capture_begin``) or a ``debug_dump`` of one costs an
eager warm-up round, the capture and the instantiation.  All are fine in a
bench, a test or a deliberate registry sweep, and ruinous anywhere a
production round can reach.  The FLOP count and the allocator walk belong
to the compiler plane (``COLD_INTROSPECTION_MODULES``); captures belong to
the step-graph cache and the compiler plane (``COLD_CAPTURE_MODULES``).
Everything else must route through ``CompileRegistry.analyze_all`` /
``STEP_GRAPHS`` or carry a suppression-with-reason naming why its call
site is cold.
"""

import ast

from orion_tpu_torch.analysis.engine import Diagnostic, Rule, dotted_name

#: Classes whose listed methods are hot-path (matched by the class's own
#: name or any base-class name, so subclasses inherit the discipline).
HOT_CLASSES = {
    "Space": {
        "arrays_to_params",
        "params_to_arrays",
        "params_to_cube",
        "decode_flat_np",
        "encode_flat_np",
    },
    "TrialBatch": {"prepare", "to_docs", "trials"},
    "Producer": {
        "_produce",
        "_cube_rows_for",
        "_dispatch_speculative",
        "_take_speculative",
    },
    "DocumentStorage": {"register_trials", "register_trial_docs"},
    "ParamBatch": set(),  # columnar by construction; listed for subclasses
}

#: Module-level hot-path functions, by name.
HOT_FUNCTIONS = {"compute_batch_ids"}

#: Parameter/local names that denote a q-sized batch.  Deliberately tight:
#: the rule must stay surgical (a ``for dim in self`` per-dimension pass is
#: the DESIRED shape and must never be flagged).
BATCH_NAMES = frozenset(
    {
        "params_list",
        "params_rows",
        "params_batch",
        "trials",
        "docs",
        "pairs",
        "suggested",
        "outcomes",
        "registered_trials",
    }
)

#: Reference twins are exempt by suffix: they exist precisely to RETAIN the
#: per-trial loops as differential anchors.
_REFERENCE_SUFFIX = "_reference"

#: Call wrappers that preserve batch-sizedness of their first argument.
_TRANSPARENT_CALLS = frozenset({"enumerate", "zip", "reversed", "list", "tuple"})


class PerTrialLoopInHotPath(Rule):
    id = "PERF001"
    name = "per-trial-loop-in-hot-path"
    description = (
        "per-trial python loop (for/comprehension over a q-sized batch) "
        "inside a producer/codec hot-path function; vectorize per-dim or "
        "move the loop behind the plugin-compat boundary (suppress with a "
        "reason if the boundary is argued)"
    )

    # --- hot-path discovery -------------------------------------------------
    def _hot_functions(self, tree):
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                names = {node.name} | {
                    (dotted_name(base) or "").split(".")[-1]
                    for base in node.bases
                }
                methods = set()
                for name in names:
                    methods |= HOT_CLASSES.get(name, set())
                if not methods:
                    continue
                for item in node.body:
                    if (
                        isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and item.name in methods
                        and not item.name.endswith(_REFERENCE_SUFFIX)
                    ):
                        yield node.name, item
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if (
                    node.name in HOT_FUNCTIONS
                    and not node.name.endswith(_REFERENCE_SUFFIX)
                ):
                    yield None, node

    # --- batch-sizedness ----------------------------------------------------
    def _batch_locals(self, fn):
        """Parameters + locals assigned from a batch-sized expression."""
        args = fn.args
        names = {
            a.arg
            for a in (
                list(args.posonlyargs)
                + list(args.args)
                + list(args.kwonlyargs)
            )
            if a.arg in BATCH_NAMES
        }
        # One propagation level: ``chunk = suggested[:k]`` keeps q-size.
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                if self._is_batch_expr(node.value, names):
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            names.add(target.id)
        return names

    def _is_batch_expr(self, node, names):
        if isinstance(node, ast.Name):
            return node.id in names or node.id in BATCH_NAMES
        if isinstance(node, ast.Subscript):
            # A slice keeps batch size; a scalar index does not.
            if isinstance(node.slice, ast.Slice):
                return self._is_batch_expr(node.value, names)
            return False
        if isinstance(node, ast.Attribute):
            # ``batch.params`` / ``self.params`` style: the terminal
            # attribute name carries the batch shape.
            return node.attr in BATCH_NAMES
        if isinstance(node, ast.Call):
            callee = (dotted_name(node.func) or "").split(".")[-1]
            if callee in _TRANSPARENT_CALLS and node.args:
                return self._is_batch_expr(node.args[0], names)
        return False

    # --- check --------------------------------------------------------------
    def check(self, module):
        seen = set()
        for owner, fn in self._hot_functions(module.tree):
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            names = self._batch_locals(fn)
            where = f"{owner}.{fn.name}" if owner else fn.name
            for node in ast.walk(fn):
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    iter_node = node.iter
                    kind = "for loop"
                elif isinstance(
                    node, (ast.ListComp, ast.SetComp, ast.DictComp,
                           ast.GeneratorExp)
                ):
                    iter_node = node.generators[0].iter
                    kind = "comprehension"
                else:
                    continue
                if self._is_batch_expr(iter_node, names):
                    yield Diagnostic(
                        module.path,
                        node.lineno,
                        node.col_offset,
                        self.id,
                        f"per-trial {kind} over a q-sized batch in hot-path "
                        f"'{where}'; vectorize per-dim (numpy ufunc / lookup "
                        "table / columnar pass) or suppress with the argued "
                        "plugin-compat reason",
                    )


#: Per-round prep functions whose signature-invariant products must ride a
#: cache: module-level names and method names (matched on ANY class — prep
#: methods are declared by name, like HOT_FUNCTIONS, so algorithm
#: subclasses inherit the discipline without registration).
HOT_PREP_FUNCTIONS = {"make_fused_plan"}
HOT_PREP_METHODS = {"fused_step_plan", "_gp_plan"}

#: Local names that denote a signature-invariant prep product.  Tight on
#: purpose: ``arrays``/``prep_key``/``fast_key`` are per-round by nature
#: (fresh device operands, the cache's own probe key) and must stay quiet.
PREP_PRODUCT_NAMES = frozenset({"statics", "signature", "step_kw", "kw"})

#: Identifier substrings that mark a value as cache-loaded: a conditional
#: on such a value is the cache guard the rebuild must sit under.
_CACHE_MARKERS = ("cache", "token", "memo")


class UncachedPrepRebuild(Rule):
    id = "PERF002"
    name = "uncached-prep-rebuild-in-hot-path"
    description = (
        "per-round rebuild of a signature-invariant prep product (statics/"
        "kwargs dict, signature string or tuple) inside a hot-path plan-prep "
        "function, outside any cache guard; pin it behind a *_cache "
        "attribute / prep token (suppress with a reason if the rebuild is "
        "argued)"
    )

    # --- hot-path discovery -------------------------------------------------
    def _hot_functions(self, tree):
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if (
                        isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and item.name in HOT_PREP_METHODS
                        and not item.name.endswith(_REFERENCE_SUFFIX)
                    ):
                        yield node.name, item
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if (
                    node.name in HOT_PREP_FUNCTIONS
                    and not node.name.endswith(_REFERENCE_SUFFIX)
                ):
                    yield None, node

    # --- cache-loaded names -------------------------------------------------
    @staticmethod
    def _is_cacheish(identifier):
        lowered = identifier.lower()
        return any(marker in lowered for marker in _CACHE_MARKERS)

    def _cache_loaded_names(self, fn):
        """Locals assigned from an expression that touches a cache/token —
        ``prep = _PLAN_PREP_CACHE.get(key)``, ``kw = self._step_kw_cache``,
        ``pinned = prep_token.pinned``.  A conditional on one of these IS
        the cache guard."""
        names = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            touches_cache = any(
                (isinstance(sub, ast.Name) and self._is_cacheish(sub.id))
                or (isinstance(sub, ast.Attribute) and self._is_cacheish(sub.attr))
                for sub in ast.walk(node.value)
            )
            if touches_cache:
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        names.add(target.id)
        return names

    # --- rebuild products ---------------------------------------------------
    @staticmethod
    def _is_rebuild_expr(node):
        """A from-scratch build of a prep product: a dict literal/``dict()``
        call, an f-string, or a tuple literal."""
        if isinstance(node, (ast.Dict, ast.DictComp, ast.JoinedStr, ast.Tuple)):
            return True
        if isinstance(node, ast.Call):
            return (dotted_name(node.func) or "").split(".")[-1] == "dict"
        return False

    # --- check --------------------------------------------------------------
    def check(self, module):
        seen = set()
        for owner, fn in self._hot_functions(module.tree):
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            guards = self._cache_loaded_names(fn)
            where = f"{owner}.{fn.name}" if owner else fn.name
            yield from self._scan(fn.body, guarded=False, guards=guards,
                                  where=where, path=module.path)

    def _scan(self, stmts, guarded, guards, where, path):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested defs are their own (non-hot) scope
            if isinstance(stmt, ast.Assign) and not guarded:
                for target in stmt.targets:
                    if (
                        isinstance(target, ast.Name)
                        and target.id in PREP_PRODUCT_NAMES
                        and self._is_rebuild_expr(stmt.value)
                    ):
                        yield Diagnostic(
                            path,
                            stmt.lineno,
                            stmt.col_offset,
                            self.id,
                            f"'{target.id}' is rebuilt from scratch every "
                            f"round in hot-path prep '{where}' with no cache "
                            "guard; load it from a *_cache attribute / prep "
                            "token and rebuild only on miss (suppress with a "
                            "reason if the per-round rebuild is argued)",
                        )
            if isinstance(stmt, ast.If):
                test_guards = guarded or any(
                    isinstance(sub, ast.Name) and sub.id in guards
                    for sub in ast.walk(stmt.test)
                )
                yield from self._scan(stmt.body, test_guards, guards, where, path)
                yield from self._scan(stmt.orelse, test_guards, guards, where, path)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                yield from self._scan(stmt.body, guarded, guards, where, path)
                yield from self._scan(stmt.orelse, guarded, guards, where, path)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                yield from self._scan(stmt.body, guarded, guards, where, path)
            elif isinstance(stmt, ast.Try):
                for block in (stmt.body, stmt.orelse, stmt.finalbody):
                    yield from self._scan(block, guarded, guards, where, path)
                for handler in stmt.handlers:
                    yield from self._scan(handler.body, guarded, guards,
                                          where, path)


#: The modules that OWN the cold introspection, by basename so checkout
#: layouts don't matter; everything else is a hot path until argued
#: otherwise.  The FLOP count and the allocator walk are the compiler
#: plane's; captures are the step-graph cache's and the compiler plane's.
COLD_INTROSPECTION_MODULES = frozenset({"compiler_plane.py"})
COLD_CAPTURE_MODULES = frozenset({"compiler_plane.py", "step_graphs.py"})

#: Calls (last dotted component) that walk the allocator or count FLOPs by
#: running a round under a dispatch hook.
_INTROSPECTION_CALLS = frozenset({"FlopCounterMode", "memory_snapshot", "_snapshot"})

#: Calls (last dotted component) that capture, or dump, a CUDA graph.
_CAPTURE_CALLS = frozenset({"graph", "CUDAGraph", "capture_begin", "debug_dump",
                            "make_graphed_callables"})


class CompilerIntrospectionOutsideColdPath(Rule):
    id = "PERF003"
    name = "compiler-introspection-outside-cold-path"
    description = (
        "FlopCounterMode(...) or torch.cuda.memory_snapshot() outside the "
        "compiler plane, or a CUDA-graph capture (torch.cuda.graph, "
        "CUDAGraph(...), capture_begin, make_graphed_callables) or a "
        "debug_dump outside the step-graph cache and the compiler plane: a "
        "FLOP count runs a whole eager round under a dispatch hook, the "
        "snapshot walks every allocator block, and a capture costs a "
        "warm-up round, the capture and its instantiation — route through "
        "CompileRegistry.analyze_all / STEP_GRAPHS, or suppress with the "
        "reason the call site is cold"
    )

    @staticmethod
    def _basename(path):
        return str(path).replace("\\", "/").rsplit("/", 1)[-1]

    @staticmethod
    def _is_capture(name):
        """``torch.cuda.graph(...)`` (not any ``graph(...)``), or a call whose
        last component names a capture or a dump."""
        last = name.rsplit(".", 1)[-1]
        if last == "graph":
            return name.endswith("cuda.graph")
        return last in _CAPTURE_CALLS

    @staticmethod
    def _is_introspection(name):
        last = name.rsplit(".", 1)[-1]
        if last == "_snapshot":
            return name.endswith("cuda.memory._snapshot")
        return last in _INTROSPECTION_CALLS

    def check(self, module):
        base = self._basename(module.path)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            if self._is_introspection(name) and base not in COLD_INTROSPECTION_MODULES:
                yield Diagnostic(
                    module.path,
                    node.lineno,
                    node.col_offset,
                    self.id,
                    f"'{name}(...)' outside the compiler plane: a FLOP count "
                    "runs a whole eager round under a dispatch hook and an "
                    "allocator snapshot walks every block; read it from the "
                    "CompileRegistry (analyze_all) or the step graphs' own "
                    "records, or suppress with the reason this call site is "
                    "cold",
                )
            elif self._is_capture(name) and base not in COLD_CAPTURE_MODULES:
                yield Diagnostic(
                    module.path,
                    node.lineno,
                    node.col_offset,
                    self.id,
                    f"'{name}(...)' captures or dumps a CUDA graph outside the "
                    "step-graph cache: a capture costs a warm-up round, the "
                    "capture and its instantiation; go through STEP_GRAPHS.run"
                    " / .prewarm, or suppress with the reason this call site "
                    "is cold",
                )


PERF_RULES = (
    PerTrialLoopInHotPath,
    UncachedPrepRebuild,
    CompilerIntrospectionOutsideColdPath,
)
