"""CUDA-graph capture rules (``JIT001``–``JIT004``; port of
``orion_tpu/analysis/jit_rules.py``, rewritten for torch).

The port replays the GP round as a CUDA graph captured once per signature
(``orion_tpu_torch/algo/step_graphs.py``), and a capture dies quietly on
what ``jax.jit`` would have traced: one ``.item()`` inside the round turns
the capture into ``operation not permitted when stream is capturing``; one
Python ``if`` on a tensor value reads it to the host, the same sync; an
index by a 0-d tensor reads the index to the host (the fault that broke
every capture once, ``algo/tpu_bo.py``'s ``exploit_idx`` now goes through
``index_select``); and a Python number threaded into a tensor slot is baked
into the graph, so every replay silently reuses the first round's value.
The rule ids keep the reference's, so ``--select JIT`` and the catalog line
up with it; their meaning is the capture's:

- ``JIT001`` — a host sync inside a captured function: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``.synchronize()``, ``float()``/``int()``/``bool()`` of a tensor, a numpy
  call over a tensor, ``torch.tensor``/``as_tensor``/``from_numpy`` (a host
  copy), ``nonzero``, ``masked_select``, ``unique``, and indexing by a 0-d
  tensor.
- ``JIT002`` — a Python branch (``if``/``while``/``assert``/conditional
  expression) on a tensor value inside a captured function.  A branch on a
  Python static (a keyword-only argument of the captured root, a shape, a
  string) is baked into the capture by design and stays quiet.
- ``JIT003`` — a Python number threaded into a tensor slot of a captured
  function at a capture site (replay never sees a new value: the step
  graphs copy only tensors into their static inputs), and a static that
  changes every round (``float(...)``/``.item()`` in the statics handed to
  the step graphs), which forks the step-graph signature every round.
- ``JIT004`` — a device-mesh construction inside a captured function or a
  declared hot-path function (``HOT_PATH_REGISTRY``): the port's own
  ``Mesh(...)`` (``orion_tpu_torch.algo.sharding``; the cached
  ``get_mesh``/``device_mesh`` are the way to name one) and
  ``torch.distributed``'s ``DeviceMesh``/``init_device_mesh``.

**What is captured.**  A capture records the whole call tree of what it
runs, so the rules check the captured ROOTS and every function of the
linted tree they reach.  Roots: the names in ``FUSED_STEP_REGISTRY``; the
``fn`` handed to ``STEP_GRAPHS.run``/``.prewarm``; a function called inside
a ``with torch.cuda.graph(...)`` block; and the argument of a capture
helper — a function whose parameter is called inside such a block (its
call sites, to a fixpoint).  Callees are resolved through each module's
imports (at any scope), module aliases, re-exports and ``self.`` methods,
across modules, with a visited set.

**What is a tensor.**  A root's positional parameters are its tensors and
its keyword-only parameters its statics (the step graphs pass ``arrays``
positionally and ``**statics`` by name).  Tensor-ness then flows through
each function (torch calls, tensor methods and attributes other than the
static metadata ``shape``/``ndim``/``dtype``/``device``..., arithmetic,
indexing, unpacking) and into callees' parameters at every call site, to a
fixpoint over the call tree.  The analysis is static and conservative in
one direction: a value it cannot place is not a tensor, so it misses
rather than invents; ``chip_smoke.py``'s ``lint`` phase holds its verdicts
against real captures on the card.
"""

import ast
import os

from orion_tpu_torch.analysis.engine import (
    Diagnostic,
    Rule,
    arg_names,
    dotted_name,
    enclosing_class,
    enclosing_function,
)

#: Functions captured even when nothing in the linted tree shows the
#: capture site (the fused suggest step, captured behind ``run_fused_plan``).
FUSED_STEP_REGISTRY = frozenset({"_suggest_step"})

#: Receivers whose ``.run``/``.prewarm`` capture their ``fn`` argument.
STEP_GRAPH_CACHES = frozenset({"STEP_GRAPHS"})
_CACHE_METHODS = frozenset({"run", "prewarm"})
_CACHE_FN, _CACHE_ARRAYS, _CACHE_STATICS = 0, 2, 3  # positions of fn, arrays, statics

#: Per-round dispatch surfaces that must not construct a device mesh per
#: call even though they are not captured themselves (the reference's
#: registry, less the stacked round's names, which the port dropped; the
#: port's tenant-parallel branch lives in ``run_coalesced_plans``).
HOT_PATH_REGISTRY = frozenset({
    "_suggest_step",
    "_tenant_parallel_suggest_step",
    "make_fused_plan",
    "run_fused_plan",
    "run_suggest_step_arrays",
    "run_coalesced_plans",
})
#: The port's mesh class (``get_mesh``'s uncached path) and torch's.
_MESH_CONSTRUCTORS = frozenset({"Mesh", "DeviceMesh", "init_device_mesh"})

#: Tensor methods that read the value to the host.
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize", "nonzero",
                           "masked_select", "unique", "unique_consecutive"})
#: torch functions that read a value to the host or copy one from it.
_SYNC_TORCH = frozenset({"nonzero", "masked_select", "unique", "unique_consecutive",
                         "argwhere", "tensor", "as_tensor", "from_numpy"})
_HOST_COPIES = frozenset({"tensor", "as_tensor", "from_numpy"})
_NUMPY_ALIASES = frozenset({"np", "numpy"})
_CONCRETIZING_BUILTINS = frozenset({"float", "int", "bool"})

#: Tensor attributes and methods that are static metadata: reading them
#: neither syncs nor depends on the values.
_METADATA_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda", "requires_grad",
                             "layout", "is_leaf", "names", "is_sparse", "is_quantized",
                             "is_meta", "grad_fn"})
_METADATA_METHODS = frozenset({"size", "dim", "numel", "nelement", "element_size", "stride",
                               "is_contiguous", "data_ptr", "is_floating_point",
                               "is_complex", "get_device", "storage_offset"})
#: torch functions that return no tensor.
_TORCH_NON_TENSOR = frozenset({"is_tensor", "is_floating_point", "is_complex", "finfo",
                               "iinfo", "device", "dtype", "Size", "get_default_dtype",
                               "Generator", "is_grad_enabled", "no_grad", "enable_grad",
                               "inference_mode", "set_grad_enabled", "broadcast_shapes",
                               "promote_types", "result_type", "record_function",
                               "current_stream", "stream", "Stream", "Event",
                               "is_available", "device_count", "current_device"})
#: Builtins whose result is a Python value whatever they are given.
_HOST_BUILTINS = frozenset({"len", "isinstance", "issubclass", "type", "id", "callable",
                            "hasattr", "str", "repr", "print", "range", "enumerate",
                            "float", "int", "bool"})
#: Reductions that give a 0-d tensor when called without ``dim``.
_FULL_REDUCTIONS = frozenset({"argmin", "argmax", "sum", "mean", "max", "min", "prod",
                              "amax", "amin", "any", "all", "count_nonzero", "norm",
                              "median", "std", "var", "nansum", "nanmean", "logsumexp"})
_SCALAR_FACTORIES = frozenset({"full", "zeros", "ones", "empty", "rand", "randn"})


def _is_capture_context(node):
    """``torch.cuda.graph(...)`` (any qualification ending in ``cuda.graph``)."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func) or ""
    return name == "cuda.graph" or name.endswith(".cuda.graph")


def _python_number(node, numbers=frozenset()):
    """A Python number (not a tensor): a numeric literal, ``-literal``,
    ``float(...)``/``int(...)``, ``.item()``, or a name bound only to
    those (``numbers``)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) and not isinstance(node.value, bool)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        return _python_number(node.operand, numbers)
    if isinstance(node, ast.Name):
        return node.id in numbers
    if isinstance(node, ast.Call):
        name = dotted_name(node.func) or ""
        if name in ("float", "int"):
            return True
        return isinstance(node.func, ast.Attribute) and node.func.attr == "item"
    return False


def _host_read(node):
    """A per-round host read: ``float(...)``, ``int(...)``, ``.item()``,
    ``.tolist()``."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func) or ""
    if name in ("float", "int"):
        return True
    return isinstance(node.func, ast.Attribute) and node.func.attr in ("item", "tolist")


# --- the project index: modules, defs, imports --------------------------------


def _module_name(path):
    """Dotted module name of ``path``: its package chain (directories with
    an ``__init__.py``) and its stem; a file outside packages is its stem."""
    path = os.path.realpath(path)
    directory, filename = os.path.split(path)
    stem = filename[:-3]
    parts = [] if stem == "__init__" else [stem]
    while os.path.isfile(os.path.join(directory, "__init__.py")):
        directory, package = os.path.split(directory)
        parts.insert(0, package)
    return ".".join(parts)


class _ModuleInfo:
    """One linted module's defs, classes, imports and instance bindings."""

    def __init__(self, module):
        self.module = module
        self.name = _module_name(module.path)
        self.is_package = os.path.basename(module.path) == "__init__.py"
        self.defs = {}  # top-level name -> def node
        self.classes = {}  # class name -> {method name -> def node}
        self.aliases = {}  # top-level name -> aliased expression (Name/Attribute)
        self.imports = {}  # bound name -> ("module", dotted) | ("symbol", module, name)
        for node in module.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = {
                    item.name: item for item in node.body
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                }
            elif isinstance(node, ast.Assign) and isinstance(node.value, (ast.Name, ast.Attribute)):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        self.aliases[target.id] = node.value
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.imports[alias.asname] = ("module", alias.name)
                    else:
                        top = alias.name.split(".")[0]
                        self.imports[top] = ("module", top)
            elif isinstance(node, ast.ImportFrom):
                base = self._absolute(node)
                if base is None:
                    continue
                for alias in node.names:
                    if alias.name != "*":
                        self.imports[alias.asname or alias.name] = ("symbol", base, alias.name)

    def _absolute(self, node):
        if not node.level:
            return node.module
        parts = self.name.split(".")
        keep = len(parts) - node.level + (1 if self.is_package else 0)
        if keep < 0:
            return None
        base = parts[:keep]
        if node.module:
            base.append(node.module)
        return ".".join(base) or None


class _Project:
    """Name resolution across the linted modules."""

    def __init__(self, modules):
        self.infos = [_ModuleInfo(m) for m in modules]
        self.by_name = {}
        for info in self.infos:
            self.by_name.setdefault(info.name, info)
        self.by_path = {info.module.path: info for info in self.infos}
        self.owner = {}  # id(def node) -> _ModuleInfo
        self._nested = {}  # id(function) -> {name: def nested anywhere in it}
        self._resolved = {}  # (id(call func), id(scope)) -> def or None
        for info in self.infos:
            for node in ast.walk(info.module.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    self.owner[id(node)] = info

    def symbol(self, module_name, name, seen=None):
        """The def ``name`` of module ``module_name`` (following re-exports
        and aliases), a module name (``("module", dotted)``), or None."""
        seen = set() if seen is None else seen
        if (module_name, name) in seen:
            return None
        seen.add((module_name, name))
        submodule = f"{module_name}.{name}"
        info = self.by_name.get(module_name)
        if info is None:
            return ("module", submodule) if submodule in self.by_name else None
        if name in info.defs:
            return info.defs[name]
        if name in info.aliases:
            return self.expr(info, info.aliases[name], seen)
        if name in info.imports:
            return self._imported(info.imports[name], seen)
        if submodule in self.by_name:
            return ("module", submodule)
        return None

    def _imported(self, binding, seen):
        if binding[0] == "module":
            return binding
        _kind, module_name, name = binding
        return self.symbol(module_name, name, seen)

    def name(self, info, name, seen=None):
        """What a bare ``name`` means at the top of ``info``'s module."""
        if name in info.defs:
            return info.defs[name]
        if name in info.aliases:
            return self.expr(info, info.aliases[name], seen)
        if name in info.imports:
            return self._imported(info.imports[name], set() if seen is None else seen)
        return None

    def expr(self, info, node, seen=None):
        """A def node or ``("module", dotted)`` for a Name/Attribute chain."""
        seen = set() if seen is None else seen
        if isinstance(node, ast.Name):
            return self.name(info, node.id, seen)
        if isinstance(node, ast.Attribute):
            base = self.expr(info, node.value, seen)
            if isinstance(base, tuple) and base[0] == "module":
                return self.symbol(base[1], node.attr, seen)
        return None

    def callee(self, info, call_func, scope):
        """The def a call reaches: a bare name, a module attribute, or a
        ``self.`` method of the enclosing class (memoized per call)."""
        key = (id(call_func), id(scope))
        if key not in self._resolved:
            self._resolved[key] = self._callee(info, call_func, scope)
        return self._resolved[key]

    def _nested_defs(self, fn):
        found = self._nested.get(id(fn))
        if found is None:
            found = self._nested[id(fn)] = {}
            for stmt in ast.walk(fn):
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and stmt is not fn:
                    found.setdefault(stmt.name, stmt)
        return found

    def _callee(self, info, call_func, scope):
        if (isinstance(call_func, ast.Attribute) and isinstance(call_func.value, ast.Name)
                and call_func.value.id == "self" and scope is not None):
            cls = enclosing_class(scope)
            if cls is not None:
                for item in cls.body:
                    if (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                            and item.name == call_func.attr):
                        return item
            return None
        if isinstance(call_func, ast.Name) and scope is not None:
            # A def nested in the calling function shadows the module's.
            for parent in [scope, *_enclosing_functions(scope)]:
                nested = self._nested_defs(parent).get(call_func.id)
                if nested is not None:
                    return nested
        target = self.expr(info, call_func)
        return target if isinstance(target, (ast.FunctionDef, ast.AsyncFunctionDef)) else None


def _enclosing_functions(node):
    fn = enclosing_function(node)
    while fn is not None:
        yield fn
        fn = enclosing_function(fn)


# --- tensor-ness inside one function -----------------------------------------


class _Values:
    """Which local names hold tensors, 0-d tensors and Python numbers, by a
    flow-insensitive fixpoint over the function's bindings (nested defs and
    lambdas included, their parameters as tensors)."""

    def __init__(self, fn, tensor_params):
        self.tensors = set(tensor_params)
        self.zero_d = set()
        for node in ast.walk(fn):
            if node is not fn and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                    ast.Lambda)):
                ordered, extra = arg_names(node)
                self.tensors |= set(ordered) | set(extra)
        bindings = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                bindings.extend((t, node.value) for t in node.targets)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign, ast.NamedExpr)):
                if node.value is not None:
                    bindings.append((node.target, node.value))
            elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
                bindings.append((node.target, ("iter", node.iter)))
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                bindings.extend((item.optional_vars, ("with", item.context_expr))
                                for item in node.items if item.optional_vars is not None)
        self.numbers = self._numbers(bindings)
        changed = True
        while changed:
            changed = False
            for target, value in bindings:
                if isinstance(value, tuple):
                    kind, source = value
                    tensor = kind == "iter" and self.is_tensor(source)
                    zero_d = False
                else:
                    tensor, zero_d = self.is_tensor(value), self.is_zero_d(value)
                for name in _target_names(target):
                    if tensor and name not in self.tensors:
                        self.tensors.add(name)
                        changed = True
                    if (zero_d and isinstance(target, ast.Name)
                            and name not in self.zero_d):
                        self.zero_d.add(name)
                        changed = True

    @staticmethod
    def _numbers(bindings):
        """Names every binding of which is a Python number."""
        numbers, others = set(), set()
        for target, value in bindings:
            names = _target_names(target)
            if isinstance(target, ast.Name) and not isinstance(value, tuple) and \
                    _python_number(value):
                numbers |= names
            else:
                others |= names
        return numbers - others

    def is_tensor(self, node):
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Attribute):
            if node.attr in _METADATA_ATTRS:
                return False
            return self.is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.Starred):
            return self.is_tensor(node.value)
        if isinstance(node, (ast.BinOp,)):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tensor(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return False
            return self.is_tensor(node.left) or any(self.is_tensor(c) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_tensor(e) for e in node.elts)
        if isinstance(node, ast.Call):
            return self._call_is_tensor(node)
        return False

    def _call_is_tensor(self, node):
        func = node.func
        name = dotted_name(func) or ""
        if name.startswith("torch."):
            return name.rsplit(".", 1)[-1] not in _TORCH_NON_TENSOR and not name.startswith(
                ("torch.cuda.", "torch._C.", "torch.profiler."))
        if isinstance(func, ast.Attribute):
            if func.attr in _METADATA_METHODS or func.attr in ("item", "tolist", "numpy"):
                return False
            if self.is_tensor(func.value):
                return True
        if name in _HOST_BUILTINS:
            return False
        args = list(node.args) + [kw.value for kw in node.keywords]
        return any(self.is_tensor(a) for a in args)

    def is_zero_d(self, node):
        """A 0-d tensor: a full reduction (no ``dim``), a scalar factory,
        a 0-d name, or arithmetic of those and constants."""
        if isinstance(node, ast.Name):
            return node.id in self.zero_d
        if isinstance(node, ast.BinOp):
            sides = [s for s in (node.left, node.right) if not isinstance(s, ast.Constant)]
            return bool(sides) and all(self.is_zero_d(s) for s in sides)
        if isinstance(node, ast.UnaryOp):
            return self.is_zero_d(node.operand)
        if not isinstance(node, ast.Call):
            return False
        func = node.func
        name = dotted_name(func) or ""
        has_dim = any(kw.arg in ("dim", "axis") for kw in node.keywords)
        last = name.rsplit(".", 1)[-1] if name else getattr(func, "attr", "")
        if name.startswith("torch.") and name.count(".") == 1:
            if last in _FULL_REDUCTIONS:
                return len(node.args) == 1 and not has_dim
            if last in _SCALAR_FACTORIES:
                return bool(node.args) and _empty_shape(node.args[0])
            if last == "scalar_tensor":
                return True
            if last == "tensor":
                return bool(node.args) and _python_number(node.args[0])
            return False
        if isinstance(func, ast.Attribute) and func.attr in _FULL_REDUCTIONS:
            return not node.args and not has_dim and self.is_tensor(func.value)
        return False


def _empty_shape(node):
    return isinstance(node, (ast.Tuple, ast.List)) and not node.elts


def _target_names(target):
    return {sub.id for sub in ast.walk(target) if isinstance(sub, ast.Name)}


# --- the captured call tree ---------------------------------------------------


class CapturedFunction:
    """One function a capture records: its node, module and the parameters
    that hold tensors; ``values`` is its local analysis."""

    __slots__ = ("node", "info", "tensor_params", "values", "roots")

    def __init__(self, node, info):
        self.node = node
        self.info = info
        self.tensor_params = set()
        self.values = None
        self.roots = set()

    @property
    def name(self):
        return getattr(self.node, "name", "<lambda>")


class CaptureIndex:
    """Every captured function of the linted tree, the capture sites whose
    arguments JIT003 reads, and the capture helpers found on the way."""

    def __init__(self, modules):
        self.project = _Project(modules)
        self.captured = {}  # id(def node) -> CapturedFunction
        self.sites = []  # (info, call, callee def, forwarded param names or None)
        self.cache_calls = []  # (info, call) of STEP_GRAPHS.run/.prewarm
        self._pending = []
        self._roots()
        self._propagate()

    # --- roots ------------------------------------------------------------
    def _roots(self):
        project = self.project
        for info in project.infos:
            for node in ast.walk(info.module.tree):
                if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and node.name in FUSED_STEP_REGISTRY):
                    self._add_root(node, info)
                elif isinstance(node, ast.Call) and self._is_cache_call(node):
                    self.cache_calls.append((info, node))
                    fn = _argument(node, _CACHE_FN, "fn")
                    target = project.callee(info, fn, enclosing_function(node)) if fn else None
                    if target is not None:
                        self._add_root(target, info)
        helpers = self._capture_helpers()
        for info in project.infos:
            for block in ast.walk(info.module.tree):
                if not isinstance(block, (ast.With, ast.AsyncWith)) or not any(
                        _is_capture_context(item.context_expr) for item in block.items):
                    continue
                scope = enclosing_function(block)
                for stmt in block.body:
                    for call in ast.walk(stmt):
                        if isinstance(call, ast.Call):
                            target = project.callee(info, call.func, scope)
                            if target is not None:
                                self._add_root(target, info)
                                self.sites.append((info, call, target, None))
        # Call sites of capture helpers, to a fixpoint (a helper's caller
        # that forwards its own parameter is a helper too).
        for info in project.infos:
            for call in ast.walk(info.module.tree):
                if not isinstance(call, ast.Call):
                    continue
                scope = enclosing_function(call)
                helper = project.callee(info, call.func, scope)
                if helper is None or id(helper) not in helpers:
                    continue
                fn_param, forwarded = helpers[id(helper)]
                bound = _bind(helper, call)
                fn_arg = bound.get(fn_param)
                if isinstance(fn_arg, ast.Lambda):
                    self._add_root(fn_arg, info)
                elif fn_arg is not None:
                    target = project.callee(info, fn_arg, scope)
                    if target is not None:
                        self._add_root(target, info)
                        self.sites.append((info, call, target, forwarded))

    def _is_cache_call(self, call):
        func = call.func
        if not (isinstance(func, ast.Attribute) and func.attr in _CACHE_METHODS):
            return False
        receiver = dotted_name(func.value) or ""
        return receiver.rsplit(".", 1)[-1] in STEP_GRAPH_CACHES

    def _capture_helpers(self):
        """``id(def) -> (parameter called in a capture block, parameters
        forwarded into that call)``, to a fixpoint over plain calls."""
        project = self.project
        helpers = {}
        for info in project.infos:
            for block in ast.walk(info.module.tree):
                if not isinstance(block, (ast.With, ast.AsyncWith)) or not any(
                        _is_capture_context(item.context_expr) for item in block.items):
                    continue
                fn = enclosing_function(block)
                if fn is None:
                    continue
                ordered, extra = arg_names(fn)
                params = set(ordered) | set(extra)
                for stmt in block.body:
                    for call in ast.walk(stmt):
                        if (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
                                and call.func.id in params):
                            helpers[id(fn)] = (call.func.id, _forwarded(call, params))
        changed = True
        while changed:
            changed = False
            for info in project.infos:
                for call in ast.walk(info.module.tree):
                    if not isinstance(call, ast.Call):
                        continue
                    fn = enclosing_function(call)
                    if fn is None or id(fn) in helpers:
                        continue
                    helper = project.callee(info, call.func, fn)
                    if helper is None or id(helper) not in helpers:
                        continue
                    bound = _bind(helper, call)
                    fn_arg = bound.get(helpers[id(helper)][0])
                    ordered, extra = arg_names(fn)
                    if isinstance(fn_arg, ast.Name) and fn_arg.id in set(ordered) | set(extra):
                        forwarded = {
                            a.id for p, a in bound.items()
                            if p.split("[")[0] in helpers[id(helper)][1]
                            and isinstance(a, ast.Name)
                        }
                        helpers[id(fn)] = (fn_arg.id, forwarded)
                        changed = True
        return helpers

    def _add_root(self, node, info):
        """A root: its positional parameters are its tensors."""
        ordered, extra = arg_names(node)
        vararg = node.args.vararg.arg if node.args.vararg else None
        params = set(ordered) | ({vararg} if vararg else set())
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and enclosing_class(
                node) is not None and ordered and ordered[0] in ("self", "cls"):
            params.discard(ordered[0])
        self._mark(node, params, root=True)

    def _mark(self, node, tensor_params, root=False):
        info = self.project.owner.get(id(node))
        if info is None:
            return
        entry = self.captured.get(id(node))
        if entry is None:
            entry = self.captured[id(node)] = CapturedFunction(node, info)
            self._pending.append(entry)
        elif not tensor_params - entry.tensor_params:
            return
        elif entry not in self._pending:
            self._pending.append(entry)
        entry.tensor_params |= tensor_params

    # --- the call tree ----------------------------------------------------
    def _propagate(self):
        project = self.project
        while self._pending:
            entry = self._pending.pop()
            entry.values = values = _Values(entry.node, entry.tensor_params)
            for call in _calls_in(entry.node):
                scope = enclosing_function(call) or entry.node
                if isinstance(entry.node, ast.Lambda):
                    scope = enclosing_function(entry.node)
                target = project.callee(entry.info, call.func, scope)
                if target is not None:
                    bound = _bind(target, call)
                    tensors = {p.split("[")[0] for p, a in bound.items()
                               if values.is_tensor(a)}
                    self._mark(target, tensors)
                # A function handed to another call runs inside the capture too.
                for arg in list(call.args) + [kw.value for kw in call.keywords]:
                    if isinstance(arg, (ast.Name, ast.Attribute)):
                        ref = project.callee(entry.info, arg, scope)
                        if ref is not None and ref is not target:
                            self._add_root(ref, project.owner.get(id(ref)))

    def functions_of(self, module):
        return [c for c in self.captured.values() if c.info.module is module]


def _calls_in(fn):
    if isinstance(fn, ast.Lambda):
        return [n for n in ast.walk(fn.body) if isinstance(n, ast.Call)]
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call)]


def _argument(call, position, keyword):
    if len(call.args) > position and not any(
            isinstance(a, ast.Starred) for a in call.args[:position + 1]):
        return call.args[position]
    for kw in call.keywords:
        if kw.arg == keyword:
            return kw.value
    return None


def _bind(fn, call):
    """``{parameter name: argument node}`` of a call to ``fn`` (a bound
    ``self.`` method skips ``self``); the extra positional arguments of a
    ``*args`` parameter bind as ``args[0]``, ``args[1]``, ..."""
    ordered, _extra = arg_names(fn)
    if (isinstance(call.func, ast.Attribute) and isinstance(call.func.value, ast.Name)
            and call.func.value.id == "self" and ordered and ordered[0] == "self"):
        ordered = ordered[1:]
    bound = {}
    vararg = fn.args.vararg.arg if fn.args.vararg else None
    for index, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            break
        if index < len(ordered):
            bound[ordered[index]] = arg
        elif vararg is not None:
            bound[f"{vararg}[{index - len(ordered)}]"] = arg
    for kw in call.keywords:
        if kw.arg is not None:
            bound[kw.arg] = kw.value
    return bound


def _forwarded(call, params):
    """Parameters of the helper that flow into the captured call."""
    names = set()
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        value = arg.value if isinstance(arg, ast.Starred) else arg
        if isinstance(value, ast.Name) and value.id in params:
            names.add(value.id)
    return names


def capture_index(modules):
    """The run's :class:`CaptureIndex`, built once and shared by the four
    rules (cached on the first module; it dies with the run)."""
    if not modules:
        return CaptureIndex([])
    cached = getattr(modules[0], "lint_capture_index", None)
    if cached is None:
        cached = modules[0].lint_capture_index = CaptureIndex(modules)
    return cached


def captured_spans(paths):
    """``[(path, name, first line, last line)]`` of every captured function
    under ``paths``: what the card's sync check holds the rules to."""
    from orion_tpu_torch.analysis.engine import iter_python_files, load_module

    modules = [m for m, _error in map(load_module, iter_python_files(paths)) if m is not None]
    index = CaptureIndex(modules)
    return sorted(
        (os.path.realpath(c.info.module.path), c.name, c.node.lineno, c.node.end_lineno)
        for c in index.captured.values()
    )


# --- the rules ----------------------------------------------------------------


class _CaptureRule(Rule):
    def begin(self, modules):
        self._index = capture_index(modules)

    def _captured(self, module):
        return self._index.functions_of(module)


class HostSyncInCapture(_CaptureRule):
    id = "JIT001"
    name = "host-sync-in-capture"
    description = (
        "No host synchronization inside a captured function (a CUDA-graph "
        "capture records the whole call tree of _suggest_step and of "
        "whatever STEP_GRAPHS.run/.prewarm or torch.cuda.graph captures): "
        ".item()/.tolist()/.cpu()/.numpy()/.to('cpu')/.synchronize(), "
        "float()/int()/bool() of a tensor, numpy over a tensor, "
        "torch.tensor/as_tensor/from_numpy (a host copy), nonzero/"
        "masked_select/unique, or indexing by a 0-d tensor (use "
        "index_select)."
    )

    def check(self, module):
        for fn in self._captured(module):
            values = fn.values
            for node in _calls_in(fn.node) + [
                    n for n in ast.walk(fn.node) if isinstance(n, ast.Subscript)]:
                message = self._violation(node, values)
                if message:
                    yield Diagnostic(module.path, node.lineno, node.col_offset, self.id,
                                     f"{message} inside captured function '{fn.name}'; a "
                                     "capture cannot sync with the host — keep the value "
                                     "on the device or move the read out of the round")

    @staticmethod
    def _violation(node, values):
        if isinstance(node, ast.Subscript):
            index = node.slice
            parts = index.elts if isinstance(index, ast.Tuple) else [index]
            if any(values.is_zero_d(p) for p in parts):
                return "indexing by a 0-d tensor reads the index to the host"
            return None
        func = node.func
        name = dotted_name(func) or ""
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS and not (
                name.startswith("torch.") and name.count(".") == 1):
            return f".{func.attr}() forces a host sync"
        if (isinstance(func, ast.Attribute) and func.attr == "to"
                and any(_is_cpu(a) for a in list(node.args) + [
                    kw.value for kw in node.keywords if kw.arg == "device"])):
            return ".to('cpu') copies to the host"
        if name.startswith("torch.") and name.count(".") == 1 and \
                name.split(".")[1] in _SYNC_TORCH:
            if name.split(".")[1] in _HOST_COPIES:
                return f"{name}() copies a host value to the device"
            return f"{name}() synchronizes with the host"
        if name in _CONCRETIZING_BUILTINS and node.args and values.is_tensor(node.args[0]):
            return f"{name}() of a tensor reads it to the host"
        if "." in name and name.split(".", 1)[0] in _NUMPY_ALIASES and any(
                values.is_tensor(a) for a in list(node.args) + [kw.value for kw in node.keywords]):
            return f"numpy call {name}() over a tensor reads it to the host"
        return None


def _is_cpu(node):
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and (dotted_name(node.func) or "").endswith("device")
            and bool(node.args) and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


class BranchOnTensor(_CaptureRule):
    id = "JIT002"
    name = "branch-on-tensor"
    description = (
        "No Python control flow on a tensor value inside a captured "
        "function: if/while/assert/a conditional expression on a tensor "
        "calls bool() on it, a host sync no capture allows (use "
        "torch.where).  A branch on a Python static — a keyword-only "
        "argument of the captured root, a shape, a string — is baked into "
        "the capture by design and is not flagged."
    )

    def check(self, module):
        for fn in self._captured(module):
            for node in ast.walk(fn.node):
                if not isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
                    continue
                if fn.values.is_tensor(node.test):
                    kind = "conditional expression" if isinstance(node, ast.IfExp) else \
                        type(node).__name__.lower()
                    yield Diagnostic(module.path, node.lineno, node.col_offset, self.id,
                                     f"python {kind} on a tensor value inside captured "
                                     f"function '{fn.name}'; bool() of a tensor syncs with "
                                     "the host — use torch.where, or branch on a static")


class StaleScalarInCapture(_CaptureRule):
    id = "JIT003"
    name = "stale-scalar-in-capture"
    description = (
        "No Python number threaded positionally into a tensor slot of a "
        "captured function at a capture site (a torch.cuda.graph block, a "
        "capture helper's call, STEP_GRAPHS.run's arrays): the capture "
        "bakes it in and every replay reuses it (the step graphs copy only "
        "tensors into their static inputs) — pass a 0-d device tensor.  "
        "Nor a per-round host read (float()/int()/.item()/.tolist()) among "
        "the statics handed to STEP_GRAPHS.run/.prewarm: a static that "
        "changes every round forks the step-graph signature every round."
    )

    def check(self, module):
        index = self._index
        for info, call, target, forwarded in index.sites:
            if info.module is not module:
                continue
            numbers = _Values(enclosing_function(call), ()).numbers if enclosing_function(
                call) is not None else set()
            bound = _bind(target, call) if forwarded is None else {
                p: a for p, a in _bind(_helper_of(index, info, call), call).items()
                if p.split("[")[0] in forwarded}
            positional = set(arg_names(target)[0])
            for param, arg in bound.items():
                if forwarded is None and param not in positional:
                    continue
                if _python_number(arg, numbers):
                    yield Diagnostic(module.path, arg.lineno, arg.col_offset, self.id,
                                     f"python number passed into a tensor slot of captured "
                                     f"function '{target.name}'; the capture bakes it in "
                                     "and every replay reuses it — pass a 0-d device "
                                     "tensor")
        for info, call in index.cache_calls:
            if info.module is not module:
                continue
            scope = enclosing_function(call)
            yield from self._cache_call(module, call, scope)

    def _cache_call(self, module, call, scope):
        arrays = _resolve_local(_argument(call, _CACHE_ARRAYS, "arrays"), scope, call)
        if isinstance(arrays, (ast.Tuple, ast.List)):
            numbers = _Values(scope, ()).numbers if scope is not None else set()
            for element in arrays.elts:
                if _python_number(element, numbers):
                    yield Diagnostic(module.path, element.lineno, element.col_offset, self.id,
                                     "python number among the arrays handed to the step "
                                     "graphs; a replay copies only tensors into the "
                                     "captured inputs, so it reuses the first round's "
                                     "value — pass a 0-d device tensor")
        statics = _resolve_local(_argument(call, _CACHE_STATICS, "statics"), scope, call)
        values = []
        if isinstance(statics, ast.Dict):
            values = statics.values
        elif isinstance(statics, ast.Call) and dotted_name(statics.func) == "dict":
            values = [kw.value for kw in statics.keywords]
        for value in values:
            if _host_read(value):
                yield Diagnostic(module.path, value.lineno, value.col_offset, self.id,
                                 "a per-round host read among the statics handed to the "
                                 "step graphs; a static that changes every round forks "
                                 "the step-graph signature every round (a capture a round)"
                                 " — pass it in the arrays as a device tensor")


def _helper_of(index, info, call):
    return index.project.callee(info, call.func, enclosing_function(call))


def _resolve_local(node, scope, before):
    """A Name's last plain assignment in ``scope`` before ``before``."""
    if not isinstance(node, ast.Name) or scope is None:
        return node
    found = node
    for stmt in ast.walk(scope):
        if (isinstance(stmt, ast.Assign) and stmt.lineno < before.lineno
                and any(isinstance(t, ast.Name) and t.id == node.id for t in stmt.targets)):
            found = stmt.value
    return found


class MeshConstructionInHotPath(_CaptureRule):
    id = "JIT004"
    name = "mesh-construction-in-hot-path"
    description = (
        "No per-call Mesh(...)/DeviceMesh(...)/init_device_mesh(...) inside "
        "a captured function or a declared hot-path function "
        "(HOT_PATH_REGISTRY): a mesh is named once per topology (the cached "
        "get_mesh/device_mesh), never built per round — its identity keys "
        "the round's graph signature."
    )

    def check(self, module):
        captured = {id(c.node) for c in self._captured(module)}
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if id(fn) not in captured and fn.name not in HOT_PATH_REGISTRY:
                continue
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call):
                    continue
                name = dotted_name(call.func)
                if name and name.rsplit(".", 1)[-1] in _MESH_CONSTRUCTORS:
                    yield Diagnostic(module.path, call.lineno, call.col_offset, self.id,
                                     f"{name}(...) constructed inside hot-path function "
                                     f"'{fn.name}'; build the mesh once and pass it in")


JIT_RULES = (HostSyncInCapture, BranchOnTensor, StaleScalarInCapture,
             MeshConstructionInHotPath)
