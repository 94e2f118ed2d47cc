"""Storage retry/trace coverage rules (``STO001``–``STO005``; port of
``orion_tpu/analysis/storage_rules.py``, the same rules over the port's
storage, whose base classes and decorators keep the reference's names).

The port's storage rests on one invariant: every storage protocol op
rides the shared :class:`~orion_tpu_torch.storage.retry.RetryPolicy` through the
``_traced``/``_retrying`` decorators, with a declared applied-or-not mode —
and every ambiguous wire loss carries ``maybe_applied`` so non-converging
ops can refuse a blind re-send.  A new protocol op that skips the decorator
silently reverts to pre-policy crash-on-transient behavior; a new
``DatabaseError`` raised after bytes may have hit the wire without the
flag silently turns CAS retries unsafe.  These rules pin both.

``STO004`` extends the discipline to the sharded router
(``storage/shard.py``): a fan-out method that aggregates per-shard
``DatabaseError``\\ s must propagate the STRICTEST ``maybe_applied`` of
its parts — one shard's ambiguous loss makes the whole fan-out ambiguous,
and a summary error raised without the merged verdict silently launders a
maybe-applied mutation into a blindly-retriable one.
"""

import ast

from orion_tpu_torch.analysis.engine import Diagnostic, Rule, dotted_name

#: A class participates in the storage protocol when it, or any base by
#: name, carries one of these names.
_STORAGE_BASES = ("BaseStorage", "DocumentStorage")

#: Decorators that apply the unified retry policy.
_RETRY_DECORATORS = ("_traced", "_retrying")

#: The explicit-mode keyword each decorator takes.
_MODE_KEYWORDS = {"_traced": "retry", "_retrying": "mode"}

#: Wire-send markers: a function containing one of these calls may have put
#: bytes on the wire before any later failure.
_SEND_ATTRS = frozenset({"sendall", "_exchange"})


def _is_storage_class(node):
    if node.name in _STORAGE_BASES:
        return True
    for base in node.bases:
        name = dotted_name(base) or ""
        if name.split(".")[-1] in _STORAGE_BASES:
            return True
    return False


def _touches_db(fn):
    """True when the method body reads ``self._db`` (the raw backend)."""
    for node in ast.walk(fn):
        if dotted_name(node) == "self._db" and isinstance(node, ast.Attribute):
            return True
        # _db_batch / _db_batch_capable route to the backend too.
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if name.startswith("self._db_batch"):
                return True
    return False


def _retry_decorator(fn):
    """The ``_traced``/``_retrying`` decorator Call on ``fn``, or None."""
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call):
            name = (dotted_name(dec.func) or "").split(".")[-1]
            if name in _RETRY_DECORATORS:
                return name, dec
        else:
            name = (dotted_name(dec) or "").split(".")[-1]
            if name in _RETRY_DECORATORS:
                return name, None
    return None, None


def _has_property_decorator(fn):
    return any((dotted_name(d) or "") == "property" for d in fn.decorator_list)


class UncoveredStorageOp(Rule):
    id = "STO001"
    name = "uncovered-storage-op"
    description = (
        "Every public method of a BaseStorage/DocumentStorage subclass that "
        "touches self._db must be wrapped in _traced(...)/_retrying(...) so "
        "it rides the unified retry policy (and, for hot ops, the telemetry "
        "span/histogram channel)."
    )

    def check(self, module):
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ClassDef) or not _is_storage_class(node):
                continue
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                # Private methods (and thereby every dunder lifecycle hook)
                # are out of scope: the rule covers the public protocol.
                if item.name.startswith("_"):
                    continue
                if _has_property_decorator(item):
                    continue
                if not _touches_db(item):
                    continue
                name, _call = _retry_decorator(item)
                if name is None:
                    yield Diagnostic(
                        module.path,
                        item.lineno,
                        item.col_offset,
                        self.id,
                        f"storage op '{node.name}.{item.name}' touches "
                        "self._db without @_traced/@_retrying — it would "
                        "crash on the first transient backend failure "
                        "instead of riding the unified retry policy",
                    )


class ImplicitRetryMode(Rule):
    id = "STO002"
    name = "implicit-retry-mode"
    description = (
        "_traced/_retrying decorators must declare their applied-or-not "
        "mode explicitly (retry=MODE_ALWAYS/MODE_UNAPPLIED/None for "
        "_traced, mode=... for _retrying): whether an op converges under "
        "re-application is a per-op correctness decision, not a default."
    )

    def check(self, module):
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            name, call = _retry_decorator(node)
            if name is None:
                continue
            keyword = _MODE_KEYWORDS[name]
            if call is None or not any(kw.arg == keyword for kw in call.keywords):
                yield Diagnostic(
                    module.path,
                    node.lineno,
                    node.col_offset,
                    self.id,
                    f"@{name} on '{node.name}' relies on the default retry "
                    f"mode; declare {keyword}=MODE_ALWAYS / MODE_UNAPPLIED "
                    "(or None to opt out) so the convergence contract is "
                    "visible at the op",
                )


class AmbiguousWireError(Rule):
    id = "STO003"
    name = "ambiguous-wire-error"
    description = (
        "In a function that sends on the wire (calls .sendall()/"
        "._exchange()), every DatabaseError raised must carry an explicit "
        "maybe_applied decision — raise a variable whose .maybe_applied "
        "was assigned, or suppress with the reason why nothing was sent."
    )

    def _sends(self, fn):
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                if node.func.attr in _SEND_ATTRS:
                    return True
        return False

    def check(self, module):
        for fn in [
            n
            for n in ast.walk(module.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]:
            if not self._sends(fn):
                continue
            # Names whose .maybe_applied is assigned somewhere in this fn.
            marked = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    for target in node.targets:
                        if (
                            isinstance(target, ast.Attribute)
                            and target.attr == "maybe_applied"
                            and isinstance(target.value, ast.Name)
                        ):
                            marked.add(target.value.id)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Raise) or node.exc is None:
                    continue
                exc = node.exc
                if isinstance(exc, ast.Call):
                    name = (dotted_name(exc.func) or "").split(".")[-1]
                    if name == "DatabaseError":
                        yield Diagnostic(
                            module.path,
                            node.lineno,
                            node.col_offset,
                            self.id,
                            "DatabaseError raised inline in a wire-send "
                            "function without a maybe_applied decision; "
                            "assign it to a variable and set "
                            ".maybe_applied before raising",
                        )
                elif isinstance(exc, ast.Name) and exc.id not in marked:
                    # `raise exc` re-raising the caught error propagates its
                    # own maybe_applied — but only if the caught name wasn't
                    # rebound to a fresh DatabaseError without the flag.
                    if self._binds_database_error(fn, exc.id):
                        yield Diagnostic(
                            module.path,
                            node.lineno,
                            node.col_offset,
                            self.id,
                            f"DatabaseError variable {exc.id!r} raised in a "
                            "wire-send function without .maybe_applied ever "
                            "being set on it",
                        )

    def _binds_database_error(self, fn, name):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                callee = (dotted_name(node.value.func) or "").split(".")[-1]
                if callee == "DatabaseError" and any(
                    isinstance(t, ast.Name) and t.id == name for t in node.targets
                ):
                    return True
        return False


#: Blessed aggregation surfaces for STO004: the error constructor that
#: stamps the merged verdict itself, and the merge predicate a hand-built
#: error may assign ``maybe_applied`` from.
_FANOUT_ERROR_CONSTRUCTORS = frozenset({"shard_fanout_error"})
_MERGE_PREDICATES = frozenset({"merge_maybe_applied"})


class UnmergedFanoutError(Rule):
    id = "STO004"
    name = "unmerged-fanout-error"
    description = (
        "In a shard-routing class (name contains 'Sharded') or a fan-out "
        "helper (name contains 'fan_out'/'fanout'), every DatabaseError "
        "raised must carry the strictest maybe_applied of the per-shard "
        "parts: raise shard_fanout_error(...) (which merges internally), "
        "or assign .maybe_applied from merge_maybe_applied(...) before "
        "raising.  An unmerged summary error would let the retry policy "
        "blind-resend a mutation one shard may already have applied."
    )

    def _fanout_functions(self, tree):
        """(owner, fn) pairs in scope: methods of Sharded* classes plus any
        function whose own name marks it a fan-out helper."""
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and "Sharded" in node.name:
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        yield node.name, item
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                lowered = node.name.lower()
                if "fan_out" in lowered or "fanout" in lowered:
                    yield None, node

    def _merged_names(self, fn):
        """Names whose error carries a merged verdict: assigned from a
        blessed constructor, or whose .maybe_applied is assigned from a merge
        predicate call."""
        merged = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign) or not isinstance(
                node.value, ast.Call
            ):
                continue
            callee = (dotted_name(node.value.func) or "").split(".")[-1]
            for target in node.targets:
                if isinstance(target, ast.Name) and callee in _FANOUT_ERROR_CONSTRUCTORS:
                    merged.add(target.id)
                if (
                    isinstance(target, ast.Attribute)
                    and target.attr == "maybe_applied"
                    and isinstance(target.value, ast.Name)
                    and callee in _MERGE_PREDICATES
                ):
                    merged.add(target.value.id)
        return merged

    def check(self, module):
        seen = set()
        for owner, fn in self._fanout_functions(module.tree):
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            merged = self._merged_names(fn)
            where = f"{owner}.{fn.name}" if owner else fn.name
            for node in ast.walk(fn):
                if not isinstance(node, ast.Raise) or node.exc is None:
                    continue
                exc = node.exc
                if isinstance(exc, ast.Call):
                    callee = (dotted_name(exc.func) or "").split(".")[-1]
                    if callee in _FANOUT_ERROR_CONSTRUCTORS:
                        continue
                    if callee == "DatabaseError":
                        yield Diagnostic(
                            module.path,
                            node.lineno,
                            node.col_offset,
                            self.id,
                            f"DatabaseError raised inline in fan-out scope "
                            f"'{where}' without the merged per-shard "
                            "maybe_applied; raise shard_fanout_error(...) "
                            "or assign .maybe_applied from "
                            "merge_maybe_applied(...) first",
                        )
                elif isinstance(exc, ast.Name) and exc.id not in merged:
                    if self._binds_database_error(fn, exc.id):
                        yield Diagnostic(
                            module.path,
                            node.lineno,
                            node.col_offset,
                            self.id,
                            f"DatabaseError variable {exc.id!r} raised in "
                            f"fan-out scope '{where}' without its "
                            "maybe_applied merged from the per-shard parts "
                            "(merge_maybe_applied / shard_fanout_error)",
                        )

    def _binds_database_error(self, fn, name):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                callee = (dotted_name(node.value.func) or "").split(".")[-1]
                if callee == "DatabaseError" and any(
                    isinstance(t, ast.Name) and t.id == name for t in node.targets
                ):
                    return True
        return False


#: STO005 markers: the placement-override collection (either spelling) and
#: the epoch-mutating wire op.
_PLACEMENT_NAMES = frozenset({"_placement", "PLACEMENT_COLLECTION"})
_PLACEMENT_MUTATORS = frozenset({"write", "read_and_write", "remove"})
_EPOCH_WIRE_OPS = frozenset({"promote"})


class UnguardedPlacementMutation(Rule):
    id = "STO005"
    name = "unguarded-placement-mutation"
    description = (
        "Placement/epoch state is the routing ground truth of the live "
        "control plane: every mutation of the `_placement` collection "
        "(write/read_and_write/remove) and every `promote` wire call must "
        "ride a RetryPolicy.run(..., mode=...) with an EXPLICIT "
        "applied-or-not mode in the same (outermost) function — a bare "
        "call that dies mid-wire leaves the migration state machine "
        "half-flipped with no declared convergence contract."
    )

    def _outermost_functions(self, tree):
        """Top-level functions and class methods, NOT nested defs: the
        policy.run(mode=...) covering a nested thunk lives in the
        enclosing function, which is the unit of review."""
        stack = [(tree, False)]
        while stack:
            node, inside_fn = stack.pop()
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if not inside_fn:
                        yield child
                    stack.append((child, True))
                else:
                    stack.append((child, inside_fn))

    @staticmethod
    def _first_arg_marks_placement(node):
        if not node.args:
            return False
        first = node.args[0]
        if isinstance(first, ast.Constant) and first.value == "_placement":
            return True
        name = dotted_name(first) or ""
        return name.split(".")[-1] in _PLACEMENT_NAMES

    def _flagged_calls(self, fn):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or not isinstance(
                node.func, ast.Attribute
            ):
                continue
            attr = node.func.attr
            if attr in _PLACEMENT_MUTATORS and self._first_arg_marks_placement(
                node
            ):
                yield node, "placement mutation"
            elif attr == "_call" and node.args:
                op = node.args[0]
                if (
                    isinstance(op, ast.Constant)
                    and op.value in _EPOCH_WIRE_OPS
                ):
                    yield node, f"'{op.value}' wire op"

    @staticmethod
    def _has_explicit_mode_run(fn):
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "run"
                and any(kw.arg == "mode" for kw in node.keywords)
            ):
                return True
        return False

    def check(self, module):
        for fn in self._outermost_functions(module.tree):
            covered = None
            for node, what in self._flagged_calls(fn):
                if covered is None:
                    covered = self._has_explicit_mode_run(fn)
                if covered:
                    continue
                yield Diagnostic(
                    module.path,
                    node.lineno,
                    node.col_offset,
                    self.id,
                    f"{what} in '{fn.name}' without a RetryPolicy.run(..., "
                    "mode=...) in the same function — placement/epoch "
                    "mutations must declare their applied-or-not "
                    "convergence mode explicitly",
                )


STORAGE_RULES = (
    UncoveredStorageOp,
    ImplicitRetryMode,
    AmbiguousWireError,
    UnmergedFanoutError,
    UnguardedPlacementMutation,
)
