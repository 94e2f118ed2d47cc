"""Telemetry discipline rules (``TEL001``–``TEL006``; port of
``orion_tpu/analysis/telemetry_rules.py``).

The telemetry plane's contract: the registry is near-zero-cost when
disabled, and stays cheap when enabled.  Three ways code quietly breaks it
— computing a registry key per loop iteration, timing a block with a
manually-managed span (leaks the record on an exception path), and
building f-string names or args dicts at a call site that runs even when
telemetry is off (the mutator early-returns, but its arguments were
already allocated).

``TEL004`` extends the allocation discipline to the optimization-health
emitters (``orion_tpu_torch.health``): ``FLIGHT.record(...)`` and the
storage channel's ``record_health(...)`` sit on the same hot paths as the
TELEMETRY mutators and must not build allocating arguments on the
disabled path either (a guard on ``FLIGHT.enabled`` or
``TELEMETRY.enabled`` whitelists, exactly as for TEL003).  ``TEL005``
holds wire spans to the trace context; ``TEL006`` holds the doctor's rule
classes (``orion_tpu_torch.diagnosis.engine.DoctorRule``) to declared
severities, runbook anchors and gauge names minted once per class."""

import ast

from orion_tpu_torch.analysis.engine import (
    Diagnostic,
    Rule,
    ancestors,
    arg_names,
    dotted_name,
    enclosing_function,
)

#: Mutators of the process-wide registry.
_MUTATORS = frozenset({"count", "observe", "set_gauge", "record_span"})

#: Argument AST nodes whose construction allocates per call.
_ALLOCATING_NODES = (
    ast.JoinedStr,
    ast.Dict,
    ast.List,
    ast.Set,
    ast.ListComp,
    ast.SetComp,
    ast.DictComp,
    ast.GeneratorExp,
)


def _telemetry_call(node):
    """The mutator name when ``node`` is a TELEMETRY registry call
    (``TELEMETRY.count(...)``, ``tel.TELEMETRY.observe(...)``), else None."""
    if not isinstance(node, ast.Call):
        return None
    name = dotted_name(node.func)
    if not name:
        return None
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] == "TELEMETRY" and parts[-1] in _MUTATORS:
        return parts[-1]
    return None


def _enabled_polarity(test, negated=False):
    """``"pos"`` when the test can only be TRUE with telemetry enabled
    (the body is the enabled-only path), ``"neg"`` when it can only be
    FALSE with telemetry enabled (the else is), None when the flag does
    not dominate the branch.  Domination matters: in ``done or
    TELEMETRY.enabled`` the body still runs disabled, so the read must
    not whitelist it — only a bare flag read, ``not``, and the
    implication-preserving sides of and/or propagate polarity; anything
    else (comparisons, calls) is opaque."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _enabled_polarity(test.operand, not negated)
    name = dotted_name(test)
    if (
        name
        and name.split(".")[-1] == "enabled"
        and ("TELEMETRY" in name or "FLIGHT" in name)
    ):
        # Both observability flags dominate: TELEMETRY.enabled for the
        # registry mutators, FLIGHT.enabled for the health/flight
        # emitters (TEL004) — the CLI flips them together, and either
        # guard proves the disabled path skips the allocation.
        return "neg" if negated else "pos"
    if isinstance(test, ast.BoolOp):
        results = [_enabled_polarity(v, negated) for v in test.values]
        conjunction = isinstance(test.op, ast.And) != negated  # De Morgan
        if conjunction:
            # a and b true => every conjunct true: one "pos" suffices;
            # false => some conjunct false: "neg" needs ALL of them.
            if any(r == "pos" for r in results):
                return "pos"
            if all(r == "neg" for r in results):
                return "neg"
        else:
            # a or b true => some disjunct true: "pos" needs ALL;
            # false => every disjunct false: one "neg" suffices.
            if all(r == "pos" for r in results):
                return "pos"
            if any(r == "neg" for r in results):
                return "neg"
    return None


def _in_body(if_node, child):
    """Whether ``child`` (the ancestor-chain node directly under
    ``if_node``) sits in the ``if`` body rather than the ``else``."""
    return any(child is stmt for stmt in if_node.body)


def _mints_sentinel(ifexp):
    """True when the IfExp is truthy exactly when telemetry is enabled:
    ``clock() if TELEMETRY.enabled else None`` (or the inverted
    ``None if not TELEMETRY.enabled else clock()``) — the branch the
    DISABLED path takes must be a falsy constant, or the minted name is
    truthy with telemetry off."""
    polarity = _enabled_polarity(ifexp.test)
    if polarity == "pos":
        disabled_side = ifexp.orelse
    elif polarity == "neg":
        disabled_side = ifexp.body
    else:
        return False
    return isinstance(disabled_side, ast.Constant) and not disabled_side.value


def _sentinel_polarity(test, sentinels):
    """``"pos"`` when the test is truthy only if the sentinel is set
    (bare ``t0`` / ``t0 is not None``), ``"neg"`` for the inverse
    (``t0 is None`` / ``not t0``), None when no sentinel dominates —
    the side of the branch matters: ``if t0 is None:`` puts the DISABLED
    path in the body."""
    if isinstance(test, ast.Name) and test.id in sentinels:
        return "pos"
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _sentinel_polarity(test.operand, sentinels)
        if inner == "pos":
            return "neg"
        if inner == "neg":
            return "pos"
        return None
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        left, op, right = test.left, test.ops[0], test.comparators[0]
        if (
            isinstance(left, ast.Name)
            and left.id in sentinels
            and isinstance(right, ast.Constant)
            and right.value is None
        ):
            if isinstance(op, ast.IsNot):
                return "pos"
            if isinstance(op, ast.Is):
                return "neg"
    return None


def _in_enabled_context(node):
    """True when ``node`` only executes with telemetry enabled: an
    ancestor ``if`` with enabled polarity puts it on the enabled side
    (body of ``if TELEMETRY.enabled:`` / else of the negation)."""
    child = node
    for parent in ancestors(node):
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        if isinstance(parent, ast.If):
            polarity = _enabled_polarity(parent.test)
            in_body = _in_body(parent, child)
            if polarity == "pos" and in_body:
                return True
            if polarity == "neg" and not in_body:
                return True
        child = parent
    return False


def _early_exit_dominates(call):
    """True when an earlier SIBLING statement on the call's path is an
    ``if`` that leaves with telemetry disabled (``if not TELEMETRY.enabled:
    return/raise/continue``).  Sibling position is what makes this real
    dominance: reaching the call means its whole ancestor-statement chain
    executed, which means every earlier statement in each of those blocks
    ran without exiting — whereas a guard nested in some UNRELATED branch
    (or in a loop the call is outside of) proves nothing."""
    child = call
    for parent in ancestors(call):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(parent, field, None)
            if not isinstance(stmts, list):
                continue
            position = next(
                (i for i, stmt in enumerate(stmts) if stmt is child), None
            )
            if position is None:
                continue
            for stmt in stmts[:position]:
                if (
                    isinstance(stmt, ast.If)
                    and _enabled_polarity(stmt.test) == "neg"
                    and any(
                        isinstance(s, (ast.Return, ast.Raise, ast.Continue))
                        for s in stmt.body
                    )
                ):
                    return True
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
        child = parent
    return False


def _is_guarded(call):
    """True when the mutator call only runs with telemetry enabled:

    - an ancestor ``if`` branch reachable only with the flag set: the body
      of ``if TELEMETRY.enabled:`` / the ``else`` of ``if not
      TELEMETRY.enabled:``, or the body of a test on a variable assigned
      from a ``... if TELEMETRY.enabled else None`` sentinel (the
      ``t0 is not None`` idiom); or
    - an earlier sibling statement on the call's path that exits with the
      flag unset (the ``if not TELEMETRY.enabled: return`` prologue idiom;
      see :func:`_early_exit_dominates` for why siblinghood is required).
    """
    fn = enclosing_function(call)
    sentinels = set()
    if fn is not None:
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.IfExp):
                # t0 = time.perf_counter() if TELEMETRY.enabled else None —
                # the flag must dominate the conditional AND the disabled
                # side must be falsy for the target to track enabled-ness.
                if _mints_sentinel(node.value):
                    sentinels |= {
                        t.id for t in node.targets if isinstance(t, ast.Name)
                    }
            elif isinstance(node, ast.Assign) and _in_enabled_context(node):
                # t0 = None; if TELEMETRY.enabled: ...; t0 = clock() —
                # harvest targets only from enabled-only contexts, or an
                # assignment on the DISABLED side would mint a sentinel
                # that is truthy with telemetry off.
                sentinels |= {
                    t.id for t in node.targets if isinstance(t, ast.Name)
                }
        # A candidate only tracks enabled-ness if NO other write can leave
        # it truthy with telemetry disabled: every assignment to it must
        # be the minting IfExp, sit in an enabled-only context, or be a
        # falsy-constant reset (`t0 = None`).  `done = False` + `if
        # enabled: done = True` followed by an unconditional `done = True`
        # elsewhere is NOT a sentinel.
        if sentinels:
            # Bindings that aren't assignments can make the name truthy
            # with telemetry off regardless of any guard: parameters (the
            # caller picks the value), loop targets, with/except aliases,
            # global/nonlocal (rebindable elsewhere).
            ordered, extra = arg_names(fn)
            sentinels -= set(ordered) | set(extra)
            for node in ast.walk(fn):
                value = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign, ast.NamedExpr)):
                    targets, value = (node.target,), node.value
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    targets = (node.target,)
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    targets = tuple(
                        item.optional_vars
                        for item in node.items
                        if item.optional_vars is not None
                    )
                elif isinstance(node, ast.ExceptHandler):
                    sentinels.discard(node.name)
                    continue
                elif isinstance(node, (ast.Global, ast.Nonlocal)):
                    sentinels -= set(node.names)
                    continue
                else:
                    continue
                names = set()
                for t in targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name):
                            names.add(sub.id)
                if not names & sentinels:
                    continue
                if (
                    isinstance(node, ast.Assign)
                    and isinstance(value, ast.IfExp)
                    and _mints_sentinel(value)
                ):
                    continue
                if (
                    not isinstance(node, ast.AugAssign)
                    and isinstance(value, ast.Constant)
                    and not value.value
                ):
                    continue
                if _in_enabled_context(node):
                    continue
                sentinels -= names
    child = call
    for parent in ancestors(call):
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
        if isinstance(parent, ast.If):
            polarity = _enabled_polarity(parent.test)
            in_body = _in_body(parent, child)
            if polarity == "pos" and in_body:
                return True
            if polarity == "neg" and not in_body:
                return True
            if polarity is None:
                # The SIDE of a sentinel test matters: `if t0 is None:`
                # puts the disabled path in the body, so only the truthy
                # side of the sentinel whitelists the call.
                spol = _sentinel_polarity(parent.test, sentinels)
                if spol == "pos" and in_body:
                    return True
                if spol == "neg" and not in_body:
                    return True
        child = parent
    return _early_exit_dominates(call)


class DynamicKeyInLoop(Rule):
    id = "TEL001"
    name = "dynamic-key-in-loop"
    description = (
        "No per-iteration registry keys: a TELEMETRY mutator called inside "
        "a for/while loop must use a constant metric name — an f-string/"
        "concatenated name allocates and re-hashes the key every iteration "
        "of a hot loop (hoist the name, or batch the samples)."
    )

    def check(self, module):
        for node in ast.walk(module.tree):
            mutator = _telemetry_call(node)
            if mutator is None or not node.args:
                continue
            name_arg = node.args[0]
            # Constants are free; plain names/attributes are the sanctioned
            # hoisted form — only per-call COMPUTATION (f-string, concat,
            # call) of the key inside the loop is the violation.
            if isinstance(name_arg, (ast.Constant, ast.Name, ast.Attribute)):
                continue
            in_loop = any(
                isinstance(parent, (ast.For, ast.While))
                for parent in ancestors(node)
            )
            if in_loop:
                yield Diagnostic(
                    module.path,
                    node.lineno,
                    node.col_offset,
                    self.id,
                    f"TELEMETRY.{mutator}() with a computed metric name "
                    "inside a loop; hoist the key out of the loop or batch "
                    "the samples into one call",
                )


class UnmanagedSpan(Rule):
    id = "TEL002"
    name = "unmanaged-span"
    description = (
        "Spans must be context-managed: 'with TELEMETRY.span(...):' — a "
        "manually entered span leaks its record on every exception path "
        "and skews the histogram.  (Explicit record_span(...) with a "
        "measured duration is the sanctioned non-with form.)"
    )

    def check(self, module):
        with_items = set()
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    with_items.add(id(item.context_expr))
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if not name:
                continue
            parts = name.split(".")
            if len(parts) >= 2 and parts[-2] == "TELEMETRY" and parts[-1] == "span":
                if id(node) not in with_items:
                    yield Diagnostic(
                        module.path,
                        node.lineno,
                        node.col_offset,
                        self.id,
                        "TELEMETRY.span() used outside a with statement; "
                        "context-manage it (or use record_span with an "
                        "explicit duration)",
                    )


class AllocationOnDisabledPath(Rule):
    id = "TEL003"
    name = "allocation-on-disabled-path"
    description = (
        "No allocation-bearing telemetry calls on the disabled fast path: "
        "a mutator whose arguments build f-strings/dicts/lists pays that "
        "allocation even when the registry is disabled (the early-return "
        "is inside the callee) — guard the call site with "
        "TELEMETRY.enabled."
    )

    def check(self, module):
        for node in ast.walk(module.tree):
            mutator = _telemetry_call(node)
            if mutator is None:
                continue
            allocating = None
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, _ALLOCATING_NODES):
                        allocating = sub
                        break
                if allocating is not None:
                    break
            if allocating is None:
                continue
            if _is_guarded(node):
                continue
            kind = (
                "f-string"
                if isinstance(allocating, ast.JoinedStr)
                else type(allocating).__name__.lower()
            )
            yield Diagnostic(
                module.path,
                node.lineno,
                node.col_offset,
                self.id,
                f"TELEMETRY.{mutator}() builds a {kind} argument on an "
                "unguarded path — it allocates even with telemetry "
                "disabled; wrap the call in 'if TELEMETRY.enabled:'",
            )


def _health_call(node):
    """The emitter label when ``node`` is an optimization-health emission
    call — ``FLIGHT.record(...)`` (any qualification) or a storage
    ``record_health(...)`` — else None."""
    if not isinstance(node, ast.Call):
        return None
    name = dotted_name(node.func)
    if not name:
        return None
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] == "FLIGHT" and parts[-1] == "record":
        return "FLIGHT.record"
    if parts[-1] == "record_health":
        return "record_health"
    return None


class HealthEmissionOnDisabledPath(Rule):
    id = "TEL004"
    name = "health-emission-on-disabled-path"
    description = (
        "No allocation-bearing health/flight-record emissions on the "
        "disabled fast path: FLIGHT.record(...) and storage "
        "record_health(...) calls whose arguments build f-strings/dicts/"
        "lists allocate even when the recorder is off — guard the call "
        "site with FLIGHT.enabled (or TELEMETRY.enabled), same discipline "
        "as TEL003."
    )

    def check(self, module):
        for node in ast.walk(module.tree):
            emitter = _health_call(node)
            if emitter is None:
                continue
            allocating = None
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, _ALLOCATING_NODES):
                        allocating = sub
                        break
                if allocating is not None:
                    break
            if allocating is None:
                continue
            if _is_guarded(node):
                continue
            kind = (
                "f-string"
                if isinstance(allocating, ast.JoinedStr)
                else type(allocating).__name__.lower()
            )
            yield Diagnostic(
                module.path,
                node.lineno,
                node.col_offset,
                self.id,
                f"{emitter}() builds a {kind} argument on an unguarded "
                "path — it allocates even with the flight recorder "
                "disabled; wrap the call in 'if FLIGHT.enabled:'",
            )


#: Attribute names whose CALL marks a function as a wire-send path: the
#: socket send itself, the request/response exchange helpers, and the
#: gateway reply writer (``self.wfile.write``).
_WIRE_SEND_ATTRS = ("sendall",)
_WIRE_EXCHANGE_PREFIX = "_exchange"

#: Referenced names/attributes that count as touching the TraceContext
#: machinery (injecting into a payload, adopting off the wire, or stamping
#: a span's trace identity explicitly).
_CTX_NAME_MARKERS = frozenset(
    {
        "TraceContext",
        "current_trace_context",
        "set_trace_context",
        "trace_scope",
        "to_wire",
        "from_wire",
        "adopt_begin",
        "adopt_finish",
        "ctx",
    }
)
_CTX_KEYWORD_MARKERS = frozenset({"ctx", "span_ctx", "parent_ctx", "links", "root"})


def _is_wire_send_call(node):
    if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
        return False
    attr = node.func.attr
    if attr in _WIRE_SEND_ATTRS or attr.startswith(_WIRE_EXCHANGE_PREFIX):
        return True
    # The gateway reply writer: ...wfile.write(...)
    if attr == "write":
        receiver = dotted_name(node.func.value)
        return bool(receiver) and receiver.split(".")[-1] == "wfile"
    return False


def _is_span_call(node):
    """TELEMETRY.span(...) / any ``*.record_span(...)`` — the private
    server-side registries (``self._span_tel.record_span``) count too."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    if not name:
        return False
    parts = name.split(".")
    if parts[-1] == "record_span":
        return True
    return len(parts) >= 2 and parts[-2] == "TELEMETRY" and parts[-1] == "span"


class WireSpanWithoutTraceContext(Rule):
    id = "TEL005"
    name = "wire-span-without-trace-context"
    description = (
        "A wire-send path (.sendall / _exchange* / gateway wfile.write) "
        "that opens or records a span must inject or adopt the ambient "
        "TraceContext — otherwise the server side of the hop records "
        "orphan spans and `orion-tpu-torch trace --distributed` cannot join the "
        "processes (inject: payload['ctx'] = ctx.to_wire(); adopt: "
        "TraceContext.from_wire(...) / parent_ctx=...)."
    )

    def check(self, module):
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            has_wire_send = False
            span_calls = []
            touches_ctx = False
            for node in ast.walk(fn):
                if _is_wire_send_call(node):
                    has_wire_send = True
                if _is_span_call(node):
                    span_calls.append(node)
                    if any(
                        kw.arg in _CTX_KEYWORD_MARKERS for kw in node.keywords
                    ):
                        touches_ctx = True
                name = dotted_name(node) if isinstance(node, ast.Attribute) else None
                if isinstance(node, ast.Name) and node.id in _CTX_NAME_MARKERS:
                    touches_ctx = True
                elif name and any(
                    part in _CTX_NAME_MARKERS for part in name.split(".")
                ):
                    touches_ctx = True
            if has_wire_send and span_calls and not touches_ctx:
                for call in span_calls:
                    yield Diagnostic(
                        module.path,
                        call.lineno,
                        call.col_offset,
                        self.id,
                        "span on a wire-send path without TraceContext "
                        "injection/adoption — the cross-process trace "
                        "cannot join; inject the ambient context into the "
                        "payload (ctx.to_wire()) or adopt the wire ctx "
                        "(TraceContext.from_wire / parent_ctx=...)",
                    )


#: Severity strings a doctor rule may declare (mirrors
#: ``orion_tpu_torch.diagnosis.engine.SEVERITIES`` — kept literal here so the
#: lint engine never imports the diagnosis package it checks).
_DOCTOR_SEVERITIES = frozenset({"info", "warn", "critical"})


def _doctor_rule_class(node):
    """True when ``node`` is a ClassDef subclassing ``DoctorRule`` (any
    qualification — ``DoctorRule``, ``engine.DoctorRule``)."""
    if not isinstance(node, ast.ClassDef):
        return False
    for base in node.bases:
        name = dotted_name(base)
        if name and name.split(".")[-1] == "DoctorRule":
            return True
    return False


def _class_constant(node, attr):
    """The ast.Constant assigned to ``attr`` directly in the class body,
    or None (absent, or assigned a non-constant).  Both the plain and the
    annotated spelling count — ``severity: str = "critical"`` is as
    explicit a declaration as the bare assignment."""
    for stmt in node.body:
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = (stmt.target,)
            value = stmt.value
        else:
            continue
        for target in targets:
            if isinstance(target, ast.Name) and target.id == attr:
                return value if isinstance(value, ast.Constant) else None
    return None


class DoctorRuleDiscipline(Rule):
    id = "TEL006"
    name = "doctor-rule-discipline"
    description = (
        "Every DoctorRule subclass must DECLARE its severity (info|warn|"
        "critical) and a non-empty runbook anchor as class constants — a "
        "finding the report cannot rank, or whose runbook link resolves "
        "nowhere, is noise — and its evaluate()/methods must not build "
        "per-call computed metric keys (f-strings, concatenation): the "
        "per-rule gauge name is minted once at class definition, the same "
        "discipline TEL001 enforces in loops."
    )

    def check(self, module):
        for node in ast.walk(module.tree):
            if not _doctor_rule_class(node):
                continue
            severity = _class_constant(node, "severity")
            if severity is None or severity.value not in _DOCTOR_SEVERITIES:
                yield Diagnostic(
                    module.path,
                    node.lineno,
                    node.col_offset,
                    self.id,
                    f"doctor rule {node.name} must declare "
                    "severity = 'info'|'warn'|'critical' as a class "
                    "constant (inherited or computed severities are not "
                    "declarations)",
                )
            runbook = _class_constant(node, "runbook")
            if runbook is None or not (
                isinstance(runbook.value, str) and runbook.value
            ):
                yield Diagnostic(
                    module.path,
                    node.lineno,
                    node.col_offset,
                    self.id,
                    f"doctor rule {node.name} must declare a non-empty "
                    "runbook anchor (runbook = 'dxNNN-rule-name', resolved "
                    "into docs/monitoring.md)",
                )
            for fn in node.body:
                if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                for call in ast.walk(fn):
                    mutator = _telemetry_call(call)
                    if mutator is None or not call.args:
                        continue
                    key = call.args[0]
                    if isinstance(key, (ast.Constant, ast.Name, ast.Attribute)):
                        continue
                    yield Diagnostic(
                        module.path,
                        call.lineno,
                        call.col_offset,
                        self.id,
                        f"TELEMETRY.{mutator}() with a computed metric key "
                        f"inside doctor rule {node.name}.{fn.name}() — "
                        "mint the name once at class definition "
                        "(gauge_name) instead of per evaluation",
                    )


TELEMETRY_RULES = (
    DynamicKeyInLoop,
    UnmanagedSpan,
    AllocationOnDisabledPath,
    HealthEmissionOnDisabledPath,
    WireSpanWithoutTraceContext,
    DoctorRuleDiscipline,
)
