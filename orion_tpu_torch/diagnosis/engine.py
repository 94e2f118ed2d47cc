"""Rule-engine core for ``orion-tpu-torch doctor`` (port of
``orion_tpu/diagnosis/engine.py``).

The stack emits every production signal a hunt can produce — telemetry
counters/gauges/histograms, per-round health records and flight events,
/metrics gauges and device-memory accounting, replication lag and epochs
— but nothing *interprets* them: an operator must already know that
``cuda_graph.recaptures`` climbing means a signature fork, or that a flat
EI plus collapsed lengthscales means the GP died.  This engine turns those signal planes into severity-ranked
findings with runbook links, mirroring the ``analysis/`` lint-rule
architecture: a :class:`DoctorRule` protocol, a registry, and one
``run_rules`` entry point over a joined :class:`~orion_tpu_torch.diagnosis
.snapshot.Snapshot`.

Contracts every rule keeps (the reference's lint rule ``TEL006`` checks
them; the port's TEL family is ROADMAP queue A item 9b):

- ``severity`` is declared explicitly (``info`` | ``warn`` | ``critical``)
  — a finding's severity is the rule's, never computed per call;
- ``runbook`` names an anchor into ``docs/monitoring.md``'s "Diagnosis &
  runbook" section (the registry-completeness test resolves every anchor);
- ``evaluate()`` never builds per-call computed metric keys — the
  per-rule gauge name (``doctor.findings.<ID>``) is minted ONCE at class
  definition, so publishing allocates no metric name per pass.

Rule ids live in the ``DX*`` family: ``DX0xx`` systems (``rules_system``),
``DX02x`` storage/replication (``rules_storage``), ``DX04x`` optimizer
health (``rules_gp``), ``DX05x`` compiler plane (``rules_compiler``).
"""

import json

#: Severity ladder, least to most urgent.  FIXED: the /metrics exposition
#: labels findings with these exact strings.
SEVERITIES = ("info", "warn", "critical")

_SEVERITY_RANK = {name: rank for rank, name in enumerate(SEVERITIES)}

#: Documentation page every runbook anchor resolves into.
RUNBOOK_PAGE = "docs/monitoring.md"


class Finding:
    """One diagnosis: rule identity, severity, human message, runbook
    link, and an optional numeric evidence value (what the rule measured —
    the trend slope, the counter total).

    ``subject`` names WHAT the finding is about when one rule can fire
    for several independent subjects (shard 0 vs shard 2, the queue vs
    the backpressure counter).  The watch-mode alert dedup keys on
    ``(rule_id, subject)`` — never on the message, whose embedded live
    numbers change every pass while the condition persists."""

    __slots__ = (
        "rule_id", "name", "severity", "message", "runbook", "value", "subject"
    )

    def __init__(self, rule, message, value=None, subject=None):
        self.rule_id = rule.id
        self.name = rule.name
        self.severity = rule.severity
        self.runbook = rule.runbook
        self.message = message
        self.value = value
        self.subject = subject

    @property
    def fingerprint(self):
        """The alert-dedup identity of this finding."""
        return (self.rule_id, self.subject)

    def format(self):
        return (
            f"[{self.severity.upper():>8}] {self.rule_id} {self.name}: "
            f"{self.message}  (runbook: {RUNBOOK_PAGE}#{self.runbook})"
        )

    def to_dict(self):
        out = {
            "rule": self.rule_id,
            "name": self.name,
            "severity": self.severity,
            "message": self.message,
            "runbook": f"{RUNBOOK_PAGE}#{self.runbook}",
        }
        if self.value is not None:
            out["value"] = self.value
        return out

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<Finding {self.format()}>"


class DoctorRule:
    """Base class for diagnosis rules.

    Subclasses declare ``id``/``name``/``severity``/``runbook``/
    ``description`` and implement ``evaluate(snapshot)`` yielding
    :class:`Finding`s.  One instance evaluates one snapshot; instances are
    created fresh per :func:`run_rules` call, so rules need no reset
    discipline.  ``gauge_name`` is minted once per class here — evaluate
    bodies must never compute metric keys."""

    id = "DX000"
    name = "abstract"
    severity = "warn"
    runbook = ""
    description = ""
    #: The per-rule findings gauge (``orion_tpu_doctor_findings{rule,
    #: severity}`` on the /metrics plane); set by ``__init_subclass__``.
    gauge_name = "doctor.findings.DX000"

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls.gauge_name = "doctor.findings." + cls.id

    def evaluate(self, snapshot):
        """Yield Findings for one snapshot."""
        return ()

    def finding(self, message, value=None, subject=None):
        return Finding(self, message, value=value, subject=subject)


def default_rules():
    """Fresh instances of every registered rule, validated: a rule whose
    severity or runbook anchor is missing would ship findings the report
    cannot rank or the operator cannot act on — refuse at registration."""
    from orion_tpu_torch.diagnosis.rules_compiler import COMPILER_RULES
    from orion_tpu_torch.diagnosis.rules_gp import GP_RULES
    from orion_tpu_torch.diagnosis.rules_storage import STORAGE_RULES
    from orion_tpu_torch.diagnosis.rules_system import SYSTEM_RULES

    rules = []
    for family in (SYSTEM_RULES, STORAGE_RULES, GP_RULES, COMPILER_RULES):
        for cls in family:
            if cls.severity not in SEVERITIES:
                raise ValueError(
                    f"doctor rule {cls.id} declares unknown severity "
                    f"{cls.severity!r} (must be one of {SEVERITIES})"
                )
            if not cls.runbook:
                raise ValueError(
                    f"doctor rule {cls.id} declares no runbook anchor"
                )
            rules.append(cls())
    return rules


def doctor_catalog():
    """(id, name, severity, runbook, description) for every registered
    rule — docs, ``doctor --list-rules``, and the completeness scan."""
    return [
        (r.id, r.name, r.severity, r.runbook, r.description)
        for r in default_rules()
    ]


def rule_severities():
    """id -> severity for every registered rule PLUS the engine's
    broken-rule marker (the /metrics exposition labels the
    ``orion_tpu_doctor_findings`` family with it)."""
    out = {r.id: r.severity for r in default_rules()}
    out[_BROKEN_RULE.id] = _BROKEN_RULE.severity
    return out


class DoctorReport:
    """The outcome of one diagnosis pass: findings (most severe first),
    per-rule counts (zeros included, so publishing clears resolved
    findings), and the status/exit-code contract (``critical`` -> 1)."""

    def __init__(self, findings, rules):
        self.findings = sorted(
            findings,
            key=lambda f: (-_SEVERITY_RANK.get(f.severity, 0), f.rule_id),
        )
        # The engine's broken-rule marker publishes like any rule: a rule
        # crashing in a production watchdog is exactly the condition a
        # scraper must be able to alert on.
        counts = {rule.id: 0 for rule in rules}
        counts.setdefault(_BROKEN_RULE.id, 0)
        for finding in self.findings:
            counts[finding.rule_id] = counts.get(finding.rule_id, 0) + 1
        self.rule_counts = counts
        #: rule id -> its findings gauge name, precomputed by the classes.
        self.gauge_names = {rule.id: rule.gauge_name for rule in rules}
        self.gauge_names.setdefault(_BROKEN_RULE.id, _BROKEN_RULE.gauge_name)

    def count(self, severity):
        return sum(1 for f in self.findings if f.severity == severity)

    @property
    def status(self):
        if self.count("critical"):
            return "critical"
        if self.count("warn"):
            return "warn"
        return "ok"

    @property
    def exit_code(self):
        """The automation contract: 0 healthy (warns included — they are
        advice, not pages), 1 on any critical finding."""
        return 1 if self.count("critical") else 0

    def summary(self):
        """The /healthz doctor block: status + severity counts."""
        return {
            "status": self.status,
            "critical": self.count("critical"),
            "warn": self.count("warn"),
            "info": self.count("info"),
        }

    def to_dict(self):
        return {
            **self.summary(),
            "findings": [f.to_dict() for f in self.findings],
        }

    def format_human(self, label=None):
        head = f"orion-tpu-torch doctor — {label}" if label else "orion-tpu-torch doctor"
        lines = [head]
        if not self.findings:
            lines.append("healthy: no findings")
        for finding in self.findings:
            lines.append(finding.format())
        counts = self.summary()
        lines.append(
            f"status: {counts['status']}  "
            f"(critical: {counts['critical']}, warn: {counts['warn']}, "
            f"info: {counts['info']})"
        )
        return "\n".join(lines)

    def format_json(self):
        return json.dumps(self.to_dict())


def run_rules(snapshot, rules=None):
    """Evaluate every rule over ``snapshot`` and return a
    :class:`DoctorReport`.  A single misbehaving rule must not take down
    the diagnosis pass (the doctor may run inside a worker thread), so
    per-rule exceptions degrade to an engine ``warn`` finding naming the
    rule instead of raising."""
    if rules is None:
        rules = default_rules()
    findings = []
    for rule in rules:
        try:
            findings.extend(rule.evaluate(snapshot))
        except Exception as exc:  # pragma: no cover - defensive
            findings.append(
                Finding(
                    _BROKEN_RULE,
                    f"rule {rule.id} ({rule.name}) crashed during "
                    f"evaluation: {type(exc).__name__}: {exc}",
                )
            )
    return DoctorReport(findings, rules)


class _BrokenRuleMarker(DoctorRule):
    """Identity the engine reports a crashing rule under — itself a warn
    (the diagnosis pass is degraded, not the system)."""

    id = "DX999"
    name = "broken-rule"
    severity = "warn"
    runbook = "dx999-broken-rule"
    description = "a registered doctor rule raised during evaluation"


_BROKEN_RULE = _BrokenRuleMarker()
