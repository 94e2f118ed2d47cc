"""Storage invariant auditor: the cross-trial consistency oracle (port of
``orion_tpu/storage/audit.py``).

The coordination protocol rests on a handful of invariants no single
operation checks end to end — each op is individually atomic, but a
crashed worker, a mid-batch fault, or a buggy migration can still leave
the *collection* in a state the optimizer silently mis-learns from.
This module walks an experiment's raw trial documents and reports every
violation of:

- **unique identity**: no duplicate ``_id``s, and no two distinct live
  trials sitting on the same parameter point (the deterministic
  md5-of-params identity + unique index are supposed to make that
  impossible; an auditor that trusts the mechanism it audits is
  useless after a ``db copy`` or a hand-edit);
- **status machine sanity**: every status is a known one, ``reserved``
  trials carry the ``heartbeat``/``start_time`` the pacemaker and
  lost-trial sweep key on;
- **completed ⇒ results**: a ``completed`` trial has a results list with
  an objective entry — a completed trial without one is a LOST
  observation (the algorithm can never learn from it);
- **no orphaned reservations**: no trial has sat ``reserved`` with a
  heartbeat older than the sweep threshold — the state a dead worker
  leaves behind when the recovery sweep is not running.

Surfaced as ``orion-tpu-torch audit`` (cli/audit.py) and as
``Experiment.audit()``: an experiment driven to completion must audit
clean — zero duplicated trials, zero lost observations.
"""

import time

from orion_tpu_torch.core.trial import ALL_STATUSES, Trial

#: Default orphaned-reservation threshold when the caller has no
#: experiment-level heartbeat to hand (matches DEFAULT_HEARTBEAT).
DEFAULT_LOST_TIMEOUT = 120.0


class AuditReport:
    """Violations + collection stats for one audited experiment."""

    def __init__(self, experiment_id, n_trials, status_counts, violations):
        self.experiment_id = experiment_id
        self.n_trials = n_trials
        self.status_counts = dict(status_counts)
        self.violations = list(violations)

    @property
    def ok(self):
        return not self.violations

    def summary(self):
        lines = [
            f"experiment {self.experiment_id}: {self.n_trials} trials "
            + ", ".join(
                f"{n} {status}"
                # str() key: a malformed doc's status may be None or any
                # type — that is a finding to print, not a sort crash.
                for status, n in sorted(
                    self.status_counts.items(), key=lambda kv: str(kv[0])
                )
            )
        ]
        if self.ok:
            lines.append("audit: OK (no invariant violations)")
        else:
            lines.append(f"audit: {len(self.violations)} violation(s)")
            for v in self.violations:
                lines.append(f"  [{v['check']}] trial {v['trial']}: {v['message']}")
        return "\n".join(lines)


def _violation(check, trial_id, message):
    return {"check": check, "trial": trial_id, "message": message}


def _trial_docs(storage, exp_id):
    """Raw trial documents — raw, not Trial objects, so a malformed doc is
    a *finding*, never a crash that hides the rest of the audit."""
    read_docs = getattr(storage, "read_trial_docs", None)
    if read_docs is not None:
        return read_docs(exp_id)
    return [t.to_dict() for t in storage.fetch_trials(uid=exp_id)]


def audit_experiment(storage, experiment, lost_timeout=None, now=None):
    """Audit one experiment's trials; returns an :class:`AuditReport`.

    ``experiment`` may be an Experiment (its ``heartbeat`` supplies the
    orphaned-reservation threshold), a config dict, or a bare id.
    ``lost_timeout`` overrides the threshold; ``now`` pins the clock for
    deterministic tests.
    """
    exp_id = getattr(experiment, "id", None)
    if exp_id is None:
        exp_id = experiment["_id"] if isinstance(experiment, dict) else experiment
    if lost_timeout is None:
        if isinstance(experiment, dict):
            lost_timeout = experiment.get("heartbeat") or DEFAULT_LOST_TIMEOUT
        else:
            lost_timeout = getattr(experiment, "heartbeat", DEFAULT_LOST_TIMEOUT)
    now = time.time() if now is None else now

    docs = _trial_docs(storage, exp_id)
    violations = []
    status_counts = {}
    seen_ids = set()
    point_owner = {}  # hash_params -> first trial id on that point

    for doc in docs:
        tid = doc.get("_id")
        status = doc.get("status")
        status_counts[status] = status_counts.get(status, 0) + 1

        if tid in seen_ids:
            violations.append(
                _violation("unique-id", tid, "duplicate trial id in storage")
            )
        seen_ids.add(tid)

        if status not in ALL_STATUSES:
            violations.append(
                _violation("status", tid, f"unknown status {status!r}")
            )

        point = Trial.compute_id(doc.get("experiment"), doc.get("params") or {})
        other = point_owner.setdefault(point, tid)
        if other != tid:
            violations.append(
                _violation(
                    "duplicate-point",
                    tid,
                    f"same parameter point as trial {other} — duplicated trial",
                )
            )

        if status == "reserved":
            heartbeat = doc.get("heartbeat")
            if heartbeat is None:
                violations.append(
                    _violation(
                        "heartbeat", tid, "reserved trial without a heartbeat"
                    )
                )
            elif now - heartbeat > lost_timeout:
                violations.append(
                    _violation(
                        "orphaned-reservation",
                        tid,
                        f"heartbeat is {now - heartbeat:.1f}s stale "
                        f"(sweep threshold {lost_timeout:.1f}s) — the "
                        "lost-trial sweep is not recovering it",
                    )
                )
            if doc.get("start_time") is None:
                violations.append(
                    _violation(
                        "heartbeat", tid, "reserved trial without a start_time"
                    )
                )

        if status == "completed":
            results = doc.get("results") or []
            has_objective = any(
                isinstance(r, dict) and r.get("type") == "objective"
                for r in results
            )
            if not has_objective:
                violations.append(
                    _violation(
                        "lost-observation",
                        tid,
                        "completed trial has no objective result — the "
                        "observation is lost to the algorithm",
                    )
                )
            if doc.get("end_time") is None:
                violations.append(
                    _violation("lost-observation", tid, "completed trial has no end_time")
                )

    return AuditReport(exp_id, len(docs), status_counts, violations)


def audit_storage(storage, lost_timeout=None, now=None):
    """Audit every experiment in the storage; returns a list of reports."""
    return [
        audit_experiment(
            storage, doc, lost_timeout=lost_timeout, now=now
        )
        for doc in storage.fetch_experiments({})
    ]
