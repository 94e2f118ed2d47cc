"""Self-diagnosis for the port (``orion-tpu-torch doctor``; port of
``orion_tpu/diagnosis``).

A declarative rule engine over every telemetry plane the stack already
emits: merged counters/gauges/histograms, the per-round health-record
series, flight events, replication probes, and worker staleness — joined
into one :class:`~orion_tpu_torch.diagnosis.snapshot.Snapshot` and evaluated by
a catalog of :class:`~orion_tpu_torch.diagnosis.engine.DoctorRule`s, each with
a declared severity and a runbook anchor into ``docs/monitoring.md``.

Surfaces: the ``orion-tpu-torch doctor`` CLI (exit 0 healthy / 1
critical, ``--watch`` with alert dedup), ``flight.alert`` events and the
``orion_tpu_doctor_findings{rule,severity}`` gauge family, the /healthz
doctor block on the worker metrics server, the flight dump's header,
``info`` and ``top``, and an optional in-process watchdog in ``workon``
(``doctor_interval:``).

The facade is LAZY (PEP 562), same rationale as
``orion_tpu_torch.analysis``:
``metrics.py`` imports this package on the scrape path only to label the
doctor gauge family — an eager rules import would tax every process
start for a facility most processes never run.
"""

__all__ = [
    "DoctorReport",
    "DoctorRule",
    "Finding",
    "Snapshot",
    "collect_snapshot",
    "default_rules",
    "doctor_catalog",
    "doctor_summary",
    "local_snapshot",
    "publish_report",
    "rule_severities",
    "run_rules",
]

_HOMES = {
    "DoctorReport": "engine",
    "DoctorRule": "engine",
    "Finding": "engine",
    "default_rules": "engine",
    "doctor_catalog": "engine",
    "rule_severities": "engine",
    "run_rules": "engine",
    "Snapshot": "snapshot",
    "collect_snapshot": "snapshot",
    "local_snapshot": "snapshot",
    "doctor_summary": "watch",
    "publish_report": "watch",
}


def __getattr__(name):
    home = _HOMES.get(name)
    if home is not None:
        import importlib

        module = importlib.import_module(f"orion_tpu_torch.diagnosis.{home}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
