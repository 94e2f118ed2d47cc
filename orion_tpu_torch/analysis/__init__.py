"""Static and runtime concurrency analysis for the port (port of
``orion_tpu/analysis``).

- ``LCK*`` — the static lock graph stays acyclic and shared attributes
  stay behind their lock (``lock_rules``), run through the rule engine
  (``engine``; ``run_lint(paths)`` is the whole API).  The reference's
  other rule families are ROADMAP queue A item 9b.
- The dynamic half lives in ``orion_tpu_torch.analysis.sanitizer``
  (``orion-tpu-torch tsan``): instrumented lock shims, vector-clock race
  detection, and the static↔dynamic cross-check that feeds
  runtime-observed lock edges back into the ``LCK`` graph as ``LCK003``
  findings.

The package facade is LAZY (PEP 562): ``sanitizer`` is stdlib-only and
imported at module scope by the telemetry/health/storage hot paths for
their cell annotations — an eager engine import here would tax every
process start for a lint facility most processes never run.
"""

__all__ = [
    "Diagnostic",
    "Rule",
    "default_rules",
    "format_human",
    "format_json",
    "rule_catalog",
    "run_lint",
]


def __getattr__(name):
    if name in __all__:
        from orion_tpu_torch.analysis import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
