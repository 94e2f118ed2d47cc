"""Static and runtime analysis of the port's own invariants (port of
``orion_tpu/analysis``; ``orion-tpu-torch lint``).

Five rule families over the code's AST, each pinning a convention the
runtime cannot check for itself:

- ``JIT*``  — the GP round stays capturable as a CUDA graph: no host sync,
  no branch on a tensor value and no Python number in a tensor slot in
  anything a capture records (``jit_rules``, rewritten for torch);
- ``STO*``  — storage protocol ops ride the unified retry policy with an
  explicit applied-or-not mode, and wire errors carry ``maybe_applied``
  (``storage_rules``);
- ``TEL*``  — telemetry stays allocation-free when disabled and cheap when
  enabled, and the doctor's rules declare their severity and runbook
  (``telemetry_rules``);
- ``LCK*``  — the static lock graph stays acyclic and shared attributes
  stay behind their lock (``lock_rules``);
- ``PERF*`` — the producer's round stays vectorized, plan prep rides its
  cache, and the compiler plane's introspection stays cold
  (``perf_rules``).

``run_lint(paths)`` is the whole API (``engine``); the self-lint test and
``chip_smoke.py``'s ``lint`` phase call it directly.

The dynamic half lives in ``orion_tpu_torch.analysis.sanitizer``
(``orion-tpu-torch tsan``): instrumented lock shims, vector-clock race
detection, and the static↔dynamic cross-check that feeds runtime-observed
lock edges back into the ``LCK`` graph as ``LCK003`` findings.

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
