"""Compiler-plane doctor rules (``DX05x``; port of
``orion_tpu/diagnosis/rules_compiler.py``): capture-storm rate, recapture
attribution coverage, prewarm correctness, and device-memory headroom.

These read the signals :mod:`orion_tpu_torch.compiler_plane` emits — the
``cuda_graph.captures`` counter, the ``cuda_graph.recaptures.attributed``
/ ``cuda_graph.recaptures.prewarm_covered`` attribution counters, and the
``compiler.*`` gauges /metrics publishes — so every rule is gated on the
compiler plane actually being active (``cuda_graph.captures > 0`` where
it matters): an old snapshot from a build without the plane must stay
quiet, not fire "unattributed" over counters that never existed.  The
port's counter names stand where the reference reads ``jax.compiles``,
``jax.retraces`` and its attribution counters (the table in
``compiler_plane``'s docstring); thresholds, ids, names and runbook
anchors are the reference's.
"""

from orion_tpu_torch.diagnosis.engine import DoctorRule


class CaptureStorm(DoctorRule):
    id = "DX050"
    name = "compile-storm"
    severity = "warn"
    runbook = "dx050-compile-storm"
    description = (
        "cuda_graph.captures keeping pace with rounds: the process is "
        "paying CUDA-graph captures continuously (signature churn, or a "
        "prewarm loop re-capturing the same buckets) instead of a handful "
        "of captures up front."
    )

    #: A healthy hunt captures each signature once (initial signatures +
    #: pow-2 bucket growths, prewarms included); a storm captures per
    #: ROUND.  Both bars must hold, exactly like DX001.
    MIN_ROUNDS = 10
    MIN_COMPILES = 20
    COMPILES_PER_ROUND = 1.0

    def evaluate(self, snapshot):
        rounds = snapshot.rounds()
        captures = snapshot.counter("cuda_graph.captures")
        if rounds >= self.MIN_ROUNDS and captures >= max(
            self.MIN_COMPILES, self.COMPILES_PER_ROUND * rounds
        ):
            yield self.finding(
                f"{captures} CUDA-graph captures over {rounds} rounds "
                "(healthy: one per signature) — check `orion-tpu-torch "
                "profile` for which static is churning",
                value=captures,
            )


class UnattributedRecapture(DoctorRule):
    id = "DX051"
    name = "unattributed-retrace"
    severity = "warn"
    runbook = "dx051-unattributed-retrace"
    description = (
        "cuda_graph.recaptures counted without a matching compiler-plane "
        "attribution: some capture site books recaptures outside the "
        "CompileRegistry, so `flight.cuda_graph.recapture` cannot name the "
        "changed static — the self-diagnosing contract is broken."
    )

    def evaluate(self, snapshot):
        # Gate on the plane being active: a snapshot from a build without
        # the registry has recaptures but no captures counter at all —
        # that is missing instrumentation, not an attribution bug.
        if not snapshot.counter("cuda_graph.captures"):
            return
        recaptures = snapshot.counter("cuda_graph.recaptures")
        attributed = snapshot.counter("cuda_graph.recaptures.attributed")
        if recaptures > attributed:
            yield self.finding(
                f"{recaptures - attributed} of {recaptures} recaptures have "
                "no compiler-plane attribution — a capture site counts "
                "cuda_graph.recaptures without CompileRegistry.record_retrace",
                value=recaptures - attributed,
            )


class PrewarmCoveredRecapture(DoctorRule):
    id = "DX052"
    name = "prewarm-covered-retrace"
    severity = "critical"
    runbook = "dx052-prewarm-covered-retrace"
    description = (
        "a synchronous recapture landed at a signature a completed prewarm "
        "already captured: the prewarm built a graph the real round then "
        "could not reuse — a prewarm bug (statics drift between the "
        "prewarm's plan and the round's), paying both the prewarm AND the "
        "stall."
    )

    def evaluate(self, snapshot):
        covered = snapshot.counter("cuda_graph.recaptures.prewarm_covered")
        if covered:
            yield self.finding(
                f"{covered} recapture(s) at signatures prewarm had already "
                "captured — the prewarm's graph is not the step-graph cache "
                "entry the round looks up; diff the "
                "`flight.cuda_graph.recapture` signature against the "
                "prewarm's in `orion-tpu-torch profile`",
                value=covered,
            )


class HbmFootprintNearCapacity(DoctorRule):
    id = "DX053"
    name = "hbm-footprint-near-capacity"
    severity = "warn"
    runbook = "dx053-hbm-footprint-near-capacity"
    description = (
        "the largest captured round's footprint (its graph pool and static "
        "inputs) is within the alert fraction of the card's memory: the "
        "next q or history-bucket growth may run out of device memory "
        "instead of capturing."
    )

    #: Fire when the worst plan pins >= this fraction of device memory —
    #: the next pow-2 bucket growth roughly doubles the dominant buffers.
    CAPACITY_FRACTION = 0.8

    def evaluate(self, snapshot):
        footprint = snapshot.gauge("compiler.hbm_bytes_max")
        capacity = snapshot.gauge("compiler.hbm_capacity_bytes")
        if not footprint or not capacity:
            return
        ratio = float(footprint) / float(capacity)
        if ratio >= self.CAPACITY_FRACTION:
            yield self.finding(
                f"largest captured round's footprint {footprint / 1e9:.2f}GB "
                f"is {ratio:.0%} of the {capacity / 1e9:.2f}GB device memory "
                f"(alert at {self.CAPACITY_FRACTION:.0%}) — the predicted "
                "memory-bound q is in `orion-tpu-torch profile`; cap q or "
                "the fit bucket before the next growth",
                value=ratio,
            )


COMPILER_RULES = (
    CaptureStorm,
    UnattributedRecapture,
    PrewarmCoveredRecapture,
    HbmFootprintNearCapacity,
)
