"""Optimizer-health doctor rules (``DX04x``; port of
``orion_tpu/diagnosis/rules_gp.py``) over the per-round health-record
series (``orion_tpu_torch.health``): the records of GP rounds on the card,
whose pool posterior runs ``fused_gram``, and the ``mem_bytes`` stamp
``devmem`` puts into each.

These are the signals ``orion-tpu-torch top`` renders raw and an experienced
operator reads by eye: a NaN marginal likelihood, lengthscales pinned at
the clip floor, an EI surface gone flat, a q-batch that stopped being
diverse, an incumbent that stopped moving, device memory that only goes
up.  Trend rules use the shared robust-slope detector so one noisy round
cannot fire a finding.
"""

import math

from orion_tpu_torch.diagnosis.engine import DoctorRule
from orion_tpu_torch.diagnosis.trend import relative_change, robust_slope


def _bad(value):
    """NaN/inf guard over a float-ish health field."""
    try:
        value = float(value)
    except (TypeError, ValueError):
        return False
    return math.isnan(value) or math.isinf(value)


class GPDegenerate(DoctorRule):
    id = "DX040"
    name = "gp-degenerate"
    severity = "critical"
    runbook = "dx040-gp-degenerate"
    description = (
        "the GP fit itself died: NaN/inf marginal likelihood or noise, or "
        "every lengthscale collapsed to the clip floor — suggestions are "
        "now draws from a broken model, not a posterior."
    )

    #: All lengthscales below this = the kernel treats EVERY dimension as
    #: pure noise (the per-dim clip floor is 1e-3-scale).
    LS_COLLAPSE = 1e-3

    def evaluate(self, snapshot):
        latest = snapshot.latest_health()
        if not latest:
            return
        for field in ("gp_mll", "gp_noise"):
            if _bad(latest.get(field)):
                yield self.finding(
                    f"latest health record carries a non-finite {field} "
                    f"({latest.get(field)}) — the GP fit has diverged; "
                    "check the objective scale and the copula transform",
                    value=latest.get("round"),
                )
                return
        ls_max = latest.get("gp_ls_max")
        if ls_max is not None and float(ls_max) < self.LS_COLLAPSE:
            yield self.finding(
                f"all fitted lengthscales collapsed below "
                f"{self.LS_COLLAPSE:g} (max {float(ls_max):.2g}) — the "
                "model treats every dimension as noise",
                value=float(ls_max),
            )


class EIFlatline(DoctorRule):
    id = "DX041"
    name = "ei-flatline"
    severity = "warn"
    runbook = "dx041-ei-flatline"
    description = (
        "expected improvement has been ~zero over the whole candidate pool "
        "for several consecutive rounds: either the hunt converged, or the "
        "fit thinks the incumbent is unattainable — both mean new rounds "
        "buy nothing."
    )

    WINDOW = 4
    EI_FLOOR = 1e-8

    def evaluate(self, snapshot):
        ei = snapshot.series("acq_ei_max", last=self.WINDOW)
        if len(ei) < self.WINDOW:
            return
        if all(float(v) < self.EI_FLOOR for v in ei):
            yield self.finding(
                f"acq_ei_max < {self.EI_FLOOR:g} for the last "
                f"{self.WINDOW} rounds — acquisition flattened (converged, "
                "or the GP fit is dead: cross-check DX040/DX043)",
                value=float(ei[-1]),
            )


class QDedupCollapse(DoctorRule):
    id = "DX042"
    name = "q-dedup-collapse"
    severity = "warn"
    runbook = "dx042-q-dedup-collapse"
    description = (
        "the selected q-batch keeps containing mostly duplicate rows: the "
        "candidate generator collapsed onto too few points — most of the "
        "batch's device and evaluation budget is wasted."
    )

    WINDOW = 3
    UNIQUE_FLOOR = 0.5

    def evaluate(self, snapshot):
        fracs = snapshot.series("q_unique_frac", last=self.WINDOW)
        if len(fracs) < self.WINDOW:
            return
        ordered = sorted(float(v) for v in fracs)
        median = ordered[len(ordered) // 2]
        if median < self.UNIQUE_FLOOR:
            yield self.finding(
                f"median q-batch unique fraction {median:.2f} < "
                f"{self.UNIQUE_FLOOR:g} over the last {self.WINDOW} rounds "
                "— the dedup fill is running out of distinct candidates",
                value=median,
            )


class RegretStagnation(DoctorRule):
    id = "DX043"
    name = "regret-stagnation"
    severity = "info"
    runbook = "dx043-regret-stagnation"
    description = (
        "the incumbent has not moved for many rounds: converged, stuck in "
        "a basin, or the optimizer stopped learning — info, because a "
        "finished hunt looks exactly like this on purpose."
    )

    MIN_RECORDS = 10
    #: Relative improvement of best_y across the trailing half-window
    #: below this = stagnant.
    REL_IMPROVEMENT = 1e-4

    def evaluate(self, snapshot):
        best = snapshot.series("best_y")
        if len(best) < self.MIN_RECORDS:
            return
        window = [float(v) for v in best[len(best) // 2:]]
        first, last = window[0], window[-1]
        improvement = (first - last) / max(abs(first), 1e-12)
        if improvement < self.REL_IMPROVEMENT:
            yield self.finding(
                f"incumbent unchanged over the last {len(window)} recorded "
                f"rounds (relative improvement {improvement:.2g}) — "
                "converged or stuck; cross-check DX041 for a flat EI",
                value=improvement,
            )


class MemoryGrowth(DoctorRule):
    id = "DX044"
    name = "memory-growth"
    severity = "warn"
    runbook = "dx044-memory-growth"
    description = (
        "device-resident bytes grow steadily round over round, well past "
        "what history growth explains: leaked buffers (or an unbounded "
        "cache) will eventually OOM the accelerator."
    )

    MIN_RECORDS = 12
    #: Relative growth across the window.  Pow-2 history growth doubles at
    #: most once per window at steady state; 50% SUSTAINED with a positive
    #: robust slope is a leak signature.
    REL_GROWTH = 0.5

    def evaluate(self, snapshot):
        mem = snapshot.series("mem_bytes", last=2 * self.MIN_RECORDS)
        if len(mem) < self.MIN_RECORDS:
            return
        if robust_slope(mem) > 0 and relative_change(mem) >= self.REL_GROWTH:
            yield self.finding(
                f"device-live bytes grew {float(mem[0]) / 1e6:.1f} -> "
                f"{float(mem[-1]) / 1e6:.1f} MB across {len(mem)} rounds "
                "(sustained positive trend) — check memory.* gauges for "
                "which pool is growing",
                value=float(mem[-1]),
            )


GP_RULES = (
    GPDegenerate,
    EIFlatline,
    QDedupCollapse,
    RegretStagnation,
    MemoryGrowth,
)
