"""Multi-seed regret-trajectory regression gate (a copy of
``orion_tpu/benchmarks/regret_gate.py``, pure Python, for the port).

The bench's single-seed regret anchor cannot pin optimizer-quality drift:
Hartmann6 under the default TuRBO config has a **bimodal** seed
distribution (lucky seeds descend into the global basin, regret ~0.01;
unlucky seeds converge in the second-best basin, regret ~0.13–0.20 — see
``BENCH_SEEDS.json`` and docs/performance.md), so any code change that
perturbs the trajectory bit-stream re-rolls which basin seed 0 lands in
and the headline "regret" jumps by 10x with no real regression.  That is
exactly what the r02–r05 drift was (0.0148 → 0.1408 → 0.1628: all draws
from one stable distribution).

This gate replaces anchor-parity with a statistical comparison of the
FULL regret distribution across seeds:

- run the bench regret scenario for N seeds, recording the whole
  incumbent-regret curve per seed;
- compare against the committed baseline (``BENCH_REGRET_BASELINE.json``)
  with a one-sided **Mann–Whitney U** test (rank-based: scale-free,
  robust to the bimodality) on BOTH the final regrets and the curve AUCs
  (mean log-regret over rounds — catches "gets there eventually but much
  slower" regressions the final value hides);
- corroborate with a **bootstrap** confidence interval on the median
  shift, and require a minimum relative effect — five seeds of pure noise
  must not fail CI.

The gate FAILS only when the regression is statistically significant
(p < alpha) AND the bootstrap CI excludes zero AND the median worsening
exceeds ``min_rel_effect`` — all three, because with 5-vs-5 seeds any
single criterion alone is too twitchy for a hard CI gate.  Pure python +
math (no scipy): the normal-approximation U test with tie correction is
deterministic and exact enough at these sample sizes.
"""

import json
import math
import random

#: Defaults shared by bench.py and the unit tests.
DEFAULT_ALPHA = 0.05
DEFAULT_MIN_REL_EFFECT = 0.25
EPS = 1e-12


def _rankdata(values):
    """Average ranks (1-based) with ties sharing their mean rank."""
    order = sorted(range(len(values)), key=lambda i: values[i])
    ranks = [0.0] * len(values)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and values[order[j + 1]] == values[order[i]]:
            j += 1
        mean_rank = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[order[k]] = mean_rank
        i = j + 1
    return ranks


def mann_whitney_u(current, baseline):
    """One-sided Mann–Whitney U: ``p`` small means ``current`` tends to be
    LARGER than ``baseline`` (for regrets: a regression).

    Normal approximation with tie correction and continuity correction —
    deterministic, dependency-free, and accurate to what a 5-vs-5 gate can
    resolve (the exact one-sided floor at n=m=5 is 1/252 ≈ 0.004).
    Returns ``(u_current, p_greater)``."""
    n, m = len(current), len(baseline)
    if not n or not m:
        return 0.0, 1.0
    pooled = list(current) + list(baseline)
    ranks = _rankdata(pooled)
    r_current = sum(ranks[:n])
    u = r_current - n * (n + 1) / 2.0  # U statistic of `current`
    mean_u = n * m / 2.0
    # Tie correction on the variance.
    counts = {}
    for value in pooled:
        counts[value] = counts.get(value, 0) + 1
    total = n + m
    tie_term = sum(c**3 - c for c in counts.values())
    var_u = (n * m / 12.0) * (total + 1 - tie_term / (total * (total - 1)))
    if var_u <= 0:
        return u, 1.0
    z = (u - mean_u - 0.5) / math.sqrt(var_u)  # continuity-corrected
    p_greater = 0.5 * math.erfc(z / math.sqrt(2.0))
    return u, p_greater


def _median(values):
    ordered = sorted(values)
    mid = len(ordered) // 2
    if len(ordered) % 2:
        return ordered[mid]
    return 0.5 * (ordered[mid - 1] + ordered[mid])


def bootstrap_median_shift(current, baseline, n_boot=4000, seed=0):
    """95% bootstrap CI of ``median(current) - median(baseline)``.

    Seeded (deterministic in CI); returns ``(lo, hi)``."""
    rng = random.Random(seed)
    diffs = []
    for _ in range(n_boot):
        resampled_current = [rng.choice(current) for _ in current]
        resampled_baseline = [rng.choice(baseline) for _ in baseline]
        diffs.append(_median(resampled_current) - _median(resampled_baseline))
    diffs.sort()
    lo = diffs[int(0.025 * (len(diffs) - 1))]
    hi = diffs[int(0.975 * (len(diffs) - 1))]
    return lo, hi


def curve_auc(curve):
    """Mean log10-regret over the curve — the trajectory-wide summary (a
    run that reaches the same final regret twice as slowly scores worse).
    Floored at EPS so an exact-zero regret cannot blow up the log."""
    return sum(math.log10(max(float(v), EPS)) for v in curve) / max(len(curve), 1)


def _compare(current_stats, baseline_stats, alpha, min_rel_effect, seed):
    """One statistic's three-criterion verdict."""
    _u, p = mann_whitney_u(current_stats, baseline_stats)
    lo, hi = bootstrap_median_shift(current_stats, baseline_stats, seed=seed)
    base_med = _median(baseline_stats)
    curr_med = _median(current_stats)
    rel_effect = (curr_med - base_med) / max(abs(base_med), EPS)
    regressed = (
        p < alpha and lo > 0.0 and rel_effect > min_rel_effect
    )
    return {
        "p_value": round(p, 6),
        "baseline_median": base_med,
        "current_median": curr_med,
        "rel_effect": round(rel_effect, 6),
        "shift_ci95": [lo, hi],
        "regressed": bool(regressed),
    }


def evaluate_regret_gate(
    current_curves,
    baseline_curves,
    alpha=DEFAULT_ALPHA,
    min_rel_effect=DEFAULT_MIN_REL_EFFECT,
    seed=0,
):
    """Gate verdict dict for per-seed regret curves vs the committed
    baseline.  ``pass`` is False only when EITHER the final-regret or the
    curve-AUC comparison trips all three criteria (significance + CI +
    minimum effect) toward WORSE — improvements always pass."""
    current_final = [float(curve[-1]) for curve in current_curves]
    baseline_final = [float(curve[-1]) for curve in baseline_curves]
    final = _compare(current_final, baseline_final, alpha, min_rel_effect, seed)
    # AUC operates in log space already; its medians are log10 regrets, so
    # the relative-effect floor is applied to the LINEAR ratio implied by
    # the log shift (a +0.1 log10 shift = 26% slower descent).
    current_auc = [curve_auc(curve) for curve in current_curves]
    baseline_auc = [curve_auc(curve) for curve in baseline_curves]
    _u, p_auc = mann_whitney_u(current_auc, baseline_auc)
    lo, hi = bootstrap_median_shift(current_auc, baseline_auc, seed=seed + 1)
    auc_shift = _median(current_auc) - _median(baseline_auc)
    auc = {
        "p_value": round(p_auc, 6),
        "baseline_median": _median(baseline_auc),
        "current_median": _median(current_auc),
        "log10_shift": round(auc_shift, 6),
        "shift_ci95": [lo, hi],
        "regressed": bool(
            p_auc < alpha
            and lo > 0.0
            and 10.0**auc_shift - 1.0 > min_rel_effect
        ),
    }
    return {
        "pass": not (final["regressed"] or auc["regressed"]),
        "alpha": alpha,
        "min_rel_effect": min_rel_effect,
        "seeds": len(current_curves),
        "baseline_seeds": len(baseline_curves),
        "final": final,
        "auc": auc,
    }


def load_baseline(path):
    """Committed baseline file -> list of per-seed regret curves.

    Schema (``BENCH_REGRET_BASELINE.json``): ``{"seeds": [...],
    "curves": [[regret, ...], ...], "config": {...}, "justification":
    "..."}`` — curves indexed like seeds."""
    with open(path) as handle:
        data = json.load(handle)
    return [list(map(float, curve)) for curve in data["curves"]]
