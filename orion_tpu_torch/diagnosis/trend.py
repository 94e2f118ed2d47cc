"""Dependency-free trend detectors for the doctor's rule catalog (port of
``orion_tpu/diagnosis/trend.py``).

Trend rules (replication-lag growth, device-memory growth, regret
stagnation) must not fire on one noisy sample, and must not need scipy —
the same discipline as ``benchmarks/regret_gate.py``'s dependency-free
Mann–Whitney.  Two detectors cover every shipped rule:

- :func:`robust_slope` — the Theil–Sen estimator (median of pairwise
  slopes): one outlier sample in a window of ten cannot flip the sign,
  which a least-squares fit (or a naive last-minus-first) can;
- :func:`ewma` — exponentially weighted moving average, for "recent
  level" questions (is EI *still* flat, not was-it-flat-once).

Both accept plain Python floats; records with missing fields are the
caller's job to drop (``Snapshot.series`` already does).
"""


def robust_slope(values):
    """Theil–Sen slope of ``values`` against their indices (units: value
    change per sample).  Returns 0.0 for fewer than 2 points — a window
    too short to claim a trend must read as "no trend", never as noise."""
    points = [float(v) for v in values]
    n = len(points)
    if n < 2:
        return 0.0
    slopes = []
    for i in range(n):
        for j in range(i + 1, n):
            slopes.append((points[j] - points[i]) / float(j - i))
    slopes.sort()
    mid = len(slopes) // 2
    if len(slopes) % 2:
        return slopes[mid]
    return 0.5 * (slopes[mid - 1] + slopes[mid])


def ewma(values, alpha=0.35):
    """Exponentially weighted moving average of ``values`` (newest last).
    Returns None on an empty series — "no data" must stay distinguishable
    from "averages to zero"."""
    result = None
    for value in values:
        value = float(value)
        result = value if result is None else alpha * value + (1 - alpha) * result
    return result


def relative_change(values):
    """``(last - first) / max(|first|, eps)`` over the series — the
    magnitude question a positive slope alone cannot answer (a slope of
    +1 byte/round on a 100 MB buffer is not growth worth a finding)."""
    if len(values) < 2:
        return 0.0
    first, last = float(values[0]), float(values[-1])
    return (last - first) / max(abs(first), 1e-12)
