"""The step-graph cache's pool bound (``orion_tpu_torch/algo/step_graphs.py``)
on the CPU: the rule that starts a fresh pool, and the bookkeeping a CPU
entry carries.  The captures themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``diagnosis`` (b))."""

import pytest
import torch

from orion_tpu_torch.algo.step_graphs import (
    _CPU_MARKER, POOL_BOUND, StepGraphs, _footprint, _over_bound, _segments, graph_pool_bytes)

MiB = 1 << 20


@pytest.mark.parametrize("pool,footprints,over", [
    # Captures in ascending size: the first one's growth is its whole
    # footprint, each later one's growth a lower bound of its own.
    (73 * MiB, [73 * MiB], False),
    (136 * MiB, [73 * MiB, 0, 0, 0, 66 * MiB], True),
    (110 * MiB, [73 * MiB, 37 * MiB], True),
    (109 * MiB, [73 * MiB, 36 * MiB], False),
    # A larger newcomer is its own footprint's lower bound.
    (700 * MiB, [140 * MiB, 560 * MiB], False),
    # The ascending q=128 capture, first on growths, then on its footprint
    # measured alone.
    (136 * MiB, [70 * MiB, 2 * MiB, 64 * MiB], True),
    (136 * MiB, [70 * MiB, 2 * MiB, 134 * MiB], False),
    (0, [], False),
])
def test_over_bound_compares_the_pool_with_the_largest_footprint(pool, footprints, over):
    assert _over_bound(pool, footprints) is over
    assert POOL_BOUND == 1.5


@pytest.mark.parametrize("grew,alone,footprint", [
    (2 * MiB, None, 2 * MiB),  # not measured: the capture's growth
    (2 * MiB, 134 * MiB, 134 * MiB),  # measured alone: exact
    (70 * MiB, 70 * MiB, 70 * MiB),  # a pool's first capture
])
def test_a_footprint_is_exact_where_measured_else_the_growth(grew, alone, footprint):
    entry = _CPU_MARKER._replace(grew_bytes=grew, alone_bytes=alone)
    assert _footprint(entry) == footprint


def test_no_graph_pool_is_read_before_cuda_starts():
    assert not torch.cuda.is_initialized()
    assert graph_pool_bytes() == 0 and _segments({(1, 0)}) == []


def test_cpu_entries_mark_signatures_without_a_pool():
    graphs = StepGraphs()
    calls = []

    def step(x, *, q):
        calls.append(q)
        return x * q

    out, entry, missed = graphs.run(lambda a, b, *, q: step(b, q=q), ("sig", 2),
                                    (None, torch.ones(3)), {"q": 2})
    assert missed and entry.graph is None and entry.grew_bytes == 0 and entry.alone_bytes is None
    assert torch.equal(out, torch.full((3,), 2.0))
    _, _, missed = graphs.run(lambda a, b, *, q: step(b, q=q), ("sig", 2),
                              (None, torch.ones(3)), {"q": 2})
    assert not missed and calls == [2, 2]
    assert graphs.pool_bytes() == 0 and graphs.fresh_pools == 0 and graphs.pool is None
    graphs.fresh_pools = graphs.alone_captures = 3
    graphs.reset()  # no pool to release: CUDA is never touched
    assert graphs.entries() == [] and graphs.fresh_pools == graphs.alone_captures == 0
    assert not torch.cuda.is_initialized()
