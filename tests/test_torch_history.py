"""The port's observation buffers against ``orion_tpu.algo.history``:
the same appends give bit-equal padded views, and the local-GP gather
picks the same rows under distance ties (lowest index first)."""

import copy

import numpy as np

from orion_tpu.algo.history import DeviceHistory as JaxDeviceHistory
from orion_tpu.algo.history import HostHistory as JaxHostHistory
from orion_tpu_torch.algo.history import DeviceHistory, HostHistory


def _batches(seed, d):
    rng = np.random.default_rng(seed)
    for b in (5, 16, 1, 40, 30):  # crosses the 64 floor into the 128 bucket
        yield rng.uniform(size=(b, d)).astype(np.float32), rng.normal(size=(b,)).astype(
            np.float32
        )


def test_append_and_fit_view_match():
    port, ref = DeviceHistory(3, device="cpu"), JaxDeviceHistory(3)
    host_t, host_j = HostHistory(3), JaxHostHistory(3)
    for rows, ys in _batches(0, 3):
        port.append(rows, ys)
        ref.append(rows, ys)
        host_t.append(rows, ys)
        host_j.append(rows, ys)
        got, want = port.fit_view(), ref.fit_view()
        assert got[3] == want[3]
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(host_t.x, host_j.x)
        assert (host_t.best_idx, host_t.best_y) == (host_j.best_idx, host_j.best_y)


def test_local_view_ties_break_to_lowest_index():
    # Rows on a lattice around the center: many exactly equal distances,
    # plus exact duplicates of the center itself.
    grid = np.array([[i, j] for i in range(-3, 4) for j in range(-3, 4)], np.float32) / 8.0
    rows = np.concatenate([grid + 0.5, grid[::-1] + 0.5, np.full((3, 2), 0.5, np.float32)])
    ys = np.arange(rows.shape[0], dtype=np.float32)
    port = DeviceHistory.from_host(rows, ys, device="cpu")
    ref = JaxDeviceHistory.from_host(rows, ys)
    center = np.array([0.5, 0.5], np.float32)
    for m in (5, 20, 64):
        got, want = port.local_view(center, m), ref.local_view(center, m)
        assert got[3] == want[3]
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = port.local_view(center, 9, dist_cols=1)
    want = ref.local_view(center, 9, dist_cols=1)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_deepcopy_is_copy_on_write():
    port = DeviceHistory(2, device="cpu")
    port.append(np.ones((3, 2), np.float32), np.ones(3, np.float32))
    clone = copy.deepcopy(port)
    clone.append(np.zeros((2, 2), np.float32), np.full(2, 7.0, np.float32))
    port.append(np.full((1, 2), 2.0, np.float32), np.full(1, 5.0, np.float32))
    assert port.count == 4 and clone.count == 5
    np.testing.assert_array_equal(port.fit_view()[1][:4].numpy(), [1, 1, 1, 5])
    np.testing.assert_array_equal(clone.fit_view()[1][:5].numpy(), [1, 1, 1, 7, 7])
    host = HostHistory(2)
    host.append(np.ones((2, 2), np.float32), np.ones(2, np.float32))
    host_clone = copy.deepcopy(host)
    host_clone.append(np.zeros((1, 2), np.float32), np.zeros(1, np.float32))
    assert host.count == 2 and host_clone.count == 3 and host.best_y == 1.0
