"""The port's mesh helpers (``orion_tpu_torch.algo.sharding``,
``orion_tpu_torch.parallel``) against the reference's
(``orion_tpu.algo.sharding``, on the suite's 8 virtual CPU devices).

Setup: logical CPU slots (``device="cpu"``), the counterpart of the
reference's virtual devices.  Pass: the same cache identities, stacked
shapes, fingerprints and per-slot placement fractions as the reference,
exactly; placement fractions summing to 1 within 1e-6, as the reference's
own test holds them.
"""

import numpy as np
import pytest
import torch

from orion_tpu.algo import sharding as ref
from orion_tpu_torch import parallel
from orion_tpu_torch.algo import sharding
from orion_tpu_torch.diagnosis import Snapshot, run_rules


def test_mesh_and_spec_caches_return_the_same_objects():
    mesh_a = sharding.get_mesh(8, device="cpu")
    assert sharding.get_mesh(8, device="cpu") is mesh_a
    assert parallel.device_mesh(8, device="cpu") is mesh_a
    assert sharding.candidate_spec(mesh_a) is parallel.candidate_sharding(mesh_a)
    assert sharding.replicated_spec(mesh_a) is parallel.replicated(mesh_a)
    assert sharding.get_mesh(1, device="cpu") is not mesh_a
    assert sharding.get_mesh(8, sharding.TENANT_AXIS, device="cpu") is not mesh_a
    assert (mesh_a.size, mesh_a.slots, mesh_a.one_device) == (8, (torch.device("cpu"),) * 8,
                                                              True)


def test_clear_caches_builds_a_new_mesh():
    mesh = sharding.get_mesh(4, device="cpu")
    sharding.clear_caches()
    again = sharding.get_mesh(4, device="cpu")
    assert again is not mesh and repr(again) == repr(mesh) == "4×candidates@cpu"


@pytest.mark.parametrize("a,b", [(1, 8), (2, 8), (3, 8), (4, 8), (6, 8), (8, 8), (16, 8),
                                 (12, 4), (8, 1), (5, 5), (48, 16)])
def test_gcd_pow2_matches_the_reference(a, b):
    assert sharding._gcd_pow2(a, b) == ref._gcd_pow2(a, b)


@pytest.mark.parametrize("tenants", [1, 2, 3, 4, 6, 8, 16])
def test_stacked_mesh_shape_matches_the_reference(tenants):
    mesh = sharding.get_stacked_mesh(tenants, 8, device="cpu")
    want = ref.get_stacked_mesh(tenants, 8)
    assert mesh.shape == want.devices.shape
    assert mesh.axis_names == tuple(want.axis_names)
    assert sharding.get_stacked_mesh(tenants, 8, device="cpu") is mesh
    assert sharding.mesh_fingerprint(mesh) == ref.mesh_fingerprint(want)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_fingerprint_matches_the_reference(n):
    mesh = sharding.get_mesh(n, device="cpu")
    assert sharding.mesh_fingerprint(mesh) == ref.mesh_fingerprint(ref.get_mesh(n)) == \
        f"{n}×candidates"
    assert sharding.mesh_fingerprint(None) == ref.mesh_fingerprint(None) == "none"


def test_placement_over_eight_slots_sums_to_one():
    mesh = sharding.get_mesh(8, device="cpu")
    pool = sharding.shard_candidates(torch.zeros((64, 4)), mesh)
    fractions = sharding.placement_fractions(pool)
    want = ref.placement_fractions(ref.shard_candidates(np.zeros((64, 4), np.float32),
                                                        ref.get_mesh(8)))
    assert sorted(fractions.values()) == sorted(want.values())
    assert len(fractions) == 8 and all(f > 0 for f in fractions.values())
    assert abs(sum(fractions.values()) - 1.0) < 1e-6
    assert mesh.last_placement == tuple([8 * 4 * 4] * 8)


def test_candidates_shard_into_contiguous_chunks_and_gather_back():
    mesh = sharding.get_mesh(4, device="cpu")
    c = torch.arange(10 * 3, dtype=torch.float32).reshape(10, 3)
    pool = parallel.shard_candidates(c, mesh)
    assert pool.sharding is parallel.candidate_sharding(mesh)
    assert [s.shape[0] for s in pool.shards] == [len(t) for t in torch.tensor_split(c, 4)]
    assert list(pool.sizes) == [3, 3, 2, 2] and pool.offsets() == [0, 3, 6, 8]
    for shard, want in zip(pool.shards, torch.tensor_split(c, 4)):
        assert shard.data_ptr() == want.data_ptr()  # a view: the slot is the home device
    np.testing.assert_array_equal(sharding.gather_candidates(pool), c.numpy())


def test_replicated_arrays_count_fully_on_every_slot():
    mesh = sharding.get_mesh(4, device="cpu")
    state = sharding.place(torch.ones((16, 16)), parallel.replicated(mesh))
    pool = sharding.shard_candidates(torch.ones((64, 4)), mesh)
    assert sharding.placement_fractions(state) == {i: 0.25 for i in range(4)}
    assert sharding.mesh_utilization(mesh, state, pool) == (0.25, 0.25)
    np.testing.assert_array_equal(sharding.gather_candidates(state), np.ones((16, 16)))


def test_dx006_fires_on_a_collapsed_placement_and_stays_silent_on_an_even_one():
    mesh = sharding.get_mesh(4, device="cpu")
    even = sharding.mesh_health_fields(mesh, sharding.shard_candidates(torch.ones((64, 6)),
                                                                       mesh))
    collapsed = sharding.mesh_health_fields(mesh, sharding.Placement((64 * 6 * 4, 0, 0, 0)))
    assert even == {"mesh_devices": 4, "mesh_util_min_frac": 0.25, "mesh_util_max_frac": 0.25}
    assert collapsed["mesh_util_max_frac"] == 1.0 and collapsed["mesh_util_min_frac"] == 0.0

    def fired(record):
        return [f.rule_id for f in run_rules(Snapshot(health=[record])).findings
                if f.rule_id == "DX006"]

    assert fired(even) == []
    assert fired(collapsed) == ["DX006"]
    assert fired({f"serve_{k}": v for k, v in collapsed.items()}) == ["DX006"]


def test_a_mesh_over_cards_asks_for_cuda():
    """``device=None`` and ``"cuda"`` mean the card: no card here, so the
    mesh raises rather than land on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            sharding.get_mesh(2, device=device)


def test_a_mesh_needs_a_slot():
    with pytest.raises(ValueError):
        sharding.get_mesh(0, device="cpu")
