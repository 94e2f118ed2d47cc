"""The port's search-space codecs against ``orion_tpu.space``, for every
prior the DSL builds.  Both sides run the same numpy/scipy host codec, so
decoded values and encoded rows must be equal (float64 decode, float32
rows: rtol 1e-12 / exact)."""

import numpy as np
import pytest

from orion_tpu.space.dsl import build_space as jax_build_space
from orion_tpu_torch.space.dsl import DSLError, build_space

PRIORS = {
    "u": "uniform(-3, 5)",
    "ud": "uniform(0, 10, discrete=True)",
    "lu": "loguniform(1e-4, 1.0)",
    "lud": "loguniform(1, 1000, discrete=True)",
    "n": "normal(0.5, 2.0)",
    "nt": "normal(0.0, 1.0, low=-1.0, high=2.0)",
    "nd": "normal(5, 2, discrete=True)",
    "g": "gaussian(1.0, 0.5)",
    "c": "choices(['a', 'b', 3, 4.5])",
    "cp": "choices({'x': 0.2, 'y': 0.5, 'z': 0.3})",
    "ri": "randint(2, 9)",
    "sh": "uniform(0, 1, shape=(2, 3))",
    "shc": "choices(['p', 'q'], shape=2)",
    "p": "uniform(1, 100, precision=3)",
    "f": "fidelity(1, 64, 4)",
    "+added": "+uniform(0, 2)",
}


def _spaces():
    return build_space(PRIORS), jax_build_space(PRIORS)


def test_same_layout_and_configuration():
    port, ref = _spaces()
    assert port.keys() == ref.keys()
    assert port.n_cols == ref.n_cols
    assert port.configuration() == ref.configuration()


def test_decode_arrays_to_params_and_back():
    port, ref = _spaces()
    u = np.random.default_rng(0).uniform(size=(64, port.n_cols)).astype(np.float32)
    u[0] = 0.0  # the codec's clip edges
    u[1] = 1.0
    got, want = port.decode_flat_np(u), ref.decode_flat_np(u)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-12)
    params_t = port.arrays_to_params(got)
    params_j = ref.arrays_to_params(want)
    assert params_t.names == params_j.names
    for col_t, col_j in zip(params_t.columns, params_j.columns):
        # Shaped dims hold one array per row; compare them as arrays.
        np.testing.assert_array_equal(np.asarray(col_t, dtype=object),
                                      np.asarray(col_j, dtype=object))
    np.testing.assert_array_equal(port.params_to_cube(params_t), ref.params_to_cube(params_j))
    # The plain dict list (plugin boundary) encodes like the columnar batch.
    np.testing.assert_array_equal(
        port.params_to_cube(params_t.materialize()), ref.params_to_cube(params_j.materialize())
    )
    cube = port.encode_flat_np(got)
    np.testing.assert_array_equal(cube, ref.encode_flat_np(want))


def test_containment_and_errors_match():
    port, ref = _spaces()
    u = np.random.default_rng(1).uniform(size=(8, port.n_cols))
    for params in port.arrays_to_params(port.decode_flat_np(u)):
        assert port.contains_point(params) and ref.contains_point(params)
    with pytest.raises(DSLError):
        build_space({"bad": "uniform(2, 1)"})
    with pytest.raises(DSLError):
        build_space({"bad": "__import__('os').system('true')"})


# --- prior sampling: Space.sample, sample_flat, Dimension.sample_host --------
#
# torch cannot reproduce JAX's threefry stream, so the two packages' draws
# are not compared; the same cube ``u`` is fed to both decodes instead.  The
# reference decodes on the device in float32 and the port on the host in
# float64: continuous values agree within rtol 1e-5 (float32 rounding,
# through exp for the log priors), integers and categories exactly.

SAMPLE_PRIORS = {
    "lin": "uniform(-3, 5)",
    "log": "loguniform(1e-4, 1.0)",
    "int": "uniform(0, 10, discrete=True)",
    "cat": "choices(['a', 'b', 3, 4.5])",
    "shr": "uniform(0, 1, shape=(2, 3))",
    "shc": "choices(['p', 'q'], shape=2)",
    "fid": "fidelity(1, 64, 4)",
}


def _assert_params_equal(got, want):
    assert len(got) == len(want)
    for row_t, row_j in zip(got, want):
        assert row_t.keys() == row_j.keys()
        for name in row_j:
            a, b = np.asarray(row_t[name]), np.asarray(row_j[name])
            if a.dtype.kind == "f" or b.dtype.kind == "f":
                np.testing.assert_allclose(a.astype(float), b.astype(float), rtol=1e-5,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
                assert type(row_t[name]) is type(row_j[name]), name


@pytest.mark.parametrize("fidelity_value", [None, 16])
def test_sample_decodes_a_cube_like_the_reference(monkeypatch, fidelity_value):
    import jax.numpy as jnp
    import torch

    port, ref = build_space(SAMPLE_PRIORS), jax_build_space(SAMPLE_PRIORS)
    u = np.random.default_rng(3).uniform(size=(256, port.n_cols)).astype(np.float32)
    monkeypatch.setattr(port, "sample_flat", lambda gen, n: torch.from_numpy(u[:n]))
    monkeypatch.setattr(ref, "sample_flat", lambda key, n: jnp.asarray(u[:n]))
    got = port.sample(0, n=256, fidelity_value=fidelity_value).materialize()
    want = ref.sample(0, n=256, fidelity_value=fidelity_value)
    _assert_params_equal(got, want)
    assert {row["fid"] for row in got} == {16 if fidelity_value else 64}


@pytest.mark.parametrize("name", sorted(SAMPLE_PRIORS))
def test_sample_host_matches_the_reference_on_one_numpy_stream(name):
    """``Dimension.sample_host`` takes a numpy Generator in both packages,
    so there the draws themselves are the same."""
    port, ref = build_space(SAMPLE_PRIORS)[name], jax_build_space(SAMPLE_PRIORS)[name]
    got = port.sample_host(np.random.default_rng(5), n=64)
    want = np.asarray(ref.sample_host(np.random.default_rng(5), n=64))
    assert got.shape == want.shape
    if want.dtype.kind in "fc":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_sample_flat_is_a_uniform_cube_on_the_generators_device():
    import torch

    space = build_space(SAMPLE_PRIORS)
    gen = torch.Generator().manual_seed(0)
    u = space.sample_flat(gen, 1000)
    assert u.shape == (1000, space.n_cols) and u.dtype == torch.float32
    assert u.device == gen.device
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_sample_respects_bounds_and_supports():
    space = build_space(SAMPLE_PRIORS)
    params = space.sample(11, n=2000).materialize()
    assert all(space.contains_point(p) for p in params)
    lin = np.asarray([p["lin"] for p in params])
    log = np.asarray([p["log"] for p in params])
    assert lin.min() >= -3 and lin.max() <= 5
    assert log.min() >= 1e-4 and log.max() <= 1.0
    assert {p["int"] for p in params} <= set(range(11))
    assert all(isinstance(p["int"], int) for p in params)
    assert {p["cat"] for p in params} == {"a", "b", 3, 4.5}
    assert all(np.shape(p["shr"]) == (2, 3) for p in params)
    assert {v for p in params for v in np.asarray(p["shc"]).tolist()} == {"p", "q"}
    assert {p["fid"] for p in params} == {64}


def test_sample_is_reproducible_for_one_seed():
    import torch

    space = build_space(SAMPLE_PRIORS)
    first = space.sample(7, n=50).materialize()
    again = space.sample(7, n=50).materialize()
    by_generator = space.sample(torch.Generator().manual_seed(7), n=50).materialize()
    other = space.sample(8, n=50).materialize()
    assert [p["lin"] for p in first] == [p["lin"] for p in again]
    assert [p["lin"] for p in first] == [p["lin"] for p in by_generator]
    assert [p["cat"] for p in first] == [p["cat"] for p in again]
    assert [p["lin"] for p in first] != [p["lin"] for p in other]


def test_loguniform_median_is_the_geometric_mean():
    space = build_space({"lr": "loguniform(1e-4, 1.0)"})
    values = np.asarray([p["lr"] for p in space.sample(0, n=20000)])
    median, geometric = float(np.median(values)), 1e-2
    assert abs(median - geometric) <= 0.05 * geometric
