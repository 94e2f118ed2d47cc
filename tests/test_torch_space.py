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
