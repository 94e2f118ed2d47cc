"""Layout of the packed per-round health vector the fused suggest step
attaches to ``GPState.health`` (the part of ``orion_tpu/health.py`` the
port needs: ``DEVICE_HEALTH_FIELDS`` and ``unpack_device_health``).

- ``gp_mll``: marginal log-likelihood per observation of the final fit;
- ``gp_ls_min`` / ``gp_ls_mean`` / ``gp_ls_max``: fitted lengthscales over
  the free dims;
- ``gp_noise``: fitted noise level;
- ``acq_ei_max`` / ``acq_ei_mean``: expected improvement over the pool;
- ``q_unique_frac``: fraction of distinct rows in the selected q-batch.
"""

import numpy as np

#: FIXED order — the vector is unpacked positionally.
DEVICE_HEALTH_FIELDS = (
    "gp_mll",
    "gp_ls_min",
    "gp_ls_mean",
    "gp_ls_max",
    "gp_noise",
    "acq_ei_max",
    "acq_ei_mean",
    "q_unique_frac",
)


def unpack_device_health(vec):
    """Packed ``(len(DEVICE_HEALTH_FIELDS),)`` vector (tensor or array) ->
    field dict.  Read it after the round's rows reached the host, so the
    values are ready and the copy does not wait on the device."""
    if hasattr(vec, "detach"):
        vec = vec.detach().cpu().numpy()
    values = np.asarray(vec, dtype=np.float64).ravel()
    if values.shape[0] < len(DEVICE_HEALTH_FIELDS):
        return {}
    return {name: float(values[i]) for i, name in enumerate(DEVICE_HEALTH_FIELDS)}
