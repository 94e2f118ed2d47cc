"""The host-budget factor — ONE source of truth for every consumer (port of
``orion_tpu/hostbudget.py``).

The steady-state bar is ``host_ms_per_round <= F x device_ms_per_round``.
The consumers read the SAME knob so they can never drift apart:

- ``top``'s and ``info``'s live host/device ratio, which flags a worker
  whose mean ``producer.round`` exceeds ``1 + F`` times its mean
  ``device.dispatch`` window (the round CONTAINS the device window, so a
  host tax of F x device makes the round (1+F) x device);
- the doctor's DX004 rule (``diagnosis/rules_system.py``); in the
  reference, also ``bench.py``'s host-budget check.

``ORION_TPU_HOST_BUDGET_FACTOR`` overrides everywhere at once.
"""

import logging
import os

log = logging.getLogger(__name__)

#: Host tax per steady-state round may cost at most this multiple of the
#: device time (the reference's value).
DEFAULT_HOST_BUDGET_FACTOR = 1.25

ENV_VAR = "ORION_TPU_HOST_BUDGET_FACTOR"


def host_budget_factor():
    """The effective host-budget factor: env override, else the default.

    Read at call time (not import time) so a test or runner can flip the
    env var without re-importing every consumer.  A malformed override
    falls back to the default with a warning rather than crashing the
    commands that read it."""
    raw = os.environ.get(ENV_VAR, "").strip()
    if raw:
        try:
            return float(raw)
        except ValueError:
            log.warning(
                "ignoring malformed %s=%r (want a float); using %s",
                ENV_VAR, raw, DEFAULT_HOST_BUDGET_FACTOR,
            )
    return DEFAULT_HOST_BUDGET_FACTOR


def round_budget_factor():
    """The derived threshold over ``producer.round`` vs
    ``device.dispatch``: the round INCLUDES the device window, so a host
    budget of F x device bounds the whole round at (1 + F) x device."""
    return 1.0 + host_budget_factor()
