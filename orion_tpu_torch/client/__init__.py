"""Client helpers imported by the *user's* script (port of
``orion_tpu/client/__init__.py``, copied as it is).

Capability parity: reference `src/orion/client/__init__.py` — the script-side
half of the results contract: `report_results(data)` writes JSON to
``$ORION_RESULTS_PATH`` when running under a worker (once only), else prints
to stdout so scripts stay runnable standalone.  ``IS_ORION_ON`` tells the
script whether it is being orchestrated.
"""

import json
import os

IS_ORION_ON = False
RESULTS_FILENAME = os.getenv("ORION_RESULTS_PATH", None)
_HAS_REPORTED_RESULTS = False

if RESULTS_FILENAME and os.path.exists(os.path.dirname(os.path.abspath(RESULTS_FILENAME))):
    IS_ORION_ON = True


def report_results(data):
    """Report final evaluation results of this trial.

    ``data`` is a list of dicts ``{"name", "type", "value"}`` where exactly
    one entry should have type ``"objective"``.  May be called once.
    """
    global _HAS_REPORTED_RESULTS
    if _HAS_REPORTED_RESULTS:
        raise RuntimeWarning("Has already reported evaluation results once.")
    if IS_ORION_ON:
        with open(RESULTS_FILENAME, "w") as handle:
            json.dump(data, handle)
    else:
        print(json.dumps(data))
    _HAS_REPORTED_RESULTS = True


def report_objective(value, name="objective"):
    """Convenience wrapper for the common single-objective case."""
    report_results([{"name": name, "type": "objective", "value": value}])
