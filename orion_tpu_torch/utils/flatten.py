"""Dotted-key dict flatten/unflatten helpers (port of
``orion_tpu/utils/flatten.py``, unchanged).

Used by the ephemeral document store and layered configuration (capability
parity: reference `src/orion/core/utils/flatten.py`).
"""


def flatten(nested, prefix=""):
    """Flatten a nested dict into a single-level dict with dotted keys."""
    out = {}
    for key, value in nested.items():
        full = f"{prefix}{key}"
        if isinstance(value, dict) and value:
            out.update(flatten(value, prefix=full + "."))
        else:
            out[full] = value
    return out


def unflatten(flat):
    """Inverse of :func:`flatten`."""
    out = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out
