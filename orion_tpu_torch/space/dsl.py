"""Prior-expression DSL: ``name~'uniform(-3, 5)'``.

Capability parity: reference `src/orion/core/io/space_builder.py` — same
grammar (uniform/loguniform/gaussian/normal/choices/fidelity, ``discrete=``,
``shape=``, ``default_value=``, ``precision=``, branching markers ``+ - >``)
— but parsed with the ``ast`` module instead of the reference's restricted
``eval`` (`space_builder.py:53-56`), so arbitrary code can never execute.

Deviation (documented): the reference falls back to *any* ``scipy.stats``
distribution name (`space_builder.py:204-212`).  On device we support the
named priors below plus common scipy aliases; exotic scipy distributions
raise with a clear message instead of silently running on host.
"""

import ast
import re

from orion_tpu_torch.space.dims import Categorical, Fidelity, Integer, NotSet, Real
from orion_tpu_torch.space.space import Space

# Reference marker regex: `orion_cmdline_parser.py:88`
MARKER_RE = re.compile(r"^([\+\-\>]?)(.*)$", re.DOTALL)

_ALIASES = {
    "gaussian": "normal",
    "norm": "normal",
    "reciprocal": "loguniform",
    "log_uniform": "loguniform",
}


class DSLError(ValueError):
    """Malformed prior expression."""


def _literal(node, expr):
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError) as exc:
        raise DSLError(f"Non-literal argument in prior expression {expr!r}") from exc


def _parse_call(expr):
    try:
        tree = ast.parse(expr.strip(), mode="eval")
    except SyntaxError as exc:
        raise DSLError(f"Cannot parse prior expression {expr!r}") from exc
    call = tree.body
    if not isinstance(call, ast.Call) or not isinstance(call.func, ast.Name):
        raise DSLError(f"Prior expression must be a call, got {expr!r}")
    name = call.func.id.lower()
    args = [_literal(a, expr) for a in call.args]
    kwargs = {kw.arg: _literal(kw.value, expr) for kw in call.keywords if kw.arg}
    return name, args, kwargs


def _shape_tuple(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def build_dimension(name, expr):
    """Build one Dimension from ``expr`` (no branching marker)."""
    dist, args, kwargs = _parse_call(expr)
    dist = _ALIASES.get(dist, dist)
    shape = _shape_tuple(kwargs.pop("shape", None))
    default = kwargs.pop("default_value", NotSet)
    discrete = bool(kwargs.pop("discrete", False))
    precision = int(kwargs.pop("precision", 0) or 0)

    if dist == "fidelity":
        if shape:
            raise DSLError("fidelity dimensions must be scalar")
        low, high = int(args[0]), int(args[1])
        base = int(args[2]) if len(args) > 2 else int(kwargs.pop("base", 2))
        if kwargs:
            raise DSLError(f"Unknown fidelity kwargs {sorted(kwargs)}")
        if not (1 <= low <= high):
            raise DSLError(f"fidelity needs 1 <= low <= high, got ({low}, {high})")
        if base < 1:
            raise DSLError(f"fidelity base must be >= 1, got {base}")
        return Fidelity(name=name, prior_expr=expr.strip(), low=low, high=high, base=base)

    if dist == "choices":
        if len(args) == 1 and isinstance(args[0], dict):
            categories = tuple(args[0].keys())
            probs = tuple(float(p) for p in args[0].values())
            if abs(sum(probs) - 1.0) > 1e-6:
                raise DSLError(f"choices probabilities must sum to 1, got {sum(probs)}")
        elif len(args) == 1 and isinstance(args[0], (list, tuple)):
            categories, probs = tuple(args[0]), ()
        else:
            categories, probs = tuple(args), ()
        if not categories:
            raise DSLError("choices requires at least one category")
        return Categorical(
            name=name,
            prior_expr=expr.strip(),
            shape=shape,
            default_value=default,
            categories=categories,
            probs=probs,
        )

    cls = Integer if discrete else Real
    common = dict(
        name=name,
        prior_expr=expr.strip(),
        shape=shape,
        default_value=default,
        precision=precision,
    )

    if dist in ("uniform", "loguniform", "randint") and len(args) < 2:
        raise DSLError(f"{dist} requires (low, high), got {expr!r}")
    if dist == "uniform":
        low, high = float(args[0]), float(args[1])
        if low >= high:
            raise DSLError(f"uniform needs low < high, got ({low}, {high})")
        return cls(dist="uniform", low=low, high=high, **common)
    if dist == "loguniform":
        low, high = float(args[0]), float(args[1])
        if not (0 < low < high):
            raise DSLError(f"loguniform needs 0 < low < high, got ({low}, {high})")
        return cls(dist="loguniform", low=low, high=high, **common)
    if dist == "normal":
        loc = float(args[0]) if args else float(kwargs.pop("loc", 0.0))
        scale = float(args[1]) if len(args) > 1 else float(kwargs.pop("scale", 1.0))
        low = float(kwargs.pop("low", float("-inf")))
        high = float(kwargs.pop("high", float("inf")))
        if scale <= 0:
            raise DSLError(f"normal needs scale > 0, got {scale}")
        return cls(dist="normal", loc=loc, scale=scale, low=low, high=high, **common)
    if dist == "randint":
        low, high = int(args[0]), int(args[1])
        if low >= high:
            raise DSLError(f"randint needs low < high, got ({low}, {high})")
        return Integer(dist="uniform", low=low, high=high - 1, **common)

    raise DSLError(
        f"Unknown prior {dist!r} in {expr!r}. Supported: uniform, loguniform, "
        "normal/gaussian, choices, fidelity, randint (+ discrete=True variants). "
        "Arbitrary scipy.stats distributions are not supported on device."
    )


def split_marker(expr):
    """Strip a leading EVC branching marker (+ add, - remove, > rename)."""
    marker, rest = MARKER_RE.match(expr.strip()).groups()
    return marker, rest


def build_space(priors):
    """Build a Space from a {name: prior_expr} mapping (markers stripped)."""
    space = Space()
    for name, expr in priors.items():
        marker, clean = split_marker(expr)
        if marker == ">":
            # rename marker `old~>new` — handled by EVC, not a prior
            continue
        space.register(build_dimension(name, clean))
    return space
