"""Search-space layer of the port: dimensions, Space container, prior DSL
(mirrors ``orion_tpu.space``; host codecs only)."""

from orion_tpu_torch.space.dims import (
    Categorical,
    Dimension,
    Fidelity,
    Integer,
    NotSet,
    Real,
)
from orion_tpu_torch.space.dsl import DSLError, build_dimension, build_space, split_marker
from orion_tpu_torch.space.space import Space

__all__ = [
    "Categorical",
    "Dimension",
    "DSLError",
    "Fidelity",
    "Integer",
    "NotSet",
    "Real",
    "Space",
    "build_dimension",
    "build_space",
    "split_marker",
]
