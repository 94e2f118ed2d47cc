"""Storage: the coordination backend (port of ``orion_tpu/storage``).

All inter-worker communication — trial queue, reservation locking,
heartbeats, experiment configs — flows through a shared document store.
Backends of the port:

- ``memory`` — in-process, for tests and single-process runs.
- ``pickled`` — single file + advisory file lock, multi-process safe on one
  node; the default.  It also opens files that ``orion_tpu`` wrote
  (:func:`orion_tpu_torch.convert.storage_from_jax`).
- ``sqlite`` — one SQLite file, row-level transactions; files cross between
  the two packages in both directions.

The reference's ``network`` backend, its sharded router and fault injection
are ROADMAP queue A item 7; the audit is :mod:`orion_tpu_torch.storage.audit`.
"""

from orion_tpu_torch.storage.backends import PickledDB
from orion_tpu_torch.storage.base import (
    BaseStorage,
    DocumentStorage,
    ReadOnlyStorage,
    create_storage,
    get_storage,
    setup_storage,
)
from orion_tpu_torch.storage.documents import MemoryDB
from orion_tpu_torch.storage.retry import RetryPolicy, is_transient

__all__ = [
    "BaseStorage",
    "DocumentStorage",
    "MemoryDB",
    "PickledDB",
    "ReadOnlyStorage",
    "RetryPolicy",
    "create_storage",
    "get_storage",
    "is_transient",
    "setup_storage",
]
