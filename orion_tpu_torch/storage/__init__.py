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
- ``network`` — :class:`~orion_tpu_torch.storage.netdb.NetworkDB`, a client
  of an ``orion-tpu-torch db serve`` process (or of the reference's server:
  the wire is the same), with replication and a quorum on the server side.
- ``shards:`` — :class:`~orion_tpu_torch.storage.shard.ShardedNetworkDB`,
  the consistent-hash router over replicated network shards.

The day-2 operations on a sharded topology are
:mod:`~orion_tpu_torch.storage.rebalance`, :mod:`~orion_tpu_torch.storage.drain`
and :mod:`~orion_tpu_torch.storage.backup`; fault injection and the soak
harness are :mod:`~orion_tpu_torch.storage.faults` and
:mod:`~orion_tpu_torch.storage.soak`; the audit is
:mod:`orion_tpu_torch.storage.audit`.
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
from orion_tpu_torch.storage.netdb import DBServer, NetworkDB
from orion_tpu_torch.storage.retry import RetryPolicy, is_transient
from orion_tpu_torch.storage.shard import HashRing, ShardedNetworkDB

__all__ = [
    "BaseStorage",
    "DBServer",
    "DocumentStorage",
    "HashRing",
    "MemoryDB",
    "NetworkDB",
    "PickledDB",
    "ReadOnlyStorage",
    "RetryPolicy",
    "ShardedNetworkDB",
    "create_storage",
    "get_storage",
    "is_transient",
    "setup_storage",
]
