"""Durable single-file backend with cross-process locking (port of
``orion_tpu/storage/backends.py``).

Capability parity: reference `src/orion/core/io/database/pickleddb.py` — every
operation takes an advisory file lock, unpickles the in-memory DB, applies the
op, and atomically rewrites the file (write-to-temp + rename).  The reference
uses the `filelock` package with a 60s timeout; here the lock is `fcntl.flock`
on a sidecar ``<path>.lock`` file (stdlib-only, correct across processes on
one node — the same guarantee the reference offers).

Files are read through :class:`_DBUnpickler`, never a bare ``pickle.load``:
a file that ``orion_tpu`` wrote holds pickled
``orion_tpu.storage.documents.MemoryDB`` / ``Collection`` objects, and a
bare load would import ``orion_tpu`` (and with it JAX).  The unpickler maps
those two classes onto this package's and refuses every other
``orion_tpu.*`` name, so the port opens the reference's files.  The port
writes its own class paths: once the port has written a file, the
reference cannot read it.
"""

import contextlib
import errno
import fcntl
import os
import pickle
import tempfile
import time

from orion_tpu_torch.storage.documents import Collection, MemoryDB
from orion_tpu_torch.utils.exceptions import DatabaseError

DEFAULT_LOCK_TIMEOUT = 60.0

#: Classes of a reference-written file and the port's classes they load as.
_REFERENCE_CLASSES = {
    ("orion_tpu.storage.documents", "MemoryDB"): MemoryDB,
    ("orion_tpu.storage.documents", "Collection"): Collection,
}


class LockAcquisitionTimeout(DatabaseError):
    """Could not obtain the database file lock in time."""


def atomic_pickle_dump(path, obj):
    """Pickle ``obj`` to ``path`` atomically (tempfile in the target dir +
    rename)."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=dirname, prefix=".dbtmp-")
    try:
        with os.fdopen(fd, "wb") as handle:
            pickle.dump(obj, handle)
        os.replace(tmp, path)  # atomic on POSIX
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


class _DBUnpickler(pickle.Unpickler):
    """Loads the port's own files as they are and the reference's through
    :data:`_REFERENCE_CLASSES`; any other ``orion_tpu`` class is refused."""

    def find_class(self, module, name):
        if module == "orion_tpu" or module.startswith("orion_tpu."):
            cls = _REFERENCE_CLASSES.get((module, name))
            if cls is None:
                raise DatabaseError(
                    f"cannot load {module}.{name}: a database file may hold "
                    "orion_tpu's MemoryDB and Collection only"
                )
            return cls
        return super().find_class(module, name)


@contextlib.contextmanager
def _file_lock(lock_path, timeout=DEFAULT_LOCK_TIMEOUT, poll=0.01):
    fd = os.open(lock_path, os.O_CREAT | os.O_RDWR)
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError as exc:
                if exc.errno not in (errno.EAGAIN, errno.EACCES, errno.EWOULDBLOCK):
                    raise  # real flock failure (e.g. ENOLCK) — don't mask as timeout
                if time.monotonic() >= deadline:
                    raise LockAcquisitionTimeout(
                        f"could not lock {lock_path} within {timeout}s"
                    )
                time.sleep(poll)
        yield
    finally:
        with contextlib.suppress(OSError):
            fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


class PickledDB:
    """File-backed document DB; safe for many concurrent worker processes."""

    def __init__(self, path, lock_timeout=DEFAULT_LOCK_TIMEOUT):
        self.path = os.path.abspath(os.path.expanduser(path))
        self.lock_timeout = lock_timeout
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # Index definitions must survive reloads, so they are applied to the
        # pickled state itself on every ensure_index.

    @property
    def _lock_path(self):
        return self.path + ".lock"

    def _load(self):
        if not os.path.exists(self.path) or os.path.getsize(self.path) == 0:
            return MemoryDB()
        with open(self.path, "rb") as handle:
            return _DBUnpickler(handle).load()

    def _dump(self, db):
        atomic_pickle_dump(self.path, db)

    @contextlib.contextmanager
    def _locked(self, write=True):
        with _file_lock(self._lock_path, timeout=self.lock_timeout):
            db = self._load()
            yield db
            if write:
                self._dump(db)

    # --- AbstractDB contract ------------------------------------------------
    def ensure_index(self, collection, keys, unique=False):
        with self._locked() as db:
            db.ensure_index(collection, keys, unique=unique)

    def ensure_indexes(self, specs):
        """All index definitions in ONE lock/load/dump cycle (worker startup
        happens per process; five separate cycles would rewrite the whole DB
        file five times under the shared lock)."""
        with self._locked() as db:
            db.ensure_indexes(specs)

    def index_information(self, collection):
        with self._locked(write=False) as db:
            return db.index_information(collection)

    def drop_index(self, collection, name):
        with self._locked() as db:
            db.drop_index(collection, name)

    def write(self, collection, data, query=None):
        with self._locked() as db:
            return db.write(collection, data, query)

    def update_many(self, collection, pairs):
        with self._locked() as db:
            return db.update_many(collection, pairs)

    def apply_batch(self, ops):
        """The whole batch in ONE lock/load/dump cycle (see
        MemoryDB.apply_batch for the outcome contract).  A q-batch
        registration otherwise pays q full unpickle+rewrite cycles — the
        dominant cost of this backend.  Successful slots persist even when
        a later slot fails (matching the sequential path: MemoryDB's
        insert checks uniqueness before mutating, so a failed slot leaves
        no partial state in the dumped snapshot)."""
        with self._locked() as db:
            return db.apply_batch(ops)

    def collection_names(self):
        """Enumeration surface shared by every backend (replication
        snapshots, `db dump`): one lock/load cycle over the inner store."""
        with self._locked(write=False) as db:
            return db.collection_names()

    def index_specs(self):
        with self._locked(write=False) as db:
            return db.index_specs()

    def read(self, collection, query=None, projection=None):
        with self._locked(write=False) as db:
            return db.read(collection, query, projection)

    def read_and_write(self, collection, query, data):
        with self._locked() as db:
            return db.read_and_write(collection, query, data)

    def count(self, collection, query=None):
        with self._locked(write=False) as db:
            return db.count(collection, query)

    def remove(self, collection, query=None):
        with self._locked() as db:
            return db.remove(collection, query)
