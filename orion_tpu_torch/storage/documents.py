"""In-memory Mongo-flavored document store (port of
``orion_tpu/storage/documents.py``, copied as it is).

Capability parity: reference `src/orion/core/io/database/ephemeraldb.py`
(collections of flattened documents, unique indexes with duplicate detection,
query operators ``$ne,$in,$gte,$gt,$lte,$lt``, projection semantics) and the
`AbstractDB` contract from `src/orion/core/io/database/__init__.py`
(read/write/read_and_write/count/remove/ensure_index + DuplicateKeyError).

This is the reference model for correctness; the pickled file backend wraps
one of these under a cross-process file lock.
"""

import copy
import json
import threading

from orion_tpu_torch.utils.exceptions import DatabaseError, DuplicateKeyError


def json_default(value):
    """Tolerate numpy scalars/arrays in documents (params carry them)."""
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return value.item()
        except Exception:
            pass
    tolist = getattr(value, "tolist", None)
    if callable(tolist):
        return value.tolist()
    raise TypeError(f"not JSON serializable: {type(value)}")


def dumps_canonical(value):
    """Canonical JSON form of a document: sorted keys, numpy tolerated.
    Shared by the sqlite backend (row payloads, unique-index keys) and
    `db copy` (content comparison across backend representations)."""
    return json.dumps(value, sort_keys=True, default=json_default)


def index_key(doc, fields):
    """Canonical key of a document under a (possibly dotted) field tuple —
    the key function every backend's unique-index enforcement agrees on."""
    return dumps_canonical([_get_path(doc, f)[1] for f in fields])

def _ordered(op):
    """Range operators never raise on incomparable types — they just don't
    match.  A list-valued field meeting ``{$gte: 2}`` must behave the same
    on every backend; letting TypeError escape made the in-process backends
    raise it while the network server translated it into a DatabaseError —
    a per-backend divergence (found by the differential fuzzer) and a way
    for one malformed query to break a shared server's request loop."""

    def safe(doc_val, qv):
        if doc_val is None:
            return False
        try:
            # bool() inside the try: numpy-array field values make the
            # comparison return an elementwise array whose truthiness
            # raises LATER (outside any guard) — force the ValueError here.
            return bool(op(doc_val, qv))
        except (TypeError, ValueError):
            return False

    return safe


def _in(doc_val, qv):
    try:
        return bool(doc_val in qv)
    except (TypeError, ValueError):
        return False


_OPS = {
    "$ne": lambda doc_val, qv: doc_val != qv,
    "$in": _in,
    "$gte": _ordered(lambda a, b: a >= b),
    "$gt": _ordered(lambda a, b: a > b),
    "$lte": _ordered(lambda a, b: a <= b),
    "$lt": _ordered(lambda a, b: a < b),
}


def _plain_value(value):
    """Numpy values normalize to their python list/scalar form BEFORE any
    comparison, so the in-process backends judge queries on exactly what
    the sqlite/network backends stored (those serialize through JSON on
    write).  Without this, {'a': np.array(...)} matched {'a': {'$ne': 2}}
    differently per backend — and equality raised ValueError at
    array-truthiness time (differential-fuzzer find, extended by review)."""
    tolist = getattr(value, "tolist", None)
    if callable(tolist) and not isinstance(value, (str, bytes, list, dict)):
        try:
            return value.tolist()
        except Exception:  # pragma: no cover - exotic array-likes
            return value
    return value


def _match_value(doc_val, query_val):
    doc_val = _plain_value(doc_val)
    if isinstance(query_val, dict) and any(k.startswith("$") for k in query_val):
        return all(_OPS[op](doc_val, qv) for op, qv in query_val.items())
    try:
        return bool(doc_val == query_val)
    except ValueError:  # pragma: no cover - array-likes without tolist
        return False


def _matches(nested_doc, query):
    """Match a query against a nested document, walking dotted paths
    directly — flattening the whole document per candidate per query was the
    dominant cost of every collection scan at q-batch scale."""
    for key, qv in (query or {}).items():
        found, value = _get_path(nested_doc, key)
        if not _match_value(value if found else None, qv):
            return False
    return True


def _get_path(doc, dotted):
    """Resolve a dotted path against nested dicts; literal keys win first."""
    if dotted in doc:
        return True, doc[dotted]
    node = doc
    for part in dotted.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return False, None
    return True, node


def _hashable(value):
    try:
        hash(value)
        return value
    except TypeError:
        return repr(value)


class _Unhashable:
    """Sentinel bucket key for value maps: repr() is not canonical under
    equality ([1] == [1.0] but their reprs differ), so unhashable stored
    values all share one bucket that every narrowed scan includes."""


def _value_map_key(value):
    try:
        hash(value)
        return value
    except TypeError:
        return _Unhashable


def _set_path(doc, dotted, value):
    parts = dotted.split(".")
    node = doc
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


_SCALAR_TYPES = frozenset((str, int, float, bool, type(None)))


def _copy_doc(value):
    """Deep copy for JSON-like documents (dict/list/scalars) without
    copy.deepcopy's dispatch+memo machinery — which dominated the in-memory
    backend's profile (28 s of a 32 s q=512 ackley50 run was deepcopy).
    Documents are acyclic JSON-ish trees, so direct recursion is safe;
    exotic node values (numpy arrays, tuples, sets) fall back per-node.
    Scalar leaves are handled inline in the comprehensions — most nodes of
    a trial document are {name,type,value} leaves, and a function call per
    scalar is the bulk of the copy cost at q-batch scale."""
    tv = type(value)
    if tv is dict:
        return {
            k: (v if type(v) in _SCALAR_TYPES else _copy_doc(v))
            for k, v in value.items()
        }
    if tv is list:
        return [v if type(v) in _SCALAR_TYPES else _copy_doc(v) for v in value]
    if tv in _SCALAR_TYPES:
        return value
    return copy.deepcopy(value)


def _project(nested_doc, projection):
    """Inclusion-style projection walking dotted paths directly — documents
    with literal "." in keys are returned byte-identical, never restructured."""
    if not projection:
        return _copy_doc(nested_doc)
    keep_id = projection.get("_id", 1)
    selected = {k for k, v in projection.items() if v and k != "_id"}
    out = {}
    for key in selected:
        found, value = _get_path(nested_doc, key)
        if found:
            if key in nested_doc:
                out[key] = _copy_doc(value)
            else:
                _set_path(out, key, _copy_doc(value))
    if keep_id and "_id" in nested_doc:
        out["_id"] = nested_doc["_id"]
    return out


def apply_update(doc, update):
    """Return a new doc with a Mongo-style update applied; ``doc`` is never
    mutated.

    Copy-on-write along the updated paths only: the returned doc SHARES
    every unmodified subtree with ``doc``.  That is safe because every
    caller replaces the stored doc with the result and discards the old one
    (reads hand out `_copy_doc`/`_project` copies, and indexes reference
    `_id`s, not subtrees) — and it is what keeps a 2-field status update
    from deep-copying a several-hundred-node trial document (a 2048-trial
    ackley50 sweep spends ~35% of its host wall in `_copy_doc` otherwise,
    most of it under updates).

    Walks dotted update keys into the nested doc directly — never
    flatten/unflatten the whole document, which would restructure any
    stored key that itself contains a "." (e.g. a param named "opt.lr").
    Shared by every backend (memory/pickled/network/sqlite) so update
    semantics cannot diverge."""
    sets = update.get("$set") if any(k.startswith("$") for k in update) else update
    unsets = update.get("$unset", {})
    new_doc = dict(doc)
    for key, value in (sets or {}).items():
        parts = key.split(".")
        node = new_doc
        for part in parts[:-1]:
            child = node.get(part)
            # Shallow-copy the dict on the path (COW); anything else is
            # replaced by {} (previous behavior).  Re-copying a dict this
            # update already copied is redundant but harmless.
            node[part] = dict(child) if isinstance(child, dict) else {}
            node = node[part]
        node[parts[-1]] = _copy_doc(value)
    for key in unsets:
        parts = key.split(".")
        # Read-only probe first: an absent final key must stay an
        # allocation-free no-op — the COW walk below copies every dict on
        # the path, which would manufacture garbage for a no-op update.
        probe = new_doc
        for part in parts[:-1]:
            probe = probe.get(part) if isinstance(probe, dict) else None
        if not isinstance(probe, dict) or parts[-1] not in probe:
            continue
        node = new_doc
        for part in parts[:-1]:
            node[part] = dict(node[part])
            node = node[part]
        node.pop(parts[-1], None)
    return new_doc


class Collection:
    """One named collection of documents with unique-index enforcement."""

    def __init__(self):
        self._docs = {}  # _id -> nested document
        self._indexes = {}  # name -> (tuple of fields, unique)
        self._unique_maps = {}  # fields -> {index key -> _id}; O(1) dup checks
        # field -> {value key -> {_id: None}} for single-field indexes:
        # narrows scans for equality/$in queries on indexed fields (the
        # reservation hot path filters on status — a full _matches scan per
        # reservation is O(trials^2) over a q-batch run).  Ordered dicts so
        # candidate order stays deterministic.
        self._value_maps = {}
        self._auto_id = 0

    def __getstate__(self):
        # The hash indexes are derivable from docs+indexes: dropping them
        # keeps pickled snapshots from growing with every distinct value,
        # at an O(n) rebuild-on-load cost (__setstate__).
        state = self.__dict__.copy()
        state.pop("_unique_maps", None)
        state.pop("_value_maps", None)
        return state

    def __setstate__(self, state):
        # DB files pickled by versions that predate the hash indexes must
        # keep loading: rebuild them from the stored docs/indexes.
        self.__dict__.update(state)
        if "_unique_maps" not in self.__dict__:
            self._unique_maps = {}
            for fields, unique in self._indexes.values():
                if unique and fields not in self._unique_maps:
                    self._unique_maps[fields] = self._build_unique_map(fields)
        if "_value_maps" not in self.__dict__:
            self._value_maps = {}
            for fields, _unique in self._indexes.values():
                if len(fields) == 1:
                    self._rebuild_value_map(fields[0])

    # --- indexes ----------------------------------------------------------
    def ensure_index(self, keys, unique=False):
        fields = tuple(k[0] if isinstance(k, (tuple, list)) else k for k in keys)
        name = "_".join(fields) + "_1"
        self._indexes[name] = (fields, unique)
        if unique and fields not in self._unique_maps:
            self._unique_maps[fields] = self._build_unique_map(fields)
        elif not unique:
            # Redefined unique -> non-unique: stop enforcing uniqueness.
            # (Index names are a pure function of the fields tuple, so this
            # entry is the only one that can cover these fields.)
            self._unique_maps.pop(fields, None)
        if len(fields) == 1 and fields[0] not in self._value_maps:
            self._rebuild_value_map(fields[0])

    def _rebuild_value_map(self, field):
        entries = {}
        for _id, doc in self._docs.items():
            key = _value_map_key(_get_path(doc, field)[1])
            entries.setdefault(key, {})[_id] = None
        self._value_maps[field] = entries

    def _build_unique_map(self, fields):
        return {
            self._index_key(doc, fields): _id for _id, doc in self._docs.items()
        }

    def index_information(self):
        return {name: unique for name, (_, unique) in self._indexes.items()}

    def drop_index(self, name):
        if name not in self._indexes:
            raise KeyError(f"index not found: {name}")
        fields, unique = self._indexes.pop(name)
        if unique and not any(
            f == fields and u for f, u in self._indexes.values()
        ):
            self._unique_maps.pop(fields, None)
        if len(fields) == 1:
            self._value_maps.pop(fields[0], None)

    def _index_key(self, doc, fields):
        return tuple(_hashable(_get_path(doc, f)[1]) for f in fields)

    def _check_unique(self, doc, ignore_id=None):
        for fields, entries in self._unique_maps.items():
            other = entries.get(self._index_key(doc, fields))
            if other is not None and other != ignore_id:
                raise DuplicateKeyError(
                    f"duplicate key on index {fields}"
                )

    def _unique_keys(self, doc):
        """One ``_index_key`` computation per unique index, shared by the
        duplicate check AND the index insert — ``insert`` previously paid
        the dotted-path walk + canonicalization twice per document, which
        is pure overhead at q-batch registration scale."""
        return [
            (fields, entries, self._index_key(doc, fields))
            for fields, entries in self._unique_maps.items()
        ]

    def _index_add(self, doc):
        for fields, entries in self._unique_maps.items():
            entries[self._index_key(doc, fields)] = doc["_id"]
        for field, entries in self._value_maps.items():
            key = _value_map_key(_get_path(doc, field)[1])
            entries.setdefault(key, {})[doc["_id"]] = None

    def _index_discard(self, doc):
        for fields, entries in self._unique_maps.items():
            key = self._index_key(doc, fields)
            if entries.get(key) == doc["_id"]:
                del entries[key]
        for field, entries in self._value_maps.items():
            key = _value_map_key(_get_path(doc, field)[1])
            bucket = entries.get(key)
            if bucket is not None:
                bucket.pop(doc["_id"], None)
                if not bucket:
                    del entries[key]  # maps must not grow with history

    # --- CRUD --------------------------------------------------------------
    def insert(self, doc):
        doc = _copy_doc(doc)
        if "_id" not in doc:
            self._auto_id += 1
            doc["_id"] = self._auto_id
        _id = doc["_id"]
        if _id in self._docs:
            raise DuplicateKeyError(f"duplicate _id {_id!r}")
        # Compute each unique-index key ONCE, check-then-add with the same
        # values (the q-batch register path inserts q docs back to back).
        unique_keys = self._unique_keys(doc)
        for fields, entries, key in unique_keys:
            if entries.get(key) is not None:
                raise DuplicateKeyError(f"duplicate key on index {fields}")
        self._docs[_id] = doc
        for _fields, entries, key in unique_keys:
            entries[key] = _id
        for field, entries in self._value_maps.items():
            key = _value_map_key(_get_path(doc, field)[1])
            entries.setdefault(key, {})[_id] = None
        return _id

    def _candidates(self, query):
        """Docs possibly matching: O(1) for point queries by _id; narrowed
        through the value maps for equality/$in on indexed fields (every
        candidate still passes through `_matches` — this only prunes)."""
        _id = (query or {}).get("_id")
        if _id is not None and not isinstance(_id, dict):
            doc = self._docs.get(_id)
            return [doc] if doc is not None else []
        # Pick the cheapest indexed key by bucket sizes FIRST; materialize
        # only the winner (merging every key's buckets would copy the full
        # per-experiment id set on each reservation — O(trials^2) again).
        best_key = None
        best_size = None
        candidates = {}
        for key, qv in (query or {}).items():
            entries = self._value_maps.get(key)
            if entries is None:
                continue
            if isinstance(qv, dict):
                if set(qv) != {"$in"}:
                    continue
                values = qv["$in"]
            else:
                values = [qv]
            try:
                for v in values:
                    hash(v)
            except TypeError:
                continue  # unhashable query value: repr isn't canonical
            size = sum(len(entries.get(v, ())) for v in values) + len(
                entries.get(_Unhashable, ())
            )
            if best_size is None or size < best_size:
                best_key, best_size, candidates = key, size, (entries, values)
        if best_key is None:
            return self._docs.values()
        entries, values = candidates
        ids = {}
        for value in values:
            ids.update(entries.get(value, {}))
        ids.update(entries.get(_Unhashable, {}))
        return [self._docs[i] for i in ids if i in self._docs]

    def find(self, query=None, projection=None):
        out = []
        for doc in self._candidates(query):
            if _matches(doc, query):
                out.append(_project(doc, projection))
        return out

    def update(self, query, update, many=True):
        count = 0
        for doc in list(self._candidates(query)):
            if not _matches(doc, query):
                continue
            _id = doc["_id"]
            new_doc = apply_update(doc, update)
            new_doc["_id"] = _id
            self._check_unique(new_doc, ignore_id=_id)
            self._index_discard(doc)
            self._docs[_id] = new_doc
            self._index_add(new_doc)
            count += 1
            if not many:
                break
        return count

    def find_one_and_update(self, query, update, return_new=True):
        """Atomic single-document compare-and-swap (the sync primitive)."""
        for doc in self._candidates(query):
            if _matches(doc, query):
                _id = doc["_id"]
                new_doc = apply_update(doc, update)
                new_doc["_id"] = _id
                self._check_unique(new_doc, ignore_id=_id)
                self._index_discard(doc)
                self._docs[_id] = new_doc
                self._index_add(new_doc)
                return _copy_doc(new_doc if return_new else doc)
        return None

    def count(self, query=None):
        # No projection/copy per match — the producer's count-gated sync
        # calls this every round; it must cost a scan, not allocations.
        return sum(
            1 for doc in self._candidates(query) if _matches(doc, query)
        )

    def remove(self, query=None):
        doomed = [
            doc["_id"] for doc in self._candidates(query) if _matches(doc, query)
        ]
        for _id in doomed:
            self._index_discard(self._docs[_id])
            del self._docs[_id]
        return len(doomed)


class MemoryDB:
    """Thread-safe in-memory database of named collections."""

    #: A count/targeted query costs a scan here, not a full-DB reload —
    #: the producer's count-gated sync keys on this (see Producer.update).
    cheap_counts = True

    def __init__(self):
        self._collections = {}
        self._lock = threading.RLock()

    def __getstate__(self):
        # The RLock is process-local; the pickled backend provides its own
        # cross-process file lock.
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.RLock()

    def _col(self, name):
        if name not in self._collections:
            self._collections[name] = Collection()
        return self._collections[name]

    def collection_names(self):
        """Every collection this store holds — the enumeration surface the
        netdb replication snapshot and `db dump` walk (every backend offers
        it so full-state transfer never needs backend-specific probing)."""
        with self._lock:
            return sorted(self._collections)

    def index_specs(self):
        """``[(collection, [field, ...], unique), ...]`` for every declared
        index — the shape ``ensure_index`` accepts, so a snapshot resync
        can rebuild the index layout verbatim."""
        with self._lock:
            out = []
            for name in sorted(self._collections):
                for fields, unique in self._collections[name]._indexes.values():
                    out.append((name, list(fields), unique))
            return out

    # AbstractDB-style contract (reference `database/__init__.py:23-264`)
    def ensure_index(self, collection, keys, unique=False):
        with self._lock:
            self._col(collection).ensure_index(keys, unique=unique)

    def ensure_indexes(self, specs):
        """Batched index setup: [(collection, keys, unique), ...] in one pass."""
        with self._lock:
            for collection, keys, unique in specs:
                self._col(collection).ensure_index(keys, unique=unique)

    def index_information(self, collection):
        with self._lock:
            return self._col(collection).index_information()

    def drop_index(self, collection, name):
        with self._lock:
            self._col(collection).drop_index(name)

    def write(self, collection, data, query=None):
        """Insert when no query; update-many when query given."""
        with self._lock:
            return self._write_locked(collection, data, query)

    def update_many(self, collection, pairs):
        """Apply ``[(query, update), ...]`` in order; returns the total
        matched count.  One lock here, one lock/load/dump cycle on the
        pickled wrapper, one transaction on SQL, one pipelined round trip
        on the network backend — the batched-update path schema migrations
        (`db upgrade`) use instead of a write (and a full file rewrite on
        file-backed stores) per document.

        Mid-batch failure semantics are backend-dependent, so callers must
        be idempotent-re-runnable (the migration updates are): memory keeps
        the applied prefix, pickled and SQLite discard the whole batch
        (the pickled wrapper only dumps its state after a clean run;
        SQLite's transaction rolls back), and the network backend applies
        every non-failing pair before raising the first failure (the
        pipeline is fully drained)."""
        with self._lock:
            col = self._col(collection)
            return sum(col.update(q, u, many=True) for q, u in pairs)

    #: Sub-operations apply_batch accepts — the write-cycle subset of the
    #: contract (index management stays per-op: it is startup-time work and
    #: its KeyError semantics don't fit slot outcomes).
    BATCH_OPS = frozenset({"write", "read", "read_and_write", "count", "remove"})

    def apply_batch(self, ops):
        """Apply ``[(op, args, kwargs), ...]`` as ONE atomic unit with
        respect to other clients: the lock is taken once for the whole
        batch, so no concurrent writer interleaves between slots.  Returns
        one outcome per op — the op's result, or the exception instance it
        raised (slot independence: a DuplicateKeyError in slot 3 says
        nothing about slot 4).  This is the backend primitive the batched
        storage write path (register_trials & friends) commits through —
        one lock here, one transaction on SQL, one wire round trip on the
        network backend, one load/dump cycle on the pickled file.

        An op name outside BATCH_OPS is a programming error and rejects
        the WHOLE batch before anything applies (every backend and the
        network server agree on this upfront validation)."""
        for op, _args, _kwargs in ops:
            if op not in self.BATCH_OPS:
                raise DatabaseError(f"bad batch op {op!r}")
        out = []
        with self._lock:
            for op, args, kwargs in ops:
                try:
                    out.append(getattr(self, f"_{op}_locked")(*args, **kwargs))
                except Exception as exc:
                    out.append(exc)
        return out

    def _write_locked(self, collection, data, query=None):
        col = self._col(collection)
        if query is None:
            if isinstance(data, (list, tuple)):
                return [col.insert(doc) for doc in data]
            return col.insert(data)
        return col.update(query, data, many=True)

    def _read_locked(self, collection, query=None, projection=None):
        return self._col(collection).find(query, projection)

    def _read_and_write_locked(self, collection, query, data):
        return self._col(collection).find_one_and_update(query, data)

    def _count_locked(self, collection, query=None):
        return self._col(collection).count(query)

    def _remove_locked(self, collection, query=None):
        return self._col(collection).remove(query)

    def read(self, collection, query=None, projection=None):
        with self._lock:
            return self._read_locked(collection, query, projection)

    def read_and_write(self, collection, query, data):
        with self._lock:
            return self._read_and_write_locked(collection, query, data)

    def count(self, collection, query=None):
        with self._lock:
            return self._count_locked(collection, query)

    def remove(self, collection, query=None):
        with self._lock:
            return self._remove_locked(collection, query)
