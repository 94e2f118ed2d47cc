"""SQLite document database — durable multi-process storage without a server
(port of ``orion_tpu/storage/sqlitedb.py``, with its ``storage.sqlite.txn``
telemetry histogram, and with an index over the fields the worker loop filters on: see
``_FIELD_INDEXES``).  The file holds JSON documents in SQL and no class paths,
so a file either package writes opens in the other.

Fills the slot the reference covers with PickledDB (whole-file flock +
unpickle per op, `src/orion/core/io/database/pickleddb.py:162-207`) but with
row-granular writes and real cross-process atomicity: WAL mode lets readers
proceed under a writer, `BEGIN IMMEDIATE` serializes compare-and-swap
reservations, and uniqueness is enforced by an actual UNIQUE constraint (a
durable mirror of the in-memory backend's hash indexes), so concurrent
workers get `DuplicateKeyError` from the database itself rather than from an
advisory lock.

Document semantics (dotted-path queries/updates, `$in`/`$gte`/... operators,
projections) are shared with the in-memory backend — same helpers, same
behavior, one contract test suite over both.
"""

import functools
import heapq
import json
import operator
import sqlite3
import threading
import time

from orion_tpu_torch.storage.documents import (
    MemoryDB,
    apply_update,
    dumps_canonical as _dumps,
    index_key as _index_key,
    _matches,
    _project,
)
from orion_tpu_torch.telemetry import TELEMETRY
from orion_tpu_torch.utils.exceptions import DatabaseError, DuplicateKeyError


def _translate_errors(method):
    """Raw sqlite3 errors -> the unified DatabaseError family, so callers
    handling lock contention / corrupt files behave the same across
    backends (exceptions.py unifies storage errors by design)."""

    @functools.wraps(method)
    def wrapper(*args, **kwargs):
        try:
            return method(*args, **kwargs)
        except sqlite3.Error as exc:
            raise DatabaseError(f"sqlite: {exc}") from exc

    return wrapper

_SCHEMA = """
CREATE TABLE IF NOT EXISTS docs (
    collection TEXT NOT NULL,
    id TEXT NOT NULL,
    doc TEXT NOT NULL,
    PRIMARY KEY (collection, id)
);
CREATE TABLE IF NOT EXISTS idx_meta (
    collection TEXT NOT NULL,
    name TEXT NOT NULL,
    fields TEXT NOT NULL,
    is_unique INTEGER NOT NULL,
    PRIMARY KEY (collection, name)
);
CREATE TABLE IF NOT EXISTS unique_keys (
    collection TEXT NOT NULL,
    fields TEXT NOT NULL,
    key TEXT NOT NULL,
    id TEXT NOT NULL,
    PRIMARY KEY (collection, fields, key)
);
CREATE TABLE IF NOT EXISTS counters (
    collection TEXT PRIMARY KEY,
    next_id INTEGER NOT NULL
);
"""


#: The worker loop filters on ``experiment`` and ``status`` for every trial
#: (the reservation claim, the ``is_done``/``is_broken`` counts).  Where the
#: reference scans the collection, parsing every document, the port keeps an
#: index over the two fields, and the prefilter names their paths as
#: literals so that the planner matches it (``id`` last: scans return rows
#: in ``id`` order, as the reference's do).  A trial document carries its
#: round's lineage (1024 parent ids at q=1024, ~36 KB), so a scan of 9216
#: such trials parses ~330 MB of JSON: eight workers on one file spent
#: their time waiting on each other's scans.
#:
#: Python writes non-finite floats as the bare tokens NaN and Infinity.
#: SQLite below 3.42 cannot parse them, so an index computing
#: ``json_extract`` over every document made each insert or update of such
#: a document fail there (``malformed JSON``), whichever package wrote it.
#: Both indexes are therefore partial on ``json_valid(doc)``, which every
#: SQLite with JSON functions answers alike (RFC 8259: false for NaN, also
#: where JSON5 parses): the field index covers the documents that are
#: standard JSON, and the second index lists the others in ``id`` order, so
#: that a scan reads each part by its index and merges them by ``id``.
#: Neither index evaluates ``json_extract`` on a document it cannot parse,
#: so any SQLite, and the reference's code, writes to a file that has them.
#: The nonstandard documents are narrowed by their text instead
#: (``_text_prefilter``), so that a hunt whose objectives are often NaN
#: does not parse all of them in every count and reservation.
_INDEXED_FIELDS = ("experiment", "status")
_VALID_JSON = "json_valid(doc)"
_FIELD_INDEXES = (
    "CREATE INDEX IF NOT EXISTS docs_valid_experiment_status ON docs (collection, "
    + ", ".join(f"json_extract(doc, '$.{field}')" for field in _INDEXED_FIELDS)
    + f", id) WHERE {_VALID_JSON}",
    "CREATE INDEX IF NOT EXISTS docs_nonstandard_json ON docs (collection, id) "
    f"WHERE NOT {_VALID_JSON}",
)
#: The full index of earlier versions of this module, dropped on open: it
#: computed ``json_extract`` over every document.
_LEGACY_INDEX = "docs_experiment_status"


def _id_key(_id):
    """Canonical string form of a document id (ids are ints or strings)."""
    return _dumps(_id)


def sqlite_path_selected(path):
    """Should ``path`` use the SQLite backend?  An EXISTING file is
    identified by its 16-byte header (a pickle snapshot named results.db
    must keep loading as pickled — extension sniffing alone would hand
    pickle bytes to sqlite3); only new files go by extension.  Shared by
    the CLI --storage-path routing and the network server's --persist."""
    import os

    if os.path.exists(path) and os.path.getsize(path) > 0:
        with open(path, "rb") as f:
            return f.read(16).startswith(b"SQLite format 3\x00")
    # Nonexistent OR empty: sqlite3.connect creates the file zero-byte before
    # the first schema commit writes the header, so a crash in that window
    # must not silently flip a *.sqlite path to the pickle format.
    return path.endswith((".sqlite", ".sqlite3", ".db"))


class SQLiteDB:
    """AbstractDB-contract database over a single SQLite file."""

    #: Counts/targeted queries are SQL-side — no full-DB reload per op
    #: (the producer's count-gated sync keys on this).
    cheap_counts = True

    def __init__(self, path, timeout=60.0):
        self._path = str(path)
        self._timeout = float(timeout)
        self._local = threading.local()
        #: Transactions opened since construction (each one COMMIT, i.e. one
        #: WAL sync cycle) — the instrument bench.py's storage breakdown
        #: reads to prove a q-batch registration costs O(1) transactions.
        #: Lock-guarded: connections are per-thread by design, so the
        #: counter must not lose increments across threads.
        self.txn_count = 0
        self._txn_count_lock = threading.Lock()
        with self._conn():  # create schema eagerly so first reads see tables
            pass

    # --- connection management --------------------------------------------
    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(
                self._path,
                timeout=self._timeout,
                isolation_level=None,  # explicit transaction control
            )
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            conn.executescript(_SCHEMA)
            conn.execute(f"DROP INDEX IF EXISTS {_LEGACY_INDEX}")
            for index in _FIELD_INDEXES:
                conn.execute(index)
            self._local.conn = conn
        return conn

    class _Txn:
        """IMMEDIATE transaction: the cross-process synchronization point.

        Wall time from BEGIN to COMMIT/ROLLBACK (lock wait + statements +
        WAL sync) feeds the ``storage.sqlite.txn`` telemetry histogram —
        the commit-latency signal next to the ``txn_count`` counter."""

        def __init__(self, conn):
            self.conn = conn
            self._t0 = None

        def __enter__(self):
            self._t0 = time.perf_counter() if TELEMETRY.enabled else None
            self.conn.execute("BEGIN IMMEDIATE")
            return self.conn

        def __exit__(self, exc_type, exc, tb):
            if exc_type is None:
                self.conn.execute("COMMIT")
            else:
                self.conn.execute("ROLLBACK")
            if self._t0 is not None:
                TELEMETRY.observe(
                    "storage.sqlite.txn", time.perf_counter() - self._t0
                )

    def _txn(self):
        with self._txn_count_lock:
            self.txn_count += 1
        return self._Txn(self._conn())

    # --- indexes -----------------------------------------------------------
    @_translate_errors
    def ensure_index(self, collection, keys, unique=False):
        fields = [k[0] if isinstance(k, (tuple, list)) else k for k in keys]
        name = "_".join(fields) + "_1"
        with self._txn() as conn:
            conn.execute(
                "INSERT OR REPLACE INTO idx_meta VALUES (?, ?, ?, ?)",
                (collection, name, _dumps(fields), int(unique)),
            )
            fields_key = _dumps(fields)
            if unique:
                # Backfill the durable unique map for existing documents.
                # Pre-existing duplicates are tolerated last-wins — the
                # memory/pickled backends do the same (_build_unique_map),
                # and storage construction must never make legacy data
                # unreadable; NEW duplicates are rejected from here on.
                for doc in self._scan(conn, collection):
                    conn.execute(
                        "INSERT OR REPLACE INTO unique_keys VALUES (?, ?, ?, ?)",
                        (
                            collection,
                            fields_key,
                            _index_key(doc, fields),
                            _id_key(doc["_id"]),
                        ),
                    )
            else:
                conn.execute(
                    "DELETE FROM unique_keys WHERE collection = ? AND fields = ?",
                    (collection, fields_key),
                )

    def ensure_indexes(self, specs):
        for collection, keys, unique in specs:
            self.ensure_index(collection, keys, unique=unique)

    @_translate_errors
    def index_information(self, collection):
        rows = self._conn().execute(
            "SELECT name, is_unique FROM idx_meta WHERE collection = ?",
            (collection,),
        )
        return {name: bool(u) for name, u in rows}

    @_translate_errors
    def drop_index(self, collection, name):
        with self._txn() as conn:
            row = conn.execute(
                "SELECT fields FROM idx_meta WHERE collection = ? AND name = ?",
                (collection, name),
            ).fetchone()
            if row is None:
                raise KeyError(f"index not found: {name}")
            conn.execute(
                "DELETE FROM idx_meta WHERE collection = ? AND name = ?",
                (collection, name),
            )
            conn.execute(
                "DELETE FROM unique_keys WHERE collection = ? AND fields = ?",
                (collection, row[0]),
            )

    @_translate_errors
    def collection_names(self):
        """Every collection present in documents OR index metadata — the
        enumeration surface the netdb replication snapshot and `db dump`
        walk (an indexed-but-empty collection must survive a resync)."""
        rows = self._conn().execute(
            "SELECT DISTINCT collection FROM docs "
            "UNION SELECT DISTINCT collection FROM idx_meta"
        )
        return sorted(name for (name,) in rows)

    @_translate_errors
    def index_specs(self):
        """``[(collection, [field, ...], unique), ...]`` in the shape
        ``ensure_index`` accepts (snapshot-resync rebuild surface)."""
        rows = self._conn().execute(
            "SELECT collection, fields, is_unique FROM idx_meta "
            "ORDER BY collection, name"
        )
        return [(col, json.loads(fields), bool(u)) for col, fields, u in rows]

    def _unique_specs(self, conn, collection):
        rows = conn.execute(
            "SELECT fields FROM idx_meta WHERE collection = ? AND is_unique = 1",
            (collection,),
        ).fetchall()
        return [json.loads(f) for (f,) in rows]

    # --- document plumbing -------------------------------------------------
    @staticmethod
    def _sql_prefilter(query):
        """SQL WHERE fragments for the simple top-level conditions of a
        query (equality / $in on scalar values) via json_extract, so hot
        scans — reservation filters on status — skip Python-parsing rows
        that cannot match.  Python `_matches` still runs afterwards; this
        only narrows, never decides."""
        def pushable(v):
            if isinstance(v, bool):
                return False  # json_extract yields 0/1, Python has True/False
            if isinstance(v, int):
                return -(2**63) <= v < 2**63  # sqlite INTEGER range
            return isinstance(v, (str, float))

        clauses, params = [], []
        for key, qv in (query or {}).items():
            if not key.isidentifier():  # dotted/odd keys: leave to _matches
                continue
            # A literal path (an identifier holds no quote), so that the
            # planner can match the field index.
            field = f"json_extract(doc, '$.{key}')"
            if pushable(qv):
                clauses.append(f"{field} = ?")
                params.append(qv)
            elif (
                isinstance(qv, dict)
                and set(qv) == {"$in"}
                and all(pushable(v) for v in qv["$in"])
            ):
                marks = ",".join("?" * len(qv["$in"]))
                clauses.append(f"{field} IN ({marks})")
                params.extend(qv["$in"])
        return clauses, params

    @staticmethod
    def _text_prefilter(query):
        """SQL WHERE fragments that narrow the documents SQLite cannot parse
        by their text: a top-level string condition (equality or ``$in``)
        can only hold where the document contains the value's JSON form, so
        ``instr`` drops the rest (another experiment's trials, a status
        that is not asked for) without a JSON parse.  Only strings that
        JSON writes as they are (no escapes) are pushed; ``_matches``
        still decides."""
        def literal(v):
            if not isinstance(v, str):
                return None
            text = json.dumps(v)
            return text if text[1:-1] == v else None

        clauses, params = [], []
        for key, qv in (query or {}).items():
            if not key.isidentifier():
                continue
            values = qv["$in"] if isinstance(qv, dict) and set(qv) == {"$in"} else [qv]
            texts = [literal(v) for v in values]
            if texts and None not in texts:
                clauses.append("(" + " OR ".join(["instr(doc, ?) > 0"] * len(texts)) + ")")
                params.extend(texts)
        return clauses, params

    def _nonstandard_sql(self, select, query):
        """``select`` over the documents that are not standard JSON, with
        the query's text prefilter, and its parameters."""
        clauses, params = self._text_prefilter(query)
        sql = f"{select} FROM docs WHERE collection = ? AND NOT {_VALID_JSON}"
        return " AND ".join([sql, *clauses]), params

    @staticmethod
    def _index_arms(query):
        """``query`` as the queries whose scans, merged by id, give its rows:
        with the field index, a status ``$in`` beside an experiment becomes
        one query per status, each an index range already in id order.  As
        one ``IN``, the ordered scan walks every document in id order,
        parsing each that no longer matches: a reservation late in a hunt
        parsed every trial already taken, holding the write lock."""
        query = query or {}
        statuses = query.get("status")
        if not (isinstance(query.get("experiment"), str)
                and isinstance(statuses, dict) and set(statuses) == {"$in"}
                and statuses["$in"] and all(isinstance(v, str) for v in statuses["$in"])):
            return [query]
        return [dict(query, status=value) for value in dict.fromkeys(statuses["$in"])]

    def _scan_iter(self, conn, collection, query=None):
        """Lazily yield parsed documents matching the query's SQL-pushable
        prefix (first-match paths stop early — read_and_write holds the
        exclusive write lock while scanning, so parsing the whole
        collection there would serialize every worker behind O(n) JSON
        work per reservation)."""
        _id = (query or {}).get("_id")
        if _id is not None and not isinstance(_id, dict):
            rows = conn.execute(
                "SELECT doc FROM docs WHERE collection = ? AND id = ?",
                (collection, _id_key(_id)),
            )
            for (d,) in rows:
                yield json.loads(d)
            return
        arms = [self._sql_prefilter(arm) for arm in self._index_arms(query)]
        split = any(clauses for clauses, _ in arms)
        statements = []
        for clauses, params in arms:
            if split:
                clauses = [_VALID_JSON, *clauses]
            sql = "SELECT id, doc FROM docs WHERE collection = ?"
            if clauses:
                sql += " AND " + " AND ".join(clauses)
            # The reference's order (its one index is the primary key),
            # whichever index the planner takes.
            statements.append((sql + " ORDER BY id", (collection, *params)))
        if split:
            # The documents SQLite cannot parse, narrowed by their text;
            # the caller's _matches decides for them.
            sql, params = self._nonstandard_sql("SELECT id, doc", query)
            statements.append((sql + " ORDER BY id", (collection, *params)))
        yielded = set()
        try:
            # Inside the try: a statement runs to its first row here.
            cursors = [conn.execute(sql, params) for sql, params in statements]
            rows = cursors[0] if len(cursors) == 1 else heapq.merge(
                *cursors, key=operator.itemgetter(0))
            for _, d in rows:
                doc = json.loads(d)
                yielded.add(_id_key(doc.get("_id")))
                yield doc
        except sqlite3.OperationalError:
            # A doc carrying a NaN/Infinity token (json.dumps emits them for
            # non-finite objectives) breaks SQLite's json_extract mid-scan;
            # Python json.loads accepts them, so finish with the unfiltered
            # scan + _matches, skipping rows already yielded.
            for (d,) in conn.execute(
                "SELECT doc FROM docs WHERE collection = ?", (collection,)
            ).fetchall():
                doc = json.loads(d)
                if _id_key(doc.get("_id")) not in yielded:
                    yield doc

    def _scan(self, conn, collection, query=None):
        """Materialized scan — required where the loop body mutates the
        table it is scanning (write/remove)."""
        return list(self._scan_iter(conn, collection, query))

    def _next_id(self, conn, collection):
        conn.execute(
            "INSERT INTO counters VALUES (?, 1) "
            "ON CONFLICT(collection) DO UPDATE SET next_id = next_id + 1",
            (collection,),
        )
        (value,) = conn.execute(
            "SELECT next_id FROM counters WHERE collection = ?", (collection,)
        ).fetchone()
        return value

    def _insert(self, conn, collection, doc):
        doc = json.loads(_dumps(doc))  # canonical JSON round-trip
        if "_id" not in doc:
            doc["_id"] = self._next_id(conn, collection)
        idk = _id_key(doc["_id"])
        for fields in self._unique_specs(conn, collection):
            try:
                conn.execute(
                    "INSERT INTO unique_keys VALUES (?, ?, ?, ?)",
                    (collection, _dumps(fields), _index_key(doc, fields), idk),
                )
            except sqlite3.IntegrityError:
                raise DuplicateKeyError(f"duplicate key on index {fields}")
        try:
            conn.execute(
                "INSERT INTO docs VALUES (?, ?, ?)", (collection, idk, _dumps(doc))
            )
        except sqlite3.IntegrityError:
            raise DuplicateKeyError(f"duplicate _id {doc['_id']!r}")
        return doc["_id"]

    def _replace(self, conn, collection, old_doc, new_doc):
        idk = _id_key(old_doc["_id"])
        for fields in self._unique_specs(conn, collection):
            fields_key = _dumps(fields)
            old_key = _index_key(old_doc, fields)
            new_key = _index_key(new_doc, fields)
            if old_key == new_key:
                continue
            conn.execute(
                "DELETE FROM unique_keys "
                "WHERE collection = ? AND fields = ? AND key = ? AND id = ?",
                (collection, fields_key, old_key, idk),
            )
            try:
                conn.execute(
                    "INSERT INTO unique_keys VALUES (?, ?, ?, ?)",
                    (collection, fields_key, new_key, idk),
                )
            except sqlite3.IntegrityError:
                raise DuplicateKeyError(f"duplicate key on index {fields}")
        conn.execute(
            "UPDATE docs SET doc = ? WHERE collection = ? AND id = ?",
            (_dumps(new_doc), collection, idk),
        )

    def _insert_many(self, conn, collection, docs):
        """Bulk insert inside the caller's transaction: per-doc outcomes
        (the new ``_id``, or the DuplicateKeyError that doc raised).

        The happy path is one ``executemany`` per statement — the q-batch
        registration shape the batched write path commits — under a single
        SAVEPOINT.  Any integrity conflict rolls that back (auto-id
        counter bumps included) and re-runs per-doc under individual
        SAVEPOINTs, so only the conflicting docs fail AND auto-assigned
        ids come out exactly as q sequential inserts would hand them out
        (a failed slot's counter bump rolls back with its savepoint on
        both paths).  A doc that cannot canonicalize to JSON fails its own
        slot with the TypeError the sequential write would raise — never
        the whole batch."""
        outcomes = [None] * len(docs)
        prepared = []  # (slot index, canonical doc)
        for i, doc in enumerate(docs):
            try:
                prepared.append((i, json.loads(_dumps(doc))))
            except Exception as exc:
                outcomes[i] = exc
        auto_id_docs = [doc for _, doc in prepared if "_id" not in doc]
        specs = self._unique_specs(conn, collection)
        conn.execute("SAVEPOINT batch_insert")
        try:
            for doc in auto_id_docs:
                doc["_id"] = self._next_id(conn, collection)
            for fields in specs:
                fields_key = _dumps(fields)
                conn.executemany(
                    "INSERT INTO unique_keys VALUES (?, ?, ?, ?)",
                    [
                        (collection, fields_key, _index_key(doc, fields),
                         _id_key(doc["_id"]))
                        for _, doc in prepared
                    ],
                )
            conn.executemany(
                "INSERT INTO docs VALUES (?, ?, ?)",
                [
                    (collection, _id_key(doc["_id"]), _dumps(doc))
                    for _, doc in prepared
                ],
            )
        except sqlite3.IntegrityError:
            conn.execute("ROLLBACK TO batch_insert")
            conn.execute("RELEASE batch_insert")
            # The rollback undid the happy path's id assignments; strip
            # them so each slot's _insert re-draws its own (and a failed
            # slot's draw rolls back with its savepoint — sequential
            # semantics).
            for doc in auto_id_docs:
                doc.pop("_id", None)
            for i, doc in prepared:
                conn.execute("SAVEPOINT one_insert")
                try:
                    outcomes[i] = self._insert(conn, collection, doc)
                    conn.execute("RELEASE one_insert")
                except DuplicateKeyError as exc:
                    conn.execute("ROLLBACK TO one_insert")
                    conn.execute("RELEASE one_insert")
                    outcomes[i] = exc
            return outcomes
        conn.execute("RELEASE batch_insert")
        for i, doc in prepared:
            outcomes[i] = doc["_id"]
        return outcomes

    def _write_in(self, conn, collection, data, query=None):
        if query is None:
            if isinstance(data, (list, tuple)):
                return [self._insert(conn, collection, doc) for doc in data]
            return self._insert(conn, collection, data)
        data = json.loads(_dumps(data))
        count = 0
        for doc in self._scan(conn, collection, query):
            if not _matches(doc, query):
                continue
            new_doc = apply_update(doc, data)
            new_doc["_id"] = doc["_id"]
            self._replace(conn, collection, doc, new_doc)
            count += 1
        return count

    def _read_in(self, conn, collection, query=None, projection=None):
        return [
            _project(doc, projection)
            for doc in self._scan_iter(conn, collection, query)
            if _matches(doc, query)
        ]

    def _read_and_write_in(self, conn, collection, query, data):
        data = json.loads(_dumps(data))
        for doc in self._scan_iter(conn, collection, query):
            if _matches(doc, query):
                new_doc = apply_update(doc, data)
                new_doc["_id"] = doc["_id"]
                self._replace(conn, collection, doc, new_doc)
                return new_doc
        return None

    def _remove_in(self, conn, collection, query=None):
        doomed = [
            doc
            for doc in self._scan(conn, collection, query)
            if _matches(doc, query)
        ]
        for doc in doomed:
            idk = _id_key(doc["_id"])
            conn.execute(
                "DELETE FROM docs WHERE collection = ? AND id = ?",
                (collection, idk),
            )
            conn.execute(
                "DELETE FROM unique_keys WHERE collection = ? AND id = ?",
                (collection, idk),
            )
        return len(doomed)

    @staticmethod
    def _is_plain_insert(op, args, kwargs):
        """A ``write`` carrying one document and no query — the slot shape
        apply_batch coalesces into :meth:`_insert_many` runs.  The query
        check must be ``is None``: an EMPTY query dict means update-all,
        not insert (write()'s own routing)."""
        return (
            op == "write"
            and len(args) == 2
            and not isinstance(args[1], (list, tuple))
            and (kwargs or {}).get("query") is None
        )

    @_translate_errors
    def apply_batch(self, ops):
        """Apply ``[(op, args, kwargs), ...]`` in ONE transaction: one
        COMMIT (and one WAL sync) per q-batch instead of q.  Outcome
        contract matches MemoryDB.apply_batch — per-slot results or
        exception instances, each failing op rolled back to its own
        SAVEPOINT so the rest of the batch commits.  Consecutive plain
        inserts into one collection ride :meth:`_insert_many`'s
        ``executemany`` fast path (the register_trials shape).  An op name
        outside BATCH_OPS rejects the whole batch upfront (nothing
        applied), same as every other backend."""
        if not ops:
            return []
        for op, _args, _kwargs in ops:
            if op not in MemoryDB.BATCH_OPS:
                raise DatabaseError(f"bad batch op {op!r}")
        if all(op in ("read", "count") for op, _, _ in ops):
            # Pure reads never need the IMMEDIATE write lock — taking it
            # would serialize every worker's per-round sync poll
            # (fetch_update_view) behind real commits.  WAL autocommit
            # reads see a consistent snapshot per statement, exactly what
            # the previous direct-call path gave.
            conn = self._conn()
            out = []
            for op, args, kwargs in ops:
                try:
                    out.append(getattr(self, f"_{op}_in")(conn, *args, **kwargs))
                except sqlite3.Error as exc:
                    out.append(DatabaseError(f"sqlite: {exc}"))
                except Exception as exc:
                    out.append(exc)
            return out
        out = []
        with self._txn() as conn:
            i = 0
            while i < len(ops):
                op, args, kwargs = ops[i]
                if self._is_plain_insert(op, args, kwargs):
                    j = i + 1
                    while j < len(ops) and self._is_plain_insert(
                        *ops[j]
                    ) and ops[j][1][0] == args[0]:
                        j += 1
                    out.extend(
                        self._insert_many(
                            conn, args[0], [o[1][1] for o in ops[i:j]]
                        )
                    )
                    i = j
                    continue
                conn.execute("SAVEPOINT batch_op")
                try:
                    result = getattr(self, f"_{op}_in")(conn, *args, **kwargs)
                    conn.execute("RELEASE batch_op")
                    out.append(result)
                except Exception as exc:
                    conn.execute("ROLLBACK TO batch_op")
                    conn.execute("RELEASE batch_op")
                    if isinstance(exc, sqlite3.Error):
                        exc = DatabaseError(f"sqlite: {exc}")
                    out.append(exc)
                i += 1
        return out

    # --- AbstractDB contract ----------------------------------------------
    @_translate_errors
    def write(self, collection, data, query=None):
        with self._txn() as conn:
            return self._write_in(conn, collection, data, query)

    @_translate_errors
    def update_many(self, collection, pairs):
        """All updates in ONE transaction (see MemoryDB.update_many)."""
        total = 0
        with self._txn() as conn:
            for query, data in pairs:
                data = json.loads(_dumps(data))
                for doc in self._scan(conn, collection, query):
                    if not _matches(doc, query):
                        continue
                    new_doc = apply_update(doc, data)
                    new_doc["_id"] = doc["_id"]
                    self._replace(conn, collection, doc, new_doc)
                    total += 1
        return total

    @_translate_errors
    def read(self, collection, query=None, projection=None):
        return self._read_in(self._conn(), collection, query, projection)

    @_translate_errors
    def read_and_write(self, collection, query, data):
        with self._txn() as conn:
            return self._read_and_write_in(conn, collection, query, data)

    @_translate_errors
    def count(self, collection, query=None):
        return self._count_in(self._conn(), collection, query)

    def _count_in(self, conn, collection, query=None):
        if not query:
            (n,) = conn.execute(
                "SELECT COUNT(*) FROM docs WHERE collection = ?", (collection,)
            ).fetchone()
            return n
        clauses, params = self._sql_prefilter(query)
        if len(clauses) == len(query):
            # Every condition was pushed to SQL, so COUNT(*) decides exactly
            # — no JSON parse per row.  The producer's count-gated sync
            # calls this every round with {experiment, status}, both
            # pushable.
            sql = (
                "SELECT COUNT(*) FROM docs WHERE collection = ? AND "
                + " AND ".join([_VALID_JSON, *clauses])
            )
            try:
                (n,) = conn.execute(sql, (collection, *params)).fetchone()
            except sqlite3.OperationalError:
                pass  # non-finite JSON token mid-scan: fall through
            else:
                # The documents SQLite cannot parse, narrowed by their text.
                sql, params = self._nonstandard_sql("SELECT doc", query)
                rest = conn.execute(sql, (collection, *params))
                return n + sum(1 for (d,) in rest if _matches(json.loads(d), query))
        return sum(
            1
            for doc in self._scan_iter(conn, collection, query)
            if _matches(doc, query)
        )

    @_translate_errors
    def remove(self, collection, query=None):
        with self._txn() as conn:
            return self._remove_in(conn, collection, query)

    def close(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
