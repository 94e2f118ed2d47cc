"""`orion-tpu-torch db ...`: storage administration (port of
``orion_tpu/cli/db.py``).

Capability parity: reference `src/orion/core/cli/db/` + `cli/setup.py` +
`cli/checks/` — ``setup`` writes the user-level configuration file,
``test`` runs the three staged check suites (presence / creation /
operations, reference `cli/checks/`), ``upgrade`` migrates stored documents
to the current schema (indexes + config backfill, reference
`cli/db/upgrade.py:96-183`).  ``dump``/``load``/``copy`` move documents
between backends (``load`` also reads mongoexport files and reference-Oríon
pickles), ``serve`` runs the network server (replicas, quorum), ``ring`` and
``status`` show a sharded topology, ``migrate-ids`` rewrites trial ids.
The day-2 operations change a sharded topology: ``ring --diff`` shows the
rebalance plan, ``rebalance`` migrates experiments to their ring homes,
``drain`` empties a shard before it is removed, ``backup`` and ``restore``
snapshot every shard and rebuild a fresh topology from the snapshots.
"""

import contextlib
import os

import yaml

from orion_tpu_torch.cli.base import load_cli_config
from orion_tpu_torch.config import user_config_path
from orion_tpu_torch.storage.base import setup_storage
from orion_tpu_torch.utils.exceptions import CheckError


def add_subparser(subparsers):
    parser = subparsers.add_parser("db", help="storage administration")
    sub = parser.add_subparsers(dest="db_command", metavar="ACTION")

    setup_p = sub.add_parser("setup", help="write the user configuration file")
    add_setup_args(setup_p)
    setup_p.set_defaults(func=main_setup)

    serve_p = sub.add_parser(
        "serve", help="run the shared network DB server (multi-node storage)"
    )
    serve_p.add_argument("--host", default="0.0.0.0", help="bind address")
    serve_p.add_argument("--port", type=int, default=8765, help="bind port")
    serve_p.add_argument(
        "--persist",
        default=None,
        help="snapshot file so the server can restart without losing state",
    )
    serve_p.add_argument(
        "--secret-file",
        default=None,
        help="file holding the shared secret clients must prove knowledge of "
        "(HMAC handshake; the secret never crosses the wire).  Clients set "
        "ORION_DB_SECRET_FILE or storage.secret_file.",
    )
    serve_p.add_argument(
        "--no-auth",
        action="store_true",
        help="explicitly run WITHOUT authentication (localhost development "
        "only — any peer that can reach the port can read and corrupt "
        "experiments)",
    )
    serve_p.add_argument(
        "--replicate-to",
        action="append",
        default=None,
        metavar="host:port",
        help="push this server's ordered mutation stream to a read replica "
        "(repeatable; replicas serve the hot read path of a sharded "
        "topology — see docs/multi_node.md).  Replication is asynchronous: "
        "writes are acknowledged before they reach any replica.",
    )
    serve_p.add_argument(
        "--replica",
        action="store_true",
        help="mark this server a read replica (stamps its applied "
        "replication sequence on read replies so clients detect lag; also "
        "set automatically when a primary's stream arrives)",
    )
    serve_p.add_argument(
        "--quorum",
        type=int,
        default=0,
        metavar="N",
        help="replication-ack floor for synchronous collections "
        "(experiments/trials/placement): a write is acknowledged only "
        "after N replicas confirm it, so those writes survive kill -9 by "
        "construction.  Needs at least N live replicas to stay writable; "
        "telemetry/health stay async.  0 (default) = all-async "
        "(see docs/multi_node.md).",
    )
    serve_p.add_argument(
        "--quorum-timeout",
        type=float,
        default=2.0,
        metavar="SECONDS",
        help="how long a synchronous write waits for its replica acks before "
        "it fails as maybe-applied (default 2.0, the server's own).  A round "
        "of q=1024 trials carrying their lineage is ~37 MB, which a replica "
        "applies in seconds.",
    )
    serve_p.set_defaults(func=main_serve)

    ring_p = sub.add_parser(
        "ring",
        help="show the sharded storage topology and per-experiment "
        "ring placement (requires a shards: stanza / ORION_DB_SHARDS)",
    )
    _common(ring_p)
    ring_p.add_argument(
        "--diff",
        action="store_true",
        help="show the rebalance plan instead: which experiments live away "
        "from their ring home (after a topology change) and where "
        "`db rebalance` would move them (~1/N of the keyspace when one "
        "shard was added)",
    )
    ring_p.set_defaults(func=main_ring)

    rebalance_p = sub.add_parser(
        "rebalance",
        help="move experiments to their ring homes after a topology change "
        "(live: copy -> verify byte-identical -> atomic placement flip -> "
        "delete source; crash-resumable — see docs/multi_node.md)",
    )
    _common(rebalance_p)
    rebalance_p.add_argument(
        "--dry-run", action="store_true",
        help="print the plan and exit without moving anything",
    )
    rebalance_p.add_argument(
        "--fence-grace", type=float, default=None, metavar="SECONDS",
        help="how long experiments stay fenced before the flip (default: "
        "the routers' placement-cache TTL, so every router observes the "
        "fence before documents move)",
    )
    rebalance_p.set_defaults(func=main_rebalance)

    drain_p = sub.add_parser(
        "drain",
        help="empty one shard BEFORE removing it from the topology: every "
        "resident experiment migrates to its post-removal ring home "
        "through the same crash-resumable pin/copy/byte-verify/flip "
        "machinery as `db rebalance` — zero lost observations, clean "
        "audit (see docs/multi_node.md, Day-2 operations)",
    )
    _common(drain_p)
    drain_p.add_argument(
        "shard", metavar="SHARD",
        help="the shard to drain: its index (as shown by `db ring` / "
        "`db status`) or its ring identity host:port",
    )
    drain_p.add_argument(
        "--dry-run", action="store_true",
        help="print the plan and exit without moving anything",
    )
    drain_p.add_argument(
        "--fence-grace", type=float, default=None, metavar="SECONDS",
        help="how long experiments stay fenced before the flip (default: "
        "the routers' placement-cache TTL, so every router observes the "
        "fence before documents move)",
    )
    drain_p.set_defaults(func=main_drain)

    status_p = sub.add_parser(
        "status",
        help="one-shot storage fleet status: per-shard role, replica set, "
        "replication lag and quorum floor (probed live)",
    )
    _common(status_p)
    status_p.add_argument(
        "--json", action="store_true",
        help="emit the probed structure as JSON instead of the table",
    )
    status_p.set_defaults(func=main_status)

    migrate_ids_p = sub.add_parser(
        "migrate-ids",
        help="rewrite trial ids to a new identity scheme (default: the "
        "byte-hash cube_hash scheme) experiment by experiment — copy under "
        "new ids -> byte-verify non-id fields -> flip id_scheme -> delete "
        "originals; crash-resumable, works on every backend and across "
        "the sharded router (see docs/multi_node.md)",
    )
    _common(migrate_ids_p)
    migrate_ids_p.add_argument(
        "--scheme", default="cube_hash", choices=["md5", "cube_hash"],
        help="target id scheme (default: cube_hash)",
    )
    migrate_ids_p.add_argument(
        "-n", "--name", default=None, metavar="NAME",
        help="migrate only this experiment (default: every experiment "
        "whose scheme differs)",
    )
    migrate_ids_p.add_argument(
        "--dry-run", action="store_true",
        help="print the plan and exit without rewriting anything",
    )
    migrate_ids_p.set_defaults(func=main_migrate_ids)

    backup_p = sub.add_parser(
        "backup",
        help="stream one consistent seq/epoch-stamped snapshot per shard "
        "into a directory (manifest written last, atomically)",
    )
    _common(backup_p)
    backup_p.add_argument(
        "--out", required=True, metavar="DIR",
        help="backup directory (created if missing)",
    )
    backup_p.set_defaults(func=main_backup)

    restore_p = sub.add_parser(
        "restore",
        help="rebuild a FRESH topology from a `db backup` directory; "
        "documents are routed through the CURRENT ring, so the new "
        "topology may have a different shard count",
    )
    _common(restore_p)
    restore_p.add_argument(
        "--src", required=True, metavar="DIR",
        help="backup directory holding manifest.json",
    )
    restore_p.add_argument(
        "--force", action="store_true",
        help="restore into a NON-empty destination (documents merge by id; "
        "conflicting content is NOT detected — disaster recovery only)",
    )
    restore_p.set_defaults(func=main_restore)

    copy_p = sub.add_parser(
        "copy",
        help="copy every experiment/trial between storage backends "
        "(e.g. migrate a pickled file to sqlite or to a network server)",
    )
    copy_p.add_argument(
        "--src", required=True,
        help="source storage: a DB file path, or host:port of a network server",
    )
    copy_p.add_argument(
        "--dst", required=True,
        help="destination storage: a DB file path, or host:port (created/merged)",
    )
    copy_p.set_defaults(func=main_copy)

    dump_p = sub.add_parser(
        "dump",
        help="export every document as JSON lines (backup / migration)",
    )
    dump_p.add_argument(
        "--src", required=True,
        help="storage to export: a DB file path, or host:port",
    )
    dump_p.add_argument(
        "--out", default="-",
        help="output file (default '-': stdout)",
    )
    dump_p.set_defaults(func=main_dump)

    load_p = sub.add_parser(
        "load",
        help="import documents from a dump file (orion-tpu JSONL, or a "
        "mongoexport --jsonArray file from a reference Oríon deployment)",
    )
    load_p.add_argument(
        "--src", required=True,
        help="dump file: `db dump` JSONL, raw-JSONL, or a JSON array",
    )
    load_p.add_argument(
        "--dst", required=True,
        help="destination storage: a DB file path, or host:port",
    )
    load_p.add_argument(
        "--collection", default=None,
        help="collection for files of raw documents (mongoexport output); "
        "not needed for `db dump` files, which carry the collection per line",
    )
    load_p.set_defaults(func=main_load)

    test_p = sub.add_parser("test", help="run staged storage checks")
    _common(test_p)
    test_p.set_defaults(func=main_test)

    up_p = sub.add_parser("upgrade", help="migrate stored documents to the current schema")
    _common(up_p)
    up_p.set_defaults(func=main_upgrade)

    parser.set_defaults(func=lambda args: parser.print_help() or 1)
    return parser


def _common(parser):
    parser.add_argument("-c", "--config", metavar="path", default=None)
    parser.add_argument("--storage-path", default=None)
    parser.add_argument("--debug", action="store_true")


def add_setup_args(parser):
    """Storage-setup arguments, shared by `db setup` and the top-level
    `setup` alias."""
    parser.add_argument(
        "--storage-type",
        default="pickled",
        choices=["pickled", "sqlite", "memory", "network"],
    )
    parser.add_argument("--path", default=None, help="DB file path (pickled/sqlite)")
    parser.add_argument("--host", default="127.0.0.1", help="network DB host")
    parser.add_argument("--port", type=int, default=8765, help="network DB port")
    parser.add_argument(
        "--secret-file", default=None,
        help="shared-secret file for an authenticated network server",
    )


def _copy_spec_to_config(spec):
    """``host:port`` (no path separators, numeric port) selects the network
    client; anything else is a DB file path routed by header/extension
    (same routing as --storage-path)."""
    if ":" in spec and os.sep not in spec and not os.path.exists(spec):
        host, _, port = spec.rpartition(":")
        if port.isdigit():
            return {"type": "network", "host": host, "port": int(port)}
    from orion_tpu_torch.cli.base import _storage_type_for_path

    return {"type": _storage_type_for_path(spec), "path": spec}


_COPY_COLLECTIONS = ("experiments", "trials", "lying_trials", "telemetry")


def _same_content(a, b):
    """Content equality across backend representations: canonical JSON
    tolerates numpy values, tuples→lists through sqlite, and non-finite
    floats (NaN != NaN as dicts).  Legacy pickled docs may hold values JSON
    can't express at all (bytes, sets) — fall back to plain equality then."""
    from orion_tpu_torch.storage.documents import dumps_canonical

    try:
        return dumps_canonical(a) == dumps_canonical(b)
    except TypeError:
        try:
            return bool(a == b)
        except Exception:  # numpy arrays make dict.__eq__ ambiguous
            return False


def _unique_key(doc, fields):
    from orion_tpu_torch.storage.documents import _get_path, index_key

    try:
        return index_key(doc, fields)
    except TypeError:  # non-JSON value inside a unique field: rare, legacy
        return repr([_get_path(doc, f)[1] for f in fields])


def _source_storage_or_error(spec):
    """Open a READ source: a nonexistent file path is an error, never a
    freshly-created empty DB — `db dump --src typo.sqlite` would otherwise
    truncate the backup (and `db copy` report a successful 0-doc copy)
    while the user believes their data was exported."""
    import sys

    from orion_tpu_torch.storage.base import create_storage

    config = _copy_spec_to_config(spec)
    if "path" in config and not os.path.exists(config["path"]):
        print(f"ERROR: source database {spec!r} does not exist", file=sys.stderr)
        return None
    return create_storage(config)


def main_dump(args):
    """Export every collection as JSON lines: ``{"collection": c, "doc": d}``
    per line — the lossless, diffable interchange format ``db load``
    re-imports (and the backup story for every backend, network included)."""
    import json
    import sys
    import tempfile

    from orion_tpu_torch.storage.documents import json_default

    src = _source_storage_or_error(args.src)
    if src is None:
        return 1

    def _write_all(out):
        n = 0
        for collection in _COPY_COLLECTIONS:
            for doc in src.db.read(collection):
                out.write(
                    json.dumps(
                        {"collection": collection, "doc": doc},
                        default=json_default,
                    )
                    + "\n"
                )
                n += 1
        return n

    if args.out == "-":
        _write_all(sys.stdout)
        return 0
    # Atomic replace: a mid-dump failure (unserializable legacy document,
    # network source dropping) must never have truncated the previous
    # backup already.
    out_dir = os.path.dirname(os.path.abspath(args.out)) or "."
    fd, tmp_path = tempfile.mkstemp(dir=out_dir, suffix=".dump-partial")
    try:
        with os.fdopen(fd, "w") as out:
            n = _write_all(out)
        # mkstemp creates 0600; preserve an existing backup's mode (a
        # group-readable file synced by another user must stay readable),
        # else the umask default a plain open() would have produced.
        import stat

        if os.path.exists(args.out):
            mode = stat.S_IMODE(os.stat(args.out).st_mode)
        else:
            current_umask = os.umask(0)
            os.umask(current_umask)
            mode = 0o666 & ~current_umask
        os.chmod(tmp_path, mode)
        os.replace(tmp_path, args.out)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp_path)
        raise
    print(f"dumped {n} documents to {args.out}")
    return 0


def _denormalize_mongo(value):
    """Strip Mongo extended-JSON wrappers so reference-Oríon exports load as
    plain documents: ``{"$oid": s}`` -> s, ``{"$date": ...}`` -> epoch
    seconds (float — this framework's timestamp convention), and the
    ``$number*`` scalar wrappers -> python numbers."""
    if isinstance(value, dict):
        if set(value) == {"$oid"}:
            return str(value["$oid"])
        if set(value) == {"$date"}:
            inner = value["$date"]
            if isinstance(inner, dict) and set(inner) == {"$numberLong"}:
                return int(inner["$numberLong"]) / 1000.0
            if isinstance(inner, (int, float)):
                return inner / 1000.0  # epoch millis
            import datetime

            return datetime.datetime.fromisoformat(
                str(inner).replace("Z", "+00:00")
            ).timestamp()
        if set(value) == {"$numberLong"} or set(value) == {"$numberInt"}:
            return int(next(iter(value.values())))
        if set(value) == {"$numberDouble"} or set(value) == {"$numberDecimal"}:
            return float(next(iter(value.values())))
        return {k: _denormalize_mongo(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_denormalize_mongo(v) for v in value]
    return value


def _iter_dump_docs(path, default_collection):
    """Yield (collection, doc) from a dump file: `db dump` JSONL lines
    carrying their collection, raw-JSONL documents, or one JSON array
    (mongoexport --jsonArray).  Raw forms need --collection."""
    import json

    from orion_tpu_torch.utils.exceptions import CheckError

    with open(path) as handle:
        head = handle.read(1)
        handle.seek(0)
        if head == "[":
            if default_collection is None:
                raise CheckError(
                    "this file is a raw JSON array of documents; pass "
                    "--collection (experiments/trials/lying_trials) to say "
                    "where they belong"
                )
            for doc in json.load(handle):
                yield default_collection, _denormalize_mongo(doc)
            return
        for line_no, line in enumerate(handle, 1):
            line = line.strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
            except json.JSONDecodeError as exc:
                raise CheckError(f"{path}:{line_no}: not JSON: {exc}") from exc
            if (
                isinstance(entry, dict)
                and set(entry) == {"collection", "doc"}
            ):
                # Our own dump format: already plain documents — running the
                # Mongo denormalizer over them would mangle any legitimate
                # value shaped like a wrapper (a user metadata dict whose
                # only key is "$date"), breaking dump->load losslessness.
                yield entry["collection"], entry["doc"]
            elif default_collection is not None:
                yield default_collection, _denormalize_mongo(entry)
            else:
                raise CheckError(
                    f"{path}:{line_no}: raw document without --collection "
                    "(db-dump lines carry {'collection': ..., 'doc': ...})"
                )


def _depickle_values(value):
    """Normalize pickled reference values to this framework's document
    conventions: naive-UTC datetimes (the reference stamps
    ``datetime.utcnow()``) -> epoch-second floats, tuples -> lists."""
    import datetime

    if isinstance(value, datetime.datetime):
        if value.tzinfo is None:
            value = value.replace(tzinfo=datetime.timezone.utc)
        return value.timestamp()
    if isinstance(value, dict):
        return {k: _depickle_values(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_depickle_values(v) for v in value]
    return value


def _iter_reference_pickle_docs(path):
    """Yield (collection, doc) from a reference-Oríon ``PickledDB`` file
    (a pickled EphemeralDB — `reference pickleddb.py:162-174`).

    Unpickling needs the reference's classes, i.e. ``import orion`` must
    work — true for a real migrating user, who has Oríon installed next to
    this framework.  Run ``db upgrade`` on the destination afterwards to
    convert the reference's trial schema (params as [{name,type,value}])
    to this framework's params dict."""
    import sys

    from orion_tpu_torch.storage.backends import _DBUnpickler
    from orion_tpu_torch.storage.documents import MemoryDB
    from orion_tpu_torch.utils.exceptions import CheckError

    try:
        # Unpickle FIRST: an orion-tpu pickle (either package's) needs no
        # reference package, and its misdiagnosis ("install Oríon") must not
        # shadow the real answer ("use db copy").  A reference pickle
        # without `orion` importable surfaces here as ModuleNotFoundError.
        # The pickled backend's unpickler opens orion_tpu's files without
        # importing it.
        with open(path, "rb") as handle:
            database = _DBUnpickler(handle).load()
    except ImportError as exc:
        raise CheckError(
            "this file is a pickled database whose classes are not "
            f"importable ({exc}); reading a reference-Oríon PickledDB "
            "requires the `orion` package (run the load where Oríon is "
            "installed, or export the data with mongoexport / its own "
            "tooling and load the JSON instead)"
        ) from exc
    if isinstance(database, MemoryDB):
        raise CheckError(
            "this is an orion-tpu pickled database, not a reference-Oríon "
            "one — use `db copy` to merge it"
        )
    collections = getattr(database, "_db", None)
    if collections is None:
        raise CheckError(
            "not a reference Oríon pickled database (no collections inside)"
        )
    for name, collection in collections.items():
        docs = collection.find()
        if not docs:
            continue
        if name not in _COPY_COLLECTIONS:
            print(
                f"skipping reference collection {name!r} "
                f"({len(docs)} document(s); no counterpart here)",
                file=sys.stderr,
            )
            continue
        for doc in docs:
            yield name, _depickle_values(dict(doc))


def _strip_id(doc):
    return {k: v for k, v in doc.items() if k != "_id"}


def _plan_merge(dst, docs_by_collection):
    """Plan-before-write merge shared by ``db copy`` and ``db load``:
    returns ``(plan, conflicts)`` where plan is
    ``[(collection, missing_docs, present_count), ...]``.

    A document is *present* (idempotent no-op) when the destination — or an
    earlier occurrence in the same source — already holds it with identical
    content; it is a *conflict* when the same _id (or the same
    unique-index key: experiments sharing name/version/user under distinct
    _ids) maps to DIFFERENT content.  Conflicts must abort before any
    write: the write phase would otherwise raise mid-batch with part of
    the source applied.  Documents WITHOUT an _id dedup by full content
    against the destination's _id-stripped documents (trials have no
    unique index to catch a re-insert)."""
    from orion_tpu_torch.storage.base import INDEX_SPECS
    from orion_tpu_torch.storage.documents import dumps_canonical

    unique_fields = {
        collection: fields for collection, fields, unique in INDEX_SPECS if unique
    }
    plan, conflicts = [], 0
    for collection, docs in docs_by_collection.items():
        fields = unique_fields.get(collection)
        existing = {}
        unique_seen = set()
        dst_docs = list(dst.db.read(collection))
        for doc in dst_docs:
            if "_id" in doc:
                existing[doc["_id"]] = doc
            if fields:
                unique_seen.add(_unique_key(doc, fields))
        # Content keys support only the raw-JSONL id-less path; built
        # lazily — `db copy` and db-dump loads always carry _ids, and
        # canonical-JSON-encoding every destination document would be O(N)
        # wasted work on their common path.
        existing_content = None

        def content_keys():
            nonlocal existing_content
            if existing_content is None:
                existing_content = set()
                for doc in dst_docs:
                    try:
                        existing_content.add(dumps_canonical(_strip_id(doc)))
                    except TypeError:
                        pass
            return existing_content
        first_by_id = {}
        missing, present = [], 0
        for doc in docs:
            _id = doc.get("_id")
            if _id is not None and _id in first_by_id:
                # Repeated inside the source (concatenated dumps): same
                # content merges, different content is a real conflict.
                if _same_content(first_by_id[_id], doc):
                    present += 1
                else:
                    conflicts += 1
                continue
            if _id is not None:
                first_by_id[_id] = doc
            other = existing.get(_id) if _id is not None else None
            if other is not None:
                if _same_content(other, doc):
                    present += 1
                else:
                    conflicts += 1
                continue
            if _id is None:
                try:
                    key = dumps_canonical(doc)
                except TypeError:
                    key = None
                if key is not None and key in content_keys():
                    present += 1
                    continue
                if key is not None:
                    content_keys().add(key)
            if fields is not None:
                key = _unique_key(doc, fields)
                if key in unique_seen:
                    conflicts += 1
                    continue
                unique_seen.add(key)
            missing.append(doc)
        plan.append((collection, missing, present))
    return plan, conflicts


def main_load(args):
    """Import a dump into a destination storage; duplicate documents with
    identical content merge idempotently, differing content aborts before
    anything is written (same contract as ``db copy``)."""
    import sys

    from orion_tpu_torch.storage.base import create_storage
    from orion_tpu_torch.utils.exceptions import CheckError, DuplicateKeyError

    if args.collection is not None and args.collection not in _COPY_COLLECTIONS:
        print(
            f"ERROR: unknown collection {args.collection!r}; expected one of "
            f"{_COPY_COLLECTIONS}",
            file=sys.stderr,
        )
        return 1
    dst = create_storage(_copy_spec_to_config(args.dst))
    by_collection = {}
    try:
        with open(args.src, "rb") as handle:
            is_pickle = handle.read(1) == b"\x80"  # pickle protocol-2+ magic
        if is_pickle:
            # A reference-Oríon PickledDB artifact (migration path; follow
            # with `db upgrade` on the destination to convert its schemas).
            docs_iter = _iter_reference_pickle_docs(args.src)
        else:
            docs_iter = _iter_dump_docs(args.src, args.collection)
        for collection, doc in docs_iter:
            if collection not in _COPY_COLLECTIONS:
                raise CheckError(f"unknown collection {collection!r} in dump")
            by_collection.setdefault(collection, []).append(doc)
    except OSError as exc:
        print(f"ERROR: cannot read {args.src!r}: {exc}", file=sys.stderr)
        return 1
    plan, conflicts = _plan_merge(dst, by_collection)
    if conflicts:
        print(
            f"ERROR: {conflicts} document(s) collide (same _id or same "
            "experiment name/version/user with DIFFERENT content) — "
            "NOTHING was loaded.  Bump the version or rename one side, "
            "then re-run.",
            file=sys.stderr,
        )
        return 1
    for collection, missing, present in plan:
        if missing:
            try:
                dst.db.write(collection, missing)
            except DuplicateKeyError as exc:
                print(
                    f"ERROR: destination changed during the load "
                    f"({collection}: {exc}) — the load is incomplete; "
                    "re-run to merge idempotently.",
                    file=sys.stderr,
                )
                return 1
        print(f"{collection}: loaded {len(missing)}, already present {present}")
    return 0


def main_copy(args):
    import sys

    from orion_tpu_torch.storage.base import create_storage
    from orion_tpu_torch.utils.exceptions import DuplicateKeyError

    src = _source_storage_or_error(args.src)
    if src is None:
        return 1
    dst = create_storage(_copy_spec_to_config(args.dst))
    # Plan everything BEFORE writing anything (shared with `db load`): a
    # conflicting experiment id must abort the whole copy, or its src
    # trials (carrying experiment=id) would attach to the unrelated dst
    # experiment.
    plan, conflicts = _plan_merge(
        dst,
        {
            collection: src.db.read(collection)
            for collection in _COPY_COLLECTIONS
        },
    )
    if conflicts:
        print(
            f"ERROR: {conflicts} document(s) collide with the destination "
            "with DIFFERENT content (same _id, or experiments sharing "
            "name/version/user) — NOTHING was copied.  For _id collisions "
            "from legacy auto-increment ids, run `orion-tpu-torch db upgrade` on "
            "both sides first; for same-named experiments, bump the version "
            "or rename one side before copying.",
            file=sys.stderr,
        )
        return 1
    for collection, missing, present in plan:
        if missing:
            # One batched write: per-doc writes into a pickled destination
            # would re-lock and rewrite the whole file per document.
            try:
                dst.db.write(collection, missing)
            except DuplicateKeyError as exc:
                # Race: a dst writer created a colliding doc after planning.
                print(
                    f"ERROR: destination changed during the copy "
                    f"({collection}: {exc}) — the copy is incomplete; "
                    "re-run to merge idempotently.",
                    file=sys.stderr,
                )
                return 1
        print(f"{collection}: copied {len(missing)}, already present {present}")
    return 0


def main_serve(args):
    import sys

    from orion_tpu_torch.storage.netdb import serve

    secret = None
    if args.secret_file:
        # Same read-strip-validate (and clean error surface) as the client
        # side's secret resolution.
        from orion_tpu_torch.storage.base import _resolve_network_secret

        secret = _resolve_network_secret({"secret_file": args.secret_file})
    elif not args.no_auth:
        # Secure by default: binding 0.0.0.0 without credentials hands the
        # whole experiment to anyone on the network.
        print(
            "ERROR: refusing to serve without authentication.  Pass "
            "--secret-file <path> (recommended), or --no-auth for localhost "
            "development.",
            file=sys.stderr,
        )
        return 1
    serve(
        host=args.host,
        port=args.port,
        persist=args.persist,
        secret=secret,
        replicate_to=args.replicate_to,
        replica=args.replica,
        quorum=args.quorum,
        quorum_timeout=args.quorum_timeout,
    )
    return 0


def _sharded_router_or_error(args):
    """Resolve the configured storage and require the consistent-hash
    router; returns ``(storage, router)`` or ``(None, None)`` after
    printing the remedy."""
    config = load_cli_config(args)
    storage = setup_storage(config["storage"], force=True)
    router = storage.db
    if not hasattr(router, "describe_topology"):
        print(
            "storage is not sharded; add a `shards:` stanza to the storage "
            "config (or set ORION_DB_SHARDS) — see docs/multi_node.md"
        )
        return None, None
    return storage, router


def _print_plan(plan):
    summary = plan.summary()
    print(
        f"rebalance plan: {summary['moves']} of {summary['experiments']} "
        f"experiment(s) move ({summary['move_fraction']:.1%}); "
        f"{summary['stays']} already home"
    )
    for move in plan.moves:
        print(f"  {move.describe()}")
    for exp_id, homes in plan.strays:
        print(f"  STRAY {exp_id}: found on shards {homes} with no placement record")


def main_ring(args):
    """`db ring`: the operator's placement oracle — which shard owns each
    experiment, and what the topology looks like, computed from the SAME
    ring every router instance builds (no server round trips needed for
    the placement itself; the experiment list is read through the
    router).  ``--diff`` shows the rebalance plan instead: where each
    displaced experiment currently lives vs where the ring now puts it."""
    from orion_tpu_torch.cli.base import describe_storage_topology

    storage, router = _sharded_router_or_error(args)
    if router is None:
        return 1
    print(describe_storage_topology(probe=True))
    topology = router.describe_topology()
    for shard in topology["shards"]:
        replicas = ", ".join(shard["replicas"]) or "none"
        serving = ""
        if shard.get("primary") and shard["primary"] != shard["address"]:
            serving = f"  primary NOW: {shard['primary']} (epoch {shard.get('epoch', 0)})"
        print(
            f"  shard {shard['index']}: {shard['address']}  "
            f"replicas: {replicas}{serving}"
        )
    if getattr(args, "diff", False):
        from orion_tpu_torch.storage.rebalance import Rebalancer

        plan = Rebalancer(router).plan()
        _print_plan(plan)
        if plan.moves:
            n = len(topology["shards"])
            print(
                f"(~1/N invariant: {plan.move_fraction:.1%} moving vs "
                f"1/{n} = {1 / n:.1%} expected after adding one shard)"
            )
            print("run `orion-tpu-torch db rebalance` to execute this plan")
        return 0
    docs = storage.fetch_experiments({})
    if not docs:
        print("no experiments in storage")
        return 0
    print(f"{len(docs)} experiment(s):")
    for doc in sorted(docs, key=lambda d: (d["name"], d.get("version", 1))):
        shard = router.shard_for(doc["_id"])
        print(
            f"  {doc['name']} v{doc.get('version', 1)} "
            f"({doc['_id']}) -> shard {shard}"
        )
    return 0


def main_rebalance(args):
    """`db rebalance`: execute the ring diff — migrate every displaced
    experiment to its ring home through the crash-resumable placement
    state machine (storage/rebalance.py).  Re-run after any crash: the
    plan is recomputed from the standing placement docs and resumes."""
    from orion_tpu_torch.storage.rebalance import Rebalancer

    _storage, router = _sharded_router_or_error(args)
    if router is None:
        return 1
    rebalancer = Rebalancer(router, fence_grace=args.fence_grace)
    plan = rebalancer.plan()
    _print_plan(plan)
    if args.dry_run or not plan.moves:
        return 1 if plan.strays else 0
    if plan.strays:
        print("ERROR: strays present — resolve before rebalancing")
        return 1
    rebalancer.run(plan)
    moved = len(plan.moves)
    print(f"rebalanced {moved} experiment(s); placement == ring again")
    return 0


def _resolve_shard_arg(router, value):
    """A ``db drain`` SHARD operand: an index or a ring identity."""
    try:
        index = int(value)
    except ValueError:
        index = None
        for shard in router.describe_topology()["shards"]:
            if value in (shard["address"], shard["primary"]):
                index = shard["index"]
                break
    return index


def main_drain(args):
    """`db drain SHARD`: run the ring diff BEFORE the shard disappears —
    migrate every resident experiment to its post-removal ring home
    (storage/drain.py), verify the shard is empty, then tell the operator
    to drop it from the shards: stanza.  Re-run after any crash: the plan
    is recomputed from the standing placement docs and resumes."""
    import sys

    from orion_tpu_torch.storage.drain import Drainer
    from orion_tpu_torch.utils.exceptions import DatabaseError

    _storage, router = _sharded_router_or_error(args)
    if router is None:
        return 1
    index = _resolve_shard_arg(router, args.shard)
    if index is None:
        print(
            f"ERROR: no shard matches {args.shard!r} — pass an index or a "
            "ring identity from `db status`",
            file=sys.stderr,
        )
        return 1
    try:
        drainer = Drainer(router, index, fence_grace=args.fence_grace)
    except DatabaseError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    plan = drainer.plan()
    print(
        f"drain shard {index} ({drainer.drain_identity}): "
        f"{len(plan.moves)} experiment(s) to move "
        f"(ring share {drainer.ring_share():.1%})"
    )
    for move in plan.moves:
        print(f"  {move.describe()}")
    for exp_id, homes in plan.strays:
        print(f"  STRAY {exp_id}: needs `db rebalance` first (shards {homes})")
    if args.dry_run:
        return 1 if plan.strays else 0
    if plan.strays:
        print(
            "ERROR: strays present — run `orion-tpu-torch db rebalance` first, "
            "then drain",
            file=sys.stderr,
        )
        return 1
    try:
        drainer.run(plan)
    except DatabaseError as exc:
        print(f"ERROR: drain failed: {exc}", file=sys.stderr)
        print(f"re-run `orion-tpu-torch db drain {args.shard}` to resume", file=sys.stderr)
        return 1
    residual = drainer.residual_experiments()
    if residual:
        print(
            f"ERROR: {len(residual)} experiment(s) still resident after the "
            f"drain: {residual[:3]} — re-run to resume",
            file=sys.stderr,
        )
        return 1
    print(
        f"shard {index} drained: {len(plan.moves)} experiment(s) moved, "
        "0 resident"
    )
    print(
        f"now remove {drainer.drain_identity} from the storage shards: "
        "stanza (every router picks the new ring up via set_topology / "
        "restart) and retire the server"
    )
    return 0


def main_status(args):
    """`db status`: the storage fleet at a glance — one probed line per
    shard (role, epoch, seq, quorum floor, per-replica lag), same
    rendering discipline as the `top --all` fleet header."""
    import json

    from orion_tpu_torch.cli.base import describe_storage_topology

    _storage, router = _sharded_router_or_error(args)
    if router is None:
        return 1
    topology = router.describe_topology()
    health = router.replication_health()
    if args.json:
        print(
            json.dumps(
                {
                    "vnodes": topology["vnodes"],
                    "replica_reads": topology["replica_reads"],
                    "shards": health,
                },
                indent=2,
                sort_keys=True,
            )
        )
        return 0
    print(describe_storage_topology(probe=True))
    for entry in health:
        if entry.get("error"):
            print(
                f"  s{entry['index']} {entry['address']}  "
                f"DOWN ({entry['error']})"
            )
            continue
        quorum = entry.get("quorum", 0)
        line = (
            f"  s{entry['index']} {entry['address']}  "
            f"{entry.get('role', '?')}@{entry['primary']}  "
            f"epoch {entry.get('epoch', 0)}  seq {entry.get('seq', 0)}  "
            f"quorum {quorum if quorum else 'off'}"
        )
        print(line)
        for row in entry.get("replicas", ()):
            if row.get("error"):
                detail = f"DOWN ({row['error']})"
            else:
                detail = f"seq {row.get('seq', 0)}  lag {row.get('lag', '?')}"
                if row.get("resyncing"):
                    detail += "  RESYNCING"
            print(f"      replica {row['address']}  {detail}")
    return 0


def main_migrate_ids(args):
    """`db migrate-ids`: rewrite trial ids to ``--scheme`` through the
    crash-resumable copy/verify/flip/delete state machine
    (storage/migrate_ids.py).  Re-run after any crash: the plan is
    recomputed from the standing migration docs and resumes.  Run with no
    active producers on the affected experiments."""
    import sys

    from orion_tpu_torch.storage.migrate_ids import IdMigrator
    from orion_tpu_torch.utils.exceptions import DatabaseError

    config = load_cli_config(args)
    storage = setup_storage(config["storage"], force=True)
    migrator = IdMigrator(storage, to_scheme=args.scheme)
    rows = migrator.plan(experiment=args.name)
    if not rows:
        print(f"nothing to migrate: every experiment already uses {args.scheme!r}")
        return 0
    print(f"migrate-ids plan: {len(rows)} experiment(s) -> {args.scheme!r}")
    for row in rows:
        print(f"  {row.describe()}")
    if args.dry_run:
        return 0
    try:
        migrator.run(rows)
    except DatabaseError as exc:
        print(f"ERROR: migrate-ids failed: {exc}", file=sys.stderr)
        print("re-run `orion-tpu-torch db migrate-ids` to resume", file=sys.stderr)
        return 1
    rewritten = sum(row.rewritten for row in rows)
    print(
        f"migrated {len(rows)} experiment(s) ({rewritten} doc(s) rewritten); "
        "run `orion-tpu-torch audit --all` to verify"
    )
    return 0


def main_backup(args):
    """`db backup --out DIR`: one consistent snapshot per shard + manifest."""
    import sys

    from orion_tpu_torch.storage.backup import backup_topology
    from orion_tpu_torch.utils.exceptions import DatabaseError

    config = load_cli_config(args)
    storage = setup_storage(config["storage"], force=True)
    db = storage.db
    if not hasattr(db, "_call") and not hasattr(db, "shard_connections"):
        print(
            "ERROR: `db backup` snapshots network/sharded storage; for "
            "file-backed storage use `db dump`",
            file=sys.stderr,
        )
        return 1
    try:
        manifest = backup_topology(db, args.out)
    except DatabaseError as exc:
        print(f"ERROR: backup failed: {exc}", file=sys.stderr)
        return 1
    total = sum(entry["docs"] for entry in manifest["shards"])
    for entry in manifest["shards"]:
        print(
            f"  shard {entry['index']} ({entry['address']}): "
            f"{entry['docs']} docs at seq {entry['seq']} epoch {entry['epoch']}"
        )
    print(f"backed up {total} documents from "
          f"{len(manifest['shards'])} shard(s) to {args.out}")
    return 0


def main_restore(args):
    """`db restore --src DIR`: rebuild a fresh topology from a backup."""
    import sys

    from orion_tpu_torch.storage.backup import restore_topology
    from orion_tpu_torch.utils.exceptions import DatabaseError

    config = load_cli_config(args)
    storage = setup_storage(config["storage"], force=True)
    db = storage.db
    if not hasattr(db, "apply_batch"):
        print(
            "ERROR: `db restore` targets network/sharded storage; for "
            "file-backed storage use `db load`",
            file=sys.stderr,
        )
        return 1
    try:
        summary = restore_topology(db, args.src, require_empty=not args.force)
    except DatabaseError as exc:
        print(f"ERROR: restore failed: {exc}", file=sys.stderr)
        return 1
    for collection, count in sorted(summary["collections"].items()):
        if count:
            print(f"  {collection}: {count}")
    print(
        f"restored {summary['documents']} documents through the current "
        "ring; run `orion-tpu-torch audit --all` to verify"
    )
    return 0


def main_setup(args):
    path = user_config_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    storage = {"type": args.storage_type}
    if args.storage_type == "network":
        storage["host"] = args.host
        storage["port"] = args.port
        if args.secret_file:
            storage["secret_file"] = os.path.abspath(args.secret_file)
    elif args.path:
        storage["path"] = os.path.abspath(args.path)
    elif args.storage_type in ("pickled", "sqlite"):
        ext = "pkl" if args.storage_type == "pickled" else "sqlite"
        storage["path"] = os.path.join(
            os.path.dirname(path), f"orion_tpu_db.{ext}"
        )
    existing = {}
    if os.path.exists(path):
        with open(path) as handle:
            existing = yaml.safe_load(handle) or {}
    existing["storage"] = storage
    with open(path, "w") as handle:
        yaml.safe_dump(existing, handle, default_flow_style=False)
    print(f"Wrote storage configuration to {path}")
    return 0


# --- staged checks (reference cli/checks/: presence, creation, operations) ---


def check_presence(config):
    """Stage 1: a storage configuration can be resolved at all."""
    if not config.get("storage") or not config["storage"].get("type"):
        raise CheckError("no storage configuration found")
    return f"storage type {config['storage']['type']!r}"


def check_creation(config):
    """Stage 2: the backend can be instantiated and locked."""
    storage = setup_storage(config["storage"], force=True)
    storage.db.read("experiments", {"_id": "__check__"})
    return type(storage.db).__name__


def check_operations(config):
    """Stage 3: write / read / count / remove roundtrip."""
    storage = setup_storage(config["storage"], force=True)
    db = storage.db
    db.remove("_checks", {})
    db.write("_checks", {"_id": "c1", "value": 1})
    if db.count("_checks") != 1:
        raise CheckError("count after write != 1")
    doc = db.read_and_write("_checks", {"_id": "c1"}, {"value": 2})
    if doc is None or doc["value"] != 2:
        raise CheckError("read_and_write failed")
    db.remove("_checks", {})
    if db.count("_checks") != 0:
        raise CheckError("remove failed")
    return "write/read/cas/remove ok"


def main_test(args):
    config = load_cli_config(args)
    failures = 0
    for stage, check in (
        ("presence", check_presence),
        ("creation", check_creation),
        ("operations", check_operations),
    ):
        try:
            detail = check(config)
            print(f"check {stage}... ok ({detail})")
        except Exception as exc:
            print(f"check {stage}... FAIL: {exc}")
            failures += 1
            break  # later stages depend on earlier ones
    return 1 if failures else 0


def main_upgrade(args):
    """Schema migration: re-ensure indexes, backfill missing fields."""
    config = load_cli_config(args)
    storage = setup_storage(config["storage"], force=True)
    migrated = 0
    for doc in storage.fetch_experiments({}):
        updates = {}
        if "version" not in doc:
            updates["version"] = 1
        if "priors" not in doc:
            updates["priors"] = (doc.get("metadata") or {}).get("priors", {})
        if "refers" not in doc:
            updates["refers"] = {}
        if "strategy" not in doc:
            # Reference schema nests it (`producer.strategy`,
            # reference experiment.py:120 / configuration dict).
            strategy = (doc.get("producer") or {}).get("strategy")
            if isinstance(strategy, str):
                updates["strategy"] = strategy
        if updates:
            storage.update_experiment(uid=doc["_id"], **updates)
            migrated += 1
    # Trials: backfill parents list.
    n_trials = storage.db.write(
        "trials", {"parents": []}, query={"parents": None}
    )
    # Reference-schema trials: params is [{name, type, value}, ...]
    # (reference `core/worker/trial.py` Param list) — convert to this
    # framework's params dict keyed by name, batched so a file-backed
    # destination pays one lock/rewrite cycle, not one per trial.
    pairs = [
        (
            {"_id": doc["_id"]},
            {"params": {p["name"]: p["value"] for p in doc["params"]}},
        )
        for doc in storage.db.read("trials")
        if isinstance(doc.get("params"), list)
    ]
    if pairs:
        n_trials += storage.db.update_many("trials", pairs)
    print(f"Upgraded {migrated} experiments, {n_trials} trials.")
    return 0
