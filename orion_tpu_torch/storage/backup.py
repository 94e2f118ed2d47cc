"""Cross-shard snapshot backup / restore (`orion-tpu-torch db backup` /
`db restore`; port of ``orion_tpu/storage/backup.py``: the same manifest and
shard files, so either package restores the other's backups).

``backup_topology`` streams one CONSISTENT snapshot per shard — the
``snapshot`` wire op returns the same full-state dump replica resyncs
ship, taken under the server's replication lock so no mutation
interleaves, stamped with the shard's applied ``seq`` and ``epoch`` —
into ``DIR/shard<i>.json`` files plus a ``manifest.json`` recording the
topology and per-shard positions.  The manifest is written LAST
(atomically): a crashed backup leaves no manifest and a restore refuses
to touch it.

``restore_topology`` rebuilds a FRESH topology from a backup directory:
every document is routed through the destination router's OWN ring, so
the restore target may have a different shard count than the source —
the documents land wherever the new ring says they belong.  Placement
override docs (``_placement``) are deliberately dropped: they encode the
OLD topology's mid-migration state, and on the new ring the documents
are placed directly at their homes.  Restores are convergent: re-running
a crashed restore dedups on document ids.

One repair against the reference: the diagnostics channels whose ``_id``
is each shard's auto-increment counter (telemetry, metrics, spans,
health; ``rebalance.AUTO_ID_COLLECTIONS``) restore by CONTENT, as the
rebalancer moves them.  The same integer id names different documents on
different source shards, so once two shards' rows land on one destination
shard the reference's restore dedups unrelated rows as resends and then
fails its own count check; here each row is inserted without its id (the
destination assigns one) unless the destination already holds a row of
the same content, which keeps a re-run convergent.
"""

import json
import logging
import os
import tempfile
import time
from collections import Counter

from orion_tpu_torch.storage.documents import json_default
from orion_tpu_torch.storage.rebalance import AUTO_ID_COLLECTIONS, _canonical, _strip_id
from orion_tpu_torch.storage.retry import MODE_ALWAYS, create_retry_policy
from orion_tpu_torch.storage.shard import PLACEMENT_COLLECTION
from orion_tpu_torch.utils.exceptions import DatabaseError, DuplicateKeyError

log = logging.getLogger(__name__)

MANIFEST = "manifest.json"

#: Server-internal collections never restored: replication bookkeeping is
#: per-server state and placement overrides encode the OLD topology.
_SKIP_RESTORE = frozenset({"_replmeta", PLACEMENT_COLLECTION})

#: Batched restore chunk (one apply_batch request per chunk per shard).
RESTORE_BATCH = 256

RESTORE_RETRY = {
    "max_attempts": 5,
    "base_delay": 0.05,
    "max_delay": 1.0,
    "deadline": 30.0,
}


def _shard_surfaces(db):
    """``[(index, NetworkDB), ...]`` for a router or a single client."""
    connections = getattr(db, "shard_connections", None)
    if connections is not None:
        return connections()
    return [(0, db)]


def backup_topology(db, out_dir):
    """Snapshot every shard of ``db`` (router or single NetworkDB) into
    ``out_dir``; returns the manifest dict."""
    os.makedirs(out_dir, exist_ok=True)
    describe = getattr(db, "describe_topology", None)
    manifest = {
        "version": 1,
        "created_at": time.time(),
        "topology": describe() if describe is not None else {"shards": 1},
        "shards": [],
    }
    for index, conn in _shard_surfaces(db):
        payload = conn._call("snapshot")
        if not isinstance(payload, dict):
            raise DatabaseError(
                f"shard {index} ({conn.host}:{conn.port}) returned no "
                "snapshot — is the server older than the backup protocol?"
            )
        collections = payload.get("collections") or {}
        entry = {
            "index": index,
            "address": f"{conn.host}:{conn.port}",
            "seq": int(payload.get("seq", 0)),
            "epoch": int(payload.get("epoch", 0) or 0),
            "file": f"shard{index}.json",
            "docs": sum(len(v) for v in collections.values()),
            "collections": {k: len(v) for k, v in collections.items()},
        }
        _atomic_json(os.path.join(out_dir, entry["file"]), payload)
        manifest["shards"].append(entry)
        log.info(
            "backed up shard %d (%s): %d docs at seq %d epoch %d",
            index, entry["address"], entry["docs"], entry["seq"], entry["epoch"],
        )
    _atomic_json(os.path.join(out_dir, MANIFEST), manifest)
    return manifest


def load_manifest(src_dir):
    path = os.path.join(src_dir, MANIFEST)
    if not os.path.exists(path):
        raise DatabaseError(
            f"{src_dir!r} holds no {MANIFEST} — not a completed "
            "`orion-tpu-torch db backup` directory"
        )
    with open(path) as handle:
        return json.load(handle)


def restore_topology(db, src_dir, require_empty=True, retry=None):
    """Restore a backup directory into ``db`` (router or single client).

    The destination must be EMPTY (no experiments) unless
    ``require_empty=False`` — a restore is a disaster-recovery rebuild,
    not a merge (``db load`` merges).  Returns a summary dict with
    per-collection document counts; raises when the restored counts do
    not match the manifest."""
    manifest = load_manifest(src_dir)
    policy = create_retry_policy(dict(RESTORE_RETRY) if retry is None else retry)
    if require_empty:
        existing = policy.run(
            lambda: db.count("experiments", {}),
            op="restore.precheck", mode=MODE_ALWAYS,
        )
        if existing:
            raise DatabaseError(
                f"restore target already holds {existing} experiment(s); "
                "restore rebuilds a FRESH topology — point it at empty "
                "shards (or pass --force to merge at your own risk)"
            )
    expected = {}
    before = {}
    created = {}
    for entry in manifest["shards"]:
        path = os.path.join(src_dir, entry["file"])
        with open(path) as handle:
            payload = json.load(handle)
        for collection, docs in (payload.get("collections") or {}).items():
            if collection in _SKIP_RESTORE:
                continue
            expected[collection] = expected.get(collection, 0) + len(docs)
            if collection not in before:
                before[collection] = policy.run(
                    lambda collection=collection: db.count(collection, {}),
                    op=f"restore.count.{collection}", mode=MODE_ALWAYS,
                )
            if not docs:
                continue
            if collection in AUTO_ID_COLLECTIONS:
                landed = _write_by_content(db, collection, docs, policy)
            else:
                landed = _write_by_id(db, collection, docs, policy)
            created[collection] = created.get(collection, 0) + landed
    # Verify: the destination (through the new ring) must hold every
    # backed-up document, and exactly what it held before plus what this
    # restore created: a surplus (a batch written twice) fails as a
    # shortfall does.
    mismatches = []
    for collection, count in sorted(expected.items()):
        have = policy.run(
            lambda collection=collection: db.count(collection, {}),
            op=f"restore.verify.{collection}", mode=MODE_ALWAYS,
        )
        want = before[collection] + created.get(collection, 0)
        if have < count or have != want:
            mismatches.append((collection, max(count, want), have))
    if mismatches:
        raise DatabaseError(
            "restore does not match the backup: "
            + "; ".join(
                f"{c}: expected {want}, destination holds {have}"
                for c, want, have in mismatches
            )
        )
    return {
        "manifest": manifest,
        "collections": expected,
        "documents": sum(expected.values()),
    }


def _write_by_id(db, collection, docs, policy):
    """Write ``docs`` with their ids in batches; returns how many the
    destination did not hold yet.  A retried batch is safe: a write whose
    id already landed comes back as a ``DuplicateKeyError``."""
    created = 0
    for start in range(0, len(docs), RESTORE_BATCH):
        ops = [("write", [collection, doc], {}) for doc in docs[start:start + RESTORE_BATCH]]
        outcomes = policy.run(
            lambda ops=ops: db.apply_batch(ops),
            op=f"restore.write.{collection}", mode=MODE_ALWAYS,
        )
        for outcome in outcomes:
            if isinstance(outcome, DuplicateKeyError):
                continue  # a crashed earlier restore, or a retried batch, got here
            if isinstance(outcome, Exception):
                raise outcome
            created += 1
    return created


def _write_by_content(db, collection, docs, policy):
    """Insert the rows of ``docs`` the destination does not hold yet, by
    content outside ``_id`` (:func:`_missing_by_content`), in batches;
    returns how many it inserted.

    Nothing stops a row without an id from landing twice, so a batch whose
    reply was lost after it was applied must not be sent again whole: a
    retried batch first reads what the destination holds and writes only
    the rows of the batch that did not land."""
    present = policy.run(
        lambda: _content(db, collection),
        op=f"restore.read.{collection}", mode=MODE_ALWAYS,
    )
    fresh = _missing_by_content(docs, present)
    expected = Counter(present)
    for start in range(0, len(fresh), RESTORE_BATCH):
        chunk = fresh[start:start + RESTORE_BATCH]
        retried = []

        def attempt(chunk=chunk):
            todo = chunk
            if retried:
                landed = _content(db, collection) - expected
                todo = _missing_by_content(chunk, landed)
            retried.append(True)
            return db.apply_batch([("write", [collection, doc], {}) for doc in todo])

        outcomes = policy.run(attempt, op=f"restore.write.{collection}", mode=MODE_ALWAYS)
        for outcome in outcomes:
            if isinstance(outcome, Exception):
                raise outcome
        expected.update(_canonical(doc) for doc in chunk)
    return len(fresh)


def _content(db, collection):
    """The destination's rows of ``collection`` as a multiset of their
    content outside ``_id``."""
    return Counter(_canonical(_strip_id(doc)) for doc in db.read(collection, {}))


def _missing_by_content(docs, present):
    """The rows of ``docs`` not in the multiset ``present`` (two equal rows
    need two), each without its id so the destination assigns one from
    its own counter."""
    have = Counter(present)
    fresh = []
    for doc in docs:
        key = _canonical(_strip_id(doc))
        if have[key] > 0:
            have[key] -= 1
            continue
        fresh.append(_strip_id(doc))
    return fresh


def _atomic_json(path, payload):
    out_dir = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp_path = tempfile.mkstemp(dir=out_dir, suffix=".backup-partial")
    try:
        with os.fdopen(fd, "w") as handle:
            json.dump(payload, handle, default=json_default)
        os.replace(tmp_path, path)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:  # pragma: no cover - best-effort cleanup
            pass
        raise
