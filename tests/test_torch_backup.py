"""The port's cross-shard backup and restore (``orion_tpu_torch/storage/
backup.py``) against ``orion_tpu.storage.backup`` over the same port
servers: the manifest and the shard files the reference writes; restores
onto a fresh topology of another shard count that leave the reference's
documents, with backups crossing between the packages in both directions;
the ``seq`` and ``epoch`` stamps; the refusals and a forced merge; a crashed
restore re-run to the same documents.  Auto-id diagnostics rows (each
shard counts its own ids) restore by content in the port, where the
reference's restore loses colliding rows and fails its count check."""

import json
import os

import pytest
from test_torch_netdb import servers  # noqa: F401
from test_torch_rebalance import exp_ids, load, populate, router, save, shard_state, spec

from orion_tpu.storage import backup as ref_backup
from orion_tpu_torch.storage import backup
from orion_tpu_torch.storage.audit import audit_storage
from orion_tpu_torch.storage.backup import MANIFEST, load_manifest
from orion_tpu_torch.storage.base import DocumentStorage
from orion_tpu_torch.storage.documents import dumps_canonical
from orion_tpu_torch.storage.netdb import NetworkDB

BACKUPS = {"port": backup, "ref": ref_backup}
NAMES = [f"exp-{e}" for e in range(9)]
TRIALS_PER_EXP = 5


@pytest.fixture
def source(servers):  # noqa: F811
    """Three port servers holding nine experiments (trials and auto-id
    telemetry rows), and a port router over them."""
    started = [servers("port") for _ in range(3)]
    db = router("port", [spec(s) for s in started])
    populate(db, NAMES, trials=TRIALS_PER_EXP)
    yield db
    db.close()


def spec_of(conn):
    return {"host": conn.host, "port": conn.port}


def _backup(package, source, out):
    db = router(package, [spec_of(c) for _, c in source.shard_connections()])
    try:
        return BACKUPS[package].backup_topology(db, out)
    finally:
        db.close()


def _restore(package, specs, src, **kwargs):
    db = router(package, specs)
    try:
        summary = BACKUPS[package].restore_topology(db, src, **kwargs)
    finally:
        db.close()
    summary.pop("manifest")
    return summary


def _contents(db, collection):
    """Canonical documents of ``collection`` through ``db``; by content
    (without ``_id``) for the auto-id channels."""
    docs = db.read(collection, {})
    if collection == "telemetry":
        docs = [{k: v for k, v in d.items() if k != "_id"} for d in docs]
    return sorted(dumps_canonical(d) for d in docs)


def _assert_restored(specs, source):
    db = router("port", specs)
    try:
        for collection in ("experiments", "trials", "telemetry"):
            assert _contents(db, collection) == _contents(source, collection), collection
        for eid in exp_ids(NAMES):
            assert db.count("trials", {"experiment": eid}) == TRIALS_PER_EXP
        for _index, conn in db.shard_connections():
            reports = audit_storage(DocumentStorage(conn), lost_timeout=3600.0)
            assert all(r.ok for r in reports), [r.violations for r in reports]
    finally:
        db.close()


def test_backup_writes_the_reference_manifest_and_shard_files(source, tmp_path):
    dirs = {p: str(tmp_path / p) for p in ("ref", "port")}
    manifests = {p: _backup(p, source, dirs[p]) for p in dirs}
    for manifest in manifests.values():
        manifest.pop("created_at")
    assert manifests["port"] == manifests["ref"] and len(manifests["port"]["shards"]) == 3
    with open(os.path.join(dirs["port"], MANIFEST)) as handle:
        on_disk = json.load(handle)
    on_disk.pop("created_at")
    assert on_disk == manifests["port"]
    for entry in manifests["port"]["shards"]:
        with open(os.path.join(dirs["port"], entry["file"]), "rb") as port_file, \
                open(os.path.join(dirs["ref"], entry["file"]), "rb") as ref_file:
            assert port_file.read() == ref_file.read()
    total = sum(e["docs"] for e in manifests["port"]["shards"])
    assert total == len(NAMES) * (1 + TRIALS_PER_EXP + 2)


@pytest.mark.parametrize("dest_shards", [1, 2])
def test_restores_cross_packages_and_shard_counts_like_the_reference(
        source, servers, tmp_path, dest_shards):  # noqa: F811
    """Without auto-id rows: a backup of three shards restored onto
    ``dest_shards`` fresh shards leaves the same documents whichever
    package wrote it and whichever restores it, with the same summary;
    the restored documents are the source's and every shard audits
    clean."""
    source.remove("telemetry", {})
    dirs = {p: str(tmp_path / p) for p in ("ref", "port")}
    for package in dirs:
        _backup(package, source, dirs[package])
    dest = [servers("port") for _ in range(dest_shards)]
    specs, empty = [spec(s) for s in dest], save(dest)
    states, summaries = {}, {}
    for writer in ("ref", "port"):
        for restorer in ("ref", "port"):
            load(dest, empty)
            summaries[writer, restorer] = _restore(restorer, specs, dirs[writer])
            states[writer, restorer] = shard_state(dest)
    assert all(s == summaries["ref", "ref"] for s in summaries.values())
    assert all(state == states["ref", "ref"] for state in states.values())
    assert summaries["port", "port"]["collections"] == {
        "experiments": len(NAMES), "trials": len(NAMES) * TRIALS_PER_EXP, "telemetry": 0}
    _assert_restored(specs, source)


@pytest.mark.parametrize("dest_shards", [1, 2])
def test_auto_id_rows_restore_by_content(source, servers, tmp_path, dest_shards):  # noqa: F811
    """With each source shard's telemetry ids counted from 1, the port
    restores every row (a fresh id on the destination), the trials and
    experiments by id; a re-run adds nothing.  The reference's restore of
    the same backup loses the rows whose ids collide on a destination
    shard and fails its count check (the repair this port carries)."""
    out = str(tmp_path / "backup")
    manifest = _backup("port", source, out)
    dest = [servers("port") for _ in range(dest_shards)]
    specs, empty = [spec(s) for s in dest], save(dest)
    summary = _restore("port", specs, out)
    assert summary["collections"]["telemetry"] == 2 * len(NAMES)
    _assert_restored(specs, source)
    state = shard_state(dest)
    assert _restore("port", specs, out, require_empty=False) == summary
    assert shard_state(dest) == state
    ids = [d["_id"] for _, c in source.shard_connections() for d in c.read("telemetry", {})]
    if dest_shards == 1 and len(ids) != len(set(ids)):
        load(dest, empty)
        with pytest.raises(Exception, match="restore incomplete: telemetry"):
            _restore("ref", specs, out)
    assert [e["collections"].get("telemetry", 0) for e in manifest["shards"]] \
        == [len(c.read("telemetry", {})) for _, c in source.shard_connections()]


def test_backup_stamps_each_shard_with_its_seq_and_epoch(servers, tmp_path):  # noqa: F811
    replica = servers("port", replica=True)
    primary = servers("port", replicate_to=[replica.address])
    client = NetworkDB(host=primary.address[0], port=primary.address[1], reconnect_jitter=0)
    try:
        client.write("trials", {"_id": "t1", "experiment": "e"})
        entries = [BACKUPS[p].backup_topology(client, str(tmp_path / p))["shards"][0]
                   for p in ("port", "ref")]
    finally:
        client.close()
    assert entries[0] == entries[1]
    assert entries[0]["seq"] == 1 and entries[0]["epoch"] == 1
    assert entries[0]["collections"].get("trials") == 1


def _refusals(package, db, tmp_path):
    module = BACKUPS[package]
    out = []
    incomplete = str(tmp_path / f"no-manifest-{package}")
    os.makedirs(incomplete)
    for call in (lambda: module.load_manifest(incomplete),
                 lambda: module.restore_topology(db, incomplete)):
        with pytest.raises(Exception, match="manifest") as err:
            call()
        out.append((type(err.value).__name__, str(err.value).replace(incomplete, "DIR")
                    .replace("orion-tpu-torch", "orion-tpu")))
    done = str(tmp_path / f"backup-{package}")
    module.backup_topology(db, done)
    with pytest.raises(Exception, match="FRESH") as err:
        module.restore_topology(db, done)
    out.append((type(err.value).__name__, str(err.value)))
    summary = module.restore_topology(db, done, require_empty=False)
    out.append((summary["collections"], db.count("trials", {}), db.count("telemetry", {})))
    return out


def test_refusals_and_a_forced_merge_match_the_reference(source, tmp_path):
    """A directory without a manifest and a non-empty target are refused
    with the reference's errors; a forced restore over the source merges
    convergently (documents dedup on their ids, auto-id rows on their
    content)."""
    ref_db = router("ref", [spec_of(c) for _, c in source.shard_connections()])
    try:
        got = _refusals("port", source, tmp_path)
        want = _refusals("ref", ref_db, tmp_path)
    finally:
        ref_db.close()
    assert got == want
    assert got[0][0] == "DatabaseError"
    assert got[3][1:] == (len(NAMES) * TRIALS_PER_EXP, 2 * len(NAMES))


def test_a_crashed_restore_reruns_to_the_reference_documents(source, servers, tmp_path):  # noqa: F811
    """Part of a backup already landed (a crashed restore): re-running the
    restore lands the rest, to the documents the reference's re-run
    leaves."""
    source.remove("telemetry", {})
    out = str(tmp_path / "backup")
    _backup("port", source, out)
    dest = [servers("port") for _ in range(2)]
    specs, empty = [spec(s) for s in dest], save(dest)
    states = {}
    for package in ("ref", "port"):
        load(dest, empty)
        db = router(package, specs)
        try:
            entry = load_manifest(out)["shards"][0]
            with open(os.path.join(out, entry["file"])) as handle:
                payload = json.load(handle)
            for collection, docs in payload["collections"].items():
                if not collection.startswith("_") and docs:
                    db.write(collection, docs)
        finally:
            db.close()
        with pytest.raises(Exception, match="FRESH"):
            _restore(package, specs, out)
        _restore(package, specs, out, require_empty=False)
        states[package] = shard_state(dest)
    assert states["port"] == states["ref"]
    _assert_restored(specs, source)
