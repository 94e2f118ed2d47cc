"""A restore batch whose reply is lost after it was applied
(``orion_tpu_torch/storage/backup.py``).

The auto-id collections (telemetry, metrics, spans, health) restore by
content, without ids, so nothing on the server refuses a row written twice.
A ``FaultProxy`` in front of the destination eats the reply of one
telemetry batch; the restore's retry must write only the rows that did not
land, and each auto-id collection must then hold exactly the manifest's
count.  The verify rejects a surplus as it rejects a shortfall.
"""

import pytest
from test_torch_netdb import servers  # noqa: F401
from test_torch_rebalance import populate, router, spec

from orion_tpu_torch.storage import backup
from orion_tpu_torch.storage.faults import FaultProxy
from orion_tpu_torch.storage.rebalance import AUTO_ID_COLLECTIONS
from orion_tpu_torch.utils.exceptions import DatabaseError

NAMES = [f"exp-{e}" for e in range(6)]


def _backed_up(servers, tmp_path):  # noqa: F811
    """A backup of two port shards holding ``NAMES`` with their trials and
    two telemetry rows each, plus 300 rows more (two batches) on one."""
    source = router("port", [spec(servers("port")) for _ in range(2)])
    try:
        populate(source, NAMES)
        source.write("telemetry", [{"experiment": "bulk", "worker": "w1", "kind": "t", "n": i}
                                   for i in range(300)])
        out = str(tmp_path / "backup")
        return backup.backup_topology(source, out), out
    finally:
        source.close()


def _manifest_counts(manifest):
    counts = {}
    for entry in manifest["shards"]:
        for collection, n in entry["collections"].items():
            counts[collection] = counts.get(collection, 0) + n
    return counts


def test_a_lost_reply_mid_restore_writes_no_auto_id_row_twice(servers, tmp_path):  # noqa: F811
    manifest, out = _backed_up(servers, tmp_path)
    dest = servers("port")
    proxy = FaultProxy(*dest.address)
    host, port = proxy.serve_background()
    db = router("port", [{"host": host, "port": port}])
    apply_batch = db.apply_batch
    armed = []

    def dropping(ops):
        # The second telemetry batch: applied by the server, its reply lost.
        if ops and ops[0][1][0] == "telemetry":
            armed.append(len(ops))
            if len(armed) == 2:
                proxy.fail_next("drop_reply")
        return apply_batch(ops)

    db.apply_batch = dropping
    try:
        summary = backup.restore_topology(db, out)
        assert proxy.faults_fired == {"drop_reply": 1}
        counts = _manifest_counts(manifest)
        assert counts["telemetry"] == 2 * len(NAMES) + 300
        for collection in AUTO_ID_COLLECTIONS:
            assert db.count(collection, {}) == counts.get(collection, 0), collection
        assert summary["collections"] == {c: n for c, n in counts.items()
                                          if not c.startswith("_")}
    finally:
        db.close()
        proxy.stop()


def test_the_verify_rejects_a_surplus(servers, tmp_path, monkeypatch):  # noqa: F811
    """A restore that writes one telemetry row more than it reports (as a
    batch resent whole would) fails its verify."""
    _manifest, out = _backed_up(servers, tmp_path)
    db = router("port", [spec(servers("port"))])
    write_by_content = backup._write_by_content

    strays = []

    def one_more(db, collection, docs, policy):
        created = write_by_content(db, collection, docs, policy)
        if collection == "telemetry" and not strays:
            strays.append(db.write("telemetry", {"experiment": "stray", "worker": "w9",
                                                 "kind": "t", "n": 0}))
        return created

    monkeypatch.setattr(backup, "_write_by_content", one_more)
    try:
        with pytest.raises(DatabaseError, match="telemetry: expected 312, destination holds 313"):
            backup.restore_topology(db, out)
    finally:
        db.close()
