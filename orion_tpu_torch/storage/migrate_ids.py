"""`orion-tpu-torch db migrate-ids`: rewrite an experiment's trial ids to a
new identity scheme, crash-resumably and byte-verified (port of
``orion_tpu/storage/migrate_ids.py``: the same state machine and the same
new ids).

The cube_hash identity (``orion_tpu_torch.core.trial.compute_cube_ids``) is ~an
order of magnitude cheaper per point than the historical repr+md5, but an
existing experiment's documents carry md5 ``_id``s — and every consumer
(reservation CAS, duplicate-point unique index, parents lineage) keys on
them.  :class:`IdMigrator` closes the gap with the rebalancer's
state-machine shape, recorded in a per-experiment override doc any crashed
run resumes from:

======================  ======================================================
migration doc state     meaning
======================  ======================================================
(absent)                experiment ids match its ``id_scheme`` — nothing to do
``pinned``              migration claimed; new-id twins are being copied in
``copied``              copy complete and byte-verified; the flip is next
``flipped``             ``id_scheme`` flipped on the experiment doc; old-id
                        originals await deletion
(absent again)          migration complete
======================  ======================================================

Phase order per experiment: pin → copy each trial/lying-trial doc under its
new id (parents lineage remapped old→new in the same pass) → byte-verify
every non-id field against the original (canonical JSON, the same oracle
the rebalancer uses) + clean experiment audit → flip ``id_scheme`` on the
experiment doc → delete the old-id originals → drop the override.  Every
phase is diff-driven off the *recomputable* expected ids (the scheme hash
is a pure function of the params), so re-running any phase is a no-op —
which is the whole crash-resume story: no copied-id manifest to lose.

One code path covers all four backends AND the sharded router: every op
carries the ``experiment`` key (or the experiment's own ``_id``), which is
exactly what :class:`~orion_tpu_torch.storage.shard.ShardedNetworkDB` routes by
— the migration doc, the new-id twins and the deletes all land on the
experiment's home shard without the migrator knowing the topology.

Run it with no active producers on the experiment: a producer that loaded
the pre-flip config would keep registering old-scheme ids after the flip.
"""

import logging
import time

from orion_tpu_torch.core.trial import ID_SCHEMES, compute_scheme_ids
from orion_tpu_torch.space.dsl import build_space
from orion_tpu_torch.storage.audit import audit_experiment
from orion_tpu_torch.storage.documents import dumps_canonical
from orion_tpu_torch.storage.retry import MODE_ALWAYS, create_retry_policy
from orion_tpu_torch.telemetry import TELEMETRY
from orion_tpu_torch.utils.exceptions import DatabaseError, DuplicateKeyError

log = logging.getLogger(__name__)

#: Collections holding docs keyed by a trial id.  ``lying_trials`` ids are
#: hashed with the lie marker, mirroring ``Trial.id``.
ID_COLLECTIONS = (("trials", False), ("lying_trials", True))

#: Per-experiment migration override docs.  NOT ``_placement``: routers
#: interpret that collection's states (pin/fence routing) and the
#: rebalancer's planner sweeps it — id migration is shard-local and must
#: never read as a half-finished move.
MIGRATION_COLLECTION = "_id_migrations"

#: Batched-write chunk for the copy path (one lock hold / wire request per
#: chunk on capable backends).
COPY_BATCH = 256

MIGRATE_RETRY = {
    "max_attempts": 5,
    "base_delay": 0.05,
    "max_delay": 1.0,
    "deadline": 30.0,
}


def migration_doc_id(experiment_id):
    return f"idmig:{experiment_id}"


class IdMigration:
    """One experiment's row in the migration plan."""

    def __init__(self, exp_id, name, version, from_scheme, to_scheme, state):
        self.exp_id = exp_id
        self.name = name
        self.version = version
        self.from_scheme = from_scheme
        self.to_scheme = to_scheme
        self.state = state  # None (fresh) | pinned | copied | flipped
        self.rewritten = 0

    def describe(self):
        return (
            f"{self.name} v{self.version} ({self.exp_id}) "
            f"{self.from_scheme} -> {self.to_scheme}"
            + (f" [{self.state}]" if self.state else "")
        )


class IdMigrator:
    """Crash-resumable trial-id rewriter over any document storage.

    ``crash_at`` is a test hook called with a stage label per experiment
    (``"after_copy"``, ``"after_verify"``, ``"after_flip"``); raising from
    it simulates a migrator crash at that exact point — the crash-resume
    suite drives it."""

    def __init__(self, storage, to_scheme="cube_hash", retry=None,
                 copy_batch=COPY_BATCH, crash_at=None):
        if to_scheme not in ID_SCHEMES:
            raise DatabaseError(
                f"unknown id scheme {to_scheme!r}; one of {ID_SCHEMES}"
            )
        self.storage = storage
        self.db = storage.db
        self.to_scheme = to_scheme
        self.policy = create_retry_policy(
            dict(MIGRATE_RETRY) if retry is None else retry
        )
        self.copy_batch = int(copy_batch)
        self.crash_at = crash_at

    # --- plan ----------------------------------------------------------------
    def plan(self, experiment=None):
        """Experiments whose ids need rewriting: scheme differs from the
        target, or a standing migration doc records an unfinished run.
        Recomputed from storage every time — which is what makes a crashed
        run resumable with no local state."""
        overrides = {
            str(doc.get("experiment")): doc
            for doc in self._read(MIGRATION_COLLECTION, {})
        }
        rows = []
        for doc in self._read("experiments", {}):
            name = doc.get("name")
            if experiment is not None and name != experiment:
                continue
            exp_id = str(doc["_id"])
            scheme = doc.get("id_scheme") or "md5"
            override = overrides.get(exp_id)
            if scheme == self.to_scheme and override is None:
                continue
            rows.append(
                IdMigration(
                    exp_id,
                    name,
                    doc.get("version", 1),
                    scheme,
                    self.to_scheme,
                    override.get("state") if override else None,
                )
            )
        return rows

    # --- run -----------------------------------------------------------------
    def run(self, rows=None, experiment=None):
        """Carry every planned migration to completion; safe to re-run
        after any crash (each phase is diff-driven and convergent)."""
        rows = self.plan(experiment=experiment) if rows is None else rows
        for row in rows:
            self._migrate(row)
        return rows

    def _migrate(self, row):
        space = self._space_for(row.exp_id)
        if row.state is None:
            self._set_state(row, "pinned")
        if row.state == "pinned":
            row.rewritten = self._copy(row, space)
            self._hook("after_copy", row)
            self._verify(row, space)
            self._hook("after_verify", row)
            self._set_state(row, "copied")
        if row.state == "copied":
            self._flip(row)
            self._set_state(row, "flipped")
            self._hook("after_flip", row)
        if row.state == "flipped":
            self._delete_old(row, space)
            self._drop_state(row)
            row.state = None
            TELEMETRY.count("storage.migrated_id_experiments")
            log.info("migrated ids for %s", row.describe())

    def _hook(self, stage, row):
        if self.crash_at is not None:
            self.crash_at(stage, row.exp_id)

    # --- helpers -------------------------------------------------------------
    def _read(self, collection, query):
        return self.policy.run(
            lambda: self.db.read(collection, query),
            op=f"migrate_ids.read.{collection}", mode=MODE_ALWAYS,
        )

    def _space_for(self, exp_id):
        docs = self._read("experiments", {"_id": exp_id})
        if not docs:
            raise DatabaseError(f"experiment {exp_id!r} vanished mid-migration")
        doc = docs[0]
        priors = doc.get("priors") or (doc.get("metadata") or {}).get(
            "priors", {}
        )
        return build_space(priors) if priors else None

    def _id_map(self, row, space):
        """``{collection: [(doc, expected_id), ...]}`` plus the global
        old→new id mapping.  Expected ids are recomputed from the params —
        a pure function, so every phase (and every re-run) agrees on them.
        Docs the target scheme cannot encode keep their ids (the scheme
        helper's deterministic md5 fallback) and drop out of every diff."""
        per_collection = {}
        mapping = {}
        for collection, lie in ID_COLLECTIONS:
            docs = self._read(collection, {"experiment": row.exp_id})
            if not docs:
                per_collection[collection] = []
                continue
            expected = compute_scheme_ids(
                row.exp_id,
                [doc.get("params") or {} for doc in docs],
                lie=lie,
                id_scheme=self.to_scheme,
                space=space,
            )
            pairs = list(zip(docs, expected))
            per_collection[collection] = pairs
            for doc, new_id in pairs:
                mapping[doc.get("_id")] = new_id
        return per_collection, mapping

    def _twin(self, doc, new_id, mapping):
        """The doc's new-id twin: ``_id`` rewritten, parents lineage
        remapped through the same migration; every other field is carried
        byte-for-byte (the verify phase holds us to that)."""
        twin = dict(doc)
        twin["_id"] = new_id
        parents = twin.get("parents")
        if parents:
            twin["parents"] = [mapping.get(p, p) for p in parents]
        return twin

    def _copy(self, row, space):
        """Diff-driven copy-under-new-ids: insert the twins the store
        lacks, overwrite ones that differ.  Convergent under crash/re-run
        — inserts dedup on ``_id``, updates are absolute by-id writes."""
        per_collection, mapping = self._id_map(row, space)
        copied = 0
        for collection, pairs in per_collection.items():
            moving = [(d, n) for d, n in pairs if d.get("_id") != n]
            if not moving:
                continue
            # `pairs` holds EVERY doc in the collection (a crashed run's
            # already-inserted twins included), so it doubles as the
            # presence map — no second read.
            have = {d.get("_id"): _canonical(d) for d, _ in pairs}
            ops = []
            for doc, new_id in moving:
                twin = self._twin(doc, new_id, mapping)
                found = have.get(new_id)
                if found is None:
                    ops.append((twin, None))
                elif found != _canonical(twin):
                    ops.append((twin, new_id))
            for start in range(0, len(ops), self.copy_batch):
                chunk = ops[start:start + self.copy_batch]
                inserts = [t for t, q in chunk if q is None]
                if inserts:
                    self.policy.run(
                        lambda docs=inserts: self._insert(collection, docs),
                        op=f"migrate_ids.copy.{collection}", mode=MODE_ALWAYS,
                    )
                for twin, new_id in chunk:
                    if new_id is None:
                        continue
                    self.policy.run(
                        lambda t=twin, n=new_id: self.db.write(
                            collection,
                            {k: v for k, v in t.items() if k != "_id"},
                            query={"_id": n, "experiment": row.exp_id},
                        ),
                        op=f"migrate_ids.fix.{collection}", mode=MODE_ALWAYS,
                    )
                copied += len(chunk)
        return copied

    def _insert(self, collection, docs):
        try:
            self.db.write(collection, list(docs))
        except DuplicateKeyError:
            # A resend raced its own earlier apply: converge per-doc.
            for doc in docs:
                try:
                    self.db.write(collection, dict(doc))
                except DuplicateKeyError:
                    pass

    def _verify(self, row, space):
        """Every rewritten document must exist under its new id with every
        non-id field BYTE-IDENTICAL to the original (canonical JSON — the
        rebalancer's oracle), parents lineage remapped; and the experiment
        must pass the invariant audit."""
        per_collection, mapping = self._id_map(row, space)
        for collection, pairs in per_collection.items():
            have = {d.get("_id"): _canonical(d) for d, _ in pairs}
            for doc, new_id in pairs:
                if doc.get("_id") == new_id:
                    continue
                twin = self._twin(doc, new_id, mapping)
                found = have.get(new_id)
                if found is None or found != _canonical(twin):
                    raise DatabaseError(
                        f"migrate-ids verify failed for {row.exp_id}: "
                        f"{collection} doc {doc.get('_id')!r} "
                        + ("missing" if found is None else "differs")
                        + f" under new id {new_id!r}"
                    )
        exp_docs = self._read("experiments", {"_id": row.exp_id})
        report = audit_experiment(
            self.storage, exp_docs[0], lost_timeout=3600.0
        )
        # The old-id originals are still present beside their twins here,
        # so the duplicate-point check necessarily sees doubles; every
        # OTHER invariant must hold.  (The post-delete `audit --all` the
        # acceptance gate runs sees a fully clean experiment.)
        real = [
            v for v in report.violations
            if v.get("check") != "duplicate-point"
        ]
        if real:
            raise DatabaseError(
                f"migrate-ids verify failed for {row.exp_id}: audit dirty: "
                f"{real}"
            )

    def _flip(self, row):
        self.policy.run(
            lambda: self.db.write(
                "experiments",
                {"id_scheme": self.to_scheme},
                query={"_id": row.exp_id},
            ),
            op="migrate_ids.flip", mode=MODE_ALWAYS,
        )

    def _delete_old(self, row, space):
        """Remove the old-id originals (only reached after the flip): any
        doc whose id differs from its expected id while the expected id
        exists is a pre-migration original."""
        per_collection, _mapping = self._id_map(row, space)
        for collection, pairs in per_collection.items():
            present = {doc.get("_id") for doc, _ in pairs}
            for doc, new_id in pairs:
                old_id = doc.get("_id")
                if old_id == new_id or new_id not in present:
                    continue
                self.policy.run(
                    lambda o=old_id: self.db.remove(
                        collection, {"_id": o, "experiment": row.exp_id}
                    ),
                    op=f"migrate_ids.delete.{collection}", mode=MODE_ALWAYS,
                )

    # --- migration-state doc -------------------------------------------------
    def _set_state(self, row, state):
        """Upsert the override doc — same write-with-query / insert /
        re-update race handling as the rebalancer's placement CAS."""
        doc_id = migration_doc_id(row.exp_id)
        # Queries carry the experiment key so the sharded router routes
        # them straight to the experiment's home shard (no fan-out).
        query = {"_id": doc_id, "experiment": row.exp_id}
        fields = {
            "experiment": row.exp_id,
            "state": state,
            "to": self.to_scheme,
            "ts": time.time(),
        }

        def upsert():
            if self.db.write(MIGRATION_COLLECTION, dict(fields), query=dict(query)):
                return
            try:
                self.db.write(MIGRATION_COLLECTION, dict(fields, _id=doc_id))
            except DuplicateKeyError:
                self.db.write(
                    MIGRATION_COLLECTION, dict(fields), query=dict(query)
                )

        self.policy.run(
            upsert, op=f"migrate_ids.state.{state}", mode=MODE_ALWAYS
        )
        row.state = state

    def _drop_state(self, row):
        doc_id = migration_doc_id(row.exp_id)
        self.policy.run(
            lambda: self.db.remove(
                MIGRATION_COLLECTION,
                {"_id": doc_id, "experiment": row.exp_id},
            ),
            op="migrate_ids.state.drop", mode=MODE_ALWAYS,
        )


def _canonical(doc):
    try:
        return dumps_canonical(doc)
    except TypeError:  # pragma: no cover - non-JSON legacy value
        return repr(sorted(doc.items(), key=lambda kv: kv[0]))
