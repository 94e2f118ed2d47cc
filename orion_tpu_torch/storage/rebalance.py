"""Live ring rebalancing: move experiments to their ring homes without
stopping the hunt (port of ``orion_tpu/storage/rebalance.py``: the same
plan, the same placement states and byte-identical moved documents).

Adding (or removing) a shard changes the consistent-hash ring: ~1/N of
the experiments now hash to a different shard, but their documents still
live where the OLD ring put them.  :class:`Rebalancer` closes that gap —
``orion-tpu-torch db rebalance`` drives it — by migrating each displaced
experiment through a crash-resumable state machine recorded in a
per-experiment *placement override* doc that every router consults
before the ring (``storage/shard.py``):

======================  ======================================================
placement doc state     meaning
======================  ======================================================
(absent)                the experiment lives at its ring home — ring routes
``pinned``  @ source    override routes to the source; the migrator is
                        copying collections to the destination
``fenced``  @ source    flip window: routers hold experiment ops with a
                        transient error (the op-level retry re-routes after
                        the flip); never cached, so the window stays short
``moved``   @ dest      flip done: routers route to the destination; the
                        source copy and the override itself await deletion
(absent again)          move complete — the ring IS the placement again
======================  ======================================================

The override doc lives on the experiment's (new-)ring shard — the one
place any router can find without knowing the answer.  Phase order per
run: pin every mover, copy (batched, per-slot convergent), fence every
mover, wait ONE placement-TTL grace so every router cache expires and
observes the fence, then per mover delta-copy + verify **byte-identical**
documents + clean destination audit, flip, delete the source copy, drop
the override.  A crash anywhere resumes idempotently: the next run
recomputes the plan from the standing placement docs and actual document
locations and continues from the recorded state — copy and delete are
diff-driven (re-running them is a no-op), the flip is a single-doc
upsert.

Writes during migration: the pin keeps every router writing to the
SOURCE while copies run (the delta pass after the fence picks those up);
the fence holds writes entirely across verify+flip.  A router that
cached the pin just before the fence re-reads within one TTL — which is
exactly why the fence grace must cover ``placement_ttl``.
"""

import logging
import time
from collections import Counter

from orion_tpu_torch.health import FLIGHT
from orion_tpu_torch.storage.audit import audit_experiment
from orion_tpu_torch.storage.base import DocumentStorage
from orion_tpu_torch.storage.documents import dumps_canonical
from orion_tpu_torch.storage.retry import MODE_ALWAYS, create_retry_policy
from orion_tpu_torch.storage.shard import PLACEMENT_COLLECTION, placement_doc_id
from orion_tpu_torch.telemetry import TELEMETRY
from orion_tpu_torch.utils.exceptions import DatabaseError, DuplicateKeyError

log = logging.getLogger(__name__)

#: Per-experiment collections keyed by the ``experiment`` field; the
#: experiments doc itself moves by ``_id``.  Everything a shard holds for
#: one experiment is one of these (INDEX_SPECS + the telemetry channel).
EXPERIMENT_COLLECTIONS = (
    "trials",
    "lying_trials",
    "telemetry",
    "metrics",
    "spans",
    "health",
)

#: Diagnostics channels whose ``_id`` is the backend's per-shard
#: auto-increment counter: the same integer id names DIFFERENT documents
#: on different shards, so two experiments migrating onto one shard
#: collide on ``_id`` even though their documents are unrelated.  These
#: move by experiment-scoped CONTENT (id stripped, destination assigns a
#: fresh id); everything else keeps its id byte-identical.
AUTO_ID_COLLECTIONS = frozenset(("telemetry", "metrics", "spans", "health"))

#: Batched-write chunk for the copy path: one ``apply_batch`` wire request
#: per chunk (one lock hold / transaction server-side).
COPY_BATCH = 256

#: Retry knobs for migration ops (tighter deadline than the op-level
#: default: the migrator is a foreground CLI command).
REBALANCE_RETRY = {
    "max_attempts": 5,
    "base_delay": 0.05,
    "max_delay": 1.0,
    "deadline": 30.0,
}


class Move:
    """One experiment's migration row in the plan."""

    def __init__(self, exp_id, name, version, src_index, dst_index, state):
        self.exp_id = exp_id
        self.name = name
        self.version = version
        self.src_index = src_index
        self.dst_index = dst_index
        self.state = state  # None (fresh) | pinned | fenced | moved

    def describe(self):
        return (
            f"{self.name} v{self.version} ({self.exp_id}) "
            f"shard {self.src_index} -> {self.dst_index}"
            + (f" [{self.state}]" if self.state else "")
        )


class RebalancePlan:
    """Ring diff: which experiments move, which stay."""

    def __init__(self, moves, stays, strays):
        self.moves = moves
        self.stays = stays
        self.strays = strays  # [(exp_id, [indices])] — need operator eyes

    @property
    def total(self):
        return len(self.moves) + self.stays

    @property
    def move_fraction(self):
        return len(self.moves) / self.total if self.total else 0.0

    def summary(self):
        return {
            "experiments": self.total,
            "moves": len(self.moves),
            "stays": self.stays,
            "move_fraction": round(self.move_fraction, 4),
            "strays": len(self.strays),
        }


class Rebalancer:
    """Crash-resumable experiment migrator over a
    :class:`~orion_tpu_torch.storage.shard.ShardedNetworkDB` router.

    ``crash_at`` is a test hook called with a stage label per experiment
    (``"after_pin"``, ``"after_copy"``, ``"after_fence"``,
    ``"after_verify"``, ``"after_flip"``); raising from it simulates a
    migrator crash at that exact point — the crash-resume suite drives
    it.  ``fence_grace`` defaults to the router's placement TTL: the flip
    is only safe once every router's cached pre-fence placement has
    expired."""

    def __init__(self, router, retry=None, fence_grace=None, copy_batch=COPY_BATCH,
                 crash_at=None, sleep=time.sleep):
        self.router = router
        self.policy = create_retry_policy(
            dict(REBALANCE_RETRY) if retry is None else retry
        )
        self.fence_grace = (
            router.placement_ttl if fence_grace is None else float(fence_grace)
        )
        self.copy_batch = int(copy_batch)
        self.crash_at = crash_at
        self._sleep = sleep
        self._conns = dict(router.shard_connections())

    # --- plan ----------------------------------------------------------------
    def plan(self):
        """Compute the ring diff from ACTUAL document locations: for every
        experiment, where its documents live (standing placement docs
        first — they encode a mid-flight migration — then the shard its
        doc is found on) versus where the CURRENT ring says it belongs.
        Needs no record of the old topology, which is also exactly what
        makes a crashed run resumable."""
        placements = {}
        for index, conn in self._conns.items():
            docs = self.policy.run(
                lambda conn=conn: conn.read(PLACEMENT_COLLECTION, {}),
                op="rebalance.plan.placements", mode=MODE_ALWAYS,
            )
            for doc in docs:
                placements[str(doc.get("experiment"))] = doc
        located = {}
        meta = {}
        for index, conn in self._conns.items():
            docs = self.policy.run(
                lambda conn=conn: conn.read("experiments", {}),
                op="rebalance.plan.experiments", mode=MODE_ALWAYS,
            )
            for doc in docs:
                exp_id = str(doc["_id"])
                located.setdefault(exp_id, []).append(index)
                meta.setdefault(
                    exp_id, (doc.get("name"), doc.get("version", 1))
                )
        moves, stays, strays = [], 0, []
        for exp_id in sorted(set(located) | set(placements)):
            name, version = meta.get(exp_id, ("?", "?"))
            dst_index = self.router.shard_for(exp_id)
            placement = placements.get(exp_id)
            if placement is not None:
                state = placement.get("state")
                identity = placement.get("shard")
                src_index = self._index_of(identity)
                if src_index is None:
                    strays.append((exp_id, [identity]))
                    continue
                if state == "moved":
                    # Flip done; src is wherever stale copies remain.
                    stale = [i for i in located.get(exp_id, ()) if i != dst_index]
                    src_index = stale[0] if stale else src_index
                    moves.append(
                        Move(exp_id, name, version, src_index, dst_index, state)
                    )
                    continue
                if src_index == dst_index and state in (None, "pinned"):
                    # An override pointing at the ring home: leftover from
                    # an aborted plan — just drop it.
                    moves.append(
                        Move(exp_id, name, version, src_index, dst_index, "moved")
                    )
                    continue
                moves.append(
                    Move(exp_id, name, version, src_index, dst_index, state)
                )
                continue
            homes = located.get(exp_id, [])
            if dst_index in homes and len(homes) == 1:
                stays += 1
                continue
            if len(homes) > 1:
                # No override yet the experiment exists on several shards:
                # not a state this machine produces — operator eyes needed.
                strays.append((exp_id, homes))
                continue
            if not homes:
                continue  # placement-only ghost handled above
            moves.append(Move(exp_id, name, version, homes[0], dst_index, None))
        return RebalancePlan(moves, stays, strays)

    def _index_of(self, identity):
        for index, conn in self._conns.items():
            if f"{conn.host}:{conn.port}" == identity:
                return index
        # The identity may be a shard's RING identity while the connection
        # points at a promoted replica — resolve through the router.
        return self.router._identity_index.get(identity)

    # --- run -----------------------------------------------------------------
    def run(self, plan=None):
        """Execute ``plan`` (or a fresh one) to completion; returns the
        plan with every move carried out.  Safe to re-run after any crash."""
        plan = self.plan() if plan is None else plan
        if plan.strays:
            raise DatabaseError(
                f"rebalance refuses to run with {len(plan.strays)} stray "
                f"experiment(s) living on multiple shards without a "
                f"placement record: {plan.strays[:3]} — resolve manually "
                "(db copy + remove) first"
            )
        movers = [m for m in plan.moves if m.state != "moved"]
        finishers = [m for m in plan.moves if m.state == "moved"]
        # Phase 1+2: pin + copy (routers keep writing to the source).
        self._note_phase("pin_copy")
        for move in movers:
            if move.state is None:
                self._set_placement(move, "pinned", self._identity(move.src_index))
                move.state = "pinned"
                self._hook("after_pin", move)
            self._copy(move)
            self._hook("after_copy", move)
            self._note_progress()
        # Phase 3: fence every mover, then ONE grace wait covering the
        # placement TTL — after it, every router observes the fence.
        self._note_phase("fence")
        for move in movers:
            if move.state == "pinned":
                self._set_placement(move, "fenced", self._identity(move.src_index))
                move.state = "fenced"
                self._hook("after_fence", move)
                self._note_progress()
        if movers and self.fence_grace > 0:
            self._sleep(self.fence_grace)
        # Phase 4: delta-copy + verify + flip, one mover at a time.
        self._note_phase("verify_flip")
        for move in movers:
            self._copy(move)  # the delta written since the first pass
            self._verify(move)
            self._hook("after_verify", move)
            self._set_placement(move, "moved", self._identity(move.dst_index))
            move.state = "moved"
            if FLIGHT.enabled:
                FLIGHT.record(
                    "rebalance.flip",
                    args={"experiment": move.exp_id, "dst": move.dst_index},
                )
            self._hook("after_flip", move)
            self._note_progress()
        # Phase 5+6: delete the source copy, then drop the override — the
        # ring IS the placement again.
        self._note_phase("cleanup")
        for move in movers + finishers:
            self._delete_source(move)
            self._drop_placement(move)
            TELEMETRY.count("storage.shard.rebalanced_experiments")
            log.info("rebalanced %s", move.describe())
            self._note_progress()
        self._note_phase(None)
        return plan

    def _hook(self, stage, move):
        if self.crash_at is not None:
            self.crash_at(stage, move.exp_id)

    def _note_phase(self, name):
        """Phase-boundary hook (``None`` = run complete).  The base
        migrator publishes nothing; the drain specialization books the
        ``storage.drain.phase_age_s`` gauge."""

    def _note_progress(self):
        """Per-move progress hook inside a phase (see :meth:`_note_phase`)."""

    def _identity(self, index):
        conn = self._conns[index]
        for shard in self.router._shards:
            if shard.index == index:
                return shard.identity
        return f"{conn.host}:{conn.port}"  # pragma: no cover - defensive

    # --- placement ops (batched + explicit retry mode) ----------------------
    def _placement_conn(self, move):
        """The shard holding ``move``'s override doc: the experiment's
        CURRENT-ring home — the destination for a rebalance (the ring
        already points there), the SOURCE for a drain (the drained shard
        is still on the routers' ring until ``set_topology`` drops it)."""
        return self._conns[move.dst_index]

    def _set_placement(self, move, state, identity):
        """Upsert the override doc on the experiment's ring shard
        (:meth:`_placement_conn`) — the single-doc CAS every router's
        routing consults.  Converges under re-application: an absolute
        by-id upsert."""
        dst = self._placement_conn(move)
        doc_id = placement_doc_id(move.exp_id)
        fields = {
            "experiment": move.exp_id,
            "state": state,
            "shard": identity,
            "ts": time.time(),
        }

        def upsert():
            if dst.write(PLACEMENT_COLLECTION, dict(fields), query={"_id": doc_id}):
                return
            try:
                dst.write(PLACEMENT_COLLECTION, dict(fields, _id=doc_id))
            except DuplicateKeyError:
                # Raced our own resend: the doc exists now — update wins.
                dst.write(PLACEMENT_COLLECTION, dict(fields), query={"_id": doc_id})

        self.policy.run(
            upsert, op=f"rebalance.placement.{state}", mode=MODE_ALWAYS
        )

    def _drop_placement(self, move):
        dst = self._placement_conn(move)
        doc_id = placement_doc_id(move.exp_id)
        self.policy.run(
            lambda: dst.remove(PLACEMENT_COLLECTION, {"_id": doc_id}),
            op="rebalance.placement.drop", mode=MODE_ALWAYS,
        )

    # --- copy / verify / delete ----------------------------------------------
    def _exp_docs(self, conn, collection, exp_id):
        if collection == "experiments":
            query = {"_id": exp_id}
        else:
            query = {"experiment": exp_id}
        return self.policy.run(
            lambda: conn.read(collection, query),
            op=f"rebalance.read.{collection}", mode=MODE_ALWAYS,
        )

    def _copy(self, move):
        """Diff-driven batched copy source -> destination: insert what the
        destination lacks, overwrite what differs (byte-identical target).
        Convergent under crash/re-run — inserts dedup on ``_id``, updates
        are absolute by-id writes."""
        src = self._conns[move.src_index]
        dst = self._conns[move.dst_index]
        copied = 0
        for collection in ("experiments",) + EXPERIMENT_COLLECTIONS:
            src_docs = self._exp_docs(src, collection, move.exp_id)
            if not src_docs:
                continue
            dst_docs = self._exp_docs(dst, collection, move.exp_id)
            ops = []
            if collection in AUTO_ID_COLLECTIONS:
                # Content-keyed diff: insert only the multiset difference,
                # id stripped so the destination assigns from ITS counter
                # (a copied id could collide with a co-resident
                # experiment's rows).  Convergent under crash/re-run —
                # already-copied rows count toward the destination
                # multiset regardless of the id they landed under.
                have = Counter(_canonical(_strip_id(d)) for d in dst_docs)
                for doc in src_docs:
                    key = _canonical(_strip_id(doc))
                    if have[key] > 0:
                        have[key] -= 1
                        continue
                    ops.append(("write", [collection, _strip_id(doc)], {}))
            else:
                dst_by_id = {d.get("_id"): _canonical(d) for d in dst_docs}
                for doc in src_docs:
                    _id = doc.get("_id")
                    have = dst_by_id.get(_id)
                    if have is None:
                        ops.append(("write", [collection, doc], {}))
                    elif have != _canonical(doc):
                        ops.append(
                            (
                                "write",
                                [collection, _strip_id(doc)],
                                {"query": {"_id": _id}},
                            )
                        )
            for start in range(0, len(ops), self.copy_batch):
                chunk = ops[start:start + self.copy_batch]
                outcomes = self.policy.run(
                    lambda chunk=chunk: dst.apply_batch(chunk),
                    op=f"rebalance.copy.{collection}", mode=MODE_ALWAYS,
                )
                for outcome in outcomes:
                    if isinstance(outcome, DuplicateKeyError):
                        continue  # a resend raced its own earlier apply
                    if isinstance(outcome, Exception):
                        raise outcome
                copied += len(chunk)
        if copied and FLIGHT.enabled:
            FLIGHT.record(
                "rebalance.copy",
                args={"experiment": move.exp_id, "docs": copied},
            )
        return copied

    def _verify(self, move):
        """Every source document must exist BYTE-IDENTICAL on the
        destination (canonical JSON — the same oracle ``db copy`` uses),
        and the destination must pass the invariant audit for this
        experiment.  Runs inside the fence, so the comparison is stable."""
        src = self._conns[move.src_index]
        dst = self._conns[move.dst_index]
        for collection in ("experiments",) + EXPERIMENT_COLLECTIONS:
            src_docs = self._exp_docs(src, collection, move.exp_id)
            if not src_docs:
                continue
            dst_docs = self._exp_docs(dst, collection, move.exp_id)
            if collection in AUTO_ID_COLLECTIONS:
                # Auto-increment channels moved by content: every source
                # row must exist on the destination with identical bytes
                # OUTSIDE the id (the destination assigned its own).
                have = Counter(_canonical(_strip_id(d)) for d in dst_docs)
                for doc in src_docs:
                    key = _canonical(_strip_id(doc))
                    if have[key] <= 0:
                        raise DatabaseError(
                            f"rebalance verify failed for {move.exp_id}: "
                            f"{collection} doc {doc.get('_id')!r} missing "
                            "on the destination shard"
                        )
                    have[key] -= 1
                continue
            dst_by_id = {d.get("_id"): _canonical(d) for d in dst_docs}
            for doc in src_docs:
                have = dst_by_id.get(doc.get("_id"))
                if have is None or have != _canonical(doc):
                    raise DatabaseError(
                        f"rebalance verify failed for {move.exp_id}: "
                        f"{collection} doc {doc.get('_id')!r} "
                        + ("missing" if have is None else "differs")
                        + " on the destination shard"
                    )
        # Audit exactly THIS experiment on the destination (the movers are
        # fenced for the whole verify loop — auditing every co-resident
        # experiment per move would grow the write-unavailability window
        # with the shard's population, not with the work being verified).
        exp_docs = self._exp_docs(dst, "experiments", move.exp_id)
        if exp_docs:
            report = audit_experiment(
                DocumentStorage(dst), exp_docs[0], lost_timeout=3600.0
            )
            if not report.ok:
                raise DatabaseError(
                    f"rebalance verify failed for {move.exp_id}: destination "
                    f"audit dirty: {report.violations}"
                )

    def _delete_source(self, move):
        """Remove the experiment's documents from the source shard (only
        reached after the flip — routers no longer route there)."""
        if move.src_index == move.dst_index:
            return
        src = self._conns[move.src_index]
        removed = 0
        for collection in EXPERIMENT_COLLECTIONS:
            removed += self.policy.run(
                lambda collection=collection: src.remove(
                    collection, {"experiment": move.exp_id}
                ),
                op=f"rebalance.delete.{collection}", mode=MODE_ALWAYS,
            ) or 0
        removed += self.policy.run(
            lambda: src.remove("experiments", {"_id": move.exp_id}),
            op="rebalance.delete.experiments", mode=MODE_ALWAYS,
        ) or 0
        if removed and FLIGHT.enabled:
            FLIGHT.record(
                "rebalance.delete",
                args={"experiment": move.exp_id, "docs": removed},
            )


def _canonical(doc):
    try:
        return dumps_canonical(doc)
    except TypeError:  # pragma: no cover - non-JSON legacy value
        return repr(sorted(doc.items(), key=lambda kv: kv[0]))


def _strip_id(doc):
    return {k: v for k, v in doc.items() if k != "_id"}
