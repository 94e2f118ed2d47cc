"""Shard drain: remove a shard from the topology with zero lost documents
(port of ``orion_tpu/storage/drain.py``: the same survivor-ring plan and
refusals).

``orion-tpu-torch db drain SHARD`` is the planned-change half of day-2
storage operations (the unplanned half is replica auto-reprovisioning and
quorum mode).  Shrinking a topology with a bare ``set_topology`` would
strand every document the drained shard holds; the :class:`Drainer` runs
the ring diff **before** the shard disappears and migrates each resident
experiment through the same crash-resumable pin → copy → byte-verify →
flip placement-override machinery live rebalancing uses
(``storage/rebalance.py``) — with two deliberate inversions:

- **Destinations come from the SURVIVOR ring** (the current ring minus the
  drained shard, same vnodes): each resident experiment moves to exactly
  the shard the post-removal ring will hash it to, so dropping the shard
  afterwards changes nothing about placement.
- **Placement overrides live on the DRAINED shard** — the experiments'
  ring home on the topology the routers still run.  Any router resolves a
  drained experiment's ring home TO the drained shard, reads the override
  there, and follows it.  The ``moved`` override is therefore **kept**
  after the flip (the base migrator drops it): it is the only thing
  routing live traffic to the destination until ``set_topology`` removes
  the shard, at which point the new ring maps those experiments straight
  to the destination and the override — gone with the shard — is no
  longer consulted by anyone.

Phase order and crash-resume semantics are inherited from the base
migrator; a re-run recomputes the plan from the standing placement docs
on the drained shard and resumes.  When the drain completes the shard
holds only its ``_placement`` docs (and server-internal bookkeeping);
:meth:`Drainer.residual_experiments` is the completeness check the CLI
and the soak gate assert on.

The drain publishes ``storage.drain.phase_age_s`` — seconds since the
current phase last made progress, 0 between runs — the gauge a stuck
drain shows on (the doctor's ``drain-stuck`` rule, DX060, reads it).
"""

import logging
import threading
import time

from orion_tpu_torch.analysis.sanitizer import TSAN
from orion_tpu_torch.storage.rebalance import Move, RebalancePlan, Rebalancer
from orion_tpu_torch.storage.retry import MODE_ALWAYS
from orion_tpu_torch.storage.shard import PLACEMENT_COLLECTION, HashRing
from orion_tpu_torch.telemetry import TELEMETRY
from orion_tpu_torch.utils.exceptions import DatabaseError

log = logging.getLogger(__name__)

#: Seconds since the drain's current phase last made progress.
DRAIN_PHASE_AGE_GAUGE = "storage.drain.phase_age_s"


class Drainer(Rebalancer):
    """Crash-resumable drain of one shard over a
    :class:`~orion_tpu_torch.storage.shard.ShardedNetworkDB` router.

    ``drain_index`` names the shard to empty.  The router must still carry
    the shard (drain runs BEFORE the topology change); call
    ``set_topology`` with the surviving specs once :meth:`run` returns and
    :meth:`residual_experiments` reports zero."""

    def __init__(self, router, drain_index, **kwargs):
        super().__init__(router, **kwargs)
        self.drain_index = int(drain_index)
        if self.drain_index not in self._conns:
            raise DatabaseError(
                f"no shard at index {self.drain_index} "
                f"(topology has {len(self._conns)} shard(s))"
            )
        identities = {s.index: s.identity for s in router._shards}
        self.drain_identity = identities[self.drain_index]
        survivors = [
            identities[i] for i in sorted(identities) if i != self.drain_index
        ]
        if not survivors:
            raise DatabaseError(
                "refusing to drain the only shard — nothing would survive "
                "to receive its documents"
            )
        #: The post-removal ring: same identities minus the drained one,
        #: same vnodes — deterministic, so a crashed drain re-run computes
        #: identical destinations.
        self._dst_ring = HashRing(survivors, vnodes=router._ring.vnodes)
        self._survivors = survivors
        self._identity_to_index = {v: k for k, v in identities.items()}
        # Phase state shared with concurrent gauge readers (the state
        # itself is also inspected by tests) — every access under the lock.
        self._phase_lock = threading.Lock()
        self._phase = None
        self._phase_since = time.monotonic()

    # --- plan ----------------------------------------------------------------
    def _dst_index(self, exp_id):
        """Post-removal ring home of one experiment, as a CURRENT-topology
        shard index."""
        identity = self._survivors[self._dst_ring.lookup(str(exp_id))]
        return self._identity_to_index[identity]

    def plan(self):
        """Every experiment RESIDENT on the drained shard, destined for
        its survivor-ring home.  Refuses (as strays) anything that needs a
        rebalance first: a resident experiment whose current-ring home is
        some OTHER shard (its move belongs to ``db rebalance``), an
        experiment ring-homed here but living elsewhere without an
        override, and any unfinished migration state found on other
        shards — one migrator owns the placement machinery at a time."""
        placements = {}
        foreign_placements = []
        for index, conn in self._conns.items():
            docs = self.policy.run(
                lambda conn=conn: conn.read(PLACEMENT_COLLECTION, {}),
                op="drain.plan.placements", mode=MODE_ALWAYS,
            )
            for doc in docs:
                exp_id = str(doc.get("experiment"))
                if index == self.drain_index:
                    placements[exp_id] = doc
                else:
                    foreign_placements.append((exp_id, [index]))
        located = {}
        meta = {}
        for index, conn in self._conns.items():
            docs = self.policy.run(
                lambda conn=conn: conn.read("experiments", {}),
                op="drain.plan.experiments", mode=MODE_ALWAYS,
            )
            for doc in docs:
                exp_id = str(doc["_id"])
                located.setdefault(exp_id, []).append(index)
                meta.setdefault(
                    exp_id, (doc.get("name"), doc.get("version", 1))
                )
        moves, stays, strays = [], 0, list(foreign_placements)
        for exp_id in sorted(set(located) | set(placements)):
            name, version = meta.get(exp_id, ("?", "?"))
            homes = located.get(exp_id, [])
            placement = placements.get(exp_id)
            ring_home = self.router.shard_for(exp_id)
            if placement is None and self.drain_index not in homes:
                if ring_home == self.drain_index and homes:
                    # Ring-homed here but living elsewhere with no
                    # override: a half-finished REBALANCE this machine
                    # didn't start — operator eyes.
                    strays.append((exp_id, homes))
                else:
                    stays += 1
                continue
            if placement is None and ring_home != self.drain_index:
                # Resident here but ring-homed elsewhere: a pending
                # `db rebalance` — running both diffs as one would race
                # the other migrator's state machine.
                strays.append((exp_id, homes))
                continue
            dst_index = self._dst_index(exp_id)
            state = placement.get("state") if placement is not None else None
            if state == "moved":
                moves.append(
                    Move(
                        exp_id, name, version,
                        self.drain_index, dst_index, "moved",
                    )
                )
                continue
            moves.append(
                Move(exp_id, name, version, self.drain_index, dst_index, state)
            )
        return RebalancePlan(moves, stays, strays)

    # --- base-machinery inversions -------------------------------------------
    def _placement_conn(self, move):
        """Override docs live on the DRAINED shard — the experiments' ring
        home on the topology the routers still run (module docstring)."""
        return self._conns[self.drain_index]

    def _drop_placement(self, move):
        """Keep the ``moved`` override: it routes live traffic to the
        destination until ``set_topology`` removes the drained shard (and
        the override with it).  Dropping it here would bounce routers back
        to the ring — which still names the drained, now-empty shard."""

    # --- phase-age gauge -----------------------------------------------------
    def _note_phase(self, name):
        with self._phase_lock:
            TSAN.write("Drainer._phase", self)
            self._phase = name
            self._phase_since = time.monotonic()
        TELEMETRY.set_gauge(DRAIN_PHASE_AGE_GAUGE, 0.0)

    def _note_progress(self):
        with self._phase_lock:
            TSAN.write("Drainer._phase", self)
            since = self._phase_since
        TELEMETRY.set_gauge(
            DRAIN_PHASE_AGE_GAUGE, max(0.0, time.monotonic() - since)
        )

    def phase(self):
        """``(phase_name_or_None, seconds_in_phase)`` — operator surface."""
        with self._phase_lock:
            TSAN.write("Drainer._phase", self)
            return self._phase, max(0.0, time.monotonic() - self._phase_since)

    # --- completeness --------------------------------------------------------
    def residual_experiments(self):
        """Experiment ids still resident on the drained shard — must be
        empty before ``set_topology`` may drop it.  (``_placement`` docs
        and server bookkeeping are EXPECTED to remain; they vanish with
        the shard.)"""
        conn = self._conns[self.drain_index]
        docs = self.policy.run(
            lambda: conn.read("experiments", {}),
            op="drain.residual", mode=MODE_ALWAYS,
        )
        return [str(doc["_id"]) for doc in docs]

    def ring_share(self):
        """Fraction of the hash space the drained shard owns on the
        CURRENT ring — the expected move fraction (the soak gate bounds
        the observed fraction by 2x of this)."""
        ring = self.router._ring
        span = 1 << 64
        total = 0
        hashes, indices = ring._hashes, ring._indices
        for position, point in enumerate(hashes):
            if indices[position] != self.drain_index:
                continue
            previous = hashes[position - 1] if position else hashes[-1] - span
            total += point - previous
        return total / span
