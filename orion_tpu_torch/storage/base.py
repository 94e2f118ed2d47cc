"""Storage protocol: every coordination primitive workers rely on (port of
``orion_tpu/storage/base.py`` over the local backends ``memory``,
``pickled`` and ``sqlite``, the ``network`` client and the sharded router
of ``shards:``, with the reference's telemetry: a span and a
``storage.<backend>.<op>`` histogram per hot-path op, the backends' own
counters, the ``trial.status`` flight event, and the metrics and spans
channels the workers flush through).

Capability parity: reference `src/orion/storage/base.py` (BaseStorageProtocol,
singleton access) + `src/orion/storage/legacy.py` (protocol mapped onto a
document DB: unique (name, version) experiment index, atomic trial
reservation via find-one-and-update, CAS status updates raising FailedUpdate,
stale-heartbeat lost-trial queries, lies in a separate collection).

Timestamps are ``time.time()`` floats everywhere (device-friendly and
pickle-stable), not datetimes.
"""

import functools
import time

from orion_tpu_torch.core.trial import RESERVABLE_STATUSES, Trial
from orion_tpu_torch.health import FLIGHT
from orion_tpu_torch.storage.backends import PickledDB
from orion_tpu_torch.storage.documents import MemoryDB
from orion_tpu_torch.storage.retry import MODE_ALWAYS, MODE_UNAPPLIED, create_retry_policy
from orion_tpu_torch.telemetry import (
    TELEMETRY,
    current_trace_context,
    set_trace_context,
)
from orion_tpu_torch.utils.exceptions import DatabaseError, FailedUpdate


class BaseStorage:
    """Abstract protocol; see :class:`DocumentStorage` for the semantics.

    The batch operations (``register_trials`` / ``reserve_trials`` /
    ``update_completed_trials``) ship DEFAULT loop implementations over
    their singular siblings, so a third-party storage protocol that only
    defines the per-trial ops automatically satisfies the batch API the
    producer and client commit through.  Backends that can amortize
    (:class:`DocumentStorage` over a transactional or networked store)
    override them with single-transaction / single-round-trip versions —
    semantics are identical either way: one outcome per slot, a failing
    slot never blocking the rest."""

    def create_experiment(self, config):
        raise NotImplementedError

    def update_experiment(self, experiment=None, uid=None, where=None, **kwargs):
        raise NotImplementedError

    def fetch_experiments(self, query, projection=None):
        raise NotImplementedError

    def register_trial(self, trial):
        raise NotImplementedError

    def register_trials(self, trials):
        """Batch-register: one outcome per trial — the trial itself, or the
        exception (DuplicateKeyError for an already-taken point) that slot
        raised.  Default loop fallback; see the class docstring."""
        out = []
        for trial in trials:
            try:
                out.append(self.register_trial(trial))
            except Exception as exc:
                out.append(exc)
        return out

    def reserve_trials(self, experiment, num):
        """Claim up to ``num`` pending trials.  Default loop fallback."""
        out = []
        for _ in range(max(0, num)):
            trial = self.reserve_trial(experiment)
            if trial is None:
                break
            out.append(trial)
        return out

    def update_completed_trials(self, pairs):
        """Batch-complete ``[(trial, results), ...]``: one outcome per pair
        — the completed trial, or the exception that slot raised (a
        failing slot never aborts the rest; same containment the batched
        backends give).  Default loop fallback."""
        out = []
        for trial, results in pairs:
            try:
                out.append(self.update_completed_trial(trial, results))
            except Exception as exc:
                out.append(exc)
        return out

    def register_lie(self, trial):
        raise NotImplementedError

    def register_lies(self, trials):
        """Batch-register lying trials: one outcome per trial — the trial,
        or the exception its slot raised (DuplicateKeyError for a lie
        already registered).  Default loop fallback."""
        out = []
        for trial in trials:
            try:
                out.append(self.register_lie(trial))
            except Exception as exc:
                out.append(exc)
        return out

    # --- optional capabilities ----------------------------------------------
    # Default no-ops so third-party storage protocols keep satisfying the
    # producer's flush path (which is fire-and-forget anyway).
    def record_timings(self, experiment, samples):
        """Append ``[(op, duration, count), ...]`` timing samples."""

    def record_metrics(self, experiment, snapshot, worker=None):
        """Upsert one worker's telemetry metrics snapshot."""

    def fetch_metrics(self, experiment):
        """All workers' metric snapshot docs for ``experiment``."""
        return []

    def record_spans(self, experiment, spans):
        """Append drained span records for ``experiment``."""

    def fetch_spans(self, experiment):
        """Every stored span record for ``experiment``, time-ordered."""
        return []

    def record_health(self, experiment, record, worker=None):
        """Append one per-round optimization-health record."""

    def fetch_health(self, experiment):
        """Every stored health record for ``experiment``, time-ordered."""
        return []

    def fetch_lies(self, experiment):
        raise NotImplementedError

    def reserve_trial(self, experiment):
        raise NotImplementedError

    def fetch_trials(self, experiment=None, uid=None):
        raise NotImplementedError

    def fetch_trials_by_status(self, experiment, status):
        raise NotImplementedError

    def get_trial(self, trial=None, uid=None):
        raise NotImplementedError

    def set_trial_status(self, trial, status, was=None):
        raise NotImplementedError

    def update_heartbeat(self, trial):
        raise NotImplementedError

    def fetch_lost_trials(self, experiment, timeout):
        raise NotImplementedError

    def push_trial_results(self, trial):
        raise NotImplementedError

    def update_completed_trial(self, trial, results):
        raise NotImplementedError

    def count_completed_trials(self, experiment):
        raise NotImplementedError

    def count_broken_trials(self, experiment):
        raise NotImplementedError

    def fetch_noncompleted_trials(self, experiment):
        raise NotImplementedError


# Canonical index layout; the unique specs double as the conflict oracle for
# `orion-tpu db copy` pre-flight planning (cli/db.py).
INDEX_SPECS = [
    # The user is part of experiment identity (per-user namespacing):
    # two users may own same-named experiments.
    ("experiments", ["name", "version", "metadata.user"], True),
    ("trials", ["experiment"], False),
    ("trials", ["status"], False),
    ("trials", ["experiment", "status"], False),
    ("lying_trials", ["experiment"], False),
    # Unified-telemetry channel: spans are counted/pruned and metrics
    # upserted by (experiment, worker) on every worker flush round.
    ("metrics", ["experiment"], False),
    ("spans", ["experiment"], False),
    # Optimization-health channel: one record per producer round, appended
    # and pruned by (experiment, time) like the spans above.
    ("health", ["experiment"], False),
]


#: Telemetry label per backend class; unknown (third-party) backends fall
#: back to their lowercased class name.
_BACKEND_LABELS = {
    "MemoryDB": "memory",
    "PickledDB": "pickled",
    "SQLiteDB": "sqlite",
    "NetworkDB": "network",
    "ShardedNetworkDB": "shard",
}

#: Backend-maintained monotonic counters re-exported through the telemetry
#: registry (sampled at snapshot time — zero hot-path cost).  The sharded
#: router adds its read-path health counters (failovers to a primary,
#: stale replica reads, cross-shard fan-outs); other backends simply lack
#: the attributes and skip them.
_BACKEND_COUNTER_ATTRS = (
    "txn_count",
    "wire_requests",
    "round_trips",
    "reconnects",
    "failovers",
    "replica_stale_reads",
    "fan_outs",
)


def _traced(op, span_name=None, retry=MODE_ALWAYS):
    """Time a DocumentStorage protocol op into the telemetry registry: a
    ``storage.{op}`` span (overridable — ``register_trials`` reports as
    ``storage.commit``, the produce round's write) plus a per-backend
    per-op latency histogram ``storage.{backend}.{op}``.  Disabled
    telemetry costs one attribute check.

    ``retry`` applies the storage instance's unified
    :class:`~orion_tpu_torch.storage.retry.RetryPolicy` around the op (the mode
    says whether the op converges under re-application; None opts out).
    Retries happen INSIDE the span/histogram window, so the recorded op
    latency is what the caller actually waited — the separate
    ``storage.retries`` counter says how much of it was retry."""

    def decorate(fn):
        name = span_name or f"storage.{op}"

        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            policy = self._retry
            if policy is not None and retry is not None:
                def run():
                    return policy.run(
                        lambda: fn(self, *args, **kwargs), op=op, mode=retry
                    )
            else:
                def run():
                    return fn(self, *args, **kwargs)
            if not TELEMETRY.enabled:
                return run()
            t0 = time.perf_counter()
            # Run the op AS a child trace context: wire clients underneath
            # (NetworkDB) inject the ambient context into their request
            # envelopes, so the server's apply span parents at THIS op span
            # (storage.commit -> netdb.apply in the distributed merge).
            parent = current_trace_context()
            ctx = parent.child() if parent is not None and parent.sampled else None
            if ctx is not None:
                set_trace_context(ctx)
            try:
                return run()
            finally:
                if ctx is not None:
                    set_trace_context(parent)
                duration = time.perf_counter() - t0
                backend = self._backend_label
                # histogram=False: the sample's ONE histogram home is the
                # per-backend key below — same-name span histograms would
                # double every snapshot's payload and duplicate info rows.
                TELEMETRY.record_span(
                    name,
                    start=t0,
                    args={"backend": backend},
                    histogram=False,
                    span_ctx=ctx,
                    parent_ctx=parent if ctx is not None else None,
                )
                TELEMETRY.observe(f"storage.{backend}.{op}", duration)

        return wrapper

    return decorate


def _retrying(op, mode=MODE_ALWAYS):
    """Retry-only wrapper (no span) for the protocol ops outside the traced
    set — reads and auxiliary writes share the same policy and transient
    classification as the hot-path ops, they just don't each earn a
    telemetry stream."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            policy = self._retry
            if policy is None:
                return fn(self, *args, **kwargs)
            return policy.run(lambda: fn(self, *args, **kwargs), op=op, mode=mode)

        return wrapper

    return decorate


class DocumentStorage(BaseStorage):
    """Protocol over any AbstractDB-style document backend."""

    def __init__(self, db, retry=None):
        self._db = db
        # Unified retry policy (storage/retry.py): default ON with modest
        # settings — every protocol op below shares one backoff/deadline/
        # classification contract across the backends.  ``retry``
        # accepts a RetryPolicy, a ``storage.retry`` config dict, or
        # False to disable (raw pre-policy behavior).
        self._retry = create_retry_policy(retry)
        self._backend_label = _BACKEND_LABELS.get(
            type(db).__name__, type(db).__name__.lower()
        )
        for attr in _BACKEND_COUNTER_ATTRS:
            if isinstance(getattr(db, attr, None), int):
                TELEMETRY.register_external_counter(
                    f"storage.{self._backend_label}.{attr}", db, attr
                )
        self._setup_indexes()

    @property
    def db(self):
        return self._db

    def _setup_indexes(self):
        # Reference `legacy.py:70-88`; batched into one backend write cycle.
        try:
            # Schema migration: the pre-user index would keep enforcing
            # name+version uniqueness across users on older databases.
            self._db.drop_index("experiments", "name_version_1")
        except (KeyError, DatabaseError):
            pass
        self._db.ensure_indexes(INDEX_SPECS)

    # --- experiments --------------------------------------------------------
    @_retrying("create_experiment", mode=MODE_ALWAYS)
    def create_experiment(self, config):
        """Insert a new experiment config; DuplicateKeyError if (name, version)
        already exists — callers translate that into a RaceCondition retry.
        Retry-converging: a re-send of an applied-but-unacknowledged create
        surfaces as that same DuplicateKeyError, which build_experiment already
        treats as a lost creation race and resolves by reloading."""
        config = dict(config)
        config.setdefault("version", 1)
        _id = self._db.write("experiments", config)
        config["_id"] = _id
        return config

    @_retrying("update_experiment", mode=MODE_ALWAYS)
    def update_experiment(self, experiment=None, uid=None, where=None, **kwargs):
        query = dict(where or {})
        if uid is not None:
            query["_id"] = uid
        elif experiment is not None:
            query["_id"] = experiment["_id"]
        if not query:
            # Reference raises MissingArguments here (`legacy.py:94-109`);
            # never allow an accidental collection-wide update.
            raise DatabaseError(
                "update_experiment requires an experiment, uid, or where query"
            )
        return self._db.write("experiments", kwargs, query=query)

    @_retrying("fetch_experiments", mode=MODE_ALWAYS)
    def fetch_experiments(self, query, projection=None):
        return self._db.read("experiments", query, projection)

    # --- trials -------------------------------------------------------------
    @_traced("register_trial", retry=MODE_ALWAYS)
    def register_trial(self, trial):
        """Insert a new trial; DuplicateKeyError on a duplicate point id."""
        trial.submit_time = trial.submit_time or time.time()
        self._db.write("trials", trial.to_dict())
        return trial

    @_retrying("register_lie", mode=MODE_ALWAYS)
    def register_lie(self, trial):
        trial.submit_time = trial.submit_time or time.time()
        self._db.write("lying_trials", trial.to_dict())
        return trial

    @_retrying("register_lies", mode=MODE_ALWAYS)
    def register_lies(self, trials):
        """Batch twin of :meth:`register_lie`, ONE backend round (one
        lock/load/dump cycle on the pickled file).  The reference writes
        each lie on its own; the producer lies about every trial in flight
        every round, so with another worker's q=1024 batch in flight that
        rewrote the whole pickled file 1024 times a round.  Retry-converging:
        a re-sent slot comes back as DuplicateKeyError."""
        now = time.time()
        for trial in trials:
            trial.submit_time = trial.submit_time or now
        if not self._db_batch_capable():
            return super().register_lies(trials)
        results = self._db_batch(
            [("write", ["lying_trials", trial.to_dict()], {}) for trial in trials]
        )
        return [
            result if isinstance(result, Exception) else trial
            for trial, result in zip(trials, results)
        ]

    @_retrying("fetch_lies", mode=MODE_ALWAYS)
    def fetch_lies(self, experiment):
        docs = self._db.read("lying_trials", {"experiment": _exp_id(experiment)})
        return [Trial.from_dict(d) for d in docs]

    def _reservation_ops(self, experiment):
        """The one reservation query/update pair — single-claim and batch
        paths MUST write identical documents, so both build from here.

        The claim stamps ``worker`` (host:pid) — the reference declares the
        field on Trial (`trial.py:45-46`) but never fills it; stamping at
        the reservation CAS makes `status --all`/post-mortems attribute
        every trial to the process that ran it."""
        now = time.time()
        query = {
            "experiment": _exp_id(experiment),
            "status": {"$in": list(RESERVABLE_STATUSES)},
        }
        update = {
            "status": "reserved",
            "start_time": now,
            "heartbeat": now,
            "worker": _worker_id(),
        }
        return query, update

    @_traced("reserve_trial", retry=MODE_ALWAYS)
    def reserve_trial(self, experiment):
        """Atomically claim one pending trial (the cross-worker sync point;
        reference `legacy.py:253-273`)."""
        query, update = self._reservation_ops(experiment)
        doc = self._db.read_and_write("trials", query, update)
        return Trial.from_dict(doc) if doc else None

    def _db_batch_capable(self):
        """True when the backend offers a batching primitive — THE
        capability predicate every batch op keys on (so a third primitive
        added to :meth:`_db_batch` is recognized everywhere at once)."""
        return (
            getattr(self._db, "apply_batch", None) is not None
            or getattr(self._db, "pipeline", None) is not None
        )

    def _db_batch(self, ops):
        """One backend round for ``[(op, args, kwargs), ...]`` through the
        cheapest primitive the backend offers: ``apply_batch`` (one
        transaction / one wire request), else ``pipeline`` (N request
        lines in ~1 RTT, network client).  Callers check
        :meth:`_db_batch_capable` first and loop per-op otherwise.  Either
        primitive returns one outcome per op, exception instances
        included."""
        apply_batch = getattr(self._db, "apply_batch", None)
        if apply_batch is not None:
            return apply_batch(ops)
        return self._db.pipeline(ops)

    @_traced("reserve_trials", retry=MODE_ALWAYS)
    def reserve_trials(self, experiment, num):
        """Claim up to ``num`` pending trials; each claim is individually
        atomic (repeated find-one-and-updates — every op sees the previous
        op's status flip, even inside one transaction, so the claims are
        distinct).  The batch rides one backend round (one transaction on
        SQL, one wire request on the network backend); q=4096 reservation
        over TCP would otherwise pay 4096 serialized RTTs."""
        if num <= 0:
            return []
        if not self._db_batch_capable():
            return super().reserve_trials(experiment, num)
        query, update = self._reservation_ops(experiment)
        # Probe with ONE claim first: callers reserve-then-produce, so the
        # common steady state is an EMPTY queue — batching num futile
        # find-one-and-updates there would double the server's reservation
        # work every round.  Non-empty pays one extra round trip.
        first = self._db.read_and_write("trials", query, update)
        if first is None:
            return []
        if num == 1:
            return [Trial.from_dict(first)]
        remaining = num - 1
        if getattr(self._db, "cheap_counts", False):
            # Cap the claim batch at what is actually pending: num-1
            # find-one-and-updates against a shallow queue are mostly
            # futile full scans — inside ONE transaction on SQL backends,
            # i.e. O(num x collection) work under the exclusive write
            # lock.  The count is advisory (concurrent producers may add
            # or steal trials before the claims run); correctness still
            # comes from each claim's own CAS.
            remaining = min(remaining, self._db.count("trials", query))
        if remaining <= 0:
            return [Trial.from_dict(first)]
        docs = [first] + self._db_batch(
            [("read_and_write", ["trials", query, update], {})] * remaining
        )
        out, error = [], None
        for doc in docs:
            if isinstance(doc, Exception):
                error = error or doc
            elif doc is not None:
                out.append(Trial.from_dict(doc))
        if error is not None and not out:
            # Nothing claimed + server-side failure: surface it exactly as
            # the per-op path would — treating it as "no trials pending"
            # masks the fault and sends the caller off to produce duplicates.
            raise error
        # With claims in hand, RETURN them even if a later slot errored:
        # raising would strand already-reserved trials (no owner, no
        # heartbeat) until the lost-trial sweep.  A persistent fault will
        # surface on the next (empty-handed) round.
        return out

    @_traced("register_trials", span_name="storage.commit", retry=MODE_ALWAYS)
    def register_trials(self, trials):
        """Batch-register; returns one outcome per trial: the trial itself on
        success or the per-trial exception (DuplicateKeyError for an
        already-taken point — slot independence matters: one duplicate must
        not block the rest of a q-batch).  The whole batch is ONE backend
        round: a single ``executemany`` transaction on SQL (one fsync per
        q-batch instead of q), one wire request on the network backend, one
        lock/load/dump cycle on the pickled file."""
        now = time.time()
        # lint: disable=PERF001 -- Trial-object compat path (plugins and
        # direct callers hand real Trials); the producer's columnar round
        # rides register_trial_docs below instead.
        for trial in trials:
            trial.submit_time = trial.submit_time or now
        if not self._db_batch_capable():
            return super().register_trials(trials)
        results = self._db_batch(
            # lint: disable=PERF001 -- per-trial to_dict IS this compat
            # path's contract; the columnar twin builds docs in one pass.
            [("write", ["trials", trial.to_dict()], {}) for trial in trials]
        )
        # lint: disable=PERF001 -- O(1) zip per slot pairing outcomes back
        # to their trials.
        return [
            result if isinstance(result, Exception) else trial
            for trial, result in zip(trials, results)
        ]

    @_traced("register_trials", span_name="storage.commit", retry=MODE_ALWAYS)
    def register_trial_docs(self, docs):
        """Columnar twin of :meth:`register_trials`: RAW trial documents
        (one columnar ``TrialBatch.to_docs`` pass upstream — no ``Trial``
        objects, no per-trial ``to_dict``) committed as ONE backend round.
        One outcome per doc: an exception instance for a failed slot
        (``DuplicateKeyError`` for an already-taken point), any other value
        means the slot registered.  Same wire/transaction shape as
        ``register_trials`` — one ``write`` sub-op per doc through the
        batch primitive — so crash-consistency and convergence contracts
        (docs/robustness.md) are unchanged; shares its telemetry op name
        (``storage.commit`` span) for dashboard continuity."""
        if not self._db_batch_capable():
            out = []
            # lint: disable=PERF001 -- loop fallback for backends without
            # a batch primitive; the hot path is the _db_batch leg below.
            for doc in docs:
                try:
                    out.append(self._db.write("trials", doc))
                except Exception as exc:
                    out.append(exc)
            return out
        # lint: disable=PERF001 -- one wire/transaction sub-op per doc IS
        # the batch primitive's slot shape (per-slot outcomes require it).
        return self._db_batch([("write", ["trials", doc], {}) for doc in docs])

    @_traced("update_completed_trials", retry=MODE_ALWAYS)
    def update_completed_trials(self, pairs):
        """Batch-complete ``[(trial, results), ...]`` — one backend round
        (one transaction on SQL, one wire request on the network backend);
        per-trial FailedUpdate surfaces in the returned outcome list
        instead of aborting the batch."""
        if not self._db_batch_capable():
            return super().update_completed_trials(pairs)
        outcomes = []
        now = time.time()
        ops = []
        for trial, results in pairs:
            trial.results = list(results)
            trial.end_time = now
            ops.append(
                (
                    "read_and_write",
                    [
                        "trials",
                        {"_id": trial.id},
                        {
                            "results": [r.to_dict() for r in trial.results],
                            "end_time": trial.end_time,
                            "status": "completed",
                        },
                    ],
                    {},
                )
            )
        docs = self._db_batch(ops)
        for (trial, _results), doc in zip(pairs, docs):
            if isinstance(doc, Exception):
                outcomes.append(doc)
            elif doc is None:
                outcomes.append(
                    FailedUpdate(f"completed trial {trial.id} vanished from storage")
                )
            else:
                trial.status = "completed"
                outcomes.append(trial)
        return outcomes

    @_traced("fetch_trials", retry=MODE_ALWAYS)
    def fetch_trials(self, experiment=None, uid=None):
        query = {"experiment": uid if uid is not None else _exp_id(experiment)}
        docs = self._db.read("trials", query)
        docs.sort(key=_trial_doc_order)
        return [Trial.from_dict(d) for d in docs]

    @_retrying("read_trial_docs", mode=MODE_ALWAYS)
    def read_trial_docs(self, uid, ids=None, projection=None):
        """Raw trial documents for an experiment, optionally id-filtered and
        projected.  The supported read path for consumers that need
        signature-level reads without Trial construction — the EVC tree
        fetch's incremental cache (`evc/experiment.py`) — and therefore a
        whitelisted READ-ONLY operation; reaching for ``storage.db`` instead
        breaks on `ExperimentView`'s read-only proxy."""
        query = {"experiment": uid}
        if ids is not None:
            query["_id"] = {"$in": list(ids)}
        return self._db.read("trials", query, projection=projection)

    @_traced("fetch_update_view", retry=MODE_ALWAYS)
    def fetch_update_view(self, experiment, known_completed=-1):
        """The producer's per-round sync snapshot: ``(trials, n_completed)``.

        When the backend advertises ``cheap_counts``, the completed history
        is count-gated — re-read only when the completed count moved past
        ``known_completed`` (completed is terminal, so the count can only
        grow); otherwise the round reads just the (small) non-completed
        set.  On a pipeline-capable backend the non-completed read and the
        count share ONE round trip.  Backends without cheap ops (the
        pickled file pays a full lock/unpickle cycle per op) keep the
        single full fetch.

        The two reads are not one atomic snapshot: a trial completing
        between them appears in both (its completed view wins below) or
        flips the count so the gate re-opens — it can never vanish from
        the round.  Trials are returned in the same (submit_time, id)
        order ``fetch_trials`` delivers, which is what keeps replay
        deterministic.
        """
        if not getattr(self._db, "cheap_counts", False):
            trials = self.fetch_trials(experiment)
            return trials, -1
        exp_id = _exp_id(experiment)
        noncompleted_query = {"experiment": exp_id, "status": {"$ne": "completed"}}
        completed_query = {"experiment": exp_id, "status": "completed"}
        if self._db_batch_capable():
            nc_docs, n_completed = self._db_batch(
                [
                    ("read", ["trials", noncompleted_query], {}),
                    ("count", ["trials", completed_query], {}),
                ]
            )
            for result in (nc_docs, n_completed):
                if isinstance(result, Exception):
                    raise result
        else:
            nc_docs = self._db.read("trials", noncompleted_query)
            n_completed = self._db.count("trials", completed_query)
        if n_completed != known_completed:
            done_docs = self._db.read("trials", completed_query)
        else:
            done_docs = []
        by_id = {d["_id"]: d for d in nc_docs}
        by_id.update((d["_id"], d) for d in done_docs)  # completed view wins
        docs = sorted(by_id.values(), key=_trial_doc_order)
        return [Trial.from_dict(d) for d in docs], n_completed

    @_retrying("fetch_trials_by_status", mode=MODE_ALWAYS)
    def fetch_trials_by_status(self, experiment, status):
        statuses = [status] if isinstance(status, str) else list(status)
        docs = self._db.read(
            "trials",
            {"experiment": _exp_id(experiment), "status": {"$in": statuses}},
        )
        return [Trial.from_dict(d) for d in docs]

    @_retrying("get_trial", mode=MODE_ALWAYS)
    def get_trial(self, trial=None, uid=None):
        _id = uid if uid is not None else trial.id
        docs = self._db.read("trials", {"_id": _id})
        return Trial.from_dict(docs[0]) if docs else None

    @_traced("set_trial_status", retry=MODE_UNAPPLIED)
    def set_trial_status(self, trial, status, was=None):
        """Compare-and-swap status update (reference `legacy.py:223-243`).

        Always guarded: the swap only succeeds if the stored status equals
        ``was`` (defaulting to the caller's in-memory view, so a concurrent
        transition by another worker raises FailedUpdate instead of being
        silently overwritten).

        The CAS does NOT converge under blind re-application (a retried
        swap that already applied reports a spurious FailedUpdate), so the
        retry mode is ``unapplied`` and ambiguous losses verify-then-
        converge here: a re-read showing the target status means the lost
        attempt applied (success); one showing the guard status means it
        did not (the ambiguity is cleared and the policy may retry);
        anything else re-raises the ambiguity.
        """
        guard = was if was is not None else trial.status
        query = {"_id": trial.id, "status": guard}
        update = {"status": status}
        if status in ("completed", "interrupted", "broken"):
            update["end_time"] = time.time()
        try:
            doc = self._db.read_and_write("trials", query, update)
        except DatabaseError as exc:
            if not getattr(exc, "maybe_applied", False):
                raise
            try:
                current = self._db.read("trials", {"_id": trial.id})
            except Exception:
                # The verify read failed too, so the ambiguity STANDS —
                # re-raise the original ambiguous error.  Letting the
                # read's own (possibly non-ambiguous) failure propagate
                # would hand the retry policy a transient it happily
                # re-runs, blind-re-executing the non-converging CAS.
                raise exc from None
            stored = current[0].get("status") if current else None
            if stored == status:
                trial.status = status
                return Trial.from_dict(current[0])
            if stored == guard:
                exc.maybe_applied = False  # provably not applied: retriable
            raise
        if doc is None:
            raise FailedUpdate(
                f"trial {trial.id} not updated to {status!r} (was={was!r})"
            )
        trial.status = status
        # Status transitions are flight-recorder events: the crash
        # post-mortem wants the recent lifecycle edges on its timeline.
        # Guarded — the args dict must not allocate when the recorder is off
        # (this is a per-trial path).
        if FLIGHT.enabled:
            FLIGHT.record(
                "trial.status",
                args={"trial": trial.id, "from": guard, "to": status},
            )
        return Trial.from_dict(doc)

    @_traced("update_heartbeat", retry=MODE_ALWAYS)
    def update_heartbeat(self, trial):
        doc = self._db.read_and_write(
            "trials",
            {"_id": trial.id, "status": "reserved"},
            {"heartbeat": time.time()},
        )
        if doc is None:
            raise FailedUpdate(f"trial {trial.id} is no longer reserved")

    @_retrying("fetch_lost_trials", mode=MODE_ALWAYS)
    def fetch_lost_trials(self, experiment, timeout):
        """Reserved trials whose worker stopped heartbeating (crashed/killed)."""
        threshold = time.time() - timeout
        docs = self._db.read(
            "trials",
            {
                "experiment": _exp_id(experiment),
                "status": "reserved",
                "heartbeat": {"$lt": threshold},
            },
        )
        return [Trial.from_dict(d) for d in docs]

    @_retrying("push_trial_results", mode=MODE_ALWAYS)
    def push_trial_results(self, trial):
        doc = self._db.read_and_write(
            "trials",
            {"_id": trial.id, "status": "reserved"},
            {"results": [r.to_dict() for r in trial.results]},
        )
        if doc is None:
            raise FailedUpdate(f"cannot push results of non-reserved trial {trial.id}")
        return Trial.from_dict(doc)

    @_traced("update_completed_trial", retry=MODE_ALWAYS)
    def update_completed_trial(self, trial, results):
        trial.results = list(results)
        trial.end_time = time.time()
        doc = self._db.read_and_write(
            "trials",
            {"_id": trial.id},
            {
                "results": [r.to_dict() for r in trial.results],
                "end_time": trial.end_time,
                "status": "completed",
            },
        )
        if doc is None:
            raise FailedUpdate(f"completed trial {trial.id} vanished from storage")
        trial.status = "completed"
        return trial

    @_retrying("count_completed_trials", mode=MODE_ALWAYS)
    def count_completed_trials(self, experiment):
        return self._db.count(
            "trials", {"experiment": _exp_id(experiment), "status": "completed"}
        )

    @_retrying("count_broken_trials", mode=MODE_ALWAYS)
    def count_broken_trials(self, experiment):
        return self._db.count(
            "trials", {"experiment": _exp_id(experiment), "status": "broken"}
        )

    # --- timing samples (suggest/register/observe, from the producer) -------
    #: Oldest samples are pruned past this per-experiment count so the
    #: telemetry collection cannot grow without bound on long hunts.
    TELEMETRY_CAP = 5000

    def record_timing(self, experiment, op, duration, count=1):
        """One timing sample: op in {'suggest', 'observe'}."""
        self.record_timings(experiment, [(op, duration, count)])

    def record_timings(self, experiment, samples):
        """Batched samples [(op, duration, count), ...] in ONE backend write
        (a write per sample would cost a full lock/rewrite cycle each on the
        file backend — on the producer's hot path)."""
        if not samples:
            return
        self._append_timings(experiment, samples)
        self._prune_timings(experiment)

    # Append leg: a lost-reply re-send would duplicate samples, so the
    # ambiguous case gives up (mode="unapplied") — losing one flush beats
    # double-counting it, and the next round flushes fresh data anyway.
    # The prune leg retries separately so ITS transient failure can never
    # re-run an append that already landed.
    @_retrying("record_timings", mode=MODE_UNAPPLIED)
    def _append_timings(self, experiment, samples):
        now = time.time()
        exp_id = _exp_id(experiment)
        self._db.write(
            "telemetry",
            [
                {
                    "experiment": exp_id,
                    "op": op,
                    "duration": float(duration),
                    "count": int(count),
                    "time": now,
                }
                for op, duration, count in samples
            ],
        )

    # Count/read/remove-below-cutoff all converge under re-application.
    # Raw _db reads, not fetch_timings: the fetchers carry
    # their own @_retrying, and nesting two policies would compound to
    # max_attempts**2 backend attempts during a sustained outage.
    @_retrying("record_timings.prune", mode=MODE_ALWAYS)
    def _prune_timings(self, experiment):
        exp_id = _exp_id(experiment)
        n = self._db.count("telemetry", {"experiment": exp_id})
        if n > self.TELEMETRY_CAP:
            docs = self._db.read("telemetry", {"experiment": exp_id})
            # Index off the re-read list, not the earlier count: another
            # worker's prune can land between count() and read().
            if len(docs) <= self.TELEMETRY_CAP:
                return
            docs.sort(key=lambda d: d.get("time") or 0.0)
            cutoff = docs[len(docs) - self.TELEMETRY_CAP].get("time") or 0.0
            self._db.remove(
                "telemetry",
                {"experiment": exp_id, "time": {"$lt": cutoff}},
            )

    @_retrying("fetch_timings", mode=MODE_ALWAYS)
    def fetch_timings(self, experiment, op=None):
        query = {"experiment": _exp_id(experiment)}
        if op is not None:
            query["op"] = op
        docs = self._db.read("telemetry", query)
        docs.sort(key=lambda d: d.get("time") or 0.0)
        return docs

    # --- unified telemetry channel (orion_tpu_torch.telemetry snapshots/spans)
    #: Span documents are pruned past this per-experiment count (same
    #: unbounded-growth guard as TELEMETRY_CAP for timing samples).
    SPANS_CAP = 20000

    # Upsert keyed by (experiment, worker): re-applying after an ambiguous
    # loss converges on the same latest-snapshot doc, so retry always.
    @_retrying("record_metrics", mode=MODE_ALWAYS)
    def record_metrics(self, experiment, snapshot, worker=None):
        """Upsert one worker's metrics snapshot (``Telemetry.snapshot()``)
        keyed by (experiment, worker) — counters/histograms are per-worker
        monotonic totals, so the latest doc supersedes earlier ones and
        ``fetch_metrics`` + ``telemetry.merge_snapshots`` aggregate across
        the fleet.  ``worker`` defaults to this process's host:pid."""
        exp_id = _exp_id(experiment)
        worker = worker or _worker_id()
        doc = {
            "experiment": exp_id,
            "worker": worker,
            "time": time.time(),
            "counters": dict(snapshot.get("counters") or {}),
            "gauges": dict(snapshot.get("gauges") or {}),
            "histograms": dict(snapshot.get("histograms") or {}),
        }
        updated = self._db.write(
            "metrics", doc, query={"experiment": exp_id, "worker": worker}
        )
        if not updated:
            self._db.write("metrics", doc)

    @_retrying("fetch_metrics", mode=MODE_ALWAYS)
    def fetch_metrics(self, experiment):
        docs = self._db.read("metrics", {"experiment": _exp_id(experiment)})
        docs.sort(key=lambda d: d.get("time") or 0.0)
        return docs

    def record_spans(self, experiment, spans):
        """Append drained span records (``Telemetry.drain_spans()``) in ONE
        backend write; prunes the oldest past :attr:`SPANS_CAP`."""
        if not spans:
            return
        self._append_spans(experiment, spans)
        self._prune_spans(experiment)

    # Append leg, same contract as record_timings: ambiguous losses give up
    # instead of risking duplicated span records, and the prune retries
    # separately so it cannot re-run a landed append.
    @_retrying("record_spans", mode=MODE_UNAPPLIED)
    def _append_spans(self, experiment, spans):
        exp_id = _exp_id(experiment)
        worker = _worker_id()
        self._db.write(
            "spans",
            [{"experiment": exp_id, "worker": worker, **span} for span in spans],
        )

    @_retrying("record_spans.prune", mode=MODE_ALWAYS)
    def _prune_spans(self, experiment):
        exp_id = _exp_id(experiment)
        n = self._db.count("spans", {"experiment": exp_id})
        if n > self.SPANS_CAP:
            # Prune with hysteresis — down to 90% of the cap, not exactly
            # to it: a prune-to-cap would leave the collection full, so
            # EVERY later flush re-pays the full fetch+sort+remove on the
            # producer's hot path; the 10% slack amortizes it to one prune
            # per ~2k spans.
            keep = max(1, int(self.SPANS_CAP * 0.9))
            docs = self._db.read("spans", {"experiment": exp_id})
            # Index off the re-read list, not the earlier count: another
            # worker's prune can land between count() and read().
            if len(docs) <= keep:
                return
            docs.sort(key=lambda d: d.get("ts") or 0.0)
            cutoff = docs[len(docs) - keep].get("ts") or 0.0
            self._db.remove(
                "spans", {"experiment": exp_id, "ts": {"$lt": cutoff}}
            )

    @_retrying("fetch_spans", mode=MODE_ALWAYS)
    def fetch_spans(self, experiment):
        docs = self._db.read("spans", {"experiment": _exp_id(experiment)})
        docs.sort(key=lambda d: d.get("ts") or 0.0)
        return docs

    # --- optimization-health channel --------------------------------------
    #: Health records are pruned past this per-experiment count — one
    #: record per producer round, so the cap holds the recent few thousand
    #: rounds of every worker (same unbounded-growth guard as SPANS_CAP).
    HEALTH_CAP = 4096

    def record_health(self, experiment, record, worker=None):
        """Append one per-round health record (``BaseAlgorithm
        .health_record()`` merged by the producer) in ONE backend write;
        prunes the oldest past :attr:`HEALTH_CAP`."""
        if not record:
            return
        self._append_health(experiment, record, worker)
        self._prune_health(experiment)

    # Append leg, same contract as record_spans: an ambiguous-loss resend
    # would duplicate the round's record (skewing round-rate and regret
    # curves), so give up on maybe_applied — the next round flushes fresh
    # data anyway.  The prune leg retries separately so its transient
    # failure can never re-run a landed append.
    @_retrying("record_health", mode=MODE_UNAPPLIED)
    def _append_health(self, experiment, record, worker=None):
        doc = dict(record)
        doc["experiment"] = _exp_id(experiment)
        doc["worker"] = worker or _worker_id()
        if doc.get("time") is None:
            doc["time"] = time.time()
        self._db.write("health", doc)

    @_retrying("record_health.prune", mode=MODE_ALWAYS)
    def _prune_health(self, experiment):
        exp_id = _exp_id(experiment)
        n = self._db.count("health", {"experiment": exp_id})
        if n > self.HEALTH_CAP:
            # Hysteresis to 90% of the cap, same rationale as _prune_spans:
            # a prune-to-cap would re-pay the fetch+sort+remove on every
            # later flush of a full collection.
            keep = max(1, int(self.HEALTH_CAP * 0.9))
            docs = self._db.read("health", {"experiment": exp_id})
            # Index off the re-read list, not the earlier count: another
            # worker's prune can land between count() and read().
            if len(docs) <= keep:
                return
            docs.sort(key=lambda d: d.get("time") or 0.0)
            cutoff = docs[len(docs) - keep].get("time") or 0.0
            self._db.remove(
                "health", {"experiment": exp_id, "time": {"$lt": cutoff}}
            )

    @_retrying("fetch_health", mode=MODE_ALWAYS)
    def fetch_health(self, experiment):
        docs = self._db.read("health", {"experiment": _exp_id(experiment)})
        docs.sort(key=lambda d: d.get("time") or 0.0)
        return docs

    @_retrying("fetch_noncompleted_trials", mode=MODE_ALWAYS)
    def fetch_noncompleted_trials(self, experiment):
        docs = self._db.read(
            "trials",
            {"experiment": _exp_id(experiment), "status": {"$ne": "completed"}},
        )
        return [Trial.from_dict(d) for d in docs]


def _trial_doc_order(doc):
    """THE trial ordering: every path that hands trials to an algorithm
    must sort with this one key, or observe order (and with it replay
    determinism) diverges between paths."""
    return (doc.get("submit_time") or 0.0, str(doc.get("_id")))


def _worker_id():
    """host:pid identity of this worker process (computed per call: a
    forked/spawned child must not inherit the parent's pid stamp)."""
    import os
    import socket

    return f"{socket.gethostname()}:{os.getpid()}"


def _exp_id(experiment):
    if isinstance(experiment, dict):
        return experiment["_id"]
    if hasattr(experiment, "id"):
        return experiment.id
    return experiment


_READONLY_METHODS = {
    "fetch_experiments",
    "fetch_trials",
    "fetch_trials_by_status",
    "fetch_lies",
    "fetch_lost_trials",
    "fetch_noncompleted_trials",
    "get_trial",
    "read_trial_docs",
    "count_completed_trials",
    "count_broken_trials",
    "fetch_timings",
    "fetch_metrics",
    "fetch_spans",
    "fetch_health",
}


class ReadOnlyStorage:
    """Whitelist proxy (reference `storage/base.py:251-281`)."""

    def __init__(self, storage):
        self._storage = storage

    def __getattr__(self, name):
        if name not in _READONLY_METHODS:
            raise AttributeError(f"{name!r} is not a read-only storage operation")
        return getattr(self._storage, name)


def _parse_network_address(config):
    """(host, port) from a network-storage config; ``address``/``path`` may
    carry ``host[:port]`` (the ORION_DB_ADDRESS env form)."""
    host = config.get("host", "127.0.0.1")
    port = config.get("port", 8765)
    address = config.get("address")
    if not address and "host" not in config and "port" not in config:
        # `path` doubles as ORION_DB_ADDRESS, but only when host/port are not
        # given: the layered config merge leaks the DEFAULTS pickled path into
        # a network storage section, and it must not hijack the address.
        address = config.get("path")
    if address:
        address = str(address)
        if ":" in address:
            host, _, port = address.rpartition(":")
            if not host or not port:
                raise DatabaseError(
                    f"bad network DB address {address!r}; expected host:port"
                )
        else:
            host = address
    return host, int(port)


def resolve_wire_secret(config, env_prefix="ORION_DB", what="network DB"):
    """Shared secret for an authenticated wire surface: explicit config
    value, a secret file (config or ``{env_prefix}_SECRET_FILE``), or
    ``{env_prefix}_SECRET``.  None = unauthenticated client (open/
    localhost servers).  Shared by the netdb client (``ORION_DB``) and
    the suggest gateway client (``ORION_SERVE``) so the two wire planes
    resolve credentials identically."""
    import os

    if config.get("secret") is not None:
        return str(config["secret"])
    path = config.get("secret_file") or os.getenv(f"{env_prefix}_SECRET_FILE")
    if path:
        try:
            with open(path) as handle:
                secret = handle.read().strip()
        except OSError as exc:
            raise DatabaseError(
                f"cannot read {what} secret file {path!r}: {exc} "
                "(is the shared mount available on this node?)"
            ) from exc
        if not secret:
            raise DatabaseError(f"{what} secret file {path!r} is empty")
        return secret
    return os.getenv(f"{env_prefix}_SECRET") or None


def _resolve_network_secret(config):
    return resolve_wire_secret(config, env_prefix="ORION_DB", what="network DB")


def create_storage(config=None):
    """Build a storage instance from a config dict.

    ``{"type": "memory"}``, ``{"type": "pickled", "path": ...}``,
    ``{"type": "sqlite", "path": ...}`` or ``{"type": "network", "host":
    ..., "port": ...}`` (``address: host:port``; a ``shards:`` stanza routes
    through :class:`~orion_tpu_torch.storage.shard.ShardedNetworkDB`).
    A ``retry`` sub-dict tunes the unified retry policy knobs
    (``max_attempts``/``base_delay``/``max_delay``/``multiplier``/
    ``jitter``/``deadline`` — docs/robustness.md); ``retry: false``
    disables retries entirely.
    """
    config = dict(config or {})
    retry = config.get("retry")
    db_type = config.get("type", "pickled")
    if db_type in ("memory", "ephemeral", "ephemeraldb"):
        return DocumentStorage(MemoryDB(), retry=retry)
    if db_type in ("pickled", "pickleddb"):
        path = config.get("path", "orion_tpu_db.pkl")
        return DocumentStorage(
            PickledDB(path, lock_timeout=config.get("lock_timeout", 60.0)),
            retry=retry,
        )
    if db_type in ("sqlite", "sqlite3"):
        from orion_tpu_torch.storage.sqlitedb import SQLiteDB

        path = config.get("path", "orion_tpu_db.sqlite")
        return DocumentStorage(
            SQLiteDB(path, timeout=config.get("lock_timeout", 60.0)),
            retry=retry,
        )
    if db_type in ("network", "netdb"):
        from orion_tpu_torch.storage.netdb import NetworkDB

        secret = _resolve_network_secret(config)
        if config.get("shards"):
            # Scale-out control plane: a `shards:` stanza routes this
            # storage through the consistent-hash router (per-shard
            # replicas ride inside each entry; docs/multi_node.md).
            from orion_tpu_torch.storage.shard import (
                DEFAULT_PROMOTE_AFTER_S,
                PLACEMENT_TTL_S,
                ShardedNetworkDB,
            )

            return DocumentStorage(
                ShardedNetworkDB(
                    config["shards"],
                    vnodes=config.get("vnodes", 64),
                    timeout=config.get("timeout", 60.0),
                    secret=secret,
                    reconnect_jitter=config.get("reconnect_jitter", 0.1),
                    shard_retry=config.get("shard_retry"),
                    replica_reads=config.get("replica_reads", True),
                    # Self-healing knobs (docs/multi_node.md): automatic
                    # replica promotion + its confirmation window, and the
                    # placement-override cache TTL the rebalance fence
                    # grace must cover.
                    auto_promote=config.get("auto_promote", True),
                    promote_after=config.get(
                        "promote_after", DEFAULT_PROMOTE_AFTER_S
                    ),
                    placement_ttl=config.get("placement_ttl", PLACEMENT_TTL_S),
                ),
                retry=retry,
            )
        host, port = _parse_network_address(config)
        return DocumentStorage(
            NetworkDB(
                host=host,
                port=port,
                timeout=config.get("timeout", 60.0),
                secret=secret,
                reconnect_jitter=config.get("reconnect_jitter", 0.1),
            ),
            retry=retry,
        )
    raise DatabaseError(f"Unknown storage type {db_type!r}")


_storage_singleton = None


def setup_storage(config=None, force=False):
    """Initialize the process-wide storage singleton."""
    global _storage_singleton
    if _storage_singleton is None or force:
        _storage_singleton = create_storage(config)
    return _storage_singleton


def get_storage():
    if _storage_singleton is None:
        raise DatabaseError("storage singleton not initialized; call setup_storage()")
    return _storage_singleton
