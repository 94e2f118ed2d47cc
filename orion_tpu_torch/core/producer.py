"""Producer: turn algorithm suggestions into registered trials (port of
``orion_tpu/core/producer.py``).

Capability parity: reference `src/orion/core/worker/producer.py` — observe
completed trials in the real algorithm + strategy; build a *naive* copy that
additionally observes fantasized results ("lies") for incomplete trials;
suggest from the naive copy so concurrent suggestion stays diverse; register
trials with lineage parents; jittered backoff on duplicate points and a
`max_idle_time` guard against algorithms that stop producing new points.

Where the port differs from the reference:

- The random stream.  The reference hands the naive copy's ``rng_key`` to
  the real algorithm after each suggest.  Here each instance owns a
  ``torch.Generator``; the naive copy's generator STATE is copied into the
  real algorithm's own generator (:func:`_advance_rng`).  Sharing the
  generator object would alias the two instances' streams; not copying
  would make every round replay the same draws.
- The lies of a round are registered in one storage round
  (``Experiment.register_lies``), where the reference writes each on its
  own: on the ``pickled`` file each write rewrites the whole file, so two
  workers at q=1024 paid 1024 rewrites a round for the other's batch.
Telemetry, as in the reference: every ``produce`` round is the root span
``producer.round`` (a new distributed trace: the storage ops it causes
nest inside it); the producer's suggest / register / observe samples
become ``producer.<op>`` spans booked once a round; a ``producer.round``
flight event per round; on the speculative path a ``device.dispatch``
span per ring entry (dispatch to finalize or discard) and a
``producer.speculative_dispatch`` span for the host's share; and
``_flush_timings`` drains the spans (the flight events mirrored as
``flight.*`` spans) to storage every round and upserts the metrics
snapshot at most every :attr:`Producer.METRICS_FLUSH_INTERVAL` seconds.

Before each metrics snapshot the device-memory sampler runs
(``orion_tpu_torch.devmem.sample_memory``), and each health record carries
the ``mem_bytes`` stamp of its gauge, as in the reference; so do the
serve-placement gauges of a fleet-served algorithm
(:meth:`Producer._sample_serve_placement`).
"""

import copy
import inspect
import logging
import os
import time
from collections import deque

import numpy as np

from orion_tpu_torch.core.trial import RESERVABLE_STATUSES, Result, Trial, TrialBatch
from orion_tpu_torch.devmem import sample_memory
from orion_tpu_torch.health import FLIGHT, flight_events_as_spans
from orion_tpu_torch.storage.retry import RetryPolicy
from orion_tpu_torch.telemetry import TELEMETRY, current_trace_context
from orion_tpu_torch.utils.exceptions import (
    AlgorithmExhausted,
    DuplicateKeyError,
    SampleTimeout,
)

log = logging.getLogger(__name__)


def _base_register_suggestion():
    """The BaseAlgorithm no-op ``register_suggestion`` (lazy import: the
    algo package is heavier than this module and not otherwise needed)."""
    from orion_tpu_torch.algo.base import BaseAlgorithm

    return BaseAlgorithm.register_suggestion


def _observe_accepts_cube(algo):
    """True when the algorithm's ``observe`` takes the columnar ``cube``
    kwarg (the BaseAlgorithm contract).  Pre-columnar third-party plugins
    that override ``observe(params_list, results)`` keep working through
    the dict path."""
    try:
        sig = inspect.signature(type(algo).observe)
    except (TypeError, ValueError):  # pragma: no cover - exotic callables
        return False
    return any(
        p.name == "cube" or p.kind is inspect.Parameter.VAR_KEYWORD
        for p in sig.parameters.values()
    )


def _advance_rng(real, naive):
    """Move ``real``'s random streams to where ``naive``'s stand, and
    nothing else of its state: the naive copy has observed lies, which must
    never reach the real algorithm.  Each generator's state is copied (a
    host-side seed and offset, also for a ``cuda`` generator); the two
    instances keep their own generator objects."""
    for name in ("generator", "model_generator"):
        gen = getattr(naive, name, None)
        if gen is not None:
            getattr(real, name).set_state(gen.get_state())


class Producer:
    #: Minimum seconds between metrics-snapshot upserts: _flush_timings
    #: runs from both update() and produce(), and the snapshot (every
    #: histogram's full bucket array) is the heaviest telemetry write —
    #: a q-round's worth of freshness is plenty.
    METRICS_FLUSH_INTERVAL = 2.0

    def __init__(self, experiment, max_idle_time=None, pipeline_depth=None):
        from orion_tpu_torch.core.experiment import (
            DEFAULT_MAX_IDLE_TIME,
            DEFAULT_PIPELINE_DEPTH,
        )

        if max_idle_time is None:
            max_idle_time = DEFAULT_MAX_IDLE_TIME
        # Pipeline depth resolution: explicit arg > experiment worker-level
        # knob > ORION_TPU_PIPELINE_DEPTH env > default 1.
        if pipeline_depth is None:
            pipeline_depth = getattr(experiment, "pipeline_depth", None)
        if pipeline_depth is None:
            pipeline_depth = os.environ.get("ORION_TPU_PIPELINE_DEPTH")
        self.pipeline_depth = max(
            1, int(pipeline_depth or DEFAULT_PIPELINE_DEPTH)
        )
        if experiment.algorithm is None:
            raise RuntimeError("Experiment not instantiated (call instantiate())")
        self.experiment = experiment
        self.algorithm = experiment.algorithm
        self.strategy = experiment.strategy
        self.max_idle_time = max_idle_time
        self.naive_algorithm = None
        self._observed_ids = set()  # replaces reference TrialsHistory dedup
        self._leaf_ids = []  # lineage: children of observed DAG (trials_history.py)
        # Columnar observe cache: trial id -> (D,) float32 unit-cube row
        # (Space.params_to_cube encoding).  Lies re-observe every in-flight
        # trial every round; without this each round re-parses O(in-flight)
        # param dicts through the codec.  Keyed by the STORAGE trial id —
        # a stored string on fetched trials, so cache lookups never pay the
        # md5-over-params hash_params would recompute per access.  Rows are
        # evicted once their trial completes and feeds the real algorithm
        # (never needed again — _observed_ids gates re-observation) and
        # swept for stopped trials.
        self._cube_cache = {}
        # Third-party plugins may predate the columnar contract and override
        # observe(params_list, results) without the cube kwarg — detect once
        # and fall back to the dict path for them (same semantics, slower).
        # Algorithms that declare uses_observe_cube=False (purely dict-keyed
        # observation handling, e.g. ASHA rung bookkeeping) skip the cube
        # build/cache too — it would be pure waste for them.
        self._observe_takes_cube = getattr(
            self.algorithm, "uses_observe_cube", True
        ) and _observe_accepts_cube(self.algorithm)
        self.failure_count = 0
        self._backoff_policy = RetryPolicy(
            base_delay=0.01, max_delay=0.5, jitter=0.5, deadline=None
        )
        self._n_in_flight = 0  # status == reserved (someone is executing)
        self._n_reservable = 0  # new/suspended/interrupted (worker can consume)
        self._pending_timings = []
        # Telemetry span entries buffered per round and booked in ONE
        # record_spans_batch call at flush time — the per-sample
        # record_span each paid a lock round-trip inside the hot loop.
        self._pending_spans = []
        # One optimization-health record per produce round, built at round
        # end with telemetry on and flushed through the storage health
        # channel next to the spans/metrics.
        self._pending_health = None
        self._round_index = 0
        self._last_metrics_flush = float("-inf")
        self._n_completed_seen = 0
        self._update_epoch = 0
        # The speculative ring: up to ``pipeline_depth`` in-flight rounds,
        # oldest first, each ``(handle, algo, t0, ctx)`` — the unforced
        # device handle, the naive copy that dispatched it, and (telemetry
        # on) the dispatch time and trace context its ``device.dispatch``
        # span closes against.  Round k's storage
        # commit and codec work run while rounds k+1..k+N sit here (CUDA
        # launches are asynchronous).
        self._spec_ring = deque()
        # Whether the algorithm actually implements register_suggestion:
        # the per-slot call is a per-point plugin API, and paying a q-row
        # dict materialization per round to invoke the base no-op would
        # defeat the columnar commit.  Re-resolved at the top of every
        # produce round (_refresh_register_suggestion_gate) so
        # instance-assigned hooks and post-construction monkeypatches keep
        # firing exactly as a dynamic call would.
        self._needs_register_suggestion = True
        self._refresh_register_suggestion_gate()
        # Trial ids already conditioned (register_suggestion + lie) onto the
        # CURRENT naive copy by _dispatch_speculative: the pipelined commit
        # may re-invoke it on the same instance (mid-loop dispatch opted
        # out, post-loop retry), and re-observing the same lies would skew
        # opt-in model-based speculation.  Reset whenever the naive copy is
        # rebuilt.
        self._spec_conditioned = set()
        # Probe the EVC family ONCE: walking the tree costs extra collection
        # scans per round (each a full lock/unpickle on the file backend),
        # which an un-branched experiment should never pay.  A branch
        # appearing mid-run is picked up by the next worker process.
        # The fetcher is incremental: topology and adapted family trials are
        # cached, only changed trials re-read and re-adapted each round.
        self._tree_fetcher = None
        if experiment.refers.get("parent_id") or experiment.storage.fetch_experiments(
            {"refers.parent_id": experiment.id}, projection={"_id": 1}
        ):
            from orion_tpu_torch.evc.experiment import TreeTrialsFetcher

            self._tree_fetcher = TreeTrialsFetcher(experiment)

    # --- observation --------------------------------------------------------
    def update(self):
        """Sync algorithm state with storage (reference `producer.py:103-132`).

        Trials come through the EVC tree: a branched child warm-starts from
        its ancestors' completed trials, adapted hop by hop (reference
        `evc/experiment.py:154-226` — the point of branching).

        The round's snapshot comes from storage.fetch_update_view, which
        count-gates the completed history on capable backends (update()
        runs every produce round AND every backoff; re-reading the whole
        completed history each time costs O(trials) per call) and keeps
        the single full fetch elsewhere — see its docstring for the
        consistency and ordering contract."""
        if self._tree_fetcher is not None:
            trials = self._tree_fetcher.fetch()
        else:
            # Every 16th sync forces the gate open: the count gate assumes
            # the completed count only grows, which a concurrent db-level
            # remove of a completed trial (offset by a fresh completion)
            # could violate — the periodic full read bounds that staleness
            # window instead of trusting the invariant forever.
            self._update_epoch += 1
            known = self._n_completed_seen if self._update_epoch % 16 else -1
            trials, self._n_completed_seen = (
                self.experiment.storage.fetch_update_view(self.experiment, known)
            )
        completed = [t for t in trials if t.status == "completed" and t.objective]
        incomplete = [t for t in trials if not t.is_stopped]
        # Exhaustion/backoff accounting counts THIS experiment's trials only:
        # the EVC tree fetch includes the family's trials, which this worker
        # can never reserve and whose completions feed ancestors, not us.
        own_id = self.experiment.id
        own = [t for t in trials if t.experiment == own_id]
        self._n_in_flight = sum(t.status == "reserved" for t in own)
        self._n_reservable = sum(t.status in RESERVABLE_STATUSES for t in own)
        self._update_algorithm(completed)
        # Bound the columnar cache: stopped trials are never lied about
        # again, so their rows are dead weight.  Completed-with-objective
        # trials were just observed (and evicted) above; this sweep covers
        # broken / interrupted / objective-less terminals, which would
        # otherwise leak one row per failed trial forever.  (A resumed
        # interrupted trial simply re-encodes on its next cache miss.)
        if self._cube_cache:
            for t in trials:
                if t.is_stopped:
                    self._cube_cache.pop(t.id, None)
        self._update_naive_algorithm(incomplete)
        self._flush_timings()

    def _update_algorithm(self, completed):
        fresh = [t for t in completed if t.id not in self._observed_ids]
        if fresh:
            params = [t.params for t in fresh]
            results = [_trial_results(t) for t in fresh]
            cube = self._cube_rows_for(fresh)
            t0 = time.perf_counter()
            if cube is not None:
                self.algorithm.observe(params, results, cube=cube)
            else:  # pre-columnar plugin signature
                self.algorithm.observe(params, results)
            self._record_timing("observe", time.perf_counter() - t0, len(fresh))
            self.strategy.observe(params, results)
            for t in fresh:
                self._observed_ids.add(t.id)
                self._cube_cache.pop(t.id, None)
            self._leaf_ids = [t.id for t in fresh]

    def _cube_rows_for(self, trials):
        """(n, D) columnar rows for ``trials`` — cache hits plus ONE bulk
        ``params_to_cube`` call for the misses.  Bit-identical to the
        per-call dict encode the algorithms would otherwise run (same
        single pipeline, row-independent codec), so the columnar and dict
        observe paths cannot diverge.  Host numpy rows: the algorithm
        uploads a whole observe batch at once.  Returns None (dict
        fallback) for pre-columnar plugin algorithms."""
        if not self._observe_takes_cube:
            return None
        space = self.algorithm.space
        # lint: disable=PERF001 -- one dict probe per row against the id
        # cache (no codec work); misses below encode in ONE bulk call.
        rows = [self._cube_cache.get(t.id) for t in trials]
        missing = [i for i, r in enumerate(rows) if r is None]
        if missing:
            encoded = space.params_to_cube([trials[i].params for i in missing])
            for j, i in enumerate(missing):
                # Copy each row out: a view into `encoded` would pin the
                # whole (n_missing, D) batch for as long as any one row
                # survives in the cache.
                row = np.array(encoded[j])
                self._cube_cache[trials[i].id] = row
                rows[i] = row
        if not rows:
            return None
        return np.stack(rows)

    def _record_timing(self, op, duration, count):
        """Buffer a timing sample; flushed once per produce()/update() round
        so telemetry never adds a storage write inside the hot retry loop.

        The same sample also feeds the process-wide telemetry registry as a
        ``producer.{op}`` span + histogram entry — BUFFERED like the
        storage samples and booked in one ``record_spans_batch`` call at
        flush time, so the hot loop pays no registry lock per sample.
        The span start is captured here (now - duration) so batching does
        not shift the record on the trace timeline."""
        self._pending_timings.append((op, duration, count))
        # Guarded: the span name f-string and args dict must not be
        # allocated per sample when telemetry is off — this runs inside
        # every produce()/update() round.  The ambient TraceContext is
        # captured NOW (fifth element): the batch flushes at round end,
        # when the ambient may already belong to the next round.
        if TELEMETRY.enabled:
            self._pending_spans.append(
                (
                    f"producer.{op}",
                    time.perf_counter() - duration,
                    duration,
                    {"count": count},
                    current_trace_context(),
                )
            )

    def _flush_timings(self, force_metrics=False):
        """Telemetry must never break the run.

        Flushes the buffered timing samples and the round's health record
        through storage AND, when the telemetry registry is enabled, this
        worker's new span records (drained once each; the flight events
        mirrored as ``flight.*`` spans) + a metrics snapshot upsert — so
        ``orion-tpu-torch metrics``/``trace`` aggregate across worker
        processes.  The snapshot upsert is time-gated
        (METRICS_FLUSH_INTERVAL): this runs from update() AND produce(),
        and re-upserting an all-histograms snapshot twice per round would
        tax the storage hot path.  ``force_metrics`` (the end-of-run
        flush) bypasses the gate so final totals always land."""
        samples, self._pending_timings = self._pending_timings, []
        health, self._pending_health = self._pending_health, None
        if (not samples and not health and not TELEMETRY.enabled
                and not FLIGHT.enabled):
            return
        # Book the round's buffered producer spans in one registry call
        # BEFORE draining, so they ride this very flush to storage.
        if self._pending_spans:
            pending, self._pending_spans = self._pending_spans, []
            TELEMETRY.record_spans_batch(pending)
        try:
            if samples:
                self.experiment.storage.record_timings(self.experiment, samples)
            spans = TELEMETRY.drain_spans() if TELEMETRY.enabled else []
            if FLIGHT.enabled:
                # Mirror drained flight events into the spans channel as
                # flight.* records, so `orion-tpu-torch flight-record -n
                # NAME` can reconstruct this worker's recent history.
                spans = spans + flight_events_as_spans(FLIGHT.drain())
            if spans:
                self.experiment.storage.record_spans(self.experiment, spans)
            if health:
                self.experiment.storage.record_health(self.experiment, health)
            if TELEMETRY.enabled:
                now = time.monotonic()
                if (
                    force_metrics
                    or now - self._last_metrics_flush >= self.METRICS_FLUSH_INTERVAL
                ):
                    # The device-memory and graph-cache gauges ride the same
                    # gate (rate-limited again inside), so a snapshot never
                    # ships stale memory numbers.
                    sample_memory(force=force_metrics)
                    self._sample_serve_placement()
                    self.experiment.storage.record_metrics(
                        self.experiment, TELEMETRY.snapshot()
                    )
                    self._last_metrics_flush = now
        except Exception:  # pragma: no cover - read-only/remote storage quirks
            log.debug("could not record telemetry", exc_info=True)

    def _sample_serve_placement(self):
        """Mirror the remote algorithm's fleet placement into gauges
        (fleet-served experiments only: ``placement()`` is None for local
        algorithms and single-gateway tenants).  Rides the metrics flush,
        so `orion-tpu-torch top`/`info` show which gateway this worker's
        tenant lives on and how often it failed over."""
        placement = getattr(self.algorithm, "placement", None)
        if placement is None:
            return
        try:
            record = placement()
        except Exception:  # pragma: no cover - observability never breaks
            return
        if not record:
            return
        TELEMETRY.set_gauge("serve.client.fleet_epoch", float(record.get("epoch") or 0))
        TELEMETRY.set_gauge("serve.client.fleet_members", float(record.get("members") or 0))
        TELEMETRY.set_gauge("serve.client.failovers", float(record.get("failovers") or 0))
        TELEMETRY.set_gauge("serve.client.adoptions", float(record.get("adoptions") or 0))

    def _update_naive_algorithm(self, incomplete):
        """Naive algo = deepcopy of real + lies for in-flight trials
        (reference `producer.py:159-174`)."""
        self.naive_algorithm = copy.deepcopy(self.algorithm)
        self._spec_conditioned.clear()  # fresh copy: nothing conditioned yet
        lying = self._produce_lies(incomplete)
        # The lies observed right below ARE conditioning: seed the set with
        # their source ids, or a mid-round backoff (rebuild here, then the
        # next iteration's speculative dispatch) would observe the same
        # in-flight trials' lies a second time on this very copy.
        self._spec_conditioned.update(src.id for src, _ in lying)
        if lying:
            params = [lt.params for _, lt in lying]
            results = [{"objective": lt.lie.value} for _, lt in lying]
            # Columnar: lies re-feed every in-flight point every round, so
            # this is the hottest dict->cube boundary in the loop — row
            # cache + one bulk encode for first-seen points.  Keyed by the
            # SOURCE trial (its storage id is a stored string; the lying
            # twin's id would be a fresh md5 per access AND would never
            # match the eviction sweep's keys).
            cube = self._cube_rows_for([src for src, _ in lying])
            if cube is not None:
                self.naive_algorithm.observe(params, results, cube=cube)
            else:  # pre-columnar plugin signature
                self.naive_algorithm.observe(params, results)

    def _produce_lies(self, incomplete):
        """(source_trial, lying_trial) pairs for every liable in-flight
        trial — the source carries the storage identity, the lying twin the
        fantasy result.  The lies are registered in ONE storage round (the
        reference writes each on its own: at q=1024 on the pickled file
        that is a whole-file rewrite per in-flight trial per round)."""
        lying = []
        for trial in incomplete:
            lie = self.strategy.lie(trial)
            if lie is None or lie.value is None:
                continue
            lying_trial = Trial(
                experiment=trial.experiment,
                params=dict(trial.params),
                results=[Result(lie.name, "lie", lie.value)],
            )
            lying.append((trial, lying_trial))
        if lying:
            outcomes = self.experiment.register_lies([lt for _, lt in lying])
            for outcome in outcomes:
                # A DuplicateKeyError slot is a lie registered in an
                # earlier round; any other failure surfaces.
                if isinstance(outcome, Exception) and not isinstance(
                    outcome, DuplicateKeyError
                ):
                    raise outcome
        return lying

    # --- production ---------------------------------------------------------
    def produce(self, pool_size=None, own_in_flight=0):
        """Register `pool_size` new trials (reference `producer.py:69-101`).

        The round's storage commit is PIPELINED: once the final batch is
        built, the next round's device suggest is dispatched first and the
        batched register runs while that computation is in flight — storage
        latency and device latency overlap instead of adding up.

        ``own_in_flight``: how many of the experiment's reserved trials THE
        CALLER itself is holding.  An opt-out normally backs off while
        reserved trials exist (their completions can revive the algorithm),
        but waiting on the caller's own reservations would deadlock the
        caller against itself (``ExperimentClient.suggest`` holding a
        partial batch) — so the wait only applies when reserved trials
        beyond the caller's own exist."""
        # root=True: every produce round IS one distributed trace — the
        # storage commits it causes all stamp this round's trace_id, which
        # is what `orion-tpu-torch trace --attribute` buckets the round's
        # wall time by.
        with TELEMETRY.span("producer.round", root=True):
            return self._produce(pool_size, own_in_flight)

    def _produce(self, pool_size, own_in_flight):
        pool_size = pool_size or self.experiment.pool_size
        self._refresh_register_suggestion_gate()
        registered = 0
        start = time.time()
        speculative = self._take_speculative(pool_size)
        registered_trials = []
        while registered < pool_size:
            if time.time() - start > self.max_idle_time:
                raise SampleTimeout(
                    f"algorithm produced no new unique point in {self.max_idle_time}s"
                )
            t0 = time.perf_counter()
            if speculative is not None:
                # Already timed by _take_speculative (the residual transfer).
                suggested, speculative = speculative, None
            else:
                # Columnar flow: the suggestion crosses the boundary as a
                # (q, d) array; batch.params is a LAZY ParamBatch — the
                # storage documents build straight from its columns below,
                # and per-point dicts only materialize at plugin-compat
                # boundaries (register_suggestion overrides, lie strategy).
                batch = self.naive_algorithm.suggest_batch(
                    pool_size - registered
                )
                suggested = batch.params if batch is not None else None
                _advance_rng(self.algorithm, self.naive_algorithm)
                if suggested is not None:
                    self._record_timing(
                        "suggest", time.perf_counter() - t0, len(suggested)
                    )
            if suggested is None:
                log.debug("algorithm opted out of suggesting")
                # Re-sync first: the opt-out may come from a stale view.
                self.update()
                if registered or self._n_reservable:
                    # The worker can make progress without new points —
                    # consume what is already registered (this round's
                    # partial batch or a concurrent producer's); exhaustion
                    # re-fires on the next dry production round.
                    break
                if self._n_in_flight > own_in_flight:
                    # Executing trials beyond the caller's own exist; their
                    # completions may change the algorithm's state — wait.
                    self._sleep_backoff()
                    continue
                t0 = time.perf_counter()
                batch = self.naive_algorithm.suggest_batch(
                    pool_size - registered
                )
                suggested = batch.params if batch is not None else None
                _advance_rng(self.algorithm, self.naive_algorithm)
                if suggested is None:
                    # Nothing pending, nothing running, and a fresh-state
                    # retry still opts out: no observation can ever arrive,
                    # so the state producing this opt-out is final.
                    raise AlgorithmExhausted(
                        "algorithm opted out of suggesting with no trials "
                        "in flight; the search space is exhausted"
                    )
                self._record_timing(
                    "suggest", time.perf_counter() - t0, len(suggested)
                )
            # Columnar commit: the round's chunk stays a lazy ParamBatch
            # (or a host scheduler's dict list) wrapped by a TrialBatch —
            # ids and storage documents are built in ONE columnar pass
            # (core.trial), never q Trial constructions.
            batch = TrialBatch(suggested[: pool_size - registered])
            # Pipelined commit: when this batch fills the round, stamp
            # identities now — freezing ids, so the speculative lie path and
            # cube cache key correctly — top the speculative ring up to
            # pipeline_depth in-flight rounds, and only then write storage.
            # Presuming the batch registers is safe: a slot that turns out
            # duplicate IS durably registered (by whoever won the race), so
            # the speculative conditioning stays truthful; the ring is
            # discarded below if any slot fails to register.
            prepared = registered + len(batch) >= pool_size
            overlapped = False
            if prepared:
                self.experiment.prepare_trial_batch(batch, parents=self._leaf_ids)
                if getattr(self.naive_algorithm, "speculation_safe", False):
                    overlapped = self._dispatch_speculative(
                        pool_size, registered_trials + batch.trials()
                    )
            # Batch registration: ONE storage round; per-trial
            # DuplicateKeyError comes back as that slot's outcome.
            t0 = time.perf_counter()
            try:
                outcomes = self.experiment.register_trial_batch(
                    batch, parents=self._leaf_ids, prepared=prepared
                )
            except Exception:
                if overlapped:
                    # Transport-level commit failure (no per-slot outcomes):
                    # the batch's fate is unknown, so every ring entry
                    # conditioned on it must go.
                    self._discard_spec_ring()
                raise
            self._record_timing("register", time.perf_counter() - t0, len(batch))
            had_duplicate = False
            batch_error = None
            spec_capable = getattr(self.naive_algorithm, "speculation_safe", False)
            # lint: disable=PERF001 -- per-slot outcome handling: the
            # register_suggestion hook is a per-point plugin API (gated to
            # algorithms that actually override it), everything else here
            # is O(1) bookkeeping per slot.
            for slot, outcome in enumerate(outcomes):
                if isinstance(outcome, DuplicateKeyError):
                    # The point IS durably registered (by us earlier or by a
                    # concurrent worker) — the algorithm must still learn it
                    # is consumed, or it will re-suggest it forever.
                    if self._needs_register_suggestion:
                        self.algorithm.register_suggestion(batch.params[slot])
                    log.debug("duplicate suggestion %s", batch.ids[slot])
                    had_duplicate = True
                elif isinstance(outcome, Exception):
                    # Remember but keep walking the outcomes: later slots of
                    # the same round WERE durably registered, and skipping
                    # their register_suggestion would make the algorithm
                    # re-suggest them all next round.
                    batch_error = batch_error or outcome
                else:
                    if self._needs_register_suggestion:
                        self.algorithm.register_suggestion(batch.params[slot])
                    registered += 1
                    # Trial views only materialize for the speculative
                    # conditioning path; their ids ride the columnar batch.
                    if spec_capable:
                        registered_trials.append(batch.trial_at(slot))
            if overlapped and (had_duplicate or batch_error is not None):
                # The speculative copies were conditioned on slots that did
                # not register; drop the whole ring — the post-loop dispatch
                # (or the next round's) redoes it from the true set.
                self._discard_spec_ring()
            if batch_error is not None:
                raise batch_error
            if had_duplicate:
                self.backoff()
        self._round_index += 1
        if TELEMETRY.enabled:
            # One optimization-health record per round: the naive copy ran
            # this round's fused suggest (its GPState carries the packed
            # device health), the REAL algorithm holds the honest host
            # truth — merge with the real instance's fields winning.
            self._pending_health = self._build_health(registered)
        if FLIGHT.enabled:
            FLIGHT.record(
                "producer.round",
                args={"round": self._round_index, "registered": registered},
            )
        self._flush_timings()
        if len(self._spec_ring) < self._effective_pipeline_depth(
            self.naive_algorithm
        ):
            self._dispatch_speculative(pool_size, registered_trials)
        return registered

    def _refresh_register_suggestion_gate(self):
        """Resolve whether ``register_suggestion`` must be invoked per slot.

        Looked up on the INSTANCE (not the class) and refreshed every
        produce round: a plugin assigning the hook in ``__init__`` or a
        test monkeypatching it after construction must keep receiving the
        per-point callbacks."""
        hook = getattr(self.algorithm, "register_suggestion", None)
        self._needs_register_suggestion = (
            hook is not None
            and getattr(hook, "__func__", hook)
            is not _base_register_suggestion()
        )

    def _effective_pipeline_depth(self, algo):
        """Ring depth actually used for ``algo``.

        Deep rings are provably free ONLY for algorithms that declare
        ``speculation_safe`` at the CLASS level (observation-independent:
        random, grid — any depth is bit-identical to depth 1).  Opt-in
        model-based speculation (`speculative_suggest=True` sets the flag
        per-INSTANCE) keeps the async-BO contract "each in-flight round is
        conditioned on the previous one's lies", which a burst of N
        dispatches from one posterior would break.  Such algorithms stay
        1-deep regardless of the knob."""
        if getattr(type(algo), "speculation_safe", False):
            return self.pipeline_depth
        return 1

    def _build_health(self, registered):
        """Merge naive-copy device health over real-instance host truth
        into one per-round record; never raises and returns None for
        algorithms that report nothing."""
        try:
            record = {}
            naive = self.naive_algorithm
            if naive is not None:
                record.update(
                    getattr(naive, "health_record", lambda: None)() or {}
                )
            record.update(
                getattr(self.algorithm, "health_record", lambda: None)() or {}
            )
            if not record:
                return None
            record["round"] = self._round_index
            record["registered"] = int(registered)
            record["time"] = time.time()
            # Device-memory stamp (orion_tpu_torch.devmem publishes the
            # gauge, rate-limited): gauges are last-write-wins, so the
            # health record is the only stored time series of it.
            mem = TELEMETRY.gauge_value("memory.device_live_bytes")
            if mem is not None:
                record["mem_bytes"] = float(mem)
            return record
        except Exception:  # pragma: no cover - observability never breaks a run
            log.debug("could not build health record", exc_info=True)
            return None

    # --- speculative overlap ------------------------------------------------
    def _close_entry_window(self, t0, ctx, outcome):
        """Close one ring entry's ``device.dispatch`` span: the async
        device work window from speculative dispatch to finalize/discard."""
        # t0 is only ever stamped with telemetry enabled, but the args dict
        # below must provably not allocate on the disabled path, so the
        # guard is explicit (it also closes the window cleanly if the
        # registry was disabled mid-run).
        if t0 is not None and TELEMETRY.enabled:
            TELEMETRY.record_span(
                "device.dispatch", start=t0, args={"outcome": outcome},
                parent_ctx=ctx,
            )

    def _discard_spec_ring(self):
        """Drop every in-flight speculative round (commit failure, duplicate
        slots, naive-copy invalidation): their conditioning presumed a
        registration set that did not hold, so none may be consumed."""
        while self._spec_ring:
            _handle, _algo, t0, ctx = self._spec_ring.popleft()
            self._close_entry_window(t0, ctx, "discarded")

    def _dispatch_speculative(self, pool_size, registered_trials):
        """Top the speculative ring up to ``pipeline_depth`` in-flight
        rounds before this round's trials execute.

        Only algorithms declaring ``speculation_safe`` are speculated.
        Observation-independent algorithms (random search) declare it by
        class — dispatching N rounds ahead consumes the SAME random stream
        the synchronous path would, in the same order (rounds are finalized
        oldest-first), so any depth is bit-identical to depth 1.
        Model-based algorithms opt in (`speculative_suggest=True`,
        async-BO semantics): the naive copy first observes constant-liar
        lies for the just-registered batch, and such algorithms are CAPPED
        at an effective depth of 1 (_effective_pipeline_depth).  Lie
        conditioning happens ONCE per registered batch
        (``_spec_conditioned``).

        Returns True when at least one speculative round is in flight
        after the call — the pipelined commit path uses this to know the
        storage write it is about to issue overlaps live device work."""
        algo = self.naive_algorithm
        if algo is None or not getattr(algo, "speculation_safe", False):
            # A non-speculative algorithm must never leave stale handles
            # behind.
            self._discard_spec_ring()
            return False
        t_dispatch = time.perf_counter() if TELEMETRY.enabled else None
        dispatched = 0
        try:
            # Condition each trial onto this naive copy AT MOST ONCE (the
            # set resets with every naive rebuild).
            # lint: disable=PERF001 -- plugin-compat boundary: the lie
            # strategy and register_suggestion hooks are per-point APIs;
            # this path only runs for speculation-safe algorithms.
            fresh = [
                t for t in registered_trials
                if t.id not in self._spec_conditioned
            ]
            if fresh:
                # The dispatch copy predates this round's registrations (it
                # was deepcopied in update()): mark the just-registered
                # points consumed on IT too, or cursor-based algorithms
                # (grid) would speculatively re-suggest the exact batch just
                # written and pay a round of DuplicateKeyError + backoff.
                for trial in fresh:
                    if self._needs_register_suggestion:
                        algo.register_suggestion(trial.params)
                    self._spec_conditioned.add(trial.id)
                lie_trials, lie_results = [], []
                for trial in fresh:
                    lie = self.strategy.lie(trial)
                    if lie is not None and lie.value is not None:
                        lie_trials.append(trial)
                        lie_results.append({"objective": lie.value})
                if lie_trials:
                    lie_params = [dict(t.params) for t in lie_trials]
                    lie_cube = self._cube_rows_for(lie_trials)
                    if lie_cube is not None:
                        algo.observe(lie_params, lie_results, cube=lie_cube)
                    else:  # pre-columnar plugin signature
                        algo.observe(lie_params, lie_results)
            depth = self._effective_pipeline_depth(algo)
            while len(self._spec_ring) < depth:
                t0 = time.perf_counter() if TELEMETRY.enabled else None
                handle = algo.dispatch_suggest(pool_size)
                if handle is None:
                    break
                ctx = current_trace_context() if t0 is not None else None
                self._spec_ring.append((handle, algo, t0, ctx))
                dispatched += 1
        except Exception:  # pragma: no cover - speculation must never break a run
            log.debug("speculative dispatch failed", exc_info=True)
            return bool(self._spec_ring)
        if t_dispatch is not None:
            # Host-side cost of conditioning + async dispatch; the device
            # work windows are the per-entry open ``device.dispatch`` spans
            # above.
            TELEMETRY.record_span(
                "producer.speculative_dispatch",
                start=t_dispatch,
                args={"dispatched": dispatched},
            )
        if dispatched:
            # Keep the real algo's random stream ahead of the speculative
            # draws, or the next naive copy would replay them.
            _advance_rng(self.algorithm, algo)
        return bool(self._spec_ring)

    def _take_speculative(self, pool_size):
        if not self._spec_ring:
            return None
        handle, algo, t0, ctx = self._spec_ring.popleft()
        try:
            t_fin = time.perf_counter()
            out = algo.finalize_suggest_batch(handle).params[:pool_size]
            # Timed as "suggest": what remains of the device round trip
            # after the overlap (ideally just the residual transfer).
            self._record_timing("suggest", time.perf_counter() - t_fin, len(out))
            self._close_entry_window(t0, ctx, "finalized")
            return out
        except Exception:  # pragma: no cover - speculation must never break a run
            log.debug("speculative finalize failed", exc_info=True)
            self._close_entry_window(t0, ctx, "failed")
            # Later entries share the failed handle's lineage (same naive
            # copy, same device stream) — discard rather than trust them.
            self._discard_spec_ring()
            return None

    def backoff(self):
        """Re-sync with storage + jittered sleep (reference `producer.py:61-67`)."""
        self.update()
        self._sleep_backoff()

    def _sleep_backoff(self):
        # The unified backoff policy (storage/retry.py): exponential from
        # 10ms, capped at 0.5s, jittered so concurrent producers
        # de-synchronize.
        self._backoff_policy.sleep(
            self.failure_count, op="producer.backoff", span="producer.backoff"
        )
        self.failure_count += 1


def _trial_results(trial):
    out = {"objective": trial.objective.value if trial.objective else None}
    if trial.gradient is not None:
        out["gradient"] = trial.gradient.value
    if trial.constraints:
        out["constraint"] = [c.value for c in trial.constraints]
    return out
