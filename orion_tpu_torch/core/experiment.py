"""Experiment: the DB-backed facade every subsystem talks to (port of
``orion_tpu/core/experiment.py``).

Capability parity: reference `src/orion/core/worker/experiment.py` — load by
(name, version) with latest-version resolution, trial operations delegated to
storage (atomic reservation + lost-trial sweep, registration with submit
time, lies, completed updates), `is_done`/`is_broken` from DB counts, stats,
and `configure()` with race-condition handling.  Branching/conflict logic
lives in `orion_tpu_torch.evc` and is invoked from the builder, not here.

Not ported yet: a ``serve`` section's remote algorithm, which raises
:class:`NotImplementedError` naming ROADMAP queue A item 8.
``instantiate(device=None)`` builds the algorithm on ``cuda`` and raises
where no card is present; the CPU runs only when ``device="cpu"`` is
passed.
"""

import logging
import time

from orion_tpu_torch.algo.base import create_algo
from orion_tpu_torch.core.strategy import create_strategy
from orion_tpu_torch.core.trial import ID_SCHEMES, Trial, compute_scheme_ids
from orion_tpu_torch.space.dsl import build_space
from orion_tpu_torch.telemetry import TELEMETRY
from orion_tpu_torch.utils.exceptions import (
    DuplicateKeyError,
    FailedUpdate,
    RaceCondition,
)

log = logging.getLogger(__name__)

#: Worker-level defaults (reference `core/__init__.py:52-105`).
DEFAULT_HEARTBEAT = 120.0
DEFAULT_MAX_BROKEN = 3
DEFAULT_MAX_IDLE_TIME = 60.0
DEFAULT_POOL_SIZE = 1
DEFAULT_PIPELINE_DEPTH = 1


class Experiment:
    """One named, versioned optimization run over a search space."""

    def __init__(self, storage, config):
        self._storage = storage
        self.name = config["name"]
        self.version = config.get("version", 1)
        self._id = config.get("_id")
        self.metadata = dict(config.get("metadata", {}))
        self.max_trials = config.get("max_trials", float("inf"))
        self.max_broken = config.get("max_broken", DEFAULT_MAX_BROKEN)
        self.heartbeat = config.get("heartbeat", DEFAULT_HEARTBEAT)
        self.max_idle_time = config.get("max_idle_time", DEFAULT_MAX_IDLE_TIME)
        self.pool_size = config.get("pool_size", DEFAULT_POOL_SIZE)
        # Worker-level knob (never stored identity, like heartbeat): how many
        # speculative rounds the producer keeps in flight (docs/performance.md
        # "Wall ≈ device").  None = unset — the Producer resolves it through
        # ORION_TPU_PIPELINE_DEPTH down to DEFAULT_PIPELINE_DEPTH (1, the
        # pre-ring behavior).
        self.pipeline_depth = config.get("pipeline_depth")
        self.working_dir = config.get("working_dir")
        self.algo_config = config.get("algorithms", "random")
        self.strategy_config = config.get("strategy", "MaxParallelStrategy")
        self.refers = dict(config.get("refers", {}))
        # Trial identity scheme — STORED identity (unlike heartbeat): every
        # consumer must compute the same ids, so the scheme rides the
        # experiment doc.  Absent = md5, which keeps every pre-existing
        # experiment resuming byte-identically; `db migrate-ids` flips it.
        self.id_scheme = config.get("id_scheme") or "md5"
        if self.id_scheme not in ID_SCHEMES:
            raise ValueError(
                f"Unknown id_scheme {self.id_scheme!r}; one of {ID_SCHEMES}"
            )
        self._last_lost_sweep = float("-inf")
        self.priors = dict(config.get("priors") or config.get("metadata", {}).get("priors", {}))
        self.space = build_space(self.priors) if self.priors else None
        self.algorithm = None
        self.strategy = None
        # Worker-level serving knob (never stored identity): a ``serve:``
        # section asks for a gateway-backed remote algorithm, which the
        # port does not have yet (instantiate raises).
        self.serve_config = config.get("serve")

    # --- instantiation ------------------------------------------------------
    def instantiate(self, seed=None, device=None):
        """Build the algorithm + strategy from config (reference
        `experiment.py:562-614`).  ``device`` goes to
        :func:`~orion_tpu_torch.algo.base.create_algo`: ``None`` means
        ``cuda`` and raises where no card is present."""
        if self.space is None:
            raise ValueError(f"Experiment {self.name} has no search space")
        if self.serve_config:
            raise NotImplementedError(
                "a serve section (remote algorithm on the suggest gateway) "
                "is not ported yet: ROADMAP queue A item 8, old item 7"
            )
        self.algorithm = create_algo(
            self.space, self.algo_config, seed=seed, device=device
        )
        self.strategy = create_strategy(self.strategy_config)
        return self

    @property
    def id(self):
        return self._id

    @property
    def storage(self):
        return self._storage

    def configuration(self):
        out = {
            "name": self.name,
            "version": self.version,
            "metadata": self.metadata,
            "max_trials": self.max_trials,
            "max_broken": self.max_broken,
            "pool_size": self.pool_size,
            "working_dir": self.working_dir,
            "algorithms": self.algo_config,
            "strategy": self.strategy_config,
            "priors": self.priors,
            "refers": self.refers,
        }
        if self.id_scheme != "md5":
            # Conditional so default-scheme experiments' configuration stays
            # byte-for-byte what every earlier release produced (EVC conflict
            # detection and stored-config comparisons ride this dict).
            out["id_scheme"] = self.id_scheme
        return out

    # --- trial operations ---------------------------------------------------
    def fix_lost_trials(self):
        """Sweep reserved trials with stale heartbeats back to reservable
        (the elastic-recovery story; reference `experiment.py:217-232`)."""
        self._last_lost_sweep = time.monotonic()
        TELEMETRY.count("experiment.lost_trial_sweeps")
        for trial in self._storage.fetch_lost_trials(self._id, self.heartbeat):
            try:
                self._storage.set_trial_status(trial, "interrupted", was="reserved")
                log.info("Recovered lost trial %s", trial.id)
                TELEMETRY.count("experiment.lost_trials_recovered")
            except FailedUpdate:
                pass  # another worker got there first — fine

    def fix_lost_trials_throttled(self, interval=None):
        """Sweep unless one already ran within ``interval`` seconds (default
        heartbeat/4); returns True when a sweep actually ran.  Rate limiting
        matters on the reservation hot path: a trial cannot become lost
        faster than the heartbeat window, so sweeping a q=4096 reservation
        burst 4096 times is pure collection-scan overhead."""
        if interval is None:
            interval = max(1.0, self.heartbeat / 4.0)
        if time.monotonic() - self._last_lost_sweep < interval:
            return False
        self.fix_lost_trials()
        return True

    def reserve_trial(self):
        swept = self.fix_lost_trials_throttled()
        trial = self._storage.reserve_trial(self._id)
        if trial is None and not swept:
            # Miss guarantee: a dead worker's trial must be recoverable on
            # ANY reservation attempt (reference `experiment.py:217-232`),
            # so force the sweep the throttle skipped — but never twice in
            # the same call.
            self.fix_lost_trials()
            trial = self._storage.reserve_trial(self._id)
        if trial is not None:
            trial.working_dir = self.working_dir
        return trial

    def reserve_trials(self, num):
        """Batch reservation: up to ``num`` trials in one storage round trip
        (pipelined on the network backend).  Same lost-trial sweep guarantee
        as :meth:`reserve_trial`."""
        swept = self.fix_lost_trials_throttled()
        trials = self._storage.reserve_trials(self._id, num)
        if not trials and not swept:
            self.fix_lost_trials()
            trials = self._storage.reserve_trials(self._id, num)
        for trial in trials:
            trial.working_dir = self.working_dir
        return trials

    def _stamp_scheme_ids(self, trials, lie=False):
        """Freeze each trial's id under this experiment's ``id_scheme``.

        md5 needs no stamp (the ``Trial.id`` property computes it lazily);
        cube_hash ids ride ``_id_override`` so every creation path —
        single-trial registration, lies, the columnar batch — emits ids
        under ONE scheme.  A mixed-scheme experiment would silently defeat
        the duplicate-point unique index."""
        if self.id_scheme == "md5" or not trials:
            return trials
        ids = compute_scheme_ids(
            self._id,
            [trial.params for trial in trials],
            lie=lie,
            id_scheme=self.id_scheme,
            space=self.space,
        )
        for trial, _id in zip(trials, ids):
            trial._id_override = _id
        return trials

    def register_trial(self, trial, parents=()):
        trial.experiment = self._id
        trial.parents = list(parents)
        trial.submit_time = time.time()
        self._stamp_scheme_ids([trial])
        self._storage.register_trial(trial)
        return trial

    def prepare_trials(self, trials, parents=()):
        """Stamp the identity fields (experiment, lineage parents, submit
        time) WITHOUT writing storage.  This finalizes each trial's id
        (the scheme hash covers experiment + params), so a caller may key
        caches or dispatch device work against the real ids BEFORE the
        storage commit — the producer's pipelined commit path does exactly
        that."""
        now = time.time()
        for trial in trials:
            trial.experiment = self._id
            trial.parents = list(parents)
            trial.submit_time = now
        return self._stamp_scheme_ids(trials)

    def register_trials(self, trials, parents=(), prepared=False):
        """Batch registration; returns per-trial outcomes (the trial, or its
        DuplicateKeyError) — one storage round (single transaction / wire
        request on capable backends).  ``prepared=True`` skips re-stamping
        trials already passed through :meth:`prepare_trials`."""
        if not prepared:
            self.prepare_trials(trials, parents)
        return self._storage.register_trials(trials)

    def prepare_trial_batch(self, batch, parents=()):
        """Columnar twin of :meth:`prepare_trials`: stamp a
        :class:`~orion_tpu_torch.core.trial.TrialBatch`'s identity fields and
        freeze its ids WITHOUT writing storage."""
        return batch.prepare(
            self._id,
            parents=parents,
            id_scheme=self.id_scheme,
            space=self.space,
        )

    def register_trial_batch(self, batch, parents=(), prepared=False):
        """Columnar batch registration: the round's documents are built in
        one pass (``TrialBatch.to_docs``) and fed straight to the storage
        batch primitive — no per-trial ``Trial``/``to_dict`` round trips.
        Returns per-slot outcomes (exception instances for failed slots,
        ``DuplicateKeyError`` for an already-taken point).  Storage
        protocols that predate ``register_trial_docs`` transparently fall
        back to the Trial-object path (identical write sequence)."""
        if not prepared:
            self.prepare_trial_batch(batch, parents)
        register_docs = getattr(self._storage, "register_trial_docs", None)
        if register_docs is not None:
            return register_docs(batch.to_docs())
        return self._storage.register_trials(batch.trials())

    def register_lies(self, trials):
        """Register lying twins of in-flight trials in one storage round;
        returns one outcome per trial (the trial, or its slot's exception:
        DuplicateKeyError for a lie registered in an earlier round)."""
        for trial in trials:
            trial.experiment = self._id
        self._stamp_scheme_ids(trials, lie=True)
        return self._storage.register_lies(trials)

    def update_completed_trial(self, trial, results):
        return self._storage.update_completed_trial(trial, results)

    def update_completed_trials(self, pairs):
        return self._storage.update_completed_trials(pairs)

    def set_trial_status(self, trial, status, was=None):
        return self._storage.set_trial_status(trial, status, was=was)

    def update_heartbeat(self, trial):
        self._storage.update_heartbeat(trial)

    def fetch_trials(self, with_evc_tree=False):
        if with_evc_tree:
            # Roots have empty refers but may still have children — the tree
            # walk itself discovers both directions.
            from orion_tpu_torch.evc.experiment import fetch_tree_trials

            return fetch_tree_trials(self)
        return self._storage.fetch_trials(uid=self._id)

    def fetch_trials_by_status(self, status):
        return self._storage.fetch_trials_by_status(self._id, status)

    def fetch_lies(self):
        return self._storage.fetch_lies(self._id)

    def fetch_noncompleted_trials(self):
        return self._storage.fetch_noncompleted_trials(self._id)

    # --- termination --------------------------------------------------------
    @property
    def is_done(self):
        """Completed-trial budget reached, or the algorithm says so."""
        if self._storage.count_completed_trials(self._id) >= self.max_trials:
            return True
        return bool(self.algorithm is not None and self.algorithm.is_done)

    @property
    def is_broken(self):
        return self._storage.count_broken_trials(self._id) >= self.max_broken

    def audit(self, lost_timeout=None):
        """Run the storage invariant auditor over this experiment's trials
        (``orion_tpu_torch.storage.audit``); the orphaned-reservation
        threshold defaults to this experiment's heartbeat window."""
        from orion_tpu_torch.storage.audit import audit_experiment

        return audit_experiment(
            self._storage, self, lost_timeout=lost_timeout
        )

    # --- stats --------------------------------------------------------------
    def stats(self):
        """Best trial + counts + duration (reference `experiment.py:419-467`)."""
        completed = self.fetch_trials_by_status("completed")
        out = {
            "trials_completed": len(completed),
            "best_trials_id": None,
            "best_evaluation": None,
            "start_time": self.metadata.get("timestamp"),
            "finish_time": None,
            "duration": None,
        }
        best = None
        finish = None
        for trial in completed:
            obj = trial.objective
            if obj is None:
                continue
            if best is None or obj.value < best.objective.value:
                best = trial
            if trial.end_time is not None:
                finish = max(finish or trial.end_time, trial.end_time)
        if best is not None:
            out["best_trials_id"] = best.id
            out["best_evaluation"] = best.objective.value
            out["best_params"] = dict(best.params)
        if finish is not None:
            out["finish_time"] = finish
            if out["start_time"] is not None:
                out["duration"] = finish - out["start_time"]
        return out


class ExperimentView:
    """Non-writable experiment façade (reference `experiment.py:673-744`).

    Wraps a built :class:`Experiment`, whitelists read-only attributes, and
    swaps its storage handle for a :class:`ReadOnlyStorage` so even the
    allowed methods cannot mutate anything.  Used by the info/status/list
    CLI paths.
    """

    __slots__ = ("_experiment",)

    valid_attributes = frozenset(
        # attributes
        ["name", "version", "metadata", "refers", "max_trials", "max_broken",
         "pool_size", "working_dir", "algo_config", "strategy_config",
         "priors", "heartbeat", "max_idle_time"]
        # properties
        + ["id", "space", "is_done", "is_broken", "stats", "storage"]
        # methods
        + ["configuration", "fetch_trials", "fetch_trials_by_status",
           "get_trial"]
    )

    def __init__(self, experiment):
        from orion_tpu_torch.storage.base import ReadOnlyStorage

        experiment._storage = ReadOnlyStorage(experiment.storage)
        object.__setattr__(self, "_experiment", experiment)

    def __getattr__(self, name):
        if name not in self.valid_attributes:
            raise AttributeError(
                f"Cannot access attribute {name!r} on view-only experiments."
            )
        return getattr(self._experiment, name)

    def __setattr__(self, name, value):
        raise AttributeError("ExperimentView is read-only")

    def __repr__(self):
        return (
            f"ExperimentView(name={self.name}, version={self.version})"
        )


def build_experiment(
    storage,
    name,
    version=None,
    user=None,
    priors=None,
    branch_config=None,
    **config,
):
    """Create-or-resume an experiment (reference `experiment_builder.py:224-288`).

    Resolution: fetch latest (or requested) version from storage; if absent,
    create version 1 with the given config.  If present and the new config
    conflicts with the stored one, delegate to EVC branching (a version bump
    child experiment) — `orion_tpu_torch.evc.builder.branch_experiment`.
    Races on concurrent creation retry once (RaceCondition semantics).
    """
    config = {k: v for k, v in config.items() if v is not None}
    for attempt in range(2):
        existing = _fetch_config(storage, name, version, user=user)
        if existing is None:
            # Non-mutating read of metadata: on a lost creation race the SAME
            # config dict feeds the resume path below, where popped metadata
            # would silently disable code/CLI conflict detection.
            full = {
                "name": name,
                "version": version or 1,
                "priors": dict(priors or {}),
                "metadata": {
                    "timestamp": time.time(),
                    **(config.get("metadata") or {}),
                },
                **{k: v for k, v in config.items() if k != "metadata"},
            }
            full.setdefault("algorithms", "random")
            full.setdefault("strategy", "MaxParallelStrategy")
            full["_id"] = full.get("_id") or experiment_id(
                name, full["version"], full["metadata"].get("user")
            )
            try:
                created = storage.create_experiment(full)
                return Experiment(storage, created)
            except DuplicateKeyError:
                if attempt:
                    raise RaceCondition(
                        f"lost creation race for experiment {name!r} twice"
                    )
                continue  # someone else created it — reload
        # Resume path.  Branch when anything identity-bearing changed: the
        # search space, an explicitly-given algorithm config (an omitted
        # algorithms key means "resume as stored", never a silent downgrade
        # to the default), the user script's VCS state, its config file
        # hash, or its non-prior command line.  The same detector drives the
        # branch itself, so the gate and the branching can never disagree.
        from orion_tpu_torch.evc.builder import branch_experiment
        from orion_tpu_torch.evc.conflicts import detect_conflicts

        exp = Experiment(storage, existing)
        candidate = {
            "name": name,
            "priors": dict(priors) if priors else dict(exp.priors),
            "algorithms": config.get("algorithms"),
            "metadata": config.get("metadata") or {},
        }
        if detect_conflicts(exp.configuration(), candidate).conflicts:
            return branch_experiment(
                storage,
                exp,
                candidate["priors"],
                branch_config=branch_config,
                **config,
            )
        for key in ("max_trials", "pool_size", "working_dir", "max_broken"):
            if key in config and config[key] is not None:
                setattr(exp, key, config[key])
        return exp
    raise RaceCondition(f"could not build experiment {name!r}")


def experiment_id(name, version, user=None):
    """Deterministic experiment identity.

    The user is part of the key: two users may own same-named experiments
    (per-user namespacing), and a name+version-only id would collide on the
    unique index at creation.  ``user=None`` keeps the historical formula so
    pre-existing databases resume unchanged.
    """
    key = {"v": version}
    if user:
        key["u"] = user
    return Trial.compute_id(name, key)


def _fetch_config(storage, name, version=None, user=None):
    query = {"name": name}
    if version is not None:
        query["version"] = version
    if user is not None:
        # -u/--user namespacing: an explicit user only sees (and resumes)
        # their own experiments; same name under another user is free.
        query["metadata.user"] = user
    docs = storage.fetch_experiments(query)
    if not docs:
        return None
    return max(docs, key=lambda d: d.get("version", 1))
