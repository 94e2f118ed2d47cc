"""The worker main loop (port of ``orion_tpu/core/worker.py``).

Capability parity: reference `src/orion/core/worker/__init__.py` — `workon`
creates a Producer and Consumer and loops `worker_trials` times (infinite by
default): stop when the experiment is done or broken; reserve a trial
(producing new ones when the queue is dry); consume it; report stats at the
end.  Many workers running this loop against one shared storage is the
framework's data-parallel execution model; on-device parallelism lives
inside each algorithm's suggest step.

Observability, as in the reference: the worker's ``/metrics`` +
``/healthz`` server starts with the loop when ``ORION_TPU_METRICS_PORT``
(or the ``metrics_port:`` config key) asks for one; a crash dumps the
flight recorder's ring next to the process (``flight-<name>-<pid>.jsonl``);
and the loop's end flushes the producer's last spans and a final metrics
snapshot.  Left out: the diagnosis watchdog (``doctor_interval``), which
comes with the diagnosis package (ROADMAP queue A item 9).
"""

import io
import logging
import time

from orion_tpu_torch.core.consumer import Consumer
from orion_tpu_torch.core.experiment import DEFAULT_HEARTBEAT, DEFAULT_MAX_IDLE_TIME
from orion_tpu_torch.core.producer import Producer
from orion_tpu_torch.health import FLIGHT
from orion_tpu_torch.storage.retry import RetryPolicy, is_transient
from orion_tpu_torch.utils.exceptions import (
    AlgorithmExhausted,
    BrokenExperiment,
    DatabaseError,
    SampleTimeout,
    WaitingForTrials,
)

log = logging.getLogger(__name__)

#: Production rounds reserve_trial attempts before declaring the queue dry.
MAX_RESERVE_ROUNDS = 10


def reserve_trial(experiment, producer, max_rounds=MAX_RESERVE_ROUNDS, policy=None):
    """Reserve a trial, producing a fresh batch when none is pending
    (reference `worker/__init__.py:24-39`).

    Iterative, not recursive: the loop retries up to ``max_rounds``
    production rounds with the unified backoff policy between empty-handed
    rounds, so contention storms (concurrent workers stealing every
    produced batch) thin out instead of stampeding."""
    if policy is None:
        policy = RetryPolicy(
            max_attempts=max_rounds + 1, base_delay=0.01, max_delay=0.5,
            deadline=None,
        )
    for attempt in range(max_rounds + 1):
        trial = experiment.reserve_trial()
        if trial is not None:
            return trial
        if attempt >= max_rounds:
            break
        if attempt:
            # First empty round just produces (the common cold-start);
            # repeated ones mean contention — space them out.
            policy.sleep(attempt - 1, op="reserve_trial", span="worker.backoff")
        log.debug("no pending trials; producing a new batch")
        producer.update()
        producer.produce()
    raise WaitingForTrials(
        f"no trial could be reserved after {max_rounds} production rounds"
    )


def workon(
    experiment,
    cmdline_parser,
    worker_trials=None,
    max_idle_time=DEFAULT_MAX_IDLE_TIME,
    heartbeat_interval=DEFAULT_HEARTBEAT / 2.0,
):
    """Run the optimization loop for up to `worker_trials` trials."""
    if worker_trials is None or worker_trials < 0:
        worker_trials = float("inf")
    # Pull-based metrics plane (orion_tpu_torch.metrics): a worker opts in
    # via the ORION_TPU_METRICS_PORT env var (or the `metrics_port:` config
    # key, which cli/base.py resolves to the same spelling) — idempotent,
    # one daemon /metrics + /healthz server per process, failures logged
    # not raised.
    from orion_tpu_torch.metrics import ensure_worker_metrics_server

    ensure_worker_metrics_server()
    producer = Producer(experiment, max_idle_time=max_idle_time)
    consumer = Consumer(
        experiment, cmdline_parser, heartbeat_interval=heartbeat_interval
    )
    try:
        iterations = _workon_loop(experiment, producer, consumer, worker_trials)
    except BaseException as exc:
        # Crash flight record: dump the bounded ring of recent structured
        # events (round boundaries, retries, status transitions) as a JSONL
        # artifact next to the crash, so the post-mortem starts with a
        # timeline instead of a bare traceback.  None when the recorder is
        # disabled; dump_crash never raises.
        path = FLIGHT.dump_crash(experiment.name, exc)
        if path:
            log.error("worker crashed; flight record written to %s", path)
        raise
    finally:
        # Final telemetry flush: the last round's timing samples, spans and
        # metrics (the closing producer.round span included) would
        # otherwise die with the process.  Fire-and-forget by contract;
        # force_metrics bypasses the per-round upsert gate so the worker's
        # final counter totals always land.
        producer._flush_timings(force_metrics=True)
    if experiment.is_broken:
        # The budget may be exhausted on the very last worker iteration —
        # still a broken experiment, not a clean exit.
        raise BrokenExperiment(
            f"experiment {experiment.name} has too many broken trials"
        )
    return iterations


def _workon_loop(experiment, producer, consumer, worker_trials):
    iterations = 0
    # Graceful degradation under storage hiccups: a transient failure that
    # exhausted the storage layer's own retry policy backs the WORKER off
    # (up to max_idle_time of consecutive failure) instead of crashing it —
    # a worker that dies on a 20s storage blip abandons its reserved trial
    # to the lost-trial sweep and shrinks the fleet.  Fatal (semantic)
    # errors still raise immediately; the window resets on any success.
    degrade_policy = RetryPolicy(
        max_attempts=10**9, base_delay=0.1, max_delay=5.0, deadline=None
    )
    degrade_state = {"since": None, "count": 0}

    def _degrade(exc, where):
        """Absorb one transient failure (backoff + True) or decide it must
        raise (False): fatal errors, or a failure streak past
        max_idle_time.  Only DatabaseError-family transients qualify:
        every backend wraps its infrastructure failures in DatabaseError,
        while a raw OSError here is NOT storage — it is the user's script
        failing to launch (FileNotFoundError from Popen) and must crash
        with its real traceback, not be retried as a 'storage blip'."""
        if not (isinstance(exc, DatabaseError) and is_transient(exc)):
            return False
        now = time.monotonic()
        since = degrade_state["since"] or now
        degrade_state["since"] = since
        if now - since > producer.max_idle_time:
            log.error(
                "storage has been failing for %.1fs (> max_idle_time); "
                "giving up: %s",
                now - since,
                exc,
            )
            return False
        log.warning(
            "transient storage failure during %s (attempt %d, backing off): %s",
            where,
            degrade_state["count"] + 1,
            exc,
        )
        degrade_policy.sleep(
            degrade_state["count"], op=f"worker.{where}", span="worker.backoff"
        )
        degrade_state["count"] += 1
        return True

    while iterations < worker_trials:
        # The status reads are storage round trips too: during an outage the
        # degrade path above would absorb a reserve failure only for the
        # next loop-top is_broken/is_done read to crash the worker anyway.
        try:
            broken = experiment.is_broken
            done = False if broken else experiment.is_done
        except Exception as exc:
            if not _degrade(exc, "status"):
                raise
            continue
        if broken:
            log.error(
                "Experiment %s is broken (>= %s broken trials); stopping.",
                experiment.name,
                experiment.max_broken,
            )
            raise BrokenExperiment(f"experiment {experiment.name} has too many broken trials")
        if done:
            log.info("Experiment %s is done.", experiment.name)
            break
        try:
            trial = reserve_trial(experiment, producer)
            degrade_state["since"] = None
            degrade_state["count"] = 0
        except AlgorithmExhausted:
            # A finite algorithm ran out of points with nothing in flight:
            # every registered trial is consumed and no observation can
            # change that — a clean end of the hunt.
            log.info(
                "Algorithm for experiment %s is exhausted; stopping.",
                experiment.name,
            )
            break
        except (SampleTimeout, WaitingForTrials) as dry:
            try:
                if experiment.is_done:
                    break
            except Exception as exc:
                if not _degrade(exc, "status"):
                    raise
                continue
            raise dry
        except Exception as exc:
            if not _degrade(exc, "reserve"):
                raise
            continue
        log.debug("Consuming trial %s", trial.id)
        try:
            consumer.consume(trial)
        except Exception as exc:
            # An observe-side storage failure (pushing results/status) that
            # outlived the storage policy: the trial stays reserved and the
            # lost-trial sweep will recover it — back the worker off rather
            # than killing it.  KeyboardInterrupt and semantic errors
            # propagate.
            if not _degrade(exc, "consume"):
                raise
            continue
        degrade_state["since"] = None
        degrade_state["count"] = 0
        iterations += 1
    return iterations


def format_stats(experiment):
    """Human-readable end-of-run summary (reference `worker/__init__.py:66-88`)."""
    stats = experiment.stats()
    out = io.StringIO()
    out.write("RESULTS\n=======\n")
    out.write(f"experiment: {experiment.name} (v{experiment.version})\n")
    out.write(f"trials completed: {stats['trials_completed']}\n")
    if stats.get("best_evaluation") is not None:
        out.write(f"best objective: {stats['best_evaluation']}\n")
        out.write(f"best trial: {stats['best_trials_id']}\n")
        out.write("best params:\n")
        for name, value in sorted(stats.get("best_params", {}).items()):
            out.write(f"  {name}: {value}\n")
    return out.getvalue()
