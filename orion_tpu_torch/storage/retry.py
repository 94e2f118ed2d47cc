"""Unified retry/backoff policy for storage operations (port of
``orion_tpu/storage/retry.py``).

``RetryPolicy`` is the one contract every storage operation shares:

- **exponential backoff with jitter and a deadline** — attempt ``n``
  sleeps ``base_delay * multiplier**n`` (capped at ``max_delay``),
  jittered so a fleet of workers hammered by the same outage doesn't
  retry in lockstep, and bounded by both ``max_attempts`` and a wall
  clock ``deadline``;
- **transient-vs-fatal classification** shared by every caller:
  semantic outcomes (``DuplicateKeyError``, ``FailedUpdate``,
  ``AuthenticationError``, ``KeyError``) are *answers*, never retried;
  everything else in the ``DatabaseError`` family plus OS-level
  connection failures is presumed transient;
- **applied-or-not awareness**: an exception carrying
  ``maybe_applied=True`` is only retried for operations that *converge*
  under re-application.  Non-converging ops give up immediately and
  surface the ambiguity to the caller;
- **telemetry**: every retry books a ``storage.retries`` counter tick +
  a ``storage.retry.backoff`` span (so retries are visible in a trace
  exactly where the round stalled) and a ``storage.retry`` flight event,
  and every exhausted policy books ``storage.gave_up`` (counter and
  flight event).

``DocumentStorage`` applies a policy instance to every protocol op
(``storage/base.py``).
"""

import random
import time

from orion_tpu_torch.health import FLIGHT
from orion_tpu_torch.telemetry import TELEMETRY
from orion_tpu_torch.utils.exceptions import (
    AuthenticationError,
    DatabaseError,
    DuplicateKeyError,
    FailedUpdate,
)

#: Exceptions that are semantic outcomes of the operation — retrying them
#: can only repeat the same answer (or worse, mask a real conflict).
FATAL_ERRORS = (DuplicateKeyError, FailedUpdate, AuthenticationError)

#: Retry modes — how an op behaves when the failed attempt MAY have been
#: durably applied (``exc.maybe_applied``):
#: - "always": the op converges under re-application (deterministic ids +
#:   unique indexes absorb a duplicate insert; absolute by-id updates are
#:   idempotent; an orphaned reservation is recovered by the lost-trial
#:   sweep) — retry any transient failure.
#: - "unapplied": the op does NOT converge (a was-guarded CAS re-applied
#:   after success reports a spurious conflict) — retry only failures
#:   that guarantee nothing was applied.
MODE_ALWAYS = "always"
MODE_UNAPPLIED = "unapplied"


def is_transient(exc):
    """True when ``exc`` is worth retrying: an infrastructure failure, not
    a semantic answer.  THE classification every retry loop (storage layer,
    worker loop, pacemaker) shares — two call sites disagreeing on what is
    transient is how silent retry-forever loops are born."""
    if isinstance(exc, FATAL_ERRORS):
        return False
    if isinstance(exc, DatabaseError):
        return True
    return isinstance(exc, (ConnectionError, TimeoutError, OSError))


class RetryPolicy:
    """Exponential backoff + jitter + deadline around a callable.

    Parameters mirror the ``storage.retry`` config section
    (docs/robustness.md): ``max_attempts`` total tries, delays growing as
    ``base_delay * multiplier**attempt`` capped at ``max_delay``, the
    whole affair bounded by ``deadline`` seconds of wall clock.
    ``jitter`` is the +/- fraction applied to each delay; ``seed`` pins
    the jitter stream for deterministic tests.  ``sleep`` is injectable
    for the same reason.
    """

    def __init__(
        self,
        max_attempts=4,
        base_delay=0.05,
        max_delay=2.0,
        multiplier=2.0,
        jitter=0.25,
        deadline=15.0,
        seed=None,
        sleep=time.sleep,
    ):
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = None if deadline is None else float(deadline)
        self._rng = random.Random(seed)
        self._sleep = sleep

    def delay(self, attempt):
        """Backoff before retry number ``attempt`` (0-based), jittered."""
        # Exponent-capped: past ~2**64 the product is max_delay regardless,
        # and an unbounded float power overflows on long outages.
        raw = min(
            self.base_delay * self.multiplier ** min(attempt, 64), self.max_delay
        )
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        # Cap AFTER jitter: max_delay is a hard ceiling (at the cap, jitter
        # only shortens — fleets still de-synchronize on the way up).
        return max(0.0, min(raw, self.max_delay))

    def sleep(self, attempt, op="storage", span="storage.retry.backoff"):
        """Sleep one backoff step, booked as a span so stalls show up in
        traces where they happened.  ``span`` defaults to the storage
        layer's ``storage.retry.backoff``; non-storage reusers of the
        policy (producer duplicate backoff, worker reserve spacing) pass
        their own name so a healthy-but-contended run doesn't read as a
        struggling store in a trace."""
        duration = self.delay(attempt)
        if duration > 0.0:
            self._sleep(duration)
        # Guarded: the args dict must not be allocated when telemetry is
        # off — backoff sleeps sit inside the storage retry hot path.
        if TELEMETRY.enabled:
            TELEMETRY.record_span(
                span,
                duration=duration,
                args={"op": op, "attempt": attempt},
                histogram=False,
            )
        return duration

    def run(self, fn, op="storage", mode=MODE_ALWAYS):
        """Call ``fn()`` under this policy.

        Transient failures are retried with backoff until ``max_attempts``
        or ``deadline`` runs out; fatal failures raise immediately.  In
        ``mode="unapplied"`` a failure whose ``maybe_applied`` flag is set
        gives up at once (see MODE_UNAPPLIED above).  Gave-up failures
        re-raise the LAST exception after booking ``storage.gave_up``.
        """
        stop_at = (
            None if self.deadline is None else time.monotonic() + self.deadline
        )
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as exc:
                if not is_transient(exc):
                    raise
                if mode == MODE_UNAPPLIED and getattr(exc, "maybe_applied", False):
                    TELEMETRY.count("storage.gave_up")
                    raise
                attempt += 1
                out_of_budget = attempt >= self.max_attempts or (
                    stop_at is not None and time.monotonic() >= stop_at
                )
                if out_of_budget:
                    TELEMETRY.count("storage.gave_up")
                    # Guarded (TEL004): the args dict must not allocate on
                    # the disabled path — this sits inside the retry loop.
                    if FLIGHT.enabled:
                        FLIGHT.record(
                            "storage.gave_up",
                            args={"op": op, "attempts": attempt},
                        )
                    raise
                TELEMETRY.count("storage.retries")
                if FLIGHT.enabled:
                    FLIGHT.record(
                        "storage.retry", args={"op": op, "attempt": attempt}
                    )
                self.sleep(attempt - 1, op=op)


def create_retry_policy(config=None):
    """Build a policy from a ``storage.retry`` config section.

    ``None``/``{}`` -> the default policy; ``False`` -> no retries (the
    raw pre-policy behavior, for tests and callers that layer their own
    handling); a dict -> ``RetryPolicy(**dict)``; a ready policy instance
    passes through."""
    if config is False:
        return None
    if config is None or config == {}:
        return RetryPolicy()
    if isinstance(config, RetryPolicy):
        return config
    return RetryPolicy(**dict(config))
