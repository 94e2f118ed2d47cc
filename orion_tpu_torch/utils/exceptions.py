"""Framework-wide exception types (a copy of ``orion_tpu/utils/exceptions.py``:
the port imports nothing of ``orion_tpu``).

Capability parity: reference `src/orion/core/utils/exceptions.py` plus DB error
types from `src/orion/core/io/database/__init__.py` (DuplicateKeyError,
DatabaseError) — unified here since our storage layer is one subsystem.
"""


class OrionTPUError(Exception):
    """Base class for all framework errors."""


class NoConfigurationError(OrionTPUError):
    """Raised when an experiment configuration cannot be found."""


class CheckError(OrionTPUError):
    """Raised when a staged database check fails."""


class RaceCondition(OrionTPUError):
    """Raised when a concurrent writer won a create/update race.

    Callers are expected to re-fetch state and retry once (reference semantics:
    `experiment_builder.py:239-251`).
    """


class DatabaseError(OrionTPUError):
    """Generic storage-backend failure.

    ``maybe_applied`` marks the applied-or-not-unknowable failures: the
    operation MAY have been durably applied before the failure surfaced
    (the network backend's lost-in-flight-mutation case, a fault-injected
    reply loss).  The unified retry policy (``storage/retry.py``) only
    re-runs such a failure for operations that converge under
    re-application; everything else surfaces the ambiguity.  Class
    default False; raisers set the instance attribute."""

    maybe_applied = False


class DuplicateKeyError(DatabaseError):
    """A unique-index constraint was violated on insert/update."""


class AuthenticationError(DatabaseError):
    """Network storage rejected the client's credentials (or none given)."""


class FailedUpdate(DatabaseError):
    """A compare-and-swap update matched no document."""


class ExecutionError(OrionTPUError):
    """User trial script exited with a nonzero return code."""


class BrokenExperiment(OrionTPUError):
    """Too many broken trials; experiment aborted."""


class InvalidResult(OrionTPUError):
    """User script reported malformed results."""


class SampleTimeout(OrionTPUError):
    """Algorithm failed to sample a new unique point within max_idle_time."""


class AlgorithmExhausted(OrionTPUError):
    """A finite algorithm opted out with no trials in flight anywhere.

    Nothing can change its state (no pending observation exists and lies
    have nothing to fantasize over), so the producer ends the hunt now
    instead of burning ``max_idle_time`` (reference opt-out contract:
    `src/orion/algo/base.py:142-163`, `src/orion/core/worker/producer.py:74-78`
    back off forever; workers exit cleanly on this signal)."""


class WaitingForTrials(OrionTPUError):
    """No trial could be reserved right now."""


class MissingResultFile(OrionTPUError):
    """User script exited 0 but never reported results."""
