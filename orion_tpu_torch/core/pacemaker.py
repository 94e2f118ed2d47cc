"""Heartbeat thread for running trials (port of ``orion_tpu/core/pacemaker.py``).

Capability parity: reference `src/orion/core/worker/trial_pacemaker.py` —
a daemon thread bumping the trial's heartbeat every `wait_time` seconds while
it stays reserved; stops itself when the trial reaches a stopped status or
the update fails (meaning another actor transitioned it).

Failure accounting (robustness subsystem, docs/robustness.md): the storage
write itself already rides the unified retry policy inside
``DocumentStorage.update_heartbeat``, so an exception reaching this thread
means a whole policy's worth of backoff was exhausted.  Each such beat
books a ``pacemaker.beats_failed`` counter tick, and after
``max_failed_beats`` CONSECUTIVE failures the cause is logged loudly (and
re-logged every further ``max_failed_beats`` beats) — a silently dead
heartbeat is exactly how a live trial gets swept as lost and re-executed
by another worker.  The thread keeps beating regardless: the next
successful write is what saves the trial.
"""

import logging
import os
import threading
import time

from orion_tpu_torch.telemetry import TELEMETRY
from orion_tpu_torch.utils.exceptions import FailedUpdate

log = logging.getLogger(__name__)

DEFAULT_WAIT_TIME = 60.0

#: Consecutive failed beats before the pacemaker starts warning (env knob
#: ORION_TPU_PACEMAKER_MAX_FAILED_BEATS, or the constructor parameter).
DEFAULT_MAX_FAILED_BEATS = 3


class TrialPacemaker(threading.Thread):
    def __init__(self, storage, trial, wait_time=DEFAULT_WAIT_TIME,
                 max_failed_beats=None):
        super().__init__(daemon=True)
        self.storage = storage
        self.trial = trial
        self.wait_time = wait_time
        if max_failed_beats is None:
            try:
                max_failed_beats = int(
                    os.environ.get("ORION_TPU_PACEMAKER_MAX_FAILED_BEATS", "")
                    or DEFAULT_MAX_FAILED_BEATS
                )
            except ValueError:
                max_failed_beats = DEFAULT_MAX_FAILED_BEATS
        self.max_failed_beats = max(1, int(max_failed_beats))
        self.consecutive_failures = 0
        self._stop_event = threading.Event()

    def stop(self):
        self._stop_event.set()

    def run(self):
        beat_due = time.perf_counter() + self.wait_time
        while not self._stop_event.wait(self.wait_time):
            # Heartbeat lag: how far past the scheduled beat this one fires
            # (event-wait jitter + the PREVIOUS beat's storage-write time —
            # beat_due is re-anchored at wake, before this beat's write, so
            # a slow/flapping storage backend shows up in the next wake's
            # lag instead of being absorbed).  A lag approaching the
            # lost-trial sweep threshold means live trials are at risk of
            # being recovered as lost — exported as a gauge so the merged
            # metrics surface it per worker fleet.
            now = time.perf_counter()
            TELEMETRY.set_gauge(
                "pacemaker.heartbeat_lag_s", max(0.0, now - beat_due)
            )
            beat_due = now + self.wait_time
            try:
                self.storage.update_heartbeat(self.trial)
                self.consecutive_failures = 0
            except FailedUpdate:
                break  # trial no longer reserved — our work here is done
            except Exception as exc:
                # The storage layer's retry policy already backed off and
                # gave up; swallow the beat but NEVER silently — count it,
                # and warn once per max_failed_beats streak with the cause
                # so a dying heartbeat is visible before the lost-trial
                # sweep reclaims a live trial.
                self.consecutive_failures += 1
                TELEMETRY.count("pacemaker.beats_failed")
                if self.consecutive_failures % self.max_failed_beats == 0:
                    log.warning(
                        "heartbeat for trial %s has failed %d consecutive "
                        "time(s) (latest cause: %s); the trial will be swept "
                        "as lost if this persists past the experiment "
                        "heartbeat window",
                        self.trial.id,
                        self.consecutive_failures,
                        exc,
                    )
                continue
