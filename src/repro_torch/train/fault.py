"""Fault tolerance: preemption handling, straggler detection, restart policy
(port of ``repro/train/fault.py``).

One host, so multi-host failures are simulated, but the control logic is
what a large job needs, and the tests drive it through failure scenarios:

* ``PreemptionGuard`` turns SIGTERM (a preemption notice) into a
  "checkpoint now, then exit cleanly" request the train loop polls;
* ``StragglerWatchdog`` keeps a per-step wall-time EWMA; a step slower than
  ``threshold x`` the EWMA is a straggler incident, and ``trip_limit``
  consecutive incidents escalate (on a real cluster: checkpoint and restart
  without the slow host; here: the callback);
* ``RestartPolicy`` gives a bounded exponential backoff with a failure
  budget (it gives up after ``max_restarts`` within ``window_s``);
* ``run_resumable`` is the glue: resume from the latest checkpoint, step
  until done, checkpoint every N steps and on preemption.

The reference's ``shardings`` argument (placing restored leaves on a mesh)
has no counterpart: ``init_state()`` gives the devices.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

from repro_torch.train import checkpoint as ckpt_lib


class PreemptionGuard:
    """SIGTERM-safe: flips a flag the loop polls; a second signal
    raises."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._old = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        if self._requested:
            raise KeyboardInterrupt("second preemption signal")
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def request(self):  # for tests / manual triggering
        self._requested = True


@dataclasses.dataclass
class StragglerWatchdog:
    threshold: float = 2.0          # step slower than 2x EWMA = incident
    trip_limit: int = 3             # consecutive incidents before escalation
    alpha: float = 0.2              # EWMA smoothing
    warmup_steps: int = 3

    _ewma: float = 0.0
    _steps: int = 0
    _consecutive: int = 0
    incidents: int = 0
    escalations: int = 0

    def observe(self, step_time_s: float,
                on_escalate: Callable[[], None] | None = None) -> bool:
        """Returns True if this step was a straggler incident."""
        self._steps += 1
        if self._steps <= self.warmup_steps:
            self._ewma = (step_time_s if self._ewma == 0 else
                          (1 - self.alpha) * self._ewma + self.alpha * step_time_s)
            return False
        is_incident = step_time_s > self.threshold * self._ewma
        if is_incident:
            self.incidents += 1
            self._consecutive += 1
            if self._consecutive >= self.trip_limit:
                self.escalations += 1
                self._consecutive = 0
                if on_escalate:
                    on_escalate()
        else:
            self._consecutive = 0
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * step_time_s
        return is_incident


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    window_s: float = 3600.0
    base_backoff_s: float = 1.0
    max_backoff_s: float = 60.0

    _failures: list = dataclasses.field(default_factory=list)

    def record_failure(self, now: float | None = None) -> float | None:
        """Returns backoff seconds, or None if the budget is exhausted."""
        now = time.monotonic() if now is None else now
        self._failures = [t for t in self._failures if now - t < self.window_s]
        self._failures.append(now)
        if len(self._failures) > self.max_restarts:
            return None
        return min(self.base_backoff_s * 2 ** (len(self._failures) - 1),
                   self.max_backoff_s)


def run_resumable(
    *,
    ckpt_dir: str,
    total_steps: int,
    init_state: Callable[[], dict],
    step_fn: Callable[[dict, int], tuple[dict, dict]],
    ckpt_every: int = 50,
    guard: PreemptionGuard | None = None,
    watchdog: StragglerWatchdog | None = None,
    on_metrics: Callable[[int, dict], None] | None = None,
) -> tuple[dict, int, bool]:
    """Resume-from-latest training driver.

    Returns (state, last_step, completed).  ``completed`` is False when a
    preemption checkpoint-and-exit happened.
    """
    start = ckpt_lib.latest_step(ckpt_dir)
    if start is not None:
        state, _extra = ckpt_lib.restore(ckpt_dir, start, init_state())
        step0 = start
    else:
        state = init_state()
        step0 = 0

    step = step0
    for step in range(step0, total_steps):
        t0 = time.monotonic()
        state, metrics = step_fn(state, step)
        dt = time.monotonic() - t0
        if watchdog is not None:
            watchdog.observe(dt)
        if on_metrics:
            on_metrics(step, metrics)
        done = step + 1
        if guard is not None and guard.preempted:
            ckpt_lib.save(ckpt_dir, done, state)
            return state, done, False
        if done % ckpt_every == 0 or done == total_steps:
            ckpt_lib.save(ckpt_dir, done, state)
    return state, step + 1, True
