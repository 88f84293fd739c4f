"""Serve-tier autoscaling: sustained telemetry drives the elastic pilot.

The policy watches the two signals the serving loop already exports through
its :class:`~repro_torch.obs.MetricsRegistry` — queue depth (demand the
current slots cannot absorb) and slot idleness (capacity nobody is using) —
and turns SUSTAINED pressure into the elastic pool's operations:
``inject_grow`` / ``inject_retire`` on an in-process executor (the process
executor's ``add_worker`` / ``retire_worker`` are a later slice).  Transient
spikes are ignored by construction: a condition must hold continuously for
``sustain_s`` before an action fires, and actions are separated by
``cooldown_s`` so a grow gets to take effect before the next decision.

Thresholds come from the constructor or the ``REPRO_SERVE_*`` env knobs
(documented in docs/OPERATIONS.md):

* ``REPRO_SERVE_QUEUE_HIGH``  — queue depth above which the tier is
  considered backlogged (default 4);
* ``REPRO_SERVE_IDLE_FRAC``   — active-slot fraction below which (with an
  empty queue) the tier is considered idle (default 0.25);
* ``REPRO_SERVE_SUSTAIN_S``   — how long a condition must hold (default 2.0);
* ``REPRO_SERVE_COOLDOWN_S``  — minimum gap between actions (default 5.0).

The policy is deliberately executor-agnostic: it calls ``grow()`` /
``retire()`` callables and counts workers itself, so the same object is unit
testable with a fake clock and drives a real pilot unchanged.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass
class AutoscaleConfig:
    queue_high: int = 4
    idle_frac: float = 0.25
    sustain_s: float = 2.0
    cooldown_s: float = 5.0
    min_workers: int = 1
    max_workers: int = 4

    @classmethod
    def from_env(cls, **overrides) -> "AutoscaleConfig":
        kw = dict(
            queue_high=int(_env_float("REPRO_SERVE_QUEUE_HIGH", 4)),
            idle_frac=_env_float("REPRO_SERVE_IDLE_FRAC", 0.25),
            sustain_s=_env_float("REPRO_SERVE_SUSTAIN_S", 2.0),
            cooldown_s=_env_float("REPRO_SERVE_COOLDOWN_S", 5.0))
        kw.update(overrides)
        return cls(**kw)


class ServeAutoscaler:
    """Sustained-pressure hysteresis over (queue depth, slot idleness).

    ``observe`` is called with the current gauges; it returns ``"grow"`` /
    ``"retire"`` when it fired (after invoking the callback) or None.  The
    grow condition is a backlog (`queue_depth > queue_high`) sustained for
    ``sustain_s``; the retire condition is an EMPTY queue with at most
    ``idle_frac * max_slots`` slots active, sustained the same way.  A
    failing callback (e.g. ``add_worker`` on a pool already at its host's
    capacity) is swallowed: autoscaling is advisory, serving must not die
    because scaling did.
    """

    def __init__(self, grow: Callable[[], object],
                 retire: Callable[[], object],
                 config: Optional[AutoscaleConfig] = None,
                 workers: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = config or AutoscaleConfig.from_env()
        self._grow = grow
        self._retire = retire
        self.workers = workers
        self._clock = clock
        self._since: Optional[float] = None    # condition onset time
        self._cond: Optional[str] = None       # which condition is running
        self._last_action: float = -float("inf")
        self.actions: list[tuple[float, str]] = []

    def observe(self, queue_depth: int, slots_active: int,
                max_slots: int) -> Optional[str]:
        now = self._clock()
        if queue_depth > self.cfg.queue_high:
            cond = "grow"
        elif queue_depth == 0 and \
                slots_active <= self.cfg.idle_frac * max_slots:
            cond = "retire"
        else:
            cond = None
        if cond != self._cond:
            self._cond, self._since = cond, now
        if cond is None or now - self._since < self.cfg.sustain_s:
            return None
        if now - self._last_action < self.cfg.cooldown_s:
            return None
        if cond == "grow" and self.workers >= self.cfg.max_workers:
            return None
        if cond == "retire" and self.workers <= self.cfg.min_workers:
            return None
        try:
            (self._grow if cond == "grow" else self._retire)()
        except Exception:  # noqa: BLE001 — advisory: serving outlives scaling
            return None
        self.workers += 1 if cond == "grow" else -1
        self._last_action = now
        self._since = now   # re-arm: the condition must sustain again
        self.actions.append((now, cond))
        return cond
