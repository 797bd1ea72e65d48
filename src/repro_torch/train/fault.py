"""Fault tolerance (the port's counterpart of ``repro.train.fault``):
failure injection, restart from the newest checkpoint, a straggler
watchdog.  A real cluster's failure signal (a lost device, a missed
heartbeat) stands in as ``NodeFailure``, raised by a ``FailureInjector`` on
a schedule, so the restart logic runs end to end in one process.

Elasticity, as the reference's: a checkpoint holds whole leaves, and the
data is addressed by (step, shard), so a restart onto another mesh (another
data-axis size, or none) only places the leaves anew (the manager's
``mesh`` and ``placement``) and splits the batch by the new mesh.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

from .checkpoint import CheckpointManager, latest_step, restore_checkpoint

__all__ = ["NodeFailure", "FailureInjector", "StragglerPolicy", "ResilientLoop"]

log = logging.getLogger("repro_torch.fault")


class NodeFailure(RuntimeError):
    """Stands in for device loss or a heartbeat timeout on a real cluster."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for tests: fail once at each given step."""

    fail_at_steps: tuple = ()
    failures_per_step: int = 1
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise NodeFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class StragglerPolicy:
    """Step-time watchdog: a step longer than ``factor`` x the trailing
    median (of up to ``window`` steps, once there are 5) is slow; after
    ``tolerance`` consecutive slow steps ``observe`` asks for a rebalance
    (returns True, counted in ``rebalance_requests``)."""

    factor: float = 3.0
    tolerance: int = 3
    window: int = 20
    _times: list = dataclasses.field(default_factory=list)
    slow_steps: int = 0
    rebalance_requests: int = 0

    def observe(self, dt: float) -> bool:
        self._times.append(dt)
        self._times = self._times[-self.window:]
        if len(self._times) >= 5:
            med = sorted(self._times)[len(self._times) // 2]
            if dt > self.factor * med:
                self.slow_steps += 1
                if self.slow_steps >= self.tolerance:
                    self.slow_steps = 0
                    self.rebalance_requests += 1
                    return True
            else:
                self.slow_steps = 0
        return False


class ResilientLoop:
    """Runs a train loop body with checkpoint / restart semantics."""

    def __init__(self, ckpt: CheckpointManager, *, injector: Optional[FailureInjector] = None,
                 straggler: Optional[StragglerPolicy] = None, max_restarts: int = 10):
        self.ckpt = ckpt
        self.injector = injector
        self.straggler = straggler or StragglerPolicy()
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, state: Any, step_fn: Callable[[Any, int], Any], *, start_step: int, num_steps: int,
            restore_fn: Optional[Callable[[Any], Any]] = None):
        """step_fn(state, step) -> state, for steps [start_step, start_step +
        num_steps); a checkpoint after each step the manager's ``every``
        divides.  On ``NodeFailure``: restore the newest checkpoint and go on
        from its step; with nothing saved yet, replay from ``start_step``
        with the state as it stands (the reference's behaviour).  Returns
        (state, end step)."""
        step = start_step
        end = start_step + num_steps
        while step < end:
            try:
                t0 = time.monotonic()
                if self.injector:
                    self.injector.check(step)
                state = step_fn(state, step)
                self.straggler.observe(time.monotonic() - t0)
                step += 1
                self.ckpt.maybe_save(step, state)
            except NodeFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                log.warning("%s -- restarting from latest checkpoint", e)
                self.ckpt.wait()
                if latest_step(self.ckpt.directory) is None:
                    step = start_step  # nothing saved yet: replay from start
                    continue
                state, step = restore_checkpoint(self.ckpt.directory, state, mesh=self.ckpt.mesh,
                                                 placement=self.ckpt.placement)
                if restore_fn is not None:
                    state = restore_fn(state)
        self.ckpt.wait()
        return state, step
