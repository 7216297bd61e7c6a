"""Fault tolerance and straggler handling for the training runtime (the
port of ``repro.runtime.fault_tolerance``: host code, the same
semantics; a mesh is ``launch.mesh.Mesh`` and a restored state is placed
by the caller's ``reshard``).

Production model (1000+ nodes):
  * every step runs under a Watchdog deadline; a blown deadline marks the
    step failed (hung collective / dead host);
  * failures trigger restore-from-latest-checkpoint; if the device pool
    shrank, the supervisor rebuilds a smaller mesh (drop a pod / shrink the
    data axis) and re-places the restored state with the new shardings —
    elastic rescale, enabled by the restore onto any device in
    repro_torch.checkpoint;
  * straggler mitigation: per-step wall times feed an EWMA; a step slower
    than ``straggler_factor`` x the EWMA increments a strike counter, and
    ``on_straggler`` (deployment hook: re-route traffic, swap the node,
    re-shard) fires after ``max_strikes`` — on TPU pods the SPMD program
    advances in lockstep (as do data-parallel ranks), so persistent
    per-step slowness IS the straggler signal;
  * deterministic data (counter-mode pipeline) + step-indexed checkpoints
    make recovery exactly-once: no batch is skipped or double-counted.

Everything is testable on CPU: FailureInjector raises at configured steps,
and the supervisor's recovery path (restore -> remesh -> continue) runs in
tests/test_torch_substrate.py.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable

from repro_torch.checkpoint import Checkpointer


class DeadlineExceeded(RuntimeError):
    pass


class Watchdog:
    """SIGALRM-based step deadline (no-op when deadline <= 0)."""

    def __init__(self, deadline_s: float = 0.0):
        self.deadline_s = deadline_s

    def __enter__(self):
        if self.deadline_s > 0:
            def _handler(signum, frame):
                raise DeadlineExceeded(
                    f"step exceeded {self.deadline_s}s deadline"
                )

            self._old = signal.signal(signal.SIGALRM, _handler)
            signal.setitimer(signal.ITIMER_REAL, self.deadline_s)
        return self

    def __exit__(self, *exc):
        if self.deadline_s > 0:
            signal.setitimer(signal.ITIMER_REAL, 0.0)
            signal.signal(signal.SIGALRM, self._old)
        return False


class FailureInjector:
    """Deterministic fault injection for recovery tests."""

    def __init__(self, fail_steps: tuple[int, ...] = (), exc=RuntimeError):
        self.fail_steps = set(fail_steps)
        self.exc = exc
        self.fired: list[int] = []

    def check(self, step: int):
        if step in self.fail_steps:
            self.fail_steps.discard(step)
            self.fired.append(step)
            raise self.exc(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    max_strikes: int = 3
    alpha: float = 0.2
    _ewma: float = 0.0
    strikes: int = 0
    events: int = 0

    def observe(self, step_seconds: float) -> bool:
        """Returns True when the straggler hook should fire."""
        if self._ewma == 0.0:
            self._ewma = step_seconds
            return False
        slow = step_seconds > self.factor * self._ewma
        self._ewma = (1 - self.alpha) * self._ewma + self.alpha * step_seconds
        if slow:
            self.strikes += 1
            if self.strikes >= self.max_strikes:
                self.strikes = 0
                self.events += 1
                return True
        else:
            self.strikes = 0
        return False


class TrainSupervisor:
    """Checkpoint/restart + elastic-remesh training loop supervisor.

    Parameters are callables so the supervisor is host-framework agnostic:
      build(mesh)  -> (step_fn, state)    — compile for a mesh, fresh state
      reshard(state, mesh) -> state       — re-place restored state
      meshes: list of fallback meshes, largest first (e.g. 2 pods, 1 pod)
    """

    def __init__(
        self,
        build: Callable[[Any], tuple[Callable, Any]],
        reshard: Callable[[Any, Any], Any],
        meshes: list,
        ckpt: Checkpointer,
        *,
        step_deadline_s: float = 0.0,
        max_restarts: int = 3,
        straggler: StragglerMonitor | None = None,
        injector: FailureInjector | None = None,
    ):
        self.build = build
        self.reshard = reshard
        self.meshes = meshes
        self.ckpt = ckpt
        self.step_deadline_s = step_deadline_s
        self.max_restarts = max_restarts
        self.straggler = straggler or StragglerMonitor()
        self.injector = injector
        self.restarts = 0
        self.straggler_events = 0
        self.log: list[str] = []

    def run(self, num_steps: int, batch_fn) -> Any:
        mesh_idx = 0
        step_fn, state = self.build(self.meshes[mesh_idx])
        # resume if a committed checkpoint exists
        found = self.ckpt.restore_latest(state)
        step0 = 0
        if found[0] is not None:
            step0, restored = found
            state = self.reshard(restored, self.meshes[mesh_idx])
            self.log.append(f"resumed from step {step0}")
            step0 += 1

        step = step0
        while step < num_steps:
            try:
                if self.injector is not None:
                    self.injector.check(step)
                t0 = time.monotonic()
                with Watchdog(self.step_deadline_s):
                    state, metrics = step_fn(state, batch_fn(step))
                dt = time.monotonic() - t0
                if self.straggler.observe(dt):
                    self.straggler_events += 1
                    self.log.append(f"straggler event at step {step}")
                self.ckpt.maybe_save(step, state)
                step += 1
            except (DeadlineExceeded, RuntimeError) as e:
                self.restarts += 1
                self.log.append(f"failure at step {step}: {e}")
                if self.restarts > self.max_restarts:
                    raise
                # device pool may have shrunk: fall back to the next mesh
                if self.restarts >= 2 and mesh_idx + 1 < len(self.meshes):
                    mesh_idx += 1
                    self.log.append(
                        f"elastic rescale -> mesh {mesh_idx} "
                        f"({self.meshes[mesh_idx].size} devices)"
                    )
                step_fn, state = self.build(self.meshes[mesh_idx])
                found = self.ckpt.restore_latest(state)
                if found[0] is not None:
                    ck_step, restored = found
                    state = self.reshard(restored, self.meshes[mesh_idx])
                    step = ck_step + 1
                else:
                    step = 0
        self.ckpt.wait()
        return state
