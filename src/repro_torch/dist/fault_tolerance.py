"""Fault-tolerant training: straggler detection and the checkpoint/restart
loop (PyTorch counterpart of repro.dist.fault_tolerance).

`TrainSupervisor` wraps a step function with save-every-k checkpointing and
restart-from-latest recovery: a step that raises is logged, the state is
restored from the newest checkpoint (or, with none, from the state the run
started with), and the steps since are replayed. `StragglerMonitor` flags
steps whose wall time exceeds `threshold x` the running EMA.

The port's state is updated in place (the LSM index by `dedup_batch`, the
parameters and moments by AdamW), so the state the run started with is kept
by value: every tensor copied to the host when the run starts, and copied
back onto its device at each restart from it.
"""

from __future__ import annotations

import time

import torch

from repro_torch.checkpoint.checkpoint import TensorSpec, tree_map


class StragglerMonitor:
    """EMA-based step-time watchdog.

    observe(t) returns True (and counts the step) iff t exceeds
    `threshold * ema`. Flagged steps do not update the EMA: one straggler
    must not drag the baseline up and mask the next one.
    """

    def __init__(self, alpha: float = 0.1, threshold: float = 3.0):
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.ema: float | None = None
        self.flagged_steps = 0

    def observe(self, step_time: float) -> bool:
        t = float(step_time)
        if self.ema is None:
            self.ema = t
            return False
        if t > self.threshold * self.ema:
            self.flagged_steps += 1
            return True
        self.ema = self.alpha * t + (1.0 - self.alpha) * self.ema
        return False


def _to_host(leaf):
    return leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor) else leaf


def _onto(host, spec):
    return host.to(spec.device, copy=True) if isinstance(spec, TensorSpec) else host


class TrainSupervisor:
    """Supervised training loop: run `num_steps` steps with checkpoint/restart.

    step_fn(state, step) -> state may raise (node failure, preemption); the
    supervisor restores the latest checkpoint and replays from there, up to
    `max_restarts` times. Steps are replayed against the restored state, so a
    deterministic step_fn yields the same final state as a failure-free run.
    """

    def __init__(self, checkpoint_manager, save_every: int = 1, max_restarts: int = 3,
                 monitor: StragglerMonitor | None = None):
        self.cm = checkpoint_manager
        self.save_every = int(save_every)
        self.max_restarts = int(max_restarts)
        self.monitor = monitor
        self.restarts = 0
        self.log: list[str] = []

    @staticmethod
    def _spec(state):
        """Shapes, dtypes and devices of the state's tensors (no data is copied)."""
        return tree_map(TensorSpec.of, state)

    def run(self, state, step_fn, num_steps: int, start_step: int = 0):
        """Returns (final_state, completed_steps)."""
        spec = self._spec(state)
        initial = tree_map(_to_host, state)  # restart-from-zero copy, by value
        step = start_step
        while step < num_steps:
            try:
                t0 = time.perf_counter()
                state = step_fn(state, step)
                if self.monitor is not None and self.monitor.observe(time.perf_counter() - t0):
                    self.log.append(f"STRAGGLER at step {step}")
                step += 1
                if step % self.save_every == 0:
                    self.cm.save(step, state)
            except Exception as e:  # noqa: BLE001 — any step failure is recoverable
                self.log.append(f"FAILURE at step {step}: {e!r}")
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    self.log.append("restart budget exhausted; re-raising")
                    raise
                if hasattr(self.cm, "wait"):
                    self.cm.wait()  # an async save in flight lands first: restart from the newest
                latest = self.cm.latest_step()
                if latest is None:
                    state, step = tree_map(_onto, initial, spec), start_step
                    self.log.append("RESTART from initial state (no checkpoint)")
                else:
                    state = self.cm.restore(latest, spec)
                    step = latest
                    self.log.append(f"RESTART from checkpoint step {latest}")
        if hasattr(self.cm, "wait"):
            self.cm.wait()  # drain any in-flight async save before reporting done
        return state, step
