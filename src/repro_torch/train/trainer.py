"""Training loop with the fault-tolerance substrate wired in:

- periodic and preemption-triggered checkpointing (atomic, async,
  retained; ``checkpoint.manager``, the JAX package's layout);
- restore on start (``maybe_restore``) into the model and optimizer state
  in place;
- straggler monitor: per-step wall-time EWMA + z-score; slow steps are
  logged and counted;
- loss / throughput metrics log (host-side JSONL).

The trainer holds the model (a ``Transformer``, updated in place by the
step) and the optimizer state; a checkpoint is {"params": the model's
tree in the JAX layout, "opt": the state}.
"""
from __future__ import annotations

import dataclasses
import json
import signal
import time

from repro_torch.checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    ckpt_keep: int = 3
    log_every: int = 10
    log_path: str | None = None
    straggler_z: float = 3.0
    straggler_ema: float = 0.9


class StragglerMonitor:
    def __init__(self, z: float, ema: float):
        self.z = z
        self.ema = ema
        self.mean = None
        self.var = 0.0
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        """True when dt is slow: beyond mean + z std and 1.5x the mean."""
        if self.mean is None:
            self.mean = dt
            return False
        slow = False
        std = max(self.var ** 0.5, 1e-6)
        if dt > self.mean + self.z * std and dt > 1.5 * self.mean:
            self.flagged += 1
            slow = True
        d = dt - self.mean
        self.mean += (1 - self.ema) * d
        self.var = self.ema * (self.var + (1 - self.ema) * d * d)
        return slow


def _tree(params):
    """A model's tree in the JAX layout; any other tree as given."""
    return params.tree() if hasattr(params, "tree") else params


class Trainer:
    def __init__(self, train_step, params, opt_state, loader,
                 config: TrainerConfig):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.loader = loader
        self.cfg = config
        self.ckpt = CheckpointManager(config.ckpt_dir, keep=config.ckpt_keep)
        self.monitor = StragglerMonitor(config.straggler_z,
                                        config.straggler_ema)
        self.step = 0
        self.history: list[dict] = []
        self._preempted = False
        self._saved_step = None
        try:
            signal.signal(signal.SIGTERM, self._on_preempt)
        except ValueError:
            pass  # not on the main thread

    def _on_preempt(self, *_):
        self._preempted = True

    # -- restart -------------------------------------------------------------
    def maybe_restore(self) -> bool:
        """Restore the latest checkpoint into the model and the optimizer
        state (in place); False when there is none."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        self.ckpt.restore(latest, {"params": _tree(self.params),
                                   "opt": self.opt_state})
        self.step = latest
        return True

    def _save(self, blocking=False):
        self.ckpt.save(self.step, {"params": _tree(self.params),
                                   "opt": self.opt_state},
                       blocking=blocking)
        self._saved_step = self.step

    # -- loop ----------------------------------------------------------------
    def run(self, steps: int | None = None):
        """Run ``steps`` steps (default total_steps), checkpointing every
        ckpt_every and at the end (the end's write blocks; where the last
        step's periodic save already holds it, the run waits for that
        write instead of writing the step again)."""
        target = self.step + (steps or self.cfg.total_steps)
        while self.step < target:
            batch = next(self.loader)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])          # waits for the device
            dt = time.perf_counter() - t0
            self.step += 1
            slow = self.monitor.observe(dt)
            rec = {"step": self.step, "loss": loss, "dt": dt, "slow": slow,
                   "grad_norm": float(metrics.get("grad_norm", 0.0))}
            self.history.append(rec)
            if self.cfg.log_path and self.step % self.cfg.log_every == 0:
                with open(self.cfg.log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if self.step % self.cfg.ckpt_every == 0:
                self._save()
            if self._preempted:
                self._save(blocking=True)
                raise SystemExit(f"preempted at step {self.step}; "
                                 "checkpoint written")
        if self._saved_step == self.step:
            self.ckpt.wait()
        else:
            self._save(blocking=True)
        return self.history
