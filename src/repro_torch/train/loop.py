"""Fault-tolerant training loop, the port of ``repro.train.loop``.

Wires the pieces: the counted data stream (restart = replay), the train
step, async atomic checkpoints, and straggler detection.

  * **Restart**: :meth:`TrainLoop.try_restore` restores the newest
    checkpoint (params + optimizer state + step) and the loop resumes the
    stream at that step — a batch is a pure function of (seed, step), so a
    restarted run replays the uninterrupted one.
  * **Checkpoint cadence**: every ``ckpt_every`` steps, async and atomic;
    the loop waits for the device-to-host copy only, not the disk.
  * **Straggler mitigation**: an EMA of the per-step wall time; a step
    slower than ``straggler_factor`` × the EMA is logged, counted and
    handed to the ``on_straggler`` hook.
  * **NaN guard**: the step keeps the last good params for a non-finite
    loss (inside the step); here the skip is counted and logged, and the
    step is left out of ``history``.

The step's wall time runs from the call to the loss read on the host (one
host sync a step, as the reference's ``float(metrics["loss"])``).

Over a mesh (``layout``, a ``dist.sharding.TrainLayout``; the step from
``make_train_step(..., rules=)``) every rank runs the loop: checkpoints
hold the whole tree (gathered, written by rank 0), a restore narrows it
to the rank's blocks, a step's wall time is the slowest rank's (so the
straggler counts agree), the NaN skips agree because the step's loss is
the global one, and only rank 0 logs.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.dist.spmd import rank, world_max

__all__ = ["LoopConfig", "LoopState", "TrainLoop"]


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 200
    ckpt_keep: int = 3
    log_every: int = 20
    straggler_factor: float = 3.0
    straggler_warmup: int = 10         # steps before the EMA is trusted
    ema_decay: float = 0.9


@dataclass
class LoopState:
    step: int = 0
    ema_step_time: float = 0.0
    straggler_count: int = 0
    nan_skip_count: int = 0
    history: list = field(default_factory=list)


class TrainLoop:
    def __init__(self, cfg: LoopConfig, train_step, stream, params,
                 opt_state,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 log: Callable[[str], None] = print,
                 batch_transform: Optional[Callable] = None,
                 layout=None):
        self.cfg = cfg
        self.train_step = train_step
        self.stream = stream
        self.params = params
        self.opt_state = opt_state
        self.on_straggler = on_straggler
        self.batch_transform = batch_transform
        self.layout = layout
        self.mesh = None if layout is None else layout.mesh
        self.log = log if rank() == 0 or layout is None \
            else (lambda s: None)
        self.state = LoopState()
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep,
                                       layout=layout)
                     if cfg.ckpt_dir else None)

    # -------------------------------------------------------- restart
    def try_restore(self) -> bool:
        """Resume from the newest checkpoint if one exists."""
        if self.ckpt is None:
            return False
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return False
        tree = {"params": self.params, "opt": self.opt_state}
        restored = restore(self.cfg.ckpt_dir, step, tree, self.layout)
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.state.step = step
        self.log(f"[loop] restored checkpoint step={step}")
        return True

    # -------------------------------------------------------- run
    def run(self) -> LoopState:
        cfg = self.cfg
        st = self.state
        while st.step < cfg.total_steps:
            batch = self.stream.batch(st.step)
            if self.batch_transform is not None:
                batch = self.batch_transform(batch)
            t0 = time.perf_counter()
            new_params, new_opt, metrics = self.train_step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if self.mesh is not None:
                dt = world_max(dt, self.mesh, "loop step wall")

            # the step already kept the last good params for a non-finite
            # loss; here the skip is only counted and logged
            self.params, self.opt_state = new_params, new_opt
            if not math.isfinite(loss) or int(metrics.get("skipped", 0)):
                st.nan_skip_count += 1
                self.log(f"[loop] step {st.step}: non-finite loss, "
                         f"update skipped in-step")
            else:
                st.history.append((st.step, loss))

            # straggler detection on the wall-time EMA
            if st.step >= cfg.straggler_warmup and st.ema_step_time > 0 \
                    and dt > cfg.straggler_factor * st.ema_step_time:
                st.straggler_count += 1
                if self.on_straggler is not None:
                    self.on_straggler(st.step, dt)
                self.log(f"[loop] step {st.step}: straggler "
                         f"({dt*1e3:.1f} ms vs EMA {st.ema_step_time*1e3:.1f})")
            st.ema_step_time = (cfg.ema_decay * st.ema_step_time
                                + (1 - cfg.ema_decay) * dt
                                if st.ema_step_time else dt)

            st.step += 1
            if st.step % cfg.log_every == 0:
                self.log(f"[loop] step {st.step}: loss={loss:.4f} "
                         f"lr={float(metrics.get('lr', 0)):.2e} "
                         f"gnorm={float(metrics.get('grad_norm', 0)):.3f} "
                         f"{dt*1e3:.0f} ms")
            if self.ckpt is not None and st.step % cfg.ckpt_every == 0:
                self.ckpt.save(st.step,
                               {"params": self.params, "opt": self.opt_state})
        if self.ckpt is not None:
            self.ckpt.save(st.step,
                           {"params": self.params, "opt": self.opt_state})
            self.ckpt.wait()
        return st
