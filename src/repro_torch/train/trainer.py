"""Training loop with the fault-tolerance hooks (counterpart of
``repro/train/trainer.py``):

 - CheckpointManager (atomic save-every-N, keep-k, resume-from-latest),
 - deterministic (seed, step)-keyed data → exact replay after restart,
 - straggler watchdog: per-step wall times tracked; steps slower than
   ``factor`` × running median are logged.

The loss is read back to the host once a step, as the reference reads it,
so each step's wall time covers its device work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.data.loader import batches
from repro_torch.device import resolve_device
from repro_torch.train.steps import init_train_state, make_train_step


@dataclass
class StragglerWatchdog:
    factor: float = 3.0
    times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        med = float(np.median(self.times[-64:]))
        slow = len(self.times) > 8 and dt > self.factor * med
        if slow:
            self.flagged.append((step, dt, med))
        return slow

    @property
    def p50(self):
        return float(np.median(self.times)) if self.times else 0.0


def train(cfg, steps: int = 100, global_batch: int = 8, seq_len: int = 128,
          lr: float = 3e-4, seed: int = 0, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, microbatches: int = 1,
          log: Callable[[str], None] = print, hook: Optional[Callable] = None,
          device="cuda"):
    """Single-host training driver on ``device``; resumes from the latest
    checkpoint under ``ckpt_dir``.  Returns ``(state, losses, watchdog)``."""
    dev = resolve_device(device)
    state = init_train_state(cfg, seed, device=dev)
    step_fn = make_train_step(cfg, base_lr=lr, total_steps=steps,
                              microbatches=microbatches, remat="none")
    start = 0
    mgr = CheckpointManager(ckpt_dir, every=ckpt_every) if ckpt_dir else None
    if mgr is not None:
        got_step, got = mgr.restore_latest(state, device=dev)
        if got is not None:
            state, start = got, got_step
            log(f"[resume] from step {start}")

    watchdog = StragglerWatchdog()
    history = []
    it = batches(cfg, global_batch, seq_len, seed=seed, start_step=start, device=dev)
    for step, batch in it:
        if step >= steps:
            break
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        slow = watchdog.observe(step, dt)
        history.append(loss)
        if slow:
            log(f"[straggler] step {step}: {dt:.3f}s > {watchdog.factor}x median")
        if step % 20 == 0:
            log(f"step {step}: loss={loss:.4f} ({dt:.2f}s)")
        if mgr is not None:
            mgr.maybe_save(step + 1, state)
        if hook is not None:
            hook(step, state)
    return state, history, watchdog
