"""Production train loop: checkpoint/restart, straggler watchdog, elastic
re-planning hooks, host-prefetched data — ``repro/train/loop.py``
restated.

The loop is deliberately host-side simple — all heavy lifting is in the
train_step — and is exercised end-to-end on CPU by the tests (small models,
few steps).  A step's time ends when its loss has been read back to the
host (where the JAX loop calls ``block_until_ready``); the state is
restored onto the devices of the state the loop was given.

The train step updates the state in place (AdamW writes each leaf as it
goes), so a step that raises may leave it half updated.  The JAX loop
rebinds its state only after a step returns; here the last save on the way
out is skipped instead when a step did not complete, and the newest
checkpoint stays the last one written from a whole step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.replicate import plan_cluster
from repro_torch.data.pipeline import SyntheticTokens, make_batch_iterator


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    # straggler watchdog: a step slower than ema * threshold is an event
    straggler_threshold: float = 3.0
    straggler_ema: float = 0.9
    # elastic: callback invoked on straggler/failure events
    on_straggler: Optional[Callable[[int, float, float], None]] = None


class TrainLoop:
    def __init__(self, train_step, state, dataset: SyntheticTokens,
                 cfg: TrainLoopConfig,
                 extra_batch: Optional[Dict[str, Any]] = None):
        self.train_step = train_step
        self.state = state
        self.dataset = dataset
        self.cfg = cfg
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir)
                     if cfg.checkpoint_dir else None)
        self.start_step = 0
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_events: List[Dict[str, float]] = []
        self._extra = extra_batch

    # ------------------------------------------------------------- restart
    def try_restore(self) -> bool:
        if self.ckpt is None:
            return False
        res = self.ckpt.restore_latest(self.state)
        if res is None:
            return False
        step, self.state = res
        self.start_step = step
        return True

    # ---------------------------------------------------------------- run
    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        it = make_batch_iterator(self.dataset, start_step=self.start_step,
                                 extra=self._extra)
        ema = None
        step = self.start_step
        in_step = False         # a step began and has not yet completed
        try:
            while step < cfg.total_steps:
                step, batch = next(it)
                if step >= cfg.total_steps:
                    break
                t0 = time.perf_counter()
                in_step = True
                self.state, metrics = self.train_step(self.state, batch)
                loss = float(metrics["loss"])         # waits for the step
                in_step = False
                dt = time.perf_counter() - t0

                # straggler watchdog (step-time EMA)
                if ema is not None and dt > cfg.straggler_threshold * ema:
                    ev = {"step": step, "dt": dt, "ema": ema}
                    self.straggler_events.append(ev)
                    if cfg.on_straggler:
                        cfg.on_straggler(step, dt, ema)
                ema = dt if ema is None else \
                    cfg.straggler_ema * ema + (1 - cfg.straggler_ema) * dt

                if step % cfg.log_every == 0 or step == cfg.total_steps - 1:
                    self.metrics_log.append(
                        {"step": step,
                         "loss": loss,
                         "grad_norm": float(metrics["grad_norm"]),
                         "dt_s": dt})
                if self.ckpt and step > 0 and \
                        step % cfg.checkpoint_every == 0:
                    self.ckpt.save(step, self.state)
                step += 1
        finally:
            it.close()
            if self.ckpt and not in_step:
                self.ckpt.save(step, self.state, blocking=True)
            elif self.ckpt:
                self.ckpt.wait()        # the periodic writes still finish
        return {"final_step": step, "metrics": self.metrics_log,
                "stragglers": self.straggler_events}


def replan_after_failure(n_alive: int, model_shards: int):
    """Elastic hook: derive the new mesh from the surviving device count —
    the paper's resource-aware replication applied at cluster scale."""
    return plan_cluster(n_alive, model_shards)
