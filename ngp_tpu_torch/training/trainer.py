"""Training loop, logging and checkpoints (``ngp_tpu/training/trainer.py``).

The subclass sets ``self.model`` and implements ``train_step(batch,
draws=None) -> metrics`` (a dict of device scalars), which runs the
forward, ``loss.backward()`` and ``_apply_gradients``. Scalars are
fetched to the host every ``log_every`` steps, so the loop does not
wait for the device on every step.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterable, Optional

import torch

from ngp_tpu_torch.training import checkpoints as ckpt_lib
from ngp_tpu_torch.training.state import EMA, make_optimizer


class Trainer:
    def __init__(self, name: str, workspace: str = "workspace", lr: float = 1e-3,
                 lr_decay_target: float = 0.1, max_steps: int = 30000,
                 ema_decay: Optional[float] = 0.95, max_keep_ckpt: int = 2,
                 eval_interval: int = 1, log_every: int = 100):
        self.name = name
        self.workspace = workspace
        self.lr = lr
        self.lr_decay_target = lr_decay_target
        self.max_steps = max_steps
        self.ema_decay = ema_decay
        self.max_keep_ckpt = max_keep_ckpt
        self.eval_interval = eval_interval  # epochs between validation runs
        self.log_every = log_every
        self.epoch = 0
        self.global_step = 0
        self.stats = {"loss": [], "best_loss": None}
        # at most one numbered checkpoint per interval (besides the last)
        self.ckpt_min_interval_s = 120.0
        self._last_ckpt_time = 0.0
        self.model: Optional[torch.nn.Module] = None
        self.optimizer = None
        self.scheduler = None
        self.ema: Optional[EMA] = None

    # ---- subclass hooks --------------------------------------------------

    def on_step_begin(self):
        """Called before every train step (the grid trainer refreshes its
        occupancy grid here)."""

    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _aux_state(self) -> Dict[str, Any]:
        return {}

    def _load_aux_state(self, sd: Dict[str, Any]) -> None:
        pass

    # ---- lifecycle -------------------------------------------------------

    def ensure_initialized(self):
        """The optimizer, schedule and EMA shadow of ``self.model``."""
        if self.optimizer is None:
            self.optimizer, self.scheduler = make_optimizer(
                self.model.parameters(), self.lr, self.max_steps, self.lr_decay_target
            )
            if self.ema_decay is not None:
                self.ema = EMA(self.model, self.ema_decay)

    def _apply_gradients(self):
        """Adam step, schedule step, then the EMA of the new weights."""
        self.optimizer.step()
        self.scheduler.step()
        if self.ema is not None:
            self.ema.update()

    def step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """One train step with its bookkeeping: ``on_step_begin`` (the
        refresh cadence keys off ``global_step``), the step, the count.
        Returns device scalars; reading them waits for the device."""
        self.ensure_initialized()
        self.on_step_begin()
        metrics = self.train_step(batch, draws)
        self.global_step += 1
        return metrics

    def train_one_epoch(self, loader: Iterable):
        t0 = time.perf_counter()
        pending = []
        n_steps = 0
        for batch in loader:
            metrics = self.step(batch)
            n_steps += 1
            pending.append((self.global_step, metrics))
            if len(pending) >= self.log_every:
                self._flush_metrics(pending)
                pending = []
        self._flush_metrics(pending)
        dt = time.perf_counter() - t0
        self.log(f"epoch {self.epoch}: {n_steps} steps in {dt:.2f}s "
                 f"({n_steps / max(dt, 1e-9):.1f} it/s)")

    def _flush_metrics(self, pending):
        if not pending:
            return
        step, metrics = pending[-1]
        host = {k: float(v) for k, v in metrics.items()}
        self.stats["loss"].append(host.get("loss", 0.0))
        self.log(f"step {step}: " + " ".join(f"{k}={v:.6f}" for k, v in host.items()))
        # turbo budget overflow: a calibrated estimate of the dropped
        # share of samples; a healthy converged scene reads about 0.1,
        # an under-budgeted one 0.4-0.5 (the JAX trainer's threshold)
        if host.get("turbo_overflow", 0.0) > 0.3 and step > 256:
            self.log(
                f"[warn] turbo sample-budget overflow at {host['turbo_overflow']:.1%}: "
                f"raise coarse_candidates/crossing_slots/compact_mean_samples or the "
                f"scene loses far samples (watch eval PSNR)"
            )

    def log(self, msg: str):
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        os.makedirs(self.workspace, exist_ok=True)
        with open(os.path.join(self.workspace, f"log_{self.name}.txt"), "a") as f:
            f.write(line + "\n")

    # ---- checkpoints -----------------------------------------------------

    def _ckpt_state(self) -> Dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "ema": self.ema.state_dict() if self.ema is not None else None,
            "aux": self._aux_state(),
            "global_step": self.global_step,
            "best_loss": self.stats["best_loss"],
        }

    def save_checkpoint(self, best: bool = False) -> str:
        """A numbered checkpoint, or with ``best`` the best one, whose
        model weights are the EMA's."""
        self.ensure_initialized()
        state = self._ckpt_state()
        if best and self.ema is not None:
            state["model"] = dict(state["model"], **self.ema.state_dict())
        return ckpt_lib.save_checkpoint(self.workspace, self.name, state, epoch=self.epoch,
                                        max_keep=self.max_keep_ckpt, best=best)

    def load_checkpoint(self, path: Optional[str] = None) -> bool:
        self.ensure_initialized()
        if path is None:
            path = ckpt_lib.latest_checkpoint(self.workspace, self.name)
        if path is None or not os.path.exists(path):
            self.log("no checkpoint found, training from scratch")
            return False
        sd = ckpt_lib.load_checkpoint(path)
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        if self.ema is not None and sd["ema"] is not None:
            self.ema.load_state_dict(sd["ema"])
        self._load_aux_state(sd["aux"])
        self.global_step = sd["global_step"]
        self.epoch = sd["epoch"]
        self.stats["best_loss"] = sd["best_loss"]
        self.log(f"loaded checkpoint {path} (epoch {self.epoch})")
        return True
