"""Training loop, logging and checkpoints (``ngp_tpu/training/trainer.py``).

The subclass sets ``self.model`` and implements ``train_step(batch,
draws=None) -> metrics`` (a dict of device scalars), which runs the
forward, ``loss.backward()`` and ``_apply_gradients``. Scalars are
fetched to the host every ``log_every`` steps, so the loop does not
wait for the device on every step.

``train(train_loader, valid_loader, max_epochs)`` runs the epochs, saves
a numbered checkpoint at the last epoch or after ``ckpt_min_interval_s``
and, every ``eval_interval`` epochs, the best checkpoint on
``eval_metric`` (lower is better; by default the mean ``eval_step`` loss
over the validation batches, ``evaluate_one_epoch``).

A checkpoint restores tolerantly, as the JAX trainer's does: each key
of the model, the Adam state (kept by parameter name) and the EMA
shadow takes the saved value where the checkpoint has it with the same
shape, and keeps its fresh value, logged, where not; ``_post_restore``
then rebuilds what derives from skipped keys. ``_extra_ckpt_metadata``
is stored in the file, and ``_restore_metadata`` reads it back before
the merge (TensoRF resizes its factors there).

With ``use_tensorboard`` (the command lines set it, as the JAX trainer's
default does) and where ``tensorboardX`` imports, ``writer`` is a
``SummaryWriter`` on ``<workspace>/run/<name>``, and the scalars go where
the JAX trainer writes them: ``train/<metric>`` and ``train/lr`` at each
metrics flush, ``eval/loss`` after ``evaluate_one_epoch`` and
``eval/<metric>`` after the NeRF trainers' ``evaluate``; otherwise
``writer`` is None.

Under a mesh (``self.mesh``, ``parallel.make_mesh``; every rank runs the
same loop) rank 0 alone logs and writes files. A checkpoint holds the
whole CP factor banks, their Adam moments and EMA shadows, gathered over
the ``model`` axis, as the JAX trainer's ``device_get`` gives them, so it
equals a one-device checkpoint; ``load_checkpoint`` splits them again.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import torch

from ngp_tpu_torch import tracing
from ngp_tpu_torch.parallel.mesh import gather_split, split_names, take_split
from ngp_tpu_torch.training import checkpoints as ckpt_lib
from ngp_tpu_torch.training.state import EMA, make_optimizer


class Trainer:
    def __init__(self, name: str, workspace: str = "workspace", lr: float = 1e-3,
                 lr_decay_target: float = 0.1, max_steps: int = 30000,
                 ema_decay: Optional[float] = 0.95, max_keep_ckpt: int = 2,
                 eval_interval: int = 1, log_every: int = 100,
                 use_tensorboard: bool = False):
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
        self.stats = {"loss": [], "valid_loss": [], "best_loss": None}
        # at most one numbered checkpoint per interval (besides the last)
        self.ckpt_min_interval_s = 120.0
        self._last_ckpt_time = 0.0
        self.model: Optional[torch.nn.Module] = None
        self.optimizer = None
        self.scheduler = None
        self.ema: Optional[EMA] = None
        self.last_restore_skipped: List[str] = []
        # a parallel.make_mesh mesh: rays split over "data" in the train
        # step and the frame renders (see training/nerf.py), or None
        self.mesh = None
        self.writer = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self.writer = SummaryWriter(os.path.join(workspace, "run", name))

    # ---- subclass hooks --------------------------------------------------

    def on_step_begin(self):
        """Called before every train step (the grid trainer refreshes its
        occupancy grid here)."""

    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _aux_state(self) -> Dict[str, Any]:
        return {}

    def _load_aux_state(self, sd: Dict[str, Any], skipped: List[str]) -> None:
        pass

    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        raise NotImplementedError(
            "implement eval_step (batch-loss eval) or override eval_metric (e.g. -PSNR "
            "via evaluate) for best-checkpoint selection")

    def eval_metric(self, valid) -> float:
        """Best-checkpoint metric (lower is better) of the validation input:
        by default the mean ``eval_step`` loss over its batches."""
        return self.evaluate_one_epoch(valid)

    def _make_optimizer(self):
        """(optimizer, scheduler) over ``self.model``'s parameters."""
        return make_optimizer([("all", list(self.model.parameters()), self.lr,
                                self.lr_decay_target)], self.max_steps)

    def _extra_ckpt_metadata(self) -> Dict[str, Any]:
        """Plain values stored in the checkpoint beside the state."""
        return {}

    def _restore_metadata(self, meta: Dict[str, Any]) -> None:
        """Called with the stored metadata before the state is restored."""

    def _post_restore(self, skipped: List[str]) -> None:
        """Rebuild derived state after a restore that kept fresh values for
        the ``skipped`` keys."""

    # ---- lifecycle -------------------------------------------------------

    def ensure_initialized(self):
        """The optimizer, schedule and EMA shadow of ``self.model``."""
        if self.optimizer is None:
            self.reset_optimizer()

    def reset_optimizer(self):
        """A fresh optimizer and schedule, and an EMA shadow that starts as
        a copy of the parameters (after the module's parameters were
        replaced)."""
        self.optimizer, self.scheduler = self._make_optimizer()
        self.ema = EMA(self.model, self.ema_decay) if self.ema_decay is not None else None

    @tracing.traced("update")
    def _apply_gradients(self):
        """Adam step, schedule step, then the EMA of the new weights."""
        self.optimizer.step()
        self.scheduler.step()
        if self.ema is not None:
            self.ema.update()

    @tracing.traced("step")
    def step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """One train step with its bookkeeping: ``on_step_begin`` (the
        refresh cadence keys off ``global_step``), the step, the count.
        Returns device scalars; reading them waits for the device. Under
        a profiler the call is the span ``ngp/step`` (``tracing``)."""
        self.ensure_initialized()
        self.on_step_begin()
        metrics = self.train_step(batch, draws)
        self.global_step += 1
        return metrics

    def train(self, train_loader: Union[Iterable, Callable[[], Iterable]],
              valid_loader=None, max_epochs: int = 1):
        """Train to ``max_epochs``. ``train_loader`` is iterated once an
        epoch, or called for each epoch's iterator when it is a function."""
        self.ensure_initialized()
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            self.train_one_epoch(train_loader() if callable(train_loader) else train_loader)
            if self._agree(epoch == max_epochs
                           or time.time() - self._last_ckpt_time > self.ckpt_min_interval_s):
                self.save_checkpoint()
                self._last_ckpt_time = time.time()
            if valid_loader is not None and epoch % self.eval_interval == 0:
                metric = self.eval_metric(valid_loader)
                if self.stats["best_loss"] is None or metric < self.stats["best_loss"]:
                    self.stats["best_loss"] = metric
                    self.save_checkpoint(best=True)

    def evaluate_one_epoch(self, loader: Iterable) -> float:
        """The mean ``eval_step`` loss over the loader's batches."""
        total, n = 0.0, 0
        for batch in loader:
            total += float(self.eval_step(batch)["loss"])
            n += 1
        loss = total / max(n, 1)
        self.stats["valid_loss"].append(loss)
        self.log(f"eval epoch {self.epoch}: loss={loss:.6f}")
        if self.writer is not None:
            self.writer.add_scalar("eval/loss", loss, self.global_step)
        return loss

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

    def profile_steps(self, loader, n_steps: int = 20, logdir: Optional[str] = None) -> str:
        """Run ``n_steps`` train steps under ``torch.profiler`` (CPU
        activity, and CUDA's with the model on a card), then synchronise.
        The Chrome trace, with the ``ngp/`` spans of ``tracing`` on the
        timeline of the device's events, goes to ``logdir``
        (``<workspace>/profile`` by default; open it in Perfetto), and the
        log gets the counters a step. ``loader`` is an iterable of batches,
        or a function giving one epoch's iterator (called again while
        steps remain). Returns the directory."""
        from torch.profiler import ProfilerActivity, profile

        self.ensure_initialized()
        logdir = logdir or os.path.join(self.workspace, "profile")
        dev = next(self.model.parameters()).device
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        batches = (itertools.chain.from_iterable(loader() for _ in itertools.count())
                   if callable(loader) else iter(loader))
        tracing.reset_counters()
        with profile(activities=activities) as prof:
            for batch in itertools.islice(batches, n_steps):
                self.step(batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        totals = tracing.counter_totals()
        tracing.reset_counters()
        if self._writes():
            os.makedirs(logdir, exist_ok=True)
            path = os.path.join(logdir, f"{self.name}_step{self.global_step}.trace.json")
            prof.export_chrome_trace(path)
            self.log(f"profile trace of {n_steps} steps written to {path}")
            if totals:
                self.log("counters a step: " + " ".join(
                    f"{k}={v / n_steps:.6g}" for k, v in sorted(totals.items())))
        return logdir

    def _flush_metrics(self, pending):
        if not pending:
            return
        step, metrics = pending[-1]
        host = {k: float(v) for k, v in metrics.items()}
        self.stats["loss"].append(host.get("loss", 0.0))
        if self.writer is not None:
            for k, v in host.items():
                self.writer.add_scalar(f"train/{k}", v, step)
            self.writer.add_scalar("train/lr", self.optimizer.param_groups[0]["lr"], step)
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

    def _agree(self, flag: bool) -> bool:
        """Under a mesh, rank 0's ``flag`` on every rank (a decision read
        off the host clock, which the ranks must take together), else
        ``flag``."""
        if self.mesh is None:
            return flag
        t = torch.tensor([int(flag)], device=next(self.model.parameters()).device)
        torch.distributed.broadcast(t, src=0)
        return bool(t.item())

    def _writes(self) -> bool:
        """Whether this process logs and writes files: rank 0 under a mesh."""
        return self.mesh is None or torch.distributed.get_rank() == 0

    def log(self, msg: str):
        if not self._writes():
            return
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        os.makedirs(self.workspace, exist_ok=True)
        with open(os.path.join(self.workspace, f"log_{self.name}.txt"), "a") as f:
            f.write(line + "\n")

    # ---- checkpoints -----------------------------------------------------

    def _optimizer_state(self) -> Dict[str, Any]:
        """The optimizer's state dict with its per-parameter state and
        groups keyed by parameter name, not by index: an added network
        then shifts no other parameter's moments."""
        names = {id(p): k for k, p in self.model.named_parameters()}
        order = [names[id(p)] for g in self.optimizer.param_groups for p in g["params"]]
        sd = self.optimizer.state_dict()
        return {"by_name": True,
                "state": {order[i]: v for i, v in sd["state"].items()},
                "param_groups": [{**g, "params": [order[i] for i in g["params"]]}
                                 for g in sd["param_groups"]]}

    def _load_optimizer_state(self, saved: Dict[str, Any], skipped: List[str]) -> None:
        """Restore ``_optimizer_state`` (or an older index-keyed state dict,
        whose indices are the fresh optimizer's order): a parameter whose
        state is missing or reshaped gets zero moments at the restored step
        count (the JAX optimizer keeps one count for all parameters) and is
        appended to ``skipped``."""
        params = dict(self.model.named_parameters())
        names = {id(p): k for k, p in params.items()}
        order = [names[id(p)] for g in self.optimizer.param_groups for p in g["params"]]
        if saved.get("by_name"):
            by_name = saved["state"]
        else:
            by_name = {order[i]: v for i, v in saved["state"].items() if i < len(order)}
        state = {}
        for i, name in enumerate(order):
            s = by_name.get(name)
            if s is not None and all(tuple(v.shape) == tuple(params[name].shape)
                                     for k, v in s.items() if k != "step"):
                # the moments in their parameter's layout (a factor's is cell-major)
                state[i] = {k: v if k == "step" else torch.empty_like(params[name]).copy_(v)
                            for k, v in s.items()}
            else:
                skipped.append(f"optimizer/{name}")
        step = next((s["step"] for s in state.values() if "step" in s), None)
        if step is not None:
            for i, name in enumerate(order):
                if i not in state:
                    z = torch.zeros_like(params[name], memory_format=torch.preserve_format)
                    state[i] = {"step": step.clone(), "exp_avg": z, "exp_avg_sq": z.clone()}
        groups = self.optimizer.state_dict()["param_groups"]
        if len(saved["param_groups"]) == len(groups):
            groups = [{**g, **{k: v for k, v in sg.items() if k != "params"}}
                      for g, sg in zip(groups, saved["param_groups"])]
        self.optimizer.load_state_dict({"state": state, "param_groups": groups})

    def _resplit(self, sd: Optional[Dict[str, Any]], fn) -> Optional[Dict[str, Any]]:
        """``sd`` with ``fn`` applied to the split banks' entries (state
        dicts by parameter name; the optimizer's per-parameter dicts, all but
        their step count). Every rank calls it in the same order."""
        names = split_names(self.model) if self.mesh is not None else ()
        if sd is None or not names:
            return sd
        out = dict(sd)
        for k in sorted(names):
            v = out.get(k)
            if isinstance(v, dict):
                out[k] = {kk: vv if kk == "step" else fn(vv) for kk, vv in v.items()}
            elif v is not None:
                out[k] = fn(v)
        return out

    def _ckpt_state(self) -> Dict[str, Any]:
        def whole(sd):
            return self._resplit(sd, lambda t: gather_split(t, self.mesh))

        opt = self._optimizer_state()
        return {
            "model": whole(self.model.state_dict()),
            "optimizer": dict(opt, state=whole(opt["state"])),
            "scheduler": self.scheduler.state_dict(),
            "ema": whole(self.ema.state_dict()) if self.ema is not None else None,
            "aux": self._aux_state(),
            "global_step": self.global_step,
            "best_loss": self.stats["best_loss"],
            "meta": self._extra_ckpt_metadata(),
        }

    def save_checkpoint(self, best: bool = False) -> str:
        """A numbered checkpoint, or with ``best`` the best one, whose
        model weights are the EMA's. Under a mesh every rank calls it and
        rank 0 writes the file."""
        self.ensure_initialized()
        state = self._ckpt_state()
        if best and state["ema"] is not None:
            state["model"] = dict(state["model"], **state["ema"])
        if self._writes():
            path = ckpt_lib.save_checkpoint(self.workspace, self.name, state, epoch=self.epoch,
                                            max_keep=self.max_keep_ckpt, best=best)
        else:
            path = ckpt_lib.checkpoint_path(self.workspace, self.name, self.epoch, best)
        if self.mesh is not None:
            torch.distributed.barrier()  # the file exists for every rank
        return path

    def load_checkpoint(self, path: Optional[str] = None) -> bool:
        """Restore tolerantly (see the module docstring); returns whether a
        checkpoint was found. ``self.last_restore_skipped`` lists the keys
        that kept their fresh values."""
        self.ensure_initialized()
        if path is None:
            path = ckpt_lib.latest_checkpoint(self.workspace, self.name)
        if path is None or not os.path.exists(path):
            self.log("no checkpoint found, training from scratch")
            return False
        sd = ckpt_lib.load_checkpoint(path)
        if self.mesh is not None:
            # this model rank's columns of the whole banks

            def mine(sd_):
                return self._resplit(sd_, lambda t: take_split(t, self.mesh))

            sd = dict(sd, model=mine(sd.get("model")), ema=mine(sd.get("ema")),
                      optimizer=dict(sd["optimizer"], state=mine(sd["optimizer"]["state"])))
        self._restore_metadata(sd.get("meta") or {})
        skipped: List[str] = []
        self.model.load_state_dict(
            ckpt_lib.tolerant_merge(self.model.state_dict(), sd.get("model"), "model", skipped))
        self._load_optimizer_state(sd["optimizer"], skipped)
        self.scheduler.load_state_dict(sd["scheduler"])
        if self.ema is not None:
            skipped += [f"ema/{k}" for k in self.ema.load_state_dict(sd.get("ema") or {})]
        self._load_aux_state(sd.get("aux") or {}, skipped)
        self.global_step = sd["global_step"]
        self.epoch = sd["epoch"]
        self.stats["best_loss"] = sd.get("best_loss")
        self.last_restore_skipped = skipped
        if skipped:
            self.log(f"checkpoint restore: kept fresh values for {len(skipped)} "
                     f"missing/mismatched keys: {skipped}")
            self._post_restore(skipped)
        self.log(f"loaded checkpoint {path} (epoch {self.epoch})")
        return True
