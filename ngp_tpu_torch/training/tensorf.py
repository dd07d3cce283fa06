"""TensoRF trainer (``ngp_tpu/training/tensorf.py``; the reference's
tensoRF/utils.py): the occupancy-grid trainer with

- the L1 of the sigma factors added to the loss (utils.py:46);
- two learning-rate groups: the factors at ``lr`` (lr0), the networks at
  ``lr_net`` (lr1), each decaying to 0.1x over ``max_steps``
  (``make_optimizer``'s groups, the counterpart of ``optax.multi_transform``);
- at the first step of ``upsample_model_steps`` a shrink of the VM
  factors to the occupied cells' AABB, and at each of them an upsample
  to the next of the log-spaced resolutions (``upsample_schedule``);
  new parameters get a fresh optimizer and schedule and an EMA that
  restarts as their copy (``_replace_params``), as the JAX trainer's
  ``tx.init`` and EMA reset do;
- checkpoints that store the factor resolution and the AABB; a restore
  first resizes the live factors to the stored resolution.

The density, colour and background closures (``_fns``) read the live
AABB; frames render through them (no fused radiance closure).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ngp_tpu_torch.config import RenderConfig, TrainConfig
from ngp_tpu_torch.models.tensorf import (
    FACTOR_PREFIXES,
    TensoRFCPNetwork,
    _vm_resolution,
    set_parameters,
    shrink_vm_params,
    upsample_cp_params,
    upsample_vm_params,
)
from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer
from ngp_tpu_torch.training.state import make_optimizer


def upsample_schedule(resolution0: int, resolution1: int, steps: Sequence[int]) -> list:
    """Log-spaced target resolutions (main_tensoRF.py:132)."""
    return (np.round(np.exp(np.linspace(np.log(resolution0), np.log(resolution1),
                                        len(steps) + 1)))
            .astype(np.int32).tolist()[1:])


class TensoRFTrainer(GridNeRFTrainer):
    def __init__(self, model, render_cfg: RenderConfig, train_cfg: TrainConfig,
                 lr_net: float = 1e-3, l1_reg_weight: float = 1e-4,
                 upsample_model_steps: Sequence[int] = (2000, 3000, 4000, 5500, 7000),
                 resolution0: int = 128, resolution1: int = 300, name: str = "tensoRF",
                 **kwargs):
        self.lr_net = lr_net
        super().__init__(model, render_cfg, train_cfg, name=name, **kwargs)
        self.l1_reg_weight = l1_reg_weight
        self.upsample_model_steps = list(upsample_model_steps)
        self.upsample_resolutions = upsample_schedule(resolution0, resolution1,
                                                      upsample_model_steps)
        self.is_cp = isinstance(model, TensoRFCPNetwork)
        self.aabb = np.asarray(render_cfg.aabb, np.float32)
        self._did_shrink = False

    def _make_optimizer(self):
        factors, nets = [], []
        for k, p in self.model.named_parameters():
            (factors if k.startswith(FACTOR_PREFIXES) else nets).append(p)
        return make_optimizer([("factors", factors, self.lr, self.lr_decay_target),
                               ("nets", nets, self.lr_net, 0.1)], self.max_steps)

    def _fns(self):
        aabb = torch.as_tensor(self.aabb, device=self.device)
        model = self.model

        def density_fn(x):
            return model.density(x, aabb)

        def color_fn(d, geo):
            return model.color(d, geo, aabb)

        bg_fn = model.background if model.bg_radius > 0 else None
        return density_fn, color_fn, bg_fn

    def _loss_extra(self):
        """The L1 sparsity of the sigma factors (tensoRF/utils.py:46)."""
        return self.l1_reg_weight * self.model.density_loss()

    # ---- upsample and shrink ---------------------------------------------

    def on_step_begin(self):
        super().on_step_begin()
        if self.global_step in self.upsample_model_steps:
            reso = int(self.upsample_resolutions[
                self.upsample_model_steps.index(self.global_step)])
            if not self._did_shrink:
                self._shrink()
                self._did_shrink = True
            self._upsample((reso, reso, reso))

    def _params(self):
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def _shrink(self):
        occ = self.aux["occ"]
        params, aabb = self._params(), self.aabb
        if not self.is_cp:
            cfg = self.render_cfg
            params, aabb = shrink_vm_params(
                params, self.aabb, occ.density_grid.cpu().numpy(), float(occ.mean_density),
                cfg.density_thresh, cfg.bound, cfg.grid_size)
        self.aabb = np.asarray(aabb, np.float32)
        self._replace_params(params)
        self.log(f"shrink: aabb -> {self.aabb.tolist()}")

    def _upsample(self, resolution: Tuple[int, int, int]):
        fn = upsample_cp_params if self.is_cp else upsample_vm_params
        self._replace_params(fn(self._params(), resolution))
        self.log(f"upsample -> {resolution}")

    def _replace_params(self, params):
        """New parameters (new shapes): a fresh optimizer and schedule, and
        the EMA restarted as a copy of them."""
        set_parameters(self.model, params)
        self.reset_optimizer()

    @property
    def current_resolution(self) -> Tuple[int, int, int]:
        p = self._params()
        if self.is_cp:
            return tuple(p[f"sigma_vec_{i}"].shape[1] for i in range(3))
        return _vm_resolution(p)

    # ---- checkpoints (tensoRF/utils.py:247, :350) -------------------------

    def _extra_ckpt_metadata(self):
        return {"resolution": [int(r) for r in self.current_resolution],
                "aabb": [float(v) for v in self.aabb]}

    def _restore_metadata(self, meta):
        """Resize the live factors to the stored resolution before the
        state is restored, so that their shapes match."""
        reso = meta.get("resolution")
        if reso and tuple(reso) != self.current_resolution:
            self._upsample(tuple(int(r) for r in reso))
            self.log(f"resized model to checkpointed resolution {reso}")
        if meta.get("aabb"):
            self.aabb = np.asarray(meta["aabb"], np.float32)
