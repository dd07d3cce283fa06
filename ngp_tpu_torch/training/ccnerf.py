"""CCNeRF trainer (``ngp_tpu/training/ccnerf.py``; the reference's CCNeRF
training through tensoRF/utils.py): rank-residual steps.

The model's forward gives the cumulative outputs of the first 1..K rank
groups; each is composited into its own image over the same march
samples (the reference's run_cuda composites per K,
nerf/renderer.py:298-311) and the loss averages the K MSEs
(nerf/utils.py:529-531), so every rank prefix stays a usable model.
With the turbo march (``-O``) the K heads share one march and one
compaction (``render_rays_grid_turbo_multi``); without it, the v1 march's
[N, S] samples are composited once per K. Frames, refreshes, evaluate and
test render the full rank through the density and colour closures
(``_fns``), as in JAX.
"""

from __future__ import annotations

from typing import Dict

import torch

from ngp_tpu_torch.data.raysampler import rays_from_indices, sample_ray_indices
from ngp_tpu_torch.models.ccnerf import CCNeRF
from ngp_tpu_torch.models.occupancy import (
    composite_rays,
    march_rays,
    render_rays_grid_turbo_multi,
)
from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer


class CCNeRFTrainer(GridNeRFTrainer):
    def __init__(self, model: CCNeRF, render_cfg, train_cfg, name: str = "ccnerf", **kwargs):
        super().__init__(model, render_cfg, train_cfg, name=name, **kwargs)

    def _fns(self):
        model = self.model

        def color_fn(d, geo):
            shape = d.shape[:-1]
            _, rgb = model.sigma_rgb(geo.reshape(-1, 3), d.reshape(-1, 3))
            return rgb.reshape(*shape, 3)

        return model.density, color_fn, None

    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """One residual step on a batch of one frame's rays (uniform pixels,
        a random per-pixel background for RGBA frames): the loss is the
        mean over K of each rank prefix's MSE. ``draws`` as
        ``NeRFTrainer.train_step`` takes them ("inds", "bg", "noise")."""
        self.ensure_initialized()
        draws = draws or {}
        images, poses, intrinsics = batch["images"], batch["poses"], batch["intrinsics"]
        idx = int(batch["idx"])
        F, H, W, C = images.shape
        n_rays = self.train_cfg.num_rays
        dev = images.device
        inds = sample_ray_indices(H, W, n_rays, generator=self.generator, draws=draws,
                                  device=dev)["inds"]
        rays = rays_from_indices(poses[idx], intrinsics, H, W, inds)
        pixels = images[idx].reshape(H * W, C)[inds].float()
        if C == 4:
            bg = draws["bg"].to(dev) if "bg" in draws else torch.rand(
                (n_rays, 3), generator=self.generator, device=dev)
            gt = pixels[:, :3] * pixels[:, 3:] + bg * (1.0 - pixels[:, 3:])
        else:
            bg, gt = 1.0, pixels
        cfg, model, occ = self.render_cfg, self.model, self.aux["occ"]
        noise = draws.get("noise")

        self.optimizer.zero_grad(set_to_none=True)
        if cfg.turbo:
            # one march and compaction for every rank prefix
            out = render_rays_grid_turbo_multi(
                lambda pts, dirs: model.sigma_rgb(pts, dirs, residual=True),
                rays["rays_o"], rays["rays_d"], occ, cfg, bg_color=bg, perturb=True,
                generator=self.generator, noise=noise)
            imgs = out["image"]
        else:
            m = march_rays(rays["rays_o"], rays["rays_d"], occ, cfg, perturb=True,
                           generator=self.generator, noise=noise)
            S = m["xyzs"].shape[1]
            sigma, rgb = model.sigma_rgb(m["xyzs"].reshape(-1, 3), m["dirs"].reshape(-1, 3),
                                         residual=True)
            K = sigma.shape[0]
            out = composite_rays(sigma.reshape(K, n_rays, S), rgb.reshape(K, n_rays, S, 3),
                                 m["ts"], m["deltas"], m["mask"], m["nears"], m["fars"],
                                 density_scale=cfg.density_scale, t_thresh=cfg.t_thresh)
            imgs = out["image"] + (1.0 - out["weights_sum"])[..., None] * bg
        loss = ((imgs - gt[None]) ** 2).mean(dim=(1, 2)).mean()
        loss.backward()
        self._apply_gradients()
        return {"loss": loss.detach()}
