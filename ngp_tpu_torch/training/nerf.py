"""NeRF trainer (``ngp_tpu/training/nerf.py:NeRFTrainer``).

``train_step`` trains on one batch of sampled rays of one frame: the
frame gather, pixel sampling (uniform, error map or patches), a random
per-pixel background for RGBA frames, the render, per-ray MSE, the
optimizer step and the error-map EMA. Its random draws come from the
trainer's generator, or from ``draws`` (the sampler's draws, "bg" and
"noise"), so that a test can feed it the numbers ``jax.random`` drew.

``render_frame`` renders with the EMA weights when there are any, a
full frame in fixed-size ray chunks. Which rays share a chunk decides
the pixels, because the occupancy-grid
renderer water-fills a per-chunk sample budget, so the chunking follows
the JAX code exactly: the frame's rays are interleaved by a fixed
permutation (``np.random.default_rng(1234)``), the eval prepass (when
the subclass has one) sorts them hit-first, the chunk count is rounded
into buckets and only grows (sticky maximum), and the tail chunk is
padded by repeating the last index. The JAX code loops over chunks with
``jax.lax.map`` inside one compiled call; here it is a Python loop
whose chunks run on the device without a host sync.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from ngp_tpu_torch.config import RenderConfig, TrainConfig
from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
from ngp_tpu_torch.data.raysampler import (
    rays_from_frame_indices,
    rays_from_indices,
    sample_ray_indices,
)
from ngp_tpu_torch.models.nerf import NeRFNetwork
from ngp_tpu_torch.training.trainer import Trainer


class NeRFTrainer(Trainer):
    def __init__(self, model: NeRFNetwork, render_cfg: RenderConfig,
                 train_cfg: Optional[TrainConfig] = None, name: str = "ngp",
                 seed: int = 0, **kwargs):
        train_cfg = train_cfg or TrainConfig()
        kwargs.setdefault("lr", train_cfg.lr)
        kwargs.setdefault("max_steps", train_cfg.iters)
        kwargs.setdefault("workspace", train_cfg.workspace)
        kwargs.setdefault("ema_decay", train_cfg.ema_decay)
        kwargs.setdefault("max_keep_ckpt", train_cfg.max_keep_ckpt)
        super().__init__(name=name, **kwargs)
        if train_cfg.tv_weight > 0 or train_cfg.distortion_weight > 0:
            raise NotImplementedError("the tv and distortion losses are not ported yet")
        self.model = model
        self.render_cfg = render_cfg
        self.train_cfg = train_cfg
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # rays per chunk of a staged frame render (the reference's
        # --max_ray_batch)
        self.max_ray_batch = 4096
        # True: frames come back as f32; False: quantized to u8 (image)
        # and bf16 (depth), as the JAX trainer transfers them
        self.eval_f32_frames = False
        self.aux = self.init_aux()
        self._chunk_counts: Dict[tuple, int] = {}
        # totals of the last render_frames call: rendered samples and
        # the budget-overflow estimate (the march's n_dropped counters)
        self.last_render_stats: Dict[str, float] = {}

    def init_aux(self):
        return {}

    def _fns(self):
        """(density_fn, color_fn) on the live weights, recording autograd
        when grad mode is on."""
        raise NotImplementedError(
            "the non-grid renderer is not ported yet; use GridNeRFTrainer"
        )

    def _eval_fns(self):
        """The network closures one frame render uses (built once per
        frame, not per chunk)."""
        raise NotImplementedError(
            "the non-grid renderer is not ported yet; use GridNeRFTrainer"
        )

    def _render_with(self, fns, rays_o, rays_d, bg_color=None, aabb=None,
                     t_range=None, perturb=False, noise=None):
        """Render one batch of rays with the closures of ``_fns`` plus a
        fused radiance closure or None (training: ``perturb``) or of
        ``_eval_fns`` (eval)."""
        raise NotImplementedError(
            "the non-grid renderer is not ported yet; use GridNeRFTrainer"
        )

    # ---- train -----------------------------------------------------------

    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """batch: images [F, H, W, C], poses [F, 4, 4], intrinsics [4] on
        the device, and the frame index ``idx``. Returns device scalars
        "loss" and, from the grid renderer, "turbo_overflow"."""
        self.ensure_initialized()
        draws = draws or {}
        images, poses, intrinsics = batch["images"], batch["poses"], batch["intrinsics"]
        idx = int(batch["idx"])
        F, H, W, C = images.shape
        n_rays = self.train_cfg.num_rays
        dev = images.device
        image, pose = images[idx], poses[idx]
        error_map = self.aux["error_map"][idx] if "error_map" in self.aux else None
        sample = sample_ray_indices(
            H, W, n_rays, error_map=error_map, patch_size=self.train_cfg.patch_size,
            uniform_frac=self.train_cfg.error_map_uniform_frac,
            generator=self.generator, draws=draws, device=dev,
        )
        inds = sample["inds"]
        rays = rays_from_indices(pose, intrinsics, H, W, inds)
        pixels = image.reshape(H * W, C)[inds].float()
        if C == 4 and self.render_cfg.bg_radius <= 0:
            bg = draws["bg"].to(dev) if "bg" in draws else torch.rand(
                (n_rays, 3), generator=self.generator, device=dev)
        else:
            bg = 1.0
        gt_rgb = pixels[:, :3] * pixels[:, 3:] + bg * (1.0 - pixels[:, 3:]) if C == 4 else pixels

        self.optimizer.zero_grad(set_to_none=True)
        out = self._render_with((*self._fns(), None), rays["rays_o"], rays["rays_d"],
                                bg_color=bg, perturb=True, noise=draws.get("noise"))
        per_ray = ((out["image"] - gt_rgb) ** 2).mean(dim=-1)
        loss = per_ray.mean()
        loss.backward()
        self._apply_gradients()

        metrics = {"loss": loss.detach()}
        if "n_dropped" in out:
            tot = (out["n_dropped"] + out["n_samples"]).float()
            metrics["turbo_overflow"] = out["n_dropped"].float() / torch.clamp(tot, min=1.0)
        if error_map is not None:
            # in place: the map is trainer state that nothing else holds
            em = self.aux["error_map"]
            ic = sample["inds_coarse"]
            em[idx, ic] = 0.1 * em[idx][ic] + 0.9 * per_ray.detach()
        return metrics

    def make_loader(self, dataset: NeRFDataset):
        """Epoch iterator factory: the split's arrays go to the device
        once, and each step's batch names them and a frame index."""
        dev = self.device
        images = torch.as_tensor(
            dataset.images if dataset.images is not None
            else np.zeros((len(dataset), dataset.H, dataset.W, 3), np.float32), device=dev)
        poses = torch.as_tensor(np.asarray(dataset.poses, np.float32), device=dev)
        intrinsics = torch.as_tensor(np.asarray(dataset.intrinsics, np.float32), device=dev)
        np_rng = np.random.default_rng(self.train_cfg.seed)
        n_frames = len(dataset)

        def epoch_iter():
            for idx in dataset.epoch_indices(np_rng, self.train_cfg.rand_pose):
                if idx >= n_frames:
                    continue  # random-pose guidance steps are not ported
                yield {"images": images, "poses": poses, "intrinsics": intrinsics,
                       "idx": int(idx)}

        return epoch_iter

    def enable_error_map(self, n_frames: int):
        M = self.train_cfg.error_map_size
        self.aux = dict(self.aux)
        self.aux["error_map"] = torch.ones((n_frames, M * M), device=self.device)

    def train_on_dataset(self, train_ds: NeRFDataset,
                         valid_ds: Optional[NeRFDataset] = None, max_epochs: int = 1):
        if valid_ds is not None:
            raise NotImplementedError("evaluate is not ported yet; pass valid_ds=None")
        self.ensure_initialized()
        if self.train_cfg.error_map and train_ds.images is not None:
            if "error_map" not in self.aux:
                self.enable_error_map(len(train_ds))
        epoch_iter = self.make_loader(train_ds)
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            self.train_one_epoch(epoch_iter())
            if (epoch == max_epochs
                    or time.time() - self._last_ckpt_time > self.ckpt_min_interval_s):
                self.save_checkpoint()
                self._last_ckpt_time = time.time()

    # ---- eval ------------------------------------------------------------

    def _eval_weights(self):
        """The EMA weights in the model while rendering, when there are
        any (the JAX trainer's ``eval_params``)."""
        return self.ema.average_parameters() if self.ema is not None else contextlib.nullcontext()

    @torch.no_grad()
    def render_frame(self, pose, intrinsics, H: int, W: int, chunk: int = 0):
        """One frame -> (image [H, W, 3], depth [H, W]) numpy f32."""
        imgs, deps = self.render_frames(np.asarray(pose, np.float32)[None], intrinsics,
                                        H, W, chunk=chunk)
        return imgs[0], deps[0]

    @torch.no_grad()
    def render_frames(self, poses, intrinsics, H: int, W: int, chunk: int = 0):
        """poses [F, 4, 4] -> (images [F, H, W, 3], depths [F, H, W]),
        each frame rendered as its own single-frame group."""
        poses = np.asarray(poses, np.float32)
        imgs, deps = [], []
        n_samples = n_dropped = 0.0
        with self._eval_weights():
            for f in range(poses.shape[0]):
                img, dep, stats = self._render_one(poses[f], intrinsics, H, W,
                                                   chunk or self.max_ray_batch)
                imgs.append(img)
                deps.append(dep)
                n_samples += stats["n_samples"]
                n_dropped += stats["n_dropped"]
        self.last_render_stats = {"n_samples": n_samples, "n_dropped": n_dropped}
        return np.stack(imgs), np.stack(deps)

    def _render_one(self, pose: np.ndarray, intrinsics, H: int, W: int, chunk: int):
        dev = self.device
        aabb_eff = np.asarray(self.render_cfg.aabb, np.float32)
        box = self._fetch_eval_tight_box()
        if box is not None:
            lo = np.maximum(aabb_eff[:3], box[:3])
            hi = np.minimum(aabb_eff[3:], box[3:])
            if (hi > lo).all():
                aabb_eff = np.concatenate([lo, hi])
            self._set_eval_lattice_span(aabb_eff)
        else:
            self._eval_lattice_span = None
        pose_t = torch.as_tensor(pose, device=dev)[None]
        intr_t = torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev)
        pre = self._run_eval_prepass(pose_t, intr_t, H, W, aabb_eff)
        if pre is not None:
            self._set_eval_lattice_span_value(pre["span"])
        n = H * W
        if pre is not None:
            C = max(1, -(-pre["count"] // chunk))
            C = 1 << (C - 1).bit_length() if C <= 8 else -(-C // 16) * 16
            C = min(C, max(1, -(-n // chunk)))
            # sticky maximum: the JAX renderer keeps the largest chunk
            # count seen at this frame size so it never recompiles; the
            # count also decides which rays share a chunk
            ckey = ("dev_C", H, W, chunk)
            C = max(C, self._chunk_counts.get(ckey, 0))
            self._chunk_counts[ckey] = C
            inds = self._sorted_chunk_slices(pre["sorted_inds"], C, chunk)
        else:
            sel = self._frame_perm(n)
            bbox = self._project_aabb_bbox(pose, intrinsics, H, W, aabb_eff)
            if bbox is not None:
                r0, r1, c0, c1 = bbox
                rows, cols = sel // W, sel % W
                sel = sel[(rows >= r0) & (rows <= r1) & (cols >= c0) & (cols <= c1)]
            inds = None
            if sel.size:
                C = max(1, -(-sel.size // chunk))
                C = 1 << (C - 1).bit_length() if C <= 8 else -(-C // 8) * 8
                pad = C * chunk - sel.size
                sel = np.concatenate([sel, np.full(pad, sel[-1])]) if pad else sel
                inds = torch.as_tensor(sel.reshape(C, chunk).astype(np.int64), device=dev)
        images = torch.ones((n, 3), device=dev)
        depths = torch.zeros((n,), device=dev)
        n_samples = torch.zeros((), device=dev)
        n_dropped = torch.zeros((), device=dev)
        if inds is not None:
            fns = self._eval_fns()
            aabb_t = torch.as_tensor(aabb_eff, device=dev)
            fids = torch.zeros((chunk,), dtype=torch.int64, device=dev)
            for c in range(inds.shape[0]):
                ic = inds[c]
                rays = rays_from_frame_indices(pose_t, intr_t, H, W, ic, fids)
                t_range = None
                if pre is not None:
                    t_range = torch.stack([pre["t0"][ic], pre["t1"][ic]], dim=-1)
                out = self._render_with(fns, rays["rays_o"], rays["rays_d"],
                                        bg_color=1.0, aabb=aabb_t, t_range=t_range)
                img = torch.clamp(out["image"], 0.0, 1.0)
                dep = out["depth"]
                if not self.eval_f32_frames:
                    img = torch.round(img * 255.0).to(torch.uint8).float() / 255.0
                    dep = dep.to(torch.bfloat16).float()
                # clip-padded duplicates write identical values
                images[ic] = img
                depths[ic] = dep
                n_samples += out["n_samples"]
                n_dropped += out["n_dropped"]
        stats = {"n_samples": float(n_samples), "n_dropped": float(n_dropped)}
        return (images.reshape(H, W, 3).cpu().numpy(),
                depths.reshape(H, W).cpu().numpy(), stats)

    # hooks the occupancy-grid trainer fills in
    def _fetch_eval_tight_box(self):
        return None

    def _set_eval_lattice_span(self, aabb_eff):
        pass

    def _set_eval_lattice_span_value(self, span: float):
        pass

    def _run_eval_prepass(self, poses, intrinsics, H, W, aabb_eff):
        return None

    @staticmethod
    def _sorted_chunk_slices(sorted_inds: torch.Tensor, C: int, chunk: int):
        """[C, chunk] chunks of the hit-sorted index buffer; positions
        past its end repeat its last entry."""
        pos = torch.arange(C * chunk, device=sorted_inds.device)
        return sorted_inds[pos.clamp(max=sorted_inds.shape[0] - 1)].reshape(C, chunk)

    def _project_aabb_bbox(self, pose, intrinsics, H: int, W: int, aabb=None):
        """Conservative pixel bbox (+1 px) of the projected scene box;
        None when the camera is inside the box or a corner is behind it."""
        pose = np.asarray(pose, np.float32)
        fx, fy, cx, cy = np.asarray(intrinsics, np.float32)
        if aabb is None:
            aabb = np.asarray(self.render_cfg.aabb, np.float32)
        o = pose[:3, 3]
        if np.all(o >= aabb[:3]) and np.all(o <= aabb[3:]):
            return None
        corners = np.array(
            [[aabb[3 * (i & 1)], aabb[1 + 3 * ((i >> 1) & 1)], aabb[2 + 3 * ((i >> 2) & 1)]]
             for i in range(8)], np.float32,
        )
        cam = (corners - o) @ pose[:3, :3]
        if np.any(cam[:, 2] <= 1e-6):
            return None
        col = cam[:, 0] / cam[:, 2] * fx + cx
        row = cam[:, 1] / cam[:, 2] * fy + cy
        r0 = max(0, int(np.floor(row.min())) - 1)
        r1 = min(H - 1, int(np.ceil(row.max())) + 1)
        c0 = max(0, int(np.floor(col.min())) - 1)
        c1 = min(W - 1, int(np.ceil(col.max())) + 1)
        if r0 > r1 or c0 > c1:
            return (0, -1, 0, -1)
        return (r0, r1, c0, c1)

    @staticmethod
    def _frame_perm(n: int) -> np.ndarray:
        """The fixed ray interleave of an n-pixel frame."""
        return np.random.default_rng(1234).permutation(n)
