"""NeRF trainer (``ngp_tpu/training/nerf.py:NeRFTrainer``).

This class renders without the occupancy grid: the uniform + PDF
renderer of ``models/renderer.py`` (``main_nerf`` without ``-O``); the
grid trainer (``training/nerf_grid.py``) overrides ``_render_with``.
Both composite the background net when ``bg_radius > 0``.

``train_step`` trains on one batch of sampled rays of one frame: the
frame gather, pixel sampling (uniform, error map or patches), a random
per-pixel background for RGBA frames, the render, per-ray MSE plus the
TV term (``tv_weight``, the encoder table's dense levels) and the
distortion term (``distortion_weight``, ``eff_distloss`` on the render's
per-slot weights, ts and deltas), the optimizer step and the error-map
EMA. Its random draws come from the trainer's generator, or from
``draws`` (the sampler's draws, "bg", the render's "noise" and, for the
PDF samples of the uniform renderer, "pdf_u"), so that a test can feed
it the numbers ``jax.random`` drew. With ``rand_pose`` >= 0 and a
``guidance_loss``, the loader also yields random-pose batches, which
``guidance_step`` trains on: a low-resolution full frame from a random
orbit pose on a white background, scored by the image loss.

Dynamic scenes (D-NeRF, ``training/dnerf.py``) share this stack: a batch
that carries ``times`` renders at its frame's time (``_step_fns(time)``
and ``_render_with(..., time=)``), ``_render_loss_extra`` adds a loss
term read from the render's output, and ``render_frames(...,
times=)`` renders each frame at its time; ``evaluate`` and ``test``
pass the split's times, which a static scene's closures ignore.

``render_frame`` renders with the EMA weights when there are any, a
full frame in fixed-size ray chunks, inside ``aabb_infer`` (the
inference crop box) when it is set. Which rays share a chunk decides
the pixels, because the occupancy-grid
renderer water-fills a per-chunk sample budget, so the chunking follows
the JAX code exactly: the frame's rays are interleaved by a fixed
permutation (``np.random.default_rng(1234)``), the eval prepass (when
the subclass has one) sorts them hit-first, the chunk count is rounded
into buckets and only grows (sticky maximum), and the tail chunk is
padded by repeating the last index. The JAX code loops over chunks with
``jax.lax.map`` inside one compiled call; here it is a Python loop
whose chunks run on the device without a host sync.

Under a mesh (``self.mesh``, ``parallel.make_mesh``), as the JAX trainer
under its ``jax.sharding.Mesh``: every rank draws the whole step's
numbers from its identically seeded generator (ray indices, background,
the render's noise), data rank d trains on the d-th contiguous slice of
the rays, the gradients are averaged over ``data`` before the optimizer
step, and the loss, ``turbo_overflow`` and the error map are the whole
batch's. A frame deals its whole chunks to the data ranks (every model
rank of a data group on the same chunk; a chunk keeps its budget's drop
rule) and all-gathers them, so it equals the one-device frame;
``evaluate`` scores through ``eval_metrics_dp``. The fused CP heads step
aside, as in JAX.

``train_gui`` and ``test_gui`` are the GUI loop's two halves
(``viewer.py`` drives them through ``step`` and ``render_frame``).

``evaluate`` scores a split (PSNR, SSIM, and LPIPS with
``lpips_weights``) on the u8 frames
``render_frames`` returns, ``test`` writes a split's frames as PNGs
(and a video where a writer can be imported), ``save_mesh`` samples the
density on a 256^3 lattice through ``NeRFNetwork.density`` (the unfused
module path, as the JAX trainer does) and writes its marching-tetrahedra
iso-surface. ``train_on_dataset(train_ds, valid_ds)`` keeps the best
checkpoint on ``eval_metric`` every ``eval_interval`` epochs.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ngp_tpu_torch import tracing
from ngp_tpu_torch.config import RenderConfig, TrainConfig
from ngp_tpu_torch.data.mesh import save_mesh as write_mesh
from ngp_tpu_torch.data.nerf_dataset import NeRFDataset, rand_poses
from ngp_tpu_torch.data.raysampler import (
    rays_from_frame_indices,
    rays_from_indices,
    sample_ray_indices,
)
from ngp_tpu_torch.models.nerf import NeRFNetwork, make_fused_density
from ngp_tpu_torch.models.renderer import render_rays
from ngp_tpu_torch.ops.losses import eff_distloss
from ngp_tpu_torch.ops.rays import sph_from_ray
from ngp_tpu_torch.parallel.collectives import (
    data_sum,
    eval_metrics_dp,
    gather_predictions_dp,
    rank_budget,
    sync_gradients,
)
from ngp_tpu_torch.parallel.mesh import DATA_AXIS, axis_rank, axis_size, data_slice
from ngp_tpu_torch.training.metrics import LPIPSMeter, PSNRMeter, SSIMMeter
from ngp_tpu_torch.training.trainer import Trainer
from ngp_tpu_torch.utils.color import linear_to_srgb_np
from ngp_tpu_torch.utils.png import write_png


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
        kwargs.setdefault("eval_interval", train_cfg.eval_interval)
        super().__init__(name=name, **kwargs)
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
        # the last save_mesh call: seconds per stage, vertex and face counts
        self.last_mesh_stats: Dict[str, float] = {}
        # image loss of the random-pose guidance steps (clip_guidance), or
        # None: the loader then skips the virtual indices
        self.guidance_loss = None
        # LPIPS weights for evaluate: a path to a torch checkpoint (the
        # --lpips_weights flag) or converted params (training/lpips.py)
        self.lpips_weights = None
        # the inference crop box [xmin, ymin, zmin, xmax, ymax, zmax] of the
        # frame renders, or None for the scene's box
        self.aabb_infer = None
        # train_gui's loader and its iterator, which carry on across calls
        self._gui_loader = None
        self._gui_iter = None

    def init_aux(self):
        return {}

    def _fns(self):
        """(density_fn, color_fn, bg_fn) on the live weights, recording
        autograd when grad mode is on: the fused CP density when the model
        has one (``make_fused_density``) and there is no mesh, else the
        module's; bg_fn is the background net when ``bg_radius > 0``, else
        None."""
        density_fn = make_fused_density(self.model) if self.mesh is None else None
        if density_fn is None:
            density_fn = self.model.density
        bg_fn = self.model.background if self.render_cfg.bg_radius > 0 else None
        return density_fn, self.model.color, bg_fn

    def _eval_fns(self, time=None):
        """The network closures one frame render uses (built once per
        frame, not per chunk): ``_fns`` and a fused radiance closure, which
        this renderer does not have (None), as in JAX. ``time``: the
        frame's scene time, which a static scene ignores."""
        return (*self._fns(), None)

    def _step_fns(self, time=None):
        """The closures a train step renders with: ``_fns`` and no fused
        radiance closure; ``time`` (the batch's scene time, None for a
        static scene) is for the dynamic trainer."""
        return (*self._fns(), None)

    def _step_draws(self, n_rays: int, draws, dev) -> Dict[str, torch.Tensor]:
        """The render's draws for a whole step of ``n_rays`` rays, from
        ``draws`` or, in the order the render draws them, the generator:
        the perturbation noise [n, T] and, with upsampling, the PDF draws
        [n, U]."""
        cfg = self.render_cfg
        out = {"noise": draws.get("noise")}
        if out["noise"] is None:
            out["noise"] = torch.rand((n_rays, cfg.num_steps), generator=self.generator,
                                      device=dev)
        if cfg.upsample_steps > 0:
            out["pdf_u"] = draws.get("pdf_u")
            if out["pdf_u"] is None:
                out["pdf_u"] = torch.rand((n_rays, cfg.upsample_steps),
                                          generator=self.generator, device=dev)
        return out

    def _render_with(self, fns, rays_o, rays_d, bg_color=None, aabb=None,
                     t_range=None, perturb=False, noise=None, pdf_u=None, time=None,
                     train_budget=None):
        """Render one batch of rays with the closures of ``_step_fns``
        (training: ``perturb``) or of ``_eval_fns`` (eval): here the
        uniform + PDF renderer, which takes no per-ray t range and no scene
        time, and has no sample budget (``train_budget`` is not used)."""
        if t_range is not None:
            raise ValueError("t_range needs the occupancy-grid renderer")
        density_fn, color_fn, bg_fn, _ = fns
        return render_rays(density_fn, color_fn, rays_o, rays_d, self.render_cfg,
                           perturb=perturb, bg_color=bg_color, bg_fn=bg_fn, aabb=aabb,
                           generator=self.generator, noise=noise, pdf_u=pdf_u)

    # ---- train -----------------------------------------------------------

    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """batch: images [F, H, W, C], poses [F, 4, 4], intrinsics [4] on
        the device, and the frame index ``idx``. Returns device scalars
        "loss" and, from the grid renderer, "turbo_overflow". Under a
        profiler its phases are the spans ``ngp/batch`` (rays, pixels,
        ground truth, ``zero_grad``), ``ngp/forward`` (the render and the
        loss), ``ngp/backward`` and ``ngp/update`` (``_apply_gradients``)."""
        with tracing.span("batch"):
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
            if C == 4 and self.render_cfg.bg_radius <= 0:
                bg = draws["bg"].to(dev) if "bg" in draws else torch.rand(
                    (n_rays, 3), generator=self.generator, device=dev)
            else:
                bg = 1.0
            rdraws = {k: draws[k] for k in ("noise", "pdf_u") if k in draws}
            mesh, kw = self.mesh, {}
            if mesh is not None:
                # the whole step's draws on every rank, then this data rank's rays
                rdraws = self._step_draws(n_rays, rdraws, dev)
                rows = data_slice(mesh, n_rays)
                inds = inds[rows]
                bg = bg[rows] if torch.is_tensor(bg) else bg
                rdraws = {k: v.to(dev)[rows] for k, v in rdraws.items()}
                whole = n_rays * self.render_cfg.compact_mean_samples
                kw["train_budget"] = lambda n_valid: rank_budget(mesh, n_valid, whole)
            rays = rays_from_indices(pose, intrinsics, H, W, inds)
            pixels = image.reshape(H * W, C)[inds].float()
            gt_rgb = (pixels[:, :3] * pixels[:, 3:] + bg * (1.0 - pixels[:, 3:]) if C == 4
                      else pixels)
            # a dynamic scene's frame time rides the batch (host values)
            time = float(batch["times"][idx]) if "times" in batch else None

            self.optimizer.zero_grad(set_to_none=True)
        with tracing.span("forward"):
            out = self._render_with(self._step_fns(time), rays["rays_o"], rays["rays_d"],
                                    bg_color=bg, perturb=True, noise=rdraws.get("noise"),
                                    pdf_u=rdraws.get("pdf_u"), time=time, **kw)
            per_ray = ((out["image"] - gt_rgb) ** 2).mean(dim=-1)
            loss = per_ray.mean() + self._loss_extra()
            extra = self._render_loss_extra(out)
            if extra is not None:
                loss = loss + extra
            wd = self.train_cfg.distortion_weight
            if wd > 0:
                # per ray slot; padded slots have weight 0 and add nothing
                loss = loss + wd * eff_distloss(out["weights"], out["ts"], out["deltas"])
        with tracing.span("backward"):
            loss.backward()
            if mesh is not None:
                sync_gradients(self.model.parameters(), mesh)
        self._apply_gradients()

        loss, per_ray = loss.detach(), per_ray.detach()
        counts = None
        if "n_dropped" in out:
            counts = torch.stack([out["n_dropped"].float(), out["n_samples"].float()])
        if mesh is not None:
            # the batch's mean loss and counters, and every ray's error
            tot = data_sum(mesh, torch.cat([loss.reshape(1), *([] if counts is None
                                                                else [counts])]))
            loss = tot[0] / axis_size(mesh, DATA_AXIS)
            counts = None if counts is None else tot[1:]
            per_ray = gather_predictions_dp(mesh, per_ray)
        metrics = {"loss": loss}
        if counts is not None:
            metrics["turbo_overflow"] = counts[0] / torch.clamp(counts.sum(), min=1.0)
        if error_map is not None:
            # in place: the map is trainer state that nothing else holds
            em = self.aux["error_map"]
            ic = sample["inds_coarse"]
            em[idx, ic] = 0.1 * em[idx][ic] + 0.9 * per_ray
        return metrics

    def _loss_extra(self):
        """``tv_weight`` times the model's TV loss."""
        wt = self.train_cfg.tv_weight
        return wt * self.model.tv_loss() if wt > 0 else 0.0

    def _render_loss_extra(self, out):
        """A loss term read from the render's output (D-NeRF's deformation
        L1), or None."""
        return None

    # ---- random-pose guidance steps -----------------------------------------

    def guidance_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """Train on a random pose with ``guidance_loss`` instead of ground
        truth (the reference's utils.py:473-488): batch "pose" [4, 4],
        "intrinsics" [4] and the frame size "rH", "rW"; every pixel of
        the frame, white background. ``draws["noise"]`` replaces the
        render's perturbation draw ([rH * rW] for the march, [rH * rW, T]
        for the uniform renderer) and ``draws["pdf_u"]`` its PDF draw."""
        self.ensure_initialized()
        draws = draws or {}
        rH, rW = int(batch["rH"]), int(batch["rW"])
        dev = self.device
        inds = torch.arange(rH * rW, device=dev)
        rays = rays_from_indices(batch["pose"], batch["intrinsics"], rH, rW, inds)
        self.optimizer.zero_grad(set_to_none=True)
        out = self._render_with((*self._fns(), None), rays["rays_o"], rays["rays_d"],
                                bg_color=1.0, perturb=True, noise=draws.get("noise"),
                                pdf_u=draws.get("pdf_u"))
        loss = self.guidance_loss(out["image"].reshape(1, rH, rW, 3))
        loss.backward()
        self._apply_gradients()
        return {"loss": loss.detach()}

    def train_one_epoch(self, loader):
        """Guidance batches go to ``guidance_step`` (counted as steps, with
        the refresh cadence), the others through the base loop."""
        def wrapped():
            for batch in loader:
                if "guidance" in batch:
                    self.on_step_begin()
                    self.guidance_step(batch)
                    self.global_step += 1
                else:
                    yield batch

        super().train_one_epoch(wrapped())

    def make_loader(self, dataset: NeRFDataset):
        """Epoch iterator factory: the split's arrays go to the device
        once, and each step's batch names them and a frame index. A
        virtual index (``rand_pose``) becomes a guidance batch: a random
        orbit pose at the split's radius, the frame scaled by
        s = sqrt(H * W / num_rays) (at least 8 x 8 pixels)."""
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
                    if self.guidance_loss is None:
                        continue
                    pose = rand_poses(np_rng, 1, radius=dataset.radius)[0]
                    s = float(np.sqrt(dataset.H * dataset.W / self.train_cfg.num_rays))
                    yield {"guidance": True, "pose": torch.as_tensor(pose, device=dev),
                           "intrinsics": intrinsics / s,
                           "rH": max(int(dataset.H / s), 8), "rW": max(int(dataset.W / s), 8)}
                    continue
                yield {"images": images, "poses": poses, "intrinsics": intrinsics,
                       "idx": int(idx)}

        return epoch_iter

    def enable_error_map(self, n_frames: int):
        M = self.train_cfg.error_map_size
        self.aux = dict(self.aux)
        self.aux["error_map"] = torch.ones((n_frames, M * M), device=self.device)

    def eval_metric(self, valid) -> float:
        """Best-checkpoint metric: -PSNR over the validation split (lower
        is better)."""
        if not isinstance(valid, NeRFDataset):
            raise TypeError("NeRF trainers evaluate on a NeRFDataset split "
                            f"(got {type(valid).__name__})")
        return -self.evaluate(valid)["psnr"]

    def train_on_dataset(self, train_ds: NeRFDataset,
                         valid_ds: Optional[NeRFDataset] = None, max_epochs: int = 1):
        """Train to ``max_epochs``; with ``valid_ds``, every
        ``eval_interval`` epochs evaluate it and keep the best checkpoint."""
        self.ensure_initialized()
        if self.train_cfg.error_map and train_ds.images is not None:
            if "error_map" not in self.aux:
                self.enable_error_map(len(train_ds))
        self.train(self.make_loader(train_ds), valid_ds, max_epochs)

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
    def render_frames(self, poses, intrinsics, H: int, W: int, chunk: int = 0, times=None):
        """poses [F, 4, 4] -> (images [F, H, W, 3], depths [F, H, W]),
        each frame rendered as its own single-frame group; ``times`` [F]:
        the frames' scene times (a dynamic scene's; a static one ignores
        them). A group of several frames must share one time, as in JAX,
        whose chunks span frames."""
        poses = np.asarray(poses, np.float32)
        F = poses.shape[0]
        if times is not None:
            times = np.asarray(times, np.float32).reshape(-1)
            if F > 1 and np.unique(times).size > 1:
                raise ValueError("render_frames: a multi-frame group must share one scene "
                                 "time; render distinct times one frame per call")
        imgs, deps = [], []
        n_samples = n_dropped = 0.0
        with self._eval_weights():
            for f in range(F):
                time = None if times is None else float(times[f])
                img, dep, stats = self._render_one(poses[f], intrinsics, H, W,
                                                   chunk or self.max_ray_batch, time=time)
                imgs.append(img)
                deps.append(dep)
                n_samples += stats["n_samples"]
                n_dropped += stats["n_dropped"]
        self.last_render_stats = {"n_samples": n_samples, "n_dropped": n_dropped}
        return np.stack(imgs), np.stack(deps)

    def _render_one(self, pose: np.ndarray, intrinsics, H: int, W: int, chunk: int,
                    time=None):
        dev = self.device
        crop = self.render_cfg.aabb if self.aabb_infer is None else self.aabb_infer
        aabb_eff = np.asarray(crop, np.float32)
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
        pre = self._run_eval_prepass(pose_t, intr_t, H, W, aabb_eff, time=time)
        if pre is not None:
            self._set_eval_lattice_span_value(pre["span"])
        n = H * W
        # with the background net and a prepass, the rays the cull drops
        # still see the background: a march-free pass renders it for the
        # whole frame first
        bg_frame = None
        if self.render_cfg.bg_radius > 0 and pre is not None:
            bg_frame = self._render_bg_frames(pose_t, intr_t, H, W)
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
            # the pixel-bbox cull, unless the background net would have to
            # fill the culled pixels and no background pass ran
            bbox = None
            if self.render_cfg.bg_radius <= 0 or bg_frame is not None:
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
        # one spare row takes the writes of the slots that do not win
        images = torch.ones((n + 1, 3), device=dev)
        if bg_frame is not None:
            images[:n] = bg_frame
        depths = torch.zeros((n + 1,), device=dev)
        n_samples = torch.zeros((), device=dev)
        n_dropped = torch.zeros((), device=dev)
        if inds is not None:
            dst = torch.where(self._last_slots(inds, n), inds, n)
            fns = self._eval_fns(time)
            aabb_t = torch.as_tensor(aabb_eff, device=dev)
            fids = torch.zeros((chunk,), dtype=torch.int64, device=dev)
            C = inds.shape[0]
            # under a mesh data rank d renders chunks d, d + D, ...
            D = 1 if self.mesh is None else axis_size(self.mesh, DATA_AXIS)
            mine = range(0 if self.mesh is None else axis_rank(self.mesh, DATA_AXIS), C, D)
            dealt = []
            for c in mine:
                ic = inds[c]
                rays = rays_from_frame_indices(pose_t, intr_t, H, W, ic, fids)
                t_range = None
                if pre is not None:
                    t_range = torch.stack([pre["t0"][ic], pre["t1"][ic]], dim=-1)
                out = self._render_with(fns, rays["rays_o"], rays["rays_d"],
                                        bg_color=1.0, aabb=aabb_t, t_range=t_range, time=time)
                img = torch.clamp(out["image"], 0.0, 1.0)
                dep = out["depth"]
                if not self.eval_f32_frames:
                    img = torch.round(img * 255.0).to(torch.uint8).float() / 255.0
                    dep = dep.to(torch.bfloat16).float()
                if self.mesh is None:
                    images[dst[c]] = img
                    depths[dst[c]] = dep
                else:
                    dealt.append(torch.cat([img, dep[:, None]], dim=-1))
                # the uniform renderer counts no samples; the v1 march has
                # no budget to overflow: 0 dropped
                n_samples += out.get("n_samples", 0.0)
                n_dropped += out.get("n_dropped", 0.0)
            if self.mesh is not None:
                # every rank's chunks, back in chunk order c = j * D + d
                J = -(-C // D)
                mine_out = torch.zeros((J, chunk, 4), device=dev)
                if dealt:
                    mine_out[:len(dealt)] = torch.stack(dealt)
                every = gather_predictions_dp(self.mesh, mine_out)
                every = every.view(D, J, chunk, 4).transpose(0, 1).reshape(J * D, chunk, 4)[:C]
                images[dst.reshape(-1)] = every[..., :3].reshape(-1, 3)
                depths[dst.reshape(-1)] = every[..., 3].reshape(-1)
                n_samples, n_dropped = data_sum(self.mesh, torch.stack([n_samples, n_dropped]))
        stats = {"n_samples": float(n_samples), "n_dropped": float(n_dropped)}
        return (images[:n].reshape(H, W, 3).cpu().numpy(),
                depths[:n].reshape(H, W).cpu().numpy(), stats)

    def _render_bg_frames(self, poses: torch.Tensor, intrinsics: torch.Tensor, H: int,
                          W: int) -> torch.Tensor:
        """The background net alone over a whole frame, [H * W, 3] on the
        device: the rays the eval prepass culls still need the background
        (the reference composites it for dead rays too), but not the march.
        Chunks of 65,536 rays (the last one wraps to the frame's start),
        ``sph_from_ray`` and the bg net, clipped to [0, 1] and, unless
        ``eval_f32_frames``, rounded to u8 levels as the frame chunks are.
        poses [1, 4, 4] and intrinsics [4] on the device."""
        dev = self.device
        n = H * W
        chunk = 65536
        inds = torch.arange(-(-n // chunk) * chunk, device=dev) % n
        fids = torch.zeros((chunk,), dtype=torch.int64, device=dev)
        out = []
        for c in range(inds.shape[0] // chunk):
            rays = rays_from_frame_indices(poses, intrinsics, H, W,
                                           inds[c * chunk:(c + 1) * chunk], fids)
            sph = sph_from_ray(rays["rays_o"], rays["rays_d"], self.render_cfg.bg_radius)
            col = torch.clamp(self.model.background(sph, rays["rays_d"]), 0.0, 1.0)
            if not self.eval_f32_frames:
                col = torch.round(col * 255.0).to(torch.uint8).float() / 255.0
            out.append(col)
        return torch.cat(out)[:n]

    @staticmethod
    def _last_slots(inds: torch.Tensor, n: int) -> torch.Tensor:
        """[C, chunk] bool: True where a slot is the last one holding its
        pixel. The tail padding repeats one pixel, whose copies may
        water-fill differently; the JAX trainer's numpy scatter keeps the
        last copy, where ``index_put_`` would keep an arbitrary one."""
        flat = inds.reshape(-1)
        pos = torch.arange(flat.shape[0], device=inds.device)
        last = torch.full((n,), -1, dtype=pos.dtype, device=inds.device)
        last.scatter_reduce_(0, flat, pos, reduce="amax")
        return (last[flat] == pos).reshape(inds.shape)

    # ---- the GUI loop's two halves (nerf/utils.py:718-829) -------------------

    def train_gui(self, train_ds: NeRFDataset, step: int = 16) -> Dict[str, float]:
        """Run ``step`` train steps on ``train_ds``'s loader, which carries
        on across calls, and report the last loss, the learning rate and
        the seconds taken (reading the loss waits for the device): the
        trainer half of the reference's GUI loop (utils.py:718-776).
        ``viewer.InteractiveSession`` adapts the step count to a budget."""
        self.ensure_initialized()
        if self._gui_loader is None:
            self._gui_loader = self.make_loader(train_ds)
            self._gui_iter = iter(self._gui_loader())
        t0 = time.perf_counter()
        metrics = None
        for _ in range(step):
            try:
                batch = next(self._gui_iter)
            except StopIteration:
                self._gui_iter = iter(self._gui_loader())
                batch = next(self._gui_iter)
            metrics = self.step(batch)
        loss = float(metrics["loss"])
        return {"loss": loss, "lr": self.optimizer.param_groups[0]["lr"],
                "time": time.perf_counter() - t0}

    def test_gui(self, pose, intrinsics, W: int, H: int, bg_color=None, spp: int = 1,
                 downscale: float = 1.0) -> Dict[str, np.ndarray]:
        """Render one view at ``downscale`` and bring it back to (H, W) by
        nearest-neighbour resizing: the render half of the GUI loop
        (utils.py:780-829). ``bg_color`` and ``spp`` are the reference's
        arguments and change nothing, as in JAX."""
        rH, rW = int(H * downscale), int(W * downscale)
        intr = np.asarray(intrinsics, np.float32) * downscale
        image, depth = self.render_frame(pose, intr, rH, rW)
        if downscale != 1.0:
            import cv2

            image = cv2.resize(image, (W, H), interpolation=cv2.INTER_NEAREST)
            depth = cv2.resize(depth, (W, H), interpolation=cv2.INTER_NEAREST)
        return {"image": image, "depth": depth}

    # ---- evaluate, test, mesh export ---------------------------------------

    def evaluate(self, dataset: NeRFDataset, max_frames: Optional[int] = None,
                 with_ssim: bool = False,
                 with_lpips: Optional[bool] = None) -> Dict[str, float]:
        """PSNR (and SSIM, and LPIPS) over the first ``max_frames`` frames
        of a split with the EMA weights, each frame saved as a PNG under
        ``workspace/validation``. LPIPS needs ``lpips_weights``: with
        ``with_lpips`` None it is scored whenever they are set. The meters
        score the u8-quantized frames ``render_frames`` returns (unless
        ``eval_f32_frames``) against the ground truth composited on white,
        as the JAX trainer does; the quantization caps PSNR near 59 dB."""
        meter = PSNRMeter()
        ssim_meter = SSIMMeter() if with_ssim else None
        if with_lpips is None:
            with_lpips = self.lpips_weights is not None
        lpips_meter = None
        if with_lpips:
            lw = self.lpips_weights
            # a dict is converted params, a string a checkpoint's path
            lpips_meter = (LPIPSMeter(params=lw, device=self.device) if isinstance(lw, dict)
                           else LPIPSMeter(weights_path=lw, device=self.device))
        n = len(dataset) if max_frames is None else min(max_frames, len(dataset))
        out_dir = os.path.join(self.workspace, "validation")
        os.makedirs(out_dir, exist_ok=True)
        for i, img in self._render_split(dataset, n):
            gt = dataset.images[i]
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + 1.0 * (1 - gt[..., 3:])
            if self.mesh is None:
                meter.update(img, gt)
            else:
                meter.V += self._psnr_dp(img, gt)
                meter.N += 1
            if ssim_meter is not None:
                ssim_meter.update(img, gt)
            if lpips_meter is not None:
                lpips_meter.update(img, gt)
            self._save_image(os.path.join(out_dir, f"{self.name}_{self.epoch:04d}_{i:04d}.png"),
                             self._export_color(img))
        result = {"psnr": meter.measure()}
        report = meter.report()
        if ssim_meter is not None:
            result["ssim"] = ssim_meter.measure()
            report += ", " + ssim_meter.report()
        if lpips_meter is not None:
            result["lpips"] = lpips_meter.measure()
            report += ", " + lpips_meter.report()
        self.log(f"evaluate: {report} over {n} frames")
        if self.writer is not None:
            for k, v in result.items():
                self.writer.add_scalar(f"eval/{k}", v, self.global_step)
        return result

    def _psnr_dp(self, img: np.ndarray, gt: np.ndarray) -> float:
        """A frame's PSNR through ``eval_metrics_dp``: each data rank scores
        its contiguous share of the pixels (every rank holds the frame)."""
        share = axis_rank(self.mesh, DATA_AXIS)
        D = axis_size(self.mesh, DATA_AXIS)
        p, g = (torch.tensor_split(torch.as_tensor(np.asarray(a, np.float32).reshape(-1, 3),
                                                   device=self.device), D)[share]
                for a in (img, gt))
        return float(eval_metrics_dp(self.mesh, p, g)["psnr"])

    def _render_split(self, dataset: NeRFDataset, n: int) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (index, image [H, W, 3]) over the first n frames of a
        split, one frame per render, at the split's frame times when it
        has them. Synchronous: the JAX trainer pipelines its frame groups
        one dispatch deep for a remote TPU."""
        all_times = getattr(dataset, "times", None)
        for i in range(n):
            times = None
            if all_times is not None and len(all_times) > i:
                times = np.asarray(all_times[i:i + 1], np.float32)
            imgs, _ = self.render_frames(np.asarray(dataset.poses[i:i + 1], np.float32),
                                         dataset.intrinsics, dataset.H, dataset.W, times=times)
            yield i, imgs[0]

    def test(self, dataset: NeRFDataset, write_video: bool = True) -> str:
        """Render a split into ``workspace/results``: one PNG per frame
        and, where imageio or cv2 can be imported, a video."""
        out_dir = os.path.join(self.workspace, "results")
        os.makedirs(out_dir, exist_ok=True)
        frames = []
        for i, img in self._render_split(dataset, len(dataset)):
            img = self._export_color(img)
            frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
            self._save_image(os.path.join(out_dir, f"{self.name}_{i:04d}_rgb.png"), img)
        if write_video and frames and self._writes():
            self._write_video(out_dir, frames)
        return out_dir

    def _write_video(self, out_dir: str, frames) -> None:
        """An mp4 through imageio, else an MJPG avi through cv2, else only
        the PNG frames (the JAX trainer's fallback chain)."""
        path = os.path.join(out_dir, f"{self.name}.mp4")
        try:
            import imageio

            imageio.mimwrite(path, frames, fps=25, quality=8)
            self.log(f"wrote video {path}")
            return
        except Exception as e:  # no imageio, or no ffmpeg backend for it
            self.log(f"no mp4 ({type(e).__name__}: {e}); trying cv2")
        try:
            import cv2

            avi = os.path.join(out_dir, f"{self.name}.avi")
            h, w = frames[0].shape[:2]
            vw = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"MJPG"), 25, (w, h))
            for f in frames:
                vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            vw.release()
            self.log(f"wrote video {avi} (MJPG fallback)")
        except Exception as e:
            self.log(f"video export failed ({e}); frames saved as PNG")

    def _export_color(self, img: np.ndarray) -> np.ndarray:
        """A model trained on linear images predicts linear radiance:
        convert it for PNG and video export. Metrics stay in the training
        space."""
        if self.train_cfg.color_space == "linear":
            return linear_to_srgb_np(img)
        return img

    def _save_image(self, path: str, img: np.ndarray):
        if self._writes():
            write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))

    @torch.no_grad()
    def density_grid(self, resolution: int = 256) -> np.ndarray:
        """sigma [R, R, R] (numpy f32) on the ``ij`` lattice of
        ``linspace(-bound, bound, R)`` per axis, with the EMA weights,
        through ``NeRFNetwork.density`` in chunks of 2^16 points (the
        last one zero-padded), as the JAX trainer's ``save_mesh`` samples
        it."""
        b = self.render_cfg.bound
        xs = torch.as_tensor(np.linspace(-b, b, resolution, dtype=np.float32),
                             device=self.device)
        pts = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), dim=-1).reshape(-1, 3)
        chunk = 2**16
        pad = (-pts.shape[0]) % chunk
        if pad:
            pts = torch.cat([pts, torch.zeros((pad, 3), device=self.device)])
        sig = []
        with self._eval_weights():
            for i in range(0, pts.shape[0], chunk):
                sigma, _ = self.model.density(pts[i:i + chunk])
                sig.append(sigma)
        sigma = torch.cat(sig)[: resolution**3].reshape(resolution, resolution, resolution)
        return sigma.cpu().numpy()

    def save_mesh(self, path: Optional[str] = None, resolution: int = 256,
                  threshold: float = 10.0) -> str:
        """The iso-surface sigma = ``threshold`` of ``density_grid`` by
        marching tetrahedra, scaled to [-bound, bound]^3 and written to
        ``path`` (default ``workspace/meshes/<name>_<epoch>.obj``). Under
        a mesh every rank samples the density, and rank 0 writes."""
        from ngp_tpu_torch import native

        self.ensure_initialized()
        if path is None:
            path = os.path.join(self.workspace, "meshes", f"{self.name}_{self.epoch}.obj")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        t0 = time.perf_counter()
        sigma = self.density_grid(resolution)
        if not self._writes():
            return path
        t1 = time.perf_counter()
        verts, faces = native.marching_cubes(sigma, threshold)
        b = self.render_cfg.bound
        verts = verts / (resolution - 1) * 2 * b - b
        t2 = time.perf_counter()
        write_mesh(path, verts, faces)
        self.last_mesh_stats = {"density_s": t1 - t0, "marching_s": t2 - t1,
                                "write_s": time.perf_counter() - t2,
                                "n_verts": len(verts), "n_faces": len(faces)}
        self.log(f"saved mesh {path} ({len(verts)} verts)")
        return path

    # hooks the occupancy-grid trainer fills in
    def _fetch_eval_tight_box(self):
        return None

    def _set_eval_lattice_span(self, aabb_eff):
        pass

    def _set_eval_lattice_span_value(self, span: float):
        pass

    def _run_eval_prepass(self, poses, intrinsics, H, W, aabb_eff, time=None):
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
