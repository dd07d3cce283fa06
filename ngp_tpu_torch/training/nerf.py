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

``evaluate`` scores a split (PSNR, SSIM) on the u8 frames
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

from ngp_tpu_torch.config import RenderConfig, TrainConfig
from ngp_tpu_torch.data.mesh import save_mesh as write_mesh
from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
from ngp_tpu_torch.data.raysampler import (
    rays_from_frame_indices,
    rays_from_indices,
    sample_ray_indices,
)
from ngp_tpu_torch.models.nerf import NeRFNetwork
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
        # the last save_mesh call: seconds per stage, vertex and face counts
        self.last_mesh_stats: Dict[str, float] = {}

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
        epoch_iter = self.make_loader(train_ds)
        for epoch in range(self.epoch + 1, max_epochs + 1):
            self.epoch = epoch
            self.train_one_epoch(epoch_iter())
            if (epoch == max_epochs
                    or time.time() - self._last_ckpt_time > self.ckpt_min_interval_s):
                self.save_checkpoint()
                self._last_ckpt_time = time.time()
            if valid_ds is not None and epoch % self.eval_interval == 0:
                metric = self.eval_metric(valid_ds)
                if self.stats["best_loss"] is None or metric < self.stats["best_loss"]:
                    self.stats["best_loss"] = metric
                    self.save_checkpoint(best=True)

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
        # one spare row takes the writes of the slots that do not win
        images = torch.ones((n + 1, 3), device=dev)
        depths = torch.zeros((n + 1,), device=dev)
        n_samples = torch.zeros((), device=dev)
        n_dropped = torch.zeros((), device=dev)
        if inds is not None:
            dst = torch.where(self._last_slots(inds, n), inds, n)
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
                images[dst[c]] = img
                depths[dst[c]] = dep
                n_samples += out["n_samples"]
                n_dropped += out["n_dropped"]
        stats = {"n_samples": float(n_samples), "n_dropped": float(n_dropped)}
        return (images[:n].reshape(H, W, 3).cpu().numpy(),
                depths[:n].reshape(H, W).cpu().numpy(), stats)

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

    # ---- evaluate, test, mesh export ---------------------------------------

    def evaluate(self, dataset: NeRFDataset, max_frames: Optional[int] = None,
                 with_ssim: bool = False, with_lpips: bool = False) -> Dict[str, float]:
        """PSNR (and SSIM) over the first ``max_frames`` frames of a split
        with the EMA weights, each frame saved as a PNG under
        ``workspace/validation``. The meters score the u8-quantized
        frames ``render_frames`` returns (unless ``eval_f32_frames``)
        against the ground truth composited on white, as the JAX trainer
        does; the quantization caps PSNR near 59 dB."""
        meter = PSNRMeter()
        ssim_meter = SSIMMeter() if with_ssim else None
        if with_lpips:
            LPIPSMeter()  # raises: not ported
        n = len(dataset) if max_frames is None else min(max_frames, len(dataset))
        out_dir = os.path.join(self.workspace, "validation")
        os.makedirs(out_dir, exist_ok=True)
        for i, img in self._render_split(dataset, n):
            gt = dataset.images[i]
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + 1.0 * (1 - gt[..., 3:])
            meter.update(img, gt)
            if ssim_meter is not None:
                ssim_meter.update(img, gt)
            self._save_image(os.path.join(out_dir, f"{self.name}_{self.epoch:04d}_{i:04d}.png"),
                             self._export_color(img))
        result = {"psnr": meter.measure()}
        report = meter.report()
        if ssim_meter is not None:
            result["ssim"] = ssim_meter.measure()
            report += ", " + ssim_meter.report()
        self.log(f"evaluate: {report} over {n} frames")
        return result

    def _render_split(self, dataset: NeRFDataset, n: int) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (index, image [H, W, 3]) over the first n frames of a
        split, one frame per render. Synchronous: the JAX trainer
        pipelines its frame groups one dispatch deep for a remote TPU."""
        for i in range(n):
            imgs, _ = self.render_frames(np.asarray(dataset.poses[i:i + 1], np.float32),
                                         dataset.intrinsics, dataset.H, dataset.W)
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
        if write_video and frames:
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

    @staticmethod
    def _save_image(path: str, img: np.ndarray):
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
        ``path`` (default ``workspace/meshes/<name>_<epoch>.obj``)."""
        from ngp_tpu_torch import native

        self.ensure_initialized()
        if path is None:
            path = os.path.join(self.workspace, "meshes", f"{self.name}_{self.epoch}.obj")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        t0 = time.perf_counter()
        sigma = self.density_grid(resolution)
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
