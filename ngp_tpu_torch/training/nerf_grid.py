"""Occupancy-grid NeRF trainer (``-O`` path;
``ngp_tpu/training/nerf_grid.py:GridNeRFTrainer``).

With ``RenderConfig.turbo`` (the ``-O`` presets), train steps march
with a perturbed lattice start and the training budget
(``compact_mean_samples`` per ray, ray-major tail drop), and eval frames
go through the turbo march with the JAX trainer's eval dials and
defaults: a water-filled budget of ``eval_mean_samples`` samples per
ray, 64 coarse candidates, tight marching inside the occupied box, and
the two-round prepass at pixel stride 2. Without it (the hash-grid
configuration, ``-O --encoding hashgrid``) both go through the v1 march
(``render_rays_grid``: the first ``max_samples_per_ray`` occupied probes
per ray); the prepass and the tight box stay turbo-only, as in JAX.
``eval_max_samples`` and ``eval_probe_stride`` are eval dials of both.
The density grid is refreshed from the live weights every
``update_extra_interval`` steps (``on_step_begin``). With ``bg_radius >
0`` both marches composite the background net, and a frame whose
prepass culls rays first renders the background alone
(``_render_bg_frames``).

A time-sliced (D-NeRF) occupancy state shares the stack through two
hooks: ``_occ_at(time)`` gives the state a render at scene time ``time``
marches (here the whole static state), and the eval prepass runs on a
time-sliced state only where ``_prepass_time_sliced`` says so, on the
slice at the frame's time (JAX's ``_prepass_occ``). A time-sliced state
has no tight eval box, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as tnf

from ngp_tpu_torch import tracing
from ngp_tpu_torch.data.raysampler import rays_from_frame_indices
from ngp_tpu_torch.models.nerf import NeRFNetwork, make_fused_sigma_rgb
from ngp_tpu_torch.models.occupancy import (
    SQRT3,
    init_occupancy,
    mark_untrained_grid,
    occupied_aabb,
    pack_occupancy_payloads,
    pack_prepass_payload,
    prepass_spacing,
    ray_prepass,
    render_rays_grid,
    render_rays_grid_turbo,
    update_occupancy,
)
from ngp_tpu_torch.training.checkpoints import tolerant_merge
from ngp_tpu_torch.training.nerf import NeRFTrainer


class GridNeRFTrainer(NeRFTrainer):
    _prepass_time_sliced = False  # the eval prepass on a time-sliced state

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # eval dials (see the JAX trainer for what each one trades);
        # None = the render config's value
        self.eval_max_samples: Optional[int] = None
        self.eval_probe_stride: int = 1
        self.eval_mean_samples: Optional[int] = 6
        self.eval_coarse_candidates: Optional[int] = 64
        self.eval_tight_march: bool = True
        self.eval_prepass: bool = True
        self.eval_prepass_stride: int = 2
        self._eval_lattice_span: Optional[float] = None
        self._span_sticky = 0.0
        self._tight_box_for = None
        self._tight_box_cache = None

    def init_aux(self):
        return {"occ": init_occupancy(self.render_cfg, self.device)}

    def _eval_fns(self, time=None):
        """``_fns`` and the fused radiance closure, which only the
        ``NeRFNetwork`` has (TensoRF and the other families render with
        their density and colour closures, as in JAX), and not under a
        mesh (as in JAX)."""
        vals_fn = None
        if type(self.model) is NeRFNetwork and self.mesh is None:
            vals_fn = make_fused_sigma_rgb(self.model)
        return (*self._fns(), vals_fn)

    @torch.no_grad()
    def render_batch(self, rays_o, rays_d, bg_color=None, aabb=None, t_range=None):
        return self._render_with(self._eval_fns(), rays_o, rays_d, bg_color=bg_color,
                                 aabb=aabb, t_range=t_range)

    def _occ_at(self, time):
        """The occupancy state a render at scene time ``time`` marches: a
        static scene's whole state."""
        return self.aux["occ"]

    def _step_draws(self, n_rays: int, draws, dev):
        """The march's draw for a whole step: its lattice noise [n]."""
        noise = draws.get("noise")
        if noise is None:
            noise = torch.rand((n_rays,), generator=self.generator, device=dev)
        return {"noise": noise}

    def _render_with(self, fns, rays_o, rays_d, bg_color=None, aabb=None,
                     t_range=None, perturb=False, noise=None, pdf_u=None, time=None,
                     return_geo=False, train_budget=None):
        """The turbo or the v1 march on ``_occ_at(time)`` (the grid renders
        draw no PDF samples: ``pdf_u`` is not used); ``return_geo`` as the
        renders take it, ``train_budget`` as the turbo render takes it (the
        v1 march has no budget)."""
        cfg = self.render_cfg
        density_fn, color_fn, bg_fn, vals_fn = fns
        occ = self._occ_at(time)
        if perturb:
            # training: the config's own budgets, no eval dials
            kw = {"train_budget": train_budget} if cfg.turbo else {}
            render = render_rays_grid_turbo if cfg.turbo else render_rays_grid
            return render(density_fn, color_fn, rays_o, rays_d, occ, cfg,
                          bg_color=bg_color, aabb=aabb, t_range=t_range, perturb=True,
                          generator=self.generator, noise=noise, bg_fn=bg_fn,
                          return_geo=return_geo, **kw)
        over = {}
        if self.eval_probe_stride > 1:
            over["max_steps"] = max(cfg.max_steps // self.eval_probe_stride, 16)
        if self.eval_coarse_candidates is not None:
            over["coarse_candidates"] = int(self.eval_coarse_candidates)
        if self._eval_lattice_span is not None and cfg.turbo:
            over["lattice_span"] = float(self._eval_lattice_span)
        cfg = dataclasses.replace(cfg, **over)
        max_samples = self.eval_max_samples
        if not cfg.turbo:
            return render_rays_grid(density_fn, color_fn, rays_o, rays_d, occ, cfg,
                                    bg_color=bg_color, max_samples=max_samples, aabb=aabb,
                                    t_range=t_range, bg_fn=bg_fn, return_geo=return_geo)
        S = max_samples or cfg.max_samples_per_ray
        ems = self.eval_mean_samples
        budget = rays_o.shape[0] * (S if ems is None else min(ems, S))
        return render_rays_grid_turbo(
            density_fn, color_fn, rays_o, rays_d, occ, cfg,
            bg_color=bg_color, max_samples=max_samples, budget=budget, aabb=aabb,
            t_range=t_range, vals_fn=None if return_geo else vals_fn, bg_fn=bg_fn,
            return_geo=return_geo,
        )

    def _fetch_eval_tight_box(self):
        """Occupied-region AABB [6] (numpy), cached per grid state."""
        occ = self.aux["occ"]
        if not (self.render_cfg.turbo and self.eval_tight_march) or occ.occ_grid.ndim != 4:
            return None
        if self._tight_box_for is not occ:
            self._tight_box_cache = (
                occupied_aabb(occ, self.render_cfg).cpu().numpy().astype(np.float32)
            )
            self._tight_box_for = occ
        return self._tight_box_cache

    def _set_eval_lattice_span(self, aabb_eff: np.ndarray) -> None:
        """Lattice span from the eval box's diameter, in 1/8-chord buckets."""
        chord = 2.0 * SQRT3 * self.render_cfg.bound
        span = float(np.linalg.norm(np.maximum(aabb_eff[3:] - aabb_eff[:3], 0)))
        q = chord / 8.0
        bucket = min(math.ceil(max(span, q) / q) * q, chord)
        self._eval_lattice_span = None if bucket >= chord else bucket

    def _set_eval_lattice_span_value(self, span: float) -> None:
        """Lattice span from the prepass's longest [t0, t1], in 1/16-chord
        buckets. Sticky maximum: it only grows, as in the JAX trainer,
        and it sets the probe count K and with it the march's samples."""
        chord = 2.0 * SQRT3 * self.render_cfg.bound
        q = chord / 16.0
        bucket = min(math.ceil(max(float(span), q) / q) * q, chord)
        bucket = max(bucket, self._span_sticky)
        self._span_sticky = bucket
        self._eval_lattice_span = None if bucket >= chord else bucket

    def _run_eval_prepass(self, poses, intrinsics, H: int, W: int, aabb_eff, time=None):
        """Frame-level eval cull (``occupancy.ray_prepass``) for a single
        frame: "t0"/"t1" per pixel, "span" (longest hit interval),
        "sorted_inds" (the frame permutation stably sorted hit-first)
        and "count" (hit rays); None when the prepass is off. A
        time-sliced state is probed at the frame's ``time`` (0 when None),
        where ``_prepass_time_sliced`` allows it."""
        cfg = self.render_cfg
        if not (self.eval_prepass and cfg.turbo):
            return None
        if self.aux["occ"].occ_grid.ndim != 4 and not self._prepass_time_sliced:
            return None
        dev = self.device
        occ = self._occ_at(0.0 if time is None else time)
        n = H * W
        s = max(int(self.eval_prepass_stride), 1)
        Hs, Ws = -(-H // s), -(-W // s)
        ns = Hs * Ws
        chunk = 65536
        Cp = -(-ns // chunk)
        if s == 1:
            inds = np.arange(n, dtype=np.int64)
        else:
            rows = np.minimum(np.arange(Hs) * s, H - 1)
            cols = np.minimum(np.arange(Ws) * s, W - 1)
            inds = (rows[:, None] * W + cols[None, :]).reshape(-1)
        pad = Cp * chunk - ns
        if pad:
            inds = np.concatenate([inds, np.full(pad, inds[-1])])
        inds = torch.as_tensor(inds, device=dev)
        pcfg = dataclasses.replace(cfg, lattice_span=self._eval_lattice_span)
        h_sp = prepass_spacing(pcfg)
        aabb_t = torch.as_tensor(aabb_eff, device=dev)
        fids = torch.zeros((chunk,), dtype=torch.int64, device=dev)
        hits, t0s, t1s = [], [], []
        for c in range(Cp):
            rays = rays_from_frame_indices(poses, intrinsics, H, W,
                                           inds[c * chunk:(c + 1) * chunk], fids)
            out = ray_prepass(rays["rays_o"], rays["rays_d"], occ, pcfg, aabb=aabb_t)
            zero = torch.zeros((), device=dev)
            hits.append(out["hit"])
            t0s.append(torch.where(out["hit"], out["t0"], zero))
            t1s.append(torch.where(out["hit"], out["t1"], zero))
        hits, t0s, t1s = torch.cat(hits), torch.cat(t0s), torch.cat(t1s)
        if s > 1:
            # stride reconstruction: 3x3 dilation over the probe grid
            # (hit = any, t0 = min - h, t1 = max + h), then
            # nearest-upsample to full resolution
            hit_g = hits[:ns].reshape(1, 1, Hs, Ws)
            inf = torch.tensor(math.inf, device=dev)
            t0_g = torch.where(hit_g, t0s[:ns].reshape(1, 1, Hs, Ws), inf)
            t1_g = torch.where(hit_g, t1s[:ns].reshape(1, 1, Hs, Ws), -inf)
            hit_d = tnf.max_pool2d(hit_g.float(), 3, stride=1, padding=1)[0, 0] > 0.0
            t0_d = -tnf.max_pool2d(-t0_g, 3, stride=1, padding=1)[0, 0] - h_sp
            t1_d = tnf.max_pool2d(t1_g, 3, stride=1, padding=1)[0, 0] + h_sp
            rmap = torch.arange(H, device=dev) // s
            cmap = torch.arange(W, device=dev) // s
            hit_full = hit_d[rmap][:, cmap]
            zero = torch.zeros((), device=dev)
            t0_full = torch.where(hit_full, t0_d[rmap][:, cmap], zero)
            t1_full = torch.where(hit_full, t1_d[rmap][:, cmap], zero)
            hit_flat = hit_full.reshape(-1)
            t0_out, t1_out = t0_full.reshape(-1), t1_full.reshape(-1)
            spans = torch.where(hit_full, t1_full - t0_full, zero)
        else:
            hit_flat = hits[:n]
            t0_out, t1_out = t0s, t1s
            spans = torch.where(hits, t1s - t0s, torch.zeros((), device=dev))
        perm = torch.as_tensor(self._frame_perm(n), device=dev)
        order = torch.sort((~hit_flat[perm]).to(torch.int8), stable=True).indices
        meta = torch.stack([hit_flat.sum().float(), spans.max()]).cpu().numpy()
        return {
            "t0": t0_out, "t1": t1_out, "span": float(meta[1]),
            "sorted_inds": perm[order], "count": int(meta[0]),
        }

    @torch.no_grad()
    @tracing.traced("refresh")
    def _update_occupancy(self):
        """Refresh the density grid from the live (not the EMA) weights."""
        density_fn = self._fns()[0]
        self.aux = dict(self.aux)
        self.aux["occ"] = update_occupancy(
            self.aux["occ"], density_fn, self.render_cfg, generator=self.generator,
            density_scale=self.render_cfg.density_scale,
        )

    def on_step_begin(self):
        if self.global_step % self.train_cfg.update_extra_interval == 0:
            self._update_occupancy()

    def reset_extra_state(self):
        """Back to the initial, fully occupied grid."""
        self.aux = dict(self.aux)
        self.aux["occ"] = init_occupancy(self.render_cfg, self.device)

    def mark_untrained(self, poses, intrinsics, H_img: int, W_img: int):
        """Cull the cells no training camera sees; call once before training."""
        self.aux = dict(self.aux)
        self.aux["occ"] = mark_untrained_grid(self.aux["occ"], poses, intrinsics,
                                              H_img, W_img, self.render_cfg)

    def train_on_dataset(self, train_ds, valid_ds=None, max_epochs: int = 1):
        if self.epoch == 0:  # a fresh run culls never-seen cells
            self.mark_untrained(train_ds.poses, train_ds.intrinsics, train_ds.H, train_ds.W)
        super().train_on_dataset(train_ds, valid_ds, max_epochs)

    def _aux_state(self):
        occ = self.aux["occ"]
        sd = {f.name: getattr(occ, f.name) for f in dataclasses.fields(occ)}
        out = {"occ": sd}
        if "error_map" in self.aux:
            out["error_map"] = self.aux["error_map"]
        return out

    def _load_aux_state(self, sd, skipped):
        """The occupancy state field by field onto the fresh one
        (``tolerant_merge``), and the error map when it was saved."""
        occ = self.aux["occ"]
        fresh = {f.name: getattr(occ, f.name) for f in dataclasses.fields(occ)}
        merged = tolerant_merge(fresh, sd.get("occ"), "aux/occ", skipped)
        self.aux = {"occ": type(occ)(**merged).to(self.device)}
        if "error_map" in sd:
            self.aux["error_map"] = sd["error_map"].to(self.device)

    def _post_restore(self, skipped):
        """Repack the march's payloads from the restored grids when the
        restore skipped any of them (they are functions of ``occ_grid``
        and ``density_grid``)."""
        if not any(k.startswith("aux/occ/") and "payload" in k for k in skipped):
            return
        occ = self.aux["occ"]
        # a time-sliced state packs each slice
        sliced = occ.occ_grid.ndim == 5
        grids = zip(occ.occ_grid, occ.density_grid) if sliced else [(occ.occ_grid,
                                                                      occ.density_grid)]
        packed = [(*pack_occupancy_payloads(og, dg), pack_prepass_payload(og)) for og, dg in grids]
        coarse, fine, pre = (torch.stack(p) if sliced else p[0] for p in zip(*packed))
        self.aux = dict(self.aux)
        self.aux["occ"] = dataclasses.replace(occ, coarse_payload=coarse, fine_payload=fine,
                                              prepass_payload=pre)
