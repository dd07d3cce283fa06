"""D-NeRF trainer: the time-sliced occupancy grid and the deformation
L1 (``ngp_tpu/training/dnerf.py``; the reference's dnerf/utils.py and the
dynamic parts of dnerf/renderer.py).

- ``TimeOccupancyState``: the density grid gains a time axis [T, CAS, H,
  H, H] (renderer.py:92), with the turbo march's payloads per slice;
  ``slice_at_time`` is the static state of the slice floor(time * T)
  (renderer.py:285), views of the time-sliced tensors.
- The refresh (renderer.py:463-550, JAX's schedule): the first 16
  refreshes sweep all T slices; later ones rotate over a quarter of them,
  rounded up to whole blocks of ``refresh_time_chunk`` slices
  (``refresh_slices``). Each slice is refreshed at its time (i + 0.5) / T
  jittered by +-0.5 / T, through ``update_occupancy`` on the slice, and
  written back in place (the grids are the trainer's own, and a copy of
  the 1 GB full-size grid per refresh would be waste); ``mean_density``
  is then taken over the full grid, and the grid freezes after
  ``freeze_after`` refreshes. JAX refreshes in blocks of 16 slices only
  because a larger ``lax.map`` faulted its TPU; here the slices of a
  refresh go one at a time, and the set refreshed on each call is JAX's.
- Training shares the static trainer's step (``NeRFTrainer.train_step``):
  the loader's batches carry the frames' ``times``, the render marches
  the slice at the batch's time with the closures at that time, and
  ``_render_loss_extra`` adds 1e-3 times the L1 of the deformation over
  the valid samples (dnerf/utils.py:117-119). Frames render at their
  time (``render_frame(..., time=)``), with the eval prepass on the slice;
  there is no tight eval box and no fused radiance closure, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ngp_tpu_torch import tracing
from ngp_tpu_torch.config import RenderConfig
from ngp_tpu_torch.models.occupancy import (
    OccupancyState,
    pack_occupancy_payloads,
    pack_prepass_payload,
    update_occupancy,
)
from ngp_tpu_torch.parallel.collectives import data_sum
from ngp_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
from ngp_tpu_torch.training.nerf import NeRFTrainer
from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer


@dataclasses.dataclass
class TimeOccupancyState:
    """[T]-sliced ``OccupancyState`` (dnerf/renderer.py:92-100): the
    density and occupancy grids [T, CAS, H, H, H] and each slice's turbo
    payloads [T, ...]; one mean density and refresh count."""

    density_grid: torch.Tensor
    occ_grid: torch.Tensor
    mean_density: torch.Tensor
    iter_density: int
    coarse_payload: torch.Tensor
    fine_payload: torch.Tensor
    prepass_payload: torch.Tensor

    def to(self, device) -> "TimeOccupancyState":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "iter_density"
        })


def init_time_occupancy(cfg: RenderConfig, device="cuda") -> TimeOccupancyState:
    """Every slice fully occupied, density 0; the payloads packed once and
    copied to every slice."""
    H, cas, T = cfg.grid_size, cfg.cascades, cfg.time_size
    occ = torch.ones((T, cas, H, H, H), dtype=torch.bool, device=device)
    coarse, fine = pack_occupancy_payloads(occ[0])
    pre = pack_prepass_payload(occ[0])
    return TimeOccupancyState(
        density_grid=torch.zeros((T, cas, H, H, H), device=device),
        occ_grid=occ,
        mean_density=torch.zeros((), device=device),
        iter_density=0,
        coarse_payload=coarse.expand(T, *coarse.shape).clone(),
        fine_payload=fine.expand(T, *fine.shape).clone(),
        prepass_payload=pre.expand(T, *pre.shape).clone(),
    )


def time_index(time, T: int) -> int:
    """The slice of scene time ``time``: floor(time * T) in f32, clipped
    to [0, T - 1] (dnerf/renderer.py:285)."""
    return int(np.clip(np.floor(np.float32(time) * np.float32(T)), 0, T - 1))


def slice_at_time(state: TimeOccupancyState, time, cfg: RenderConfig) -> OccupancyState:
    """The static state of the slice nearest ``time`` (views, no copy)."""
    t = time_index(time, cfg.time_size)
    return OccupancyState(
        density_grid=state.density_grid[t], occ_grid=state.occ_grid[t],
        mean_density=state.mean_density, iter_density=state.iter_density,
        coarse_payload=state.coarse_payload[t], fine_payload=state.fine_payload[t],
        prepass_payload=state.prepass_payload[t],
    )


def refresh_slices(iter_density: int, T: int, chunk: int, cursor: int) -> Tuple[List[int], int]:
    """(the slices a refresh updates, the next cursor): all T slices for
    the first 16 refreshes (or when T fits one block), else a quarter of
    them rounded up to whole blocks of C slices, from the rotating cursor
    (JAX's schedule; C is ``chunk`` cut down to a divisor of T)."""
    C = min(chunk, T)
    while T % C:
        C -= 1
    if iter_density < 16 or T <= C:
        starts = list(range(0, T, C))
    else:
        q = -(-max(T // 4, C) // C) * C
        starts = [(cursor + j) % T for j in range(0, q, C)]
        cursor = (cursor + q) % T
    return [t0 + j for t0 in starts for j in range(C)], cursor


class DNeRFTrainer(GridNeRFTrainer):
    """Trains ``DNeRFNetwork``, ``DNeRFHyperNetwork`` or
    ``DNeRFBasisNetwork`` on the shared stack (see the module docstring)."""

    deform_reg_weight = 1e-3  # dnerf/utils.py:117-119
    freeze_after = 100  # dnerf/renderer.py:500
    refresh_time_chunk = 16  # JAX's block of slices, which sets the quarter's rounding
    _prepass_time_sliced = True  # the eval prepass runs on the frame time's slice

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._refresh_cursor = 0
        # the slices the last refresh updated (the schedule, for the tests)
        self.last_refresh_slices: List[int] = []

    def init_aux(self):
        return {"occ": init_time_occupancy(self.render_cfg, self.device)}

    def _occ_at(self, time):
        return slice_at_time(self.aux["occ"], 0.0 if time is None else time, self.render_cfg)

    # ---- rendering ----------------------------------------------------------

    def _fns(self, time=0.0):
        """Closures at scene time ``time``: the density closure's geometry
        output is (geo, dx), which the colour closure and the deformation
        L1 read."""
        model = self.model

        def density_fn(x):
            sigma, geo, dx = model.density(x, time)
            return sigma, (geo, dx)

        def color_fn(d, geo_pack):
            return model.color(d, geo_pack[0])

        return density_fn, color_fn, None

    def _eval_fns(self, time=None):
        """The closures at ``time`` (0 when None) and no fused radiance
        closure, for frames and train steps alike."""
        return (*self._fns(0.0 if time is None else time), None)

    _step_fns = _eval_fns

    def _render_with(self, fns, rays_o, rays_d, **kw):
        """The grid render on the slice at ``kw["time"]``, always with the
        geometry output: "deform" (dx per sample) and "sample_mask" (which
        samples are valid)."""
        out = super()._render_with(fns, rays_o, rays_d, **{**kw, "return_geo": True})
        geo = out.pop("geo", None)
        if geo is not None:
            out["deform"] = geo[1]
            out["sample_mask"] = out.pop("compact_valid")
        return out

    def _render_loss_extra(self, out):
        """The deformation's L1 over valid samples (dnerf/utils.py:117-119);
        under a mesh over the whole batch's samples: each data rank's sum
        over the batch's count, times D, since the ranks' losses are
        averaged."""
        deform = out.get("deform")
        if deform is None:
            return None
        dmask = out["sample_mask"][..., None].float()
        num, count = (deform.abs() * dmask).sum(), dmask.sum()
        if self.mesh is not None:
            num = num * axis_size(self.mesh, DATA_AXIS)
            count = data_sum(self.mesh, count)
        reg = num / (count * 3 + 1e-6)
        return self.deform_reg_weight * reg

    @torch.no_grad()
    def render_frame(self, pose, intrinsics, H: int, W: int, chunk: int = 0, time: float = 0.0):
        """One frame at scene ``time`` through the shared frame renderer."""
        imgs, deps = self.render_frames(np.asarray(pose, np.float32)[None], intrinsics, H, W,
                                        chunk=chunk, times=np.asarray([time], np.float32))
        return imgs[0], deps[0]

    # ---- occupancy: all slices, then a rotating quarter, frozen after 100 -----

    @torch.no_grad()
    @tracing.traced("refresh")
    def _update_occupancy(self, draws=None):
        """One refresh of the slices the schedule picks. ``draws`` maps each
        refreshed slice to its draws ("time_u", the time jitter's uniform
        draw; "jitter" and "slab_x0" as ``update_occupancy`` takes them);
        the generator draws whatever it leaves out."""
        occ: TimeOccupancyState = self.aux["occ"]
        if occ.iter_density >= self.freeze_after:
            self.last_refresh_slices = []
            return  # frozen (dnerf/renderer.py:500)
        cfg = self.render_cfg
        T = cfg.time_size
        slices, self._refresh_cursor = refresh_slices(occ.iter_density, T,
                                                      self.refresh_time_chunk,
                                                      self._refresh_cursor)
        half_t = 0.5 / T
        for t in slices:
            d = (draws or {}).get(t, {})
            time = (t + 0.5) / T
            u = d.get("time_u")
            u = (torch.rand((), generator=self.generator, device=self.device) if u is None
                 else torch.as_tensor(u, dtype=torch.float32, device=self.device))
            density_fn = self._fns(time + (u * 2 - 1) * half_t)[0]
            new = update_occupancy(slice_at_time(occ, time, cfg), density_fn, cfg,
                                   generator=self.generator,
                                   density_scale=cfg.density_scale,
                                   jitter=d.get("jitter"), slab_x0=d.get("slab_x0"))
            # in place: the slice views' storage is the trainer's own state
            for f in ("density_grid", "occ_grid", "coarse_payload", "fine_payload",
                      "prepass_payload"):
                getattr(occ, f)[t].copy_(getattr(new, f))
        self.last_refresh_slices = slices
        self.aux = dict(self.aux)
        # the mean over the full grid (renderer.py:537), exact however many
        # slices this refresh touched
        self.aux["occ"] = dataclasses.replace(
            occ, mean_density=torch.clamp(occ.density_grid, min=0.0).mean(),
            iter_density=occ.iter_density + 1)

    def reset_extra_state(self):
        self.aux = dict(self.aux)
        self.aux["occ"] = init_time_occupancy(self.render_cfg, self.device)

    # ---- data ---------------------------------------------------------------

    def train_on_dataset(self, train_ds, valid_ds=None, max_epochs: int = 1):
        """The static trainer's loop without ``mark_untrained`` (culling
        is the time-sliced refresh's job for a dynamic scene)."""
        NeRFTrainer.train_on_dataset(self, train_ds, valid_ds, max_epochs)

    def make_loader(self, dataset):
        """The static loader's batches, each with the split's frame times
        (host f32: the step picks its slice on the host)."""
        frames = super().make_loader(dataset)
        times = np.asarray(dataset.times, np.float32)

        def epoch_iter():
            for batch in frames():
                yield {**batch, "times": times}

        return epoch_iter
