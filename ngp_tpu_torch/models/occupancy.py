"""Occupancy grid, turbo and v1 marches and compositor
(``ngp_tpu/models/occupancy.py``) — the part of it the ``-O`` renders run.

The functions keep the JAX names, array layouts and sample semantics:
the same t-lattice, the same coarse (pooled, byte-packed) and fine
(64-bit per coarse cell) occupancy tests, the same per-ray candidate,
crossing and sample budgets with far-first drops, the same water-filled
compaction and the same masked compositing. The turbo march is one
hand-written kernel, ``ops/kernels/march.march_turbo``, which walks each
ray's lattice in march order and compacts with warp ballots where the
JAX code selects by top-k over t-bits keys and routes the fine payload
by one-hot einsums; its plain version keeps the JAX composition. The
eval prepass is one kernel too, ``ray_prepass_kernel``, which walks each
ray's prepass probes where the JAX code builds the dense probe lattice
around its coarse lookup. Compaction is one stable sort of the ray-major
mask.

The fine payload's uint32 words are held in int64 tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ngp_tpu_torch import tracing
from ngp_tpu_torch.config import RenderConfig
from ngp_tpu_torch.ops.kernels.march import (  # noqa: F401  (ray_prepass_plain re-exported)
    march_turbo,
    ray_prepass_kernel,
    ray_prepass_plain,
)
from ngp_tpu_torch.ops.lattice import (  # noqa: F401  (re-exported)
    _TKEY_INVALID,
    _TKEY_THRESH,
    COARSE_FACTOR,
    SQRT3,
    _ascending,
    _cells,
    _frexp_exponent,
    _points,
    _tbits,
    dt_bounds,
    lattice_probes,
    mip_from_dt,
    mip_from_pos,
    prepass_probes,
    prepass_spacing,
    t_lattice,
)
from ngp_tpu_torch.models.renderer import background
from ngp_tpu_torch.ops.morton import morton3d_invert, packbits
from ngp_tpu_torch.ops.rays import near_far_from_aabb

ALIGN = 4  # compact segment alignment (samples per placement row)


@dataclasses.dataclass
class OccupancyState:
    """Density grid and its packed views (see the JAX ``OccupancyState``).

    density_grid   [CAS, H, H, H] f32, -1 = untrained
    occ_grid       [CAS, H, H, H] bool
    mean_density   scalar f32 tensor
    iter_density   number of refreshes so far (host int)
    coarse_payload [CAS*Hc^3/1024, 128] f32 byte values of the pooled grid
    fine_payload   [CAS*Hc^3, 18] int64 holding uint32 words: 64 fine bits,
                   then 64 log-quantized eroded densities, 4 per word
    prepass_payload  like coarse_payload, of the 3^3-dilated pooled grid
    """

    density_grid: torch.Tensor
    occ_grid: torch.Tensor
    mean_density: torch.Tensor
    iter_density: int
    coarse_payload: torch.Tensor
    fine_payload: torch.Tensor
    prepass_payload: torch.Tensor

    def to(self, device) -> "OccupancyState":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "iter_density"
        })


def _erode3(g: torch.Tensor) -> torch.Tensor:
    """3^3 min-pool of [CAS, H, H, H], zero outside the grid."""
    for ax in (1, 2, 3):
        z = torch.zeros_like(g.narrow(ax, 0, 1))
        n = g.shape[ax]
        lo = torch.cat([z, g.narrow(ax, 0, n - 1)], dim=ax)
        hi = torch.cat([g.narrow(ax, 1, n - 1), z], dim=ax)
        g = torch.minimum(g, torch.minimum(lo, hi))
    return g


def _blocks(grid: torch.Tensor) -> torch.Tensor:
    """[CAS, H, H, H] -> [CAS*Hc^3, 64]: each coarse cell's 4^3 fine
    cells, z fastest at both levels."""
    cas, H = grid.shape[0], grid.shape[1]
    F = COARSE_FACTOR
    Hc = H // F
    b = grid.reshape(cas, Hc, F, Hc, F, Hc, F).permute(0, 1, 3, 5, 2, 4, 6)
    return b.reshape(cas * Hc**3, F**3)


def _pack_bits_payload(bits_flat: torch.Tensor) -> torch.Tensor:
    """Flat cell bits (z fastest) -> [rows, 128] f32 byte payload."""
    shifts = torch.arange(8, device=bits_flat.device)
    bytes_ = (bits_flat.reshape(-1, 8).long() << shifts).sum(dim=1)
    pad = (-bytes_.shape[0]) % 128
    if pad:
        bytes_ = torch.cat([bytes_, bytes_.new_zeros(pad)])
    return bytes_.float().reshape(-1, 128)


def pack_occupancy_payloads(occ_grid: torch.Tensor,
                            density_grid: Optional[torch.Tensor] = None):
    """occ_grid [CAS, H, H, H] bool -> (coarse_payload, fine_payload);
    with ``density_grid`` the fine rows also carry the eroded,
    log-quantized densities (code c: 2^(c/8 - 16), 0 = zero)."""
    blocks = _blocks(occ_grid)
    bits = blocks.long()
    shifts = torch.arange(32, device=occ_grid.device)
    w0 = (bits[:, :32] << shifts).sum(dim=1)
    w1 = (bits[:, 32:] << shifts).sum(dim=1)
    R = w0.shape[0]
    if density_grid is None:
        dens_words = w0.new_zeros((R, 16))
    else:
        d = _blocks(_erode3(torch.clamp(density_grid, min=0.0)))
        code = torch.where(
            d > 2.0 ** -16,
            torch.clamp(torch.floor((torch.log2(torch.clamp(d, min=1e-30)) + 16.0) * 8.0),
                        1.0, 255.0),
            torch.zeros((), device=d.device),
        ).long()
        shifts8 = torch.arange(4, device=d.device) * 8
        dens_words = (code.reshape(R, 16, 4) << shifts8).sum(dim=2)
    fine_payload = torch.cat([w0[:, None], w1[:, None], dens_words], dim=1)
    coarse_payload = _pack_bits_payload(blocks.any(dim=1))
    return coarse_payload, fine_payload


def pack_prepass_payload(occ_grid: torch.Tensor) -> torch.Tensor:
    """Pooled coarse occupancy dilated by a stride-1 3^3 max-pool, packed
    like the coarse payload, for :func:`ray_prepass`."""
    cas, H = occ_grid.shape[0], occ_grid.shape[1]
    F = COARSE_FACTOR
    Hc = H // F
    d = occ_grid.reshape(cas, Hc, F, Hc, F, Hc, F).any(dim=6).any(dim=4).any(dim=2)
    for ax in (1, 2, 3):
        lo = torch.cat([d.narrow(ax, 1, Hc - 1), d.narrow(ax, Hc - 1, 1)], dim=ax)
        hi = torch.cat([d.narrow(ax, 0, 1), d.narrow(ax, 0, Hc - 1)], dim=ax)
        d = d | lo | hi
    return _pack_bits_payload(d.reshape(-1))


def init_occupancy(cfg: RenderConfig, device="cuda") -> OccupancyState:
    H, cas = cfg.grid_size, cfg.cascades
    occ = torch.ones((cas, H, H, H), dtype=torch.bool, device=device)
    coarse, fine = pack_occupancy_payloads(occ)
    return OccupancyState(
        density_grid=torch.zeros((cas, H, H, H), device=device),
        occ_grid=occ,
        mean_density=torch.zeros((), device=device),
        iter_density=0,
        coarse_payload=coarse,
        fine_payload=fine,
        prepass_payload=pack_prepass_payload(occ),
    )


def occupancy_from_jax(arrays: Dict[str, np.ndarray], device="cuda") -> OccupancyState:
    """A JAX ``OccupancyState`` given as numpy arrays (its field names)
    -> the port's state on ``device``."""
    def t(name, dtype):
        return torch.from_numpy(np.array(arrays[name]).astype(dtype)).to(device)

    return OccupancyState(
        density_grid=t("density_grid", np.float32),
        occ_grid=t("occ_grid", np.bool_),
        mean_density=t("mean_density", np.float32),
        iter_density=int(np.asarray(arrays["iter_density"])),
        coarse_payload=t("coarse_payload", np.float32),
        fine_payload=t("fine_payload", np.int64),
        prepass_payload=t("prepass_payload", np.float32),
    )


def bitfield(state: OccupancyState) -> torch.Tensor:
    """uint8 density bitfield [CAS * H^3 / 8] in the reference's cell order:
    bit m of a cascade is the cell at ``morton3d_invert(m)``
    (nerf/renderer.py:459-462, packed as raymarching.cu:268 does)."""
    occ = state.occ_grid
    H = occ.shape[-1]
    c = morton3d_invert(torch.arange(H**3, device=occ.device)).long()
    zorder = occ.reshape(occ.shape[0], -1)[:, (c[:, 0] * H + c[:, 1]) * H + c[:, 2]]
    return packbits(zorder.float().reshape(-1), 0.5)


def occupied_aabb(state: OccupancyState, cfg: RenderConfig) -> torch.Tensor:
    """World-space AABB [6] of every occupied cell, padded by one fine
    cell per cascade; the full scene box when nothing is occupied."""
    H = cfg.grid_size
    occ = state.occ_grid
    dev = occ.device
    lo = torch.full((3,), math.inf, device=dev)
    hi = torch.full((3,), -math.inf, device=dev)
    for c in range(occ.shape[0]):
        bc = float(min(2.0**c, cfg.bound))
        cell = 2.0 * bc / H
        g = occ[c]
        for ax in range(3):
            prof = g.any(dim=tuple(a for a in range(3) if a != ax))
            anyc = prof.any()
            first = torch.argmax(prof.int()).float()
            last = (H - 1 - torch.argmax(prof.flip(0).int())).float()
            lo_w = (first / H * 2.0 - 1.0) * bc - cell
            hi_w = ((last + 1.0) / H * 2.0 - 1.0) * bc + cell
            inf = torch.tensor(math.inf, device=dev)
            lo[ax] = torch.minimum(lo[ax], torch.where(anyc, lo_w, inf))
            hi[ax] = torch.maximum(hi[ax], torch.where(anyc, hi_w, -inf))
    full = torch.tensor(cfg.aabb, dtype=torch.float32, device=dev)
    valid = (hi > lo).all()
    lo = torch.where(valid, torch.maximum(lo, full[:3]), full[:3])
    hi = torch.where(valid, torch.minimum(hi, full[3:]), full[3:])
    return torch.cat([lo, hi])


# ---------------------------------------------------------------------------
# eval prepass
# ---------------------------------------------------------------------------


def ray_prepass(rays_o, rays_d, state: OccupancyState, cfg: RenderConfig,
                aabb=None) -> Dict[str, torch.Tensor]:
    """Conservative eval cull: per ray, may it produce any march sample
    (``hit``), and an interval [t0, t1] holding all of them; also the
    ray's ``nears`` and ``fars``. One kernel launch on the card
    (``ray_prepass_kernel``); ``ray_prepass_plain`` on the CPU."""
    return ray_prepass_kernel(rays_o, rays_d, state.prepass_payload, cfg, aabb=aabb)


# ---------------------------------------------------------------------------
# v1 march (the hash-grid configuration's renderer)
# ---------------------------------------------------------------------------


def occupancy_at(state: OccupancyState, x: torch.Tensor, dt: torch.Tensor,
                 cfg: RenderConfig) -> torch.Tensor:
    """Occupancy of world points x [..., 3] with step sizes dt [...]: the
    nearest cell of the dense grid at the larger of the position's and
    the step's mip level."""
    cas = cfg.cascades
    level = torch.maximum(mip_from_pos(x, cas), mip_from_dt(dt, cfg.grid_size, cas))
    n, _ = _cells(x, dt, cfg, level)
    H = cfg.grid_size
    cell = (n[..., 0].long() * H + n[..., 1]) * H + n[..., 2]
    return state.occ_grid.reshape(cas, -1)[level.long(), cell]


@tracing.traced("march")
def march_rays(rays_o, rays_d, state: OccupancyState, cfg: RenderConfig,
               max_samples: Optional[int] = None, aabb=None,
               t_range: Optional[torch.Tensor] = None, perturb: bool = False,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Per-ray samples of the v1 march, [N, S] ascending in t: every
    lattice probe reads the dense occupancy grid (``occupancy_at``), and
    the first S occupied probes in march order are kept. The JAX code
    selects them by top-k over the keys k (valid) and K + k (not); the S
    smallest keys are the same here, and each key mod K is its probe.

    ``aabb`` overrides the scene box of the ray interval, ``t_range``
    [N, 2] clips each ray's [near, far]; ``perturb`` shifts each ray's
    lattice start by ``noise`` [N] (uniform in [0, 1)) or by draws from
    ``generator``."""
    S = min(max_samples or cfg.max_samples_per_ray, cfg.max_steps)
    N = rays_o.shape[0]
    dev = rays_o.device
    if aabb is None:
        aabb = cfg.aabb
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)
    if t_range is not None:
        nears = torch.maximum(nears, t_range[:, 0])
        fars = torch.minimum(fars, t_range[:, 1])
    hit = fars > nears
    fars_c = torch.where(hit, fars, nears)
    if perturb and noise is None:
        noise = torch.rand((N,), generator=generator, device=dev)
    ts, dts = t_lattice(nears, fars_c, cfg, noise if perturb else None)
    K = ts.shape[1]
    occ = occupancy_at(state, _points(rays_o, rays_d, ts, cfg.bound), dts, cfg)
    valid = occ & (ts < fars_c[:, None]) & hit[:, None]
    ks = torch.arange(K, dtype=torch.int32, device=dev)
    probe = (_ascending(torch.where(valid, ks, ks + K), S) % K).long()
    mask = torch.arange(S, device=dev)[None, :] < valid.sum(dim=-1)[:, None]
    zero = torch.zeros((), device=dev)
    ts_c = torch.where(mask, torch.gather(ts, 1, probe), zero)
    dts_c = torch.where(mask, torch.gather(dts, 1, probe), zero)
    xyzs = _points(rays_o, rays_d, ts_c, cfg.bound)
    return {
        "xyzs": xyzs,
        "dirs": rays_d[:, None, :].expand_as(xyzs),
        "ts": ts_c,
        "deltas": dts_c,
        "mask": mask,
        "nears": nears,
        "fars": fars,
    }


def count_samples(evaluated: int, out: Dict[str, torch.Tensor]) -> None:
    """A render's sample counters (``tracing.count``): the rows the network
    closures evaluated (``evaluated``, a host int), the samples composited
    (``out["n_samples"]``) and, where the march has a budget, those it
    dropped (``out["n_dropped"]``)."""
    tracing.count("samples_evaluated", evaluated)
    tracing.count("samples_composited", out["n_samples"])
    if "n_dropped" in out:
        tracing.count("samples_dropped", out["n_dropped"])


def render_rays_grid(density_fn: Callable, color_fn: Callable, rays_o, rays_d,
                     state: OccupancyState, cfg: RenderConfig, bg_color=None,
                     max_samples: Optional[int] = None, aabb=None,
                     t_range: Optional[torch.Tensor] = None, perturb: bool = False,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None,
                     bg_fn: Optional[Callable] = None,
                     return_geo: bool = False) -> Dict[str, torch.Tensor]:
    """v1 march -> network -> compositing. The network runs on all N * S
    slots, the masked ones included, as the JAX renderer does: their
    compositing weights are zero, so they add nothing to a pixel or a
    gradient. There is no ``n_dropped``: the v1 march has no budget
    below S per ray. ``bg_fn`` (``bg_radius > 0``) replaces ``bg_color``
    (``models.renderer.background``). ``return_geo`` adds the density
    closure's geometry output (``out["geo"]``, per [N, S] slot) and its
    validity mask (``out["compact_valid"]``, the march's [N, S] mask), which
    D-NeRF's deformation regulariser reads."""
    m = march_rays(rays_o, rays_d, state, cfg, max_samples=max_samples, aabb=aabb,
                   t_range=t_range, perturb=perturb, generator=generator, noise=noise)
    sigmas, geo = density_fn(m["xyzs"])
    rgbs = color_fn(m["dirs"], geo)
    out = composite_rays(sigmas, rgbs, m["ts"], m["deltas"], m["mask"], m["nears"],
                         m["fars"], density_scale=cfg.density_scale, t_thresh=cfg.t_thresh)
    out["image"] = out["image"] + (1.0 - out["weights_sum"])[..., None] * background(
        rays_o, rays_d, cfg, bg_color, bg_fn)
    out["n_samples"] = m["mask"].sum()
    count_samples(m["mask"].numel(), out)
    out["ts"], out["deltas"] = m["ts"], m["deltas"]
    if return_geo:
        out["geo"], out["compact_valid"] = geo, m["mask"]
    return out


# ---------------------------------------------------------------------------
# turbo march
# ---------------------------------------------------------------------------


def turbo_budgets(cfg: RenderConfig, max_samples: Optional[int] = None) -> Tuple[int, int, int]:
    """(S, K2, U) of the turbo march: samples per ray (at most the
    candidates, in ALIGN steps), coarse candidates and crossing slots."""
    S = max_samples or cfg.max_samples_per_ray
    S = min(S, cfg.max_steps)
    K = lattice_probes(cfg)
    if K < ALIGN:
        raise ValueError(f"lattice too short ({K} probes)")
    K2 = max(min(cfg.coarse_candidates, K), ALIGN)
    S = max(ALIGN, min(-(-S // ALIGN) * ALIGN, K2 // ALIGN * ALIGN))
    return S, K2, cfg.crossing_slots


@tracing.traced("march")
def march_rays_turbo(rays_o, rays_d, state: OccupancyState, cfg: RenderConfig,
                     max_samples: Optional[int] = None, aabb=None,
                     t_range: Optional[torch.Tensor] = None, perturb: bool = False,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Per-ray samples of the occupancy-grid march, [N, S] ascending in t.

    1. every lattice probe is tested against the pooled coarse grid;
    2. the first ``coarse_candidates`` survivors per ray are kept;
    3. runs of candidates in one coarse cell form a crossing; the first
       ``crossing_slots`` crossings read their 64 fine bits, later ones
       are dropped (far-first);
    4. fine-occupied candidates are compacted to the per-ray budget S.

    All four are ``march_turbo``, one kernel on the card. ``perturb``
    (training) shifts each ray's lattice start by a uniform fraction of
    a step: ``noise`` [N] when given, else drawn from ``generator``.
    """
    S, K2, U = turbo_budgets(cfg, max_samples)
    if perturb and noise is None:
        noise = torch.rand((rays_o.shape[0],), generator=generator, device=rays_o.device)
    m = march_turbo(rays_o, rays_d, state.coarse_payload, state.fine_payload, cfg, S, K2, U,
                    aabb=aabb, t_range=t_range, noise=noise if perturb else None)
    xyzs = _points(rays_o, rays_d, m["ts"], cfg.bound)
    m["xyzs"] = xyzs
    m["dirs"] = rays_d[:, None, :].expand_as(xyzs)
    return m


# ---------------------------------------------------------------------------
# compaction, placement, compositing
# ---------------------------------------------------------------------------


def compact_valid_samples(mask: torch.Tensor, budget: int,
                          extra: Optional[torch.Tensor] = None):
    """Squeeze the valid samples of [N, S] rays into a [budget] buffer,
    ray-major: one stable sort puts valid slots first in ray order.

    Returns (src, valid, offsets[, extra_c]): compact slot m holds march
    slot src[m] (flat N*S index); offsets[n] is ray n's first compact
    slot; ``extra`` [N, S] is compacted alongside."""
    flat = mask.reshape(-1)
    counts = mask.sum(dim=1)
    offsets = torch.cumsum(counts, dim=0) - counts
    order = torch.sort((~flat).to(torch.int8), stable=True).indices
    src = order[:budget]
    valid = flat[src]
    if extra is None:
        return src, valid, offsets
    return src, valid, offsets, extra.reshape(-1)[src]


class _PlaceCompact(torch.autograd.Function):
    """The JAX ``place_compact`` custom VJP: the backward gathers each
    compact block's gradient from its own ray's slot and zeroes blocks
    outside their ray's segment. Autograd of the forward gather would
    instead scatter-add the gradient of every slot that read a block,
    clamped and out-of-segment slots included."""

    @staticmethod
    def forward(ctx, vals, offsets, src, S):
        M, Fd = vals.shape
        N = offsets.shape[0]
        v8 = vals.reshape(M // ALIGN, ALIGN * Fd)
        rows = offsets[:, None] // ALIGN + torch.arange(S // ALIGN, device=vals.device)[None, :]
        ctx.save_for_backward(offsets, src)
        ctx.S, ctx.shape = S, (M, Fd)
        return v8[rows.clamp(0, M // ALIGN - 1)].reshape(N, S, Fd)

    @staticmethod
    def backward(ctx, g):
        offsets, src = ctx.saved_tensors
        S, (M, Fd) = ctx.S, ctx.shape
        N = offsets.shape[0]
        nb, SA = M // ALIGN, S // ALIGN
        g8 = g.reshape(N * SA, ALIGN * Fd)
        ray_b = src[::ALIGN] // S  # ray of each compact block
        j_b = torch.arange(nb, device=g.device) - offsets[ray_b] // ALIGN
        row_b = ray_b * SA + j_b.clamp(0, SA - 1)
        dv8 = g8[row_b.clamp(0, N * SA - 1)]
        in_seg = (j_b >= 0) & (j_b < SA)
        dvals = torch.where(in_seg[:, None], dv8, torch.zeros((), device=g.device))
        return dvals.reshape(M, Fd), None, None, None


def place_compact(vals: torch.Tensor, offsets: torch.Tensor, src: torch.Tensor,
                  S: int) -> torch.Tensor:
    """Per-compact-sample values [M, F] -> [N, S, F] ray slots. Needs
    ALIGN-aligned segments; slots past a ray's count hold garbage that
    the caller masks, and get no gradient back into ``vals``."""
    return _PlaceCompact.apply(vals, offsets, src, S)


def _turbo_compact_geometry(rays_o, rays_d, state, cfg, max_samples, aabb, budget,
                            t_range=None, perturb=False, generator=None, noise=None,
                            train_budget=None):
    """March -> ALIGN-padded compaction -> per-compact-sample points.

    An explicit (eval) budget is water-filled: every ray gets the same
    depth allowance k*, the largest ALIGN multiple whose total fits the
    budget, and the leftover goes as one more block to the first rays
    still cut. Without one (training) the budget is
    N * compact_mean_samples and the ray-major tail is dropped;
    ``train_budget(n_valid)`` replaces it when the rays are one data
    rank's slice of a batch (``parallel.collectives.rank_budget``), and a
    budget of 0 keeps one masked block."""
    N = rays_o.shape[0]
    dev = rays_o.device
    m = march_rays_turbo(rays_o, rays_d, state, cfg, max_samples=max_samples, aabb=aabb,
                         t_range=t_range, perturb=perturb, generator=generator, noise=noise)
    S = m["mask"].shape[1]
    n_total8 = torch.clamp((m["n_total"] + ALIGN - 1) // ALIGN * ALIGN, max=S)
    water_fill = budget is not None
    if budget is None:
        budget = (N * cfg.compact_mean_samples if train_budget is None
                  else train_budget(n_total8.sum()))
    limit = min(budget, N * S)
    budget = max(limit, ALIGN)
    if water_fill and budget < N * S:
        ks = torch.arange(0, S + 1, ALIGN, device=dev)
        tot = torch.minimum(n_total8[None, :], ks[:, None]).sum(dim=1)
        k_star = torch.clamp(torch.where(tot <= budget, ks, 0).amax(), min=ALIGN)
        tot_k = torch.minimum(n_total8, k_star).sum()
        wants = n_total8 > k_star
        rank = torch.cumsum(wants.long(), dim=0) - 1
        extra_blocks = torch.clamp(budget - tot_k, min=0) // ALIGN
        bonus = ALIGN * (wants & (rank < extra_blocks)).long()
        n_alloc = torch.minimum(n_total8, k_star + bonus)
    else:
        n_alloc = n_total8
    iota_s = torch.arange(S, device=dev)[None, :]
    mask8 = iota_s < n_alloc[:, None]
    src, valid_m, offsets, t_c = compact_valid_samples(mask8, budget, extra=m["ts"])
    if limit < budget:
        valid_m = valid_m & (torch.arange(budget, device=dev) < limit)
    ray = src // S
    pts = torch.clamp(rays_o[ray] + rays_d[ray] * t_c[:, None], -cfg.bound, cfg.bound)
    dirs = rays_d[ray]
    maskb = m["mask"] & (iota_s < n_alloc[:, None]) & ((offsets[:, None] + iota_s) < limit)
    return m, S, budget, src, valid_m, offsets, t_c, pts, dirs, maskb


def composite_rays(sigmas, rgbs, ts, deltas, mask, nears, fars,
                   density_scale: float = 1.0, t_thresh: float = 1e-4):
    """Masked front-to-back compositing; transmittance below
    ``t_thresh`` stops contributing. Depth is normalised to [near, far]."""
    sigmas = sigmas.float()
    alphas = 1.0 - torch.exp(-deltas * density_scale * sigmas)
    alphas = torch.where(mask, alphas, torch.zeros((), device=alphas.device))
    shifted = torch.cat([torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-15], dim=-1)
    trans = torch.cumprod(shifted, dim=-1)[..., :-1]
    weights = torch.where(trans > t_thresh, alphas * trans, torch.zeros((), device=alphas.device))
    span = torch.clamp(fars - nears, min=1e-10)
    depth_t = torch.clamp((ts - nears[:, None]) / span[:, None], 0, 1)
    return {
        "weights": weights,
        "weights_sum": weights.sum(dim=-1),
        "image": (weights[..., None] * rgbs.float()).sum(dim=-2),
        "depth": (weights * depth_t).sum(dim=-1),
    }


def render_rays_grid_turbo(density_fn: Optional[Callable], color_fn: Optional[Callable],
                           rays_o, rays_d, state: OccupancyState, cfg: RenderConfig,
                           bg_color=None, max_samples: Optional[int] = None, aabb=None,
                           budget: Optional[int] = None,
                           t_range: Optional[torch.Tensor] = None,
                           vals_fn: Optional[Callable] = None, perturb: bool = False,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None,
                           bg_fn: Optional[Callable] = None,
                           return_geo: bool = False,
                           train_budget: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Turbo march -> compaction -> network on the compact batch ->
    placement -> compositing. ``vals_fn(pts, dirs) -> [M, 4]`` (eval)
    replaces the density_fn / color_fn pair. ``perturb`` (training)
    jitters the lattice start (see :func:`march_rays_turbo`). ``bg_fn``
    (``bg_radius > 0``) replaces ``bg_color`` (``models.renderer.background``).
    ``return_geo`` adds the density closure's geometry output for the
    compact batch (``out["geo"]``, [budget, ...]) and its validity mask
    (``out["compact_valid"]``, [budget]); it takes no ``vals_fn``.
    ``train_budget``: see :func:`_turbo_compact_geometry`."""
    if vals_fn is not None and return_geo:
        raise ValueError("vals_fn is incompatible with return_geo")
    m, S, budget, src, valid_m, offsets, t_c, pts, dirs, maskb = _turbo_compact_geometry(
        rays_o, rays_d, state, cfg, max_samples, aabb, budget, t_range=t_range,
        perturb=perturb, generator=generator, noise=noise, train_budget=train_budget,
    )
    if vals_fn is not None:
        vals = vals_fn(pts, dirs)
    else:
        sigmas, geo = density_fn(pts)
        rgbs = color_fn(dirs, geo)
        vals = torch.cat([sigmas.reshape(-1, 1).float(), rgbs.float()], dim=-1)
    placed = place_compact(vals, offsets, src, S)
    out = composite_rays(placed[..., 0], placed[..., 1:], m["ts"], m["deltas"], maskb,
                         m["nears"], m["fars"], density_scale=cfg.density_scale,
                         t_thresh=cfg.t_thresh)
    out["image"] = out["image"] + (1.0 - out["weights_sum"])[..., None] * background(
        rays_o, rays_d, cfg, bg_color, bg_fn)
    out["n_samples"] = maskb.sum()
    out["n_dropped"] = m["n_dropped"].sum() + (m["mask"] & ~maskb).sum()
    count_samples(budget, out)
    out["ts"], out["deltas"] = m["ts"], m["deltas"]
    if return_geo:
        out["geo"], out["compact_valid"] = geo, valid_m
    return out


def render_rays_grid_turbo_multi(sigma_rgb_fn: Callable, rays_o, rays_d,
                                 state: OccupancyState, cfg: RenderConfig, bg_color=None,
                                 max_samples: Optional[int] = None, aabb=None,
                                 budget: Optional[int] = None, perturb: bool = False,
                                 generator: Optional[torch.Generator] = None,
                                 noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The turbo render of K stacked radiance heads over one march:
    ``sigma_rgb_fn(pts [M, 3], dirs [M, 3]) -> (sigmas [K, M], rgbs [K, M, 3])``
    on the compact batch, each head placed and composited into its own
    image (CCNeRF's rank-residual training forward). The march,
    compaction and placement are the single-head path's; the K heads are
    placed together as one [M, 4K] value row. Returns "image" [K, N, 3],
    "weights_sum", "depth" [K, N], "weights" [K, N, S] and the single-head
    path's "n_samples" and "n_dropped"."""
    m, S, budget, src, valid_m, offsets, t_c, pts, dirs, maskb = _turbo_compact_geometry(
        rays_o, rays_d, state, cfg, max_samples, aabb, budget, perturb=perturb,
        generator=generator, noise=noise,
    )
    sigmas, rgbs = sigma_rgb_fn(pts, dirs)
    K, M = sigmas.shape
    vals = torch.cat([sigmas[..., None].float(), rgbs.float()], dim=-1)  # [K, M, 4]
    placed = place_compact(vals.permute(1, 0, 2).reshape(M, 4 * K), offsets, src, S)
    placed = placed.reshape(-1, S, K, 4).permute(2, 0, 1, 3)  # [K, N, S, 4]
    out = composite_rays(placed[..., 0], placed[..., 1:], m["ts"], m["deltas"], maskb,
                         m["nears"], m["fars"], density_scale=cfg.density_scale,
                         t_thresh=cfg.t_thresh)
    bg = 1.0 if bg_color is None else bg_color
    out["image"] = out["image"] + (1.0 - out["weights_sum"])[..., None] * bg
    out["n_samples"] = maskb.sum()
    out["n_dropped"] = m["n_dropped"].sum() + (m["mask"] & ~maskb).sum()
    count_samples(budget, out)
    return out


# ---------------------------------------------------------------------------
# density-grid maintenance
# ---------------------------------------------------------------------------


def _cascade_query_points(coords, cas: int, cfg: RenderConfig, u: torch.Tensor):
    """Cell coords [N, 3] -> jittered world points in cascade ``cas``;
    ``u`` [N, 3] uniform draws in [0, 1)."""
    H = cfg.grid_size
    bound = min(2.0**cas, cfg.bound)
    half = bound / H
    xyzs = 2.0 * coords.float() / (H - 1) - 1.0
    xyzs = xyzs * (bound - half)
    return xyzs + (u * 2.0 - 1.0) * half


def _full_coords(H: int, device):
    r = torch.arange(H, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)


def update_occupancy(state: OccupancyState, density_fn: Callable, cfg: RenderConfig,
                     generator: Optional[torch.Generator] = None, decay: float = 0.95,
                     density_scale: float = 1.0,
                     jitter: Optional[Sequence[torch.Tensor]] = None,
                     slab_x0: Optional[Sequence[int]] = None) -> OccupancyState:
    """EMA-max density-grid refresh, re-threshold and repack.

    The first 16 refreshes query every cell of every cascade; later
    ones one random x-slab of H/4 planes per cascade. Queries are
    jittered cell centers. The draws come from ``generator``, or from
    ``jitter`` (per cascade, [cells, 3] uniform in [0, 1)) and
    ``slab_x0`` (per cascade, for a partial refresh) when given."""
    H, cas = cfg.grid_size, cfg.cascades
    dev = state.density_grid.device
    full = state.iter_density < 16
    thickness = max(H // 4, 1)

    def draw_u(c, n):
        if jitter is not None:
            return jitter[c].to(dev)
        return torch.rand((n, 3), generator=generator, device=dev)

    def query(coords, c, u):
        sig = []
        chunk = 128 * 128 * 8
        for i in range(0, coords.shape[0], chunk):
            pts = _cascade_query_points(coords[i:i + chunk], c, cfg, u[i:i + chunk])
            sig.append(density_fn(pts)[0].float() * density_scale)
        return torch.cat(sig)

    if full:
        coords = _full_coords(H, dev)
        tmp = torch.stack([
            query(coords, c, draw_u(c, H**3)).reshape(H, H, H) for c in range(cas)
        ])
    else:
        tmp = torch.full((cas, H, H, H), -1.0, device=dev)
        r = torch.arange(H, device=dev)
        base = torch.stack(torch.meshgrid(
            torch.arange(thickness, device=dev), r, r, indexing="ij"), dim=-1).reshape(-1, 3)
        for c in range(cas):
            if slab_x0 is not None:
                x0 = int(slab_x0[c])
            else:
                x0 = int(torch.randint(0, H - thickness + 1, (1,), generator=generator,
                                       device=dev).item())
            coords = base + torch.tensor([x0, 0, 0], device=dev)
            sig = query(coords, c, draw_u(c, base.shape[0]))
            tmp[c, x0:x0 + thickness] = sig.reshape(thickness, H, H)

    grid = state.density_grid
    valid = (grid >= 0) & (tmp >= 0)
    new_grid = torch.where(valid, torch.maximum(grid * decay, tmp), grid)
    mean_density = torch.clamp(new_grid, min=0.0).mean()
    thresh = torch.clamp(mean_density, max=cfg.density_thresh)
    occ = new_grid > thresh
    coarse, fine = pack_occupancy_payloads(occ, new_grid)
    return OccupancyState(
        density_grid=new_grid,
        occ_grid=occ,
        mean_density=mean_density,
        iter_density=state.iter_density + 1,
        coarse_payload=coarse,
        fine_payload=fine,
        prepass_payload=pack_prepass_payload(occ),
    )


def mark_untrained_grid(state: OccupancyState, poses, intrinsics, H_img: int, W_img: int,
                        cfg: RenderConfig) -> OccupancyState:
    """Set the cells that no training camera sees to -1, so they never
    become occupied: a cell is seen when its center lies in front of a
    camera and inside its field of view widened by one cell. Host numpy,
    then one transfer of the [CAS, H, H, H] mask."""
    Hg, cas = cfg.grid_size, cfg.cascades
    fx, fy, cx, cy = (float(v) for v in np.asarray(intrinsics, np.float32)[:4])
    poses_np = np.asarray(poses, np.float32)
    rot = poses_np[:, :3, :3]
    trans = poses_np[:, :3, 3]
    idx = np.arange(Hg, dtype=np.float32)
    base = np.stack(np.meshgrid(idx, idx, idx, indexing="ij"), axis=-1).reshape(-1, 3)
    base = 2.0 * base / (Hg - 1) - 1.0
    vis_all = np.empty((cas, Hg, Hg, Hg), np.bool_)
    for c in range(cas):
        bound = min(2.0**c, cfg.bound)
        half = bound / Hg
        pts = base * (bound - half)
        visible = np.zeros(pts.shape[0], np.bool_)
        for p in range(poses_np.shape[0]):
            cam = (pts - trans[p]) @ rot[p]
            z = cam[:, 2]
            visible |= (
                (z > 0.01)
                & (np.abs(cam[:, 0]) < cx / fx * z + 2 * half)
                & (np.abs(cam[:, 1]) < cy / fy * z + 2 * half)
            )
        vis_all[c] = visible.reshape(Hg, Hg, Hg)
    grid = state.density_grid
    vis = torch.from_numpy(vis_all).to(grid.device)
    return dataclasses.replace(
        state, density_grid=torch.where(vis, grid, torch.full((), -1.0, device=grid.device))
    )
