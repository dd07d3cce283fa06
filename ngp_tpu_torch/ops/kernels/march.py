"""The turbo march, the eval prepass and the coarse occupancy lookup:
the CUDA kernels' wrappers and their plain versions.

``march_turbo`` replaces the turbo march of
``ngp_tpu/models/occupancy.py:march_rays_turbo`` around its Pallas
kernel ``ngp_tpu/ops/pallas/march_kernels.py:coarse_lookup_bits``: the
lattice, the coarse test, the candidate, crossing and sample budgets
and the drop estimate, as one kernel. ``ray_prepass_kernel`` replaces
the eval prepass around the same Pallas kernel
(``ngp_tpu/models/occupancy.py:ray_prepass``): the slab test, the probe
lattice, the mip levels, the lookups of the dilated payload and the
first and last occupied probe, as one kernel. ``coarse_lookup_bits`` is
that Pallas kernel's port alone, which no path calls. The kernels are in
``csrc/march_kernels.cu``, whose header says what bounds them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from ngp_tpu_torch.config import RenderConfig
from ngp_tpu_torch.ops.kernels import LAUNCHES
from ngp_tpu_torch.ops.kernels.build import check_launch, load_library
from ngp_tpu_torch.ops.lattice import (
    _TKEY_INVALID,
    _TKEY_THRESH,
    COARSE_FACTOR,
    _ascending,
    _cells,
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
from ngp_tpu_torch.ops.rays import near_far_from_aabb


def coarse_lookup_plain(payload: torch.Tensor, flatcell: torch.Tensor) -> torch.Tensor:
    """Bit ``fc & 7`` of byte ``payload.flat[fc >> 3]``; cells past the
    payload read as empty (``ngp_tpu/models/occupancy.py:_coarse_lookup``)."""
    flat = payload.reshape(-1)
    n_bytes = flat.shape[0]
    byte_idx = flatcell >> 3
    inside = (flatcell >= 0) & (byte_idx < n_bytes)
    byte = flat[byte_idx.clamp(0, n_bytes - 1).long()].to(torch.int32)
    return (((byte >> (flatcell & 7)) & 1) > 0) & inside


def coarse_lookup_bits(payload: torch.Tensor, flatcell: torch.Tensor) -> torch.Tensor:
    """Occupancy bit of each flat coarse-cell id.

    payload : [R, 128] f32 byte values (``pack_occupancy_payloads``)
    flatcell: int32, any shape, ids in [0, R*1024)
    returns : bool, the shape of ``flatcell``
    """
    if flatcell.device.type == "cpu":
        return coarse_lookup_plain(payload, flatcell)
    if flatcell.device.type != "cuda":
        raise ValueError(f"coarse_lookup_bits: no kernel for {flatcell.device}")
    if payload.device != flatcell.device or payload.dtype != torch.float32:
        raise ValueError("coarse_lookup_bits: payload must be f32 on the flatcell's device")
    if payload.ndim != 2 or payload.shape[1] != 128 or not payload.is_contiguous():
        raise ValueError(f"coarse_lookup_bits: payload must be contiguous [R, 128], "
                         f"got {tuple(payload.shape)}")
    if flatcell.dtype != torch.int32 or not flatcell.is_contiguous():
        raise ValueError("coarse_lookup_bits: flatcell must be contiguous int32")
    out = torch.empty(flatcell.shape, dtype=torch.bool, device=flatcell.device)
    n = flatcell.numel()
    if n == 0:
        return out
    lib = load_library()
    err = lib.ngp_coarse_lookup_bits(
        payload.data_ptr(), payload.numel(), flatcell.data_ptr(), n,
        out.data_ptr(), torch.cuda.current_stream(flatcell.device).cuda_stream,
    )
    check_launch("coarse_lookup_bits", err)
    LAUNCHES["coarse_lookup_bits"] += 1
    return out


def _proxy_on(cfg: RenderConfig, fine_payload: torch.Tensor) -> bool:
    return cfg.t_proxy_thresh is not None and fine_payload.shape[1] >= 18


def march_turbo_plain(rays_o, rays_d, coarse_payload, fine_payload, cfg: RenderConfig,
                      S: int, K2: int, U: int, aabb=None,
                      t_range: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The turbo march as the JAX code composes it: the [N, K] lattice,
    the coarse test of every probe, the first K2 survivors by top-k over
    t-bits keys, crossings as runs of one coarse cell and their fine
    bits through a per-slot table, the transmittance proxy, and the
    first S fine survivors by a second top-k.

    coarse_payload [R, 128] f32 bytes, fine_payload [Rf, 18] int64 words
    (``pack_occupancy_payloads``); S, K2 and U the sample, candidate and
    crossing budgets; ``aabb`` the box (the config's when None);
    ``t_range`` [N, 2] clips each ray; ``noise`` [N] in [0, 1) shifts
    each lattice start by that fraction of a step. Returns nears, fars
    [N], ts, deltas, mask [N, S] (zeros where masked), n_total [N] (fine
    survivors) and n_dropped [N] (the budgets' estimated drops)."""
    N = rays_o.shape[0]
    dev = rays_o.device
    F = COARSE_FACTOR
    dt_min, dt_max = dt_bounds(cfg)
    if aabb is None:
        aabb = cfg.aabb
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)
    if t_range is not None:
        nears = torch.maximum(nears, t_range[:, 0])
        fars = torch.minimum(fars, t_range[:, 1])
    hit = fars > nears
    fars_c = torch.where(hit, fars, nears)
    ts, dts = t_lattice(nears, fars_c, cfg, noise)

    def dt_at(t):
        if cfg.dt_gamma == 0.0:
            return torch.full_like(t, dt_min)
        return torch.clamp(t * cfg.dt_gamma, dt_min, dt_max)

    _, flat_c = _cells(_points(rays_o, rays_d, ts, cfg.bound), dts, cfg)
    coarse_ok = coarse_lookup_plain(coarse_payload, flat_c)
    valid_c = coarse_ok & (ts < fars_c[:, None]) & hit[:, None]

    tbits = _tbits(ts)
    cand = _ascending(torch.where(valid_c, tbits, tbits + _TKEY_INVALID), K2)
    cmask = cand < _TKEY_THRESH
    tbits2 = torch.where(cmask, cand, cand - _TKEY_INVALID)
    ts2 = tbits2.view(torch.float32)
    dts2 = dt_at(ts2)
    n2, flat2 = _cells(_points(rays_o, rays_d, ts2, cfg.bound), dts2, cfg)

    # crossings: runs of consecutive candidates in one coarse cell
    change = torch.cat(
        [torch.ones((N, 1), dtype=torch.bool, device=dev), flat2[:, 1:] != flat2[:, :-1]],
        dim=1,
    ) & cmask
    slot = torch.cumsum(change.int(), dim=1) - 1
    in_budget = slot < U
    first = change & in_budget
    slot_cell = torch.full((N, U + 1), -1, dtype=torch.int64, device=dev)
    slot_cell.scatter_(1, torch.where(first, slot, U).long(),
                       torch.where(first, flat2.long(), -1))
    pay = fine_payload[slot_cell[:, :U].clamp(min=0)]  # [N, U, 18]
    slot_cl = slot.clamp(0, U - 1).long()
    off = n2 % F
    bit6 = ((off[..., 0] * F + off[..., 1]) * F + off[..., 2]).long()  # [N, K2]
    word = torch.gather(pay[..., 0:2], 1, slot_cl[..., None].expand(N, K2, 2))
    word = torch.gather(word, 2, (bit6 >> 5)[..., None])[..., 0]
    fine_ok = ((word >> (bit6 & 31)) & 1) > 0
    valid_f = fine_ok & cmask & in_budget
    n_tested = (cmask & in_budget).sum(dim=-1)
    fine_rate = valid_f.sum(dim=-1) / torch.clamp(n_tested, min=1)

    if _proxy_on(cfg, fine_payload):
        # transmittance-proxy early-out: estimated optical depth of the
        # candidates' own fine cells, accumulated front to back
        cw = torch.gather(pay[..., 2:18], 1, slot_cl[..., None].expand(N, K2, 16))
        cw = torch.gather(cw, 2, (bit6 >> 2)[..., None])[..., 0]
        code = ((cw >> ((bit6 & 3) * 8)) & 0xFF).float()
        dens = torch.where(code > 0.0, torch.exp2(code / 8.0 - 16.0),
                           torch.zeros((), device=dev))
        contrib = torch.where(valid_f, dens * cfg.density_scale * dts2,
                              torch.zeros((), device=dev))
        cum = torch.cumsum(contrib, dim=1) - contrib
        valid_f = valid_f & (cum < -math.log(cfg.t_proxy_thresh))

    sel = _ascending(torch.where(valid_f, tbits2, tbits2 + _TKEY_INVALID), S)
    n_total = valid_f.sum(dim=-1)
    mask = torch.arange(S, device=dev)[None, :] < n_total[:, None]
    ts_c = torch.where(mask, sel, 0).view(torch.float32)
    dts_c = torch.where(mask, dt_at(ts_c), torch.zeros((), device=dev))

    n_coarse = valid_c.sum(dim=-1)
    n_kept_c = cmask.sum(dim=-1)
    untested = (n_coarse - n_kept_c) + (cmask & ~in_budget).sum(dim=-1)
    dropped = untested.float() * fine_rate + torch.clamp(n_total - S, min=0)
    return {"nears": nears, "fars": fars, "ts": ts_c, "deltas": dts_c, "mask": mask,
            "n_total": n_total, "n_dropped": dropped}


def _device_box(aabb, dev, kernel="march_turbo"):
    """(6 host floats, device pointer or None) of a kernel's box: a
    tensor on the card is read there, anything else on the host."""
    if torch.is_tensor(aabb) and aabb.device == dev:
        box = aabb.to(torch.float32).contiguous()
        if box.numel() != 6:
            raise ValueError(f"{kernel}: aabb must hold 6 values, got {box.numel()}")
        return (ctypes.c_float * 6)(), box
    vals = [float(v) for v in (aabb.tolist() if torch.is_tensor(aabb) else aabb)]
    if len(vals) != 6:
        raise ValueError(f"{kernel}: aabb must hold 6 values, got {len(vals)}")
    return (ctypes.c_float * 6)(*vals), None


def _check_f32(name, t, shape, dev, strided=False, kernel="march_turbo"):
    """f32 of this shape on dev, contiguous (or, strided, any strides >= 0:
    the rays are often views, one origin expanded over a chunk)."""
    if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not (t.is_contiguous() or strided and min(t.stride(), default=0) >= 0):
        raise ValueError(f"{kernel}: {name} must be {'' if strided else 'contiguous '}f32 "
                         f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} strides "
                         f"{t.stride()} on {t.device}")


def _check_payload(kernel, payload, dev):
    if payload.device != dev or payload.dtype != torch.float32 or payload.ndim != 2 \
            or payload.shape[1] != 128 or not payload.is_contiguous():
        raise ValueError(f"{kernel}: the payload must be contiguous f32 [R, 128] on {dev}, "
                         f"got {payload.dtype} {tuple(payload.shape)}")


def march_turbo(rays_o, rays_d, coarse_payload, fine_payload, cfg: RenderConfig,
                S: int, K2: int, U: int, aabb=None, t_range: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The turbo march: ``march_turbo_plain``'s function, one kernel
    launch on the card. Takes any lattice, K2, U and S <= K2; raises
    ValueError where the coarse payload does not fit a block's shared
    memory (more than 227 KB: at grid 128, 56 cascades)."""
    dev = rays_o.device
    if dev.type == "cpu":
        return march_turbo_plain(rays_o, rays_d, coarse_payload, fine_payload, cfg, S, K2, U,
                                 aabb=aabb, t_range=t_range, noise=noise)
    if dev.type != "cuda":
        raise ValueError(f"march_turbo: no kernel for {dev}")
    N = rays_o.shape[0]
    _check_f32("rays_o", rays_o, (N, 3), dev, strided=True)
    _check_f32("rays_d", rays_d, (N, 3), dev, strided=True)
    if t_range is not None:
        _check_f32("t_range", t_range, (N, 2), dev)
    if noise is not None:
        _check_f32("noise", noise, (N,), dev)
    _check_payload("march_turbo", coarse_payload, dev)
    if fine_payload.device != dev or fine_payload.dtype != torch.int64 \
            or fine_payload.ndim != 2 or fine_payload.shape[1] < 2 \
            or not fine_payload.is_contiguous():
        raise ValueError("march_turbo: fine_payload must be contiguous int64 [R, >= 2] on "
                         f"{dev}, got {fine_payload.dtype} {tuple(fine_payload.shape)}")
    if not (1 <= S <= K2 and U >= 1):
        raise ValueError(f"march_turbo: budgets S {S}, K2 {K2}, U {U}")
    box, box_dev = _device_box(cfg.aabb if aabb is None else aabb, dev)
    K = lattice_probes(cfg)
    dt_min, dt_max = dt_bounds(cfg)
    proxy = _proxy_on(cfg, fine_payload)
    f32 = dict(dtype=torch.float32, device=dev)
    out = {
        "nears": torch.empty((N,), **f32), "fars": torch.empty((N,), **f32),
        "ts": torch.empty((N, S), **f32), "deltas": torch.empty((N, S), **f32),
        "mask": torch.empty((N, S), dtype=torch.bool, device=dev),
        "n_total": torch.empty((N,), dtype=torch.int64, device=dev),
        "n_dropped": torch.empty((N,), **f32),
    }
    lib = load_library()
    # called for N = 0 too, so a payload the kernel does not take raises alike
    strides = (ctypes.c_longlong * 4)(*rays_o.stride(), *rays_d.stride())
    err = lib.ngp_march_turbo(
        rays_o.data_ptr(), rays_d.data_ptr(), strides, N, box,
        None if box_dev is None else box_dev.data_ptr(),
        None if t_range is None else t_range.data_ptr(),
        None if noise is None else noise.data_ptr(),
        coarse_payload.data_ptr(), coarse_payload.numel(),
        fine_payload.data_ptr(), fine_payload.shape[0], fine_payload.shape[1],
        dt_min, dt_max, cfg.dt_gamma, cfg.min_near, cfg.bound, cfg.grid_size, cfg.cascades,
        K, K2, U, S, int(proxy), -math.log(cfg.t_proxy_thresh) if proxy else 0.0,
        cfg.density_scale,
        *(out[k].data_ptr() for k in ("nears", "fars", "ts", "deltas", "mask", "n_total",
                                      "n_dropped")),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch("march_turbo", err)
    if N > 0:
        LAUNCHES["march_turbo"] += 1
    return out


def ray_prepass_plain(rays_o, rays_d, payload, cfg: RenderConfig,
                      aabb=None) -> Dict[str, torch.Tensor]:
    """The eval prepass as the JAX code composes it
    (``ngp_tpu/models/occupancy.py:ray_prepass``): the [N, Kp] probe
    lattice at one coarse cell's spacing from each ray's near end, the
    probes' points and mip levels, the dilated payload's bit at the
    probe's level (and, with more than one cascade, the levels beside
    it), masked to the box and to t <= far + h / 2, then per ray ``hit``
    (any probe occupied) and [``t0``, ``t1``] (the first and last
    occupied probe, widened by h / 2 and clipped to [near, far]; near
    where nothing is hit), with ``nears`` and ``fars``.

    payload [R, 128] f32 bytes (``pack_prepass_payload``); ``aabb`` the
    box (the config's when None)."""
    cas = cfg.cascades
    h = prepass_spacing(cfg)
    Kp = prepass_probes(cfg)
    dt_min, dt_max = dt_bounds(cfg)
    if aabb is None:
        aabb = cfg.aabb
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)
    hit_box = fars > nears
    ts = nears[:, None] + h * torch.arange(Kp, dtype=torch.float32, device=nears.device)[None, :]
    if cfg.dt_gamma == 0.0:
        dts = torch.full_like(ts, dt_min)
    else:
        dts = torch.clamp(ts * cfg.dt_gamma, dt_min, dt_max)
    x = _points(rays_o, rays_d, ts, cfg.bound)

    def lookup_level(level):
        return coarse_lookup_plain(payload, _cells(x, dts, cfg, level)[1])

    if cas == 1:
        occ = lookup_level(torch.zeros(ts.shape, dtype=torch.int32, device=ts.device))
    else:
        level = torch.maximum(mip_from_pos(x, cas), mip_from_dt(dts, cfg.grid_size, cas))
        occ = lookup_level(level)
        occ = occ | lookup_level(torch.clamp(level - 1, min=0))
        occ = occ | lookup_level(torch.clamp(level + 1, max=cas - 1))
    occ = occ & (ts <= fars[:, None] + 0.5 * h) & hit_box[:, None]
    hit = occ.any(dim=1)
    inf = torch.tensor(math.inf, device=ts.device)
    t0 = torch.where(occ, ts, inf).amin(dim=1) - 0.5 * h
    t1 = torch.where(occ, ts, -inf).amax(dim=1) + 0.5 * h
    t0 = torch.where(hit, torch.maximum(t0, nears), nears)
    t1 = torch.where(hit, torch.minimum(t1, fars), nears)
    return {"hit": hit, "t0": t0, "t1": t1, "nears": nears, "fars": fars}


def ray_prepass_kernel(rays_o, rays_d, payload, cfg: RenderConfig,
                       aabb=None) -> Dict[str, torch.Tensor]:
    """The eval prepass: ``ray_prepass_plain``'s function, one kernel
    launch on the card, bit-equal to it there. Raises ValueError where
    the payload does not fit a block's shared memory (more than 227 KB:
    at grid 128, 56 cascades)."""
    dev = rays_o.device
    if dev.type == "cpu":
        return ray_prepass_plain(rays_o, rays_d, payload, cfg, aabb=aabb)
    if dev.type != "cuda":
        raise ValueError(f"ray_prepass: no kernel for {dev}")
    N = rays_o.shape[0]
    _check_f32("rays_o", rays_o, (N, 3), dev, strided=True, kernel="ray_prepass")
    _check_f32("rays_d", rays_d, (N, 3), dev, strided=True, kernel="ray_prepass")
    _check_payload("ray_prepass", payload, dev)
    box, box_dev = _device_box(cfg.aabb if aabb is None else aabb, dev, "ray_prepass")
    dt_min, dt_max = dt_bounds(cfg)
    h = prepass_spacing(cfg)
    f32 = dict(dtype=torch.float32, device=dev)
    out = {"hit": torch.empty((N,), dtype=torch.bool, device=dev),
           "t0": torch.empty((N,), **f32), "t1": torch.empty((N,), **f32),
           "nears": torch.empty((N,), **f32), "fars": torch.empty((N,), **f32)}
    lib = load_library()
    # called for N = 0 too, so a payload the kernel does not take raises alike
    strides = (ctypes.c_longlong * 4)(*rays_o.stride(), *rays_d.stride())
    err = lib.ngp_ray_prepass(
        rays_o.data_ptr(), rays_d.data_ptr(), strides, N, box,
        None if box_dev is None else box_dev.data_ptr(), payload.data_ptr(), payload.numel(),
        h, 0.5 * h, prepass_probes(cfg), dt_min, dt_max, cfg.dt_gamma, cfg.min_near,
        cfg.bound, cfg.grid_size, cfg.cascades,
        *(out[k].data_ptr() for k in ("hit", "t0", "t1", "nears", "fars")),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch("ray_prepass", err)
    if N > 0:
        LAUNCHES["ray_prepass"] += 1
    return out
