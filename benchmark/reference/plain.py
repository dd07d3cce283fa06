"""Plain PyTorch reference of the NeRF training step the benchmark times.

Frozen copies of the plain compositions that define the port's
semantics, in float32, with nothing of the port imported: the march
lattice and the two marches (the turbo march with its candidate,
crossing and sample budgets and the training budget's ray-major tail
drop, and the v1 march), the occupancy grid's refresh, packing and
camera cull, the CP factor-bank and hash-grid encoders, the bias-free
MLPs, the SH and frequency encodings, trunc_exp and the masked
compositor. ``step.py`` drives them through a training step.

``Rounding`` says where the configuration's compute type rounds a value
(the encoder's parameters and features, each MLP weight, input and layer
output): the reference passes values through unchanged; the control
rounds them to a lower precision (``Rounding("fp8")``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

SQRT3 = math.sqrt(3.0)
COARSE_FACTOR = 4
ALIGN = 4
_TKEY_INVALID = 0x20000000
_TKEY_THRESH = 0x50000000
_BIG = 1e10
PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_M32 = 0xFFFFFFFF
FP8_MAX = 448.0  # the largest finite float8 e4m3 value
FP8_E5M2_MAX = 57344.0  # the largest finite float8 e5m2 value


def _scaled_round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale that maps max |x| to ``top``."""
    scale = torch.clamp(x.abs().amax(), min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _FakeFP8(torch.autograd.Function):
    """Per-tensor scaled float8 rounding as fp8 training does it: e4m3
    on the value, e5m2 on the gradient that flows back through it."""

    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x.detach(), torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, FP8_E5M2_MAX)


class Rounding:
    """``"f32"``: values pass unchanged (the reference); ``"fp8"``: each
    rounding point of the configuration's compute type rounds to scaled
    float8, e4m3 forward and e5m2 backward (the control)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown rounding {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32" or x.numel() == 0:
            return x
        return _FakeFP8.apply(x)


# ---------------------------------------------------------------------------
# activations and direction / position encodings
# ---------------------------------------------------------------------------


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.exp(torch.clamp(x, -15.0, 15.0)) * g


def trunc_exp(x):
    """exp forward; the gradient is exp of the input clamped to [-15, 15]."""
    return _TruncExp.apply(x)


def freq_encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    """[x, sin x, cos x, sin 2x, cos 2x, ...] by the double-angle ladder."""
    outs = [x]
    if degree > 0:
        s, c = torch.sin(x), torch.cos(x)
        outs += [s, c]
        for _ in range(1, degree):
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
            outs += [s, c]
    return torch.cat(outs, dim=-1)


def _double_factorial(n: int) -> int:
    out = 1
    while n > 1:
        out *= n
        n -= 2
    return out


def sh_encode(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis of unit directions, l^2 + l + m order, Condon-Shortley
    phase, by the Sloan recurrence."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [None] * (degree * degree)
    one = torch.ones_like(x)
    A, B = one, torch.zeros_like(x)
    for m in range(degree):
        p_prev = one * float(_double_factorial(2 * m - 1))
        p_curr = None
        for l in range(m, degree):  # noqa: E741
            if l == m:
                p = p_prev
            elif l == m + 1:
                p = (2 * m + 1) * z * p_prev
                p_curr = p
            else:
                p = ((2 * l - 1) * z * p_curr - (l + m - 1) * p_prev) / (l - m)
                p_prev, p_curr = p_curr, p
            k = math.sqrt((2 * l + 1) / (4.0 * math.pi)
                          * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                out[l * l + l] = k * p
            else:
                c = ((-1.0) ** m) * math.sqrt(2.0) * k
                out[l * l + l + m] = (c * p) * A
                out[l * l + l - m] = (c * p) * B
        A, B = x * A - y * B, x * B + y * A
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------


def cp_features(pos: torch.Tensor, factors: Sequence[torch.Tensor],
                resolutions: Sequence[int]) -> torch.Tensor:
    """CP factor-bank features of positions [M, 3] in [0, 1]: per bank the
    product over axes of the lerped factor line, [M, nb * R]; zero for
    rows outside [0, 1]^3."""
    p = pos.clamp(0.0, 1.0)
    outs = []
    for fb, res in zip(factors, resolutions):
        acc = None
        for ax in range(3):
            pa = p[:, ax] * (res - 1)
            i0 = torch.clamp(torch.floor(pa), max=res - 2).long()
            w = (pa - i0)[:, None]
            v = fb[ax][i0] * (1 - w) + fb[ax][i0 + 1] * w
            acc = v if acc is None else acc * v
        outs.append(acc)
    cp = torch.cat(outs, dim=-1)
    oob = ((pos < 0.0) | (pos > 1.0)).any(dim=-1)
    return torch.where(oob[:, None], torch.zeros((), device=cp.device), cp)


@dataclasses.dataclass(frozen=True)
class HashGeometry:
    """Per-level geometry of a multiresolution hash grid (instant-ngp's
    level scales, row offsets, dense strides and hashed levels)."""

    input_dim: int
    level_dim: int
    scales: Tuple[float, ...]
    offsets: Tuple[int, ...]
    strides: Tuple[Tuple[int, ...], ...]
    hashed: Tuple[bool, ...]
    shift: float

    @property
    def num_levels(self) -> int:
        return len(self.scales)

    @property
    def num_rows(self) -> int:
        return self.offsets[-1]


def hash_geometry(num_levels: int, level_dim: int, base_resolution: int,
                  log2_hashmap_size: int, desired_resolution: int,
                  input_dim: int = 3) -> HashGeometry:
    """The grid of torch-ngp's ``GridEncoder`` (gridtype hash, corners not
    aligned): per-level scale b^l * base - 1 with b set by the finest
    resolution, rows ceil(base * b^l)+1 per axis, capped at 2^log2 and
    rounded up to 8; a level hashes where its dense rows do not fit."""
    s = (math.exp2(math.log2(desired_resolution / base_resolution) / (num_levels - 1))
         if num_levels > 1 else 1.0)
    log2s = math.log2(s)
    max_params = 2**log2_hashmap_size
    offs = [0]
    for lvl in range(num_levels):
        res = int(math.ceil(base_resolution * s**lvl))
        params = min(max_params, (res + 1)**input_dim)
        offs.append(offs[-1] + int(math.ceil(params / 8) * 8))
    scales = tuple(math.exp2(lvl * log2s) * base_resolution - 1.0 for lvl in range(num_levels))
    strides, hashed = [], []
    for lvl in range(num_levels):
        size = offs[lvl + 1] - offs[lvl]
        side = int(math.ceil(scales[lvl])) + 2
        st, stride, overflow = [], 1, False
        for _ in range(input_dim):
            if stride > size:
                overflow = True
                break
            st.append(stride)
            stride *= side
        strides.append(tuple(st))
        hashed.append(overflow or stride > size)
    return HashGeometry(input_dim, level_dim, scales, tuple(offs), tuple(strides),
                        tuple(hashed), 0.5)


def hash_level_rows(geom: HashGeometry, level: int, corner_pos: torch.Tensor) -> torch.Tensor:
    """Integer corner coords [..., D] -> table rows within the level: the
    dense index or the prime XOR hash in wrapping uint32, then % rows."""
    size = geom.offsets[level + 1] - geom.offsets[level]
    index = torch.zeros(corner_pos.shape[:-1], dtype=torch.int64, device=corner_pos.device)
    if geom.hashed[level]:
        for d in range(geom.input_dim):
            index = index ^ ((corner_pos[..., d] * PRIMES[d]) & _M32)
    else:
        for d, s in enumerate(geom.strides[level]):
            index = (index + corner_pos[..., d] * s) & _M32
    return index % size


def hash_corners(x: torch.Tensor, geom: HashGeometry, level: int):
    """Flat table rows [B, 2^D] and d-linear weights [B, 2^D] of the
    points' cell at ``level`` (corner k's axis d is bit d of k)."""
    D = geom.input_dim
    k = torch.arange(2**D, device=x.device)
    corners = (k[:, None] >> torch.arange(D, device=x.device)[None, :]) & 1
    pos = x * geom.scales[level] + geom.shift
    pos_floor = torch.floor(pos)
    frac = pos - pos_floor
    rows = hash_level_rows(geom, level, pos_floor[:, None, :].long() + corners[None])
    sel = torch.where(corners[None] == 1, frac[:, None, :], 1.0 - frac[:, None, :])
    w = sel[..., 0]
    for d in range(1, D):
        w = w * sel[..., d]
    return rows + geom.offsets[level], w


def hash_encode(x: torch.Tensor, table: torch.Tensor, geom: HashGeometry,
                rnd: Rounding) -> torch.Tensor:
    """Hash-grid features [B, L * C] of points in [0, 1]^D; zero outside."""
    table = rnd(table)
    outs = []
    for level in range(geom.num_levels):
        rows, w = hash_corners(x, geom, level)
        outs.append((rnd(w)[..., None] * table[rows]).sum(dim=1))
    out = torch.cat(outs, dim=-1)
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)
    return torch.where(oob[:, None], torch.zeros((), device=x.device), out)


def mlp(x: torch.Tensor, weights: Sequence[torch.Tensor], rnd: Rounding) -> torch.Tensor:
    """Bias-free MLP, ReLU between layers, weights [in, out]; ``rnd`` at
    the input, each weight and each layer's output."""
    h = rnd(x)
    for i, w in enumerate(weights):
        h = h @ rnd(w)
        if i != len(weights) - 1:
            h = torch.relu(h)
        h = rnd(h)
    return h


# ---------------------------------------------------------------------------
# rays and the march lattice
# ---------------------------------------------------------------------------


def near_far_from_aabb(rays_o, rays_d, aabb, min_near: float):
    """Slab test: a miss gets near = far = 1e10; callers test far > near."""
    inv_d = 1.0 / rays_d
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=rays_o.device)
    lo = (aabb[:3] - rays_o) * inv_d
    hi = (aabb[3:] - rays_o) * inv_d
    near = torch.minimum(lo, hi).amax(dim=-1)
    far = torch.maximum(lo, hi).amin(dim=-1)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    big = torch.full_like(near, _BIG)
    return torch.where(miss, big, near), torch.where(miss, big, far)


def rays_from_indices(pose, intrinsics, W: int, inds):
    """Pixel-centre rays of flat pixel indices through a cam-to-world pose."""
    fx, fy, cx, cy = (intrinsics[i] for i in range(4))
    row = (inds // W).float() + 0.5
    col = (inds % W).float() + 0.5
    dirs = torch.stack([(col - cx) / fx, (row - cy) / fy, torch.ones_like(row)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_d = dirs @ pose[:3, :3].T
    return pose[:3, 3].expand_as(rays_d), rays_d


def cascades(r) -> int:
    return 1 + math.ceil(math.log2(max(r["bound"], 1.0)))


def dt_bounds(r) -> Tuple[float, float]:
    dt_min = 2.0 * SQRT3 / r["max_steps"]
    dt_max = 2.0 * SQRT3 * (2 ** (cascades(r) - 1)) / r["grid_size"]
    return dt_min, dt_max


def lattice_probes(r) -> int:
    if r["dt_gamma"] != 0.0:
        raise ValueError("the reference marches the dt_gamma = 0 lattice only")
    return int(math.ceil(r["max_steps"] * max(1.0, r["bound"])))


def t_lattice(nears, r, noise):
    """[N, K] probe t's and step sizes of the uniform lattice; ``noise`` [N]
    shifts each start by that fraction of a step."""
    dt_min, _ = dt_bounds(r)
    t0 = nears + torch.clamp(nears * r["dt_gamma"], *dt_bounds(r)) * noise
    ks = torch.arange(lattice_probes(r), dtype=torch.float32, device=nears.device)
    ts = t0[:, None] + ks[None, :] * dt_min
    return ts, torch.full_like(ts, dt_min)


def _frexp_exponent(x):
    return (torch.floor(torch.log2(torch.clamp(x, min=1e-30))) + 1).to(torch.int32)


def mip_from_pos(x, cas: int):
    return torch.clamp(_frexp_exponent(x.abs().amax(dim=-1)), 0, cas - 1)


def mip_from_dt(dt, grid_size: int, cas: int):
    return torch.clamp(_frexp_exponent(dt * grid_size * 0.5), 0, cas - 1)


def cells(x, dts, r, level=None):
    """Fine cell coords [..., 3] and flat coarse id of points at their mip level."""
    H, cas = r["grid_size"], cascades(r)
    Hc = H // COARSE_FACTOR
    if level is None:
        level = torch.maximum(mip_from_pos(x, cas), mip_from_dt(dts, H, cas))
    mip_bound = torch.clamp(2.0 ** level.float(), max=r["bound"])
    n = torch.clamp((0.5 * (x / mip_bound[..., None] + 1.0) * H).to(torch.int32), 0, H - 1)
    c = n // COARSE_FACTOR
    flat = ((level * Hc + c[..., 0]) * Hc + c[..., 1]) * Hc + c[..., 2]
    return n, flat.to(torch.int32)


def points(rays_o, rays_d, ts, bound):
    return torch.clamp(rays_o[:, None, :] + rays_d[:, None, :] * ts[..., None], -bound, bound)


def _ascending(keys, k: int):
    return -torch.topk(-keys, k, dim=1).values


# ---------------------------------------------------------------------------
# occupancy grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Grid:
    density: torch.Tensor  # [CAS, H, H, H] f32, -1 = never seen
    occ: torch.Tensor  # [CAS, H, H, H] bool
    iters: int
    coarse: torch.Tensor  # [R, 128] f32 bytes of the pooled grid
    fine: torch.Tensor  # [CAS * Hc^3, 18] int64: 64 bits, 64 eroded log densities


def _erode3(g):
    for ax in (1, 2, 3):
        z = torch.zeros_like(g.narrow(ax, 0, 1))
        n = g.shape[ax]
        lo = torch.cat([z, g.narrow(ax, 0, n - 1)], dim=ax)
        hi = torch.cat([g.narrow(ax, 1, n - 1), z], dim=ax)
        g = torch.minimum(g, torch.minimum(lo, hi))
    return g


def _blocks(grid):
    cas, H = grid.shape[0], grid.shape[1]
    F = COARSE_FACTOR
    Hc = H // F
    b = grid.reshape(cas, Hc, F, Hc, F, Hc, F).permute(0, 1, 3, 5, 2, 4, 6)
    return b.reshape(cas * Hc**3, F**3)


def pack_payloads(occ, density=None):
    """(coarse byte payload, fine payload) of an occupancy grid."""
    blocks = _blocks(occ)
    bits = blocks.long()
    shifts = torch.arange(32, device=occ.device)
    w0 = (bits[:, :32] << shifts).sum(dim=1)
    w1 = (bits[:, 32:] << shifts).sum(dim=1)
    R = w0.shape[0]
    if density is None:
        dens_words = w0.new_zeros((R, 16))
    else:
        d = _blocks(_erode3(torch.clamp(density, min=0.0)))
        code = torch.where(
            d > 2.0 ** -16,
            torch.clamp(torch.floor((torch.log2(torch.clamp(d, min=1e-30)) + 16.0) * 8.0),
                        1.0, 255.0),
            torch.zeros((), device=d.device)).long()
        dens_words = (code.reshape(R, 16, 4) << (torch.arange(4, device=d.device) * 8)).sum(dim=2)
    fine = torch.cat([w0[:, None], w1[:, None], dens_words], dim=1)
    flat = blocks.any(dim=1)
    bytes_ = (flat.reshape(-1, 8).long() << torch.arange(8, device=occ.device)).sum(dim=1)
    pad = (-bytes_.shape[0]) % 128
    if pad:
        bytes_ = torch.cat([bytes_, bytes_.new_zeros(pad)])
    return bytes_.float().reshape(-1, 128), fine


def init_grid(r, device) -> Grid:
    H, cas = r["grid_size"], cascades(r)
    occ = torch.ones((cas, H, H, H), dtype=torch.bool, device=device)
    coarse, fine = pack_payloads(occ)
    return Grid(torch.zeros((cas, H, H, H), device=device), occ, 0, coarse, fine)


def mark_untrained(grid: Grid, poses, intrinsics, r) -> Grid:
    """Cells whose centre no training camera sees (in front, inside the
    field of view widened by one cell) become -1."""
    Hg, cas = r["grid_size"], cascades(r)
    fx, fy, cx, cy = (float(v) for v in np.asarray(intrinsics, np.float32)[:4])
    poses = np.asarray(poses, np.float32)
    idx = np.arange(Hg, dtype=np.float32)
    base = np.stack(np.meshgrid(idx, idx, idx, indexing="ij"), axis=-1).reshape(-1, 3)
    base = 2.0 * base / (Hg - 1) - 1.0
    vis = np.empty((cas, Hg, Hg, Hg), np.bool_)
    for c in range(cas):
        bound = min(2.0**c, r["bound"])
        half = bound / Hg
        pts = base * (bound - half)
        seen = np.zeros(pts.shape[0], np.bool_)
        for p in range(poses.shape[0]):
            cam = (pts - poses[p, :3, 3]) @ poses[p, :3, :3]
            z = cam[:, 2]
            seen |= ((z > 0.01) & (np.abs(cam[:, 0]) < cx / fx * z + 2 * half)
                     & (np.abs(cam[:, 1]) < cy / fy * z + 2 * half))
        vis[c] = seen.reshape(Hg, Hg, Hg)
    v = torch.from_numpy(vis).to(grid.density.device)
    return dataclasses.replace(
        grid, density=torch.where(v, grid.density, torch.full((), -1.0, device=v.device)))


@torch.no_grad()
def refresh(grid: Grid, density_fn, r, generator: torch.Generator,
            density_scale: float = 1.0, decay: float = 0.95) -> Grid:
    """A full refresh (the first 16 of a run): every cell's density at a
    jittered cell centre, drawn per cascade as one [H^3, 3] uniform from
    ``generator``; EMA-max update, threshold at min(mean, thresh), repack."""
    H, cas = r["grid_size"], cascades(r)
    if grid.iters >= 16:
        raise ValueError("the reference refreshes the whole grid only (the first 16 refreshes)")
    dev = grid.density.device
    ax = torch.arange(H, device=dev)
    coords = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1).reshape(-1, 3)
    tmp = []
    for c in range(cas):
        u = torch.rand((H**3, 3), generator=generator, device=dev)
        bound = min(2.0**c, r["bound"])
        half = bound / H
        sig = []
        for i in range(0, H**3, 1 << 17):
            xyz = (2.0 * coords[i:i + (1 << 17)].float() / (H - 1) - 1.0) * (bound - half)
            xyz = xyz + (u[i:i + (1 << 17)] * 2.0 - 1.0) * half
            sig.append(density_fn(xyz)[0] * density_scale)
        tmp.append(torch.cat(sig).reshape(H, H, H))
    tmp = torch.stack(tmp)
    old = grid.density
    valid = (old >= 0) & (tmp >= 0)
    new = torch.where(valid, torch.maximum(old * decay, tmp), old)
    thresh = torch.clamp(torch.clamp(new, min=0.0).mean(), max=r["density_thresh"])
    occ = new > thresh
    coarse, fine = pack_payloads(occ, new)
    return Grid(new, occ, grid.iters + 1, coarse, fine)


def coarse_lookup(payload, flatcell):
    flat = payload.reshape(-1)
    n_bytes = flat.shape[0]
    byte_idx = flatcell >> 3
    inside = (flatcell >= 0) & (byte_idx < n_bytes)
    byte = flat[byte_idx.clamp(0, n_bytes - 1).long()].to(torch.int32)
    return (((byte >> (flatcell & 7)) & 1) > 0) & inside


# ---------------------------------------------------------------------------
# the marches
# ---------------------------------------------------------------------------


def turbo_budgets(r) -> Tuple[int, int, int]:
    S = min(r["max_samples_per_ray"], r["max_steps"])
    K = lattice_probes(r)
    K2 = max(min(r["coarse_candidates"], K), ALIGN)
    S = max(ALIGN, min(-(-S // ALIGN) * ALIGN, K2 // ALIGN * ALIGN))
    return S, K2, r["crossing_slots"]


def march_turbo(rays_o, rays_d, grid: Grid, r, noise):
    """The turbo march: coarse test of every lattice probe, the first K2
    survivors, crossings (runs of one coarse cell) read their fine bits
    while within the U crossing slots, the first S fine survivors."""
    S, K2, U = turbo_budgets(r)
    N = rays_o.shape[0]
    dev = rays_o.device
    F = COARSE_FACTOR
    dt_min, _ = dt_bounds(r)
    nears, fars = near_far_from_aabb(rays_o, rays_d, (-r["bound"],) * 3 + (r["bound"],) * 3,
                                     r["min_near"])
    hit = fars > nears
    fars_c = torch.where(hit, fars, nears)
    ts, dts = t_lattice(nears, r, noise)
    _, flat_c = cells(points(rays_o, rays_d, ts, r["bound"]), dts, r)
    valid_c = coarse_lookup(grid.coarse, flat_c) & (ts < fars_c[:, None]) & hit[:, None]
    tbits = ts.contiguous().view(torch.int32)
    cand = _ascending(torch.where(valid_c, tbits, tbits + _TKEY_INVALID), K2)
    cmask = cand < _TKEY_THRESH
    ts2 = torch.where(cmask, cand, cand - _TKEY_INVALID).view(torch.float32)
    dts2 = torch.full_like(ts2, dt_min)
    n2, flat2 = cells(points(rays_o, rays_d, ts2, r["bound"]), dts2, r)
    change = torch.cat([torch.ones((N, 1), dtype=torch.bool, device=dev),
                        flat2[:, 1:] != flat2[:, :-1]], dim=1) & cmask
    slot = torch.cumsum(change.int(), dim=1) - 1
    in_budget = slot < U
    first = change & in_budget
    slot_cell = torch.full((N, U + 1), -1, dtype=torch.int64, device=dev)
    slot_cell.scatter_(1, torch.where(first, slot, U).long(), torch.where(first, flat2.long(), -1))
    pay = grid.fine[slot_cell[:, :U].clamp(min=0)]
    slot_cl = slot.clamp(0, U - 1).long()
    off = n2 % F
    bit6 = ((off[..., 0] * F + off[..., 1]) * F + off[..., 2]).long()
    word = torch.gather(pay[..., 0:2], 1, slot_cl[..., None].expand(N, K2, 2))
    word = torch.gather(word, 2, (bit6 >> 5)[..., None])[..., 0]
    valid_f = (((word >> (bit6 & 31)) & 1) > 0) & cmask & in_budget
    sel = _ascending(torch.where(valid_f, ts2.view(torch.int32),
                                 ts2.view(torch.int32) + _TKEY_INVALID), S)
    n_total = valid_f.sum(dim=-1)
    mask = torch.arange(S, device=dev)[None, :] < n_total[:, None]
    ts_c = torch.where(mask, sel, 0).view(torch.float32)
    dts_c = torch.where(mask, torch.full_like(ts_c, dt_min), torch.zeros((), device=dev))
    return {"nears": nears, "fars": fars, "ts": ts_c, "deltas": dts_c, "mask": mask,
            "n_total": n_total}


def turbo_train_mask(m, r):
    """The training budget: N * compact_mean_samples compact slots, each
    ray's survivors padded to ALIGN, dealt ray-major; what does not fit
    is dropped from the tail of the ray order."""
    mask = m["mask"]
    N, S = mask.shape
    n8 = torch.clamp((m["n_total"] + ALIGN - 1) // ALIGN * ALIGN, max=S)
    limit = min(N * r["compact_mean_samples"], N * S)
    offsets = torch.cumsum(n8, dim=0) - n8
    iota = torch.arange(S, device=mask.device)[None, :]
    return mask & (iota < n8[:, None]) & ((offsets[:, None] + iota) < limit)


def march_v1(rays_o, rays_d, grid: Grid, r, noise):
    """The v1 march: the first S occupied lattice probes of each ray on
    the dense grid at the larger of the position's and the step's mip."""
    S = min(r["max_samples_per_ray"], r["max_steps"])
    dev = rays_o.device
    H, cas = r["grid_size"], cascades(r)
    nears, fars = near_far_from_aabb(rays_o, rays_d, (-r["bound"],) * 3 + (r["bound"],) * 3,
                                     r["min_near"])
    hit = fars > nears
    fars_c = torch.where(hit, fars, nears)
    ts, dts = t_lattice(nears, r, noise)
    K = ts.shape[1]
    x = points(rays_o, rays_d, ts, r["bound"])
    level = torch.maximum(mip_from_pos(x, cas), mip_from_dt(dts, H, cas))
    n, _ = cells(x, dts, r, level)
    cell = (n[..., 0].long() * H + n[..., 1]) * H + n[..., 2]
    occ = grid.occ.reshape(cas, -1)[level.long(), cell]
    valid = occ & (ts < fars_c[:, None]) & hit[:, None]
    ks = torch.arange(K, dtype=torch.int32, device=dev)
    probe = (_ascending(torch.where(valid, ks, ks + K), S) % K).long()
    mask = torch.arange(S, device=dev)[None, :] < valid.sum(dim=-1)[:, None]
    zero = torch.zeros((), device=dev)
    return {"nears": nears, "fars": fars, "mask": mask,
            "ts": torch.where(mask, torch.gather(ts, 1, probe), zero),
            "deltas": torch.where(mask, torch.gather(dts, 1, probe), zero)}


def composite(sigmas, rgbs, ts, deltas, mask, nears, fars, density_scale=1.0,
              t_thresh=1e-4) -> Dict[str, torch.Tensor]:
    """Masked front-to-back compositing; transmittance below ``t_thresh``
    stops contributing."""
    alphas = 1.0 - torch.exp(-deltas * density_scale * sigmas)
    alphas = torch.where(mask, alphas, torch.zeros((), device=alphas.device))
    shifted = torch.cat([torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-15], dim=-1)
    trans = torch.cumprod(shifted, dim=-1)[..., :-1]
    weights = torch.where(trans > t_thresh, alphas * trans, torch.zeros((), device=alphas.device))
    return {"weights_sum": weights.sum(dim=-1),
            "image": (weights[..., None] * rgbs).sum(dim=-2)}


def scatter_slots(mask: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Values of the mask's true slots (row-major) -> [N, S, F], zero elsewhere."""
    out = vals.new_zeros(mask.shape + vals.shape[1:])
    return out.index_put((mask,), vals)


def rays_in_box(x: torch.Tensor) -> torch.Tensor:
    return ((x >= 0.0) & (x <= 1.0)).all(dim=-1)


def corner_rows(x: torch.Tensor, geom: HashGeometry, level: int) -> torch.Tensor:
    """The table rows [B, 2^D] a hash-grid level reads for points x (for the
    yardstick's byte counts)."""
    return hash_corners(x, geom, level)[0]
