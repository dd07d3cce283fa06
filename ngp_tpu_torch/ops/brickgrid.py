"""Brick-halo multiresolution grid encoding (``ngp_tpu/ops/brickgrid.py``).

One table row holds a brick of a level's cell grid, stride 2, with its
full 3x3x3 halo of cell values (27 * C floats): the trilinear stencil of
any point whose base cell lies in the brick is inside that row, so the
encoding gathers ONE row per (point, level) and selects the 2x2x2
stencil out of the halo by a 2-way masked select per axis. The JAX
package built it to cut the TPU's gather row count; halo copies of one
cell receive their gradients separately (seams at brick boundaries, as
the MLP absorbs hash collisions). The geometry (level scales, the
[0, 1]^3 domain, zeros outside) is the hash grid's; a level's bricks are
dense row-major until they overflow ``2^log2_hashmap_size`` rows, then
hashed by JAX's primes in wrapping uint32 (taken here in int64, cut to 32
bits after each product and sum, as ``ops/hashgrid.py`` does).

JAX leaves all of it to XLA (no Pallas kernel). On the card two kernels
run it (``csrc/brick_kernels.cu``, wrapped by ``brick_encode_fwd`` and
``brick_table_grad``): the forward reads only the 8 stencil cells of each
row, and the table gradient adds each (point, level)'s 8 stencil
products straight into a zeroed f32 table gradient: one f32 sum of all
levels, as JAX gathers all levels in one take so that autodiff emits a
single scatter-add. ``BrickEncode`` ties them together. A third kernel,
``brick_encode_bwd``, writes the gathered rows' cotangent, which
``scatter_add_rows`` (``ops/kernels/scatter.py``) added into the table
gradient until the two were fused; no path runs it. On the CPU the same
functions take their plain versions: ``brick_encode_plain`` (the row
gather by ``GatherRows``, the stencil's masked selects and the weights in
torch ops), ``brick_encode_bwd_plain`` (the cotangent autograd of the
former hands to the row gather, bit for bit) and
``brick_table_grad_plain`` (those rows added by
``scatter_add_rows_plain``). The gradient in x is autograd of
``brick_encode_plain`` on every device (no path asks for it; each call
counts under ``LAUNCHES["brick_x_grad_plain"]``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ngp_tpu_torch.ops.kernels import LAUNCHES, scatter
from ngp_tpu_torch.ops.kernels.build import check_launch, int_array, load_library

_PRIMES = (1, 2654435761, 805459861)
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class BrickGridConfig:
    input_dim: int = 3  # bricks are 3-D only (the hot NeRF case)
    num_levels: int = 8
    level_dim: int = 4
    per_level_scale: float = 2.0
    base_resolution: int = 16
    log2_hashmap_size: int = 15  # bricks per level cap
    desired_resolution: Optional[int] = None

    def __post_init__(self):
        if self.input_dim != 3:
            raise ValueError("BrickGrid supports input_dim=3")
        if self.desired_resolution is not None and self.num_levels > 1:
            s = math.exp2(math.log2(self.desired_resolution / self.base_resolution)
                          / (self.num_levels - 1))
            object.__setattr__(self, "per_level_scale", s)

    def level_scale(self, level: int) -> float:
        return math.exp2(level * math.log2(self.per_level_scale)) * self.base_resolution - 1.0

    def level_resolution(self, level: int) -> int:
        return int(math.ceil(self.level_scale(level))) + 1

    def level_bricks(self, level: int) -> Tuple[int, bool]:
        """(#brick rows, hashed?) for a level. Bricks tile the cell grid
        with stride 2; dense until the brick count overflows the cap."""
        side = self.level_resolution(level) // 2 + 1
        cap = 2**self.log2_hashmap_size
        return (side**3, False) if side**3 <= cap else (cap, True)

    @property
    def offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for level in range(self.num_levels):
            offs.append(offs[-1] + self.level_bricks(level)[0])
        return tuple(offs)

    @property
    def num_rows(self) -> int:
        return self.offsets[-1]

    @property
    def row_width(self) -> int:
        return 27 * self.level_dim

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda") -> torch.Tensor:
        """U(-1e-4, 1e-4) table [num_rows, row_width], drawn from a CPU
        generator and placed on ``device``."""
        u = torch.rand((self.num_rows, self.row_width), generator=generator)
        return ((u * 2.0 - 1.0) * 1e-4).to(device=device, dtype=dtype)


def _brick_index(cfg: BrickGridConfig, level: int, bcoord: torch.Tensor) -> torch.Tensor:
    """Brick coords [..., 3] (int64) -> row index within the level (int64)."""
    n, hashed = cfg.level_bricks(level)
    bc = bcoord & _M32  # the uint32 view of JAX's int32 coords
    if not hashed:
        side = cfg.level_resolution(level) // 2 + 1
        idx = (((bc[..., 0] * side) & _M32) + bc[..., 1]) & _M32
        idx = (((idx * side) & _M32) + bc[..., 2]) & _M32
    else:
        idx = torch.zeros_like(bc[..., 0])
        for d in range(3):
            idx = idx ^ ((bc[..., d] * _PRIMES[d]) & _M32)
    return idx % n


def dense_field_to_brick_table(field: np.ndarray, cfg: BrickGridConfig,
                               level: int) -> np.ndarray:
    """One dense level's brick rows from a cell field [R, R, R, C] (R = the
    level resolution, +1 for the outer corners): consistent halo copies,
    which make the encoding exact trilinear interpolation of the field."""
    n, hashed = cfg.level_bricks(level)
    if hashed:
        raise ValueError("only dense levels can be built from a field")
    side = cfg.level_resolution(level) // 2 + 1
    C = cfg.level_dim
    padded = np.zeros((2 * side + 1,) * 3 + (C,), field.dtype)
    padded[: field.shape[0], : field.shape[1], : field.shape[2]] = field
    # halo[bx, by, bz] = padded[2b : 2b + 3] per axis, row-major over bricks
    win = np.lib.stride_tricks.sliding_window_view(padded, (3, 3, 3), axis=(0, 1, 2))
    halos = win[::2, ::2, ::2][:side, :side, :side]  # [side^3 bricks, C, 3, 3, 3]
    return np.ascontiguousarray(np.moveaxis(halos, 3, -1).reshape(n, 27 * C))


def _stencils(x: torch.Tensor, cfg: BrickGridConfig, dt: torch.dtype):
    """The plain versions' geometry of points x [..., 3]: (whether each
    lies outside [0, 1]^3 [N], its row per level int32 [N * L] (level
    fastest), the fractions [N, L, 3] in ``dt``, the low bits of the base
    cell [N, L, 3] int64, the trilinear weights wxyz [N, L, 2, 2, 2] in
    ``dt``, rounded as JAX's chain rounds them)."""
    xf = x.reshape(-1, 3)
    xf = xf.to(torch.promote_types(xf.dtype, torch.float32))
    oob = ((xf < 0.0) | (xf > 1.0)).any(dim=-1)
    idx, frac, lo = [], [], []
    for level in range(cfg.num_levels):
        pos = xf * cfg.level_scale(level) + 0.5
        x0 = torch.floor(pos)
        frac.append((pos - x0).to(dt))
        x0 = x0.long()
        lo.append(x0 & 1)
        idx.append(_brick_index(cfg, level, x0 >> 1) + cfg.offsets[level])
    if cfg.num_rows >= 2**31:
        raise ValueError(f"brick_encode: {cfg.num_rows} table rows do not fit int32 indices")
    idx = torch.stack(idx, dim=1).reshape(-1).to(torch.int32)
    f = torch.stack(frac, dim=1)
    w = torch.stack([1.0 - f, f], dim=-1)  # [N, L, 3, 2]
    wxyz = w[:, :, 0, :, None, None] * w[:, :, 1, None, :, None] * w[:, :, 2, None, None, :]
    return oob, idx, torch.stack(lo, dim=1), wxyz


def brick_encode_plain(x: torch.Tensor, table: torch.Tensor, cfg: BrickGridConfig,
                       compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``brick_encode`` in torch ops: one gather of a 27 * C row per point
    and level (``GatherRows``), the stencil's masked selects, the
    trilinear weights (in the compute type, as JAX casts the table and
    the fractions). Differentiable in x and the table by autograd."""
    dt = compute_dtype or table.dtype
    oob, idx, lo, wxyz = _stencils(x, cfg, dt)
    N, L, C = oob.shape[0], cfg.num_levels, cfg.level_dim
    lo = lo == 1
    halo = scatter.GatherRows.apply(table, idx).to(dt).reshape(N, L, 3, 3, 3, C)

    def pick(t, axis, m):
        """The 2 of 3 halo entries along ``axis`` at the stencil's offset."""
        hi, low = t.narrow(axis, 1, 2), t.narrow(axis, 0, 2)
        return torch.where(m.reshape(m.shape + (1,) * (t.dim() - 2)), hi, low)

    s = pick(halo, 2, lo[..., 0])  # [N, L, 2, 3, 3, C]
    s = pick(s, 3, lo[..., 1])  # [N, L, 2, 2, 3, C]
    s = pick(s, 4, lo[..., 2])  # [N, L, 2, 2, 2, C]
    out = (s * wxyz[..., None]).sum(dim=(2, 3, 4)).reshape(N, L * C)
    out = torch.where(oob[:, None], torch.zeros((), dtype=out.dtype, device=out.device), out)
    return out.reshape(*x.shape[:-1], cfg.output_dim)


def brick_encode_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                           cfg: BrickGridConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx int32 [N * L], rows f32 [N * L, 27 * C]) for points x [N, 3]
    and the output's cotangent g [N, L * C] (the compute type): each (point,
    level)'s table row, -1 outside the box, and the cotangent that autograd
    of ``brick_encode_plain`` hands to its row gather, bit for bit. The 8
    stencil cells of a row hold the products g * wxyz in the compute type
    (a -0 made +0, as autograd's selects add each product to a zero) cast
    to f32; every other cell, and every row outside the box, is zero."""
    dt = g.dtype
    oob, idx, lo, wxyz = _stencils(x, cfg, dt)
    N, L, C = oob.shape[0], cfg.num_levels, cfg.level_dim
    idx = torch.where(oob[:, None], -1, idx.view(N, L)).reshape(-1)
    gl = torch.where(oob[:, None], torch.zeros((), dtype=dt, device=g.device), g)
    prod = (gl.reshape(N, L, 1, 1, 1, C) * wxyz[..., None]).float() + 0.0
    ijk = torch.arange(2, device=lo.device)
    cells = ((lo[..., 0, None, None, None] + ijk[:, None, None]) * 9
             + (lo[..., 1, None, None, None] + ijk[None, :, None]) * 3
             + (lo[..., 2, None, None, None] + ijk[None, None, :]))  # [N, L, 2, 2, 2]
    rows = torch.zeros((N * L, 27, C), dtype=torch.float32, device=g.device)
    rows.scatter_(1, cells.reshape(N * L, 8, 1).expand(-1, -1, C), prod.reshape(N * L, 8, C))
    return idx, rows.reshape(N * L, 27 * C)


def _divisor_magic(d: int) -> Tuple[int, int]:
    """(magic, shift) for dividing any uint32 h by d >= 1 without a
    division, as the kernels do (``csrc/brick_kernels.cu:level_row``):
    with t = (magic * h) >> 32, h // d = (t + ((h - t) >> 1)) >> shift
    (Granlund and Montgomery's round-up multiplier). (0, 0) where d is a
    power of two: h % d is then h & (d - 1)."""
    if d & (d - 1) == 0:
        return 0, 0
    l = (d - 1).bit_length()  # ceil(log2 d) >= 2
    return (1 << 32) * ((1 << l) - d) // d + 1, l - 1


@functools.lru_cache(maxsize=16)
def _level_args(cfg: BrickGridConfig):
    """The kernels' per-level arrays: scale (rounded to f32, as torch
    rounds a Python scalar against an f32 tensor), first row, rows, the
    side of a dense level's brick grid, whether the level is hashed, and
    the magic and shift of division by its rows (``_divisor_magic``)."""
    L = cfg.num_levels
    levels = [cfg.level_bricks(level) for level in range(L)]
    scales = [float(np.float32(cfg.level_scale(level))) for level in range(L)]
    magic = [_divisor_magic(n) for n, _ in levels]
    return ((ctypes.c_float * L)(*scales),
            int_array(cfg.offsets[:L]),
            (ctypes.c_uint * L)(*[n for n, _ in levels]),
            (ctypes.c_uint * L)(*[cfg.level_resolution(level) // 2 + 1 for level in range(L)]),
            int_array([int(hashed) for _, hashed in levels]),
            (ctypes.c_uint * L)(*[m for m, _ in magic]),
            int_array([sh for _, sh in magic]))


def _check_brick_args(name: str, x: torch.Tensor, other: torch.Tensor, shape, what: str,
                      cfg: BrickGridConfig) -> None:
    """Raise ValueError unless x is floating [N, 3] and ``other`` (the
    table or the cotangent) floating of ``shape`` on x's device; on the
    card also unless the kernels take the configuration."""
    if not (x.is_floating_point() and other.is_floating_point()):
        raise ValueError(f"{name}: x and the {what} must be floating point")
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"{name}: x must be [N, 3], not {tuple(x.shape)}")
    if tuple(other.shape) != tuple(shape):
        raise ValueError(f"{name}: the {what} must be {tuple(shape)}, not {tuple(other.shape)}")
    if other.device != x.device:
        raise ValueError(f"{name}: x and the {what} lie on {x.device} and {other.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {x.device}")
    if x.device.type == "cuda":
        if x.dtype == torch.float64:
            raise ValueError(f"{name}: the kernel takes f32, bf16 or f16 points")
        if cfg.level_dim not in (1, 2, 4, 8) or cfg.num_levels > 32:
            raise ValueError(f"{name}: the kernel takes level_dim 1, 2, 4 or 8 and at most 32 "
                             f"levels, not {cfg.level_dim} and {cfg.num_levels}")
        if cfg.num_rows >= 2**31 or x.shape[0] * cfg.num_levels >= 2**31:
            raise ValueError(f"{name}: more rows or items than int32 indices reach")


def brick_encode_fwd(x: torch.Tensor, table: torch.Tensor, cfg: BrickGridConfig,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The encoding of points x [N, 3] -> [N, L * C] in ``compute_dtype``
    (the table's when None), zeros outside the box. On the card one kernel
    launch (table f32 [num_rows, 27 * C], contiguous and 16-byte aligned;
    f32 or bf16 output): the 8 products of a point and level summed in f32
    and rounded once, so within one rounding of the compute type of the
    plain version's sum; ``brick_encode_plain`` on the CPU."""
    _check_brick_args("brick_encode_fwd", x, table, (cfg.num_rows, cfg.row_width), "table",
                      cfg)
    dt = compute_dtype or table.dtype
    if x.device.type == "cpu":
        return brick_encode_plain(x, table, cfg, dt)
    if table.dtype != torch.float32 or not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("brick_encode_fwd: the table must be a contiguous, 16-byte aligned f32 "
                         "tensor")
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"brick_encode_fwd: the kernel computes in f32 or bf16, not {dt}")
    xf = x.float().contiguous()
    N = xf.shape[0]
    out = torch.empty((N, cfg.output_dim), dtype=dt, device=x.device)
    if N == 0:
        return out
    lib = load_library()
    err = lib.ngp_brick_encode_fwd(xf.data_ptr(), N, table.data_ptr(), cfg.level_dim,
                                   cfg.num_levels, *_level_args(cfg),
                                   int(dt == torch.bfloat16), out.data_ptr(),
                                   torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("brick_encode_fwd", err)
    LAUNCHES["brick_encode_fwd"] += 1
    return out


def brick_encode_bwd(x: torch.Tensor, g: torch.Tensor,
                     cfg: BrickGridConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx int32 [N * L], rows f32 [N * L, 27 * C]): the table row of each
    point and level (-1 outside the box) and the cotangent of the gathered
    rows under the output's cotangent g [N, L * C] (f32 or bf16, the
    compute type), as ``brick_encode_bwd_plain`` makes them. On the card
    one kernel launch, bit-equal to the plain version; the plain version on
    the CPU. No path calls it (``brick_table_grad`` adds the same products
    without the rows)."""
    _check_brick_args("brick_encode_bwd", x, g, (x.shape[0], cfg.output_dim), "cotangent", cfg)
    if x.device.type == "cpu":
        return brick_encode_bwd_plain(x, g, cfg)
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"brick_encode_bwd: the kernel takes an f32 or bf16 cotangent, not "
                         f"{g.dtype}")
    xf, g = x.float().contiguous(), g.contiguous()
    N, L = xf.shape[0], cfg.num_levels
    idx = torch.empty((N * L,), dtype=torch.int32, device=x.device)
    rows = torch.empty((N * L, cfg.row_width), dtype=torch.float32, device=x.device)
    if N == 0:
        return idx, rows
    lib = load_library()
    err = lib.ngp_brick_encode_bwd(xf.data_ptr(), N, g.data_ptr(), cfg.level_dim, L,
                                   *_level_args(cfg), int(g.dtype == torch.bfloat16),
                                   idx.data_ptr(), rows.data_ptr(),
                                   torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("brick_encode_bwd", err)
    LAUNCHES["brick_encode_bwd"] += 1
    return idx, rows


def brick_table_grad_plain(x: torch.Tensor, g: torch.Tensor, cfg: BrickGridConfig,
                           out: torch.Tensor) -> torch.Tensor:
    """``out`` (f32 [num_rows, 27 * C]) += the table gradient of
    ``brick_encode_plain`` on points x [N, 3] under the output's cotangent
    g [N, L * C] (the compute type): ``brick_encode_bwd_plain``'s rows
    added by ``scatter_add_rows_plain``. Returns out."""
    idx, rows = brick_encode_bwd_plain(x, g, cfg)
    return scatter.scatter_add_rows_plain(idx, rows, out)


def brick_table_grad(x: torch.Tensor, g: torch.Tensor, cfg: BrickGridConfig,
                     out: torch.Tensor) -> torch.Tensor:
    """``out`` (f32 [num_rows, 27 * C], contiguous) += the table gradient
    of the encoding of points x [N, 3] under the output's cotangent g
    [N, L * C] (f32 or bf16, the compute type), in place; returns out. On
    the card one kernel launch: each (point, level)'s 8 stencil products,
    rounded in the compute type as ``brick_encode_bwd_plain`` rounds them,
    added into its row by f32 atomics, so within f32 summation order of
    the plain version; ``brick_table_grad_plain`` on the CPU."""
    _check_brick_args("brick_table_grad", x, g, (x.shape[0], cfg.output_dim), "cotangent", cfg)
    if (tuple(out.shape) != (cfg.num_rows, cfg.row_width) or out.dtype != torch.float32
            or out.device != x.device):
        raise ValueError(f"brick_table_grad: out must be f32 {(cfg.num_rows, cfg.row_width)} on "
                         f"{x.device}, not {out.dtype} {tuple(out.shape)} on {out.device}")
    if x.device.type == "cpu":
        return brick_table_grad_plain(x, g, cfg, out)
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"brick_table_grad: the kernel takes an f32 or bf16 cotangent, not "
                         f"{g.dtype}")
    if not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError("brick_table_grad: out must be contiguous and 16-byte aligned")
    xf, g = x.float().contiguous(), g.contiguous()
    if xf.shape[0] == 0:
        return out
    lib = load_library()
    err = lib.ngp_brick_table_grad(xf.data_ptr(), xf.shape[0], g.data_ptr(), cfg.level_dim,
                                   cfg.num_levels, *_level_args(cfg),
                                   int(g.dtype == torch.bfloat16), out.data_ptr(),
                                   torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("brick_table_grad", err)
    LAUNCHES["brick_table_grad"] += 1
    return out


class BrickEncode(torch.autograd.Function):
    """``brick_encode`` on points x [N, 3]: the forward by
    ``brick_encode_fwd``; the table gradient by ``brick_table_grad`` into
    a zeroed f32 table, cast to the table's type; the gradient in x by
    autograd of ``brick_encode_plain`` in x alone; each only where
    autograd asks for it."""

    @staticmethod
    def forward(ctx, x, table, cfg, compute_dtype):
        ctx.save_for_backward(x, table)
        ctx.cfg, ctx.compute_dtype = cfg, compute_dtype
        return brick_encode_fwd(x, table, cfg, compute_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        d_x = d_table = None
        if ctx.needs_input_grad[1]:
            d_table = torch.zeros(table.shape, dtype=torch.float32, device=g.device)
            d_table = brick_table_grad(x, g, ctx.cfg, d_table).to(table.dtype)
        if ctx.needs_input_grad[0]:
            LAUNCHES["brick_x_grad_plain"] += 1
            with torch.enable_grad():
                xx = x.detach().requires_grad_()
                (d_x,) = torch.autograd.grad(
                    brick_encode_plain(xx, table.detach(), ctx.cfg, ctx.compute_dtype), xx, g)
        return d_x, d_table, None, None


def brick_encode(x: torch.Tensor, table: torch.Tensor, cfg: BrickGridConfig,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Encode x in [0, 1]^3 -> [..., L * C] in ``compute_dtype`` (the
    table's dtype when None); zeros outside the box. Differentiable in x
    and the table (``BrickEncode``: the kernels on the card, the plain
    versions on the CPU)."""
    if x.shape[-1] != 3:
        raise ValueError(f"brick_encode: x must be [..., 3], not {tuple(x.shape)}")
    out = BrickEncode.apply(x.reshape(-1, 3), table, cfg, compute_dtype or table.dtype)
    return out.reshape(*x.shape[:-1], cfg.output_dim)
