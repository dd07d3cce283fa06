"""Multiresolution hash / tiled grid encoder: the CUDA kernels' wrappers
and their plain versions.

The JAX package leaves this encoder to XLA (``ngp_tpu/ops/hashgrid.py:
grid_encode``, the take and einsum at ``hashgrid.py:203-204``);
``grid_encode_fwd`` and ``grid_encode_bwd`` do that work by hand, in
``csrc/grid_kernels.cu``, and ``grid_encode_bwd_x`` in
``csrc/grid_bwd_x_kernels.cu``, whose headers say what bounds them.
``GridEncode`` is the encoder with its gradients: in the table, the
backward adds every corner's cotangent row w * g into the f32 gradient in
one atomic pass (``grid_encode_bwd``), skipping zero rows, the VJP of the
take and the einsum; its plain version makes the corner rows
(``grid_encode_bwd_rows_plain``) and adds them with ``index_add_``. In the
points, ``grid_encode_bwd_x`` gives what JAX's autodiff of ``grid_encode``
gives for x (``hashgrid.py:161-209``); its plain version is autograd of
``grid_encode_plain``.

``GridGeometry`` is what the kernels read of a ``GridConfig``
(``ops/hashgrid.py``): per level the interpolation scale, row offset and
count, the dense strides of the dims that fit the level and whether the
level hashes. The kernels take points of D = 2 (the background net's
sphere coordinates), D = 3 or D = 4 (D-NeRF's hyper grid) dimensions; the
plain versions take any D.

Rounding with the bf16 compute type (a bf16 output): table values and
corner weights are rounded to bf16 and their products summed in f32,
then each feature rounded once, as JAX's bf16 einsum on the CPU does.
Backward, the product w * g is rounded to bf16 (the einsum's VJP) and
the gradient sums in f32, where JAX sums in bf16 and casts; in the points,
each corner's dot product of the cotangent with its bf16 row is rounded
to bf16 (the einsum's VJP in the weights), the rest is f32.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ngp_tpu_torch import tracing
from ngp_tpu_torch.ops.kernels import LAUNCHES
from ngp_tpu_torch.ops.kernels.build import check_launch, int_array, load_library
from ngp_tpu_torch.ops.kernels.scatter import scatter_add_rows_plain

PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_M32 = 0xFFFFFFFF
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_LEVELS = 32
_KERNEL_DIMS = (2, 3, 4)


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Static per-level geometry of a multiresolution grid."""

    input_dim: int
    level_dim: int
    scales: Tuple[float, ...]
    offsets: Tuple[int, ...]  # L + 1 cumulative row offsets
    strides: Tuple[Tuple[int, ...], ...]  # dense strides of the dims that fit, per level
    hashed: Tuple[bool, ...]
    shift: float  # 0.5, or 0 with align_corners
    smoothstep: bool

    @property
    def num_levels(self) -> int:
        return len(self.scales)

    @property
    def num_rows(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim


def corner_offsets(input_dim: int, device=None) -> torch.Tensor:
    """[2^D, D] binary corner offsets in CUDA bit order (bit d of the
    corner's number: the upper corner along axis d)."""
    k = torch.arange(2**input_dim, device=device)
    return (k[:, None] >> torch.arange(input_dim, device=device)[None, :]) & 1


def level_rows(geom: GridGeometry, level: int, corner_pos: torch.Tensor) -> torch.Tensor:
    """Integer corner coords [..., D] (int64) -> rows within the level:
    the dense row-major index over the dims that fit, or on a hashed level
    the XOR of per-dim prime products, in wrapping uint32, then % rows.
    Products and sums are taken in int64 and cut to 32 bits after each,
    which keeps the uint32 result for negative coords too."""
    size = geom.offsets[level + 1] - geom.offsets[level]
    index = torch.zeros(corner_pos.shape[:-1], dtype=torch.int64, device=corner_pos.device)
    if geom.hashed[level]:
        for d in range(geom.input_dim):
            index = index ^ ((corner_pos[..., d] * PRIMES[d]) & _M32)
    else:
        for d, s in enumerate(geom.strides[level]):
            index = (index + corner_pos[..., d] * s) & _M32
    return index % size


def _weights(frac: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """[B, 2^D] d-linear weights, multiplied in axis order (as the kernel)."""
    f = frac[:, None, :]
    sel = torch.where(corners[None] == 1, f, 1.0 - f)
    w = sel[..., 0]
    for d in range(1, sel.shape[-1]):
        w = w * sel[..., d]
    return w


def _level_corners(x: torch.Tensor, geom: GridGeometry, level: int, corners: torch.Tensor):
    """Flat table rows [B, 2^D] and weights [B, 2^D] of the points' cell."""
    pos = x * geom.scales[level] + geom.shift
    pos_floor = torch.floor(pos)
    frac = pos - pos_floor
    if geom.smoothstep:
        frac = frac * frac * (3.0 - 2.0 * frac)
    corner_pos = pos_floor[:, None, :].long() + corners[None]
    rows = level_rows(geom, level, corner_pos) + geom.offsets[level]
    return rows, _weights(frac, corners)


def _oob(x: torch.Tensor) -> torch.Tensor:
    return ((x < 0.0) | (x > 1.0)).any(dim=-1)


def grid_encode_plain(x: torch.Tensor, table: torch.Tensor, geom: GridGeometry,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [B, D] -> [B, L*C] in ``out_dtype`` (the table's when None), zero
    for points outside [0, 1]^D. Differentiable by autograd in x and the
    table; the table gradient sums in f32 for an f32 table (rows are
    gathered, then cast to the compute type)."""
    dt = out_dtype or table.dtype
    corners = corner_offsets(geom.input_dim, x.device)
    outs = []
    for level in range(geom.num_levels):
        rows, w = _level_corners(x, geom, level, corners)
        vals = table[rows].to(dt)  # [B, 2^D, C]
        feat = (w.to(dt).float()[..., None] * vals.float()).sum(dim=1)
        outs.append(feat.to(dt))
    out = torch.cat(outs, dim=-1)
    return torch.where(_oob(x)[:, None], torch.zeros((), dtype=dt, device=x.device), out)


def grid_encode_bwd_rows_plain(x: torch.Tensor, g: torch.Tensor,
                               geom: GridGeometry) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner rows of the VJP: idx [B*L*2^D] int32 (flat table rows, -1
    for points outside [0, 1]^D) and rows [B*L*2^D, C] f32, the cotangent
    w * g of each corner, ordered (point, level, corner). A bf16 g (the
    bf16 compute type) rounds w and w * g to bf16."""
    bf = g.dtype == torch.bfloat16
    C = geom.level_dim
    B = x.shape[0]
    corners = corner_offsets(geom.input_dim, x.device)
    idx, rows = [], []
    for level in range(geom.num_levels):
        r, w = _level_corners(x, geom, level, corners)
        if bf:
            w = w.to(torch.bfloat16).float()
        prod = w[..., None] * g[:, level * C:(level + 1) * C].float()[:, None, :]
        if bf:
            prod = prod.to(torch.bfloat16).float()
        idx.append(r)
        rows.append(prod)
    idx = torch.stack(idx, dim=1)  # [B, L, 2^D]
    rows = torch.stack(rows, dim=1)  # [B, L, 2^D, C]
    oob = _oob(x)
    idx = torch.where(oob[:, None, None], -1, idx).to(torch.int32)
    rows = torch.where(oob[:, None, None, None], torch.zeros((), device=x.device), rows)
    return idx.reshape(-1), rows.reshape(B * geom.num_levels * 2**geom.input_dim, C)


def grid_encode_bwd_x_plain(x: torch.Tensor, table: torch.Tensor, g: torch.Tensor,
                            geom: GridGeometry) -> torch.Tensor:
    """The gradient in the points [B, D] f32: autograd of
    ``grid_encode_plain`` (output type g's) in x, the cotangent g [B, L*C];
    zero rows for points outside [0, 1]^D."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        out = grid_encode_plain(xr, table.detach(), geom, g.dtype)
        (dx,) = torch.autograd.grad(out, xr, g)
    return dx


def grid_encode_bwd_plain(x: torch.Tensor, g: torch.Tensor, geom: GridGeometry) -> torch.Tensor:
    """The table gradient [num_rows, C] f32: the corner rows of
    ``grid_encode_bwd_rows_plain`` added into an f32 zero table with
    ``index_add_``, the -1 rows (points outside [0, 1]^D) dropped."""
    idx, rows = grid_encode_bwd_rows_plain(x, g, geom)
    out = torch.zeros((geom.num_rows, geom.level_dim), dtype=torch.float32, device=x.device)
    return scatter_add_rows_plain(idx, rows, out)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_points(name: str, x: torch.Tensor, geom: GridGeometry) -> int:
    D = geom.input_dim
    if D not in _KERNEL_DIMS:
        raise ValueError(f"{name}: the kernel takes 2-D, 3-D or 4-D points, the grid is {D}-D")
    if geom.level_dim not in (1, 2, 4, 8) or not 1 <= geom.num_levels <= _MAX_LEVELS:
        raise ValueError(f"{name}: the kernel takes 1, 2, 4 or 8 features on 1-{_MAX_LEVELS} "
                         f"levels, not {geom.level_dim} on {geom.num_levels}")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != D or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous f32 [B, {D}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[0] * geom.num_levels * 2**D >= 2**31:
        raise ValueError(f"{name}: {x.shape[0]} points are more corners than int32 reaches")
    return x.shape[0]


@functools.lru_cache(maxsize=64)
def _geometry_args(geom: GridGeometry):
    """The C arguments of the geometry: per level the scale, row offset,
    row count, D dense strides (0 past the dims that fit) and the hashed
    flag, then the shift and the interpolation. Made once per geometry:
    the kernels only read them, and building the ctypes arrays costs more
    host time than a small launch."""
    L, D = geom.num_levels, geom.input_dim
    strides = [0] * (D * L)
    for level, st in enumerate(geom.strides):
        strides[D * level:D * level + len(st)] = st
    sizes = [geom.offsets[i + 1] - geom.offsets[i] for i in range(L)]
    return (
        (ctypes.c_float * L)(*geom.scales),
        int_array(geom.offsets[:L]),
        (ctypes.c_uint * L)(*sizes),
        (ctypes.c_uint * (D * L))(*strides),
        int_array([int(h) for h in geom.hashed]),
        float(geom.shift),
        int(geom.smoothstep),
    )


def _count(name: str, D: int) -> None:
    LAUNCHES[name] += 1
    if D in (2, 4) and f"{name}_{D}d" in LAUNCHES:
        LAUNCHES[f"{name}_{D}d"] += 1


def _check_table(name: str, x: torch.Tensor, table: torch.Tensor, geom: GridGeometry,
                 od: torch.dtype) -> None:
    """A contiguous f32 or bf16 table [num_rows, C] on x's device that starts
    on a pair of rows (the kernels load rows and row pairs as vectors)."""
    if (table.device != x.device or table.dtype not in _DTYPES or od not in _DTYPES
            or tuple(table.shape) != (geom.num_rows, geom.level_dim)
            or not table.is_contiguous()):
        raise ValueError(f"{name}: table must be contiguous f32 or bf16 "
                         f"[{geom.num_rows}, {geom.level_dim}] on {x.device}, output f32 "
                         f"or bf16; got {table.dtype} {tuple(table.shape)} -> {od}")
    pair = 2 * geom.level_dim * table.element_size()
    if table.data_ptr() % pair != 0:
        raise ValueError(f"{name}: the table must start on a pair of rows "
                         f"({pair} bytes); it starts at {table.data_ptr() % pair} past one")


@tracing.traced("hash_fwd")
def grid_encode_fwd(x: torch.Tensor, table: torch.Tensor, geom: GridGeometry,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Grid features: x [B, D] f32 (D = 2, 3 or 4) -> [B, L*C] in ``out_dtype``
    (f32 or bf16; the table's dtype when None), zero outside [0, 1]^D. table
    [num_rows, C] f32 or bf16, contiguous, starting on a pair of rows (the
    kernel loads rows and row pairs as vectors)."""
    if x.device.type == "cpu":
        return grid_encode_plain(x, table, geom, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_fwd: no kernel for {x.device}")
    B = _check_points("grid_encode_fwd", x, geom)
    od = out_dtype or table.dtype
    _check_table("grid_encode_fwd", x, table, geom, od)
    out = torch.empty((B, geom.output_dim), dtype=od, device=x.device)
    if B > 0:
        lib = load_library()
        err = lib.ngp_grid_encode_fwd(
            x.data_ptr(), B, geom.input_dim, table.data_ptr(),
            int(table.dtype == torch.bfloat16),
            geom.level_dim, geom.num_levels, *_geometry_args(geom), out.data_ptr(),
            int(od == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
        )
        check_launch("grid_encode_fwd", err)
        _count("grid_encode_fwd", geom.input_dim)
    return out


@tracing.traced("hash_table_grad")
def grid_encode_bwd(x: torch.Tensor, g: torch.Tensor, geom: GridGeometry) -> torch.Tensor:
    """The table gradient [num_rows, C] f32 in one launch: x [B, D] f32
    (D = 2, 3 or 4), g [B, L*C] f32 or bf16 (the output's cotangent); every
    (point, level, corner) whose product row w * g is not zero is added by
    f32 atomics into a table the wrapper zeroes (the lanes of a warp that
    add to one row sum first). Points outside [0, 1]^D add nothing."""
    if x.device.type == "cpu":
        return grid_encode_bwd_plain(x, g, geom)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_bwd: no kernel for {x.device}")
    B = _check_points("grid_encode_bwd", x, geom)
    if (g.device != x.device or g.dtype not in _DTYPES
            or tuple(g.shape) != (B, geom.output_dim) or not g.is_contiguous()):
        raise ValueError(f"grid_encode_bwd: g must be contiguous f32 or bf16 "
                         f"[{B}, {geom.output_dim}] on {x.device}")
    dtable = torch.zeros((geom.num_rows, geom.level_dim), dtype=torch.float32, device=x.device)
    if B > 0:
        lib = load_library()
        err = lib.ngp_grid_encode_bwd(
            x.data_ptr(), B, geom.input_dim, g.data_ptr(), int(g.dtype == torch.bfloat16),
            geom.level_dim,
            geom.num_levels, *_geometry_args(geom), dtable.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        check_launch("grid_encode_bwd", err)
        _count("grid_encode_bwd", geom.input_dim)
    return dtable


def grid_encode_bwd_x(x: torch.Tensor, table: torch.Tensor, g: torch.Tensor,
                      geom: GridGeometry) -> torch.Tensor:
    """The gradient in the points [B, D] f32 in one launch, one thread a
    point and a slice of its levels: x [B, D] f32 (D = 2, 3 or 4), the table as ``grid_encode_fwd``
    takes it, g [B, L*C] f32 or bf16 (the output's cotangent, whose dtype is
    the output's). Points outside [0, 1]^D get zero rows."""
    if x.device.type == "cpu":
        return grid_encode_bwd_x_plain(x, table, g, geom)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_bwd_x: no kernel for {x.device}")
    B = _check_points("grid_encode_bwd_x", x, geom)
    _check_table("grid_encode_bwd_x", x, table, geom, g.dtype)
    if (g.device != x.device or tuple(g.shape) != (B, geom.output_dim)
            or not g.is_contiguous()):
        raise ValueError(f"grid_encode_bwd_x: g must be contiguous f32 or bf16 "
                         f"[{B}, {geom.output_dim}] on {x.device}")
    dx = torch.empty((B, geom.input_dim), dtype=torch.float32, device=x.device)
    if B > 0:
        lib = load_library()
        err = lib.ngp_grid_encode_bwd_x(
            x.data_ptr(), B, geom.input_dim, table.data_ptr(),
            int(table.dtype == torch.bfloat16), g.data_ptr(), int(g.dtype == torch.bfloat16),
            geom.level_dim, geom.num_levels, *_geometry_args(geom), dx.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        check_launch("grid_encode_bwd_x", err)
        _count("grid_encode_bwd_x", geom.input_dim)
    return dx


class GridEncode(torch.autograd.Function):
    """The grid encoder with its gradients: in the table through
    ``grid_encode_bwd``, in the points through ``grid_encode_bwd_x``, each
    only where autograd asks for it."""

    @staticmethod
    def forward(ctx, x, table, geom, out_dtype):
        ctx.save_for_backward(x, table)
        ctx.geom = geom
        return grid_encode_fwd(x, table, geom, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        g = g.contiguous()
        dx = dtable = None
        if ctx.needs_input_grad[0]:
            dx = grid_encode_bwd_x(x, table, g, ctx.geom)
        if ctx.needs_input_grad[1]:
            dtable = grid_encode_bwd(x, g, ctx.geom).to(table.dtype)
        return dx, dtable, None, None
