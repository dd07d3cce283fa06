"""Scatter-adds, and the factor taps' forward: the CUDA kernels' wrappers
and their plain versions.

``scatter_add_rows`` replaces ``scripts/perf_probe2_r2.py:scatter_pallas``
(``zeros[R, W].at[idx].add(rows)``, the VJP of a row gather). No path
runs it: the brick grid's table gradient, which added the rows'
cotangent by it, is one kernel of its own
(``ops/brickgrid.py:brick_table_grad``), whose plain version adds the
plain rows by ``scatter_add_rows_plain``; ``GatherRows`` (the row gather
of the plain ``brick_encode_plain``) adds by it in its backward. The
hash-grid table gradient adds its corner rows itself
(``ops/kernels/hashgrid.py:grid_encode_bwd``). Indices outside [0, R) add
nothing, as XLA's scatter drops them (``jnp``'s ``.at`` wraps indices in
[-R, 0) before it scatters; nothing here passes such an index on
purpose: -1 marks a row that adds nothing).

``scatter_add_taps`` replaces no Pallas kernel: it is the factor gradient
of ``ops/interp.py``'s bilinear taps, which the JAX package leaves to
XLA's VJP of ``jnp.take`` (``ngp_tpu/ops/interp.py:39``, ``:62``).
TensoRF and CCNeRF train through it (``interp.FactorTaps``). It makes
each sample's cells and weights itself, as ``factor_taps`` makes them
here. ``sample_taps_fwd`` replaces no Pallas kernel either: it is the
taps' forward, ``ngp_tpu/ops/interp.py:sample_1d`` / ``sample_2d``
(``:27``, ``:45``), which the JAX package leaves to XLA; ``FactorTaps``
samples through it. ``factor_taps`` is the one owner of the taps' cells,
weights and roundings; both kernels make them by ``csrc/taps.cuh``. The
kernels are in ``csrc/scatter_kernels.cu`` and ``csrc/taps_kernels.cu``,
whose headers say what bounds them and how each is laid out.

Both taps kernels read and write a factor held cell-major
(``cell_major``): the memory is [D, R] (a line) or [H, W, R] (a plane),
seen in JAX's shape [R, D] / [R, H, W] with strides (1, R) / (1, W R, R),
so a sample's R values at a tap are one contiguous read or reduction.
TensoRF's and CCNeRF's factor parameters are made in that layout; on the
card the wrappers take no other and raise.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ngp_tpu_torch.ops.kernels import LAUNCHES
from ngp_tpu_torch.ops.kernels.build import check_launch, load_library


def is_cell_major(factor: torch.Tensor) -> bool:
    """Whether ``factor`` [R, D] or [R, H, W] holds its values cell-major:
    memory [D, R] or [H, W, R] (strides (1, R) or (1, W R, R); a size-1
    dimension's stride aside), as the taps kernels read it."""
    return factor.movedim(0, -1).is_contiguous()


def cell_major(factor: torch.Tensor) -> torch.Tensor:
    """``factor`` [R, D] or [R, H, W] with the same values held cell-major
    (``is_cell_major``): ``factor`` itself when it already is, else one
    transposed copy."""
    if is_cell_major(factor):
        return factor
    return factor.movedim(0, -1).contiguous().movedim(-1, 0)


def scatter_add_rows_plain(idx: torch.Tensor, rows: torch.Tensor,
                           out: torch.Tensor) -> torch.Tensor:
    """``out[idx[m]] += rows[m]`` in place for idx in [0, R); returns out."""
    keep = (idx >= 0) & (idx < out.shape[0])
    out.index_add_(0, torch.where(keep, idx, 0).long(),
                   torch.where(keep[:, None], rows, torch.zeros((), device=rows.device)))
    return out


def scatter_add_rows(idx: torch.Tensor, rows: torch.Tensor,
                     out: torch.Tensor) -> torch.Tensor:
    """``out[idx[m], :] += rows[m, :]`` in place, by f32 atomics on the
    card: idx [M] int32, rows [M, W] f32, out [R, W] f32, all contiguous;
    indices outside [0, R) add nothing. The kernel's branch follows from
    the shape: merged tiles for 16-byte aligned rows of W % 4 == 0, at
    most 256 floats, else a thread or warp per row. Returns out."""
    if idx.device.type == "cpu":
        return scatter_add_rows_plain(idx, rows, out)
    if idx.device.type != "cuda":
        raise ValueError(f"scatter_add_rows: no kernel for {idx.device}")
    if idx.dtype != torch.int32 or idx.ndim != 1 or not idx.is_contiguous():
        raise ValueError("scatter_add_rows: idx must be a contiguous int32 vector")
    M = idx.shape[0]
    for name, t in (("rows", rows), ("out", out)):
        if t.device != idx.device or t.dtype != torch.float32 or t.ndim != 2 \
                or not t.is_contiguous():
            raise ValueError(f"scatter_add_rows: {name} must be contiguous 2-D f32 on "
                             f"{idx.device}")
    if rows.shape[0] != M or rows.shape[1] != out.shape[1]:
        raise ValueError(f"scatter_add_rows: rows {tuple(rows.shape)} do not fit idx [{M}] "
                         f"and out {tuple(out.shape)}")
    if out.shape[0] >= 2**31:
        raise ValueError("scatter_add_rows: out has more rows than int32 indices reach")
    if M == 0 or out.numel() == 0:
        return out
    lib = load_library()
    err = lib.ngp_scatter_add_rows(idx.data_ptr(), rows.data_ptr(), M, rows.shape[1],
                                   out.shape[0], out.data_ptr(),
                                   torch.cuda.current_stream(idx.device).cuda_stream)
    check_launch("scatter_add_rows", err)
    LAUNCHES["scatter_add_rows"] += 1
    return out


def scatter_rows(idx: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The functional form: ``zeros[num_rows, W].at[idx].add(rows)`` in
    f32, as ``scatter_pallas`` computes it."""
    out = torch.zeros((num_rows, rows.shape[1]), dtype=torch.float32, device=rows.device)
    return scatter_add_rows(idx, rows, out)


class GatherRows(torch.autograd.Function):
    """``index_select(table, 0, idx)`` (idx int32 [M]) whose table
    gradient is ``scatter_add_rows`` of the rows' cotangent, in f32, into
    a zeroed table (the plain version on the CPU), cast to the table's
    type."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return torch.index_select(table, 0, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = torch.zeros(ctx.table_shape, dtype=torch.float32, device=g.device)
        return scatter_add_rows(idx, g.float().contiguous(), out).to(ctx.table_dtype), None


def _to_pixel(u: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    """The pixel coordinate of u in [-1, 1] on an axis of ``size`` cells,
    each operation rounded on its own: ``to_pixel`` in
    ``csrc/taps.cuh`` must round the same way (no fused
    multiply-add), or a sample on a cell edge lands in another cell."""
    u = u.float()
    if align_corners:
        return (u + 1.0) / 2.0 * (size - 1)
    return (u + 1.0) / 2.0 * size - 0.5


def factor_taps(coords: torch.Tensor, grid: Sequence[int],
                align_corners: bool) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The bilinear taps of points on a factor grid: ``grid`` (D,) with
    coords u [N] (2 taps), or (H, W) with coords [N, 2], u on the W axis
    and v on the H axis (4 taps). Per tap, in ``ops/interp.py``'s order:
    (the flat cell clamped into the grid [N] int64, whether the cell is in
    the grid [N] bool, the weight [N] f32), with ``_to_pixel``'s
    convention (``align_corners``). The one owner of the taps' geometry:
    ``sample_taps_plain`` reads these taps, and ``sample_taps`` in
    ``csrc/taps.cuh`` makes the same cells and weights with the same
    roundings for both kernels."""
    if len(grid) == 1:
        (D,) = grid
        p = _to_pixel(coords, D, align_corners)
        p0 = torch.floor(p)
        f = p - p0
        p0 = p0.long()
        return [(i.clamp(0, D - 1), (i >= 0) & (i < D), w)
                for i, w in ((p0, 1.0 - f), (p0 + 1, f))]
    H, W = grid
    px = _to_pixel(coords[:, 0], W, align_corners)
    py = _to_pixel(coords[:, 1], H, align_corners)
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    x0, y0 = x0.long(), y0.long()

    def tap(yi, xi, w):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        return yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1), ok, w

    return [tap(y0, x0, (1 - fx) * (1 - fy)), tap(y0, x0 + 1, fx * (1 - fy)),
            tap(y0 + 1, x0, (1 - fx) * fy), tap(y0 + 1, x0 + 1, fx * fy)]


def sample_taps_plain(factor: torch.Tensor, coords: torch.Tensor,
                      align_corners: bool) -> torch.Tensor:
    """The taps' lerp: factor [R, D] and coords [N], or [R, H, W] and [N, 2]
    -> [R, N] in torch's promotion of the factor's type and f32: per tap
    of ``factor_taps``, one ``index_select``, ``where``, ``mul`` and ``add``
    (``out = v_0 w_0``, then ``out = out + v_t w_t``)."""
    R = factor.shape[0]
    flat = factor.reshape(R, -1)
    out = None
    for idx, ok, w in factor_taps(coords, factor.shape[1:], align_corners):
        v = flat.index_select(1, idx)
        v = torch.where(ok[None, :], v, torch.zeros((), dtype=v.dtype, device=v.device))
        out = v * w[None, :] if out is None else out + v * w[None, :]
    return out


def _check_taps_args(name: str, factor: torch.Tensor, coords: torch.Tensor) -> None:
    """Raise ValueError unless factor is a floating [R, D] line with
    floating coords [N], or an [R, H, W] plane with coords [N, 2]."""
    if not (factor.is_floating_point() and coords.is_floating_point()):
        raise ValueError(f"{name}: the factor and the coords must be floating point")
    if factor.ndim == 2:
        if coords.ndim != 1:
            raise ValueError(f"{name}: a line's coords must be [N]")
    elif factor.ndim == 3:
        if coords.ndim != 2 or coords.shape[1] != 2:
            raise ValueError(f"{name}: a plane's coords must be [N, 2]")
    else:
        raise ValueError(f"{name}: the factor must be a line [R, D] or a plane [R, H, W]")


def sample_taps_fwd(factor: torch.Tensor, coords: torch.Tensor,
                    align_corners: bool) -> torch.Tensor:
    """The bilinear taps of ``factor_taps`` on each factor row: factor [R,
    D] with coords u [N], or [R, H, W] with coords [N, 2] -> [R, N]; zero
    outside the grid. On the card one kernel launch: factor f32 or bf16,
    cell-major (``is_cell_major``), coords f32 of any strides, output f32,
    bit-equal to ``sample_taps_plain`` (every product and sum rounded on
    its own, in its order); ``sample_taps_plain`` on the CPU."""
    _check_taps_args("sample_taps_fwd", factor, coords)
    if factor.device.type == "cpu":
        return sample_taps_plain(factor, coords, align_corners)
    if factor.device.type != "cuda":
        raise ValueError(f"sample_taps_fwd: no kernel for {factor.device}")
    if factor.dtype not in (torch.float32, torch.bfloat16) or not is_cell_major(factor):
        raise ValueError("sample_taps_fwd: the factor must be an f32 or bf16 tensor held "
                         "cell-major (ops/kernels/scatter.py:cell_major)")
    if coords.device != factor.device or coords.dtype != torch.float32:
        raise ValueError(f"sample_taps_fwd: coords must be f32 on {factor.device}")
    R, grid, N = factor.shape[0], factor.shape[1:], coords.shape[0]
    if factor.numel() >= 2**31 or N >= 2**31 or R > 8 * 65535:
        raise ValueError("sample_taps_fwd: more entries than the kernel's offsets reach")
    out = torch.empty((R, N), dtype=torch.float32, device=factor.device)
    if out.numel() == 0:
        return out
    u, su, v, sv = _coord_args(coords, grid)
    H, W = (1, grid[0]) if len(grid) == 1 else grid
    lib = load_library()
    err = lib.ngp_sample_taps_fwd(factor.data_ptr(), int(factor.dtype == torch.bfloat16), R, N,
                                  u.data_ptr(), su, None if v is None else v.data_ptr(), sv,
                                  H, W, int(align_corners), out.data_ptr(),
                                  torch.cuda.current_stream(factor.device).cuda_stream)
    check_launch("sample_taps_fwd", err)
    LAUNCHES["sample_taps_fwd"] += 1
    return out


def scatter_add_taps_plain(g: torch.Tensor, coords: torch.Tensor, out: torch.Tensor,
                           align_corners: bool) -> torch.Tensor:
    """``out[r, cell_t(n)] += g[r, n] * w_t(n)`` in place over the taps of
    ``factor_taps`` (out [R, D] or [R, H, W]) that fall in the grid: one
    ``index_add_`` along dim 1 per tap of the masked, weighted cotangent.
    Returns out."""
    flat = out.view(out.shape[0], -1)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for idx, ok, w in factor_taps(coords, out.shape[1:], align_corners):
        flat.index_add_(1, idx, torch.where(ok[None, :], g * w[None, :], zero))
    return out


def _coord_args(coords: torch.Tensor, grid: Sequence[int]):
    """(u, its stride, v or None, its stride) of f32 coords, no copy."""
    if len(grid) == 1:
        if coords.ndim != 1:
            raise ValueError("scatter_add_taps: a line's coords must be [N]")
        return coords, coords.stride(0), None, 0
    if coords.ndim != 2 or coords.shape[1] != 2:
        raise ValueError("scatter_add_taps: a plane's coords must be [N, 2]")
    return coords[:, 0], coords.stride(0), coords[:, 1], coords.stride(0)


def scatter_add_taps(g: torch.Tensor, coords: torch.Tensor, out: torch.Tensor,
                     align_corners: bool) -> torch.Tensor:
    """``out[r, cell_t(n)] += g[r, n] * w_t(n)`` in place over the 2 (out
    [R, D], coords u [N]) or 4 (out [R, H, W], coords [N, 2]) bilinear
    taps of each sample that fall in the grid, as ``factor_taps`` makes
    them: g [R, N] f32 contiguous, out f32 held cell-major
    (``is_cell_major``), coords f32 of any strides. One kernel launch on
    the card (runs of samples that hit one cell summed before they are
    added), ``scatter_add_taps_plain`` on the CPU. Returns out."""
    if g.device.type == "cpu":
        return scatter_add_taps_plain(g, coords, out, align_corners)
    if g.device.type != "cuda":
        raise ValueError(f"scatter_add_taps: no kernel for {g.device}")
    if g.dtype != torch.float32 or g.ndim != 2 or not g.is_contiguous():
        raise ValueError("scatter_add_taps: g must be a contiguous 2-D f32 tensor")
    if out.device != g.device or out.dtype != torch.float32 or out.ndim not in (2, 3) \
            or not is_cell_major(out):
        raise ValueError(f"scatter_add_taps: out must be an [R, D] or [R, H, W] f32 tensor "
                         f"held cell-major (ops/kernels/scatter.py:cell_major) on {g.device}")
    if coords.device != g.device or coords.dtype != torch.float32:
        raise ValueError(f"scatter_add_taps: coords must be f32 on {g.device}")
    R, N = g.shape
    grid = out.shape[1:]
    u, su, v, sv = _coord_args(coords, grid)
    if out.shape[0] != R or coords.shape[0] != N:
        raise ValueError(f"scatter_add_taps: g {tuple(g.shape)}, coords {tuple(coords.shape)} "
                         f"and out {tuple(out.shape)} do not fit")
    if out.numel() >= 2**31 or N >= 2**31:
        raise ValueError("scatter_add_taps: more entries than int32 offsets reach")
    if R == 0 or N == 0 or out.numel() == 0:
        return out
    H, W = (1, grid[0]) if len(grid) == 1 else grid
    lib = load_library()
    err = lib.ngp_scatter_add_taps(g.data_ptr(), R, N, u.data_ptr(), su,
                                   None if v is None else v.data_ptr(), sv, H, W,
                                   int(align_corners), out.data_ptr(),
                                   torch.cuda.current_stream(g.device).cuda_stream)
    check_launch("scatter_add_taps", err)
    LAUNCHES["scatter_add_taps"] += 1
    return out
