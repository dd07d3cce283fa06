"""The yardstick: an H100's published peaks and the least bytes and
operations of the kernels whose roofline shares the benchmark reports.

Frozen copies of ``chip_smoke.py``'s ``bound``, ``density_work``, the
factor gradient's byte count, ``table_bytes``, ``grid_fwd_work`` and
``grid_bwd_work``: inputs read once and outputs written once, table rows
counted in the distinct 32-byte sectors HBM moves, and where the work
depends on the data, what these inputs need (rows inside the box, live
rows and items). Peaks: NVIDIA's H100 SXM data sheet, dense.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from benchmark.reference import plain as P

HBM_RATE = 3.35e12  # bytes/s
BF16_TENSOR_RATE = 989e12  # FLOP/s, dense bf16 on the tensor cores
F32_CORE_RATE = 67e12  # FLOP/s, f32 on the CUDA cores
TF32X3_TENSOR_RATE = 495e12 / 3  # f32-accurate products as three TF32 products
SECTOR = 32  # bytes HBM moves at the least


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_s(n_bytes: float, tensor_flops: float = 0.0, core_flops: float = 0.0,
            tf32x3_flops: float = 0.0) -> float:
    """The least seconds of a kernel that moves ``n_bytes`` once and does
    the given matrix-product (bf16 tensor cores), other (f32 CUDA cores)
    and f32-accurate matrix-product operations."""
    return max(n_bytes / HBM_RATE, tensor_flops / BF16_TENSOR_RATE,
               core_flops / F32_CORE_RATE, tf32x3_flops / TF32X3_TENSOR_RATE)


def head_work(n_bytes, bf16: bool, product_flops, other_flops):
    """``bound_s``'s arguments of a CP head: its products on the tensor
    cores (bf16) or at the 3xTF32 rate (f32), the rest on the CUDA cores."""
    if bf16:
        return n_bytes, product_flops, other_flops, 0
    return n_bytes, 0, other_flops, product_flops


def density_head_work(M: int, factor_bytes: int, D: int, H1: int, OUT: int,
                      elem: int, nbR: int, residuals: bool):
    """``cp_density_fwd`` on M rows: positions, banks and weights read, the
    f32 output (and the feats and h1 residuals in the weight type) written;
    both products; a CP lerp about 14 operations per (row, bank column)."""
    n_bytes = M * 12 + factor_bytes + (D * H1 + H1 * OUT) * elem + M * OUT * 4
    if residuals:
        n_bytes += M * (D + H1) * elem
    return head_work(n_bytes, elem == 2, 2 * M * (D * H1 + H1 * OUT), 14 * M * nbR)


def factor_grad_work(pos: torch.Tensor, g_cp: torch.Tensor, factor_bytes: int,
                     resolutions: Sequence[int], rank: int):
    """``cp_bwd_banks``: positions and g read, the banks read and their
    gradients written in the factor type; per live row of a bank (inside
    the box, g not all zero in the bank's columns) 24 operations a column."""
    inside = P.rays_in_box(pos)
    live = 0
    for b in range(len(resolutions)):
        live += int((inside & (g_cp[:, b * rank:(b + 1) * rank] != 0).any(dim=1)).sum())
    return nbytes(pos, g_cp) + 2 * factor_bytes, 0, 24 * live * rank, 0


def table_bytes(rows: torch.Tensor, level_dim: int, num_rows: int) -> int:
    """Bytes of the f32 table rows named (entries < 0 name none): each
    distinct row once, in whole 32-byte sectors, at most the whole table."""
    row = level_dim * 4
    rows = rows[rows >= 0].long()
    if row >= SECTOR:
        n = torch.unique(rows).numel() * row
    else:
        n = torch.unique(rows * row // SECTOR).numel() * SECTOR
    return min(n, num_rows * row)


def _level_rows(x: torch.Tensor, geom: P.HashGeometry, live: torch.Tensor):
    """Per level, the rows that the points where ``live`` [B, L] read."""
    for level in range(geom.num_levels):
        keep = live[:, level]
        yield P.corner_rows(x[keep], geom, level).reshape(-1)


def hash_fwd_work(x: torch.Tensor, geom: P.HashGeometry, out_elem: int):
    """The grid forward: x read, the rows of every corner of the points
    inside [0, 1]^D read (distinct sectors), the output written; per
    (point, level) 3 D operations of position, per corner D - 1 of weight
    and 2 per feature."""
    D, L, C = geom.input_dim, geom.num_levels, geom.level_dim
    inside = P.rays_in_box(x)
    live = inside[:, None].expand(-1, L)
    sectors = sum(table_bytes(r, C, geom.num_rows) for r in _level_rows(x, geom, live))
    B = x.shape[0]
    return (nbytes(x) + min(sectors, geom.num_rows * C * 4) + B * L * C * out_elem, 0,
            B * L * (3 * D + 2**D * (D - 1 + 2 * C)), 0)


def hash_bwd_work(x: torch.Tensor, g: torch.Tensor, geom: P.HashGeometry):
    """The table gradient: x and g read, the rows that receive a non-zero
    product written (distinct sectors); per live (point, level) (inside,
    cotangent not zero) 3 D operations of position, per corner D - 1 of
    weight and 1 per feature."""
    D, L, C = geom.input_dim, geom.num_levels, geom.level_dim
    live = (g.view(-1, L, C) != 0).any(dim=2) & P.rays_in_box(x)[:, None]
    sectors = sum(table_bytes(r, C, geom.num_rows) for r in _level_rows(x, geom, live))
    return (nbytes(x, g) + min(sectors, geom.num_rows * C * 4), 0,
            int(live.sum()) * (3 * D + 2**D * (D - 1 + C)), 0)


def model_flops_per_sample(net: dict) -> Tuple[int, int]:
    """(sigma MLP, colour MLP) forward FLOPs of one sample: 2 per weight."""
    if net["encoding"] == "cpgrid":
        d_in = len(net["cp_resolutions"]) * net["cp_rank"] + 3 * (1 + 2 * net["cp_freq_degree"])
    else:
        d_in = net["num_levels"] * net["level_dim"]

    def chain(dims):
        return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))

    hid, geo = net["hidden_dim"], net["geo_feat_dim"]
    sigma = chain([d_in] + [hid] * (net["num_layers"] - 1) + [1 + geo])
    hc = net["hidden_dim_color"]
    color = chain([net["sh_degree"] ** 2 + geo] + [hc] * (net["num_layers_color"] - 1) + [3])
    return sigma, color
