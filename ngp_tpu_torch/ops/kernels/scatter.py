"""Row scatter-add: the CUDA kernel's wrapper and its plain version.

``scatter_add_rows`` replaces ``scripts/perf_probe2_r2.py:scatter_pallas``
(``zeros[R, W].at[idx].add(rows)``, the VJP of a row gather); the kernel
is in ``csrc/scatter_kernels.cu``, whose header says what bounds it. No
path runs it: the hash-grid table gradient adds its corner rows itself
(``ops/kernels/hashgrid.py:grid_encode_bwd``); its plain version uses
``scatter_add_rows_plain``. Indices outside [0, R) add
nothing, as XLA's scatter drops them (``jnp``'s ``.at`` wraps indices in
[-R, 0) before it scatters; nothing here passes such an index on
purpose: -1 marks a row that adds nothing).
"""

from __future__ import annotations

import torch

from ngp_tpu_torch.ops.kernels import LAUNCHES
from ngp_tpu_torch.ops.kernels.build import check_launch, load_library


def scatter_add_rows_plain(idx: torch.Tensor, rows: torch.Tensor,
                           out: torch.Tensor) -> torch.Tensor:
    """``out[idx[m]] += rows[m]`` in place for idx in [0, R); returns out."""
    keep = (idx >= 0) & (idx < out.shape[0])
    out.index_add_(0, torch.where(keep, idx, 0).long(),
                   torch.where(keep[:, None], rows, torch.zeros((), device=rows.device)))
    return out


def scatter_add_rows(idx: torch.Tensor, rows: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out[idx[m], :] += rows[m, :]`` in place, by f32 atomics on the
    card: idx [M] int32, rows [M, W] f32, out [R, W] f32, all contiguous;
    indices outside [0, R) add nothing. Returns out."""
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
    if M == 0 or rows.shape[1] == 0:
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
