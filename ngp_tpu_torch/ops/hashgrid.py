"""Multiresolution hash / tiled grid encoding (``ngp_tpu/ops/hashgrid.py``).

The same level geometry (both resolution formulas: the kernel's for the
interpolation scale, ``grid.py``'s for the row offsets), the same
indexing (dense row-major while the stride fits the level, the prime
XOR hash on an overflowing hashed level, ``% rows``) and the same
d-linear or smoothstep interpolation, zero outside [0, 1]^D.
``grid_encode`` takes the plain PyTorch version for a CPU tensor
(differentiable by autograd in x and the table, as the JAX function is)
and the CUDA kernels for a CUDA tensor (``ops/kernels/hashgrid.py``:
``GridEncode`` while autograd records the table, the forward launch
alone otherwise), where it gives the table gradient but no x-gradient.
``grid_tv_loss`` is the TV regulariser over the table's dense levels,
plain tensor ops on either device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from ngp_tpu_torch.ops.kernels.hashgrid import (
    GridEncode,
    GridGeometry,
    corner_offsets,
    grid_encode_fwd,
    grid_encode_plain,
    level_rows,
)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Static geometry of a multiresolution grid encoding."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    per_level_scale: float = 2.0
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: Optional[int] = None
    gridtype: str = "hash"  # "hash" | "tiled"
    align_corners: bool = False
    interpolation: str = "linear"  # "linear" | "smoothstep"

    def __post_init__(self):
        if self.gridtype not in ("hash", "tiled"):
            raise ValueError(f"unknown gridtype {self.gridtype}")
        if self.interpolation not in ("linear", "smoothstep"):
            raise ValueError(f"unknown interpolation {self.interpolation}")
        if self.desired_resolution is not None:
            # the finest level's resolution sets per_level_scale
            if self.num_levels > 1:
                s = math.exp2(math.log2(self.desired_resolution / self.base_resolution)
                              / (self.num_levels - 1))
            else:
                s = 1.0
            object.__setattr__(self, "per_level_scale", s)

    @property
    def log2_per_level_scale(self) -> float:
        return math.log2(self.per_level_scale)

    def level_scale(self, level: int) -> float:
        """The continuous grid scale of the interpolation coords."""
        return math.exp2(level * self.log2_per_level_scale) * self.base_resolution - 1.0

    def level_resolution(self, level: int) -> int:
        """Grid cells along each axis at ``level`` (the kernel formula)."""
        return int(math.ceil(self.level_scale(level))) + 1

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Cumulative per-level table-row offsets, length L + 1; rows per
        level from ceil(H * s^l) (not the kernel formula), rounded up to
        a multiple of 8 and capped at the hash-map size."""
        max_params = 2**self.log2_hashmap_size
        offs = [0]
        for lvl in range(self.num_levels):
            res = int(math.ceil(self.base_resolution * self.per_level_scale**lvl))
            side = res if self.align_corners else res + 1
            params = min(max_params, side**self.input_dim)
            params = int(math.ceil(params / 8) * 8)
            offs.append(offs[-1] + params)
        return tuple(offs)

    @property
    def num_rows(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @functools.cached_property
    def geometry(self) -> GridGeometry:
        """What the kernels read: per level the scale, the dense strides of
        the dims whose stride still fits the level, and whether it hashes."""
        offs = self.offsets
        strides, hashed = [], []
        for level in range(self.num_levels):
            size = offs[level + 1] - offs[level]
            res = self.level_resolution(level)
            side = res if self.align_corners else res + 1
            st, stride, overflow = [], 1, False
            for _ in range(self.input_dim):
                if stride > size:
                    overflow = True
                    break
                st.append(stride)
                stride *= side
            overflow = overflow or stride > size
            strides.append(tuple(st))
            hashed.append(self.gridtype == "hash" and overflow)
        return GridGeometry(
            input_dim=self.input_dim, level_dim=self.level_dim,
            scales=tuple(self.level_scale(lv) for lv in range(self.num_levels)),
            offsets=offs, strides=tuple(strides), hashed=tuple(hashed),
            shift=0.0 if self.align_corners else 0.5,
            smoothstep=self.interpolation == "smoothstep",
        )

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda") -> torch.Tensor:
        """U(-1e-4, 1e-4) table [num_rows, level_dim], drawn from a CPU
        generator and placed on ``device``."""
        u = torch.rand((self.num_rows, self.level_dim), generator=generator)
        return ((u * 2.0 - 1.0) * 1e-4).to(device=device, dtype=dtype)


def _corner_offsets(input_dim: int) -> torch.Tensor:
    """[2^D, D] binary corner offsets in CUDA bit order (bit d of idx)."""
    return corner_offsets(input_dim)


def _level_indices(cfg: GridConfig, level: int, pos_grid: torch.Tensor) -> torch.Tensor:
    """Integer corner coords [..., D] -> row indices within a level (int64)."""
    return level_rows(cfg.geometry, level, pos_grid.long())


def grid_encode(x: torch.Tensor, embeddings: torch.Tensor, cfg: GridConfig,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Encode points ``x`` in [0, 1]^D -> features [..., L * C] in
    ``compute_dtype`` (the table's dtype when None); zero outside.

    CPU tensors: the plain version, differentiable in x and the table.
    CUDA tensors: ``GridEncode`` (table gradient through ``grid_encode_bwd``)
    while autograd records the table, the forward kernel otherwise."""
    if x.shape[-1] != cfg.input_dim:
        raise ValueError(f"expected [..., {cfg.input_dim}] input, got {tuple(x.shape)}")
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, cfg.input_dim)
    xf = xf.to(torch.promote_types(xf.dtype, torch.float32))
    geom = cfg.geometry
    out_dtype = compute_dtype or embeddings.dtype
    if xf.device.type == "cpu":
        out = grid_encode_plain(xf, embeddings, geom, out_dtype)
    elif torch.is_grad_enabled() and (embeddings.requires_grad or xf.requires_grad):
        out = GridEncode.apply(xf.contiguous(), embeddings.contiguous(), geom, out_dtype)
    else:
        out = grid_encode_fwd(xf.contiguous(), embeddings.contiguous(), geom, out_dtype)
    return out.reshape(*batch_shape, cfg.output_dim)


def grid_tv_loss(embeddings: torch.Tensor, cfg: GridConfig,
                 levels: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Total variation over the dense (non-hashed) levels of the table: per
    level and axis the mean squared difference of neighbouring rows, the
    mean over those terms; 0 when no level is dense. A dense level's rows
    are laid out with dim 0 fastest, so its reshape reverses the axes.
    Autograd gives the table gradient."""
    total = torch.zeros((), device=embeddings.device)
    offs = cfg.offsets
    n_terms = 0
    for level in range(cfg.num_levels) if levels is None else levels:
        res = cfg.level_resolution(level)
        side = res if cfg.align_corners else res + 1
        if side**cfg.input_dim > offs[level + 1] - offs[level]:
            continue  # hashed: neighbours are not adjacent rows
        dense = embeddings[offs[level]:offs[level] + side**cfg.input_dim]
        dense = dense.reshape((side,) * cfg.input_dim + (cfg.level_dim,))
        for axis in range(cfg.input_dim):
            total = total + (torch.diff(dense, dim=axis).float() ** 2).mean()
            n_terms += 1
    return total / n_terms if n_terms else total
