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

JAX leaves all of it to XLA (no Pallas kernel), and so the port computes
it in torch on either device: ``index_select`` for the gather (its
backward, ``index_add_``, gives the table gradient) and autograd through
the selects and weights for the point gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

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


def brick_encode(x: torch.Tensor, table: torch.Tensor, cfg: BrickGridConfig,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Encode x in [0, 1]^3 -> [..., L * C] in ``compute_dtype`` (the
    table's dtype when None); zeros outside the box. One gather of a
    27 * C row per point and level, the stencil's masked selects, the
    trilinear weights (in the compute type, as JAX casts the table and
    the fractions). Differentiable in x and the table."""
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, 3)
    xf = xf.to(torch.promote_types(xf.dtype, torch.float32))
    dt = compute_dtype or table.dtype
    N, L, C = xf.shape[0], cfg.num_levels, cfg.level_dim
    oob = ((xf < 0.0) | (xf > 1.0)).any(dim=-1)

    idx, frac, lo = [], [], []
    for level in range(L):
        pos = xf * cfg.level_scale(level) + 0.5
        x0 = torch.floor(pos)
        frac.append((pos - x0).to(dt))
        x0 = x0.long()
        lo.append(x0 & 1)
        idx.append(_brick_index(cfg, level, x0 >> 1) + cfg.offsets[level])
    idx = torch.stack(idx, dim=1).reshape(-1)  # [N * L], level fastest
    f = torch.stack(frac, dim=1)  # [N, L, 3]
    lo = torch.stack(lo, dim=1) == 1  # [N, L, 3]
    halo = torch.index_select(table, 0, idx).to(dt).reshape(N, L, 3, 3, 3, C)

    def pick(t, axis, m):
        """The 2 of 3 halo entries along ``axis`` at the stencil's offset."""
        hi, low = t.narrow(axis, 1, 2), t.narrow(axis, 0, 2)
        return torch.where(m.reshape(m.shape + (1,) * (t.dim() - 2)), hi, low)

    s = pick(halo, 2, lo[..., 0])  # [N, L, 2, 3, 3, C]
    s = pick(s, 3, lo[..., 1])  # [N, L, 2, 2, 3, C]
    s = pick(s, 4, lo[..., 2])  # [N, L, 2, 2, 2, C]
    w = torch.stack([1.0 - f, f], dim=-1)  # [N, L, 3, 2]
    wxyz = (w[:, :, 0, :, None, None] * w[:, :, 1, None, :, None]
            * w[:, :, 2, None, None, :])  # [N, L, 2, 2, 2]
    out = (s * wxyz[..., None]).sum(dim=(2, 3, 4)).reshape(N, L * C)
    out = torch.where(oob[:, None], torch.zeros((), dtype=out.dtype, device=out.device), out)
    return out.reshape(*batch_shape, cfg.output_dim)
