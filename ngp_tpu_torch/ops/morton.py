"""3-D Morton (Z-order) codes and occupancy-grid bit packing
(``ngp_tpu/ops/morton.py``).

The JAX functions work in uint32. torch has no unsigned 32-bit shifts,
so these work in int64: each product is masked by a constant below
2^32, which is the same as masking its value mod 2^32, and a code is
masked to its low 32 bits before a right shift, so the shift is
logical. Codes come back as int32, as in JAX.
"""

from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each value out to every 3rd bit."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def _compact_bits(v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_expand_bits` (gather every 3rd bit)."""
    v = v & 0x49249249
    v = (v | (v >> 2)) & 0xC30C30C3
    v = (v | (v >> 4)) & 0x0F00F00F
    v = (v | (v >> 8)) & 0xFF0000FF
    v = (v | (v >> 16)) & 0x0000FFFF
    return v


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """Integer coords [..., 3] (each in [0, 1024)) -> Z-order codes
    expand(x) | expand(y) << 1 | expand(z) << 2, int32."""
    c = coords.long() & _LOW32
    code = (_expand_bits(c[..., 0]) | (_expand_bits(c[..., 1]) << 1)
            | (_expand_bits(c[..., 2]) << 2))
    return (code & _LOW32).to(torch.int32)


def morton3d_invert(codes: torch.Tensor) -> torch.Tensor:
    """Z-order codes [...] -> integer coords [..., 3], int32."""
    v = codes.long() & _LOW32
    xyz = [_compact_bits(v >> k) for k in range(3)]
    return torch.stack(xyz, dim=-1).to(torch.int32)


def packbits(grid: torch.Tensor, thresh) -> torch.Tensor:
    """Threshold a flattened density grid into a uint8 bitfield: bit i of
    byte n is set iff grid[8n + i] > thresh."""
    bits = (grid.reshape(-1, 8) > thresh).to(torch.uint8)
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8, device=grid.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def unpackbits(bitfield: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`packbits`: bool, 8x the length."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bitfield.device)
    bits = (bitfield[..., None] >> shifts) & 1
    return bits.reshape(*bitfield.shape[:-1], -1).bool()
