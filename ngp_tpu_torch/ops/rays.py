"""Ray/AABB intersection (``ngp_tpu/ops/rays.py:near_far_from_aabb``)."""

from __future__ import annotations

from typing import Tuple

import torch

_BIG = 1e10


def near_far_from_aabb(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    aabb: torch.Tensor,
    min_near: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test -> per-ray (near, far).

    A ray that misses the slab gets near = far = 1e10. A ray pointing
    away from the box is not a miss: it keeps far < near, and callers
    treat ``far > near`` as the hit test.
    """
    o = rays_o.float()
    inv_d = 1.0 / rays_d.float()
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=o.device)
    lo = (aabb[:3] - o) * inv_d
    hi = (aabb[3:] - o) * inv_d
    near = torch.minimum(lo, hi).amax(dim=-1)
    far = torch.maximum(lo, hi).amin(dim=-1)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    big = torch.full_like(near, _BIG)
    return torch.where(miss, big, near), torch.where(miss, big, far)
