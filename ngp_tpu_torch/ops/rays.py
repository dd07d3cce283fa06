"""Ray geometry (``ngp_tpu/ops/rays.py``): ray/AABB intersection, the
background sphere's coordinates of a ray, and pixel unprojection."""

from __future__ import annotations

from typing import Tuple

import math

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


def sph_from_ray(rays_o: torch.Tensor, rays_d: torch.Tensor, radius: float) -> torch.Tensor:
    """Ray ∩ sphere(radius) -> (theta, phi) in [-1, 1]: the larger
    quadratic root (origins inside the sphere), y up; [..., 2] =
    (2 * theta / pi - 1, phi / pi)."""
    o = rays_o.float()
    d = rays_d.float()
    a = (d * d).sum(dim=-1)
    b = (o * d).sum(dim=-1)  # B / 2
    c = (o * o).sum(dim=-1) - radius * radius
    disc = torch.clamp(b * b - a * c, min=0.0)
    t = (-b + torch.sqrt(disc)) / a
    p = o + t[..., None] * d
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    theta = torch.atan2(torch.sqrt(x * x + z * z), y)
    phi = torch.atan2(z, x)
    return torch.stack([2.0 * theta / math.pi - 1.0, phi / math.pi], dim=-1)


def rays_from_pixels(pixels_xy: torch.Tensor, pose: torch.Tensor,
                     intrinsics: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel coords [..., 2] (x = column, y = row; + 0.5 for the centre),
    a camera-to-world pose [..., 4, 4] or [4, 4] and intrinsics (fx, fy,
    cx, cy) -> (rays_o, rays_d) [..., 3], unit directions, camera z = +1."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    x = (pixels_xy[..., 0].float() + 0.5 - cx) / fx
    y = (pixels_xy[..., 1].float() + 0.5 - cy) / fy
    dirs_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    rot = pose[..., :3, :3]
    dirs = torch.einsum("...ij,...j->...i", rot, dirs_cam)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_o = torch.broadcast_to(pose[..., :3, 3], dirs.shape)
    return rays_o, dirs
