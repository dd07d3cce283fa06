"""Pixel sampling and camera rays (``ngp_tpu/data/raysampler.py``).

Rows are ``inds // W`` and columns ``inds % W``, sampled at pixel
centers; camera-space directions are (x, y, 1), normalised, then rotated
by the camera-to-world pose.

``sample_ray_indices`` has the JAX sampler's three modes. Its random
draws come from a ``torch.Generator``, or are passed in (``draws``) so
that a test can give it the numbers ``jax.random`` drew.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def sample_ray_indices(H: int, W: int, n_rays: int,
                       error_map: Optional[torch.Tensor] = None, patch_size: int = 1,
                       uniform_frac: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Dict[str, torch.Tensor]] = None,
                       device="cuda") -> Dict[str, torch.Tensor]:
    """Choose ``n_rays`` flat pixel indices in [0, H*W).

    Returns {"inds": [N]} plus {"inds_coarse": [N]} in error-map mode.

    - ``patch_size`` > 1: random top-left corners ("x0", "y0" draws, in
      [0, H - p) and [0, W - p)) and dense p x p patches;
    - no error map: uniform indices ("inds");
    - error map [M*M]: multinomial without replacement over the coarse
      cells as a Gumbel top-k ("gumbel_u", uniforms of the map's size),
      upscaled with jitter ("jx", "jy"), plus ``round(n_rays *
      uniform_frac)`` uniform rays ("inds_u") whose coarse cells are
      reported too.
    Draws missing from ``draws`` come from ``generator``."""
    draws = draws or {}
    if error_map is not None:
        device = error_map.device

    def randint(name, lo, hi, n):
        if name in draws:
            return draws[name].to(device=device, dtype=torch.int64)
        return torch.randint(lo, hi, (n,), generator=generator, device=device)

    def uniform(name, n):
        if name in draws:
            return draws[name].to(device=device, dtype=torch.float32)
        return torch.rand((n,), generator=generator, device=device)

    out = {}
    if patch_size > 1:
        num_patch = n_rays // (patch_size**2)
        x0 = randint("x0", 0, H - patch_size, num_patch)
        y0 = randint("y0", 0, W - patch_size, num_patch)
        r = torch.arange(patch_size, device=x0.device)
        pi, pj = torch.meshgrid(r, r, indexing="ij")
        rows = x0[:, None] + pi.reshape(1, -1)
        cols = y0[:, None] + pj.reshape(1, -1)
        out["inds"] = (rows * W + cols).reshape(-1)
    elif error_map is None:
        out["inds"] = randint("inds", 0, H * W, n_rays)
    else:
        n_uni = int(round(n_rays * uniform_frac))
        n_w = n_rays - n_uni
        em = error_map.reshape(-1).float()
        M = int(round(em.shape[0] ** 0.5))
        logits = torch.log(torch.clamp(em, min=1e-12))
        u = uniform("gumbel_u", em.shape[0])
        gumbel = -torch.log(-torch.log(u + 1e-10) + 1e-10)
        inds_coarse = torch.topk(logits + gumbel, n_w).indices
        sx, sy = H / M, W / M
        jx, jy = uniform("jx", n_w), uniform("jy", n_w)
        ix = torch.clamp(((inds_coarse // M) * sx + jx * sx).to(torch.int32), 0, H - 1)
        iy = torch.clamp(((inds_coarse % M) * sy + jy * sy).to(torch.int32), 0, W - 1)
        inds = ix.long() * W + iy.long()
        if n_uni:
            inds_u = randint("inds_u", 0, H * W, n_uni)
            cu_x = torch.clamp((inds_u // W).float() / sx, 0, M - 1).to(torch.int64)
            cu_y = torch.clamp((inds_u % W).float() / sy, 0, M - 1).to(torch.int64)
            inds = torch.cat([inds, inds_u])
            inds_coarse = torch.cat([inds_coarse, cu_x * M + cu_y])
        out["inds"] = inds
        out["inds_coarse"] = inds_coarse
    return out


def _cam_dirs(intrinsics, W: int, inds):
    fx, fy, cx, cy = (intrinsics[i] for i in range(4))
    row = (inds // W).float() + 0.5
    col = (inds % W).float() + 0.5
    dirs = torch.stack([(col - cx) / fx, (row - cy) / fy, torch.ones_like(row)], dim=-1)
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def rays_from_indices(pose, intrinsics, H: int, W: int, inds) -> Dict[str, torch.Tensor]:
    """pose [4, 4] cam2world; intrinsics [4] (fx, fy, cx, cy); inds [N]."""
    dirs = _cam_dirs(intrinsics, W, inds)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand_as(rays_d)
    return {"rays_o": rays_o, "rays_d": rays_d}


def rays_from_frame_indices(poses, intrinsics, H: int, W: int, inds,
                            fids) -> Dict[str, torch.Tensor]:
    """Each ray unprojects through its own frame's pose: poses [F, 4, 4],
    fids [N]. A plain gather of the pose (the JAX package routes it
    through a one-hot matmul for the TPU; the values are the same)."""
    dirs = _cam_dirs(intrinsics, W, inds)
    pose = poses[fids.long()]  # [N, 4, 4]
    rays_d = torch.einsum("nij,nj->ni", pose[:, :3, :3], dirs)
    return {"rays_o": pose[:, :3, 3], "rays_d": rays_d}


def full_frame_rays(pose, intrinsics, H: int, W: int) -> Dict[str, torch.Tensor]:
    """All H*W rays of a frame, row-major."""
    return rays_from_indices(pose, intrinsics, H, W,
                             torch.arange(H * W, device=pose.device))
