"""Camera rays from flat pixel indices (``ngp_tpu/data/raysampler.py``).

Rows are ``inds // W`` and columns ``inds % W``, sampled at pixel
centers; camera-space directions are (x, y, 1), normalised, then rotated
by the camera-to-world pose.
"""

from __future__ import annotations

from typing import Dict

import torch


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
