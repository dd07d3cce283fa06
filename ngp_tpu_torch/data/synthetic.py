"""Procedural synthetic NeRF scene (``ngp_tpu/data/synthetic.py``).

Two analytic emission-absorption fields (constant-density coloured
spheres, and a harder textured variant with rods and a torus; with a
time, the first sphere moves along x) rendered with 512 uniform samples
per ray and the JAX package's plain compositor
(``ngp_tpu/models/renderer.py:composite``). ``make_synthetic_dataset``
writes the blender-format scene to disk (``transforms_{split}.json``
and RGBA PNGs through cv2), as the JAX function does;
``make_synthetic_frames`` returns the same splits in memory, with the
same seeded poses, and quantises the frames to u8 levels the way the
PNG round trip does.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
from ngp_tpu_torch.data.raysampler import full_frame_rays
from ngp_tpu_torch.ops.rays import near_far_from_aabb

# spheres: (center, radius, sigma, rgb)
_SPHERES = [
    ((0.0, 0.0, 0.0), 0.42, 22.0, (0.85, 0.25, 0.15)),
    ((0.4, 0.25, 0.1), 0.22, 30.0, (0.15, 0.7, 0.25)),
    ((-0.35, -0.1, 0.3), 0.18, 40.0, (0.2, 0.35, 0.9)),
    ((0.1, -0.4, -0.35), 0.15, 60.0, (0.9, 0.8, 0.2)),
    ((-0.2, 0.42, -0.2), 0.12, 80.0, (0.85, 0.4, 0.8)),
]
# hard variant: spheres (center, radius, sigma, rgb, texture frequency),
# rods (a, b, radius, sigma, rgb), a torus (center, R, r, sigma, rgb)
_HARD_SPHERES = [
    ((0.0, 0.0, 0.0), 0.38, 25.0, (0.85, 0.25, 0.15), 9.0),
    ((0.42, 0.28, 0.12), 0.2, 30.0, (0.15, 0.7, 0.25), 14.0),
    ((-0.38, -0.12, 0.32), 0.17, 40.0, (0.2, 0.35, 0.9), 11.0),
    ((0.12, -0.42, -0.36), 0.14, 60.0, (0.9, 0.8, 0.2), 17.0),
    ((-0.22, 0.45, -0.22), 0.11, 80.0, (0.85, 0.4, 0.8), 21.0),
    ((0.55, -0.2, 0.4), 0.09, 70.0, (0.3, 0.85, 0.8), 25.0),
    ((-0.55, 0.25, -0.45), 0.08, 90.0, (0.95, 0.55, 0.2), 19.0),
    ((0.3, 0.55, 0.45), 0.07, 100.0, (0.5, 0.2, 0.9), 28.0),
    ((-0.1, -0.6, 0.15), 0.06, 120.0, (0.2, 0.9, 0.4), 31.0),
    ((0.62, 0.5, -0.3), 0.05, 150.0, (0.9, 0.15, 0.5), 35.0),
    ((-0.62, -0.45, -0.2), 0.05, 150.0, (0.95, 0.9, 0.85), 40.0),
    ((0.05, 0.2, 0.62), 0.045, 160.0, (0.4, 0.6, 1.0), 38.0),
]
_HARD_RODS = [
    ((-0.6, -0.55, -0.5), (0.6, 0.5, 0.55), 0.025, 200.0, (1.0, 0.85, 0.3)),
    ((-0.5, 0.6, 0.5), (0.55, -0.6, -0.45), 0.02, 220.0, (0.3, 1.0, 0.9)),
    ((0.6, -0.5, 0.55), (-0.55, 0.55, -0.55), 0.02, 220.0, (1.0, 0.45, 0.85)),
]
_HARD_TORUS = ((0.0, 0.15, 0.0), 0.55, 0.04, 180.0, (0.55, 0.95, 0.35))


def _vec(v, x):
    return torch.tensor(v, dtype=torch.float32, device=x.device)


def _center(i, c, x, time):
    """Sphere i's centre; with a time in [0, 1], sphere 0 moves along x."""
    c = _vec(c, x)
    if time is not None and i == 0:
        c = c + _vec((0.5, 0.0, 0.0), x) * (time - 0.5)
    return c


def scene_density_color(x: torch.Tensor, time: Optional[float] = None):
    """x [..., 3] -> (sigma [...], rgb [..., 3]): coloured spheres."""
    sigma = torch.zeros(x.shape[:-1], device=x.device)
    rgb = torch.zeros(x.shape[:-1] + (3,), device=x.device)
    for i, (c, r, s, col) in enumerate(_SPHERES):
        inside = (torch.linalg.norm(x - _center(i, c, x, time), dim=-1) < r).float()
        sigma = sigma + s * inside
        rgb = rgb + s * inside[..., None] * _vec(col, x)
    rgb = rgb / torch.clamp(sigma[..., None], min=1e-8)
    return sigma, torch.where(sigma[..., None] > 0, rgb, torch.ones((), device=x.device))


def scene_density_color_hard(x: torch.Tensor, time: Optional[float] = None):
    """The harder field: textured spheres down to r = 0.045, three thin
    rods and a torus, piecewise-constant sigma."""
    sigma = torch.zeros(x.shape[:-1], device=x.device)
    rgb = torch.zeros(x.shape[:-1] + (3,), device=x.device)

    def add(inside_sigma, col, tex=None):
        nonlocal sigma, rgb
        w = inside_sigma[..., None] * (tex[..., None] if tex is not None else 1.0)
        sigma = sigma + inside_sigma
        rgb = rgb + w * _vec(col, x)

    for i, (c, r, s, col, freq) in enumerate(_HARD_SPHERES):
        inside = (torch.linalg.norm(x - _center(i, c, x, time), dim=-1) < r).float()
        tex = 0.65 + 0.35 * (
            torch.sin(freq * x[..., 0] + i)
            * torch.sin(freq * x[..., 1] + 2.0 * i)
            * torch.sin(freq * x[..., 2] + 3.0 * i)
        )
        add(s * inside, col, tex)
    for a, b, r, s, col in _HARD_RODS:
        a, b = _vec(a, x), _vec(b, x)
        ab = b - a
        t = torch.clamp(((x - a) * ab).sum(dim=-1) / (ab * ab).sum(), 0.0, 1.0)
        d = torch.linalg.norm(x - (a + t[..., None] * ab), dim=-1)
        add(s * (d < r).float(), col)
    tc, R, r, s, col = _HARD_TORUS
    q = x - _vec(tc, x)
    ring = torch.sqrt(torch.clamp(q[..., 0] ** 2 + q[..., 2] ** 2, min=1e-12)) - R
    d = torch.sqrt(ring**2 + q[..., 1] ** 2)
    add(s * (d < r).float(), col)
    rgb = rgb / torch.clamp(sigma[..., None], min=1e-8)
    return sigma, torch.where(sigma[..., None] > 0, torch.clamp(rgb, 0.0, 1.0),
                              torch.ones((), device=x.device))


_FIELDS = {"default": scene_density_color, "hard": scene_density_color_hard}


def _orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """y-up look-at orbit pose in the native (ngp) frame."""
    center = np.array([
        radius * np.sin(theta) * np.sin(phi),
        radius * np.cos(theta),
        radius * np.sin(theta) * np.cos(phi),
    ])
    forward = -center / np.linalg.norm(center)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([right, up, forward], axis=-1)
    pose[:3, 3] = center
    return pose


def _inverse_ngp(pose: np.ndarray, scale: float) -> np.ndarray:
    """The inverse of ``nerf_matrix_to_ngp``: rows [2, 0, 1], rotation
    columns 1 and 2 negated, translation unscaled, so that a stored
    transforms.json pose loads back as the native pose."""
    nerf = np.eye(4, dtype=np.float32)
    nerf[0, :3] = pose[2, :3] * np.array([1, -1, -1])
    nerf[1, :3] = pose[0, :3] * np.array([1, -1, -1])
    nerf[2, :3] = pose[1, :3] * np.array([1, -1, -1])
    nerf[0, 3] = pose[2, 3] / scale
    nerf[1, 3] = pose[0, 3] / scale
    nerf[2, 3] = pose[1, 3] / scale
    return nerf


def _composite(sigmas, rgbs, deltas):
    """Front-to-back compositing without masks (``renderer.composite``):
    (premultiplied image [N, 3], weights_sum [N])."""
    alphas = 1.0 - torch.exp(-deltas * sigmas)
    shifted = torch.cat([torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-15], dim=-1)
    weights = alphas * torch.cumprod(shifted, dim=-1)[..., :-1]
    return (weights[..., None] * rgbs).sum(dim=-2), weights.sum(dim=-1)


@torch.no_grad()
def render_gt_frame(pose, intrinsics, H: int, W: int, num_steps: int = 512,
                    time: Optional[float] = None, variant: str = "default",
                    device="cuda") -> np.ndarray:
    """RGBA ground-truth frame [H, W, 4] f32 of the analytic scene (at
    ``time`` for the dynamic scene), with straight (not premultiplied)
    colour, as the PNGs store it."""
    field = _FIELDS[variant]
    pose_t = torch.as_tensor(np.asarray(pose, np.float32), device=device)
    intr_t = torch.as_tensor(np.asarray(intrinsics, np.float32), device=device)
    rays = full_frame_rays(pose_t, intr_t, H, W)
    aabb = torch.tensor([-1.0, -1, -1, 1, 1, 1], device=device)
    z = torch.linspace(0.0, 1.0, num_steps, device=device)
    images, alphas = [], []
    chunk = 16384
    for i in range(0, H * W, chunk):
        ro = rays["rays_o"][i:i + chunk]
        rd = rays["rays_d"][i:i + chunk]
        nears, fars = near_far_from_aabb(ro, rd, aabb, 0.05)
        fars = torch.where(fars > nears, fars, nears)
        z_vals = nears[:, None] + (fars - nears)[:, None] * z[None, :]
        sigma, rgb = field(ro[:, None, :] + rd[:, None, :] * z_vals[..., None], time)
        deltas = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                            ((fars - nears) / num_steps)[:, None]], dim=-1)
        img, a = _composite(sigma, rgb, deltas)
        images.append(img)
        alphas.append(a)
    image = torch.cat(images).reshape(H, W, 3)
    alpha = torch.cat(alphas).reshape(H, W, 1)
    straight = torch.where(alpha > 1e-4, image / torch.clamp(alpha, min=1e-4),
                           torch.ones((), device=device))
    return torch.clamp(torch.cat([straight, alpha], dim=-1), 0.0, 1.0).cpu().numpy()


def make_synthetic_frames(n_train: int = 40, n_val: int = 4, n_test: int = 8,
                          H: int = 400, W: int = 400, radius: float = 2.2,
                          fov_deg: float = 50.0, seed: int = 0, num_steps: int = 512,
                          variant: str = "default",
                          device="cuda") -> Dict[str, NeRFDataset]:
    """The "train", "val" and "test" splits of the synthetic scene.

    Train poses are seeded orbit draws (``np.random.default_rng(seed)``,
    theta in [pi/4, 3pi/4), phi in [0, 2pi)), eval poses a fixed ring,
    as ``make_synthetic_dataset`` draws them. Frames are RGBA, truncated
    to u8 levels and divided by 255 (the PNG round trip)."""
    rng = np.random.default_rng(seed)
    focal = 0.5 * W / np.tan(0.5 * np.deg2rad(fov_deg))
    intrinsics = np.array([focal, focal, W / 2, H / 2], np.float32)
    out = {}
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        poses, images = [], []
        for i in range(n):
            pose = _pose_draws(rng, split, i, n, radius)
            rgba = render_gt_frame(pose, intrinsics, H, W, num_steps=num_steps,
                                   variant=variant, device=device)
            poses.append(pose)
            images.append((rgba * 255).astype(np.uint8).astype(np.float32) / 255.0)
        out[split] = NeRFDataset.from_arrays(
            np.stack(images) if n else np.zeros((0, H, W, 4), np.float32),
            np.stack(poses) if n else np.zeros((0, 4, 4), np.float32),
            intrinsics, H, W, split=split,
        )
    return out


def _pose_draws(rng: np.random.Generator, split: str, i: int, n: int, radius: float):
    """Train poses are seeded orbit draws (theta in [pi/4, 3pi/4), phi in
    [0, 2pi)); eval poses a fixed ring, the test ring half a step on."""
    if split == "train":
        theta = rng.uniform(np.pi / 4, 3 * np.pi / 4)
        phi = rng.uniform(0, 2 * np.pi)
    else:
        theta = np.pi / 2.2
        phi = 2 * np.pi * (i + (0.5 if split == "test" else 0.0)) / n
    return _orbit_pose(theta, phi, radius)


def make_synthetic_dataset(root: str, n_train: int = 40, n_val: int = 4, n_test: int = 8,
                           H: int = 400, W: int = 400, radius: float = 2.2,
                           fov_deg: float = 50.0, scale: float = 0.8, seed: int = 0,
                           overwrite: bool = False, num_steps: int = 512,
                           dynamic: bool = False, variant: str = "default",
                           device="cuda") -> str:
    """Write (or, unless ``overwrite``, reuse) the blender-format scene
    under ``root``; returns root. Poses are stored pre-inverted
    (``_inverse_ngp``), so that the loader's ``nerf_matrix_to_ngp`` at
    ``scale`` gives back the native orbit poses the frames were rendered
    from; frames are written BGRA through ``cv2.imwrite``, truncated to
    u8, and a dynamic scene's frames carry their ``time``."""
    import cv2

    if os.path.exists(os.path.join(root, "transforms_train.json")) and not overwrite:
        return root
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    focal = 0.5 * W / np.tan(0.5 * np.deg2rad(fov_deg))
    intrinsics = np.array([focal, focal, W / 2, H / 2], np.float32)
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        frames = []
        for i in range(n):
            pose = _pose_draws(rng, split, i, n, radius)
            t_frame = (i / max(n - 1, 1)) if dynamic else None
            rgba = render_gt_frame(pose, intrinsics, H, W, num_steps=num_steps, time=t_frame,
                                   variant=variant, device=device)
            img_dir = os.path.join(root, split)
            os.makedirs(img_dir, exist_ok=True)
            name = f"r_{i}"
            bgra = (rgba[..., [2, 1, 0, 3]] * 255).astype(np.uint8)
            cv2.imwrite(os.path.join(img_dir, name + ".png"), bgra)
            frame = {"file_path": f"{split}/{name}",
                     "transform_matrix": _inverse_ngp(pose, scale).tolist()}
            if dynamic:
                frame["time"] = t_frame
            frames.append(frame)
        meta = {"camera_angle_x": float(2 * np.arctan(0.5 * W / focal)), "h": H, "w": W,
                "frames": frames}
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f, indent=1)
    return root
