"""Traffic generator of the training cells: the scene and every step's draws.

The scene is a frozen copy of the port's procedural scene
(``ngp_tpu_torch/data/synthetic.py``): coloured constant-density
spheres rendered with 512 uniform samples a ray by emission-absorption
compositing, on the device, quantised to u8 levels as a PNG round trip
does; train poses are orbit draws (theta in [pi/4, 3pi/4), phi in
[0, 2pi)) at the traffic file's radius and field of view, from the
traffic file's ``view_seed``: every run trains on the same views, as on
one dataset, so the run's seed does not change the scene's work.

``Feed`` yields each step's batch and draws, as the trainer takes them:
frames in a fresh seeded permutation each epoch, and from one device
generator the step's pixel indices, background colours and lattice
noise. The order and the draws come from the run's seed; the traffic
file (``benchmark/traffic/<name>.json``) sets the sizes and the views.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

_SPHERES = [
    ((0.0, 0.0, 0.0), 0.42, 22.0, (0.85, 0.25, 0.15)),
    ((0.4, 0.25, 0.1), 0.22, 30.0, (0.15, 0.7, 0.25)),
    ((-0.35, -0.1, 0.3), 0.18, 40.0, (0.2, 0.35, 0.9)),
    ((0.1, -0.4, -0.35), 0.15, 60.0, (0.9, 0.8, 0.2)),
    ((-0.2, 0.42, -0.2), 0.12, 80.0, (0.85, 0.4, 0.8)),
]


def seeds(seed: int, n: int) -> Tuple[int, ...]:
    """``n`` independent 63-bit seeds from one run seed of any size."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, dtype=np.uint64)
    return tuple(int(s) >> 1 for s in state)


def _field(x: torch.Tensor):
    sigma = torch.zeros(x.shape[:-1], device=x.device)
    rgb = torch.zeros(x.shape[:-1] + (3,), device=x.device)
    for c, r, s, col in _SPHERES:
        inside = (torch.linalg.norm(x - torch.tensor(c, device=x.device), dim=-1) < r).float()
        sigma = sigma + s * inside
        rgb = rgb + s * inside[..., None] * torch.tensor(col, device=x.device)
    rgb = rgb / torch.clamp(sigma[..., None], min=1e-8)
    return sigma, torch.where(sigma[..., None] > 0, rgb, torch.ones((), device=x.device))


def orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    center = np.array([radius * np.sin(theta) * np.sin(phi), radius * np.cos(theta),
                       radius * np.sin(theta) * np.cos(phi)])
    forward = -center / np.linalg.norm(center)
    right = np.cross(forward, np.array([0.0, -1.0, 0.0]))
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([right, up, forward], axis=-1)
    pose[:3, 3] = center
    return pose


@torch.no_grad()
def render_frame(pose: torch.Tensor, intrinsics: torch.Tensor, H: int, W: int,
                 num_steps: int) -> torch.Tensor:
    """RGBA frame [H, W, 4] of the analytic scene, straight colour."""
    dev = pose.device
    inds = torch.arange(H * W, device=dev)
    fx, fy, cx, cy = (intrinsics[i] for i in range(4))
    row, col = (inds // W).float() + 0.5, (inds % W).float() + 0.5
    dirs = torch.stack([(col - cx) / fx, (row - cy) / fy, torch.ones_like(row)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand_as(rays_d)
    z = torch.linspace(0.0, 1.0, num_steps, device=dev)
    images, alphas = [], []
    for i in range(0, H * W, 16384):
        ro, rd = rays_o[i:i + 16384], rays_d[i:i + 16384]
        inv = 1.0 / rd
        lo, hi = (-1.0 - ro) * inv, (1.0 - ro) * inv
        near = torch.minimum(lo, hi).amax(dim=-1)
        far = torch.maximum(lo, hi).amin(dim=-1)
        miss = near > far
        near = torch.where(miss, 1e10, torch.clamp(near, min=0.05))
        far = torch.where(miss, 1e10, far)
        far = torch.where(far > near, far, near)
        zv = near[:, None] + (far - near)[:, None] * z[None, :]
        sigma, rgb = _field(ro[:, None, :] + rd[:, None, :] * zv[..., None])
        deltas = torch.cat([zv[:, 1:] - zv[:, :-1], ((far - near) / num_steps)[:, None]], dim=-1)
        a = 1.0 - torch.exp(-deltas * sigma)
        shifted = torch.cat([torch.ones_like(a[..., :1]), 1.0 - a + 1e-15], dim=-1)
        w = a * torch.cumprod(shifted, dim=-1)[..., :-1]
        images.append((w[..., None] * rgb).sum(dim=-2))
        alphas.append(w.sum(dim=-1))
    image = torch.cat(images).reshape(H, W, 3)
    alpha = torch.cat(alphas).reshape(H, W, 1)
    straight = torch.where(alpha > 1e-4, image / torch.clamp(alpha, min=1e-4),
                           torch.ones((), device=dev))
    return torch.clamp(torch.cat([straight, alpha], dim=-1), 0.0, 1.0)


@dataclasses.dataclass
class Scene:
    images: torch.Tensor  # [F, H, W, 4] f32 in [0, 1], u8 levels
    poses: torch.Tensor  # [F, 4, 4] cam-to-world
    intrinsics: torch.Tensor  # [4] fx, fy, cx, cy


def make_scene(traffic: Dict, device) -> Scene:
    """The traffic file's train views of the scene, poses drawn from its
    ``view_seed``."""
    sc = traffic["scene"]
    H, W, n = int(sc["height"]), int(sc["width"]), int(sc["train_views"])
    rng = np.random.default_rng(int(sc["view_seed"]))
    focal = 0.5 * W / np.tan(0.5 * np.deg2rad(float(sc["fov_deg"])))
    intr = torch.tensor([focal, focal, W / 2, H / 2], dtype=torch.float32, device=device)
    poses = np.stack([orbit_pose(rng.uniform(np.pi / 4, 3 * np.pi / 4),
                                 rng.uniform(0, 2 * np.pi), float(sc["radius"]))
                      for _ in range(n)])
    poses_t = torch.as_tensor(poses, device=device)
    images = torch.stack([render_frame(poses_t[i], intr, H, W, int(sc["samples_per_ray"]))
                          for i in range(n)])
    images = (images * 255).to(torch.uint8).float() / 255.0
    return Scene(images, poses_t, intr)


class Feed:
    """The steps' batches and draws from the run's seed."""

    def __init__(self, traffic: Dict, scene: Scene, order_seed: int, draw_seed: int):
        self.n_rays = int(traffic["rays_per_step"])
        self.scene = scene
        self.rng = np.random.default_rng(order_seed)
        self.gen = torch.Generator(device=scene.images.device).manual_seed(draw_seed)
        self.order = []
        self.batch = {"images": scene.images, "poses": scene.poses,
                      "intrinsics": scene.intrinsics}

    def next(self):
        """(batch, draws) of the next step."""
        if not self.order:
            self.order = list(self.rng.permutation(self.scene.images.shape[0]))
        idx = int(self.order.pop(0))
        _, H, W, _ = self.scene.images.shape
        dev = self.scene.images.device
        n = self.n_rays
        draws = {"inds": torch.randint(0, H * W, (n,), generator=self.gen, device=dev),
                 "bg": torch.rand((n, 3), generator=self.gen, device=dev),
                 "noise": torch.rand((n,), generator=self.gen, device=dev)}
        return dict(self.batch, idx=idx), draws
