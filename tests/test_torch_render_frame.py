"""The slice as a whole: the port's GridNeRFTrainer.render_frame against
the JAX trainer's on the same weights and the same refreshed grid.

Bounds: mean absolute pixel difference <= 1e-4, at least 99.5% of
pixels within 1e-3 (a one-ulp difference in a ray's near can move one
lattice probe into the next cell), and the default u8 frames at most
one level apart."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ngp_tpu.config import NetworkConfig, RenderConfig, TrainConfig
from ngp_tpu.models.nerf import NeRFNetwork
from ngp_tpu.training.nerf_grid import GridNeRFTrainer
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch.models.nerf import NeRFNetwork as TNeRFNetwork
from ngp_tpu_torch.models.nerf import params_from_jax
from ngp_tpu_torch.models.occupancy import occupancy_from_jax
from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer as TGridNeRFTrainer

H = W = 32


def _pair(tmp_path, bound=1.0):
    rc = RenderConfig(bound=bound, min_near=0.05, dt_gamma=0.0, max_steps=64,
                      max_samples_per_ray=16, grid_size=16, density_thresh=10.0,
                      turbo=True, coarse_candidates=48, crossing_slots=16,
                      compact_mean_samples=6)
    nc = NetworkConfig(encoding="cpgrid", use_bf16=False, cp_resolutions=(32, 64),
                       cp_rank=16, cp_freq_degree=4, sh_degree=3)
    jtr = GridNeRFTrainer(NeRFNetwork(cfg=nc, render=rc), rc,
                          TrainConfig(iters=10, num_rays=256, workspace=str(tmp_path)),
                          log_every=10**9, use_tensorboard=False)
    jtr.ensure_initialized()
    for _ in range(3):
        jtr._update_occupancy()
    occ = jtr.aux["occ"]
    arrays = {f.name: np.asarray(getattr(occ, f.name)) for f in dataclasses.fields(occ)}
    net = TNeRFNetwork(tconfig.NetworkConfig(**dataclasses.asdict(nc)),
                       tconfig.RenderConfig(**dataclasses.asdict(rc)), device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jtr.eval_params())))
    ttr = TGridNeRFTrainer(net, net.render)
    ttr.aux = {"occ": occupancy_from_jax(arrays, device="cpu")}
    return jtr, ttr


def _poses():
    poses = []
    for ang in (0.3, 2.1):
        o = np.array([2.5 * np.sin(ang), 0.4, -2.5 * np.cos(ang)], np.float32)
        f = -o / np.linalg.norm(o)
        r = np.cross(f, [0.0, 1.0, 0.0])
        r /= np.linalg.norm(r)
        d = np.cross(f, r)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = r, d, f, o
        poses.append(pose)
    return np.stack(poses)


INTR = np.array([36.0, 36.0, 16.0, 16.0], np.float32)


def _check(img_t, img_j):
    diff = np.abs(img_t - img_j)
    assert diff.mean() <= 1e-4, diff.mean()
    assert np.mean(diff.max(axis=-1) <= 1e-3) >= 0.995
    assert np.abs(img_j - 1.0).max() > 0.05  # the frame has content


@pytest.mark.parametrize("prepass", [True, False])
def test_render_frame_matches_jax(tmp_path, prepass):
    jtr, ttr = _pair(tmp_path)
    for tr in (jtr, ttr):
        tr.eval_prepass = prepass
        tr.eval_f32_frames = True
    for pose in _poses():
        img_j, dep_j = jtr.render_frame(pose, INTR, H, W, chunk=256)
        img_t, dep_t = ttr.render_frame(pose, INTR, H, W, chunk=256)
        assert img_t.shape == (H, W, 3) and dep_t.shape == (H, W)
        _check(img_t, img_j)
        assert np.abs(dep_t - dep_j).mean() <= 1e-4
    assert ttr._eval_lattice_span == jtr._eval_lattice_span
    assert ttr.last_render_stats["n_samples"] > 0


def test_render_frames_u8_within_one_level(tmp_path):
    jtr, ttr = _pair(tmp_path)
    poses = _poses()
    imgs_t, _ = ttr.render_frames(poses, INTR, H, W, chunk=256)
    for f in range(len(poses)):
        img_j, _ = jtr.render_frame(poses[f], INTR, H, W, chunk=256)
        levels = np.abs(np.round(imgs_t[f] * 255.0) - np.round(img_j * 255.0))
        assert levels.max() <= 1.0
        assert np.mean(levels == 0) >= 0.995
