"""Render, network and training configuration dataclasses.

A field-for-field copy of ``ngp_tpu.config.RenderConfig``,
``NetworkConfig`` and ``TrainConfig``: the JAX package imports JAX when any of its modules
is imported, so the port cannot share the module itself.
``tests/test_torch_imports.py`` pins this copy to the original.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Scene and rendering geometry; see ``ngp_tpu.config.RenderConfig``
    for what each field means."""

    bound: float = 1.0
    density_scale: float = 1.0
    min_near: float = 0.2
    density_thresh: float = 0.01
    bg_radius: float = -1.0

    # non-accelerated path
    num_steps: int = 128
    upsample_steps: int = 128

    # accelerated path (occupancy-grid marching)
    grid_size: int = 128
    dt_gamma: float = 0.0
    max_steps: int = 1024
    t_thresh: float = 1e-4
    max_samples_per_ray: int = 256

    # D-NeRF time slices
    time_size: int = 64

    # turbo march
    turbo: bool = False
    coarse_candidates: int = 96
    crossing_slots: int = 16
    compact_mean_samples: int = 16
    t_proxy_thresh: Optional[float] = None
    lattice_span: Optional[float] = None

    @property
    def cascades(self) -> int:
        return 1 + math.ceil(math.log2(max(self.bound, 1.0)))

    @property
    def aabb(self) -> Tuple[float, ...]:
        b = self.bound
        return (-b, -b, -b, b, b, b)


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """NeRFNetwork topology."""

    encoding: str = "hashgrid"
    encoding_dir: str = "sphere_harmonics"
    encoding_bg: str = "hashgrid"
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    sh_degree: int = 4
    cp_resolutions: Tuple[int, ...] = (256, 512, 1024, 2048)
    cp_rank: int = 64
    cp_freq_degree: int = 5
    use_bf16: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer and optimizer settings; see ``ngp_tpu.config.TrainConfig``."""

    iters: int = 30000
    lr: float = 1e-2
    num_rays: int = 4096
    eval_interval: int = 50  # epochs
    update_extra_interval: int = 16
    max_keep_ckpt: int = 2
    ema_decay: float = 0.95
    error_map: bool = False
    error_map_uniform_frac: float = 0.5
    error_map_size: int = 128
    patch_size: int = 1
    rand_pose: int = -1
    seed: int = 0
    workspace: str = "workspace"
    ckpt: str = "latest"
    tv_weight: float = 0.0
    distortion_weight: float = 0.0
    color_space: str = "srgb"
