"""Encoder factory (``ngp_tpu/models/encoders.py``): the identity
(``None``), ``frequency``, ``sphere_harmonics``, ``cpgrid``,
``brickgrid``, ``hashgrid`` and ``tiledgrid`` encoders. Weights are
drawn from a CPU ``torch.Generator`` and placed on ``device``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ngp_tpu_torch.ops.brickgrid import BrickGridConfig, brick_encode
from ngp_tpu_torch.ops.cpgrid import CPGridConfig, cpgrid_encode
from ngp_tpu_torch.ops.freq import freq_encode, freq_encode_dim
from ngp_tpu_torch.ops.hashgrid import GridConfig, grid_encode, grid_tv_loss
from ngp_tpu_torch.ops.sh import sh_basis_dim, sh_encode


class Identity(nn.Module):
    def __init__(self, input_dim: int = 3):
        super().__init__()
        self.output_dim = input_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class FreqEncoder(nn.Module):
    def __init__(self, input_dim: int = 3, degree: int = 12):
        super().__init__()
        self.degree = degree
        self.output_dim = freq_encode_dim(input_dim, degree)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return freq_encode(x, self.degree)


class SHEncoder(nn.Module):
    def __init__(self, degree: int = 4):
        super().__init__()
        self.degree = degree
        self.output_dim = sh_basis_dim(degree)

    def forward(self, dirs: torch.Tensor) -> torch.Tensor:
        return sh_encode(dirs, self.degree)


class BrickGridEncoder(nn.Module):
    """Brick-halo multiresolution grid (``ops/brickgrid.py``: one gather per
    point and level), one learned table, the ``embeddings`` parameter
    [num_rows, 27 * level_dim], as the flax module names it."""

    def __init__(self, cfg: BrickGridConfig, compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.output_dim = cfg.output_dim
        g = generator or torch.Generator().manual_seed(0)
        self.embeddings = nn.Parameter(cfg.init(g, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return brick_encode(x, self.embeddings, self.cfg, self.compute_dtype)


class CPGridEncoder(nn.Module):
    """Multiresolution CP factor banks, one ``factors_<res>`` parameter
    ([3, res, rank]) per bank, as the flax module names them. Split over a
    mesh's ``model`` axis (``parallel.shard_params``), each bank holds this
    rank's columns and ``feature_gather`` all-gathers the ranks' feature
    columns before the frequency columns are appended."""

    def __init__(self, cfg: CPGridConfig,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.output_dim = cfg.output_dim
        g = generator or torch.Generator().manual_seed(0)
        for r, f in zip(cfg.resolutions, cfg.init(g, device=device)):
            self.register_parameter(f"factors_{r}", nn.Parameter(f))
        self.feature_gather = None

    @property
    def factors(self):
        return tuple(getattr(self, f"factors_{r}") for r in self.cfg.resolutions)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cpgrid_encode(x, self.factors, self.cfg, self.compute_dtype,
                             gather=self.feature_gather)


class GridEncoder(nn.Module):
    """Multiresolution hash or tiled grid with one learned table, the
    ``embeddings`` parameter [num_rows, level_dim], as the flax module
    names it."""

    def __init__(self, cfg: GridConfig, compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.output_dim = cfg.output_dim
        g = generator or torch.Generator().manual_seed(0)
        self.embeddings = nn.Parameter(cfg.init(g, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return grid_encode(x, self.embeddings, self.cfg, self.compute_dtype)

    def tv_loss(self) -> torch.Tensor:
        """TV regulariser over the table's dense levels (``grid_tv_loss``)."""
        return grid_tv_loss(self.embeddings, self.cfg)


def get_encoder(
    encoding: Optional[str],
    input_dim: int = 3,
    multires: int = 6,
    degree: int = 4,
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: int = 2048,
    align_corners: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    cp_resolutions: Tuple[int, ...] = (256, 512, 1024, 2048),
    cp_rank: int = 64,
    cp_freq_degree: int = 5,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> Tuple[nn.Module, int]:
    """String -> (encoder module, output_dim)."""
    if encoding is None or encoding == "None":
        return Identity(input_dim), input_dim
    if encoding == "frequency":
        enc = FreqEncoder(input_dim, multires)
        return enc, enc.output_dim
    if encoding == "sphere_harmonics":
        enc = SHEncoder(degree=degree)
        return enc, enc.output_dim
    if encoding == "cpgrid":
        cfg = CPGridConfig(
            resolutions=tuple(cp_resolutions), rank=cp_rank,
            freq_degree=cp_freq_degree,
        )
        enc = CPGridEncoder(cfg, compute_dtype=compute_dtype, generator=generator,
                            device=device)
        return enc, cfg.output_dim
    if encoding == "brickgrid":
        cfg = BrickGridConfig(
            num_levels=num_levels, level_dim=level_dim, base_resolution=base_resolution,
            log2_hashmap_size=min(log2_hashmap_size, 16),
            desired_resolution=desired_resolution,
        )
        enc = BrickGridEncoder(cfg, compute_dtype=compute_dtype, generator=generator,
                               device=device)
        return enc, cfg.output_dim
    if encoding in ("hashgrid", "tiledgrid"):
        cfg = GridConfig(
            input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution, log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            gridtype="hash" if encoding == "hashgrid" else "tiled",
            align_corners=align_corners,
        )
        enc = GridEncoder(cfg, compute_dtype=compute_dtype, generator=generator,
                          device=device)
        return enc, cfg.output_dim
    raise ValueError(f"unknown encoding: {encoding}")
