"""Encoder factory (``ngp_tpu/models/encoders.py``); the port has the
``cpgrid`` and ``sphere_harmonics`` encoders so far."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ngp_tpu_torch.ops.cpgrid import CPGridConfig, cpgrid_encode
from ngp_tpu_torch.ops.sh import sh_basis_dim, sh_encode


class SHEncoder(nn.Module):
    def __init__(self, degree: int = 4):
        super().__init__()
        self.degree = degree
        self.output_dim = sh_basis_dim(degree)

    def forward(self, dirs: torch.Tensor) -> torch.Tensor:
        return sh_encode(dirs, self.degree)


class CPGridEncoder(nn.Module):
    """Multiresolution CP factor banks, one ``factors_<res>`` parameter
    ([3, res, rank]) per bank, as the flax module names them."""

    def __init__(self, cfg: CPGridConfig,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.output_dim = cfg.output_dim
        g = generator or torch.Generator().manual_seed(0)
        for r, f in zip(cfg.resolutions, cfg.init(g)):
            self.register_parameter(f"factors_{r}", nn.Parameter(f))

    @property
    def factors(self):
        return tuple(getattr(self, f"factors_{r}") for r in self.cfg.resolutions)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cpgrid_encode(x, self.factors, self.cfg, self.compute_dtype)


def get_encoder(
    encoding: str,
    degree: int = 4,
    compute_dtype: Optional[torch.dtype] = None,
    cp_resolutions: Tuple[int, ...] = (256, 512, 1024, 2048),
    cp_rank: int = 64,
    cp_freq_degree: int = 5,
    generator: Optional[torch.Generator] = None,
) -> Tuple[nn.Module, int]:
    """String -> (encoder module, output_dim)."""
    if encoding == "sphere_harmonics":
        enc = SHEncoder(degree=degree)
        return enc, enc.output_dim
    if encoding == "cpgrid":
        cfg = CPGridConfig(
            resolutions=tuple(cp_resolutions), rank=cp_rank,
            freq_degree=cp_freq_degree,
        )
        enc = CPGridEncoder(cfg, compute_dtype=compute_dtype, generator=generator)
        return enc, cfg.output_dim
    raise NotImplementedError(f"encoding {encoding!r} is not ported yet")
