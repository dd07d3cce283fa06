"""Multiresolution CP factor-bank encoder (``ngp_tpu/ops/cpgrid.py``).

Inputs live in [0, 1]^3; rows outside get zero CP features and keep
their frequency columns. ``cpgrid_encode`` (the unfused encoder, which
``NeRFNetwork.density`` runs), ``cpgrid_density`` and
``cpgrid_sigma_rgb`` reach the CUDA kernels for CUDA tensors
(``ops/kernels/cp.py``) and their plain versions for CPU tensors,
which follow the JAX package's CPU branches. ``cpgrid_encode`` and
``cpgrid_density`` are differentiable in the factors (and weights): by
autograd of the plain composition on CPU tensors (the JAX CPU branch),
through ``CPEncode`` / ``CPDensity`` and the factor backward kernel on
CUDA tensors (the Pallas branch, with zero d(pos)).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ngp_tpu_torch.ops.freq import freq_encode, freq_encode_dim
from ngp_tpu_torch.ops.kernels.cp import (
    cp_density,
    cp_density_plain,
    cp_encode,
    cp_encode_plain,
    cp_sigma_rgb,
)


@dataclasses.dataclass(frozen=True)
class CPGridConfig:
    resolutions: Tuple[int, ...] = (256, 512, 1024, 2048)
    rank: int = 64
    freq_degree: int = 5
    init_scale: float = 0.2
    block: int = 1024

    @property
    def output_dim(self) -> int:
        d = len(self.resolutions) * self.rank
        if self.freq_degree > 0:
            d += freq_encode_dim(3, self.freq_degree)
        return d

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda") -> Tuple[torch.Tensor, ...]:
        """One [3, res, rank] bank per resolution, normal x init_scale,
        drawn from a CPU generator and placed on ``device``."""
        return tuple(
            (torch.randn((3, r, self.rank), generator=generator)
             * self.init_scale).to(device=device, dtype=dtype)
            for r in self.resolutions
        )


def _cast(ts, dtype):
    return tuple(t.to(dtype) for t in ts) if dtype is not None else tuple(ts)


def cpgrid_encode(x, factors, cfg: CPGridConfig,
                  compute_dtype: Optional[torch.dtype] = None,
                  gather: Optional[Callable] = None) -> torch.Tensor:
    """x in [0, 1]^3, any leading shape -> [..., output_dim] in
    ``compute_dtype`` (f32 when None): the CP features, then the freq
    columns of 2x - 1. With ``gather`` the factors are a model rank's
    column shards, and ``gather`` maps their features to the whole banks'
    (``parallel.collectives.gather_cp_features``)."""
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, 3).float().contiguous()
    factors = tuple(f.contiguous() for f in _cast(factors, compute_dtype))
    out_dtype = compute_dtype or torch.float32
    encode = cp_encode_plain if xf.device.type == "cpu" else cp_encode
    feats = encode(xf, factors, cfg.resolutions, out_dtype)
    if gather is not None:
        feats = gather(feats)
    if cfg.freq_degree > 0:
        fr = freq_encode(2.0 * xf - 1.0, cfg.freq_degree).to(out_dtype)
        feats = torch.cat([feats, fr], dim=-1)
    return feats.reshape(*batch_shape, cfg.output_dim)


def cpgrid_density(x, factors, w1, w2, cfg: CPGridConfig,
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused density head: [cpgrid_encode(x)] -> relu(. @ w1) @ w2.
    x in [0, 1]^3, any leading shape -> [..., OUT] f32."""
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, 3).float().contiguous()
    factors = tuple(f.contiguous() for f in _cast(factors, compute_dtype))
    w1, w2 = (w.contiguous() for w in _cast((w1, w2), compute_dtype))
    head = cp_density_plain if xf.device.type == "cpu" else cp_density
    out = head(xf, factors, w1, w2, cfg.resolutions, cfg.freq_degree)
    return out.reshape(*batch_shape, w2.shape[1])


def cpgrid_sigma_rgb(x, dirs, factors, w1, w2, color_ws, cfg: CPGridConfig,
                     sh_degree: int,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused eval radiance: x in [0, 1]^3, unit dirs -> [..., 4] f32
    rows (trunc_exp(sigma_raw), sigmoid(rgb))."""
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, 3).float().contiguous()
    df = dirs.reshape(-1, 3).float().contiguous()
    factors = _cast(factors, compute_dtype)
    w1, w2 = _cast((w1, w2), compute_dtype)
    color_ws = _cast(color_ws, compute_dtype)
    out = cp_sigma_rgb(xf, df, factors, w1, w2, color_ws, cfg.resolutions,
                       cfg.freq_degree, sh_degree)
    return out.reshape(*batch_shape, 4)
