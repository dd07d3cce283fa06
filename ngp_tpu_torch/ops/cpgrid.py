"""Multiresolution CP factor-bank encoder (``ngp_tpu/ops/cpgrid.py``).

Inputs live in [0, 1]^3; rows outside get zero CP features and keep
their frequency columns. ``cpgrid_density`` and ``cpgrid_sigma_rgb``
reach the CUDA kernels for CUDA tensors (``ops/kernels/cp.py``) and
their plain versions for CPU tensors, which follow the JAX package's
CPU branches. ``cpgrid_density`` is differentiable in the factors and
weights: by autograd of the plain composition on CPU tensors (the JAX
CPU branch), through ``CPDensity`` and its backward kernel on CUDA
tensors (the Pallas branch, with zero d(pos)). ``cpgrid_encode`` alone
(the unfused encoder) has no kernel yet: the Pallas ``cp_encode`` is
still to be ported, so it runs on CPU tensors only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ngp_tpu_torch.ops.freq import freq_encode, freq_encode_dim
from ngp_tpu_torch.ops.kernels.cp import (
    cp_density,
    cp_density_plain,
    cp_features_plain,
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
             device="cpu") -> Tuple[torch.Tensor, ...]:
        """One [3, res, rank] bank per resolution, normal x init_scale."""
        return tuple(
            (torch.randn((3, r, self.rank), generator=generator)
             * self.init_scale).to(device=device, dtype=dtype)
            for r in self.resolutions
        )


def _cast(ts, dtype):
    return tuple(t.to(dtype) for t in ts) if dtype is not None else tuple(ts)


def cpgrid_encode(x, factors, cfg: CPGridConfig,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x in [0, 1]^3, any leading shape -> [..., output_dim]."""
    if x.device.type != "cpu":
        raise NotImplementedError(
            "cpgrid_encode has no CUDA kernel yet (Pallas cp_encode is still "
            "to be ported); the fused heads cpgrid_density / "
            "cpgrid_sigma_rgb are"
        )
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, 3).float()
    factors = _cast(factors, compute_dtype)
    out_dtype = compute_dtype or torch.float32
    feats = cp_features_plain(xf, factors, cfg.resolutions).to(out_dtype)
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
