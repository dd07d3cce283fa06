"""SDF regression network (``ngp_tpu/models/sdf.py``; the reference's
sdf/netowrk.py [sic]): the hash-grid encoder on (x + 1) / 2, then a
bias-free MLP with optional skip connections (the encoder's features
concatenated again before each layer in ``skips``) -> the signed
distance [..., 1], clamped to +-``clip_sdf`` when set. With
``use_bf16`` the encoder's features and every layer's input, weights and
output are rounded to bf16 (products accumulate in f32), as flax's
``Dense(dtype=bfloat16)`` computes them; the output is f32.

On a CUDA tensor the encoder runs the grid kernels (``grid_encode_fwd``
and, while autograd records the table, ``grid_encode_bwd``); the SDF
loss takes no gradient in x.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ngp_tpu_torch.models.encoders import get_encoder
from ngp_tpu_torch.models.mlp import lecun_normal


class SDFNetwork(nn.Module):
    """Weights come from a seeded CPU ``torch.Generator`` or, through
    ``load_state_dict(params_from_jax(tree))``, from the JAX model; they
    are built on ``device`` (the card unless the caller asks for another)."""

    def __init__(self, encoding: str = "hashgrid", num_layers: int = 3,
                 skips: Sequence[int] = (), hidden_dim: int = 64,
                 clip_sdf: Optional[float] = None, use_bf16: bool = False,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        self.num_layers = num_layers
        self.skips = tuple(skips)
        self.clip_sdf = clip_sdf
        self.compute_dtype = torch.bfloat16 if use_bf16 else None
        self.encoder, in_dim = get_encoder(encoding, compute_dtype=self.compute_dtype,
                                           generator=g, device=device)
        dim = in_dim
        for layer in range(num_layers):
            if layer in self.skips:
                dim += in_dim
            out = 1 if layer == num_layers - 1 else hidden_dim
            self.register_parameter(f"dense_{layer}",
                                    nn.Parameter(lecun_normal(dim, out, g).to(device)))
            dim = out

    @property
    def weights(self):
        return tuple(getattr(self, f"dense_{i}") for i in range(self.num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., 3] in [-1, 1] -> sdf [..., 1] f32."""
        feat = self.encoder((x + 1.0) / 2.0)
        dt = self.compute_dtype or feat.dtype
        h = feat
        for layer, w in enumerate(self.weights):
            if layer in self.skips:
                h = torch.cat([h, feat], dim=-1)
            h = (h.to(dt).float() @ w.to(dt).float()).to(dt)
            if layer != self.num_layers - 1:
                h = torch.relu(h)
        h = h.float()
        if self.clip_sdf is not None:
            h = torch.clamp(h, -self.clip_sdf, self.clip_sdf)
        return h


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """Flax ``SDFNetwork`` params (with or without the top-level
    ``"params"`` key) -> this module's state dict: the encoder's table
    (flax names the unnamed submodule ``GridEncoder_0``) and
    ``dense_<l>/kernel`` ([in, out], no transpose)."""
    p = tree.get("params", tree)
    out = {}
    for name, v in p.items():
        if name.startswith("dense_"):
            out[name] = torch.from_numpy(np.array(v["kernel"], np.float32))
        else:
            out.update({f"encoder.{k}": torch.from_numpy(np.array(a, np.float32))
                        for k, a in v.items()})
    return out
