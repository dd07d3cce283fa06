"""D-NeRF: dynamic scenes (``ngp_tpu/models/dnerf.py``; the reference's
dnerf/ family).

- ``DNeRFNetwork`` (deform, the default; dnerf/network.py): freq(x, 10) and
  freq(t, 6) -> a 5 x 128 MLP -> dx; the canonical point x + dx feeds the
  hash grid, whose features, freq(t) and freq(x) go to the sigma net; an
  SH colour net as the static NeRF's. The deformation net trains only
  through the grid encoder's gradient in its points (``GridEncode``'s
  x-gradient, ``grid_encode_bwd_x`` on the card).
- ``DNeRFHyperNetwork`` (ambient; dnerf/network_hyper.py): tanh(MLP(freq(t)))
  * bound is an extra grid coordinate, so the hash grid is 4-D.
- ``DNeRFBasisNetwork`` (temporal basis; dnerf/network_basis.py): the
  sigma and colour heads give per-basis coefficients, dotted with a
  learned basis(t).

Each has ``density(x, t) -> (sigma, geo, dx)``, ``color(d, geo)`` and
``forward(x, d, t) -> (sigma, rgb, dx)``; t is a scene time in [0, 1] (a
float or a 0-d tensor). Weights come from a seeded CPU generator on
``device`` (the card unless the caller asks for another), or from
``params_from_jax`` of the flax tree.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ngp_tpu_torch.config import NetworkConfig, RenderConfig
from ngp_tpu_torch.models.encoders import get_encoder
from ngp_tpu_torch.models.mlp import MLP
from ngp_tpu_torch.ops.activation import trunc_exp
from ngp_tpu_torch.ops.freq import freq_encode, freq_encode_dim


def _time_column(t, like: torch.Tensor) -> torch.Tensor:
    """t (a float or 0-d tensor) as an f32 column [..., 1] of like's batch."""
    tt = torch.as_tensor(t, dtype=torch.float32, device=like.device).reshape(1)
    return tt.expand(*like.shape[:-1], 1)


class _DNeRFBase(nn.Module):
    def _setup(self, cfg: NetworkConfig, render: RenderConfig, generator, device):
        self.cfg = cfg
        self.render = render
        self.compute_dtype = torch.bfloat16 if cfg.use_bf16 else None
        return generator or torch.Generator().manual_seed(0)

    def _grid(self, g, device, input_dim: int = 3):
        c = self.cfg
        enc, dim = get_encoder(c.encoding, input_dim=input_dim, num_levels=c.num_levels,
                               level_dim=c.level_dim, base_resolution=c.base_resolution,
                               log2_hashmap_size=c.log2_hashmap_size,
                               desired_resolution=int(2048 * self.render.bound),
                               compute_dtype=self.compute_dtype, generator=g, device=device)
        self.encoder = enc
        return dim

    def _scale_to_unit(self, x):
        b = self.render.bound
        return (x + b) / (2 * b)

    def color(self, d, geo_feat):
        de = self.encoder_dir(d)
        h = torch.cat([de.to(geo_feat.dtype), geo_feat], dim=-1)
        return torch.sigmoid(self.color_net(h).float())

    def forward(self, x, d, t):
        sigma, geo, dx = self.density(x, t)
        return sigma, self.color(d, geo), dx


class DNeRFNetwork(_DNeRFBase):
    """The deformation-network variant (dnerf/network.py)."""

    def __init__(self, cfg: NetworkConfig, render: RenderConfig, num_layers_deform: int = 5,
                 hidden_dim_deform: int = 128, deform_multires: int = 10,
                 time_multires: int = 6, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        g = self._setup(cfg, render, generator, device)
        dt = self.compute_dtype
        self.deform_multires, self.time_multires = deform_multires, time_multires
        enc_dims = freq_encode_dim(3, deform_multires) + freq_encode_dim(1, time_multires)
        self.deform_net = MLP(enc_dims, 3, hidden_dim_deform, num_layers_deform, dt, g, device)
        in_dim = self._grid(g, device)
        self.sigma_net = MLP(in_dim + enc_dims, 1 + cfg.geo_feat_dim, cfg.hidden_dim,
                             cfg.num_layers, dt, g, device)
        self.encoder_dir, in_dim_dir = get_encoder(cfg.encoding_dir, degree=cfg.sh_degree)
        self.color_net = MLP(in_dim_dir + cfg.geo_feat_dim, 3, cfg.hidden_dim_color,
                             cfg.num_layers_color, dt, g, device)

    def deform(self, x, t):
        """x: [..., 3], t: scene time -> (dx [..., 3] f32, freq(x), freq(t))."""
        enc_x = freq_encode(x, self.deform_multires)
        enc_t = freq_encode(_time_column(t, x), self.time_multires)
        return self.deform_net(torch.cat([enc_x, enc_t], dim=-1)).float(), enc_x, enc_t

    def density(self, x, t):
        """-> (sigma [...], geo [..., G], dx [..., 3])."""
        dx, enc_x, enc_t = self.deform(x, t)
        h = self.encoder(self._scale_to_unit(x + dx))
        h = self.sigma_net(torch.cat([h, enc_t.to(h.dtype), enc_x.to(h.dtype)], dim=-1))
        return trunc_exp(h[..., 0].float()), h[..., 1:], dx


class DNeRFHyperNetwork(_DNeRFBase):
    """The hyper-space variant (dnerf/network_hyper.py:126-138): the scene
    time maps to ``ambient_dim`` extra grid coordinates."""

    def __init__(self, cfg: NetworkConfig, render: RenderConfig, num_layers_ambient: int = 5,
                 hidden_dim_ambient: int = 128, ambient_dim: int = 1, time_multires: int = 6,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        g = self._setup(cfg, render, generator, device)
        dt = self.compute_dtype
        self.ambient_dim, self.time_multires = ambient_dim, time_multires
        self.ambient_net = MLP(freq_encode_dim(1, time_multires), ambient_dim,
                               hidden_dim_ambient, num_layers_ambient, dt, g, device)
        in_dim = self._grid(g, device, input_dim=3 + ambient_dim)
        self.sigma_net = MLP(in_dim, 1 + cfg.geo_feat_dim, cfg.hidden_dim, cfg.num_layers,
                             dt, g, device)
        self.encoder_dir, in_dim_dir = get_encoder(cfg.encoding_dir, degree=cfg.sh_degree)
        self.color_net = MLP(in_dim_dir + cfg.geo_feat_dim, 3, cfg.hidden_dim_color,
                             cfg.num_layers_color, dt, g, device)

    def ambient(self, t) -> torch.Tensor:
        """[ambient_dim] = tanh(ambient_net(freq(t))) * bound."""
        dev = self.ambient_net.dense_0.device
        enc_t = freq_encode(torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(1, 1),
                            self.time_multires)
        return torch.tanh(self.ambient_net(enc_t).float())[0] * self.render.bound

    def density(self, x, t):
        amb = self.ambient(t)
        x4 = torch.cat([x, amb.expand(*x.shape[:-1], self.ambient_dim)], dim=-1)
        h = self.sigma_net(self.encoder(self._scale_to_unit(x4)))
        return trunc_exp(h[..., 0].float()), h[..., 1:], torch.zeros_like(x)


class DNeRFBasisNetwork(_DNeRFBase):
    """The temporal-basis variant (dnerf/network_basis.py)."""

    def __init__(self, cfg: NetworkConfig, render: RenderConfig, num_basis: int = 4,
                 time_multires: int = 6, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        g = self._setup(cfg, render, generator, device)
        dt = self.compute_dtype
        self.num_basis, self.time_multires = num_basis, time_multires
        in_dim = self._grid(g, device)
        self.basis_net = MLP(freq_encode_dim(1, time_multires), num_basis, 128, 3, dt, g, device)
        self.sigma_net = MLP(in_dim, (1 + cfg.geo_feat_dim) * num_basis, cfg.hidden_dim,
                             cfg.num_layers, dt, g, device)
        self.encoder_dir, in_dim_dir = get_encoder(cfg.encoding_dir, degree=cfg.sh_degree)
        self.color_net = MLP(in_dim_dir + cfg.geo_feat_dim, 3 * num_basis, cfg.hidden_dim_color,
                             cfg.num_layers_color, dt, g, device)

    def basis(self, t) -> torch.Tensor:
        dev = self.basis_net.dense_0.device
        enc_t = freq_encode(torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(1, 1),
                            self.time_multires)
        return self.basis_net(enc_t)[0].float()

    def density(self, x, t):
        b = self.basis(t)
        h = self.sigma_net(self.encoder(self._scale_to_unit(x))).float()
        h = h.reshape(*x.shape[:-1], 1 + self.cfg.geo_feat_dim, self.num_basis)
        out = (h * b).sum(dim=-1)
        geo = torch.cat([out[..., 1:], b.expand(*x.shape[:-1], self.num_basis)], dim=-1)
        return trunc_exp(out[..., 0]), geo, torch.zeros_like(x)

    def color(self, d, geo_feat):
        b = geo_feat[..., -self.num_basis:]
        h = torch.cat([self.encoder_dir(d), geo_feat[..., :-self.num_basis]], dim=-1)
        h = self.color_net(h).float().reshape(*d.shape[:-1], 3, self.num_basis)
        return torch.sigmoid((h * b[..., None, :]).sum(dim=-1))


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """Flax D-NeRF params (any of the three variants, with or without the
    top-level ``"params"`` key) -> the module's state dict: ``encoder/
    embeddings`` and each MLP's ``dense_<i>/kernel`` ([in, out], no
    transpose)."""
    p = tree.get("params", tree)
    out = {}
    for name, v in p.items():
        if name == "encoder":
            out["encoder.embeddings"] = torch.from_numpy(np.array(v["embeddings"], np.float32))
        else:
            for layer, w in v.items():
                out[f"{name}.{layer}"] = torch.from_numpy(np.array(w["kernel"], np.float32))
    return out
