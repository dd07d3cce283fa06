"""NeRF network head (``ngp_tpu/models/nerf.py``): cpgrid or hash grid
-> 2-layer sigma MLP (1 + geo outputs), SH(dir) + geo -> color MLP ->
sigmoid; with ``bg_radius > 0`` also the background net, a 2-D hash grid
over the sphere coordinates of a ray's exit point + SH(dir) -> 2-layer
MLP -> sigmoid.

``make_fused_density`` and ``make_fused_sigma_rgb`` build the flagship
config's fused heads on the CP kernels; ``params_from_jax`` converts a
flax param tree of the JAX ``NeRFNetwork`` into this module's state.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ngp_tpu_torch.config import NetworkConfig, RenderConfig
from ngp_tpu_torch.models.encoders import get_encoder
from ngp_tpu_torch.models.mlp import MLP
from ngp_tpu_torch.ops.activation import trunc_exp
from ngp_tpu_torch.ops.cpgrid import CPGridConfig, cpgrid_density, cpgrid_sigma_rgb


class NeRFNetwork(nn.Module):
    """Weights come from a seeded CPU ``torch.Generator`` or, through
    ``load_state_dict(params_from_jax(tree))``, from the JAX model; they
    are built on ``device`` (the card unless the caller asks for another)."""

    def __init__(self, cfg: NetworkConfig, render: RenderConfig,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.render = render
        g = generator or torch.Generator().manual_seed(0)
        dtype = torch.bfloat16 if cfg.use_bf16 else None
        self.compute_dtype = dtype
        self.encoder, in_dim = get_encoder(
            cfg.encoding, num_levels=cfg.num_levels, level_dim=cfg.level_dim,
            base_resolution=cfg.base_resolution, log2_hashmap_size=cfg.log2_hashmap_size,
            desired_resolution=int(2048 * render.bound), compute_dtype=dtype,
            cp_resolutions=cfg.cp_resolutions, cp_rank=cfg.cp_rank,
            cp_freq_degree=cfg.cp_freq_degree, generator=g, device=device,
        )
        self.sigma_net = MLP(in_dim, 1 + cfg.geo_feat_dim, cfg.hidden_dim,
                             cfg.num_layers, dtype, g, device)
        self.encoder_dir, in_dim_dir = get_encoder(cfg.encoding_dir, degree=cfg.sh_degree)
        self.color_net = MLP(in_dim_dir + cfg.geo_feat_dim, 3, cfg.hidden_dim_color,
                             cfg.num_layers_color, dtype, g, device)
        if render.bg_radius > 0:
            # drawn after every other network, whose initialisation is then
            # the same with and without it; the encoder's other arguments
            # are get_encoder's defaults, as in JAX
            self.encoder_bg, in_dim_bg = get_encoder(
                cfg.encoding_bg, input_dim=2, num_levels=4, log2_hashmap_size=19,
                desired_resolution=2048, compute_dtype=dtype, generator=g, device=device,
            )
            self.bg_net = MLP(in_dim_dir + in_dim_bg, 3, cfg.hidden_dim_bg, cfg.num_layers_bg,
                              dtype, g, device)

    def _scale_to_unit(self, x):
        b = self.render.bound
        return (x + b) / (2 * b)

    def density(self, x):
        """x: [..., 3] in [-bound, bound] -> (sigma [...], geo [..., G])."""
        h = self.sigma_net(self.encoder(self._scale_to_unit(x)))
        return trunc_exp(h[..., 0].float()), h[..., 1:]

    def color(self, d, geo_feat):
        """d: [..., 3] unit dirs -> rgb [..., 3]."""
        de = self.encoder_dir(d)
        h = self.color_net(torch.cat([de.to(geo_feat.dtype), geo_feat], dim=-1))
        return torch.sigmoid(h.float())

    def forward(self, x, d):
        sigma, geo = self.density(x)
        return sigma, self.color(d, geo)

    def background(self, sph, d):
        """sph: [..., 2] in [-1, 1] (``ops.rays.sph_from_ray``), d: [..., 3]
        unit dirs -> rgb [..., 3]."""
        if self.render.bg_radius <= 0:
            raise ValueError("background() requires bg_radius > 0")
        h = self.encoder_bg((sph + 1.0) / 2.0)
        de = self.encoder_dir(d)
        h = self.bg_net(torch.cat([de.to(h.dtype), h], dim=-1))
        return torch.sigmoid(h.float())

    def tv_loss(self) -> torch.Tensor:
        """TV regulariser of the spatial encoder's table; 0 for encoders
        without one (cpgrid, frequency, identity)."""
        if hasattr(self.encoder, "tv_loss"):
            return self.encoder.tv_loss()
        return torch.zeros((), device=next(self.parameters()).device)


def _fused_parts(model: NeRFNetwork):
    c = model.cfg
    # the fused heads read whole banks: none for a model rank's shards
    if (c.encoding != "cpgrid" or c.num_layers != 2
            or model.encoder.feature_gather is not None):
        return None
    cfg = CPGridConfig(resolutions=tuple(c.cp_resolutions), rank=c.cp_rank,
                       freq_degree=c.cp_freq_degree)
    dt = model.compute_dtype or torch.float32
    # cast once per closure, not on every call: the fused heads read the
    # weights in the MLP compute type. Built while autograd records, the
    # casts are in the graph, so gradients reach the f32 parameters
    # through them (JAX's astype); under no_grad they are plain copies.
    factors = tuple(f.to(dt).contiguous() for f in model.encoder.factors)
    w1, w2 = (w.to(dt).contiguous() for w in model.sigma_net.weights)
    return cfg, factors, w1, w2


def make_fused_density(model: NeRFNetwork) -> Optional[Callable]:
    """``density_fn(x) -> (sigma, geo)`` on the fused CP density kernel
    for the flagship config (cpgrid + 2-layer sigma MLP), else None (the
    hash grid runs the module path, as in JAX).
    Differentiable in the encoder and sigma-net weights when built with
    grad mode on; build it anew after an optimizer step."""
    parts = _fused_parts(model)
    if parts is None:
        return None
    cfg, factors, w1, w2 = parts
    dtype = model.compute_dtype
    b = model.render.bound

    def density_fn(x):
        h = cpgrid_density((x + b) / (2 * b), factors, w1, w2, cfg)
        sigma = trunc_exp(h[..., 0])
        geo = h[..., 1:]
        return sigma, geo.to(dtype) if dtype is not None else geo

    return density_fn


def make_fused_sigma_rgb(model: NeRFNetwork) -> Optional[Callable]:
    """Eval-only ``vals_fn(pts [M, 3], dirs [M, 3]) -> [M, 4]`` on the
    fused radiance kernel for the flagship config, else None."""
    c = model.cfg
    with torch.no_grad():
        parts = _fused_parts(model)
    if parts is None or c.encoding_dir != "sphere_harmonics":
        return None
    cfg, factors, w1, w2 = parts
    dt = model.compute_dtype or torch.float32
    color_ws = tuple(w.detach().to(dt).contiguous() for w in model.color_net.weights)
    b = model.render.bound

    def vals_fn(x, d):
        return cpgrid_sigma_rgb((x + b) / (2 * b), d, factors, w1, w2, color_ws,
                                cfg, c.sh_degree)

    return vals_fn


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """Flax ``NeRFNetwork`` params (nested dicts of arrays, with or
    without the top-level ``"params"`` key) -> this module's state dict.

    Reads ``encoder/factors_<res>`` (cpgrid) or ``encoder/embeddings``
    (hash or tiled grid), ``sigma_net/dense_<i>/kernel`` and
    ``color_net/dense_<i>/kernel``, and with the background net
    ``encoder_bg/embeddings`` and ``bg_net/dense_<i>/kernel``; the kernels
    keep their [in, out] layout."""
    p = tree.get("params", tree)
    out = {}
    for enc in ("encoder", "encoder_bg"):
        for name, arr in p.get(enc, {}).items():
            out[f"{enc}.{name}"] = torch.from_numpy(np.array(arr, np.float32))
    for net in ("sigma_net", "color_net", "bg_net"):
        for name, layer in p.get(net, {}).items():
            out[f"{net}.{name}"] = torch.from_numpy(np.array(layer["kernel"], np.float32))
    return out
