"""TensoRF: vector-matrix (VM) and CP tensor decompositions
(``ngp_tpu/models/tensorf.py``; the reference's tensoRF/network.py and
network_cp.py).

- VM: density = trunc_exp of the sum over the three axis pairs of
  plane(x_pair) * line(x_axis) over the ranks; colour features =
  basis_mat of the concatenated plane * line products, then
  freq(feat, 2) and freq(dir, 2) -> 3-layer MLP -> sigmoid; with
  ``bg_radius > 0`` a background plane over the sphere coordinates
  (``bg_mat``) and a 2-layer net.
- CP: the rank-R product of three per-axis lines for density and for
  the colour features.

Points are normalised to [-1, 1] inside the training AABB, which shrink
moves; the trainer passes it. The resolution is an init-time size only:
every method reads shapes from the parameters, so the parameter
transforms (``upsample_vm_params``, ``upsample_cp_params``,
``shrink_vm_params``, on a dict of tensors by parameter name) need no
new module. The factor sampling is ``ops/interp.py``'s taps (no Pallas
kernel computes it), which read the factors cell-major: every factor
parameter (``FACTOR_PREFIXES``) is made in that layout, at init, by
``set_parameters`` and by ``params_from_jax`` (``ops/interp.py:cell_major``),
in JAX's shape.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ngp_tpu_torch.models.mlp import MLP, lecun_normal
from ngp_tpu_torch.ops.activation import trunc_exp
from ngp_tpu_torch.ops.freq import freq_encode
from ngp_tpu_torch.ops.interp import cell_major, resize_bilinear, sample_1d, sample_2d

# component i: a plane over the axes MAT_IDS[i], stored [R, res[m1],
# res[m0]], and a line over the axis VEC_IDS[i] (tensoRF/network.py:36-37)
MAT_IDS = ((0, 1), (0, 2), (1, 2))
VEC_IDS = (2, 1, 0)

# parameters of the factor group (lr0); every other parameter is a network's
FACTOR_PREFIXES = ("sigma_", "color_vec", "color_mat", "bg_mat")

Params = Dict[str, torch.Tensor]


def _normalize(x: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """World points -> [-1, 1] inside ``aabb`` [6] (tensoRF/network.py:166)."""
    return 2.0 * (x - aabb[:3]) / (aabb[3:] - aabb[:3]) - 1.0


def _mean_abs(factor: torch.Tensor) -> torch.Tensor:
    """mean |factor|, taken over the factor's memory ([..., R], contiguous):
    its gradient is then cell-major like the factor (``mean``'s backward is
    contiguous in the shape it sees, and a gradient in another layout than
    its parameter's costs autograd one more launch, a copy)."""
    return factor.movedim(0, -1).abs().mean()


def _factor(g: torch.Generator, shape, scale: float, device) -> nn.Parameter:
    """A factor parameter of ``scale`` N(0, 1) entries, held cell-major."""
    return nn.Parameter(cell_major((scale * torch.randn(shape, generator=g)).to(device)))


class _TensoRFBase(nn.Module):
    def _colour_head(self, feat: torch.Tensor, d: torch.Tensor, shape) -> torch.Tensor:
        feat = feat @ self.basis_mat
        h = torch.cat([freq_encode(feat, 2), freq_encode(d.reshape(-1, 3), 2)], dim=-1)
        return torch.sigmoid(self.color_net(h).float()).reshape(*shape, 3)

    def forward(self, x, d, aabb):
        sigma, geo = self.density(x, aabb)
        return sigma, self.color(d, geo, aabb)


class TensoRFNetwork(_TensoRFBase):
    """VM decomposition. Weights come from a seeded CPU generator (or
    ``params_from_jax``), on ``device`` (the card unless the caller asks
    for another)."""

    def __init__(self, resolution: Sequence[int] = (128, 128, 128),
                 sigma_rank: Sequence[int] = (16, 16, 16),
                 color_rank: Sequence[int] = (48, 48, 48), color_feat_dim: int = 27,
                 num_layers: int = 3, hidden_dim: int = 128,
                 bg_resolution: Sequence[int] = (512, 512), bg_rank: int = 8,
                 num_layers_bg: int = 2, hidden_dim_bg: int = 64, bg_radius: float = -1.0,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        self.bg_radius = bg_radius
        for prefix, ranks in (("sigma", sigma_rank), ("color", color_rank)):
            for i in range(3):
                m0, m1 = MAT_IDS[i]
                self.register_parameter(f"{prefix}_mat_{i}", _factor(
                    g, (ranks[i], resolution[m1], resolution[m0]), 0.1, device))
                self.register_parameter(f"{prefix}_vec_{i}", _factor(
                    g, (ranks[i], resolution[VEC_IDS[i]]), 0.1, device))
        self.basis_mat = nn.Parameter(
            lecun_normal(sum(color_rank), color_feat_dim, g).to(device))
        self.color_net = MLP(5 * color_feat_dim + 15, 3, hidden_dim, num_layers,
                             generator=g, device=device)
        if bg_radius > 0:
            self.bg_mat = _factor(g, (bg_rank, *bg_resolution), 0.1, device)
            self.bg_net = MLP(15 + bg_rank, 3, hidden_dim_bg, num_layers_bg,
                              generator=g, device=device)

    def _mats(self, prefix):
        return [getattr(self, f"{prefix}_mat_{i}") for i in range(3)]

    def _vecs(self, prefix):
        return [getattr(self, f"{prefix}_vec_{i}") for i in range(3)]

    def _vm_features(self, xn, prefix):
        """xn [N, 3] in [-1, 1] -> [sum R, N] plane * line products."""
        feats = []
        for i, (mat, vec) in enumerate(zip(self._mats(prefix), self._vecs(prefix))):
            m0, m1 = MAT_IDS[i]
            uv = torch.stack([xn[:, m0], xn[:, m1]], dim=-1)
            feats.append(sample_2d(mat, uv) * sample_1d(vec, xn[:, VEC_IDS[i]]))
        return torch.cat(feats, dim=0)

    def density(self, x, aabb):
        """x: [..., 3] world -> (sigma [...], geo = x)."""
        xn = _normalize(x.reshape(-1, 3), aabb)
        sigma = trunc_exp(self._vm_features(xn, "sigma").sum(dim=0))
        return sigma.reshape(x.shape[:-1]), x

    def color(self, d, x, aabb):
        """d: [..., 3] unit dirs, x: [..., 3] world -> rgb [..., 3]."""
        xn = _normalize(x.reshape(-1, 3), aabb)
        return self._colour_head(self._vm_features(xn, "color").T, d, d.shape[:-1])

    def background(self, sph, d):
        """sph: [..., 2] in [-1, 1], d: [..., 3] -> rgb [..., 3]
        (tensoRF/network.py:200-217)."""
        h = sample_2d(self.bg_mat, sph.reshape(-1, 2)).T
        h = torch.cat([freq_encode(d.reshape(-1, 3), 2), h], dim=-1)
        return torch.sigmoid(self.bg_net(h).float()).reshape(*sph.shape[:-1], 3)

    def density_loss(self):
        """L1 of the sigma factors (tensoRF/network.py:258-263)."""
        loss = 0.0
        for mat, vec in zip(self._mats("sigma"), self._vecs("sigma")):
            loss = loss + _mean_abs(mat) + _mean_abs(vec)
        return loss


class TensoRFCPNetwork(_TensoRFBase):
    """CP decomposition (tensoRF/network_cp.py): rank-R products of three
    per-axis lines; colour features are basis_mat of the products."""

    bg_radius = -1.0

    def __init__(self, resolution: Sequence[int] = (300, 300, 300), sigma_rank: int = 96,
                 color_rank: int = 288, color_feat_dim: int = 27, num_layers: int = 3,
                 hidden_dim: int = 128, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        for prefix, rank in (("sigma", sigma_rank), ("color", color_rank)):
            for i in range(3):
                self.register_parameter(f"{prefix}_vec_{i}", _factor(
                    g, (rank, resolution[VEC_IDS[i]]), 0.2, device))
        self.basis_mat = nn.Parameter(lecun_normal(color_rank, color_feat_dim, g).to(device))
        self.color_net = MLP(5 * color_feat_dim + 15, 3, hidden_dim, num_layers,
                             generator=g, device=device)

    def _cp_features(self, xn, prefix):
        f = sample_1d(getattr(self, f"{prefix}_vec_0"), xn[:, VEC_IDS[0]])
        f = f * sample_1d(getattr(self, f"{prefix}_vec_1"), xn[:, VEC_IDS[1]])
        return f * sample_1d(getattr(self, f"{prefix}_vec_2"), xn[:, VEC_IDS[2]])

    def density(self, x, aabb):
        xn = _normalize(x.reshape(-1, 3), aabb)
        sigma = trunc_exp(self._cp_features(xn, "sigma").sum(dim=0))
        return sigma.reshape(x.shape[:-1]), x

    def color(self, d, x, aabb):
        xn = _normalize(x.reshape(-1, 3), aabb)
        return self._colour_head(self._cp_features(xn, "color").T, d, d.shape[:-1])

    def density_loss(self):
        return sum(_mean_abs(getattr(self, f"sigma_vec_{i}")) for i in range(3))


# ---------------------------------------------------------------------------
# parameter transforms: progressive upsample and occupancy shrink
# ---------------------------------------------------------------------------


def _resize_line(vec: torch.Tensor, n: int) -> torch.Tensor:
    return resize_bilinear(vec[:, :, None], (n, 1))[:, :, 0]


def upsample_vm_params(params: Params, new_resolution: Sequence[int]) -> Params:
    """Every VM factor resized bilinearly (align_corners) to
    ``new_resolution`` (upsample_model, tensoRF/network.py:268-280)."""
    p = dict(params)
    for prefix in ("sigma", "color"):
        for i in range(3):
            m0, m1 = MAT_IDS[i]
            mk, vk = f"{prefix}_mat_{i}", f"{prefix}_vec_{i}"
            if mk in p:
                p[mk] = resize_bilinear(p[mk], (new_resolution[m1], new_resolution[m0]))
            if vk in p:
                p[vk] = _resize_line(p[vk], new_resolution[VEC_IDS[i]])
    return p


def upsample_cp_params(params: Params, new_resolution: Sequence[int]) -> Params:
    p = dict(params)
    for prefix in ("sigma", "color"):
        for i in range(3):
            vk = f"{prefix}_vec_{i}"
            if vk in p:
                p[vk] = _resize_line(p[vk], new_resolution[VEC_IDS[i]])
    return p


def shrink_vm_params(params: Params, aabb: np.ndarray, occ_density: np.ndarray,
                     mean_density: float, density_thresh: float, bound: float,
                     grid_size: int) -> Tuple[Params, np.ndarray]:
    """Crop the factors to the AABB of the occupied cells of the finest
    cascade of the density grid (shrink_model, tensoRF/network.py:282-318),
    on the host. Returns (new params, new aabb [6])."""
    half = bound / grid_size
    thresh = min(density_thresh, mean_density)
    occ = np.asarray(occ_density[-1]).reshape(grid_size, grid_size, grid_size) > thresh
    idx = np.stack(np.nonzero(occ), axis=-1)
    if len(idx) == 0:
        return params, aabb
    pos = (2 * idx / (grid_size - 1) - 1) * (bound - half)
    min_pos = pos.min(0) - half
    max_pos = pos.max(0) + half

    res = _vm_resolution(params)
    units = (aabb[3:] - aabb[:3]) / np.array(res)
    tl = np.clip(np.round((min_pos - aabb[:3]) / units).astype(int), 0, None)
    br = np.minimum(np.round((max_pos - aabb[:3]) / units).astype(int), res)

    p = dict(params)
    for prefix in ("sigma", "color"):
        for i in range(3):
            m0, m1 = MAT_IDS[i]
            v = VEC_IDS[i]
            p[f"{prefix}_vec_{i}"] = p[f"{prefix}_vec_{i}"][:, tl[v]:br[v]]
            p[f"{prefix}_mat_{i}"] = p[f"{prefix}_mat_{i}"][:, tl[m1]:br[m1], tl[m0]:br[m0]]
    return p, np.concatenate([min_pos, max_pos]).astype(np.float32)


def _vm_resolution(params: Params) -> Tuple[int, int, int]:
    """(res_x, res_y, res_z) from the factor shapes: line i covers axis
    VEC_IDS[i]."""
    res = [0, 0, 0]
    for i in range(3):
        res[VEC_IDS[i]] = params[f"sigma_vec_{i}"].shape[1]
    return tuple(res)


def set_parameters(model: nn.Module, params: Params) -> None:
    """Replace the model's parameters by new ``nn.Parameter``s holding
    ``params`` (by name; shapes may change): the factors cell-major, the
    rest contiguous."""
    for name, t in params.items():
        prefix, _, leaf = name.rpartition(".")
        module = model.get_submodule(prefix) if prefix else model
        t = t.detach()
        setattr(module, leaf, nn.Parameter(
            cell_major(t) if name.startswith(FACTOR_PREFIXES) else t.contiguous()))


def params_from_jax(tree) -> Params:
    """Flax ``TensoRFNetwork`` / ``TensoRFCPNetwork`` params (with or
    without the top-level ``"params"`` key) -> the module's state dict:
    the factors by name (cell-major), ``basis_mat/kernel``, and
    ``color_net`` / ``bg_net`` ``dense_<i>/kernel`` ([in, out], no
    transpose)."""
    p = tree.get("params", tree)
    out = {}
    for name, v in p.items():
        if name in ("color_net", "bg_net"):
            for layer, w in v.items():
                out[f"{name}.{layer}"] = torch.from_numpy(np.array(w["kernel"], np.float32))
        elif name == "basis_mat":
            out[name] = torch.from_numpy(np.array(v["kernel"], np.float32))
        else:
            out[name] = cell_major(torch.from_numpy(np.array(v, np.float32)))
    return out
