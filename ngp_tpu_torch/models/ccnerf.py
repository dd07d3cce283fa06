"""CCNeRF: rank-residual grouped tensor decomposition, with compression
and scene composition after training (``ngp_tpu/models/ccnerf.py``; the
reference's tensoRF/network_cc.py).

- The density and colour fields are sums over K rank GROUPS of CP terms
  (the product of three line factors U_vec [r, H], mixed by S_vec [out, r])
  and triple-plane terms (the product of three plane factors U_mat
  [r, H, W] at the three axis-pair projections, mixed by S_mat [out, r]),
  sampled with ``align_corners=False`` (``ops/interp.py``).
- The colour output has 3 * degree^2 channels; rgb = sigmoid(<feats,
  SH(d)>), with no MLP.
- Rank-residual training: ``sigma_rgb(..., residual=True)`` returns the
  cumulative outputs of the first 1..K groups, [K, N, ...], and the
  trainer averages the loss over K, so every rank prefix is a model.
- ``finalize`` sorts each group's ranks by importance and fuses the
  groups; ``compress`` keeps the leading ranks; ``compose`` builds a scene
  of several finalized models with per-object rigid transforms, summed
  sigma and a softmax(sigma)-weighted blend of the colour logits.

The parameters are ``nn.Parameter``s named ``<kind>_<group>_U<i>`` and
``<kind>_<group>_S`` (kind: vec_density, mat_density, vec, mat), so the
trainer's optimizer, EMA and checkpoints take them; ``params()`` gives
them as the JAX package's tree ({kind: [{"U": [3 factors], "S": S}]}), and
the post-training operations take such a tree and return a new one,
which ``load_params`` installs. The factors U are held cell-major
(``ops/interp.py:cell_major``), the layout the taps kernels read:
``load_params`` installs them so, and ``compose`` keeps its objects' so.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ngp_tpu_torch.models.tensorf import MAT_IDS, VEC_IDS
from ngp_tpu_torch.ops.activation import trunc_exp
from ngp_tpu_torch.ops.interp import cell_major, sample_1d, sample_2d
from ngp_tpu_torch.ops.sh import sh_encode

KINDS = (("vec_density", False), ("mat_density", True), ("vec", False), ("mat", True))

Tree = Dict[str, List[Dict]]


@dataclasses.dataclass(frozen=True)
class CCNeRFConfig:
    resolution: Tuple[int, int, int] = (128, 128, 128)
    degree: int = 4
    # cumulative ranks per group (network_cc.py:21-24)
    rank_vec_density: Tuple[int, ...] = (64, 64, 64, 64, 64)
    rank_mat_density: Tuple[int, ...] = (0, 4, 8, 12, 16)
    rank_vec: Tuple[int, ...] = (64, 64, 64, 64, 64)
    rank_mat: Tuple[int, ...] = (0, 4, 16, 32, 64)

    @property
    def K(self) -> int:
        return len(self.rank_vec)

    @property
    def out_dim(self) -> int:
        return 3 * self.degree**2

    def group_sizes(self, cumulative: Sequence[int]) -> List[int]:
        return np.diff(np.asarray(cumulative), prepend=0).tolist()

    def cumulative(self, kind: str) -> Tuple[int, ...]:
        return {"vec_density": self.rank_vec_density, "mat_density": self.rank_mat_density,
                "vec": self.rank_vec, "mat": self.rank_mat}[kind]


def init_ccnerf(cfg: CCNeRFConfig, generator: torch.Generator, device="cuda") -> Tree:
    """The parameter tree: per kind, per non-empty group, three factors
    (0.2 N(0, 1)) and S of Kaiming scale (sqrt(2 / r) N(0, 1)), drawn in
    the JAX init's order from a CPU generator."""
    out = {}
    for kind, is_mat in KINDS:
        out_dim = 1 if kind.endswith("density") else cfg.out_dim
        groups = []
        for g in cfg.group_sizes(cfg.cumulative(kind)):
            if g <= 0:
                continue
            U = []
            for i in range(3):
                if is_mat:
                    m0, m1 = MAT_IDS[i]
                    shape = (g, cfg.resolution[m1], cfg.resolution[m0])
                else:
                    shape = (g, cfg.resolution[VEC_IDS[i]])
                U.append((0.2 * torch.randn(shape, generator=generator)).to(device))
            S = math.sqrt(2.0 / g) * torch.randn((out_dim, g), generator=generator)
            groups.append({"U": U, "S": S.to(device)})
        out[kind] = groups
    return out


def _with_slots(cfg: CCNeRFConfig, params: Tree) -> Dict[str, Dict]:
    """Per kind, the groups and the K slot each one fills (empty groups
    were skipped at init but still hold a slot)."""
    out = {}
    for kind, _ in KINDS:
        sizes = cfg.group_sizes(cfg.cumulative(kind))
        slots = [k for k, g in enumerate(sizes) if g > 0]
        out[kind] = {"groups": params[kind], "slots": slots[: len(params[kind])]}
    return out


def _group_features(group: Dict, xn: torch.Tensor, is_mat: bool) -> torch.Tensor:
    """[out, N] contribution of one rank group at normalised coords."""
    feat = None
    for i in range(3):
        if is_mat:
            m0, m1 = MAT_IDS[i]
            f = sample_2d(group["U"][i], torch.stack([xn[:, m0], xn[:, m1]], dim=-1),
                          align_corners=False)
        else:
            f = sample_1d(group["U"][i], xn[:, VEC_IDS[i]], align_corners=False)
        feat = f if feat is None else feat * f
    return group["S"] @ feat


def _features(kind_vec: Dict, kind_mat: Dict, xn: torch.Tensor, K: int, residual: bool):
    """Cumulative per-group outputs: [K, N, out] when residual, else the
    last [N, out]. A slot with no group adds zero."""
    outputs = []
    last = None
    iv = im = 0
    for k in range(K):
        y = None
        if iv < len(kind_vec["slots"]) and kind_vec["slots"][iv] == k:
            y = _group_features(kind_vec["groups"][iv], xn, False)
            iv += 1
        if im < len(kind_mat["slots"]) and kind_mat["slots"][im] == k:
            f = _group_features(kind_mat["groups"][im], xn, True)
            y = f if y is None else y + f
            im += 1
        if y is None and last is not None:
            y = torch.zeros_like(last)
        if last is not None and y is not None:
            y = y + last
        last = y
        if residual:
            outputs.append(y)
    if residual:
        return torch.stack([o.T for o in outputs])
    return last.T


def _normalize(x: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    return 2.0 * (x - aabb[:3]) / (aabb[3:] - aabb[:3]) - 1.0


def _density_rgb_logits(cfg: CCNeRFConfig, params: Tree, x, d, aabb, K: int, residual: bool):
    """(sigma, colour logits <feats, SH(d)> or None without d) of one model."""
    p = _with_slots(cfg, params)
    xn = _normalize(x, aabb)
    fd = _features(p["vec_density"], p["mat_density"], xn, K, residual)
    sigma = trunc_exp(fd[..., 0])
    if d is None:
        return sigma, None
    fc = _features(p["vec"], p["mat"], xn, K, residual)
    enc_d = sh_encode(d, cfg.degree)
    h = fc.reshape(*fc.shape[:-1], 3, cfg.degree**2)
    return sigma, (h * enc_d[..., None, :]).sum(dim=-1)


class CCNeRF(nn.Module):
    """The model; its parameters come from a seeded CPU generator on
    ``device`` (the card unless the caller asks for another), or from
    ``load_params``."""

    def __init__(self, cfg: CCNeRFConfig, bound: float = 1.0,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.bound = bound
        self.register_buffer("aabb", torch.tensor([-bound] * 3 + [bound] * 3,
                                                  dtype=torch.float32, device=device),
                             persistent=False)
        self.finalized = cfg.K == 1
        # compose: [(params, T 4x4 or None, R 3x3 or None, aabb, cfg)]
        self.objects: Optional[List] = None
        self._names: List[str] = []
        self.load_params(init_ccnerf(cfg, generator or torch.Generator().manual_seed(0),
                                     device))

    # ---- parameters ---------------------------------------------------------

    def load_params(self, params: Tree) -> None:
        """Replace the parameters by new ``nn.Parameter``s holding the tree's
        tensors (shapes and group counts may change): the factors U
        cell-major, S contiguous."""
        for name in self._names:
            delattr(self, name)
        self._names = []
        for kind, _ in KINDS:
            for gi, g in enumerate(params[kind]):
                for i, u in enumerate(g["U"]):
                    self._put(f"{kind}_{gi}_U{i}", cell_major(self._f32(u)))
                self._put(f"{kind}_{gi}_S", self._f32(g["S"]).contiguous())

    def _f32(self, t: torch.Tensor) -> torch.Tensor:
        return t.detach().to(self.aabb.device, torch.float32)

    def _put(self, name: str, t: torch.Tensor) -> None:
        self.register_parameter(name, nn.Parameter(t))
        self._names.append(name)

    def params(self) -> Tree:
        """The parameters as the JAX package's tree (the Parameters
        themselves: autograd reaches them through it)."""
        out = {}
        for kind, _ in KINDS:
            groups, gi = [], 0
            while hasattr(self, f"{kind}_{gi}_S"):
                groups.append({"U": [getattr(self, f"{kind}_{gi}_U{i}") for i in range(3)],
                               "S": getattr(self, f"{kind}_{gi}_S")})
                gi += 1
            out[kind] = groups
        return out

    # ---- forward ------------------------------------------------------------

    def sigma_rgb(self, x: torch.Tensor, d: torch.Tensor, K: int = -1,
                  residual: bool = False):
        """x: [N, 3] world, d: [N, 3] unit dirs -> residual (sigma [K, N],
        rgb [K, N, 3]), else ([N], [N, 3])."""
        if self.objects is not None:
            shape = x.shape[:-1]
            sigma, rgb = self._compose_forward(x.reshape(-1, 3), d.reshape(-1, 3))
            return sigma.reshape(shape), rgb.reshape(*shape, 3)
        K = self.cfg.K if K <= 0 else K
        sigma, h = _density_rgb_logits(self.cfg, self.params(), x, d, self.aabb, K, residual)
        return sigma, torch.sigmoid(h)

    def density(self, x: torch.Tensor):
        """x: [..., 3] -> (sigma [...], geo = x)."""
        if self.objects is not None:
            sigma, _ = self._compose_forward(x.reshape(-1, 3), None)
            return sigma.reshape(x.shape[:-1]), x
        sigma, _ = _density_rgb_logits(self.cfg, self.params(), x.reshape(-1, 3), None,
                                       self.aabb, self.cfg.K, False)
        return sigma.reshape(x.shape[:-1]), x

    def _compose_forward(self, x: torch.Tensor, d: Optional[torch.Tensor]):
        """A composed scene: sigma summed over the objects, rgb = sigmoid of
        the softmax(sigma)-weighted sum of their colour logits
        (network_cc.py:297-335)."""
        sigmas, hs = [], []
        N = x.shape[0]
        for params, T, R, aabb, cfg in self.objects:
            xo = x
            if T is not None:
                T = torch.as_tensor(T, dtype=torch.float32, device=x.device)
                xo = (torch.cat([x, torch.ones((N, 1), device=x.device)], -1) @ T.T)[:, :3]
            do = None
            if d is not None:
                do = d if R is None else d @ torch.as_tensor(R, dtype=torch.float32,
                                                             device=x.device).T
            sigma, h = _density_rgb_logits(
                cfg, params, xo, do, torch.as_tensor(aabb, dtype=torch.float32,
                                                     device=x.device), cfg.K, False)
            sigmas.append(sigma)
            hs.append(h)
        sigma_all = sum(sigmas)
        if d is None:
            return sigma_all, None
        ws = torch.softmax(torch.stack(sigmas), dim=0)  # [O, N]
        return sigma_all, torch.sigmoid(sum(h * w[:, None] for h, w in zip(hs, ws)))

    # ---- after training -------------------------------------------------------

    def finalize(self, params: Tree) -> Tree:
        """Sort each group's ranks by importance (|S| summed over outputs
        times each factor's norm, in numpy as JAX does) and fuse the groups
        (network_cc.py:463-516); the model becomes single-group."""
        new, ranks = {}, {}
        for kind, _ in KINDS:
            groups = params[kind]
            if not groups:
                new[kind], ranks[kind] = [], 0
                continue
            sorted_groups = []
            for g in groups:
                S = g["S"].detach()
                U = [u.detach() for u in g["U"]]
                importance = np.abs(S.cpu().numpy()).sum(0)
                for u in U:
                    importance = importance * np.linalg.norm(
                        u.cpu().contiguous().numpy().reshape(len(importance), -1), axis=-1)
                order = torch.as_tensor(np.argsort(-importance), device=S.device)
                sorted_groups.append({"U": [u[order] for u in U], "S": S[:, order]})
            fused = {"U": [torch.cat([g["U"][i] for g in sorted_groups]) for i in range(3)],
                     "S": torch.cat([g["S"] for g in sorted_groups], dim=1)}
            new[kind], ranks[kind] = [fused], fused["S"].shape[1]
        self.cfg = dataclasses.replace(
            self.cfg, rank_vec_density=(ranks["vec_density"],),
            rank_mat_density=(ranks["mat_density"],), rank_vec=(ranks["vec"],),
            rank_mat=(ranks["mat"],))
        self.finalized = True
        return new

    def compress(self, params: Tree, ranks: Tuple[int, int, int, int]) -> Tree:
        """The leading (density vec, density mat, colour vec, colour mat)
        ranks of a finalized tree (network_cc.py:518-549)."""
        if not self.finalized:
            params = self.finalize(params)
        new = {}
        for (kind, _), r in zip(KINDS, ranks):
            if r == 0 or not params[kind]:
                new[kind] = []
                continue
            g = params[kind][0]
            new[kind] = [{"U": [u[:r] for u in g["U"]], "S": g["S"][:, :r]}]
        self.cfg = dataclasses.replace(
            self.cfg, rank_vec_density=(ranks[0],), rank_mat_density=(ranks[1],),
            rank_vec=(ranks[2],), rank_mat=(ranks[3],))
        return new

    def compose(self, models_params, transforms=None) -> "CCNeRF":
        """A scene of several models: ``models_params`` [(model, params)],
        ``transforms`` per object (T 4x4, R 3x3) world -> object maps or
        None (network_cc.py:551-625)."""
        self.objects = []
        for idx, (model, params) in enumerate(models_params):
            if not model.finalized:
                params = model.finalize(params)
            T = R = None
            if transforms is not None and transforms[idx] is not None:
                T, R = transforms[idx]
            params = {kind: [{"U": [cell_major(u) for u in g["U"]], "S": g["S"]}
                             for g in params[kind]] for kind, _ in KINDS}
            self.objects.append((params, T, R, model.aabb, model.cfg))
        return self


def params_from_jax(tree, device="cpu") -> Tree:
    """The JAX model's list-of-groups tree (numpy arrays) -> the port's tree
    of f32 tensors on ``device``, for ``CCNeRF.load_params``."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return {kind: [{"U": [t(u) for u in g["U"]], "S": t(g["S"])} for g in tree[kind]]
            for kind, _ in KINDS}
