"""The march lattice: step sizes, probe counts, mip levels, cells and
t-bits keys, and the eval prepass's probe spacing and count
(``ngp_tpu/models/occupancy.py``).

Shared by ``models/occupancy.py`` (which re-exports every name) and the
plain versions of the turbo march and the prepass in
``ops/kernels/march.py``, which must not import the models package.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from ngp_tpu_torch.config import RenderConfig

SQRT3 = math.sqrt(3.0)
COARSE_FACTOR = 4  # fine cells per coarse cell per axis
# t-bits keys: positive-f32 bit patterns are monotone in t; real t's
# bits stay below _TKEY_THRESH (bits of 2^33), invalid probes add
# _TKEY_INVALID without int32 overflow
_TKEY_INVALID = 0x20000000
_TKEY_THRESH = 0x50000000


def dt_bounds(cfg: RenderConfig) -> Tuple[float, float]:
    """(dt_min, dt_max) of the adaptive step clamp."""
    dt_min = 2.0 * SQRT3 / cfg.max_steps
    dt_max = 2.0 * SQRT3 * (2 ** (cfg.cascades - 1)) / cfg.grid_size
    return dt_min, dt_max


@functools.lru_cache(maxsize=None)
def _adaptive_probe_count(dt_gamma: float, dt_min: float, dt_max: float,
                          t0: float, span: float) -> int:
    cap = int(math.ceil(span / dt_min)) + 2
    t, k = t0, 0
    end = t0 + span
    while t < end and k < cap:
        t += min(max(t * dt_gamma, dt_min), dt_max)
        k += 1
    return max(k + 2, 2)


def lattice_probes(cfg: RenderConfig) -> int:
    """Probe count K of the march lattice (a function of the config)."""
    span = cfg.lattice_span
    dt_min, dt_max = dt_bounds(cfg)
    if cfg.dt_gamma == 0.0:
        if span is None:
            return int(math.ceil(cfg.max_steps * max(1.0, cfg.bound)))
        return max(int(math.ceil(span / dt_min)) + 2, 2)
    return _adaptive_probe_count(
        cfg.dt_gamma, dt_min, dt_max, cfg.min_near,
        2.0 * SQRT3 * cfg.bound if span is None else span,
    )


def prepass_spacing(cfg: RenderConfig) -> float:
    """Prepass probe spacing: one cascade-0 coarse cell."""
    return 2.0 * min(1.0, cfg.bound) / (cfg.grid_size // COARSE_FACTOR)


def prepass_probes(cfg: RenderConfig) -> int:
    """Probe count of the prepass lattice: the marched span at
    ``prepass_spacing``, plus the half-step slack."""
    h = prepass_spacing(cfg)
    span = 2.0 * SQRT3 * cfg.bound if cfg.lattice_span is None else cfg.lattice_span
    return max(int(math.ceil(span / h)) + 2, 2)


def _frexp_exponent(x: torch.Tensor) -> torch.Tensor:
    return (torch.floor(torch.log2(torch.clamp(x, min=1e-30))) + 1).to(torch.int32)


def mip_from_pos(x: torch.Tensor, cascades: int) -> torch.Tensor:
    mx = x.abs().amax(dim=-1)
    return torch.clamp(_frexp_exponent(mx), 0, cascades - 1)


def mip_from_dt(dt: torch.Tensor, grid_size: int, cascades: int) -> torch.Tensor:
    return torch.clamp(_frexp_exponent(dt * grid_size * 0.5), 0, cascades - 1)


def t_lattice(nears: torch.Tensor, fars: torch.Tensor, cfg: RenderConfig,
              noise: Optional[torch.Tensor] = None):
    """The march lattice, [N, K] t values and step sizes; ``noise`` [N]
    in [0, 1) perturbs each ray's start by that fraction of a step."""
    dt_min, dt_max = dt_bounds(cfg)

    def dt_of(t):
        return torch.clamp(t * cfg.dt_gamma, dt_min, dt_max)

    t0 = nears
    if noise is not None:
        t0 = t0 + dt_of(t0) * noise
    K = lattice_probes(cfg)
    if cfg.dt_gamma == 0.0:
        ks = torch.arange(K, dtype=torch.float32, device=nears.device)
        ts = t0[:, None] + ks[None, :] * dt_min
        return ts, torch.full_like(ts, dt_min)
    ts, dts = [], []
    t = t0
    for _ in range(K):
        d = dt_of(t)
        ts.append(t)
        dts.append(d)
        t = t + d
    return torch.stack(ts, dim=1), torch.stack(dts, dim=1)


def _cells(x: torch.Tensor, dts: torch.Tensor, cfg: RenderConfig, level=None):
    """Fine cell coords [..., 3] and flat coarse id of clipped world
    points at their mip level (given, or from position and step)."""
    H, cas = cfg.grid_size, cfg.cascades
    Hc = H // COARSE_FACTOR
    if level is None:
        level = torch.maximum(mip_from_pos(x, cas), mip_from_dt(dts, H, cas))
    mip_bound = torch.clamp(2.0 ** level.float(), max=cfg.bound)
    n = torch.clamp((0.5 * (x / mip_bound[..., None] + 1.0) * H).to(torch.int32), 0, H - 1)
    c = n // COARSE_FACTOR
    flat = ((level * Hc + c[..., 0]) * Hc + c[..., 1]) * Hc + c[..., 2]
    return n, flat.to(torch.int32)


def _points(rays_o, rays_d, ts, bound):
    x = rays_o[:, None, :] + rays_d[:, None, :] * ts[..., None]
    return torch.clamp(x, -bound, bound)


def _tbits(ts: torch.Tensor) -> torch.Tensor:
    return ts.contiguous().view(torch.int32)


def _ascending(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest int32 keys of each row, ascending."""
    return -torch.topk(-keys, k, dim=1).values
