"""Volume rendering without the occupancy grid (``ngp_tpu/models/renderer.py``):
a uniform lattice of ``num_steps`` samples in [near, far], optionally
jittered, optionally ``upsample_steps`` more drawn from the coarse
weights by inverse-CDF sampling (``sample_pdf``), and front-to-back
compositing over the whole [N, T] lattice (``composite``). Gradients are
autograd's, as JAX's are ``jax.grad`` of the same function.

The random draws (the perturbation noise [N, T] and the PDF draws
[N, U]) come from ``noise`` and ``pdf_u`` when given (a test feeds the
numbers ``jax.random`` drew), else from ``generator``. The deterministic
lattices follow ``jnp.linspace``'s arithmetic (``_linspace``), and the
merge of the PDF samples sorts stably, as ``jnp.argsort`` does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ngp_tpu_torch.config import RenderConfig
from ngp_tpu_torch.ops.rays import near_far_from_aabb, sph_from_ray


def _linspace(start: float, stop: float, n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, n)`` in f32 as XLA evaluates it:
    step = i * (1 / (n - 1)), start * (1 - step) + stop * step, the last
    entry ``stop`` itself (``torch.linspace`` rounds some entries another
    way)."""
    if n == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    a = torch.tensor(start, dtype=torch.float32, device=device)
    b = torch.tensor(stop, dtype=torch.float32, device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) * (
        1.0 / torch.tensor(float(n - 1), dtype=torch.float32, device=device))
    return torch.cat([a * (1.0 - step) + b * step, b[None]])


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_samples`` new z-values per ray.

    bins [B, T] (z midpoints), weights [B, T - 1]; ``u`` [B, n_samples]
    uniform draws, or None for the deterministic midpoint lattice."""
    weights = weights.float() + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [B, T]
    if u is None:
        u = _linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples, cdf.device)
        u = u.expand(*cdf.shape[:-1], n_samples)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def composite(sigmas: torch.Tensor, rgbs: torch.Tensor, deltas: torch.Tensor,
              density_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """Front-to-back alpha compositing over the sample axis: sigmas
    [N, T], rgbs [N, T, 3], deltas [N, T] -> weights [N, T], weights_sum
    [N], image [N, 3]; alpha = 1 - exp(-sigma * delta * scale), the
    transmittance the exclusive product of (1 - alpha + 1e-15)."""
    sigmas = sigmas.float()
    alphas = 1.0 - torch.exp(-deltas * density_scale * sigmas)
    shifted = torch.cat([torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-15], dim=-1)
    transmittance = torch.cumprod(shifted, dim=-1)[..., :-1]
    weights = alphas * transmittance
    return {"weights": weights, "weights_sum": weights.sum(dim=-1),
            "image": (weights[..., None] * rgbs.float()).sum(dim=-2)}


def background(rays_o: torch.Tensor, rays_d: torch.Tensor, cfg: RenderConfig, bg_color=None,
               bg_fn: Optional[Callable] = None):
    """What a ray sees behind the scene, for every renderer: the background
    net at the ray's exit point on the sphere of radius ``bg_radius`` when
    there is one, else ``bg_color`` (1, white, when None)."""
    if bg_fn is not None and cfg.bg_radius > 0:
        return bg_fn(sph_from_ray(rays_o, rays_d, cfg.bg_radius), rays_d)
    return 1.0 if bg_color is None else bg_color


def render_rays(density_fn: Callable, color_fn: Callable, rays_o: torch.Tensor,
                rays_d: torch.Tensor, cfg: RenderConfig, perturb: bool = False,
                bg_color=None, bg_fn: Optional[Callable] = None, aabb=None,
                num_steps: Optional[int] = None, upsample_steps: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                pdf_u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Uniform + PDF-upsampled volume rendering of a ray batch.

    density_fn: [..., 3] -> (sigma [...], geo [..., G]); color_fn: (dirs
    [..., 3], geo) -> rgb [..., 3]; rays [N, 3] with unit directions.
    ``perturb`` (training) jitters each sample by up to half a step and
    draws the PDF samples at random; without it both are deterministic.
    ``bg_fn(sph [N, 2], dirs [N, 3]) -> [N, 3]`` (``bg_radius > 0``)
    replaces ``bg_color`` (default 1, white).

    Returns image [N, 3], depth [N] (normalised within [near, far]),
    weights_sum [N], and the per-sample weights, z_vals (also as "ts")
    and deltas that the distortion term reads."""
    T = num_steps or cfg.num_steps
    U = cfg.upsample_steps if upsample_steps is None else upsample_steps
    N = rays_o.shape[0]
    dev = rays_o.device
    aabb = torch.as_tensor(cfg.aabb if aabb is None else aabb, dtype=torch.float32, device=dev)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)
    # rays that miss (or leave behind the origin) get an empty interval
    fars = torch.where(fars > nears, fars, nears)

    z = _linspace(0.0, 1.0, T, dev)
    z_vals = nears[:, None] + (fars - nears)[:, None] * z[None, :]  # [N, T]
    sample_dist = (fars - nears) / T
    if perturb:
        if noise is None:
            noise = torch.rand((N, T), generator=generator, device=dev)
        z_vals = z_vals + (noise.to(dev) - 0.5) * sample_dist[:, None]

    lo, hi = aabb[:3], aabb[3:]

    def pts(zv):
        return torch.clamp(rays_o[:, None, :] + rays_d[:, None, :] * zv[..., None], lo, hi)

    xyzs = pts(z_vals)
    sigmas, geo = density_fn(xyzs)  # [N, T], [N, T, G]

    if U > 0:
        # importance-sample new z from the coarse weights
        deltas = torch.cat([torch.diff(z_vals, dim=-1), sample_dist[:, None]], dim=-1)
        coarse = composite(sigmas.detach(), torch.zeros((N, T, 3), device=dev), deltas,
                           cfg.density_scale)
        z_mid = z_vals[..., :-1] + 0.5 * deltas[..., :-1]
        if perturb and pdf_u is None:
            pdf_u = torch.rand((N, U), generator=generator, device=dev)
        new_z = sample_pdf(z_mid, coarse["weights"][:, 1:-1], U,
                           pdf_u.to(dev) if perturb else None).detach()
        new_xyzs = pts(new_z)
        new_sigmas, new_geo = density_fn(new_xyzs)
        z_vals = torch.cat([z_vals, new_z], dim=-1)
        z_vals, order = torch.sort(z_vals, dim=-1, stable=True)
        sigmas = torch.gather(torch.cat([sigmas, new_sigmas], dim=-1), -1, order)
        o3 = order[..., None]
        geo = torch.gather(torch.cat([geo, new_geo], dim=-2), -2,
                           o3.expand(-1, -1, geo.shape[-1]))
        xyzs = torch.gather(torch.cat([xyzs, new_xyzs], dim=-2), -2, o3.expand(-1, -1, 3))

    deltas = torch.cat([torch.diff(z_vals, dim=-1), sample_dist[:, None]], dim=-1)
    dirs = rays_d[:, None, :].expand(xyzs.shape)
    rgbs = color_fn(dirs, geo)
    out = composite(sigmas, rgbs, deltas, cfg.density_scale)
    weights, weights_sum = out["weights"], out["weights_sum"]

    span = torch.clamp(fars - nears, min=1e-10)
    ori_z = torch.clamp((z_vals - nears[:, None]) / span[:, None], 0.0, 1.0)
    depth = (weights * ori_z).sum(dim=-1)

    image = out["image"] + (1.0 - weights_sum)[..., None] * background(
        rays_o, rays_d, cfg, bg_color, bg_fn)
    return {"image": image, "depth": depth, "weights_sum": weights_sum, "weights": weights,
            "z_vals": z_vals, "ts": z_vals, "deltas": deltas}
