"""Bilinear sampling and resizing with explicit corner conventions
(``ngp_tpu/ops/interp.py``), for the TensoRF family. The taps are
``index_select``s of the factor lines and planes, lerped in torch ops;
``FactorTaps`` gives their gradient in the factor by the kernel
``scatter_add_taps`` on the card (``ops/kernels/scatter.py``; its plain
version, one ``index_add_`` per tap, on the CPU), and in the points by
autograd of the same forward. The JAX package leaves both to XLA (no
Pallas kernel). A TensoRF step pads its unused sample slots at one point,
so the taps of many consecutive samples hit one cell: the kernel sums
such runs before it adds. ``chip_smoke.py:tap_forms`` times the taps'
forms on the card.

- ``align_corners=True``: u in [-1, 1] maps to pixel centres 0 .. W-1,
  (u + 1) / 2 * (W - 1) (``grid_sample``'s convention);
- ``align_corners=False``: (u + 1) / 2 * W - 0.5;
- zero outside the grid (``grid_sample``'s ``padding_mode="zeros"``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from ngp_tpu_torch.ops.kernels import scatter


def _sample(factor: torch.Tensor, coords: torch.Tensor, align_corners: bool) -> torch.Tensor:
    """The taps' lerp: factor [R, D] and coords [N], or [R, H, W] and
    [N, 2] -> [R, N]."""
    R = factor.shape[0]
    flat = factor.reshape(R, -1)
    out = None
    for idx, ok, w in scatter.factor_taps(coords, factor.shape[1:], align_corners):
        v = flat.index_select(1, idx)
        v = torch.where(ok[None, :], v, torch.zeros((), dtype=v.dtype, device=v.device))
        out = v * w[None, :] if out is None else out + v * w[None, :]
    return out


class FactorTaps(torch.autograd.Function):
    """``_sample`` with its gradients: in the factor by
    ``scatter.scatter_add_taps`` into a zeroed f32 factor, in the points by
    autograd of ``_sample`` in the points alone, each only where autograd
    asks for it."""

    @staticmethod
    def forward(ctx, factor, coords, align_corners):
        ctx.save_for_backward(factor, coords)
        ctx.align_corners = align_corners
        return _sample(factor, coords, align_corners)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        factor, coords = ctx.saved_tensors
        d_factor = d_coords = None
        if ctx.needs_input_grad[0]:
            d_factor = torch.zeros(factor.shape, dtype=torch.float32, device=factor.device)
            scatter.scatter_add_taps(g.float().contiguous(), coords.float(), d_factor,
                                     ctx.align_corners)
            d_factor = d_factor.to(factor.dtype)
        if ctx.needs_input_grad[1]:
            with torch.enable_grad():
                c = coords.detach().requires_grad_()
                (d_coords,) = torch.autograd.grad(
                    _sample(factor.detach(), c, ctx.align_corners), c, g)
        return d_factor, d_coords, None


def sample_1d(line: torch.Tensor, u: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """line: [R, D]; u: [N] in [-1, 1] -> [R, N] (zero outside)."""
    return FactorTaps.apply(line, u, align_corners)


def sample_2d(plane: torch.Tensor, uv: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """plane: [R, H, W]; uv: [N, 2] with uv[:, 0] = u on the W axis and
    uv[:, 1] = v on the H axis (``grid_sample``'s order) -> [R, N]."""
    return FactorTaps.apply(plane, uv, align_corners)


def _linspace_f32(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace`` in f32: start + i * step for i < num - 1, the last
    entry exactly ``stop``."""
    if num == 1:
        return torch.full((1,), float(start), device=device)
    step = (stop - start) / (num - 1)
    out = start + torch.arange(num, device=device, dtype=torch.float32) * torch.tensor(
        step, dtype=torch.float32, device=device)
    out[-1] = stop
    return out


def resize_bilinear(img: torch.Tensor, new_hw: Sequence[int],
                    align_corners: bool = True) -> torch.Tensor:
    """img: [..., H, W] -> [..., H', W'], ``F.interpolate(mode="bilinear")``
    (TensoRF's upsample_model, tensoRF/network.py:268-272)."""
    H, W = img.shape[-2:]
    Hn, Wn = (int(n) for n in new_hw)
    dev = img.device
    if align_corners:
        ys = _linspace_f32(0.0, H - 1.0, Hn, dev)
        xs = _linspace_f32(0.0, W - 1.0, Wn, dev)
    else:
        ys = (torch.arange(Hn, device=dev, dtype=torch.float32) + 0.5) * H / Hn - 0.5
        xs = (torch.arange(Wn, device=dev, dtype=torch.float32) + 0.5) * W / Wn - 0.5

    def interp_axis(a, coords, axis):
        size = a.shape[axis]
        c0 = torch.floor(coords).long().clamp(0, size - 1)
        c1 = (c0 + 1).clamp(0, size - 1)
        f = (coords - c0).clamp(0.0, 1.0)
        shape = [1] * a.ndim
        shape[axis] = -1
        f = f.reshape(shape)
        return a.index_select(axis, c0) * (1 - f) + a.index_select(axis, c1) * f

    out = interp_axis(img, ys, img.ndim - 2)
    return interp_axis(out, xs, out.ndim - 1)
