"""Bilinear sampling and resizing with explicit corner conventions
(``ngp_tpu/ops/interp.py``), for the TensoRF family: gathers and lerps
in torch ops, differentiable by autograd in the factors and the points.
No Pallas kernel computes these (the JAX package leaves them to XLA),
so no kernel of the port does either. The taps are ``index_select``s,
whose backward adds into the factors with ``index_add_``. Advanced
indexing's backward sorts the indices and walks each run of equal ones
in turn, and a TensoRF step pads its unused sample slots at one point:
``chip_smoke.py:tap_forms`` times both forms on the card.

- ``align_corners=True``: u in [-1, 1] maps to pixel centres 0 .. W-1,
  (u + 1) / 2 * (W - 1) (``grid_sample``'s convention);
- ``align_corners=False``: (u + 1) / 2 * W - 0.5;
- zero outside the grid (``grid_sample``'s ``padding_mode="zeros"``).
"""

from __future__ import annotations

from typing import Sequence

import torch


def _to_pixel(u: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    u = u.float()
    if align_corners:
        return (u + 1.0) / 2.0 * (size - 1)
    return (u + 1.0) / 2.0 * size - 0.5


def sample_1d(line: torch.Tensor, u: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """line: [R, D]; u: [N] in [-1, 1] -> [R, N] (zero outside)."""
    D = line.shape[-1]
    p = _to_pixel(u, D, align_corners)
    p0 = torch.floor(p)
    f = p - p0
    p0 = p0.long()

    def tap(idx):
        ok = (idx >= 0) & (idx < D)
        v = line.index_select(1, idx.clamp(0, D - 1))
        return torch.where(ok[None, :], v, torch.zeros((), dtype=v.dtype, device=v.device))

    return tap(p0) * (1.0 - f)[None, :] + tap(p0 + 1) * f[None, :]


def sample_2d(plane: torch.Tensor, uv: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """plane: [R, H, W]; uv: [N, 2] with uv[:, 0] = u on the W axis and
    uv[:, 1] = v on the H axis (``grid_sample``'s order) -> [R, N]."""
    R, H, W = plane.shape
    px = _to_pixel(uv[:, 0], W, align_corners)
    py = _to_pixel(uv[:, 1], H, align_corners)
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    x0, y0 = x0.long(), y0.long()
    flat = plane.reshape(R, H * W)

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = flat.index_select(1, yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
        return torch.where(ok[None, :], v, torch.zeros((), dtype=v.dtype, device=v.device))

    return (tap(y0, x0) * ((1 - fx) * (1 - fy))[None, :]
            + tap(y0, x0 + 1) * (fx * (1 - fy))[None, :]
            + tap(y0 + 1, x0) * ((1 - fx) * fy)[None, :]
            + tap(y0 + 1, x0 + 1) * (fx * fy)[None, :])


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
