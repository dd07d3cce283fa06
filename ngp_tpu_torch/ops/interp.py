"""Bilinear sampling and resizing with explicit corner conventions
(``ngp_tpu/ops/interp.py``), for the TensoRF family. ``FactorTaps`` runs
the taps' forward by the kernel ``sample_taps_fwd`` on the card
(``ops/kernels/scatter.py``; its plain version, one ``index_select`` +
``where`` + ``mul`` + ``add`` per tap, on the CPU), their gradient in the
factor by the kernel ``scatter_add_taps`` (its plain version, one
``index_add_`` per tap, on the CPU), and their gradient in the points by
autograd of the plain forward (no path asks for it; each such call counts
under ``LAUNCHES["taps_coords_grad_plain"]``). The JAX package leaves all
of it to XLA (no Pallas kernel). A TensoRF step pads its unused sample
slots at one point, so the taps of many consecutive samples hit one cell:
the gradient kernel sums such runs before it adds.
``chip_smoke.py:tap_forms`` times the taps' forms on the card.

The factors are held cell-major (``cell_major``: memory [D, R] or [H, W,
R], seen in JAX's shape [R, D] / [R, H, W]), the layout both kernels
read: the models make their factor parameters so, and ``FactorTaps``
passes the factor on as it is and makes the factor's gradient with the
factor's strides, so that autograd takes it without a copy.

- ``align_corners=True``: u in [-1, 1] maps to pixel centres 0 .. W-1,
  (u + 1) / 2 * (W - 1) (``grid_sample``'s convention);
- ``align_corners=False``: (u + 1) / 2 * W - 0.5;
- zero outside the grid (``grid_sample``'s ``padding_mode="zeros"``).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ngp_tpu_torch.ops.kernels import LAUNCHES, scatter
from ngp_tpu_torch.ops.kernels.scatter import cell_major  # noqa: F401


class FactorTaps(torch.autograd.Function):
    """The taps' lerp, factor [R, D] and coords [N], or [R, H, W] and
    [N, 2] -> [R, N], by ``scatter.sample_taps_fwd`` (on the card the
    factor must be cell-major), with its gradients: in the factor by
    ``scatter.scatter_add_taps`` into a zeroed f32 factor of the factor's
    strides, in the points by autograd of ``scatter.sample_taps_plain`` in
    the points alone, each only where autograd asks for it."""

    @staticmethod
    def forward(ctx, factor, coords, align_corners):
        ctx.save_for_backward(factor, coords)
        ctx.align_corners = align_corners
        return scatter.sample_taps_fwd(factor, coords, align_corners)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        factor, coords = ctx.saved_tensors
        d_factor = d_coords = None
        if ctx.needs_input_grad[0]:
            d_factor = torch.zeros_like(factor, dtype=torch.float32,
                                        memory_format=torch.preserve_format)
            scatter.scatter_add_taps(g.float().contiguous(), coords.float(), d_factor,
                                     ctx.align_corners)
            d_factor = d_factor.to(factor.dtype)
        if ctx.needs_input_grad[1]:
            LAUNCHES["taps_coords_grad_plain"] += 1
            with torch.enable_grad():
                c = coords.detach().requires_grad_()
                (d_coords,) = torch.autograd.grad(
                    scatter.sample_taps_plain(factor.detach(), c, ctx.align_corners), c, g)
        return d_factor, d_coords, None


def sample_1d(line: torch.Tensor, u: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """line: [R, D]; u: [N] in [-1, 1] -> [R, N] (zero outside)."""
    return FactorTaps.apply(line, u, align_corners)


def sample_2d(plane: torch.Tensor, uv: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """plane: [R, H, W]; uv: [N, 2] with uv[:, 0] = u on the W axis and
    uv[:, 1] = v on the H axis (``grid_sample``'s order) -> [R, N]."""
    return FactorTaps.apply(plane, uv, align_corners)


def _fma_f32(p: np.ndarray, q: np.ndarray, c: np.ndarray) -> np.ndarray:
    """p * q + c for f32 arrays, rounded to f32 once (a fused multiply-add):
    the f64 sum of the exact product (24 + 24 bits) and c, and its rounding
    error (Knuth's two-sum), which decides the one case where rounding to
    f64 and then to f32 is not rounding once (an f64 sum exactly halfway
    between two f32 values)."""
    prod = p.astype(np.float64) * q.astype(np.float64)
    c = c.astype(np.float64)
    s = prod + c
    bb = s - prod
    err = (prod - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.float32(np.inf), np.float32(-np.inf)))
    tie = (s != r) & (s == (r.astype(np.float64) + other.astype(np.float64)) / 2) & (err != 0)
    return np.where(tie & ((err > 0) == (other > r)), other, r)


@functools.lru_cache(maxsize=64)
def linspace_f32(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in f32 as XLA on the CPU evaluates
    it: its simplifier turns JAX's ``start * (1 - i / d) + stop * (i / d)``
    (d = num - 1) into ``start * (1 - i * r) + i * (stop * r)`` with r =
    f32(1 / d), and LLVM fuses the last product into the sum; the last
    entry is ``stop``. Equal to ``jnp.linspace`` on every lattice the port
    makes (``tests/test_torch_linspace.py``); on other lattices that start
    off 0 it can be one ulp off (XLA contracts some of those otherwise).
    Made on the host once per lattice and device (a copy to the card waits
    for the stream), so callers must not write into it."""
    f32 = np.float32
    if num == 1:
        return torch.full((1,), float(start), dtype=torch.float32, device=device)
    a, b = f32(start), f32(stop)
    i = np.arange(num - 1, dtype=f32)
    r = f32(1) / f32(num - 1)
    out = _fma_f32(i, np.full_like(i, b * r), a * (f32(1) - i * r))
    return torch.from_numpy(np.append(out, b).astype(f32)).to(device)


def resize_bilinear(img: torch.Tensor, new_hw: Sequence[int],
                    align_corners: bool = True) -> torch.Tensor:
    """img: [..., H, W] -> [..., H', W'], ``F.interpolate(mode="bilinear")``
    (TensoRF's upsample_model, tensoRF/network.py:268-272)."""
    H, W = img.shape[-2:]
    Hn, Wn = (int(n) for n in new_hw)
    dev = img.device
    if align_corners:
        ys = linspace_f32(0.0, H - 1.0, Hn, dev)
        xs = linspace_f32(0.0, W - 1.0, Wn, dev)
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
