"""The scatter-adds' plain versions and the autograd functions around them
(``ops/kernels/scatter.py``: ``scatter_add_taps_plain``, ``GatherRows``;
``ops/interp.py``: ``FactorTaps``) against the JAX package's VJPs, on the
CPU: the factor taps' gradient against ``jax.vjp`` of
``ngp_tpu.ops.interp.sample_1d`` / ``sample_2d`` in the factor (both
corner conventions, points outside [-1, 1], narrow and wide ranks, a
block of padded slots at one point, points on exact cell edges),
``FactorTaps``'s values against the taps' formulation before it (bit for
bit) and its gradients against JAX's, and the brick grid's table
gradient through ``GatherRows`` against ``jax.vjp`` of
``ngp_tpu.ops.brickgrid.brick_encode`` with many points in one brick and
points outside the box.

Tolerances. The gradients sum the same f32 products in another order:
1e-4 of the largest entry, as ``test_torch_tensorf.py:_vjp_check``
holds the taps. On cell edges the gradient's support (the entries that
are not zero) must equal JAX's exactly: a sample whose pixel coordinate
rounds to the other side of an edge adds a weight of a few ulps into a
cell the forward did not read, which no tolerance of the values shows.
The brick grid's table gradient in f32: 1e-5 of the largest entry, as
``test_torch_brickgrid.py`` holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.ops import brickgrid as jbg
from ngp_tpu.ops import interp as ji
from ngp_tpu_torch.ops import brickgrid as tbg
from ngp_tpu_torch.ops import interp as ti
from ngp_tpu_torch.ops.kernels import scatter as ks
from test_torch_train_step import _scaled


def _today_1d(line, u, align_corners):
    """``sample_1d`` as the port wrote it before ``FactorTaps``."""
    D = line.shape[-1]
    p = ks._to_pixel(u, D, align_corners)
    p0 = torch.floor(p)
    f = p - p0
    p0 = p0.long()

    def tap(idx):
        ok = (idx >= 0) & (idx < D)
        v = line.index_select(1, idx.clamp(0, D - 1))
        return torch.where(ok[None, :], v, torch.zeros((), dtype=v.dtype))

    return tap(p0) * (1.0 - f)[None, :] + tap(p0 + 1) * f[None, :]


def _today_2d(plane, uv, align_corners):
    """``sample_2d`` as the port wrote it before ``FactorTaps``."""
    R, H, W = plane.shape
    px = ks._to_pixel(uv[:, 0], W, align_corners)
    py = ks._to_pixel(uv[:, 1], H, align_corners)
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    x0, y0 = x0.long(), y0.long()
    flat = plane.reshape(R, H * W)

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = flat.index_select(1, yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
        return torch.where(ok[None, :], v, torch.zeros((), dtype=v.dtype))

    return (tap(y0, x0) * ((1 - fx) * (1 - fy))[None, :]
            + tap(y0, x0 + 1) * (fx * (1 - fy))[None, :]
            + tap(y0 + 1, x0) * ((1 - fx) * fy)[None, :]
            + tap(y0 + 1, x0 + 1) * (fx * fy)[None, :])


def _points(n, dims, seed, padded=0):
    """n points in [-1.2, 1.2]^dims (some outside the grid), a ray's
    samples (consecutive points a little apart), and the last ``padded``
    slots all at the first point, as the compaction pads a step."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1.2, 1.2, size=(n, dims)).astype(np.float32)
    k = n // 4
    start = rng.uniform(-0.9, 0.9, size=(1, dims))
    u[k:2 * k] = (start + 0.013 * np.arange(k)[:, None] * rng.uniform(0.2, 1.0, (1, dims)))
    if padded:
        u[n - padded:] = u[0]
    return u[:, 0].copy() if dims == 1 else u


def _edge_points(size, dims, align_corners):
    """Points whose pixel coordinate is a cell edge in real arithmetic:
    each edge's f32 value and its neighbours 1 and 2 ulps away."""
    k = np.arange(-1, size + 1, dtype=np.float64)
    u = (k / (size - 1) * 2 - 1) if align_corners else ((2 * k + 1) / size - 1)
    u = u.astype(np.float32)
    near = [u]
    for steps in (1, 2):
        for direction in (np.inf, -np.inf):
            v = u.copy()
            for _ in range(steps):
                v = np.nextafter(v, np.float32(direction))
            near.append(v)
    u = np.concatenate(near)
    if dims == 1:
        return u
    rng = np.random.default_rng(size)
    return np.stack([u, rng.permutation(u)], axis=-1)


def _factor(R, grid, seed):
    return np.random.default_rng(seed).normal(size=(R, *grid)).astype(np.float32)


def _jax_vjp(factor, coords, cot, align_corners):
    fn = ji.sample_1d if factor.ndim == 2 else ji.sample_2d
    out, vjp = jax.vjp(lambda f, c: fn(f, c, align_corners), jnp.asarray(factor),
                       jnp.asarray(coords))
    d_factor, d_coords = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(d_factor), np.asarray(d_coords)


CASES = [  # (R, grid, N, padded slots)
    (4, (13,), 300, 0), (48, (29,), 512, 150), (4, (7, 11), 300, 0), (48, (12, 9), 512, 150),
    (1, (5,), 64, 40), (7, (3, 2), 200, 64),
]


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("R,grid,N,padded", CASES)
def test_scatter_add_taps_plain_matches_jax_vjp(R, grid, N, padded, align_corners):
    factor = _factor(R, grid, R + N)
    coords = _points(N, len(grid), N + padded, padded)
    cot = np.random.default_rng(9).normal(size=(R, N)).astype(np.float32)
    _, want, _ = _jax_vjp(factor, coords, cot, align_corners)
    got = ks.scatter_add_taps_plain(torch.from_numpy(cot), torch.from_numpy(coords),
                                    torch.zeros((R, *grid)), align_corners)
    assert got.shape == want.shape
    _scaled(got, want, 1e-4)
    assert float(got.abs().max()) > 0


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("R,grid,N,padded", CASES)
def test_factor_taps_values_are_the_former_taps_bit_for_bit(R, grid, N, padded, align_corners):
    factor = torch.from_numpy(_factor(R, grid, 3))
    coords = torch.from_numpy(_points(N, len(grid), 4, padded))
    if len(grid) == 1:
        want = _today_1d(factor, coords, align_corners)
        got = ti.sample_1d(factor.requires_grad_(), coords, align_corners)
    else:
        want = _today_2d(factor, coords, align_corners)
        got = ti.sample_2d(factor.requires_grad_(), coords, align_corners)
    assert got.requires_grad and torch.equal(got.detach(), want)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("R,grid,N,padded", CASES)
def test_factor_taps_gradients_match_jax(R, grid, N, padded, align_corners):
    factor = _factor(R, grid, 5)
    coords = _points(N, len(grid), 6, padded)
    cot = np.random.default_rng(7).normal(size=(R, N)).astype(np.float32)
    want, d_factor, d_coords = _jax_vjp(factor, coords, cot, align_corners)
    f = torch.from_numpy(factor).requires_grad_()
    c = torch.from_numpy(coords).requires_grad_()
    got = ti.FactorTaps.apply(f, c, align_corners)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    got.backward(torch.from_numpy(cot))
    _scaled(f.grad, d_factor, 1e-4)
    _scaled(c.grad, d_coords, 1e-4)
    # the factor alone, and the points alone
    f2 = torch.from_numpy(factor).requires_grad_()
    (ti.FactorTaps.apply(f2, torch.from_numpy(coords), align_corners)
     * torch.from_numpy(cot)).sum().backward()
    assert torch.equal(f2.grad, f.grad)
    c2 = torch.from_numpy(coords).requires_grad_()
    (ti.FactorTaps.apply(torch.from_numpy(factor), c2, align_corners)
     * torch.from_numpy(cot)).sum().backward()
    assert torch.equal(c2.grad, c.grad)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("grid", [(16,), (152,), (128,), (9, 16), (128, 128)])
def test_taps_on_cell_edges_match_jax(grid, align_corners):
    coords = _edge_points(grid[-1], len(grid), align_corners)
    R, N = 3, coords.shape[0]
    factor = _factor(R, grid, 11)
    cot = np.random.default_rng(12).normal(size=(R, N)).astype(np.float32)
    want, d_factor, _ = _jax_vjp(factor, coords, cot, align_corners)
    f = torch.from_numpy(factor).requires_grad_()
    got = ti.FactorTaps.apply(f, torch.from_numpy(coords), align_corners)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(f.grad.numpy() != 0, d_factor != 0)
    _scaled(f.grad, d_factor, 1e-4)
    # each cell the taps name is one the forward read: the taps' cells
    # with a non-zero weight equal the cells that received a gradient
    taps = ks.factor_taps(torch.from_numpy(coords), grid, align_corners)
    read = torch.zeros(int(np.prod(grid)), dtype=torch.bool)
    for idx, ok, w in taps:
        read[idx[ok & (w != 0)]] = True
    assert torch.equal(read, (f.grad.reshape(R, -1) != 0).any(dim=0))


def _cluster_points(n, seed):
    """Many points in one brick of each level (a tight cluster), a ray's
    samples through it, and a quarter of the points outside the box."""
    rng = np.random.default_rng(seed)
    x = np.empty((n, 3), np.float32)
    q = n // 4
    x[:q] = 0.4321 + rng.uniform(-1e-3, 1e-3, (q, 3))
    t = np.linspace(0.0, 0.8, q, dtype=np.float32)[:, None]
    x[q:2 * q] = 0.1 + t * np.array([0.6, 0.5, 0.7], np.float32)
    x[2 * q:3 * q] = rng.uniform(0.0, 1.0, (q, 3))
    x[3 * q:] = rng.uniform(-0.3, 1.3, (n - 3 * q, 3))
    x[3 * q:, 0] = rng.choice([-0.1, 1.1], n - 3 * q)
    return x


@pytest.mark.parametrize("name", ["small", "preset_cut"])
def test_brick_table_gradient_through_gather_rows_matches_jax(name, monkeypatch):
    configs = {"small": dict(num_levels=4, level_dim=2, base_resolution=4, per_level_scale=2.3,
                             log2_hashmap_size=9),
               "preset_cut": dict(num_levels=8, level_dim=4, base_resolution=16,
                                  log2_hashmap_size=12, desired_resolution=4096)}
    a, b = jbg.BrickGridConfig(**configs[name]), tbg.BrickGridConfig(**configs[name])
    rng = np.random.default_rng(3)
    table = rng.normal(size=(a.num_rows, a.row_width)).astype(np.float32)
    x = _cluster_points(1024, 4)
    g = rng.normal(size=(1024, a.output_dim)).astype(np.float32)
    out, vjp = jax.vjp(lambda tt: jbg.brick_encode(jnp.asarray(x), tt, a), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    calls = []
    plain = ks.scatter_add_rows

    def counting(idx, rows, dst):
        calls.append((idx.dtype, tuple(rows.shape)))
        return plain(idx, rows, dst)

    monkeypatch.setattr(ks, "scatter_add_rows", counting)
    tt = torch.from_numpy(table).requires_grad_(True)
    got = tbg.brick_encode(torch.from_numpy(x), tt, b)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    got.backward(torch.from_numpy(g))
    assert calls == [(torch.int32, (1024 * a.num_levels, a.row_width))]
    _scaled(tt.grad, np.asarray(want), 1e-5)
    # the cluster's rows received many points' cotangents
    assert float(tt.grad.abs().max()) > 0
