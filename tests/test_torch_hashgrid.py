"""The port's hash / tiled grid encoder (``ngp_tpu_torch/ops/hashgrid.py``
and the plain versions of its kernels) against ``ngp_tpu/ops/hashgrid.py``
on the same points and tables, the table gradient
(``grid_encode_bwd_plain``) against ``jax.vjp``, and the row scatter-add
against JAX's ``.at[idx].add``.

Tolerances. Geometry: equal. Forward: f32 to 1e-6 absolute on tables of
O(1) values (eight-term sums in another order: measured 1.8e-7), bf16
equal (table values and weights rounded to bf16, products summed in
f32 and each feature rounded once, as JAX's bf16 einsum on the CPU
does). f32 gradients: the table's to 1e-6 and x's to 1e-5 of their
largest entries (sums in another order). The bf16 table gradient: the
port sums the bf16-rounded corner products in f32 (the accumulator of
``scatter_pallas``), JAX scatter-adds them into a bf16 table, rounding
after every add; with one point per table row the two are equal, and in
general they differ by at most JAX's rounding, 2^-8 of each partial sum:
2^-8 * (adds to the row) * (sum of the row's |products|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.models.encoders import get_encoder as j_get_encoder
from ngp_tpu.ops import hashgrid as jh
from ngp_tpu_torch.models.encoders import get_encoder as t_get_encoder
from ngp_tpu_torch.ops import hashgrid as th
from ngp_tpu_torch.ops.kernels import hashgrid as kh
from ngp_tpu_torch.ops.kernels import scatter as ks

SMALL = dict(num_levels=4, log2_hashmap_size=10, base_resolution=4, desired_resolution=64)
CONFIGS = {
    "hash": SMALL,
    "tiled": dict(SMALL, gridtype="tiled"),
    "smoothstep": dict(SMALL, interpolation="smoothstep"),
    "align_corners": dict(SMALL, align_corners=True),
    "per_level_scale": dict(num_levels=3, log2_hashmap_size=12, base_resolution=5,
                            per_level_scale=1.7, level_dim=4),
}


def _points(shape, seed=0, lo=-0.05, hi=1.05):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape + (3,)).astype(np.float32)


def _table(cfg, seed=1):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, size=(cfg.num_rows, cfg.level_dim)).astype(np.float32)


def _scaled(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(desired_resolution=2048), dict(), dict(desired_resolution=4096),
    dict(desired_resolution=1024, align_corners=True),
    dict(gridtype="tiled", desired_resolution=2048), *CONFIGS.values(),
])
def test_grid_config_geometry_matches_jax(kw):
    """Both resolution formulas, the row offsets (the full-width table at
    bound 1 is 6,119,864 rows: levels 5-15 saturate at 2^19) and the
    per-level dense/hash choice of the index."""
    jc, tc = jh.GridConfig(**kw), th.GridConfig(**kw)
    assert tc.offsets == jc.offsets and tc.num_rows == jc.num_rows
    assert tc.output_dim == jc.output_dim and tc.per_level_scale == jc.per_level_scale
    for lv in range(jc.num_levels):
        assert tc.level_scale(lv) == jc.level_scale(lv)
        assert tc.level_resolution(lv) == jc.level_resolution(lv)
    if kw == dict(desired_resolution=2048):
        assert tc.num_rows == 6119864
        assert tc.geometry.hashed == (False,) * 5 + (True,) * 11
    np.testing.assert_array_equal(th._corner_offsets(3).numpy(), jh._corner_offsets(3))
    # every corner of a lattice patch, negative coords included, maps to the
    # same row within each level
    g = np.stack(np.meshgrid(*[np.arange(-3, 70, 7)] * 3, indexing="ij"), -1).reshape(-1, 3)
    for lv in range(jc.num_levels):
        want = np.asarray(jh._level_indices(jc, lv, jnp.asarray(g, jnp.int32)))
        np.testing.assert_array_equal(th._level_indices(tc, lv, torch.from_numpy(g)).numpy(),
                                      want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name, dtype):
    """Points in and outside [0, 1]^3 (zero rows) in a [2, 5, 3] batch and a
    flat one, through ``grid_encode`` (the plain version on the CPU)."""
    kw = CONFIGS[name]
    jc, tc = jh.GridConfig(**kw), th.GridConfig(**kw)
    tab = _table(jc)
    jd = None if dtype == "float32" else jnp.bfloat16
    td = None if dtype == "float32" else torch.bfloat16
    for shape in ((2, 5), (600,)):
        x = _points(shape)
        x[0, 0] = [0.5, 1.2, 0.5] if len(shape) == 2 else x[0, 0]
        want = np.asarray(jh.grid_encode(jnp.asarray(x), jnp.asarray(tab), jc, jd)
                          .astype(jnp.float32))
        got = th.grid_encode(torch.from_numpy(x), torch.from_numpy(tab), tc, td)
        assert got.shape == shape + (tc.output_dim,)
        assert got.dtype == (td or torch.float32)
        oob = ((x < 0) | (x > 1)).any(-1)
        assert oob.any() and not got[torch.from_numpy(oob)].float().any()
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("name", ["hash", "tiled", "smoothstep", "align_corners"])
def test_gradients_match_jax(name):
    """f32: the table and x gradients of the plain version (autograd)
    against ``jax.grad``."""
    jc, tc = jh.GridConfig(**CONFIGS[name]), th.GridConfig(**CONFIGS[name])
    x, tab = _points((700,), seed=2), _table(jc, seed=3)
    g = np.random.default_rng(4).normal(size=(700, jc.output_dim)).astype(np.float32)
    gx, gt = jax.grad(lambda a, b: jnp.sum(jh.grid_encode(a, b, jc) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(tab))
    xt = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(tab).requires_grad_()
    (th.grid_encode(xt, tt, tc) * torch.from_numpy(g)).sum().backward()
    _scaled(tt.grad, gt, 1e-6)
    _scaled(xt.grad, gx, 1e-5)
    assert float(np.abs(np.asarray(gx)).max()) > 0


def _jax_table_grad(jc, x, tab, g, dtype):
    def f(t):
        return jnp.sum(jh.grid_encode(jnp.asarray(x), t, jc, dtype).astype(jnp.float32) * g)

    return np.asarray(jax.grad(f)(jnp.asarray(tab)))


@pytest.mark.parametrize("name", ["hash", "tiled", "smoothstep"])
def test_bwd_rows_and_scatter_give_jax_table_gradient_f32(name):
    """``grid_encode_bwd_rows_plain`` + ``scatter_add_rows_plain`` (the
    plain version of ``grid_encode_bwd``) equal JAX's table gradient."""
    jc, tc = jh.GridConfig(**CONFIGS[name]), th.GridConfig(**CONFIGS[name])
    x, tab = _points((500,), seed=5), _table(jc)
    g = np.random.default_rng(6).normal(size=(500, jc.output_dim)).astype(np.float32)
    idx, rows = kh.grid_encode_bwd_rows_plain(torch.from_numpy(x), torch.from_numpy(g),
                                              tc.geometry)
    assert idx.dtype == torch.int32 and idx.shape == (500 * jc.num_levels * 8,)
    assert rows.dtype == torch.float32 and rows.shape == (idx.shape[0], jc.level_dim)
    oob = torch.from_numpy(((x < 0) | (x > 1)).any(-1))
    assert (idx.reshape(500, -1)[oob] == -1).all() and (idx.reshape(500, -1)[~oob] >= 0).all()
    got = ks.scatter_rows(idx, rows, tc.num_rows)
    _scaled(got, _jax_table_grad(jc, x, tab, g, None), 1e-6)


@pytest.mark.parametrize("n_points", [1, 400])
def test_bf16_table_gradient_rounding_points(n_points):
    """bf16: each corner product w * g is rounded to bf16 where JAX's
    einsum VJP rounds it; the port then sums in f32 where JAX sums in
    bf16 (see the module docstring for the bound)."""
    jc, tc = jh.GridConfig(**CONFIGS["hash"]), th.GridConfig(**CONFIGS["hash"])
    x, tab = _points((n_points,), seed=7, lo=0.0, hi=1.0), _table(jc)
    g = np.random.default_rng(8).normal(size=(n_points, jc.output_dim)).astype(np.float32)
    want = _jax_table_grad(jc, x, tab, g, jnp.bfloat16)
    gb = torch.from_numpy(g).bfloat16()
    idx, rows = kh.grid_encode_bwd_rows_plain(torch.from_numpy(x), gb, tc.geometry)
    got = ks.scatter_rows(idx, rows, tc.num_rows).numpy()
    tt = torch.from_numpy(tab).requires_grad_()
    (th.grid_encode(torch.from_numpy(x), tt, tc, torch.bfloat16).float()
     * gb.float()).sum().backward()
    np.testing.assert_array_equal(tt.grad.numpy(), got)  # autograd of the plain version
    if n_points == 1:
        np.testing.assert_array_equal(got, want)
        return
    adds = ks.scatter_rows(idx, (rows != 0).float(), tc.num_rows).numpy()
    s_abs = ks.scatter_rows(idx, rows.abs(), tc.num_rows).numpy()
    assert (np.abs(got - want) <= 2.0**-8 * adds * s_abs + 1e-7).all()
    assert adds.max() > 1 and not np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["hash", "tiled"])
def test_grid_encode_bwd_plain_matches_jax_vjp(name, dtype):
    """``grid_encode_bwd_plain`` (the plain version of the one-pass kernel
    ``grid_encode_bwd``) against ``jax.vjp`` of ``grid_encode`` in the
    table, on a cotangent whose rows are 85% zero (the masked slots of a
    train step) and points of which some lie outside [0, 1]^3. f32: to
    1e-6 of the largest entry (sums in another order). bf16: the same
    bf16 corner products, summed in f32 here and in bf16 by JAX (the
    module docstring's bound). ``GridEncode`` on CPU tensors gives the
    same table gradient, bit for bit."""
    jc, tc = jh.GridConfig(**CONFIGS[name]), th.GridConfig(**CONFIGS[name])
    n = 600
    x, tab = _points((n,), seed=11), _table(jc, seed=12)
    rng = np.random.default_rng(13)
    g = rng.normal(size=(n, jc.output_dim)).astype(np.float32)
    zero = rng.random(n) < 0.85
    g[zero] = 0.0
    bf = dtype == "bfloat16"
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf else (None, torch.float32)
    _, vjp = jax.vjp(lambda t: jh.grid_encode(jnp.asarray(x), t, jc, jd), jnp.asarray(tab))
    want = np.asarray(vjp(jnp.asarray(g).astype(jd or jnp.float32))[0], np.float32)
    gt = torch.from_numpy(g).to(td)
    got = kh.grid_encode_bwd_plain(torch.from_numpy(x), gt, tc.geometry)
    assert got.dtype == torch.float32 and got.shape == (tc.num_rows, tc.level_dim)
    inside = ~((x < 0) | (x > 1)).any(-1)
    assert (~inside).any() and 0.8 <= zero.mean() <= 0.9 and (inside & ~zero).any()
    tt = torch.from_numpy(tab).requires_grad_()
    kh.GridEncode.apply(torch.from_numpy(x), tt, tc.geometry, td).backward(gt)
    np.testing.assert_array_equal(tt.grad.numpy(), got.numpy())
    if not bf:
        _scaled(got, want, 1e-6)
        return
    idx, rows = kh.grid_encode_bwd_rows_plain(torch.from_numpy(x), gt, tc.geometry)
    adds = ks.scatter_rows(idx, (rows != 0).float(), tc.num_rows).numpy()
    s_abs = ks.scatter_rows(idx, rows.abs(), tc.num_rows).numpy()
    assert (np.abs(got.numpy() - want) <= 2.0**-8 * adds * s_abs + 1e-7).all()
    assert float(np.abs(want).max()) > 0


def test_scatter_add_rows_plain_matches_jax_at_add():
    """Repeated indices sum; indices at or past R, and below -R, add
    nothing as in ``.at[idx].add``. In [-R, 0) ``.at`` wraps first, XLA's
    scatter itself (``lax.scatter_add``) drops them, and so does the port
    (-1 marks a corner outside the unit cube)."""
    rng = np.random.default_rng(9)
    R, W, M = 37, 5, 400
    idx = rng.integers(-2 * R, 2 * R, size=M).astype(np.int32)
    idx[:50] = 3  # a hot row
    rows = rng.normal(size=(M, W)).astype(np.float32)
    out0 = rng.normal(size=(R, W)).astype(np.float32)
    got = ks.scatter_add_rows_plain(torch.from_numpy(idx), torch.from_numpy(rows),
                                    torch.from_numpy(out0.copy())).numpy()
    wraps = (idx < 0) & (idx >= -R)
    keep = np.where(wraps, R, idx)
    want = jnp.asarray(out0).at[jnp.asarray(keep)].add(jnp.asarray(rows))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-6)
    dnums = jax.lax.ScatterDimensionNumbers(update_window_dims=(1,), inserted_window_dims=(0,),
                                            scatter_dims_to_operand_dims=(0,))
    xla = jax.lax.scatter_add(jnp.asarray(out0), jnp.asarray(idx)[:, None], jnp.asarray(rows),
                              dnums, mode=jax.lax.GatherScatterMode.FILL_OR_DROP)
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-5, rtol=1e-6)
    fresh = ks.scatter_rows(torch.from_numpy(idx), torch.from_numpy(rows), R).numpy()
    np.testing.assert_allclose(fresh, np.asarray(xla) - out0, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("encoding", ["hashgrid", "tiledgrid"])
def test_grid_encoder_module_matches_jax(encoding):
    """``get_encoder``'s grid encoders: one ``embeddings`` parameter of
    the table's shape, drawn U(-1e-4, 1e-4), and the flax module's
    output on its own table."""
    kw = dict(num_levels=3, level_dim=2, base_resolution=4, log2_hashmap_size=9,
              desired_resolution=32)
    jenc, jdim = j_get_encoder(encoding, **kw)
    tenc, tdim = t_get_encoder(encoding, generator=torch.Generator().manual_seed(0),
                               device="cpu", **kw)
    assert tdim == jdim and [n for n, _ in tenc.named_parameters()] == ["embeddings"]
    x = _points((64,), seed=10, lo=0.0, hi=1.0)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tab = np.array(params["params"]["embeddings"])
    assert tenc.embeddings.shape == tab.shape and tenc.embeddings.device.type == "cpu"
    assert float(tenc.embeddings.detach().abs().max()) <= 1e-4
    assert dataclasses.asdict(tenc.cfg) == dataclasses.asdict(jenc.cfg)
    with torch.no_grad():
        tenc.embeddings.copy_(torch.from_numpy(tab))
        got = tenc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jenc.apply(params, jnp.asarray(x))),
                               atol=1e-10, rtol=1e-5)
