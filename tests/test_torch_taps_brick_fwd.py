"""The factor taps' forward and the brick grid's encoding as the port runs
them through their kernel wrappers (``ops/kernels/scatter.py:
sample_taps_fwd`` inside ``ops/interp.py:FactorTaps``;
``ops/brickgrid.py:BrickEncode`` around ``brick_encode_fwd`` and
``brick_encode_bwd``), on the CPU, where the wrappers take their plain
versions, against the JAX package's ``sample_1d`` / ``sample_2d`` and
``brick_encode``: the forward, ``jax.vjp`` in the factor or table, and the
gradient in the coords or x where autograd asks for it (and its counter,
``LAUNCHES["taps_coords_grad_plain"]`` / ``["brick_x_grad_plain"]``, only
then). Points on cell and brick edges (and 1-2 ulps off them), on the
box's faces and just outside it, and points outside the grid; both corner
conventions; dense and hashed levels; f32 and bf16. Also: the plain
version of ``brick_encode_bwd`` (the layout its kernel must write) is the
cotangent autograd of ``brick_encode_plain`` hands to the row gather, bit
for bit, and each wrapper raises ``ValueError`` on a meta tensor, a wrong
dtype and a wrong shape.

Tolerances, as a share of the largest entry of JAX's result. The taps:
the forward 1e-6 (the same f32 products and sums in the same order; XLA
may contract a product into its sum), the coords gradient 1e-4 and the
factor gradient 1e-4 in f32 (the same products summed in another order,
as ``tests/test_torch_scatter_taps.py`` holds them), 2e-2 for a bf16
factor (JAX adds the cotangents in bf16, the port in f32 and rounds once).
The brick grid as ``tests/test_torch_brickgrid.py`` holds it: f32 1e-5
throughout; bf16 1e-2 for the forward and the x gradient (a bf16 step is
2^-8, and the eight products sum in another order), 2e-2 for the table
gradient (JAX adds a row's cotangents in bf16, the port in f32).
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
from ngp_tpu_torch.ops.kernels import LAUNCHES
from ngp_tpu_torch.ops.kernels import scatter as ks
from test_torch_train_step import _scaled

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _ulps(v, steps=(1, 2)):
    """v and its f32 neighbours ``steps`` ulps away on both sides."""
    out = [v]
    for n in steps:
        for direction in (np.inf, -np.inf):
            w = v.copy()
            for _ in range(n):
                w = np.nextafter(w, np.float32(direction))
            out.append(w)
    return np.concatenate(out)


def _tap_coords(grid, align_corners, seed):
    """Uniform coords in [-1.2, 1.2] (some outside the grid), a run of one
    repeated point, and the coords of every cell edge and 1-2 ulps off it."""
    rng = np.random.default_rng(seed)
    size = grid[-1]
    k = np.arange(-1, size + 1, dtype=np.float64)
    edges = _ulps(((k / (size - 1) * 2 - 1) if align_corners
                   else ((2 * k + 1) / size - 1)).astype(np.float32))
    u = np.concatenate([rng.uniform(-1.2, 1.2, 200).astype(np.float32),
                        np.full(40, 0.123, np.float32), edges])
    if len(grid) == 1:
        return u
    return np.stack([u, rng.permutation(u)], axis=-1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("grid", [(13,), (7, 11)])
@pytest.mark.parametrize("align_corners", [True, False])
def test_factor_taps_through_the_forward_wrapper_match_jax(align_corners, grid, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(len(grid))
    factor = jnp.asarray(rng.normal(size=(6, *grid)).astype(np.float32)).astype(jdt)
    coords = _tap_coords(grid, align_corners, seed=3)
    fn = ji.sample_1d if len(grid) == 1 else ji.sample_2d
    want, vjp = jax.vjp(lambda f, c: fn(f, c, align_corners), factor, jnp.asarray(coords))
    cot = rng.normal(size=want.shape).astype(np.float32)
    d_factor, d_coords = vjp(jnp.asarray(cot))
    f = torch.from_numpy(np.array(factor.astype(jnp.float32))).to(tdt).requires_grad_()
    c = torch.from_numpy(coords).requires_grad_()
    launches, coords_grads = LAUNCHES["sample_taps_fwd"], LAUNCHES["taps_coords_grad_plain"]
    got = ti.FactorTaps.apply(f, c, align_corners)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _scaled(got.detach(), np.asarray(want), 1e-6)
    got.backward(torch.from_numpy(cot))
    assert f.grad.dtype == tdt
    _scaled(f.grad.float(), np.asarray(d_factor.astype(jnp.float32)),
            1e-4 if dtype == "float32" else 2e-2)
    _scaled(c.grad, np.asarray(d_coords), 1e-4)
    # the CPU takes the plain version: no kernel launch; one gradient in the
    # points, asked for once
    assert LAUNCHES["sample_taps_fwd"] == launches
    assert LAUNCHES["taps_coords_grad_plain"] == coords_grads + 1
    # the factor alone: no gradient in the points is made
    f2 = f.detach().clone().requires_grad_()
    ti.FactorTaps.apply(f2, torch.from_numpy(coords), align_corners).backward(
        torch.from_numpy(cot))
    assert torch.equal(f2.grad, f.grad)
    assert LAUNCHES["taps_coords_grad_plain"] == coords_grads + 1


BRICKS = {
    # dense and hashed levels, a non-integer scale, 2 features
    "small": dict(num_levels=4, level_dim=2, base_resolution=4, per_level_scale=2.3,
                  log2_hashmap_size=9),
    # the --preset tpu encoder's levels with 2^12 bricks a level (4 features)
    "preset_cut": dict(num_levels=8, level_dim=4, base_resolution=16, log2_hashmap_size=12,
                       desired_resolution=4096),
}


def _brick_points(cfg, kind, seed):
    """``random``: uniform in the box, a quarter outside it. ``edges``: on
    each level's cell edges (x * scale + 0.5 an integer in real arithmetic:
    even ones are brick edges) and 1-2 ulps off them, on the box's faces
    and just inside and outside them (by normal floats: XLA's CPU flushes
    subnormals to zero, torch and the card do not), the other coordinates
    uniform."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        x = rng.uniform(0.0, 1.0, (768, 3)).astype(np.float32)
        out = rng.random(768) < 0.25
        x[out] = rng.uniform(-0.3, 1.3, (int(out.sum()), 3)).astype(np.float32)
        return x
    vals = []
    for level in range(cfg.num_levels):
        s = cfg.level_scale(level)
        n = rng.choice(np.arange(1, int(s) + 1), size=min(12, int(s)), replace=False)
        vals.append(((n - 0.5) / s).astype(np.float32))
    one = np.float32(1.0)
    faces = np.array([0.0, 2.0**-20, -2.0**-20, one, np.nextafter(one, np.float32(0)),
                      np.nextafter(one, np.float32(2))], np.float32)
    v = np.concatenate([_ulps(np.concatenate(vals)), faces])
    x = rng.uniform(0.0, 1.0, (v.size, 3)).astype(np.float32)
    x[np.arange(v.size), rng.integers(0, 3, v.size)] = v
    return x


def _brick_case(name, kind, seed=0):
    a, b = jbg.BrickGridConfig(**BRICKS[name]), tbg.BrickGridConfig(**BRICKS[name])
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(a.num_rows, a.row_width)).astype(np.float32)
    x = _brick_points(a, kind, seed + 1)
    g = rng.normal(size=(x.shape[0], a.output_dim)).astype(np.float32)
    return a, b, table, x, g


@pytest.mark.parametrize("kind", ["random", "edges"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(BRICKS))
def test_brick_encode_function_matches_jax(name, dtype, kind):
    a, b, table, x, g = _brick_case(name, kind)
    tdt, jdt = DTYPES[dtype]
    jdt = None if dtype == "float32" else jdt
    out, vjp = jax.vjp(lambda xx, tt: jbg.brick_encode(xx, tt, a, compute_dtype=jdt),
                       jnp.asarray(x), jnp.asarray(table))
    gx, gt = vjp(jnp.asarray(g).astype(out.dtype))
    xt = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    launches = {k: LAUNCHES[k] for k in ("brick_encode_fwd", "brick_encode_bwd",
                                         "brick_x_grad_plain")}
    got = tbg.BrickEncode.apply(xt, tt, b, tdt)
    assert got.dtype == tdt and got.shape == out.shape
    oob = ((x < 0) | (x > 1)).any(axis=1)
    assert oob.any() and (~oob).any() and (got.detach()[torch.from_numpy(oob)] == 0).all()
    got.backward(torch.from_numpy(g).to(tdt))
    tol, tol_table = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 2e-2)
    _scaled(got.detach().float(), np.asarray(out, np.float32), tol)
    _scaled(tt.grad, np.asarray(gt, np.float32), tol_table)
    _scaled(xt.grad, np.asarray(gx, np.float32), tol)
    assert float(xt.grad.abs().max()) > 0 and float(tt.grad.abs().max()) > 0
    assert {k: LAUNCHES[k] - n for k, n in launches.items()} == {
        "brick_encode_fwd": 0, "brick_encode_bwd": 0, "brick_x_grad_plain": 1}
    # the table alone: no gradient in x is made, the same table gradient
    tt2 = torch.from_numpy(table).requires_grad_()
    tbg.brick_encode(torch.from_numpy(x), tt2, b, tdt).backward(torch.from_numpy(g).to(tdt))
    assert torch.equal(tt2.grad, tt.grad)
    assert LAUNCHES["brick_x_grad_plain"] == launches["brick_x_grad_plain"] + 1


def _autograd_rows(x, table, cfg, g, dt, monkeypatch):
    """(idx, rows): what autograd of ``brick_encode_plain`` hands to the row
    scatter of the table gradient (``GatherRows``'s backward)."""
    calls = []
    plain = ks.scatter_add_rows

    def keeping(idx, rows, out):
        calls.append((idx.clone(), rows.clone()))
        return plain(idx, rows, out)

    monkeypatch.setattr(ks, "scatter_add_rows", keeping)
    tt = torch.from_numpy(table).requires_grad_()
    out = tbg.brick_encode_plain(torch.from_numpy(x), tt, cfg, dt)
    out.backward(torch.from_numpy(g).to(dt))
    monkeypatch.undo()
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("kind", ["random", "edges"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(BRICKS))
def test_brick_encode_bwd_plain_is_autograds_cotangent_bit_for_bit(name, dtype, kind,
                                                                   monkeypatch):
    _, cfg, table, x, g = _brick_case(name, kind, seed=5)
    tdt = DTYPES[dtype][0]
    if kind == "edges":
        # negative cotangents against zero weights: products of -0
        g = -np.abs(g)
    idx_a, rows_a = _autograd_rows(x, table, cfg, g, tdt, monkeypatch)
    idx, rows = tbg.brick_encode_bwd(torch.from_numpy(x), torch.from_numpy(g).to(tdt), cfg)
    assert idx.dtype == torch.int32 and rows.dtype == torch.float32
    assert rows.shape == rows_a.shape == (x.shape[0] * cfg.num_levels, cfg.row_width)
    assert torch.equal(rows.view(torch.int32), rows_a.view(torch.int32))
    inside = torch.from_numpy(~((x < 0) | (x > 1)).any(axis=1)).repeat_interleave(
        cfg.num_levels)
    assert torch.equal(idx[inside], idx_a[inside]) and (idx[~inside] == -1).all()
    # 8 of a row's 27 cells carry a product; no -0 among them
    live = rows.view(rows.shape[0], 27, cfg.level_dim).ne(0).any(-1).sum(-1)
    assert int(live.max()) <= 8 and int(live[inside].max()) > 0
    assert not torch.signbit(rows[rows == 0]).any()


def _raising_calls():
    f = torch.zeros((4, 9))
    u = torch.zeros((6,))
    cfg = tbg.BrickGridConfig(num_levels=2, level_dim=2, base_resolution=4,
                              log2_hashmap_size=6)
    table, x = torch.zeros((cfg.num_rows, cfg.row_width)), torch.zeros((5, 3))
    g = torch.zeros((5, cfg.output_dim))
    return {
        "sample_taps_fwd": {
            "meta": lambda: ks.sample_taps_fwd(f.to("meta"), u.to("meta"), True),
            "dtype": lambda: ks.sample_taps_fwd(f.long(), u, True),
            "shape": lambda: ks.sample_taps_fwd(f, torch.zeros((6, 2)), True),
        },
        "brick_encode_fwd": {
            "meta": lambda: tbg.brick_encode_fwd(x.to("meta"), table.to("meta"), cfg),
            "dtype": lambda: tbg.brick_encode_fwd(x, table.long(), cfg),
            "shape": lambda: tbg.brick_encode_fwd(x, table[:-1], cfg),
        },
        "brick_encode_bwd": {
            "meta": lambda: tbg.brick_encode_bwd(x.to("meta"), g.to("meta"), cfg),
            "dtype": lambda: tbg.brick_encode_bwd(x.int(), g, cfg),
            "shape": lambda: tbg.brick_encode_bwd(x, g[:, 1:], cfg),
        },
        "brick_table_grad": {
            "meta": lambda: tbg.brick_table_grad(x.to("meta"), g.to("meta"), cfg,
                                                 table.to("meta")),
            "dtype": lambda: tbg.brick_table_grad(x.int(), g, cfg, table.clone()),
            "shape": lambda: tbg.brick_table_grad(x, g[:, 1:], cfg, table.clone()),
        },
    }


@pytest.mark.parametrize("case", ["meta", "dtype", "shape"])
@pytest.mark.parametrize("wrapper", ["sample_taps_fwd", "brick_encode_fwd", "brick_encode_bwd",
                                     "brick_table_grad"])
def test_wrappers_raise_on_what_they_do_not_take(wrapper, case):
    with pytest.raises(ValueError):
        _raising_calls()[wrapper][case]()
