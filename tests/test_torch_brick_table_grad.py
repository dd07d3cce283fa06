"""The brick grid's table gradient as the port makes it in one kernel
(``ops/brickgrid.py:brick_table_grad``, which ``BrickEncode`` calls in
place of the rows' cotangent and a row scatter-add), on the CPU, where the
wrapper takes its plain version ``brick_table_grad_plain``:

- against ``jax.vjp`` of ``ngp_tpu.ops.brickgrid.brick_encode`` in the
  table, on dense and hashed levels (``test_torch_taps_brick_fwd.BRICKS``),
  in f32 and bf16, on random points with a quarter outside the box, on
  points on every level's cell and brick edges and the box's faces, and on
  runs of consecutive points in one brick and stencil (a ray's samples);
  tolerances as ``tests/test_torch_brickgrid.py`` holds the table
  gradient: 1e-5 of the largest entry in f32, 2e-2 in bf16 (JAX adds a
  row's cotangents in bf16, the port in f32);
- ``BrickEncode``'s backward on the CPU bit-equal to what it was before the
  fusion (``brick_encode_bwd_plain``'s rows added by
  ``scatter_add_rows_plain``), the wrapper adding into the out it is given,
  and no kernel counted;
- the divisor magic numbers the kernels divide a level's rows by
  (``_divisor_magic``), against integer division, through a numpy model of
  the kernels' three lines (``csrc/brick_kernels.cu:level_row``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.ops import brickgrid as jbg
from ngp_tpu_torch.ops import brickgrid as tbg
from ngp_tpu_torch.ops.kernels import LAUNCHES
from ngp_tpu_torch.ops.kernels import scatter as ks
from test_torch_taps_brick_fwd import BRICKS, DTYPES, _brick_points
from test_torch_train_step import _scaled

# the --preset tpu encoder: 8 levels x 4, 2^16 bricks a level
PRESET = dict(num_levels=8, level_dim=4, base_resolution=16, log2_hashmap_size=16,
              desired_resolution=4096)


def _ray_points(cfg, seed):
    """24 rays of 32 consecutive samples each (the v1 march's slots): the
    samples 1e-3 apart, so at a coarse level a ray's samples share a brick
    and a stencil; 4 rays start at one point (every sample in one brick)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.1, 0.9, (24, 3))
    d = rng.normal(size=(24, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.arange(32) * 1e-3
    t = np.where(np.arange(24)[:, None] < 4, 0.0, t[None, :])
    return (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3).astype(np.float32)


def _case(name, kind, seed):
    a, b = jbg.BrickGridConfig(**BRICKS[name]), tbg.BrickGridConfig(**BRICKS[name])
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(a.num_rows, a.row_width)).astype(np.float32)
    x = _ray_points(a, seed + 1) if kind == "rays" else _brick_points(a, kind, seed + 1)
    g = rng.normal(size=(x.shape[0], a.output_dim)).astype(np.float32)
    # masked slots: a fifth of the points carry a zero cotangent
    g[rng.random(x.shape[0]) < 0.2] = 0.0
    return a, b, table, x, g


@pytest.mark.parametrize("kind", ["random", "edges", "rays"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(BRICKS))
def test_brick_table_grad_plain_matches_jax(name, dtype, kind):
    a, b, table, x, g = _case(name, kind, seed=11)
    tdt, jdt = DTYPES[dtype]
    jdt = None if dtype == "float32" else jdt
    out, vjp = jax.vjp(lambda tt: jbg.brick_encode(jnp.asarray(x), tt, a, compute_dtype=jdt),
                       jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g).astype(out.dtype))
    zeros = torch.zeros((b.num_rows, b.row_width))
    got = tbg.brick_table_grad_plain(torch.from_numpy(x), torch.from_numpy(g).to(tdt), b, zeros)
    assert got is zeros and got.dtype == torch.float32
    _scaled(got, np.asarray(want, np.float32), 1e-5 if dtype == "float32" else 2e-2)
    assert float(got.abs().max()) > 0
    # the wrapper on the CPU: the plain version, added into the out it is given
    base = torch.from_numpy(np.random.default_rng(3).normal(size=tuple(zeros.shape))
                            .astype(np.float32))
    xt, gt = torch.from_numpy(x), torch.from_numpy(g).to(tdt)
    added = tbg.brick_table_grad(xt, gt, b, base.clone())
    assert torch.equal(added, tbg.brick_table_grad_plain(xt, gt, b, base.clone()))
    assert not torch.equal(added, base)


@pytest.mark.parametrize("kind", ["random", "edges", "rays"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(BRICKS))
def test_brick_encode_backward_is_the_rows_and_scatter_bit_for_bit(name, dtype, kind):
    _, cfg, table, x, g = _case(name, kind, seed=21)
    tdt = DTYPES[dtype][0]
    if kind == "edges":
        g = -np.abs(g)  # negative cotangents against zero weights: products of -0
    xt, gt = torch.from_numpy(x), torch.from_numpy(g).to(tdt)
    tt = torch.from_numpy(table).requires_grad_()
    before = dict(LAUNCHES)
    tbg.brick_encode(xt, tt, cfg, tdt).backward(gt)
    assert LAUNCHES == before
    idx, rows = tbg.brick_encode_bwd_plain(xt, gt, cfg)
    want = ks.scatter_add_rows_plain(idx, rows, torch.zeros((cfg.num_rows, cfg.row_width)))
    assert tt.grad.dtype == torch.float32
    assert torch.equal(tt.grad.view(torch.int32), want.view(torch.int32))


def test_brick_table_grad_refuses_a_wrong_out():
    cfg = tbg.BrickGridConfig(**BRICKS["small"])
    x, g = torch.zeros((5, 3)), torch.zeros((5, cfg.output_dim))
    for out in (torch.zeros((cfg.num_rows - 1, cfg.row_width)),
                torch.zeros((cfg.num_rows, cfg.row_width), dtype=torch.float64),
                torch.zeros((cfg.num_rows, cfg.row_width)).to("meta")):
        with pytest.raises(ValueError):
            tbg.brick_table_grad(x, g, cfg, out)


def _level_row(rows, magic, shift, h):
    """``csrc/brick_kernels.cu:level_row`` in numpy uint64: h % rows by a
    mask, or by the magic multiplier and shift."""
    h = h.astype(np.uint64)
    if magic == 0:
        return h & np.uint64(rows - 1)
    t = (np.uint64(magic) * h) >> np.uint64(32)
    q = (t + ((h - t) >> np.uint64(1))) >> np.uint64(shift)
    return h - q * np.uint64(rows)


@pytest.mark.parametrize("name", ["preset", "small", "divisors"])
def test_divisor_magic_divides_every_uint32(name):
    if name == "divisors":
        rng = np.random.default_rng(0)
        divisors = [1, 2, 3, 5, 7, 729, 6859, 64000, 2**31 - 1, 2**32 - 1, 3 * 2**30]
        divisors += [int(v) for v in rng.integers(3, 2**32, 40)]
    else:
        cfg = tbg.BrickGridConfig(**(PRESET if name == "preset" else BRICKS[name]))
        divisors = [cfg.level_bricks(level)[0] for level in range(cfg.num_levels)]
        if name == "preset":  # three dense levels, then hashed ones of 2^16 rows
            assert divisors[:4] == [729, 6859, 64000, 65536]
    rng = np.random.default_rng(1)
    for d in divisors:
        magic, shift = tbg._divisor_magic(d)
        assert (magic == 0) == (d & (d - 1) == 0) and 0 <= magic < 2**32
        h = np.concatenate([rng.integers(0, 2**32, 20000, dtype=np.uint64),
                            np.array([0, 1, d - 1, d, d + 1, 2 * d - 1, 2**32 - 1,
                                      (2**32 - 1) // d * d, (2**32 - 1) // d * d - 1],
                                     dtype=np.uint64) % np.uint64(2**32)])
        np.testing.assert_array_equal(_level_row(d, magic, shift, h), h % np.uint64(d))
