"""The port's brick grid (``ops/brickgrid.py``, ``BrickGridEncoder``) against
the JAX package's: the level geometry and table size (the ``--preset tpu``
widths included), the brick index on dense and hashed levels (negative
coords too), ``brick_encode``'s forward, table gradient and point
gradient against ``jax.vjp`` on random points with 25% outside the box,
``dense_field_to_brick_table`` and the exact trilinear case, the encoder
factory, and ``--preset tpu`` train steps (the v1 march) on JAX's draws.

Tolerances. f32: the forward and both gradients to 1e-5 of the largest
entry (JAX runs op by op, so x * scale + 0.5 rounds as the port rounds
it). bf16 (the preset's compute type): the forward and the point
gradient to 1e-2 of the largest entry (a bf16 step is 2^-8, and the
eight products sum in another order), the table gradient to 2e-2 (JAX
adds a row's cotangents in bf16, the port in f32). The train steps as
``test_torch_train_step.py`` holds one: the loss to 1e-5 relative, each
gradient to 1e-4 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.ops import brickgrid as jbg
from ngp_tpu_torch.models.encoders import BrickGridEncoder, get_encoder
from ngp_tpu_torch.ops import brickgrid as tbg
from test_torch_renderer import one_torch_thread  # noqa: F401
from test_torch_train_step import _check_step, _np, _scaled, _trainer_pair

CONFIGS = {
    # the --preset tpu encoder at bound 2: 8 levels x 4, 2^16 bricks a level
    "preset": dict(num_levels=8, level_dim=4, base_resolution=16, log2_hashmap_size=16,
                   desired_resolution=4096),
    # small: dense and hashed levels, a non-integer scale
    "small": dict(num_levels=4, level_dim=2, base_resolution=4, per_level_scale=2.3,
                  log2_hashmap_size=9),
    "one_level": dict(num_levels=1, level_dim=3, base_resolution=8, log2_hashmap_size=12),
}
# the preset's levels with 2^12 bricks a level (a table of 1.4 M values, not 43 M)
CONFIGS["preset_cut"] = dict(CONFIGS["preset"], log2_hashmap_size=12)


@pytest.mark.parametrize("name", ["preset", "small", "one_level"])
def test_geometry_matches_jax(name):
    a, b = jbg.BrickGridConfig(**CONFIGS[name]), tbg.BrickGridConfig(**CONFIGS[name])
    assert b.per_level_scale == a.per_level_scale
    for level in range(a.num_levels):
        assert b.level_scale(level) == a.level_scale(level)
        assert b.level_bricks(level) == a.level_bricks(level)
    assert (b.offsets, b.num_rows, b.row_width, b.output_dim) == \
        (a.offsets, a.num_rows, a.row_width, a.output_dim)
    if name == "preset":
        # 729 + 6,859 + 64,000 dense bricks, then five hashed levels of 2^16
        assert b.num_rows == 399_268 and b.num_rows * b.row_width * 4 == 172_483_776


@pytest.mark.parametrize("name", ["preset", "small"])
def test_brick_index_matches_jax(name):
    a, b = jbg.BrickGridConfig(**CONFIGS[name]), tbg.BrickGridConfig(**CONFIGS[name])
    rng = np.random.default_rng(0)
    for level in range(a.num_levels):
        side = a.level_resolution(level) // 2 + 1
        bc = rng.integers(-3, side + 3, (512, 3)).astype(np.int32)
        want = np.asarray(jbg._brick_index(a, level, jnp.asarray(bc)))
        got = tbg._brick_index(b, level, torch.from_numpy(bc).long()).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < a.level_bricks(level)[0]


def _points(n, seed):
    """Random points, a quarter of them outside [0, 1]^3."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    out = rng.random(n) < 0.25
    x[out] = rng.uniform(-0.3, 1.3, (int(out.sum()), 3)).astype(np.float32)
    x[out, rng.integers(0, 3, int(out.sum()))] = rng.choice([-0.1, 1.1], int(out.sum()))
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["preset_cut", "small"])
def test_brick_encode_and_vjp_match_jax(name, dtype):
    a, b = jbg.BrickGridConfig(**CONFIGS[name]), tbg.BrickGridConfig(**CONFIGS[name])
    rng = np.random.default_rng(1)
    table = rng.normal(size=(a.num_rows, a.row_width)).astype(np.float32)
    x = _points(2048, 2)
    g = rng.normal(size=(2048, a.output_dim)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    out, vjp = jax.vjp(lambda xx, tt: jbg.brick_encode(xx, tt, a, compute_dtype=jdt),
                       jnp.asarray(x), jnp.asarray(table))
    gx, gt = vjp(jnp.asarray(g).astype(out.dtype))
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    got = tbg.brick_encode(xt, tt, b, compute_dtype=tdt)
    assert got.dtype == (torch.float32 if tdt is None else tdt) and got.shape == (2048,
                                                                                 a.output_dim)
    got.backward(torch.from_numpy(g).to(got.dtype))
    oob = ((x < 0) | (x > 1)).any(axis=1)
    assert 0.2 < oob.mean() < 0.3 and (got.detach()[torch.from_numpy(oob)] == 0).all()
    tol, tol_table = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 2e-2)
    _scaled(got.detach().float(), np.asarray(out, np.float32), tol)
    _scaled(tt.grad, np.asarray(gt, np.float32), tol_table)
    _scaled(xt.grad, np.asarray(gx, np.float32), tol)
    assert float(xt.grad.abs().max()) > 0 and float(tt.grad.abs().max()) > 0


def test_dense_field_to_brick_table_and_exact_trilinear():
    """Consistent halo copies: the table equals JAX's, and the encoding is
    the field's exact trilinear interpolation."""
    cfg = tbg.BrickGridConfig(num_levels=1, level_dim=2, base_resolution=8, per_level_scale=1.0)
    jcfg = jbg.BrickGridConfig(num_levels=1, level_dim=2, base_resolution=8, per_level_scale=1.0)
    res = cfg.level_resolution(0)
    rng = np.random.default_rng(0)
    field = rng.normal(size=(res + 1, res + 1, res + 1, 2)).astype(np.float32)
    rows = tbg.dense_field_to_brick_table(field, cfg, 0)
    np.testing.assert_array_equal(rows, jbg.dense_field_to_brick_table(field, jcfg, 0))
    x = rng.uniform(0.02, 0.98, size=(200, 3)).astype(np.float32)
    got = tbg.brick_encode(torch.from_numpy(x), torch.from_numpy(rows), cfg).numpy()
    pos = x * cfg.level_scale(0) + 0.5
    p0 = np.floor(pos).astype(int)
    f = pos - p0
    expect = np.zeros((200, 2), np.float32)
    for c in range(8):
        o = [(c >> d) & 1 for d in range(3)]
        w = np.prod([f[:, d] if o[d] else 1 - f[:, d] for d in range(3)], axis=0)
        expect += w[:, None] * field[p0[:, 0] + o[0], p0[:, 1] + o[1], p0[:, 2] + o[2]]
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="dense"):
        tbg.dense_field_to_brick_table(field, tbg.BrickGridConfig(log2_hashmap_size=4), 3)


def test_encoder_factory_caps_the_bricks():
    """``get_encoder("brickgrid")`` caps log2_hashmap_size at 16 (JAX's
    ``min(., 16)``) and names its table ``embeddings``."""
    enc, dim = get_encoder("brickgrid", num_levels=8, level_dim=4, log2_hashmap_size=19,
                           desired_resolution=4096, compute_dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(enc, BrickGridEncoder) and dim == 32 == enc.output_dim
    assert enc.cfg.log2_hashmap_size == 16 and enc.cfg == tbg.BrickGridConfig(
        **CONFIGS["preset"])
    assert tuple(enc.embeddings.shape) == (399_268, 108) and enc.embeddings.abs().max() <= 1e-4
    out = enc(torch.rand(64, 3))
    assert out.dtype == torch.bfloat16 and out.shape == (64, 32)
    with pytest.raises(ValueError, match="unknown encoding"):
        get_encoder("voxels", device="cpu")


# one dense and three hashed levels of 4 x 4 (the preset's level width),
# at bound 1 (finest 2048 cells), through the v1 march
_BRICK_NC = dict(encoding="brickgrid", use_bf16=False, num_levels=4, level_dim=4,
                 base_resolution=4, log2_hashmap_size=10, sh_degree=3)


def test_preset_tpu_train_steps_match_jax(tmp_path, monkeypatch):
    """Train steps of the brick grid through the v1 march (``--preset tpu``'s
    path; f32 here, the preset's bf16 held op by op above) on JAX's draws,
    three steps (both frames, three draws) from the same weights and grid:
    the loss and every gradient. JAX's step runs under ``jit``, whose fused multiply-adds round
    the sample points once, as the port then rounds them
    (``_one_rounding``)."""
    from ngp_tpu_torch.data import synthetic as tsyn
    from test_torch_v1_march import RC as V1_RC
    from test_torch_v1_march import _one_rounding

    _one_rounding(monkeypatch)
    H = W = 24
    n = 256
    tc = dict(iters=50, num_rays=n, workspace=str(tmp_path))
    jtr, port = _trainer_pair(tmp_path, V1_RC, _BRICK_NC, tc, table_std=0.1)
    frames = tsyn.make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=H, W=W,
                                        device="cpu")["train"]
    batch = {"images": jnp.asarray(frames.images), "poses": jnp.asarray(frames.poses),
             "intrinsics": jnp.asarray(frames.intrinsics)}
    tbatch = {"images": torch.from_numpy(frames.images), "poses": torch.from_numpy(frames.poses),
              "intrinsics": torch.from_numpy(frames.intrinsics)}
    step = jax.jit(jtr.train_step)
    for idx, seed in ((1, 9), (0, 10), (1, 11)):
        rng = jax.random.PRNGKey(seed)
        jstate, _, jmet = step(jtr.state, jtr.aux, dict(batch, idx=jnp.int32(idx)), rng)
        k_pix, k_bg, k_render = jax.random.split(rng, 3)
        draws = {"inds": _np(jax.random.randint(k_pix, (n,), 0, H * W)),
                 "bg": _np(jax.random.uniform(k_bg, (n, 3))),
                 "noise": _np(jax.random.uniform(k_render, (n,)))}
        ttr = port()
        assert isinstance(ttr.model.encoder, BrickGridEncoder)
        tmet = ttr.train_step(dict(tbatch, idx=idx), draws)
        _check_step(jstate, jmet, tmet, ttr.model)
