"""The port's losses, TV regulariser, Morton codes and bit packing, ray
geometry and the frequency and identity encoders against the JAX package
(``tests/test_morton_rays_losses.py`` holds the JAX side against slow
references) on the same numpy-seeded inputs.

Tolerances. Losses, TV, rays and encoders: 1e-6 relative to the largest
value (f32 sums in another order, atan2 and sqrt in another library);
the frequency encoder's octave k to 1e-6 * 2^k, as
``tests/test_torch_ops.py::test_freq_encode`` holds it (XLA's and
PyTorch's sin and cos differ by up to one ulp, and each rung of the
double-angle ladder doubles that). Morton codes, their inverse and the
bit fields: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu import config as jconfig
from ngp_tpu.models.encoders import get_encoder as j_get_encoder
from ngp_tpu.models.nerf import NeRFNetwork as JNeRFNetwork
from ngp_tpu.ops import hashgrid as jh
from ngp_tpu.ops import losses as jl
from ngp_tpu.ops import morton as jm
from ngp_tpu.ops import rays as jr
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch.models.encoders import get_encoder as t_get_encoder
from ngp_tpu_torch.models.nerf import NeRFNetwork as TNeRFNetwork
from ngp_tpu_torch.models.nerf import params_from_jax
from ngp_tpu_torch.ops import hashgrid as th
from ngp_tpu_torch.ops import losses as tl
from ngp_tpu_torch.ops import morton as tm
from ngp_tpu_torch.ops import rays as tr

TOL = 1e-6


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-0.5, 2.0, size=(64, 3)).astype(np.float32)
    # half the errors inside Huber's delta of 0.1, half outside
    tgt = (pred + rng.choice([-1.0, 1.0], size=pred.shape)
           * rng.uniform(0.0, 0.2, size=pred.shape)).astype(np.float32)
    return pred, tgt


@pytest.mark.parametrize("name,kw", [("mape_loss", {}), ("huber_loss", {}),
                                     ("huber_loss", {"delta": 0.05}),
                                     ("mape_loss", {"reduction": "none"})])
def test_mape_and_huber_values_and_gradients(name, kw):
    pred, tgt = _loss_inputs(1)
    jf, tf = getattr(jl, name), getattr(tl, name)
    want = jf(jnp.asarray(pred), jnp.asarray(tgt), **kw)
    jg = jax.grad(lambda p: jf(p, jnp.asarray(tgt), **kw).sum())(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = tf(p, torch.from_numpy(tgt), **kw)
    got.sum().backward()
    _close(got, want)
    _close(p.grad, jg)


@pytest.mark.parametrize("shape", [(8, 32), (3, 5, 48)])
def test_eff_distloss_value_and_gradients(shape):
    rng = np.random.default_rng(2)
    w = rng.uniform(0, 0.2, size=shape).astype(np.float32)
    w[..., -5:] = 0.0  # padded slots
    t = np.sort(rng.uniform(0.1, 2.0, size=shape).astype(np.float32), axis=-1)
    d = rng.uniform(0.01, 0.05, size=shape).astype(np.float32)
    args = tuple(jnp.asarray(a) for a in (w, t, d))
    want = jl.eff_distloss(*args)
    jgrads = jax.grad(jl.eff_distloss, argnums=(0, 1, 2))(*args)
    ts = [torch.from_numpy(a).requires_grad_() for a in (w, t, d)]
    got = tl.eff_distloss(*ts)
    got.backward()
    _close(got, want)
    for a, g in zip(ts, jgrads):
        _close(a.grad, g)
    assert float(got.detach()) > 0


def _tiled_cfg(**kw):
    base = dict(num_levels=4, level_dim=2, base_resolution=4, log2_hashmap_size=10,
                desired_resolution=32)
    base.update(kw)
    return jh.GridConfig(**base), th.GridConfig(**base)


@pytest.mark.parametrize("kw", [dict(gridtype="tiled"), dict(), dict(align_corners=True),
                                dict(gridtype="tiled", levels=(1, 3))])
def test_grid_tv_loss_value_and_table_gradient(kw):
    """A tiled grid (every level dense), a hash grid whose fine levels
    hash (skipped), align_corners sides, and a subset of levels."""
    kw = dict(kw)
    levels = kw.pop("levels", None)
    jcfg, tcfg = _tiled_cfg(**kw)
    table = np.random.default_rng(3).normal(size=(jcfg.num_rows, 2)).astype(np.float32)
    want, jg = jax.value_and_grad(lambda e: jh.grid_tv_loss(e, jcfg, levels=levels))(
        jnp.asarray(table))
    e = torch.from_numpy(table).requires_grad_()
    got = th.grid_tv_loss(e, tcfg, levels=levels)
    got.backward()
    _close(got, want)
    _close(e.grad, jg)
    assert float(want) > 0


def test_grid_tv_loss_is_zero_without_dense_levels():
    jcfg, tcfg = _tiled_cfg(num_levels=2, base_resolution=32, log2_hashmap_size=6)
    table = np.ones((jcfg.num_rows, 2), np.float32)
    assert float(jh.grid_tv_loss(jnp.asarray(table), jcfg)) == 0.0
    assert float(th.grid_tv_loss(torch.from_numpy(table), tcfg)) == 0.0


@pytest.mark.parametrize("encoding", ["tiledgrid", "cpgrid"])
def test_nerf_network_tv_loss(encoding):
    """``NeRFNetwork.tv_loss`` on the JAX model's own weights: the table's
    TV and its gradient for a grid encoder, 0 for the CP grid."""
    rc = dict(bound=1.0)
    nc = dict(encoding=encoding, num_levels=3, level_dim=2, base_resolution=4,
              log2_hashmap_size=10, use_bf16=False, cp_resolutions=(16, 32), cp_rank=8,
              cp_freq_degree=2, sh_degree=2)
    jnet = JNeRFNetwork(cfg=jconfig.NetworkConfig(**nc), render=jconfig.RenderConfig(**rc))
    x0 = jnp.zeros((8, 3))
    d0 = jnp.concatenate([jnp.ones((8, 1)), jnp.zeros((8, 2))], axis=-1)
    params = jnet.init(jax.random.PRNGKey(0), x0, d0, method=JNeRFNetwork.full_init)
    if encoding == "tiledgrid":  # a table with structure: U(-1e-4, 1e-4) is nearly flat
        emb = np.random.default_rng(4).normal(
            size=params["params"]["encoder"]["embeddings"].shape).astype(np.float32)
        params = jax.tree.map(lambda a: a, params)
        params["params"]["encoder"]["embeddings"] = jnp.asarray(emb)
    want, jg = jax.value_and_grad(
        lambda p: jnet.apply(p, method=JNeRFNetwork.tv_loss))(params)
    net = TNeRFNetwork(tconfig.NetworkConfig(**nc), tconfig.RenderConfig(**rc), device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    got = net.tv_loss()
    if encoding == "cpgrid":
        assert float(got) == 0.0 == float(want)
        return
    got.backward()
    _close(got, want)
    _close(net.encoder.embeddings.grad, jg["params"]["encoder"]["embeddings"])
    assert float(want) > 0


@pytest.mark.parametrize("hi", [128, 1024])
def test_morton_codes_equal_jax(hi):
    coords = np.random.default_rng(5).integers(0, hi, size=(500, 3)).astype(np.int32)
    want = np.asarray(jm.morton3d(jnp.asarray(coords)))
    got = tm.morton3d(torch.from_numpy(coords))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = tm.morton3d_invert(got)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jm.morton3d_invert(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy(), coords)


def test_morton_invert_of_any_int32_equals_jax():
    """Negative int32 codes: JAX reads them as uint32, so must the port."""
    codes = np.random.default_rng(6).integers(-2**31, 2**31 - 1, size=400).astype(np.int32)
    want = np.asarray(jm.morton3d_invert(jnp.asarray(codes)))
    np.testing.assert_array_equal(tm.morton3d_invert(torch.from_numpy(codes)).numpy(), want)


@pytest.mark.parametrize("thresh", [0.1, -0.5])
def test_packbits_and_unpackbits_equal_jax(thresh):
    grid = np.random.default_rng(7).uniform(-1, 1, size=(4096,)).astype(np.float32)
    want = np.asarray(jm.packbits(jnp.asarray(grid), thresh))
    got = tm.packbits(torch.from_numpy(grid), thresh)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tm.unpackbits(got).numpy(),
                                  np.asarray(jm.unpackbits(jnp.asarray(want))))
    np.testing.assert_array_equal(tm.unpackbits(got).numpy(), grid > thresh)


@pytest.mark.parametrize("radius", [2.5, 8.0])
def test_sph_from_ray_matches_jax(radius):
    rng = np.random.default_rng(8)
    o = rng.uniform(-0.5, 0.5, size=(256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)  # not unit: a = |d|^2
    want = jr.sph_from_ray(jnp.asarray(o), jnp.asarray(d), radius)
    got = tr.sph_from_ray(torch.from_numpy(o), torch.from_numpy(d), radius)
    _close(got, want)


@pytest.mark.parametrize("batched", [False, True])
def test_rays_from_pixels_matches_jax(batched):
    rng = np.random.default_rng(9)
    pix = np.stack([rng.integers(0, 40, 300), rng.integers(0, 30, 300)], -1).astype(np.int32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = q, [0.3, -1.2, 2.0]
    if batched:  # one pose per pixel
        pose = np.broadcast_to(pose, (300, 4, 4)).copy()
        pose[:, :3, 3] += rng.normal(size=(300, 3)).astype(np.float32)
    intr = np.array([35.0, 33.0, 20.5, 14.5], np.float32)
    jo, jd = jr.rays_from_pixels(jnp.asarray(pix), jnp.asarray(pose), jnp.asarray(intr))
    to, td = tr.rays_from_pixels(torch.from_numpy(pix), torch.from_numpy(pose),
                                 torch.from_numpy(intr))
    _close(to, jo)
    _close(td, jd)


@pytest.mark.parametrize("encoding,kw", [("frequency", dict(multires=6)),
                                         ("frequency", dict(multires=3, input_dim=2)),
                                         (None, {}), ("None", dict(input_dim=2))])
def test_frequency_and_identity_encoders_match_jax(encoding, kw):
    D = kw.get("input_dim", 3)
    x = np.random.default_rng(10).uniform(-2, 2, size=(128, D)).astype(np.float32)
    jenc, jdim = j_get_encoder(encoding, **kw)
    tenc, tdim = t_get_encoder(encoding, device="cpu", **kw)
    assert tdim == jdim == tenc.output_dim and not list(tenc.parameters())
    want = np.asarray(jenc.apply(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                                 jnp.asarray(x)))
    got = tenc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (128, jdim)
    for col in range(jdim // D):  # x, then sin and cos of each octave
        octave = max((col - 1) // 2, 0)
        np.testing.assert_allclose(got[:, col * D:(col + 1) * D], want[:, col * D:(col + 1) * D],
                                   atol=TOL * 2**octave, rtol=0)
