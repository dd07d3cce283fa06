"""Port ops against the JAX ops on the same numpy inputs, to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.data import raysampler as jrs
from ngp_tpu.ops import activation as jact
from ngp_tpu.ops import freq as jfreq
from ngp_tpu.ops import rays as jrays
from ngp_tpu.ops import sh as jsh
from ngp_tpu_torch.data import raysampler as trs
from ngp_tpu_torch.ops import activation as tact
from ngp_tpu_torch.ops import freq as tfreq
from ngp_tpu_torch.ops import rays as trays
from ngp_tpu_torch.ops import sh as tsh

TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=TOL, rtol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def test_near_far_hits_and_both_miss_kinds():
    rng = np.random.default_rng(0)
    ro = rng.uniform(-3, 3, size=(256, 3)).astype(np.float32)
    rd = rng.normal(size=(256, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    # a slab-disjoint miss and a ray pointing away from the box
    ro[0], rd[0] = [0.0, 3.0, -3.0], [0.0, 0.0, 1.0]
    ro[1], rd[1] = [0.0, 0.0, -3.0], [0.0, 0.0, -1.0]
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    jn, jf = jrays.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(aabb), 0.05)
    tn, tf = trays.near_far_from_aabb(_t(ro), _t(rd), _t(aabb), 0.05)
    _close(tn, jn)
    _close(tf, jf)
    assert float(tn[0]) == float(tf[0]) == 1e10
    assert float(tf[1]) < float(tn[1]) < 1e10


@pytest.mark.parametrize("degree", [0, 1, 4, 6])
def test_freq_encode(degree):
    x = np.random.default_rng(1).uniform(-1, 1, size=(128, 3)).astype(np.float32)
    # XLA's and PyTorch's sin/cos differ by up to one ulp; each rung of
    # the double-angle ladder doubles that, so octave k is held to
    # 1e-6 * 2^(k-1)
    got = tfreq.freq_encode(_t(x), degree).numpy().reshape(128, -1, 3)
    want = np.asarray(jfreq.freq_encode(jnp.asarray(x), degree)).reshape(128, -1, 3)
    for col in range(got.shape[1]):
        octave = max((col - 1) // 2, 0)
        _close(got[:, col], want[:, col], atol=TOL * 2**octave)


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode(degree):
    d = np.random.default_rng(2).normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = tsh.sh_encode(_t(d), degree)
    assert got.shape == (128, degree * degree)
    _close(got, jsh.sh_encode(jnp.asarray(d), degree))


def test_trunc_exp_forward_and_grad():
    x = np.linspace(-20, 20, 81).astype(np.float32)
    g = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    jy, jvjp = jax.vjp(jact.trunc_exp, jnp.asarray(x))
    xt = _t(x).clone().requires_grad_(True)
    ty = tact.trunc_exp(xt)
    ty.backward(_t(g))
    _close(ty.detach(), jy)
    _close(xt.grad, jvjp(jnp.asarray(g))[0])


def test_rays_from_indices_and_frame_indices():
    rng = np.random.default_rng(4)
    H, W = 24, 32
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for f in range(3):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        poses[f, :3, :3] = q.astype(np.float32)
        poses[f, :3, 3] = rng.uniform(-3, 3, size=3)
    intr = np.array([30.0, 31.0, 16.0, 12.0], np.float32)
    inds = rng.integers(0, H * W, size=300).astype(np.int32)
    fids = rng.integers(0, 3, size=300).astype(np.int32)
    j = jrs.rays_from_frame_indices(jnp.asarray(poses), jnp.asarray(intr), H, W,
                                    jnp.asarray(inds), jnp.asarray(fids))
    t = trs.rays_from_frame_indices(_t(poses), _t(intr), H, W, _t(inds), _t(fids))
    _close(t["rays_o"], j["rays_o"])
    _close(t["rays_d"], j["rays_d"])
    j1 = jrs.rays_from_indices(jnp.asarray(poses[1]), jnp.asarray(intr), H, W,
                               jnp.asarray(inds))
    t1 = trs.rays_from_indices(_t(poses[1]), _t(intr), H, W, _t(inds))
    _close(t1["rays_o"], j1["rays_o"])
    _close(t1["rays_d"], j1["rays_d"])
