"""The port's CP density backward against the JAX package: the factor
backward ``cp_bwd_banks_plain`` against ``_cp_bwd_banks`` (Pallas in
interpret mode), ``CPDensity`` against ``jax.grad`` of the Pallas
``cp_density``, and autograd of the port's ``cpgrid_density`` on CPU
tensors against ``jax.grad`` of the JAX CPU branch.

Tolerances, relative to the largest gradient (atol = rtol). f32: 1e-5,
summation order only (measured below 4e-7). bf16 against the JAX CPU
branch: 5e-3, since both round features, h1 and the backward's dh1 to
bf16 at the same points but another f32 summation order may flip a
rounding (measured: equal). bf16 against Pallas: 2e-2, since the
Pallas backward also builds bf16 lerp weights and rounds g * (other
axes' values) to bf16, where the port lerps and multiplies in f32 as
the JAX CPU branch does (measured 4.7e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.ops import cpgrid as jcp
from ngp_tpu.ops.pallas import cp_kernels as jk
from ngp_tpu_torch.ops import cpgrid as tcp
from ngp_tpu_torch.ops.kernels import cp as tk

RES = (32, 64)
RANK = 16
FD = 4


def _setup(m=300, seed=5, h1=32, out=8):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.1, 1.1, size=(m, 3)).astype(np.float32)
    pos[:4] = [[0.0, 0.5, 1.0], [1.0, 1.0, 1.0], [0.25, 0.0, 0.75], [0.5, 0.5, 0.5]]
    factors = tuple(rng.normal(0, 0.4, size=(3, r, RANK)).astype(np.float32) for r in RES)
    D = len(RES) * RANK + 3 * (1 + 2 * FD)
    w1 = rng.normal(0, 0.2, size=(D, h1)).astype(np.float32)
    w2 = rng.normal(0, 0.2, size=(h1, out)).astype(np.float32)
    g = rng.normal(size=(m, out)).astype(np.float32)
    return pos, factors, w1, w2, g


def _close_scaled(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cp_bwd_banks_plain_matches_pallas(dtype, tol):
    pos, factors, _, _, _ = _setup()
    g_cp = np.random.default_rng(1).normal(size=(pos.shape[0], len(RES) * RANK))
    g_cp = g_cp.astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jk._cp_bwd_banks(jnp.asarray(pos), tuple(jnp.asarray(f, jd) for f in factors),
                            jnp.asarray(g_cp), RES, 128)
    got = tk.cp_bwd_banks_plain(torch.from_numpy(pos),
                                tuple(torch.from_numpy(f).to(td) for f in factors),
                                torch.from_numpy(g_cp), RES)
    for a, b in zip(got, want):
        assert a.dtype == td and tuple(a.shape) == b.shape
        _close_scaled(a.float().numpy(), b, tol)


def test_cp_bwd_banks_out_of_box_rows_add_nothing():
    pos, factors, _, _, _ = _setup(m=64)
    pos[:, 0] = np.where(np.arange(64) % 2 == 0, -0.05, 1.05)
    g_cp = torch.ones((64, len(RES) * RANK))
    got = tk.cp_bwd_banks_plain(torch.from_numpy(pos),
                                tuple(torch.from_numpy(f) for f in factors), g_cp, RES)
    assert all(float(a.abs().max()) == 0.0 for a in got)


def _jax_grads(fn, factors, w1, w2, g):
    def loss(f, a, b):
        return jnp.vdot(fn(f, a, b), jnp.asarray(g))

    return jax.grad(loss, argnums=(0, 1, 2))(
        tuple(jnp.asarray(f) for f in factors), jnp.asarray(w1), jnp.asarray(w2)
    )


def _torch_grads(fn, factors, w1, w2, g):
    fs = [torch.from_numpy(f).requires_grad_() for f in factors]
    a = torch.from_numpy(w1).requires_grad_()
    b = torch.from_numpy(w2).requires_grad_()
    out = fn(fs, a, b)
    assert out.dtype == torch.float32
    (out * torch.from_numpy(g)).sum().backward()
    return [f.grad for f in fs], a.grad, b.grad


def _check_grads(got, want, tol):
    for a, b in zip(got[0], want[0]):
        _close_scaled(a.numpy(), b, tol)
    _close_scaled(got[1].numpy(), want[1], tol)
    _close_scaled(got[2].numpy(), want[2], tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cp_density_vjp_matches_pallas(dtype, tol):
    """CPDensity (plain versions of both kernels on CPU tensors) against
    the custom VJP of the Pallas cp_density, f32 masters cast to the
    compute dtype inside the differentiated function."""
    pos, factors, w1, w2, g = _setup()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = _jax_grads(
        lambda f, a, b: jk.cp_density(jnp.asarray(pos), tuple(x.astype(jd) for x in f),
                                      a.astype(jd), b.astype(jd), RES, FD, 128),
        factors, w1, w2, g)
    got = _torch_grads(
        lambda f, a, b: tk.CPDensity.apply(torch.from_numpy(pos), a.to(td), b.to(td), RES,
                                           FD, *[x.to(td) for x in f]),
        factors, w1, w2, g)
    _check_grads(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-3)])
def test_cpgrid_density_autograd_matches_jax_cpu_branch(dtype, tol):
    pos, factors, w1, w2, g = _setup()
    cfg_j = jcp.CPGridConfig(resolutions=RES, rank=RANK, freq_degree=FD)
    cfg_t = tcp.CPGridConfig(resolutions=RES, rank=RANK, freq_degree=FD)
    cd_j = None if dtype == "float32" else jnp.bfloat16
    cd_t = None if dtype == "float32" else torch.bfloat16
    want = _jax_grads(
        lambda f, a, b: jcp.cpgrid_density(jnp.asarray(pos), f, a, b, cfg_j, compute_dtype=cd_j),
        factors, w1, w2, g)
    got = _torch_grads(
        lambda f, a, b: tcp.cpgrid_density(torch.from_numpy(pos), f, a, b, cfg_t,
                                           compute_dtype=cd_t),
        factors, w1, w2, g)
    _check_grads(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-3)])
def test_cp_density_vjp_matches_plain_autograd(dtype, tol):
    """The custom backward equals autograd of the plain composition (the
    path CPU tensors take)."""
    pos, factors, w1, w2, g = _setup(seed=8)
    td = getattr(torch, dtype)
    p = torch.from_numpy(pos)

    def fused(f, a, b):
        return tk.CPDensity.apply(p, a.to(td), b.to(td), RES, FD, *[x.to(td) for x in f])

    def plain(f, a, b):
        return tk.cp_density_plain(p, [x.to(td) for x in f], a.to(td), b.to(td), RES, FD)

    got = _torch_grads(fused, factors, w1, w2, g)
    want = _torch_grads(plain, factors, w1, w2, g)
    _check_grads(got, ([f.numpy() for f in want[0]], want[1].numpy(), want[2].numpy()), tol)


def test_residuals_are_the_multiplied_values():
    pos, factors, w1, w2, _ = _setup()
    fs = tuple(torch.from_numpy(f).bfloat16() for f in factors)
    a, b = torch.from_numpy(w1).bfloat16(), torch.from_numpy(w2).bfloat16()
    out, feats, h1 = tk.cp_density_fwd(torch.from_numpy(pos), fs, a, b, RES, FD,
                                       residuals=True)
    assert feats.dtype == h1.dtype == torch.bfloat16
    assert feats.shape == (pos.shape[0], a.shape[0]) and h1.shape == (pos.shape[0], a.shape[1])
    assert torch.equal(out, tk.cp_density_fwd(torch.from_numpy(pos), fs, a, b, RES, FD))
    assert torch.equal(h1, torch.relu(feats.float() @ a.float()).bfloat16())
    assert torch.equal(out, h1.float() @ b.float())


def test_cp_density_takes_the_residual_free_path_without_grad():
    pos, factors, w1, w2, _ = _setup(m=40)
    fs = [torch.from_numpy(f).requires_grad_() for f in factors]
    a = torch.from_numpy(w1).requires_grad_()
    b = torch.from_numpy(w2).requires_grad_()
    p = torch.from_numpy(pos)
    assert tk.cp_density(p, fs, a, b, RES, FD).grad_fn is not None
    with torch.no_grad():
        assert tk.cp_density(p, fs, a, b, RES, FD).grad_fn is None
