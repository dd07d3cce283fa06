"""The port's unfused CP encoder, its VJP, the bf16 module path of
``NeRFNetwork.density`` and the bias-free MLP chain against the JAX
package: the Pallas kernels in interpret mode (as tests/test_cp_kernels.py
and tests/test_fused_mlp.py run them) and the CPU branch of
ops/cpgrid.py.

Tolerances. f32 features: 1e-5 (the tent matmul and the gather lerp
round 1 - w differently by an ulp). bf16 output from f32 lerps: 1e-2
relative, since a last-ulp difference of the f32 feature can flip its
one rounding to bf16 (2^-8 relative). bf16 banks against the Pallas
kernel, which also rounds its tent weights to bf16: 5e-2, as
tests/test_torch_cp_kernels.py. Factor gradients: 1e-4 of the largest
entry in f32 (f32 sums in another order); in bf16 against the Pallas
backward, which rounds g x values to bf16 before its tent matmul, 1e-2.
The bf16 module path rounds at the same points as flax's bf16 Dense
layers, so a different f32 summation order can flip one bf16 rounding
of a hidden unit: 1e-2. The MLP chain: 1e-2, for the same reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.ops import cpgrid as jcp
from ngp_tpu.ops.pallas import cp_kernels as jk
from ngp_tpu.ops.pallas.fused_mlp import fused_mlp as j_fused_mlp
from ngp_tpu_torch.ops import cpgrid as tcp
from ngp_tpu_torch.ops.kernels import cp as tk
from ngp_tpu_torch.ops.kernels import fused_mlp as tmlp
from test_torch_cp_kernels import FD, RANK, RES, _close, _j, _jax_network, _port_network, _t


def _inputs(m=300, seed=21):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.1, 1.1, size=(m, 3)).astype(np.float32)
    pos[:8] = rng.uniform(0.0, 1.0, size=(8, 3))
    pos[8:12] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [1.0, 0.5, 0.0], [0.999, 1e-4, 0.5]]
    factors = tuple(rng.normal(0, 0.3, size=(3, r, RANK)).astype(np.float32) for r in RES)
    return pos, factors


def _oob(pos):
    return ((pos < 0) | (pos > 1)).any(axis=-1)


@pytest.mark.parametrize("bank_dtype,out_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "float32"), ("bfloat16", "bfloat16"),
])
def test_cp_encode_plain_matches_jax(bank_dtype, out_dtype):
    pos, factors = _inputs()
    jb, tb = getattr(jnp, bank_dtype), getattr(torch, bank_dtype)
    jo, to = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    got = tk.cp_encode_plain(torch.from_numpy(pos), _t(factors, tb), RES, to)
    assert got.dtype == to and got.shape == (pos.shape[0], len(RES) * RANK)
    oob = _oob(pos)
    assert 0 < oob.sum() < len(pos)
    assert not got[torch.from_numpy(oob)].float().any()  # zero outside the box
    pallas = jk.cp_encode(jnp.asarray(pos), _j(factors, jb), RES, 128, jo)
    assert pallas.dtype == jo
    tol = {("float32", "float32"): 1e-5, ("float32", "bfloat16"): 1e-2}.get(
        (bank_dtype, out_dtype), 5e-2)
    _close(got.float(), np.asarray(pallas, np.float32), tol)
    # the wrapper takes the plain version for CPU tensors
    fwd = tk.cp_encode_fwd(torch.from_numpy(pos), _t(factors, tb), RES, to)
    assert torch.equal(fwd, got)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_cpgrid_encode_matches_jax_cpu_branch(compute_dtype):
    pos, factors = _inputs(seed=22)
    x = pos.reshape(15, 20, 3)
    jcfg = jcp.CPGridConfig(resolutions=RES, rank=RANK, freq_degree=FD)
    tcfg = tcp.CPGridConfig(resolutions=RES, rank=RANK, freq_degree=FD)
    jd = getattr(jnp, compute_dtype) if compute_dtype else None
    td = getattr(torch, compute_dtype) if compute_dtype else None
    got = tcp.cpgrid_encode(torch.from_numpy(x), _t(factors), tcfg, td)
    want = jcp.cpgrid_encode(jnp.asarray(x), _j(factors), jcfg, jd)
    assert got.shape == (15, 20, tcfg.output_dim)
    assert got.dtype == (td or torch.float32) and np.dtype(want.dtype).name == str(got.dtype)[6:]
    _close(got.float(), np.asarray(want, np.float32), 1e-5 if td is None else 1e-2)
    # out-of-box rows: zero CP columns, freq columns kept
    flat = got.reshape(-1, tcfg.output_dim).float()
    oob = torch.from_numpy(_oob(pos))
    assert not flat[oob][:, : len(RES) * RANK].any()
    assert flat[oob][:, len(RES) * RANK:].abs().sum() > 0


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_cp_encode_vjp_matches_jax(dtype, tol):
    pos, factors = _inputs(m=260, seed=23)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    g = np.random.default_rng(24).normal(size=(pos.shape[0], len(RES) * RANK)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, f: jk.cp_encode(p, f, RES, 128, jnp.float32),
                     jnp.asarray(pos), _j(factors, jd))
    dpos_j, dfac_j = vjp(jnp.asarray(g))
    p = torch.from_numpy(pos).requires_grad_()
    fs = [f.requires_grad_() for f in _t(factors, td)]
    out = tk.cp_encode(p, fs, RES)
    assert out.grad_fn is not None and "CPEncode" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(g))
    assert not np.asarray(dpos_j).any() and not p.grad.any()
    for f, want in zip(fs, dfac_j):
        assert f.grad.dtype == td
        want = np.asarray(want, np.float32)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(f.grad.float().numpy() / scale, want / scale, atol=tol)
    # the same gradients as autograd of the plain composition (the CPU
    # branch of cpgrid_encode), f32 sums in another order
    fs2 = [f.detach().clone().requires_grad_() for f in fs]
    tk.cp_encode_plain(torch.from_numpy(pos), fs2, RES).backward(torch.from_numpy(g))
    for a, b in zip(fs, fs2):
        _close(a.grad.float(), b.grad.float(), 1e-5 if dtype == "float32" else 1e-2)


def test_cp_encode_without_grad_takes_the_forward_alone():
    pos, factors = _inputs(m=64, seed=25)
    fs = [f.requires_grad_() for f in _t(factors)]
    with torch.no_grad():
        out = tk.cp_encode(torch.from_numpy(pos), fs, RES)
    assert out.grad_fn is None
    assert torch.equal(out, tk.cp_encode_plain(torch.from_numpy(pos), fs, RES).detach())
    with pytest.raises(ValueError):
        tk.cp_encode_fwd(torch.zeros((4, 3), device="meta"), fs, RES)


def test_nerf_density_module_path_bf16_matches_jax():
    """NeRFNetwork.density (cpgrid_encode -> bf16 sigma MLP), the path
    save_mesh samples, against the JAX module in bf16."""
    from ngp_tpu.models.nerf import NeRFNetwork as JNet

    model, params, nc, rc = _jax_network(True)
    net = _port_network(params, nc, rc)
    x = np.random.default_rng(26).uniform(-1.05, 1.05, size=(200, 3)).astype(np.float32)
    with torch.no_grad():
        s, g = net.density(torch.from_numpy(x))
    s_j, g_j = model.apply(params, jnp.asarray(x), method=JNet.density)
    assert s.dtype == torch.float32 and g.dtype == torch.bfloat16
    assert g_j.dtype == jnp.bfloat16
    _close(s, s_j, 1e-2)
    _close(g.float(), np.asarray(g_j, np.float32), 1e-2)


def _mlp_inputs(B=300, dims=(32, 64, 64, 16), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, dims[0])).astype(np.float32)
    ws = [(rng.normal(size=(dims[i], dims[i + 1])) * 0.2).astype(np.float32)
          for i in range(len(dims) - 1)]
    return x, ws


def test_fused_mlp_plain_matches_jax():
    x, ws = _mlp_inputs()
    want = j_fused_mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws], tile=128, interpret=True)
    got = tmlp.fused_mlp_plain(torch.from_numpy(x), [torch.from_numpy(w) for w in ws])
    assert got.shape == (300, 16) and got.dtype == torch.float32
    _close(got, want, 1e-2)
    # the wrapper takes the plain version for CPU tensors, bf16 x too
    assert torch.equal(tmlp.fused_mlp(torch.from_numpy(x), [torch.from_numpy(w) for w in ws]),
                       got)
    xb = torch.from_numpy(x).bfloat16()
    assert torch.equal(tmlp.fused_mlp(xb, [torch.from_numpy(w) for w in ws]), got)


def test_fused_mlp_shape_validation():
    with pytest.raises(ValueError, match="weight 0"):
        tmlp.fused_mlp(torch.zeros((8, 32)), [torch.zeros((16, 64))])
    with pytest.raises(ValueError, match="weight 1"):
        tmlp.fused_mlp_plain(torch.zeros((8, 32)), [torch.zeros((32, 64)), torch.zeros((32, 4))])
    with pytest.raises(ValueError):
        tmlp.fused_mlp(torch.zeros((8, 32), device="meta"), [torch.zeros((32, 4))])
