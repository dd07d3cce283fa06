"""The plain versions the CP run kernels are held to on the card, against
the JAX package, on the input kinds those kernels specialise on: rows
along rays (taps that repeat and change inside a warp's run of 32 rows,
coordinates of exactly 0 and 1, rows outside the box inside runs, zero
cotangent rows) and x-slices of the mesh lattice. The inputs are the card
tests' (``ray_rows``, ``ray_cotangent``, ``lattice_chunk`` in
tests/test_torch_cuda_kernels.py), at a few hundred rows, two banks and
rank 8 or 12; the Pallas kernels run in interpret mode, as
tests/test_torch_cp_backward.py and tests/test_torch_cp_encode.py run
them.

Tolerances as those files give them: factor gradients relative to the
largest entry, f32 1e-5 (summation order) and bf16 2e-2 (the Pallas
backward builds bf16 tent weights and rounds g x values to bf16); f32
features 1e-5, f32 lerps rounded once to bf16 1e-2, bf16 banks against
the Pallas kernel's bf16 tent weights 5e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.ops.pallas import cp_kernels as jk
from ngp_tpu_torch.ops.kernels import cp as tk
from test_torch_cp_kernels import _close, _j, _t
from test_torch_cuda_kernels import lattice_chunk, ray_cotangent, ray_rows

RES = (32, 64)
DTYPES = [("float32", "float32"), ("float32", "bfloat16"),
          ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


def _factors(rank, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 0.4, size=(3, r, rank)).astype(np.float32) for r in RES)


def _oob(pos):
    return ((pos < 0) | (pos > 1)).any(axis=-1)


def _close_scaled(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=tol)


@pytest.mark.parametrize("rank", [8, 12])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cp_bwd_banks_plain_on_ray_rows_matches_pallas(dtype, tol, rank):
    pos = ray_rows(300, seed=rank)
    g_cp = ray_cotangent(300, len(RES), rank, seed=rank + 1)
    assert 0 < _oob(pos).sum() < len(pos) and ((pos == 0) | (pos == 1)).any()
    assert (g_cp == 0).all(axis=1).any()
    factors = _factors(rank, seed=rank + 2)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jk._cp_bwd_banks(jnp.asarray(pos), _j(factors, jd), jnp.asarray(g_cp), RES, 128)
    got = tk.cp_bwd_banks_plain(torch.from_numpy(pos), _t(factors, td),
                                torch.from_numpy(g_cp), RES)
    for a, b in zip(got, want):
        assert a.dtype == td and tuple(a.shape) == b.shape
        _close_scaled(a.float().numpy(), np.asarray(b, np.float32), tol)


def _check_encode(pos, factors, bank_dtype, out_dtype):
    jb, tb = getattr(jnp, bank_dtype), getattr(torch, bank_dtype)
    jo, to = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    got = tk.cp_encode_plain(torch.from_numpy(pos), _t(factors, tb), RES, to)
    assert got.dtype == to and not got[torch.from_numpy(_oob(pos))].float().any()
    want = jk.cp_encode(jnp.asarray(pos), _j(factors, jb), RES, 128, jo)
    tol = {("float32", "float32"): 1e-5, ("float32", "bfloat16"): 1e-2}.get(
        (bank_dtype, out_dtype), 5e-2)
    _close(got.float(), np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("bank_dtype,out_dtype", DTYPES)
def test_cp_encode_plain_on_ray_rows_matches_pallas(bank_dtype, out_dtype):
    pos = ray_rows(300, seed=3)
    assert 0 < _oob(pos).sum() < len(pos)
    _check_encode(pos, _factors(12, seed=4), bank_dtype, out_dtype)


@pytest.mark.parametrize("bank_dtype,out_dtype", DTYPES)
def test_cp_encode_plain_on_mesh_lattice_matches_pallas(bank_dtype, out_dtype):
    """An x-slice of a 16^3 lattice: 256 rows, y and z from exactly 0 to
    exactly 1."""
    pos = lattice_chunk(16, 5)
    assert pos.shape == (256, 3) and (pos[:, 0] == pos[0, 0]).all()
    assert pos[:, 1:].min() == 0.0 and pos[:, 1:].max() == 1.0
    _check_encode(pos, _factors(8, seed=6), bank_dtype, out_dtype)


def test_lattice_chunk_is_a_save_mesh_chunk():
    """``lattice_chunk`` gives the rows ``density_grid`` feeds one chunk
    of ``NeRFNetwork.density``, scaled to [0, 1]: the same lattice and
    the same arithmetic."""
    res_l, i, b = 16, 5, 1.0
    xs = torch.as_tensor(np.linspace(-b, b, res_l, dtype=np.float32))
    pts = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), dim=-1).reshape(-1, 3)
    chunk = pts[i * res_l**2:(i + 1) * res_l**2]
    assert torch.equal(torch.from_numpy(lattice_chunk(res_l, i)), (chunk + b) / (2 * b))


def test_cp_density_bwd_passes_an_aligned_cotangent(monkeypatch):
    """The density backward hands ``cp_bwd_banks`` d(CP features) alone:
    a contiguous [M, nb*R] f32 tensor (rows 4 * nb*R bytes apart), equal
    to the CP columns of d(features) = dh1 @ w1^T."""
    rng = np.random.default_rng(7)
    rank, fd, m, h1 = 12, 2, 50, 16
    factors = _t(_factors(rank, seed=8))
    D = len(RES) * rank + 3 * (1 + 2 * fd)
    w1 = torch.from_numpy(rng.normal(0, 0.2, size=(D, h1)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(0, 0.2, size=(h1, 4)).astype(np.float32))
    pos = torch.from_numpy(ray_rows(m, seed=9))
    _, feats, hid = tk.cp_density_plain(pos, factors, w1, w2, RES, fd, residuals=True)
    g = torch.from_numpy(rng.normal(size=(m, 4)).astype(np.float32))
    seen = []
    plain = tk.cp_bwd_banks

    def spy(pos_, factors_, g_cp, resolutions):
        seen.append(g_cp)
        return plain(pos_, factors_, g_cp, resolutions)

    monkeypatch.setattr(tk, "cp_bwd_banks", spy)
    tk.cp_density_bwd(g, pos, factors, w1, w2, feats, hid, RES)
    (g_cp,) = seen
    assert g_cp.dtype == torch.float32 and g_cp.shape == (m, len(RES) * rank)
    assert g_cp.is_contiguous() and g_cp.stride(0) * 4 % 16 == 0
    dh1 = torch.where(hid > 0, g @ w2.t(), torch.zeros(()))
    torch.testing.assert_close(g_cp, (dh1 @ w1.t())[:, :len(RES) * rank], rtol=1e-6, atol=1e-6)
