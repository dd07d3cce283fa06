"""``ops/interp.py:linspace_f32``, the port's one owner of ``jnp.linspace``'s
f32 arithmetic (``resize_bilinear`` and through it TensoRF's upsample, the
renderer's uniform lattice and ``sample_pdf``'s deterministic one), against
``jnp.linspace`` on the CPU: equal, bit for bit, on every lattice the port
makes (TensoRF's upsample list, the tests' 16 -> 31 and 20 -> 31, the
renderer's lattices at 64 and 128 samples); on the midpoint lattices of
other sample counts within one ulp, which is pinned here (XLA contracts
some sums that start off 0 into a fused multiply-add its own way). Also
``resize_bilinear`` and ``upsample_vm_params`` at 20 -> 31 equal to the JAX
package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.models import tensorf as jt
from ngp_tpu.ops import interp as ji
from ngp_tpu.training.tensorf import upsample_schedule
from ngp_tpu_torch.models import tensorf as tt
from ngp_tpu_torch.ops import interp as ti

# TensoRF's upsample list at the JAX trainer's defaults (128 -> 300 over five
# steps): each resize is linspace(0, old - 1, new)
_RES = [128] + upsample_schedule(128, 300, (2000, 3000, 4000, 5500, 7000))
LATTICES = ([(0.0, 19.0, 31), (0.0, 15.0, 31)]
            + [(0.0, a - 1.0, b) for a, b in zip(_RES[:-1], _RES[1:])]
            + [(0.5 / n, 1.0 - 0.5 / n, n) for n in (64, 128)]
            + [(0.0, 1.0, n) for n in (1, 2, 64, 128, 256)])


def _ulps(got, want):
    return np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("start,stop,num", LATTICES)
def test_linspace_f32_equals_jnp_on_the_ports_lattices(start, stop, num):
    got = ti.linspace_f32(start, stop, num)
    assert got.dtype == torch.float32 and got.shape == (num,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.linspace(start, stop, num),
                                                          np.float32))


def test_linspace_f32_over_lattice_families():
    """Equal on every resize lattice linspace(0, H - 1, n) of a sweep and on
    linspace(0, 1, n) up to 512 samples; within one ulp on the midpoint
    lattices (0.5 / n, 1 - 0.5 / n, n), the pinned difference."""
    for H in range(2, 320, 13):
        for n in range(2, 320, 11):
            np.testing.assert_array_equal(ti.linspace_f32(0.0, H - 1.0, n).numpy(),
                                          np.asarray(jnp.linspace(0.0, H - 1.0, n), np.float32))
    worst = 0
    for n in range(2, 513, 3):
        np.testing.assert_array_equal(ti.linspace_f32(0.0, 1.0, n).numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n), np.float32))
        a, b = 0.5 / n, 1.0 - 0.5 / n
        worst = max(worst, int(_ulps(ti.linspace_f32(a, b, n).numpy(),
                                     np.asarray(jnp.linspace(a, b, n), np.float32)).max()))
    assert worst <= 1


def test_fma_f32_rounds_once():
    """The one rounding of p * q + c, against exact rational arithmetic, on
    f32 values whose f64 sum can land halfway between two f32 values."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    p = rng.integers(1, 2**12, 4000).astype(np.float32)
    q = (rng.integers(1, 2**12, 4000) * 2.0**-12).astype(np.float32)
    c = (rng.integers(-2**24, 2**24, 4000) * 2.0**-30).astype(np.float32)
    # odd products of 25 bits lie halfway between two f32 values, and a c
    # below half an f64 ulp leaves their f64 sum on that midpoint
    p[:2000] = (rng.integers(2**11, 2**12, 2000) * 2 + 1).astype(np.float32)
    q[:2000] = ((rng.integers(2**10, 2**11, 2000) * 2 + 1) * 2.0**-12).astype(np.float32)
    c[:2000] = np.where(rng.random(2000) < 0.5, 2.0**-45, -2.0**-45).astype(np.float32)
    got = ti._fma_f32(p, q, c)
    naive = (p.astype(np.float64) * q + c.astype(np.float64)).astype(np.float32)
    assert (got != naive).sum() > 100  # the midpoint case is met
    for gv, pv, qv, cv in zip(got, p, q, c):
        exact = Fraction(float(pv)) * Fraction(float(qv)) + Fraction(float(cv))
        lo = np.float32(float(exact))
        # the f32 nearest the exact value, ties to even, from its neighbours
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        want = [v for v, e in zip(cands, errs) if e == best]
        if len(want) > 1:
            want = [v for v in want if int(np.float32(v).view(np.int32)) % 2 == 0]
        assert gv == want[0], (pv, qv, cv)


@pytest.mark.parametrize("align_corners", [True, False])
def test_resize_bilinear_20_to_31_matches_jax(align_corners):
    img = np.random.default_rng(7).normal(size=(3, 20, 20)).astype(np.float32)
    want = np.asarray(ji.resize_bilinear(jnp.asarray(img), (31, 31), align_corners))
    got = ti.resize_bilinear(torch.from_numpy(img), (31, 31), align_corners).numpy()
    np.testing.assert_array_equal(got, want)


def test_upsample_vm_params_20_to_31_matches_jax():
    rng = np.random.default_rng(8)
    res, new, rank = (20, 20, 20), (31, 31, 31), 3
    params = {}
    for prefix in ("sigma", "color"):
        for i in range(3):
            m0, m1 = jt.MAT_IDS[i]
            params[f"{prefix}_mat_{i}"] = rng.normal(size=(rank, res[m1], res[m0])).astype(
                np.float32)
            params[f"{prefix}_vec_{i}"] = rng.normal(size=(rank, res[jt.VEC_IDS[i]])).astype(
                np.float32)
    want = jt.upsample_vm_params({"params": {k: jnp.asarray(v) for k, v in params.items()}},
                                 new)["params"]
    got = tt.upsample_vm_params({k: torch.from_numpy(v) for k, v in params.items()}, new)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
