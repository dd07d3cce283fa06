"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit; elsewhere they
skip. Run them there with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py``.
Tolerances as in chip_smoke.py: |kernel - plain| <= tol * (1 + |plain|),
tol 1e-4 in f32 (summation order) and 1e-2 in bf16 (a flipped bf16
rounding of a hidden unit). ``cp_bwd_banks`` sums by f32 atomics in no
fixed order: |kernel - plain| <= 2^-13 * (the sum of the absolute
contributions) + (bf16 output) 2^-7 * |plain|, a half step of each of
the two roundings to bf16. One train step through the kernels matches
the CPU plain step: loss to 1e-4 relative, each gradient to 1e-3 of
its largest entry (f32, atomics and summation order). ``cp_encode_fwd``
rounds each feature once from the same f32 lerps: the same bounds, by
output type. ``fused_mlp``: 1e-2, a flipped bf16 rounding of a hidden
unit. The module path of ``NeRFNetwork.density`` on the card against
the CPU: 1e-4 in f32. The grid encoder forward: the same bounds, by
output type. The row scatter-add (each of its branches), the taps'
factor gradient and the grid encoder's table gradient
(``grid_encode_bwd``, alone and as ``GridEncode``'s backward): f32 sums
of n terms in two orders, at most 2 (n - 1) 2^-24 times the sum of
their magnitudes; the taps' gradient also on exactly the plain
version's cells. The taps and the brick grid through their autograd
functions on the card against the CPU: values and gradients to 1e-5 of
their largest entry. The hash-grid train
step: as the cpgrid step. The grid kernels on 2-D points (the background
net's encoder) and the background net on the card against the CPU: the
same bounds; on 4-D points (D-NeRF's hyper grid), the same bounds. The
grid encoder's x-gradient (``grid_encode_bwd_x``, alone and as
``GridEncode``'s backward): its plain version sums the same terms in
another order, so 1e-4 of the largest entry in f32; with a bf16 cotangent
each corner's dot product is rounded to bf16 by both, and a rounding that
flips moves a term by one bf16 step, so 1e-2 of the largest entry. LPIPS on the card with the default cuDNN flags against the
CPU: 1e-4 relative (TF32 convolutions would miss it by about 1e-3). The
turbo march and the eval prepass round every float as their plain
versions do: equal, bit for bit. The f32 heads (3xTF32 on the tensor
cores for H1 <= 256) are held to the f32 tolerance above; their feats
residual is the features as the products split them, within 2^-22 of
f32's."""

import math

import numpy as np
import pytest
import torch

from ngp_tpu_torch.ops.kernels import LAUNCHES
from ngp_tpu_torch.ops.kernels import cp as tk
from ngp_tpu_torch.ops.kernels import fused_mlp as tmlp
from ngp_tpu_torch.ops.kernels import march as tm

import march_model

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _weights(dev, dtype, res, rank, fd, h1=64, out=16, sh=4, seed=0, scale=0.2,
             hidden=(64, 64)):
    g = torch.Generator().manual_seed(seed)
    factors = tuple((torch.randn((3, r, rank), generator=g) * scale).to(dev, dtype) for r in res)
    D = len(res) * rank + 3 * (1 + 2 * fd)
    w1 = (torch.randn((D, h1), generator=g) / D**0.5).to(dev, dtype)
    w2 = (torch.randn((h1, out), generator=g) / h1**0.5).to(dev, dtype)
    dims = [sh * sh + out - 1, *hidden, 3]
    color = tuple((torch.randn((dims[i], dims[i + 1]), generator=g) / dims[i] ** 0.5)
                  .to(dev, dtype) for i in range(len(dims) - 1))
    return factors, w1, w2, color


def _inputs(dev, M, seed=1):
    g = torch.Generator().manual_seed(seed)
    pos = (torch.rand((M, 3), generator=g) * 1.1 - 0.05).to(dev)
    dirs = torch.nn.functional.normalize(torch.randn((M, 3), generator=g), dim=-1).to(dev)
    return pos, dirs


def _check(got, want, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= TOL[dtype] * (1 + want.abs())).all(), \
        float((got - want).abs().max())


SHAPES = [((32, 64), 16, 4, 1000), ((128, 256, 512, 1024, 2048), 128, 6, 4099)]
# the density head's edges besides, with the factors' scale: one row,
# fewer 128-row tiles than SMs, a rank that is no multiple of 8 (scalar
# tail) and one that is no multiple of 4 either (the f32 heads' scalar
# gathers), eight banks with no frequency ladder (3 frequency columns),
# rank 256 on five banks (a bf16 w1 streams through shared memory a K chunk
# at a time, as every f32 w1 does), factors of std 1.5, whose CP features
# (std ~2 against ~4e-3) dominate h1, so a wrong bank, axis or tap moves the
# output past its bound, and rank 1024 on two banks (K 2075: an f32 w1 this
# long fits in shared memory neither whole nor split, and the row-block
# kernel's f32 feature rows did not fit)
DENSITY_SHAPES = [s + (0.2,) for s in SHAPES] + [
    ((32, 64), 16, 4, 1, 0.2), ((128, 256, 512, 1024, 2048), 128, 6, 300, 0.2),
    ((32, 64), 12, 2, 1000, 0.2), ((32, 64), 6, 2, 1000, 0.2),
    ((16, 24, 32, 48, 64, 96, 128, 256), 8, 0, 777, 0.2),
    ((128, 256, 512, 1024, 2048), 256, 6, 1000, 0.2),
    ((128, 256, 512, 1024, 2048), 128, 6, 4099, 1.5),
    ((32, 64), 1024, 4, 1000, 0.2),
]


def _density_bound(pos, factors, res, want):
    """With residuals, bf16: out and h1 as ``_check``; the feats are
    rounded once from f32 values both compute alike up to the order of
    f32 operations: one bf16 step (2^-7 |plain|) plus, for a CP column,
    2^-20 of the sum of its terms' magnitudes (three f32 lerps and two
    products) and, for a frequency column, 2^-14 (the double-angle ladder
    doubles a few f32 ulps of sin and cos per octave)."""
    out, feats, h1 = (w.float() for w in want)
    mag = tk.cp_features_plain(pos, [f.abs() for f in factors], res)
    slack = torch.full(feats.shape, 2.0**-14, device=feats.device)
    slack[:, :mag.shape[1]] = 2.0**-20 * mag
    tol = TOL[torch.bfloat16]
    return [tol * (1 + out.abs()), 2.0**-7 * feats.abs() + slack, tol * (1 + h1.abs())]


def _tc_route(h1, hidden=()):
    """Whether a head of these widths takes the tensor-core kernels (bf16,
    or f32 in 3xTF32)."""
    return h1 <= 256 and all(w <= 64 for w in hidden)


def _check_route(head, dtype, before, tc):
    """One launch of ``head`` since ``before``, counted under the route its
    type and widths give: ``<head>_tc`` (bf16), ``<head>_tf32x3`` (f32) or
    neither (the row-block kernel)."""
    assert LAUNCHES[head] == before[head] + 1
    for route, dt in (("_tc", torch.bfloat16), ("_tf32x3", torch.float32)):
        assert LAUNCHES[head + route] - before[head + route] == int(tc and dtype == dt), route


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,rank,fd,M,scale", DENSITY_SHAPES)
def test_cp_density_kernel(dev, dtype, res, rank, fd, M, scale):
    factors, w1, w2, _ = _weights(dev, dtype, res, rank, fd, scale=scale)
    pos, _ = _inputs(dev, M)
    before = dict(LAUNCHES)
    got = tk.cp_density_fwd(pos, factors, w1, w2, res, fd)
    _check_route("cp_density_fwd", dtype, before, _tc_route(64))
    _check(got, tk.cp_density_plain(pos, factors, w1, w2, res, fd), dtype)


TURBO = ((128, 256, 512, 1024, 2048), 128, 6)
# sigma MLPs wider than the 128-row tensor-core tiles take: 64-row tiles
# (H1 72 and 128), 32-row tiles (256) and the row-block kernel (300)
WIDE_H1 = [TURBO + (4099, 0.2, h1, 16) for h1 in (72, 128, 256, 300)] + [
    TURBO + (4099, 1.5, 128, 16), ((32, 64), 12, 2, 1000, 0.2, 200, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,rank,fd,M,scale,h1,out", WIDE_H1)
def test_cp_density_kernel_wide(dev, dtype, res, rank, fd, M, scale, h1, out):
    """Without residuals at the wide H1s; both types take the tensor-core
    kernels up to H1 = 256 and the row-block kernel above."""
    factors, w1, w2, _ = _weights(dev, dtype, res, rank, fd, h1=h1, out=out, scale=scale)
    pos, _ = _inputs(dev, M)
    before = dict(LAUNCHES)
    got = tk.cp_density_fwd(pos, factors, w1, w2, res, fd)
    _check_route("cp_density_fwd", dtype, before, _tc_route(h1))
    _check(got, tk.cp_density_plain(pos, factors, w1, w2, res, fd), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,rank,fd,M,scale,h1,out", [s + (64, 16) for s in DENSITY_SHAPES]
                         + [((32, 64), 12, 1, 333, 0.2, 20, 5),
                            ((32, 64), 16, 2, 200, 0.2, 8, 3)] + WIDE_H1)
def test_cp_density_kernel_residuals(dev, dtype, res, rank, fd, M, scale, h1, out):
    """With residuals, and hidden / output widths that are no multiple of
    16 / 8 (zero-padded in the tensor-core kernel); bf16 feats to a bf16
    step (``_density_bound``)."""
    factors, w1, w2, _ = _weights(dev, dtype, res, rank, fd, h1=h1, out=out, scale=scale)
    pos, _ = _inputs(dev, M)
    before = dict(LAUNCHES)
    got = tk.cp_density_fwd(pos, factors, w1, w2, res, fd, residuals=True)
    assert LAUNCHES["cp_density_fwd_residuals"] == before["cp_density_fwd_residuals"] + 1
    _check_route("cp_density_fwd", dtype, before, _tc_route(h1))
    want = tk.cp_density_plain(pos, factors, w1, w2, res, fd, residuals=True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
    if dtype == torch.float32:
        for a, b in zip(got, want):
            _check(a, b, dtype)
        return
    torch.cuda.synchronize()
    for i, (a, b, bound) in enumerate(zip(got, want, _density_bound(pos, factors, res, want))):
        err = (a.float() - b.float()).abs()
        assert torch.isfinite(a).all() and (err <= bound).all(), (i, float(err.max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cp_kernels_past_2_31_feature_elements(dev, dtype):
    """The uniform renderer at ``--num_steps 1024`` gives the fused density
    head 4096 x 1024 = 4,194,304 rows at the turbo-hq widths: its residual
    feats are [4,194,304, 679], 2.85e9 elements, past int32 (11.4 GB in
    f32). The kernels address rows with 64-bit offsets: the last rows'
    outputs are those of the same rows alone (to the type's bound), and the
    factor gradient of the last rows alone is that of the full call with the
    other rows' cotangent zero (to the summation-order bound). A row
    count whose positions 3 * M pass int32 raises before any launch."""
    res, rank, fd = (128, 256, 512, 1024, 2048), 128, 6
    factors, w1, w2, _ = _weights(dev, dtype, res, rank, fd)
    M, tail = 4096 * 1024, 4099
    pos = torch.rand((M, 3), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    before = dict(LAUNCHES)
    out, feats, h1 = tk.cp_density_fwd(pos, factors, w1, w2, res, fd, residuals=True)
    _check_route("cp_density_fwd", dtype, before, True)
    assert feats.numel() >= 2**31
    last = tk.cp_density_fwd(pos[-tail:].contiguous(), factors, w1, w2, res, fd, residuals=True)
    torch.cuda.synchronize()
    for a, b in zip((out, feats, h1), last):
        _check(a[-tail:].float(), b.float(), dtype)
    del out, feats, h1, last
    nbR = len(res) * rank
    g = torch.zeros((M, nbR), device=dev)
    g[-tail:] = torch.randn((tail, nbR), generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    full = tk.cp_bwd_banks(pos, factors, g, res)
    alone = tk.cp_bwd_banks(pos[-tail:].contiguous(), factors, g[-tail:].contiguous(), res)
    for a, b, bound in zip(full, alone, bwd_bound(pos[-tail:].contiguous(), factors,
                                                  g[-tail:].contiguous(), res, alone)):
        assert ((a.float() - b.float()).abs() <= bound).all()
    del g, full
    big = torch.empty((2**31 // 3 + 1, 3), device=dev)
    with pytest.raises(ValueError, match="int row arithmetic"):
        tk.cp_density_fwd(big, factors, w1, w2, res, fd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cp_heads_take_no_rows(dev, dtype):
    """M = 0 on either route: empty outputs of the right shapes and types,
    no launch counted; a shape no kernel takes still raises at M = 0."""
    for h1 in (64, 300):
        factors, w1, w2, color = _weights(dev, dtype, (32, 64), 16, 4, h1=h1)
        pos, dirs = _inputs(dev, 0)
        before = dict(LAUNCHES)
        out, feats, h1_ = tk.cp_density_fwd(pos, factors, w1, w2, (32, 64), 4, residuals=True)
        rgb = tk.cp_sigma_rgb(pos, dirs, factors, w1, w2, color, (32, 64), 4, 4)
        assert LAUNCHES == before
        assert out.shape == (0, 16) and out.dtype == torch.float32
        assert feats.shape == (0, w1.shape[0]) and h1_.shape == (0, h1)
        assert feats.dtype == h1_.dtype == dtype and rgb.shape == (0, 4)
    factors, w1, w2, _ = _weights(dev, dtype, (32, 64), 16, 4, h1=2048)
    with pytest.raises(ValueError, match="shared memory"):
        tk.cp_density_fwd(pos, factors, w1, w2, (32, 64), 4)


def bwd_bound(pos, factors, g_cp, res, want):
    """The summation-order bound of cp_bwd_banks against its plain version."""
    s_abs = tk.cp_bwd_banks_plain(pos, [f.abs() for f in factors], g_cp.abs(), res)
    ulp = 2.0**-7 if factors[0].dtype == torch.bfloat16 else 0.0
    return [2.0**-13 * s.float() + ulp * w.float().abs() for s, w in zip(s_abs, want)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,rank,fd,M", SHAPES)
def test_cp_bwd_banks_kernel(dev, dtype, res, rank, fd, M):
    factors, _, _, _ = _weights(dev, dtype, res, rank, fd)
    pos, _ = _inputs(dev, M)
    g = torch.randn((M, len(res) * rank + 7), generator=torch.Generator().manual_seed(2))
    g_cp = g.to(dev)[:, : len(res) * rank]  # a row stride wider than the columns
    before = LAUNCHES["cp_bwd_banks"]
    got = tk.cp_bwd_banks(pos, factors, g_cp, res)
    torch.cuda.synchronize()
    assert LAUNCHES["cp_bwd_banks"] == before + 1
    want = tk.cp_bwd_banks_plain(pos, factors, g_cp, res)
    for a, b, bound in zip(got, want, bwd_bound(pos, factors, g_cp, res, want)):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.isfinite(a).all()
        assert ((a.float() - b.float()).abs() <= bound).all()


def ray_rows(m, seed):
    """[m, 3] f32 positions in runs along rays, as a train step's
    compacted samples: each ray 1-12 consecutive rows, 0.002-0.02 apart
    along a random direction from a random start in the box, so the
    coarse banks' taps repeat and change inside a run of 32 rows. Rays
    that leave the box put rows outside it inside runs, and about one
    row in 30 has a coordinate of exactly 0 or 1."""
    rng = np.random.default_rng(seed)
    rays, n = [], 0
    while n < m:
        k = int(rng.integers(1, 13))
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        start = rng.uniform(0.0, 1.0, 3)
        rays.append(start + rng.uniform(0.002, 0.02) * np.arange(k)[:, None] * d)
        n += k
    pos = np.concatenate(rays)[:m].astype(np.float32)
    edge = rng.choice(m, size=max(1, m // 30), replace=False)
    pos[edge, rng.integers(0, 3, edge.size)] = rng.choice([0.0, 1.0], edge.size)
    return pos


def ray_cotangent(m, nb, rank, seed):
    """[m, nb * rank] f32 normal cotangent with zero rows: about one in
    five, a run of 40, and one bank's columns alone in about one in
    ten."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(m, nb * rank)).astype(np.float32)
    g[rng.random(m) < 0.2] = 0.0
    g[m // 3:m // 3 + 40] = 0.0
    for i in np.flatnonzero(rng.random(m) < 0.1):
        b = int(rng.integers(0, nb))
        g[i, b * rank:(b + 1) * rank] = 0.0
    return g


def lattice_chunk(res_l, i):
    """x-slice i of the ``ij`` lattice of linspace(-1, 1, res_l) per axis,
    scaled to [0, 1] as ``NeRFNetwork.density`` scales it: the rows of one
    ``save_mesh`` chunk at res_l = 256 (x constant, y changing every
    res_l rows, z fastest)."""
    xs = np.linspace(-1.0, 1.0, res_l, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs[i:i + 1], xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)
    return (pts + np.float32(1.0)) / np.float32(2.0)


# rows along rays at the run kernels' edges: rank 6 (no multiple of 4: the
# scalar-column instance), rank 12, one row, a ragged row count, rank 256
# (two column groups of 128), and the turbo-hq banks
RUN_SHAPES = [((32, 64), 6, 777), ((32, 64), 12, 1000), ((32, 64), 16, 1), ((32, 64), 16, 33),
              ((128, 256), 256, 2000), ((128, 256, 512, 1024, 2048), 128, 4099)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,rank,M", RUN_SHAPES)
def test_cp_bwd_banks_kernel_on_ray_rows(dev, dtype, res, rank, M):
    """Rows along rays (``ray_rows``) with zero cotangent rows
    (``ray_cotangent``), g contiguous as the density backward passes it."""
    factors, _, _, _ = _weights(dev, dtype, res, rank, 0)
    pos = torch.from_numpy(ray_rows(M, seed=M)).to(dev)
    g_cp = torch.from_numpy(ray_cotangent(M, len(res), rank, seed=M + 1)).to(dev)
    before = LAUNCHES["cp_bwd_banks"]
    got = tk.cp_bwd_banks(pos, factors, g_cp, res)
    torch.cuda.synchronize()
    assert LAUNCHES["cp_bwd_banks"] == before + 1
    want = tk.cp_bwd_banks_plain(pos, factors, g_cp, res)
    for a, b, bound in zip(got, want, bwd_bound(pos, factors, g_cp, res, want)):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.isfinite(a).all()
        assert ((a.float() - b.float()).abs() <= bound).all()


def _check_encode(pos, factors, res, out_dtype):
    before = LAUNCHES["cp_encode_fwd"]
    got = tk.cp_encode_fwd(pos, factors, res, out_dtype)
    assert LAUNCHES["cp_encode_fwd"] == before + 1
    want = tk.cp_encode_plain(pos, factors, res, out_dtype)
    assert got.dtype == out_dtype and got.shape == want.shape
    oob = ((pos < 0) | (pos > 1)).any(dim=-1)
    assert not got[oob].float().any()
    _check(got.float(), want.float(), out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,rank,M", RUN_SHAPES)
def test_cp_encode_kernel_on_ray_rows(dev, dtype, out_dtype, res, rank, M):
    factors, _, _, _ = _weights(dev, dtype, res, rank, 0)
    _check_encode(torch.from_numpy(ray_rows(M, seed=M)).to(dev), factors, res, out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,rank,res_l,i", [((32, 64), 12, 64, 17),
                                              ((128, 256, 512, 1024, 2048), 128, 256, 128)])
def test_cp_encode_kernel_on_mesh_lattice(dev, dtype, out_dtype, res, rank, res_l, i):
    """One x-slice of the mesh lattice (``lattice_chunk``): a save_mesh
    chunk of 65,536 rows on the turbo-hq banks, and a small one."""
    factors, _, _, _ = _weights(dev, dtype, res, rank, 0)
    _check_encode(torch.from_numpy(lattice_chunk(res_l, i)).to(dev), factors, res, out_dtype)


# the radiance head's shapes: (res, rank, fd, M, scale, h1, out, sh degree,
# colour hidden widths). The density edges (one row, a ragged row count,
# rank 12, rank 256 with w1 streamed, factors of std 1.5), H1 = 128, 256 and
# 300 (the row-block kernel), SH degrees 1 and 8, 1-4 colour layers, widths
# that are no multiple of 16 (H1 20, 5 outputs, hidden 20 / 40 / 24), and a
# colour layer of 80 (past the tensor-core kernel's 64: the row-block kernel)
SIGMA_RGB_SHAPES = [s + (0.2, 64, 16, 4, (64, 64)) for s in SHAPES] + [
    TURBO + (1, 0.2, 64, 16, 4, (64, 64)),
    TURBO + (24575, 0.2, 64, 16, 4, (64, 64)),
    ((32, 64), 12, 2, 1000, 0.2, 64, 16, 4, (64, 64)),
    TURBO[:1] + (256, 6, 1000, 0.2, 64, 16, 4, (64, 64)),
    TURBO + (4099, 1.5, 64, 16, 4, (64, 64)),
    TURBO + (4099, 0.2, 128, 16, 3, (64,)),
    TURBO + (2000, 0.2, 256, 16, 4, (64, 64)),
    TURBO + (2000, 0.2, 300, 16, 4, (64, 64)),
    ((32, 64), 16, 4, 1000, 0.2, 64, 16, 1, (64, 64)),
    ((32, 64), 16, 4, 1000, 0.2, 64, 16, 8, (64, 64)),
    ((32, 64), 16, 4, 1000, 0.2, 64, 16, 4, ()),
    ((32, 64), 16, 4, 1000, 0.2, 64, 16, 4, (40, 24, 64)),
    ((32, 64), 12, 1, 777, 0.2, 20, 5, 2, (20,)),
    ((32, 64), 16, 4, 1000, 0.2, 64, 16, 4, (80, 64)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,rank,fd,M,scale,h1,out,sh,hidden", SIGMA_RGB_SHAPES)
def test_cp_sigma_rgb_kernel(dev, dtype, res, rank, fd, M, scale, h1, out, sh, hidden):
    factors, w1, w2, color = _weights(dev, dtype, res, rank, fd, h1=h1, out=out, sh=sh,
                                      scale=scale, hidden=hidden)
    pos, dirs = _inputs(dev, M)
    before = dict(LAUNCHES)
    got = tk.cp_sigma_rgb(pos, dirs, factors, w1, w2, color, res, fd, sh)
    _check_route("cp_sigma_rgb", dtype, before, _tc_route(h1, hidden))
    _check(got, tk.cp_sigma_rgb_plain(pos, dirs, factors, w1, w2, color, res, fd, sh), dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,rank,fd,M", SHAPES)
def test_cp_encode_kernel(dev, dtype, out_dtype, res, rank, fd, M):
    factors, _, _, _ = _weights(dev, dtype, res, rank, fd)
    pos, _ = _inputs(dev, M)
    _check_encode(pos, factors, res, out_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,rank,fd,M", SHAPES)
def test_cp_encode_backward_kernel(dev, dtype, res, rank, fd, M):
    factors, _, _, _ = _weights(dev, dtype, res, rank, fd)
    pos, _ = _inputs(dev, M)
    g = torch.randn((M, len(res) * rank), generator=torch.Generator().manual_seed(3)).to(dev)
    fk = [f.clone().requires_grad_() for f in factors]
    fp = [f.clone().requires_grad_() for f in factors]
    before = LAUNCHES["cp_bwd_banks"]
    tk.cp_encode(pos, fk, res).backward(g)
    torch.cuda.synchronize()
    assert LAUNCHES["cp_bwd_banks"] == before + 1
    tk.cp_encode_plain(pos, fp, res).backward(g)
    want = [f.grad for f in fp]
    for a, b, bound in zip(fk, want, bwd_bound(pos, factors, g, res, want)):
        assert a.grad.dtype == dtype and torch.isfinite(a.grad).all()
        assert ((a.grad.float() - b.float()).abs() <= bound).all()


# the package's MLPs (density 32-64-64-16, colour 31-64-64-3, hash sigma
# 32-64-16), one layer, eight layers, widths of 128 (the tensor cores' widest)
# and 200 (the CUDA-core route)
MLP_WIDTHS = [[32, 64, 64, 16], [31, 64, 64, 3], [32, 64, 16], [32, 16],
              [32, 64, 64, 64, 64, 64, 64, 64, 16], [128, 128, 128, 128], [32, 200, 16]]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [0, 1, 300, 4099])
@pytest.mark.parametrize("dims", MLP_WIDTHS, ids=lambda d: "-".join(map(str, d)))
def test_fused_mlp_kernel(dev, x_dtype, B, dims):
    g = torch.Generator().manual_seed(B)
    x = torch.randn((B, dims[0]), generator=g).to(dev, x_dtype)
    ws = [(torch.randn((dims[i], dims[i + 1]), generator=g) * (2.0 / dims[i]) ** 0.5).to(dev)
          for i in range(len(dims) - 1)]
    before = dict(LAUNCHES)
    got = tmlp.fused_mlp(x, ws)
    assert LAUNCHES["fused_mlp"] == before["fused_mlp"] + int(B > 0)
    tc = B > 0 and max(dims) <= 128
    assert LAUNCHES["fused_mlp_tc"] == before["fused_mlp_tc"] + int(tc)
    assert got.dtype == torch.float32 and got.shape == (B, dims[-1])
    _check(got, tmlp.fused_mlp_plain(x, ws), torch.bfloat16)


def test_density_module_path_on_the_card(dev):
    """NeRFNetwork.density (cpgrid_encode -> sigma MLP) runs on the card
    through cp_encode_fwd and matches the CPU module path in f32."""
    from ngp_tpu_torch.config import NetworkConfig, RenderConfig
    from ngp_tpu_torch.models.nerf import NeRFNetwork

    rc = RenderConfig(bound=1.0, turbo=True)
    nc = NetworkConfig(encoding="cpgrid", use_bf16=False, cp_resolutions=(32, 64),
                       cp_rank=16, cp_freq_degree=4, sh_degree=3)
    cpu = NeRFNetwork(nc, rc, torch.Generator().manual_seed(0), device="cpu")
    gpu = NeRFNetwork(nc, rc)
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    x = torch.rand((5000, 3), generator=torch.Generator().manual_seed(4)) * 2.1 - 1.05
    before = LAUNCHES["cp_encode_fwd"]
    with torch.no_grad():
        s_g, g_g = gpu.density(x.to(dev))
        s_c, g_c = cpu.density(x)
    assert LAUNCHES["cp_encode_fwd"] == before + 1
    _check(s_g.cpu(), s_c, torch.float32)
    _check(g_g.cpu(), g_c, torch.float32)


@pytest.mark.parametrize("R", [32, 64])
def test_coarse_lookup_kernel_bits(dev, R):
    g = torch.Generator().manual_seed(R)
    payload = torch.randint(0, 256, (R, 128), generator=g).float().to(dev)
    fc = torch.randint(-5, R * 1024 + 5, (333, 77), generator=g, dtype=torch.int32).to(dev)
    assert torch.equal(tm.coarse_lookup_bits(payload, fc), tm.coarse_lookup_plain(payload, fc))


# the CPU tests' cases (march_model.CASES), and a turbo-hq march: grid 128,
# 256 probes, 96 candidates, 16 crossings, 32 samples, 4096 rays
MARCH_CASES = list(march_model.CASES) + ["turbo-hq"]


def _march_case(name, dev):
    """(config, state on the card, rays, noise, t_range) of a march case,
    all made from seeds with numpy."""
    from ngp_tpu_torch.config import RenderConfig
    from ngp_tpu_torch.models import occupancy as to

    if name == "turbo-hq":
        kw, frac, kind, noisy, clipped = (dict(max_steps=256, max_samples_per_ray=32,
                                               grid_size=128, coarse_candidates=96,
                                               crossing_slots=16), 0.05, "box", True, False)
        n = 4096
    else:
        kw, frac, kind, noisy, clipped = march_model.CASES[name]
        n = 96
    cfg = RenderConfig(**march_model.config(kw))
    occ, dens = march_model.grids(cfg, frac=frac)
    coarse, fine = to.pack_occupancy_payloads(torch.from_numpy(occ).to(dev),
                                              torch.from_numpy(dens).to(dev))
    ro, rd = march_model.rays(kind, n=n, bound=cfg.bound)
    noise = np.random.default_rng(5).random(n).astype(np.float32) if noisy else None
    tr = march_model.t_ranges(n) if clipped else None
    return cfg, coarse, fine, ro, rd, noise, tr


def _on(a, dev):
    return None if a is None else torch.from_numpy(a).to(dev)


@pytest.mark.parametrize("box", ["config", "tensor"])
@pytest.mark.parametrize("name", MARCH_CASES)
def test_march_turbo_kernel(dev, name, box):
    """The kernel gives the plain version's samples bit for bit; with the
    transmittance proxy a ray may differ only where the proxy's sum lies
    within 1e-5 of its threshold (the two add in other orders)."""
    from ngp_tpu_torch.models import occupancy as to

    cfg, coarse, fine, ro, rd, noise, tr = _march_case(name, dev)
    S, K2, U = to.turbo_budgets(cfg)
    aabb = None if box == "config" else torch.tensor(cfg.aabb, device=dev) * 0.9
    args = (_on(ro, dev), _on(rd, dev), coarse, fine, cfg, S, K2, U)
    kw = dict(aabb=aabb, t_range=_on(tr, dev), noise=_on(noise, dev))
    before = LAUNCHES["march_turbo"]
    got = tm.march_turbo(*args, **kw)
    assert LAUNCHES["march_turbo"] == before + 1
    want = tm.march_turbo_plain(*args, **kw)
    torch.cuda.synchronize()
    for k in ("nears", "fars", "ts", "deltas", "mask", "n_total", "n_dropped"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    differ = ((got["ts"] != want["ts"]) | (got["mask"] != want["mask"])
              | (got["deltas"] != want["deltas"])).any(dim=1) | (got["n_total"] != want["n_total"])
    if cfg.t_proxy_thresh is not None:
        model = march_model.march_model(
            ro, rd, coarse.cpu().numpy(), fine.cpu().numpy(), cfg, S, K2, U,
            aabb=None if aabb is None else aabb.cpu().numpy(), t_range=tr, noise=noise)
        assert (torch.from_numpy(model["approach"]) <= 1e-5)[differ.cpu()].all()
    else:
        assert not differ.any(), int(differ.sum())
    keep = ~differ
    assert torch.equal(got["nears"], want["nears"]) and torch.equal(got["fars"], want["fars"])
    assert torch.allclose(got["n_dropped"][keep], want["n_dropped"][keep], rtol=1e-6, atol=0)
    assert int(got["mask"].sum()) > 0


# the CPU tests' prepass cases (march_model.PREPASS_CASES), and one at grid
# 128 with 4096 rays
PREPASS_CASES = list(march_model.PREPASS_CASES) + ["grid 128"]


@pytest.mark.parametrize("box", ["config", "tensor"])
@pytest.mark.parametrize("name", PREPASS_CASES)
def test_ray_prepass_kernel(dev, name, box):
    """The prepass kernel gives the plain version's hit, t0, t1, nears and
    fars bit for bit, the box given on the host or as a tensor on the
    card."""
    from ngp_tpu_torch.config import RenderConfig
    from ngp_tpu_torch.models import occupancy as to

    if name == "grid 128":
        changes, frac, kind, aabb, n = dict(grid_size=128, max_steps=256), 0.002, "box", None, 4096
    else:
        (changes, frac, kind, aabb), n = march_model.PREPASS_CASES[name], 200
    cfg = RenderConfig(**march_model.config(changes))
    occ, _ = march_model.grids(cfg, frac=frac)
    payload = to.pack_prepass_payload(torch.from_numpy(occ).to(dev))
    ro, rd = march_model.rays(kind, n=n, seed=2, bound=cfg.bound)
    ro, rd = _on(ro, dev), _on(rd, dev)
    if box == "tensor":
        aabb = torch.tensor(cfg.aabb if aabb is None else aabb, device=dev)
    before = LAUNCHES["ray_prepass"]
    got = tm.ray_prepass_kernel(ro, rd, payload, cfg, aabb=aabb)
    assert LAUNCHES["ray_prepass"] == before + 1
    want = tm.ray_prepass_plain(ro, rd, payload, cfg, aabb=aabb)
    torch.cuda.synchronize()
    assert set(got) == set(want) == {"hit", "t0", "t1", "nears", "fars"}
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), (k, int((got[k] != want[k]).sum()))
    assert 0 < int(got["hit"].sum()) < n


def test_ray_prepass_kernel_no_rays_and_wide_payload(dev):
    from ngp_tpu_torch.config import RenderConfig

    cfg = RenderConfig(**march_model.config({}))
    empty = torch.zeros((0, 3), device=dev)
    before = LAUNCHES["ray_prepass"]
    out = tm.ray_prepass_kernel(empty, empty, torch.zeros((1, 128), device=dev), cfg)
    assert LAUNCHES["ray_prepass"] == before
    assert set(out) == {"hit", "t0", "t1", "nears", "fars"}
    assert all(v.shape == (0,) for v in out.values()) and out["hit"].dtype == torch.bool
    # a payload past a block's shared memory (grid 512, 4 cascades), with and
    # without rays
    for rays in (empty, torch.ones((8, 3), device=dev)):
        with pytest.raises(ValueError, match="shared memory"):
            tm.ray_prepass_kernel(rays, rays, torch.zeros((2048, 128), device=dev), cfg)
    with pytest.raises(ValueError):
        tm.ray_prepass_kernel(empty, empty, torch.zeros((1, 64), device=dev), cfg)
    assert LAUNCHES["ray_prepass"] == before


def test_march_turbo_kernel_no_rays_and_wide_payload(dev):
    from ngp_tpu_torch.config import RenderConfig

    cfg = RenderConfig(**march_model.config({}))
    empty = torch.zeros((0, 3), device=dev)
    fine = torch.zeros((64, 18), dtype=torch.int64, device=dev)
    out = tm.march_turbo(empty, empty, torch.zeros((1, 128), device=dev), fine, cfg, 16, 32, 8)
    assert out["ts"].shape == (0, 16) and out["n_total"].shape == (0,)
    # a coarse payload past a block's shared memory (grid 512, 4 cascades)
    with pytest.raises(ValueError, match="shared memory"):
        tm.march_turbo(empty, empty, torch.zeros((2048, 128), device=dev), fine, cfg, 16, 32, 8)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    factors, w1, w2, _ = _weights(dev, torch.float32, (32, 64), 16, 4)
    pos, _ = _inputs(dev, 64)
    with pytest.raises(ValueError):
        tk.cp_density_fwd(pos.double(), factors, w1, w2, (32, 64), 4)
    with pytest.raises(ValueError):
        tk.cp_density_fwd(pos, factors, w1.bfloat16(), w2, (32, 64), 4)
    with pytest.raises(ValueError):
        tk.cp_density_fwd(pos, factors, w1, w2, (32, 64), 3)
    # shared memory past a block's in both kernels, of either type: an H1 of
    # 2048 (the row-block kernel's route), a w2 of 2000 columns
    for dt in (torch.bfloat16, torch.float32):
        fb, w1b, w2b, _ = _weights(dev, dt, (32, 64), 16, 4, h1=2048)
        with pytest.raises(ValueError, match="shared memory"):
            tk.cp_density_fwd(pos, fb, w1b, w2b, (32, 64), 4)
        fb, w1b, _, _ = _weights(dev, dt, (32, 64), 16, 4)
        w2b = torch.zeros((64, 2000), dtype=dt, device=dev)
        with pytest.raises(ValueError, match="shared memory"):
            tk.cp_density_fwd(pos, fb, w1b, w2b, (32, 64), 4)
    with pytest.raises(ValueError):
        tm.coarse_lookup_bits(torch.zeros((4, 128), device=dev),
                              torch.zeros((8, 2), dtype=torch.int32, device=dev).t())
    g = torch.zeros((64, 32), device=dev)
    with pytest.raises(ValueError):
        tk.cp_bwd_banks(pos, factors, g[:, :16], (32, 64))
    with pytest.raises(ValueError):
        tk.cp_bwd_banks(pos, factors, g.t().contiguous().t(), (32, 64))
    with pytest.raises(ValueError):
        tk.cp_encode_fwd(pos, factors, (32, 64), torch.float16)
    with pytest.raises(ValueError):
        tk.cp_encode_fwd(pos, (factors[0], factors[1].bfloat16()), (32, 64))
    with pytest.raises(ValueError):
        tk.cp_encode_fwd(pos[:, :2].contiguous(), factors, (32, 64))
    with pytest.raises(ValueError, match="weight 0"):
        tmlp.fused_mlp(pos, [torch.zeros((4, 8), device=dev)])
    with pytest.raises(ValueError):
        tmlp.fused_mlp(pos.double(), [torch.zeros((3, 8), device=dev)])
    # a chain neither route's shared memory holds
    with pytest.raises(ValueError, match="shared memory"):
        tmlp.fused_mlp(pos, [torch.zeros((3, 1024), device=dev),
                             torch.zeros((1024, 1024), device=dev)])


def test_kernels_on_the_render_path(dev):
    """A tiny GPU frame goes through the eval kernels (the heads, the march,
    the prepass) and matches the same frame rendered on the CPU through the
    plain versions; the prepass no longer launches the lookup alone."""
    from ngp_tpu_torch.config import NetworkConfig, RenderConfig
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

    rc = RenderConfig(bound=1.0, min_near=0.05, max_steps=64, max_samples_per_ray=16,
                      grid_size=16, density_thresh=10.0, turbo=True, coarse_candidates=48)
    nc = NetworkConfig(encoding="cpgrid", use_bf16=False, cp_resolutions=(32, 64),
                       cp_rank=16, cp_freq_degree=4, sh_degree=3)
    cpu_model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(0), device="cpu")
    gpu_model = NeRFNetwork(nc, rc)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_tr = GridNeRFTrainer(gpu_model.to(dev), rc)
    reset_launch_counts()
    for _ in range(2):
        gpu_tr._update_occupancy()
    cpu_tr = GridNeRFTrainer(cpu_model, rc)
    cpu_tr.aux = {"occ": gpu_tr.aux["occ"].to("cpu")}
    for tr in (cpu_tr, gpu_tr):
        tr.eval_f32_frames = True
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.5
    intr = np.array([40.0, 40.0, 16.0, 16.0], np.float32)
    img_g, _ = gpu_tr.render_frame(pose, intr, 32, 32, chunk=256)
    counts = launch_counts()
    # the march is one kernel, and so is the prepass
    assert all(counts[k] > 0 for k in ("cp_density_fwd", "cp_sigma_rgb", "march_turbo",
                                       "ray_prepass")), counts
    assert counts["coarse_lookup_bits"] == 0, counts
    img_c, _ = cpu_tr.render_frame(pose, intr, 32, 32, chunk=256)
    assert np.abs(img_g - img_c).mean() <= 1e-4


def test_train_step_on_the_card_matches_cpu(dev, tmp_path):
    """One f32 train step through the kernels (the residual forward, the
    factor backward, the march) against the same step on the CPU
    through the plain versions: same weights, grid, frames and draws."""
    import copy

    from ngp_tpu_torch.config import NetworkConfig, RenderConfig, TrainConfig
    from ngp_tpu_torch.data.synthetic import make_synthetic_frames
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

    rc = RenderConfig(bound=1.0, min_near=0.05, max_steps=64, max_samples_per_ray=16,
                      grid_size=16, density_thresh=10.0, turbo=True, coarse_candidates=48,
                      compact_mean_samples=6)
    nc = NetworkConfig(encoding="cpgrid", use_bf16=False, cp_resolutions=(32, 64),
                       cp_rank=16, cp_freq_degree=4, sh_degree=3)
    tc = TrainConfig(num_rays=1024, workspace=str(tmp_path))
    frames = make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=32, W=32)["train"]
    cpu_model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(0), device="cpu")
    gpu_tr = GridNeRFTrainer(copy.deepcopy(cpu_model).to(dev), rc, tc)
    for _ in range(2):
        gpu_tr._update_occupancy()
    cpu_tr = GridNeRFTrainer(cpu_model, rc, tc)
    cpu_tr.aux = {"occ": gpu_tr.aux["occ"].to("cpu")}
    g = torch.Generator().manual_seed(1)
    draws = {"inds": torch.randint(0, 32 * 32, (1024,), generator=g),
             "bg": torch.rand((1024, 3), generator=g), "noise": torch.rand((1024,), generator=g)}
    batch = {"images": torch.from_numpy(frames.images), "poses": torch.from_numpy(frames.poses),
             "intrinsics": torch.from_numpy(frames.intrinsics), "idx": 1}
    reset_launch_counts()
    mg = gpu_tr.train_step({k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()},
                           {k: v.to(dev) for k, v in draws.items()})
    counts = launch_counts()
    for name in ("cp_density_fwd_residuals", "cp_bwd_banks", "march_turbo"):
        assert counts[name] > 0, counts
    assert counts["coarse_lookup_bits"] == 0 and counts["ray_prepass"] == 0, counts
    mc = cpu_tr.train_step(batch, draws)
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4 * float(mc["loss"])
    cpu_grads = dict(cpu_tr.model.named_parameters())
    for name, p in gpu_tr.model.named_parameters():
        want = cpu_grads[name].grad
        assert float((p.grad.cpu() - want).abs().max()) <= 1e-3 * float(want.abs().max()), name


# ---------------------------------------------------------------------------
# the hash-grid encoder and the row scatter-add
# ---------------------------------------------------------------------------

GRIDS = {
    "full": dict(desired_resolution=2048),  # 16 levels x 2, 2^19 rows per level
    "tiled": dict(num_levels=4, base_resolution=4, log2_hashmap_size=10, desired_resolution=64,
                  gridtype="tiled"),
    "smooth4": dict(num_levels=3, level_dim=4, base_resolution=5, log2_hashmap_size=12,
                    per_level_scale=1.7, interpolation="smoothstep", align_corners=True),
}


# 2-D grids: the background net's encoder (4 levels x 2, the finest hashed
# at 2^19 rows), a tiled one and a smoothstep one with 4 features
GRIDS_2D = {
    "bg": dict(input_dim=2, num_levels=4, log2_hashmap_size=19, desired_resolution=2048),
    "tiled2": dict(input_dim=2, num_levels=3, base_resolution=4, log2_hashmap_size=10,
                   desired_resolution=64, gridtype="tiled"),
    "smooth2": dict(input_dim=2, num_levels=3, level_dim=4, base_resolution=5,
                    log2_hashmap_size=8, per_level_scale=1.7, interpolation="smoothstep",
                    align_corners=True),
}


def _grid(name, dev, dtype=torch.float32, seed=0):
    from ngp_tpu_torch.ops.hashgrid import GridConfig

    cfg = GridConfig(**{**GRIDS, **GRIDS_2D}[name])
    g = torch.Generator().manual_seed(seed)
    table = (torch.rand((cfg.num_rows, cfg.level_dim), generator=g) * 2 - 1).to(dev, dtype)
    return cfg, table


def scatter_bound(idx, rows, num_rows):
    """f32 sums of n terms in any two orders differ by at most
    2 (n - 1) 2^-24 times the sum of the terms' magnitudes."""
    from ngp_tpu_torch.ops.kernels import scatter as ks

    adds = ks.scatter_add_rows_plain(idx, torch.ones_like(rows),
                                     torch.zeros((num_rows, rows.shape[1]), device=rows.device))
    s_abs = ks.scatter_add_rows_plain(idx, rows.abs(),
                                      torch.zeros((num_rows, rows.shape[1]), device=rows.device))
    return 2.0 * 2.0**-24 * adds * s_abs + 1e-30


def _ray_points(dev, n_rays=40, samples=128, seed=7):
    """Points as the v1 march gives them: consecutive samples of one ray
    (neighbouring lanes share their coarse cells), some outside [0, 1]^3."""
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n_rays, 1, 3), generator=g) * 0.4 - 0.2
    d = torch.nn.functional.normalize(torch.rand((n_rays, 1, 3), generator=g) + 0.2, dim=-1)
    t = torch.linspace(0.0, 1.9, samples)[None, :, None]
    return (o + t * d).reshape(-1, 3).contiguous().to(dev)


@pytest.mark.parametrize("points", ["random", "rays"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_encode_fwd_kernel(dev, name, table_dtype, out_dtype, points):
    from ngp_tpu_torch.ops.kernels import hashgrid as kh

    cfg, table = _grid(name, dev, table_dtype)
    pos = _inputs(dev, 5001)[0] if points == "random" else _ray_points(dev)
    before = LAUNCHES["grid_encode_fwd"]
    got = kh.grid_encode_fwd(pos, table, cfg.geometry, out_dtype)
    assert LAUNCHES["grid_encode_fwd"] == before + 1
    want = kh.grid_encode_plain(pos, table, cfg.geometry, out_dtype)
    assert got.dtype == out_dtype and got.shape == (pos.shape[0], cfg.output_dim)
    oob = ((pos < 0) | (pos > 1)).any(dim=-1)
    assert not got[oob].float().any()
    _check(got.float(), want.float(), out_dtype)


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_grid_encode_fwd_kernel_unaligned_table(dev, table_dtype):
    """A contiguous table one element past an aligned address (a view into
    a larger buffer) is refused: the kernel loads rows and row pairs as
    vectors. The same values from an aligned copy are taken."""
    from ngp_tpu_torch.ops.kernels import hashgrid as kh

    cfg, table = _grid("full", dev, table_dtype)
    shifted = torch.empty(table.numel() + 1, dtype=table_dtype, device=dev)[1:].view(table.shape)
    shifted.copy_(table)
    assert shifted.data_ptr() % 16 != 0
    pos, _ = _inputs(dev, 5001)
    before = LAUNCHES["grid_encode_fwd"]
    with pytest.raises(ValueError, match="pair of rows"):
        kh.grid_encode_fwd(pos, shifted, cfg.geometry, torch.bfloat16)
    assert LAUNCHES["grid_encode_fwd"] == before
    got = kh.grid_encode_fwd(pos, shifted.clone(), cfg.geometry, torch.bfloat16)
    want = kh.grid_encode_plain(pos, table, cfg.geometry, torch.bfloat16)
    _check(got.float(), want.float(), torch.bfloat16)


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_encode_bwd_kernel(dev, name, g_dtype):
    """The one-pass table gradient against its plain version (corner rows,
    then ``index_add_``), within the f32 summation-order bound, on a
    cotangent whose rows are 85% zero, points partly outside [0, 1]^3,
    and runs of neighbouring points (shared corners within a warp)."""
    from ngp_tpu_torch.ops.kernels import hashgrid as kh

    cfg, _ = _grid(name, dev)
    gen = torch.Generator().manual_seed(5)
    pos, _ = _inputs(dev, 3001)
    pos[:640] = (0.3 + 0.01 * torch.rand((640, 3), generator=gen)).to(dev)
    g = torch.randn((3001, cfg.output_dim), generator=gen)
    g[torch.rand(3001, generator=gen) < 0.85] = 0.0
    g = g.to(dev, g_dtype)
    before = LAUNCHES["grid_encode_bwd"]
    got = kh.grid_encode_bwd(pos, g, cfg.geometry)
    torch.cuda.synchronize()
    assert LAUNCHES["grid_encode_bwd"] == before + 1
    want = kh.grid_encode_bwd_plain(pos, g, cfg.geometry)
    idx, rows = kh.grid_encode_bwd_rows_plain(pos, g, cfg.geometry)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert ((got - want).abs() <= scatter_bound(idx, rows, cfg.num_rows)).all()
    assert want.abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["full", "smooth4"])
def test_grid_encode_backward_kernel(dev, name, dtype):
    """``GridEncode``'s table gradient (``grid_encode_bwd``) against
    autograd of the plain version, within the f32 summation-order bound."""
    from ngp_tpu_torch.ops.hashgrid import grid_encode
    from ngp_tpu_torch.ops.kernels import hashgrid as kh

    cfg, table = _grid(name, dev)
    pos, _ = _inputs(dev, 20000)
    g = torch.randn((20000, cfg.output_dim), generator=torch.Generator().manual_seed(6))
    g = g.to(dev, dtype)
    tk_ = table.clone().requires_grad_()
    tp = table.clone().requires_grad_()
    before = dict(LAUNCHES)
    grid_encode(pos, tk_, cfg, dtype).backward(g)
    torch.cuda.synchronize()
    for name_k in ("grid_encode_fwd", "grid_encode_bwd"):
        assert LAUNCHES[name_k] == before[name_k] + 1, name_k
    kh.grid_encode_plain(pos, tp, cfg.geometry, dtype).backward(g)
    idx, rows = kh.grid_encode_bwd_rows_plain(pos, g, cfg.geometry)
    bound = scatter_bound(idx, rows, cfg.num_rows)
    assert tk_.grad.dtype == torch.float32 and torch.isfinite(tk_.grad).all()
    assert ((tk_.grad - tp.grad).abs() <= bound).all()
    # the x-gradient is asked for too: GridEncode launches grid_encode_bwd_x
    xk, xp = pos.clone().requires_grad_(), pos.clone().requires_grad_()
    before = dict(LAUNCHES)
    grid_encode(xk, tk_, cfg, dtype).backward(g)
    assert LAUNCHES["grid_encode_bwd_x"] == before["grid_encode_bwd_x"] + 1
    kh.grid_encode_plain(xp, tp, cfg.geometry, dtype).backward(g)
    _check_dx(xk.grad, xp.grad, dtype)


def _sph_points(dev, n=5001, seed=9):
    """2-D points as the background net gets them, (sph + 1) / 2 of rays
    from inside the sphere, then rows on the box's edges and corners
    (exactly 0 and 1, inside) and a float past them (outside)."""
    from ngp_tpu_torch.ops.rays import sph_from_ray

    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=g) * 2.0 - 1.0
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    x = (sph_from_ray(o, d, 4.0) + 1.0) / 2.0
    edge = torch.tensor([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.5], [0.5, 0.0],
                         [-1e-7, 0.5], [0.5, 1.0 + 1e-7], [1.0, 1e-30]])
    return torch.cat([x, edge]).contiguous().to(dev)


@pytest.mark.parametrize("points", ["random", "sph"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(GRIDS_2D))
def test_grid_encode_fwd_kernel_2d(dev, name, table_dtype, out_dtype, points):
    """The D = 2 instance of the forward against its plain version, on
    random points and on the background net's points with the box's
    edges; counted under ``grid_encode_fwd_2d`` too."""
    from ngp_tpu_torch.ops.kernels import hashgrid as kh

    cfg, table = _grid(name, dev, table_dtype)
    if points == "random":
        pos = (torch.rand((5001, 2), generator=torch.Generator().manual_seed(3)) * 1.1
               - 0.05).to(dev)
    else:
        pos = _sph_points(dev)
    before = dict(LAUNCHES)
    got = kh.grid_encode_fwd(pos, table, cfg.geometry, out_dtype)
    for k in ("grid_encode_fwd", "grid_encode_fwd_2d"):
        assert LAUNCHES[k] == before[k] + 1, k
    want = kh.grid_encode_plain(pos, table, cfg.geometry, out_dtype)
    assert got.dtype == out_dtype and got.shape == (pos.shape[0], cfg.output_dim)
    oob = ((pos < 0) | (pos > 1)).any(dim=-1)
    assert not got[oob].float().any() and got[~oob].float().abs().sum() > 0
    _check(got.float(), want.float(), out_dtype)


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(GRIDS_2D))
def test_grid_encode_bwd_kernel_2d(dev, name, g_dtype):
    """The D = 2 table gradient against its plain version, within the f32
    summation-order bound, on the background net's points (the edges
    included) with 85% zero cotangent rows."""
    from ngp_tpu_torch.ops.kernels import hashgrid as kh

    cfg, _ = _grid(name, dev)
    pos = _sph_points(dev)
    gen = torch.Generator().manual_seed(5)
    g = torch.randn((pos.shape[0], cfg.output_dim), generator=gen)
    g[torch.rand(pos.shape[0], generator=gen) < 0.85] = 0.0
    g[-8:] = 1.0  # the edge rows
    g = g.to(dev, g_dtype)
    before = dict(LAUNCHES)
    got = kh.grid_encode_bwd(pos, g, cfg.geometry)
    torch.cuda.synchronize()
    for k in ("grid_encode_bwd", "grid_encode_bwd_2d"):
        assert LAUNCHES[k] == before[k] + 1, k
    want = kh.grid_encode_bwd_plain(pos, g, cfg.geometry)
    idx, rows = kh.grid_encode_bwd_rows_plain(pos, g, cfg.geometry)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert ((got - want).abs() <= scatter_bound(idx, rows, cfg.num_rows)).all()
    assert want.abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_encode_backward_kernel_2d(dev, dtype):
    """``GridEncode`` on the background net's grid: forward and table
    gradient against autograd of the plain version."""
    from ngp_tpu_torch.ops.hashgrid import grid_encode
    from ngp_tpu_torch.ops.kernels import hashgrid as kh

    cfg, table = _grid("bg", dev)
    pos = _sph_points(dev, n=20000)
    g = torch.randn((pos.shape[0], cfg.output_dim), generator=torch.Generator().manual_seed(6))
    g = g.to(dev, dtype)
    tk_ = table.clone().requires_grad_()
    tp = table.clone().requires_grad_()
    out = grid_encode(pos, tk_, cfg, dtype)
    _check(out.float(), kh.grid_encode_plain(pos, table, cfg.geometry, dtype).float(), dtype)
    out.backward(g)
    kh.grid_encode_plain(pos, tp, cfg.geometry, dtype).backward(g)
    idx, rows = kh.grid_encode_bwd_rows_plain(pos, g, cfg.geometry)
    assert ((tk_.grad - tp.grad).abs() <= scatter_bound(idx, rows, cfg.num_rows)).all()


def test_grid_kernels_raise_on_4d_points(dev):
    """4-D points (D-NeRF's hyper grid) now take the D = 4 instances; a
    5-D grid has no kernel instance: the three wrappers raise ValueError on
    the card, and nothing launches."""
    from ngp_tpu_torch.ops.hashgrid import GridConfig
    from ngp_tpu_torch.ops.kernels import hashgrid as kh

    cfg = GridConfig(input_dim=4, num_levels=2, base_resolution=4, log2_hashmap_size=10,
                     desired_resolution=16)
    table = torch.zeros((cfg.num_rows, cfg.level_dim), device=dev)
    before = LAUNCHES["grid_encode_fwd_4d"]
    kh.grid_encode_fwd(torch.rand((64, 4), device=dev), table, cfg.geometry)
    assert LAUNCHES["grid_encode_fwd_4d"] == before + 1
    cfg = GridConfig(input_dim=5, num_levels=2, base_resolution=4, log2_hashmap_size=10,
                     desired_resolution=16)
    table = torch.zeros((cfg.num_rows, cfg.level_dim), device=dev)
    pos = torch.rand((64, 5), device=dev)
    g = torch.zeros((64, cfg.output_dim), device=dev)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="2-D, 3-D or 4-D"):
        kh.grid_encode_fwd(pos, table, cfg.geometry)
    with pytest.raises(ValueError, match="2-D, 3-D or 4-D"):
        kh.grid_encode_bwd(pos, g, cfg.geometry)
    with pytest.raises(ValueError, match="2-D, 3-D or 4-D"):
        kh.grid_encode_bwd_x(pos, table, g, cfg.geometry)
    assert dict(LAUNCHES) == before
    cfg2, table2 = _grid("bg", dev)
    with pytest.raises(ValueError):  # 3-D points into a 2-D grid
        kh.grid_encode_fwd(torch.rand((64, 3), device=dev), table2, cfg2.geometry)


# 4-D grids: D-NeRF's hyper grid (16 levels x 2, 2^19 rows, finest 4096 at
# bound 2), a small hashed one and a tiled smoothstep one with 4 features
GRIDS_4D = {
    "hyper": dict(input_dim=4, log2_hashmap_size=19, desired_resolution=4096),
    "hash4": dict(input_dim=4, num_levels=4, base_resolution=4, log2_hashmap_size=12,
                  desired_resolution=64),
    "smooth4d": dict(input_dim=4, num_levels=3, level_dim=4, base_resolution=3,
                     log2_hashmap_size=10, per_level_scale=1.5, interpolation="smoothstep",
                     gridtype="tiled"),
}


def _grid_nd(name, dev, dtype=torch.float32, seed=0):
    from ngp_tpu_torch.ops.hashgrid import GridConfig

    cfg = GridConfig(**{**GRIDS, **GRIDS_2D, **GRIDS_4D}[name])
    g = torch.Generator().manual_seed(seed)
    table = (torch.rand((cfg.num_rows, cfg.level_dim), generator=g) * 2 - 1).to(dev, dtype)
    return cfg, table


def _points_nd(dev, n, D, seed=3):
    """Points of D dims, about 25% of them outside [0, 1]^D."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, D), generator=g)
    out = torch.rand(n, generator=g) < 0.25
    x[out, 0] = x[out, 0] * 0.2 + 1.01
    return x.contiguous().to(dev)


def _check_dx(got, want, g_dtype):
    torch.cuda.synchronize()
    tol = 1e-4 if g_dtype == torch.float32 else 1e-2
    scale = float(want.abs().max())
    assert got.dtype == torch.float32 and torch.isfinite(got).all() and scale > 0
    assert ((got - want).abs() <= tol * scale).all(), float((got - want).abs().max()) / scale


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["full", "smooth4", "bg", "smooth2", *GRIDS_4D])
def test_grid_encode_bwd_x_kernel(dev, name, table_dtype, g_dtype):
    """The x-gradient against autograd of the plain version on D = 2, 3 and
    4 grids, 25% of the points outside the box (zero rows), 30% of the
    cotangent rows zero, at 5001 points and at 0, 1, 33 and 4099 (blocks of
    32 points: a ragged last block, one point alone); then an all-zero
    cotangent, whose gradient is all zero. Counted under
    ``grid_encode_bwd_x_4d`` too on 4-D points; no launch for no points."""
    from ngp_tpu_torch.ops.kernels import hashgrid as kh

    cfg, table = _grid_nd(name, dev, table_dtype)
    D = cfg.input_dim
    for B in (5001, 0, 1, 33, 4099):
        pos = _points_nd(dev, B, D)
        gen = torch.Generator().manual_seed(8)
        g = torch.randn((B, cfg.output_dim), generator=gen)
        g[torch.rand(B, generator=gen) < 0.3] = 0.0
        if B == 1:
            pos[0] = 0.37  # inside the box
        g = g.to(dev, g_dtype)
        before = dict(LAUNCHES)
        got = kh.grid_encode_bwd_x(pos, table, g, cfg.geometry)
        assert LAUNCHES["grid_encode_bwd_x"] == before["grid_encode_bwd_x"] + (B > 0)
        assert LAUNCHES["grid_encode_bwd_x_4d"] == before["grid_encode_bwd_x_4d"] + (
            D == 4 and B > 0)
        assert got.shape == (B, D) and got.dtype == torch.float32
        if B == 0:
            continue
        want = kh.grid_encode_bwd_x_plain(pos, table, g, cfg.geometry)
        oob = ((pos < 0) | (pos > 1)).any(dim=-1)
        assert not got[oob].any()
        if float(want.abs().max()) > 0:
            _check_dx(got, want, g_dtype)
        else:
            torch.cuda.synchronize()
            assert not got.any()
    zero = torch.zeros((4099, cfg.output_dim), device=dev, dtype=g_dtype)
    got = kh.grid_encode_bwd_x(_points_nd(dev, 4099, D), table, zero, cfg.geometry)
    torch.cuda.synchronize()
    assert got.shape == (4099, D) and not got.any()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(GRIDS_4D))
def test_grid_encode_kernels_4d(dev, name, table_dtype, out_dtype):
    """The D = 4 instances of the forward and the table gradient against
    their plain versions (the forward to its output type's bound, the table
    gradient within the f32 summation-order bound), counted under
    ``grid_encode_fwd_4d`` and ``grid_encode_bwd_4d`` too."""
    from ngp_tpu_torch.ops.kernels import hashgrid as kh

    cfg, table = _grid_nd(name, dev, table_dtype)
    pos = _points_nd(dev, 5001, 4)
    before = dict(LAUNCHES)
    got = kh.grid_encode_fwd(pos, table, cfg.geometry, out_dtype)
    want = kh.grid_encode_plain(pos, table, cfg.geometry, out_dtype)
    oob = ((pos < 0) | (pos > 1)).any(dim=-1)
    assert not got[oob].float().any() and got[~oob].float().abs().sum() > 0
    _check(got.float(), want.float(), out_dtype)
    g = torch.randn((5001, cfg.output_dim), generator=torch.Generator().manual_seed(5))
    g[:2000] = 0.0
    g = g.to(dev, out_dtype)
    got = kh.grid_encode_bwd(pos, g, cfg.geometry)
    torch.cuda.synchronize()
    for k in ("grid_encode_fwd", "grid_encode_fwd_4d", "grid_encode_bwd", "grid_encode_bwd_4d"):
        assert LAUNCHES[k] == before[k] + 1, k
    want = kh.grid_encode_bwd_plain(pos, g, cfg.geometry)
    idx, rows = kh.grid_encode_bwd_rows_plain(pos, g, cfg.geometry)
    assert ((got - want).abs() <= scatter_bound(idx, rows, cfg.num_rows)).all()
    assert want.abs().max() > 0


@pytest.mark.parametrize("use_bf16", [False, True])
def test_background_net_on_the_card_matches_cpu(dev, use_bf16):
    """``NeRFNetwork.background`` through the 2-D grid kernel against the
    same weights on the CPU (the plain version). The table keeps its own
    allocation after ``load_state_dict``, which starts on a pair of rows."""
    from ngp_tpu_torch.config import NetworkConfig, RenderConfig
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops.rays import sph_from_ray

    rc = RenderConfig(bg_radius=4.0)
    nc = NetworkConfig(encoding="hashgrid", num_levels=4, log2_hashmap_size=12,
                       use_bf16=use_bf16)
    cpu = NeRFNetwork(nc, rc, torch.Generator().manual_seed(2), device="cpu")
    with torch.no_grad():  # a table of O(1) values, so every level counts
        cpu.encoder_bg.embeddings.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(3))
    gpu = NeRFNetwork(nc, rc, torch.Generator().manual_seed(5), device=dev)
    gpu.load_state_dict(cpu.state_dict())
    emb = gpu.encoder_bg.embeddings
    assert emb.is_cuda and emb.data_ptr() % (2 * emb.shape[1] * emb.element_size()) == 0
    g = torch.Generator().manual_seed(4)
    o = torch.rand((4096, 3), generator=g) * 2.0 - 1.0
    d = torch.nn.functional.normalize(torch.randn((4096, 3), generator=g), dim=-1)
    sph = sph_from_ray(o, d, rc.bg_radius)
    before = LAUNCHES["grid_encode_fwd_2d"]
    with torch.no_grad():
        got = gpu.background(sph.to(dev), d.to(dev))
        want = cpu.background(sph, d)
    assert LAUNCHES["grid_encode_fwd_2d"] == before + 1
    _check(got.cpu(), want, torch.bfloat16 if use_bf16 else torch.float32)


def test_lpips_on_the_card_with_default_flags(dev):
    """LPIPS on the card with cuDNN's default flags (TF32 allowed) against
    the CPU, 1e-4 relative: the meter's convolutions run in full f32."""
    from ngp_tpu_torch.training.lpips import lpips, random_params

    torch.backends.cudnn.allow_tf32 = True
    params = random_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2, 64, 64, 3), generator=g)
    y = (x + 0.1 * torch.randn(x.shape, generator=g)).clamp(0, 1)
    got = lpips(params, x.to(dev), y.to(dev)).cpu()
    want = lpips(params, x, y)
    assert torch.backends.cudnn.allow_tf32
    assert ((got - want).abs() <= 1e-4 * want.abs()).all(), (got, want)


@pytest.mark.parametrize("W", [1, 2, 3, 4, 8, 128, 130])
@pytest.mark.parametrize("aligned", [True, False])
def test_scatter_add_rows_kernel(dev, W, aligned):
    """Repeated and out-of-range indices, every row width branch, and
    rows that are not 16-byte aligned (the scalar-atomic fallback)."""
    from ngp_tpu_torch.ops.kernels import scatter as ks

    g = torch.Generator().manual_seed(W)
    M, R = 50000, 777
    idx = torch.randint(-5, R + 5, (M,), generator=g, dtype=torch.int32)
    idx[:5000] = 3  # a hot row
    # a view one float into its buffer is 4-byte aligned only
    rows = torch.empty((M * W + 1,), device=dev)[int(not aligned):][:M * W].view(M, W)
    rows.copy_(torch.randn((M, W), generator=g))
    idx = idx.to(dev)
    out0 = torch.randn((R, W), generator=g).to(dev)
    before = LAUNCHES["scatter_add_rows"]
    got = ks.scatter_add_rows(idx, rows, out0.clone())
    torch.cuda.synchronize()
    assert LAUNCHES["scatter_add_rows"] == before + 1
    want = ks.scatter_add_rows_plain(idx, rows, out0.clone())
    keep = (idx >= 0) & (idx < R)
    bound = scatter_bound(torch.where(keep, idx, -1), rows, R) + 2.0**-23 * out0.abs()
    assert ((got - want).abs() <= bound).all()


# (kind, M rows, R table rows, W): duplicate-heavy indices, rows whose
# float4s are mostly zero (the brick rows: 8 of 27 carry a cotangent), R
# not a multiple of 32, a 43 MB out whose rows are mostly added once, the
# widest tiled rows, hash level 0's narrow rows, rows of one float4
ROW_CASES = [("dups", 200_000, 777, 108), ("zero_float4s", 100_000, 777, 108),
             ("large_out", 60_000, 100_003, 108), ("wide", 20_000, 333, 256),
             ("level0", 300_000, 4920, 2), ("narrow_vec", 100_000, 50, 4)]


def _rows_case(dev, kind, M, R, W, layout, seed=0):
    """Indices and rows of a case; ``offset`` rows are a view one float
    into their buffer (4-byte aligned only), which takes the kernel's
    per-row branch whatever W is."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(-3, R + 3, (M,), generator=g, dtype=torch.int32)
    rows = torch.randn((M, W), generator=g)
    if kind == "dups":
        # runs of one index and a few hot indices, as a ray's samples share bricks
        idx[: M // 2] = torch.randint(0, 10, (M // 2,), generator=g, dtype=torch.int32)
        idx[M // 2: M // 2 + 5000] = 7
    if kind == "zero_float4s":
        live = torch.rand((M, W // 4), generator=g) < 8 / 27
        rows = (rows.view(M, W // 4, 4) * live[..., None]).view(M, W)
        rows[: M // 20] = 0.0
    on_card = torch.empty((M * W + 1,), device=dev)[int(layout == "offset"):][:M * W]
    return idx.to(dev), on_card.view(M, W).copy_(rows)


@pytest.mark.parametrize("layout", ["aligned", "offset"])
@pytest.mark.parametrize("kind,M,R,W", ROW_CASES)
def test_scatter_add_rows_branches(dev, kind, M, R, W, layout):
    """Both branches of the kernel against the plain version into a random
    out: ``aligned`` rows of W % 4 == 0, at most 256 floats, take the
    staged and merged tiles, the rest and every ``offset`` view a thread
    or warp per row."""
    from ngp_tpu_torch.ops.kernels import scatter as ks

    idx, rows = _rows_case(dev, kind, M, R, W, layout)
    out0 = torch.randn((R, W), generator=torch.Generator().manual_seed(1)).to(dev)
    before = LAUNCHES["scatter_add_rows"]
    got = ks.scatter_add_rows(idx, rows, out0.clone())
    torch.cuda.synchronize()
    assert LAUNCHES["scatter_add_rows"] == before + 1
    want = ks.scatter_add_rows_plain(idx, rows, out0.clone())
    # n adds into an entry of out0 are a sum of n + 1 terms; two orders of
    # it differ by at most 2 n 2^-24 times the sum of the terms' magnitudes
    adds = ks.scatter_add_rows_plain(idx, torch.ones_like(rows), torch.zeros_like(out0))
    s_abs = ks.scatter_add_rows_plain(idx, rows.abs(), out0.abs())
    assert ((got - want).abs() <= 2.0 * 2.0**-24 * adds * s_abs).all()


def taps_bound(g, coords, shape, align_corners):
    """f32 sums of n products g * w in two orders differ by at most
    2 (n - 1) 2^-24 times the sum of their magnitudes (n: the taps that
    land in a cell, per cell)."""
    from ngp_tpu_torch.ops.kernels import scatter as ks

    counts = torch.zeros(math.prod(shape[1:]), device=g.device)
    for idx, ok, _ in ks.factor_taps(coords, shape[1:], align_corners):
        counts.index_add_(0, idx[ok], torch.ones_like(idx[ok], dtype=torch.float32))
    s_abs = ks.scatter_add_taps_plain(g.abs(), coords, torch.zeros(shape, device=g.device),
                                      align_corners)
    return 2.0 * 2.0**-24 * counts.view(shape[1:]) * s_abs + 1e-30


def _tap_points(dev, kind, N, dims, size, align_corners, seed=0):
    """Uniform points (some outside the grid), a ray's samples, the same
    with the last 60% of the slots padded at the first point, or points on
    cell edges and 1-2 ulps off them."""
    g = torch.Generator().manual_seed(seed)
    if kind == "edges":
        k = torch.arange(-1, size + 1, dtype=torch.float64)
        u = ((k / (size - 1) * 2 - 1) if align_corners else ((2 * k + 1) / size - 1)).float()
        near = [u]
        for steps in (1, 2):
            for d in (math.inf, -math.inf):
                v = u.clone()
                for _ in range(steps):
                    v = torch.nextafter(v, torch.full_like(v, d))
                near.append(v)
        u = torch.cat(near)
        u = u.repeat((N + u.numel() - 1) // u.numel())[:N]
        pts = u[:, None] if dims == 1 else torch.stack([u, u[torch.randperm(N, generator=g)]], 1)
    else:
        pts = torch.rand((N, dims), generator=g) * 2.4 - 1.2
        if kind in ("ray", "padded"):
            start = torch.rand((1, dims), generator=g) * 1.6 - 0.8
            pts = start + 0.0131 * torch.arange(N)[:, None] * torch.rand((1, dims), generator=g)
            pts = torch.remainder(pts + 1.0, 2.0) - 1.0
        if kind == "padded":
            pts[int(0.4 * N):] = pts[0]
    pts = pts.contiguous().to(dev)
    return pts[:, 0] if dims == 1 else pts


# (R, grid, N): CCNeRF's narrowest group and TensoRF's ranks, lines and
# planes at TensoRF's 152 and odd sizes, a tail tile and one sample
TAP_CASES = [(1, (152,), 32768), (4, (128,), 5000), (16, (152, 152), 32768),
             (48, (152,), 32768), (7, (13, 11), 1), (64, (128, 128), 4099),
             (288, (57,), 700)]


@pytest.mark.parametrize("kind", ["uniform", "ray", "padded", "edges"])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("R,grid,N", TAP_CASES)
def test_scatter_add_taps_kernel(dev, R, grid, N, align_corners, kind):
    """The taps' factor gradient against its plain version: the same
    cells receive a gradient (the kernel rounds the pixel coordinates as
    the forward does, so a sample on a cell edge adds where the forward
    read), each entry within the f32 summation-order bound."""
    from ngp_tpu_torch.ops.kernels import scatter as ks

    coords = _tap_points(dev, kind, N, len(grid), grid[-1], align_corners, seed=R + N)
    g = torch.randn((R, N), generator=torch.Generator().manual_seed(2)).to(dev)
    before = LAUNCHES["scatter_add_taps"]
    got = ks.scatter_add_taps(g, coords, torch.zeros((R, *grid), device=dev), align_corners)
    torch.cuda.synchronize()
    assert LAUNCHES["scatter_add_taps"] == before + 1
    want = ks.scatter_add_taps_plain(g, coords, torch.zeros((R, *grid), device=dev),
                                     align_corners)
    assert torch.equal(got != 0, want != 0)
    assert ((got - want).abs() <= taps_bound(g, coords, (R, *grid), align_corners)).all()


def test_factor_taps_and_gather_rows_on_the_card(dev):
    """``interp.sample_1d`` / ``sample_2d`` (TensoRF's strided coordinate
    columns) and ``brick_encode`` on the card through the kernels, against
    the same on the CPU: values and gradients to 1e-5 of their largest
    entry (f32 sums in another order)."""
    from ngp_tpu_torch.ops import brickgrid, interp
    from ngp_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(5)
    plane, line = torch.randn((16, 40, 33), generator=g), torch.randn((48, 37), generator=g)
    xn = torch.rand((3000, 3), generator=g) * 2.2 - 1.1
    xn[1000:] = xn[0]
    cot = torch.randn((16, 3000), generator=g)

    def taps(dev_, align):
        p, ln, x = (t.to(dev_).clone().requires_grad_() for t in (plane, line, xn))
        uv = torch.stack([x[:, 0], x[:, 2]], dim=-1)
        out = interp.sample_2d(p, uv, align) * interp.sample_1d(ln, x[:, 1], align)[:16]
        (out * cot.to(dev_)).sum().backward()
        return out.detach().cpu(), p.grad.cpu(), ln.grad.cpu(), x.grad.cpu()

    cfg = brickgrid.BrickGridConfig(num_levels=4, level_dim=4, base_resolution=8,
                                    log2_hashmap_size=10)
    table = cfg.init(torch.Generator().manual_seed(6), device="cpu")
    x = torch.rand((4096, 3), generator=g) * 1.2 - 0.1
    x[:2048] = 0.3 + 1e-3 * x[:2048]
    gb = torch.randn((4096, cfg.output_dim), generator=g)

    def bricks(dev_):
        t = table.to(dev_).clone().requires_grad_()
        out = brickgrid.brick_encode(x.to(dev_), t, cfg)
        out.backward(gb.to(dev_))
        return out.detach().cpu(), t.grad.cpu()

    for align in (True, False):
        reset_launch_counts()
        got = taps(dev, align)
        torch.cuda.synchronize()
        assert launch_counts()["scatter_add_taps"] == 2
        for a, b in zip(got, taps("cpu", align)):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    reset_launch_counts()
    got = bricks(dev)
    torch.cuda.synchronize()
    assert launch_counts()["scatter_add_rows"] == 1
    for a, b in zip(got, bricks("cpu")):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_scatter_add_taps_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    from ngp_tpu_torch.ops.kernels import scatter as ks

    g, u = torch.zeros((4, 8), device=dev), torch.zeros((8,), device=dev)
    out = torch.zeros((4, 5), device=dev)
    with pytest.raises(ValueError):
        ks.scatter_add_taps(g.double(), u, out, True)
    with pytest.raises(ValueError):
        ks.scatter_add_taps(g.t().contiguous().t(), u, out, True)
    with pytest.raises(ValueError):
        ks.scatter_add_taps(g, u.double(), out, True)
    with pytest.raises(ValueError):
        ks.scatter_add_taps(g, torch.zeros((8, 2), device=dev), out, True)
    with pytest.raises(ValueError):
        ks.scatter_add_taps(g, u, torch.zeros((3, 5), device=dev), True)
    with pytest.raises(ValueError):
        ks.scatter_add_taps(g, u[:7], out, True)
    with pytest.raises(ValueError):
        ks.scatter_add_taps(g, u, torch.zeros((4, 5, 6), device=dev), True)


def test_grid_and_scatter_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from ngp_tpu_torch.ops.kernels import hashgrid as kh
    from ngp_tpu_torch.ops.kernels import scatter as ks

    cfg, table = _grid("tiled", dev)
    pos, _ = _inputs(dev, 64)
    geom = cfg.geometry
    with pytest.raises(ValueError):
        kh.grid_encode_fwd(pos.double(), table, geom)
    with pytest.raises(ValueError):
        kh.grid_encode_fwd(pos, table[:-1], geom)
    with pytest.raises(ValueError):
        kh.grid_encode_fwd(pos, table, geom, torch.float16)
    with pytest.raises(ValueError):
        kh.grid_encode_fwd(pos.t().contiguous().t(), table, geom)
    with pytest.raises(ValueError):
        kh.grid_encode_bwd(pos, torch.zeros((64, cfg.output_dim + 1), device=dev), geom)
    with pytest.raises(ValueError):
        kh.grid_encode_bwd(pos, torch.zeros((64, cfg.output_dim), device=dev).half(), geom)
    with pytest.raises(ValueError):
        kh.grid_encode_bwd(pos.t().contiguous().t(), torch.zeros((64, cfg.output_dim),
                                                                 device=dev), geom)
    idx = torch.zeros((8,), dtype=torch.int32, device=dev)
    out = torch.zeros((4, 2), device=dev)
    with pytest.raises(ValueError):
        ks.scatter_add_rows(idx.long(), torch.zeros((8, 2), device=dev), out)
    with pytest.raises(ValueError):
        ks.scatter_add_rows(idx, torch.zeros((2, 8), device=dev).t(), out)
    with pytest.raises(ValueError):
        ks.scatter_add_rows(idx, torch.zeros((8, 3), device=dev), out)
    with pytest.raises(ValueError):
        ks.scatter_add_rows(idx, torch.zeros((8, 2), device=dev), out.double())


def test_hashgrid_train_step_on_the_card_matches_cpu(dev, tmp_path):
    """One f32 step of the hash-grid configuration through the grid
    kernels against the same step on the CPU: loss
    to 1e-4 relative, each gradient (the table's included) to 1e-3 of
    its largest entry (f32 atomics and summation order)."""
    import copy

    from ngp_tpu_torch.config import NetworkConfig, RenderConfig, TrainConfig
    from ngp_tpu_torch.data.synthetic import make_synthetic_frames
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

    rc = RenderConfig(bound=1.0, min_near=0.05, max_steps=64, max_samples_per_ray=16,
                      grid_size=16, density_thresh=10.0, turbo=False)
    nc = NetworkConfig(encoding="hashgrid", use_bf16=False, num_levels=4, level_dim=2,
                       base_resolution=4, log2_hashmap_size=10, sh_degree=3)
    tc = TrainConfig(num_rays=1024, workspace=str(tmp_path))
    frames = make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=32, W=32,
                                   device=dev)["train"]
    cpu_model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(0), device="cpu")
    gpu_tr = GridNeRFTrainer(copy.deepcopy(cpu_model).to(dev), rc, tc)
    for _ in range(2):
        gpu_tr._update_occupancy()
    cpu_tr = GridNeRFTrainer(cpu_model, rc, tc)
    cpu_tr.aux = {"occ": gpu_tr.aux["occ"].to("cpu")}
    g = torch.Generator().manual_seed(1)
    draws = {"inds": torch.randint(0, 32 * 32, (1024,), generator=g),
             "bg": torch.rand((1024, 3), generator=g), "noise": torch.rand((1024,), generator=g)}
    batch = {"images": torch.from_numpy(frames.images), "poses": torch.from_numpy(frames.poses),
             "intrinsics": torch.from_numpy(frames.intrinsics), "idx": 1}
    reset_launch_counts()
    mg = gpu_tr.train_step({k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()},
                           {k: v.to(dev) for k, v in draws.items()})
    counts = launch_counts()
    for name in ("grid_encode_fwd", "grid_encode_bwd"):
        assert counts[name] > 0, counts
    assert not any(v for k, v in counts.items() if k.startswith("cp_")), counts
    mc = cpu_tr.train_step(batch, draws)
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4 * float(mc["loss"])
    cpu_grads = dict(cpu_tr.model.named_parameters())
    for name, p in gpu_tr.model.named_parameters():
        want = cpu_grads[name].grad
        assert float((p.grad.cpu() - want).abs().max()) <= 1e-3 * float(want.abs().max()), name
