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
its largest entry (f32, atomics and summation order)."""

import numpy as np
import pytest
import torch

from ngp_tpu_torch.ops.kernels import LAUNCHES
from ngp_tpu_torch.ops.kernels import cp as tk
from ngp_tpu_torch.ops.kernels import march as tm

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _weights(dev, dtype, res, rank, fd, h1=64, out=16, sh=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    factors = tuple((torch.randn((3, r, rank), generator=g) * 0.2).to(dev, dtype) for r in res)
    D = len(res) * rank + 3 * (1 + 2 * fd)
    w1 = (torch.randn((D, h1), generator=g) / D**0.5).to(dev, dtype)
    w2 = (torch.randn((h1, out), generator=g) / h1**0.5).to(dev, dtype)
    dims = [sh * sh + out - 1, 64, 64, 3]
    color = tuple((torch.randn((dims[i], dims[i + 1]), generator=g) / dims[i] ** 0.5)
                  .to(dev, dtype) for i in range(3))
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,rank,fd,M", SHAPES)
def test_cp_density_kernel(dev, dtype, res, rank, fd, M):
    factors, w1, w2, _ = _weights(dev, dtype, res, rank, fd)
    pos, _ = _inputs(dev, M)
    before = LAUNCHES["cp_density_fwd"]
    got = tk.cp_density_fwd(pos, factors, w1, w2, res, fd)
    assert LAUNCHES["cp_density_fwd"] == before + 1
    _check(got, tk.cp_density_plain(pos, factors, w1, w2, res, fd), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,rank,fd,M", SHAPES)
def test_cp_density_kernel_residuals(dev, dtype, res, rank, fd, M):
    factors, w1, w2, _ = _weights(dev, dtype, res, rank, fd)
    pos, _ = _inputs(dev, M)
    before = LAUNCHES["cp_density_fwd_residuals"]
    got = tk.cp_density_fwd(pos, factors, w1, w2, res, fd, residuals=True)
    assert LAUNCHES["cp_density_fwd_residuals"] == before + 1
    want = tk.cp_density_plain(pos, factors, w1, w2, res, fd, residuals=True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        _check(a.float(), b.float(), dtype)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,rank,fd,M", SHAPES)
def test_cp_sigma_rgb_kernel(dev, dtype, res, rank, fd, M):
    factors, w1, w2, color = _weights(dev, dtype, res, rank, fd)
    pos, dirs = _inputs(dev, M)
    got = tk.cp_sigma_rgb(pos, dirs, factors, w1, w2, color, res, fd, 4)
    _check(got, tk.cp_sigma_rgb_plain(pos, dirs, factors, w1, w2, color, res, fd, 4), dtype)


@pytest.mark.parametrize("R", [32, 64])
def test_coarse_lookup_kernel_bits(dev, R):
    g = torch.Generator().manual_seed(R)
    payload = torch.randint(0, 256, (R, 128), generator=g).float().to(dev)
    fc = torch.randint(-5, R * 1024 + 5, (333, 77), generator=g, dtype=torch.int32).to(dev)
    assert torch.equal(tm.coarse_lookup_bits(payload, fc), tm.coarse_lookup_plain(payload, fc))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    factors, w1, w2, _ = _weights(dev, torch.float32, (32, 64), 16, 4)
    pos, _ = _inputs(dev, 64)
    with pytest.raises(ValueError):
        tk.cp_density_fwd(pos.double(), factors, w1, w2, (32, 64), 4)
    with pytest.raises(ValueError):
        tk.cp_density_fwd(pos, factors, w1.bfloat16(), w2, (32, 64), 4)
    with pytest.raises(ValueError):
        tk.cp_density_fwd(pos, factors, w1, w2, (32, 64), 3)
    with pytest.raises(ValueError):
        tm.coarse_lookup_bits(torch.zeros((4, 128), device=dev),
                              torch.zeros((8, 2), dtype=torch.int32, device=dev).t())
    g = torch.zeros((64, 32), device=dev)
    with pytest.raises(ValueError):
        tk.cp_bwd_banks(pos, factors, g[:, :16], (32, 64))
    with pytest.raises(ValueError):
        tk.cp_bwd_banks(pos, factors, g.t().contiguous().t(), (32, 64))


def test_kernels_on_the_render_path(dev):
    """A tiny GPU frame goes through the three eval kernels and matches the
    same frame rendered on the CPU through the plain versions."""
    from ngp_tpu_torch.config import NetworkConfig, RenderConfig
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

    rc = RenderConfig(bound=1.0, min_near=0.05, max_steps=64, max_samples_per_ray=16,
                      grid_size=16, density_thresh=10.0, turbo=True, coarse_candidates=48)
    nc = NetworkConfig(encoding="cpgrid", use_bf16=False, cp_resolutions=(32, 64),
                       cp_rank=16, cp_freq_degree=4, sh_degree=3)
    cpu_model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(0))
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
    assert all(counts[k] > 0 for k in ("cp_density_fwd", "cp_sigma_rgb",
                                       "coarse_lookup_bits")), counts
    img_c, _ = cpu_tr.render_frame(pose, intr, 32, 32, chunk=256)
    assert np.abs(img_g - img_c).mean() <= 1e-4


def test_train_step_on_the_card_matches_cpu(dev, tmp_path):
    """One f32 train step through the kernels (the residual forward, the
    factor backward, the coarse lookup) against the same step on the CPU
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
    cpu_model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(0))
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
    for name in ("cp_density_fwd_residuals", "cp_bwd_banks", "coarse_lookup_bits"):
        assert counts[name] > 0, counts
    mc = cpu_tr.train_step(batch, draws)
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4 * float(mc["loss"])
    cpu_grads = dict(cpu_tr.model.named_parameters())
    for name, p in gpu_tr.model.named_parameters():
        want = cpu_grads[name].grad
        assert float((p.grad.cpu() - want).abs().max()) <= 1e-3 * float(want.abs().max()), name
