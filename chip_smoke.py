#!/usr/bin/env python3
"""Drive the PyTorch port's ``-O`` paths once on one NVIDIA GPU: the eval
render, training, and the end of a run (evaluate, test, mesh export).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``ngp_tpu_torch/ops/kernels/csrc``, then

2-3. builds the turbo-hq NeRF network at full width from a seeded
     generator (random weights), refreshes the 128^3 occupancy grid (16
     full sweeps, then one partial refresh) and renders 800x800 frames
     through ``GridNeRFTrainer.render_frame`` (the eval path);
4.   holds each kernel against its plain PyTorch version at the paths'
     shapes: the refresh and the eval chunk, the train step's 98,304
     rows for the density forward with residuals and the factor
     backward, the mesh export's 65,536-row chunk for the CP encoder
     and its backward, and 524,288 x [32, 64, 64, 16] for the MLP chain
     (which no path runs);
5.   renders a small frame on the GPU and the same frame on the CPU
     through the plain versions;
6.   renders the synthetic scene (16 train frames at 400x400 and one
     val frame) and trains turbo-hq at 16384 rays per step through
     ``GridNeRFTrainer.step`` (grid refresh every 16 steps, Adam, EMA;
     the train path), times the last 128 of 256 steps, and requires a
     finite loss that falls;
7.   renders the val pose with the EMA weights and checks its PSNR;
     then, on the same trainer, ``evaluate`` (PSNR and SSIM, the PSNR
     equal to the frame's), ``test`` (its PNG decodes to the frame) and
     ``save_mesh`` at 256^3 (256 CP-encoder launches through
     ``NeRFNetwork.density``, a non-empty mesh inside the box);
8.   runs one small f32 train step on the GPU and the same step on the
     CPU through the plain versions, and compares loss and gradients.

Each path is run with the launch counts set to 0 just before it and read
just after; a kernel of the path that was not launched fails the run.
Every time is printed beside the card's name and power limit. The last
line is a JSON object ``{"ok": true, "device": {...}}``; any failure
raises and exits non-zero.
"""

import copy
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
FRAME = 800
FRAMES = 3
# kernel vs plain tolerances, |kernel - plain| <= TOL * (1 + |plain|):
# f32 differs only in summation order (679-term sums of O(1) values);
# bf16 rounds features and hidden units at the same points in both, so
# a different summation order can flip one bf16 rounding (2^-8
# relative) of a hidden unit, which the next layer spreads
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# mean |pixel| difference of a small frame, GPU kernels vs CPU plain
# versions, bf16 network: a flipped rounding moves a sample's colour by
# ~1e-2 at most, and few samples flip
FRAME_TOL = 5e-3
# train: 16384 rays per step (bench.py), 256 steps, the last 128 timed
TRAIN_RAYS = 16384
TRAIN_STEPS = 256
TIMED_STEPS = 128
TRAIN_ROWS = TRAIN_RAYS * 6  # compact_mean_samples x rays: the density head's rows
# the mean loss of the last 16 steps must be below this share of the
# first 16 steps' mean, and the trained val frame must reach this PSNR
# (the first run, on NVIDIA H100 80GB HBM3, 700.00 W: 0.0072 and 31.87 dB)
LOSS_FALL = 0.1
MIN_PSNR = 25.0
# evaluate scores the same u8 frame as phase 7: its PSNR to this many dB
EVAL_PSNR_TOL = 0.01
# save_mesh: 256^3 lattice points in chunks of 2^16, one encoder launch each
MESH_RES = 256
MESH_CHUNKS = MESH_RES**3 // 2**16
ENCODE_ROWS = 2**16
MLP_DIMS = [32, 64, 64, 16]
MLP_ROWS = (524288, 300)
# one small f32 train step, GPU kernels vs CPU plain versions: the
# loss to 1e-4 relative and each gradient to 1e-3 of its largest entry
# (f32 atomics and summation order)
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 1e-3


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def orbit_pose(angle, radius=2.5, height=0.6):
    import numpy as np

    o = np.array([radius * math.sin(angle), height, -radius * math.cos(angle)], np.float32)
    f = -o / np.linalg.norm(o)
    r = np.cross(f, [0.0, 1.0, 0.0])
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = r, d, f, o
    return pose


def intrinsics(size, fovy_deg=50.0):
    import numpy as np

    focal = 0.5 * size / math.tan(math.radians(fovy_deg) / 2)
    return np.array([focal, focal, size / 2, size / 2], np.float32)


def cuda_ms(fn, reps=10):
    """Device time of one call, from CUDA events around ``reps`` calls."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, kernel, plain, dtype, bound=None):
    """Run kernel and plain on the same inputs; raise past the tolerance,
    by default TOL[dtype] * (1 + |plain|); ``bound(want)`` gives one
    bound tensor per output instead. Outputs may be tuples. Returns
    (max_abs_err, kernel ms, plain ms), timed plain, kernel, kernel,
    plain."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    bounds = bound(want) if bound else [TOL[dtype] * (1.0 + w.float().abs()) for w in want]
    err_max = 0.0
    for i, (g, w, b) in enumerate(zip(got, want, bounds)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.isfinite(g).all():
            raise RuntimeError(f"{name} [{dtype}] output {i}: shape, dtype or finiteness "
                               "differs from the plain version")
        err = (g.float() - w.float()).abs()
        if (err > b).any():
            raise RuntimeError(f"{name} [{dtype}] output {i}: max |kernel - plain| "
                               f"{float(err.max())} exceeds its bound")
        err_max = max(err_max, float(err.max()))
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return err_max, (k1 + k2) / 2, (p1 + p2) / 2


def bwd_bound(cp, pos, factors, g_cp, res, want):
    """cp_bwd_banks sums by f32 atomics in no fixed order: per entry,
    2^-13 of the sum of its absolute contributions, plus (bf16 output)
    2^-7 * |plain|, a half step of each of the two roundings to bf16."""
    s_abs = cp.cp_bwd_banks_plain(pos, [f.abs() for f in factors], g_cp.abs(), res)
    ulp = 2.0**-7 if factors[0].dtype.itemsize == 2 else 0.0
    return [2.0**-13 * s.float() + ulp * w.float().abs() for s, w in zip(s_abs, want)]


def check_launched(path, counts, names):
    print(f"launches [{path}]: {json.dumps(counts)}", flush=True)
    for name in names:
        if counts[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the {path} path")


def train_step_gpu_vs_cpu(dev):
    """One small f32 train step through the kernels and the same step on
    the CPU through the plain versions; raise past the tolerances."""
    import torch

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
    with tempfile.TemporaryDirectory() as ws:
        tc = TrainConfig(num_rays=1024, workspace=ws)
        frames = make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=32, W=32)["train"]
        cpu_model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(SEED))
        gpu_tr = GridNeRFTrainer(copy.deepcopy(cpu_model).to(dev), rc, tc)
        for _ in range(2):
            gpu_tr._update_occupancy()
        cpu_tr = GridNeRFTrainer(cpu_model, rc, tc)
        cpu_tr.aux = {"occ": gpu_tr.aux["occ"].to("cpu")}
        g = torch.Generator().manual_seed(SEED + 2)
        draws = {"inds": torch.randint(0, 32 * 32, (1024,), generator=g),
                 "bg": torch.rand((1024, 3), generator=g),
                 "noise": torch.rand((1024,), generator=g)}
        batch = {"images": torch.from_numpy(frames.images),
                 "poses": torch.from_numpy(frames.poses),
                 "intrinsics": torch.from_numpy(frames.intrinsics), "idx": 1}
        reset_launch_counts()
        mg = gpu_tr.train_step(
            {k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()},
            {k: v.to(dev) for k, v in draws.items()})
        torch.cuda.synchronize()
        check_launched("small train step", launch_counts(),
                       ("cp_density_fwd_residuals", "cp_bwd_banks", "coarse_lookup_bits"))
        mc = cpu_tr.train_step(batch, draws)
    loss_g, loss_c = float(mg["loss"]), float(mc["loss"])
    if not math.isfinite(loss_g) or abs(loss_g - loss_c) > STEP_LOSS_TOL * abs(loss_c):
        raise RuntimeError(f"small train step: loss {loss_g} on the GPU, {loss_c} on the CPU")
    worst = 0.0
    cpu_params = dict(cpu_tr.model.named_parameters())
    for name, p in gpu_tr.model.named_parameters():
        want = cpu_params[name].grad
        rel = float((p.grad.cpu() - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        if not rel <= STEP_GRAD_TOL:
            raise RuntimeError(f"small train step: gradient of {name} differs by {rel} "
                               "of its largest entry")
        worst = max(worst, rel)
    print(f"small train step: loss gpu {loss_g:.7f} cpu {loss_c:.7f}, worst gradient "
          f"difference {worst:.3e} of its largest entry", flush=True)
    return worst


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from ngp_tpu_torch.config import NetworkConfig, RenderConfig, TrainConfig
    from ngp_tpu_torch.data.synthetic import make_synthetic_frames
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops.kernels import build, cp, launch_counts, march, reset_launch_counts
    from ngp_tpu_torch.ops.kernels import fused_mlp as mlp
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer
    from ngp_tpu_torch.utils.png import read_png

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)

    def phase(name, t0):
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"phase {name}: {dt:.3f} s  [{card}]", flush=True)
        return dt

    # 1. build the kernels from the checkout's sources
    t0 = time.perf_counter()
    _, report = build.build()
    build.load_library()
    phase("build", t0)
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")

    # 2. the turbo-hq network at full width, random weights from a seed
    rc = RenderConfig(
        bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=256, max_samples_per_ray=32,
        grid_size=128, density_thresh=10.0, turbo=True, coarse_candidates=96,
        crossing_slots=16, compact_mean_samples=6,
    )
    nc = NetworkConfig(encoding="cpgrid", use_bf16=True,
                       cp_resolutions=(128, 256, 512, 1024, 2048), cp_rank=128,
                       cp_freq_degree=6)
    t0 = time.perf_counter()
    model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(SEED)).to(dev)
    trainer = GridNeRFTrainer(model, rc, seed=SEED)
    phase("model", t0)

    # 3. the eval path: grid refresh, then full frames
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(16):
        trainer._update_occupancy()
    phase("refresh 16 full sweeps (128^3 queries each)", t0)
    t0 = time.perf_counter()
    trainer._update_occupancy()
    phase("refresh partial (H/4 slab)", t0)
    occ = trainer.aux["occ"]
    print(f"grid: iter {occ.iter_density}, occupied {float(occ.occ_grid.float().mean()):.4f}, "
          f"mean density {float(occ.mean_density):.4f}")
    intr = intrinsics(FRAME)
    images = []
    for f in range(FRAMES):
        pose = orbit_pose(0.7 + 2.0 * math.pi * f / FRAMES)
        t0 = time.perf_counter()
        img, dep = trainer.render_frame(pose, intr, FRAME, FRAME)
        dt = phase(f"frame {f} ({FRAME}x{FRAME})", t0)
        st = trainer.last_render_stats
        print(f"frame {f}: {dt * 1e3:.1f} ms, n_samples {st['n_samples']:.0f}, "
              f"n_dropped {st['n_dropped']:.1f}, lattice span {trainer._eval_lattice_span}  "
              f"[{card}]", flush=True)
        images.append(img)
    eval_counts = launch_counts()
    check_launched("eval", eval_counts, ("cp_density_fwd", "cp_sigma_rgb", "coarse_lookup_bits"))
    for img in images:
        if img.shape != (FRAME, FRAME, 3) or not np.isfinite(img).all():
            raise RuntimeError("frame is not a finite 800x800x3 image")
        if img.min() < 0.0 or img.max() > 1.0:
            raise RuntimeError("frame values outside [0, 1]")
    if trainer.last_render_stats["n_samples"] <= 0:
        raise RuntimeError("the frames rendered no samples")

    # 4. each kernel against its plain version at the paths' shapes
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    factors = tuple(f.detach() for f in model.encoder.factors)
    w1, w2 = (w.detach() for w in model.sigma_net.weights)
    color = tuple(w.detach() for w in model.color_net.weights)
    res, fd = nc.cp_resolutions, nc.cp_freq_degree
    nbR = len(res) * nc.cp_rank
    rows = {"cp_density_fwd": 128 * 128 * 8, "cp_sigma_rgb": 4096 * 6}
    results = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        fa = tuple(f.to(dt).contiguous() for f in factors)
        a1, a2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
        ca = tuple(w.to(dt).contiguous() for w in color)
        pos = torch.rand((rows["cp_density_fwd"], 3), generator=gen, device=dev) * 1.1 - 0.05
        results[("cp_density_fwd", dtype)] = compare(
            "cp_density_fwd",
            lambda: cp.cp_density_fwd(pos, fa, a1, a2, res, fd),
            lambda: cp.cp_density_plain(pos, fa, a1, a2, res, fd), dtype)
        pos_t = torch.rand((TRAIN_ROWS, 3), generator=gen, device=dev) * 1.1 - 0.05
        results[("cp_density_fwd+residuals", dtype)] = compare(
            "cp_density_fwd+residuals",
            lambda: cp.cp_density_fwd(pos_t, fa, a1, a2, res, fd, residuals=True),
            lambda: cp.cp_density_plain(pos_t, fa, a1, a2, res, fd, residuals=True), dtype)
        # the factor gradient from a d(features) of the train shape, with a
        # row stride wider than its columns as the backward passes it
        g_cp = torch.randn((TRAIN_ROWS, w1.shape[0]), generator=gen, device=dev)[:, :nbR]
        results[("cp_bwd_banks", dtype)] = compare(
            "cp_bwd_banks",
            lambda: cp.cp_bwd_banks(pos_t, fa, g_cp, res),
            lambda: cp.cp_bwd_banks_plain(pos_t, fa, g_cp, res), dtype,
            bound=lambda want: bwd_bound(cp, pos_t, fa, g_cp, res, want))
        pos = torch.rand((rows["cp_sigma_rgb"], 3), generator=gen, device=dev)
        dirs = torch.nn.functional.normalize(
            torch.randn((rows["cp_sigma_rgb"], 3), generator=gen, device=dev), dim=-1)
        results[("cp_sigma_rgb", dtype)] = compare(
            "cp_sigma_rgb",
            lambda: cp.cp_sigma_rgb(pos, dirs, fa, a1, a2, ca, res, fd, nc.sh_degree),
            lambda: cp.cp_sigma_rgb_plain(pos, dirs, fa, a1, a2, ca, res, fd, nc.sh_degree),
            dtype)
        # the CP encoder at the mesh chunk, each bank type to each output type
        pos_e = torch.rand((ENCODE_ROWS, 3), generator=gen, device=dev) * 1.1 - 0.05
        for out_name in ("bfloat16", "float32"):
            od = getattr(torch, out_name)
            results[("cp_encode_fwd", f"{dtype}->{out_name}")] = compare(
                "cp_encode_fwd",
                lambda: cp.cp_encode_fwd(pos_e, fa, res, od),
                lambda: cp.cp_encode_plain(pos_e, fa, res, od), out_name)
        # its backward (CPEncode: cp_bwd_banks) against autograd of the plain
        # version, forward and backward timed together
        g_e = torch.randn((ENCODE_ROWS, nbR), generator=gen, device=dev)
        fr = [f.clone().requires_grad_() for f in fa]
        results[("CPEncode backward", dtype)] = compare(
            "CPEncode backward",
            lambda: torch.autograd.grad(cp.cp_encode(pos_e, fr, res), fr, g_e),
            lambda: torch.autograd.grad(cp.cp_encode_plain(pos_e, fr, res), fr, g_e), dtype,
            bound=lambda want: bwd_bound(cp, pos_e, fa, g_e, res, want))
    # the MLP chain at the JAX docstring's shape and a ragged small batch
    for rows_m in MLP_ROWS:
        x_m = torch.randn((rows_m, MLP_DIMS[0]), generator=gen, device=dev)
        w_m = [torch.randn((MLP_DIMS[i], MLP_DIMS[i + 1]), generator=gen, device=dev) * 0.2
               for i in range(len(MLP_DIMS) - 1)]
        results[("fused_mlp", str(rows_m))] = compare(
            "fused_mlp", lambda: mlp.fused_mlp(x_m, w_m), lambda: mlp.fused_mlp_plain(x_m, w_m),
            "bfloat16")
    payload = occ.coarse_payload
    fc = torch.randint(0, payload.numel() * 8, (4096, 64), generator=gen, device=dev,
                       dtype=torch.int32)
    got = march.coarse_lookup_bits(payload, fc)
    want = march.coarse_lookup_plain(payload, fc)
    if not torch.equal(got, want):
        raise RuntimeError("coarse_lookup_bits: bits differ from the plain version")
    p1 = cuda_ms(lambda: march.coarse_lookup_plain(payload, fc))
    k1 = cuda_ms(lambda: march.coarse_lookup_bits(payload, fc))
    k2 = cuda_ms(lambda: march.coarse_lookup_bits(payload, fc))
    p2 = cuda_ms(lambda: march.coarse_lookup_plain(payload, fc))
    results[("coarse_lookup_bits", "bits")] = (0.0, (k1 + k2) / 2, (p1 + p2) / 2)
    for (name, dtype), (err, k_ms, p_ms) in results.items():
        print(f"kernel {name} [{dtype}]: max_abs_err {err:.3e}, kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms  [{card}]")

    # 5. a small frame: GPU kernels against the CPU plain versions, same
    # weights and grid, fresh trainers (no sticky spans or chunk counts)
    small = 64
    gpu_tr = GridNeRFTrainer(model, rc, seed=SEED)
    gpu_tr.aux = {"occ": occ}
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_tr = GridNeRFTrainer(cpu_model, rc, seed=SEED)
    cpu_tr.aux = {"occ": occ.to("cpu")}
    for tr in (gpu_tr, cpu_tr):
        tr.eval_f32_frames = True
    pose = orbit_pose(1.1)
    img_g, _ = gpu_tr.render_frame(pose, intrinsics(small), small, small, chunk=1024)
    img_c, _ = cpu_tr.render_frame(pose, intrinsics(small), small, small, chunk=1024)
    diff = float(np.abs(img_g - img_c).mean())
    print(f"small frame {small}x{small}: mean |gpu - cpu| {diff:.3e}, "
          f"max {float(np.abs(img_g - img_c).max()):.3e}, "
          f"gpu n_samples {gpu_tr.last_render_stats['n_samples']:.0f}, "
          f"cpu n_samples {cpu_tr.last_render_stats['n_samples']:.0f}")
    if not np.isfinite(img_g).all() or diff > FRAME_TOL:
        raise RuntimeError(f"small frame: GPU and CPU renders differ by {diff}")
    # the kernel checks' inputs too, so the train phase's peak memory is its own
    del trainer, gpu_tr, cpu_tr, cpu_model, model, pos_e, g_e, fr, x_m, w_m

    # 6. the train path: bench.py's scene size and preset, random init
    t0 = time.perf_counter()
    splits = make_synthetic_frames(n_train=16, n_val=1, n_test=0, H=400, W=400, seed=SEED,
                                   device=dev)
    phase("synthetic scene (17 frames of 400x400, 512 samples per ray)", t0)
    train_ds, val_ds = splits["train"], splits["val"]
    model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(SEED)).to(dev)
    with tempfile.TemporaryDirectory() as ws:
        tc = TrainConfig(iters=30000, lr=1e-2, num_rays=TRAIN_RAYS, update_extra_interval=16,
                         workspace=ws)
        trainer = GridNeRFTrainer(model, rc, tc, seed=SEED)
        trainer.mark_untrained(train_ds.poses, train_ds.intrinsics, train_ds.H, train_ds.W)
        epoch_iter = trainer.make_loader(train_ds)
        batches = itertools.chain.from_iterable(epoch_iter() for _ in itertools.count())
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, overflow = [], []
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS):
            if i == TRAIN_STEPS - TIMED_STEPS:
                phase(f"train steps 0-{i - 1} (first calls, grid warm-up)", t0)
                t0 = time.perf_counter()
            metrics = trainer.step(next(batches))
            losses.append(metrics["loss"])
            overflow.append(metrics["turbo_overflow"])
        dt = phase(f"train steps {TRAIN_STEPS - TIMED_STEPS}-{TRAIN_STEPS - 1} (timed)", t0)
        train_counts = launch_counts()
        check_launched("train", train_counts, ("cp_density_fwd", "cp_density_fwd_residuals",
                                              "cp_bwd_banks", "coarse_lookup_bits"))
        steps_s = TIMED_STEPS / dt
        print(f"train: {steps_s:.2f} steps/s, {steps_s * TRAIN_RAYS:.0f} rays/s, "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]",
              flush=True)
        losses = torch.stack(losses).cpu().numpy()
        overflow = torch.stack(overflow).cpu().numpy()
        occ = trainer.aux["occ"]
        print(f"train loss: first 16 mean {losses[:16].mean():.6f}, last 16 mean "
              f"{losses[-16:].mean():.6f}; turbo_overflow last {overflow[-1]:.4f}; grid iter "
              f"{occ.iter_density}, occupied {float(occ.occ_grid.float().mean()):.4f}")
        if not np.isfinite(losses).all():
            raise RuntimeError("train: non-finite loss")
        if not losses[-16:].mean() < LOSS_FALL * losses[:16].mean():
            raise RuntimeError(f"train: the loss did not fall below {LOSS_FALL} of its start")

        # 7. the trained frame: the val pose with the EMA weights
        reset_launch_counts()
        pose, H, W = val_ds.poses[0], val_ds.H, val_ds.W
        t0 = time.perf_counter()
        img, _ = trainer.render_frame(pose, val_ds.intrinsics, H, W)
        dt = phase(f"trained frame ({H}x{W}, EMA weights)", t0)
        t0 = time.perf_counter()
        img, _ = trainer.render_frame(pose, val_ds.intrinsics, H, W)
        dt2 = phase(f"trained frame again ({H}x{W})", t0)
        frame_counts = launch_counts()
        check_launched("trained frame", frame_counts, ("cp_sigma_rgb", "coarse_lookup_bits"))
        gt = val_ds.images[0]
        gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
        psnr = -10.0 * math.log10(float(np.mean((img - gt) ** 2)))
        if img.shape != (H, W, 3) or not np.isfinite(img).all() or not psnr >= MIN_PSNR:
            raise RuntimeError(f"trained frame: not a finite image of {MIN_PSNR} dB or more "
                               f"(PSNR {psnr})")
        print(f"trained frame: PSNR {psnr:.2f} dB against the ground truth after "
              f"{TRAIN_STEPS} steps, {dt * 1e3:.1f} / {dt2 * 1e3:.1f} ms  [{card}]", flush=True)

        # 7b. evaluate the val split (writes workspace/validation)
        reset_launch_counts()
        t0 = time.perf_counter()
        ev = trainer.evaluate(val_ds, with_ssim=True)
        phase("evaluate (1 val frame, PSNR and SSIM)", t0)
        evaluate_counts = launch_counts()
        check_launched("evaluate", evaluate_counts, ("cp_sigma_rgb", "coarse_lookup_bits"))
        if not (math.isfinite(ev["psnr"]) and ev["psnr"] >= MIN_PSNR and 0.0 < ev["ssim"] <= 1.0):
            raise RuntimeError(f"evaluate: PSNR {ev['psnr']}, SSIM {ev['ssim']}")
        if abs(ev["psnr"] - psnr) > EVAL_PSNR_TOL:
            raise RuntimeError(f"evaluate: PSNR {ev['psnr']} differs from the frame's {psnr}")
        print(f"evaluate: PSNR {ev['psnr']:.4f} dB, SSIM {ev['ssim']:.4f}  [{card}]", flush=True)

        # 7c. test: the val frame as a PNG under workspace/results
        reset_launch_counts()
        t0 = time.perf_counter()
        out_dir = trainer.test(val_ds)
        phase("test (1 frame, PNG)", t0)
        test_counts = launch_counts()
        check_launched("test", test_counts, ("cp_sigma_rgb", "coarse_lookup_bits"))
        png = read_png(os.path.join(out_dir, f"{trainer.name}_0000_rgb.png"))
        if not np.array_equal(png, (np.clip(img, 0, 1) * 255).astype(np.uint8)):
            raise RuntimeError("test: the PNG does not decode to the rendered frame")

        # 7d. save_mesh: the density lattice through NeRFNetwork.density
        reset_launch_counts()
        t0 = time.perf_counter()
        mesh_path = trainer.save_mesh(resolution=MESH_RES, threshold=10.0)
        dt = phase(f"save_mesh ({MESH_RES}^3 density, marching, OBJ)", t0)
        mesh_counts = launch_counts()
        check_launched("save_mesh", mesh_counts, ("cp_encode_fwd",))
        others = {k: v for k, v in mesh_counts.items() if k != "cp_encode_fwd" and v}
        if mesh_counts["cp_encode_fwd"] != MESH_CHUNKS or others:
            raise RuntimeError(f"save_mesh: {mesh_counts['cp_encode_fwd']} encoder launches "
                               f"(want {MESH_CHUNKS}), other kernels {others}")
        with open(mesh_path) as f:
            lines = f.read().splitlines()
        verts = np.array([ln.split()[1:4] for ln in lines if ln.startswith("v ")], np.float64)
        n_faces = sum(ln.startswith("f ") for ln in lines)
        st = trainer.last_mesh_stats
        if len(verts) == 0 or n_faces == 0 or np.abs(verts).max() > rc.bound:
            raise RuntimeError(f"save_mesh: {len(verts)} vertices, {n_faces} faces, "
                               f"largest |coordinate| {np.abs(verts).max(initial=0.0)}")
        print(f"save_mesh: {len(verts)} vertices, {n_faces} faces in {dt:.3f} s: density "
              f"{st['density_s']:.3f} s, marching {st['marching_s']:.3f} s, OBJ "
              f"{st['write_s']:.3f} s  [{card}]", flush=True)

    # 8. one small train step: GPU kernels against the CPU plain versions
    train_step_gpu_vs_cpu(dev)

    path_counts = (eval_counts, train_counts, frame_counts, evaluate_counts, test_counts,
                   mesh_counts)
    sources = {
        "cp_density_fwd": ("ngp_tpu_torch/ops/kernels/csrc/cp_kernels.cu",
                           "ngp_tpu/ops/pallas/cp_kernels.py:345",
                           ("cp_density_fwd+residuals", "bfloat16")),
        "cp_sigma_rgb": ("ngp_tpu_torch/ops/kernels/csrc/cp_kernels.cu",
                         "ngp_tpu/ops/pallas/cp_kernels.py:506", ("cp_sigma_rgb", "bfloat16")),
        "coarse_lookup_bits": ("ngp_tpu_torch/ops/kernels/csrc/march_kernels.cu",
                               "ngp_tpu/ops/pallas/march_kernels.py:73",
                               ("coarse_lookup_bits", "bits")),
        "cp_bwd_banks": ("ngp_tpu_torch/ops/kernels/csrc/cp_kernels.cu",
                         "ngp_tpu/ops/pallas/cp_kernels.py:206", ("cp_bwd_banks", "bfloat16")),
        "cp_encode_fwd": ("ngp_tpu_torch/ops/kernels/csrc/cp_kernels.cu",
                          "ngp_tpu/ops/pallas/cp_kernels.py:159",
                          ("cp_encode_fwd", "bfloat16->bfloat16")),
        # on no path: launches stays 0
        "fused_mlp": ("ngp_tpu_torch/ops/kernels/csrc/mlp_kernels.cu",
                      "ngp_tpu/ops/pallas/fused_mlp.py:92", ("fused_mlp", str(MLP_ROWS[0]))),
    }
    kernels = []
    for name, (src, replaces, key) in sources.items():
        err, k_ms, p_ms = results[key]
        launches = sum(c[name] for c in path_counts)
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "max_abs_err": err, "ms": k_ms,
                        "plain_ms": p_ms})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
