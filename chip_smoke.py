#!/usr/bin/env python3
"""Drive the PyTorch port's ``-O`` eval render path once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``ngp_tpu_torch/ops/kernels/csrc``,
builds the turbo-hq NeRF network at full width from a seeded generator
(random weights), refreshes the 128^3 occupancy grid (16 full sweeps,
then one partial refresh, the trainer's cadence), and renders 800x800
frames through ``GridNeRFTrainer.render_frame`` with the default eval
dials. It then checks that each kernel of that path was launched, that
each agrees with its plain PyTorch version at the path's shapes, and
that a small frame rendered on the GPU agrees with the same frame
rendered on the CPU through the plain versions. Every time is printed
beside the card's name and power limit. The last line is a JSON object
``{"ok": true, "device": {...}}``; any failure raises and exits non-zero.
"""

import copy
import json
import math
import os
import subprocess
import sys
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


def compare(name, kernel, plain, dtype):
    """Run kernel and plain on the same inputs; raise past the tolerance.
    Returns (max_abs_err, kernel ms, plain ms), timed plain, kernel,
    kernel, plain."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name} [{dtype}]: non-finite kernel output")
    err = (got - want).abs()
    bound = TOL[dtype] * (1.0 + want.abs())
    if (err > bound).any():
        raise RuntimeError(f"{name} [{dtype}]: max |kernel - plain| {float(err.max())} "
                           f"exceeds {TOL[dtype]} * (1 + |plain|)")
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return float(err.max()), (k1 + k2) / 2, (p1 + p2) / 2


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from ngp_tpu_torch.config import NetworkConfig, RenderConfig
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops.kernels import build, cp, launch_counts, march, reset_launch_counts
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

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

    # 3. the main path: grid refresh, then full frames; counts cover only this
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
    counts = launch_counts()
    print(f"launches: {json.dumps(counts)}")
    for name, n in counts.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the main path")
    for img in images:
        if img.shape != (FRAME, FRAME, 3) or not np.isfinite(img).all():
            raise RuntimeError("frame is not a finite 800x800x3 image")
        if img.min() < 0.0 or img.max() > 1.0:
            raise RuntimeError("frame values outside [0, 1]")
    if trainer.last_render_stats["n_samples"] <= 0:
        raise RuntimeError("the frames rendered no samples")

    # 4. each kernel against its plain version at the path's shapes
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    factors = tuple(f.detach() for f in model.encoder.factors)
    w1, w2 = (w.detach() for w in model.sigma_net.weights)
    color = tuple(w.detach() for w in model.color_net.weights)
    res, fd = nc.cp_resolutions, nc.cp_freq_degree
    rows = {"cp_density_fwd": 128 * 128 * 8, "cp_sigma_rgb": 4096 * 6}
    results = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        fa = tuple(f.to(dt).contiguous() for f in factors)
        a1, a2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
        ca = tuple(w.to(dt).contiguous() for w in color)
        pos = torch.rand((rows["cp_density_fwd"], 3), generator=gen, device=dev) * 1.1 - 0.05
        r = compare("cp_density_fwd",
                    lambda: cp.cp_density_fwd(pos, fa, a1, a2, res, fd),
                    lambda: cp.cp_density_plain(pos, fa, a1, a2, res, fd),
                    dtype)
        results[("cp_density_fwd", dtype)] = r
        pos = torch.rand((rows["cp_sigma_rgb"], 3), generator=gen, device=dev)
        dirs = torch.nn.functional.normalize(
            torch.randn((rows["cp_sigma_rgb"], 3), generator=gen, device=dev), dim=-1)
        r = compare("cp_sigma_rgb",
                    lambda: cp.cp_sigma_rgb(pos, dirs, fa, a1, a2, ca, res, fd,
                                            nc.sh_degree),
                    lambda: cp.cp_sigma_rgb_plain(pos, dirs, fa, a1, a2, ca, res,
                                                  fd, nc.sh_degree),
                    dtype)
        results[("cp_sigma_rgb", dtype)] = r
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

    sources = {
        "cp_density_fwd": ("ngp_tpu_torch/ops/kernels/csrc/cp_kernels.cu",
                           "ngp_tpu/ops/pallas/cp_kernels.py:345"),
        "cp_sigma_rgb": ("ngp_tpu_torch/ops/kernels/csrc/cp_kernels.cu",
                         "ngp_tpu/ops/pallas/cp_kernels.py:506"),
        "coarse_lookup_bits": ("ngp_tpu_torch/ops/kernels/csrc/march_kernels.cu",
                               "ngp_tpu/ops/pallas/march_kernels.py:73"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        key = (name, "bits") if name == "coarse_lookup_bits" else (name, "bfloat16")
        err, k_ms, p_ms = results[key]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[name], "max_abs_err": err, "ms": k_ms,
                        "plain_ms": p_ms})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
