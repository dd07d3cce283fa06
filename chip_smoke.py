#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU: the eval render,
training, and the end of a run (evaluate, test, mesh export), at the
turbo-hq preset and in the hash-grid configuration (``-O --encoding
hashgrid``), then the port's command line: ``-O`` and the rest of
``main_nerf`` (the background net, the renderer without the occupancy
grid, LPIPS).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

(``--probe-scatter`` adds ``scatter_probe`` to phase 9.)
It builds the CUDA kernels from ``ngp_tpu_torch/ops/kernels/csrc`` (and
counts the tensor-core instructions, HMMA, of the two bf16 heads and of
the MLP chain's tensor-core kernel in the library's SASS, and their
spills in the compiler's report; and prints the registers and spills of
the CP factor backward's and encoder's run kernels, whose SASS must call
no 64-bit division routine, and of the turbo march), then

2-3. builds the turbo-hq NeRF network at full width from a seeded
     generator (random weights), refreshes the 128^3 occupancy grid (16
     full sweeps, then one partial refresh), renders 800x800 frames
     through ``GridNeRFTrainer.render_frame`` (the eval path);
4.   holds each kernel against its plain PyTorch version at the paths'
     shapes: the refresh and the eval chunk, the train step's 98,304
     rows for the density forward with residuals and the factor
     backward (and the density forward at the edges of
     ``DENSITY_EDGES`` and at the sigma widths ``WIDE_H1``, the
     radiance head at ``SIGMA_RGB_EDGES``), the mesh export's 65,536-row
     chunk for the CP encoder (on random rows and on one x-slice of the
     256^3 mesh lattice, a save_mesh chunk) and its backward, and 524,288 x
     [32, 64, 64, 16] and [32, 64, 16] for the MLP chain (which no path
     runs); the hash-grid encoder at the refresh chunk (131,072 points) and a
     hash-grid train step (4096 rays x 256 samples = 1,048,576 points)
     on the full-width table (16 levels x 2, 6,119,864 rows), forward
     and table gradient, and the row scatter-add (which no path runs
     any more) at the probe script's shape and one hash level's, with
     ``Tensor.index_add_`` timed beside it; the coarse lookup (which
     only the eval prepass runs) on random cells; the grid kernels' 2-D
     instances on the background net's encoder (4 levels x 2, the
     finest hashed into 2^19 rows) at a background-frame chunk (65,536
     points) and a CLI step's rays (4096), bf16 and f32;
5.   renders a small frame on the GPU and the same frame on the CPU
     through the plain versions;
6.   renders the synthetic scene (16 train frames at 400x400 and one
     val frame) and trains turbo-hq at 16384 rays per step through
     ``GridNeRFTrainer.step`` (grid refresh every 16 steps, Adam, EMA;
     the train path), times the last 128 of 256 steps, and requires a
     finite loss that falls; on the first and last steps' own factor
     backward inputs (positions and d(CP features)) it counts the rows
     that add nothing, prints what the backward's merge finds there
     (``merge_runs``) and holds ``cp_bwd_banks`` against its plain
     version; on every 32nd step's and the last step's own march
     inputs (rays, noise, the grid of that step) it holds
     ``march_turbo`` against its plain version, every ray's samples bit
     for bit;
7.   renders the val pose with the EMA weights and checks its PSNR,
     and holds ``march_turbo`` against its plain version on the frame's
     first 4096-ray chunk;
     then, on the same trainer, ``evaluate`` (PSNR and SSIM, the PSNR
     equal to the frame's), ``test`` (its PNG decodes to the frame) and
     ``save_mesh`` at 256^3 (256 CP-encoder launches through
     ``NeRFNetwork.density``, a non-empty mesh inside the box); then
     profiles an 800x800 frame of the trained model and 16 more train
     steps (device time by kernel, the device's idle share);
8.   runs one small f32 train step on the GPU and the same step on the
     CPU through the plain versions, and compares loss and gradients;
     then a bf16 network with ``hidden_dim=128`` refreshes, takes a
     train step and renders a frame; then (8c) turbo-hq at the CLI's
     default lattice, ``dt_gamma = 1/128``: 192 warm-up and 64 timed
     train steps, 16 profiled steps and one profiled 800x800 frame,
     beside phase 7's ``dt_gamma = 0`` figures, with ``march_turbo``
     held against its plain version on the last timed step's own
     inputs and on the first 4096-ray chunk of an 800x800 frame;
9.   trains the hash-grid configuration at full width on the same scene
     (v1 march, 1024 steps and 256 samples per ray, 4096 rays per step,
     refresh every 16 steps) for 256 steps, times the last 128,
     requires a loss that falls, renders the val pose with the EMA
     weights to a PSNR floor, and profiles 16 more steps; on the first
     and last steps' own encoder inputs (points and bf16 cotangent) it
     holds the encoder's forward against its plain version, counts the
     zero cotangent rows and holds the table gradient against its plain
     version;
10.  runs one small f32 hash-grid train step on the GPU and on the CPU,
     and the card's encoder inputs and cotangents of that step through
     the plain encoder on the CPU, against the card's table gradient;
11.  runs the port's command line (``ngp_tpu_torch.main_nerf``) on the
     scene ``make_synthetic_dataset`` writes to a temporary directory: (a)
     ``<scene> -O --iters 2048 --save_mesh`` in this process (51 epochs,
     one validation and best checkpoint, evaluate and test on the test
     split, the mesh; the loss falls, the test PNGs decode, the mesh is
     not empty, the test PSNR reaches a floor; rays/s over the middle
     epochs beside phase 8c's), (b) the same one epoch longer, which
     must resume at the saved step, (c) ``--test`` as a subprocess, whose
     PSNR must equal (b)'s, (d) ``-O --encoding hashgrid`` with
     ``--tv_weight`` and ``--distortion_weight`` (a finite TV loss, a
     loss that falls) and (e) ``--rand_pose 4`` (its guidance steps run,
     with finite losses);
12.  runs the rest of ``main_nerf`` on the same scene
     (``cli_rest_runs``): (a) ``-O --bg_radius 32 --downscale 4
     --lpips_weights`` (a random-weight checkpoint; 25 epochs; the PSNR
     of the first train views at least ``CLI_BG_MIN_PSNR``, the test
     PSNR beside a white frame's and 11 (a)'s, LPIPS finite, the
     background pass run, the 2-D grid kernels launched and held against
     their plain versions on the first and last steps' own points), (b) no
     ``-O`` at the CLI's defaults (the uniform renderer, hash grid, f32,
     512 samples a ray: 2,097,152 a step; the loss falls, the test PSNR
     beats a white frame's; rays/s, ms a step, one profiled step; the
     3-D grid kernels on the last step's own points), (c) no ``-O`` with
     ``--encoding cpgrid --fp16`` at the turbo-hq widths (the loss
     falls; the CP kernels launched, and held against their plain
     versions at its 2,097,152 rows) and (d) ``-O --encoding hashgrid
     --bg_radius 32`` (the v1 march with the background net).

Each path is run with the launch counts set to 0 just before it and read
just after; a kernel of the path that was not launched fails the run.
Every time is printed beside the card's name and power limit. The line
before the last two is ``{"kernels": [...]}``: per kernel its launches on
the paths, its largest difference from its plain version, its time, the
plain version's, the library call's where one PyTorch call computes the
same function (else null), and its bound, the least time the card could
take for the same work: the larger of the bytes it must move over the
memory rate and its operations over the peak rate of the units that
could do them (``bound``). The last line is a JSON object
``{"ok": true, "device": {...}}``; any failure raises and exits non-zero.
"""

import argparse
import contextlib
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
# and the package's narrowest chain (the hash grid's sigma MLP) at the first
MLP_NARROW = [32, 64, 16]
# phase 8c: the CLI's default adaptive step (main_nerf.py's --dt_gamma); 192
# untimed and 64 timed steps, so that its profiled steps, like phase 7e's,
# follow 16 full grid refreshes and meet a partial one (a full refresh
# makes 16 density chunks, a partial one 4)
CLI_DT_GAMMA = 1 / 128
GAMMA_STEPS = 192
GAMMA_TIMED = 64
# the density head's edges on the card, (rows, None for the model's banks
# or (resolutions, rank, freq degree) of random ones, factor scale): one
# row, a ragged row count (not a multiple of the 128-row tile), rank 12
# (no multiple of 8: the scalar tail of the gathers) with frequency degree
# 2 on two small banks, rank 256 (K 1328: w1 no longer fits in shared
# memory beside the tiles and streams in a chunk at a time), and the
# model's banks scaled by CP_SCALE, so the CP features (then of std ~2
# against ~4e-3) dominate h1 and a wrong bank, axis or tap moves the
# output past its bound
CP_SCALE = 7.5
DENSITY_EDGES = ((1, None, 1.0), (131_071, None, 1.0), (4099, ((32, 64), 12, 2), 1.0),
                 (4099, ((128, 256, 512, 1024, 2048), 256, 6), 1.0),
                 (TRAIN_ROWS, None, CP_SCALE))
# bf16 sigma MLPs wider than the 128-row tensor-core tiles take (64-row tiles
# for 72 and 128 hidden units, 32-row tiles for 256), on the model's banks
WIDE_H1 = (72, 128, 256)
WIDE_ROWS = 4099
# the radiance head's edges on the card, as DENSITY_EDGES, each with its
# sigma width H1, SH degree and colour hidden widths: one row, a ragged row
# count, rank 12 with frequency degree 2, rank 256 (w1 streamed), the model's
# banks scaled by CP_SCALE, and H1 = 128 (64-row tiles) with SH degree 3 and a
# 2-layer colour MLP
EVAL_ROWS = 4096 * 6
SIGMA_RGB_EDGES = ((1, None, 1.0, 64, 4, (64, 64)), (EVAL_ROWS - 1, None, 1.0, 64, 4, (64, 64)),
                   (4099, ((32, 64), 12, 2), 1.0, 64, 4, (64, 64)),
                   (4099, ((128, 256, 512, 1024, 2048), 256, 6), 1.0, 64, 4, (64, 64)),
                   (EVAL_ROWS, None, CP_SCALE, 64, 4, (64, 64)),
                   (EVAL_ROWS, None, 1.0, 128, 3, (64,)))
# one small f32 train step, GPU kernels vs CPU plain versions: the
# loss to 1e-4 relative and each gradient to 1e-3 of its largest entry
# (f32 atomics and summation order); in the hash-grid configuration the
# table's and the first sigma layer's as directional derivatives, to 1e-3
# of sum |g| |d| (train_step_gpu_vs_cpu says why), and the table's
# elementwise against the CPU replay of the card's encoder inputs
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 1e-3
# the hash-grid configuration (main_nerf.py -O --encoding hashgrid): its
# v1 defaults, 4096 rays per step; the encoder's rows at the refresh
# chunk and at a train step's 4096 x 256 sample slots
HASH_RAYS = 4096
HASH_STEPS = 256
HASH_TIMED = 128
GRID_ROWS = (128 * 128 * 8, HASH_RAYS * 256)
# the val frame after HASH_STEPS steps (the first run, on NVIDIA H100 80GB
# HBM3, 700.00 W: 31.70 dB)
MIN_PSNR_HASH = 28.0
# scripts/perf_probe2_r2.py's scatter shape (M rows of W into R), and
# level 0 of the full-width table: a train step's 8 corners of 1,048,576
# points into 4,920 rows of 2
SCATTER_SHAPES = ((2_097_152, 16_384, 128), (8 * HASH_RAYS * 256, 4_920, 2))
# phase 11: the port's CLI (python -m ngp_tpu_torch.main_nerf) on the scene
# that make_synthetic_dataset writes at its defaults (40 train, 4 val and 8
# test frames of 400x400), with the CLI's own 4096 rays a step and dt_gamma:
# 2048 iterations are 51 epochs, so the eval_interval of 50 epochs validates
# once and keeps one best checkpoint; the resume adds one epoch; the
# hash-grid run takes CLI_HASH_ITERS iterations with both losses, the
# guidance run CLI_GUIDE_ITERS with --rand_pose 4 (one epoch: 40 frames and
# 10 guidance steps)
CLI_ITERS = 2048
CLI_FRAMES = (40, 4, 8)
# (a)'s test-split PSNR must reach this, and its loss, the mean of the last 5
# epochs' last steps, fall below LOSS_FALL of the first 5 epochs'. The first
# three runs (NVIDIA H100 80GB HBM3, 700.00 W) read 38.20, 38.23 and 38.31 dB
# (0.11 dB apart), loss ratios 0.003; the floor is the lowest less the wider
# 0.9 dB over which 12 runs of one tree spread at 256 steps
# (scripts/torch_march_psnr_spread.py), rounded down
MIN_PSNR_CLI = 37.0
CLI_HASH_ITERS = 256
CLI_GUIDE_ITERS = 64
CLI_RAND_POSE = 4
# phase 12: the rest of main_nerf on the same scene. (a) turbo-hq with the
# background net on a sphere of radius CLI_BG_RADIUS and LPIPS from a
# random-weight checkpoint, CLI_BG_ITERS iterations (25 epochs: cut from 51
# to hold the smoke's time) on frames of 100x100 (--downscale
# CLI_BG_DOWNSCALE); (b) no -O at the CLI's defaults (hash grid, f32, 512
# samples a ray, 4096 rays: 2,097,152 samples a step), CLI_UNIFORM_ITERS;
# (c) no -O with the CP grid at the turbo-hq widths in bf16, CLI_CP_ITERS;
# (d) the hash grid's v1 march with the background net, CLI_HASH_ITERS.
# On this white-background scene, whose cameras sit inside the box, the
# background net learns the train views on its own and the density field
# stays empty: the test split reads a white frame's PSNR, with the net's
# output or with white in its place (PERF.md). So (a) is held on the first
# CLI_BG_VIEWS train views through evaluate: at least CLI_BG_MIN_PSNR, set
# from its own first runs on NVIDIA H100 80GB HBM3, 700.00 W (20.15 and
# 20.16 dB; a white frame 11.36) and at least 3 dB above a white frame's.
# At 400x400 the net had not learned the views in 1024 iterations
# (epoch-mean loss 0.104 -> 0.045, test PSNR 11.46 dB).
CLI_BG_RADIUS = 32
CLI_BG_ITERS = 1024
CLI_BG_DOWNSCALE = 4
CLI_BG_VIEWS = 8
CLI_BG_MIN_PSNR = 16.0
CLI_UNIFORM_ITERS = 256
CLI_CP_ITERS = 128
CLI_TURBO_HQ = ["--cp_rank", "128", "--cp_freq_degree", "6", "--cp_resolutions", "128", "256",
                "512", "1024", "2048"]
# the background net's encoder (NeRFNetwork.encoder_bg: 4 levels x 2 of 2-D
# points, the finest hashed into 2^19 rows) at a background-frame chunk and a
# CLI train step's rays
BG_GRID = dict(input_dim=2, num_levels=4, log2_hashmap_size=19, desired_resolution=2048)
BG_ROWS = (65536, 4096)
# H100 SXM (NVIDIA's data sheet): HBM bytes/s, dense bf16 tensor-core and
# f32 CUDA-core FLOP/s
HBM_RATE = 3.35e12
BF16_TENSOR_RATE = 989e12
F32_CORE_RATE = 67e12
# the least HBM moves at once: a table row read or written costs its sector
SECTOR = 32
# the profiler trace's event categories that are device work
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, tensor_flops=0.0, core_flops=0.0):
    """(ms, "bytes" or "operations"): the least time of a kernel that reads
    and writes ``n_bytes`` once and does ``tensor_flops`` of matrix
    products (bf16 tensor cores) and ``core_flops`` of other arithmetic
    (f32 CUDA cores)."""
    t_bytes = n_bytes / HBM_RATE
    t_ops = max(tensor_flops / BF16_TENSOR_RATE, core_flops / F32_CORE_RATE)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def inside_rows(pos):
    return ((pos >= 0.0) & (pos <= 1.0)).all(dim=1)


def table_bytes(idx, geom):
    """The bytes of the f32 table rows that idx names (entries < 0 name
    none): each distinct row once, counted in the whole 32-byte sectors
    that HBM moves, and at most the whole table."""
    import torch

    row = geom.level_dim * 4
    idx = idx[idx >= 0].long()
    if row >= SECTOR:
        n = torch.unique(idx).numel() * row
    else:
        n = torch.unique(idx * row // SECTOR).numel() * SECTOR
    return min(n, geom.num_rows * row)


def grid_fwd_work(x, geom, od):
    """(bytes, 0, operations) of the grid forward on points x [B, D]: x
    read, the table rows of every corner of the points inside [0, 1]^D
    read (``table_bytes``), the output of type od written; per (point,
    level) 3 D operations of position, then per corner D - 1 of weight
    and 2 per feature."""
    import torch

    from ngp_tpu_torch.ops.kernels import hashgrid as hk

    D, L, C = geom.input_dim, geom.num_levels, geom.level_dim
    B = x.shape[0]
    idx, _ = hk.grid_encode_bwd_rows_plain(x, torch.ones((B, L * C), device=x.device), geom)
    return (nbytes(x) + table_bytes(idx, geom) + B * L * C * od.itemsize, 0,
            B * L * (3 * D + 2**D * (D - 1 + 2 * C)))


def grid_bwd_work(x, g, geom, idx, rows):
    """(bytes, 0, operations) of the table gradient on points x and
    cotangent g, whose corner rows idx and products rows
    ``grid_encode_bwd_rows_plain`` gives: x and g read, and the table rows
    that receive a non-zero product written (``table_bytes``; the kernel
    adds into no other row, and the zero fill is the wrapper's own
    launch); per (point, level) inside [0, 1]^D with a non-zero
    cotangent, 3 D operations of position, then per corner D - 1 of
    weight and 1 per feature."""
    D, L, C = geom.input_dim, geom.num_levels, geom.level_dim
    live = int(((g.view(-1, L, C) != 0).any(dim=2) & inside_rows(x)[:, None]).sum())
    return (nbytes(x, g) + table_bytes(idx[(rows != 0).any(dim=1)], geom), 0,
            live * (3 * D + 2**D * (D - 1 + C)))


def scatter_bound(ks, idx, rows, num_rows):
    """Two f32 sums of the same n terms in different orders differ by at
    most 2 (n - 1) 2^-24 times the sum of the terms' magnitudes."""
    import torch

    zeros = torch.zeros((num_rows, rows.shape[1]), device=rows.device)
    adds = ks.scatter_add_rows_plain(idx, torch.ones_like(rows), zeros.clone())
    s_abs = ks.scatter_add_rows_plain(idx, rows.abs(), zeros)
    return 2.0 * 2.0**-24 * adds * s_abs


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


def compare(name, kernel, plain, dtype, work, tol=None):
    """Run kernel and plain on the same inputs; raise past the tolerance,
    by default TOL[dtype] * (1 + |plain|); ``tol(want)`` gives one
    bound tensor per output instead. Outputs may be tuples. ``work`` is
    (bytes, tensor-core FLOPs, CUDA-core FLOPs) of the function. Returns
    (max_abs_err, kernel ms, plain ms, (bound ms, what bounds it)), timed
    plain, kernel, kernel, plain."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    bounds = tol(want) if tol else [TOL[dtype] * (1.0 + w.float().abs()) for w in want]
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
    return err_max, (k1 + k2) / 2, (p1 + p2) / 2, bound(*work)


def density_bound(cp, pos, factors, res, want):
    """cp_density_fwd with residuals, bf16: out and h1 to TOL, as
    ``compare``; the feats are rounded once from f32 values that both
    compute alike up to the order of f32 operations, so each is held to
    one bf16 step (2^-7 |plain|) plus, for a CP column, 2^-20 of the sum
    of its terms' magnitudes (three f32 lerps and two products) and, for
    a frequency column, 2^-14 (the double-angle ladder doubles a few f32
    ulps of sin and cos per octave)."""
    import torch

    out, feats, h1 = want
    mag = cp.cp_features_plain(pos, [f.abs() for f in factors], res)
    slack = torch.full(feats.shape, 2.0**-14, device=feats.device)
    slack[:, :mag.shape[1]] = 2.0**-20 * mag
    return [TOL["bfloat16"] * (1.0 + out.abs()), 2.0**-7 * feats.float().abs() + slack,
            TOL["bfloat16"] * (1.0 + h1.float().abs())]


def bwd_bound(cp, pos, factors, g_cp, res, want):
    """cp_bwd_banks sums by f32 atomics in no fixed order: per entry,
    2^-13 of the sum of its absolute contributions, plus (bf16 output)
    2^-7 * |plain|, a half step of each of the two roundings to bf16."""
    s_abs = cp.cp_bwd_banks_plain(pos, [f.abs() for f in factors], g_cp.abs(), res)
    ulp = 2.0**-7 if factors[0].dtype.itemsize == 2 else 0.0
    return [2.0**-13 * s.float() + ulp * w.float().abs() for s, w in zip(s_abs, want)]


def profile(fn, n, what, card, focus=()):
    """Where the time of ``n`` calls of ``fn`` goes (``what``: "step" or
    "frame"): ``torch.profiler`` over them, the device time of each kernel
    (and copy) by name, the device's busy share of the host wall time,
    launches per call, and the device time and share of busy time of the
    kernels whose names hold a string of ``focus``. Returns (device ms
    per call, launches per call, idle share)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # (device ms, count) by name from the profiler's trace (a frame's
    # 51,000 launches make key_averages() take about a minute of host
    # time): kernels, copies and fills only, not the device ranges of
    # annotations (the optimizer's), which overlap the kernels inside them
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("cat") in DEVICE_ACTIVITIES:
            ms, count = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (ms + e["dur"] / 1e3, count + 1)
    del events
    rows = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    busy = sum(ms for ms, _ in by_name.values())
    launches = sum(count for _, count in by_name.values())
    if launches == 0:
        raise RuntimeError(f"the profile of {n} {what}s holds no device activity")
    print(f"profile of {n} {what}s: wall {wall * 1e3 / n:.2f} ms per {what}, device busy "
          f"{busy / n:.2f} ms per {what}, idle share {1.0 - busy / (wall * 1e3):.3f}, "
          f"{launches / n:.0f} device launches per {what}  [{card}]")
    for key, (ms, count) in rows[:14]:
        print(f"  {ms / n:8.3f} ms/{what}  {count / n:8.1f}x  {key[:110]}")
    for name in focus:
        ms = sum(t for key, (t, _) in rows if name in key) / n
        count = sum(c for key, (_, c) in rows if name in key) / n
        print(f"  {name}: {ms:.3f} ms per {what} in {count:.0f} launches, "
              f"{ms * n / max(busy, 1e-9):.3f} of the device busy time  [{card}]")
    return busy / n, launches / n, 1.0 - busy / (wall * 1e3)


def ptxas_usage(report, kernel):
    """[(entry function, registers, bytes of spill stores)] that ``ptxas
    -v`` reports for each instance of ``kernel``; raises if the report
    does not name it."""
    found, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
            if name:
                found.append([name, 0, 0])
        elif name and "spill stores" in line:
            found[-1][2] += int(line.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in line and "registers" in line:
            found[-1][1] = int(line.split("Used")[1].split("registers")[0])
    if not found:
        raise RuntimeError(f"the compiler report does not name {kernel}")
    return [tuple(f) for f in found]


def head_weights(gen, dev, dt, D, H1, OUT, sh, hidden):
    """Random bias-free weights of a radiance head: w1 [D, H1], w2
    [H1, OUT] and the colour layers [sh^2 + OUT - 1, *hidden, 3], each
    scaled by 1/sqrt(its fan-in)."""
    import torch

    cdims = [sh * sh + OUT - 1, *hidden, 3]

    def layer(a, b):
        return (torch.randn((a, b), generator=gen, device=dev) / a**0.5).to(dt)

    return (layer(D, H1), layer(H1, OUT),
            tuple(layer(cdims[i], cdims[i + 1]) for i in range(len(cdims) - 1)))


def sass_lines(lib_path, kernel):
    """The SASS instruction lines of every function of the built library
    whose name holds ``kernel``, from ``cuobjdump --dump-sass``."""
    from ngp_tpu_torch.ops.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    lines, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            lines.append(line)
    return lines


def merge_runs(pos, g_cp, res, rank):
    """What the factor backward's merge finds on these rows, computed here
    from the taps as the kernel makes them: per bank, its live rows
    (inside the box, g not all zero in the bank's columns), the mean
    number of live rows one running sum covers per axis (within a warp's
    run of 32 rows, while the axis's tap i0 repeats), and the 16-byte
    atomics the merge issues per column group (2 per sum, one fewer after
    a move by one) beside 6 per live row without it."""
    import torch

    inside = inside_rows(pos)
    out = []
    for b, r in enumerate(res):
        live = (inside & (g_cp[:, b * rank:(b + 1) * rank] != 0).any(dim=1)).nonzero()[:, 0]
        i0 = torch.clamp(torch.floor(pos[live].clamp(0.0, 1.0) * (r - 1)), max=r - 2).long()
        run = live // 32
        same_run = torch.zeros_like(run, dtype=torch.bool)
        same_run[1:] = run[1:] == run[:-1]
        lengths, atomics = [], 0
        for ax in range(3):
            step = torch.zeros_like(i0[:, ax])
            step[1:] = i0[1:, ax] - i0[:-1, ax]
            sums = int((~same_run | (step != 0)).sum())
            shifts = int((same_run & (step.abs() == 1)).sum())
            lengths.append(live.numel() / max(sums, 1))
            atomics += 2 * sums - shifts
        out.append((r, live.numel(), lengths, atomics))
    return out


def scatter_probe(x, g, geom, idx, rows, nz, s_bound, label, card, results, library):
    """The two-kernel design the table gradient replaced, on one step's
    own corner rows (``--probe-scatter``): the corner rows (their plain
    version, on the card), then ``scatter_add_rows``, beside
    ``index_add_`` on the same rows, and the scatter on variants of the
    rows that tell its costs apart (zero products skipped, only the
    non-zero rows in step order, the same rows shuffled)."""
    import torch

    from ngp_tpu_torch.ops.kernels import hashgrid as hk
    from ngp_tpu_torch.ops.kernels import scatter as sk

    R, C = geom.num_rows, geom.level_dim
    outs = [torch.zeros((R, C), device=x.device) for _ in range(3)]
    key = ("scatter_add_rows", f"{label}: {idx.numel()}x{C} into {R}")
    results[key] = compare(
        "scatter_add_rows", lambda: sk.scatter_add_rows(idx, rows, outs[0]),
        lambda: sk.scatter_add_rows_plain(idx, rows, outs[1]), "float32",
        (nbytes(idx, rows, outs[0]), 0, idx.numel() * C), tol=lambda want: [s_bound])
    keep = idx >= 0
    idx_l = torch.where(keep, idx, 0).long()
    rows_l = torch.where(keep[:, None], rows, torch.zeros((), device=x.device))
    library[key] = cuda_ms(lambda: outs[2].index_add_(0, idx_l, rows_l))
    del idx_l, rows_l
    t_rows = cuda_ms(lambda: hk.grid_encode_bwd_rows_plain(x, g, geom), reps=3)
    idx_skip = torch.where(nz, idx, -1)
    t_skip = cuda_ms(lambda: sk.scatter_add_rows(idx_skip, rows, outs[2]))
    idx_nz, rows_nz = idx[nz].contiguous(), rows[nz].contiguous()
    t_nz = cuda_ms(lambda: sk.scatter_add_rows(idx_nz, rows_nz, outs[2]))
    perm = torch.randperm(idx_nz.numel(), device=x.device)
    idx_sh, rows_sh = idx_nz[perm].contiguous(), rows_nz[perm].contiguous()
    t_sh = cuda_ms(lambda: sk.scatter_add_rows(idx_sh, rows_sh, outs[2]))
    print(f"hash step {label}: corner rows (plain, on the card) {t_rows:.4f} ms, then "
          f"scatter_add_rows {results[key][1]:.4f} ms (index_add_ {library[key]:.4f} ms); the "
          f"scatter with zero products skipped {t_skip:.4f} ms, on the {idx_nz.numel()} "
          f"non-zero rows alone {t_nz:.4f} ms, the same shuffled {t_sh:.4f} ms  [{card}]",
          flush=True)


def step_table_gradient(x, g, geom, label, card, results, library, probe):
    """The hash step's table gradient on one step's own encoder inputs
    (points x [B, 3] f32, cotangent g [B, L*C] bf16): the zero rows of g
    and the non-zero corner products, then ``grid_encode_bwd`` against
    its plain version (and, with ``probe``, ``scatter_probe``)."""
    from ngp_tpu_torch.ops.kernels import hashgrid as hk
    from ngp_tpu_torch.ops.kernels import scatter as sk

    zero_rows = float((g == 0).all(dim=1).float().mean())
    idx, rows = hk.grid_encode_bwd_rows_plain(x, g, geom)
    nz = (rows != 0).any(dim=1) & (idx >= 0)
    n_nz = int(nz.sum())
    print(f"hash step {label}: {x.shape[0]} points, {zero_rows:.4f} of the cotangent rows exactly "
          f"zero, {n_nz} of {idx.numel()} corner rows with a non-zero product "
          f"({n_nz / idx.numel():.4f})", flush=True)
    s_bound = scatter_bound(sk, idx, rows, geom.num_rows)
    if probe:
        scatter_probe(x, g, geom, idx, rows, nz, s_bound, label, card, results, library)
    work = grid_bwd_work(x, g, geom, idx, rows)
    del idx, rows, nz
    results[("grid_encode_bwd", label)] = compare(
        "grid_encode_bwd", lambda: hk.grid_encode_bwd(x, g, geom),
        lambda: hk.grid_encode_bwd_plain(x, g, geom), "bfloat16", work,
        tol=lambda want: [s_bound])


def grid_checks(hk, sk, x, table, geom, od, g, label, results):
    """``grid_encode_fwd`` and ``grid_encode_bwd`` on points x [B, D] against
    their plain versions: the forward to TOL of the output type, the table
    gradient (cotangent g) within the f32 summation-order bound
    (``scatter_bound``); work as ``grid_fwd_work`` and ``grid_bwd_work``
    count it."""
    idx, rows = hk.grid_encode_bwd_rows_plain(x, g, geom)
    s_bound = scatter_bound(sk, idx, rows, geom.num_rows)
    bwd_work = grid_bwd_work(x, g, geom, idx, rows)
    del idx, rows
    results[("grid_encode_fwd", label)] = compare(
        "grid_encode_fwd", lambda: hk.grid_encode_fwd(x, table, geom, od),
        lambda: hk.grid_encode_plain(x, table, geom, od), str(od).split(".")[-1],
        grid_fwd_work(x, geom, od))
    results[("grid_encode_bwd", label)] = compare(
        "grid_encode_bwd", lambda: hk.grid_encode_bwd(x, g, geom),
        lambda: hk.grid_encode_bwd_plain(x, g, geom), str(g.dtype).split(".")[-1], bwd_work,
        tol=lambda want: [s_bound])


def step_factor_gradient(pos, factors, g_cp, res, label, card, results):
    """``cp_bwd_banks`` on one turbo-hq train step's own inputs
    (positions, the step's bf16 factors, d(CP features)): the rows that
    add nothing, what the backward's merge finds (``merge_runs``), then
    the kernel against its plain version with the factors in bf16 and in
    f32."""
    import torch

    from ngp_tpu_torch.ops.kernels import cp

    rank = factors[0].shape[-1]
    outside = 1.0 - float(inside_rows(pos).float().mean())
    zero = float((g_cp == 0).all(dim=1).float().mean())
    print(f"train step {label}: {pos.shape[0]} rows, {outside:.4f} outside the box, {zero:.4f} "
          "with d(CP features) all zero", flush=True)
    live_rows = 0
    for r, live, lengths, atomics in merge_runs(pos, g_cp, res, rank):
        live_rows += live
        print(f"  bank {r}: {live} live rows, mean run length x {lengths[0]:.3f} y "
              f"{lengths[1]:.3f} z {lengths[2]:.3f}; {atomics} 16-byte atomics per column "
              f"group, {6 * live} unmerged", flush=True)
    for dtype in ("bfloat16", "float32"):
        fa = tuple(f.to(getattr(torch, dtype)) for f in factors)
        results[("cp_bwd_banks", label + ("" if dtype == "bfloat16" else " f32"))] = compare(
            "cp_bwd_banks", lambda: cp.cp_bwd_banks(pos, fa, g_cp, res),
            lambda: cp.cp_bwd_banks_plain(pos, fa, g_cp, res), dtype,
            (nbytes(pos, g_cp, *fa, *fa), 0, 24 * live_rows * rank),
            tol=lambda want: bwd_bound(cp, pos, fa, g_cp, res, want))


def print_results(results, library, card, printed):
    """Print the kernel comparisons not in ``printed``; returns the keys
    printed so far."""
    for key, (err, k_ms, p_ms, (b_ms, b_by)) in results.items():
        if key in printed:
            continue
        lib = library.get(key)
        lib = "" if lib is None else f", index_add_ {lib:.4f} ms"
        print(f"kernel {key[0]} [{key[1]}]: max_abs_err {err:.3e}, kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms{lib}, bound {b_ms:.4f} ms ({b_by})  [{card}]")
    return printed | set(results)


def check_launched(path, counts, names, absent=()):
    """Raise unless each kernel of ``names`` and none of ``absent`` was
    launched on the path."""
    print(f"launches [{path}]: {json.dumps(counts)}", flush=True)
    for name in names:
        if counts[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the {path} path")
    for name in absent:
        if counts[name] != 0:
            raise RuntimeError(f"kernel {name} was launched {counts[name]} times on the {path} "
                               "path")


def record_marches(occupancy, keep):
    """Wrap the march kernel that ``march_rays_turbo`` calls: call n's
    inputs (cloned) go into the returned dict under ``keep(n, rays)``'s
    label, unless it returns None. Returns (the dict, a function that
    restores the kernel)."""
    seen, calls, launch = {}, [0], occupancy.march_turbo

    def record(rays_o, rays_d, coarse, fine, cfg, S, K2, U, aabb=None, t_range=None,
               noise=None):
        label = keep(calls[0], rays_o.shape[0])
        calls[0] += 1
        if label is not None and label not in seen:
            def c(t):
                return t.clone() if hasattr(t, "clone") else t
            seen[label] = ((rays_o.clone(), rays_d.clone(), coarse.clone(), fine.clone(), cfg, S,
                            K2, U), dict(aabb=c(aabb), t_range=c(t_range), noise=c(noise)))
        return launch(rays_o, rays_d, coarse, fine, cfg, S, K2, U, aabb=aabb, t_range=t_range,
                      noise=noise)

    occupancy.march_turbo = record

    def restore():
        occupancy.march_turbo = launch
        return calls[0]

    return seen, restore


def compare_march(label, args, kw, card, results):
    """``march_turbo`` against its plain version on one march's own
    inputs: every ray's near, far, samples, steps, mask and count bit for
    bit, the drop estimate to 1e-6 relative; then the times (plain, kernel,
    kernel, plain). Bound: the rays (and noise, t_range) read once, the
    coarse payload, one 8-byte fine word per sample, the outputs written
    once."""
    import torch

    from ngp_tpu_torch.ops.kernels import march

    got = march.march_turbo(*args, **kw)
    want = march.march_turbo_plain(*args, **kw)
    torch.cuda.synchronize()
    differ = (((got["ts"] != want["ts"]) | (got["mask"] != want["mask"])
               | (got["deltas"] != want["deltas"])).any(dim=1) | (got["n_total"] != want["n_total"])
              | (got["nears"] != want["nears"]) | (got["fars"] != want["fars"]))
    n_diff = int(differ.sum())
    nd_err = (got["n_dropped"] - want["n_dropped"]).abs()
    err = max(float((got[k].float() - want[k].float()).abs().max())
              for k in ("ts", "deltas", "n_dropped", "n_total"))
    N, S = got["ts"].shape
    n_samples = int(got["mask"].sum())
    print(f"march_turbo [{label}]: {N} rays x {S} slots, {n_samples} samples, {n_diff} rays "
          f"differ from the plain version, n_dropped {float(got['n_dropped'].sum()):.1f} "
          f"(max |kernel - plain| {float(nd_err.max()):.3e})", flush=True)
    if n_diff or not (nd_err <= 1e-6 * want["n_dropped"].abs()).all():
        raise RuntimeError(f"march_turbo [{label}]: {n_diff} rays differ from the plain version")
    ins = [t for t in (*args[:2], kw.get("t_range"), kw.get("noise")) if torch.is_tensor(t)]
    n_bytes = nbytes(*ins, args[2], *got.values()) + 8 * n_samples
    p1 = cuda_ms(lambda: march.march_turbo_plain(*args, **kw))
    k1 = cuda_ms(lambda: march.march_turbo(*args, **kw))
    k2 = cuda_ms(lambda: march.march_turbo(*args, **kw))
    p2 = cuda_ms(lambda: march.march_turbo_plain(*args, **kw))
    results[("march_turbo", label)] = (err, (k1 + k2) / 2, (p1 + p2) / 2, bound(n_bytes))


def gamma_window(dev, card, rc, nc, train_ds, results):
    """turbo-hq at the CLI's default lattice (``dt_gamma = 1/128``, about
    218 probes a ray): a fresh network trained GAMMA_STEPS steps, then
    GAMMA_TIMED timed, 16 steps and one 800x800 frame of the trained
    model under the profiler; ``march_turbo`` held against its plain
    version on the last timed step's own inputs and on the first
    4096-ray chunk of the unprofiled frame (its recurrence branch).
    Returns (rays/s, the timed steps' launch counts, the frame's launch
    counts, the step profile, the frame profile)."""
    import dataclasses

    import torch

    from ngp_tpu_torch.config import TrainConfig
    from ngp_tpu_torch.models import occupancy
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

    grc = dataclasses.replace(rc, dt_gamma=CLI_DT_GAMMA)
    model = NeRFNetwork(nc, grc, torch.Generator().manual_seed(SEED), device=dev)
    with tempfile.TemporaryDirectory() as ws:
        tc = TrainConfig(iters=30000, lr=1e-2, num_rays=TRAIN_RAYS, update_extra_interval=16,
                         workspace=ws)
        trainer = GridNeRFTrainer(model, grc, tc, seed=SEED)
        trainer.mark_untrained(train_ds.poses, train_ds.intrinsics, train_ds.H, train_ds.W)
        epoch_iter = trainer.make_loader(train_ds)
        batches = itertools.chain.from_iterable(epoch_iter() for _ in itertools.count())
        last = GAMMA_STEPS + GAMMA_TIMED - 1
        march_seen, restore_march = record_marches(
            occupancy, lambda n, _: f"dt_gamma {CLI_DT_GAMMA} step {n}" if n == last else None)
        for _ in range(GAMMA_STEPS):
            trainer.step(next(batches))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        losses = [trainer.step(next(batches))["loss"] for _ in range(GAMMA_TIMED)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        step_counts = launch_counts()
        if restore_march() != last + 1:
            raise RuntimeError(f"dt_gamma {CLI_DT_GAMMA}: not one march a step")
        loss = float(torch.stack(losses).mean())
        rays_s = GAMMA_TIMED * TRAIN_RAYS / dt
        print(f"dt_gamma {CLI_DT_GAMMA}: {GAMMA_TIMED / dt:.2f} steps/s, {rays_s:.0f} rays/s over "
              f"steps {GAMMA_STEPS}-{GAMMA_STEPS + GAMMA_TIMED - 1}, mean loss {loss:.6f}  "
              f"[{card}]", flush=True)
        if not math.isfinite(loss):
            raise RuntimeError(f"dt_gamma {CLI_DT_GAMMA}: non-finite loss")
        pose, intr = orbit_pose(0.7), intrinsics(FRAME)
        chunk = f"dt_gamma {CLI_DT_GAMMA} eval chunk"
        frame_seen, restore_march = record_marches(
            occupancy, lambda n, rays: chunk if rays == 4096 else None)
        reset_launch_counts()
        img, _ = trainer.render_frame(pose, intr, FRAME, FRAME)
        frame_counts = launch_counts()
        restore_march()
        if not (img.shape == (FRAME, FRAME, 3) and (img >= 0).all() and (img <= 1).all()):
            raise RuntimeError(f"dt_gamma {CLI_DT_GAMMA}: the frame is not an image in [0, 1]")
        march_seen.update(frame_seen)
        if len(march_seen) != 2:
            raise RuntimeError(f"dt_gamma {CLI_DT_GAMMA}: marches caught {sorted(march_seen)}")
        for label, (m_args, m_kw) in march_seen.items():
            compare_march(label, m_args, m_kw, card, results)
        del march_seen, frame_seen
        frame_prof = profile(lambda: trainer.render_frame(pose, intr, FRAME, FRAME), 1, "frame",
                             card, focus=("march", "coarse_lookup"))
        step_prof = profile(lambda: trainer.step(next(batches)), 16, "step", card,
                            focus=("march", "topk"))
    return rays_s, step_counts, frame_counts, step_prof, frame_prof


@contextlib.contextmanager
def cli_recorder(dev, card):
    """Run ``ngp_tpu_torch.main_nerf`` in this process and see what it does:
    yields (seen, run). ``run(argv, label)`` clears ``seen``, resets the
    launch counts, runs ``main(argv)`` on the card and returns (trainer,
    launch counts, seconds, the loss readings). ``seen`` then holds each
    epoch's wall time (its last step's loss read to the host ends it),
    evaluate's results and wall times, test's wall time, the guidance
    steps' losses, the step a checkpoint load resumed at, the calls of
    the background-frame pass and every train step's loss (a device
    scalar); ``NeRFTrainer``'s methods are wrapped at
    class level for it and restored after."""
    import numpy as np
    import torch

    from ngp_tpu_torch import main_nerf
    from ngp_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ngp_tpu_torch.training.nerf import NeRFTrainer

    seen = {"epochs": [], "evaluate": [], "results": [], "evaluate_s": [], "test_s": [],
            "guidance": [], "loaded": [], "bg_frames": [], "step_losses": []}
    names = ("train_one_epoch", "evaluate", "test", "guidance_step", "load_checkpoint",
             "_render_bg_frames", "train_step")
    original = {k: getattr(NeRFTrainer, k) for k in names}

    def train_one_epoch(self, loader):
        t0 = time.perf_counter()
        original["train_one_epoch"](self, loader)
        seen["epochs"].append(time.perf_counter() - t0)

    def evaluate(self, *a, **kw):
        t0 = time.perf_counter()
        out = original["evaluate"](self, *a, **kw)
        seen["evaluate_s"].append(time.perf_counter() - t0)
        seen["evaluate"].append(out["psnr"])
        seen["results"].append(out)
        return out

    def test(self, *a, **kw):
        t0 = time.perf_counter()
        out = original["test"](self, *a, **kw)
        seen["test_s"].append(time.perf_counter() - t0)
        return out

    def guidance_step(self, *a, **kw):
        out = original["guidance_step"](self, *a, **kw)
        seen["guidance"].append(out["loss"])
        return out

    def load_checkpoint(self, *a, **kw):
        loaded = original["load_checkpoint"](self, *a, **kw)
        seen["loaded"].append(self.global_step if loaded else None)
        return loaded

    def render_bg_frames(self, *a, **kw):
        out = original["_render_bg_frames"](self, *a, **kw)
        seen["bg_frames"].append(out.shape[0])
        return out

    def train_step(self, *a, **kw):
        out = original["train_step"](self, *a, **kw)
        seen["step_losses"].append(out["loss"])  # on the device: no sync
        return out

    def run(argv, label):
        for v in seen.values():
            v.clear()
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer = main_nerf.main(argv, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        losses = np.array(trainer.stats["loss"], np.float64)
        print(f"CLI {label}: {dt:.3f} s, global step {trainer.global_step}, {len(losses)} loss "
              f"readings, first {losses[:1]}, last {losses[-1:]}  [{card}]", flush=True)
        if not np.isfinite(losses).all():
            raise RuntimeError(f"CLI {label}: non-finite loss")
        return trainer, counts, dt, losses

    patched = {"train_one_epoch": train_one_epoch, "evaluate": evaluate, "test": test,
               "guidance_step": guidance_step, "load_checkpoint": load_checkpoint,
               "_render_bg_frames": render_bg_frames, "train_step": train_step}
    for k, fn in patched.items():
        setattr(NeRFTrainer, k, fn)
    try:
        yield seen, run
    finally:
        for k in names:
            setattr(NeRFTrainer, k, original[k])


def cli_runs(dev, card, scene, api_rays_s):
    """Phase 11: ``ngp_tpu_torch.main_nerf`` on the scene on disk, as a user
    runs it. (a) turbo-hq through ``main`` in this process, (b) the same
    command one epoch longer, resuming from ``--ckpt latest``, (c) ``--test``
    as a subprocess on the checkpoint (b) wrote, whose PSNR must equal
    (b)'s ``evaluate`` (both start from a fresh trainer: the eval's sticky
    chunk counts and spans, which (a)'s validation frames raised, are then
    the same), (d) the hash grid with the TV and distortion losses, (e)
    the random-pose guidance steps. Returns the launch counts of (a), (b),
    (d) and (e), (a)'s rays/s over its middle epochs and its test PSNR."""
    import numpy as np
    import torch

    from ngp_tpu_torch.utils.png import read_png

    n_train, n_val, n_test = CLI_FRAMES
    with tempfile.TemporaryDirectory() as tmp, cli_recorder(dev, card) as (seen, run):
        # (a) turbo-hq, 51 epochs, one validation, evaluate, test, mesh
        ws = os.path.join(tmp, "ws")
        argv = [scene, "-O", "--workspace", ws, "--iters", str(CLI_ITERS), "--save_mesh"]
        trainer, a_counts, a_dt, losses = run(argv, "(a) -O")
        check_launched("CLI (a) -O", a_counts,
                       ("cp_density_fwd", "cp_bwd_banks", "march_turbo", "cp_sigma_rgb",
                        "coarse_lookup_bits", "cp_encode_fwd"))
        epochs = CLI_ITERS // n_train
        if trainer.epoch != epochs or len(seen["epochs"]) != epochs:
            raise RuntimeError(f"CLI (a): epoch {trainer.epoch}, {len(seen['epochs'])} "
                               f"epochs run, want {epochs}")
        # the timed middle: epochs 2 to the last but one (the first has
        # the first calls; the last is followed by evaluate, test, mesh)
        mid = seen["epochs"][1:-1]
        rays_s = len(mid) * n_train * trainer.train_cfg.num_rays / sum(mid)
        if not losses[-5:].mean() < LOSS_FALL * losses[:5].mean():
            raise RuntimeError(f"CLI (a): the loss did not fall below {LOSS_FALL} of "
                               "its start (the first and last 5 epochs' last steps)")
        ckpts = sorted(os.listdir(os.path.join(ws, "checkpoints")))
        if f"{trainer.name}_best.pth" not in ckpts:
            raise RuntimeError(f"CLI (a): no best checkpoint in {ckpts}")
        a_eval = seen["evaluate"]
        if len(a_eval) != 2:  # the validation at epoch 50, the test split
            raise RuntimeError(f"CLI (a): {len(a_eval)} evaluate calls, want 2")
        psnr_a = a_eval[-1]
        results_dir = os.path.join(ws, "results")
        for i in range(n_test):
            png = read_png(os.path.join(results_dir, f"{trainer.name}_{i:04d}_rgb.png"))
            if png.shape != (400, 400, 3):
                raise RuntimeError(f"CLI (a): test PNG {i} has shape {png.shape}")
        mesh = trainer.last_mesh_stats
        if mesh.get("n_verts", 0) == 0 or mesh.get("n_faces", 0) == 0:
            raise RuntimeError(f"CLI (a): empty mesh {mesh}")
        if not psnr_a >= MIN_PSNR_CLI:
            raise RuntimeError(f"CLI (a): test-split PSNR {psnr_a} under {MIN_PSNR_CLI}")
        print(f"CLI (a): {a_dt:.3f} s wall for {CLI_ITERS} iterations ({epochs} epochs) with "
              f"one validation, evaluate, test and save_mesh; {rays_s:.0f} rays/s over "
              f"epochs 2-{epochs - 1} at {trainer.train_cfg.num_rays} rays a step (phase 8c, "
              f"the API at {TRAIN_RAYS} rays a step and the same dt_gamma: "
              f"{api_rays_s:.0f}); loss {losses[:5].mean():.6f} -> {losses[-5:].mean():.6f}; "
              f"test split PSNR {psnr_a:.4f} dB over {n_test} frames; mesh {mesh['n_verts']} "
              f"vertices, {mesh['n_faces']} faces  [{card}]", flush=True)
        ev_s, test_s = seen["evaluate_s"], seen["test_s"][0]
        mesh_s = mesh["density_s"] + mesh["marching_s"] + mesh["write_s"]
        rest = a_dt - sum(seen["epochs"]) - sum(ev_s) - test_s - mesh_s
        print(f"CLI (a) host loop: epochs {min(mid):.3f}-{max(mid):.3f} s (first "
              f"{seen['epochs'][0]:.3f}, last {seen['epochs'][-1]:.3f}); validation "
              f"({n_val} frames) {ev_s[0]:.3f} s, evaluate ({n_test} frames) {ev_s[1]:.3f} "
              f"s, test {test_s:.3f} s, save_mesh {mesh_s:.3f} s (OBJ {mesh['write_s']:.3f}); "
              f"the rest (loading the splits, checkpoints) {rest:.3f} s  [{card}]",
              flush=True)
        saved_step = trainer.global_step
        del trainer

        # (b) resume: one epoch more from the latest checkpoint
        argv[argv.index("--iters") + 1] = str(CLI_ITERS + n_train)
        trainer, b_counts, _, _ = run(argv, "(b) --ckpt latest")
        if seen["loaded"] != [saved_step] or trainer.global_step != saved_step + n_train:
            raise RuntimeError(f"CLI (b): resumed at {seen['loaded']}, ended at "
                               f"{trainer.global_step}; saved at {saved_step}")
        check_launched("CLI (b) resume", b_counts, ("cp_bwd_banks", "march_turbo"))
        psnr_b = seen["evaluate"][-1]
        del trainer

        # (c) --test as a subprocess, from the repository root
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "ngp_tpu_torch.main_nerf", scene, "-O",
                              "--workspace", ws, "--test"],
                             cwd=os.path.dirname(os.path.abspath(__file__)),
                             capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"CLI (c) --test: exit {res.returncode}\n{res.stderr[-3000:]}")
        found = [ln for ln in res.stdout.splitlines() if "evaluate: PSNR = " in ln]
        if len(found) != 1:
            raise RuntimeError(f"CLI (c) --test: no evaluate line\n{res.stdout[-3000:]}")
        psnr_c = float(found[0].split("PSNR = ")[1].split()[0])
        print(f"CLI (c) --test subprocess: {dt:.3f} s, evaluate PSNR {psnr_c:.6f} dB; the "
              f"resumed run's {psnr_b:.6f}, (a)'s {psnr_a:.6f}  [{card}]", flush=True)
        if f"{psnr_c:.6f}" != f"{psnr_b:.6f}":
            raise RuntimeError(f"CLI (c): --test PSNR {psnr_c} differs from the resumed "
                               f"run's {psnr_b} on the same checkpoint")

        # (d) the hash grid with the TV and distortion losses
        ws_d = os.path.join(tmp, "ws_hash")
        trainer, d_counts, _, losses = run(
            [scene, "-O", "--encoding", "hashgrid", "--workspace", ws_d, "--iters",
             str(CLI_HASH_ITERS), "--tv_weight", "1e-6", "--distortion_weight", "1e-3"],
            "(d) hashgrid + tv + distortion")
        check_launched("CLI (d) hashgrid", d_counts, ("grid_encode_fwd", "grid_encode_bwd"))
        with torch.no_grad():
            tv = float(trainer.model.tv_loss())
        print(f"CLI (d): tv_loss {tv:.6e}, loss {losses[0]:.6f} -> {losses[-1]:.6f}, test "
              f"split PSNR {seen['evaluate'][-1]:.4f} dB  [{card}]", flush=True)
        if not (math.isfinite(tv) and tv > 0 and losses[-1] < losses[0]):
            raise RuntimeError(f"CLI (d): tv_loss {tv}, losses {losses}")
        del trainer

        # (e) the random-pose guidance steps
        ws_e = os.path.join(tmp, "ws_guide")
        trainer, e_counts, _, _ = run(
            [scene, "-O", "--rand_pose", str(CLI_RAND_POSE), "--workspace", ws_e,
             "--iters", str(CLI_GUIDE_ITERS)], "(e) --rand_pose")
        g = [float(x) for x in seen["guidance"]]
        want = n_train // CLI_RAND_POSE
        print(f"CLI (e): {len(g)} guidance steps, losses {np.round(g, 6).tolist()}, global "
              f"step {trainer.global_step}  [{card}]", flush=True)
        if len(g) != want or not np.isfinite(g).all() or trainer.global_step != n_train + want:
            raise RuntimeError(f"CLI (e): {len(g)} guidance steps (want {want}), losses {g}, "
                               f"global step {trainer.global_step}")
        del trainer
    return (a_counts, b_counts, d_counts, e_counts), rays_s, psnr_a


def cli_steps(iters):
    """The train steps of a CLI run of ``iters`` iterations: whole epochs of
    the scene's train split (``main_nerf``: max(1, iters // frames))."""
    return max(1, iters // CLI_FRAMES[0]) * CLI_FRAMES[0]


def write_lpips_checkpoint(path):
    """Random AlexNet-LPIPS weights from the seed, saved as torchvision's
    ``features.*`` and the heads' ``lins.<i>.weight`` (nothing downloads the
    real ones)."""
    import torch

    from ngp_tpu_torch.training.lpips import random_params

    params = random_params(torch.Generator().manual_seed(SEED))
    sd = {}
    for i, idx in enumerate((0, 3, 6, 8, 10)):
        sd[f"features.{idx}.weight"] = torch.tensor(params[f"conv{i}_w"].transpose(3, 2, 0, 1))
        sd[f"features.{idx}.bias"] = torch.tensor(params[f"conv{i}_b"])
        sd[f"lins.{i}.weight"] = torch.tensor(params[f"lin{i}_w"]).reshape(1, -1, 1, 1)
    torch.save(sd, path)


@contextlib.contextmanager
def grid_inputs(keep):
    """Catch the grid encoder's own inputs in train steps: call n (of those
    that record autograd) of a D-dimensional encoder whose ``keep(n, D)``
    gives a label stores its points and, once the backward has run, its
    output's cotangent under that label. Yields the dict."""
    from ngp_tpu_torch.models.encoders import GridEncoder

    caught, calls, forward = {}, {}, GridEncoder.forward

    def catching(self, x):
        out = forward(self, x)
        D = self.cfg.input_dim
        if out.requires_grad:
            n = calls.get(D, 0)
            calls[D] = n + 1
            label = keep(n, D)
            if label is not None:
                entry = caught[label] = {"x": x.detach().reshape(-1, D).float().contiguous()
                                         .clone(), "table": self.embeddings}
                out.register_hook(lambda g, e=entry: e.__setitem__(
                    "g", g.detach().reshape(e["x"].shape[0], -1).contiguous().clone()))
        return out

    GridEncoder.forward = catching
    try:
        yield caught
    finally:
        GridEncoder.forward = forward


def cli_rest_runs(dev, card, scene, psnr_11a, rays_s_11a, results):
    """Phase 12: the rest of ``main_nerf`` on phase 11's scene. (a) ``-O
    --bg_radius --downscale`` with ``--lpips_weights`` (a random-weight
    checkpoint): turbo-hq with the background net, whose frames the eval
    prepass culls and the background pass fills; the train views' PSNR to
    its floor, the test PSNR beside phase 11 (a)'s and a white frame's
    (also with the net's output replaced by white), LPIPS finite, the 2-D grid
    kernels launched and held against their plain versions on the first
    and last steps' own background points; (b) no ``-O`` at the CLI's defaults (the uniform
    renderer, hash grid, f32, 512 samples a ray): the loss falls, the test
    PSNR beats a white frame's, one profiled step, and the 3-D grid kernels
    on the last step's own 2,097,152 points; (c) no ``-O``, the CP grid at
    the turbo-hq widths in bf16 (the fused density head on 2,097,152 rows
    a step): the loss falls, the CP kernels launched, and both at that row
    count against their plain versions; (d) ``-O --encoding hashgrid
    --bg_radius``, the v1 march with the background net. Returns the
    launch counts of (a)-(d)."""
    import numpy as np
    import torch

    from ngp_tpu_torch import main_nerf
    from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
    from ngp_tpu_torch.ops.kernels import cp
    from ngp_tpu_torch.ops.kernels import hashgrid as hk
    from ngp_tpu_torch.ops.kernels import scatter as sk

    n_train, n_val, n_test = CLI_FRAMES

    def white_psnr(split, downscale, frames=None):
        """The mean PSNR of a constant white frame on a split's first frames."""
        ds = NeRFDataset(scene, split=split, downscale=downscale)
        gt = ds.images[:frames, ..., :3] * ds.images[:frames, ..., 3:] + (
            1.0 - ds.images[:frames, ..., 3:])
        return float(np.mean([-10.0 * math.log10(float(np.mean((1.0 - f) ** 2))) for f in gt]))

    white = white_psnr("test", 1)
    counts = []

    def losses_fall(label):
        """The mean loss of the run's last epoch below that of its first
        (a step's loss alone moves with its frame and rays). Returns the
        epoch means."""
        steps = torch.stack(seen["step_losses"]).cpu().numpy()
        means = steps.reshape(-1, n_train).mean(axis=1)
        if not means[-1] < means[0]:
            raise RuntimeError(f"CLI 12{label}: the loss did not fall: epoch means {means}")
        return means

    def timed_epochs(seen, trainer):
        mid = seen["epochs"][1:-1] or seen["epochs"][-1:]
        rays_s = len(mid) * n_train * trainer.train_cfg.num_rays / sum(mid)
        return rays_s, 1e3 * sum(mid) / (len(mid) * n_train)

    with tempfile.TemporaryDirectory() as tmp, cli_recorder(dev, card) as (seen, run):
        lpips_path = os.path.join(tmp, "alex_random.pth")
        write_lpips_checkpoint(lpips_path)

        # (a) turbo-hq with the background net and LPIPS
        bg = ["--bg_radius", str(CLI_BG_RADIUS)]
        last = cli_steps(CLI_BG_ITERS) - 1
        with grid_inputs(lambda n, D: {0: "D=2 step 0", last: f"D=2 step {last}"}.get(n)
                         if D == 2 else None) as caught:
            trainer, a_counts, a_dt, _ = run(
                [scene, "-O", "--workspace", os.path.join(tmp, "ws_bg"), "--iters",
                 str(CLI_BG_ITERS), "--downscale", str(CLI_BG_DOWNSCALE), "--lpips_weights",
                 lpips_path] + bg, "12(a) -O --bg_radius")
        counts.append(a_counts)
        check_launched("CLI 12(a) -O --bg_radius", a_counts,
                       ("grid_encode_fwd_2d", "grid_encode_bwd_2d", "cp_density_fwd",
                        "cp_bwd_banks", "march_turbo", "cp_sigma_rgb", "coarse_lookup_bits"))
        res = seen["results"][-1]
        psnr, lp = res["psnr"], res.get("lpips", float("nan"))
        rays_s, ms = timed_epochs(seen, trainer)
        means = losses_fall("(a)")
        # the train views the background net has learned, through evaluate
        # (prepass, background-frame pass, turbo chunks); then the test
        # split with the background net's output replaced by white, which
        # leaves what the density field alone adds to a white frame
        opt = main_nerf.build_parser().parse_args([scene])
        views = NeRFDataset(scene, split="train", scale=opt.scale, offset=opt.offset,
                            downscale=CLI_BG_DOWNSCALE)
        train_psnr = trainer.evaluate(views, max_frames=CLI_BG_VIEWS)["psnr"]
        trainer.model.background = lambda sph, d: torch.ones_like(d)
        test_ds = NeRFDataset(scene, split="test", scale=opt.scale, offset=opt.offset,
                              downscale=CLI_BG_DOWNSCALE)
        fg_psnr = trainer.evaluate(test_ds)["psnr"]
        del trainer.model.background
        white_a = white_psnr("test", CLI_BG_DOWNSCALE)
        white_v = white_psnr("train", CLI_BG_DOWNSCALE, CLI_BG_VIEWS)
        print(f"CLI 12(a): {a_dt:.3f} s wall for {CLI_BG_ITERS} iterations at --downscale "
              f"{CLI_BG_DOWNSCALE}; {rays_s:.0f} rays/s over the middle epochs (phase 11 (a): "
              f"{rays_s_11a:.0f}); PSNR on the first {CLI_BG_VIEWS} train views {train_psnr:.4f} "
              f"dB (a white frame: {white_v:.4f}); test split {psnr:.4f} dB (a white frame: "
              f"{white_a:.4f}; phase 11 (a) at full scale: {psnr_11a:.4f}), with the background "
              f"white {fg_psnr:.4f}; LPIPS {lp:.6f} (random weights); {len(seen['bg_frames'])} "
              f"background-frame passes; epoch-mean loss {means[0]:.6f} -> {means[-1]:.6f}  "
              f"[{card}]", flush=True)
        if not (train_psnr >= CLI_BG_MIN_PSNR > white_v + 3.0 and math.isfinite(psnr)
                and math.isfinite(lp)):
            raise RuntimeError(f"CLI 12(a): train-view PSNR {train_psnr} (floor {CLI_BG_MIN_PSNR}, "
                               f"a white frame {white_v}), test PSNR {psnr}, LPIPS {lp}")
        if not seen["bg_frames"] or sorted(caught) != ["D=2 step 0", f"D=2 step {last}"]:
            raise RuntimeError(f"CLI 12(a): {len(seen['bg_frames'])} background-frame passes, "
                               f"caught {sorted(caught)}")
        # both 2-D kernels on the steps' own points, on the trained table
        # scaled to a largest |value| of 1, and bf16 cotangents (-O)
        bgeom = trainer.model.encoder_bg.cfg.geometry
        for label, e in caught.items():
            table = e["table"].detach()
            table = (table / table.abs().max()).contiguous()
            grid_checks(hk, sk, e["x"], table, bgeom, torch.bfloat16, e["g"], label, results)
        del trainer, caught

        # (b) no -O: the uniform renderer at the CLI's defaults
        last = cli_steps(CLI_UNIFORM_ITERS) - 1
        with grid_inputs(lambda n, D: f"D=3 step {last}" if D == 3 and n == last
                         else None) as caught:
            trainer, b_counts, b_dt, _ = run(
                [scene, "--workspace", os.path.join(tmp, "ws_uniform"), "--iters",
                 str(CLI_UNIFORM_ITERS)], "12(b) no -O")
        counts.append(b_counts)
        check_launched("CLI 12(b) no -O", b_counts, ("grid_encode_fwd", "grid_encode_bwd"),
                       absent=("march_turbo", "coarse_lookup_bits", "cp_density_fwd"))
        means = losses_fall("(b)")
        psnr = seen["results"][-1]["psnr"]
        rays_s, ms = timed_epochs(seen, trainer)
        print(f"CLI 12(b): {b_dt:.3f} s wall for {CLI_UNIFORM_ITERS} iterations; {rays_s:.0f} "
              f"rays/s, {ms:.2f} ms a step of {trainer.train_cfg.num_rays} rays x "
              f"{trainer.render_cfg.num_steps} samples; test split PSNR {psnr:.4f} dB (a white "
              f"frame: {white:.4f}); epoch-mean loss {np.round(means, 6).tolist()}  [{card}]",
              flush=True)
        if not psnr > white:
            raise RuntimeError(f"CLI 12(b): test PSNR {psnr} not above a white frame's {white}")
        train_ds = NeRFDataset(scene, split="train")
        batches = itertools.chain.from_iterable(
            trainer.make_loader(train_ds)() for _ in itertools.count())
        trainer.step(next(batches))
        profile(lambda: trainer.step(next(batches)), 1, "step", card,
                focus=("grid_fwd", "grid_bwd", "gemm", "elementwise"))
        e = caught[f"D=3 step {last}"]
        geom = trainer.model.encoder.cfg.geometry
        table = e["table"].detach()
        table = (table / table.abs().max()).contiguous()
        grid_checks(hk, sk, e["x"], table, geom, torch.float32, e["g"],
                    f"D=3 float32 step {last} of 12(b)", results)
        del trainer, caught, e, table

        # (c) no -O, the CP grid at the turbo-hq widths in bf16
        seen_rows = []
        bwd = cp.cp_bwd_banks

        def counting_bwd(pos, factors, g_cp, resolutions):
            seen_rows.append(pos.shape[0])
            return bwd(pos, factors, g_cp, resolutions)

        cp.cp_bwd_banks = counting_bwd
        try:
            trainer, c_counts, c_dt, _ = run(
                [scene, "--encoding", "cpgrid", "--fp16", "--workspace",
                 os.path.join(tmp, "ws_cp"), "--iters", str(CLI_CP_ITERS)] + CLI_TURBO_HQ,
                "12(c) no -O --encoding cpgrid --fp16")
        finally:
            cp.cp_bwd_banks = bwd
        counts.append(c_counts)
        check_launched("CLI 12(c) cpgrid", c_counts,
                       ("cp_density_fwd", "cp_density_fwd_residuals", "cp_density_fwd_tc",
                        "cp_bwd_banks"), absent=("march_turbo", "grid_encode_fwd"))
        means = losses_fall("(c)")
        rays_s, ms = timed_epochs(seen, trainer)
        rows = max(seen_rows)
        print(f"CLI 12(c): {c_dt:.3f} s wall for {CLI_CP_ITERS} iterations; {rays_s:.0f} rays/s, "
              f"{ms:.2f} ms a step; the density head's rows a step {rows}; test split PSNR "
              f"{seen['results'][-1]['psnr']:.4f} dB; epoch-mean loss {means[0]:.6f} -> "
              f"{means[-1]:.6f}  [{card}]", flush=True)
        # both CP kernels at that row count, on the trained weights
        gen = torch.Generator(device=dev).manual_seed(SEED + 12)
        m = trainer.model
        res = tuple(m.cfg.cp_resolutions)
        fa = tuple(f.detach().to(torch.bfloat16).contiguous() for f in m.encoder.factors)
        a1, a2 = (w.detach().to(torch.bfloat16).contiguous() for w in m.sigma_net.weights)
        fd = m.cfg.cp_freq_degree
        pos = torch.rand((rows, 3), generator=gen, device=dev) * 1.1 - 0.05
        D, H1, OUT = a1.shape[0], a1.shape[1], a2.shape[1]
        nbR = len(res) * m.cfg.cp_rank
        del trainer, m
        results[("cp_density_fwd+residuals", f"bfloat16 {rows} rows of 12(c)")] = compare(
            "cp_density_fwd+residuals",
            lambda: cp.cp_density_fwd(pos, fa, a1, a2, res, fd, residuals=True),
            lambda: cp.cp_density_plain(pos, fa, a1, a2, res, fd, residuals=True), "bfloat16",
            (nbytes(pos, *fa, a1, a2) + rows * (OUT * 4 + (D + H1) * 2),
             rows * 2 * (D * H1 + H1 * OUT), 14 * rows * nbR),
            tol=lambda want: density_bound(cp, pos, fa, res, want))
        g_cp = torch.randn((rows, nbR), generator=gen, device=dev)
        results[("cp_bwd_banks", f"bfloat16 {rows} rows of 12(c)")] = compare(
            "cp_bwd_banks", lambda: cp.cp_bwd_banks(pos, fa, g_cp, res),
            lambda: cp.cp_bwd_banks_plain(pos, fa, g_cp, res), "bfloat16",
            (nbytes(pos, g_cp, *fa, *fa), 0, 24 * rows * nbR),
            tol=lambda want: bwd_bound(cp, pos, fa, g_cp, res, want))
        del pos, g_cp, fa

        # (d) the v1 march with the background net
        trainer, d_counts, _, _ = run(
            [scene, "-O", "--encoding", "hashgrid", "--workspace", os.path.join(tmp, "ws_v1bg"),
             "--iters", str(CLI_HASH_ITERS)] + bg, "12(d) -O --encoding hashgrid --bg_radius")
        counts.append(d_counts)
        check_launched("CLI 12(d) hashgrid --bg_radius", d_counts,
                       ("grid_encode_fwd", "grid_encode_bwd", "grid_encode_fwd_2d",
                        "grid_encode_bwd_2d"), absent=("march_turbo",))
        means = losses_fall("(d)")
        print(f"CLI 12(d): test split PSNR {seen['results'][-1]['psnr']:.4f} dB, loss "
              f"{means[0]:.6f} -> {means[-1]:.6f}, {len(seen['bg_frames'])} background-frame "
              f"passes (no prepass on the v1 march)  [{card}]", flush=True)
        del trainer
    return counts


def train_step_gpu_vs_cpu(dev, hash_grid=False):
    """One small f32 train step through the kernels and the same step on
    the CPU through the plain versions, at the turbo-hq preset or in the
    hash-grid configuration; raise past the tolerances."""
    import torch

    from ngp_tpu_torch.config import NetworkConfig, RenderConfig, TrainConfig
    from ngp_tpu_torch.data.synthetic import make_synthetic_frames
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

    if hash_grid:
        rc = RenderConfig(bound=1.0, min_near=0.05, max_steps=64, max_samples_per_ray=16,
                          grid_size=16, density_thresh=10.0, turbo=False)
        nc = NetworkConfig(encoding="hashgrid", use_bf16=False, num_levels=8,
                           log2_hashmap_size=14, sh_degree=3)
        kernels = ("grid_encode_fwd", "grid_encode_bwd")
    else:
        rc = RenderConfig(bound=1.0, min_near=0.05, max_steps=64, max_samples_per_ray=16,
                          grid_size=16, density_thresh=10.0, turbo=True, coarse_candidates=48,
                          compact_mean_samples=6)
        nc = NetworkConfig(encoding="cpgrid", use_bf16=False, cp_resolutions=(32, 64),
                           cp_rank=16, cp_freq_degree=4, sh_degree=3)
        kernels = ("cp_density_fwd_residuals", "cp_bwd_banks", "march_turbo")
    path = "small hash-grid train step" if hash_grid else "small train step"
    with tempfile.TemporaryDirectory() as ws:
        tc = TrainConfig(num_rays=1024, workspace=ws)
        frames = make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=32, W=32,
                                       device=dev)["train"]
        cpu_model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(SEED), device="cpu")
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
        # the encoder's inputs and output cotangents on the card, to replay
        # its table gradient on the CPU from the same points
        replay_enc = copy.deepcopy(cpu_model.encoder)
        seen = []

        def keep(module, args, out):
            if out.requires_grad:
                seen.append([args[0].detach(), None])
                out.register_hook(lambda g, entry=seen[-1]: entry.__setitem__(1, g.detach()))

        hook = gpu_tr.model.encoder.register_forward_hook(keep)
        reset_launch_counts()
        mg = gpu_tr.train_step(
            {k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()},
            {k: v.to(dev) for k, v in draws.items()})
        torch.cuda.synchronize()
        hook.remove()
        check_launched(path, launch_counts(), kernels, absent=("coarse_lookup_bits",))
        mc = cpu_tr.train_step(batch, draws)
    if hash_grid:
        # the card's table gradient against the plain version's on the
        # card's own encoder inputs and cotangents: equal up to the order
        # of the f32 sums (atomics)
        for x, g in seen:
            replay_enc(x.cpu()).backward(g.cpu())
        want = replay_enc.embeddings.grad
        got = gpu_tr.model.encoder.embeddings.grad.cpu()
        rel = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        print(f"{path}: encoder.embeddings against the CPU replay of the card's encoder "
              f"inputs, elementwise {rel:.3e} of its largest entry", flush=True)
        if not rel <= STEP_GRAD_TOL:
            raise RuntimeError(f"{path}: the table gradient differs from its CPU replay by "
                               f"{rel} of its largest entry")
    loss_g, loss_c = float(mg["loss"]), float(mc["loss"])
    if not math.isfinite(loss_g) or abs(loss_g - loss_c) > STEP_LOSS_TOL * abs(loss_c):
        raise RuntimeError(f"{path}: loss {loss_g} on the GPU, {loss_c} on the CPU")
    # The GPU's and the CPU's ray products round differently. A fine hash
    # level (scale ~2047) turns a ray one ulp away into a feature change
    # that flips the ReLU of a few of the sigma MLP's near-zero hidden
    # units, and a flip moves its sample's whole feature gradient, so the
    # table's and the first sigma layer's gradients move by more than
    # 1e-3 of their largest entries where the loss agrees to 7 digits.
    # Against the CPU step those two are held as directional derivatives
    # along random directions; the table's is held elementwise against
    # its replay above.
    directional = ("encoder.embeddings", "sigma_net.dense_0") if hash_grid else ()
    gen = torch.Generator().manual_seed(SEED + 3)
    worst = 0.0
    cpu_params = dict(cpu_tr.model.named_parameters())
    for name, p in gpu_tr.model.named_parameters():
        want = cpu_params[name].grad
        rel = float((p.grad.cpu() - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        if name in directional:
            print(f"{path}: {name} elementwise {rel:.3e} of its largest entry", flush=True)
            rel = 0.0
            for _ in range(8):
                d = torch.randn(want.shape, generator=gen)
                rel = max(rel, abs(float(((p.grad.cpu() - want) * d).sum()))
                          / max(float((want.abs() * d.abs()).sum()), 1e-30))
        if not rel <= STEP_GRAD_TOL:
            raise RuntimeError(f"{path}: gradient of {name} differs by {rel} "
                               "of its largest entry")
        worst = max(worst, rel)
    print(f"{path}: loss gpu {loss_g:.7f} cpu {loss_c:.7f}, worst gradient "
          f"difference {worst:.3e} of its largest entry", flush=True)
    return worst


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--probe-scatter", action="store_true",
                        help="also time the replaced corner rows + scatter_add_rows pair and "
                             "index_add_ on the hash steps' own rows (scatter_probe)")
    args = parser.parse_args()
    probe_scatter = args.probe_scatter
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from ngp_tpu_torch.config import NetworkConfig, RenderConfig, TrainConfig
    from ngp_tpu_torch.data.synthetic import make_synthetic_frames
    from ngp_tpu_torch.models import occupancy
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops.kernels import build, cp, launch_counts, march, reset_launch_counts
    from ngp_tpu_torch.ops.hashgrid import GridConfig, grid_encode
    from ngp_tpu_torch.ops.kernels import fused_mlp as mlp
    from ngp_tpu_torch.ops.kernels import hashgrid as hk
    from ngp_tpu_torch.ops.kernels import scatter as sk
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
    # the tensor-core kernels of the bf16 heads and the MLP chain: HMMA in
    # their SASS, no spills
    for kernel in ("cp_density_tc_kernel", "cp_sigma_rgb_tc_kernel", "fused_mlp_tc_kernel"):
        hmma = sum("HMMA" in line for line in sass_lines(build.library_path(), kernel))
        spills = sum(n for _, _, n in ptxas_usage(report, kernel))
        print(f"SASS: {kernel} has {hmma} HMMA instructions; ptxas: {spills} bytes of spill "
              "stores", flush=True)
        if hmma == 0 or spills > 0:
            raise RuntimeError(f"{kernel}: {hmma} tensor-core instructions, {spills} bytes of "
                               "spill stores")
    # the CP run kernels: registers and spills of each instance; no call to
    # a 64-bit division routine in their SASS
    for kernel in ("cp_bwd_runs_kernel", "cp_encode_runs_kernel"):
        for name, regs, spills in ptxas_usage(report, kernel):
            print(f"ptxas: {name}: {regs} registers, {spills} bytes of spill stores")
        calls = [ln.strip() for ln in sass_lines(build.library_path(), kernel) if "CALL" in ln]
        divs = [c for c in calls if "div" in c.lower() or "rem" in c.lower()]
        print(f"SASS: {kernel}: {len(calls)} calls, {len(divs)} to a division routine",
              flush=True)
        if divs:
            raise RuntimeError(f"{kernel} calls a division routine: {divs[:2]}")
    for name, regs, spills in ptxas_usage(report, "march_turbo_kernel"):
        print(f"ptxas: {name}: {regs} registers, {spills} bytes of spill stores", flush=True)

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
    check_launched("eval", eval_counts, ("cp_density_fwd", "cp_density_fwd_tc", "cp_sigma_rgb",
                                         "cp_sigma_rgb_tc", "march_turbo", "coarse_lookup_bits"))
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
    rows = {"cp_density_fwd": 128 * 128 * 8, "cp_sigma_rgb": EVAL_ROWS}
    results = {}
    # the work of each function for its bound: a CP lerp is about 14
    # operations per (row, bank column), three taps of 4 and two products;
    # the factor backward 2 taps of ~4 per (row, bank column, axis)
    mlp_flops = 2 * (w1.shape[0] * w1.shape[1] + w2.shape[0] * w2.shape[1])
    color_flops = 2 * sum(w.shape[0] * w.shape[1] for w in color)
    D, H1, OUT = w1.shape[0], w1.shape[1], w2.shape[1]
    # one save_mesh chunk: x-slice MESH_RES / 2 of density_grid's lattice,
    # scaled to [0, 1] as NeRFNetwork.density scales it
    xs = torch.as_tensor(np.linspace(-rc.bound, rc.bound, MESH_RES, dtype=np.float32),
                         device=dev)
    mesh_chunk = torch.stack(torch.meshgrid(xs[MESH_RES // 2:MESH_RES // 2 + 1], xs, xs,
                                            indexing="ij"), dim=-1).reshape(-1, 3)
    mesh_chunk = ((mesh_chunk + rc.bound) / (2 * rc.bound)).contiguous()
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        esz = dt.itemsize
        fa = tuple(f.to(dt).contiguous() for f in factors)
        a1, a2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
        ca = tuple(w.to(dt).contiguous() for w in color)
        M = rows["cp_density_fwd"]
        pos = torch.rand((M, 3), generator=gen, device=dev) * 1.1 - 0.05
        results[("cp_density_fwd", dtype)] = compare(
            "cp_density_fwd",
            lambda: cp.cp_density_fwd(pos, fa, a1, a2, res, fd),
            lambda: cp.cp_density_plain(pos, fa, a1, a2, res, fd), dtype,
            (nbytes(pos, *fa, a1, a2) + M * OUT * 4, M * mlp_flops, 14 * M * nbR))
        M = TRAIN_ROWS
        pos_t = torch.rand((M, 3), generator=gen, device=dev) * 1.1 - 0.05
        resid_tol = None
        if dtype == "bfloat16":
            resid_tol = lambda want: density_bound(cp, pos_t, fa, res, want)  # noqa: E731
        results[("cp_density_fwd+residuals", dtype)] = compare(
            "cp_density_fwd+residuals",
            lambda: cp.cp_density_fwd(pos_t, fa, a1, a2, res, fd, residuals=True),
            lambda: cp.cp_density_plain(pos_t, fa, a1, a2, res, fd, residuals=True), dtype,
            (nbytes(pos_t, *fa, a1, a2) + M * (OUT * 4 + (D + H1) * esz), M * mlp_flops,
             14 * M * nbR), tol=resid_tol)
        # the density head's edge shapes, with and without residuals
        for M_e, small, scale in DENSITY_EDGES:
            fe, e1, e2, res_e, fd_e = tuple(f * scale for f in fa), a1, a2, res, fd
            if small is not None:
                res_e, rank_e, fd_e = small
                fe = tuple((torch.randn((3, r, rank_e), generator=gen, device=dev) * 0.2).to(dt)
                           for r in res_e)
                D_e = len(res_e) * rank_e + 3 * (1 + 2 * fd_e)
                e1 = (torch.randn((D_e, H1), generator=gen, device=dev) / D_e**0.5).to(dt)
                e2 = (torch.randn((H1, OUT), generator=gen, device=dev) / H1**0.5).to(dt)
            pos_x = torch.rand((M_e, 3), generator=gen, device=dev) * 1.1 - 0.05
            shape = (f"{dtype} {M_e} rows, rank {fe[0].shape[-1]}, freq degree {fd_e}, "
                     f"factors x{scale}")
            for resid in (False, True):
                tol = None
                if resid and dtype == "bfloat16":
                    tol = lambda want: density_bound(cp, pos_x, fe, res_e, want)  # noqa: E731
                results[("cp_density_fwd" + "+residuals" * resid, shape)] = compare(
                    "cp_density_fwd",
                    lambda: cp.cp_density_fwd(pos_x, fe, e1, e2, res_e, fd_e, residuals=resid),
                    lambda: cp.cp_density_plain(pos_x, fe, e1, e2, res_e, fd_e, residuals=resid),
                    dtype, (nbytes(pos_x, *fe, e1, e2) + M_e * OUT * 4, M_e * mlp_flops, 0),
                    tol=tol)
        # sigma MLPs wider than the 128-row tiles take, on the model's banks;
        # bf16 must take the tensor-core kernel (its launch count says so)
        pos_x = torch.rand((WIDE_ROWS, 3), generator=gen, device=dev) * 1.1 - 0.05
        for h1_w in WIDE_H1:
            e1, e2, _ = head_weights(gen, dev, dt, D, h1_w, OUT, nc.sh_degree, ())
            before = launch_counts()["cp_density_fwd_tc"]
            cp.cp_density_fwd(pos_x, fa, e1, e2, res, fd)
            if launch_counts()["cp_density_fwd_tc"] - before != int(dtype == "bfloat16"):
                raise RuntimeError(f"cp_density_fwd: H1 {h1_w} {dtype} took the wrong route")
            flops = 2 * WIDE_ROWS * (D * h1_w + h1_w * OUT)
            for resid in (False, True):
                tol = None
                if resid and dtype == "bfloat16":
                    tol = lambda want: density_bound(cp, pos_x, fa, res, want)  # noqa: E731
                results[("cp_density_fwd" + "+residuals" * resid,
                         f"{dtype} {WIDE_ROWS} rows, H1 {h1_w}")] = compare(
                    "cp_density_fwd",
                    lambda: cp.cp_density_fwd(pos_x, fa, e1, e2, res, fd, residuals=resid),
                    lambda: cp.cp_density_plain(pos_x, fa, e1, e2, res, fd, residuals=resid),
                    dtype, (nbytes(pos_x, *fa, e1, e2) + WIDE_ROWS * OUT * 4, flops, 0), tol=tol)
        # the factor gradient from a d(CP features) of the train shape,
        # contiguous as the density backward passes it
        g_cp = torch.randn((M, nbR), generator=gen, device=dev)
        results[("cp_bwd_banks", dtype)] = compare(
            "cp_bwd_banks",
            lambda: cp.cp_bwd_banks(pos_t, fa, g_cp, res),
            lambda: cp.cp_bwd_banks_plain(pos_t, fa, g_cp, res), dtype,
            (nbytes(pos_t, g_cp, *fa, *fa), 0, 24 * M * nbR),
            tol=lambda want: bwd_bound(cp, pos_t, fa, g_cp, res, want))
        # and from g rows D floats apart, which no 16-byte access reads:
        # the scalar-column instance
        g_wide = torch.randn((M, D), generator=gen, device=dev)[:, :nbR]
        results[("cp_bwd_banks", f"{dtype} g rows {D} floats apart")] = compare(
            "cp_bwd_banks",
            lambda: cp.cp_bwd_banks(pos_t, fa, g_wide, res),
            lambda: cp.cp_bwd_banks_plain(pos_t, fa, g_wide, res), dtype,
            (nbytes(pos_t, g_wide, *fa, *fa), 0, 24 * M * nbR),
            tol=lambda want: bwd_bound(cp, pos_t, fa, g_wide, res, want))
        del g_wide
        M = rows["cp_sigma_rgb"]
        pos = torch.rand((M, 3), generator=gen, device=dev)
        dirs = torch.nn.functional.normalize(
            torch.randn((M, 3), generator=gen, device=dev), dim=-1)
        results[("cp_sigma_rgb", dtype)] = compare(
            "cp_sigma_rgb",
            lambda: cp.cp_sigma_rgb(pos, dirs, fa, a1, a2, ca, res, fd, nc.sh_degree),
            lambda: cp.cp_sigma_rgb_plain(pos, dirs, fa, a1, a2, ca, res, fd, nc.sh_degree),
            dtype, (nbytes(pos, dirs, *fa, a1, a2, *ca) + M * 4 * 4,
                    M * (mlp_flops + color_flops), 14 * M * nbR))
        # the radiance head's edge shapes
        for M_e, small, scale, h1_e, sh_e, hidden in SIGMA_RGB_EDGES:
            fe, res_e, fd_e, e1, e2, ce = tuple(f * scale for f in fa), res, fd, a1, a2, ca
            if small is not None:
                res_e, rank_e, fd_e = small
                fe = tuple((torch.randn((3, r, rank_e), generator=gen, device=dev) * 0.2).to(dt)
                           for r in res_e)
            D_e = len(res_e) * fe[0].shape[-1] + 3 * (1 + 2 * fd_e)
            if (D_e, h1_e, sh_e, hidden) != (D, H1, nc.sh_degree, (64, 64)):
                e1, e2, ce = head_weights(gen, dev, dt, D_e, h1_e, OUT, sh_e, hidden)
            pos_x = torch.rand((M_e, 3), generator=gen, device=dev)
            dirs_x = torch.nn.functional.normalize(
                torch.randn((M_e, 3), generator=gen, device=dev), dim=-1)
            if dtype == "bfloat16":
                before = launch_counts()["cp_sigma_rgb_tc"]
                cp.cp_sigma_rgb(pos_x, dirs_x, fe, e1, e2, ce, res_e, fd_e, sh_e)
                if launch_counts()["cp_sigma_rgb_tc"] == before:
                    raise RuntimeError("cp_sigma_rgb: a bf16 edge shape missed the tensor cores")
            flops = 2 * M_e * (e1.numel() + e2.numel() + sum(w.numel() for w in ce))
            shape = (f"{dtype} {M_e} rows, rank {fe[0].shape[-1]}, freq degree {fd_e}, "
                     f"factors x{scale}, H1 {h1_e}, SH {sh_e}, colour {len(ce)} layers")
            results[("cp_sigma_rgb", shape)] = compare(
                "cp_sigma_rgb",
                lambda: cp.cp_sigma_rgb(pos_x, dirs_x, fe, e1, e2, ce, res_e, fd_e, sh_e),
                lambda: cp.cp_sigma_rgb_plain(pos_x, dirs_x, fe, e1, e2, ce, res_e, fd_e, sh_e),
                dtype, (nbytes(pos_x, dirs_x, *fe, e1, e2, *ce) + M_e * 16, flops, 0))
        # the CP encoder at the mesh chunk's size, each bank type to each
        # output type: random rows, then save_mesh's own chunk (an x-slice
        # of the 256^3 lattice)
        M = ENCODE_ROWS
        pos_e = torch.rand((M, 3), generator=gen, device=dev) * 1.1 - 0.05
        for out_name, (label, pos_m) in itertools.product(
                ("bfloat16", "float32"), (("", pos_e), (" mesh chunk", mesh_chunk))):
            od = getattr(torch, out_name)
            results[("cp_encode_fwd", f"{dtype}->{out_name}{label}")] = compare(
                "cp_encode_fwd",
                lambda: cp.cp_encode_fwd(pos_m, fa, res, od),
                lambda: cp.cp_encode_plain(pos_m, fa, res, od), out_name,
                (nbytes(pos_m, *fa) + M * nbR * od.itemsize, 0, 14 * M * nbR))
            if not (cp.cp_encode_fwd(pos_m, fa, res, od)[~inside_rows(pos_m)] == 0).all():
                raise RuntimeError("cp_encode_fwd: a row outside the box has a feature")
        # its backward (CPEncode: cp_bwd_banks) against autograd of the plain
        # version, forward and backward timed together
        g_e = torch.randn((M, nbR), generator=gen, device=dev)
        fr = [f.clone().requires_grad_() for f in fa]
        results[("CPEncode backward", dtype)] = compare(
            "CPEncode backward",
            lambda: torch.autograd.grad(cp.cp_encode(pos_e, fr, res), fr, g_e),
            lambda: torch.autograd.grad(cp.cp_encode_plain(pos_e, fr, res), fr, g_e), dtype,
            (nbytes(pos_e, g_e, *fa, *fa) + M * nbR * 4, 0, 38 * M * nbR),
            tol=lambda want: bwd_bound(cp, pos_e, fa, g_e, res, want))
    # the MLP chain at the JAX docstring's shape and a ragged small batch,
    # and the narrowest chain
    for dims, rows_m, label in [(MLP_DIMS, r, str(r)) for r in MLP_ROWS] + [
            (MLP_NARROW, MLP_ROWS[0], f"{MLP_ROWS[0]} x {'-'.join(map(str, MLP_NARROW))}")]:
        x_m = torch.randn((rows_m, dims[0]), generator=gen, device=dev)
        w_m = [torch.randn((dims[i], dims[i + 1]), generator=gen, device=dev) * 0.2
               for i in range(len(dims) - 1)]
        before = launch_counts()["fused_mlp_tc"]
        mlp.fused_mlp(x_m, w_m)
        if launch_counts()["fused_mlp_tc"] != before + 1:
            raise RuntimeError(f"fused_mlp: {dims} missed the tensor cores")
        results[("fused_mlp", label)] = compare(
            "fused_mlp", lambda: mlp.fused_mlp(x_m, w_m), lambda: mlp.fused_mlp_plain(x_m, w_m),
            "bfloat16", (nbytes(x_m, *w_m) + rows_m * dims[-1] * 4,
                         rows_m * 2 * sum(a * b for a, b in zip(dims, dims[1:])), 0))
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
    results[("coarse_lookup_bits", "bits")] = (0.0, (k1 + k2) / 2, (p1 + p2) / 2,
                                               bound(nbytes(payload, fc, got)))

    # the hash grid's kernels on the full-width table (f32, as the model
    # keeps it), at the refresh chunk and a train step's sample slots; work
    # as grid_fwd_work and grid_bwd_work count it
    gcfg = GridConfig(desired_resolution=2048)
    geom = gcfg.geometry
    L, C = gcfg.num_levels, gcfg.level_dim
    table = torch.rand((gcfg.num_rows, C), generator=gen, device=dev) * 2.0 - 1.0
    B = GRID_ROWS[-1]
    for dtype in ("bfloat16", "float32"):
        od = getattr(torch, dtype)
        for rows_g in GRID_ROWS:
            x_g = torch.rand((rows_g, 3), generator=gen, device=dev) * 1.1 - 0.05
            results[("grid_encode_fwd", f"{dtype} {rows_g}")] = compare(
                "grid_encode_fwd", lambda: hk.grid_encode_fwd(x_g, table, geom, od),
                lambda: hk.grid_encode_plain(x_g, table, geom, od), dtype,
                grid_fwd_work(x_g, geom, od))
        g_g = torch.randn((B, L * C), generator=gen, device=dev).to(od)
        # the table gradient sums the same f32 (bf16-rounded with a bf16 g)
        # corner products as its plain version, by atomics in another
        # order: per entry within 2 (n - 1) 2^-24 of the sum of its n
        # terms' magnitudes (scatter_bound)
        idx_p, rows_p = hk.grid_encode_bwd_rows_plain(x_g, g_g, geom)
        s_bound = scatter_bound(sk, idx_p, rows_p, gcfg.num_rows)
        bwd_work = grid_bwd_work(x_g, g_g, geom, idx_p, rows_p)
        del idx_p, rows_p
        results[("grid_encode_bwd", f"{dtype} random")] = compare(
            "grid_encode_bwd", lambda: hk.grid_encode_bwd(x_g, g_g, geom),
            lambda: hk.grid_encode_bwd_plain(x_g, g_g, geom), dtype, bwd_work,
            tol=lambda want: [s_bound])
        # GridEncode: forward and table gradient, against autograd of the
        # plain version, timed together
        tr = table.clone().requires_grad_()
        fwd_work = grid_fwd_work(x_g, geom, od)
        results[("GridEncode backward", dtype)] = compare(
            "GridEncode backward",
            lambda: torch.autograd.grad(grid_encode(x_g, tr, gcfg, od), tr, g_g),
            lambda: torch.autograd.grad(hk.grid_encode_plain(x_g, tr, geom, od), tr, g_g),
            dtype, tuple(a + b for a, b in zip(fwd_work, bwd_work)),
            tol=lambda want: [s_bound])
        del s_bound, tr, g_g
    del x_g
    # the 2-D instances on the background net's encoder geometry, f32 table,
    # points (sph + 1) / 2 of rays from inside the box to the sphere: a
    # background-frame chunk and a CLI step's rays
    from ngp_tpu_torch.ops.rays import sph_from_ray

    bcfg = GridConfig(**BG_GRID)
    bgeom = bcfg.geometry
    b_table = torch.rand((bcfg.num_rows, bcfg.level_dim), generator=gen, device=dev) * 2 - 1
    for rows_b in BG_ROWS:
        o = torch.rand((rows_b, 3), generator=gen, device=dev) * 2 - 1
        d = torch.nn.functional.normalize(torch.randn((rows_b, 3), generator=gen, device=dev),
                                          dim=-1)
        x_b = ((sph_from_ray(o, d, CLI_BG_RADIUS) + 1.0) / 2.0).contiguous()
        for dtype in ("bfloat16", "float32"):
            od = getattr(torch, dtype)
            grid_checks(hk, sk, x_b, b_table, bgeom, od,
                        torch.randn((rows_b, bcfg.output_dim), generator=gen,
                                    device=dev).to(od), f"D=2 {dtype} {rows_b}", results)
    del b_table, x_b
    # the row scatter-add, in place into a zero table, beside index_add_
    library = {}
    for M, R, W in SCATTER_SHAPES:
        idx_s = torch.randint(0, R, (M,), generator=gen, device=dev, dtype=torch.int32)
        rows_s = torch.randn((M, W), generator=gen, device=dev)
        outs = [torch.zeros((R, W), device=dev) for _ in range(3)]
        s_bound = scatter_bound(sk, idx_s, rows_s, R)
        key = ("scatter_add_rows", f"{M}x{W} into {R}")
        results[key] = compare(
            "scatter_add_rows", lambda: sk.scatter_add_rows(idx_s, rows_s, outs[0]),
            lambda: sk.scatter_add_rows_plain(idx_s, rows_s, outs[1]), "float32",
            (nbytes(idx_s, rows_s, outs[0]), 0, M * W), tol=lambda want: [s_bound])
        lib = outs[2].index_add_(0, idx_s, rows_s)
        torch.cuda.synchronize()
        if not ((lib - sk.scatter_rows(idx_s, rows_s, R)).abs() <= s_bound).all():
            raise RuntimeError("index_add_ differs from scatter_add_rows past the f32 bound")
        library[key] = cuda_ms(lambda: outs[2].index_add_(0, idx_s, rows_s))
        del idx_s, rows_s, outs, s_bound, lib
    printed = print_results(results, library, card, set())

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
    del trainer, gpu_tr, cpu_tr, cpu_model, model, pos_e, g_e, fr, x_m, w_m, table

    # 6. the train path: bench.py's scene size and preset, random init
    t0 = time.perf_counter()
    splits = make_synthetic_frames(n_train=16, n_val=1, n_test=0, H=400, W=400, seed=SEED,
                                   device=dev)
    phase("synthetic scene (17 frames of 400x400, 512 samples per ray)", t0)
    train_ds, val_ds = splits["train"], splits["val"]

    def train(trainer, label, steps, timed):
        """``steps`` train steps over the train split, epoch after epoch,
        the last ``timed`` of them timed. Returns (each step's metrics,
        seconds of the timed window, the batch iterator)."""
        epoch_iter = trainer.make_loader(train_ds)
        batches = itertools.chain.from_iterable(epoch_iter() for _ in itertools.count())
        out = []
        t0 = time.perf_counter()
        for i in range(steps):
            if i == steps - timed:
                phase(f"{label} steps 0-{i - 1} (first calls, grid warm-up)", t0)
                t0 = time.perf_counter()
            out.append(trainer.step(next(batches)))
        return out, phase(f"{label} steps {steps - timed}-{steps - 1} (timed)", t0), batches

    model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(SEED)).to(dev)
    with tempfile.TemporaryDirectory() as ws:
        tc = TrainConfig(iters=30000, lr=1e-2, num_rays=TRAIN_RAYS, update_extra_interval=16,
                         workspace=ws)
        trainer = GridNeRFTrainer(model, rc, tc, seed=SEED)
        trainer.mark_untrained(train_ds.poses, train_ds.intrinsics, train_ds.H, train_ds.W)
        # the factor backward's own inputs of the first and the last step:
        # cp_density_bwd calls cp_bwd_banks through its module, once a step
        bwd_seen, bwd_calls, launch_bwd = {}, [0], cp.cp_bwd_banks

        def record_bwd(pos, factors, g_cp, resolutions):
            n = bwd_calls[0]
            bwd_calls[0] += 1
            if n in (0, TRAIN_STEPS - 1):
                bwd_seen[f"step {n}"] = (pos.clone(), tuple(f.clone() for f in factors),
                                         g_cp.clone(), tuple(resolutions))
            return launch_bwd(pos, factors, g_cp, resolutions)

        cp.cp_bwd_banks = record_bwd
        # and the march's own inputs of every 32nd step and the last, one
        # march a step
        march_seen, restore_march = record_marches(
            occupancy,
            lambda n, _: f"step {n}" if n % 32 == 0 or n == TRAIN_STEPS - 1 else None)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        metrics, dt, batches = train(trainer, "train", TRAIN_STEPS, TIMED_STEPS)
        cp.cp_bwd_banks = launch_bwd
        march_calls = restore_march()
        if bwd_calls[0] != TRAIN_STEPS or march_calls != TRAIN_STEPS:
            raise RuntimeError(f"train: {bwd_calls[0]} factor backward calls and {march_calls} "
                               f"marches in {TRAIN_STEPS} steps")
        train_dt = dt
        losses = [m["loss"] for m in metrics]
        overflow = [m["turbo_overflow"] for m in metrics]
        train_counts = launch_counts()
        check_launched("train", train_counts, ("cp_density_fwd", "cp_density_fwd_tc",
                                              "cp_density_fwd_residuals",
                                              "cp_bwd_banks", "march_turbo"),
                       absent=("coarse_lookup_bits",))
        steps_s = TIMED_STEPS / dt
        held = sum(nbytes(pos, *fac, g) for pos, fac, g, _ in bwd_seen.values())
        print(f"train: {steps_s:.2f} steps/s, {steps_s * TRAIN_RAYS:.0f} rays/s, "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (with "
              f"{held / 2**30:.2f} GiB of captured factor backward inputs held)  [{card}]",
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
        for label, (pos_s, fac_s, g_s, res_s) in bwd_seen.items():
            step_factor_gradient(pos_s, fac_s, g_s, res_s, label, card, results)
        del bwd_seen
        for label, (m_args, m_kw) in march_seen.items():
            compare_march(label, m_args, m_kw, card, results)
        del march_seen

        # 7. the trained frame: the val pose with the EMA weights
        reset_launch_counts()
        pose, H, W = val_ds.poses[0], val_ds.H, val_ds.W
        # the frame's first 4096-ray chunk's march inputs
        march_seen, restore_march = record_marches(
            occupancy, lambda n, rays: "eval chunk" if rays == 4096 else None)
        t0 = time.perf_counter()
        img, _ = trainer.render_frame(pose, val_ds.intrinsics, H, W)
        dt = phase(f"trained frame ({H}x{W}, EMA weights)", t0)
        restore_march()
        t0 = time.perf_counter()
        img, _ = trainer.render_frame(pose, val_ds.intrinsics, H, W)
        dt2 = phase(f"trained frame again ({H}x{W})", t0)
        frame_counts = launch_counts()
        check_launched("trained frame", frame_counts, ("cp_sigma_rgb", "cp_sigma_rgb_tc",
                                                       "march_turbo", "coarse_lookup_bits"))
        for label, (m_args, m_kw) in march_seen.items():
            compare_march(label, m_args, m_kw, card, results)
        if "eval chunk" not in march_seen:
            raise RuntimeError("trained frame: no 4096-ray march chunk")
        del march_seen
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
        check_launched("evaluate", evaluate_counts, ("cp_sigma_rgb", "cp_sigma_rgb_tc",
                                                     "march_turbo", "coarse_lookup_bits"))
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
        check_launched("test", test_counts, ("cp_sigma_rgb", "cp_sigma_rgb_tc",
                                             "march_turbo", "coarse_lookup_bits"))
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

        # 7e. under the profiler, after the phases that score the 256-step
        # model and after every timed window of the turbo-hq paths, so no
        # timed window follows a profiler session: an 800x800 frame of
        # the trained model (after one unprofiled, so the frame's chunk
        # counts are settled), then 16 more train steps (one grid refresh
        # among them)
        pose, intr = orbit_pose(0.7), intrinsics(FRAME)
        trainer.render_frame(pose, intr, FRAME, FRAME)
        frame_prof = profile(lambda: trainer.render_frame(pose, intr, FRAME, FRAME), 1, "frame",
                             card, focus=("cp_sigma_rgb", "cp_density", "march", "coarse_lookup"))
        step_prof = profile(lambda: trainer.step(next(batches)), 16, "step", card,
                            focus=("cp_bwd", "cp_density", "march", "topk"))

    # 8. one small train step: GPU kernels against the CPU plain versions
    train_step_gpu_vs_cpu(dev)
    del trainer, model

    # 8b. a bf16 turbo network whose sigma MLP has 128 hidden units (the
    # heads' 64-row tensor-core tiles) on small banks: a refresh, a train
    # step and the val frame
    wnc = NetworkConfig(encoding="cpgrid", use_bf16=True, cp_resolutions=(64, 128, 256),
                        cp_rank=32, cp_freq_degree=4, hidden_dim=128)
    model = NeRFNetwork(wnc, rc, torch.Generator().manual_seed(SEED))  # on the card
    with tempfile.TemporaryDirectory() as ws:
        trainer = GridNeRFTrainer(model, rc, TrainConfig(lr=1e-2, num_rays=TRAIN_RAYS,
                                                         workspace=ws), seed=SEED)
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer._update_occupancy()
        loss = float(trainer.step(next(iter(trainer.make_loader(train_ds)())))["loss"])
        img, _ = trainer.render_frame(val_ds.poses[0], val_ds.intrinsics, val_ds.H, val_ds.W)
        phase("hidden_dim=128: refresh, train step, frame", t0)
        wide_counts = launch_counts()
        check_launched("hidden_dim=128", wide_counts,
                       ("cp_density_fwd_tc", "cp_density_fwd_residuals", "cp_bwd_banks",
                        "cp_sigma_rgb_tc", "march_turbo", "coarse_lookup_bits"))
        if not math.isfinite(loss) or not np.isfinite(img).all() or img.min() < 0 or img.max() > 1:
            raise RuntimeError(f"hidden_dim=128: loss {loss}, frame values "
                               f"{img.min()}..{img.max()}")
        print(f"hidden_dim=128: loss {loss:.6f}, frame {img.shape}, mean "
              f"{float(img.mean()):.4f}", flush=True)
    del trainer, model

    # 8c. turbo-hq at the CLI's default lattice, beside phase 7's dt_gamma = 0
    t0 = time.perf_counter()
    g_rays_s, gamma_counts, gamma_frame_counts, g_step, g_frame = gamma_window(
        dev, card, rc, nc, train_ds, results)
    phase(f"dt_gamma {CLI_DT_GAMMA} window", t0)
    check_launched(f"dt_gamma {CLI_DT_GAMMA} train", gamma_counts, ("march_turbo",),
                   absent=("coarse_lookup_bits",))
    check_launched(f"dt_gamma {CLI_DT_GAMMA} frame", gamma_frame_counts,
                   ("march_turbo", "coarse_lookup_bits", "cp_sigma_rgb_tc"))
    for what, (zero, gamma) in (("step", (step_prof, g_step)), ("frame", (frame_prof, g_frame))):
        print(f"{what}: dt_gamma 0 {zero[0]:.2f} ms device time in {zero[1]:.0f} launches "
              f"(idle {zero[2]:.3f}); dt_gamma {CLI_DT_GAMMA} {gamma[0]:.2f} ms in "
              f"{gamma[1]:.0f} launches (idle {gamma[2]:.3f})  [{card}]", flush=True)
    print(f"train: dt_gamma 0 {TIMED_STEPS * TRAIN_RAYS / train_dt:.0f} rays/s (steps "
          f"{TRAIN_STEPS - TIMED_STEPS}-{TRAIN_STEPS - 1}), dt_gamma {CLI_DT_GAMMA} "
          f"{g_rays_s:.0f} rays/s (steps {GAMMA_STEPS}-{GAMMA_STEPS + GAMMA_TIMED - 1})  "
          f"[{card}]", flush=True)

    # 9. the hash-grid configuration (main_nerf.py <scene> -O --encoding
    # hashgrid) on the same scene: full width, v1 march, random init
    hrc = RenderConfig(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=1024,
                       max_samples_per_ray=256, grid_size=128, density_thresh=10.0,
                       turbo=False)
    hnc = NetworkConfig(encoding="hashgrid", use_bf16=True)
    torch.cuda.reset_peak_memory_stats()
    model = NeRFNetwork(hnc, hrc, torch.Generator().manual_seed(SEED))  # on the card
    print(f"hash grid: {model.encoder.cfg.num_rows} table rows x {hnc.level_dim}, "
          f"{sum(p.numel() for p in model.parameters())} parameters", flush=True)
    with tempfile.TemporaryDirectory() as ws:
        tc = TrainConfig(iters=30000, lr=1e-2, num_rays=HASH_RAYS, update_extra_interval=16,
                         workspace=ws)
        trainer = GridNeRFTrainer(model, hrc, tc, seed=SEED)
        trainer.mark_untrained(train_ds.poses, train_ds.intrinsics, train_ds.H, train_ds.W)
        # the encoder's own inputs (points, output cotangent) of the first
        # and the last step
        steps_seen, caught = [0], {}

        def keep(module, args, out):
            if not out.requires_grad:
                return
            n = steps_seen[0]
            steps_seen[0] += 1
            if n not in (0, HASH_STEPS - 1):
                return
            x = args[0].detach().reshape(-1, 3).float().clone()
            entry = caught[f"step {n}"] = {"x": x}
            out.register_hook(lambda g, e=entry: e.__setitem__(
                "g", g.detach().reshape(x.shape[0], -1).contiguous().clone()))

        hook = model.encoder.register_forward_hook(keep)
        reset_launch_counts()
        metrics, dt, batches = train(trainer, "hash-grid train", HASH_STEPS, HASH_TIMED)
        hook.remove()
        losses = [m["loss"] for m in metrics]
        hash_train_counts = launch_counts()
        check_launched("hash-grid train", hash_train_counts,
                       ("grid_encode_fwd", "grid_encode_bwd"))
        cp_launched = {k: v for k, v in hash_train_counts.items() if k.startswith("cp_") and v}
        if cp_launched:
            raise RuntimeError(f"hash-grid train: CP kernels launched {cp_launched}")
        steps_s = HASH_TIMED / dt
        print(f"hash-grid train: {steps_s:.2f} steps/s, {steps_s * HASH_RAYS:.0f} rays/s, "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]",
              flush=True)
        # the trained table scaled to a largest |value| of 1: its values
        # (~0.03 at most) are below the default bound, TOL * (1 + |plain|),
        # which a kernel that read the wrong rows would then meet
        table_h = model.encoder.embeddings.detach()
        table_h = (table_h / table_h.abs().max()).contiguous()
        geom_h = model.encoder.cfg.geometry
        for label, entry in caught.items():
            # the forward on the step's own points (consecutive samples of a
            # ray share their coarse cells), then the table gradient
            x = entry["x"]
            results[("grid_encode_fwd", label)] = compare(
                "grid_encode_fwd", lambda: hk.grid_encode_fwd(x, table_h, geom_h, torch.bfloat16),
                lambda: hk.grid_encode_plain(x, table_h, geom_h, torch.bfloat16), "bfloat16",
                grid_fwd_work(x, geom_h, torch.bfloat16))
            step_table_gradient(x, entry["g"], geom_h, label, card, results, library,
                                probe_scatter)
        del table_h
        del caught
        losses = torch.stack(losses).cpu().numpy()
        occ = trainer.aux["occ"]
        print(f"hash-grid train loss: first 16 mean {losses[:16].mean():.6f}, last 16 mean "
              f"{losses[-16:].mean():.6f}; grid iter {occ.iter_density}, occupied "
              f"{float(occ.occ_grid.float().mean()):.4f}")
        if not np.isfinite(losses).all():
            raise RuntimeError("hash-grid train: non-finite loss")
        if not losses[-16:].mean() < LOSS_FALL * losses[:16].mean():
            raise RuntimeError(f"hash-grid train: the loss did not fall below {LOSS_FALL} of "
                               "its start")

        # the val pose with the EMA weights, through the v1 march
        reset_launch_counts()
        pose, H, W = val_ds.poses[0], val_ds.H, val_ds.W
        t0 = time.perf_counter()
        img, _ = trainer.render_frame(pose, val_ds.intrinsics, H, W)
        dt = phase(f"hash-grid frame ({H}x{W}, EMA weights)", t0)
        t0 = time.perf_counter()
        img, _ = trainer.render_frame(pose, val_ds.intrinsics, H, W)
        dt2 = phase(f"hash-grid frame again ({H}x{W})", t0)
        hash_frame_counts = launch_counts()
        check_launched("hash-grid frame", hash_frame_counts, ("grid_encode_fwd",))
        st = trainer.last_render_stats
        psnr = -10.0 * math.log10(float(np.mean((img - gt) ** 2)))
        if img.shape != (H, W, 3) or not np.isfinite(img).all() or not psnr >= MIN_PSNR_HASH:
            raise RuntimeError(f"hash-grid frame: not a finite image of {MIN_PSNR_HASH} dB or "
                               f"more (PSNR {psnr})")
        print(f"hash-grid frame: PSNR {psnr:.2f} dB against the ground truth after "
              f"{HASH_STEPS} steps, {dt * 1e3:.1f} / {dt2 * 1e3:.1f} ms, n_samples "
              f"{st['n_samples']:.0f}, n_dropped {st['n_dropped']:.0f}  [{card}]", flush=True)
        # 16 more steps under the profiler (one grid refresh among them)
        profile(lambda: trainer.step(next(batches)), 16, "step", card)
    del trainer, model

    # 10. one small f32 hash-grid train step: GPU kernels against the CPU
    train_step_gpu_vs_cpu(dev, hash_grid=True)

    with tempfile.TemporaryDirectory() as tmp:
        # 11. the port's command line on a scene on disk
        from ngp_tpu_torch.data.synthetic import make_synthetic_dataset

        scene = os.path.join(tmp, "scene")
        n_train, n_val, n_test = CLI_FRAMES
        t0 = time.perf_counter()
        make_synthetic_dataset(scene, n_train=n_train, n_val=n_val, n_test=n_test, device=dev)
        phase(f"CLI scene ({sum(CLI_FRAMES)} frames of 400x400 written)", t0)
        t0 = time.perf_counter()
        cli_counts, rays_11a, psnr_11a = cli_runs(dev, card, scene, g_rays_s)
        phase("CLI (-O, resume, --test, hashgrid with losses, --rand_pose)", t0)

        # 12. the rest of main_nerf: the background net, no -O, LPIPS
        t0 = time.perf_counter()
        rest_counts = cli_rest_runs(dev, card, scene, psnr_11a, rays_11a, results)
        phase("CLI rest (-O --bg_radius + LPIPS, no -O hash grid and cpgrid, v1 + bg)", t0)

    print_results(results, library, card, printed)
    path_counts = (eval_counts, train_counts, frame_counts, evaluate_counts, test_counts,
                   mesh_counts, wide_counts, gamma_counts, gamma_frame_counts, hash_train_counts,
                   hash_frame_counts, *cli_counts, *rest_counts)
    csrc = "ngp_tpu_torch/ops/kernels/csrc/"
    sources = {
        "cp_density_fwd": (csrc + "cp_kernels.cu", "ngp_tpu/ops/pallas/cp_kernels.py:345",
                           ("cp_density_fwd+residuals", "bfloat16")),
        "cp_sigma_rgb": (csrc + "cp_kernels.cu", "ngp_tpu/ops/pallas/cp_kernels.py:506",
                         ("cp_sigma_rgb", "bfloat16")),
        # the march around the lookup on the train and eval paths, on the last
        # train step's own inputs; the lookup alone in the eval prepass
        "march_turbo": (csrc + "march_kernels.cu", "ngp_tpu/ops/pallas/march_kernels.py:73",
                        ("march_turbo", f"step {TRAIN_STEPS - 1}")),
        "coarse_lookup_bits": (csrc + "march_kernels.cu",
                               "ngp_tpu/ops/pallas/march_kernels.py:73",
                               ("coarse_lookup_bits", "bits")),
        # on the main path's own inputs: the last train step's, a mesh chunk
        "cp_bwd_banks": (csrc + "cp_kernels.cu", "ngp_tpu/ops/pallas/cp_kernels.py:206",
                         ("cp_bwd_banks", f"step {TRAIN_STEPS - 1}")),
        "cp_encode_fwd": (csrc + "cp_kernels.cu", "ngp_tpu/ops/pallas/cp_kernels.py:159",
                          ("cp_encode_fwd", "bfloat16->bfloat16 mesh chunk")),
        # on no path: launches stays 0 (scatter_add_rows too since the table
        # gradient adds by itself)
        "fused_mlp": (csrc + "mlp_kernels.cu", "ngp_tpu/ops/pallas/fused_mlp.py:92",
                      ("fused_mlp", str(MLP_ROWS[0]))),
        "scatter_add_rows": (csrc + "scatter_kernels.cu", "scripts/perf_probe2_r2.py:128",
                             ("scatter_add_rows", "{0}x{2} into {1}".format(*SCATTER_SHAPES[0]))),
        # the JAX package leaves these to XLA: its take and einsum
        "grid_encode_fwd": (csrc + "grid_kernels.cu", "ngp_tpu/ops/hashgrid.py:203",
                            ("grid_encode_fwd", f"bfloat16 {GRID_ROWS[-1]}")),
        "grid_encode_bwd": (csrc + "grid_kernels.cu", "ngp_tpu/ops/hashgrid.py:204",
                            ("grid_encode_bwd", f"step {HASH_STEPS - 1}")),
        # their 2-D instances (the background net), on phase 12 (a)'s last
        # step's own points
        "grid_encode_fwd_2d": (csrc + "grid_kernels.cu", "ngp_tpu/ops/hashgrid.py:203",
                               ("grid_encode_fwd", f"D=2 step {cli_steps(CLI_BG_ITERS) - 1}")),
        "grid_encode_bwd_2d": (csrc + "grid_kernels.cu", "ngp_tpu/ops/hashgrid.py:204",
                               ("grid_encode_bwd", f"D=2 step {cli_steps(CLI_BG_ITERS) - 1}")),
    }
    kernels = []
    for name, (src, replaces, key) in sources.items():
        err, k_ms, p_ms, (b_ms, b_by) = results[key]
        launches = sum(c[name] for c in path_counts)
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "max_abs_err": err, "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": library.get(key)})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
