#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU: the eval render,
training, and the end of a run (evaluate, test, mesh export), at the
turbo-hq preset and in the hash-grid configuration (``-O --encoding
hashgrid``), then the port's command lines: ``-O`` and the rest of
``main_nerf`` (the background net, the renderer without the occupancy
grid, LPIPS), ``main_sdf``, ``main_tensoRF``, ``main_CCNeRF`` and
``main_dnerf``, the viewers, CLIP guidance and the brick grid, and last
the trainers under a mesh (``ngp_tpu_torch/parallel/``, one NCCL rank).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

(``--probe-scatter`` adds ``scatter_probe`` to phase 9; ``--mlp`` builds the
kernels and runs ``mlp_checks`` alone.)
It builds the CUDA kernels from ``ngp_tpu_torch/ops/kernels/csrc`` (and
counts the tensor-core instructions, HMMA, of the two heads' bf16 and f32
(3xTF32) kernels and of the MLP chain's tensor-core kernels (forward and
backward) in the
library's SASS, and their spills in the compiler's report, none allowed
but in the f32 heads'; and prints the registers and spills of the CP
factor backward's and encoder's run kernels, whose SASS must call no
64-bit division routine, and of the turbo march; and of the brick grid's
three kernels, which must not spill nor call a division routine), then

2-3. builds the turbo-hq NeRF network at full width from a seeded
     generator (random weights), refreshes the 128^3 occupancy grid (16
     full sweeps, then one partial refresh), renders 800x800 frames
     through ``GridNeRFTrainer.render_frame`` (the eval path); then (3b)
     the same network built with ``use_bf16=False`` (the f32 heads' API
     path): 16 full refreshes and one 800x800 frame, both heads on their
     3xTF32 route, the radiance kernel held against its plain version on
     the frame's first radiance chunk's own inputs;
4.   holds each kernel against its plain PyTorch version at the paths'
     shapes: the refresh and the eval chunk, the train step's 98,304
     rows for the density forward with residuals and the factor
     backward (and the density forward at the edges of
     ``DENSITY_EDGES`` and at the sigma widths ``WIDE_H1``, the
     radiance head at ``SIGMA_RGB_EDGES``), the mesh export's 65,536-row
     chunk for the CP encoder (on random rows and on one x-slice of the
     256^3 mesh lattice, a save_mesh chunk) and its backward, 524,288 x
     [32, 64, 64, 16] and [32, 64, 16] for the MLP chain's f32 output, and
     its bf16 route (``FusedMLP``'s forward and backward, every bf16 MLP's
     on the card) at the benchmark cells' shapes (``mlp_checks``); the
     hash-grid encoder at the refresh chunk (131,072 points) and a
     hash-grid train step (4096 rays x 256 samples = 1,048,576 points)
     on the full-width table (16 levels x 2, 6,119,864 rows), forward
     and table gradient, and the row scatter-add (on no path since the brick
     grid's table gradient became one kernel; phase 17 (c) holds it on the
     rows of that path's own points) at the
     probe script's shape and one hash level's, with
     ``Tensor.index_add_`` timed beside it; the coarse lookup (which
     no path runs since the eval prepass became one kernel) on random
     cells; the grid kernels' 2-D
     instances on the background net's encoder (4 levels x 2, the
     finest hashed into 2^19 rows) at a background-frame chunk (65,536
     points) and a CLI step's rays (4096), bf16 and f32; the factor taps'
     forward (``sample_taps_fwd``, bit for bit) and gradient
     (``scatter_add_taps``, within ``taps_bound``) on cell-major planes
     and lines of ranks 1, 16 and 48 at 152 on uniform, clustered and
     padded points, strided and stacked coords, both corner conventions,
     beside ``grid_sample``'s forward; the brick grid's kernels
     (``brick_encode_fwd`` and ``brick_table_grad`` within their bounds,
     ``brick_encode_bwd`` bit for bit) at ``--preset tpu``'s geometry on
     random points, a quarter outside the box, and on every level's cell
     and brick edges, bf16 and f32, the table gradient with its zero fill
     timed beside the fill, ``brick_encode_bwd`` and ``scatter_add_rows``
     that made it before;
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
     steps (device time by kernel, the device's idle share), after
     holding the prepass kernel against its plain version on the three
     prepass chunks of an unprofiled 800x800 frame, every ray bit for
     bit;
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
     epochs beside phase 8c's; the prepass kernel on the last test
     frame's prepass, bit for bit), (b) the same one epoch longer, which
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
     versions at its 2,097,152 rows), (d) ``-O --encoding hashgrid
     --bg_radius 32`` (the v1 march with the background net) and (e) (c)
     without ``--fp16``, in f32 as the JAX CLI defaults (the loss falls;
     the density head on its 3xTF32 route, and held against its plain
     version at the step's 2,097,152 rows on the trained weights; rays/s
     and ms a step);
13.  runs ``ngp_tpu_torch.main_sdf sphere`` in this process
     (``sdf_runs``): (a) ``--epochs 2`` (200 steps of 262,144 points, the
     256^3 mesh; the validation MAPE falls, the mesh's median vertex
     radius is the normalised sphere's within ``SDF_RADIUS_TOL``; points/s,
     the host's sampling and BVH label time a batch, a profiled step; the
     grid kernels on the last step's own points against their plain
     versions), (b) ``--test`` on (a)'s workspace (the same mesh), (c)
     ``--fp16 --epochs 1`` (the MAPE falls; the grid kernels in bf16);
14.  runs ``ngp_tpu_torch.main_tensoRF`` on phase 11's scene
     (``tensorf_runs``): (a) ``-O --iters 2048`` (51 epochs, past the
     shrink and the upsample to 152^3 at step 2000; the loss falls, the
     AABB shrank inside the box, the test PSNR beats a white frame's and
     ``TENSORF_MIN_PSNR``; rays/s, a profiled step, ``sample_taps_fwd``
     and ``scatter_add_taps`` (the factor taps' forward and gradient)
     against their plain versions on every call of a step's own taps and,
     for the gradient at 152^3 on uniform, clustered and padded points in
     both corner conventions, beside ``index_add_`` and ``grid_sample``'s
     backward, the factor taps as the port's kernels, as its former
     ``index_select`` forward and as advanced indexing, ``march_turbo`` on the
     last step's and a test frame's own march inputs, every ray bit for
     bit, and the prepass kernel on a test frame's prepass), (b)
     ``--test`` (a fresh trainer resizes to 152^3 before it loads; the
     PSNR equals (a)'s), (c) ``--cp --iters 256`` and (d) ``--bg_radius 32
     --iters 128`` (the loss falls; the background net runs in training
     and in eval); every run launches ``sample_taps_fwd``, the runs that
     train ``scatter_add_taps``, and none the taps' plain gradient in the
     points;
15.  runs ``ngp_tpu_torch.main_CCNeRF`` on phase 11's scene
     (``ccnerf_runs``) at the CLI's widths: (a) ``-O --compose --iters
     512`` (the loss falls; rays/s; the finalized full rank's and the
     three compression levels' test PSNRs beside a white frame's;
     ``finalize`` leaves sigma and rgb at 65,536 points within
     ``FINALIZE_TOL``; the composed scene's frames written; one profiled
     step of the rank-residual model; ``sample_taps_fwd`` and
     ``scatter_add_taps`` on every call of a step's own taps;
     ``march_turbo`` on a step's own
     inputs, and the prepass kernel on a test frame's prepass, bit for
     bit), (b) ``--test`` (the same full-rank PSNR);
16.  writes the dynamic synthetic scene (a moving sphere) and runs
     ``ngp_tpu_torch.main_dnerf`` on it (``dnerf_runs``) at the CLI's
     widths: (a) ``-O --iters 1024`` (the loss falls, the test PSNR beats
     a white frame's and ``DNERF_MIN_PSNR``; rays/s; the refresh wall of a
     full 64-slice sweep and of a quarter; one profiled step; the prepass
     kernel on a test frame's prepass at time 0.5, bit for bit;
     ``grid_encode_bwd_x`` held against its plain version on the last
     step's own points, with its bf16 cotangent and in f32, and on random
     points with 25% outside the box, the forward and table gradient on
     the step's points), (b) ``--test`` (the same PSNR), (c) ``--hyper
     --iters 80`` (the D = 4 forward, table gradient and x-gradient on its
     last step's points and on random 4-D points), (d) ``--basis --iters
     80`` (no x-gradient launched); with ``--dnerf-control`` also (e), (a)
     with the deformation net frozen, whose test PSNR must stay below
     ``DNERF_MIN_PSNR``;
17.  the viewers, CLIP guidance and the brick grid: (a) ``viewer_runs``:
     ``main_nerf <phase 11's scene> -O --gui`` on 11 (a)'s workspace and
     ``main_dnerf -O --gui`` on 16 (a)'s, ``viewer_web.serve`` replaced by
     passes of its loop body (``serve_step``) against a real server on a
     free localhost port: the page, the frame and stats, a train call that
     moves the step, the view held to ``render_frame`` of its pose, SPP
     accumulation and its reset, training off, the ``max_samples`` dial, a
     crop, and a time scrub that changes D-NeRF's view; (b) ``clip_runs``:
     ``CLIPLoss`` at ViT-B/16's widths on weights from SEED, its towers and
     image gradient on the card against the CPU in f32, CLIP's forward and
     backward at 224^2 timed, then ``main_nerf -O --rand_pose 4
     --clip_model_path`` (``CLIPLoss`` replaced by a maker of this loss):
     every guidance step ran with a finite loss and gave the CP factors a
     gradient, the kernels they launched, one profiled guidance step; (c)
     ``brick_runs``: ``main_nerf --preset tpu --iters 400`` and ``--test``
     (a PSNR floor over a white frame's; the training run launches
     ``brick_encode_fwd`` and ``brick_table_grad``, the table gradient,
     and no other kernel, ``--test`` the forward alone) and
     ``brick_encode`` on the last step's own points: the card against the
     CPU, the three kernels against their plain versions, its forward and
     forward + table gradient timed beside their bound, and
     ``scatter_add_rows`` against its plain version on the rows of that
     step's points and cotangent, beside ``index_add_``;
18.  ``ngp_tpu_torch/parallel/`` on one rank over NCCL (``parallel_runs``):
     turbo-hq at full width from one seed with no mesh, under
     ``make_mesh(1)`` and under a (1, 1) ("data", "model") mesh with the CP
     banks split (``shard_params``; the feature gather at one rank):
     ``PARALLEL_STEPS`` steps each (refreshes at 0 and 16), the losses in
     lockstep with no mesh's, rays/s over steps 1-15 and the device time of
     ``PARALLEL_PROFILED`` profiled steps; the 800x800 frame under each
     mesh against the frame of the same weights with no mesh (the fused
     head), ``evaluate`` through ``eval_metrics_dp``, and
     ``eval_metrics_dp`` and ``gather_predictions_dp`` against one-device
     torch. Under a mesh the fused heads step aside, as in JAX: the paths
     must launch ``cp_encode_fwd``, ``cp_bwd_banks`` (training),
     ``march_turbo`` and ``ray_prepass`` (frames) and no CP head.

Each path is run with the launch counts set to 0 just before it and read
just after; a kernel of the path that was not launched fails the run, and
so does ``coarse_lookup_bits`` launched on any path (the prepass kernel
took its place).
Every time is printed beside the card's name and power limit. The line
before the last two is ``{"kernels": [...]}``: per kernel its launches on
the paths, its largest difference from its plain version, its time, the
plain version's, the library call's where one PyTorch call computes the
same function (else null), and its bound, the least time the card could
take for the same work: the larger of the bytes it must move over the
memory rate and its operations over the peak rate of the units that
could do them (``bound``), and under "paths" its launches on each of
phases 14's, 15's, 17's and 18's paths. The last line is a JSON object
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
# calls of a plain version timed in each of compare's two plain windows
# (after two warm-ups): the plain versions take 0.1-200 ms a call, and
# PERF.md holds their times from runs of 10; fewer keep the smoke inside
# its time limit
PLAIN_REPS = 3
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
# the bf16 MLPs of the benchmark's cells through FusedMLP (mlp_checks): the
# hash cell's sigma and colour nets on a step's 8,192 x 256 slots, turbo's
# colour net on its 262,140 compact rows; MLP_LIVE of each 256-slot ray
# carry a cotangent in the march-like case (the hash cell composites
# ~12% of its slots), the rest are zero
MLP_CELLS = ((2_097_152, (32, 64, 16)), (2_097_152, (31, 64, 64, 3)),
             (262_140, (31, 64, 64, 3)))
MLP_LIVE = 30
# the share of rows whose dX may move by a flipped ReLU (mlp_flipped_rows)
MLP_FLIPPED = 1e-4
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
CLI_V1_BG_ITERS = 128
CLI_GUIDE_ITERS = 64
CLI_RAND_POSE = 4
# phase 12: the rest of main_nerf on the same scene. (a) turbo-hq with the
# background net on a sphere of radius CLI_BG_RADIUS and LPIPS from a
# random-weight checkpoint, CLI_BG_ITERS iterations (25 epochs: cut from 51
# to hold the smoke's time) on frames of 100x100 (--downscale
# CLI_BG_DOWNSCALE); (b) no -O at the CLI's defaults (hash grid, f32, 512
# samples a ray, 4096 rays: 2,097,152 samples a step), CLI_UNIFORM_ITERS;
# (c) no -O with the CP grid at the turbo-hq widths in bf16, CLI_CP_ITERS;
# (d) the hash grid's v1 march with the background net, CLI_V1_BG_ITERS
# (256 until phases 15-16 came; cut to hold the smoke near 700 s); (e) (c)
# in f32, CLI_CP_ITERS.
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
# phase 13: main_sdf sphere at the CLI's widths (262,144 points a batch, 100
# batches an epoch); the mesh's median vertex radius must be the normalised
# sphere's (normalize_mesh: 0.95 / sqrt(3)) within about one lattice cell of
# the 256^3 mesh (2 / 255)
SDF_EPOCHS = 2
SDF_POINTS = 2**18
SDF_RADIUS = 0.95 / math.sqrt(3)
SDF_RADIUS_TOL = 0.01
# phase 14: main_tensoRF on phase 11's scene; 2048 iterations are 51 epochs,
# past step 2000's shrink and upsample to 152^3 (resolutions 128 -> 300 over
# five steps); the test PSNR must beat a white frame's and this floor: the
# first two runs (NVIDIA H100 80GB HBM3, 700.00 W) read 25.91 and 25.88 dB,
# the floor is the lowest less 1.5 dB (wider than the 0.9 dB over which
# turbo-hq's PSNR spreads within one tree), rounded down
TENSORF_ITERS = 2048
TENSORF_RES = 152
TENSORF_MIN_PSNR = 24.0
# (c) and (d) were 512 and 256 iterations until phases 15-16 came; cut to
# hold the smoke near 700 s
TENSORF_CP_ITERS = 256
TENSORF_BG_ITERS = 128
BG_GRID = dict(input_dim=2, num_levels=4, log2_hashmap_size=19, desired_resolution=2048)
# phase 15, CCNeRF at the CLI's widths on phase 11's scene: cut from 30,000
# iterations; the finalized field held to its trained one (sums over ranks
# in another order)
CCNERF_ITERS = 512
CCNERF_MIN_PSNR = 28.0
FINALIZE_TOL = 1e-4
# phase 16, D-NeRF at the CLI's widths on the dynamic scene: (a) cut from
# 30,000 iterations to 25 epochs (16 full refreshes, then 46 of a quarter),
# (c) and (d) to 2 epochs, their 5 refreshes cut from JAX's schedule (16
# full 64-slice sweeps, then quarters; 4-7.6 s a sweep, 0.4-0.5 s a quarter)
# to DNERF_SHORT_FULL_SWEEPS full sweeps, then quarters (so that the smoke
# holds its time limit; (a) with 4 full sweeps read 12.71 dB, under the
# floor; the schedule itself is held to JAX's on the CPU,
# tests/test_torch_dnerf.py); the x-gradient's tolerance by cotangent type
# (see bwd_x_checks). The floor sits between (a)'s readings (NVIDIA H100
# 80GB HBM3, 700.00 W: 13.43-14.48 dB in four runs) and those of (a) with
# the deformation net frozen (--dnerf-control: 12.11-12.12 in two runs; a
# white frame 11.56)
DNERF_ITERS = 1024
DNERF_SHORT_ITERS = 80
DNERF_SHORT_FULL_SWEEPS = 1
DNERF_MIN_PSNR = 12.8
# phase 17: (a) the viewers, their views held to render_frame within this many
# u8 levels (f32 atomics in the compositor); (b) CLIP guidance at ViT-B/16's
# widths on random weights: fixed token ids (start of text 49406, then ids of
# the vocabulary, end of text 49407, the largest id, where the text tower
# pools), the card's towers and image gradient held to the CPU's in f32 within
# CLIP_TOL of the largest entry; (c) --preset tpu for BRICK_ITERS iterations
# (10 epochs), whose test PSNR must beat a white frame's by BRICK_MIN_GAIN dB
# (set before its first run; PERF.md)
VIEW_LEVELS = 1
CLIP_IDS = (49406, 320, 1125, 539, 320, 4269, 49407)
CLIP_TOL = 1e-3
BRICK_ITERS = 400
BRICK_MIN_GAIN = 5.0
BWD_X_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# calls of a plain version timed in each of compare's two plain windows
# (after two warm-ups): the plain versions take 0.1-200 ms a call, and
# PERF.md holds their times from runs of 10; fewer keep the smoke inside
# its time limit
PLAIN_REPS = 3
# phase 18: turbo-hq under a mesh of one rank (NCCL), update_extra_interval
# + 1 steps (refreshes at steps 0 and 16), each loss within
# PARALLEL_LOSS_TOL[0] + PARALLEL_LOSS_TOL[1] |one device's|
# (__graft_entry__.py:_dryrun_multichip_inner); steps 1-15 timed (no refresh)
PARALLEL_STEPS = 17
PARALLEL_LOSS_TOL = (1e-4, 5e-3)
PARALLEL_PROFILED = 4
BG_ROWS = (65536, 4096)
# H100 SXM (NVIDIA's data sheet): HBM bytes/s, dense bf16 tensor-core and
# f32 CUDA-core FLOP/s, and f32-accurate products on the tensor cores: three
# TF32 products each (3xTF32) at the dense TF32 rate, 495 TFLOP/s
HBM_RATE = 3.35e12
BF16_TENSOR_RATE = 989e12
F32_CORE_RATE = 67e12
TF32X3_TENSOR_RATE = 495e12 / 3
# the least HBM moves at once: a table row read or written costs its sector
SECTOR = 32
# the profiler trace's event categories that are device work
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, tensor_flops=0.0, core_flops=0.0, tf32x3_flops=0.0):
    """(ms, "bytes" or "operations"): the least time of a kernel that reads
    and writes ``n_bytes`` once and does ``tensor_flops`` of matrix
    products (bf16 tensor cores), ``core_flops`` of other arithmetic (f32
    CUDA cores) and ``tf32x3_flops`` of f32-accurate matrix products
    (3xTF32 on the tensor cores)."""
    t_bytes = n_bytes / HBM_RATE
    t_ops = max(tensor_flops / BF16_TENSOR_RATE, core_flops / F32_CORE_RATE,
                tf32x3_flops / TF32X3_TENSOR_RATE)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def head_work(n_bytes, dtype, product_flops, other_flops):
    """(bytes, bf16 tensor-core operations, CUDA-core operations, 3xTF32
    operations) of a CP head, ``bound``'s arguments: its matrix products on
    the tensor cores, in bf16 or, for f32, at the 3xTF32 rate (the least
    the card needs for f32-accurate products, whichever route the kernel
    takes), the rest on the CUDA cores."""
    if dtype == "bfloat16":
        return n_bytes, product_flops, other_flops, 0
    return n_bytes, 0, other_flops, product_flops


def density_work(pos, factors, w1, w2, residuals=False):
    """``head_work`` of ``cp_density_fwd`` on these tensors: pos, the banks
    and the weights read, the f32 output (and the feats and h1 residuals,
    in the weight type) written; both products; a CP lerp about 14
    operations per (row, bank column), three taps of 4 and two products."""
    M, (D, H1), OUT = pos.shape[0], w1.shape, w2.shape[1]
    n_bytes = nbytes(pos, *factors, w1, w2) + M * OUT * 4
    if residuals:
        n_bytes += M * (D + H1) * w1.element_size()
    nbR = len(factors) * factors[0].shape[-1]
    return head_work(n_bytes, str(w1.dtype).split(".")[-1], 2 * M * (D * H1 + H1 * OUT),
                     14 * M * nbR)


def sigma_rgb_work(pos, dirs, factors, w1, w2, color):
    """``head_work`` of ``cp_sigma_rgb`` on these tensors: pos, dirs, the
    banks and every weight read, 16 bytes a row written; the density
    products and the colour MLP's; the lerps as ``density_work``."""
    M = pos.shape[0]
    flops = 2 * M * sum(w.numel() for w in (w1, w2, *color))
    nbR = len(factors) * factors[0].shape[-1]
    return head_work(nbytes(pos, dirs, *factors, w1, w2, *color) + M * 16,
                     str(w1.dtype).split(".")[-1], flops, 14 * M * nbR)


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


def taps_bound(sk, g, coords, shape, align_corners):
    """``scatter_add_taps`` sums each cell's products g * w in no fixed
    order: per entry, 2 (n - 1) 2^-24 times the sum of its n products'
    magnitudes (n: the taps that land in the cell)."""
    import torch

    counts = torch.zeros(math.prod(shape[1:]), device=g.device)
    for idx, ok, _ in sk.factor_taps(coords, shape[1:], align_corners):
        counts.index_add_(0, idx[ok], torch.ones(int(ok.sum()), device=g.device))
    s_abs = sk.scatter_add_taps_plain(g.abs(), coords, torch.zeros(shape, device=g.device),
                                      align_corners)
    return 2.0 * 2.0**-24 * counts.view(shape[1:]) * s_abs


def taps_check(sk, g, coords, shape, align_corners, label, card, results, library, timed=True):
    """``scatter_add_taps`` (g [R, N], coords [N] or [N, 2], a factor of
    ``shape``) against its plain version: the same cells receive a
    gradient (the kernel rounds the pixel coordinates as the forward does)
    and each entry is within ``taps_bound``. With ``timed``, its time
    beside its bound (g and the coords read once, the factor gradient
    written once; per sample about 5 operations a tap for its cell and
    weight, per row and tap a product and a sum), ``index_add_`` over the
    taps' concatenated cells and weighted cotangent, and the backward of
    ``grid_sample`` (bilinear, zeros padding, the same corner convention)
    into its input: the same gradient in one PyTorch call, its
    ``library_ms``, beside its largest difference from the kernel (it
    rounds the pixel coordinates its own way)."""
    import torch
    import torch.nn.functional as F

    got = sk.scatter_add_taps(g, coords, cell_major_zeros(shape, g.device), align_corners)
    want = sk.scatter_add_taps_plain(g, coords, cell_major_zeros(shape, g.device),
                                     align_corners)
    bound_t = taps_bound(sk, g, coords, shape, align_corners)
    err = (got - want).abs()
    if not torch.equal(got != 0, want != 0) or (err > bound_t).any():
        raise RuntimeError(f"scatter_add_taps [{label}]: the kernel's cells or sums differ from "
                           f"the plain version's (max |kernel - plain| {float(err.max())})")
    if not timed:
        return float(err.max())
    R, N = g.shape
    taps = 2 if len(shape) == 2 else 4
    key = ("scatter_add_taps", label)
    # the kernel's d factor cell-major, index_add_'s row-major (its own layout)
    outs = [cell_major_zeros(shape, g.device) for _ in range(2)]
    outs.append(torch.zeros(shape, device=g.device))
    results[key] = compare(
        "scatter_add_taps", lambda: sk.scatter_add_taps(g, coords, outs[0], align_corners),
        lambda: sk.scatter_add_taps_plain(g, coords, outs[1], align_corners), "float32",
        (nbytes(g, coords) + 4 * math.prod(shape), 0, N * 5 * taps + 2 * R * N * taps),
        tol=lambda _: [bound_t])
    cells, vals = [], []
    for idx, ok, w in sk.factor_taps(coords, shape[1:], align_corners):
        cells.append(idx)
        vals.append(torch.where(ok[None, :], g * w[None, :], torch.zeros((), device=g.device)))
    cells, vals = torch.cat(cells), torch.cat(vals, dim=1)
    flat = outs[2].view(R, -1)
    add_ms = cuda_ms(lambda: flat.index_add_(1, cells, vals))
    add_dev = device_ms(lambda: flat.index_add_(1, cells, vals))
    # a line is an image of one row, sampled at y = 0 (exactly its row)
    spatial = (1, shape[1]) if len(shape) == 2 else shape[1:]
    inp = torch.zeros((1, R, *spatial), device=g.device, requires_grad=True)
    uv = coords if coords.ndim == 2 else torch.stack([coords, torch.zeros_like(coords)], dim=-1)
    sampled = F.grid_sample(inp, uv.reshape(1, 1, N, 2), mode="bilinear", padding_mode="zeros",
                            align_corners=align_corners)
    gs = g.view(1, R, 1, N)
    (d_inp,) = torch.autograd.grad(sampled, inp, gs, retain_graph=True)
    library[key] = cuda_ms(lambda: torch.autograd.grad(sampled, inp, gs, retain_graph=True))
    gs_dev = device_ms(lambda: torch.autograd.grad(sampled, inp, gs, retain_graph=True))
    gs_diff = float((d_inp.view(shape) - got).abs().max())
    print(f"scatter_add_taps [{label}]: {R} rows x {N} samples into {tuple(shape[1:])}, "
          f"align_corners={align_corners}; kernel {results[key][1]:.4f} ms, device "
          f"{device_ms(lambda: sk.scatter_add_taps(g, coords, outs[0], align_corners)):.4f} ms "
          f"(queued), plain {results[key][2]:.4f} ms, index_add_ {add_ms:.4f} ms (device "
          f"{add_dev:.4f}), grid_sample's backward {library[key]:.4f} ms (device {gs_dev:.4f}; "
          f"max |difference| from the kernel {gs_diff:.3e}), bound {results[key][3][0]:.4f} ms  "
          f"[{card}]", flush=True)
    return float(err.max())


def cell_major_zeros(shape, device):
    """Zeros of ``shape`` [R, ...] held cell-major (memory [..., R]), the
    layout of the factors and of their gradient on the card."""
    import torch

    return torch.zeros((*shape[1:], shape[0]), device=device).movedim(-1, 0)


def keep_taps(sk, calls):
    """A stand-in for ``scatter_add_taps`` that keeps each call's inputs
    (g and the coords cloned, the factor's shape, the convention) in
    ``calls`` and launches the kernel."""
    launch = sk.scatter_add_taps

    def keeping(g, coords, out, align_corners):
        calls.append((g.clone(), coords.clone(), tuple(out.shape), align_corners))
        return launch(g, coords, out, align_corners)

    return keeping


def step_taps(sk, calls, label, card, results, library):
    """``taps_check`` on every call of a step's factor taps (``keep_taps``),
    the largest (rows x samples) one timed, under "<label> largest call"."""
    largest = max(range(len(calls)), key=lambda i: calls[i][0].numel())
    worst = 0.0
    for i, (g, coords, shape, align) in enumerate(calls):
        if i != largest:
            worst = max(worst, taps_check(sk, g, coords, shape, align, f"{label} call {i}", card,
                                          results, library, timed=False))
    g, coords, shape, align = calls[largest]
    worst = max(worst, taps_check(sk, g, coords, shape, align, f"{label} largest call", card,
                                  results, library))
    print(f"{label}: {len(calls)} scatter_add_taps calls held against the plain version, max "
          f"|kernel - plain| {worst:.3e}  [{card}]", flush=True)


def restride(t, stride):
    """A copy of ``t`` laid out with ``stride`` (a column of a wider
    tensor, as the paths pass the taps' coords), on a buffer of its own."""
    import torch

    size = 1 + sum((n - 1) * st for n, st in zip(t.shape, stride))
    return torch.empty(size, dtype=t.dtype, device=t.device).as_strided(t.shape, stride) \
        .copy_(t)


def taps_fwd_check(sk, factor, coords, align_corners, label, card, results, library,
                   timed=True):
    """``sample_taps_fwd`` (factor [R, D] or [R, H, W], coords [N] or
    [N, 2] of any strides) against its plain version on the same inputs:
    equal bit for bit (every product and sum rounded on its own, in the
    plain version's order). With ``timed``, its time beside its bound (the
    factor and the coords read once, the [R, N] f32 output written once;
    per sample about 5 operations a tap for its cell and weight, per row
    and tap a product and a sum), and the forward of ``grid_sample``
    (bilinear, zeros padding, the same corner convention) on the same
    factor and points, its ``library_ms``, beside its largest difference
    from the kernel (it rounds the pixel coordinates its own way)."""
    import torch
    import torch.nn.functional as F

    got = sk.sample_taps_fwd(factor, coords, align_corners)
    want = sk.sample_taps_plain(factor, coords, align_corners)
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise RuntimeError(f"sample_taps_fwd [{label}]: the kernel differs from the plain "
                           f"version (max |kernel - plain| {float((got - want).abs().max())})")
    if not timed:
        return
    R, N = got.shape
    taps = 2 if factor.ndim == 2 else 4
    key = ("sample_taps_fwd", label)
    results[key] = compare(
        "sample_taps_fwd", lambda: sk.sample_taps_fwd(factor, coords, align_corners),
        lambda: sk.sample_taps_plain(factor, coords, align_corners), "float32",
        (nbytes(factor, coords) + 4 * R * N, 0, N * 5 * taps + 2 * R * N * taps),
        tol=lambda want: [torch.zeros_like(want[0])])
    # a line is an image of one row, sampled at y = 0 (exactly its row)
    spatial = (1, factor.shape[1]) if factor.ndim == 2 else factor.shape[1:]
    inp = factor.float().reshape(1, R, *spatial)
    uv = coords if coords.ndim == 2 else torch.stack([coords, torch.zeros_like(coords)], dim=-1)
    uv = uv.float().reshape(1, 1, N, 2)

    def sample():
        return F.grid_sample(inp, uv, mode="bilinear", padding_mode="zeros",
                             align_corners=align_corners)

    gs_diff = float((sample().view(R, N) - got).abs().max())
    library[key] = cuda_ms(sample)
    print(f"sample_taps_fwd [{label}]: {R} rows of {tuple(factor.shape[1:])} "
          f"({str(factor.dtype).split('.')[-1]}) at {N} samples (coord strides "
          f"{coords.stride()}), align_corners={align_corners}; kernel {results[key][1]:.4f} ms, "
          f"device {device_ms(lambda: sk.sample_taps_fwd(factor, coords, align_corners)):.4f} "
          f"ms (queued), plain {results[key][2]:.4f} ms, grid_sample {library[key]:.4f} ms "
          f"(device {device_ms(sample):.4f}; max |difference| from the kernel {gs_diff:.3e}), "
          f"bound {results[key][3][0]:.4f} ms  [{card}]", flush=True)


def keep_taps_fwd(sk, calls):
    """A stand-in for ``sample_taps_fwd`` that keeps each call's inputs
    (the factor and the coords cloned, the coords' strides, the
    convention) in ``calls`` and launches the kernel."""
    launch = sk.sample_taps_fwd

    def keeping(factor, coords, align_corners):
        calls.append((factor.clone(), coords.clone(), coords.stride(), align_corners))
        return launch(factor, coords, align_corners)

    return keeping


def step_taps_fwd(sk, calls, label, card, results, library):
    """``taps_fwd_check`` on every call of a step's taps forward
    (``keep_taps_fwd``, the coords laid out with their own strides), the
    largest (rows x samples) one timed, under "<label> largest call"."""
    largest = max(range(len(calls)), key=lambda i: calls[i][0].shape[0] * calls[i][1].shape[0])
    for i, (factor, coords, stride, align) in enumerate(calls):
        taps_fwd_check(sk, factor, restride(coords, stride), align,
                       f"{label} largest call" if i == largest else f"{label} call {i}", card,
                       results, library, timed=i == largest)
    print(f"{label}: {len(calls)} sample_taps_fwd calls equal to the plain version bit for "
          f"bit  [{card}]", flush=True)


def brick_work(x, cfg, out_bytes, per_item, live=None):
    """(bytes, 0, operations) of a brick kernel on points x [N, 3]: x read,
    the 32-byte sectors of the stencil cells that the points inside the box
    read or write (each distinct sector once: 8 cells of C floats a point
    and level; with ``live`` [N, L], only where it is true), ``out_bytes``
    read or written; ``per_item`` operations a (point, level)."""
    import torch

    from ngp_tpu_torch.ops import brickgrid

    L, C = cfg.num_levels, cfg.level_dim
    inside = inside_rows(x)
    sectors = []
    ijk = torch.arange(2, device=x.device)
    for level in range(L):
        xi = x[inside if live is None else inside & live[:, level]]
        x0 = torch.floor(xi * cfg.level_scale(level) + 0.5).long()
        row = brickgrid._brick_index(cfg, level, x0 >> 1) + cfg.offsets[level]
        lo = x0 & 1
        cell = ((lo[:, 0, None, None, None] + ijk[:, None, None]) * 9
                + (lo[:, 1, None, None, None] + ijk[None, :, None]) * 3
                + (lo[:, 2, None, None, None] + ijk[None, None, :])).reshape(-1, 8)
        first = (row[:, None] * 27 + cell) * C * 4
        sectors.append(torch.unique(torch.cat([first // SECTOR,
                                               (first + C * 4 - 1) // SECTOR])))
    read = torch.unique(torch.cat(sectors)).numel() * SECTOR
    return nbytes(x) + read + out_bytes, 0, x.shape[0] * L * per_item


def brick_fwd_bound(bg, x, table, cfg, dt):
    """``brick_encode_fwd`` sums the same 8 products of the compute type as
    its plain version in another f32 order and rounds once: in f32 within
    1e-6 of the sum of the products' magnitudes S (two orders of 7 f32
    additions, 2 x 7 x 2^-24 < 1e-6); in bf16 within one bf16 step of the
    plain value (2^-7 |plain| bounds its ulp) plus 2^-20 S (the f32 orders'
    difference, which a sum that cancels can carry past one step). S is the
    plain version on |table|: the weights are not negative."""
    import torch

    with torch.no_grad():
        s_abs = bg.brick_encode_plain(x, table.abs(), cfg, dt).float()

    def tol(want):
        if dt == torch.float32:
            return [1e-6 * s_abs]
        return [2.0**-7 * want[0].float().abs() + 2.0**-20 * s_abs]

    return tol


def brick_grad_bound(bg, x, g, cfg):
    """``brick_table_grad`` adds the products ``brick_encode_bwd_plain``
    puts in its rows, in another f32 order: ``scatter_bound`` of those
    rows."""
    from ngp_tpu_torch.ops.kernels import scatter as sk

    idx, rows = bg.brick_encode_bwd_plain(x, g, cfg)
    return scatter_bound(sk, idx, rows, cfg.num_rows)


def brick_checks(bg, x, table, cfg, g, label, card, results, timed=True):
    """``brick_encode_fwd``, ``brick_table_grad`` and ``brick_encode_bwd`` on
    points x [N, 3], the table and the output's cotangent g (its dtype the
    compute type) against their plain versions: the forward within
    ``brick_fwd_bound``, the table gradient (into a zeroed table) within
    ``brick_grad_bound``, the rows kernel's rows and row indices bit for
    bit. With ``timed``, each timed beside its bound (``brick_work``: the
    forward writes its output, about 9 + 8 (2 + 2 C) operations a point and
    level; the table gradient reads g and writes the stencil sectors of the
    (point, level)s whose cotangent is not zero, 9 + 8 (1 + C); the rows
    kernel reads g and writes the rows and indices, 9 + 8 (2 + C)), and the
    device ms of the table gradient with its zero fill beside the fill, the
    rows kernel and ``scatter_add_rows`` that made it before (on the same
    inputs), and the fill alone."""
    import torch

    from ngp_tpu_torch.ops.kernels import scatter as sk

    dt = g.dtype
    N, L, C = x.shape[0], cfg.num_levels, cfg.level_dim
    shape = (cfg.num_rows, cfg.row_width)
    tol = brick_fwd_bound(bg, x, table, cfg, dt)
    with torch.no_grad():
        got = bg.brick_encode_fwd(x, table, cfg, dt)
        want = bg.brick_encode_plain(x, table, cfg, dt)
    err = (got.float() - want.float()).abs()
    if got.dtype != want.dtype or (err > tol([want])[0]).any():
        raise RuntimeError(f"brick_encode_fwd [{label}]: max |kernel - plain| "
                           f"{float(err.max())} exceeds its bound")
    g_bound = brick_grad_bound(bg, x, g, cfg)
    got_t = bg.brick_table_grad(x, g, cfg, torch.zeros(shape, device=x.device))
    want_t = bg.brick_table_grad_plain(x, g, cfg, torch.zeros(shape, device=x.device))
    err_t = (got_t - want_t).abs()
    if (err_t > g_bound).any():
        raise RuntimeError(f"brick_table_grad [{label}]: max |kernel - plain| "
                           f"{float(err_t.max())} exceeds its bound")
    del got_t, want_t, err_t
    (idx, rows), (idx_p, rows_p) = bg.brick_encode_bwd(x, g, cfg), \
        bg.brick_encode_bwd_plain(x, g, cfg)
    if not (torch.equal(idx, idx_p) and torch.equal(rows.view(torch.int32),
                                                    rows_p.view(torch.int32))):
        raise RuntimeError(f"brick_encode_bwd [{label}]: the kernel's rows or indices differ "
                           "from the plain version's")
    del idx, rows, idx_p, rows_p
    if not timed:
        return float(err.max())
    name = str(dt).split(".")[-1]
    with torch.no_grad():
        results[("brick_encode_fwd", label)] = compare(
            "brick_encode_fwd", lambda: bg.brick_encode_fwd(x, table, cfg, dt),
            lambda: bg.brick_encode_plain(x, table, cfg, dt), name,
            brick_work(x, cfg, N * L * C * dt.itemsize, 9 + 8 * (2 + 2 * C)), tol=tol)
    outs = [torch.zeros(shape, device=x.device) for _ in range(2)]
    live = (g.view(N, L, C) != 0).any(dim=2)
    results[("brick_table_grad", label)] = compare(
        "brick_table_grad", lambda: bg.brick_table_grad(x, g, cfg, outs[0]),
        lambda: bg.brick_table_grad_plain(x, g, cfg, outs[1]), name,
        brick_work(x, cfg, nbytes(g), 9 + 8 * (1 + C), live), tol=lambda want: [g_bound])
    del outs, g_bound
    results[("brick_encode_bwd", label)] = compare(
        "brick_encode_bwd", lambda: bg.brick_encode_bwd(x, g, cfg),
        lambda: bg.brick_encode_bwd_plain(x, g, cfg), name,
        (nbytes(x, g) + N * L * (4 + cfg.row_width * 4), 0, N * L * (9 + 8 * (2 + C))),
        tol=lambda want: [torch.zeros_like(w, dtype=torch.float32) for w in want])
    dev_ms = {
        "brick_encode_fwd": device_ms(lambda: bg.brick_encode_fwd(x, table, cfg, dt)),
        "brick_table_grad": device_ms(lambda: bg.brick_table_grad(
            x, g, cfg, torch.zeros(shape, device=x.device))),
        "brick_encode_bwd": device_ms(lambda: bg.brick_encode_bwd(x, g, cfg))}
    fill = device_ms(lambda: torch.zeros(shape, device=x.device))
    before = device_ms(lambda: sk.scatter_add_rows(*bg.brick_encode_bwd(x, g, cfg),
                                                   torch.zeros(shape, device=x.device)))
    for what, ms in dev_ms.items():
        r = results[(what, label)]
        with_fill = " with its zero fill" if what == "brick_table_grad" else ""
        print(f"{what} [{label}]: {N} points x {L} levels x {C} ({name}); kernel {r[1]:.4f} ms, "
              f"device{with_fill} {ms:.4f} ms (queued), plain {r[2]:.4f} ms, bound "
              f"{r[3][0]:.4f} ms ({r[3][1]}), max |kernel - plain| {r[0]:.3e}  [{card}]",
              flush=True)
    print(f"brick table gradient [{label}]: device ms, queued: zero fill + brick_table_grad "
          f"{dev_ms['brick_table_grad']:.4f}; zero fill + brick_encode_bwd + scatter_add_rows "
          f"{before:.4f}; the fill alone {fill:.4f} ({nbytes(table) / 1e6:.1f} MB); bound of "
          f"the fill and the table gradient "
          f"{bound(nbytes(x, g) + cfg.num_rows * cfg.row_width * 4)[0]:.4f}  [{card}]",
          flush=True)
    return float(err.max())


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


def device_ms(fn, reps=20):
    """Device time of one call: CUDA events around ``reps`` calls that the
    host queues behind a 10 ms sleep kernel, so they run back to back
    without the host time between launches, which ``cuda_ms`` includes
    where the wrapper is slower than its kernel. The call must not make
    the host wait for the device."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # clock cycles: ~10 ms at the H100's 1.98 GHz
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
    p1, k1 = cuda_ms(plain, reps=PLAIN_REPS), cuda_ms(kernel)
    k2, p2 = cuda_ms(kernel), cuda_ms(plain, reps=PLAIN_REPS)
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


def sass_dump(lib_path):
    """The built library's SASS, from ``cuobjdump --dump-sass`` (about
    15 s on an H100 host: dumped once and read for every kernel)."""
    from ngp_tpu_torch.ops.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "--dump-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout


def sass_lines(sass, kernel):
    """The SASS instruction lines of every function in ``sass`` (a
    ``sass_dump``) whose name holds ``kernel``."""
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
        lib = "" if lib is None else f", library {lib:.4f} ms"
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


def keep_prepasses(occupancy, kept, last):
    """Wrap the prepass kernel that ``occupancy.ray_prepass`` calls, so the
    list ``kept`` holds the inputs (cloned) of its last ``last`` calls.
    Returns a function that restores the kernel."""
    import torch

    launch = occupancy.ray_prepass_kernel

    def keep(rays_o, rays_d, payload, cfg, aabb=None):
        kept.append(((rays_o.clone(), rays_d.clone(), payload.clone(), cfg),
                     dict(aabb=aabb.clone() if torch.is_tensor(aabb) else aabb)))
        del kept[:-last]
        return launch(rays_o, rays_d, payload, cfg, aabb=aabb)

    occupancy.ray_prepass_kernel = keep

    def restore():
        occupancy.ray_prepass_kernel = launch

    return restore


def compare_prepass(label, args, kw, card, results):
    """``ray_prepass_kernel`` against ``ray_prepass_plain`` on one prepass
    call's own inputs: every ray's hit, t0, t1, near and far bit for bit;
    then the times (plain, kernel, kernel, plain). Bound: the rays and the
    payload read once, the five outputs written once."""
    import torch

    from ngp_tpu_torch.ops.kernels import march

    got = march.ray_prepass_kernel(*args, **kw)
    want = march.ray_prepass_plain(*args, **kw)
    torch.cuda.synchronize()
    differ = torch.zeros_like(want["hit"])
    for k in ("hit", "t0", "t1", "nears", "fars"):
        if got[k].dtype != want[k].dtype or got[k].shape != want[k].shape:
            raise RuntimeError(f"ray_prepass [{label}]: {k} differs in type or shape")
        differ |= got[k] != want[k]
    n_diff = int(differ.sum())
    hit = want["hit"]
    span = float((want["t1"] - want["t0"])[hit].mean()) if bool(hit.any()) else 0.0
    print(f"ray_prepass [{label}]: {hit.numel()} rays, {int(hit.sum())} hit, mean span "
          f"{span:.4f}, {n_diff} rays differ from the plain version", flush=True)
    if n_diff:
        raise RuntimeError(f"ray_prepass [{label}]: {n_diff} rays differ from the plain version")
    n_bytes = nbytes(*args[:3], *got.values())
    p1 = cuda_ms(lambda: march.ray_prepass_plain(*args, **kw))
    k1 = cuda_ms(lambda: march.ray_prepass_kernel(*args, **kw))
    k2 = cuda_ms(lambda: march.ray_prepass_kernel(*args, **kw))
    p2 = cuda_ms(lambda: march.ray_prepass_plain(*args, **kw))
    dev_ms = device_ms(lambda: march.ray_prepass_kernel(*args, **kw))
    print(f"ray_prepass [{label}]: device {dev_ms:.4f} ms a launch (queued), "
          f"{(k1 + k2) / 2:.4f} ms between back-to-back calls  [{card}]", flush=True)
    results[("ray_prepass", label)] = (0.0, (k1 + k2) / 2, (p1 + p2) / 2, bound(n_bytes))


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
                             card, focus=("march", "ray_prepass", "coarse_lookup"))
        step_prof = profile(lambda: trainer.step(next(batches)), 16, "step", card,
                            focus=("march", "topk"))
    return rays_s, step_counts, frame_counts, step_prof, frame_prof


def bf16_steps(got, want):
    """|got - want| in bf16 steps of want (2^(e - 7) for |want| in [2^e,
    2^(e + 1)); the smallest normal's step where want is 0)."""
    import torch

    got, want = got.float(), want.float()
    _, e = torch.frexp(want.abs().clamp_min(torch.finfo(torch.float32).tiny))
    return (got - want).abs() / torch.ldexp(torch.ones_like(want), e - 8)


def mlp_fwd_slack(fm, x, ws):
    """How far y may move between two orders of the chain's f32 sums: each
    sum by 2^-20 of its terms' magnitudes, each rounding to bf16 by one
    step (at most 2^-7 of the value) more where the sum moved, the moves
    carried through the next layers' |W| (a ReLU moves nothing further)."""
    import torch

    hs = []
    y = fm.mlp_chain(x, ws, torch.bfloat16, hs)
    hs = [h.float().abs() for h in hs + [y]]
    d = torch.zeros_like(hs[0])
    for h, h_next, w in zip(hs, hs[1:], ws):
        wa = w.to(torch.bfloat16).float().abs()
        pre = d @ wa + 2.0**-20 * (h @ wa)
        d = pre + 2.0**-7 * (h_next + pre)
    return d


def mlp_flipped_rows(dx, dx_ref):
    """The rows of dX more than 1e-2 of its largest entry off the plain
    version's: rows where a hidden unit's ReLU flipped between the two
    orders of its f32 sums."""
    err = (dx.float() - dx_ref.float()).abs().amax(1)
    return int((err > 1e-2 * float(dx_ref.float().abs().max())).sum())


def mlp_checks(fm, dev, card, results, library):
    """The bf16 MLP route at the benchmark cells' shapes (MLP_CELLS):
    ``mlp_bf16_fwd`` and ``mlp_bf16_bwd`` against their plain versions on the
    card (the cuBLAS f32 chain), with a dense cotangent and a march-like one
    (MLP_LIVE rows of each 256 live), timed beside their bound (x, g and
    the weights read, y, dX and dW written once; products at the bf16
    rate), the plain versions and today's path (autograd of MLP.forward's
    chain, forward and backward) as ``library_ms``. The forward is held to
    ``mlp_fwd_slack`` (one bf16 step of y, more where a hidden value
    rounded to the other neighbour), dW to 1e-2 of its largest entry, dX
    the same but in at most MLP_FLIPPED of the rows (a ReLU that flips
    between two f32 sums in another order moves its row's whole term)."""
    import torch

    from ngp_tpu_torch.ops.kernels import launch_counts

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def chain_grads(x, ws, g):
        y = fm.mlp_chain(x, ws, bf16)
        return torch.autograd.grad(y, [x, *ws], g)

    for rows, dims in MLP_CELLS:
        label = f"{rows} x {'-'.join(map(str, dims))}"
        x = torch.randn((rows, dims[0]), generator=gen, device=dev).to(bf16)
        ws = [torch.randn((a, b), generator=gen, device=dev) * (2.0 / a) ** 0.5
              for a, b in zip(dims, dims[1:])]
        g_dense = torch.randn((rows, dims[-1]), generator=gen, device=dev).to(bf16)
        live = (torch.arange(rows, device=dev) % 256 < MLP_LIVE)[:, None]
        g_march = g_dense * live
        params = sum(a * b for a, b in zip(dims, dims[1:]))
        w_bytes = 4 * params
        # forward
        before = launch_counts()
        y = fm.mlp_bf16_fwd(x, ws)
        counts = launch_counts()
        if counts["fused_mlp_tc"] != before["fused_mlp_tc"] + 1:
            raise RuntimeError(f"mlp_bf16_fwd {label}: missed the tensor cores")
        y_ref = fm.mlp_bf16_plain(x, ws)
        steps = bf16_steps(y, y_ref)
        off = (y.float() - y_ref.float()).abs() - mlp_fwd_slack(fm, x, ws)
        if y.dtype != bf16 or not torch.isfinite(y.float()).all() or float(off.max()) > 0:
            raise RuntimeError(f"mlp_bf16_fwd {label}: {float(off.max())} past its slack")
        print(f"mlp_bf16_fwd {label}: of {y.numel()} outputs {int((steps > 0).sum())} one bf16 "
              f"step or more off the plain version, {int((steps > 1).sum())} more than one, "
              f"largest {float(steps.max()):.1f} steps; all within mlp_fwd_slack  [{card}]",
              flush=True)
        fwd_bound = bound(nbytes(x, y) + w_bytes, 2.0 * rows * params)
        p1 = device_ms(lambda: fm.mlp_bf16_plain(x, ws))
        k1 = device_ms(lambda: fm.mlp_bf16_fwd(x, ws))
        k2 = device_ms(lambda: fm.mlp_bf16_fwd(x, ws))
        p2 = device_ms(lambda: fm.mlp_bf16_plain(x, ws))
        results[("mlp_bf16_fwd", label)] = (float((y.float() - y_ref.float()).abs().max()),
                                            (k1 + k2) / 2, (p1 + p2) / 2, fwd_bound)
        # today's path: MLP.forward's chain of f32 products and casts, with
        # its graph kept as in training
        xr, wr = x.detach().requires_grad_(), [w.detach().requires_grad_() for w in ws]
        library[("mlp_bf16_fwd", label)] = (device_ms(lambda: fm.mlp_chain(xr, wr, bf16))
                                            + device_ms(lambda: fm.mlp_chain(xr, wr, bf16))) / 2
        y_chain = fm.mlp_chain(xr, wr, bf16)
        # backward
        for kind, g in (("march", g_march), ("dense", g_dense)):
            before = launch_counts()["fused_mlp_bwd"]
            dx, dw = fm.mlp_bf16_bwd(x, ws, g)
            if launch_counts()["fused_mlp_bwd"] != before + 1:
                raise RuntimeError(f"mlp_bf16_bwd {label}: not launched")
            dx_ref, dw_ref = fm.mlp_bf16_bwd_plain(x, ws, g)
            errs = [float((a.float() - b.float()).abs().max()) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip([dx, *dw], [dx_ref, *dw_ref])]
            dx_steps = bf16_steps(dx, dx_ref)
            flipped = mlp_flipped_rows(dx, dx_ref)
            print(f"mlp_bf16_bwd {label} {kind}: dX {int((dx_steps > 1).sum())} of {dx.numel()} "
                  f"more than one bf16 step off, largest {float(dx_steps.max()):.1f}; rows of dX "
                  f"more than 1e-2 of its largest entry off {flipped} of {rows}; worst of largest "
                  f"entry dX {errs[0]:.2e}, dW {', '.join(f'{e:.2e}' for e in errs[1:])}"
                  f"  [{card}]", flush=True)
            if not (all(e <= 1e-2 for e in errs[1:]) and flipped <= MLP_FLIPPED * rows):
                raise RuntimeError(f"mlp_bf16_bwd {label} {kind}: {errs} of the largest entries, "
                                   f"{flipped} rows of dX off")
            n_live = rows if kind == "dense" else int(live.sum())
            bwd_bound = bound(nbytes(x, g, dx) + 2 * w_bytes, 2.0 * 3 * n_live * params)
            k1 = device_ms(lambda: fm.mlp_bf16_bwd(x, ws, g))
            p1 = device_ms(lambda: fm.mlp_bf16_bwd_plain(x, ws, g))
            k2 = device_ms(lambda: fm.mlp_bf16_bwd(x, ws, g))
            p2 = device_ms(lambda: fm.mlp_bf16_bwd_plain(x, ws, g))
            results[("mlp_bf16_bwd", f"{label} {kind}")] = (max(errs), (k1 + k2) / 2,
                                                            (p1 + p2) / 2, bwd_bound)
            # the backward alone, and forward and backward, against today's
            # chain (autograd of MLP.forward's f32 products and casts)
            library[("mlp_bf16_bwd", f"{label} {kind}")] = sum(
                device_ms(lambda: torch.autograd.grad(y_chain, [xr, *wr], g, retain_graph=True))
                for _ in range(2)) / 2
            c1 = device_ms(lambda: chain_grads(xr, wr, g))
            c2 = device_ms(lambda: chain_grads(xr, wr, g))
            key = ("FusedMLP fwd+bwd", f"{label} {kind}")
            fwd = results[("mlp_bf16_fwd", label)]
            bwd = results[("mlp_bf16_bwd", f"{label} {kind}")]
            results[key] = (max(errs), fwd[1] + bwd[1], fwd[2] + bwd[2],
                            bound(nbytes(x, y, g, dx) + 3 * w_bytes,
                                  2.0 * rows * params + 2.0 * 3 * n_live * params))
            library[key] = (c1 + c2) / 2
            print(f"MLP {label} {kind}: forward {fwd[1]:.4f} ms (plain {fwd[2]:.4f}, bound "
                  f"{fwd_bound[0]:.4f} by {fwd_bound[1]}), backward {bwd[1]:.4f} ms (plain "
                  f"{bwd[2]:.4f}, bound {bwd_bound[0]:.4f} by {bwd_bound[1]}); forward + "
                  f"backward {results[key][1]:.4f} ms, today's cuBLAS chain {library[key]:.4f} "
                  f"ms, bound {results[key][3][0]:.4f}  [{card}]", flush=True)


def f32_eval_run(dev, card, nc, rc, results):
    """Phase 3b, the f32 heads' API path: the turbo-hq network of phase 2
    built with ``use_bf16=False`` (random weights from SEED), 16 full grid
    refreshes (the density head on 131,072-row chunks) and one 800x800
    frame through ``GridNeRFTrainer.render_frame`` (the radiance head),
    both heads on their 3xTF32 route; the radiance kernel held against its
    plain version on the frame's first radiance chunk's own inputs.
    Returns the path's launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops import cpgrid
    from ngp_tpu_torch.ops.kernels import cp, launch_counts, reset_launch_counts
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

    nc32 = dataclasses.replace(nc, use_bf16=False)
    model = NeRFNetwork(nc32, rc, torch.Generator().manual_seed(SEED)).to(dev)
    trainer = GridNeRFTrainer(model, rc, seed=SEED)
    caught, head = [], cpgrid.cp_sigma_rgb

    def catching(x, d, *rest):
        if not caught:
            caught.append((x.clone(), d.clone(), *rest))
        return head(x, d, *rest)

    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(16):
        trainer._update_occupancy()
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t0
    cpgrid.cp_sigma_rgb = catching
    try:
        t0 = time.perf_counter()
        img, _ = trainer.render_frame(orbit_pose(0.7), intrinsics(FRAME), FRAME, FRAME)
        torch.cuda.synchronize()
        t_frame = time.perf_counter() - t0
    finally:
        cpgrid.cp_sigma_rgb = head
    counts = launch_counts()
    check_launched("f32 eval", counts, ("cp_density_fwd_tf32x3", "cp_sigma_rgb_tf32x3",
                                        "march_turbo", "ray_prepass"),
                   absent=("cp_density_fwd_tc", "cp_sigma_rgb_tc", "coarse_lookup_bits"))
    if img.shape != (FRAME, FRAME, 3) or not np.isfinite(img).all():
        raise RuntimeError("f32 eval: the frame is not a finite 800x800x3 image")
    x, d, factors, w1, w2, color, res, fd, sh = caught[0]
    # the heads read the parameters themselves (an f32 cast is no copy)
    factors, color = tuple(f.detach() for f in factors), tuple(w.detach() for w in color)
    w1, w2 = w1.detach(), w2.detach()
    results[("cp_sigma_rgb", "float32 API frame chunk 0")] = compare(
        "cp_sigma_rgb", lambda: cp.cp_sigma_rgb(x, d, factors, w1, w2, color, res, fd, sh),
        lambda: cp.cp_sigma_rgb_plain(x, d, factors, w1, w2, color, res, fd, sh), "float32",
        sigma_rgb_work(x, d, factors, w1, w2, color))
    st = trainer.last_render_stats
    print(f"f32 eval: 16 full refreshes {t_refresh:.3f} s, one {FRAME}x{FRAME} frame "
          f"{t_frame * 1e3:.1f} ms (n_samples {st['n_samples']:.0f}), its first radiance "
          f"chunk {x.shape[0]} rows  [{card}]", flush=True)
    return counts


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_runs(dev, card, rc, nc, train_ds, val_ds, results):
    """Phase 18: ``ngp_tpu_torch/parallel/`` on one rank over NCCL. The
    turbo-hq trainer from one seed with no mesh, under ``make_mesh(1)`` (the
    data axis) and under a (1, 1) ("data", "model") mesh with the banks
    split by ``shard_params`` (the feature gather's path, at one rank):
    PARALLEL_STEPS steps each, the losses in lockstep with no mesh's, steps
    1-15 timed and PARALLEL_PROFILED profiled; then the 800x800 frame under
    each mesh against the same trainer's frame with no mesh (the fused
    head), ``evaluate``'s PSNR through ``eval_metrics_dp``, and the two
    collectives against one-device torch. Under a mesh the fused heads step
    aside: ``cp_encode_fwd`` and ``cp_bwd_banks`` carry the CP work, and
    each is held against its plain version on the (1, 1) mesh's last
    step's own inputs (the split banks). Returns (the train launch
    counts, the frame launch counts)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ngp_tpu_torch.config import TrainConfig
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops.kernels import cp, launch_counts, reset_launch_counts
    from ngp_tpu_torch.parallel import eval_metrics_dp, gather_predictions_dp, make_mesh
    from ngp_tpu_torch.parallel.mesh import shard_params
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

    fused = ("cp_density_fwd", "cp_density_fwd_tc", "cp_density_fwd_residuals",
             "cp_density_fwd_tf32x3", "cp_sigma_rgb", "cp_sigma_rgb_tc", "cp_sigma_rgb_tf32x3")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        data_mesh = make_mesh(1)
        if make_mesh(1, model_parallel=1).mesh_dim_names != ("data",):
            raise RuntimeError("make_mesh(1, model_parallel=1) is not a data mesh")
        split_mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        train_counts = {}
        runs = {}
        with tempfile.TemporaryDirectory() as ws:
            for label, mesh in (("no mesh", None), ("data", data_mesh),
                                ("data x model", split_mesh)):
                model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(SEED), device=dev)
                if label == "data x model":
                    if shard_params(model, mesh) != {f"encoder.factors_{r}"
                                                    for r in nc.cp_resolutions}:
                        raise RuntimeError("shard_params did not split the CP banks")
                tc = TrainConfig(iters=30000, lr=1e-2, num_rays=TRAIN_RAYS,
                                 update_extra_interval=16, workspace=os.path.join(ws, label))
                trainer = GridNeRFTrainer(model, rc, tc, seed=SEED)
                trainer.mesh = mesh
                trainer.mark_untrained(train_ds.poses, train_ds.intrinsics, train_ds.H,
                                       train_ds.W)
                epoch_iter = trainer.make_loader(train_ds)
                batches = itertools.chain.from_iterable(epoch_iter() for _ in itertools.count())
                # the last train call's inputs of the CP encoder and its
                # backward (a step's TRAIN_ROWS rows; the refresh's chunks
                # are larger)
                seen, launch = {}, (cp.cp_encode_fwd, cp.cp_bwd_banks)

                def clone(a):
                    if torch.is_tensor(a):
                        return a.clone()
                    return tuple(map(clone, a)) if isinstance(a, (tuple, list)) else a

                def keep(name, fn):
                    def call(pos, *args):
                        if pos.shape[0] == TRAIN_ROWS:
                            seen[name] = clone((pos, *args))
                        return fn(pos, *args)
                    return call

                if label == "data x model":
                    cp.cp_encode_fwd = keep("cp_encode_fwd", launch[0])
                    cp.cp_bwd_banks = keep("cp_bwd_banks", launch[1])
                torch.cuda.synchronize()
                reset_launch_counts()
                try:
                    losses = [trainer.step(next(batches))["loss"]]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    losses += [trainer.step(next(batches))["loss"] for _ in range(15)]
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    losses += [trainer.step(next(batches))["loss"]
                               for _ in range(PARALLEL_STEPS - 16)]
                finally:
                    cp.cp_encode_fwd, cp.cp_bwd_banks = launch
                counts = launch_counts()
                if label == "data x model":
                    if sorted(seen) != ["cp_bwd_banks", "cp_encode_fwd"]:
                        raise RuntimeError(f"parallel train ({label}): caught {sorted(seen)}")
                    pos, fa, res, od = seen["cp_encode_fwd"]
                    M, nbR = pos.shape[0], len(fa) * fa[0].shape[-1]
                    step_label = f"18 (1, 1) mesh step {PARALLEL_STEPS - 1}"
                    results[("cp_encode_fwd", step_label)] = compare(
                        "cp_encode_fwd", lambda: cp.cp_encode_fwd(pos, fa, res, od),
                        lambda: cp.cp_encode_plain(pos, fa, res, od), str(od).split(".")[1],
                        (nbytes(pos, *fa) + M * nbR * od.itemsize, 0, 14 * M * nbR))
                    step_factor_gradient(*seen["cp_bwd_banks"], step_label, card, results)
                    del seen
                if mesh is not None:
                    check_launched(f"parallel train ({label})", counts,
                                   ("cp_encode_fwd", "cp_bwd_banks", "march_turbo"),
                                   absent=fused + ("coarse_lookup_bits",))
                    train_counts = {k: train_counts.get(k, 0) + v for k, v in counts.items()}
                losses = torch.stack(losses).cpu().numpy()
                if not np.isfinite(losses).all():
                    raise RuntimeError(f"parallel train ({label}): non-finite loss")
                print(f"parallel train ({label}): {15 * TRAIN_RAYS / dt:.0f} rays/s over steps "
                      f"1-15 ({dt * 1e3 / 15:.2f} ms a step); losses {losses[0]:.6f} -> "
                      f"{losses[-1]:.6f}  [{card}]", flush=True)
                runs[label] = (trainer, losses, 15 * TRAIN_RAYS / dt, batches)
            ref = runs["no mesh"][1]
            for label in ("data", "data x model"):
                gap = np.abs(runs[label][1] - ref)
                if not (gap <= PARALLEL_LOSS_TOL[0] + PARALLEL_LOSS_TOL[1] * np.abs(ref)).all():
                    raise RuntimeError(f"parallel train ({label}): losses {runs[label][1]} not "
                                       f"in lockstep with no mesh's {ref}")
                print(f"parallel train ({label}): {PARALLEL_STEPS} losses within "
                      f"{float((gap / np.abs(ref)).max()):.2e} of no mesh's (relative)", flush=True)

            # the frames: the data mesh trainer's 800x800 frame with no mesh
            # (the fused head) against each mesh trainer's under its mesh
            pose, intr = orbit_pose(0.7), intrinsics(FRAME)
            trainer = runs["data"][0]
            trainer.mesh = None
            t0 = time.perf_counter()
            base, _ = trainer.render_frame(pose, intr, FRAME, FRAME)
            fused_ms = (time.perf_counter() - t0) * 1e3
            trainer.mesh = data_mesh
            frame_counts = {}
            for label in ("data", "data x model"):
                trainer = runs[label][0]
                trainer.render_frame(pose, intr, FRAME, FRAME)  # sticky chunk counts settle
                reset_launch_counts()
                t0 = time.perf_counter()
                img, _ = trainer.render_frame(pose, intr, FRAME, FRAME)
                mesh_ms = (time.perf_counter() - t0) * 1e3
                counts = launch_counts()
                check_launched(f"parallel frame ({label})", counts,
                               ("cp_encode_fwd", "march_turbo", "ray_prepass"),
                               absent=fused + ("coarse_lookup_bits",))
                frame_counts = {k: frame_counts.get(k, 0) + v for k, v in counts.items()}
                diff = float(np.abs(img - base).mean())
                print(f"parallel frame ({label}): {FRAME}x{FRAME} {mesh_ms:.1f} ms under the mesh "
                      f"(no mesh, fused head: {fused_ms:.1f} ms); mean |mesh - no mesh| "
                      f"{diff:.3e}, max {float(np.abs(img - base).max()):.3e}  [{card}]",
                      flush=True)
                if img.shape != (FRAME, FRAME, 3) or not np.isfinite(img).all() or diff > FRAME_TOL:
                    raise RuntimeError(f"parallel frame ({label}): differs by {diff}")
                # the collectives against one-device torch on the frame's pixels
                p = torch.as_tensor(img.reshape(-1, 3), device=dev)
                g = torch.as_tensor(base.reshape(-1, 3), device=dev)
                m = eval_metrics_dp(trainer.mesh, p, g)
                mse = torch.mean((p - g) ** 2)
                if abs(float(m["mse"]) - float(mse)) > 1e-6 * float(mse) + 1e-12:
                    raise RuntimeError(f"eval_metrics_dp: {float(m['mse'])} against {float(mse)}")
                if not torch.equal(gather_predictions_dp(trainer.mesh, p), p):
                    raise RuntimeError("gather_predictions_dp changed the rows")
            # evaluate under the data mesh scores through eval_metrics_dp
            trainer = runs["data"][0]
            ev = trainer.evaluate(val_ds)
            img, _ = trainer.render_frame(val_ds.poses[0], val_ds.intrinsics, val_ds.H, val_ds.W)
            gt = val_ds.images[0]
            gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
            psnr = -10.0 * math.log10(float(np.mean((img - gt) ** 2)))
            print(f"parallel evaluate (data): PSNR {ev['psnr']:.4f} dB through eval_metrics_dp, "
                  f"the frame's {psnr:.4f}  [{card}]", flush=True)
            if abs(ev["psnr"] - psnr) > EVAL_PSNR_TOL:
                raise RuntimeError(f"parallel evaluate: PSNR {ev['psnr']} against {psnr}")
            # last, under the profiler (no timed window follows one)
            dev_ms = {}
            for label, (trainer, _, _, batches) in runs.items():
                print(f"parallel profile ({label}):")
                dev_ms[label] = profile(lambda: trainer.step(next(batches)), PARALLEL_PROFILED,
                                        "step", card, focus=("cp_encode", "cp_bwd", "cp_density",
                                                             "nccl"))[0]
            print("parallel train: rays/s " + ", ".join(
                f"{k} {v[2]:.0f}" for k, v in runs.items()) + "; device ms a step " + ", ".join(
                f"{k} {v:.3f}" for k, v in dev_ms.items()) + f"  [{card}]", flush=True)
    finally:
        dist.destroy_process_group()
    return train_counts, frame_counts


@contextlib.contextmanager
def cli_recorder(dev, card):
    """Run ``ngp_tpu_torch.main_nerf`` in this process and see what it does:
    yields (seen, run). ``run(argv, label)`` clears ``seen``, resets the
    launch counts, runs ``main(argv)`` on the card (``main_nerf``'s, or
    another NeRF-family CLI's given as ``main``) and returns (trainer,
    launch counts, seconds, the loss readings). ``seen`` then holds each
    epoch's wall time (its last step's loss read to the host ends it),
    evaluate's results and wall times, test's wall time, the guidance
    steps' losses, the step a checkpoint load resumed at, the calls of
    the background-frame pass, every train step's loss (a device
    scalar) and the inputs of the last eval prepass (``keep_prepasses``);
    ``NeRFTrainer``'s methods are wrapped at class level for it and
    restored after."""
    import numpy as np
    import torch

    from ngp_tpu_torch import main_nerf
    from ngp_tpu_torch.models import occupancy
    from ngp_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ngp_tpu_torch.training.nerf import NeRFTrainer

    seen = {"epochs": [], "evaluate": [], "results": [], "evaluate_s": [], "test_s": [],
            "guidance": [], "loaded": [], "bg_frames": [], "step_losses": [], "prepass": []}
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

    def run(argv, label, main=main_nerf.main):
        for v in seen.values():
            v.clear()
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer = main(argv, device=dev)
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
    restore_prepass = keep_prepasses(occupancy, seen["prepass"], 1)
    try:
        yield seen, run
    finally:
        restore_prepass()
        for k in names:
            setattr(NeRFTrainer, k, original[k])


def cli_runs(dev, card, scene, api_rays_s, work, results):
    """Phase 11: ``ngp_tpu_torch.main_nerf`` on the scene on disk, as a user
    runs it. (a) turbo-hq through ``main`` in this process, (b) the same
    command one epoch longer, resuming from ``--ckpt latest``, (c) ``--test``
    as a subprocess on the checkpoint (b) wrote, whose PSNR must equal
    (b)'s ``evaluate`` (both start from a fresh trainer: the eval's sticky
    chunk counts and spans, which (a)'s validation frames raised, are then
    the same), (d) the hash grid with the TV and distortion losses, (e)
    the random-pose guidance steps. The prepass kernel is held against its
    plain version on (a)'s last test frame (``results``). The workspaces go
    under ``work`` (``work/cli/ws`` is (a)'s, which phase 17 serves).
    Returns the launch
    counts of (a), (b), (d) and (e), (a)'s rays/s over its middle epochs and
    its test PSNR."""
    import numpy as np
    import torch

    from ngp_tpu_torch.utils.png import read_png

    n_train, n_val, n_test = CLI_FRAMES
    tmp = os.path.join(work, "cli")
    with cli_recorder(dev, card) as (seen, run):
        # (a) turbo-hq, 51 epochs, one validation, evaluate, test, mesh
        ws = os.path.join(tmp, "ws")
        argv = [scene, "-O", "--workspace", ws, "--iters", str(CLI_ITERS), "--save_mesh"]
        trainer, a_counts, a_dt, losses = run(argv, "(a) -O")
        check_launched("CLI (a) -O", a_counts,
                       ("cp_density_fwd", "cp_bwd_banks", "march_turbo", "cp_sigma_rgb",
                        "ray_prepass", "cp_encode_fwd"), absent=("coarse_lookup_bits",))
        # the prepass of (a)'s last test frame (bound 2: two cascades)
        compare_prepass("11 (a) test frame, bound 2", *seen["prepass"][-1], card, results)
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


def white_psnr(scene, split, downscale=1, frames=None):
    """The mean PSNR of a constant white frame on a split's first frames."""
    import numpy as np

    from ngp_tpu_torch.data.nerf_dataset import NeRFDataset

    ds = NeRFDataset(scene, split=split, downscale=downscale)
    gt = ds.images[:frames, ..., :3] * ds.images[:frames, ..., 3:] + (
        1.0 - ds.images[:frames, ..., 3:])
    return float(np.mean([-10.0 * math.log10(float(np.mean((1.0 - f) ** 2))) for f in gt]))


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
    --bg_radius``, the v1 march with the background net; (e) (c) in f32
    (no ``--fp16``, the JAX CLI's default type): the loss falls, the
    density head on its 3xTF32 route, held against its plain version at
    the step's row count on the trained weights. Returns the
    launch counts of (a)-(e)."""
    import numpy as np
    import torch

    from ngp_tpu_torch import main_nerf
    from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
    from ngp_tpu_torch.ops.kernels import cp
    from ngp_tpu_torch.ops.kernels import hashgrid as hk
    from ngp_tpu_torch.ops.kernels import scatter as sk

    n_train, n_val, n_test = CLI_FRAMES
    white = white_psnr(scene, "test", 1)
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
                        "cp_bwd_banks", "march_turbo", "cp_sigma_rgb", "ray_prepass"),
                       absent=("coarse_lookup_bits",))
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
        white_a = white_psnr(scene, "test", CLI_BG_DOWNSCALE)
        white_v = white_psnr(scene, "train", CLI_BG_DOWNSCALE, CLI_BG_VIEWS)
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
                       absent=("march_turbo", "coarse_lookup_bits", "ray_prepass",
                               "cp_density_fwd"))
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
        nbR = len(res) * m.cfg.cp_rank
        del trainer, m
        results[("cp_density_fwd+residuals", f"bfloat16 {rows} rows of 12(c)")] = compare(
            "cp_density_fwd+residuals",
            lambda: cp.cp_density_fwd(pos, fa, a1, a2, res, fd, residuals=True),
            lambda: cp.cp_density_plain(pos, fa, a1, a2, res, fd, residuals=True), "bfloat16",
            density_work(pos, fa, a1, a2, residuals=True),
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
             "--iters", str(CLI_V1_BG_ITERS)] + bg, "12(d) -O --encoding hashgrid --bg_radius")
        counts.append(d_counts)
        check_launched("CLI 12(d) hashgrid --bg_radius", d_counts,
                       ("grid_encode_fwd", "grid_encode_bwd", "grid_encode_fwd_2d",
                        "grid_encode_bwd_2d"), absent=("march_turbo",))
        means = losses_fall("(d)")
        print(f"CLI 12(d): test split PSNR {seen['results'][-1]['psnr']:.4f} dB, loss "
              f"{means[0]:.6f} -> {means[-1]:.6f}, {len(seen['bg_frames'])} background-frame "
              f"passes (no prepass on the v1 march)  [{card}]", flush=True)
        del trainer

        # (e) as (c) in f32, the JAX CLI's default type: the density head on
        # its 3xTF32 route
        seen_rows.clear()
        cp.cp_bwd_banks = counting_bwd
        try:
            trainer, e_counts, e_dt, _ = run(
                [scene, "--encoding", "cpgrid", "--workspace", os.path.join(tmp, "ws_cp32"),
                 "--iters", str(CLI_CP_ITERS)] + CLI_TURBO_HQ,
                "12(e) no -O --encoding cpgrid (f32)")
        finally:
            cp.cp_bwd_banks = bwd
        counts.append(e_counts)
        check_launched("CLI 12(e) cpgrid f32", e_counts,
                       ("cp_density_fwd", "cp_density_fwd_residuals", "cp_density_fwd_tf32x3",
                        "cp_bwd_banks"),
                       absent=("march_turbo", "grid_encode_fwd", "cp_density_fwd_tc"))
        means = losses_fall("(e)")
        rays_s, ms = timed_epochs(seen, trainer)
        rows = max(seen_rows)
        print(f"CLI 12(e): {e_dt:.3f} s wall for {CLI_CP_ITERS} iterations; {rays_s:.0f} rays/s, "
              f"{ms:.2f} ms a step; the density head's rows a step {rows}; test split PSNR "
              f"{seen['results'][-1]['psnr']:.4f} dB; epoch-mean loss {means[0]:.6f} -> "
              f"{means[-1]:.6f}  [{card}]", flush=True)
        # the density head with residuals at that row count, on the trained weights
        m = trainer.model
        if m.compute_dtype is not None:
            raise RuntimeError(f"CLI 12(e): the network computes in {m.compute_dtype}, not f32")
        res, fd = tuple(m.cfg.cp_resolutions), m.cfg.cp_freq_degree
        fa = tuple(f.detach().contiguous() for f in m.encoder.factors)
        a1, a2 = (w.detach().contiguous() for w in m.sigma_net.weights)
        pos = torch.rand((rows, 3), generator=gen, device=dev) * 1.1 - 0.05
        del trainer, m
        results[("cp_density_fwd+residuals", f"float32 {rows} rows of 12(e)")] = compare(
            "cp_density_fwd+residuals",
            lambda: cp.cp_density_fwd(pos, fa, a1, a2, res, fd, residuals=True),
            lambda: cp.cp_density_plain(pos, fa, a1, a2, res, fd, residuals=True), "float32",
            density_work(pos, fa, a1, a2, residuals=True))
        del pos, fa
    return counts


@contextlib.contextmanager
def patched(*swaps):
    """Set (object, attribute, value) for the body of the ``with`` block
    and put the old values back after it."""
    old = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    for obj, name, value in swaps:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in old:
            setattr(obj, name, value)


def sdf_runs(dev, card, results):
    """Phase 13: ``ngp_tpu_torch.main_sdf sphere`` in this process, at the
    CLI's widths (262,144 points a batch, 100 batches an epoch, a 256^3
    mesh). (a) ``--epochs 2``: the validation MAPE falls, the mesh's median
    vertex radius is the normalised sphere's, points/s on the host clock,
    the host's sampling and label time a batch, one profiled step, and the
    grid kernels on the last step's own points against their plain
    versions (f32); (b) ``--test`` on (a)'s workspace writes the same mesh;
    (c) ``--fp16 --epochs 1``: the MAPE falls, the grid kernels on its
    last step's points (bf16). Returns the launch counts of (a)-(c)."""
    import numpy as np
    import torch

    from ngp_tpu_torch import main_sdf, native
    from ngp_tpu_torch.data import sdf_dataset
    from ngp_tpu_torch.data.mesh import icosphere, load_mesh
    from ngp_tpu_torch.ops.kernels import hashgrid as hk
    from ngp_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from ngp_tpu_torch.ops.kernels import scatter as sk
    from ngp_tpu_torch.training.sdf import SDFTrainer

    seen = {"valid": [], "epochs": [], "sample_s": [], "label_s": []}
    train, epoch = SDFTrainer.train, SDFTrainer.train_one_epoch
    sample, label = sdf_dataset.SDFDataset.sample_batch, native.MeshSDF.__call__

    def train_w(self, train_loader, valid_loader=None, max_epochs=1):
        seen["valid"].append(self.evaluate_one_epoch(valid_loader))
        train(self, train_loader, valid_loader, max_epochs)
        seen["valid"].append(self.evaluate_one_epoch(valid_loader))

    def epoch_w(self, loader):
        t0 = time.perf_counter()
        epoch(self, loader)  # its last loss read to the host ends it
        seen["epochs"].append(time.perf_counter() - t0)

    def timed(fn, key):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            seen[key].append(time.perf_counter() - t0)
            return out
        return wrapped

    def run(argv, what, last):
        for v in seen.values():
            v.clear()
        reset_launch_counts()
        t0 = time.perf_counter()
        with grid_inputs(lambda n, D: f"SDF {what} step {last}" if n == last else None) as caught:
            trainer = main_sdf.main(argv, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        check_launched(f"SDF {what}", counts, ("grid_encode_fwd",) + (
            ("grid_encode_bwd",) if last is not None else ()),
            absent=("march_turbo", "cp_density_fwd", "grid_encode_fwd_2d"))
        valid = list(seen["valid"])
        print(f"SDF {what}: {dt:.3f} s, global step {trainer.global_step}, validation MAPE "
              f"{np.round(valid, 6).tolist()}  [{card}]", flush=True)
        if last is not None and not (len(valid) == 2 and valid[1] < valid[0]):
            raise RuntimeError(f"SDF {what}: the validation MAPE did not fall: {valid}")
        return trainer, counts, caught

    def radius(path):
        v, f = load_mesh(path)
        if len(v) == 0 or len(f) == 0:
            raise RuntimeError(f"SDF mesh {path}: {len(v)} vertices, {len(f)} faces")
        return v, float(np.median(np.linalg.norm(v, axis=-1)))

    swaps = ((SDFTrainer, "train", train_w), (SDFTrainer, "train_one_epoch", epoch_w),
             (sdf_dataset.SDFDataset, "sample_batch", timed(sample, "sample_s")),
             (native.MeshSDF, "__call__", timed(label, "label_s")))
    counts = []
    with tempfile.TemporaryDirectory() as tmp, patched(*swaps):
        # (a) the default run
        ws = os.path.join(tmp, "ws")
        argv = ["sphere", "--workspace", ws, "--epochs", str(SDF_EPOCHS)]
        last = 100 * SDF_EPOCHS - 1
        trainer, a_counts, caught = run(argv, "(a)", last)
        counts.append(a_counts)
        n = trainer.global_step
        mesh_a = os.path.join(tmp, "mesh_a.obj")
        os.replace(trainer.last_mesh_path, mesh_a)
        verts_a, r_a = radius(mesh_a)
        epochs = seen["epochs"]
        pts_s = 100 * SDF_POINTS / epochs[-1]
        sample_ms = 1e3 * float(np.mean(seen["sample_s"]))
        label_ms = 1e3 * float(np.mean(seen["label_s"]))
        print(f"SDF (a): {SDF_POINTS} points a step; epochs {np.round(epochs, 3).tolist()} s, "
              f"{pts_s:.0f} points/s in epoch {len(epochs)} (host clock); the host's batch "
              f"{sample_ms:.2f} ms, of which BVH labels of {SDF_POINTS // 2} points {label_ms:.2f} "
              f"ms; mesh {len(verts_a)} vertices, median radius {r_a:.6f} (the sphere's "
              f"{SDF_RADIUS:.6f})  [{card}]", flush=True)
        if n != 100 * SDF_EPOCHS or not abs(r_a - SDF_RADIUS) <= SDF_RADIUS_TOL:
            raise RuntimeError(f"SDF (a): {n} steps, median mesh radius {r_a} (want "
                               f"{SDF_RADIUS} within {SDF_RADIUS_TOL})")
        e = caught[f"SDF (a) step {last}"]
        geom = trainer.model.encoder.cfg.geometry
        table = e["table"].detach()
        table = (table / table.abs().max()).contiguous()
        grid_checks(hk, sk, e["x"], table, geom, torch.float32, e["g"],
                    f"SDF f32 step {last}", results)
        del caught, e, table
        v, f = icosphere(subdiv=5, radius=1.0)
        ds = sdf_dataset.SDFDataset(vertices=v, faces=f, size=1, num_samples=SDF_POINTS,
                                    seed=SEED + 13)
        trainer.step(ds.sample_batch())
        profile(lambda: trainer.step(ds.sample_batch()), 4, "SDF step", card,
                focus=("grid_fwd", "grid_bwd", "gemm", "elementwise"))
        del trainer

        # (b) --test on (a)'s workspace: the same mesh from the checkpoint
        trainer, b_counts, _ = run(argv + ["--test"], "(b) --test", None)
        counts.append(b_counts)
        verts_b, r_b = radius(trainer.last_mesh_path)
        diff = (float(np.abs(verts_b - verts_a).max()) if verts_b.shape == verts_a.shape
                else math.inf)
        print(f"SDF (b): global step {trainer.global_step}, mesh {len(verts_b)} vertices, "
              f"max |vertex - (a)'s| {diff:.3e}  [{card}]", flush=True)
        if trainer.global_step != n or not diff <= 1e-6:
            raise RuntimeError(f"SDF (b): step {trainer.global_step}, the mesh differs from "
                               f"(a)'s by {diff}")
        del trainer

        # (c) bf16
        last = 99
        trainer, c_counts, caught = run(
            ["sphere", "--workspace", os.path.join(tmp, "ws_bf16"), "--fp16", "--epochs", "1"],
            "(c) --fp16", last)
        counts.append(c_counts)
        e = caught[f"SDF (c) --fp16 step {last}"]
        table = e["table"].detach()
        table = (table / table.abs().max()).contiguous()
        grid_checks(hk, sk, e["x"], table, geom, torch.bfloat16, e["g"],
                    f"SDF bf16 step {last}", results)
        del trainer, caught, e, table
    return counts


def tensorf_runs(dev, card, scene, rays_s_11a, results, library):
    """Phase 14: ``ngp_tpu_torch.main_tensoRF`` on phase 11's scene, in this
    process. (a) ``-O --iters 2048`` (51 epochs: the shrink and the first
    upsample at step 2000): the loss falls, the factors end at 152^3 in an
    AABB that shrank inside the box, the test PSNR beats a white frame's
    and ``TENSORF_MIN_PSNR``; rays/s over the middle epochs, one profiled
    step, ``scatter_add_taps`` held against its plain version on every
    call of a step's own taps (``step_taps``), the factor sampling's tap
    forms and the kernel on their points (``tap_forms``),
    ``march_turbo`` held against its plain version on the last step's own
    march inputs and on the test frames' first chunk, and the prepass
    kernel on the last test frame's prepass; (b)
    ``--test`` on (a)'s workspace: a fresh trainer resizes to 152^3 before
    it loads, and its PSNR equals (a)'s; (c) ``--cp --iters 256``: the loss
    falls and the PSNR beats a white frame's; (d) ``--bg_radius 32 --iters
    128``: the loss falls and the background closure runs in training and
    in eval. The runs that train ((a), (c), (d)) must launch
    ``scatter_add_taps``. Returns the launch counts of (a)-(d)."""
    import numpy as np
    import torch

    from ngp_tpu_torch import main_tensoRF
    from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
    from ngp_tpu_torch.models import occupancy
    from ngp_tpu_torch.models.tensorf import TensoRFNetwork
    from ngp_tpu_torch.ops.kernels import scatter as sk

    n_train = CLI_FRAMES[0]
    white = white_psnr(scene, "test")
    box = main_tensoRF.build_parser().parse_args([scene]).bound
    launch, background = occupancy.march_turbo, TensoRFNetwork.background
    kept, bg_calls = {}, {"train": 0, "eval": 0}

    def keep_march(rays_o, rays_d, coarse, fine, cfg, S, K2, U, aabb=None, t_range=None,
                   noise=None):
        label = "TensoRF step" if noise is not None else "TensoRF frame chunk"
        if label == "TensoRF step" or label not in kept:
            def c(t):
                return t.clone() if torch.is_tensor(t) else t
            kept[label] = ((rays_o.clone(), rays_d.clone(), coarse.clone(), fine.clone(), cfg, S,
                            K2, U), dict(aabb=c(aabb), t_range=c(t_range), noise=c(noise)))
        return launch(rays_o, rays_d, coarse, fine, cfg, S, K2, U, aabb=aabb, t_range=t_range,
                      noise=noise)

    def counting_background(self, sph, d):
        bg_calls["train" if torch.is_grad_enabled() else "eval"] += 1
        return background(self, sph, d)

    def epoch_means(seen, label):
        steps = torch.stack(seen["step_losses"]).cpu().numpy()
        means = steps.reshape(-1, n_train).mean(axis=1)
        if not means[-1] < means[0]:
            raise RuntimeError(f"TensoRF {label}: the loss did not fall: epoch means {means}")
        return means

    counts = []
    swaps = ((occupancy, "march_turbo", keep_march),
             (TensoRFNetwork, "background", counting_background))
    with (tempfile.TemporaryDirectory() as tmp, cli_recorder(dev, card) as (seen, run),
          patched(*swaps)):
        # (a) VM, -O, across the shrink and the first upsample
        ws = os.path.join(tmp, "ws")
        argv = [scene, "-O", "--workspace", ws, "--iters", str(TENSORF_ITERS)]
        trainer, a_counts, a_dt, _ = run(argv, "14(a) main_tensoRF -O", main_tensoRF.main)
        counts.append(a_counts)
        check_launched("TensoRF (a) -O", a_counts, ("march_turbo", "ray_prepass",
                                                     "sample_taps_fwd", "scatter_add_taps"),
                       absent=("cp_density_fwd", "cp_sigma_rgb", "grid_encode_fwd",
                               "coarse_lookup_bits", "taps_coords_grad_plain"))
        means = epoch_means(seen, "(a)")
        psnr = seen["results"][-1]["psnr"]
        mid = seen["epochs"][1:-1]
        rays_s = len(mid) * n_train * trainer.train_cfg.num_rays / sum(mid)
        aabb = trainer.aabb
        reso = trainer.current_resolution
        print(f"TensoRF (a): {a_dt:.3f} s wall, {trainer.global_step} steps, {rays_s:.0f} rays/s "
              f"over epochs 2-{len(seen['epochs']) - 1} (phase 11 (a), turbo-hq: "
              f"{rays_s_11a:.0f}); resolution {reso}, aabb {np.round(aabb, 4).tolist()}; test "
              f"PSNR {psnr:.4f} dB (a white frame: {white:.4f}; floor {TENSORF_MIN_PSNR}); "
              f"epoch-mean loss {means[0]:.6f} -> {means[-1]:.6f}  [{card}]", flush=True)
        shrunk = (aabb[:3] >= -box).all() and (aabb[3:] <= box).all() and (
            (aabb[:3] > -box).any() or (aabb[3:] < box).any())
        if reso != (TENSORF_RES,) * 3 or not shrunk or not psnr > max(white, TENSORF_MIN_PSNR):
            raise RuntimeError(f"TensoRF (a): resolution {reso}, aabb {aabb}, test PSNR {psnr}")
        if sorted(kept) != ["TensoRF frame chunk", "TensoRF step"] or not seen["prepass"]:
            raise RuntimeError(f"TensoRF (a): caught {sorted(kept)}, {len(seen['prepass'])} "
                               "prepasses")
        for label in ("TensoRF step", "TensoRF frame chunk"):
            compare_march(label, *kept[label], card, results)
        compare_prepass("TensoRF test frame", *seen["prepass"][-1], card, results)
        kept.clear()
        train_ds = NeRFDataset(scene, split="train", scale=0.33)
        batches = itertools.chain.from_iterable(
            trainer.make_loader(train_ds)() for _ in itertools.count())
        taps, fwd_taps = [], []
        with patched((sk, "scatter_add_taps", keep_taps(sk, taps)),
                     (sk, "sample_taps_fwd", keep_taps_fwd(sk, fwd_taps))):
            trainer.step(next(batches))
        step_taps(sk, taps, "TensoRF step", card, results, library)
        step_taps_fwd(sk, fwd_taps, "TensoRF step", card, results, library)
        profile(lambda: trainer.step(next(batches)), 1, "TensoRF step", card,
                focus=("indexFunc", "indexSelect", "scatter_taps", "sample_taps", "march",
                       "elementwise", "gemm"))
        del trainer, train_ds, batches, taps, fwd_taps
        tap_forms(dev, card, results, library)

        # (b) --test on (a)'s workspace
        trainer, b_counts, _, _ = run(argv + ["--test"], "14(b) --test", main_tensoRF.main)
        counts.append(b_counts)
        check_launched("TensoRF (b) --test", b_counts, ("march_turbo", "ray_prepass",
                                                         "sample_taps_fwd"),
                       absent=("coarse_lookup_bits", "taps_coords_grad_plain"))
        psnr_b = seen["results"][-1]["psnr"]
        print(f"TensoRF (b): resumed step {seen['loaded']}, resolution "
              f"{trainer.current_resolution}, test PSNR {psnr_b:.6f} dB ((a): {psnr:.6f})  "
              f"[{card}]", flush=True)
        if (trainer.current_resolution != reso or not np.allclose(trainer.aabb, aabb)
                or not abs(psnr_b - psnr) <= 0.01):
            raise RuntimeError(f"TensoRF (b): resolution {trainer.current_resolution}, aabb "
                               f"{trainer.aabb}, PSNR {psnr_b} against (a)'s {psnr}")
        del trainer

        # (c) CP
        trainer, c_counts, _, _ = run(
            [scene, "-O", "--cp", "--workspace", os.path.join(tmp, "ws_cp"), "--iters",
             str(TENSORF_CP_ITERS)], "14(c) main_tensoRF -O --cp", main_tensoRF.main)
        counts.append(c_counts)
        check_launched("TensoRF (c) --cp", c_counts, ("march_turbo", "ray_prepass",
                                                      "sample_taps_fwd", "scatter_add_taps"),
                       absent=("coarse_lookup_bits", "taps_coords_grad_plain"))
        means = epoch_means(seen, "(c)")
        psnr_c = seen["results"][-1]["psnr"]
        print(f"TensoRF (c): resolution {trainer.current_resolution}, test PSNR {psnr_c:.4f} dB "
              f"(a white frame: {white:.4f}); epoch-mean loss {means[0]:.6f} -> "
              f"{means[-1]:.6f}  [{card}]", flush=True)
        if not psnr_c > white:
            raise RuntimeError(f"TensoRF (c): test PSNR {psnr_c} not above a white frame's")
        del trainer

        # (d) the background plane and net
        bg_calls.update(train=0, eval=0)
        trainer, d_counts, _, _ = run(
            [scene, "-O", "--bg_radius", str(CLI_BG_RADIUS), "--workspace",
             os.path.join(tmp, "ws_bg"), "--iters", str(TENSORF_BG_ITERS)],
            "14(d) main_tensoRF -O --bg_radius", main_tensoRF.main)
        counts.append(d_counts)
        check_launched("TensoRF (d) --bg_radius", d_counts,
                       ("march_turbo", "sample_taps_fwd", "scatter_add_taps"),
                       absent=("taps_coords_grad_plain",))
        means = epoch_means(seen, "(d)")
        print(f"TensoRF (d): background calls {bg_calls}, {len(seen['bg_frames'])} "
              f"background-frame passes, test PSNR {seen['results'][-1]['psnr']:.4f} dB; "
              f"epoch-mean loss {means[0]:.6f} -> {means[-1]:.6f}  [{card}]", flush=True)
        if not (bg_calls["train"] > 0 and bg_calls["eval"] > 0):
            raise RuntimeError(f"TensoRF (d): background calls {bg_calls}")
        del trainer
    return counts


def bwd_x_checks(hk, x, table, geom, g, label, results, card):
    """``grid_encode_bwd_x`` on points x [B, D] (table, cotangent g) against
    its plain version (autograd of ``grid_encode_plain`` in x): the plain
    version sums the same terms in another order, so 1e-4 of the largest
    entry with an f32 cotangent; with a bf16 one both round each corner's
    <g, row> to bf16, and a rounding that flips moves a term by one bf16
    step, so 1e-2 of the largest entry. Work: x, g and dx once, the corner
    rows' sectors (``table_bytes``); per (point, level) inside [0, 1]^D
    with a non-zero cotangent, 3 D operations of position, then per corner
    2 C of the dot product and D^2 + D of the weights' derivatives."""
    import torch

    D, L, C = geom.input_dim, geom.num_levels, geom.level_dim
    dtype = str(g.dtype).split(".")[-1]
    idx, _ = hk.grid_encode_bwd_rows_plain(x, torch.ones_like(g, dtype=torch.float32), geom)
    live = int(((g.view(-1, L, C) != 0).any(dim=2) & inside_rows(x)[:, None]).sum())
    work = (nbytes(x, g) + 4 * x.numel() + table_bytes(idx, geom), 0,
            live * (3 * D + 2**D * (2 * C + D * D + D)))
    del idx
    scale = BWD_X_TOL[dtype]
    results[("grid_encode_bwd_x", label)] = compare(
        "grid_encode_bwd_x", lambda: hk.grid_encode_bwd_x(x, table, g, geom),
        lambda: hk.grid_encode_bwd_x_plain(x, table, g, geom), dtype, work,
        tol=lambda want: [torch.full_like(want[0], scale * float(want[0].abs().max()))])
    dev_ms = device_ms(lambda: hk.grid_encode_bwd_x(x, table, g, geom))
    print(f"grid_encode_bwd_x [{label}]: device {dev_ms:.4f} ms a launch (queued), "
          f"{results[('grid_encode_bwd_x', label)][1]:.4f} ms between back-to-back calls  "
          f"[{card}]", flush=True)


def random_points(dev, n, D, seed):
    """n points in [0, 1]^D of which about 25% are outside (one coordinate
    past 1)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n, D), generator=gen)
    out = torch.rand(n, generator=gen) < 0.25
    x[out, 0] = 1.01 + 0.2 * x[out, 0]
    return x.contiguous().to(dev)


def ccnerf_runs(dev, card, scene, results, library):
    """Phase 15: ``ngp_tpu_torch.main_CCNeRF`` on phase 11's scene at the
    CLI's widths (res 128^3, K = 5 rank groups to density ranks 64 vec /
    16 mat and colour ranks 64 / 64, SH degree 4, 4096 rays), in this
    process. (a) ``-O --compose --iters CCNERF_ITERS``: the loss falls;
    rays/s over the middle epochs; the finalized full rank and the three
    compression levels' PSNRs beside a white frame's (the full rank above
    ``CCNERF_MIN_PSNR``); ``finalize`` leaves the field unchanged (sigma
    and rgb at 65,536 random points, before and after, within
    ``FINALIZE_TOL``); the composed scene's test frames written; one
    profiled step of the trained rank-residual model, ``scatter_add_taps``
    held against its plain version on every call of a step's own taps
    (``step_taps``; launched on (a)); ``march_turbo`` held
    against its plain version on the last step's own march inputs, and the
    prepass kernel on the last test frame's prepass. (b)
    ``--test`` on (a)'s workspace: the full-rank PSNR equals (a)'s.
    Returns the launch counts of (a) and (b)."""
    import numpy as np
    import torch

    from ngp_tpu_torch import main_CCNeRF
    from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
    from ngp_tpu_torch.models import occupancy
    from ngp_tpu_torch.models.ccnerf import CCNeRF
    from ngp_tpu_torch.ops.kernels import scatter as sk
    from ngp_tpu_torch.training.ccnerf import CCNeRFTrainer

    n_train = CLI_FRAMES[0]
    white = white_psnr(scene, "test", frames=2)
    launch, finalize, step = occupancy.march_turbo, CCNeRF.finalize, CCNeRFTrainer.train_step
    kept, losses, pre = {}, [], {}

    def keep_march(rays_o, rays_d, coarse, fine, cfg, S, K2, U, aabb=None, t_range=None,
                   noise=None):
        if noise is not None:
            kept["CCNeRF step"] = ((rays_o.clone(), rays_d.clone(), coarse.clone(), fine.clone(),
                                    cfg, S, K2, U), dict(aabb=aabb, t_range=t_range,
                                                         noise=noise.clone()))
        return launch(rays_o, rays_d, coarse, fine, cfg, S, K2, U, aabb=aabb, t_range=t_range,
                      noise=noise)

    def keep_finalize(self, params):
        if self.objects is None and not pre:
            pre["cfg"] = self.cfg
            pre["params"] = {k: [{"U": [u.detach().clone() for u in g["U"]],
                                  "S": g["S"].detach().clone()} for g in v]
                             for k, v in params.items()}
        return finalize(self, params)

    def keep_loss(self, *a, **kw):
        out = step(self, *a, **kw)
        losses.append(out["loss"])
        return out

    counts = []
    swaps = ((occupancy, "march_turbo", keep_march), (CCNeRF, "finalize", keep_finalize),
             (CCNeRFTrainer, "train_step", keep_loss))
    with (tempfile.TemporaryDirectory() as tmp, cli_recorder(dev, card) as (seen, run),
          patched(*swaps)):
        ws = os.path.join(tmp, "ws")
        argv = [scene, "-O", "--workspace", ws, "--iters", str(CCNERF_ITERS)]
        trainer, a_counts, a_dt, _ = run(argv + ["--compose"], "15(a) main_CCNeRF -O --compose",
                                         main_CCNeRF.main)
        counts.append(a_counts)
        check_launched("CCNeRF (a) -O", a_counts, ("march_turbo", "ray_prepass",
                                                    "sample_taps_fwd", "scatter_add_taps"),
                       absent=("cp_density_fwd", "cp_sigma_rgb", "grid_encode_fwd",
                               "coarse_lookup_bits", "taps_coords_grad_plain"))
        compare_prepass("CCNeRF test frame", *seen["prepass"][-1], card, results)
        steps = torch.stack(losses).cpu().numpy()
        means = steps.reshape(-1, n_train).mean(axis=1)
        mid = seen["epochs"][1:-1]
        rays_s = len(mid) * n_train * trainer.train_cfg.num_rays / sum(mid)
        psnrs = [r["psnr"] for r in seen["results"]]
        print(f"CCNeRF (a): {a_dt:.3f} s wall, {trainer.global_step} steps, {rays_s:.0f} rays/s "
              f"over epochs 2-{len(seen['epochs']) - 1}; epoch-mean loss {means[0]:.6f} -> "
              f"{means[-1]:.6f}; test PSNR (2 frames) full rank {psnrs[0]:.4f} dB, compressed "
              f"{dict(zip(main_CCNeRF.COMPRESS_RANKS, np.round(psnrs[1:], 4).tolist()))} (a white "
              f"frame: {white:.4f}); compose test {seen['test_s'][-1]:.3f} s  [{card}]",
              flush=True)
        if not (means[-1] < means[0] and len(psnrs) == 4 and psnrs[0] > max(white,
                                                                          CCNERF_MIN_PSNR)):
            raise RuntimeError(f"CCNeRF (a): epoch means {means}, PSNRs {psnrs}")
        if not any(f.startswith("ccnerf_") and f.endswith("_rgb.png")
                   for f in os.listdir(os.path.join(ws, "results"))):
            raise RuntimeError("CCNeRF (a): the composed scene wrote no frames")
        # finalize only sorts and concatenates: the field stays the trained one's
        model0 = CCNeRF(pre["cfg"], bound=trainer.model.bound, device=dev)
        model0.load_params(pre["params"])
        gen = torch.Generator().manual_seed(SEED + 15)
        x = (torch.rand((65536, 3), generator=gen) * 2 - 1).to(dev)
        d = torch.nn.functional.normalize(torch.randn((65536, 3), generator=gen), dim=-1).to(dev)
        with torch.no_grad():
            s0, r0 = model0.sigma_rgb(x, d)
            s1, r1 = trainer.model.sigma_rgb(x, d)
        ds_, dr = float(((s1 - s0).abs() / (1 + s0.abs())).max()), float((r1 - r0).abs().max())
        print(f"CCNeRF finalize: K {pre['cfg'].K} -> {trainer.model.cfg.K}; max |sigma change| / "
              f"(1 + sigma) {ds_:.3e}, max |rgb change| {dr:.3e} at 65,536 points (tolerance "
              f"{FINALIZE_TOL})  [{card}]", flush=True)
        if not (ds_ <= FINALIZE_TOL and dr <= FINALIZE_TOL):
            raise RuntimeError(f"CCNeRF finalize moved the field: {ds_}, {dr}")
        compare_march("CCNeRF step", *kept.pop("CCNeRF step"), card, results)
        # one profiled step of the trained rank-residual model
        pt = CCNeRFTrainer(model0, trainer.render_cfg, trainer.train_cfg, seed=SEED)
        pt.aux = trainer.aux
        batches = itertools.chain.from_iterable(
            pt.make_loader(NeRFDataset(scene, split="train", scale=0.8))()
            for _ in itertools.count())
        taps, fwd_taps = [], []
        with patched((sk, "scatter_add_taps", keep_taps(sk, taps)),
                     (sk, "sample_taps_fwd", keep_taps_fwd(sk, fwd_taps))):
            pt.step(next(batches))
        step_taps(sk, taps, "CCNeRF step", card, results, library)
        step_taps_fwd(sk, fwd_taps, "CCNeRF step", card, results, library)
        profile(lambda: pt.step(next(batches)), 1, "CCNeRF step", card,
                focus=("indexFunc", "indexSelect", "scatter_taps", "sample_taps", "march",
                       "elementwise", "gemm", "reduce"))
        del trainer, pt, model0, batches, pre["params"], taps, fwd_taps

        # (b) --test on (a)'s workspace
        losses.clear()
        trainer, b_counts, _, _ = run(argv + ["--test"], "15(b) --test", main_CCNeRF.main)
        counts.append(b_counts)
        check_launched("CCNeRF (b) --test", b_counts, ("march_turbo", "ray_prepass",
                                                        "sample_taps_fwd"),
                       absent=("coarse_lookup_bits", "taps_coords_grad_plain"))
        psnr_b = seen["results"][0]["psnr"]
        print(f"CCNeRF (b): resumed step {seen['loaded']}, full-rank test PSNR {psnr_b:.6f} dB "
              f"((a): {psnrs[0]:.6f})  [{card}]", flush=True)
        if not abs(psnr_b - psnrs[0]) <= 0.01:
            raise RuntimeError(f"CCNeRF (b): PSNR {psnr_b} against (a)'s {psnrs[0]}")
        del trainer
    return counts


def dnerf_runs(dev, card, results, work, control=False):
    """Phase 16: ``ngp_tpu_torch.main_dnerf`` at the CLI's widths (16 levels
    x 2, 2^19 rows, finest 4096 at bound 2; the deformation MLP 5 x 128;
    T = 64 time slices of a 128^3 grid; 4096 rays; bf16 with ``-O``) on the
    dynamic synthetic scene (``make_synthetic_dataset(dynamic=True)``), in
    this process. (a) ``-O --iters DNERF_ITERS``: the loss falls, the test
    PSNR beats a white frame's and ``DNERF_MIN_PSNR``; rays/s; the refresh
    wall of a full 64-slice sweep and of a quarter; one profiled step; the
    prepass kernel on the prepass of a test frame at time 0.5; the grid
    kernels on the last step's own points (``grid_encode_bwd_x``, D =
    3, the step's bf16 cotangent and in f32; the forward and the table
    gradient) and on random points with 25% outside the box. (b) ``--test``
    on (a)'s workspace: the same PSNR. (c) ``--hyper --iters
    DNERF_SHORT_ITERS`` (as (d), ``DNERF_SHORT_FULL_SWEEPS`` full refreshes
    before the quarters): the 4-D instances (forward, table gradient,
    x-gradient) launched and held against their plain versions on its last
    step's own points and on random 4-D points. (d) ``--basis --iters
    DNERF_SHORT_ITERS``: the loss falls; no x-gradient is launched. With
    ``control`` (``--dnerf-control``), (e): (a) again with the deformation
    net frozen (its output detached: no gradient reaches it, and no
    x-gradient is launched), whose test PSNR must stay below
    ``DNERF_MIN_PSNR``. The scene and workspaces go under ``work/dnerf``
    (``dscene``; (a)'s ``ws``, which phase 17 serves). Returns the launch
    counts of (a)-(d)."""
    import numpy as np
    import torch

    from ngp_tpu_torch import main_dnerf
    from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
    from ngp_tpu_torch.data.synthetic import make_synthetic_dataset
    from ngp_tpu_torch.models.dnerf import DNeRFNetwork
    from ngp_tpu_torch.ops.kernels import hashgrid as hk
    from ngp_tpu_torch.ops.kernels import scatter as sk
    from ngp_tpu_torch.training import dnerf as dnerf_training
    from ngp_tpu_torch.training.dnerf import DNeRFTrainer

    n_train = CLI_FRAMES[0]
    refresh = DNeRFTrainer._update_occupancy
    walls = {}
    schedule = dnerf_training.refresh_slices

    def fewer_full(iter_density, *rest):
        # refreshes past the first DNERF_SHORT_FULL_SWEEPS take JAX's quarters
        return schedule(iter_density if iter_density < DNERF_SHORT_FULL_SWEEPS
                        else max(iter_density, 16), *rest)

    def timed_refresh(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refresh(self)
        torch.cuda.synchronize()
        walls.setdefault(len(self.last_refresh_slices), []).append(time.perf_counter() - t0)

    def epoch_means(seen, label):
        means = torch.stack(seen["step_losses"]).cpu().numpy().reshape(-1, n_train).mean(axis=1)
        if not means[-1] < means[0]:
            raise RuntimeError(f"D-NeRF {label}: the loss did not fall: epoch means {means}")
        return means

    counts = []
    tmp = os.path.join(work, "dnerf")
    with (cli_recorder(dev, card) as (seen, run),
          patched((DNeRFTrainer, "_update_occupancy", timed_refresh))):
        scene = os.path.join(tmp, "dscene")
        t0 = time.perf_counter()
        make_synthetic_dataset(scene, n_train=n_train, n_val=CLI_FRAMES[1],
                               n_test=CLI_FRAMES[2], dynamic=True, device=dev)
        print(f"D-NeRF scene ({sum(CLI_FRAMES)} frames of 400x400, dynamic): "
              f"{time.perf_counter() - t0:.3f} s  [{card}]", flush=True)
        white = white_psnr(scene, "test")

        def go(argv, label, last):
            with grid_inputs(lambda n, D: f"D-NeRF {label} step {last}" if n == last
                             else None) as caught:
                out = run(argv, label, main_dnerf.main)
            return (*out, caught)

        # (a) the deformation net
        ws = os.path.join(tmp, "ws")
        argv = [scene, "-O", "--workspace", ws, "--iters", str(DNERF_ITERS)]
        last = cli_steps(DNERF_ITERS) - 1
        trainer, a_counts, a_dt, _, caught = go(argv, "16(a) main_dnerf -O", last)
        counts.append(a_counts)
        check_launched("D-NeRF (a) -O", a_counts,
                       ("march_turbo", "ray_prepass", "grid_encode_fwd",
                        "grid_encode_bwd", "grid_encode_bwd_x"),
                       absent=("cp_density_fwd", "grid_encode_fwd_4d", "grid_encode_fwd_2d",
                               "coarse_lookup_bits"))
        means = epoch_means(seen, "(a)")
        psnr = seen["results"][-1]["psnr"]
        mid = seen["epochs"][1:-1]
        rays_s = len(mid) * n_train * trainer.train_cfg.num_rays / sum(mid)
        T = trainer.render_cfg.time_size
        full, quarter = walls.get(T, []), walls.get(T // 4, [])
        print(f"D-NeRF (a): {a_dt:.3f} s wall, {trainer.global_step} steps, {rays_s:.0f} rays/s "
              f"over epochs 2-{len(seen['epochs']) - 1} (refreshes included); refresh wall: "
              f"{len(full)} full {T}-slice sweeps, median {np.median(full):.3f} s (first "
              f"{full[0]:.3f}); {len(quarter)} of a quarter ({T // 4} slices), median "
              f"{np.median(quarter) if quarter else float('nan'):.3f} s; test PSNR {psnr:.4f} dB "
              f"(a white frame: {white:.4f}; floor {DNERF_MIN_PSNR}); epoch-mean loss "
              f"{means[0]:.6f} -> {means[-1]:.6f}  [{card}]", flush=True)
        if not (psnr > max(white, DNERF_MIN_PSNR) and len(full) == 16 and quarter):
            raise RuntimeError(f"D-NeRF (a): test PSNR {psnr}, refreshes {sorted(walls)}")
        if control:
            def frozen(self, x, t, deform=DNeRFNetwork.deform):
                with torch.no_grad():
                    return deform(self, x, t)

            with patched((DNeRFNetwork, "deform", frozen)):
                trainer_e, e_counts, e_dt, _, _ = go(
                    [scene, "-O", "--workspace", os.path.join(tmp, "ws_frozen"), "--iters",
                     str(DNERF_ITERS)], "16(e) deformation frozen", None)
            del trainer_e
            check_launched("D-NeRF (e) deformation frozen", e_counts,
                           ("march_turbo", "grid_encode_fwd", "grid_encode_bwd"),
                           absent=("grid_encode_bwd_x",))
            means_e = epoch_means(seen, "(e)")
            psnr_e = seen["results"][-1]["psnr"]
            print(f"D-NeRF (e) the deformation net frozen: {e_dt:.3f} s wall; test PSNR "
                  f"{psnr_e:.4f} dB ((a): {psnr:.4f}; floor {DNERF_MIN_PSNR}; a white frame: "
                  f"{white:.4f}); epoch-mean loss {means_e[0]:.6f} -> {means_e[-1]:.6f} ((a): "
                  f"{means[-1]:.6f})  [{card}]", flush=True)
            if not psnr_e < DNERF_MIN_PSNR:
                raise RuntimeError(f"D-NeRF (e): the frozen deformation's PSNR {psnr_e} passes "
                                   f"the floor {DNERF_MIN_PSNR}")
        e = caught[f"D-NeRF 16(a) main_dnerf -O step {last}"]
        geom = trainer.model.encoder.cfg.geometry
        table = e["table"].detach()
        table = (table / table.abs().max()).contiguous()
        label = f"D=3 bf16 step {last}"
        print(f"D-NeRF (a) step {last}: {e['x'].shape[0]} encoder points, "
              f"{1.0 - float(inside_rows(e['x']).float().mean()):.4f} outside the box, "
              f"{float((e['g'] == 0).all(dim=1).float().mean()):.4f} zero cotangent rows",
              flush=True)
        bwd_x_checks(hk, e["x"], table, geom, e["g"], label, results, card)
        bwd_x_checks(hk, e["x"], table, geom, e["g"].float(), f"D=3 f32 step {last}", results, card)
        grid_checks(hk, sk, e["x"], table, geom, torch.bfloat16, e["g"], label, results)
        xr = random_points(dev, 262144, 3, SEED + 16)
        gr = torch.randn((262144, geom.output_dim), generator=torch.Generator().manual_seed(
            SEED + 17)).to(dev)
        bwd_x_checks(hk, xr, table, geom, gr, "D=3 f32 random", results, card)
        bwd_x_checks(hk, xr, table, geom, gr.bfloat16(), "D=3 bf16 random", results, card)
        del caught, e, xr, gr
        # the prepass of a test frame at time 0.5, on that time's slice
        seen["prepass"].clear()
        test_ds = NeRFDataset(scene, split="test")
        trainer.render_frame(test_ds.poses[0], test_ds.intrinsics, test_ds.H, test_ds.W,
                             time=0.5)
        compare_prepass("D-NeRF test frame at time 0.5", *seen["prepass"][-1], card, results)
        del test_ds
        batches = itertools.chain.from_iterable(
            trainer.make_loader(NeRFDataset(scene, split="train"))() for _ in itertools.count())
        trainer.step(next(batches))
        profile(lambda: trainer.step(next(batches)), 1, "D-NeRF step", card,
                focus=("grid_bwd_x", "grid_fwd", "grid_bwd_kernel", "march", "gemm"))
        del trainer, batches

        # (b) --test on (a)'s workspace
        trainer, b_counts, _, _, _ = go(argv + ["--test"], "16(b) --test", None)
        counts.append(b_counts)
        check_launched("D-NeRF (b) --test", b_counts, ("march_turbo", "ray_prepass"),
                       absent=("coarse_lookup_bits",))
        psnr_b = seen["results"][-1]["psnr"]
        print(f"D-NeRF (b): resumed step {seen['loaded']}, test PSNR {psnr_b:.6f} dB ((a): "
              f"{psnr:.6f})  [{card}]", flush=True)
        if not abs(psnr_b - psnr) <= 0.01:
            raise RuntimeError(f"D-NeRF (b): PSNR {psnr_b} against (a)'s {psnr}")
        del trainer

        # (c) the hyper grid: the 4-D instances
        last = cli_steps(DNERF_SHORT_ITERS) - 1
        with patched((dnerf_training, "refresh_slices", fewer_full)):
            trainer, c_counts, _, _, caught = go(
                [scene, "-O", "--hyper", "--workspace", os.path.join(tmp, "ws_hyper"),
                 "--iters", str(DNERF_SHORT_ITERS)], "16(c) --hyper", last)
        counts.append(c_counts)
        check_launched("D-NeRF (c) --hyper", c_counts,
                       ("march_turbo", "grid_encode_fwd_4d", "grid_encode_bwd_4d",
                        "grid_encode_bwd_x_4d"))
        means = epoch_means(seen, "(c)")
        print(f"D-NeRF (c): test PSNR {seen['results'][-1]['psnr']:.4f} dB; epoch-mean loss "
              f"{means[0]:.6f} -> {means[-1]:.6f}  [{card}]", flush=True)
        e = caught[f"D-NeRF 16(c) --hyper step {last}"]
        geom = trainer.model.encoder.cfg.geometry
        table = e["table"].detach()
        table = (table / table.abs().max()).contiguous()
        label = f"D=4 bf16 step {last}"
        bwd_x_checks(hk, e["x"], table, geom, e["g"], label, results, card)
        bwd_x_checks(hk, e["x"], table, geom, e["g"].float(), f"D=4 f32 step {last}", results, card)
        grid_checks(hk, sk, e["x"], table, geom, torch.bfloat16, e["g"], label, results)
        grid_checks(hk, sk, e["x"], table, geom, torch.float32, e["g"].float(),
                    f"D=4 f32 step {last}", results)
        xr = random_points(dev, 262144, 4, SEED + 18)
        gr = torch.randn((262144, geom.output_dim), generator=torch.Generator().manual_seed(
            SEED + 19)).to(dev)
        grid_checks(hk, sk, xr, table, geom, torch.float32, gr, "D=4 f32 random", results)
        bwd_x_checks(hk, xr, table, geom, gr, "D=4 f32 random", results, card)
        bwd_x_checks(hk, xr, table, geom, gr.bfloat16(), "D=4 bf16 random", results, card)
        del trainer, caught, e, xr, gr, table

        # (d) the temporal basis
        with patched((dnerf_training, "refresh_slices", fewer_full)):
            trainer, d_counts, _, _, _ = go(
                [scene, "-O", "--basis", "--workspace", os.path.join(tmp, "ws_basis"),
                 "--iters", str(DNERF_SHORT_ITERS)], "16(d) --basis", None)
        counts.append(d_counts)
        check_launched("D-NeRF (d) --basis", d_counts, ("march_turbo", "grid_encode_bwd"),
                       absent=("grid_encode_bwd_x", "grid_encode_fwd_4d"))
        means = epoch_means(seen, "(d)")
        print(f"D-NeRF (d): test PSNR {seen['results'][-1]['psnr']:.4f} dB; epoch-mean loss "
              f"{means[0]:.6f} -> {means[-1]:.6f}  [{card}]", flush=True)
        del trainer
    return counts


@contextlib.contextmanager
def served(session, W, H, radius, fovy):
    """What ``viewer_web.serve`` sets up for ``session``: the camera, the
    shared state and a real server, here on a free localhost port and on a
    thread of its own; yields (camera, state, get), ``get(path)`` the body
    of an HTTP GET. The server is shut down and its thread joined after."""
    import threading
    import urllib.request

    from ngp_tpu_torch import viewer_web
    from ngp_tpu_torch.viewer import OrbitCamera

    camera = OrbitCamera(W, H, r=radius, fovy=fovy)
    state = {"frame": None, "stats": {}, "lock": threading.Lock()}
    server = viewer_web.make_server(session, camera, state, W, H, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
            return r.read()

    try:
        yield camera, state, get
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def u8_frame(img):
    """A view as ``serve_step`` publishes it: u8 levels, truncated."""
    import numpy as np

    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def same_view(label, frame, img):
    """The loop's u8 frame against ``render_frame``'s image of the same pose:
    at most one level apart (the compositor adds by f32 atomics)."""
    import numpy as np

    want = u8_frame(img)
    d = np.abs(frame.astype(np.int32) - want.astype(np.int32))
    if frame.shape != want.shape or d.max() > VIEW_LEVELS:
        raise RuntimeError(f"viewer {label}: the view differs from render_frame's by "
                           f"{d.max() if frame.shape == want.shape else frame.shape} levels")
    return float(np.mean(d > 0))


def viewer_runs(dev, card, scene, ws, dscene, dws):
    """Phase 17 (a): ``main_nerf <phase 11's scene> -O --gui`` on 11 (a)'s
    workspace ``ws`` and ``main_dnerf <dscene> -O --gui`` on 16 (a)'s
    ``dws``, each with ``viewer_web.serve`` replaced by ``served`` and
    passes of its loop body (``serve_step``), the HTTP requests a browser
    sends in between. The render budget is raised so that every view is
    at downscale 1 (the adaptive downscale is tested on the CPU). NeRF:
    the checkpoint's step loaded, the page, a train call of 16 steps that
    moves ``global_step``, the view equal to ``render_frame`` of its pose
    (``same_view``), the JPEG and the stats, SPP accumulation on an
    unchanged pose and its reset on an orbit, then training off, the
    ``max_samples`` dial and an aabb crop (xmin at 0.99 of the bound: a
    lighter frame);
    the ms of a train call and of a view. D-NeRF: a train call, training
    off, then a /ctl time scrub to 0.5: SPP resets, the view equals
    ``render_frame(..., time=0.5)`` and differs from the view at 0.
    Returns the launch counts of the two runs."""
    import numpy as np
    import torch

    from ngp_tpu_torch import main_dnerf, main_nerf, viewer_web
    from ngp_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    def timed_pass(session, camera, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        viewer_web.serve_step(session, camera, state)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def drive(label, main, argv, checks):
        def fake_serve(session, W=800, H=800, port=7860, train=True, radius=2.0, fovy=60.0):
            if not train:
                raise RuntimeError(f"viewer {label}: serve called with train=False")
            session.render_budget_ms = 1e9
            with served(session, W, H, radius, fovy) as (camera, state, get):
                if b"ngp_tpu viewer" not in get("/"):
                    raise RuntimeError(f"viewer {label}: no viewer page at /")
                checks(session, camera, state, get)
            served_to.append(session)

        served_to = []
        reset_launch_counts()
        t0 = time.perf_counter()
        with patched((viewer_web, "serve", fake_serve)):
            trainer = main(argv, device=dev)
        torch.cuda.synchronize()
        counts = launch_counts()
        if len(served_to) != 1 or served_to[0].trainer is not trainer:
            raise RuntimeError(f"viewer {label}: serve was not reached with the trainer")
        print(f"viewer {label}: {time.perf_counter() - t0:.3f} s in all  [{card}]", flush=True)
        return counts

    def nerf_checks(session, camera, state, get):
        tr = session.trainer
        step0 = tr.global_step
        if step0 <= 0:
            raise RuntimeError("viewer (nerf): no checkpoint was loaded")
        # pass 1: a train call of 16 steps, then the view at downscale 1
        first_s = timed_pass(session, camera, state)
        stats = json.loads(get("/stats"))
        if not (tr.global_step == step0 + 16 == stats["step"] and math.isfinite(stats["loss"])):
            raise RuntimeError(f"viewer (nerf): step {tr.global_step} after a train call from "
                               f"{step0}, stats {stats}")
        img, _ = tr.render_frame(camera.pose, camera.intrinsics, camera.H, camera.W)
        differ = same_view("(nerf)", state["frame"], img)
        if get("/frame")[:2] != b"\xff\xd8":
            raise RuntimeError("viewer (nerf): /frame is not a JPEG")
        # pass 2: the same pose accumulates
        second_s = timed_pass(session, camera, state)
        stats2 = json.loads(get("/stats"))
        if stats2["spp"] != 2 or stats2["downscale"] != 1.0:
            raise RuntimeError(f"viewer (nerf): stats {stats2} on an unchanged pose")
        # pass 3: an orbit resets the accumulation
        get("/ctl?op=orbit&dx=40&dy=-10")
        timed_pass(session, camera, state)
        if json.loads(get("/stats"))["spp"] != 1:
            raise RuntimeError("viewer (nerf): an orbit did not reset the accumulation")
        before = state["frame"].copy()
        # pass 4: training off, the eval dial, xmin near the box's side
        get("/ctl?op=train")
        get("/ctl?op=max_samples&dx=16")
        get("/ctl?op=aabb&axis=0&dx=99")
        step = tr.global_step
        timed_pass(session, camera, state)
        crop = tr.aabb_infer
        bound_x = 0.99 * tr.render_cfg.bound
        if (session.training or tr.global_step != step or tr.eval_max_samples != 16
                or crop is None or abs(crop[0] - bound_x) > 1e-6):
            raise RuntimeError(f"viewer (nerf): training {session.training}, step "
                               f"{tr.global_step} (was {step}), eval_max_samples "
                               f"{tr.eval_max_samples}, aabb_infer {crop}")
        dark = [float(np.mean(255 - f.astype(np.float32))) for f in (before, state["frame"])]
        if not dark[1] < dark[0]:
            raise RuntimeError(f"viewer (nerf): the crop did not lighten the view ({dark})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.render_view(camera)
        torch.cuda.synchronize()
        view_s = time.perf_counter() - t0
        print(f"viewer (nerf): step {step0} loaded; a train call of 16 steps {stats['train_ms']:.1f}"
              f" ms (the first pass {first_s * 1e3:.1f} ms with its view), then "
              f"{stats2['train_ms']:.1f} ms for {session.steps_per_call} steps (pass 2, "
              f"{second_s * 1e3:.1f} ms); a {camera.W}x{camera.H} view {view_s * 1e3:.1f} ms "
              f"(cropped, 16 samples a ray); the view against render_frame: {differ:.5f} of "
              f"the values one level apart; the crop's mean darkness {dark[0]:.2f} -> "
              f"{dark[1]:.2f}  [{card}]", flush=True)

    def dnerf_checks(session, camera, state, get):
        tr = session.trainer
        step0 = tr.global_step
        if step0 <= 0 or not session._supports_time:
            raise RuntimeError("viewer (dnerf): no checkpoint loaded, or no scene time")
        timed_pass(session, camera, state)
        if tr.global_step != step0 + 16:
            raise RuntimeError(f"viewer (dnerf): step {tr.global_step} after a train call "
                               f"from {step0}")
        get("/ctl?op=train")
        timed_pass(session, camera, state)
        at0 = state["frame"].copy()
        get("/ctl?op=time&dx=0.5")
        t_s = timed_pass(session, camera, state)
        stats = json.loads(get("/stats"))
        if session.time != 0.5 or stats["spp"] != 1 or tr.global_step != step0 + 16:
            raise RuntimeError(f"viewer (dnerf): time {session.time}, stats {stats}")
        img, _ = tr.render_frame(camera.pose, camera.intrinsics, camera.H, camera.W, time=0.5)
        differ = same_view("(dnerf)", state["frame"], img)
        moved = float(np.mean(np.abs(state["frame"].astype(np.int32) - at0) > VIEW_LEVELS))
        if not moved >= 1e-3:
            raise RuntimeError(f"viewer (dnerf): the scrub to 0.5 left the view as at 0 "
                               f"({moved} of the values moved)")
        print(f"viewer (dnerf): step {step0} loaded; a {camera.W}x{camera.H} view at time 0.5 "
              f"{t_s * 1e3:.1f} ms; {moved:.4f} of the values differ from the view at 0 by "
              f"more than {VIEW_LEVELS} level; against render_frame {differ:.5f} one level "
              f"apart  [{card}]", flush=True)

    nerf_counts = drive("17(a) main_nerf -O --gui", main_nerf.main,
                        [scene, "-O", "--gui", "--workspace", ws, "--iters", str(CLI_ITERS)],
                        nerf_checks)
    check_launched("viewer main_nerf -O --gui", nerf_counts,
                   ("march_turbo", "cp_density_fwd", "cp_bwd_banks", "cp_sigma_rgb",
                    "ray_prepass", "fused_mlp", "fused_mlp_bwd"),
                   absent=("cp_encode_fwd", "coarse_lookup_bits"))
    dnerf_counts = drive("17(a) main_dnerf -O --gui", main_dnerf.main,
                         [dscene, "-O", "--gui", "--workspace", dws, "--iters",
                          str(DNERF_ITERS)], dnerf_checks)
    check_launched("viewer main_dnerf -O --gui", dnerf_counts,
                   ("march_turbo", "grid_encode_fwd", "grid_encode_bwd", "grid_encode_bwd_x",
                    "ray_prepass"), absent=("cp_density_fwd", "coarse_lookup_bits"))
    return nerf_counts, dnerf_counts


def rel_err(got, want):
    """max |got - want| over max |want|, on the CPU in f32."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def clip_runs(dev, card, scene, work):
    """Phase 17 (b): CLIP guidance at ViT-B/16's widths (``CLIPConfig()``:
    vision 768 x 12 layers x 12 heads, patch 16, 224^2; text 512 x 12 x 8;
    embedding 512) on weights drawn from SEED and the fixed token ids
    ``CLIP_IDS``. The towers' embeddings, the loss and d loss / d images of
    a 64 x 64 image (a guidance frame's size here) on the card against the
    same module and weights on the CPU in f32, within ``CLIP_TOL`` of the
    largest entry; the device ms of CLIP's forward and forward + backward
    at 224^2. Then ``main_nerf <scene> -O --rand_pose 4 --clip_model_path
    <name> --iters 64`` (one epoch: 40 frames and 10 guidance steps on
    64 x 64 frames), with ``clip_guidance.CLIPLoss`` replaced by a maker
    of this loss (no checkout is read): every guidance step ran, with a
    finite loss in [-1, 1], and left a finite, non-zero gradient on each CP
    factor bank; the kernels the guidance steps launched (counted around
    each); one profiled guidance step. Returns the run's launch counts and
    the guidance steps'."""
    import numpy as np
    import torch

    from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
    from ngp_tpu_torch.models import clip as tclip
    from ngp_tpu_torch.ops.kernels import launch_counts
    from ngp_tpu_torch.training import clip_guidance
    from ngp_tpu_torch.training.nerf import NeRFTrainer

    cfg = tclip.CLIPConfig()
    t0 = time.perf_counter()
    params = tclip.CLIP(cfg, torch.Generator().manual_seed(SEED), device=dev).state_dict()
    ids = np.zeros((1, cfg.context_length), np.int64)
    ids[0, :len(CLIP_IDS)] = CLIP_IDS
    loss_fn = clip_guidance.CLIPLoss("a chair", clip_cfg=cfg, params=params, token_ids=ids,
                                     device=dev)
    cpu = clip_guidance.CLIPLoss("a chair", clip_cfg=cfg,
                                 params={k: v.cpu() for k, v in params.items()},
                                 token_ids=ids, device="cpu")
    n_params = sum(v.numel() for v in params.values())
    print(f"CLIP ViT-B/16: {n_params} parameters from seed {SEED}, both towers built in "
          f"{time.perf_counter() - t0:.3f} s  [{card}]", flush=True)

    def value_grad(loss, x):
        x = x.clone().requires_grad_(True)
        v = loss(x)
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g

    img = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(SEED + 20))
    v_d, g_d = value_grad(loss_fn, img.to(dev))
    v_c, g_c = value_grad(cpu, img)
    with torch.no_grad():
        px = tclip.preprocess(img, cfg)
        e_d, e_c = loss_fn.model.encode_image(px.to(dev)), cpu.model.encode_image(px)
    errs = {"image embedding": rel_err(e_d, e_c),
            "text embedding": rel_err(loss_fn.text_features, cpu.text_features),
            "loss": rel_err(v_d, v_c), "d loss / d images": rel_err(g_d, g_c)}
    print(f"CLIP card vs CPU (f32, of the largest entry): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; loss {float(v_d):.6f}  [{card}]", flush=True)
    if not all(e <= CLIP_TOL for e in errs.values()) or not float(g_c.abs().max()) > 0:
        raise RuntimeError(f"CLIP: the card's towers differ from the CPU's past {CLIP_TOL}: "
                           f"{errs}")
    x224 = torch.rand((1, 224, 224, 3), device=dev, requires_grad=True)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: loss_fn(x224))
    fb_ms = cuda_ms(lambda: torch.autograd.grad(loss_fn(x224), x224))
    print(f"CLIP at 224^2 (batch 1): forward {fwd_ms:.3f} ms, forward + backward to the "
          f"pixels {fb_ms:.3f} ms (CUDA events)  [{card}]", flush=True)
    del cpu, e_c, g_c

    guided = {k: 0 for k in launch_counts()}
    grads = []

    def scored(text, model_path=None, device="cuda"):
        return loss_fn

    with cli_recorder(dev, card) as (seen, run):
        recorded = NeRFTrainer.guidance_step

        def guidance_step(self, *a, **kw):
            before = launch_counts()
            out = recorded(self, *a, **kw)
            for k, v in launch_counts().items():
                guided[k] += v - before[k]
            grads.append([float(f.grad.abs().sum()) if f.grad is not None else 0.0
                          for f in self.model.encoder.factors])
            return out

        with patched((clip_guidance, "CLIPLoss", scored),
                     (NeRFTrainer, "guidance_step", guidance_step)):
            trainer, counts, dt, _ = run(
                [scene, "-O", "--rand_pose", str(CLI_RAND_POSE), "--clip_model_path",
                 "clip-vit-base-patch16", "--clip_text", "a chair", "--workspace",
                 os.path.join(work, "ws_clip"), "--iters", str(CLI_GUIDE_ITERS)],
                "17(b) --rand_pose --clip_model_path")
        losses = [float(x) for x in seen["guidance"]]
    want = CLI_FRAMES[0] // CLI_RAND_POSE
    print(f"CLIP guidance: {len(losses)} guidance steps, losses {np.round(losses, 6).tolist()}; "
          f"the CP factor banks' gradient sums (first, last step) {grads[:1]}, {grads[-1:]}; "
          f"{dt:.3f} s  [{card}]", flush=True)
    if (trainer.guidance_loss is not loss_fn or len(losses) != want
            or not all(math.isfinite(v) and -1.0 <= v <= 1.0 for v in losses)
            or not all(math.isfinite(g) and g > 0 for step in grads for g in step)):
        raise RuntimeError(f"CLIP guidance: {len(losses)} steps (want {want}), losses {losses}, "
                           f"factor gradients {grads}")
    check_launched("CLIP run -O --rand_pose --clip_model_path", counts,
                   ("cp_density_fwd", "cp_bwd_banks", "march_turbo", "cp_sigma_rgb"))
    check_launched("CLIP guidance steps", guided,
                   ("cp_density_fwd", "cp_bwd_banks", "march_turbo"),
                   absent=("cp_sigma_rgb", "coarse_lookup_bits", "ray_prepass", "cp_encode_fwd"))
    batches = trainer.make_loader(NeRFDataset(scene, split="train"))()
    batch = next(b for b in batches if "guidance" in b)
    trainer.guidance_step(batch)
    profile(lambda: trainer.guidance_step(batch), 1, "guidance step", card,
            focus=("gemm", "softmax", "cp_", "march", "upsample"))
    del trainer, loss_fn
    return counts, guided


def brick_points(gen, dev, n):
    """n points uniform in [0, 1]^3, a quarter of them moved outside the box
    on one axis (to -0.1 or 1.1)."""
    import torch

    x = torch.rand((n, 3), generator=gen, device=dev)
    out = torch.rand((n,), generator=gen, device=dev) < 0.25
    axis = torch.randint(0, 3, (n,), generator=gen, device=dev)
    side = torch.where(torch.rand((n,), generator=gen, device=dev) < 0.5, -0.1, 1.1)
    x[out, axis[out]] = side[out]
    return x


def brick_edges(gen, dev, cfg):
    """Points with one coordinate on a level's cell edge (x * scale + 0.5
    an integer in real arithmetic; even integers are brick edges) or 1 ulp
    off it, for every cell of every level, or on the box's faces and
    2^-20 inside or outside them; the other two coordinates uniform."""
    import torch

    vals = []
    for level in range(cfg.num_levels):
        s = cfg.level_scale(level)
        vals.append(((torch.arange(1, int(s) + 1, device=dev, dtype=torch.float64) - 0.5) / s)
                    .float())
    v = torch.cat(vals)
    v = torch.cat([v, torch.nextafter(v, torch.full_like(v, 2.0)),
                   torch.nextafter(v, torch.full_like(v, -1.0)),
                   torch.tensor([0.0, 2.0**-20, -2.0**-20, 1.0, 1.0 + 2.0**-20,
                                 1.0 - 2.0**-20], device=dev)])
    x = torch.rand((v.numel(), 3), generator=gen, device=dev)
    axis = torch.randint(0, 3, (v.numel(),), generator=gen, device=dev)
    x[torch.arange(v.numel(), device=dev), axis] = v
    return x


def brick_rows(x, cfg):
    """The distinct table rows ``brick_encode`` gathers for points x [N, 3]."""
    import torch

    from ngp_tpu_torch.ops import brickgrid

    rows = []
    for level in range(cfg.num_levels):
        x0 = torch.floor(x * cfg.level_scale(level) + 0.5).long()
        rows.append(brickgrid._brick_index(cfg, level, x0 >> 1) + cfg.offsets[level])
    inside = inside_rows(x)
    return torch.unique(torch.stack(rows, dim=1)[inside]).numel()


def brick_runs(dev, card, scene, work, results, library):
    """Phase 17 (c): ``main_nerf <scene> --preset tpu --iters BRICK_ITERS``
    (the brick grid, 8 levels x 4 of up to 2^16 bricks of 108 values, bf16,
    the v1 march at 256 steps and 32 samples a ray; 10 epochs), then
    ``--test`` on its workspace: the epoch-mean loss falls, the test PSNR
    beats a white frame's by ``BRICK_MIN_GAIN`` dB and ``--test`` gives the
    same PSNR; the training run launches ``brick_encode_fwd`` and
    ``brick_table_grad`` (the table gradient, ``BrickEncode``) and no other
    kernel (not ``brick_encode_bwd`` or ``scatter_add_rows``, which made the
    table gradient before), ``--test`` ``brick_encode_fwd`` alone (the v1
    march is torch, as JAX leaves it to XLA), and neither asks for the plain
    x gradient. On the last step's own encoder points and cotangent:
    ``brick_encode``'s forward on the card against the CPU (bf16, ``TOL``);
    ``brick_checks`` (the three kernels against their plain versions, timed
    beside their bounds); the forward and the forward + table gradient
    between back-to-back calls and queued (``device_ms``) beside their
    bound: the 32-byte sectors of the distinct stencil cells read once
    (``brick_work``: 8 cells of a row a point and level, not the whole row),
    the points and cotangent read, the bf16 output and the dense f32 table
    gradient written once (``bound``); ``scatter_add_rows`` against its
    plain version on the rows ``brick_encode_bwd`` makes from that step's
    points and cotangent, beside ``index_add_`` and the kernel's per-row branch on a copy of the
    rows one float into its buffer (4-byte aligned, so no tiles); two
    profiled train steps and the peak memory of one. Returns the launch
    counts of the two runs."""
    import numpy as np
    import torch

    from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
    from ngp_tpu_torch.models.encoders import BrickGridEncoder
    from ngp_tpu_torch.ops import brickgrid
    from ngp_tpu_torch.ops.kernels import scatter as sk
    white = white_psnr(scene, "test")
    caught, calls = {}, [0]
    forward = BrickGridEncoder.forward

    def catching(self, x):
        out = forward(self, x)
        calls[0] += 1
        if out.requires_grad:
            entry = caught["last"] = {"x": x.detach().reshape(-1, 3).float().contiguous()
                                      .clone(), "enc": self}
            out.register_hook(lambda g, e=entry: e.__setitem__(
                "g", g.detach().reshape(e["x"].shape[0], -1).contiguous().clone()))
        return out

    ws = os.path.join(work, "ws_brick")
    argv = [scene, "--preset", "tpu", "--workspace", ws, "--iters", str(BRICK_ITERS)]
    n_train = CLI_FRAMES[0]
    with cli_recorder(dev, card) as (seen, run), patched((BrickGridEncoder, "forward", catching)):
        trainer, a_counts, a_dt, _ = run(argv, "17(c) --preset tpu")
        n_calls = calls[0]
        enc = trainer.model.encoder
        means = torch.stack(seen["step_losses"]).cpu().numpy().reshape(-1, n_train).mean(axis=1)
        psnr = seen["results"][-1]["psnr"]
        mid = seen["epochs"][1:-1]
        rays_s = len(mid) * n_train * trainer.train_cfg.num_rays / sum(mid)
        n_epochs = len(seen["epochs"])
        _, b_counts, _, _ = run(argv + ["--test"], "17(c) --test")
        psnr_b = seen["results"][-1]["psnr"]
    cfg = enc.cfg
    print(f"brick grid (c): {cfg.num_levels} levels x {cfg.level_dim}, {cfg.num_rows} bricks "
          f"of {cfg.row_width} values ({cfg.num_rows * cfg.row_width * 4} bytes in f32); "
          f"{trainer.global_step} steps in {a_dt:.3f} s, {rays_s:.0f} rays/s over epochs "
          f"2-{n_epochs - 1}; {n_calls} brick_encode calls; epoch-mean loss "
          f"{means[0]:.6f} -> {means[-1]:.6f}; test PSNR {psnr:.4f} dB (--test {psnr_b:.4f}; a "
          f"white frame {white:.4f}, floor +{BRICK_MIN_GAIN})  [{card}]", flush=True)
    if not (isinstance(enc, BrickGridEncoder) and enc.compute_dtype == torch.bfloat16
            and cfg.num_levels == 8 and cfg.level_dim == 4):
        raise RuntimeError(f"brick grid: not the preset's encoder: {cfg}")
    if not (means[-1] < means[0] and psnr >= white + BRICK_MIN_GAIN
            and abs(psnr_b - psnr) <= 0.01):
        raise RuntimeError(f"brick grid: epoch means {means}, test PSNR {psnr} (white {white}), "
                           f"--test {psnr_b}")
    # the preset's bf16 MLPs take FusedMLP
    mlps = ("fused_mlp", "fused_mlp_tc")
    trained = ("brick_encode_fwd", "brick_table_grad", "fused_mlp_bwd") + mlps
    check_launched("brick grid --preset tpu", a_counts, trained,
                   absent=tuple(k for k in a_counts if k not in trained))
    check_launched("brick grid --test", b_counts, ("brick_encode_fwd",) + mlps,
                   absent=tuple(k for k in b_counts if k not in ("brick_encode_fwd",) + mlps))

    e = caught["last"]
    x, g = e["x"], e["g"]
    table = e["enc"].embeddings.detach().requires_grad_(True)
    out = brickgrid.brick_encode(x, table, cfg, torch.bfloat16)
    n = min(x.shape[0], 16384)
    want = brickgrid.brick_encode(x[:n].cpu(), table.detach().cpu(), cfg, torch.bfloat16)
    err = (out[:n].detach().float().cpu() - want.float()).abs()
    if not bool((err <= TOL["bfloat16"] * (1.0 + want.float().abs())).all()):
        raise RuntimeError(f"brick_encode: the card's forward differs from the CPU's by "
                           f"{float(err.max())}")
    brick_checks(brickgrid, x, table.detach(), cfg, g, "17c last step", card, results)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: brickgrid.brick_encode(x, table, cfg, torch.bfloat16))
    def fwd_and_grad():
        return torch.autograd.grad(brickgrid.brick_encode(x, table, cfg, torch.bfloat16),
                                   (table,), g)

    fb_ms, fb_dev = cuda_ms(fwd_and_grad), device_ms(fwd_and_grad)
    N, L, C = x.shape[0], cfg.num_levels, cfg.level_dim
    rows = brick_rows(x, cfg)
    io, _, ops = brick_work(x, cfg, N * L * C * 2, 9 + 8 * (2 + 2 * C))
    f_bound = bound(io, 0, ops)
    fb_bound = bound(io + nbytes(g) + cfg.num_rows * cfg.row_width * 4, 0, 2 * ops)
    live = float((g.view(N, L, C) != 0).any(dim=2).float().mean())
    print(f"brick_encode (brick_encode_fwd, brick_table_grad) on step "
          f"{trainer.global_step - 1}'s {N} points "
          f"({1.0 - float(inside_rows(x).float().mean()):.4f} outside the box, {live:.4f} of "
          f"(point, level)s with a cotangent, {rows} distinct rows, "
          f"{io - nbytes(x) - N * L * C * 2} bytes of stencil sectors): forward "
          f"{fwd_ms:.4f} ms (bound {f_bound[0]:.4f}, {f_bound[1]}), forward + table gradient "
          f"{fb_ms:.4f} ms, queued {fb_dev:.4f} ms (bound {fb_bound[0]:.4f}, {fb_bound[1]}); "
          f"the card vs the CPU on {n} points {float(err.max()):.3e}  [{card}]", flush=True)
    # the row scatter on the rows the step's points and cotangent make
    idx_b, rows_b = brickgrid.brick_encode_bwd(x, g, cfg)
    R, W = cfg.num_rows, cfg.row_width
    outs = [torch.zeros((R, W), device=dev) for _ in range(3)]
    s_bound = scatter_bound(sk, idx_b, rows_b, R)
    key = ("scatter_add_rows", "17c last step's rows")
    results[key] = compare(
        "scatter_add_rows", lambda: sk.scatter_add_rows(idx_b, rows_b, outs[0]),
        lambda: sk.scatter_add_rows_plain(idx_b, rows_b, outs[1]), "float32",
        (nbytes(idx_b, rows_b, outs[0]), 0, rows_b.numel()), tol=lambda want: [s_bound])
    idx_l = idx_b.long()
    library[key] = cuda_ms(lambda: outs[2].index_add_(0, idx_l, rows_b))
    # the per-row branch on the same rows: a copy one float into its buffer
    # is 4-byte aligned only, so it skips the tiles
    rows_o = torch.empty((rows_b.numel() + 1,), device=dev)[1:].view(rows_b.shape)
    rows_o.copy_(rows_b)
    branches = {
        "tiles": device_ms(lambda: sk.scatter_add_rows(idx_b, rows_b, outs[0])),
        "a warp per row, unaligned copy": device_ms(
            lambda: sk.scatter_add_rows(idx_b, rows_o, outs[0]))}
    del rows_o
    zero4 = float((rows_b.view(-1, W // 4, 4) == 0).all(-1).float().mean())
    print(f"scatter_add_rows on step {trainer.global_step - 1}'s {idx_b.numel()} gathered rows "
          f"({torch.unique(idx_b[idx_b >= 0]).numel()} distinct, {zero4:.4f} of their float4s "
          f"zero) into "
          f"{R} x {W}: {results[key][1]:.4f} ms, index_add_ {library[key]:.4f} ms, bound "
          f"{results[key][3][0]:.4f} ms, max |kernel - plain| {results[key][0]:.3e}; device ms "
          f"by branch {{{', '.join(f'{k}: {v:.4f}' for k, v in branches.items())}}}  "
          f"[{card}]", flush=True)
    del out, want, table, caught, e, x, g, idx_b, rows_b, outs, s_bound, idx_l
    batches = itertools.chain.from_iterable(
        trainer.make_loader(NeRFDataset(scene, split="train"))() for _ in itertools.count())
    trainer.step(next(batches))
    profile(lambda: trainer.step(next(batches)), 2, "brick-grid step", card,
            focus=("brick_", "scatter_rows", "index", "gemm", "where", "elementwise"))
    torch.cuda.reset_peak_memory_stats()
    trainer.step(next(batches))
    print(f"brick-grid step: peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB  "
          f"[{card}]", flush=True)
    return a_counts, b_counts


def advanced_sample_1d(line, u):
    """``interp.sample_1d`` (align_corners) with advanced-indexing taps."""
    import torch

    D = line.shape[-1]
    p = (u.float() + 1.0) / 2.0 * (D - 1)
    p0 = torch.floor(p)
    f = p - p0
    p0 = p0.long()

    def tap(idx):
        ok = (idx >= 0) & (idx < D)
        return torch.where(ok[None, :], line[:, idx.clamp(0, D - 1)], 0.0)

    return tap(p0) * (1.0 - f)[None, :] + tap(p0 + 1) * f[None, :]


def advanced_sample_2d(plane, uv):
    """``interp.sample_2d`` (align_corners) with advanced-indexing taps."""
    import torch

    R, H, W = plane.shape
    px = (uv[:, 0].float() + 1.0) / 2.0 * (W - 1)
    py = (uv[:, 1].float() + 1.0) / 2.0 * (H - 1)
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    x0, y0 = x0.long(), y0.long()
    flat = plane.reshape(R, H * W)

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        return torch.where(ok[None, :], flat[:, yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)],
                           0.0)

    return (tap(y0, x0) * ((1 - fx) * (1 - fy))[None, :]
            + tap(y0, x0 + 1) * (fx * (1 - fy))[None, :]
            + tap(y0 + 1, x0) * ((1 - fx) * fy)[None, :]
            + tap(y0 + 1, x0 + 1) * (fx * fy)[None, :])


def tap_points(gen, dev, res, n, used=14_273):
    """``n`` points in [-1, 1]^3 (``tap_forms`` says how): "uniform",
    "clustered" (8 samples 2 / res apart on rays through a N(0, 0.3^2)
    cluster) and "padded" (those with the slots from ``used`` on at one
    point, as the compaction pads a step)."""
    import torch

    centres = (0.3 * torch.randn((n // 8, 1, 3), generator=gen, device=dev)).clamp(-1, 1)
    dirs = torch.nn.functional.normalize(
        torch.randn((n // 8, 1, 3), generator=gen, device=dev), dim=-1)
    clustered = (centres + dirs * torch.arange(8, device=dev).view(1, 8, 1) * (2.0 / res))
    clustered = clustered.reshape(n, 3).clamp(-1, 1)
    padded = clustered.clone()
    padded[used:] = padded[0]
    return {"uniform": torch.rand((n, 3), generator=gen, device=dev) * 2.0 - 1.0,
            "clustered": clustered, "padded": padded}


def tap_forms(dev, card, results, library):
    """TensoRF's factor sampling, forward and factor backward, with the
    port's kernels (``sample_taps_fwd`` forward, ``scatter_add_taps``
    backward), with the former taps (the plain ``index_select`` forward,
    ``scatter_add_taps`` backward) and with advanced indexing
    (``factor[:, idx]``), whose backward sorts the indices and walks each
    run of equal ones in turn. At a ``-O``
    step's shapes after the first upsample: VM factors at 152^3 (sigma
    rank 16, colour 48, three plane/line pairs each), 32,768 points (4096
    rays x 8) drawn uniform in the box, as a march places them (8 samples
    2/152 apart on rays through a N(0, 0.3^2) cluster), and those with the
    budget's unused slots (18,495 of a step of 14,273 samples) at one
    point, as the compaction pads them (ray 0 at t = 0; ``tap_points``).
    The features must agree bit for bit; times are ``cuda_ms`` in turns
    (each form, then each in reverse order). Then ``taps_check`` on each point set,
    both corner conventions (TensoRF's and CCNeRF's), a plane of rank 16
    and 48 and a line of rank 48."""
    import torch

    from ngp_tpu_torch.models.tensorf import MAT_IDS, VEC_IDS
    from ngp_tpu_torch.ops import interp
    from ngp_tpu_torch.ops.kernels import scatter as sk

    res, ranks, n = TENSORF_RES, (16, 48), 4096 * 8
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    # the factors cell-major, as the models hold them
    planes = [sk.cell_major(0.1 * torch.randn((r, res, res), generator=gen, device=dev))
              .requires_grad_() for r in ranks for _ in range(3)]
    lines = [sk.cell_major(0.1 * torch.randn((r, res), generator=gen, device=dev))
             .requires_grad_() for r in ranks for _ in range(3)]
    points = tap_points(gen, dev, res, n)
    cot = torch.randn((sum(ranks) * 3, n), generator=gen, device=dev)
    forms = {"advanced": (advanced_sample_2d, advanced_sample_1d),
             "index_select": (interp.sample_2d, interp.sample_1d),
             "kernels": (interp.sample_2d, interp.sample_1d)}

    def step(form, xn):
        s2, s1 = forms[form]
        feats = []
        # the port's former taps: the plain forward beside the gradient kernel
        plain = (sk, "sample_taps_fwd", sk.sample_taps_plain)
        with patched(*([plain] if form == "index_select" else [])):
            for j, (plane, line) in enumerate(zip(planes, lines)):
                m0, m1 = MAT_IDS[j % 3]
                uv = torch.stack([xn[:, m0], xn[:, m1]], dim=-1)
                feats.append(s2(plane, uv) * s1(line, xn[:, VEC_IDS[j % 3]]))
        out = torch.cat(feats)
        return out.detach(), torch.autograd.grad((out * cot).sum(), planes + lines)

    for name, xn in points.items():
        runs = {form: step(form, xn) for form in forms}
        out_k, grads_k = runs["kernels"]
        for form, (out_f, grads_f) in runs.items():
            if not torch.equal(out_f, out_k):
                raise RuntimeError(f"TensoRF taps [{name}]: the {form} form's features differ "
                                   "from the kernels'")
        err = max(float((a - b).abs().max()) for a, b in zip(grads_k, runs["advanced"][1]))
        order = list(forms) + list(forms)[::-1]
        ms = {form: [] for form in forms}
        for form in order:
            ms[form].append(cuda_ms(lambda: step(form, xn)))
        print(f"TensoRF taps [{name} points]: forward + factor backward of {n} points on 6 "
              f"planes and 6 lines at {res}: advanced indexing "
              f"{sum(ms['advanced']) / 2:.3f} ms, index_select + scatter_add_taps "
              f"{sum(ms['index_select']) / 2:.3f} ms, sample_taps_fwd + scatter_add_taps "
              f"{sum(ms['kernels']) / 2:.3f} ms; features equal, max |gradient "
              f"difference| {err:.3e}  [{card}]", flush=True)
        uv = torch.stack([xn[:, MAT_IDS[0][0]], xn[:, MAT_IDS[0][1]]], dim=-1)
        for align in (True, False):
            for rank, shape, coords in ((16, (16, res, res), uv), (48, (48, res, res), uv),
                                        (48, (48, res), xn[:, VEC_IDS[0]])):
                kind = "plane" if len(shape) == 3 else "line"
                taps_check(sk, cot[:rank], coords, shape, align,
                           f"{name} {kind} R{rank} align_corners={align}", card, results, library)


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
        check_launched(path, launch_counts(), kernels,
                       absent=("coarse_lookup_bits", "ray_prepass"))
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
    parser.add_argument("--mlp", action="store_true",
                        help="build the kernels, run mlp_checks (the bf16 MLP route at the "
                             "benchmark cells' shapes) and stop")
    parser.add_argument("--dnerf-control", action="store_true",
                        help="also run phase 16 (a) with the deformation net frozen; its test "
                             "PSNR must stay below DNERF_MIN_PSNR")
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
    t0 = time.perf_counter()
    sass = sass_dump(build.library_path())
    # the tensor-core kernels of the heads (bf16, and f32 in 3xTF32) and the
    # MLP chain's forward and backward: HMMA in their SASS, no spills but in
    # the f32 heads' (each thread holds a K chunk's loads beside its
    # products' state in 128 registers; PERF.md)
    for kernel in ("cp_density_tc_kernel", "cp_sigma_rgb_tc_kernel", "cp_density_tf32x3_kernel",
                   "cp_sigma_rgb_tf32x3_kernel", "fused_mlp_tc_kernel", "fused_mlp_bwd_kernel"):
        hmma = sum("HMMA" in line for line in sass_lines(sass, kernel))
        spills = sum(n for _, _, n in ptxas_usage(report, kernel))
        print(f"SASS: {kernel} has {hmma} HMMA instructions; ptxas: {spills} bytes of spill "
              "stores", flush=True)
        if hmma == 0 or (spills > 0 and "tf32x3" not in kernel):
            raise RuntimeError(f"{kernel}: {hmma} tensor-core instructions, {spills} bytes of "
                               "spill stores")
    # the CP run kernels: registers and spills of each instance; no call to
    # a 64-bit division routine in their SASS
    for kernel in ("cp_bwd_runs_kernel", "cp_encode_runs_kernel"):
        for name, regs, spills in ptxas_usage(report, kernel):
            print(f"ptxas: {name}: {regs} registers, {spills} bytes of spill stores")
        calls = [ln.strip() for ln in sass_lines(sass, kernel) if "CALL" in ln]
        divs = [c for c in calls if "div" in c.lower() or "rem" in c.lower()]
        print(f"SASS: {kernel}: {len(calls)} calls, {len(divs)} to a division routine",
              flush=True)
        if divs:
            raise RuntimeError(f"{kernel} calls a division routine: {divs[:2]}")
    for kernel in ("march_turbo_kernel", "ray_prepass_kernel", "grid_bwd_x_kernel"):
        for name, regs, spills in ptxas_usage(report, kernel):
            print(f"ptxas: {name}: {regs} registers, {spills} bytes of spill stores", flush=True)
    # the brick kernels (32-bit geometry, the rows divided by a mask or a
    # magic multiplier): no spills, no call to a division routine
    for kernel in ("brick_fwd_kernel", "brick_grad_kernel", "brick_bwd_kernel"):
        usage = ptxas_usage(report, kernel)
        for name, regs, spills in usage:
            print(f"ptxas: {name}: {regs} registers, {spills} bytes of spill stores")
        calls = [ln.strip() for ln in sass_lines(sass, kernel) if "CALL" in ln]
        divs = [c for c in calls if "div" in c.lower() or "rem" in c.lower()]
        spills = sum(n for _, _, n in usage)
        print(f"SASS: {kernel}: {len(calls)} calls, {len(divs)} to a division routine; "
              f"{spills} bytes of spill stores", flush=True)
        if divs or spills:
            raise RuntimeError(f"{kernel}: {len(divs)} calls to a division routine "
                               f"({divs[:2]}), {spills} bytes of spill stores")
    del sass
    phase("SASS checks", t0)
    if args.mlp:
        results, library = {}, {}
        t0 = time.perf_counter()
        mlp_checks(mlp, dev, card, results, library)
        phase("MLP route at the cells' shapes", t0)
        print(json.dumps({"mlp": [{"what": k[0], "shape": k[1], "max_err": v[0], "ms": v[1],
                                   "plain_ms": v[2], "bound_ms": v[3][0], "bound_by": v[3][1],
                                   "library_ms": library.get(k)}
                                  for k, v in results.items()]}))
        print(card)
        return

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
                                         "cp_sigma_rgb_tc", "march_turbo", "ray_prepass"),
                   absent=("coarse_lookup_bits",))
    for img in images:
        if img.shape != (FRAME, FRAME, 3) or not np.isfinite(img).all():
            raise RuntimeError("frame is not a finite 800x800x3 image")
        if img.min() < 0.0 or img.max() > 1.0:
            raise RuntimeError("frame values outside [0, 1]")
    if trainer.last_render_stats["n_samples"] <= 0:
        raise RuntimeError("the frames rendered no samples")
    results, library = {}, {}

    # 3b. the f32 heads' API path: the same network in f32, refreshes, a frame
    t0 = time.perf_counter()
    f32_eval_counts = f32_eval_run(dev, card, nc, rc, results)
    phase("f32 eval (16 full refreshes, one 800x800 frame)", t0)

    # 4. each kernel against its plain version at the paths' shapes
    t4 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    factors = tuple(f.detach() for f in model.encoder.factors)
    w1, w2 = (w.detach() for w in model.sigma_net.weights)
    color = tuple(w.detach() for w in model.color_net.weights)
    res, fd = nc.cp_resolutions, nc.cp_freq_degree
    nbR = len(res) * nc.cp_rank
    rows = {"cp_density_fwd": 128 * 128 * 8, "cp_sigma_rgb": EVAL_ROWS}
    # the work of each function for its bound: the heads' as density_work
    # and sigma_rgb_work count it; the factor backward 2 taps of ~4 per
    # (row, bank column, axis)
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
        # the tensor-core route's count of each head in this type
        route = {head: head + ("_tc" if dtype == "bfloat16" else "_tf32x3")
                 for head in ("cp_density_fwd", "cp_sigma_rgb")}
        fa = tuple(f.to(dt).contiguous() for f in factors)
        a1, a2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
        ca = tuple(w.to(dt).contiguous() for w in color)
        M = rows["cp_density_fwd"]
        pos = torch.rand((M, 3), generator=gen, device=dev) * 1.1 - 0.05
        results[("cp_density_fwd", dtype)] = compare(
            "cp_density_fwd",
            lambda: cp.cp_density_fwd(pos, fa, a1, a2, res, fd),
            lambda: cp.cp_density_plain(pos, fa, a1, a2, res, fd), dtype,
            density_work(pos, fa, a1, a2))
        M = TRAIN_ROWS
        pos_t = torch.rand((M, 3), generator=gen, device=dev) * 1.1 - 0.05
        resid_tol = None
        if dtype == "bfloat16":
            resid_tol = lambda want: density_bound(cp, pos_t, fa, res, want)  # noqa: E731
        results[("cp_density_fwd+residuals", dtype)] = compare(
            "cp_density_fwd+residuals",
            lambda: cp.cp_density_fwd(pos_t, fa, a1, a2, res, fd, residuals=True),
            lambda: cp.cp_density_plain(pos_t, fa, a1, a2, res, fd, residuals=True), dtype,
            density_work(pos_t, fa, a1, a2, residuals=True), tol=resid_tol)
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
                    dtype, density_work(pos_x, fe, e1, e2, residuals=resid), tol=tol)
        # sigma MLPs wider than the 128-row tiles take, on the model's banks;
        # each must take its type's tensor-core kernel (its launch count says so)
        pos_x = torch.rand((WIDE_ROWS, 3), generator=gen, device=dev) * 1.1 - 0.05
        for h1_w in WIDE_H1:
            e1, e2, _ = head_weights(gen, dev, dt, D, h1_w, OUT, nc.sh_degree, ())
            before = launch_counts()[route["cp_density_fwd"]]
            cp.cp_density_fwd(pos_x, fa, e1, e2, res, fd)
            if launch_counts()[route["cp_density_fwd"]] - before != 1:
                raise RuntimeError(f"cp_density_fwd: H1 {h1_w} {dtype} took the wrong route")
            for resid in (False, True):
                tol = None
                if resid and dtype == "bfloat16":
                    tol = lambda want: density_bound(cp, pos_x, fa, res, want)  # noqa: E731
                results[("cp_density_fwd" + "+residuals" * resid,
                         f"{dtype} {WIDE_ROWS} rows, H1 {h1_w}")] = compare(
                    "cp_density_fwd",
                    lambda: cp.cp_density_fwd(pos_x, fa, e1, e2, res, fd, residuals=resid),
                    lambda: cp.cp_density_plain(pos_x, fa, e1, e2, res, fd, residuals=resid),
                    dtype, density_work(pos_x, fa, e1, e2, residuals=resid), tol=tol)
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
            dtype, sigma_rgb_work(pos, dirs, fa, a1, a2, ca))
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
            before = launch_counts()[route["cp_sigma_rgb"]]
            cp.cp_sigma_rgb(pos_x, dirs_x, fe, e1, e2, ce, res_e, fd_e, sh_e)
            if launch_counts()[route["cp_sigma_rgb"]] == before:
                raise RuntimeError(f"cp_sigma_rgb: a {dtype} edge shape missed the tensor cores")
            shape = (f"{dtype} {M_e} rows, rank {fe[0].shape[-1]}, freq degree {fd_e}, "
                     f"factors x{scale}, H1 {h1_e}, SH {sh_e}, colour {len(ce)} layers")
            results[("cp_sigma_rgb", shape)] = compare(
                "cp_sigma_rgb",
                lambda: cp.cp_sigma_rgb(pos_x, dirs_x, fe, e1, e2, ce, res_e, fd_e, sh_e),
                lambda: cp.cp_sigma_rgb_plain(pos_x, dirs_x, fe, e1, e2, ce, res_e, fd_e, sh_e),
                dtype, sigma_rgb_work(pos_x, dirs_x, fe, e1, e2, ce))
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
    # the bf16 MLP route (FusedMLP's two kernels) at the cells' shapes
    mlp_checks(mlp, dev, card, results, library)
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
    # the factor taps at TensoRF's 152^3 (a -O step after the first upsample):
    # cell-major planes and lines of ranks 1, 16 and 48 on 32,768 uniform,
    # clustered and padded points (tap_points), both corner conventions, the
    # coords columns of the points (strided, as the models pass them) and, for
    # the planes, also stacked as the models stack them; the forward (rank 48
    # timed; a bf16 plane) and the gradient (timed in phase 14's tap_forms)
    from ngp_tpu_torch.ops import brickgrid as bg

    for pname, xn in tap_points(gen, dev, TENSORF_RES, 4096 * 8).items():
        cot = torch.randn((48, xn.shape[0]), generator=gen, device=dev)
        for rank in (1, 16, 48):
            plane = sk.cell_major(torch.randn((rank, TENSORF_RES, TENSORF_RES), generator=gen,
                                              device=dev))
            line = sk.cell_major(torch.randn((rank, TENSORF_RES), generator=gen, device=dev))
            for align in (True, False):
                for kind, factor, coords in (
                        ("plane", plane, xn[:, 0:2]), ("line", line, xn[:, 2]),
                        ("plane stacked", plane, torch.stack([xn[:, 0], xn[:, 2]], dim=-1))):
                    label = f"{pname} {kind} R{rank} align_corners={align}"
                    taps_fwd_check(sk, factor, coords, align, label, card, results, library,
                                   timed=rank == 48 and kind != "plane stacked")
                    taps_check(sk, cot[:rank], coords, tuple(factor.shape), align, label, card,
                               results, library, timed=False)
        taps_fwd_check(sk, sk.cell_major(plane[:16].to(torch.bfloat16)), xn[:, 0:2], False,
                       f"{pname} bf16 plane R16", card, results, library, timed=False)
    del plane, line, xn, cot
    # the brick grid's kernels at --preset tpu's geometry (8 levels x 4,
    # levels 0-2 dense, 3-7 hashed; 399,268 rows of 108 f32, drawn N(0, 1)):
    # 131,072 random points with 25% outside the box; the points of every
    # level's cell edges (x * scale + 0.5 an integer: even ones are brick
    # edges) and 1 ulp off them, the box's faces and just outside them; bf16
    # and f32
    bcfg = bg.BrickGridConfig(num_levels=8, level_dim=4, base_resolution=16,
                              log2_hashmap_size=16, desired_resolution=4096)
    btable = torch.randn((bcfg.num_rows, bcfg.row_width), generator=gen, device=dev)
    brick_x = {"random": brick_points(gen, dev, 131_072), "edges": brick_edges(gen, dev, bcfg)}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for pname, xb in brick_x.items():
            gb = torch.randn((xb.shape[0], bcfg.output_dim), generator=gen, device=dev).to(dt)
            err = brick_checks(bg, xb, btable, bcfg, gb, f"{dtype} {pname}", card, results,
                               timed=pname == "random")
            print(f"brick kernels [{dtype} {pname}]: {xb.shape[0]} points, forward within its "
                  f"bound (max |kernel - plain| {err:.3e}), table gradient within its bound, "
                  f"rows bit for bit  [{card}]", flush=True)
    del btable, brick_x, gb
    printed = print_results(results, library, card, set())
    phase("kernels against their plain versions", t4)

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
                       absent=("coarse_lookup_bits", "ray_prepass"))
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
                                                       "march_turbo", "ray_prepass"),
                       absent=("coarse_lookup_bits",))
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
                                                     "march_turbo", "ray_prepass"),
                       absent=("coarse_lookup_bits",))
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
                                             "march_turbo", "ray_prepass"),
                       absent=("coarse_lookup_bits",))
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
        api_prepass = []
        restore_prepass = keep_prepasses(occupancy, api_prepass, 3)
        trainer.render_frame(pose, intr, FRAME, FRAME)
        restore_prepass()
        # the prepass of the 800x800 frame at stride 2: three chunks
        if len(api_prepass) != 3:
            raise RuntimeError(f"trained 800x800 frame: {len(api_prepass)} prepass chunks kept")
        for i, (p_args, p_kw) in enumerate(api_prepass):
            compare_prepass(f"API frame chunk {i}", p_args, p_kw, card, results)
        del api_prepass
        frame_prof = profile(lambda: trainer.render_frame(pose, intr, FRAME, FRAME), 1, "frame",
                             card, focus=("cp_sigma_rgb", "cp_density", "march", "ray_prepass",
                                          "coarse_lookup"))
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
                        "cp_sigma_rgb_tc", "march_turbo", "ray_prepass"),
                       absent=("coarse_lookup_bits",))
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
                   absent=("coarse_lookup_bits", "ray_prepass"))
    check_launched(f"dt_gamma {CLI_DT_GAMMA} frame", gamma_frame_counts,
                   ("march_turbo", "ray_prepass", "cp_sigma_rgb_tc"),
                   absent=("coarse_lookup_bits",))
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
        cli_counts, rays_11a, psnr_11a = cli_runs(dev, card, scene, g_rays_s, tmp, results)
        phase("CLI (-O, resume, --test, hashgrid with losses, --rand_pose)", t0)

        # 12. the rest of main_nerf: the background net, no -O, LPIPS
        t0 = time.perf_counter()
        rest_counts = cli_rest_runs(dev, card, scene, psnr_11a, rays_11a, results)
        phase("CLI rest (-O --bg_radius + LPIPS, no -O hash grid and cpgrid, v1 + bg)", t0)

        # 13. SDF: main_sdf sphere, --test, --fp16
        t0 = time.perf_counter()
        sdf_counts = sdf_runs(dev, card, results)
        phase("SDF (sphere, --test, --fp16)", t0)

        # 14. TensoRF on the same scene: -O (VM), --test, --cp, --bg_radius
        t0 = time.perf_counter()
        tensorf_counts = tensorf_runs(dev, card, scene, rays_11a, results, library)
        phase("TensoRF (-O, --test, --cp, --bg_radius)", t0)

        # 15. CCNeRF on the same scene: -O --compose, --test
        t0 = time.perf_counter()
        ccnerf_counts = ccnerf_runs(dev, card, scene, results, library)
        phase("CCNeRF (-O --compose, --test)", t0)

        # 16. D-NeRF on a dynamic scene: -O, --test, --hyper, --basis
        t0 = time.perf_counter()
        dnerf_counts = dnerf_runs(dev, card, results, tmp, control=args.dnerf_control)
        phase("D-NeRF (-O, --test, --hyper, --basis)", t0)

        # 17. the viewers on 11 (a)'s and 16 (a)'s workspaces, CLIP guidance,
        # the brick grid
        t0 = time.perf_counter()
        view_counts = viewer_runs(dev, card, scene, os.path.join(tmp, "cli", "ws"),
                                  os.path.join(tmp, "dnerf", "dscene"),
                                  os.path.join(tmp, "dnerf", "ws"))
        phase("viewers (main_nerf -O --gui, main_dnerf -O --gui)", t0)
        t0 = time.perf_counter()
        clip_counts, guided_counts = clip_runs(dev, card, scene, tmp)
        phase("CLIP guidance (ViT-B/16, -O --rand_pose --clip_model_path)", t0)
        t0 = time.perf_counter()
        brick_counts = brick_runs(dev, card, scene, tmp, results, library)
        phase("brick grid (--preset tpu, --test)", t0)

    # 18. parallelism: the trainers' mesh branches on one rank over NCCL
    t0 = time.perf_counter()
    par_train_counts, par_frame_counts = parallel_runs(dev, card, rc, nc, train_ds, val_ds,
                                                       results)
    phase(f"parallel (one NCCL rank: 3 x {PARALLEL_STEPS} steps, two mesh frames)", t0)

    print_results(results, library, card, printed)
    path_counts = (eval_counts, f32_eval_counts, train_counts, frame_counts, evaluate_counts,
                   test_counts, mesh_counts, wide_counts, gamma_counts, gamma_frame_counts,
                   hash_train_counts, hash_frame_counts, *cli_counts, *rest_counts, *sdf_counts,
                   *tensorf_counts, *ccnerf_counts, *dnerf_counts, *view_counts, clip_counts,
                   *brick_counts, par_train_counts, par_frame_counts)
    # phases 14's, 15's, 17's and 18's paths on their own (the guidance steps
    # are a part of the CLIP run)
    def summed(runs):
        return {k: sum(c[k] for c in runs) for k in runs[0]}

    slice_paths = {"14_tensorf": summed(tensorf_counts), "15_ccnerf": summed(ccnerf_counts),
                   "17a_viewer_nerf": view_counts[0], "17a_viewer_dnerf": view_counts[1],
                   "17b_clip_run": clip_counts, "17b_clip_guidance_steps": guided_counts,
                   "17c_brickgrid": summed(brick_counts),
                   "18_parallel_train": par_train_counts, "18_parallel_frame": par_frame_counts}
    csrc = "ngp_tpu_torch/ops/kernels/csrc/"
    sources = {
        "cp_density_fwd": (csrc + "cp_kernels.cu", "ngp_tpu/ops/pallas/cp_kernels.py:345",
                           ("cp_density_fwd+residuals", "bfloat16")),
        "cp_sigma_rgb": (csrc + "cp_kernels.cu", "ngp_tpu/ops/pallas/cp_kernels.py:506",
                         ("cp_sigma_rgb", "bfloat16")),
        # the same heads' f32 route (3xTF32): at phase 4's shapes, as above
        "cp_density_fwd_tf32x3": (csrc + "cp_kernels.cu", "ngp_tpu/ops/pallas/cp_kernels.py:345",
                                  ("cp_density_fwd+residuals", "float32")),
        "cp_sigma_rgb_tf32x3": (csrc + "cp_kernels.cu", "ngp_tpu/ops/pallas/cp_kernels.py:506",
                                ("cp_sigma_rgb", "float32")),
        # the march around the lookup on the train and eval paths, on the last
        # train step's own inputs; the eval prepass around it, on the trained
        # 800x800 frame's first prepass chunk; the lookup alone, on no path
        "march_turbo": (csrc + "march_kernels.cu", "ngp_tpu/ops/pallas/march_kernels.py:73",
                        ("march_turbo", f"step {TRAIN_STEPS - 1}")),
        "ray_prepass": (csrc + "march_kernels.cu", "ngp_tpu/ops/pallas/march_kernels.py:73",
                        ("ray_prepass", "API frame chunk 0")),
        "coarse_lookup_bits": (csrc + "march_kernels.cu",
                               "ngp_tpu/ops/pallas/march_kernels.py:73",
                               ("coarse_lookup_bits", "bits")),
        # on the main path's own inputs: the last train step's, a mesh chunk
        "cp_bwd_banks": (csrc + "cp_kernels.cu", "ngp_tpu/ops/pallas/cp_kernels.py:206",
                         ("cp_bwd_banks", f"step {TRAIN_STEPS - 1}")),
        "cp_encode_fwd": (csrc + "cp_kernels.cu", "ngp_tpu/ops/pallas/cp_kernels.py:159",
                          ("cp_encode_fwd", "bfloat16->bfloat16 mesh chunk")),
        # every bf16 MLP on the card (FusedMLP): the hash cell's colour net
        # on a step's 2,097,152 slots, the backward with its march-like
        # cotangent
        "fused_mlp": (csrc + "mlp_kernels.cu", "ngp_tpu/ops/pallas/fused_mlp.py:92",
                      ("mlp_bf16_fwd", "2097152 x 31-64-64-3")),
        "fused_mlp_bwd": (csrc + "mlp_kernels.cu", "none: XLA's VJP of the MLPs",
                          ("mlp_bf16_bwd", "2097152 x 31-64-64-3 march")),
        # on no path since brick_table_grad: the rows of phase 17 (c)'s last
        # step's own points and cotangent; the factor taps' gradient (TensoRF,
        # CCNeRF), on the largest call of a TensoRF step's own taps
        "scatter_add_rows": (csrc + "scatter_kernels.cu", "scripts/perf_probe2_r2.py:128",
                             ("scatter_add_rows", "17c last step's rows")),
        "scatter_add_taps": (csrc + "scatter_kernels.cu", "ngp_tpu/ops/interp.py:62",
                             ("scatter_add_taps", "TensoRF step largest call")),
        # the taps' forward (TensoRF, CCNeRF), on the largest call of a TensoRF
        # step's own taps; the brick grid's forward, table gradient and rows'
        # cotangent (on no path), on phase 17 (c)'s last step's own points and
        # cotangent
        "sample_taps_fwd": (csrc + "taps_kernels.cu", "ngp_tpu/ops/interp.py:45",
                            ("sample_taps_fwd", "TensoRF step largest call")),
        "brick_encode_fwd": (csrc + "brick_kernels.cu", "ngp_tpu/ops/brickgrid.py:143",
                             ("brick_encode_fwd", "17c last step")),
        "brick_table_grad": (csrc + "brick_kernels.cu", "ngp_tpu/ops/brickgrid.py:143",
                             ("brick_table_grad", "17c last step")),
        "brick_encode_bwd": (csrc + "brick_kernels.cu", "ngp_tpu/ops/brickgrid.py:143",
                             ("brick_encode_bwd", "17c last step")),
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
        # JAX's autodiff of grid_encode in x (D-NeRF), and the 4-D instances
        # (the hyper grid), on phase 16 (a)'s and (c)'s last steps' own points
        "grid_encode_bwd_x": (csrc + "grid_bwd_x_kernels.cu", "ngp_tpu/ops/hashgrid.py:161",
                              ("grid_encode_bwd_x", f"D=3 bf16 step {cli_steps(DNERF_ITERS) - 1}")),
        "grid_encode_fwd_4d": (csrc + "grid_kernels.cu", "ngp_tpu/ops/hashgrid.py:203",
                               ("grid_encode_fwd",
                                f"D=4 bf16 step {cli_steps(DNERF_SHORT_ITERS) - 1}")),
        "grid_encode_bwd_4d": (csrc + "grid_kernels.cu", "ngp_tpu/ops/hashgrid.py:204",
                               ("grid_encode_bwd",
                                f"D=4 bf16 step {cli_steps(DNERF_SHORT_ITERS) - 1}")),
        "grid_encode_bwd_x_4d": (csrc + "grid_bwd_x_kernels.cu", "ngp_tpu/ops/hashgrid.py:161",
                                 ("grid_encode_bwd_x",
                                  f"D=4 bf16 step {cli_steps(DNERF_SHORT_ITERS) - 1}")),
    }
    lookups = sum(c["coarse_lookup_bits"] for c in path_counts)
    if lookups:
        raise RuntimeError(f"coarse_lookup_bits was launched {lookups} times on the paths: the "
                           "prepass kernel replaces it")
    kernels = []
    for name, (src, replaces, key) in sources.items():
        err, k_ms, p_ms, (b_ms, b_by) = results[key]
        launches = sum(c[name] for c in path_counts)
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "max_abs_err": err, "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": library.get(key),
                        "paths": {p: c[name] for p, c in slice_paths.items()}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
