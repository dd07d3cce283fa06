#!/usr/bin/env python3
"""The PyTorch port's turbo-hq quality, run after run, with the march kernel
and with its plain version.

Each run trains a fresh turbo-hq network (random weights from one seed) for
256 steps of 16384 rays on the synthetic scene and scores the val frame
with the EMA weights, as ``chip_smoke.py`` phases 6-7 do. Runs alternate
between ``march_turbo`` (one CUDA kernel) and ``march_turbo_plain`` (the
same samples bit for bit, composed of PyTorch ops). Every input is the
same from run to run, so the spread within one route is what the f32
atomics of the backward leave; a gap between the routes would be the
kernel's.

Run on one NVIDIA GPU from the repository root:

    python3 scripts/torch_march_psnr_spread.py [--runs 12]

Prints one line per run and, last, one JSON object with each route's
PSNRs and final losses.
"""

import argparse
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile

SEED = 0
STEPS = 256
RAYS = 16384


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=12, help="runs of each route")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_march_psnr_spread: no CUDA device; this script runs on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from ngp_tpu_torch.config import NetworkConfig, RenderConfig, TrainConfig
    from ngp_tpu_torch.data.synthetic import make_synthetic_frames
    from ngp_tpu_torch.models import occupancy
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops.kernels import launch_counts, march, reset_launch_counts
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    # the turbo-hq preset (bench.py), as chip_smoke.py builds it
    rc = RenderConfig(
        bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=256, max_samples_per_ray=32,
        grid_size=128, density_thresh=10.0, turbo=True, coarse_candidates=96,
        crossing_slots=16, compact_mean_samples=6,
    )
    nc = NetworkConfig(encoding="cpgrid", use_bf16=True,
                       cp_resolutions=(128, 256, 512, 1024, 2048), cp_rank=128,
                       cp_freq_degree=6)
    splits = make_synthetic_frames(n_train=16, n_val=1, n_test=0, H=400, W=400, seed=SEED,
                                   device=dev)
    train_ds, val_ds = splits["train"], splits["val"]
    gt = val_ds.images[0]
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    routes = {"kernel": march.march_turbo, "plain": march.march_turbo_plain}
    out = {name: {"psnr": [], "loss": []} for name in routes}
    for i, name in itertools.product(range(args.runs), routes):
        occupancy.march_turbo = routes[name]
        model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(SEED), device=dev)
        with tempfile.TemporaryDirectory() as ws:
            tc = TrainConfig(iters=30000, lr=1e-2, num_rays=RAYS, update_extra_interval=16,
                             workspace=ws)
            trainer = GridNeRFTrainer(model, rc, tc, seed=SEED)
            trainer.mark_untrained(train_ds.poses, train_ds.intrinsics, train_ds.H, train_ds.W)
            epoch_iter = trainer.make_loader(train_ds)
            batches = itertools.chain.from_iterable(epoch_iter() for _ in itertools.count())
            reset_launch_counts()
            losses = [trainer.step(next(batches))["loss"] for _ in range(STEPS)]
            launched = launch_counts()["march_turbo"]
            img, _ = trainer.render_frame(val_ds.poses[0], val_ds.intrinsics, val_ds.H,
                                          val_ds.W)
        if launched != (STEPS if name == "kernel" else 0):
            raise RuntimeError(f"run {i} ({name}): {launched} march kernel launches")
        psnr = -10.0 * math.log10(float(np.mean((img - gt) ** 2)))
        loss = float(torch.stack(losses[-16:]).mean())
        if not (math.isfinite(psnr) and math.isfinite(loss)):
            raise RuntimeError(f"run {i} ({name}): PSNR {psnr}, loss {loss}")
        out[name]["psnr"].append(psnr)
        out[name]["loss"].append(loss)
        print(f"run {i} {name}: PSNR {psnr:.4f} dB, last 16 steps' mean loss {loss:.6f}  "
              f"[{card}]", flush=True)
        del trainer, model
    occupancy.march_turbo = routes["kernel"]
    for name, r in out.items():
        p = r["psnr"]
        print(f"{name}: PSNR min {min(p):.4f} median {statistics.median(p):.4f} max "
              f"{max(p):.4f} dB, sd {statistics.pstdev(p):.4f} over {len(p)} runs  [{card}]")
    print(json.dumps({"card": card, **out}))


if __name__ == "__main__":
    main()
