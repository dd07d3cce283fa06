#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 18 (``ngp_tpu_torch/parallel/`` on one
NCCL rank) alone on one NVIDIA GPU: build the kernels, render phase 6's
synthetic scene (16 train frames and one val frame of 400x400) and call
``parallel_runs`` at the turbo-hq preset. About two minutes of command
time, most of it the build.

    python3 scripts/torch_phase18.py
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    import chip_smoke as cs
    from ngp_tpu_torch.config import NetworkConfig, RenderConfig
    from ngp_tpu_torch.data.synthetic import make_synthetic_frames
    from ngp_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("torch_phase18: no CUDA device; this script runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print("card:", card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    build.build()
    build.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    # chip_smoke.py's phase 2 preset and phase 6 scene
    rc = RenderConfig(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=256,
                      max_samples_per_ray=32, grid_size=128, density_thresh=10.0, turbo=True,
                      coarse_candidates=96, crossing_slots=16, compact_mean_samples=6)
    nc = NetworkConfig(encoding="cpgrid", use_bf16=True,
                       cp_resolutions=(128, 256, 512, 1024, 2048), cp_rank=128,
                       cp_freq_degree=6)
    splits = make_synthetic_frames(n_train=16, n_val=1, n_test=0, H=400, W=400, seed=cs.SEED,
                                   device=dev)
    t0 = time.perf_counter()
    results = {}
    train_counts, frame_counts = cs.parallel_runs(dev, card, rc, nc, splits["train"],
                                                  splits["val"], results)
    cs.print_results(results, {}, card, set())
    print(f"phase 18: {time.perf_counter() - t0:.1f} s  [{card}]")
    print("train launches:", {k: v for k, v in train_counts.items() if v})
    print("frame launches:", {k: v for k, v in frame_counts.items() if v})


if __name__ == "__main__":
    main()
