#!/usr/bin/env python3
"""Time the eval prepass and the grid encoder's x-gradient of one tree of
the PyTorch port on one NVIDIA GPU, so that two trees (a parent and its
change) can be compared in one call on one card:

    python3 scripts/torch_prepass_bwd_x_times.py --tree <tree root>

It builds that tree's kernels, then prints one JSON line per measurement:

- ``ray_prepass``: ``occupancy.ray_prepass`` on a 65,536-ray chunk of an
  800x800 frame (the eval prepass's chunk) of an occupancy grid at grid
  128 (a ball about the centre and random cells), bound 1 (one cascade)
  and bound 2 (two): device launches and device ms a call
  (``torch.profiler`` over 20 calls), its device time queued
  (``device_ms``) and its wall time with a device sync (mean of 20
  calls);
- ``frame``: one 800x800 frame of the turbo-hq network on random weights
  from a seed (16 grid refreshes first, one unprofiled frame): device
  launches, device ms, idle share and wall of one profiled frame;
- ``grid_encode_bwd_x``: the x-gradient on D-NeRF's grids (D = 3: 16
  levels x 2, 2^19 rows, finest 4096; D = 4 the hyper grid) at 32,768
  points (a train step's, 25% zero cotangent rows) and 262,144 random
  points (25% outside the box), f32 and bf16 cotangent: CUDA-event ms of
  one call (10 calls after 2 warm-ups), its device time (``device_ms``:
  20 calls queued behind a sleep kernel, so no host time between them)
  and a digest of dx's bytes (equal digests: bit-equal gradients).

Run each tree in turn, parent, change, change, parent; every line names
the tree and the card (name and power limit).
"""

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=ROOT, help="root of the tree whose port is timed")
    tree = os.path.abspath(parser.parse_args().tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_prepass_bwd_x_times: no CUDA device; this script runs on a GPU")
    # this script's own helpers (timing, profile, poses), whichever tree is timed
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ngp_tpu_torch.config import NetworkConfig, RenderConfig
    from ngp_tpu_torch.models import occupancy
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.ops.hashgrid import GridConfig
    from ngp_tpu_torch.ops.kernels import build
    from ngp_tpu_torch.ops.kernels import hashgrid as hk
    from ngp_tpu_torch.data.raysampler import rays_from_frame_indices
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    name = os.path.basename(tree.rstrip("/")) or tree
    t0 = time.perf_counter()
    build.build()
    build.load_library()
    print(f"[{name}] build {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)

    def emit(**kw):
        print(json.dumps({"tree": name, **kw, "card": card}), flush=True)

    def quiet_profile(fn, n):
        """(device ms, device launches, idle share) a call, over n calls."""
        import contextlib
        import io

        with contextlib.redirect_stdout(io.StringIO()):
            return cs.profile(fn, n, "call", card)

    gen = torch.Generator().manual_seed(cs.SEED)
    # the prepass on a 65,536-ray chunk of an 800x800 frame, bound 1 and 2
    for bound in (1.0, 2.0):
        rc = RenderConfig(bound=bound, min_near=0.05, dt_gamma=0.0, max_steps=256,
                          max_samples_per_ray=32, grid_size=128, turbo=True)
        # a ball of radius 0.35 about the centre, as a trained object fills the
        # grid, with one cell in 10^4 occupied at random besides
        u = (torch.arange(128) + 0.5) / 64 - 1.0
        r = torch.stack(torch.meshgrid(u, u, u, indexing="ij")).norm(dim=0)
        occ = torch.stack([r * min(2.0**c, bound) < 0.35 for c in range(rc.cascades)])
        occ = (occ | (torch.rand(occ.shape, generator=gen) < 1e-4)).to(dev)
        state = occupancy.init_occupancy(rc, dev)
        state.prepass_payload = occupancy.pack_prepass_payload(occ)
        inds = torch.arange(65536, device=dev) * 9 % (cs.FRAME * cs.FRAME)
        rays = rays_from_frame_indices(
            torch.as_tensor(cs.orbit_pose(0.7)[None], device=dev),
            torch.as_tensor(cs.intrinsics(cs.FRAME), device=dev), cs.FRAME, cs.FRAME, inds,
            torch.zeros_like(inds))
        if bound > 1.0:  # cameras inside the box, as at bound 2 and scale 0.33
            rays["rays_o"] = rays["rays_o"] * 0.5
        aabb = torch.tensor(rc.aabb, device=dev)

        def call():
            return occupancy.ray_prepass(rays["rays_o"], rays["rays_d"], state, rc, aabb=aabb)

        out = call()
        hits = int(out["hit"].sum())
        # 20 calls a session: a session of one kernel's launch can come back
        # empty from the profiler
        busy, launches, _ = quiet_profile(call, 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 20 * 1e3
        emit(what="ray_prepass", bound=bound, cascades=rc.cascades, rays=65536, hit=hits,
             launches=launches, device_ms=busy, queued_ms=cs.device_ms(call), wall_ms=wall)
        del state, rays, out

    # one 800x800 frame of the turbo-hq network on random weights
    rc = RenderConfig(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=256,
                      max_samples_per_ray=32, grid_size=128, density_thresh=10.0, turbo=True,
                      coarse_candidates=96, crossing_slots=16, compact_mean_samples=6)
    nc = NetworkConfig(encoding="cpgrid", use_bf16=True,
                       cp_resolutions=(128, 256, 512, 1024, 2048), cp_rank=128,
                       cp_freq_degree=6)
    model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(cs.SEED)).to(dev)
    trainer = GridNeRFTrainer(model, rc, seed=cs.SEED)
    for _ in range(16):
        trainer._update_occupancy()
    pose, intr = cs.orbit_pose(0.7), cs.intrinsics(cs.FRAME)
    trainer.render_frame(pose, intr, cs.FRAME, cs.FRAME)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    busy, launches, idle = quiet_profile(lambda: trainer.render_frame(pose, intr, cs.FRAME,
                                                                       cs.FRAME), 1)
    emit(what="frame", size=cs.FRAME, launches=launches, device_ms=busy, idle=idle,
         profiled_wall_ms=(time.perf_counter() - t0) * 1e3)
    del trainer, model

    # the x-gradient on D-NeRF's grids
    for D in (3, 4):
        cfg = GridConfig(input_dim=D, log2_hashmap_size=19, desired_resolution=4096)
        geom = cfg.geometry
        table = (torch.rand((cfg.num_rows, cfg.level_dim), generator=gen) * 2 - 1).to(dev)
        for B in (32768, 262144):
            x = torch.rand((B, D), generator=gen)
            out = torch.rand(B, generator=gen) < 0.25
            if B == 32768:
                x = x * 0.5 + 0.25  # a step's points, inside the box
            else:
                x[out, 0] = 1.01 + 0.2 * x[out, 0]
            x = x.contiguous().to(dev)
            g = torch.randn((B, geom.output_dim), generator=gen)
            if B == 32768:
                g[out] = 0.0
            for gd in (torch.float32, torch.bfloat16):
                gg = g.to(dev, gd)
                ms = cs.cuda_ms(lambda: hk.grid_encode_bwd_x(x, table, gg, geom))
                dev_ms = cs.device_ms(lambda: hk.grid_encode_bwd_x(x, table, gg, geom))
                dx = hk.grid_encode_bwd_x(x, table, gg, geom)
                digest = hashlib.sha256(dx.cpu().numpy().tobytes()).hexdigest()[:16]
                emit(what="grid_encode_bwd_x", D=D, points=B, g=str(gd).split(".")[-1], ms=ms,
                     device_ms=dev_ms, dx_sha256=digest, finite=bool(torch.isfinite(dx).all()))
    print(f"[{name}] ok  [{card}]", flush=True)


if __name__ == "__main__":
    main()
