#!/usr/bin/env python3
"""Time the CP heads of one tree of the PyTorch port on one NVIDIA GPU, f32
and bf16, so that two trees (a parent and its change) can be compared in
one call on one card:

    python3 scripts/torch_cp_f32_times.py --tree <tree root>

It builds that tree's kernels, then prints one JSON line per shape, on
turbo-hq's widths (5 banks of rank 128 at 128-2048, frequency degree 6,
sigma 679-64-16, colour 31-64-64-3) with random weights from a seed (the
same in every tree) and random rows (25% outside the box for the density
head): ``cp_density_fwd`` at 131,072 rows (a refresh chunk), with
residuals at 98,304 (a turbo-hq train step) and 2,097,152 (a step of
``main_nerf --encoding cpgrid`` without ``-O``), and ``cp_sigma_rgb`` at
24,576 rows (an eval chunk). Each line holds the kernel's device time
(``chip_smoke.py:device_ms``: 20 calls queued behind a sleep kernel, so
no host time between them), its CUDA-event time of back-to-back calls
(``cuda_ms``), the route counts of one call, the largest difference from
the plain version and the bound (``chip_smoke.py:density_work`` /
``sigma_rgb_work``), and a digest of the outputs' bytes (equal digests:
bit-equal outputs).

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
RES, RANK, FD, H1, OUT, SH, HIDDEN = (128, 256, 512, 1024, 2048), 128, 6, 64, 16, 4, (64, 64)
# (head, rows, residuals)
SHAPES = (("cp_density_fwd", 131_072, False), ("cp_density_fwd", 98_304, True),
          ("cp_sigma_rgb", 24_576, False), ("cp_density_fwd", 2_097_152, True))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=ROOT, help="root of the tree whose port is timed")
    tree = os.path.abspath(parser.parse_args().tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_cp_f32_times: no CUDA device; this script runs on a GPU")
    # this script's own helpers (timing, work, weights), whichever tree is timed
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ngp_tpu_torch.ops.kernels import LAUNCHES, build, cp

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    name = os.path.basename(tree.rstrip("/")) or tree
    t0 = time.perf_counter()
    build.build()
    build.load_library()
    print(f"[{name}] build {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    D = len(RES) * RANK + 3 * (1 + 2 * FD)
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        factors = tuple((torch.randn((3, r, RANK), generator=gen, device=dev) * 0.2).to(dtype)
                        for r in RES)
        w1, w2, color = cs.head_weights(gen, dev, dtype, D, H1, OUT, SH, HIDDEN)
        for head, M, resid in SHAPES:
            pos = torch.rand((M, 3), generator=gen, device=dev)
            if head == "cp_density_fwd":
                pos = pos * 1.1 - 0.05

                def kernel():
                    return cp.cp_density_fwd(pos, factors, w1, w2, RES, FD, residuals=resid)

                def plain():
                    return cp.cp_density_plain(pos, factors, w1, w2, RES, FD, residuals=resid)

                work = cs.density_work(pos, factors, w1, w2, residuals=resid)
            else:
                dirs = torch.nn.functional.normalize(
                    torch.randn((M, 3), generator=gen, device=dev), dim=-1)

                def kernel():
                    return cp.cp_sigma_rgb(pos, dirs, factors, w1, w2, color, RES, FD, SH)

                def plain():
                    return cp.cp_sigma_rgb_plain(pos, dirs, factors, w1, w2, color, RES, FD, SH)

                work = cs.sigma_rgb_work(pos, dirs, factors, w1, w2, color)
            before = dict(LAUNCHES)
            got = kernel()
            torch.cuda.synchronize()
            routes = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                      if k.startswith(head) and v != before.get(k, 0)}
            got = got if isinstance(got, tuple) else (got,)
            want = plain()
            want = want if isinstance(want, tuple) else (want,)
            err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
            digest = hashlib.sha256()
            for a in got:
                digest.update(a.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            del got, want
            b_ms, b_by = cs.bound(*work)
            print(json.dumps({
                "tree": name, "head": head + "+residuals" * resid, "dtype": str(dtype)[6:],
                "rows": M, "device_ms": cs.device_ms(kernel), "cuda_ms": cs.cuda_ms(kernel),
                "routes": routes, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
                "digest": digest.hexdigest()[:16], "card": card}), flush=True)
            del pos


if __name__ == "__main__":
    main()
