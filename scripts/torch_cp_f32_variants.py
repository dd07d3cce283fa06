#!/usr/bin/env python3
"""Where the f32 CP heads' time goes on one NVIDIA GPU: build variants of
one tree's ``cp_kernels.cu`` that each leave one part of the 3xTF32 kernels
out, and time the f32 heads of each in turn:

    python3 scripts/torch_cp_f32_variants.py [--tree <root>] [--work <dir>]

The variants (each a copy of the tree under ``--work``, its source edited):

- ``as is``: the tree unchanged;
- ``no K-loop products``: the tile loop makes every K chunk (gathers, w1's
  rows, the residual stores) but multiplies none, so h1 is zero;
- ``no gathers``: every row's CP features are zero without a load (w1's
  rows, the frequency columns and the products stay);
- ``64-row tiles``: tiles of 64 rows where ``tc_rows`` gives 128.

For each it prints one JSON line: ``device_ms`` (``chip_smoke.py``: 20
calls queued behind a sleep kernel) of ``cp_density_fwd`` at 131,072
rows, with residuals at 98,304 and ``cp_sigma_rgb`` at 24,576 (turbo-hq's
widths, random weights and rows from a seed, as
``scripts/torch_cp_f32_times.py``), and the card's name and power limit.
Only the ``as is`` outputs are right; the others time a part.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("ngp_tpu_torch", "ops", "kernels", "csrc", "cp_kernels.cu")
VARIANTS = {
    "as is": [],
    "no K-loop products": [(
        "    if (nth > 0)\n      x3_mma_chunk(", "    if (nth < 0)\n      x3_mma_chunk(")],
    "no gathers": [(
        "if (4 * g < c.kc) gather4_load(p, c.seg, r, c.c0 + 4 * g, vec, S.g[j]);",
        "if (4 * g < c.kc) S.g[j].live = false;")],
    "64-row tiles": [(
        "int x3_route(const HeadParams& p, int* kc) {\n  const int rows = tc_rows(p.H1);",
        "int x3_route(const HeadParams& p, int* kc) {\n"
        "  const int rows = tc_rows(p.H1) == 128 ? 64 : tc_rows(p.H1);")],
}

TIMER = r"""
import importlib.util, json, sys
import torch
spec = importlib.util.spec_from_file_location("smoke", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from ngp_tpu_torch.ops.kernels import build, cp
build.build()
build.load_library()
dev = torch.device("cuda", 0)
RES, RANK, FD, H1, OUT = (128, 256, 512, 1024, 2048), 128, 6, 64, 16
D = len(RES) * RANK + 3 * (1 + 2 * FD)
gen = torch.Generator(device=dev).manual_seed(cs.SEED)
f = tuple(torch.randn((3, r, RANK), generator=gen, device=dev) * 0.2 for r in RES)
w1, w2, color = cs.head_weights(gen, dev, torch.float32, D, H1, OUT, 4, (64, 64))
pos = torch.rand((131_072, 3), generator=gen, device=dev) * 1.1 - 0.05
pr = torch.rand((24_576, 3), generator=gen, device=dev)
dirs = torch.nn.functional.normalize(torch.randn((24_576, 3), generator=gen, device=dev), dim=-1)
print(json.dumps({
    "variant": sys.argv[1],
    "density_ms": cs.device_ms(lambda: cp.cp_density_fwd(pos, f, w1, w2, RES, FD)),
    "residuals_ms": cs.device_ms(
        lambda: cp.cp_density_fwd(pos[:98_304], f, w1, w2, RES, FD, residuals=True)),
    "radiance_ms": cs.device_ms(
        lambda: cp.cp_sigma_rgb(pr, dirs, f, w1, w2, color, RES, FD, 4)),
    "card": cs.card_line()}), flush=True)
"""


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=ROOT, help="root of the tree whose kernels are varied")
    parser.add_argument("--work", default=os.path.join(ROOT, "tree_check", "cp_f32_variants"),
                        help="directory for the variant copies (git-ignored)")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    text = open(os.path.join(tree, SOURCE)).read()
    shutil.rmtree(args.work, ignore_errors=True)
    dirs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"torch_cp_f32_variants: {name!r} does not apply to {tree}")
            src = src.replace(old, new)
        d = os.path.join(args.work, str(i))
        shutil.copytree(os.path.join(tree, "ngp_tpu_torch"), os.path.join(d, "ngp_tpu_torch"),
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        with open(os.path.join(d, SOURCE), "w") as fh:
            fh.write(src)
        dirs[name] = d
    # build every variant at once: nvcc runs a process per source
    builds = [subprocess.Popen([sys.executable, "-c", "from ngp_tpu_torch.ops.kernels import "
                                "build; build.build()"], cwd=d) for d in dirs.values()]
    if any(b.wait() != 0 for b in builds):
        raise SystemExit("torch_cp_f32_variants: a variant did not build")
    smoke = os.path.join(ROOT, "chip_smoke.py")
    for _ in range(2):
        for name, d in dirs.items():
            subprocess.run([sys.executable, "-c", TIMER, name, smoke], cwd=d, check=True,
                           timeout=300)


if __name__ == "__main__":
    main()
