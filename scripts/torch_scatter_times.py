#!/usr/bin/env python3
"""Time the row scatter-add and the paths that scatter (the brick grid's
table gradient, the TensoRF and CCNeRF train steps' factor taps) of one
tree of the PyTorch port on one NVIDIA GPU, so that two trees (a parent
and its change) can be compared in one call on one card:

    python3 scripts/torch_scatter_times.py --tree <tree root> --scene <dir>

It builds that tree's kernels, then prints one JSON line per measurement:

- ``scatter_add_rows`` at the probe script's shape (2,097,152 x 128 into
  16,384), hash level 0's (8,388,608 x 2 into 4,920) and the brick path's
  rows (the preset's 8 levels x 4, 399,268 rows of 108; 131,072 points of
  4096 rays x 32 samples, 10% of them with a zero cotangent, give
  1,048,576 rows; their cotangent from autograd through a copy of
  ``brick_encode``'s selects and weights): the rows as given (``layout``
  ``aligned``) and a copy one float into its buffer (``offset``: 4-byte
  aligned, which takes the kernel's per-row branch with scalar atomics),
  each with its CUDA-event ms between back-to-back calls (``ms``, 10
  calls after 2 warm-ups) and queued behind a sleep kernel
  (``device_ms``), its largest difference from the plain version,
  ``index_add_``'s ms and the bound (the indices and rows read, the table
  written once, at 3.35 TB/s);
- ``brick_encode``: the preset's forward + table gradient (bf16, as the
  ``--preset tpu`` path runs it) on those points, ms;
- ``tensorf_step`` / ``ccnerf_step``: ``main_tensoRF -O --iters 80`` and
  ``main_CCNeRF -O --iters 80`` on the scene (written there by
  ``make_synthetic_dataset`` if the directory is missing), then 4
  profiled train steps: device ms and launches a step, idle share, and
  the device ms and launches of ``index_add_`` (``indexFunc``),
  ``index_select`` (``indexSelect``) and the taps kernel
  (``scatter_taps``).

Run each tree in turn, parent, change, change, parent; every line names
the tree and the card (name and power limit).
"""

import argparse
import contextlib
import importlib.util
import io
import itertools
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOCUS = ("indexFunc", "indexSelect", "scatter_taps")


def brick_halo_cotangent(x, g, cfg, brickgrid):
    """(idx int32 [N * L], rows f32 [N * L, 27 C]): the table rows that
    ``brick_encode`` gathers for points x [N, 3] and their cotangent under
    the output cotangent g [N, L C], by autograd through its selects and
    weights with a leaf in place of the gathered rows."""
    import torch

    N, L, C = x.shape[0], cfg.num_levels, cfg.level_dim
    idx, frac, lo = [], [], []
    for level in range(L):
        pos = x * cfg.level_scale(level) + 0.5
        x0 = torch.floor(pos)
        frac.append(pos - x0)
        x0 = x0.long()
        lo.append(x0 & 1)
        idx.append(brickgrid._brick_index(cfg, level, x0 >> 1) + cfg.offsets[level])
    idx = torch.stack(idx, dim=1).reshape(-1).to(torch.int32)
    f, lo = torch.stack(frac, dim=1), torch.stack(lo, dim=1) == 1
    halo = torch.zeros((N, L, 3, 3, 3, C), device=x.device, requires_grad=True)

    def pick(t, axis, m):
        hi, low = t.narrow(axis, 1, 2), t.narrow(axis, 0, 2)
        return torch.where(m.reshape(m.shape + (1,) * (t.dim() - 2)), hi, low)

    s = pick(pick(pick(halo, 2, lo[..., 0]), 3, lo[..., 1]), 4, lo[..., 2])
    w = torch.stack([1.0 - f, f], dim=-1)
    wxyz = w[:, :, 0, :, None, None] * w[:, :, 1, None, :, None] * w[:, :, 2, None, None, :]
    out = (s * wxyz[..., None]).sum(dim=(2, 3, 4)).reshape(N, L * C)
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)
    out = torch.where(oob[:, None], torch.zeros((), device=x.device), out)
    (rows,) = torch.autograd.grad(out, halo, g)
    return idx, rows.reshape(N * L, 27 * C).contiguous()


def ray_points(gen, dev, rays=4096, samples=32):
    """Points of rays through the box, as a march places them: origins on a
    sphere about the centre, directions to the centre jittered, samples
    sqrt(3) / 256 apart from where the ray enters [0, 1]^3."""
    import torch

    o = torch.nn.functional.normalize(torch.randn((rays, 3), generator=gen), dim=-1) * 1.2
    d = torch.nn.functional.normalize(-o + 0.3 * torch.randn((rays, 3), generator=gen), dim=-1)
    o = o + 0.5
    t0 = torch.rand((rays, 1), generator=gen) * 0.8 + 0.4
    t = t0 + torch.arange(samples)[None, :] * (3**0.5 / 256)
    return (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3).contiguous().to(dev)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=ROOT, help="root of the tree whose port is timed")
    parser.add_argument("--scene", required=True,
                        help="the synthetic scene's directory (written there if missing)")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_scatter_times: no CUDA device; this script runs on a GPU")
    # this script's own helpers (timing, profile, bounds), whichever tree is timed
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ngp_tpu_torch import main_CCNeRF, main_tensoRF
    from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
    from ngp_tpu_torch.data.synthetic import make_synthetic_dataset
    from ngp_tpu_torch.ops import brickgrid
    from ngp_tpu_torch.ops.kernels import build
    from ngp_tpu_torch.ops.kernels import scatter as sk

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

    gen = torch.Generator().manual_seed(cs.SEED)
    cfg = brickgrid.BrickGridConfig(num_levels=8, level_dim=4, base_resolution=16,
                                    log2_hashmap_size=16, desired_resolution=4096)
    x = ray_points(gen, dev)
    g = torch.randn((x.shape[0], cfg.output_dim), generator=gen)
    g[torch.rand(x.shape[0], generator=gen) < 0.1] = 0.0
    g = g.to(dev)
    idx_b, rows_b = brick_halo_cotangent(x, g, cfg, brickgrid)
    shapes = []
    for M, R, W in cs.SCATTER_SHAPES:
        shapes.append((f"{M}x{W} into {R}", torch.randint(0, R, (M,), generator=gen,
                                                            dtype=torch.int32).to(dev),
                       torch.randn((M, W), generator=gen).to(dev), R))
    shapes.append((f"brick rows {idx_b.numel()}x{cfg.row_width} into {cfg.num_rows}", idx_b,
                   rows_b, cfg.num_rows))
    for label, idx, rows, R in shapes:
        W = rows.shape[1]
        out = torch.zeros((R, W), device=dev)
        want = sk.scatter_add_rows_plain(idx, rows, torch.zeros_like(out))
        idx_l = idx.long()
        lib_ms = cs.cuda_ms(lambda: out.index_add_(0, idx_l, rows))
        b_ms, b_by = cs.bound(cs.nbytes(idx, rows, out))
        zero4 = float((rows.view(rows.shape[0], W // 4, 4) == 0).all(-1).float().mean()) \
            if W % 4 == 0 else None
        for layout in ("aligned", "offset"):
            if layout == "offset":
                rows = torch.empty((rows.numel() + 1,), device=dev)[1:].view(rows.shape) \
                    .copy_(rows)
            got = sk.scatter_add_rows(idx, rows, torch.zeros_like(out))
            err = float((got - want).abs().max())
            ms = cs.cuda_ms(lambda: sk.scatter_add_rows(idx, rows, out))
            dev_ms = cs.device_ms(lambda: sk.scatter_add_rows(idx, rows, out))
            emit(what="scatter_add_rows", shape=label, layout=layout, ms=ms, device_ms=dev_ms,
                 max_abs_err=err, index_add_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                 distinct_rows=int(torch.unique(idx).numel()), zero_float4_share=zero4)
        del out, want, idx_l
    del shapes
    table = cfg.init(torch.Generator().manual_seed(cs.SEED), device=dev).requires_grad_()
    gb = g.to(torch.bfloat16)
    fb_ms = cs.cuda_ms(lambda: torch.autograd.grad(
        brickgrid.brick_encode(x, table, cfg, torch.bfloat16), (table,), gb))
    emit(what="brick_encode", points=x.shape[0], forward_and_table_gradient_ms=fb_ms)
    del table, idx_b, rows_b

    scene = os.path.abspath(args.scene)
    if not os.path.isdir(scene):
        make_synthetic_dataset(scene, n_train=40, n_val=4, n_test=8, device=dev)
    runs = (("tensorf_step", main_tensoRF.main, 0.33), ("ccnerf_step", main_CCNeRF.main, 0.8))
    for what, run, scale in runs:
        with tempfile.TemporaryDirectory() as ws, contextlib.redirect_stdout(io.StringIO()):
            trainer = run([scene, "-O", "--workspace", ws, "--iters", "80"])
        train_ds = NeRFDataset(scene, split="train", scale=scale)
        batches = itertools.chain.from_iterable(
            trainer.make_loader(train_ds)() for _ in itertools.count())
        for _ in range(2):
            trainer.step(next(batches))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            busy, launches, idle = cs.profile(lambda: trainer.step(next(batches)), 4, "step",
                                              card, focus=FOCUS)
        lines = buf.getvalue().splitlines()
        focus = {}
        for key in FOCUS:
            line = next(ln for ln in lines if ln.strip().startswith(key + ":"))
            ms, rest = line.split(":", 1)[1].split(" ms per step in ")
            focus[key] = {"ms": float(ms), "launches": int(rest.split(" launches")[0])}
        emit(what=what, device_ms=busy, launches=launches, idle=idle, **focus)
        del trainer, batches, train_ds
    print(f"[{name}] ok  [{card}]", flush=True)


if __name__ == "__main__":
    main()
