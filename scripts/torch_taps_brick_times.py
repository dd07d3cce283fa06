#!/usr/bin/env python3
"""Time the train steps that sample factor taps or encode by the brick grid
(TensoRF, CCNeRF and ``--preset tpu``) of one tree of the PyTorch port on
one NVIDIA GPU, so that two trees (a parent and its change) can be
compared in one call on one card:

    python3 scripts/torch_taps_brick_times.py --tree <tree root> --scene <dir>

It builds that tree's kernels, then, on the scene (written there by
``make_synthetic_dataset`` if the directory is missing), runs
``main_tensoRF -O``, ``main_CCNeRF -O`` and ``main_nerf --preset tpu``,
each for ``--iters`` iterations, and on each trainer takes 2 warm-up
steps, ``--steps`` steps on the host clock (ending in a synchronize: wall
ms a step and rays/s) and 4 steps under ``chip_smoke.py:profile``
(device ms and launches a step, the idle share, and the device ms and
launches of the kernels whose names hold ``sample_taps``,
``scatter_taps``, ``brick_``, ``indexSelect``, ``indexFunc`` or
``elementwise``). On the TensoRF and CCNeRF trainers it then keeps the
largest call of one step's ``sample_taps_fwd`` and ``scatter_add_taps``
(factor or d factor in the layout that tree's models hold) and times each
kernel there, and on a rank-48 152^2 plane at 32,768 uniform points
(``chip_smoke.py:tap_points``), by ``chip_smoke.py:device_ms``. On the
``--preset tpu`` trainer it keeps one step's encoder call (points,
table, the output's cotangent) and times its forward and table gradient
by ``device_ms``, split into the forward, the zero fill and the table
gradient's kernels (``brick_table_grad``, or ``brick_encode_bwd`` and
``scatter_add_rows`` in a tree that makes the gradient through rows),
the forward + table gradient through autograd queued and between
back-to-back calls, the host's time to issue each part, ten forward +
table gradients under ``chip_smoke.py:profile`` (each kernel's and
fill's device ms, the idle share) and the peak memory of a train step. It
prints one JSON line per step kind, naming the tree and the card (name
and power limit). ``--runs`` picks the trainers (all three by default).
Run each tree in turn: parent, change, change, parent.
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
FOCUS = ("sample_taps", "scatter_taps", "brick_", "indexSelect", "indexFunc", "elementwise")


def largest_taps(cs, trainer, batches):
    """One train step with the tree's taps wrappers wrapped: the inputs of
    the largest (rows x samples) call of each, as the step passed them."""
    import torch

    from ngp_tpu_torch.ops.kernels import scatter as sk

    fwd, bwd = sk.sample_taps_fwd, sk.scatter_add_taps
    kept = {}

    def keep(name, size, args):
        if name not in kept or size > kept[name][0]:
            kept[name] = (size, args)

    def keep_fwd(factor, coords, align):
        keep("sample_taps_fwd", factor.shape[0] * coords.shape[0],
             (factor.clone(), cs.restride(coords, coords.stride()), align))
        return fwd(factor, coords, align)

    def keep_bwd(g, coords, out, align):
        keep("scatter_add_taps", g.numel(),
             (g.clone(), cs.restride(coords, coords.stride()), torch.zeros_like(out), align))
        return bwd(g, coords, out, align)

    sk.sample_taps_fwd, sk.scatter_add_taps = keep_fwd, keep_bwd
    try:
        trainer.step(next(batches))
    finally:
        sk.sample_taps_fwd, sk.scatter_add_taps = fwd, bwd
    return {name: args for name, (_, args) in kept.items()}


def taps_times(cs, trainer, batches, dev):
    """Device ms of the tree's two taps kernels on a step's largest calls
    and on the uniform plane, each factor in the layout the tree's wrapper
    takes (cell-major or row-major)."""
    import torch

    from ngp_tpu_torch.ops.kernels import scatter as sk

    out = {}
    for name, args in largest_taps(cs, trainer, batches).items():
        fn = getattr(sk, name)
        out[f"{name} step largest call"] = {
            "shape": [int(args[0].shape[0]), int(args[1].shape[0])],
            "device_ms": cs.device_ms(lambda: fn(*args))}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 14)
    xn = cs.tap_points(gen, dev, cs.TENSORF_RES, 4096 * 8)["uniform"]
    res, uv = cs.TENSORF_RES, xn[:, 0:2]
    plane = torch.randn((48, res, res), generator=gen, device=dev)
    try:
        factor = plane.movedim(0, -1).contiguous().movedim(-1, 0)
        sk.sample_taps_fwd(factor, uv, True)
    except ValueError:  # a tree whose kernels read row-major factors
        factor = plane
    g = torch.randn((48, uv.shape[0]), generator=gen, device=dev)
    d_factor = torch.zeros_like(factor)
    out["sample_taps_fwd uniform plane"] = {
        "device_ms": cs.device_ms(lambda: sk.sample_taps_fwd(factor, uv, True))}
    out["scatter_add_taps uniform plane"] = {
        "device_ms": cs.device_ms(lambda: sk.scatter_add_taps(g, uv, d_factor, True))}
    return out


def host_ms(fn, n=50):
    """The host clock of one call of ``fn``, over ``n`` calls that do not
    wait for the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e3


def brick_times(cs, trainer, batches, card):
    """The device ms of one step's brick encoder call's forward and table
    gradient, split into their parts, with the tree's own wrappers; the
    profile of ten forward + table gradients; a step's peak memory."""
    import torch

    from ngp_tpu_torch.models.encoders import BrickGridEncoder
    from ngp_tpu_torch.ops import brickgrid
    from ngp_tpu_torch.ops.kernels import scatter as sk

    kept, forward = {}, BrickGridEncoder.forward

    def keeping(self, x):
        out = forward(self, x)
        if out.requires_grad and "x" not in kept:
            kept.update(x=x.detach().reshape(-1, 3).float().contiguous().clone(), enc=self)
            out.register_hook(lambda g: kept.__setitem__(
                "g", g.detach().reshape(kept["x"].shape[0], -1).contiguous().clone()))
        return out

    BrickGridEncoder.forward = keeping
    try:
        trainer.step(next(batches))
    finally:
        BrickGridEncoder.forward = forward
    x, g, enc = kept["x"], kept["g"], kept["enc"]
    cfg, dt = enc.cfg, enc.compute_dtype
    table = enc.embeddings.detach().requires_grad_(True)
    shape = (cfg.num_rows, cfg.row_width)
    out = torch.zeros(shape, device=x.device)

    def fwd_and_grad():
        return torch.autograd.grad(brickgrid.brick_encode(x, table, cfg, dt), (table,), g)

    parts = {"forward": cs.device_ms(lambda: brickgrid.brick_encode_fwd(x, table, cfg, dt)),
             "zero fill": cs.device_ms(lambda: torch.zeros(shape, device=x.device))}
    if hasattr(brickgrid, "brick_table_grad"):
        parts["brick_table_grad"] = cs.device_ms(lambda: brickgrid.brick_table_grad(
            x, g, cfg, out))
        parts["zero fill + brick_table_grad"] = cs.device_ms(lambda: brickgrid.brick_table_grad(
            x, g, cfg, torch.zeros(shape, device=x.device)))
    idx, rows = brickgrid.brick_encode_bwd(x, g, cfg)
    parts["brick_encode_bwd"] = cs.device_ms(lambda: brickgrid.brick_encode_bwd(x, g, cfg))
    parts["scatter_add_rows"] = cs.device_ms(lambda: sk.scatter_add_rows(idx, rows, out))
    parts["zero fill + brick_encode_bwd + scatter_add_rows"] = cs.device_ms(
        lambda: sk.scatter_add_rows(*brickgrid.brick_encode_bwd(x, g, cfg),
                                    torch.zeros(shape, device=x.device)))
    del idx, rows
    parts["forward + table gradient, queued"] = cs.device_ms(fwd_and_grad)
    parts["forward + table gradient, back to back"] = cs.cuda_ms(fwd_and_grad)
    # the host's time to issue each part (a call's host clock over 50 calls
    # that wait for no device work)
    host = {"forward": host_ms(lambda: brickgrid.brick_encode_fwd(x, table, cfg, dt)),
            "zero fill": host_ms(lambda: torch.zeros(shape, device=x.device))}
    if hasattr(brickgrid, "brick_table_grad"):
        host["brick_table_grad"] = host_ms(lambda: brickgrid.brick_table_grad(x, g, cfg, out))
    else:
        host["brick_encode_bwd + scatter_add_rows"] = host_ms(
            lambda: sk.scatter_add_rows(*brickgrid.brick_encode_bwd(x, g, cfg), out))
    host["forward + table gradient"] = host_ms(fwd_and_grad)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        busy, launches, idle = cs.profile(fwd_and_grad, 10, "call", card)
    kernels = [ln.strip().split(None, 3) for ln in buf.getvalue().splitlines()
               if "ms/call" in ln]
    profiled = {"device_ms": busy, "launches": launches, "idle": idle,
                "by_name": [[float(k[0]), float(k[2].rstrip("x")), k[3][:90]] for k in kernels]}
    torch.cuda.reset_peak_memory_stats()
    trainer.step(next(batches))
    return {"points": int(x.shape[0]),
            "live": float((g.view(x.shape[0], cfg.num_levels, -1) != 0).any(-1).float().mean()),
            "device_ms": parts, "host_ms": host, "profile": profiled,
            "step_peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=ROOT, help="root of the tree whose port is timed")
    parser.add_argument("--scene", required=True,
                        help="the synthetic scene's directory (written there if missing)")
    parser.add_argument("--iters", type=int, default=80, help="iterations each main trains")
    parser.add_argument("--steps", type=int, default=16, help="steps timed on the host clock")
    parser.add_argument("--runs", nargs="+", default=["tensorf", "ccnerf", "brick"],
                        choices=["tensorf", "ccnerf", "brick"], help="the trainers to time")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_taps_brick_times: no CUDA device; this script runs on a GPU")
    # this script's own helpers (profile, the card line), whichever tree is timed
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ngp_tpu_torch import main_CCNeRF, main_nerf, main_tensoRF
    from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
    from ngp_tpu_torch.data.synthetic import make_synthetic_dataset
    from ngp_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    name = os.path.basename(tree.rstrip("/")) or tree
    t0 = time.perf_counter()
    build.build()
    build.load_library()
    print(f"[{name}] build {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    scene = os.path.abspath(args.scene)
    if not os.path.isdir(scene):
        make_synthetic_dataset(scene, n_train=40, n_val=4, n_test=8, device=dev)

    runs = (("tensorf_step", main_tensoRF.main, ["-O"], 0.33),
            ("ccnerf_step", main_CCNeRF.main, ["-O"], 0.8),
            ("brick_step", main_nerf.main, ["--preset", "tpu"], None))
    for what, run, flags, scale in runs:
        if what.split("_")[0] not in args.runs:
            continue
        with tempfile.TemporaryDirectory() as ws, contextlib.redirect_stdout(io.StringIO()):
            trainer = run([scene, *flags, "--workspace", ws, "--iters", str(args.iters)])
        kw = {} if scale is None else {"scale": scale}
        train_ds = NeRFDataset(scene, split="train", **kw)
        batches = itertools.chain.from_iterable(
            trainer.make_loader(train_ds)() for _ in itertools.count())
        for _ in range(2):
            trainer.step(next(batches))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(args.steps):
            trainer.step(next(batches))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) / args.steps
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
        print(json.dumps({"tree": name, "what": what, "wall_ms": wall * 1e3,
                          "rays_per_s": trainer.train_cfg.num_rays / wall, "device_ms": busy,
                          "launches": launches, "idle": idle, **focus, "card": card}),
              flush=True)
        if what != "brick_step":  # the factor taps' trainers
            print(json.dumps({"tree": name, "what": what.replace("step", "taps"),
                              **taps_times(cs, trainer, batches, dev), "card": card}),
                  flush=True)
        else:
            print(json.dumps({"tree": name, "what": "brick_encode",
                              **brick_times(cs, trainer, batches, card), "card": card}),
                  flush=True)
        del trainer, batches, train_ds
    print(f"[{name}] ok  [{card}]", flush=True)


if __name__ == "__main__":
    main()
