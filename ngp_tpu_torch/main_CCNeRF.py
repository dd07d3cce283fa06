"""CCNeRF training, compression and composition CLI of the port:
``python -m ngp_tpu_torch.main_CCNeRF``.

The same flags and defaults as the JAX package's ``main_CCNeRF.py`` (a
copy of its parser, pinned by ``tests/test_torch_ccnerf.py``) and the same
run: rank-residual training (``-O``: the turbo march, one march shared by
the K rank prefixes, at most 256 lattice steps and 32 samples a ray), then
``finalize`` and ``evaluate`` of the full rank on two test frames, each of
the three ``compress`` levels evaluated the same way, and with
``--compose`` a scene of the finalized model and a copy translated by 0.6
along x, rendered by ``test(write_video=True)``. ``--test`` loads
``--ckpt`` (the latest by default) instead of training; ``--gui`` loads
it and serves the browser viewer (``viewer_web.serve``) instead of all of
that. It runs on the CUDA device; ``main`` takes ``device="cpu"`` from a
caller (the tests), no flag does. ``--preload`` is accepted and changes
nothing.
"""

import argparse
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ngp_tpu_torch.config import RenderConfig, TrainConfig
from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
from ngp_tpu_torch.models.ccnerf import CCNeRF, CCNeRFConfig
from ngp_tpu_torch.training.ccnerf import CCNeRFTrainer

COMPRESS_RANKS = ((64, 16, 64, 64), (64, 8, 64, 16), (64, 2, 64, 4))


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str)
    parser.add_argument("-O", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--compose", action="store_true", help="demo: compose the trained object with a translated copy")
    parser.add_argument("--workspace", type=str, default="workspace")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=30000)
    parser.add_argument("--lr", type=float, default=2e-2)
    parser.add_argument("--ckpt", type=str, default="latest")
    parser.add_argument("--num_rays", type=int, default=4096)
    parser.add_argument("--max_steps", type=int, default=1024)
    parser.add_argument("--update_extra_interval", type=int, default=16)
    parser.add_argument("--bound", type=float, default=1.0)
    parser.add_argument("--scale", type=float, default=0.8)
    parser.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    parser.add_argument("--dt_gamma", type=float, default=0.0)
    parser.add_argument("--min_near", type=float, default=0.2)
    parser.add_argument("--density_thresh", type=float, default=10)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--preload", action="store_true", help="no-op: data is always device-resident on TPU")
    parser.add_argument("--color_space", type=str, default="srgb", choices=["srgb", "linear"])
    parser.add_argument("--error_map", action="store_true")
    parser.add_argument("--patch_size", type=int, default=1)
    parser.add_argument("--max_ray_batch", type=int, default=4096)
    parser.add_argument("--gui", action="store_true", help="serve the browser viewer")
    parser.add_argument("--W", type=int, default=800)
    parser.add_argument("--H", type=int, default=800)
    parser.add_argument("--radius", type=float, default=5.0)
    parser.add_argument("--fovy", type=float, default=50.0)
    parser.add_argument("--max_spp", type=int, default=64)
    parser.add_argument("--downscale", type=int, default=1)
    parser.add_argument("--epochs", type=int, default=0)
    return parser


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> CCNeRFTrainer:
    """Parse ``argv`` (the command line when None), run, and return the
    trainer of the finalized full-rank model."""
    opt = build_parser().parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ngp_tpu_torch.main_CCNeRF runs on a CUDA device, and none is "
                           "available")
    if opt.synthetic:
        from ngp_tpu_torch.data.synthetic import make_synthetic_dataset

        make_synthetic_dataset(opt.path, device=device)

    # -O: the turbo march, one march shared by every rank prefix
    turbo = bool(opt.O)
    render_cfg = RenderConfig(
        bound=opt.bound, min_near=opt.min_near, density_thresh=opt.density_thresh,
        dt_gamma=opt.dt_gamma, max_steps=min(opt.max_steps, 256) if turbo else opt.max_steps,
        turbo=turbo, max_samples_per_ray=32 if turbo else 256,
    )
    train_cfg = TrainConfig(
        iters=opt.iters, lr=opt.lr, num_rays=opt.num_rays, seed=opt.seed,
        workspace=opt.workspace, update_extra_interval=opt.update_extra_interval,
        color_space=opt.color_space, error_map=opt.error_map, patch_size=opt.patch_size,
    )
    model = CCNeRF(CCNeRFConfig(), bound=opt.bound,
                   generator=torch.Generator().manual_seed(opt.seed), device=device)
    trainer = CCNeRFTrainer(model, render_cfg, train_cfg, seed=opt.seed, use_tensorboard=True)
    trainer.max_ray_batch = opt.max_ray_batch
    dataset = functools.partial(NeRFDataset, opt.path, scale=opt.scale, offset=opt.offset,
                                downscale=opt.downscale, color_space=opt.color_space)
    if opt.gui:
        from ngp_tpu_torch.viewer import InteractiveSession
        from ngp_tpu_torch.viewer_web import serve

        trainer.load_checkpoint(None if opt.ckpt == "latest" else opt.ckpt)
        session = InteractiveSession(trainer, dataset(split="train", seed=opt.seed),
                                     max_spp=opt.max_spp)
        serve(session, W=opt.W, H=opt.H, radius=opt.radius, fovy=opt.fovy)
        return trainer
    test_ds = dataset(split="test")
    ckpt = None if opt.ckpt == "latest" else opt.ckpt
    if not opt.test:
        train_ds = dataset(split="train", seed=opt.seed)
        valid_ds = dataset(split="val")
        max_epochs = opt.epochs or max(1, opt.iters // len(train_ds))
        trainer.load_checkpoint(ckpt)
        trainer.train_on_dataset(train_ds, valid_ds, max_epochs=max_epochs)
    else:
        trainer.load_checkpoint(ckpt)

    # the full rank, finalized (the live weights, no EMA), then each
    # compression level
    fused = model.finalize(model.params())
    model.load_params(fused)
    trainer.ema = None
    if test_ds.has_gt:
        res = trainer.evaluate(test_ds, max_frames=2)
        trainer.log(f"finalized full-rank: PSNR {res['psnr']:.2f}")
    for ranks in COMPRESS_RANKS:
        small_model = CCNeRF(CCNeRFConfig(), bound=opt.bound, device=device)
        small_model.finalized = True
        small_model.cfg = model.cfg
        small_model.load_params(small_model.compress(fused, ranks))
        small_trainer = CCNeRFTrainer(small_model, render_cfg, train_cfg, seed=opt.seed)
        small_trainer.ensure_initialized()
        small_trainer.ema = None
        small_trainer.aux = trainer.aux
        if test_ds.has_gt:
            res = small_trainer.evaluate(test_ds, max_frames=2)
            small_trainer.log(f"compressed ranks={ranks}: PSNR {res['psnr']:.2f}")

    if opt.compose:
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.6  # a translated copy
        scene = CCNeRF(model.cfg, bound=opt.bound, device=device).compose(
            [(model, fused), (model, fused)], transforms=[None, (T, np.eye(3, dtype=np.float32))])
        scene_trainer = CCNeRFTrainer(scene, render_cfg, train_cfg, seed=opt.seed)
        scene_trainer.ensure_initialized()
        scene_trainer.aux = trainer.aux
        out = scene_trainer.test(test_ds, write_video=True)
        scene_trainer.log(f"composed scene rendered to {out}")
    return trainer


if __name__ == "__main__":
    main()
