"""TensoRF training CLI of the port: ``python -m ngp_tpu_torch.main_tensoRF``.

The same flags and defaults as the JAX package's ``main_tensoRF.py`` (a
copy of its parser, pinned by ``tests/test_torch_tensorf.py``;
``--upsample_model_steps`` appends to its default list, as there), and
the same run: the VM decomposition (``--cp``: CP) with the L1 sparsity
term, two learning rates, the shrink and progressive upsample;
``-O`` sets ``--fp16`` (which the model ignores, as in JAX),
``--cuda_ray``, the turbo march with 32 samples a ray and a training
budget of 8 (``compact_mean_samples``), and ``max_steps <= 256``.
``--synthetic`` writes the procedural scene; the transforms.json splits
load from ``<path>``; ``TensoRFTrainer`` trains with validation every
``eval_interval`` epochs, then ``evaluate`` and ``test`` on the test
split; ``--test`` loads ``--ckpt`` (the latest by default) and does only
the last part; ``--gui`` loads the checkpoint and serves the browser
viewer (``viewer_web.serve``) instead. It runs on the CUDA device;
``main`` takes ``device="cpu"`` from a caller (the tests), no flag does.
``--preload`` is accepted and changes nothing.
"""

import argparse
import functools
from typing import Optional, Sequence

import torch

from ngp_tpu_torch.config import RenderConfig, TrainConfig
from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
from ngp_tpu_torch.models.tensorf import TensoRFCPNetwork, TensoRFNetwork
from ngp_tpu_torch.training.tensorf import TensoRFTrainer


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str)
    parser.add_argument("-O", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--workspace", type=str, default="workspace")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=30000)
    parser.add_argument("--lr0", type=float, default=2e-2, help="lr for decomposition factors")
    parser.add_argument("--lr1", type=float, default=1e-3, help="lr for networks")
    parser.add_argument("--ckpt", type=str, default="latest")
    parser.add_argument("--num_rays", type=int, default=4096)
    parser.add_argument("--cuda_ray", action="store_true")
    parser.add_argument("--max_steps", type=int, default=1024)
    parser.add_argument("--update_extra_interval", type=int, default=16)
    parser.add_argument("--l1_reg_weight", type=float, default=1e-4)
    parser.add_argument("--fp16", action="store_true")
    parser.add_argument("--cp", action="store_true", help="use the CP decomposition")
    parser.add_argument("--resolution0", type=int, default=128)
    parser.add_argument("--resolution1", type=int, default=300)
    parser.add_argument("--upsample_model_steps", type=int, action="append",
                        default=[2000, 3000, 4000, 5500, 7000])
    parser.add_argument("--bound", type=float, default=2.0)
    parser.add_argument("--scale", type=float, default=0.33)
    parser.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    parser.add_argument("--dt_gamma", type=float, default=1 / 128)
    parser.add_argument("--min_near", type=float, default=0.2)
    parser.add_argument("--density_thresh", type=float, default=10)
    parser.add_argument("--bg_radius", type=float, default=-1)
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


def resolve_opts(opt):
    """``-O`` = the recommended settings (reference main_tensoRF.py:107-110):
    fp16, cuda_ray and the turbo march; returns ``opt`` with ``turbo``."""
    opt.turbo = False
    if opt.O:
        opt.fp16 = True
        opt.cuda_ray = True
        opt.turbo = True
        opt.max_steps = min(opt.max_steps, 256)
    return opt


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> TensoRFTrainer:
    """Parse ``argv`` (the command line when None), run, and return the
    trainer."""
    opt = resolve_opts(build_parser().parse_args(argv))
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ngp_tpu_torch.main_tensoRF runs on a CUDA device, and none is "
                           "available")
    if opt.synthetic:
        from ngp_tpu_torch.data.synthetic import make_synthetic_dataset

        make_synthetic_dataset(opt.path, device=device)

    render_cfg = RenderConfig(
        bound=opt.bound, min_near=opt.min_near, density_thresh=opt.density_thresh,
        bg_radius=opt.bg_radius, dt_gamma=opt.dt_gamma, max_steps=opt.max_steps,
        turbo=opt.turbo, max_samples_per_ray=32 if opt.turbo else 256,
        compact_mean_samples=8,
    )
    train_cfg = TrainConfig(
        iters=opt.iters, lr=opt.lr0, num_rays=opt.num_rays, seed=opt.seed,
        workspace=opt.workspace, update_extra_interval=opt.update_extra_interval,
        color_space=opt.color_space, error_map=opt.error_map, patch_size=opt.patch_size,
    )
    r0 = opt.resolution0
    g = torch.Generator().manual_seed(opt.seed)
    if opt.cp:
        model = TensoRFCPNetwork(resolution=(r0, r0, r0), generator=g, device=device)
    else:
        model = TensoRFNetwork(resolution=(r0, r0, r0), bg_radius=opt.bg_radius, generator=g,
                               device=device)
    trainer = TensoRFTrainer(
        model, render_cfg, train_cfg, lr_net=opt.lr1, l1_reg_weight=opt.l1_reg_weight,
        upsample_model_steps=opt.upsample_model_steps, resolution0=opt.resolution0,
        resolution1=opt.resolution1, seed=opt.seed, use_tensorboard=True,
    )
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
    if opt.test:
        trainer.load_checkpoint(None if opt.ckpt == "latest" else opt.ckpt)
    else:
        train_ds = dataset(split="train", seed=opt.seed)
        valid_ds = dataset(split="val")
        max_epochs = opt.epochs or max(1, opt.iters // len(train_ds))
        trainer.train_on_dataset(train_ds, valid_ds, max_epochs=max_epochs)
    if test_ds.has_gt:
        trainer.evaluate(test_ds)
    trainer.test(test_ds)
    return trainer


if __name__ == "__main__":
    main()
