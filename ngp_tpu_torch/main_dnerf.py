"""D-NeRF (dynamic scene) training CLI of the port:
``python -m ngp_tpu_torch.main_dnerf``.

The same flags and defaults as the JAX package's ``main_dnerf.py`` (a copy
of its parser, pinned by ``tests/test_torch_dnerf.py``) and the same run:
the deformation network (``--basis``: the temporal basis, ``--hyper``: the
4-D hyper grid), the time-sliced occupancy grid (``--time_size`` slices),
the frames' times from the dataset; ``-O`` is the turbo march (at most 256
lattice steps, 32 samples a ray, a training budget of 8 a ray) with bf16
networks (as ``--fp16``). ``--synthetic`` writes the procedural scene with
its moving sphere (``dynamic=True``); training validates every
``eval_interval`` epochs, then ``evaluate`` scores the test split;
``--test`` loads ``--ckpt`` (the latest by default) and only evaluates. It
runs on the CUDA device; ``main`` takes ``device="cpu"`` from a caller (the
tests), no flag does. ``--gui`` (after the ``--test`` branch, as in JAX)
loads the checkpoint and serves the browser viewer, the scene time on
its ``[``/``]`` keys (``viewer_web.serve``); ``--cuda_ray``, ``--preload``
and ``--lr_net`` are accepted and change nothing, as in JAX.
"""

import argparse
import functools
from typing import Optional, Sequence

import torch

from ngp_tpu_torch.config import NetworkConfig, RenderConfig, TrainConfig
from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
from ngp_tpu_torch.models.dnerf import DNeRFBasisNetwork, DNeRFHyperNetwork, DNeRFNetwork
from ngp_tpu_torch.training.dnerf import DNeRFTrainer


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str)
    parser.add_argument("-O", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--workspace", type=str, default="workspace")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=30000)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--ckpt", type=str, default="latest")
    parser.add_argument("--num_rays", type=int, default=4096)
    parser.add_argument("--max_steps", type=int, default=1024)
    parser.add_argument("--update_extra_interval", type=int, default=16)
    parser.add_argument("--fp16", action="store_true")
    parser.add_argument("--basis", action="store_true", help="temporal-basis variant")
    parser.add_argument("--hyper", action="store_true", help="hyper (ambient-dim) variant")
    parser.add_argument("--cuda_ray", action="store_true", help="accelerated marching (TPU grid path; always on here)")
    parser.add_argument("--preload", action="store_true", help="no-op: data is always device-resident on TPU")
    parser.add_argument("--color_space", type=str, default="srgb", choices=["srgb", "linear"])
    parser.add_argument("--error_map", action="store_true")
    parser.add_argument("--max_ray_batch", type=int, default=4096)
    parser.add_argument("--lr_net", type=float, default=1e-3,
                        help="accepted for parity (single optax lr schedule)")
    parser.add_argument("--bg_radius", type=float, default=-1)
    parser.add_argument("--gui", action="store_true", help="serve the browser viewer")
    parser.add_argument("--W", type=int, default=800)
    parser.add_argument("--H", type=int, default=800)
    parser.add_argument("--radius", type=float, default=5.0)
    parser.add_argument("--fovy", type=float, default=50.0)
    parser.add_argument("--max_spp", type=int, default=64)
    parser.add_argument("--bound", type=float, default=2.0)
    parser.add_argument("--scale", type=float, default=0.33)
    parser.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    parser.add_argument("--dt_gamma", type=float, default=1 / 128)
    parser.add_argument("--min_near", type=float, default=0.2)
    parser.add_argument("--density_thresh", type=float, default=10)
    parser.add_argument("--time_size", type=int, default=64)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--downscale", type=int, default=1)
    parser.add_argument("--epochs", type=int, default=0)
    return parser


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> DNeRFTrainer:
    """Parse ``argv`` (the command line when None), run, and return the
    trainer."""
    opt = build_parser().parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ngp_tpu_torch.main_dnerf runs on a CUDA device, and none is "
                           "available")
    if opt.synthetic:
        from ngp_tpu_torch.data.synthetic import make_synthetic_dataset

        make_synthetic_dataset(opt.path, dynamic=True, device=device)

    # -O: the turbo march on per-slice payloads
    turbo = bool(opt.O)
    render_cfg = RenderConfig(
        bound=opt.bound, min_near=opt.min_near, density_thresh=opt.density_thresh,
        dt_gamma=opt.dt_gamma, max_steps=min(opt.max_steps, 256) if turbo else opt.max_steps,
        time_size=opt.time_size, bg_radius=opt.bg_radius, turbo=turbo,
        max_samples_per_ray=32 if turbo else 256, compact_mean_samples=8,
    )
    net_cfg = NetworkConfig(use_bf16=opt.fp16 or opt.O)
    train_cfg = TrainConfig(
        iters=opt.iters, lr=opt.lr, num_rays=opt.num_rays, seed=opt.seed,
        workspace=opt.workspace, update_extra_interval=opt.update_extra_interval,
        color_space=opt.color_space, error_map=opt.error_map,
    )
    if opt.hyper:
        cls = DNeRFHyperNetwork
    else:
        cls = DNeRFBasisNetwork if opt.basis else DNeRFNetwork
    model = cls(net_cfg, render_cfg, generator=torch.Generator().manual_seed(opt.seed),
                device=device)
    trainer = DNeRFTrainer(model, render_cfg, train_cfg, name="dnerf", seed=opt.seed,
                           use_tensorboard=True)

    dataset = functools.partial(NeRFDataset, opt.path, scale=opt.scale, offset=opt.offset,
                                downscale=opt.downscale)
    test_ds = dataset(split="test")
    if opt.test:
        trainer.load_checkpoint(None if opt.ckpt == "latest" else opt.ckpt)
        if test_ds.has_gt:
            trainer.evaluate(test_ds)
        return trainer

    train_ds = dataset(split="train", seed=opt.seed, color_space=opt.color_space)
    valid_ds = dataset(split="val", color_space=opt.color_space)
    trainer.max_ray_batch = opt.max_ray_batch
    if opt.gui:
        from ngp_tpu_torch.viewer import InteractiveSession
        from ngp_tpu_torch.viewer_web import serve

        trainer.load_checkpoint(None if opt.ckpt == "latest" else opt.ckpt)
        serve(InteractiveSession(trainer, train_ds, max_spp=opt.max_spp), W=opt.W, H=opt.H,
              radius=opt.radius, fovy=opt.fovy)
        return trainer
    max_epochs = opt.epochs or max(1, opt.iters // len(train_ds))
    trainer.train_on_dataset(train_ds, valid_ds, max_epochs=max_epochs)
    if test_ds.has_gt:
        trainer.evaluate(test_ds)
    return trainer


if __name__ == "__main__":
    main()
