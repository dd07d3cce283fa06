"""NeRF training CLI of the port: ``python -m ngp_tpu_torch.main_nerf``.

The same flags, defaults, choices and presets as the JAX package's
``main_nerf.py`` (``-O`` = bf16 + grid marching + the turbo-hq preset;
``-O --encoding hashgrid`` = the hash grid through the v1 march), and
the same run: ``--synthetic`` writes the procedural scene, the
transforms.json splits load from ``<path>``, ``GridNeRFTrainer`` (with
``-O`` / ``--cuda_ray``) or ``NeRFTrainer`` (the uniform + PDF renderer,
``--num_steps`` and ``--upsample_steps`` per ray) trains with validation
every ``eval_interval`` epochs and keeps the best checkpoint, ``--ckpt
latest`` resumes, then ``evaluate`` (with LPIPS when ``--lpips_weights``
names a local checkpoint) and ``test`` on the test split and, with
``--save_mesh``, the mesh; ``--test`` does only the last part from a
checkpoint. ``--bg_radius > 0`` adds the background net. It runs on the
CUDA device; ``main`` takes ``device="cpu"`` from a caller (the tests),
no flag does.

Flags whose path is not ported (``--gui``, ``--clip_model_path``, the
brick grid) raise ``NotImplementedError`` naming the ROADMAP item that
ports it; ``--ff``, ``--tcnn`` and ``--preload`` are accepted and change
nothing, as in JAX. The parser and ``resolve_opts``
are copies of ``main_nerf.py``'s (the port imports nothing of the JAX
side); ``tests/test_torch_dataset_cli.py`` pins them to it.
"""

import argparse
import functools
from typing import Optional, Sequence

import torch

from ngp_tpu_torch.config import NetworkConfig, RenderConfig, TrainConfig
from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
from ngp_tpu_torch.models.nerf import NeRFNetwork
from ngp_tpu_torch.training.nerf import NeRFTrainer
from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str)
    parser.add_argument("-O", action="store_true", help="recommended settings (bf16 + grid marching; TPU defaults)")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--workspace", type=str, default="workspace")
    parser.add_argument("--seed", type=int, default=0)
    # training
    parser.add_argument("--iters", type=int, default=30000)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--ckpt", type=str, default="latest")
    parser.add_argument("--num_rays", type=int, default=4096)
    parser.add_argument("--cuda_ray", action="store_true", help="accelerated occupancy-grid marching (TPU kernel path)")
    parser.add_argument("--max_steps", type=int, default=1024)
    parser.add_argument("--num_steps", type=int, default=512)
    parser.add_argument("--upsample_steps", type=int, default=0)
    parser.add_argument("--update_extra_interval", type=int, default=16)
    parser.add_argument("--max_ray_batch", type=int, default=4096)
    parser.add_argument("--patch_size", type=int, default=1)
    # network
    parser.add_argument("--fp16", action="store_true", help="bf16 mixed precision (TPU)")
    # dataset
    parser.add_argument("--color_space", type=str, default="srgb", choices=["srgb", "linear"],
                        help="'linear': train on linearized images, convert exports back to srgb")
    parser.add_argument("--tv_weight", type=float, default=0.0,
                        help="TV regulariser weight on dense grid-encoder levels")
    parser.add_argument("--distortion_weight", type=float, default=0.0,
                        help="distortion (EffDistLoss) weight on ray weights")
    parser.add_argument("--preload", action="store_true", help="no-op: data is always device-resident on TPU")
    parser.add_argument("--bound", type=float, default=2.0)
    parser.add_argument("--scale", type=float, default=0.33)
    parser.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    parser.add_argument("--dt_gamma", type=float, default=1 / 128)
    parser.add_argument("--min_near", type=float, default=0.2)
    parser.add_argument("--density_thresh", type=float, default=10)
    parser.add_argument("--bg_radius", type=float, default=-1)
    # experimental
    parser.add_argument("--error_map", action="store_true")
    parser.add_argument(
        "--error_map_size", type=int, default=128,
        help="coarse error-map resolution (use 256 at num_rays >= 16384: "
        "a 128^2 map is inert there — every cell gets drawn)",
    )
    parser.add_argument("--rand_pose", type=int, default=-1)
    parser.add_argument("--clip_text", type=str, default="",
                        help="CLIP guidance prompt for rand_pose mode; needs "
                             "--clip_model_path (local HF CLIP checkout)")
    parser.add_argument("--clip_model_path", type=str, default="",
                        help="local 'openai/clip-vit-base-patch16' checkout")
    # backbone selectors kept for CLI parity: there is ONE flax backbone
    parser.add_argument("--ff", action="store_true",
                        help="accepted for parity (single flax backbone on TPU)")
    parser.add_argument("--tcnn", action="store_true",
                        help="accepted for parity (single flax backbone on TPU)")
    # GUI (browser viewer; the reference's DearPyGui window flags)
    parser.add_argument("--gui", action="store_true", help="serve the browser viewer instead of batch training")
    parser.add_argument("--W", type=int, default=800, help="GUI render width")
    parser.add_argument("--H", type=int, default=800, help="GUI render height")
    parser.add_argument("--radius", type=float, default=5.0, help="GUI camera radius")
    parser.add_argument("--fovy", type=float, default=50.0, help="GUI camera fovy")
    parser.add_argument("--max_spp", type=int, default=64, help="GUI max SPP accumulation")
    parser.add_argument("--synthetic", action="store_true", help="generate the procedural test scene at <path> if missing")
    parser.add_argument("--synthetic_variant", type=str, default="default",
                        choices=["default", "hard"],
                        help="'hard': textured emission, 12 spheres, thin rods + torus")
    parser.add_argument(
        "--encoding", type=str, default=None,
        choices=["hashgrid", "tiledgrid", "brickgrid", "cpgrid", "frequency"],
        help="spatial encoding (default hashgrid; -O without an explicit "
             "choice selects the turbo-hq preset); 'cpgrid' is the TPU "
             "flagship (MXU-matmul CP factor banks, zero random memory "
             "access)",
    )
    parser.add_argument("--num_levels", type=int, default=16)
    parser.add_argument("--level_dim", type=int, default=2)
    parser.add_argument("--preset", type=str, default="", choices=["", "tpu", "turbo", "turbo-hq"],
                        help="'turbo-hq' (the -O default): rank-128 x 5-bank "
                             "cpgrid + matmul-march + sample compaction — "
                             "hash-class quality at ~1.9x the CUDA reference; "
                             "'turbo': rank-64 x 4-bank variant; "
                             "'tpu': round-1 brickgrid preset")
    parser.add_argument("--compact_mean_samples", type=int, default=None,
                        help="global train sample budget as mean samples/ray "
                             "(the reference's mean_count cap, "
                             "raymarching.py:198-203); turbo presets default "
                             "to 6 (measured quality-neutral vs 8/16 and "
                             "~1.2x/2x faster)")
    parser.add_argument("--cp_rank", type=int, default=64)
    parser.add_argument("--cp_freq_degree", type=int, default=5)
    parser.add_argument("--cp_resolutions", type=int, nargs="*",
                        default=[256, 512, 1024, 2048])
    parser.add_argument("--max_samples_per_ray", type=int, default=256,
                        help="static per-ray sample budget for the TPU marcher")
    parser.add_argument("--lpips_weights", type=str, default="",
                        help="local LPIPS (alex) torch .pth; when set, "
                             "evaluate/test also report LPIPS")
    parser.add_argument("--downscale", type=int, default=1)
    parser.add_argument("--epochs", type=int, default=0, help="override epoch count (default: iters / frames)")
    parser.add_argument("--save_mesh", action="store_true")
    return parser


def resolve_opts(opt):
    """Expand -O / --preset macro flags into concrete options (the
    reference's flag-interaction block, main_nerf.py:67-84)."""
    if opt.O:
        opt.fp16 = True
        opt.cuda_ray = True
        opt.preload = True
        # "-O = recommended settings" (main_nerf.py:67-70 in the
        # reference). On TPU the recommended path is the flagship
        # turbo-hq preset (hash-class quality at ~1.9x the CUDA
        # reference; works for dt_gamma>0 colmap captures too). An
        # explicit --preset/--encoding choice wins.
        if not opt.preset and opt.encoding is None:
            opt.preset = "turbo-hq"
    if opt.patch_size > 1:
        opt.error_map = False
        assert opt.num_rays % (opt.patch_size**2) == 0
    if opt.preset == "tpu":
        opt.fp16 = True
        opt.cuda_ray = True
        opt.encoding = "brickgrid"
        opt.num_levels = 8
        opt.level_dim = 4
        opt.max_steps = min(opt.max_steps, 256)
        opt.max_samples_per_ray = 32
    turbo = opt.preset in ("turbo", "turbo-hq")
    if turbo:
        opt.fp16 = True
        opt.cuda_ray = True
        opt.encoding = "cpgrid"
        opt.max_steps = min(opt.max_steps, 256)
        opt.max_samples_per_ray = 32
        if opt.compact_mean_samples is None:
            # measured (hard scene, 6k steps): mean 6 = mean 8 quality
            # (-0.03 dB, same SSIM) at 47 vs 39 steps/s; mean 16 is
            # slower AND slightly worse
            opt.compact_mean_samples = 6
    if opt.compact_mean_samples is None:
        opt.compact_mean_samples = 16  # config default (safe, no drops)
        # dt_gamma is NOT forced: the turbo march handles both the
        # uniform (dt_gamma=0, blender-style) and adaptive
        # (default 1/128, real colmap captures) lattices
    if opt.preset == "turbo-hq":
        # measured on the hard synthetic scene: 29.3 dB @ 6K steps =
        # brickgrid/hash-class quality at ~5x its step rate, still
        # 1.13x the CUDA reference throughput (rank 192 adds nothing)
        opt.cp_rank = 128
        opt.cp_freq_degree = 6
        opt.cp_resolutions = [128, 256, 512, 1024, 2048]
    if opt.encoding is None:
        opt.encoding = "hashgrid"
    opt.turbo = turbo
    return opt


def unported(opt) -> Optional[str]:
    """Why a resolved option set cannot run in the port, or None."""
    if opt.gui:
        return "--gui: the viewers are not ported yet (ROADMAP §1 item 4)"
    if opt.encoding == "brickgrid":
        return ("--encoding brickgrid / --preset tpu: the brick grid is not ported yet "
                "(ROADMAP §1 item 7)")
    if opt.clip_model_path:
        return "--clip_model_path: CLIP guidance is not ported yet (ROADMAP §1 item 9)"
    return None


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> NeRFTrainer:
    """Parse ``argv`` (the command line when None), run, and return the
    trainer."""
    opt = resolve_opts(build_parser().parse_args(argv))
    why = unported(opt)
    if why is not None:
        raise NotImplementedError(why)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ngp_tpu_torch.main_nerf runs on a CUDA device, and none is "
                           "available")

    if opt.synthetic:
        from ngp_tpu_torch.data.synthetic import make_synthetic_dataset

        make_synthetic_dataset(opt.path, variant=opt.synthetic_variant, device=device)

    render_cfg = RenderConfig(
        bound=opt.bound, min_near=opt.min_near, density_thresh=opt.density_thresh,
        bg_radius=opt.bg_radius, num_steps=opt.num_steps, upsample_steps=opt.upsample_steps,
        dt_gamma=opt.dt_gamma, max_steps=opt.max_steps,
        max_samples_per_ray=min(opt.max_samples_per_ray, opt.max_steps), turbo=opt.turbo,
        compact_mean_samples=opt.compact_mean_samples,
    )
    net_cfg = NetworkConfig(
        encoding=opt.encoding, num_levels=opt.num_levels, level_dim=opt.level_dim,
        use_bf16=opt.fp16, cp_rank=opt.cp_rank, cp_freq_degree=opt.cp_freq_degree,
        cp_resolutions=tuple(opt.cp_resolutions),
    )
    train_cfg = TrainConfig(
        iters=opt.iters, lr=opt.lr, num_rays=opt.num_rays, error_map=opt.error_map,
        error_map_size=opt.error_map_size, patch_size=opt.patch_size,
        rand_pose=opt.rand_pose, seed=opt.seed, workspace=opt.workspace, ckpt=opt.ckpt,
        update_extra_interval=opt.update_extra_interval, tv_weight=opt.tv_weight,
        distortion_weight=opt.distortion_weight, color_space=opt.color_space,
    )
    model = NeRFNetwork(net_cfg, render_cfg, torch.Generator().manual_seed(opt.seed),
                        device=device)
    trainer_cls = GridNeRFTrainer if opt.cuda_ray else NeRFTrainer
    trainer = trainer_cls(model, render_cfg, train_cfg, seed=opt.seed)
    trainer.max_ray_batch = opt.max_ray_batch
    if opt.lpips_weights:
        trainer.lpips_weights = opt.lpips_weights
    ckpt = None if opt.ckpt == "latest" else opt.ckpt
    dataset = functools.partial(NeRFDataset, opt.path, scale=opt.scale, offset=opt.offset,
                                downscale=opt.downscale, color_space=opt.color_space)

    if not opt.test:
        train_ds = dataset(split="train", error_map=opt.error_map, seed=opt.seed)
        if opt.rand_pose >= 0:
            from ngp_tpu_torch.training.clip_guidance import GradientImageLoss

            print("[warn] no --clip_model_path: using the stand-in GradientImageLoss for "
                  "guidance steps")
            trainer.guidance_loss = GradientImageLoss(opt.clip_text)
        valid_ds = dataset(split="val")
        max_epochs = opt.epochs or max(1, opt.iters // len(train_ds))
        trainer.load_checkpoint(ckpt)
        trainer.train_on_dataset(train_ds, valid_ds, max_epochs=max_epochs)
    else:
        trainer.load_checkpoint(ckpt)

    test_ds = dataset(split="test")
    if test_ds.has_gt:
        trainer.evaluate(test_ds)
    trainer.test(test_ds)
    if opt.save_mesh:
        trainer.save_mesh(threshold=opt.density_thresh)
    return trainer


if __name__ == "__main__":
    main()
