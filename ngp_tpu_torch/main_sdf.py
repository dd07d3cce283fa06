"""SDF training CLI of the port: ``python -m ngp_tpu_torch.main_sdf``.

The same flags and defaults as the JAX package's ``main_sdf.py`` (a
copy of its parser, pinned by ``tests/test_torch_sdf.py``), and the same
run: the mesh at ``path`` (``.obj`` / ``.ply``), or ``sphere`` for a
procedural icosphere (subdivision 5, 20,480 faces); 100 batches of
``--num_samples`` points an epoch and one validation batch from the next
seed; ``SDFTrainer`` resumes from the latest checkpoint, trains
``--epochs`` epochs (``--test`` skips training) and writes the
marching-tetrahedra mesh at ``--mesh_resolution``^3 to
``<workspace>/meshes/ngp_sdf_<epoch>.obj``. It runs on the CUDA
device; ``main`` takes ``device="cpu"`` from a caller (the tests), no
flag does. ``--ff`` and ``--tcnn`` are accepted and change nothing, as
in JAX.
"""

import argparse
from typing import Optional, Sequence

import torch

from ngp_tpu_torch.data.mesh import icosphere
from ngp_tpu_torch.data.sdf_dataset import SDFDataset
from ngp_tpu_torch.models.sdf import SDFNetwork
from ngp_tpu_torch.training.sdf import SDFTrainer


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("path", help="mesh file (.obj/.ply), or 'sphere' for a procedural test mesh")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--workspace", type=str, default="workspace")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--fp16", action="store_true", help="bf16 mixed precision (TPU)")
    parser.add_argument("--ff", action="store_true", help="accepted for parity (single flax backbone on TPU)")
    parser.add_argument("--tcnn", action="store_true", help="accepted for parity (single flax backbone on TPU)")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--num_samples", type=int, default=2**18)
    parser.add_argument("--clip_sdf", type=float, default=None)
    parser.add_argument("--mesh_resolution", type=int, default=256)
    return parser


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> SDFTrainer:
    """Parse ``argv`` (the command line when None), run, and return the
    trainer."""
    opt = build_parser().parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ngp_tpu_torch.main_sdf runs on a CUDA device, and none is "
                           "available")
    model = SDFNetwork(clip_sdf=opt.clip_sdf, use_bf16=opt.fp16,
                       generator=torch.Generator().manual_seed(opt.seed), device=device)
    if opt.path == "sphere":
        v, f = icosphere(subdiv=5, radius=1.0)
        kw = {"vertices": v, "faces": f}
    else:
        kw = {"path": opt.path}
    train_ds = SDFDataset(size=100, num_samples=opt.num_samples, clip_sdf=opt.clip_sdf,
                          seed=opt.seed, **kw)
    valid_ds = SDFDataset(size=1, num_samples=opt.num_samples, clip_sdf=opt.clip_sdf,
                          seed=opt.seed + 1, **kw)
    trainer = SDFTrainer(model, workspace=opt.workspace, lr=opt.lr,
                         max_steps=100 * opt.epochs, eval_interval=5, use_tensorboard=True)
    trainer.load_checkpoint()
    if not opt.test:
        trainer.train(train_ds, valid_ds, max_epochs=opt.epochs)
    trainer.save_mesh(resolution=opt.mesh_resolution)
    return trainer


if __name__ == "__main__":
    main()
