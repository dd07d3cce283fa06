"""Checkpoints (``ngp_tpu/training/checkpoints.py``): numbered
checkpoints with ``max_keep`` retention, a separate best checkpoint,
and the latest one found by name. Each is one ``torch.save`` file of
state dicts, tensors and plain scalars; JAX checkpoints are not read
(weights move with ``models.nerf.params_from_jax``).
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional

import torch


def save_checkpoint(workspace: str, name: str, state: Dict[str, Any], epoch: int = 0,
                    max_keep: int = 2, best: bool = False) -> str:
    ckpt_dir = os.path.join(workspace, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    fname = f"{name}_best.pth" if best else f"{name}_ep{epoch:04d}.pth"
    path = os.path.join(ckpt_dir, fname)
    torch.save({**state, "epoch": epoch}, path)
    if not best and max_keep > 0:
        for old in sorted(glob.glob(os.path.join(ckpt_dir, f"{name}_ep*.pth")))[:-max_keep]:
            os.remove(old)
    return path


def latest_checkpoint(workspace: str, name: str) -> Optional[str]:
    ckpts = sorted(glob.glob(os.path.join(workspace, "checkpoints", f"{name}_ep*.pth")))
    return ckpts[-1] if ckpts else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint's dict, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
