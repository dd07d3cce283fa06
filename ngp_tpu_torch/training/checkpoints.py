"""Checkpoints (``ngp_tpu/training/checkpoints.py``): numbered
checkpoints with ``max_keep`` retention, a separate best checkpoint,
the latest one found by name, and a tolerant restore. Each is one
``torch.save`` file of state dicts, tensors and plain scalars; JAX
checkpoints are not read (weights move with ``params_from_jax``).

``tolerant_merge`` is the JAX package's ``_tolerant_merge`` (the
reference's ``strict=False`` load): every key of the fresh state takes
the saved value when the checkpoint has it with the same shape, and
keeps its fresh value, its name recorded, when the key is missing or
its shape changed. Saved keys the fresh state lacks are dropped.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Mapping, Optional

import torch


def checkpoint_path(workspace: str, name: str, epoch: int = 0, best: bool = False) -> str:
    fname = f"{name}_best.pth" if best else f"{name}_ep{epoch:04d}.pth"
    return os.path.join(workspace, "checkpoints", fname)


def save_checkpoint(workspace: str, name: str, state: Dict[str, Any], epoch: int = 0,
                    max_keep: int = 2, best: bool = False) -> str:
    ckpt_dir = os.path.join(workspace, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(workspace, name, epoch, best)
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


def _same_shape(a, b) -> bool:
    sa, sb = getattr(a, "shape", None), getattr(b, "shape", None)
    return sa is None or sb is None or tuple(sa) == tuple(sb)


def tolerant_merge(fresh: Mapping[str, Any], saved: Optional[Mapping[str, Any]],
                   prefix: str, skipped: List[str]) -> Dict[str, Any]:
    """``fresh`` with each key replaced by ``saved[key]`` where that exists
    with the same shape; the others keep their fresh values and are
    appended to ``skipped`` as ``prefix/key``."""
    saved = saved if saved is not None else {}
    out = {}
    for k, v in fresh.items():
        if k in saved and _same_shape(v, saved[k]):
            out[k] = saved[k]
        else:
            skipped.append(f"{prefix}/{k}")
            out[k] = v
    return out
