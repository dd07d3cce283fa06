"""Debug visualisation helpers (``ngp_tpu/utils/vis.py``).

Equivalents of the reference's commented-in debug hooks (SURVEY.md §4):
``torch_vis_2d`` (nerf/utils.py:150-170), ``plot_pointcloud``
(nerf/renderer.py:49-58), ``visualize_poses`` (nerf/provider.py:30-54).
Headless: figures are saved to files through matplotlib's Agg backend,
imported at the first call. Inputs are numpy arrays or anything
``np.asarray`` takes (a CPU tensor). The default paths are relative to
the working directory.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def vis_2d(x, path: str = "vis2d.png", renormalize: bool = False) -> str:
    """Save a [H, W(, C)] array as an image (torch_vis_2d analog)."""
    plt = _pyplot()
    arr = np.asarray(x, dtype=np.float32)
    if renormalize:
        arr = (arr - arr.min()) / (np.ptp(arr) + 1e-8)
    plt.figure(figsize=(6, 6))
    plt.imshow(np.clip(arr, 0, 1) if arr.ndim == 3 else arr)
    plt.axis("off")
    plt.savefig(path, bbox_inches="tight")
    plt.close()
    return path


def plot_pointcloud(pc, color=None, path: str = "pointcloud.png") -> str:
    """Save a 3-D scatter of points [N, 3] (subsampled for speed)."""
    plt = _pyplot()
    pc = np.asarray(pc)
    if len(pc) > 20000:
        sel = np.random.default_rng(0).choice(len(pc), 20000, replace=False)
        pc = pc[sel]
        color = None if color is None else np.asarray(color)[sel]
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=0.5, c=color)
    plt.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def visualize_poses(poses, size: float = 0.1, path: str = "poses.png") -> str:
    """Save camera frusta line plots for [B, 4, 4] cam2world poses."""
    plt = _pyplot()
    poses = np.asarray(poses)
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    for pose in poses:
        pos = pose[:3, 3]
        a = pos + size * (pose[:3, 0] + pose[:3, 1] + pose[:3, 2])
        b = pos + size * (-pose[:3, 0] + pose[:3, 1] + pose[:3, 2])
        c = pos + size * (-pose[:3, 0] - pose[:3, 1] + pose[:3, 2])
        d = pos + size * (pose[:3, 0] - pose[:3, 1] + pose[:3, 2])
        for seg in ((pos, a), (pos, b), (pos, c), (pos, d), (a, b), (b, c), (c, d), (d, a)):
            xs, ys, zs = zip(*seg)
            ax.plot(xs, ys, zs, "b-", linewidth=0.5)
    ax.scatter([0], [0], [0], c="r", s=10)
    plt.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path
