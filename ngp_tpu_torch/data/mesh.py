"""Triangle-mesh export, numpy only (``ngp_tpu/data/mesh.py:save_mesh``;
reference nerf/utils.py:626-630). The loaders and surface sampling of
the JAX module come with the SDF workload."""

from __future__ import annotations

import os

import numpy as np


def save_mesh(path: str, vertices: np.ndarray, faces: np.ndarray, colors=None):
    """Save to .obj or .ply (ascii). colors: optional [n, 3] float in [0,1]."""
    ext = os.path.splitext(path)[1].lower()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if ext == ".obj":
        with open(path, "w") as f:
            for i, v in enumerate(vertices):
                if colors is not None:
                    c = colors[i]
                    f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
                else:
                    f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for t in faces:
                f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")
    elif ext == ".ply":
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(vertices)}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            if colors is not None:
                f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\nend_header\n")
            for i, v in enumerate(vertices):
                line = f"{v[0]} {v[1]} {v[2]}"
                if colors is not None:
                    c = (np.clip(colors[i], 0, 1) * 255).astype(np.uint8)
                    line += f" {c[0]} {c[1]} {c[2]}"
                f.write(line + "\n")
            for t in faces:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
    else:
        raise ValueError(f"unsupported mesh format: {path}")
