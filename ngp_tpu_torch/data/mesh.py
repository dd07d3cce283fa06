"""Triangle-mesh IO and sampling, numpy only (``ngp_tpu/data/mesh.py``):
``load_mesh`` (OBJ, and PLY in ascii or binary_little_endian),
``save_mesh``, ``normalize_mesh`` (sdf/provider.py:36-41 of the
reference), area-weighted ``sample_surface`` and the procedural
``icosphere``. Copies of the JAX module's functions, which give the
same arrays bit for bit (``tests/test_torch_sdf.py``).
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load (vertices [n, 3] f32, faces [m, 3] i32) from .obj or .ply."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return _load_obj(path)
    if ext == ".ply":
        return _load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


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


def _load_obj(path):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [p.split("/")[0] for p in line.split()[1:]]
                idx = [int(i) for i in idx]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan-triangulate polygons
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, dtype=np.float32), np.asarray(faces, dtype=np.int32)


def _load_ply(path):
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_vert = int(next(l.split()[2] for l in header if l.startswith("element vertex")))
        n_face = int(next(l.split()[2] for l in header if l.startswith("element face")))
        # vertex property layout
        props = []
        in_vertex = False
        for l in header:
            if l.startswith("element"):
                in_vertex = l.startswith("element vertex")
            elif l.startswith("property") and in_vertex:
                parts = l.split()
                props.append((parts[1], parts[2]))
        type_map = {
            "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
            "uchar": ("B", 1), "uint8": ("B", 1), "char": ("b", 1),
            "short": ("h", 2), "ushort": ("H", 2),
            "int": ("i", 4), "int32": ("i", 4), "uint": ("I", 4),
        }
        if fmt == "ascii":
            verts = []
            names = [p[1] for p in props]
            xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
            for _ in range(n_vert):
                vals = f.readline().split()
                verts.append([float(vals[xi]), float(vals[yi]), float(vals[zi])])
            faces = []
            for _ in range(n_face):
                vals = f.readline().split()
                idx = [int(v) for v in vals[1 : 1 + int(vals[0])]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
            return np.asarray(verts, np.float32), np.asarray(faces, np.int32)
        elif fmt == "binary_little_endian":
            fmt_str = "<" + "".join(type_map[t][0] for t, _ in props)
            stride = struct.calcsize(fmt_str)
            raw = f.read(stride * n_vert)
            names = [p[1] for p in props]
            xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
            arr = np.array(
                [struct.unpack_from(fmt_str, raw, i * stride) for i in range(n_vert)]
            )
            verts = arr[:, [xi, yi, zi]].astype(np.float32)
            faces = []
            for _ in range(n_face):
                (cnt,) = struct.unpack("<B", f.read(1))
                idx = struct.unpack(f"<{cnt}i", f.read(4 * cnt))
                for k in range(1, cnt - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
            return verts, np.asarray(faces, np.int32)
        raise ValueError(f"unsupported PLY format {fmt}")


def normalize_mesh(vertices: np.ndarray) -> np.ndarray:
    """Center + scale into [-1, 1] exactly as sdf/provider.py:36-41:
    scale = 2 / ||vmax - vmin|| * 0.95 (diagonal-based, not per-axis)."""
    vmin = vertices.min(0)
    vmax = vertices.max(0)
    center = (vmin + vmax) / 2
    scale = 2.0 / np.sqrt(np.sum((vmax - vmin) ** 2)) * 0.95
    return ((vertices - center[None, :]) * scale).astype(np.float32)


def sample_surface(
    vertices: np.ndarray, faces: np.ndarray, n: int, rng: np.random.Generator
) -> np.ndarray:
    """Area-weighted uniform surface sampling (trimesh .sample equivalent)."""
    a = vertices[faces[:, 0]]
    b = vertices[faces[:, 1]]
    c = vertices[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    probs = areas / areas.sum()
    tri = rng.choice(len(faces), size=n, p=probs)
    u = rng.uniform(size=(n, 1))
    v = rng.uniform(size=(n, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    return (a[tri] + u * (b[tri] - a[tri]) + v * (c[tri] - a[tri])).astype(np.float32)


def icosphere(subdiv: int = 4, radius: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural test mesh (subdivided octahedron projected to a sphere)."""
    verts = [
        np.array(v, dtype=np.float64)
        for v in [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    ]
    faces = [
        (0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
        (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5),
    ]
    for _ in range(subdiv):
        cache = {}
        new_faces = []

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts[i] + verts[j]
                m /= np.linalg.norm(m)
                verts.append(m)
                cache[key] = len(verts) - 1
            return cache[key]

        for (i, j, k) in faces:
            ij, jk, ki = midpoint(i, j), midpoint(j, k), midpoint(k, i)
            new_faces += [(i, ij, ki), (j, jk, ij), (k, ki, jk), (ij, jk, ki)]
        faces = new_faces
    return (
        (np.asarray(verts) * radius).astype(np.float32),
        np.asarray(faces, dtype=np.int32),
    )
