"""SDF training data: online point sampling around a mesh
(``ngp_tpu/data/sdf_dataset.py``; the reference's sdf/provider.py:28-88).

The mesh is normalised into [-1, 1]; each batch is 7/8 surface points,
the second half of the batch perturbed by N(0, 0.01^2), plus 1/8
uniform points in the cube. The signed distances of the second half
come from the native BVH oracle (``native.MeshSDF``, positive outside);
the first half are surface points, label 0. Host numpy, the same draws
as the JAX dataset for a seed, bit for bit; the trainer moves each
batch to the device.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from ngp_tpu_torch.data.mesh import load_mesh, normalize_mesh, sample_surface
from ngp_tpu_torch.native import MeshSDF


class SDFDataset:
    def __init__(
        self,
        path: Optional[str] = None,
        vertices: Optional[np.ndarray] = None,
        faces: Optional[np.ndarray] = None,
        size: int = 100,
        num_samples: int = 2**18,
        clip_sdf: Optional[float] = None,
        seed: int = 0,
    ):
        if path is not None:
            vertices, faces = load_mesh(path)
        if vertices is None or faces is None:
            raise ValueError("need either path or (vertices, faces)")
        self.vertices = normalize_mesh(np.asarray(vertices, np.float32))
        self.faces = np.asarray(faces, np.int32)
        self.sdf_fn = MeshSDF(self.vertices, self.faces)
        if num_samples % 8 != 0:
            raise ValueError("num_samples must be divisible by 8")
        self.num_samples = num_samples
        self.clip_sdf = clip_sdf
        self.size = size
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.size

    def sample_batch(self) -> Dict[str, np.ndarray]:
        n = self.num_samples
        sdfs = np.zeros((n, 1), dtype=np.float32)
        points_surface = sample_surface(self.vertices, self.faces, n * 7 // 8, self.rng)
        # perturb everything past the batch midpoint (provider.py:72)
        points_surface[n // 2 :] += 0.01 * self.rng.standard_normal(
            (n * 3 // 8, 3)
        ).astype(np.float32)
        points_uniform = (
            self.rng.uniform(size=(n // 8, 3)).astype(np.float32) * 2 - 1
        )
        points = np.concatenate([points_surface, points_uniform], axis=0)
        sdfs[n // 2 :, 0] = self.sdf_fn(points[n // 2 :])
        if self.clip_sdf is not None:
            sdfs = sdfs.clip(-self.clip_sdf, self.clip_sdf)
        return {"points": points, "sdfs": sdfs}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(self.size):
            yield self.sample_batch()
