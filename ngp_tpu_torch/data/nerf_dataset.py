"""In-memory NeRF frames (``ngp_tpu/data/nerf_dataset.py:NeRFDataset``).

The trainer reads a split as stacked arrays: images [N, H, W, C] in
[0, 1] (RGBA or RGB), native camera-to-world poses [N, 4, 4] and
intrinsics [4] (fx, fy, cx, cy). The transforms.json / PNG loaders of
the JAX provider are not ported yet; ``data.synthetic`` fills this
container directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class NeRFDataset:
    images: Optional[np.ndarray]  # [N, H, W, C] f32, or None (no ground truth)
    poses: np.ndarray  # [N, 4, 4] f32
    intrinsics: np.ndarray  # [4] f32
    H: int
    W: int
    training: bool = True

    def __len__(self) -> int:
        return len(self.poses)

    def epoch_indices(self, rng: np.random.Generator, rand_pose: int = -1) -> np.ndarray:
        """Shuffled frame indices for one epoch; with ``rand_pose`` > 0,
        1/rand_pose extra virtual indices >= len(poses) ask for a random
        pose (the guidance steps the trainer skips until they are
        ported)."""
        size = len(self.poses)
        if self.training and rand_pose > 0:
            size += size // rand_pose
        return rng.permutation(size) if self.training else np.arange(size)
