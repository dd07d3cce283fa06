"""NeRF dataset (``ngp_tpu/data/nerf_dataset.py:NeRFDataset``): a split
as stacked numpy arrays, images [N, H, W, C] in [0, 1] (RGBA or RGB),
native camera-to-world poses [N, 4, 4] and intrinsics [4] (fx, fy, cx,
cy).

``NeRFDataset(path, split=...)`` reads a scene from disk, as the JAX
provider does: the colmap layout (one ``transforms.json``; frame 0 is
the val split, the test split a slerp path between two frames drawn
from ``np.random.default_rng(seed)``) or the blender layout
(``transforms_{split}.json``; ``all`` and ``trainval`` join files);
poses through ``nerf_matrix_to_ngp``; intrinsics from ``fl_x``/``fl_y``
or ``camera_angle_x``/``_y``; images through cv2 (BGR(A) -> RGB(A),
``INTER_AREA`` downscale, / 255). Frames whose file is missing are
skipped. ``NeRFDataset.from_arrays`` fills the same container from
arrays in memory (``data.synthetic.make_synthetic_frames`` and the
tests do).
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

import numpy as np

from ngp_tpu_torch.utils.color import srgb_to_linear_np

# the coarse error map's default resolution, as the reference's
ERROR_MAP_SIZE = 128


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33, offset=(0, 0, 0)) -> np.ndarray:
    """NeRF -> ngp axis permutation and scene scaling (provider.py:19-27)."""
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def rand_poses(rng: np.random.Generator, size: int, radius: float = 1.0,
               theta_range=(np.pi / 3, 2 * np.pi / 3), phi_range=(0, 2 * np.pi)) -> np.ndarray:
    """Random y-up look-at orbit poses [size, 4, 4] (provider.py:57-91)."""
    thetas = rng.uniform(theta_range[0], theta_range[1], size)
    phis = rng.uniform(phi_range[0], phi_range[1], size)
    centers = np.stack([
        radius * np.sin(thetas) * np.sin(phis),
        radius * np.cos(thetas),
        radius * np.sin(thetas) * np.cos(phis),
    ], axis=-1)

    def normalize(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-10)

    forward = -normalize(centers)
    up = np.broadcast_to(np.array([0.0, -1.0, 0.0]), centers.shape)
    right = normalize(np.cross(forward, up))
    up = normalize(np.cross(right, forward))
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (size, 4, 4)).copy()
    poses[:, :3, :3] = np.stack([right, up, forward], axis=-1)
    poses[:, :3, 3] = centers
    return poses.astype(np.float32)


def _slerp(r0: np.ndarray, r1: np.ndarray, t: float) -> np.ndarray:
    """Rotation-matrix slerp through scipy (provider.py:169-173)."""
    from scipy.spatial.transform import Rotation, Slerp

    return Slerp([0, 1], Rotation.from_matrix(np.stack([r0, r1])))(t).as_matrix()


def _normalized_times(times) -> np.ndarray:
    """Per-frame times in [0, 1]: a ``time`` field, or the frame index
    divided by the largest when any exceeds 1."""
    times = np.asarray(times, np.float32)
    if times.size and times.max() > 1.0:
        times = times / max(times.max(), 1.0)
    return times


def _load_transform(path: str, split: str):
    """(layout, the split's transforms dict)."""
    if os.path.exists(os.path.join(path, "transforms.json")):
        with open(os.path.join(path, "transforms.json")) as f:
            return "colmap", json.load(f)
    if not os.path.exists(os.path.join(path, "transforms_train.json")):
        raise FileNotFoundError(f"no transforms*.json under {path}")
    if split == "all":
        transform = None
        for p in sorted(glob.glob(os.path.join(path, "*.json"))):
            with open(p) as f:
                t = json.load(f)
            if transform is None:
                transform = t
            else:
                transform["frames"].extend(t["frames"])
        return "blender", transform
    if split == "trainval":
        with open(os.path.join(path, "transforms_train.json")) as f:
            transform = json.load(f)
        with open(os.path.join(path, "transforms_val.json")) as f:
            transform["frames"].extend(json.load(f)["frames"])
        return "blender", transform
    with open(os.path.join(path, f"transforms_{split}.json")) as f:
        return "blender", json.load(f)


class NeRFDataset:
    def __init__(self, path: str, split: str = "train", downscale: int = 1,
                 scale: float = 0.33, offset=(0, 0, 0), n_test: int = 10,
                 error_map: bool = False, seed: int = 0, color_space: str = "srgb"):
        import cv2

        self.root_path = path
        self.split = split
        self.training = split in ("train", "all", "trainval")
        rng = np.random.default_rng(seed)
        self.mode, transform = _load_transform(path, split)
        if "h" in transform and "w" in transform:
            self.H = int(transform["h"]) // downscale
            self.W = int(transform["w"]) // downscale
        else:
            self.H = self.W = None

        frames = transform["frames"]
        poses: List[np.ndarray] = []
        images: Optional[List[np.ndarray]] = []
        times: List[float] = []
        if self.mode == "colmap" and split == "test":
            # a smooth path between two random frames
            f0, f1 = rng.choice(frames, 2, replace=False)
            p0 = nerf_matrix_to_ngp(np.array(f0["transform_matrix"], np.float32), scale, offset)
            p1 = nerf_matrix_to_ngp(np.array(f1["transform_matrix"], np.float32), scale, offset)
            images = None
            for i in range(n_test + 1):
                ratio = np.sin(((i / n_test) - 0.5) * np.pi) * 0.5 + 0.5
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = _slerp(p0[:3, :3], p1[:3, :3], ratio)
                pose[:3, 3] = (1 - ratio) * p0[:3, 3] + ratio * p1[:3, 3]
                poses.append(pose)
                times.append(i / max(n_test, 1))
            if self.H is None:  # from the first frame's image
                img = cv2.imread(os.path.join(path, frames[0]["file_path"]),
                                 cv2.IMREAD_UNCHANGED)
                self.H = img.shape[0] // downscale
                self.W = img.shape[1] // downscale
        else:
            if self.mode == "colmap":
                if split == "train":
                    frames = frames[1:]
                elif split == "val":
                    frames = frames[:1]
            for fr in frames:
                f_path = os.path.join(path, fr["file_path"])
                if self.mode == "blender" and "." not in os.path.basename(f_path):
                    f_path += ".png"
                if not os.path.exists(f_path):
                    continue
                pose = nerf_matrix_to_ngp(np.array(fr["transform_matrix"], np.float32),
                                          scale, offset)
                image = cv2.imread(f_path, cv2.IMREAD_UNCHANGED)
                if self.H is None:
                    self.H = image.shape[0] // downscale
                    self.W = image.shape[1] // downscale
                if image.shape[-1] == 3:
                    image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
                else:
                    image = cv2.cvtColor(image, cv2.COLOR_BGRA2RGBA)
                if image.shape[0] != self.H or image.shape[1] != self.W:
                    image = cv2.resize(image, (self.W, self.H), interpolation=cv2.INTER_AREA)
                poses.append(pose)
                images.append(image.astype(np.float32) / 255.0)
                times.append(float(fr.get("time", len(times))))

        self.poses = np.stack(poses)
        self.times = _normalized_times(times)
        self.images = np.stack(images) if images else None
        if self.images is not None and color_space == "linear":
            self.images[..., :3] = srgb_to_linear_np(self.images[..., :3])
        self.radius = float(np.linalg.norm(self.poses[:, :3, 3], axis=-1).mean())
        self.error_map = (np.ones((len(self.poses), ERROR_MAP_SIZE * ERROR_MAP_SIZE), np.float32)
                          if (self.training and error_map) else None)

        # intrinsics (provider.py:259-274)
        if "fl_x" in transform or "fl_y" in transform:
            fl_x = transform.get("fl_x", transform.get("fl_y")) / downscale
            fl_y = transform.get("fl_y", transform.get("fl_x")) / downscale
        elif "camera_angle_x" in transform or "camera_angle_y" in transform:
            fl_x = (self.W / (2 * np.tan(transform["camera_angle_x"] / 2))
                    if "camera_angle_x" in transform else None)
            fl_y = (self.H / (2 * np.tan(transform["camera_angle_y"] / 2))
                    if "camera_angle_y" in transform else None)
            fl_x = fl_x if fl_x is not None else fl_y
            fl_y = fl_y if fl_y is not None else fl_x
        else:
            raise RuntimeError("cannot determine focal length from transforms.json")
        cx = transform.get("cx", self.W / 2) / (downscale if "cx" in transform else 1)
        cy = transform.get("cy", self.H / 2) / (downscale if "cy" in transform else 1)
        self.intrinsics = np.array([fl_x, fl_y, cx, cy], dtype=np.float32)

    @classmethod
    def from_arrays(cls, images: Optional[np.ndarray], poses: np.ndarray, intrinsics,
                    H: int, W: int, split: str = "train",
                    times: Optional[np.ndarray] = None) -> "NeRFDataset":
        """A split from arrays in memory: images [N, H, W, C] in [0, 1] or
        None (no ground truth), native poses [N, 4, 4], intrinsics [4];
        times default to the frame indices, as the loader's."""
        ds = cls.__new__(cls)
        ds.root_path = None
        ds.split = split
        ds.mode = "memory"
        ds.training = split in ("train", "all", "trainval")
        ds.H, ds.W = H, W
        ds.poses = np.asarray(poses, np.float32)
        ds.images = None if images is None else np.asarray(images, np.float32)
        ds.intrinsics = np.asarray(intrinsics, np.float32)
        ds.times = _normalized_times(np.arange(len(ds.poses)) if times is None else times)
        ds.radius = (float(np.linalg.norm(ds.poses[:, :3, 3], axis=-1).mean())
                     if len(ds.poses) else 0.0)
        ds.error_map = None
        return ds

    def __len__(self) -> int:
        return len(self.poses)

    @property
    def has_gt(self) -> bool:
        return self.images is not None

    @property
    def num_channels(self) -> int:
        return self.images.shape[-1] if self.images is not None else 3

    def epoch_indices(self, rng: np.random.Generator, rand_pose: int = -1) -> np.ndarray:
        """Shuffled frame indices for one epoch; with ``rand_pose`` > 0,
        1/rand_pose extra virtual indices >= len(poses) ask for a
        random-pose guidance step (provider.py:325-331)."""
        size = len(self.poses)
        if self.training and rand_pose > 0:
            size += size // rand_pose
        return rng.permutation(size) if self.training else np.arange(size)
