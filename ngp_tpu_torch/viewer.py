"""Interactive viewing: orbit camera + train/render interleaving
(``ngp_tpu/viewer.py``).

A copy of the JAX package's numpy viewer, the equivalent of the
reference's DearPyGui GUI layer (``nerf/gui.py``) for a headless host:

- :class:`OrbitCamera` — orbit / scale / pan camera model
  (gui.py:10-52), pure numpy;
- :class:`InteractiveSession` — the trainer-facing loop contract:
  ``train_steps()`` with dynamic step count targeting a time budget
  (gui.py:106-111) and ``render_view()`` with dynamic downscale
  targeting a frame budget (gui.py:135-140) plus SPP accumulation
  (gui.py:142-148);
- :mod:`ngp_tpu_torch.viewer_web` — a zero-dependency browser viewer that
  drives an InteractiveSession over HTTP.

What differs from the JAX copy: ``train_steps`` drives the port's
``Trainer.step(batch)`` and waits for the device by reading the last
step's loss (JAX calls ``jax.block_until_ready``). The sample-budget
dials set ``eval_max_samples`` / ``eval_mean_samples``; the JAX trainer
also drops its compiled renderers there, and the port compiles nothing
per budget: a frame builds its closures anew and reads the dials, while
the sticky chunk count and lattice span stay, as JAX keeps them.
"""

from __future__ import annotations

import inspect
import time
from typing import Optional

import numpy as np


class OrbitCamera:
    """Orbit camera with the reference's parametrization (gui.py:10-52)."""

    def __init__(self, W: int, H: int, r: float = 2.0, fovy: float = 60.0):
        self.W = W
        self.H = H
        self.radius = r
        self.fovy = fovy
        self.center = np.array([0.0, 0.0, 0.0], dtype=np.float32)
        # rotation stored as a 3x3 matrix; start looking down +z like
        # the framework's ray convention
        self.rot = np.eye(3, dtype=np.float32)

    @property
    def pose(self) -> np.ndarray:
        """cam2world [4, 4]: translate out along -z then rotate."""
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = self.rot
        pose[:3, 3] = self.center - self.rot @ np.array([0, 0, self.radius], np.float32)
        return pose

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * np.tan(np.radians(self.fovy) / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2], dtype=np.float32)

    def orbit(self, dx: float, dy: float):
        """Rotate azimuth/elevation by mouse deltas (gui.py:33-41)."""
        side = self.rot[:3, 0]
        up = np.array([0, 1, 0], np.float32)
        rot_y = _axis_angle(up, -dx * 0.005)
        rot_x = _axis_angle(side, -dy * 0.005)
        self.rot = rot_y @ rot_x @ self.rot

    def scale(self, delta: float):
        self.radius *= 1.1**-delta

    def pan(self, dx: float, dy: float, dz: float = 0.0):
        self.center += 0.0005 * self.rot @ np.array([dx, dy, dz], np.float32)


def _axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    a = np.cos(angle / 2)
    b, c, d = -axis * np.sin(angle / 2)
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
            [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
            [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
        ],
        dtype=np.float32,
    )


class InteractiveSession:
    """Interleaves training and view rendering with adaptive budgets.

    trainer: any NeRF-family trainer of the port with ``render_frame(pose,
    intrinsics, H, W)``, ``make_loader`` and ``step``.
    """

    def __init__(
        self,
        trainer,
        train_loader=None,
        train_budget_ms: float = 500.0,
        render_budget_ms: float = 200.0,
        max_spp: int = 64,
    ):
        self.trainer = trainer
        self.train_budget_ms = train_budget_ms
        self.render_budget_ms = render_budget_ms
        self.max_spp = max_spp
        self.training = train_loader is not None
        self._train_iter = None
        self._epoch_iter_factory = None
        if train_loader is not None:
            self._epoch_iter_factory = trainer.make_loader(train_loader)
        self.steps_per_call = 16  # dynamic (gui.py:106-111)
        self.downscale = 1.0  # dynamic (gui.py:135-140)
        self._accum: Optional[np.ndarray] = None
        self._accum_pose: Optional[np.ndarray] = None
        self.spp = 0
        # scene time for dynamic (D-NeRF) trainers; render_frame
        # receives it when the trainer supports a `time` kwarg
        self.time = 0.0
        self.mode = "rgb"  # or 'depth' (GUI mode combo, gui.py:302-309)
        self._supports_time = "time" in inspect.signature(trainer.render_frame).parameters
        # widget requests queued by UI threads, executed on the main
        # (device-owning) loop thread via service_requests()
        self._requests: list = []

    # ---- widget surface (nerf/gui.py:302-338 parity) ----------------------

    def set_aabb_axis(self, axis: int, frac: float):
        """Live 6-dof inference crop: slider value in [-1, 1] scaled to
        the scene bound, written to trainer.aabb_infer (a render argument:
        the next frame reads it). Layout [xmin,ymin,zmin,xmax,ymax,zmax]
        (nerf/gui.py:316-338)."""
        t = self.trainer
        bound = t.render_cfg.bound
        aabb = np.array(
            t.aabb_infer if t.aabb_infer is not None else t.render_cfg.aabb,
            np.float32,
        )
        aabb[axis] = float(np.clip(frac, -1.0, 1.0)) * bound
        # keep an nonempty box (min strictly below max per axis)
        eps = 1e-3 * bound
        for a in range(3):
            if aabb[a] > aabb[a + 3] - eps:
                if axis == a:
                    aabb[a] = aabb[a + 3] - eps
                else:
                    aabb[a + 3] = aabb[a] + eps
        t.aabb_infer = aabb
        self._accum_pose = None  # crop change invalidates SPP accum

    def request(self, op: str, arg=None):
        """Queue a trainer-mutating widget action (called from HTTP
        handler threads; the device is driven only by the main loop)."""
        self._requests.append((op, arg))

    def service_requests(self):
        """Execute queued widget actions on the main loop thread:
        train toggle, save-ckpt / save-mesh buttons, density-grid
        reset, eval sample-budget dials (nerf/gui.py:302-315)."""
        while self._requests:
            op, arg = self._requests.pop(0)
            t = self.trainer
            if op == "train":
                if self._epoch_iter_factory is not None:
                    self.training = not self.training
            elif op == "save_ckpt":
                t.save_checkpoint()
            elif op == "save_mesh" and hasattr(t, "save_mesh"):
                t.save_mesh()
            elif op == "reset" and hasattr(t, "reset_extra_state"):
                t.reset_extra_state()
            elif op == "max_samples":
                # the per-ray eval budget (the dial trades PSNR for frame
                # rate), rounded up to a multiple of 4: the turbo placement
                # takes ALIGN-aligned per-ray budgets (occupancy.place_compact)
                t.eval_max_samples = max(4, -(-int(arg) // 4) * 4)
            elif op == "mean_samples" and hasattr(t, "eval_mean_samples"):
                # water-filled global eval budget (mean samples/ray);
                # 0 = no budget (full no-drop render). Scarce budgets
                # trim the deepest samples of the longest rays, so the
                # dial degrades smoothly instead of dropping pixels.
                v = int(arg)
                t.eval_mean_samples = None if v <= 0 else max(1, v)
            self._accum_pose = None

    # ---- training ---------------------------------------------------------

    def _next_batch(self):
        if self._train_iter is None:
            self._train_iter = iter(self._epoch_iter_factory())
        try:
            return next(self._train_iter)
        except StopIteration:
            self._train_iter = iter(self._epoch_iter_factory())
            return next(self._train_iter)

    def train_steps(self) -> dict:
        """Run ~train_budget worth of steps (trainer.train_gui
        equivalent, nerf/utils.py:718-776). Returns timing + loss."""
        t = self.trainer
        t.ensure_initialized()
        t0 = time.perf_counter()
        metrics = None
        for _ in range(self.steps_per_call):
            metrics = t.step(self._next_batch())
        loss = float(metrics["loss"])  # waits for the device
        dt = (time.perf_counter() - t0) * 1000
        # adapt step count toward the budget (gui.py:106-111)
        per_step = dt / max(self.steps_per_call, 1)
        self.steps_per_call = int(np.clip(self.train_budget_ms / max(per_step, 1e-3), 1, 256))
        return {"loss": loss, "ms": dt, "steps": self.steps_per_call}

    # ---- rendering --------------------------------------------------------

    def render_view(self, camera: OrbitCamera, spp_accumulate: bool = True) -> np.ndarray:
        """Render the camera view at the adaptive resolution; average
        across calls with an unchanged pose (SPP accumulation,
        gui.py:142-148). Returns [H, W, 3] float."""
        t0 = time.perf_counter()
        ds = max(self.downscale, 1.0)
        rH, rW = int(camera.H / ds), int(camera.W / ds)
        intr = camera.intrinsics / ds
        if self._supports_time:
            image, depth = self.trainer.render_frame(camera.pose, intr, rH, rW, time=self.time)
        else:
            image, depth = self.trainer.render_frame(camera.pose, intr, rH, rW)
        if self.mode == "depth":
            # normalized-depth visualization (reference GUI 'mode'
            # combo, nerf/gui.py:302-309)
            image = np.repeat(depth[..., None], 3, axis=-1)
        dt = (time.perf_counter() - t0) * 1000
        # adapt downscale toward the render budget (gui.py:135-140)
        full_ms = dt * ds * ds
        self.downscale = float(np.clip(np.sqrt(full_ms / self.render_budget_ms), 1.0, 8.0))

        if rH != camera.H:
            import cv2

            image = cv2.resize(image, (camera.W, camera.H), interpolation=cv2.INTER_LINEAR)

        # accumulation key includes scene time (a scrub must reset SPP)
        pose = np.concatenate(
            [camera.pose.reshape(-1), [self.time, float(self.mode == "depth")]]
        )
        if (
            spp_accumulate
            and self._accum is not None
            and self._accum_pose is not None
            and np.allclose(pose, self._accum_pose)
            and self.spp < self.max_spp
        ):
            self._accum = (self._accum * self.spp + image) / (self.spp + 1)
            self.spp += 1
        else:
            self._accum = image
            self._accum_pose = pose
            self.spp = 1
        return self._accum
