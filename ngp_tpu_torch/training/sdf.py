"""SDF trainer (``ngp_tpu/training/sdf.py``; the reference's
sdf/utils.py): direct regression of signed distances with the MAPE
loss, Adam and the per-step EMA; ``predict_sdf`` queries the EMA
weights in chunks of 2^18 points, and ``save_mesh`` samples a lattice
on [-1, 1]^3, extracts the zero level set by marching tetrahedra
(``marching_cubes(-sdf, 0)``: the oracle is positive outside) and writes
the vertices mapped back to [-1, 1] (sdf/utils.py:235-259).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import numpy as np
import torch

from ngp_tpu_torch.data.mesh import save_mesh
from ngp_tpu_torch.models.sdf import SDFNetwork
from ngp_tpu_torch.native import marching_cubes
from ngp_tpu_torch.ops.losses import mape_loss
from ngp_tpu_torch.training.trainer import Trainer


class SDFTrainer(Trainer):
    def __init__(self, model: SDFNetwork, name: str = "ngp_sdf", **kwargs):
        super().__init__(name=name, **kwargs)
        self.model = model
        self.device = next(model.parameters()).device
        self.last_mesh_path: Optional[str] = None

    def _tensors(self, batch):
        return (torch.as_tensor(batch["points"], device=self.device),
                torch.as_tensor(batch["sdfs"], device=self.device))

    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """batch: "points" [N, 3] and "sdfs" [N, 1] (numpy or tensors)."""
        self.ensure_initialized()
        points, sdfs = self._tensors(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = mape_loss(self.model(points), sdfs)
        loss.backward()
        self._apply_gradients()
        return {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        """The MAPE of the live (not the EMA) weights, as JAX's eval_step."""
        points, sdfs = self._tensors(batch)
        return {"loss": mape_loss(self.model(points), sdfs)}

    @torch.no_grad()
    def predict_sdf(self, points: np.ndarray, chunk: int = 2**18) -> np.ndarray:
        """SDF [n] at points [n, 3], in chunks, with the EMA weights when
        there are any."""
        self.ensure_initialized()
        outs = [torch.zeros((0,), device=self.device)]
        with self.ema.average_parameters() if self.ema is not None else contextlib.nullcontext():
            for i in range(0, len(points), chunk):
                x = torch.as_tensor(points[i:i + chunk], device=self.device)
                outs.append(self.model(x)[:, 0])
            return torch.cat(outs).cpu().numpy()

    def save_mesh(self, path: Optional[str] = None, resolution: int = 256) -> str:
        if path is None:
            path = os.path.join(self.workspace, "meshes", f"{self.name}_{self.epoch}.obj")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        xs = np.linspace(-1, 1, resolution, dtype=np.float32)
        grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)
        sdf = self.predict_sdf(grid).reshape(resolution, resolution, resolution)
        verts, faces = marching_cubes(-sdf, 0.0)
        verts = verts / (resolution - 1) * 2.0 - 1.0
        save_mesh(path, verts, faces)
        self.log(f"saved mesh to {path} ({len(verts)} verts, {len(faces)} faces)")
        self.last_mesh_path = path
        return path
