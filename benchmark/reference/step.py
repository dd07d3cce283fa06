"""The reference training steps: plain PyTorch, float32 with TF32 off.

``reference_steps`` follows the first training steps of a cell from the
same inputs the program was given (the benchmark's weights, scene, frame
order, per-step draws and the trainer's seed) and returns what the
comparison reads: each step's loss, the first step's gradient norm per
parameter, each parameter's and EMA shadow's change after the steps, and
the occupancy grid of the first step's refresh. The network, marches,
grid and optimizer follow the configuration file's keys (``network``,
``render``, ``train``); nothing of the program is imported.

``fault`` plants one of the faults a training step can have, for the
calibration of the limits: ``"half_batch"`` takes the loss's mean over
the first half of the rays alone, ``"alter"`` zeroes the encoder
features of every 16th sample.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference import plain as P


class Model:
    """The configuration's network on a dict of named f32 parameters (the
    names the benchmark gives its weights)."""

    def __init__(self, net: Dict, render: Dict, params: Dict[str, torch.Tensor],
                 rnd: P.Rounding, fault: Optional[str] = None):
        self.net, self.render, self.params, self.rnd, self.fault = net, render, params, rnd, fault
        self.bound = float(render["bound"])
        if net["encoding"] == "hashgrid":
            self.geom = P.hash_geometry(net["num_levels"], net["level_dim"],
                                        net["base_resolution"], net["log2_hashmap_size"],
                                        int(2048 * self.bound))
        elif net["encoding"] != "cpgrid":
            raise ValueError(f"the reference has no {net['encoding']} encoder")

    def _weights(self, prefix: str, n: int) -> List[torch.Tensor]:
        return [self.params[f"{prefix}.dense_{i}"] for i in range(n)]

    def density(self, x: torch.Tensor):
        """World points [M, 3] -> (sigma [M], geo features [M, G])."""
        net, rnd = self.net, self.rnd
        pos = (x + self.bound) / (2 * self.bound)
        if net["encoding"] == "cpgrid":
            res = net["cp_resolutions"]
            factors = [rnd(self.params[f"encoder.factors_{r}"]) for r in res]
            feats = torch.cat([P.cp_features(pos, factors, res),
                               P.freq_encode(2.0 * pos - 1.0, net["cp_freq_degree"])], dim=-1)
        else:
            feats = P.hash_encode(pos, self.params["encoder.embeddings"], self.geom, rnd)
        if self.fault == "alter":
            keep = (torch.arange(feats.shape[0], device=feats.device) % 16 != 0)
            feats = feats * keep[:, None]
        h = P.mlp(feats, self._weights("sigma_net", net["num_layers"]), rnd)
        return P.trunc_exp(h[:, 0]), h[:, 1:]

    def color(self, d: torch.Tensor, geo: torch.Tensor) -> torch.Tensor:
        de = P.sh_encode(d, self.net["sh_degree"])
        h = P.mlp(torch.cat([de, geo], dim=-1),
                  self._weights("color_net", self.net["num_layers_color"]), self.rnd)
        return torch.sigmoid(h)


def render(model: Model, rays_o, rays_d, grid: P.Grid, r: Dict, noise, bg):
    """March, network on the kept samples, compositing, background."""
    if r["turbo"]:
        if r.get("t_proxy_thresh") is not None:
            raise ValueError("the reference has no transmittance proxy")
        m = P.march_turbo(rays_o, rays_d, grid, r, noise)
        mask = P.turbo_train_mask(m, r)
    else:
        m = P.march_v1(rays_o, rays_d, grid, r, noise)
        mask = m["mask"]
    x = P.points(rays_o, rays_d, m["ts"], r["bound"])[mask]
    d = rays_d[:, None, :].expand(-1, mask.shape[1], -1)[mask]
    sigma, geo = model.density(x)
    rgb = model.color(d, geo)
    out = P.composite(P.scatter_slots(mask, sigma), P.scatter_slots(mask, rgb), m["ts"],
                      m["deltas"], mask, m["nears"], m["fars"],
                      density_scale=r["density_scale"], t_thresh=r["t_thresh"])
    return out["image"] + (1.0 - out["weights_sum"])[..., None] * bg, int(mask.sum())


def reference_steps(cfg: Dict, weights: Dict[str, torch.Tensor], scene, steps: Sequence,
                    trainer_seed: int, rnd: Optional[P.Rounding] = None,
                    fault: Optional[str] = None, device=None,
                    march_grid: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """Follow ``steps`` [(frame index, draws {"inds", "bg", "noise"})] from
    ``weights``; ``scene`` has images [F, H, W, 4], poses [F, 4, 4] and
    intrinsics [4] as tensors. Returns "losses", "grad" (the first step's
    gradient norm per parameter, and "grad_vec" the gradient itself),
    "change" (norm of each parameter's and
    "ema/" shadow's change after the steps), "occ" (the first refresh's
    occupancy grid) and "samples" (network samples per step).

    ``march_grid`` ({"occ", "density"} of the program's grid after the
    first refresh): the steps march on it, packed here, in place of the
    reference's own refresh, which is still made and returned as "occ".
    A grid cell whose density lies within rounding of the threshold can
    flip, and one flipped cell moves every later sample of the rays that
    cross it; marching on the program's grid keeps that out of the
    steps' numbers, and the grid is compared by itself."""
    if fault not in (None, "half_batch", "alter"):
        raise ValueError(f"unknown fault {fault!r}")
    rnd = rnd or P.Rounding("f32")
    device = device or scene.images.device
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _steps(cfg, weights, scene, steps, trainer_seed, rnd, fault, device, march_grid)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _steps(cfg, weights, scene, steps, trainer_seed, rnd, fault, device, march_grid):
    net, r, t = cfg["network"], cfg["render"], cfg["train"]
    names = sorted(weights)
    w0 = {k: weights[k].detach().to(device=device, dtype=torch.float32) for k in names}
    params = {k: w0[k].clone().requires_grad_() for k in names}
    ema = {k: w0[k].clone() for k in names}
    exp_avg = {k: torch.zeros_like(w0[k]) for k in names}
    exp_avg_sq = {k: torch.zeros_like(w0[k]) for k in names}
    model = Model(net, r, params, rnd, fault)
    beta1, beta2, eps = 0.9, 0.99, 1e-15
    decay = float(t.get("ema_decay", 0.95))
    grid = P.mark_untrained(P.init_grid(r, device), scene.poses.cpu().numpy(),
                            scene.intrinsics.cpu().numpy(), r)
    gen = torch.Generator(device=device).manual_seed(int(trainer_seed))
    images = scene.images.to(device)
    F, H, W, C = images.shape
    losses, samples = [], []
    grad1 = first_occ = None
    for i, (idx, draws) in enumerate(steps):
        if i % int(t["update_extra_interval"]) == 0:
            with torch.no_grad():
                grid = P.refresh(grid, model.density, r, gen,
                                 density_scale=float(r["density_scale"]))
            if first_occ is None:
                first_occ = grid.occ.clone()
                if march_grid is not None:
                    occ, dens = march_grid["occ"].to(device), march_grid["density"].to(device)
                    grid = P.Grid(dens, occ, grid.iters, *P.pack_payloads(occ, dens))
        inds = draws["inds"].to(device).long()
        bg = draws["bg"].to(device).float()
        rays_o, rays_d = P.rays_from_indices(scene.poses[idx].to(device),
                                             scene.intrinsics.to(device), W, inds)
        pix = images[idx].reshape(H * W, C)[inds].float()
        gt = pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])
        image, n_samples = render(model, rays_o, rays_d, grid, r, draws["noise"].to(device), bg)
        per_ray = ((image - gt) ** 2).mean(dim=-1)
        if fault == "half_batch":
            per_ray = per_ray[:per_ray.shape[0] // 2]
        loss = per_ray.mean()
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(w0[k])) for k, g in zip(names, grads)}
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        lr = float(t["lr"]) * float(t.get("lr_decay_target", 0.1)) ** min(i / int(t["iters"]), 1.0)
        n = i + 1
        with torch.no_grad():
            for k in names:
                g = grads[k]
                exp_avg[k].lerp_(g, 1 - beta1)
                exp_avg_sq[k].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                denom = (exp_avg_sq[k].sqrt() / (1 - beta2**n) ** 0.5).add_(eps)
                params[k].addcdiv_(exp_avg[k], denom, value=-lr / (1 - beta1**n))
                ema[k].mul_(decay).add_(params[k], alpha=1.0 - decay)
        losses.append(float(loss.detach()))
        samples.append(n_samples)
    change = {}
    with torch.no_grad():
        for k in names:
            change[k] = float(torch.linalg.vector_norm(params[k] - w0[k]))
            change["ema/" + k] = float(torch.linalg.vector_norm(ema[k] - w0[k]))
    return {"losses": losses, "grad": {k: float(torch.linalg.vector_norm(g)) for k, g in grad1.items()},
            "grad_vec": grad1, "change": change, "occ": first_occ, "samples": samples}
