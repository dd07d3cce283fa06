"""Ranks for tests/test_torch_parallel.py: ``spawn`` starts ``world``
processes on gloo (one torch thread each, no JAX: they take numpy
inputs), each runs a list of cases on the mesh it is given and returns
its results; ``one_device`` runs the same cases with no mesh in the
calling process."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import tempfile
import time

import numpy as np
import torch

JOIN_TIMEOUT = 240.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(cases, world: int = 8, model_parallel: int = 1, timeout: float = JOIN_TIMEOUT):
    """Run ``cases`` ([(name, kwargs)]) on ``world`` gloo ranks under
    ``make_mesh(world, model_parallel, "cpu")``; returns each rank's list
    of results. Fails if a rank fails or the ranks outlive ``timeout``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out:
        ctx = mp.start_processes(_entry, args=(world, model_parallel, _free_port(), cases, out),
                                 nprocs=world, join=False, start_method="spawn")
        end = time.monotonic() + timeout
        while not ctx.join(timeout=max(end - time.monotonic(), 0.1)):
            if time.monotonic() > end:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"the {world} ranks outlived {timeout} s")
        return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False)
                for r in range(world)]


def _entry(rank, world, model_parallel, port, cases, out):
    import torch.distributed as dist

    from ngp_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(world, model_parallel=model_parallel, device_type="cpu")
        results = [CASES[name](mesh, **kw) for name, kw in cases]
        torch.save(results, os.path.join(out, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def one_device(cases):
    """The same cases with no mesh, in this process."""
    return [CASES[name](None, **kw) for name, kw in cases]


# ---- what a case builds ----------------------------------------------------


@contextlib.contextmanager
def one_rounding(on: bool = True):
    """Round the lattice t0 + k dt and the points o + d t once, as JAX's
    XLA:CPU code does (``test_torch_v1_march._one_rounding``), for the
    body of the ``with`` block: the hash grid's finest level is sensitive
    to one ulp of a sample."""
    from ngp_tpu_torch.models import occupancy as to

    if not on:
        yield
        return

    def t_lattice(nears, fars, cfg, noise=None):
        assert cfg.dt_gamma == 0.0
        dt = float(np.float32(to.dt_bounds(cfg)[0]))
        t0 = nears if noise is None else (nears.double() + dt * noise.double()).float()
        ks = torch.arange(to.lattice_probes(cfg), dtype=torch.float64)
        ts = (t0.double()[:, None] + ks[None, :] * dt).float()
        return ts, torch.full_like(ts, dt)

    def points(rays_o, rays_d, ts, bound):
        x = rays_o.double()[:, None, :] + rays_d.double()[:, None, :] * ts.double()[..., None]
        return torch.clamp(x.float(), -bound, bound)

    saved = to.t_lattice, to._points
    to.t_lattice, to._points = t_lattice, points
    try:
        yield
    finally:
        to.t_lattice, to._points = saved


def trainer(mesh, rc, nc, tc, params=None, occ=None, seed=0, rounding=False, family="nerf"):
    """A ``GridNeRFTrainer`` (``family="dnerf"``: a ``DNeRFTrainer`` of a
    ``DNeRFNetwork``) on the CPU: the network from ``params`` (a numpy
    state dict, the whole banks) or from a seed, the occupancy state from
    ``occ`` (numpy fields) or fresh; under a 2-D mesh the banks are split
    before the optimizer is built. ``rounding``: see ``one_rounding``,
    which the cases apply."""
    from ngp_tpu_torch.config import NetworkConfig, RenderConfig, TrainConfig
    from ngp_tpu_torch.models.dnerf import DNeRFNetwork
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.models.occupancy import occupancy_from_jax
    from ngp_tpu_torch.parallel.mesh import shard_params
    from ngp_tpu_torch.training.dnerf import DNeRFTrainer
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

    rcfg = RenderConfig(**rc)
    net_cls, tr_cls = ((DNeRFNetwork, DNeRFTrainer) if family == "dnerf"
                       else (NeRFNetwork, GridNeRFTrainer))
    model = net_cls(NetworkConfig(**nc), rcfg, generator=torch.Generator().manual_seed(seed),
                    device="cpu")
    if params is not None:
        model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    if mesh is not None:
        shard_params(model, mesh)
    tr = tr_cls(model, rcfg, TrainConfig(**tc), seed=seed)
    tr.mesh = mesh
    if occ is not None:
        tr.aux = {"occ": occupancy_from_jax(occ, device="cpu")}
    tr.ensure_initialized()
    return tr


def batch(frames):
    out = {"images": torch.from_numpy(frames["images"]),
           "poses": torch.from_numpy(frames["poses"]),
           "intrinsics": torch.from_numpy(frames["intrinsics"]), "idx": int(frames["idx"])}
    if "times" in frames:
        out["times"] = frames["times"]
    return out


def whole_state(tr, mesh):
    """Parameters, Adam moments and EMA shadows as numpy, the split banks
    gathered whole, and the shapes each rank holds of them."""
    from ngp_tpu_torch.parallel.mesh import gather_split, split_names

    names = split_names(tr.model) if mesh is not None else set()

    def whole(name, t):
        return (gather_split(t, mesh) if name in names else t).detach().numpy().copy()

    opt = tr.optimizer.state
    out = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}, "ema": {}, "local_shapes": {}}
    for name, p in sorted(tr.model.named_parameters()):
        out["params"][name] = whole(name, p)
        out["ema"][name] = whole(name, tr.ema.shadow[name])
        st = opt.get(p, {})
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                out[k][name] = whole(name, st[k])
        out["local_shapes"][name] = [tuple(p.shape), tuple(tr.ema.shadow[name].shape)] + [
            tuple(st[k].shape) for k in ("exp_avg", "exp_avg_sq") if k in st]
    return out


def grids(tr):
    occ = tr.aux["occ"]
    return {"density_grid": occ.density_grid.numpy().copy(),
            "occ_grid": occ.occ_grid.numpy().copy(), "iter": occ.iter_density}


# ---- the cases --------------------------------------------------------------


def case_step(mesh, setup, frames, draws):
    """One ``train_step`` with the given draws (the whole batch's); the
    budgets ``rank_budget`` gave this rank, with the counts it was given."""
    from ngp_tpu_torch.training import nerf as tnerf

    tr = trainer(mesh, **setup)
    seen, real = [], tnerf.rank_budget

    def record(mesh_, n_valid, budget):
        got = real(mesh_, n_valid, budget)
        seen.append((int(n_valid), int(budget), got))
        return got

    tnerf.rank_budget = record
    try:
        with one_rounding(setup.get("rounding", False)):
            met = tr.train_step(batch(frames),
                                {k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    finally:
        tnerf.rank_budget = real
    return {"loss": float(met["loss"]),
            "turbo_overflow": float(met.get("turbo_overflow", -1.0)),
            "budgets": seen, **whole_state(tr, mesh)}


def case_frame(mesh, setup, pose, intr, H, W, chunk, refreshes=0):
    """``refreshes`` grid refreshes from the generator, then a frame."""
    tr = trainer(mesh, **setup)
    for _ in range(refreshes):
        tr._update_occupancy()
    img, dep = tr.render_frame(pose, intr, H, W, chunk=chunk)
    return {"image": img, "depth": dep, "stats": dict(tr.last_render_stats), **grids(tr)}


def case_collectives(mesh, pred, gt):
    from ngp_tpu_torch.parallel import (
        data_sharding,
        eval_metrics_dp,
        gather_predictions_dp,
        shard_pytree,
    )

    p, g = shard_pytree((torch.from_numpy(pred), torch.from_numpy(gt)), data_sharding(mesh))
    m = eval_metrics_dp(mesh, p, g)
    return {"mse": float(m["mse"]), "psnr": float(m["psnr"]),
            "gathered": gather_predictions_dp(mesh, p).numpy(), "rows": p.shape[0]}


def case_window(mesh, setup, frames, steps):
    """``steps`` trainer steps on one batch from the seeded generator (the
    refresh cadence included); each step's loss, the grid after each."""
    tr = trainer(mesh, **setup)
    b = batch(frames)
    losses, states = [], []
    for _ in range(steps):
        losses.append(float(tr.step(b)["loss"]))
        states.append(grids(tr))
    return {"losses": losses, "grids": states, **whole_state(tr, mesh)}


def case_checkpoint(mesh, setup, frames, draws, workspace):
    """A step, a checkpoint in ``workspace``, then a fresh trainer that
    restores it: its state against the saved trainer's."""
    tc = dict(setup["tc"], workspace=workspace)
    setup = dict(setup, tc=tc)
    tr = trainer(mesh, **setup)
    tr.train_step(batch(frames), {k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    path = tr.save_checkpoint()
    fresh = trainer(mesh, **dict(setup, seed=setup.get("seed", 0) + 1))
    assert fresh.load_checkpoint(path)
    mine = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    same = {n: bool(torch.equal(p.detach(), mine[n])) for n, p in fresh.model.named_parameters()}
    for n, p in fresh.model.named_parameters():
        p_old = dict(tr.model.named_parameters())[n]
        same[n] &= bool(torch.equal(fresh.ema.shadow[n], tr.ema.shadow[n]))
        for k in ("exp_avg", "exp_avg_sq"):
            same[n] &= bool(torch.equal(fresh.optimizer.state[p][k],
                                        tr.optimizer.state[p_old][k]))
    return {"path": path, "restored_equal": same, "skipped": list(fresh.last_restore_skipped),
            "step": fresh.global_step}


def case_placement(mesh, setup):
    """``shard_params`` then ``unshard_params`` on a seeded network (the
    whole banks back, bit for bit, and no feature gather left), and
    ``replicate_sharding`` of a tree whose tensors differ by rank."""
    import torch.distributed as dist

    from ngp_tpu_torch.config import NetworkConfig, RenderConfig
    from ngp_tpu_torch.models.nerf import NeRFNetwork
    from ngp_tpu_torch.parallel import replicate_sharding, shard_pytree
    from ngp_tpu_torch.parallel.mesh import shard_params, split_names, unshard_params

    model = NeRFNetwork(NetworkConfig(**setup["nc"]), RenderConfig(**setup["rc"]),
                        torch.Generator().manual_seed(5), device="cpu")
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    split = shard_params(model, mesh)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    names = split_names(model)
    back = unshard_params(model, mesh)
    x = torch.full((3,), float(dist.get_rank()))
    tree = shard_pytree({"a": x, "b": [x, 7]}, replicate_sharding(mesh))
    return {"split": split, "names": names, "back": back, "shapes": shapes,
            "restored": all(torch.equal(v, whole[k]) for k, v in model.state_dict().items()),
            "gather_left": model.encoder.feature_gather is not None,
            "replicated": [tree["a"].tolist(), tree["b"][0].tolist(), tree["b"][1]]}


CASES = {"step": case_step, "frame": case_frame, "collectives": case_collectives,
         "window": case_window, "checkpoint": case_checkpoint, "placement": case_placement}


def occ_fields(occ) -> dict:
    """A JAX ``OccupancyState`` as numpy fields (``occupancy_from_jax``)."""
    return {f.name: np.asarray(getattr(occ, f.name)) for f in dataclasses.fields(occ)}
