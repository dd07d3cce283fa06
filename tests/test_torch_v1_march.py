"""The hash-grid configuration's render and train path against the JAX
package: the v1 march (``march_rays``) on the same grid, rays and noise,
``render_rays_grid`` with ``params_from_jax`` weights, one f32 train
step of ``GridNeRFTrainer`` with the v1 renderer and JAX's draws, an
eval frame, and the network's default device.

Tolerances. The march: mask equal, t and dt to 1e-6. The render
(f32): pixels, depth and opacity to 1e-5 (the same samples; f32 sums in
another order through the encoder, the MLPs and the compositor). The
train step: loss to 1e-5 relative and each gradient, the hash table's
included, to 1e-4 of its largest entry, as the cpgrid step
(``test_torch_train_step.py``), with the sample points rounded as JAX
rounds them; 1e-2 with the port's own rounding (``_one_rounding`` says
why). The frame: u8 pixels within one level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu import config as jconfig
from ngp_tpu.models import occupancy as jo
from ngp_tpu.models.nerf import NeRFNetwork as JNeRFNetwork
from ngp_tpu.training.nerf_grid import GridNeRFTrainer as JGridNeRFTrainer
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch.data import synthetic as tsyn
from ngp_tpu_torch.models import occupancy as to
from ngp_tpu_torch.models.nerf import NeRFNetwork as TNeRFNetwork
from ngp_tpu_torch.models.nerf import make_fused_density, make_fused_sigma_rgb, params_from_jax
from ngp_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer as TGridNeRFTrainer
from test_torch_occupancy import _cfg, _close, _eq, _grids, _jax_state, _rays, _to_port
from test_torch_train_step import _grad_recorder, _np, _scaled

RC = dict(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=64, max_samples_per_ray=16,
          grid_size=16, density_thresh=10.0, turbo=False)
NC = dict(encoding="hashgrid", use_bf16=False, num_levels=4, level_dim=2, base_resolution=4,
          log2_hashmap_size=10, sh_degree=3)


@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("kw", [dict(), dict(dt_gamma=1 / 128, bound=2.0),
                                dict(max_samples_per_ray=64), dict(clip=True)])
def test_march_rays_matches_jax(kw, perturb):
    """Mask, t and dt of every slot, with the lattice start perturbed by
    JAX's noise or not, adaptive steps, a budget that does not bind, and
    a per-ray ``t_range`` inside an ``aabb`` override."""
    kw = dict(kw)
    clip = kw.pop("clip", False)
    jcfg, cfg = _cfg(turbo=False, **kw)
    occ, dens = _grids(jcfg, frac=0.3)
    js = _jax_state(jcfg, occ, dens)
    ro, rd = _rays(bound=jcfg.bound)
    extra_j, extra_t = {}, {}
    if clip:
        box = np.array([-0.8, -0.7, -0.9, 0.7, 0.8, 0.6], np.float32)
        tr = np.stack([np.full(ro.shape[0], 1.6), np.full(ro.shape[0], 2.6)], -1)
        tr = (tr + np.random.default_rng(3).uniform(0, 0.3, tr.shape)).astype(np.float32)
        extra_j = dict(aabb=jnp.asarray(box), t_range=jnp.asarray(tr))
        extra_t = dict(aabb=torch.from_numpy(box), t_range=torch.from_numpy(tr))
    key = jax.random.PRNGKey(4)
    jm = jo.march_rays(jnp.asarray(ro), jnp.asarray(rd), js, jcfg, rng=key, perturb=perturb,
                       **extra_j)
    noise = _np(jax.random.uniform(key, (ro.shape[0],))) if perturb else None
    tm = to.march_rays(torch.from_numpy(ro), torch.from_numpy(rd), _to_port(js), cfg,
                       perturb=perturb, noise=noise, **extra_t)
    _eq(tm["mask"], jm["mask"])
    assert 0 < int(tm["mask"].sum()) < tm["mask"].numel()
    _close(tm["ts"], jm["ts"], 1e-6)
    _close(tm["deltas"], jm["deltas"], 1e-6)
    _close(tm["xyzs"], jm["xyzs"], 1e-6)
    _close(tm["nears"], jm["nears"], 1e-6)
    _close(tm["fars"], jm["fars"], 1e-6)
    # the occupancy lookup of every lattice probe
    ts, dts = to.t_lattice(tm["nears"], torch.where(tm["fars"] > tm["nears"], tm["fars"],
                                                    tm["nears"]), cfg)
    x = torch.clamp(torch.from_numpy(ro)[:, None] + torch.from_numpy(rd)[:, None] * ts[..., None],
                    -cfg.bound, cfg.bound)
    _eq(to.occupancy_at(_to_port(js), x, dts, cfg),
        jo.occupancy_at(js, jnp.asarray(x.numpy()), jnp.asarray(dts.numpy()), jcfg))


def _networks(seed=0):
    jrc, trc = jconfig.RenderConfig(**RC), tconfig.RenderConfig(**RC)
    model = JNeRFNetwork(cfg=jconfig.NetworkConfig(**NC), render=jrc)
    x0 = jnp.zeros((8, 3))
    params = model.init(jax.random.PRNGKey(seed), x0, x0, method=JNeRFNetwork.full_init)
    # a table of O(0.1) values, so that the render is not flat
    emb = np.random.default_rng(seed).normal(
        scale=0.3, size=params["params"]["encoder"]["embeddings"].shape).astype(np.float32)
    params["params"]["encoder"]["embeddings"] = jnp.asarray(emb)
    net = TNeRFNetwork(tconfig.NetworkConfig(**NC), trc, device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return model, params, net, jrc, trc


def test_hashgrid_network_loads_jax_params():
    model, params, net, _, _ = _networks()
    assert set(net.state_dict()) == {"encoder.embeddings", "sigma_net.dense_0",
                                     "sigma_net.dense_1", "color_net.dense_0",
                                     "color_net.dense_1", "color_net.dense_2"}
    assert make_fused_density(net) is None and make_fused_sigma_rgb(net) is None
    x = np.random.default_rng(1).uniform(-1.1, 1.1, size=(300, 3)).astype(np.float32)
    d = np.random.default_rng(2).normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    js, jr = model.apply(params, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        ts, tr = net(torch.from_numpy(x), torch.from_numpy(d))
    _close(ts, js, 1e-5)
    _close(tr, jr, 1e-5)


@pytest.mark.parametrize("perturb", [False, True])
def test_render_rays_grid_matches_jax(perturb):
    model, params, net, jrc, trc = _networks()
    occ, dens = _grids(jrc, frac=0.3, seed=5)
    js = _jax_state(jrc, occ, dens)
    ro, rd = _rays(n=64, seed=6)
    bg = np.random.default_rng(7).uniform(size=(64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)

    def dfn(x):
        return model.apply(params, x, method=JNeRFNetwork.density)

    def cfn(d, g):
        return model.apply(params, d, g, method=JNeRFNetwork.color)

    jout = jo.render_rays_grid(dfn, cfn, jnp.asarray(ro), jnp.asarray(rd), js, jrc, rng=key,
                               perturb=perturb, bg_color=jnp.asarray(bg))
    noise = _np(jax.random.uniform(key, (64,))) if perturb else None
    with torch.no_grad():
        tout = to.render_rays_grid(net.density, net.color, torch.from_numpy(ro),
                                   torch.from_numpy(rd), _to_port(js), trc,
                                   bg_color=torch.from_numpy(bg), perturb=perturb, noise=noise)
    assert "n_dropped" not in tout
    _eq(tout["n_samples"], jout["n_samples"])
    for k in ("image", "depth", "weights_sum", "weights"):
        _close(tout[k], jout[k], 1e-5)
    assert float(tout["weights_sum"].max()) > 0.1


def test_network_builds_on_the_card_unless_asked():
    """Built without a device, the network goes to CUDA: on a machine
    without one it raises rather than training on the CPU unasked."""
    nc, rc = tconfig.NetworkConfig(**NC), tconfig.RenderConfig(**RC)
    if torch.cuda.is_available():
        assert {p.device.type for p in TNeRFNetwork(nc, rc).parameters()} == {"cuda"}
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            TNeRFNetwork(nc, rc)
        with pytest.raises((RuntimeError, AssertionError)):
            to.init_occupancy(rc)
    net = TNeRFNetwork(nc, rc, device="cpu")
    assert {p.device.type for p in net.parameters()} == {"cpu"}


def _one_rounding(monkeypatch):
    """Round the lattice t0 + k * dt (and the perturbed start) and the
    points o + d * t once, where JAX's XLA:CPU code fuses each into a
    multiply-add; the port rounds twice. On the finest hash levels (cells
    of 1/2048) a sample one ulp away moves the features by about 5e-4 of
    their size at the initial table's scale, enough to move the first
    sigma layer's and the table's gradients past 1e-4 (measured 4e-3
    and 7e-3 of their largest entries; 6e-7 and 1.5e-6 with one
    rounding)."""

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

    monkeypatch.setattr(to, "t_lattice", t_lattice)
    monkeypatch.setattr(to, "_points", points)


@pytest.mark.parametrize("rounding", ["jax", "port"])
def test_hashgrid_train_step_matches_jax(tmp_path, monkeypatch, rounding):
    """One f32 step of the hash-grid configuration (v1 march, network on
    every slot) with JAX's weights, grid and draws: the loss, and every
    gradient (the table's included) to 1e-4 of its largest entry when
    the sample points are rounded as JAX rounds them (``_one_rounding``);
    with the port's own rounding, the loss to 1e-5 and the gradients to
    1e-2 of their largest entries (measured 7.1e-3)."""
    if rounding == "jax":
        _one_rounding(monkeypatch)
    H = W = 32
    tc = dict(iters=50, num_rays=512, workspace=str(tmp_path))
    jrc = jconfig.RenderConfig(**RC)
    jtr = JGridNeRFTrainer(JNeRFNetwork(cfg=jconfig.NetworkConfig(**NC), render=jrc), jrc,
                           jconfig.TrainConfig(**tc), log_every=10**9, use_tensorboard=False)
    jtr.tx = _grad_recorder()
    jtr.ensure_initialized()
    for _ in range(3):
        jtr._update_occupancy()
    frames = tsyn.make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=H, W=W,
                                        device="cpu")["train"]
    batch = {"images": jnp.asarray(frames.images), "poses": jnp.asarray(frames.poses),
             "intrinsics": jnp.asarray(frames.intrinsics), "idx": jnp.int32(1)}
    rng = jax.random.PRNGKey(7)
    jstate, _, jmet = jax.jit(jtr.train_step)(jtr.state, jtr.aux, batch, rng)
    n = tc["num_rays"]
    k_pix, k_bg, k_render = jax.random.split(rng, 3)
    draws = {"inds": _np(jax.random.randint(k_pix, (n,), 0, H * W)),
             "bg": _np(jax.random.uniform(k_bg, (n, 3))),
             "noise": _np(jax.random.uniform(k_render, (n,)))}

    net = TNeRFNetwork(tconfig.NetworkConfig(**NC), tconfig.RenderConfig(**RC), device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jtr.state.params)))
    ttr = TGridNeRFTrainer(net, net.render, tconfig.TrainConfig(**tc))
    occ = jtr.aux["occ"]
    ttr.aux = {"occ": to.occupancy_from_jax(
        {f.name: np.asarray(getattr(occ, f.name)) for f in dataclasses.fields(occ)},
        device="cpu")}
    assert 0.0 < float(ttr.aux["occ"].occ_grid.float().mean()) < 1.0
    tbatch = {"images": torch.from_numpy(frames.images), "poses": torch.from_numpy(frames.poses),
              "intrinsics": torch.from_numpy(frames.intrinsics), "idx": 1}
    reset_launch_counts()
    tmet = ttr.train_step(tbatch, draws)
    assert not any(launch_counts().values())  # the CPU takes the plain versions

    loss = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - loss) <= 1e-5 * loss and loss > 0
    assert "turbo_overflow" not in tmet and "turbo_overflow" not in jmet
    jgrads = params_from_jax(jax.tree.map(np.asarray, jstate.opt_state["g"]))
    assert set(jgrads) == {n for n, _ in net.named_parameters()}
    for name, p in net.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        _scaled(p.grad, jgrads[name], 1e-4 if rounding == "jax" else 1e-2)


def test_hashgrid_eval_frame_matches_jax(tmp_path):
    """``render_frame`` of the hash-grid configuration (v1 march, no
    prepass, the projected-box chunk list) on JAX's weights and grid."""
    model, params, net, jrc, trc = _networks(seed=3)
    jtr = JGridNeRFTrainer(model, jrc, jconfig.TrainConfig(workspace=str(tmp_path)),
                           log_every=10**9, use_tensorboard=False)
    jtr.ensure_initialized()
    jtr.state = jtr.state.replace(params=params, ema_params=params)
    occ, dens = _grids(jrc, frac=0.3, seed=9)
    jtr.aux = dict(jtr.aux, occ=_jax_state(jrc, occ, dens))
    ttr = TGridNeRFTrainer(net, trc)
    ttr.aux = {"occ": _to_port(jtr.aux["occ"])}
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.5
    intr = np.array([20.0, 20.0, 12.0, 12.0], np.float32)
    want, _ = jtr.render_frame(pose, intr, 24, 24, chunk=256)
    got, _ = ttr.render_frame(pose, intr, 24, 24, chunk=256)
    assert ttr.last_render_stats["n_dropped"] == 0 and ttr.last_render_stats["n_samples"] > 0
    assert np.abs(got - np.asarray(want)).max() <= 1.0 / 255 + 1e-6
    assert np.abs(got - 1.0).max() > 0.05  # the frame is not all background
