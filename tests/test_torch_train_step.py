"""The port's training path against the JAX package on the same inputs
and the same random draws: place_compact's VJP, the perturbed march,
the ray sampler, the untrained-cell cull, the synthetic scene, one f32
train step (loss, every gradient, turbo_overflow, the error map), and
the optimizer, schedule and EMA.

jax.random and torch draw different numbers, so each test draws with
JAX's own key splits and hands the numbers to the port.

Tolerances. The march, sampler, cull and place_compact: equal (t to
1e-6). The ground-truth render: 2e-5 (f32, 512-term transmittance
products; measured 3.5e-6), and the u8 frames within one level (an
opaque alpha of exactly 1.0 against 1 - 2^-24 truncates to 255 and
254). The
train step: loss to 1e-5 relative, each gradient to 1e-4 of its
largest entry (f32 sums in another order through the compositor and
both MLPs; measured 2.3e-6). Optimizer and EMA: 1e-6 relative on identical gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ngp_tpu import config as jconfig
from ngp_tpu.data import raysampler as jrs
from ngp_tpu.data import synthetic as jsyn
from ngp_tpu.models import occupancy as jo
from ngp_tpu.models.nerf import NeRFNetwork as JNeRFNetwork
from ngp_tpu.training.nerf_grid import GridNeRFTrainer as JGridNeRFTrainer
from ngp_tpu.training.state import apply_gradients, create_train_state
from ngp_tpu.training.trainer import Trainer as JTrainer
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch.data import raysampler as trs
from ngp_tpu_torch.data import synthetic as tsyn
from ngp_tpu_torch.models import occupancy as to
from ngp_tpu_torch.models.nerf import NeRFNetwork as TNeRFNetwork
from ngp_tpu_torch.models.nerf import params_from_jax
from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer as TGridNeRFTrainer
from ngp_tpu_torch.training.trainer import Trainer as TTrainer
from test_torch_occupancy import _cfg, _close, _eq, _grids, _jax_state, _rays, _to_port


def _np(x):
    return torch.from_numpy(np.array(x))


def _scaled(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# place_compact's VJP (the repaired gradient) and the perturbed march
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut", [0, 8])
def test_place_compact_vjp_matches_jax(cut):
    """Gradient only from each block's own ray slot; slots that read a
    block through the clamp or past their ray's segment send nothing
    back (autograd of the forward gather would scatter-add them)."""
    rng = np.random.default_rng(11)
    N, S, Fd = 12, 16, 4
    counts = rng.integers(0, S // 4 + 1, size=N) * 4
    mask = np.arange(S)[None, :] < counts[:, None]
    budget = int(counts.sum()) - cut
    src_j, _, off_j = jo.compact_valid_samples(jnp.asarray(mask), budget, block_uniform=True)
    src_t, _, off_t = to.compact_valid_samples(torch.from_numpy(mask), budget)
    vals = rng.normal(size=(budget, Fd)).astype(np.float32)
    g = rng.normal(size=(N, S, Fd)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jo.place_compact(v, off_j, src_j, S), jnp.asarray(vals))
    (dj,) = vjp(jnp.asarray(g))
    v = torch.from_numpy(vals).requires_grad_()
    to.place_compact(v, off_t, src_t, S).backward(torch.from_numpy(g))
    _eq(v.grad, dj)
    # the fault the custom backward repairs: a plain gather's autograd
    v8 = v.detach().reshape(-1, 4 * Fd).requires_grad_()
    rows = off_t[:, None] // 4 + torch.arange(S // 4)[None, :]
    v8[rows.clamp(0, budget // 4 - 1)].reshape(N, S, Fd).backward(torch.from_numpy(g))
    assert not np.allclose(v8.grad.reshape(budget, Fd).numpy(), np.asarray(dj))


@pytest.mark.parametrize("kw", [dict(), dict(dt_gamma=1 / 128, bound=2.0)])
def test_perturbed_march_with_the_same_noise(kw):
    jcfg, cfg = _cfg(**kw)
    occ, dens = _grids(jcfg, frac=0.15)
    js = _jax_state(jcfg, occ, dens)
    ro, rd = _rays(bound=jcfg.bound)
    key = jax.random.PRNGKey(3)
    march = jax.jit(jo.march_rays_turbo, static_argnames=("cfg", "perturb"))
    jm = march(jnp.asarray(ro), jnp.asarray(rd), js, jcfg, rng=key, perturb=True)
    noise = _np(jax.random.uniform(key, (ro.shape[0],)))
    tm = to.march_rays_turbo(torch.from_numpy(ro), torch.from_numpy(rd), _to_port(js), cfg,
                             perturb=True, noise=noise)
    _eq(tm["mask"], jm["mask"])
    _close(tm["ts"], jm["ts"], 1e-6)
    _close(tm["deltas"], jm["deltas"], 1e-6)
    _eq(tm["n_total"], jm["n_total"])
    _close(tm["n_dropped"], jm["n_dropped"], 1e-5)
    still = to.march_rays_turbo(torch.from_numpy(ro), torch.from_numpy(rd), _to_port(js), cfg)
    assert not torch.equal(still["ts"], tm["ts"])
    drawn = to.march_rays_turbo(torch.from_numpy(ro), torch.from_numpy(rd), _to_port(js), cfg,
                                perturb=True, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(drawn["ts"], tm["ts"])


# ---------------------------------------------------------------------------
# the ray sampler, the cull, the synthetic scene
# ---------------------------------------------------------------------------


def test_sample_ray_indices_uniform_and_full_frame():
    key = jax.random.PRNGKey(1)
    H, W, n = 24, 40, 500
    want = jrs.sample_ray_indices(key, H, W, n)
    got = trs.sample_ray_indices(H, W, n, device="cpu", draws={
        "inds": _np(jax.random.randint(key, (n,), 0, H * W))})
    _eq(got["inds"], want["inds"])
    drawn = trs.sample_ray_indices(H, W, n, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    assert drawn["inds"].shape == (n,) and 0 <= int(drawn["inds"].min())
    assert int(drawn["inds"].max()) < H * W
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.2, -2.0]
    intr = np.array([30.0, 28.0, 20.0, 12.0], np.float32)
    jf = jrs.full_frame_rays(jnp.asarray(pose), jnp.asarray(intr), H, W)
    tf = trs.full_frame_rays(torch.from_numpy(pose), torch.from_numpy(intr), H, W)
    _close(tf["rays_d"], jf["rays_d"], 1e-6)
    _close(tf["rays_o"], jf["rays_o"], 0)


@pytest.mark.parametrize("uniform_frac", [0.0, 0.5])
def test_sample_ray_indices_error_map(uniform_frac):
    key = jax.random.PRNGKey(2)
    M, H, W, n = 16, 40, 56, 200
    em = np.random.default_rng(4).exponential(size=M * M).astype(np.float32)
    want = jrs.sample_ray_indices(key, H, W, n, error_map=jnp.asarray(em),
                                  uniform_frac=uniform_frac)
    n_uni = int(round(n * uniform_frac))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = {
        "gumbel_u": _np(jax.random.uniform(k1, (M * M,))),
        "jx": _np(jax.random.uniform(k2, (n - n_uni,))),
        "jy": _np(jax.random.uniform(k3, (n - n_uni,))),
        "inds_u": _np(jax.random.randint(k4, (n_uni,), 0, H * W)),
    }
    got = trs.sample_ray_indices(H, W, n, error_map=torch.from_numpy(em),
                                 uniform_frac=uniform_frac, draws=draws)
    _eq(got["inds"], want["inds"])
    _eq(got["inds_coarse"], want["inds_coarse"])
    drawn = trs.sample_ray_indices(H, W, n, error_map=torch.from_numpy(em),
                                   uniform_frac=uniform_frac,
                                   generator=torch.Generator().manual_seed(0))
    weighted = drawn["inds_coarse"][: n - n_uni]
    assert weighted.unique().numel() == n - n_uni  # without replacement


def test_sample_ray_indices_patch():
    key = jax.random.PRNGKey(5)
    H, W, n, p = 30, 34, 160, 4
    want = jrs.sample_ray_indices(key, H, W, n, patch_size=p)
    kx, ky = jax.random.split(key)
    num = n // p**2
    got = trs.sample_ray_indices(H, W, n, patch_size=p, device="cpu", draws={
        "x0": _np(jax.random.randint(kx, (num,), 0, H - p)),
        "y0": _np(jax.random.randint(ky, (num,), 0, W - p)),
    })
    _eq(got["inds"], want["inds"])


def _orbit_poses(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([tsyn._orbit_pose(rng.uniform(np.pi / 4, 3 * np.pi / 4),
                                      rng.uniform(0, 2 * np.pi), 2.2) for _ in range(n)])


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_mark_untrained_grid(bound):
    jcfg, cfg = _cfg(bound=bound)
    occ, dens = _grids(jcfg)
    js = _jax_state(jcfg, occ, dens)
    poses = _orbit_poses(3)
    intr = np.array([30.0, 30.0, 16.0, 16.0], np.float32)
    jn = jo.mark_untrained_grid(js, jnp.asarray(poses), jnp.asarray(intr), 32, 32, jcfg)
    tn = to.mark_untrained_grid(_to_port(js), poses, intr, 32, 32, cfg)
    _eq(tn.density_grid, jn.density_grid)
    assert int((tn.density_grid < 0).sum()) > int((torch.from_numpy(dens) < 0).sum())


@pytest.mark.parametrize("variant", ["default", "hard"])
def test_make_synthetic_frames_matches_render_gt_frame(variant):
    H = W = 32
    splits = tsyn.make_synthetic_frames(n_train=2, n_val=1, n_test=1, H=H, W=W, seed=3,
                                        variant=variant, device="cpu")
    train = splits["train"]
    focal = 0.5 * W / np.tan(0.5 * np.deg2rad(50.0))
    np.testing.assert_array_equal(train.intrinsics,
                                  np.array([focal, focal, W / 2, H / 2], np.float32))
    rng = np.random.default_rng(3)
    for i in range(2):
        theta = rng.uniform(np.pi / 4, 3 * np.pi / 4)
        phi = rng.uniform(0, 2 * np.pi)
        np.testing.assert_array_equal(train.poses[i], jsyn._orbit_pose(theta, phi, 2.2))
    np.testing.assert_array_equal(splits["val"].poses[0], jsyn._orbit_pose(np.pi / 2.2, 0.0, 2.2))
    np.testing.assert_array_equal(splits["test"].poses[0],
                                  jsyn._orbit_pose(np.pi / 2.2, np.pi, 2.2))
    assert train.training and not splits["val"].training
    want = jsyn.render_gt_frame(train.poses[0], train.intrinsics, H, W, variant=variant)
    got = tsyn.render_gt_frame(train.poses[0], train.intrinsics, H, W, variant=variant,
                               device="cpu")
    _close(got, want, 2e-5)
    # u8 truncation, as the PNG writer does; a 1-ulp difference at an
    # exact level (opaque alpha 1.0) may move a value by one level
    np.testing.assert_array_equal(train.images[0],
                                  (got * 255).astype(np.uint8).astype(np.float32) / 255.0)
    assert np.abs(train.images[0] * 255.0 - np.floor(want * 255.0)).max() <= 1.0 + 1e-4
    assert (want[..., 3] > 0.5).mean() > 0.05  # the frame has content


# ---------------------------------------------------------------------------
# one train step, and the optimizer
# ---------------------------------------------------------------------------


def _grad_recorder():
    """An optax transform that leaves the params as they are and keeps
    the last gradients as its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}),
    )


@pytest.mark.parametrize("error_map", [False, True])
def test_train_step_matches_jax(tmp_path, error_map):
    H = W = 32
    rc = dict(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=64, max_samples_per_ray=16,
              grid_size=16, density_thresh=10.0, turbo=True, coarse_candidates=48,
              crossing_slots=16, compact_mean_samples=6)
    nc = dict(encoding="cpgrid", use_bf16=False, cp_resolutions=(32, 64), cp_rank=16,
              cp_freq_degree=4, sh_degree=3)
    tc = dict(iters=50, num_rays=1024, error_map=error_map, error_map_size=32,
              workspace=str(tmp_path))
    jrc = jconfig.RenderConfig(**rc)
    jtr = JGridNeRFTrainer(JNeRFNetwork(cfg=jconfig.NetworkConfig(**nc), render=jrc), jrc,
                           jconfig.TrainConfig(**tc), log_every=10**9, use_tensorboard=False)
    jtr.tx = _grad_recorder()
    jtr.ensure_initialized()
    for _ in range(3):
        jtr._update_occupancy()
    frames = tsyn.make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=H, W=W,
                                     device="cpu")["train"]
    em = np.random.default_rng(6).exponential(size=(2, 32 * 32)).astype(np.float32)
    aux = dict(jtr.aux)
    if error_map:
        aux["error_map"] = jnp.asarray(em)
    batch = {"images": jnp.asarray(frames.images), "poses": jnp.asarray(frames.poses),
             "intrinsics": jnp.asarray(frames.intrinsics), "idx": jnp.int32(1)}
    rng = jax.random.PRNGKey(7)
    jstate, jaux, jmet = jax.jit(jtr.train_step)(jtr.state, aux, batch, rng)

    # JAX's draws: train_step's key splits, then the sampler's and the march's
    n = tc["num_rays"]
    k_pix, k_bg, k_render = jax.random.split(rng, 3)
    draws = {"bg": _np(jax.random.uniform(k_bg, (n, 3))),
             "noise": _np(jax.random.uniform(k_render, (n,)))}
    if error_map:
        n_uni = int(round(n * 0.5))
        k1, k2, k3, k4 = jax.random.split(k_pix, 4)
        draws.update(gumbel_u=_np(jax.random.uniform(k1, (32 * 32,))),
                     jx=_np(jax.random.uniform(k2, (n - n_uni,))),
                     jy=_np(jax.random.uniform(k3, (n - n_uni,))),
                     inds_u=_np(jax.random.randint(k4, (n_uni,), 0, H * W)))
    else:
        draws["inds"] = _np(jax.random.randint(k_pix, (n,), 0, H * W))

    net = TNeRFNetwork(tconfig.NetworkConfig(**nc), tconfig.RenderConfig(**rc), device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jtr.state.params)))
    ttr = TGridNeRFTrainer(net, net.render, tconfig.TrainConfig(**tc))
    occ = jtr.aux["occ"]
    ttr.aux = {"occ": to.occupancy_from_jax(
        {f.name: np.asarray(getattr(occ, f.name)) for f in dataclasses.fields(occ)},
        device="cpu")}
    if error_map:
        ttr.aux["error_map"] = torch.from_numpy(em.copy())
    tbatch = {"images": torch.from_numpy(frames.images), "poses": torch.from_numpy(frames.poses),
              "intrinsics": torch.from_numpy(frames.intrinsics), "idx": 1}
    tmet = ttr.train_step(tbatch, draws)

    loss = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - loss) <= 1e-5 * loss and loss > 0
    assert abs(float(tmet["turbo_overflow"]) - float(jmet["turbo_overflow"])) <= 1e-6
    jgrads = params_from_jax(jax.tree.map(np.asarray, jstate.opt_state["g"]))
    for name, p in net.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        _scaled(p.grad, jgrads[name], 1e-4)
    if error_map:
        want = np.asarray(jaux["error_map"])
        got = ttr.aux["error_map"].numpy()
        assert not np.array_equal(want, em)
        # a coarse cell drawn twice takes either ray's value; compare the rest
        ic = np.asarray(jrs.sample_ray_indices(
            k_pix, H, W, n, error_map=jnp.asarray(em[1]), uniform_frac=0.5)["inds_coarse"])
        once = np.bincount(ic, minlength=32 * 32) == 1
        _close(got[1][once], want[1][once], 1e-6)
        np.testing.assert_array_equal(got[0], want[0])
        assert once[ic].mean() > 0.2


def test_optimizer_schedule_and_ema_match_optax(tmp_path):
    """Adam (eps 1e-15), the decaying learning rate (past its end at
    step 3) and the per-step EMA, fed the same gradients."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** -s).astype(np.float32)
              for k, v in params.items()} for s in range(3)]
    jt = JTrainer("t", workspace=str(tmp_path), lr=1e-2, max_steps=2, use_tensorboard=False)
    st = create_train_state(jax.tree.map(jnp.asarray, params), jt.tx, use_ema=True)

    mod = torch.nn.Module()
    for k, v in params.items():
        mod.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    tt = TTrainer("t", workspace=str(tmp_path), lr=1e-2, max_steps=2)
    tt.model = mod
    tt.ensure_initialized()
    for g in grads:
        st = apply_gradients(st, jax.tree.map(jnp.asarray, g), jt.tx, ema_decay=0.95)
        for k, p in mod.named_parameters():
            p.grad = torch.from_numpy(g[k])
        tt._apply_gradients()
        for k, p in mod.named_parameters():
            _close(p.detach(), st.params[k], 1e-6)
            _close(tt.ema.shadow[k], st.ema_params[k], 1e-6)
    assert tt.scheduler.get_last_lr()[0] == pytest.approx(float(jt.schedule(3)), rel=1e-6)


def test_train_on_dataset_refresh_cadence_and_checkpoints(tmp_path):
    """The port's loop on its own: culling on a fresh run, a refresh
    every ``update_extra_interval`` steps, the error map, numbered and
    best checkpoints, and a restore that brings every piece back."""
    rc = tconfig.RenderConfig(bound=1.0, min_near=0.05, max_steps=64, max_samples_per_ray=16,
                              grid_size=16, density_thresh=10.0, turbo=True,
                              coarse_candidates=48, compact_mean_samples=6)
    nc = tconfig.NetworkConfig(encoding="cpgrid", use_bf16=False, cp_resolutions=(32, 64),
                               cp_rank=16, cp_freq_degree=4, sh_degree=3)
    tc = tconfig.TrainConfig(iters=50, num_rays=256, update_extra_interval=4, error_map=True,
                             error_map_size=16, workspace=str(tmp_path))
    frames = tsyn.make_synthetic_frames(n_train=3, n_val=0, n_test=0, H=16, W=16,
                                     device="cpu")["train"]

    def trainer():
        net = TNeRFNetwork(nc, rc, torch.Generator().manual_seed(0), device="cpu")
        return TGridNeRFTrainer(net, rc, tc, log_every=5)

    tr = trainer()
    tr.train_on_dataset(frames, max_epochs=3)
    occ = tr.aux["occ"]
    assert tr.global_step == 9 and occ.iter_density == 3  # refreshes at steps 0, 4, 8
    assert bool((occ.density_grid < 0).any())  # cells no camera sees
    assert not torch.equal(tr.aux["error_map"], torch.ones_like(tr.aux["error_map"]))
    assert np.isfinite(tr.stats["loss"]).all() and len(tr.stats["loss"]) == 3
    ckpts = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert ckpts == ["ngp_ep0001.pth", "ngp_ep0003.pth"]
    assert (tmp_path / "log_ngp.txt").exists()
    tr.save_checkpoint(best=True)

    back = trainer()
    assert back.load_checkpoint()
    assert (back.global_step, back.epoch) == (9, 3)
    for (k, a), b in zip(tr.model.named_parameters(), back.model.parameters()):
        _eq(b.detach(), a.detach())
        _eq(back.ema.shadow[k], tr.ema.shadow[k])
    assert back.scheduler.last_epoch == tr.scheduler.last_epoch == 9
    assert back.optimizer.state_dict()["state"][0]["step"] == 9
    for f in dataclasses.fields(occ):
        _eq(getattr(back.aux["occ"], f.name), getattr(occ, f.name))
    _eq(back.aux["error_map"], tr.aux["error_map"])

    best = trainer()
    assert best.load_checkpoint(str(tmp_path / "checkpoints" / "ngp_best.pth"))
    for k, p in best.model.named_parameters():
        _eq(p.detach(), tr.ema.shadow[k])
    with tr.ema.average_parameters():  # render_frame's weights
        for k, p in tr.model.named_parameters():
            _eq(p.detach(), tr.ema.shadow[k])
    _eq(tr.model.encoder.factors_32.detach(), back.model.encoder.factors_32.detach())


# ---------------------------------------------------------------------------
# the TV and distortion terms, the guidance step and its loader
# ---------------------------------------------------------------------------


def _trainer_pair(tmp_path, rc, nc, tc, table_std=None):
    """A JAX trainer that records its gradients and the port's trainer on
    the same weights and occupancy grid (three JAX refreshes). With
    ``table_std``, the grid table is redrawn N(0, table_std), so that the
    TV term is not negligible beside the MSE."""
    jrc = jconfig.RenderConfig(**rc)
    jtr = JGridNeRFTrainer(JNeRFNetwork(cfg=jconfig.NetworkConfig(**nc), render=jrc), jrc,
                           jconfig.TrainConfig(**tc), log_every=10**9, use_tensorboard=False)
    jtr.tx = _grad_recorder()
    jtr.ensure_initialized()
    if table_std is not None:
        params = jax.tree.map(lambda a: a, jtr.state.params)
        emb = params["params"]["encoder"]["embeddings"]
        params["params"]["encoder"]["embeddings"] = jnp.asarray(
            np.random.default_rng(8).normal(scale=table_std, size=emb.shape).astype(np.float32))
        jtr.state = jtr.state.replace(params=params)
    for _ in range(3):
        jtr._update_occupancy()

    def port():
        net = TNeRFNetwork(tconfig.NetworkConfig(**nc), tconfig.RenderConfig(**rc), device="cpu")
        net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jtr.state.params)))
        ttr = TGridNeRFTrainer(net, net.render, tconfig.TrainConfig(**tc))
        occ = jtr.aux["occ"]
        ttr.aux = {"occ": to.occupancy_from_jax(
            {f.name: np.asarray(getattr(occ, f.name)) for f in dataclasses.fields(occ)},
            device="cpu")}
        return ttr

    return jtr, port


def _check_step(jstate, jmet, tmet, net):
    """The loss to 1e-5 relative, every gradient to 1e-4 of its largest
    entry, as ``test_train_step_matches_jax`` holds them."""
    loss = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - loss) <= 1e-5 * abs(loss) and loss != 0
    jgrads = params_from_jax(jax.tree.map(np.asarray, jstate.opt_state["g"]))
    assert set(jgrads) == {n for n, _ in net.named_parameters()}
    for name, p in net.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        _scaled(p.grad, jgrads[name], 1e-4)


_TURBO_RC = dict(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=64, max_samples_per_ray=16,
                 grid_size=16, density_thresh=10.0, turbo=True, coarse_candidates=48,
                 crossing_slots=16, compact_mean_samples=6)
_CP_NC = dict(encoding="cpgrid", use_bf16=False, cp_resolutions=(32, 64), cp_rank=16,
              cp_freq_degree=4, sh_degree=3)
# one dense level of 17^3 rows, which the TV term reaches in full; a finer
# level (the network's finest is 2048 * bound) would need the sample points
# rounded as JAX rounds them (test_torch_v1_march.py:_one_rounding)
_TILED_NC = dict(encoding="tiledgrid", use_bf16=False, num_levels=1, level_dim=2,
                 base_resolution=16, log2_hashmap_size=14, sh_degree=3)


@pytest.mark.parametrize("config", ["turbo-cpgrid", "turbo-tiledgrid", "v1-hashgrid"])
def test_train_step_with_tv_and_distortion_matches_jax(tmp_path, monkeypatch, config):
    """One f32 step with ``tv_weight`` and ``distortion_weight`` > 0 on the
    turbo march (per placed slot: padded slots weigh 0) and on the v1
    march (the hash grid, whose level 0 is dense; the sample points
    rounded as JAX rounds them, ``_one_rounding``), with JAX's draws.
    The CP grid has no table: its TV term is 0."""
    from test_torch_v1_march import NC as V1_NC
    from test_torch_v1_march import RC as V1_RC
    from test_torch_v1_march import _one_rounding

    march, enc = config.split("-")
    rc, nc = (_TURBO_RC, _CP_NC) if march == "turbo" else (V1_RC, V1_NC)
    if enc == "tiledgrid":
        nc = _TILED_NC
    if march == "v1":
        _one_rounding(monkeypatch)
    H = W = 32
    n = 512
    tc = dict(iters=50, num_rays=n, workspace=str(tmp_path), tv_weight=0.5,
              distortion_weight=0.1)
    jtr, port = _trainer_pair(tmp_path, rc, nc, tc,
                              table_std=None if enc == "cpgrid" else 0.1)
    frames = tsyn.make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=H, W=W,
                                        device="cpu")["train"]
    batch = {"images": jnp.asarray(frames.images), "poses": jnp.asarray(frames.poses),
             "intrinsics": jnp.asarray(frames.intrinsics), "idx": jnp.int32(1)}
    rng = jax.random.PRNGKey(9)
    jstate, _, jmet = jax.jit(jtr.train_step)(jtr.state, jtr.aux, batch, rng)
    k_pix, k_bg, k_render = jax.random.split(rng, 3)
    draws = {"inds": _np(jax.random.randint(k_pix, (n,), 0, H * W)),
             "bg": _np(jax.random.uniform(k_bg, (n, 3))),
             "noise": _np(jax.random.uniform(k_render, (n,)))}
    tbatch = {"images": torch.from_numpy(frames.images), "poses": torch.from_numpy(frames.poses),
              "intrinsics": torch.from_numpy(frames.intrinsics), "idx": 1}
    ttr = port()
    tmet = ttr.train_step(tbatch, draws)
    _check_step(jstate, jmet, tmet, ttr.model)
    # each term moves the loss: the same step without it
    for off in ("tv_weight", "distortion_weight"):
        if off == "tv_weight" and enc == "cpgrid":
            continue
        bare = port()
        bare.train_cfg = dataclasses.replace(bare.train_cfg, **{off: 0.0})
        assert float(bare.train_step(tbatch, draws)["loss"]) < 0.99 * float(tmet["loss"]), off


def _guidance_pose():
    from ngp_tpu_torch.data.nerf_dataset import rand_poses

    return rand_poses(np.random.default_rng(3), 1, radius=2.2)[0]


def test_guidance_step_matches_jax(tmp_path):
    """One random-pose guidance step (``GradientImageLoss`` on a 16 x 12
    full frame, white background, every ray perturbed by JAX's noise) on
    a fixed pose: the loss and every gradient."""
    from ngp_tpu.training.clip_guidance import GradientImageLoss as JGradientImageLoss
    from ngp_tpu_torch.training.clip_guidance import GradientImageLoss

    tc = dict(iters=50, num_rays=1024, workspace=str(tmp_path), rand_pose=2)
    jtr, port = _trainer_pair(tmp_path, _TURBO_RC, _CP_NC, tc)
    jtr.guidance_loss = JGradientImageLoss("x")
    pose = _guidance_pose()
    intr = np.array([16.0, 16.0, 6.0, 8.0], np.float32)
    rH, rW = 16, 12
    rng = jax.random.PRNGKey(4)
    batch = {"pose": jnp.asarray(pose), "intrinsics": jnp.asarray(intr),
             "image_h": jnp.zeros((rH,)), "image_w": jnp.zeros((rW,))}
    jstate, _, jmet = jax.jit(jtr.guidance_step)(jtr.state, jtr.aux, batch, rng)
    ttr = port()
    ttr.guidance_loss = GradientImageLoss("x")
    tmet = ttr.guidance_step({"pose": torch.from_numpy(pose), "intrinsics": torch.from_numpy(intr),
                              "rH": rH, "rW": rW},
                             {"noise": _np(jax.random.uniform(rng, (rH * rW,)))})
    _check_step(jstate, jmet, tmet, ttr.model)


def test_loader_guidance_batches_match_jax(tmp_path):
    """With ``rand_pose`` = 2 and a guidance loss, both loaders draw the
    same epoch order and the same random poses from one generator; a
    guidance batch scales the intrinsics by s = sqrt(H * W / num_rays)
    and the frame to at least 8 x 8. ``train_one_epoch`` counts its
    guidance steps as steps; without a guidance loss they are skipped."""
    from ngp_tpu.training.clip_guidance import GradientImageLoss as JGradientImageLoss
    from ngp_tpu_torch.training.clip_guidance import GradientImageLoss

    tc = dict(iters=50, num_rays=64, workspace=str(tmp_path), rand_pose=2, seed=5)
    jtr, port = _trainer_pair(tmp_path, _TURBO_RC, _CP_NC, tc)
    ds = tsyn.make_synthetic_frames(n_train=4, n_val=0, n_test=0, H=24, W=20,
                                    device="cpu")["train"]
    jtr.guidance_loss = JGradientImageLoss()
    ttr = port()
    want = list(jtr.make_loader(ds)())
    assert not [b for b in port().make_loader(ds)() if "guidance" in b]  # no loss: skipped
    ttr.guidance_loss = GradientImageLoss()
    got = list(ttr.make_loader(ds)())
    assert len(got) == len(want) == 6
    assert sum("guidance" in b for b in got) == 2
    for g, w in zip(got, want):
        assert ("guidance" in g) == ("guidance" in w)
        if "guidance" in g:
            np.testing.assert_array_equal(g["pose"].numpy(), np.asarray(w["pose"]))
            np.testing.assert_array_equal(g["intrinsics"].numpy(), np.asarray(w["intrinsics"]))
            assert (g["rH"], g["rW"]) == (w["image_h"].shape[0], w["image_w"].shape[0]) == (8, 8)
        else:
            assert g["idx"] == int(w["idx"])
    losses = []
    guidance_step = ttr.guidance_step
    ttr.guidance_step = lambda b, d=None: losses.append(guidance_step(b, d)["loss"])
    ttr.train_one_epoch(ttr.make_loader(ds)())
    assert ttr.global_step == 6 and len(losses) == 2 and np.isfinite(losses).all()


def test_turbo_render_weights_share_the_slot_layout():
    """What the distortion term reads from a turbo train render:
    ``weights``, ``ts`` and ``deltas`` per placed slot [N, S], ts
    ascending along the valid slots, and weight 0 on every slot the march
    did not fill or the budget dropped."""
    from ngp_tpu_torch.models.nerf import make_fused_density

    rc = tconfig.RenderConfig(**dict(_TURBO_RC, compact_mean_samples=2))
    net = TNeRFNetwork(tconfig.NetworkConfig(**_CP_NC), rc, torch.Generator().manual_seed(1),
                       device="cpu")
    occ = to.init_occupancy(rc, device="cpu")
    rng = np.random.default_rng(12)
    ro = np.tile(np.array([[0.1, -0.2, -2.5]], np.float32), (64, 1))
    rd = rng.normal(size=(64, 3)).astype(np.float32) * 0.2 + np.array([0, 0, 1], np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    noise = torch.from_numpy(rng.uniform(size=64).astype(np.float32))
    ro_t, rd_t = torch.from_numpy(ro), torch.from_numpy(rd)
    out = to.render_rays_grid_turbo(make_fused_density(net), net.color, ro_t, rd_t, occ, rc,
                                    perturb=True, noise=noise)
    m = to.march_rays_turbo(ro_t, rd_t, occ, rc, perturb=True, noise=noise)
    assert out["weights"].shape == out["ts"].shape == out["deltas"].shape == m["mask"].shape
    _eq(out["ts"], m["ts"])
    assert not bool(out["weights"][~m["mask"]].any())
    kept = out["weights"] > 0
    assert 0 < int(kept.sum()) <= int(out["n_samples"]) < int(m["mask"].sum())  # a binding budget
    ts = torch.where(m["mask"], m["ts"], torch.tensor(float("inf")))
    assert bool((ts[:, 1:] >= ts[:, :-1]).all())
