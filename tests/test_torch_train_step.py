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
