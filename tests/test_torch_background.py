"""The background net (``bg_radius > 0``) and the inference crop box
against the JAX package: the 2-D grid encoder's plain version (hashed and
dense levels, f32 and bf16, points on the box's edge) and its table
gradient, ``NeRFNetwork.background``, one ``GridNeRFTrainer`` step with
the background through the turbo march and through the v1 march, one
``NeRFTrainer`` step with it, a frame whose prepass culls rays and whose
culled pixels come from the background pass (``_render_bg_frames``), and
``aabb_infer``.

Tolerances. The encoder: f32 features to 1e-6, bf16 to one bf16 step of
the feature (2^-8 relative, the rounding of a sum of bf16 products taken
in another order), the table gradient to 1e-6 of its largest entry, and
in bf16 besides n 2^-8 times the sum of a row's n terms' magnitudes (JAX
adds them in bf16, the port in f32).
``background``: f32 to 1e-5, its parameter gradients to 1e-4 of their
largest entries; bf16 to 2e-2 (a flipped bf16 rounding of a hidden
unit). The train steps: the loss to 1e-5 relative and every gradient to
1e-4 of its largest entry, JAX run op by op (see
``test_torch_renderer.py``); the v1 march with the sample points rounded
as JAX rounds them (``test_torch_v1_march.py:_one_rounding``). The
frames: f32 pixels to 1e-4 on average, at least 99.5% within 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu import config as jconfig
from ngp_tpu.models.nerf import NeRFNetwork as JNeRFNetwork
from ngp_tpu.ops import hashgrid as jhg
from ngp_tpu.ops.rays import sph_from_ray as jsph_from_ray
from ngp_tpu.training.nerf_grid import GridNeRFTrainer as JGridNeRFTrainer
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch.data import synthetic as tsyn
from ngp_tpu_torch.models import occupancy as to
from ngp_tpu_torch.models.nerf import NeRFNetwork as TNeRFNetwork
from ngp_tpu_torch.models.nerf import params_from_jax
from ngp_tpu_torch.ops import hashgrid as thg
from ngp_tpu_torch.ops.kernels import hashgrid as kh
from ngp_tpu_torch.ops.rays import sph_from_ray
from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer as TGridNeRFTrainer
from test_torch_renderer import CP_NC, HASH_NC, RC, _pair, one_torch_thread  # noqa: F401
from test_torch_train_step import _TILED_NC, _TURBO_RC, _grad_recorder, _np, _scaled

BG = 4.0
# the background encoder's geometry (NeRFNetwork.encoder_bg), and a smaller
# one whose three levels are all dense
GRIDS_2D = {
    "bg": dict(input_dim=2, num_levels=4, log2_hashmap_size=19, desired_resolution=2048),
    "dense": dict(input_dim=2, num_levels=3, base_resolution=4, log2_hashmap_size=12,
                  desired_resolution=32),
}


def _sph_points(n=3000, seed=0):
    """(sph + 1) / 2 of rays from inside the sphere, as the background net
    reads them, then points on the box's edges (exactly 0 and 1: inside)
    and a float past them (outside)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = (np.asarray(jsph_from_ray(jnp.asarray(o), jnp.asarray(d), BG)) + 1.0) / 2.0
    f32 = np.float32
    edge = np.array([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.5], [0.5, 0.0],
                     [-1e-7, 0.5], [0.5, np.nextafter(f32(1.0), f32(2.0))]], np.float32)
    return np.concatenate([x, edge]).astype(np.float32)


# ---------------------------------------------------------------------------
# the 2-D grid encoder and the background net
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(GRIDS_2D))
def test_grid_encode_2d_matches_jax(name, dtype):
    jcfg = jhg.GridConfig(**GRIDS_2D[name])
    tcfg = thg.GridConfig(**GRIDS_2D[name])
    assert tcfg.offsets == jcfg.offsets
    hashed = tcfg.geometry.hashed
    assert (name == "bg") == any(hashed) and (name == "bg") == hashed[-1]
    x = _sph_points()
    table = np.random.default_rng(1).uniform(-1, 1, (tcfg.num_rows, 2)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    want, vjp = jax.vjp(lambda t: jhg.grid_encode(jnp.asarray(x), t, jcfg, jdt),
                        jnp.asarray(table))
    got = thg.grid_encode(torch.from_numpy(x), torch.from_numpy(table), tcfg, tdt)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    tol = 1e-6 + (0.0 if dtype == "float32" else 2.0**-8 * np.abs(want))
    assert (np.abs(got - want) <= tol).all(), float(np.abs(got - want).max())
    edge = x[-7:]
    outside = ((edge < 0) | (edge > 1)).any(axis=-1)
    assert outside.tolist() == [False] * 5 + [True] * 2
    assert not got[-2:].any() and np.abs(got[-7:-2]).sum(axis=1).min() > 0
    # the table gradient, against jax.vjp (bf16: the port sums in f32)
    g = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    g[np.random.default_rng(3).uniform(size=len(g)) < 0.5] = 0.0
    (jg,) = vjp(jnp.asarray(g).astype(want.dtype if jdt is None else jdt))
    tg = kh.grid_encode_bwd_plain(torch.from_numpy(x), torch.from_numpy(g).to(tdt or
                                                                              torch.float32),
                                  tcfg.geometry)
    jg = np.asarray(jg.astype(jnp.float32))
    bound = 1e-6 * np.abs(jg).max()
    if dtype == "bfloat16":
        # JAX adds a row's n bf16 products in bf16, the port in f32: each of
        # JAX's n additions rounds by up to 2^-8 (bf16's unit roundoff) of a
        # partial sum, at most the sum of the terms' magnitudes
        geom = tcfg.geometry
        xt = torch.from_numpy(x)
        idx, _ = kh.grid_encode_bwd_rows_plain(xt, torch.from_numpy(g), geom)
        n = np.bincount(idx[idx >= 0].numpy(), minlength=tcfg.num_rows)[:, None]
        s_abs = kh.grid_encode_bwd_plain(xt, torch.from_numpy(np.abs(g)), geom).numpy()
        bound = bound + n * 2.0**-8 * s_abs
    assert (np.abs(tg.numpy() - jg) <= bound).all()


def _networks(use_bf16=False, seed=0):
    """JAX's NeRFNetwork with the background net (a hash grid of one
    level), its params with the background table redrawn U(-1, 1), and the
    port's network on them."""
    nc = dict(HASH_NC, use_bf16=use_bf16)
    jrc = jconfig.RenderConfig(**dict(RC, bg_radius=BG))
    model = JNeRFNetwork(cfg=jconfig.NetworkConfig(**nc), render=jrc)
    x0 = jnp.zeros((8, 3))
    d0 = jnp.concatenate([jnp.ones((8, 1)), jnp.zeros((8, 2))], axis=-1)
    params = model.init(jax.random.PRNGKey(seed), x0, d0, method=JNeRFNetwork.full_init)
    params = jax.tree.map(lambda a: a, params)
    emb = params["params"]["encoder_bg"]["embeddings"]
    params["params"]["encoder_bg"]["embeddings"] = jnp.asarray(
        np.random.default_rng(seed).uniform(-1, 1, emb.shape).astype(np.float32))
    net = TNeRFNetwork(tconfig.NetworkConfig(**nc), tconfig.RenderConfig(**dict(RC, bg_radius=BG)),
                       device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return model, params, net


def test_background_net_layout_and_seeded_init():
    """The background modules are drawn after the others: the rest of the
    network is the same with and without them, and the bg encoder is
    get_encoder's 2-D grid of 4 levels to 2048."""
    nc = tconfig.NetworkConfig(**HASH_NC)
    with_bg = TNeRFNetwork(nc, tconfig.RenderConfig(bg_radius=BG),
                           torch.Generator().manual_seed(3), device="cpu")
    without = TNeRFNetwork(nc, tconfig.RenderConfig(), torch.Generator().manual_seed(3),
                           device="cpu")
    sd = with_bg.state_dict()
    for k, v in without.state_dict().items():
        assert torch.equal(sd[k], v), k
    cfg = with_bg.encoder_bg.cfg
    jcfg = jhg.GridConfig(input_dim=2, num_levels=4, log2_hashmap_size=19,
                          desired_resolution=2048)
    assert (cfg.input_dim, cfg.num_levels, cfg.offsets) == (2, 4, jcfg.offsets)
    sh_dim = nc.sh_degree**2
    assert [tuple(w.shape) for w in with_bg.bg_net.weights] == [(sh_dim + 8, 64), (64, 3)]
    with pytest.raises(ValueError, match="bg_radius"):
        without.background(torch.zeros((1, 2)), torch.ones((1, 3)))


@pytest.mark.parametrize("use_bf16", [False, True])
def test_background_matches_jax(use_bf16):
    model, params, net = _networks(use_bf16)
    rng = np.random.default_rng(4)
    o = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sph_j = jsph_from_ray(jnp.asarray(o), jnp.asarray(d), BG)
    sph_t = sph_from_ray(torch.from_numpy(o), torch.from_numpy(d), BG)
    np.testing.assert_allclose(sph_t.numpy(), np.asarray(sph_j), atol=2e-6, rtol=0)
    cot = rng.normal(size=(256, 3)).astype(np.float32)

    def jloss(p):
        rgb = model.apply(p, sph_j, jnp.asarray(d), method=JNeRFNetwork.background)
        return jnp.sum(rgb * cot), rgb

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    # the same sphere coordinates on both sides: atan2 may differ by an ulp
    got = net.background(torch.from_numpy(np.asarray(sph_j)), torch.from_numpy(d))
    (got * torch.from_numpy(cot)).sum().backward()
    tol = 2e-2 if use_bf16 else 1e-5
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=0)
    assert float(np.asarray(want).std()) > 0.01
    if not use_bf16:
        jgrads = params_from_jax(jax.tree.map(np.asarray, jg))
        for name in ("encoder_bg.embeddings", "bg_net.dense_0", "bg_net.dense_1"):
            p = dict(net.named_parameters())[name]
            assert float(p.grad.abs().max()) > 0, name
            _scaled(p.grad, jgrads[name], 1e-4)


# ---------------------------------------------------------------------------
# train steps with the background
# ---------------------------------------------------------------------------


_V1_RC = dict(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=64, max_samples_per_ray=16,
              grid_size=16, density_thresh=10.0, turbo=False)


def _grid_pair(tmp_path, rc, nc, tc):
    """A JAX GridNeRFTrainer recording its gradients (three refreshes of
    its grid, the spatial and background tables redrawn) and the port's
    trainer on the same weights and grid."""
    jrc = jconfig.RenderConfig(**rc)
    jtr = JGridNeRFTrainer(JNeRFNetwork(cfg=jconfig.NetworkConfig(**nc), render=jrc), jrc,
                           jconfig.TrainConfig(**tc), log_every=10**9, use_tensorboard=False)
    jtr.tx = _grad_recorder()
    jtr.ensure_initialized()
    params = jax.tree.map(lambda a: a, jtr.state.params)
    rng = np.random.default_rng(8)
    for enc, std in (("encoder", 0.3), ("encoder_bg", 1.0)):
        if "embeddings" in params["params"].get(enc, {}):
            emb = params["params"][enc]["embeddings"]
            params["params"][enc]["embeddings"] = jnp.asarray(
                rng.normal(scale=std, size=emb.shape).astype(np.float32))
    jtr.state = jtr.state.replace(params=params, ema_params=params)
    for _ in range(3):
        jtr._update_occupancy()
    net = TNeRFNetwork(tconfig.NetworkConfig(**nc), tconfig.RenderConfig(**rc), device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    ttr = TGridNeRFTrainer(net, net.render, tconfig.TrainConfig(**tc))
    occ = jtr.aux["occ"]
    ttr.aux = {"occ": to.occupancy_from_jax(
        {f.name: np.asarray(getattr(occ, f.name)) for f in dataclasses.fields(occ)},
        device="cpu")}
    return jtr, ttr


@pytest.mark.parametrize("config", ["turbo-tiledgrid", "v1-hashgrid", "uniform-hashgrid"])
def test_train_step_with_background_matches_jax(tmp_path, monkeypatch, config):
    """One f32 step with ``bg_radius > 0``: the render composites the
    background net (white ground-truth background, no random one), on the
    turbo march, the v1 march and the uniform renderer; the loss and every
    gradient, the background's included. Both sides read the sphere
    coordinates JAX computes (``sph_from_ray`` is held to JAX's in
    ``test_background_matches_jax``): atan2 differs by an ulp, and on the
    2048-cell level a point that moves can flip a ReLU of the background
    MLP (measured once: 24 of the background table's 1.4 M gradient
    entries 3e-3 of the largest off)."""
    from ngp_tpu_torch.models import renderer as tr
    from test_torch_v1_march import _one_rounding

    monkeypatch.setattr(tr, "sph_from_ray", lambda o, d, r: torch.from_numpy(np.asarray(
        jsph_from_ray(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), r))))
    n = 256
    tc = dict(iters=50, num_rays=n, workspace=str(tmp_path))
    if config == "turbo-tiledgrid":
        jtr, ttr = _grid_pair(tmp_path, dict(_TURBO_RC, bg_radius=BG), _TILED_NC, tc)
    elif config == "v1-hashgrid":
        _one_rounding(monkeypatch)
        jtr, ttr = _grid_pair(tmp_path, dict(_V1_RC, bg_radius=BG), HASH_NC, tc)
    else:
        jtr, ttr = _pair(tmp_path, dict(RC, bg_radius=BG), HASH_NC, dict(num_rays=n))
    H = W = 24
    frames = tsyn.make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=H, W=W,
                                        device="cpu")["train"]
    batch = {"images": jnp.asarray(frames.images), "poses": jnp.asarray(frames.poses),
             "intrinsics": jnp.asarray(frames.intrinsics), "idx": jnp.int32(1)}
    rng = jax.random.PRNGKey(11)
    jstate, _, jmet = jtr.train_step(jtr.state, jtr.aux, batch, rng)
    k_pix, _, k_render = jax.random.split(rng, 3)
    draws = {"inds": _np(jax.random.randint(k_pix, (n,), 0, H * W))}
    if config == "uniform-hashgrid":
        draws["noise"] = _np(jax.random.uniform(jax.random.split(k_render)[1],
                                                (n, RC["num_steps"])))
    else:
        draws["noise"] = _np(jax.random.uniform(k_render, (n,)))
    tbatch = {"images": torch.from_numpy(frames.images), "poses": torch.from_numpy(frames.poses),
              "intrinsics": torch.from_numpy(frames.intrinsics), "idx": 1}
    tmet = ttr.train_step(tbatch, draws)
    loss = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - loss) <= 1e-5 * loss and loss > 0
    jgrads = params_from_jax(jax.tree.map(np.asarray, jstate.opt_state["g"]))
    assert {"encoder_bg.embeddings", "bg_net.dense_0", "bg_net.dense_1"} <= set(jgrads)
    assert set(jgrads) == {k for k, _ in ttr.model.named_parameters()}
    for name, p in ttr.model.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        _scaled(p.grad, jgrads[name], 1e-4)


# ---------------------------------------------------------------------------
# frames: the background pass and the crop box
# ---------------------------------------------------------------------------


def _pose(angle=0.5, radius=2.4):
    o = np.array([radius * np.sin(angle), 0.6, -radius * np.cos(angle)], np.float32)
    f = -o / np.linalg.norm(o)
    r = np.cross(f, [0.0, 1.0, 0.0])
    r /= np.linalg.norm(r)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = r, np.cross(f, r), f, o
    return pose


INTR = np.array([20.0, 20.0, 12.0, 12.0], np.float32)


def _check_frame(got, want):
    want = np.asarray(want)
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-4, diff.mean()
    assert np.mean(diff.max(axis=-1) <= 1e-3) >= 0.995


def test_render_frame_with_background_frames_matches_jax(tmp_path):
    """turbo with the prepass: the culled rays' pixels come from the
    background pass, the others from the march with the background net
    composited (f32 frames)."""
    tc = dict(iters=50, num_rays=256, workspace=str(tmp_path))
    jtr, ttr = _grid_pair(tmp_path, dict(_TURBO_RC, bg_radius=BG), CP_NC, tc)
    calls = []
    bg_frames = ttr._render_bg_frames
    ttr._render_bg_frames = lambda *a: calls.append(a) or bg_frames(*a)
    pose = _pose()
    jtr.eval_f32_frames = ttr.eval_f32_frames = True
    want, dep_j = jtr.render_frame(pose, INTR, 24, 24, chunk=128)
    got, dep_t = ttr.render_frame(pose, INTR, 24, 24, chunk=128)
    _check_frame(got, want)
    assert np.abs(dep_t - np.asarray(dep_j)).mean() <= 1e-4
    assert len(calls) == 1
    # the background reaches the culled pixels: nothing is left white
    assert float(np.abs(got - 1.0).max(axis=-1).min()) > 0.0
    with torch.no_grad():
        bg = bg_frames(*calls[-1]).reshape(24, 24, 3).numpy()
    assert float(np.abs(bg - got).max(axis=-1).min()) == 0.0  # some pixels are bg alone


@pytest.mark.parametrize("trainer", ["turbo", "uniform"])
def test_aabb_infer_matches_jax(tmp_path, trainer):
    """The inference crop box replaces the scene's box in a frame render:
    rays outside it render the background, and the render inside it
    agrees with JAX's under the same crop."""
    box = (-0.4, -0.6, -0.3, 0.5, 0.4, 0.6)
    tc = dict(iters=50, num_rays=256, workspace=str(tmp_path))
    if trainer == "turbo":
        jtr, ttr = _grid_pair(tmp_path, _TURBO_RC, CP_NC, tc)
    else:
        jtr, ttr = _pair(tmp_path, dict(RC, upsample_steps=4), HASH_NC)
    pose = _pose(1.1)
    jtr.eval_f32_frames = ttr.eval_f32_frames = True
    full, _ = ttr.render_frame(pose, INTR, 24, 24, chunk=128)
    jtr.aabb_infer = ttr.aabb_infer = box
    want, _ = jtr.render_frame(pose, INTR, 24, 24, chunk=128)
    got, _ = ttr.render_frame(pose, INTR, 24, 24, chunk=128)
    _check_frame(got, want)
    assert np.abs(got - full).max() > 0.05  # the crop changes the frame
    assert (got == 1.0).all(axis=-1).mean() > (full == 1.0).all(axis=-1).mean()


def test_background_run_follows_jax(tmp_path):
    """ROADMAP §3's case to confirm: ``-O --bg_radius 32`` on a small white
    scene on disk, with the command line's box and scale (bound 2, scale
    0.33: the cameras inside the box) and adaptive steps, cpgrid in f32.
    Both packages start from the same weights and train 12 epochs of 4
    views with their own random draws; each epoch-mean loss of the port
    lies within 10% of JAX's (measured on the CPU: 3.4% at most), both
    fall, and the density grids end alike (occupied share and mean density
    within 10%). The background net taking over the views on this scene
    is then the configuration's behaviour, not the port's."""
    from ngp_tpu.data.nerf_dataset import NeRFDataset as JNeRFDataset
    from ngp_tpu_torch.data.nerf_dataset import NeRFDataset as TNeRFDataset

    root = tsyn.make_synthetic_dataset(str(tmp_path / "scene"), n_train=4, n_val=1, n_test=1,
                                       H=24, W=24, num_steps=64, device="cpu")
    epochs = 12
    rc = dict(_TURBO_RC, bound=2.0, min_near=0.2, dt_gamma=1 / 128, bg_radius=32.0)
    tc = dict(iters=epochs * 4, lr=1e-2, num_rays=256, workspace=str(tmp_path / "ws"))
    jrc = jconfig.RenderConfig(**rc)
    jtr = JGridNeRFTrainer(JNeRFNetwork(cfg=jconfig.NetworkConfig(**CP_NC), render=jrc), jrc,
                           jconfig.TrainConfig(**tc), log_every=1, use_tensorboard=False)
    jtr.ensure_initialized()
    net = TNeRFNetwork(tconfig.NetworkConfig(**CP_NC), tconfig.RenderConfig(**rc), device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jtr.state.params)))
    ttr = TGridNeRFTrainer(net, net.render, tconfig.TrainConfig(**tc), log_every=1)
    jtr.train_on_dataset(JNeRFDataset(root, split="train", scale=0.33), None, max_epochs=epochs)
    ttr.train_on_dataset(TNeRFDataset(root, split="train", scale=0.33), None, max_epochs=epochs)
    want = np.array(jtr.stats["loss"]).reshape(epochs, -1).mean(axis=1)
    got = np.array(ttr.stats["loss"]).reshape(epochs, -1).mean(axis=1)
    assert want.shape == (epochs,) and np.isfinite(got).all()
    print(f"epoch-mean losses: JAX {np.round(want, 6).tolist()}, port "
          f"{np.round(got, 6).tolist()}, largest relative gap "
          f"{float(np.max(np.abs(got - want) / want)):.4f}")
    np.testing.assert_allclose(got, want, rtol=0.1)
    assert got[-1] < 0.6 * got[0] and want[-1] < 0.6 * want[0]
    jocc, tocc = jtr.aux["occ"], ttr.aux["occ"]
    assert float(tocc.occ_grid.float().mean()) == pytest.approx(
        float(jnp.mean(jocc.occ_grid)), rel=0.1)
    assert float(tocc.mean_density) == pytest.approx(float(jocc.mean_density), rel=0.1)
