"""The port's uniform + PDF renderer (``ngp_tpu_torch/models/renderer.py``)
and the non-grid ``NeRFTrainer`` against the JAX package on the same
inputs, weights and random draws: ``sample_pdf``, ``composite``,
``render_rays`` (with and without PDF samples and perturbation, f32 and
bf16), one train step and a frame.

jax.random and torch draw different numbers, so each test draws with
JAX's own key splits (``render_rays`` splits its key once for the
perturbation and once more for the PDF draw) and hands the numbers over.

Tolerances. ``sample_pdf``: the same bin for every new sample and z to
1e-6 plus what the CDF's rounding moves it (XLA:CPU sums the CDF as a
tree, ``torch.cumsum`` in order: T 2^-24 apart at most, divided by the
sample's bin mass, times the bin's width; more than 95% of the samples
within 1e-6). ``composite`` and ``render_rays`` in f32: image, depth and
weights_sum to 1e-5, each parameter gradient to 1e-4 of its largest
entry (f32 sums in another order: the exclusive cumulative product, the
MLPs). In bf16: image and weights_sum to 2e-2 and depth to 5e-2 (a
flipped bf16 rounding of a hidden unit moves a sample's density or
colour by about 1e-2). The train step: the loss to 1e-5 relative and
every gradient to 1e-4 of its largest entry, on a hash grid of one
hashed level of resolution 16 and on a CP grid through the fused
density's plain version. JAX runs these op by op, not under ``jit``:
compiled, XLA:CPU fuses the lattice and the sample points into
multiply-adds, which round once where the port rounds twice, and a
sample one ulp away can flip a ReLU of the sigma MLP (measured: 12 of
the table's 8192 gradient entries 1.6e-3 of the largest off). The frame:
f32 pixels to 1e-4 on average, u8 pixels within one level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu import config as jconfig
from ngp_tpu.models import renderer as jr
from ngp_tpu.models.nerf import NeRFNetwork as JNeRFNetwork
from ngp_tpu.training.nerf import NeRFTrainer as JNeRFTrainer
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch.data import synthetic as tsyn
from ngp_tpu_torch.models import renderer as tr
from ngp_tpu_torch.models.nerf import NeRFNetwork as TNeRFNetwork
from ngp_tpu_torch.models.nerf import params_from_jax
from ngp_tpu_torch.training.nerf import NeRFTrainer as TNeRFTrainer
from test_torch_occupancy import _rays
from test_torch_train_step import _grad_recorder, _np, _scaled

RC = dict(bound=1.0, min_near=0.05, num_steps=24, upsample_steps=0)
# one hashed level of resolution 16 (17^3 = 4913 corners in 4096 rows)
HASH_NC = dict(encoding="hashgrid", use_bf16=False, num_levels=1, base_resolution=16,
               log2_hashmap_size=12, sh_degree=3)
CP_NC = dict(encoding="cpgrid", use_bf16=False, cp_resolutions=(32, 64), cp_rank=16,
             cp_freq_degree=4, sh_degree=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one thread for the module (the files that import this
    fixture too): in a test run that keeps every core busy, a pool of one
    thread per core waits at its barriers many times longer than the work
    takes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(tmp_path, rc, nc, tc=None, table_std=0.3):
    """A JAX ``NeRFTrainer`` that records its gradients and the port's on
    the same weights; a grid table is redrawn N(0, table_std), so that the
    encoder's features move the density (the initial table is 1e-4)."""
    tc = {**dict(iters=50, num_rays=256, workspace=str(tmp_path)), **(tc or {})}
    jrc = jconfig.RenderConfig(**rc)
    jtr = JNeRFTrainer(JNeRFNetwork(cfg=jconfig.NetworkConfig(**nc), render=jrc), jrc,
                       jconfig.TrainConfig(**tc), log_every=10**9, use_tensorboard=False)
    jtr.tx = _grad_recorder()
    jtr.ensure_initialized()
    params = jax.tree.map(lambda a: a, jtr.state.params)
    rng = np.random.default_rng(8)
    for enc in ("encoder", "encoder_bg"):
        if "embeddings" in params["params"].get(enc, {}):
            emb = params["params"][enc]["embeddings"]
            params["params"][enc]["embeddings"] = jnp.asarray(
                rng.normal(scale=table_std, size=emb.shape).astype(np.float32))
    jtr.state = jtr.state.replace(params=params, ema_params=params)
    net = TNeRFNetwork(tconfig.NetworkConfig(**nc), tconfig.RenderConfig(**rc), device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    ttr = TNeRFTrainer(net, net.render, tconfig.TrainConfig(**tc))
    return jtr, ttr


def _ray_batch(n=64, seed=0):
    """Rays into the box, and a few that miss it or point away."""
    ro, rd = _rays(n, seed)
    rd[:3] = [[0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [0.0, 0.8, 0.6]]
    return ro, rd


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# sample_pdf and composite
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drawn", [False, True])
def test_sample_pdf_matches_jax(drawn):
    rng = np.random.default_rng(1)
    B, T, n = 64, 33, 24
    bins = np.sort(rng.uniform(0.5, 3.0, (B, T)), axis=-1).astype(np.float32)
    w = rng.exponential(size=(B, T - 1)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.3] = 0.0
    w[:4] = 0.0  # rays whose coarse weights are all zero
    key = jax.random.PRNGKey(2) if drawn else None
    want = np.asarray(jr.sample_pdf(jnp.asarray(bins), jnp.asarray(w), n, key))
    u = _np(jax.random.uniform(key, (B, n))) if drawn else None
    got = tr.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), n, u).numpy()
    assert got.shape == want.shape == (B, n)
    # the bin of every new sample, but for those on a bin's edge (z equal
    # to a bin value, where either bin gives the same z: the uniform CDF of
    # an all-zero row meets the midpoint lattice there)
    on_edge = np.zeros(want.shape, bool)
    for b in range(B):
        on_edge[b] = np.abs(want[b][:, None] - bins[b][None, :]).min(axis=1) <= 1e-6
        np.testing.assert_array_equal(
            np.searchsorted(bins[b], got[b], side="right")[~on_edge[b]],
            np.searchsorted(bins[b], want[b], side="right")[~on_edge[b]])
    assert on_edge.mean() < 0.1
    # z to 1e-6, plus what the CDF's rounding moves it: the two cumulative
    # sums of T terms of total 1 differ by up to T 2^-24, which a sample
    # turns into a shift of that over its bin's mass times the bin's width
    k = np.stack([np.searchsorted(bins[b], want[b], side="right") - 1 for b in range(B)])
    k = np.clip(k, 0, T - 2)
    w1 = w.astype(np.float64) + 1e-5
    mass = np.take_along_axis(w1 / w1.sum(axis=-1, keepdims=True), k, axis=-1)
    width = np.take_along_axis(np.diff(bins, axis=-1), k, axis=-1)
    bound = 1e-6 + T * 2.0**-24 * width / np.maximum(mass, 1e-5)
    err = np.abs(got - want)
    assert (err <= bound).all(), float((err - bound).max())
    assert (err <= 1e-6).mean() > 0.95


def test_composite_matches_jax():
    rng = np.random.default_rng(3)
    N, T = 50, 40
    sig = (rng.exponential(size=(N, T)) * rng.uniform(0.0, 4.0, (N, 1))).astype(np.float32)
    rgb = rng.uniform(size=(N, T, 3)).astype(np.float32)
    dlt = rng.uniform(0.01, 0.08, (N, T)).astype(np.float32)
    g_img = rng.normal(size=(N, 3)).astype(np.float32)
    g_ws = rng.normal(size=(N,)).astype(np.float32)

    def jloss(s, c):
        out = jr.composite(s, c, jnp.asarray(dlt), 1.3)
        return jnp.sum(out["image"] * g_img) + jnp.sum(out["weights_sum"] * g_ws), out

    (_, want), (gs_j, gc_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(sig), jnp.asarray(rgb))
    s = torch.from_numpy(sig).requires_grad_()
    c = torch.from_numpy(rgb).requires_grad_()
    got = tr.composite(s, c, torch.from_numpy(dlt), 1.3)
    ((got["image"] * torch.from_numpy(g_img)).sum()
     + (got["weights_sum"] * torch.from_numpy(g_ws)).sum()).backward()
    for k in ("weights", "weights_sum", "image"):
        _close(got[k].detach(), want[k], 1e-5)
    _scaled(s.grad, gs_j, 1e-4)
    _scaled(c.grad, gc_j, 1e-4)
    assert float(want["weights_sum"].min()) < 0.5 < float(want["weights_sum"].max())


# ---------------------------------------------------------------------------
# render_rays on the network
# ---------------------------------------------------------------------------


def _jax_draws(key, n, T, U, perturb):
    """The numbers JAX's render_rays draws from ``key``."""
    if not perturb:
        return None, None
    key, k = jax.random.split(key)
    noise = _np(jax.random.uniform(k, (n, T)))
    pdf_u = None
    if U > 0:
        key, k = jax.random.split(key)
        pdf_u = _np(jax.random.uniform(k, (n, U)))
    return noise, pdf_u


def _render_both(jtr, ttr, ro, rd, perturb, key, cots):
    """Render and differentiate sum(image * c0) + sum(depth * c1) +
    sum(weights_sum * c2) on both sides; returns (JAX outputs, JAX
    gradients as the port's state dict, port outputs)."""
    cfg = jtr.render_cfg
    c0, c1, c2 = cots

    def jloss(params):
        d, c, b = jtr._fns(params)
        out = jr.render_rays(d, c, jnp.asarray(ro), jnp.asarray(rd), cfg,
                             rng=key if perturb else None, perturb=perturb, bg_fn=b)
        return (jnp.sum(out["image"] * c0) + jnp.sum(out["depth"] * c1)
                + jnp.sum(out["weights_sum"] * c2)), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jtr.state.params)
    noise, pdf_u = _jax_draws(key, ro.shape[0], cfg.num_steps, cfg.upsample_steps, perturb)
    d, c, b = ttr._fns()
    tout = tr.render_rays(d, c, torch.from_numpy(ro), torch.from_numpy(rd), ttr.render_cfg,
                          perturb=perturb, bg_fn=b, noise=noise, pdf_u=pdf_u)
    ((tout["image"] * torch.from_numpy(c0)).sum() + (tout["depth"] * torch.from_numpy(c1)).sum()
     + (tout["weights_sum"] * torch.from_numpy(c2)).sum()).backward()
    return jout, params_from_jax(jax.tree.map(np.asarray, jg)), tout


def _cots(n, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n,)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32))


@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("upsample", [0, 8])
def test_render_rays_matches_jax(tmp_path, upsample, perturb):
    jtr, ttr = _pair(tmp_path, dict(RC, upsample_steps=upsample), HASH_NC)
    ro, rd = _ray_batch()
    jout, jgrads, tout = _render_both(jtr, ttr, ro, rd, perturb, jax.random.PRNGKey(5),
                                      _cots(ro.shape[0]))
    T = RC["num_steps"] + upsample
    assert tout["weights"].shape == tout["z_vals"].shape == tout["deltas"].shape == (64, T)
    for k in ("image", "depth", "weights_sum", "weights"):
        _close(tout[k].detach(), jout[k], 1e-5)
    for k in ("z_vals", "deltas"):
        _close(tout[k], jout[k], 2e-6)
    assert torch.equal(tout["ts"], tout["z_vals"])
    ws = np.asarray(jout["weights_sum"])
    assert ws[:3].max() == 0.0 and ws.max() > 0.1  # the misses, and content
    for name, p in ttr.model.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        _scaled(p.grad, jgrads[name], 1e-4)


def test_render_rays_bf16_matches_jax(tmp_path):
    jtr, ttr = _pair(tmp_path, dict(RC, upsample_steps=8), dict(HASH_NC, use_bf16=True))
    ro, rd = _ray_batch(seed=1)
    jout, _, tout = _render_both(jtr, ttr, ro, rd, True, jax.random.PRNGKey(6),
                                 _cots(ro.shape[0]))
    _close(tout["image"].detach(), jout["image"], 2e-2)
    _close(tout["weights_sum"].detach(), jout["weights_sum"], 2e-2)
    _close(tout["depth"].detach(), jout["depth"], 5e-2)
    assert float(np.abs(np.asarray(jout["image"]) - 1.0).max()) > 0.05


def test_render_rays_draws_from_the_generator_when_given_no_draws():
    rc = tconfig.RenderConfig(**dict(RC, upsample_steps=8))
    net = TNeRFNetwork(tconfig.NetworkConfig(**HASH_NC), rc, device="cpu")
    ro, rd = (torch.from_numpy(a) for a in _ray_batch())

    def render(seed, perturb=True):
        with torch.no_grad():
            return tr.render_rays(net.density, net.color, ro, rd, rc, perturb=perturb,
                                  generator=torch.Generator().manual_seed(seed))["z_vals"]

    assert torch.equal(render(0), render(0)) and not torch.equal(render(0), render(1))
    assert torch.equal(render(0, False), render(1, False))
    z = render(2)
    assert bool((z[:, 1:] >= z[:, :-1]).all())  # merged in order


# ---------------------------------------------------------------------------
# the non-grid trainer: a train step and a frame
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("enc,upsample", [("hashgrid", 0), ("hashgrid", 8), ("cpgrid", 8)])
def test_train_step_matches_jax(tmp_path, enc, upsample):
    """One f32 step of ``NeRFTrainer`` with JAX's draws: the loss, and every
    gradient, which with Adam's first step decides the updated weights.
    With ``distortion_weight`` the term reads the renderer's weights, z
    values and deltas."""
    H = W = 24
    n = 128
    nc = HASH_NC if enc == "hashgrid" else CP_NC
    jtr, ttr = _pair(tmp_path, dict(RC, upsample_steps=upsample), nc,
                     dict(num_rays=n, distortion_weight=0.01))
    frames = tsyn.make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=H, W=W,
                                        device="cpu")["train"]
    batch = {"images": jnp.asarray(frames.images), "poses": jnp.asarray(frames.poses),
             "intrinsics": jnp.asarray(frames.intrinsics), "idx": jnp.int32(1)}
    rng = jax.random.PRNGKey(9)
    # op by op, not under jit: XLA then contracts no multiply-add, and the
    # sample points round as the port's do
    jstate, _, jmet = jtr.train_step(jtr.state, jtr.aux, batch, rng)
    k_pix, k_bg, k_render = jax.random.split(rng, 3)
    noise, pdf_u = _jax_draws(k_render, n, RC["num_steps"], upsample, True)
    draws = {"inds": _np(jax.random.randint(k_pix, (n,), 0, H * W)),
             "bg": _np(jax.random.uniform(k_bg, (n, 3))), "noise": noise}
    if pdf_u is not None:
        draws["pdf_u"] = pdf_u
    tbatch = {"images": torch.from_numpy(frames.images), "poses": torch.from_numpy(frames.poses),
              "intrinsics": torch.from_numpy(frames.intrinsics), "idx": 1}
    tmet = ttr.train_step(tbatch, draws)
    loss = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - loss) <= 1e-5 * loss and loss > 0
    jgrads = params_from_jax(jax.tree.map(np.asarray, jstate.opt_state["g"]))
    assert set(jgrads) == {k for k, _ in ttr.model.named_parameters()}
    for name, p in ttr.model.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        _scaled(p.grad, jgrads[name], 1e-4)


def _frame_pose(angle=0.4):
    o = np.array([2.4 * np.sin(angle), 0.5, -2.4 * np.cos(angle)], np.float32)
    f = -o / np.linalg.norm(o)
    r = np.cross(f, [0.0, 1.0, 0.0])
    r /= np.linalg.norm(r)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = r, np.cross(f, r), f, o
    return pose


INTR = np.array([26.0, 26.0, 12.0, 12.0], np.float32)


def test_render_frame_matches_jax(tmp_path):
    """``render_frame`` at 24x24 without the occupancy grid: the projected
    box's pixels in chunks, 8 PDF samples a ray, on JAX's weights."""
    jtr, ttr = _pair(tmp_path, dict(RC, upsample_steps=8), HASH_NC)
    pose = _frame_pose()
    for t in (jtr, ttr):
        t.eval_f32_frames = True
    img_j, dep_j = jtr.render_frame(pose, INTR, 24, 24, chunk=128)
    img_t, dep_t = ttr.render_frame(pose, INTR, 24, 24, chunk=128)
    assert img_t.shape == (24, 24, 3) and dep_t.shape == (24, 24)
    diff = np.abs(img_t - np.asarray(img_j))
    assert diff.mean() <= 1e-4 and diff.max() <= 1e-3
    assert np.abs(dep_t - np.asarray(dep_j)).mean() <= 1e-4
    assert np.abs(np.asarray(img_j) - 1.0).max() > 0.05  # the frame has content
    ttr.eval_f32_frames = jtr.eval_f32_frames = False
    img_j, _ = jtr.render_frame(pose, INTR, 24, 24, chunk=128)
    img_t, _ = ttr.render_frame(pose, INTR, 24, 24, chunk=128)
    assert np.abs(np.round(img_t * 255.0) - np.round(np.asarray(img_j) * 255.0)).max() <= 1.0
