"""The port's CCNeRF slice against the JAX package on the same inputs:
``CCNeRF.sigma_rgb`` (residual and plain) and ``density`` with JAX's
weights (``params_from_jax``), ``finalize`` (the rank order and the fused
tree), ``compress``, ``compose``, the occupancy ``bitfield``, the multi-head
turbo render ``render_rays_grid_turbo_multi``, one ``CCNeRFTrainer`` step
on each path (turbo and the v1 march) with JAX's draws, and the command
line's parser and a small ``main_CCNeRF.main`` run on the CPU.

Tolerances. f32 values to 1e-5 relative (sums over ranks and SH
channels in another order); finalize equal (the same numpy order, then
copies); bits equal. The render: images to 1e-5, the counters equal. The
train step: the loss to 1e-5 relative, every gradient to 1e-4 of its
largest entry. Finalize changes the field only by the order of f32 sums
(1e-5 relative), and a frame by at most one u8 level.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu import config as jconfig
from ngp_tpu.models import ccnerf as jcc
from ngp_tpu.models import occupancy as jo
from ngp_tpu.training import ccnerf as jcct
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch import main_CCNeRF as tmain
from ngp_tpu_torch.data import synthetic as tsyn
from ngp_tpu_torch.models import ccnerf as tcc
from ngp_tpu_torch.models import occupancy as to
from ngp_tpu_torch.training import ccnerf as tcct
from test_torch_renderer import one_torch_thread  # noqa: F401
from test_torch_sdf import jax_main_parser, parser_actions
from test_torch_train_step import _grad_recorder, _np, _scaled

# K = 3 groups; the colour vec kind has an empty group at slot 2 and the
# mat kinds one at slot 0; a non-cubic resolution catches a swapped axis
_CFG = dict(resolution=(16, 12, 20), degree=2, rank_vec_density=(2, 3, 5),
            rank_mat_density=(0, 2, 3), rank_vec=(2, 4, 4), rank_mat=(0, 1, 3))
_RC = dict(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=64, max_samples_per_ray=16,
           grid_size=16, density_thresh=10.0, coarse_candidates=48, crossing_slots=16,
           compact_mean_samples=6)


def _pair(seed=0):
    """JAX's model and params, and the port's model on the same weights."""
    jm = jcc.CCNeRF(jcc.CCNeRFConfig(**_CFG), bound=1.0)
    params = jcc.init_ccnerf(jax.random.PRNGKey(seed), jm.cfg)
    tm = tcc.CCNeRF(tcc.CCNeRFConfig(**_CFG), bound=1.0, device="cpu")
    tm.load_params(tcc.params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _rays(n=300, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _tree_np(tree):
    return {k: [{"U": [np.asarray(u.detach() if torch.is_tensor(u) else u) for u in g["U"]],
                 "S": np.asarray(g["S"].detach() if torch.is_tensor(g["S"]) else g["S"])}
                for g in v] for k, v in tree.items()}


def test_parameters_follow_the_groups():
    """The port's init: one U triple and S per non-empty group, JAX's
    shapes; ``params()`` gives them back as the JAX tree."""
    jm, params, tm = _pair()
    ours = tcc.CCNeRF(tcc.CCNeRFConfig(**_CFG), bound=1.0, device="cpu")
    for tree in (tm.params(), ours.params()):
        for kind in params:
            assert len(tree[kind]) == len(params[kind])
            for g, jg in zip(tree[kind], params[kind]):
                assert [tuple(u.shape) for u in g["U"]] == [u.shape for u in jg["U"]]
                assert tuple(g["S"].shape) == jg["S"].shape
    np.testing.assert_array_equal(_tree_np(tm.params())["mat"][1]["U"][2],
                                  np.asarray(params["mat"][1]["U"][2]))
    assert len(list(tm.parameters())) == sum(4 * len(v) for v in params.values())


@pytest.mark.parametrize("residual", [True, False])
def test_sigma_rgb_and_density_match_jax(residual):
    jm, params, tm = _pair()
    x, d = _rays()
    js, jr = jm.sigma_rgb(params, jnp.asarray(x), jnp.asarray(d), residual=residual)
    ts, tr = tm.sigma_rgb(torch.from_numpy(x), torch.from_numpy(d), residual=residual)
    K = jm.cfg.K
    assert ts.shape == ((K, 300) if residual else (300,))
    _close(ts.detach(), js)
    _close(tr.detach(), jr)
    jd, _ = jm.density(params, jnp.asarray(x).reshape(20, 15, 3))
    td, geo = tm.density(torch.from_numpy(x).reshape(20, 15, 3))
    assert td.shape == (20, 15) and geo.shape == (20, 15, 3)
    _close(td.detach(), jd)


def test_finalize_compress_and_compose_match_jax():
    """finalize: the same rank order and fused tree as JAX (and the field
    of the full rank unchanged); compress: JAX's slices and field; compose:
    a scene of the finalized model and a translated, rotated copy."""
    jm, params, tm = _pair()
    x, d = _rays()
    xt, dt = torch.from_numpy(x), torch.from_numpy(d)
    before = tm.sigma_rgb(xt, dt)
    jf = jm.finalize(jax.tree.map(np.asarray, params))
    tf = tm.finalize(tm.params())
    assert tm.cfg == dataclasses.replace(tm.cfg, **{
        k: getattr(jm.cfg, k) for k in ("rank_vec_density", "rank_mat_density", "rank_vec",
                                        "rank_mat")}) and tm.finalized
    want, got = _tree_np(jf), _tree_np(tf)
    for kind in want:
        for g, w in zip(got[kind], want[kind]):
            for a, b in zip(g["U"] + [g["S"]], w["U"] + [w["S"]]):
                np.testing.assert_array_equal(a, b)
    tm.load_params(tf)
    after = tm.sigma_rgb(xt, dt)
    for a, b in zip(after, before):
        _close(a.detach(), b.detach())
    js, jr = jm.sigma_rgb(jf, jnp.asarray(x), jnp.asarray(d))
    _close(after[0].detach(), js)
    _close(after[1].detach(), jr)
    for ranks in ((4, 2, 3, 1), (2, 0, 4, 0)):
        jsm = jcc.CCNeRF(jcc.CCNeRFConfig(**_CFG), bound=1.0)
        jsm.finalized, jsm.cfg = True, jm.cfg
        jp = jsm.compress({k: [dict(g) for g in v] for k, v in jf.items()}, ranks)
        tsm = tcc.CCNeRF(tcc.CCNeRFConfig(**_CFG), bound=1.0, device="cpu")
        tsm.finalized, tsm.cfg = True, tm.cfg
        tsm.load_params(tsm.compress(tf, ranks))
        assert tsm.cfg.rank_mat == jsm.cfg.rank_mat and tsm.cfg.rank_vec == jsm.cfg.rank_vec
        js, jr = jsm.sigma_rgb(jp, jnp.asarray(x), jnp.asarray(d))
        ts, tr = tsm.sigma_rgb(xt, dt)
        _close(ts.detach(), js)
        _close(tr.detach(), jr)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.3, -0.1, 0.2]
    c, s = np.cos(0.4), np.sin(0.4)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    jscene = jcc.CCNeRF(jm.cfg, bound=1.0).compose([(jm, jf), (jm, jf)], [None, (T, R)])
    tscene = tcc.CCNeRF(tm.cfg, bound=1.0, device="cpu").compose([(tm, tf), (tm, tf)],
                                                                 [None, (T, R)])
    js, jr = jscene.sigma_rgb(None, jnp.asarray(x), jnp.asarray(d))
    ts, tr = tscene.sigma_rgb(xt, dt)
    _close(ts.detach(), js)
    _close(tr.detach(), jr)
    jd, _ = jscene.density(None, jnp.asarray(x))
    _close(tscene.density(xt)[0].detach(), jd)


# ---------------------------------------------------------------------------
# the occupancy bitfield, the multi-head render and the residual step
# ---------------------------------------------------------------------------


def _trainer_pair(tmp_path, turbo=True, refreshes=3):
    """JAX's ``CCNeRFTrainer`` (gradients recorded, a few refreshes) and the
    port's on its weights and occupancy grid."""
    tc = dict(iters=50, lr=2e-2, num_rays=256, workspace=str(tmp_path))
    rc = dict(_RC, turbo=turbo)
    jm = jcc.CCNeRF(jcc.CCNeRFConfig(**_CFG), bound=1.0)
    jtr = jcct.CCNeRFTrainer(jm, jconfig.RenderConfig(**rc), jconfig.TrainConfig(**tc),
                             log_every=10**9, use_tensorboard=False)
    jtr.tx = _grad_recorder()
    jtr.ensure_initialized()
    for _ in range(refreshes):
        jtr._update_occupancy()
    tm = tcc.CCNeRF(tcc.CCNeRFConfig(**_CFG), bound=1.0, device="cpu")
    tm.load_params(tcc.params_from_jax(jax.tree.map(np.asarray, jtr.state.params)))
    ttr = tcct.CCNeRFTrainer(tm, tconfig.RenderConfig(**rc), tconfig.TrainConfig(**tc),
                             log_every=10**9)
    occ = jtr.aux["occ"]
    ttr.aux = {"occ": to.occupancy_from_jax(
        {f.name: np.asarray(getattr(occ, f.name)) for f in dataclasses.fields(occ)},
        device="cpu")}
    return jtr, ttr


@pytest.fixture(scope="module")
def turbo_pair(tmp_path_factory):
    """One turbo trainer pair for the tests that only render (the frame
    test, which finalizes the port's model, comes last)."""
    return _trainer_pair(tmp_path_factory.mktemp("ccnerf"))


def test_bitfield_bits_equal(turbo_pair):
    jtr, ttr = turbo_pair
    want = np.asarray(jo.bitfield(jtr.aux["occ"]))
    got = to.bitfield(ttr.aux["occ"]).numpy()
    assert got.dtype == np.uint8 and 0 < got.astype(bool).mean() < 1
    np.testing.assert_array_equal(got, want)


def test_multi_head_render_matches_jax(turbo_pair):
    """``render_rays_grid_turbo_multi`` with the residual heads, a
    perturbed march and a per-ray background: every head's image,
    weights_sum and depth, and the single-head counters."""
    jtr, ttr = turbo_pair
    rng = np.random.default_rng(5)
    n = 200
    o = np.tile(np.array([[0.1, -0.2, -2.2]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.25 + [0, 0, 1]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    bg = rng.uniform(size=(n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    params = jtr.state.params
    jm = jtr.model

    def jfn(p, dd):
        return jm.sigma_rgb(params, p, dd, residual=True)

    want = jax.jit(lambda occ, o, d, bg: jo.render_rays_grid_turbo_multi(
        jfn, o, d, occ, jtr.render_cfg, rng=key, perturb=True, bg_color=bg))(
        jtr.aux["occ"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(bg))
    noise = _np(jax.random.uniform(key, (n,)))
    got = to.render_rays_grid_turbo_multi(
        lambda p, dd: ttr.model.sigma_rgb(p, dd, residual=True), torch.from_numpy(o),
        torch.from_numpy(d), ttr.aux["occ"], ttr.render_cfg, bg_color=torch.from_numpy(bg),
        perturb=True, noise=noise)
    assert got["image"].shape == (3, n, 3)
    for k in ("image", "weights_sum", "depth"):
        _close(got[k].detach(), want[k])
    assert int(got["n_samples"]) == int(want["n_samples"]) > 0
    assert int(got["n_dropped"]) == int(want["n_dropped"])


@pytest.mark.parametrize("turbo", [True, False])
def test_residual_step_matches_jax(tmp_path, turbo):
    """One f32 residual step with JAX's draws on the turbo march (one march
    for the K heads) and on the v1 march (per-K composite): the loss
    (averaged over K) and every gradient."""
    jtr, ttr = _trainer_pair(tmp_path, turbo=turbo)
    H = W = 24
    frames = tsyn.make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=H, W=W,
                                        device="cpu")["train"]
    batch = {"images": jnp.asarray(frames.images), "poses": jnp.asarray(frames.poses),
             "intrinsics": jnp.asarray(frames.intrinsics), "idx": jnp.int32(1)}
    rng = jax.random.PRNGKey(7)
    jstate, _, jmet = jax.jit(jtr.train_step)(jtr.state, jtr.aux, batch, rng)
    n = 256
    k_pix, k_bg, k_render = jax.random.split(rng, 3)
    draws = {"bg": _np(jax.random.uniform(k_bg, (n, 3))),
             "noise": _np(jax.random.uniform(k_render, (n,))),
             "inds": _np(jax.random.randint(k_pix, (n,), 0, H * W))}
    tbatch = {"images": torch.from_numpy(frames.images), "poses": torch.from_numpy(frames.poses),
              "intrinsics": torch.from_numpy(frames.intrinsics), "idx": 1}
    tmet = ttr.train_step(tbatch, draws)
    loss = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - loss) <= 1e-5 * loss and loss > 0
    jg = _tree_np(jstate.opt_state["g"])
    tg = {k: [{"U": [u.grad for u in g["U"]], "S": g["S"].grad} for g in v]
          for k, v in ttr.model.params().items()}
    for kind in jg:
        for g, w in zip(tg[kind], jg[kind]):
            for a, b in zip(g["U"] + [g["S"]], w["U"] + [w["S"]]):
                assert a is not None and float(a.abs().max()) > 0, kind
                _scaled(a, b, 1e-4)


def test_frame_and_finalized_frame(turbo_pair):
    """``render_frame`` of a CCNeRF trainer (the density and colour
    closures) matches JAX's frame; after ``finalize`` the frame moves by
    at most one u8 level."""
    jtr, ttr = turbo_pair
    pose = tsyn.make_synthetic_frames(n_train=1, n_val=0, n_test=0, H=8, W=8,
                                      device="cpu")["train"].poses[0]
    H = W = 24
    intr = np.array([30.0, 30.0, 12.0, 12.0], np.float32)
    want, _ = jtr.render_frame(pose, intr, H, W)
    got, _ = ttr.render_frame(pose, intr, H, W)
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert err.mean() <= 1e-4 and (err <= 1e-3).mean() >= 0.995
    tm = ttr.model
    tm.load_params(tm.finalize(tm.params()))
    ttr.ema = None
    fin, _ = ttr.render_frame(pose, intr, H, W)
    assert np.abs(fin - got).max() <= 1.0 / 255 + 1e-6


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_parser_pinned_to_main_ccnerf(monkeypatch):
    want = parser_actions(jax_main_parser(monkeypatch, "main_CCNeRF.py"))
    got = parser_actions(tmain.build_parser())
    assert [a[2] for a in got] == [a[2] for a in want]
    for g, w in zip(got, want):
        assert g == w, g[2]


def test_main_runs_on_the_cpu_and_refuses_the_viewer(tmp_path, monkeypatch):
    """``-O --compose`` on a small scene (the model cut to ``_CFG``, the
    grid to 16^3): training, the finalized full rank and the three
    compression levels evaluated, the composed scene's frames written;
    then ``--test`` from the checkpoint gives the same full-rank PSNR.
    ``--gui`` resumes the checkpoint and reaches ``serve`` (replaced)
    with an ``InteractiveSession``."""
    from ngp_tpu_torch.training.nerf import NeRFTrainer

    root = tsyn.make_synthetic_dataset(str(tmp_path / "scene"), n_train=3, n_val=1, n_test=1,
                                       H=24, W=24, num_steps=64, device="cpu")
    monkeypatch.setattr(tmain, "CCNeRFConfig", functools.partial(tcc.CCNeRFConfig, **_CFG))
    monkeypatch.setattr(tmain, "RenderConfig",
                        functools.partial(tconfig.RenderConfig, grid_size=16))
    results = []
    evaluate = NeRFTrainer.evaluate
    monkeypatch.setattr(NeRFTrainer, "evaluate",
                        lambda self, *a, **k: results.append(evaluate(self, *a, **k))
                        or results[-1])
    ws = tmp_path / "ws"
    argv = [root, "-O", "--workspace", str(ws), "--iters", "6", "--num_rays", "256",
            "--compose"]
    tr = tmain.main(argv, device="cpu")
    assert tr.global_step == 6 and tr.model.finalized and tr.model.cfg.K == 1
    assert np.isfinite(tr.stats["loss"]).all()
    # the full rank and three levels (2 epochs: no validation)
    assert len(results) == 4 and all(np.isfinite(r["psnr"]) for r in results)
    assert list((ws / "results").glob("ccnerf_*_rgb.png"))
    back = tmain.main(argv[:-1] + ["--test"], device="cpu")
    assert back.global_step == 6 and results[4]["psnr"] == pytest.approx(results[0]["psnr"],
                                                                         abs=1e-6)
    from ngp_tpu_torch import viewer_web
    from ngp_tpu_torch.viewer import InteractiveSession

    served = []
    monkeypatch.setattr(viewer_web, "serve", lambda session, **kw: served.append(session))
    gui = tmain.main(argv + ["--gui"], device="cpu")
    assert len(served) == 1 and isinstance(served[0], InteractiveSession)
    assert served[0].trainer is gui and gui.global_step == tr.global_step
