"""The port's TensoRF slice against the JAX package on the same inputs:
``ops/interp.py`` (both corner conventions, points outside the grid, and
the VJPs against ``jax.vjp``), the VM and CP ``density`` and ``color``,
the VM ``background``, ``density_loss``, the parameter transforms
(upsample, shrink on a given density grid, the upsample schedule), the
two-group optimizer against ``optax.multi_transform``, one
``TensoRFTrainer`` step on the turbo march with JAX's draws, a frame
through ``render_frame`` (no fused radiance closure), the resolution
round trip of a checkpoint, the command line's parser and a small
``main_tensoRF.main`` run on the CPU.

Tolerances. f32 values to 1e-5, gradients to 1e-4 of their largest
entry; the transforms and the upsample schedule equal. The optimizer:
1e-6 relative on identical gradients. The train step: the loss to 1e-5
relative, every gradient to 1e-4 of its largest entry. The frame: f32
pixels to 1e-4 on average, at least 99.5% within 1e-3 (as
``test_torch_background.py``'s frames).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu import config as jconfig
from ngp_tpu.models import tensorf as jt
from ngp_tpu.ops import interp as ji
from ngp_tpu.training import tensorf as jtt
from ngp_tpu.training.state import apply_gradients, create_train_state
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch import main_tensoRF as tmain
from ngp_tpu_torch.data import synthetic as tsyn
from ngp_tpu_torch.models import occupancy as to
from ngp_tpu_torch.models import tensorf as tt
from ngp_tpu_torch.ops import interp as ti
from ngp_tpu_torch.training import tensorf as ttt
from test_torch_renderer import one_torch_thread  # noqa: F401
from test_torch_sdf import jax_main_parser, parser_actions
from test_torch_train_step import _grad_recorder, _np, _scaled

AABB = np.array([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], np.float32)


def _vjp_check(jfn, tfn, args, seed=0):
    """Values to 1e-5 and the VJP of a random cotangent, per argument, to
    1e-4 of its largest entry."""
    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    got = tfn(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    cot = np.random.default_rng(seed).normal(size=want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    (got * torch.from_numpy(cot)).sum().backward()
    for t, g in zip(targs, jgrads):
        _scaled(t.grad, g, 1e-4)


# ---------------------------------------------------------------------------
# ops/interp.py
# ---------------------------------------------------------------------------


def _coords(n, dims, seed):
    """Points in [-1.3, 1.3] (some outside the grid) and the corners."""
    u = np.random.default_rng(seed).uniform(-1.3, 1.3, size=(n, dims)).astype(np.float32)
    u[:4] = np.array([[-1.0], [1.0], [0.0], [-0.999]], np.float32)
    return u[:, 0] if dims == 1 else u


@pytest.mark.parametrize("align_corners", [True, False])
def test_sample_1d_and_vjp(align_corners):
    line = np.random.default_rng(1).normal(size=(5, 9)).astype(np.float32)
    _vjp_check(lambda a, u: ji.sample_1d(a, u, align_corners),
               lambda a, u: ti.sample_1d(a, u, align_corners), [line, _coords(300, 1, 2)])


@pytest.mark.parametrize("align_corners", [True, False])
def test_sample_2d_and_vjp(align_corners):
    plane = np.random.default_rng(3).normal(size=(4, 7, 11)).astype(np.float32)
    _vjp_check(lambda a, uv: ji.sample_2d(a, uv, align_corners),
               lambda a, uv: ti.sample_2d(a, uv, align_corners), [plane, _coords(300, 2, 4)])


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("shape,new", [((3, 5, 7), (9, 13)), ((2, 16, 16), (31, 24)),
                                       ((2, 12, 9), (4, 5)), ((6, 128, 1), (152, 1)),
                                       ((2, 152, 1), (180, 1))])
def test_resize_bilinear_and_vjp(align_corners, shape, new):
    img = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    want = np.asarray(ji.resize_bilinear(jnp.asarray(img), new, align_corners))
    got = ti.resize_bilinear(torch.from_numpy(img), new, align_corners).numpy()
    np.testing.assert_array_equal(got, want)
    _vjp_check(lambda a: ji.resize_bilinear(a, new, align_corners),
               lambda a: ti.resize_bilinear(a, new, align_corners), [img])


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------


def _vm_pair(res=16, bg_radius=-1.0):
    kw = dict(resolution=(res, res + 2, res - 3), sigma_rank=(4, 3, 2), color_rank=(8, 6, 5),
              hidden_dim=32, bg_radius=bg_radius, bg_resolution=(24, 20), bg_rank=3)
    jm = jt.TensoRFNetwork(**kw)
    x = jnp.zeros((8, 3))
    d = jnp.concatenate([jnp.ones((8, 1)), jnp.zeros((8, 2))], -1)
    params = jm.init(jax.random.PRNGKey(0), x, d, jnp.asarray(AABB),
                     method=jt.TensoRFNetwork.full_init)
    tm = tt.TensoRFNetwork(**kw, device="cpu")
    sd = tt.params_from_jax(jax.tree.map(np.asarray, params))
    assert set(sd) == {k for k, _ in tm.named_parameters()}
    tm.load_state_dict(sd)
    return jm, params, tm


def _cp_pair(res=16):
    kw = dict(resolution=(res, res + 2, res - 3), sigma_rank=6, color_rank=10, hidden_dim=32)
    jm = jt.TensoRFCPNetwork(**kw)
    x = jnp.zeros((8, 3))
    d = jnp.concatenate([jnp.ones((8, 1)), jnp.zeros((8, 2))], -1)
    params = jm.init(jax.random.PRNGKey(0), x, d, jnp.asarray(AABB),
                     method=jt.TensoRFCPNetwork.full_init)
    tm = tt.TensoRFCPNetwork(**kw, device="cpu")
    sd = tt.params_from_jax(jax.tree.map(np.asarray, params))
    assert set(sd) == {k for k, _ in tm.named_parameters()}
    tm.load_state_dict(sd)
    return jm, params, tm


def _points(n=400, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.7, 0.8, size=(n, 3)).astype(np.float32)  # inside and outside the box
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _param_grads_check(jm, params, tm, jfn, tfn, seed=8):
    """Values to 1e-5 and every parameter's gradient of <out, cot> to 1e-4
    of its largest entry."""
    want = np.asarray(jfn(params))
    tm.zero_grad(set_to_none=True)
    got = tfn()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    cot = np.random.default_rng(seed).normal(size=want.shape).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jfn(p) * cot))(params)
    (got * torch.from_numpy(cot)).sum().backward()
    jg = tt.params_from_jax(jax.tree.map(np.asarray, jg))
    n = 0
    for name, p in tm.named_parameters():
        if p.grad is not None and float(jg[name].abs().max()) > 0:
            _scaled(p.grad, jg[name], 1e-4)
            n += 1
    assert n > 0


@pytest.mark.parametrize("kind", ["vm", "cp"])
@pytest.mark.parametrize("what", ["density", "color"])
def test_density_and_color_match_jax(kind, what):
    jm, params, tm = _vm_pair() if kind == "vm" else _cp_pair()
    cls = type(jm)
    x, d = _points()
    aabb = np.array([-0.6, -0.5, -0.6, 0.6, 0.7, 0.5], np.float32)
    ja, ta = jnp.asarray(aabb), torch.from_numpy(aabb)
    if what == "density":
        jfn = functools.partial(lambda p: jm.apply(p, jnp.asarray(x), ja, method=cls.density)[0])
        tfn = functools.partial(lambda: tm.density(torch.from_numpy(x), ta)[0])
    else:
        jfn = functools.partial(lambda p: jm.apply(p, jnp.asarray(d), jnp.asarray(x), ja,
                                                   method=cls.color))
        tfn = functools.partial(lambda: tm.color(torch.from_numpy(d), torch.from_numpy(x), ta))
    _param_grads_check(jm, params, tm, jfn, tfn)


def test_background_and_density_loss_match_jax():
    jm, params, tm = _vm_pair(bg_radius=4.0)
    _, d = _points()
    sph = np.random.default_rng(9).uniform(-1.1, 1.1, size=(len(d), 2)).astype(np.float32)
    _param_grads_check(
        jm, params, tm,
        lambda p: jm.apply(p, jnp.asarray(sph), jnp.asarray(d), method=jt.TensoRFNetwork.background),
        lambda: tm.background(torch.from_numpy(sph), torch.from_numpy(d)))
    for (j, p), t in ((_vm_pair()[:2], _vm_pair()[2]), (_cp_pair()[:2], _cp_pair()[2])):
        _param_grads_check(j, p, t, lambda q: j.apply(q, method=type(j).density_loss)[None],
                           lambda: t.density_loss()[None])


# ---------------------------------------------------------------------------
# the parameter transforms and the schedule
# ---------------------------------------------------------------------------


def _np_params(params):
    return tt.params_from_jax(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("kind", ["vm", "cp"])
def test_upsample_params_equal(kind):
    jm, params, tm = _vm_pair() if kind == "vm" else _cp_pair()
    new = (31, 20, 25)
    jfn, tfn = ((jt.upsample_vm_params, tt.upsample_vm_params) if kind == "vm"
                else (jt.upsample_cp_params, tt.upsample_cp_params))
    want = _np_params(jfn(params, new))
    got = tfn({k: p.detach() for k, p in tm.named_parameters()}, new)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    if kind == "vm":
        assert tt._vm_resolution(got) == jt._vm_resolution(jfn(params, new)) == new


@pytest.mark.parametrize("occupied", ["box", "none"])
def test_shrink_vm_params_equal(occupied):
    jm, params, tm = _vm_pair(res=20)
    G, bound = 16, 1.0
    dens = np.zeros((2, G, G, G), np.float32)
    if occupied == "box":
        dens[-1, 3:9, 5:12, 2:14] = 20.0
        dens[-1, 10, 4, 7] = 50.0
    args = (AABB, dens, 5.0, 10.0, bound, G)
    jp, jaabb = jt.shrink_vm_params(params, *args)
    tp, taabb = tt.shrink_vm_params({k: p.detach() for k, p in tm.named_parameters()}, *args)
    np.testing.assert_array_equal(taabb, jaabb)
    want = _np_params(jp)
    for k in want:
        np.testing.assert_array_equal(tp[k].numpy(), want[k].numpy(), err_msg=k)
    if occupied == "box":
        assert tt._vm_resolution(tp) != (20, 22, 17)


@pytest.mark.parametrize("r0,r1,steps", [(128, 300, (2000, 3000, 4000, 5500, 7000)),
                                         (16, 24, (4,)), (32, 48, (60, 80, 100))])
def test_upsample_schedule_equal(r0, r1, steps):
    assert ttt.upsample_schedule(r0, r1, steps) == jtt.upsample_schedule(r0, r1, steps)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

_RC = dict(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=64, max_samples_per_ray=16,
           grid_size=16, density_thresh=10.0, turbo=True, coarse_candidates=48,
           crossing_slots=16, compact_mean_samples=8)
_NET = dict(resolution=(16, 16, 16), sigma_rank=(2, 3, 2), color_rank=(4, 4, 5), hidden_dim=32)


def _jax_tree(flat, template):
    """Port-named arrays -> the flax tree of ``template``."""
    p = {}
    for k, v in template["params"].items():
        if k in ("color_net", "bg_net"):
            p[k] = {layer: {"kernel": flat[f"{k}.{layer}"]} for layer in v}
        else:
            p[k] = {"kernel": flat[k]} if k == "basis_mat" else flat[k]
    return {"params": p}


def _trainer_pair(tmp_path, tc=None, **tkw):
    """JAX's ``TensoRFTrainer`` (gradients recorded, three refreshes) and
    the port's on its weights and occupancy grid."""
    tc = {**dict(iters=50, lr=2e-2, num_rays=256, workspace=str(tmp_path)), **(tc or {})}
    jrc = jconfig.RenderConfig(**_RC)
    jtr = jtt.TensoRFTrainer(jt.TensoRFNetwork(**_NET), jrc, jconfig.TrainConfig(**tc),
                             log_every=10**9, use_tensorboard=False, **tkw)
    jtr.tx = _grad_recorder()
    jtr.ensure_initialized()
    for _ in range(3):
        jtr._update_occupancy()
    net = tt.TensoRFNetwork(**_NET, device="cpu")
    net.load_state_dict(tt.params_from_jax(jax.tree.map(np.asarray, jtr.state.params)))
    ttr = ttt.TensoRFTrainer(net, tconfig.RenderConfig(**_RC), tconfig.TrainConfig(**tc),
                             log_every=10**9, **tkw)
    occ = jtr.aux["occ"]
    ttr.aux = {"occ": to.occupancy_from_jax(
        {f.name: np.asarray(getattr(occ, f.name)) for f in dataclasses.fields(occ)},
        device="cpu")}
    return jtr, ttr


def test_two_group_optimizer_matches_multi_transform(tmp_path):
    """Adam on the factors at lr0 and on the networks at lr1, each decaying
    (past its end at step 3), and the per-step EMA, fed the same
    gradients; the optimizer's groups split as JAX's labels do."""
    tc = tconfig.TrainConfig(iters=2, lr=2e-2, workspace=str(tmp_path))
    jm = jt.TensoRFNetwork(**_NET, bg_radius=2.0, bg_resolution=(8, 8), bg_rank=2)
    jtr = jtt.TensoRFTrainer(jm, jconfig.RenderConfig(**_RC, bg_radius=2.0),
                             jconfig.TrainConfig(**dataclasses.asdict(tc)), lr_net=3e-3,
                             log_every=10**9, use_tensorboard=False)
    jtr.ensure_initialized()
    st = create_train_state(jtr.state.params, jtr.tx, use_ema=True)
    net = tt.TensoRFNetwork(**_NET, bg_radius=2.0, bg_resolution=(8, 8), bg_rank=2,
                            device="cpu")
    net.load_state_dict(_np_params(st.params))
    ttr = ttt.TensoRFTrainer(net, tconfig.RenderConfig(**_RC, bg_radius=2.0), tc, lr_net=3e-3)
    ttr.ensure_initialized()
    groups = {g["name"]: {id(p) for p in g["params"]} for g in ttr.optimizer.param_groups}
    names = {id(p): k for k, p in net.named_parameters()}
    assert {names[i] for i in groups["nets"]} == {
        "basis_mat", "color_net.dense_0", "color_net.dense_1", "color_net.dense_2",
        "bg_net.dense_0", "bg_net.dense_1"}
    rng = np.random.default_rng(0)
    for s in range(3):
        grads = {k: (rng.normal(size=p.shape) * 10.0 ** -s).astype(np.float32)
                 for k, p in net.named_parameters()}
        jgrads = _jax_tree(grads, st.params)
        st = apply_gradients(st, jax.tree.map(jnp.asarray, jgrads), jtr.tx, ema_decay=0.95)
        for k, p in net.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        ttr._apply_gradients()
        want, shadow = _np_params(st.params), _np_params(st.ema_params)
        for k, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ttr.ema.shadow[k].numpy(), shadow[k].numpy(), rtol=1e-6,
                                       atol=1e-7)
    lrs = {g["name"]: g["lr"] for g in ttr.optimizer.param_groups}
    assert lrs["factors"] == pytest.approx(2e-3, rel=1e-6)
    assert lrs["nets"] == pytest.approx(3e-4, rel=1e-6)


def test_train_step_matches_jax(tmp_path):
    """One f32 step of the turbo march with the L1 term, JAX's draws: the
    loss, turbo_overflow and every gradient."""
    jtr, ttr = _trainer_pair(tmp_path)
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
    assert abs(float(tmet["turbo_overflow"]) - float(jmet["turbo_overflow"])) <= 1e-6
    jgrads = _np_params(jstate.opt_state["g"])
    for name, p in ttr.model.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        _scaled(p.grad, jgrads[name], 1e-4)


def test_frame_renders_without_a_fused_closure(tmp_path):
    """``render_frame`` of a TensoRF model goes through the density and
    colour closures (``_eval_fns`` gives no fused radiance closure, as
    JAX's ``_eval_vals_fn``), and its pixels match JAX's frame."""
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

    jtr, ttr = _trainer_pair(tmp_path)
    assert isinstance(ttr, GridNeRFTrainer) and ttr._eval_fns()[3] is None
    pose = tsyn.make_synthetic_frames(n_train=1, n_val=0, n_test=0, H=8, W=8,
                                      device="cpu")["train"]
    H = W = 24
    intr = np.array([30.0, 30.0, 12.0, 12.0], np.float32)
    want, _ = jtr.render_frame(pose.poses[0], intr, H, W)
    got, _ = ttr.render_frame(pose.poses[0], intr, H, W)
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    assert err.mean() <= 1e-4 and (err <= 1e-3).mean() >= 0.995


def test_checkpoint_resolution_round_trip(tmp_path):
    """``tests/test_tensorf.py:125`` in the port: a run that crosses the
    shrink and upsample stores its resolution and AABB; a fresh trainer at
    the base resolution resizes before it loads and renders the same
    frame."""
    frames = tsyn.make_synthetic_frames(n_train=3, n_val=0, n_test=0, H=40, W=40,
                                        device="cpu")["train"]
    rc = tconfig.RenderConfig(**dict(_RC, max_samples_per_ray=32))
    tc = tconfig.TrainConfig(iters=60, lr=2e-2, num_rays=256, workspace=str(tmp_path))

    def make():
        net = tt.TensoRFNetwork(resolution=(16, 16, 16), sigma_rank=(2, 2, 2),
                                color_rank=(4, 4, 4), hidden_dim=32, device="cpu")
        return ttt.TensoRFTrainer(net, rc, tc, upsample_model_steps=[4], resolution0=16,
                                  resolution1=24, log_every=10**9)

    t1 = make()
    t1.ckpt_min_interval_s = 0.0
    t1.train_on_dataset(frames, max_epochs=3)
    assert t1.current_resolution == (24, 24, 24) and t1._did_shrink
    r1 = t1.render_frame(frames.poses[0], frames.intrinsics, 16, 16)[0]
    t2 = make()
    assert t2.load_checkpoint()
    assert t2.current_resolution == (24, 24, 24) and t2.last_restore_skipped == []
    np.testing.assert_allclose(t2.aabb, t1.aabb, atol=1e-6)
    r2 = t2.render_frame(frames.poses[0], frames.intrinsics, 16, 16)[0]
    np.testing.assert_allclose(r2, r1, atol=1e-5)
    assert {g["name"] for g in t2.optimizer.param_groups} == {"factors", "nets"}
    assert t2.optimizer.param_groups[0]["lr"] == t1.optimizer.param_groups[0]["lr"]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_parser_pinned_to_main_tensorf(monkeypatch):
    want = parser_actions(jax_main_parser(monkeypatch, "main_tensoRF.py"))
    got = parser_actions(tmain.build_parser())
    assert [a[2] for a in got] == [a[2] for a in want]
    for g, w in zip(got, want):
        assert g == w, g[2]


def test_resolve_opts():
    opt = tmain.resolve_opts(tmain.build_parser().parse_args(
        ["scene", "-O", "--upsample_model_steps", "9000"]))
    assert opt.fp16 and opt.cuda_ray and opt.turbo and opt.max_steps == 256
    assert opt.upsample_model_steps == [2000, 3000, 4000, 5500, 7000, 9000]
    opt = tmain.resolve_opts(tmain.build_parser().parse_args(["scene", "--max_steps", "128"]))
    assert not (opt.fp16 or opt.cuda_ray or opt.turbo) and opt.max_steps == 128


def test_main_runs_and_tests_on_the_cpu(tmp_path, monkeypatch):
    """``-O`` on a small scene (the grid cut to 16^3, resolutions 16 -> 20),
    an upsample step appended at 3 (after the shrink), then ``--test``:
    the fresh trainer resizes to the stored resolution, and its evaluate
    reads the PSNR of the first run's."""
    from ngp_tpu_torch.training.nerf import NeRFTrainer

    root = tsyn.make_synthetic_dataset(str(tmp_path / "scene"), n_train=3, n_val=1, n_test=1,
                                       H=24, W=24, num_steps=64, device="cpu")
    monkeypatch.setattr(tmain, "RenderConfig",
                        functools.partial(tconfig.RenderConfig, grid_size=16))
    results = []
    evaluate = NeRFTrainer.evaluate
    monkeypatch.setattr(NeRFTrainer, "evaluate",
                        lambda self, *a, **k: results.append(evaluate(self, *a, **k))
                        or results[-1])
    argv = [root, "-O", "--workspace", str(tmp_path / "ws"), "--iters", "6", "--num_rays",
            "256", "--resolution0", "16", "--resolution1", "20", "--upsample_model_steps", "3"]
    tr = tmain.main(argv, device="cpu")
    assert tr.global_step == 6 and tr.current_resolution == (20, 20, 20) and tr._did_shrink
    assert np.isfinite(tr.stats["loss"]).all()
    assert (tmp_path / "ws" / "results").exists()
    back = tmain.main(argv + ["--test"], device="cpu")
    assert back.current_resolution == (20, 20, 20) and back.global_step == 6
    np.testing.assert_allclose(back.aabb, tr.aabb)
    assert len(results) == 2 and results[1]["psnr"] == pytest.approx(results[0]["psnr"],
                                                                     abs=1e-6)
