"""The factors' cell-major layout (``ops/kernels/scatter.py:cell_major``:
memory [D, R] or [H, W, R], seen in JAX's shape [R, D] / [R, H, W]), the
layout the taps kernels read, in the TensoRF and CCNeRF models, against
the JAX package on the CPU.

Every factor that goes through ``ops/interp.py:FactorTaps`` (TensoRF VM's
planes and lines and ``bg_mat``, CP's lines, CCNeRF's U) holds cell-major
memory after init, ``params_from_jax``, upsample, shrink, CCNeRF's
``finalize`` / ``compress`` / ``compose`` and a checkpoint round trip
(with the optimizer's moments and the EMA shadow), with JAX's values;
autograd gives each factor a gradient of the factor's strides;
``FactorTaps`` on cell-major factors matches ``jax.vjp`` of
``sample_1d`` / ``sample_2d`` and equals the row-major factor's result
bit for bit; one TensoRF VM step and one CCNeRF step match JAX's.

Tolerances, as the files they follow: the taps' values 1e-5 and their
gradients 1e-4 of the largest entry (``test_torch_scatter_taps.py``: the
same f32 products summed in another order), the support of a gradient on
cell edges exactly; the steps' loss 1e-5 relative and every gradient
1e-4 of its largest entry (``test_torch_tensorf.py``,
``test_torch_ccnerf.py``); transforms and restores exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.models import ccnerf as jcc
from ngp_tpu.models import tensorf as jt
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch.data import synthetic as tsyn
from ngp_tpu_torch.models import ccnerf as tcc
from ngp_tpu_torch.models import tensorf as tt
from ngp_tpu_torch.ops import interp as ti
from ngp_tpu_torch.ops.kernels import scatter as ks
from ngp_tpu_torch.training import ccnerf as tcct
from ngp_tpu_torch.training import tensorf as ttt
from test_torch_ccnerf import _CFG, _rays, _tree_np
from test_torch_ccnerf import _pair as _cc_pair
from test_torch_ccnerf import _trainer_pair as _cc_trainer_pair
from test_torch_renderer import one_torch_thread  # noqa: F401
from test_torch_scatter_taps import CASES, _edge_points, _factor, _jax_vjp
from test_torch_scatter_taps import _points as _tap_points
from test_torch_tensorf import _NET, _RC, AABB, _cp_pair, _np_params, _points, _vm_pair
from test_torch_tensorf import _trainer_pair as _tf_trainer_pair
from test_torch_train_step import _np, _scaled


def _factors(model):
    """The model's parameters that go through ``FactorTaps``, by name."""
    if isinstance(model, tcc.CCNeRF):
        return {k: p for k, p in model.named_parameters() if "_U" in k}
    return {k: p for k, p in model.named_parameters() if k.startswith(tt.FACTOR_PREFIXES)}


def _assert_cell_major(model):
    factors = _factors(model)
    assert factors
    for name, p in factors.items():
        assert ks.is_cell_major(p), (name, tuple(p.shape), p.stride())
        # the rank is the fastest dimension: not the row-major layout
        assert p.shape[0] == 1 or p.stride(0) == 1, (name, p.stride())
    for name, p in model.named_parameters():
        if name not in factors:
            assert p.is_contiguous(), name


def _models():
    return {
        "vm": lambda: tt.TensoRFNetwork(**_NET, device="cpu"),
        "vm_bg": lambda: tt.TensoRFNetwork(**_NET, bg_radius=2.0, bg_resolution=(8, 6),
                                           bg_rank=3, device="cpu"),
        "cp": lambda: tt.TensoRFCPNetwork(resolution=(16, 18, 13), sigma_rank=6, color_rank=10,
                                          hidden_dim=32, device="cpu"),
        "ccnerf": lambda: tcc.CCNeRF(tcc.CCNeRFConfig(**_CFG), bound=1.0, device="cpu"),
    }


@pytest.mark.parametrize("kind", ["vm", "vm_bg", "cp", "ccnerf"])
def test_factors_are_cell_major_after_init(kind):
    _assert_cell_major(_models()[kind]())


def test_cell_major_keeps_the_values_and_copies_once():
    f = torch.from_numpy(_factor(5, (7, 3), 0))
    cm = ks.cell_major(f)
    assert torch.equal(cm, f) and cm.shape == f.shape and cm.stride() == (1, 15, 5)
    assert ks.cell_major(cm) is cm and not ks.is_cell_major(f)
    line = ks.cell_major(torch.from_numpy(_factor(4, (9,), 1)))
    assert line.stride() == (1, 4) and ks.is_cell_major(line)
    # a rank of 1 is both layouts
    assert ks.is_cell_major(torch.zeros((1, 4, 6))) and ks.is_cell_major(torch.zeros((1, 5)))
    assert ks.cell_major(torch.zeros((3, 4))).requires_grad_().is_leaf


@pytest.mark.parametrize("kind", ["vm", "cp"])
def test_params_from_jax_is_cell_major_with_jax_values(kind):
    """``params_from_jax`` gives the factors cell-major; loaded into the
    model (``load_state_dict``) or installed by ``set_parameters``, the
    model holds them so, with JAX's values."""
    jm, params, tm = _vm_pair(bg_radius=2.0) if kind == "vm" else _cp_pair()
    sd = tt.params_from_jax(jax.tree.map(np.asarray, params))
    for name in _factors(tm):
        assert ks.is_cell_major(sd[name]), name
    _assert_cell_major(tm)
    fresh = type(tm)(**({} if kind == "cp" else {"bg_radius": 2.0}), device="cpu")
    tt.set_parameters(fresh, sd)
    _assert_cell_major(fresh)
    want = _np_params(params)
    for model in (tm, fresh):
        for name, p in model.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(), err_msg=name)


@pytest.mark.parametrize("kind", ["vm", "cp"])
def test_upsample_and_shrink_keep_cell_major(kind):
    """The parameter transforms on cell-major factors give JAX's values;
    ``set_parameters`` installs them cell-major (the trainer's
    ``_replace_params``)."""
    jm, params, tm = _vm_pair() if kind == "vm" else _cp_pair()
    new = (31, 20, 25)
    jfn, tfn = ((jt.upsample_vm_params, tt.upsample_vm_params) if kind == "vm"
                else (jt.upsample_cp_params, tt.upsample_cp_params))
    jp = jfn(params, new)
    tt.set_parameters(tm, tfn({k: p.detach() for k, p in tm.named_parameters()}, new))
    _assert_cell_major(tm)
    want = _np_params(jp)
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(), err_msg=name)
    if kind == "cp":
        return
    G = 16
    dens = np.zeros((2, G, G, G), np.float32)
    dens[-1, 3:9, 5:12, 2:14] = 20.0
    args = (AABB, dens, 5.0, 10.0, 1.0, G)
    jp, jaabb = jt.shrink_vm_params(jp, *args)
    tp, taabb = tt.shrink_vm_params({k: p.detach() for k, p in tm.named_parameters()}, *args)
    np.testing.assert_array_equal(taabb, jaabb)
    tt.set_parameters(tm, tp)
    _assert_cell_major(tm)
    assert tt._vm_resolution(tp) != new
    want = _np_params(jp)
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(), err_msg=name)


def test_ccnerf_finalize_compress_compose_keep_cell_major():
    """``load_params`` of JAX's tree, of the finalized tree and of a
    compressed one installs U cell-major with JAX's values; a composed
    scene holds its objects' U cell-major and renders JAX's field."""
    jm, params, tm = _cc_pair()
    _assert_cell_major(tm)
    jf = jm.finalize(jax.tree.map(np.asarray, params))
    tf = tm.finalize(tm.params())
    tm.load_params(tf)
    _assert_cell_major(tm)
    want, got = _tree_np(jf), _tree_np(tm.params())
    for kind in want:
        for g, w in zip(got[kind], want[kind]):
            for a, b in zip(g["U"] + [g["S"]], w["U"] + [w["S"]]):
                np.testing.assert_array_equal(a, b)
    small = tcc.CCNeRF(tcc.CCNeRFConfig(**_CFG), bound=1.0, device="cpu")
    small.finalized, small.cfg = True, tm.cfg
    small.load_params(small.compress(tf, (4, 2, 3, 1)))
    _assert_cell_major(small)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.3, -0.1, 0.2]
    c, s = np.cos(0.4), np.sin(0.4)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    jscene = jcc.CCNeRF(jm.cfg, bound=1.0).compose([(jm, jf), (jm, jf)], [None, (T, Rz)])
    tscene = tcc.CCNeRF(tm.cfg, bound=1.0, device="cpu").compose([(tm, tf), (tm, tf)],
                                                                 [None, (T, Rz)])
    for obj in tscene.objects:
        for kind, groups in obj[0].items():
            for g in groups:
                assert all(ks.is_cell_major(u) for u in g["U"]), kind
    x, d = _rays()
    js, jr = jscene.sigma_rgb(None, jnp.asarray(x), jnp.asarray(d))
    ts, tr = tscene.sigma_rgb(torch.from_numpy(x), torch.from_numpy(d))
    for a, b in ((ts, js), (tr, jr)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))


def _tensorf_trainer(tmp_path):
    net = tt.TensoRFNetwork(**_NET, bg_radius=2.0, bg_resolution=(8, 6), bg_rank=3, device="cpu")
    tc = tconfig.TrainConfig(iters=8, lr=2e-2, num_rays=64, workspace=str(tmp_path))
    return ttt.TensoRFTrainer(net, tconfig.RenderConfig(**_RC, bg_radius=2.0), tc,
                              upsample_model_steps=[4], resolution0=16, resolution1=20,
                              log_every=10**9)


def _ccnerf_trainer(tmp_path):
    model = tcc.CCNeRF(tcc.CCNeRFConfig(**_CFG), bound=1.0, device="cpu")
    tc = tconfig.TrainConfig(iters=8, lr=2e-2, num_rays=64, workspace=str(tmp_path))
    return tcct.CCNeRFTrainer(model, tconfig.RenderConfig(**_RC), tc, log_every=10**9)


@pytest.mark.parametrize("moments", ["cell-major", "row-major"])
@pytest.mark.parametrize("kind", ["tensorf", "ccnerf"])
def test_checkpoint_round_trip_keeps_cell_major(tmp_path, kind, moments):
    """A trainer that took two Adam steps (TensoRF: after an upsample to
    20^3, so the restore resizes the fresh model first) saves; a fresh
    trainer loads: the factors, their EMA shadows and their Adam moments
    are cell-major and equal to the saved ones, also where the file holds
    the moments row-major (as a checkpoint of row-major factors does)."""
    make = _tensorf_trainer if kind == "tensorf" else _ccnerf_trainer
    t1 = make(tmp_path)
    t1.ensure_initialized()
    if kind == "tensorf":
        t1._upsample((20, 20, 20))
    rng = np.random.default_rng(0)
    for _ in range(2):
        for p in t1.model.parameters():
            p.grad = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
        t1._apply_gradients()
    if moments == "row-major":
        for state in t1.optimizer.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                state[k] = state[k].contiguous()
    t1.save_checkpoint()
    t2 = make(tmp_path)
    assert t2.load_checkpoint() and t2.last_restore_skipped == []
    _assert_cell_major(t2.model)
    live1, live2 = dict(t1.model.named_parameters()), dict(t2.model.named_parameters())
    for name, p in _factors(t2.model).items():
        assert torch.equal(p, live1[name]), name
        shadow = t2.ema.shadow[name]
        assert shadow.stride() == p.stride() and torch.equal(shadow, t1.ema.shadow[name]), name
        state, saved = t2.optimizer.state[p], t1.optimizer.state[live1[name]]
        for k in ("exp_avg", "exp_avg_sq"):
            assert state[k].stride() == p.stride(), (name, k)
            assert torch.equal(state[k], saved[k]), (name, k)
    assert set(live1) == set(live2)


@pytest.mark.parametrize("kind", ["vm", "vm_bg", "cp", "ccnerf"])
def test_factor_grads_take_the_factors_strides(kind):
    """A backward through the model gives each factor a gradient of the
    factor's own strides (``FactorTaps.backward`` makes it so, and
    autograd keeps it)."""
    model = _models()[kind]()
    x, d = _points(300)
    x, d = torch.from_numpy(x), torch.from_numpy(d)
    if kind == "ccnerf":
        sigma, rgb = model.sigma_rgb(x, d, residual=True)
    else:
        aabb = torch.from_numpy(AABB)
        sigma, geo = model.density(x, aabb)
        rgb = model.color(d, geo, aabb)
        if kind == "vm_bg":
            sph = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (300, 2))
                                   .astype(np.float32))
            rgb = rgb + model.background(sph, d)
    (sigma.sum() + rgb.square().sum()).backward()
    for name, p in _factors(model).items():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        assert p.grad.stride() == p.stride(), (name, p.grad.stride(), p.stride())
    if kind != "ccnerf":
        # the L1 term's own gradient too: one in another layout costs autograd
        # a copy into the factor's
        sigma_factors = [p for k, p in _factors(model).items() if k.startswith("sigma_")]
        for p, g in zip(sigma_factors, torch.autograd.grad(model.density_loss(), sigma_factors)):
            assert g.stride() == p.stride()


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("R,grid,N,padded", CASES)
def test_factor_taps_on_cell_major_factors_match_jax(R, grid, N, padded, align_corners):
    """``FactorTaps`` on a cell-major factor: the values of ``sample_1d`` /
    ``sample_2d`` and both gradients of ``jax.vjp``; the values bit for
    bit and the gradients exactly those of the same factor row-major."""
    factor = _factor(R, grid, 5)
    coords = _tap_points(N, len(grid), 6, padded)
    cot = np.random.default_rng(7).normal(size=(R, N)).astype(np.float32)
    want, d_factor, d_coords = _jax_vjp(factor, coords, cot, align_corners)
    runs = []
    for layout in (ks.cell_major, torch.Tensor.contiguous):
        f = layout(torch.from_numpy(factor)).requires_grad_()
        c = torch.from_numpy(coords).requires_grad_()
        got = ti.FactorTaps.apply(f, c, align_corners)
        got.backward(torch.from_numpy(cot))
        assert f.grad.stride() == f.stride()
        runs.append((got.detach(), f.grad, c.grad))
    (got, fg, cg), (got_rm, fg_rm, cg_rm) = runs
    assert ks.is_cell_major(fg) and (R == 1 or not ks.is_cell_major(fg_rm))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    _scaled(fg, d_factor, 1e-4)
    _scaled(cg, d_coords, 1e-4)
    assert torch.equal(got, got_rm) and torch.equal(fg, fg_rm) and torch.equal(cg, cg_rm)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("grid", [(152,), (9, 16), (128, 128)])
def test_factor_taps_on_cell_edges_match_jax(grid, align_corners):
    """On cell edges and 1-2 ulps off them, a cell-major factor's values
    equal JAX's and its gradient has JAX's support."""
    coords = _edge_points(grid[-1], len(grid), align_corners)
    R, N = 5, coords.shape[0]
    factor = _factor(R, grid, 11)
    cot = np.random.default_rng(12).normal(size=(R, N)).astype(np.float32)
    want, d_factor, _ = _jax_vjp(factor, coords, cot, align_corners)
    f = ks.cell_major(torch.from_numpy(factor)).requires_grad_()
    got = ti.FactorTaps.apply(f, torch.from_numpy(coords), align_corners)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(f.grad.numpy() != 0, d_factor != 0)
    _scaled(f.grad, d_factor, 1e-4)


def _step_inputs():
    H = W = 24
    frames = tsyn.make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=H, W=W,
                                        device="cpu")["train"]
    batch = {"images": jnp.asarray(frames.images), "poses": jnp.asarray(frames.poses),
             "intrinsics": jnp.asarray(frames.intrinsics), "idx": jnp.int32(1)}
    rng = jax.random.PRNGKey(7)
    n = 256
    k_pix, k_bg, k_render = jax.random.split(rng, 3)
    draws = {"bg": _np(jax.random.uniform(k_bg, (n, 3))),
             "noise": _np(jax.random.uniform(k_render, (n,))),
             "inds": _np(jax.random.randint(k_pix, (n,), 0, H * W))}
    tbatch = {"images": torch.from_numpy(frames.images), "poses": torch.from_numpy(frames.poses),
              "intrinsics": torch.from_numpy(frames.intrinsics), "idx": 1}
    return batch, rng, tbatch, draws


def test_tensorf_step_on_cell_major_factors_matches_jax(tmp_path):
    """One f32 TensoRF VM step (turbo march, L1 term) on cell-major
    factors with JAX's draws: the loss and every gradient, each factor's
    gradient in the factor's strides."""
    jtr, ttr = _tf_trainer_pair(tmp_path)
    _assert_cell_major(ttr.model)
    batch, rng, tbatch, draws = _step_inputs()
    jstate, _, jmet = jax.jit(jtr.train_step)(jtr.state, jtr.aux, batch, rng)
    tmet = ttr.train_step(tbatch, draws)
    loss = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - loss) <= 1e-5 * loss and loss > 0
    jgrads = _np_params(jstate.opt_state["g"])
    factors = _factors(ttr.model)
    for name, p in ttr.model.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        if name in factors:
            assert p.grad.stride() == p.stride(), name
        _scaled(p.grad, jgrads[name], 1e-4)


def test_ccnerf_step_on_cell_major_factors_matches_jax(tmp_path):
    """One f32 CCNeRF residual step (turbo march) on cell-major U with
    JAX's draws: the loss and every gradient, each U's gradient in its
    strides."""
    jtr, ttr = _cc_trainer_pair(tmp_path)
    _assert_cell_major(ttr.model)
    batch, rng, tbatch, draws = _step_inputs()
    jstate, _, jmet = jax.jit(jtr.train_step)(jtr.state, jtr.aux, batch, rng)
    tmet = ttr.train_step(tbatch, draws)
    loss = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - loss) <= 1e-5 * loss and loss > 0
    jg = _tree_np(jstate.opt_state["g"])
    for kind, groups in ttr.model.params().items():
        for g, w in zip(groups, jg[kind]):
            for a, b in zip(g["U"] + [g["S"]], w["U"] + [w["S"]]):
                assert a.grad is not None and float(a.grad.abs().max()) > 0, kind
                assert a.grad.stride() == a.stride(), kind
                _scaled(a.grad, b, 1e-4)
