"""The port's D-NeRF slice against the JAX package on the same inputs:
the three networks (``DNeRFNetwork``, ``DNeRFHyperNetwork`` on its 4-D
grid, ``DNeRFBasisNetwork``) with JAX's weights (``params_from_jax``) and
their gradients, ``slice_at_time``, the eval prepass on the slice at a
frame's time, the refresh schedule's slice sets over
120 refreshes (the freeze included), a whole refresh (full and quarter)
with JAX's draws, one ``DNeRFTrainer`` step with the deformation L1 on
each path (turbo and the v1 march) with JAX's draws, 24 steps with three
refreshes on JAX's draws, a 24x24 frame at two times, and the command
line's parser and a small ``main_dnerf.main`` run on a dynamic scene on
the CPU.

Tolerances. f32 outputs to 1e-5 relative, their parameter gradients to
1e-4 of each one's largest entry; bf16 outputs to 2e-2 (a flipped bf16
rounding of a hidden unit). The deformation variant encodes x with ten
octaves: the two packages' sin(x) differ by an ulp in ~4% of values, and
the double-angle ladder doubles that per octave (2^9 ulps, ~3e-5, in the
top one), which reaches sigma through the sigma net's input (measured
4.1e-5 relative) and the deformation net's first layer through its input
and the grid encoder's x-gradient, whose finest level is 2048 cells
across (measured 5.1e-4 of its largest entry): so 1e-4 relative for that
variant's outputs and 1e-3 of the largest entry for ``deform_net``'s
gradients. The slices and the schedule: equal. The refresh and the 24
steps: stated in their tests. The train step: the
loss to 1e-5 relative, every gradient to 1e-4 of its largest entry. The
frames: f32 pixels to 1e-4 on average, at least 99.5% within 1e-3.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ngp_tpu import config as jconfig
from ngp_tpu.models import dnerf as jdn
from ngp_tpu.models import occupancy as jo
from ngp_tpu.training import dnerf as jdt
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch import main_dnerf as tmain
from ngp_tpu_torch.data import synthetic as tsyn
from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
from ngp_tpu_torch.models import dnerf as tdn
from ngp_tpu_torch.models import occupancy as to
from ngp_tpu_torch.training import dnerf as tdt
from test_torch_renderer import one_torch_thread  # noqa: F401
from test_torch_sdf import jax_main_parser, parser_actions
from test_torch_train_step import _grad_recorder, _np, _scaled

_NET = dict(num_levels=4, log2_hashmap_size=12, base_resolution=8, hidden_dim=32,
            hidden_dim_color=32)
_RC = dict(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=64, max_samples_per_ray=16,
           grid_size=16, density_thresh=10.0, coarse_candidates=48, crossing_slots=16,
           compact_mean_samples=8, time_size=4)
VARIANTS = {"deform": (jdn.DNeRFNetwork, tdn.DNeRFNetwork),
            "hyper": (jdn.DNeRFHyperNetwork, tdn.DNeRFHyperNetwork),
            "basis": (jdn.DNeRFBasisNetwork, tdn.DNeRFBasisNetwork)}


def _small_deform(params):
    """The deformation net's last layer scaled by 1e-3, so dx is small: the
    two packages' f32 products round dx apart by an ulp of dx, and at the
    finest level (2048 cells across) an ulp of a point's own size would
    move its interpolation weights past the tolerance."""
    p = jax.tree.map(np.asarray, params)
    net = p["params"].get("deform_net")
    if net is not None:
        last = f"dense_{len(net) - 1}"
        net[last] = {"kernel": net[last]["kernel"] * np.float32(1e-3)}
    return p


def _jax_init(jm, seed=0):
    x0 = jnp.zeros((8, 3))
    d0 = jnp.concatenate([jnp.ones((8, 1)), jnp.zeros((8, 2))], axis=-1)
    return _small_deform(jm.init(jax.random.PRNGKey(seed), x0, d0, 0.0,
                                 method=type(jm).full_init))


def _pair(variant, use_bf16=False, rc=None):
    jcls, tcls = VARIANTS[variant]
    rc = rc or _RC
    jm = jcls(cfg=jconfig.NetworkConfig(**_NET, use_bf16=use_bf16),
              render=jconfig.RenderConfig(**rc))
    params = _jax_init(jm)
    tm = tcls(tconfig.NetworkConfig(**_NET, use_bf16=use_bf16), tconfig.RenderConfig(**rc),
              device="cpu")
    tm.load_state_dict(tdn.params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _grad_tol(name):
    return 1e-3 if name.startswith("deform_net") else 1e-4


def _points(n=256, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_networks_match_jax(variant, use_bf16):
    """sigma, rgb and dx of ``forward`` at t = 0.37 and the geometry
    features of ``density``; in f32 also the gradient of a fixed weighting
    of the outputs in every parameter."""
    jm, params, tm = _pair(variant, use_bf16)
    x, d = _points()
    t = 0.37
    rng = np.random.default_rng(4)
    ws = rng.normal(size=(256,)).astype(np.float32)
    wr = rng.normal(size=(256, 3)).astype(np.float32)

    def jloss(p):
        s, r, dx = jm.apply(p, jnp.asarray(x), jnp.asarray(d), jnp.float32(t))
        return jnp.sum(jnp.log1p(s) * ws) + jnp.sum(r * wr) + jnp.sum(dx ** 2), (s, r, dx)

    (_, (js, jr, jdx)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    ts, tr, tdx = tm(torch.from_numpy(x), torch.from_numpy(d), t)
    tol = 2e-2 if use_bf16 else (1e-4 if variant == "deform" else 1e-5)
    for got, want in ((ts, js), (tr, jr), (tdx, jdx)):
        got, want = got.detach().numpy(), np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-6))
    jgeo = jax.jit(lambda p: jm.apply(p, jnp.asarray(x), jnp.float32(t),
                                      method=type(jm).density)[1])(params)
    tgeo = tm.density(torch.from_numpy(x), t)[1]
    np.testing.assert_allclose(tgeo.float().detach().numpy(), np.asarray(jgeo, np.float32),
                               rtol=tol, atol=tol * float(np.abs(np.asarray(jgeo)).max()))
    if use_bf16:
        return
    loss = ((torch.log1p(ts) * torch.from_numpy(ws)).sum() + (tr * torch.from_numpy(wr)).sum()
            + (tdx ** 2).sum())
    loss.backward()
    want = tdn.params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in tm.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        _scaled(p.grad, want[name], _grad_tol(name))


# ---------------------------------------------------------------------------
# the time-sliced occupancy state and its refresh schedule
# ---------------------------------------------------------------------------


def _time_occ(occ):
    """A JAX ``TimeOccupancyState`` -> the port's, on the CPU; the payloads
    JAX keeps only for the turbo march are packed per slice otherwise."""
    arrays = {f.name: np.asarray(getattr(occ, f.name)) for f in dataclasses.fields(occ)}
    if getattr(occ, "coarse_payload") is None:
        og, dg = (torch.from_numpy(np.array(arrays[k])) for k in ("occ_grid", "density_grid"))
        packed = [(*to.pack_occupancy_payloads(o, d), to.pack_prepass_payload(o))
                  for o, d in zip(og, dg)]
        for name, p in zip(("coarse_payload", "fine_payload", "prepass_payload"),
                           zip(*packed)):
            arrays[name] = torch.stack(p).numpy()
    st = to.occupancy_from_jax(arrays, device="cpu")
    return tdt.TimeOccupancyState(**{f.name: getattr(st, f.name)
                                     for f in dataclasses.fields(st)})


def _trainer_pair(tmp_path, variant="deform", turbo=True, refreshes=2, time_size=4,
                  table_scale=1.0, tx=None):
    """JAX's ``DNeRFTrainer`` (its optimizer ``tx``, by default one that
    records the gradients; a few refreshes) and the port's on its weights
    and time-sliced occupancy grid; ``table_scale`` multiplies the hash
    table's initial entries (+-1e-4, near-constant densities) before the
    refreshes."""
    tc = dict(iters=50, lr=1e-2, num_rays=256, workspace=str(tmp_path))
    rc = dict(_RC, turbo=turbo, time_size=time_size)
    jcls, tcls = VARIANTS[variant]
    jm = jcls(cfg=jconfig.NetworkConfig(**_NET, use_bf16=False),
              render=jconfig.RenderConfig(**rc))
    jtr = jdt.DNeRFTrainer(jm, jconfig.RenderConfig(**rc), jconfig.TrainConfig(**tc),
                           log_every=10**9, use_tensorboard=False)
    jtr.tx = tx or _grad_recorder()
    jtr.ensure_initialized()
    params = _small_deform(jtr.state.params)
    enc = params["params"]["encoder"]
    enc["embeddings"] = enc["embeddings"] * np.float32(table_scale)
    jtr.state = jtr.state.replace(params=jax.tree.map(jnp.asarray, params))
    for _ in range(refreshes):
        jtr._update_occupancy()
    tm = tcls(tconfig.NetworkConfig(**_NET, use_bf16=False), tconfig.RenderConfig(**rc),
              device="cpu")
    tm.load_state_dict(tdn.params_from_jax(jax.tree.map(np.asarray, jtr.state.params)))
    ttr = tdt.DNeRFTrainer(tm, tconfig.RenderConfig(**rc), tconfig.TrainConfig(**tc),
                           log_every=10**9)
    ttr.aux = {"occ": _time_occ(jtr.aux["occ"])}
    return jtr, ttr


@pytest.fixture(scope="module")
def turbo_pair(tmp_path_factory):
    return _trainer_pair(tmp_path_factory.mktemp("dnerf"))


def test_slice_at_time_matches_jax(turbo_pair):
    """Every field of the slice nearest a time, at the slices' edges, inside
    them and clipped outside [0, 1)."""
    jtr, ttr = turbo_pair
    jocc, tocc = jtr.aux["occ"], ttr.aux["occ"]
    assert tocc.density_grid.shape == (4, 1, 16, 16, 16) and jocc.iter_density == 2
    for t in (0.0, 0.2499, 0.25, 0.6, 0.999, 1.0, -0.1, 1.7):
        js = jdt.slice_at_time(jocc, jnp.float32(t), jtr.render_cfg)
        ts = tdt.slice_at_time(tocc, t, ttr.render_cfg)
        for f in dataclasses.fields(js):
            want = np.asarray(getattr(js, f.name))
            got = getattr(ts, f.name)
            got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
            np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=f.name)


@pytest.mark.parametrize("t", [0.0, 0.5, 0.9])
def test_prepass_at_time_matches_jax(turbo_pair, t):
    """The eval prepass on the slice a frame at time t probes: the port's
    ``_occ_at(t)`` through ``ray_prepass_plain`` (what the prepass runs on
    the CPU) against JAX's ``_prepass_occ`` through its ``ray_prepass``,
    on a time-sliced state whose slices hold different occupancy: hit
    equal, t0 and t1 to 1e-6."""
    import copy

    import march_model

    jtr, ttr = turbo_pair
    rc = ttr.render_cfg
    T = rc.time_size
    # one occupied cell a slice, in another corner of the grid each time:
    # the dilated payloads of the slices differ
    H = rc.grid_size
    occ = np.zeros((T, rc.cascades, H, H, H), bool)
    for i, cell in enumerate([(1, 1, 1), (H - 2, H - 2, H - 2), (1, H - 2, H // 2),
                              (H - 2, 1, H // 2)][:T]):
        occ[(i, 0) + cell] = True
    dens = np.where(occ, np.float32(20.0), np.float32(0.0)).astype(np.float32)
    packed = [jo.pack_occupancy_payloads(jnp.asarray(o), jnp.asarray(d)) for o, d in zip(occ, dens)]
    jstate = jtr.aux["occ"].replace(
        occ_grid=jnp.asarray(occ), density_grid=jnp.asarray(dens),
        coarse_payload=jnp.stack([c for c, _ in packed]),
        fine_payload=jnp.stack([f for _, f in packed]),
        prepass_payload=jnp.stack([jo.pack_prepass_payload(jnp.asarray(o)) for o in occ]))
    port = copy.copy(ttr)
    port.aux = {"occ": _time_occ(jstate)}
    ro, rd = march_model.rays("edge", n=200, seed=2, bound=rc.bound)
    jp = jo.ray_prepass(jnp.asarray(ro), jnp.asarray(rd),
                        jtr._prepass_occ({"occ": jstate}, jnp.float32(t)), jtr.render_cfg)
    tp = to.ray_prepass_plain(torch.from_numpy(ro), torch.from_numpy(rd),
                              port._occ_at(t).prepass_payload, rc)
    np.testing.assert_array_equal(tp["hit"].numpy(), np.asarray(jp["hit"]))
    assert 0 < int(tp["hit"].sum()) < 200
    for k in ("t0", "t1"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)


def test_refresh_schedule_matches_jax(tmp_path, monkeypatch):
    """The slices each of 120 refreshes updates at T = 64 (JAX's block of
    16): all 64 in the first 16, then a rotating quarter, nothing from the
    100th on (the freeze). JAX's per-block refresh and the port's
    ``update_occupancy`` are stubbed to return their input: only the
    schedule runs."""
    rc = dict(_RC, time_size=64, turbo=True)
    tc = dict(iters=10, workspace=str(tmp_path))
    jm = jdn.DNeRFNetwork(cfg=jconfig.NetworkConfig(**_NET), render=jconfig.RenderConfig(**rc))
    jtr = jdt.DNeRFTrainer(jm, jconfig.RenderConfig(**rc), jconfig.TrainConfig(**tc),
                           log_every=10**9, use_tensorboard=False)
    jtr.ensure_initialized()
    calls = []
    jtr._jit_update_occ = lambda params, cur, k, t0: (calls[-1].extend(range(t0, t0 + 16)),
                                                      (cur, 0.0))[1]
    jtr._jit_finalize_occ = lambda s: s.replace(iter_density=s.iter_density + 1)
    tm = tdn.DNeRFNetwork(tconfig.NetworkConfig(**_NET), tconfig.RenderConfig(**rc),
                          device="cpu")
    ttr = tdt.DNeRFTrainer(tm, tconfig.RenderConfig(**rc), tconfig.TrainConfig(**tc),
                           log_every=10**9)
    monkeypatch.setattr(tdt, "update_occupancy", lambda state, *a, **k: state)
    for i in range(120):
        calls.append([])
        jtr._update_occupancy()
        ttr._update_occupancy()
        assert ttr.last_refresh_slices == calls[-1], i
    sizes = [len(c) for c in calls]
    assert sizes == [64] * 16 + [16] * 84 + [0] * 20
    assert sorted(sum(calls[16:20], [])) == list(range(64))
    assert ttr.aux["occ"].iter_density == int(jtr.aux["occ"].iter_density) == 100


def test_refresh_updates_the_slices(tmp_path):
    """A real refresh on the port: every slice of the first refreshes
    changes, and the mean density is the full grid's."""
    rc = tconfig.RenderConfig(**dict(_RC, turbo=True))
    tm = tdn.DNeRFNetwork(tconfig.NetworkConfig(**_NET, use_bf16=False), rc, device="cpu")
    ttr = tdt.DNeRFTrainer(tm, rc, tconfig.TrainConfig(workspace=str(tmp_path)),
                           log_every=10**9)
    ttr._update_occupancy()
    occ = ttr.aux["occ"]
    assert ttr.last_refresh_slices == [0, 1, 2, 3] and occ.iter_density == 1
    assert (occ.density_grid.reshape(4, -1) > 0).all(dim=1).all()
    assert float(occ.mean_density) == pytest.approx(float(occ.density_grid.clamp(min=0).mean()))
    for t in range(4):
        coarse, fine = to.pack_occupancy_payloads(occ.occ_grid[t], occ.density_grid[t])
        assert torch.equal(coarse, occ.coarse_payload[t]) and torch.equal(fine,
                                                                          occ.fine_payload[t])


def _jax_step_draws(key, n, H, W):
    """The draws of JAX's train step with key ``key``, as the port takes them."""
    k_pix, k_bg, k_render = jax.random.split(key, 3)
    return {"bg": _np(jax.random.uniform(k_bg, (n, 3))),
            "noise": _np(jax.random.uniform(k_render, (n,))),
            "inds": _np(jax.random.randint(k_pix, (n,), 0, H * W))}


def _jax_refresh_draws(rng, slices, C, full, cfg):
    """The draws JAX's refresh of ``slices`` (blocks of C) takes from
    ``rng``, keyed by slice as the port's ``_update_occupancy`` takes them:
    a key per block, a key per slice, the time jitter from the slice key
    folded with 1, then ``update_occupancy``'s draws from the slice key."""
    H, cas = cfg.grid_size, cfg.cascades
    thickness = max(H // 4, 1)
    n_chunks = max(1, H**3 // (128 * 128 * 8))
    draws = {}
    for t0 in slices[::C]:
        rng, k = jax.random.split(rng)
        for i, key in enumerate(jax.random.split(k, C)):
            d = {"time_u": _np(jax.random.uniform(jax.random.fold_in(key, 1), ())),
                 "jitter": [], "slab_x0": []}
            for _ in range(cas):
                if full:
                    key, kc = jax.random.split(key)
                    u = [_np(jax.random.uniform(kk, (H**3 // n_chunks, 3)))
                         for kk in jax.random.split(kc, n_chunks)]
                    d["jitter"].append(torch.cat(u))
                else:
                    key, kx, kq = jax.random.split(key, 3)
                    d["slab_x0"].append(int(jax.random.randint(kx, (), 0, H - thickness + 1)))
                    d["jitter"].append(_np(jax.random.uniform(kq, (thickness * H * H, 3))))
            draws[t0 + i] = d
    return draws


_OCC_FIELDS = ("density_grid", "occ_grid", "coarse_payload", "fine_payload", "prepass_payload")


def _refresh_both(jtr, ttr, exact=True):
    """One refresh in both packages, the port fed JAX's draws; holds the
    port's time-sliced state to JAX's: the slices left alone unchanged;
    in each refreshed slice the density grid to 1e-4 relative, the
    occupancy bits equal but for cells within 1e-4 of the slice's
    threshold (min(its mean, density_thresh)), the three payloads JAX's
    when no bit differs; the mean over the full grid to 1e-4. Always the
    port's own grid packed and the count. ``exact=False`` (weights that
    training has carried apart) leaves out the comparisons with JAX's
    grid. Returns the refreshed slices."""
    T, C = ttr.render_cfg.time_size, ttr.refresh_time_chunk
    before = {f: getattr(ttr.aux["occ"], f).clone() for f in _OCC_FIELDS}
    it = int(jtr.aux["occ"].iter_density)
    slices, _ = tdt.refresh_slices(it, T, C, getattr(jtr, "_refresh_cursor", 0))
    draws = _jax_refresh_draws(jtr.rng, slices, C, it < 16, ttr.render_cfg)
    jtr._update_occupancy()
    ttr._update_occupancy(draws)
    assert ttr.last_refresh_slices == slices
    want, got = _time_occ(jtr.aux["occ"]), ttr.aux["occ"]
    for t in range(T):
        if t not in slices:
            for f in _OCC_FIELDS:
                assert torch.equal(getattr(got, f)[t], before[f][t]), (f, t)
            continue
        wd, gd = want.density_grid[t], got.density_grid[t]
        assert not torch.equal(gd, before["density_grid"][t]), t
        if exact:
            flips = got.occ_grid[t] != want.occ_grid[t]
            assert 0.2 < want.occ_grid[t].float().mean() < 0.8, t
            np.testing.assert_allclose(gd.numpy(), wd.numpy(), rtol=1e-4,
                                       atol=1e-4 * float(wd.abs().max()), err_msg=f"slice {t}")
            thresh = min(float(wd.clamp(min=0).mean()), ttr.render_cfg.density_thresh)
            tie = (wd - thresh).abs() <= 1e-4 * thresh
            assert not (flips & ~tie).any(), t
            if not flips.any():
                for f in _OCC_FIELDS[2:]:
                    assert torch.equal(getattr(got, f)[t], getattr(want, f)[t]), (f, t)
        coarse, fine = to.pack_occupancy_payloads(got.occ_grid[t], gd)
        assert torch.equal(coarse, got.coarse_payload[t]), t
        assert torch.equal(fine, got.fine_payload[t]), t
        assert torch.equal(to.pack_prepass_payload(got.occ_grid[t]), got.prepass_payload[t]), t
    mean = float(got.density_grid.clamp(min=0).mean())
    assert float(got.mean_density) == pytest.approx(mean, rel=1e-6)
    if exact:
        assert float(got.mean_density) == pytest.approx(float(want.mean_density), rel=1e-4)
    assert got.iter_density == int(jtr.aux["occ"].iter_density) == it + 1
    return slices


def _refresh_pair(tmp_path, variant="deform", iter_density=2, tx=None):
    """The trainers of ``_trainer_pair`` on T = 8 slices refreshed in
    blocks of C = 2, the hash table scaled by 1e3 (densities spread around
    the threshold), the port's state JAX's at ``iter_density``."""
    jtr, ttr = _trainer_pair(tmp_path, variant=variant, refreshes=2, time_size=8,
                             table_scale=1e3, tx=tx)
    # JAX's block size is fixed when its refresh compiles
    jtr.refresh_time_chunk = ttr.refresh_time_chunk = 2
    jtr._jit_update_occ = None
    jtr.aux = {"occ": jtr.aux["occ"].replace(iter_density=jnp.int32(iter_density))}
    ttr.aux = {"occ": _time_occ(jtr.aux["occ"])}
    return jtr, ttr


@pytest.mark.parametrize("phase", ["full", "quarter"])
@pytest.mark.parametrize("variant", ["deform", "hyper"])
def test_refresh_matches_jax(tmp_path, variant, phase):
    """A whole refresh in both packages from the same weights and the
    time-sliced state of two JAX refreshes, the port fed JAX's draws
    (``_refresh_both``): a full sweep of the 8 slices, or (from refresh 16
    on) two quarters in turn, the port's state JAX's before each. The
    densities' 1e-4: JAX's query points are an FMA's, an ulp off the
    port's in most cells, and the scaled table makes an ulp of a point
    ~1e-5 of a density. The basis variant is left out: in one of its
    cells JAX's refresh (its queries inside ``lax.map``) reads a density
    further from JAX's own direct evaluation of that point than the
    tolerance, and the port agrees with the direct one."""
    jtr, ttr = _refresh_pair(tmp_path, variant, iter_density=2 if phase == "full" else 16)
    if phase == "full":
        assert _refresh_both(jtr, ttr) == list(range(8))
        return
    for r in range(2):
        ttr.aux = {"occ": _time_occ(jtr.aux["occ"])}
        assert _refresh_both(jtr, ttr) == [2 * r, 2 * r + 1]


def test_training_with_refreshes_follows_jax(tmp_path):
    """Twenty-four steps of the deformation variant with a refresh every
    eight (refreshes 15, 16 and 17: the last full sweep, then two
    quarters), in both packages from the same weights and grid, the port
    fed JAX's draws for the steps and the refreshes and never given JAX's
    state again; both on plain SGD (lr 10), whose steps keep a small
    difference small where Adam's (eps 1e-15) move every weight by the
    rate however small its gradient. The first refresh is held as in
    ``test_refresh_matches_jax``, the later ones' slices and packing.

    The two packages round the deformed points apart by an ulp, and a point
    within an ulp of a cell face of the finest level (2048 across) takes
    the next cell's x-gradient: the runs part after a few steps, as JAX's
    own run parts from itself when the deformation net's last layer is
    scaled by 1 + 1e-6. So the first two losses to 1e-5 relative, and
    afterwards the port's departure from JAX's losses within twice that
    perturbed run's, at its largest and on average."""
    lr = 10.0
    jtr, ttr = _refresh_pair(tmp_path, iter_density=15, tx=optax.sgd(lr))

    def sgd():
        opt = torch.optim.SGD(ttr.model.parameters(), lr=lr)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)

    ttr._make_optimizer = sgd
    H = W = 24
    frames = tsyn.make_synthetic_frames(n_train=4, n_val=0, n_test=0, H=H, W=W,
                                        device="cpu")["train"]
    times = np.array([0.05, 0.3, 0.55, 0.8], np.float32)
    jbatch = {"images": jnp.asarray(frames.images), "poses": jnp.asarray(frames.poses),
              "intrinsics": jnp.asarray(frames.intrinsics), "times": jnp.asarray(times)}
    tbatch = {"images": torch.from_numpy(frames.images), "poses": torch.from_numpy(frames.poses),
              "intrinsics": torch.from_numpy(frames.intrinsics), "times": times}
    start = jax.tree.map(np.array, (jtr.state, jtr.aux["occ"], jtr.rng))
    step = jax.jit(jtr.train_step)

    def run(port):
        losses, refreshed = [], []
        for i in range(24):
            if i % 8 == 0:
                refreshed.append(_refresh_both(jtr, ttr, exact=i == 0) if port
                                 else jtr._update_occupancy())
            key = jax.random.PRNGKey(100 + i)
            jtr.state, jtr.aux, met = step(jtr.state, jtr.aux,
                                           dict(jbatch, idx=jnp.int32(i % 4)), key)
            losses.append([float(met["loss"])])
            if port:
                met = ttr.train_step(dict(tbatch, idx=i % 4), _jax_step_draws(key, 256, H, W))
                losses[-1].append(float(met["loss"]))
        return np.array(losses).T, refreshed

    (want, got), refreshed = run(port=True)
    assert refreshed == [list(range(8)), [0, 1], [2, 3]]
    state, occ, jtr.rng = jax.tree.map(jnp.asarray, start)
    last = state.params["params"]["deform_net"]["dense_4"]
    last["kernel"] = last["kernel"] * np.float32(1 + 1e-6)
    jtr.state, jtr.aux, jtr._refresh_cursor = state, {"occ": occ}, 0
    (again,), _ = run(port=False)
    port, jax_self = (got - want) / want, (again - want) / want
    print(f"largest relative departure from JAX's losses: the port {np.abs(port).max():.3e}, "
          f"JAX perturbed {np.abs(jax_self).max():.3e}; mean {port.mean():.3e} and "
          f"{jax_self.mean():.3e}")
    assert np.abs(port[:2]).max() <= 1e-5 and np.abs(jax_self).max() > 1e-4
    assert np.abs(port).max() <= 2 * np.abs(jax_self).max()
    assert abs(port.mean()) <= 2 * np.abs(jax_self).mean()
    assert want[-4:].mean() < want[:4].mean() and got[-4:].mean() < got[:4].mean()


# ---------------------------------------------------------------------------
# the train step and the frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("turbo", [True, False])
def test_deform_step_matches_jax(tmp_path, turbo):
    """One f32 step of the deformation variant with JAX's draws, the batch's
    frame at time 2/3 (slice 2): the loss with the deformation L1 and every
    gradient, the deformation net's included."""
    jtr, ttr = _trainer_pair(tmp_path, turbo=turbo)
    H = W = 24
    frames = tsyn.make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=H, W=W,
                                        device="cpu")["train"]
    times = np.array([0.1, 2.0 / 3.0], np.float32)
    batch = {"images": jnp.asarray(frames.images), "poses": jnp.asarray(frames.poses),
             "intrinsics": jnp.asarray(frames.intrinsics), "times": jnp.asarray(times),
             "idx": jnp.int32(1)}
    rng = jax.random.PRNGKey(7)
    jstate, _, jmet = jax.jit(jtr.train_step)(jtr.state, jtr.aux, batch, rng)
    draws = _jax_step_draws(rng, 256, H, W)
    tbatch = {"images": torch.from_numpy(frames.images), "poses": torch.from_numpy(frames.poses),
              "intrinsics": torch.from_numpy(frames.intrinsics), "times": times, "idx": 1}
    seen = {}
    extra = ttr._render_loss_extra
    ttr._render_loss_extra = lambda out: seen.setdefault("reg", extra(out))
    tmet = ttr.train_step(tbatch, draws)
    loss = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - loss) <= 1e-5 * loss and loss > 0
    assert float(seen["reg"]) > 0
    jgrads = tdn.params_from_jax(jax.tree.map(np.asarray, jstate.opt_state["g"]))
    names = [name for name, _ in ttr.model.named_parameters()]
    assert any(n.startswith("deform_net") for n in names)
    for name, p in ttr.model.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        _scaled(p.grad, jgrads[name], _grad_tol(name))


@pytest.mark.parametrize("variant", ["deform", "hyper"])
def test_frames_at_two_times_match_jax(tmp_path, variant):
    """``render_frame(..., time=)`` at two times (two slices, the eval
    prepass on each): JAX's pixels; the two times give different frames."""
    jtr, ttr = _trainer_pair(tmp_path, variant=variant)
    pose = tsyn.make_synthetic_frames(n_train=1, n_val=0, n_test=0, H=8, W=8,
                                      device="cpu")["train"].poses[0]
    H = W = 24
    intr = np.array([30.0, 30.0, 12.0, 12.0], np.float32)
    got = {}
    for t in (0.1, 0.8):
        want, _ = jtr.render_frame(pose, intr, H, W, time=t)
        got[t], _ = ttr.render_frame(pose, intr, H, W, time=t)
        err = np.abs(np.asarray(got[t], np.float32) - np.asarray(want, np.float32))
        assert got[t].shape == (H, W, 3) and np.isfinite(got[t]).all()
        assert err.mean() <= 1e-4 and (err <= 1e-3).mean() >= 0.995
    assert np.abs(got[0.1] - got[0.8]).max() > 0
    with pytest.raises(ValueError, match="share one scene time"):
        ttr.render_frames(np.stack([pose, pose]), intr, H, W, times=[0.1, 0.8])


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_parser_pinned_to_main_dnerf(monkeypatch):
    want = parser_actions(jax_main_parser(monkeypatch, "main_dnerf.py"))
    got = parser_actions(tmain.build_parser())
    assert [a[2] for a in got] == [a[2] for a in want]
    for g, w in zip(got, want):
        assert g == w, g[2]


@pytest.mark.parametrize("variant", [[], ["--hyper"]])
def test_main_runs_on_the_cpu(tmp_path, monkeypatch, variant):
    """``-O --time_size 4`` on a small dynamic scene (the grid cut to 16^3,
    the hash grid to 4 levels of 2^12 rows): training at the frames'
    times, evaluate on the test split; then ``--test`` from the
    checkpoint gives the same PSNR. ``--gui`` resumes the checkpoint and
    reaches ``serve`` (replaced) with an ``InteractiveSession``."""
    from ngp_tpu_torch.training.nerf import NeRFTrainer

    root = tsyn.make_synthetic_dataset(str(tmp_path / "scene"), n_train=4, n_val=1, n_test=2,
                                       H=24, W=24, num_steps=64, dynamic=True, device="cpu")
    assert len(set(NeRFDataset(root, split="train").times.tolist())) == 4
    monkeypatch.setattr(tmain, "RenderConfig",
                        functools.partial(tconfig.RenderConfig, grid_size=16))
    monkeypatch.setattr(tmain, "NetworkConfig",
                        functools.partial(tconfig.NetworkConfig, num_levels=4,
                                          log2_hashmap_size=12))
    results = []
    evaluate = NeRFTrainer.evaluate
    monkeypatch.setattr(NeRFTrainer, "evaluate",
                        lambda self, *a, **k: results.append(evaluate(self, *a, **k))
                        or results[-1])
    argv = [root, "-O", "--workspace", str(tmp_path / "ws"), "--iters", "8", "--num_rays",
            "256", "--time_size", "4", *variant]
    tr = tmain.main(argv, device="cpu")
    assert tr.global_step == 8 and tr.aux["occ"].density_grid.shape[0] == 4
    assert tr.model.compute_dtype == torch.bfloat16 and np.isfinite(tr.stats["loss"]).all()
    assert len(results) == 1 and np.isfinite(results[0]["psnr"])
    back = tmain.main(argv + ["--test"], device="cpu")
    assert back.global_step == 8 and back.aux["occ"].iter_density == tr.aux["occ"].iter_density
    assert results[1]["psnr"] == pytest.approx(results[0]["psnr"], abs=1e-6)
    from ngp_tpu_torch import viewer_web
    from ngp_tpu_torch.viewer import InteractiveSession

    served = []
    monkeypatch.setattr(viewer_web, "serve", lambda session, **kw: served.append(session))
    gui = tmain.main(argv + ["--gui"], device="cpu")
    assert len(served) == 1 and isinstance(served[0], InteractiveSession)
    assert served[0].trainer is gui and gui.global_step == tr.global_step
