"""The port's occupancy grid, turbo march, prepass, compaction and
compositor against ngp_tpu/models/occupancy.py on the same grids, rays
and random draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.config import RenderConfig as JRenderConfig
from ngp_tpu.models import occupancy as jo
from ngp_tpu_torch.config import RenderConfig
from ngp_tpu_torch.models import occupancy as to

import march_model


def _cfg(**kw):
    kw.setdefault("bound", 1.0)
    kw.setdefault("min_near", 0.05)
    kw.setdefault("dt_gamma", 0.0)
    kw.setdefault("max_steps", 64)
    kw.setdefault("max_samples_per_ray", 16)
    kw.setdefault("grid_size", 16)
    kw.setdefault("turbo", True)
    kw.setdefault("coarse_candidates", 32)
    kw.setdefault("crossing_slots", 8)
    kw.setdefault("compact_mean_samples", 6)
    return JRenderConfig(**kw), RenderConfig(**kw)


def _rays(n=96, seed=0, bound=1.0):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.3, 0.3, size=(n, 3)).astype(np.float32)
    ro[:, 2] = -2.2 * bound
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.6
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return ro, d


def _grids(jcfg, seed=1, frac=0.2):
    rng = np.random.default_rng(seed)
    shape = (jcfg.cascades,) + (jcfg.grid_size,) * 3
    dens = rng.exponential(20.0, size=shape).astype(np.float32)
    dens[rng.random(shape) < 0.05] = -1.0
    occ = (rng.random(shape) < frac) & (dens > 0)
    return occ, dens


def _jax_state(jcfg, occ, dens):
    occ_j, dens_j = jnp.asarray(occ), jnp.asarray(dens)
    cp, fp = jo.pack_occupancy_payloads(occ_j, dens_j)
    return jo.init_occupancy(jcfg).replace(
        occ_grid=occ_j, density_grid=dens_j, coarse_payload=cp, fine_payload=fp,
        prepass_payload=jo.pack_prepass_payload(occ_j),
    )


def _to_port(jstate):
    arrays = {f.name: np.asarray(getattr(jstate, f.name))
              for f in dataclasses.fields(jstate)}
    return to.occupancy_from_jax(arrays, device="cpu")


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("bound,H", [(1.0, 16), (2.0, 32)])
def test_payload_packing_bit_for_bit(bound, H):
    jcfg, cfg = _cfg(bound=bound, grid_size=H)
    occ, dens = _grids(jcfg)
    cp_j, fp_j = jo.pack_occupancy_payloads(jnp.asarray(occ), jnp.asarray(dens))
    cp_t, fp_t = to.pack_occupancy_payloads(torch.from_numpy(occ), torch.from_numpy(dens))
    _eq(cp_t, cp_j)
    _eq(fp_t, np.asarray(fp_j).astype(np.int64))
    _eq(to.pack_prepass_payload(torch.from_numpy(occ)),
        jo.pack_prepass_payload(jnp.asarray(occ)))
    cp_j0, fp_j0 = jo.pack_occupancy_payloads(jnp.asarray(occ))
    cp_t0, fp_t0 = to.pack_occupancy_payloads(torch.from_numpy(occ))
    _eq(fp_t0, np.asarray(fp_j0).astype(np.int64))
    js, ts = jo.init_occupancy(jcfg), to.init_occupancy(cfg, device="cpu")
    for name in ("coarse_payload", "prepass_payload", "density_grid", "occ_grid"):
        _eq(getattr(ts, name), getattr(js, name))
    _eq(to.occupied_aabb(_to_port(_jax_state(jcfg, occ, dens)), cfg),
        jo.occupied_aabb(_jax_state(jcfg, occ, dens), jcfg))


def _jax_draws(jcfg, key, full):
    """The jitter (and slab) draws jax update_occupancy makes from key."""
    H, cas = jcfg.grid_size, jcfg.cascades
    jit, x0s = [], []
    if full:
        n_chunks = max(1, (H**3) // (128 * 128 * 8))
        for _ in range(cas):
            key, k = jax.random.split(key)
            keys = jax.random.split(k, n_chunks)
            jit.append(np.concatenate([
                np.asarray(jax.random.uniform(kk, (H**3 // n_chunks, 3))) for kk in keys
            ]))
        return jit, None
    th = max(H // 4, 1)
    for _ in range(cas):
        key, kx, kq = jax.random.split(key, 3)
        x0s.append(int(jax.random.randint(kx, (), 0, H - th + 1)))
        jit.append(np.asarray(jax.random.uniform(kq, (th * H * H, 3))))
    return jit, x0s


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_update_occupancy_full_and_partial(bound):
    from ngp_tpu.models.nerf import make_fused_density as j_fd
    from test_torch_cp_kernels import _jax_network, _port_network
    from ngp_tpu_torch.models.nerf import make_fused_density

    model, params, nc, _ = _jax_network(False)
    jcfg, cfg = _cfg(bound=bound, density_thresh=10.0)
    model = model.clone(render=jcfg)
    net = _port_network(params, nc, cfg)
    jfn, tfn = j_fd(model, params), make_fused_density(net)

    s0 = jo.init_occupancy(jcfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    s1 = jo.update_occupancy(s0, jfn, jcfg, k1)
    jit, _ = _jax_draws(jcfg, k1, full=True)
    with torch.no_grad():
        t1 = to.update_occupancy(_to_port(s0), tfn, cfg,
                                 jitter=[torch.tensor(j) for j in jit])
    _close(t1.density_grid, s1.density_grid, 1e-5)
    _eq(t1.occ_grid, s1.occ_grid)
    _eq(t1.coarse_payload, s1.coarse_payload)
    _eq(t1.fine_payload, np.asarray(s1.fine_payload).astype(np.int64))
    _eq(t1.prepass_payload, s1.prepass_payload)
    assert t1.iter_density == 1
    assert 0.0 < float(t1.occ_grid.float().mean()) < 1.0

    s1p = s1.replace(iter_density=jnp.int32(16))
    s2 = jo.update_occupancy(s1p, jfn, jcfg, k2)
    jit, x0s = _jax_draws(jcfg, k2, full=False)
    with torch.no_grad():
        t2 = to.update_occupancy(_to_port(s1p), tfn, cfg,
                                 jitter=[torch.tensor(j) for j in jit], slab_x0=x0s)
    _close(t2.density_grid, s2.density_grid, 1e-5)
    _eq(t2.occ_grid, s2.occ_grid)
    _eq(t2.fine_payload, np.asarray(s2.fine_payload).astype(np.int64))
    # the port's own generator draws give a partial refresh too
    with torch.no_grad():
        t3 = to.update_occupancy(t2, tfn, cfg, generator=torch.Generator().manual_seed(0))
    assert t3.iter_density == 18


MARCH_CASES = [
    dict(),
    dict(coarse_candidates=64, crossing_slots=64, max_samples_per_ray=32),
    dict(dt_gamma=1 / 128, bound=2.0),
    dict(lattice_span=1.5),
]


@pytest.mark.parametrize("kw", MARCH_CASES)
def test_march_rays_turbo(kw):
    jcfg, cfg = _cfg(**kw)
    occ, dens = _grids(jcfg, frac=0.15)
    js = _jax_state(jcfg, occ, dens)
    ts = _to_port(js)
    ro, rd = _rays(bound=jcfg.bound)
    jm = jo.march_rays_turbo(jnp.asarray(ro), jnp.asarray(rd), js, jcfg)
    tm = to.march_rays_turbo(torch.from_numpy(ro), torch.from_numpy(rd), ts, cfg)
    _eq(tm["mask"], jm["mask"])
    _close(tm["ts"], jm["ts"], 1e-6)
    _close(tm["deltas"], jm["deltas"], 1e-6)
    _eq(tm["n_total"], jm["n_total"])
    _close(tm["n_dropped"], jm["n_dropped"], 1e-5)
    assert int(tm["mask"].sum()) > 0


def test_march_rays_turbo_t_range_and_proxy():
    jcfg, cfg = _cfg(t_proxy_thresh=1e-2)
    occ, dens = _grids(jcfg, frac=0.4)
    js = _jax_state(jcfg, occ, dens)
    ro, rd = _rays(seed=4)
    tr = np.stack([np.full(ro.shape[0], 1.5, np.float32),
                   np.full(ro.shape[0], 2.8, np.float32)], axis=-1)
    jm = jo.march_rays_turbo(jnp.asarray(ro), jnp.asarray(rd), js, jcfg,
                             t_range=jnp.asarray(tr))
    tm = to.march_rays_turbo(torch.from_numpy(ro), torch.from_numpy(rd), _to_port(js), cfg,
                             t_range=torch.from_numpy(tr))
    _eq(tm["mask"], jm["mask"])
    _close(tm["ts"], jm["ts"], 1e-6)


@pytest.mark.parametrize("kw", list(march_model.PREPASS_CASES.values()))
def test_ray_prepass(kw):
    """ray_prepass_plain (which ray_prepass runs on the CPU) against JAX's
    ray_prepass over march_model.PREPASS_CASES: one, two and three
    cascades, dt_gamma 0 and 1/128, a box override, a lattice span, rays
    that miss the box and rays that start inside it."""
    changes, frac, kind, box = kw
    jcfg, cfg = _cfg(**changes)
    occ, dens = _grids(jcfg, frac=frac)
    js = _jax_state(jcfg, occ, dens)
    ro, rd = march_model.rays(kind, n=200, seed=2, bound=jcfg.bound)
    jp = jo.ray_prepass(jnp.asarray(ro), jnp.asarray(rd), js, jcfg,
                        aabb=None if box is None else jnp.asarray(box, jnp.float32))
    ts = _to_port(js)
    tro, trd = torch.from_numpy(ro), torch.from_numpy(rd)
    tp = to.ray_prepass_plain(tro, trd, ts.prepass_payload, cfg, aabb=box)
    via = to.ray_prepass(tro, trd, ts, cfg, aabb=box)
    assert set(tp) == set(via) == {"hit", "t0", "t1", "nears", "fars"}
    for k in tp:
        assert torch.equal(via[k], tp[k]), k
    _eq(tp["hit"], jp["hit"])
    assert 0 < int(tp["hit"].sum()) < 200
    _close(tp["t0"], jp["t0"], 1e-6)
    _close(tp["t1"], jp["t1"], 1e-6)


def test_composite_rays():
    rng = np.random.default_rng(8)
    N, S = 40, 16
    sig = rng.exponential(5.0, size=(N, S)).astype(np.float32)
    rgb = rng.random((N, S, 3)).astype(np.float32)
    ts = np.sort(rng.uniform(0.5, 3.0, size=(N, S)), axis=1).astype(np.float32)
    dl = rng.uniform(0.01, 0.1, size=(N, S)).astype(np.float32)
    mask = rng.random((N, S)) < 0.7
    near, far = np.full(N, 0.4, np.float32), np.full(N, 3.1, np.float32)
    jout = jo.composite_rays(*map(jnp.asarray, (sig, rgb, ts, dl, mask, near, far)))
    tout = to.composite_rays(*map(torch.from_numpy, (sig, rgb, ts, dl, mask, near, far)))
    for k in ("weights", "weights_sum", "image", "depth"):
        _close(tout[k], jout[k], 1e-6)


def _vals_j(x, d):
    s = jnp.exp(2.0 * jnp.sin(3.0 * x[:, :1]))
    return jnp.concatenate([s, 0.5 + 0.5 * jnp.cos(x * 2.0 + d)], axis=-1)


def _vals_t(x, d):
    s = torch.exp(2.0 * torch.sin(3.0 * x[:, :1]))
    return torch.cat([s, 0.5 + 0.5 * torch.cos(x * 2.0 + d)], dim=-1)


@pytest.mark.parametrize("budget_per_ray", [2, 6, None])
def test_water_filled_compaction_and_render(budget_per_ray):
    jcfg, cfg = _cfg(max_samples_per_ray=32, coarse_candidates=64, crossing_slots=16)
    occ, dens = _grids(jcfg, frac=0.3)
    js = _jax_state(jcfg, occ, dens)
    ro, rd = _rays(n=128, seed=6)
    N = ro.shape[0]
    budget = None if budget_per_ray is None else N * budget_per_ray
    jg = jo._turbo_compact_geometry(jnp.asarray(ro), jnp.asarray(rd), js, jcfg, None, False,
                                    None, None, budget)
    tg = to._turbo_compact_geometry(torch.from_numpy(ro), torch.from_numpy(rd),
                                    _to_port(js), cfg, None, None, budget)
    _, S_j, b_j, src_j, valid_j, off_j, tc_j, pts_j, dirs_j, maskb_j = jg
    _, S_t, b_t, src_t, valid_t, off_t, tc_t, pts_t, dirs_t, maskb_t = tg
    assert (S_t, b_t) == (S_j, b_j)
    _eq(src_t, src_j)
    _eq(valid_t, valid_j)
    _eq(off_t, off_j)
    _eq(maskb_t, maskb_j)
    _close(tc_t, tc_j, 1e-6)
    _close(pts_t, pts_j, 1e-6)
    _close(dirs_t, dirs_j, 1e-6)

    jr = jo.render_rays_grid_turbo(None, None, jnp.asarray(ro), jnp.asarray(rd), js, jcfg,
                                   budget=budget, vals_fn=_vals_j)
    tr = to.render_rays_grid_turbo(None, None, torch.from_numpy(ro), torch.from_numpy(rd),
                                   _to_port(js), cfg, budget=budget, vals_fn=_vals_t)
    _close(tr["image"], jr["image"], 1e-5)
    _close(tr["depth"], jr["depth"], 1e-5)
    assert int(tr["n_samples"]) == int(jr["n_samples"])
    _close(tr["n_dropped"], jr["n_dropped"], 1e-4)


def test_place_compact_forward():
    rng = np.random.default_rng(9)
    N, S, Fd = 12, 8, 4
    counts = rng.integers(0, S // 4 + 1, size=N) * 4
    mask = np.arange(S)[None, :] < counts[:, None]
    budget = int(counts.sum())
    src_j, valid_j, off_j = jo.compact_valid_samples(jnp.asarray(mask), budget)
    src_t, valid_t, off_t = to.compact_valid_samples(torch.from_numpy(mask), budget)
    _eq(src_t, src_j)
    _eq(off_t, off_j)
    vals = rng.normal(size=(budget, Fd)).astype(np.float32)
    pj = jo.place_compact(jnp.asarray(vals), off_j, src_j, S)
    pt = to.place_compact(torch.from_numpy(vals), off_t, src_t, S)
    _eq(pt.numpy()[mask], np.asarray(pj)[mask])
