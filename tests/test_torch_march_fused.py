"""The turbo march that ``march_turbo`` runs as one kernel, on the CPU:
its plain version (the JAX composition, moved out of
``models/occupancy.py``) and a numpy model of the kernel's algorithm
(``march_model.py``), each against ``ngp_tpu/models/occupancy.py:
march_rays_turbo`` on the same grids, rays and noise. Samples, their
steps, the mask and the counts are held for equality, the drop
estimate to 1e-6.

The model shows that the kernel's shape changes no sample: one ray at a
time in rounds of 32 probes, candidates compacted in march order by
ballots instead of a top-k over t-bits keys, fine bits read from each
candidate's own coarse cell instead of a per-crossing slot table, and
the first S fine survivors by a second pass instead of a second top-k.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from march_model import CASES, F32, config, grids, march_model, rays, t_ranges
from ngp_tpu.config import RenderConfig as JRenderConfig
from ngp_tpu.models import occupancy as jo
from ngp_tpu_torch.config import RenderConfig
from ngp_tpu_torch.models import occupancy as to
from ngp_tpu_torch.ops import lattice
from ngp_tpu_torch.ops.kernels import march as tm
from test_torch_occupancy import _jax_state, _to_port

OUTPUTS = ("ts", "deltas", "mask", "n_total")


def _case(name):
    """The case's configs, JAX and port states, rays, noise (as JAX draws
    it) and t_range, and JAX's march of them (eager, so XLA fuses no
    multiply-add that the port rounds twice)."""
    kw, frac, kind, noisy, clipped = CASES[name]
    jcfg, cfg = JRenderConfig(**config(kw)), RenderConfig(**config(kw))
    occ, dens = grids(cfg, frac=frac)
    js = _jax_state(jcfg, occ, dens)
    ro, rd = rays(kind, bound=cfg.bound)
    tr = t_ranges(ro.shape[0]) if clipped else None
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.uniform(key, (ro.shape[0],))) if noisy else None
    jm = jo.march_rays_turbo(jnp.asarray(ro), jnp.asarray(rd), js, jcfg,
                             t_range=None if tr is None else jnp.asarray(tr),
                             rng=key if noisy else None, perturb=noisy)
    return cfg, _to_port(js), ro, rd, noise, tr, {k: np.asarray(v) for k, v in jm.items()}


def _hold(got, want):
    for k in OUTPUTS:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    np.testing.assert_allclose(np.asarray(got["n_dropped"]), want["n_dropped"], rtol=1e-6,
                               atol=1e-6)
    assert int(np.asarray(got["mask"]).sum()) > 0


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("name", list(CASES))
def test_march_turbo_plain_matches_jax(name):
    cfg, state, ro, rd, noise, tr, want = _case(name)
    S, K2, U = to.turbo_budgets(cfg)
    got = tm.march_turbo_plain(torch.from_numpy(ro), torch.from_numpy(rd), state.coarse_payload,
                               state.fine_payload, cfg, S, K2, U, t_range=_t(tr),
                               noise=_t(noise))
    _hold(got, want)
    np.testing.assert_array_equal(got["nears"].numpy(), want["nears"])
    np.testing.assert_array_equal(got["fars"].numpy(), want["fars"])
    # the wrapper and the model's caller take the plain version on the CPU
    full = to.march_rays_turbo(torch.from_numpy(ro), torch.from_numpy(rd), state, cfg,
                               t_range=_t(tr), perturb=noise is not None, noise=_t(noise))
    _hold(full, want)
    np.testing.assert_array_equal(full["xyzs"].numpy(), want["xyzs"])


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_model_matches_jax(name):
    cfg, state, ro, rd, noise, tr, want = _case(name)
    S, K2, U = to.turbo_budgets(cfg)
    args = (ro, rd, state.coarse_payload.numpy(), state.fine_payload.numpy())
    got = march_model(*args, cfg, S, K2, U, t_range=tr, noise=noise)
    _hold(got, want)
    np.testing.assert_array_equal(got["nears"], want["nears"])
    # each case reaches what it is named for
    hit = got["fars"] > got["nears"]
    if name == "more than K2 coarse survivors":
        assert (got["n_coarse"] > K2).any() and (want["n_dropped"] > 0).any()
    if name == "more than U crossings":
        assert (got["n_cross"] > U).any()
    if name == "misses and starts inside":
        assert (~hit).any() and (hit & (got["nears"] == F32(cfg.min_near))).any()
    if name == "t_range, proxy":
        off = march_model(*args, dataclasses.replace(cfg, t_proxy_thresh=None), S, K2, U,
                          t_range=tr, noise=noise)
        assert (got["n_total"] < off["n_total"]).any()
        assert np.isfinite(got["approach"]).any()


def test_the_occupancy_module_re_exports_the_lattice():
    for name in ("dt_bounds", "lattice_probes", "t_lattice", "_cells", "_points", "mip_from_pos",
                 "mip_from_dt", "_frexp_exponent", "_tbits", "_ascending", "COARSE_FACTOR",
                 "SQRT3", "_TKEY_INVALID", "_TKEY_THRESH"):
        assert getattr(to, name) is getattr(lattice, name), name


@pytest.mark.parametrize("max_samples,want", [(None, (16, 32, 8)), (7, (8, 32, 8)),
                                              (200, (32, 32, 8))])
def test_turbo_budgets(max_samples, want):
    assert to.turbo_budgets(RenderConfig(**config({})), max_samples) == want
    with pytest.raises(ValueError, match="lattice too short"):
        to.turbo_budgets(RenderConfig(**config(dict(lattice_span=0.001, max_steps=1024))))
