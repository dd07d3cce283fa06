"""The port's plain CP heads and coarse lookup against the JAX package:
the Pallas kernels run in interpret mode (as tests/test_cp_kernels.py
runs them) and the CPU branches of ops/cpgrid.py.

Tolerances. f32: 1e-4, as the JAX kernel tests use. bf16: the port
rounds features, h1, SH, geo and the color hiddens to bf16 where the
Pallas kernels do, and lerps the factor lines in f32 as the JAX CPU
reference does. Against the JAX CPU branch of cpgrid_density (same
rounding points) it is held to 1e-2: a different f32 summation order
can flip one bf16 rounding (2^-8 relative) of a hidden unit. Against
the Pallas kernels, which also build their lerp weights in bf16, every
CP feature differs by up to a few bf16 steps, so it is held to 5e-2;
so is the JAX CPU branch of cpgrid_sigma_rgb, which rounds neither the
features nor h1 to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.ops import cpgrid as jcp
from ngp_tpu.ops.pallas import cp_kernels as jk
from ngp_tpu.ops.pallas.march_kernels import coarse_lookup_bits as j_lookup
from ngp_tpu_torch.ops import cpgrid as tcp
from ngp_tpu_torch.ops.kernels import cp as tk
from ngp_tpu_torch.ops.kernels import march as tm

RES = (32, 64)
RANK = 16
FD = 4
SH = 3


def _setup(m=260, seed=3, h1=32, out=8):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.1, 1.1, size=(m, 3)).astype(np.float32)
    dirs = rng.normal(size=(m, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    factors = tuple(rng.normal(0, 0.3, size=(3, r, RANK)).astype(np.float32) for r in RES)
    D = len(RES) * RANK + 3 * (1 + 2 * FD)
    w1 = rng.normal(0, 0.2, size=(D, h1)).astype(np.float32)
    w2 = rng.normal(0, 0.2, size=(h1, out)).astype(np.float32)
    dims = [SH * SH + out - 1, 16, 16, 3]
    color = tuple(rng.normal(0, 0.3, size=(dims[i], dims[i + 1])).astype(np.float32)
                  for i in range(3))
    return pos, dirs, factors, w1, w2, color


def _j(xs, dtype=jnp.float32):
    return tuple(jnp.asarray(x, dtype) for x in xs)


def _t(xs, dtype=torch.float32):
    return tuple(torch.from_numpy(np.asarray(x, np.float32)).to(dtype) for x in xs)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _widths(cases):
    """The cases at H1 = 32 (their ids as before) and again at H1 = 128,
    a sigma MLP wider than the 128-row tensor-core tiles take (the card's
    64- and 32-row tiles; H1 = 128 is the bf16 turbo network at
    ``hidden_dim=128``)."""
    return ([pytest.param(*c, 32, id="-".join(map(str, c))) for c in cases]
            + [pytest.param(*c, 128, id="-".join(map(str, c)) + "-h1_128") for c in cases])


@pytest.mark.parametrize("dtype,tol_cpu,tol_pallas,h1", _widths([
    ("float32", 1e-4, 1e-4), ("bfloat16", 1e-2, 5e-2),
]))
def test_cp_density_plain(dtype, tol_cpu, tol_pallas, h1):
    pos, _, factors, w1, w2, _ = _setup(h1=h1)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = tk.cp_density_plain(torch.from_numpy(pos), _t(factors, td), *_t((w1, w2), td),
                              RES, FD)
    pallas = jk.cp_density(jnp.asarray(pos), _j(factors, jd), *_j((w1, w2), jd), RES, FD, 128)
    cfg = jcp.CPGridConfig(resolutions=RES, rank=RANK, freq_degree=FD)
    cpu = jcp.cpgrid_density(jnp.asarray(pos), _j(factors), *_j((w1, w2)), cfg,
                             compute_dtype=None if dtype == "float32" else jd)
    assert got.shape == (pos.shape[0], w2.shape[1]) and got.dtype == torch.float32
    _close(got, cpu, tol_cpu)
    _close(got, pallas, tol_pallas)


@pytest.mark.parametrize("dtype,tol,h1", _widths([("float32", 1e-4), ("bfloat16", 5e-2)]))
def test_cp_sigma_rgb_plain(dtype, tol, h1):
    pos, dirs, factors, w1, w2, color = _setup(seed=5, h1=h1)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = tk.cp_sigma_rgb_plain(torch.from_numpy(pos), torch.from_numpy(dirs),
                                _t(factors, td), *_t((w1, w2), td), _t(color, td),
                                RES, FD, SH)
    pallas = jk.cp_sigma_rgb(jnp.asarray(pos), jnp.asarray(dirs), _j(factors, jd),
                             *_j((w1, w2), jd), _j(color, jd), RES, FD, SH, 128)
    cfg = jcp.CPGridConfig(resolutions=RES, rank=RANK, freq_degree=FD)
    cpu = jcp.cpgrid_sigma_rgb(jnp.asarray(pos), jnp.asarray(dirs), _j(factors),
                               *_j((w1, w2)), _j(color), cfg, SH,
                               compute_dtype=None if dtype == "float32" else jd)
    assert got.shape == (pos.shape[0], 4)
    _close(got, pallas, tol)
    _close(got, cpu, tol)


def test_cpgrid_dispatch_on_cpu_matches_jax():
    """ops/cpgrid.py's public functions on CPU tensors (the dispatch the
    renderer uses) == the JAX CPU branches, f32."""
    pos, dirs, factors, w1, w2, color = _setup(seed=7)
    jcfg = jcp.CPGridConfig(resolutions=RES, rank=RANK, freq_degree=FD)
    tcfg = tcp.CPGridConfig(resolutions=RES, rank=RANK, freq_degree=FD)
    assert tcfg.output_dim == jcfg.output_dim
    x = pos.reshape(13, 20, 3)
    _close(tcp.cpgrid_encode(torch.from_numpy(x), _t(factors), tcfg),
           jcp.cpgrid_encode(jnp.asarray(x), _j(factors), jcfg), 1e-5)
    _close(tcp.cpgrid_density(torch.from_numpy(x), _t(factors), *_t((w1, w2)), tcfg),
           jcp.cpgrid_density(jnp.asarray(x), _j(factors), *_j((w1, w2)), jcfg), 1e-4)
    got = tcp.cpgrid_sigma_rgb(torch.from_numpy(pos), torch.from_numpy(dirs), _t(factors),
                               *_t((w1, w2)), _t(color), tcfg, SH)
    want = jcp.cpgrid_sigma_rgb(jnp.asarray(pos), jnp.asarray(dirs), _j(factors),
                                *_j((w1, w2)), _j(color), jcfg, SH)
    _close(got, want, 1e-4)


def test_cpgrid_init_distribution():
    cfg = tcp.CPGridConfig(resolutions=(64, 128), rank=32)
    banks = cfg.init(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(b.shape) for b in banks] == [(3, 64, 32), (3, 128, 32)]
    allv = torch.cat([b.reshape(-1) for b in banks])
    assert abs(float(allv.mean())) < 0.01
    assert abs(float(allv.std()) - 0.2) < 0.01


@pytest.mark.parametrize("R", [1, 16])
def test_coarse_lookup_plain_bits(R):
    rng = np.random.default_rng(17 + R)
    payload = rng.integers(0, 256, size=(R, 128)).astype(np.float32)
    fc = rng.integers(0, R * 1024, size=(7, 193)).astype(np.int32)
    got = tm.coarse_lookup_plain(torch.from_numpy(payload), torch.from_numpy(fc))
    want = j_lookup(jnp.asarray(payload), jnp.asarray(fc), block=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        tm.coarse_lookup_bits(torch.from_numpy(payload), torch.from_numpy(fc)).numpy(),
        got.numpy(),
    )


def test_coarse_lookup_past_payload_is_empty():
    payload = torch.full((2, 128), 255.0)
    fc = torch.tensor([0, 2047, 2048, 5000], dtype=torch.int32)
    assert tm.coarse_lookup_plain(payload, fc).tolist() == [True, True, False, False]


def test_wrappers_refuse_other_devices():
    pos = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        tm.coarse_lookup_bits(torch.zeros((1, 128), device="meta"),
                              torch.zeros((4,), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        tk.cp_density_fwd(pos, (), pos, pos, (), 0)


def _jax_network(use_bf16):
    from ngp_tpu.config import NetworkConfig, RenderConfig
    from ngp_tpu.models.nerf import NeRFNetwork

    rc = RenderConfig(bound=1.0, turbo=True)
    nc = NetworkConfig(encoding="cpgrid", use_bf16=use_bf16, cp_resolutions=RES,
                       cp_rank=RANK, cp_freq_degree=FD, sh_degree=SH)
    model = NeRFNetwork(cfg=nc, render=rc)
    x0 = jnp.zeros((8, 3))
    params = model.init(jax.random.PRNGKey(0), x0, x0, method=NeRFNetwork.full_init)
    return model, params, nc, rc


def _port_network(params, nc, rc):
    import dataclasses

    from ngp_tpu_torch.config import NetworkConfig, RenderConfig
    from ngp_tpu_torch.models.nerf import NeRFNetwork, params_from_jax

    net = NeRFNetwork(NetworkConfig(**dataclasses.asdict(nc)),
                      RenderConfig(**dataclasses.asdict(rc)), device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return net


def test_params_from_jax_real_init_tree():
    """A real NeRFNetwork.init tree loads into the port (every name and
    shape), and the module and fused paths then agree with JAX in f32."""
    from ngp_tpu.models.nerf import NeRFNetwork as JNet
    from ngp_tpu.models.nerf import make_fused_density as j_fd
    from ngp_tpu.models.nerf import make_fused_sigma_rgb as j_fs
    from ngp_tpu_torch.models.nerf import make_fused_density, make_fused_sigma_rgb

    model, params, nc, rc = _jax_network(False)
    net = _port_network(params, nc, rc)
    sd = net.state_dict()
    assert set(sd) == {"encoder.factors_32", "encoder.factors_64",
                       "sigma_net.dense_0", "sigma_net.dense_1",
                       "color_net.dense_0", "color_net.dense_1", "color_net.dense_2"}
    np.testing.assert_array_equal(
        sd["sigma_net.dense_0"].numpy(),
        np.asarray(params["params"]["sigma_net"]["dense_0"]["kernel"]),
    )
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    with torch.no_grad():
        s_t, rgb_t = net(torch.from_numpy(x), torch.from_numpy(d))
        s_f, g_f = make_fused_density(net)(torch.from_numpy(x))
        v_f = make_fused_sigma_rgb(net)(torch.from_numpy(x), torch.from_numpy(d))
    s_j, rgb_j = model.apply(params, jnp.asarray(x), jnp.asarray(d))
    _close(s_t, s_j, 1e-4)
    _close(rgb_t, rgb_j, 1e-4)
    s_jf, g_jf = j_fd(model, params)(jnp.asarray(x))
    _close(s_f, s_jf, 1e-4)
    _close(g_f, g_jf, 1e-4)
    _close(v_f, j_fs(model, params)(jnp.asarray(x), jnp.asarray(d)), 1e-4)
    _, geo_j = model.apply(params, jnp.asarray(x), method=JNet.density)
    _close(g_f, geo_j, 1e-4)


def test_fused_heads_bf16_match_jax():
    from ngp_tpu.models.nerf import make_fused_density as j_fd
    from ngp_tpu_torch.models.nerf import make_fused_density

    model, params, nc, rc = _jax_network(True)
    net = _port_network(params, nc, rc)
    x = np.random.default_rng(12).uniform(-1, 1, size=(64, 3)).astype(np.float32)
    with torch.no_grad():
        s, g = make_fused_density(net)(torch.from_numpy(x))
    s_j, g_j = j_fd(model, params)(jnp.asarray(x))
    assert g.dtype == torch.bfloat16
    _close(s, s_j, 1e-2)
    _close(g.float(), np.asarray(g_j, np.float32), 1e-2)
