"""LPIPS (``ngp_tpu_torch/training/lpips.py`` and ``LPIPSMeter``) against
the JAX package: the distance on JAX's random weights, the weights'
shapes, the two checkpoint layouts ``load_torch_weights`` reads, the
meter, and ``evaluate`` with LPIPS on the non-grid trainer.

Nothing is downloaded: the checkpoints are written here from random
weights. Tolerances. The distance: 1e-5 relative (f32 convolutions and
sums in another order). The loaders: equal, bit for bit. The meter: the
mean to 1e-5 relative. ``evaluate``: the port's LPIPS equal to its meter
on the frames it rendered, and within 2e-3 of JAX's (the two renders'
u8 frames may differ by one level in a pixel).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.training import lpips as jl
from ngp_tpu.training import metrics as jm
from ngp_tpu_torch.data import synthetic as tsyn
from ngp_tpu_torch.training import lpips as tl
from ngp_tpu_torch.training import metrics as tm
from test_torch_renderer import HASH_NC, RC, _pair, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, jl.random_params(jax.random.PRNGKey(0)))


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    y = np.clip(x + 0.15 * rng.normal(size=shape), 0.0, 1.0).astype(np.float32)
    return x, y


def test_lpips_matches_jax(params):
    x, y = _images((2, 64, 64, 3), seed=1)
    want = np.asarray(jl.lpips(params, jnp.asarray(x), jnp.asarray(y)))
    got = tl.lpips(params, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert want.min() > 0.0
    same = tl.lpips(params, torch.from_numpy(x), torch.from_numpy(x))
    assert float(same.abs().max()) == 0.0
    with pytest.raises(ValueError, match="31 x 31"):
        tl.lpips(params, torch.from_numpy(x[:, :30]), torch.from_numpy(y[:, :30]))


def test_random_params_have_jax_shapes(params):
    got = tl.random_params(torch.Generator().manual_seed(0))
    assert set(got) == set(params)
    for k, v in params.items():
        assert got[k].shape == v.shape and got[k].dtype == np.float32, k
    again = tl.random_params(torch.Generator().manual_seed(0))
    assert all(np.array_equal(got[k], again[k]) for k in got)


def _checkpoint(params, layout):
    """The params as a torch state dict in the ``lpips`` package's layout or
    torchvision's AlexNet features beside the linear heads."""
    tv_idx = (0, 3, 6, 8, 10)
    sd = {}
    for i in range(5):
        w = torch.tensor(np.transpose(params[f"conv{i}_w"],
                                      (3, 2, 0, 1)))
        b = torch.tensor(params[f"conv{i}_b"] + 0.01 * i)
        lin = torch.tensor(params[f"lin{i}_w"]).reshape(1, -1, 1, 1)
        if layout == "lpips":
            sd[f"net.slice{i + 1}.{tv_idx[i]}.weight"] = w
            sd[f"net.slice{i + 1}.{tv_idx[i]}.bias"] = b
            sd[f"lin{i}.model.1.weight"] = lin
        else:
            sd[f"features.{tv_idx[i]}.weight"] = w
            sd[f"features.{tv_idx[i]}.bias"] = b
            sd[f"lins.{i}.weight"] = lin
    return sd


@pytest.mark.parametrize("layout", ["lpips", "torchvision"])
def test_load_torch_weights_matches_jax(tmp_path, params, layout):
    path = str(tmp_path / f"{layout}.pth")
    torch.save(_checkpoint(params, layout), path)
    want = jl.load_torch_weights(path)
    got = tl.load_torch_weights(path)
    assert set(got) == set(want) == set(params)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["conv0_w"], params["conv0_w"])
    with pytest.raises(KeyError):
        torch.save({"other": torch.zeros(3)}, path)
        tl.load_torch_weights(path)


def test_lpips_meter_matches_jax(tmp_path, params):
    path = str(tmp_path / "w.pth")
    torch.save(_checkpoint(params, "lpips"), path)
    a, b = _images((3, 40, 36, 3), seed=2)
    tmeter = tm.LPIPSMeter(weights_path=path, device="cpu")
    jmeter = jm.LPIPSMeter(weights_path=path)
    for i in range(2):  # one frame [H, W, C] at a time, then a batch
        tmeter.update(a[i], b[i])
        jmeter.update(a[i], b[i])
    tmeter.update(a, b)
    jmeter.update(a, b)
    assert tmeter.N == jmeter.N == 5
    assert tmeter.measure() == pytest.approx(jmeter.measure(), rel=1e-5)
    assert tmeter.name() == jmeter.name() == "LPIPS (alex)"
    assert tmeter.report().startswith("LPIPS (alex) = ")
    by_params = tm.LPIPSMeter(params=tl.load_torch_weights(path), device="cpu")
    by_params.update(a, b)
    assert by_params.measure() == pytest.approx(float(np.mean(
        [tl.lpips(by_params._params, torch.from_numpy(a[i:i + 1]),
                  torch.from_numpy(b[i:i + 1])) for i in range(3)])), rel=1e-6)
    with pytest.raises(RuntimeError, match="weights"):
        tm.LPIPSMeter(device="cpu").update(a[0], b[0])
    with pytest.raises(ValueError):
        tm.LPIPSMeter(net="vgg")


def test_evaluate_with_lpips_matches_jax(tmp_path, params):
    """``evaluate`` reports LPIPS when ``lpips_weights`` is set (a path, as
    ``--lpips_weights`` sets it, or converted params) or when asked."""
    jtr, ttr = _pair(tmp_path, dict(RC, upsample_steps=4), HASH_NC)
    val = tsyn.make_synthetic_frames(n_train=0, n_val=2, n_test=0, H=32, W=32,
                                     device="cpu")["val"]
    path = str(tmp_path / "w.pth")
    torch.save(_checkpoint(params, "torchvision"), path)
    assert "lpips" not in ttr.evaluate(val)
    ttr.lpips_weights = jtr.lpips_weights = path
    got = ttr.evaluate(val)
    want = jtr.evaluate(val)
    assert set(got) == set(want) == {"psnr", "lpips"}
    assert abs(got["psnr"] - want["psnr"]) <= 0.01
    assert got["lpips"] == pytest.approx(want["lpips"], rel=2e-3)
    # the meter on the frames evaluate rendered
    meter = tm.LPIPSMeter(weights_path=path, device="cpu")
    for i in range(2):
        img, _ = ttr.render_frame(val.poses[i], val.intrinsics, val.H, val.W)
        gt = val.images[i]
        meter.update(img, gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:]))
    assert got["lpips"] == pytest.approx(meter.measure(), rel=1e-6)
    ttr.lpips_weights = tl.load_torch_weights(path)
    assert ttr.evaluate(val)["lpips"] == pytest.approx(got["lpips"], rel=1e-6)
    assert "lpips" not in ttr.evaluate(val, with_lpips=False)
    assert os.path.exists(os.path.join(ttr.workspace, "validation"))
