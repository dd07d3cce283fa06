"""The port's tolerant checkpoint restore against the JAX package's: a
checkpoint saved without the background net and resumed with
``bg_radius > 0`` (the reference's ``strict=False`` load). Both packages
keep fresh values for the keys the checkpoint lacks, skip the same
modules of the weights, the Adam moments and the EMA, continue the
saved step, and keep the moments of the parameters they restore. Also:
the port's older index-keyed Adam state still loads, and occupancy
payloads that the checkpoint lacks are repacked from its grids.

Tolerances: restored and fresh values are held exactly (a restore copies).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu import config as jconfig
from ngp_tpu.models.nerf import NeRFNetwork as JNeRFNetwork
from ngp_tpu.training.nerf_grid import GridNeRFTrainer as JGridNeRFTrainer
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch.data import synthetic as tsyn
from ngp_tpu_torch.models.nerf import NeRFNetwork as TNeRFNetwork
from ngp_tpu_torch.training import checkpoints as tckpt
from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer as TGridNeRFTrainer
from test_torch_train_step import _TILED_NC, _TURBO_RC

BG = 32.0
STEPS = 3


@pytest.fixture(scope="module")
def frames():
    return tsyn.make_synthetic_frames(n_train=2, n_val=0, n_test=0, H=16, W=16,
                                      device="cpu")["train"]


def _jax_trainer(ws, bg):
    rc = jconfig.RenderConfig(**_TURBO_RC, bg_radius=bg)
    return JGridNeRFTrainer(JNeRFNetwork(cfg=jconfig.NetworkConfig(**_TILED_NC), render=rc), rc,
                            jconfig.TrainConfig(iters=50, num_rays=256, workspace=str(ws)),
                            log_every=10**9, use_tensorboard=False)


def _port_trainer(ws, bg):
    rc = tconfig.RenderConfig(**_TURBO_RC, bg_radius=bg)
    net = TNeRFNetwork(tconfig.NetworkConfig(**_TILED_NC), rc, torch.Generator().manual_seed(0),
                       device="cpu")
    tr = TGridNeRFTrainer(net, rc, tconfig.TrainConfig(iters=50, num_rays=256,
                                                       workspace=str(ws)), log_every=10**9)
    tr.ensure_initialized()
    return tr


def _port_batch(frames):
    return {"images": torch.from_numpy(frames.images), "poses": torch.from_numpy(frames.poses),
            "intrinsics": torch.from_numpy(frames.intrinsics), "idx": 1}


def _jax_skipped(paths):
    """JAX's skipped key paths -> {(part, top-level module)}."""
    out = set()
    for p in paths:
        part = ("ema" if "/ema_params/" in p else "optimizer" if "/opt_state/" in p
                else "model")
        out.add((part, p.rsplit("params/", 1)[1].split("/")[0]))
    return out


def _port_skipped(keys):
    return {(k.split("/")[0], k.split("/", 1)[1].split(".")[0]) for k in keys}


@pytest.fixture(scope="module")
def restored(tmp_path_factory, frames):
    """Both packages: STEPS steps without the background net, a checkpoint,
    then a fresh trainer with it that loads the checkpoint. Returns the
    trainers and copies of the state just before and after the load."""
    ws = tmp_path_factory.mktemp("restore")
    jbatch = {"images": jnp.asarray(frames.images), "poses": jnp.asarray(frames.poses),
              "intrinsics": jnp.asarray(frames.intrinsics), "idx": jnp.int32(1)}
    ja = _jax_trainer(ws / "jax", -1.0)
    ja.ensure_initialized()
    for _ in range(STEPS):
        ja.step(jbatch)
    ja.save_checkpoint()
    jb = _jax_trainer(ws / "jax", BG)
    jb.ensure_initialized()
    j_fresh = jax.tree.map(np.asarray, jb.state.params)
    j_skipped, post_restore = [], jb._post_restore
    jb._post_restore = lambda skipped: (j_skipped.extend(skipped), post_restore(skipped))
    assert jb.load_checkpoint()

    ta = _port_trainer(ws / "port", -1.0)
    for _ in range(STEPS):
        ta.step(_port_batch(frames))
    ta.save_checkpoint()
    tb = _port_trainer(ws / "port", BG)
    t_fresh = {k: p.detach().clone() for k, p in tb.model.named_parameters()}
    assert tb.load_checkpoint()
    return dict(
        ja=ja, jb=jb, ta=ta, tb=tb, jbatch=jbatch, frames=frames, j_skipped=j_skipped,
        j_fresh=j_fresh["params"],
        j_saved=jax.tree.map(np.asarray, ja.state.params)["params"],
        j_loaded=jax.tree.map(np.asarray, jb.state.params)["params"],
        j_saved_opt=jax.tree.map(np.asarray, ja.state.opt_state[0]),
        j_loaded_opt=jax.tree.map(np.asarray, jb.state.opt_state[0]),
        t_fresh=t_fresh,
        t_saved={k: p.detach().clone() for k, p in ta.model.named_parameters()},
        t_loaded={k: p.detach().clone() for k, p in tb.model.named_parameters()},
        t_saved_opt={k: {s: v.clone() for s, v in ta.optimizer.state[p].items()}
                     for k, p in ta.model.named_parameters()},
        t_loaded_opt={k: {s: v.clone() for s, v in tb.optimizer.state[p].items()}
                      for k, p in tb.model.named_parameters()},
    )


def test_skipped_keys_match_jax(restored):
    want = _jax_skipped(restored["j_skipped"])
    assert want == {(part, mod) for part in ("model", "optimizer", "ema")
                    for mod in ("encoder_bg", "bg_net")}
    assert _port_skipped(restored["tb"].last_restore_skipped) == want


def test_skipped_values_are_fresh_and_restored_values_saved(restored):
    saved, fresh = restored["t_saved"], restored["t_fresh"]
    ta, tb = restored["ta"], restored["tb"]
    assert any(k.startswith(("encoder_bg", "bg_net")) for k in restored["t_loaded"])
    for k, p in restored["t_loaded"].items():
        assert torch.equal(p, saved[k] if k in saved else fresh[k]), k
        shadow = ta.ema.shadow[k] if k in saved else fresh[k]
        assert torch.equal(tb.ema.shadow[k], shadow), k
    # the JAX side does the same
    for mod, got in restored["j_loaded"].items():
        want = restored["j_saved"].get(mod, restored["j_fresh"][mod])
        jax.tree.map(np.testing.assert_array_equal, got, want)


def test_adam_moments_of_kept_parameters_survive(restored):
    """Kept parameters keep their moments and step count; the added ones
    start from zero moments at the restored count, as under JAX's one
    count; JAX keeps the kept modules' moments too."""
    saved = restored["t_saved_opt"]
    for k, st in restored["t_loaded_opt"].items():
        assert float(st["step"]) == STEPS, k
        if k in saved:
            assert float(saved[k]["exp_avg_sq"].abs().max()) > 0, k
            for s in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(st[s], saved[k][s]), (k, s)
        else:
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any(), k
    jl, js = restored["j_loaded_opt"], restored["j_saved_opt"]
    assert int(jl.count) == STEPS
    for moments in ("mu", "nu"):
        for mod, got in getattr(jl, moments)["params"].items():
            want = getattr(js, moments)["params"].get(mod)
            if want is None:
                jax.tree.map(lambda a: np.testing.assert_array_equal(a, 0 * a), got)
            else:
                jax.tree.map(np.testing.assert_array_equal, got, want)


def test_global_step_continues(restored):
    ja, jb, ta, tb = restored["ja"], restored["jb"], restored["ta"], restored["tb"]
    assert jb.global_step == ja.global_step == STEPS
    assert tb.global_step == ta.global_step == STEPS
    assert tb.epoch == ta.epoch
    assert tb.scheduler.last_epoch == STEPS
    assert tb.optimizer.param_groups[0]["lr"] == ta.optimizer.param_groups[0]["lr"]
    metrics = tb.step(_port_batch(restored["frames"]))
    assert tb.global_step == STEPS + 1 and np.isfinite(float(metrics["loss"]))
    assert all(float(st["step"]) == STEPS + 1 for st in tb.optimizer.state.values())
    jb.step(restored["jbatch"])
    assert jb.global_step == STEPS + 1


def test_index_keyed_optimizer_state_still_loads(tmp_path, frames):
    """A checkpoint whose Adam state is torch's own index-keyed state dict
    (the port's earlier format) restores every moment."""
    ta = _port_trainer(tmp_path, -1.0)
    for _ in range(2):
        ta.step(_port_batch(frames))
    path = ta.save_checkpoint()
    sd = tckpt.load_checkpoint(path)
    sd["optimizer"] = ta.optimizer.state_dict()
    del sd["meta"]
    torch.save(sd, path)
    tb = _port_trainer(tmp_path, -1.0)
    assert tb.load_checkpoint(path) and tb.last_restore_skipped == []
    for pa, pb in zip(ta.model.parameters(), tb.model.parameters()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(tb.optimizer.state[pb][key], ta.optimizer.state[pa][key])
    assert tb.optimizer.param_groups[0]["lr"] == ta.optimizer.param_groups[0]["lr"]


@pytest.mark.parametrize("drop", ["prepass_payload", "coarse_payload"])
def test_missing_payload_is_repacked(tmp_path, frames, drop):
    """A checkpoint without one of the march's payloads (or with a
    reshaped one) restores the grids and repacks every payload from them,
    as JAX's ``_post_restore`` does."""
    ta = _port_trainer(tmp_path, -1.0)
    for _ in range(2):
        ta.step(_port_batch(frames))
    path = ta.save_checkpoint()
    sd = tckpt.load_checkpoint(path)
    del sd["aux"]["occ"][drop]
    sd["aux"]["occ"]["fine_payload"] = sd["aux"]["occ"]["fine_payload"][:, :2]
    torch.save(sd, path)
    tb = _port_trainer(tmp_path, -1.0)
    assert tb.load_checkpoint(path)
    assert set(tb.last_restore_skipped) == {f"aux/occ/{drop}", "aux/occ/fine_payload"}
    occ_a, occ_b = ta.aux["occ"], tb.aux["occ"]
    for f in dataclasses.fields(occ_a):
        a, b = getattr(occ_a, f.name), getattr(occ_b, f.name)
        assert (a == b) if f.name == "iter_density" else torch.equal(a, b), f.name
