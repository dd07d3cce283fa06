"""The port's parallelism (``ngp_tpu_torch/parallel/`` and the trainers'
mesh branches) against the JAX package's one-device programs and its
own, mirroring ``tests/test_parallel.py`` and ``__graft_entry__.py:
_dryrun_multichip_inner``.

The port's ranks are processes on gloo (``parallel_workers.spawn``: 8
ranks, one torch thread each, no JAX; they take the JAX side's numpy
draws and weights); the JAX side runs here on conftest's 8 virtual CPU
devices. Two spawns serve every case: an 8-rank ``("data",)`` mesh and
a ``(4, 2)`` ``("data", "model")`` mesh.

Tolerances. A step: the loss to 1e-5 relative and the parameters after
Adam to rtol 2e-4 / atol 2e-6 (``test_parallel.py:83-89``), Adam's
moments (which carry the gradients' scale, where Adam's first update does
not) likewise after scaling each by its largest entry; the rank
split's loss to 1e-4 relative of JAX's (``:151``), its banks, Adam
moments and EMA gathered whole to the one-device update at the step's
tolerance. Frames: the one-device frame's u8 pixels, and JAX's within
one level (f32 sums in another order). The 17-step window: each loss
within 1e-4 + 5e-3 |ref| of one device's, across two grid refreshes
(``_dryrun_multichip_inner``); the grids bit-equal across ranks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_workers as pw
from ngp_tpu.config import NetworkConfig as JNetworkConfig
from ngp_tpu.config import RenderConfig as JRenderConfig
from ngp_tpu.config import TrainConfig as JTrainConfig
from ngp_tpu.models.nerf import NeRFNetwork as JNeRFNetwork
from ngp_tpu.parallel import eval_metrics_dp as jeval_metrics_dp
from ngp_tpu.parallel import gather_predictions_dp as jgather_predictions_dp
from ngp_tpu.parallel import make_mesh as jmake_mesh
from ngp_tpu.parallel.mesh import tp_param_specs as jtp_param_specs
from ngp_tpu.training.nerf_grid import GridNeRFTrainer as JGridNeRFTrainer
from ngp_tpu_torch.models.nerf import params_from_jax

H = W = 16
N_RAYS = 64
# test_parallel.py:26-41, the hash grid on the v1 march
HASH_RC = dict(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=32, max_samples_per_ray=16,
               grid_size=16)
HASH_NC = dict(num_levels=4, level_dim=2, log2_hashmap_size=12, use_bf16=False)
# test_parallel.py:137-147, the CP grid on the turbo march: 16 samples a ray
# against a budget of 8, so the budget binds on the fresh, fully occupied grid
TURBO_RC = dict(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=32, max_samples_per_ray=16,
                grid_size=16, turbo=True, coarse_candidates=32, crossing_slots=16,
                compact_mean_samples=8)
CP_NC = dict(encoding="cpgrid", use_bf16=False, cp_resolutions=(32, 64), cp_rank=8,
             cp_freq_degree=4)
WINDOW = 17  # update_extra_interval + 1: refreshes at steps 0 and 16
# rays a chunk of the frames: more chunks than data ranks, so a rank renders
# several and the last round leaves some ranks without one
FRAME_CHUNK = 16
# D-NeRF (test_torch_dnerf.py's small widths) on the turbo march, whose
# budget binds on the fresh grid: the deformation L1 is a mean over the
# whole batch's valid samples
DNERF_NC = dict(num_levels=4, log2_hashmap_size=12, base_resolution=8, hidden_dim=32,
                hidden_dim_color=32, use_bf16=False)
DNERF_RC = dict(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=64, max_samples_per_ray=16,
                grid_size=16, density_thresh=10.0, turbo=True, coarse_candidates=48,
                crossing_slots=16, compact_mean_samples=8, time_size=4)


def _frames():
    """test_parallel.py:_tiny_batch as numpy (two random RGBA frames)."""
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(2, H, W, 4)).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[:, :3, 3] = [0, 0, -2.0]
    return {"images": images, "poses": poses,
            "intrinsics": np.array([20.0, 20.0, W / 2, H / 2], np.float32), "idx": 0}


def _pose():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0, 0, -2.0]
    return pose, np.array([20.0, 20.0, 8.0, 8.0], np.float32)


def _jax_step(rc, nc, workspace, key=7):
    """JAX's one-device step (jit, Adam) on its fresh trainer, and the
    port's inputs: its weights and grid as numpy, and its draws."""
    jrc = JRenderConfig(**rc)
    jtr = JGridNeRFTrainer(JNeRFNetwork(cfg=JNetworkConfig(**nc), render=jrc), jrc,
                           JTrainConfig(iters=100, num_rays=N_RAYS, workspace=str(workspace)),
                           log_every=10**9, use_tensorboard=False)
    jtr.ensure_initialized()
    fr = _frames()
    params = {k: v.numpy() for k, v in
              params_from_jax(jax.tree.map(np.asarray, jtr.state.params)).items()}
    occ = pw.occ_fields(jtr.aux["occ"])
    batch = {"images": jnp.asarray(fr["images"]), "poses": jnp.asarray(fr["poses"]),
             "intrinsics": jnp.asarray(fr["intrinsics"]), "idx": jnp.int32(fr["idx"])}
    rng = jax.random.PRNGKey(key)
    state, _, met = jax.jit(jtr.train_step)(jtr.state, jtr.aux, batch, rng)
    k_pix, k_bg, k_render = jax.random.split(rng, 3)
    draws = {"inds": np.asarray(jax.random.randint(k_pix, (N_RAYS,), 0, H * W)),
             "bg": np.asarray(jax.random.uniform(k_bg, (N_RAYS, 3))),
             "noise": np.asarray(jax.random.uniform(k_render, (N_RAYS,)))}
    setup = dict(rc=rc, nc=nc, tc=dict(iters=100, num_rays=N_RAYS, workspace=str(workspace)),
                 params=params, occ=occ, rounding=nc.get("encoding") != "cpgrid")
    want = {"loss": float(met["loss"]),
            "params": {k: v.numpy() for k, v in
                       params_from_jax(jax.tree.map(np.asarray, state.params)).items()}}
    if "turbo_overflow" in met:
        want["turbo_overflow"] = float(met["turbo_overflow"])
    return jtr, setup, draws, want


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The 8-rank ("data",) mesh: (a) the hash-grid step, (b) the turbo
    step with the budget binding, (c) a hash-grid frame, a D-NeRF step,
    (d) the two collectives; and the one-device runs of (a)-(c) and
    D-NeRF's."""
    ws = tmp_path_factory.mktemp("dp")
    jhash, hash_setup, hash_draws, hash_want = _jax_step(HASH_RC, HASH_NC, ws)
    _, turbo_setup, turbo_draws, turbo_want = _jax_step(TURBO_RC, CP_NC, ws, key=3)
    pose, intr = _pose()
    jframe, _ = jhash.render_frame(pose, intr, H, W, chunk=FRAME_CHUNK)
    rng = np.random.default_rng(3)
    pred = rng.uniform(size=(64, 3)).astype(np.float32)
    gt = rng.uniform(size=(64, 3)).astype(np.float32)
    frame_setup = dict(hash_setup, rounding=False)
    dnerf = dict(setup=dict(rc=DNERF_RC, nc=DNERF_NC, family="dnerf",
                            tc=dict(iters=100, num_rays=N_RAYS, workspace=str(ws))),
                 frames=dict(_frames(), idx=1, times=np.array([0.0, 0.6], np.float32)),
                 draws=turbo_draws)
    cases = [("step", dict(setup=hash_setup, frames=_frames(), draws=hash_draws)),
             ("step", dict(setup=turbo_setup, frames=_frames(), draws=turbo_draws)),
             ("frame", dict(setup=frame_setup, pose=pose, intr=intr, H=H, W=W, chunk=FRAME_CHUNK)),
             ("step", dnerf),
             ("collectives", dict(pred=pred, gt=gt))]
    ranks = pw.spawn(cases, world=8)
    one = pw.one_device(cases[:4])
    return {"ranks": ranks, "one": one, "want": [hash_want, turbo_want, np.asarray(jframe)],
            "pred": pred, "gt": gt}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The (4, 2) ("data", "model") mesh: (e) the rank-split step, (c) a
    turbo frame after two refreshes, (f) the 17-step window, (g) a
    checkpoint; and their one-device runs."""
    ws = tmp_path_factory.mktemp("tp")
    _, setup, draws, want = _jax_step(TURBO_RC, CP_NC, ws, key=0)
    pose, intr = _pose()
    seeded = dict(rc=TURBO_RC, nc=CP_NC,
                  tc=dict(iters=100, num_rays=N_RAYS, workspace=str(ws), update_extra_interval=16))

    def cases(tag):
        return [("step", dict(setup=setup, frames=_frames(), draws=draws)),
                ("frame", dict(setup=seeded, pose=pose, intr=intr, H=H, W=W, chunk=FRAME_CHUNK,
                               refreshes=2)),
                ("window", dict(setup=seeded, frames=_frames(), steps=WINDOW)),
                ("checkpoint", dict(setup=setup, frames=_frames(), draws=draws,
                                    workspace=str(ws / tag))),
                ("placement", dict(setup=seeded))]

    ranks = pw.spawn(cases("mesh"), world=8, model_parallel=2)
    one = pw.one_device(cases("one")[:4])
    return {"ranks": ranks, "one": one, "want": want, "params": setup["params"]}


def _params_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-6, err_msg=k)


def _moments_close(got, want):
    """Adam's moments, each to the step's tolerance scaled by its largest
    entry (their entries are ~1e-7 and ~1e-14: a plain atol would hold
    nothing), and so the gradients that made them."""
    for key in ("exp_avg", "exp_avg_sq"):
        assert set(got[key]) == set(want[key]) and want[key]
        for k, w in want[key].items():
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(got[key][k] / scale, w / scale, rtol=2e-4, atol=2e-6,
                                       err_msg=f"{key} {k}")


def _replicated(ranks, case):
    """Every rank holds the same parameters after the step."""
    for r in ranks[1:]:
        for k, v in ranks[0][case]["params"].items():
            np.testing.assert_array_equal(r[case]["params"][k], v, err_msg=k)


def test_dp_step_hash_grid_matches_one_device(dp_runs):
    """(a) The 8-rank step of the hash grid (v1 march) equals JAX's
    one-device step and the port's (``test_parallel.py:66``)."""
    got, one, want = dp_runs["ranks"][0][0], dp_runs["one"][0], dp_runs["want"][0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    _params_close(got["params"], want["params"])
    _params_close(got["params"], one["params"])
    _moments_close(got, one)
    _replicated(dp_runs["ranks"], 0)
    assert got["budgets"] == []  # the v1 march has no budget


def test_dp_step_turbo_budget_binds_matches_one_device(dp_runs):
    """(b) The 8-rank turbo step where the training budget binds: the
    batch's ray-major tail is dropped across the ranks (each rank's
    budget is what the ranks before it left), as one device drops it."""
    ranks = dp_runs["ranks"]
    got, one, want = ranks[0][1], dp_runs["one"][1], dp_runs["want"][1]
    assert want["turbo_overflow"] > 0 and got["turbo_overflow"] > 0  # n_dropped > 0
    np.testing.assert_allclose(got["turbo_overflow"], want["turbo_overflow"], rtol=1e-6)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    _params_close(got["params"], want["params"])
    _params_close(got["params"], one["params"])
    _moments_close(got, one)
    _replicated(ranks, 1)
    budgets = [r[1]["budgets"][0] for r in ranks]
    whole = N_RAYS * TURBO_RC["compact_mean_samples"]
    assert all(b == whole for _, b, _ in budgets)
    left = whole
    for n_valid, _, share in budgets:
        assert share == max(left, 0)
        left -= n_valid
    assert left < 0 and budgets[-1][2] < budgets[-1][0]  # it binds: the last rank is cut


def test_dp_step_dnerf_matches_one_device(dp_runs):
    """The D-NeRF step inherits the mesh branch: at 8 data ranks, with the
    budget binding, the loss (the deformation L1 over the whole batch's
    valid samples included) and the update are one device's."""
    ranks, one = dp_runs["ranks"], dp_runs["one"][3]
    got = ranks[0][3]
    assert got["turbo_overflow"] > 0
    assert any(share < n_valid for r in ranks for n_valid, _, share in r[3]["budgets"])
    np.testing.assert_allclose(got["turbo_overflow"], one["turbo_overflow"], rtol=1e-6)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    _params_close(got["params"], one["params"])
    _moments_close(got, one)
    _replicated(ranks, 3)


@pytest.mark.parametrize("mesh", ["data8", "data4_model2"])
def test_frame_under_mesh_equals_one_device(dp_runs, tp_runs, mesh):
    """(c) ``render_frame`` under the mesh (whole chunks dealt to the data
    ranks, then gathered) is the one-device frame (``test_parallel.py:92``):
    the hash grid on the v1 march, also against JAX's frame; the turbo
    march with its prepass and water-filled budget on the split banks."""
    runs = dp_runs if mesh == "data8" else tp_runs
    idx = 2 if mesh == "data8" else 1
    one = runs["one"][idx]
    for r in runs["ranks"]:
        got = r[idx]
        assert got["image"].shape == (H, W, 3) and np.isfinite(got["image"]).all()
        np.testing.assert_array_equal(got["image"], one["image"])
        np.testing.assert_array_equal(got["depth"], one["depth"])
        assert got["stats"] == one["stats"] and got["stats"]["n_samples"] > 0
    if mesh == "data8":
        assert np.abs(runs["ranks"][0][idx]["image"] - runs["want"][2]).max() <= 1 / 255 + 1e-6
    else:
        assert runs["one"][idx]["stats"]["n_dropped"] > 0  # the eval budget binds


def test_eval_metrics_dp_matches_numpy_and_jax(dp_runs):
    """(d) ``eval_metrics_dp`` over 8 data ranks of 8 rows each, against
    numpy and JAX's on its 8-device mesh (``test_parallel.py:108``)."""
    pred, gt = dp_runs["pred"], dp_runs["gt"]
    mse = np.mean((pred - gt) ** 2)
    jout = jeval_metrics_dp(jmake_mesh(8), jnp.asarray(pred), jnp.asarray(gt))
    for r in dp_runs["ranks"]:
        got = r[4]
        assert got["rows"] == 8
        np.testing.assert_allclose(got["mse"], mse, rtol=1e-6)
        np.testing.assert_allclose(got["psnr"], -10.0 * np.log10(mse), rtol=1e-5)
        np.testing.assert_allclose(got["mse"], float(jout["mse"]), rtol=1e-6)
        np.testing.assert_allclose(got["psnr"], float(jout["psnr"]), rtol=1e-6)


def test_gather_predictions_dp_matches_numpy_and_jax(dp_runs):
    """(d) ``gather_predictions_dp``: the ranks' rows back in order, on
    every rank (``test_parallel.py:122``)."""
    pred = dp_runs["pred"]
    jout = np.asarray(jgather_predictions_dp(jmake_mesh(8), jnp.asarray(pred)))
    np.testing.assert_array_equal(jout, pred)
    for r in dp_runs["ranks"]:
        np.testing.assert_array_equal(r[4]["gathered"], pred)


def test_rank_split_step_keeps_the_banks_split(tp_runs):
    """(e) The (4, 2) step with the CP banks split over "model"
    (``test_parallel.py:130``): the loss is JAX's one-device loss; after
    the step each bank, its Adam moments and its EMA shadow are still
    [3, res, R / 2] on every rank, and gathered whole they are the
    one-device update; the replicated parameters are equal on every rank."""
    ranks, one, want = tp_runs["ranks"], tp_runs["one"][0], tp_runs["want"]
    got = ranks[0][0]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    R = CP_NC["cp_rank"]
    banks = [f"encoder.factors_{r}" for r in CP_NC["cp_resolutions"]]
    for r in ranks:
        shapes = r[0]["local_shapes"]
        for b, res in zip(banks, CP_NC["cp_resolutions"]):
            assert shapes[b] == [(3, res, R // 2)] * 4, b  # param, EMA, both moments
        assert shapes["sigma_net.dense_0"][0] == tuple(one["params"]["sigma_net.dense_0"].shape)
    for key in ("params", "ema"):
        _params_close(got[key], one[key])
    _moments_close(got, one)
    _params_close(got["params"], want["params"])
    for r in ranks[1:]:
        for key in ("params", "exp_avg", "exp_avg_sq", "ema"):
            for k, v in got[key].items():
                np.testing.assert_array_equal(r[0][key][k], v, err_msg=f"{key} {k}")


def test_tp_param_specs_split_the_banks_as_jax(tp_runs):
    """The port splits exactly the parameters JAX's ``tp_param_specs``
    shards over "model" (the CP banks, on their last axis)."""
    jrc = JRenderConfig(**TURBO_RC)
    jtr = JGridNeRFTrainer(JNeRFNetwork(cfg=JNetworkConfig(**CP_NC), render=jrc), jrc,
                           JTrainConfig(iters=100, num_rays=N_RAYS), log_every=10**9,
                           use_tensorboard=False)
    jtr.ensure_initialized()
    jspecs = jtp_param_specs(jtr.state.params, jmake_mesh(8, model_parallel=2))
    flat = jax.tree_util.tree_leaves_with_path(jspecs)
    jsplit = {"/".join(str(getattr(q, "key", q)) for q in path) for path, s in flat
              if not s.is_fully_replicated}
    jsplit = {p.split("/", 1)[1].replace("/", ".") for p in jsplit}
    shapes = tp_runs["ranks"][0][0]["local_shapes"]
    split = {k for k, v in shapes.items() if v[0] != tuple(tp_runs["params"][k].shape)}
    assert split == jsplit == {f"encoder.factors_{r}" for r in CP_NC["cp_resolutions"]}


def test_rank_split_window_in_lockstep(tp_runs):
    """(f) 17 trainer steps at (4, 2) from the seeded generator, with the
    grid refreshed at steps 0 and 16: each loss within 1e-4 + 5e-3 |ref| of
    the one-device run's, and the grids bit-equal across the ranks after
    every step (``_dryrun_multichip_inner``)."""
    ranks, one = tp_runs["ranks"], tp_runs["one"][2]
    got = ranks[0][2]
    assert len(got["losses"]) == WINDOW
    for i, (a, b) in enumerate(zip(got["losses"], one["losses"])):
        assert abs(a - b) <= 1e-4 + 5e-3 * abs(b), (i, a, b)
    assert [g["iter"] for g in got["grids"]] == [1] * 16 + [2]
    for r in ranks[1:]:
        for g, g0 in zip(r[2]["grids"], got["grids"]):
            np.testing.assert_array_equal(g["density_grid"], g0["density_grid"])
            np.testing.assert_array_equal(g["occ_grid"], g0["occ_grid"])
    for r in ranks:
        assert r[2]["losses"] == got["losses"]


def test_checkpoint_under_mesh(tp_runs):
    """(g) A checkpoint written under the (4, 2) mesh holds the whole
    banks, Adam moments and EMA shadows: it equals the one-device
    checkpoint of the same step; restored into a fresh split trainer it
    gives back every rank's shards exactly."""
    ranks, one = tp_runs["ranks"], tp_runs["one"][3]
    mesh_ck = torch.load(ranks[0][3]["path"], weights_only=True)
    one_ck = torch.load(one["path"], weights_only=True)
    assert mesh_ck["global_step"] == one_ck["global_step"]
    assert set(mesh_ck["model"]) == set(one_ck["model"])
    for sec in ("model", "ema"):
        for k, v in one_ck[sec].items():
            assert mesh_ck[sec][k].shape == v.shape, (sec, k)
            np.testing.assert_allclose(mesh_ck[sec][k].numpy(), v.numpy(), rtol=2e-4,
                                       atol=2e-6, err_msg=f"{sec} {k}")
    _moments_close({kk: {k: st[kk].numpy() for k, st in mesh_ck["optimizer"]["state"].items()}
                    for kk in ("exp_avg", "exp_avg_sq")},
                   {kk: {k: st[kk].numpy() for k, st in one_ck["optimizer"]["state"].items()}
                    for kk in ("exp_avg", "exp_avg_sq")})
    for r in ranks:
        assert r[3]["path"] == ranks[0][3]["path"] and r[3]["skipped"] == []
        assert all(r[3]["restored_equal"].values()), r[3]["restored_equal"]


def test_shard_unshard_and_replicate(tp_runs):
    """``shard_params`` splits the banks, ``unshard_params`` gives them back
    whole, bit for bit, on every rank, and ``replicate_sharding`` hands
    every rank rank 0's tensors (other leaves kept)."""
    banks = {f"encoder.factors_{r}" for r in CP_NC["cp_resolutions"]}
    for r in tp_runs["ranks"]:
        got = r[4]
        assert got["split"] == got["names"] == got["back"] == banks
        for b, res in zip(sorted(banks), sorted(CP_NC["cp_resolutions"])):
            assert got["shapes"][b] == (3, res, CP_NC["cp_rank"] // 2)
        assert got["restored"] and not got["gather_left"]
        assert got["replicated"] == [[0.0] * 3, [0.0] * 3, 7]


def test_make_mesh_takes_no_fallback(tmp_path):
    """``make_mesh`` on a process group of one rank: the CPU mesh only when
    asked for, no CUDA mesh without a card (nothing falls back to gloo or
    the CPU), no more devices than ranks, and the model axis only for
    ``model_parallel > 1``."""
    import torch.distributed as dist

    from ngp_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, device_type="cpu")
        assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
        assert make_mesh(model_parallel=1, device_type="cpu").mesh_dim_names == ("data",)
        with pytest.raises(ValueError):
            make_mesh(2, device_type="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                make_mesh(1)
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, device_type="cpu")


def test_occ_fields_round_trip():
    """The JAX occupancy state reaches the ranks field for field."""
    from ngp_tpu.models.occupancy import init_occupancy

    from ngp_tpu_torch.models.occupancy import occupancy_from_jax

    occ = init_occupancy(JRenderConfig(**TURBO_RC))
    port = occupancy_from_jax(pw.occ_fields(occ), device="cpu")
    for f in dataclasses.fields(occ):
        np.testing.assert_array_equal(np.asarray(getattr(port, f.name)),
                                      np.asarray(getattr(occ, f.name)))
