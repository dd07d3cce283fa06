"""The port's viewers against the JAX package's: ``OrbitCamera`` (pose,
intrinsics, orbit, scale, pan), ``InteractiveSession`` on a port trainer
(train calls, SPP accumulation and downscale, the widget requests, the
aabb crop), the HTTP endpoints of ``viewer_web.make_server`` and the
loop of ``serve``, ``test_gui`` / ``train_gui`` against JAX's on the
same weights and draws, each command line's ``--gui`` reaching ``serve``
with an ``InteractiveSession``, the tensorboard writer, and the debug
plots of ``utils/vis.py``.

Tolerances. The camera: equal, bit for bit (the same numpy code).
``test_gui``: the u8 frames at most one level apart in at most 0.5% of
the pixels, as ``test_torch_render_frame.py`` holds ``render_frame``.
``train_gui``: the loss to 1e-5 relative and every gradient to 1e-4 of
its largest entry, as ``test_torch_train_step.py`` holds a step.
"""

import functools
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from ngp_tpu import viewer as jviewer
from ngp_tpu.data import synthetic as jsyn
from ngp_tpu.data.nerf_dataset import NeRFDataset as JNeRFDataset
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch import viewer as tviewer
from ngp_tpu_torch import viewer_web as tweb
from ngp_tpu_torch.data import synthetic as tsyn
from ngp_tpu_torch.data.nerf_dataset import NeRFDataset
from ngp_tpu_torch.models.nerf import NeRFNetwork
from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer
from test_torch_render_frame import INTR, H, W, _pair, _poses
from test_torch_renderer import one_torch_thread  # noqa: F401
from test_torch_train_step import _CP_NC, _TURBO_RC, _check_step, _np, _trainer_pair

SIZE = 24


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A small static scene the port writes, RGBA."""
    root = str(tmp_path_factory.mktemp("viewer_scene") / "scene")
    return tsyn.make_synthetic_dataset(root, n_train=3, n_val=1, n_test=1, H=SIZE, W=SIZE,
                                       num_steps=64, device="cpu")


def _port_trainer(ws, num_rays=256):
    """A small hash-grid trainer of the port on the v1 march (the JAX
    viewer tests' configuration)."""
    rc = tconfig.RenderConfig(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=64,
                              max_samples_per_ray=16, grid_size=16, density_thresh=10.0)
    nc = tconfig.NetworkConfig(num_levels=4, log2_hashmap_size=12, use_bf16=False)
    model = NeRFNetwork(nc, rc, torch.Generator().manual_seed(0), device="cpu")
    return GridNeRFTrainer(model, rc, tconfig.TrainConfig(iters=100, num_rays=num_rays,
                                                          workspace=str(ws)))


# ---------------------------------------------------------------------------
# the camera
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moves", [
    [],
    [("orbit", (40, -25))],
    [("scale", (1,)), ("scale", (-3,))],
    [("pan", (5, -3)), ("pan", (1, 2, 7))],
    [("orbit", (40, -25)), ("scale", (1,)), ("pan", (5, -3)), ("orbit", (-300, 90))],
], ids=["start", "orbit", "scale", "pan", "all"])
def test_orbit_camera_matches_jax(moves):
    a = jviewer.OrbitCamera(64, 48, r=2.0, fovy=50)
    b = tviewer.OrbitCamera(64, 48, r=2.0, fovy=50)
    for op, args in moves:
        getattr(a, op)(*args)
        getattr(b, op)(*args)
    np.testing.assert_array_equal(b.pose, a.pose)
    np.testing.assert_array_equal(b.intrinsics, a.intrinsics)
    R = b.pose[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    np.testing.assert_array_equal(tviewer._axis_angle(np.array([0.3, 1.0, -2.0]), 0.7),
                                  jviewer._axis_angle(np.array([0.3, 1.0, -2.0]), 0.7))


# ---------------------------------------------------------------------------
# the session on a port trainer
# ---------------------------------------------------------------------------


def test_interactive_session_train_render(tmp_path, scene):
    """Train calls move the step and adapt their count; a view at
    downscale 1 is ``render_frame``'s frame; an unchanged pose
    accumulates, a new pose, a time scrub or the depth mode reset; a
    downscaled view is resized back to the camera's size."""
    trainer = _port_trainer(tmp_path / "ws")
    # a frame budget no frame exceeds: the downscale stays 1 unless set
    sess = tviewer.InteractiveSession(trainer, NeRFDataset(scene, split="train", scale=0.8),
                                      train_budget_ms=200, render_budget_ms=1e6)
    m = sess.train_steps()
    assert np.isfinite(m["loss"]) and trainer.global_step == 16 and 1 <= m["steps"] <= 256
    sess.train_steps()
    assert trainer.global_step == 16 + m["steps"]

    cam = tviewer.OrbitCamera(32, 32, r=2.0)
    img1 = sess.render_view(cam)
    want, _ = trainer.render_frame(cam.pose, cam.intrinsics, 32, 32)
    np.testing.assert_array_equal(img1, want)
    assert sess.spp == 1 and sess.downscale == 1.0
    img2 = sess.render_view(cam)  # same pose -> accumulates
    assert sess.spp == 2 and img2.shape == (32, 32, 3)
    cam.orbit(30, 0)
    sess.downscale = 2.0
    img3 = sess.render_view(cam)  # new pose -> reset, rendered at 16 x 16
    assert sess.spp == 1 and img3.shape == (32, 32, 3) and sess.downscale == 1.0
    sess.render_view(cam)
    assert sess.spp == 2
    sess.time = 0.5  # a time scrub resets
    sess.render_view(cam)
    assert sess.spp == 1
    sess.mode = "depth"
    depth_view = sess.render_view(cam)
    assert sess.spp == 1
    _, depth = trainer.render_frame(cam.pose, cam.intrinsics, 32, 32)
    np.testing.assert_array_equal(depth_view, np.repeat(depth[..., None], 3, axis=-1))


def test_widget_surface_aabb_and_requests(tmp_path, scene):
    """The live aabb_infer crop changes the render (a cropped box renders
    background), and queued requests run in ``service_requests``."""
    trainer = _port_trainer(tmp_path / "ws")
    ds = NeRFDataset(scene, split="train", scale=0.8)
    sess = tviewer.InteractiveSession(trainer, ds, train_budget_ms=100, render_budget_ms=100)
    for _ in range(3):
        sess.train_steps()
    pose = ds.poses[0]
    full, _ = trainer.render_frame(pose, ds.intrinsics, SIZE, SIZE)
    sess.set_aabb_axis(0, 0.99)  # xmin -> just under xmax
    assert trainer.aabb_infer[0] < trainer.aabb_infer[3]
    sess.set_aabb_axis(3, -0.99)  # xmax clamped above xmin: the box stays valid
    assert trainer.aabb_infer[0] < trainer.aabb_infer[3]
    cropped, _ = trainer.render_frame(pose, ds.intrinsics, SIZE, SIZE)
    assert np.abs(cropped - 1.0).mean() < np.abs(full - 1.0).mean()
    trainer.aabb_infer = None
    again, _ = trainer.render_frame(pose, ds.intrinsics, SIZE, SIZE)
    np.testing.assert_allclose(again, full, atol=1e-6)

    sess.request("save_ckpt")
    sess.request("reset")
    sess.request("max_samples", 7)  # rounded up to a multiple of 4
    sess.request("mean_samples", 6)
    sess.service_requests()
    assert trainer.eval_max_samples == 8 and trainer.eval_mean_samples == 6
    assert float(trainer.aux["occ"].occ_grid.float().mean()) == 1.0  # the reset grid
    sess.request("mean_samples", 0)  # 0 = no budget (full render)
    sess.service_requests()
    assert trainer.eval_mean_samples is None
    assert list((tmp_path / "ws" / "checkpoints").glob("*.pth"))
    was = sess.training
    sess.request("train")
    sess.service_requests()
    assert sess.training != was


def test_viewer_web_http_endpoints():
    """The page, a frame, the stats, the /ctl ops on the camera and the
    session, and a 404, through a real server (a stub session)."""

    class StubSession:
        def __init__(self):
            self.mode = "rgb"
            self.aabb_calls = []
            self.requests = []

        def set_aabb_axis(self, axis, frac):
            self.aabb_calls.append((axis, frac))

        def request(self, op, arg=None):
            self.requests.append((op, arg))

    sess = StubSession()
    cam = tviewer.OrbitCamera(64, 64, r=2.0)
    state = {"frame": np.zeros((64, 64, 3), np.uint8), "stats": {"step": 7},
             "lock": threading.Lock()}
    server = tweb.make_server(sess, cam, state, 64, 64, 0)  # port 0: any free port
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        def get(p):
            return urllib.request.urlopen(f"http://127.0.0.1:{port}{p}", timeout=10)

        assert b"ngp_tpu viewer" in get("/").read()
        assert get("/frame").read()[:2] == b"\xff\xd8"  # JPEG magic
        assert json.loads(get("/stats").read())["step"] == 7
        r0 = cam.radius
        get("/ctl?op=scale&dx=1").read()
        assert cam.radius < r0
        pose0 = cam.pose
        get("/ctl?op=orbit&dx=20&dy=5").read()
        assert not np.allclose(cam.pose, pose0)
        get("/ctl?op=fov&dx=80").read()
        assert cam.fovy == 80.0
        get("/ctl?op=aabb&axis=2&dx=-50").read()
        assert sess.aabb_calls == [(2, -0.5)]
        get("/ctl?op=time&dx=0.25").read()
        get("/ctl?op=time&dx=0.9").read()
        assert state["time"] == 1.0  # clipped to [0, 1]
        get("/ctl?op=save_ckpt").read()
        get("/ctl?op=max_samples&dx=16").read()
        assert ("save_ckpt", None) in sess.requests and ("max_samples", 16) in sess.requests
        get("/ctl?op=mode").read()
        assert sess.mode == "depth"
        with pytest.raises(urllib.error.HTTPError) as e:
            get("/nope")
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


def test_serve_loop_drives_a_port_trainer(tmp_path, scene, monkeypatch):
    """``serve_step`` (one pass of ``serve``'s loop) against a real server:
    the frame and stats it publishes, the train toggle and the dial from
    /ctl applied on the next pass; ``serve`` loops until a
    KeyboardInterrupt and then returns."""
    trainer = _port_trainer(tmp_path / "ws")
    sess = tviewer.InteractiveSession(trainer, NeRFDataset(scene, split="train", scale=0.8),
                                      train_budget_ms=50, render_budget_ms=1e6)
    cam = tviewer.OrbitCamera(32, 32, r=2.0)
    state = {"frame": None, "stats": {}, "lock": threading.Lock()}
    server = tweb.make_server(sess, cam, state, 32, 32, 0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        def get(p):
            return urllib.request.urlopen(f"http://127.0.0.1:{port}{p}", timeout=10).read()

        tweb.serve_step(sess, cam, state)
        stats = json.loads(get("/stats"))
        assert stats["step"] == trainer.global_step > 0 and np.isfinite(stats["loss"])
        assert stats["spp"] == 1 and get("/frame")[:2] == b"\xff\xd8"
        want, _ = trainer.render_frame(cam.pose, cam.intrinsics, 32, 32)
        np.testing.assert_array_equal(state["frame"],
                                      (np.clip(want, 0, 1) * 255).astype(np.uint8))
        get("/ctl?op=train")
        get("/ctl?op=max_samples&dx=8")
        step = trainer.global_step
        tweb.serve_step(sess, cam, state)
        assert not sess.training and trainer.global_step == step
        assert trainer.eval_max_samples == 8 and "loss" not in json.loads(get("/stats"))
    finally:
        server.shutdown()
        server.server_close()

    calls = []

    def step_then_stop(*a):
        calls.append(a)
        if len(calls) == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(tweb, "serve_step", step_then_stop)
    tweb.serve(sess, W=32, H=32, port=0)
    assert len(calls) == 2 and calls[0][0] is sess and calls[0][1].W == 32


# ---------------------------------------------------------------------------
# the GUI loop's halves against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("downscale", [1.0, 0.5])
def test_test_gui_matches_jax(tmp_path, downscale):
    jtr, ttr = _pair(tmp_path)
    for pose in _poses():
        want = jtr.test_gui(pose, INTR, W, H, downscale=downscale)
        got = ttr.test_gui(pose, INTR, W, H, downscale=downscale)
        assert got["image"].shape == (H, W, 3) and got["depth"].shape == (H, W)
        levels = np.abs(np.round(got["image"] * 255.0) - np.round(want["image"] * 255.0))
        assert levels.max() <= 1.0 and np.mean(levels == 0) >= 0.995
        assert np.abs(got["depth"] - want["depth"]).mean() <= 1e-3
        assert np.abs(want["image"] - 1.0).max() > 0.05  # the frame has content


def test_train_gui_matches_jax(tmp_path, monkeypatch):
    """One ``train_gui`` step of each package on the same weights, grid,
    frame order (both loaders) and JAX's draws: the loss, the learning
    rate and every gradient. The refresh is off in both (``on_step_begin``),
    as the grid was copied from JAX's."""
    root = jsyn.make_synthetic_dataset(str(tmp_path / "scene"), n_train=2, n_val=1, n_test=1,
                                       H=SIZE, W=SIZE, num_steps=64)
    n = 256
    tc = dict(iters=50, num_rays=n, workspace=str(tmp_path / "ws"))
    jtr, port = _trainer_pair(tmp_path, _TURBO_RC, _CP_NC, tc)
    ttr = port()
    for tr in (jtr, ttr):
        monkeypatch.setattr(tr, "on_step_begin", lambda: None)
    _, k = jax.random.split(jtr.rng)
    k_pix, k_bg, k_render = jax.random.split(k, 3)
    draws = {"inds": _np(jax.random.randint(k_pix, (n,), 0, SIZE * SIZE)),
             "bg": _np(jax.random.uniform(k_bg, (n, 3))),
             "noise": _np(jax.random.uniform(k_render, (n,)))}
    train_step = ttr.train_step
    monkeypatch.setattr(ttr, "train_step", lambda batch, d=None: train_step(batch, draws))
    want = jtr.train_gui(JNeRFDataset(root, split="train"), step=1)
    got = ttr.train_gui(NeRFDataset(root, split="train"), step=1)
    assert jtr.global_step == ttr.global_step == 1
    assert got["lr"] == pytest.approx(want["lr"], rel=1e-6) and got["time"] > 0
    _check_step(jtr.state, {"loss": want["loss"]}, {"loss": got["loss"]}, ttr.model)


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dynamic_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("viewer_dscene") / "scene")
    return tsyn.make_synthetic_dataset(root, n_train=3, n_val=1, n_test=1, H=SIZE, W=SIZE,
                                       num_steps=64, dynamic=True, device="cpu")


@pytest.mark.parametrize("name", ["main_nerf", "main_tensoRF", "main_CCNeRF", "main_dnerf"])
def test_gui_flag_reaches_serve(tmp_path, monkeypatch, scene, dynamic_scene, name):
    """``<main> <scene> -O --gui`` builds the trainer, loads the checkpoint
    (none here), and hands ``serve`` an ``InteractiveSession`` on the
    train split with the viewer flags, instead of training (``serve``
    replaced; the grid cut to 16^3)."""
    import importlib

    main = importlib.import_module(f"ngp_tpu_torch.{name}")
    monkeypatch.setattr(main, "RenderConfig",
                        functools.partial(tconfig.RenderConfig, grid_size=16))
    served = []
    monkeypatch.setattr(tweb, "serve", lambda session, **kw: served.append((session, kw)))
    root = dynamic_scene if name == "main_dnerf" else scene
    trainer = main.main([root, "-O", "--gui", "--workspace", str(tmp_path / "ws"), "--W", "48",
                         "--H", "40", "--radius", "3", "--fovy", "40", "--max_spp", "9"],
                        device="cpu")
    assert len(served) == 1
    session, kw = served[0]
    assert isinstance(session, tviewer.InteractiveSession) and session.trainer is trainer
    assert kw == {"W": 48, "H": 40, "radius": 3.0, "fovy": 40.0}
    assert session.max_spp == 9 and session.training and trainer.global_step == 0
    assert session._supports_time == (name == "main_dnerf")
    batch = session._next_batch()
    assert batch["images"].shape[0] == 3


def test_tensorboard_writer(tmp_path, scene):
    """``use_tensorboard``: a writer on ``<workspace>/run/<name>`` that gets
    the JAX trainer's scalars (train/<metric> and train/lr at each flush,
    eval/<metric> after evaluate); none without the flag."""
    pytest.importorskip("tensorboardX")
    assert _port_trainer(tmp_path / "off").writer is None
    rc = tconfig.RenderConfig(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=64,
                              max_samples_per_ray=16, grid_size=16, density_thresh=10.0)
    model = NeRFNetwork(tconfig.NetworkConfig(num_levels=4, log2_hashmap_size=12,
                                              use_bf16=False), rc, device="cpu")
    ws = tmp_path / "ws"
    trainer = GridNeRFTrainer(model, rc, tconfig.TrainConfig(num_rays=128, workspace=str(ws)),
                              log_every=2, use_tensorboard=True)
    assert trainer.writer is not None
    seen = []
    add = trainer.writer.add_scalar
    trainer.writer.add_scalar = lambda tag, v, step: seen.append((tag, step)) or add(tag, v, step)
    ds = NeRFDataset(scene, split="train", scale=0.8)
    trainer.train_on_dataset(ds, max_epochs=1)
    trainer.evaluate(NeRFDataset(scene, split="val", scale=0.8))
    trainer.writer.flush()
    assert ("train/loss", 2) in seen and ("train/lr", 2) in seen and ("train/loss", 3) in seen
    assert ("eval/psnr", 3) in seen
    assert [p for p in (ws / "run" / "ngp").iterdir() if p.stat().st_size > 0]


def test_vis_helpers_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    from ngp_tpu_torch.utils import vis

    rng = np.random.default_rng(0)
    paths = [vis.vis_2d(rng.random((16, 16)), str(tmp_path / "a.png"), renormalize=True),
             vis.vis_2d(rng.random((16, 16, 3)), str(tmp_path / "b.png")),
             vis.plot_pointcloud(rng.random((30000, 3)), rng.random((30000, 3)),
                                 str(tmp_path / "c.png")),
             vis.visualize_poses(tsyn._orbit_pose(0.5, 0.3, 2.0)[None], 0.2,
                                 str(tmp_path / "d.png"))]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
