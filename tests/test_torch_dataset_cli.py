"""The port's scene loaders, scene writer and command line against the
JAX package: ``NeRFDataset`` on scenes that the JAX package's
``make_synthetic_dataset`` writes (the blender layout, every split; a
colmap ``transforms.json`` with ``fl_x``/``cx`` and its slerp test path;
``downscale``; RGB images; a missing file; linear colour), the port's
``make_synthetic_dataset`` beside JAX's, ``rand_poses``, the parser and
``resolve_opts`` pinned to ``main_nerf.py``'s, the flags the port
refuses, and one small ``main`` run on the CPU.

Tolerances. The loaders: equal, bit for bit. The scene writer: the JSON
to 1e-6, the PNGs within one u8 level in under 1% of the pixels (the
ground-truth render is held to JAX's in ``test_torch_train_step.py``).
"""

import functools
import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

import main_nerf as jmain
from ngp_tpu.data import nerf_dataset as jds
from ngp_tpu.data import synthetic as jsyn
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch import main_nerf as tmain
from ngp_tpu_torch.data import nerf_dataset as tds
from ngp_tpu_torch.data import synthetic as tsyn
from ngp_tpu_torch.training.nerf import NeRFTrainer
from ngp_tpu_torch.utils.png import read_png
from test_torch_renderer import one_torch_thread  # noqa: F401

SIZE = 24
FRAMES = dict(n_train=3, n_val=2, n_test=2)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A blender-layout scene written by the JAX package, RGBA."""
    root = str(tmp_path_factory.mktemp("jax_scene") / "scene")
    return jsyn.make_synthetic_dataset(root, H=SIZE, W=SIZE, num_steps=128, **FRAMES)


def _same(a, b):
    """Every attribute the trainer and the CLI read, bit for bit."""
    assert (a.H, a.W, a.training, a.has_gt, a.num_channels, len(a)) == \
        (b.H, b.W, b.training, b.has_gt, b.num_channels, len(b))
    for name in ("poses", "intrinsics", "times", "images", "error_map"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.radius == b.radius
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    np.testing.assert_array_equal(a.epoch_indices(rng_a, 2), b.epoch_indices(rng_b, 2))


@pytest.mark.parametrize("split", ["train", "val", "test", "all", "trainval"])
@pytest.mark.parametrize("kw", [dict(), dict(scale=0.8, offset=(0.1, 0.0, -0.2)),
                                dict(downscale=2), dict(color_space="linear"),
                                dict(error_map=True, seed=3)])
def test_blender_splits_load_as_jax(scene, split, kw):
    _same(tds.NeRFDataset(scene, split=split, **kw), jds.NeRFDataset(scene, split=split, **kw))


def _colmap(scene, dst, with_hw=False, rgb=False):
    """One transforms.json over the blender scene's train images, with
    fl_x/fl_y and cx/cy (and h/w), the images in another directory; RGB
    images when ``rgb``. The poses are random right-handed rotations (the
    synthetic orbit frames are left-handed, which the slerp refuses)."""
    with open(os.path.join(scene, "transforms_train.json")) as f:
        meta = json.load(f)
    os.makedirs(os.path.join(dst, "images"), exist_ok=True)
    rng = np.random.default_rng(11)
    frames = []
    for i, fr in enumerate(meta["frames"]):
        name = f"images/img_{i}.png"
        img = cv2.imread(os.path.join(scene, fr["file_path"] + ".png"), cv2.IMREAD_UNCHANGED)
        cv2.imwrite(os.path.join(dst, name), img[..., :3] if rgb else img)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        pose = np.eye(4)
        pose[:3, :3] = q * np.sign(np.linalg.det(q))
        pose[:3, 3] = rng.normal(size=3) * 2.0
        frames.append({"file_path": name, "transform_matrix": pose.tolist()})
    out = {"fl_x": 30.5, "fl_y": 29.0, "cx": 11.25, "cy": 12.75, "frames": frames}
    if with_hw:
        out.update(h=SIZE, w=SIZE)
    with open(os.path.join(dst, "transforms.json"), "w") as f:
        json.dump(out, f)
    return dst


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("kw", [dict(), dict(downscale=2, n_test=4, seed=7),
                                dict(rgb=True), dict(with_hw=True, seed=2)])
def test_colmap_layout_loads_as_jax(scene, tmp_path, split, kw):
    """Frame 0 is val, the others train; the test split is the slerp
    path between two frames drawn from the seed (no images)."""
    kw = dict(kw)
    rgb = kw.pop("rgb", False)
    root = _colmap(scene, str(tmp_path / "colmap"), with_hw=kw.pop("with_hw", False), rgb=rgb)
    got = tds.NeRFDataset(root, split=split, **kw)
    _same(got, jds.NeRFDataset(root, split=split, **kw))
    assert got.mode == "colmap"
    if split == "test":
        assert got.images is None and len(got) == kw.get("n_test", 10) + 1
    else:
        assert got.num_channels == (3 if rgb else 4)


def test_rgb_images_and_a_missing_file_load_as_jax(scene, tmp_path):
    root = str(tmp_path / "rgb")
    shutil.copytree(scene, root)
    for i in range(FRAMES["n_train"]):
        p = os.path.join(root, "train", f"r_{i}.png")
        cv2.imwrite(p, cv2.imread(p, cv2.IMREAD_UNCHANGED)[..., :3])
    os.remove(os.path.join(root, "val", "r_1.png"))
    for split in ("train", "val"):  # "all" would stack RGB and RGBA frames
        got = tds.NeRFDataset(root, split=split, downscale=2)
        _same(got, jds.NeRFDataset(root, split=split, downscale=2))
    assert tds.NeRFDataset(root, split="train").num_channels == 3
    assert len(tds.NeRFDataset(root, split="val")) == FRAMES["n_val"] - 1


def test_from_arrays_and_no_scene(tmp_path):
    imgs = np.random.default_rng(0).uniform(size=(3, 4, 5, 4)).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 3)
    poses[:, :3, 3] = [[0, 0, 2.0], [0, 3.0, 0], [1.0, 0, 0]]
    ds = tds.NeRFDataset.from_arrays(imgs, poses, [5.0, 5.0, 2.5, 2.0], 4, 5, split="val")
    assert (ds.H, ds.W, len(ds), ds.training, ds.has_gt, ds.num_channels) == (4, 5, 3, False,
                                                                             True, 4)
    assert ds.radius == pytest.approx(2.0)
    np.testing.assert_array_equal(ds.times, np.array([0.0, 0.5, 1.0], np.float32))
    np.testing.assert_array_equal(ds.epoch_indices(np.random.default_rng(0), 2), [0, 1, 2])
    none = tds.NeRFDataset.from_arrays(None, poses, [5.0, 5.0, 2.5, 2.0], 4, 5)
    assert not none.has_gt and none.num_channels == 3 and none.training
    with pytest.raises(FileNotFoundError):
        tds.NeRFDataset(str(tmp_path))


def test_rand_poses_equal_jax():
    for radius in (1.0, 0.9075):
        want = jds.rand_poses(np.random.default_rng(4), 5, radius=radius)
        got = tds.rand_poses(np.random.default_rng(4), 5, radius=radius)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32


@pytest.mark.parametrize("kw", [dict(), dict(variant="hard"), dict(dynamic=True),
                                dict(dynamic=True, variant="hard", seed=2)])
def test_make_synthetic_dataset_matches_jax(tmp_path, kw):
    """The JSON to 1e-6; the PNGs within one u8 level, and different only
    where the JAX frame's value times 255 lies within 1e-3 of a whole
    level, so that truncation to u8 takes the level or the one below by
    one ulp of f32: an opaque alpha of exactly 1.0 (1 - 2^-24 on the
    other side), and straight colours of 0.2, 0.4, 0.8 or 1.0. Those are
    3-5% of the pixels of these frames (measured), not under 1%: every
    opaque pixel sits on such a boundary."""
    common = dict(n_train=2, n_val=1, n_test=1, H=SIZE, W=SIZE, num_steps=128, **kw)
    want = jsyn.make_synthetic_dataset(str(tmp_path / "jax"), **common)
    got = tsyn.make_synthetic_dataset(str(tmp_path / "port"), device="cpu", **common)
    rng = np.random.default_rng(kw.get("seed", 0))
    focal = 0.5 * SIZE / np.tan(0.5 * np.deg2rad(50.0))
    intr = np.array([focal, focal, SIZE / 2, SIZE / 2], np.float32)
    n_diff = 0
    for split in ("train", "val", "test"):
        with open(os.path.join(want, f"transforms_{split}.json")) as f:
            jmeta = json.load(f)
        with open(os.path.join(got, f"transforms_{split}.json")) as f:
            tmeta = json.load(f)
        assert set(tmeta) == set(jmeta) and (tmeta["h"], tmeta["w"]) == (jmeta["h"], jmeta["w"])
        assert tmeta["camera_angle_x"] == pytest.approx(jmeta["camera_angle_x"], abs=1e-6)
        n = len(jmeta["frames"])
        assert len(tmeta["frames"]) == n
        for i, (tf, jf) in enumerate(zip(tmeta["frames"], jmeta["frames"])):
            assert set(tf) == set(jf) and tf["file_path"] == jf["file_path"]
            assert ("time" in tf) == bool(kw.get("dynamic"))
            if "time" in tf:
                assert tf["time"] == pytest.approx(jf["time"], abs=1e-6)
            np.testing.assert_allclose(tf["transform_matrix"], jf["transform_matrix"], atol=1e-6)
            a = cv2.imread(os.path.join(got, tf["file_path"] + ".png"), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(os.path.join(want, jf["file_path"] + ".png"), cv2.IMREAD_UNCHANGED)
            assert a.shape == b.shape == (SIZE, SIZE, 4)
            d = a.astype(np.int32) - b.astype(np.int32)
            assert np.abs(d).max() <= 1
            pose = tsyn._pose_draws(rng, split, i, n, 2.2)
            ref = jsyn.render_gt_frame(pose, intr, SIZE, SIZE, num_steps=128,
                                       time=tf.get("time"), variant=kw.get("variant", "default"))
            level = np.asarray(ref)[..., [2, 1, 0, 3]] * 255.0
            np.testing.assert_array_equal(b, level.astype(np.uint8))
            on_boundary = np.abs(level - np.round(level)) < 1e-3
            assert not (d != 0)[~on_boundary].any()
            n_diff += int((d != 0).any(axis=-1).sum())
    assert n_diff < 0.08 * 4 * SIZE * SIZE
    # an existing scene is kept unless overwrite
    stamp = os.path.getmtime(os.path.join(got, "transforms_train.json"))
    tsyn.make_synthetic_dataset(got, device="cpu", **common)
    assert os.path.getmtime(os.path.join(got, "transforms_train.json")) == stamp
    # the loaders give back the native poses at the writer's scale
    ds = tds.NeRFDataset(got, split="val", scale=0.8)
    np.testing.assert_allclose(ds.poses[0], tsyn._orbit_pose(np.pi / 2.2, 0.0, 2.2), atol=1e-6)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _actions(parser):
    keys = ("option_strings", "dest", "default", "type", "choices", "nargs", "const",
            "required", "help")
    return [tuple(getattr(a, k) for k in keys) for a in parser._actions]


def test_parser_pinned_to_main_nerf():
    got, want = _actions(tmain.build_parser()), _actions(jmain.build_parser())
    assert [a[1] for a in got] == [a[1] for a in want]
    for g, w in zip(got, want):
        assert g == w, g[1]


@pytest.mark.parametrize("argv", [[], ["-O"], ["-O", "--encoding", "hashgrid"],
                                  ["--preset", "turbo"], ["--patch_size", "4"],
                                  ["-O", "--preset", "turbo", "--compact_mean_samples", "8"],
                                  ["--preset", "tpu", "--max_steps", "128"]])
def test_resolve_opts_agrees_with_main_nerf(argv):
    argv = ["scene"] + argv
    got = tmain.resolve_opts(tmain.build_parser().parse_args(argv))
    want = jmain.resolve_opts(jmain.build_parser().parse_args(argv))
    assert vars(got) == vars(want)


@pytest.mark.parametrize("flags,item", [
    (["--cuda_ray", "--encoding", "tiledgrid", "--gui"], "item 4"),
    (["-O", "--rand_pose", "0", "--clip_model_path", "clip"], "item 9"),
    (["-O", "--encoding", "brickgrid"], "item 7"),
    (["--preset", "tpu"], "item 7"),
])
def test_unported_flags_raise(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP §1 {item}"):
        tmain.main([str(tmp_path / "none"), "--workspace", str(tmp_path / "ws")] + flags,
                   device="cpu")
    assert not (tmp_path / "ws").exists()


@pytest.mark.parametrize("flags", [
    [],  # no -O / --cuda_ray: NeRFTrainer, the uniform + PDF renderer
    ["-O", "--bg_radius", "4"],  # the background net and its frames
    ["-O", "--lpips_weights"],  # LPIPS in evaluate, from a checkpoint on disk
], ids=["uniform", "bg_radius", "lpips_weights"])
def test_main_runs_the_rest_of_main_nerf_on_the_cpu(tmp_path, monkeypatch, flags):
    """The runs ROADMAP §1 item 5 brought up, as ``main_nerf.py`` runs them:
    without -O (``NeRFTrainer``, 16 + 8 samples a ray here), with the
    background net, and with LPIPS from a random-weight checkpoint the
    test writes (32 x 32 frames: AlexNet needs 31 or more); each trains
    two epochs, evaluates and tests on the CPU. The grid is cut to 16^3,
    the hash grid to 4 levels of 2^12 rows and the CP grid to rank 16 on
    two banks (the presets set the widths; these runs test the paths)."""
    from ngp_tpu_torch.training.lpips import random_params
    from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer

    size = 32 if "--lpips_weights" in flags else SIZE
    root = tsyn.make_synthetic_dataset(str(tmp_path / "scene"), n_train=4, n_val=1, n_test=2,
                                       H=size, W=size, num_steps=64, device="cpu")
    monkeypatch.setattr(tmain, "RenderConfig",
                        functools.partial(tconfig.RenderConfig, grid_size=16))
    monkeypatch.setattr(tmain, "NetworkConfig", lambda **kw: tconfig.NetworkConfig(**dict(
        kw, num_levels=4, log2_hashmap_size=12, cp_rank=16, cp_resolutions=(32, 64))))
    results = []
    evaluate = NeRFTrainer.evaluate
    monkeypatch.setattr(NeRFTrainer, "evaluate",
                        lambda self, *a, **k: results.append(evaluate(self, *a, **k))
                        or results[-1])
    flags = list(flags)
    if "--lpips_weights" in flags:
        path = str(tmp_path / "alex.pth")
        params = random_params(torch.Generator().manual_seed(0))
        sd = {}  # torchvision's AlexNet features and the LPIPS heads
        for i, idx in enumerate((0, 3, 6, 8, 10)):
            w = params[f"conv{i}_w"].transpose(3, 2, 0, 1).copy()  # HWIO -> OIHW
            sd[f"features.{idx}.weight"] = torch.from_numpy(w)
            sd[f"features.{idx}.bias"] = torch.from_numpy(params[f"conv{i}_b"])
            sd[f"lins.{i}.weight"] = torch.from_numpy(params[f"lin{i}_w"]).reshape(1, -1, 1, 1)
        torch.save(sd, path)
        flags.append(path)
    ws = str(tmp_path / "ws")
    argv = [root, "--workspace", ws, "--iters", "8", "--num_rays", "128", "--num_steps", "16",
            "--upsample_steps", "8", "--seed", "3"] + flags
    tr = tmain.main(argv, device="cpu")
    assert tr.global_step == 8 and tr.epoch == 2 and np.isfinite(tr.stats["loss"]).all()
    assert isinstance(tr, GridNeRFTrainer) == ("-O" in flags)
    assert tr.render_cfg.bg_radius == (4.0 if "--bg_radius" in flags else -1.0)
    assert hasattr(tr.model, "bg_net") == ("--bg_radius" in flags)
    assert len(results) == 1 and np.isfinite(results[0]["psnr"])
    assert ("lpips" in results[0]) == ("--lpips_weights" in flags)
    if "lpips" in results[0]:
        assert tr.lpips_weights == flags[-1] and 0.0 < results[0]["lpips"] < 10.0
    for i in range(2):
        assert read_png(os.path.join(ws, "results", f"ngp_{i:04d}_rgb.png")).shape == \
            (size, size, 3)


def test_clip_loss_is_not_ported():
    from ngp_tpu_torch.training.clip_guidance import CLIPLoss

    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 9"):
        CLIPLoss("a chair", model_path="clip")


def test_main_runs_on_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main([str(tmp_path), "-O"])


def test_main_trains_resumes_and_tests_on_the_cpu(tmp_path, monkeypatch):
    """``--synthetic`` on a scene already written (kept), then -O: the
    checkpoints, the test PNGs and the mesh; a longer run resumes at
    the saved step; ``--test`` reproduces the resumed run's evaluate.
    The occupancy grid is cut to 16^3 and the mesh lattice to 24^3; the
    iso-level 1.0 crosses the untrained density, trunc_exp of values near
    0."""
    root = tsyn.make_synthetic_dataset(str(tmp_path / "scene"), n_train=4, n_val=1, n_test=2,
                                       H=SIZE, W=SIZE, num_steps=64, device="cpu")
    monkeypatch.setattr(tmain, "RenderConfig",
                        functools.partial(tconfig.RenderConfig, grid_size=16))
    monkeypatch.setattr(NeRFTrainer, "save_mesh",
                        functools.partialmethod(NeRFTrainer.save_mesh, resolution=24))
    psnrs = []
    evaluate = NeRFTrainer.evaluate
    monkeypatch.setattr(NeRFTrainer, "evaluate",
                        lambda self, *a, **k: psnrs.append(evaluate(self, *a, **k)["psnr"])
                        or {"psnr": psnrs[-1]})
    ws = str(tmp_path / "ws")
    argv = [root, "--synthetic", "-O", "--workspace", ws, "--iters", "8", "--num_rays", "256",
            "--save_mesh", "--density_thresh", "1.0", "--seed", "3"]
    tr = tmain.main(argv, device="cpu")
    assert tr.global_step == 8 and tr.epoch == 2 and len(psnrs) == 1
    assert np.isfinite(tr.stats["loss"]).all()
    assert sorted(os.listdir(os.path.join(ws, "checkpoints"))) == ["ngp_ep0001.pth",
                                                                   "ngp_ep0002.pth"]
    for i in range(2):
        assert read_png(os.path.join(ws, "results", f"ngp_{i:04d}_rgb.png")).shape == \
            (SIZE, SIZE, 3)
    assert os.path.getsize(os.path.join(ws, "meshes", "ngp_2.obj")) > 0
    assert tr.last_mesh_stats["n_faces"] > 0

    argv[argv.index("--iters") + 1] = "12"
    resumed = tmain.main(argv, device="cpu")
    assert resumed.global_step == 12 and resumed.epoch == 3
    ckpts = sorted(os.listdir(os.path.join(ws, "checkpoints")))
    assert ckpts == ["ngp_ep0002.pth", "ngp_ep0003.pth"]

    tested = tmain.main([root, "-O", "--workspace", ws, "--test"], device="cpu")
    assert tested.global_step == 12 and psnrs[-1] == psnrs[-2]
