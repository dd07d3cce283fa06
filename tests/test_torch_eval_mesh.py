"""The end of a user's ``-O`` run in the port against the JAX package:
the image meters, ``evaluate`` on a trained grid trainer, ``save_mesh``'s
density grid and marching tetrahedra, the mesh writer, the PNG codec,
and best checkpoints from ``train_on_dataset(train_ds, valid_ds)``.

Tolerances. PSNR and SSIM on the same images: 1e-5 (f32 sums in another
order), and the LPIPS meter on JAX's random weights 1e-5 relative; SSIM of a mostly white frame 1e-4, since its variance terms
E[x^2] - E[x]^2 cancel two blurs near 1.0 (f32 steps of 6e-8 against
c2 = 9e-4): measured against an f64 SSIM of 0.9753487, JAX reads
0.9753435 and the port 0.9753775. ``evaluate``: PSNR to 0.01 dB and SSIM to 1e-3, since the port's
u8 frames may sit one level from JAX's on a few pixels
(tests/test_torch_render_frame.py). The density grid: 1e-4 relative
(f32, sums in another order through the encoder and the MLP). Marching
on one grid and the mesh files: equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu import config as jconfig
from ngp_tpu.models import occupancy as jo
from ngp_tpu.models.nerf import NeRFNetwork as JNeRFNetwork
from ngp_tpu.training import metrics as jm
from ngp_tpu.training.lpips import random_params as jlpips_random_params
from ngp_tpu.training.nerf_grid import GridNeRFTrainer as JGridNeRFTrainer
from ngp_tpu_torch import config as tconfig
from ngp_tpu_torch import native as tnative
from ngp_tpu_torch.data import synthetic as tsyn
from ngp_tpu_torch.data.mesh import save_mesh as t_save_mesh
from ngp_tpu_torch.models.nerf import NeRFNetwork as TNeRFNetwork
from ngp_tpu_torch.training import metrics as tm
from ngp_tpu_torch.training.nerf_grid import GridNeRFTrainer as TGridNeRFTrainer
from ngp_tpu_torch.utils.png import read_png, write_png

RC = dict(bound=1.0, min_near=0.05, dt_gamma=0.0, max_steps=64, max_samples_per_ray=16,
          grid_size=16, density_thresh=10.0, turbo=True, coarse_candidates=48,
          crossing_slots=16, compact_mean_samples=6)
NC = dict(encoding="cpgrid", use_bf16=False, cp_resolutions=(32, 64), cp_rank=16,
          cp_freq_degree=4, sh_degree=3)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape).astype(np.float32), 0, 1)
    return a, b


@pytest.mark.parametrize("shape", [(20, 24, 3), (8, 9, 3), (5, 4, 3)])
def test_psnr_ssim_match_jax(shape):
    """Including images under 11 px, where the window shrinks (9 -> 7,
    4 -> 3)."""
    a, b = _images(shape, seed=sum(shape))
    assert float(tm.psnr(a, b)) == pytest.approx(float(jm.psnr(jnp.asarray(a), jnp.asarray(b))),
                                                 abs=1e-5)
    got, want = float(tm.ssim(a, b)), float(jm.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert got == pytest.approx(want, abs=1e-5)
    assert got < 1.0
    assert float(tm.ssim(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(1.0,
                                                                                    abs=1e-5)


def test_ssim_white_background_matches_jax():
    """The mostly white frame of tests/test_metrics.py, where an SSIM
    computed with lost precision reads above 1."""
    rng = np.random.default_rng(0)
    base = np.ones((64, 64, 3), np.float32)
    base[20:40, 20:40] = rng.random((20, 20, 3))
    noisy = np.clip(base + rng.normal(0, 0.01, base.shape).astype(np.float32), 0, 1)
    v = float(tm.ssim(base, noisy))
    assert 0.8 < v <= 1.0
    assert v == pytest.approx(float(jm.ssim(jnp.asarray(base), jnp.asarray(noisy))), abs=1e-4)
    assert float(tm.ssim(base, base)) == pytest.approx(1.0, abs=1e-5)


def test_meters_match_jax():
    a, b = _images((3, 16, 18, 3), seed=5)
    tp, ts, jp, js = tm.PSNRMeter(), tm.SSIMMeter(), jm.PSNRMeter(), jm.SSIMMeter()
    for i in range(3):
        tp.update(a[i], b[i])
        jp.update(a[i], b[i])
    ts.update(a, b)  # a [B, H, W, C] batch counts per image
    js.update(a, b)
    assert tp.N == jp.N == ts.N == js.N == 3
    assert tp.measure() == pytest.approx(jp.measure(), abs=1e-5)
    assert ts.measure() == pytest.approx(js.measure(), abs=1e-5)
    assert tp.report().startswith("PSNR = ") and ts.report().startswith("SSIM = ")
    tp.clear()
    assert (tp.N, tp.measure()) == (0, 0.0)
    # LPIPS on JAX's random weights (frames of at least 31 x 31 pixels)
    params = jax.tree.map(np.asarray, jlpips_random_params(jax.random.PRNGKey(3)))
    c, d = _images((2, 32, 33, 3), seed=6)
    tl, jl = tm.LPIPSMeter(params=params, device="cpu"), jm.LPIPSMeter(params=params)
    for meter in (tl, jl):
        meter.update(c[0], d[0])
        meter.update(c, d)
    assert tl.N == jl.N == 3
    assert tl.measure() == pytest.approx(jl.measure(), rel=1e-5) and tl.measure() > 0
    assert tl.report().startswith("LPIPS (alex) = ")


# ---------------------------------------------------------------------------
# PNG codec and the mesh writer
# ---------------------------------------------------------------------------


def test_png_round_trip(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, size=(13, 17, 3), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    with pytest.raises(ValueError):
        write_png(path, img.astype(np.float32))


def test_png_reads_back_in_an_image_library(tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(2).integers(0, 256, size=(9, 11, 3), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    write_png(path, img)
    np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB), img)


@pytest.mark.parametrize("ext", [".obj", ".ply"])
def test_mesh_writer_matches_jax(tmp_path, ext):
    from ngp_tpu.data.mesh import save_mesh as j_save_mesh

    rng = np.random.default_rng(3)
    verts = rng.normal(size=(10, 3)).astype(np.float32)
    faces = rng.integers(0, 10, size=(7, 3)).astype(np.int32)
    t_save_mesh(str(tmp_path / f"t{ext}"), verts, faces)
    j_save_mesh(str(tmp_path / f"j{ext}"), verts, faces)
    assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()


# ---------------------------------------------------------------------------
# a trained port trainer and the JAX trainer on its weights and grid
# ---------------------------------------------------------------------------


def _tree(state):
    """The port's state dict -> the flax param tree of the JAX network."""
    p = {"encoder": {}, "sigma_net": {}, "color_net": {}}
    for k, v in state.items():
        mod, name = k.split(".")
        a = jnp.asarray(v.detach().numpy())
        p[mod][name] = a if mod == "encoder" else {"kernel": a}
    return {"params": p}


def _occ_to_jax(occ):
    return jo.OccupancyState(
        density_grid=jnp.asarray(occ.density_grid.numpy()),
        occ_grid=jnp.asarray(occ.occ_grid.numpy()),
        mean_density=jnp.asarray(occ.mean_density.numpy()),
        iter_density=jnp.int32(occ.iter_density),
        coarse_payload=jnp.asarray(occ.coarse_payload.numpy()),
        fine_payload=jnp.asarray(occ.fine_payload.numpy().astype(np.uint32)),
        prepass_payload=jnp.asarray(occ.prepass_payload.numpy()),
    )


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port trainer after 2 epochs of 4 steps on the synthetic scene,
    and a JAX trainer holding its EMA weights and its grid."""
    ws = tmp_path_factory.mktemp("trained")
    rc, nc = tconfig.RenderConfig(**RC), tconfig.NetworkConfig(**NC)
    splits = tsyn.make_synthetic_frames(n_train=4, n_val=2, n_test=1, H=24, W=24, seed=1,
                                     device="cpu")
    tc = dict(iters=50, num_rays=512, update_extra_interval=4, workspace=str(ws / "t"))
    ttr = TGridNeRFTrainer(TNeRFNetwork(nc, rc, torch.Generator().manual_seed(0), device="cpu"), rc,
                           tconfig.TrainConfig(**tc), log_every=10**9)
    ttr.train_on_dataset(splits["train"], max_epochs=2)
    jrc = jconfig.RenderConfig(**RC)
    jtr = JGridNeRFTrainer(JNeRFNetwork(cfg=jconfig.NetworkConfig(**NC), render=jrc), jrc,
                           jconfig.TrainConfig(**dict(tc, workspace=str(ws / "j"))),
                           log_every=10**9, use_tensorboard=False)
    jtr.ensure_initialized()
    ema = _tree(ttr.ema.state_dict())
    jtr.state = jtr.state.replace(params=ema, ema_params=ema)
    jtr.aux = dict(jtr.aux, occ=_occ_to_jax(ttr.aux["occ"]))
    return ttr, jtr, splits


def read_png_any(path):
    """A PNG that cv2 wrote (the JAX trainer) -> [H, W, 3] RGB uint8."""
    cv2 = pytest.importorskip("cv2")
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def test_evaluate_matches_jax(trained):
    ttr, jtr, splits = trained
    got = ttr.evaluate(splits["val"], with_ssim=True)
    want = jtr.evaluate(splits["val"], with_ssim=True)
    assert abs(got["psnr"] - want["psnr"]) <= 0.01, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= 1e-3, (got, want)
    assert 5.0 < got["psnr"] < 60.0 and 0.0 < got["ssim"] <= 1.0
    # one PNG per frame, named as the JAX trainer names them
    for i in range(2):
        name = f"ngp_{ttr.epoch:04d}_{i:04d}.png"
        t_img = read_png(os.path.join(ttr.workspace, "validation", name))
        assert t_img.shape == (24, 24, 3)
        j_img = read_png_any(os.path.join(jtr.workspace, "validation", f"ngp_0000_{i:04d}.png"))
        assert np.abs(t_img.astype(int) - j_img.astype(int)).max() <= 1

def test_eval_metric_is_minus_psnr(trained, monkeypatch):
    ttr, _, splits = trained
    monkeypatch.setattr(ttr, "evaluate", lambda ds: {"psnr": 23.5})
    assert ttr.eval_metric(splits["val"]) == -23.5
    with pytest.raises(TypeError):
        ttr.eval_metric(splits["val"].images)


def test_test_writes_frames(trained, monkeypatch):
    """Each rendered frame goes to results/<name>_<i>_rgb.png as the JAX
    trainer's cv2 writer would store it: u8 by truncation."""
    ttr, _, splits = trained
    rendered = []
    render = ttr.render_frames

    def recording(*args, **kwargs):
        out = render(*args, **kwargs)
        rendered.append(out[0][0])
        return out

    monkeypatch.setattr(ttr, "render_frames", recording)
    out = ttr.test(splits["test"], write_video=False)
    assert sorted(os.listdir(out)) == ["ngp_0000_rgb.png"] and len(rendered) == 1
    img = read_png(os.path.join(out, "ngp_0000_rgb.png"))
    np.testing.assert_array_equal(img, (np.clip(rendered[0], 0, 1) * 255).astype(np.uint8))
    assert img.min() < 200  # the frame has content


def test_save_mesh_matches_jax(trained, tmp_path, monkeypatch):
    """The density grid against JAX's, then marching on one grid, then
    the written files."""
    import ngp_tpu.native as jnative

    ttr, jtr, _ = trained
    res = 24
    grids = {}

    def capture(key, fn):
        def wrapped(grid, iso):
            grids[key] = np.array(grid)
            return fn(grid, iso)
        return wrapped

    monkeypatch.setattr(jnative, "marching_cubes", capture("jax", jnative.marching_cubes))
    monkeypatch.setattr(tnative, "marching_cubes", capture("torch", tnative.marching_cubes))
    thresh = float(np.median(ttr.density_grid(res)))
    j_path = jtr.save_mesh(str(tmp_path / "j.obj"), resolution=res, threshold=thresh)
    t_path = ttr.save_mesh(str(tmp_path / "t.obj"), resolution=res, threshold=thresh)
    assert grids["jax"].shape == grids["torch"].shape == (res, res, res)
    np.testing.assert_allclose(grids["torch"], grids["jax"], rtol=1e-4, atol=1e-6)
    assert ttr.last_mesh_stats["n_verts"] > 0
    monkeypatch.undo()
    verts_j, faces_j = jnative.marching_cubes(grids["jax"], thresh)
    verts_t, faces_t = tnative.marching_cubes(grids["jax"], thresh)
    assert len(faces_j) > 0
    np.testing.assert_array_equal(verts_t, verts_j)
    np.testing.assert_array_equal(faces_t, faces_j)
    # the port's file holds its own marching output, scaled to the box
    from ngp_tpu.data.mesh import load_mesh

    v, f = load_mesh(t_path)
    verts, faces = tnative.marching_cubes(grids["torch"], thresh)
    np.testing.assert_allclose(v, verts / (res - 1) * 2 - 1, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(f, faces)
    assert np.abs(v).max() <= 1.0 and os.path.exists(j_path)


def test_train_on_dataset_keeps_the_best_checkpoint(tmp_path):
    rc, nc = tconfig.RenderConfig(**RC), tconfig.NetworkConfig(**NC)
    splits = tsyn.make_synthetic_frames(n_train=2, n_val=1, n_test=0, H=16, W=16, device="cpu")
    tc = tconfig.TrainConfig(iters=50, num_rays=256, eval_interval=2, workspace=str(tmp_path))
    net = TNeRFNetwork(nc, rc, torch.Generator().manual_seed(0), device="cpu")
    tr = TGridNeRFTrainer(net, rc, tc, log_every=10**9)
    assert tr.eval_interval == 2
    tr.train_on_dataset(splits["train"], splits["val"], max_epochs=1)
    assert tr.stats["best_loss"] is None  # epoch 1: no validation
    tr.train_on_dataset(splits["train"], splits["val"], max_epochs=2)
    best = tr.stats["best_loss"]
    assert best is not None and best < 0  # -PSNR
    ckpts = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert "ngp_best.pth" in ckpts
    assert sorted(os.listdir(tmp_path / "validation")) == ["ngp_0002_0000.png"]
    back = TGridNeRFTrainer(TNeRFNetwork(nc, rc, device="cpu"), rc, tc)
    assert back.load_checkpoint(str(tmp_path / "checkpoints" / "ngp_best.pth"))
    assert back.stats["best_loss"] == pytest.approx(best)


# ---------------------------------------------------------------------------
# the padded pixel of a frame (ROADMAP section 3)
# ---------------------------------------------------------------------------


def test_last_slots_keep_the_last_copy_as_numpy_does():
    rng = np.random.default_rng(7)
    n = 50
    sel = rng.permutation(n)[:37]
    inds = np.concatenate([sel, np.full(64 - sel.size, sel[-1])]).reshape(4, 16)
    vals = rng.normal(size=64).astype(np.float32)
    want = np.full(n + 1, -9.0, np.float32)
    want[inds.reshape(-1)] = vals  # numpy: the last write of a repeated index wins
    keep = TGridNeRFTrainer._last_slots(torch.from_numpy(inds), n)
    assert int(keep.sum()) == 37 and bool(keep.reshape(-1)[-1])
    got = torch.full((n + 1,), -9.0)
    got[torch.where(keep, torch.from_numpy(inds), n).reshape(-1)] = torch.from_numpy(vals)
    np.testing.assert_array_equal(got[:n].numpy(), want[:n])


def test_frame_padding_pixel_matches_jax_and_repeats(trained):
    """The prepass pads the last chunk with copies of the last hit-sorted
    pixel; when that pixel is a hit, its copies water-fill differently.
    The port keeps the last copy, as the JAX trainer does, so the pixel
    matches JAX and a frame rendered twice on several threads repeats."""
    ttr, jtr, splits = trained
    ds = splits["test"]
    torch.set_num_threads(max(4, torch.get_num_threads()))
    ttr.eval_f32_frames = jtr.eval_f32_frames = True
    try:
        imgs = [ttr.render_frame(ds.poses[0], ds.intrinsics, 24, 24)[0] for _ in range(4)]
        img_j, _ = jtr.render_frame(ds.poses[0], ds.intrinsics, 24, 24)
        pre = ttr._run_eval_prepass(torch.as_tensor(ds.poses[:1]),
                                    torch.as_tensor(ds.intrinsics), 24, 24,
                                    np.asarray(ttr.render_cfg.aabb, np.float32))
    finally:
        ttr.eval_f32_frames = jtr.eval_f32_frames = False
    for img in imgs[1:]:
        np.testing.assert_array_equal(img, imgs[0])
    p = int(pre["sorted_inds"][-1])
    assert pre["count"] == 24 * 24  # every pixel hits: the padded pixel is a hit
    np.testing.assert_allclose(imgs[0].reshape(-1, 3)[p], img_j.reshape(-1, 3)[p], atol=1e-5)
