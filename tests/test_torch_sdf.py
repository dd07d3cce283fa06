"""The port's SDF slice against the JAX package on the same inputs: the
mesh loaders (files JAX's ``save_mesh`` writes), ``normalize_mesh``,
``sample_surface``, ``icosphere``, ``SDFDataset`` batches for a seed,
the ``MeshSDF`` oracle, the ``SDFNetwork`` forward (f32 and bf16, with
and without skips and ``clip_sdf``), one ``SDFTrainer`` step, the
command line's parser, and a small ``main_sdf.main`` run on the CPU with
its checkpoint round trip.

Tolerances. Host numpy (meshes, sampling, batches, labels): bit-equal.
The network: f32 to 1e-5, bf16 to 2e-2 (a flipped bf16 rounding of a
hidden unit). The step: the loss to 1e-5 relative, every gradient to
1e-4 of its largest entry, and the parameters after Adam to 1e-5 where
the gradient is at least 1e-4 of its largest entry (below that its sign,
which sets Adam's first update of lr, is a matter of summation order).
The mesh of the CPU run: the median vertex radius within JAX's test
tolerance (0.1) of the normalised sphere's 0.95 / sqrt(3).
"""

import argparse
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.data import mesh as jmesh
from ngp_tpu.data.sdf_dataset import SDFDataset as JSDFDataset
from ngp_tpu.models.sdf import SDFNetwork as JSDFNetwork
from ngp_tpu.native import MeshSDF as JMeshSDF
from ngp_tpu.ops.losses import mape_loss as jmape_loss
from ngp_tpu.training.sdf import SDFTrainer as JSDFTrainer
from ngp_tpu_torch import main_sdf as tmain
from ngp_tpu_torch.data import mesh as tmesh
from ngp_tpu_torch.data.sdf_dataset import SDFDataset as TSDFDataset
from ngp_tpu_torch.models.sdf import SDFNetwork as TSDFNetwork
from ngp_tpu_torch.models.sdf import params_from_jax
from ngp_tpu_torch.native import MeshSDF as TMeshSDF
from ngp_tpu_torch.training.sdf import SDFTrainer as TSDFTrainer
from test_torch_renderer import one_torch_thread  # noqa: F401
from test_torch_train_step import _scaled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPHERE_R = 0.95 / np.sqrt(3)


class _Parser(Exception):
    pass


def jax_main_parser(monkeypatch, script):
    """The ``ArgumentParser`` that the JAX package's ``<script>``'s ``main``
    builds (its parser is local to ``main``): the first ``parse_args``
    raises with it."""
    def grab(self, *args, **kwargs):
        raise _Parser(self)

    spec = importlib.util.spec_from_file_location(f"jax_{script[:-3]}",
                                                  os.path.join(REPO, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parser) as got:
        mod.main()
    monkeypatch.undo()
    return got.value.args[0]


def parser_actions(parser):
    keys = ("option_strings", "dest", "default", "type", "choices", "nargs", "const",
            "required", "help")
    return [(type(a).__name__,) + tuple(getattr(a, k) for k in keys) for a in parser._actions]


# ---------------------------------------------------------------------------
# host numpy: meshes, sampling, the dataset and the oracle
# ---------------------------------------------------------------------------


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("subdiv", [0, 2, 3])
def test_icosphere_and_normalize_bit_equal(subdiv):
    jv, jf = jmesh.icosphere(subdiv=subdiv, radius=1.3)
    tv, tf = tmesh.icosphere(subdiv=subdiv, radius=1.3)
    _eq(tv, jv)
    _eq(tf, jf)
    _eq(tmesh.normalize_mesh(tv * np.float32(2.0) + 0.25), jmesh.normalize_mesh(jv * 2.0 + 0.25))


@pytest.mark.parametrize("ext", [".obj", ".ply"])
def test_load_mesh_reads_what_jax_writes(tmp_path, ext):
    v, f = jmesh.icosphere(subdiv=2)
    v = v * np.float32(0.7) + np.float32(0.1)
    path = str(tmp_path / f"m{ext}")
    jmesh.save_mesh(path, v, f)
    tv, tf = tmesh.load_mesh(path)
    jv, jf = jmesh.load_mesh(path)
    _eq(tv, jv)
    _eq(tf, jf)


def test_load_binary_ply_and_polygons(tmp_path):
    """A binary_little_endian PLY with an extra property and a quad, and
    an OBJ with a quad, slashes and negative indices: both fan-triangulated."""
    import struct

    path = str(tmp_path / "b.ply")
    verts = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    with open(path, "wb") as fh:
        fh.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
                 b"property float x\nproperty float y\nproperty float z\n"
                 b"property uchar red\nelement face 2\n"
                 b"property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            fh.write(struct.pack("<fffB", *v, 7))
        fh.write(struct.pack("<B3i", 3, 0, 1, 2))
        fh.write(struct.pack("<B4i", 4, 1, 2, 3, 4))
    _eq(tmesh.load_mesh(path)[0], jmesh.load_mesh(path)[0])
    _eq(tmesh.load_mesh(path)[1], jmesh.load_mesh(path)[1])
    obj = str(tmp_path / "q.obj")
    with open(obj, "w") as fh:
        fh.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2/2 3/3 4/4\nf -1 -2 -3\n")
    for a, b in zip(tmesh.load_mesh(obj), jmesh.load_mesh(obj)):
        _eq(a, b)


def test_sample_surface_bit_equal():
    v, f = jmesh.icosphere(subdiv=3)
    got = tmesh.sample_surface(v, f, 5000, np.random.default_rng(4))
    want = jmesh.sample_surface(v, f, 5000, np.random.default_rng(4))
    _eq(got, want)


@pytest.mark.parametrize("clip_sdf", [None, 0.05])
def test_dataset_batches_bit_equal(clip_sdf):
    v, f = jmesh.icosphere(subdiv=3)
    kw = dict(vertices=v, faces=f, size=2, num_samples=4096, clip_sdf=clip_sdf, seed=3)
    jds, tds = JSDFDataset(**kw), TSDFDataset(**kw)
    assert len(tds) == len(jds) == 2
    for jb, tb in zip(jds, tds):
        _eq(tb["points"], jb["points"])
        _eq(tb["sdfs"], jb["sdfs"])
    assert (tb["sdfs"][:2048] == 0).all() and (tb["sdfs"][2048:] != 0).any()


def test_mesh_sdf_oracle_equal():
    v, f = jmesh.icosphere(subdiv=3)
    v = jmesh.normalize_mesh(v)
    pts = np.random.default_rng(5).uniform(-1, 1, size=(4096, 3)).astype(np.float32)
    got, want = TMeshSDF(v, f)(pts), JMeshSDF(v, f)(pts)
    _eq(got, want)
    r = np.linalg.norm(pts, axis=-1)
    assert (np.sign(got) == np.sign(r - SPHERE_R))[np.abs(r - SPHERE_R) > 0.02].all()


@pytest.mark.parametrize("bad", ["vertices", "faces", "index", "points"])
def test_mesh_sdf_refuses_malformed_input(bad):
    """The oracle checks shapes and face indices before native code reads
    the buffers."""
    v, f = jmesh.icosphere(subdiv=1)
    pts = np.zeros((4, 3), np.float32)
    if bad == "vertices":
        v = v[:, :2]
    elif bad == "faces":
        f = f.reshape(-1)
    elif bad == "index":
        f = f.copy()
        f[0, 0] = len(v)
    else:
        pts = pts.reshape(-1)
    with pytest.raises(ValueError):
        TMeshSDF(v, f)(pts)


# ---------------------------------------------------------------------------
# the network and one train step
# ---------------------------------------------------------------------------


def _pair(use_bf16=False, skips=(), clip_sdf=None, num_layers=3):
    jm = JSDFNetwork(num_layers=num_layers, skips=skips, clip_sdf=clip_sdf, use_bf16=use_bf16)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((8, 3)))
    tm = TSDFNetwork(num_layers=num_layers, skips=skips, clip_sdf=clip_sdf, use_bf16=use_bf16,
                     device="cpu")
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    assert set(sd) == {k for k, _ in tm.named_parameters()}
    tm.load_state_dict(sd)
    return jm, params, tm


def _points(n=3000, seed=6):
    """Points in [-1.1, 1.1]^3 (some outside the grid), the table redrawn
    by the caller so the features move the output."""
    return np.random.default_rng(seed).uniform(-1.1, 1.1, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("skips,clip_sdf", [((), None), ((1,), None), ((0, 2), 0.1)])
def test_sdf_network_matches_jax(use_bf16, skips, clip_sdf):
    jm, params, tm = _pair(use_bf16, skips, clip_sdf, num_layers=4)
    enc = next(k for k in params["params"] if not k.startswith("dense_"))
    emb = params["params"][enc]["embeddings"]
    table = np.random.default_rng(7).normal(scale=0.5, size=emb.shape).astype(np.float32)
    params = jax.tree.map(lambda a: a, params)
    params["params"][enc]["embeddings"] = jnp.asarray(table)
    with torch.no_grad():
        tm.encoder.embeddings.copy_(torch.from_numpy(table))
    x = _points()
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (len(x), 1) and got.dtype == np.float32
    tol = 2e-2 if use_bf16 else 1e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    if clip_sdf is not None:
        assert np.abs(got).max() <= clip_sdf and (np.abs(got) == clip_sdf).any()


def test_train_step_matches_jax(tmp_path):
    """One f32 step on one dataset batch: the MAPE, every gradient, and
    the parameters after Adam (both at lr 1e-3)."""
    v, f = jmesh.icosphere(subdiv=3)
    batch = JSDFDataset(vertices=v, faces=f, num_samples=2048, seed=1).sample_batch()
    jm, params, tm = _pair()
    jtr = JSDFTrainer(jm, workspace=str(tmp_path / "j"), lr=1e-3, max_steps=100,
                      use_tensorboard=False)
    jtr.ensure_initialized()
    jtr.state = jtr.state.replace(params=params, ema_params=params,
                                  opt_state=jtr.tx.init(params))
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    jgrads = jax.grad(lambda p: jmape_loss(jm.apply(p, jbatch["points"]),
                                           jbatch["sdfs"]))(params)
    jstate, _, jmet = jtr.train_step(jtr.state, None, jbatch, jax.random.PRNGKey(0))

    ttr = TSDFTrainer(tm, workspace=str(tmp_path / "t"), lr=1e-3, max_steps=100)
    tmet = ttr.train_step(batch)
    loss = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - loss) <= 1e-5 * loss and loss > 0
    jg = params_from_jax(jax.tree.map(np.asarray, jgrads))
    jp = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for name, p in tm.named_parameters():
        g = jg[name].numpy()
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        _scaled(p.grad, g, 1e-4)
        sure = np.abs(g) >= 1e-4 * np.abs(g).max()
        assert sure.sum() > 0
        np.testing.assert_allclose(p.detach().numpy()[sure], jp[name].numpy()[sure], atol=1e-5)
    with torch.no_grad():
        x = torch.from_numpy(batch["points"][:64])
        ev = ttr.eval_step({"points": batch["points"], "sdfs": batch["sdfs"]})
        assert np.isfinite(float(ev["loss"])) and ttr.predict_sdf(x.numpy()).shape == (64,)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_parser_pinned_to_main_sdf(monkeypatch):
    want = parser_actions(jax_main_parser(monkeypatch, "main_sdf.py"))
    got = parser_actions(tmain.build_parser())
    assert [a[2] for a in got] == [a[2] for a in want]
    for g, w in zip(got, want):
        assert g == w, g[2]


def test_main_runs_and_resumes_on_the_cpu(tmp_path, monkeypatch):
    """``sphere --epochs 1`` at 8192 points a batch and a 32^3 mesh: the
    loss is finite and the mesh lies on the sphere; then ``--test`` from
    the checkpoint writes the same mesh. The hash levels are cut to 2^15
    rows (from 2^19) so that 100 Adam steps take seconds on one thread."""
    from ngp_tpu_torch.models import sdf as tsdf

    get_encoder = tsdf.get_encoder
    monkeypatch.setattr(tsdf, "get_encoder",
                        lambda *a, **kw: get_encoder(*a, log2_hashmap_size=15, **kw))
    ws = str(tmp_path / "ws")
    argv = ["sphere", "--workspace", ws, "--epochs", "1", "--num_samples", "8192",
            "--mesh_resolution", "32"]
    tr = tmain.main(argv, device="cpu")
    assert tr.global_step == 100 and tr.epoch == 1
    assert np.isfinite(tr.stats["loss"]).all()
    with open(tr.last_mesh_path) as fh:
        first = fh.read()
    v, f = tmesh.load_mesh(tr.last_mesh_path)
    assert len(v) > 100 and len(f) > 100
    assert abs(float(np.median(np.linalg.norm(v, axis=-1))) - SPHERE_R) < 0.1
    pts = _points(64)
    before = tr.predict_sdf(pts)

    back = tmain.main(argv + ["--test"], device="cpu")
    assert back.global_step == 100 and back.last_restore_skipped == []
    np.testing.assert_array_equal(back.predict_sdf(pts), before)
    with open(back.last_mesh_path) as fh:
        assert fh.read() == first


def test_main_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["sphere"])
