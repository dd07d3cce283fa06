"""The port's CLIP towers and ``CLIPLoss`` against the JAX package's, at
``CLIPConfig.tiny()``: both embeddings after ``params_from_jax``,
``preprocess`` (up- and down-sampling, the edges included), the loss and
its gradient in the images, ``load_hf_clip`` on a random tiny
HuggingFace ``CLIPModel`` against HuggingFace and JAX, the errors, and
one guidance step with ``CLIPLoss`` against JAX's.

Tolerances, f32: the embeddings, the preprocessed pixels, the loss and
its image gradient to 1e-5 of the largest entry (sums in another order
through two pre-LN blocks); HuggingFace's embeddings to 1e-5 of theirs;
the guidance step as ``test_torch_train_step.py`` holds a step (the loss
to 1e-5 relative, each gradient to 1e-4 of its largest entry).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.models import clip as jclip
from ngp_tpu.training.clip_guidance import CLIPLoss as JCLIPLoss
from ngp_tpu_torch.models import clip as tclip
from ngp_tpu_torch.training.clip_guidance import CLIPLoss
from test_torch_renderer import one_torch_thread  # noqa: F401
from test_torch_train_step import (
    _CP_NC,
    _TURBO_RC,
    _check_step,
    _guidance_pose,
    _np,
    _scaled,
    _trainer_pair,
)

IDS = np.array([[1, 5, 9, 63, 0, 0, 0, 0]], np.int32)  # 63 = EOT (the largest id)


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny CLIP with every parameter moved off its initial value
    (biases and LayerNorm scales too), and the port's on the same weights."""
    cfg = jclip.CLIPConfig.tiny()
    model = jclip.CLIP(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, cfg.image_size, cfg.image_size, 3)),
                        jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32)),
        params)
    port = tclip.CLIP(tclip.CLIPConfig.tiny(), device="cpu")
    port.load_state_dict(tclip.params_from_jax(jax.tree.map(np.asarray, params)))  # strict
    return cfg, model, params, port


def test_config_matches_jax():
    import dataclasses

    for make in (lambda m: m.CLIPConfig(), lambda m: m.CLIPConfig.tiny()):
        assert dataclasses.asdict(make(tclip)) == dataclasses.asdict(make(jclip))
    np.testing.assert_array_equal(tclip.IMAGE_MEAN, jclip.IMAGE_MEAN)
    np.testing.assert_array_equal(tclip.IMAGE_STD, jclip.IMAGE_STD)


def test_embeddings_match_jax(pair):
    cfg, model, params, port = pair
    rng = np.random.default_rng(0)
    px = rng.normal(size=(3, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ids = rng.integers(0, 60, (3, 11)).astype(np.int32)
    ids[np.arange(3), [4, 10, 7]] = 63
    want_i = np.asarray(model.apply(params, jnp.asarray(px), method=jclip.CLIP.encode_image))
    want_t = np.asarray(model.apply(params, jnp.asarray(ids), method=jclip.CLIP.encode_text))
    with torch.no_grad():
        got_i = port.encode_image(torch.from_numpy(px)).numpy()
        got_t = port.encode_text(torch.from_numpy(ids)).numpy()
    assert got_i.shape == (3, cfg.embed_dim) and got_t.shape == (3, cfg.embed_dim)
    _scaled(got_i, want_i, 1e-5)
    _scaled(got_t, want_t, 1e-5)


@pytest.mark.parametrize("shape", [(2, 20, 20), (1, 72, 56), (1, 32, 32), (1, 13, 45)],
                         ids=["up", "down", "same", "mixed"])
def test_preprocess_matches_jax(shape):
    """jax.image.resize's bilinear antialiases when it shrinks; the port's
    F.interpolate(antialias=True) is held to it on every pixel."""
    cfg = jclip.CLIPConfig.tiny()
    x = np.random.default_rng(1).random(shape + (3,)).astype(np.float32)
    want = np.asarray(jclip.preprocess(jnp.asarray(x), cfg))
    got = tclip.preprocess(torch.from_numpy(x), tclip.CLIPConfig.tiny()).numpy()
    assert got.shape == (shape[0], cfg.image_size, cfg.image_size, 3)
    _scaled(got, want, 1e-5)
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], atol=1e-5)  # the edges
    np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]], atol=1e-5)


@pytest.mark.parametrize("size", [(2, 40, 40), (1, 16, 12)], ids=["down", "up"])
def test_clip_loss_and_image_gradient_match_jax(pair, size):
    cfg, model, params, port = pair
    jloss = JCLIPLoss("tiny", clip_cfg=cfg, params=params, token_ids=IDS)
    tloss = CLIPLoss("tiny", clip_cfg=tclip.CLIPConfig.tiny(), params=port.state_dict(),
                     token_ids=IDS, device="cpu")
    _scaled(tloss.text_features.numpy(), np.asarray(jloss.text_features), 1e-5)
    assert not tloss.text_features.requires_grad
    img = np.random.default_rng(2).random(size + (3,)).astype(np.float32)
    v, g = jax.value_and_grad(lambda x: jloss(x))(jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_(True)
    loss = tloss(x)
    loss.backward()
    lv = float(loss.detach())
    assert abs(lv - float(v)) <= 1e-5 * abs(float(v)) and -1.0 <= lv <= 1.0
    _scaled(x.grad.numpy(), np.asarray(g), 1e-5)
    assert all(p.grad is None for p in tloss.model.parameters())  # the towers are frozen


def test_clip_loss_needs_weights():
    with pytest.raises(RuntimeError, match="pretrained weights"):
        CLIPLoss("a chair", device="cpu")
    with pytest.raises(RuntimeError, match="pretrained weights"):
        CLIPLoss("a chair", clip_cfg=tclip.CLIPConfig.tiny(), token_ids=IDS, device="cpu")


def test_load_hf_clip_raises_without_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        tclip.load_hf_clip("checkout")


def test_load_hf_clip_matches_hf_and_jax(tmp_path):
    """A random tiny HuggingFace CLIPModel saved to disk (offline): the
    port's towers on its converted weights against HuggingFace's features
    and the JAX package's ``load_hf_clip``."""
    transformers = pytest.importorskip("transformers")
    # HF pools the text tower at the eos position, the towers at argmax(ids):
    # the tiny vocabulary's eos is its largest id, as EOT is in CLIP's
    tc = transformers.CLIPTextConfig(
        vocab_size=64, hidden_size=32, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=16, hidden_act="quick_gelu",
        eos_token_id=63, bos_token_id=62)
    vc = transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2,
        image_size=32, patch_size=8, hidden_act="quick_gelu")
    torch.manual_seed(0)
    hf = transformers.CLIPModel(
        transformers.CLIPConfig.from_text_vision_configs(tc, vc, projection_dim=16)).eval()
    path = str(tmp_path / "hf_clip")
    hf.save_pretrained(path)

    cfg, sd = tclip.load_hf_clip(path)
    assert cfg == tclip.CLIPConfig.tiny()
    port = tclip.CLIP(cfg, device="cpu")
    port.load_state_dict(sd)  # strict: every key mapped
    jcfg, jparams = jclip.load_hf_clip(path)
    jmodel = jclip.CLIP(jcfg)
    rng = np.random.default_rng(0)
    px = rng.random((2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 60, (2, 12)).astype(np.int64)
    ids[:, -1] = 63
    with torch.no_grad():
        ref_i = hf.get_image_features(pixel_values=torch.from_numpy(px.transpose(0, 3, 1, 2)))
        ref_t = hf.get_text_features(input_ids=torch.from_numpy(ids))
        got_i = port.encode_image(torch.from_numpy(px))
        got_t = port.encode_text(torch.from_numpy(ids))
    _scaled(got_i.numpy(), ref_i.numpy(), 1e-5)
    _scaled(got_t.numpy(), ref_t.numpy(), 1e-5)
    _scaled(got_i.numpy(),
            np.asarray(jmodel.apply(jparams, jnp.asarray(px), method=jclip.CLIP.encode_image)),
            1e-5)
    _scaled(got_t.numpy(),
            np.asarray(jmodel.apply(jparams, jnp.asarray(ids.astype(np.int32)),
                                    method=jclip.CLIP.encode_text)), 1e-5)


def test_clip_guidance_step_matches_jax(tmp_path, pair):
    """One random-pose guidance step scored by ``CLIPLoss`` (a 16 x 12 full
    frame, white background, JAX's noise; the frame upsampled to 32^2):
    the loss and every gradient, as ``test_guidance_step_matches_jax``."""
    cfg, model, params, port = pair
    tc = dict(iters=50, num_rays=1024, workspace=str(tmp_path), rand_pose=2)
    jtr, make_port = _trainer_pair(tmp_path, _TURBO_RC, _CP_NC, tc)
    jtr.guidance_loss = JCLIPLoss("x", clip_cfg=cfg, params=params, token_ids=IDS)
    pose = _guidance_pose()
    intr = np.array([16.0, 16.0, 6.0, 8.0], np.float32)
    rH, rW = 16, 12
    rng = jax.random.PRNGKey(4)
    batch = {"pose": jnp.asarray(pose), "intrinsics": jnp.asarray(intr),
             "image_h": jnp.zeros((rH,)), "image_w": jnp.zeros((rW,))}
    jstate, _, jmet = jax.jit(jtr.guidance_step)(jtr.state, jtr.aux, batch, rng)
    ttr = make_port()
    ttr.guidance_loss = CLIPLoss("x", clip_cfg=tclip.CLIPConfig.tiny(),
                                 params=port.state_dict(), token_ids=IDS, device="cpu")
    tmet = ttr.guidance_step({"pose": torch.from_numpy(pose), "intrinsics": torch.from_numpy(intr),
                              "rH": rH, "rW": rW},
                             {"noise": _np(jax.random.uniform(rng, (rH * rW,)))})
    _check_step(jstate, jmet, tmet, ttr.model)
