"""The PyTorch port imports on a CPU-only machine without JAX, the JAX
package, the JAX package's ``main_nerf.py`` or Triton, and its config
copy matches the JAX package's; its command line and ``chip_smoke.py``
exit non-zero without a CUDA device."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

import ngp_tpu.config as jax_config
import ngp_tpu_torch.config as torch_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "ngp_tpu_torch",
    "ngp_tpu_torch.config",
    "ngp_tpu_torch.ops.rays",
    "ngp_tpu_torch.ops.freq",
    "ngp_tpu_torch.ops.sh",
    "ngp_tpu_torch.ops.activation",
    "ngp_tpu_torch.ops.cpgrid",
    "ngp_tpu_torch.ops.hashgrid",
    "ngp_tpu_torch.ops.losses",
    "ngp_tpu_torch.ops.morton",
    "ngp_tpu_torch.ops.kernels",
    "ngp_tpu_torch.ops.kernels.build",
    "ngp_tpu_torch.ops.kernels.cp",
    "ngp_tpu_torch.ops.kernels.march",
    "ngp_tpu_torch.ops.kernels.fused_mlp",
    "ngp_tpu_torch.ops.kernels.hashgrid",
    "ngp_tpu_torch.ops.kernels.scatter",
    "ngp_tpu_torch.models.mlp",
    "ngp_tpu_torch.models.encoders",
    "ngp_tpu_torch.models.nerf",
    "ngp_tpu_torch.models.occupancy",
    "ngp_tpu_torch.models.renderer",
    "ngp_tpu_torch.data.raysampler",
    "ngp_tpu_torch.data.nerf_dataset",
    "ngp_tpu_torch.data.synthetic",
    "ngp_tpu_torch.data.mesh",
    "ngp_tpu_torch.native",
    "ngp_tpu_torch.utils.color",
    "ngp_tpu_torch.utils.png",
    "ngp_tpu_torch.training.metrics",
    "ngp_tpu_torch.training.lpips",
    "ngp_tpu_torch.training.state",
    "ngp_tpu_torch.training.checkpoints",
    "ngp_tpu_torch.training.trainer",
    "ngp_tpu_torch.training.nerf",
    "ngp_tpu_torch.training.nerf_grid",
    "ngp_tpu_torch.training.clip_guidance",
    "ngp_tpu_torch.main_nerf",
    "chip_smoke",
]


def test_every_module_imports_without_jax_or_triton():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {MODULES!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "ngp_tpu", "triton", "main_nerf"))
        assert not bad, bad
        from ngp_tpu_torch.ops.kernels import build
        assert build._lib is None  # the kernel library loads at first launch
        from ngp_tpu_torch import native
        assert native._lib is None  # so does the marching library
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["RenderConfig", "NetworkConfig", "TrainConfig"])
def test_config_matches_jax_package(name):
    a, b = getattr(jax_config, name), getattr(torch_config, name)
    fa = [(f.name, f.type, f.default) for f in dataclasses.fields(a)]
    fb = [(f.name, f.type, f.default) for f in dataclasses.fields(b)]
    assert fa == fb
    assert a.__dataclass_params__.frozen and b.__dataclass_params__.frozen


@pytest.mark.parametrize("bound", [0.5, 1.0, 2.0, 3.0])
def test_config_properties_match(bound):
    a = jax_config.RenderConfig(bound=bound)
    b = torch_config.RenderConfig(bound=bound)
    assert a.cascades == b.cascades
    assert a.aabb == b.aabb


@pytest.mark.parametrize("argv", [["chip_smoke.py"], ["-m", "ngp_tpu_torch.main_nerf", "scene", "-O"]])
def test_card_entry_points_fail_without_cuda(tmp_path, argv):
    import torch

    if torch.cuda.is_available():
        pytest.skip("the machine has a CUDA device")
    res = subprocess.run([sys.executable] + argv, cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, HOME=str(tmp_path)))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "CUDA" in res.stdout + res.stderr
