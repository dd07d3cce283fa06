"""The PyTorch port imports on a CPU-only machine without JAX, the JAX
package, the JAX package's mains or Triton, and its config copy matches
the JAX package's; its command lines and ``chip_smoke.py`` exit non-zero
without a CUDA device."""

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
    "ngp_tpu_torch.tracing",
    "ngp_tpu_torch.ops.rays",
    "ngp_tpu_torch.ops.freq",
    "ngp_tpu_torch.ops.sh",
    "ngp_tpu_torch.ops.activation",
    "ngp_tpu_torch.ops.cpgrid",
    "ngp_tpu_torch.ops.hashgrid",
    "ngp_tpu_torch.ops.losses",
    "ngp_tpu_torch.ops.morton",
    "ngp_tpu_torch.ops.interp",
    "ngp_tpu_torch.ops.brickgrid",
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
    "ngp_tpu_torch.models.sdf",
    "ngp_tpu_torch.models.tensorf",
    "ngp_tpu_torch.models.ccnerf",
    "ngp_tpu_torch.models.dnerf",
    "ngp_tpu_torch.models.clip",
    "ngp_tpu_torch.data.raysampler",
    "ngp_tpu_torch.data.nerf_dataset",
    "ngp_tpu_torch.data.synthetic",
    "ngp_tpu_torch.data.mesh",
    "ngp_tpu_torch.data.sdf_dataset",
    "ngp_tpu_torch.native",
    "ngp_tpu_torch.utils.color",
    "ngp_tpu_torch.utils.png",
    "ngp_tpu_torch.utils.vis",
    "ngp_tpu_torch.viewer",
    "ngp_tpu_torch.viewer_web",
    "ngp_tpu_torch.training.metrics",
    "ngp_tpu_torch.training.lpips",
    "ngp_tpu_torch.training.state",
    "ngp_tpu_torch.training.checkpoints",
    "ngp_tpu_torch.training.trainer",
    "ngp_tpu_torch.training.nerf",
    "ngp_tpu_torch.training.nerf_grid",
    "ngp_tpu_torch.training.clip_guidance",
    "ngp_tpu_torch.training.sdf",
    "ngp_tpu_torch.training.tensorf",
    "ngp_tpu_torch.training.ccnerf",
    "ngp_tpu_torch.training.dnerf",
    "ngp_tpu_torch.parallel",
    "ngp_tpu_torch.parallel.mesh",
    "ngp_tpu_torch.parallel.collectives",
    "ngp_tpu_torch.main_nerf",
    "ngp_tpu_torch.main_sdf",
    "ngp_tpu_torch.main_tensoRF",
    "ngp_tpu_torch.main_CCNeRF",
    "ngp_tpu_torch.main_dnerf",
    "chip_smoke",
]


def test_every_module_imports_without_jax_or_triton():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {MODULES!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "ngp_tpu", "triton", "main_nerf",
                                            "main_sdf", "main_tensoRF", "main_CCNeRF",
                                            "main_dnerf", "transformers",
                                            "matplotlib", "tensorboardX"))
        assert not bad, bad
        from ngp_tpu_torch.ops.kernels import build
        assert build._lib is None  # the kernel library loads at first launch
        from ngp_tpu_torch import native
        assert not native._libs  # so do the marching and SDF libraries
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


@pytest.mark.parametrize("argv", [["chip_smoke.py"], ["-m", "ngp_tpu_torch.main_nerf", "scene", "-O"],
                                  ["-m", "ngp_tpu_torch.main_sdf", "sphere"],
                                  ["-m", "ngp_tpu_torch.main_tensoRF", "scene", "-O"],
                                  ["-m", "ngp_tpu_torch.main_CCNeRF", "scene", "-O"],
                                  ["-m", "ngp_tpu_torch.main_dnerf", "scene", "-O"],
                                  ["-m", "ngp_tpu_torch.main_nerf", "scene", "-O", "--gui"],
                                  ["-m", "ngp_tpu_torch.main_tensoRF", "scene", "-O", "--gui"],
                                  ["-m", "ngp_tpu_torch.main_CCNeRF", "scene", "-O", "--gui"],
                                  ["-m", "ngp_tpu_torch.main_dnerf", "scene", "-O", "--gui"]])
def test_card_entry_points_fail_without_cuda(tmp_path, argv):
    import torch

    if torch.cuda.is_available():
        pytest.skip("the machine has a CUDA device")
    res = subprocess.run([sys.executable] + argv, cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, HOME=str(tmp_path)))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "CUDA" in res.stdout + res.stderr
