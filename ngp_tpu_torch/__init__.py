"""ngp_tpu_torch — the PyTorch and CUDA port of ``ngp_tpu``.

The JAX package ``ngp_tpu`` stays the reference; this package computes
the same functions with PyTorch tensors, and every Pallas kernel on its
path is a CUDA kernel written for Hopper (``ops/kernels/csrc``). The
layout mirrors ``ngp_tpu``:

- ``ngp_tpu_torch.ops``      — rays, encoders, activations, CP grid, losses, Morton
  codes, bilinear factor sampling, kernels
- ``ngp_tpu_torch.models``   — MLP, encoders, NeRF network, occupancy grid, SDF
  network, TensoRF (VM and CP)
- ``ngp_tpu_torch.data``     — ray generation, the transforms.json loaders, the
  synthetic scene, mesh IO and sampling, the SDF dataset
- ``ngp_tpu_torch.training`` — the generic loop, the NeRF, SDF and TensoRF trainers,
  the guidance loss and the image metrics
- ``ngp_tpu_torch.main_nerf``, ``main_sdf``, ``main_tensoRF`` — the command lines
  (``python -m ngp_tpu_torch.main_nerf`` and so on)
- ``ngp_tpu_torch.native``   — marching tetrahedra and the mesh SDF oracle (host C++
  over ctypes)
- ``ngp_tpu_torch.utils``    — color spaces, the PNG codec
- ``ngp_tpu_torch.tracing``  — the spans and counters a torch profiler run records

Importing the package needs only ``torch`` and ``numpy``: the kernel
library is built and loaded at its first launch, a CPU tensor takes
each kernel's plain PyTorch version, and the loaders import cv2 and
scipy when they run.
"""

__version__ = "0.1.0"
