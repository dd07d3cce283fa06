"""ngp_tpu_torch — the PyTorch and CUDA port of ``ngp_tpu``.

The JAX package ``ngp_tpu`` stays the reference; this package computes
the same functions with PyTorch tensors, and every Pallas kernel on its
path is a CUDA kernel written for Hopper (``ops/kernels/csrc``). The
layout mirrors ``ngp_tpu``:

- ``ngp_tpu_torch.ops``      — rays, encoders, activations, CP grid, kernels
- ``ngp_tpu_torch.models``   — MLP, encoders, NeRF network, occupancy grid
- ``ngp_tpu_torch.data``     — ray generation, in-memory frames, the mesh writer
- ``ngp_tpu_torch.training`` — the NeRF trainers and the image metrics
- ``ngp_tpu_torch.native``   — marching tetrahedra (host C++ over ctypes)
- ``ngp_tpu_torch.utils``    — color spaces, the PNG codec

Importing the package needs only ``torch`` and ``numpy``: the kernel
library is built and loaded at its first launch, and a CPU tensor takes
each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
