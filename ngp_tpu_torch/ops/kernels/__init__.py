"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

- ``cp.cp_density_fwd``      replaces ``ngp_tpu/ops/pallas/cp_kernels.py:cp_density`` (forward)
- ``cp.cp_sigma_rgb``        replaces ``ngp_tpu/ops/pallas/cp_kernels.py:cp_sigma_rgb``
- ``march.coarse_lookup_bits`` replaces ``ngp_tpu/ops/pallas/march_kernels.py:coarse_lookup_bits``

Each wrapper takes its plain PyTorch version for a CPU tensor and
launches its kernel for a CUDA tensor; there is no fallback between the
two. ``LAUNCHES`` counts the kernel launches of each wrapper, so a run
can show that its path went through the kernels.
"""

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "cp_density_fwd": 0,
    "cp_sigma_rgb": 0,
    "coarse_lookup_bits": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)
