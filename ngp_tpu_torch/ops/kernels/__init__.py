"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

- ``cp.cp_density_fwd``      replaces ``ngp_tpu/ops/pallas/cp_kernels.py:cp_density`` (forward;
  ``residuals=True`` also writes the feats/h1 rows its backward reads)
- ``cp.cp_bwd_banks``        replaces ``ngp_tpu/ops/pallas/cp_kernels.py:_cp_bwd_banks``
- ``cp.cp_sigma_rgb``        replaces ``ngp_tpu/ops/pallas/cp_kernels.py:cp_sigma_rgb``
- ``march.march_turbo``      replaces the turbo march around
  ``ngp_tpu/ops/pallas/march_kernels.py:coarse_lookup_bits`` (``models/occupancy.py:
  march_rays_turbo``, one launch a march)
- ``march.ray_prepass_kernel`` replaces the eval prepass around the same Pallas kernel
  (``models/occupancy.py:ray_prepass``, one launch a chunk of rays)
- ``march.coarse_lookup_bits`` replaces ``ngp_tpu/ops/pallas/march_kernels.py:coarse_lookup_bits``
  alone; no path calls it
- ``cp.cp_encode_fwd``       replaces ``ngp_tpu/ops/pallas/cp_kernels.py:cp_encode`` (forward;
  ``cp.CPEncode`` adds its backward through ``cp_bwd_banks``)
- ``fused_mlp.fused_mlp``    replaces ``ngp_tpu/ops/pallas/fused_mlp.py:fused_mlp``;
  ``fused_mlp.mlp_bf16_fwd`` runs the same kernel with a bf16 output, and
  ``fused_mlp.mlp_bf16_bwd`` (no Pallas counterpart: the JAX package leaves
  the MLPs' VJP to XLA) its backward; ``fused_mlp.FusedMLP`` trains every
  bf16 ``models.mlp.MLP`` on the card through the two
- ``scatter.scatter_add_rows`` replaces ``scripts/perf_probe2_r2.py:scatter_pallas`` (a row
  scatter-add); no path calls it (the brick grid's table gradient is
  ``brickgrid.brick_table_grad``); ``scatter.GatherRows``' backward (the plain brick
  encoding's table gradient) adds through it
- ``scatter.scatter_add_taps`` replaces no Pallas kernel: the factor gradient of the
  bilinear taps (TensoRF, CCNeRF), which the JAX package leaves to XLA's VJP of
  ``jnp.take`` (``ngp_tpu/ops/interp.py:39``, ``:62``); ``interp.FactorTaps`` adds it
- ``scatter.sample_taps_fwd`` replaces no Pallas kernel: the bilinear taps' forward
  (TensoRF, CCNeRF), which the JAX package leaves to XLA (``ngp_tpu/ops/interp.py:27``,
  ``:45``); ``interp.FactorTaps`` samples through it. Both taps kernels read and write
  factors held cell-major (``scatter.cell_major``)
- ``brickgrid.brick_encode_fwd``, ``brickgrid.brick_table_grad`` and
  ``brickgrid.brick_encode_bwd`` (in ``ops/brickgrid.py``) replace no Pallas kernel: the
  brick grid's encoding, its table gradient and the cotangent of the rows it reads,
  which the JAX package leaves to XLA (``ngp_tpu/ops/brickgrid.py:143``);
  ``brickgrid.BrickEncode`` runs the first two. No path runs ``brick_encode_bwd``: with
  ``scatter_add_rows`` it made the table gradient until ``brick_table_grad`` fused them
- ``hashgrid.grid_encode_fwd`` and ``hashgrid.grid_encode_bwd`` replace no Pallas
  kernel: the JAX package leaves the hash-grid encoder and its VJP to XLA
  (``ngp_tpu/ops/hashgrid.py:203-204``); ``hashgrid.GridEncode`` adds the backward
  through ``grid_encode_bwd``, which adds into the table gradient by atomics
  itself (it does not go through ``scatter_add_rows``), and through
  ``hashgrid.grid_encode_bwd_x``, the VJP in the points that JAX's autodiff
  of ``grid_encode`` gives (``hashgrid.py:161-209``; D-NeRF trains through it)

Each wrapper takes its plain PyTorch version for a CPU tensor and
launches its kernel for a CUDA tensor; there is no fallback between the
two. ``LAUNCHES`` counts the kernel launches of each wrapper, so a run
can show that its path went through the kernels;
``cp_density_fwd_residuals`` counts the launches of ``cp_density_fwd``
that wrote residuals, ``cp_density_fwd_tc`` and ``cp_sigma_rgb_tc``
the launches of the two heads that took the bf16 tensor-core kernels,
``cp_density_fwd_tf32x3`` and ``cp_sigma_rgb_tf32x3`` those that took
the f32 ones (3xTF32; heads the tensor-core tiles take; all four count
under ``cp_density_fwd`` and ``cp_sigma_rgb`` too), ``fused_mlp_tc``
those of ``fused_mlp`` (``mlp_bf16_fwd``'s included) that took its
tensor-core kernel, ``fused_mlp_bwd`` those of ``mlp_bf16_bwd``,
``grid_encode_fwd_2d`` and
``grid_encode_bwd_2d`` the grid kernels' launches on 2-D points (the
background net's encoder), and ``grid_encode_fwd_4d``,
``grid_encode_bwd_4d`` and ``grid_encode_bwd_x_4d`` those on 4-D points
(D-NeRF's hyper grid); they count under ``grid_encode_fwd``,
``grid_encode_bwd`` and ``grid_encode_bwd_x`` too.
``taps_coords_grad_plain`` and ``brick_x_grad_plain`` count no kernel:
the calls of the taps' gradient in the points and of the brick grid's
gradient in x, which run autograd of the plain versions on every device
(no path asks for either).
"""

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "cp_density_fwd": 0,
    "cp_sigma_rgb": 0,
    "coarse_lookup_bits": 0,
    "march_turbo": 0,
    "ray_prepass": 0,
    "cp_bwd_banks": 0,
    "cp_density_fwd_residuals": 0,
    "cp_density_fwd_tc": 0,
    "cp_sigma_rgb_tc": 0,
    "cp_density_fwd_tf32x3": 0,
    "cp_sigma_rgb_tf32x3": 0,
    "cp_encode_fwd": 0,
    "fused_mlp": 0,
    "fused_mlp_tc": 0,
    "fused_mlp_bwd": 0,
    "grid_encode_fwd": 0,
    "grid_encode_bwd": 0,
    "grid_encode_fwd_2d": 0,
    "grid_encode_bwd_2d": 0,
    "grid_encode_bwd_x": 0,
    "grid_encode_fwd_4d": 0,
    "grid_encode_bwd_4d": 0,
    "grid_encode_bwd_x_4d": 0,
    "scatter_add_rows": 0,
    "scatter_add_taps": 0,
    "sample_taps_fwd": 0,
    "brick_encode_fwd": 0,
    "brick_encode_bwd": 0,
    "brick_table_grad": 0,
    "taps_coords_grad_plain": 0,
    "brick_x_grad_plain": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)
