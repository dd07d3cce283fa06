"""Tiny versions of the benchmark's cells for the CPU tests: the cells'
own configuration files with the sizes cut so a CPU step takes well
under a second."""

from __future__ import annotations

import copy

from benchmark import harness

TINY_NETWORK = {
    "cpgrid": {"cp_resolutions": [16, 32], "cp_rank": 8, "cp_freq_degree": 2},
    "hashgrid": {"num_levels": 4, "log2_hashmap_size": 12},
}
TINY_RENDER = {
    True: {"grid_size": 16, "max_steps": 64, "max_samples_per_ray": 16,
           "coarse_candidates": 32, "crossing_slots": 8},
    False: {"grid_size": 16, "max_steps": 64, "max_samples_per_ray": 16},
}
TINY_TRAFFIC = {"rays_per_step": 256, "warmup_steps": 6, "checked_steps": 3,
                "profiled_steps": 4,
                "scene": {"train_views": 3, "height": 24, "width": 24, "fov_deg": 50.0,
                          "radius": 2.2, "samples_per_ray": 64,
                          "view_seed": 0}}


def tiny_cell(name: str, bf16: bool = True) -> harness.Cell:
    """The named cell of BENCHMARK.json at a CPU test's size."""
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["network"].update(TINY_NETWORK[cfg["network"]["encoding"]], use_bf16=bf16)
    cfg["render"].update(TINY_RENDER[cfg["render"]["turbo"]])
    traffic = dict(copy.deepcopy(cell.traffic), **copy.deepcopy(TINY_TRAFFIC))
    return harness.Cell(name=name, chips=cell.chips, config=cfg, traffic=traffic,
                        data=copy.deepcopy(cell.data), end_to_end=cell.end_to_end,
                        per_layer=cell.per_layer)
