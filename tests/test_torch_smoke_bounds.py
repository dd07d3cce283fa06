"""The bounds ``chip_smoke.py`` gives the CP heads at the main path's
shapes, counted from the shapes alone (meta tensors, no data): f32
products at the 3xTF32 rate (three TF32 products each, 495 / 3 TFLOP/s,
the least the card needs for f32-accurate products), bf16 products at the
bf16 tensor-core rate (989 TFLOP/s), the lerps on the CUDA cores (67
TFLOP/s) and the bytes over 3.35 TB/s, the larger of the three."""

import pytest
import torch

import chip_smoke as cs

# turbo-hq: 5 banks of rank 128, frequency degree 6, sigma 679-64-16,
# colour 31-64-64-3 (SH degree 4)
RES, RANK, FD, H1, OUT = (128, 256, 512, 1024, 2048), 128, 6, 64, 16
COLOR = (31, 64, 64, 3)


def _head(dtype):
    meta = dict(device="meta", dtype=dtype)
    factors = tuple(torch.empty((3, r, RANK), **meta) for r in RES)
    D = len(RES) * RANK + 3 * (1 + 2 * FD)
    w1 = torch.empty((D, H1), **meta)
    w2 = torch.empty((H1, OUT), **meta)
    color = tuple(torch.empty((a, b), **meta) for a, b in zip(COLOR, COLOR[1:]))
    return factors, w1, w2, color


def _rows(M):
    return torch.empty((M, 3), device="meta")


# (dtype, head, rows, bound ms to 4 places, what bounds it): the refresh
# chunk, the train step with residuals, the eval chunk
CASES = [
    (torch.float32, "density", 131_072, 0.0707, "operations"),
    (torch.float32, "residuals", 98_304, 0.0913, "bytes"),
    (torch.float32, "radiance", 24_576, 0.0151, "operations"),
    (torch.bfloat16, "density", 131_072, 0.0175, "operations"),
    (torch.bfloat16, "residuals", 98_304, 0.0468, "bytes"),
    (torch.bfloat16, "radiance", 24_576, 0.0033, "operations"),
]


@pytest.mark.parametrize("dtype,head,M,want_ms,want_by", CASES)
def test_head_bound(dtype, head, M, want_ms, want_by):
    factors, w1, w2, color = _head(dtype)
    pos = _rows(M)
    if head == "radiance":
        work = cs.sigma_rgb_work(pos, _rows(M), factors, w1, w2, color)
    else:
        work = cs.density_work(pos, factors, w1, w2, residuals=head == "residuals")
    ms, by = cs.bound(*work)
    assert (round(ms, 4), by) == (want_ms, want_by)


def test_f32_products_count_at_the_3xtf32_rate():
    """The f32 density head's 11.66 GFLOP of products at 131,072 rows go to
    the 3xTF32 term of ``bound``, none to the bf16 or CUDA-core terms."""
    factors, w1, w2, _ = _head(torch.float32)
    n_bytes, bf16_flops, core_flops, tf32x3_flops = cs.density_work(_rows(131_072), factors,
                                                                    w1, w2)
    assert bf16_flops == 0
    assert tf32x3_flops == 131_072 * 2 * (679 * 64 + 64 * 16)
    assert core_flops == 14 * 131_072 * len(RES) * RANK
    assert cs.TF32X3_TENSOR_RATE == pytest.approx(165e12)
    assert cs.bound(0, tf32x3_flops=tf32x3_flops)[0] == pytest.approx(
        tf32x3_flops / 165e12 * 1e3)


@pytest.mark.parametrize("live_share", [1.0, 0.5, 0.0])
def test_brick_work_counts_the_live_items_distinct_stencil_sectors(live_share):
    """``brick_work``'s bytes on a small brick grid: x, each distinct 32-byte
    sector of the 8 stencil cells of the (point, level)s inside the box and
    marked live (all where ``live`` is None), and the bytes passed in,
    against a count of the cells' sectors one by one."""
    from ngp_tpu_torch.ops import brickgrid as bg

    cfg = bg.BrickGridConfig(num_levels=3, level_dim=4, base_resolution=4, log2_hashmap_size=6)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((300, 3), generator=g) * 1.2 - 0.1
    live = torch.rand((300, cfg.num_levels), generator=g) < live_share
    got, _, ops = cs.brick_work(x, cfg, 1000, 7, live if live_share < 1.0 else None)
    sectors = set()
    for n in range(x.shape[0]):
        if ((x[n] < 0) | (x[n] > 1)).any():
            continue
        for level in range(cfg.num_levels):
            if not live[n, level] and live_share < 1.0:
                continue
            pos = torch.floor(x[n] * cfg.level_scale(level) + 0.5).long()
            row = int(bg._brick_index(cfg, level, pos >> 1)) + cfg.offsets[level]
            lo = (pos & 1).tolist()
            for i in range(2):
                for j in range(2):
                    for k in range(2):
                        cell = (lo[0] + i) * 9 + (lo[1] + j) * 3 + lo[2] + k
                        first = (row * 27 + cell) * cfg.level_dim * 4
                        sectors.update({first // 32, (first + cfg.level_dim * 4 - 1) // 32})
    assert got == x.numel() * 4 + len(sectors) * 32 + 1000
    assert ops == 300 * cfg.num_levels * 7
