"""The frozen yardstick against hand counts at small shapes, and the trace
reader on a hand-made trace."""

from __future__ import annotations

import json
import types

import pytest
import torch

from benchmark import yardstick as Y
from benchmark.reference import plain as P
from benchmark.trace import Profile


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert Y.bound_s(3.35e12) == pytest.approx(1.0)
    assert Y.bound_s(0, tensor_flops=989e12) == pytest.approx(1.0)
    assert Y.bound_s(3.35e12, core_flops=2 * 67e12) == pytest.approx(2.0)
    assert Y.bound_s(1.0, tf32x3_flops=495e12) == pytest.approx(3.0)


def test_density_head_work_by_hand():
    # 10 rows, 2 banks of rank 4 (8 CP + 3 freq = 11 features), H1 5, OUT 3, bf16
    n_bytes, tensor, core, tf32 = Y.density_head_work(
        M=10, factor_bytes=100, D=11, H1=5, OUT=3, elem=2, nbR=8, residuals=True)
    assert n_bytes == 10 * 12 + 100 + (11 * 5 + 5 * 3) * 2 + 10 * 3 * 4 + 10 * (11 + 5) * 2
    assert tensor == 2 * 10 * (11 * 5 + 5 * 3) and core == 14 * 10 * 8 and tf32 == 0
    n_bytes, tensor, core, tf32 = Y.density_head_work(
        M=10, factor_bytes=100, D=11, H1=5, OUT=3, elem=4, nbR=8, residuals=False)
    assert n_bytes == 10 * 12 + 100 + (11 * 5 + 5 * 3) * 4 + 10 * 3 * 4
    assert tensor == 0 and tf32 == 2 * 10 * (11 * 5 + 5 * 3)


def test_factor_grad_work_counts_live_rows():
    pos = torch.tensor([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [0.1, 0.2, 0.3], [0.9, 0.9, 0.9]])
    g = torch.zeros((4, 8))
    g[0, :4] = 1.0  # bank 0 live
    g[1] = 1.0  # outside the box: not live
    g[2, 4:] = 1.0  # bank 1 live
    g[3] = 1.0  # both banks live
    n_bytes, tensor, core, _ = Y.factor_grad_work(pos, g, 60, (8, 16), 4)
    assert n_bytes == 4 * 3 * 4 + 4 * 8 * 4 + 2 * 60
    assert tensor == 0 and core == 24 * 4 * 4  # 4 live (row, bank) pairs


def test_table_bytes_counts_distinct_sectors():
    # 8-byte rows (2 f32): 4 rows a 32-byte sector
    rows = torch.tensor([0, 1, 3, 4, -1, 4, 9])
    assert Y.table_bytes(rows, 2, 100) == 3 * 32
    assert Y.table_bytes(rows, 8, 100) == 5 * 32  # 32-byte rows: distinct rows
    assert Y.table_bytes(torch.arange(100), 2, 10) == 10 * 8  # at most the table


def test_hash_work_by_hand():
    geom = P.hash_geometry(2, 2, 4, 6, 8)
    x = torch.tensor([[0.3, 0.6, 0.2], [2.0, 0.5, 0.5]])  # the second is outside
    rows = [P.corner_rows(x[:1], geom, lvl).reshape(-1) for lvl in range(2)]
    sectors = sum(Y.table_bytes(r, 2, geom.num_rows) for r in rows)
    n_bytes, _, core, _ = Y.hash_fwd_work(x, geom, 2)
    assert n_bytes == x.numel() * 4 + sectors + 2 * 2 * 2 * 2
    assert core == 2 * 2 * (3 * 3 + 8 * (3 - 1 + 2 * 2))
    g = torch.zeros((2, 4))
    g[0, 2:] = 1.0  # only level 1 of the inside point is live
    n_bytes, _, core, _ = Y.hash_bwd_work(x, g, geom)
    assert n_bytes == x.numel() * 4 + g.numel() * 4 + Y.table_bytes(rows[1], 2, geom.num_rows)
    assert core == 1 * (3 * 3 + 8 * (3 - 1 + 2))


def test_hash_geometry_of_instant_ngp():
    geom = P.hash_geometry(16, 2, 16, 19, 2048)
    assert geom.num_rows == 6_119_864
    assert not geom.hashed[0] and geom.hashed[-1]


def test_model_flops_per_sample():
    turbo = json.load(open("benchmark/configs/turbo-hq.json"))["network"]
    hashg = json.load(open("benchmark/configs/instant-ngp-hash.json"))["network"]
    color = 2 * (31 * 64 + 64 * 64 + 64 * 3)
    assert Y.model_flops_per_sample(turbo) == (2 * (679 * 64 + 64 * 16), color)
    assert Y.model_flops_per_sample(hashg) == (2 * (32 * 64 + 64 * 16), color)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_profile_attributes_device_work_to_spans():
    events = [
        _ev("user_annotation", "bench/march", 0, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=3),
        _ev("cpu_op", "aten::mm", 19, 3),
        _ev("user_annotation", "bench/factor_grad", 30, 10, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 31, 1, tid=2, corr=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 31, 1, tid=1, corr=5),  # other thread
        _ev("kernel", "march_turbo_kernel", 3, 4, tid=7, corr=1),
        _ev("gpu_memset", "Memset", 7, 1, tid=7, corr=2),
        _ev("kernel", "sm90_gemm", 21, 2, tid=7, corr=3),
        _ev("kernel", "cp_bwd_runs_kernel", 40, 6, tid=7, corr=4),
        _ev("kernel", "cp_bwd_runs_kernel", 46, 2, tid=7, corr=5),
    ]
    p = Profile(events, n_steps=2, wall_s=100e-6)
    assert p.spans["march"] == [(pytest.approx(5e-6), 2)]
    assert p.spans["factor_grad"] == [(pytest.approx(6e-6), 1)]
    assert p.span_s("refresh") is None
    assert p.busy_s == pytest.approx(15e-6)  # [3, 8] + [21, 23] + [40, 48]
    assert p.device_s(lambda n: "gemm" in n) == pytest.approx(2e-6)
    b = p.breakdown()
    assert b["device_ops"][0] == ["cp_bwd_runs_kernel", pytest.approx(8e-6)]
    gaps = dict(b["idle_gaps"])
    # 8 -> 21: nothing on the host at 14.5; 23 -> 40: the span at 31.5
    assert gaps == {"(no host op)": pytest.approx(13e-6),
                    "bench/factor_grad": pytest.approx(17e-6)}


def test_device_time_and_mfu_read_the_profile():
    from benchmark import harness

    events = [_ev("kernel", "a", 0, 4, corr=1), _ev("kernel", "b", 2, 4, corr=2),
              _ev("gpu_memcpy", "c", 10, 2, corr=3)]
    run = types.SimpleNamespace(profile=Profile(events, n_steps=2, wall_s=1.0),
                                counts={"samples": 30.0}, window={"steps": 3},
                                config=json.load(open("benchmark/configs/turbo-hq.json")))
    dev = harness.load_reader("device_ms_per_step")
    assert dev.PROFILE and dev.read(run) == pytest.approx(1e3 * 8e-6 / 2)  # [0, 6] + [10, 12]
    sigma, color = Y.model_flops_per_sample(run.config["network"])
    want = 100.0 * 3 * (sigma + color) * 10 / (4e-6 * Y.BF16_TENSOR_RATE)
    assert harness.load_reader("mfu").read(run) == pytest.approx(want)
    assert dev.read(types.SimpleNamespace(profile=None)) is None
