"""The bf16 MLP's fused route on the CPU (``ops/kernels/fused_mlp.py``).

``FusedMLP`` takes the plain versions for CPU tensors: its forward and
backward equal autograd of ``mlp_chain`` (``MLP.forward``'s chain of f32
products and bf16 casts) bit for bit, on the package's chains (the hash
cells' sigma 32-64-16, the colour net 31-64-64-3, D-NeRF's sigma,
deformation and basis nets, a 128-wide chain), with zero rows, zero
cotangent rows and an f32 input. The route's rule is a pure function of
dtype and widths, which ``MLP`` applies once, to calls on the card; f32
models and CPU tensors keep the chain and count their rows as not fused.
"""

import pytest
import torch

from ngp_tpu_torch import tracing
from ngp_tpu_torch.models.mlp import MLP
from ngp_tpu_torch.ops.kernels import fused_mlp as fm

BF16 = torch.bfloat16
CHAINS = {
    "hash-sigma": [32, 64, 16],
    "colour": [31, 64, 64, 3],
    "dnerf-sigma": [108, 64, 16],
    "dnerf-deform": [76, 128, 128, 128, 128, 3],
    "dnerf-basis": [13, 128, 128, 4],
    "wide": [128, 128, 16],
    "one-layer": [32, 16],
}


def _inputs(dims, rows, x_dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, dims[0]), generator=g).to(x_dtype)
    ws = [torch.randn((a, b), generator=g) * (2.0 / a) ** 0.5 for a, b in zip(dims, dims[1:])]
    cot = torch.randn((rows, dims[-1]), generator=g).to(BF16)
    cot[::3] = 0  # zero cotangent rows, as the march's masked slots give
    return x, ws, cot


def _grads(fn, x, ws, cot):
    xr = x.clone().requires_grad_()
    wr = [w.clone().requires_grad_() for w in ws]
    y = fn(xr, wr)
    y.backward(cot)
    return y.detach(), xr.grad, [w.grad for w in wr]


@pytest.mark.parametrize("rows", [0, 1, 300])
@pytest.mark.parametrize("x_dtype", [BF16, torch.float32])
@pytest.mark.parametrize("name", list(CHAINS))
def test_plain_function_equals_autograd_of_the_chain(name, x_dtype, rows):
    dims = CHAINS[name]
    x, ws, cot = _inputs(dims, rows, x_dtype)
    y_ref, dx_ref, dw_ref = _grads(lambda a, b: fm.mlp_chain(a, b, BF16), x, ws, cot)
    y, dx, dw = _grads(lambda a, b: fm.FusedMLP.apply(a, *b), x, ws, cot)
    assert y.dtype == BF16 and torch.equal(y, y_ref)
    assert dx.dtype == x_dtype and torch.equal(dx, dx_ref)
    for got, want in zip(dw, dw_ref):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    # without dX the weights' gradients are the same
    none, dw2 = fm.mlp_bf16_bwd(x.to(BF16), ws, cot, need_dx=False)
    assert none is None and all(torch.equal(a, b) for a, b in zip(dw2, dw_ref))


@pytest.mark.parametrize("name", ["hash-sigma", "colour"])
def test_all_zero_cotangent_gives_zero_gradients(name):
    dims = CHAINS[name]
    x, ws, cot = _inputs(dims, 64, BF16, seed=3)
    dx, dw = fm.mlp_bf16_bwd(x, ws, torch.zeros_like(cot))
    assert not dx.any() and not any(d.any() for d in dw)


@pytest.mark.parametrize("name", ["hash-sigma", "colour"])
def test_module_on_the_fused_route_equals_its_own_chain(name, monkeypatch):
    """``MLP.forward`` through ``FusedMLP`` (the route forced on the CPU,
    where the function takes the plain versions) on a [rays, samples, D]
    input: the same output and gradients as its own chain, bit for bit."""
    dims = CHAINS[name]
    m = MLP(dims[0], dims[-1], dims[1], len(dims) - 1, BF16, device="cpu")
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 75, dims[0]), generator=g).to(BF16)
    cot = torch.randn((4, 75, dims[-1]), generator=g).to(BF16)
    y_ref, dx_ref, dw_ref = _grads(lambda a, b: fm.mlp_chain(a, b, BF16), x,
                                  [w.detach() for w in m.weights], cot)
    assert m.fused_device == "cuda"
    monkeypatch.setattr(m, "fused_device", "cpu")
    xr = x.clone().requires_grad_()
    y = m(xr)
    y.backward(cot)
    assert y.shape == (4, 75, dims[-1]) and torch.equal(y.detach(), y_ref)
    assert torch.equal(xr.grad, dx_ref)
    for w, want in zip(m.weights, dw_ref):
        assert torch.equal(w.grad, want)


@pytest.mark.parametrize("dtype", [None, BF16])
def test_cpu_and_f32_calls_keep_the_chain(dtype, monkeypatch):
    """On the CPU (bf16 or f32) ``MLP.forward`` runs its own chain and
    counts its rows as not fused."""

    def refuse(*a):
        raise AssertionError("FusedMLP on a CPU tensor")

    monkeypatch.setattr(fm.FusedMLP, "apply", refuse)
    m = MLP(31, 3, 64, 3, dtype, device="cpu")
    x = torch.randn((2, 50, 31), generator=torch.Generator().manual_seed(1))
    tracing.reset_counters()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            y = m(x)
        totals = tracing.counter_totals()
    finally:
        tracing.reset_counters()
    assert torch.equal(y, fm.mlp_chain(x, m.weights, dtype or torch.float32))
    assert totals == {"mlp_rows": 100.0}


@pytest.mark.parametrize("device,dtype,dims,fused", [
    ("cuda", BF16, [32, 64, 16], True),
    ("cuda", BF16, [31, 64, 64, 3], True),
    ("cuda", BF16, [128, 128, 16], True),
    ("cuda", BF16, [129, 64, 16], False),
    ("cuda", BF16, [32, 129, 16], False),
    ("cuda", BF16, [13, 128, 128, 4], True),
    ("cuda", BF16, [76, 128, 128, 128, 128, 3], False),  # the shared memory
    ("cuda", BF16, [16] * 9, True),
    ("cuda", BF16, [16] * 10, False),
    ("cuda", torch.float32, [32, 64, 16], False),
    ("cuda", None, [32, 64, 16], False),
    ("cpu", BF16, [32, 64, 16], False),
])
def test_route_rule(device, dtype, dims, fused):
    """The rule as ``MLP`` applies it: its widths and dtype at construction,
    the device at each call."""
    assert (device == "cuda" and fm.fused_route(dtype, dims)) is fused
    m = MLP(dims[0], dims[-1], dims[1], len(dims) - 1, dtype, device="cpu")
    assert (m.fused_device == device) is fused


def test_backward_shared_memory_as_the_kernel_lays_it_out():
    # 32-64-16: weights 32x64 + 64x16 padded, twice in bf16 and once in f32;
    # the scan's 33 ints a warp (16-byte aligned); a warp's tiles: 16 rows of
    # the inputs (32 + 8, 64 + 8) and output cotangents (64 + 8, 16 + 8)
    assert fm.bwd_smem_bytes([32, 64, 16]) == 8 * 3072 + 144 + 2 * 16 * (40 + 72 + 72 + 24)
    assert fm.bwd_smem_bytes([31, 64, 64, 3], warps=8) == (
        8 * 7168 + 4 * 33 * 8 + 8 * 2 * 16 * (40 + 72 + 72 + 72 + 72 + 24))
