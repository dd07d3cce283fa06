"""The whole step's share of the card's bf16 dense peak (989 TFLOP/s):
the model's matrix-product FLOPs, forward and backward (3 x the forward),
on the samples a step evaluates (the turbo march's compacted samples,
the rows the density head takes; the v1 march's valid slots only; the
mean over the traced run's window), over the card's busy time a
profiled step (``device_ms_per_step``)."""

from benchmark import yardstick as Y

SPANS = [
    {"module": "ngp_tpu_torch.ops.kernels.cp", "attr": "cp_density_fwd", "span": "density_head",
     "when": lambda a, k: bool(k.get("residuals", a[6] if len(a) > 6 else False)),
     "counter": "samples", "count": lambda a, k, out: a[0].shape[0]},
    {"module": "ngp_tpu_torch.models.occupancy", "attr": "march_rays", "span": "march",
     "counter": "samples", "count": lambda a, k, out: out["mask"].sum()},
]


def read(run):
    n, p = run.counts.get("samples"), run.profile
    if not n or p is None or not p.busy_s:
        return None
    sigma, color = Y.model_flops_per_sample(run.config["network"])
    flops = 3.0 * (sigma + color) * n / run.window["steps"]
    return 100.0 * flops / (p.busy_s / p.n_steps * Y.BF16_TENSOR_RATE)
