"""The training density head (``cp_density_fwd`` with residuals: CP
features, both products, feats and h1 written) as a share of its
roofline: the copied bound of each captured call's inputs over the
device time of the work launched inside that call."""

from benchmark import yardstick as Y


def _capture(a, k, out):
    pos, factors, w1, w2 = a[0], a[1], a[2], a[3]
    return {"M": pos.shape[0], "factor_bytes": Y.nbytes(*factors), "D": w1.shape[0],
            "H1": w1.shape[1], "OUT": w2.shape[1], "elem": w1.element_size(),
            "nbR": len(factors) * factors[0].shape[-1]}


SPANS = [
    {"module": "ngp_tpu_torch.ops.kernels.cp", "attr": "cp_density_fwd", "span": "density_head",
     "when": lambda a, k: bool(k.get("residuals", a[6] if len(a) > 6 else False)),
     "capture": _capture},
]


def read(run):
    p, caps = run.profile, run.captures.get("density_head")
    if p is None or not caps:
        return None
    inst = p.spans.get("density_head", [])[:len(caps)]
    dev = sum(s for s, _ in inst)
    if not dev:
        return None
    least = sum(Y.bound_s(*Y.density_head_work(residuals=True, **c)) for c in caps[:len(inst)])
    return 100.0 * least / dev
