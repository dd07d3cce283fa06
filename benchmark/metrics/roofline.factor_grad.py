"""The CP factor gradient (``cp_bwd_banks``: the banks' gradients from
d(CP features), with its zero fill and cast) as a share of its roofline,
on the captured calls' own rows (live rows: inside the box, g not zero)."""

from benchmark import yardstick as Y


def _capture(a, k, out):
    pos, factors, g_cp, res = a[0], a[1], a[2], a[3]
    return {"pos": pos, "g_cp": g_cp, "factor_bytes": Y.nbytes(*factors),
            "resolutions": tuple(res), "rank": factors[0].shape[-1]}


SPANS = [
    {"module": "ngp_tpu_torch.ops.kernels.cp", "attr": "cp_bwd_banks", "span": "factor_grad",
     "capture": _capture},
]


def read(run):
    p, caps = run.profile, run.captures.get("factor_grad")
    if p is None or not caps:
        return None
    inst = p.spans.get("factor_grad", [])[:len(caps)]
    dev = sum(s for s, _ in inst)
    if not dev:
        return None
    least = sum(Y.bound_s(*Y.factor_grad_work(**c)) for c in caps[:len(inst)])
    return 100.0 * least / dev
