"""The hash grid's table gradient on the training step's points and
cotangent (``grid_encode_bwd``, with its zero fill) as a share of its
roofline: the copied bound (the live items' distinct sectors written)
over the device time of its work."""

from benchmark import yardstick as Y
from benchmark.reference import plain as P

SPANS = [
    {"module": "ngp_tpu_torch.ops.kernels.hashgrid", "attr": "grid_encode_bwd",
     "span": "hash_table_grad", "capture": lambda a, k, out: {"x": a[0], "g": a[1]}},
]


def read(run):
    p, caps = run.profile, run.captures.get("hash_table_grad")
    if p is None or not caps:
        return None
    inst = p.spans.get("hash_table_grad", [])[:len(caps)]
    dev = sum(s for s, _ in inst)
    if not dev:
        return None
    net = run.config["network"]
    geom = P.hash_geometry(net["num_levels"], net["level_dim"], net["base_resolution"],
                           net["log2_hashmap_size"], int(2048 * run.config["render"]["bound"]))
    least = sum(Y.bound_s(*Y.hash_bwd_work(c["x"], c["g"], geom)) for c in caps[:len(inst)])
    return 100.0 * least / dev
