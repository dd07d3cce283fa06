"""The hash-grid encoding's forward on the training step's points
(``grid_encode_fwd``) as a share of its roofline: the copied bound of
each captured call's own points (distinct table sectors of the corners
of the points inside the box) over the device time of its work."""

from benchmark import yardstick as Y
from benchmark.reference import plain as P

SPANS = [
    {"module": "ngp_tpu_torch.ops.kernels.hashgrid", "attr": "grid_encode_fwd",
     "span": "hash_fwd", "capture": lambda a, k, out: {"x": a[0], "elem": out.element_size()}},
]


def read(run):
    p, caps = run.profile, run.captures.get("hash_fwd")
    if p is None or not caps:
        return None
    inst = p.spans.get("hash_fwd", [])[:len(caps)]
    dev = sum(s for s, _ in inst)
    if not dev:
        return None
    net = run.config["network"]
    geom = P.hash_geometry(net["num_levels"], net["level_dim"], net["base_resolution"],
                           net["log2_hashmap_size"], int(2048 * run.config["render"]["bound"]))
    least = sum(Y.bound_s(*Y.hash_fwd_work(c["x"], geom, c["elem"])) for c in caps[:len(inst)])
    return 100.0 * least / dev
