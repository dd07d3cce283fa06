"""Device ms per refresh of the work launched inside update_occupancy
(the grid trainer's refresh every update_extra_interval steps)."""

SPANS = [
    {"module": "ngp_tpu_torch.training.nerf_grid", "attr": "update_occupancy",
     "span": "refresh"},
]


def read(run):
    p = run.profile
    inst = p.spans.get("refresh") if p is not None else None
    if not inst or not sum(s for s, _ in inst):
        return None
    return 1e3 * sum(s for s, _ in inst) / len(inst)
