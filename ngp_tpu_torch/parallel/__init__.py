"""Parallelism over ``torch.distributed`` (``ngp_tpu/parallel/``): rays
split over a ``data`` axis, the CP factor banks over a ``model`` axis.
See ``mesh.py`` for the layout and ``collectives.py`` for the
collectives the trainers call."""

from ngp_tpu_torch.parallel.collectives import eval_metrics_dp, gather_predictions_dp
from ngp_tpu_torch.parallel.mesh import (
    data_sharding,
    make_mesh,
    replicate_sharding,
    shard_pytree,
)

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicate_sharding",
    "shard_pytree",
    "eval_metrics_dp",
    "gather_predictions_dp",
]
