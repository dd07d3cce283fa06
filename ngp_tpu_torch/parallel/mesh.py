"""Device meshes and placement over ``torch.distributed``
(``ngp_tpu/parallel/mesh.py``).

The JAX package places arrays on a ``jax.sharding.Mesh`` and XLA inserts
the collectives. Here each mesh position is a process (a rank, one card
each), and the trainers call the collectives themselves
(``parallel/collectives.py``):

- the ``data`` axis splits a step's rays: data rank d takes the d-th
  contiguous slice (``data_slice``), the parameters are replicated and
  the gradients averaged over ``data`` before the optimizer step;
- the ``model`` axis (``model_parallel > 1``) splits the CP factor banks
  [3, res, R] on their rank axis (``tp_param_specs``): model rank m
  holds columns m R/M ... (m + 1) R/M of each bank (``shard_params``),
  encodes its columns of the features, and the columns of the M ranks
  are all-gathered before the sigma MLP. The Adam moments and the EMA
  shadow of a bank are built on the shard, so they are split with it.

``init_device_mesh`` lays the ranks out row-major: global rank
r = d * M + m. Every rank of a data group (its M model ranks) works on
the same rays.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Set, Tuple

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` over the process group the caller set up
    (``torch.distributed.init_process_group``, e.g. under ``torchrun``):
    1-D ``("data",)``, or 2-D ``("data", "model")`` when ``model_parallel
    > 1``. ``n_devices`` (default: the world size) must be the world size.
    On the card (``device_type="cuda"``) the group must be NCCL's; the CPU
    (``"cpu"``, gloo) is for callers that ask for it, such as the tests.
    Nothing falls back to another backend or device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (call "
                           "torch.distributed.init_process_group first)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: {n} devices asked of a process group of {world} ranks")
    if n % model_parallel:
        raise ValueError(f"make_mesh: {n} devices do not split into model groups of "
                         f"{model_parallel}")
    backend = dist.get_backend()
    want = {"cuda": "nccl", "cpu": "gloo"}.get(device_type)
    if want is None:
        raise ValueError(f"make_mesh: device_type {device_type!r} (cuda or cpu)")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device")
    if backend != want:
        raise RuntimeError(f"make_mesh: a {device_type} mesh needs the {want} backend, "
                           f"the process group has {backend}")
    from torch.distributed.device_mesh import init_device_mesh

    if model_parallel > 1:
        return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return init_device_mesh(device_type, (n,), mesh_dim_names=(DATA_AXIS,))


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis``; 1 for an axis the mesh does not have."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 for a missing axis)."""
    return mesh.get_local_rank(axis) if axis in (mesh.mesh_dim_names or ()) else 0


# ---- tensor parallelism: the CP factor banks over "model" -------------------


def tp_param_specs(model: nn.Module, mesh) -> Dict[str, Tuple]:
    """Parameter name -> partition spec: ``(None, None, "model")`` for a
    CP factor bank (a name holding ``factors_``, ndim 3) when the mesh has a
    ``model`` axis, ``()`` (replicated) for every other parameter."""
    split = MODEL_AXIS in (mesh.mesh_dim_names or ())
    return {name: (None, None, MODEL_AXIS) if split and "factors_" in name and p.ndim == 3
            else () for name, p in model.named_parameters()}


def _owner(model: nn.Module, name: str):
    path, _, leaf = name.rpartition(".")
    return (model.get_submodule(path) if path else model), leaf


def split_names(model: nn.Module) -> Set[str]:
    """The parameters that ``shard_params`` split: those of modules whose
    feature gather is set."""
    return {name for name, _ in model.named_parameters()
            if getattr(_owner(model, name)[0], "feature_gather", None) is not None}


def take_split(t: torch.Tensor, mesh) -> torch.Tensor:
    """This model rank's contiguous columns of a whole bank (last axis)."""
    M, m = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    R = t.shape[-1]
    if R % M:
        raise ValueError(f"a bank of rank {R} does not split over {M} model ranks")
    w = R // M
    return t[..., m * w:(m + 1) * w].contiguous()


def gather_split(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole bank from the model ranks' shards (a collective over
    ``model``: every model rank calls it)."""
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, MODEL_AXIS))]
    dist.all_gather(parts, t.detach().contiguous(), group=mesh.get_group(MODEL_AXIS))
    return torch.cat(parts, dim=-1)


def shard_params(model: nn.Module, mesh) -> Set[str]:
    """Replace each bank ``tp_param_specs`` splits by this model rank's
    shard [3, res, R / M] (R % M == 0), and set the feature gather of its
    encoder. Call it before the trainer builds its optimizer and EMA.
    Returns the names split."""
    from ngp_tpu_torch.parallel.collectives import gather_cp_features

    names = [k for k, spec in tp_param_specs(model, mesh).items() if spec]
    banks: Dict[nn.Module, int] = {}
    for name in names:
        module, leaf = _owner(model, name)
        if not hasattr(module, "feature_gather"):
            raise TypeError(f"{name}: {type(module).__name__} cannot gather split features")
        p = getattr(module, leaf)
        setattr(module, leaf, nn.Parameter(take_split(p.detach(), mesh),
                                           requires_grad=p.requires_grad))
        banks[module] = banks.get(module, 0) + 1
    for module, n_banks in banks.items():
        module.feature_gather = partial(gather_cp_features, mesh, n_banks=n_banks)
    return set(names)


def unshard_params(model: nn.Module, mesh) -> Set[str]:
    """The inverse of ``shard_params``: gather the whole banks over
    ``model`` (every rank calls it) and clear the feature gathers."""
    names = sorted(split_names(model))
    for name in names:
        module, leaf = _owner(model, name)
        p = getattr(module, leaf)
        setattr(module, leaf, nn.Parameter(gather_split(p.detach(), mesh),
                                           requires_grad=p.requires_grad))
    for name in names:
        _owner(model, name)[0].feature_gather = None
    return set(names)


# ---- placement (the counterparts of the JAX shardings) ----------------------


def data_slice(mesh, n: int) -> slice:
    """Data rank d's rows of an n-row batch: the d-th of D equal
    contiguous slices (as ``P("data")`` splits axis 0); n % D == 0."""
    D = axis_size(mesh, DATA_AXIS)
    if n % D:
        raise ValueError(f"{n} rows do not split over {D} data ranks")
    k = n // D
    d = axis_rank(mesh, DATA_AXIS)
    return slice(d * k, (d + 1) * k)


def data_sharding(mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """``NamedSharding(mesh, P("data"))``: x -> this data rank's rows of x."""
    return lambda x: x[data_slice(mesh, x.shape[0])]


def replicate_sharding(mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """``NamedSharding(mesh, P())``: x -> rank 0's x, on every rank (a
    broadcast over the whole mesh, which ``make_mesh`` makes the world)."""
    def place(x: torch.Tensor) -> torch.Tensor:
        x = x.detach().clone().contiguous()
        dist.broadcast(x, src=0)
        return x

    return place


def shard_pytree(tree, sharding: Callable[[torch.Tensor], torch.Tensor]):
    """Apply ``sharding`` to every tensor of a tree of dicts, lists and
    tuples; other leaves are kept."""
    if torch.is_tensor(tree):
        return sharding(tree)
    if isinstance(tree, dict):
        return {k: shard_pytree(v, sharding) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_pytree(v, sharding) for v in tree)
    return tree
