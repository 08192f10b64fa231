"""Parameter and batch sharding rules.

Port of ``item_alignment_tpu/parallel/sharding.py``.  ``param_partition_spec``
is the JAX package's rule on a parameter's Flax path and shape (the same
tuple of axis names a ``PartitionSpec`` holds):

- attention q/k/v and MLP-up kernels ``[in, out]`` -> (fsdp, tensor)
- attention-out and MLP-down kernels ``[in, out]`` -> (tensor, fsdp)
- embedding tables ``[V, H]`` -> (None, fsdp)
- biases of tensor-split outputs -> (tensor,)
- anything else, and any dimension that does not divide, replicated.

``torch_partition_spec`` gives the same rule on the port's parameter (its
name through ``convert.flax_path``), transposed where the port's layout is:
a Dense ``weight [out, in]`` reads the kernel's spec backwards, so q/k/v
and the MLP-up weights split their rows over ``tensor`` and their columns
over ``fsdp``.

``shard_params`` applies the rules with PyTorch's own tools, in place.
When the tensor axis is above 1, ``parallelize_module`` puts
``ColwiseParallel``/``RowwiseParallel`` on each Dense that the rules split
over ``tensor`` (the encoder's attention then runs on its rank's heads:
``models/encoder.py``); at tensor 1 the rules still name the axis, as JAX's
do, but nothing is split, so no module takes those styles.  Then FSDP2
``fully_shard`` over the ``("data", "fsdp")`` sub-mesh, which replicates
over ``data`` and shards over ``fsdp`` on the dimension the rules give (dim
0 where they give none: FSDP2 shards every parameter it holds), goes on
each block (``_blocks``: a transformer layer, an image block, a GCN layer)
and then on the root, which keeps the rest.  A block's parameters are
gathered only while it runs and resharded after its forward, so the fsdp
axis cuts the parameters a rank holds.  The model's ``load_state_dict``
then takes full tensors too, and ``full_state_dict`` gathers them back.

Batches ride the ``data`` axis alone, as JAX's ``P("data")``: the fsdp and
tensor ranks of one data index see the same rows (``batch_sharding``,
``process_slice``, ``put_global_batch``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from item_alignment_torch.convert import _attention_part, flax_path
from item_alignment_torch.parallel.mesh import AXIS_DATA, AXIS_FSDP, AXIS_TENSOR

# kernels whose OUTPUT feature dim is split across the tensor axis
_COL_PARALLEL = ("query", "key", "value", "intermediate")
# kernels whose INPUT feature dim is split across the tensor axis
_ROW_PARALLEL = ("attention/output", "mlp_output")

Spec = Tuple[Optional[str], ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh``, a dict, or None (one device)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _divides(n: Optional[int], size: int) -> bool:
    return n is not None and size > 0 and n % size == 0


def param_partition_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
                         mesh) -> Spec:
    """JAX's rule: the axis of each dimension of the Flax parameter at
    ``path`` with ``shape``, () when replicated."""
    sizes = mesh_sizes(mesh)
    names = "/".join(str(p) for p in path)
    fsdp = sizes.get(AXIS_FSDP, 1)
    tensor = sizes.get(AXIS_TENSOR, 1)
    leaf = path[-1] if path else ""

    if leaf == "embedding" and len(shape) == 2:
        return (None, AXIS_FSDP) if _divides(shape[1], fsdp) else ()

    if leaf == "kernel" and len(shape) == 2:
        col = any(k in names for k in _COL_PARALLEL)
        row = any(k in names for k in _ROW_PARALLEL)
        in_ax = AXIS_TENSOR if (row and _divides(shape[0], tensor)) else (
            AXIS_FSDP if (col and _divides(shape[0], fsdp)) else None)
        out_ax = AXIS_TENSOR if (col and _divides(shape[1], tensor)) else (
            AXIS_FSDP if (row and _divides(shape[1], fsdp)) else None)
        if in_ax is None and out_ax is None:
            # generic dense: fsdp-shard the larger dim if it divides
            if _divides(shape[1], fsdp):
                return (None, AXIS_FSDP)
            if _divides(shape[0], fsdp):
                return (AXIS_FSDP, None)
            return ()
        return (in_ax, out_ax)

    if leaf == "bias" and len(shape) == 1:
        if any(k in names for k in _COL_PARALLEL) and _divides(shape[0], tensor):
            return (AXIS_TENSOR,)
        return ()

    return ()  # LayerNorm scales, scalars, etc: replicated


def _flax_shape(path: Tuple[str, ...], shape: Tuple[int, ...]) -> tuple:
    """The Flax parameter's shape, as far as the rules read it: a Dense
    kernel is the transpose of the port's weight; a ViT attention kernel is
    3-D and its q/k/v biases 2-D in Flax (the rules replicate both)."""
    part = _attention_part(path[:-1])
    if part is not None:
        return ((1, 1, 1) if path[-1] == "kernel" else
                (1, 1) if part != "out" else tuple(shape))
    if path[-1] == "kernel" and len(shape) == 2:
        return tuple(reversed(shape))
    return tuple(shape)


def torch_partition_spec(name: str, shape, mesh) -> Spec:
    """The rule for the port's parameter ``name`` of ``shape``, one axis
    (or None) per dimension of the port's tensor."""
    path = flax_path(name)
    fshape = _flax_shape(path, tuple(shape))
    spec = tuple(param_partition_spec(path, fshape, mesh))
    spec = spec + (None,) * (len(fshape) - len(spec))
    if len(fshape) != len(shape):  # replicated (ViT attention)
        return (None,) * len(shape)
    if path[-1] == "kernel" and len(shape) == 2:
        spec = tuple(reversed(spec))
    return spec


def tree_shardings(model: nn.Module, mesh) -> Dict[str, Spec]:
    """{parameter name: ``torch_partition_spec``} of every parameter."""
    return {n: torch_partition_spec(n, p.shape, mesh)
            for n, p in model.named_parameters()}


def _tensor_plan(model: nn.Module, specs: Dict[str, Spec]) -> dict:
    """{module name: ColwiseParallel | RowwiseParallel} for each Dense that
    the rules split over ``tensor``; any other parameter that they split
    so has no module to run it and raises."""
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    from item_alignment_torch.models.encoder import SelfAttention, TransformerLayer
    from item_alignment_torch.models.layers import Dense

    owners = {}
    for name, m in model.named_modules():
        if isinstance(m, (SelfAttention, TransformerLayer)):
            for child, sub in m.named_children():
                if isinstance(sub, Dense):
                    owners[f"{name}.{child}"] = sub
    plan, covered = {}, set()
    for name, m in owners.items():
        spec = specs[f"{name}.weight"]
        if spec[0] == AXIS_TENSOR:
            plan[name] = ColwiseParallel()
        elif spec[1] == AXIS_TENSOR:
            plan[name] = RowwiseParallel()
        else:
            continue
        covered |= {f"{name}.weight", f"{name}.bias"}
    for n, spec in specs.items():
        if AXIS_TENSOR in spec and n not in covered:
            raise ValueError(f"{n}: the rules split it over the tensor axis "
                             "and no module of the port runs it so")
    return plan


def _blocks(model: nn.Module) -> list:
    """The modules that FSDP2 gathers one at a time, innermost first."""
    from item_alignment_torch.models.encoder import TransformerLayer
    from item_alignment_torch.models.graph import GCN2Layer
    from item_alignment_torch.models.image import NFBlock, PreActBottleneck, ViTBlock
    from item_alignment_torch.models.multimodal import (
        CrossAttention,
        ParallelTransformerBlock,
    )

    kinds = (TransformerLayer, ViTBlock, PreActBottleneck, NFBlock,
             ParallelTransformerBlock, CrossAttention, GCN2Layer)
    return [m for m in reversed(list(model.modules()))
            if isinstance(m, kinds) and m is not model]


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Shard ``model``'s parameters in place by the rules (module
    docstring); a None mesh leaves the model as it is."""
    if mesh is None:
        return model
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor.parallel import parallelize_module

    from item_alignment_torch.models.encoder import SelfAttention

    sizes = mesh_sizes(mesh)
    specs = tree_shardings(model, sizes)
    tensor = sizes[AXIS_TENSOR]
    plan = _tensor_plan(model, specs) if tensor > 1 else {}
    t_rank = mesh[AXIS_TENSOR].get_local_rank()
    for name, m in model.named_modules():
        if isinstance(m, SelfAttention) and f"{name}.query" in plan:
            heads = m.config.num_attention_heads
            if heads % tensor:
                raise ValueError(f"{heads} attention heads do not divide "
                                 f"over a tensor axis of {tensor}")
            m.head_offset = t_rank * (heads // tensor)
    if plan:
        parallelize_module(model, mesh[AXIS_TENSOR], plan)
    fsdp_dim = {}
    for n, p in model.named_parameters():
        spec = specs[n]
        fsdp_dim[id(p)] = spec.index(AXIS_FSDP) if AXIS_FSDP in spec else 0
    for m in _blocks(model) + [model]:
        fully_shard(m, mesh=mesh[AXIS_DATA, AXIS_FSDP],
                    shard_placement_fn=lambda p: Shard(fsdp_dim[id(p)]))
    model.register_load_state_dict_pre_hook(_distribute_full_tensors)
    return model


def distribute_like(full: torch.Tensor, like: DTensor) -> DTensor:
    """``full`` (the whole tensor, the same on every rank) placed as
    ``like`` is."""
    mesh = like.device_mesh
    return DTensor.from_local(
        full.to(like.device, like.dtype), mesh, [Replicate()] * mesh.ndim,
        run_check=False).redistribute(mesh, like.placements)


def _distribute_full_tensors(module, state_dict, prefix, *args) -> None:
    """``load_state_dict`` of a sharded model: full tensors are placed as
    the parameters they replace."""
    for name, p in module.named_parameters():
        v = state_dict.get(prefix + name)
        if isinstance(p, DTensor) and isinstance(v, torch.Tensor) \
                and not isinstance(v, DTensor):
            state_dict[prefix + name] = distribute_like(v, p)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of ``t`` (a collective for a DTensor)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict as whole tensors on the CPU (every rank must
    call it under a mesh)."""
    return {k: full_tensor(v).detach().cpu().clone()
            for k, v in model.state_dict().items()}


def batch_sharding(mesh) -> Tuple[int, int]:
    """(index, count) of this rank along the data axis: the batch rows
    ride that axis alone (JAX's ``P("data")``)."""
    if mesh is None:
        return 0, 1
    return mesh[AXIS_DATA].get_local_rank(), mesh_sizes(mesh)[AXIS_DATA]


def process_slice(n_rows: int, process_index: Optional[int] = None,
                  process_count: Optional[int] = None, mesh=None) -> slice:
    """This rank's contiguous slice of a global batch of ``n_rows``: of
    ``process_count`` equal parts the ``process_index``-th (by default the
    data axis of ``mesh``).  The rows must divide."""
    index, count = batch_sharding(mesh)
    pi = index if process_index is None else process_index
    pc = count if process_count is None else process_count
    if n_rows % pc:
        raise ValueError(f"global batch {n_rows} not divisible by {pc} "
                         "data-parallel ranks")
    per = n_rows // pc
    return slice(pi * per, (pi + 1) * per)


def put_global_batch(mesh, value) -> Tuple[Any, int]:
    """This rank's rows of one global batch array and their offset ``b0``
    in it (the whole array and 0 without a mesh)."""
    if mesh is None:
        return value, 0
    rows = process_slice(np.shape(value)[0], mesh=mesh)
    return value[rows], rows.start
