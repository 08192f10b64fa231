"""Process groups and the device mesh.

Port of ``item_alignment_tpu/parallel/mesh.py``.  The JAX package drives
every device of a host from one process and names them in a
``jax.sharding.Mesh`` with the axes ``("data", "fsdp", "tensor")``.  The
port runs one process per device, joined by ``torch.distributed`` (NCCL on
CUDA, gloo on the CPU), and names them in a ``DeviceMesh`` with the same
axes.  So a mesh of 8 devices needs 8 processes (``torchrun
--nproc_per_node 8``, or the ``--distributed`` flags in each process).

- ``initialize_distributed``: ``torch.distributed.init_process_group`` from
  the coordinator's ``host:port``, the process count and this process's
  index, or from torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
  ``RANK`` when they are omitted (JAX reads the pod's environment there).
  On CUDA each process takes ``cuda:LOCAL_RANK`` (torchrun's variable, else
  the process index modulo the cards of the host).
- ``create_mesh``: ``init_device_mesh`` with ``MeshConfig.axis_sizes`` of
  the world size; None for a mesh of one device without a process group,
  which keeps the single-device path exactly.  A mesh that asks for more
  devices than there are processes raises, saying how many to launch.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from item_alignment_torch.config import MeshConfig
from item_alignment_torch.device import resolve_device

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXES = (AXIS_DATA, AXIS_FSDP, AXIS_TENSOR)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None, backend: Optional[str] = None) -> None:
    """Join this process to the job's process group (once; a second call
    does nothing).  ``device``: "cuda" (the default) joins over NCCL,
    "cpu" over gloo; ``backend`` names another (gloo for processes that
    share one card, which NCCL refuses)."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env:
            raise ValueError("--distributed needs --coordinator_address "
                             "host:port, or torchrun's MASTER_ADDR and "
                             "MASTER_PORT")
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside {world} processes")
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)


def maybe_initialize_distributed_from_args(args) -> None:
    """CLI hook: ``--distributed [--coordinator_address --num_processes
    --process_id]`` on every command that takes them, or a launch by
    torchrun (``WORLD_SIZE`` above 1); the process group runs on
    ``--device``."""
    if getattr(args, "distributed", False) \
            or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize_distributed(
            getattr(args, "coordinator_address", None),
            getattr(args, "num_processes", None),
            getattr(args, "process_id", None),
            getattr(args, "device", None))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def create_mesh(config: Optional[MeshConfig] = None, device_type: str = "cuda"):
    """The ``("data", "fsdp", "tensor")`` ``DeviceMesh`` over the process
    group, or None without one when the mesh is a single device."""
    config = config or MeshConfig()
    n = world_size()
    need = max(config.data, 1) * max(config.fsdp, 1) * max(config.tensor, 1)
    if (n != need) if config.data != -1 else (n % need):
        raise ValueError(
            f"mesh {config.data},{config.fsdp},{config.tensor} needs "
            f"{'a multiple of ' if config.data == -1 else ''}{need} devices "
            f"and the port runs one process per device: launch {need} "
            f"processes (torchrun --nproc_per_node {need}, or --distributed "
            f"in each), not {n}")
    sizes = config.axis_sizes(n)
    if not dist.is_initialized():
        return None
    return torch.distributed.device_mesh.init_device_mesh(
        device_type, sizes, mesh_dim_names=AXES)
