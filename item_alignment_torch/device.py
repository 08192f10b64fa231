"""Device resolution for the port's entry points, and the guard of
``pred-text --xfer_guard``."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch
import torch.distributed


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a GPU raises.  In
    a process group (one process per device) "cuda" is the process's own
    card, which ``parallel/mesh.initialize_distributed`` set."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None \
            and torch.distributed.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def transfer_guard(device: torch.device, on: bool = True) -> Iterator[None]:
    """With ``on`` and a CUDA ``device``, a synchronizing copy inside the
    block raises (``torch.cuda.set_sync_debug_mode("error")``): a
    host-to-device copy from pageable memory, say, where an explicit
    non-blocking copy from pinned memory goes through.  It stands in for
    JAX's ``transfer_guard_host_to_device("disallow")``.  On the CPU there
    is no transfer to guard."""
    if not (on and device.type == "cuda"):
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)
