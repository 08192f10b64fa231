"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

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
