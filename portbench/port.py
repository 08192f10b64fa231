"""What the benchmark takes from the program, ``item_alignment_torch``,
whatever the model: its attention entry, its launch counters, and the
device's clock and memory.  The models themselves are the families'
(``families/<family>.py``).
"""

from __future__ import annotations

import gc
import time
from typing import Optional, Tuple

import numpy as np
import torch

from item_alignment_torch.ops import cuda_attention, cuda_attention_train
from item_alignment_torch.ops.attention import flash_attention


def launches() -> Tuple[int, int, int]:
    """The attention kernels' launch counters: #1 (no dropout), #2 and #3
    (the dropout forward and backward at S <= 512)."""
    return (cuda_attention.LAUNCHES, cuda_attention_train.FWD_LAUNCHES,
            cuda_attention_train.BWD_LAUNCHES)


def attention_seconds(B: int, N: int, S: int, H: int, mask: np.ndarray,
                      rate: float, backward: bool, device, calls: int = 20
                      ) -> Optional[float]:
    """Device seconds a call of the attention entry the encoder calls
    (``ops/attention.flash_attention``) at these shapes and key mask: bf16
    q, k, v ``[B, S, N, H]``, the fp32 key bias of ``mask``, with ``rate``
    its dropout and with ``backward`` its backward to q, k and v.  The
    union of the device's operations over ``calls`` calls after two, from
    the profiler (``trace.profiled``): a call launches few kernels, so the
    host's launches, which CUDA events around the calls would time, can
    outlast them.  None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    from portbench.trace import profiled

    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((B, S, N, H), generator=gen, device=device,
                           dtype=torch.bfloat16).requires_grad_(backward)
               for _ in range(3))
    g = torch.randn((B, S, N, H), generator=gen, device=device,
                    dtype=torch.bfloat16)
    bias = ((1.0 - torch.as_tensor(mask, device=device).float()) * -1e9
            )[:, None, None, :]

    def call(i):
        out = flash_attention(q, k, v, bias, dropout_rate=rate,
                              dropout_seed=i if rate else None,
                              dtype=torch.bfloat16, num_heads=N)
        if backward:
            torch.autograd.grad(out, (q, k, v), g)

    for i in range(2):
        call(i)
    _, trace = profiled(lambda: [call(i) for i in range(calls)])
    return trace.busy_s / calls


def free(device) -> None:
    """Hand back to the card what the dropped program state held."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def clock(device) -> float:
    """The host clock after the device has finished its work."""
    synchronize(device)
    return time.perf_counter()
