"""Fused attention forward: a hand-written CUDA kernel and its plain version.

Port of ``item_alignment_tpu/ops/pallas_attention.py:fused_attention``.
Without gradients (``torch.no_grad`` / ``inference_mode``, or inputs that
need none) ``fused_attention`` launches the ``_attn_kernel`` port in
``csrc/fused_attention.cu`` (kernel #1) for CUDA tensors.  In bf16 that is a
Hopper kernel whose tiles TMA loads, so q, k and v are held to
``check_tma`` too: a view TMA cannot take raises, it does not fall back.
When a gradient is wanted it takes the route of the JAX custom VJP
(``_fused_attention_fwd`` / ``_fused_attention_bwd``): the forward runs #2's
contract at rate 0, which also emits lse, and the backward #3's contract at
rate 0 (``ops/cuda_attention_train.py``).  CPU tensors
run ``fused_attention_reference``, which autograd differentiates; any other
device raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from item_alignment_torch.ops import _build
from item_alignment_torch.ops import cuda_attention_train as train
from item_alignment_torch.ops._launch import (
    DTYPE_CODE,
    HEAD_DIMS,
    bias_rows,
    check_launchable,
    check_tma,
    cuda_stream,
    entry,
    ptr,
)
from item_alignment_torch.ops.cuda_attention_train import check_inputs

# launches of the CUDA kernel (never counts the CPU plain version)
LAUNCHES = 0


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the attention-dropout plain
    version at rate 0, step by step (64-key tiles, an online softmax from
    the finite -1e30 start with fp32 scores and stats, unnormalised p
    rounded to v's dtype before P.V, and a final divide by max(rowsum,
    1e-37)).  The bf16 kernel takes its exponentials as exp2 of
    log2(e)-scaled scores: the same values up to fp32 rounding.  q/k/v
    ``[B, S, N, H]``, bias ``[B, 1, 1, S]``."""
    return train.fused_attention_dropout_reference(0.0, 0, q, k, v, bias)[0]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel #1 on CUDA tensors."""
    check_launchable(q, k, v)
    check_tma(q, k, v)
    lib, fn = entry("fused_attention", "ia_fused_attention_fwd",
                    "ii" + "p" * 5 + "iii" + "l" * 13 + "fp")
    B, S, N, H = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    rows = bias_rows(bias, B, S)
    with torch.cuda.device(q.device):
        err = fn(
            DTYPE_CODE[q.dtype], H, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ptr(rows), out.data_ptr(), B, S, N,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], 0 if rows is None else rows.stride(0),
            1.0 / math.sqrt(H), cuda_stream(q))
    _build.check(lib, err, "fused attention")
    return out


def smem_bytes() -> dict:
    """Dynamic shared memory a bf16 block of the kernel takes, by head
    dim; builds the library."""
    import ctypes
    fn = _build.load("fused_attention").ia_fused_attention_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return {h: fn(h) for h in HEAD_DIMS}


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(H) + bias) v in q's dtype.  q/k/v
    ``[B, S, N, H]`` (float32 or bfloat16, H in 32/64/128), bias
    ``[B, 1, 1, S]`` additive key bias or None."""
    global LAUNCHES
    check_inputs(q, k, v, bias)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return train.fused_attention_dropout(0.0, 0, q, k, v, bias)
    out = _launch(q, k, v, bias)
    LAUNCHES += 1
    return out
