"""Attention ops.

``dot_product_attention`` is the plain math path (any device);
``flash_attention`` dispatches to the fused CUDA kernel
(``ops/cuda_attention.py``) for CUDA tensors, and to that kernel's plain
version for CPU tensors.  Port of ``item_alignment_tpu/ops/attention.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from item_alignment_torch.ops.cuda_attention import fused_attention

NEG_INF = -1e9  # matches BERT-style additive masking ((1-mask)*-10000 in HF)
MAX_FUSED_SEQ = 512


def make_attention_bias(attention_mask: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, S] {0,1} key mask -> [B, 1, 1, S] additive bias."""
    bias = (1.0 - attention_mask.to(dtype)) * NEG_INF
    return bias[:, None, None, :]


def dot_product_attention(
    q: torch.Tensor,  # [B, S, N, H]
    k: torch.Tensor,  # [B, T, N, H]
    v: torch.Tensor,  # [B, T, N, H]
    bias: Optional[torch.Tensor] = None,  # [B, 1|N, 1|S, T] additive
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain masked multi-head attention: fp32 scores and softmax, probs
    cast to ``dtype`` before the product with v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bsnh,btnh->bnst", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(dtype)
    if dropout_rate > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout_rate
        probs = probs * keep.to(dtype) / (1.0 - dropout_rate)
    ct = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bnst,btnh->bsnh", probs.to(ct), v.to(ct))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Fused attention.  CUDA tensors with no dropout and S <= 512 launch
    the fused kernel; CPU tensors take the plain versions.  The CUDA
    training kernels (dropout) and the blockwise kernels (S > 512) are not
    ported yet, and asking for them raises."""
    if q.device.type == "cuda":
        if dropout_rate > 0.0:
            raise NotImplementedError(
                "attention dropout on CUDA needs the training kernels "
                "(ROADMAP Queue 2 #2-#3, _attn_dropout_kernel and its "
                "backward), not ported yet")
        if q.shape[1] > MAX_FUSED_SEQ:
            raise NotImplementedError(
                f"S={q.shape[1]} > {MAX_FUSED_SEQ} on CUDA needs the blockwise "
                "kernels (ROADMAP Queue 2 #4-#6, _flash_kernel), not ported "
                "yet")
    elif dropout_rate > 0.0:
        return dot_product_attention(q, k, v, bias, dropout_rate, generator,
                                     dtype)
    return fused_attention(q, k, v, bias).to(dtype)
