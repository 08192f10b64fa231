"""Attention ops.

``dot_product_attention`` is the plain math path (any device), with JAX's
continuous-rate dropout on the probabilities.  ``flash_attention``
dispatches to the fused kernels.  At S <= 512: ``ops/cuda_attention.py``
(kernel #1, and kernels #2/#3 at rate 0 when a gradient is wanted) without
dropout, and ``ops/cuda_attention_train.py`` (kernels #2/#3) with dropout.
At S > 512: ``ops/cuda_attention_blockwise.py`` (kernels #4-#6) with and
without dropout.  CUDA tensors launch them; CPU tensors run their plain
versions; a failed build or launch raises (the JAX dispatcher's fallback to
the plain path is not carried over).  Port of
``item_alignment_tpu/ops/attention.py``.

Under tensor parallelism a call holds heads ``[head_offset, head_offset +
N)`` of ``num_heads``, and under data parallelism rows ``b0..`` of the
step's batch (``ops.dropout.batch_rows``): both dropout paths then drop
that slice of what one call on the whole batch and all heads drops.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from item_alignment_torch.engine.observability import span
from item_alignment_torch.ops.cuda_attention import fused_attention
from item_alignment_torch.ops.cuda_attention_blockwise import (
    fused_attention_blockwise,
    fused_attention_blockwise_dropout,
)
from item_alignment_torch.ops.cuda_attention_train import fused_attention_dropout
from item_alignment_torch.ops.dropout import global_rows
from item_alignment_torch.utils.flops import count_attention

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
    dropout_seed: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    head_offset: int = 0,
    num_heads: Optional[int] = None,
) -> torch.Tensor:
    """Plain masked multi-head attention: fp32 scores and softmax, probs
    cast to ``dtype`` before the product with v.  With a rate and a seed,
    each probability is kept with probability 1 - rate and survivors are
    divided by 1 - rate, as JAX's bernoulli dropout does; the draw is over
    the global rows and ``num_heads`` heads, sliced to this call's."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bsnh,btnh->bnst", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(dtype)
    if dropout_rate > 0.0 and dropout_seed is not None:
        B, N = probs.shape[:2]
        b0, total = global_rows()
        gen = torch.Generator(device=probs.device).manual_seed(dropout_seed)
        draws = torch.rand((total or B, num_heads or N) + probs.shape[2:],
                           generator=gen, device=probs.device)
        keep = draws[b0:b0 + B, head_offset:head_offset + N] < 1.0 - dropout_rate
        probs = probs * keep.to(dtype) / (1.0 - dropout_rate)
    ct = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bnst,btnh->bsnh", probs.to(ct), v.to(ct))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    head_offset: int = 0,
    num_heads: Optional[int] = None,
) -> torch.Tensor:
    """Fused attention.  With a rate and a seed it runs
    ``fused_attention_dropout`` (kernels #2/#3, the mask a hash of the
    seed), otherwise ``fused_attention``; at S > 512 their blockwise
    counterparts (kernels #4-#6), which take any S.  CUDA tensors launch
    the kernels, CPU tensors take their plain versions.  Under a FLOP
    counter (``utils/flops.py``) a call counts its model FLOPs, whichever
    runs it."""
    with span("attention"):
        return count_attention(_flash_attention, q, k, v, bias, dropout_rate,
                               dropout_seed, dtype, head_offset, num_heads)


def _flash_attention(q, k, v, bias, dropout_rate, dropout_seed, dtype,
                     head_offset, num_heads) -> torch.Tensor:
    dropout = dropout_rate > 0.0 and dropout_seed is not None
    if dropout:
        # the keep bits of rows b0.. and heads head_offset.. of the step's
        # [total, num_heads] grid
        stride = num_heads or q.shape[2]
        keep_index = (stride, global_rows()[0] * stride + head_offset)
    if q.shape[1] > MAX_FUSED_SEQ:
        if dropout:
            out = fused_attention_blockwise_dropout(dropout_rate, dropout_seed,
                                                    q, k, v, bias, *keep_index)
        else:
            out = fused_attention_blockwise(q, k, v, bias)
    elif dropout:
        out = fused_attention_dropout(dropout_rate, dropout_seed, q, k, v, bias,
                                      *keep_index)
    else:
        out = fused_attention(q, k, v, bias)
    return out.to(dtype)
