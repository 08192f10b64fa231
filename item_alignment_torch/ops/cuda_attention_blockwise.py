"""Blockwise attention for long sequences (S > 512): forward, dQ and dK/dV
CUDA kernels, their plain versions, and the autograd function around them.

Port of ``item_alignment_tpu/ops/pallas_attention.py``'s
``fused_attention_blockwise_dropout`` and ``fused_attention_blockwise``
(``_flash_kernel`` forward; ``_flash_dq_kernel`` and ``_flash_dkv_kernel``
backward).

- ``flash_fwd`` launches ``csrc/flash_blockwise_fwd.cu`` (kernel #4): out
  ``[B, S, N, H]`` and the float64 row statistics lse ``[B, N, S]``.  In
  bf16 it is a Hopper kernel (``wgmma`` products, a TMA ring fed by a
  producer warp) that also serves #2's contract
  (``cuda_attention_train.fused_attention_dropout_fwd``), so its launcher
  lives in ``ops/_launch.py`` as well.
- ``flash_delta`` computes delta = rowsum(g * out) ``[B, N, S]``, which the
  JAX package leaves to XLA (the delta CUDA kernel of
  ``csrc/attention_common.cuh``; it counts as no kernel of its own).
- ``flash_dq`` (kernel #5) and ``flash_dkv`` (kernel #6) launch the two
  entry points of ``csrc/flash_blockwise_bwd.cu``, Hopper kernels in bf16
  too.  Their launchers live in ``ops/_launch.py``, because #3's contract
  (``cuda_attention_train.fused_attention_dropout_bwd``) runs on the same
  kernels.  Every bf16 input is held by ``check_tma`` to what TMA takes
  before anything is built.  This module imports ``cuda_attention_train``,
  not the reverse, and its counters count only the calls made here.
- ``fused_attention_blockwise_dropout`` is the ``autograd.Function``: it
  saves the seed, q, k, v, the bias, out and lse, and the backward
  regenerates the mask from the seed.  ``fused_attention_blockwise`` is its
  rate-0 case; without a gradient it still launches kernel #4 (the JAX
  package has no separate kernel without lse either).

Each wrapper launches its kernel for CUDA tensors and runs its plain version
(``*_reference``) for CPU tensors; any other device raises, and nothing
falls back when a build or a launch fails.

Two deliberate differences from the TPU kernels.  Their ``block_q`` and
``block_kv`` arguments are VMEM tile sizes, and they assert S % block == 0
(the JAX dispatcher then falls back to XLA, e.g. at S = 1020).  Here the
kernels mask a ragged last tile, so any S is taken and the public functions
have no block arguments (the tiles are fixed in the sources: a forward
block owns 64 queries, a bf16 backward block 128 rows; PERF.md has the
measurements behind them).  And the keep bit of score (b, n, i, j) is the
package's one hash of (seed, b, n, i, j) (``keep_mask_reference``), not a
per-tile reseed of a hardware generator: the three kernels tile differently
and draw the same bits.  At S <= 512 the same kernels serve #2's and #3's
contracts (``cuda_attention_train``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from item_alignment_torch.ops import _build
from item_alignment_torch.ops import cuda_attention_train as train
from item_alignment_torch.ops._launch import HEAD_DIMS
from item_alignment_torch.ops._launch import launch_delta as _launch_delta
from item_alignment_torch.ops._launch import launch_dkv as _launch_dkv
from item_alignment_torch.ops._launch import launch_dq as _launch_dq
from item_alignment_torch.ops._launch import launch_fwd as _launch_fwd
from item_alignment_torch.ops.cuda_attention_train import (
    _device_kind,
    attention_delta,
    check_inputs,
)
from item_alignment_torch.ops.dropout import dropout_consts

# launches of the CUDA kernels (never counts the CPU plain versions)
FWD_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0

BLOCK_KV = 64  # keys per tile in the forward kernel


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fused_attention_blockwise_reference(
    rate: float, seed: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None, bn_stride: Optional[int] = None,
    bn_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel #4: the online softmax of
    ``online_softmax_reference`` over the kernel's 64-key tiles.  Returns out
    ``[B, S, N, H]`` in q's dtype and lse ``[B, N, S]`` in float64.  It
    materialises ``[B, N, S, S]`` scores (and int64 hash words with
    dropout): keep B small where S is in the thousands."""
    return train.online_softmax_reference(rate, seed, q, k, v, bias, BLOCK_KV,
                                          bn_stride, bn_base)


def flash_dq_reference(
    rate: float, seed: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], g: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, bn_stride: Optional[int] = None, bn_base: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of kernel #5: dq = ds k / sqrt(H) with ds of
    ``backward_terms_reference``.  ``lse`` float64 and ``delta`` fp32 are
    ``[B, N, S]``."""
    _, ds = train.backward_terms_reference(rate, seed, q, k, v, bias, g, lse,
                                           delta, bn_stride, bn_base)
    return train.dq_reference(ds, k)


def flash_dkv_reference(
    rate: float, seed: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], g: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, bn_stride: Optional[int] = None, bn_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel #6: dk = ds^T q / sqrt(H) and
    dv = (keep * p_r)^T g."""
    pd, ds = train.backward_terms_reference(rate, seed, q, k, v, bias, g, lse,
                                            delta, bn_stride, bn_base)
    return train.dkv_reference(pd, ds, q, g)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def smem_bytes() -> dict:
    """Dynamic shared memory a block of the bf16 #4 ("fwd"), #5 ("dq") and
    #6 ("dkv") kernels takes, by (kernel, head dim); builds the libraries."""
    import ctypes
    fwd = _build.load("flash_blockwise_fwd").ia_flash_fwd_smem_bytes
    fwd.argtypes = [ctypes.c_int]
    bwd = _build.load("flash_blockwise_bwd").ia_flash_bwd_smem_bytes
    bwd.argtypes = [ctypes.c_int, ctypes.c_int]
    fwd.restype = bwd.restype = ctypes.c_int
    return {(name, h): fwd(h) if name == "fwd" else bwd(i - 1, h)
            for i, name in enumerate(("fwd", "dq", "dkv")) for h in HEAD_DIMS}


def _check_bwd(q, k, v, bias, g, lse, delta):
    check_inputs(q, k, v, bias)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"g must match q, got {tuple(g.shape)} {g.dtype}")
    B, S, N, _ = q.shape
    for name, t, dtypes in (("lse", lse, (torch.float64,)),
                            ("delta", delta, (torch.float32, torch.float64))):
        if tuple(t.shape) != (B, N, S) or t.dtype not in dtypes:
            raise ValueError(f"{name} must be [B, N, S] = {(B, N, S)}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def flash_fwd(rate: float, seed: int, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, bias: Optional[torch.Tensor] = None,
              bn_stride: Optional[int] = None, bn_base: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #4: (out, lse).  q/k/v ``[B, S, N, H]`` of any S (float32 or
    bfloat16, H in 32/64/128 on CUDA), bias ``[B, 1, 1, S]`` or None,
    ``rate`` in [0, 1), ``seed`` a 32-bit int, ``bn_stride``/``bn_base``
    the keep bits' index (``cuda_attention_train``)."""
    global FWD_LAUNCHES
    check_inputs(q, k, v, bias)
    dropout_consts(rate)
    if _device_kind(q, "fused_attention_blockwise") == "cpu":
        return fused_attention_blockwise_reference(rate, seed, q, k, v, bias,
                                                   bn_stride, bn_base)
    out = _launch_fwd(rate, seed, q, k, v, bias, bn_stride, bn_base)
    FWD_LAUNCHES += 1
    return out


def flash_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(g * out) ``[B, N, S]`` (fp32; float64 inputs on the
    CPU stay float64)."""
    if g.shape != out.shape or g.dtype != out.dtype:
        raise ValueError(f"g must match out, got {tuple(g.shape)} {g.dtype}")
    if _device_kind(g, "fused_attention_blockwise") == "cpu":
        return attention_delta(g, out)
    return _launch_delta(g.contiguous(), out)


def flash_dq(rate: float, seed: int, q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, bias: Optional[torch.Tensor], g: torch.Tensor,
             lse: torch.Tensor, delta: torch.Tensor,
             bn_stride: Optional[int] = None, bn_base: int = 0
             ) -> torch.Tensor:
    """Kernel #5: dq from the forward's lse, ``flash_delta``'s delta and
    the output gradient ``g``."""
    global DQ_LAUNCHES
    _check_bwd(q, k, v, bias, g, lse, delta)
    g = g.contiguous()
    if _device_kind(q, "fused_attention_blockwise") == "cpu":
        return flash_dq_reference(rate, seed, q, k, v, bias, g, lse, delta,
                                  bn_stride, bn_base)
    dq = _launch_dq(rate, seed, q, k, v, bias, g, lse, delta, bn_stride,
                    bn_base)
    DQ_LAUNCHES += 1
    return dq


def flash_dkv(rate: float, seed: int, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, bias: Optional[torch.Tensor], g: torch.Tensor,
              lse: torch.Tensor, delta: torch.Tensor,
              bn_stride: Optional[int] = None, bn_base: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #6: (dk, dv) from the same inputs as ``flash_dq``."""
    global DKV_LAUNCHES
    _check_bwd(q, k, v, bias, g, lse, delta)
    g = g.contiguous()
    if _device_kind(q, "fused_attention_blockwise") == "cpu":
        return flash_dkv_reference(rate, seed, q, k, v, bias, g, lse, delta,
                                   bn_stride, bn_base)
    dkv = _launch_dkv(rate, seed, q, k, v, bias, g, lse, delta, bn_stride,
                      bn_base)
    DKV_LAUNCHES += 1
    return dkv


class _FusedAttentionBlockwiseDropout(torch.autograd.Function):
    """Forward kernel #4; backward delta, then kernels #5 and #6; the mask
    is regenerated from the seed.  The bias is a mask and gets no
    gradient."""

    @staticmethod
    def forward(ctx, rate, seed, q, k, v, bias, bn_stride, bn_base):
        out, lse = flash_fwd(rate, seed, q, k, v, bias, bn_stride, bn_base)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.rate, ctx.seed, ctx.bn = rate, seed, (bn_stride, bn_base)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = flash_delta(g, out)
        args = (ctx.rate, ctx.seed, q, k, v, bias, g, lse, delta, *ctx.bn)
        dq = flash_dq(*args)
        dk, dv = flash_dkv(*args)
        return None, None, dq, dk, dv, None, None, None


def fused_attention_blockwise_dropout(rate: float, seed: int, q: torch.Tensor,
                                      k: torch.Tensor, v: torch.Tensor,
                                      bias: Optional[torch.Tensor] = None,
                                      bn_stride: Optional[int] = None,
                                      bn_base: int = 0) -> torch.Tensor:
    """Attention for any sequence length with inverted dropout on the
    probabilities, in q's dtype; differentiable in q, k and v."""
    return _FusedAttentionBlockwiseDropout.apply(float(rate), int(seed), q, k,
                                                 v, bias, bn_stride,
                                                 int(bn_base))


def fused_attention_blockwise(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """softmax(q k^T / sqrt(H) + bias) v for any sequence length: the rate-0
    case of ``fused_attention_blockwise_dropout``."""
    return fused_attention_blockwise_dropout(0.0, 0, q, k, v, bias)
