"""Blockwise attention for long sequences (S > 512): forward, dQ and dK/dV
CUDA kernels, their plain versions, and the autograd function around them.

Port of ``item_alignment_tpu/ops/pallas_attention.py``'s
``fused_attention_blockwise_dropout`` and ``fused_attention_blockwise``
(``_flash_kernel`` forward; ``_flash_dq_kernel`` and ``_flash_dkv_kernel``
backward).

- ``flash_fwd`` launches ``csrc/flash_blockwise_fwd.cu`` (kernel #4): out
  ``[B, S, N, H]`` and the float64 row statistics lse ``[B, N, S]``.
- ``flash_delta`` computes delta = rowsum(g * out) ``[B, N, S]``, which the
  JAX package leaves to XLA (the delta CUDA kernel of
  ``csrc/attention_common.cuh``; it counts as no kernel of its own).
- ``flash_dq`` (kernel #5) and ``flash_dkv`` (kernel #6) launch the two
  entry points of ``csrc/flash_blockwise_bwd.cu``: in bf16 Hopper kernels
  (``wgmma`` products, a TMA ring fed by a producer warp), whose inputs
  ``check_tma`` holds to what TMA takes.
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
and draw the same bits, which at S <= 512 are the bits of kernels #2/#3.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from item_alignment_torch.ops import _build
from item_alignment_torch.ops import cuda_attention_train as train
from item_alignment_torch.ops.cuda_attention_train import (
    DTYPE_CODE,
    _device_kind,
    attention_delta,
    bias_rows,
    check_inputs,
    check_launchable,
    cuda_stream,
)
from item_alignment_torch.ops.dropout import M32, dropout_consts

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
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel #4: the online softmax of
    ``online_softmax_reference`` over the kernel's 64-key tiles.  Returns out
    ``[B, S, N, H]`` in q's dtype and lse ``[B, N, S]`` in float64.  It
    materialises ``[B, N, S, S]`` scores (and int64 hash words with
    dropout): keep B small where S is in the thousands."""
    return train.online_softmax_reference(rate, seed, q, k, v, bias, BLOCK_KV)


def flash_dq_reference(
    rate: float, seed: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], g: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of kernel #5: dq = ds k / sqrt(H) with ds of
    ``backward_terms_reference``.  ``lse`` float64 and ``delta`` fp32 are
    ``[B, N, S]``."""
    _, ds = train.backward_terms_reference(rate, seed, q, k, v, bias, g, lse,
                                           delta)
    return train.dq_reference(ds, k)


def flash_dkv_reference(
    rate: float, seed: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], g: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel #6: dk = ds^T q / sqrt(H) and
    dv = (keep * p_r)^T g."""
    pd, ds = train.backward_terms_reference(rate, seed, q, k, v, bias, g, lse,
                                            delta)
    return train.dkv_reference(pd, ds, q, g)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _entry(name: str, fn: str, argtypes):
    import ctypes
    lib = _build.load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        kinds = {"i": ctypes.c_int, "p": ctypes.c_void_p, "l": ctypes.c_longlong,
                 "f": ctypes.c_float, "u": ctypes.c_uint}
        f.argtypes = [kinds[c] for c in argtypes]
        f.restype = ctypes.c_int
    return lib, f


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(rate, seed, q, k, v, bias):
    check_launchable(q, k, v)
    lib, fn = _entry("flash_blockwise_fwd", "ia_flash_fwd",
                     "ii" + "p" * 6 + "iii" + "l" * 13 + "fuufp")
    B, S, N, H = q.shape
    t, keep_p = dropout_consts(rate)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, N, S), dtype=torch.float64, device=q.device)
    rows = bias_rows(bias, B, S)
    with torch.cuda.device(q.device):
        err = fn(DTYPE_CODE[q.dtype], H, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), _ptr(rows), out.data_ptr(), lse.data_ptr(),
                 B, S, N, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], 0 if rows is None else rows.stride(0),
                 1.0 / math.sqrt(H), int(seed) & M32, t, keep_p, cuda_stream(q))
    _build.check(lib, err, "blockwise attention forward")
    return out, lse


def _launch_delta(g, out):
    check_launchable(g, out)
    lib, fn = _entry("flash_blockwise_bwd", "ia_flash_delta",
                     "ii" + "ppp" + "iii" + "l" * 6 + "p")
    B, S, N, H = g.shape
    delta = torch.empty((B, N, S), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = fn(DTYPE_CODE[g.dtype], H, g.data_ptr(), out.data_ptr(),
                 delta.data_ptr(), B, S, N, *g.stride()[:3], *out.stride()[:3],
                 cuda_stream(g))
    _build.check(lib, err, "blockwise attention delta")
    return delta


def check_tma(*tensors: torch.Tensor) -> None:
    """What TMA, which loads the bf16 tiles of #5 and #6, needs beyond
    ``check_launchable``: a positive stride (below 2^40 bytes) in each of
    the first three dimensions whose size is above 1."""
    if tensors[0].dtype != torch.bfloat16:
        return
    for t in tensors:
        for size, st in zip(t.shape[:3], t.stride()[:3]):
            if size > 1 and not 0 < st * t.element_size() < 2 ** 40:
                raise ValueError(f"bfloat16 q/k/v/g of the blockwise backward "
                                 f"need positive strides below 2^40 bytes "
                                 f"(TMA), got {tuple(t.stride())}")


def _launch_bwd(fn_name, n_out, rate, seed, q, k, v, bias, g, lse, delta):
    check_launchable(q, k, v, g)
    check_tma(q, k, v, g)
    lib, fn = _entry("flash_blockwise_bwd", fn_name,
                     "ii" + "p" * (7 + n_out) + "iii" + "l" * 16 + "fuufp")
    B, S, N, H = q.shape
    t, keep_p = dropout_consts(rate)
    outs = tuple(torch.empty_like(q, memory_format=torch.contiguous_format)
                 for _ in range(n_out))
    rows = bias_rows(bias, B, S)
    lse, delta = lse.contiguous(), delta.contiguous()
    with torch.cuda.device(q.device):
        err = fn(DTYPE_CODE[q.dtype], H, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), g.data_ptr(), _ptr(rows), lse.data_ptr(),
                 delta.data_ptr(), *(o.data_ptr() for o in outs), B, S, N,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *g.stride()[:3], *outs[0].stride()[:3],
                 0 if rows is None else rows.stride(0), 1.0 / math.sqrt(H),
                 int(seed) & M32, t, keep_p, cuda_stream(q))
    _build.check(lib, err, f"blockwise attention backward ({fn_name})")
    return outs


def bwd_smem_bytes() -> dict:
    """Dynamic shared memory a block of the bf16 #5 ("dq") and #6 ("dkv")
    kernels takes, by (kernel, head dim); builds the library."""
    import ctypes
    fn = _build.load("flash_blockwise_bwd").ia_flash_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return {(name, h): fn(i, h) for i, name in enumerate(("dq", "dkv"))
            for h in train.HEAD_DIMS}


def _launch_dq(rate, seed, q, k, v, bias, g, lse, delta):
    return _launch_bwd("ia_flash_dq", 1, rate, seed, q, k, v, bias, g, lse,
                       delta)[0]


def _launch_dkv(rate, seed, q, k, v, bias, g, lse, delta):
    return _launch_bwd("ia_flash_dkv", 2, rate, seed, q, k, v, bias, g, lse,
                       delta)


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
              v: torch.Tensor, bias: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #4: (out, lse).  q/k/v ``[B, S, N, H]`` of any S (float32 or
    bfloat16, H in 32/64/128 on CUDA), bias ``[B, 1, 1, S]`` or None,
    ``rate`` in [0, 1), ``seed`` a 32-bit int."""
    global FWD_LAUNCHES
    check_inputs(q, k, v, bias)
    dropout_consts(rate)
    if _device_kind(q, "fused_attention_blockwise") == "cpu":
        return fused_attention_blockwise_reference(rate, seed, q, k, v, bias)
    out = _launch_fwd(rate, seed, q, k, v, bias)
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
             lse: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Kernel #5: dq from the forward's lse, ``flash_delta``'s delta and
    the output gradient ``g``."""
    global DQ_LAUNCHES
    _check_bwd(q, k, v, bias, g, lse, delta)
    g = g.contiguous()
    if _device_kind(q, "fused_attention_blockwise") == "cpu":
        return flash_dq_reference(rate, seed, q, k, v, bias, g, lse, delta)
    dq = _launch_dq(rate, seed, q, k, v, bias, g, lse, delta)
    DQ_LAUNCHES += 1
    return dq


def flash_dkv(rate: float, seed: int, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, bias: Optional[torch.Tensor], g: torch.Tensor,
              lse: torch.Tensor, delta: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #6: (dk, dv) from the same inputs as ``flash_dq``."""
    global DKV_LAUNCHES
    _check_bwd(q, k, v, bias, g, lse, delta)
    g = g.contiguous()
    if _device_kind(q, "fused_attention_blockwise") == "cpu":
        return flash_dkv_reference(rate, seed, q, k, v, bias, g, lse, delta)
    dkv = _launch_dkv(rate, seed, q, k, v, bias, g, lse, delta)
    DKV_LAUNCHES += 1
    return dkv


class _FusedAttentionBlockwiseDropout(torch.autograd.Function):
    """Forward kernel #4; backward delta, then kernels #5 and #6; the mask
    is regenerated from the seed.  The bias is a mask and gets no
    gradient."""

    @staticmethod
    def forward(ctx, rate, seed, q, k, v, bias):
        out, lse = flash_fwd(rate, seed, q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.rate, ctx.seed = rate, seed
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = flash_delta(g, out)
        args = (ctx.rate, ctx.seed, q, k, v, bias, g, lse, delta)
        dq = flash_dq(*args)
        dk, dv = flash_dkv(*args)
        return None, None, dq, dk, dv, None


def fused_attention_blockwise_dropout(rate: float, seed: int, q: torch.Tensor,
                                      k: torch.Tensor, v: torch.Tensor,
                                      bias: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """Attention for any sequence length with inverted dropout on the
    probabilities, in q's dtype; differentiable in q, k and v."""
    return _FusedAttentionBlockwiseDropout.apply(float(rate), int(seed), q, k,
                                                 v, bias)


def fused_attention_blockwise(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """softmax(q k^T / sqrt(H) + bias) v for any sequence length: the rate-0
    case of ``fused_attention_blockwise_dropout``."""
    return fused_attention_blockwise_dropout(0.0, 0, q, k, v, bias)
