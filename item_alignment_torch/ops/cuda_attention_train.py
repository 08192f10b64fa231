"""Fused attention with dropout: forward and backward CUDA kernels, their
plain versions, and the autograd function around them.

Port of ``item_alignment_tpu/ops/pallas_attention.py:fused_attention_dropout``
(``_attn_dropout_kernel`` forward, ``_attn_dropout_bwd_kernel`` backward).

- ``fused_attention_dropout_fwd`` (kernel #2's contract: out ``[B, S, N, H]``
  and the float64 row statistics lse ``[B, N, S]``) runs on the Hopper
  forward of ``csrc/flash_blockwise_fwd.cu``, the kernel that also serves
  #4 at any S (launched through ``ops/_launch.py``).  One call counts once
  in ``FWD_LAUNCHES`` and never in the blockwise module's counters.
- ``fused_attention_dropout_bwd`` (kernel #3's contract: dq, dk, dv) runs on
  the Hopper backward family of ``csrc/flash_blockwise_bwd.cu``: the delta
  kernel, then the dQ and dK/dV kernels that also serve #5 and #6 at any S
  (launched through ``ops/_launch.py``, which this module and
  ``cuda_attention_blockwise`` both import).  One call counts once in
  ``BWD_LAUNCHES`` and never in the blockwise module's counters.
- ``fused_attention_dropout`` is the ``autograd.Function``: it saves the
  seed, q, k, v, the bias, out and lse, and the backward regenerates the
  mask from the seed.

Each wrapper launches its kernels for CUDA tensors and runs its plain version
(``*_reference``) for CPU tensors; any other device raises.  The keep bit of
score (b, n, i, j) is a hash of (seed, b, n, i, j) alone
(``keep_mask_reference``; ``csrc/attention_common.cuh`` gives the formula),
so the plain versions draw the same bits as the kernels.  Every function
that draws them takes ``bn_stride`` and ``bn_base``: the pair (b, n) enters
the hash as ``b * bn_stride + n + bn_base``, by default ``(N, 0)``.  A call
on rows ``b0..`` and heads ``n0..`` of a larger batch of ``N_g`` heads (a
data or tensor parallel rank's share) passes ``(N_g, b0 * N_g + n0)`` and
draws that slice of the larger call's bits.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from item_alignment_torch.ops import _launch
from item_alignment_torch.ops.dropout import M32, dropout_consts, mix32

# launches of the CUDA kernels (never counts the CPU plain versions); one
# backward call launches its three CUDA kernels (delta, dQ, dK/dV) and
# counts once
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

BLOCK_N = 64  # keys per tile in the forward kernel
INIT_MAX = -1e30
MIN_DENOM = 1e-37
# the plain versions also take float64 (and then compute in it)
_PLAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def keep_mask_reference(seed: int, B: int, N: int, S: int, threshold: int,
                        like: torch.Tensor, bn_stride: Optional[int] = None,
                        bn_base: int = 0) -> torch.Tensor:
    """Keep bits ``[B, N, S, S]`` of the attention kernels, computed with
    int64 tensor ops on ``like``'s device; (b, n) hashes as ``b *
    bn_stride + n + bn_base`` (``bn_stride`` None: N)."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=like.device)  # noqa: E731
    stride = N if bn_stride is None else int(bn_stride)
    bn = ar(B)[:, None] * stride + ar(N)[None, :] + int(bn_base)
    head = mix32(mix32((int(seed) & M32) ^ 0x9E3779B9) ^ bn)[:, :, None, None]
    i, j = ar(S)[:, None], ar(S)[None, :]
    row = mix32(head ^ i)
    word = mix32(row ^ (j >> 2))
    return ((word >> (8 * (j & 3))) & 0xFF) >= threshold


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> None:
    """Shapes, dtypes and devices the attention kernels take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, S, N, H] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _PLAIN_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention takes float32 or bfloat16 q/k/v of one "
                        f"dtype (float64 on the CPU), got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dimension")
    if bias is not None:
        B, S = q.shape[0], q.shape[1]
        if bias.numel() != B * S or bias.shape[-1] != S:
            raise ValueError(f"bias must be a [B, 1, 1, S] key bias, got "
                             f"{tuple(bias.shape)}")
        if bias.device != q.device:
            raise ValueError(f"bias is on {bias.device}, q on {q.device}")


def _device_kind(q: torch.Tensor, what: str) -> str:
    kind = q.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {q.device}")
    return kind


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    """fp32 as in the kernels; float64 inputs stay float64."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _scores(q, k, bias):
    """Scores [B, N, S, S] = q k^T / sqrt(H) + bias in the accumulation
    dtype."""
    B, S, N, H = q.shape
    ct = _acc_dtype(q)
    qf = q.to(ct).permute(0, 2, 1, 3)
    kf = k.to(ct).permute(0, 2, 1, 3)
    scores = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(H))
    if bias is not None:
        scores = scores + bias.reshape(B, 1, 1, S).to(ct)
    return scores


def online_softmax_reference(
    rate: float, seed: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], block_n: int,
    bn_stride: Optional[int] = None, bn_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels (#2, and #4 of ``cuda_attention_blockwise``) step
    by step, over key tiles of ``block_n``: an online softmax from the finite
    -1e30 start, l summing the undropped mass, keep * p rounded to v's dtype
    before P.V, and out divided by max(l, 1e-37) * keep_p.  Returns out
    ``[B, S, N, H]`` in q's dtype and lse = m + log(max(l, 1e-37))
    ``[B, N, S]`` in float64."""
    B, S, N, H = q.shape
    t, keep_p = dropout_consts(rate)
    scores = _scores(q, k, bias)
    ct = scores.dtype
    vf = v.to(ct).permute(0, 2, 1, 3)
    keep = keep_mask_reference(seed, B, N, S, t, q, bn_stride,
                               bn_base) if t else None
    m = scores.new_full((B, N, S, 1), INIT_MAX)
    l = scores.new_zeros((B, N, S, 1))
    acc = scores.new_zeros((B, N, S, H))
    for t0 in range(0, S, block_n):
        t1 = min(t0 + block_n, S)
        s = scores[..., t0:t1]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., t0:t1], p, torch.zeros_like(p))
        acc = acc * alpha + p.to(v.dtype).to(ct) @ vf[:, :, t0:t1]
        m = m_new
    denom = torch.clamp(l, min=MIN_DENOM)
    out = acc / (denom * keep_p)
    lse = m.double() + torch.log(denom.double())
    return out.permute(0, 2, 1, 3).to(q.dtype), lse[..., 0]


def fused_attention_dropout_reference(
    rate: float, seed: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None, bn_stride: Optional[int] = None,
    bn_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel #2: ``online_softmax_reference`` over
    the kernel's 64-key tiles.  Returns (out, lse)."""
    return online_softmax_reference(rate, seed, q, k, v, bias, BLOCK_N,
                                    bn_stride, bn_base)


def attention_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(g * out) ``[B, N, S]`` in the accumulation dtype, the
    row term of the backward (the plain version of its delta kernel)."""
    ct = _acc_dtype(g)
    return torch.einsum("bsnh,bsnh->bns", g.to(ct), out.to(ct))


def backward_terms_reference(
    rate: float, seed: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], g: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, bn_stride: Optional[int] = None, bn_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two score-shaped terms of the backward kernels (#3, and #5/#6 of
    ``cuda_attention_blockwise``), ``[B, N, S, S]`` in the accumulation
    dtype, each already rounded to q's dtype as the kernels round them:
    keep * p_r and ds = p_r * (where(keep, g v^T, 0) - delta * keep_p), with
    p_r = exp(s - (lse + ln keep_p)) and s - lse taken in float64."""
    B, S, N, H = q.shape
    dt = q.dtype
    t, keep_p = dropout_consts(rate)
    scores = _scores(q, k, bias)
    ct = scores.dtype
    vf, gf = (x.to(ct).permute(0, 2, 1, 3) for x in (v, g))
    shift = lse.double() + math.log(keep_p)
    p_r = torch.exp((scores.double() - shift[..., None]).to(ct))
    dpd = gf @ vf.transpose(-1, -2)
    if t:
        keep = keep_mask_reference(seed, B, N, S, t, q, bn_stride, bn_base)
        pd = torch.where(keep, p_r, torch.zeros_like(p_r))
        dpd = torch.where(keep, dpd, torch.zeros_like(dpd))
    else:
        pd = p_r
    ds = p_r * (dpd - delta.to(ct)[..., None] * keep_p)
    return pd.to(dt).to(ct), ds.to(dt).to(ct)


def dq_reference(ds: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """dq = ds k / sqrt(H), ``[B, S, N, H]`` in k's dtype."""
    kf = k.to(ds.dtype).permute(0, 2, 1, 3)
    scale = 1.0 / math.sqrt(k.shape[-1])
    return ((ds @ kf) * scale).permute(0, 2, 1, 3).to(k.dtype)


def dkv_reference(pd: torch.Tensor, ds: torch.Tensor, q: torch.Tensor,
                  g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk = ds^T q / sqrt(H) and dv = (keep * p_r)^T g, in q's dtype."""
    qf, gf = (x.to(ds.dtype).permute(0, 2, 1, 3) for x in (q, g))
    dk = (ds.transpose(-1, -2) @ qf) * (1.0 / math.sqrt(q.shape[-1]))
    dv = pd.transpose(-1, -2) @ gf
    return tuple(x.permute(0, 2, 1, 3).to(q.dtype) for x in (dk, dv))


def fused_attention_dropout_bwd_reference(
    rate: float, seed: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], g: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, bn_stride: Optional[int] = None, bn_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel #3 (the TPU kernel's algebra):
    ``backward_terms_reference``, then dq = ds k / sqrt(H), dk = ds^T q /
    sqrt(H) and dv = (keep * p_r)^T g.  ``lse`` float64 and ``delta`` fp32
    are ``[B, N, S]``; returns dq, dk, dv in q's dtype."""
    pd, ds = backward_terms_reference(rate, seed, q, k, v, bias, g, lse, delta,
                                      bn_stride, bn_base)
    return (dq_reference(ds, k), *dkv_reference(pd, ds, q, g))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _launch_bwd(rate, seed, q, k, v, bias, g, out, lse, bn_stride=None,
                bn_base=0):
    """Kernel #3's contract on the Hopper backward family: delta =
    rowsum(g * out), then the dQ and dK/dV kernels; (dq, dk, dv)."""
    delta = _launch.launch_delta(g, out)
    args = (rate, seed, q, k, v, bias, g, lse, delta, bn_stride, bn_base)
    return (_launch.launch_dq(*args), *_launch.launch_dkv(*args))


def fused_attention_dropout_fwd(
    rate: float, seed: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None, bn_stride: Optional[int] = None,
    bn_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #2's contract: (out, lse).  q/k/v ``[B, S, N, H]`` (float32 or
    bfloat16, H in 32/64/128 on CUDA), bias ``[B, 1, 1, S]`` or None,
    ``rate`` in [0, 1), ``seed`` a 32-bit int.  On CUDA it launches kernel
    #4 (``_launch.launch_fwd``) and counts once in ``FWD_LAUNCHES``."""
    global FWD_LAUNCHES
    check_inputs(q, k, v, bias)
    dropout_consts(rate)
    if _device_kind(q, "fused_attention_dropout") == "cpu":
        return fused_attention_dropout_reference(rate, seed, q, k, v, bias,
                                                 bn_stride, bn_base)
    out = _launch.launch_fwd(rate, seed, q, k, v, bias, bn_stride, bn_base)
    FWD_LAUNCHES += 1
    return out


def fused_attention_dropout_bwd(
    rate: float, seed: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], g: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, bn_stride: Optional[int] = None, bn_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel #3's contract: (dq, dk, dv) from the forward's out and lse
    (float64 ``[B, N, S]``) and the output gradient ``g``.  On CUDA it
    launches the delta, dQ and dK/dV kernels (``_launch_bwd``) and counts
    once in ``BWD_LAUNCHES``."""
    global BWD_LAUNCHES
    check_inputs(q, k, v, bias)
    for name, t in (("g", g), ("out", out)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q, got {tuple(t.shape)} "
                             f"{t.dtype}")
    g = g.contiguous()
    if _device_kind(q, "fused_attention_dropout") == "cpu":
        return fused_attention_dropout_bwd_reference(
            rate, seed, q, k, v, bias, g, lse, attention_delta(g, out),
            bn_stride, bn_base)
    grads = _launch_bwd(rate, seed, q, k, v, bias, g, out, lse, bn_stride,
                        bn_base)
    BWD_LAUNCHES += 1
    return grads


class _FusedAttentionDropout(torch.autograd.Function):
    """Forward #2's contract, backward #3's; the mask is regenerated from
    the seed.  The bias is a mask and gets no gradient."""

    @staticmethod
    def forward(ctx, rate, seed, q, k, v, bias, bn_stride, bn_base):
        out, lse = fused_attention_dropout_fwd(rate, seed, q, k, v, bias,
                                               bn_stride, bn_base)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.rate, ctx.seed, ctx.bn = rate, seed, (bn_stride, bn_base)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_dropout_bwd(ctx.rate, ctx.seed, q, k, v,
                                                 bias, g, out, lse, *ctx.bn)
        return None, None, dq, dk, dv, None, None, None


def fused_attention_dropout(rate: float, seed: int, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            bn_stride: Optional[int] = None, bn_base: int = 0
                            ) -> torch.Tensor:
    """Attention with inverted dropout on the probabilities, in q's dtype;
    differentiable in q, k and v.  ``bn_stride``/``bn_base``: the keep
    bits' index (the module docstring)."""
    return _FusedAttentionDropout.apply(float(rate), int(seed), q, k, v, bias,
                                        bn_stride, int(bn_base))
