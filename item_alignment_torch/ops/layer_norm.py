"""LayerNorm as a hand-written CUDA kernel forward and one backward, and
their plain versions.

``layer_norm`` is ``models/layers.py:LayerNorm``'s arithmetic (Flax's
LayerNorm): statistics in fp32, ``mean`` and ``var = max(E[x^2] - mean^2,
0)``, ``y = (x - mean) * (rsqrt(var + eps) * weight) (+ bias)`` in
``dtype``, or in x's type promoted with fp32 when ``dtype`` is None.

- CPU tensors run ``layer_norm_reference``, that formula in plain PyTorch,
  which autograd differentiates.
- CUDA tensors launch ``ia_ln_fwd`` of ``csrc/layer_norm.cu`` and, for the
  gradient, ``ia_ln_bwd`` and ``ia_ln_bwd_params`` (``_LayerNorm``); any
  other device raises.  The kernels take fp32 or bf16 in and out, any
  width up to ``MAX_WIDTH``, and with or without a bias.
- ``layer_norm_stats`` and ``layer_norm_bwd_reference`` are the plain
  versions of what the kernels save and of the analytic backward they
  compute: with ``g = dy * weight`` and ``xhat = (x - mean) * rstd``,
  ``dx = rstd * (g - mean(g) - xhat * mean(g * xhat))``, the last term left
  out on rows whose variance was clamped (as autograd's gradient through
  ``clamp(min=0)`` leaves it out), and the parameter gradients
  ``sum(dy * xhat)`` and ``sum(dy)`` over the rows.  The kernels sum those
  over fixed blocks of rows (``bwd_blocks``), then over the blocks in
  order, so that a call repeats bit for bit.

The kernels replace no TPU kernel: the JAX package leaves LayerNorm to
XLA's fusion.  They were added because the plain chain, about fourteen
fp32 kernels a forward and twenty a backward, took 40-49% of the device's
busy time in every benchmark cell on an H100.  ``FWD_LAUNCHES`` and
``BWD_LAUNCHES`` count the kernels' forward and backward calls (never the
plain versions).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from item_alignment_torch.ops import _build
from item_alignment_torch.ops._launch import DTYPE_CODE, cuda_stream, entry, ptr

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
MAX_WIDTH = 8192  # eight warps of 32 lanes of 32 columns a row
# the backward's blocks of rows, at most: on an H100 one wave of its
# 4-warp blocks (3 fit an SM), 61 us at 20400 rows of 1024 against 69 us
# with 512 (two waves) and 83 us with 128
BWD_BLOCKS = 256


def out_dtype(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype or torch.promote_types(x.dtype, torch.float32)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor], eps: float,
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version: Flax's LayerNorm formula in PyTorch."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + eps) * weight
    y = (xf - mean) * mul
    if bias is not None:
        y = y + bias
    return y.to(out_dtype(x, dtype))


def layer_norm_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's fp32 mean and variance before the clamp, ``[rows]``, as
    the forward computes them and the kernels save them."""
    xf = x.float()
    mean = xf.mean(dim=-1)
    return mean, (xf * xf).mean(dim=-1) - mean * mean


def bwd_blocks(rows: int) -> Tuple[int, int]:
    """(rows a block, blocks) of the backward: at most ``BWD_BLOCKS``
    blocks of consecutive rows, a function of ``rows`` alone."""
    per = -(-rows // BWD_BLOCKS)
    return per, -(-rows // per)


def layer_norm_bwd_reference(x: torch.Tensor, weight: torch.Tensor,
                             mean: torch.Tensor, var: torch.Tensor,
                             dy: torch.Tensor, eps: float):
    """The plain version of the kernels' backward: (dx in x's dtype, dw,
    db) from x and dy ``[rows, H]`` and the forward's ``mean`` and
    unclamped ``var`` ``[rows]``; dw and db fp32."""
    xf, d = x.float(), dy.float()
    rstd = torch.rsqrt(var.clamp(min=0.0) + eps)[:, None]
    xhat = (xf - mean[:, None]) * rstd
    g = d * weight
    mgx = torch.where(var[:, None] < 0, 0.0,
                      (g * xhat).mean(dim=-1, keepdim=True))
    dx = rstd * (g - g.mean(dim=-1, keepdim=True) - xhat * mgx)
    return dx.to(x.dtype), (d * xhat).sum(dim=0), d.sum(dim=0)


def _check(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], dtype: torch.dtype) -> None:
    """What the kernels take: x and the output in fp32 or bf16, widths 1
    to ``MAX_WIDTH``, and contiguous fp32 ``[H]`` parameters on x's
    device."""
    if x.dtype not in DTYPE_CODE or dtype not in DTYPE_CODE:
        raise TypeError(f"the LayerNorm kernels take float32 or bfloat16, "
                        f"got {x.dtype} in and {dtype} out")
    H = x.shape[-1]
    if not 0 < H <= MAX_WIDTH:
        raise ValueError(f"the LayerNorm kernels take widths 1 to "
                         f"{MAX_WIDTH}, got {H}")
    for t in (weight, bias):
        if t is not None and not (
                t.dtype == torch.float32 and t.shape == (H,)
                and t.is_contiguous() and t.device == x.device):
            raise ValueError(f"the LayerNorm kernels take contiguous "
                             f"float32 [{H}] parameters on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def launch_fwd(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float, dtype: torch.dtype,
               stats: bool):
    """(y, mean, var) by ``ia_ln_fwd`` for a contiguous ``[rows, H]`` x;
    mean and var (``[rows]`` fp32) only when ``stats``, else None."""
    global FWD_LAUNCHES
    lib, fn = entry("layer_norm", "ia_ln_fwd", "ii" + "p" * 6 + "lifp")
    rows, H = x.shape
    y = torch.empty((rows, H), dtype=dtype, device=x.device)
    mean = var = None
    if stats:
        mean, var = torch.empty((2, rows), dtype=torch.float32,
                                device=x.device)
    with torch.cuda.device(x.device):
        err = fn(DTYPE_CODE[x.dtype], DTYPE_CODE[dtype], x.data_ptr(),
                 weight.data_ptr(), ptr(bias), y.data_ptr(), ptr(mean),
                 ptr(var), rows, H, eps, cuda_stream(x))
    _build.check(lib, err, "LayerNorm forward")
    FWD_LAUNCHES += 1
    return y, mean, var


def launch_bwd(x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
               var: torch.Tensor, dy: torch.Tensor, eps: float):
    """(dx, dw, db) by ``ia_ln_bwd`` and ``ia_ln_bwd_params`` from the
    forward's contiguous x, mean and var and a contiguous dy."""
    global BWD_LAUNCHES
    lib, fn = entry("layer_norm", "ia_ln_bwd",
                    "ii" + "p" * 7 + "l" + "iii" + "fp")
    _, params = entry("layer_norm", "ia_ln_bwd_params", "ppp" + "ii" + "p")
    rows, H = x.shape
    per, blocks = bwd_blocks(rows)
    dx = torch.empty_like(x)
    # the partials [2, blocks, H], then dw and db, in one allocation
    scratch = torch.empty(2 * (blocks + 1) * H, dtype=torch.float32,
                          device=x.device)
    part = scratch[:2 * blocks * H]
    dw, db = scratch[2 * blocks * H:].view(2, H)
    stream = cuda_stream(x)
    with torch.cuda.device(x.device):
        err = fn(DTYPE_CODE[x.dtype], DTYPE_CODE[dy.dtype], x.data_ptr(),
                 weight.data_ptr(), mean.data_ptr(), var.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), part.data_ptr(), rows, H, per,
                 blocks, eps, stream)
        _build.check(lib, err, "LayerNorm backward")
        err = params(part.data_ptr(), dw.data_ptr(), db.data_ptr(), blocks,
                     H, stream)
    _build.check(lib, err, "LayerNorm backward (parameters)")
    BWD_LAUNCHES += 1
    return dx, dw, db


class _LayerNorm(torch.autograd.Function):
    """The kernels' forward and backward on a contiguous ``[rows, H]`` x."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dtype):
        y, mean, var = launch_fwd(x, weight, bias, eps, dtype, stats=True)
        ctx.save_for_backward(x, weight, mean, var)
        ctx.eps, ctx.has_bias = eps, bias is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, var = ctx.saved_tensors
        dx, dw, db = launch_bwd(x, weight, mean, var, dy.contiguous(),
                                ctx.eps)
        return dx, dw, db if ctx.has_bias else None, None, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm over x's last dimension (module docstring); weight and
    bias ``[H]`` fp32, bias None for none."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cuda or cpu, not {x.device}")
    dt = out_dtype(x, dtype)
    _check(x, weight, bias, dt)
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.shape[0] == 0:
        return torch.empty(x.shape, dtype=dt, device=x.device)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        y = _LayerNorm.apply(x2, weight, bias, eps, dt)
    else:
        y = launch_fwd(x2, weight, bias, eps, dt, stats=False)[0]
    return y.reshape(x.shape)
