"""Int8 path for the dense projections.

Port of ``item_alignment_tpu/ops/quant.py``.  Symmetric, zero-point-free
quantization:

- weights: per-output-channel absmax scales, quantized in every call from
  the fp32 parameters (checkpoints stay fp32 and load unchanged);
- activations: dynamic per-row (per-token) absmax scales;
- accumulation: int8 x int8 -> int32, dequantized by the outer product of
  the two scale vectors.

Scales and int8 values are computed in fp32 exactly as the JAX package
computes them (``torch.round`` rounds half to even, as ``jnp.round`` does;
the clip is +-127), so both give the same bits.  The int32 product is
``torch._int_mm`` on the CPU and on the card: the JAX package computes it
with ``lax.dot_general`` outside any Pallas kernel, and the accumulators are
exact either way.  ``INT_MM_LAUNCHES`` counts its calls.

This is an inference knob (``ModelConfig.quant="int8"``): ``round`` has no
gradient, so training keeps the float path.

Under tensor parallelism (``int8_matmul_tensor_parallel``) a
column-parallel product takes this rank's output channels, whose scales
are their own; a row-parallel one holds a slice of the feature axis, so
the per-token and per-channel absmax are all-reduced (max) over the tensor
axis, and so are the int32 accumulators (sum, exact) before the
dequantization: the result equals one device's bit for bit (the JAX
package leaves those collectives to XLA).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from item_alignment_torch.utils.flops import count_as

_EPS = 1e-8  # guards all-zero rows and channels (padding tokens)
INT_MM_LAUNCHES = 0


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax(dim=-1, keepdim=True)


def quantize_rowwise(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """[..., D] -> ``(x_q int8, scale [..., 1] fp32)`` with per-row absmax
    scales, ``x ~= x_q * scale`` and ``scale = absmax / 127``; ``amax``,
    when given, is the rows' absmax over a wider feature axis."""
    xf = x.float()
    amax = row_absmax(x) if amax is None else amax
    scale = torch.clamp(amax, min=_EPS) / 127.0
    x_q = torch.clamp(torch.round(xf / scale), -127, 127)
    return x_q.to(torch.int8), scale


def quantize_colwise(w: torch.Tensor):
    """[D_in, D_out] -> ``(w_q int8, scale [1, D_out] fp32)`` with
    per-output-channel absmax scales."""
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(amax, min=_EPS) / 127.0
    w_q = torch.clamp(torch.round(wf / scale), -127, 127)
    return w_q.to(torch.int8), scale


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 ``a [M, K]`` and ``b [K, N]``.

    ``torch._int_mm`` on CUDA takes more than 16 rows and K, N multiples of
    8: the rows are padded to at least 17 and K, N to multiples of 8 with
    zeros, which add nothing to an integer sum, and the padding is cut off
    the result."""
    global INT_MM_LAUNCHES
    M, K = a.shape
    N = b.shape[1]
    pad_m, pad_k, pad_n = max(17 - M, 0), -K % 8, -N % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_n, 0, pad_k))
    INT_MM_LAUNCHES += 1
    # a FLOP counter counts the product's own shape, not the padding
    return count_as(2 * M * N * K, torch._int_mm, a, b)[:M, :N]


def int8_matmul_prequant(x_q: torch.Tensor, x_scale: torch.Tensor,
                         weight: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Product with activations already quantized: ``x_q [rows, D_in]``,
    ``x_scale [rows, 1]``, ``weight [D_out, D_in]`` (the port's Dense layout,
    the transpose of Flax's kernel; its rows are the kernel's columns, so
    ``quantize_rowwise(weight)`` is ``quantize_colwise(kernel)`` transposed,
    bit for bit)."""
    w_q, w_scale = quantize_rowwise(weight)
    acc = int8_mm(x_q, w_q.t())                           # [rows, D_out] int32
    y = acc.float() * (x_scale * w_scale.reshape(1, -1))  # rank-1 dequant
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_matmul(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ weight.T + bias`` with both operands quantized to int8 and
    accumulated in int32; ``x`` is [..., D_in] in any float dtype."""
    lead = x.shape[:-1]
    x_q, x_scale = quantize_rowwise(x.reshape(-1, x.shape[-1]))
    y = int8_matmul_prequant(x_q, x_scale, weight, bias, out_dtype)
    return y.reshape(*lead, weight.shape[0])


def int8_matmul_tensor_parallel(x, weight, bias, out_dtype: torch.dtype):
    """``int8_matmul`` of a ``QuantDense`` under tensor parallelism:
    ``weight`` (and ``x``) are DTensors over the tensor axis.  Column-
    parallel (weight rows split): the whole ``x`` against this rank's
    output channels.  Row-parallel (weight columns split): this rank's
    feature slice of ``x``, with the absmax of every token and channel and
    the int32 accumulators all-reduced over the axis."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = weight.device_mesh
    xl = x.to_local() if isinstance(x, DTensor) else x
    w = weight.to_local()
    b = bias.to_local() if isinstance(bias, DTensor) else bias
    lead = xl.shape[:-1]
    x2 = xl.reshape(-1, xl.shape[-1])
    if weight.placements[0] == Shard(0):
        y = int8_matmul(x2, w, b, out_dtype).reshape(*lead, -1)
        return DTensor.from_local(y, mesh, [Shard(y.dim() - 1)],
                                  run_check=False)
    group = mesh.get_group()
    x_amax, w_amax = row_absmax(x2), row_absmax(w)
    for amax in (x_amax, w_amax):
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    x_q, x_scale = quantize_rowwise(x2, x_amax)
    w_q, w_scale = quantize_rowwise(w, w_amax)
    acc = int8_mm(x_q, w_q.t()).contiguous()
    dist.all_reduce(acc, group=group)
    y = acc.float() * (x_scale * w_scale.reshape(1, -1))
    if b is not None:
        y = y + b.float()
    return DTensor.from_local(y.to(out_dtype).reshape(*lead, -1), mesh,
                              [Replicate()], run_check=False)
