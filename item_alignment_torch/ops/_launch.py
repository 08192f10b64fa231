"""What every attention kernel launch shares, and the launchers of the two
Hopper kernel files that serve the contracts with row statistics.

- The checks a launch makes beyond the public functions' shape checks
  (``check_launchable``; ``check_tma`` for the bf16 kernels that load their
  tiles by TMA, which is all of them), the dtype codes of the C interfaces,
  the key bias as fp32 rows, the current stream, and ``entry``, which binds
  one C function of a kernel library with ``ctypes``.
- ``launch_fwd`` launches ``ia_flash_fwd`` of ``csrc/flash_blockwise_fwd.cu``
  (kernel #4), the forward of two contracts:
  ``cuda_attention_train.fused_attention_dropout_fwd`` (TPU kernel #2, the
  forward at S <= 512) and ``cuda_attention_blockwise.flash_fwd`` (#4, any
  S).
- ``launch_delta``, ``launch_dq`` and ``launch_dkv`` launch the three entry
  points of ``csrc/flash_blockwise_bwd.cu`` (the delta kernel, the dQ
  kernel #5 and the dK/dV kernel #6).  Two contracts run on them:
  ``cuda_attention_train.fused_attention_dropout_bwd`` (TPU kernel #3, the
  backward at S <= 512) and ``cuda_attention_blockwise.flash_dq`` /
  ``flash_dkv`` (#5 and #6, any S).

Each contract counts its own launches.  Every bf16 contract is held to
``check_tma`` before anything is built, so a view that TMA cannot load
raises at the forward, not after the forward's work is spent.

This module imports neither wrapper module: both import it, and
``cuda_attention_blockwise`` imports ``cuda_attention_train`` (for the plain
versions), never the other way round.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from item_alignment_torch.ops import _build
from item_alignment_torch.ops.dropout import M32, dropout_consts

HEAD_DIMS = (32, 64, 128)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_launchable(*tensors: torch.Tensor) -> None:
    """What the CUDA kernels need beyond the public functions' checks."""
    if tensors[0].dtype not in DTYPE_CODE:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got "
                        f"{tensors[0].dtype}")
    H = tensors[0].shape[-1]
    if H not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head dims {HEAD_DIMS}, got {H}")
    if tensors[0].dtype == torch.bfloat16:  # the kernels copy 16-byte chunks
        for t in tensors:
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError("bfloat16 q/k/v/g must be 16-byte aligned "
                                 "with strides in multiples of 8 elements")


def check_tma(*tensors: torch.Tensor) -> None:
    """What TMA, which loads the tiles of the bf16 kernels #1, #4, #5 and
    #6, needs beyond ``check_launchable``: a positive stride (below 2^40
    bytes) in each of the first three dimensions whose size is above 1."""
    if tensors[0].dtype != torch.bfloat16:
        return
    for t in tensors:
        for size, st in zip(t.shape[:3], t.stride()[:3]):
            if size > 1 and not 0 < st * t.element_size() < 2 ** 40:
                raise ValueError(f"bfloat16 attention inputs are loaded by "
                                 f"TMA and need positive strides below 2^40 "
                                 f"bytes, got {tuple(t.stride())}")


def bias_rows(bias: Optional[torch.Tensor], B: int, S: int):
    """The [B, 1, 1, S] key bias as contiguous fp32 [B, S] rows."""
    if bias is None:
        return None
    return bias.reshape(B, S).to(torch.float32).contiguous()


def cuda_stream(t: torch.Tensor) -> int:
    """The current stream of t's device, as the raw handle (0.1 us a call
    on an H100's host, against 4 us through ``torch.cuda.current_stream``,
    which builds a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def entry(name: str, fn: str, argtypes: str):
    """Library ``name`` (built at first use) and its C function ``fn``, with
    ``argtypes`` one letter an argument: i int, p pointer, l long long,
    f float, u unsigned int."""
    import ctypes
    lib = _build.load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        kinds = {"i": ctypes.c_int, "p": ctypes.c_void_p, "l": ctypes.c_longlong,
                 "f": ctypes.c_float, "u": ctypes.c_uint}
        f.argtypes = [kinds[c] for c in argtypes]
        f.restype = ctypes.c_int
    return lib, f


def keep_index(N: int, bn_stride: Optional[int], bn_base: int):
    """The kernels' (bn_stride, bn_base) as unsigned ints: the keep bit of
    (b, n) hashes ``b * bn_stride + n + bn_base``; ``(N, 0)`` by default."""
    stride = N if bn_stride is None else int(bn_stride)
    if not (0 < stride < 2 ** 32 and 0 <= int(bn_base) < 2 ** 32):
        raise ValueError(f"bn_stride {bn_stride} / bn_base {bn_base} out of "
                         "the kernels' unsigned range")
    return stride, int(bn_base)


def launch_fwd(rate, seed, q, k, v, bias, bn_stride=None, bn_base=0):
    """(out, lse) by kernel #4: out ``[B, S, N, H]`` in q's dtype, lse
    float64 ``[B, N, S]``; the keep bits at (bn_stride, bn_base)
    (``keep_index``)."""
    check_launchable(q, k, v)
    check_tma(q, k, v)
    lib, fn = entry("flash_blockwise_fwd", "ia_flash_fwd",
                    "ii" + "p" * 6 + "iii" + "l" * 13 + "fuufuup")
    B, S, N, H = q.shape
    stride, base = keep_index(N, bn_stride, bn_base)
    t, keep_p = dropout_consts(rate)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, N, S), dtype=torch.float64, device=q.device)
    rows = bias_rows(bias, B, S)
    with torch.cuda.device(q.device):
        err = fn(DTYPE_CODE[q.dtype], H, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), ptr(rows), out.data_ptr(), lse.data_ptr(),
                 B, S, N, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], 0 if rows is None else rows.stride(0),
                 1.0 / math.sqrt(H), int(seed) & M32, t, keep_p, stride, base,
                 cuda_stream(q))
    _build.check(lib, err, "attention forward")
    return out, lse


def launch_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(g * out), fp32 ``[B, N, S]``, by the delta kernel."""
    check_launchable(g, out)
    lib, fn = entry("flash_blockwise_bwd", "ia_flash_delta",
                    "ii" + "ppp" + "iii" + "l" * 6 + "p")
    B, S, N, H = g.shape
    delta = torch.empty((B, N, S), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = fn(DTYPE_CODE[g.dtype], H, g.data_ptr(), out.data_ptr(),
                 delta.data_ptr(), B, S, N, *g.stride()[:3], *out.stride()[:3],
                 cuda_stream(g))
    _build.check(lib, err, "attention backward delta")
    return delta


def _launch_bwd(fn_name, n_out, rate, seed, q, k, v, bias, g, lse, delta,
                bn_stride=None, bn_base=0):
    check_launchable(q, k, v, g)
    check_tma(q, k, v, g)
    lib, fn = entry("flash_blockwise_bwd", fn_name,
                    "ii" + "p" * (7 + n_out) + "iii" + "l" * 16 + "fuufuup")
    B, S, N, H = q.shape
    stride, base = keep_index(N, bn_stride, bn_base)
    t, keep_p = dropout_consts(rate)
    outs = tuple(torch.empty_like(q, memory_format=torch.contiguous_format)
                 for _ in range(n_out))
    rows = bias_rows(bias, B, S)
    lse, delta = lse.contiguous(), delta.contiguous()
    with torch.cuda.device(q.device):
        err = fn(DTYPE_CODE[q.dtype], H, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), g.data_ptr(), ptr(rows), lse.data_ptr(),
                 delta.data_ptr(), *(o.data_ptr() for o in outs), B, S, N,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *g.stride()[:3], *outs[0].stride()[:3],
                 0 if rows is None else rows.stride(0), 1.0 / math.sqrt(H),
                 int(seed) & M32, t, keep_p, stride, base, cuda_stream(q))
    _build.check(lib, err, f"attention backward ({fn_name})")
    return outs


def launch_dq(rate, seed, q, k, v, bias, g, lse, delta, bn_stride=None,
              bn_base=0) -> torch.Tensor:
    """dq by the dQ kernel, from the forward's float64 lse and fp32 delta
    (both ``[B, N, S]``)."""
    return _launch_bwd("ia_flash_dq", 1, rate, seed, q, k, v, bias, g, lse,
                       delta, bn_stride, bn_base)[0]


def launch_dkv(rate, seed, q, k, v, bias, g, lse, delta, bn_stride=None,
               bn_base=0):
    """(dk, dv) by the dK/dV kernel, from the same inputs as ``launch_dq``."""
    return _launch_bwd("ia_flash_dkv", 2, rate, seed, q, k, v, bias, g, lse,
                       delta, bn_stride, bn_base)
