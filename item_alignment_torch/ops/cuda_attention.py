"""Fused attention forward: a hand-written CUDA kernel and its plain version.

Port of ``item_alignment_tpu/ops/pallas_attention.py:fused_attention``
(the ``_attn_kernel`` forward).  ``fused_attention`` launches the kernel in
``csrc/fused_attention.cu`` for CUDA tensors and runs
``fused_attention_reference`` for CPU tensors; any other device raises.

The kernel is compiled with ``nvcc`` into a shared library with a plain C
interface at first use, cached under ``build/kernels/`` by a hash of the
source and flags, and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

# launches of the CUDA kernel (never counts the CPU plain version)
LAUNCHES = 0

BLOCK_N = 64  # keys per tile, as in the kernel
HEAD_DIMS = (32, 64, 128)
INIT_MAX = -1e30
MIN_DENOM = 1e-37

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, step by step: 64-key tiles, an
    online softmax from the finite -1e30 start with fp32 scores and stats,
    unnormalised p rounded to v's dtype before P.V, and a final divide by
    max(rowsum, 1e-37).  (The bf16 kernel takes its exponentials as exp2 of
    log2(e)-scaled scores: the same values up to fp32 rounding.)  q/k/v
    ``[B, S, N, H]``, bias ``[B, 1, 1, S]``."""
    B, S, N, H = q.shape
    scale = 1.0 / math.sqrt(H)
    qf = q.float().permute(0, 2, 1, 3)           # [B, N, S, H]
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    # every score is one fp32 dot product, as in the kernel; taking them in
    # one product keeps the summation order of the plain path
    scores = (qf @ kf.transpose(-1, -2)) * scale        # [B, N, S, S]
    if bias is not None:
        scores = scores + bias.reshape(B, 1, 1, S).float()
    m = torch.full((B, N, S, 1), INIT_MAX, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, N, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, N, S, H), dtype=torch.float32, device=q.device)
    for t0 in range(0, S, BLOCK_N):
        t1 = min(t0 + BLOCK_N, S)
        s = scores[..., t0:t1]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vf[:, :, t0:t1]
        m = m_new
    out = acc / torch.clamp(l, min=MIN_DENOM)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the fused attention kernel")


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libia_fused_attention-{tag}.so"
    t0 = time.perf_counter()
    log = ""
    if not path.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ia_fused_attention_fwd.argtypes = (
        [i32, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32]
        + [i64] * 13 + [ctypes.c_float, ptr])
    lib.ia_fused_attention_fwd.restype = i32
    lib.ia_cuda_error_string.argtypes = [i32]
    lib.ia_cuda_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(path=str(path), seconds=time.perf_counter() - t0,
                      log=log)
    _lib = lib
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor]) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, S, N, H] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
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


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(H) + bias) v in q's dtype.  q/k/v
    ``[B, S, N, H]`` (float32 or bfloat16, H in 32/64/128), bias
    ``[B, 1, 1, S]`` additive key bias or None."""
    global LAUNCHES
    _check(q, k, v, bias)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, not "
                         f"{q.device}")
    B, S, N, H = q.shape
    if H not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {HEAD_DIMS}, "
                         f"got {H}")
    if q.dtype == torch.bfloat16:  # the kernel copies 16-byte chunks
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(f"{name} must be 16-byte aligned with "
                                 f"strides in multiples of 8 elements")
    lib = load_library()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    bias_rows = None
    if bias is not None:
        bias_rows = bias.reshape(B, S).to(torch.float32).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ia_fused_attention_fwd(
            _DTYPE_CODE[q.dtype], H, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias_rows is None else bias_rows.data_ptr(),
            out.data_ptr(), B, S, N,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            0 if bias_rows is None else bias_rows.stride(0),
            1.0 / math.sqrt(H), stream)
    if err != 0:
        msg = lib.ia_cuda_error_string(err).decode()
        raise RuntimeError(f"fused attention launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out
