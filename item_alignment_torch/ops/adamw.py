"""AdamW's update as one hand-written CUDA multi-tensor kernel, and its
plain version.

``adamw_step`` takes an optimizer step's tensors as four lists (parameters,
gradients and the two moments, one entry a tensor) and updates them in
place: in fp32, ``m' = b1 m + (1 - b1) g``, ``v' = b2 v + (1 - b2) g^2``,
``u = (m' / c1) / (sqrt(v' / c2) + eps)`` (``+ wd p`` where decayed) with
``c = 1 - b^count``, the moments stored back in their own type and ``p +=
-lr u`` where trained.  A frozen parameter keeps its value while its
moments advance.

- CPU tensors run ``adamw_reference``, that chain in ``torch._foreach_*``
  calls, which is the kernel's specification.
- CUDA tensors launch ``ia_adamw`` of ``csrc/adamw.cu``; any other device
  raises, as does a tensor that is not contiguous or lies on another
  device.  Parameters and gradients are fp32 or bf16, the moments fp32 or
  bf16; ``plan`` groups the tensors by their types and cuts each group
  into launches of at most ``MAX_TENSORS``.  The host reads each tensor's
  pointer and length into the launch's own arguments, so a step never
  waits on the device.  A ``Table`` keeps those arguments from step to
  step while the parameters and moments stay where they are: a step then
  checks the gradients and writes their pointers alone.

The kernel replaces no TPU kernel: the JAX package leaves its optax chain
to XLA's fusion.  It was added because the plain chain, about fifteen
passes over fp32 copies of every tensor, took 19.4 ms of a RoBERTa-large
train step on an H100, where reading and writing each parameter once takes
1.94 ms.  ``LAUNCHES`` counts the kernel's launches and ``TENSORS`` the
tensors they stepped (never the plain version's).
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from item_alignment_torch.ops import _build
from item_alignment_torch.ops._launch import DTYPE_CODE, cuda_stream, entry

LAUNCHES = 0
TENSORS = 0
MAX_TENSORS = 512  # a launch's table, csrc/adamw.cu:kMaxTensors
CHUNK = 16384  # elements a block takes, csrc/adamw.cu:kChunk
TRAINED, DECAY = 1, 2  # the table's flags


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """``(1 - b1^count, 1 - b2^count)`` after ``count`` steps."""
    return 1.0 - b1 ** count, 1.0 - b2 ** count


@torch.no_grad()
def adamw_reference(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                    decay: Sequence[bool], trained: Sequence[bool],
                    lr: float, b1: float, b2: float, eps: float, wd: float,
                    count: int) -> None:
    """The plain version: the kernel's update as a chain of
    ``torch._foreach_*`` passes, in place."""
    c1, c2 = bias_corrections(b1, b2, count)
    g32 = [g.float() for g in grads]
    m = torch._foreach_mul([t.float() for t in mu], b1)
    torch._foreach_add_(m, g32, alpha=1.0 - b1)
    v = torch._foreach_mul([t.float() for t in nu], b2)
    torch._foreach_addcmul_(v, g32, g32, value=1.0 - b2)
    denom = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(m, c1)
    torch._foreach_div_(upd, denom)
    decayed = [i for i, d in enumerate(decay) if d]
    if wd and decayed:
        torch._foreach_add_([upd[i] for i in decayed],
                            [params[i].float() for i in decayed], alpha=wd)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_copy_(list(mu), m)
    torch._foreach_copy_(list(nu), v)
    moved = [i for i, t in enumerate(trained) if t]
    if moved:
        torch._foreach_add_([params[i] for i in moved],
                            [upd[i] for i in moved])


def plan(keys: Sequence[Hashable], sizes: Sequence[int]
         ) -> List[Tuple[Hashable, List[int], List[int]]]:
    """The launches of a step over tensors of type ``keys[i]`` and
    ``sizes[i]`` elements: ``(key, indices, chunk_end)`` a launch, the
    tensors of one key in their order, at most ``MAX_TENSORS`` a launch,
    and ``chunk_end[j]`` the running count of ``CHUNK``-element chunks
    through the launch's j-th tensor (its grid is the last).  Empty tensors
    take no launch."""
    groups: Dict[Hashable, List[int]] = {}
    for i, (key, n) in enumerate(zip(keys, sizes)):
        if n:
            groups.setdefault(key, []).append(i)
    out = []
    for key, idx in groups.items():
        for s in range(0, len(idx), MAX_TENSORS):
            part = idx[s:s + MAX_TENSORS]
            ends = np.cumsum([-(-sizes[i] // CHUNK) for i in part])
            out.append((key, part, ends.tolist()))
    return out


def _check(params, grads, mu, nu) -> torch.device:
    """What the kernel takes: four lists of one length, each entry four
    contiguous tensors of one length on one CUDA device, parameters and
    gradients fp32 or bf16, the two moments of one type, fp32 or bf16."""
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError(f"adamw_step takes lists of one length, got "
                         f"{len(params)}, {len(grads)}, {len(mu)}, {len(nu)}")
    device = params[0].device
    for group in zip(params, grads, mu, nu):
        n = group[0].numel()
        for t in group:
            if t.device != device or not t.is_contiguous() or t.numel() != n:
                raise ValueError(
                    f"the AdamW kernel takes contiguous tensors of one length "
                    f"on {device}, got {tuple(t.shape)} "
                    f"{'contiguous' if t.is_contiguous() else 'strided'} on "
                    f"{t.device} beside {n} elements")
            if t.dtype not in DTYPE_CODE:
                raise TypeError(f"the AdamW kernel takes float32 or bfloat16, "
                                f"got {t.dtype}")
        if group[2].dtype != group[3].dtype:
            raise TypeError(f"the moments differ in type: {group[2].dtype} "
                            f"and {group[3].dtype}")
    return device


class Table:
    """A step's launches kept for the next: ``plan``'s groups, each with
    its (p, g, m, v) rows of pointers, lengths, chunk ends and flags.
    ``key`` holds what they were built from (each parameter's and
    moment's address, type and length, the parameters' contiguity, the
    gradients' types, the flags),
    so a step whose parameters and moments stay where they are rebuilds
    nothing and writes only the gradients' row."""

    def __init__(self):
        self.key = None
        self.device = None
        self.groups: list = []

    def build(self, params, grads, mu, nu, decay, trained, wd) -> None:
        self.key = None
        self.device = _check(params, grads, mu, nu)
        keys = [(DTYPE_CODE[p.dtype], DTYPE_CODE[g.dtype], DTYPE_CODE[m.dtype])
                for p, g, m in zip(params, grads, mu)]
        flags = np.array([TRAINED * bool(t) + DECAY * bool(d and wd)
                          for d, t in zip(decay, trained)], dtype=np.uint8)
        self.groups = []
        for types, idx, ends in plan(keys, [p.numel() for p in params]):
            ptrs = np.array([[t[i].data_ptr() for i in idx]
                             for t in (params, grads, mu, nu)],
                            dtype=np.uint64)
            n = [params[i].numel() for i in idx]
            self.groups.append((types, idx, n, ptrs,
                                np.array(n, dtype=np.int64),
                                np.array(ends, dtype=np.int32),
                                np.ascontiguousarray(flags[idx])))

    def grads(self, grads) -> None:
        """Check the step's gradients (contiguous, of their parameter's
        length, on the table's device; their types are in ``key``) and
        write their pointers into the gradients' row."""
        for _, idx, n, ptrs, *_ in self.groups:
            row = []
            for i, k in zip(idx, n):
                g = grads[i]
                if (g.device != self.device or not g.is_contiguous()
                        or g.numel() != k):
                    raise ValueError(
                        f"the AdamW kernel takes contiguous tensors of one "
                        f"length on {self.device}, got a gradient "
                        f"{tuple(g.shape)} "
                        f"{'contiguous' if g.is_contiguous() else 'strided'} "
                        f"on {g.device} beside {k} elements")
                row.append(g.data_ptr())
            ptrs[1] = row


def _key(params, grads, mu, nu, decay, trained, wd) -> tuple:
    """What a ``Table`` is built from (its docstring)."""
    return ((len(params), len(grads), len(mu), len(nu), bool(wd)),
            tuple((p.data_ptr(), p.dtype, p.numel(), p.is_contiguous(),
                   m.data_ptr(), m.dtype, v.data_ptr(), v.dtype, g.dtype)
                  for p, g, m, v in zip(params, grads, mu, nu)),
            tuple(map(bool, decay)), tuple(map(bool, trained)))


def launch(params, grads, mu, nu, decay, trained, lr, b1, b2, eps, wd,
           count, table: Optional[Table] = None) -> None:
    """The step by ``ia_adamw``, one launch a group of ``plan``; ``table``
    (a fresh one when None) is rebuilt only where its key has changed."""
    global LAUNCHES, TENSORS
    table = Table() if table is None else table
    key = _key(params, grads, mu, nu, decay, trained, wd)
    if key != table.key:
        table.build(params, grads, mu, nu, decay, trained, wd)
    else:
        table.grads(grads)
    table.key = key
    lib, fn = entry("adamw", "ia_adamw", "iiii" + "pppp" + "f" * 9 + "p")
    c1, c2 = bias_corrections(b1, b2, count)
    stream = cuda_stream(params[0])
    with torch.cuda.device(table.device):
        for types, idx, _, ptrs, n, chunk_end, flags in table.groups:
            err = fn(*types, len(idx), ptrs.ctypes.data, n.ctypes.data,
                     chunk_end.ctypes.data, flags.ctypes.data, lr, b1,
                     1.0 - b1, b2, 1.0 - b2, c1, c2, eps, wd, stream)
            _build.check(lib, err, "AdamW")
            LAUNCHES += 1
            TENSORS += len(idx)


def adamw_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
               decay: Sequence[bool], trained: Sequence[bool], lr: float,
               b1: float, b2: float, eps: float, wd: float,
               count: int, table: Optional[Table] = None) -> None:
    """One AdamW step in place (module docstring); ``count`` is the step's
    number from 1, which sets the bias corrections; ``table`` keeps the
    kernel's launches from one step to the next."""
    if not params:
        return
    device = params[0].device
    if device.type == "cpu":
        adamw_reference(params, grads, mu, nu, decay, trained, lr, b1, b2,
                        eps, wd, count)
    elif device.type == "cuda":
        launch(params, grads, mu, nu, decay, trained, lr, b1, b2, eps, wd,
               count, table=table)
    else:
        raise ValueError(f"adamw_step runs on cuda or cpu, not {device}")
