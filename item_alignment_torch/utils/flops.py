"""Model-FLOP counting of one call, for MFU.

Port of ``item_alignment_tpu/utils/flops.py``, in its convention: the
FLOPs of the products and convolutions a call runs, and nothing for
elementwise work.  A product of any form (``mm``, ``bmm``, ``addmm``,
``baddbmm``, ``einsum``'s products, ``F.linear``) counts ``2·batch·M·N·K``;
a convolution ``2·batch·out_spatial·cout·k_spatial·cin/groups``; a backward
counts its products as JAX counts the transposed dots, and a remat replay
counts again.  ``torch.sparse.mm`` counts 0, as JAX's ``segment_sum`` does.

``count_flops`` runs the call under ``FlopCounter``, a
``torch.utils.flop_counter.FlopCounterMode`` with two additions:

- ``torch._int_mm`` (int8 x int8 -> int32) counts ``2·M·N·K``, where the
  base class counts 0, as JAX counts its int8 ``dot_general``;
- ``count_as`` and ``count_attention`` let an op count its model FLOPs
  itself and hide the ops it runs.  The attention entry point
  (``ops/attention.flash_attention``) counts ``4·B·N·S·T·H`` in the forward
  and ``2·B·N·S·T·H`` for each of dP, dV, dQ and dK its backward takes (8·
  when all are), whether a CUDA kernel runs it (a ctypes call no aten op
  sees) or its plain version (whose tiles' products would count otherwise),
  so the card and the CPU give one number.  These are the counts of XLA's
  ``dot_product_attention``, JAX's attention on the CPU; the Pallas cost
  estimates count more (the kernels' recompute), and are not followed.
  ``ops/quant.int8_mm`` counts the unpadded ``2·M·N·K`` of its product.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

_ACTIVE: Optional["FlopCounter"] = None


def _int_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    m, k = a_shape
    return 2 * m * b_shape[1] * k


class FlopCounter(FlopCounterMode):
    """``FlopCounterMode`` that counts ``torch._int_mm`` and lets an op
    count itself (``count_as``, ``count_attention``).  One may be active at
    a time; ``get_total_flops`` gives the count."""

    def __init__(self):
        super().__init__(display=False,
                         custom_mapping={torch.ops.aten._int_mm: _int_mm_flop})
        self.paused = 0

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a FlopCounter is already counting")
        self.paused = 0
        super().__enter__()
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return super().__exit__(*exc)

    def _count_flops(self, func_packet, out, args, kwargs):
        if self.paused:
            return out
        return super()._count_flops(func_packet, out, args, kwargs)

    def add(self, what: str, flops: int) -> None:
        self.flop_counts["Global"][what] += int(flops)


def count_as(flops: int, fn: Callable, *args: Any, **kwargs: Any) -> Any:
    """``fn(*args, **kwargs)``, counted as ``flops`` whatever ops it runs in
    its forward (its backward is not covered)."""
    counter = _ACTIVE
    if counter is None:
        return fn(*args, **kwargs)
    counter.add(getattr(fn, "__name__", "op"), flops)
    counter.paused += 1
    try:
        return fn(*args, **kwargs)
    finally:
        counter.paused -= 1


def _hide_backward(counter: FlopCounter, out: torch.Tensor, inputs,
                   name: str, flops: int) -> None:
    """Count ``flops`` when the backward reaches ``out`` and none of the ops
    of the graph between ``out`` and ``inputs``: each of its nodes pauses
    the counter while it runs."""
    stop = {t.grad_fn for t in inputs if t.grad_fn is not None}
    nodes, queue = set(), deque([out.grad_fn])
    while queue:
        node = queue.popleft()
        if node is None or node in stop or node in nodes:
            continue
        nodes.add(node)
        queue.extend(n for n, _ in node.next_functions)

    def pause(*_):
        if _ACTIVE is counter:
            counter.paused += 1

    def resume(*_):
        if _ACTIVE is counter:
            counter.paused -= 1

    def reached(grad_outputs):
        if _ACTIVE is counter:
            counter.add(name, flops)

    out.grad_fn.register_prehook(reached)
    for node in nodes:
        node.register_prehook(pause)
        node.register_hook(resume)


def count_attention(fn: Callable, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, *args: Any, **kwargs: Any
                    ) -> torch.Tensor:
    """``fn(q, k, v, *args, **kwargs)``, attention over q ``[B, S, N, H]``
    and k, v ``[B, T, N, H]``, counted by the model formulas: ``4·B·N·S·T·H``
    forward, and in the backward ``2·B·N·S·T·H`` for dV (v needs a
    gradient), dP (q or k does), dQ and dK.  Nothing ``fn`` runs counts."""
    counter = _ACTIVE
    if counter is None:
        return fn(q, k, v, *args, **kwargs)
    B, S, N, H = q.shape
    unit = 2 * B * N * S * k.shape[1] * H
    out = count_as(2 * unit, fn, q, k, v, *args, **kwargs)
    if out.grad_fn is not None:
        need = (v.requires_grad, q.requires_grad or k.requires_grad,
                q.requires_grad, k.requires_grad)
        inputs = [t for t in (q, k, v, *args, *kwargs.values())
                  if isinstance(t, torch.Tensor)]
        _hide_backward(counter, out, inputs, "attention_backward",
                       unit * sum(need))
    return out


def count_flops(fn: Callable, *args: Any, **kwargs: Any) -> int:
    """The model FLOPs of one call of ``fn(*args, **kwargs)``: a forward, or
    a train step with its backward (and its remat replays)."""
    with FlopCounter() as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()
