"""Dropout and the dropout seeds.

Port of ``item_alignment_tpu/ops/dropout.py`` (``replay_dropout``,
``ReplayDropout``) and of flax's ``nn.Dropout`` as the heads use it.

Every mask is a pure function of integers.  A training step has one seed
(``Trainer`` derives it from ``(config.seed, step)``); each dropout site
folds in a site number fixed by the model's structure (a layer's index, the
site's place in the layer) with ``fold_seed``, never a counter that advances
per call.  So recomputing a layer's forward in the backward (remat) draws the
same masks, without help from ``torch.utils.checkpoint``'s RNG stashing
(which covers only the global generators).

- ``replay_dropout``: inverted dropout on uint8 draws, keep iff draw >=
  round(rate * 256), survivors scaled by 1 / keep_p with the effective keep
  probability keep_p = 1 - round(rate * 256) / 256.  Its backward draws the
  mask again from the seed instead of saving it.  The encoder's hidden and
  embedding sites use it.  Plain torch: the JAX package has no Pallas
  kernel for it.
- ``dropout``: flax ``nn.Dropout``: keep with probability 1 - rate, survivors
  divided by 1 - rate exactly.  The heads use it.

Draws come from a ``torch.Generator`` seeded with the site's seed on the
tensor's device, so they differ between the CPU and the card (and from
JAX's), but never between a forward and its backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x < 2^32, with every intermediate below 2^49
    (so int64 tensors do not overflow)."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix32(x):
    """The "lowbias32" 32-bit integer finaliser, on Python ints or int64
    tensors; the attention kernels compute the same function in CUDA
    (``csrc/attention_common.cuh``)."""
    x = x & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def fold_seed(seed: Optional[int], site: int) -> Optional[int]:
    """The seed (a 32-bit int) of dropout site ``site`` under ``seed``;
    None (evaluation) stays None."""
    if seed is None:
        return None
    return mix32(int(seed) ^ mix32(int(site) + 0x632BE5AB))


def dropout_consts(rate: float) -> Tuple[int, float]:
    """(threshold, keep_p) of dropout on uint8 draws, as the TPU kernels'
    ``_keep_mask_u8``: keep iff the draw >= round(rate * 256); survivors
    are scaled by 1 / keep_p, the effective keep probability."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    t = int(round(rate * 256.0))
    return t, 1.0 - t / 256.0


def _replay_keep(seed: int, shape, device, threshold: int) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.randint(0, 256, shape, generator=gen, device=device,
                          dtype=torch.uint8)
    return draws >= threshold


class _ReplayDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rate: float, seed: int, x: torch.Tensor) -> torch.Tensor:
        t, keep_p = dropout_consts(rate)
        ctx.rate, ctx.seed = rate, seed
        keep = _replay_keep(seed, x.shape, x.device, t)
        return torch.where(keep, x * (1.0 / keep_p), torch.zeros_like(x))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        t, keep_p = dropout_consts(ctx.rate)
        keep = _replay_keep(ctx.seed, g.shape, g.device, t)
        return None, None, torch.where(keep, g * (1.0 / keep_p),
                                       torch.zeros_like(g))


def replay_dropout(rate: float, seed: int, x: torch.Tensor) -> torch.Tensor:
    """Inverted dropout whose backward regenerates the mask from ``seed``."""
    if dropout_consts(rate)[0] == 0:
        return x
    return _ReplayDropout.apply(rate, seed, x)


def dropout(x: torch.Tensor, rate: float, seed: Optional[int],
            deterministic: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, survivors
    divided by 1 - rate."""
    if deterministic or rate == 0.0:
        return x
    if seed is None:
        raise ValueError("training-mode dropout needs a dropout seed")
    if rate == 1.0:
        return torch.zeros_like(x)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class ReplayDropout(nn.Module):
    """``replay_dropout`` as a module: the identity in evaluation
    (``deterministic=True``) or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None,
                deterministic: bool = True) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        if seed is None:
            raise ValueError("training-mode dropout needs a dropout seed")
        return replay_dropout(self.rate, seed, x)
