"""Frozen copies of the port's dropout draws, so that the reference drops
what the program drops.

- ``fold_seed``: the seed of a dropout site under a step's seed (a 32-bit
  integer hash; the port's ``ops/dropout.py``).
- ``hidden_keep``: the embedding and hidden sites' replay dropout: uint8
  draws of a ``torch.Generator`` seeded with the site's seed on the
  tensor's device, kept iff the draw is at least ``round(rate * 256)``;
  survivors scaled by ``1 / keep_p``.
- ``head_keep``: the heads' flax-style dropout: uniform draws of the same
  kind of generator, kept iff below ``1 - rate``; survivors divided by
  ``1 - rate``.
- ``attention_keep``: the attention kernels' keep bit of score (b, n, i,
  j), a hash of (seed, b, n, i, j) alone (the port's
  ``csrc/attention_common.cuh``).

Every draw is over the whole batch and sliced to a block of rows, so a
reference that runs the batch in blocks drops what one call on the whole
batch drops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix32(x):
    """The "lowbias32" integer finaliser on Python ints or int64 tensors."""
    x = x & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def fold_seed(seed: Optional[int], site: int) -> Optional[int]:
    if seed is None:
        return None
    return mix32(int(seed) ^ mix32(int(site) + 0x632BE5AB))


def dropout_consts(rate: float) -> Tuple[int, float]:
    """(threshold on uint8 draws, effective keep probability)."""
    t = int(round(rate * 256.0))
    return t, 1.0 - t / 256.0


def hidden_keep(seed: int, shape, rows: slice, device, rate: float
                ) -> torch.Tensor:
    """Keep mask of a replay-dropout site over ``shape`` (the whole batch),
    rows ``rows``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randint(0, 256, tuple(shape), generator=gen, device=device,
                         dtype=torch.uint8)
    return draw[rows] >= dropout_consts(rate)[0]


def head_keep(seed: int, shape, rows: slice, device, rate: float
              ) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(tuple(shape), generator=gen, device=device)
    return draw[rows] < 1.0 - rate


def attention_keep(seed: int, rows: slice, heads: int, seq: int, rate: float,
                   device) -> torch.Tensor:
    """Keep bits ``[rows, heads, seq, seq]`` of the attention kernels for
    the batch rows ``rows`` (global row indices)."""
    def ar(start, stop):
        return torch.arange(start, stop, dtype=torch.int64, device=device)

    bn = ar(rows.start, rows.stop)[:, None] * heads + ar(0, heads)[None, :]
    head = mix32(mix32((int(seed) & M32) ^ 0x9E3779B9) ^ bn)[:, :, None, None]
    i, j = ar(0, seq)[:, None], ar(0, seq)[None, :]
    word = mix32(mix32(head ^ i) ^ (j >> 2))
    return ((word >> (8 * (j & 3))) & 0xFF) >= dropout_consts(rate)[0]
