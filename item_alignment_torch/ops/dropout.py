"""Replay dropout, serving half.

Port of ``item_alignment_tpu/ops/dropout.py:ReplayDropout``.  In evaluation
(``deterministic=True``) or at rate 0 it is the identity.  The training form,
inverted dropout on uint8 draws whose backward regenerates the keep mask, is
ported with the training slice; asking for it raises.
"""

from __future__ import annotations

import torch
from torch import nn


class ReplayDropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        raise NotImplementedError(
            "training-mode replay dropout is not ported yet (ROADMAP Queue 1 "
            "#2, training slice)")
