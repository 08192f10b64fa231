"""Universal model output: every pair model returns
(loss, logits, probs, src_embeds, tgt_embeds)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class PairClassifierOutput:
    logits: Optional[torch.Tensor] = None
    probs: Optional[torch.Tensor] = None
    src_embeds: Optional[torch.Tensor] = None
    tgt_embeds: Optional[torch.Tensor] = None
    loss: Optional[torch.Tensor] = None
