"""Universal model output: every pair model returns
(loss, logits, probs, src_embeds, tgt_embeds).

The dataclass is a pytree node (``torch.export.register_dataclass``), so
that FSDP2 finds the output's tensors and hooks their backward: without it
the root module's gradients are never reduced (the sharded parameters keep
no gradient) when the inputs need none, as token ids do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.export


@dataclass
class PairClassifierOutput:
    logits: Optional[torch.Tensor] = None
    probs: Optional[torch.Tensor] = None
    src_embeds: Optional[torch.Tensor] = None
    tgt_embeds: Optional[torch.Tensor] = None
    loss: Optional[torch.Tensor] = None


torch.export.register_dataclass(PairClassifierOutput)
