"""Model families ported so far: the RoBERTa text models."""

from item_alignment_torch.models.outputs import PairClassifierOutput  # noqa: F401
from item_alignment_torch.models.text import (  # noqa: F401
    RobertaBackbone,
    RobertaOneTower,
    RobertaTwoTower,
)
