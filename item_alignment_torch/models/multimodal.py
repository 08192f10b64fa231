"""The multimodal RobertaImage family: backbone, one-tower, two-tower.

Port of the RoBERTa+image towers of ``item_alignment_tpu/models/
multimodal.py`` (``RobertaImageBackbone``, ``RobertaImageOneTower``,
``RobertaImageTwoTower``).  Image embeddings (``image_hidden_size`` floats
an item, from an image tower run offline) are spliced over the
``[unused99]`` token positions (``ensemble == "begin"``) or concatenated at
the classification head (``"end"``).  The constructors take ``device``
(None means ``"cuda"``) and ``seed`` as the text models of
``models/text.py`` do, and parameter names follow the Flax tree.  CoCa is
not ported yet (ROADMAP Queue 1 #11: CoCa).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.device import resolve_device
from item_alignment_torch.models.embeddings import ImageSpliceEmbeddings
from item_alignment_torch.models.encoder import TransformerEncoder
from item_alignment_torch.models.heads import TwoTowerClassificationHead
from item_alignment_torch.models.outputs import PairClassifierOutput
from item_alignment_torch.models.text import (
    Device,
    _encode,
    _initialise,
    _OneTowerHead,
    _two_tower_output,
)
from item_alignment_torch.ops.dropout import fold_seed


class RobertaImageBackbone(nn.Module):
    """Image-splice embeddings + encoder; returns all hidden states in
    fp32 (the encoder in bf16 under ``dtype="bfloat16"``)."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with torch.device(dev):
            self.embeddings = ImageSpliceEmbeddings(config)
            self.encoder = TransformerEncoder(config)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids, image_embeds, attention_mask=None,
                token_type_ids=None, position_ids=None, image_indices=None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        hidden = self.embeddings(input_ids, image_embeds, token_type_ids,
                                 position_ids, attention_mask, image_indices,
                                 deterministic, fold_seed(dropout_seed, 0))
        return _encode(self, hidden, attention_mask, deterministic,
                       dropout_seed)


class RobertaImageOneTower(nn.Module):
    """``[CLS] [IMG] [SEP] src [SEP] [IMG] [SEP] tgt [SEP]`` with both
    images spliced in (``begin``), or the plain pair with the images at the
    head (``end``).  The vec_sim tgt position is ``item_seq_len``, which
    does not count the ``[IMG] [SEP]`` prefix, as in the JAX package."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.roberta = RobertaImageBackbone(config, dev, seed=None)
        with torch.device(dev):
            self.head = _OneTowerHead(config, config.item_seq_len)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids, src_image_embeds, tgt_image_embeds,
                attention_mask=None, token_type_ids=None, position_ids=None,
                image_indices=None, labels=None, deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> PairClassifierOutput:
        images = (src_image_embeds, tgt_image_embeds)
        states = self.roberta(input_ids, images, attention_mask,
                              token_type_ids, position_ids, image_indices,
                              deterministic, fold_seed(dropout_seed, 0))
        return self.head(states, labels, None, deterministic,
                         fold_seed(dropout_seed, 1),
                         images if self.config.ensemble == "end" else None)


class RobertaImageTwoTower(nn.Module):
    """Two shared-weight passes, each item's image spliced at position 1
    (``begin``); CLS pair -> two-tower head."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.roberta = RobertaImageBackbone(config, dev, seed=None)
        with torch.device(dev):
            self.classifier = TwoTowerClassificationHead(
                config.hidden_size, dropout_rate=config.hidden_dropout_prob,
                num_labels=config.num_labels)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids_1, image_embeds_1, input_ids_2,
                image_embeds_2, attention_mask_1=None, attention_mask_2=None,
                token_type_ids_1=None, token_type_ids_2=None, labels=None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> PairClassifierOutput:
        out_1 = self.roberta(input_ids_1, (image_embeds_1, image_embeds_1),
                             attention_mask_1, token_type_ids_1,
                             deterministic=deterministic,
                             dropout_seed=fold_seed(dropout_seed, 0))[-1]
        out_2 = self.roberta(input_ids_2, (image_embeds_2, image_embeds_2),
                             attention_mask_2, token_type_ids_2,
                             deterministic=deterministic,
                             dropout_seed=fold_seed(dropout_seed, 1))[-1]
        return _two_tower_output(self, out_1, out_2, labels, deterministic,
                                 dropout_seed)
