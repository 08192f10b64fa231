"""RoBERTa embeddings.

Port of ``item_alignment_tpu/models/embeddings.py``: ``create_position_ids``,
``EmbedPostprocess`` and ``RobertaEmbeddings`` (with the ``cate_ids`` hook).
The embedding LayerNorm has no compute dtype, so it runs and returns fp32.

One deliberate difference: position ids derived from ``input_ids`` run up to
S + ``pad_token_id``, and a sequence whose last id would lie past the
position table raises a ``ValueError`` here.  In JAX an index past the table
is silent (``nn.Embed`` clamps or fills); in torch it is an index error on
the CPU and a device-side assert on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.models.layers import LayerNorm, embedding_lookup
from item_alignment_torch.ops.dropout import ReplayDropout


def create_position_ids(input_ids: torch.Tensor, padding_idx: int
                        ) -> torch.Tensor:
    """RoBERTa pad-aware position ids: cumsum(mask) * mask + pad id."""
    mask = (input_ids != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class EmbedPostprocess(nn.Module):
    """token_type + position add, LayerNorm, dropout (shared tail)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = config
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dropout = ReplayDropout(cfg.hidden_dropout_prob)

    def forward(self, inputs_embeds, token_type_ids, position_ids,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        x = (inputs_embeds
             + embedding_lookup(self.token_type_embeddings, token_type_ids)
             + embedding_lookup(self.position_embeddings, position_ids))
        x = self.layer_norm(x)
        return self.dropout(x, dropout_seed, deterministic)


class RobertaEmbeddings(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size)
        if config.cate_size:
            self.cate_embeddings = nn.Embedding(config.cate_size,
                                                config.hidden_size)
        self.post = EmbedPostprocess(config)

    def forward(
        self,
        input_ids: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        cate_ids: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        dropout_seed: Optional[int] = None,
    ) -> torch.Tensor:
        cfg = self.config
        if position_ids is None:
            last = input_ids.shape[1] + cfg.pad_token_id
            if last >= cfg.max_position_embeddings:
                raise ValueError(
                    f"a sequence of {input_ids.shape[1]} tokens needs position "
                    f"ids up to {last} (S + pad_token_id), but the position "
                    f"table has max_position_embeddings="
                    f"{cfg.max_position_embeddings} rows; grow the table "
                    f"(utils/hf_import.py copies the pretrained rows)")
            position_ids = create_position_ids(input_ids, cfg.pad_token_id)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        embeds = embedding_lookup(self.word_embeddings, input_ids)
        if cate_ids is not None:
            if not cfg.cate_size:
                raise ValueError("cate_ids passed but config.cate_size unset")
            embeds = embeds + embedding_lookup(self.cate_embeddings, cate_ids)
        return self.post(embeds, token_type_ids, position_ids, deterministic,
                         dropout_seed)
