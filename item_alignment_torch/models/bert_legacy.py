"""The legacy 5-field BERT member (ensemble member ``bert_base``).

Port of ``item_alignment_tpu/models/bert_legacy.py``:

- ``FIELD_NAMES`` and ``FIELD_MAX_LENS``: the five sentence-pair fields and
  their padded lengths;
- ``NoisyBertBackbone``: ``word_embeddings`` directly under ``bert``, an
  optional additive embedding noise ``noise[:, :S]`` (the adversarial
  deltas), then ``post`` (``EmbedPostprocess``), the encoder and the
  ``Pooler``;
- ``BertAlignModel``: five shared-weight passes over (pvs, title, cate,
  cate_path, industry_name), the pooled outputs summed, then the 2-class
  ``seq_relationship`` head;
- ``sim_eval_weight``: (w[1] - w[0], b[1] - b[0]) of that head;
- ``BertForPretraining``: ``transform_dense``, the activation,
  ``transform_ln`` and an MLM decoder tied to the word-embedding
  ``Parameter`` plus ``mlm_bias``; the masked NLL (labels below 0 are not
  predicted) plus NSP.

Position ids are RoBERTa's, ``cumsum(ids != pad) * (ids != pad) + pad``, so
a row of ``n`` real tokens reads position ``n + pad_token_id``.  The pvs
field is padded to 512 and ``configs/roberta_base.json`` has 512
positions: a padded width of 512 is fine, a row whose 512 tokens are all
real is not.  JAX reads past the table there and gets NaN; the port checks
the real lengths where the arrays are built (``data/bert_data.py``'s
``check_position_ids``) and raises a ``ValueError`` that names the row,
before any device work.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.models.embeddings import (
    EmbedPostprocess,
    create_position_ids,
)
from item_alignment_torch.models.encoder import ACT, Pooler, TransformerEncoder
from item_alignment_torch.models.layers import (
    Dense,
    LayerNorm,
    embedding_lookup,
)
from item_alignment_torch.models.losses import cross_entropy_loss
from item_alignment_torch.models.outputs import PairClassifierOutput
from item_alignment_torch.models.text import Device, _initialise
from item_alignment_torch.device import resolve_device
from item_alignment_torch.ops.dropout import fold_seed

FIELD_NAMES = ("pvs", "title", "cate", "cate_path", "industry_name")
# the fields' padded pair lengths (the reference's data_utils.py:92-94)
FIELD_MAX_LENS = {"pvs": 512, "title": 150, "cate": 20, "cate_path": 50,
                  "industry_name": 20}


class NoisyBertBackbone(nn.Module):
    """Embeddings (with optional additive noise) + encoder + pooler;
    returns (the last hidden states, the pooled [CLS]), both fp32."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size)
        self.post = EmbedPostprocess(config)
        self.encoder = TransformerEncoder(config)
        self.pooler = Pooler(config)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                noise: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        cfg = self.config
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        position_ids = create_position_ids(input_ids, cfg.pad_token_id)
        embeds = embedding_lookup(self.word_embeddings, input_ids)
        if noise is not None:
            embeds = embeds + noise[:, :embeds.shape[1], :]
        hidden = self.post(embeds, token_type_ids, position_ids,
                           deterministic, fold_seed(dropout_seed, 0))
        if cfg.dtype == "bfloat16":
            hidden = hidden.to(torch.bfloat16)
        last = self.encoder(hidden, attention_mask, deterministic,
                            fold_seed(dropout_seed, 1))[-1].float()
        return last, self.pooler(last)


class BertAlignModel(nn.Module):
    """The 5-field pair classifier.  ``fields`` maps each of
    ``FIELD_NAMES`` to {input_ids, attention_mask, token_type_ids} of that
    field's pair; ``pvs_noise`` / ``title_noise`` (``[B, L, H]``, L at least
    the field's length) are added to those fields' word embeddings."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with torch.device(dev):
            self.bert = NoisyBertBackbone(config)
            self.seq_relationship = Dense(config.hidden_size, 2)
        _initialise(self, config, dev, seed)

    def forward(self, fields: Dict[str, Dict[str, torch.Tensor]],
                labels: Optional[torch.Tensor] = None,
                pvs_noise: Optional[torch.Tensor] = None,
                title_noise: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> PairClassifierOutput:
        noise = {"pvs": pvs_noise, "title": title_noise}
        pooled_sum = None
        for i, name in enumerate(FIELD_NAMES):
            f = fields[name]
            _, pooled = self.bert(f["input_ids"], f.get("attention_mask"),
                                  f.get("token_type_ids"), noise.get(name),
                                  deterministic, fold_seed(dropout_seed, i))
            pooled_sum = pooled if pooled_sum is None else pooled_sum + pooled
        logits = self.seq_relationship(pooled_sum)
        probs = torch.softmax(logits, dim=-1)[:, 1]
        loss = None if labels is None else cross_entropy_loss(logits, labels)
        return PairClassifierOutput(loss=loss, logits=logits, probs=probs,
                                    src_embeds=pooled_sum,
                                    tgt_embeds=pooled_sum)


def sim_eval_weight(state: Mapping[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w[1] - w[0], b[1] - b[0]) of the NSP head of a ``BertAlignModel``
    state dict: ``pooled . w + b`` is the class-1-minus-class-0 logit
    margin."""
    w = state["seq_relationship.weight"]  # [2, H]
    b = state["seq_relationship.bias"]
    return w[1] - w[0], b[1] - b[0]


class BertForPretraining(nn.Module):
    """MLM + NSP for the structure-aware domain pretrain.  MLM labels: a
    token id, or below 0 (-1, -100) where nothing is predicted."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        H = config.hidden_size
        with torch.device(dev):
            self.bert = NoisyBertBackbone(config)
            self.transform_dense = Dense(H, H)
            self.transform_ln = LayerNorm(H, config.layer_norm_eps)
            self.mlm_bias = nn.Parameter(torch.zeros(config.vocab_size))
            self.seq_relationship = Dense(H, 2)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                mlm_labels: Optional[torch.Tensor] = None,
                next_label: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        cfg = self.config
        sequence_output, pooled = self.bert(
            input_ids, attention_mask, token_type_ids,
            deterministic=deterministic, dropout_seed=dropout_seed)
        x = self.transform_ln(ACT[cfg.hidden_act](
            self.transform_dense(sequence_output)))
        # the decoder is the word-embedding table itself
        mlm_logits = x @ self.bert.word_embeddings.weight.t() + self.mlm_bias
        nsp_logits = self.seq_relationship(pooled)
        loss = None
        if mlm_labels is not None:
            valid = (mlm_labels >= 0).float()
            logp = torch.log_softmax(mlm_logits.float(), dim=-1)
            nll = -torch.gather(logp, -1,
                                mlm_labels.clamp_min(0)[..., None].long()
                                )[..., 0]
            loss = (nll * valid).sum() / valid.sum().clamp_min(1.0)
            if next_label is not None:
                loss = loss + cross_entropy_loss(nsp_logits, next_label)
        return {"mlm_logits": mlm_logits, "nsp_logits": nsp_logits,
                "loss": loss}
