"""RoBERTa: the port's cross-encoder (``one_tower``), its shared-weight
two-tower encoder (``two_tower``) and the RobertaImage cross-encoder
(``image_one_tower``), as a model family of the benchmark.

A family is what the jobs know of a model.  A configuration file names
its family (``"family": "roberta"``) and ``cell.py`` finds this file by
that name.  A family module gives:

- ``KINDS``, the models it builds, and ``build``, the program's model of
  a kind holding the seed's weights;
- ``param_shapes``, ``is_norm_scale`` and ``decays``: the weights' layout,
  the scales that ``weights.make`` starts at 1, AdamW's decayed leaves;
- the reference's entries the jobs call: ``fp32_exact``,
  ``one_tower_logits``, ``item_embedding``, ``two_tower_probs`` and the
  train check's ``run_steps``;
- the hand counts ``forward_flop``, ``train_flop`` and ``pair_score_flop``;
- ``attention_record``, what ``metrics/attn_roofline.py`` reads;
- ``SPANS``, the module spans its program opens beyond those that code
  shared by every family opens (``spans.MODULES``).

This one delegates: its arithmetic is ``reference/roberta.py``,
``reference/layout.py``, ``reference/train.py`` and ``flops.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.models import RobertaOneTower, RobertaTwoTower
from item_alignment_torch.models.multimodal import RobertaImageOneTower

from portbench import flops, port, weights
from portbench.reference import layout
from portbench.reference import roberta as ref
from portbench.reference import train as ref_train

KINDS = layout.KINDS
MODELS = {"one_tower": RobertaOneTower, "two_tower": RobertaTwoTower,
          "image_one_tower": RobertaImageOneTower}
# RoBERTa's embeddings (models/embeddings.py) and its encoder's GELU
# (models/encoder.py)
SPANS = ("embeddings", "gelu")

param_shapes = layout.param_shapes
is_norm_scale = layout.is_layer_norm_scale
decays = layout.decays
fp32_exact = ref.fp32_exact
item_embedding = ref.item_embedding
two_tower_probs = ref.two_tower_probs
run_steps = ref_train.run_steps
pair_score_flop = flops.two_tower_scores


def model_config(sizes: Dict, dtype: str, **overrides) -> ModelConfig:
    """The port's config of a configuration file's ``model`` sizes, with
    the pair layout of 2 x (``max_seq_len`` + ``max_seq_len_pv``)."""
    known = set(ModelConfig.__dataclass_fields__)
    kw = {k: v for k, v in sizes.items() if k in known}
    kw.update(dtype=dtype, **overrides)
    return ModelConfig(**kw)


def build(kind: str, sizes: Dict, dtype: str, seed: int, device,
          **overrides) -> torch.nn.Module:
    """The port's model of ``kind`` at ``sizes`` (``overrides`` on the
    port's config), holding the benchmark's weights of ``seed``."""
    model = MODELS[kind](model_config(sizes, dtype, **overrides),
                         device=device, seed=None)
    weights.load_into(model, weights.make(param_shapes(sizes, kind), seed,
                                          device, is_norm_scale))
    return model


def one_tower_logits(w, sizes: Dict, batch: Dict[str, torch.Tensor],
                     rows: slice, total: int, precision: str = "fp32"
                     ) -> torch.Tensor:
    """The cross-encoder's evaluation logits of the block ``rows`` of a
    batch of ``total`` rows."""
    return ref.one_tower_logits(w, sizes, batch,
                                ref.Drops(rows=rows, total=total), precision)


def forward_flop(sizes: Dict, kind: str, rows: int, S: int) -> int:
    """A forward of ``kind`` over ``rows`` sequences of ``S`` tokens: the
    cross-encoders' logits, the two-tower encoder's item states."""
    if kind == "two_tower":
        return flops.encoder_forward(sizes, rows, S)
    return flops.one_tower_forward(sizes, rows, S, kind == "image_one_tower")


def train_flop(sizes: Dict, kind: str, rows: int, S: int) -> int:
    return flops.train_step(sizes, rows, S, kind == "image_one_tower")


def attention_record(sizes: Dict, mask: np.ndarray, rate: float,
                     backward: bool, device) -> Dict[str, Optional[float]]:
    """What ``metrics/attn_roofline.py`` reads: the attention entry's
    device seconds a call (``port.attention_seconds``) and its least time
    (``flops.attention_bound_s``) at a batch of ``mask``'s rows and length
    with a configuration's heads."""
    B, S = mask.shape
    N = sizes["num_attention_heads"]
    H = sizes["hidden_size"] // N
    return {"attn_s": port.attention_seconds(B, N, S, H, mask, rate,
                                             backward, device),
            "attn_bound_s": flops.attention_bound_s(
                B, N, S, H, backward, keys=int(mask.sum()))}

