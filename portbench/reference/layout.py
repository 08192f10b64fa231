"""The parameters of each model the benchmark runs, by name and shape, in
the port's state-dict layout (its ``named_parameters()`` order), worked out
from a configuration's sizes alone.

``kind`` is ``one_tower`` (the cross-encoder), ``two_tower`` (the
shared-weight encoder with the two-tower head) or ``image_one_tower`` (the
cross-encoder whose embeddings splice two projected image features).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

KINDS = ("one_tower", "two_tower", "image_one_tower")


def param_shapes(cfg: Dict, kind: str) -> List[Tuple[str, Tuple[int, ...]]]:
    if kind not in KINDS:
        raise ValueError(f"unknown model kind {kind!r}; one of {KINDS}")
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    labels = cfg.get("num_labels", 2)
    emb = "roberta.embeddings."
    out = [(emb + "word_embeddings.weight", (cfg["vocab_size"], H))]
    if kind == "image_one_tower":
        out += [(emb + "img2txt.weight", (H, cfg["image_hidden_size"])),
                (emb + "img2txt.bias", (H,))]
    out += [(emb + "post.token_type_embeddings.weight",
             (cfg["type_vocab_size"], H)),
            (emb + "post.position_embeddings.weight",
             (cfg["max_position_embeddings"], H)),
            (emb + "post.layer_norm.weight", (H,)),
            (emb + "post.layer_norm.bias", (H,))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"roberta.encoder.layer_{i}."
        for proj in ("query", "key", "value", "output"):
            out += [(f"{p}attention.{proj}.weight", (H, H)),
                    (f"{p}attention.{proj}.bias", (H,))]
        out += [(p + "attention_layer_norm.weight", (H,)),
                (p + "attention_layer_norm.bias", (H,)),
                (p + "intermediate.weight", (I, H)),
                (p + "intermediate.bias", (I,)),
                (p + "mlp_output.weight", (H, I)),
                (p + "mlp_output.bias", (H,)),
                (p + "output_layer_norm.weight", (H,)),
                (p + "output_layer_norm.bias", (H,))]
    if kind == "two_tower":
        out += [("classifier.out_proj.weight", (labels, 2 * H)),
                ("classifier.out_proj.bias", (labels,))]
    else:
        out += [("head.classifier.dense.weight", (H, H)),
                ("head.classifier.dense.bias", (H,)),
                ("head.classifier.out_proj.weight", (labels, H)),
                ("head.classifier.out_proj.bias", (labels,))]
    return out


def is_layer_norm_scale(name: str) -> bool:
    return name.endswith("layer_norm.weight")


def decays(name: str) -> bool:
    """AdamW's weight decay: dense kernels and embedding tables, not
    biases and not LayerNorm parameters."""
    return name.endswith(".weight") and "layer_norm" not in name
