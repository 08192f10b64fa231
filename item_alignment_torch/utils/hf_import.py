"""HuggingFace/torch checkpoint import.

Port of ``item_alignment_tpu/utils/hf_import.py``.  Converts a torch
``state_dict`` with HF BERT/Chinese-RoBERTa names (the ``pytorch_model.bin``
the reference finetunes from) into the names of the port's
``RobertaBackbone``, with the reference's loading quirks:

- ``type_vocab_size > 2``: the pretrained 2 token-type rows go into the first
  rows of the larger table (finetune_text.py:243-248);
- ``max_position_embeddings > 512``: the pretrained 512 position rows go into
  the first rows of the larger table (finetune_text.py:250-255), which is how
  a model that takes a pair longer than 512 tokens is made.

The new rows are drawn as the JAX package draws them (``np.random.
RandomState(0)``, normal with ``initializer_range``, the token-type table
first), so both packages give equal tables.  HF to the port is a rename: the
port's ``Dense.weight`` is ``[out, in]`` as torch stores it.  Converted
weights are flat dicts of float numpy arrays whose names are relative to the
backbone (``embeddings...``, ``encoder.layer_0...``).
``convert_pkgm_state_dicts`` merges such a checkpoint with the PKGM
pretrain arrays (``pkgm_model.bin``) into ``PKGMBackbone`` names.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, MutableMapping, Optional

import numpy as np
import torch

_EMBEDDINGS = {
    "embeddings.word_embeddings.weight": "embeddings.word_embeddings.weight",
    "embeddings.LayerNorm.weight": "embeddings.post.layer_norm.weight",
    "embeddings.LayerNorm.bias": "embeddings.post.layer_norm.bias",
}
_TOKEN_TYPE = "embeddings.token_type_embeddings.weight"
_POSITION = "embeddings.position_embeddings.weight"
# HF module under encoder.layer.<i>. -> the port's under encoder.layer_<i>.
_LAYER = {
    "attention.self.query": "attention.query",
    "attention.self.key": "attention.key",
    "attention.self.value": "attention.value",
    "attention.output.dense": "attention.output",
    "attention.output.LayerNorm": "attention_layer_norm",
    "intermediate.dense": "intermediate",
    "output.dense": "mlp_output",
    "output.LayerNorm": "output_layer_norm",
}


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def _strip_prefix(name: str) -> str:
    for p in ("bert.", "roberta."):
        if name.startswith(p):
            return name[len(p):]
    return name


def convert_encoder_state_dict(
    sd: Mapping[str, np.ndarray],
    type_vocab_size: Optional[int] = None,
    max_position_embeddings: Optional[int] = None,
    rng: Optional[np.random.RandomState] = None,
    initializer_range: float = 0.02,
) -> Dict[str, np.ndarray]:
    """HF encoder weights -> ``RobertaBackbone`` names.  Embedding tables
    grow by the row-copy quirks when the target sizes exceed the
    checkpoint's."""
    rng = rng or np.random.RandomState(0)
    sd = {_strip_prefix(k): np.asarray(v) for k, v in sd.items()}

    def grow(table: np.ndarray, target_rows: Optional[int]) -> np.ndarray:
        if target_rows is None or target_rows <= table.shape[0]:
            return table
        out = rng.normal(0.0, initializer_range,
                         (target_rows, table.shape[1])).astype(table.dtype)
        out[: table.shape[0]] = table
        return out

    out = {ours: sd[theirs] for theirs, ours in _EMBEDDINGS.items()}
    # the token-type table draws first, as in the JAX package
    out["embeddings.post.token_type_embeddings.weight"] = grow(
        sd[_TOKEN_TYPE], type_vocab_size)
    out["embeddings.post.position_embeddings.weight"] = grow(
        sd[_POSITION], max_position_embeddings)
    layer_ids = sorted({int(m.group(1)) for k in sd
                        if (m := re.match(r"encoder\.layer\.(\d+)\.", k))})
    for i in layer_ids:
        for theirs, ours in _LAYER.items():
            for leaf in ("weight", "bias"):
                out[f"encoder.layer_{i}.{ours}.{leaf}"] = sd[
                    f"encoder.layer.{i}.{theirs}.{leaf}"]
    return out


def convert_pkgm_state_dicts(
    roberta_sd: Mapping[str, np.ndarray],
    kg_sd: Mapping[str, np.ndarray],
    type_vocab_size: Optional[int] = None,
    max_position_embeddings: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """The text-encoder checkpoint merged with the PKGM pretrain arrays
    (``ent_emb.weight``, ``rel_emb.weight``, ``proj_mat.weight`` and
    optionally ``proj_mat.bias``) -> ``PKGMBackbone`` names.  Mh is
    ``h @ proj_mat.T`` in the pretrain model, so ``proj_mat.weight`` is the
    port's Dense weight as it is (the JAX package stores its transpose as
    the Flax kernel)."""
    out = convert_encoder_state_dict(roberta_sd, type_vocab_size,
                                     max_position_embeddings)
    kg = {_strip_prefix(k): np.asarray(v) for k, v in kg_sd.items()}

    def find(*names):
        for n in names:
            if n in kg:
                return kg[n]
        raise KeyError(f"none of {names} in kg checkpoint: {list(kg)[:8]}")

    for table in ("ent_emb", "rel_emb", "proj_mat"):
        out[f"embeddings.{table}.weight"] = find(f"{table}.weight", table)
    if "proj_mat.bias" in kg:
        out["embeddings.proj_mat.bias"] = kg["proj_mat.bias"]
    return out


def import_hf_roberta(state: Mapping[str, torch.Tensor],
                      sd: Mapping[str, np.ndarray], config,
                      kg_sd: Optional[Mapping[str, np.ndarray]] = None
                      ) -> Dict[str, torch.Tensor]:
    """Overlay HF encoder weights onto the ``state_dict`` of an initialised
    ``RobertaOneTower``/``RobertaTwoTower`` (backbone under ``roberta.``);
    with ``kg_sd`` (a ``pkgm_model.bin``), the PKGM tables too, onto a
    ``PKGMOneTower``/``PKGMTwoTower``.  Returns a new dict to
    ``load_state_dict``."""
    if kg_sd is None:
        converted = convert_encoder_state_dict(
            sd, config.type_vocab_size, config.max_position_embeddings)
    else:
        converted = convert_pkgm_state_dicts(
            sd, kg_sd, config.type_vocab_size,
            config.max_position_embeddings)
    out = dict(state)
    _overlay(out, {f"roberta.{k}": v for k, v in converted.items()})
    return out


def _as_tensor(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value, dtype=np.float32)).to(
        device=like.device, dtype=like.dtype)


def _overlay(dst: MutableMapping[str, torch.Tensor],
             src: Mapping[str, np.ndarray]) -> None:
    """Replace ``dst``'s entries by ``src``'s; shapes must agree."""
    for k, v in src.items():
        if tuple(dst[k].shape) != tuple(np.shape(v)):
            raise ValueError(f"shape mismatch for {k}: {tuple(dst[k].shape)} "
                             f"vs {tuple(np.shape(v))}")
        dst[k] = _as_tensor(v, dst[k])


def _overlay_rows(dst: MutableMapping[str, torch.Tensor],
                  src: Mapping[str, np.ndarray]) -> None:
    """Like ``_overlay`` but tolerates embedding tables whose row count
    differs: the overlapping leading rows are copied and the rest of the
    destination's rows are kept (the row-copy quirk in both directions, e.g.
    a 5-type pretrain table into a 4-type model)."""
    for k, v in src.items():
        d = dst[k]
        if tuple(d.shape) == tuple(np.shape(v)):
            dst[k] = _as_tensor(v, d)
            continue
        if d.dim() != 2 or np.ndim(v) != 2 or d.shape[1] != np.shape(v)[1]:
            raise ValueError(f"incompatible shapes for {k}: {tuple(d.shape)} "
                             f"vs {tuple(np.shape(v))}")
        rows = min(d.shape[0], np.shape(v)[0])
        out = d.clone()
        out[:rows] = _as_tensor(v, d)[:rows]
        dst[k] = out
