"""Weight conversion between the JAX package's Flax parameter trees and the
port's state dicts.

``state_dict_from_flax`` takes a ``{"params": ...}`` tree of nested dicts of
numpy arrays (as ``jax.tree_util.tree_map(np.asarray, variables)`` gives, or
as a msgpack checkpoint restores) and returns the ``state_dict`` of the
matching port model (``RobertaBackbone``, ``RobertaOneTower``,
``RobertaTwoTower``, ``PKGMBackbone``, ``PKGMOneTower``, ``PKGMTwoTower``,
the ``RobertaImage*`` models, whose ``img2txt`` and ``dense_img`` are
Dense kernels, the legacy ``BertAlignModel`` and ``BertForPretraining``,
``TextCNNTwoTower``, the image towers and ``ImageTwoTower``).  The port's
module names follow the Flax tree, so the mapping is the tree path joined
with dots, plus these leaf renames:

- Dense ``kernel [in, out]``   -> ``weight [out, in]``
- Conv ``kernel [K, in, out]`` -> ``nn.Conv1d`` ``weight [out, in, K]``
  (both are the reverse of all axes, so one transpose serves both)
- Conv ``kernel [kh, kw, in, out]`` (HWIO) -> ``weight [out, in, kh, kw]``
  (OIHW)
- flax ``MultiHeadDotProductAttention`` (a module ``attn``, ViT's):
  ``query``/``key``/``value`` ``kernel [D, N, Hd]`` -> ``weight [N*Hd, D]``
  and ``bias [N, Hd]`` -> ``bias [N*Hd]``; ``out`` ``kernel [N, Hd, D]`` ->
  ``weight [D, N*Hd]``
- LayerNorm ``scale``          -> ``weight``
- Embed ``embedding``          -> ``weight``
- a parameter of the module itself keeps its name: ``BertForPretraining``'s
  ``mlm_bias``, StdConv's ``gain``, ViT's ``cls_token`` and ``pos_embed``,
  AffineAct's ``scale`` (told from a LayerNorm's by its parent, a ResNetV2
  or one of its blocks, which holds ``stem_conv`` or ``conv1``) and ECA's
  ``conv`` (``[k, 1, 1]`` -> the Conv1d weight ``[1, 1, k]``, the reverse
  of its axes).

``flax_path`` maps a port parameter name back to its Flax path (a LayerNorm
module's name contains ``layer_norm`` or ends in ``_ln``, as the MLM head's
``transform_ln``, or is ViT's ``norm1``, ``norm2`` or ``norm``; an embedding
table's ends in ``embeddings``, as RoBERTa's tables, or in ``_emb``, as
PKGM's ``ent_emb`` and ``rel_emb``), and ``flax_from_state_dict`` is the
reverse conversion (it needs the head count of a ViT's attention to give
its kernels their head axes back).  The MLM decoder of
``BertForPretraining`` is the word-embedding table itself and has no entry
of its own in either tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

# the module-name endings of the ported models' embedding tables
EMBED_SUFFIXES = ("embeddings", "_emb")
# ViT's LayerNorms (ResNetV2's AffineActs share the names but hold
# ``scale``, not ``weight``)
VIT_NORMS = ("norm1", "norm2", "norm")
# parameters declared by a module itself (``self.param``), not a leaf of a
# submodule
OWN_PARAMS = ("mlm_bias", "gain", "conv", "cls_token", "pos_embed", "scale")
# the children that mark a module as a ResNetV2 or one of its blocks, whose
# norms are AffineActs
AFFINE_PARENTS = ("stem_conv", "conv1")
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias", **{n: n for n in OWN_PARAMS if n != "scale"}}


def _attention_part(mods: Sequence[str]) -> Optional[str]:
    """"query", "key", "value" or "out" for the projections of a flax
    ``MultiHeadDotProductAttention`` named ``attn``, else None."""
    if len(mods) >= 2 and mods[-2] == "attn" and \
            mods[-1] in ("query", "key", "value", "out"):
        return mods[-1]
    return None


def state_dict_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    params = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], mods: Tuple[str, ...],
             parent: Mapping[str, Any]) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, mods + (name,), node)
                continue
            if name not in _LEAF:
                raise KeyError(f"unknown Flax leaf {'/'.join(mods + (name,))}")
            arr = np.asarray(value, dtype=np.float32)
            leaf = _LEAF[name]
            part = _attention_part(mods)
            if name == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif name == "kernel" and part == "out":
                arr = arr.reshape(-1, arr.shape[-1]).T
            elif name == "kernel" and part:
                arr = arr.reshape(arr.shape[0], -1).T
            elif name in ("kernel", "conv"):
                arr = arr.T  # Dense [in, out], Conv1d [K, in, out], ECA
            elif name == "bias" and part:
                arr = arr.reshape(-1)
            elif name == "scale" and any(k in parent for k in AFFINE_PARENTS):
                leaf = "scale"  # AffineAct's own parameter
            out[".".join(mods + (leaf,))] = torch.tensor(arr)

    walk(params, (), {})
    return out


def flax_path(name: str) -> Tuple[str, ...]:
    """``roberta.encoder.layer_0.attention.query.weight`` ->
    ``("roberta", "encoder", "layer_0", "attention", "query", "kernel")``."""
    *mods, leaf = name.split(".")
    if leaf in OWN_PARAMS:
        return tuple(mods) + (leaf,)
    if leaf == "weight":
        if ("layer_norm" in mods[-1] or mods[-1].endswith("_ln")
                or mods[-1] in VIT_NORMS):
            leaf = "scale"
        elif mods[-1].endswith(EMBED_SUFFIXES):
            leaf = "embedding"
        else:
            leaf = "kernel"
    elif leaf != "bias":
        raise KeyError(f"unknown parameter leaf {name}")
    return tuple(mods) + (leaf,)


def flax_from_state_dict(state: Mapping[str, torch.Tensor],
                         num_heads: Optional[int] = None) -> Dict[str, Any]:
    """A port ``state_dict`` -> ``{"params": ...}`` nested dicts of float32
    numpy arrays in the Flax layout.  ``num_heads`` is the head count of a
    ViT's attention, whose Flax kernels have head axes."""
    params: Dict[str, Any] = {}
    for name, value in state.items():
        *mods, leaf = flax_path(name)
        arr = value.detach().to("cpu", torch.float32).numpy()
        part = _attention_part(mods)
        if part and num_heads is None:
            raise ValueError(f"{name}: flax_from_state_dict needs the "
                             "attention's num_heads")
        if leaf == "kernel" and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif leaf == "kernel" and part == "out":
            arr = arr.T.reshape(num_heads, -1, arr.shape[0])
        elif leaf == "kernel" and part:
            arr = arr.T.reshape(arr.shape[1], num_heads, -1)
        elif leaf in ("kernel", "conv"):
            arr = arr.T
        elif leaf == "bias" and part and part != "out":
            arr = arr.reshape(num_heads, -1)
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": params}
