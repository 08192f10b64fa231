"""Weight conversion between the JAX package's Flax parameter trees and the
port's state dicts.

``state_dict_from_flax`` takes a ``{"params": ...}`` tree of nested dicts of
numpy arrays (as ``jax.tree_util.tree_map(np.asarray, variables)`` gives, or
as a msgpack checkpoint restores) and returns the ``state_dict`` of the
matching port model (``RobertaBackbone``, ``RobertaOneTower``,
``RobertaTwoTower``, ``PKGMBackbone``, ``PKGMOneTower``, ``PKGMTwoTower``,
the ``RobertaImage*`` models, whose ``img2txt`` and ``dense_img`` are
Dense kernels, the legacy ``BertAlignModel`` and ``BertForPretraining``, and
``TextCNNTwoTower``).  The port's module names follow the Flax tree, so the
mapping is the tree path joined with dots, plus these leaf renames:

- Dense ``kernel [in, out]``   -> ``weight [out, in]``
- Conv ``kernel [K, in, out]`` -> ``nn.Conv1d`` ``weight [out, in, K]``
  (both are the reverse of all axes, so one transpose serves both)
- LayerNorm ``scale``          -> ``weight``
- Embed ``embedding``          -> ``weight``
- a parameter of the module itself (``BertForPretraining``'s ``mlm_bias``)
  keeps its name.

``flax_path`` maps a port parameter name back to its Flax path (a LayerNorm
module's name contains ``layer_norm`` or ends in ``_ln``, as the MLM head's
``transform_ln``; an embedding table's ends in ``embeddings``, as RoBERTa's
tables, or in ``_emb``, as PKGM's ``ent_emb`` and ``rel_emb``), and
``flax_from_state_dict`` is the reverse conversion.  The MLM decoder of
``BertForPretraining`` is the word-embedding table itself and has no entry
of its own in either tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# the module-name endings of the ported models' embedding tables
EMBED_SUFFIXES = ("embeddings", "_emb")
# parameters declared by a module itself (``self.param``), not a leaf of a
# submodule
OWN_PARAMS = ("mlm_bias",)
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias", **{name: name for name in OWN_PARAMS}}


def state_dict_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    params = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            if name not in _LEAF:
                raise KeyError(f"unknown Flax leaf {prefix}{name}")
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                arr = arr.T  # Dense [in, out], Conv [K, in, out]
            out[prefix + _LEAF[name]] = torch.tensor(arr)

    walk(params, "")
    return out


def flax_path(name: str) -> Tuple[str, ...]:
    """``roberta.encoder.layer_0.attention.query.weight`` ->
    ``("roberta", "encoder", "layer_0", "attention", "query", "kernel")``."""
    *mods, leaf = name.split(".")
    if leaf in OWN_PARAMS:
        return tuple(mods) + (leaf,)
    if leaf == "weight":
        if "layer_norm" in mods[-1] or mods[-1].endswith("_ln"):
            leaf = "scale"
        elif mods[-1].endswith(EMBED_SUFFIXES):
            leaf = "embedding"
        else:
            leaf = "kernel"
    elif leaf != "bias":
        raise KeyError(f"unknown parameter leaf {name}")
    return tuple(mods) + (leaf,)


def flax_from_state_dict(state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, Any]:
    """A port ``state_dict`` -> ``{"params": ...}`` nested dicts of float32
    numpy arrays in the Flax layout."""
    params: Dict[str, Any] = {}
    for name, value in state.items():
        *mods, leaf = flax_path(name)
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "kernel":
            arr = arr.T
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": params}
