"""Weight conversion between the JAX package's Flax parameter trees and the
port's state dicts.

``state_dict_from_flax`` takes a ``{"params": ...}`` tree of nested dicts of
numpy arrays (as ``jax.tree_util.tree_map(np.asarray, variables)`` gives, or
as a msgpack checkpoint restores) and returns the ``state_dict`` of the
matching port model (``RobertaBackbone``, ``RobertaOneTower``,
``RobertaTwoTower``, ``PKGMBackbone``, ``PKGMOneTower``, ``PKGMTwoTower``
or the ``RobertaImage*`` models, whose ``img2txt`` and ``dense_img`` are
Dense kernels).  The port's module names follow the Flax tree, so the
mapping is the tree path joined with dots, plus three leaf renames:

- Dense ``kernel [in, out]`` -> ``weight [out, in]``
- LayerNorm ``scale``        -> ``weight``
- Embed ``embedding``        -> ``weight``

``flax_path`` maps a port parameter name back to its Flax path (a LayerNorm
module's name contains ``layer_norm``; an embedding table's ends in
``embeddings``, as RoBERTa's tables, or in ``_emb``, as PKGM's ``ent_emb``
and ``rel_emb``), and ``flax_from_state_dict`` is the reverse conversion.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# the module-name endings of the ported models' embedding tables
EMBED_SUFFIXES = ("embeddings", "_emb")
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias"}


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
                arr = arr.T
            out[prefix + _LEAF[name]] = torch.tensor(arr)

    walk(params, "")
    return out


def flax_path(name: str) -> Tuple[str, ...]:
    """``roberta.encoder.layer_0.attention.query.weight`` ->
    ``("roberta", "encoder", "layer_0", "attention", "query", "kernel")``."""
    *mods, leaf = name.split(".")
    if leaf == "weight":
        if "layer_norm" in mods[-1]:
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
