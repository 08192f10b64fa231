"""Weight conversion from the JAX package's Flax parameter trees.

``state_dict_from_flax`` takes a ``{"params": ...}`` tree of nested dicts of
numpy arrays (as ``jax.tree_util.tree_map(np.asarray, variables)`` gives, or
as a msgpack checkpoint restores) and returns the ``state_dict`` of the
matching port model (``RobertaBackbone``, ``RobertaOneTower`` or
``RobertaTwoTower``).  The port's module names follow the Flax tree, so the
mapping is the tree path joined with dots, plus three leaf renames:

- Dense ``kernel [in, out]`` -> ``weight [out, in]``
- LayerNorm ``scale``        -> ``weight``
- Embed ``embedding``        -> ``weight``
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

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
