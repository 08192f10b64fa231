"""Checkpointing on ``torch.save``.

Port of ``item_alignment_tpu/engine/checkpoint.py``, which writes through
orbax and flax msgpack; both import jax, so the port saves with ``torch.save``
instead: every tensor is moved to the CPU first and keeps its dtype (bf16
optimizer moments stay bf16).  It reads the JAX package's single-file
parameter dumps too: ``load_params`` of a ``.msgpack`` file decodes it
(``utils/flax_msgpack.py``) and converts the Flax tree into the port's
state dict (``convert.state_dict_from_flax``).  The port writes ``.pt``
only, and the train-state checkpoints of the two packages are not
interchangeable.

- ``CheckpointManager(directory, keep)``: one file per step
  (``step_<n>.pt``), the newest ``keep`` kept.  A file is written under a
  temporary name and renamed, so a run killed while saving leaves no
  half-written checkpoint to resume from.
- ``save_params`` / ``load_params``: one file of a ``state_dict`` (read
  from a ``.pt`` or a Flax ``.msgpack``).
- ``merge_param_sources``: the multi-source restore of the PKGM finetune.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, List, Optional

import torch

logger = logging.getLogger("item_alignment_torch")


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _atomic_save(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(_to_cpu(obj), tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Save and restore a train-state tree (nested dicts of tensors and
    Python scalars) by step."""

    _NAME = re.compile(r"step_(\d+)\.pt$")

    def __init__(self, directory: str, keep: int = 20):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def save(self, step: int, tree: Any) -> None:
        _atomic_save(tree, self._path(step))
        for old in self.all_steps()[:-self.keep] if self.keep else []:
            os.unlink(self._path(old))

    def restore(self, step: Optional[int] = None) -> Any:
        """The tree saved at ``step`` (the latest when None), on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := self._NAME.match(name)))


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """One file of a ``state_dict`` (epoch-series checkpoints for soup, the
    best-F1 parameters)."""
    _atomic_save(params, path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The state dict in ``path``: a ``.pt`` of ``save_params``, or a Flax
    ``.msgpack`` of the JAX package's ``save_params`` (fp32 tensors named
    as the port's modules are)."""
    if path.endswith(".msgpack"):
        from item_alignment_torch.convert import state_dict_from_flax
        from item_alignment_torch.utils.flax_msgpack import read_flax_msgpack

        return state_dict_from_flax(read_flax_msgpack(path))
    return torch.load(path, map_location="cpu", weights_only=True)


def _copy_dicts(node):
    if isinstance(node, dict):
        return {k: _copy_dicts(v) for k, v in node.items()}
    return node


def merge_param_sources(base: Any, *overlays: Dict[Any, Any]) -> Any:
    """Multi-source restore: start from ``base`` and overwrite subtrees.

    Mirrors the PKGM dual-checkpoint merge (text encoder weights +
    ``ent_emb``/``rel_emb``/``proj_mat`` arrays from the KGE pretrain): each
    overlay is {path tuple or '/'-joined string: subtree}.  The dict
    structure is copied (not the arrays), so the caller's base tree is never
    mutated."""
    tree = _copy_dicts(base)

    def set_path(d, path, value):
        keys = path.split("/") if isinstance(path, str) else list(path)
        node = d
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    for overlay in overlays:
        for path, value in overlay.items():
            set_path(tree, path, value)
            logger.info(f"[merge_param_sources] injected {path}")
    return tree
