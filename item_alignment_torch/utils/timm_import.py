"""timm checkpoint import for the image towers.

Port of ``item_alignment_tpu/utils/timm_import.py``.  The reference
finetunes ``timm.create_model(name, pretrained=True)`` backbones and dumps
``image_embedding.json`` through a pretrained NFNet; here the caller
supplies the torch-saved timm 0.6.5 state dict (``scripts/train.sh``'s
``TIMM_NFNET``; nothing is downloaded), read with
``utils/hf_import.py:load_torch_state_dict``.  The converters map its keys
onto the port's names (``models/image.py``, which keeps the Flax tree's
module names):

- ``convert_timm_vit``      <- ``vit_*_patch16_*``: the fused
  ``blocks.i.attn.qkv`` ``[3D, D]`` split into ``attn.query``/``key``/
  ``value``; ``attn.proj`` -> ``attn.out``; ``mlp.fc1``/``fc2`` ->
  ``mlp_fc1``/``mlp_fc2``; ``patch_embed.proj`` -> ``patch_embed``;
- ``convert_timm_nfnet``    <- ``eca_nfnet_l0``: ``stem.conv{1-4}`` ->
  ``stem{0-3}``, ``stages.{s}.{b}.*`` -> ``stage{s}_block{b}.*``,
  ``downsample.conv`` -> ``downsample``; each ScaledStdConv's gain
  ``[O, 1, 1, 1]`` -> ``[O]``; the ECA conv stays ``[1, 1, k]``; the
  1000-class ``head.fc`` is dropped;
- ``convert_timm_resnetv2`` <- ``resnetv2_50``: ``stem.conv`` ->
  ``stem_conv``, ``stages.{i}.blocks.{j}.*`` -> ``stage{i}_block{j}.*``;
  each BatchNormAct2d's running statistics folded into ``AffineAct``'s
  ``scale = w / sqrt(var + eps)``, ``bias = b - mean * scale`` (eps 1e-5).

The port's convolutions keep torch's OIHW layout and its denses torch's
``[out, in]``, so apart from the splits and folds the values are copied as
they are.  ``load_timm_backbone`` overlays a conversion onto a model's
state dict; a key the model lacks, a shape that differs or a timm key left
over raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from item_alignment_torch.utils.hf_import import _overlay

Converted = Dict[str, np.ndarray]
BACKBONE_MODULES = ("NFNet", "ResNetV2", "ViT")


def convert_timm_vit(sd: Mapping[str, np.ndarray]) -> Converted:
    """timm ViT state dict -> ``ViT`` names.  The port's projections keep
    torch's ``[D, D]``, so no head count is needed (JAX's DenseGeneral
    kernels have head axes, and its converter takes one)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    D = sd["cls_token"].shape[-1]
    out: Converted = {
        "cls_token": sd["cls_token"].reshape(1, 1, D),
        "pos_embed": sd["pos_embed"],
        "patch_embed.weight": sd["patch_embed.proj.weight"],
        "patch_embed.bias": sd["patch_embed.proj.bias"],
        "norm.weight": sd["norm.weight"],
        "norm.bias": sd["norm.bias"],
    }
    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        p, q = f"blocks.{i}.", f"block_{i}."
        weights = np.split(sd[p + "attn.qkv.weight"], 3, axis=0)
        biases = np.split(sd[p + "attn.qkv.bias"], 3, axis=0)
        for part, w, b in zip(("query", "key", "value"), weights, biases):
            out[f"{q}attn.{part}.weight"] = w
            out[f"{q}attn.{part}.bias"] = b
        for theirs, ours in (("norm1", "norm1"), ("norm2", "norm2"),
                             ("attn.proj", "attn.out"),
                             ("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
            for leaf in ("weight", "bias"):
                out[f"{q}{ours}.{leaf}"] = sd[f"{p}{theirs}.{leaf}"]
        i += 1
    return out


def convert_timm_nfnet(sd: Mapping[str, np.ndarray]) -> Converted:
    """timm 0.6.5 ``eca_nfnet_l0`` state dict -> ``NFNet`` names; every
    key but ``head.*`` must be used."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    out: Converted = {}
    consumed = set()

    def stdconv(theirs: str, ours: str) -> None:
        for leaf in ("weight", "bias", "gain"):
            consumed.add(f"{theirs}.{leaf}")
            value = sd[f"{theirs}.{leaf}"]
            out[f"{ours}.{leaf}"] = value.reshape(-1) if leaf == "gain" \
                else value

    for i in range(4):
        stdconv(f"stem.conv{i + 1}", f"stem{i}")
    stdconv("final_conv", "final_conv")
    s = 0
    while f"stages.{s}.0.conv1.weight" in sd:
        b = 0
        while f"stages.{s}.{b}.conv1.weight" in sd:
            p, q = f"stages.{s}.{b}", f"stage{s}_block{b}"
            for name in ("conv1", "conv2", "conv2b", "conv3"):
                stdconv(f"{p}.{name}", f"{q}.{name}")
            if f"{p}.downsample.conv.weight" in sd:
                stdconv(f"{p}.downsample.conv", f"{q}.downsample")
            consumed.add(f"{p}.attn_last.conv.weight")
            out[f"{q}.attn_last.conv"] = sd[f"{p}.attn_last.conv.weight"]
            b += 1
        s += 1
    _check_consumed(sd, consumed, "nfnet")
    return out


def _fold_bn(sd: Mapping[str, np.ndarray], prefix: str, eps: float = 1e-5
             ) -> tuple:
    """BatchNormAct2d running statistics -> AffineAct (scale, bias):
    ``(x - mean) / sqrt(var + eps) * w + b = x * scale + bias``."""
    w, b = sd[prefix + ".weight"], sd[prefix + ".bias"]
    scale = w / np.sqrt(sd[prefix + ".running_var"] + eps)
    return (scale.astype(np.float32),
            (b - sd[prefix + ".running_mean"] * scale).astype(np.float32))


def convert_timm_resnetv2(sd: Mapping[str, np.ndarray], eps: float = 1e-5
                          ) -> Converted:
    """timm 0.6.5 ``resnetv2_50`` state dict -> ``ResNetV2`` names, the
    BatchNorms folded; every key but ``head.*`` and
    ``num_batches_tracked`` must be used."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    out: Converted = {}
    consumed = set()

    def conv(theirs: str, ours: str) -> None:
        consumed.add(theirs + ".weight")
        out[ours + ".weight"] = sd[theirs + ".weight"]

    def bn(theirs: str, ours: str) -> None:
        consumed.update(f"{theirs}.{leaf}" for leaf in (
            "weight", "bias", "running_mean", "running_var"))
        out[ours + ".scale"], out[ours + ".bias"] = _fold_bn(sd, theirs, eps)

    conv("stem.conv", "stem_conv")
    bn("norm", "norm")
    i = 0
    while f"stages.{i}.blocks.0.conv1.weight" in sd:
        j = 0
        while f"stages.{i}.blocks.{j}.conv1.weight" in sd:
            p, q = f"stages.{i}.blocks.{j}", f"stage{i}_block{j}"
            for n in (1, 2, 3):
                bn(f"{p}.norm{n}", f"{q}.norm{n}")
                conv(f"{p}.conv{n}", f"{q}.conv{n}")
            if f"{p}.downsample.conv.weight" in sd:
                conv(f"{p}.downsample.conv", f"{q}.downsample")
            j += 1
        i += 1
    _check_consumed(sd, consumed, "resnetv2")
    return out


def _check_consumed(sd, consumed, family: str) -> None:
    leftover = sorted(k for k in sd if k not in consumed
                      and not k.startswith("head.")
                      and not k.endswith("num_batches_tracked"))
    if leftover:
        raise ValueError(f"unconsumed timm {family} keys: {leftover[:8]}")


def convert_for_model_name(model_name: str, sd: Mapping[str, np.ndarray]
                           ) -> Converted:
    """Dispatch on the reference's ``--model_name`` strings (nfnet / vit /
    resnet substring)."""
    if "nfnet" in model_name:
        return convert_timm_nfnet(sd)
    if "vit" in model_name:
        return convert_timm_vit(sd)
    if "resnet" in model_name:
        return convert_timm_resnetv2(sd)
    raise ValueError(f"no timm converter for model name: {model_name}")


def load_timm_backbone(state: Mapping[str, torch.Tensor],
                       sd: Mapping[str, np.ndarray], model_name: str
                       ) -> Dict[str, torch.Tensor]:
    """``state`` (a model's ``state_dict``) with the converted timm weights
    over its backbone: the submodule ``NFNet_0``, ``ResNetV2_0`` or
    ``ViT_0`` of an ``ImageTwoTower``, or the whole of a bare tower.  Each
    converted key must exist with the same shape."""
    converted = convert_for_model_name(model_name, sd)
    out = dict(state)
    prefixes = sorted({k.split(".")[0] for k in out
                       if k.split(".")[0].split("_")[0] in BACKBONE_MODULES})
    if len(prefixes) > 1:
        raise ValueError(f"ambiguous backbones: {prefixes}")
    prefix = prefixes[0] + "." if prefixes else ""
    missing = sorted(prefix + k for k in converted if prefix + k not in out)
    if missing:
        raise KeyError(f"the model has no {missing[:8]}")
    _overlay(out, {prefix + k: v for k, v in converted.items()})
    return out
