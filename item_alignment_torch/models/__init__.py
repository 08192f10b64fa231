"""Model families ported so far: the RoBERTa, PKGM and TextCNN text
models, the legacy 5-field BERT, the multimodal RobertaImage
one-/two-tower and the image two-tower (ViT, ResNetV2, NFNet)."""

from item_alignment_torch.models.bert_legacy import (  # noqa: F401
    BertAlignModel,
    BertForPretraining,
)
from item_alignment_torch.models.image import (  # noqa: F401
    BACKBONES,
    ImageTwoTower,
)
from item_alignment_torch.models.multimodal import (  # noqa: F401
    RobertaImageBackbone,
    RobertaImageOneTower,
    RobertaImageTwoTower,
)
from item_alignment_torch.models.outputs import PairClassifierOutput  # noqa: F401
from item_alignment_torch.models.text import (  # noqa: F401
    PKGMBackbone,
    PKGMOneTower,
    PKGMTwoTower,
    RobertaBackbone,
    RobertaOneTower,
    RobertaTwoTower,
    TextCNN,
    TextCNNTwoTower,
)

# model-name substrings of the families still to port, in the JAX package's
# dispatch order (item_alignment_tpu/models/__init__.py:build_model), which
# takes the image towers between the two
NOT_PORTED = (
    ("coca", "ROADMAP Queue 1 #11: CoCa"),
    ("gcn", "ROADMAP Queue 1 #10: The graph path"),
)


def is_image_two_tower(name: str) -> bool:
    """Whether ``build_model`` gives ``name`` an ``ImageTwoTower``: an
    image-backbone name that no family before it in the dispatch takes."""
    return any(key in name for key in BACKBONES) and not any(
        key in name for key in ("pkgm", "textcnn", "roberta_image", "coca"))


def build_model(config, device=None, seed=0):
    """The model of ``config.model_name`` (a name substring, as the JAX
    package's ``build_model`` dispatches); the families not yet ported
    raise with their ROADMAP item."""
    name = config.model_name
    one_tower = config.interaction_type == "one_tower"
    if "pkgm" in name:
        cls = PKGMOneTower if one_tower else PKGMTwoTower
        return cls(config, device=device, seed=seed)
    if "textcnn" in name:
        return TextCNNTwoTower(config, device=device, seed=seed)
    if "roberta_image" in name:
        cls = RobertaImageOneTower if one_tower else RobertaImageTwoTower
        return cls(config, device=device, seed=seed)
    if is_image_two_tower(name):
        return ImageTwoTower(config, device=device, seed=seed)
    for key, item in NOT_PORTED:
        if key in name:
            raise NotImplementedError(
                f"model {name!r} is not ported yet ({item})")
    if "roberta" in name or "bert" in name:
        cls = RobertaOneTower if one_tower else RobertaTwoTower
        return cls(config, device=device, seed=seed)
    raise ValueError(f"unknown model name: {name}")
