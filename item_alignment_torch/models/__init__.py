"""Model families ported so far: the RoBERTa, PKGM and TextCNN text
models, the legacy 5-field BERT and the multimodal RobertaImage
one-/two-tower."""

from item_alignment_torch.models.bert_legacy import (  # noqa: F401
    BertAlignModel,
    BertForPretraining,
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
# dispatch order (item_alignment_tpu/models/__init__.py:build_model)
NOT_PORTED = (
    ("coca", "ROADMAP Queue 1 #11: CoCa"),
    ("vit", "ROADMAP Queue 1 #9: The image towers"),
    ("resnet", "ROADMAP Queue 1 #9: The image towers"),
    ("nfnet", "ROADMAP Queue 1 #9: The image towers"),
    ("gcn", "ROADMAP Queue 1 #10: The graph path"),
)


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
    for key, item in NOT_PORTED:
        if key in name:
            raise NotImplementedError(
                f"model {name!r} is not ported yet ({item})")
    if "roberta" in name or "bert" in name:
        cls = RobertaOneTower if one_tower else RobertaTwoTower
        return cls(config, device=device, seed=seed)
    raise ValueError(f"unknown model name: {name}")
