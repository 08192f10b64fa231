"""Model families ported so far: the RoBERTa and PKGM text models."""

from item_alignment_torch.models.outputs import PairClassifierOutput  # noqa: F401
from item_alignment_torch.models.text import (  # noqa: F401
    PKGMBackbone,
    PKGMOneTower,
    PKGMTwoTower,
    RobertaBackbone,
    RobertaOneTower,
    RobertaTwoTower,
)

# model-name substrings of the families still to port, in the JAX package's
# dispatch order (item_alignment_tpu/models/__init__.py:build_model)
NOT_PORTED = (
    ("textcnn", "ROADMAP Queue 1 #8: TextCNN"),
    ("roberta_image", "ROADMAP Queue 1 #6: The multimodal RobertaImage "
                      "one/two-tower"),
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
    for key, item in NOT_PORTED:
        if key in name:
            raise NotImplementedError(
                f"model {name!r} is not ported yet ({item})")
    if "roberta" in name or "bert" in name:
        cls = RobertaOneTower if one_tower else RobertaTwoTower
        return cls(config, device=device, seed=seed)
    raise ValueError(f"unknown model name: {name}")
