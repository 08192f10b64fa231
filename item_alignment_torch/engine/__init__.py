"""Serving engine ported so far: two-tower encode-once inference."""

from item_alignment_torch.engine.inference import (  # noqa: F401
    TwoTowerInference,
    two_tower_encode_fn,
    two_tower_head_fn,
)
