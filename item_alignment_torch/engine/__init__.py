"""Engine ported so far: training with checkpoint/resume, metrics and
two-tower encode-once inference."""

from item_alignment_torch.engine.checkpoint import CheckpointManager  # noqa: F401

from item_alignment_torch.engine.inference import (  # noqa: F401
    TwoTowerInference,
    two_tower_encode_fn,
    two_tower_head_fn,
)
from item_alignment_torch.engine.train import Trainer  # noqa: F401
