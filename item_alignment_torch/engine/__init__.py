"""Engine ported so far: training with checkpoint/resume, metrics,
two-tower encode-once inference and observability.

The exports below load on first use: the models and ops import
``engine.observability`` (spans), and ``engine.train`` imports them, so
importing this package must not import ``train`` back."""

import importlib

_EXPORTS = {"CheckpointManager": "checkpoint",
            "TwoTowerInference": "inference",
            "two_tower_encode_fn": "inference",
            "two_tower_head_fn": "inference",
            "Trainer": "train"}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
