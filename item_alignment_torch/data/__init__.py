"""Data loading ported so far: the fixed-shape batcher."""

from item_alignment_torch.data.datasets import ArrayDataset  # noqa: F401
