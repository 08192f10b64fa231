"""Data ported so far: the fixed-shape batcher, the WordPiece tokenizer,
the text layouts (``tokenization``) and offline preparation (``prepare``)."""

from item_alignment_torch.data.datasets import ArrayDataset  # noqa: F401
