"""Logger, checkpoint-file names and the bos token of the reference
(``src/utils/config.py:2-7``), and the checkpoint import helpers."""

from item_alignment_torch.utils.logging import logger  # noqa: F401

ROBERTA_WEIGHTS_NAME = "pytorch_model.bin"
KG_WEIGHTS_NAME = "pkgm_model.bin"
COCA_WEIGHTS_NAME = "coca_model.bin"
VIT_WEIGHTS_NAME = "image_encoder.bin"
BOS_TOKEN = "<S>"
