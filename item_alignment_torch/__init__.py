"""PyTorch/CUDA port of the item-alignment framework.

Runs beside the JAX package ``item_alignment_tpu`` (the reference) and never
imports it.  Plain tensor code is PyTorch; each TPU kernel of the reference
becomes a kernel written by hand for Hopper (``csrc/``).  Entry points run on
``cuda`` unless given ``device="cpu"``.
"""

from item_alignment_torch.config import ModelConfig  # noqa: F401
