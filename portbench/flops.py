"""The yardstick's arithmetic: the model FLOP of a forward, a train step
and a two-tower score by the hand count, the attention entry's least
FLOP and bytes, and the H100's published peaks.

The model count is the products' ``2·M·N·K`` and nothing for elementwise
work, the convention of the port's ``utils/flops.py``: an encoder forward
over ``rows`` sequences of ``S`` tokens is ``L·2·rows·S·(4H² + 2H·I)`` for
the dense projections plus ``L·4·rows·S²·H`` for attention's two products
(every position, padding included); a train step is three times its
forward (the backward's two transposed products of each).  The heads and
the image projection add their own products.  Embedding lookups count 0.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM, dense: bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def encoder_forward(cfg: Dict, rows: int, S: int) -> int:
    L, H, I = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["intermediate_size"])
    return L * 2 * rows * S * (4 * H * H + 2 * H * I) + L * 4 * rows * S * S * H


def one_tower_head(cfg: Dict, rows: int) -> int:
    H = cfg["hidden_size"]
    return 2 * rows * H * H + 2 * rows * H * cfg.get("num_labels", 2)


def image_splice(cfg: Dict, rows: int) -> int:
    """The src and tgt image features through ``img2txt``."""
    return 2 * 2 * rows * cfg["image_hidden_size"] * cfg["hidden_size"]


def one_tower_forward(cfg: Dict, rows: int, S: int, images: bool) -> int:
    return (encoder_forward(cfg, rows, S) + one_tower_head(cfg, rows)
            + (image_splice(cfg, rows) if images else 0))


def train_step(cfg: Dict, rows: int, S: int, images: bool) -> int:
    """Three times the forward; the image projection twice (its input,
    the image features, takes no gradient)."""
    return (3 * one_tower_forward(cfg, rows, S, False)
            + (2 * image_splice(cfg, rows) if images else 0))


def two_tower_scores(cfg: Dict, pairs: int) -> int:
    return 2 * pairs * 2 * cfg["hidden_size"] * cfg.get("num_labels", 2)


def attention_bound_s(B: int, N: int, S: int, H: int, backward: bool,
                      keys: int = None) -> float:
    """The least time of one attention call (forward, or forward and
    backward) on the card: the larger of its FLOP over the bf16 peak and
    its bytes over HBM's (q, k, v, the fp32 key bias and out; in the
    backward do, dq, dk and dv; each read or written once).  The FLOP are
    what the inputs need: every query against the keys its row's mask
    keeps, ``keys`` of them over the batch (all ``B·S`` by default), so
    4·N·S·keys·H forward and 8· more backward."""
    keys = B * S if keys is None else keys
    flop = (4 + (8 if backward else 0)) * N * S * keys * H
    tensors = 4 + (4 if backward else 0)
    nbytes = tensors * B * S * N * H * 2 + 4 * B * S  # bf16; fp32 bias
    return max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
