"""The benchmark's tests: ``python -m pytest portbench/tests -q`` from the
root of the checkout.  They run the program and the reference at a tiny
size on the CPU; those marked ``chip`` need an NVIDIA card and skip
without one (decided in the ``card`` fixture, never at import)."""

import sys
from pathlib import Path

import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

torch.set_num_threads(1)

TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, image_hidden_size=12)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def tiny_cell(name: str, dtype: str = "float32"):
    """Cell ``name`` of the manifest at a CPU test's size: ``TINY``'s
    model (passed to the job as overrides), a few short rows, the
    configuration's dtype replaced by ``dtype`` and AdamW's moments kept
    in fp32 (at this size a leaf holds a few dozen elements, and the
    round-off of bf16 moments moves one leaf's change by several
    percent)."""
    from portbench import cell as cells

    c = cells.load(name)
    c.config = dict(c.config, dtype=dtype)
    mix = dict(c.traffic)
    if mix["kind"] == "pairs":
        mix.update(rows=4, seq_len=16, min_len=4, pool=4)
        if "image_hidden_size" in mix:
            mix["image_hidden_size"] = TINY["image_hidden_size"]
    else:
        mix.update(items=16, seq_len=8, min_len=2, candidates=3, pool=2)
    c.traffic = mix
    work = dict(c.workload)
    if work["job"] == "mine":
        work.update(encode_rows=4, score_rows=8)
    work["check"] = dict(work["check"], block_rows=3)
    if "optimizer" in work:
        work["optimizer"] = dict(work["optimizer"], state_dtype="float32")
    c.workload = work
    return c


@pytest.fixture
def tiny():
    return tiny_cell
