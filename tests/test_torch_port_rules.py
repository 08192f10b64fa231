"""Rules of the port: it imports no JAX, and its entry points run on cuda
unless asked for the CPU."""

import ast
import pathlib

import pytest
import torch

from item_alignment_torch.config import ModelConfig, TrainConfig
from item_alignment_torch.engine.inference import TwoTowerInference
from item_alignment_torch.engine.train import Trainer
from item_alignment_torch.models.text import (
    RobertaBackbone,
    RobertaOneTower,
    RobertaTwoTower,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "item_alignment_tpu")
TINY = ModelConfig(vocab_size=50, hidden_size=32, num_hidden_layers=1,
                   num_attention_heads=1, intermediate_size=32,
                   max_position_embeddings=32)


def _port_sources():
    files = sorted((ROOT / "item_alignment_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = _port_sources()
    assert len(files) > 10
    bad = {f"{p.relative_to(ROOT)}: {name}" for p in files
           for name in _imported_roots(p) if name in FORBIDDEN}
    assert not bad, sorted(bad)


def test_kernel_source_ships_with_the_package():
    for source in ("fused_attention.cu", "attention_dropout_fwd.cu",
                   "attention_dropout_bwd.cu", "attention_common.cuh"):
        assert (ROOT / "item_alignment_torch" / "csrc" / source).is_file()


@pytest.mark.parametrize("build", [
    lambda: RobertaOneTower(TINY),
    lambda: RobertaTwoTower(TINY),
    lambda: RobertaBackbone(TINY),
    lambda: TwoTowerInference(lambda b: b, lambda s, t: s),
    lambda: Trainer(torch.nn.Linear(2, 2), TrainConfig()),
])
def test_entry_points_default_to_cuda(build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


def test_entry_points_run_on_cpu_when_asked():
    model = RobertaOneTower(TINY, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
