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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
             "item_alignment_tpu")
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
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {"item_alignment_torch/ops/cuda_attention_blockwise.py",
            "item_alignment_torch/utils/hf_import.py",
            "item_alignment_torch/engine/checkpoint.py"} <= names
    bad = {f"{p.relative_to(ROOT)}: {name}" for p in files
           for name in _imported_roots(p) if name in FORBIDDEN}
    assert not bad, sorted(bad)


def test_kernel_source_ships_with_the_package():
    from item_alignment_torch.ops import _build

    for source in ("fused_attention.cu", "flash_blockwise_fwd.cu",
                   "flash_blockwise_bwd.cu", "attention_common.cuh",
                   "hopper_common.cuh"):
        assert (ROOT / "item_alignment_torch" / "csrc" / source).is_file()
    # kernel #2's contract runs on the forward of flash_blockwise_fwd.cu and
    # #3's on the dQ and dK/dV kernels of flash_blockwise_bwd.cu; their own
    # sources are gone
    for gone in ("attention_dropout_fwd.cu", "attention_dropout_bwd.cu"):
        assert not (ROOT / "item_alignment_torch" / "csrc" / gone).exists()
    # ops/_build.py names exactly the three sources
    assert sorted(_build.SOURCES) == ["flash_blockwise_bwd",
                                      "flash_blockwise_fwd", "fused_attention"]
    assert {f"{name}.cu" for name in _build.SOURCES} == {
        p.name for p in _build.CSRC.glob("*.cu")}


def test_kernels_are_built_at_first_use_not_at_import(monkeypatch, tmp_path):
    """Importing the port builds nothing and needs no nvcc; a launch where
    there is no nvcc raises instead of falling back."""
    from item_alignment_torch.ops import _build
    from item_alignment_torch.ops import cuda_attention_blockwise as cab

    assert not _build._LIBS
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    q = torch.zeros(1, 520, 1, 32)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cab._launch_fwd(0.0, 0, q, q, q, None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cab._launch_dq(0.0, 0, q, q, q, None, q, q, q)


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
