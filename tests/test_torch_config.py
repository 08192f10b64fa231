"""The port's ModelConfig equals the JAX package's, field by field."""

import dataclasses

import pytest

from item_alignment_torch.config import ModelConfig as TorchConfig

pytest.importorskip("jax")
from item_alignment_tpu.config import ModelConfig as JaxConfig  # noqa: E402

PRESETS = ["roberta_base", "roberta_large", "pkgm_base", "pkgm_large",
           "roberta_image_large", "textcnn"]


def test_fields_and_defaults_match():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(JaxConfig)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(TorchConfig)]
    assert tf == jf
    assert dataclasses.asdict(TorchConfig()) == dataclasses.asdict(JaxConfig())


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_match(preset):
    t = getattr(TorchConfig, preset)(dtype="bfloat16")
    j = getattr(JaxConfig, preset)(dtype="bfloat16")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("head_dim", "item_seq_len", "pair_seq_len",
                 "num_cls_features"):
        assert getattr(t, prop) == getattr(j, prop)


def test_from_json_and_replace_match():
    kw = dict(max_seq_len=50, max_seq_len_pv=205, dtype="bfloat16")
    t = TorchConfig.from_json("configs/roberta_large.json", **kw)
    j = JaxConfig.from_json("configs/roberta_large.json", **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.pair_seq_len == 510 and t.item_seq_len == 255
    assert (dataclasses.asdict(t.replace(cls_layers=(1, 2), cls_pool="avg"))
            == dataclasses.asdict(j.replace(cls_layers=(1, 2), cls_pool="avg")))
