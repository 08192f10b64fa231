"""The port's Flax msgpack reader vs ``flax.serialization``, on the CPU.

Trees that flax writes (fp32, bf16, int32, uint8 arrays, numpy and Python
scalars, empty dicts, nested lists, strings and None) decode to what
``msgpack_restore`` gives, bit for bit; so do flax's chunked arrays, with
``MAX_CHUNK_SIZE`` set small inside the test.  A malformed file raises a
``ValueError`` that names it.  A ``best_f1.msgpack`` that the JAX CLI wrote
goes through the port's ``mine``, ``finetune-text --do_eval --do_pred``
(predict.sh's line), ``load_params`` and ``model-soup`` and gives JAX's
outputs.
"""

import json

import numpy as np
import pytest
import torch

from item_alignment_torch import cli as tcli
from item_alignment_torch.convert import state_dict_from_flax
from item_alignment_torch.engine.checkpoint import load_params
from item_alignment_torch.utils.flax_msgpack import (
    read_flax_msgpack,
    restore,
)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from item_alignment_tpu import cli as jcli  # noqa: E402
from item_alignment_tpu.engine.checkpoint import save_params as jsave  # noqa: E402
from test_torch_cli import (  # noqa: E402,F401
    _flags,
    _keep_torch_rng,
    _mine,
    _pred_probs,
    _run,
    corpus,
    jax_one_tower,
    jax_two_tower,
)

torch.set_num_threads(1)


def _tree(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "params": {
            "dense": {"kernel": rs.randn(5, 3).astype(np.float32),
                      "bias": np.zeros(3, np.float32)},
            "bf16": jnp.asarray(rs.randn(4, 2).astype(np.float32)).astype(
                jnp.bfloat16),
            "ids": rs.randint(-9, 9, (2, 3)).astype(np.int32),
            "pixels": rs.randint(0, 256, (2, 2, 3)).astype(np.uint8),
            "empty": {},
            "zero_size": np.zeros((0, 4), np.float32),
        },
        "step": np.int64(12345678901),
        "scale": np.float32(0.5),
        "python": [1, -7, 300, -40000, 2 ** 40, 1.25, True, None, "x",
                   [b"raw", {"k": 3}]],
    }


def _same(got, ref, path="tree"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), path
        for k in ref:
            _same(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert isinstance(got, torch.Tensor), path
        if ref.dtype == jnp.bfloat16:
            assert got.dtype == torch.bfloat16, path
            got = got.view(torch.uint16)
            ref = np.asarray(ref).view(np.uint16)
        assert got.shape == np.shape(ref), path
        assert got.numpy().dtype == np.asarray(ref).dtype, path
        assert np.array_equal(got.numpy(), np.asarray(ref)), path
    elif isinstance(ref, bytes):
        assert bytes(got) == ref, path
    else:
        assert got == ref and type(got) is type(ref), path


def test_reader_equals_flax_msgpack_restore(tmp_path):
    raw = serialization.msgpack_serialize(_tree())
    ref = serialization.msgpack_restore(raw)
    (tmp_path / "t.msgpack").write_bytes(raw)
    _same(read_flax_msgpack(str(tmp_path / "t.msgpack")), ref)
    _same(restore(bytearray(raw)), ref)


def test_chunked_arrays(monkeypatch):
    """flax splits arrays over MAX_CHUNK_SIZE bytes into flat chunks."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rs = np.random.RandomState(1)
    tree = {"big": rs.randn(7, 9).astype(np.float32),
            "nested": {"ids": np.arange(50, dtype=np.int32).reshape(5, 10)},
            "small": np.ones(3, np.float32)}
    raw = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in raw
    ref = serialization.msgpack_restore(raw)
    got = restore(bytearray(raw))
    _same(got, ref)
    assert got["big"].shape == (7, 9)


@pytest.mark.parametrize("damage", ["truncated", "garbage", "trailing",
                                    "bad_ext", "empty"])
def test_malformed_file_raises_a_value_error_naming_it(tmp_path, damage):
    raw = serialization.msgpack_serialize(_tree())
    data = {"truncated": raw[:-7], "garbage": b"\xc1" + raw,
            "trailing": raw + b"\x00", "empty": b"",
            "bad_ext": b"\x81\xa1a\xd4\x09\x00"}[damage]
    path = tmp_path / f"{damage}.msgpack"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=str(path)):
        read_flax_msgpack(str(path))
    with pytest.raises(ValueError, match=str(path)):
        load_params(str(path))


def test_load_params_of_a_jax_file_is_the_converted_tree(tmp_path):
    tree = {"roberta": {"encoder": {"dense": {
        "kernel": np.random.RandomState(2).randn(4, 6).astype(np.float32),
        "bias": np.arange(6, dtype=np.float32)}}}}
    jsave(str(tmp_path / "p.msgpack"), tree)
    got = load_params(str(tmp_path / "p.msgpack"))
    ref = state_dict_from_flax(tree)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], ref[k])


def test_jax_best_f1_msgpack_through_the_port_mine(corpus, jax_two_tower,
                                                   capsys):
    msgpack, _ = jax_two_tower
    ref = _run(jcli.main, _mine(corpus, msgpack, "jmine_mp.jsonl"),
               capsys)[-1]
    got = _run(tcli.main, _mine(corpus, msgpack, "tmine_mp.jsonl",
                                "--device", "cpu"), capsys)[-1]
    rows, probs = _pred_probs(got["output"])
    ref_rows, ref_probs = _pred_probs(ref["output"])
    assert [(r["src_item_id"], r["tgt_item_id"]) for r in rows] == \
        [(r["src_item_id"], r["tgt_item_id"]) for r in ref_rows]
    assert len(rows) == 4
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-4)


def test_model_soup_of_jax_files(corpus, jax_two_tower, tmp_path, capsys):
    msgpack, pt = jax_two_tower
    ref = load_params(pt)
    out = _run(tcli.main, ["model-soup", "--checkpoints", str(msgpack), pt,
                           "--output", str(tmp_path / "soup.pt"),
                           "--device", "cpu"], capsys)[-1]
    assert out["n"] == 2
    soup = torch.load(tmp_path / "soup.pt", weights_only=True)
    assert sorted(soup) == sorted(ref)
    for k in ref:
        assert torch.equal(soup[k], (ref[k] + ref[k]) / 2.0), k
    assert json.loads(json.dumps(out))["output"].endswith("soup.pt")


def test_jax_best_f1_msgpack_through_finetune_text_eval_and_pred(
        corpus, jax_one_tower, capsys):
    """predict.sh's ``finetune-text --do_pred --file_state_dict
    best_f1.msgpack``: the JAX run's own file evaluates and predicts as the
    JAX CLI did, within 1e-4."""
    lines = _run(tcli.main, _flags(
        corpus, "torch_mp", "--do_eval", "--do_pred", "--device", "cpu",
        "--file_state_dict",
        str(jax_one_tower["dir"] / "best_f1.msgpack")), capsys)
    ev = [o for o in lines if "sweep" in o][-1]
    ref = jax_one_tower["eval"]
    assert abs(ev["best_f1"] - ref["best_f1"]) <= 1e-4
    assert abs(ev["best_threshold"] - ref["best_threshold"]) <= 1e-4
    pred = [o for o in lines if "prediction_file" in o][-1]
    _, probs = _pred_probs(pred["prediction_file"])
    _, ref_probs = _pred_probs(jax_one_tower["pred"]["prediction_file"])
    assert len(probs) == 4
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-4)
