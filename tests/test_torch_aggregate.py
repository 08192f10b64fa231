"""The port's aggregation (``aggregate/{ensemble,soup,submit}.py``) vs the
JAX package's, on the CPU, on the same data: fused rows equal, soups equal
bit for bit, submission archives with the same members and bytes."""

import json
import zipfile

import numpy as np
import pytest
import torch

from item_alignment_torch.aggregate import ensemble as tens
from item_alignment_torch.aggregate import soup as tsoup
from item_alignment_torch.aggregate import submit as tsub
from item_alignment_torch.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)

jax = pytest.importorskip("jax")
from item_alignment_tpu.aggregate import ensemble as jens  # noqa: E402
from item_alignment_tpu.aggregate import soup as jsoup  # noqa: E402
from item_alignment_tpu.aggregate import submit as jsub  # noqa: E402


def _members(seed=0, n=20, k=3):
    """k members' rows over the same pairs (in another order for the
    second), each with its threshold and f1."""
    rs = np.random.RandomState(seed)
    out = []
    for m in range(k):
        rows = [{"src_item_id": f"s{i}", "src_item_emb": f"[{rs.rand()}]",
                 "tgt_item_id": f"t{i}", "tgt_item_emb": f"[{rs.rand()}]",
                 "threshold": 0.5} for i in range(n)]
        if m == 1:
            rows = rows[::-1]
        out.append((rows, float(0.3 + 0.1 * m), float(0.8 + 0.02 * m)))
    return out


ID_DICT = {f"{p}{i}": {"cate_name": "衬衫" if i % 3 == 0 else "手机"}
           for p in "st" for i in range(20)}


@pytest.mark.parametrize("strategy", ["threshold", "f1"])
@pytest.mark.parametrize("split", [False, True])
def test_ensemble_predictions_match_jax(strategy, split):
    members = _members()
    kw = {}
    if split:
        kw = dict(unseen_model_predictions=_members(seed=1, k=2))
        ours = tens.ensemble_predictions(
            members, strategy, pair_is_unseen=tens.make_unseen_checker(
                ID_DICT), **kw)
        theirs = jens.ensemble_predictions(
            members, strategy, pair_is_unseen=jens.make_unseen_checker(
                ID_DICT), **kw)
    else:
        ours = tens.ensemble_predictions(members, strategy)
        theirs = jens.ensemble_predictions(members, strategy)
    assert ours == theirs and len(ours) == 20
    assert json.dumps(ours) == json.dumps(theirs)
    if strategy == "f1":
        assert {r["tgt_item_emb"] for r in ours} <= {"[1.0]", "[-1.0]"}
    with pytest.raises(ValueError):
        tens.ensemble_predictions(members, "mean")


def test_prediction_files_and_parse_prob_match_jax(tmp_path):
    rows = _members(k=1)[0][0]
    a = tens.write_prediction_file(rows, str(tmp_path / "t" / "p.jsonl"))
    b = jens.write_prediction_file(rows, str(tmp_path / "j" / "p.jsonl"))
    assert open(a, "rb").read() == open(b, "rb").read()
    assert tens.read_prediction_file(a) == jens.read_prediction_file(b) == rows
    for text in ("[0.25]", " [0.5,0.1] ", "[1e-3, 2]"):
        assert tens.parse_prob(text) == jens.parse_prob(text)
    assert tens.ONLY_TEST_CATES == jens.ONLY_TEST_CATES
    assert tens.ONLY_VALID_CATES == jens.ONLY_VALID_CATES


def _states(n=3, seed=0):
    rs = np.random.RandomState(seed)
    return [{"a.weight": torch.from_numpy(rs.randn(4, 3).astype(np.float32)),
             "a.bias": torch.from_numpy(rs.randn(4).astype(np.float32)),
             "n.layer_norm.weight": torch.from_numpy(
                 rs.randn(3).astype(np.float32))} for _ in range(n)]


def _flax(states):
    return [flax_from_state_dict(s) for s in states]


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("restrict", [False, True])
def test_uniform_soup_matches_jax(n, restrict):
    """The sum in the JAX order, then the division, bit for bit; entries
    left out by ``include`` come from the last state dict."""
    states = _states(n)
    if restrict:
        ours = tsoup.uniform_soup(states, include=lambda k: "bias" not in k)
        theirs = jsoup.uniform_soup(_flax(states), include=lambda path: all(
            getattr(p, "key", None) != "bias" for p in path))
    else:
        ours = tsoup.uniform_soup(states)
        theirs = jsoup.uniform_soup(_flax(states))
    theirs = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, theirs))
    assert ours.keys() == theirs.keys()
    for k, v in ours.items():
        assert torch.equal(v, theirs[k]), k
    if restrict and n > 1:
        assert torch.equal(ours["a.bias"], states[-1]["a.bias"])
    with pytest.raises(ValueError):
        tsoup.uniform_soup([])


def test_greedy_soup_matches_jax():
    """The same candidates kept in the same order: a score that prefers
    weights near a target takes some state dicts and leaves others."""
    states = _states(4, seed=3)
    target = states[2]["a.weight"].numpy() * 0.5

    def t_score(s):
        return -float(np.abs(s["a.weight"].numpy() - target).sum())

    def j_score(tree):
        return -float(np.abs(np.asarray(
            tree["params"]["a"]["kernel"]).T - target).sum())

    ours = tsoup.greedy_soup(states, t_score)
    theirs = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jsoup.greedy_soup(_flax(states), j_score)))
    for k, v in ours.items():
        assert torch.equal(v, theirs[k]), k
    assert not any(torch.equal(ours["a.weight"], s["a.weight"])
                   for s in states)


def test_load_state_dicts_on_the_cpu(tmp_path):
    from item_alignment_torch.engine.checkpoint import save_params

    states = _states(2)
    paths = []
    for i, s in enumerate(states):
        paths.append(str(tmp_path / f"{i}.pt"))
        save_params(paths[-1], s)
    loaded = tsoup.load_state_dicts(paths, "cpu")
    assert all(torch.equal(a[k], b[k]) for a, b in zip(loaded, states)
               for k in a)


def test_submission_matches_jax(tmp_path):
    rows = tens.ensemble_predictions(_members(), "threshold")
    path = tens.write_prediction_file(rows, str(tmp_path / "r.jsonl"))
    assert tsub.validate_submission(path) == jsub.validate_submission(path) \
        == {"rows": 20, "ok": True}
    ours = tsub.package_submission(path, str(tmp_path / "t" / "result.zip"))
    theirs = jsub.package_submission(path, str(tmp_path / "j" / "result.zip"))
    with zipfile.ZipFile(ours) as a, zipfile.ZipFile(theirs) as b:
        assert a.namelist() == b.namelist() == ["similarity.py",
                                                "deepAI_result.jsonl"]
        for name in a.namelist():
            assert a.read(name) == b.read(name)
        scope = {}
        exec(a.read("similarity.py").decode(), scope)
    assert scope["compute"]([0.1], [0.7, 0.2]) == 0.7
    loaded = scope["load_embeddings"](path)
    assert len(loaded) == 20 and loaded[0][0] == rows[0]["src_item_id"]
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"src_item_id": "a", "src_item_emb": "[0]",
                               "tgt_item_id": "b", "tgt_item_emb": "[]",
                               "threshold": 0.0}) + "\n")
    with pytest.raises(ValueError):
        tsub.validate_submission(str(bad))
    with pytest.raises(AssertionError):
        jsub.validate_submission(str(bad))
