"""The port's GCNII and GCNTwoTower vs the JAX package's, on the CPU.

A random graph of 37 nodes (normalised, sorted by destination, with its
transpose; whole and in chunks of 32 edges, padded), features [37, 12],
hidden 8, 3 layers, from both Flax parameter layouts: the stacked ``conv``
tree of ``gcn_scan_layers`` and ``conv_0..conv_2`` (the port holds the
first and ``convert`` stacks the second).  The JAX models are initialised
with ``jax.jit(model.init)``, their trees converted with
``state_dict_from_flax``; the forward (deterministic) and every parameter's
gradient agree within 1e-5.  Both trees survive a round trip through
``convert``.  Dropout is flax's exact rate at the input, at each layer and
at the output.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.config import ModelConfig as TConfig
from item_alignment_torch.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from item_alignment_torch.models import build_model
from item_alignment_torch.models import graph as tgraph
from item_alignment_torch.ops.sparse import Adjacency

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.models import graph as jgraph  # noqa: E402
from item_alignment_tpu.ops import sparse as jsp  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
N, FEAT, B = 37, 12, 6


@pytest.fixture(scope="module", autouse=True)
def _keep_torch_rng():
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


def graph_inputs(seed=0, chunk=None):
    """Edges (sorted, with the transpose, padded to ``chunk``), features,
    a pair batch and labels, from a seed."""
    rs = np.random.RandomState(seed)
    ei = np.unique(rs.randint(0, N, (2, 120)), axis=1)
    ei, ew = jsp.normalize_adjacency(ei, N)
    ti, tw = jsp.transpose_edges(ei, ew)
    ei, ew = jsp.sort_edges_by_dst(ei, ew)
    if chunk:
        target = -(-ei.shape[1] // chunk) * chunk
        ei, ew = jsp.pad_edges(ei, ew, target, pad_dst=N - 1)
        ti, tw = jsp.pad_edges(ti, tw, target, pad_dst=N - 1)
    feats = rs.randn(N, FEAT).astype(np.float32)
    src = rs.randint(0, N, B).astype(np.int32)
    tgt = rs.randint(0, N, B).astype(np.int32)
    labels = np.array([0, 1, 1, 0, 1, 0], np.int32)
    return dict(ei=ei, ew=ew, trans=(ti, tw), feats=feats, src=src, tgt=tgt,
                labels=labels)


def _configs(scan, chunk=None, **kw):
    kw = {**dict(model_name="gcn", gcn_hidden=8, gcn_layers=3,
                 gcn_feature_dim=FEAT, gcn_edge_chunk=chunk,
                 gcn_scan_layers=scan, gcn_sorted_edges=True,
                 hidden_dropout_prob=0.0), **kw}
    return JConfig(**kw), TConfig(**kw)


def _jax_model(jcfg, g):
    model = jgraph.GCNTwoTower(jcfg)
    trans = tuple(map(jnp.asarray, g["trans"]))
    args = (jnp.asarray(g["feats"]), jnp.asarray(g["ei"]),
            jnp.asarray(g["ew"]), jnp.asarray(g["src"]),
            jnp.asarray(g["tgt"]))
    params = jax.jit(lambda k: model.init(
        {"params": k}, *args, labels=jnp.asarray(g["labels"]),
        edge_transpose=trans))(jax.random.PRNGKey(0))
    return model, params, args, trans


def _port(tcfg, params, g, chunk):
    model = tgraph.GCNTwoTower(tcfg, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    adj = Adjacency(g["ei"], g["ew"], N, chunk, g["trans"], device="cpu")
    t = {k: torch.from_numpy(g[k]).long() for k in ("src", "tgt", "labels")}
    return model, adj, torch.from_numpy(g["feats"]), t


@pytest.mark.parametrize("scan", [True, False], ids=["stacked", "conv_l"])
@pytest.mark.parametrize("chunk", [None, 32], ids=["whole", "chunked"])
def test_gcn_two_tower_forward_and_grads_match_jax(scan, chunk):
    g = graph_inputs(chunk=chunk)
    jcfg, tcfg = _configs(scan, chunk)
    jmodel, params, args, trans = _jax_model(jcfg, g)
    labels = jnp.asarray(g["labels"])

    def loss_fn(p):
        out = jmodel.apply(p, *args, labels=labels, edge_transpose=trans)
        return out.loss, out

    (ref_loss, ref), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    model, adj, feats, t = _port(tcfg, params, g, chunk)
    out = model(feats, adj, t["src"], t["tgt"], labels=t["labels"])
    for name in ("logits", "probs", "src_embeds", "tgt_embeds"):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                   np.asarray(getattr(ref, name)), atol=TOL)
    assert abs(out.loss.item() - float(ref_loss)) < TOL
    out.loss.backward()
    ref_g = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                        ref_grads))
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(ref_g)
    for name, p in names.items():
        scale = max(1.0, float(ref_g[name].abs().max()))
        err = float((p.grad - ref_g[name]).abs().max())
        assert err <= TOL * scale, (name, err)


def test_gcn_is_deterministic_and_the_layouts_compute_one_function():
    """The port holds one layout; both Flax trees of one set of weights
    load into it as the same state and give the same probabilities."""
    g = graph_inputs(seed=1)
    _, tcfg = _configs(True)
    model = tgraph.GCNTwoTower(tcfg, device="cpu", seed=3)
    layered = flax_from_state_dict(model.state_dict(), scan_layers=False)
    conv = layered["params"]["encoder"]
    assert "conv" not in conv and sorted(k for k in conv if "conv" in k) \
        == ["conv_0", "conv_1", "conv_2"]
    stacked = flax_from_state_dict(model.state_dict())
    assert stacked["params"]["encoder"]["conv"]["weight"]["kernel"].shape \
        == (3, 8, 8)
    adj = Adjacency(g["ei"], g["ew"], N, None, g["trans"], device="cpu")
    feats = torch.from_numpy(g["feats"])
    src, tgt = (torch.from_numpy(g[k]).long() for k in ("src", "tgt"))
    a = model(feats, adj, src, tgt).probs
    assert torch.equal(a, model(feats, adj, src, tgt).probs)
    for tree in (stacked, layered):
        other = tgraph.GCNTwoTower(tcfg, device="cpu", seed=None)
        other.load_state_dict(state_dict_from_flax(tree))
        assert torch.equal(a, other(feats, adj, src, tgt).probs)


@pytest.mark.parametrize("scan", [True, False], ids=["stacked", "conv_l"])
def test_both_flax_trees_survive_a_round_trip(scan):
    g = graph_inputs()
    jcfg, tcfg = _configs(scan)
    _, params, _, _ = _jax_model(jcfg, g)
    tree = jax.tree_util.tree_map(np.asarray, params)
    state = state_dict_from_flax(tree)
    model = tgraph.GCNTwoTower(tcfg, device="cpu", seed=None)
    model.load_state_dict(state)  # every name and shape fits the port
    back = flax_from_state_dict(model.state_dict(), scan_layers=scan)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        assert np.array_equal(flat_back[path], leaf), path
    if scan:
        assert tree["params"]["encoder"]["conv"]["weight"]["kernel"].shape \
            == (3, 8, 8)


def test_gcn_dropout_sites_use_the_exact_rate(monkeypatch):
    """Three sites (input, each layer, output) at flax's rate, each with
    its own seed."""
    calls = []
    real = tgraph.dropout

    def spy(x, rate, seed, deterministic):
        calls.append((rate, seed))
        return real(x, rate, seed, deterministic)

    monkeypatch.setattr(tgraph, "dropout", spy)
    g = graph_inputs()
    _, tcfg = _configs(True, hidden_dropout_prob=0.3)
    model = tgraph.GCNTwoTower(tcfg, device="cpu", seed=0)
    adj = Adjacency(g["ei"], g["ew"], N, None, g["trans"], device="cpu")
    feats = torch.ones(N, FEAT)
    src, tgt = (torch.from_numpy(g[k]).long() for k in ("src", "tgt"))
    model(feats, adj, src, tgt, deterministic=False, dropout_seed=11)
    assert [r for r, _ in calls] == [0.3] * (1 + 3 + 1)
    assert len({s for _, s in calls}) == 5
    # the input site's kept fraction is 1 - 0.3 on 37 x 12 ones, scaled
    x = real(torch.ones(2000, 50), 0.3, calls[0][1], False)
    assert abs(float((x > 0).float().mean()) - 0.7) < 0.01
    assert torch.allclose(x[x > 0], torch.tensor(1 / 0.7))


def test_build_model_gives_gcn_a_two_tower():
    _, tcfg = _configs(False)
    assert isinstance(build_model(tcfg, device="cpu"), tgraph.GCNTwoTower)
