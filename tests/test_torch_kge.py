"""The port's KGE library (``item_alignment_torch/kge``) vs the JAX
package's, on the CPU.

Parameters come from the JAX models' ``init_params`` and move to the port as
numpy arrays; toy KGs and negatives are made from seeds with numpy.  Scores
and trained parameters agree within 1e-5; ``bernoulli_probs``, the ranks,
the inference top-k, the numpy-only modules and the ``.npz`` files exactly.
"""

import os

import numpy as np
import pytest
import torch

from item_alignment_torch.config import MeshConfig
from item_alignment_torch.kge import evaluation as tev
from item_alignment_torch.kge import graph as tgraph
from item_alignment_torch.kge import inference as tinf
from item_alignment_torch.kge import losses as tloss
from item_alignment_torch.kge import models as tmodels
from item_alignment_torch.kge import redundancy as tred
from item_alignment_torch.kge import sampling as tsamp
from item_alignment_torch.kge import type_constraints as ttc
from item_alignment_torch.kge.train import KGETrainer as TTrainer
from item_alignment_torch.models.layers import take_rows

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.kge import evaluation as jev  # noqa: E402
from item_alignment_tpu.kge import graph as jgraph  # noqa: E402
from item_alignment_tpu.kge import inference as jinf  # noqa: E402
from item_alignment_tpu.kge import losses as jloss  # noqa: E402
from item_alignment_tpu.kge import models as jmodels  # noqa: E402
from item_alignment_tpu.kge import redundancy as jred  # noqa: E402
from item_alignment_tpu.kge import sampling as jsamp  # noqa: E402
from item_alignment_tpu.kge import type_constraints as jtc  # noqa: E402
from item_alignment_tpu.kge.train import KGETrainer as JTrainer  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
N_ENT, N_REL, DIM = 20, 5, 16


def _kg(mod, n_ent=30, n_rel=4, n_facts=120, seed=0, structured=True):
    """tests/test_kge.py's toy KG: structured tails t = (h + r + 1) % n, or
    random ones (several tails to a head and relation)."""
    rs = np.random.RandomState(seed)
    h = rs.randint(0, n_ent, n_facts)
    r = rs.randint(0, n_rel, n_facts)
    t = (h + r + 1) % n_ent if structured else rs.randint(0, n_ent, n_facts)
    return mod.KnowledgeGraph(h, r, t, n_ent, n_rel)


def _params(name, seed=0, n_ent=N_ENT, n_rel=N_REL, dim=DIM):
    """(JAX model, JAX params, port model, port params) on one draw."""
    jm = jmodels.make_kge_model(name, n_ent, n_rel, dim)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = tmodels.make_kge_model(name, n_ent, n_rel, dim)
    return jm, jp, tm, _to_torch(jp)


def _to_torch(jp):
    return tmodels.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _facts(B=8, seed=1, n_ent=N_ENT, n_rel=N_REL):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, n_ent, B), rs.randint(0, n_rel, B),
            rs.randint(0, n_ent, B))


def _close(ours, theirs, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(ours.detach()),
                               np.asarray(theirs), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("name", tmodels.KNOWN)
def test_score_matches_jax(name):
    jm, jp, tm, tp = _params(name)
    h, r, t = _facts()
    _close(tm.score(tp, h, r, t), jm.score(jp, h, r, t), name)


@pytest.mark.parametrize("kind", ["L1", "L2", "torus_L1", "torus_L2",
                                  "torus_eL2"])
def test_dissimilarities_match_jax(kind):
    rs = np.random.RandomState(2)
    a, b = rs.rand(2, 6, DIM).astype(np.float32)
    _close(tmodels.dissimilarity(torch.from_numpy(a), torch.from_numpy(b),
                                 kind),
           jmodels.dissimilarity(jnp.asarray(a), jnp.asarray(b), kind), kind)
    jm = jmodels.make_kge_model("transe", N_ENT, N_REL, DIM, kind)
    tm = tmodels.make_kge_model("transe", N_ENT, N_REL, DIM, kind)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tp = _to_torch(jp)
    h, r, t = _facts()
    _close(tm.score(tp, h, r, t), jm.score(jp, h, r, t), "transe " + kind)
    _close(tm.scores_all_tails(tp, h, r), jm.scores_all_tails(jp, h, r),
           "tails " + kind)


@pytest.mark.parametrize("name", tmodels.KNOWN)
def test_scores_all_candidates_match_jax_and_pointwise(name):
    """``scores_all_tails/heads`` (the ||x||^2 - 2x.e + ||e||^2 expansion or
    the chunked fallback) against JAX's and against pointwise ``score``; the
    pkgm head expansion also on an entity table off the unit sphere."""
    jm, jp, tm, tp = _params(name, seed=3)
    h, r, t = _facts(5, seed=4)
    cand = np.arange(N_ENT)
    with torch.no_grad():
        tails = tm.scores_all_tails(tp, h, r)
        point_t = tm.score(tp, np.repeat(h, N_ENT), np.repeat(r, N_ENT),
                           np.tile(cand, 5)).reshape(5, N_ENT)
    _close(tails, jm.scores_all_tails(jp, jnp.asarray(h), jnp.asarray(r)),
           "tails vs jax")
    if name == "pkgm":  # the head expansion normalises each candidate
        jp["ent_emb"] = jp["ent_emb"] * jnp.linspace(0.5, 2.0, N_ENT)[:, None]
        tp = _to_torch(jp)
    with torch.no_grad():
        heads = tm.scores_all_heads(tp, t, r)
        point_h = tm.score(tp, np.tile(cand, 5), np.repeat(r, N_ENT),
                           np.repeat(t, N_ENT)).reshape(5, N_ENT)
    assert tails.shape == heads.shape == (5, N_ENT)
    _close(heads, jm.scores_all_heads(jp, jnp.asarray(t), jnp.asarray(r)),
           "heads vs jax")
    if name != "transe":  # transe's expansion reads the raw table
        _close(tails, point_t, "tails vs pointwise", tol=2e-4)
        _close(heads, point_h, "heads vs pointwise", tol=2e-4)


def test_chunked_candidates_span_several_chunks(monkeypatch):
    """The fallback scorers' chunks (4096 candidates; 7 here) tile the
    candidates exactly once, in order."""
    jm, jp, tm, tp = _params("transh", seed=5)
    monkeypatch.setattr(tmodels, "CHUNK", 7)
    h, r, t = _facts(3, seed=6)
    _close(tm.scores_all_tails(tp, h, r),
           jm.scores_all_tails(jp, jnp.asarray(h), jnp.asarray(r)), "tails")
    _close(tm.scores_all_heads(tp, t, r),
           jm.scores_all_heads(jp, jnp.asarray(t), jnp.asarray(r)), "heads")


@pytest.mark.parametrize("name", ["transe", "transh", "distmult"])
def test_normalize_parameters_and_embeddings_match_jax(name):
    jm, jp, tm, tp = _params(name, seed=7)
    jp = {k: v * 3.0 for k, v in jp.items()}  # off the unit sphere
    tp = _to_torch(jp)
    ours, theirs = tm.normalize_parameters(tp), jm.normalize_parameters(jp)
    assert ours.keys() == theirs.keys()
    for k in ours:
        _close(ours[k], theirs[k], k)
    for a, b in zip(tm.get_embeddings(tp), jm.get_embeddings(jp)):
        _close(a, b, "get_embeddings")


@pytest.mark.parametrize("kind", ["margin", "logistic", "bce"])
def test_losses_match_jax(kind):
    rs = np.random.RandomState(8)
    pos, neg = (rs.randn(2, 24) * 3).astype(np.float32)
    _close(tloss.kge_loss(kind, torch.from_numpy(pos), torch.from_numpy(neg),
                          0.7),
           jloss.kge_loss(kind, jnp.asarray(pos), jnp.asarray(neg), 0.7),
           kind)


def test_forward_tiles_the_positives_like_jax():
    jm, jp, tm, tp = _params("pkgm", seed=9)
    h, r, t = _facts(6, seed=10)
    rs = np.random.RandomState(11)
    nh, nt = rs.randint(0, N_ENT, (2, 18))
    for a, b in zip(tm.forward(tp, h, t, r, nh, nt),
                    jm.forward(jp, *(jnp.asarray(x) for x in
                                     (h, t, r, nh, nt)))):
        assert a.shape == b.shape == (18,)
        _close(a, b, "forward")


def test_take_rows_gradient_of_a_3d_table():
    """The lookup behind every KGE gather gives ``table[ids]`` and its
    gradient for a [n, d, d] table (TransR's projections), small and
    large."""
    for rows, n_ids in ((5, 40), (3000, 40)):
        rs = np.random.RandomState(rows)
        table = torch.from_numpy(rs.randn(rows, 3, 4).astype(np.float32))
        ids = torch.from_numpy(rs.randint(0, rows, n_ids))
        ids[:10] = 1
        w = torch.from_numpy(rs.randn(n_ids, 3, 4).astype(np.float32))
        a = table.clone().requires_grad_()
        b = table.clone().requires_grad_()
        ra, rb = take_rows(a, ids), b[ids]
        assert torch.equal(ra, rb)
        (ra * w).sum().backward()
        (rb * w).sum().backward()
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- sampling
def test_bernoulli_probs_equal_jax():
    for kg_args in (dict(), dict(n_ent=12, n_rel=7, n_facts=300, seed=3)):
        assert np.array_equal(tsamp.bernoulli_probs(_kg(tgraph, **kg_args)),
                              jsamp.bernoulli_probs(_kg(jgraph, **kg_args)))


@pytest.mark.parametrize("cls", ["UniformNegativeSampler",
                                 "BernoulliNegativeSampler"])
def test_corruption_changes_one_side_within_range(cls):
    """Each negative keeps one side of its fact and draws the other from
    [1, n_ent); the head is chosen about as often as the sampler says."""
    kg = _kg(tgraph, n_facts=2000)
    sampler = getattr(tsamp, cls)(kg, n_neg=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    nh, nt = (x.numpy() for x in sampler.corrupt_kg_device(gen))
    h3, t3 = np.tile(kg.head_idx, 3), np.tile(kg.tail_idx, 3)
    assert nh.shape == nt.shape == (3 * kg.n_facts,)
    # one side at most changes (a drawn id may equal the old one)
    new_h, new_t = nh != h3, nt != t3
    assert not (new_h & new_t).any() and (new_h | new_t).mean() > 0.9
    drawn = np.concatenate([nh[new_h], nt[new_t]])
    assert drawn.min() >= 1 and drawn.max() < kg.n_ent
    p = (0.5 if cls.startswith("Uniform")
         else np.tile(sampler.bern_probs.numpy()[kg.relations], 3).mean())
    assert abs(new_h.mean() / (new_h | new_t).mean() - p) < 0.05
    a = sampler.corrupt_kg_device(torch.Generator().manual_seed(0))
    assert all(torch.equal(x, torch.from_numpy(y)) for x, y in
               zip(a, (nh, nt)))


def test_positional_pools_match_jax():
    """The padded per-relation pools equal JAX's, and every drawn entity
    comes from its relation's pool on the corrupted side."""
    kgs = [_kg(mod, n_ent=40, n_rel=3, n_facts=200, seed=4)
           for mod in (tgraph, jgraph)]
    ours = tsamp.PositionalNegativeSampler(kgs[0], n_neg=4, max_pool=16,
                                           device="cpu")
    theirs = jsamp.PositionalNegativeSampler(kgs[1], n_neg=4, max_pool=16)
    for k in ("head_table", "head_sizes", "tail_table", "tail_sizes"):
        assert np.array_equal(getattr(ours, k).numpy(),
                              np.asarray(getattr(theirs, k))), k
    nh, nt = (x.numpy() for x in ours.corrupt_batch(
        torch.Generator().manual_seed(1), kgs[0].head_idx, kgs[0].tail_idx,
        kgs[0].relations))
    rel = np.tile(kgs[0].relations, 4)
    heads = ours.head_table.numpy()
    tails = ours.tail_table.numpy()
    for i in range(len(nh)):
        assert nh[i] in heads[rel[i]] or nt[i] in tails[rel[i]]


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("name,accumulate", [("pkgm", 1), ("pkgm", 2),
                                             ("transe", 1)])
def test_kge_trainer_matches_jax(name, accumulate, monkeypatch):
    """Two epochs of three steps from the same initial parameters with the
    same negatives given to both trainers (each sampler's
    ``corrupt_kg_device`` patched to return them): the losses and the
    normalised parameters after each run within 1e-5."""
    kgs = [_kg(mod) for mod in (tgraph, jgraph)]
    kw = dict(n_neg=2, batch_size=32, n_epochs=2, learning_rate=1e-2,
              grad_accumulation_steps=accumulate, seed=0)
    jt = JTrainer(jmodels.make_kge_model(name, 30, 4, DIM), kgs[1], **kw)
    tt = TTrainer(tmodels.make_kge_model(name, 30, 4, DIM), kgs[0],
                  device="cpu", **kw)
    tt.params = _to_torch(jt.params)
    rs = np.random.RandomState(5)
    negs = [rs.randint(1, 30, (2, 2 * 120)) for _ in range(2)]
    j_negs, t_negs = iter(negs), iter(negs)
    monkeypatch.setattr(jt.sampler, "corrupt_kg_device",
                        lambda rng, n_neg=None: tuple(
                            jnp.asarray(x) for x in next(j_negs)))
    monkeypatch.setattr(tt.sampler, "corrupt_kg_device",
                        lambda gen, n_neg=None: tuple(
                            torch.from_numpy(x) for x in next(t_negs)))
    jr, tr = jt.run(), tt.run()
    np.testing.assert_allclose([h["loss"] for h in tr["history"]],
                               [h["loss"] for h in jr["history"]],
                               rtol=TOL, atol=TOL)
    assert tr["params"].keys() == jr["params"].keys()
    for k, v in tr["params"].items():
        _close(v, jr["params"][k], k)
    assert tt.adam.count == 6 // accumulate


def test_kge_trainer_moves_on_the_device_it_was_given():
    kg = _kg(tgraph)
    tt = TTrainer(tmodels.make_kge_model("transe", 30, 4, 8), kg, n_neg=1,
                  batch_size=64, n_epochs=1, device="cpu", seed=3)
    before = {k: v.clone() for k, v in tt.params.items()}
    out = tt.run()
    assert np.isfinite(out["history"][0]["loss"])
    assert not torch.equal(before["ent_emb"], out["params"]["ent_emb"])
    assert {v.device.type for v in out["params"].values()} == {"cpu"}


@pytest.mark.parametrize("mesh", [None, (1, 1, 1), (-1, 1, 1), MeshConfig()])
def test_kge_trainer_takes_a_one_device_mesh(mesh):
    TTrainer(tmodels.make_kge_model("transe", 30, 4, 8), _kg(tgraph),
             batch_size=64, n_epochs=1, device="cpu", mesh=mesh)


@pytest.mark.parametrize("mesh", [(2, 1, 1), (1, 2, 1), MeshConfig(tensor=2)])
def test_kge_trainer_raises_on_a_larger_mesh(mesh):
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 #4: Parallelism"):
        TTrainer(tmodels.make_kge_model("transe", 30, 4, 8), _kg(tgraph),
                 batch_size=64, n_epochs=1, device="cpu", mesh=mesh)


def test_kge_final_npz_moves_between_the_packages(tmp_path):
    """A JAX-written ``.npz`` loads in the port, and the reverse, key for
    key and bit for bit."""
    kgs = [_kg(mod) for mod in (tgraph, jgraph)]
    jt = JTrainer(jmodels.make_kge_model("pkgm", 30, 4, 8), kgs[1],
                  batch_size=64, n_epochs=1)
    jt.save(str(tmp_path / "jax" / "kge_final.npz"))
    ours = TTrainer.load(str(tmp_path / "jax" / "kge_final.npz"),
                         device="cpu")
    assert ours.keys() == jt.params.keys()
    for k, v in ours.items():
        assert v.dtype == torch.float32
        assert np.array_equal(v.numpy(), np.asarray(jt.params[k])), k
    tt = TTrainer(tmodels.make_kge_model("pkgm", 30, 4, 8), kgs[0],
                  batch_size=64, n_epochs=1, device="cpu")
    tt.save(str(tmp_path / "torch" / "kge_final.npz"))
    theirs = JTrainer.load(str(tmp_path / "torch" / "kge_final.npz"))
    assert theirs.keys() == tt.params.keys()
    for k, v in theirs.items():
        assert np.array_equal(np.asarray(v), tt.params[k].numpy()), k


# -------------------------------------------------------------- evaluation
def _split(mod):
    kg = _kg(mod, n_facts=200, structured=False)
    return kg.split_kg(share=0.8, seed=0)


@pytest.mark.parametrize("name", ["pkgm", "transe", "distmult", "transh"])
def test_link_prediction_matches_jax(name):
    """Raw and filtered ranks (head and tail side) equal, and so the mean
    rank, MRR and hit@10, with the filter of train + test."""
    (t_train, t_test), (j_train, j_test) = _split(tgraph), _split(jgraph)
    jm, jp, tm, tp = _params(name, seed=12, n_ent=30, n_rel=4)
    ours = tev.LinkPredictionEvaluator(tm, tp, t_test,
                                       kg_filter=(t_train, t_test),
                                       batch_size=16).evaluate()
    theirs = jev.LinkPredictionEvaluator(jm, jp, j_test,
                                         kg_filter=(j_train, j_test),
                                         batch_size=16).evaluate()
    for k in ("ranks_t", "ranks_h", "filt_ranks_t", "filt_ranks_h"):
        assert np.array_equal(getattr(ours, k), getattr(theirs, k)), k
    raw, filt = ours._both()
    assert (filt <= raw).all() and (filt < raw).any()
    assert ours.mean_rank() == theirs.mean_rank()
    assert ours.mrr() == theirs.mrr()
    assert ours.hit_at_k(10) == theirs.hit_at_k(10)


def test_relation_prediction_and_triplet_classification_match_jax():
    (t_train, t_test), (j_train, j_test) = _split(tgraph), _split(jgraph)
    jm, jp, tm, tp = _params("transe", seed=13, n_ent=30, n_rel=4)
    assert tev.RelationPredictionEvaluator(tm, tp, t_test).evaluate(7) == \
        jev.RelationPredictionEvaluator(jm, jp, j_test).evaluate(7)
    ours = tev.TripletClassificationEvaluator(tm, tp, t_train, t_test, seed=2)
    theirs = jev.TripletClassificationEvaluator(jm, jp, j_train, j_test,
                                                seed=2)
    assert ours.accuracy() == theirs.accuracy()
    np.testing.assert_allclose(ours.thresholds, theirs.thresholds, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("what", ["tails", "heads", "relations"])
def test_inference_top_k_matches_jax(what):
    """Top-k predictions equal JAX's, with a dictionary of known facts
    filtered out, and their scores within 1e-5."""
    kg = _kg(tgraph, n_facts=40)
    jm, jp, tm, tp = _params("distmult", seed=14, n_ent=30, n_rel=4)
    if what == "relations":
        known = {(int(kg.head_idx[0]), int(kg.tail_idx[0])): {0, 2}}
        args = (kg.head_idx[:9], kg.tail_idx[:9])
        ours = tinf.RelationInference(tm, tp, *args, top_k=2,
                                      dictionary=known)
        theirs = jinf.RelationInference(jm, jp, *args, top_k=2,
                                        dictionary=known)
    else:
        anchor = kg.head_idx if what == "tails" else kg.tail_idx
        known = {(int(anchor[0]), int(kg.relations[0])): {0, 1, 2, 3}}
        args = (anchor[:9], kg.relations[:9])
        ours = tinf.EntityInference(tm, tp, *args, top_k=5, missing=what,
                                    dictionary=known)
        theirs = jinf.EntityInference(jm, jp, *args, top_k=5, missing=what,
                                      dictionary=known)
    assert np.array_equal(ours.evaluate(b_size=4), theirs.evaluate(b_size=4))
    np.testing.assert_allclose(ours.scores, theirs.scores, rtol=TOL,
                               atol=TOL)
    assert not set(ours.predictions[0]) & set(next(iter(known.values())))


# ------------------------------------------------- the numpy-only modules
def _ccks_files(d):
    d.mkdir(parents=True, exist_ok=True)
    ents = [f"/item/i{i}" for i in range(12)] + [f"/value/v{i}"
                                                 for i in range(6)]
    rels = ["[PAD]", "brand", "size", "color"]
    (d / "entity2id.txt").write_text("".join(f"{e}\t{i}\n"
                                             for i, e in enumerate(ents)))
    (d / "relation2id.txt").write_text("".join(f"{r}\t{i}\n"
                                               for i, r in enumerate(rels)))
    rs = np.random.RandomState(15)
    for name, n in (("train2id.txt", 40), ("valid2id.txt", 8),
                    ("test2id.txt", 6)):
        (d / name).write_text("".join(
            f"{ents[rs.randint(12)]}\t{rels[rs.randint(1, 4)]}\t"
            f"{ents[12 + rs.randint(6)]}\n" for _ in range(n)) + "\n")
    return str(d)


def _same_kg(a, b):
    for k in ("head_idx", "relations", "tail_idx"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert (a.n_ent, a.n_rel, a.ent2ix, a.rel2ix) == \
        (b.n_ent, b.n_rel, b.ent2ix, b.rel2ix)


def test_graph_module_equals_jax(tmp_path):
    path = _ccks_files(tmp_path / "kg")
    ours = tgraph.load_ccks(path, do_eval=True, do_test=True)
    theirs = jgraph.load_ccks(path, do_eval=True, do_test=True)
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        _same_kg(a, b)
    for a, b in zip(_kg(tgraph, n_facts=200).split_kg(0.7, seed=1),
                    _kg(jgraph, n_facts=200).split_kg(0.7, seed=1)):
        _same_kg(a, b)
    assert ours[1].dict_of_tails(ours[0]) == theirs[1].dict_of_tails(
        theirs[0])
    assert ours[2].dict_of_heads(*ours[:2]) == theirs[2].dict_of_heads(
        *theirs[:2])
    triples = [("a", "r", "b"), ("b", "s", "c"), ("c", "r", "a")]
    _same_kg(tgraph.KnowledgeGraph.from_triples(triples),
             jgraph.KnowledgeGraph.from_triples(triples))


def test_type_constraints_and_redundancy_equal_jax(tmp_path):
    path = _ccks_files(tmp_path / "kg")
    ours = tgraph.load_ccks(path, do_eval=True, do_test=True)
    theirs = jgraph.load_ccks(path, do_eval=True, do_test=True)
    assert ttc.relation_categories(*ours) == jtc.relation_categories(*theirs)
    a = ttc.write_type_constraints(str(tmp_path / "t"), *ours)
    b = jtc.write_type_constraints(str(tmp_path / "j"), *theirs)
    assert open(a).read() == open(b).read()
    assert ttc.split_test_by_category(str(tmp_path / "t"), ours[0], ours[2],
                                      ours[1]) == \
        jtc.split_test_by_category(str(tmp_path / "j"), theirs[0], theirs[2],
                                   theirs[1])
    for name in ("1-1.txt", "1-n.txt", "n-1.txt", "n-n.txt"):
        assert open(os.path.join(tmp_path, "t", name)).read() == \
            open(os.path.join(tmp_path, "j", name)).read()
    # duplicated and reversed relations, and a cartesian product relation
    h = np.array([0, 1, 0, 1, 2, 3, 0, 0, 1, 1])
    r = np.array([0, 0, 1, 1, 2, 2, 3, 3, 3, 3])
    t = np.array([2, 3, 2, 3, 0, 1, 2, 3, 2, 3])
    tk, jk = (mod.KnowledgeGraph(h, r, t, 4, 4) for mod in (tgraph, jgraph))
    assert tred.duplicates(tk) == jred.duplicates(jk)
    assert tred.duplicates(tk)[0]
    assert tred.cartesian_product_relations(tk) == \
        jred.cartesian_product_relations(jk) == [3]
