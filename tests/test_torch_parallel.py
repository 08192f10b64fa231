"""The port's parallel layer on the CPU: the partition rules against JAX's,
the batch helpers, the keep bits at global indices, and sharded steps of
every family in gloo process groups against the one-device step.

The process groups are spawned once a module (``parallel/dryrun.spawn``):
four ranks for the meshes (4,1,1), (1,4,1), (2,1,2), (1,2,2) and the
tensor-parallel evaluation, eight for (2,2,2), the checkpoints, the other
families and the dry run.  Each worker computes from fixed seeds, so the
same call in this process without a group is the one-device result.  The
limits of the sharded steps are JAX's own (rtol 2e-5, atol 1e-6,
``tests/test_multichip_scaling.py``); the first step of that schedule has
lr 0 (one warmup step of eight), so the gradients handed to AdamW and its
first moments carry the step, beside the loss and the parameters.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.convert import flax_path, state_dict_from_flax
from item_alignment_torch.ops import cuda_attention_blockwise as cab
from item_alignment_torch.ops import cuda_attention_train as cat
from item_alignment_torch.parallel import dryrun
from item_alignment_torch.parallel import sharding as tsh

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import MeshConfig as JMesh  # noqa: E402
from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.config import OptimizerConfig as JOpt  # noqa: E402
from item_alignment_tpu.config import TrainConfig as JTrain  # noqa: E402
from item_alignment_tpu.engine.train import Trainer as JTrainer  # noqa: E402
from item_alignment_tpu.parallel import mesh as jmesh  # noqa: E402
from item_alignment_tpu.parallel import sharding as jsh  # noqa: E402

torch.set_num_threads(1)

MESHES4 = [(4, 1, 1), (1, 4, 1), (2, 1, 2), (1, 2, 2)]
FUSED = {"fuse_qkv": True}
FUSED_MESHES = [(1, 2, 2), (2, 1, 2)]
CLIP = {"max_grad_norm": 1e-2}  # below the gradients' norm: every step clips
RATES = (0.0, 0.1)
STEP_TOL = dict(rtol=2e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# partition rules
# ---------------------------------------------------------------------------

def _text_tree():
    from item_alignment_tpu.models.text import RobertaOneTower

    cfg = JConfig(**dryrun.TINY)
    ids = jnp.ones((2, cfg.pair_seq_len), jnp.int32)
    return jax.jit(RobertaOneTower(cfg).init)({"params": jax.random.PRNGKey(0)},
                                              ids, ids)


def _nfnet_tree():
    import item_alignment_tpu.models.image as im

    cfg = JConfig(model_name="eca_nfnet_l0", image_model_name="eca_nfnet_l0",
                  image_size=32)
    orig = dict(im.BACKBONES)
    im.BACKBONES["nfnet"] = lambda c: im.NFNet(depths=(1,), channels=(16,))
    try:
        x = jnp.ones((2, 32, 32, 3), jnp.float32)
        return jax.jit(im.ImageTwoTower(cfg).init)(
            {"params": jax.random.PRNGKey(0)}, x, x)
    finally:
        im.BACKBONES.update(orig)


def _coca_tree():
    from item_alignment_tpu.models.multimodal import CoCaForItemAlignment

    cfg = JConfig(model_name="coca", ensemble="sum", hidden_size=64,
                  num_hidden_layers=1, num_attention_heads=4,
                  intermediate_size=128, vocab_size=100,
                  max_position_embeddings=128, image_hidden_size=24,
                  multimodal_depth=1, coca_heads=4, ff_mult=2, image_size=16,
                  patch_size=8)
    ids = jnp.ones((2, 10), jnp.int32)
    img = jnp.ones((2, 16, 16, 3), jnp.float32)
    return jax.jit(CoCaForItemAlignment(cfg).init)(
        {"params": jax.random.PRNGKey(0)}, ids, img, ids, img)


TREES = {"roberta": _text_tree, "nfnet": _nfnet_tree, "coca": _coca_tree}


@pytest.fixture(scope="module")
def flax_trees():
    return {k: jax.tree_util.tree_map(np.asarray, f()) for k, f in TREES.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _expected(jspec, flax_shape, torch_shape, leaf):
    """JAX's spec as the port's tensor holds it: padded to the Flax rank,
    read backwards for a Dense kernel; a parameter whose rank the port
    changes (a ViT attention kernel) must be replicated."""
    spec = tuple(jspec) + (None,) * (len(flax_shape) - len(tuple(jspec)))
    if len(flax_shape) != len(torch_shape):
        assert not any(spec), spec
        return (None,) * len(torch_shape)
    if leaf == "kernel" and len(torch_shape) == 2:
        assert tuple(torch_shape) == tuple(reversed(flax_shape))
        return tuple(reversed(spec))
    return spec


@pytest.mark.parametrize("mesh", [(8, 1, 1), (1, 8, 1), (2, 2, 2), (4, 1, 2)])
@pytest.mark.parametrize("family", ["roberta", "nfnet", "coca", "kge"])
def test_placements_equal_jax_partition_specs(flax_trees, family, mesh):
    """Every parameter's placement equals JAX's ``param_partition_spec`` on
    its Flax path, transposed where the port's layout is ([out, in])."""
    jm = jmesh.create_mesh(JMesh(*mesh))
    sizes = dict(zip(("data", "fsdp", "tensor"), mesh))
    if family == "kge":
        from item_alignment_torch.kge.models import make_kge_model

        params = make_kge_model("pkgm", 50, 5, 16).init_params(
            torch.Generator().manual_seed(0))
        for name, p in params.items():
            assert tsh.param_partition_spec((name,), tuple(p.shape), sizes) \
                == tuple(jsh.param_partition_spec((name,), tuple(p.shape), jm))
        return
    tree = flax_trees[family]
    split = set()
    for name, t in state_dict_from_flax(tree).items():
        path = flax_path(name)
        flax_shape = np.shape(_leaf(tree["params"], path))
        want = _expected(jsh.param_partition_spec(path, flax_shape, jm),
                         flax_shape, t.shape, path[-1])
        assert tsh.torch_partition_spec(name, t.shape, sizes) == want, name
        split |= {ax for ax in want if ax}
    if family == "roberta":  # the rules name both axes, even of size 1
        assert split == {"fsdp", "tensor"}, split


def test_a_dimension_that_does_not_divide_is_replicated():
    sizes = {"data": 1, "fsdp": 2, "tensor": 4}
    name = "roberta.encoder.layer_0.attention.query"
    # out = 6 divides neither axis; in = 4 divides fsdp
    assert tsh.torch_partition_spec(f"{name}.weight", (6, 4), sizes) \
        == (None, "fsdp")
    assert tsh.torch_partition_spec(f"{name}.bias", (6,), sizes) == (None,)
    # the generic fallback: fsdp on a dimension that divides, else none
    assert tsh.torch_partition_spec(f"{name}.weight", (6, 3), sizes) \
        == ("fsdp", None)
    assert tsh.torch_partition_spec(f"{name}.weight", (5, 3), sizes) \
        == (None, None)
    assert tsh.torch_partition_spec(
        "roberta.embeddings.word_embeddings.weight", (10, 3), sizes) \
        == (None, None)


def test_model_outputs_are_pytree_nodes():
    """FSDP2 (torch 2.11) hooks the backward of the tensors that pytree
    finds in a module's output; a plain dataclass hides them, and then no
    gradient of the root is reduced."""
    from torch.utils._pytree import tree_flatten

    from item_alignment_torch.models.outputs import PairClassifierOutput

    out = PairClassifierOutput(logits=torch.ones(2), loss=torch.zeros(()))
    assert [t.shape for t in tree_flatten(out)[0]] == [(2,), ()]


# ---------------------------------------------------------------------------
# the batch helpers (tests/test_multihost.py)
# ---------------------------------------------------------------------------

def test_process_slice_partitions_batch():
    n, seen = 16, []
    for pi in range(4):
        seen.extend(range(n)[tsh.process_slice(n, process_index=pi,
                                               process_count=4)])
    assert seen == list(range(n))  # disjoint, ordered, complete
    dryrun.check_process_slices(16)


def test_process_slice_requires_divisibility():
    with pytest.raises(ValueError, match="not divisible"):
        tsh.process_slice(10, process_index=0, process_count=4)


def test_put_global_batch_single_process():
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    rows, b0 = tsh.put_global_batch(None, x)
    assert b0 == 0 and rows is x
    assert tsh.batch_sharding(None) == (0, 1)


# ---------------------------------------------------------------------------
# keep bits at global (row, head) indices
# ---------------------------------------------------------------------------

def test_keep_bits_of_a_slice_are_the_slice_of_the_whole():
    B, N, S, t = 6, 8, 40, 26
    like = torch.zeros(1)
    whole = cat.keep_mask_reference(99, B, N, S, t, like)
    assert torch.equal(cat.keep_mask_reference(99, B, N, S, t, like, N, 0),
                       whole)
    b0, n0 = 2, 4
    part = cat.keep_mask_reference(99, 3, 4, S, t, like, N, b0 * N + n0)
    assert torch.equal(part, whole[b0:b0 + 3, n0:n0 + 4])
    # the default index is today's formula: b * N + n
    bn = torch.arange(B)[:, None] * N + torch.arange(N)[None, :]
    head = cat.mix32(cat.mix32((99 & cat.M32) ^ 0x9E3779B9) ^ bn)
    assert torch.equal(whole[..., 0, 0], (cat.mix32(cat.mix32(head ^ 0) ^ 0)
                                          & 0xFF) >= t)


@pytest.mark.parametrize("S", [40, 520])
def test_attention_of_a_slice_is_the_slice_of_the_whole(S):
    """#2's and #3's plain versions (#4-#6's at S > 512) on rows 2.. and
    heads 4.. with (bn_stride, bn_base) equal the whole call's slice."""
    rs = np.random.RandomState(S)
    B, N, H = 4, 8, 16
    q, k, v, g = (torch.from_numpy(rs.randn(B, S, N, H).astype(np.float32))
                  for _ in range(4))
    bias = torch.zeros(B, 1, 1, S)
    bias[1, ..., S // 2:] = -1e9
    fwd, dq, dkv = ((cat.fused_attention_dropout_reference, None, None)
                    if S <= 512 else (cab.fused_attention_blockwise_reference,
                                      cab.flash_dq_reference,
                                      cab.flash_dkv_reference))
    out, lse = fwd(0.1, 7, q, k, v, bias)
    sl = (slice(2, 4), slice(None), slice(4, 8))
    args = [x[sl].contiguous() for x in (q, k, v)]
    out_s, lse_s = fwd(0.1, 7, *args, bias[2:4], N, 2 * N + 4)
    assert torch.equal(out_s, out[sl]) and torch.equal(lse_s, lse[2:4, 4:8])
    delta = cat.attention_delta(g, out)
    if dq is None:
        whole = cat.fused_attention_dropout_bwd_reference(
            0.1, 7, q, k, v, bias, g, lse, delta)
        part = cat.fused_attention_dropout_bwd_reference(
            0.1, 7, *args, bias[2:4], g[sl].contiguous(), lse[2:4, 4:8],
            delta[2:4, 4:8], N, 2 * N + 4)
    else:
        whole = (dq(0.1, 7, q, k, v, bias, g, lse, delta),
                 *dkv(0.1, 7, q, k, v, bias, g, lse, delta))
        rest = (bias[2:4], g[sl].contiguous(), lse[2:4, 4:8],
                delta[2:4, 4:8], N, 2 * N + 4)
        part = (dq(0.1, 7, *args, *rest), *dkv(0.1, 7, *args, *rest))
    for a, b in zip(part, whole):
        torch.testing.assert_close(a, b[sl], rtol=0, atol=1e-6)


@pytest.mark.parametrize("fn", ["text_step", "eval_probs", "gcn_step",
                                "kge_epoch", "dryrun_multichip"])
def test_dry_run_takes_the_card_unless_given_the_cpu(monkeypatch, fn):
    """Like every entry point of the port, the dry run's functions and its
    command line default to the card, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(dryrun, fn)()
    assert dryrun.spawn.__kwdefaults__["device"] is None


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def four():
    calls = [("text_step", (m, r)) for m in MESHES4 for r in RATES]
    calls += [("text_step", (m, 0.1), {"width": FUSED}) for m in FUSED_MESHES]
    calls += [("text_step", (m, 0.1), CLIP) for m in FUSED_MESHES]
    calls += [("eval_probs", (m, q)) for q in (None, "int8")
              for m in ((2, 2, 1), (2, 1, 2))]
    calls += [("legacy_adversarial_steps", ((2, 1, 2),))]
    calls += [("held_param_bytes", (m,)) for m in ((1, 4, 1), (4, 1, 1))]
    out = dryrun.spawn(dryrun.run_all, 4, calls, "cpu", device="cpu",
                       timeout=120)
    return dict(zip([str(c) for c in calls], out))


@pytest.fixture(scope="module")
def one_device():
    out = {r: dryrun.text_step(None, r, device="cpu") for r in RATES}
    out["fused"] = dryrun.text_step(None, 0.1, device="cpu", width=FUSED)
    out["clip"] = dryrun.text_step(None, 0.1, device="cpu", **CLIP)
    return out


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel8")
    # a one-device checkpoint for the (2,2,2) ranks to restore
    single = dryrun.resume_steps(None, str(tmp / "single"), device="cpu")
    calls = [("text_step", ((2, 2, 2), r)) for r in RATES]
    calls += [("resume_steps", ((2, 2, 2), str(tmp / "sharded"))),
              ("resume_steps", ((2, 2, 2), str(tmp / "again"),
                                str(tmp / "single"))),
              ("family_steps", ((2, 2, 2),)),
              ("gcn_step", ((8, 1, 1),)), ("kge_epoch", ((8, 1, 1),)),
              ("dryrun_multichip", ())]
    out = dryrun.spawn(dryrun.run_all, 8, calls, "cpu", device="cpu",
                       timeout=120)
    return dict(zip(["text0", "text1", "resume", "resume_single", "families",
                     "gcn8", "kge8", "dryrun"], out), single=single,
                tmp=tmp)


def _assert_step(got, ref, what):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-5,
                               err_msg=what)
    for part in ("grads", "params", "mu"):
        assert got[part].keys() == ref[part].keys()
        for n in ref[part]:
            torch.testing.assert_close(got[part][n], ref[part][n], **STEP_TOL,
                                       msg=lambda m: f"{what} {part} {n}: {m}")


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("mesh", MESHES4)
def test_sharded_step_equals_one_device(four, one_device, mesh, rate):
    _assert_step(four[str(("text_step", (mesh, rate)))], one_device[rate],
                 f"{mesh} dropout {rate}")


@pytest.mark.parametrize("mesh", FUSED_MESHES)
def test_sharded_fused_qkv_step_equals_one_device(four, one_device, mesh):
    """``fuse_qkv`` under tensor=2, dropout 0.1: each rank's product takes
    its rows of q, k and v side by side and splits them by the local
    width; its backward all-reduces the input's gradient over tensor."""
    _assert_step(four[str(("text_step", (mesh, 0.1), {"width": FUSED}))],
                 one_device["fused"], f"{mesh} fuse_qkv dropout 0.1")


@pytest.mark.parametrize("mesh", FUSED_MESHES)
def test_sharded_clipped_step_equals_one_device(four, one_device, mesh):
    """Global-norm clipping under fsdp and tensor: the norm is the whole
    gradients', reduced from each mesh's shards, so every rank scales by
    the one-device factor."""
    _assert_step(four[str(("text_step", (mesh, 0.1), CLIP))],
                 one_device["clip"], f"{mesh} clipped dropout 0.1")


def test_fsdp_gathers_one_block_at_a_time(four):
    """Over fsdp=4 a rank holds, as each layer starts, the root's
    parameters, that layer whole and a quarter of each other layer (FSDP2
    on every layer, then the root); over data=4 it holds them all."""
    sharded = four[str(("held_param_bytes", ((1, 4, 1),)))]
    replicated = four[str(("held_param_bytes", ((4, 1, 1),)))]
    whole, layer = sharded["whole"], sharded["layer"]
    assert replicated["peak"] == whole
    assert sharded["peak"] == whole - 3 * (layer - layer // 4)


@pytest.mark.parametrize("rate", RATES)
def test_sharded_step_equals_one_device_on_222(eight, one_device, rate):
    _assert_step(eight[f"text{int(rate > 0)}"], one_device[rate],
                 f"(2,2,2) dropout {rate}")


@pytest.mark.parametrize("quant", [None, "int8"])
def test_tensor_parallel_eval_equals_tensor_1(four, quant):
    """tensor=2 evaluation equals tensor=1 (JAX's
    ``test_flagship_tp2_matches_tp1_logits`` and its int8 twin): the
    per-channel scales are the shard's, the per-token absmax spans the
    whole feature axis."""
    tp1 = four[str(("eval_probs", ((2, 2, 1), quant)))]
    tp2 = four[str(("eval_probs", ((2, 1, 2), quant)))]
    assert np.isfinite(tp1).all() and len(np.unique(tp1)) > 1
    np.testing.assert_allclose(tp2, tp1, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(tp1, dryrun.eval_probs(None, quant,
                                                      device="cpu"),
                               rtol=2e-5, atol=2e-6)


def test_adversarial_deltas_follow_the_one_device_run(four):
    """PGD noise on the legacy member under (2,1,2), dropout 0.1: each rank
    updates the whole deltas from the whole batch's gradient, as one
    device does.  After the second step (the first with lr above 0) the
    key biases hold AdamW's scaling of fp32 noise (their gradient is zero
    in exact arithmetic: softmax ignores a shift shared by all keys), so
    they are held to 1e-4, the rest to 1e-6."""
    got = four[str(("legacy_adversarial_steps", ((2, 1, 2),)))]
    ref = dryrun.legacy_adversarial_steps(None, device="cpu")
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-5)
    for part in ("deltas", "params"):
        for n, t in ref[part].items():
            atol = 1e-4 if n.endswith("key.bias") else 1e-6
            torch.testing.assert_close(got[part][n], t, rtol=1e-4, atol=atol,
                                       msg=lambda m: f"{part} {n}: {m}")
    assert all(d.abs().max() > 0 for d in got["deltas"].values())


def test_port_step_on_212_equals_jax_step_on_212():
    """At dropout 0 the port's (2,1,2) Trainer, from JAX's weights, follows
    JAX's Trainer on its (2,1,2) mesh for two steps (the second with lr
    above 0) within 1e-4."""
    from item_alignment_tpu.models.text import RobertaOneTower

    cfg = JConfig(**dryrun.TINY, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)
    batch = dryrun.text_batch(cfg, 8)
    model = RobertaOneTower(cfg)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(3)},
                                 jnp.asarray(batch["input_ids"]),
                                 jnp.asarray(batch["attention_mask"]))
    state = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    jt = JTrainer(model, JTrain(seed=0, train_batch_size=8, eval_batch_size=8,
                                scan_steps=1, mesh=JMesh(2, 1, 2),
                                optimizer=JOpt(**dryrun.OPT)),
                  params=params["params"])
    jt.setup(batch)
    losses = []
    for _ in range(2):
        jt.state, loss = jt._train_step(jt.state, jt._device_batch(batch))
        losses.append(float(loss))
    ours = dryrun.spawn(dryrun.text_step, 4, (2, 1, 2), 0.0, state, 8, 2,
                        "cpu", device="cpu", timeout=120)
    np.testing.assert_allclose(ours["losses"], losses, rtol=0, atol=1e-4)
    theirs = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jt.state.params}))
    for n, p in ours["params"].items():
        np.testing.assert_allclose(p.numpy(), theirs[n].numpy(), rtol=0,
                                   atol=1e-4, err_msg=n)


def test_checkpoint_222_resumes_the_trajectory(eight):
    """Save on (2,2,2), restore into a new Trainer there: the next step is
    the uninterrupted one (JAX's ``test_sharded_checkpoint_roundtrip_222``),
    with dropout 0.1."""
    r = eight["resume"]
    assert r["meta"]["epoch"] == 0 and abs(r["meta"]["best_f1"] - 0.5) < 1e-9
    np.testing.assert_allclose(r["resumed"], r["continued"], rtol=1e-6)
    for n, p in r["params_continued"].items():
        assert torch.equal(r["params_resumed"][n], p), n


def test_checkpoint_moves_between_one_device_and_222(eight, tmp_path):
    """A state saved on (2,2,2) loads on one device, and one saved on one
    device loads on (2,2,2): either way the next step is the other run's."""
    on_one = dryrun.resume_steps(None, str(tmp_path / "x"),
                                 str(eight["tmp"] / "sharded"), device="cpu")
    np.testing.assert_allclose(on_one["resumed"], eight["resume"]["continued"],
                               rtol=2e-5)
    np.testing.assert_allclose(eight["resume_single"]["resumed"],
                               eight["single"]["continued"], rtol=2e-5)
    for n, p in eight["single"]["params_continued"].items():
        torch.testing.assert_close(eight["resume_single"]["params_resumed"][n],
                                   p, **STEP_TOL)


@pytest.fixture(scope="module")
def families():
    return dryrun.family_steps(None, "cpu")


@pytest.mark.parametrize("family", ["nfnet", "coca", "gcn"])
def test_family_sharded_step_equals_unsharded(eight, families, family):
    """One step of each family on (2,2,2) (and the GCN's pair batch over
    a data axis of 8), dropout 0.1: loss and whole gradients."""
    ref = families[family]
    runs = [eight["families"][family]] + ([eight["gcn8"]] if family == "gcn"
                                          else [])
    for got in runs:
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        for n, g in ref["grads"].items():
            torch.testing.assert_close(got["grads"][n], g, rtol=1e-4,
                                       atol=1e-5, msg=lambda m: f"{n}: {m}")


def test_kge_sharded_epoch_equals_unsharded(eight, families):
    """JAX's ``test_kge_family_sharded_epoch_matches_unsharded`` on data 8
    and on (2,2,2): the loss, and the tables too."""
    ref = families["kge"]
    for got in (eight["kge8"], eight["families"]["kge"]):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
        for n, p in ref["params"].items():
            torch.testing.assert_close(got["params"][n], p, rtol=1e-4,
                                       atol=1e-5)


def test_dryrun_multichip(eight):
    losses = eight["dryrun"]
    assert set(losses) == {"text", "nfnet", "coca", "gcn", "kge"}
    assert all(np.isfinite(v) for v in losses.values())
