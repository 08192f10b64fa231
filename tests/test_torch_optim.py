"""The port's optimizer vs the JAX package's (``engine/optim.py``) on the
same parameters and gradients, made with numpy."""

import dataclasses

import numpy as np
import pytest
import torch

from item_alignment_torch.config import ModelConfig as TConfig
from item_alignment_torch.config import OptimizerConfig as TOpt
from item_alignment_torch.convert import flax_from_state_dict, state_dict_from_flax
from item_alignment_torch.engine import optim as topt
from item_alignment_torch.models.text import RobertaOneTower

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from item_alignment_tpu.config import OptimizerConfig as JOpt  # noqa: E402
from item_alignment_tpu.engine import optim as jopt  # noqa: E402

# tiny shapes and many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

TINY = TConfig(vocab_size=50, hidden_size=16, num_hidden_layers=1,
               num_attention_heads=2, intermediate_size=32,
               max_position_embeddings=32, max_seq_len=4, max_seq_len_pv=4,
               auxiliary_task=True)


def _tree(seed):
    """A Flax-layout tree with a kernel, an embedding, a bias and a
    LayerNorm scale."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    return {"params": {"dense": {"kernel": f(6, 4), "bias": f(4)},
                       "word_embeddings": {"embedding": f(5, 4)},
                       "layer_norm": {"scale": f(4), "bias": f(4)}}}


def _jax_run(cfg_kw, steps, grads, tx=None):
    params = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    tx = tx or jopt.make_optimizer(JOpt(**cfg_kw), params)
    state = tx.init(params)
    for g in grads:
        g = jax.tree_util.tree_map(jnp.asarray, g)
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return jax.tree_util.tree_map(np.asarray, params)


def _torch_run(cfg_kw, grads):
    params = {n: torch.nn.Parameter(t)
              for n, t in state_dict_from_flax(_tree(0)).items()}
    opt = topt.make_optimizer(TOpt(**cfg_kw), params)
    for g in grads:
        for n, t in state_dict_from_flax(g).items():
            params[n].grad = t
        opt.step()
        opt.zero_grad()
    return flax_from_state_dict(params)


def _assert_trees_close(a, b, rtol, atol):
    fa = dict(jax.tree_util.tree_flatten_with_path(a)[0])
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_allclose(fa[k], fb[k], rtol=rtol, atol=atol,
                                   err_msg=str(k))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_adamw_matches_jax_for_3_steps(state_dtype, wd):
    kw = dict(learning_rate=1e-2, weight_decay=wd, total_steps=10,
              warmup_proportion=0.1, state_dtype=state_dtype)
    grads = [_tree(s + 1) for s in range(3)]
    expect = _jax_run(kw, 3, grads)
    got = _torch_run(kw, grads)
    # the same fp32 arithmetic up to the order of rounding in the bias
    # corrections and the schedule (float32 in JAX, float64 here)
    _assert_trees_close(got, expect, rtol=1e-5, atol=1e-7)


def test_linear_warmup_decay_matches_optax():
    kw = dict(learning_rate=5e-5, total_steps=16000, warmup_proportion=0.1)
    js, ts = jopt.linear_warmup_decay(JOpt(**kw)), topt.linear_warmup_decay(TOpt(**kw))
    for step in (0, 1, 800, 1599, 1600, 1601, 9000, 15999, 16000, 20000):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(step))


def _model_names():
    model = RobertaOneTower(TINY, device="cpu", seed=0)
    return model, [n for n, _ in model.named_parameters()]


def _jax_mask_by_name(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): bool(v)
            for path, v in flat}


def test_decay_and_freeze_masks_match_jax():
    model, names = _model_names()
    tree = flax_from_state_dict(model.state_dict())
    from item_alignment_torch.convert import flax_path
    for ours, theirs in (
            (topt.decay_mask(names), jopt.decay_mask(tree["params"])),
            (topt.freeze_mask(names, ("embed", "encoder.layer_0.attention",
                                      "kernel")),
             jopt.freeze_mask(tree["params"], ("embed",
                                               "encoder.layer_0.attention",
                                               "kernel")))):
        theirs = _jax_mask_by_name(theirs)
        assert {flax_path(n): v for n, v in ours.items()} == theirs
        assert 0 < sum(ours.values()) < len(ours)


def test_clipping_freezing_and_accumulation_match_jax():
    """max_grad_norm, freeze_patterns and grad_accumulation_steps through
    make_optimizer, 4 mini-steps (2 updates at k=2)."""
    grads = [jax.tree_util.tree_map(lambda x, s=s: x * (1 + s), _tree(s + 1))
             for s in range(4)]
    for kw in (dict(max_grad_norm=1.0), dict(freeze_patterns=("dense",)),
               dict(grad_accumulation_steps=2),
               dict(grad_accumulation_steps=2, max_grad_norm=0.5)):
        kw = dict(learning_rate=1e-2, total_steps=10, **kw)
        expect = _jax_run(kw, 4, grads)
        got = _torch_run(kw, grads)
        _assert_trees_close(got, expect, rtol=1e-5, atol=1e-7)
        if "freeze_patterns" in kw:
            np.testing.assert_array_equal(got["params"]["dense"]["kernel"],
                                          _tree(0)["params"]["dense"]["kernel"])


def test_optimizer_config_defaults_match():
    assert dataclasses.asdict(TOpt()) == dataclasses.asdict(JOpt())
