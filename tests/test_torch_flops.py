"""The port's model-FLOP counter (``utils/flops.py``) vs the JAX package's
(``item_alignment_tpu/utils/flops.py``), on the CPU.

The five cases of ``tests/test_flops.py`` give the same numbers; an int8
``QuantDense`` counts what JAX counts of ``int8_matmul`` (the unpadded
``2·M·N·K``); ``RobertaOneTower`` at ``test_flops.py``'s tiny config counts
exactly JAX's forward, forward plus backward (``jax.grad``) and the
backward under remat.  The attention entry point counts its model FLOPs
whichever runs it: the plain attention, the kernels' plain versions on the
CPU, and the CUDA entry points stubbed to count without running give one
number.  The one product the port runs that JAX has no dot for, the
embedding backward's one-hot product (a scatter-add), counts 0 as JAX's
gather transpose does, so the counts are equal with no gap.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from item_alignment_torch.config import ModelConfig as TC
from item_alignment_torch.models import RobertaOneTower
from item_alignment_torch.models.encoder import QuantDense
from item_alignment_torch.ops import attention as tattn
from item_alignment_torch.utils.flops import FlopCounter, count_flops

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import ModelConfig as JC  # noqa: E402
from item_alignment_tpu.models.text import RobertaOneTower as JOne  # noqa: E402
from item_alignment_tpu.ops.quant import int8_matmul  # noqa: E402
from item_alignment_tpu.utils.flops import count_flops as jax_count  # noqa: E402

torch.set_num_threads(1)

# tests/test_flops.py:54-72's config
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, vocab_size=100, max_seq_len=8,
            max_seq_len_pv=8, max_position_embeddings=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def test_matmul_exact():
    a, b = torch.zeros(8, 32), torch.zeros(32, 16)
    ours = count_flops(lambda a, b: a @ b, a, b)
    assert ours == jax_count(lambda a, b: a @ b, jnp.zeros((8, 32)),
                             jnp.zeros((32, 16))) == 2 * 8 * 32 * 16
    assert count_flops(F.linear, a, b.T, torch.zeros(16)) == ours
    assert count_flops(torch.einsum, "mk,kn->mn", a, b) == ours


def test_conv_strided_exact():
    def f(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    theirs = jax_count(f, jnp.zeros((2, 16, 16, 3)), jnp.zeros((3, 3, 3, 8)))
    ours = count_flops(lambda x, w: F.conv2d(x, w, stride=2, padding=1),
                       torch.zeros(2, 3, 16, 16), torch.zeros(8, 3, 3, 3))
    assert ours == theirs == 2 * 2 * 8 * 8 * 8 * 9 * 3


def test_grouped_conv_exact():
    def f(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=4)
    theirs = jax_count(f, jnp.zeros((1, 8, 8, 16)), jnp.zeros((3, 3, 4, 16)))
    ours = count_flops(lambda x, w: F.conv2d(x, w, padding=1, groups=4),
                       torch.zeros(1, 16, 8, 8), torch.zeros(16, 4, 3, 3))
    assert ours == theirs == 2 * 1 * 8 * 8 * 16 * 9 * (16 // 4)


def test_loop_multiplies_by_length():
    """A Python loop of 5 counts what JAX's ``scan`` of length 5 counts."""
    def f(p, x):
        def body(c, xi):
            return c + jnp.sum(xi @ p), None
        return jax.lax.scan(body, 0.0, x)[0]

    def g(p, x):
        c = torch.zeros(())
        for xi in x:
            c = c + (xi @ p).sum()
        return c
    theirs = jax_count(f, jnp.zeros((16, 16)), jnp.zeros((5, 4, 16)))
    ours = count_flops(g, torch.zeros(16, 16), torch.zeros(5, 4, 16))
    assert ours == theirs == 5 * 2 * 4 * 16 * 16


def test_grad_counts_transposed_dots():
    def f(p, x):
        return jnp.sum((x @ p) ** 2)
    p, x = jnp.zeros((16, 16)), jnp.zeros((4, 16))
    fwd = jax_count(f, p, x)
    theirs = jax_count(jax.grad(f, argnums=(0, 1)), p, x)

    tp = torch.zeros(16, 16, requires_grad=True)
    tx = torch.zeros(4, 16, requires_grad=True)
    ours_fwd = count_flops(lambda: ((tx @ tp) ** 2).sum())
    ours = count_flops(lambda: ((tx @ tp) ** 2).sum().backward())
    assert ours_fwd == fwd and ours == theirs == 3 * fwd


@pytest.mark.parametrize("rows", [5, 32])
def test_int8_quant_dense_counts_as_jax_int8_matmul(rows):
    """``torch._int_mm`` counts ``2·M·N·K`` (the base counter counts 0),
    and ``int8_mm`` counts the product's own shape, not its padding to 17
    rows and multiples of 8."""
    rs = np.random.RandomState(0)
    x = rs.randn(rows, 36).astype(np.float32)
    kernel = rs.randn(36, 20).astype(np.float32)
    theirs = jax_count(lambda x, k: int8_matmul(x, k, jnp.zeros(20)),
                       jnp.asarray(x), jnp.asarray(kernel))
    dense = QuantDense(36, 20)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(kernel.T))
        ours = count_flops(dense, torch.from_numpy(x))
    assert ours == theirs == 2 * rows * 20 * 36
    a = torch.ones(32, 64, dtype=torch.int8)
    assert count_flops(torch._int_mm, a, a.T.contiguous()) == 2 * 32 * 32 * 64


def _models(remat=False, quant=None, flash=True, **extra):
    cfg = JC(**TINY, remat=remat, quant=quant)
    B, S = 2, cfg.pair_seq_len
    ids = jnp.ones((B, S), jnp.int32)
    mask = jnp.ones((B, S), jnp.int32)
    model = JOne(cfg)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, ids, mask)
    ours = RobertaOneTower(TC(**{**TINY, **extra}, remat=remat, quant=quant,
                              use_flash_attention=flash), device="cpu", seed=0)
    return model, params, ids, mask, ours


def _torch_batch():
    S = JC(**TINY).pair_seq_len
    ids = torch.ones(2, S, dtype=torch.long)
    return ids, torch.ones_like(ids), torch.tensor([0, 1])


def _step(model, ids, mask, labels, seed=None):
    def step():
        model(ids, mask, labels=labels, deterministic=seed is None,
              dropout_seed=seed).loss.backward()
    return step


@pytest.mark.parametrize("quant", [None, "int8"])
def test_encoder_forward_matches_jax(quant):
    model, params, ids, mask, ours = _models(quant=quant)
    theirs = jax_count(lambda p: model.apply(p, ids, mask).probs, params)
    tids, tmask, _ = _torch_batch()
    with torch.no_grad():
        got = count_flops(ours, tids, tmask)
    assert got == theirs
    if quant is None:  # test_flops.py:70's hand formula covers the encoder
        cfg = JC(**TINY)
        B, S, H = 2, cfg.pair_seq_len, cfg.hidden_size
        L, inter = cfg.num_hidden_layers, cfg.intermediate_size
        hand = L * (2 * B * S * (4 * H * H + 2 * H * inter) + 4 * B * S * S * H)
        assert hand <= got <= hand * 1.01


@pytest.mark.parametrize("remat", [False, True])
def test_encoder_forward_and_backward_match_jax_grad(remat):
    """Forward plus backward at dropout 0 equals ``count_flops(jax.grad)``
    exactly (within 1e-3 is the bound; there is no gap), and under remat
    the replayed attention products count as JAX's remat replays them."""
    model, params, ids, mask, ours = _models(remat=remat)
    labels = jnp.array([0, 1])
    theirs = jax_count(jax.grad(
        lambda p: model.apply(p, ids, mask, labels=labels).loss), params)
    got = count_flops(_step(ours, *_torch_batch()))
    assert abs(got - theirs) <= 1e-3 * theirs
    assert got == theirs


def _stub(monkeypatch):
    """The CUDA entry points replaced by elementwise stand-ins: they run no
    product, and the gradient still reaches q, k and v."""
    def stub(*args):
        q, k, v = [a for a in args if isinstance(a, torch.Tensor)][:3]
        return q + k + v

    for name in ("fused_attention", "fused_attention_dropout",
                 "fused_attention_blockwise",
                 "fused_attention_blockwise_dropout"):
        monkeypatch.setattr(tattn, name, stub)


@pytest.mark.parametrize("seed", [None, 7])
def test_both_attention_routes_count_the_same(seed, monkeypatch):
    """The plain attention (its own products), the kernels' plain versions
    on the CPU (their tiles' products hidden) and stubbed CUDA entry points
    (no product at all) count one number, dropout on or off, and it is
    JAX's count at dropout 0."""
    extra = ({} if seed is None else
             dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1))
    model, params, ids, mask, _ = _models()
    labels = jnp.array([0, 1])
    theirs = jax_count(jax.grad(
        lambda p: model.apply(p, ids, mask, labels=labels).loss), params)
    batch = _torch_batch()
    counts = {}
    for route in ("plain", "kernels' plain versions", "stubbed entry points"):
        with monkeypatch.context() as m:
            if route == "stubbed entry points":
                _stub(m)
            ours = _models(flash=route != "plain", **extra)[-1]
            counts[route] = count_flops(_step(ours, *batch, seed=seed))
    assert set(counts.values()) == {theirs}, counts


@pytest.mark.parametrize("S", [40, 520])
@pytest.mark.parametrize("stub", [False, True])
def test_flash_attention_counts_the_model_formula(S, stub, monkeypatch):
    """4·B·N·S²·H forward, 8· more in the backward, at S <= 512 and on the
    blockwise route; with only v needing a gradient the backward counts
    dV alone, and a forward without a graph counts no backward."""
    if stub:
        _stub(monkeypatch)
    B, N, H = 1, 2, 32
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, S, N, H, generator=gen).requires_grad_()
               for _ in range(3))
    unit = 2 * B * N * S * S * H
    with torch.no_grad():
        assert count_flops(tattn.flash_attention, q, k, v) == 2 * unit
    assert count_flops(lambda: tattn.flash_attention(
        q, k, v, dropout_rate=0.1, dropout_seed=3).sum().backward()) == 6 * unit
    qd, kd = q.detach(), k.detach()
    assert count_flops(lambda: tattn.flash_attention(
        qd, kd, v).sum().backward()) == 3 * unit
    # a graph made under the counter and run after it counts nowhere
    with FlopCounter():
        out = tattn.flash_attention(q, k, v)
    out.sum().backward()
    assert count_flops(lambda: None) == 0


def test_one_counter_at_a_time():
    with FlopCounter():
        with pytest.raises(RuntimeError, match="already counting"):
            FlopCounter().__enter__()
