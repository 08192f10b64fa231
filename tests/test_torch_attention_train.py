"""The training attention of the port (kernels #2 and #3) vs the JAX
package, on the CPU.

The port's plain versions ``fused_attention_dropout_reference`` (#2) and
``fused_attention_dropout_bwd_reference`` (#3) follow their CUDA kernels; the
CPU wrappers run them.  The JAX side is ``dot_product_attention`` and
``jax.grad`` of it, as the JAX package's own CPU tests run it.  With dropout
the TPU's random bits cannot be reproduced, so the dropout tests mirror the
JAX package's kernel tests (``tests/test_pallas_kernel_tpu.py``):
statistics, forward/backward mask identity and the rate -> 0 limit.
"""

import math

import numpy as np
import pytest
import torch

from item_alignment_torch.ops import _launch
from item_alignment_torch.ops import attention as tatt
from item_alignment_torch.ops import cuda_attention
from item_alignment_torch.ops import cuda_attention_blockwise as cab
from item_alignment_torch.ops import cuda_attention_train as cat

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.ops import attention as jatt  # noqa: E402
from test_torch_attention import _inputs, _pretend_cuda  # noqa: E402

# tiny shapes and many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (S, N): the 1/8-grid inputs of test_torch_attention, with a ragged last
# key tile (37, 130, 255) and 12 heads
CASES = [(37, 4), (130, 12), (255, 4)]


def _bias(mask):
    return tatt.make_attention_bias(torch.from_numpy(mask))


def _jax_scores(q, k, mask):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = jnp.einsum("bsnh,btnh->bnst", jnp.asarray(q), jnp.asarray(k),
                   preferred_element_type=jnp.float32) * scale
    return s + jatt.make_attention_bias(jnp.asarray(mask))


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("S,N", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_rate0_matches_jax(S, N, dtype):
    q, k, v, mask = _inputs(S, dtype, N=N)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    expect = jax.jit(lambda q, k, v, b: jatt.dot_product_attention(
        q, k, v, b, dtype=jd))(*(jnp.asarray(x, jd) for x in (q, k, v)),
                               jatt.make_attention_bias(jnp.asarray(mask)))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    out, lse = cat.fused_attention_dropout_fwd(0.0, 0, tq, tk, tv, _bias(mask))
    assert out.dtype == getattr(torch, dtype) and lse.dtype == torch.float64
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(expect.astype(jnp.float32)),
                               rtol=0, atol=TOL[dtype])
    # JAX's lse is fp32, whose own rounding at |lse| ~ 1e3 (the x30 row) and
    # 1e9 (the fully masked row) exceeds 1e-5: hold it relatively as well
    jlse = np.asarray(jax.nn.logsumexp(_jax_scores(q, k, mask), axis=-1))
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=1e-6, atol=TOL[dtype])
    # the fully masked row keeps log(S) above the -1e9 bias
    np.testing.assert_allclose(lse[1].numpy() + 1e9, math.log(S), atol=1e-3)


@pytest.mark.parametrize("S,N", CASES)
def test_backward_rate0_matches_jax_grad(S, N):
    """fp32 dq/dk/dv within 1e-4 of jax.grad relative to max|ref| (the
    comparison of test_pallas_kernel_tpu.py:164-181)."""
    q, k, v, mask = _inputs(S, "float32", N=N)
    w = np.random.RandomState(S).randn(*q.shape).astype(np.float32)
    jb = jatt.make_attention_bias(jnp.asarray(mask))
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        jatt.dot_product_attention(q, k, v, jb) * jnp.asarray(w)),
        argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    bias = _bias(mask)
    out, lse = cat.fused_attention_dropout_fwd(0.0, 0, tq, tk, tv, bias)
    ours = cat.fused_attention_dropout_bwd(0.0, 0, tq, tk, tv, bias,
                                           torch.from_numpy(w), out, lse)
    for name, a, b in zip("qkv", ours, grads):
        assert a.dtype == torch.float32
        assert _rel_err(a.numpy(), b) < 1e-4, name


def test_backward_bf16_matches_jax_grad():
    """bf16: keep * p and ds are rounded to bf16 before their products, as
    in the TPU kernel, so the grads agree within 2e-2 of max|ref|."""
    q, k, v, mask = _inputs(130, "bfloat16")
    w = np.random.RandomState(1).randn(*q.shape).astype(np.float32)
    jb = jatt.make_attention_bias(jnp.asarray(mask))
    grads = jax.grad(lambda q, k, v: jnp.sum(
        jatt.dot_product_attention(q, k, v, jb) * jnp.asarray(w)),
        argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    bias = _bias(mask)
    out, lse = cat.fused_attention_dropout_fwd(0.0, 0, tq, tk, tv, bias)
    ours = cat.fused_attention_dropout_bwd(0.0, 0, tq, tk, tv, bias,
                                           torch.from_numpy(w).bfloat16(),
                                           out, lse)
    for name, a, b in zip("qkv", ours, grads):
        assert a.dtype == torch.bfloat16
        assert _rel_err(a.float().numpy(), b) < 2e-2, name


def test_dropout_statistics():
    """As test_pallas_kernel_tpu.py:102: inverted dropout keeps E[out], the
    same seed reproduces bit for bit, another seed differs; the dropped
    fraction is the quantised 26/256."""
    q, k, v, mask = _inputs(130, "float32", seed=3)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    tv = torch.from_numpy(np.abs(v))
    bias = _bias(mask)
    base = cat.fused_attention_dropout_reference(0.0, 0, tq, tk, tv, bias)[0]
    outs = [cat.fused_attention_dropout(0.1, s, tq, tk, tv, bias)
            for s in range(8)]
    mean = torch.stack(outs).double().mean(0)
    assert abs(mean.mean() - base.double().mean()) / base.double().mean() < 0.05
    assert (outs[0] - outs[1]).abs().max() > 1e-3
    assert torch.equal(outs[0], cat.fused_attention_dropout(0.1, 0, tq, tk,
                                                            tv, bias))
    B, S, N, _ = q.shape
    t, keep_p = cat.dropout_consts(0.1)
    assert (t, keep_p) == (26, 1 - 26 / 256)
    keep = cat.keep_mask_reference(123, 16, N, S, t, tq)
    assert abs((~keep).double().mean().item() - 26 / 256) < 0.003
    # rows, heads and batch rows draw different masks
    assert not torch.equal(keep[0, 0, 0], keep[0, 0, 1])
    assert not torch.equal(keep[0, 0], keep[0, 1])
    assert not torch.equal(keep[0], keep[1])


def test_keep_mask_matches_the_formula():
    """The int64 tensor hash equals the documented 32-bit formula on plain
    Python ints (the kernels' arithmetic)."""
    def mix32(x):
        x &= 0xFFFFFFFF
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    seed, B, N, S, t = 0xDEADBEEF, 2, 3, 9, 100
    keep = cat.keep_mask_reference(seed, B, N, S, t, torch.zeros(1))
    for b in range(B):
        for n in range(N):
            head = mix32(mix32(seed ^ 0x9E3779B9) ^ (b * N + n))
            for i in range(S):
                row = mix32(head ^ i)
                for j in range(S):
                    byte = (mix32(row ^ (j >> 2)) >> (8 * (j & 3))) & 0xFF
                    assert bool(keep[b, n, i, j]) == (byte >= t)


def test_dropout_fwd_bwd_mask_identity():
    """As test_pallas_kernel_tpu.py:125: the dropped-probability row
    pd[q0, :] read from the forward with one-hot v and from the backward
    as dv of out[q0] has the same zeros and the same values."""
    rs = np.random.RandomState(1)
    B, S, N, H = 1, 130, 2, 16
    q, k = (torch.from_numpy(rs.randn(B, S, N, H).astype(np.float32))
            for _ in range(2))
    rate, seed, q0 = 0.2, 3, 5
    zeros = torch.zeros(B, S, N, H)
    out, lse = cat.fused_attention_dropout_fwd(rate, seed, q, k, zeros)
    g = torch.zeros(B, S, N, H)
    g[0, q0] = 1.0
    dv = cat.fused_attention_dropout_bwd(rate, seed, q, k, zeros, None, g,
                                         out, lse)[2]
    for n in range(N):
        v = torch.zeros(S, B, S, N, H)
        v[torch.arange(S), 0, torch.arange(S), n, 0] = 1.0
        fwd_row = torch.stack([cat.fused_attention_dropout(
            rate, seed, q, k, v[j])[0, q0, n, 0] for j in range(S)])
        bwd_row = dv[0, :, n, 0]
        assert torch.equal(fwd_row == 0, bwd_row == 0)
        assert 0.1 < (fwd_row == 0).double().mean() < 0.35
        np.testing.assert_allclose(fwd_row.numpy(), bwd_row.numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_dropout_rate_to_zero_limit():
    """As test_pallas_kernel_tpu.py:89: a rate that rounds to no dropped
    byte is the no-dropout kernel."""
    q, k, v, mask = _inputs(64, "float32")
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    bias = _bias(mask)
    ref = cuda_attention.fused_attention_reference(tq, tk, tv, bias)
    out = cat.fused_attention_dropout(1e-9, 7, tq, tk, tv, bias)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-6)


def test_gradcheck_float64_with_dropout():
    rs = np.random.RandomState(2)
    B, S, N, H = 1, 6, 2, 4
    q, k, v = (torch.from_numpy(rs.randn(B, S, N, H)).requires_grad_()
               for _ in range(3))
    bias = _bias(np.array([[1, 1, 1, 1, 0, 1]], np.int32)).double()
    assert torch.autograd.gradcheck(
        lambda q, k, v: cat.fused_attention_dropout(0.3, 9, q, k, v, bias),
        (q, k, v), eps=1e-6, atol=1e-6)


def _stub_backward_launchers(monkeypatch, launched=None):
    """The delta, dQ and dK/dV launchers of ops/_launch.py replaced by their
    plain versions, each appending its name to ``launched``."""
    def stub(name, fn):
        def run(*args):
            if launched is not None:
                launched.append(name)
            return fn(*args)
        return run

    monkeypatch.setattr(_launch, "launch_delta",
                        stub("delta", cat.attention_delta))
    monkeypatch.setattr(_launch, "launch_dq", stub("dq", cab.flash_dq_reference))
    monkeypatch.setattr(_launch, "launch_dkv",
                        stub("dkv", cab.flash_dkv_reference))


def test_cuda_attention_gradients_reach_qkv(monkeypatch):
    """The fault of slice 1: on CUDA, fused_attention returned the kernel's
    buffer with no autograd node, so q, k and v got no gradient.  Under
    pretend-CUDA with the launchers routed to their plain versions, a
    forward with grad goes through #2's contract (the forward launcher) and
    #3's (the delta, dQ and dK/dV launchers) at rate 0 and its gradients
    equal the plain path's; without grad it launches #1."""
    q, k, v, mask = _inputs(37, "float32")
    w = torch.from_numpy(np.random.RandomState(4).randn(*q.shape)
                         .astype(np.float32))
    bias = _bias(mask)

    def grads(fn):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        (fn(tq, tk, tv, bias) * w).sum().backward()
        return [t.grad for t in (tq, tk, tv)]

    expect = grads(cuda_attention.fused_attention_reference)
    kernel1 = []
    monkeypatch.setattr(_launch, "launch_fwd", cat.fused_attention_dropout_reference)
    _stub_backward_launchers(monkeypatch)
    monkeypatch.setattr(cuda_attention, "_launch",
                        lambda *a: kernel1.append(1) or
                        cuda_attention.fused_attention_reference(*a))
    before = (cuda_attention.LAUNCHES, cat.FWD_LAUNCHES, cat.BWD_LAUNCHES)
    _pretend_cuda(monkeypatch)
    got = grads(cuda_attention.fused_attention)
    after = (cuda_attention.LAUNCHES, cat.FWD_LAUNCHES, cat.BWD_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [0, 1, 1] and not kernel1
    for name, a, b in zip("qkv", got, expect):
        assert a is not None, f"d{name} missing"
        # two fp32 gradient algorithms (autograd through the online softmax
        # vs the lse-based backward): 1e-4 of max|ref|, as against JAX
        assert _rel_err(a.numpy(), b.numpy()) < 1e-4, name
    with torch.no_grad():
        cuda_attention.fused_attention(*(torch.from_numpy(x)
                                         for x in (q, k, v)), bias)
    assert kernel1 == [1] and cuda_attention.LAUNCHES == before[0] + 1


def test_flash_attention_cpu_dropout_uses_the_training_kernels():
    """On the CPU with dropout, the dispatcher runs #2/#3's plain versions
    (the same mask for the same seed), launching nothing."""
    q, k, v, mask = _inputs(37, "float32")
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    bias = _bias(mask)
    before = (cat.FWD_LAUNCHES, cat.BWD_LAUNCHES)
    out = tatt.flash_attention(tq, tk, tv, bias, dropout_rate=0.1,
                               dropout_seed=11)
    ref = cat.fused_attention_dropout_reference(0.1, 11, tq, tk, tv, bias)[0]
    assert torch.equal(out, ref)
    assert (cat.FWD_LAUNCHES, cat.BWD_LAUNCHES) == before


@pytest.mark.parametrize("S,N", CASES)
def test_cuda_backward_route_matches_the_jax_kernel(S, N, monkeypatch):
    """Kernel #3's contract on "CUDA" (pretend-CUDA tensors) goes through
    the delta, dQ and dK/dV launchers of ops/_launch.py (stubbed with their
    plain versions), counts once in BWD_LAUNCHES and never in the blockwise
    wrappers' DQ_LAUNCHES/DKV_LAUNCHES, and at rate 0 gives the dq, dk and
    dv of the JAX package's ``_fused_attention_dropout_bwd`` (its Pallas
    kernel in interpret mode) on the same out and lse, within 1e-4 of
    max|ref| in fp32."""
    import functools

    from jax.experimental import pallas as pl

    from item_alignment_tpu.ops import pallas_attention as jpa

    q, k, v, mask = _inputs(S, "float32", N=N)
    g = np.random.RandomState(S + 1).randn(*q.shape).astype(np.float32)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    jb = jatt.make_attention_bias(jnp.asarray(mask))
    out, lse = jpa._fused_attention_dropout_impl(0.0, 0, jq, jk, jv, jb)
    expect = jpa._fused_attention_dropout_bwd(0.0, (0, jq, jk, jv, jb, lse, out),
                                              jg)[1:4]

    launched = []
    _stub_backward_launchers(monkeypatch, launched)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tout = torch.from_numpy(np.asarray(out))
    tlse = torch.from_numpy(np.asarray(lse)).double()
    before = (cat.BWD_LAUNCHES, cab.DQ_LAUNCHES, cab.DKV_LAUNCHES)
    _pretend_cuda(monkeypatch)
    got = cat.fused_attention_dropout_bwd(0.0, 0, tq, tk, tv, _bias(mask), tg,
                                          tout, tlse)
    after = (cat.BWD_LAUNCHES, cab.DQ_LAUNCHES, cab.DKV_LAUNCHES)
    assert launched == ["delta", "dq", "dkv"]
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0]
    for name, a, b in zip("qkv", got, expect):
        assert a.dtype == torch.float32
        assert _rel_err(a.numpy(), np.asarray(b)) < 1e-4, name


@pytest.mark.parametrize("S", [130, 255, 510])
def test_cuda_forward_route_matches_the_jax_kernel(S, monkeypatch):
    """Kernel #2's contract on "CUDA" (pretend-CUDA tensors) goes through
    ``_launch.launch_fwd``, the launcher of kernel #4 (stubbed here with
    #4's plain version), and through nothing else; it counts once in
    ``cat.FWD_LAUNCHES`` and never in ``cab.FWD_LAUNCHES``, and at rate 0
    its out and lse are those of the JAX package's
    ``_fused_attention_dropout_impl`` (its Pallas kernel in interpret
    mode): out within 1e-4 of max|ref|, lse within 1e-5 of |lse| + 1, fp32
    module math as in the backward test above."""
    import functools

    from jax.experimental import pallas as pl

    from item_alignment_tpu.ops import pallas_attention as jpa

    q, k, v, mask = _inputs(S, "float32")
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    out, lse = jpa._fused_attention_dropout_impl(
        0.0, 0, *(jnp.asarray(x) for x in (q, k, v)),
        jatt.make_attention_bias(jnp.asarray(mask)))

    launched = []

    def launch_fwd(*args):
        launched.append("launch_fwd")
        return cab.fused_attention_blockwise_reference(*args)

    monkeypatch.setattr(_launch, "launch_fwd", launch_fwd)
    for mod, name in ((_launch, "launch_delta"), (_launch, "launch_dq"),
                      (_launch, "launch_dkv"), (cab, "_launch_fwd"),
                      (cuda_attention, "_launch"),
                      (cat, "fused_attention_dropout_reference")):
        monkeypatch.setattr(mod, name, lambda *a, name=name: pytest.fail(
            f"{name} ran for #2's contract on a CUDA tensor"))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = (cat.FWD_LAUNCHES, cab.FWD_LAUNCHES)
    _pretend_cuda(monkeypatch)
    got, got_lse = cat.fused_attention_dropout_fwd(0.0, 0, tq, tk, tv,
                                                   _bias(mask))
    after = (cat.FWD_LAUNCHES, cab.FWD_LAUNCHES)
    assert launched == ["launch_fwd"]
    assert [a - b for a, b in zip(after, before)] == [1, 0]
    assert got.dtype == torch.float32 and got_lse.dtype == torch.float64
    assert _rel_err(got.numpy(), np.asarray(out)) < 1e-4
    lse = np.asarray(lse, np.float64)
    assert (np.abs(got_lse.numpy() - lse) / (np.abs(lse) + 1.0)).max() < 1e-5
