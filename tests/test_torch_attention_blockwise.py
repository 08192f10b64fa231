"""The long-sequence attention of the port (kernels #4, #5 and #6) vs the JAX
package, on the CPU.

The port's plain versions ``fused_attention_blockwise_reference`` (#4),
``flash_dq_reference`` (#5) and ``flash_dkv_reference`` (#6) follow their CUDA
kernels; the CPU wrappers run them.  The JAX side is ``dot_product_attention``
and ``jax.grad`` of it, which is what the JAX ``flash_attention`` runs on the
CPU at any length.  With dropout the TPU's random bits cannot be reproduced,
so the dropout tests mirror the JAX package's kernel tests
(``tests/test_pallas_kernel_tpu.py:206-275``): statistics, forward/backward
mask identity and the rate -> 0 limit.
"""

import math

import numpy as np
import pytest
import torch

from item_alignment_torch.ops import _build, _launch
from item_alignment_torch.ops import attention as tatt
from item_alignment_torch.ops import cuda_attention
from item_alignment_torch.ops import cuda_attention_blockwise as cab
from item_alignment_torch.ops import cuda_attention_train as cat

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.ops import attention as jatt  # noqa: E402
from test_torch_attention import _inputs, _pretend_cuda  # noqa: E402
from test_torch_attention_train import _bias, _jax_scores, _rel_err  # noqa: E402

# tiny widths and many small ops: one thread per test process keeps parallel
# test workers from oversubscribing the CPU
torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (S, N): all above the 512 dispatch point; 520 and 576 end in a ragged
# 64-key tile (8 keys, and none: 576 = 9 x 64), 640 = 5 x 128; 12 heads once
CASES = [(520, 2), (576, 12), (640, 2)]
H = 32


def _torch(x, dtype="float32"):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("S,N", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_rate0_matches_jax(S, N, dtype):
    q, k, v, mask = _inputs(S, dtype, N=N, H=H)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    expect = jax.jit(lambda q, k, v, b: jatt.dot_product_attention(
        q, k, v, b, dtype=jd))(*(jnp.asarray(x, jd) for x in (q, k, v)),
                               jatt.make_attention_bias(jnp.asarray(mask)))
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    out, lse = cab.flash_fwd(0.0, 0, tq, tk, tv, _bias(mask))
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
    # the public function is the same forward
    assert torch.equal(cab.fused_attention_blockwise(tq, tk, tv, _bias(mask)),
                       out)


def _jax_grads(q, k, v, mask, w):
    jb = jatt.make_attention_bias(jnp.asarray(mask))
    return jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        jatt.dot_product_attention(q, k, v, jb) * jnp.asarray(w)),
        argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))


def _our_grads(q, k, v, mask, w, dtype):
    tq, tk, tv, tw = (_torch(x, dtype) for x in (q, k, v, w))
    bias = _bias(mask)
    out, lse = cab.flash_fwd(0.0, 0, tq, tk, tv, bias)
    delta = cab.flash_delta(tw, out)
    args = (0.0, 0, tq, tk, tv, bias, tw, lse, delta)
    return (cab.flash_dq(*args), *cab.flash_dkv(*args))


@pytest.mark.parametrize("S,N", CASES)
def test_backward_rate0_matches_jax_grad(S, N):
    """fp32 dq (#5) and dk, dv (#6) within 1e-4 of jax.grad relative to
    max|ref| (the comparison of test_pallas_kernel_tpu.py:164-181)."""
    q, k, v, mask = _inputs(S, "float32", N=N, H=H)
    w = np.random.RandomState(S).randn(*q.shape).astype(np.float32)
    grads = _jax_grads(q, k, v, mask, w)
    for name, a, b in zip("qkv", _our_grads(q, k, v, mask, w, "float32"), grads):
        assert a.dtype == torch.float32
        assert _rel_err(a.numpy(), b) < 1e-4, name


def test_backward_bf16_matches_jax_grad():
    """bf16: keep * p and ds are rounded to bf16 before their products, as
    in the TPU kernels, so the grads agree within 2e-2 of max|ref|."""
    q, k, v, mask = _inputs(520, "bfloat16", N=2, H=H)
    w = np.random.RandomState(1).randn(*q.shape).astype(np.float32)
    grads = _jax_grads(q, k, v, mask, w)
    for name, a, b in zip("qkv", _our_grads(q, k, v, mask, w, "bfloat16"), grads):
        assert a.dtype == torch.bfloat16
        assert _rel_err(a.float().numpy(), b) < 2e-2, name


def test_autograd_function_runs_the_three_kernels_plain_versions():
    """The autograd function's backward equals flash_dq / flash_dkv on the
    saved tensors, with dropout on."""
    q, k, v, mask = _inputs(520, "float32", B=3, N=2, H=H)
    w = _torch(np.random.RandomState(2).randn(*q.shape).astype(np.float32))
    bias = _bias(mask)
    tq, tk, tv = (_torch(x).requires_grad_() for x in (q, k, v))
    out = cab.fused_attention_blockwise_dropout(0.1, 9, tq, tk, tv, bias)
    (out * w).sum().backward()
    with torch.no_grad():
        ref, lse = cab.flash_fwd(0.1, 9, tq, tk, tv, bias)
        args = (0.1, 9, tq, tk, tv, bias, w, lse, cab.flash_delta(w, ref))
        expect = (cab.flash_dq(*args), *cab.flash_dkv(*args))
    assert torch.equal(out, ref)
    for t, e in zip((tq, tk, tv), expect):
        assert torch.equal(t.grad, e)


def test_dropout_statistics():
    """As test_pallas_kernel_tpu.py:206: inverted dropout keeps E[out], the
    same seed reproduces bit for bit, another seed differs."""
    q, k, v, mask = _inputs(520, "float32", N=2, H=H, seed=3)
    tq, tk, tv = _torch(q), _torch(k), _torch(np.abs(v))
    bias = _bias(mask)
    base = cab.fused_attention_blockwise(tq, tk, tv, bias)
    outs = [cab.fused_attention_blockwise_dropout(0.1, s, tq, tk, tv, bias)
            for s in range(6)]
    mean = torch.stack(outs).double().mean(0)
    assert abs(mean.mean() - base.double().mean()) / base.double().mean() < 0.05
    assert (outs[0] - outs[1]).abs().max() > 1e-3
    assert torch.equal(outs[0], cab.fused_attention_blockwise_dropout(
        0.1, 0, tq, tk, tv, bias))


def _keep_bits_read_back(rate, seed, B, S, N):
    """The keep bits [B, N, S, S] as the forward, dK/dV and dQ plain
    versions apply them, read back with q = 0 (uniform probabilities) and
    one-hot operands, H keys or queries per call."""
    z = torch.zeros(B, S, N, H)
    e0 = z.clone()
    e0[..., 0] = 1
    fwd, dkv, dq = (torch.zeros(B, N, S, S, dtype=torch.bool) for _ in range(3))
    out0, lse0 = cab.flash_fwd(rate, seed, z, z, z)
    for c0 in range(0, S, H):
        idx = torch.arange(c0, min(c0 + H, S))
        one_hot = z.clone()
        one_hot[:, idx, :, idx - c0] = 1
        out, _ = cab.flash_fwd(rate, seed, z, z, one_hot)
        fwd[..., idx] = out[..., :len(idx)].permute(0, 2, 1, 3) != 0
        dv = cab.flash_dkv(rate, seed, z, z, z, None, one_hot, lse0,
                           cab.flash_delta(one_hot, out0))[1]
        dkv[:, :, idx, :] = dv[..., :len(idx)].permute(0, 2, 3, 1) != 0
        oute, lsee = cab.flash_fwd(rate, seed, z, one_hot, e0)
        g = cab.flash_dq(rate, seed, z, one_hot, e0, None, e0, lsee,
                         cab.flash_delta(e0, oute))
        dq[..., idx] = g[..., :len(idx)].permute(0, 2, 1, 3) >= 0
    return fwd, dkv, dq


def test_keep_bits_are_the_package_hash():
    """#4, #5 and #6 tile differently and draw the same bits: those of
    keep_mask_reference, which are the bits of kernels #2/#3 (one hash of
    (seed, b, n, i, j), no per-tile reseed)."""
    B, S, N, rate, seed = 1, 520, 2, 0.2, 77
    t, _ = cat.dropout_consts(rate)
    expect = cat.keep_mask_reference(seed, B, N, S, t, torch.zeros(1))
    for what, got in zip(("forward", "dK/dV", "dQ"),
                         _keep_bits_read_back(rate, seed, B, S, N)):
        assert torch.equal(got, expect), what
    assert abs((~expect).double().mean().item() - t / 256) < 0.005
    # at S <= 512 the blockwise and the full-tile plain versions agree bit
    # for bit for one seed: the same keep bits and the same 64-key tiles
    q, k, v, mask = _inputs(130, "float32", N=2, H=H)
    args = (0.1, 5, _torch(q), _torch(k), _torch(v), _bias(mask))
    for a, b in zip(cab.flash_fwd(*args),
                    cat.fused_attention_dropout_fwd(*args)):
        assert torch.equal(a, b)


def test_dropout_fwd_bwd_mask_identity():
    """As test_pallas_kernel_tpu.py:226: the dropped-probability row
    pd[q0, :] read from the forward with one-hot v and from the dK/dV kernel
    as dv of out[q0] has the same zeros and the same values."""
    rs = np.random.RandomState(1)
    B, S, N = 1, 520, 2
    q, k = (_torch(rs.randn(B, S, N, H).astype(np.float32)) for _ in range(2))
    rate, seed, q0 = 0.2, 3, 5
    zeros = torch.zeros(B, S, N, H)
    out, lse = cab.flash_fwd(rate, seed, q, k, zeros)
    g = torch.zeros(B, S, N, H)
    g[0, q0] = 1.0
    dv = cab.flash_dkv(rate, seed, q, k, zeros, None, g, lse,
                       cab.flash_delta(g, out))[1]
    fwd_row = torch.zeros(N, S)
    for c0 in range(0, S, H):
        idx = torch.arange(c0, min(c0 + H, S))
        v = zeros.clone()
        v[:, idx, :, idx - c0] = 1.0
        o = cab.fused_attention_blockwise_dropout(rate, seed, q, k, v)
        fwd_row[:, idx] = o[0, q0, :, :len(idx)]
    bwd_row = dv[0, :, :, 0].T
    assert torch.equal(fwd_row == 0, bwd_row == 0)
    assert 0.1 < (fwd_row == 0).double().mean() < 0.35
    np.testing.assert_allclose(fwd_row.numpy(), bwd_row.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_dropout_rate_to_zero_limit():
    """As test_pallas_kernel_tpu.py:261: a rate that rounds to no dropped
    byte is the no-dropout kernel."""
    q, k, v, mask = _inputs(520, "float32", N=2, H=H)
    tq, tk, tv = (_torch(x) for x in (q, k, v))
    bias = _bias(mask)
    ref = cab.fused_attention_blockwise(tq, tk, tv, bias)
    out = cab.fused_attention_blockwise_dropout(1e-9, 7, tq, tk, tv, bias)
    assert torch.equal(out, ref)


def test_gradcheck_float64_with_dropout():
    rs = np.random.RandomState(2)
    B, S, N, Hd = 1, 6, 2, 4
    q, k, v = (torch.from_numpy(rs.randn(B, S, N, Hd)).requires_grad_()
               for _ in range(3))
    bias = _bias(np.array([[1, 1, 1, 1, 0, 1]], np.int32)).double()
    assert torch.autograd.gradcheck(
        lambda q, k, v: cab.fused_attention_blockwise_dropout(0.3, 9, q, k, v,
                                                              bias),
        (q, k, v), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("S,dropout,expect", [
    (520, False, "blockwise"), (520, True, "blockwise_dropout"),
    (512, False, "fused"), (512, True, "fused_dropout"),
])
def test_dispatcher_splits_at_512(S, dropout, expect, monkeypatch):
    """flash_attention sends S > 512 to the blockwise functions and S <= 512
    to the full-tile ones, with and without dropout (JAX
    ops/attention.py:69-76, :87-93)."""
    calls = []

    def record(name):
        def fn(*args):
            calls.append(name)
            return torch.zeros_like(args[-4])
        return fn

    monkeypatch.setattr(tatt, "fused_attention_blockwise", record("blockwise"))
    monkeypatch.setattr(tatt, "fused_attention_blockwise_dropout",
                        record("blockwise_dropout"))
    monkeypatch.setattr(tatt, "fused_attention", record("fused"))
    monkeypatch.setattr(tatt, "fused_attention_dropout", record("fused_dropout"))
    q = torch.zeros(1, S, 1, 8)
    kw = dict(dropout_rate=0.1, dropout_seed=3) if dropout else {}
    tatt.flash_attention(q, q, q, None, **kw)
    assert calls == [expect]


def test_cuda_tensors_reach_the_blockwise_launches(monkeypatch):
    """A pretend-CUDA tensor at S > 512 reaches the launches of #4, #5 and
    #6 (stubbed here with their plain versions, which the stubs count), each
    counter moves by one, the full-tile kernels are not touched, and the
    gradients equal the CPU path's."""
    q, k, v, mask = _inputs(520, "float32", B=3, N=2, H=H)
    w = _torch(np.random.RandomState(4).randn(*q.shape).astype(np.float32))
    bias = _bias(mask)

    def grads():
        tq, tk, tv = (_torch(x).requires_grad_() for x in (q, k, v))
        # a rate that drops nothing takes the dropout route without the
        # plain versions' mask hash (torch.arange on the pretend device)
        out = tatt.flash_attention(tq, tk, tv, bias, dropout_rate=1e-9,
                                   dropout_seed=5)
        (out * w).sum().backward()
        return [t.grad for t in (tq, tk, tv)]

    expect = grads()
    launched = []

    def stub(name, fn):
        def run(*args):
            launched.append(name)
            return fn(*args)
        return run

    monkeypatch.setattr(cab, "_launch_fwd", stub(
        "fwd", cab.fused_attention_blockwise_reference))
    monkeypatch.setattr(cab, "_launch_delta", stub("delta", cat.attention_delta))
    monkeypatch.setattr(cab, "_launch_dq", stub("dq", cab.flash_dq_reference))
    monkeypatch.setattr(cab, "_launch_dkv", stub("dkv", cab.flash_dkv_reference))
    for mod, name in ((cab, "fused_attention_blockwise_reference"),
                      (cab, "flash_dq_reference"), (cab, "flash_dkv_reference")):
        monkeypatch.setattr(mod, name, lambda *a: pytest.fail(
            "a plain version ran on a CUDA tensor"))
    before = (cab.FWD_LAUNCHES, cab.DQ_LAUNCHES, cab.DKV_LAUNCHES,
              cuda_attention.LAUNCHES, cat.FWD_LAUNCHES, cat.BWD_LAUNCHES)
    _pretend_cuda(monkeypatch)
    got = grads()
    after = (cab.FWD_LAUNCHES, cab.DQ_LAUNCHES, cab.DKV_LAUNCHES,
             cuda_attention.LAUNCHES, cat.FWD_LAUNCHES, cat.BWD_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 0, 0, 0]
    assert launched == ["fwd", "delta", "dq", "dkv"]
    for a, b in zip(got, expect):
        assert torch.equal(a, b)
    # without a gradient the rate-0 function still launches kernel #4
    with torch.no_grad():
        tatt.flash_attention(*(_torch(x) for x in (q, k, v)), bias)
    assert launched[-1] == "fwd" and cab.FWD_LAUNCHES == before[0] + 2


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 520, 2, 32)
    with pytest.raises(TypeError):
        cab.flash_fwd(0.0, 0, q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        cab.flash_fwd(0.0, 0, q, q, q[:, :4])
    lse = torch.zeros(1, 2, 520, dtype=torch.float64)
    with pytest.raises(ValueError, match="lse"):
        cab.flash_dq(0.0, 0, q, q, q, None, q, lse.float(), lse.float())
    with pytest.raises(ValueError, match="delta"):
        cab.flash_dkv(0.0, 0, q, q, q, None, q, lse, lse[:, :1].float())


def test_tma_strides_are_checked_before_any_build(monkeypatch):
    """The bf16 kernels #5 and #6 load their tiles by TMA, which needs a
    positive stride in each dimension of size above 1: a broadcast input
    (stride 0 over the batch) raises before anything is built.  A dimension
    of size 1 may have any stride, and fp32 (no TMA) is not held to it."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built"))
    q = torch.zeros(2, 520, 2, 32, dtype=torch.bfloat16)
    k = q[:1].expand(2, 520, 2, 32)
    lse = torch.zeros(2, 2, 520, dtype=torch.float64)
    _pretend_cuda(monkeypatch)
    for fn in (cab.flash_dq, cab.flash_dkv):
        with pytest.raises(ValueError, match="TMA"):
            fn(0.0, 0, q, k, q, None, q, lse, lse.float())
    one = torch.zeros(520 * 2 * 32, dtype=torch.bfloat16).as_strided(
        (1, 520, 2, 32), (0, 64, 32, 1))
    _launch.check_tma(one, one, one, one)
    wide = q[:1].float().expand(2, 520, 2, 32)
    assert wide.stride(0) == 0
    _launch.check_tma(wide, wide)


@pytest.mark.parametrize("S", [64, 520])
@pytest.mark.parametrize("fn", ["fused_attention_dropout",
                                "fused_attention_blockwise_dropout",
                                "fused_attention_blockwise"])
def test_broadcast_bf16_views_raise_at_the_forward(fn, S, monkeypatch):
    """Every bf16 contract is held to what TMA takes before anything is
    built: a k broadcast over the batch (stride 0) raises a ValueError at
    the forward of #2's contract and of #4's, with and without a gradient,
    and not after the forward's work is spent (the backward has the same
    rule).  The JAX package takes such a view: its arrays have no
    strides."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built"))
    q = torch.zeros(2, S, 2, 32, dtype=torch.bfloat16, requires_grad=True)
    k = q.detach()[:1].expand(2, S, 2, 32)
    assert k.stride(0) == 0
    _pretend_cuda(monkeypatch)
    with pytest.raises(ValueError, match="TMA"):
        if fn == "fused_attention_dropout":
            cat.fused_attention_dropout(0.1, 7, q, k, q)
        elif fn == "fused_attention_blockwise_dropout":
            cab.fused_attention_blockwise_dropout(0.1, 7, q, k, q)
        else:
            with torch.no_grad():
                cab.fused_attention_blockwise(q, k, q)
