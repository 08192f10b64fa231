"""Port attention vs the JAX package's attention on the CPU.

On the CPU the JAX ``flash_attention`` resolves to ``dot_product_attention``
(the Pallas kernel runs only on a TPU), so both are the reference here.  The
port's ``fused_attention_reference`` follows its CUDA kernel step by step
(64-key tiles, online softmax), and ``flash_attention`` on CPU tensors runs
it without launching anything.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.ops import attention as tatt
from item_alignment_torch.ops import (
    cuda_attention,
    cuda_attention_blockwise,
    cuda_attention_train,
)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.ops import attention as jatt  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(S, dtype, B=4, N=4, H=16, seed=0):
    """Ragged key masks, one fully masked row (batch 1) and one large-norm
    row (batch 2, q and k scaled x30).

    q and k lie on a grid of 1/8, so every q.k product and sum is exact in
    fp32 and both sides get the same scores whatever their summation order:
    a x30 row's scores run to thousands, where one rounding of a score moves
    the output by more than the 1e-5 fp32 tolerance."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, S, N, H).astype(np.float32) for _ in range(3))
    q[2] *= 30.0
    k[2] *= 30.0
    q, k = (np.round(x * 8.0) / 8.0 for x in (q, k))
    lens = rs.randint(1, S + 1, size=B)
    lens[1] = 0
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    if dtype == "bfloat16":  # round once so both sides see the same values
        q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                   for x in (q, k, v))
    return q, k, v, mask


def _jax_out(q, k, v, mask, dtype, fn=jatt.flash_attention):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    bias = jatt.make_attention_bias(jnp.asarray(mask))
    out = jax.jit(lambda q, k, v, b: fn(q, k, v, b, dtype=jd))(
        *(jnp.asarray(x, jd) for x in (q, k, v)), bias)
    return np.asarray(out.astype(jnp.float32))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def test_make_attention_bias_matches():
    mask = np.array([[1, 1, 0, 0], [0, 0, 0, 0], [1, 1, 1, 1]], np.int32)
    ours = tatt.make_attention_bias(torch.from_numpy(mask)).numpy()
    theirs = np.asarray(jatt.make_attention_bias(jnp.asarray(mask)))
    assert ours.shape == (3, 1, 1, 4)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("S", [37, 64, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["reference", "flash_attention"])
def test_attention_matches_jax(S, dtype, fn):
    q, k, v, mask = _inputs(S, dtype)
    expect = _jax_out(q, k, v, mask, dtype)
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    bias = tatt.make_attention_bias(torch.from_numpy(mask))
    before = cuda_attention.LAUNCHES
    if fn == "reference":
        out = cuda_attention.fused_attention_reference(tq, tk, tv, bias)
    else:
        out = tatt.flash_attention(tq, tk, tv, bias,
                                   dtype=getattr(torch, dtype))
    assert cuda_attention.LAUNCHES == before  # CPU tensors launch nothing
    assert out.dtype == getattr(torch, dtype)
    got = out.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, expect, rtol=0, atol=TOL[dtype])
    # the fully masked row is the uniform mean of v over all S keys
    np.testing.assert_allclose(got[1], np.broadcast_to(
        v[1].mean(0, keepdims=True), v[1].shape), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_product_attention_matches_jax(dtype):
    q, k, v, mask = _inputs(37, dtype, seed=1)
    expect = _jax_out(q, k, v, mask, dtype, fn=jatt.dot_product_attention)
    out = tatt.dot_product_attention(
        *(_torch(x, dtype) for x in (q, k, v)),
        tatt.make_attention_bias(torch.from_numpy(mask)),
        dtype=getattr(torch, dtype))
    np.testing.assert_allclose(out.float().numpy(), expect, rtol=0,
                               atol=TOL[dtype])


def test_no_bias_matches_jax():
    q, k, v, _ = _inputs(64, "float32", seed=2)
    expect = np.asarray(jatt.dot_product_attention(
        *(jnp.asarray(x) for x in (q, k, v))))
    out = cuda_attention.fused_attention(*(torch.from_numpy(x)
                                           for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), expect, rtol=0, atol=1e-5)


def _pretend_cuda(monkeypatch):
    """Make CPU tensors look like CUDA tensors to the dispatcher."""
    class FakeDevice:
        type = "cuda"

    fake = FakeDevice()
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: fake))


def test_dispatcher_raises_on_cuda_dropout(monkeypatch):
    """CUDA dropout at S <= 512 goes to the training kernels' wrapper and at
    S > 512 to the blockwise kernels' (their launchers stubbed here); a
    launcher that fails raises, nothing falls back to a plain version."""
    calls = []

    def launch(rate, seed, q, k, v, bias):
        calls.append((q.shape[1], rate, seed))
        return torch.full_like(q, 3.0), torch.zeros(q.shape[0], q.shape[2],
                                                    q.shape[1], dtype=torch.float64)

    def broken(*args):
        raise RuntimeError("nvcc not found")

    q, long = torch.zeros(1, 8, 2, 32), torch.zeros(1, 520, 1, 32)
    monkeypatch.setattr(cuda_attention_train, "_launch_fwd", launch)
    monkeypatch.setattr(cuda_attention_blockwise, "_launch_fwd", launch)
    _pretend_cuda(monkeypatch)
    for x in (q, long):
        out = tatt.flash_attention(x, x, x, None, dropout_rate=0.1,
                                   dropout_seed=5)
        assert float(out.max()) == 3.0
    assert calls == [(8, 0.1, 5), (520, 0.1, 5)]
    monkeypatch.setattr(cuda_attention_train, "_launch_fwd", broken)
    monkeypatch.setattr(cuda_attention_blockwise, "_launch_fwd", broken)
    for x in (q, long):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tatt.flash_attention(x, x, x, None, dropout_rate=0.1,
                                 dropout_seed=5)


def test_dispatcher_raises_on_cuda_long_sequence(monkeypatch):
    """S > 512 on CUDA without dropout launches the blockwise forward
    (kernel #4) and not the serving kernel; when its build or launch fails
    the call raises (the JAX dispatcher would fall back to the plain
    path)."""
    q = torch.zeros(1, 520, 1, 32)
    launched = []
    monkeypatch.setattr(
        cuda_attention_blockwise, "_launch_fwd",
        lambda rate, seed, q, k, v, bias: launched.append(rate) or (
            torch.ones_like(q), torch.zeros(1, 1, 520, dtype=torch.float64)))
    monkeypatch.setattr(cuda_attention, "_launch", lambda *a: pytest.fail(
        "the serving kernel took S > 512"))
    _pretend_cuda(monkeypatch)
    before = cuda_attention_blockwise.FWD_LAUNCHES
    with torch.no_grad():
        assert float(tatt.flash_attention(q, q, q, None).min()) == 1.0
    assert launched == [0.0]
    assert cuda_attention_blockwise.FWD_LAUNCHES == before + 1

    def broken(*args):
        raise RuntimeError("ptxas: too much shared memory")

    monkeypatch.setattr(cuda_attention_blockwise, "_launch_fwd", broken)
    with pytest.raises(RuntimeError, match="shared memory"):
        tatt.flash_attention(q, q, q, None)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(TypeError):
        cuda_attention.fused_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        cuda_attention.fused_attention(q, q, q[:, :4])
    with pytest.raises(ValueError):
        cuda_attention.fused_attention(q, q, q, torch.zeros(1, 1, 1, 9))
