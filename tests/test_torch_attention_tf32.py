"""The arithmetic that the fp32 kernels are designed to, emulated on the CPU
against the JAX package: the backward kernels of
``csrc/flash_blockwise_bwd.cu`` (``flash_dq_f32``, ``flash_dkv_f32``: #3's
fp32 route, and #5/#6 in fp32) and the forward block of
``csrc/attention_f32.cuh`` (``attn_fwd_f32``: #1 in fp32;
``flash_fwd_f32``: #2's contract and #4 in fp32).  These tests check the
design, not the CUDA code: the kernels themselves are checked on the card
by ``chip_smoke.py`` (phase 2's SASS and spills, phases 3, 6, 11 and 19e
against float64 with a TF32 witness).

The kernels take every product on the tensor cores in TF32 (11 significant
bits), three times over ("3xTF32"): x = big + small with big = x rounded to
TF32 as ``cvt.rna`` rounds and small = the rest rounded again, and a b =
small_a big_b + big_a small_b + big_a big_b.  Here the same rounding runs
in numpy, and each ``mma.sync`` m16n8k8 is a model of the tensor cores'
fp32 accumulation, which truncates: its eight exact products and the
accumulator aligned to the largest of them, the bits below that one's 24th
cut, and the sum cut to fp32 toward zero (``tc_step``).  Every product
keeps one accumulator over its whole contraction (``mma_3xtf32``), except
g v^T, whose 8-deep steps each go into a fresh accumulator added in fp32
to nearest (``mma_3xtf32_rn``), as ds = p (dp - delta) cancels on a
one-hot row.  The five products of the backward are the scores q k^T,
g v^T, ds k, ds^T q and (keep p_r)^T g; the contractions over keys (ds k)
and queries (ds^T q, p_r^T g) take the kernels' order of each group of 8
(``acc_a_split``: the lane's columns 2t, 2t + 1 as logical k = t, t + 4),
and the lane layout of m16n8k8 that order relies on is pinned by
``test_fragments``.

The grads are held against ``jax.grad`` of the JAX package's fp32
attention within 1e-4 of each (batch row, head) slice's max|ref|, on numpy
``randn`` inputs (off the 1/8 grid of the other attention tests, where
every q.k is exact in TF32 too); one TF32 product per fp32 product on the
same inputs exceeds that limit, so these inputs tell the two apart.

The forward (``emulated_forward``) takes its two products, q k^T and p v,
each in place in one accumulator: the tests below hold out against the JAX
package's fp32 attention within 1e-4 of each slice's max|ref| and lse
against a float64 logsumexp within 1e-5, and require the in-place sums to
stay within half of both limits in every case, a one-hot row included
(the rule by which a product may be summed in place; otherwise it would
take ``mma_3xtf32_rn``'s fresh accumulators).
"""

import functools
import math

import numpy as np
import pytest
import torch

from item_alignment_torch.ops import attention as tatt
from item_alignment_torch.ops import cuda_attention_train as cat

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.ops import attention as jatt  # noqa: E402

torch.set_num_threads(1)

GRAD_TOL = 1e-4  # chip_smoke.py's GRAD_TOL[float32], per slice
HEAD_DIMS = (32, 64, 128)
# the fp32 forward block (csrc/attention_f32.cuh): keys a tile, and which
# of its products (scores q k^T, then p v) sum each 8-deep step in a fresh
# accumulator added in fp32 (mma_3xtf32_rn) rather than in place
FWD_LOOP = 32
FWD_FRESH = (False, False)
# logical k of an 8-deep step -> the physical row of its 8-row group that
# the kernels put there: k = t is row 2t, k = t + 4 is row 2t + 1
K_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def tf32(x):
    """fp32 -> TF32 as ``cvt.rna.tf32.f32`` rounds: 0x1000 added to the
    magnitude bits, the low 13 cleared (to nearest, ties away from 0)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    mag = ((bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) \
        & np.uint32(0xFFFFE000)
    return ((bits & np.uint32(0x80000000)) | mag).view(np.float32)


def split(x):
    """(big, small) of ``hopper_common.cuh:split_tf32``."""
    x = np.asarray(x, np.float32)
    big = tf32(x)
    return big, tf32(x - big)


def toward_zero(x):
    """float64 -> fp32, rounded toward zero."""
    f = np.asarray(x, np.float64).astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tc_step(c, prods):
    """One ``mma.sync`` m16n8k8's accumulation, as modelled here: the exact
    products ``prods`` (float64 [..., 8]) and the fp32 accumulator ``c``
    aligned to the largest of them, the bits below its 24th cut, the sum
    cut to fp32 toward zero."""
    terms = np.concatenate([prods, np.asarray(c, np.float64)[..., None]], -1)
    top = np.abs(terms).max(-1, keepdims=True)
    quantum = np.ldexp(1.0, np.frexp(top)[1] - 24)
    return toward_zero((np.trunc(terms / quantum) * quantum).sum(-1))


def matmul(a, b, passes, fresh=False, acc=None):
    """acc + a [..., M, K] @ b [..., K, N] in fp32 from TF32 operands, K a
    multiple of 8, in 8-deep ``tc_step`` steps of ``passes`` products each:
    3 as the kernels take them (small big, big small, big big), 1 as one
    TF32 product.  All steps go into one accumulator (``mma_3xtf32``), or
    with ``fresh`` each into a fresh one added in fp32 to nearest
    (``mma_3xtf32_rn``).  ``acc`` (fp32, default zeros) is the accumulator
    the steps start from."""
    if passes == 1:
        pairs = [(tf32(a), tf32(b))]
    else:
        (ab, as_), (bb, bs) = split(a), split(b)
        pairs = [(as_, bb), (ab, bs), (ab, bb)]
    d = (np.zeros(a.shape[:-1] + b.shape[-1:], np.float32) if acc is None
         else np.asarray(acc, np.float32))
    for k0 in range(0, a.shape[-1], 8):
        acc = np.zeros_like(d) if fresh else d
        for x, y in pairs:
            prods = (x[..., :, None, k0:k0 + 8].astype(np.float64)
                     * np.swapaxes(y[..., k0:k0 + 8, :], -1, -2)
                     [..., None, :, :].astype(np.float64))
            acc = tc_step(acc, prods)
        d = d + acc if fresh else acc
    return d


def contract_in_groups(a, b, passes, fresh=False, acc=None):
    """acc + a [..., M, K] @ b [..., K, N] over K in the kernels' order
    (``matmul``'s ``fresh`` and ``acc``): K padded to whole groups of 8
    with zeros (the zero-filled rows past S) and each group taken in
    ``K_ORDER``."""
    K = a.shape[-1]
    pad = -K % 8
    a = np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), a.dtype)], -1)
    b = np.concatenate([b, np.zeros(b.shape[:-2] + (pad,) + b.shape[-1:],
                                    b.dtype)], -2)
    order = (np.arange(0, K + pad, 8)[:, None] + K_ORDER).reshape(-1)
    return matmul(np.ascontiguousarray(a[..., order]),
                  np.ascontiguousarray(b[..., order, :]), passes, fresh, acc)


def split_lse(lse):
    """``attention_common.cuh:split_lse``: the float64 lse as fp32 hi + lo."""
    hi = lse.astype(np.float32)
    return hi, (lse - hi.astype(np.float64)).astype(np.float32)


def emulated_backward(q, k, v, bias, g, lse, delta, passes):
    """dq, dk, dv of #3's contract at rate 0 by the fp32 kernels' design,
    with ``passes`` TF32 products per fp32 product and the tensor cores'
    accumulation as ``tc_step`` models it; arrays
    [B, S, N, H] (bias [B, S], lse float64 and delta [B, N, S])."""
    scale = np.float32(1.0 / math.sqrt(q.shape[-1]))
    qh, kh, vh, gh = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                      for x in (q, k, v, g))
    s = matmul(qh, kh.transpose(0, 1, 3, 2), passes)
    x = s * scale + bias[:, None, None, :]
    hi, lo = split_lse(lse)
    p = np.exp2(((x - hi[..., None]) - lo[..., None]) * np.float32(math.log2(math.e)))
    dp = matmul(gh, vh.transpose(0, 1, 3, 2), passes, fresh=True)
    ds = (p * (dp - delta[..., None])).astype(np.float32)
    dq = contract_in_groups(ds, kh, passes) * scale
    dk = contract_in_groups(np.ascontiguousarray(ds.transpose(0, 1, 3, 2)),
                            qh, passes) * scale
    dv = contract_in_groups(np.ascontiguousarray(p.transpose(0, 1, 3, 2)),
                            gh, passes)
    return tuple(x.transpose(0, 2, 1, 3) for x in (dq, dk, dv))


def emulated_forward(q, k, v, bias, passes, fresh=FWD_FRESH, loop=FWD_LOOP):
    """out and lse of #1 and of #2's contract at rate 0 by the fp32 forward
    block's design (``csrc/attention_f32.cuh``): key tiles of ``loop``
    rows, zero past S with a key bias of -inf there; per tile the scores
    q k^T by ``matmul`` and x = fmaf(s, scale, bias) in natural units; the
    exact running row max m from -1e30, alpha = exp2((m - m') log2 e), p =
    exp2((x - m') log2 e), l = l alpha + rowsum(p) in fp32, o = o alpha and
    then o += p v contracted in ``K_ORDER`` from o as it stands; out = o /
    max(l, 1e-37) and lse = m + log(max(l, 1e-37)) in float64.  ``fresh``
    (scores, p v): each 8-deep step of that product in a fresh accumulator
    (``mma_3xtf32_rn``), else in place.  Arrays [B, S, N, H], bias [B, S];
    returns out [B, S, N, H] (fp32) and lse [B, N, S] (float64)."""
    B, S, N, H = q.shape
    scale = np.float32(1.0 / math.sqrt(H))
    log2e = np.float32(math.log2(math.e))
    pad = -S % loop
    qh, kh, vh = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                  for x in (q, k, v))
    kh, vh = (np.concatenate([x, np.zeros((B, N, pad, H), np.float32)], 2)
              for x in (kh, vh))
    kb = np.concatenate([bias, np.full((B, pad), -np.inf, np.float32)], 1)
    m = np.full((B, N, S), -1e30, np.float32)
    l = np.zeros((B, N, S), np.float32)
    o = np.zeros((B, N, S, H), np.float32)
    for k0 in range(0, S + pad, loop):
        kt = np.ascontiguousarray(kh[:, :, k0:k0 + loop].swapaxes(-1, -2))
        s = matmul(qh, kt, passes, fresh=fresh[0])
        x = (s.astype(np.float64) * np.float64(scale)
             + kb[:, None, None, k0:k0 + loop]).astype(np.float32)
        m_new = np.maximum(m, x.max(-1))
        alpha = np.exp2((m - m_new) * log2e)
        p = np.exp2((x - m_new[..., None]) * log2e)
        l = l * alpha + p.sum(-1, dtype=np.float32)
        o = contract_in_groups(p, vh[:, :, k0:k0 + loop], passes,
                               fresh=fresh[1], acc=o * alpha[..., None])
        m = m_new
    denom = np.maximum(l, np.float32(1e-37))
    out = o / denom[..., None]
    lse = m.astype(np.float64) + np.log(denom.astype(np.float64))
    return out.transpose(0, 2, 1, 3), lse


def _slice_rel(a, b):
    """The worst max|a - b| / max|b| over the (batch row, head) slices."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max(axis=(1, 3))
    return (err / np.maximum(np.abs(b).max(axis=(1, 3)), 1e-30)).max()


def _case(H, B=2, S=130, N=2, seed=0):
    """numpy randn q, k, v, g (off the 1/8 grid), a ragged mask with a
    fully masked batch row (1); the forward's out and float64 lse from the
    port's plain version, delta, and jax.grad's dq, dk, dv."""
    rs = np.random.RandomState(seed + H)
    q, k, v, g = (rs.randn(B, S, N, H).astype(np.float32) for _ in range(4))
    lens = rs.randint(S // 4, S + 1, size=B)
    lens[1] = 0
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    jb = jatt.make_attention_bias(jnp.asarray(mask))
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        jatt.dot_product_attention(q, k, v, jb) * jnp.asarray(g)),
        argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    bias = tatt.make_attention_bias(torch.from_numpy(mask))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = cat.fused_attention_dropout_fwd(0.0, 0, tq, tk, tv, bias)
    delta = cat.attention_delta(tg, out).numpy()
    args = (q, k, v, bias.reshape(B, S).numpy(), g, lse.numpy(), delta)
    return args, [np.asarray(x) for x in grads]


@pytest.mark.parametrize("H", HEAD_DIMS)
def test_3xtf32_backward_matches_jax_grad(H):
    """3xTF32 products give dq, dk, dv within 1e-4 of each slice's max|ref|
    of jax.grad, the fully masked row included."""
    args, ref = _case(H)
    for name, a, b in zip("qkv", emulated_backward(*args, passes=3), ref):
        assert np.isfinite(a).all()
        assert _slice_rel(a, b) < GRAD_TOL, name


@pytest.mark.parametrize("H", HEAD_DIMS)
def test_one_pass_tf32_exceeds_the_limit(H):
    """One TF32 product per fp32 product on the same inputs reads above the
    limit: the inputs tell an fp32-accurate kernel from a TF32 one."""
    args, ref = _case(H)
    worst = max(_slice_rel(a, b) for a, b in
                zip(emulated_backward(*args, passes=1), ref))
    assert worst > GRAD_TOL


def test_split_is_exact_up_to_22_bits():
    """big + small == x for every x of at most 22 significant bits, and
    big and small are TF32 values (the low 13 bits clear)."""
    rs = np.random.RandomState(0)
    for bits in range(1, 23):
        m = rs.randint(2 ** (bits - 1), 2 ** bits, size=4096)
        x = (m * np.ldexp(1.0, rs.randint(-40, 40, size=m.size) - bits)
             * rs.choice([-1.0, 1.0], size=m.size)).astype(np.float32)
        big, small = split(x)
        for part in (big, small):
            assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
        np.testing.assert_array_equal(big.astype(np.float64)
                                      + small.astype(np.float64),
                                      x.astype(np.float64))


def test_split_error_bound():
    """For any fp32 x, |x - (big + small)| <= 2^-22 |x|; one TF32 rounding
    alone is up to 2^-11 |x| away."""
    x = np.random.RandomState(1).randn(1 << 16).astype(np.float32)
    big, small = split(x)
    err = np.abs(x.astype(np.float64) - big.astype(np.float64)
                 - small.astype(np.float64))
    assert (err <= np.ldexp(np.abs(x.astype(np.float64)), -22)).all()
    one = np.abs(x.astype(np.float64) - tf32(x).astype(np.float64))
    assert (one <= np.ldexp(np.abs(x.astype(np.float64)), -11)).all()
    assert one.max() > np.ldexp(1.0, -16) * np.abs(x).max()


def test_tc_step_truncates():
    """The accumulator model cuts toward zero where fp32 rounds: 1 + 3 *
    2^-25 stays 1 for either sign (fp32's rounded sum is 1 + 2^-23), and a
    sum that fits in 24 bits of its largest term is exact."""
    p = np.zeros(8)
    p[:3] = 2.0 ** -25
    assert np.float32(1) + np.float32(3 * 2.0 ** -25) == np.float32(1 + 2.0 ** -23)
    assert tc_step(np.float32(1), p) == np.float32(1)
    assert tc_step(np.float32(-1), -p) == np.float32(-1)
    assert tc_step(np.float32(0.5), np.arange(1, 9) * 0.25) == np.float32(9.5)


@pytest.mark.parametrize("H", HEAD_DIMS)
def test_fresh_accumulators_for_dp(H):
    """Under the truncating model, g v^T held in one accumulator through
    3 H / 8 mma drifts from the exact sum of its TF32 products more than
    twice as far (largest and rms error) as with each 8-deep step in a
    fresh accumulator added in fp32 (``mma_3xtf32_rn``), which stays no
    further off in rms than the plain version's fp32 product.  On a
    one-hot row ds = p (dp - delta) cancels, so dp's drift is what the
    row's dq and dk are made of."""
    rs = np.random.RandomState(H)
    g, v = (rs.randn(12, 20, H).astype(np.float32) for _ in range(2))
    vt = np.ascontiguousarray(v.swapaxes(-1, -2))
    (gb, gs), (vb, vs) = split(g), split(vt)
    exact = sum(x.astype(np.float64) @ y.astype(np.float64)
                for x, y in ((gs, vb), (gb, vs), (gb, vb)))

    def err(d):
        e = d.astype(np.float64) - exact
        return np.abs(e).max(), np.sqrt((e ** 2).mean())

    in_place, fresh = err(matmul(g, vt, 3)), err(matmul(g, vt, 3, fresh=True))
    plain = err((torch.from_numpy(g) @ torch.from_numpy(vt)).numpy())
    assert in_place[0] > 2 * fresh[0] and in_place[1] > 2 * fresh[1]
    assert fresh[1] <= plain[1]


def _mma(a_frag, b_frag):
    """mma.sync m16n8k8 (row.col) from the 32 lanes' fragments: lane 4g + t
    holds A (16 x 8) as (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) and
    B (8 x 8) as (t, g), (t + 4, g); returns D = A B as the lanes hold it:
    (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)."""
    A, Bm = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_frag[lane]
        Bm[t, g], Bm[t + 4, g] = b_frag[lane]
    D = A @ Bm
    return [(D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1])
            for g, t in (divmod(lane, 4) for lane in range(32))]


def _acc(M):
    """A 16 x 8 tile as the accumulator lanes hold it."""
    return [(M[g, 2 * t], M[g, 2 * t + 1], M[g + 8, 2 * t], M[g + 8, 2 * t + 1])
            for g, t in (divmod(lane, 4) for lane in range(32))]


def test_fragments():
    """The kernels' lane mappings give the intended products.  Scores: A
    from 16 rows of q at (row g, col t) and (g, t + 4) of an 8-wide step
    (``a_split``), B from rows g of k at cols t, t + 4.  ds k: A from the
    accumulator of ds as it stands (``acc_a_split``: c0, c2, c1, c3) and B
    from rows 2t and 2t + 1 of k's 8-row group at col g, with no lane
    exchanging a value."""
    rs = np.random.RandomState(2)
    q, k = rs.randn(16, 8), rs.randn(8, 8)  # 16 queries / 8 keys x 8 dims
    a = [(q[g, t], q[g + 8, t], q[g, t + 4], q[g + 8, t + 4])
         for g, t in (divmod(lane, 4) for lane in range(32))]
    b = [(k[g, t], k[g, t + 4]) for g, t in (divmod(lane, 4) for lane in range(32))]
    np.testing.assert_allclose(_mma(a, b), _acc(q @ k.T), rtol=1e-12)

    ds, kv = rs.randn(16, 8), rs.randn(8, 8)  # 16 rows x 8 keys; 8 keys x 8 dims
    c = _acc(ds)
    a = [(c0, c2, c1, c3) for c0, c1, c2, c3 in c]
    b = [(kv[2 * t, g], kv[2 * t + 1, g])
         for g, t in (divmod(lane, 4) for lane in range(32))]
    np.testing.assert_allclose(_mma(a, b), _acc(ds @ kv), rtol=1e-12)
    # and K_ORDER is that order: logical k -> physical key
    assert [2 * t for t in range(4)] + [2 * t + 1 for t in range(4)] \
        == K_ORDER.tolist()


# the forward's limits: chip_smoke.py's TOL[float32] on out (here per slice)
# and LSE_TOL on lse (absolute on ordinary rows, of |lse| + 1 on the one-hot
# row, whose fp32 scores run to about 100)
OUT_TOL = 1e-4
LSE_TOL = 1e-5
ONE_HOT_ROW = 2  # batch row whose q is scaled by 30: one key takes each row


@functools.lru_cache(maxsize=None)
def _fwd_case(H, one_hot, B=3, S=130, N=2, seed=0):
    """numpy randn q, k, v (off the 1/8 grid), a ragged mask with a fully
    masked batch row (1) and, with ``one_hot``, q of batch row
    ``ONE_HOT_ROW`` scaled by 30; the key bias rows [B, S], the JAX
    package's fp32 out, and the float64 logsumexp of the scores as the
    contract has them (computed in float64, rounded to fp32: there the
    -1e9 mask bias swallows q.k, so the fully masked row is uniform)."""
    rs = np.random.RandomState(seed + H)
    q, k, v = (rs.randn(B, S, N, H).astype(np.float32) for _ in range(3))
    if one_hot:
        q[ONE_HOT_ROW] *= 30.0
    lens = rs.randint(S // 4, S + 1, size=B)
    lens[1] = 0
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    ref = np.asarray(jax.jit(jatt.dot_product_attention)(
        *(jnp.asarray(x) for x in (q, k, v)),
        jatt.make_attention_bias(jnp.asarray(mask))))
    bias = tatt.make_attention_bias(torch.from_numpy(mask)).reshape(B, S).numpy()
    x = (np.einsum("bqnh,bknh->bnqk", q.astype(np.float64), k.astype(np.float64))
         / math.sqrt(H) + bias[:, None, None, :]).astype(np.float32).astype(np.float64)
    top = x.max(-1)
    lse = top + np.log(np.exp(x - top[..., None]).sum(-1))
    return (q, k, v, bias), ref, lse


@functools.lru_cache(maxsize=None)
def _fwd_errs(H, one_hot, passes, fresh=FWD_FRESH):
    """The emulated forward's worst out error per slice (of its max|ref|)
    and worst lse error (absolute; of |lse| + 1 on the one-hot row)."""
    args, ref, ref_lse = _fwd_case(H, one_hot)
    out, lse = emulated_forward(*args, passes=passes, fresh=fresh)
    assert np.isfinite(out).all() and np.isfinite(lse).all()
    d = np.abs(lse - ref_lse)
    if one_hot:
        d[ONE_HOT_ROW] /= np.abs(ref_lse[ONE_HOT_ROW]) + 1.0
    return _slice_rel(out, ref), d.max()


FWD_CASES = [(H, one_hot) for one_hot in (False, True) for H in HEAD_DIMS]


@pytest.mark.parametrize("H,one_hot", FWD_CASES)
def test_3xtf32_forward_matches_jax(H, one_hot):
    """The forward block's design (3xTF32 products summed as ``FWD_FRESH``
    says, 32-key tiles, the online softmax) gives out within 1e-4 of each
    slice's max|ref| of the JAX package's fp32 attention and lse within
    1e-5 of the float64 logsumexp, the fully masked row included."""
    e_out, e_lse = _fwd_errs(H, one_hot, 3)
    assert e_out < OUT_TOL and e_lse < LSE_TOL


@pytest.mark.parametrize("H,one_hot", FWD_CASES)
def test_in_place_forward_sums_keep_half_the_limit(H, one_hot):
    """Both products summed in place in one accumulator (``mma_3xtf32``)
    stay within half of each limit in every case: the margin under which
    the kernel keeps the in-place form (``FWD_FRESH``) rather than a fresh
    accumulator per 8-deep step."""
    assert FWD_FRESH == (False, False)
    e_out, e_lse = _fwd_errs(H, one_hot, 3, (False, False))
    assert e_out < OUT_TOL / 2 and e_lse < LSE_TOL / 2


@pytest.mark.parametrize("H,one_hot", FWD_CASES)
def test_one_pass_tf32_forward_exceeds_the_limits(H, one_hot):
    """One TF32 product per fp32 product reads above both limits on the
    same inputs: they tell an fp32-accurate forward from a TF32 one."""
    e_out, e_lse = _fwd_errs(H, one_hot, 1)
    assert e_out > OUT_TOL and e_lse > LSE_TOL
