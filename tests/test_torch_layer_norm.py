"""``ops/layer_norm.py`` on the CPU: the plain forward is Flax's LayerNorm
formula bit for bit, the plain analytic backward (what the CUDA kernels
compute) matches autograd through it, on a constant row whose variance
rounds below 0 too, and the autograd function that runs the kernels on the card is wired right
(its launches replaced by the plain versions)."""

import pytest
import torch

from item_alignment_torch.models.layers import LayerNorm
from item_alignment_torch.ops import layer_norm as ln

EPS = 1e-5


def _formula(x, weight, bias, eps, dtype):
    """``LayerNorm.forward``'s arithmetic as the port first wrote it."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + eps) * weight
    y = (xf - mean) * mul
    if bias is not None:
        y = y + bias
    return y.to(dtype or torch.promote_types(x.dtype, torch.float32))


def _inputs(rows, H, seed=0, dtype=torch.float32):
    """x (randn x 2 + 0.5, row 1 the constant 0.1), weight, bias, dy."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, H, generator=g) * 2 + 0.5
    x[1] = 0.1
    w = 1 + 0.1 * torch.randn(H, generator=g)
    b = 0.1 * torch.randn(H, generator=g)
    return x.to(dtype), w, b, torch.randn(rows, H, generator=g)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("use_bias", [True, False])
def test_plain_path_is_the_formula_bit_for_bit(x_dtype, dtype, use_bias):
    x, _, _, _ = _inputs(6, 48, dtype=x_dtype)
    x = x.reshape(2, 3, 48)
    module = LayerNorm(48, EPS, dtype, use_bias=use_bias)
    with torch.no_grad():
        module.weight.normal_(1.0, 0.1)
        if use_bias:
            module.bias.normal_(0.0, 0.1)
    want = _formula(x, module.weight, module.bias, EPS, dtype)
    got = module(x)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    assert torch.equal(ln.layer_norm(x, module.weight, module.bias, EPS,
                                     dtype), want)


def _clamped_row(H, seed):
    """A constant row of width H whose variance, as ``layer_norm_stats``
    computes it, rounds below 0; None if none of 200 constants does.  The
    search runs here because where the rounding falls depends on the host's
    reduction order."""
    g = torch.Generator().manual_seed(seed)
    for c in (0.1 + 3 * torch.rand(200, generator=g)).tolist():
        row = torch.full((1, H), c)
        if ln.layer_norm_stats(row)[1][0] < 0:
            return row
    return None


@pytest.mark.parametrize("H", [32, 768, 1024, 3072])
def test_analytic_backward_matches_autograd(H):
    rows = 37
    x, w, b, dy = _inputs(rows, H, seed=H)
    row = _clamped_row(H, seed=H)
    if row is not None:  # else row 1 stays the constant 0.1
        x[1] = row
    mean, var = ln.layer_norm_stats(x)
    assert row is None or var[1] < 0
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    ln.layer_norm_reference(*leaves, EPS).backward(dy)
    dx, dw, db = ln.layer_norm_bwd_reference(x, w, mean, var, dy, EPS)
    for got, leaf in zip((dx, dw, db), leaves):
        assert got.dtype == torch.float32
        assert _rel(got, leaf.grad) <= 1e-5


@pytest.mark.parametrize("rows", [1, 7, 511, 512, 513, 600, 20400, 1 << 20])
def test_backward_blocks_cover_the_rows(rows):
    per, blocks = ln.bwd_blocks(rows)
    assert 1 <= blocks <= ln.BWD_BLOCKS
    assert (blocks - 1) * per < rows <= blocks * per


@pytest.mark.parametrize("x_dtype,dtype", [
    (torch.float32, None), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, None)])
@pytest.mark.parametrize("use_bias", [True, False])
def test_autograd_function_on_the_plain_launches(monkeypatch, x_dtype, dtype,
                                                 use_bias):
    """``_LayerNorm`` with its launches replaced by the plain versions gives
    autograd's gradients through the plain forward, and counts nothing."""
    def fwd(x, weight, bias, eps, dt, stats):
        y = ln.layer_norm_reference(x, weight, bias, eps, dt)
        return (y, *ln.layer_norm_stats(x)) if stats else (y, None, None)

    monkeypatch.setattr(ln, "launch_fwd", fwd)
    monkeypatch.setattr(ln, "launch_bwd", ln.layer_norm_bwd_reference)
    launches = (ln.FWD_LAUNCHES, ln.BWD_LAUNCHES)
    x, w, b, dy = _inputs(20, 96, seed=5, dtype=x_dtype)
    b = b if use_bias else None
    out = ln.out_dtype(x, dtype)
    grads = []
    for apply in (lambda *t: ln._LayerNorm.apply(*t, EPS, out),
                  lambda *t: ln.layer_norm_reference(*t, EPS, dtype)):
        leaves = [None if t is None else t.clone().requires_grad_()
                  for t in (x, w, b)]
        y = apply(*leaves)
        assert y.dtype == out
        y.backward(dy.to(out))
        grads.append([None if t is None else t.grad for t in leaves])
    for got, want in zip(*grads):
        if want is None:
            assert got is None
            continue
        assert got.dtype == want.dtype
        assert _rel(got.float(), want.float()) <= (
            1e-5 if got.dtype == torch.float32 else 1e-2)
    assert (ln.FWD_LAUNCHES, ln.BWD_LAUNCHES) == launches


def test_the_kernels_checks():
    """Another device raises; the kernels take fp32 and bf16 in and out,
    widths up to ``MAX_WIDTH`` and contiguous fp32 parameters of x's
    width."""
    w = torch.ones(8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ln.layer_norm(torch.zeros(2, 8, device="meta"), w, None, EPS)
    x = torch.zeros(2, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ln._check(x.half(), w, None, torch.float16)
    wide = torch.ones(ln.MAX_WIDTH + 1)
    with pytest.raises(ValueError, match="widths 1 to 8192"):
        ln._check(torch.zeros(2, ln.MAX_WIDTH + 1), wide, None,
                  torch.float32)
    for bad in (w.bfloat16(), torch.ones(9), torch.ones(16)[::2]):
        with pytest.raises(ValueError, match=r"float32 \[8\] parameters"):
            ln._check(x, w, bad, torch.float32)
    ln._check(x.bfloat16(), w, w, torch.float32)
