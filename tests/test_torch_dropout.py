"""Dropout of the port: replay dropout (mirroring ``tests/test_dropout.py``),
the heads' exact-rate dropout, and remat with dropout on.

JAX's random bits cannot be reproduced in torch, so these check the
properties the train step depends on rather than equal masks.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.models.heads import (
    ClsClassificationHead,
    TwoTowerClassificationHead,
)
from item_alignment_torch.models.text import RobertaOneTower
from item_alignment_torch.ops.dropout import (
    ReplayDropout,
    dropout,
    fold_seed,
    replay_dropout,
)

# tiny shapes and many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

KEEP_P = 1 - 26 / 256  # rate 0.1 on uint8 draws


def test_replay_dropout_mean_preserving():
    x = torch.ones(256, 512)
    y = replay_dropout(0.1, 7, x)
    kept = y > 0
    assert abs(kept.double().mean().item() - KEEP_P) < 0.01
    assert abs(y.double().mean().item() - 1.0) < 0.01
    # kept elements carry exactly the 1/keep_p scale
    np.testing.assert_allclose(y[kept].numpy(), 1 / KEEP_P, rtol=1e-6)


def test_replay_dropout_bwd_regenerates_fwd_mask():
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 128)
                         .astype(np.float32)).requires_grad_()
    y = replay_dropout(0.2, 3, x)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    keep_p = 1 - round(0.2 * 256) / 256
    assert torch.equal(dx != 0, y != 0)
    np.testing.assert_allclose(dx[dx != 0].numpy(), 1 / keep_p, rtol=1e-6)


def test_replay_dropout_rate_zero_identity():
    x = torch.arange(12.0).reshape(3, 4).requires_grad_()
    y = replay_dropout(0.0, 0, x)
    assert torch.equal(y, x)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert torch.equal(dx, torch.ones_like(x))


def test_replay_dropout_dtype_preserved():
    x = torch.ones(8, 128, dtype=torch.bfloat16, requires_grad=True)
    y = replay_dropout(0.1, 1, x)
    assert y.dtype == torch.bfloat16
    (dx,) = torch.autograd.grad(y, x, y.detach())
    assert dx.dtype == torch.bfloat16


def test_module_deterministic_and_training():
    mod = ReplayDropout(0.5)
    x = torch.ones(4, 64)
    assert mod(x) is x  # deterministic by default: no seed needed
    frac = (mod(x, seed=2, deterministic=False) != 0).double().mean().item()
    assert 0.3 < frac < 0.7
    with pytest.raises(ValueError, match="seed"):
        mod(x, deterministic=False)


def test_fold_seed_is_a_pure_function():
    assert fold_seed(5, 3) == fold_seed(5, 3)
    assert len({fold_seed(5, s) for s in range(100)}) == 100
    assert fold_seed(None, 3) is None
    assert 0 <= fold_seed(2 ** 40, 1) < 2 ** 32


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_head_dropout_exact_rate(rate):
    """Repair: the heads' dropout was replay dropout, which quantises 0.1 to
    26/256 and scales survivors by 256/230.  As flax's nn.Dropout, survivors
    are now x / (1 - rate) exactly and the kept fraction is 1 - rate."""
    x = torch.from_numpy(np.random.RandomState(1).rand(400, 256)
                         .astype(np.float32) + 0.5)
    y = dropout(x, rate, 11, deterministic=False)
    kept = y != 0
    assert torch.equal(y[kept], x[kept] / (1.0 - rate))
    assert abs(kept.double().mean().item() - (1 - rate)) < 0.005
    head = TwoTowerClassificationHead(256, dropout_rate=rate)
    hx, hy, _, _ = head(x, x, deterministic=False, dropout_seed=4)
    for out in (hx, hy):
        kept = out != 0
        assert torch.equal(out[kept], x[kept] / (1.0 - rate))
    assert not torch.equal(hx != 0, hy != 0)  # each call site draws its own
    assert dropout(x, rate, None, deterministic=True) is x
    # the ensemble="end" head's image branch: dropout on the concatenated
    # image vectors before dense_img, at the exact rate as well
    cls = ClsClassificationHead(ModelConfig(
        hidden_size=8, image_hidden_size=128, ensemble="end",
        classifier_dropout=rate))
    seen = []
    cls.dense_img.register_forward_hook(lambda m, args, out:
                                        seen.append(args[0]))
    cls(x[:, None, :8], deterministic=False, dropout_seed=4,
        image_embeds=(x[:, :128], x[:, 128:]))
    kept = seen[0] != 0
    assert torch.equal(seen[0][kept], x[kept] / (1.0 - rate))
    assert abs(kept.double().mean().item() - (1 - rate)) < 0.005


def _grads(policy):
    cfg = ModelConfig(hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64,
                      vocab_size=100, max_position_embeddings=64,
                      max_seq_len=4, max_seq_len_pv=4,
                      hidden_dropout_prob=0.1,
                      attention_probs_dropout_prob=0.1,
                      remat=policy is not None,
                      remat_policy=policy or "dots")
    model = RobertaOneTower(cfg, device="cpu", seed=0)
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(1, 100, (4, cfg.pair_seq_len))).long()
    mask = torch.ones_like(ids)
    mask[1, 10:] = 0
    out = model(ids, mask, labels=torch.tensor([0, 1, 1, 0]),
                deterministic=False, dropout_seed=5)
    out.loss.backward()
    return out.loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["full", "dots", "mlp"])
def test_remat_grads_equal_non_remat_with_dropout(policy):
    """Remat replays each layer's forward in the backward.  With dropout on
    (hidden 0.1 and attention 0.1) and one seed, the replay draws the same
    masks, because every mask is a function of (step seed, site), so the
    gradients equal the non-remat ones."""
    loss, expect = _grads(None)
    loss_r, got = _grads(policy)
    assert loss_r == loss
    for name, g in expect.items():
        assert g is not None and got[name] is not None, name
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=name)


def test_dropout_changes_with_the_seed():
    """One seed gives one set of masks; another seed, others; training
    without a seed raises."""
    cfg = ModelConfig(hidden_size=32, num_hidden_layers=1,
                      num_attention_heads=4, intermediate_size=64,
                      vocab_size=100, max_position_embeddings=64,
                      max_seq_len=4, max_seq_len_pv=4)
    model = RobertaOneTower(cfg, device="cpu", seed=0)
    ids = torch.from_numpy(np.random.RandomState(0)
                           .randint(1, 100, (4, cfg.pair_seq_len))).long()
    outs = [model(ids, torch.ones_like(ids), deterministic=False,
                  dropout_seed=s).logits for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="seed"):
        model(ids, torch.ones_like(ids), deterministic=False)
