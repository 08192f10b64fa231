"""The AdamW kernel (``csrc/adamw.cu`` through ``ops/adamw.py``) on the
card against its plain chain: at RoBERTa-large's table over three steps in
each pair of types the port runs, on tensors that are not aligned, through
``Optimizer.step`` with no host synchronisation, and in ``Trainer`` steps
on FSDP2's local shards with accumulation and with clipping.

Marked ``chip``: each test skips without a card (decided in the ``card``
fixture).  The file imports no JAX, so on the card it runs without
``tests/conftest.py``, which sets up JAX's CPU mesh:

    python -m pytest --noconftest -m chip tests/test_torch_adamw_card.py -q
"""

from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from item_alignment_torch.config import ModelConfig, OptimizerConfig
from item_alignment_torch.engine import optim
from item_alignment_torch.models.text import RobertaOneTower
from item_alignment_torch.ops import adamw
from item_alignment_torch.parallel import dryrun

ROOT = Path(__file__).resolve().parents[1]
HYPER = dict(b1=0.9, b2=0.98, eps=1e-8, wd=0.01)

pytestmark = pytest.mark.chip


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def large_shapes():
    """RoBERTa-large's 393 parameters (``large-train-s510``'s table) by
    name, from the model built on the meta device."""
    cfg = ModelConfig.from_json(str(ROOT / "configs" / "roberta_large.json"),
                                max_seq_len=50, max_seq_len_pv=205)
    model = RobertaOneTower(cfg, device="meta", seed=None)
    return {n: p.shape for n, p in model.named_parameters()}


def ulp(t):
    """The unit in the last place of each element of ``t`` in its type
    (bf16: 8 bits of mantissa; fp32: 24)."""
    bits = 8 if t.dtype == torch.bfloat16 else 24
    e = torch.floor(torch.log2(t.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - (bits - 1))


def ulps(got, want):
    """|got - want| in units of the last place of ``want``, elementwise."""
    return (got.float() - want.float()).abs() / ulp(want)


def rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("types", [
    (torch.float32, torch.float32, torch.bfloat16),   # the train cells
    (torch.float32, torch.float32, torch.float32),    # fused=False
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.bfloat16),  # accumulated in fp32
])
def test_kernel_matches_the_plain_chain_at_roberta_large(card, types):
    """Three steps at RoBERTa-large's table with the embeddings frozen, one
    launch a step over all 393 tensors.  Each step against the plain chain
    from the same state: moments within one ulp of their type; parameters
    within two ulps of the larger of their old and new values plus 1e-6 of
    the step's change (the chain divides and rounds the update a few ulps
    apart; where the update nearly cancels the value, the new value's ulp
    is finer than that), far below a step's change.  Over the three steps,
    fp32 parameters within 1e-6 of their largest against the plain chain's
    own trajectory.  Frozen parameters unchanged."""
    p_dt, g_dt, m_dt = types
    shapes = large_shapes()
    names = list(shapes)
    gen = torch.Generator(device=card).manual_seed(7)
    start = [(torch.randn(s, generator=gen, device=card) * 0.02).to(p_dt)
             for s in shapes.values()]

    def state(p):
        return ([t.clone() for t in p],
                [torch.zeros_like(t, dtype=m_dt) for t in p],
                [torch.zeros_like(t, dtype=m_dt) for t in p])

    kernel, plain = state(start), state(start)
    decay = list(optim.decay_mask(names).values())
    trained = ["embeddings" not in n for n in names]
    for step in range(1, 4):
        grads = [(torch.randn(s, generator=gen, device=card)
                  * 10.0 ** (step - 4)).to(g_dt) for s in shapes.values()]
        args = (decay, trained, 1e-3 * step, *HYPER.values(), step)
        old = [t.clone() for t in kernel[0]]
        ref = [[t.clone() for t in ts] for ts in kernel]  # the same state
        launches, tensors = adamw.LAUNCHES, adamw.TENSORS
        adamw.adamw_step(kernel[0], grads, *kernel[1:], *args)
        assert adamw.LAUNCHES - launches == 1
        assert adamw.TENSORS - tensors == len(names) == 393
        adamw.adamw_reference(ref[0], grads, *ref[1:], *args)
        adamw.adamw_reference(plain[0], grads, *plain[1:], *args)
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            new = ref[0][i].float()
            gap = (kernel[0][i].float() - new).abs()
            bound = (2 * torch.maximum(ulp(old[i]), ulp(ref[0][i]))
                     + 1e-6 * (new - old[i].float()).abs())
            assert (gap <= bound).all(), (step, n)
            for j in (1, 2):
                assert ulps(kernel[j][i], ref[j][i]).max() <= 1, (step, n)
        del old, ref
    for i, n in enumerate(names):
        if p_dt == torch.float32:
            assert rel(kernel[0][i], plain[0][i]) <= 1e-6, n
        if not trained[i]:
            assert torch.equal(kernel[0][i], start[i]), n


def test_tensors_that_are_not_aligned(card):
    """Contiguous views at odd offsets (as shards of a flat buffer can be)
    go element by element and agree with the plain chain."""
    sizes = [1, 5, 16383, 16385, 40000, 3]
    gen = torch.Generator(device=card).manual_seed(3)
    flat = {k: torch.randn(sum(sizes) + len(sizes), generator=gen,
                           device=card) for k in ("p", "g")}
    sides = []
    for _ in range(2):
        p = flat["p"].clone()
        m = torch.zeros(sum(sizes) + len(sizes), device=card,
                        dtype=torch.bfloat16)
        v = torch.zeros_like(m)
        views = {k: [] for k in "pgmv"}
        at = 1
        for n in sizes:
            for k, t in zip("pgmv", (p, flat["g"], m, v)):
                views[k].append(t[at:at + n])
            at += n + 1
        sides.append(views)
    for step in (1, 2):
        args = ([True] * len(sizes), [True] * len(sizes), 1e-3,
                *HYPER.values(), step)
        adamw.adamw_step(*(sides[0][k] for k in "pgmv"), *args)
        adamw.adamw_reference(*(sides[1][k] for k in "pgmv"), *args)
    torch.cuda.synchronize()
    for a, b in zip(sides[0]["p"], sides[1]["p"]):
        assert rel(a, b) <= 1e-6
    for k in "mv":
        for a, b in zip(sides[0][k], sides[1][k]):
            assert ulps(a, b).max() <= 1


def test_optimizer_step_never_waits_on_the_device(card):
    """``Optimizer.step`` at RoBERTa-large's table, clipped and accumulated
    over two mini-steps, under ``set_sync_debug_mode("error")``: no call
    synchronises; each update is one launch over every trained tensor."""
    shapes = large_shapes()
    gen = torch.Generator(device=card).manual_seed(11)
    params = {n: torch.nn.Parameter(torch.randn(s, generator=gen, device=card)
                                    * 0.02) for n, s in shapes.items()}
    opt = optim.Optimizer(OptimizerConfig(
        learning_rate=1e-3, total_steps=10, state_dtype="bfloat16",
        max_grad_norm=1.0, grad_accumulation_steps=2,
        freeze_patterns=("classifier",)), params)
    trained = len(opt.trained)
    assert 0 < trained < len(params)
    for _ in range(4):
        for p in params.values():
            p.grad = torch.randn(p.shape, generator=gen, device=card) * 1e-2
        launches, tensors = adamw.LAUNCHES, adamw.TENSORS
        torch.cuda.set_sync_debug_mode("error")
        try:
            updated = opt.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        opt.zero_grad()
        assert adamw.LAUNCHES - launches == (1 if updated else 0)
        assert adamw.TENSORS - tensors == (len(params) if updated else 0)
    torch.cuda.synchronize()
    assert opt.adamw.count == 2


def _steps(card, mesh, steps=4, **opt):
    """``steps`` train steps of the dry run's RobertaOneTower (heads of 32)
    on one batch, on ``mesh`` (None: one device); the trainer, the whole
    parameters on the host and the kernel's launches."""
    cfg = dryrun.text_config(0.1, **dryrun.DRY_WIDTH)
    model = RobertaOneTower(cfg, device=card, seed=0)
    trainer = dryrun._trainer(model, mesh, 8, card, **opt).setup()
    batch = dryrun.text_batch(cfg, 8)
    before = adamw.LAUNCHES
    for _ in range(steps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    return trainer, trainer._host_params(), adamw.LAUNCHES - before


@pytest.mark.parametrize("opt", [dict(grad_accumulation_steps=2),
                                 dict(max_grad_norm=1e-2)])
def test_trainer_steps_on_local_shards(card, monkeypatch, opt):
    """A ``Trainer`` on a one-rank mesh, whose parameters FSDP2 holds as
    DTensors (the optimizer steps their local shards through the kernel),
    against the one-device steps with the plain chain: the dry run's
    tolerance for a sharded step (``tests/test_torch_parallel.py``)."""
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{dryrun.free_port()}",
        world_size=1, rank=0)
    try:
        trainer, sharded, launches = _steps(card, (1, 1, 1), **opt)
        assert all(isinstance(p, DTensor)
                   for p in trainer.optimizer.params.values())
    finally:
        dist.destroy_process_group()
    assert launches == trainer.optimizer.adamw.count > 0
    monkeypatch.setattr(adamw, "launch",
                        lambda *a, table=None: adamw.adamw_reference(*a))
    _, plain, launched = _steps(card, None, **opt)
    assert launched == 0
    for n, want in plain.items():
        torch.testing.assert_close(sharded[n], want, rtol=2e-5, atol=1e-6,
                                   msg=lambda m: f"{n}: {m}")


def test_the_kernel_refuses_mixed_and_strided_tensors(card):
    a, b = torch.zeros(8, device=card), torch.zeros(8)
    args = ([False], [True], 1e-3, *HYPER.values(), 1)
    with pytest.raises(ValueError, match="contiguous tensors"):
        adamw.adamw_step([a], [b], [a.clone()], [a.clone()], *args)
    s = torch.zeros(4, 2, device=card).t()
    with pytest.raises(ValueError, match="contiguous tensors"):
        adamw.adamw_step([s], [s], [s.clone()], [s.clone()], *args)
