"""The port's optimizer vs the JAX package's (``engine/optim.py``) on the
same parameters and gradients, made with numpy; its one-pass in-place step
(``ops/adamw.py``) against the former chain, its planner against the
kernel's walk over the chunks, and its launcher against a CPU stand-in of
the kernel (the kernel itself: ``test_torch_adamw_card.py``)."""

import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from item_alignment_torch.config import ModelConfig as TConfig
from item_alignment_torch.config import OptimizerConfig as TOpt
from item_alignment_torch.convert import flax_from_state_dict, state_dict_from_flax
from item_alignment_torch.engine import optim as topt
from item_alignment_torch.models.text import RobertaOneTower
from item_alignment_torch.ops import adamw as adamw_op

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from item_alignment_tpu.config import OptimizerConfig as JOpt  # noqa: E402
from item_alignment_tpu.engine import optim as jopt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

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


# --------------------------------------------- the one-pass in-place step
# (ops/adamw.py: its plain route on the CPU; the launcher's table on a
# stand-in of the CUDA kernel)

def _former_chain(params, grads, mu, nu, decay, trained, lr, b1, b2, eps,
                  wd, count):
    """``FusedAdamW.update`` and ``Optimizer.step``'s apply as the port
    wrote them before the one-pass step: the updates returned, then added
    to the trained parameters."""
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    names = list(params)
    g32 = [grads[n].float() for n in names]
    m = torch._foreach_mul([mu[n].float() for n in names], b1)
    torch._foreach_add_(m, g32, alpha=1.0 - b1)
    v = torch._foreach_mul([nu[n].float() for n in names], b2)
    torch._foreach_addcmul_(v, g32, g32, value=1.0 - b2)
    denom = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(m, c1)
    torch._foreach_div_(upd, denom)
    out = dict(zip(names, upd))
    if wd and decay:
        torch._foreach_add_([out[n] for n in decay],
                            [params[n].float() for n in decay], alpha=wd)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_copy_([mu[n] for n in names], m)
    torch._foreach_copy_([nu[n] for n in names], v)
    torch._foreach_add_([params[n] for n in trained],
                        [out[n] for n in trained])


def _table(seed, dtype=torch.float32):
    """Parameters of the shapes the planner cares about (a 16384-element
    chunk, one past it, lengths not a multiple of 4, one element) and
    gradients for three steps."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"a/kernel": (64, 256), "b/kernel": (16385,), "c/bias": (7,),
              "d/scale": (1,), "e/embedding": (33, 5)}
    params = {n: torch.randn(s, generator=g).to(dtype) for n, s in
              shapes.items()}
    grads = [{n: (torch.randn(s, generator=g) * 10 ** (k - 1)).to(dtype)
              for n, s in shapes.items()} for k in range(3)]
    return params, grads


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_in_place_step_is_the_former_chain_bit_for_bit(param_dtype,
                                                       state_dtype, wd):
    """``FusedAdamW.step`` on the CPU (the plain route) gives the former
    update-then-apply chain's parameters and moments bit for bit over three
    steps, with two parameters frozen."""
    params, grads = _table(0, param_dtype)
    names = list(params)
    decay = {n: n.endswith(("kernel", "embedding")) for n in names}
    trained = [n for n in names if n not in ("b/kernel", "d/scale")]
    sched = topt.linear_warmup_decay(TOpt(learning_rate=1e-2, total_steps=10,
                                          warmup_proportion=0.1))
    opt = topt.FusedAdamW({n: p.clone() for n, p in params.items()}, sched,
                          0.9, 0.98, 1e-8, wd, decay, state_dtype)
    ref = {n: p.clone() for n, p in params.items()}
    mu = {n: torch.zeros_like(p, dtype=state_dtype) for n, p in ref.items()}
    nu = {n: torch.zeros_like(p, dtype=state_dtype) for n, p in ref.items()}
    for k, g in enumerate(grads):
        opt.step(g, set(trained))
        _former_chain(ref, g, mu, nu, [n for n in names if decay[n]],
                      trained, sched(k), 0.9, 0.98, 1e-8, wd, k + 1)
    for n in names:
        assert torch.equal(opt.params[n], ref[n]), n
        assert opt.mu[n].dtype == state_dtype
        assert torch.equal(opt.mu[n], mu[n]) and torch.equal(opt.nu[n], nu[n])
    assert torch.equal(opt.params["d/scale"], params["d/scale"])


def test_frozen_parameters_keep_their_values_while_their_moments_advance():
    grads = [_tree(s + 1) for s in range(2)]
    kw = dict(learning_rate=1e-2, total_steps=10, weight_decay=0.01,
              state_dtype="bfloat16")
    runs = {}
    for frozen in ((), ("dense",)):
        params = {n: torch.nn.Parameter(t) for n, t in
                  state_dict_from_flax(_tree(0)).items()}
        opt = topt.make_optimizer(TOpt(freeze_patterns=frozen, **kw), params)
        for g in grads:
            for n, t in state_dict_from_flax(g).items():
                params[n].grad = t
            opt.step()
            opt.zero_grad()
        runs[frozen] = (params, opt.adamw)
    start = state_dict_from_flax(_tree(0))
    (moved, free), (kept, held) = runs[()], runs[("dense",)]
    for n in start:
        assert torch.equal(held.mu[n], free.mu[n])
        assert torch.equal(held.nu[n], free.nu[n])
        assert held.mu[n].abs().sum() > 0
        if "dense" in n:
            assert torch.equal(kept[n], start[n])
            assert not torch.equal(moved[n], start[n])
        else:
            assert torch.equal(kept[n], moved[n])


def _meta_table(name):
    """(names, shapes) of a train cell's parameters, from the model built
    on the meta device (no memory)."""
    from item_alignment_torch.models.multimodal import RobertaImageOneTower

    cfg = TConfig.from_json(str(ROOT / "configs" / f"{name}.json"),
                            max_seq_len=50, max_seq_len_pv=205)
    cls = RobertaImageOneTower if "image" in name else RobertaOneTower
    model = cls(cfg, device="meta", seed=None)
    return [(n, p.numel()) for n, p in model.named_parameters()]


def _walk(plan, sizes):
    """Each element's visits when every launch's blocks find their tensor
    and chunk as ``ia_adamw_kernel`` does (a binary search over the
    chunks' running ends), then take their whole vectors of four and the
    ragged tail element by element."""
    seen = [np.zeros(n, np.int32) for n in sizes]
    for _, idx, ends in plan:
        for c in range(ends[-1]):
            lo, hi = 0, len(idx) - 1
            while lo < hi:
                mid = (lo + hi) // 2
                lo, hi = (mid + 1, hi) if ends[mid] <= c else (lo, mid)
            first = (c - (ends[lo - 1] if lo else 0)) * adamw_op.CHUNK
            n = min(adamw_op.CHUNK, sizes[idx[lo]] - first)
            vec = n // 4 * 4
            seen[idx[lo]][first:first + vec] += 1
            seen[idx[lo]][first + vec:first + n] += 1
    return seen


@pytest.mark.parametrize("case", ["roberta_large", "roberta_image_large",
                                  "one", "odd", "many", "mixed"])
def test_the_planner_covers_every_element_once(case):
    """The launches of a step: every element of every tensor visited once;
    at most 4 launches at both train cells' tables (393 and 395 tensors)."""
    if case.startswith("roberta"):
        table = _meta_table(case)
        sizes, keys = [n for _, n in table], [(0, 0, 1)] * len(table)
        assert len(table) == {"roberta_large": 393,
                              "roberta_image_large": 395}[case]
        assert sum(sizes) == {"roberta_large": 325_526_530,
                              "roberta_image_large": 328_673_282}[case]
    else:
        sizes = {"one": [3], "odd": [16383, 16384, 16385, 7, 1, 0, 32770],
                 "many": [5 + i % 9 for i in range(1100)],
                 "mixed": [1024, 4097, 1024, 9]}[case]
        keys = ([(0, 1, 1), (0, 0, 1)] * 2 if case == "mixed"
                else [(0, 0, 0)] * len(sizes))
    plan = adamw_op.plan(keys, sizes)
    if case.startswith("roberta"):
        assert len(plan) <= 4
        assert plan[0][2][-1] == sum(-(-n // adamw_op.CHUNK) for n in sizes)
    if case == "many":
        assert [len(p[1]) for p in plan] == [512, 512, 76]
    if case == "mixed":
        assert [(k, i) for k, i, _ in plan] == [((0, 1, 1), [0, 2]),
                                               ((0, 0, 1), [1, 3])]
    for key, idx, _ in plan:
        assert len(idx) <= adamw_op.MAX_TENSORS
        assert all(keys[i] == key for i in idx)
    if case.startswith("roberta"):  # whole tables: count, not walk
        assert sorted(i for _, idx, _ in plan for i in idx) == list(
            range(len(sizes)))
        return
    for n, seen in zip(sizes, _walk(plan, sizes)):
        assert (seen == 1).all() if n else seen.size == 0


def _stand_in(tensors):
    """``ia_adamw`` on the CPU: reads the launcher's table, checks it as the
    C function does and runs the kernel's update per element on the tensors
    at its pointers (fp32 arithmetic, the scalars as the kernel gets
    them)."""
    import ctypes

    by_ptr = {t.data_ptr(): t for t in tensors}
    calls = []

    def fn(p_dt, g_dt, m_dt, count, ptrs, n, chunk_end, flags, lr, b1, om1,
           b2, om2, c1, c2, eps, wd, stream):
        def arr(addr, ctype, k):
            return np.ctypeslib.as_array((ctype * k).from_address(addr))

        ptrs = arr(ptrs, ctypes.c_uint64, 4 * count).reshape(4, count)
        n = arr(n, ctypes.c_int64, count)
        ends, flags = arr(chunk_end, ctypes.c_int32, count), arr(
            flags, ctypes.c_uint8, count)
        assert 1 <= count <= adamw_op.MAX_TENSORS
        assert (ends == np.cumsum(-(-n // adamw_op.CHUNK))).all()
        f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
        for i in range(count):
            p, g, m, v = (by_ptr[int(a)] for a in ptrs[:, i])
            assert p.numel() == n[i]
            assert [adamw_op.DTYPE_CODE[t.dtype] for t in (p, g, m)] == [
                p_dt, g_dt, m_dt]
            m1 = f(b1) * m.float() + f(om1) * g.float()
            v1 = f(b2) * v.float() + f(om2) * (g.float() * g.float())
            u = (m1 / f(c1)) / (torch.sqrt(v1 / f(c2)) + f(eps))
            if flags[i] & adamw_op.DECAY:
                u = u + f(wd) * p.float()
            if flags[i] & adamw_op.TRAINED:
                p.copy_(p.float() + u * -f(lr))
            m.copy_(m1)
            v.copy_(v1)
        calls.append(count)
        return 0

    return fn, calls


def test_the_launcher_table_on_a_stand_in_of_the_kernel(monkeypatch):
    """``launch`` hands ``ia_adamw`` each group's pointers in (p, g, m, v)
    order, lengths, chunk ends, flags and scalars such that the kernel's
    arithmetic gives the plain route's step (within fp32 rounding of the
    scalars); one launch a type group, counted with its tensors."""
    params, grads = _table(1)
    params["f/kernel"] = torch.randn(40, dtype=torch.bfloat16)
    grads = [dict(g, **{"f/kernel": torch.randn(40, dtype=torch.bfloat16)})
             for g in grads]
    names = list(params)
    decay = [n.endswith("kernel") for n in names]
    trained = [n != "c/bias" for n in names]
    ref = {n: p.clone() for n, p in params.items()}
    mom = {k: {n: torch.zeros_like(p, dtype=torch.bfloat16)
               for n, p in params.items()} for k in ("mu", "nu", "rmu", "rnu")}
    everything = [*params.values(), *mom["mu"].values(),
                  *mom["nu"].values()]
    for g in grads:
        everything += list(g.values())
    fn, calls = _stand_in(everything)
    monkeypatch.setattr(adamw_op, "entry", lambda *a: (None, fn))
    monkeypatch.setattr(adamw_op, "cuda_stream", lambda t: 0)
    monkeypatch.setattr(adamw_op.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    for counter in ("LAUNCHES", "TENSORS"):  # the stand-in's, not kept
        monkeypatch.setattr(adamw_op, counter, getattr(adamw_op, counter))
    before = (adamw_op.LAUNCHES, adamw_op.TENSORS)
    for k, g in enumerate(grads):
        hyper = (1e-3 * (k + 1), 0.9, 0.98, 1e-8, 0.01, k + 1)
        adamw_op.launch(list(params.values()), [g[n] for n in names],
                        list(mom["mu"].values()), list(mom["nu"].values()),
                        decay, trained, *hyper)
        adamw_op.adamw_reference(list(ref.values()), [g[n] for n in names],
                                 list(mom["rmu"].values()),
                                 list(mom["rnu"].values()), decay, trained,
                                 *hyper)
    assert calls == [5, 1] * 3
    assert (adamw_op.LAUNCHES, adamw_op.TENSORS) == (before[0] + 6,
                                                     before[1] + 18)
    for n in names:
        tol = 1e-6 if params[n].dtype == torch.float32 else 8e-3
        torch.testing.assert_close(params[n], ref[n], rtol=tol, atol=tol)
        for a, b in (("mu", "rmu"), ("nu", "rnu")):
            torch.testing.assert_close(mom[a][n].float(), mom[b][n].float(),
                                       rtol=8e-3, atol=1e-30)
    assert torch.equal(params["c/bias"], _table(1)[0]["c/bias"])


def test_a_kept_table_is_rebuilt_only_where_its_key_changes(monkeypatch):
    """With a ``Table`` kept across steps (as ``FusedAdamW`` keeps one) the
    launcher builds it once, then writes each step's gradient pointers
    alone, and the stand-in kernel's steps equal those of a table built
    afresh each step bit for bit; a parameter moved elsewhere or a gradient
    of another type rebuilds it; a strided gradient or one of another
    length raises."""
    params, grads = _table(2)
    names = list(params)
    decay, trained = [True] * len(names), [True] * len(names)
    ref = {n: p.clone() for n, p in params.items()}
    mom = {k: {n: torch.zeros_like(p, dtype=torch.bfloat16)
               for n, p in params.items()} for k in ("mu", "nu", "rmu", "rnu")}
    gen = torch.Generator().manual_seed(3)
    late = {"a": torch.randn(64, 256, generator=gen),
            "ga": torch.randn(64, 256, generator=gen),
            "gb": torch.randn(16385, generator=gen).bfloat16()}
    late["ra"] = late["a"].clone()
    everything = [*params.values(), *ref.values(), *late.values()]
    for k in mom:
        everything += list(mom[k].values())
    for g in grads:
        everything += list(g.values())
    fn, calls = _stand_in(everything)
    monkeypatch.setattr(adamw_op, "entry", lambda *a: (None, fn))
    monkeypatch.setattr(adamw_op, "cuda_stream", lambda t: 0)
    monkeypatch.setattr(adamw_op.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    for counter in ("LAUNCHES", "TENSORS"):  # the stand-in's, not kept
        monkeypatch.setattr(adamw_op, counter, getattr(adamw_op, counter))
    table, built = adamw_op.Table(), []
    build = adamw_op.Table.build
    monkeypatch.setattr(adamw_op.Table, "build", lambda self, *a: (
        built.append(1) if self is table else None, build(self, *a)))

    def step(k, g):
        hyper = (1e-3 * (k + 1), 0.9, 0.98, 1e-8, 0.01, k + 1)
        adamw_op.launch(list(params.values()), [g[n] for n in names],
                        list(mom["mu"].values()), list(mom["nu"].values()),
                        decay, trained, *hyper, table=table)
        adamw_op.launch(list(ref.values()), [g[n] for n in names],
                        list(mom["rmu"].values()), list(mom["rnu"].values()),
                        decay, trained, *hyper)

    for k, g in enumerate(grads):
        step(k, g)
    assert len(built) == 1 and calls == [5] * 6
    params["a/kernel"], ref["a/kernel"] = late["a"], late["ra"]  # moved
    step(3, dict(grads[0], **{"a/kernel": late["ga"]}))
    assert len(built) == 2
    step(4, dict(grads[1], **{"a/kernel": late["ga"],
                              "b/kernel": late["gb"]}))  # another type
    assert len(built) == 3 and calls == [5] * 8 + [4, 1] * 2
    for n in names:
        assert torch.equal(params[n], ref[n]), n
        assert torch.equal(mom["mu"][n], mom["rmu"][n]), n
        assert torch.equal(mom["nu"][n], mom["rnu"][n]), n
    for bad in (late["ga"].t().contiguous().t(), late["ga"][:, :128]):
        with pytest.raises(ValueError, match="contiguous tensors"):
            step(5, dict(grads[2], **{"a/kernel": bad,
                                      "b/kernel": late["gb"]}))
    assert len(built) == 3


def test_the_kernels_checks():
    """Another device raises; the kernel takes contiguous fp32 or bf16
    tensors of one length on one device, and moments of one type."""
    p = [torch.zeros(8)]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        adamw_op.adamw_step([torch.zeros(8, device="meta")], p, p, p, [False],
                            [True], 1e-3, 0.9, 0.98, 1e-8, 0.0, 1)
    bad = [
        (ValueError, "contiguous", ([torch.zeros(4, 2).t()], [torch.zeros(2, 4).t()])),
        (ValueError, "contiguous", ([torch.zeros(8)], [torch.zeros(8, device="meta")])),
        (ValueError, "one length", ([torch.zeros(8)], [torch.zeros(9)])),
        (TypeError, "float32 or bfloat16", ([torch.zeros(8)], [torch.zeros(8, dtype=torch.float16)])),
    ]
    for err, match, (params, grads) in bad:
        with pytest.raises(err, match=match):
            adamw_op._check(params, grads, [torch.zeros_like(params[0])],
                            [torch.zeros_like(params[0])])
    with pytest.raises(TypeError, match="moments differ"):
        adamw_op._check(p, p, [torch.zeros(8)],
                        [torch.zeros(8, dtype=torch.bfloat16)])
    with pytest.raises(ValueError, match="one length"):
        adamw_op._check(p, p, p, [])


def test_no_launch_is_counted_on_the_cpu():
    """The train path on CPU tensors takes the plain route: the kernel's
    counters do not move."""
    before = (adamw_op.LAUNCHES, adamw_op.TENSORS)
    _torch_run(dict(learning_rate=1e-2, total_steps=10, max_grad_norm=1.0,
                    grad_accumulation_steps=2),
               [_tree(s + 1) for s in range(4)])
    assert (adamw_op.LAUNCHES, adamw_op.TENSORS) == before
