"""The port's adversarial embedding noise vs the JAX package's, on the CPU.

``engine/adversarial.py``'s updates take the same deltas, gradients and
draws as JAX's: FREE needs no draw; PGD's restarts and MIX's ``u`` are
drawn here from JAX's threefry keys, as ``update_deltas`` splits them, and
given to the port.  Through the trainers, three FREE steps of a tiny
12-head ``BertAlignModel`` (dropout 0) agree with the JAX ``Trainer``'s
within 1e-5, deltas included, and an adversarial run killed and resumed
equals the uninterrupted one bit for bit.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.config import OptimizerConfig as TOpt
from item_alignment_torch.config import TrainConfig as TTrain
from item_alignment_torch.convert import state_dict_from_flax
from item_alignment_torch.data.bert_data import align_kwargs
from item_alignment_torch.data.datasets import ArrayDataset as TDataset
from item_alignment_torch.engine import adversarial as tadv
from item_alignment_torch.engine.train import Trainer as TTrainer
from item_alignment_torch.models import bert_legacy as tbl

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import OptimizerConfig as JOpt  # noqa: E402
from item_alignment_tpu.config import TrainConfig as JTrain  # noqa: E402
from item_alignment_tpu.data.datasets import ArrayDataset as JDataset  # noqa: E402
from item_alignment_tpu.engine import adversarial as jadv  # noqa: E402
from item_alignment_tpu.engine.train import Trainer as JTrainer  # noqa: E402
from item_alignment_tpu.models import bert_legacy as jbl  # noqa: E402
from test_torch_bert_legacy import (  # noqa: E402
    LENS,
    _configs,
    _jf,
    _port,
    make_fields,
)

torch.set_num_threads(1)
EPS, ALPHA = 0.02, 0.01
NAMES = ("pvs_noise", "title_noise")  # JAX's tree order (sorted keys)


@pytest.fixture(scope="module", autouse=True)
def _keep_torch_rng():
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


def _deltas_and_grads(seed=0, B=2, H=8):
    rs = np.random.RandomState(seed)
    deltas = {n: np.clip(rs.randn(B, L, H).astype(np.float32) * EPS, -EPS,
                         EPS) for n, L in zip(NAMES, (6, 4))}
    grads = {n: rs.randn(*d.shape).astype(np.float32) for n, d in
             deltas.items()}
    grads["title_noise"][0, 0, :3] = 0.0  # sign(0) = 0 on both sides
    return deltas, grads


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _same(ours, theirs):
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]),
                                      err_msg=k)


def _jax_draws(mode, rng, deltas):
    """The draws JAX's ``update_deltas`` makes from ``rng``: each leaf's
    PGD restart (for MIX from the second half of its key) and MIX's u."""
    keys = jax.random.split(rng, len(deltas) + 1)
    restarts = {}
    for k, name in zip(keys[:-1], NAMES):
        if mode == "MIX":
            k = jax.random.split(k)[1]
        restarts[name] = torch.from_numpy(np.array(jax.random.uniform(
            k, deltas[name].shape, minval=-EPS, maxval=EPS)))
    return restarts, float(jax.random.uniform(keys[-1]))


def test_free_update_matches_jax():
    deltas, grads = _deltas_and_grads()
    ours = tadv.update_deltas("FREE", _t(deltas), _t(grads), EPS, ALPHA)
    theirs = jadv.update_deltas("FREE", jax.random.PRNGKey(0),
                                jax.tree_util.tree_map(jnp.asarray, deltas),
                                jax.tree_util.tree_map(jnp.asarray, grads),
                                EPS, ALPHA)
    _same(ours, theirs)
    assert ours["title_noise"][0, 0, :3].tolist() == \
        deltas["title_noise"][0, 0, :3].tolist()


@pytest.mark.parametrize("key", [0, 1])
def test_pgd_update_matches_jax_on_the_same_draws(key):
    deltas, grads = _deltas_and_grads(seed=key)
    rng = jax.random.PRNGKey(key)
    restarts, _ = _jax_draws("PGD", rng, deltas)
    ours = tadv.update_deltas("PGD", _t(deltas), _t(grads), EPS, ALPHA,
                              restarts=restarts)
    theirs = jadv.update_deltas("PGD", rng,
                                jax.tree_util.tree_map(jnp.asarray, deltas),
                                jax.tree_util.tree_map(jnp.asarray, grads),
                                EPS, ALPHA)
    _same(ours, theirs)


@pytest.mark.parametrize("key", range(10))
def test_mix_update_matches_jax_on_the_same_draws(key):
    """One u for all deltas picks FREE, PGD or off; keys 0-9 reach all
    three branches."""
    deltas, grads = _deltas_and_grads(seed=key)
    rng = jax.random.PRNGKey(key)
    restarts, u = _jax_draws("MIX", rng, deltas)
    ours = tadv.update_deltas("MIX", _t(deltas), _t(grads), EPS, ALPHA,
                              u=u, restarts=restarts)
    theirs = jadv.update_deltas("MIX", rng,
                                jax.tree_util.tree_map(jnp.asarray, deltas),
                                jax.tree_util.tree_map(jnp.asarray, grads),
                                EPS, ALPHA)
    _same(ours, theirs)


def test_mix_branches_reached_by_the_keys_above():
    us = [_jax_draws("MIX", jax.random.PRNGKey(k), _deltas_and_grads(k)[0])[1]
          for k in range(10)]
    assert min(us) < tadv.P_FREE
    assert any(tadv.P_FREE <= u < tadv.P_PGD for u in us)
    assert max(us) >= tadv.P_PGD


@pytest.mark.parametrize("u", [0.1, 0.3, 0.7])
def test_mix_update_branches_and_the_off_branch_zeroes(u):
    """u < 0.15 is FREE, u < 0.45 PGD; otherwise every stored delta becomes
    zero, as JAX's code does (``* active``), whatever its docstring says.
    The single-delta ``mix_update`` equals JAX's for the same u and
    restart."""
    deltas, grads = _deltas_and_grads(seed=3)
    d, g = deltas["pvs_noise"], grads["pvs_noise"]
    restart = torch.full(d.shape, 0.005)
    new, active = tadv.mix_update(torch.from_numpy(d), torch.from_numpy(g),
                                  EPS, ALPHA, u, restart=restart)
    assert active == float(u < 0.45)
    if u < 0.15:
        want = tadv.free_update(torch.from_numpy(d), torch.from_numpy(g), EPS)
    elif u < 0.45:
        want = torch.clamp(restart + ALPHA * torch.sign(torch.from_numpy(g)),
                           -EPS, EPS)
    else:
        want = torch.from_numpy(d)
    assert torch.equal(new, want)
    if u >= 0.45:  # JAX's mix_update keeps it; its update_deltas zeroes it
        j_new, j_active = jadv.mix_update(jax.random.PRNGKey(0), d, g, EPS,
                                          ALPHA, u=jnp.float32(u))
        np.testing.assert_array_equal(np.asarray(j_new), d)
        assert float(j_active) == 0.0
    out = tadv.update_deltas("MIX", _t(deltas), _t(grads), EPS, ALPHA, u=u,
                             restarts={k: restart[:, :v.shape[1]]
                                       for k, v in deltas.items()})
    assert bool((out["pvs_noise"] == 0).all()) == (u >= 0.45)


def test_update_deltas_draws_are_a_function_of_the_seed():
    deltas, grads = _deltas_and_grads(seed=4)
    for mode in ("PGD", "MIX"):
        a = tadv.update_deltas(mode, _t(deltas), _t(grads), EPS, ALPHA,
                               seed=11)
        b = tadv.update_deltas(mode, _t(deltas), _t(grads), EPS, ALPHA,
                               seed=11)
        c = tadv.update_deltas(mode, _t(deltas), _t(grads), EPS, ALPHA,
                               seed=12)
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert mode == "MIX" or not all(torch.equal(a[k], c[k]) for k in a)
    with pytest.raises(ValueError, match="unknown adversarial mode"):
        tadv.update_deltas("FGSM", _t(deltas), _t(grads), EPS, ALPHA)
    with pytest.raises(ValueError, match="MIX needs"):
        tadv.update_deltas("MIX", _t(deltas), _t(grads), EPS, ALPHA)


def _field_rows(n, seed):
    fields = make_fields(n, seed=seed)
    rows = {f"{k}_{kk}": v for k, f in fields.items() for kk, v in f.items()}
    rows["labels"] = np.random.RandomState(seed).randint(0, 2, n).astype(
        np.int32)
    return rows


def test_free_trainer_matches_jax_trainer_for_3_steps():
    """Three FREE steps at dropout 0, batch 8, through the port's Trainer
    and the JAX Trainer (8 CPU devices): losses, parameters (but the key
    biases, see below) and the stored deltas within 1e-5."""
    jcfg, tcfg = _configs()
    B = 8
    parts = [_field_rows(B, seed) for seed in (10, 11, 12)]
    jmodel = jbl.BertAlignModel(jcfg)
    params, model = _port(tbl.BertAlignModel, jmodel, tcfg,
                          _jf(make_fields(B, seed=10)))
    H = tcfg.hidden_size
    spec = {"pvs_noise": (LENS["pvs"], H), "title_noise": (LENS["title"], H)}
    adv = ("FREE", EPS, ALPHA)
    opt = dict(learning_rate=1e-3, total_steps=10, warmup_proportion=0.1)
    common = dict(seed=3, train_batch_size=B, eval_batch_size=B,
                  log_steps=1000, scan_steps=1)
    jt = JTrainer(jmodel, JTrain(optimizer=JOpt(**opt), **common),
                  params=params["params"], batch_transform=align_kwargs,
                  adversarial=adv, noise_spec=spec)
    tt = TTrainer(model.train(), TTrain(optimizer=TOpt(**opt), **common),
                  device="cpu", batch_transform=align_kwargs, adversarial=adv,
                  noise_spec=spec)
    for epoch, rows in enumerate(parts):
        jl = jt.train_epoch(JDataset(rows), epoch)["loss"]
        tl = tt.train_epoch(TDataset(rows), epoch)["loss"]
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5,
                                   err_msg=f"step {epoch}")
    ours = model.state_dict()
    theirs = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jt.state.params}))
    assert ours.keys() == theirs.keys()
    for name, p in ours.items():
        if name.endswith("attention.key.bias"):
            # zero gradient in exact arithmetic (softmax ignores a shift
            # shared by all keys): both sides move it by fp32 noise that
            # Adam scales up, so each stays within the steps' learning rate
            for x in (p.numpy(), theirs[name].numpy()):
                assert np.abs(x).max() <= 3 * opt["learning_rate"], name
            continue
        np.testing.assert_allclose(p.numpy(), theirs[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    for name, d in tt.deltas.items():
        jd = np.asarray(jt.state.deltas[name])
        np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-5,
                                   err_msg=name)
        assert np.abs(jd).max() == pytest.approx(EPS)


def _adv_trainer(ckpt_dir=None, epochs=4, resume=False, mode="MIX"):
    _, tcfg = _configs(hidden_dropout_prob=0.1,
                       attention_probs_dropout_prob=0.1)
    model = tbl.BertAlignModel(tcfg, device="cpu", seed=0)
    H = tcfg.hidden_size
    train = TTrain(seed=5, train_batch_size=4, eval_batch_size=4,
                   num_epochs=epochs, log_steps=100, checkpoint_dir=ckpt_dir,
                   resume=resume,
                   optimizer=TOpt(learning_rate=2e-3, total_steps=16,
                                  warmup_proportion=0.1))
    return TTrainer(model, train, device="cpu", batch_transform=align_kwargs,
                    adversarial=(mode, EPS, ALPHA),
                    noise_spec={"pvs_noise": (LENS["pvs"], H),
                                "title_noise": (LENS["title"], H)})


@pytest.mark.parametrize("mode", ["MIX", "PGD"])
def test_adversarial_kill_and_resume_equals_the_uninterrupted_run(tmp_path,
                                                                  mode):
    """4 epochs of 2 steps with dropout 0.1 and noise against 2 epochs,
    a checkpoint, and a new Trainer that resumes: losses, parameters,
    optimizer moments and the deltas equal bit for bit."""
    ds = TDataset(_field_rows(8, seed=20))
    full = _adv_trainer(mode=mode)
    hist_full = full.fit(ds)["history"]
    a = _adv_trainer(str(tmp_path), epochs=2, mode=mode)
    hist_a = a.fit(ds)["history"]
    del a
    b = _adv_trainer(str(tmp_path), resume=True, mode=mode)
    hist_b = b.fit(ds)["history"]
    assert [h["loss"] for h in hist_a + hist_b] == \
        [h["loss"] for h in hist_full]
    for (name, x), y in zip(full.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(x, y), name
    sa, sb = full.optimizer.state_dict(), b.optimizer.state_dict()
    for kind in ("mu", "nu"):
        for name, m in sa[kind].items():
            assert torch.equal(m, sb[kind][name]), (kind, name)
    assert full.deltas.keys() == b.deltas.keys()
    for name, d in full.deltas.items():
        assert torch.equal(d, b.deltas[name]), name
    if mode == "PGD":  # MIX's last draw may have turned the noise off
        assert all(d.abs().max() > 0 for d in full.deltas.values())


def test_trainer_refuses_adversarial_without_a_noise_spec():
    _, tcfg = _configs()
    model = tbl.BertAlignModel(tcfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="noise_spec"):
        TTrainer(model, TTrain(), device="cpu", adversarial=("FREE", 1.0, 1.0))
    with pytest.raises(ValueError, match="unknown adversarial mode"):
        TTrainer(model, TTrain(), device="cpu", adversarial=("free", 1.0, 1.0),
                 noise_spec={"pvs_noise": (4, 96)})
