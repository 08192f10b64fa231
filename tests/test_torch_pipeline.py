"""The port's reproduction pipeline (``item_alignment_torch/pipeline``)
against the JAX package's ``scripts/``.

(a) ``train.sh`` and ``predict.sh`` issue the JAX scripts' commands, line
for line, under ``IA="echo IA-CMD"``, but for the parameter files they
name (the port's ``.pt`` for the JAX CLI's ``.msgpack``); p8 packages
through the port's ``aggregate.submit``.  ``START_AT``, ``STOP_AFTER`` and
the default start behave as they do on the JAX scripts.
(b) ``synth_corpus`` writes the bytes of ``scripts/make_synth_corpus.py`` at
one seed and size; its NFNet checkpoint has timm's names and shapes and
converts back exactly.
(c) The whole pipeline on the CPU, at tiny widths under the configs' file
names: every step of ``train.sh`` and ``predict.sh`` returns 0 and
``result.zip`` validates; the JAX ``ensemble`` and packaging of the port's
member files give the same bytes.

(c) runs each ``ia-torch`` command through ``chip_smoke.py``'s command
server, as the smoke's phase 24 does on the card: a child forked from one
process that imported the port once (a fresh interpreter a command would
pay torch's import 24 times over).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
import zipfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "item_alignment_torch" / "pipeline"
SCRIPTS = REPO / "scripts"
# the only differences of the port's command lines from the JAX scripts'
SUBSTITUTIONS = (("best_f1.msgpack", "best_f1.pt"),
                 ("bert_align.msgpack", "bert_align.pt"))
KNOBS = ("IA", "DATA_DIR", "OUT", "VOCAB", "PRETRAINED", "CONFIGS", "EPOCHS",
         "KGE_EPOCHS", "BERT_EPOCHS", "IMG_SIZE", "IMG_EMB_SIZE", "START_AT",
         "STOP_AFTER", "RESUME", "BOXES_FILE", "TIMM_NFNET", "EXTRA_FLAGS")
TRAIN_STEPS = ("0-prepare", "1-pkgm-pretrain", "2-roberta-flagship",
               "3-roberta-cls-layers", "4-pkgm-finetune", "5-textcnn",
               "6a-image-prep", "6b-roberta-image", "7-nfnet",
               "8-bert-legacy", "9-gcn", "done")
PREDICT_STEPS = ("p0-roberta-flagship", "p1-roberta-cls-layers", "p2-pkgm",
                 "p3-textcnn", "p4-roberta-image", "p5-nfnet", "p6-bert",
                 "p7-ensemble", "p8-package")
MARK = re.compile(r"^=== \[(train|predict)\.sh\] step (\S+) @ \d+ ===$")
# the ia-torch commands whose parser has no --device flag
NO_DEVICE = ("ensemble", "build-graph")
CORPUS = dict(n_items=200, n_train_pairs=100, n_valid_pairs=16,
              n_test_pairs=16, n_image_pairs=8, n_values=100, n_cates=4,
              n_keys=30)


def _env(**kw) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", **kw)
    return env


def _bash(script: Path, env: dict, cwd: Path, timeout: int = 120):
    return subprocess.run(["bash", str(script)], capture_output=True,
                          text=True, env=env, cwd=str(cwd), timeout=timeout)


def _normalized(stdout: str) -> list:
    """The lines with each step mark's clock reading taken out."""
    return [re.sub(r" @ \d+ ===$", " @ T ===", ln)
            for ln in stdout.splitlines()]


def _flags(kw: dict) -> list:
    return [a for k, v in kw.items() for a in (f"--{k}", str(v))]


# ----------------------------------------------------------- (a) commands


def _record(script: str, tmp: Path, name: str, knobs: dict) -> list:
    data = tmp / name
    # p8 packages what p7 fused: one row stands in for it
    ens = data / "output" / "ensemble"
    ens.mkdir(parents=True)
    (ens / "deepAI_result.jsonl").write_text(json.dumps({
        "src_item_id": "a", "src_item_emb": "[0]", "tgt_item_id": "b",
        "tgt_item_emb": "[0.5]", "threshold": 0.4}) + "\n")
    root = PORT if name == "port" else SCRIPTS
    proc = _bash(root / script, _env(IA="echo IA-CMD", DATA_DIR=str(data),
                                     **knobs), tmp)
    assert proc.returncode == 0, proc.stderr
    return _normalized(proc.stdout.replace(str(data), "$DATA_DIR"))


@pytest.mark.parametrize("script,knobs", [
    ("train.sh", {}),
    ("train.sh", {"START_AT": "5"}),
    ("train.sh", {"START_AT": "4", "STOP_AFTER": "4"}),
    ("train.sh", {"EPOCHS": "1", "KGE_EPOCHS": "1", "BERT_EPOCHS": "1",
                  "IMG_SIZE": "64", "IMG_EMB_SIZE": "32", "RESUME": "1",
                  "CONFIGS": "tiny"}),
    ("predict.sh", {}),
    ("predict.sh", {"START_AT": "p5", "IMG_SIZE": "64"}),
])
def test_port_scripts_issue_the_jax_commands(script, knobs, tmp_path):
    """Line for line the JAX script's output under ``IA="echo IA-CMD"``,
    once its parameter file names are the port's; p8's validation and
    zip path print the same."""
    jax_lines = _record(script, tmp_path, "jax", knobs)
    port_lines = _record(script, tmp_path, "port", knobs)
    substituted = []
    for line in jax_lines:
        for old, new in SUBSTITUTIONS:
            line = line.replace(old, new)
        substituted.append(line)
    assert port_lines == substituted
    cmds = [ln for ln in port_lines if ln.startswith("IA-CMD")]
    assert cmds and not any("msgpack" in ln for ln in port_lines)
    # every difference is one of the listed substitutions
    assert sum(a != b for a, b in zip(jax_lines, port_lines)) == sum(
        old in ln for ln in jax_lines for old, _ in SUBSTITUTIONS)
    if script == "predict.sh" and "START_AT" not in knobs:
        assert sum(".pt" in c for c in cmds) == 7
        assert port_lines[-2:] == ["{'rows': 1, 'ok': True}",
                                   "$DATA_DIR/result.zip"]


def test_port_train_sh_start_at_skips_completed_steps(tmp_path):
    env = _env(IA="echo IA-CMD", DATA_DIR=str(tmp_path), START_AT="5",
               EPOCHS="1", KGE_EPOCHS="1", BERT_EPOCHS="1")
    proc = _bash(PORT / "train.sh", env, tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    marks = [m.group(2) for m in map(MARK.match, lines) if m]
    assert tuple(marks) == TRAIN_STEPS
    i5 = next(i for i, ln in enumerate(lines) if "step 5-textcnn" in ln)
    before, after = lines[:i5], lines[i5:]
    assert not any(ln.startswith("IA-CMD") for ln in before)
    assert sum("(skipped" in ln for ln in before) == 5
    assert any(ln.startswith("IA-CMD finetune-text") for ln in after)
    assert any(ln.startswith("IA-CMD finetune-graph") for ln in after)


def test_port_train_sh_default_runs_from_step_zero(tmp_path):
    proc = _bash(PORT / "train.sh", _env(IA="echo IA-CMD",
                                         DATA_DIR=str(tmp_path)), tmp_path)
    assert proc.returncode == 0, proc.stderr
    first_cmd = next(ln for ln in proc.stdout.splitlines()
                     if ln.startswith("IA-CMD"))
    assert first_cmd.startswith("IA-CMD prepare")
    assert "(skipped" not in proc.stdout
    assert "IA-CMD pred-text" in proc.stdout
    assert "best_f1.pt" in proc.stdout


def test_port_train_sh_stop_after_exits_after_step(tmp_path):
    env = _env(IA="echo IA-CMD", DATA_DIR=str(tmp_path), START_AT="4",
               STOP_AFTER="4", EPOCHS="1", KGE_EPOCHS="1", BERT_EPOCHS="1")
    proc = _bash(PORT / "train.sh", env, tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    cmds = [ln for ln in lines if ln.startswith("IA-CMD")]
    assert cmds and all("finetune-text" in c for c in cmds)
    assert any("(stopping: STOP_AFTER=4)" in ln for ln in lines)
    assert not any("textcnn" in c for c in cmds)


def test_port_predict_sh_start_at(tmp_path):
    (tmp_path / "output" / "ensemble").mkdir(parents=True)
    (tmp_path / "output" / "ensemble" / "deepAI_result.jsonl").write_text(
        json.dumps({"src_item_id": "a", "src_item_emb": "[0]",
                    "tgt_item_id": "b", "tgt_item_emb": "[1]",
                    "threshold": 0.4}) + "\n")
    proc = _bash(PORT / "predict.sh", _env(
        IA="echo IA-CMD", DATA_DIR=str(tmp_path), START_AT="p6"), tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    marks = [m.group(2) for m in map(MARK.match, lines) if m]
    assert tuple(marks) == PREDICT_STEPS
    cmds = [ln.split()[1] for ln in lines if ln.startswith("IA-CMD")]
    assert cmds == ["pred-bert", "ensemble"]
    assert sum("(skipped" in ln for ln in lines) == 6
    assert (tmp_path / "result.zip").is_file()


# ------------------------------------------------------------- (b) corpus


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("seed", [0, 3])
def test_synth_corpus_writes_the_jax_generators_bytes(seed, tmp_path):
    """At one seed and size (and one ``PYTHONHASHSEED``: the images' noise
    is seeded by ``hash(item_id)`` in both) the same files, byte for
    byte, and the same summary but for the seconds."""
    flags = _flags(dict(CORPUS, seed=seed))
    env = _env(PYTHONHASHSEED="0")
    runs = {}
    for name, cmd in (
            ("jax", [sys.executable, str(SCRIPTS / "make_synth_corpus.py")]),
            ("port", [sys.executable, "-m",
                      "item_alignment_torch.pipeline.synth_corpus"])):
        out = tmp_path / name
        proc = subprocess.run(cmd + ["--output_dir", str(out)] + flags,
                              capture_output=True, text=True, env=env,
                              cwd=str(REPO), timeout=120)
        assert proc.returncode == 0, proc.stderr
        summary = json.loads(proc.stdout.splitlines()[-1])
        summary.pop("seconds")
        runs[name] = (_tree(out), summary)
    (jax_files, jax_summary), (port_files, port_summary) = runs["jax"], \
        runs["port"]
    assert port_summary == jax_summary and port_summary["test_pairs"] == 16
    assert sorted(port_files) == sorted(jax_files)
    assert {"raw/item_info.jsonl", "raw/item_train_pair.jsonl",
            "raw/item_valid_pair.jsonl", "raw/item_test_pair.jsonl",
            "vocab/vocab.txt", "item-align-train.json", "item-align-val.json",
            "item-align-test.json"} <= set(port_files)
    assert sum(k.startswith("raw/item_images/") for k in port_files) > 0
    assert all(port_files[k] == jax_files[k] for k in jax_files), sorted(
        k for k in jax_files if port_files[k] != jax_files[k])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tiny corpus from ``synth_corpus`` with its NFNet checkpoint."""
    from item_alignment_torch.pipeline import synth_corpus

    out = tmp_path_factory.mktemp("pipeline") / "data"
    synth_corpus.main(["--output_dir", str(out), "--with_nfnet_ckpt",
                       "--seed", "5"] + _flags(CORPUS))
    return out


def test_synth_corpus_nfnet_checkpoint_converts_back_exactly(corpus):
    """``--with_nfnet_ckpt`` writes the port NFNet's random weights under
    timm's names and shapes (those of the JAX generator's torch mirror of
    timm's eca_nfnet_l0), and ``convert_timm_nfnet`` gives them back
    exactly."""
    import numpy as np
    import torch
    from test_timm_import import TNFNet

    from item_alignment_torch.pipeline.synth_corpus import random_nfnet
    from item_alignment_torch.utils.timm_import import convert_timm_nfnet

    sd = torch.load(corpus / "pretrained" / "eca_nfnet_l0.bin")
    timm_like = TNFNet((1, 2, 6, 3), (256, 512, 1536, 1536), 64, 128,
                       1.5).state_dict()
    # timm's head has 1000 classes, the mirror's 10
    assert sd["head.fc.weight"].shape == (1000, 2304)
    assert {k: tuple(v.shape) for k, v in sd.items()
            if not k.startswith("head.")} == {
        k: tuple(v.shape) for k, v in timm_like.items()
        if not k.startswith("head.")}
    assert sd.keys() == timm_like.keys()
    back = convert_timm_nfnet({k: v.numpy() for k, v in sd.items()})
    state = random_nfnet(5).state_dict()
    assert back.keys() == state.keys()
    assert all(np.array_equal(back[k], state[k].numpy()) for k in state)
    gains = [v for k, v in state.items() if k.endswith(".gain")]
    assert gains and all(float(g.min()) >= 0.5 for g in gains)


# -------------------------------------------------------- (c) end to end


IA_CPU = """#!/usr/bin/env bash
# ia-torch on the CPU through chip_smoke.py's command server
cmd=$1; shift
case "$cmd" in
  {no_device}) exec {client} "$cmd" "$@" ;;
  *) exec {client} "$cmd" "$@" --device cpu ;;
esac
"""


@pytest.fixture(scope="module")
def ia_cpu(tmp_path_factory):
    """An ``IA`` for the scripts: ``chip_smoke.py``'s command server (each
    command in a child forked from a process that imported the port once,
    so the commands skip torch's import) behind a wrapper that adds
    ``--device cpu`` where the command's parser takes it.  Yields the
    wrapper's path and the file of the server's records."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    tmp = tmp_path_factory.mktemp("ia")
    address = f"ia_pipeline_test_{os.getpid()}"
    client = tmp / "ia_client.py"
    client.write_text(chip_smoke.CLI_CLIENT.format(address=address))
    wrapper = tmp / "ia-cpu"
    wrapper.write_text(IA_CPU.format(
        no_device="|".join(NO_DEVICE),
        client=f"{sys.executable} -I -S {client}"))
    wrapper.chmod(0o755)
    server = subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--serve-cli", address],
        stdout=subprocess.PIPE, text=True, env=_env(OMP_NUM_THREADS="4"),
        cwd=str(REPO), start_new_session=True)
    try:
        assert server.stdout.readline().strip() == "ready"
        yield str(wrapper), tmp / "commands.jsonl"
    finally:
        server.kill()
        server.wait()


def tiny_configs(root: Path) -> Path:
    """The scripts' five configs at tiny widths, under the same names:
    four layers for ``--cls_layers 1,2,3,4``; no attention dropout (the
    plain hash of the keep bits over [B, N, 510, 510] is the CPU's cost,
    and the kernels' tests hold dropout)."""
    base = dict(vocab_size=21128, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=64,
                hidden_act="gelu", hidden_dropout_prob=0.1,
                attention_probs_dropout_prob=0.0, max_position_embeddings=512,
                type_vocab_size=4, initializer_range=0.02,
                layer_norm_eps=1e-12, pad_token_id=0, num_labels=2)
    configs = {
        "roberta_large": dict(model_name="roberta_large",
                              num_hidden_layers=4),
        "pkgm_large": dict(model_name="pkgm_large", num_entities=258211,
                           num_relations=1379, kg_embedding_dim=16,
                           max_seq_len=64, max_pvs=30),
        "roberta_image_large": dict(model_name="roberta_image_large",
                                    ensemble="begin",
                                    image_hidden_size=3072),
        "textcnn": dict(model_name="textcnn", num_filters=4),
        "roberta_base": dict(model_name="roberta_base"),
    }
    out = root / "configs"
    out.mkdir()
    for name, kw in configs.items():
        (out / f"{name}.json").write_text(json.dumps(dict(base, **kw)))
    return out


def _steps(stdout: str, script: str) -> list:
    marks = [(m.group(1), m.group(2)) for m in map(MARK.match,
                                                   stdout.splitlines()) if m]
    assert all(s == script for s, _ in marks)
    return [name for _, name in marks]


def test_pipeline_end_to_end_on_cpu(corpus, ia_cpu, tmp_path):
    """train.sh then predict.sh on the tiny corpus with tiny configs:
    every step runs and returns 0, every member's parameter file and
    prediction exists, ``result.zip`` validates with a row a test pair;
    the JAX ``ensemble`` and packaging of the same member files give the
    same bytes."""
    from item_alignment_tpu.aggregate.submit import (
        package_submission as jax_package,
        validate_submission as jax_validate,
    )
    from item_alignment_tpu.cli import main as jax_main

    from item_alignment_torch.aggregate.submit import validate_submission

    client, records = ia_cpu
    env = _env(IA=client, DATA_DIR=str(corpus),
               CHIP_SMOKE_RECORDS=str(records),
               CONFIGS=str(tiny_configs(tmp_path)), IMG_SIZE="64",
               IMG_EMB_SIZE="64", EPOCHS="1", KGE_EPOCHS="1",
               BERT_EPOCHS="1", OMP_NUM_THREADS="4")
    t0 = time.perf_counter()
    train = _bash(PORT / "train.sh", env, tmp_path, timeout=600)
    assert train.returncode == 0, train.stdout[-3000:] + train.stderr[-3000:]
    assert "(skipped" not in train.stdout
    assert tuple(_steps(train.stdout, "train")) == TRAIN_STEPS
    out = corpus / "output"
    members = ("roberta_large-v3.4-one_tower-cls-NA-ce",
               "roberta_large-v3.4-one_tower-cls_1,2,3,4_cat-NA-ce",
               "pkgm_large-v3.4-one_tower-cls-NA-ce",
               "textcnn-v3.4-two_tower-cls-NA-ce",
               "roberta_image_large-v5-one_tower-cls-begin-ce",
               "eca_nfnet_l0-v6-two_tower-cls-NA-ce")
    for name in members:
        assert (out / name / "best_f1.pt").is_file(), name
    assert (out / "bert_base" / "bert_align.pt").is_file()
    assert (corpus / "graph" / "feature_matrix.npy").is_file()
    assert (out / "gcn" / "gcn_params.pt").is_file()

    predict = _bash(PORT / "predict.sh", env, tmp_path, timeout=600)
    assert predict.returncode == 0, (predict.stdout[-3000:]
                                     + predict.stderr[-3000:])
    assert tuple(_steps(predict.stdout, "predict")) == PREDICT_STEPS
    seconds = time.perf_counter() - t0
    recs = [json.loads(line) for line in records.read_text().splitlines()]
    # every command returned 0, found what it reads, and launched no
    # kernel: on the CPU each wrapper runs its kernel's plain version
    assert len(recs) == 15 + 9
    assert all(r["rc"] == 0 and not r["missing"] for r in recs)
    assert all(r["launches"] == [0] * 6 for r in recs)
    assert sum(len(r["reads"]) for r in recs) == 8
    commands = [r["argv"] for r in recs]
    result = out / "ensemble" / "deepAI_result.jsonl"
    assert validate_submission(str(result)) == {"rows": 16, "ok": True}
    with zipfile.ZipFile(corpus / "result.zip") as z:
        port_zip = {n: z.read(n) for n in z.namelist()}
    assert port_zip["deepAI_result.jsonl"] == result.read_bytes()

    # the JAX ensemble and packaging on the port's member files
    ensemble = next(c for c in commands if c[0] == "ensemble")
    jax_dir = tmp_path / "jax"
    for name in members + ("bert_base-one_tower-cls-NA-ce",):
        (jax_dir / "output" / name).mkdir(parents=True)
        shutil.copy(out / name / "deepAI_result_threshold=0.4.jsonl",
                    jax_dir / "output" / name)
    at = ensemble.index("--data_dir") + 1
    assert ensemble[at] == str(corpus)
    assert jax_main(ensemble[:at] + [str(jax_dir)] + ensemble[at + 1:]) == 0
    jax_result = jax_dir / "output" / "ensemble" / "deepAI_result.jsonl"
    assert jax_result.read_bytes() == result.read_bytes()
    assert jax_validate(str(jax_result)) == {"rows": 16, "ok": True}
    with zipfile.ZipFile(jax_package(str(jax_result),
                                     str(jax_dir / "result.zip"))) as z:
        assert {n: z.read(n) for n in z.namelist()} == port_zip
    print(f"pipeline on the CPU: {seconds:.1f} s for {len(commands)} "
          f"commands")
