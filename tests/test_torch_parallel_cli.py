"""``ia-torch finetune-text --distributed`` in two processes on the CPU
(gloo), against one process (JAX's ``tests/test_multihost.py`` runs its CLI
the same way): each rank's losses and F1 agree with the other's and with
the one-process run's, and rank 0 alone writes the run's files."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from item_alignment_torch import cli as tcli
from item_alignment_torch.parallel.dryrun import free_port

pytest.importorskip("jieba")

from test_torch_cli import TINY, VOCAB  # noqa: E402
from test_torch_prepare import write_corpus  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS = re.compile(r"epoch (\d+) step (\d+) loss ([0-9.]+)")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_cli")
    write_corpus(tmp / "raw")
    (tmp / "vocab").mkdir()
    (tmp / "vocab" / "vocab.txt").write_text("\n".join(VOCAB),
                                             encoding="utf-8")
    (tmp / "tiny.json").write_text(json.dumps(TINY))  # attention dropout 0.1
    assert tcli.main(["prepare", "--data_dir", str(tmp / "raw"),
                      "--output_dir", str(tmp / "processed"),
                      "--valid_proportion", "0.3"]) == 0
    return tmp


def _argv(corpus, name, *extra):
    return ["finetune-text", "--data_dir", str(corpus / "processed"),
            "--output_dir", str(corpus / name), "--log_dir",
            str(corpus / name / "logs"), "--vocab_path",
            str(corpus / "vocab"), "--model_name", "roberta_tiny",
            "--config_file", str(corpus / "tiny.json"), "--max_seq_len", "8",
            "--max_seq_len_pv", "8", "--train_batch_size", "4",
            "--eval_batch_size", "4", "--epochs", "2", "--log_steps", "1",
            "--learning_rate", "1e-3", "--do_train", "--do_eval",
            "--device", "cpu", *extra]


def _start(argv):
    code = ("import sys; from item_alignment_torch.cli import main; "
            "sys.exit(main(sys.argv[1:]))")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT),
                                           os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, "-c", code, *argv], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    return {"losses": [float(m.group(3)) for m in LOSS.finditer(err)],
            "best": [x["best"] for x in lines if "best" in x][-1],
            "eval": [x for x in lines if "sweep" in x][-1]}


def test_two_processes_agree_with_one(corpus):
    port = free_port()
    group = _argv(corpus, "group", "--mesh", "2,1,1", "--distributed",
                  "--coordinator_address", f"127.0.0.1:{port}",
                  "--num_processes", "2")
    procs = [_start(group + ["--process_id", str(r)]) for r in range(2)]
    single = _start(_argv(corpus, "single"))
    ranks = [_finish(p) for p in procs]
    one = _finish(single)
    assert len(one["losses"]) == 4  # two steps an epoch, two epochs
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        assert r["best"] == ranks[0]["best"] and r["eval"] == ranks[0]["eval"]
    assert ranks[0]["best"]["best_f1"] == one["best"]["best_f1"]
    assert ranks[0]["eval"]["sweep"] == one["eval"]["sweep"]
    # rank 0's full-precision losses against the one process's
    logs = [[json.loads(x)["value"] for x in open(
        corpus / name / "logs" / "scalars.jsonl") if "train/loss" in x]
        for name in ("group", "single")]
    assert len(logs[0]) == len(logs[1]) == 4
    for a, b in zip(*logs):
        assert abs(a - b) <= 1e-5 * abs(b), logs
    run = "roberta_tiny-v1-one_tower-cls-NA-ce"
    assert (corpus / "group" / run / "best_f1.pt").exists()
    assert sorted(os.listdir(corpus / "group" / run)) \
        == sorted(os.listdir(corpus / "single" / run))
