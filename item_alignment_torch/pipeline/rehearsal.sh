#!/usr/bin/env bash
# Dress rehearsal: run the port's pipeline/train.sh + pipeline/predict.sh
# as one orchestrated pipeline on a reference-shaped synthetic corpus (65k
# train pairs, ~258k KG entities / ~3M triples), at reduced epochs, and
# record the measured per-step wall-clock.  The port's copy of
# scripts/rehearsal.sh.
#
#   DATA_DIR=/path/to/rehearsal bash item_alignment_torch/pipeline/rehearsal.sh
#
# Defaults: 1 epoch per finetune member, 50 KGE epochs (vs the reference's
# 10/500); the per-step seconds scale linearly to the full schedule.  The
# corpus is synthetic (python -m item_alignment_torch.pipeline.synth_corpus;
# no CCKS data or pretrained RoBERTa weights ship with the repo) so this
# measures pipeline integrity + wall-clock, not F1 parity; image members run
# on the --n_image_pairs slice and extrapolate.  CORPUS_FLAGS passes sizes
# to the generator.
set -uo pipefail

HERE="$(cd "$(dirname "$0")" && pwd)"
DATA_DIR=${DATA_DIR:-$HERE/../../rehearsal_data}
mkdir -p "$DATA_DIR"
DATA_DIR="$(cd "$DATA_DIR" && pwd)"
export DATA_DIR
# from the checkout's root: configs/ and the package are found there
cd "$HERE/../.."
export IA=${IA:-"python -m item_alignment_torch.cli"}
export EPOCHS=${EPOCHS:-1}
export KGE_EPOCHS=${KGE_EPOCHS:-50}
export BERT_EPOCHS=${BERT_EPOCHS:-1}

if [ ! -f "$DATA_DIR/raw/item_info.jsonl" ]; then
  echo "=== [rehearsal] corpus generation @ $(date +%s) ==="
  python -m item_alignment_torch.pipeline.synth_corpus \
    --output_dir "$DATA_DIR" --with_nfnet_ckpt ${CORPUS_FLAGS:-}
fi

# START_AT applies to train.sh only (steps 0..9); predict.sh has its own
# step namespace (p0..p8) and resumes via PREDICT_START_AT — a leaked
# train-side START_AT=6a would otherwise make predict.sh skip every step.
echo "=== [rehearsal] train.sh begin @ $(date +%s) ==="
START_AT="${START_AT:-}" bash "$HERE/train.sh" 2>&1 | tee "$DATA_DIR/train_log.txt"
train_rc=${PIPESTATUS[0]}
echo "=== [rehearsal] train.sh end rc=$train_rc @ $(date +%s) ==="

echo "=== [rehearsal] predict.sh begin @ $(date +%s) ==="
START_AT="${PREDICT_START_AT:-}" bash "$HERE/predict.sh" 2>&1 | tee "$DATA_DIR/predict_log.txt"
pred_rc=${PIPESTATUS[0]}
echo "=== [rehearsal] predict.sh end rc=$pred_rc @ $(date +%s) ==="

python - "$DATA_DIR" <<'EOF'
import json
import re
import sys

data_dir = sys.argv[1]
# merge with steps recorded by earlier (partial) runs: resumed pipelines
# preserve their prior logs as train_log_*.txt / predict_log_*.txt and the
# previous rehearsal_steps.json; a skipped step times at ~0s and must not
# shadow the real measurement, so "latest non-trivial wins".
import glob
timed = {}
try:
    for row in json.load(open(f"{data_dir}/rehearsal_steps.json")):
        timed[row["step"]] = row["seconds"]
except (FileNotFoundError, ValueError):
    pass
logs = sorted(glob.glob(f"{data_dir}/train_log_*.txt")) + \
    sorted(glob.glob(f"{data_dir}/predict_log_*.txt")) + \
    [f"{data_dir}/train_log.txt", f"{data_dir}/predict_log.txt"]
order = []
for log in logs:
    try:
        text = open(log).read()
    except FileNotFoundError:
        continue
    marks = re.findall(r"=== \[(?:train|predict).sh\] step (\S+) @ (\d+) ===",
                       text)
    skipped = set(re.findall(r"step (\S+) @ \d+ ===\n\s*\(skipped", text))
    for (name, t0), (_, t1) in zip(marks, marks[1:]):
        if name not in order:
            order.append(name)
        secs = int(t1) - int(t0)
        if name not in skipped and (name not in timed or secs > 0):
            timed[name] = secs
rows = [{"step": s, "seconds": timed[s]} for s in order if s in timed]
rows += [{"step": s, "seconds": v} for s, v in timed.items()
         if s not in order]
print(json.dumps({"per_step_seconds": rows}, indent=1))
open(f"{data_dir}/rehearsal_steps.json", "w").write(json.dumps(rows))
EOF
exit $(( train_rc || pred_rc ))
