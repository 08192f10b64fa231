#!/usr/bin/env bash
# Prediction + ensembling pipeline (reference predict.sh:1-160): per-model
# do_pred at the tuned thresholds, then the category-aware threshold
# ensemble and submission packaging, via the ia-torch CLI.  The port's copy
# of scripts/predict.sh: the same steps and command lines; it reads the
# port's .pt parameter files and packages with the port's submit module.
#
#   DATA_DIR=data bash item_alignment_torch/pipeline/predict.sh
set -euo pipefail

DATA_DIR=${DATA_DIR:-data}
OUT=${OUT:-$DATA_DIR/output}
VOCAB=${VOCAB:-$DATA_DIR/vocab}
IA=${IA:-ia-torch}
CONFIGS=${CONFIGS:-configs}
IMG_SIZE=${IMG_SIZE:-800}

# START_AT=<step-name-prefix> resumes mid-pipeline (same contract as
# train.sh): earlier steps print but skip
START_AT=${START_AT:-}
RUN=1
[ -n "$START_AT" ] && RUN=0
step() {
  if [ "$RUN" = 0 ] && [[ "$1" == "$START_AT"* ]]; then RUN=1; fi
  echo "=== [predict.sh] step $* @ $(date +%s) ==="
  [ "$RUN" = 1 ] || echo "    (skipped: START_AT=$START_AT)"
}
g() { if [ "$RUN" = 1 ]; then "$@"; fi; }

# per-model predictions (threshold 0.4 file naming, like the reference);
# --do_pred targets processed/finetune_test.tsv when present
step p0-roberta-flagship
g $IA finetune-text --data_dir "$DATA_DIR/processed" --output_dir "$OUT" \
  --vocab_path "$VOCAB" --config_file "$CONFIGS"/roberta_large.json \
  --model_name roberta_large --data_version v3.4 --threshold 0.4 --do_pred \
  --file_state_dict "$OUT/roberta_large-v3.4-one_tower-cls-NA-ce/best_f1.pt" \
  ${EXTRA_FLAGS:-}
step p1-roberta-cls-layers
g $IA finetune-text --data_dir "$DATA_DIR/processed" --output_dir "$OUT" \
  --vocab_path "$VOCAB" --config_file "$CONFIGS"/roberta_large.json \
  --model_name roberta_large --data_version v3.4 --cls_layers 1,2,3,4 \
  --cls_pool cat --threshold 0.4 --do_pred \
  --file_state_dict "$OUT/roberta_large-v3.4-one_tower-cls_1,2,3,4_cat-NA-ce/best_f1.pt" \
  ${EXTRA_FLAGS:-}
step p2-pkgm
g $IA finetune-text --data_dir "$DATA_DIR/processed" --output_dir "$OUT" \
  --vocab_path "$VOCAB" --config_file "$CONFIGS"/pkgm_large.json \
  --entity2id "$DATA_DIR/processed/entity2id.txt" \
  --relation2id "$DATA_DIR/processed/relation2id.txt" \
  --model_name pkgm_large --data_version v3.4 --max_seq_len 64 \
  --threshold 0.4 --do_pred \
  --file_state_dict "$OUT/pkgm_large-v3.4-one_tower-cls-NA-ce/best_f1.pt" \
  ${EXTRA_FLAGS:-}
# note: every member predicts at --threshold 0.4 so the prediction FILES
# all match the ensemble's --input_file; the per-member decision thresholds
# (0.6 textcnn, 0.5 nfnet, ...) live in the ensemble spec below
step p3-textcnn
g $IA finetune-text --data_dir "$DATA_DIR/processed" --output_dir "$OUT" \
  --vocab_path "$VOCAB" --config_file "$CONFIGS"/textcnn.json \
  --model_name textcnn --data_version v3.4 --interaction_type two_tower \
  --threshold 0.4 --do_pred \
  --file_state_dict "$OUT/textcnn-v3.4-two_tower-cls-NA-ce/best_f1.pt" \
  ${EXTRA_FLAGS:-}
step p4-roberta-image
g $IA finetune-multimodal --data_dir "$DATA_DIR/processed_image" \
  --output_dir "$OUT" --vocab_path "$VOCAB" \
  --config_file "$CONFIGS"/roberta_image_large.json \
  --model_name roberta_image_large --data_version v5 --ensemble begin \
  --threshold 0.4 --do_pred \
  --file_state_dict "$OUT/roberta_image_large-v5-one_tower-cls-begin-ce/best_f1.pt" \
  ${EXTRA_FLAGS:-}
# test-pair image shards (train.sh step 7 builds only train/valid)
step p5-nfnet
g $IA prepare --data_dir "$DATA_DIR/raw" \
  --output_dir "$DATA_DIR/image_shards" --only_image \
  --dtypes test --image_size "$IMG_SIZE"
# eval batch 16, as the original package's run has it (the shared text default
# is 64)
g $IA finetune-image --data_dir "$DATA_DIR" --output_dir "$OUT" \
  --shards "$DATA_DIR"/image_shards/test_feat_*.npz \
  --model_name eca_nfnet_l0 --data_version v6 --image_size "$IMG_SIZE" \
  --train_batch_size 16 --eval_batch_size 16 \
  --interaction_type two_tower --threshold 0.4 --do_pred \
  --file_state_dict "$OUT/eca_nfnet_l0-v6-two_tower-cls-NA-ce/best_f1.pt" \
  ${EXTRA_FLAGS:-}
# legacy bert: pred-bert writes the submission jsonl into the ensemble dir
step p6-bert
g mkdir -p "$OUT/bert_base-one_tower-cls-NA-ce"
g $IA pred-bert --test_file "$DATA_DIR/item-align-test.json" \
  --vocab_path "$VOCAB" --config_file "$CONFIGS"/roberta_base.json \
  --params "$OUT/bert_base/bert_align.pt" --threshold 0.4 \
  --output "$OUT/bert_base-one_tower-cls-NA-ce/deepAI_result_threshold=0.4.jsonl"

# threshold ensemble with the category-aware split (model_ensemble.py)
step p7-ensemble
g $IA ensemble --data_dir "$DATA_DIR" --ensemble_strategy threshold \
  --item_info "$DATA_DIR/raw/item_info.jsonl" \
  --models '[
    ["roberta_large-v3.4-one_tower-cls-NA-ce", 0.3, 0.8610],
    ["roberta_large-v3.4-one_tower-cls_1,2,3,4_cat-NA-ce", 0.4, 0.8600],
    ["roberta_image_large-v5-one_tower-cls-begin-ce", 0.4, 0.8582],
    ["eca_nfnet_l0-v6-two_tower-cls-NA-ce", 0.4, 0.7777],
    ["pkgm_large-v3.4-one_tower-cls-NA-ce", 0.4, 0.8096],
    ["bert_base-one_tower-cls-NA-ce", 0.3, 0.8510],
    ["textcnn-v3.4-two_tower-cls-NA-ce", 0.6, 0.7703]]' \
  --models_unseen '[
    ["roberta_large-v3.4-one_tower-cls-NA-ce", 0.4, 0.8610],
    ["roberta_large-v3.4-one_tower-cls_1,2,3,4_cat-NA-ce", 0.4, 0.8600],
    ["roberta_image_large-v5-one_tower-cls-begin-ce", 0.4, 0.8582],
    ["pkgm_large-v3.4-one_tower-cls-NA-ce", 0.5, 0.8096],
    ["bert_base-one_tower-cls-NA-ce", 0.4, 0.8510],
    ["textcnn-v3.4-two_tower-cls-NA-ce", 0.6, 0.7703]]'

# package result.zip for the scorer
step p8-package
if [ "$RUN" = 1 ]; then
python - <<'EOF'
import os
from item_alignment_torch.aggregate.submit import package_submission, validate_submission
data_dir = os.environ.get("DATA_DIR", "data")
result = os.path.join(data_dir, "output", "ensemble", "deepAI_result.jsonl")
print(validate_submission(result))
print(package_submission(result, os.path.join(data_dir, "result.zip")))
EOF
fi
