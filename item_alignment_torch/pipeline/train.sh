#!/usr/bin/env bash
# Reproduction pipeline: train the 8 ensemble members with the reference's
# blessed hyperparameters (reference train.sh:1-140), via the ia-torch CLI.
# The port's copy of scripts/train.sh: the same steps, command lines, flags
# and knobs; the parameter files it reads are the port's .pt files.
#
#   DATA_DIR=data bash item_alignment_torch/pipeline/train.sh
#
# Inputs under $DATA_DIR: raw/item_info.jsonl, raw/item_train_pair.jsonl,
# vocab/ (BERT vocab dir), pretrained/ (pytorch_model.bin [+ pkgm_model.bin]).
set -euo pipefail

DATA_DIR=${DATA_DIR:-data}
OUT=${OUT:-$DATA_DIR/output}
VOCAB=${VOCAB:-$DATA_DIR/vocab}
PRETRAINED=${PRETRAINED:-$DATA_DIR/pretrained}
IA=${IA:-ia-torch}
CONFIGS=${CONFIGS:-configs}
# epoch knobs: defaults reproduce the reference's schedule; the dress
# rehearsal (pipeline/rehearsal.sh) overrides them for a reduced-epoch
# wall-clock measurement at reference data shape
EPOCHS=${EPOCHS:-10}
KGE_EPOCHS=${KGE_EPOCHS:-500}
BERT_EPOCHS=${BERT_EPOCHS:-3}
# image sizes: 800 matches the reference two-tower member (1000 upstream);
# 288 is the embedding-dump size; tiny shakeouts override both
IMG_SIZE=${IMG_SIZE:-800}
IMG_EMB_SIZE=${IMG_EMB_SIZE:-288}

# START_AT=<step-name-prefix> resumes mid-pipeline: steps before it are
# printed but skipped (their artifacts must already exist from a prior run).
# STOP_AFTER=<step-name-prefix> exits once that step completes, so a single
# member can be (re-)measured without running the pipeline's tail.
START_AT=${START_AT:-}
STOP_AFTER=${STOP_AFTER:-}
RUN=1
DONE_STOP=0
[ -n "$START_AT" ] && RUN=0
step() {
  if [ "$DONE_STOP" = 1 ]; then
    # print the mark so log summarizers can bound the stopped step's time
    echo "=== [train.sh] step $* @ $(date +%s) ==="
    echo "    (stopping: STOP_AFTER=$STOP_AFTER)"
    exit 0
  fi
  if [ "$RUN" = 0 ] && [[ "$1" == "$START_AT"* ]]; then RUN=1; fi
  echo "=== [train.sh] step $* @ $(date +%s) ==="
  [ "$RUN" = 1 ] || echo "    (skipped: START_AT=$START_AT)"
  if [ -n "$STOP_AFTER" ] && [ "$RUN" = 1 ] && [[ "$1" == "$STOP_AFTER"* ]]
  then DONE_STOP=1; fi
}
g() { if [ "$RUN" = 1 ]; then "$@"; fi; }

step 0-prepare
# 0. offline preparation (shared-pvs-first v3.4 ordering, KG id maps)
g $IA prepare --data_dir "$DATA_DIR/raw" --output_dir "$DATA_DIR/processed" \
  --valid_proportion 0.1 --num_train_augment 0

step 1-pkgm-pretrain
# 1. PKGM pretraining (TransE-style KG embeddings, margin loss, bern n_neg=3)
g $IA pkgm-pretrain --data_dir "$DATA_DIR/processed" \
  --output_dir "$DATA_DIR/kge" --model_name pkgm --embedding_dim 1024 \
  --batch_size 32768 --epochs "$KGE_EPOCHS" --learning_rate 1e-4 --margin 1.0 --n_neg 3

step 2-roberta-flagship
# 2. roberta_large v3.4 one-tower cls (the flagship; lr 5e-5 bs 40 seq 50+205)
#    Full train-state checkpoints land per epoch; re-running with the same
#    --checkpoint_dir and --resume continues from the last saved state.
#    bf16 AdamW moments, as the reference run of these flags keeps them;
#    the arithmetic stays fp32.
g $IA finetune-text --data_dir "$DATA_DIR/processed" --output_dir "$OUT" \
  --vocab_path "$VOCAB" --config_file "$CONFIGS"/roberta_large.json \
  --pretrained_model_path "$PRETRAINED" \
  --model_name roberta_large --data_version v3.4 \
  --max_seq_len 50 --max_seq_len_pv 205 --train_batch_size 40 \
  --opt_state_dtype bfloat16 \
  --checkpoint_dir "$OUT/roberta_large_ckpt" ${RESUME:+--resume} \
  --learning_rate 5e-5 --epochs "$EPOCHS" --bf16 --do_train --do_eval

step 3-roberta-cls-layers
# 3. roberta_large cls_1,2,3,4_cat variant
g $IA finetune-text --data_dir "$DATA_DIR/processed" --output_dir "$OUT" \
  --vocab_path "$VOCAB" --config_file "$CONFIGS"/roberta_large.json \
  --pretrained_model_path "$PRETRAINED" \
  --model_name roberta_large --data_version v3.4 --cls_layers 1,2,3,4 \
  --cls_pool cat --max_seq_len 50 --max_seq_len_pv 205 \
  --train_batch_size 40 --opt_state_dtype bfloat16 \
  --learning_rate 5e-5 --epochs "$EPOCHS" --bf16 --do_train

step 4-pkgm-finetune
# 4. pkgm_large one-tower (seq 64, max_pvs 30, effective batch 256).
#    The batch runs as 4 accumulated micro-steps of 64 with full-remat
#    activations, the same effective batch 256 as the reference, so the
#    port's numbers match a run of the original package with the same flags
#    (--gradient_accumulation_steps accumulates k FULL micro-batches, so
#    the per-step batch is 256/4, not 256)
g $IA finetune-text --data_dir "$DATA_DIR/processed" --output_dir "$OUT" \
  --vocab_path "$VOCAB" --config_file "$CONFIGS"/pkgm_large.json \
  --pretrained_model_path "$PRETRAINED" \
  --entity2id "$DATA_DIR/processed/entity2id.txt" \
  --relation2id "$DATA_DIR/processed/relation2id.txt" \
  --model_name pkgm_large --data_version v3.4 \
  --max_seq_len 64 --max_pvs 30 --train_batch_size 64 \
  --gradient_accumulation_steps 4 --remat --remat_policy full \
  --learning_rate 5e-5 --epochs "$EPOCHS" --bf16 --do_train

step 5-textcnn
# 5. textcnn two-tower
g $IA finetune-text --data_dir "$DATA_DIR/processed" --output_dir "$OUT" \
  --vocab_path "$VOCAB" --config_file "$CONFIGS"/textcnn.json \
  --model_name textcnn --data_version v3.4 --interaction_type two_tower \
  --max_seq_len 50 --max_seq_len_pv 205 --train_batch_size 64 \
  --learning_rate 1e-3 --epochs "$EPOCHS" --do_train

step 6a-image-prep
# 6a. image offline pipeline: detection-guided crops (boxes precomputed by
#     any external detector; omit --boxes_file to copy images uncropped),
#     then the pretrained-NFNet embedding dump threaded into 9-col TSVs.
#     TIMM_NFNET is a torch-saved eca_nfnet_l0 state_dict.
g $IA prepare --data_dir "$DATA_DIR/raw" --output_dir "$DATA_DIR/raw" \
  --only_image --object_detection ${BOXES_FILE:+--boxes_file "$BOXES_FILE"} \
  --min_crop_ratio 0.1
NFNET_CKPT="${TIMM_NFNET:-$PRETRAINED/eca_nfnet_l0.bin}"
g $IA prepare --data_dir "$DATA_DIR/raw" \
  --output_dir "$DATA_DIR/processed_image" --with_image \
  --cv_model_name eca_nfnet_l0 \
  --pretrained_model_path "$NFNET_CKPT" \
  --image_size "$IMG_EMB_SIZE" --valid_proportion 0.1

step 6b-roberta-image
# 6b. roberta_image_large v5 one-tower ensemble=begin
g $IA finetune-multimodal --data_dir "$DATA_DIR/processed_image" \
  --output_dir "$OUT" --vocab_path "$VOCAB" \
  --config_file "$CONFIGS"/roberta_image_large.json \
  --pretrained_model_path "$PRETRAINED" \
  --model_name roberta_image_large --data_version v5 --ensemble begin \
  --max_seq_len 50 --max_seq_len_pv 205 --train_batch_size 32 \
  --learning_rate 5e-5 --epochs "$EPOCHS" --bf16 --do_train

step 7-nfnet
# 7. eca_nfnet_l0 image two-tower from pair-image shards (image_size 1000
#    in the reference; 800 and batch 16, as the original package's run has them)
g $IA prepare --data_dir "$DATA_DIR/raw" \
  --output_dir "$DATA_DIR/image_shards" --only_image \
  --dtypes train,valid --image_size "$IMG_SIZE"
# valid shards exist when raw/item_valid_pair.jsonl does; eval on them
# when present so best_f1.pt carries the best (not last) params
VALID_SHARDS=$(ls "$DATA_DIR"/image_shards/valid_feat_*.npz 2>/dev/null || true)
g $IA finetune-image --data_dir "$DATA_DIR" --output_dir "$OUT" \
  --shards "$DATA_DIR"/image_shards/train_feat_*.npz \
  ${VALID_SHARDS:+--valid_shards $VALID_SHARDS} \
  --pretrained_model_path "$NFNET_CKPT" \
  --model_name eca_nfnet_l0 --data_version v6 --image_size "$IMG_SIZE" \
  --train_batch_size 16 --gradient_accumulation_steps 4 \
  --learning_rate 1e-4 --epochs "$EPOCHS" --bf16 \
  --do_train --do_eval

step 8-bert-legacy
# 8. legacy 5-field bert with MIX adversarial noise
g $IA finetune-bert --train_file "$DATA_DIR/item-align-train.json" \
  --valid_file "$DATA_DIR/item-align-val.json" --vocab_path "$VOCAB" \
  --config_file "$CONFIGS"/roberta_base.json --output_dir "$OUT/bert_base" \
  --batch_size 8 --epochs "$BERT_EPOCHS" --adversarial MIX

step 9-gcn
# 9. GCN over the item/attribute graph: adjacency + indexed pair files,
#    features from the finetuned flagship encoder
g $IA build-graph --item_info "$DATA_DIR/raw/item_info.jsonl" \
  --entity2id "$DATA_DIR/processed/entity2id.txt" \
  --train_pairs "$DATA_DIR/raw/item_train_pair.jsonl" \
  --output_dir "$DATA_DIR/graph" --valid_proportion 0.1
g $IA pred-text --entity2id "$DATA_DIR/processed/entity2id.txt" \
  --item_info "$DATA_DIR/raw/item_info.jsonl" --vocab_path "$VOCAB" \
  --config_file "$CONFIGS"/roberta_large.json \
  --pretrained_model_path "$PRETRAINED" \
  --file_state_dict "$OUT/roberta_large-v3.4-one_tower-cls-NA-ce/best_f1.pt" \
  --output "$DATA_DIR/graph/feature_matrix.npy"
g $IA finetune-graph \
  --feature_matrix "$DATA_DIR/graph/feature_matrix.npy" \
  --edges "$DATA_DIR/graph/edges.npz" \
  --train_pairs "$DATA_DIR/graph/item_train_train_pair.jsonl" \
  --valid_pairs "$DATA_DIR/graph/item_train_valid_pair.jsonl" \
  --edge_chunk 262144 --scan_layers \
  --output_dir "$OUT/gcn"
step done
