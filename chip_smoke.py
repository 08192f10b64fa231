#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each (more for most); any failure exits non-zero.  They
run in the order 1-6, 11, 7-9, 12-15, 10, 16-24:

1. card: name and power limit from nvidia-smi; TF32 off.
2. build: compile every kernel source in ``item_alignment_torch/csrc``, one
   nvcc each, all at once; print each kernel's ptxas registers and spills,
   and the dynamic shared memory of the bf16 #1, #4, #5 and #6 blocks; from
   ``cuobjdump -sass``, the branches in each stretch between two batches of
   products that holds exponentials (the per-score work) of #1's bf16
   kernels and of #4's (with and without dropout, every head dim): there
   must be none, and #4's bf16 kernels must spill no register.  The fp32
   dQ and dK/dV kernels (``flash_dq_f32``, ``flash_dkv_f32``: #3's fp32
   route, #5/#6 in fp32), every head dim with and without dropout: their
   dynamic shared memory, and from the SASS their TF32 tensor-core
   products (HMMA.1688.F32.TF32) and scalar FMAs: each must hold TF32
   products and fewer than a third as many FFMAs (no scalar-FMA product
   loop), and none may spill.  Then the native data loader's host library
   (``csrc/ia_data.cpp``) by g++: its build seconds and path.
3. kernel: the serving kernel (#1) against its plain PyTorch version on the
   card at the serving shapes (B=64, S=510 and S=255, N=16, H=64, bf16), at
   S=510 on the split views of a fused QKV projection, and at small fp32
   and other-head-dim cases, with ragged masks, a fully masked row and a
   large-norm row.  Times of the kernel (with achieved TFLOP/s), the plain
   version and
   ``scaled_dot_product_attention`` (a yardstick only: the port never calls
   it), their ratio, beside the least time the card could take.
4. cross-encoder: RoBERTa-large ``RobertaOneTower`` (24 layers, hidden 1024,
   S=510, bf16, random weights from --seed) answers batches of 8 pair
   requests; probs checked against the same weights on the plain attention.
5. mining: ``RobertaTwoTower`` at 255 tokens under ``TwoTowerInference``
   encodes 512 items once in batches of 64 and scores 100 pairs per item;
   cached probs checked against a direct two-tower forward.
6. training kernels: #2's contract, the attention-dropout forward (run by
   kernel #4), and #3's contract, the backward (run by the delta kernel,
   #5 and #6), against their plain versions at B=4, S=510, N=16, H=64 in
   bf16 and at small fp32 and H=32/128 shapes, at rate 0 and 0.1, with
   ragged masks, a fully masked row and a large-norm row (lse held within
   1e-5 on the ordinary rows, as lse + 1e9 within 1e-4 on the fully masked
   row and within 1e-5 of |lse| + 1 on the large-norm row; dq/dk/dv held
   per batch row and head against that slice's max|ref|, the large-norm
   row as a whole against its own); the keep bits read back from the three
   CUDA kernels (#4, #6, #5) equal the plain hash bit for bit, and the
   dropped fraction is near 26/256.  fp32 off the 1/8 grid (randn q, k,
   v and g, no x30 row, a fully masked row) at B=4, S=510, N=16, H=64 and
   B=2, S=300, N=4, H=128, and on views whose rows are not 16-byte
   aligned (4-byte copies), rate 0 and 0.1: out within 1e-4 of each
   slice's max|ref|, lse as above, and dq, dk and dv within 1e-4 of each
   slice's max|ref|, against the plain versions on float64-upcast inputs
   (the fully masked row against the plain versions in fp32), and the
   same plain versions in fp32 with TF32 products must read above those
   limits (the witnesses that the inputs tell fp32 from TF32: the
   forward's on out or on lse, the backward's on dq, dk or dv).
   Times at the train shape B=40, S=510 beside the plain versions,
   ``scaled_dot_product_attention`` with dropout 0.1 (forward, and its
   backward alone; a yardstick only) and the least time the card could
   take for the function (and, for the backward, for the route's own
   products); the backward's parts (#5, #6, delta) and its ratio to SDPA.
7. gradient check: RoBERTa-large at batch 4, dropout 0 and
   ``deterministic=False``, in fp32 and bf16: one backward through the
   kernels against the same weights with ``use_flash_attention=False`` and
   the plain attention computed in fp32, every parameter's gradient and,
   in bf16, the median over the layers of the q/k/v weight gradients.
8. training: RoBERTa-large ``RobertaOneTower`` with the bench.py recipe
   (batch 40, S=510, dropout 0.1, fused AdamW with bf16 moments) takes one
   warm-up step and three timed steps through the port's ``Trainer``, then
   one more under ``torch.profiler`` for the device time by kernel group
   and the device's idle share; then one more step under
   ``utils/flops.count_flops``: its model FLOP within 1% above three times
   tests/test_flops.py:70's hand count of the encoder (plus, under remat,
   the attention products the "dots" policy replays), and its share of 989
   TFLOP/s at the timed ms/step.  Phase 14 does the same at S=1024.
9. remat: RoBERTa-large at batch 4 with dropout 0.1 and one seed; the
   gradients with each ``remat_policy`` equal those without remat.  It runs
   after phase 8: run before it, it slowed phase 8's host side (the device
   time per step stayed the same), and phase 8's step is close to
   host-bound.
10. sensitivity: the checks can fail.  For each entry of ``MUTATIONS`` a
   backward kernel's output is made wrong (dq, dk or dv scaled or zeroed,
   in every launch or in one layer's alone), and the kernel phase (6 or 11)
   at its main shape and the gradient check (7 or 13) in bf16 must each
   fail where the entry lists them.
11. blockwise kernels: the long-sequence forward (#4), dQ (#5) and dK/dV (#6)
   kernels against their plain versions at B=2, S=1024 and S=2048, N=16,
   H=64 in bf16, at S=1020 (a ragged last tile), and at small fp32 and
   H=32/128 shapes, held as in phase 6, and fp32 off the grid at B=2,
   S=600, N=4, H=64 as in phase 6; keep bits of all three kernels
   against the plain hash; at B=4, S=510, rate 0 and 0.1, #4's out and lse
   against a full-tile softmax in float64 computed on the card
   (``torch.logsumexp`` of the scores, the keep bits of
   ``keep_mask_reference``), which shares no code with the kernel or its
   plain version.  Times of each kernel alone at B=16, S=1024 (the long
   train shape) and at B=4, S=2048, where the plain versions' outputs are
   held against the kernels' as well, beside the plain versions,
   ``scaled_dot_product_attention`` with dropout 0.1 (its forward beside
   #4; its whole backward, which gives dq, dk and dv together, beside #5
   and #6, and its ratio to delta + #5 + #6; a yardstick only) and the
   least time the card could take.
12. long cross-encoder: ``RobertaOneTower`` at pair length S=1024
   (``max_seq_len=100, max_seq_len_pv=412``) with a 1032-row position table,
   full depth, bf16, batches of 4 pairs; probs against plain attention.
13. long gradient check: phase 7's check at batch 2, S=1024.  In bf16 each
   query and key parameter is held by its component along the plain
   gradient, and the same model runs once more on the plain versions of
   #4-#6 to show how far bf16 rounding alone moves those gradients.
14. long training: ``Trainer`` at batch 16, S=1024, dropout 0.1, fused AdamW
   with bf16 moments, full depth: one warm-up and three timed steps, then
   one under ``torch.profiler``.
15. checkpoint and resume: first, the gradients of one step at each train
   batch size (2 layers) repeat bit for bit over four runs; then
   ``Trainer.fit`` with ``checkpoint_dir`` in a
   temporary directory at 4 layers (full width, S=1024, batch 4), two epochs
   of two steps, against a run stopped after the first epoch and resumed
   with ``resume=True``: final parameters and optimizer moments equal bit
   for bit.
16. entry points: ``item_alignment_torch.cli.main`` in this process, at
   ``configs/roberta_large.json`` width in bf16 with random weights, on a
   corpus and a 21128-row vocab written from --seed into a temporary
   directory (jieba where installed, else a whitespace stand-in registered
   for this phase only; the line says which).  ``prepare`` writes the
   TSVs; ``finetune-text`` one-tower (max_seq_len 50 + 205, pair S=510,
   batch 40, phase 8's schedule horizon) trains four steps, evaluates and
   predicts: losses finite, 24
   calls of #2's and of #3's contracts a step, #1 in every eval and
   prediction batch, and the prediction file equal to a direct forward of
   the saved ``best_f1.pt`` within 2e-2.  (16b) ``finetune-text
   --scan_steps 8`` and ``--scan_steps 1`` train the same 18 batches
   (chunks of 8, 8, 1, 1 against 18 of one) with the loss logged every 3
   steps: the parameters equal bit for bit, the loss logged at the steps
   the JAX Trainer's rule gives ([8, 16, 18] and [3, 6, ..., 18]), 24
   calls of #2's and #3's contracts a step, ms/step of both (host clock
   between the first and last logged losses); a third ``--scan_steps 8``
   run under ``torch.profiler`` counts one pinned host-to-device copy a
   batch key a chunk and equals the others bit for bit.
   ``finetune-text`` two-tower
   trains two steps; ``mine`` on its weights (512 items at S=255, 10 pairs
   an item) runs in bf16, with ``--cache_quant int8`` and with ``--quant
   int8 --cache_quant int8``: bf16 within 2e-2 of 64 direct two-tower
   forwards, the int8 cache within 0.01 and int8 dense projections within
   0.05 of bf16 (the JAX package's own limits), ``torch._int_mm`` 6 x 24
   times an encode batch.  ``pred-text`` on every entity of ``prepare``'s
   ``entity2id.txt`` (over 1024) at S=64, bf16 and int8 with
   ``--scan_chunks 8 --xfer_guard`` and bf16 with ``--scan_chunks 1``: [n,
   1024], finite, ``--scan_chunks`` 8 and 1 equal bit for bit, #1 24 times
   an encode of 256 rows (groups of 8 padded), int8 within 8% of bf16
   (relative, Frobenius); a pageable host-to-device copy under the guard
   raises and a pinned non-blocking one goes through.  ``ops/quant.int8_mm`` is
   exact on the card at the encoder's product shapes.  Wall times of every
   command, ``mine``'s pairs/s and the CLI's ms/step.
17. PKGM: on the phase 16 corpus, ``prepare``'s KG maps grown to
   configs/pkgm_large.json's 258,211 entities (the corpus's ``/item/<id>``
   entities first) and 1,379 relations, with 262,144 train and 1,024
   validation facts from --seed.  (a) ``ia-torch pkgm-pretrain --model_name
   pkgm --embedding_dim 1024 --batch_size 32768 --n_neg 3 --epochs 2
   --do_eval``: ms/step, epoch and eval times, the host time of reading the
   KG, ``bernoulli_probs`` and the filter dictionaries; the loss finite and
   falling, ``kge_final.npz`` equal to the trained [258211, 1024] tables,
   and the all-candidate tail scores of 64 facts within 1e-3 (relative) of
   pointwise ``score``.  (b) ``finetune-text --model_name pkgm_large``
   one-tower (max_seq_len 64, max_pvs 30: S=248) in bf16 with dropout 0.1,
   4 steps at batch 40, eval and predict, from a ``pytorch_model.bin`` of
   random RoBERTa-large weights and a ``pkgm_model.bin`` made from (a)'s
   ``kge_final.npz``, whose tables the model holds bit for bit after the
   merge.  (c) the two-tower (S=124 a tower), 2 steps and eval.  (d) the
   one-tower's probabilities on the kernels within 2e-2 of plain attention
   and of its prediction file; #1 held and timed at B=40, S=248 and 124;
   #2's forward and #3's dq, dk and dv (dropout 0 and 0.1, and their keep
   bits) held against their plain versions at B=40, S=248 and 124 as
   phase 6 holds them; a PKGM-large train step timed and profiled, with the entity table's lookup
   backward and AdamW update timed alone; two train steps run twice from one
   state equal bit for bit (2 layers, the full entity table).
18. multimodal: on the phase 16 corpus, with a synthetic
   ``image_embedding.json`` of 3072 floats an item from --seed and the
   vocab's ``[unused99]`` at row 99, at configs/roberta_image_large.json's
   width in bf16 with random weights.  (a) ``prepare --with_image``: TSVs
   of 9 columns whose image columns parse to the written vectors and are
   the file's own array text byte for byte (the native span scan);
   ``read_embedding_spans`` timed against ``json.load`` + ``format_rows``
   on the file, both giving the same texts; a row of NaN, +inf and -inf
   dumped and read back by ``json.loads``.  (b)
   ``finetune-multimodal --model_name roberta_image_large --ensemble
   begin`` one-tower (max_seq_len 50 + 205, S=510, batch 32, dropout 0.1)
   trains 5 steps, evaluates and predicts: losses finite, the layout's
   image tokens at position 1 and past it, probabilities on the kernels
   within 2e-2 of plain attention and of the prediction file, then phase
   8's timing of 3 steps and one profiled step.  (c) ``--ensemble end``
   one-tower 1 step and eval (``dense_img`` 6144 -> 1024, no ``img2txt``);
   the ``begin`` two-tower (S=255 a tower) 2 steps and eval.  (d) #2's
   forward and #3's dq, dk and dv (dropout 0 and 0.1, and their keep
   bits) against their plain versions at B=32, S=510 and 255 as phase 6
   holds them.  (e) a text member (``finetune-text roberta_large``, 1
   step, predict) and the multimodal member fused by ``ensemble
   --ensemble_strategy threshold``: one row per test pair, each score the
   sum of the members' prob - 0.5 and equal to ``ensemble_predictions``.
   (f) ``model-soup`` of two epoch files of (b)'s command: every tensor
   equal to (a + b) / 2 computed on the card.
19. legacy BERT and TextCNN: on the phase 16 corpus (320 labelled pairs),
   its items as 5-field rows (the first 20 key:value pairs, spaced into
   words; pvs pairs of 113-293 real tokens padded to 512), at
   configs/roberta_base.json's width (12 layers, hidden 768, 12 heads of
   64, FFN 3072, vocab 21128) with random weights.  (a) ``bert-pretrain``
   at S=256 (``--max_seq_len 254``), batch 16, bf16, on the first corpus
   items whose structure-aware examples fill exactly 4 steps: losses
   finite, five token types.  (b) ``finetune-bert --adversarial MIX`` in
   fp32 (scripts/train.sh step 8) from (a)'s ``bert_pretrain.pt``, batch 8,
   6 steps and an eval of 40 rows; then ``--bf16 --adversarial FREE`` 4
   steps, and phase 8's timing of 3 steps and one profiled step through a
   ``Trainer`` with FREE noise, then the same in fp32 with MIX noise (the
   attention kernels' device time one by one).  (f) rows whose row 3 holds a pvs pair of
   512 real tokens: the data layer's build raises the ``ValueError`` on
   the host, before any device work.  (c) ``pred-bert`` on the 40 test
   pairs with (b)'s fp32 weights: one line a pair, the file equal to a
   direct forward on the kernels, which is within 1e-5 of plain attention;
   the same weights in bf16 within 2e-2.  (d) ``finetune-text --model_name
   textcnn --interaction_type two_tower`` at configs/textcnn.json, S=50+205,
   batch 64, lr 1e-3: 4 steps, eval and predict, no attention kernel.  (e)
   #1, #2's forward and #3's dq, dk and dv (dropout 0 and 0.1, and their
   keep bits) against their plain versions at N=12, H=64, B=8 and S=512,
   150, 50 and 20, in bf16 and fp32, and #2's and #3's at (a)'s B=16,
   S=256 in bf16, held as phases 3 and 6 hold them, fp32 off the grid
   (#2's forward and #3's backward) at B=8, S=512 as in phase 6, and each
   timed at B=8, S=512 beside SDPA and the bound, #3's route with dQ and
   dK/dV alone (TFLOP/s and the ratio to their bounds: in fp32 those of
   3xTF32).
20. the image family: on phase 16's corpus at 512 items in four
   categories of ``data/images.py:CATE2YOLO_CLASS``, each with a JPEG main
   image (a product on a plain background, 600-1000 px a side) and 128
   train, 32 valid and 32 test pairs, and an ``eca_nfnet_l0`` checkpoint
   under timm 0.6.5's names and shapes written from a random NFNet (every
   StdConv gain from U(0.5, 1)), all from --seed.  (a) scripts/train.sh
   step 6a: ``prepare --only_image --object_detection --min_crop_ratio
   0.1`` (the saliency detector: at least 90% of the items cropped), then
   ``prepare --with_image --cv_model_name eca_nfnet_l0
   --pretrained_model_path`` at 288 px, batch 32, fp32: 512 vectors of
   2304, eight of them within 1e-4 of max|ref| of direct fp32 forwards of
   the same crops on the card and on the CPU; one encode batch profiled;
   the TSVs' 2304-wide image columns then train one ``finetune-multimodal``
   step at configs/roberta_image_large.json's width (batch 32, S=510,
   bf16).  (b) step 7 and predict.sh p5: ``prepare --only_image --dtypes
   train,valid,test --image_size 800`` (uint8 shards), ``finetune-image
   --model_name eca_nfnet_l0 --image_size 800 --train_batch_size 16
   --gradient_accumulation_steps 4 --learning_rate 1e-4 --bf16`` from the
   checkpoint, 8 micro-batches and an eval, then ``--do_pred`` in fp32 from
   its ``best_f1.pt``: the file within 1e-4 of a direct fp32 forward, bf16
   probabilities within 2e-2 of fp32, uint8 normalised on the card within
   1e-6 of the host's ``normalize``; then the step through a ``Trainer``
   (one warm-up and three timed optimizer steps of 4 micro-batches, one
   micro-batch under ``torch.profiler`` split into convolutions,
   elementwise and the rest, its model FLOP by ``utils/flops.count_flops``,
   which must equal ``FlopCounterMode``'s there), and at
   288 px in fp32 with dropout 0 the gradient mean that the optimizer hands
   AdamW after 4 micro-batches of 4 pairs within 1e-4 of each parameter's
   max|ref| of one batch of the 16.  (c) ViT-L/16 at 384
   (configs/vit_large_patch16_384.json: 577 tokens, 24 layers, hidden 1024)
   and ResNetV2-50 at 288 (configs/resnetv2_50.json): a two-tower train
   step at batch 16 in bf16, one warm-up and three timed, and the trained
   weights' bf16 probabilities within 2e-2 of fp32.  No attention kernel is
   on this path: the image commands count no launch of #1-#6.
21. the graph path (scripts/train.sh step 9) at the reference's scale,
   230,000 nodes and 2,000,000 random edges plus self loops, from --seed.
   (a) ``ops/sparse.spmm`` on the card, forward, dx and dw, against
   float64 on the CPU (``index_add_``, no shared code) within 1e-5 of
   max|ref|: on a graph a tenth that size sorted by destination and not,
   whole and in padded chunks, with the transpose list and without; and
   at full size in train.sh's layout (sorted, chunks of 262,144, padded,
   the transpose).  Its time at [230000, 128] fp32 (forward, the backward's
   dx) beside the bytes bound and the bare ``torch.sparse.mm`` (cuSPARSE's
   CSR SpMM, which spmm calls) on a CSR matrix built beforehand, which must
   give spmm's forward bit for bit.  (b) two forward and backward runs
   equal bit for bit (cuSPARSE's CSR SpMM repeats, and dw is gathers).
   (c) ``ia-torch build-graph`` on a 512-item ``item_info`` with its
   ``entity2id.txt``: every item-value link both ways plus self loops,
   both lists sorted by destination, the transpose the swapped list, the
   pair split.  (d) ``ia-torch finetune-graph --edge_chunk 262144
   --scan_layers`` (hidden 128, 4 layers, batch 512, Adam 1e-2) on fp32
   features [230000, 1024], 2 epochs of 4,096 pairs and 1,024 valid
   pairs, twice: ``gcn_params.pt`` equal bit for bit, ms/step, peak
   memory, one step under ``torch.profiler``; a 3,000-node graph's
   trained probabilities on the card within 1e-4 of the CPU's.  No
   attention kernel is on this path.
22. CoCa at configs/coca_base.json's width (hidden 768, 12 text layers,
   a 12-layer ViT-B/16 at 224 px, a 12-deep multimodal decoder with 12
   heads) in bf16 with random weights from --seed.  (a) ``ia-torch
   coca-pretrain`` on two ``.npz`` shards of 128-token captions and uint8
   images, batch 32, 4 steps: losses finite, 12 calls of #2's and #3's
   contracts a step.  (b) ``finetune-multimodal --model_name coca_base``
   with ``--ensemble sum`` and ``cross_attn`` from (a)'s
   ``coca_pretrain.pt`` on 7-column TSVs with a 256 px JPEG an item (S=128
   a tower, batch 32, 3 steps, eval, predict): 24 calls of #2's and #3's
   contracts a step and 24 launches of #1 an eval or prediction batch;
   the probabilities on the kernels within 2e-2 of plain attention, of
   the finetuned model and of its start (the seed's weights under the
   pretrain's, the head scaled so that its logit margins have a root mean
   square of 1; at least 4 of its probabilities must lie off 0 and 1:
   random weights saturate them within a few steps); with ``sum``, 3
   steps timed and one profiled through a ``Trainer``.  (c) #1 at the
   finetune's S=128, B=32, N=12, and #2's and #3's contracts at the
   pretrain's S=127 and the finetune's S=128 (B=32, N=12, rates 0 and
   0.1, the keep bits), against their plain versions as phase 6 holds
   them; their errors join the kernels line's.
23. the parallel layer (``item_alignment_torch/parallel``).  (a) The keep
   bits at global indices: #2's contract and #3's route at B=40, S=510,
   N=16, H=64 in bf16, #4-#6 at B=4, S=1024, and both in fp32 at small
   shapes, rate 0.1, called on rows 20-39 (2-3, 1-2) and heads 8-15 (2-3)
   with (bn_stride, bn_base) = (N, r0 * N + h0): out, lse, dq, dk, dv and
   the keep bits read back from each kernel equal the whole call's slice
   bit for bit.  (b) Phase 8's recipe through a process group of one over
   NCCL, mesh (1,1,1), the model under FSDP2 (each layer, then the root;
   a tensor axis of 1 takes no tensor-parallel style): losses and
   parameters of one warm-up and five timed steps against the same steps
   without a process group (1e-6 relative; bit for bit is expected and the
   line says which), ms/step and the idle share of both, 24 calls of #2's
   and #3's contracts a step; a third run with the tensor-parallel styles
   put on by hand splits the wrappers' cost between them and FSDP2.  (c) Two processes
   on the one card over gloo, mesh (2,1,1), one step at hidden 256 through
   the kernels against the same step in one process (loss 1e-6 relative,
   gradients 1e-5 of the largest); (1,1,2) is left out (gloo's collectives
   on CUDA tensors crashed a rank).
24. the reproduction pipeline: ``item_alignment_torch/pipeline/train.sh``
   (steps 0-9) then ``predict.sh`` (p0-p8) as ``bash`` children under
   ``set -euo pipefail``, at the scripts' own ``configs/*.json`` (RoBERTa-
   large, PKGM-large, RobertaImage-large, TextCNN, RoBERTa-base),
   ``eca_nfnet_l0`` at ``IMG_SIZE`` 800 and ``IMG_EMB_SIZE`` 288, 1024-wide
   GCN features, ``EPOCHS=KGE_EPOCHS=BERT_EPOCHS=1``, on a corpus that
   ``pipeline/synth_corpus.py`` makes from --seed (4,000 items, 2,000
   train, 200 valid and 200 test pairs, 64 image pairs, 3,000 values, a
   random eca_nfnet_l0 under timm's names).  ``IA`` is a client of
   ``serve_cli``: each of the 24 ``ia-torch`` commands runs ``cli.main``
   in a child forked from one process that imported torch and the port
   once (the jieba stand-in on the children's ``PYTHONPATH`` where jieba
   is missing) and records its return code, the parameter files it reads
   (each must exist before its step), its launches of #1-#6 and whether
   it rebuilt a kernel library.  Each step's mark and the scripts' rc 0;
   #1 in every eval and prediction, #2 = #3 in every finetune of an
   attention model (#2 = 2 x #3 under step 4's ``--remat``), none of
   #1-#3 elsewhere, #4-#6 nowhere; ``result.zip`` validated by the port's
   ``validate_submission`` with a row for each distinct test pair, its
   fused scores finite.  Each step's wall seconds and the whole
   pipeline's, beside the card's name and power limit.

Every launch counter is zeroed just before each main path and read just
after it: phases 4-5 (serving: only #1, once per layer of every forward),
phase 8 (training: 24 calls of #2's contract and 24 of #3's per step,
none counted as #4, #5 or #6), phase 12 (long
serving: 24 launches of #4 per forward, no other kernel), phase 14 (long
training: 24 launches each of #4, #5 and #6 per step, no other kernel),
each command of phase 16, and phase 17's finetune commands (b-c: #1 in
every eval and prediction batch, #2 and #3 24 calls a step a tower, none of
#4-#6), and phase 18's commands (b, c, e, f: the same rule; its direct
forwards, profiled steps and kernel checks are left out), and phase 19's
commands (``bert-pretrain``: #2 and #3 12 calls a step; ``finetune-bert``:
60 a step, 12 layers x 5 fields, and #1 60 an eval batch; ``pred-bert``: #1
60 a batch; TextCNN none; #4-#6 none anywhere), phase 20's image
commands (a and b; none of #1-#6), phase 21's graph commands (none) and
phase 22's CoCa commands (as above) and phase 23b (24 calls of #2's and
#3's contracts a step), and each command of phase 24 in its own process
(as above); the kernels line adds the launches of phases 16-24.  The
line before the last is one JSON object with the six kernels' numbers (the
rows of #1 and #2 with an ``f32`` object too: phase 19e's fp32 ms,
library_ms, bound_ms and bound_by at B=8, S=512, N=12); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import re
import shutil
import signal
import socket
import gc
import io
import random
import string
import subprocess
import sys
import tempfile
import time
import traceback
import types
import zipfile
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.nn.functional as F

import numpy as np

from item_alignment_torch import cli
from item_alignment_torch.config import ModelConfig, OptimizerConfig, TrainConfig
from item_alignment_torch.data.bert_data import (
    align_kwargs,
    build_pretrain_examples,
    pairs_to_field_dataset,
)
from item_alignment_torch.data import native_loader
from item_alignment_torch.data.datasets import ArrayDataset
from item_alignment_torch.data.prepare import load_item_info, read_finetune_tsv
from item_alignment_torch import kge
from item_alignment_torch.data.tokenization import (
    encode_texts,
    load_kg_tokenizers,
    load_text_tokenizer,
    rows_to_one_tower_dataset,
    rows_to_pkgm_dataset,
)
from item_alignment_torch.device import transfer_guard
from item_alignment_torch.engine.checkpoint import load_params
from item_alignment_torch.engine.inference import (
    TwoTowerInference,
    two_tower_encode_fn,
    two_tower_head_fn,
)
from item_alignment_torch.engine.optim import FusedAdamW
from item_alignment_torch.engine.train import Trainer
from item_alignment_torch.kge import evaluation as kev
from item_alignment_torch.kge import sampling as ksamp
from item_alignment_torch.models import encoder
from item_alignment_torch.models.bert_legacy import BertAlignModel
from item_alignment_torch.models.layers import take_rows
from item_alignment_torch.models.multimodal import RobertaImageOneTower
from item_alignment_torch.models.text import (
    PKGMOneTower,
    RobertaOneTower,
    RobertaTwoTower,
)
from item_alignment_torch.ops import _build, _launch, cuda_attention
from item_alignment_torch.ops import cuda_attention_blockwise as cab
from item_alignment_torch.ops import cuda_attention_train as cat
from item_alignment_torch.ops import quant
from item_alignment_torch.ops import sparse
from item_alignment_torch.ops.attention import make_attention_bias
from item_alignment_torch.pipeline.synth_corpus import (
    nfnet_tower,
    random_nfnet,
    timm_nfnet_state_dict,
)
from item_alignment_torch.utils.flops import count_flops

ROOT = Path(__file__).resolve().parent
# H100 SXM datasheet peaks (dense): bf16 tensor cores, fp32 without them, HBM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# TF32 tensor cores (dense): an fp32-accurate product there costs three
# TF32 products (3xTF32), so an fp32 function's least time is the lesser of
# FLOP / 67 TFLOP/s and 3 FLOP / 495 TFLOP/s
PEAK_TF32 = 495e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
KERNEL_CASES = [  # (label, B, S, N, H, dtype, q/k/v split from one fused
    # QKV projection); the first is the main shape
    ("bf16 S=510", 64, 510, 16, 64, torch.bfloat16, False),
    ("bf16 S=255", 64, 255, 16, 64, torch.bfloat16, False),
    ("bf16 S=510 fuse_qkv", 64, 510, 16, 64, torch.bfloat16, True),
    ("bf16 H=32", 4, 130, 4, 32, torch.bfloat16, False),
    ("bf16 H=128", 4, 130, 4, 128, torch.bfloat16, False),
    ("fp32 H=32", 4, 130, 4, 32, torch.float32, False),
    ("fp32 H=64", 4, 130, 4, 64, torch.float32, False),
    ("fp32 H=128", 4, 130, 4, 128, torch.float32, False),
]
LAYERS = 24


class CheckFailed(Exception):
    """A check of the smoke run failed; ``main`` prints it and exits 1."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ragged_mask(B: int, S: int, gen: torch.Generator, lo: int = 1
                ) -> torch.Tensor:
    lens = torch.randint(lo, S + 1, (B,), generator=gen, device="cuda")
    return (torch.arange(S, device="cuda")[None, :] < lens[:, None]).long()


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_card() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card, flush=True)
    print(f"phase 1 card: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    return card


def _ptxas_summary(log: str) -> str:
    """kernel<template integers>: registers and spill bytes, from nvcc
    -Xptxas -v."""
    out, name, spill, stack = [], "?", "", ""
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)", ln)
        if m:
            k = re.search(r"(attn_[a-z0-9_]+?|flash_(?:fwd|dq|dkv)_(?:bf16|f32))"
                          r"I(f|13__nv_bfloat16)?"
                          r"((?:L[ib]\d+E)+)E", m.group(1))
            dtype = {"f": "_f32", "13__nv_bfloat16": "_bf16"}.get(
                k.group(2), "") if k else ""
            ints = ",".join(re.findall(r"L[ib](\d+)E", k.group(3))) if k else ""
            name = f"{k.group(1)}{dtype}<{ints}>" if k else m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
        if m:
            stack, spill = m.group(1), m.group(2)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name} {m.group(1)} regs"
                       + (f" spill {spill} B" if spill not in ("", "0") else "")
                       + (f" stack {stack} B" if stack not in ("", "0") else ""))
            spill = stack = ""
    return "; ".join(out)


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build()
    print(f"phase 2 build: {time.perf_counter() - t0:.3f} s for "
          f"{len(_build.SOURCES)} sources in parallel", flush=True)
    native_loader.get_lib()  # the host library of the data path, by g++
    info = native_loader.BUILD_INFO
    print(f"  csrc/ia_data.cpp (the native data loader): g++ "
          f"{info['seconds']:.3f} s, {info['path']}", flush=True)
    for name in _build.SOURCES:
        info = _build.BUILD_INFO[name]
        print(f"  {name}.cu: {info['seconds']:.3f} s "
              f"({Path(info['path']).name}); ptxas: "
              f"{_ptxas_summary(info['log'])}", flush=True)
    smem = cuda_attention.smem_bytes()  # one entry per bf16 kernel of #1
    print("  fused_attention.cu bf16 dynamic shared memory a block: "
          + ", ".join(f"<{h}> {b} B" for h, b in smem.items()), flush=True)
    print("  flash_blockwise_{fwd,bwd}.cu bf16 dynamic shared memory a "
          "block: " + ", ".join(f"{name}<{h}> {n} B" for (name, h), n
                                in cab.smem_bytes().items()), flush=True)
    # the bf16 kernels of #1 (one per head dim) and of #4 (one per head dim
    # and dropout on or off)
    for source, kernel, count in (("fused_attention", "attn_fwd_bf16", 3),
                                  ("flash_blockwise_fwd", "flash_fwd_bf16", 6)):
        branches = score_branches(_build.BUILD_INFO[source]["path"], kernel)
        for name, stretches in branches.items():
            print(f"  {name} sass: " + ", ".join(
                f"{ex2} exponentials, {br} branches" for ex2, br in stretches)
                + " (stretches between batches of products)", flush=True)
        check(len(branches) == count and all(
            len(st) == 2 and all(ex2 >= 32 and br == 0 for ex2, br in st)
            for st in branches.values()),
            f"{kernel}: branches around the per-score work {branches}")
    spills = [k for k in _ptxas_summary(
        _build.BUILD_INFO["flash_blockwise_fwd"]["log"]).split("; ")
        if k.startswith("flash_fwd_bf16") and "spill" in k]
    check(not spills, f"#4's bf16 kernels spill registers: {spills}")
    # the fp32 kernels, every instantiation: the forward block of #1 and #4
    # (#2's contract) and the dQ and dK/dV kernels (#3's fp32 route, #5 and
    # #6 in fp32): their dynamic shared memory, TF32 products on the tensor
    # cores, no scalar-FMA product loop and no spill
    for source, smem_fn, kernels, count in (
            ("fused_attention", "ia_fused_attention_f32_smem_bytes",
             ("attn_fwd_f32",), 3),
            ("flash_blockwise_fwd", "ia_flash_fwd_f32_smem_bytes",
             ("flash_fwd_f32",), 6),
            ("flash_blockwise_bwd", "ia_flash_bwd_smem_bytes",
             ("flash_dq_f32", "flash_dkv_f32"), 12)):
        info = _build.BUILD_INFO[source]
        smem = getattr(_build.load(source), smem_fn)
        smem.restype = ctypes.c_int
        if source == "flash_blockwise_bwd":
            smem.argtypes = [ctypes.c_int, ctypes.c_int]
            sizes = [(f"{name}<{h}>", smem(i, h)) for i, name in
                     ((2, "dq"), (3, "dkv")) for h in _launch.HEAD_DIMS]
        else:
            smem.argtypes = [ctypes.c_int]
            sizes = [(f"<{h}>", smem(h)) for h in _launch.HEAD_DIMS]
        print(f"  {source}.cu fp32 dynamic shared memory a block: "
              + ", ".join(f"{name} {n} B" for name, n in sizes), flush=True)
        found = {}
        for kernel in kernels:
            counts = tf32_products(info["path"], kernel)
            found.update(counts)
            print(f"  {kernel} sass: " + ", ".join(
                f"<{name.split('<')[1]} {hmma} HMMA.1688.F32.TF32, {ffma} FFMA"
                for name, (hmma, ffma) in counts.items()), flush=True)
        check(len(found) == count and all(hmma > 0 and 3 * ffma < hmma
                                          for hmma, ffma in found.values()),
              f"{source}.cu's fp32 kernels: TF32 products and FFMAs {found}")
        spills = [k for k in _ptxas_summary(info["log"]).split("; ")
                  if k.startswith(kernels) and ("spill" in k or "stack" in k)]
        check(not spills, f"{source}.cu's fp32 kernels spill: {spills}")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
               / "cuobjdump")


def score_branches(lib: str, kernel: str) -> dict:
    """For each instantiation of the template ``kernel`` in the library
    ``lib``: its SASS cut at every wgmma (HGMMA) into stretches, and for
    each stretch that holds exponentials (MUFU.EX2: the per-score work of
    one tile step) the number of exponentials and of branch instructions
    (BRA, BSSY) in it."""
    sass = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name, stretch = {}, None, [0, 0]
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            k = re.search(kernel + r"I((?:L[ib]\d+E)+)E", m.group(1))
            name = (f"{kernel}<{','.join(re.findall(r'L[ib](\d+)E', k.group(1)))}>"
                    if k else None)
            if name:
                out[name] = []
            stretch = [0, 0]
            continue
        if name is None:
            continue
        if "HGMMA" in ln:
            if stretch[0]:
                out[name].append(tuple(stretch))
            stretch = [0, 0]
        elif "MUFU.EX2" in ln:
            stretch[0] += 1
        elif re.search(r"\b(BRA|BSSY)\b", ln):
            stretch[1] += 1
    return out


def tf32_products(lib: str, kernel: str) -> dict:
    """For each instantiation of the template ``kernel`` in ``lib``: the
    TF32 tensor-core products (HMMA.1688.F32.TF32, one mma.sync m16n8k8)
    and the scalar FMAs (FFMA) in its SASS.  A product on the tensor cores
    is three HMMA (3xTF32); a scalar-FMA product loop would show as FFMAs
    beside few or no HMMA."""
    sass = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            k = re.search(kernel + r"I((?:L[ib]\d+E)+)E", m.group(1))
            name = (f"{kernel}<{','.join(re.findall(r'L[ib](\d+)E', k.group(1)))}>"
                    if k else None)
            if name:
                out[name] = [0, 0]
            continue
        if name is None:
            continue
        if "HMMA.1688.F32.TF32" in ln:
            out[name][0] += 1
        elif re.search(r"\bFFMA\b", ln):
            out[name][1] += 1
    return {k: tuple(v) for k, v in out.items()}


def _kernel_inputs(B, S, N, H, dt, fused, gen):
    """q, k, v (split views of one [B, S, 3 N H] projection when ``fused``,
    as ``models/encoder.py`` makes them) and the key bias of a ragged mask
    with a fully masked row (batch row 1) and a large-norm row (2)."""
    qkv = torch.randn(B, S, 3, N, H, device="cuda", generator=gen)
    qkv[2, :, :2] *= 30.0  # a large-norm row: q and k
    if dt == torch.float32:
        # a 1/8 grid makes every q.k exact in fp32, so the comparison does
        # not hinge on the summation order of x30 scores
        qkv = torch.round(qkv * 8) / 8
    qkv = qkv.to(dt)
    if fused:
        q, k, v = (t.reshape(B, S, N, H) for t in
                   qkv.reshape(B, S, 3 * N * H).split(N * H, dim=-1))
    else:
        q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
    mask = ragged_mask(B, S, gen)
    mask[1] = 0  # a fully masked row, as mine's padded tail batch
    return q, k, v, make_attention_bias(mask)


def phase_kernel(gen: torch.Generator) -> dict:
    main = None
    worst = 0.0
    for case in KERNEL_CASES:
        row, err = kernel_case(*case, gen=gen)
        worst = max(worst, err)
        if main is None:
            main = row
    main["max_abs_err"] = worst
    return main


def kernel_case(label, B, S, N, H, dt, fused, gen: torch.Generator,
                phase: str = "phase 3 kernel") -> tuple:
    """The serving kernel (#1) at one shape: held against its plain
    version, then timed beside it, SDPA and the bound.  Returns (the
    kernels line's numbers, max abs err)."""
    q, k, v, bias = _kernel_inputs(B, S, N, H, dt, fused, gen)
    ref = cuda_attention.fused_attention_reference(
        q.float(), k.float(), v.float(), bias)
    out = cuda_attention.fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    uniform = (out[1].float() - v[1].float().mean(0, keepdim=True)
               ).abs().max().item()
    check(bool(torch.isfinite(out).all()), f"kernel {label}: non-finite")
    check(err <= TOL[dt], f"kernel {label}: max abs err {err} > {TOL[dt]}")
    check(uniform <= TOL[dt],
          f"kernel {label}: masked row off the mean of v by {uniform}")
    del out

    iters = 20 if B * S > 10_000 else 50
    ms = cuda_ms(lambda: cuda_attention.fused_attention(q, k, v, bias),
                 iters)
    plain_ms = cuda_ms(
        lambda: cuda_attention.fused_attention_reference(q, k, v, bias),
        3, warmup=1)
    sdpa_mask = bias.to(dt)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=sdpa_mask), iters)
    nbytes = 4 * B * S * N * H * q.element_size() + B * S * 4
    flops = 4 * B * N * S * S * H
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               **_bound(nbytes, flops, dt))
    bound_ms, bound_by = row["bound_ms"], row["bound_by"]
    print(f"{phase} {label} (B={B} S={S} N={N} H={H}): max_abs_err "
          f"{err:.3e} (masked row {uniform:.3e}; tol {TOL[dt]:g}); kernel "
          f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms (kernel/sdpa {ms / library_ms:.3f}), "
          f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    del q, k, v, ref
    return row, err


def pair_batch(B: int, S: int, vocab: int, gen: torch.Generator):
    """Token ids with ragged lengths, pad id 0 after each row's end."""
    mask = ragged_mask(B, S, gen, lo=S // 4)
    ids = torch.randint(5, vocab, (B, S), generator=gen, device="cuda")
    return ids * mask, mask


def phase_cross_encoder(cfg: ModelConfig, seed: int, gen: torch.Generator,
                        batch: int = 8, kernel: int = 0,
                        name: str = "phase 4 cross-encoder") -> int:
    """The one-tower model answers three batches of pair requests (the
    first warms up); ``kernel`` indexes ``counters()``: the kernel every
    layer of every forward must launch."""
    model = RobertaOneTower(cfg, seed=seed).eval()
    S, batches = cfg.pair_seq_len, 2
    reqs = [pair_batch(batch, S, cfg.vocab_size, gen)
            for _ in range(batches + 1)]
    probs, times = [], []
    before = counters()[kernel]
    with torch.inference_mode():
        for ids, mask in reqs:  # the first batch warms up
            t0 = time.perf_counter()
            p = model(ids, mask).probs
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            probs.append(p)
    launches = counters()[kernel] - before
    check(launches == LAYERS * len(reqs),
          f"{name}: {launches} launches of kernel #{kernel + 1} for "
          f"{len(reqs)} forwards of {LAYERS} layers")
    got = torch.cat(probs)
    check(tuple(got.shape) == (batch * len(reqs),)
          and bool(torch.isfinite(got).all()) and got.min() >= 0
          and got.max() <= 1, f"{name}: probs not finite in [0, 1]")

    plain = RobertaOneTower(cfg.replace(use_flash_attention=False),
                            seed=None).eval()
    plain.load_state_dict(model.state_dict())
    with torch.inference_mode():
        ref = torch.cat([plain(ids, mask).probs for ids, mask in reqs])
    diff = (got - ref).abs().max().item()
    check(diff <= 2e-2, f"{name}: kernel vs plain probs differ {diff}")
    served = batch * batches
    pairs_s = served / sum(times[1:])
    print(f"{name}: {served} pairs at S={S} in batches of {batch} in "
          f"{sum(times[1:]) * 1e3:.2f} ms ({pairs_s:.2f} pairs/s; warm-up "
          f"batch {times[0] * 1e3:.1f} ms), {launches} launches of kernel "
          f"#{kernel + 1} ({LAYERS}/forward), probs vs plain attention max "
          f"diff {diff:.3e}", flush=True)
    del model, plain
    torch.cuda.empty_cache()
    return launches


def phase_mining(cfg: ModelConfig, seed: int, gen: torch.Generator) -> int:
    cfg = cfg.replace(interaction_type="two_tower")
    model = RobertaTwoTower(cfg, seed=seed + 1).eval()
    S, n_items, enc_batch, per_item = cfg.item_seq_len, 512, 64, 100
    ids, mask = pair_batch(n_items, S, cfg.vocab_size, gen)
    item_ids = [f"item{i}" for i in range(n_items)]
    batches = [{"input_ids": ids[s:s + enc_batch],
                "attention_mask": mask[s:s + enc_batch]}
               for s in range(0, n_items, enc_batch)]
    inf = TwoTowerInference(two_tower_encode_fn(model),
                            two_tower_head_fn(model), batch_size=4096)

    before = cuda_attention.LAUNCHES
    t0 = time.perf_counter()
    cache = inf.build_cache(item_ids, batches)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    src = torch.arange(n_items).repeat_interleave(per_item).numpy()
    tgt = torch.randint(0, n_items, (n_items * per_item,),
                        generator=torch.Generator().manual_seed(seed)).numpy()
    t0 = time.perf_counter()
    probs = inf.score_pairs(src, tgt)
    score_s = time.perf_counter() - t0
    launches = cuda_attention.LAUNCHES - before
    check(launches == LAYERS * len(batches),
          f"mining: {launches} kernel launches for {len(batches)} encode "
          f"batches of {LAYERS} layers")
    check(tuple(cache.shape) == (n_items, cfg.hidden_size),
          f"mining: cache shape {tuple(cache.shape)}")
    check(probs.shape == (len(src),) and bool(
        ((probs >= 0) & (probs <= 1)).all()), "mining: probs not in [0, 1]")

    idx = slice(0, 8 * per_item, per_item)  # 8 pairs from 8 source items
    s8, t8 = torch.as_tensor(src[idx]).cuda(), torch.as_tensor(tgt[idx]).cuda()
    direct_before = cuda_attention.LAUNCHES
    with torch.inference_mode():
        direct = model(ids[s8], ids[t8], mask[s8], mask[t8]).probs
    direct_launches = cuda_attention.LAUNCHES - direct_before
    check(direct_launches == 2 * LAYERS,
          f"mining: {direct_launches} launches for one two-tower forward")
    diff = (torch.as_tensor(probs[idx]).cuda() - direct).abs().max().item()
    check(diff <= 2e-2, f"mining: cached vs direct probs differ {diff}")
    pairs_s = len(src) / (encode_s + score_s)
    print(f"phase 5 mining: {n_items} items at S={S} encoded in "
          f"{encode_s:.4f} s, {len(src)} pairs scored in {score_s:.4f} s "
          f"({pairs_s:.1f} pairs/s end to end), {launches} launches "
          f"({LAYERS}/encode batch, {direct_launches}/two-tower pair "
          f"forward), cached vs direct probs max diff {diff:.3e}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# kernels with row statistics and dropout: #4 forward, #5 dQ and #6 dK/dV
# (any S), which also serve the contracts of #2 (forward) and #3 (backward)
# at S <= 512
# ---------------------------------------------------------------------------

TRAIN_CASES = [  # (label, B, S, N, H, dtype); the first is the main shape
    ("bf16 S=510", 4, 510, 16, 64, torch.bfloat16),
    ("bf16 H=32", 4, 130, 4, 32, torch.bfloat16),
    ("bf16 H=128", 4, 130, 4, 128, torch.bfloat16),
    ("fp32 H=64", 4, 130, 4, 64, torch.float32),
    ("fp32 H=128", 2, 130, 4, 128, torch.float32),
]
# the plain versions materialise [B, N, S, S] int64 hash words: B = 2 at
# S in the thousands
BLOCKWISE_CASES = [
    ("bf16 S=1024", 2, 1024, 16, 64, torch.bfloat16),
    ("bf16 S=2048", 2, 2048, 16, 64, torch.bfloat16),
    ("bf16 S=1020", 2, 1020, 16, 64, torch.bfloat16),
    ("bf16 H=32", 3, 600, 4, 32, torch.bfloat16),
    ("bf16 H=128", 3, 600, 4, 128, torch.bfloat16),
    ("fp32 H=64", 3, 600, 4, 64, torch.float32),
    ("fp32 H=128", 2, 530, 2, 128, torch.float32),
]


def _blockwise_bwd(rate, seed, q, k, v, bias, g, out, lse):
    """delta, then kernels #5 and #6, as the autograd function runs them."""
    args = (rate, seed, q, k, v, bias, g, lse, cab.flash_delta(g, out))
    return (cab.flash_dq(*args), *cab.flash_dkv(*args))


def _blockwise_bwd_reference(*args):
    return (cab.flash_dq_reference(*args), *cab.flash_dkv_reference(*args))


# how the kernel phases reach a family of kernels: (out, lse) = fwd(rate,
# seed, q, k, v, bias); (dq, dk, dv) = bwd(rate, seed, q, k, v, bias, g, out,
# lse); the plain bwd takes (..., g, lse, delta)
TRAIN_FAMILY = SimpleNamespace(
    name="phase 6 train kernels",
    kernels=("#4 (in #2's route)", "#6 (in #3's route)",
             "#5 (in #3's route)"),
    fwd=cat.fused_attention_dropout_fwd, bwd=cat.fused_attention_dropout_bwd,
    fwd_ref=cat.fused_attention_dropout_reference,
    bwd_ref=cat.fused_attention_dropout_bwd_reference)
BLOCKWISE_FAMILY = SimpleNamespace(
    name="phase 11 blockwise kernels", kernels=("#4", "#6", "#5"),
    fwd=cab.flash_fwd, bwd=_blockwise_bwd,
    fwd_ref=cab.fused_attention_blockwise_reference,
    bwd_ref=_blockwise_bwd_reference)
# grads are held relative to max|ref|: in bf16 keep * p and ds are rounded
# to bf16 before their products (as in the TPU kernel) and the sums run in
# another order than the plain version's; fp32 differs by summation order.
# Each (batch row, head) slice is held against its own max|ref|: the x30
# row's one-hot softmax piles many queries' gradients onto one key, and a
# limit set by that row would pass a wrong gradient in every ordinary row.
# The x30 row is held as a whole against its own max|ref|: there ds =
# p (dp - delta) cancels (dp = delta for a one-hot row), so a head's dq and
# dk are rounding noise of dp - delta in both versions.
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _slice_rel(a: torch.Tensor, b: torch.Tensor, big=None):
    """max|a - b| / max|b| over each (batch row, head) slice of two
    ``[B, S, N, H]`` tensors, and over the whole of batch row ``big`` (the
    x30 row, if any): the worst value and its (b, n), n "all" for row
    ``big``."""
    err = (a.float() - b.float()).abs().amax(dim=(1, 3))
    ref = b.float().abs().amax(dim=(1, 3))
    rel = err / ref.clamp_min(1e-30)
    if big is not None:
        rel[big] = err[big].max() / ref[big].max().clamp_min(1e-30)
    row, n = divmod(int(rel.argmax()), rel.shape[1])
    return rel[row, n].item(), (row, "all" if row == big else n)


def _kernel_keep_bits(fam, seed: int, B: int, S: int, N: int, H: int, dt,
                      rate: float):
    """The keep bits [B, N, S, S] as each CUDA kernel applies them, read back
    with q = 0 (uniform probabilities) and one-hot operands, H keys or
    queries per call: from the forward (out with one-hot v), the dK/dV
    kernel (dv with one-hot g) and the dQ kernel (the sign of dq with
    one-hot k, v = g = e_0)."""
    z = torch.zeros(B, S, N, H, device="cuda", dtype=dt)
    e0 = z.clone()
    e0[..., 0] = 1
    fwd, dkv, dq = (torch.zeros(B, N, S, S, dtype=torch.bool, device="cuda")
                    for _ in range(3))
    for c0 in range(0, S, H):
        idx = torch.arange(c0, min(c0 + H, S), device="cuda")
        one_hot = z.clone()
        one_hot[:, idx, :, idx - c0] = 1
        out, lse = fam.fwd(rate, seed, z, z, one_hot)
        fwd[..., idx] = (out[..., :len(idx)].permute(0, 2, 1, 3) != 0)
        out0, lse0 = fam.fwd(rate, seed, z, z, z)
        dv = fam.bwd(rate, seed, z, z, z, None, one_hot, out0, lse0)[2]
        dkv[:, :, idx, :] = (dv[..., :len(idx)].permute(0, 2, 3, 1) != 0)
        oute, lsee = fam.fwd(rate, seed, z, one_hot, e0)
        g = fam.bwd(rate, seed, z, one_hot, e0, None, e0, oute, lsee)[0]
        dq[..., idx] = (g[..., :len(idx)].permute(0, 2, 1, 3) >= 0)
    torch.cuda.synchronize()
    return fwd, dkv, dq


BIG_ROW = 2  # the x30 row of the training-kernel inputs (modulo B)


def _train_inputs(B, S, N, H, dt, gen):
    q, k, v, g = (torch.randn(B, S, N, H, device="cuda", generator=gen)
                  for _ in range(4))
    q[BIG_ROW % B] *= 30.0  # a large-norm row
    k[BIG_ROW % B] *= 30.0
    if dt == torch.float32:  # exact q.k, as in phase 3
        q, k = torch.round(q * 8) / 8, torch.round(k * 8) / 8
    # no ordinary row so short that its softmax is one-hot
    mask = ragged_mask(B, S, gen, lo=8)
    mask[1] = 0  # a fully masked row
    return (q.to(dt), k.to(dt), v.to(dt), g.to(dt), make_attention_bias(mask))


LSE_TOL = dict(abs=1e-5, masked=1e-4, rel=1e-5)
MASKED_LSE = -1e8  # below this, a row whose keys all carry the -1e9 bias


def lse_errs(lse, ref_lse, big=None) -> tuple:
    """lse against a reference, row by row as each row allows: the largest
    error of an ordinary row; of a fully masked row (lse near -1e9 +
    log S) as lse + 1e9, which sees a shift of the -1e9 row in its last
    places that a relative limit would let through; and of the x30 row
    ``big`` (if any), whose fp32 scores run to the hundreds and differ by
    their ulps, relative to |lse| + 1."""
    d = (lse - ref_lse).abs()
    masked = ref_lse < MASKED_LSE
    rows = torch.ones_like(masked)
    if big is not None:
        rows[big] = False
    ordinary = rows & ~masked
    e_abs = d[ordinary].max().item() if ordinary.any() else 0.0
    e_masked = ((lse[masked] + 1e9) - (ref_lse[masked] + 1e9)).abs().max(
    ).item() if masked.any() else 0.0
    e_rel = ((d[big] / (ref_lse[big].abs() + 1.0)).max().item()
             if big is not None else 0.0)
    return e_abs, e_masked, e_rel


def hold_lse(tag: str, lse, ref_lse, big=None) -> str:
    """``lse_errs`` held to ``LSE_TOL``: an ordinary row within
    ``LSE_TOL["abs"]``, the fully masked row (batch row 1, which must be
    there) within ``LSE_TOL["masked"]``, the x30 row ``big`` within
    ``LSE_TOL["rel"]``.  Returns a text of the errors."""
    e_abs, e_masked, e_rel = lse_errs(lse, ref_lse, big)
    check(bool((ref_lse < MASKED_LSE)[1 % len(ref_lse)].all()),
          f"{tag}: no fully masked row")
    check(e_abs <= LSE_TOL["abs"], f"{tag}: lse err {e_abs} > "
          f"{LSE_TOL['abs']} on the ordinary rows")
    check(e_masked <= LSE_TOL["masked"], f"{tag}: lse + 1e9 err {e_masked} "
          f"> {LSE_TOL['masked']} on the fully masked row")
    check(e_rel <= LSE_TOL["rel"], f"{tag}: lse err {e_rel} > "
          f"{LSE_TOL['rel']} of |lse| + 1 on the x30 row")
    return (f"lse err {e_abs:.3e} (ordinary rows), {e_masked:.3e} (masked "
            f"row, lse + 1e9)" + (f", {e_rel:.3e} of |lse| + 1 (x30 row)"
                                  if big is not None else ""))


def hold_against_plain(tag: str, dt, got, ref):
    """One family's (out, lse, dq, dk, dv) held against the plain versions'
    on the same inputs: out within ``TOL``, lse as ``hold_lse`` holds it,
    dq, dk and dv within ``GRAD_TOL`` of max|ref| in each (batch row, head)
    slice.  Returns a text of the errors and the absolute errors of out and
    of (dq, dk, dv)."""
    (out, lse, *grads), (ref, ref_lse, *ref_grads) = got, ref
    big = BIG_ROW % out.shape[0]
    e_out = (out.float() - ref.float()).abs().max().item()
    e_grad, at, what = max((*_slice_rel(a, b, big), name) for name, a, b in
                           zip(("dq", "dk", "dv"), grads, ref_grads))
    check(all(bool(torch.isfinite(x).all()) for x in got),
          f"{tag}: non-finite")
    check(e_out <= TOL[dt], f"{tag}: out err {e_out} > {TOL[dt]}")
    lse_text = hold_lse(tag, lse, ref_lse, big)
    check(e_grad <= GRAD_TOL[dt], f"{tag}: {what} err {e_grad} > "
          f"{GRAD_TOL[dt]} of max|ref| in the slice (b, n) = {at}")
    text = (f"out err {e_out:.3e} (tol {TOL[dt]:g}), {lse_text}, "
            f"dq/dk/dv worst slice err {e_grad:.3e} of its "
            f"max|ref| ({what} at (b, n) = {at}, x30 row b={big} as a whole; "
            f"tol {GRAD_TOL[dt]:g})")
    return text, e_out, [(a.float() - b.float()).abs().max().item()
                         for a, b in zip(grads, ref_grads)]


def phase_train_kernels(gen: torch.Generator, cases=TRAIN_CASES,
                        fam=TRAIN_FAMILY) -> dict:
    """One family's kernels against their plain versions; returns the worst
    absolute errors of the forward (``fwd_err``) and of dq, dk and dv
    (``bwd_err``: (dq, dk, dv))."""
    err = {"fwd": 0.0, "bwd": [0.0, 0.0, 0.0]}
    for label, B, S, N, H, dt in cases:
        q, k, v, g, bias = _train_inputs(B, S, N, H, dt, gen)
        for rate in (0.0, 0.1):
            seed = 1234 + S
            out, lse = fam.fwd(rate, seed, q, k, v, bias)
            grads = fam.bwd(rate, seed, q, k, v, bias, g, out, lse)
            torch.cuda.synchronize()
            ref, ref_lse = fam.fwd_ref(rate, seed, q, k, v, bias)
            ref_grads = fam.bwd_ref(rate, seed, q, k, v, bias, g, lse,
                                    cat.attention_delta(g, out))
            tag = f"{fam.name} {label} rate {rate}"
            text, e_out, e_grads = hold_against_plain(
                tag, dt, (out, lse, *grads), (ref, ref_lse, *ref_grads))
            uniform = (out[1].float() - v[1].float().mean(0, keepdim=True)
                       ).abs().max().item() if rate == 0 else 0.0
            check(uniform <= TOL[dt], f"{fam.name} {label}: masked row "
                  f"off the mean of v by {uniform}")
            err["fwd"] = max(err["fwd"], e_out)
            err["bwd"] = [max(a, b) for a, b in zip(err["bwd"], e_grads)]
            print(f"{fam.name} {label} (B={B} S={S} N={N} H={H}) "
                  f"rate {rate}: {text}, masked-row err {uniform:.3e}",
                  flush=True)
        # the keep bits of all three CUDA kernels vs the plain hash
        t, _ = cat.dropout_consts(0.1)
        bits = _kernel_keep_bits(fam, 99, B, S, N, H, dt, 0.1)
        ref_bits = cat.keep_mask_reference(99, B, N, S, t, q)
        for what, got in zip(fam.kernels, bits):
            bad = (got != ref_bits).sum().item()
            check(bad == 0, f"{fam.name} {label}: {bad} keep bits of the "
                  f"{what} kernel differ from the plain hash")
        dropped = 1.0 - bits[0].double().mean().item()
        check(abs(dropped - 26 / 256) < 0.01,
              f"{fam.name} {label}: dropped fraction {dropped}")
        print(f"{fam.name} {label}: keep bits of the "
              + ", ".join(fam.kernels) + " kernels equal the plain hash "
              f"({ref_bits.numel()} each); "
              f"dropped fraction {dropped:.5f} (26/256 = {26 / 256:.5f})",
              flush=True)
        del q, k, v, g, out, grads, ref, ref_grads, bits, ref_bits
    return dict(fwd_err=err["fwd"], bwd_err=err["bwd"])


# fp32 cases off the 1/8 grid (label, B, S, N, H, views whose rows are not
# 16-byte aligned): phases 6, 11 and 19e's fp32 shapes at H=64, and in
# phase 6 one H=128 case and one of views that the kernels load by 4-byte
# copies; phase 3 holds #1 at OFFGRID_TRAIN's shapes
OFFGRID_TRAIN = [("fp32 off-grid S=510", 4, 510, 16, 64, False),
                 ("fp32 off-grid H=128", 2, 300, 4, 128, False),
                 ("fp32 off-grid unaligned views", 2, 130, 4, 64, True)]
OFFGRID_BLOCKWISE = [("fp32 off-grid S=600", 2, 600, 4, 64, False)]
OFFGRID_LEGACY = [("fp32 off-grid S=512 N=12", 8, 512, 12, 64, False)]  # 19e


def _offgrid_inputs(B, S, N, H, unaligned, gen):
    """fp32 q, k, v and g from ``randn`` as they come: off the 1/8 grid of
    ``_train_inputs``, so most q.k products are not exact in TF32; no x30
    row; a ragged mask with a fully masked batch row (1).  ``unaligned``:
    each a view of H columns at an offset of one in rows of H + 1."""
    q, k, v, g = (torch.randn(B, S, N, H + unaligned, device="cuda",
                              generator=gen)[..., int(unaligned):]
                  for _ in range(4))
    mask = ragged_mask(B, S, gen, lo=8)
    mask[1] = 0
    return q, k, v, g, make_attention_bias(mask)


def _offgrid_refs(plain, *args) -> tuple:
    """The references of an fp32 kernel on ``_offgrid_inputs``: its plain
    version ``plain(*args)`` on float64-upcast inputs, with the fully
    masked batch row (1) of each output from the same plain version in
    fp32 (TF32 off); and the TF32 witness, that plain version in fp32 with
    TF32 matrix products (TF32 is off again afterwards).  Outputs that are
    None stay None."""
    ref = list(plain(*(a.double() if torch.is_tensor(a) else a
                       for a in args)))
    for r, p32 in zip(ref, plain(*args)):
        if r is not None:
            r[1] = p32[1]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = plain(*args)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return ref, tf32


def hold_fwd_offgrid(tag: str, got, ref, tf32) -> tuple:
    """An fp32 forward's (out, lse or None) on ``_offgrid_inputs`` against
    ``_offgrid_refs``: out within ``TOL[float32]`` of each (batch row,
    head) slice's max|ref| (the inputs have no x30 row), lse as ``hold_lse``
    holds it.  The TF32 witness must read above the limit on out or on
    lse, or these inputs could not tell an fp32-accurate kernel from a TF32
    one.  Returns a text of the errors and the absolute error of out."""
    tol = TOL[torch.float32]
    (out, lse), (ref_out, ref_lse), (w_out, w_lse) = got, ref, tf32
    err, at = _slice_rel(out, ref_out)
    check(bool(torch.isfinite(out).all()), f"{tag}: non-finite out")
    check(err <= tol, f"{tag}: out err {err} > {tol} of max|ref| in the "
          f"slice (b, n) = {at}")
    text = (f"out worst slice err {err:.3e} of its max|ref| (at (b, n) = "
            f"{at}; tol {tol:g})")
    witness = {"out": (_slice_rel(w_out, ref_out)[0], tol)}
    if lse is not None:
        text += ", " + hold_lse(tag, lse, ref_lse)
        witness["lse"] = (lse_errs(w_lse, ref_lse)[0], LSE_TOL["abs"])
    reads = ", ".join(f"{k} {e:.3e}" for k, (e, _) in witness.items())
    above = [k for k, (e, limit) in witness.items() if e > limit]
    check(bool(above), f"{tag}: the TF32 plain version reads {reads}, "
          f"within the limits: these inputs do not tell fp32 from TF32")
    text += (f"; the TF32 witness (plain fp32 with TF32 products) reads "
             f"{reads}, above the limit on {' and '.join(above)}")
    return text, (out.double() - ref_out).abs().max().item()


def phase_offgrid_serving(gen: torch.Generator, cases) -> float:
    """#1 in fp32 on ``_offgrid_inputs`` (``cases`` as ``OFFGRID_TRAIN``,
    g unused) against its plain version on float64-upcast inputs, as
    ``hold_fwd_offgrid`` holds it.  Returns the worst absolute error."""
    worst = 0.0
    for label, B, S, N, H, unaligned in cases:
        q, k, v, _, bias = _offgrid_inputs(B, S, N, H, unaligned, gen)
        out = cuda_attention.fused_attention(q, k, v, bias)
        ref, tf32 = _offgrid_refs(lambda *a: (
            cuda_attention.fused_attention_reference(*a), None), q, k, v, bias)
        tag = f"phase 3 kernel {label}"
        text, err = hold_fwd_offgrid(tag, (out, None), ref, tf32)
        worst = max(worst, err)
        print(f"{tag} (B={B} S={S} N={N} H={H}, randn inputs, a fully "
              f"masked row) vs the plain version in float64: {text}",
              flush=True)
        del q, k, v, out, ref, tf32
    return worst


def phase_offgrid_fp32(gen: torch.Generator, fam, cases) -> tuple:
    """A family's fp32 forward and backward on ``_offgrid_inputs`` at rate 0
    and 0.1, against its plain versions run on float64-upcast inputs (the
    backward with the kernels' own lse and delta): out and lse as
    ``hold_fwd_offgrid`` holds them, dq, dk and dv within
    ``GRAD_TOL[float32]`` of each (batch row, head) slice's max|ref|.  The
    fully masked batch row is held against the plain versions in fp32 (TF32
    off) instead: in fp32 the -1e9 bias swallows q.k, so the contract gives
    that row uniform attention, while float64 keeps q.k and computes
    another function there.  The TF32 witnesses: the same plain versions in
    fp32 with TF32 matrix products must read above the limits, or these
    inputs could not tell an fp32-accurate kernel from a TF32 one.  TF32 is
    off again afterwards.  Returns the worst absolute errors of out and of
    (dq, dk, dv)."""
    tol = GRAD_TOL[torch.float32]
    worst, worst_out = [0.0, 0.0, 0.0], 0.0
    for label, B, S, N, H, unaligned in cases:
        q, k, v, g, bias = _offgrid_inputs(B, S, N, H, unaligned, gen)
        for rate in (0.0, 0.1):
            seed = 4321 + S
            tag = f"{fam.name} {label} rate {rate}"
            out, lse = fam.fwd(rate, seed, q, k, v, bias)
            fwd_text, e_out = hold_fwd_offgrid(tag, (out, lse), *_offgrid_refs(
                lambda *a: fam.fwd_ref(rate, seed, *a), q, k, v, bias))
            worst_out = max(worst_out, e_out)
            grads = fam.bwd(rate, seed, q, k, v, bias, g, out, lse)
            ref, tf32 = _offgrid_refs(
                lambda *a: fam.bwd_ref(rate, seed, *a[:5], lse, a[5]),
                q, k, v, bias, g, cat.attention_delta(g, out))
            err, at, what = max((*_slice_rel(a, b), name) for name, a, b in
                                zip(("dq", "dk", "dv"), grads, ref))
            wit, wat, wwhat = max((*_slice_rel(a, b), name) for name, a, b
                                  in zip(("dq", "dk", "dv"), tf32, ref))
            check(all(bool(torch.isfinite(x).all()) for x in grads),
                  f"{tag}: non-finite")
            check(err <= tol, f"{tag}: {what} err {err} > {tol} of max|ref| "
                  f"in the slice (b, n) = {at}")
            check(wit > tol, f"{tag}: the TF32 plain version reads {wit} <= "
                  f"{tol}: these inputs do not tell fp32 from TF32")
            worst = [max(w, (a.double() - b).abs().max().item())
                     for w, a, b in zip(worst, grads, ref)]
            print(f"{tag} (B={B} S={S} N={N} H={H}, randn inputs, a fully "
                  f"masked row) vs the plain versions in float64: forward "
                  f"{fwd_text}; dq/dk/dv worst slice err {err:.3e} of its "
                  f"max|ref| ({what} at (b, n) = {at}; tol {tol:g}); the TF32 "
                  f"witness (plain fp32 with TF32 products) {wit:.3e} "
                  f"({wwhat} at {wat}), above the limit", flush=True)
        del q, k, v, g, out, grads, ref, tf32
    return worst_out, worst


def full_tile_reference(rate: float, seed: int, q, k, v, bias):
    """Attention with inverted dropout as one full-tile softmax in float64,
    sharing no code with the kernels or their plain versions: the scores
    [B, N, S, S] in fp32, as the contract has them (the -1e9 mask bias
    swallows q.k there, so a fully masked row is uniform), then lse by
    ``torch.logsumexp`` and the softmax in float64, and the keep bits of
    ``keep_mask_reference``.  Returns out [B, S, N, H] and lse [B, N, S] in
    float64."""
    B, S, N, H = q.shape
    t, keep_p = cat.dropout_consts(rate)
    qf, kf = (x.float().permute(0, 2, 1, 3) for x in (q, k))
    scores = qf @ kf.transpose(-1, -2) * (1.0 / math.sqrt(H))
    if bias is not None:
        scores = scores + bias.float().reshape(B, 1, 1, S)
    scores = scores.double()
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    if t:
        p = torch.where(cat.keep_mask_reference(seed, B, N, S, t, q), p,
                        torch.zeros_like(p)) / keep_p
    return (p @ v.double().permute(0, 2, 1, 3)).permute(0, 2, 1, 3), lse


def phase_blockwise_vs_full_tile(gen: torch.Generator) -> None:
    """At B=4, S=510 (the contract of #2, which runs on #4) #4's out and lse
    against ``full_tile_reference`` on the same inputs and seed, at rate 0
    and 0.1, within phase 11's limits (out within ``TOL``, lse as
    ``hold_lse`` holds it): the counterpart of the JAX package's blockwise-vs-
    full-tile test on the TPU, and a check of #4 by other arithmetic than
    its plain version's 64-key online softmax."""
    B, S, N, H, dt = TRAIN_CASES[0][1:]
    q, k, v, _, bias = _train_inputs(B, S, N, H, dt, gen)
    for rate in (0.0, 0.1):
        out, lse = cab.flash_fwd(rate, 77, q, k, v, bias)
        ref, ref_lse = full_tile_reference(rate, 77, q, k, v, bias)
        torch.cuda.synchronize()
        tag = f"#4 vs the full-tile float64 softmax at S={S} rate {rate}"
        e_out = (out.double() - ref).abs().max().item()
        check(bool(torch.isfinite(out).all()) and e_out <= TOL[dt],
              f"{tag}: out {e_out}")
        lse_text = hold_lse(tag, lse, ref_lse, BIG_ROW % B)
        print(f"phase 11 #4 vs a full-tile float64 softmax at B={B} S={S} "
              f"rate {rate}: out err {e_out:.3e} (tol {TOL[dt]:g}), "
              f"{lse_text}", flush=True)
        del out, ref


def _bound(nbytes: int, flops: int, dt) -> dict:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dt] * 1e3
    if dt == torch.float32:
        t_ops = min(t_ops, 3 * flops / PEAK_TF32 * 1e3)
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_blockwise_kernels(gen: torch.Generator, B: int, S: int) -> dict:
    """#4, #5 and #6 each alone at one shape (N=16, H=64, bf16, rate 0.1)
    against their plain versions, SDPA with dropout 0.1 and the bound; the
    plain versions' outputs are also held against the kernels' at this
    shape, as ``hold_against_plain`` holds them.  The products of each body
    are counted: #4 two (4*B*N*S^2*H FLOP), #5 three (6*...), #6 four
    (8*...); the JAX CostEstimate attaches 12*B*N*S^2*H to both backward
    calls."""
    N, H, dt, rate, seed = 16, 64, torch.bfloat16, 0.1, 7
    q, k, v, g, bias = _train_inputs(B, S, N, H, dt, gen)
    out, lse = cab.flash_fwd(rate, seed, q, k, v, bias)
    delta = cab.flash_delta(g, out)
    args = (rate, seed, q, k, v, bias, g, lse, delta)
    ms = (cuda_ms(lambda: cab.flash_fwd(rate, seed, q, k, v, bias), 20),
          cuda_ms(lambda: cab.flash_dq(*args), 20),
          cuda_ms(lambda: cab.flash_dkv(*args), 20))
    delta_ms = cuda_ms(lambda: cab.flash_delta(g, out), 20)
    ref = {}  # the plain versions' outputs, kept from their timed calls
    plain = (
        cuda_ms(lambda: ref.update(fwd=cab.fused_attention_blockwise_reference(
            rate, seed, q, k, v, bias)), 2, warmup=1),
        cuda_ms(lambda: ref.update(dq=cab.flash_dq_reference(*args)), 2,
                warmup=1),
        cuda_ms(lambda: ref.update(dkv=cab.flash_dkv_reference(*args)), 2,
                warmup=1))
    text, e_out, e_grads = hold_against_plain(
        f"phase 11 blockwise kernels B={B} S={S}", dt,
        (out, lse, cab.flash_dq(*args), *cab.flash_dkv(*args)),
        (*ref["fwd"], ref["dq"], *ref["dkv"]))
    print(f"phase 11 blockwise kernels at the timed shape (B={B} S={S} N={N} "
          f"H={H} bf16, rate {rate}) against their plain versions: {text}",
          flush=True)
    del ref
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    mask = bias.to(dt)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, dropout_p=rate)
    sdpa_fwd = cuda_ms(sdpa, 20)
    o = sdpa()
    go = g.transpose(1, 2)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), go,
                                                   retain_graph=True), 20)
    tensor = B * S * N * H * q.element_size()
    stat, key_bias = B * N * S, B * S * 4
    work = B * N * S * S * H
    rows = {}
    for i, (name, n_tensors, stats, products, lib) in enumerate((
            ("fwd", 4, 8 * stat, 2, sdpa_fwd),          # q k v -> out, lse
            ("dq", 5, 12 * stat, 3, sdpa_bwd),          # q k v g lse delta -> dq
            ("dkv", 6, 12 * stat, 4, sdpa_bwd))):       # ... -> dk dv
        nbytes, flops = n_tensors * tensor + stats + key_bias, 2 * products * work
        rows[name] = dict(ms=ms[i], plain_ms=plain[i], library_ms=lib,
                          **_bound(nbytes, flops, dt))
        print(f"phase 11 blockwise kernels timing #{4 + i} {name} (B={B} S={S} "
              f"N={N} H={H} bf16, rate {rate}): kernel "
              f"{rows[name]['ms']:.4f} ms ({flops / ms[i] / 1e9:.1f} "
              f"TFLOP/s), plain {plain[i]:.4f} ms, sdpa "
              + ("forward" if i == 0 else "whole backward") + f" {lib:.4f} ms, "
              f"bound {rows[name]['bound_ms']:.4f} ms "
              f"({rows[name]['bound_by']}; {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)", flush=True)
    backward = ms[1] + ms[2] + delta_ms
    print(f"phase 11 blockwise kernels timing B={B} S={S}: delta "
          f"{delta_ms:.4f} ms (its own CUDA kernel, outside #5 and #6); "
          f"#5 + #6 + delta {backward:.4f} ms = {backward / sdpa_bwd:.3f} x "
          f"sdpa's whole backward", flush=True)
    return dict(rows, fwd_err=e_out, bwd_err=e_grads)


def time_train_kernels(gen: torch.Generator, B: int = 40, S: int = 510,
                       N: int = 16, dt=torch.bfloat16,
                       name: str = "phase 6 train kernels") -> dict:
    """#2's contract (on #4) and #3's at a train shape (phase 6's: B=40,
    S=510, N=16, bf16) against their plain versions, SDPA with dropout 0.1
    and the bound of the function: for #3 10*B*N*S^2*H FLOP (its five
    products) whatever runs it, beside the route's own count (delta, then
    #5's three products and #6's four: 14*B*N*S^2*H), so that a route that
    repeats products reads further from the bound.  The route's parts are
    timed alone too."""
    H, rate, seed = 64, 0.1, 7
    dname = "bf16" if dt == torch.bfloat16 else "fp32"
    q, k, v, g, bias = _train_inputs(B, S, N, H, dt, gen)
    out, lse = cat.fused_attention_dropout_fwd(rate, seed, q, k, v, bias)
    fwd_ms = cuda_ms(lambda: cat.fused_attention_dropout_fwd(
        rate, seed, q, k, v, bias), 20)
    bwd_ms = cuda_ms(lambda: cat.fused_attention_dropout_bwd(
        rate, seed, q, k, v, bias, g, out, lse), 20)
    delta = _launch.launch_delta(g, out)
    args = (rate, seed, q, k, v, bias, g, lse, delta)
    parts = (cuda_ms(lambda: _launch.launch_dq(*args), 20),
             cuda_ms(lambda: _launch.launch_dkv(*args), 20),
             cuda_ms(lambda: _launch.launch_delta(g, out), 20))
    fwd_plain = cuda_ms(lambda: cat.fused_attention_dropout_reference(
        rate, seed, q, k, v, bias), 3, warmup=1)
    bwd_plain = cuda_ms(lambda: cat.fused_attention_dropout_bwd_reference(
        rate, seed, q, k, v, bias, g, lse, cat.attention_delta(g, out)), 3,
        warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    mask = bias.to(dt)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, dropout_p=rate)
    sdpa_fwd = cuda_ms(sdpa, 20)
    o = sdpa()
    go = g.transpose(1, 2)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), go,
                                                   retain_graph=True), 20)
    el = q.element_size()
    stats = B * N * S * 8 + B * S * 4  # lse (float64) and the key bias
    rows = {}
    for what, ms, plain, lib, nbytes, flops in (
            ("fwd", fwd_ms, fwd_plain, sdpa_fwd,
             4 * B * S * N * H * el + stats, 4 * B * N * S * S * H),
            ("bwd", bwd_ms, bwd_plain, sdpa_bwd,
             8 * B * S * N * H * el + stats,
             10 * B * N * S * S * H)):
        rows[what] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          **_bound(nbytes, flops, dt))
        print(f"{name} timing {what} (B={B} S={S} N={N} H={H} "
              f"{dname}, rate {rate}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"sdpa {lib:.4f} ms (kernel/sdpa {ms / lib:.3f}), bound "
              f"{rows[what]['bound_ms']:.4f} ms ({rows[what]['bound_by']}; "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)", flush=True)
    # the route: delta reads g, out and writes delta; #5 and #6 each read
    # q, k, v, g, lse, delta and the bias; #5 writes dq, #6 dk and dv
    tensor = B * S * N * H * el
    route = _bound(13 * tensor + 2 * stats + 3 * 4 * B * N * S,
                   14 * B * N * S * S * H, dt)
    print(f"{name} timing bwd: #3's route #5 {parts[0]:.4f} ms, "
          f"#6 {parts[1]:.4f} ms, delta {parts[2]:.4f} ms; the route's own "
          f"products {14 * B * N * S * S * H / 1e9:.1f} GFLOP "
          f"({14 * B * N * S * S * H / bwd_ms / 1e9:.1f} TFLOP/s at "
          f"{bwd_ms:.4f} ms), its bound {route['bound_ms']:.4f} ms "
          f"({route['bound_by']}) against the function's "
          f"{rows['bwd']['bound_ms']:.4f} ms", flush=True)
    # dQ (three products) and dK/dV (four) alone, against their own bounds
    # and the function's; in fp32 the bounds are those of 3xTF32
    for what, ms, products, n_tensors in (("#5 dQ", parts[0], 3, 5),
                                          ("#6 dK/dV", parts[1], 4, 6)):
        flops = 2 * products * B * N * S * S * H
        own = _bound(n_tensors * tensor + stats + 4 * B * N * S, flops, dt)
        print(f"{name} timing bwd {what} alone ({dname}): {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {ms / own['bound_ms']:.2f} x "
              f"its bound {own['bound_ms']:.4f} ms ({own['bound_by']}), "
              f"{ms / rows['bwd']['bound_ms']:.2f} x the function's "
              f"{rows['bwd']['bound_ms']:.4f} ms", flush=True)
    print(f"{name} timing bwd route (delta + dQ + dK/dV, one call) "
          f"{bwd_ms:.4f} ms = {bwd_ms / sdpa_bwd:.3f} x sdpa's backward "
          f"{sdpa_bwd:.4f} ms, {bwd_ms / rows['bwd']['bound_ms']:.2f} x the "
          f"function's bound", flush=True)
    return dict(rows, parts=parts)


def zero_counters() -> None:
    cuda_attention.LAUNCHES = 0
    cat.FWD_LAUNCHES = cat.BWD_LAUNCHES = 0
    cab.FWD_LAUNCHES = cab.DQ_LAUNCHES = cab.DKV_LAUNCHES = 0


def counters():
    """Launches of kernels #1 to #6 (for #2 and #3: calls of their
    contracts, which run on #4 and on delta, #5 and #6)."""
    return (cuda_attention.LAUNCHES, cat.FWD_LAUNCHES, cat.BWD_LAUNCHES,
            cab.FWD_LAUNCHES, cab.DQ_LAUNCHES, cab.DKV_LAUNCHES)


def per_step(short: int = 0, long: int = 0, fwd_factor: int = 1):
    """The counts of #1-#6 when each layer's attention ran ``short`` times
    through #2/#3 and ``long`` times through #4/#5/#6, the forward kernels
    ``fwd_factor`` times as often (remat replays them)."""
    return (0, LAYERS * short * fwd_factor, LAYERS * short,
            LAYERS * long * fwd_factor, LAYERS * long, LAYERS * long)


@contextlib.contextmanager
def fp32_plain_attention():
    """The plain attention computed in fp32 inside any model: q, k and v
    cast up, the output cast back to the model's dtype.  In a bf16 model
    its backward then rounds neither dp = g v^T nor ds to bf16 (the bf16
    plain path rounds dp before ds = p (dp - delta), where near-uniform
    attention cancels most of it)."""
    plain = encoder.dot_product_attention

    def attend(q, k, v, bias=None, dropout_rate=0.0, dropout_seed=None,
               dtype=torch.float32, **heads):
        return plain(q.float(), k.float(), v.float(), bias, dropout_rate,
                     dropout_seed, torch.float32, **heads).to(dtype)

    encoder.dot_product_attention = attend
    try:
        yield
    finally:
        encoder.dot_product_attention = plain


PLAIN_LAUNCHERS = {"_launch_fwd": cab.fused_attention_blockwise_reference,
                   "_launch_delta": cat.attention_delta,
                   "_launch_dq": cab.flash_dq_reference,
                   "_launch_dkv": cab.flash_dkv_reference}


@contextlib.contextmanager
def plain_blockwise_kernels():
    """The plain versions of #4, #5, #6 and delta in place of their
    launches, inside any model and in its dtype: in bf16 they round keep * p
    and ds to bf16 before their products as the kernels do, so what is left
    between a model on them and the same model on the kernels is the order
    of the sums and the last bit of an exponential."""
    launchers = {name: getattr(cab, name) for name in PLAIN_LAUNCHERS}
    for name, plain in PLAIN_LAUNCHERS.items():
        setattr(cab, name, plain)
    try:
        yield
    finally:
        for name, launch in launchers.items():
            setattr(cab, name, launch)


def _loss_grads(model, ids, mask, labels):
    """Loss, parameter gradients (fp32) and launch counts of one backward."""
    model.zero_grad(set_to_none=True)
    zero_counters()
    loss = model(ids, mask, labels=labels, deterministic=False,
                 dropout_seed=0).loss
    loss.backward()
    launches = counters()
    grads = {}
    for name, p in model.named_parameters():
        check(p.grad is not None, f"grad check: no gradient for {name}")
        grads[name] = p.grad.float()
    return loss.item(), grads, launches


def param_errs(grads: dict, ref: dict) -> list:
    """(||g - g_ref|| / max(||g_ref||, 1e-3 G), name) per parameter,
    sorted, G the largest reference-gradient norm."""
    G = max(r.norm().item() for r in ref.values())
    return sorted(((grads[n] - r).norm().item() / max(r.norm().item(), 1e-3 * G),
                   n) for n, r in ref.items())


def components_along(grads: dict, ref: dict, names) -> list:
    """(<g, g_ref> / <g_ref, g_ref>, name), sorted, for each parameter whose
    name holds one of ``names``."""
    return sorted(((grads[n] * r).sum().item() / (r * r).sum().item(), n)
                  for n, r in ref.items() if any(k in n for k in names))


# Phase 7's limits by compute dtype: ``each`` for every parameter,
# ``medians`` for the median over the layers of the query, key and value
# weights, ``loss`` for |loss - plain loss|.  In bf16 the top layers' query
# and key weight gradients at random init lie below bf16 rounding: one-ulp
# differences in p or ds put them 0.3-0.45 of their norm from plain
# attention in fp32, most likely because q and k share a large component
# across tokens there and ds rounded to bf16 (as the TPU kernel rounds it)
# no longer sums to zero.  So each parameter is held loosely (a gradient
# missing through attention is off by 1.0), and the q/k/v medians tightly
# (a dq or dk off by 10% moves its median from about 0.057 to 0.11;
# phase 10 shows it).
PARAM_TOL = {"float32": dict(each=1e-3, medians=1e-3, loss=1e-4),
             "bfloat16": dict(each=0.7, medians=0.08, loss=1e-2)}
# Phase 13 (batch 2, S=1024) has bf16 limits of its own.  Sound q/k/v
# medians were 0.061-0.075 there and a dq or dk off by 10% gave 0.11 or
# more, so the limit sits between them at 0.09.  Over 1024 keys and two
# pairs a top layer's query or key gradient lies further below bf16
# rounding than at S=510: against plain attention in fp32 one came out 0.79
# of its norm away, a zero gradient being 1.0.  The phase shows the cause
# with a twin, the same model on the plain versions of #4-#6
# (``plain_blockwise_kernels``), which round as the kernels do: the twin is
# as far from plain attention in fp32 as the kernels are, and the kernels as
# far from the twin.  So the parameters named in ``along`` are held one by
# one by their component along the reference gradient, <g, g_ref> / <g_ref,
# g_ref>, within ``along_tol``: rounding noise does not line up with the
# gradient, so a sound gradient reads near 1 however noisy (0.966 to 1.027
# over the kernels and the twin on five batches), a missing one 0, one of
# the wrong sign -1 and a dq or dk off by 10% 0.89 (phase 10 zeroes one
# layer's dq or dk, which the medians do not see).  Every other parameter is
# held within ``each`` as before (the key biases too: their exact gradient
# is zero).  The loss is the mean over two pairs: from plain attention in
# fp32 the kernels moved it by 0.002-0.011 over seven batches and the twin
# by 0.001-0.007, so that limit is 2e-2; the kernels' loss and the twin's
# lay 0.0004-0.005 apart and are held within ``twin_loss``.
LONG_PARAM_TOL = {"float32": PARAM_TOL["float32"],
                  "bfloat16": dict(each=0.7, medians=0.09, loss=2e-2,
                                   along=("attention.query.",
                                          "attention.key.weight"),
                                   along_tol=(0.94, 1.06), twin_loss=1e-2)}
QKV = ("attention.query.weight", "attention.key.weight",
       "attention.value.weight")


def phase_grad_check(cfg: ModelConfig, seed: int, gen: torch.Generator,
                     dtypes=tuple(PARAM_TOL), name: str = "phase 7",
                     B: int = 4, limits=PARAM_TOL) -> None:
    """The backward kernels at rate 0 (#2/#3 at S <= 512, #4/#5/#6 above)
    through one backward of RoBERTa-large (batch ``B``, dropout 0,
    deterministic=False), in fp32 and bf16, against the same
    weights with ``use_flash_attention=False`` and the plain attention
    computed in fp32.  Each parameter's error is ||g - g_ref|| /
    max(||g_ref||, 1e-3 G), G the largest reference-gradient norm; the
    floor covers the key biases, whose gradient is zero in exact arithmetic
    (softmax ignores a shift shared by all keys), so both paths hold only
    rounding noise there.  Limits: ``limits``; the parameters they name in
    ``along`` are held by their component along the reference gradient
    instead, and with a ``twin_loss`` the same model runs once more on the
    plain versions of #4-#6 (``plain_blockwise_kernels``)."""
    cfg = cfg.replace(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    S = cfg.pair_seq_len
    ids, mask = pair_batch(B, S, cfg.vocab_size, gen)
    labels = torch.tensor([0, 1, 1, 0], device="cuda")[:B]
    long = S > 512
    expect = per_step(short=not long, long=long)
    for dtype in dtypes:
        lim = limits[dtype]
        along = lim.get("along", ())
        model = RobertaOneTower(cfg.replace(dtype=dtype), seed=seed)
        plain = RobertaOneTower(cfg.replace(dtype=dtype,
                                            use_flash_attention=False),
                                seed=None)
        plain.load_state_dict(model.state_dict())
        loss, grads, launches = _loss_grads(model, ids, mask, labels)
        with fp32_plain_attention():
            ref_loss, ref, _ = _loss_grads(plain, ids, mask, labels)
        if "twin_loss" in lim:
            with plain_blockwise_kernels():
                twin_loss, twin, _ = _loss_grads(model, ids, mask, labels)
        del model, plain
        torch.cuda.empty_cache()
        check(launches == expect, f"{name} grad check {dtype}: launches "
              f"(#1..#6) {launches}, expected {expect}")
        errs = param_errs(grads, ref)
        held = [(e, n) for e, n in errs if not any(k in n for k in along)]
        medians = {}
        for kind in QKV:
            e = sorted(x for x, n in errs if n.endswith(kind))
            check(len(e) == LAYERS, f"grad check: {len(e)} {kind} parameters")
            medians[kind.split(".")[1]] = e[LAYERS // 2]
        print(f"{name} grad check {dtype}: batch {B} S={S}, loss {loss:.6f} "
              f"vs plain {ref_loss:.6f}; {len(errs)} parameter gradients "
              f"(floor 1e-3 G): median {errs[len(errs) // 2][0]:.3e}, worst "
              f"{errs[-1][0]:.3e} ({errs[-1][1]}), worst of the {len(held)} "
              f"held one by one {held[-1][0]:.3e} ({held[-1][1]}; tol "
              f"{lim['each']:g}); median over "
              f"the layers " + ", ".join(f"{k} {v:.3e}" for k, v in
                                        medians.items())
              + f" (tol {lim['medians']:g}); launches #1..#6 {launches}",
              flush=True)
        if along:
            lo, hi = lim["along_tol"]
            comp = components_along(grads, ref, along)
            print(f"{name} grad check {dtype}: the {len(comp)} parameters "
                  f"named {' or '.join(along)} by their component along the "
                  f"plain gradient: "
                  f"{comp[0][0]:.4f} ({comp[0][1]}) to {comp[-1][0]:.4f} "
                  f"({comp[-1][1]}), limits {lo:g} to {hi:g}", flush=True)
        if "twin_loss" in lim:
            # the cause of the distances above: the twin rounds as the
            # kernels do and lies as far from plain attention in fp32
            worst, at = max((e, n) for e, n in errs
                            if any(k in n for k in along))
            from_twin = {n: e for e, n in param_errs(grads, twin)}
            twin_errs = param_errs(twin, ref)
            on_twin = {n: e for e, n in twin_errs}
            twin_comp = components_along(twin, ref, along)
            print(f"{name} grad check {dtype}: twin on the plain versions of "
                  f"#4-#6: loss {twin_loss:.6f} (the kernels' {loss:.6f}, tol "
                  f"{lim['twin_loss']:g} between them; plain attention in "
                  f"fp32 {ref_loss:.6f}); {at} is {worst:.3e} from plain "
                  f"attention in fp32 on the kernels, "
                  f"{on_twin[at]:.3e} on the twin, "
                  f"and {from_twin[at]:.3e} between the two; the twin's worst "
                  f"{twin_errs[-1][0]:.3e} ({twin_errs[-1][1]}), its "
                  f"components along the plain gradient "
                  f"{twin_comp[0][0]:.4f} to {twin_comp[-1][0]:.4f}",
                  flush=True)
            check(abs(loss - twin_loss) <= lim["twin_loss"], f"grad check "
                  f"{dtype}: losses {loss}, twin {twin_loss} (tol "
                  f"{lim['twin_loss']:g})")
            del twin
        check(abs(loss - ref_loss) <= lim["loss"], f"grad check {dtype}: "
              f"losses {loss}, {ref_loss} (tol {lim['loss']:g})")
        check(held[-1][0] <= lim["each"], f"grad check {dtype}: "
              f"{held[-1][1]} off by {held[-1][0]}")
        check(max(medians.values()) <= lim["medians"], f"grad check {dtype}: "
              f"q/k/v weight medians {medians}")
        if along:
            check(lo <= comp[0][0] and comp[-1][0] <= hi, f"grad check "
                  f"{dtype}: components along the plain gradient "
                  f"{comp[0]}, {comp[-1]} outside {lo:g} to {hi:g}")
        del grads, ref


def phase_remat_check(cfg: ModelConfig, seed: int, gen: torch.Generator) -> None:
    """Remat through the kernels: RoBERTa-large at batch 4 in bf16 with
    dropout 0.1 and one dropout seed; the gradients with remat_policy
    full, dots and mlp equal those without remat within 1e-6 of max|ref|
    (the replay recomputes the same bf16 values with the same masks, since
    every mask is a function of the seed and the site), and the replay
    launches #2's contract once more per layer."""
    cfg = cfg.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    B, S = 4, cfg.pair_seq_len
    ids, mask = pair_batch(B, S, cfg.vocab_size, gen)
    labels = torch.tensor([0, 1, 1, 0], device="cuda")
    ref, state, worst = None, None, {}
    for policy in (None, "full", "dots", "mlp"):
        model = RobertaOneTower(cfg.replace(remat=policy is not None,
                                            remat_policy=policy or "full"),
                                seed=None if state else seed)
        if state:
            model.load_state_dict(state)
        zero_counters()
        loss = model(ids, mask, labels=labels, deterministic=False,
                     dropout_seed=5).loss
        loss.backward()
        launches = counters()
        grads = {n: p.grad for n, p in model.named_parameters()}
        if ref is None:
            ref, state = (loss.item(), grads), model.state_dict()
            check(launches == per_step(short=1),
                  f"remat check: launches without remat {launches}")
            continue
        check(launches == per_step(short=1, fwd_factor=2),
              f"remat check {policy}: launches (#1..#6) {launches}")
        check(loss.item() == ref[0], f"remat check {policy}: loss "
              f"{loss.item()} vs {ref[0]}")
        worst[policy] = max(_rel(grads[n], g) for n, g in ref[1].items())
        check(worst[policy] <= 1e-6, f"remat check {policy}: gradients off "
              f"by {worst[policy]} of max|ref|")
        del model, grads
    print(f"phase 9 remat check bf16 dropout 0.1: batch {B} S={S}, loss "
          f"{ref[0]:.6f} with and without remat; worst gradient diff of "
          f"max|ref|: " + ", ".join(f"{p} {e:.3e}" for p, e in worst.items())
          + f"; launches #2/#3 {launches[1]}/{launches[2]} with remat",
          flush=True)
    del ref, state
    torch.cuda.empty_cache()


# device kernels by what they compute, from their names
KERNEL_GROUPS = (("attention kernels", ("attn_", "flash_")),
                 ("matrix products", ("gemm", "xmma", "nvjet", "cutlass")))
# the attention kernels one by one: #1, #4 (which runs #2's contract), the
# delta kernel, #5 and #6 (which run #3's), by dtype
ATTENTION_KERNELS = ("attn_fwd_bf16", "attn_fwd_f32", "flash_fwd_bf16",
                     "flash_fwd_f32", "attn_delta", "flash_dq_bf16",
                     "flash_dq_f32", "flash_dkv_bf16", "flash_dkv_f32")


def profile_step(step, step_ms: float, kernel_groups=KERNEL_GROUPS,
                 top: int = 0, host_ranges=()) -> str:
    """One more train step (``step()``) under torch.profiler: the device
    time of its kernels by group (``kernel_groups``: (name, substrings of
    a kernel's name) pairs, the rest "other"), the share of the unprofiled
    step time (``step_ms``) in which the device ran none, the six host
    ops whose own kernels took the most device time, with ``top`` the
    ``top`` kernels that took the most, and with ``host_ranges`` the host
    time spent inside the ranges whose names start so (summed over their
    calls; under the profiler, which slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    groups = dict.fromkeys([g for g, _ in kernel_groups] + ["other"], 0.0)
    attention, kernels = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        group = next((g for g, keys in kernel_groups
                      if any(k in name for k in keys)), "other")
        ms = e.time_range.elapsed_us() / 1e3
        groups[group] += ms
        kernels[e.name[:60]] = kernels.get(e.name[:60], 0.0) + ms
        kernel = next((k for k in ATTENTION_KERNELS if k in name), None)
        if kernel:
            attention[kernel] = attention.get(kernel, 0.0) + ms
    busy = sum(groups.values())
    if busy == 0.0:
        return "device time not measured (the profiler recorded no kernels)"
    ops = sorted(((e.self_device_time_total / 1e3, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU), reverse=True)[:6]
    return (f"device busy {busy:.2f} ms of {step_ms:.2f} ms/step (idle share "
            f"{1 - busy / step_ms:.3f}): " + ", ".join(
                f"{g} {ms:.2f} ms" for g, ms in groups.items())
            + "; attention by kernel: " + ", ".join(
                f"{k} {ms:.3f} ms ({ms / busy:.1%})"
                for k, ms in sorted(attention.items(), key=lambda x: -x[1]))
            + "; host ops by own device time: "
            + ", ".join(f"{name} {ms:.2f} ms" for ms, name in ops)
            + ("; kernels: " + ", ".join(
                f"{name} {ms:.2f} ms" for name, ms in sorted(
                    kernels.items(), key=lambda x: -x[1])[:top])
               if top else "")
            + ("; host time in " + ", ".join(
                "{} {:.2f} ms ({} calls)".format(prefix, *_host_range(
                    prof, prefix)) for prefix in host_ranges)
               if host_ranges else ""))


def _host_range(prof, prefix: str) -> tuple:
    """(ms, calls) of the host time inside the profiled ranges whose names
    start with ``prefix``."""
    events = [e for e in prof.key_averages() if e.key.startswith(prefix)]
    return (sum(e.cpu_time_total for e in events) / 1e3,
            sum(e.count for e in events))


def phase_train(cfg: ModelConfig, seed: int, gen: torch.Generator,
                B: int = 40, name: str = "phase 8 training") -> dict:
    """RoBERTa-large at the bench.py recipe (batch ``B``, dropout 0.1, fused
    AdamW with bf16 moments) through the port's Trainer."""
    S, steps = cfg.pair_seq_len, 4  # one warm-up, three timed
    ids, mask = pair_batch(B * steps, S, cfg.vocab_size, gen)
    labels = torch.randint(0, 2, (B * steps,), generator=gen, device="cuda")
    batches = [{"input_ids": ids[i * B:(i + 1) * B].cpu().numpy(),
                "attention_mask": mask[i * B:(i + 1) * B].cpu().numpy(),
                "labels": labels[i * B:(i + 1) * B].cpu().numpy()}
               for i in range(steps)]
    tcfg = TrainConfig(seed=seed, train_batch_size=B, log_steps=10 ** 9,
                       optimizer=OptimizerConfig(
                           learning_rate=5e-5, total_steps=16000, fused=True,
                           state_dtype="bfloat16"))
    mcfg = cfg.replace(hidden_dropout_prob=0.1,
                       attention_probs_dropout_prob=0.1)
    for remat in (False, True):
        model = RobertaOneTower(mcfg.replace(remat=remat), seed=seed)
        trainer = Trainer(model, tcfg).setup()
        watch = {n: p.detach().clone() for n, p in model.named_parameters()
                 if n.endswith(("out_proj.weight", "layer_0.attention.query.weight",
                                "word_embeddings.weight"))}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        losses, times = [], []
        try:
            for batch in batches:
                t0 = time.perf_counter()
                loss = trainer.train_step(batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(loss.item())
        except torch.cuda.OutOfMemoryError:
            print(f"{name}: batch {B} does not fit with "
                  f"remat={remat}; retrying with remat", flush=True)
            del model, trainer, watch
            torch.cuda.empty_cache()
            check(not remat, f"{name}: out of memory even with remat")
            continue
        launches = counters()
        break
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"{name}: losses {losses}")
    check(len(set(losses)) == len(losses), f"{name}: losses repeat {losses}")
    moved = {n: (p.detach() - watch[n]).abs().max().item()
             for n, p in model.named_parameters() if n in watch}
    check(len(moved) == 3 and all(v > 0 for v in moved.values()),
          f"{name}: parameters did not move {moved}")
    # remat recomputes each layer's forward, its kernel included, in the
    # backward
    long = S > 512
    expect = per_step(short=steps * (not long), long=steps * long,
                      fwd_factor=2 if remat else 1)
    check(launches == expect, f"{name}: launches (#1..#6) {launches} "
          f"over {steps} steps, expected {expect}")
    step_ms = sum(times[1:]) / (steps - 1) * 1e3
    profiled = profile_step(lambda: trainer.train_step(batches[-1]),
                            step_ms)
    flop_line = step_flop(trainer, batches[-1], mcfg, B, remat, step_ms)
    print(f"{name}: RoBERTa-large batch {B} S={S} dropout 0.1, "
          f"fused AdamW bf16 moments, remat={remat}: losses "
          f"{[round(x, 6) for x in losses]}; {step_ms:.2f} ms/step over "
          f"{steps - 1} timed steps ({B / step_ms * 1e3:.2f} train pairs/s; "
          f"warm-up step {times[0] * 1e3:.1f} ms); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches #1..#6 {launches}; "
          f"max |update| "
          + ", ".join(f"{n.split('.')[-2]} {v:.3e}" for n, v in moved.items()),
          flush=True)
    print(f"{name}: profile of one more step: {profiled}", flush=True)
    print(f"{name}: {flop_line}; {card_line()}", flush=True)
    del model, trainer
    torch.cuda.empty_cache()
    return dict(launches=launches)


def step_flop(trainer, batch, cfg: ModelConfig, B: int, remat: bool,
              step_ms: float) -> str:
    """One more train step under ``utils/flops.count_flops``: its model
    FLOP must be within 1% above three times tests/test_flops.py:70's hand
    count of the encoder's forward (the forward and the backward's two
    transposed products of each), plus, under remat, the attention's
    products, which the "dots" policy replays (it keeps the dense ones)."""
    flop = count_flops(lambda: trainer.train_step(batch))
    S, H, L = cfg.pair_seq_len, cfg.hidden_size, cfg.num_hidden_layers
    attn = L * 4 * B * S * S * H
    hand = L * 2 * B * S * (4 * H * H + 2 * H * cfg.intermediate_size) + attn
    check(not remat or cfg.remat_policy == "dots",
          f"remat policy {cfg.remat_policy}: the count expects dots")
    expect = 3 * hand + (attn if remat else 0)
    check(expect <= flop <= 1.01 * expect,
          f"model FLOP of a step {flop} vs {expect} (3 x the encoder's hand "
          f"count{' + the remat replay' if remat else ''}; within 1% above)")
    mfu = flop / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    return (f"model FLOP of a step (utils/flops.count_flops, forward, "
            f"backward{' and the remat replay' if remat else ''}) "
            f"{flop / 1e12:.4f} TFLOP, {flop / expect:.5f} x the hand count "
            f"{expect / 1e12:.4f}; at {step_ms:.2f} ms/step "
            f"{flop / (step_ms / 1e3) / 1e12:.1f} TFLOP/s, {mfu:.4f} of "
            f"989 TFLOP/s")


def phase_repeat(cfg: ModelConfig, seed: int, gen: torch.Generator, B: int,
                 layers: int = 2, runs: int = 4) -> None:
    """One batch's gradients, taken ``runs`` times with one dropout seed at
    a train step's batch size (full width, ``layers`` layers), must be equal
    bit for bit: resume rests on it.  torch's own embedding backward fails
    this at these sizes (its sum over a row's duplicates changes from run
    to run); ``models/layers.py:embedding_lookup`` is what passes it."""
    mcfg = cfg.replace(num_hidden_layers=layers)
    model = RobertaOneTower(mcfg, seed=seed)
    ids, mask = pair_batch(B, cfg.pair_seq_len, cfg.vocab_size, gen)
    labels = torch.randint(0, 2, (B,), generator=gen, device="cuda")
    first, differing = None, set()
    for _ in range(runs):
        model.zero_grad(set_to_none=True)
        model(ids, mask, labels=labels, deterministic=False,
              dropout_seed=5).loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        if first is None:
            first = grads
        differing |= {n for n, g in grads.items()
                      if not torch.equal(g, first[n])}
    check(not differing, f"repeat: gradients differ between {runs} runs of "
          f"one step at batch {B} S={cfg.pair_seq_len}: {sorted(differing)}")
    print(f"phase 15 repeatability: {len(first)} gradients of one step at "
          f"batch {B} S={cfg.pair_seq_len} ({int((ids == 0).sum())} pad "
          f"tokens of {ids.numel()}) equal bit for bit over {runs} runs",
          flush=True)
    del model, first
    torch.cuda.empty_cache()


def phase_resume(cfg: ModelConfig, seed: int, gen: torch.Generator,
                 layers: int = 4) -> None:
    """``Trainer.fit`` with checkpoints: two epochs of two steps at full
    width and ``layers`` layers (a full-depth state is about 2.8 GB on
    disk), uninterrupted, against a run stopped after the first epoch and
    resumed by a new Trainer with ``resume=True``.  Parameters and optimizer
    moments must be equal bit for bit, and the resumed run must go through
    the long-sequence kernels."""
    B, S, steps = 4, cfg.pair_seq_len, 2
    mcfg = cfg.replace(num_hidden_layers=layers, hidden_dropout_prob=0.1,
                       attention_probs_dropout_prob=0.1)
    ids, mask = pair_batch(B * steps, S, cfg.vocab_size, gen)
    labels = torch.randint(0, 2, (B * steps,), generator=gen, device="cuda")
    ds = ArrayDataset({"input_ids": ids.cpu().numpy(),
                       "attention_mask": mask.cpu().numpy(),
                       "labels": labels.cpu().numpy()})

    def fit(epochs, ckpt=None, resume=False):
        tcfg = TrainConfig(seed=seed, train_batch_size=B, eval_batch_size=B,
                           num_epochs=epochs, log_steps=10 ** 9,
                           checkpoint_dir=ckpt, resume=resume,
                           optimizer=OptimizerConfig(
                               learning_rate=5e-5, total_steps=2 * steps,
                               fused=True, state_dtype="bfloat16"))
        trainer = Trainer(RobertaOneTower(mcfg, seed=seed), tcfg)
        return trainer, trainer.fit(ds, ds)

    full, full_out = fit(2)
    with tempfile.TemporaryDirectory() as ckpt:
        _, first = fit(1, ckpt)
        saved = sorted(p.name for p in Path(ckpt).iterdir())
        nbytes = sum(p.stat().st_size for p in Path(ckpt).iterdir())
        zero_counters()
        resumed, second = fit(2, ckpt, resume=True)
        launches = counters()
    check([h["epoch"] for h in second["history"]] == [1],
          f"resume: epochs run after the restart {second['history']}")
    check(resumed.step == full.step == 2 * steps,
          f"resume: steps {resumed.step} vs {full.step}")
    # one epoch of `steps` train steps, then one eval pass of `steps` batches
    expect = (0, 0, 0, 2 * layers * steps, layers * steps, layers * steps)
    check(launches == expect, f"resume: launches (#1..#6) {launches}, "
          f"expected {expect}")
    losses = [h["loss"] for h in first["history"] + second["history"]]
    check(losses == [h["loss"] for h in full_out["history"]],
          f"resume: losses {losses} vs {full_out['history']}")
    worst = 0.0
    a, b = full.model.state_dict(), resumed.model.state_dict()
    for name in a:
        worst = max(worst, (a[name] - b[name]).abs().max().item())
    oa, ob = full.optimizer.state_dict(), resumed.optimizer.state_dict()
    for kind in ("mu", "nu"):
        for name, m in oa[kind].items():
            check(m.dtype == ob[kind][name].dtype == torch.bfloat16,
                  f"resume: moment {kind} {name} is {ob[kind][name].dtype}")
            worst = max(worst, (m.float() - ob[kind][name].float()
                                ).abs().max().item())
    check(worst == 0.0, f"resume: resumed state differs by {worst}")
    print(f"phase 15 checkpoint and resume: {layers} layers at full width, "
          f"batch {B} S={S} dropout 0.1, bf16 moments, 2 epochs of {steps} "
          f"steps; checkpoint files {saved} ({nbytes / 2 ** 20:.1f} MiB); "
          f"resumed run ran epoch [1], losses {[round(x, 6) for x in losses]} "
          f"equal the uninterrupted run's, parameters and moments equal bit "
          f"for bit (max diff {worst}); launches #1..#6 after the restart "
          f"{launches}", flush=True)
    del full, resumed
    torch.cuda.empty_cache()



# wrong backward kernels: (what, the kernel, the index of the output among
# its launcher's, factor, spare the x30 row, the one launch of each rerun
# made wrong (None: all), the phases that must fail).  The last two zero a
# gradient in one layer of 24, which no median over the layers sees.  "#3"
# is #3's route (delta, #5, #6 as ``cat._launch_bwd`` runs them, S <= 512);
# "#5" and "#6" are the blockwise wrappers' launchers (S > 512).
MUTATIONS = (
    ("#3 dv x1.03 off the x30 row", "#3", 2, 1.03, True, None, ("6",)),
    ("#3 dq zeroed", "#3", 0, 0.0, False, None, ("6", "7")),
    ("#3 dq x0.9", "#3", 0, 0.9, False, None, ("6", "7")),
    ("#3 dk x0.9", "#3", 1, 0.9, False, None, ("6", "7")),
    ("#3 dv x0.95", "#3", 2, 0.95, False, None, ("6", "7")),
    ("#5 dq x0.9", "#5", 0, 0.9, False, None, ("11", "13")),
    ("#6 dk x0.9", "#6", 0, 0.9, False, None, ("11", "13")),
    ("#6 dv x0.95", "#6", 1, 0.95, False, None, ("11", "13")),
    ("#5 dq zeroed in its 6th launch", "#5", 0, 0.0, False, 5, ("13",)),
    ("#6 dk zeroed in its 6th launch", "#6", 0, 0.0, False, 5, ("13",)),
)
LAUNCHERS = {"#3": (cat, "_launch_bwd"), "#5": (cab, "_launch_dq"),
             "#6": (cab, "_launch_dkv")}


def phase_sensitivity(cfg: ModelConfig, long_cfg: ModelConfig, seed: int,
                      gen: torch.Generator) -> None:
    """The checks can fail: with a backward kernel's output made wrong after
    each launch (one of dq, dk, dv scaled), the kernel phase at its main
    shape (6 or 11) and the gradient check in bf16 (7, or 13 at S=1024) must
    each fail where ``MUTATIONS`` lists them; a gradient zeroed in one layer
    of 24 must fail phase 13, which holds each query and key parameter by its
    component along the plain gradient.  The launches made here count on no
    path."""
    rerun = {
        "6": lambda what: phase_train_kernels(gen, TRAIN_CASES[:1]),
        "11": lambda what: phase_train_kernels(gen, BLOCKWISE_CASES[:1],
                                               BLOCKWISE_FAMILY),
        "7": lambda what: phase_grad_check(
            cfg, seed, gen, ("bfloat16",), f"phase 10 ({what}): phase 7"),
        "13": lambda what: phase_grad_check(
            long_cfg, seed, gen, ("bfloat16",),
            f"phase 10 ({what}): phase 13", B=2, limits=LONG_PARAM_TOL),
    }
    for what, kernel, i, factor, spare_big, only, phases in MUTATIONS:
        module, attr = LAUNCHERS[kernel]
        launch = getattr(module, attr)
        seen = []  # the launches of one rerun

        def wrong(*args, i=i, factor=factor, spare_big=spare_big,
                  only=only, launch=launch, seen=seen):
            result = launch(*args)
            seen.append(None)
            if only not in (None, len(seen) - 1):
                return result
            grads = list(result) if isinstance(result, tuple) else [result]
            x = grads[i].clone()
            rows = [b for b in range(x.shape[0])
                    if not (spare_big and b == BIG_ROW % x.shape[0])]
            x[rows] *= factor
            grads[i] = x
            return tuple(grads) if isinstance(result, tuple) else grads[0]

        caught = {}
        setattr(module, attr, wrong)
        try:
            for phase in phases:
                seen.clear()
                try:
                    rerun[phase](what)
                    caught[phase] = None
                except CheckFailed as e:
                    caught[phase] = str(e)
        finally:
            setattr(module, attr, launch)
        print(f"phase 10 sensitivity {what}: " + "; ".join(
            f"phase {ph} " + (f"failed ({msg})" if msg else "PASSED")
            for ph, msg in caught.items()), flush=True)
        check(all(caught.values()), f"sensitivity: {what} passed a check")
    print("phase 10 sensitivity: every wrong backward failed its checks",
          flush=True)


# ---------------------------------------------------------------------------
# phase 16: the entry points, ``ia-torch finetune-text / mine / pred-text``
# ---------------------------------------------------------------------------

VOCAB_ROWS = 21128  # configs/roberta_large.json's vocab_size
INT8_CACHE_TOL = 0.01   # tests/test_images_and_inference.py:155
INT8_DENSE_TOL = 0.05   # tests/test_quant.py:82
# pred-text's pooled features, int8 vs bf16, relative (Frobenius): on
# random RoBERTa-large weights the int8 encoder's last hidden states sit
# 4.3% from fp32's, bf16's 1.3% at layer 24 (PERF.md §6)
POOLED_INT8_REL = 0.08
# the schedule horizon of phase 8 and bench.py: with --epochs 1 alone the
# schedule would decay over these few steps at the full learning rate
TOTAL_STEPS = "16000"
# phase 16b: --scan_steps 8 and 1 over 18 steps logged every 3: chunks of
# 8, 8, 1, 1, logged where a chunk end crosses a multiple of 3, as JAX's
# Trainer logs (item_alignment_tpu/engine/train.py:282)
SCAN_RUN_STEPS, SCAN_LOG_STEPS = 18, 3


def chunk_log_steps(steps: int, scan: int, log: int) -> list:
    """The steps at which the JAX Trainer logs the loss: after each chunk
    (full chunks of ``scan``, then one step each) whose end crosses a
    multiple of ``log``."""
    ends = list(range(scan, steps - steps % scan + 1, scan)) + list(
        range(steps - steps % scan + 1, steps + 1))
    return [e for prev, e in zip([0] + ends, ends) if e // log > prev // log]


def check_transfer_guard() -> str:
    """Under ``--xfer_guard``'s guard a pinned non-blocking copy goes
    through and a pageable (synchronizing) one raises; the guard leaves
    the sync debug mode as it found it.  Returns what the pageable copy
    did."""
    with transfer_guard(torch.device("cuda")):
        torch.ones(4).pin_memory().to("cuda", non_blocking=True)
    try:
        with transfer_guard(torch.device("cuda")):
            torch.ones(4).to("cuda")
        pageable = "went through"
    except RuntimeError as e:
        pageable = f"raised ({str(e).splitlines()[0]})"
    check(pageable.startswith("raised")
          and torch.cuda.get_sync_debug_mode() == 0,
          f"phase 16: a pageable copy under the guard {pageable}")
    return pageable


def h2d_copies(run) -> dict:
    """``run()`` under torch.profiler: its host-to-device copies counted by
    the profiler's name for them (``Memcpy HtoD (Pinned -> Device)`` for
    the staged batches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    copies = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name.startswith(
                "Memcpy HtoD"):
            copies[e.name] = copies.get(e.name, 0) + 1
    return copies


def check_int8_products(gen: torch.Generator) -> str:
    """``ops/quant.int8_mm`` on the card at the encoder's product shapes
    (an encode batch of 64 x 255 tokens: K, N = 1024, 4096) and at a row
    count ``torch._int_mm`` needs padded: equal to the exact product."""
    out = []
    for M, K, N in ((64 * 255, 1024, 4096), (64 * 255, 4096, 1024),
                    (12, 1024, 1024)):
        a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        got = quant.int8_mm(a, b.t())
        ref = a.double() @ b.double().t()  # exact: |sum| < 2**53
        check(got.dtype == torch.int32 and bool((got.double() == ref).all()),
              f"phase 16: int8_mm at {M}x{K}x{N} is not exact")
        out.append(f"{M}x{K}x{N}")
    return ", ".join(out)


# the stand-in for jieba where the card's machine has none: phase 24 also
# writes it as a module file for its child processes
JIEBA_STAND_IN = '''"""A whitespace stand-in for jieba (chip_smoke.py's segmenter)."""
STAND_IN = True


def cut(text):
    return iter(text.split())
'''


@contextlib.contextmanager
def segmenter(module_dir: Path | None = None):
    """jieba where it is installed; otherwise a stand-in module whose
    ``cut`` splits on whitespace, registered for this phase only and, with
    ``module_dir``, written there as ``jieba.py`` for the phase's child
    processes (phase 24 puts the directory on their ``PYTHONPATH``: the
    tokenizer pools spawn workers, which do not inherit ``sys.modules``).
    Phase 16 holds the card path against direct calls on the same token
    ids, so the segmentation only has to be the same on both sides; the
    CPU tests hold the port's tokenization against JAX's with the real
    jieba."""
    try:
        import jieba
    except ImportError:
        jieba = None
    if getattr(jieba, "STAND_IN", False):
        yield "a whitespace stand-in (jieba is not installed)"
        return
    if jieba is not None:
        yield f"jieba {getattr(jieba, '__version__', '')}".strip()
        return
    stand_in = types.ModuleType("jieba")
    exec(JIEBA_STAND_IN, stand_in.__dict__)
    sys.modules["jieba"] = stand_in
    if module_dir is not None:
        (module_dir / "jieba.py").write_text(JIEBA_STAND_IN)
    try:
        yield "a whitespace stand-in (jieba is not installed)"
    finally:
        del sys.modules["jieba"]


def smoke_vocab() -> list:
    """A BERT-Chinese-shaped vocab of VOCAB_ROWS rows: the special tokens
    at their usual ids, ASCII, then CJK characters each with its ``##``
    continuation, ``<S>`` last."""
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + list(string.punctuation + string.digits
                    + string.ascii_lowercase))
    k = 0
    while len(vocab) < VOCAB_ROWS - 1:
        c = chr(0x4E00 + k)
        vocab += [c, "##" + c][: VOCAB_ROWS - 1 - len(vocab)]
        k += 1
    return vocab + ["<S>"]


def write_smoke_corpus(root: Path, seed: int, n_items: int = 1024,
                       n_train: int = 200, n_test: int = 40,
                       n_mine: int = 512, per_item: int = 10) -> dict:
    """item_info.jsonl, labelled train pairs, test pairs and a mining pair
    list, from ``seed``: CJK titles of 3-20 words and 5-30 key:value pvs an
    item (40 keys a category, 8 values a key), four categories."""
    rng = random.Random(seed)
    chars = [chr(0x4E00 + k) for k in range(3000)]

    def word(lo=1, hi=4):
        return "".join(rng.choice(chars) for _ in range(rng.randint(lo, hi)))

    keys = {c: [word(2, 3) for _ in range(40)] for c in "abcd"}
    values = {k: [word() for _ in range(8)] for ks in keys.values()
              for k in ks}
    raw = root / "raw"
    raw.mkdir(parents=True)
    cates = []
    with open(raw / "item_info.jsonl", "w", encoding="utf-8") as w:
        for i in range(n_items):
            cate = "abcd"[i % 4]
            cates.append(cate)
            pvs = "#;#".join(f"{k}#:#{rng.choice(values[k])}" for k in
                             rng.sample(keys[cate], rng.randint(5, 30)))
            w.write(json.dumps({
                "item_id": f"i{i}", "cate_name": cate, "cate_id": cate,
                "industry_name": "ind",
                "title": " ".join(word() for _ in range(rng.randint(3, 20))),
                "item_pvs": pvs, "sku_pvs": ""}, ensure_ascii=False) + "\n")

    def pairs(path, n, labelled):
        with open(path, "w") as w:
            for _ in range(n):
                a = rng.randrange(n_items)
                b = rng.choice([j for j in range(a % 4, n_items, 4) if j != a])
                w.write(json.dumps({"src_item_id": f"i{a}",
                                    "tgt_item_id": f"i{b}",
                                    "item_label": str(rng.randint(0, 1))
                                    if labelled else "0"}) + "\n")

    pairs(raw / "item_train_pair.jsonl", n_train, True)
    pairs(raw / "item_test_pair.jsonl", n_test, False)
    with open(root / "mine_pairs.jsonl", "w") as w:
        for a in range(n_mine):
            for b in rng.sample(range(n_mine), per_item):
                w.write(json.dumps({"src_item_id": f"i{a}",
                                    "tgt_item_id": f"i{b}"}) + "\n")
    (root / "vocab").mkdir()
    (root / "vocab" / "vocab.txt").write_text("\n".join(smoke_vocab()),
                                              encoding="utf-8")
    return {"raw": raw, "vocab": root / "vocab",
            "mine_pairs": root / "mine_pairs.jsonl"}


def run_cli(argv: list) -> tuple:
    """``cli.main(argv)`` in this process; returns (the JSON lines it
    printed, wall seconds).  A non-zero return is a failed check."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"ia-torch {argv[0]} returned {rc}")
    gc.collect()
    torch.cuda.empty_cache()
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")], wall


def _jsonl_probs(path) -> tuple:
    rows = [json.loads(line) for line in open(path)]
    return rows, np.array([float(r["tgt_item_emb"].strip("[]"))
                           for r in rows])


def phase_entry_points(seed: int, card: str) -> tuple:
    """Phase 16: ``finetune-text`` (one-tower, then two-tower), ``mine``
    three ways and ``pred-text`` two ways through ``cli.main`` at full
    RoBERTa-large width in bf16 with random weights; each output is held
    against direct model calls or the bf16 run.  Returns the launches of
    #1-#6 over the phase."""
    counts = [0] * 6

    def tally(before):
        for k, (a, b) in enumerate(zip(before, counters())):
            counts[k] += b - a

    products = check_int8_products(torch.Generator(device="cuda")
                                   .manual_seed(seed))
    with segmenter() as seg, tempfile.TemporaryDirectory() as tmp:
        print(f"phase 16 entry points: segmenter {seg}", flush=True)
        root = Path(tmp)
        files = write_smoke_corpus(root, seed)
        raw_cfg = json.loads((ROOT / "configs" / "roberta_large.json"
                              ).read_text())
        cfg_json = root / "roberta_large_bf16.json"
        cfg_json.write_text(json.dumps(dict(raw_cfg, dtype="bfloat16")))
        processed = root / "processed"
        prep, t_prep = run_cli(["prepare", "--data_dir", str(files["raw"]),
                                "--output_dir", str(processed),
                                "--seed", str(seed)])
        walls = {"prepare": t_prep}
        ft = ["finetune-text", "--data_dir", str(processed),
              "--output_dir", str(root / "out"),
              "--vocab_path", str(files["vocab"]),
              "--model_name", "roberta_large", "--config_file", str(cfg_json),
              "--max_seq_len", "50", "--max_seq_len_pv", "205",
              "--train_batch_size", "40", "--eval_batch_size", "40",
              "--epochs", "1", "--learning_rate", "5e-5",
              "--opt_state_dtype", "bfloat16", "--bf16", "--log_steps", "1",
              "--total_steps", TOTAL_STEPS, "--seed", str(seed)]

        # 1. one-tower: train, evaluate, predict
        n_train = len(read_finetune_tsv(prep[-1]["train"]))
        n_valid = len(read_finetune_tsv(prep[-1]["valid"]))
        test_rows = read_finetune_tsv(prep[-1]["test"])
        steps = n_train // 40
        zero_counters()
        out, walls["finetune-text one-tower"] = run_cli(
            ft + ["--do_train", "--do_eval", "--do_pred",
                  "--log_dir", str(root / "logs")])
        one = counters()
        tally((0,) * 6)
        scalars = [json.loads(line) for line in open(root / "logs" /
                                                     "scalars.jsonl")]
        losses = [s["value"] for s in scalars if s["tag"] == "train/loss"]
        stamps = [s["time"] for s in scalars if s["tag"] == "train/loss"]
        check(len(losses) == steps and all(map(math.isfinite, losses)),
              f"phase 16: one-tower losses {losses} over {steps} steps")
        n_eval = 2 * -(-n_valid // 40) + -(-len(test_rows) // 40)
        check(one == (LAYERS * n_eval, LAYERS * steps, LAYERS * steps, 0, 0,
                      0), f"phase 16: one-tower launches (#1..#6) {one}: "
              f"{steps} train steps, {n_eval} eval/pred batches")
        step_ms = 1e3 * (stamps[-1] - stamps[0]) / (len(stamps) - 1)
        pred = [o for o in out if "prediction_file" in o][-1]
        check(pred["prediction_split"] == "test",
              f"phase 16: predicted on {pred['prediction_split']}")
        rows, probs = _jsonl_probs(pred["prediction_file"])
        run_dir = Path(pred["prediction_file"]).parent
        tok = load_text_tokenizer(str(files["vocab"]))
        mcfg = ModelConfig.from_json(str(cfg_json), vocab_size=len(tok),
                                     max_seq_len=50, max_seq_len_pv=205)
        check(len(tok) == VOCAB_ROWS and mcfg.num_hidden_layers == LAYERS
              and mcfg.hidden_size == 1024, "phase 16: not RoBERTa-large")
        model = RobertaOneTower(mcfg, seed=None).eval()
        model.load_state_dict(load_params(str(run_dir / "best_f1.pt")))
        ds = rows_to_one_tower_dataset(test_rows, tok, 50, 205)
        direct = []
        with torch.inference_mode():
            for batch, meta in ds.batches(40):
                feed = {k: torch.from_numpy(v).long().cuda()
                        for k, v in batch.items() if k != "labels"}
                direct.append(model(**feed).probs.float().cpu().numpy()
                              [: meta["n_valid"]])
        del model
        diff = np.abs(np.concatenate(direct) - probs).max()
        check(len(rows) == len(test_rows) and np.isfinite(probs).all()
              and diff <= 2e-2, f"phase 16: prediction file vs a direct "
              f"forward of best_f1.pt differ by {diff}")
        print(f"phase 16 finetune-text one-tower: batch 40 S=510 bf16, "
              f"{steps} steps, losses {[round(x, 6) for x in losses]}, "
              f"{step_ms:.2f} ms/step through the CLI (host clock between "
              f"logged losses), launches #1..#6 {one} (#2/#3 {LAYERS}/step), "
              f"{len(rows)} test predictions vs a direct forward of "
              f"best_f1.pt max diff {diff:.3e}; {card}", flush=True)

        # 1b. --scan_steps 8 and 1 on the same 18 batches: the parameters
        # bit for bit, the losses logged at JAX's chunk ends, one staged
        # host-to-device copy a key a chunk (under the profiler, in a third
        # run), ms/step of each between the first and last logged losses
        with open(prep[-1]["train"], encoding="utf-8") as r:
            lines = r.readlines()
        n_scan = SCAN_RUN_STEPS * 40
        (processed / "scan_train.tsv").write_text(
            "".join((lines * -(-n_scan // len(lines)))[:n_scan]),
            encoding="utf-8")
        keys = len(next(rows_to_one_tower_dataset(
            read_finetune_tsv(str(processed / "scan_train.tsv")), tok, 50,
            205).batches(40))[0])
        scan_ms, scan_params, copies = {}, {}, {}
        for run, scan in (("8", 8), ("1", 1), ("8 profiled", 8)):
            tag = run.replace(" ", "_")
            argv = ft + ["--do_train", "--train_file", "scan_train.tsv",
                         "--valid_file", "none.tsv", "--scan_steps",
                         str(scan), "--log_steps", str(SCAN_LOG_STEPS),
                         "--output_dir", str(root / f"scan_{tag}"),
                         "--log_dir", str(root / f"scan_{tag}_logs")]
            zero_counters()
            if run.endswith("profiled"):
                copies = h2d_copies(lambda: run_cli(argv))
            else:
                _, walls[f"finetune-text --scan_steps {run}"] = run_cli(argv)
            launches = counters()
            tally((0,) * 6)
            check(launches == (0, LAYERS * SCAN_RUN_STEPS,
                               LAYERS * SCAN_RUN_STEPS, 0, 0, 0),
                  f"phase 16b: --scan_steps {run} launches (#1..#6) "
                  f"{launches} over {SCAN_RUN_STEPS} steps")
            logged = [(x["step"], x["time"]) for x in map(json.loads, open(
                root / f"scan_{tag}_logs" / "scalars.jsonl"))
                if x["tag"] == "train/loss"]
            want = chunk_log_steps(SCAN_RUN_STEPS, scan, SCAN_LOG_STEPS)
            check([k for k, _ in logged] == want, f"phase 16b: --scan_steps "
                  f"{run} logged the loss at steps {logged}, JAX's rule "
                  f"gives {want}")
            (k0, t0), (k1, t1) = logged[0], logged[-1]
            scan_ms[run] = 1e3 * (t1 - t0) / (k1 - k0)
            scan_params[run] = load_params(str(
                root / f"scan_{tag}" / "roberta_large-v1-one_tower-cls-NA-ce"
                / "text_finetune_epoch-1.pt"))
            shutil.rmtree(root / f"scan_{tag}")
        ref = scan_params.pop("1")
        for run, state in scan_params.items():
            same = state.keys() == ref.keys() and all(
                torch.equal(state[k], ref[k]) for k in ref)
            check(same, f"phase 16b: --scan_steps {run} parameters differ "
                  "from --scan_steps 1's")
        del scan_params, ref
        chunks = SCAN_RUN_STEPS // 8 + SCAN_RUN_STEPS % 8
        pinned = copies.get("Memcpy HtoD (Pinned -> Device)", 0)
        check(pinned == keys * chunks, f"phase 16b: {pinned} pinned "
              f"host-to-device copies at --scan_steps 8, want {keys} keys x "
              f"{chunks} chunks; all copies {copies}")
        print(f"phase 16b finetune-text --scan_steps: {SCAN_RUN_STEPS} steps "
              f"at batch 40 S=510 bf16, parameters at --scan_steps 8 (twice)"
              f" equal --scan_steps 1's bit for bit; loss logged at "
              f"{chunk_log_steps(SCAN_RUN_STEPS, 8, SCAN_LOG_STEPS)} and "
              f"{chunk_log_steps(SCAN_RUN_STEPS, 1, SCAN_LOG_STEPS)} (JAX's "
              f"rule); host-to-device copies at --scan_steps 8 {copies} "
              f"({keys} keys x {chunks} chunks staged); "
              f"{scan_ms['8']:.2f} ms/step at --scan_steps 8, "
              f"{scan_ms['1']:.2f} at 1 (host clock between the first and "
              f"last logged losses; not a claim); {card}", flush=True)

        # 2. two-tower: two steps, then mine three ways on its weights
        with open(prep[-1]["train"], encoding="utf-8") as r:
            head = [next(r) for _ in range(80)]
        (processed / "tt_train.tsv").write_text("".join(head),
                                                encoding="utf-8")
        before = counters()
        _, walls["finetune-text two-tower"] = run_cli(
            ft + ["--interaction_type", "two_tower", "--do_train",
                  "--train_file", "tt_train.tsv"])
        tally(before)
        state = root / "out" / "roberta_large-v1-two_tower-cls-NA-ce" / \
            "best_f1.pt"
        mine = ["mine", "--item_info", str(files["raw"] / "item_info.jsonl"),
                "--pairs", str(files["mine_pairs"]),
                "--vocab_path", str(files["vocab"]),
                "--config_file", str(cfg_json),
                "--max_seq_len", "50", "--max_seq_len_pv", "205",
                "--batch_size", "64", "--file_state_dict", str(state)]
        variants = {"bf16": [], "int8 cache": ["--cache_quant", "int8"],
                    "int8 dense + cache": ["--quant", "int8",
                                           "--cache_quant", "int8"]}
        mined = {}
        for name, extra in variants.items():
            zero_counters()
            quant.INT_MM_LAUNCHES = 0
            workers = ["--num_workers", "2"] if name == "bf16" else \
                ["--num_workers", "0"]
            out, wall = run_cli(mine + extra + workers + [
                "--output", str(root / f"mine_{len(mined)}.jsonl")])
            mined[name] = dict(out[-1], wall=wall, launches=counters(),
                               int_mm=quant.INT_MM_LAUNCHES)
            mined[name]["rows"], mined[name]["probs"] = _jsonl_probs(
                out[-1]["output"])
            tally((0,) * 6)
        items, n_pairs = mined["bf16"]["items"], mined["bf16"]["pairs"]
        batches = -(-items // 64)
        check(items >= 512 and n_pairs >= 10 * items,
              f"phase 16: mine on {items} items, {n_pairs} pairs")
        for name, m in mined.items():
            check(m["launches"] == (LAYERS * batches, 0, 0, 0, 0, 0),
                  f"phase 16: mine {name} launches (#1..#6) {m['launches']}")
        dense = mined["int8 dense + cache"]["int_mm"]
        check(dense == 6 * LAYERS * batches and mined["bf16"]["int_mm"] == 0
              and mined["int8 cache"]["int_mm"] == 0,
              f"phase 16: torch._int_mm ran {dense} times for {batches} "
              f"encode batches of {LAYERS} layers")

        # the direct check: full two-tower forwards of 64 of the pairs
        id_dict, _, rel = load_item_info(str(files["raw"] /
                                             "item_info.jsonl"))
        item_ids = sorted({r[k] for r in mined["bf16"]["rows"]
                           for k in ("src_item_id", "tgt_item_id")})
        ids, mask = encode_texts(
            str(files["vocab"]), cli._item_texts(id_dict, rel, item_ids,
                                                  tok.sep_token), 255)
        row = {iid: i for i, iid in enumerate(item_ids)}
        pick = np.arange(0, n_pairs, n_pairs // 64)[:64]
        src = [row[mined["bf16"]["rows"][i]["src_item_id"]] for i in pick]
        tgt = [row[mined["bf16"]["rows"][i]["tgt_item_id"]] for i in pick]
        tcfg = mcfg.replace(interaction_type="two_tower",
                            hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
        model = RobertaTwoTower(tcfg, seed=None).eval()
        model.load_state_dict(load_params(str(state)))
        t = {k: torch.from_numpy(v).long().cuda() for k, v in
             (("ids", ids), ("mask", mask))}
        with torch.inference_mode():
            direct = model(t["ids"][src], t["ids"][tgt], t["mask"][src],
                           t["mask"][tgt]).probs.float().cpu().numpy()
        del model, t
        plain = mined["bf16"]["probs"]
        diffs = {"direct": np.abs(plain[pick] - direct).max()}
        for name in ("int8 cache", "int8 dense + cache"):
            diffs[name] = np.abs(mined[name]["probs"] - plain).max()
        # probabilities pinned at 0 or 1 would hide any int8 error
        spread = float(np.mean((plain > 0.01) & (plain < 0.99)))
        check(np.isfinite(plain).all() and diffs["direct"] <= 2e-2,
              f"phase 16: mine vs direct two-tower forwards {diffs['direct']}")
        check(spread >= 0.5, f"phase 16: only {spread:.3f} of mine's "
              "probabilities lie in (0.01, 0.99)")
        check(diffs["int8 cache"] <= INT8_CACHE_TOL,
              f"phase 16: int8 cache vs bf16 {diffs['int8 cache']}")
        check(diffs["int8 dense + cache"] <= INT8_DENSE_TOL,
              f"phase 16: int8 dense vs bf16 {diffs['int8 dense + cache']}")
        for name, m in mined.items():
            walls[f"mine {name}"] = m["wall"]
        print(f"phase 16 mine: {items} items at S=255, {n_pairs} pairs, "
              "pairs_per_sec " + ", ".join(
                  f"{name} {m['pairs_per_sec']} (encode {m['encode_s']} s, "
                  f"score {m['score_s']} s)" for name, m in mined.items())
              + f"; {spread:.3f} of the bf16 probabilities in (0.01, 0.99),"
              f" mean {plain.mean():.4f}; bf16 vs {len(pick)} direct "
              f"two-tower forwards max diff "
              f"{diffs['direct']:.3e}, int8 cache vs bf16 "
              f"{diffs['int8 cache']:.3e} (limit {INT8_CACHE_TOL}), int8 "
              f"dense + cache vs bf16 {diffs['int8 dense + cache']:.3e} "
              f"(limit {INT8_DENSE_TOL}); torch._int_mm {dense} calls "
              f"(6 x {LAYERS} x {batches} encode batches); {card}",
              flush=True)

        # 3. pred-text: the pooled entity features, bf16 and int8
        ents = processed / "entity2id.txt"
        n_ents = sum(1 for line in open(ents) if line.strip())
        pt = ["pred-text", "--entity2id", str(ents),
              "--item_info", str(files["raw"] / "item_info.jsonl"),
              "--vocab_path", str(files["vocab"]),
              "--config_file", str(cfg_json), "--max_seq_len", "64",
              "--batch_size", "256", "--num_workers", "0",
              "--allow_random_weights"]
        pageable = check_transfer_guard()
        feats = {}
        for name, extra in (
                ("bf16", ["--scan_chunks", "8", "--xfer_guard"]),
                ("bf16 --scan_chunks 1", ["--scan_chunks", "1"]),
                ("int8", ["--quant", "int8", "--xfer_guard"])):
            zero_counters()
            quant.INT_MM_LAUNCHES = 0
            out, walls[f"pred-text {name}"] = run_cli(pt + extra + [
                "--output", str(root / f"feat_{len(feats)}.npy")])
            feats[name] = np.load(out[-1]["output"])
            # each group of K batches is padded to full batches of 256
            K = 1 if name.endswith("1") else 8
            encodes = K * -(-n_ents // (256 * K))
            check(counters()[0] == LAYERS * encodes
                  and quant.INT_MM_LAUNCHES == (name == "int8") * 6 * LAYERS
                  * encodes, f"phase 16: pred-text {name} launches "
                  f"{counters()}, torch._int_mm {quant.INT_MM_LAUNCHES}, "
                  f"{encodes} encodes")
            tally((0,) * 6)
        check(np.array_equal(feats["bf16"], feats["bf16 --scan_chunks 1"]),
              "phase 16: pred-text --scan_chunks 8 differs from 1")
        pooled = np.abs(feats["int8"] - feats["bf16"]).max()
        rel = float(np.linalg.norm(feats["int8"] - feats["bf16"])
                    / np.linalg.norm(feats["bf16"]))
        check(n_ents >= 1024 and all(f.shape == (n_ents, 1024)
                                     and np.isfinite(f).all()
                                     for f in feats.values()),
              f"phase 16: pred-text shapes "
              f"{[f.shape for f in feats.values()]}, {n_ents} entities")
        check(rel <= POOLED_INT8_REL, f"phase 16: pred-text int8 vs bf16 "
              f"features differ by {rel} (relative)")
        print(f"phase 16 pred-text: {n_ents} entities at S=64, features "
              f"{feats['bf16'].shape}, --scan_chunks 8 --xfer_guard equal to "
              f"--scan_chunks 1 bit for bit; a pageable copy under the guard "
              f"{pageable}; int8 vs bf16 relative (Frobenius) "
              f"{rel:.3e} (limit {POOLED_INT8_REL}), max diff {pooled:.3e}; "
              f"int8 products exact on the card at {products}; {card}",
              flush=True)
        print("phase 16 wall times: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in walls.items()) + f"; {card}",
            flush=True)
    return tuple(counts)

# ---------------------------------------------------------------------------
# phase 17: the PKGM family, ``ia-torch pkgm-pretrain`` and PKGM-large
# ---------------------------------------------------------------------------

KG_ENTITIES, KG_RELATIONS = 258211, 1379  # configs/pkgm_large.json
KG_TRAIN_FACTS, KG_VALID_FACTS = 262144, 1024
PKGM_WIDTH = 1024  # PKGM-large's hidden size and KG embedding dim
KGE_BATCH = 32768  # pkgm-pretrain's default batch
SCORE_REL_TOL = 1e-3  # all-candidate vs pointwise KGE scores, relative
PKGM_LEN, PKGM_PVS = 64, 30  # pair S = 2 * (64 + 2 * 30) = 248


@contextlib.contextmanager
def wrapped(owner, attr: str, around):
    """``owner.attr`` replaced by ``around(original)`` inside the block."""
    original = getattr(owner, attr)
    setattr(owner, attr, around(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)


def timed(store: dict, key: str):
    """A wrapper that appends each call's wall seconds, the device
    synchronised, to ``store[key]``."""
    def around(fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            store.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return call
    return around


def write_synthetic_kg(out: Path, prepared: Path, seed: int) -> dict:
    """A KG at configs/pkgm_large.json's size in the layout ``prepare``
    writes: the smoke corpus's ``/item/<id>`` entities first, then the rest
    of prepare's entities and synthetic ones up to KG_ENTITIES; prepare's
    relations, then synthetic ones up to KG_RELATIONS.  A quarter of the
    facts have an item head; a tail is a function of its head and relation
    (tests/test_kge.py's toy KG, scaled)."""
    def names(path):
        return [line.rsplit("\t", 1)[0] for line in open(path, encoding="utf-8")
                if line.strip()]

    prep_ents = names(prepared / "entity2id.txt")
    items = sorted((e for e in prep_ents if e.startswith("/item/")),
                   key=lambda e: int(e[len("/item/i"):]))
    ents = items + [e for e in prep_ents if not e.startswith("/item/")]
    ents += [f"/entity/e{k}" for k in range(KG_ENTITIES - len(ents))]
    rels = names(prepared / "relation2id.txt")
    rels += [f"/relation/r{k}" for k in range(KG_RELATIONS - len(rels))]
    rs = np.random.RandomState(seed)
    n = KG_TRAIN_FACTS + KG_VALID_FACTS
    h = rs.randint(0, KG_ENTITIES, n)
    h[: n // 4] = rs.randint(0, len(items), n // 4)
    r = rs.randint(1, KG_RELATIONS, n)
    t = (h + 7919 * r + 1) % KG_ENTITIES
    out.mkdir()
    for path, table in (("entity2id.txt", ents), ("relation2id.txt", rels)):
        (out / path).write_text("".join(f"{x}\t{i}\n" for i, x in
                                        enumerate(table)), encoding="utf-8")
    E, R = np.array(ents, dtype=object), np.array(rels, dtype=object)
    for path, sl in (("train2id.txt", slice(0, KG_TRAIN_FACTS)),
                     ("valid2id.txt", slice(KG_TRAIN_FACTS, n))):
        (out / path).write_text("\n".join(map("\t".join, zip(
            E[h[sl]], R[r[sl]], E[t[sl]]))) + "\n", encoding="utf-8")
    return {"items": len(items), "valid": (h[KG_TRAIN_FACTS:],
                                            r[KG_TRAIN_FACTS:])}


def hf_roberta_state_dict(cfg: ModelConfig, seed: int) -> dict:
    """Random encoder weights under HF's names (``roberta.`` prefix, two
    token types, as ``pytorch_model.bin`` of chinese-roberta-wwm-ext-large
    has them): matrices normal(0, initializer_range), zero biases, unit
    LayerNorm scales.  On the CPU, as ``torch.load`` gives them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    H, inner = cfg.hidden_size, cfg.intermediate_size

    def w(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * cfg.initializer_range).cpu()

    def norm(prefix):
        return {prefix + ".weight": torch.ones(H),
                prefix + ".bias": torch.zeros(H)}

    sd = {"embeddings.word_embeddings.weight": w(cfg.vocab_size, H),
          "embeddings.position_embeddings.weight":
              w(cfg.max_position_embeddings, H),
          "embeddings.token_type_embeddings.weight": w(2, H),
          **norm("embeddings.LayerNorm")}
    shapes = {"attention.self.query": (H, H), "attention.self.key": (H, H),
              "attention.self.value": (H, H),
              "attention.output.dense": (H, H),
              "intermediate.dense": (inner, H), "output.dense": (H, inner)}
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}."
        for name, (o, k) in shapes.items():
            sd[p + name + ".weight"] = w(o, k)
            sd[p + name + ".bias"] = torch.zeros(o)
        sd.update(norm(p + "attention.output.LayerNorm"))
        sd.update(norm(p + "output.LayerNorm"))
    return {"roberta." + k: v for k, v in sd.items()}


def _kge_pretrain(root: Path, prepared: Path, seed: int, card: str) -> dict:
    """17a: ``ia-torch pkgm-pretrain`` at 258,211 x 1024 on a synthetic KG;
    returns the arrays of ``kge_final.npz`` and the KG directory."""
    t0 = time.perf_counter()
    kg_dir = root / "kg"
    kg = write_synthetic_kg(kg_dir, prepared, seed)
    write_s = time.perf_counter() - t0
    out_dir = root / "kge"
    host, held = {}, {}

    def keep(fn):
        def run(self):
            held["trainer"], held["result"] = self, fn(self)
            return held["result"]
        return run

    with contextlib.ExitStack() as stack:
        for owner, attr, around in (
                (kge.KGETrainer, "_step", timed(host, "step")),
                (kge.KGETrainer, "run", keep),
                (kev.LinkPredictionEvaluator, "evaluate",
                 timed(host, "eval")),
                (ksamp, "bernoulli_probs", timed(host, "bernoulli_probs")),
                (kge, "load_ccks", timed(host, "load_ccks")),
                (kge.KnowledgeGraph, "dict_of_tails", timed(host, "dict_of")),
                (kge.KnowledgeGraph, "dict_of_heads", timed(host, "dict_of"))):
            stack.enter_context(wrapped(owner, attr, around))
        out, wall = run_cli([
            "pkgm-pretrain", "--data_dir", str(kg_dir), "--output_dir",
            str(out_dir), "--model_name", "pkgm", "--embedding_dim",
            str(PKGM_WIDTH), "--batch_size", str(KGE_BATCH), "--n_neg", "3",
            "--epochs", "2", "--do_eval"])
    trainer, history = held["trainer"], held["result"]["history"]
    res = out[-1]
    losses = [h["loss"] for h in history]
    check(len(losses) == 2 and all(map(math.isfinite, losses))
          and losses[1] < losses[0], f"phase 17a: KGE losses {losses}")
    check(0.0 < res["mrr"] <= 1.0, f"phase 17a: mrr {res['mrr']}")
    with np.load(out_dir / "kge_final.npz") as f:
        arrays = {k: f[k] for k in f.files}
    check(arrays["ent_emb"].shape == (KG_ENTITIES, PKGM_WIDTH)
          and arrays["rel_emb"].shape == (KG_RELATIONS, PKGM_WIDTH)
          and arrays["proj_mat"].shape == (PKGM_WIDTH, PKGM_WIDTH),
          f"phase 17a: kge_final.npz shapes "
          f"{ {k: v.shape for k, v in arrays.items()} }")
    params, model = trainer.params, trainer.model
    check(all(np.array_equal(arrays[k], v.cpu().numpy())
              for k, v in params.items()),
          "phase 17a: kge_final.npz differs from the trained parameters")
    # all-candidate tail scores (the ||x||^2 - 2x.e + ||e||^2 expansion)
    # against pointwise score() over every candidate, 64 validation facts
    h64, r64 = (torch.as_tensor(x[:64], device="cuda").long()
                for x in kg["valid"])
    cand = torch.arange(KG_ENTITIES, device="cuda")
    worst = 0.0
    with torch.no_grad():
        every = model.scores_all_tails(params, h64, r64)
        for i in range(64):
            point = model.score(params, h64[i].expand(KG_ENTITIES),
                                r64[i].expand(KG_ENTITIES), cand)
            worst = max(worst, ((every[i] - point).abs().max()
                                / point.abs().max()).item())
    check(worst <= SCORE_REL_TOL, f"phase 17a: all-candidate tail scores "
          f"vs pointwise differ by {worst} (relative)")
    steps = host["step"]
    step_ms = 1e3 * sum(steps[1:]) / (len(steps) - 1)
    # one more step: the first KGE_BATCH facts and their negatives
    h_all, t_all, r_all = trainer.sampler.kg_arrays
    nh, nt = trainer.sampler.corrupt_kg_device(trainer.gen)
    idx = torch.arange(KGE_BATCH, device="cuda")
    neg = torch.cat([idx + i * KG_TRAIN_FACTS for i in range(3)])
    profiled = profile_step(lambda: trainer._step(
        h_all[idx], t_all[idx], r_all[idx], nh[neg], nt[neg]), step_ms)
    print(f"phase 17a pkgm-pretrain: {KG_ENTITIES} entities x {PKGM_WIDTH}, "
          f"{KG_RELATIONS} relations, {KG_TRAIN_FACTS} train facts "
          f"({kg['items']} smoke-corpus items first), batch {KGE_BATCH}, "
          f"n_neg 3, "
          f"2 epochs of {len(steps) // 2} steps: {step_ms:.3f} ms/step "
          f"after the first ({1e3 * steps[0]:.1f} ms), epoch wall "
          f"{[round(h['wall_s'], 3) for h in history]} s, losses "
          f"{[round(x, 3) for x in losses]}, final_loss {res['final_loss']}; "
          f"filtered link prediction on {KG_VALID_FACTS} facts "
          f"{sum(host['eval']):.3f} s: mrr {res['mrr']:.6f}, hit10 "
          f"{res['hit10']:.6f}; host: writing the KG {write_s:.3f} s, "
          f"load_ccks {sum(host['load_ccks']):.3f} s, bernoulli_probs "
          f"{sum(host['bernoulli_probs']):.3f} s, dict_of_tails/heads "
          f"{sum(host['dict_of']):.3f} s; command {wall:.3f} s; all-candidate "
          f"vs pointwise tail scores of 64 facts max rel diff {worst:.3e} "
          f"(limit {SCORE_REL_TOL}); {card}", flush=True)
    print(f"phase 17a: profile of one more KGE step: {profiled}", flush=True)
    del trainer, params, model, held, every, nh, nt
    gc.collect()
    torch.cuda.empty_cache()
    return {"arrays": arrays, "kg_dir": kg_dir}


def _finetune_ms(log_dir: Path) -> tuple:
    scalars = [json.loads(line) for line in open(log_dir / "scalars.jsonl")]
    losses = [s["value"] for s in scalars if s["tag"] == "train/loss"]
    stamps = [s["time"] for s in scalars if s["tag"] == "train/loss"]
    return losses, 1e3 * (stamps[-1] - stamps[0]) / (len(stamps) - 1)


def _step_profile(trainer, batches) -> tuple:
    """phase 8's timing of train steps (the first one a warm-up) and one
    more step under ``torch.profiler``: (ms/step, the profile's text)."""
    times = []
    for batch in batches:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = 1e3 * sum(times[1:]) / (len(times) - 1)
    return step_ms, profile_step(lambda: trainer.train_step(batches[-1]),
                                 step_ms)


def _pkgm_step_profile(model, trainer, batches, card) -> str:
    """phase 8's timing of PKGM-large steps, with the entity table's share
    measured alone at the same shapes: its lookup backward (80 ids into
    258,211 rows) and its AdamW update."""
    step_ms, profiled = _step_profile(trainer, batches)
    table = model.roberta.embeddings.ent_emb.weight
    ids = torch.as_tensor(batches[0]["input_ids"][:, [PKGM_LEN, 2 * PKGM_LEN
                                                      + PKGM_PVS + 1]],
                          device="cuda").long()
    leaf = table.detach().clone().requires_grad_()
    g = torch.randn(ids.shape + (table.shape[1],), device="cuda")

    def lookup_backward():
        take_rows(leaf, ids).backward(g)
        leaf.grad = None

    lookup_ms = cuda_ms(lookup_backward, 10)
    adam = FusedAdamW({"e": leaf}, lambda step: 5e-5, 0.9, 0.98, 1e-8, 0.01,
                      {"e": True}, torch.bfloat16)
    grad = {"e": torch.randn_like(leaf)}
    adam_ms = cuda_ms(lambda: adam.update(grad), 10)
    del leaf, g, adam, grad
    return (f"{step_ms:.2f} ms/step over {len(batches) - 1} timed steps "
            f"({40 / step_ms * 1e3:.2f} train pairs/s); {profiled}; alone at "
            f"the same shapes: entity-table lookup backward "
            f"{lookup_ms:.3f} ms, its AdamW update {adam_ms:.3f} ms")


def phase_pkgm(seed: int, card: str) -> tuple:
    """Phase 17: ``pkgm-pretrain`` at configs/pkgm_large.json's KG size,
    then PKGM-large ``finetune-text`` one-tower (S=248) and two-tower
    (S=124) from its tables in bf16 with random RoBERTa-large weights, and
    the PKGM checks.  Returns the launches of #1-#6 over 17b-c and the
    worst errors of #1 (``serving_err``) and of #2's and #3's contracts
    (``fwd_err``, ``bwd_err``) against their plain versions at the PKGM
    shapes."""
    with segmenter(), tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        files = write_smoke_corpus(root, seed)
        processed = root / "processed"
        prep, _ = run_cli(["prepare", "--data_dir", str(files["raw"]),
                           "--output_dir", str(processed), "--seed",
                           str(seed)])
        kge_out = _kge_pretrain(root, processed, seed, card)
        arrays, kg_dir = kge_out["arrays"], kge_out["kg_dir"]

        # 17b: PKGM-large one-tower from the pretrain's tables
        raw_cfg = json.loads((ROOT / "configs" / "pkgm_large.json"
                              ).read_text())
        cfg_json = root / "pkgm_large_bf16.json"
        cfg_json.write_text(json.dumps(dict(raw_cfg, dtype="bfloat16")))
        tok = load_text_tokenizer(str(files["vocab"]))
        mcfg = ModelConfig.from_json(
            str(cfg_json), vocab_size=len(tok), max_seq_len=PKGM_LEN,
            max_seq_len_pv=None, max_pvs=PKGM_PVS)
        check(mcfg.hidden_size == mcfg.kg_embedding_dim == PKGM_WIDTH
              and mcfg.num_hidden_layers == LAYERS
              and mcfg.num_entities == KG_ENTITIES
              and mcfg.num_relations == KG_RELATIONS,
              "phase 17: not PKGM-large")
        pre = root / "pretrained"
        pre.mkdir()
        torch.save(hf_roberta_state_dict(mcfg, seed), pre /
                   "pytorch_model.bin")
        torch.save({f"{k}.weight": torch.from_numpy(arrays[k]) for k in
                    ("ent_emb", "rel_emb", "proj_mat")},
                   pre / "pkgm_model.bin")
        train_rows = open(prep[-1]["train"], encoding="utf-8").readlines()
        for name, n in (("pkgm_train.tsv", 160), ("pkgm_tt_train.tsv", 80)):
            (processed / name).write_text("".join(train_rows[:n]),
                                          encoding="utf-8")
        n_valid = len(read_finetune_tsv(prep[-1]["valid"]))
        test_rows = read_finetune_tsv(prep[-1]["test"])
        ft = ["finetune-text", "--data_dir", str(processed),
              "--output_dir", str(root / "out"),
              "--vocab_path", str(files["vocab"]),
              "--model_name", "pkgm_large", "--config_file", str(cfg_json),
              "--entity2id", str(kg_dir / "entity2id.txt"),
              "--relation2id", str(kg_dir / "relation2id.txt"),
              "--max_seq_len", str(PKGM_LEN), "--max_pvs", str(PKGM_PVS),
              "--train_batch_size", "40", "--eval_batch_size", "40",
              "--epochs", "1", "--learning_rate", "5e-5",
              "--opt_state_dtype", "bfloat16", "--bf16", "--log_steps", "1",
              "--total_steps", TOTAL_STEPS, "--seed", str(seed),
              "--pretrained_model_path", str(pre)]
        merged = []

        def hold_merge(fn):
            def load(model, cfg, args):
                fn(model, cfg, args)
                emb = model.roberta.embeddings
                merged.append(all(torch.equal(
                    getattr(emb, k).weight.detach().cpu(),
                    torch.from_numpy(arrays[k]))
                    for k in ("ent_emb", "rel_emb", "proj_mat")))
            return load

        walls = {}
        zero_counters()  # the PKGM main path starts here
        with wrapped(cli, "_load_pretrained", hold_merge):
            out, walls["one-tower"] = run_cli(ft + [
                "--train_file", "pkgm_train.tsv", "--do_train", "--do_eval",
                "--do_pred", "--log_dir", str(root / "logs_one")])
            one = counters()
            _, walls["two-tower"] = run_cli(ft + [
                "--interaction_type", "two_tower", "--train_file",
                "pkgm_tt_train.tsv", "--do_train", "--do_eval",
                "--log_dir", str(root / "logs_two")])
        launches = counters()
        two = tuple(b - a for a, b in zip(one, launches))
        check(merged == [True, True], f"phase 17b: the merged ent_emb/"
              f"rel_emb/proj_mat equal kge_final.npz: {merged}")
        batches_v, batches_t = -(-n_valid // 40), -(-len(test_rows) // 40)
        expect_one = (LAYERS * (2 * batches_v + batches_t), LAYERS * 4,
                      LAYERS * 4, 0, 0, 0)
        expect_two = (2 * LAYERS * 2 * batches_v, 2 * LAYERS * 2,
                      2 * LAYERS * 2, 0, 0, 0)
        check(one == expect_one and two == expect_two,
              f"phase 17: launches (#1..#6) one-tower {one} (expected "
              f"{expect_one}), two-tower {two} (expected {expect_two})")
        losses_one, ms_one = _finetune_ms(root / "logs_one")
        losses_two, ms_two = _finetune_ms(root / "logs_two")
        check(len(losses_one) == 4 and len(losses_two) == 2
              and all(map(math.isfinite, losses_one + losses_two)),
              f"phase 17: losses {losses_one}, {losses_two}")
        print(f"phase 17b finetune-text pkgm_large one-tower: batch 40 "
              f"S={2 * (PKGM_LEN + 2 * PKGM_PVS)} "
              f"bf16 dropout 0.1, KG tables from kge_final.npz (equal bit "
              f"for bit after the merge), 4 steps, losses "
              f"{[round(x, 6) for x in losses_one]}, {ms_one:.2f} ms/step "
              f"through the CLI ({40 / ms_one * 1e3:.2f} train pairs/s), "
              f"launches #1..#6 {one}, command {walls['one-tower']:.3f} s; "
              f"{card}", flush=True)
        print(f"phase 17c finetune-text pkgm_large two-tower: batch 40 "
              f"S={PKGM_LEN + 2 * PKGM_PVS} per tower, 2 steps, losses "
              f"{[round(x, 6) for x in losses_two]}, {ms_two:.2f} ms/step "
              f"through the CLI ({40 / ms_two * 1e3:.2f} train pairs/s), "
              f"launches #1..#6 {two}, command {walls['two-tower']:.3f} s; "
              f"{card}", flush=True)

        # 17d: kernels vs plain attention, the prediction file, #1 at the
        # PKGM lengths, a profiled step, and bit-equal repeats
        kg_ent, kg_rel = load_kg_tokenizers(str(kg_dir / "entity2id.txt"),
                                            str(kg_dir / "relation2id.txt"))
        run_dir = root / "out" / "pkgm_large-v1-one_tower-cls-NA-ce"
        state = load_params(str(run_dir / "best_f1.pt"))
        ds = rows_to_pkgm_dataset(test_rows, tok, kg_ent, kg_rel, PKGM_LEN,
                                  PKGM_PVS)
        check(ds.arrays["input_ids"].shape[1] == 2 * (PKGM_LEN + 1 + PKGM_PVS)
              and ds.arrays["attention_mask"].shape[1]
              == 2 * (PKGM_LEN + 2 * PKGM_PVS),
              "phase 17d: PKGM lengths")
        probs = {}
        for name, flash in (("kernels", True), ("plain", False)):
            model = PKGMOneTower(mcfg.replace(use_flash_attention=flash),
                                 seed=None).eval()
            model.load_state_dict(state)
            got = []
            with torch.inference_mode():
                for batch, meta in ds.batches(40):
                    feed = {k: torch.from_numpy(v).long().cuda()
                            for k, v in batch.items() if k != "labels"}
                    got.append(model(**feed).probs.float().cpu().numpy()
                               [: meta["n_valid"]])
            probs[name] = np.concatenate(got)
            if flash:
                kernel_model = model
        pred = [o for o in out if "prediction_file" in o][-1]
        _, filed = _jsonl_probs(pred["prediction_file"])
        diff = np.abs(probs["kernels"] - probs["plain"]).max()
        diff_file = np.abs(probs["kernels"] - filed).max()
        check(np.isfinite(probs["kernels"]).all() and diff <= 2e-2
              and diff_file <= 2e-2, f"phase 17d: PKGM-large probs on the "
              f"kernels vs plain attention {diff}, vs the prediction file "
              f"{diff_file}")
        del model
        gen = torch.Generator(device="cuda").manual_seed(seed)
        lengths = (2 * (PKGM_LEN + 2 * PKGM_PVS), PKGM_LEN + 2 * PKGM_PVS)
        kernel_rows = [kernel_case("serving", 40, S, 16, 64, torch.bfloat16,
                                   False, gen, phase="phase 17d kernel #1")
                       for S in lengths]
        # #2's and #3's contracts held against their plain versions at the
        # PKGM training shapes, neither length a multiple of 64
        errs = phase_train_kernels(gen, [
            (f"bf16 S={S}", 40, S, 16, 64, torch.bfloat16) for S in lengths],
            SimpleNamespace(**dict(vars(TRAIN_FAMILY),
                                   name="phase 17d train kernels")))
        errs["serving_err"] = max(err for _, err in kernel_rows)
        tcfg = TrainConfig(seed=seed, train_batch_size=40,
                           log_steps=10 ** 9, optimizer=OptimizerConfig(
                               learning_rate=5e-5, total_steps=16000,
                               fused=True, state_dtype="bfloat16"))
        train_ds = rows_to_pkgm_dataset(
            read_finetune_tsv(str(processed / "pkgm_train.tsv")), tok,
            kg_ent, kg_rel, PKGM_LEN, PKGM_PVS)
        batches = [b for b, _ in train_ds.batches(40)]
        trainer = Trainer(kernel_model, tcfg).setup()
        profile = _pkgm_step_profile(kernel_model, trainer, batches, card)
        del kernel_model, trainer, state
        gc.collect()
        torch.cuda.empty_cache()
        repeat = _pkgm_repeat(mcfg, seed, tcfg, batches[:2])
        print(f"phase 17d: PKGM-large one-tower on {len(ds)} test pairs at "
              f"S={lengths[0]}, kernels vs plain attention max diff "
              f"{diff:.3e}, vs the prediction file {diff_file:.3e}; #1 at "
              f"B=40 S={lengths[0]} {kernel_rows[0][0]['ms']:.4f} ms, "
              f"S={lengths[1]} {kernel_rows[1][0]['ms']:.4f} ms; training "
              f"{profile}; "
              f"{repeat}; {card}", flush=True)
    return launches, errs


def _pkgm_repeat(mcfg: ModelConfig, seed: int, tcfg: TrainConfig,
                 batches) -> str:
    """Two train steps from one state and seed, run twice, must give equal
    parameters bit for bit (full width, 2 layers, the 258,211-row entity
    table and its lookup backward included)."""
    model = PKGMOneTower(mcfg.replace(num_hidden_layers=2), seed=seed)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    finals = []
    for _ in range(2):
        model.load_state_dict(start)
        trainer = Trainer(model, tcfg).setup()
        for batch in batches:
            trainer.train_step(batch)
        finals.append({k: v.clone() for k, v in model.state_dict().items()})
    differing = sorted(k for k in finals[0]
                       if not torch.equal(finals[0][k], finals[1][k]))
    moved = not torch.equal(finals[0]["roberta.embeddings.ent_emb.weight"],
                            start["roberta.embeddings.ent_emb.weight"])
    check(not differing and moved, f"phase 17d: two runs of {len(batches)} "
          f"PKGM steps differ in {differing} (entity table moved: {moved})")
    del model, start, finals, trainer
    torch.cuda.empty_cache()
    return (f"{len(batches)} steps run twice from one state equal bit for "
            f"bit in all parameters")


# ---------------------------------------------------------------------------
# phase 18: the multimodal RobertaImage family and the aggregation
# ---------------------------------------------------------------------------

IMAGE_WIDTH = 3072  # configs/roberta_image_large.json's image_hidden_size
MM_BATCH = 32       # scripts/train.sh's roberta_image_large batch
MM_TOL = 2e-2       # bf16: kernels vs plain attention, probabilities


def _multimodal_probs(cfg: ModelConfig, state: dict, ds) -> dict:
    """The one-tower's probabilities on ``ds`` with ``state``, through the
    kernels and through plain attention; returns them and the kernel
    model."""
    probs = {}
    for name, flash in (("kernels", True), ("plain", False)):
        model = RobertaImageOneTower(cfg.replace(use_flash_attention=flash),
                                     seed=None).eval()
        model.load_state_dict(state)
        got = []
        with torch.inference_mode():
            for batch, meta in ds.batches(64):
                feed = {k: torch.from_numpy(v).cuda() for k, v in
                        batch.items() if k != "labels"}
                feed = {k: v if v.is_floating_point() else v.long()
                        for k, v in feed.items()}
                got.append(model(**feed).probs.float().cpu().numpy()
                           [: meta["n_valid"]])
        probs[name] = np.concatenate(got)
        if flash:
            probs["model"] = model
        else:
            del model
    return probs


def embedding_file_text(path: Path, rows: dict) -> str:
    """The TSVs' image columns must be the file's own array text byte for
    byte (the native span scan slices it; the file's arrays are read here
    with a regular expression, not by the port's reader); the span scan
    and the ``json.load`` path give the same texts of this file, timed
    against each other; NaN, +inf and -inf dumped and read back by
    ``json.loads`` and the span scan."""
    from item_alignment_torch.data.images import (
        embedding_texts,
        load_embedding_json,
        write_embedding_json,
    )

    own = dict(re.findall(r'"([^"]*)": \[([^\]]*)\]',
                          path.read_text(encoding="utf-8")))
    cols = [(r[1], r[4]) for split in rows.values() for r in split] + [
        (r[5], r[8]) for split in rows.values() for r in split]
    bad = [iid for iid, col in cols if col != own[iid]]
    check(not bad, f"phase 18a: {len(bad)} TSV image columns are not the "
          f"file's own text (first {bad[:3]})")
    t0 = time.perf_counter()
    spans = dict(native_loader.read_embedding_spans(str(path)))
    span_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_embedding_json(str(path))
    load_s = time.perf_counter() - t0
    check(spans == loaded == own, "phase 18a: the span scan, json.load and "
          "the file's own text disagree")
    nonfinite = path.parent / "nonfinite.json"
    texts = embedding_texts(np.array([[np.nan, np.inf, -np.inf, 1.5]],
                                     np.float32))
    write_embedding_json(["x"], texts, str(nonfinite))
    back = json.loads(nonfinite.read_text(encoding="utf-8"))["x"]
    check(texts == ["NaN,Infinity,-Infinity,1.5"] and math.isnan(back[0])
          and back[1:] == [math.inf, -math.inf, 1.5]
          and native_loader.read_embedding_spans(str(nonfinite))
          == [("x", texts[0])],
          f"phase 18a: the non-finite dump {texts} read back as {back}")
    mb = path.stat().st_size / 2 ** 20
    return (f"{len(cols)} TSV image columns equal the file's own text; "
            f"read_embedding_spans {span_s:.3f} s vs json.load + "
            f"format_rows {load_s:.3f} s ({load_s / span_s:.1f}x) on "
            f"{len(spans)} x {IMAGE_WIDTH} floats ({mb:.1f} MiB); "
            f"NaN/+inf/-inf dumped as {texts[0]!r}, read back by json.loads")


def phase_multimodal(seed: int, card: str) -> tuple:
    """Phase 18: ``prepare --with_image``, RobertaImage-large
    ``finetune-multimodal`` one-tower (``begin``, then ``end``) and
    two-tower, #2's and #3's contracts at the multimodal training shapes,
    ``ensemble`` of a text and a multimodal member and ``model-soup``, all
    through ``cli.main`` at configs/roberta_image_large.json's width in bf16
    with random weights.  Returns the launches of #1-#6 over the phase and
    the worst errors of #2's and #3's contracts at B=32, S=510 and 255."""
    from item_alignment_torch.aggregate.ensemble import (
        ensemble_predictions,
        read_prediction_file,
    )
    from item_alignment_torch.data.images import (
        embedding_texts,
        write_embedding_json,
    )
    from item_alignment_torch.data.prepare import read_tsv
    from item_alignment_torch.data.tokenization import (
        rows_to_image_one_tower_dataset,
    )

    with segmenter(), tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        files = write_smoke_corpus(root, seed)
        tok = load_text_tokenizer(str(files["vocab"]))
        check(tok.vocab.get("[unused99]") == 99,
              "phase 18: [unused99] is not row 99 of the vocab")
        # 18a: image_embedding.json of every item, then prepare --with_image
        t0 = time.perf_counter()
        ids = [json.loads(line)["item_id"] for line in
               open(files["raw"] / "item_info.jsonl", encoding="utf-8")]
        images = np.random.RandomState(seed).randn(
            len(ids), IMAGE_WIDTH).astype(np.float32)
        processed = root / "processed_image"
        write_embedding_json(ids, embedding_texts(images),
                             str(processed / "image_embedding.json"))
        write_s = time.perf_counter() - t0
        walls = {}
        prep, walls["prepare --with_image"] = run_cli([
            "prepare", "--data_dir", str(files["raw"]), "--output_dir",
            str(processed), "--seed", str(seed), "--with_image"])
        rows = {k: read_tsv(prep[-1][k]) for k in ("train", "valid", "test")}
        check(all(len(r) == 9 for split in rows.values() for r in split),
              "phase 18a: the --with_image TSVs do not have 9 columns")
        column = np.asarray(rows["test"][0][4].split(","), np.float32)
        check(np.array_equal(column, images[ids.index(rows["test"][0][1])]),
              "phase 18a: a TSV image column differs from its vector")
        native_read = embedding_file_text(
            processed / "image_embedding.json", rows)
        for name, n in (("mm_step.tsv", MM_BATCH),
                        ("mm_tt_train.tsv", 2 * MM_BATCH)):
            (processed / name).write_text("".join(
                "\t".join(r) + "\n" for r in rows["train"][:n]),
                encoding="utf-8")
        print(f"phase 18a prepare --with_image: {len(ids)} items x "
              f"{IMAGE_WIDTH} floats written in {write_s:.3f} s, TSVs of 9 "
              f"columns: {len(rows['train'])} train, {len(rows['valid'])} "
              f"valid, {len(rows['test'])} test rows, command "
              f"{walls['prepare --with_image']:.3f} s; {card}", flush=True)
        print(f"phase 18a native loader: {native_read}; {card}", flush=True)

        raw_cfg = json.loads((ROOT / "configs" / "roberta_image_large.json"
                              ).read_text())
        cfg_json = root / "roberta_image_large_bf16.json"
        cfg_json.write_text(json.dumps(dict(raw_cfg, dtype="bfloat16")))
        out = root / "output"
        mm = ["finetune-multimodal", "--data_dir", str(processed),
              "--output_dir", str(out), "--vocab_path", str(files["vocab"]),
              "--model_name", "roberta_image_large",
              "--config_file", str(cfg_json), "--image_hidden_size",
              str(IMAGE_WIDTH), "--max_seq_len", "50",
              "--max_seq_len_pv", "205", "--train_batch_size",
              str(MM_BATCH), "--eval_batch_size", "64", "--epochs", "1",
              "--learning_rate", "5e-5", "--opt_state_dtype", "bfloat16",
              "--bf16", "--log_steps", "1", "--total_steps", TOTAL_STEPS,
              "--seed", str(seed)]
        batches_v = -(-len(rows["valid"]) // 64)
        batches_t = -(-len(rows["test"]) // 64)

        # 18b: the one-tower, ensemble=begin, B=32, S=510
        steps = len(rows["train"]) // MM_BATCH
        zero_counters()  # the multimodal main path starts here
        res, walls["one-tower begin"] = run_cli(mm + [
            "--ensemble", "begin", "--do_train", "--do_eval", "--do_pred",
            "--log_dir", str(root / "logs_b")])
        one = counters()
        expect = (LAYERS * (2 * batches_v + batches_t), LAYERS * steps,
                  LAYERS * steps, 0, 0, 0)
        check(one == expect, f"phase 18b: launches (#1..#6) {one}, "
              f"expected {expect}")
        losses, cli_ms = _finetune_ms(root / "logs_b")
        check(len(losses) == steps and all(map(math.isfinite, losses)),
              f"phase 18b: losses {losses} over {steps} steps")
        pred_b = [o for o in res if "prediction_file" in o][-1]
        check(pred_b["prediction_split"] == "test",
              f"phase 18b: predicted on {pred_b['prediction_split']}")
        run_b = Path(pred_b["prediction_file"]).parent
        mcfg = ModelConfig.from_json(
            str(cfg_json), vocab_size=len(tok), max_seq_len=50,
            max_seq_len_pv=205, model_name="roberta_image_large",
            ensemble="begin", image_hidden_size=IMAGE_WIDTH)
        check(mcfg.num_hidden_layers == LAYERS and mcfg.hidden_size == 1024
              and mcfg.pair_seq_len == 510, "phase 18: not RoBERTa-large")
        test_ds = rows_to_image_one_tower_dataset(rows["test"], tok, 50, 205,
                                                  IMAGE_WIDTH)
        check(test_ds.arrays["input_ids"].shape[1] == 510
              and (test_ds.arrays["input_ids"][:, 1] == 99).all()
              and (test_ds.arrays["image_indices"] > 1).all(),
              "phase 18b: the image tokens of the one-tower layout")
        probs = _multimodal_probs(mcfg, load_params(str(run_b /
                                                        "best_f1.pt")),
                                  test_ds)
        _, filed = _jsonl_probs(pred_b["prediction_file"])
        diff = np.abs(probs["kernels"] - probs["plain"]).max()
        diff_file = np.abs(probs["kernels"] - filed).max()
        check(np.isfinite(probs["kernels"]).all() and diff <= MM_TOL
              and diff_file <= MM_TOL, f"phase 18b: probs on the kernels vs "
              f"plain attention {diff}, vs the prediction file {diff_file}")
        tcfg = TrainConfig(seed=seed, train_batch_size=MM_BATCH,
                           log_steps=10 ** 9, optimizer=OptimizerConfig(
                               learning_rate=5e-5, total_steps=16000,
                               fused=True, state_dtype="bfloat16"))
        train_ds = rows_to_image_one_tower_dataset(rows["train"], tok, 50,
                                                   205, IMAGE_WIDTH)
        model = probs.pop("model").train()
        trainer = Trainer(model, tcfg).setup()
        step_ms, profiled = _step_profile(
            trainer, [b for b, _ in train_ds.batches(MM_BATCH)][:4])
        del model, trainer, probs
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 18b finetune-multimodal roberta_image_large one-tower "
              f"begin: batch {MM_BATCH} S=510 bf16 dropout 0.1, image "
              f"vectors of {IMAGE_WIDTH}, {steps} steps, losses "
              f"{[round(x, 6) for x in losses]}, {cli_ms:.2f} ms/step "
              f"through the CLI ({MM_BATCH / cli_ms * 1e3:.2f} train "
              f"pairs/s), launches #1..#6 {one}, command "
              f"{walls['one-tower begin']:.3f} s; {len(test_ds)} test pairs "
              f"on the kernels vs plain attention max diff {diff:.3e}, vs "
              f"the prediction file {diff_file:.3e} (limit {MM_TOL}); "
              f"direct: {step_ms:.2f} ms/step over 3 timed steps, "
              f"{profiled}; {card}", flush=True)

        # 18c: the one-tower with ensemble=end, and the two-tower at S=255
        zero_counters()  # 18b's direct forwards and profiled steps left out
        before = counters()
        _, walls["one-tower end"] = run_cli(mm + [
            "--ensemble", "end", "--train_file", "mm_step.tsv", "--do_train",
            "--do_eval", "--log_dir", str(root / "logs_e")])
        mid = counters()
        _, walls["two-tower"] = run_cli(mm + [
            "--ensemble", "begin", "--interaction_type", "two_tower",
            "--train_file", "mm_tt_train.tsv", "--do_train", "--do_eval",
            "--log_dir", str(root / "logs_t")])
        after = counters()
        end = tuple(b - a for a, b in zip(before, mid))
        two = tuple(b - a for a, b in zip(mid, after))
        exp_end = (LAYERS * 2 * batches_v, LAYERS, LAYERS, 0, 0, 0)
        exp_two = (2 * LAYERS * 2 * batches_v, 2 * LAYERS * 2,
                   2 * LAYERS * 2, 0, 0, 0)
        check(end == exp_end and two == exp_two,
              f"phase 18c: launches (#1..#6) end {end} (expected "
              f"{exp_end}), two-tower {two} (expected {exp_two})")
        losses_e = [s["value"] for s in map(json.loads, open(
            root / "logs_e" / "scalars.jsonl")) if s["tag"] == "train/loss"]
        losses_t, ms_two = _finetune_ms(root / "logs_t")
        state_e = load_params(str(out / "roberta_image_large-v1-one_tower-"
                                  "cls-end-ce" / "best_f1.pt"))
        check(len(losses_e) == 1 and len(losses_t) == 2
              and all(map(math.isfinite, losses_e + losses_t))
              and state_e["head.classifier.dense_img.weight"].shape
              == (1024, 2 * IMAGE_WIDTH)
              and "roberta.embeddings.img2txt.weight" not in state_e,
              f"phase 18c: losses end {losses_e}, two-tower {losses_t}")
        del state_e
        print(f"phase 18c finetune-multimodal: one-tower end (the images at "
              f"the head, dense_img {2 * IMAGE_WIDTH} -> 1024) 1 step at "
              f"batch {MM_BATCH} S=510, loss {losses_e[0]:.6f}, launches "
              f"#1..#6 {end}, command {walls['one-tower end']:.3f} s; "
              f"two-tower begin 2 steps at batch {MM_BATCH} S=255 a tower, "
              f"losses {[round(x, 6) for x in losses_t]}, {ms_two:.2f} "
              f"ms/step through the CLI ({MM_BATCH / ms_two * 1e3:.2f} train "
              f"pairs/s), launches #1..#6 {two}, command "
              f"{walls['two-tower']:.3f} s; {card}", flush=True)

        # 18d: #2's and #3's contracts at the multimodal training shapes
        held = tuple(x + y + z for x, y, z in zip(one, end, two))
        gen = torch.Generator(device="cuda").manual_seed(seed)
        errs = phase_train_kernels(gen, [
            (f"bf16 S={S} B={MM_BATCH}", MM_BATCH, S, 16, 64, torch.bfloat16)
            for S in (510, 255)],
            SimpleNamespace(**dict(vars(TRAIN_FAMILY),
                                   name="phase 18d train kernels")))
        gc.collect()
        torch.cuda.empty_cache()

        # 18e: a text member on the same pairs, then ensemble
        text = root / "processed_text"
        run_cli(["prepare", "--data_dir", str(files["raw"]), "--output_dir",
                 str(text), "--seed", str(seed)])
        (text / "text_step.tsv").write_text("".join(open(
            text / "finetune_train_train.tsv", encoding="utf-8"
        ).readlines()[:MM_BATCH]), encoding="utf-8")
        text_cfg = root / "roberta_large_bf16.json"
        text_cfg.write_text(json.dumps(dict(json.loads(
            (ROOT / "configs" / "roberta_large.json").read_text()),
            dtype="bfloat16")))
        zero_counters()
        res, walls["finetune-text member"] = run_cli([
            "finetune-text", "--data_dir", str(text), "--output_dir",
            str(out), "--vocab_path", str(files["vocab"]),
            "--model_name", "roberta_large", "--config_file", str(text_cfg),
            "--max_seq_len", "50", "--max_seq_len_pv", "205",
            "--train_batch_size", str(MM_BATCH), "--epochs", "1",
            "--train_file", "text_step.tsv", "--bf16", "--total_steps",
            TOTAL_STEPS, "--seed", str(seed), "--do_train", "--do_pred"])
        pred_text = [o for o in res if "prediction_file" in o][-1]
        members = [(Path(pred_text["prediction_file"]).parent.name, 0.5,
                    0.8605), (run_b.name, 0.5, 0.8582)]
        res, walls["ensemble"] = run_cli([
            "ensemble", "--data_dir", str(root), "--ensemble_strategy",
            "threshold", "--models", json.dumps(members)])
        fused = read_prediction_file(res[-1]["output"])
        member_rows = [read_prediction_file(str(out / m /
                                                "deepAI_result_threshold="
                                                "0.5.jsonl"))
                       for m, _, _ in members]
        pairs = {(r[1], r[5]) for r in rows["test"]}
        check([len(m) for m in member_rows] == [len(rows["test"])] * 2
              and len(fused) == len(pairs) and {(r["src_item_id"],
                                                 r["tgt_item_id"])
                                                for r in fused} == pairs,
              f"phase 18e: {len(fused)} fused rows for {len(pairs)} pairs")
        want = {}
        for m_rows in member_rows:
            for r in m_rows:
                key = (r["src_item_id"], r["tgt_item_id"])
                want[key] = want.get(key, 0.0) + (
                    float(r["tgt_item_emb"].strip("[]").split(",")[0]) - 0.5)
        same = ensemble_predictions([(m, 0.5, f1) for m, (_, _, f1) in
                                     zip(member_rows, members)], "threshold")
        check(fused == same and all(
            float(r["tgt_item_emb"].strip("[]")) == want[
                (r["src_item_id"], r["tgt_item_id"])] for r in fused),
            "phase 18e: the fused probabilities differ from the members' "
            "sums")

        # 18f: model-soup of two epoch files of 18b's command
        _, walls["one-tower begin, 1 step"] = run_cli(mm + [
            "--ensemble", "begin", "--train_file", "mm_step.tsv",
            "--data_version", "v2", "--do_train"])
        epochs = [str(run_b / "multimodal_finetune_epoch-1.pt"),
                  str(out / "roberta_image_large-v2-one_tower-cls-begin-ce" /
                      "multimodal_finetune_epoch-1.pt")]
        res, walls["model-soup"] = run_cli([
            "model-soup", "--checkpoints", *epochs, "--output",
            str(root / "soup.pt")])
        text_launches = counters()
        soup = load_params(str(root / "soup.pt"))
        a, b = (load_params(p) for p in epochs)
        worse = [k for k in a if not torch.equal(
            soup[k].cuda(), (a[k].cuda() + b[k].cuda()) / 2.0)]
        moved = not torch.equal(a["roberta.embeddings.img2txt.weight"],
                                b["roberta.embeddings.img2txt.weight"])
        check(soup.keys() == a.keys() and not worse and moved,
              f"phase 18f: soup entries differing from (a + b) / 2: "
              f"{worse[:4]} (img2txt moved: {moved})")
        launches = tuple(h + t for h, t in zip(held, text_launches))
        check(not any(launches[3:]), f"phase 18: launches (#1..#6) "
              f"{launches}: #4-#6 counted")
        print(f"phase 18e ensemble --ensemble_strategy threshold: the text "
              f"member (finetune-text roberta_large, 1 step) and the "
              f"multimodal member, {len(rows['test'])} test rows each, "
              f"{len(fused)} fused rows, every fused score the sum of the "
              f"members' prob - 0.5 and equal to ensemble_predictions; "
              f"18f model-soup of two epoch files ({len(soup)} tensors) "
              f"equal to (a + b) / 2 on the card; wall times " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in walls.items())
              + f"; phase 18 launches #1..#6 {launches}; {card}",
              flush=True)
    return launches, errs


BASE_LAYERS = 12    # configs/roberta_base.json: the legacy member's encoder
LEGACY_PVS = 20     # key:value pairs an item in the 5-field rows
LEGACY_BATCH = 8    # scripts/train.sh step 8
# kernels vs plain attention, probabilities, by the model's dtype
LEGACY_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LEGACY_LENS = (512, 150, 50, 20)  # the distinct field widths, pvs first


def legacy_fields(item: dict, n_pvs: int = LEGACY_PVS) -> dict:
    """The five fields of a corpus item as the legacy rows hold them: the
    first ``n_pvs`` key:value pairs spaced into words (``key : value ;``),
    the title, the category as cate and cate_path, the industry."""
    pvs = " ; ".join(p.replace("#:#", " : ")
                     for p in item["item_pvs"].split("#;#")[:n_pvs])
    return {"pvs": pvs, "title": item["title"], "cate": item["cate_name"],
            "cate_path": item["cate_name"],
            "industry_name": item["industry_name"]}


def legacy_rows(raw: Path, pairs: str) -> list:
    """``pairs`` (a pair jsonl of the smoke corpus) as 5-field rows with
    src_/tgt_ fields, item ids and labels."""
    items = {d["item_id"]: d for d in map(json.loads, open(
        raw / "item_info.jsonl", encoding="utf-8"))}
    rows = []
    for pair in map(json.loads, open(raw / pairs, encoding="utf-8")):
        row = {"src_item_id": pair["src_item_id"],
               "tgt_item_id": pair["tgt_item_id"],
               "item_label": pair["item_label"]}
        for side in ("src", "tgt"):
            for k, v in legacy_fields(items[pair[f"{side}_item_id"]]).items():
                row[f"{side}_{k}"] = v
        rows.append(row)
    return rows


def write_jsonl(path: Path, rows: list) -> str:
    path.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n"
                            for r in rows), encoding="utf-8")
    return str(path)


def pretrain_items(raw: Path, tok, seed: int, batch: int = 16,
                   steps: int = 4) -> list:
    """The first items of the corpus (pvs spaced as in ``legacy_fields``)
    whose structure-aware examples, built as ``bert-pretrain`` builds them
    from ``seed``, fill exactly ``steps`` batches."""
    items = []
    for d in map(json.loads, open(raw / "item_info.jsonl", encoding="utf-8")):
        f = legacy_fields(d)
        items.append(dict(d, item_pvs=f["pvs"], cate_name_path=""))
    for start in range(len(items)):
        for n in range(1, 16):
            chosen = items[start:start + n]
            rng = random.Random(seed)
            count = sum(len(build_pretrain_examples(it, tok, 254, chosen,
                                                    rng)) for it in chosen)
            if count // batch == steps:
                return chosen
            if count // batch > steps:
                break
    raise CheckFailed("phase 19a: no run of items fills exactly 4 batches")


def _legacy_probs(cfg: ModelConfig, state: dict, ds) -> dict:
    """``BertAlignModel``'s probabilities on ``ds`` in batches of 8 through
    the kernels and through plain attention."""
    probs = {}
    for name, flash in (("kernels", True), ("plain", False)):
        model = BertAlignModel(cfg.replace(use_flash_attention=flash),
                               seed=None).eval()
        model.load_state_dict(state)
        got = []
        with torch.inference_mode():
            for batch, meta in ds.batches(LEGACY_BATCH):
                batch.pop("labels")
                feed = align_kwargs({k: torch.from_numpy(v).long().cuda()
                                     for k, v in batch.items()})
                got.append(model(**feed).probs.float().cpu().numpy()
                           [: meta["n_valid"]])
        probs[name] = np.concatenate(got)
        del model
    return probs


def legacy_step_profile(cfg: ModelConfig, seed: int, mode: str, ds) -> tuple:
    """phase 8's timing of ``finetune-bert`` steps through a ``Trainer`` at
    batch 8 in ``cfg``'s dtype with ``mode`` noise (FREE, PGD or MIX) on
    the batches of ``ds``, the first a warm-up, then one step under
    ``torch.profiler``: (ms/step, the profile's text)."""
    H = cfg.hidden_size
    trainer = Trainer(
        BertAlignModel(cfg, seed=seed),
        TrainConfig(seed=seed, train_batch_size=LEGACY_BATCH,
                    log_steps=10 ** 9, optimizer=OptimizerConfig(
                        learning_rate=2e-5, total_steps=16000)),
        batch_transform=align_kwargs,
        adversarial=(mode, 1e-2, 1e-2),
        noise_spec={"pvs_noise": (512, H), "title_noise": (150, H)}
    ).setup()
    out = _step_profile(trainer, [b for b, _ in ds.batches(LEGACY_BATCH)])
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_legacy(seed: int, card: str) -> tuple:
    """Phase 19: the legacy 5-field BERT member and TextCNN at
    configs/roberta_base.json's width (12 layers, hidden 768, 12 heads of
    64) with random weights, through ``cli.main``: ``bert-pretrain``,
    ``finetune-bert`` (fp32 MIX, then bf16 FREE), ``pred-bert``,
    ``finetune-text --model_name textcnn``; #1-#3 at N=12, B=8 and the
    field widths; the position rule.  Returns the launches of #1-#6 over
    the commands and the worst errors of #1 (``serving_err``) and of #2's
    and #3's contracts (``fwd_err``, ``bwd_err``) against their plain
    versions."""
    with segmenter(), tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        files = write_smoke_corpus(root, seed, n_train=320)
        tok = load_text_tokenizer(str(files["vocab"]))
        cfg_json = ROOT / "configs" / "roberta_base.json"
        mcfg = ModelConfig.from_json(str(cfg_json), vocab_size=len(tok),
                                     model_name="bert_legacy")
        check(mcfg.num_hidden_layers == BASE_LAYERS
              and mcfg.hidden_size == 768 and mcfg.num_attention_heads == 12
              and mcfg.head_dim == 64 and mcfg.intermediate_size == 3072
              and len(tok) == mcfg.vocab_size == VOCAB_ROWS
              and mcfg.max_position_embeddings == 512,
              "phase 19: not roberta_base")
        rows = legacy_rows(files["raw"], "item_train_pair.jsonl")
        n_tr, n_va = 6 * LEGACY_BATCH, 5 * LEGACY_BATCH
        data = {"train": write_jsonl(root / "train.jsonl", rows[:n_tr]),
                "valid": write_jsonl(root / "valid.jsonl",
                                     rows[n_tr:n_tr + n_va]),
                "bf16": write_jsonl(root / "bf16.jsonl",
                                    rows[n_tr + n_va:n_tr + n_va + 32]),
                "test": write_jsonl(root / "test.jsonl", legacy_rows(
                    files["raw"], "item_test_pair.jsonl"))}
        valid_ds = pairs_to_field_dataset(rows[n_tr:n_tr + n_va], tok)
        pvs_len = valid_ds.arrays["pvs_attention_mask"].sum(1)
        check(valid_ds.arrays["pvs_input_ids"].shape[1] == 512
              and pvs_len.max() < 511, "phase 19: the pvs pairs are not "
              "shorter rows padded to 512")
        vocab = ["--vocab_path", str(files["vocab"])]
        common = vocab + ["--config_file", str(cfg_json), "--seed", str(seed)]
        walls, launches = {}, [0] * 6

        def command(argv, expect, what):
            zero_counters()
            res, walls[what] = run_cli(argv)
            got = counters()
            check(got == expect, f"phase 19 {what}: launches (#1..#6) "
                  f"{got}, expected {expect}")
            for k in range(6):
                launches[k] += got[k]
            return res

        # 19a: bert-pretrain, S=256, batch 16, bf16, 4 steps
        pre_items = write_jsonl(root / "pretrain_items.jsonl",
                                pretrain_items(files["raw"], tok, seed))
        res = command(["bert-pretrain", "--item_info", pre_items,
                       "--output_dir", str(root / "pre"), "--max_seq_len",
                       "254", "--batch_size", "16", "--epochs", "1", "--bf16",
                       "--log_steps", "1", "--total_steps", TOTAL_STEPS,
                       "--log_dir", str(root / "logs_pre")] + common,
                      (0, 4 * BASE_LAYERS, 4 * BASE_LAYERS, 0, 0, 0),
                      "bert-pretrain")
        losses_pre, ms_pre = _finetune_ms(root / "logs_pre")
        pre_state = load_params(str(root / "pre" / "bert_pretrain.pt"))
        check(len(losses_pre) == 4 and all(map(math.isfinite, losses_pre))
              and pre_state["bert.post.token_type_embeddings.weight"].shape
              == (5, 768), f"phase 19a: losses {losses_pre}")
        print(f"phase 19a bert-pretrain: {res[-1]['examples']} structure-"
              f"aware examples, S=256 batch 16 bf16 dropout 0.1, 4 steps, "
              f"losses {[round(x, 6) for x in losses_pre]}, {ms_pre:.2f} "
              f"ms/step through the CLI, command "
              f"{walls['bert-pretrain']:.3f} s; {card}", flush=True)
        del pre_state

        # 19b: finetune-bert, fp32 MIX as train.sh step 8, then bf16 FREE
        ft = ["finetune-bert", "--batch_size", str(LEGACY_BATCH),
              "--epochs", "1", "--log_steps", "1", "--total_steps",
              TOTAL_STEPS, "--pretrained_model_path", str(root / "pre")]
        res = command(ft + ["--train_file", data["train"], "--valid_file",
                            data["valid"], "--adversarial", "MIX",
                            "--output_dir", str(root / "ft32"), "--log_dir",
                            str(root / "logs_ft32")] + common,
                      (5 * 5 * BASE_LAYERS, 6 * 5 * BASE_LAYERS,
                       6 * 5 * BASE_LAYERS, 0, 0, 0), "finetune-bert fp32 MIX")
        losses_32, ms_32 = _finetune_ms(root / "logs_ft32")
        check(len(losses_32) == 6 and all(map(math.isfinite, losses_32))
              and (root / "ft32" / "sim_eval_weight.npz").exists(),
              f"phase 19b: fp32 losses {losses_32}")
        print(f"phase 19b finetune-bert --adversarial MIX fp32: batch 8, "
              f"fields S=512/150/20/50/20, 6 steps, losses "
              f"{[round(x, 6) for x in losses_32]}, {ms_32:.2f} ms/step "
              f"through the CLI, eval best_f1 {res[-1]['best_f1']:.4f} on "
              f"{n_va} rows, command "
              f"{walls['finetune-bert fp32 MIX']:.3f} s; {card}", flush=True)
        command(ft + ["--train_file", data["bf16"], "--adversarial", "FREE",
                      "--bf16", "--output_dir", str(root / "ft16"),
                      "--log_dir", str(root / "logs_ft16")] + common,
                (0, 4 * 5 * BASE_LAYERS, 4 * 5 * BASE_LAYERS, 0, 0, 0),
                "finetune-bert bf16 FREE")
        losses_16, ms_16 = _finetune_ms(root / "logs_ft16")
        check(len(losses_16) == 4 and all(map(math.isfinite, losses_16)),
              f"phase 19b: bf16 losses {losses_16}")
        bf16_ds = pairs_to_field_dataset(
            rows[n_tr + n_va:n_tr + n_va + 32], tok)
        step_ms, profiled = legacy_step_profile(
            mcfg.replace(dtype="bfloat16"), seed, "FREE", bf16_ds)
        print(f"phase 19b finetune-bert --adversarial FREE --bf16: 4 steps "
              f"at batch 8, losses {[round(x, 6) for x in losses_16]}, "
              f"{ms_16:.2f} ms/step through the CLI "
              f"({LEGACY_BATCH / ms_16 * 1e3:.2f} train pairs/s), command "
              f"{walls['finetune-bert bf16 FREE']:.3f} s; direct: "
              f"{step_ms:.2f} ms/step over 3 timed steps, {profiled}; {card}",
              flush=True)
        step_ms, profiled = legacy_step_profile(mcfg, seed, "MIX", bf16_ds)
        print(f"phase 19b finetune-bert --adversarial MIX fp32 direct: "
              f"{step_ms:.2f} ms/step over 3 timed steps at batch 8, "
              f"{profiled}; {card}", flush=True)

        # 19f: a pvs pair that fills all 512 tokens is refused on the host
        full = [dict(r) for r in rows[:LEGACY_BATCH]]
        full[3]["src_pvs"] = " ; ".join(
            [legacy_fields(json.loads(line), 30)["pvs"] for line in open(
                files["raw"] / "item_info.jsonl", encoding="utf-8")][:8])
        full_ds = pairs_to_field_dataset(full, tok)
        check(full_ds.arrays["pvs_attention_mask"][3].sum() == 512,
              "phase 19f: the long pvs pair does not fill 512 tokens")
        zero_counters()
        refused = None
        try:
            pairs_to_field_dataset(full, tok, config=mcfg)
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "row 3 of pvs_input_ids" in refused
              and not any(counters()),
              f"phase 19f: the full row was not refused on the host "
              f"({refused})")
        print(f"phase 19f position rule: rows whose row 3 holds a 512-token "
              f"pvs pair are refused where the data layer builds them "
              f"({refused[:60]}...), no kernel launched; 19b trained padded "
              f"width 512 with rows of {int(pvs_len.min())}-"
              f"{int(pvs_len.max())} real tokens", flush=True)

        # 19c: pred-bert on the test pairs with 19b's fp32 weights
        n_test = len(open(data["test"]).readlines())
        res = command(["pred-bert", "--test_file", data["test"], "--params",
                       str(root / "ft32" / "bert_align.pt"), "--output",
                       str(root / "pred.jsonl"), "--batch_size",
                       str(LEGACY_BATCH), "--config_file", str(cfg_json)]
                      + vocab,
                      (-(-n_test // LEGACY_BATCH) * 5 * BASE_LAYERS, 0, 0, 0,
                       0, 0), "pred-bert")
        rows_p, filed = _jsonl_probs(str(root / "pred.jsonl"))
        test_ds = pairs_to_field_dataset(
            [dict(r, item_label=0) for r in map(json.loads, open(
                data["test"], encoding="utf-8"))], tok)
        state_32 = load_params(str(root / "ft32" / "bert_align.pt"))
        probs = _legacy_probs(mcfg, state_32, test_ds)
        probs_16 = _legacy_probs(mcfg.replace(dtype="bfloat16"), state_32,
                                 test_ds)
        diff = np.abs(probs["kernels"] - probs["plain"]).max()
        diff_16 = np.abs(probs_16["kernels"] - probs_16["plain"]).max()
        check(res[-1]["pairs"] == len(rows_p) == n_test
              and np.isfinite(filed).all() and np.isfinite(diff_16)
              and diff <= LEGACY_TOL["float32"]
              and diff_16 <= LEGACY_TOL["bfloat16"]
              and np.array_equal(probs["kernels"], filed.astype(np.float32)),
              f"phase 19c: {len(rows_p)} lines for {n_test} pairs, kernels "
              f"vs plain fp32 {diff}, bf16 {diff_16}, the file equal to the "
              f"kernels: "
              f"{np.array_equal(probs['kernels'], filed.astype(np.float32))}")
        print(f"phase 19c pred-bert: {n_test} test pairs, one line each, "
              f"fp32; probabilities on the kernels vs plain attention max "
              f"diff {diff:.3e} (limit {LEGACY_TOL['float32']}), equal to "
              f"the file; the same weights in bf16 {diff_16:.3e} (limit "
              f"{LEGACY_TOL['bfloat16']}); command "
              f"{walls['pred-bert']:.3f} s; {card}", flush=True)
        del state_32

        # 19d: TextCNN two-tower through finetune-text
        processed = root / "processed"
        prep, _ = run_cli(["prepare", "--data_dir", str(files["raw"]),
                           "--output_dir", str(processed), "--seed",
                           str(seed)])
        n_train = len(read_finetune_tsv(prep[-1]["train"]))
        res = command(["finetune-text", "--data_dir", str(processed),
                       "--output_dir", str(root / "cnn"), "--model_name",
                       "textcnn", "--config_file",
                       str(ROOT / "configs" / "textcnn.json"),
                       "--interaction_type", "two_tower", "--max_seq_len",
                       "50", "--max_seq_len_pv", "205", "--train_batch_size",
                       "64", "--eval_batch_size", "64", "--learning_rate",
                       "1e-3", "--epochs", "1", "--log_steps", "1",
                       "--log_dir", str(root / "logs_cnn"), "--do_train",
                       "--do_eval", "--do_pred", "--seed", str(seed)]
                      + vocab, (0,) * 6, "finetune-text textcnn")
        losses_cnn, ms_cnn = _finetune_ms(root / "logs_cnn")
        pred = [o for o in res if "prediction_file" in o][-1]
        rows_c, probs_c = _jsonl_probs(pred["prediction_file"])
        ev = [o for o in res if "sweep" in o][-1]
        check(n_train // 64 == 4 and len(losses_cnn) == 4
              and all(map(math.isfinite, losses_cnn))
              and pred["prediction_split"] == "test" and len(rows_c) == n_test
              and np.isfinite(probs_c).all(),
              f"phase 19d: {n_train} train rows, losses {losses_cnn}, "
              f"{len(rows_c)} predictions")
        print(f"phase 19d finetune-text textcnn two-tower: configs/textcnn."
              f"json (filters 1/2/3/5 x 128, embeddings 768), S=255 a "
              f"tower, batch 64, lr 1e-3, 4 steps, losses "
              f"{[round(x, 6) for x in losses_cnn]}, {ms_cnn:.2f} ms/step "
              f"through the CLI, eval best_f1 {ev['best_f1']:.4f}, "
              f"{len(rows_c)} test predictions, no attention kernel; "
              f"command {walls['finetune-text textcnn']:.3f} s; {card}",
              flush=True)

    # 19e: #1, #2's and #3's contracts at N=12, B=8 and the field widths
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtypes = (("bf16", torch.bfloat16), ("fp32", torch.float32))
    serving, timed = 0.0, {}
    for dname, dt in dtypes:
        for S in LEGACY_LENS:
            row, err = kernel_case(f"{dname} S={S} N=12", LEGACY_BATCH, S, 12,
                                   64, dt, False, gen,
                                   phase="phase 19e kernel")
            serving = max(serving, err)
            if S == LEGACY_LENS[0]:
                timed[("#1", dname)] = row
    # every shape the phase's commands train at: finetune-bert's fields at
    # B=8 in both dtypes, bert-pretrain's S=256 at B=16 in bf16
    errs = phase_train_kernels(gen, [
        (f"{dname} S={S} N=12", LEGACY_BATCH, S, 12, 64, dt)
        for dname, dt in dtypes for S in LEGACY_LENS]
        + [("bf16 S=256 B=16 N=12", 16, 256, 12, 64, torch.bfloat16)],
        SimpleNamespace(**dict(vars(TRAIN_FAMILY),
                               name="phase 19e train kernels")))
    off_out, off = phase_offgrid_fp32(gen, SimpleNamespace(**dict(
        vars(TRAIN_FAMILY), name="phase 19e train kernels")), OFFGRID_LEGACY)
    errs["fwd_err"] = max(errs["fwd_err"], off_out)
    errs["bwd_err"] = [max(a, b) for a, b in zip(errs["bwd_err"], off)]
    for dname, dt in dtypes:
        rows_t = time_train_kernels(gen, LEGACY_BATCH, LEGACY_LENS[0], 12, dt,
                                    name="phase 19e train kernels")
        timed[("#2", dname)], timed[("#3", dname)] = rows_t["fwd"], \
            rows_t["bwd"]
    check(not any(launches[3:]), f"phase 19: launches (#1..#6) "
          f"{tuple(launches)}: #4-#6 counted")
    print("phase 19e at B=8, S=512, N=12, H=64: " + "; ".join(
        f"{k} {d} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, sdpa "
        f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} {r['bound_by']})"
        for (k, d), r in timed.items()) + f"; phase 19 launches #1..#6 "
        f"{tuple(launches)}; wall times " + ", ".join(
            f"{k} {v:.3f} s" for k, v in walls.items()) + f"; {card}",
        flush=True)
    # the kernels line's fp32 numbers of #1 and #2's contract
    f32 = {k: {key: timed[(k, "fp32")][key] for key in
               ("ms", "library_ms", "bound_ms", "bound_by")}
           for k in ("#1", "#2")}
    return tuple(launches), dict(errs, serving_err=serving, f32=f32)


IMG_ITEMS = 512     # phase 20's corpus: items with a main image each
IMG_DUMP = 288      # scripts/train.sh IMG_EMB_SIZE: step 6a's dump
IMG_TRAIN = 800     # scripts/train.sh IMG_SIZE: step 7 and predict.sh p5
NF_BATCH, NF_ACCUM = 16, 4  # step 7's batch and gradient accumulation
NF_WIDTH = 2304     # eca_nfnet_l0's pooled features (1536 x 1.5)
IMG_PAIRS = {"train": 128, "valid": 32, "test": 32}
# keys of data/images.py:CATE2YOLO_CLASS, so the crop pass runs on them
IMG_CATES = ("手机", "笔记本电脑", "显示器", "电脑椅")
EMB_TOL = 1e-4      # the dump vs direct fp32 forwards, of max|ref|
IMG_TOL = 2e-2      # bf16 vs fp32 probabilities
NORM_TOL = 1e-6     # uint8 normalised on the card vs the host
ACC_TOL = 1e-4      # accumulated gradient mean vs one batch, of max|ref|
IMAGE_GROUPS = (("convolutions", ("conv", "fprop", "dgrad", "wgrad",
                                  "implicit", "cudnn")),
                ("elementwise", ("elementwise",)))


def product_image(rs: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A product on a plain studio background: a block of 35-70% of each
    side at a random place, a smooth two-colour gradient with stripes,
    every channel at least 35 below the background's."""
    img = np.empty((h, w, 3), np.uint8)
    img[:] = rs.randint(215, 256, 3)
    ph, pw = int(h * rs.uniform(0.35, 0.7)), int(w * rs.uniform(0.35, 0.7))
    y, x = rs.randint(0, h - ph + 1), rs.randint(0, w - pw + 1)
    c0, c1 = rs.randint(0, 150, 3), rs.randint(0, 150, 3)
    block = c0 + (c1 - c0) * np.linspace(0.0, 1.0, pw)[None, :, None]
    stripes = (np.arange(ph)[:, None, None] // rs.randint(8, 40)) % 2 * 30
    img[y:y + ph, x:x + pw] = np.clip(block + stripes, 0, 255)
    return img


def write_image_corpus(root: Path, seed: int) -> dict:
    """Phase 16's corpus at IMG_ITEMS items in four whitelisted categories,
    each item with a JPEG main image of 600-1000 px a side (quality 90),
    and IMG_PAIRS train, valid and test pairs."""
    from PIL import Image

    files = write_smoke_corpus(root, seed, n_items=IMG_ITEMS,
                               n_train=IMG_PAIRS["train"],
                               n_test=IMG_PAIRS["test"], n_mine=0)
    raw = files["raw"]
    (raw / "item_images").mkdir()
    rs = np.random.RandomState(seed)
    items = [json.loads(line) for line in
             open(raw / "item_info.jsonl", encoding="utf-8")]
    with open(raw / "item_info.jsonl", "w", encoding="utf-8") as w:
        for i, item in enumerate(items):
            item.update(cate_name=IMG_CATES[i % 4],
                        item_image_name=f"{item['item_id']}.jpg")
            h, wd = rs.randint(600, 1001, 2)
            Image.fromarray(product_image(rs, h, wd)).save(
                raw / "item_images" / item["item_image_name"], quality=90)
            w.write(json.dumps(item, ensure_ascii=False) + "\n")
    with open(raw / "item_valid_pair.jsonl", "w") as w:
        for k in range(IMG_PAIRS["valid"]):
            a = rs.randint(IMG_ITEMS)
            b = (a + 4 * rs.randint(1, IMG_ITEMS // 4)) % IMG_ITEMS
            w.write(json.dumps({"src_item_id": f"i{a}",
                                "tgt_item_id": f"i{b}",
                                "item_label": str(k % 2)}) + "\n")
    return files


def _rel_err(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _timm_checkpoint(path: Path, seed: int) -> str:
    """``synth_corpus``'s random eca_nfnet_l0 from ``seed``, saved by
    ``torch.save`` under timm's names; the port's converter must give the
    weights back exactly."""
    from item_alignment_torch.utils.timm_import import convert_timm_nfnet

    tower = random_nfnet(seed)
    sd = timm_nfnet_state_dict(tower)
    back = convert_timm_nfnet({k: v.numpy() for k, v in sd.items()})
    state = tower.state_dict()
    check(back.keys() == state.keys() and all(
        np.array_equal(back[k], state[k].numpy()) for k in state),
        "phase 20: the timm checkpoint does not convert back exactly")
    torch.save(sd, path)
    return str(path)


def _encode_timed(store: list):
    """A wrapper of ``dump_image_embeddings`` whose encoder appends each
    batch's wall seconds (host to device, forward, back) to ``store``."""
    def around(fn):
        def call(item_ids, image_paths, encode_fn, *args, **kw):
            def encode(imgs):
                t0 = time.perf_counter()
                out = encode_fn(imgs)
                store.append(time.perf_counter() - t0)
                return out
            return fn(item_ids, image_paths, encode, *args, **kw)
        return call
    return around


def _image_probs(cfg: ModelConfig, state: dict, batch: dict) -> tuple:
    """An ImageTwoTower in ``cfg``'s dtype with ``state``: probabilities
    and (src, tgt) embeddings of one host batch, in fp32 on the host."""
    from item_alignment_torch.models.image import ImageTwoTower

    model = ImageTwoTower(cfg, seed=None).eval()
    model.load_state_dict(state)
    with torch.inference_mode():
        out = model(torch.from_numpy(batch["images_1"]).cuda(),
                    torch.from_numpy(batch["images_2"]).cuda())
    res = tuple(x.float().cpu().numpy()
                for x in (out.probs, out.src_embeds, out.tgt_embeds))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _timed_steps(trainer, batches: list, accum: int, steps: int = 4
                 ) -> float:
    """ms per optimizer step of ``accum`` micro-batches, over ``steps - 1``
    steps after one warm-up, ``batches`` cycled."""
    times = []
    for k in range(steps):
        t0 = time.perf_counter()
        for j in range(accum):
            trainer.train_step(batches[(k * accum + j) % len(batches)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * sum(times[1:]) / (steps - 1)


def _accumulation_check(state: dict, seed: int) -> float:
    """At IMG_DUMP in fp32 with dropout 0: the gradient mean that the
    optimizer holds after NF_ACCUM micro-batches of 4 pairs (what it hands
    AdamW) against the gradients of one batch of the same 16 pairs; the
    worst error over the parameters, each of its max|ref|."""
    from item_alignment_torch.models.image import ImageTwoTower

    cfg = ModelConfig(model_name="eca_nfnet_l0",
                      image_model_name="eca_nfnet_l0", image_size=IMG_DUMP,
                      interaction_type="two_tower", hidden_dropout_prob=0.0)
    model = ImageTwoTower(cfg, seed=None)
    model.load_state_dict(state)
    rs = np.random.RandomState(seed + 20)
    n = 4 * NF_ACCUM
    batch = {"images_1": rs.randint(0, 256, (n, IMG_DUMP, IMG_DUMP, 3),
                                    np.uint8),
             "images_2": rs.randint(0, 256, (n, IMG_DUMP, IMG_DUMP, 3),
                                    np.uint8),
             "labels": rs.randint(0, 2, n).astype(np.int32)}
    model(**{k: torch.from_numpy(v).cuda() if k != "labels" else
             torch.from_numpy(v).long().cuda() for k, v in batch.items()},
          deterministic=False, dropout_seed=0).loss.backward()
    ref = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    trainer = Trainer(model, TrainConfig(
        seed=seed, train_batch_size=4, log_steps=10 ** 9,
        optimizer=OptimizerConfig(learning_rate=1e-4, total_steps=100,
                                  grad_accumulation_steps=NF_ACCUM))).setup()
    held = {}

    def hold(update):
        def call(grads):
            held.update({k: g.detach().clone() for k, g in grads.items()})
            return update(grads)
        return call

    with wrapped(trainer.optimizer.adamw, "update", hold):
        for k in range(NF_ACCUM):
            trainer.train_step({key: v[4 * k:4 * k + 4]
                                for key, v in batch.items()})
    check(held.keys() == ref.keys(), "phase 20b: AdamW got no gradients")
    worst = max((held[k] - ref[k]).abs().max().item()
                / max(ref[k].abs().max().item(), 1e-30) for k in ref)
    del model, trainer, ref, held
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def pretrained_like_resnet(tower, images: torch.Tensor) -> None:
    """Make a random ResNetV2 behave as a trained one does for the bf16
    check: each block's conv3 at a tenth of its draw (timm initialises it
    at 0, ``zero_init_last``, so a trained one stays small), then every
    AffineAct (a folded BatchNorm) set from the statistics of its input on
    ``images`` in one fp32 forward, in order: ``scale = 1 / sqrt(var +
    1e-5)``, ``bias = -mean * scale``.  With identity affines the
    activations grow block by block until the probabilities saturate; with
    folded statistics but full-size conv3s the random net is chaotic, and
    bf16 rounding alone moves its probabilities past IMG_TOL."""
    from item_alignment_torch.models.image import AffineAct, PreActBottleneck

    with torch.no_grad():
        for m in tower.modules():
            if isinstance(m, PreActBottleneck):
                m.conv3.weight.mul_(0.1)

    def fold(module, args):
        x = args[0].float()
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        module.scale.copy_(torch.rsqrt(var + 1e-5))
        module.bias.copy_(-mean * module.scale)

    hooks = [m.register_forward_pre_hook(fold) for m in tower.modules()
             if isinstance(m, AffineAct)]
    try:
        with torch.no_grad():
            tower(images)
    finally:
        for h in hooks:
            h.remove()


def _live(probs: np.ndarray) -> bool:
    """Whether some probability is off 0 and 1 (a bf16-vs-fp32 comparison
    of saturated probabilities shows nothing)."""
    return bool(((probs > 1e-3) & (probs < 1 - 1e-3)).any())


def _other_backbone(config: str, side: int, seed: int, card: str) -> str:
    """Phase 20c: a two-tower train step of ``config``'s backbone at batch
    NF_BATCH in bf16 (one warm-up, three timed), then the trained weights'
    bf16 probabilities on one batch against fp32."""
    from item_alignment_torch.models.image import ImageTwoTower

    cfg = ModelConfig.from_json(str(ROOT / "configs" / config),
                                dtype="bfloat16",
                                interaction_type="two_tower")
    model = ImageTwoTower(cfg, seed=seed)
    tower = model.tower
    if cfg.image_model_name.startswith("vit"):
        check((tower.dim, tower.depth, tower.heads) == (1024, 24, 16)
              and tower.pos_embed.shape[1] == (side // 16) ** 2 + 1 == 577,
              "phase 20c: not ViT-L/16 at 384")
    rs = np.random.RandomState(seed)
    batches = [{"images_1": rs.randint(0, 256, (NF_BATCH, side, side, 3),
                                       np.uint8),
                "images_2": rs.randint(0, 256, (NF_BATCH, side, side, 3),
                                       np.uint8),
                "labels": rs.randint(0, 2, NF_BATCH).astype(np.int32)}
               for _ in range(4)]
    if not cfg.image_model_name.startswith("vit"):
        from item_alignment_torch.models.image import maybe_normalize_uint8

        pretrained_like_resnet(tower, maybe_normalize_uint8(
            torch.from_numpy(batches[0]["images_1"]).cuda()))
    trainer = Trainer(model, TrainConfig(
        seed=seed, train_batch_size=NF_BATCH, log_steps=10 ** 9,
        optimizer=OptimizerConfig(learning_rate=1e-4,
                                  total_steps=16000))).setup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = _timed_steps(trainer, batches, 1)
    peak = torch.cuda.max_memory_allocated()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    p16 = _image_probs(cfg, state, batches[0])[0]
    p32 = _image_probs(cfg.replace(dtype="float32"), state, batches[0])[0]
    diff = float(np.abs(p16 - p32).max())
    check(np.isfinite(p16).all() and diff <= IMG_TOL and _live(p32),
          f"phase 20c {config}: bf16 vs fp32 probs {diff} (fp32 probs "
          f"{p32.min()}-{p32.max()})")
    return (f"{cfg.image_model_name} at {side} px (tower "
            f"{type(tower).__name__}, {tower.num_features} features): "
            f"{step_ms:.2f} ms/step at batch {NF_BATCH} pairs in bf16 "
            f"({NF_BATCH / step_ms * 1e3:.2f} train pairs/s), peak memory "
            f"{peak / 2 ** 30:.2f} GiB, bf16 vs fp32 probs {diff:.3e} "
            f"(limit {IMG_TOL}; fp32 probs {p32.min():.4f}-{p32.max():.4f})")


def phase_images(seed: int, card: str) -> tuple:
    """Phase 20: the image family through ``cli.main`` on the card with
    random weights from ``seed``: (a) scripts/train.sh step 6a, the crops
    and the eca_nfnet_l0 embedding dump at 288 from a timm-named
    checkpoint, then the TSVs through a finetune-multimodal step at
    configs/roberta_image_large.json's width; (b) step 7 and predict.sh p5,
    the uint8 shards at 800 and ``finetune-image`` (batch 16, accumulation
    4, bf16) and its prediction, then that step timed, profiled and
    counted through a ``Trainer``, and the accumulation held against one
    batch; (c) ViT-L/16 at 384 and ResNetV2-50 at 288.  Returns the
    launches of #1-#6 over the image commands (none: no attention kernel
    is on this path)."""
    from torch.utils.flop_counter import FlopCounterMode

    from item_alignment_torch.data import images as data_images
    from item_alignment_torch.data.images import (
        eval_transform,
        load_image,
        normalize,
    )
    from item_alignment_torch.data.prepare import read_tsv
    from item_alignment_torch.models.image import maybe_normalize_uint8
    from item_alignment_torch.utils.hf_import import load_torch_state_dict
    from item_alignment_torch.utils.timm_import import load_timm_backbone

    with segmenter(), tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        files = write_image_corpus(root, seed)
        raw = files["raw"]
        ckpt = _timm_checkpoint(root / "eca_nfnet_l0.bin", seed)
        corpus_s = time.perf_counter() - t0
        walls = {}

        # 20a: step 6a, the crops and the dump at 288
        zero_counters()  # the image family's main path starts here
        res, walls["prepare --object_detection"] = run_cli([
            "prepare", "--data_dir", str(raw), "--output_dir", str(raw),
            "--only_image", "--object_detection", "--min_crop_ratio", "0.1"])
        crops = {k: v for k, v in res[-1].items() if k != "output_dir"}
        check(crops["missing"] == 0 and crops["cropped"] >= 0.9 * IMG_ITEMS,
              f"phase 20a: crops {crops}")
        processed = root / "processed_image"
        encode_s = []
        torch.cuda.reset_peak_memory_stats()
        with wrapped(data_images, "dump_image_embeddings",
                     _encode_timed(encode_s)):
            prep, walls["prepare --with_image"] = run_cli([
                "prepare", "--data_dir", str(raw), "--output_dir",
                str(processed), "--with_image", "--cv_model_name",
                "eca_nfnet_l0", "--pretrained_model_path", ckpt,
                "--image_size", str(IMG_DUMP), "--batch_size", "32",
                "--seed", str(seed)])
        dump_peak = torch.cuda.max_memory_allocated()
        launches = counters()
        with open(processed / "image_embedding.json", encoding="utf-8") as r:
            dumped = {k: np.asarray(v, np.float32)
                      for k, v in json.load(r).items()}
        check(len(dumped) == IMG_ITEMS and all(
            v.shape == (NF_WIDTH,) and np.isfinite(v).all() and v.any()
            for v in dumped.values()), "phase 20a: image_embedding.json")
        # eight items through the tower directly, on the card and the CPU
        ids8 = [f"i{k}" for k in range(0, IMG_ITEMS, IMG_ITEMS // 8)]
        imgs8 = np.stack([eval_transform(load_image(str(
            raw / "item_images_cropped" / f"{iid}.jpg")), IMG_DUMP)
            for iid in ids8])
        tower = nfnet_tower().cuda().eval()
        check(tower.num_features == NF_WIDTH, "phase 20: not eca_nfnet_l0")
        tower.load_state_dict(load_timm_backbone(
            tower.state_dict(), load_torch_state_dict(ckpt), "eca_nfnet_l0"))
        with torch.inference_mode():
            ref = tower(torch.from_numpy(imgs8).cuda()).cpu().numpy()
            got = np.stack([dumped[iid] for iid in ids8])
            err_card = _rel_err(got, ref)
            batch32 = torch.from_numpy(np.repeat(imgs8, 4, axis=0)).cuda()
            # the first batch carries cuDNN's first-call set-up
            encode_ms = 1e3 * float(np.median(encode_s[1:]))
            profiled = profile_step(lambda: tower(batch32).cpu(), encode_ms,
                                    IMAGE_GROUPS, top=4)
            tower.cpu()
            err_cpu = _rel_err(got, tower(torch.from_numpy(imgs8)).numpy())
        del tower, batch32
        gc.collect()
        torch.cuda.empty_cache()
        check(err_card <= EMB_TOL and err_cpu <= EMB_TOL,
              f"phase 20a: dumped vectors vs direct fp32 forwards: card "
              f"{err_card}, CPU {err_cpu} (limit {EMB_TOL})")
        rows = read_tsv(prep[-1]["train"])
        check(len(rows) >= 32 and {len(r) for r in rows} == {9}
              and np.array_equal(np.asarray(rows[0][4].split(","),
                                            np.float32), dumped[rows[0][1]]),
              "phase 20a: the --with_image TSVs")
        print(f"phase 20a step 6a: {IMG_ITEMS} items with JPEG main images "
              f"of 600-1000 px (written with the timm checkpoint in "
              f"{corpus_s:.3f} s); prepare --object_detection (saliency) "
              f"{crops}, {walls['prepare --object_detection']:.3f} s; "
              f"prepare --with_image through eca_nfnet_l0 at {IMG_DUMP} px, "
              f"batch 32, fp32: {len(dumped)} vectors of {NF_WIDTH}, "
              f"command {walls['prepare --with_image']:.3f} s "
              f"({IMG_ITEMS / walls['prepare --with_image']:.2f} images/s), "
              f"encode {sum(encode_s):.3f} s in {len(encode_s)} batches "
              f"({IMG_ITEMS / sum(encode_s):.2f} images/s; the first batch "
              f"{1e3 * encode_s[0]:.2f} ms, the median of the others "
              f"{encode_ms:.2f} ms, {32 / encode_ms * 1e3:.2f} images/s), "
              f"peak memory {dump_peak / 2 ** 30:.2f} GiB; "
              f"eight items vs direct fp32 forwards: card {err_card:.3e}, "
              f"CPU {err_cpu:.3e} of max|ref| (limit {EMB_TOL}); one encode "
              f"batch of 32: {profiled}; {card}", flush=True)

        # the TSVs through one finetune-multimodal step at phase 18's shape
        (processed / "mm_step.tsv").write_text("".join(
            "\t".join(r) + "\n" for r in rows[:32]), encoding="utf-8")
        cfg_json = root / "roberta_image_large_bf16.json"
        cfg_json.write_text(json.dumps(dict(json.loads(
            (ROOT / "configs" / "roberta_image_large.json").read_text()),
            dtype="bfloat16")))
        zero_counters()
        _, walls["finetune-multimodal, 1 step"] = run_cli([
            "finetune-multimodal", "--data_dir", str(processed),
            "--output_dir", str(root / "output"), "--vocab_path",
            str(files["vocab"]), "--model_name", "roberta_image_large",
            "--config_file", str(cfg_json), "--image_hidden_size",
            str(NF_WIDTH), "--max_seq_len", "50", "--max_seq_len_pv", "205",
            "--train_batch_size", "32", "--epochs", "1", "--train_file",
            "mm_step.tsv", "--valid_file", "none.tsv", "--bf16",
            "--log_steps", "1", "--log_dir", str(root / "logs_mm"),
            "--total_steps", TOTAL_STEPS, "--seed", str(seed), "--do_train"])
        mm = counters()
        mm_loss, = [s["value"] for s in map(json.loads, open(
            root / "logs_mm" / "scalars.jsonl")) if s["tag"] == "train/loss"]
        check(math.isfinite(mm_loss) and mm == (0, LAYERS, LAYERS, 0, 0, 0),
              f"phase 20a: finetune-multimodal on the dumped vectors: loss "
              f"{mm_loss}, launches {mm}")
        print(f"phase 20a the TSVs' {NF_WIDTH}-wide image columns through "
              f"finetune-multimodal roberta_image_large (batch 32, S=510, "
              f"bf16), 1 step: loss {mm_loss:.6f}, launches #1..#6 {mm} "
              f"(phase 18's path, not phase 20's), command "
              f"{walls['finetune-multimodal, 1 step']:.3f} s", flush=True)

        # 20b: step 7 and p5, the shards at 800 and finetune-image
        zero_counters()  # the image family's main path again
        shards_dir = root / "image_shards"
        res, walls["prepare --only_image"] = run_cli([
            "prepare", "--data_dir", str(raw), "--output_dir",
            str(shards_dir), "--only_image", "--dtypes", "train,valid,test",
            "--image_size", str(IMG_TRAIN), "--seed", str(seed)])
        written = res[-1]
        shard_mb = sum(os.path.getsize(p) for v in written.values()
                       for p in v) / 2 ** 20
        out = root / "output"
        # --scan_steps 1: the 8 micro-batches would be one chunk of the
        # default 8, logged once; each is logged, so the stamps time it
        res, walls["finetune-image"] = run_cli([
            "finetune-image", "--data_dir", str(root), "--output_dir",
            str(out), "--shards", *written["train"], "--valid_shards",
            *written["valid"], "--pretrained_model_path", ckpt,
            "--model_name", "eca_nfnet_l0", "--data_version", "v6",
            "--image_size", str(IMG_TRAIN), "--train_batch_size",
            str(NF_BATCH), "--gradient_accumulation_steps", str(NF_ACCUM),
            "--learning_rate", "1e-4", "--epochs", "1", "--bf16",
            "--do_train", "--do_eval", "--log_steps", "1", "--log_dir",
            str(root / "logs_img"), "--scan_steps", "1", "--seed", str(seed)])
        losses, cli_ms = _finetune_ms(root / "logs_img")
        run_dir = out / "eca_nfnet_l0-v6-two_tower-cls-NA-ce"
        micro = IMG_PAIRS["train"] // NF_BATCH
        best = load_params(str(run_dir / "best_f1.pt"))
        moved = not torch.equal(best["NFNet_0.stem0.weight"], torch.load(
            ckpt, weights_only=True)["stem.conv1.weight"])
        check(len(losses) == micro and all(map(math.isfinite, losses))
              and moved and (run_dir / "image_finetune_epoch-1.pt").is_file(),
              f"phase 20b: finetune-image losses {losses}, weights moved "
              f"{moved}")
        res, walls["finetune-image --do_pred"] = run_cli([
            "finetune-image", "--data_dir", str(root), "--output_dir",
            str(out), "--shards", *written["test"], "--model_name",
            "eca_nfnet_l0", "--data_version", "v6", "--image_size",
            str(IMG_TRAIN), "--train_batch_size", str(NF_BATCH),
            "--eval_batch_size", str(NF_BATCH), "--interaction_type",
            "two_tower", "--threshold", "0.4", "--do_pred",
            "--file_state_dict", str(run_dir / "best_f1.pt"), "--seed",
            str(seed)])
        main_path = tuple(a + b for a, b in zip(launches, counters()))
        check(not any(main_path), f"phase 20: launches (#1..#6) "
              f"{main_path} on the image path")
        pred = [json.loads(line) for line in open(res[-1]["prediction_file"])]
        pred_emb = np.array([[np.asarray(r[k].strip("[]").split(","),
                                         np.float32)
                              for k in ("src_item_emb", "tgt_item_emb")]
                             for r in pred])
        check(pred_emb.shape == (IMG_PAIRS["test"], 2, NF_WIDTH)
              and np.isfinite(pred_emb).all(),
              f"phase 20b: the p5 prediction file {pred_emb.shape}")
        test_ds = cli._load_shard_dataset(written["test"], IMG_TRAIN)
        batch = next(test_ds.batches(NF_BATCH))[0]
        cfg = ModelConfig(model_name="eca_nfnet_l0",
                          image_model_name="eca_nfnet_l0",
                          image_size=IMG_TRAIN, interaction_type="two_tower")
        p32, src32, tgt32 = _image_probs(cfg, best, batch)
        p16 = _image_probs(cfg.replace(dtype="bfloat16"), best, batch)[0]
        bf16_diff = float(np.abs(p16 - p32).max())
        file_err = _rel_err(pred_emb[:NF_BATCH],
                            np.stack([src32, tgt32], axis=1))
        u8 = batch["images_1"]
        norm_diff = float(np.abs(maybe_normalize_uint8(
            torch.from_numpy(u8).cuda()).cpu().numpy() - normalize(u8)).max())
        check(bf16_diff <= IMG_TOL and _live(p32) and file_err <= EMB_TOL
              and norm_diff <= NORM_TOL,
              f"phase 20b: bf16 vs fp32 probs {bf16_diff} (limit {IMG_TOL}),"
              f" the p5 file vs a direct fp32 forward {file_err} (limit "
              f"{EMB_TOL}), uint8 normalised on the card vs the host "
              f"{norm_diff} (limit {NORM_TOL})")

        # the same step direct through a Trainer: timed, profiled, counted
        from item_alignment_torch.models.image import ImageTwoTower

        train_ds = cli._load_shard_dataset(written["train"], IMG_TRAIN)
        batches = [b for b, _ in train_ds.batches(NF_BATCH)]
        model = ImageTwoTower(cfg.replace(dtype="bfloat16"), seed=None)
        model.load_state_dict(best)
        trainer = Trainer(model, TrainConfig(
            seed=seed, train_batch_size=NF_BATCH, log_steps=10 ** 9,
            optimizer=OptimizerConfig(learning_rate=1e-4, total_steps=16000,
                                      grad_accumulation_steps=NF_ACCUM))
        ).setup()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = _timed_steps(trainer, batches, NF_ACCUM)
        micro_ms = step_ms / NF_ACCUM
        train_peak = torch.cuda.max_memory_allocated()
        profiled = profile_step(lambda: trainer.train_step(batches[0]),
                                micro_ms, IMAGE_GROUPS, top=8)
        def micro_batch():
            model(**trainer._device_batch(batches[1]), deterministic=False,
                  dropout_seed=0).loss.backward()

        flop = count_flops(micro_batch)
        with FlopCounterMode(display=False) as flops:  # no attention here
            micro_batch()
        model.zero_grad(set_to_none=True)
        check(flop == flops.get_total_flops(), f"phase 20b: count_flops "
              f"{flop} vs FlopCounterMode {flops.get_total_flops()}")
        mfu = flop / (micro_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()
        acc_err = _accumulation_check(best, seed)
        check(acc_err <= ACC_TOL, f"phase 20b: accumulated gradient mean vs "
              f"one batch {acc_err} (limit {ACC_TOL})")
        print(f"phase 20b step 7 / p5: prepare --only_image "
              f"{ {k: len(v) for k, v in written.items()} } shard files of "
              f"uint8 {IMG_TRAIN} px pairs ({shard_mb:.1f} MiB), "
              f"{walls['prepare --only_image']:.3f} s; finetune-image "
              f"eca_nfnet_l0 at {IMG_TRAIN} px, batch {NF_BATCH}, "
              f"accumulation {NF_ACCUM}, bf16, lr 1e-4: {micro} micro-batches"
              f" ({micro // NF_ACCUM} optimizer steps), losses "
              f"{[round(x, 6) for x in losses]}, {cli_ms:.2f} ms a "
              f"micro-batch through the CLI, eval on {IMG_PAIRS['valid']} "
              f"pairs, command {walls['finetune-image']:.3f} s; p5 --do_pred "
              f"(fp32) on {len(pred)} test pairs, "
              f"{walls['finetune-image --do_pred']:.3f} s, the file vs a "
              f"direct fp32 forward {file_err:.3e} of max|ref|; bf16 vs "
              f"fp32 probs {bf16_diff:.3e} (limit {IMG_TOL}; fp32 probs "
              f"{p32.min():.4f}-{p32.max():.4f}); uint8 "
              f"normalised on the card vs the host {norm_diff:.3e} (limit "
              f"{NORM_TOL}); launches #1..#6 over the image commands "
              f"{main_path}; {card}", flush=True)
        print(f"phase 20b direct Trainer at the same shape: {step_ms:.2f} ms "
              f"an optimizer step of {NF_ACCUM} micro-batches, {micro_ms:.2f} "
              f"ms a micro-batch ({NF_BATCH / micro_ms * 1e3:.2f} train "
              f"pairs/s, {2 * NF_BATCH / micro_ms * 1e3:.2f} images/s), peak "
              f"memory {train_peak / 2 ** 30:.2f} GiB; model FLOP of a "
              f"micro-batch (utils/flops.count_flops, equal to "
              f"FlopCounterMode's; forward and backward) "
              f"{flop / 1e12:.3f} TFLOP, {flop / (micro_ms / 1e3) / 1e12:.1f}"
              f" TFLOP/s, {mfu:.3f} of 989 TFLOP/s; one micro-batch: "
              f"{profiled}; gradient accumulation at {IMG_DUMP} px fp32: the "
              f"mean AdamW got after {NF_ACCUM} micro-batches of 4 pairs vs "
              f"one batch of {4 * NF_ACCUM}: {acc_err:.3e} of max|ref| "
              f"(limit {ACC_TOL}); {card}", flush=True)

        # 20c: the other backbones
        for config, side in (("vit_large_patch16_384.json", 384),
                             ("resnetv2_50.json", 288)):
            print(f"phase 20c {_other_backbone(config, side, seed, card)}; "
                  f"{card}", flush=True)
        print("phase 20 wall times: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in walls.items()), flush=True)
    return main_path


# ------------------------------------------------------------- phase 21
GRAPH_NODES = 230_000     # the reference's graph (ops/sparse.py:58)
GRAPH_EDGES = 2_000_000   # random edges before the self loops
GRAPH_FEATS = 1024        # pred-text's RoBERTa-large width
GRAPH_HIDDEN, GRAPH_LAYERS, GRAPH_BATCH = 128, 4, 512  # finetune-graph's
GRAPH_CHUNK = 262_144     # scripts/train.sh step 9's --edge_chunk
GRAPH_PAIRS = {"train": 4096, "valid": 1024}
GRAPH_EPOCHS = 2
SPMM_TOL = 1e-5           # fp32 on the card vs float64 on the CPU, of max|ref|
GRAPH_CPU_TOL = 1e-4      # the card's probabilities vs the CPU's


def synthetic_graph(n: int, e: int, seed: int) -> tuple:
    """``build-graph``'s arrays for a random graph: ``e`` edges (``e / 2``
    random node pairs, both ways), deduplicated, normalised with self
    loops and sorted by destination, and the transpose list."""
    rs = np.random.RandomState(seed)
    half = rs.randint(0, n, (2, e // 2))
    ei = np.unique(np.concatenate([half, half[::-1]], 1), axis=1)
    ei, ew = sparse.normalize_adjacency(ei, n)
    ti, tw = sparse.transpose_edges(ei, ew)
    ei, ew = sparse.sort_edges_by_dst(ei, ew)
    return ei, ew, ti, tw


def write_graph(root: Path, n: int, e: int, feats: int, pairs: dict,
                seed: int) -> dict:
    """``edges.npz`` (as build-graph writes it), a feature matrix ``[n,
    feats]`` and the pair files of a random graph, from ``seed``."""
    root.mkdir(parents=True, exist_ok=True)
    ei, ew, ti, tw = synthetic_graph(n, e, seed)
    np.savez(root / "edges.npz", edge_index=ei, edge_weight=ew,
             edge_index_t=ti, edge_weight_t=tw, sorted_by_dst=np.bool_(True),
             n_nodes=np.int64(n))
    rng = np.random.default_rng(seed)
    np.save(root / "feats.npy", rng.standard_normal((n, feats),
                                                    dtype=np.float32))
    for split, count in pairs.items():
        idx = rng.integers(0, n, (count, 2))
        with open(root / f"{split}.jsonl", "w") as w:
            for k, (s, t) in enumerate(idx):
                w.write(json.dumps({"src_idx": int(s), "tgt_idx": int(t),
                                    "item_label": int(k % 2)}) + "\n")
    return {"n_edges": ei.shape[1]}


def spmm_reference(ei, ew, x, g) -> tuple:
    """A @ x, A^T g and x[src] . g[dst] in float64 on the CPU with
    ``index_add_``, sharing no code with ``ops/sparse.py``."""
    src = torch.from_numpy(np.asarray(ei[0], np.int64))
    dst = torch.from_numpy(np.asarray(ei[1], np.int64))
    w = torch.from_numpy(np.asarray(ew, np.float64))[:, None]
    x64, g64 = x.detach().cpu().double(), g.cpu().double()
    y = torch.zeros_like(x64).index_add_(0, dst, x64[src] * w)
    dx = torch.zeros_like(x64).index_add_(0, src, g64[dst] * w)
    return y, dx, (x64[src] * g64[dst]).sum(-1)


def _spmm_case(ei, ew, trans, n, chunk, gen) -> float:
    """spmm's forward, dx and dw on the card against ``spmm_reference``:
    the worst error of the three, each of its max|ref|."""
    F_ = GRAPH_HIDDEN
    x = torch.randn(n, F_, generator=gen, device="cuda", requires_grad=True)
    g = torch.randn(n, F_, generator=gen, device="cuda")
    w = torch.tensor(ew, device="cuda", requires_grad=True)
    adj = sparse.Adjacency(ei, ew, n, chunk, trans, "cuda")
    y = sparse.spmm(adj, x, w)
    dx, dw = torch.autograd.grad(y, (x, w), g)
    refs = spmm_reference(ei, ew, x, g)
    return max(float((a.detach().double().cpu() - r).abs().max()
                     / r.abs().max().clamp(min=1e-30))
               for a, r in zip((y, dx, dw), refs))


def _pad_chunked(ei, ew, trans, n, chunk, sort):
    target = -(-ei.shape[1] // chunk) * chunk + chunk  # at least one pad
    pad_dst = n - 1 if sort else 0
    ei, ew = sparse.pad_edges(ei, ew, target, pad_dst=pad_dst)
    if trans is not None:
        trans = sparse.pad_edges(*trans, target, pad_dst=n - 1)
    return ei, ew, trans


def phase_spmm(seed: int, card: str) -> None:
    """Phase 21a-b: spmm on the card against float64 on the CPU, on a
    graph a tenth of the reference's in every layout, and at reference
    scale in train.sh's; two repeats bit for bit; times."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, e = GRAPH_NODES // 10, GRAPH_EDGES // 10
    ei0, ew0, ti, tw = synthetic_graph(n, e, seed)
    rs = np.random.RandomState(seed)
    shuffle = rs.permutation(ei0.shape[1])
    worst, cases = 0.0, []
    for sort in (True, False):
        for chunk in (None, 16_384):
            for with_t in (True, False):
                ei, ew = (ei0, ew0) if sort else (ei0[:, shuffle],
                                                  ew0[shuffle])
                trans = (ti, tw) if with_t else None
                if chunk:
                    ei, ew, trans = _pad_chunked(ei, ew, trans, n, chunk,
                                                 sort)
                err = _spmm_case(ei, ew, trans, n, chunk, gen)
                cases.append(f"{'sorted' if sort else 'unsorted'}/"
                             f"{'chunked+padded' if chunk else 'whole'}/"
                             f"{'transpose' if with_t else 'swapped'} "
                             f"{err:.2e}")
                worst = max(worst, err)
    N = GRAPH_NODES
    ei, ew, ti, tw = synthetic_graph(N, GRAPH_EDGES, seed + 1)
    ei, ew, trans = _pad_chunked(ei, ew, (ti, tw), N, GRAPH_CHUNK, True)
    full = _spmm_case(ei, ew, trans, N, GRAPH_CHUNK, gen)
    worst = max(worst, full)
    check(worst <= SPMM_TOL, f"phase 21a spmm vs float64: {worst:.3e} "
          f"(limit {SPMM_TOL}): {cases}, full {full:.3e}")

    adj = sparse.Adjacency(ei, ew, N, GRAPH_CHUNK, trans, "cuda")
    x = torch.randn(N, GRAPH_HIDDEN, generator=gen, device="cuda",
                    requires_grad=True)
    g = torch.randn(N, GRAPH_HIDDEN, generator=gen, device="cuda")
    w = torch.tensor(ew, device="cuda", requires_grad=True)
    runs = []
    for _ in range(2):
        y = sparse.spmm(adj, x, w)
        runs.append((y.detach(),) + torch.autograd.grad(y, (x, w), g))
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    check(same, "phase 21b: two spmm runs differ")

    E = adj.n_edges
    fwd_ms = cuda_ms(lambda: sparse.spmm(adj, x.detach()), 10)
    xg = x.detach().requires_grad_()
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(sparse.spmm(adj, xg), xg,
                                                 g), 10) - fwd_ms
    # x read and the output written once, the int32 columns and fp32
    # values of the E entries, the int32 row offsets
    nbytes = 2 * N * GRAPH_HIDDEN * 4 + E * (4 + 4) + (N + 1) * 4
    bound = _bound(nbytes, 2 * E * GRAPH_HIDDEN, torch.float32)
    A = adj.a.matrix(adj.weight, torch.float32)
    lib = torch.sparse.mm(A, x.detach())
    lib_same = torch.equal(lib, runs[0][0])
    check(lib_same, "phase 21a: spmm differs from the bare torch.sparse.mm")
    lib_ms = cuda_ms(lambda: torch.sparse.mm(A, x.detach()), 10)
    print(f"phase 21a spmm on the card vs float64 on the CPU, forward, dx "
          f"and dw, of max|ref| (limit {SPMM_TOL}): {n:,} nodes x "
          f"{e:,} edges, {GRAPH_HIDDEN} features: " + ", ".join(cases)
          + f"; {N:,} nodes x {E:,} edges (self loops and padding "
          f"included), chunk {GRAPH_CHUNK}, transpose: {full:.2e}; "
          f"phase 21b two runs bit for bit: {same}; spmm at [{N}, "
          f"{GRAPH_HIDDEN}] fp32: forward {fwd_ms:.4f} ms, backward dx "
          f"{bwd_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}: {nbytes / 1e6:.1f} MB) = "
          f"{fwd_ms / bound['bound_ms']:.1f}x; the bare torch.sparse.mm "
          f"(cuSPARSE's CSR SpMM) on a CSR matrix built beforehand "
          f"{lib_ms:.4f} ms, equal to spmm's forward bit for bit: "
          f"{lib_same}; {card}", flush=True)
    del adj, A, x, xg, g, w, runs
    gc.collect()
    torch.cuda.empty_cache()


def write_graph_items(root: Path, seed: int, n_items: int = 512) -> dict:
    """A small ``item_info.jsonl`` (categories, industries and pv values),
    its ``entity2id.txt`` and labelled pairs, as build-graph reads them."""
    rs = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    names, items = [], []
    for i in range(n_items):
        cate = f"c{i % 8}"
        pvs = {f"k{j}": f"v{j}_{rs.randint(10)}" for j in range(3)}
        items.append({"item_id": f"i{i}", "cate_name": cate,
                      "cate_id": str(i % 8), "industry_name": f"ind{i % 3}",
                      "title": f"t{i}", "item_pvs": "#;#".join(
                          f"{k}#:#{v}" for k, v in pvs.items()),
                      "sku_pvs": ""})
        names.append(f"/item/i{i}")
    values = sorted({f"/value/c{i}-{i}" for i in range(8)}
                    | {f"/value/ind{i}" for i in range(3)}
                    | {f"/value/v{j}_{k}" for j in range(3)
                       for k in range(10)})
    names += values
    with open(root / "item_info.jsonl", "w") as w:
        for it in items:
            w.write(json.dumps(it) + "\n")
    with open(root / "entity2id.txt", "w") as w:
        for k, name in enumerate(names):
            w.write(f"{name}\t{k}\n")
    with open(root / "pairs.jsonl", "w") as w:
        for k in range(200):
            a, b = rs.randint(n_items, size=2)
            w.write(json.dumps({"src_item_id": f"i{a}", "tgt_item_id":
                                f"i{b}", "item_label": str(k % 2)}) + "\n")
    return {"n_items": n_items, "n_nodes": len(names),
            "links": n_items * 5}


def _graph_probs(params: dict, feats, edges: Path, pairs: Path,
                 device: str) -> np.ndarray:
    """The probabilities of the pairs of ``pairs`` under ``params`` on
    ``device``."""
    from item_alignment_torch.models.graph import GCNTwoTower

    src, tgt, _ = cli._graph_pairs(str(pairs))
    adj = cli.load_graph(str(edges), feats.shape[0], None, device)
    cfg = ModelConfig(model_name="gcn", gcn_hidden=GRAPH_HIDDEN,
                      gcn_layers=GRAPH_LAYERS, gcn_feature_dim=feats.shape[1])
    model = GCNTwoTower(cfg, device=device, seed=None)
    model.load_state_dict(params)
    with torch.inference_mode():
        out = model(torch.from_numpy(feats).to(device), adj,
                    torch.from_numpy(src).to(device),
                    torch.from_numpy(tgt).to(device))
    return out.probs.float().cpu().numpy()


def phase_graph(seed: int, card: str) -> tuple:
    """Phase 21: the graph path (scripts/train.sh step 9) on the card: (a)
    and (b) ``phase_spmm``; (c) ``ia-torch build-graph`` on a small
    synthetic ``item_info``; (d) ``ia-torch finetune-graph`` with step 9's
    flags on a random graph at reference scale, twice, timed and
    profiled, and a small graph's trained probabilities on the card
    against the CPU.  Returns the launches of #1-#6 over the commands
    (none: no attention kernel is on this path)."""
    from item_alignment_torch.models.graph import GCNTwoTower

    walls = {}
    phase_spmm(seed, card)
    zero_counters()  # the graph path starts here
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        info = write_graph_items(root / "items", seed)
        (out,), walls["build-graph"] = run_cli([
            "build-graph", "--item_info", str(root / "items/item_info.jsonl"),
            "--entity2id", str(root / "items/entity2id.txt"),
            "--train_pairs", str(root / "items/pairs.jsonl"),
            "--output_dir", str(root / "built"), "--valid_proportion",
            "0.1", "--seed", str(seed)])
        with np.load(out["edges"]) as z:
            ei, ew, ti = z["edge_index"], z["edge_weight"], z["edge_index_t"]
            n = int(z["n_nodes"])
        sorted_ok = bool(np.all(np.diff(ei[1]) >= 0)
                         and np.all(np.diff(ti[1]) >= 0))
        expect_edges = 2 * info["links"] + n
        check(out["n_items"] == info["n_items"] and n == info["n_nodes"]
              and ei.shape[1] == expect_edges and sorted_ok
              and np.all(ew > 0) and sorted(map(tuple, ei.T)) == sorted(
                  map(tuple, ti[::-1].T))
              and out["item_train_valid_pair.jsonl"] == 20
              and out["item_train_train_pair.jsonl"] == 180,
              f"phase 21c build-graph: {out}, {ei.shape[1]} edges "
              f"(want {expect_edges}), sorted {sorted_ok}")
        print(f"phase 21c build-graph: {info['n_items']} items, {n} nodes, "
              f"{ei.shape[1]} edges ({info['links']} item-value links both "
              f"ways and {n} self loops), both lists sorted by destination, "
              f"the transpose the swapped list, pairs 180/20, "
              f"{walls['build-graph']:.3f} s; {card}", flush=True)

        g = root / "graph"
        t0 = time.perf_counter()
        sizes = write_graph(g, GRAPH_NODES, GRAPH_EDGES, GRAPH_FEATS,
                            GRAPH_PAIRS, seed)
        walls["synthetic graph"] = time.perf_counter() - t0
        argv = ["finetune-graph", "--feature_matrix", str(g / "feats.npy"),
                "--edges", str(g / "edges.npz"), "--train_pairs",
                str(g / "train.jsonl"), "--valid_pairs",
                str(g / "valid.jsonl"), "--edge_chunk", str(GRAPH_CHUNK),
                "--scan_layers", "--epochs", str(GRAPH_EPOCHS)]
        steps, params, results = {}, [], []
        torch.cuda.reset_peak_memory_stats()
        for k in range(2):
            with wrapped(cli, "gcn_train_step", timed(steps, k)):
                (res,), walls[f"finetune-graph {k}"] = run_cli(
                    argv + ["--output_dir", str(g / f"out{k}")])
            results.append(res)
            params.append(load_params(str(g / f"out{k}/gcn_params.pt")))
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_steps = GRAPH_EPOCHS * (GRAPH_PAIRS["train"] // GRAPH_BATCH)
        step_ms = 1e3 * float(np.median(steps[0][1:]))
        repeat = all(torch.equal(params[0][k], params[1][k])
                     for k in params[0])
        check(len(steps[0]) == n_steps and repeat
              and np.isfinite(results[0]["final_loss"])
              and results[0] == results[1]
              and "encoder.conv.weight.weight" in params[0],
              f"phase 21d finetune-graph: {results}, steps "
              f"{len(steps[0])}, repeat {repeat}")
        launches = counters()

        feats = np.load(g / "feats.npy")
        adj = cli.load_graph(str(g / "edges.npz"), GRAPH_NODES, GRAPH_CHUNK,
                             "cuda")
        cfg = ModelConfig(model_name="gcn", gcn_hidden=GRAPH_HIDDEN,
                          gcn_layers=GRAPH_LAYERS, gcn_feature_dim=GRAPH_FEATS)
        model = GCNTwoTower(cfg, device="cuda", seed=None)
        model.load_state_dict(params[0])
        adam = cli.graph_adam(model, 1e-2)
        features = torch.from_numpy(feats).cuda()
        del feats
        src, tgt, lab = (torch.from_numpy(a[:GRAPH_BATCH]).cuda() for a in
                         cli._graph_pairs(str(g / "train.jsonl")))

        def step():
            cli.gcn_train_step(model, adam, features, adj, src, tgt, lab,
                               seed)

        profiled = profile_step(step, step_ms, kernel_groups=(
            ("sparse products", ("csr", "spmm", "cusparse")),
            ("gathers", ("index", "gather")),
            ("matrix products", ("gemm", "xmma", "nvjet", "cutlass"))))
        del model, adam, features, adj
        gc.collect()
        torch.cuda.empty_cache()

        small = root / "small"
        write_graph(small, 3000, 20_000, 64, {"train": 512, "valid": 256},
                    seed + 2)
        run_cli(["finetune-graph", "--feature_matrix",
                 str(small / "feats.npy"), "--edges", str(small / "edges.npz"),
                 "--train_pairs", str(small / "train.jsonl"), "--edge_chunk",
                 "4096", "--scan_layers", "--epochs", "3", "--batch_size",
                 "128", "--output_dir", str(small / "out")])
        trained = load_params(str(small / "out/gcn_params.pt"))
        small_feats = np.load(small / "feats.npy")
        on_card, on_cpu = (_graph_probs(trained, small_feats,
                                        small / "edges.npz",
                                        small / "valid.jsonl", d)
                           for d in ("cuda", "cpu"))
        cpu_diff = float(np.abs(on_card - on_cpu).max())
        check(cpu_diff <= GRAPH_CPU_TOL and 0 < on_card.std(),
              f"phase 21d card vs CPU probabilities {cpu_diff:.3e}")
    check(not any(launches), f"phase 21: launches {launches}")
    print(f"phase 21d finetune-graph --edge_chunk {GRAPH_CHUNK} "
          f"--scan_layers: {GRAPH_NODES:,} nodes x {sizes['n_edges']:,} "
          f"edges (self loops included), features [{GRAPH_NODES}, "
          f"{GRAPH_FEATS}] fp32, hidden {GRAPH_HIDDEN}, {GRAPH_LAYERS} "
          f"layers, batch {GRAPH_BATCH}, {GRAPH_EPOCHS} epochs of "
          f"{GRAPH_PAIRS['train']} pairs ({n_steps} steps): {results[0]}; "
          f"{step_ms:.2f} ms/step (median of steps 2-{n_steps}; the first "
          f"{1e3 * steps[0][0]:.2f} ms), peak memory {peak:.2f} GiB; "
          f"one step profiled: {profiled}; the second run's gcn_params.pt "
          f"equal bit for bit: {repeat}; a 3,000-node graph's trained "
          f"probabilities on the card vs the CPU max diff {cpu_diff:.3e} "
          f"(limit {GRAPH_CPU_TOL}); launches #1..#6 {launches}; "
          f"wall times " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                     walls.items()) + f"; {card}",
          flush=True)
    return launches


# ------------------------------------------------------------- phase 22
COCA_BATCH = 32           # the pretrain and finetune batch
COCA_TEXT = 128           # tokens a caption and an item's text
COCA_PRETRAIN_STEPS = 4
COCA_PAIRS = {"train": 96, "valid": 64, "test": 32}
COCA_TOL = 2e-2           # bf16: kernels vs plain attention, probabilities
COCA_LIVE = 4             # valid pairs whose probability lies off 0 and 1
COCA_WIDTH_FLAGS = ("vocab_size", "hidden_size", "num_hidden_layers",
                    "num_attention_heads", "intermediate_size",
                    "multimodal_depth", "coca_heads", "image_size")


def write_coca_corpus(root: Path, seed: int, cfg: dict) -> dict:
    """Pretrain shards (``COCA_TEXT``-token captions from the smoke vocab,
    ragged, and uint8 images at the config's size) and the finetune's
    7-column TSVs with a 256 px JPEG an item, from ``seed``."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    n = COCA_BATCH * COCA_PRETRAIN_STEPS
    side = cfg["image_size"]
    ids = rs.randint(1000, cfg["vocab_size"] - 1, (n, COCA_TEXT))
    ids[:, 0] = 101  # [CLS]
    lens = rs.randint(COCA_TEXT // 4, COCA_TEXT + 1, n)
    mask = (np.arange(COCA_TEXT)[None] < lens[:, None]).astype(np.int64)
    ids = ids * mask
    half = n // 2
    for k in range(2):
        part = slice(k * half, (k + 1) * half)
        np.savez(root / f"shard_{k}.npz", input_ids=ids[part],
                 attention_mask=mask[part],
                 images=rs.randint(0, 256, (half, side, side, 3), np.uint8))
    vocab = smoke_vocab()
    words = vocab[1000:8000]
    (root / "images").mkdir()
    (root / "vocab").mkdir()
    (root / "vocab" / "vocab.txt").write_text("\n".join(vocab),
                                              encoding="utf-8")
    n_items = 160
    for i in range(n_items):
        Image.fromarray(rs.randint(0, 256, (256, 256, 3), np.uint8)).save(
            root / "images" / f"i{i}.jpg", quality=90)

    def text(k):
        return " ".join(rs.choice(words, k))

    data = root / "data"
    data.mkdir()
    names = {"train": "finetune_train_train.tsv",
             "valid": "finetune_train_valid.tsv", "test": "finetune_test.tsv"}
    for split, count in COCA_PAIRS.items():
        with open(data / names[split], "w", encoding="utf-8") as w:
            for k in range(count):
                a, b = rs.randint(n_items, size=2)
                w.write("\t".join([str(k % 2), f"i{a}", text(20), text(60),
                                   f"i{b}", text(20), text(60)]) + "\n")
    return {"data": data, "images": root / "images", "vocab": root / "vocab"}


def _coca_probs(cfg: ModelConfig, state: dict, ds) -> dict:
    """CoCaForItemAlignment's probabilities and logits on ``ds`` with
    ``state``, through the kernels and through plain attention."""
    from item_alignment_torch.models.multimodal import CoCaForItemAlignment

    probs = {}
    for name, flash in (("kernels", True), ("plain", False)):
        model = CoCaForItemAlignment(cfg.replace(use_flash_attention=flash),
                                     seed=None).eval()
        model.load_state_dict(state)
        got = []
        with torch.inference_mode():
            for batch, meta in ds.batches(COCA_BATCH):
                feed = {k: torch.from_numpy(v).cuda() for k, v in
                        batch.items() if k != "labels"}
                feed = {k: v if v.dtype == torch.uint8 else v.long()
                        for k, v in feed.items()}
                out = model(**feed)
                got.append([t.float().cpu().numpy()[: meta["n_valid"]]
                            for t in (out.probs, out.logits)])
        probs[name] = [np.concatenate(part) for part in zip(*got)]
        del model
    return probs


def _coca_finetune(root: Path, corpus: dict, tok, ensemble: str, seed: int,
                   card: str, walls: dict, segmentation: str) -> tuple:
    """Phase 22b: ``finetune-multimodal --model_name coca_base`` with
    ``ensemble`` from phase 22a's pretrain file through ``cli.main``, its
    model on the kernels against plain attention, and (``sum``) one step
    timed and profiled.  Returns the command's launches of #1-#6."""
    from item_alignment_torch.data.images import load_image
    from item_alignment_torch.data.prepare import read_finetune_tsv
    from item_alignment_torch.data.tokenization import (
        build_multimodal_pair_dataset,
    )
    from item_alignment_torch.models.multimodal import CoCaForItemAlignment

    config = ROOT / "configs" / "coca_base.json"
    width = json.loads(config.read_text())
    train_steps = COCA_PAIRS["train"] // COCA_BATCH
    log_dir = root / f"logs_{ensemble}"
    out_dir = root / f"ft_{ensemble}"
    zero_counters()  # the finetune path
    torch.cuda.reset_peak_memory_stats()
    lines, walls[f"finetune {ensemble}"] = run_cli([
        "finetune-multimodal", "--data_dir", str(corpus["data"]),
        "--output_dir", str(out_dir), "--vocab_path",
        str(corpus["vocab"]), "--model_name", "coca_base",
        "--config_file", str(config), "--images_dir",
        str(corpus["images"]), "--image_size",
        str(width["image_size"]), "--ensemble", ensemble,
        "--max_seq_len", "50", "--max_seq_len_pv",
        str(COCA_TEXT - 50), "--train_batch_size", str(COCA_BATCH),
        "--eval_batch_size", str(COCA_BATCH), "--epochs", "1",
        "--learning_rate", "1e-4", "--bf16", "--log_steps", "1",
        "--log_dir", str(log_dir), "--pretrained_model_path",
        str(root / "pre"), "--seed", str(seed), "--do_train",
        "--do_eval", "--do_pred"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    ft = counters()
    losses, ft_ms = _finetune_ms(log_dir)
    ev = [o for o in lines if "sweep" in o][-1]
    evals = 2 * COCA_PAIRS["valid"] // COCA_BATCH \
        + COCA_PAIRS["test"] // COCA_BATCH
    per_pass = 2 * width["num_hidden_layers"]  # two towers a pair
    check(ft == (per_pass * evals, per_pass * train_steps,
                 per_pass * train_steps, 0, 0, 0)
          and len(losses) == train_steps and all(np.isfinite(losses))
          and ev["best_f1"] is not None,
          f"phase 22 finetune {ensemble}: launches {ft}, losses "
          f"{losses}, eval {ev}")

    run = out_dir / f"coca_base-v1-one_tower-cls-{ensemble}-ce"
    state = load_params(str(run / "best_f1.pt"))
    cfg = ModelConfig.from_json(
        str(config), model_name="coca_base", ensemble=ensemble,
        max_seq_len=50, max_seq_len_pv=COCA_TEXT - 50,
        dtype="bfloat16", vocab_size=len(tok))
    rows = read_finetune_tsv(str(corpus["data"] /
                                 "finetune_train_valid.tsv"))
    valid = build_multimodal_pair_dataset(
        rows, tok, load_image, cli._image_paths(
            str(corpus["images"]), rows), cfg.max_seq_len,
        cfg.max_seq_len_pv, cfg.image_size, bos=ensemble == "sum")
    # random weights saturate the trained probabilities within a few steps
    # (and cross_attn's 12-deep decoder most of them from the start), so
    # the finetune's start is held too: the seed's weights under the
    # pretrain's coca and multimodal parameters, as the command loads them,
    # with the head scaled so that its margins (logit 1 - logit 0) have a
    # root mean square of 1 over the pairs (a scale, so the kernels' error
    # stays relative to the margins' size)
    start = CoCaForItemAlignment(cfg, seed=seed).state_dict()
    start.update({k: v for k, v in load_params(str(
        root / "pre" / "coca_pretrain.pt")).items() if k in start})
    diffs = []
    probs = _coca_probs(cfg, state, valid)
    diffs.append(float(np.abs(probs["kernels"][0] - probs["plain"][0]).max()))
    logits = _coca_probs(cfg, start, valid)["plain"][1]
    rms = float(np.sqrt(np.mean((logits[:, -1] - logits[:, 0]) ** 2)))
    for k in ("classifier.out_proj.weight", "classifier.out_proj.bias"):
        start[k] = start[k] / (rms or 1.0)
    probs = _coca_probs(cfg, start, valid)
    diffs.append(float(np.abs(probs["kernels"][0] - probs["plain"][0]).max()))
    live = int(((probs["plain"][0] > 0.01) & (probs["plain"][0] < 0.99)).sum())
    diff = max(diffs)
    check(diff <= COCA_TOL and live >= COCA_LIVE,
          f"phase 22 {ensemble}: kernels vs plain attention {diffs} "
          f"(trained, start; limit {COCA_TOL}), {live} of the start's "
          f"probabilities off 0 and 1 (want {COCA_LIVE})")
    profiled = ""
    if ensemble == "sum":
        model = CoCaForItemAlignment(cfg, seed=None)
        model.load_state_dict(state)
        tcfg = TrainConfig(seed=seed, train_batch_size=COCA_BATCH,
                           optimizer=OptimizerConfig(
                               learning_rate=1e-4, total_steps=100))
        trainer = Trainer(model, tcfg, device="cuda")
        rows = read_finetune_tsv(str(corpus["data"] /
                                     "finetune_train_train.tsv"))
        train_ds = build_multimodal_pair_dataset(
            rows, tok, load_image, cli._image_paths(
                str(corpus["images"]), rows), cfg.max_seq_len,
            cfg.max_seq_len_pv, cfg.image_size, bos=True)
        batches = [b for b, _ in train_ds.batches(COCA_BATCH)]
        step_ms, profiled = _step_profile(
            trainer, (batches * 2)[:4])
        profiled = (f"; direct: {step_ms:.2f} ms/step over 3 timed "
                    f"steps, {profiled}")
        del model, trainer
    del state, start, probs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 22b finetune-multimodal --model_name coca_base "
          f"--ensemble {ensemble}: batch {COCA_BATCH}, S="
          f"{COCA_TEXT} a tower, {width['image_size']} px uint8 "
          f"images, bf16, from coca_pretrain.pt, {train_steps} steps, "
          f"losses {[round(x, 4) for x in losses]}, {ft_ms:.2f} "
          f"ms/step through the CLI ({COCA_BATCH / ft_ms * 1e3:.2f} "
          f"train pairs/s), peak memory {peak:.2f} GiB; eval best "
          f"F1 {ev['best_f1']:.4f}; launches #1..#6 {ft} (#2/#3 "
          f"{per_pass} a step, #1 {per_pass} an eval or prediction "
          f"batch); "
          f"{len(valid)} valid pairs' probabilities on the kernels vs "
          f"plain attention max diff {diffs[0]:.3e} trained, {diffs[1]:.3e} "
          f"at the start ({live} of them off 0 and 1; limit {COCA_TOL}); "
          f"command {walls[f'finetune {ensemble}']:.3f} s"
          f"{profiled}; the segmenter {segmentation}; {card}", flush=True)
    return ft


def phase_coca(seed: int, card: str) -> tuple:
    """Phase 22: CoCa at configs/coca_base.json's width in bf16 (hidden 768,
    12 text layers, a 12-layer ViT-B/16 at 224 px, a 12-deep multimodal
    decoder with 12 heads), random weights from ``seed``: ``coca-pretrain``
    on uint8 shards of 128-token captions, then ``finetune-multimodal
    --model_name coca_base`` with ``sum`` and ``cross_attn`` from its
    ``coca_pretrain.pt``: train, evaluate, predict, all through
    ``cli.main``; the finetuned model on the kernels against plain
    attention; one step timed and profiled; then #1 and #2's and #3's
    contracts against their plain versions at the text encoder's shapes.
    Returns the launches of #1-#6 over the commands and the kernels'
    errors (``phase_train_kernels``'s, and #1's as ``serving_err``)."""
    from item_alignment_torch.data.tokenization import load_text_tokenizer

    config = ROOT / "configs" / "coca_base.json"
    width = json.loads(config.read_text())
    flags = [f"--{k}={width[k]}" for k in COCA_WIDTH_FLAGS]
    walls, total = {}, (0,) * 6
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        corpus = write_coca_corpus(root, seed, width)
        walls["corpus"] = time.perf_counter() - t0
        zero_counters()  # the pretrain path
        torch.cuda.reset_peak_memory_stats()
        (out,), walls["coca-pretrain"] = run_cli([
            "coca-pretrain", "--shards", str(root / "shard_0.npz"),
            str(root / "shard_1.npz"), "--output_dir", str(root / "pre"),
            "--config_file", str(config), *flags, "--batch_size",
            str(COCA_BATCH), "--epochs", "1", "--bf16", "--log_steps", "1",
            "--log_dir", str(root / "pre_logs"), "--seed", str(seed)])
        pre_peak = torch.cuda.max_memory_allocated() / 2**30
        pre = counters()
        losses, pre_ms = _finetune_ms(root / "pre_logs")
        L = width["num_hidden_layers"]  # text-encoder layers, one pass
        want = (0, L * COCA_PRETRAIN_STEPS, L * COCA_PRETRAIN_STEPS, 0, 0, 0)
        check(pre == want and len(losses) == COCA_PRETRAIN_STEPS
              and all(np.isfinite(losses)) and np.isfinite(out["final_loss"]),
              f"phase 22 coca-pretrain: launches {pre} (want {want}), "
              f"losses {losses}")
        total = tuple(a + b for a, b in zip(total, pre))
        n_params = sum(v.numel() for v in load_params(
            str(root / "pre/coca_pretrain.pt")).values())
        print(f"phase 22a coca-pretrain at coca_base width ({n_params:,} "
              f"parameters), batch {COCA_BATCH}, captions of {COCA_TEXT} "
              f"tokens (the text encoder sees {COCA_TEXT - 1}), uint8 "
              f"images at {width['image_size']} px, bf16: "
              f"{COCA_PRETRAIN_STEPS} steps, losses "
              f"{[round(x, 4) for x in losses]}, {pre_ms:.2f} ms/step "
              f"through the CLI, peak memory {pre_peak:.2f} GiB, launches "
              f"#1..#6 {pre}, command {walls['coca-pretrain']:.3f} s; "
              f"{card}", flush=True)

        tok = load_text_tokenizer(str(corpus["vocab"]))
        with segmenter() as segmentation:
            for ensemble in ("sum", "cross_attn"):
                ft = _coca_finetune(root, corpus, tok, ensemble, seed, card,
                                    walls, segmentation)
                total = tuple(a + b for a, b in zip(total, ft))
    print("phase 22 wall times: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items()), flush=True)
    # the shapes the commands above ran: the pretrain's captions of S - 1
    # tokens and the finetune's towers of S, B a batch, the base's heads
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, S, N = COCA_BATCH, COCA_TEXT, width["num_attention_heads"]
    H = width["hidden_size"] // N
    _, serving = kernel_case(f"bf16 S={S} B={B} N={N}", B, S, N, H,
                             torch.bfloat16, False, gen,
                             phase="phase 22 kernel")
    errs = phase_train_kernels(gen, [
        (f"bf16 S={s} B={B} N={N}", B, s, N, H, torch.bfloat16)
        for s in (S - 1, S)], SimpleNamespace(**dict(
            vars(TRAIN_FAMILY), name="phase 22 train kernels")))
    return total, dict(errs, serving_err=serving)


# ---------------------------------------------------------------------------
# phase 23: the parallel layer
# ---------------------------------------------------------------------------

# (label, family, B, S, N, H, dtype, rows, heads): the sliced call takes
# rows [r0, r1) and heads [h0, h1) of the whole call's inputs
OFFSET_CASES = [
    ("#2's contract and #3's route, bf16", TRAIN_FAMILY, 40, 510, 16, 64,
     torch.bfloat16, (20, 40), (8, 16)),
    ("#4-#6, bf16", BLOCKWISE_FAMILY, 4, 1024, 16, 64, torch.bfloat16,
     (2, 4), (8, 16)),
    ("#2's contract and #3's route, fp32", TRAIN_FAMILY, 4, 130, 4, 64,
     torch.float32, (2, 4), (2, 4)),
    ("#4-#6, fp32", BLOCKWISE_FAMILY, 3, 600, 4, 64, torch.float32, (1, 3),
     (2, 4)),
]


def _keep_index_family(fam, stride: int, base: int):
    """``fam``'s forward and backward with the keep bits at (``stride``,
    ``base``)."""
    def fwd(rate, seed, q, k, v, bias=None):
        return fam.fwd(rate, seed, q, k, v, bias, stride, base)

    def bwd(rate, seed, q, k, v, bias, g, out, lse):
        if fam is TRAIN_FAMILY:
            return cat.fused_attention_dropout_bwd(rate, seed, q, k, v, bias,
                                                   g, out, lse, stride, base)
        args = (rate, seed, q, k, v, bias, g, lse, cab.flash_delta(g, out),
                stride, base)
        return (cab.flash_dq(*args), *cab.flash_dkv(*args))

    return SimpleNamespace(fwd=fwd, bwd=bwd, kernels=fam.kernels)


def phase_offsets(gen: torch.Generator) -> None:
    """23a: each dropout-bearing contract called on rows r0.. and heads h0..
    of a batch with (bn_stride, bn_base) = (N, r0 * N + h0) gives out, lse,
    dq, dk, dv and the keep bits read back from each kernel equal bit for
    bit to the same slice of the whole call (each (b, n) is a block of its
    own); the bits equal the plain hash's slice too."""
    rate, seed = 0.1, 4321
    t = cat.dropout_consts(rate)[0]
    for label, fam, B, S, N, H, dt, (r0, r1), (h0, h1) in OFFSET_CASES:
        q, k, v, g, bias = _train_inputs(B, S, N, H, dt, gen)
        out, lse = fam.fwd(rate, seed, q, k, v, bias)
        grads = fam.bwd(rate, seed, q, k, v, bias, g, out, lse)
        sl = (slice(r0, r1), slice(None), slice(h0, h1))
        part = _keep_index_family(fam, N, r0 * N + h0)
        out_s, lse_s = part.fwd(rate, seed, q[sl], k[sl], v[sl], bias[r0:r1])
        grads_s = part.bwd(rate, seed, q[sl], k[sl], v[sl], bias[r0:r1],
                           g[sl], out[sl], lse[r0:r1, h0:h1])
        same = {"out": torch.equal(out_s, out[sl]),
                "lse": torch.equal(lse_s, lse[r0:r1, h0:h1])}
        same.update({n: torch.equal(a, b[sl]) for n, a, b in
                     zip(("dq", "dk", "dv"), grads_s, grads)})
        ref = cat.keep_mask_reference(seed, B, N, S, t, q)[r0:r1, h0:h1]
        whole = _kernel_keep_bits(fam, seed, B, S, N, H, dt, rate)
        sliced = _kernel_keep_bits(part, seed, r1 - r0, S, h1 - h0, H, dt,
                                   rate)
        for name, a, b in zip(fam.kernels, sliced, whole):
            same[f"keep bits {name}"] = (torch.equal(a, b[r0:r1, h0:h1])
                                         and torch.equal(a, ref))
        del whole, sliced, ref
        check(all(same.values()), f"phase 23a {label}: rows {r0}-{r1 - 1}, "
              f"heads {h0}-{h1 - 1} differ from the whole call's slice: "
              f"{[n for n, ok in same.items() if not ok]}")
        print(f"phase 23a offsets {label} at B={B} S={S} N={N} H={H}, rate "
              f"{rate}: rows {r0}-{r1 - 1} and heads {h0}-{h1 - 1} with "
              f"(bn_stride, bn_base) = ({N}, {r0 * N + h0}) equal the whole "
              f"call's slice bit for bit: " + ", ".join(same), flush=True)
        torch.cuda.empty_cache()


def _parallel_steps(mcfg: ModelConfig, tcfg: TrainConfig, seed: int,
                    batches: list, prepare=None) -> dict:
    """Phase 8's steps (one warm-up, the rest timed) and one profiled step
    through a ``Trainer`` (``prepare(trainer)`` runs before it shards the
    model); the parameters are read before the profiled step."""
    model = RobertaOneTower(mcfg, seed=seed)
    trainer = Trainer(model, tcfg)
    if prepare is not None:
        prepare(trainer)
    trainer.setup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    zero_counters()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        loss = trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = counters()
    memory = (f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
              f"allocated, {torch.cuda.memory_stats().get('num_alloc_retries', 0) - retries}"
              " allocator retries")
    step_ms = sum(times[1:]) / (len(times) - 1) * 1e3
    params = trainer._host_params()
    profiled = profile_step(lambda: trainer.train_step(batches[-1]), step_ms,
                            host_ranges=FSDP_RANGES)
    return dict(model=model, trainer=trainer, losses=losses, params=params,
                step_ms=step_ms, launches=launches, profiled=profiled,
                memory=memory)


# FSDP2's profiler ranges (torch/distributed/fsdp/_fully_shard): its hooks'
# host time in 23b's profiled steps
FSDP_RANGES = ("FSDP::root_pre_forward", "FSDP::pre_forward",
               "FSDP::post_forward", "FSDP::pre_backward",
               "FSDP::post_backward_reduce", "FSDP::post_backward_reshard",
               "FSDP::root_post_backward_callback",
               "RegisterPostBackwardFunctionBackward")


def _tensor_styles(trainer) -> None:
    """The tensor-parallel styles on the trainer's tensor axis of 1, which
    ``shard_params`` leaves out there: their cost alone."""
    from torch.distributed.tensor.parallel import parallelize_module

    from item_alignment_torch.parallel import sharding as sh

    specs = sh.tree_shardings(trainer.model, sh.mesh_sizes(trainer.mesh))
    parallelize_module(trainer.model, trainer.mesh["tensor"],
                       sh._tensor_plan(trainer.model, specs))


def phase_parallel(cfg: ModelConfig, seed: int, gen: torch.Generator) -> tuple:
    """23b: phase 8's recipe (RoBERTa-large, batch 40, S=510, bf16, dropout
    0.1, bf16 moments) through the parallel layer: a process group of one
    over NCCL, mesh (1,1,1), where the model is under FSDP2 (on each layer,
    then the root) and under no tensor-parallel style (the tensor axis is
    1).  Against the same steps without a process group: losses and
    parameters within 1e-6 relative (bit for bit expected: a collective of
    one copies), ms/step and the idle share, and 24 calls of #2's and #3's
    contracts a step.  A third run puts the tensor-parallel styles on by
    hand as well, which splits the wrappers' cost between the two."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    from item_alignment_torch.parallel.dryrun import free_port
    from item_alignment_torch.parallel.mesh import initialize_distributed

    B, S, steps = 40, cfg.pair_seq_len, 6
    ids, mask = pair_batch(B * steps, S, cfg.vocab_size, gen)
    labels = torch.randint(0, 2, (B * steps,), generator=gen, device="cuda")
    batches = [{"input_ids": ids[i * B:(i + 1) * B].cpu().numpy(),
                "attention_mask": mask[i * B:(i + 1) * B].cpu().numpy(),
                "labels": labels[i * B:(i + 1) * B].cpu().numpy()}
               for i in range(steps)]
    tcfg = TrainConfig(seed=seed, train_batch_size=B, log_steps=10 ** 9,
                       optimizer=OptimizerConfig(
                           learning_rate=5e-5, total_steps=16000, fused=True,
                           state_dtype="bfloat16"))
    mcfg = cfg.replace(hidden_dropout_prob=0.1,
                       attention_probs_dropout_prob=0.1)
    runs = {"plain": _parallel_steps(mcfg, tcfg, seed, batches)}
    del runs["plain"]["model"], runs["plain"]["trainer"]
    torch.cuda.empty_cache()
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
    try:
        check(torch.distributed.get_backend() == "nccl",
              f"phase 23b: backend {torch.distributed.get_backend()}")
        for tag, prepare in (("fsdp2", None), ("fsdp2+tp", _tensor_styles)):
            run = runs[tag] = _parallel_steps(mcfg, tcfg, seed, batches,
                                              prepare)
            model = run["model"]
            layer = model.roberta.encoder.layer_0
            query = layer.attention.query.weight
            check(isinstance(model, FSDPModule) and isinstance(layer, FSDPModule)
                  and isinstance(query, DTensor)
                  and run["trainer"].mesh is not None,
                  f"phase 23b {tag}: the model is not under the wrappers")
            run["placements"] = query.placements
            del run["model"], run["trainer"], model, layer, query
            torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
    plain, wrapped = runs["plain"], runs["fsdp2"]
    expect = per_step(short=steps)
    for tag in ("fsdp2", "fsdp2+tp"):
        run = runs[tag]
        run["exact"] = (plain["losses"] == run["losses"] and all(
            torch.equal(p, run["params"][n])
            for n, p in plain["params"].items()))
        worst = max(_rel(run["params"][n], p)
                    for n, p in plain["params"].items())
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(run["losses"], plain["losses"]))
        run["rel"] = max(worst, loss_rel)
        check(run["rel"] <= 1e-6,
              f"phase 23b {tag}: the wrapped steps leave the plain ones: "
              f"losses {run['losses']} vs {plain['losses']}, parameters "
              f"{worst:.3e}")
        check(run["launches"] == expect, f"phase 23b {tag}: launches "
              f"(#1..#6) {run['launches']} over {steps} steps, expected "
              f"{expect}")
    for tag, name in (("plain", "without a process group"),
                      ("fsdp2", "one NCCL rank, FSDP2 (the (1,1,1) path)"),
                      ("fsdp2+tp", "one NCCL rank, FSDP2 + the tensor-"
                                   "parallel styles put on by hand")):
        run = runs[tag]
        print(f"phase 23b parallel {name}: losses "
              f"{[round(x, 6) for x in run['losses']]}; {run['step_ms']:.2f} "
              f"ms/step over {steps - 1} timed steps "
              f"({B / run['step_ms'] * 1e3:.2f} train pairs/s), "
              f"{run['memory']}; profile of one more step: "
              f"{run['profiled']}", flush=True)
    both = runs["fsdp2+tp"]
    print("phase 23b parallel: mesh (1,1,1) over NCCL against the plain "
          "Trainer: " + "; ".join(
              f"{tag} (the query weight {runs[tag]['placements']}) "
              + ("bit for bit" if runs[tag]["exact"] else
                 f"within {runs[tag]['rel']:.3e} relative (not bit for bit)")
              for tag in ("fsdp2", "fsdp2+tp"))
          + f"; wrapper cost: FSDP2 {wrapped['step_ms'] - plain['step_ms']:+.2f}"
          f" ms/step, the tensor-parallel styles on top "
          f"{both['step_ms'] - wrapped['step_ms']:+.2f} ms/step; launches "
          f"#1..#6 {wrapped['launches']}", flush=True)
    return wrapped["launches"]


TWO_RANK_WIDTH = dict(hidden_size=256, num_attention_heads=4,
                      intermediate_size=512)  # heads of 64, as the kernels take


def phase_parallel_two_processes() -> None:
    """23c: two processes on the one card joined over gloo (NCCL refuses
    two ranks on one device), mesh (2,1,1): one step of a RoBERTa one-tower
    at hidden 256 (4 heads of 64, 2 layers, fp32, dropout 0.1, batch 8)
    through the kernels equals the same step in this process: the loss
    within 1e-6 relative and every gradient within 1e-5 of the largest.
    (1,1,2) is left out: gloo's collectives on CUDA tensors ended a rank
    with signal 11 there (PERF.md, section 7).  The ranks' launches are
    theirs, not this process's."""
    from item_alignment_torch.parallel import dryrun

    args = (None, 0.1, None, 8, 1, "cuda", "float32", TWO_RANK_WIDTH)
    ref = dryrun.text_step(*args)
    t0 = time.perf_counter()
    got = dryrun.spawn(dryrun.text_step, 2, (2, 1, 1), *args[1:],
                       device="cuda", backend="gloo", timeout=300)
    wall = time.perf_counter() - t0
    scale = max(g.abs().max().item() for g in ref["grads"].values())
    err = max((got["grads"][n] - g).abs().max().item() / scale
              for n, g in ref["grads"].items())
    loss_rel = abs(got["losses"][0] - ref["losses"][0]) / ref["losses"][0]
    check(got["grads"].keys() == ref["grads"].keys() and err <= 1e-5
          and loss_rel <= 1e-6, f"phase 23c: two gloo ranks on one card "
          f"leave the one-process step: loss {got['losses']} vs "
          f"{ref['losses']}, gradients {err:.3e} of the largest")
    print(f"phase 23c parallel: two processes on one card over gloo, mesh "
          f"(2,1,1), hidden 256, fp32, dropout 0.1: loss {got['losses'][0]:.7f}"
          f" (one process {ref['losses'][0]:.7f}, {loss_rel:.1e} relative), "
          f"gradients within {err:.3e} of the largest; {wall:.1f} s for the "
          f"two processes", flush=True)


# ---------------------------------------------------------------------------
# phase 24: the reproduction pipeline, pipeline/train.sh then predict.sh
# ---------------------------------------------------------------------------

PIPELINE = ROOT / "item_alignment_torch" / "pipeline"
# the corpus of synth_corpus (its --flags), cut from the rehearsal's 120k
# items and 65k train pairs so that the phase takes about six minutes
PIPELINE_CORPUS = dict(n_items=4000, n_train_pairs=2000, n_valid_pairs=200,
                       n_test_pairs=200, n_image_pairs=64, n_values=3000)
# the scripts' own configs at full width, one epoch of every member
PIPELINE_KNOBS = dict(EPOCHS="1", KGE_EPOCHS="1", BERT_EPOCHS="1",
                      IMG_SIZE=str(IMG_TRAIN), IMG_EMB_SIZE=str(IMG_DUMP))
PIPELINE_STEPS = {
    "train": ("0-prepare", "1-pkgm-pretrain", "2-roberta-flagship",
              "3-roberta-cls-layers", "4-pkgm-finetune", "5-textcnn",
              "6a-image-prep", "6b-roberta-image", "7-nfnet",
              "8-bert-legacy", "9-gcn", "done"),
    "predict": ("p0-roberta-flagship", "p1-roberta-cls-layers", "p2-pkgm",
                "p3-textcnn", "p4-roberta-image", "p5-nfnet", "p6-bert",
                "p7-ensemble", "p8-package")}
PIPELINE_MARK = re.compile(
    r"^=== \[(train|predict)\.sh\] step (\S+) @ (\d+) ===$", re.M)
PIPELINE_COMMANDS = 15 + 9  # ia-torch commands of train.sh and predict.sh
# the flags by which a command reads parameters that an earlier step wrote
PARAM_FLAGS = ("--file_state_dict", "--params")
RECORDS_ENV = "CHIP_SMOKE_RECORDS"
# the members whose models hold attention (finetune-text and -multimodal)
ATTENTION_MODELS = ("roberta_large", "pkgm_large", "roberta_image_large")


def as_cli(argv: list) -> int:
    """Phase 24's ``ia-torch``: ``cli.main(argv)`` in this process under
    ``segmenter``, then one JSON line appended to the file named by
    $CHIP_SMOKE_RECORDS: the argv and return code, the parameter files it
    reads and those missing when it started (then it runs nothing and
    returns 2), its launches of #1-#6, its seconds inside ``cli.main`` and
    the build seconds of each kernel library it loaded (0: phase 2's build
    under ``build/`` reused)."""
    reads = [argv[i + 1] for i, a in enumerate(argv[:-1]) if a in PARAM_FLAGS]
    record = dict(argv=argv, reads=reads,
                  missing=[p for p in reads if not os.path.exists(p)])
    rc = 2
    if not record["missing"]:
        zero_counters()
        t0 = time.perf_counter()
        with segmenter() as seg:
            rc = cli.main(argv)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        record.update(seconds=time.perf_counter() - t0, segmenter=seg,
                      launches=list(counters()), built={
                          k: v["seconds"] for k, v in _build.BUILD_INFO.items()})
    with open(os.environ[RECORDS_ENV], "a") as w:
        w.write(json.dumps(dict(record, rc=rc)) + "\n")
    return rc


# Phase 24's ``IA``: a client that hands its argv, working directory,
# environment and stdin/stdout/stderr to ``serve_cli`` and exits with the
# command's code
CLI_CLIENT = """import json, os, socket, sys
s = socket.socket(socket.AF_UNIX)
s.connect("\\0" + {address!r})  # an abstract socket
socket.send_fds(s, [b"x"], [0, 1, 2])
s.sendall(json.dumps({{"argv": sys.argv[1:], "cwd": os.getcwd(),
                      "env": dict(os.environ)}}).encode())
s.shutdown(socket.SHUT_WR)
sys.exit(int(s.makefile().readline() or 1))
"""


def serve_cli(address: str) -> None:
    """``python3 chip_smoke.py --serve-cli ADDRESS``: phase 24's command
    server on the abstract Unix socket ``address``.  Each ``CLI_CLIENT`` request
    runs ``as_cli`` in a child forked from this process, with the client's
    descriptors, directory and environment; the reply is its exit code.
    This process has imported torch and the port (seconds a process on
    the card's machine) and never touches the card, so each child starts
    CUDA afresh and has its own launch counts.  Prints "ready" once
    listening."""
    server = socket.socket(socket.AF_UNIX)
    server.bind("\0" + address)
    server.listen()
    print("ready", flush=True)
    while True:
        conn, _ = server.accept()
        _, fds, _, _ = socket.recv_fds(conn, 1, 3)
        request = json.loads(b"".join(iter(lambda: conn.recv(1 << 16), b"")))
        sys.stdout.flush()
        sys.stderr.flush()
        pid = os.fork()
        if pid == 0:
            server.close()
            conn.close()
            for target, fd in enumerate(fds):
                os.dup2(fd, target)
            os.chdir(request["cwd"])
            os.environ.clear()
            os.environ.update(request["env"])
            rc = 1
            try:
                rc = as_cli(request["argv"])
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else 1
            except BaseException:
                traceback.print_exc()
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(rc or 0)
        for fd in fds:
            os.close(fd)
        _, status = os.waitpid(pid, 0)
        conn.sendall(f"{os.waitstatus_to_exitcode(status)}\n".encode())
        conn.close()


def expected_launches(argv: list) -> str:
    """What a pipeline command must launch: "train" (#2 and #3, #2 twice
    as often under --remat, which replays the forward; #1 in its evals),
    "predict" (#1 alone) or "none"; #4-#6 never (pairs of 510 tokens at
    most)."""
    cmd, model = argv[0], argv[argv.index("--model_name") + 1] \
        if "--model_name" in argv else None
    if cmd in ("finetune-text", "finetune-multimodal") \
            and model in ATTENTION_MODELS:
        return "train" if "--do_train" in argv else "predict"
    return {"finetune-bert": "train", "pred-bert": "predict",
            "pred-text": "predict"}.get(cmd, "none")


def check_launches(rec: dict) -> None:
    n1, n2, n3, *long = rec["launches"]
    kind = expected_launches(rec["argv"])
    what = f"phase 24: {' '.join(rec['argv'][:1])} ({kind}) launches " \
           f"(#1..#6) {rec['launches']}"
    check(not any(long), what)
    if kind == "train":
        check(n1 > 0 and n3 > 0 and n2 == n3 * (
            2 if "--remat" in rec["argv"] else 1), what)
    elif kind == "predict":
        check(n1 > 0 and n2 == n3 == 0, what)
    else:
        check(n1 == n2 == n3 == 0, what)


def run_script(script: Path, env: dict, log: Path, timeout: float) -> tuple:
    """``bash script`` from the checkout's root in a session of its own,
    its output to ``log``; at ``timeout``, or if this process stops
    waiting, the script and every process under it are killed.  Returns
    (return code, wall seconds, end time as ``date +%s`` reads it)."""
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(["bash", str(script)], stdout=out,
                                stderr=subprocess.STDOUT, env=env,
                                cwd=str(ROOT), start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = f"killed at its {timeout:.0f} s limit"
        finally:  # the script and whatever it left running
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return rc, time.perf_counter() - t0, int(time.time())


def step_seconds(text: str, script: str, end: int) -> dict:
    """Each step's wall seconds from the scripts' own step marks (whole
    seconds of ``date +%s``, as ``rehearsal.sh`` reads them), the last one
    up to the script's end."""
    marks = [(m.group(2), int(m.group(3))) for m in PIPELINE_MARK.finditer(
        text) if m.group(1) == script]
    check(tuple(n for n, _ in marks) == PIPELINE_STEPS[script]
          and "(skipped" not in text and "(stopping" not in text,
          f"phase 24: {script}.sh step marks {marks}")
    ends = [t for _, t in marks[1:]] + [end]
    return {n: e - t for (n, t), e in zip(marks, ends) if n != "done"}


def phase_pipeline(seed: int, card: str) -> tuple:
    """Phase 24: the port's ``pipeline/train.sh`` then ``predict.sh`` as
    ``bash`` children at the configs' full width on a ``synth_corpus``
    corpus from ``seed``; ``IA`` is ``CLI_CLIENT``, each command runs in a
    child of ``serve_cli``.  Returns the launches of #1-#6 summed over the
    commands."""
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data, site, bin_dir = root / "data", root / "site", root / "bin"
        records = root / "commands.jsonl"
        site.mkdir()
        bin_dir.mkdir()
        with segmenter(site) as seg:
            pass
        # predict.sh p8's ``python`` is this interpreter (a script, not a
        # link: a link would lose a virtual environment's packages)
        (bin_dir / "python").write_text(
            f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        (bin_dir / "python").chmod(0o755)
        address = f"chip_smoke_cli_{os.getpid()}"
        client = root / "ia_client.py"
        client.write_text(CLI_CLIENT.format(address=address))
        env = {k: v for k, v in os.environ.items() if k not in (
            "START_AT", "STOP_AFTER", "RESUME", "OUT", "VOCAB", "PRETRAINED",
            "BOXES_FILE", "TIMM_NFNET", "EXTRA_FLAGS")}
        env.update(PIPELINE_KNOBS, DATA_DIR=str(data),
                   CONFIGS=str(ROOT / "configs"), **{RECORDS_ENV: str(records)},
                   IA=f"{sys.executable} -I -S {client}",
                   PATH=os.pathsep.join([str(bin_dir), env.get("PATH", "")]),
                   PYTHONPATH=os.pathsep.join(
                       [str(site), str(ROOT)] + ([env["PYTHONPATH"]]
                                                 if env.get("PYTHONPATH")
                                                 else [])))
        flags = [a for k, v in PIPELINE_CORPUS.items()
                 for a in (f"--{k}", str(v))] + ["--seed", str(seed),
                                                  "--with_nfnet_ckpt"]
        t0 = time.perf_counter()
        made = subprocess.run(
            [sys.executable, "-m", "item_alignment_torch.pipeline.synth_corpus",
             "--output_dir", str(data)] + flags, capture_output=True,
            text=True, cwd=str(ROOT), timeout=600,
            env=dict(env, PYTHONHASHSEED=str(seed)))  # the images' noise
        check(made.returncode == 0, f"phase 24: synth_corpus returned "
              f"{made.returncode}: {made.stderr[-2000:]}")
        corpus = json.loads(made.stdout.splitlines()[-1])
        print(f"phase 24 pipeline: segmenter {seg}; corpus "
              f"`synth_corpus {' '.join(flags)}` in "
              f"{time.perf_counter() - t0:.1f} s: {corpus}", flush=True)

        t0 = time.perf_counter()
        server = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--serve-cli",
             address], stdout=subprocess.PIPE, text=True, env=env,
            cwd=str(ROOT), start_new_session=True)
        walls, steps = {}, {}
        try:
            check(server.stdout.readline().strip() == "ready",
                  f"phase 24: the command server ended ({server.poll()})")
            print(f"phase 24 command server ready in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for script, timeout in (("train", 720), ("predict", 360)):
                log = root / f"{script}_log.txt"
                rc, walls[script], end = run_script(
                    PIPELINE / f"{script}.sh", env, log, timeout)
                text = log.read_text(errors="replace")
                check(rc == 0, f"phase 24: {script}.sh returned {rc}; its "
                      f"output ends:\n{text[-4000:]}")
                steps[script] = step_seconds(text, script, end)
                print(f"phase 24 {script}.sh: {walls[script]:.1f} s; steps "
                      "(s) " + ", ".join(f"{n} {t}" for n, t in
                                         steps[script].items())
                      + f"; {card}", flush=True)
        finally:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(server.pid, signal.SIGKILL)
            server.wait()

        recs = [json.loads(line) for line in open(records)]
        check(len(recs) == PIPELINE_COMMANDS and all(
            r["rc"] == 0 and not r["missing"] for r in recs),
            "phase 24: commands " + "; ".join(
                f"{r['argv'][0]} rc {r['rc']} missing {r['missing']}"
                for r in recs))
        for rec in recs:
            check_launches(rec)
        launches = [sum(r["launches"][k] for r in recs) for k in range(6)]
        check(launches[0] > 0 and launches[1] > 0 and launches[2] > 0,
              f"phase 24: launches (#1..#6) {launches}")
        rebuilt = sorted({k for r in recs for k, v in r["built"].items()
                          if v > 0})
        reads = sorted({os.path.relpath(p, data) for r in recs
                        for p in r["reads"]})
        print(f"phase 24 launches (#1..#6) over {len(recs)} commands: "
              f"{launches}; kernel libraries built in the children: "
              f"{rebuilt or 'none (phase 2 built them)'}; {len(reads)} "
              f"parameter files each present before the step that reads "
              f"it: {reads}", flush=True)
        print("phase 24 seconds inside cli.main: " + ", ".join(
            f"{r['argv'][0]} {r['seconds']:.1f}" for r in recs), flush=True)

        from item_alignment_torch.aggregate.submit import validate_submission

        result = data / "output" / "ensemble" / "deepAI_result.jsonl"
        valid = validate_submission(str(result))
        # the fused score: at or above 0 the ensemble calls a pair the same
        scores = [json.loads(json.loads(line)["tgt_item_emb"])[0]
                  for line in open(result)]
        with zipfile.ZipFile(data / "result.zip") as z:
            members = sorted(z.namelist())
            packed = z.read("deepAI_result.jsonl")
        pairs = {(r["src_item_id"], r["tgt_item_id"]) for r in map(
            json.loads, open(data / "raw" / "item_test_pair.jsonl"))}
        check(valid == {"rows": len(pairs), "ok": True}
              and members == ["deepAI_result.jsonl", "similarity.py"]
              and packed == result.read_bytes()
              and all(math.isfinite(x) for x in scores),
              f"phase 24: result.zip {valid} for {len(pairs)} distinct test "
              f"pairs, members {members}, the packed rows "
              f"{'equal' if packed == result.read_bytes() else 'differ'}, "
              f"scores in [{min(scores)}, {max(scores)}]")
        size = sum(p.stat().st_size for p in data.rglob("*") if p.is_file())
        total = walls["train"] + walls["predict"]
        print(f"phase 24 result.zip: {valid['rows']} rows (the distinct "
              f"pairs of {corpus['test_pairs']} test pairs), "
              f"validated, fused scores in [{min(scores):.4f}, "
              f"{max(scores):.4f}], {sum(x >= 0 for x in scores)} at or "
              f"above 0; pipeline wall {total:.1f} s (train.sh "
              f"{walls['train']:.1f}, predict.sh {walls['predict']:.1f}), "
              f"{size / 2**30:.1f} GiB written; {card}", flush=True)
    return tuple(launches)


def run(args) -> None:
    card = phase_card()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    config = str(ROOT / "configs" / "roberta_large.json")
    cfg = ModelConfig.from_json(config, max_seq_len=50, max_seq_len_pv=205,
                                dtype="bfloat16")
    # pairs of 1024 tokens: position ids run to 1024, past the pretrained
    # 512 rows, so the table is grown (utils/hf_import.py copies the rows of
    # a checkpoint; the weights here are random)
    long_cfg = ModelConfig.from_json(config, max_seq_len=100,
                                     max_seq_len_pv=412, dtype="bfloat16",
                                     max_position_embeddings=1032)
    check(cfg.num_hidden_layers == LAYERS and cfg.head_dim == 64
          and cfg.pair_seq_len == 510 and long_cfg.pair_seq_len == 1024,
          "unexpected roberta_large config")
    kernel = phase_kernel(gen)
    kernel["max_abs_err"] = max(kernel["max_abs_err"],
                                phase_offgrid_serving(gen, OFFGRID_TRAIN))

    zero_counters()  # the serving path starts here
    launches = phase_cross_encoder(cfg, args.seed, gen)
    launches += phase_mining(cfg, args.seed, gen)
    # the count excludes phase 5's check forward (counted by the phase)
    check(counters()[0] >= launches > 0 and not any(counters()[1:]),
          f"serving: launches (#1..#6) {counters()}")

    train = phase_train_kernels(gen)
    off_out, off = phase_offgrid_fp32(gen, TRAIN_FAMILY, OFFGRID_TRAIN)
    train["fwd_err"] = max(train["fwd_err"], off_out)
    train["bwd_err"] = [max(a, b) for a, b in zip(train["bwd_err"], off)]
    train.update(time_train_kernels(gen))
    block = phase_train_kernels(gen, BLOCKWISE_CASES, BLOCKWISE_FAMILY)
    off_out, off = phase_offgrid_fp32(gen, BLOCKWISE_FAMILY, OFFGRID_BLOCKWISE)
    phase_blockwise_vs_full_tile(gen)
    timed = time_blockwise_kernels(gen, 16, 1024)  # the kernels line's rows
    runs = (block, timed, time_blockwise_kernels(gen, 4, 2048),
            dict(fwd_err=off_out, bwd_err=off))
    block = dict(timed, fwd_err=max(r["fwd_err"] for r in runs),
                 bwd_err=[max(e) for e in zip(*(r["bwd_err"] for r in runs))])
    phase_grad_check(cfg, args.seed, gen)
    trained = phase_train(cfg, args.seed, gen)["launches"]  # the training path
    phase_remat_check(cfg, args.seed, gen)

    zero_counters()  # the long serving path
    served_long = phase_cross_encoder(long_cfg, args.seed, gen, batch=4,
                                      kernel=3,
                                      name="phase 12 long cross-encoder")
    check(counters() == (0, 0, 0, served_long, 0, 0),
          f"long serving: launches (#1..#6) {counters()}")
    phase_grad_check(long_cfg, args.seed, gen, name="phase 13 long", B=2,
                     limits=LONG_PARAM_TOL)
    trained_long = phase_train(long_cfg, args.seed, gen, B=16,  # the long
                               name="phase 14 long training")["launches"]
    phase_repeat(cfg, args.seed, gen, B=40)
    phase_repeat(long_cfg, args.seed, gen, B=16)
    phase_resume(long_cfg, args.seed, gen)
    phase_sensitivity(cfg, long_cfg, args.seed, gen)
    entry = phase_entry_points(args.seed, card)  # the entry points' path
    pkgm, pkgm_err = phase_pkgm(args.seed, card)  # the PKGM family's path
    mm, mm_err = phase_multimodal(args.seed, card)  # the multimodal path
    legacy, legacy_err = phase_legacy(args.seed, card)  # the legacy member
    image = phase_images(args.seed, card)  # the image family: no kernel
    graph = phase_graph(args.seed, card)  # the graph path: no kernel
    coca, coca_err = phase_coca(args.seed, card)  # CoCa: #1-#3
    phase_offsets(gen)
    parallel = phase_parallel(cfg, args.seed, gen)  # the parallel path
    phase_parallel_two_processes()
    pipe = phase_pipeline(args.seed, card)  # the pipeline: #1-#3

    src, tpu = "item_alignment_torch/csrc/", "item_alignment_tpu/ops/pallas_attention.py:"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = [
        dict(name="fused_attention", source=src + "fused_attention.cu",
             replaces=tpu + "63",
             launches=(launches + entry[0] + pkgm[0] + mm[0] + legacy[0]
                       + image[0] + graph[0] + coca[0] + parallel[0]
                       + pipe[0]),
             max_abs_err=max(kernel["max_abs_err"], pkgm_err["serving_err"],
                             legacy_err["serving_err"],
                             coca_err["serving_err"]),
             **{k: kernel[k] for k in keys}, f32=legacy_err["f32"]["#1"]),
        dict(name="fused_attention_dropout",
             source=src + "flash_blockwise_fwd.cu", replaces=tpu + "203",
             launches=(trained[1] + entry[1] + pkgm[1] + mm[1] + legacy[1]
                       + image[1] + graph[1] + coca[1] + parallel[1]
                       + pipe[1]),
             max_abs_err=max(train["fwd_err"], pkgm_err["fwd_err"],
                             mm_err["fwd_err"], legacy_err["fwd_err"],
                             coca_err["fwd_err"]),
             **train["fwd"], f32=legacy_err["f32"]["#2"]),
        dict(name="fused_attention_dropout_bwd",
             source=src + "flash_blockwise_bwd.cu", replaces=tpu + "241",
             launches=(trained[2] + entry[2] + pkgm[2] + mm[2] + legacy[2]
                       + image[2] + graph[2] + coca[2] + parallel[2]
                       + pipe[2]),
             max_abs_err=max(*train["bwd_err"], *pkgm_err["bwd_err"],
                             *mm_err["bwd_err"], *legacy_err["bwd_err"],
                             *coca_err["bwd_err"]),
             **train["bwd"]),
        dict(name="flash_blockwise_fwd", source=src + "flash_blockwise_fwd.cu",
             replaces=tpu + "458",
             launches=(served_long + trained_long[3] + image[3] + graph[3]
                       + coca[3] + parallel[3] + pipe[3]),
             max_abs_err=block["fwd_err"], **block["fwd"]),
        dict(name="flash_blockwise_dq", source=src + "flash_blockwise_bwd.cu",
             replaces=tpu + "522",
             launches=(trained_long[4] + image[4] + graph[4] + coca[4]
                       + parallel[4] + pipe[4]),
             max_abs_err=block["bwd_err"][0], **block["dq"]),
        dict(name="flash_blockwise_dkv", source=src + "flash_blockwise_bwd.cu",
             replaces=tpu + "571",
             launches=(trained_long[5] + image[5] + graph[5] + coca[5]
                       + parallel[5] + pipe[5]),
             max_abs_err=max(block["bwd_err"][1:]), **block["dkv"]),
    ]
    print(json.dumps({"kernels": [dict(row, route="cuda") for row in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--serve-cli"]:  # phase 24's command server
        serve_cli(sys.argv[2])
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    try:
        run(parser.parse_args())
    except CheckFailed as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
