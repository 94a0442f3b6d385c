#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (avt_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the repo root, on a machine with a GPU

1. Card and build: prints the card's name and power limit, turns TF32 off
   (for cuBLAS and cuDNN; the packed and flash kernels' own f32 products
   run as three TF32 products each, which keeps f32's accuracy), builds
   every kernel from the sources in the checkout (nvcc, sm_90a, one process
   per source, all at once, with FLASH_PARENT_COMMIT's flash forward and
   backward beside them where git history has them), logs each template's
   registers and spills (and fails if a packed kernel's f32 template at
   D=64 spills, or a flash forward or backward f32 template at D=64, 512 or
   1024) and, for the
   packed kernels' bf16 and f32 templates and the fused kernel's bf16 and
   f32 forms, warps a block, shared memory and blocks resident on an SM at
   T=197.
2. Kernels: holds each kernel against its plain PyTorch version at the
   serving and training paths' shapes (tolerances below) and times both,
   the library call that computes the same function, and the card's bound
   for the work (for the packed and flash kernels' f32 forms also the floor
   of three TF32 products a product, `tf32_floor_ms`): the
   attention forward and
   backward (dqkv and the qkv-bias gradient db; the no-db form at head dims
   32, 64 and 128; the query side, key side and db sum also timed apart from
   a profile), each with its bits on a repeat; the f32 forms also beside
   those of PARENT_COMMIT, in turns, where the checkout's git history has
   them,
   and the fused qkv projection + attention (out and qkv, bits on a repeat;
   bf16 and f32, causal and not; timed beside the split path, a matmul +
   the packed kernel).
3. Serving: the full-width flagship (ViT-B/16 + AVT-h, 3806 actions, bf16)
   answers requests of uint8 clips through `batch_predict` at batch 4, 3
   crops + flips each; the logits must be finite, (n, 3806), the same for a
   clip in a full batch and in a padded tail, and close to the same model
   with plain attention; every kernel of the path must have been launched.
4. Training: the full-width flagship takes train steps through
   `make_train_step` (train_fn -> ViT-B/16 bf16 -> AVT-h -> cls + past-cls +
   feat losses -> nesterov SGD with a bf16 momentum buffer under warmup +
   cosine) on 16 uint8 clips, bench.py's train step. Every loss is finite;
   step 0 (LR 0) leaves the parameters as they were and step 1 changes
   them; each step launches each attention kernel once per ViT block; every
   parameter of the attention branch gets a finite gradient; on one clip,
   gradients with the kernels and with the plain versions agree. Prints step
   ms, clips/s, MFU, peak memory and a profile of one step.
4b. train_fused: the same step, weights, batch and dropout seed with the
   ViT's attention op swapped for `fused_qkv_attention(use_kernel=True)`
   (this phase only): 12 fused forward and 12 no-db backward launches a
   step and no packed forward; the step-0 loss within 1e-2 relative of the
   split step's; the one-clip gradients of every block's qkv weight and
   bias and norm1 within GRAD_TOL of the split path's; step ms beside
   phase 4's.
4c. trainer: the full-width flagship of phase 4 trained through
   `run_training` on host numpy batches from an in-script loader (4 batches
   an epoch of 16 uint8 clips, reshuffled per epoch): 2 epochs, 3 steps a
   call (`make_multi_step`) and a one-batch tail, nesterov SGD with a bf16
   momentum under warmup 1 epoch + cosine over 2, an eval of 2 batches of 4
   clips (3 crops + flips) through `make_eval_step` and `evaluate` after
   each epoch, the rolling and the best checkpoint at each epoch's end. The
   optimizer counts 8 steps; every loss and the primary metric are finite;
   both checkpoints exist and the rolling one restores epoch 2.0; the
   stored logits are (8, 3806) and finite; 12 packed forward and backward
   launches a step and 12 forward launches an eval forward, nothing else.
   Then run B: the same weights in single steps, a save every half epoch,
   a crash when the loader is asked for global batch 7; a fresh model and
   optimizer restore epoch 1.5 and finish. Its per-step losses equal run
   A's within 1e-3 relative, its final parameters within 1e-3 of each
   tensor's max |value|, and it prints whether the bits are equal. Prints
   the loop's step ms beside phase 4's bare step, the save time and size
   and the evaluator's ms a batch.
5. A depth-2 ViT with 24 heads of 32 takes a train step: its attention goes
   through `packed_short_attention`, the backward kernel's no-db form.
6. The feature path of expts/02 at full width (identity backbone, 1024-d
   features, AVT-h of 6 layers, inter_dim 2048, 4 heads of 512, 3806
   actions, f32, batch 64) at a long observed context of 256 features,
   which sends every AVT-h layer through the flash kernels: the flash
   forward and backward are first held against their plain versions
   (bf16 and f32, causal and not, head dims 64, 256, 512 and 1024, T=200
   and 256) and timed beside the plain versions and SDPA, the backward
   also side by side (the dq and dk/dv kernels, from a profile, each
   beside its own bound), at (64, 256, 4x512) and (64, 128, 2x1024); the
   forward in f32 at those and at zoo_transformer's (64, 256, 8x64)
   non-causal, and in bf16 at (64, 256, 4x512), also in turns with
   FLASH_PARENT_COMMIT's (the FMA register tiles it replaced), and the f32
   backward at the three f32 shapes must give the bits of
   FLASH_PARENT_COMMIT's, where git history has them; then `make_eval_step` and
   5 timed `make_train_step` steps (nesterov SGD under warmup + cosine) run,
   with 6 forward launches per eval forward and 6 + 6 per train step; step 0
   (LR 0) leaves the parameters as they were; every AVT-h attention
   parameter gets a finite gradient; on 2 clips, gradients with the kernels
   and with the plain versions agree. At the shipped context of 10 features
   no flash kernel runs. Prints step ms, clips/s, peak memory and a profile.
6b. feature_d1024: expts/04 at full width (2048-d features, AVT-h 2048 wide,
   8 layers of 2 heads of 1024, f32, batch 64) at 128 observed features:
   an eval step (8 flash forward launches), step 0 at LR 0 (parameters
   unchanged), 2 timed train steps (8 + 8 launches each), finite attention
   gradients; prints step ms, clips/s and peak memory.
7. ek55_adam: expts/08 at full width (identity backbone, 1024-d features,
   AVT-h of 12 layers, 8 heads, 2048 wide, model dropout 0.8, no past
   classification, 2513 EK55 actions, f32, batch 32 of 10 features) with
   Adam under warmup + cosine: step 0 (LR 0) leaves the parameters as they
   were, step 1 changes them, no kernel launches (10 tokens); prints step
   ms, clips/s, TFLOP/s, peak memory, idle share and the optimizer's share
   of device time.
8. train_net: expts/02 from its experiment file through `train_net.cli`
   (the config, datasets, loader, model, `run_training`, `evaluate`), on a
   synthetic EK100 tree written with numpy and csv (`write_ek100_tree`:
   RULSTM csv annotations, 97 verbs, 300 nouns, 3806 actions, 1024-d f32
   .npy features at 30 fps), the overrides pointing the annotations and
   the npy reader at it and cutting it to 1 epoch (4 train batches of 64,
   2 eval batches); the model, batch size, optimizer and losses as the
   file sets them. (a) At the shipped 10 observed features: no kernel
   launches. (b) At 256: 6 flash forward + 6 backward launches a train
   step and 6 forward launches an eval batch, nothing else; finite losses,
   final_acc/action/AR5 among the final metrics, a checkpoint at epoch 1,
   and a second call that resumes from it, trains nothing and evaluates.
   Prints rows, steps, the loop's ms a step, the host's data ms a batch,
   the eval's ms a batch and the launches, beside the card's name and
   power limit.
9. train_net_raw: expts/01 from its experiment file through
   `train_net.cli` at full width (ViT-B/16 in f32, AVT-h of 6 layers, 4
   heads, inter_dim 2048, 10 frames at 1 fps, batch 3, 3 crops + flips at
   eval), in a scratch working directory: a synthetic EK100 tree of raw
   videos (`write_ek100_tree` with mp4v videos of 456x256 at 30 fps, 16 s,
   written with OpenCV) read by the file's `DefaultReader` (the native
   libav decoder, built at first use, or OpenCV when it does not build),
   and a seeded timm in21k ViT-B/16 file (`write_timm_vit`, with its
   21843-class head and pre_logits) where the file's
   `train.init_from_model` looks. 1 epoch of 4 train batches and 2 eval
   batches, then a resumed call that only evaluates. The backbone's leaves
   must equal the file's bit for bit before step 1, head and pre_logits
   must not load, the losses and the metric must be finite, and the
   launches are 12 packed forward + 12 packed backward (f32, with db) a
   step and 12 forward an eval batch, nothing else. Before it, phase 2
   also holds the packed kernels' f32 forms against their plain versions
   at this path's shapes (N=30 and 180 frames forward, 30 backward) and
   times them. Prints the reader that ran, the loop's ms a step, the
   host's decode wait a train batch and eval's ms a batch, beside the
   card's name and power limit; then a profile of one train step of the
   model the call built, on its first batch (device busy, idle share,
   kernel groups, the packed f32 kernels' share of device time), with
   this checkout's packed kernels and with PARENT_COMMIT's.
10. rulstm_expt05: expts/05 from its experiment file through
   `train_net.cli` as shipped (test only, eval batch 128, 11 features at 30
   fps read the RULSTM way, the RULSTM aggregator 1024 wide with 3 padding
   steps, 3806 actions), on phase 8's synthetic tree read by the npy reader
   with read_type=exact_rulstm, and a seeded file in the original RULSTM
   layout (`write_rulstm`) where its two-entry `train.init_from_model`
   spec points: the LSTMs and the action classifier must equal the file bit
   for bit after init; no kernel launches; finite metrics. Prints them,
   the host's data wait and `evaluate`'s ms a batch, and a profile of one
   eval step of the model the cli built, on its first batch.
11. zoo_transformer: the feature path with the Transformer aggregator at
   its defaults (6 layers of 8 heads of 64, 512 wide, FFN 2048), the MLP
   future predictor and the MLP classifier over 256 observed features, no
   subclips, through `train_net.cli` with expts/02's data, reader and
   optimizer lines on phase 8's tree (`zoo_transformer_overrides`), batch
   64, f32, 1 epoch of 4 batches and 2 eval batches: 6 flash forward + 6
   backward launches a step and 6 forward an eval batch, the kernels in
   their non-causal form; finite losses and metric. Before it, phase 2
   holds the non-causal flash forward and backward at (64, 256, 8, 64), f32
   and bf16, against their plain versions (bits on a repeat) and times the
   f32 ones beside SDPA and their bound. Prints the loop's ms a step and a
   profile of one train step by kernel group with the flash kernels' share.
12. rollout: expts/02 from its file through `train_net.cli` at 256
   observed features with AVT-h rollouts of 2 steps in training and 8 at
   eval (`output_len=2`, `output_len_eval=8`; the file's dropout, so the
   position-stable masks are live), on phase 8's kind of tree: 4 steps of
   12 flash forward + 12 backward launches (6 layers x 2 passes, at 256 and
   257 tokens) and 2 eval batches of 48 forward launches. Then, on the
   trained weights and the first train batch, `rollout_mode=cache` against
   the recompute mode: the eval outputs at L=8 and one train step's losses
   and gradients at L=2 within ROLLOUT_TOL of their largest magnitude
   (recompute 48 / 12 + 12 launches, cache 6 / 6 + 6), and a long eval
   rollout of L=128 on 8 clips (up to 383 tokens; recompute 768 flash
   launches, cache 6 and 127 plain masked decode steps), each mode timed
   with its peak memory. Before it, phase 2 holds the flash kernels at
   AVT-h's heads (4 x 512), causal, f32 and bf16, at T=257 (batch 64) and
   T=383 (batch 8) against their plain versions.
13. quantized: `kmeans_fit` on the card (k=4096 over every training
   feature of a synthetic tree, timed); the centroids as .npy feed expts/02
   at its shipped 10 features with `assign_to_centroids` and a
   MultiDimCrossEntropy feat loss through `train_net.cli`: 4 steps and 2
   eval batches, no kernel launches, finite losses and metric, the
   checkpoint's encoder and tied decoder equal.
14. conv_default: conf/config.yaml through `train_net.cli` with no
   --config-file (r2plus1d_34, 63.6 M parameters, the mean aggregator,
   identity future, linear classifier; 16 frames at 112 after the fixed
   128 x 174 resize; train batch 16, eval 64; f32 cuDNN convolutions, TF32
   off) on a synthetic tree of raw mp4v videos (`write_ek100_tree` with
   video, written in parallel), cut to 4 train batches and 2 eval batches:
   no kernel launches, finite losses and metric, every BatchNorm running
   statistic moved by training and none by an eval batch; the loop's ms a
   step, the decode wait, a profiled step (conv and batch-norm groups,
   TFLOP/s of the convolutions and linears, peak memory). Then, with train
   clips read by center_clip and cuDNN deterministic, 2 epochs straight
   against 2 crashed at the start of epoch 2 and resumed by a new cli
   call: the final checkpoints within 1e-3 of each tensor's max, running
   statistics included, and whether the bits are equal.
15. bn_inception: the same tree with `model/backbone=bn_inception` (N=0) at
   10 frames, smaller side 256, 224 crops, one train step of 64 clips and
   one eval batch of 128, from a seeded pretrainedmodels-layout file
   (`write_bninception`) that must load bit for bit (not last_linear nor
   the counts); then a seeded torchvision-layout r2plus1d_18 file
   (`write_video_resnet`) loads into `model/backbone=r2plus1d_18` bit for
   bit, its eval forward finite. No launches.
16. ssl: expts/02 at 256 features with `train_eval_op=pred_future_feat`
   (`SSL_OVERRIDES`: the InfoNCE, a 2048-d projection, future clips, no
   subclips and so no past classifier) through `train_net.cli`, on a tree
   whose feature stores reach past each future clip: each step runs AVT-h
   once over the 64 observed and 64 future clips, 6 flash forward + 6
   backward launches, 6 forward an eval batch; finite losses (reg among
   them); the loop's ms a step and a profiled step with its peak memory.
17. export: the serving flagship of phase 3 with its preprocessing as a
   `torch.export` program (`export_eval_forward`) at batch 4 and 32, saved
   as .pt2 and loaded in a fresh process that imports only
   `avt_tpu_torch.ops` (and serve's host loop): 12 packed forward launches
   a forward, nothing else; logits/action within the serving tolerance of
   `make_eval_forward` on the same clips (the largest difference and
   whether the bits are equal printed); a request's ms through the loaded
   program and through the eager forward at batch 4 and 32. Then the
   program with bake_params=False at batch 4 on `model_params`.
18. ddp: expts/02 at 256 features, 2 steps of 64 clips and 1 eval batch,
   in this process, as one NCCL rank and as 2 gloo ranks of 32 clips
   sharing the card, the ranks started by `avt_tpu_torch.launch --spawn`:
   6 + 6 flash launches a step on each rank, 6 an eval batch; one rank
   equal to the process bit for bit (else the gap printed); 2 ranks' mean
   losses, a parameter of the checkpoint rank 0 wrote and the merged eval
   results within 1e-4 of the process; each way's step ms.
18b. tp: tensor parallelism (parallel.model_size=2) as 2 gloo ranks
   sharing the card, which prove the slice right with the hand kernels on
   local heads and say nothing of its speed across cards (gloo through the
   host sets the times). expts/02 as phase 18 runs it, through
   `avt_tpu_torch.launch --spawn 2 parallel.model_size=2`: 6 + 6 flash
   launches a step on each rank at 2 heads of 512, 6 an eval batch; the
   losses, every tensor of the checkpoint rank 0 wrote (the one-process
   layout) and the merged eval results (model rank 0 writes them) within
   2e-5 of phase 18's one-process run; that checkpoint resumed in one
   process through `train_net.cli` and evaluated, within 2e-5. Then the
   flagship's bf16 train step at 8 clips in this process and as 2 model
   ranks (`python -m chip_smoke --tp-flagship-rank`): 12 packed forward +
   12 backward (db) launches a step on each rank at 6 heads of 64; the
   losses within 2e-2 and the updates of a parameter of each kind within
   5e-2 of one process's (TP_LOSS_TOL, TP_UPDATE_TOL). Before it, phase 2
   holds the packed kernels at N=160, T=197, H=6 and 3 (ViT-B/16's heads
   over 2 and 4 ranks), bf16 and f32, and the flash kernels at (64, 256, 2,
   512) f32 causal against their plain versions. Prints each step's ms.
19. featext: the tools' workflow in a scratch working directory
   (`featext_phase`): a synthetic EK100 tree of 4 fps mp4v videos with 256
   s before every action and a seeded timm ViT-B/16 file;
   `tools/torch_extract_features.py -c expts/01_ek100_avt.txt` in this
   process (ViT-B/16 f32 at 224 with the file's weights, the mean
   aggregator's temp_agg over one frame a dense clip every 0.25 s, batches
   of 64): 12 packed forward launches an eval batch and nothing else, the
   first and last batches' features within 1e-3 of their scale of plain
   attention's, every packed row read back bit for bit through
   NpyFeatsReader, a profiled extraction batch; expts/02 through `train_net.cli` on the
   768-d store at 256 observed features (4 steps of 64, 2 eval batches): 6
   + 6 flash launches a step, 6 an eval batch; on its results the EPIC
   metrics, a self-fusion at (0.5, 0.5) equal to the run, the EK100
   submission zip with every eval uid and a discarded one;
   `tools/torch_compute_centroids.py` (k=64) on the store, no launches;
   `tools/torch_viz_attention.py`'s maps of expts/01's model at
   output_len 2 (12 packed launches, rows summing to 1 within 1e-5, the
   causal block's upper triangle 0, within 1e-3 of plain attention's maps,
   the figures when matplotlib is there). Before it, phase 2 holds the
   packed f32 forward against its plain version at this phase's batches
   (N=64, the last extraction batch's 48, and 60 = 10 frames x 6 views).
   Prints the extraction's clips/s and decode wait, the packed kernel's
   share of a batch, pack s and the store's MB, the loop's ms a step and
   data wait, the analysis s, beside the card's name and power limit.
20. adafactor_plateau: expts/02's lines at 256 observed features with
   `opt/optimizer=adafactor` and `opt/scheduler=reduce_lr_on_plateau`
   (patience 0, an absolute threshold no eval beats: PLATEAU_OVERRIDES)
   through `train_net.cli` on 4 train and 2 eval videos, 2 epochs of 2
   steps of 64, an eval batch after each: 6 + 6 flash launches a step, 6
   an eval batch; finite losses; the plateau stepped once an eval, equal
   to a replay in this process, and no multiplier (Adafactor's relative
   step ignores the LR); one Adafactor update on the trained state, card
   against CPU from the same parameters, gradients and state: parameters,
   row, col and v within 1e-5 of each tensor's max |value|. Then expts/02
   from its file (SGD) at 10 features with the same plateau, no launches:
   the multipliers after each eval equal the replay's exactly and fall by
   the factor at the second.
21. rulstm_train: expts/05 from its file with test_only=false, 1 epoch of 4
   steps of 128 from the seeded RULSTM file (its two-entry
   `train.init_from_model`) and an eval batch; no launches; finite losses
   and metric; one train step's losses and gradients card against CPU with
   the same dropout masks (`cpu_draws`) within 1e-4 of their scale.
22. zoo_cloze: phase 11's run with the Transformer aggregator's cloze on
   (ratio 0.15, tx_mlm weight 1.0): the cloze key mask sends training's
   attention to the plain path, so only eval launches the flash forward, 6
   a batch; tx_mlm among the finite losses; one train step card against
   CPU with the same cloze draw within 1e-4 of scale.
23. mha: `multi_head_attention`, the public function, at AVT-h's width
   (f32, 4 heads of 512, biases): x_q (64, 256, 2048) over x_kv (64, 383,
   2048), causal and not, and a self-attention at (64, 256): 1 flash
   forward + 1 backward launch each; the output and every input, weight
   and bias gradient within 2e-4 of the same calls with the flash kernels'
   plain versions (`PlainFlash`). Before it, phase 2 holds the flash
   kernels at (64, 256 vs 383, 4, 512), f32 causal and not and bf16 causal,
   against their plain versions and times the f32 ones beside SDPA and the
   bound; it also times the flash kernels at (8, 383, 4, 512), the fused
   kernel's bf16 multi-tile form (N=160, T=257, checked against its plain
   version) and the packed f32 backward with db at head dim 128 (N=30, H=6,
   checked likewise).
Only phase 4b launches the fused kernel. Prints one JSON line of kernel results, then {"ok": true, "device": ...}.
Exits non-zero on any failure, and without a CUDA device.
"""
import contextlib
import copy
import csv
import functools
from concurrent.futures import ThreadPoolExecutor
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from avt_tpu_torch import (
    VideoPreprocessor,
    basic_loss_accuracy,
    batch_predict,
    build_avt,
    build_optimizer,
    make_eval_forward,
    make_eval_step,
    make_multi_step,
    make_train_step,
    restore_checkpoint,
    run_training,
    save_checkpoint,
)
from avt_tpu_torch.evaluate import RESULTS_SAVE_DIR, evaluate, read_results
from avt_tpu_torch.losses import mse
from avt_tpu_torch.models import (
    AVTh,
    AVTModel,
    IdentityAgg,
    LinearClassifier,
    ViT,
    kmeans_fit,
    position_stable_dropout,
)
from avt_tpu_torch.models import vit as vit_module
from avt_tpu_torch.models.flagship import init_weights
from avt_tpu_torch.ops import _build, attention, multi_head_attention
from avt_tpu_torch.ops import flash_attention as fa
from avt_tpu_torch.train import (
    BEST_NAME,
    CKPT_NAME,
    MetricLogger,
    train_one_epoch,
    weighted_loss_sum,
)
from avt_tpu_torch.train import loop as loop_module
from avt_tpu_torch.train.optim import Adafactor, ParamGroup, Plateau, ReduceLROnPlateau
from avt_tpu_torch.train.step import _forward

# H100 SXM peaks (NVIDIA data sheet, dense): the bound is the larger of
# bytes over memory rate and operations over the type's peak rate
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor cores / FMA units
TF32_FLOPS = 495e12  # tensor cores, TF32: the packed kernels' f32 products, 3 each
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
NUM_ACTIONS = 3806
VIT_BLOCKS = 12  # one packed-attention launch per ViT block per forward
BATCH = 4
CLIP = (10, 256, 342, 3)  # frames of one clip: T, H, W, RGB (bench.py's eval input)
TRAIN_CLIPS = 16  # bench.py's train batch: 16 clips x 10 frames = 160 ViT frames
# bench.py's model cost per clip, forward + backward: ViT-B/16 35.2 GFLOP a
# frame x 10 frames, AVT-h 9.7, heads 1.6, x3
TRAIN_FLOPS_PER_CLIP = (35.2e9 * 10 + 9.7e9 + 1.6e9) * 3
LOSS_WTS = {"cls_action": 1.0, "past_cls_action": 1.0, "feat": 1.0}
TIMED_STEPS = 10
GRAD_TOL = 5e-2  # kernels vs plain attention, of each gradient's max |value|
# the feature path of expts/02: 1024-d features, AVT-h 2048 wide, 6 layers of
# 4 heads of 512, batch 64; 256 observed features reach the flash kernels
FEAT_DIM, FEAT_BATCH, AVTH_DIM, AVTH_LAYERS, AVTH_HEADS = 1024, 64, 2048, 6, 4
LONG_T, SHORT_T = 256, 10
FEAT_TIMED_STEPS = 5
FLASH_SHAPE = (FEAT_BATCH, LONG_T, AVTH_HEADS, AVTH_DIM // AVTH_HEADS)  # (B, T, H, D)
# expts/04 (EK100 irCSN-152 features): 2048-d features, AVT-h 2048 wide, 8
# layers of 2 heads of 1024, batch 64; 128 observed features reach the flash
# kernels (the shortest such context)
D1024_FEAT, D1024_LAYERS, D1024_HEADS, D1024_T, D1024_TIMED_STEPS = 2048, 8, 2, 128, 2
FLASH_SHAPE_D1024 = (FEAT_BATCH, D1024_T, D1024_HEADS, AVTH_DIM // D1024_HEADS)
NO_FLASH = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
NO_OTHER = {**NO_FLASH, "fused_qkv_attention_fwd": 0}  # kernels off the ViT's default path
# expts/08 (EK55, RULSTM TSN-RGB features): AVT-h of 12 layers, 8 heads, 2048
# wide over 1024-d features, model dropout 0.8, no past classification, 2513
# EK55 actions, batch 32, 10 observed features; Adam lr 5e-6 wd 1e-4
EK55_ACTIONS, EK55_LAYERS, EK55_HEADS, EK55_BATCH = 2513, 12, 8, 32
EK55_LOSS_WTS = {"cls_action": 1.0, "past_cls_action": 0.0, "feat": 2.0}
EK55_TIMED_STEPS = 5
# the trainer phase: 2 epochs of 4 batches of 16 clips, 3 steps a call in run
# A, which saves at each epoch's end and the best (a flagship checkpoint is
# 2.4 GB, ~4 s to write); run B takes single steps, saves every half epoch and
# crashes when asked for global batch 7, after its save at epoch 1.5 (with 3
# steps a call no save inside an epoch comes before a crash)
TRAINER_BATCHES, TRAINER_EPOCHS, TRAINER_K, TRAINER_CRASH_AT = 4, 2, 3, 7


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters=10, reps=5):
    """Device time of one fn() call in ms: CUDA events around `iters` calls
    back to back (so host overhead hides behind the queue), median of `reps`."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def card_normal(seed, *shapes):
    """Standard normal f32 tensors of `shapes`, drawn on the card from `seed`
    (numpy took 1-3 s a call on the host for the kernel checks' inputs, most
    of phase 2's time)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda") for s in shapes]


def attention_inputs(N, T, H, D, dtype, seed):
    qkv, bias = card_normal(seed, (N, T, 3 * H * D), (3 * H * D,))
    return qkv.to(dtype), bias


def roofline_ms(nbytes, flops, flops_per_s):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over `flops_per_s`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tf32_floor(nbytes, flops):
    """The floor of an f32 kernel whose products run as three TF32 products
    each on the tensor cores, under keys of its own beside the FMA bound."""
    ms, by = roofline_ms(nbytes, 3 * flops, TF32_FLOPS)
    return {"tf32_floor_ms": ms, "tf32_floor_by": by}


def attention_work(N, T, H, D, dtype):
    """Bytes (qkv, bias in; out) and operations of the packed forward."""
    s = torch.finfo(dtype).bits // 8
    C = H * D
    return (N * T * 3 * C + 3 * C + N * T * C) * s, 4 * N * H * T * T * D


def attention_bound_ms(N, T, H, D, dtype):
    return roofline_ms(*attention_work(N, T, H, D, dtype), PEAK_FLOPS[dtype])


def check_attention(N, T, H, D, dtype, causal, seed):
    """Kernel (bias form, as the ViT calls it) against the plain version."""
    qkv, bias = attention_inputs(N, T, H, D, dtype, seed)
    out = fa.packed_qkv_bias_attention(qkv, bias, H, causal)
    torch.cuda.synchronize()
    ref = fa.packed_short_attention_reference(qkv + bias.to(dtype), H, causal)
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out, ref, atol=TOL[dtype], rtol=TOL[dtype])
    check(torch.equal(fa.packed_qkv_bias_attention(qkv, bias, H, causal), out),
          f"short_attention_fwd N={N} T={T} D={D}: bits differ on a repeat")
    log(f"short_attention_fwd N={N} T={T} H={H} D={D} {str(dtype)[6:]} causal={causal}: "
        f"max_abs_err={err:.3g} (tolerance {TOL[dtype]}), same bits on a repeat")
    return err


def time_attention(N, T, H, D, dtype):
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(N, T, 3 * H * D, generator=gen, device="cuda", dtype=dtype)
    bias = torch.randn(3 * H * D, generator=gen, device="cuda")
    C = H * D
    q, k, v = (x.view(N, T, H, D).transpose(1, 2) for x in qkv.split(C, dim=-1))
    kernel_ms = cuda_ms(lambda: fa.packed_qkv_bias_attention(qkv, bias, H))
    plain_ms = cuda_ms(lambda: fa.packed_short_attention_reference(qkv + bias.to(dtype), H),
                       iters=2, reps=3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    bound, bound_by = attention_bound_ms(N, T, H, D, dtype)
    res = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound, bound_by=bound_by)
    if dtype == torch.float32:
        res.update(tf32_floor(*attention_work(N, T, H, D, dtype)))
    log(f"short_attention_fwd timing N={N} T={T} H={H} D={D}: " + fmt(res))
    return res


def fmt(res):
    return " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in res.items())


def time_unpaired_fwd(N, T, H, D, dtype):
    """The forward's D=32 / D=128 templates (the TPU's unpaired kernel),
    without bias, as packed_attention calls them."""
    qkv = torch.randn(N, T, 3 * H * D, generator=torch.Generator(device="cuda").manual_seed(2),
                      device="cuda", dtype=dtype)
    q, k, v = (x.view(N, T, H, D).transpose(1, 2) for x in qkv.split(H * D, dim=-1))
    out = fa.packed_short_attention(qkv, H)
    ref = fa.packed_short_attention_reference(qkv, H)
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out, ref, atol=TOL[dtype], rtol=TOL[dtype])
    bound, bound_by = attention_bound_ms(N, T, H, D, dtype)
    bound -= 1e3 * 3 * H * D * (torch.finfo(dtype).bits // 8) / HBM_BYTES_PER_S  # no bias
    res = dict(ms=cuda_ms(lambda: fa.packed_short_attention(qkv, H)),
               plain_ms=cuda_ms(lambda: fa.packed_short_attention_reference(qkv, H),
                                iters=2, reps=3),
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
               bound_ms=bound, bound_by=bound_by, max_abs_err=err)
    log(f"short_attention_fwd unpaired N={N} T={T} H={H} D={D}: " + fmt(res))
    return res


def bwd_inputs(N, T, H, D, dtype, seed):
    """qkv (N, T, 3C), dout (N, T, C), bias (3C), in the storage type."""
    return [x.to(dtype) for x in card_normal(seed, (N, T, 3 * H * D), (N, T, H * D),
                                             (3 * H * D,))]


def rel_err(out, ref):
    """max |out - ref| / max |ref|"""
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def check_attention_bwd(N, T, H, D, dtype, causal, with_db, seed):
    """The backward kernel (with db: the bias form the ViT's autograd calls;
    without: packed_short_attention's) against the plain version."""
    qkv, dout, bias = bwd_inputs(N, T, H, D, dtype, seed)
    if not with_db:
        bias = None
    dqkv, db = fa._launch_bwd(qkv, bias, dout, H, causal, with_db)
    torch.cuda.synchronize()
    ref, ref_db = fa.packed_short_attention_bwd_reference(
        qkv if bias is None else qkv + bias, dout, H, causal, with_db)
    err = rel_err(dqkv, ref)
    max_abs = (dqkv.float() - ref.float()).abs().max().item()
    msg = (f"short_attention_bwd N={N} T={T} H={H} D={D} {str(dtype)[6:]} causal={causal} "
           f"db={with_db}: dqkv max_abs_err={max_abs:.3g}, {err:.3g} of max|ref|")
    check(err <= TOL[dtype], msg)
    if with_db:
        db_err = rel_err(db, ref_db)
        msg += f"; db {db_err:.3g} of max|ref|"
        check(db_err <= TOL[dtype], msg)
    again, db_again = fa._launch_bwd(qkv, bias, dout, H, causal, with_db)
    check(torch.equal(again, dqkv) and (db is None or torch.equal(db_again, db)),
          msg + ": bits differ on a repeat")
    log(msg + f" (tolerance {TOL[dtype]}), same bits on a repeat")
    return max_abs


def attention_bwd_work(N, T, H, D, dtype, with_db=True):
    """Bytes (qkv, dout in, dqkv out; with db also the bias in and db out)
    and operations of the packed backward."""
    s = torch.finfo(dtype).bits // 8
    C = H * D
    nbytes = (N * T * 3 * C + N * T * C + N * T * 3 * C) * s
    if with_db:
        nbytes += 2 * 3 * C * s
    return nbytes, 10 * N * H * T * T * D  # s, dp, dq, dk, dv: five T x T x D products


def attention_bwd_bound_ms(N, T, H, D, dtype, with_db=True):
    return roofline_ms(*attention_bwd_work(N, T, H, D, dtype, with_db), PEAK_FLOPS[dtype])


PACKED_SIDES = {"query_ms": "bwd_query", "key_ms": "bwd_key", "db_ms": "db_reduce"}


def packed_side_ms(fn, iters=10):
    """Device ms per call of each kernel of the packed backward (the query
    side `bwd_query`, the key side `bwd_key`, the db sum `db_reduce`), from a
    torch.profiler pass over `iters` calls after one outside it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {side: 0.0 for side in PACKED_SIDES}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for side, key in PACKED_SIDES.items():
                if key in e.key:
                    out[side] += e.self_device_time_total / 1e3 / iters
    check(out["query_ms"] > 0 and out["key_ms"] > 0,
          f"the profile named no packed backward side: {out}")
    return out


def log_residency(csrc=_build.CSRC, f32=True):
    """Warps a block, dynamic shared memory and blocks resident on an SM of
    the packed kernels' templates (bf16 and, with `f32`, f32) and of the
    fused kernel's bf16 and f32 forms at the ViT's T=197 (the card's
    occupancy calculator over the kernels compiled from the sources in
    csrc). A library built from sources older than the packed kernels'
    storage-type argument answers for bf16 alone: give it f32=False."""
    import ctypes

    out = {}
    ints = [ctypes.c_int() for _ in range(3)]
    types = ("bf16", "f32") if f32 else ("bf16",)
    calls = [("short_attention_fwd", f"fwd D={D}", dt, (197, D), (dt == "bf16",))
             for dt in types for D in fa.HEAD_DIMS]
    calls += [("short_attention_bwd", f"{side} D={D}", dt, (197, D, side_i), (dt == "bf16",))
              for dt in types for side_i, side in enumerate(("query", "key")) for D in fa.HEAD_DIMS]
    calls += [("fused_qkv_attention_fwd", f"fused {dt}", dt, (197, int(dt == "bf16")), ())
              for dt in ("bf16", "f32")]
    for kernel, key, dt, args, last in calls:
        fn = getattr(_build.load(kernel, csrc), f"{kernel}_residency", None)
        if fn is None:  # an older copy of the sources
            log(f"  {kernel}: no residency entry in {csrc}")
            continue
        err = fn(*args, *(ctypes.byref(x) for x in ints), *(int(x) for x in last))
        check(err == 0, f"{kernel}_residency{args}: CUDA error {err}")
        warps, smem, blocks = (x.value for x in ints)
        if kernel != "fused_qkv_attention_fwd" and dt == "f32":
            key = f"{key} f32"
        out[key] = dict(warps=warps, smem_bytes=smem, blocks_per_sm=blocks)
        log(f"  {kernel} {key} ({dt}) T=197: {warps} warps a block, {smem} B of shared "
            f"memory, {blocks} blocks an SM ({warps * blocks} warps)")
    return out


def time_attention_bwd(N, T, H, D, dtype, with_db=True):
    """Kernel (with db: the bias form; without: packed_short_attention's),
    plain version, and the library yardstick: the backward of
    F.scaled_dot_product_attention on the split q/k/v views, timed as
    (forward + backward) - forward (it sums no bias gradient)."""
    qkv, dout, bias = bwd_inputs(N, T, H, D, dtype, seed=11)
    if not with_db:
        bias = None
    C = H * D
    kernel_ms = cuda_ms(lambda: fa._launch_bwd(qkv, bias, dout, H, False, with_db))
    plain_ms = cuda_ms(
        lambda: fa.packed_short_attention_bwd_reference(
            qkv if bias is None else qkv + bias, dout, H, False, with_db),
        iters=2, reps=3)
    x = qkv.detach().requires_grad_(True)
    do4 = dout.view(N, T, H, D).transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(
            *(t.view(N, T, H, D).transpose(1, 2) for t in x.split(C, dim=-1)))

    fwd_ms = cuda_ms(sdpa)
    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), x, do4))
    bound, bound_by = attention_bwd_bound_ms(N, T, H, D, dtype, with_db)
    sides = packed_side_ms(lambda: fa._launch_bwd(qkv, bias, dout, H, False, with_db))
    res = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=fwd_bwd_ms - fwd_ms,
               library_fwd_bwd_ms=fwd_bwd_ms, library_fwd_ms=fwd_ms,
               bound_ms=bound, bound_by=bound_by, **sides)
    if dtype == torch.float32:
        res.update(tf32_floor(*attention_bwd_work(N, T, H, D, dtype, with_db)))
    log(f"short_attention_bwd timing N={N} T={T} H={H} D={D} db={with_db}: " + fmt(res))
    return res


# The commit before the packed kernels' f32 forms moved to TF32 tensor
# cores: its f32 kernels are timed beside this checkout's in one run.
PARENT_COMMIT = "07676704cf97f6366b248078737f6676dadb3508"


def parent_csrc(commit=PARENT_COMMIT):
    """The kernel sources (csrc/) of `commit`, unpacked from this checkout's
    git history into the build directory (or a copy already unpacked
    there); None, logged, where there is neither."""
    dst = _build.BUILD_DIR / f"parent-{commit[:8]}"
    csrc = dst / "avt_tpu_torch" / "ops" / "csrc"
    if csrc.is_dir():
        return csrc
    root = os.path.dirname(os.path.abspath(__file__))
    try:
        tar = subprocess.run(["git", "-C", root, "archive", commit, "avt_tpu_torch/ops/csrc"],
                             capture_output=True, check=True, timeout=60).stdout
        dst.mkdir(parents=True, exist_ok=True)
        subprocess.run(["tar", "-x", "-C", str(dst)], input=tar, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        log(f"the kernels of {commit[:8]}: not timed (no git history to unpack them from: {e})")
        return None
    return csrc


def time_f32_turns(parent):
    """The packed kernels' f32 forms at expts/01's shapes, built from this
    checkout's sources ("change") and from `parent`, timed in turns on one
    card (parent, change, change, parent): the forward at a train step's
    and an eval batch's frames, the backward with db at a train step's, its
    sides from a profile. Returns {label: {shape: {"ms": [2 turns], ...}}}."""
    sources = {"parent": parent, "change": _build.CSRC}
    turns = ["parent", "change", "change", "parent"]
    out = {label: {} for label in sources}
    for N in (TNR_BATCH * TNR_FRAMES, TNR_BATCH * TNR_FRAMES * 6):
        qkv, _, bias = bwd_inputs(N, 197, 12, 64, torch.float32, seed=24)
        for label in turns:
            out[label].setdefault(f"fwd N{N}", {"ms": []})["ms"].append(
                cuda_ms(lambda: fa._launch(qkv, bias, 12, False, sources[label])))
    N = TNR_BATCH * TNR_FRAMES
    qkv, dout, bias = bwd_inputs(N, 197, 12, 64, torch.float32, seed=25)
    for label in turns:
        def run(csrc=sources[label]):
            return fa._launch_bwd(qkv, bias, dout, 12, False, True, csrc)

        res = out[label].setdefault(f"bwd N{N}", {"ms": []})
        res["ms"].append(cuda_ms(run))
        if "query_ms" not in res:
            res.update(packed_side_ms(run))
    for shape in out["change"]:
        log(f"f32 packed kernels in turns, {shape}: " + "; ".join(
            f"{label} " + fmt(dict(out[label][shape], ms="/".join(
                f"{x:.4f}" for x in out[label][shape]["ms"]))) for label in sources))
    return out


def fused_inputs(N, T, H, dtype, seed):
    """x (N, T, C), W as the ViT passes it (the transposed view of a (3C, C)
    weight) and b (3C), in the storage type; qkv comes out of order 1."""
    C = 64 * H
    x, w, b = card_normal(seed, (N, T, C), (3 * C, C), (3 * C,))
    return x.to(dtype), (w / np.sqrt(C)).to(dtype).t(), (b * 0.1).to(dtype)


def check_fused(N, T, H, dtype, causal, seed, csrc=_build.CSRC):
    """The fused kernel (built from the sources in csrc) against its plain
    version, on out and on qkv, and the same bits on a repeat."""
    x, w, b = fused_inputs(N, T, H, dtype, seed)
    out, qkv = fa._launch_fused(x, w, b, H, causal, csrc)
    torch.cuda.synchronize()
    ref, ref_qkv = fa.fused_qkv_attention_reference(x, w, b, H, causal)
    errs = [(got.float() - want.float()).abs().max().item()
            for got, want in ((out, ref), (qkv, ref_qkv))]
    for got, want in ((out, ref), (qkv, ref_qkv)):
        torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    again, qkv_again = fa._launch_fused(x, w, b, H, causal, csrc)
    check(torch.equal(again, out) and torch.equal(qkv_again, qkv),
          f"fused_qkv_attention_fwd N={N} T={T} H={H} {dtype} causal={causal}: bits differ "
          "on a repeat")
    log(f"fused_qkv_attention_fwd N={N} T={T} H={H} D=64 {str(dtype)[6:]} causal={causal}: "
        f"out max_abs_err={errs[0]:.3g}, qkv max_abs_err={errs[1]:.3g} "
        f"(tolerance {TOL[dtype]}), same bits on a repeat")
    return max(errs)


def fused_bound_ms(N, T, H, dtype):
    """x, W, b in; out and qkv out; 2*N*T*C*3C + 4*N*H*T^2*64 operations, as
    the TPU kernel's CostEstimate counts them."""
    s = torch.finfo(dtype).bits // 8
    C = 64 * H
    nbytes = (N * T * C + 3 * C * C + 3 * C + N * T * C + 3 * N * T * C) * s
    flops = 2 * N * T * C * 3 * C + 4 * N * H * T * T * 64
    return roofline_ms(nbytes, flops, PEAK_FLOPS[dtype])


def time_fused(N, T, H, dtype, csrc=_build.CSRC, yardsticks=True):
    """The fused kernel (built from the sources in csrc) and, with
    `yardsticks`, its plain version, the library yardstick (one matmul +
    bias, then SDPA on the split views; the port never calls it), the port's
    split path (a matmul, then the packed kernel with the bias added in its
    loads) and the bound."""
    x, w, b = fused_inputs(N, T, H, dtype, seed=12)
    C = 64 * H

    def library():
        qkv = torch.matmul(x, w) + b
        return F.scaled_dot_product_attention(
            *(t.view(N, T, H, 64).transpose(1, 2) for t in qkv.split(C, dim=-1)))

    res = dict(kernel_ms=cuda_ms(lambda: fa._launch_fused(x, w, b, H, False, csrc)))
    if yardsticks:
        bound_ms, bound_by = fused_bound_ms(N, T, H, dtype)
        res.update(plain_ms=cuda_ms(lambda: fa.fused_qkv_attention_reference(x, w, b, H),
                                    iters=2, reps=3),
                   library_ms=cuda_ms(library),
                   split_ms=cuda_ms(
                       lambda: fa.packed_qkv_bias_attention(torch.matmul(x, w), b, H)),
                   bound_ms=bound_ms, bound_by=bound_by)
        log(f"fused_qkv_attention_fwd timing N={N} T={T} H={H} D=64 {str(dtype)[6:]}: "
            + fmt(res))
    return res


def flash_inputs(B, T, H, D, dtype, seed, Tk=None):
    """q, dout (B, T, H, D) and k, v (B, Tk, H, D) (Tk = T by default) in the
    storage type."""
    return [x.to(dtype) for x in card_normal(seed, *((B, n, H, D) for n in (T, Tk or T,
                                                                           Tk or T, T)))]


def check_flash(B, T, H, D, dtype, causal, seed, Tk=None):
    """The flash forward (out, lse) and backward (dq, dk, dv) kernels against
    their plain versions, T queries over Tk keys (T by default), and the
    bits of both on a repeat; returns the forward's and the backward's max
    |err|."""
    q, k, v, do = flash_inputs(B, T, H, D, dtype, seed, Tk)
    out, lse = fa._launch_flash(q, k, v, causal, want_lse=True)
    delta = fa._delta(do, out)
    grads = fa._launch_flash_bwd(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(out, ref, atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=TOL[dtype], rtol=TOL[dtype])
    refs = fa.flash_attention_bwd_reference(q, k, v, do, out, lse, causal)
    errs = [rel_err(g, r) for g, r in zip(grads, refs)]
    fwd_err = (out.float() - ref.float()).abs().max().item()
    bwd_err = max((g.float() - r.float()).abs().max().item() for g, r in zip(grads, refs))
    msg = (f"flash_attention B={B} T={T}{'' if Tk is None else f' Tk={Tk}'} H={H} D={D} "
           f"{str(dtype)[6:]} causal={causal}: out "
           f"max_abs_err={fwd_err:.3g}, lse {(lse - ref_lse).abs().max().item():.3g}; dq, dk, dv "
           + ", ".join(f"{e:.3g} of max|ref| {r.float().abs().max().item():.3g}"
                       for e, r in zip(errs, refs)) + f" (tolerance {TOL[dtype]})")
    check(max(errs) <= TOL[dtype], msg)
    out2, lse2 = fa._launch_flash(q, k, v, causal, want_lse=True)
    check(torch.equal(out2, out) and torch.equal(lse2, lse), "flash forward: bits differ on "
          "a repeat")
    again = fa._launch_flash_bwd(q, k, v, do, lse, delta, causal)
    check(all(torch.equal(a, g) for a, g in zip(again, grads)), "flash backward: bits differ "
          "on a repeat")
    log(msg + "; forward and backward bits equal on a repeat")
    return fwd_err, bwd_err


def causal_pairs(T, causal, Tk=None):
    """The (query, key) pairs a mask keeps, T queries over Tk keys (T by
    default); causal keeps key j for query i when j <= i."""
    Tk = Tk or T
    if not causal:
        return T * Tk
    n = min(T, Tk)
    return n * (n + 1) // 2 + (T - n) * Tk


def flash_work(B, T, H, D, dtype, causal, backward, Tk=None):
    """(bytes, operations). Forward: q, k, v in, out and lse out,
    4*B*H*pairs*D; backward: q, k, v, dout, lse, delta in, dq, dk, dv out,
    10*B*H*pairs*D (s, dp, dq, dk, dv); pairs counts only the unmasked
    (query, key) pairs; T queries over Tk keys (T by default)."""
    s = torch.finfo(dtype).bits // 8
    q_rows, k_rows = B * T * H * D, B * (Tk or T) * H * D
    pairs = B * H * causal_pairs(T, causal, Tk) * D
    if backward:  # q, dout, dq; k, v, dk, dv; lse, delta
        return (3 * q_rows + 4 * k_rows) * s + 2 * B * H * T * 4, 10 * pairs
    return (2 * q_rows + 2 * k_rows) * s + B * H * T * 4, 4 * pairs  # q, out; k, v; lse


def flash_bound_ms(B, T, H, D, dtype, causal, backward, Tk=None):
    return roofline_ms(*flash_work(B, T, H, D, dtype, causal, backward, Tk), PEAK_FLOPS[dtype])


def flash_side_bound_ms(B, T, H, D, dtype, causal, side, Tk=None):
    """One side of the backward: dq reads q, k, v, dout, lse, delta and
    writes dq, 3 products (s, dp, dq); dk/dv reads the same and writes dk
    and dv, 4 products (s, dp, dk, dv)."""
    s = torch.finfo(dtype).bits // 8
    q_rows, k_rows = B * T * H * D, B * (Tk or T) * H * D
    pairs = B * H * causal_pairs(T, causal, Tk) * D
    rows = 3 * q_rows + 2 * k_rows if side == "dq" else 2 * q_rows + 4 * k_rows
    products = 3 if side == "dq" else 4
    nbytes, flops = rows * s + 2 * B * H * T * 4, 2 * products * pairs
    return roofline_ms(nbytes, flops, PEAK_FLOPS[dtype])


def flash_side_ms(fn, iters=10):
    """Device ms per call of each kernel of the flash backward (the dq side
    `flash_bwd_dq`, the dk/dv side `flash_bwd_dkv`), from a torch.profiler
    pass over `iters` calls after one outside it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {"dq": 0.0, "dkv": 0.0}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for side in out:
                if f"flash_bwd_{side}<" in e.key:
                    out[side] += e.self_device_time_total / 1e3 / iters
    check(all(ms > 0 for ms in out.values()), f"the profile named no flash backward side: {out}")
    return out


def sdpa_backend(q, k, v, causal):
    """The backend torch picks for F.scaled_dot_product_attention here."""
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=causal)).name
    except (AttributeError, RuntimeError, ValueError) as e:
        return f"unknown ({type(e).__name__})"


def time_flash(B, T, H, D, dtype, causal, Tk=None):
    """Forward (with lse, as the train step calls it) and backward kernels,
    their plain versions, and SDPA on the same (B, H, T, D) views (backward:
    (forward + backward) - forward); T queries over Tk keys (T by default;
    SDPA's is_causal keeps the same top-left pairs)."""
    q, k, v, do = flash_inputs(B, T, H, D, dtype, seed=21, Tk=Tk)
    out, lse = fa._launch_flash(q, k, v, causal, want_lse=True)
    delta = fa._delta(do, out)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    x = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]

    def sdpa():
        return F.scaled_dot_product_attention(*x, is_causal=causal)

    fwd_ms = cuda_ms(sdpa)
    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), x, do.transpose(1, 2)))
    fwd_bound, fwd_by = flash_bound_ms(B, T, H, D, dtype, causal, backward=False, Tk=Tk)
    bwd_bound, bwd_by = flash_bound_ms(B, T, H, D, dtype, causal, backward=True, Tk=Tk)
    sides = flash_side_ms(lambda: fa._launch_flash_bwd(q, k, v, do, lse, delta, causal))
    side_bounds = {side: flash_side_bound_ms(B, T, H, D, dtype, causal, side, Tk)[0]
                   for side in sides}
    res = {
        "fwd": dict(kernel_ms=cuda_ms(lambda: fa._launch_flash(q, k, v, causal, True)),
                    plain_ms=cuda_ms(lambda: fa.flash_attention_reference(q, k, v, causal),
                                     iters=2, reps=3),
                    library_ms=fwd_ms, bound_ms=fwd_bound, bound_by=fwd_by),
        "bwd": dict(kernel_ms=cuda_ms(lambda: fa._launch_flash_bwd(q, k, v, do, lse, delta,
                                                                   causal)),
                    plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_reference(
                        q, k, v, do, out, lse, causal), iters=2, reps=3),
                    library_ms=fwd_bwd_ms - fwd_ms, library_fwd_bwd_ms=fwd_bwd_ms,
                    bound_ms=bwd_bound, bound_by=bwd_by,
                    dq_ms=sides["dq"], dq_bound_ms=side_bounds["dq"],
                    dkv_ms=sides["dkv"], dkv_bound_ms=side_bounds["dkv"]),
        "sdpa_backend": sdpa_backend(*x, causal),
    }
    if dtype == torch.float32:  # both kernels' products run as three TF32 products
        for side in ("fwd", "bwd"):
            res[side].update(tf32_floor(*flash_work(B, T, H, D, dtype, causal, side == "bwd",
                                                    Tk)))
    log(f"flash_attention timing B={B} T={T}{'' if Tk is None else f' Tk={Tk}'} H={H} D={D} "
        f"{str(dtype)[6:]} causal={causal}, "
        f"SDPA backend {res['sdpa_backend']}: forward " + fmt(res["fwd"]) + "; backward "
        + fmt(res["bwd"]))
    return res


# The commit whose flash forward ran on FMA register tiles: timed in turns
# beside this checkout's tensor-core form, and its flash backward (moved to
# the shared tiling here, its arithmetic unchanged) must give the same bits
# (PARENT_COMMIT stays the packed kernels' yardstick)
FLASH_PARENT_COMMIT = "5f9805529251cc293d92452e60f29d618c3e066b"


def time_flash_fwd_turns(parent):
    """The flash forward (with lse, as the train step calls it) at the
    feature path's, feature_d1024's and zoo_transformer's shapes in f32 and
    the feature path's in bf16, built from this checkout's sources
    ("change") and from `parent`, each first checked against the plain
    version, then timed in turns on one card (parent, change, change,
    parent). Returns {label: {shape: {"ms": [2 turns], "max_abs_err": ...}}}."""
    sources = {"parent": parent, "change": _build.CSRC}
    turns = ["parent", "change", "change", "parent"]
    out = {label: {} for label in sources}
    for shape, dtype, causal in ((FLASH_SHAPE, torch.float32, True),
                                 (FLASH_SHAPE_D1024, torch.float32, True),
                                 (ZOO_SHAPE, torch.float32, False),
                                 (FLASH_SHAPE, torch.bfloat16, True)):
        q, k, v = flash_inputs(*shape, dtype, seed=29)[:3]
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal)
        key = ("x".join(map(str, shape)) + f" {str(dtype)[6:]}"
               + (" causal" if causal else " non-causal"))
        for label, csrc in sources.items():
            o, lse = fa._launch_flash(q, k, v, causal, True, csrc)
            torch.testing.assert_close(o, ref, atol=TOL[dtype], rtol=TOL[dtype])
            torch.testing.assert_close(lse, ref_lse, atol=TOL[dtype], rtol=TOL[dtype])
            err = (o.float() - ref.float()).abs().max().item()
            out[label][key] = {"ms": [], "max_abs_err": err}
        for label in turns:
            out[label][key]["ms"].append(
                cuda_ms(lambda csrc=sources[label]: fa._launch_flash(q, k, v, causal, True, csrc)))
    for key in out["change"]:
        log(f"flash forward in turns, {key}: " + "; ".join(
            f"{label} " + fmt(dict(out[label][key], ms="/".join(
                f"{x:.4f}" for x in out[label][key]["ms"]))) for label in sources))
    return out


def check_flash_bwd_bits(parent):
    """The flash backward's (dq, dk, dv) in f32 at the path shapes (the
    feature path's, feature_d1024's and zoo_transformer's), built from this
    checkout's sources and from `parent`: the same bits. Returns {shape:
    True}."""
    out = {}
    for shape, causal in ((FLASH_SHAPE, True), (FLASH_SHAPE_D1024, True), (ZOO_SHAPE, False)):
        q, k, v, do = flash_inputs(*shape, torch.float32, seed=30)
        o, lse = fa._launch_flash(q, k, v, causal, want_lse=True)
        delta = fa._delta(do, o)
        got = fa._launch_flash_bwd(q, k, v, do, lse, delta, causal)
        want = fa._launch_flash_bwd(q, k, v, do, lse, delta, causal, parent)
        key = "x".join(map(str, shape)) + (" causal" if causal else " non-causal")
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        check(same, f"flash backward {key}: bits differ from {FLASH_PARENT_COMMIT[:8]}'s")
        log(f"flash backward f32 {key}: dq, dk, dv bits equal to {FLASH_PARENT_COMMIT[:8]}'s")
        out[key] = same
    return out


def kernel_group(name):
    low = name.lower()
    for key, group in (("implicit_gemm", "conv"), ("wgrad", "conv"), ("dgrad", "conv"),
                       ("convolve", "conv"), ("bn_fw", "batch norm"), ("bn_bw", "batch norm"),
                       ("short_attn", "attention kernel"), ("bwd_query", "attention bwd kernel"),
                       ("flash_fwd", "flash attention kernel"),
                       ("fused_fwd", "fused qkv attention kernel"),
                       ("flash_bwd", "flash attention bwd kernel"),
                       ("bwd_key", "attention bwd kernel"), ("db_reduce", "attention bwd kernel"),
                       ("foreach", "optimizer"), ("multi_tensor", "optimizer"),
                       ("gemm", "matmul"),
                       ("nvjet", "matmul"), ("xmma", "matmul"), ("fprop", "conv"),
                       ("nchwtonhwc", "conv"), ("layer_norm", "layer norm"),
                       ("gelu", "gelu"), ("index", "resize gather"),
                       ("memcpy", "host-to-device copy"), ("copy", "copy/cast"),
                       ("cat", "copy/cast")):
        if key in low:
            return group
    return "other elementwise"


def profile_run(fn, label):
    """Device time by kernel group over one fn() call (torch.profiler), after
    one call outside the profile: (device busy ms, {group: ms}, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    groups = {}
    for e in kernels:
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    log(f"profile, {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {g}: {ms:.2f} ms ({100 * ms / busy_ms:.1f}% of device time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<4d} {e.key[:90]}")
    log(f"  {sum(e.count for e in kernels)} kernel launches")
    return busy_ms, groups, wall_ms


def kernel_entry(mangled):
    """A readable name for a mangled kernel entry: `name<type, D>`."""
    m = re.search(r"(?:_cu_[0-9a-f]{8}|^_Z)(\d+)", mangled)
    if m is None:
        return mangled[:60]
    start = m.end()
    name, rest = mangled[start:start + int(m.group(1))], mangled[start + int(m.group(1)):]
    flag = re.match(r"ILb([01])E", rest)
    if flag is not None:
        return f"{name}<{'true' if flag.group(1) == '1' else 'false'}>"
    args = re.match(r"I(f|13__nv_bfloat16)?Li(\d+)E", rest)
    if args is None:
        return name
    dtype = {"f": "f32", "13__nv_bfloat16": "bf16"}.get(args.group(1))
    return f"{name}<{', '.join(x for x in (dtype, args.group(2)) if x)}>"


def log_registers(name, text):
    """Logs the registers and spills of every template in one kernel's ptxas
    output; returns {template: {"registers": n, "spill_bytes": stores +
    loads}}."""
    entry, out = "?", {}
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = kernel_entry(m.group(1))
        elif "registers" in line or "spill" in line:
            log(f"  {name} {entry}: {line.split(':', 1)[-1].strip()}")
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if regs:
                out.setdefault(entry, {})["registers"] = int(regs.group(1))
            if spill:
                out.setdefault(entry, {})["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
    return out


# the packed kernels' f32 templates at the ViT's head dim, which must not spill
F32_TEMPLATES = ("short_attn_fwd_tf32<64>", "bwd_query_tf32<64>", "bwd_key_tf32<64>")
# nor the flash kernels' f32 templates at the paths' head dims
FLASH_F32_TEMPLATES = tuple(f"{kernel}<f32, {D}>" for D in (64, 512, 1024)
                            for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs on the GPU only")
    t_start = time.time()

    def mark(phase):
        log(f"-- {phase} done at {time.time() - t_start:.1f} s")

    # 1. card and build -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    # FLASH_PARENT_COMMIT's flash forward (timed in turns in phase 2) and
    # backward (its bits) build beside these
    flash_parent = parent_csrc(FLASH_PARENT_COMMIT)
    parent_builds = ([(name, _build._start_build(name, flash_parent))
                      for name in (fa.FLASH_KERNEL, fa.FLASH_BWD_KERNEL)]
                     if flash_parent is not None else [])
    build_logs = _build.build()
    for name, started in parent_builds:
        _build._finish_build(name, started)
    log(f"built {sorted(_build.KERNELS)} in {time.time() - t0:.1f} s")
    registers = {}
    for name, text in build_logs.items():
        registers.update(log_registers(name, text))
    for template in F32_TEMPLATES + FLASH_F32_TEMPLATES:
        info = registers.get(template)
        check(info is not None and info.get("spill_bytes") == 0,
              f"{template}: ptxas reported {info} (want no spill)")
    residency = log_residency()

    # 2. every kernel against its plain version -----------------------------
    main_err = check_attention(240, 197, 12, 64, torch.bfloat16, False, seed=0)
    check_attention(240, 197, 12, 64, torch.float32, False, seed=0)
    check_attention(4, 100, 4, 32, torch.bfloat16, True, seed=2)
    timing = time_attention(240, 197, 12, 64, torch.bfloat16)  # one serving batch
    bench_timing = time_attention(1920, 197, 12, 64, torch.bfloat16)  # bench eval batch
    train_timing = time_attention(160, 197, 12, 64, torch.bfloat16)  # one train batch
    unpaired = {f"D{D}": time_unpaired_fwd(160, 197, 768 // D, D, torch.bfloat16)
                for D in (32, 128)}
    # the backward at the train batch (16 clips x 10 frames): the bias form
    # with db, as the ViT's autograd calls it, then the no-db form of
    # packed_short_attention at the other head dims
    bwd_err = check_attention_bwd(160, 197, 12, 64, torch.bfloat16, False, True, seed=3)
    check_attention_bwd(160, 197, 12, 64, torch.float32, False, True, seed=3)
    for causal in (False, True):
        check_attention_bwd(160, 197, 24, 32, torch.bfloat16, causal, False, seed=4)
    check_attention_bwd(160, 197, 6, 128, torch.bfloat16, False, False, seed=5)
    # the no-db form at head pairs, as the fused op's backward runs it
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (False, True):
            check_attention_bwd(160, 197, 12, 64, dtype, causal, False, seed=13)
    bwd_timing = time_attention_bwd(160, 197, 12, 64, torch.bfloat16)
    bwd_timing_240 = time_attention_bwd(240, 197, 12, 64, torch.bfloat16)
    no_db = {f"D{D}": time_attention_bwd(160, 197, 768 // D, D, torch.bfloat16, with_db=False)
             for D in (32, 64, 128)}
    # the fused projection + attention at a serving batch, f32, a train batch
    # and causal, on out and qkv; timed at the train and serving batches
    fused_err = check_fused(240, 197, 12, torch.bfloat16, False, seed=14)
    check_fused(240, 197, 12, torch.float32, False, seed=14)
    check_fused(160, 197, 12, torch.bfloat16, False, seed=15)
    check_fused(4, 100, 4, torch.bfloat16, True, seed=16)
    fused_timing = {N: time_fused(N, 197, 12, torch.bfloat16) for N in (160, 240)}
    fused_timing_f32 = time_fused(240, 197, 12, torch.float32)
    # the flash kernels at AVT-h's shape on the feature path (f32, causal),
    # both types and masks, and the other head dims at 8 heads
    flash_err = check_flash(*FLASH_SHAPE, torch.float32, True, seed=6)
    for dtype, causal in ((torch.float32, False), (torch.bfloat16, True),
                          (torch.bfloat16, False)):
        check_flash(*FLASH_SHAPE, dtype, causal, seed=7)
    for D, dtype in ((64, torch.float32), (64, torch.bfloat16), (256, torch.float32),
                     (256, torch.bfloat16)):
        check_flash(FEAT_BATCH, LONG_T, 8, D, dtype, True, seed=8)
    check_flash(FEAT_BATCH, 200, AVTH_HEADS, 512, torch.float32, True, seed=9)
    check_flash(FEAT_BATCH, 200, 8, 64, torch.bfloat16, True, seed=10)
    # head dim 1024 (expts/04's AVT-h), and at feature_d1024's own shape
    for dtype, causal in ((torch.float32, True), (torch.float32, False), (torch.bfloat16, True)):
        check_flash(8, 256, 2, 1024, dtype, causal, seed=17)
    check_flash(8, 200, 2, 1024, torch.float32, True, seed=18)
    d1024_err = check_flash(*FLASH_SHAPE_D1024, torch.float32, True, seed=19)
    check_flash(*FLASH_SHAPE_D1024, torch.bfloat16, True, seed=19)
    # the rollout's new lengths at AVT-h's heads: a training pass of 257
    # tokens (batch 64) and the long eval rollout's last pass of 383 (batch 8)
    rollout_errs = {}
    for Bn, T in ((FEAT_BATCH, LONG_T + 1), (RO_LONG_B, RO_LONG_T)):
        for dtype in (torch.float32, torch.bfloat16):
            fwd_e, bwd_e = check_flash(Bn, T, AVTH_HEADS, AVTH_DIM // AVTH_HEADS, dtype, True,
                                       seed=36)
            rollout_errs[f"B{Bn}_T{T}_{str(dtype)[6:]}"] = {"fwd": fwd_e, "bwd": bwd_e}
    # the SSL step's one forward over 64 observed and 64 future clips
    ssl_errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        fwd_e, bwd_e = check_flash(2 * TN_BATCH, LONG_T, AVTH_HEADS, AVTH_DIM // AVTH_HEADS, dtype,
                                   True, seed=37)
        ssl_errs[f"B{2 * TN_BATCH}_T{LONG_T}_{str(dtype)[6:]}"] = {"fwd": fwd_e, "bwd": bwd_e}
    # the Transformer aggregator's encoder attention: non-causal, 8 heads of 64
    zoo_err = check_flash(*ZOO_SHAPE, torch.float32, False, seed=28)
    check_flash(*ZOO_SHAPE, torch.bfloat16, False, seed=28)
    # the packed kernels' f32 forms at expts/01's shapes: a train step of 3
    # clips x 10 frames and an eval batch of 3 clips x 10 frames x 6 views
    check_attention(TNR_BATCH * TNR_FRAMES, 197, 12, 64, torch.float32, False, seed=20)
    check_attention(TNR_BATCH * TNR_FRAMES * 6, 197, 12, 64, torch.float32, False, seed=20)
    check_attention_bwd(TNR_BATCH * TNR_FRAMES, 197, 12, 64, torch.float32, False, True, seed=21)
    # and at the featext phase's: an extraction batch, the last (partial)
    # one, and viz_attention's one clip of 10 frames x 6 views
    featext_errs = {f"N{N}": check_attention(N, 197, 12, 64, torch.float32, False, seed=22)
                    for N in FX_ATTENTION_N}
    # tensor parallelism's local shapes: ViT-B/16's 12 heads over 2 ranks
    # (6 a rank: the paired kernels with db) and over 4 (3: the unpaired
    # forms, no db, as `fused_qkv_attention` takes odd head counts), and
    # AVT-h's 4 heads of 512 over 2 ranks at expts/02's batch
    tp_errs = {}
    for H in (6, 3):
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype)[6:]
            tp_errs[f"packed_fwd_N160_H{H}_{dt}"] = check_attention(160, 197, H, 64, dtype, False,
                                                                     seed=38)
            tp_errs[f"packed_bwd_N160_H{H}_{dt}"] = check_attention_bwd(
                160, 197, H, 64, dtype, False, H % 2 == 0, seed=39)
    tp_flash = (FEAT_BATCH, LONG_T, AVTH_HEADS // TP_MODEL, AVTH_DIM // AVTH_HEADS)
    tp_errs["flash_fwd_B64_T256_H2_float32"], tp_errs["flash_bwd_B64_T256_H2_float32"] = (
        check_flash(*tp_flash, torch.float32, True, seed=40))
    # multi_head_attention's cross-attention at AVT-h's heads: 256 queries
    # over 383 keys, f32 causal and not, bf16 causal
    mha_errs = {}
    for dtype, causal in ((torch.float32, True), (torch.float32, False), (torch.bfloat16, True)):
        fwd_e, bwd_e = check_flash(*MHA_FLASH, dtype, causal, seed=46, Tk=MHA_TK)
        mha_errs[f"{str(dtype)[6:]}_causal_{causal}"] = {"fwd": fwd_e, "bwd": bwd_e}
    # the fused kernel's bf16 multi-tile form (T=257: two 256-row tiles) and
    # the packed f32 backward with db at head dim 128 (`bwd_key_tf32<128>`),
    # both timed below
    fused_err_257 = check_fused(160, 257, 12, torch.bfloat16, False, seed=47)
    f32_d128_err = check_attention_bwd(TNR_BATCH * TNR_FRAMES, 197, 6, 128, torch.float32, False,
                                       True, seed=48)
    f32_fwd = {N: time_attention(N, 197, 12, 64, torch.float32)
               for N in (TNR_BATCH * TNR_FRAMES, TNR_BATCH * TNR_FRAMES * 6)}
    f32_bwd = time_attention_bwd(TNR_BATCH * TNR_FRAMES, 197, 12, 64, torch.float32)
    parent = parent_csrc()
    f32_turns = time_f32_turns(parent) if parent is not None else None
    flash_timing = time_flash(*FLASH_SHAPE, torch.float32, True)
    flash_timing_bf16 = time_flash(*FLASH_SHAPE, torch.bfloat16, True)
    flash_timing_d1024 = time_flash(*FLASH_SHAPE_D1024, torch.float32, True)
    flash_timing_zoo = time_flash(*ZOO_SHAPE, torch.float32, False)
    flash_timing_mha = {causal: time_flash(*MHA_FLASH, torch.float32, causal, Tk=MHA_TK)
                        for causal in (True, False)}
    flash_timing_383 = time_flash(RO_LONG_B, RO_LONG_T, AVTH_HEADS, AVTH_DIM // AVTH_HEADS,
                                  torch.float32, True)
    flash_turns = time_flash_fwd_turns(flash_parent) if flash_parent is not None else None
    flash_bwd_bits = check_flash_bwd_bits(flash_parent) if flash_parent is not None else None
    fused_timing_257 = time_fused(160, 257, 12, torch.bfloat16)
    f32_bwd_d128 = time_attention_bwd(TNR_BATCH * TNR_FRAMES, 197, 6, 128, torch.float32)

    mark("phase 2")

    # 3. serving: the full-width flagship through its entry points ----------
    serve_launches = serve_phase()
    mark("serve_phase")

    # 4. training: the full-width flagship, bench.py's train step -------------
    train_launches, split_train = train_phase()
    mark("train_phase")

    # 4b. the same train step through the fused projection + attention kernel
    fused_launches, fused_train = train_fused_phase(split_train)
    mark("train_fused_phase")

    # 4c. the trainer: run_training, checkpoints, eval, crash + resume ------
    trainer_launches = trainer_phase(split_train)
    mark("trainer_phase")

    # 5. the no-db form on a train step: 24 heads of 32 ----------------------
    d32_launches = small_train_phase()
    mark("small_train_phase")

    # 6. the feature path of expts/02 at 256 observed features ---------------
    feat_launches = feature_phase()
    mark("feature_phase")

    # 6b. expts/04's AVT-h (head dim 1024) at 128 observed features -------
    d1024_launches = feature_d1024_phase()
    mark("feature_d1024_phase")

    # 7. expts/08 with Adam at full width -----------------------------------
    ek55_launches = ek55_adam_phase()
    mark("ek55_adam_phase")

    # 8. expts/02 from its file through train_net, on a synthetic EK100 tree
    tn_launches = train_net_phase(card)
    mark("train_net_phase")

    # 9. expts/01 from its file through train_net, on raw video (f32 ViT)
    tnr_launches, expt01_profile = train_net_raw_phase(card, parent)
    mark("train_net_raw_phase")

    # 10. expts/05 (the RULSTM aggregator) from its file, test only
    rulstm_launches = rulstm_expt05_phase(card)
    mark("rulstm_expt05_phase")

    # 11. the Transformer aggregator over 256 features through train_net
    zoo_launches, zoo_profile = zoo_transformer_phase(card)
    mark("zoo_transformer_phase")

    # 12. AVT-h rollouts through train_net (recompute and KV cache), long rollouts
    rollout_launches, rollout_summary = rollout_phase(card)
    mark("rollout_phase")

    # 13. quantized AVT-h: k-means on the card, then expts/02 on the centroids
    quant_launches, quant_summary = quantized_phase(card)
    mark("quantized_phase")

    # 14-15. conf/config.yaml's r2plus1d_34 and BN-Inception through train_net on raw video
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        cv_tree = write_ek100_tree(os.path.join(tmp, "tree"), train_videos=CV_TRAIN_VIDEOS,
                                   eval_videos=CV_EVAL_VIDEOS, actions_per_video=CV_ACTIONS,
                                   first_action_s=CV_FIRST_S, seed=44, video=TNR_VIDEO)
        log(f"conv phases: synthetic EK100 tree ({CV_TRAIN_VIDEOS} + {CV_EVAL_VIDEOS} mp4v "
            f"videos of {TNR_VIDEO[0]}x{TNR_VIDEO[1]} at {TNR_VIDEO[2]} fps, "
            f"{CV_FIRST_S + CV_ACTIONS + 2} s) written in {time.time() - t0:.1f} s")
        conv_launches, conv_summary = conv_default_phase(card, cv_tree)
        mark("conv_default_phase")
        bni_launches = bn_inception_phase(card, cv_tree)
        mark("bn_inception_phase")

    # 16. the SSL op (pred_future_feat) on expts/02 at 256 features
    ssl_launches, ssl_summary = ssl_phase(card)
    mark("ssl_phase")

    # 17. the serving export: saved, loaded in a fresh process, run
    export_launches, export_summary = export_phase(card)
    mark("export_phase")

    # 18. data-parallel training: expts/02 as 1 NCCL rank and 2 gloo ranks;
    # 18b. tensor parallelism: expts/02 and the flagship step as 2 model ranks
    with tempfile.TemporaryDirectory() as tmp:
        ddp_launches, ddp_summary, yard = ddp_phase(card, tmp)
        mark("ddp_phase")
        tp_launches, tp_summary = tp_phase(card, yard)
        mark("tp_phase")
    tp_summary["kernel_checks"] = tp_errs

    # 19. the tools: raw video -> a packed store -> expts/02 on it -> analysis
    featext_launches, featext_summary = featext_phase(card)
    mark("featext_phase")

    # 20. Adafactor and ReduceLROnPlateau through train_net
    ap_launches, ap_summary = adafactor_plateau_phase(card)
    mark("adafactor_plateau_phase")

    # 21. expts/05 trained
    rt_launches, rt_summary = rulstm_train_phase(card)
    mark("rulstm_train_phase")

    # 22. the Transformer aggregator's cloze (MLM) training
    cloze_launches, cloze_summary = zoo_cloze_phase(card)
    mark("zoo_cloze_phase")

    # 23. multi_head_attention, the public function, at AVT-h's width
    mha_launches, mha_summary = mha_phase(card)
    mark("mha_phase")

    paths = {"serve": serve_launches, "train": train_launches, "trainer": trainer_launches,
             "train_d32": d32_launches,
             **feat_launches, "feature_d1024": d1024_launches, "train_fused": fused_launches,
             "ek55_adam": ek55_launches, **tn_launches, **tnr_launches, **rulstm_launches,
             **zoo_launches, **rollout_launches, **quant_launches, **conv_launches,
             **bni_launches, **ssl_launches, "export": export_launches, **ddp_launches,
             **tp_launches, **featext_launches, **ap_launches, **rt_launches, **cloze_launches,
             **mha_launches}
    for path, counts in paths.items():
        if path != "train_fused":
            check(counts["fused_qkv_attention_fwd"] == 0, f"a fused launch on {path}: {counts}")

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    fwd_spec, bwd_spec = _build.KERNELS["short_attention_fwd"], _build.KERNELS["short_attention_bwd"]
    kernels = [
        dict(name="short_attention_fwd", route=fwd_spec["route"], source=fwd_spec["source"],
             replaces=fwd_spec["replaces"], launches=train_launches["short_attention_fwd"],
             launches_by_path=by_path("short_attention_fwd"),
             shape=[240, 197, 12, 64], dtype="bfloat16", max_abs_err=main_err,
             ms=timing["kernel_ms"], **timing,
             train_shape={"shape": [160, 197, 12, 64], **train_timing},
             bench_shape={"shape": [1920, 197, 12, 64], **bench_timing},
             residency={k: v for k, v in residency.items() if k.startswith("fwd")},
             unpaired_shape={k: {"shape": [160, 197, 768 // int(k[1:]), int(k[1:])], **v}
                             for k, v in unpaired.items()},
             f32_shapes={f"N{N}": {"shape": [N, 197, 12, 64], **v} for N, v in f32_fwd.items()},
             f32_registers=registers.get("short_attn_fwd_tf32<64>"),
             f32_turns=f32_turns and {label: {k: v for k, v in res.items() if k.startswith("fwd")}
                                      for label, res in f32_turns.items()},
             export=export_summary,
             featext={**{k: v for k, v in featext_summary["featext"].items() if k != "groups"},
                      "kernel_checks": featext_errs},
             tp={k: v for k, v in tp_errs.items() if k.startswith("packed_fwd")}),
        dict(name="short_attention_bwd", route=bwd_spec["route"], source=bwd_spec["source"],
             replaces=bwd_spec["replaces"], launches=train_launches["short_attention_bwd"],
             launches_by_path=by_path("short_attention_bwd"),
             shape=[160, 197, 12, 64], dtype="bfloat16", max_abs_err=bwd_err,
             ms=bwd_timing["kernel_ms"], **bwd_timing,
             serve_batch_shape={"shape": [240, 197, 12, 64], **bwd_timing_240},
             residency={k: v for k, v in residency.items() if k.startswith(("query", "key"))},
             no_db_shape={k: {"shape": [160, 197, 768 // int(k[1:]), int(k[1:])], **v}
                          for k, v in no_db.items()},
             f32_shapes={f"N{TNR_BATCH * TNR_FRAMES}": {
                 "shape": [TNR_BATCH * TNR_FRAMES, 197, 12, 64], **f32_bwd}},
             f32_registers={t: registers.get(t) for t in F32_TEMPLATES[1:]},
             f32_turns=f32_turns and {label: {k: v for k, v in res.items() if k.startswith("bwd")}
                                      for label, res in f32_turns.items()},
             expt01_train_step=expt01_profile,
             f32_d128={"shape": [TNR_BATCH * TNR_FRAMES, 197, 6, 128], "max_abs_err": f32_d128_err,
                       **f32_bwd_d128, "registers": {t: registers.get(t) for t in (
                           "bwd_query_tf32<128>", "bwd_key_tf32<128>")}},
             tp={**{k: v for k, v in tp_errs.items() if k.startswith("packed_bwd")},
                 "flagship_step": tp_summary["flagship"]}),
    ]
    for name, side, err, err_d1024, err_zoo in (
            ("flash_attention_fwd", "fwd", flash_err[0], d1024_err[0], zoo_err[0]),
            ("flash_attention_bwd", "bwd", flash_err[1], d1024_err[1], zoo_err[1])):
        spec, timing = _build.KERNELS[name], flash_timing[side]
        kernels.append(dict(
            name=name, route=spec["route"], source=spec["source"], replaces=spec["replaces"],
            launches=feat_launches["feature_train"][name], launches_by_path=by_path(name),
            shape=list(FLASH_SHAPE), dtype="float32", causal=True, max_abs_err=err,
            ms=timing["kernel_ms"], **timing, library=f"SDPA ({flash_timing['sdpa_backend']})",
            bf16={"sdpa_backend": flash_timing_bf16["sdpa_backend"], **flash_timing_bf16[side]},
            d1024={"shape": list(FLASH_SHAPE_D1024), "dtype": "float32", "causal": True,
                   "max_abs_err": err_d1024, "sdpa_backend": flash_timing_d1024["sdpa_backend"],
                   **flash_timing_d1024[side]},
            zoo_transformer={"shape": list(ZOO_SHAPE), "dtype": "float32", "causal": False,
                             "max_abs_err": err_zoo,
                             "sdpa_backend": flash_timing_zoo["sdpa_backend"],
                             **flash_timing_zoo[side],
                             "train_step": {k: v for k, v in zoo_profile.items()
                                            if k != "groups"}},
            rollout_checks={k: v[side] for k, v in rollout_errs.items()},
            mha={"shape": [*MHA_FLASH[:2], MHA_TK, *MHA_FLASH[2:]], "dtype": "float32",
                 "causal": True, "max_abs_err": mha_errs["float32_causal_True"][side],
                 "sdpa_backend": flash_timing_mha[True]["sdpa_backend"],
                 **flash_timing_mha[True][side],
                 "non_causal": {"max_abs_err": mha_errs["float32_causal_False"][side],
                                "sdpa_backend": flash_timing_mha[False]["sdpa_backend"],
                                **flash_timing_mha[False][side]},
                 "bf16_causal_max_abs_err": mha_errs["bfloat16_causal_True"][side],
                 "multi_head_attention": mha_summary},
            t383={"shape": [RO_LONG_B, RO_LONG_T, AVTH_HEADS, AVTH_DIM // AVTH_HEADS],
                  "dtype": "float32", "causal": True,
                  "max_abs_err": rollout_errs[f"B{RO_LONG_B}_T{RO_LONG_T}_float32"][side],
                  "sdpa_backend": flash_timing_383["sdpa_backend"], **flash_timing_383[side]},
            **({"turns": flash_turns} if side == "fwd" else {"bits_vs_parent": flash_bwd_bits}),
            f32_registers={t: registers.get(t) for t in FLASH_F32_TEMPLATES
                           if t.startswith(f"flash_{side}")},
            adafactor_plateau=ap_summary["adafactor"], zoo_cloze=cloze_summary,
            ssl_checks={k: v[side] for k, v in ssl_errs.items()},
            rollout=rollout_summary,
            ssl_train_step={k: v for k, v in ssl_summary.items() if k != "groups"},
            ddp=ddp_summary, featext_train=featext_summary["featext_train"],
            tp={"shape": list(tp_flash), "dtype": "float32", "causal": True,
                "max_abs_err": tp_errs[f"flash_{side}_B64_T256_H2_float32"],
                **{k: v for k, v in tp_summary.items() if k not in ("flagship",
                                                                     "kernel_checks")}}))
    spec = _build.KERNELS["fused_qkv_attention_fwd"]
    kernels.append(dict(
        name="fused_qkv_attention_fwd", route=spec["route"], source=spec["source"],
        replaces=spec["replaces"], launches=fused_launches["fused_qkv_attention_fwd"],
        launches_by_path=by_path("fused_qkv_attention_fwd"), shape=[160, 197, 12, 64],
        dtype="bfloat16", max_abs_err=fused_err, ms=fused_timing[160]["kernel_ms"],
        **fused_timing[160], library="matmul + bias, then SDPA on the split views",
        serve_batch_shape={"shape": [240, 197, 12, 64], **fused_timing[240]},
        f32={"shape": [240, 197, 12, 64], **fused_timing_f32},
        multi_tile_t257={"shape": [160, 257, 12, 64], "dtype": "bfloat16",
                         "max_abs_err": fused_err_257, **fused_timing_257},
        residency={k.split(" ")[1]: v for k, v in residency.items() if k.startswith("fused")},
        train_step_ms={"fused": fused_train["step_ms"], "split": split_train["step_ms"]}))
    log(f"quantized: {quant_summary}")
    log(f"conv_default: {conv_summary}")
    log(f"rulstm_train: {rt_summary}")
    log(f"plateau (sgd): {ap_summary['plateau_sgd']}")
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


def serve_phase():
    """Requests through batch_predict at batch 4; returns the launch counts
    of the counted requests."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_avt(num_actions=NUM_ACTIONS, vit_dtype=torch.bfloat16, generator=gen)
    pp = VideoPreprocessor(crop_size=224, scale_h=248, scale_w=-1, mean=(0.5,) * 3,
                           std=(0.5,) * 3, eval_num_crops=3, eval_flip_crops=True,
                           compute_dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    fwd = make_eval_forward(model, pp)
    forwards = [0]

    def counted(chunk):
        forwards[0] += 1
        return fwd(chunk)

    clips = np.random.default_rng(0).integers(0, 256, size=(10,) + CLIP, dtype=np.uint8)
    batch_predict(fwd, clips[:BATCH], BATCH)  # warm-up, outside the counted run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    requests = [(0, 4), (0, 8), (4, 10), (6, 10)]  # (4, 10) ends in a padded tail
    results, latencies = [], []
    _build.reset_launch_counts()
    t0 = time.time()
    for lo, hi in requests:
        t_req = time.time()
        results.append(batch_predict(counted, clips[lo:hi], BATCH)["logits/action"])
        latencies.append(time.time() - t_req)
    served_s = time.time() - t0
    launches = dict(_build.launch_counts)
    n_served = sum(hi - lo for lo, hi in requests)
    for (lo, hi), logits in zip(requests, results):
        check(logits.shape == (hi - lo, NUM_ACTIONS), f"logits shape {logits.shape}")
        check(np.isfinite(logits).all(), f"non-finite logits for clips {lo}:{hi}")
    want = VIT_BLOCKS * forwards[0]
    check(launches["short_attention_fwd"] == want, f"launches {launches}, want {want}")
    check(launches["short_attention_bwd"] == 0, f"a backward launch while serving: {launches}")
    check(all(launches[n] == 0 for n in NO_OTHER), f"a flash or fused launch while serving: "
          f"{launches}")
    # the same clip in a full batch and in a padded tail (and in two batches)
    tail_vs_full = np.abs(results[2][4:6] - results[3][2:4]).max()
    np.testing.assert_allclose(results[2][4:6], results[3][2:4], atol=1e-2, rtol=2e-2)
    np.testing.assert_allclose(results[1][:4], results[0], atol=1e-2, rtol=2e-2)
    np.testing.assert_allclose(results[2][:4], results[1][4:8], atol=1e-2, rtol=2e-2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"served {len(requests)} requests, {n_served} clips in {forwards[0]} forwards of "
        f"{BATCH} clips x 6 views x 10 frames; request latency s: "
        + ", ".join(f"{x:.4f}" for x in latencies)
        + f"; {n_served / served_s:.2f} clips/s; peak memory {peak_gb:.2f} GB; "
        f"launches {launches}; padded-tail vs full-batch max |diff| {tail_vs_full:.3g}")

    empty = batch_predict(fwd, clips[:0], BATCH)["logits/action"]
    check(empty.shape == (0, NUM_ACTIONS), f"empty request gave {empty.shape}")

    # the same model with plain attention in place of the kernel, one clip
    logits = batch_predict(fwd, clips[:1], 1)["logits/action"]
    with mock.patch.object(fa, "packed_qkv_bias_attention", plain_bias_attention):
        plain_logits = batch_predict(fwd, clips[:1], 1)["logits/action"]
    scale = np.abs(plain_logits).max()
    diff = np.abs(logits - plain_logits).max()
    log(f"kernel vs plain attention, whole model, 1 clip: max |diff| {diff:.3g} "
        f"(logit scale {scale:.3g}; limit 5e-2 of the scale)")
    check(diff <= 5e-2 * scale, f"kernel vs plain attention logits differ by {diff}")

    # steady throughput at the serving batch and at bench.py's eval batch (32)
    for bs in (BATCH, 32):
        batch = np.concatenate([clips] * 4)[:bs]
        batch_predict(fwd, batch, bs)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(3):
            batch_predict(fwd, batch, bs)
        dt = (time.time() - t0) / 3
        log(f"steady forward, batch {bs}: {dt * 1e3:.2f} ms, {bs / dt:.2f} clips/s")
    batch32 = np.concatenate([clips] * 4)[:32]
    profile_run(lambda: batch_predict(fwd, batch32, 32), "serving forward, batch 32")
    return launches


def plain_bias_attention(qkv, bias, num_heads, causal=False):
    """The plain version in place of the kernels; autograd differentiates it."""
    return fa.packed_short_attention_reference(qkv + bias.to(qkv.dtype), num_heads, causal)


def train_pipeline(model, clips, iters_per_epoch=1000, num_epochs=30, warmup_epochs=20):
    """bench.py's train step on `model`: (optimizer, step, batch on the card)."""
    pp = VideoPreprocessor(crop_size=224, scale_h="248-280", scale_w=-1, mean=(0.5,) * 3,
                           std=(0.5,) * 3, flip_p=0.5, compute_dtype=torch.bfloat16,
                           out_dtype=torch.bfloat16)
    opt, _ = build_optimizer(
        model, lr_wd=[["__all__", 1e-4, 1e-5]], optimizer_name="sgd", scheduler_name="cosine",
        iters_per_epoch=iters_per_epoch, num_epochs=num_epochs, warmup_epochs=warmup_epochs,
        optimizer_kwargs={"nesterov": True, "momentum_dtype": "bfloat16"})

    def preprocess(frames, generator):
        video = pp.train_fn(frames, generator)  # (B, 3, T, 224, 224)
        return video.transpose(1, 2)[:, :, :, None]  # T clips of 1 frame, as bench.py

    step = make_train_step(model, opt, LOSS_WTS, {"action": NUM_ACTIONS}, preprocess_fn=preprocess)
    rng = np.random.default_rng(1)
    B, T = clips, CLIP[0]
    batch = {
        "video": torch.from_numpy(rng.integers(0, 256, size=(B,) + CLIP, dtype=np.uint8)).cuda(),
        "target": {"action": torch.from_numpy(rng.integers(0, NUM_ACTIONS, size=B)).cuda()},
        "target_subclips": {"action": torch.from_numpy(
            rng.integers(-1, NUM_ACTIONS, size=(B, T, 1))).cuda()},
    }
    return opt, step, preprocess, batch


def attention_branch(name):
    """A parameter of the ViT blocks' attention branch (norm1, qkv, proj)."""
    return name.startswith("backbone.") and (".attn." in name or ".norm1." in name)


def train_phase():
    """Full-width flagship train steps; returns the launch counts of the
    checked and timed steps."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_avt(num_actions=NUM_ACTIONS, vit_dtype=torch.bfloat16, generator=gen)
    opt, step, preprocess, batch = train_pipeline(model, TRAIN_CLIPS)
    params = dict(model.named_parameters())
    branch = [n for n in params if attention_branch(n)]
    check(len(branch) == 6 * VIT_BLOCKS, f"attention branch params {len(branch)}")
    before = {n: p.detach().clone() for n, p in params.items()}
    step_gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    steps = 0
    for k in range(2):  # step 0 runs at LR 0, step 1 at the first warmup LR
        t0 = time.time()
        metrics = step(batch, step_gen)
        torch.cuda.synchronize()
        steps += 1
        first_ms = (time.time() - t0) * 1e3
        launches = dict(_build.launch_counts)
        want = VIT_BLOCKS * steps
        check(launches == {"short_attention_fwd": want, "short_attention_bwd": want, **NO_OTHER},
              f"step {k}: launches {launches}, want {want} of each")
        values = {key: v.item() for key, v in metrics.items()}
        for key in ("loss", "loss/cls_action", "loss/past_cls_action", "loss/feat"):
            check(np.isfinite(values[key]), f"step {k}: {key} = {values[key]}")
        missing = [n for n in branch if params[n].grad is None]
        check(not missing, f"step {k}: no gradient for {missing[:4]}")
        bad = [n for n in branch if not torch.isfinite(params[n].grad).all()]
        check(not bad, f"step {k}: non-finite gradient for {bad[:4]}")
        changed = [n for n, p in params.items() if not torch.equal(p, before[n])]
        lr = opt.groups[0].schedule(k)
        log(f"train step {k} ({first_ms:.1f} ms with first-call costs): lr {lr:.3g}, "
            + ", ".join(f"{key} {v:.4f}" for key, v in values.items())
            + f"; {len(changed)} of {len(params)} parameter tensors changed; launches {launches}")
        if k == 0:
            loss0 = values["loss"]
            check(not changed, f"step 0 at LR 0 changed {changed[:4]}")
            moving = sum(bool(b.any()) for b in opt.momentum_buffers.values())
            check(moving > 0, "step 0 left every momentum buffer at 0")
        else:
            check(changed, "step 1 changed no parameter")
    # steady steps, host clock around TIMED_STEPS back-to-back steps
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(TIMED_STEPS):
        metrics = step(batch, step_gen)
    torch.cuda.synchronize()
    step_s = (time.time() - t0) / TIMED_STEPS
    steps += TIMED_STEPS
    launches = dict(_build.launch_counts)
    want = VIT_BLOCKS * steps
    check(launches == {"short_attention_fwd": want, "short_attention_bwd": want, **NO_OTHER},
          f"launches {launches} after {steps} steps, want {want} of each")
    check(np.isfinite(metrics["loss"].item()), "non-finite loss in the timed steps")
    clips_s = TRAIN_CLIPS / step_s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"train step, {TRAIN_CLIPS} clips x {CLIP[0]} frames: {step_s * 1e3:.2f} ms a step "
        f"(mean of {TIMED_STEPS} after 2), {clips_s:.2f} clips/s, "
        f"MFU {clips_s * TRAIN_FLOPS_PER_CLIP / PEAK_FLOPS[torch.bfloat16]:.4f} "
        f"of {PEAK_FLOPS[torch.bfloat16] / 1e12:.0f} TFLOP/s "
        f"({TRAIN_FLOPS_PER_CLIP / 1e12:.4f} TFLOP a clip); peak memory {peak_gb:.2f} GB")
    busy_ms, _, _ = profile_run(lambda: step(batch, step_gen), f"train step, {TRAIN_CLIPS} clips")
    log(f"device busy {busy_ms:.2f} ms of the steady step's {step_s * 1e3:.2f} ms: "
        f"idle share {1 - busy_ms / (step_s * 1e3):.3f}")

    # gradients on one clip, with the kernels and with the plain versions
    names = ["backbone.model.blocks.0.attn.qkv.bias", "backbone.model.blocks.11.attn.qkv.weight",
             "backbone.model.patch_embed.proj.weight", "classifiers.action.weight"]
    one = {"video": batch["video"][:1], "target": {"action": batch["target"]["action"][:1]},
           "target_subclips": {"action": batch["target_subclips"]["action"][:1]}}
    kernel_grads = one_clip_grads(model, preprocess, one, names)
    with mock.patch.object(fa, "packed_qkv_bias_attention", plain_bias_attention):
        plain_grads = one_clip_grads(model, preprocess, one, names)
    for name, gk, gp in zip(names, kernel_grads, plain_grads):
        scale = gp.float().abs().max().item()
        diff = (gk.float() - gp.float()).abs().max().item()
        log(f"grad {name}, kernels vs plain, 1 clip: max |diff| {diff:.3g} of scale "
            f"{scale:.3g} (limit {GRAD_TOL} of the scale)")
        check(scale > 0 and diff <= GRAD_TOL * scale, f"grad {name} differs by {diff}")
    return launches, dict(loss0=loss0, step_ms=step_s * 1e3, clips_s=clips_s)


def one_clip_grads(model, preprocess, batch, names):
    """Gradients of the step's loss on a small batch (one clip, or two on the
    feature path), with the dropout masks and crop draws of a fixed seed."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    model.train()
    video = preprocess(batch["video"], gen)
    target = batch["target"]
    outputs, aux = model(video, tuple(target["action"].shape), generator=gen)
    tsub = {k: v.reshape(v.shape[0], v.shape[1], -1) for k, v in batch["target_subclips"].items()}
    losses, _ = basic_loss_accuracy(outputs, target, tsub, num_classes={"action": NUM_ACTIONS})
    losses.update(aux)
    total, _ = weighted_loss_sum(losses, LOSS_WTS)
    params = dict(model.named_parameters())
    return torch.autograd.grad(total, [params[n] for n in names])


class SyntheticClips:
    """A loader of host numpy batches: `n_batches` an epoch of `batch_size`
    uint8 clips (10, 256, 342, 3) from a pool made from `seed`, with action
    targets, subclip targets, idx and uid; `set_epoch` reshuffles the pool
    from the seed (with `shuffle`). With `crash_at` set it raises, once,
    when asked for that global batch (counted across epochs)."""

    class Dataset:
        primary_metric = "final_acc/action/AR5"  # EPIC-Kitchens-100's
        classes_manyshot = None

    dataset = Dataset()

    def __init__(self, n_batches, batch_size, seed, shuffle=True):
        rng = np.random.default_rng(seed)
        n = n_batches * batch_size
        self.clips = rng.integers(0, 256, size=(n,) + CLIP, dtype=np.uint8)
        self.target = rng.integers(0, NUM_ACTIONS, size=n)
        self.tsub = rng.integers(-1, NUM_ACTIONS, size=(n, CLIP[0], 1))
        self.n_batches, self.batch_size, self.seed, self.shuffle = n_batches, batch_size, seed, shuffle
        self.epoch = 0
        self.crash_at, self.served = None, 0

    def __len__(self):
        return self.n_batches

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = self.n_batches * self.batch_size
        order = (np.random.default_rng([self.seed, self.epoch]).permutation(n) if self.shuffle
                 else np.arange(n))
        for i in range(self.n_batches):
            if self.crash_at is not None and self.served == self.crash_at:
                self.crash_at = None
                raise RuntimeError(f"simulated crash at global batch {self.served}")
            self.served += 1
            sel = np.sort(order[i * self.batch_size:(i + 1) * self.batch_size])
            yield {"video": self.clips[sel], "target": {"action": self.target[sel]},
                   "target_subclips": {"action": self.tsub[sel]}, "idx": sel,
                   "uid": np.asarray([f"clip{j:05d}" for j in sel])}


def trainer_model(clips):
    """The phase-4 flagship and train step under the trainer phase's
    schedule: (model, optimizer, step, preprocess)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_avt(num_actions=NUM_ACTIONS, vit_dtype=torch.bfloat16, generator=gen)
    opt, step, preprocess, _ = train_pipeline(model, clips, iters_per_epoch=TRAINER_BATCHES,
                                              num_epochs=TRAINER_EPOCHS, warmup_epochs=1)
    return model, opt, step, preprocess


def recording(step, losses):
    """`step` that appends each step's loss tensor (on the card) to `losses`."""
    def recorded(batch, generator):
        metrics = step(batch, generator)
        losses.append(metrics["loss"])
        return metrics

    return recorded


def trainer_phase(split):
    """The full-width flagship trained through `run_training` (phase 4's
    train step under warmup 1 epoch + cosine over 2 epochs of 4 batches of
    16 host clips, K=3 steps a call, an eval of 2 batches of 4 clips through
    `make_eval_step` and `evaluate` after each epoch, the best checkpoint
    kept), then a run that crashes at a global batch and resumes from the
    rolling checkpoint in a fresh model and optimizer. `split` holds phase
    4's steady step time. Returns the launch counts of run A."""
    loader = SyntheticClips(TRAINER_BATCHES, TRAIN_CLIPS, seed=11)
    eval_loader = SyntheticClips(2, 4, seed=12, shuffle=False)
    eval_pp = VideoPreprocessor(crop_size=224, scale_h=248, scale_w=-1, mean=(0.5,) * 3,
                                std=(0.5,) * 3, eval_num_crops=3, eval_flip_crops=True,
                                compute_dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    saves, evals, metrics, epoch_loggers, epoch_s = [], [], [], [], []

    def timed_save(ckpt_dir, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.time()
        save_checkpoint(ckpt_dir, *args, **kwargs)
        names = kwargs.get("names", (CKPT_NAME,))
        saves.append((time.time() - t0, os.path.getsize(os.path.join(ckpt_dir, names[0]))))

    def timed_epoch(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.time()
        last_saved = train_one_epoch(*args, **kwargs)
        torch.cuda.synchronize()
        epoch_s.append(time.time() - t0)
        return last_saved

    class RecordedLogger(MetricLogger):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            epoch_loggers.append(self)

    with tempfile.TemporaryDirectory() as tmp:
        # run A: two epochs straight through
        model, opt, step, _ = trainer_model(TRAIN_CLIPS)
        eval_step = make_eval_step(model, {"action": NUM_ACTIONS},
                                   preprocess_fn=lambda v: eval_pp.eval_fn(v)[:, None])

        def eval_fn(epoch):
            torch.cuda.synchronize()
            t0 = time.time()
            metric = evaluate(eval_step, {"": eval_loader}, save_dir=os.path.join(tmp, "a"),
                              epoch=epoch, device="cuda")
            evals.append(time.time() - t0)
            metrics.append(metric)
            return metric

        losses_a = []
        ckpt_a = os.path.join(tmp, "a", "ckpt")
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.time()
        with mock.patch.object(loop_module, "save_checkpoint", timed_save), \
                mock.patch.object(loop_module, "train_one_epoch", timed_epoch), \
                mock.patch.object(loop_module, "MetricLogger", RecordedLogger):
            run_training(train_step=recording(step, losses_a), model=model, optimizer=opt,
                         train_loader=loader, eval_fn=eval_fn, num_epochs=TRAINER_EPOCHS,
                         multi_step=make_multi_step(recording(step, losses_a), TRAINER_K),
                         unroll_steps=TRAINER_K, ckpt_dir=ckpt_a, save_freq=None,
                         save_freq_min=None, eval_freq=1, store_best=True, seed=5)
        torch.cuda.synchronize()
        run_s = time.time() - t0
        launches = dict(_build.launch_counts)
        n_steps = TRAINER_EPOCHS * TRAINER_BATCHES
        n_eval = TRAINER_EPOCHS * len(eval_loader)
        want = {**{n: 0 for n in _build.KERNELS},
                "short_attention_fwd": VIT_BLOCKS * (n_steps + n_eval),
                "short_attention_bwd": VIT_BLOCKS * n_steps}
        check(launches == want, f"trainer run A: launches {launches}, want {want}")
        check(opt.count == n_steps, f"trainer run A: optimizer count {opt.count}")
        loss_a = torch.stack(losses_a).float().cpu().numpy()
        check(len(loss_a) == n_steps and np.isfinite(loss_a).all(), f"run A losses {loss_a}")
        check(sorted(os.listdir(ckpt_a)) == [CKPT_NAME, BEST_NAME], f"{os.listdir(ckpt_a)}")
        fresh, fresh_opt, _, _ = trainer_model(TRAIN_CLIPS)
        restored = restore_checkpoint(ckpt_a, fresh, fresh_opt)
        check(restored == float(TRAINER_EPOCHS) and fresh_opt.count == n_steps,
              f"run A's checkpoint restored epoch {restored}, count {fresh_opt.count}")
        del fresh, fresh_opt
        results = read_results(os.path.join(tmp, "a", RESULTS_SAVE_DIR))
        logits = results["logits/action"]
        check(logits.shape == (8, NUM_ACTIONS) and np.isfinite(logits).all(),
              f"stored logits {logits.shape}, finite {np.isfinite(logits).all()}")
        check(len(metrics) == TRAINER_EPOCHS and np.isfinite(metrics).all(),
              f"primary metric of each epoch {metrics}")
        final_a = {n: p.detach().clone() for n, p in model.named_parameters()}
        del model, opt, step, eval_step
        clips_s = epoch_loggers[1]["clips/s"]
        save_s = [t for t, _ in saves]
        log(f"trainer run A: {n_steps} steps of {TRAIN_CLIPS} clips in chunks of {TRAINER_K}, "
            f"{len(evals)} evals of {len(eval_loader)} batches of 4 clips (6 views), "
            f"{len(saves)} saves, {run_s:.2f} s; losses "
            + ", ".join(f"{x:.4f}" for x in loss_a) + f"; launches {launches}; "
            f"primary metric {eval_loader.dataset.primary_metric} of each epoch {metrics}")
        log(f"trainer loop, epoch 1: {1e3 * epoch_s[1] / TRAINER_BATCHES:.2f} ms a step (host "
            f"clock around train_one_epoch, {TRAINER_BATCHES} steps, no save inside); the "
            f"loop's clips/s meter {clips_s.global_avg:.2f} (mean of {clips_s.count} chunks, "
            f"median {clips_s.median:.2f}) vs phase 4's bare step "
            f"{split['step_ms']:.2f} ms ({split['clips_s']:.2f} clips/s); checkpoint save "
            f"{np.mean(save_s):.3f} s (min {min(save_s):.3f}, max {max(save_s):.3f}) for "
            f"{saves[0][1] / 1e9:.3f} GB; evaluator {1e3 * np.mean(evals) / len(eval_loader):.1f} "
            f"ms a batch of 4 clips ({len(evals)} evals)")

        # run B: the same run, single steps, crashing when asked for a global batch
        model, opt, step, _ = trainer_model(TRAIN_CLIPS)
        ckpt_b = os.path.join(tmp, "b")
        run_b = dict(model=model, optimizer=opt, train_loader=loader, num_epochs=TRAINER_EPOCHS,
                     ckpt_dir=ckpt_b, save_freq=0.5, save_freq_min=None, seed=5)
        losses_b = []
        loader.crash_at, loader.served = TRAINER_CRASH_AT, 0
        try:
            run_training(train_step=recording(step, losses_b), **run_b)
            check(False, "run B did not crash")
        except RuntimeError as err:
            check("simulated crash" in str(err), f"run B raised {err}")
        del model, opt, step, run_b
        model, opt, step, _ = trainer_model(TRAIN_CLIPS)
        epoch_b = restore_checkpoint(ckpt_b, model, None)
        # the last save before the crash: at the chunk of step crash_at - 1,
        # on its save_freq boundary (every 2 steps)
        want_epoch = (TRAINER_CRASH_AT - 1) // 2 * 2 / TRAINER_BATCHES
        check(epoch_b == want_epoch and epoch_b % 1, f"run B's rolling checkpoint at epoch "
              f"{epoch_b}, want the fractional {want_epoch}")
        resumed = []
        run_training(train_step=recording(step, resumed), model=model, optimizer=opt,
                     train_loader=loader, num_epochs=TRAINER_EPOCHS, ckpt_dir=ckpt_b,
                     save_freq=0.5, save_freq_min=None, seed=5)
        check(opt.count == n_steps, f"resumed run: optimizer count {opt.count}")
        first = int(round(epoch_b * TRAINER_BATCHES))
        loss_b = torch.stack(losses_b[:first] + resumed).float().cpu().numpy()
        rel = np.abs(loss_b - loss_a) / np.abs(loss_a)
        check(len(loss_b) == n_steps and rel.max() <= 1e-3,
              f"run B losses {loss_b} vs run A {loss_a}")
        worst, differ = 0.0, []
        for name, p in model.named_parameters():
            diff = (p.float() - final_a[name].float()).abs().max().item()
            scale = final_a[name].float().abs().max().item()
            if diff:
                differ.append(f"{name} {diff:.3g} of {scale:.3g}")
            worst = max(worst, diff / max(scale, 1e-30))
        check(worst <= 1e-3, f"resumed run's parameters differ from run A's: {differ[:8]}")
        log(f"trainer run B: crashed when asked for global batch {TRAINER_CRASH_AT}, resumed a "
            f"fresh model and optimizer from epoch {epoch_b} (step {first}); losses of steps "
            f"0-{n_steps - 1} vs run A: max {rel.max():.3g} relative (limit 1e-3); final "
            f"parameters vs run A: worst {worst:.3g} of the tensor's max |value| (limit 1e-3); "
            + (f"bits equal: {not differ}" if not differ else
               f"bits differ in {len(differ)} tensors: " + "; ".join(differ[:12])))
        del model, opt, step, final_a
    return launches


def small_train_phase():
    """One train step of a depth-2 ViT with 24 heads of 32: no head pairs, so
    fused_qkv_attention adds the bias itself and calls packed_short_attention,
    whose backward is the kernel's no-db form. Returns the step's launches."""
    dim, dt = 768, torch.bfloat16
    model = AVTModel(
        backbone=ViT(depth=2, num_heads=24, dtype=dt, device="cuda"),
        temporal_aggregator=IdentityAgg(in_features=dim),
        future_predictor=AVTh(in_features=dim, inter_dim=256, n_layer=1, n_head=2, output_len=1,
                              avg_last_n=1, return_past_too=True,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none"),
                              dtype=dt, device="cuda"),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=dim),
        classifiers={"action": LinearClassifier(dim, NUM_ACTIONS, device="cuda")},
        num_classes=(("action", NUM_ACTIONS),), backbone_dim=dim, dropout=0.2,
        classifier_on_past=True)
    init_weights(model, torch.Generator(device="cuda").manual_seed(3))
    _, step, _, batch = train_pipeline(model, 2)
    wrapped = {name: mock.patch.object(fa, name, wraps=getattr(fa, name))
               for name in ("packed_short_attention", "packed_qkv_bias_attention")}
    calls = {name: patch.start() for name, patch in wrapped.items()}
    try:
        _build.reset_launch_counts()
        metrics = step(batch, torch.Generator(device="cuda").manual_seed(4))
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
    finally:
        for patch in wrapped.values():
            patch.stop()
    loss = metrics["loss"].item()
    log(f"24 heads of 32, depth 2, one train step: loss {loss:.4f}; launches {launches}; "
        f"packed_short_attention calls {calls['packed_short_attention'].call_count}, "
        f"packed_qkv_bias_attention calls {calls['packed_qkv_bias_attention'].call_count}")
    check(np.isfinite(loss), f"24-head step: loss {loss}")
    check(launches == {"short_attention_fwd": 2, "short_attention_bwd": 2, **NO_OTHER},
          f"24-head step: launches {launches}, want 2 of each")
    check(calls["packed_short_attention"].call_count == 2
          and calls["packed_qkv_bias_attention"].call_count == 0,
          "24-head step did not go through packed_short_attention")
    grads = [p.grad for n, p in model.named_parameters() if attention_branch(n)]
    check(all(g is not None and torch.isfinite(g).all() for g in grads),
          "24-head step: an attention-branch gradient is missing or non-finite")
    return launches


def train_fused_phase(split):
    """The flagship train step of phase 4 with the ViT's attention op
    swapped for the fused kernel (`fused_qkv_attention(use_kernel=True)`,
    the counterpart of use_pallas=True, which no model turns on): the same
    weights, batch and dropout seed. Each of the 12 blocks runs the fused
    forward and the no-db backward kernel. `split` holds phase 4's step-0
    loss and steady step time. Returns the launch counts of the phase."""
    fused_op = functools.partial(attention.fused_qkv_attention, use_kernel=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_avt(num_actions=NUM_ACTIONS, vit_dtype=torch.bfloat16, generator=gen)
    opt, step, preprocess, batch = train_pipeline(model, TRAIN_CLIPS)
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    step_gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    split_op = vit_module.fused_qkv_attention
    vit_module.fused_qkv_attention = fused_op
    try:
        _build.reset_launch_counts()
        for k in range(2):  # step 0 runs at LR 0, step 1 at the first warmup LR
            metrics = step(batch, step_gen)
            torch.cuda.synchronize()
            launches = dict(_build.launch_counts)
            want = {**{n: 0 for n in _build.KERNELS},
                    "fused_qkv_attention_fwd": VIT_BLOCKS * (k + 1),
                    "short_attention_bwd": VIT_BLOCKS * (k + 1)}
            check(launches == want, f"fused train step {k}: launches {launches}, want {want}")
            values = {key: v.item() for key, v in metrics.items()}
            for key in ("loss", "loss/cls_action", "loss/past_cls_action", "loss/feat"):
                check(np.isfinite(values[key]), f"fused train step {k}: {key} = {values[key]}")
            changed = [n for n, p in params.items() if not torch.equal(p, before[n])]
            log(f"fused train step {k}: " + ", ".join(f"{key} {v:.4f}" for key, v in values.items())
                + f"; {len(changed)} of {len(params)} parameter tensors changed; launches {launches}")
            if k == 0:
                rel = abs(values["loss"] - split["loss0"]) / abs(split["loss0"])
                log(f"fused vs split step 0 loss: {values['loss']:.6f} vs {split['loss0']:.6f}, "
                    f"{rel:.3g} relative (limit 1e-2)")
                check(rel <= 1e-2, f"fused step 0 loss {values['loss']} vs split {split['loss0']}")
                check(not changed, f"fused step 0 at LR 0 changed {changed[:4]}")
            else:
                check(changed, "fused step 1 changed no parameter")
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(TIMED_STEPS):
            metrics = step(batch, step_gen)
        torch.cuda.synchronize()
        step_s = (time.time() - t0) / TIMED_STEPS
        launches = dict(_build.launch_counts)
        steps = 2 + TIMED_STEPS
        check(launches["fused_qkv_attention_fwd"] == VIT_BLOCKS * steps
              and launches["short_attention_bwd"] == VIT_BLOCKS * steps
              and launches["short_attention_fwd"] == 0,
              f"fused timed steps: launches {launches} after {steps} steps")
        check(np.isfinite(metrics["loss"].item()), "non-finite loss in the timed fused steps")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"fused train step, {TRAIN_CLIPS} clips: {step_s * 1e3:.2f} ms a step (mean of "
            f"{TIMED_STEPS} after 2; split path {split['step_ms']:.2f} ms in phase 4), "
            f"{TRAIN_CLIPS / step_s:.2f} clips/s (split {split['clips_s']:.2f}); peak memory "
            f"{peak_gb:.2f} GB")
        busy_ms, _, _ = profile_run(lambda: step(batch, step_gen), "fused train step")
        log(f"device busy {busy_ms:.2f} ms of the steady fused step's {step_s * 1e3:.2f} ms: "
            f"idle share {1 - busy_ms / (step_s * 1e3):.3f}")
        # gradients on one clip of every block's qkv projection and norm1,
        # with the fused op and with the split path
        names = [f"backbone.model.blocks.{i}.{leaf}" for i in range(VIT_BLOCKS)
                 for leaf in ("attn.qkv.weight", "attn.qkv.bias", "norm1.weight", "norm1.bias")]
        one = {"video": batch["video"][:1], "target": {"action": batch["target"]["action"][:1]},
               "target_subclips": {"action": batch["target_subclips"]["action"][:1]}}
        fused_grads = one_clip_grads(model, preprocess, one, names)
    finally:
        vit_module.fused_qkv_attention = split_op
    split_grads = one_clip_grads(model, preprocess, one, names)
    worst = 0.0
    for name, gf, gs in zip(names, fused_grads, split_grads):
        scale = gs.float().abs().max().item()
        diff = (gf.float() - gs.float()).abs().max().item()
        check(scale > 0 and diff <= GRAD_TOL * scale, f"fused grad {name} differs by {diff} "
              f"at scale {scale}")
        worst = max(worst, diff / scale)
    log(f"grads of {len(names)} qkv / norm1 tensors, fused vs split, 1 clip: worst max |diff| "
        f"{worst:.3g} of the tensor's scale (limit {GRAD_TOL})")
    return launches, dict(step_ms=step_s * 1e3, clips_s=TRAIN_CLIPS / step_s)


def ek55_adam_phase():
    """expts/08 at full width on random 1024-d features and weights from a
    seed: Adam (lr 5e-6, wd 1e-4 on every parameter, warmup 5 + cosine over
    15 epochs, world size 1), batch 32, 10 observed features (frame_rate 2,
    tau_o 5), f32. At 10 tokens AVT-h's attention is plain tensor code, as
    in JAX: no kernel runs. Returns the launch counts of the phase."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_avt(num_actions=EK55_ACTIONS, backbone="identity", backbone_dim=FEAT_DIM,
                      inter_dim=AVTH_DIM, n_layer=EK55_LAYERS, n_head=EK55_HEADS, dropout=0.8,
                      classifier_on_past=False, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    opt, _ = build_optimizer(
        model, lr_wd=[["__all__", 5e-6, 1e-4]], optimizer_name="adam", scheduler_name="cosine",
        iters_per_epoch=1000, num_epochs=20, warmup_epochs=5, bias_bn_wd_scale=1.0)
    num_classes = {"action": EK55_ACTIONS}
    step = make_train_step(model, opt, EK55_LOSS_WTS, num_classes)
    rng = np.random.default_rng(3)
    batch = {"video": torch.from_numpy(rng.standard_normal(
                 (EK55_BATCH, SHORT_T, FEAT_DIM, 1, 1, 1), np.float32)).cuda(),
             "target": {"action": torch.from_numpy(
                 rng.integers(0, EK55_ACTIONS, size=EK55_BATCH)).cuda()}}
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    step_gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    for k in range(2):  # step 0 runs at LR 0, step 1 at the first warmup LR
        metrics = step(batch, step_gen)
        torch.cuda.synchronize()
        values = {key: v.item() for key, v in metrics.items()}
        for key in ("loss", "loss/cls_action", "loss/feat"):
            check(np.isfinite(values[key]), f"ek55 adam step {k}: {key} = {values[key]}")
        changed = [n for n, p in params.items() if not torch.equal(p, before[n])]
        log(f"ek55 adam step {k}: lr {opt.groups[0].schedule(k):.3g}, "
            + ", ".join(f"{key} {v:.4f}" for key, v in values.items())
            + f"; {len(changed)} of {len(params)} parameter tensors changed")
        if k == 0:
            check(not changed, f"ek55 adam step 0 at LR 0 changed {changed[:4]}")
        else:
            check(changed, "ek55 adam step 1 changed no parameter")
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(EK55_TIMED_STEPS):
        metrics = step(batch, step_gen)
    torch.cuda.synchronize()
    step_s = (time.time() - t0) / EK55_TIMED_STEPS
    launches = dict(_build.launch_counts)
    check(not any(launches.values()), f"ek55 adam steps launched {launches}")
    check(np.isfinite(metrics["loss"].item()), "non-finite loss in the timed ek55 adam steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    flops = 3 * EK55_BATCH * feature_flops_per_clip(SHORT_T, EK55_LAYERS, EK55_ACTIONS, False)
    log(f"ek55 adam train step, {EK55_BATCH} clips x {SHORT_T} features, {n_params / 1e6:.1f} M "
        f"parameters: {step_s * 1e3:.2f} ms a step (mean of {EK55_TIMED_STEPS} after 2), "
        f"{EK55_BATCH / step_s:.2f} clips/s, {flops / step_s / 1e12:.2f} TFLOP/s "
        f"({flops / 1e12:.3f} TFLOP a step, {flops / step_s / PEAK_FLOPS[torch.float32]:.4f} of "
        f"the f32 peak); peak memory {peak_gb:.2f} GB")
    busy_ms, groups, _ = profile_run(lambda: step(batch, step_gen), "ek55 adam train step")
    log(f"device busy {busy_ms:.2f} ms of the steady step's {step_s * 1e3:.2f} ms: idle share "
        f"{1 - busy_ms / (step_s * 1e3):.3f}; optimizer {groups.get('optimizer', 0.0):.2f} ms, "
        f"{groups.get('optimizer', 0.0) / busy_ms:.3f} of device time")
    return launches


def plain_flash(q, k, v, causal=False):
    """The plain version in place of the flash kernels; autograd
    differentiates it."""
    return fa.flash_attention_reference(q, k, v, causal)[0]


def feature_batch(B, T, seed, dim=FEAT_DIM):
    """expts/02's subclip layout: (B, T, dim, 1, 1, 1) f32 features, one
    1-frame subclip per observed second, with their targets."""
    rng = np.random.default_rng(seed)
    video = torch.from_numpy(rng.standard_normal((B, T, dim, 1, 1, 1), np.float32))
    return {"video": video.cuda(),
            "target": {"action": torch.from_numpy(rng.integers(0, NUM_ACTIONS, size=B)).cuda()},
            "target_subclips": {"action": torch.from_numpy(
                rng.integers(-1, NUM_ACTIONS, size=(B, T, 1))).cuda()}}


def feature_flops_per_clip(T, layers=AVTH_LAYERS, actions=NUM_ACTIONS, past_classifier=True,
                           feat_dim=FEAT_DIM):
    """Forward FLOPs of one clip on the feature path: AVT-h's linears on
    every token (qkv, proj, the 4x MLP), its causal attention, the encoder
    and decoder, the past classifier on every token (when the model has
    one), the classifier once."""
    C = AVTH_DIM
    linears = layers * 12 * C * C + 2 * feat_dim * C + past_classifier * feat_dim * actions
    attention = layers * 4 * C * causal_pairs(T, True)
    return 2 * T * linears + attention + 2 * feat_dim * actions


def avth_attention_param(name):
    """A parameter of AVT-h's attention branch (ln_1, c_attn, c_proj)."""
    return name.startswith("future_predictor.gpt_model.h.") and (
        ".attn." in name or ".ln_1." in name)


def feature_phase():
    """The feature path of expts/02 at full width; returns the launch counts
    of each of its counted runs."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_avt(num_actions=NUM_ACTIONS, backbone="identity", backbone_dim=FEAT_DIM,
                      inter_dim=AVTH_DIM, n_layer=AVTH_LAYERS, n_head=AVTH_HEADS, generator=gen)
    num_classes = {"action": NUM_ACTIONS}
    eval_step = make_eval_step(model, num_classes)
    long_batch, short_batch = feature_batch(FEAT_BATCH, LONG_T, 1), feature_batch(FEAT_BATCH,
                                                                                 SHORT_T, 2)
    counts = {}

    def counted(label, fn):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts[label] = dict(_build.launch_counts)
        return out

    eval_step(long_batch)  # first-call costs, outside the counted run
    torch.cuda.synchronize()
    t0 = time.time()
    res = counted("feature_eval", lambda: eval_step(long_batch))
    eval_ms = (time.time() - t0) * 1e3
    logits = res["logits/action"]
    check(logits.shape == (FEAT_BATCH, NUM_ACTIONS) and bool(torch.isfinite(logits).all()),
          f"feature eval logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    check(all(bool(torch.isfinite(v).all()) for v in res.values()), "non-finite eval result")
    want = {**{n: 0 for n in _build.KERNELS}, "flash_attention_fwd": AVTH_LAYERS}
    check(counts["feature_eval"] == want, f"feature eval launches {counts['feature_eval']}, "
          f"want {want}")
    short = counted("feature_eval_t10", lambda: eval_step(short_batch))
    check(all(bool(torch.isfinite(v).all()) for v in short.values()), "non-finite T=10 result")
    check(not any(counts["feature_eval_t10"].values()),
          f"T={SHORT_T} eval launched {counts['feature_eval_t10']}")
    with mock.patch.object(fa, "flash_attention", plain_flash):
        plain = eval_step(long_batch)["logits/action"]
    scale, diff = plain.abs().max().item(), (logits - plain).abs().max().item()
    log(f"feature eval, {FEAT_BATCH} clips x {LONG_T} features: {eval_ms:.2f} ms "
        f"({FEAT_BATCH / eval_ms * 1e3:.2f} clips/s); loss/cls_action mean "
        f"{res['loss/cls_action'].mean().item():.4f}, aux_loss/feat "
        f"{res['aux_loss/feat'].item():.4f}; launches {counts['feature_eval']}; at T={SHORT_T} "
        f"{counts['feature_eval_t10']}; kernels vs plain logits max |diff| {diff:.3g} of scale "
        f"{scale:.3g}")
    check(diff <= 1e-3 * scale, f"feature eval: kernels vs plain logits differ by {diff}")

    opt, _ = build_optimizer(
        model, lr_wd=[["__all__", 1e-3, 1e-6]], optimizer_name="sgd", scheduler_name="cosine",
        iters_per_epoch=1000, num_epochs=50, warmup_epochs=20, bias_bn_wd_scale=1.0,
        optimizer_kwargs={"nesterov": True})
    step = make_train_step(model, opt, LOSS_WTS, num_classes)
    step_gen = torch.Generator(device="cuda").manual_seed(1)
    params = dict(model.named_parameters())
    branch = [n for n in params if avth_attention_param(n)]
    check(len(branch) == 6 * AVTH_LAYERS, f"AVT-h attention params {len(branch)}")
    before = {n: p.detach().clone() for n, p in params.items()}
    want = {**{n: 0 for n in _build.KERNELS}, "flash_attention_fwd": AVTH_LAYERS,
            "flash_attention_bwd": AVTH_LAYERS}
    torch.cuda.reset_peak_memory_stats()
    for k in range(2):  # step 0 runs at LR 0, step 1 at the first warmup LR
        t0 = time.time()
        metrics = counted("feature_train", lambda: step(long_batch, step_gen))
        first_ms = (time.time() - t0) * 1e3
        check(counts["feature_train"] == want,
              f"feature train step {k}: launches {counts['feature_train']}, want {want}")
        values = {key: v.item() for key, v in metrics.items()}
        for key in ("loss", "loss/cls_action", "loss/past_cls_action", "loss/feat"):
            check(np.isfinite(values[key]), f"feature train step {k}: {key} = {values[key]}")
        bad = [n for n in branch
               if params[n].grad is None or not torch.isfinite(params[n].grad).all()]
        check(not bad, f"feature train step {k}: missing or non-finite gradient for {bad[:4]}")
        changed = [n for n, p in params.items() if not torch.equal(p, before[n])]
        log(f"feature train step {k} ({first_ms:.1f} ms with first-call costs): lr "
            f"{opt.groups[0].schedule(k):.3g}, "
            + ", ".join(f"{key} {v:.4f}" for key, v in values.items())
            + f"; {len(changed)} of {len(params)} parameter tensors changed; launches "
            f"{counts['feature_train']}")
        if k == 0:
            check(not changed, f"step 0 at LR 0 changed {changed[:4]}")
        else:
            check(changed, "feature train step 1 changed no parameter")
    counted("feature_train_t10", lambda: step(short_batch, step_gen))
    check(not any(counts["feature_train_t10"].values()),
          f"T={SHORT_T} train step launched {counts['feature_train_t10']}")

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.time()
    for _ in range(FEAT_TIMED_STEPS):
        metrics = step(long_batch, step_gen)
    torch.cuda.synchronize()
    step_s = (time.time() - t0) / FEAT_TIMED_STEPS
    launches = dict(_build.launch_counts)
    check(launches["flash_attention_fwd"] == AVTH_LAYERS * FEAT_TIMED_STEPS
          and launches["flash_attention_bwd"] == AVTH_LAYERS * FEAT_TIMED_STEPS,
          f"timed feature steps launched {launches}")
    check(np.isfinite(metrics["loss"].item()), "non-finite loss in the timed feature steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    flops = 3 * FEAT_BATCH * feature_flops_per_clip(LONG_T)
    log(f"feature train step, {FEAT_BATCH} clips x {LONG_T} features: {step_s * 1e3:.2f} ms a "
        f"step (mean of {FEAT_TIMED_STEPS} after 2), {FEAT_BATCH / step_s:.2f} clips/s, "
        f"{flops / step_s / 1e12:.2f} TFLOP/s ({flops / 1e12:.2f} TFLOP a step), "
        f"{flops / step_s / PEAK_FLOPS[torch.float32]:.4f} of the f32 peak; peak memory "
        f"{peak_gb:.2f} GB")
    busy_ms, _, _ = profile_run(lambda: step(long_batch, step_gen),
                             f"feature train step, {FEAT_BATCH} clips x {LONG_T} features")
    log(f"device busy {busy_ms:.2f} ms of the steady step's {step_s * 1e3:.2f} ms: "
        f"idle share {1 - busy_ms / (step_s * 1e3):.3f}")

    # gradients on 2 clips, with the kernels and with the plain versions
    two = {"video": long_batch["video"][:2],
           "target": {"action": long_batch["target"]["action"][:2]},
           "target_subclips": {"action": long_batch["target_subclips"]["action"][:2]}}
    names = ["future_predictor.gpt_model.h.0.attn.c_attn.weight",
             "future_predictor.gpt_model.h.5.attn.c_attn.bias",
             "future_predictor.encoder.weight", "classifiers.action.weight"]
    features = lambda video, generator: video  # noqa: E731 (no preprocessing)
    kernel_grads = one_clip_grads(model, features, two, names)
    with mock.patch.object(fa, "flash_attention", plain_flash):
        plain_grads = one_clip_grads(model, features, two, names)
    for name, gk, gp in zip(names, kernel_grads, plain_grads):
        scale = gp.abs().max().item()
        diff = (gk - gp).abs().max().item()
        log(f"grad {name}, kernels vs plain, 2 clips: max |diff| {diff:.3g} of scale "
            f"{scale:.3g} (limit {GRAD_TOL} of the scale)")
        check(scale > 0 and diff <= GRAD_TOL * scale, f"grad {name} differs by {diff}")
    return counts


def feature_d1024_phase():
    """expts/04 at full width (identity backbone, 2048-d features, AVT-h 2048
    wide, 8 layers of 2 heads of 1024, dropout 0.2, past classifier, 3806
    actions, f32, batch 64) at 128 observed features, where every AVT-h
    layer goes through the flash kernels at head dim 1024: one eval step (8
    forward launches), step 0 at LR 0 (parameters unchanged), then 2 timed
    train steps (nesterov SGD lr 1e-3 wd 1e-6, warmup 5 + cosine over 50
    epochs), each 8 forward + 8 backward launches. Returns the launch
    counts of the phase."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_avt(num_actions=NUM_ACTIONS, backbone="identity", backbone_dim=D1024_FEAT,
                      inter_dim=AVTH_DIM, n_layer=D1024_LAYERS, n_head=D1024_HEADS, dropout=0.2,
                      classifier_on_past=True, generator=gen)
    num_classes = {"action": NUM_ACTIONS}
    batch = feature_batch(FEAT_BATCH, D1024_T, 4, dim=D1024_FEAT)
    opt, _ = build_optimizer(
        model, lr_wd=[["__all__", 1e-3, 1e-6]], optimizer_name="sgd", scheduler_name="cosine",
        iters_per_epoch=1000, num_epochs=50, warmup_epochs=5, bias_bn_wd_scale=1.0,
        optimizer_kwargs={"nesterov": True})
    eval_step, step = make_eval_step(model, num_classes), make_train_step(model, opt, LOSS_WTS,
                                                                          num_classes)
    params = dict(model.named_parameters())
    branch = [n for n in params if avth_attention_param(n)]
    check(len(branch) == 6 * D1024_LAYERS, f"AVT-h attention params {len(branch)}")
    before = {n: p.detach().clone() for n, p in params.items()}
    step_gen = torch.Generator(device="cuda").manual_seed(1)
    fwd_only = {**{n: 0 for n in _build.KERNELS}, "flash_attention_fwd": D1024_LAYERS}
    eval_step(batch)  # first-call costs, outside the counted run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.time()
    res = eval_step(batch)
    torch.cuda.synchronize()
    eval_ms = (time.time() - t0) * 1e3
    eval_counts = dict(_build.launch_counts)
    logits = res["logits/action"]
    check(logits.shape == (FEAT_BATCH, NUM_ACTIONS)
          and all(bool(torch.isfinite(x).all()) for x in res.values()),
          f"d1024 eval: logits {tuple(logits.shape)} or a non-finite result")
    check(eval_counts == fwd_only, f"d1024 eval launches {eval_counts}, want {fwd_only}")
    metrics = step(batch, step_gen)  # step 0, LR 0
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    want = {**fwd_only, "flash_attention_fwd": 2 * D1024_LAYERS,
            "flash_attention_bwd": D1024_LAYERS}
    check(counts == want, f"d1024 train step 0 launches {counts}, want {want}")
    check(np.isfinite(metrics["loss"].item()), f"d1024 step 0 loss {metrics['loss'].item()}")
    bad = [n for n in branch if params[n].grad is None or not torch.isfinite(params[n].grad).all()]
    check(not bad, f"d1024 step 0: missing or non-finite gradient for {bad[:4]}")
    changed = [n for n, p in params.items() if not torch.equal(p, before[n])]
    check(not changed, f"d1024 step 0 at LR 0 changed {changed[:4]}")
    loss0 = metrics["loss"].item()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(D1024_TIMED_STEPS):
        metrics = step(batch, step_gen)
    torch.cuda.synchronize()
    step_s = (time.time() - t0) / D1024_TIMED_STEPS
    counts = dict(_build.launch_counts)
    steps = 1 + D1024_TIMED_STEPS
    want = {**fwd_only, "flash_attention_fwd": (1 + steps) * D1024_LAYERS,
            "flash_attention_bwd": steps * D1024_LAYERS}
    check(counts == want, f"d1024 launches {counts} after {steps} steps, want {want}")
    check(np.isfinite(metrics["loss"].item()), "non-finite loss in the timed d1024 steps")
    bad = [n for n in branch if not torch.isfinite(params[n].grad).all()]
    check(not bad, f"d1024 timed steps: non-finite gradient for {bad[:4]}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    flops = 3 * FEAT_BATCH * feature_flops_per_clip(D1024_T, D1024_LAYERS, feat_dim=D1024_FEAT)
    log(f"feature_d1024 (expts/04, 2 heads of 1024), {FEAT_BATCH} clips x {D1024_T} features: "
        f"eval {eval_ms:.2f} ms; step 0 loss {loss0:.4f}, parameters unchanged at LR 0; train "
        f"{step_s * 1e3:.2f} ms a step (mean of {D1024_TIMED_STEPS} after 1), "
        f"{FEAT_BATCH / step_s:.2f} clips/s, {flops / step_s / 1e12:.2f} TFLOP/s "
        f"({flops / 1e12:.2f} TFLOP a step); loss {metrics['loss'].item():.4f}; peak memory "
        f"{peak_gb:.2f} GB; launches {counts}")
    return counts


# ---------------------------------------------------------------- train_net
EK100_VERBS, EK100_NOUNS = 97, 300
FEATURE_FPS = 30  # RULSTM stores one TSN feature per frame at 30 fps
EXPT_02 = "expts/02_ek100_avt_tsn.txt"


def write_ek100_tree(root, *, train_videos, eval_videos, actions_per_video, first_action_s,
                     dim=FEAT_DIM, seed=0, video=None, read_type="normal", tail_s=2):
    """A synthetic EK100 tree under `root`, written with numpy and csv only:
    EPIC_100_{verb,noun}_classes.csv (97 verbs, 300 nouns), RULSTM's
    actions.csv (3806 actions, action a = (verb a % 97, noun a // 97)), the
    RULSTM annotations training.csv and validation.csv (uid, video_id,
    start_frame, end_frame, verb, noun, action at 30 fps, no header; one
    action a second from `first_action_s` on, `actions_per_video` a video,
    train and eval on their own videos), and a per-video .npy store of
    `dim`-d f32 features at 30 fps (row i = frame i + 1) reaching `tail_s`
    past the last action. Returns the overrides that point expts/02 at it (the
    npy reader taking `read_type`: expts/02's 'normal', expts/05's
    'exact_rulstm').

    With video=(width, height, fps), raw videos take the store's place:
    `videos/<participant>/<video>.MP4` (mp4v, `write_video`), as long, and
    the overrides point a raw-video file (expts/01) at them, read by the
    `DefaultReader` the file composes."""
    rng = np.random.default_rng(seed)
    annot = os.path.join(root, "annotations", "epic-kitchens-100")
    rulstm = os.path.join(root, "annotations", "rulstm", "ek100")
    feats = os.path.join(root, "features")
    videos = os.path.join(root, "videos")
    for d in (annot, rulstm, os.path.join(feats, "rgb") if video is None else videos):
        os.makedirs(d, exist_ok=True)
    for name, n in (("verb", EK100_VERBS), ("noun", EK100_NOUNS)):
        with open(os.path.join(annot, f"EPIC_100_{name}_classes.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "key"])
            w.writerows([i, f"{name}{i}"] for i in range(n))
    with open(os.path.join(rulstm, "actions.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "verb", "noun", "action"])
        w.writerows([a, a % EK100_VERBS, a // EK100_VERBS,
                     f"verb{a % EK100_VERBS}_noun{a // EK100_VERBS}"]
                    for a in range(NUM_ACTIONS))
    seconds = first_action_s + actions_per_video + tail_s
    uid = 0
    jobs = []  # the videos, written in parallel below (OpenCV encodes without the GIL)
    for split, participant, n_videos in (("training", 1, train_videos),
                                         ("validation", 2, eval_videos)):
        rows = []
        for v in range(n_videos):
            name = f"P{participant:02d}_{v + 1:02d}"
            if video is None:
                np.save(os.path.join(feats, "rgb", f"{name}.npy"),
                        rng.standard_normal((seconds * FEATURE_FPS, dim), np.float32))
            else:
                jobs.append((os.path.join(videos, f"P{participant:02d}", f"{name}.MP4"),
                             int(rng.integers(2 ** 31))))
            for k in range(actions_per_video):
                start = (first_action_s + k) * FEATURE_FPS
                action = int(rng.integers(NUM_ACTIONS))
                rows.append([uid, name, start, start + FEATURE_FPS // 2, action % EK100_VERBS,
                             action // EK100_VERBS, action])
                uid += 1
        with open(os.path.join(rulstm, f"{split}.csv"), "w", newline="") as f:
            csv.writer(f).writerows(rows)
    if jobs:
        with ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 1)) as pool:
            for done in [pool.submit(write_video, path, *video, seconds=seconds, seed=seed)
                         for path, seed in jobs]:
                done.result()
    common = "dataset.epic_kitchens100.common"
    paths = [f"{common}.annot_dir={annot}/", f"{common}.rulstm_annot_dir={rulstm}/",
             f"dataset_train.annotation_path=[{rulstm}/training.csv]",
             f"dataset_eval.annotation_path=[{rulstm}/validation.csv]"]
    if video is not None:
        return paths + [f"{common}.data_dir_extension={videos}"]
    reader = ("{_target_: avt_tpu.data.NpyFeatsReader, root: "
              f"${{{common}.rulstm_feats_dir}}/rgb/, read_type: {read_type}}}")
    return paths + [f"{common}.rulstm_feats_dir={feats}/",
                    "~dataset_train.reader_fn", "~dataset_eval.reader_fn",
                    f"+dataset_train.reader_fn={reader}", f"+dataset_eval.reader_fn={reader}"]


def write_video(path, width, height, fps, *, seconds, seed):
    """An mp4v video of `seconds` at `fps`: a smooth seeded colour field
    that drifts a pixel a frame, with a block that moves across it."""
    import cv2  # only the raw-video tree needs OpenCV

    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    slopes = rng.uniform(0.2, 1.0, size=(3, 2)).astype(np.float32)
    field = np.stack([a * x + b * y for a, b in slopes], -1)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
    try:
        for i in range(int(seconds * fps)):
            frame = ((field + i * slopes[:, 0]) % 256).astype(np.uint8)
            c = (4 * i) % max(width - 32, 1)
            frame[height // 2 - 16:height // 2 + 16, c:c + 32] = 255 - 3 * (i % 80)
            writer.write(frame)
    finally:
        writer.release()


def write_timm_vit(path, *, embed_dim=768, depth=12, img_size=224, patch=16,
                   num_classes=21843, seed=0):
    """A seeded ViT state_dict in timm's layout, as timm's in21k files
    (jx_vit_base_patch16_224_in21k) hold it: the blocks, the final norm, the
    21843-class `head` and `pre_logits.fc`; N(0, 0.02) weights, LayerNorm
    weights about 1. Returns the state_dict."""
    rng = np.random.default_rng(seed)
    D, mlp, tokens = embed_dim, 4 * embed_dim, (img_size // patch) ** 2 + 1

    def w(*shape, mean=0.0):
        return torch.from_numpy(mean + 0.02 * rng.standard_normal(shape, np.float32))

    sd = {"cls_token": w(1, 1, D), "pos_embed": w(1, tokens, D),
          "patch_embed.proj.weight": w(D, 3, patch, patch), "patch_embed.proj.bias": w(D)}
    for i in range(depth):
        b = f"blocks.{i}"
        sd.update({f"{b}.norm1.weight": w(D, mean=1.0), f"{b}.norm1.bias": w(D),
                   f"{b}.attn.qkv.weight": w(3 * D, D), f"{b}.attn.qkv.bias": w(3 * D),
                   f"{b}.attn.proj.weight": w(D, D), f"{b}.attn.proj.bias": w(D),
                   f"{b}.norm2.weight": w(D, mean=1.0), f"{b}.norm2.bias": w(D),
                   f"{b}.mlp.fc1.weight": w(mlp, D), f"{b}.mlp.fc1.bias": w(mlp),
                   f"{b}.mlp.fc2.weight": w(D, mlp), f"{b}.mlp.fc2.bias": w(D)})
    sd.update({"norm.weight": w(D, mean=1.0), "norm.bias": w(D),
               "pre_logits.fc.weight": w(D, D), "pre_logits.fc.bias": w(D),
               "head.weight": w(num_classes, D), "head.bias": w(num_classes)})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)
    return sd



# the train_net phase: 9 train videos and 4 eval videos of 32 actions a
# second from 258 s on (256 observed seconds fit before each), so 288 train
# rows (4 batches of 64, the rest dropped) and 128 eval rows (2 batches)
TN_TRAIN_VIDEOS, TN_EVAL_VIDEOS, TN_ACTIONS, TN_FIRST_S = 9, 4, 32, LONG_T + 2
TN_BATCH, TN_WORKERS = 64, 8
TN_STEPS = TN_TRAIN_VIDEOS * TN_ACTIONS // TN_BATCH
TN_EVAL_BATCHES = -(-TN_EVAL_VIDEOS * TN_ACTIONS // TN_BATCH)


def long_context(T):
    """The overrides that give expts/02 T observed features: T frames at its
    1 fps over a window of T seconds."""
    return [f"data_train.num_frames={T}", f"data_eval.num_frames={T}",
            f"dataset_train.conv_to_anticipate_fn.tau_o={T}",
            f"dataset_eval.conv_to_anticipate_fn.tau_o={T}"]


class Crash(Exception):
    """A simulated crash of a train_net run (run_train_net's crash_epoch)."""


def run_train_net(argv, crash_epoch=None):
    """`train_net.cli(argv)` with its loaders, loop meters, evaluator and
    final metrics recorded, and the kernel launch counts set to 0 just
    before and read just after; with `crash_epoch`, the run raises Crash
    when its loop starts that epoch. Returns (the cli's metrics, a dict of
    what was recorded)."""
    from avt_tpu_torch import train_net

    return record_train_net(lambda: train_net.cli(argv), crash_epoch)


def record_train_net(call, crash_epoch=None):
    """call() (a run of `train_net.main`, through the cli or a tool) recorded
    as `run_train_net` records it. Returns (call's result, the record)."""
    from avt_tpu_torch import train_net
    from avt_tpu_torch.evaluate import evaluator as evaluator_module

    rec = {"waits": {"train": [], "eval": []}, "rows": {}, "loggers": [], "epochs": [],
           "eval_s": [], "finals": []}

    class TimedLoader(train_net.DataLoader):
        """The loader, timing how long each batch keeps the caller waiting."""

        def __iter__(self):
            kind = "train" if self.drop_last else "eval"
            rec["rows"][kind] = len(self.dataset)
            it = super().__iter__()
            while True:
                t0 = time.time()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                rec["waits"][kind].append(time.time() - t0)
                yield batch

    class RecordedLogger(MetricLogger):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            rec["loggers"].append(self)

    def timed_evaluate(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.time()
        metric = evaluate(*args, **kwargs)
        rec["eval_s"].append(time.time() - t0)
        return metric

    def counted_epoch(*args, **kwargs):
        if kwargs["epoch"] == crash_epoch:
            raise Crash(f"crashed at the start of epoch {crash_epoch}")
        rec["epochs"].append(kwargs["epoch"])
        return train_one_epoch(*args, **kwargs)

    final_accuracies = evaluator_module.final_accuracies_from_results

    def recorded_finals(*args, **kwargs):
        rec["finals"].append(final_accuracies(*args, **kwargs))
        return rec["finals"][-1]

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.time()
    with mock.patch.object(train_net, "DataLoader", TimedLoader), \
            mock.patch.object(train_net, "evaluate", timed_evaluate), \
            mock.patch.object(loop_module, "MetricLogger", RecordedLogger), \
            mock.patch.object(loop_module, "train_one_epoch", counted_epoch), \
            mock.patch.object(evaluator_module, "final_accuracies_from_results",
                              recorded_finals):
        metrics = call()
    torch.cuda.synchronize()
    rec["wall_s"] = time.time() - t0
    rec["launches"] = dict(_build.launch_counts)
    return metrics, rec


def train_net_phase(card):
    """expts/02 from its experiment file through `train_net.cli`, on a
    synthetic EK100 tree (`write_ek100_tree`: 1024-d features, 97 verbs,
    300 nouns, 3806 actions) read by the npy reader: the model (6 layers, 4
    heads, inter_dim 2048, dropout 0.2), the batch of 64, the optimizer and
    the losses as the file sets them; one epoch of 4 batches, then the
    eval of 2. (a) As shipped, 10 observed features: no kernel launches.
    (b) 256 observed features: 6 flash forward + 6 flash backward launches
    a train step and 6 forward launches an eval forward, nothing else;
    finite losses, final_acc/action/AR5 among the final metrics, a
    checkpoint at epoch 1; then a second cli call on the same run
    directory resumes from it, trains nothing and evaluates once. Prints
    rows, steps, the loop's ms a step, the host's data ms a batch (the
    time a batch keeps the loop waiting), the eval's ms a batch and the
    launches. Returns the launch counts of each run."""
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        tree = write_ek100_tree(os.path.join(tmp, "tree"), train_videos=TN_TRAIN_VIDEOS,
                                eval_videos=TN_EVAL_VIDEOS, actions_per_video=TN_ACTIONS,
                                first_action_s=TN_FIRST_S, seed=21)
        log(f"train_net: synthetic EK100 tree ({TN_TRAIN_VIDEOS} + {TN_EVAL_VIDEOS} videos of "
            f"{TN_FIRST_S + TN_ACTIONS + 2} s, {FEAT_DIM}-d f32 features at {FEATURE_FPS} fps) "
            f"written in {time.time() - t0:.1f} s")
        common = tree + [f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}",
                         "train.num_epochs=1"]
        for label, T in (("train_net_t10", SHORT_T), ("train_net", LONG_T)):
            run_dir = os.path.join(tmp, label)
            argv = ["--config-file", EXPT_02, "--run-dir", run_dir] + common + (
                long_context(T) if T != SHORT_T else [])
            (metric,), rec = run_train_net(argv)
            counts[label] = rec["launches"]
            layers = AVTH_LAYERS if T >= 128 else 0
            want = {**{n: 0 for n in _build.KERNELS},
                    "flash_attention_fwd": layers * (TN_STEPS + TN_EVAL_BATCHES),
                    "flash_attention_bwd": layers * TN_STEPS}
            check(rec["launches"] == want, f"{label}: launches {rec['launches']}, want {want}")
            check(rec["epochs"] == [0] and len(rec["waits"]["train"]) == TN_STEPS + 1
                  and len(rec["waits"]["eval"]) == TN_EVAL_BATCHES,
                  f"{label}: epochs {rec['epochs']}, batches {rec['waits']}")
            meters = rec["loggers"][0].meters
            losses = {k: m.global_avg for k, m in meters.items() if k.startswith("loss")}
            check(meters["loss"].count == TN_STEPS and all(np.isfinite(list(losses.values()))),
                  f"{label}: losses {losses} over {meters['loss'].count} steps")
            finals = rec["finals"]
            check(len(finals) == 1 and "final_acc/action/AR5" in finals[0]
                  and np.isfinite(finals[0]["final_acc/action/AR5"])
                  and metric == finals[0]["final_acc/action/AR5"],
                  f"{label}: final metrics {finals}, returned {metric}")
            ckpt = torch.load(os.path.join(run_dir, CKPT_NAME), map_location="cpu",
                              weights_only=False)
            check(ckpt["epoch"] == 1.0, f"{label}: checkpoint at epoch {ckpt['epoch']}")
            del ckpt
            train_wait, eval_wait = rec["waits"]["train"], rec["waits"]["eval"]
            clips_s = meters["clips/s"]
            loop_ms = TN_BATCH / clips_s.median * 1e3
            log(f"train_net {label} ({card}): expts/02 at {T} observed features, rows train "
                f"{rec['rows']['train']} / eval {rec['rows']['eval']}, {TN_STEPS} steps of "
                f"{TN_BATCH} clips (unroll_steps 32: one chunk), {len(eval_wait)} eval batches; "
                f"the loop {loop_ms:.2f} ms a step (its clips/s meter, median "
                f"{clips_s.median:.2f}, the chunk's batches and steps); host data "
                f"{1e3 * np.median(train_wait):.2f} ms a train batch (median of "
                f"{len(train_wait)}, max {1e3 * max(train_wait):.2f}), "
                f"{1e3 * np.median(eval_wait):.2f} ms an eval batch; eval "
                f"{1e3 * rec['eval_s'][0] / len(eval_wait):.2f} ms a batch (evaluate, result "
                f"files included); losses "
                + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
                + f"; final_acc/action/AR5 {metric:.4f}; cli {rec['wall_s']:.1f} s; launches "
                f"{rec['launches']}")
            if T == LONG_T:
                (again,), rec2 = run_train_net(argv)
                counts["train_net_resume"] = rec2["launches"]
                want = {**{n: 0 for n in _build.KERNELS},
                        "flash_attention_fwd": AVTH_LAYERS * TN_EVAL_BATCHES}
                check(rec2["launches"] == want and not rec2["epochs"]
                      and not rec2["waits"]["train"][1:] and len(rec2["finals"]) == 1,
                      f"resumed train_net: launches {rec2['launches']}, epochs "
                      f"{rec2['epochs']}, finals {len(rec2['finals'])}")
                check(np.isfinite(again), f"resumed train_net: metric {again}")
                log(f"train_net resumed ({card}): restored epoch 1.0, trained nothing, "
                    f"evaluated once ({1e3 * rec2['eval_s'][0] / TN_EVAL_BATCHES:.2f} ms a "
                    f"batch); final_acc/action/AR5 {again:.4f} (first run {metric:.4f}); cli "
                    f"{rec2['wall_s']:.1f} s; launches {rec2['launches']}")
    return counts


# ---------------------------------------------------------- train_net_raw
# expts/01 from its file: 4 train videos and 2 eval videos of 3 actions a
# second from 11 s on (tau_o 10 s before tau_a 1 s fits), so 12 train rows
# (4 batches of the file's 3) and 6 eval rows (2 batches)
EXPT_01 = "expts/01_ek100_avt.txt"
TIMM_IN21K = "DATA/pretrained/TIMM/jx_vit_base_patch16_224_in21k-e5005f0a.pth"
TNR_TRAIN_VIDEOS, TNR_EVAL_VIDEOS, TNR_ACTIONS, TNR_FIRST_S = 4, 2, 3, 11
TNR_BATCH, TNR_FRAMES = 3, 10  # the file's batch and observed frames (10 s at 1 fps)
TNR_VIDEO = (456, 256, 30)  # EK100's videos_extension_ht256px: 256 px high, 30 fps
TNR_STEPS = TNR_TRAIN_VIDEOS * TNR_ACTIONS // TNR_BATCH
TNR_EVAL_BATCHES = -(-TNR_EVAL_VIDEOS * TNR_ACTIONS // TNR_BATCH)


def profile_expt01_step(step, batch, parent):
    """One expts/01 train step (the step `train_net` built, on a batch its
    loader gave) profiled with this checkout's packed kernels and, when
    `parent` is given, with those built from `parent`: wall and device busy
    ms, the idle share, the kernel groups and the packed f32 kernels' share
    of device time. Returns {label: {...}}."""
    gen = torch.Generator(device="cuda")
    launch, launch_bwd = fa._launch, fa._launch_bwd
    out = {}
    for label, csrc in (("change", _build.CSRC), ("parent", parent)):
        if csrc is None:
            continue
        with mock.patch.object(fa, "_launch", functools.partial(launch, csrc=csrc)), \
                mock.patch.object(fa, "_launch_bwd", functools.partial(launch_bwd, csrc=csrc)):
            gen.manual_seed(26)
            busy, groups, wall = profile_run(lambda: step(batch, gen),
                                             f"expts/01 train step, {label}'s packed kernels")
        packed = groups.get("attention kernel", 0.0) + groups.get("attention bwd kernel", 0.0)
        out[label] = dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                          packed_ms=packed, packed_share=packed / busy, groups=groups)
        log(f"expts/01 train step, {label}'s packed kernels: wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms (idle {100 * (1 - busy / wall):.1f}%), packed f32 attention "
            f"{packed:.2f} ms ({100 * packed / busy:.1f}% of device time)")
    return out


def train_net_raw_phase(card, parent=None):
    """expts/01 from its experiment file through `train_net.cli` at full
    width (ViT-B/16 in f32, AVT-h of 6 layers, 4 heads, inter_dim 2048, 10
    frames at 1 fps, batch 3, 3 crops + flips at eval), on a synthetic EK100
    tree of raw videos (`write_ek100_tree` with mp4v videos of 456x256 at 30
    fps, 16 s each) read by the file's `DefaultReader`, and a seeded timm
    in21k ViT-B/16 file (with its 21843-class head and pre_logits) at the
    path the file's `train.init_from_model` names under ${cwd}; run in a
    scratch directory, cut to 1 epoch of 4 train batches and 2 eval
    batches, then a second call that resumes and only evaluates. Checks:
    the backbone's leaves equal the file's bit for bit before step 1,
    `head` and `pre_logits` were not loaded, every loss is finite, the
    primary metric is finite, 12 packed forward + 12 packed backward (with
    db, f32) launches a step and 12 forward an eval batch, nothing else.
    Prints the reader that ran, the loop's ms a step, the host's decode
    wait a train batch and eval's ms a batch beside the card's name and
    power limit. Then profiles one train step of the model the first call
    built, on its first batch (`profile_expt01_step`, with the kernels of
    `parent` too when given). Returns the launch counts of each call and
    the profile."""
    from avt_tpu_torch import train_net
    from avt_tpu_torch.data import video_decoder
    from avt_tpu_torch.models import import_torch

    counts, inits, readers, steps = {}, [], set(), []
    real_init, real_build = import_torch.init_from_model, train_net.build_all_datasets
    real_make_step = train_net.make_train_step

    def recorded_make_step(*args, **kwargs):
        """The real train step, keeping it and its first batch."""
        step = real_make_step(*args, **kwargs)

        def recording(batch, generator=None):
            if not steps:
                steps.append((step, batch))
            return step(batch, generator)

        return recording

    def recorded_init(model, specs):
        """The real init, then the backbone held against the file."""
        loaded = real_init(model, specs)
        sd = model.state_dict()
        vit = import_torch.load_torch_state_dict(specs[-1][-1])
        kept = import_torch.timm_vit_leaves(vit)
        inits.append({
            "equal": all(torch.equal(sd["backbone.model." + k].cpu(), v)
                         for k, v in kept.items()),
            "loaded": sorted(loaded),
            "want": sorted("backbone.model." + k for k in kept),
            "skipped": sorted(k for k in vit if k not in kept)})
        return loaded

    def recorded_build(cfg):
        train, evals = real_build(cfg)
        readers.update(type(d.reader).__name__ for d in train + list(evals.values()))
        return train, evals

    expt = os.path.join(os.path.dirname(os.path.abspath(__file__)), EXPT_01)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # ${cwd} of the file's timm path
        try:
            t0 = time.time()
            tree = write_ek100_tree(os.path.join(tmp, "tree"), train_videos=TNR_TRAIN_VIDEOS,
                                    eval_videos=TNR_EVAL_VIDEOS, actions_per_video=TNR_ACTIONS,
                                    first_action_s=TNR_FIRST_S, seed=22, video=TNR_VIDEO)
            t_tree = time.time() - t0
            t0 = time.time()
            timm = write_timm_vit(os.path.join(tmp, TIMM_IN21K), seed=23)
            log(f"train_net_raw: synthetic EK100 tree ({TNR_TRAIN_VIDEOS} + {TNR_EVAL_VIDEOS} "
                f"mp4v videos of {TNR_VIDEO[0]}x{TNR_VIDEO[1]} at {TNR_VIDEO[2]} fps, "
                f"{TNR_FIRST_S + TNR_ACTIONS + 2} s) written in {t_tree:.1f} s; timm in21k "
                f"file ({sum(v.numel() for v in timm.values()) / 1e6:.1f} M values) in "
                f"{time.time() - t0:.1f} s")
            del timm
            run_dir = os.path.join(tmp, "run")
            argv = ["--config-file", expt, "--run-dir", run_dir] + tree + [
                f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}",
                "train.num_epochs=1"]
            with mock.patch.object(train_net, "init_from_model", recorded_init), \
                    mock.patch.object(train_net, "build_all_datasets", recorded_build), \
                    mock.patch.object(train_net, "make_train_step", recorded_make_step):
                (metric,), rec = run_train_net(argv)
                counts["train_net_raw"] = rec["launches"]
                profile = profile_expt01_step(*steps[0], parent)
                del steps[:]
                (again,), rec2 = run_train_net(argv)
                counts["train_net_raw_resume"] = rec2["launches"]
            ckpt_epoch = torch.load(os.path.join(run_dir, CKPT_NAME), map_location="cpu",
                                    weights_only=False)["epoch"]
        finally:
            os.chdir(cwd)
    reader_note = ""
    if readers != {"LibavVideoReader"}:
        reader_note = f" (the native decoder: {video_decoder.native_decoder_error()})"
    log(f"train_net_raw: video reader {sorted(readers)}{reader_note}")

    first = inits[0]
    check(len(inits) == 2 and all(i["equal"] for i in inits),
          f"train_net_raw: the backbone differs from the timm file after init: {inits}")
    check(first["loaded"] == first["want"] and first["skipped"] == [
        "head.bias", "head.weight", "pre_logits.fc.bias", "pre_logits.fc.weight"],
        f"train_net_raw: loaded {len(first['loaded'])} of {len(first['want'])}, skipped "
        f"{first['skipped']}")
    L = VIT_BLOCKS
    want = {**{n: 0 for n in _build.KERNELS},
            "short_attention_fwd": L * (TNR_STEPS + TNR_EVAL_BATCHES),
            "short_attention_bwd": L * TNR_STEPS}
    check(rec["launches"] == want, f"train_net_raw: launches {rec['launches']}, want {want}")
    check(rec["epochs"] == [0] and len(rec["waits"]["train"]) == TNR_STEPS + 1
          and len(rec["waits"]["eval"]) == TNR_EVAL_BATCHES,
          f"train_net_raw: epochs {rec['epochs']}, batches {rec['waits']}")
    meters = rec["loggers"][0].meters
    losses = {k: m.global_avg for k, m in meters.items() if k.startswith("loss")}
    check(meters["loss"].count == TNR_STEPS and all(np.isfinite(list(losses.values()))),
          f"train_net_raw: losses {losses} over {meters['loss'].count} steps")
    finals = rec["finals"]
    check(len(finals) == 1 and np.isfinite(finals[0]["final_acc/action/AR5"])
          and metric == finals[0]["final_acc/action/AR5"],
          f"train_net_raw: final metrics {finals}, returned {metric}")
    check(ckpt_epoch == 1.0, f"train_net_raw: checkpoint at epoch {ckpt_epoch}")
    want2 = {**{n: 0 for n in _build.KERNELS},
             "short_attention_fwd": L * TNR_EVAL_BATCHES}
    check(rec2["launches"] == want2 and not rec2["epochs"] and not rec2["waits"]["train"][1:]
          and len(rec2["finals"]) == 1 and np.isfinite(again),
          f"resumed train_net_raw: launches {rec2['launches']}, epochs {rec2['epochs']}, "
          f"finals {rec2['finals']}, metric {again}")
    train_wait, eval_wait = rec["waits"]["train"], rec["waits"]["eval"]
    clips_s = meters["clips/s"]
    log(f"train_net_raw ({card}): expts/01 at full width (ViT-B/16 f32, AVT-h 6x4 heads, "
        f"2048 wide), rows train {rec['rows']['train']} / eval {rec['rows']['eval']}, "
        f"{TNR_STEPS} steps of {TNR_BATCH} clips x {TNR_FRAMES} frames "
        f"({TNR_BATCH * TNR_FRAMES} ViT frames), {len(eval_wait)} eval batches of {TNR_BATCH} clips x 6 views; the loop "
        f"{TNR_BATCH / clips_s.median * 1e3:.2f} ms a step (its clips/s meter, median "
        f"{clips_s.median:.4f}); host decode wait {1e3 * np.median(train_wait):.2f} ms a train "
        f"batch (median of {len(train_wait)}, max {1e3 * max(train_wait):.2f}), "
        f"{1e3 * np.median(eval_wait):.2f} ms an eval batch; eval "
        f"{1e3 * rec['eval_s'][0] / len(eval_wait):.2f} ms a batch (evaluate, result files "
        f"included); losses " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
        + f"; final_acc/action/AR5 {metric:.4f}; cli {rec['wall_s']:.1f} s; launches "
        f"{rec['launches']}; init loaded {len(first['loaded'])} tensors, skipped "
        f"{first['skipped']}")
    log(f"train_net_raw resumed ({card}): restored epoch 1.0, trained nothing, evaluated once "
        f"({1e3 * rec2['eval_s'][0] / TNR_EVAL_BATCHES:.2f} ms a batch); final_acc/action/AR5 "
        f"{again:.4f} (first run {metric:.4f}); cli {rec2['wall_s']:.1f} s; launches "
        f"{rec2['launches']}")
    return counts, profile

# ------------------------------------------------------------ rulstm_expt05
EXPT_05 = "expts/05_ek100_rustm_test_testonly.txt"
RULSTM_HIDDEN = 1024  # the released RULSTM's width (RULSTMAgg's default)
RULSTM_BATCH = 128  # expts/05's eval batch


def write_rulstm(path, *, feat_dim=FEAT_DIM, hidden=RULSTM_HIDDEN, num_actions=NUM_ACTIONS,
                 seed=0):
    """A seeded checkpoint in the original RULSTM layout (fpv-iplab/rulstm,
    the file expts/05 names): `rolling_lstm.lstm.*` and
    `unrolling_lstm.lstm.*` (torch nn.LSTM layers inside OpenLSTM, gates
    [i|f|g|o], U(-1/sqrt(H), 1/sqrt(H)) as nn.LSTM draws them) and the
    `classifier.1.{weight,bias}` Linear (num_actions, hidden), saved as its
    .pth.tar holds them: {'state_dict': ..., 'epoch': ..., 'best_perf': ...}.
    Returns the state_dict."""
    rng = np.random.default_rng(seed)
    k = hidden ** -0.5

    def u(*shape):
        return torch.from_numpy(rng.uniform(-k, k, size=shape).astype(np.float32))

    sd = {}
    for lstm in ("rolling_lstm", "unrolling_lstm"):
        sd.update({f"{lstm}.lstm.weight_ih_l0": u(4 * hidden, feat_dim),
                   f"{lstm}.lstm.weight_hh_l0": u(4 * hidden, hidden),
                   f"{lstm}.lstm.bias_ih_l0": u(4 * hidden),
                   f"{lstm}.lstm.bias_hh_l0": u(4 * hidden)})
    sd.update({"classifier.1.weight": u(num_actions, hidden), "classifier.1.bias": u(num_actions)})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state_dict": sd, "epoch": 9, "best_perf": 0.0}, path)
    return sd


def rulstm_expt05_phase(card):
    """expts/05 from its experiment file through `train_net.cli`, as
    shipped (test only, eval batch 128, 11 features at 30 fps read the
    RULSTM way, `num_pad_feats=3`, the RULSTM aggregator 1024 wide, 3806
    actions), on the `train_net` phase's synthetic EK100 tree read by the npy
    reader with read_type=exact_rulstm, and a seeded RULSTM checkpoint
    (`write_rulstm`) where its `train.init_from_model` spec points. Checks:
    after `init_from_model` the aggregator's LSTM tensors and the action
    classifier equal the file's bit for bit; no kernel launches; one eval,
    finite metrics. Prints them, the cli's wall s, the host's data wait an
    eval batch, `evaluate`'s ms a batch, and a profile of one eval step of
    the model the cli built on its first batch. Returns the launch counts."""
    from avt_tpu_torch import train_net
    from avt_tpu_torch.models import import_torch

    inits, evals = [], []
    real_init = import_torch.init_from_model
    real_make_eval = train_net.make_eval_step

    def recorded_make_eval(*args, **kwargs):
        """The real eval step, keeping it and its first batch."""
        eval_step = real_make_eval(*args, **kwargs)

        def recording(batch):
            if not evals:
                evals.append((eval_step, batch))
            return eval_step(batch)

        return recording

    def recorded_init(model, specs):
        """The real init, then the model held against the file."""
        loaded = real_init(model, specs)
        sd = model.state_dict()
        ckpt = import_torch.load_torch_state_dict(specs[0][-1])
        want = {f"temporal_aggregator.{k.replace('.lstm.', '.')}": v
                for k, v in ckpt.items() if "lstm" in k}
        want.update({f"classifiers.action.{k}": ckpt[f"classifier.1.{k}"]
                     for k in ("weight", "bias")})
        inits.append({"equal": all(torch.equal(sd[k].cpu(), v) for k, v in want.items()),
                      "loaded": sorted(loaded), "want": sorted(want)})
        return loaded

    expt = os.path.join(os.path.dirname(os.path.abspath(__file__)), EXPT_05)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        tree = write_ek100_tree(os.path.join(tmp, "tree"), train_videos=TN_TRAIN_VIDEOS,
                                eval_videos=TN_EVAL_VIDEOS, actions_per_video=TN_ACTIONS,
                                first_action_s=TN_FIRST_S, seed=24, read_type="exact_rulstm")
        ckpt = os.path.join(tmp, "RULSTM-anticipation_0.25_6_8_rgb_mt5r_best.pth.tar")
        write_rulstm(ckpt, seed=25)
        log(f"rulstm_expt05: synthetic EK100 tree and a seeded RULSTM file written in "
            f"{time.time() - t0:.1f} s")
        argv = ["--config-file", expt, "--run-dir", os.path.join(tmp, "run")] + tree + [
            f"train.init_from_model=[[temporal_aggregator,{ckpt}],"
            f"[classifiers.action,classifier.1.,{ckpt}]]",
            f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}"]
        with mock.patch.object(train_net, "init_from_model", recorded_init), \
                mock.patch.object(train_net, "make_eval_step", recorded_make_eval):
            (metric,), rec = run_train_net(argv)
    busy, _, wall = profile_run(lambda: evals[0][0](evals[0][1]),
                                f"expts/05 eval step, a batch of {RULSTM_BATCH}")
    del evals[:]
    check(len(inits) == 1 and inits[0]["equal"] and inits[0]["loaded"] == inits[0]["want"],
          f"rulstm_expt05: the model differs from the RULSTM file after init: "
          f"{inits and {k: v for k, v in inits[0].items() if k != 'loaded'}}")
    want = {n: 0 for n in _build.KERNELS}
    check(rec["launches"] == want, f"rulstm_expt05: launches {rec['launches']}, want none")
    eval_wait = rec["waits"]["eval"]
    n_eval = -(-TN_EVAL_VIDEOS * TN_ACTIONS // RULSTM_BATCH)
    check(not rec["epochs"] and len(rec["finals"]) == 1 and len(eval_wait) == n_eval,
          f"rulstm_expt05: epochs {rec['epochs']}, finals {len(rec['finals'])}, eval batches "
          f"{len(eval_wait)}")
    finals = rec["finals"][0]
    check(all(np.isfinite(v) for v in finals.values()) and np.isfinite(metric)
          and metric == finals["final_acc/action/AR5"], f"rulstm_expt05: metrics {finals}")
    log(f"rulstm_expt05 ({card}): expts/05 as shipped (test only, RULSTM 1024 wide, 3 padding "
        f"steps, 11 features at 30 fps, exact_rulstm reads), {rec['rows']['eval']} eval rows in "
        f"{len(eval_wait)} batches of {RULSTM_BATCH}; the LSTMs and the action classifier equal "
        f"the file bit for bit ({len(inits[0]['loaded'])} tensors); host data "
        f"{1e3 * np.median(eval_wait):.2f} ms an eval batch (median of {len(eval_wait)}); eval "
        f"{1e3 * rec['eval_s'][0] / len(eval_wait):.2f} ms a batch (evaluate, result files "
        f"included); metrics " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(finals.items()))
        + f"; cli {rec['wall_s']:.1f} s; launches {rec['launches']}; the eval step alone "
        f"{wall:.2f} ms wall, {busy:.2f} ms device busy")
    return {"rulstm_expt05": rec["launches"]}


# ---------------------------------------------------------- zoo_transformer
# the Transformer aggregator at its defaults (512 wide, 8 heads of 64, 6
# layers, FFN 2048) over 256 observed features: (64, 256, 8, 64) attention
ZOO_LAYERS, ZOO_HEADS, ZOO_DIM = 6, 8, 512
ZOO_SHAPE = (TN_BATCH, LONG_T, ZOO_HEADS, ZOO_DIM // ZOO_HEADS)
# expts/02's lines that the phase drops: its model head (AVT-h, the identity
# aggregator, the past classifier, the dropout), its loss weights and its
# subclips; it keeps the backbone lines and every data, dataset, reader,
# batch and optimizer line
EXPT02_DROPPED = ("model", "+model", "train.train_one_epoch_fn.loss_wts",
                  "data_train.subclips", "data_eval.subclips")
EXPT02_KEPT_MODEL = ("model/backbone=", "model.backbone_dim=")
ZOO_MODEL = ["model/temporal_aggregator=transformer", "model/future_predictor=mlp",
             "model/classifier=mlp", "model.classifier_on_past=false"]


def expt_lines(path, dropped=()):
    """The override lines of an experiment file, but those that start with
    one of `dropped`."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), path)) as f:
        lines = [line.split("#")[0].strip() for line in f]
    return [line for line in lines if line and not line.startswith(tuple(dropped))]


def expt02_kept_overrides():
    """expts/02's lines but those of EXPT02_DROPPED: its data, dataset,
    reader, batch, optimizer and backbone lines."""
    return [line for line in expt_lines(EXPT_02) if line.startswith(EXPT02_KEPT_MODEL)
            or not line.startswith(EXPT02_DROPPED)]


def zoo_transformer_overrides(tree, T=LONG_T):
    """The zoo_transformer run's overrides: expts/02's kept lines, the
    tree's, T observed features with no subclips (the aggregator sees all T
    in one clip), then the Transformer aggregator at its defaults, the MLP
    future predictor and the MLP classifier."""
    return expt02_kept_overrides() + tree + long_context(T) + ZOO_MODEL


def zoo_flops_per_clip(T, dim=ZOO_DIM, layers=ZOO_LAYERS, ffn=2048, feat=FEAT_DIM,
                       actions=NUM_ACTIONS):
    """Forward FLOPs of one clip: the down projection, each layer's qkv,
    output and FFN products and its T x T attention, then the MLP future
    predictor (2 x dim^2) and the MLP classifier."""
    per_token = 2 * feat * dim + layers * (2 * dim * (3 * dim + dim + 2 * ffn) + 4 * T * dim)
    return T * per_token + 2 * (2 * dim * dim) + 2 * (dim * dim + dim * actions)


def recording_make_train_step(train_net, captured, name="make_train_step", optimizers=None):
    """A make_train_step (or `name`'s step maker) for `train_net` whose step
    records (model, loss weights, classes, first batch, the step) in
    `captured` at its first call; the optimizer it is made with goes into
    the list `optimizers` when one is given."""
    real = getattr(train_net, name)

    def make(model, optimizer, loss_wts, num_classes, **kwargs):
        if optimizers is not None:
            optimizers.append(optimizer)
        step = real(model, optimizer, loss_wts, num_classes, **kwargs)

        def recording(batch, generator=None):
            if not captured:
                captured.append((model, loss_wts, num_classes, batch, step))
            return step(batch, generator)

        return recording

    return make


def zoo_transformer_phase(card):
    """The feature path with the Transformer aggregator over 256 observed
    features, through `train_net.cli`: expts/02's data, reader and
    optimizer on the `train_net` phase's tree (`zoo_transformer_overrides`),
    the aggregator at its defaults, batch 64, f32, 1 epoch of 4 batches and
    2 eval batches. Checks: 6 flash forward + 6 flash backward launches a
    train step and 6 forward launches an eval batch, nothing else; finite
    losses and metric. Prints the loop's ms a step and a profile of one
    train step of the model the cli built, on its first batch, by kernel
    group with the flash kernels' share. Returns the launch counts."""
    from avt_tpu_torch import train_net

    steps = []
    with tempfile.TemporaryDirectory() as tmp:
        tree = write_ek100_tree(os.path.join(tmp, "tree"), train_videos=TN_TRAIN_VIDEOS,
                                eval_videos=TN_EVAL_VIDEOS, actions_per_video=TN_ACTIONS,
                                first_action_s=TN_FIRST_S, seed=26)
        argv = ["--run-dir", os.path.join(tmp, "run")] + zoo_transformer_overrides(tree) + [
            f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}",
            "train.num_epochs=1"]
        with mock.patch.object(train_net, "make_train_step",
                               recording_make_train_step(train_net, steps)):
            (metric,), rec = run_train_net(argv)
        want = {**{n: 0 for n in _build.KERNELS},
                "flash_attention_fwd": ZOO_LAYERS * (TN_STEPS + TN_EVAL_BATCHES),
                "flash_attention_bwd": ZOO_LAYERS * TN_STEPS}
        check(rec["launches"] == want, f"zoo_transformer: launches {rec['launches']}, "
              f"want {want}")
        check(rec["epochs"] == [0] and len(rec["waits"]["train"]) == TN_STEPS + 1
              and len(rec["waits"]["eval"]) == TN_EVAL_BATCHES,
              f"zoo_transformer: epochs {rec['epochs']}, batches {rec['waits']}")
        meters = rec["loggers"][0].meters
        losses = {k: m.global_avg for k, m in meters.items() if k.startswith("loss")}
        check(meters["loss"].count == TN_STEPS and all(np.isfinite(list(losses.values()))),
              f"zoo_transformer: losses {losses} over {meters['loss'].count} steps")
        finals = rec["finals"]
        check(len(finals) == 1 and np.isfinite(metric)
              and metric == finals[0]["final_acc/action/AR5"],
              f"zoo_transformer: final metrics {finals}, returned {metric}")
        _, _, _, batch, step = steps[0]
        gen = torch.Generator(device="cuda").manual_seed(27)
        _build.reset_launch_counts()
        busy, groups, wall = profile_run(lambda: step(batch, gen),
                                         "zoo_transformer train step, 64 clips x 256 features")
        torch.cuda.synchronize()
        per_step = {**{n: 0 for n in _build.KERNELS}, "flash_attention_fwd": 2 * ZOO_LAYERS,
                    "flash_attention_bwd": 2 * ZOO_LAYERS}  # profile_run takes 2 steps
        check(_build.launch_counts == per_step,
              f"zoo_transformer: 2 steps launched {_build.launch_counts}, want {per_step}")
        flash = (groups.get("flash attention kernel", 0.0)
                 + groups.get("flash attention bwd kernel", 0.0))
        del steps[:]
    train_wait, eval_wait = rec["waits"]["train"], rec["waits"]["eval"]
    clips_s = meters["clips/s"]
    flops = 3 * TN_BATCH * zoo_flops_per_clip(LONG_T)
    profile = dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall, flash_ms=flash,
                   flash_share=flash / busy, tflop=flops / 1e12, groups=groups)
    log(f"zoo_transformer ({card}): the Transformer aggregator (6 layers of 8 heads of 64, 512 "
        f"wide, FFN 2048) + MLP future + MLP classifier at {LONG_T} observed features, f32, "
        f"rows train {rec['rows']['train']} / eval {rec['rows']['eval']}, {TN_STEPS} steps of "
        f"{TN_BATCH} clips, {len(eval_wait)} eval batches; the loop "
        f"{TN_BATCH / clips_s.median * 1e3:.2f} ms a step (its clips/s meter, median "
        f"{clips_s.median:.2f}); host data {1e3 * np.median(train_wait):.2f} ms a train batch "
        f"(median of {len(train_wait)}), {1e3 * np.median(eval_wait):.2f} ms an eval batch; "
        f"eval {1e3 * rec['eval_s'][0] / len(eval_wait):.2f} ms a batch; losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
        + f"; final_acc/action/AR5 {metric:.4f}; cli {rec['wall_s']:.1f} s; launches "
        f"{rec['launches']}")
    log(f"zoo_transformer train step ({card}): wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"(idle {100 * (1 - busy / wall):.1f}%), {flops / 1e12:.3f} TFLOP a step, "
        f"{flops / busy / 1e9:.2f} TFLOP/s of device time; the flash kernels {flash:.2f} ms "
        f"({100 * flash / busy:.1f}% of device time)")
    return {"zoo_transformer": rec["launches"]}, profile


# ---------------------------------------------------------------- rollout
# expts/02 at 256 observed features with AVT-h rollouts of 2 steps in
# training (a recompute pass at 256 tokens, then the final one at 257) and 8
# at eval (passes at 256-263 tokens); then a long eval rollout of 128 steps on
# 8 clips (its last pass at 383 tokens)
RO_TRAIN_L, RO_EVAL_L, RO_LONG_B, RO_LONG_L = 2, 8, 8, 128
RO_OVERRIDES = [f"model.future_predictor.output_len={RO_TRAIN_L}",
                f"+model.future_predictor.output_len_eval={RO_EVAL_L}"]
RO_LONG_T = LONG_T + RO_LONG_L - 1
ROLLOUT_TOL = 1e-3  # cache vs recompute, of each output's and gradient's max |value|
QUANT_K = 4096  # centroids fit over the synthetic tree's training features


def scaled_err(out, ref):
    """max |out - ref| over max |ref|."""
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-12)
            ).item()


def rollout_train_grads(model, batch, loss_wts, num_classes, seed):
    """One train step's forward and backward without the update, as
    make_train_step runs them (dropout from a generator seeded `seed`):
    ({loss: value}, {parameter: gradient}, ms, peak GB, launches)."""
    model.train()
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.time()
    _, losses, aux, _ = _forward(model, batch["video"], batch, num_classes, None, gen)
    losses.update(aux)
    total, mean_losses = weighted_loss_sum(losses, loss_wts)
    total.backward()
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    launches = dict(_build.launch_counts)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return ({k: v.item() for k, v in mean_losses.items()}, grads, ms,
            torch.cuda.max_memory_allocated() / 1e9, launches)


def rollout_eval(model, video, tshape, reps):
    """The eval forward: (outputs, ms of one call (host clock over `reps`
    calls after the first, synchronised), peak GB, the first call's
    launches)."""
    model.eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with torch.no_grad():
        out, _ = model(video, tshape)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        t0 = time.time()
        for _ in range(reps):
            model(video, tshape)
        torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / max(reps, 1)
    return out, ms, torch.cuda.max_memory_allocated() / 1e9, launches


def flash_launches(fwd, bwd=0):
    return {**{n: 0 for n in _build.KERNELS}, "flash_attention_fwd": fwd,
            "flash_attention_bwd": bwd}


def rollout_phase(card):
    """expts/02 from its file through `train_net.cli` at 256 observed
    features with output_len=2 and output_len_eval=8 (the file's dropout, so
    the position-stable masks are live), on a synthetic EK100 tree: 4 train
    steps, 12 flash forward + 12 backward launches each (6 layers x 2
    passes), and 2 eval batches, 48 forward launches each. Then, on the
    trained weights and the first train batch, the cache mode against the
    recompute mode: the eval outputs at L=8 and one train step's losses and
    gradients at L=2, each within ROLLOUT_TOL of its largest magnitude, and
    a long eval rollout of L=128 on 8 clips (recompute: 768 flash forward
    launches; cache: 6 and 127 plain decode steps), each mode timed, with
    its peak memory. Returns (the launch counts of each path, a summary)."""
    from avt_tpu_torch import train_net

    captured = []
    with tempfile.TemporaryDirectory() as tmp:
        tree = write_ek100_tree(os.path.join(tmp, "tree"), train_videos=TN_TRAIN_VIDEOS,
                                eval_videos=TN_EVAL_VIDEOS, actions_per_video=TN_ACTIONS,
                                first_action_s=TN_FIRST_S, seed=33)
        argv = (["--config-file", EXPT_02, "--run-dir", os.path.join(tmp, "run")] + tree
                + [f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}",
                   "train.num_epochs=1"] + long_context(LONG_T) + RO_OVERRIDES)
        with mock.patch.object(train_net, "make_train_step",
                               recording_make_train_step(train_net, captured)):
            (metric,), rec = run_train_net(argv)
    passes = AVTH_LAYERS * RO_TRAIN_L
    want = flash_launches(passes * TN_STEPS + AVTH_LAYERS * RO_EVAL_L * TN_EVAL_BATCHES,
                          passes * TN_STEPS)
    check(rec["launches"] == want, f"rollout: launches {rec['launches']}, want {want}")
    meters = rec["loggers"][0].meters
    losses = {k: m.global_avg for k, m in meters.items() if k.startswith("loss")}
    check(meters["loss"].count == TN_STEPS and all(np.isfinite(list(losses.values())))
          and np.isfinite(metric), f"rollout: losses {losses}, metric {metric}")
    clips_s = meters["clips/s"]
    log(f"rollout train_net ({card}): expts/02 at {LONG_T} observed features, output_len "
        f"{RO_TRAIN_L}, output_len_eval {RO_EVAL_L}, {TN_STEPS} steps of {TN_BATCH} clips, "
        f"{TN_EVAL_BATCHES} eval batches; the loop {TN_BATCH / clips_s.median * 1e3:.2f} ms a "
        f"step (its clips/s meter); eval {1e3 * rec['eval_s'][0] / TN_EVAL_BATCHES:.2f} ms a "
        f"batch; losses " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
        + f"; final_acc/action/AR5 {metric:.4f}; cli {rec['wall_s']:.1f} s; launches "
        f"{rec['launches']}")

    model, loss_wts, num_classes, batch, step = captured.pop()
    fp = model.future_predictor
    check(fp.output_len == RO_TRAIN_L and fp.output_len_eval == RO_EVAL_L
          and fp.rollout_mode == "recompute" and max(fp.pdrops) > 0,
          f"rollout: the model's AVT-h {fp.output_len}, {fp.output_len_eval}, "
          f"{fp.rollout_mode}, dropout {fp.pdrops}")
    video = batch["video"]
    tshape = tuple(next(iter(batch["target"].values())).shape)
    summary, counts = {}, {}
    modes = ("recompute", "cache")
    want_eval = {"recompute": flash_launches(AVTH_LAYERS * RO_EVAL_L),
                 "cache": flash_launches(AVTH_LAYERS)}
    want_train = {"recompute": flash_launches(passes, passes),
                  "cache": flash_launches(AVTH_LAYERS, AVTH_LAYERS)}
    evals, trains = {}, {}
    for mode in modes:
        fp.rollout_mode = mode
        out, ms, peak, launches = rollout_eval(model, video, tshape, reps=2)
        check(launches == want_eval[mode], f"rollout eval {mode}: launches {launches}, want "
              f"{want_eval[mode]}")
        evals[mode] = out
        counts[f"rollout_eval_{mode}"] = launches
        summary[f"eval_L{RO_EVAL_L}_{mode}"] = dict(ms=ms, peak_gb=peak)
        loss_vals, grads, ms, peak, launches = rollout_train_grads(model, batch, loss_wts,
                                                                   num_classes, seed=35)
        check(launches == want_train[mode], f"rollout train {mode}: launches {launches}, want "
              f"{want_train[mode]}")
        trains[mode] = (loss_vals, grads)
        counts[f"rollout_train_{mode}"] = launches
        summary[f"train_L{RO_TRAIN_L}_{mode}"] = dict(ms=ms, peak_gb=peak, losses=loss_vals)
    out_err = max(scaled_err(evals["cache"][k], evals["recompute"][k])
                  for k in evals["recompute"] if evals["recompute"][k].is_floating_point())
    (lr, gr), (lc, gc) = trains["recompute"], trains["cache"]
    loss_err = max(abs(lc[k] - lr[k]) / max(abs(lr[k]), 1e-12) for k in lr)
    grad_err = max(scaled_err(gc[n], g) for n, g in gr.items())
    check(set(gc) == set(gr) and max(out_err, loss_err, grad_err) <= ROLLOUT_TOL,
          f"rollout: cache vs recompute: eval outputs {out_err:.3g}, losses {loss_err:.3g}, "
          f"gradients {grad_err:.3g} (tolerance {ROLLOUT_TOL})")
    summary["cache_vs_recompute"] = dict(eval_outputs=out_err, losses=loss_err,
                                         gradients=grad_err, tolerance=ROLLOUT_TOL)
    log(f"rollout modes ({card}): 64 clips x {LONG_T} features; eval L={RO_EVAL_L}: "
        + ", ".join(f"{m} {summary[f'eval_L{RO_EVAL_L}_{m}']['ms']:.2f} ms "
                    f"(peak {summary[f'eval_L{RO_EVAL_L}_{m}']['peak_gb']:.2f} GB)"
                    for m in modes)
        + f"; train step (forward + backward, no update) L={RO_TRAIN_L}: "
        + ", ".join(f"{m} {summary[f'train_L{RO_TRAIN_L}_{m}']['ms']:.2f} ms "
                    f"(peak {summary[f'train_L{RO_TRAIN_L}_{m}']['peak_gb']:.2f} GB)"
                    for m in modes)
        + f"; cache vs recompute: eval outputs {out_err:.3g}, losses {loss_err:.3g}, "
        f"gradients {grad_err:.3g} of their max (tolerance {ROLLOUT_TOL})")
    del trains, gr, gc

    fp.output_len_eval = RO_LONG_L
    long_video = video[:RO_LONG_B]
    want_long = {"recompute": flash_launches(AVTH_LAYERS * RO_LONG_L),
                 "cache": flash_launches(AVTH_LAYERS)}
    longs = {}
    for mode in modes:
        fp.rollout_mode = mode
        out, ms, peak, launches = rollout_eval(model, long_video, (RO_LONG_B,), reps=1)
        check(launches == want_long[mode], f"rollout long {mode}: launches {launches}, want "
              f"{want_long[mode]}")
        longs[mode] = out
        counts[f"rollout_long_{mode}"] = launches
        summary[f"eval_L{RO_LONG_L}_{mode}"] = dict(ms=ms, peak_gb=peak)
    long_err = max(scaled_err(longs["cache"][k], longs["recompute"][k])
                   for k in longs["recompute"] if longs["recompute"][k].is_floating_point())
    check(long_err <= ROLLOUT_TOL and all(torch.isfinite(v).all() for v in longs["cache"].values()
                                          if v.is_floating_point()),
          f"rollout long: cache vs recompute {long_err:.3g} (tolerance {ROLLOUT_TOL})")
    summary["long_cache_vs_recompute"] = long_err
    rl, cl = (summary[f"eval_L{RO_LONG_L}_{m}"] for m in modes)
    log(f"rollout long ({card}): {RO_LONG_B} clips, T0={LONG_T}, L={RO_LONG_L} (up to "
        f"{RO_LONG_T} tokens): recompute {rl['ms']:.2f} ms ({AVTH_LAYERS * RO_LONG_L} flash "
        f"launches, peak {rl['peak_gb']:.2f} GB), cache {cl['ms']:.2f} ms (prefill + "
        f"{RO_LONG_L - 1} decode steps, peak {cl['peak_gb']:.2f} GB); cache vs recompute "
        f"{long_err:.3g} of the max (tolerance {ROLLOUT_TOL})")
    fp.output_len_eval, fp.rollout_mode = RO_EVAL_L, "recompute"
    del evals, longs

    # one train step of the loop (with its update), profiled, and one
    # position-stable mask at a training pass's shape (19 a pass: the
    # embedding's and 3 a layer)
    gen = torch.Generator(device="cuda").manual_seed(37)
    busy, groups, wall = profile_run(lambda: step(batch, gen), f"rollout train step, "
                                     f"{TN_BATCH} clips x {LONG_T} features, L={RO_TRAIN_L}")
    x = torch.randn(TN_BATCH, LONG_T + 1, AVTH_DIM, device="cuda")
    mask_ms = cuda_ms(lambda: position_stable_dropout(x, torch.tensor(5, device="cuda"), 0.1),
                      iters=5, reps=3)
    masks = RO_TRAIN_L * (1 + 3 * AVTH_LAYERS)
    summary["train_step_profile"] = dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                                         groups=groups, mask_ms=mask_ms, masks_a_step=masks)
    log(f"rollout train step ({card}): wall {wall:.2f} ms, device busy {busy:.2f} ms (idle "
        f"{100 * (1 - busy / wall):.1f}%); one position-stable mask at ({TN_BATCH}, "
        f"{LONG_T + 1}, {AVTH_DIM}) f32 {mask_ms:.3f} ms, {masks} a step's forward: "
        f"{masks * mask_ms:.2f} ms ({100 * masks * mask_ms / busy:.1f}% of device time)")
    del model, batch, step, x
    torch.cuda.empty_cache()
    return {"rollout": rec["launches"], **counts}, summary


def quantized_phase(card):
    """`kmeans_fit` on the card over every training feature of a synthetic
    EK100 tree (k=4096, timed); the centroids, written as .npy, feed expts/02
    at its shipped 10 features through `train_net.cli` with
    `assign_to_centroids` and a MultiDimCrossEntropy feat loss over the ids
    (AVT-h's embedding at the default 50000 ids, its decoder tied to it): 4
    train steps and 2 eval batches, no kernel launches, finite losses and
    metric, and the checkpoint's encoder and decoder weights equal. Returns
    (the launch counts, a summary)."""
    from avt_tpu_torch import train_net

    captured = []
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "tree")
        tree = write_ek100_tree(root, train_videos=TN_TRAIN_VIDEOS,
                                eval_videos=TN_EVAL_VIDEOS, actions_per_video=TN_ACTIONS,
                                first_action_s=TN_FIRST_S, seed=34)
        rgb = os.path.join(root, "features", "rgb")
        feats = np.concatenate([np.load(os.path.join(rgb, f)) for f in sorted(os.listdir(rgb))
                                if f.startswith("P01_")])
        torch.cuda.synchronize()
        t0 = time.time()
        cents = kmeans_fit(feats, k=QUANT_K, device="cuda")
        kmeans_s = time.time() - t0
        check(cents.shape == (QUANT_K, FEAT_DIM) and np.isfinite(cents).all(),
              f"kmeans_fit: centroids {cents.shape}, finite {np.isfinite(cents).all()}")
        path = os.path.join(tmp, "centroids.npy")
        np.save(path, cents)
        log(f"quantized ({card}): kmeans_fit k={QUANT_K} over {feats.shape[0]} x "
            f"{feats.shape[1]} f32 training features in {kmeans_s:.2f} s (50 iterations)")
        run_dir = os.path.join(tmp, "run")
        argv = (["--config-file", EXPT_02, "--run-dir", run_dir] + tree
                + [f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}",
                   "train.num_epochs=1", f"+model.future_predictor.assign_to_centroids={path}",
                   "model.future_predictor.future_pred_loss="
                   "{_target_: loss_fn.multidim_xentropy.MultiDimCrossEntropy}"])
        with mock.patch.object(train_net, "make_train_step",
                               recording_make_train_step(train_net, captured)):
            (metric,), rec = run_train_net(argv)
        ckpt = torch.load(os.path.join(run_dir, CKPT_NAME), map_location="cpu",
                          weights_only=False)["model"]
    check(rec["launches"] == flash_launches(0), f"quantized: launches {rec['launches']}")
    meters = rec["loggers"][0].meters
    losses = {k: m.global_avg for k, m in meters.items() if k.startswith("loss")}
    check(meters["loss"].count == TN_STEPS and all(np.isfinite(list(losses.values())))
          and np.isfinite(metric), f"quantized: losses {losses}, metric {metric}")
    model, _, _, batch, step = captured.pop()
    fp = model.future_predictor
    enc, dec = (ckpt[f"future_predictor.{n}.weight"] for n in ("encoder", "decoder"))
    check(fp.decoder.weight is fp.encoder.weight and enc.shape == (50000, AVTH_DIM)
          and torch.equal(enc, dec) and fp.assigner.num_clusters == QUANT_K,
          f"quantized: tied weights {fp.decoder.weight is fp.encoder.weight}, checkpoint "
          f"{tuple(enc.shape)} equal {torch.equal(enc, dec)}")
    clips_s = meters["clips/s"]
    log(f"quantized train_net ({card}): expts/02 at {SHORT_T} features assigned to {QUANT_K} "
        f"centroids, {TN_STEPS} steps of {TN_BATCH} clips, {TN_EVAL_BATCHES} eval batches; the "
        f"loop {TN_BATCH / clips_s.median * 1e3:.2f} ms a step; losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
        + f"; final_acc/action/AR5 {metric:.4f}; the checkpoint's encoder and tied decoder "
        f"equal; cli {rec['wall_s']:.1f} s; launches {rec['launches']}")
    gen = torch.Generator(device="cuda").manual_seed(38)
    busy, _, wall = profile_run(lambda: step(batch, gen), f"quantized train step, {TN_BATCH} "
                                f"clips x {SHORT_T} features")
    del model, batch, step, fp, ckpt
    torch.cuda.empty_cache()
    return {"quantized": rec["launches"]}, dict(kmeans_s=kmeans_s, k=QUANT_K,
                                                rows=int(feats.shape[0]), losses=losses,
                                                step_wall_ms=wall, step_busy_ms=busy)



# ---------------------------------------------------- conv_default, bn_inception
# conf/config.yaml as shipped (r2plus1d_34, 16 frames at 112, train batch 16,
# eval 64) on raw video: 4 train videos and 8 eval videos of 16 actions a
# second from 4 s on (tau_o 2.5 s before tau_a 1 s fits), so 64 train rows (4
# batches of 16) and 128 eval rows (2 batches of 64)
CV_TRAIN_VIDEOS, CV_EVAL_VIDEOS, CV_ACTIONS, CV_FIRST_S = 4, 8, 16, 4
CV_BATCH, CV_EVAL_BATCH, CV_FRAMES, CV_CROP = 16, 64, 16, 112
CV_STEPS = CV_TRAIN_VIDEOS * CV_ACTIONS // CV_BATCH
CV_EVAL_BATCHES = CV_EVAL_VIDEOS * CV_ACTIONS // CV_EVAL_BATCH
CV_RESUME_TOL = 1e-3  # straight vs crashed and resumed run, of each tensor's max |value|
# BN-Inception at TSN's input: 10 frames, smaller side 256, 224 crops; one
# train step of all 64 train rows and one eval batch of all 128 eval rows
BNI_FRAMES, BNI_CROP = 10, 224
BNI_OVERRIDES = ["model/backbone=bn_inception", "model.backbone_last_n_modules_to_drop=0",
                 f"data_train.num_frames={BNI_FRAMES}", f"data_eval.num_frames={BNI_FRAMES}",
                 "data_train.scale_h=256", "data_train.scale_w=-1", "data_eval.scale_h=256",
                 "data_eval.scale_w=-1", f"data_train.crop_size={BNI_CROP}",
                 f"data_eval.crop_size={BNI_CROP}",
                 f"train.batch_size={CV_TRAIN_VIDEOS * CV_ACTIONS}",
                 f"eval.batch_size={CV_EVAL_VIDEOS * CV_ACTIONS}"]
BNI_FILE = "bn_inception-52deb4733.pth"  # pretrainedmodels' released name
R2P1D_FILE = "r2plus1d_18-91a641e6.pth"  # torchvision's released name


def _seeded_backbone_file(path, module, head, n_classes, seed):
    """A seeded state_dict in `module`'s names and shapes (the released
    layout the port's names follow), plus the classifier `head` over
    `n_classes` that the released file carries and `num_batches_tracked`
    counts: conv and linear weights N(0, 0.02), BatchNorm weights about 1,
    running variances in [0.5, 1.5). Returns the state_dict."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(1000)
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, tuple(v.shape)).astype(np.float32))
        else:
            w = 0.02 * rng.standard_normal(tuple(v.shape), np.float32)
            sd[k] = torch.from_numpy(w + (1.0 if k.endswith("_bn.weight") or (
                k.endswith(".weight") and v.dim() == 1) else 0.0))
    dim = module.output_dim
    sd[f"{head}.weight"] = torch.from_numpy(0.02 * rng.standard_normal((n_classes, dim),
                                                                       np.float32))
    sd[f"{head}.bias"] = torch.zeros(n_classes)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)
    return sd


def write_bninception(path, seed=0):
    """A seeded BN-Inception file in pretrainedmodels' layout, with its
    1000-class `last_linear`."""
    from avt_tpu_torch.models import BNInceptionVideo

    return _seeded_backbone_file(path, BNInceptionVideo(device="meta"), "last_linear", 1000,
                                 seed)


def write_video_resnet(path, factory="r2plus1d_18", seed=0):
    """A seeded video ResNet file in torchvision's layout (a VideoResNet's
    state_dict), with its 400-class Kinetics `fc`."""
    from avt_tpu_torch.models import VIDEO_RESNETS

    return _seeded_backbone_file(path, VIDEO_RESNETS[factory](device="meta"), "fc", 400, seed)


def conv_flops(model, video):
    """Forward FLOPs of `model` on `video` counted by its convolutions and
    linears (2 per multiply-add, from the shapes a no-grad forward sees)."""
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Linear):
            total[0] += 2 * out.numel() * mod.in_features
        else:
            total[0] += 2 * out.numel() * mod.weight[0].numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model.eval()(video)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def recording_make_eval_step(train_net, moved):
    """A make_eval_step for `train_net` whose step appends to `moved`
    whether an eval batch changed any BatchNorm running statistic."""
    real = train_net.make_eval_step

    def make(model, *args, **kwargs):
        step = real(model, *args, **kwargs)

        def recording(batch):
            before = [b.clone() for n, b in model.named_buffers() if "running" in n]
            out = step(batch)
            after = [b for n, b in model.named_buffers() if "running" in n]
            moved.append(any(not torch.equal(x, y) for x, y in zip(before, after)))
            return out

        return recording

    return make


def conv_default_phase(card, tree):
    """conf/config.yaml through `train_net.cli` with no --config-file
    (r2plus1d_34, the mean aggregator, identity future, linear classifier,
    16 frames at 112, train batch 16, eval 64, SGD under warmup multi-step)
    on the raw-video tree `tree` (the overrides `write_ek100_tree` returned),
    cut to 4 train batches and 2 eval batches. (1) As shipped, one epoch:
    finite losses and metric, no kernel launches, every running statistic
    moved in training and none in eval; prints the loop's ms a step, the
    decode wait, eval's ms a batch; then a profile of one train step (busy,
    idle share, kernel groups, conv TFLOP/s, peak memory). (2) With the
    train clips read deterministically (center_clip: random_clip draws from
    a stream the loader's threads share) and cuDNN deterministic, 2 epochs
    straight, then 2 epochs crashed at the start of epoch 2 and resumed
    from its checkpoint in a new cli call: the two final checkpoints equal within CV_RESUME_TOL of
    each tensor's max |value|, running statistics included. Returns
    (launch counts, a summary)."""
    from avt_tpu_torch import train_net

    captured, moved = [], []
    cut = [f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}"]
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "shipped")
        argv = ["--run-dir", run_dir] + tree + cut + ["train.num_epochs=1"]
        with mock.patch.object(train_net, "make_train_step",
                               recording_make_train_step(train_net, captured)), \
                mock.patch.object(train_net, "make_eval_step",
                                  recording_make_eval_step(train_net, moved)):
            (metric,), rec = run_train_net(argv)
        ckpt = torch.load(os.path.join(run_dir, CKPT_NAME), map_location="cpu",
                          weights_only=False)["model"]
        stats = {k: v for k, v in ckpt.items() if "running" in k}
        check(rec["launches"] == flash_launches(0), f"conv_default: launches {rec['launches']}")
        check(rec["epochs"] == [0] and len(rec["waits"]["train"]) == CV_STEPS + 1
              and len(rec["waits"]["eval"]) == CV_EVAL_BATCHES,
              f"conv_default: epochs {rec['epochs']}, batches {rec['waits']}")
        meters = rec["loggers"][0].meters
        losses = {k: m.global_avg for k, m in meters.items() if k.startswith("loss")}
        check(meters["loss"].count == CV_STEPS and all(np.isfinite(list(losses.values())))
              and np.isfinite(metric), f"conv_default: losses {losses}, metric {metric}")
        unmoved = [k for k, v in stats.items()
                   if torch.equal(v, torch.zeros_like(v) if "mean" in k else torch.ones_like(v))]
        check(stats and not unmoved and len(moved) == CV_EVAL_BATCHES and not any(moved),
              f"conv_default: running stats unmoved by training {unmoved[:4]}, moved by eval "
              f"batches {moved}")
        model, _, _, batch, step = captured.pop()
        train_wait, eval_wait = rec["waits"]["train"], rec["waits"]["eval"]
        clips_s = meters["clips/s"]
        loop_ms = CV_BATCH / clips_s.median * 1e3
        n_params = sum(p.numel() for p in model.parameters())
        log(f"conv_default ({card}): conf/config.yaml with no --config-file, r2plus1d_34 "
            f"({n_params / 1e6:.1f} M parameters) + mean aggregator + identity future + "
            f"linear classifier on "
            f"{CV_FRAMES} frames at {CV_CROP}, f32 (TF32 off), rows train {rec['rows']['train']}"
            f" / eval {rec['rows']['eval']}, {CV_STEPS} steps of {CV_BATCH} clips, "
            f"{len(eval_wait)} eval batches of {CV_EVAL_BATCH}; the loop {loop_ms:.2f} ms a "
            f"step (its clips/s meter, median {clips_s.median:.2f}); host decode wait "
            f"{1e3 * np.median(train_wait):.2f} ms a train batch (median of {len(train_wait)}, "
            f"max {1e3 * max(train_wait):.2f}), {1e3 * np.median(eval_wait):.2f} ms an eval "
            f"batch; eval {1e3 * rec['eval_s'][0] / len(eval_wait):.2f} ms a batch; losses "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
            + f"; final_acc/action/AR5 {metric:.4f}; {len(stats)} running statistics moved in "
            f"training, none in eval; cli {rec['wall_s']:.1f} s; launches {rec['launches']}")
        gen = torch.Generator(device="cuda").manual_seed(39)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        busy, groups, wall = profile_run(lambda: step(batch, gen), f"conv_default train step, "
                                         f"{CV_BATCH} clips of {CV_FRAMES} frames at {CV_CROP}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        flops_clip = conv_flops(model, torch.randn(1, 1, 3, CV_FRAMES, CV_CROP, CV_CROP,
                                                   device="cuda"))
        flops = 3 * CV_BATCH * flops_clip
        log(f"conv_default train step ({card}): wall {wall:.2f} ms, device busy {busy:.2f} ms "
            f"(idle {100 * (1 - busy / wall):.1f}%), {flops / 1e12:.3f} TFLOP a step (3 x the "
            f"forward's {flops_clip / 1e9:.2f} GFLOP a clip in convolutions and linears), "
            f"{flops / busy / 1e9:.2f} TFLOP/s of device time; peak memory {peak_gb:.2f} GB")
        del model, batch, step, ckpt
        torch.cuda.empty_cache()

        # (2) a straight run and a crashed + resumed one, the train reads and
        # cuDNN's algorithms deterministic (its default backward algorithms
        # accumulate in no fixed order, which SGD at LR 0.1 amplifies)
        runs = {}
        two = tree + cut + ["train.num_epochs=2", "dataset_train.sample_strategy=center_clip"]
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            (runs["straight"],), rec_a = run_train_net(["--run-dir", os.path.join(tmp, "a")]
                                                       + two)
            try:
                run_train_net(["--run-dir", os.path.join(tmp, "b")] + two, crash_epoch=1)
                check(False, "conv_default: the run meant to crash at epoch 1 did not")
            except Crash:
                pass
            (runs["resumed"],), rec_b = run_train_net(["--run-dir", os.path.join(tmp, "b")]
                                                      + two)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        sd_a, sd_b = (torch.load(os.path.join(tmp, r, CKPT_NAME), map_location="cpu",
                                 weights_only=False) for r in ("a", "b"))
    check(rec_a["epochs"] == [0, 1] and rec_b["epochs"] == [1] and sd_a["epoch"] == 2.0
          and sd_b["epoch"] == 2.0, f"conv_default resume: epochs {rec_a['epochs']} / "
          f"{rec_b['epochs']}, checkpoints at {sd_a['epoch']} / {sd_b['epoch']}")
    errs = {k: scaled_err(sd_b["model"][k].float(), v.float())
            for k, v in sd_a["model"].items() if v.is_floating_point()}
    worst = max(errs, key=errs.get)
    stat_err = max(v for k, v in errs.items() if "running" in k)
    bits = all(torch.equal(sd_b["model"][k], v) for k, v in sd_a["model"].items())
    check(errs[worst] <= CV_RESUME_TOL, f"conv_default resume: {worst} differs by "
          f"{errs[worst]:.3g} of its max (limit {CV_RESUME_TOL})")
    log(f"conv_default resume ({card}): 2 epochs straight vs crashed at epoch 1 and resumed: "
        f"final weights within {errs[worst]:.3g} of each tensor's max |value| (worst {worst}), "
        f"running statistics within {stat_err:.3g}, bits equal: {bits}; metrics "
        f"{runs['straight']:.4f} / {runs['resumed']:.4f}; launches {rec_a['launches']} / "
        f"{rec_b['launches']}")
    return ({"conv_default": rec["launches"], "conv_default_resume": rec_b["launches"]},
            dict(loop_ms=loop_ms, decode_wait_ms=1e3 * float(np.median(train_wait)),
                 step_wall_ms=wall, step_busy_ms=busy, idle_share=1 - busy / wall,
                 tflop_per_step=flops / 1e12, peak_gb=peak_gb, groups=groups,
                 resume_max_err=errs[worst], resume_bits_equal=bits))


def bn_inception_phase(card, tree):
    """BN-Inception (TSN's frame-level backbone) through `train_net.cli` on
    the conv_default tree: conf/config.yaml with `model/backbone=bn_inception`
    (N=0 truncation) at 10 frames, smaller side 256, 224 crops; its
    `train.init_from_model` is a seeded file in pretrainedmodels' layout
    (`write_bninception`, with its `last_linear`), which must load bit for
    bit before step 1 (every conv, bias and BatchNorm with its running
    statistics; not the head nor the counts). One train step of 64 clips and
    one eval batch of 128: finite loss and metric, no kernel launches. Then
    a seeded r2plus1d_18 file in torchvision's layout (`write_video_resnet`,
    with its `fc`) loads through `init_from_model` into the model
    `model/backbone=r2plus1d_18` builds, bit for bit, and its eval forward
    on a 16-frame clip at 112 is finite. Returns the launch counts."""
    from avt_tpu_torch import train_net
    from avt_tpu_torch.config import Composer, parse_override
    from avt_tpu_torch.config.build import build_model
    from avt_tpu_torch.models import import_torch

    inits = []
    real_init = import_torch.init_from_model

    def recorded_init(model, specs):
        loaded = real_init(model, specs)
        sd = model.state_dict()
        src = import_torch.load_torch_state_dict(specs[-1][-1])
        kept = import_torch.convert_checkpoint(src)[0]
        inits.append({"equal": all(torch.equal(sd["backbone.model." + k].cpu(), v)
                                   for k, v in kept.items()),
                      "loaded": sorted(loaded), "want": sorted("backbone.model." + k for k in kept),
                      "skipped": sorted(k for k in src if k not in kept)})
        return loaded

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, BNI_FILE)
        write_bninception(path, seed=40)
        argv = (["--run-dir", os.path.join(tmp, "run")] + tree + BNI_OVERRIDES
                + [f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}",
                   "train.num_epochs=1", f"train.init_from_model=[[backbone.model,{path}]]"])
        with mock.patch.object(train_net, "init_from_model", recorded_init):
            (metric,), rec = run_train_net(argv)
        check(len(inits) == 1 and inits[0]["equal"] and inits[0]["loaded"] == inits[0]["want"]
              and all(k.startswith("last_linear.") or k.endswith("num_batches_tracked")
                      for k in inits[0]["skipped"]),
              f"bn_inception: init {inits}")
        check(rec["launches"] == flash_launches(0), f"bn_inception: launches {rec['launches']}")
        meters = rec["loggers"][0].meters
        losses = {k: m.global_avg for k, m in meters.items() if k.startswith("loss")}
        check(meters["loss"].count == 1 and len(rec["waits"]["eval"]) == 1
              and all(np.isfinite(list(losses.values()))) and np.isfinite(metric),
              f"bn_inception: {meters['loss'].count} steps, {len(rec['waits']['eval'])} eval "
              f"batches, losses {losses}, metric {metric}")
        log(f"bn_inception ({card}): conf/config.yaml + model/backbone=bn_inception at "
            f"{BNI_FRAMES} frames of {BNI_CROP}, init from a pretrainedmodels-layout file "
            f"({len(inits[0]['loaded'])} tensors equal to the file, skipped "
            f"{len(inits[0]['skipped'])}: last_linear and the counts), 1 step of "
            f"{CV_TRAIN_VIDEOS * CV_ACTIONS} clips ({CV_TRAIN_VIDEOS * CV_ACTIONS * BNI_FRAMES} "
            f"frames), 1 eval batch of {CV_EVAL_VIDEOS * CV_ACTIONS} clips; decode wait "
            f"{1e3 * rec['waits']['train'][0]:.2f} ms (train) / "
            f"{1e3 * rec['waits']['eval'][0]:.2f} ms (eval); eval {1e3 * rec['eval_s'][0]:.2f} "
            f"ms; losses " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
            + f"; final_acc/action/AR5 {metric:.4f}; cli {rec['wall_s']:.1f} s")

        path = os.path.join(tmp, R2P1D_FILE)
        file_sd = write_video_resnet(path, "r2plus1d_18", seed=41)
        cfg = Composer(train_net.CONF_DIR).compose("config", [parse_override(
            "model/backbone=r2plus1d_18")])
        model = build_model(cfg, {"action": NUM_ACTIONS}, {}, device="cuda")
        loaded = import_torch.init_from_model(model, [["backbone.model", path]])
        sd = model.state_dict()
        want = {k for k in file_sd if not k.startswith("fc.")
                and not k.endswith("num_batches_tracked")}
        check(sorted(loaded) == sorted("backbone.model." + k for k in want)
              and all(torch.equal(sd["backbone.model." + k].cpu(), file_sd[k]) for k in want),
              f"r2plus1d_18 file: loaded {len(loaded)} of {len(want)}, equal "
              f"{all(torch.equal(sd['backbone.model.' + k].cpu(), file_sd[k]) for k in want)}")
        with torch.no_grad():
            out, _ = model(torch.randn(2, 1, 3, CV_FRAMES, CV_CROP, CV_CROP, device="cuda"))
        check(out["logits/action"].shape == (2, NUM_ACTIONS)
              and bool(torch.isfinite(out["logits/action"]).all()),
              f"r2plus1d_18 file: eval logits {tuple(out['logits/action'].shape)}")
        log(f"bn_inception ({card}): a torchvision-layout r2plus1d_18 file loaded "
            f"{len(loaded)} tensors into model/backbone=r2plus1d_18 bit for bit (not fc nor "
            f"the counts); its eval forward finite")
        del model
        torch.cuda.empty_cache()
    return {"bn_inception": rec["launches"]}


# the ssl phase: expts/02 at 256 observed features with the SSL op: the
# InfoNCE between the projected past (2048-d) and each clip's future clip,
# no subclips (the reference's step slices the clip batch), so no past
# classifier; a step runs AVT-h once over the 64 observed and 64 future clips
SSL_OVERRIDES = ["train_eval_op=pred_future_feat", "train_eval_op/reg_criterion=simclr_infonce",
                 "+dataset_train.return_future_clips_too=true", "model.project_dim_for_nce=2048",
                 "data_train.subclips.num_frames=null", "data_train.subclips.stride=null",
                 "data_eval.subclips.num_frames=null", "data_eval.subclips.stride=null",
                 "model.classifier_on_past=false"]


def ssl_phase(card):
    """train_eval_op=pred_future_feat through `train_net.cli` on expts/02 at
    256 observed features (the train_net phase's overrides and tree, 1024-d
    features) with `SSL_OVERRIDES`: `make_ssl_train_step` forward and
    backward on 2 x 64 clips a step, 1 epoch of 4 steps and 2 eval batches.
    Checks: 6 flash forward + 6 flash backward launches a step and 6
    forward an eval batch, nothing else; finite losses (reg among them) and
    metric. Prints the loop's ms a step and a profile of one train step
    with its peak memory. Returns (the launch counts, a summary)."""
    from avt_tpu_torch import train_net

    captured = []
    with tempfile.TemporaryDirectory() as tmp:
        # the stores reach past each action's future clip (its start + 256 s)
        tree = write_ek100_tree(os.path.join(tmp, "tree"), train_videos=TN_TRAIN_VIDEOS,
                                eval_videos=TN_EVAL_VIDEOS, actions_per_video=TN_ACTIONS,
                                first_action_s=TN_FIRST_S, seed=42, tail_s=LONG_T + 2)
        argv = (["--config-file", EXPT_02, "--run-dir", os.path.join(tmp, "run")] + tree
                + [f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}",
                   "train.num_epochs=1"] + long_context(LONG_T) + SSL_OVERRIDES)
        with mock.patch.object(train_net, "make_ssl_train_step", recording_make_train_step(
                train_net, captured, "make_ssl_train_step")):
            (metric,), rec = run_train_net(argv)
    want = flash_launches(AVTH_LAYERS * (TN_STEPS + TN_EVAL_BATCHES), AVTH_LAYERS * TN_STEPS)
    check(rec["launches"] == want, f"ssl: launches {rec['launches']}, want {want}")
    meters = rec["loggers"][0].meters
    losses = {k: m.global_avg for k, m in meters.items() if k.startswith("loss")}
    check(meters["loss"].count == TN_STEPS and "loss/reg" in losses
          and all(np.isfinite(list(losses.values()))) and np.isfinite(metric),
          f"ssl: losses {losses} over {meters['loss'].count} steps, metric {metric}")
    _, _, _, batch, step = captured.pop()
    check(batch["future_0_video"].shape == batch["video"].shape == (TN_BATCH, 1, FEAT_DIM,
                                                                     LONG_T, 1, 1),
          f"ssl: batch {tuple(batch['video'].shape)}, future "
          f"{tuple(batch['future_0_video'].shape)}")
    clips_s = meters["clips/s"]
    loop_ms = TN_BATCH / clips_s.median * 1e3
    log(f"ssl ({card}): expts/02 + pred_future_feat (InfoNCE, 2048-d projection, 1 future "
        f"clip) at {LONG_T} features, {TN_STEPS} steps of {TN_BATCH} + {TN_BATCH} future clips, "
        f"{TN_EVAL_BATCHES} eval batches; the loop {loop_ms:.2f} ms a step (its clips/s meter "
        f"counts the {TN_BATCH} observed clips); host data "
        f"{1e3 * np.median(rec['waits']['train']):.2f} ms a train batch; losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
        + f"; final_acc/action/AR5 {metric:.4f}; cli {rec['wall_s']:.1f} s; launches "
        f"{rec['launches']}")
    gen = torch.Generator(device="cuda").manual_seed(43)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    busy, groups, wall = profile_run(lambda: step(batch, gen), f"ssl train step, {TN_BATCH} + "
                                     f"{TN_BATCH} clips x {LONG_T} features")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(_build.launch_counts == flash_launches(2 * AVTH_LAYERS, 2 * AVTH_LAYERS),
          f"ssl: 2 profiled steps launched {_build.launch_counts}")
    flash = groups.get("flash attention kernel", 0.0) + groups.get("flash attention bwd kernel",
                                                                   0.0)
    log(f"ssl train step ({card}): wall {wall:.2f} ms, device busy {busy:.2f} ms (idle "
        f"{100 * (1 - busy / wall):.1f}%), the flash kernels {flash:.2f} ms "
        f"({100 * flash / busy:.1f}% of device time); peak memory {peak_gb:.2f} GB")
    del batch, step
    torch.cuda.empty_cache()
    return {"ssl": rec["launches"]}, dict(loop_ms=loop_ms, step_wall_ms=wall, step_busy_ms=busy,
                                          idle_share=1 - busy / wall, flash_ms=flash,
                                          peak_gb=peak_gb, groups=groups)



# ----------------------------------------------------------------- export
# a fresh process that imports the port's ops (and serve's host loop), none
# of its models or config, loads the saved programs and answers requests
EXPORT_LOAD_SCRIPT = """
import json, sys, time
import numpy as np
import torch
from avt_tpu_torch.ops import _build
from avt_tpu_torch.serve import batch_predict, load_exported, serving_fn
clips, out_path = np.load(sys.argv[1]), sys.argv[2]
res = {}
for arg in sys.argv[3:]:  # <batch size>=<path>
    bs, path = int(arg.split("=", 1)[0]), arg.split("=", 1)[1]
    t0 = time.time()
    prog = load_exported(path)
    load_s = time.time() - t0
    t0 = time.time()
    call = serving_fn(prog)  # what a server builds once and keeps
    module_s = time.time() - t0
    batch = np.concatenate([clips] * 4)[:bs]
    _build.reset_launch_counts()
    logits = batch_predict(call, batch)["logits/action"]  # one forward
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    if bs == 4:
        np.save(out_path, logits)
    t0 = time.time()
    for _ in range(3):
        batch_predict(call, batch)
    res[bs] = dict(load_s=load_s, module_s=module_s, launches=launches,
                   request_ms=(time.time() - t0) / 3 * 1e3)
bad = [m for m in sys.modules if m.startswith(("avt_tpu_torch.models", "avt_tpu_torch.config",
                                               "avt_tpu_torch.train", "avt_tpu."))]
res["foreign_modules"] = bad
print(json.dumps(res))
"""


def export_phase(card):
    """The full-width bf16 flagship with its preprocessing (serve_phase's
    model and preprocessor) exported through `export_eval_forward` at batch
    4 and 32 on uint8 clips of CLIP, saved, then loaded and run in a fresh
    process that imports only `avt_tpu_torch.ops` and serve's host loop:
    12 packed forward launches a forward and nothing else, logits/action
    within the serving phase's bf16 tolerance of `make_eval_forward` on the
    same clips (the largest difference and whether the bits are equal are
    printed), a request's ms at batch 4 and 32 beside the eager forward's.
    Then the program with bake_params=False at batch 4, called on
    `model_params(model)`: the same checks. Returns the loaded program's
    launch counts of one forward."""
    from avt_tpu_torch.serve import (
        export_eval_forward,
        model_params,
        save_exported,
        serving_fn,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_avt(num_actions=NUM_ACTIONS, vit_dtype=torch.bfloat16, generator=gen)
    pp = VideoPreprocessor(crop_size=224, scale_h=248, scale_w=-1, mean=(0.5,) * 3,
                           std=(0.5,) * 3, eval_num_crops=3, eval_flip_crops=True,
                           compute_dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    fwd = make_eval_forward(model, pp)
    clips = np.random.default_rng(5).integers(0, 256, size=(8,) + CLIP, dtype=np.uint8)
    eager = fwd(clips[:BATCH])["logits/action"].float().cpu().numpy()
    eager_ms = {}
    for bs in (BATCH, 32):
        batch = np.concatenate([clips] * 4)[:bs]
        batch_predict(fwd, batch, bs)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(3):
            batch_predict(fwd, batch, bs)
        eager_ms[bs] = (time.time() - t0) / 3 * 1e3

    def compare(logits, what):
        diff = float(np.abs(logits - eager).max())
        check(logits.shape == eager.shape and np.isfinite(logits).all(),
              f"export {what}: logits {logits.shape}")
        np.testing.assert_allclose(logits, eager, atol=1e-2, rtol=2e-2, err_msg=what)
        return diff, bool(np.array_equal(logits, eager))

    with tempfile.TemporaryDirectory() as tmp:
        paths, export_s, sizes = [], {}, {}
        for bs in (BATCH, 32):
            t0 = time.time()
            prog = export_eval_forward(model, (bs,) + CLIP, preprocessor=pp, platforms=("cuda",))
            export_s[bs] = time.time() - t0
            targets = [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
            n_ops = targets.count("avt_tpu_torch.packed_short_attention.default")
            check(n_ops == VIT_BLOCKS, f"export: the program calls the packed op {n_ops} times")
            path = os.path.join(tmp, f"flagship_b{bs}.pt2")
            save_exported(prog, path)
            sizes[bs] = os.path.getsize(path) / 1e9
            paths.append(f"{bs}={path}")
            del prog
        np.save(os.path.join(tmp, "clips.npy"), clips)
        out_path = os.path.join(tmp, "logits.npy")
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-c", EXPORT_LOAD_SCRIPT,
                               os.path.join(tmp, "clips.npy"), out_path] + paths,
                              capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=os.getcwd()))
        check(proc.returncode == 0, f"export: the loading process failed:\n{proc.stderr[-4000:]}")
        loaded = json.loads(proc.stdout.strip().splitlines()[-1])
        load_wall = time.time() - t0
        logits = np.load(out_path)
    check(not loaded["foreign_modules"], f"export: the loading process imported "
          f"{loaded['foreign_modules']}")
    want = {**{n: 0 for n in _build.KERNELS}, "short_attention_fwd": VIT_BLOCKS}
    for bs in (BATCH, 32):
        got = loaded[str(bs)]["launches"]
        check(got == want, f"export: one forward of the loaded batch-{bs} program launched "
              f"{got}, want {want}")
    diff, same = compare(logits, "loaded program")

    t0 = time.time()
    unbaked = export_eval_forward(model, (BATCH,) + CLIP, preprocessor=pp, bake_params=False)
    unbaked_s = time.time() - t0
    call = serving_fn(unbaked)
    call(model_params(model), clips[:BATCH])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    u_logits = call(model_params(model), clips[:BATCH])["logits/action"].float().cpu().numpy()
    torch.cuda.synchronize()
    u_launches = dict(_build.launch_counts)
    check(u_launches == want, f"export: one unbaked forward launched {u_launches}, want {want}")
    u_diff, u_same = compare(u_logits, "unbaked program")
    log(f"export ({card}): the bf16 flagship with 3-crop + flip preprocessing, exported in "
        f"{export_s[BATCH]:.1f} s (batch {BATCH}) and {export_s[32]:.1f} s (batch 32), "
        f"{sizes[BATCH]:.2f} GB a .pt2; loaded in a fresh process importing avt_tpu_torch.ops "
        f"({load_wall:.1f} s with its requests; load {loaded[str(BATCH)]['load_s']:.1f} s, "
        f"serving_fn {loaded[str(BATCH)]['module_s']:.2f} s); "
        f"one forward {loaded[str(BATCH)]['launches']}; logits/action vs make_eval_forward "
        f"max |diff| {diff:.3g} (bits equal: {same}); a request (uint8 clips in, logits out) "
        f"batch {BATCH}: exported {loaded[str(BATCH)]['request_ms']:.2f} ms, eager "
        f"{eager_ms[BATCH]:.2f} ms; batch 32: exported {loaded['32']['request_ms']:.2f} ms, "
        f"eager {eager_ms[32]:.2f} ms; unbaked (params as input) exported in {unbaked_s:.1f} s, "
        f"max |diff| {u_diff:.3g} (bits equal: {u_same}), launches {u_launches}")
    del model, fwd, unbaked, call
    torch.cuda.empty_cache()
    return loaded[str(BATCH)]["launches"], dict(
        export_s=export_s[BATCH], artifact_gb=sizes[BATCH], max_abs_diff=diff, bits_equal=same,
        request_ms={"exported": {BATCH: loaded[str(BATCH)]["request_ms"],
                                 32: loaded["32"]["request_ms"]},
                    "eager": eager_ms},
        unbaked_max_abs_diff=u_diff)


# -------------------------------------------------------------------- ddp
# expts/02 at 256 features on a tree of 4 train videos of 32 actions (2
# steps of 64) and 1 eval video (1 eval batch), dropout off (plain dropout
# draws per rank), LR scaled by the per-replica batch (scale_lr_by_bs), so
# that 2 ranks x 32 clips and 1 process x 64 take the same LR
DDP_TRAIN_VIDEOS, DDP_EVAL_VIDEOS, DDP_ACTIONS = 4, 1, 32
DDP_STEPS = DDP_TRAIN_VIDEOS * DDP_ACTIONS // TN_BATCH
DDP_TOL = 1e-4  # 2 ranks vs 1 process, relative: f32 sums in another order
DDP_PARAM = "future_predictor.gpt_model.h.0.attn.c_attn.weight"
DDP_OVERRIDES = ["train.num_epochs=1", "opt.scale_lr_by_bs=true", "model.dropout=0.0",
                 "+model.future_predictor.embd_pdrop=0.0", "+model.future_predictor.attn_pdrop=0.0",
                 "+model.future_predictor.resid_pdrop=0.0"]


def timed_make_train_step(train_net, times):
    """A make_train_step for `train_net` whose step appends its own ms (a
    device sync before and after each step) to `times`."""
    real = train_net.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def timed(batch, generator=None):
            torch.cuda.synchronize()
            t0 = time.time()
            metrics = step(batch, generator)
            torch.cuda.synchronize()
            times.append((time.time() - t0) * 1e3)
            return metrics

        return timed

    return make


def ddp_rank_main(argv):
    """One rank of the ddp phase, started by `avt_tpu_torch.launch --spawn`
    in place of `python -m avt_tpu_torch.train_net` with the same arguments:
    `train_net.cli(argv)` recorded (`run_train_net`, each step timed), which
    joins the process group of the launcher's environment; writes what it
    recorded to <run dir>/rank<r>.json."""
    from avt_tpu_torch import train_net

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    times = []
    with mock.patch.object(train_net, "make_train_step", timed_make_train_step(train_net, times)):
        (metric,), rec = run_train_net(argv)
    meters = rec["loggers"][0].meters
    rank = int(os.environ["RANK"])
    out = dict(rank=rank, world=int(os.environ["WORLD_SIZE"]), metric=metric,
               launches=rec["launches"], wall_s=rec["wall_s"],
               losses={k: m.global_avg for k, m in meters.items() if k.startswith("loss")},
               loss_count=meters["loss"].count, step_ms=times)
    with open(os.path.join(argv[argv.index("--run-dir") + 1], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def ddp_phase(card, tmp=None):
    """expts/02 at 256 observed features, 2 steps of 64 clips and 1 eval
    batch, three ways: in this process through `train_net.cli`; as one rank
    of a process group over NCCL; as 2 ranks over gloo on this one card, 32
    + 32 clips a step. The ranks are started by `avt_tpu_torch.launch.main`
    with --spawn, running `ddp_rank_main` (train_net.cli recorded) in place
    of the train_net module; each step is timed with a device sync around
    it (the second step's ms is the one printed: the first warms the
    process up). Checks: each rank's flash launches are 6 + 6 a step and 6
    an eval batch; the one-rank NCCL group equals the process
    bit for bit on the losses and the checkpoint (else the gap is printed);
    the 2 gloo ranks' mean losses, DDP_PARAM in the checkpoint rank 0 wrote,
    and the merged eval results within DDP_TOL of the one-process run's
    (the measured errors printed). Prints the step ms each way. Returns the
    launch counts of each rank, a summary, and the yardstick the tp phase
    holds its ranks against: the tree's overrides, the one-process run's
    directory (under `tmp`, which outlives the call when given), losses and
    first step's ms."""
    from avt_tpu_torch import launch, train_net

    with contextlib.ExitStack() as stack:
        if tmp is None:
            tmp = stack.enter_context(tempfile.TemporaryDirectory())
        t0 = time.time()
        tree = write_ek100_tree(os.path.join(tmp, "tree"), train_videos=DDP_TRAIN_VIDEOS,
                                eval_videos=DDP_EVAL_VIDEOS, actions_per_video=DDP_ACTIONS,
                                first_action_s=TN_FIRST_S, seed=46)
        common = tree + long_context(LONG_T) + DDP_OVERRIDES + [
            f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}"]
        one_dir = os.path.join(tmp, "one")
        one_times = []
        with mock.patch.object(train_net, "make_train_step",
                               timed_make_train_step(train_net, one_times)):
            (one_metric,), one = run_train_net(["--config-file", EXPT_02, "--run-dir", one_dir]
                                               + common + [f"train.batch_size={TN_BATCH}",
                                                           f"eval.batch_size={TN_BATCH}"])
        one_losses = {k: m.global_avg for k, m in one["loggers"][0].meters.items()
                      if k.startswith("loss")}
        one_step_ms = one_times[-1]
        runs = {}
        for label, world, backend in (("ddp_w1_nccl", 1, "nccl"), ("ddp_w2_gloo", 2, "gloo")):
            run_dir = os.path.join(tmp, label)
            bs = TN_BATCH // world
            t1 = time.time()
            with mock.patch.object(launch, "TRAIN_MODULE", "chip_smoke"):
                rcs = launch.main(["-c", EXPT_02, "--spawn", str(world), "--run-dir", run_dir]
                                  + common + [f"dist_backend={backend}",
                                              f"train.batch_size={bs}", f"eval.batch_size={bs}"])
            check(rcs == [0] * world, f"{label}: ranks exited {rcs}")
            ranks = []
            for r in range(world):
                with open(os.path.join(run_dir, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            runs[label] = dict(ranks=ranks, wall_s=time.time() - t1, run_dir=run_dir)
        want = flash_launches(AVTH_LAYERS * (DDP_STEPS + 1), AVTH_LAYERS * DDP_STEPS)
        check(one["launches"] == want, f"ddp one process: launches {one['launches']}, want {want}")
        counts = {"ddp_one": one["launches"]}
        for label, run in runs.items():
            for rank in run["ranks"]:
                counts[f"{label}_rank{rank['rank']}"] = rank["launches"]
                check(rank["launches"] == want and rank["loss_count"] == DDP_STEPS
                      and len(rank["step_ms"]) == DDP_STEPS,
                      f"{label} rank {rank['rank']}: launches {rank['launches']} over "
                      f"{rank['loss_count']} steps, want {want}")
                check(all(np.isfinite(list(rank["losses"].values()))),
                      f"{label} rank {rank['rank']}: losses {rank['losses']}")

        def ckpt(run_dir):
            return torch.load(os.path.join(run_dir, CKPT_NAME), map_location="cpu",
                              weights_only=True)["model"]

        one_ckpt = ckpt(one_dir)
        one_res = read_results(os.path.join(one_dir, RESULTS_SAVE_DIR))
        # one rank of NCCL: the same program as one process, bit for bit
        w1 = runs["ddp_w1_nccl"]
        w1_ckpt = ckpt(w1["run_dir"])
        loss_gap = max(abs(w1["ranks"][0]["losses"][k] - v) for k, v in one_losses.items())
        param_gap = max(float((w1_ckpt[k].float() - v.float()).abs().max())
                        for k, v in one_ckpt.items())
        # two ranks of gloo on one card against one process on the global batch
        w2 = runs["ddp_w2_gloo"]
        w2_losses = {k: float(np.mean([r["losses"][k] for r in w2["ranks"]]))
                     for k in one_losses}
        loss_err = max(abs(w2_losses[k] - v) / max(abs(v), 1e-12) for k, v in one_losses.items())
        p_one, p_two = one_ckpt[DDP_PARAM].float(), ckpt(w2["run_dir"])[DDP_PARAM].float()
        param_err = float((p_two - p_one).abs().max() / p_one.abs().max())
        res = read_results(os.path.join(w2["run_dir"], RESULTS_SAVE_DIR))
        check(np.array_equal(res["idx"], one_res["idx"]), "ddp: merged eval idx differ")
        eval_err = {k: scaled_err(torch.from_numpy(res[k]), torch.from_numpy(one_res[k]))
                    for k in ("logits/action", "loss/cls_action")}
        log(f"ddp ({card}): expts/02 at {LONG_T} features, {DDP_STEPS} steps of {TN_BATCH} clips "
            f"and 1 eval batch, each step timed (ms: the second; first in parentheses). One "
            f"process: {one_step_ms:.2f} ({one_times[0]:.2f}) ms a step, losses "
            + ", ".join(f"{k} {v:.6f}" for k, v in sorted(one_losses.items()))
            + f". One NCCL rank: {w1['ranks'][0]['step_ms'][-1]:.2f} "
            f"({w1['ranks'][0]['step_ms'][0]:.2f}) ms a step; losses "
            + ("equal bit for bit" if loss_gap == 0 else f"differ by up to {loss_gap:.3g}")
            + ", checkpoint "
            + ("equal bit for bit" if param_gap == 0 else f"differs by up to {param_gap:.3g}")
            + f"; launch to exit {w1['wall_s']:.1f} s. Two gloo ranks on one card ("
            f"{TN_BATCH // 2} + {TN_BATCH // 2} clips): "
            + ", ".join(f"{r['step_ms'][-1]:.2f} ({r['step_ms'][0]:.2f})" for r in w2["ranks"])
            + f" ms a step (rank 0, 1); mean losses max relative error {loss_err:.3g}, "
            f"{DDP_PARAM} {param_err:.3g} of its max |value|, merged eval "
            + ", ".join(f"{k} {v:.3g}" for k, v in eval_err.items())
            + f" (limit {DDP_TOL}); launch to exit {w2['wall_s']:.1f} s; launches a rank "
            f"{w2['ranks'][0]['launches']}; tree and runs {time.time() - t0:.1f} s")
        check(loss_err <= DDP_TOL and param_err <= DDP_TOL
              and all(v <= DDP_TOL for v in eval_err.values()),
              f"ddp: 2 ranks vs 1 process: losses {loss_err:.3g}, {DDP_PARAM} {param_err:.3g}, "
              f"eval {eval_err}")
    return counts, dict(one_step_ms=one_step_ms, w1_step_ms=w1["ranks"][0]["step_ms"][-1],
                        w2_step_ms=[r["step_ms"][-1] for r in w2["ranks"]], w1_loss_gap=loss_gap,
                        w1_param_gap=param_gap, w2_loss_rel_err=loss_err,
                        w2_param_rel_err=param_err, w2_eval_err=eval_err), dict(
        common=common, one_dir=one_dir, one_losses=one_losses, one_step_ms=one_step_ms)


# --------------------------------------------------------------------- tp
# tensor parallelism (parallel.model_size=2) as 2 gloo ranks sharing the
# card: expts/02 at 256 features on the ddp phase's tree against its
# one-process run, and the flagship's bf16 train step against one process
TP_MODEL = 2
TP_TOL = 2e-5  # expts/02, f32: 2 model ranks vs 1 process, of each tensor's max |value|
TP_CLIPS = 8  # the flagship step's clips (80 ViT frames) on each rank
# bf16 flagship, 2 model ranks vs 1 process. A row layer's partial
# products are summed in f32 and rounded once to bf16, as one process's
# GEMM rounds its f32 sum once; the sums' orders differ, so an activation
# can land one bf16 step (2^-8 of it) apart, and such steps travel through
# 12 blocks: the tolerances of phase 2's bf16 checks (2e-2 on the loss,
# relative) and of its kernel-vs-plain gradients (GRAD_TOL, 5e-2 of each
# update's max |value|)
TP_LOSS_TOL, TP_UPDATE_TOL = 2e-2, GRAD_TOL
TP_NAMES = ["backbone.model.blocks.0.attn.qkv.weight", "backbone.model.blocks.0.attn.qkv.bias",
            "backbone.model.blocks.11.attn.proj.weight", "backbone.model.blocks.5.mlp.fc1.weight",
            "backbone.model.blocks.5.mlp.fc2.weight", "backbone.model.blocks.0.norm1.bias",
            "backbone.model.patch_embed.proj.weight",
            "future_predictor.gpt_model.h.0.attn.c_attn.weight",
            "future_predictor.gpt_model.h.5.mlp.c_proj.weight", "classifiers.action.weight"]
TP_PACKED = {"short_attention_fwd": VIT_BLOCKS, "short_attention_bwd": VIT_BLOCKS, **NO_OTHER}


def tp_flagship_run(mesh=None):
    """The flagship's bf16 train step (phase 4's, at TP_CLIPS clips, the LR
    schedule without warmup so that both steps move the weights) for 2
    steps, on one process or, with a mesh, as this rank's shard (rank 0's
    weights broadcast first, as train_net does). Returns the losses, each
    step's launches and ms, and the updates of TP_NAMES (gathered)."""
    from avt_tpu_torch.parallel import ddp
    from avt_tpu_torch.parallel.mesh import gather_state_dict, shard_model

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_avt(num_actions=NUM_ACTIONS, vit_dtype=torch.bfloat16, generator=gen)
    if mesh is not None:
        ddp.broadcast_module(model)
        shard_model(model, mesh)
    _, step, _, batch = train_pipeline(model, TP_CLIPS, iters_per_epoch=1, num_epochs=3,
                                       warmup_epochs=0)
    params = dict(model.named_parameters())

    def picked():
        return {n: v.float().cpu() for n, v in gather_state_dict(
            {n: params[n].detach().clone() for n in TP_NAMES}, model).items()}

    before = picked()
    step_gen = torch.Generator(device="cuda").manual_seed(1)
    losses, launches, step_ms = [], [], []
    for _ in range(2):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.time()
        metrics = step(batch, step_gen)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
        launches.append(dict(_build.launch_counts))
        losses.append({k: v.item() for k, v in metrics.items() if k.startswith("loss")})
    after = picked()
    del model, step
    torch.cuda.empty_cache()
    return dict(losses=losses, launches=launches, step_ms=step_ms,
                updates={n: after[n] - before[n] for n in TP_NAMES})


def tp_flagship_rank_main(out_dir):
    """One rank of the tp phase's flagship step, started by `tp_phase` as
    `python -m chip_smoke --tp-flagship-rank <out_dir>` with the rendezvous
    variables set: joins a gloo group on the card, builds the (1, TP_MODEL)
    mesh and runs `tp_flagship_run`; rank 0 writes the result to
    <out_dir>/tp_flagship.pt, every rank its launches and ms to
    <out_dir>/tp_flagship_rank<r>.json."""
    from avt_tpu_torch.parallel import ddp
    from avt_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ddp.setup_distributed("gloo", "cuda")
    res = tp_flagship_run(make_mesh(TP_MODEL))
    rank = ddp.rank()
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "tp_flagship.pt"))
    with open(os.path.join(out_dir, f"tp_flagship_rank{rank}.json"), "w") as f:
        json.dump({k: res[k] for k in ("losses", "launches", "step_ms")}, f)
    ddp.cleanup()


def tp_expt02(card, yard):
    """expts/02 at 256 features, 2 steps of 64 clips and 1 eval batch, as
    TP_MODEL ranks of parallel.model_size=TP_MODEL over gloo on this card
    (`launch.main(... --spawn 2 parallel.model_size=2)`, the ranks running
    `ddp_rank_main`), against the ddp phase's one-process run on the same
    tree: each rank's flash launches (6 + 6 a step, 6 an eval batch, at 2
    heads of 512), both ranks' losses, every tensor of the checkpoint rank
    0 wrote (the one-process layout) and the merged eval results (written
    by model rank 0 alone) within TP_TOL; then the checkpoint in one
    process, `train_net.cli` resuming it (nothing left to train) and
    evaluating, within TP_TOL of the one-process results."""
    from avt_tpu_torch import launch, train_net

    run_dir = os.path.join(os.path.dirname(yard["one_dir"]), "tp")
    common = yard["common"] + [f"train.batch_size={TN_BATCH}", f"eval.batch_size={TN_BATCH}"]
    t0 = time.time()
    with mock.patch.object(launch, "TRAIN_MODULE", "chip_smoke"):
        rcs = launch.main(["-c", EXPT_02, "--spawn", str(TP_MODEL), "--run-dir", run_dir]
                          + common + [f"parallel.model_size={TP_MODEL}", "dist_backend=gloo"])
    wall_s = time.time() - t0
    check(rcs == [0] * TP_MODEL, f"tp expts/02: ranks exited {rcs}")
    ranks = []
    for r in range(TP_MODEL):
        with open(os.path.join(run_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    want = flash_launches(AVTH_LAYERS * (DDP_STEPS + 1), AVTH_LAYERS * DDP_STEPS)
    counts = {}
    for rank in ranks:
        counts[f"tp_expt02_rank{rank['rank']}"] = rank["launches"]
        check(rank["launches"] == want and rank["loss_count"] == DDP_STEPS,
              f"tp expts/02 rank {rank['rank']}: launches {rank['launches']} over "
              f"{rank['loss_count']} steps, want {want}")
    one = yard["one_losses"]
    loss_err = max(abs(rank["losses"][k] - v) / max(abs(v), 1e-12)
                   for rank in ranks for k, v in one.items())

    def ckpt(d):
        return torch.load(os.path.join(d, CKPT_NAME), map_location="cpu", weights_only=True)

    got, ref = ckpt(run_dir), ckpt(yard["one_dir"])
    check(set(got["model"]) == set(ref["model"]) and all(
        got["model"][k].shape == v.shape for k, v in ref["model"].items()),
        "tp expts/02: the checkpoint is not in the one-process layout")
    param_err = max(scaled_err(got["model"][k].float(), v.float())
                    for k, v in ref["model"].items() if v.is_floating_point())
    one_res = read_results(os.path.join(yard["one_dir"], RESULTS_SAVE_DIR))
    res = read_results(os.path.join(run_dir, RESULTS_SAVE_DIR))
    check(sorted(os.listdir(os.path.join(run_dir, RESULTS_SAVE_DIR))) == ["0"],
          "tp expts/02: a model rank other than 0 wrote eval results")
    check(np.array_equal(res["idx"], one_res["idx"]), "tp expts/02: merged eval idx differ")
    eval_err = max(scaled_err(torch.from_numpy(res[k]), torch.from_numpy(one_res[k]))
                   for k in ("logits/action", "loss/cls_action"))
    # the checkpoint in one process: a resume with nothing left to train, an eval
    (_,), rec = run_train_net(["--config-file", EXPT_02, "--run-dir", run_dir] + common)
    check(rec["launches"] == flash_launches(AVTH_LAYERS, 0),
          f"tp expts/02 resumed in one process: launches {rec['launches']}")
    res1 = read_results(os.path.join(run_dir, RESULTS_SAVE_DIR))
    resumed_err = scaled_err(torch.from_numpy(res1["logits/action"]),
                             torch.from_numpy(one_res["logits/action"]))
    log(f"tp ({card}): expts/02 at {LONG_T} features as {TP_MODEL} ranks of "
        f"parallel.model_size={TP_MODEL} (gloo, one card; {AVTH_HEADS // TP_MODEL} heads of "
        f"{AVTH_DIM // AVTH_HEADS} a rank), {DDP_STEPS} steps of {TN_BATCH} clips and 1 eval "
        f"batch: " + ", ".join(f"rank {r['rank']} {r['step_ms'][-1]:.2f} ({r['step_ms'][0]:.2f}) "
                               f"ms a step" for r in ranks)
        + f" (one process: {yard['one_step_ms']:.2f} ms; gloo through the host sets these "
        f"times, not tensor parallelism); against one process: losses {loss_err:.3g} "
        f"relative, checkpoint {param_err:.3g}, merged eval {eval_err:.3g}, the checkpoint "
        f"resumed in one process and evaluated {resumed_err:.3g} (each of its max |value|; "
        f"limit {TP_TOL}); launches a rank {ranks[0]['launches']}; launch to exit "
        f"{wall_s:.1f} s")
    check(max(loss_err, param_err, eval_err, resumed_err) <= TP_TOL,
          f"tp expts/02: losses {loss_err:.3g}, checkpoint {param_err:.3g}, eval "
          f"{eval_err:.3g}, resumed {resumed_err:.3g} (limit {TP_TOL})")
    return counts, dict(step_ms=[r["step_ms"][-1] for r in ranks], loss_rel_err=loss_err,
                        ckpt_err=param_err, eval_err=eval_err, resumed_eval_err=resumed_err)


def tp_flagship(card, tmp):
    """The flagship's bf16 train step in this process, then as TP_MODEL ranks
    of a (1, TP_MODEL) mesh sharing the card (`tp_flagship_rank_main`):
    each rank launches the packed forward and backward (db) kernels 12
    times a step on 6 heads of 64; the losses within TP_LOSS_TOL and the
    updates of TP_NAMES within TP_UPDATE_TOL of one process's."""
    from avt_tpu_torch import launch

    one = tp_flagship_run()
    port = launch._free_port()
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "chip_smoke", "--tp-flagship-rank", tmp],
        env=dict(os.environ, **launch.rank_env(r, TP_MODEL, r, "localhost", port)))
        for r in range(TP_MODEL)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.time() - t0
    check(rcs == [0] * TP_MODEL, f"tp flagship: ranks exited {rcs}")
    tp = torch.load(os.path.join(tmp, "tp_flagship.pt"), weights_only=False)
    counts = {}
    for r in range(TP_MODEL):
        with open(os.path.join(tmp, f"tp_flagship_rank{r}.json")) as f:
            rank = json.load(f)
        counts[f"tp_flagship_rank{r}"] = {k: sum(c[k] for c in rank["launches"])
                                          for k in rank["launches"][0]}
        check(all(c == TP_PACKED for c in rank["launches"]),
              f"tp flagship rank {r}: launches {rank['launches']}, want {TP_PACKED} a step")
    loss_err = max(abs(t[k] - o[k]) / max(abs(o[k]), 1e-12)
                   for t, o in zip(tp["losses"], one["losses"]) for k in o)
    update_err = {n: scaled_err(tp["updates"][n], one["updates"][n]) for n in TP_NAMES}
    check(all(one["updates"][n].abs().max() > 0 for n in TP_NAMES),
          "tp flagship: a compared parameter did not move")
    log(f"tp ({card}): flagship bf16 train step, {TP_CLIPS} clips x {CLIP[0]} frames, 2 steps: "
        f"one process {one['step_ms'][1]:.2f} ({one['step_ms'][0]:.2f}) ms a step; "
        f"{TP_MODEL} ranks of parallel.model_size={TP_MODEL} (gloo, one card; ViT-B/16 at "
        f"{12 // TP_MODEL} heads of 64 a rank) {tp['step_ms'][1]:.2f} ({tp['step_ms'][0]:.2f}) "
        f"ms a step on rank 0 (gloo through the host sets these times, not tensor "
        f"parallelism); losses {loss_err:.3g} relative (limit {TP_LOSS_TOL}), updates "
        + ", ".join(f"{n.split('.', 2)[-1]} {e:.3g}" for n, e in update_err.items())
        + f" of each one-process update's max |value| (limit {TP_UPDATE_TOL}); launches a "
        f"step {TP_PACKED}; ranks' launch to exit {wall_s:.1f} s")
    check(loss_err <= TP_LOSS_TOL and max(update_err.values()) <= TP_UPDATE_TOL,
          f"tp flagship: losses {loss_err:.3g}, updates {update_err}")
    return counts, dict(one_step_ms=one["step_ms"][1], tp_step_ms=tp["step_ms"][1],
                        loss_rel_err=loss_err, update_err=update_err)


def tp_phase(card, yard):
    """Tensor parallelism on the card: `tp_expt02` against the ddp phase's
    one-process run (`yard`), then `tp_flagship`. Returns the launch counts
    of each rank and a summary."""
    counts, summary = tp_expt02(card, yard)
    with tempfile.TemporaryDirectory() as tmp:
        f_counts, summary["flagship"] = tp_flagship(card, tmp)
    counts.update(f_counts)
    return counts, summary


# ------------------------------------------------------------------ featext
# raw video -> expts/01's ViT-B/16 features (f32, the mean over each clip's
# one frame) packed into an npy store -> expts/02 trained on it at 256
# observed features -> EPIC metrics, a self-fusion and the submission zip;
# k-means on the store; attention maps of expts/01's model. 2 train videos
# and 1 eval video of 128 actions a second from 258 s on (256 observed
# seconds before each), 4 fps so that OpenCV decodes the tree quickly:
# 256 train rows (4 batches of 64), 128 eval rows (2 batches), and one more
# eval action 0.5 s in, which the anticipation shift discards
FX_TRAIN_VIDEOS, FX_EVAL_VIDEOS, FX_ACTIONS, FX_FIRST_S = 2, 1, 128, LONG_T + 2
FX_VIDEO = (456, 256, 4)  # 256 px high, as EK100's videos_extension_ht256px
FX_STRIDE = 0.25  # s: store keys 7-8 frames apart at 30 fps, inside the readers' search of 10
FX_EVAL_BATCH, FX_K, VIT_DIM = 64, 64, 768
FX_STEPS = FX_TRAIN_VIDEOS * FX_ACTIONS // TN_BATCH
FX_EVAL_BATCHES = -(-FX_EVAL_VIDEOS * FX_ACTIONS // TN_BATCH)
FX_DISCARDED_UID = 10 ** 6
# every video's dense clips (write_ek100_tree's videos end 2 s after the last action)
FX_CLIPS = round((FX_TRAIN_VIDEOS + FX_EVAL_VIDEOS) * (FX_FIRST_S + FX_ACTIONS + 2) / FX_STRIDE)
FX_VIZ_VIEWS = 6  # expts/01's eval views: 3 crops x 2 flips
# the packed forward's batches on the phase's paths, each checked in phase 2:
# a full extraction batch, the last one, viz_attention's clip of 10 frames
FX_ATTENTION_N = (FX_EVAL_BATCH, FX_CLIPS % FX_EVAL_BATCH, TNR_FRAMES * FX_VIZ_VIEWS)
FX_E2E_TOL = 1e-3  # kernels vs plain attention, of the output's max |value|


def featext_phase(card):
    """The feature-extraction workflow of the port's tools at full width, in
    a scratch working directory: a synthetic EK100 tree of raw videos and a
    seeded timm ViT-B/16 file; `tools/torch_extract_features.py -c
    expts/01_ek100_avt.txt` in this process (ViT-B/16 in f32 at 224, the
    file's weights by init_from_model, the mean aggregator's `temp_agg`,
    one frame a dense clip every FX_STRIDE s over every video, one view,
    extraction batches of FX_EVAL_BATCH): 12 packed forward launches an
    eval batch and nothing else, the first and last batches' features
    against plain attention (within FX_E2E_TOL of their scale), every packed
    row read back through NpyFeatsReader bit for bit, and a profile of one
    extraction batch;
    expts/02 through `train_net.cli` on the store (768-d features, 256
    observed, 4 steps of 64 and 2 eval batches): 6 flash forward + 6
    backward launches a step, 6 an eval batch; on its eval results the
    EPIC metrics, the run fused with itself at (0.5, 0.5) equal to its
    scores bit for bit, and the EK100 submission zip listing every eval uid
    and the discarded one; `tools/torch_compute_centroids.py` (k=FX_K) on
    the store, no launches; `tools/torch_viz_attention.py`'s device part on
    one clip with expts/01's model at output_len 2 (rows summing to 1, the
    causal block's upper triangle 0, the maps within FX_E2E_TOL of plain
    attention's; the figures when matplotlib is there).
    Prints each stage's time beside the card's name and power limit.
    Returns (the launch counts of each path, a summary)."""
    import importlib.util
    import zipfile

    from avt_tpu_torch import train_net
    from avt_tpu_torch.config import Composer, parse_override, parse_overrides_file
    from avt_tpu_torch.config.build import build_dataset
    from avt_tpu_torch.evaluate import analysis, softmax_np
    from avt_tpu_torch.models import import_torch, load_centroids

    here = os.path.dirname(os.path.abspath(__file__))

    def load_tool(name):  # by its path: tools/ also holds the JAX package's tools
        spec = importlib.util.spec_from_file_location(name, os.path.join(here, "tools",
                                                                         f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    torch_compute_centroids = load_tool("torch_compute_centroids")
    txf = load_tool("torch_extract_features")
    torch_viz_attention = load_tool("torch_viz_attention")

    expt01, expt02 = os.path.join(here, EXPT_01), os.path.join(here, EXPT_02)
    counts, summary, cwd = {}, {}, os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # ${cwd} of expts/01's timm path
        try:
            t0 = time.time()
            root = os.path.join(tmp, "tree")
            tree = write_ek100_tree(root, train_videos=FX_TRAIN_VIDEOS,
                                    eval_videos=FX_EVAL_VIDEOS, actions_per_video=FX_ACTIONS,
                                    first_action_s=FX_FIRST_S, seed=47, video=FX_VIDEO)
            rulstm = os.path.join(root, "annotations", "rulstm", "ek100")
            with open(os.path.join(rulstm, "validation.csv"), "a", newline="") as f:
                csv.writer(f).writerow([FX_DISCARDED_UID, "P02_01", 15, 30, 0, 0, 0])
            write_timm_vit(os.path.join(tmp, TIMM_IN21K), seed=48)
            log(f"featext: synthetic EK100 tree ({FX_TRAIN_VIDEOS} + {FX_EVAL_VIDEOS} mp4v videos "
                f"of {FX_VIDEO[0]}x{FX_VIDEO[1]} at {FX_VIDEO[2]} fps, "
                f"{FX_FIRST_S + FX_ACTIONS + 2} s) and the timm file written in "
                f"{time.time() - t0:.1f} s")
            workers = [f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}"]

            # 1. extraction through the tool, in this process ---------------
            run_dir, store = os.path.join(tmp, "featext"), os.path.join(tmp, "store")
            argv = (["-c", expt01, "--run-dir", run_dir, "--out", store, "--stride",
                     str(FX_STRIDE), "--clip-len", "1.0", "--formats", "npy", "--no-verify"]
                    + tree + workers
                    + ["model/temporal_aggregator=mean", "data_eval.num_frames=1",
                       "data_eval.eval_num_crops=1", "data_eval.eval_flip_crops=false",
                       f"eval.batch_size={FX_EVAL_BATCH}",
                       f"dataset_eval.annotation_path=[{rulstm}/training.csv, "
                       f"{rulstm}/validation.csv]"])
            captured, pack_s = {}, []
            real_make_eval, real_pack = train_net.make_eval_step, txf.pack

            def recorded_make_eval(*args, **kwargs):
                step = real_make_eval(*args, **kwargs)

                def recording(batch):  # the run's first and last batches
                    captured.setdefault("first", (step, batch))
                    captured["last"] = (step, batch)
                    return step(batch)

                return recording

            def timed_pack(*args, **kwargs):
                t1 = time.time()
                out = real_pack(*args, **kwargs)
                pack_s.append(time.time() - t1)
                return out

            with mock.patch.object(train_net, "make_eval_step", recorded_make_eval), \
                    mock.patch.object(txf, "pack", timed_pack):
                stats, rec = record_train_net(lambda: txf.main(argv))
            counts["featext"] = rec["launches"]
            n_batches = len(rec["waits"]["eval"])
            want = {**{n: 0 for n in _build.KERNELS},
                    "short_attention_fwd": VIT_BLOCKS * n_batches}
            check(rec["launches"] == want and n_batches == -(-rec["rows"]["eval"]
                                                             // FX_EVAL_BATCH),
                  f"featext: launches {rec['launches']} over {n_batches} batches, want {want}")
            index = txf.read_index(os.path.join(run_dir, txf.INDEX_NAME))
            check(stats["rows"] == len(index) == rec["rows"]["eval"] == FX_CLIPS
                  and stats["skipped"] == 0 and stats["videos"] == FX_TRAIN_VIDEOS + FX_EVAL_VIDEOS,
                  f"featext: packed {stats}, index {len(index)}, rows {rec['rows']}, want "
                  f"{FX_CLIPS}")
            # the first and last batches' features, kernels vs plain attention
            e2e = {}
            for name, (step, batch) in captured.items():
                n = batch["video"].shape[0]
                got = step(batch)["temp_agg"]
                with mock.patch.object(fa, "packed_qkv_bias_attention", plain_bias_attention):
                    want_feats = step(batch)["temp_agg"]
                scale = want_feats.abs().max().item()
                e2e[f"{name}_N{n}"] = diff = (got - want_feats).abs().max().item()
                check(n in FX_ATTENTION_N and diff <= FX_E2E_TOL * scale,
                      f"featext: the {name} batch of {n} clips, kernels vs plain attention "
                      f"differ by {diff} (scale {scale}; kernel checked at N {FX_ATTENTION_N})")
                log(f"featext: the {name} extraction batch ({n} clips), temp_agg kernels vs "
                    f"plain attention: max |diff| {diff:.3g} of scale {scale:.3g} (limit "
                    f"{FX_E2E_TOL} of the scale)")
            t1 = time.time()
            n_read = txf.verify_roundtrip(os.path.join(run_dir, txf.RESULTS_DIR), index, store,
                                          endpoint="temp_agg", n_check=None)
            verify_s = time.time() - t1
            check(n_read == len(index), f"featext: {n_read} readbacks of {len(index)} rows")
            npys = sorted(os.path.join(store, "npy", f) for f in os.listdir(
                os.path.join(store, "npy")))
            store_mb = sum(os.path.getsize(f) for f in npys) / 1e6
            step, batch = captured["first"]
            busy, groups, wall = profile_run(lambda: step(batch), "extraction batch, "
                                             f"{FX_EVAL_BATCH} clips x 1 frame, ViT-B/16 f32")
            packed = groups.get("attention kernel", 0.0)
            captured.clear()
            del step, batch
            eval_wait = rec["waits"]["eval"]
            ext_s = rec["eval_s"][0]
            summary["featext"] = dict(
                clips=len(index), batches=n_batches, extract_s=ext_s,
                clips_per_s=len(index) / ext_s, decode_ms=1e3 * float(np.median(eval_wait)),
                batch_wall_ms=wall, batch_busy_ms=busy, packed_ms=packed,
                packed_share=packed / busy, pack_s=pack_s[0], verify_s=verify_s,
                store_mb=store_mb, groups=groups, kernel_vs_plain=e2e)
            log(f"featext ({card}): expts/01's ViT-B/16 f32 over {len(index)} dense clips "
                f"(every {FX_STRIDE} s, 1 frame, 1 view) in {n_batches} batches of "
                f"{FX_EVAL_BATCH}: {ext_s:.2f} s, {len(index) / ext_s:.2f} clips/s = "
                f"{len(index) / ext_s:.2f} ViT frames/s; decode wait "
                f"{1e3 * np.median(eval_wait):.2f} ms a batch (median of {len(eval_wait)}, max "
                f"{1e3 * max(eval_wait):.2f}); a profiled batch {wall:.2f} ms wall, {busy:.2f} ms "
                f"busy, the packed f32 kernel {packed:.2f} ms ({100 * packed / busy:.1f}% of "
                f"device time); pack {pack_s[0]:.2f} s, {store_mb:.1f} MB of npy store "
                f"({stats['videos']} videos); every row read back bit for bit in "
                f"{verify_s:.2f} s; launches {rec['launches']}")

            # 2. expts/02 trained on the store at 256 features ---------------
            reader = ("{_target_: avt_tpu.data.NpyFeatsReader, root: " + store
                      + "/npy/, read_type: normal, warn_if_using_closeby_frame: false}")
            overrides = (tree[:4] + workers + long_context(LONG_T)
                         + [f"model.backbone_dim={VIT_DIM}", "train.num_epochs=1",
                            "~dataset_train.reader_fn", "~dataset_eval.reader_fn",
                            f"+dataset_train.reader_fn={reader}",
                            f"+dataset_eval.reader_fn={reader}"])
            train_dir = os.path.join(tmp, "train")
            (metric,), rec2 = run_train_net(["--config-file", expt02, "--run-dir", train_dir]
                                            + overrides)
            counts["featext_train"] = rec2["launches"]
            want = flash_launches(AVTH_LAYERS * (FX_STEPS + FX_EVAL_BATCHES),
                                  AVTH_LAYERS * FX_STEPS)
            check(rec2["launches"] == want,
                  f"featext_train: launches {rec2['launches']}, want {want}")
            meters = rec2["loggers"][0].meters
            losses = {k: m.global_avg for k, m in meters.items() if k.startswith("loss")}
            check(meters["loss"].count == FX_STEPS and all(np.isfinite(list(losses.values())))
                  and np.isfinite(metric) and rec2["rows"] == {
                      "train": FX_TRAIN_VIDEOS * FX_ACTIONS, "eval": FX_EVAL_VIDEOS * FX_ACTIONS},
                  f"featext_train: losses {losses}, metric {metric}, rows {rec2['rows']}")
            loop_ms = TN_BATCH / meters["clips/s"].median * 1e3
            wait_ms = 1e3 * float(np.median(rec2["waits"]["train"]))
            summary["featext_train"] = dict(loop_ms=loop_ms, data_wait_ms=wait_ms,
                                            losses=losses, metric=metric)
            log(f"featext_train ({card}): expts/02 on the extracted {VIT_DIM}-d store at "
                f"{LONG_T} observed features, {FX_STEPS} steps of {TN_BATCH} clips, "
                f"{FX_EVAL_BATCHES} eval batches: the loop {loop_ms:.2f} ms a step, host data "
                f"{wait_ms:.2f} ms a train batch (median); losses "
                + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
                + f"; final_acc/action/AR5 {metric:.4f}; cli {rec2['wall_s']:.1f} s; launches "
                f"{rec2['launches']}")

            # 3. the analysis of that run's eval results ---------------------
            t1 = time.time()
            cfg = Composer(os.path.join(here, "conf")).compose("config", parse_overrides_file(
                expt02) + [parse_override(o) for o in overrides])
            ds = build_dataset(cfg["dataset_eval"], cfg["data_eval"])
            accs, scores = analysis.get_marginalized_scores(os.path.join(train_dir, "results"), ds)
            run = analysis.scores_with_uids([scores[0], scores[1], softmax_np(scores[2])], ds)
            fused_accs, fused = analysis.late_fuse([run, run], weights=[0.5, 0.5], dataset=ds)
            sub_dir = os.path.join(tmp, "challenge")
            analysis.package_results_for_submission_ek100(fused, ds, sub_dir, uid_key="uid")
            with zipfile.ZipFile(os.path.join(sub_dir, "submit.zip")) as zf:
                submitted = json.loads(zf.read("test.json"))
            analysis_s = time.time() - t1
            want_uids = {str(u) for u in ds.df["uid"]} | {str(FX_DISCARDED_UID)}
            check(all(np.isfinite(accs[k]) for k in ("vtop1", "ntop5", "arec5", "atop1"))
                  and len(ds.df) == FX_EVAL_VIDEOS * FX_ACTIONS and len(ds.discarded_df) == 1,
                  f"featext analysis: metrics {accs}, rows {len(ds.df)}")
            check(all(np.array_equal(f[u], r[u]) for f, r in zip(fused, run) for u in r)
                  and fused_accs["arec5"] == analysis.compute_accuracies_epic(
                      [scores[0], scores[1], softmax_np(scores[2])], ds)["arec5"],
                  "featext analysis: the run fused with itself differs from the run")
            check(set(submitted["results"]) == want_uids and submitted["sls_pt"] == 1,
                  f"featext analysis: test.json lists {len(submitted['results'])} uids, want "
                  f"{len(want_uids)}")
            summary["analysis"] = dict(seconds=analysis_s, arec5=accs["arec5"],
                                       vtop1=accs["vtop1"], uids=len(submitted["results"]))
            log(f"featext analysis ({card}): EPIC metrics (verb/noun marginalized from "
                f"{NUM_ACTIONS} actions) " + "; ".join(analysis.format_accuracies_epic(accs))
                + f"; self-fusion equal to the run; test.json of {len(submitted['results'])} "
                f"uids (one discarded) in submit.zip; {analysis_s:.2f} s")

            # 4. k-means centroids over the store ----------------------------
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t1 = time.time()
            torch_compute_centroids.main(npys + ["-k", str(FX_K), "-o",
                                                 os.path.join(tmp, "centroids.npy")])
            torch.cuda.synchronize()
            cent_s = time.time() - t1
            cents = load_centroids(os.path.join(tmp, "centroids.npy"))
            check(dict(_build.launch_counts) == {n: 0 for n in _build.KERNELS}
                  and cents.shape == (FX_K, VIT_DIM) and np.isfinite(cents).all(),
                  f"featext centroids: {cents.shape}, launches {dict(_build.launch_counts)}")
            summary["centroids_s"] = cent_s
            log(f"featext centroids ({card}): k={FX_K} over the store's {len(index)} features "
                f"in {cent_s:.2f} s (50 iterations)")

            # 5. attention maps of expts/01's model at output_len 2 ----------
            vcfg = torch_viz_attention.compose(expt01, tree + [
                "model.future_predictor.output_len=2"])
            frames = torch_viz_attention.decode_frames(
                os.path.join(root, "videos", "P02", "P02_01.MP4"), FX_FIRST_S - 10.0,
                float(FX_FIRST_S), vcfg["data_eval"]["num_frames"])
            model = train_net.build_model(vcfg, {"action": NUM_ACTIONS}, {}, device="cuda")
            import_torch.init_from_model(model, vcfg["train"]["init_from_model"])
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t1 = time.time()
            maps = torch_viz_attention.attention_maps(vcfg, frames, model=model, device="cuda")
            viz_ms = 1e3 * (time.time() - t1)
            counts["viz_attention"] = dict(_build.launch_counts)
            T = TNR_FRAMES
            want = {**{n: 0 for n in _build.KERNELS}, "short_attention_fwd": VIT_BLOCKS}
            att0, att1 = maps.get("gpt2_att_0"), maps.get("gpt2_att_1")
            check(counts["viz_attention"] == want and sorted(maps) == ["gpt2_att_0", "gpt2_att_1"]
                  and att0.shape == (AVTH_LAYERS, AVTH_HEADS, T, T)
                  and att1.shape == (AVTH_LAYERS, AVTH_HEADS, 1, T + 1),
                  f"viz_attention: launches {counts['viz_attention']}, maps "
                  f"{ {k: v.shape for k, v in maps.items()} }")
            row_err = max(float(np.abs(m.sum(-1) - 1).max()) for m in maps.values())
            upper = float(np.abs(np.triu(att0, 1)).max())
            check(row_err <= 1e-5 and upper == 0.0,
                  f"viz_attention: rows sum to 1 within {row_err:.3g}, upper triangle {upper}")
            with mock.patch.object(fa, "packed_qkv_bias_attention", plain_bias_attention):
                plain_maps = torch_viz_attention.attention_maps(vcfg, frames, model=model,
                                                                device="cuda")
            map_diff = max(float(np.abs(maps[k] - plain_maps[k]).max()) for k in maps)
            check(map_diff <= FX_E2E_TOL, f"viz_attention: maps with kernels vs plain attention "
                  f"differ by {map_diff} (limit {FX_E2E_TOL}), N={T * FX_VIZ_VIEWS} checked in "
                  f"phase 2: {T * FX_VIZ_VIEWS in FX_ATTENTION_N}")
            figures = "no matplotlib: figures skipped"
            if importlib.util.find_spec("matplotlib") is not None:
                written = torch_viz_attention.render(maps, frames, os.path.join(tmp, "viz"))
                check(len(written) == 4 and all(os.path.getsize(w) > 0 for w in written),
                      f"viz_attention: figures {written}")
                figures = f"{len(written)} figures"
            del model
            torch.cuda.empty_cache()
            summary["viz_attention"] = dict(forward_ms=viz_ms, row_err=row_err,
                                            kernel_vs_plain=map_diff)
            log(f"viz_attention ({card}): expts/01's model (ViT-B/16 f32 + AVT-h) on one clip "
                f"of {T} frames x {FX_VIZ_VIEWS} views, rollout of 2: maps "
                f"{[m.shape for m in maps.values()]}, rows sum to 1 within {row_err:.2e}, "
                f"causal upper triangle 0, max |diff| {map_diff:.3g} from plain attention (limit "
                f"{FX_E2E_TOL}); {viz_ms:.2f} ms "
                f"(first call, with the decode's preprocessing); {figures}; launches "
                f"{counts['viz_attention']}")
        finally:
            os.chdir(cwd)
    return counts, summary


# ---------------------------------------------------------------------- mha
# multi_head_attention at AVT-h's width (4 heads of 512, f32) on expts/02's
# batch of 64: 256 queries over 383 keys (the length of the long rollout's
# last pass), causal and not, and a self-attention over the 256
MHA_TK = RO_LONG_T
MHA_FLASH = (FEAT_BATCH, LONG_T, AVTH_HEADS, AVTH_DIM // AVTH_HEADS)  # (B, Tq, H, D)
MHA_CASES = {"cross_causal": (True, False), "cross": (False, False),
             "self_causal": (True, True)}  # label: (causal, self-attention)
MHA_WEIGHTS, MHA_BIASES = ("wq", "wk", "wv", "wo"), ("bq", "bk", "bv", "bo")


class PlainFlash(torch.autograd.Function):
    """The flash kernels' plain versions under autograd: the forward
    `flash_attention_reference`, the backward `flash_attention_bwd_reference`."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = fa.flash_attention_reference(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*fa.flash_attention_bwd_reference(q, k, v, dout.contiguous(), out, lse,
                                                  ctx.causal), None)


def plain_flash_attention(q, k, v, causal=False):
    return PlainFlash.apply(q, k, v, causal)


def mha_inputs(seed):
    """x_q (64, 256, 2048), x_kv (64, 383, 2048), the four (2048, 2048)
    weights at 1/sqrt(2048), the four biases at 0.1 and dout, f32 on the
    card."""
    rng = np.random.default_rng(seed)
    B, Tq, _, _ = MHA_FLASH

    def t(shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, np.float32)).cuda()

    arrays = {"x_q": t((B, Tq, AVTH_DIM)), "x_kv": t((B, MHA_TK, AVTH_DIM))}
    arrays.update({w: t((AVTH_DIM, AVTH_DIM), AVTH_DIM ** -0.5) for w in MHA_WEIGHTS})
    arrays.update({b: t((AVTH_DIM,), 0.1) for b in MHA_BIASES})
    return arrays, t((B, Tq, AVTH_DIM))


def mha_run(arrays, dout, causal, self_attention):
    """multi_head_attention forward and backward: (out, {input: gradient},
    launches, ms), with the counts set to 0 just before."""
    names = [n for n in arrays if not (self_attention and n == "x_kv")]
    leaves = {n: arrays[n].detach().requires_grad_(True) for n in names}
    kv = leaves["x_q"] if self_attention else leaves["x_kv"]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.time()
    out = multi_head_attention(leaves["x_q"], kv, *(leaves[w] for w in MHA_WEIGHTS), AVTH_HEADS,
                               causal=causal, **{b: leaves[b] for b in MHA_BIASES})
    grads = torch.autograd.grad(out, list(leaves.values()), dout)
    torch.cuda.synchronize()
    return (out.detach(), dict(zip(leaves, grads)), dict(_build.launch_counts),
            (time.time() - t0) * 1e3)


def mha_phase(card):
    """`multi_head_attention` (avt_tpu_torch.ops), the public function, at
    AVT-h's width: for each of MHA_CASES one forward and one backward to
    every input, weight and bias, 1 flash forward + 1 backward launch each,
    against the same calls with the flash kernels' plain versions in their
    place (`PlainFlash`): the output and every gradient within TOL[f32] of
    its max |value| (the key bias's gradient, 0 but for rounding since a
    shift common to all keys leaves the softmax as it is, of the query
    bias's). Returns (the launch counts of each case, {case: errors})."""
    arrays, dout = mha_inputs(45)
    counts, summary = {}, {}
    tol = TOL[torch.float32]
    for label, (causal, self_attention) in MHA_CASES.items():
        out, grads, launches, ms = mha_run(arrays, dout, causal, self_attention)
        check(launches == flash_launches(1, 1), f"mha {label}: launches {launches}, want one "
              "flash forward and one backward")
        with mock.patch.object(fa, "flash_attention", plain_flash_attention):
            ref, ref_grads, plain_launches, plain_ms = mha_run(arrays, dout, causal,
                                                               self_attention)
        check(plain_launches == flash_launches(0), f"mha {label}: the plain run launched "
              f"{plain_launches}")
        errs = {"out": scaled_err(out, ref)}
        for name, g in grads.items():
            scale = ref_grads["bq" if name == "bk" else name].float().abs().max().clamp_min(1e-12)
            errs[f"d{name}"] = ((g.float() - ref_grads[name].float()).abs().max() / scale).item()
        finite = bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(g).all())
                                                        for g in grads.values())
        check(finite and max(errs.values()) <= tol, f"mha {label}: errors {errs} (tolerance "
              f"{tol}), finite {finite}")
        Tk = LONG_T if self_attention else MHA_TK
        counts[f"mha_{label}"] = launches
        summary[label] = dict(shape=[FEAT_BATCH, LONG_T, Tk, AVTH_HEADS, AVTH_DIM // AVTH_HEADS],
                              causal=causal, max_err=max(errs.values()), errors=errs, ms=ms,
                              plain_ms=plain_ms)
        log(f"mha {label} ({card}): multi_head_attention f32, x_q ({FEAT_BATCH}, {LONG_T}, "
            f"{AVTH_DIM}) over x_kv ({FEAT_BATCH}, {Tk}, {AVTH_DIM}), {AVTH_HEADS} heads, "
            f"causal={causal}, biases: forward + backward {ms:.2f} ms (plain flash versions "
            f"{plain_ms:.2f}, first calls); against the plain versions: " + ", ".join(
                f"{k} {v:.3g}" for k, v in errs.items()) + f" of max |ref| (tolerance {tol}); "
            f"launches {launches}")
    del arrays, dout
    torch.cuda.empty_cache()
    return counts, summary


# ------------------------------------------------ train steps, card vs CPU
CPU_TOL = 1e-4  # one train step's losses and gradients, card vs CPU, of each's max |value|


@contextlib.contextmanager
def cpu_draws(seed):
    """Every torch.rand inside drawn on the CPU from one generator seeded
    `seed`, then moved to the device asked for: the dropout masks and the
    cloze draw (`models/temporal_agg.py:_uniform`) are then the same on the
    card and on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    rand = torch.rand

    def draw(*size, generator=None, device=None, **kwargs):
        x = rand(*size, generator=gen, **kwargs)
        return x if device is None else x.to(device)

    with mock.patch.object(torch, "rand", draw):
        yield


def to_device(x, device):
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    return x.to(device) if isinstance(x, torch.Tensor) else x


def softplus(x, inplace=False):
    """In F.relu's place (nn.ReLU calls it too): a ReLU input within
    rounding of 0 flips between two f32 programs and moves the gradient of
    the weights before it, where the smooth softplus moves it by rounding."""
    return F.softplus(x)


def train_grads(model, batch, loss_wts, num_classes, seed, relu=F.relu):
    """One train step's forward and backward without the update, as
    make_train_step runs them, every torch.rand from `cpu_draws(seed)`,
    `relu` in F.relu's place: ({loss: value}, {parameter: gradient})."""
    model.train()
    model.zero_grad(set_to_none=True)
    with cpu_draws(seed), mock.patch.object(F, "relu", relu):
        _, losses, aux, _ = _forward(model, batch["video"], batch, num_classes, None)
    losses.update(aux)
    total, mean_losses = weighted_loss_sum(losses, loss_wts)
    total.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return {k: v.item() for k, v in mean_losses.items()}, grads


def train_grads_vs_cpu(model, batch, loss_wts, num_classes, seed, relu=F.relu):
    """`train_grads` on the card and on a CPU copy of the model and the
    batch, the port's CPU path (which the CPU tests hold against avt_tpu),
    with the same draws and `relu`. Returns dict(losses= the card's, loss_err= the
    largest relative difference, grad_err= the largest max |diff| of a
    gradient over its max |value|, worst_grad= its name, launches= the
    card's, cpu_s)."""
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    losses, grads = train_grads(model, batch, loss_wts, num_classes, seed, relu)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    t0 = time.time()
    cpu_losses, cpu_grads = train_grads(copy.deepcopy(model).to("cpu"), to_device(batch, "cpu"),
                                        loss_wts, num_classes, seed, relu)
    check(set(grads) == set(cpu_grads) and set(losses) == set(cpu_losses),
          f"card vs CPU: gradients {sorted(set(grads) ^ set(cpu_grads))}, losses "
          f"{sorted(losses)} vs {sorted(cpu_losses)}")
    grad_errs = {n: scaled_err(g.cpu(), cpu_grads[n]) for n, g in grads.items()}
    worst = max(grad_errs, key=grad_errs.get)
    return dict(
        losses=losses, launches=launches, cpu_s=time.time() - t0,
        loss_err=max(abs(losses[k] - v) / max(abs(v), 1e-12) for k, v in cpu_losses.items()),
        grad_err=grad_errs[worst], worst_grad=worst)


def recording_plateau(records):
    """A ReduceLROnPlateau for `train_net` that records its keyword
    arguments and, at each step, the metric, each group's multiplier before
    and after (None for a group without one) and its state after."""

    class Recorded(ReduceLROnPlateau):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            records.append({"kwargs": kwargs, "steps": []})

        def step(self, optimizer, metric):
            mults = [None if g.plateau is None else g.plateau.mult for g in optimizer.groups]
            floors = [None if g.plateau is None else g.plateau.floor for g in optimizer.groups]
            super().step(optimizer, metric)
            records[-1]["steps"].append(dict(
                metric=float(metric), before=mults, floors=floors, state=self.state_dict(),
                after=[None if g.plateau is None else g.plateau.mult for g in optimizer.groups]))

    return Recorded


def replay_plateau(record):
    """The recorded steps replayed by a ReduceLROnPlateau in this process on
    the same metrics, from the first step's multipliers: [(multipliers,
    state) after each step]."""
    plateau = ReduceLROnPlateau(**record["kwargs"])
    first = record["steps"][0]
    groups = [types.SimpleNamespace(plateau=None if m is None else Plateau(m, f))
              for m, f in zip(first["before"], first["floors"])]
    out = []
    for s in record["steps"]:
        plateau.step(types.SimpleNamespace(groups=groups), s["metric"])
        out.append(([None if g.plateau is None else g.plateau.mult for g in groups],
                    plateau.state_dict()))
    return out


def adafactor_vs_cpu(model, optimizer, batch, loss_wts, num_classes):
    """One Adafactor update on the card, and the same update by an Adafactor
    in this process over CPU copies of the parameters, the gradients (the
    card's, of one forward and backward on `batch`) and the state (count,
    row, col, v): {what: the largest max |card - CPU| of a tensor over its
    max |value|} for the parameters, their updates and each moment, and the
    CPU step's seconds."""
    _, grads = train_grads(model, batch, loss_wts, num_classes, seed=49)
    params = dict(model.named_parameters())
    names = [n for g in optimizer.groups for n in g.names]
    before = {n: params[n].detach().to("cpu", copy=True) for n in names}
    cpu_params = {n: torch.nn.Parameter(before[n].clone()) for n in names}
    for n in names:
        params[n].grad = grads.get(n)
        cpu_params[n].grad = None if n not in grads else grads[n].to("cpu", copy=True)
    groups = [ParamGroup(list(g.names), [cpu_params[n] for n in g.names], g.weight_decay,
                         g.schedule, g.label, copy.copy(g.plateau)) for g in optimizer.groups]
    cpu_opt = Adafactor(groups, grad_clip_max_norm=optimizer.grad_clip_max_norm,
                        frozen=optimizer.frozen, conv_weights=optimizer.conv_weights)
    cpu_opt.count = optimizer.count
    cpu_opt.state = {kind: {n: t.to("cpu", copy=True) for n, t in d.items()}
                     for kind, d in optimizer.state.items()}
    t0 = time.time()
    cpu_opt.step()
    cpu_s = time.time() - t0
    optimizer.step()
    torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    after = {n: params[n].detach().cpu() for n in names}
    errs = {"params": max(scaled_err(after[n], cpu_params[n].detach()) for n in names),
            "updates": max(scaled_err(after[n] - before[n], cpu_params[n].detach() - before[n])
                           for n in names)}
    for kind, state in optimizer.state.items():
        errs[kind] = max(scaled_err(t.cpu(), cpu_opt.state[kind][n]) for n, t in state.items())
    return errs, cpu_s


def loop_losses(rec, label, steps, epochs=1):
    """The loss meters of the run's first epoch, checked: `steps` steps in
    each of `epochs` epochs, every loss finite."""
    counts = [logger.meters["loss"].count for logger in rec["loggers"]]
    meters = rec["loggers"][0].meters
    losses = {k: m.global_avg for k, m in meters.items() if k.startswith("loss")}
    check(counts == [steps] * epochs and all(np.isfinite(list(losses.values()))),
          f"{label}: losses {losses}, steps an epoch {counts}, want {steps} in {epochs}")
    return losses


# ------------------------------------------------------- adafactor_plateau
# expts/02 at 256 observed features with opt/optimizer=adafactor and
# opt/scheduler=reduce_lr_on_plateau on 4 train videos and 2 eval videos of
# the train_net tree's kind: 2 epochs of 2 steps of 64, an eval batch after
# each. Patience 0 and an absolute threshold that no eval can beat make
# every eval after the first a bad one, so the plateau reduces at the
# second. Adafactor's relative step ignores the LR, so its groups carry no
# multiplier (as in the reference and avt_tpu); the multiplier is read in a
# second run with expts/02's own SGD at 10 features.
AP_EPOCHS, AP_TRAIN_VIDEOS, AP_EVAL_VIDEOS = 2, 4, 2
AP_STEPS = AP_TRAIN_VIDEOS * TN_ACTIONS // TN_BATCH
AP_EVAL_BATCHES = -(-AP_EVAL_VIDEOS * TN_ACTIONS // TN_BATCH)
PLATEAU_OVERRIDES = ["opt/scheduler=reduce_lr_on_plateau", "opt.scheduler.patience=0",
                     "+opt.scheduler.threshold_mode=abs", "+opt.scheduler.threshold=1e9",
                     f"train.num_epochs={AP_EPOCHS}"]
ADAFACTOR_TOL = 1e-5  # one update, card vs CPU, of each tensor's max |value|


def check_plateau(record, label, want_fall):
    """The recorded plateau steps (one an eval) against `replay_plateau`,
    exactly; with `want_fall`, a multiplier that falls by the factor at one
    step at least. Returns the multipliers after each step."""
    replay = replay_plateau(record)
    got = [(s["after"], s["state"]) for s in record["steps"]]
    check(len(got) == AP_EPOCHS and got == replay, f"{label}: the plateau's steps {got}, "
          f"replayed in this process {replay}")
    factor = np.float32(record["kwargs"]["factor"])
    falls = [i for i, s in enumerate(record["steps"])
             if any(b is not None and a == float(np.float32(b) * factor) and a < b
                    for b, a in zip(s["before"], s["after"]))]
    check(bool(falls) == want_fall, f"{label}: multipliers {[s['after'] for s in record['steps']]}"
          f", falls at steps {falls}")
    return [s["after"] for s in record["steps"]]


def adafactor_plateau_phase(card):
    """(a) expts/02's lines (but its nesterov option, which Adafactor does
    not take) at 256 observed features with Adafactor and the plateau
    scheduler (PLATEAU_OVERRIDES) through `train_net.cli` on a synthetic
    tree: 2 epochs of 2 steps of 64, each followed by an eval batch; 6 + 6
    flash launches a step, 6 an eval batch; finite losses; the
    plateau stepped once an eval, its state equal to a replay in this
    process, and no group with a multiplier; then one Adafactor update on
    the trained state, card against CPU (`adafactor_vs_cpu`): parameters,
    row, col and v within ADAFACTOR_TOL. (b) expts/02 from its file (SGD) at
    10 features with the same plateau: no launches; the multipliers after
    each eval equal to the replay's exactly, and they fall by the factor at
    the second. Returns (the launch counts of each run, a summary)."""
    from avt_tpu_torch import train_net

    counts, summary = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tree = write_ek100_tree(os.path.join(tmp, "tree"), train_videos=AP_TRAIN_VIDEOS,
                                eval_videos=AP_EVAL_VIDEOS, actions_per_video=TN_ACTIONS,
                                first_action_s=TN_FIRST_S, seed=47)
        common = tree + [f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}"]
        captured, optimizers, records = [], [], []
        argv = (["--run-dir", os.path.join(tmp, "adafactor")]
                + expt_lines(EXPT_02, ("opt.optimizer.nesterov",)) + common + long_context(LONG_T)
                + ["opt/optimizer=adafactor"] + PLATEAU_OVERRIDES)
        with mock.patch.object(train_net, "make_train_step", recording_make_train_step(
                train_net, captured, optimizers=optimizers)), \
                mock.patch.object(train_net, "ReduceLROnPlateau", recording_plateau(records)):
            (metric,), rec = run_train_net(argv)
        steps = AP_EPOCHS * AP_STEPS
        want = flash_launches(AVTH_LAYERS * (steps + AP_EPOCHS * AP_EVAL_BATCHES),
                              AVTH_LAYERS * steps)
        check(rec["launches"] == want, f"adafactor_plateau: launches {rec['launches']}, want "
              f"{want}")
        check(rec["epochs"] == list(range(AP_EPOCHS)) and len(rec["eval_s"]) == AP_EPOCHS
              and np.isfinite(metric), f"adafactor_plateau: epochs {rec['epochs']}, evals "
              f"{len(rec['eval_s'])}, metric {metric}")
        losses = loop_losses(rec, "adafactor_plateau", AP_STEPS, AP_EPOCHS)
        optimizer = optimizers[0]
        check(type(optimizer) is Adafactor and optimizer.count == steps
              and all(g.plateau is None for g in optimizer.groups) and len(records) == 1,
              f"adafactor_plateau: optimizer {type(optimizer).__name__} at count "
              f"{optimizer.count}, multipliers {[g.plateau for g in optimizer.groups]}, "
              f"{len(records)} plateaus")
        plateau_steps = check_plateau(records[0], "adafactor_plateau", want_fall=False)
        counts["adafactor_plateau"] = rec["launches"]
        model, loss_wts, num_classes, batch, _ = captured[0]
        del captured[:]
        errs, cpu_s = adafactor_vs_cpu(model, optimizer, batch, loss_wts, num_classes)
        checked = {k: v for k, v in errs.items() if k != "updates"}
        check(max(checked.values()) <= ADAFACTOR_TOL, f"adafactor_plateau: one update, card vs "
              f"CPU: {errs} (tolerance {ADAFACTOR_TOL} but for the updates)")
        n_params = sum(p.numel() for g in optimizer.groups for p in g.params)
        clips_s = rec["loggers"][0].meters["clips/s"]
        summary["adafactor"] = dict(loop_ms=TN_BATCH / clips_s.median * 1e3, losses=losses,
                                    metric=metric, card_vs_cpu=errs, cpu_step_s=cpu_s,
                                    parameters=n_params, plateau_multipliers=plateau_steps)
        log(f"adafactor_plateau ({card}): expts/02 at {LONG_T} features with Adafactor and "
            f"ReduceLROnPlateau (patience 0), {AP_EPOCHS} epochs of {AP_STEPS} steps of "
            f"{TN_BATCH}, an eval after each; the loop {summary['adafactor']['loop_ms']:.2f} ms "
            f"a step; losses " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
            + f"; final_acc/action/AR5 {metric:.4f}; the plateau's steps equal to the replay, no "
            f"multiplier (Adafactor); one update of {n_params} parameters card vs CPU: "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" of max |value| (tolerance {ADAFACTOR_TOL}, the updates unchecked: one rounding "
            f"of p + update apart); CPU step {cpu_s:.2f} s; launches {rec['launches']}")
        del model, optimizer, optimizers[:], batch
        torch.cuda.empty_cache()

        records = []
        argv = (["--config-file", EXPT_02, "--run-dir", os.path.join(tmp, "sgd")] + common
                + PLATEAU_OVERRIDES)
        with mock.patch.object(train_net, "ReduceLROnPlateau", recording_plateau(records)):
            (metric,), rec = run_train_net(argv)
    check(rec["launches"] == flash_launches(0), f"plateau sgd: launches {rec['launches']}")
    check(rec["epochs"] == list(range(AP_EPOCHS)) and len(records) == 1 and np.isfinite(metric),
          f"plateau sgd: epochs {rec['epochs']}, {len(records)} plateaus, metric {metric}")
    losses = loop_losses(rec, "plateau sgd", AP_STEPS, AP_EPOCHS)
    mults = check_plateau(records[0], "plateau sgd", want_fall=True)
    counts["plateau_sgd"] = rec["launches"]
    summary["plateau_sgd"] = dict(multipliers=mults, metrics=[s["metric"] for s in
                                                              records[0]["steps"]])
    log(f"adafactor_plateau sgd ({card}): expts/02 as shipped (nesterov SGD) at {SHORT_T} "
        f"features with ReduceLROnPlateau (patience 0, factor {records[0]['kwargs']['factor']}), "
        f"{AP_EPOCHS} epochs: multipliers after each eval {mults} (metrics "
        f"{summary['plateau_sgd']['metrics']}), equal to the replay in this process; losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
        + f"; launches {rec['launches']}")
    return counts, summary


# ------------------------------------------------------------- rulstm_train
# expts/05 trained: 16 train videos and 4 eval videos of 32 actions a second
# from 5 s on (11 features at 30 fps over tau_o 2.5 s fit before each), so
# 512 train rows (4 steps of the file's batch of 128) and 128 eval rows
RT_TRAIN_VIDEOS, RT_EVAL_VIDEOS, RT_ACTIONS, RT_FIRST_S = 16, 4, 32, 5
RT_STEPS = RT_TRAIN_VIDEOS * RT_ACTIONS // RULSTM_BATCH


def rulstm_train_phase(card):
    """expts/05 from its experiment file through `train_net.cli` with
    test_only=false and 1 epoch: the seeded RULSTM file (`write_rulstm`)
    loaded through its two-entry `train.init_from_model` spec, 4 train steps
    of 128 and an eval of 1 batch on a synthetic tree read the RULSTM way;
    no launches; finite losses and metric. Then one train step's losses and
    gradients (the aggregator's and the action classifier's) on the trained
    weights and the first batch, card against CPU (`train_grads_vs_cpu`,
    the same dropout masks) within CPU_TOL. Returns (the launch counts,
    a summary)."""
    from avt_tpu_torch import train_net

    captured = []
    expt = os.path.join(os.path.dirname(os.path.abspath(__file__)), EXPT_05)
    with tempfile.TemporaryDirectory() as tmp:
        tree = write_ek100_tree(os.path.join(tmp, "tree"), train_videos=RT_TRAIN_VIDEOS,
                                eval_videos=RT_EVAL_VIDEOS, actions_per_video=RT_ACTIONS,
                                first_action_s=RT_FIRST_S, seed=50, read_type="exact_rulstm")
        ckpt = os.path.join(tmp, "RULSTM-anticipation_0.25_6_8_rgb_mt5r_best.pth.tar")
        write_rulstm(ckpt, seed=51)
        argv = ["--config-file", expt, "--run-dir", os.path.join(tmp, "run")] + tree + [
            f"train.init_from_model=[[temporal_aggregator,{ckpt}],"
            f"[classifiers.action,classifier.1.,{ckpt}]]",
            f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}",
            "test_only=false", "train.num_epochs=1"]
        with mock.patch.object(train_net, "make_train_step",
                               recording_make_train_step(train_net, captured)):
            (metric,), rec = run_train_net(argv)
    check(rec["launches"] == flash_launches(0), f"rulstm_train: launches {rec['launches']}")
    check(rec["epochs"] == [0] and len(rec["finals"]) == 1 and np.isfinite(metric),
          f"rulstm_train: epochs {rec['epochs']}, finals {rec['finals']}, metric {metric}")
    losses = loop_losses(rec, "rulstm_train", RT_STEPS)
    model, loss_wts, num_classes, batch, _ = captured.pop()
    check(tuple(batch["video"].shape) == (RULSTM_BATCH, 1, FEAT_DIM, 11, 1, 1),
          f"rulstm_train: batch {tuple(batch['video'].shape)}")
    cmp = train_grads_vs_cpu(model, batch, loss_wts, num_classes, seed=52)
    check(cmp["launches"] == flash_launches(0) and max(cmp["loss_err"], cmp["grad_err"]) <= CPU_TOL
          and all(np.isfinite(list(cmp["losses"].values()))),
          f"rulstm_train: card vs CPU {cmp} (tolerance {CPU_TOL})")
    clips_s = rec["loggers"][0].meters["clips/s"]
    summary = dict(loop_ms=RULSTM_BATCH / clips_s.median * 1e3, losses=losses, metric=metric,
                   **{k: cmp[k] for k in ("loss_err", "grad_err", "cpu_s")})
    log(f"rulstm_train ({card}): expts/05 trained (test_only=false, 1 epoch of {RT_STEPS} steps "
        f"of {RULSTM_BATCH}, RULSTM 1024 wide from the seeded file, dropout 0.8), rows train "
        f"{rec['rows']['train']} / eval {rec['rows']['eval']}; the loop "
        f"{summary['loop_ms']:.2f} ms a step; losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
        + f"; final_acc/action/AR5 {metric:.4f}; one step card vs CPU: losses "
        f"{cmp['loss_err']:.3g}, gradients {cmp['grad_err']:.3g} ({cmp['worst_grad']}) of max "
        f"|value| (tolerance "
        f"{CPU_TOL}); cli {rec['wall_s']:.1f} s; launches {rec['launches']}")
    del model, batch
    torch.cuda.empty_cache()
    return {"rulstm_train": rec["launches"]}, summary


# ---------------------------------------------------------------- zoo_cloze
# zoo_transformer's run with the Transformer aggregator's cloze (MLM)
# training on: a key position is masked with probability 0.15 and the aux
# loss tx_mlm weighted 1.0 (conf/config.yaml's loss weight 1.0)
ZOO_CLOZE = ["+model.temporal_aggregator.cloze_loss_ratio=0.15",
             "+model.temporal_aggregator.cloze_loss_wt=1.0"]


def zoo_cloze_phase(card):
    """`zoo_transformer_overrides` plus ZOO_CLOZE through `train_net.cli`,
    1 epoch of 4 steps of 64 and 2 eval batches: in training the cloze key
    mask sends the attention to the plain path (as avt_tpu sends it to XLA),
    so the flash forward runs only at eval, 6 launches a batch; tx_mlm
    among the loop's losses, finite. Then one train step's losses and
    gradients on the trained weights and the first batch, card against CPU
    with the same cloze draw and dropout masks (`train_grads_vs_cpu`),
    within CPU_TOL, tx_mlm among them, with every ReLU (the encoder's FFN,
    the MLP future predictor and classifier) a softplus on both sides, as
    the CPU tests of the conv backbones hold them: with the ReLUs the
    gradients sat up to 5.8e-4 of their scale apart (a ReLU input within
    rounding of 0 flips between two f32 programs). Returns (the launch
    counts, a summary)."""
    from avt_tpu_torch import train_net

    captured = []
    with tempfile.TemporaryDirectory() as tmp:
        tree = write_ek100_tree(os.path.join(tmp, "tree"), train_videos=TN_TRAIN_VIDEOS,
                                eval_videos=TN_EVAL_VIDEOS, actions_per_video=TN_ACTIONS,
                                first_action_s=TN_FIRST_S, seed=53)
        argv = ["--run-dir", os.path.join(tmp, "run")] + zoo_transformer_overrides(tree) + (
            ZOO_CLOZE + [f"data_train.workers={TN_WORKERS}", f"data_eval.workers={TN_WORKERS}",
                         "train.num_epochs=1"])
        with mock.patch.object(train_net, "make_train_step",
                               recording_make_train_step(train_net, captured)):
            (metric,), rec = run_train_net(argv)
    want = flash_launches(ZOO_LAYERS * TN_EVAL_BATCHES)
    check(rec["launches"] == want, f"zoo_cloze: launches {rec['launches']}, want {want}")
    check(rec["epochs"] == [0] and np.isfinite(metric),
          f"zoo_cloze: epochs {rec['epochs']}, metric {metric}")
    losses = loop_losses(rec, "zoo_cloze", TN_STEPS)
    check("loss/tx_mlm" in losses, f"zoo_cloze: no tx_mlm among the losses {sorted(losses)}")
    model, loss_wts, num_classes, batch, _ = captured.pop()
    agg = model.temporal_aggregator
    check(agg.cloze_loss_ratio == 0.15 and agg.cloze_loss_wt == 1.0,
          f"zoo_cloze: the aggregator's cloze {agg.cloze_loss_ratio}, {agg.cloze_loss_wt}")
    cmp = train_grads_vs_cpu(model, batch, loss_wts, num_classes, seed=54, relu=softplus)
    check(cmp["launches"] == flash_launches(0) and "tx_mlm" in cmp["losses"]
          and max(cmp["loss_err"], cmp["grad_err"]) <= CPU_TOL
          and all(np.isfinite(list(cmp["losses"].values()))),
          f"zoo_cloze: card vs CPU {cmp} (tolerance {CPU_TOL})")
    clips_s = rec["loggers"][0].meters["clips/s"]
    summary = dict(loop_ms=TN_BATCH / clips_s.median * 1e3, losses=losses, metric=metric,
                   **{k: cmp[k] for k in ("loss_err", "grad_err", "cpu_s")})
    log(f"zoo_cloze ({card}): the Transformer aggregator over {LONG_T} features with cloze "
        f"0.15 / tx_mlm 1.0, {TN_STEPS} steps of {TN_BATCH}, {TN_EVAL_BATCHES} eval batches; the "
        f"loop {summary['loop_ms']:.2f} ms a step; losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
        + f"; final_acc/action/AR5 {metric:.4f}; one step card vs CPU (the same cloze draw, "
        f"ReLU as softplus): losses {cmp['loss_err']:.3g}, gradients {cmp['grad_err']:.3g} "
        f"({cmp['worst_grad']}) of max |value| "
        f"(tolerance {CPU_TOL}), tx_mlm {cmp['losses']['tx_mlm']:.4f}; cli {rec['wall_s']:.1f} s; "
        f"launches {rec['launches']}")
    del model, batch
    torch.cuda.empty_cache()
    return {"zoo_cloze": rec["launches"]}, summary


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-flagship-rank"]:  # a rank of the tp phase's flagship step
        tp_flagship_rank_main(sys.argv[2])
    elif len(sys.argv) > 1:  # a rank of the ddp or tp phase (avt_tpu_torch.launch's child)
        ddp_rank_main(sys.argv[1:])
    else:
        main()
