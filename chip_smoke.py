#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`vitadapter_torch`) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each failure exits non-zero; nothing is caught):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. builds every CUDA kernel of the port from `vitadapter_torch/ops/csrc`,
     printing registers and spills by kernel instantiation, and the
     tensor-core instructions in the attention libraries' SASS by
     instantiation (TF32 and bf16 `HGMMA`, `HMMA`); fails if an fp32
     attention kernel has no TF32 `HGMMA`, or if an instantiation of the
     fused MSDA kernels, `msda_level_dv`, the auction or `point_sample_bwd`
     has a stack frame; logs `point_sample_bwd`'s launch plan (cluster
     size, rows and shared memory a CTA, row groups) for each of its calls
     in phase 3;
  3. holds each kernel against its plain PyTorch version on the card, fp32
     and bf16, at the flagship's shapes: the forward kernels, and the
     backward kernels reached through the autograd wrappers (so the
     gradients of MSDA and attention on the card are checked too, and the
     log-sum-exp the attention forward saves for its backward); the
     auction (fp32 costs only; contested, partly valid and tied costs) for
     equal matches and rounds and for a total cost within its bound of
     scipy's optimum, with its microseconds per round. It times each
     kernel (CUDA events, L2 flushed before each call, the launches queued
     ahead) beside
     its bound, its plain version and, where one PyTorch call computes the
     same function, that call (`scaled_dot_product_attention` and its
     backward, `F.grid_sample` and its backward);
  4. serves a few batch-2 requests of raw uint8 512x512 images with the
     flagship ViT-Adapter-L + Mask2Former (ADE20K, 150 classes) in bf16 from
     random seeded weights, and checks the launch counts of the kernels;
  5. runs a reduced-depth, full-width model in fp32 on the card (kernels)
     and on the CPU (plain versions) and compares the logits;
  6. trains the flagship for a few steps (batch 2, 512x512, fp32 parameters
     and bf16 compute, DropPath 0.4, the Mask2Former loss at 12544 points
     with the auction assignment, AdamW with layer decay) and checks the
     launch counts per step;
  7. takes one train step of a reduced-depth, full-width model in fp32 on
     the card and on the CPU and compares the loss and the gradient norm;
  8. evaluates the flagship in fp32 on one 1024x2048 image through
     `train.loop.run_eval` (whole mode, img_scale (2048, 1024), ratios 1.0
     and 1.5 with flip): at ratio 1.5 the injectors' and the pixel
     decoder's values pass the 8 MiB line and take the per-level MSDA
     kernels; checks the launch counts, finite logits and the confusion
     matrix;
  9. takes one fp32 train step of the reduced-depth, full-width model at
     1792x1792, where those values pass the line too, and checks the
     launch counts of all ten kernels;
 10. evaluates the reduced model in fp32 through `run_eval` on two odd-sized
     non-square images (whole mode, ratios 0.75 and 1.0 with flip) on the
     card and on the CPU and compares the confusion matrices;
 11. drives the config entry points in this process on the 640 px
     BEiT-Adapter-L + Mask2Former config (fp32, batch 1, 100 queries):
     `tools.train.main` for 4 steps on synthetic data (checkpoints, the
     eval hook), `--resume` for a fifth, then `tools.test.main` on two
     ADE20K-layout images without and with `--aug-test`, against
     `run_eval` called directly; checks the launches of each train step
     and that no per-level or attention kernel runs;
 12. runs that config reduced to depth 4 at 256 px, full width, fp32, on
     the card and on the CPU, and compares the logits and one train
     step's loss and gradient norm (the CPU on the card's assignment);
 13. drives the config entry points likewise on the AugReg-L UperNet
     config at full width as shipped (ViT-Adapter-L in fp32 with
     `with_cp`, drop path 0.4; UPerHead 1024 and FCNHead 256 wide in bf16;
     batch 2 at 512x512): 4 train steps on synthetic data, `--resume` for
     a fifth, then the test CLI on the two ADE20K-layout images in slide
     mode and with `--aug-test` at the reference ratios, against `run_eval`
     called directly; checks the launches of each train step and of each
     model call, and that no point sampling, auction or per-level kernel
     runs;
 14. runs that config reduced to depth 4 at 256 px, full width, all fp32,
     drop path and dropout 0, on the card and on the CPU, and compares the
     logits and one seg train step's loss and gradient norm;
 15. drives the config entry points on the AugReg-L Mask R-CNN config as
     shipped (ViT-Adapter-L in fp32 with `with_cp`, 20 windowed and 4
     global blocks, batch 1 on the 1024 canvas, 100 synthetic instances):
     4 train steps, `--resume` for a fifth, then `tools.test --eval bbox
     segm` on a landscape and a portrait COCO-layout image, against
     `run_det_eval` called directly; checks the launches of each train step
     and of each model call (attention, MSDA and the NMS kernel), and
     reports s/step, peak memory, the checkpoint and the test's s/image;
 16. runs that config reduced to depth 4 (three windowed blocks, one
     global) at 256 px, full width, fp32, on the card and on the CPU, and
     compares the FPN and RPN outputs, the RoI stage and the detections'
     kept sets, then one det train step's losses and gradient norm (the
     same sampler draws, the CPU on the card's proposals);
 17. drives the config entry points on the AugReg-L HTC++ config
     (ViT-Adapter-L in fp32 with `with_cp`, ExtraAttention, the semantic
     branch, 3 cascade stages, batch 1) on the 1600x1408 canvas: the
     shipped crop [1600, 1400] is not a multiple of 32 and must raise the
     port's ValueError, as the JAX package fails there (ROADMAP.md §3);
     4 train steps, `--resume` for a fifth, `tools.test --eval bbox segm`
     on the two COCO-layout images against `run_det_eval`, then
     `--aug-test` with the `_ms` config (6 scales x flip, soft-NMS
     merge); checks the launches of each train step and of each model
     call, and reports s/step, peak memory, the checkpoint and the tests'
     s/image (model calls and host apart);
 18. one synthetic train step each of the BEiTv2 HTC++ config (BEiT
     detection variant: windows of 14 and 56, no cls token, version
     "new"; 1600x1408) and of the bf16 DeiT-S Cascade Mask R-CNN config
     (batch 2, 1024 canvas): finite losses, exact launches, peak memory;
 19. runs the HTC++ config reduced to depth 4 (three windowed blocks,
     one global) at 256 px, full width, fp32, on the card and on the CPU:
     the FPN and RPN outputs, the semantic features and the three stages'
     outputs on the card's proposals, the detections' kept sets, then one
     train step's losses and gradient norm (the same sampler draws, the
     CPU on the card's proposals);
 20. drives the config entry points on the large WSDM2023 GroundingDINO
     config (the Uni-Perceiver-Adapter-L, 24 joint layers, fp32, TF32 off,
     batch 2 on the 1024 canvas) on synthetic WSDM-layout images with
     questions and a tiny CLIP merge table: 4 train steps through the real
     pipeline with a checkpoint, `--resume` for a fifth, `tools.test
     --eval IoU` and `--aug-test` (3 scales x flip), each against
     `run_grounding_eval` called directly (boxes included), then
     `tools.generate_results` on a 2-row CSV, through the driver of
     phases 15 and 17 (`run_cli`); checks the launches of each
     train step (22/22/7 for msda fwd/bwd and the auction) and of each
     model call (22), and reports s/step, peak memory, the checkpoint and
     the tests' s/image (model calls and host apart);
 21. takes one train step of the base GQA config (`VGDataset`, questions
     of 64 tokens) with its eval hook off: finite, exact launches;
 22. runs the large WSDM2023 config at depth 4 and full width on the 256
     canvas, fp32, on the card and on the CPU: the encoder's top-100 sets,
     the last layer's outputs of every query and the decoded top box and
     scores within `GROUNDING_RTOL` of their scale, then one train step's
     losses and float64 gradient norm (the card's denoising draws, the CPU
     on the card's assignments).
Phase 3 holds the fused MSDA kernels (msda_fwd, msda_bwd) against their
plain versions on uniform locations and on locations shaped as the model
makes them (`msda_model_locations` with each geometry's query set, timed
there too under the rows' `model_shaped`), launched twice into outputs
filled with NaN first, the output, d loc and d attn bitwise equal across
the launches; at other P, widths, level counts and a misaligned value
(`FUSED_LAYOUTS`); and in fp32 at the shapes where phases 8 and 9 run them
(`MSDA_PATH_CASES`, the plain versions four heads at a time; the rows'
`paths`; phases 11's and 13's cases on model-shaped locations too).
Point sampling
and the auction are also checked at phase 11's shapes (`POINT_CLI`,
`AUCTION_CLI`; the rows' `paths["cli"]`). It also holds the per-level MSDA kernels against their plain
versions, and the per-level route against the fused kernels, at the shapes
of every MSDA call that takes that route in phases 8 and 9 (and at a few
thousand queries in fp32 and bf16), on uniform locations and on locations
shaped as the model makes them (`msda_model_locations`; all three timed
there too, under `model_shaped`; msda_level_fwd and _dgrid launched twice
for bitwise-equal outputs; msda_level_dv's atomic payload and its rate
logged), and at other P, widths and a misaligned value and d value buffer
(`LEVEL_LAYOUTS`); and the fp32 attention at the lengths phases 8 and 9
give it, and at phase 13's (batch 2, N 1024, with a backward); the
attention (windows of N 196 and global N 4096 and 4200) and fused MSDA
kernels at phase 15's detection shapes and at the bf16 DeiT-S Mask R-CNN
step's (the rows' `paths["det"]`, `["det_test"]`, `["det_bf16"]`), and at
phase 17's on the 1600x1408 canvas (ExtraAttention's 2200 tokens at head
dim 128, windows of N 196, global N 8800; the SPM pyramid of 46200
values; `paths["htc"]`); the fused MSDA kernels at phase 20's shapes (the
adapter's, the DINO encoder's 21760 queries over its 4 levels and the
decoder's 104 queries sampling around 4-d boxes, `msda_box_locations`)
and the auction at its (2, 100, 1) matrices, n_valid 1 and 0
(`paths["grounding"]`); and
the NMS kernel (`nms.cu`, not a TPU kernel) at the proposals' 4768 boxes
and the detections' 2048 for bitwise-equal kept flags. The fp32
attention (split TF32 on the tensor cores) is launched
twice at every case and must give bitwise-equal outputs and gradients; its
bound is the split-TF32 floor (`attention_bound_ms`), with the CUDA-core
figure beside it. point_sample_bwd is launched into NaN-filled outputs at
the flagship's call and at `POINT_BWD_LAYOUTS` (unsorted points, points
off the map and NaN, one mask, no points, one row or column, rows of 127
and 130, the over-line step's 448x448 masks, timed under the row's
`paths`, and a map larger than a cluster holds). The last three lines are
the card's name and power limit again, a JSON object of the kernels'
numbers (with the TPU kernels each one covers besides the one it replaces)
and {"ok": true, "device": {...}}.
"""

import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# published H100 SXM peaks (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,   # tensor cores, dense
              torch.float32: 67e12}     # CUDA cores
# the fp32 attention kernels compute each fp32 product on the tensor cores
# as three TF32 products (split TF32): their least time is three times the
# operations over the dense TF32 peak
TF32_FLOPS = 495e12
SPLIT_PRODUCTS = 3

# tolerances of kernel vs plain version on the same inputs (both sum in
# fp32 in another order): fp32 differs by float rounding; bf16 outputs are
# both rounded from fp32 sums, so they differ by at most ~1 bf16 ulp (2^-8
# relative), allowed twice over.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2.0 ** -7)}
# gradients (backward kernels with fp32 atomics, or another summation
# order): each element within 1e-5 of the reference's max |value| plus the
# relative rounding of its dtype (1e-5 for fp32, 2^-7 for bf16)
GRAD_TOL = 1e-5
# reduced-depth model, card (kernels, cuDNN convs) vs CPU, fp32, TF32 off:
# float reassociation across ~60 layers, relative to the logits' scale
E2E_RTOL = 1e-3
# phase 22's eval outputs, GroundingDINO card against CPU, of their scale
GROUNDING_RTOL = 1e-4
# phase 22's train step, card vs CPU, fp32, TF32 off, relative: the losses
# and the float64 gradient norm (no bf16 point sampling on this path, so
# only reassociation; 3.8e-6 and 1.6e-5 seen on the H100)
GROUNDING_TRAIN_RTOL = 1e-4
# reduced-depth train step, card vs CPU, fp32, TF32 off: besides the
# reassociation, the loss samples bf16-rounded mask logits, where a 1e-6
# difference can flip one rounding and move an uncertainty-selected point
# (1.8e-5 seen on the H100)
TRAIN_RTOL = 1e-3

F32, BF16 = torch.float32, torch.bfloat16
SPM512 = ((64, 64), (32, 32), (16, 16))   # the SPM pyramid at 512x512
MSDA_GEOMETRIES = {
    # name: (spatial shapes of the value, Lq, heads, calls per forward)
    "injector": (SPM512, 1024, 16, 4),
    "extractor": (((32, 32),), 5376, 16, 6),
    "pixel_decoder": (SPM512[::-1], 5376, 32, 6),
}
# where each flagship geometry's queries sit, for the model-shaped
# locations (`msda_model_locations`' `grid`): the injectors query the
# 32x32 token grid, the extractors the SPM pyramid's cells, the pixel
# decoder its value's own cells
MSDA_QUERY_GRID = {"injector": (32, 32), "extractor": SPM512,
                   "pixel_decoder": None}
ATTN_SHAPE = (2, 16, 1024, 64)   # 24 calls per forward
ATTN_CALLS = 24
# attention at the shapes of the paths that run it, head dim 64: name:
# (B, heads, N, dtype, path, forward calls there, backward calls). The
# whole-image evaluation's 1/16 token grid is 64x128 at ratio 1.0 and
# 96x192 at 1.5 (24 calls per forward, 2 forwards each with the flip); the
# over-line step's is 112x112 (4 blocks); phase 13's UperNet step runs 24
# blocks at batch 2 on the 32x32 grid, each forward twice (`with_cp`
# recomputes the blocks in the backward). Phase 15's AugReg-L Mask R-CNN
# step (1024 canvas, batch 1, `with_cp`) runs 20 windowed blocks on
# 5 x 5 windows of 14 x 14 tokens (the 64x64 grid padded to 70x70) and 4
# global ones on 4096 tokens, each forward twice; its test CLI's model
# call runs them once on the 800x1344 canvas's 50x84 grid (6 x 4 windows,
# 4200 tokens). The bf16 cases are the DeiT-S Mask R-CNN configs' step
# (batch 2, 6 heads, no `with_cp`: 8 windowed and 4 global blocks)
ATTN_PATH_CASES = {
    "eval_r1.0": (1, 16, 8192, F32, "eval_whole", 48, 0),
    "eval_r1.5": (1, 16, 18432, F32, "eval_whole", 48, 0),
    "overline": (1, 16, 12544, F32, "train_overline", 4, 4),
    "upernet": (2, 16, 1024, F32, "upernet", 48, 24),
    "det_window": (25, 16, 196, F32, "det", 40, 20),
    "det_global": (1, 16, 4096, F32, "det", 8, 4),
    "det_test_window": (24, 16, 196, F32, "det_test", 20, 0),
    "det_test_global": (1, 16, 4200, F32, "det_test", 4, 0),
    "det_bf16_window": (50, 6, 196, BF16, "det_bf16", 8, 8),
    "det_bf16_global": (2, 6, 4096, BF16, "det_bf16", 4, 4),
    # phase 17's AugReg-L HTC++ step on the 1600x1408 canvas (batch 1,
    # `with_cp`): the 100x88 grid padded to 112x98 makes 8 x 7 windows,
    # the global blocks take 8800 tokens, and ExtraAttention (8 heads of
    # 128) the 50x44 coarsest level once, outside `with_cp`
    "htc_window": (56, 16, 196, F32, "htc", 40, 20),
    "htc_global": (1, 16, 8800, F32, "htc", 8, 4),
    "htc_extra": (1, 8, 2200, F32, "htc", 1, 1),
}
# the head dim of an `ATTN_PATH_CASES` case (64 elsewhere)
ATTN_PATH_D = {"htc_extra": 128}
# point sampling in one flagship train step (batch 2, 200 queries, 60 gt
# classes, 10 decoder outputs, 12544 points):
# name: (masks N, H, W, points per mask, points sorted by y, calls)
POINT_GEOMETRIES = {
    "assign_pred": (4000, 128, 128, 12544, True, 1),
    "assign_gt": (120, 512, 512, 125440, True, 1),
    "uncertainty": (400, 128, 128, 37632, False, 10),
    "loss_pred": (400, 128, 128, 12544, True, 10),
    "loss_gt": (400, 512, 512, 12544, True, 10),
}
POINT_BWD = "loss_pred"          # the one sampling call with a gradient
# point_sample_bwd beside the flagship's call (phase 3), fp32 and bf16
# masks, each case launched into a NaN-filled output so that a cell left
# unwritten fails: name: (masks N, H, W, points per mask, points, None or
# (the path, calls per step there)). Points "sorted" by y as the loss
# sorts them, "unsorted", or "edges": unsorted, with points off the map,
# NaN coordinates, pixel centres and the map's borders (`point_bwd_points`).
# W 127 and 130 leave bands that do not start or end on 16 bytes; 448x448
# is the over-line step's call (phase 9: 1792 / 4, bf16 since the loss
# casts the mask logits); 1024x1024 is more than a cluster holds (row
# groups).
POINT_BWD_LAYOUTS = {
    "unsorted": (400, 128, 128, 12544, "unsorted", None),
    "edges": (400, 128, 128, 12544, "edges", None),
    "n1": (1, 128, 128, 12544, "sorted", None),
    "p0": (16, 128, 128, 0, "sorted", None),
    "h1": (64, 1, 300, 2000, "edges", None),
    "w1": (64, 300, 1, 2000, "edges", None),
    "h1w1": (8, 1, 1, 500, "edges", None),
    "w127": (64, 127, 127, 4000, "sorted", None),
    "w130": (64, 96, 130, 4000, "edges", None),
    "overline": (200, 448, 448, 12544, "sorted", ("train_overline", 10)),
    "row_groups": (2, 1024, 1024, 100000, "unsorted", None),
}
# point sampling in one train step of phase 11 (batch 1, 100 queries, 60
# gt classes, 10 decoder outputs, 160x160 mask logits at 640x640), as
# `POINT_GEOMETRIES`' entries
POINT_CLI = {
    "assign_pred": (1000, 160, 160, 12544, True, 1),
    "assign_gt": (60, 640, 640, 125440, True, 1),
    "uncertainty": (100, 160, 160, 37632, False, 10),
    "loss_pred": (100, 160, 160, 12544, True, 10),
    "loss_gt": (100, 640, 640, 12544, True, 10),
}
# the assignment of one flagship train step: 10 decoder outputs x batch 2
# cost matrices of 200 queries x 60 gts, solved in one launch; phase 11's:
# 10 x batch 1 of 100 queries x 60 gts
AUCTION_SHAPE = (20, 200, 60)
AUCTION_CLI = (10, 100, 60)
AUCTION_GROUNDING = (2, 100, 1)
SERVE_REQUESTS = 4   # batch-2 requests of the main path (phase 4)
TRAIN_STEPS = 6      # flagship train steps (phase 6)
TRAIN_LAUNCHES = {   # kernel launches per train step
    "msda_fwd": 16, "msda_bwd": 16, "attention_fwd": 24, "attention_bwd": 24,
    "point_sample_fwd": 32, "point_sample_bwd": 10, "auction": 1}
# the per-level MSDA route (phase 3), batch 1, head dim 32.
# name: (spatial shapes of the value, Lq, heads, dtypes, None or (the main
# path, MSDA calls of these shapes per forward or step there))
# - the calls of the main paths, in fp32 as both paths run: the flagship's
#   forward at ratio 1.5 of a 1024x2048 image (1536x3072; phase 8) and the
#   reduced model's step at 1792x1792 (phase 9). The pixel decoder queries
#   all its value rows, levels coarse first; the injectors query the 1/16
#   token grid, levels fine first. These give the kernels' table rows:
#   msda_level_fwd per eval forward, msda_level_dv/_dgrid per train step;
# - off the paths: a few thousand queries at the ratio-1.5 pixel-decoder
#   levels, fp32 and bf16, and a case whose first level has H * W <= 1024
#   (`_sample_kernel_onehot_pf`'s levels)
R15 = ((48, 96), (96, 192), (192, 384))
OVER = ((56, 56), (112, 112), (224, 224))
LEVEL_GEOMETRIES = {
    "eval_pixel_decoder": (R15, 96768, 32, (F32,), ("eval_whole", 6)),
    "eval_injector": (R15[::-1], 18432, 16, (F32,), ("eval_whole", 4)),
    "overline_pixel_decoder": (OVER, 65856, 32, (F32,),
                               ("train_overline", 6)),
    "overline_injector": (OVER[::-1], 12544, 16, (F32,),
                          ("train_overline", 4)),
    "pixel_decoder_r1.5": (R15, 4096, 32, (F32, BF16), None),
    "small_level": (((32, 32), (96, 192), (192, 384)), 4096, 32, (F32, BF16),
                    None),
}
# where each geometry's queries sit, for the model-shaped locations
# (`msda_model_locations`): None, the value's own cells (the pixel decoder);
# (h, w), a grid of h * w queries (the injectors' 1/16 token grid, or a
# 64x64 grid off the paths)
LEVEL_QUERY_GRID = {
    "eval_pixel_decoder": None, "eval_injector": (96, 192),
    "overline_pixel_decoder": None, "overline_injector": (112, 112),
    "pixel_decoder_r1.5": (64, 64), "small_level": (64, 64),
}
# the fused MSDA kernels where the paths run them in fp32, B 1, D 32:
# name: (spatial shapes of the value, Lq, heads, the query grid as
# `MSDA_QUERY_GRID`'s, the path, its calls there, with a backward). Phase 8
# at ratio 1.0 (1024x2048: the SPM pyramid (128, 256)/(64, 128)/(32, 64),
# the 1/16 grid (64, 128)) runs all 16 calls fused, at ratio 1.5 only the
# extractors ((96, 192)), each twice with the flip: 44 launches; phase 9's
# extractors (1792x1792: (112, 112)) take a backward too
R10 = ((32, 64), (64, 128), (128, 256))
SPM640 = ((80, 80), (40, 40), (20, 20))
SPM1024 = ((128, 128), (64, 64), (32, 32))
SPM800 = ((100, 168), (50, 84), (25, 42))   # the 800x1344 canvas
SPM1600 = ((200, 176), (100, 88), (50, 44))  # the 1600x1408 canvas
DINO1024 = ((128, 128), (64, 64), (32, 32), (16, 16))  # DINO's 4 levels
MSDA_PATH_CASES = {
    "eval_r1.0_injector": (R10[::-1], 8192, 16, (64, 128), "eval_whole", 8,
                           False),
    "eval_r1.0_extractor": (((64, 128),), 43008, 16, R10[::-1],
                            "eval_whole", 12, False),
    "eval_r1.0_pixel_decoder": (R10, 43008, 32, None, "eval_whole", 12,
                                False),
    "eval_r1.5_extractor": (((96, 192),), 96768, 16,
                            ((192, 384), (96, 192), (48, 96)), "eval_whole",
                            12, False),
    "overline_extractor": (((112, 112),), 65856, 16,
                           ((224, 224), (112, 112), (56, 56)),
                           "train_overline", 6, True),
    # phase 11's train step (BEiT-Adapter-L + Mask2Former at 640x640,
    # batch 1, fp32): the SPM pyramid (80, 80)/(40, 40)/(20, 20) and the
    # 1/16 grid (40, 40); every call fused (about 1.1 MB of values a head)
    # and checked on model-shaped locations too
    "cli_injector": (SPM640, 1600, 16, (40, 40), "cli", 4, True),
    "cli_extractor": (((40, 40),), 8400, 16, SPM640, "cli", 6, True),
    "cli_pixel_decoder": (SPM640[::-1], 8400, 32, None, "cli", 6, True),
    # phase 13's train step (AugReg-L + UperNet at 512x512, batch 2, fp32):
    # the flagship's injector and extractor geometries in fp32, checked on
    # model-shaped locations too
    "upernet_injector": (SPM512, 1024, 16, (32, 32), "upernet", 4, True),
    "upernet_extractor": (((32, 32),), 5376, 16, SPM512, "upernet", 6,
                          True),
    # phase 15's AugReg-L Mask R-CNN step (1024 canvas, batch 1, fp32, 16
    # heads, D 32): the SPM pyramid (128, 128)/(64, 64)/(32, 32) (2.6 MiB
    # a head) and the 1/16 grid (64, 64); its test CLI's model call on the
    # 800x1344 canvas; the DeiT-S configs' step (batch 2, bf16, 6 heads, D
    # 64)
    "det_injector": (SPM1024, 4096, 16, (64, 64), "det", 4, True),
    "det_extractor": (((64, 64),), 21504, 16, SPM1024, "det", 6, True),
    "det_test_injector": (SPM800, 4200, 16, (50, 84), "det_test", 4,
                          False),
    "det_test_extractor": (((50, 84),), 22050, 16, SPM800, "det_test", 6,
                           False),
    "det_bf16_injector": (SPM1024, 4096, 6, (64, 64), "det_bf16", 4, True),
    "det_bf16_extractor": (((64, 64),), 21504, 6, SPM1024, "det_bf16", 6,
                           True),
    # phase 17's HTC++ step on the 1600x1408 canvas (fp32, 16 heads, D
    # 32): 46200 values, 5.9 MB a head, under the 8 MiB line
    "htc_injector": (SPM1600, 8800, 16, (100, 88), "htc", 4, True),
    "htc_extractor": (((100, 88),), 46200, 16, SPM1600, "htc", 6, True),
    # phase 20's GroundingDINO step (the large wsdm2023 config, 1024
    # canvas, batch 2, fp32): the adapter's calls as phase 15's (16 heads,
    # D 32), the DINO encoder's self attention over the 4 neck levels
    # (strides 8-64: 21760 values and queries, 8 heads, D 32; 2.8 MB a
    # head) and the decoder's cross attention of 104 queries (100 and 4
    # denoising) around 4-d reference boxes (`"boxes"`: locations as
    # `MSDeformAttn` makes them from boxes)
    "grounding_injector": (SPM1024, 4096, 16, (64, 64), "grounding", 4,
                           True),
    "grounding_extractor": (((64, 64),), 21504, 16, SPM1024, "grounding", 6,
                            True),
    "grounding_encoder": (DINO1024, 21760, 8, None, "grounding", 6, True),
    "grounding_decoder": (DINO1024, 104, 8, "boxes", "grounding", 6, True),
}
# the batch, dtype and head dim of each path's MSDA calls in
# `MSDA_PATH_CASES` (1, fp32 and 32 elsewhere)
PATH_BATCH = {"upernet": 2, "det_bf16": 2, "grounding": 2}
PATH_DTYPE = {"det_bf16": BF16}
PATH_D = {"det_bf16": 64}
# the paths whose `MSDA_PATH_CASES` are also checked on model-shaped
# locations
MODEL_SHAPED_PATHS = ("cli", "upernet", "det", "det_test", "det_bf16",
                      "htc", "grounding")
# the fused kernels off the flagship's layout, fp32 and bf16 each: name:
# (spatial shapes, query grid, heads, D, P, the value 2 or 4 bytes off
# 16-byte alignment). As `LEVEL_LAYOUTS`: ragged and narrow rows and other
# P (P 3 at D 32 puts two levels' points in one round of 8 or 4 lanes),
# one, four and eight levels, and a misaligned value (the scalar
# instantiation)
SMALL2 = ((12, 20), (24, 40))
FUSED_LAYOUTS = {
    "P3": (SPM512[::-1], (32, 32), 32, 32, 3, False),
    "ragged_d20": (SMALL2, (16, 32), 4, 20, 4, False),
    "d64_P3": (SMALL2, (16, 32), 4, 64, 3, False),
    "d8_P2": (SMALL2, (16, 32), 4, 8, 2, False),
    "L1": (((24, 40),), SMALL2, 4, 32, 4, False),
    "L4": (((6, 10), (12, 20), (24, 40), (48, 80)), (16, 32), 4, 32, 4,
           False),
    "L8": (tuple((2 * k + 1, 3 * k + 2) for k in range(8)), (16, 32), 4, 32,
           4, False),
    "misaligned_d32_P5": (SMALL2, (16, 32), 4, 32, 5, True),
    "misaligned_d64": (SMALL2, (16, 32), 4, 64, 4, True),
}
# the per-level kernels off the paths' layout (P 4, D 32, 16-byte aligned),
# fp32 and bf16 each: name: (spatial shapes, query grid, heads, D, P, the
# value 2 or 4 bytes off 16-byte alignment, and then msda_level_dv's fp32
# buffer 4 bytes off). Rows of 20 fp32 leave a ragged team (5 chunks on 8
# lanes) and 20 bf16 take the scalar instantiation of the forward and
# d grid (msda_level_dv takes 4-element chunks in both dtypes: 5 on 8
# lanes); 64 wide rows take 16 (fp32) or 8 (bf16) lanes a (query, head), 8
# wide rows 2 or 1 (then P 2 takes two rounds of points); a misaligned
# value or buffer takes the scalar instantiation
LEVEL_LAYOUTS = {
    "P3": (R15, (64, 64), 32, 32, 3, False),
    "ragged_d20": (((12, 20), (24, 40)), (16, 32), 4, 20, 4, False),
    "d64_P3": (((12, 20), (24, 40)), (16, 32), 4, 64, 3, False),
    "d8_P2": (((12, 20), (24, 40)), (16, 32), 4, 8, 2, False),
    "misaligned_d32_P5": (((12, 20), (24, 40)), (16, 32), 4, 32, 5, True),
    "misaligned_d64": (((12, 20), (24, 40)), (16, 32), 4, 64, 4, True),
}
# the table row of each per-level kernel comes from its main path's calls
LEVEL_ROW_PATH = {"msda_level_fwd": "eval_whole",
                  "msda_level_dv": "train_overline",
                  "msda_level_dgrid": "train_overline"}
# phase 8: the flagship in fp32, whole mode, on one Cityscapes-sized image
EVAL_HW = (1024, 2048)
EVAL_CFG = {"num_classes": 150,
            "test_cfg": {"mode": "whole", "img_scale": (2048, 1024)},
            "aug_test": {"img_ratios": [1.0, 1.5], "flip": True}}
# 4 forwards: 16 fused MSDA calls at ratio 1.0, 6 (the extractors) at 1.5,
# where the 4 injectors and 6 pixel-decoder layers take 3 level launches
EVAL_LAUNCHES = {"msda_fwd": 2 * 16 + 2 * 6, "msda_level_fwd": 2 * 30,
                 "attention_fwd": 4 * 24}
# phase 9: S = 50176 + 12544 + 3136 rows x 32 x 4 bytes = 8.04 MiB per head
OVERLINE_HW = 1792
OVERLINE_QUERIES = 200
OVERLINE_LAUNCHES = {
    "msda_fwd": 6, "msda_bwd": 6, "msda_level_fwd": 30, "msda_level_dv": 30,
    "msda_level_dgrid": 30, "attention_fwd": 4, "attention_bwd": 4,
    "point_sample_fwd": 32, "point_sample_bwd": 10, "auction": 1}
# phase 10: card vs CPU confusion matrices, at most this share of the
# labelled pixels predicted differently (argmax flips where two classes'
# probabilities tie within float reassociation)
EVAL_CM_SHARE = 1e-3
# phase 11: the config CLI on the 640 px BEiT-Adapter-L + Mask2Former
# config, synthetic data, with these overrides; then two ADE20K-layout
# images for the test CLI (a slide crop of 640 at stride 426 takes two
# crops of each)
CLI_CONFIG = "configs/ade20k/mask2former_beit_adapter_large_640_160k_ade20k_ss.py"
CLI_STEPS = 4
CLI_OPTIONS = ["log_config.interval=1", "checkpoint_config.interval=2",
               "evaluation.interval=4", "evaluation.max_images=2"]
CLI_IMAGES = ((512, 683), (683, 512))
# `--aug-test` at ratios of at least 1: below 1 the slide crops of these
# images are smaller than img_size, whose grid the BEiT relative-position
# tables span (ROADMAP.md §3); the default ratios must raise that error
CLI_AUG_RATIOS = "aug_test.img_ratios=[1.0,1.25,1.5,1.75]"
CLI_STEP_LAUNCHES = {"msda_fwd": 16, "msda_bwd": 16, "point_sample_fwd": 32,
                     "point_sample_bwd": 10, "auction": 1}
# kernels that phase 11 must never launch
CLI_NEVER = ("msda_level_fwd", "msda_level_dv", "msda_level_dgrid",
             "attention_fwd", "attention_bwd")
# phase 13: the config CLI on the AugReg-L UperNet config as shipped (ViT-L
# in fp32 with `with_cp`, drop path 0.4; UPerHead 1024 and FCNHead 256 wide
# in bf16; batch 2 at 512x512; slide evaluation, crop 512, stride 341),
# synthetic data, with these overrides; the test CLI on `CLI_IMAGES`, then
# with `--aug-test` at the reference ratios 0.5-1.75 (ViT-Adapter resamples
# its position embedding, so any crop grid runs)
UPERNET_CONFIG = "configs/ade20k/upernet_augreg_adapter_large_512_160k_ade20k.py"
UPERNET_OPTIONS = ["log_config.interval=1", "checkpoint_config.interval=4",
                   "evaluation.interval=4", "evaluation.max_images=2"]
UPERNET_STEP_LAUNCHES = {"attention_fwd": 48, "attention_bwd": 24,
                         "msda_fwd": 10, "msda_bwd": 10}
UPERNET_FORWARD_LAUNCHES = {"attention_fwd": 24, "msda_fwd": 10}
UPERNET_NEVER = ("msda_level_fwd", "msda_level_dv", "msda_level_dgrid",
                 "point_sample_fwd", "point_sample_bwd", "auction")
# phase 15: the config CLI on the AugReg-L Mask R-CNN config as shipped
# (ViT-Adapter-L in fp32 with `with_cp`, drop path 0.4, 20 windowed and 4
# global blocks; FPN and RoI heads in fp32; batch 1 on the 1024 canvas;
# 100 synthetic instances), with these overrides; then the test CLI on one
# landscape and one portrait COCO-layout image (the 800x1344 and 1344x800
# canvases: one model call each)
DET_CONFIG = "configs/mask_rcnn/mask_rcnn_augreg_adapter_large_fpn_3x_coco.py"
DET_STEPS = 4
DET_OPTIONS = ["log_config.interval=1", "checkpoint_config.interval=4"]
DET_IMAGES = ((480, 640), (640, 480))
# a train step: 24 blocks recomputed under `with_cp`, 10 MSDA calls, one
# proposal NMS; a model call: 24 blocks and 10 MSDA calls, and one proposal
# and one detection NMS an image
DET_STEP_LAUNCHES = {"attention_fwd": 48, "attention_bwd": 24,
                     "msda_fwd": 10, "msda_bwd": 10, "nms": 1}
DET_FORWARD_LAUNCHES = {"attention_fwd": 24, "msda_fwd": 10}
DET_NEVER = ("msda_level_fwd", "msda_level_dv", "msda_level_dgrid",
             "point_sample_fwd", "point_sample_bwd", "auction")
# phase 17: the config CLI on the AugReg-L HTC++ config (ViT-Adapter-L in
# fp32 with `with_cp`, 20 windowed and 4 global blocks, ExtraAttention, the
# semantic branch, 3 cascade stages, batch 1) on the 1600x1408 canvas:
# the shipped crop [1600, 1400] is not a multiple of 32, which the
# adapter's pyramid needs (the JAX package fails its first injector's size
# assertion; ROADMAP.md §3), so the train runs take this override; the
# `--aug-test` run takes the `_ms` config (6 scales x flip)
HTC_CONFIG = "configs/htc/htc++_augreg_adapter_large_fpn_3x_coco.py"
HTC_MS_CONFIG = "configs/htc/htc++_augreg_adapter_large_fpn_3x_coco_ms.py"
HTC_CROP = "data.crop_size=[1600,1408]"
HTC_STEPS = 4
HTC_OPTIONS = ["log_config.interval=1", "checkpoint_config.interval=4",
               HTC_CROP]
# a train step: phase 15's and ExtraAttention's forward and backward (it
# is not under `with_cp`); a model call: 24 blocks, ExtraAttention and
# 10 MSDA calls
HTC_STEP_LAUNCHES = {"attention_fwd": 49, "attention_bwd": 25,
                     "msda_fwd": 10, "msda_bwd": 10, "nms": 1}
HTC_CALL_LAUNCHES = {"attention_fwd": 25, "msda_fwd": 10}
# phase 18: one synthetic train step of each config, with its overrides
# and the launches it must make. The BEiTv2 HTC++ trunk attends with
# relative-position biases in plain PyTorch (windows of 14 and 56, the
# latter 4 windows of 3136 tokens on the 112x112-padded grid): only
# ExtraAttention launches the attention kernels. The DeiT-S Cascade Mask
# R-CNN runs in bf16 at batch 2 on the 1024 canvas, without `with_cp`
ONE_STEP_CONFIGS = {
    "configs/htc/htc++_beitv2_adapter_large_fpn_3x_coco.py": (
        {"data.crop_size": [1600, 1408]},
        {"attention_fwd": 1, "attention_bwd": 1, "msda_fwd": 10,
         "msda_bwd": 10, "nms": 1}),
    "configs/cascade_rcnn/cascade_mask_rcnn_deit_adapter_small_fpn_3x_"
    "coco.py": (
        {}, {"attention_fwd": 12, "attention_bwd": 12, "msda_fwd": 10,
             "msda_bwd": 10, "nms": 2}),
}
# nms.cu at the Mask R-CNN path's sizes: name: (boxes, classes (0: one),
# IoU threshold, ((path, calls there), ...)). The proposals' NMS takes
# 1000 boxes of each of 4 levels and the 768 of the stride-64 level at the
# 1024 canvas (one a train step at batch 1, one a test image); the
# detections' takes the top 2048 of the 1000 x 80 class scores, offset by
# class (one a test image). On HTC++'s 1600x1408 canvas the proposals'
# NMS takes 5000 boxes: 1000 of each of 4 levels and 1000 of the 25x22x3
# anchors of the stride-64 level (one a train step)
NMS_CASES = {
    "proposals": (4768, 0, 0.7, (("det", 1), ("det_test", 1))),
    "detections": (2048, 80, 0.5, (("det_test", 1),)),
    "htc_proposals": (5000, 0, 0.7, (("htc", 1),)),
}
REPLACES = {
    "msda_fwd": "vitadapter/ops/msda_pallas.py:316",
    "msda_bwd": "vitadapter/ops/msda_pallas.py:1179",
    "msda_level_fwd": "vitadapter/ops/msda_pallas.py:121",
    "msda_level_dv": "vitadapter/ops/msda_pallas.py:905",
    "msda_level_dgrid": "vitadapter/ops/msda_pallas.py:1034",
    "attention_fwd": "vitadapter/ops/attention_pallas.py:57",
    "attention_bwd": "vitadapter/ops/attention_pallas.py:72",
    "point_sample_fwd": "vitadapter/ops/point_sample_pallas.py:46",
    "point_sample_bwd": "vitadapter/ops/point_sample_pallas.py:101",
    "auction": "vitadapter/ops/auction_pallas.py:33",
    # not a TPU kernel: the JAX package runs NMS as a `lax.scan`
    "nms": "vitadapter/det/boxes.py:90",
}
NOT_TPU_KERNELS = ("nms",)
# TPU kernels that compute the same function as another one, on inputs that
# a ported kernel takes whole: `msda_fwd.cu` computes the multi-level forward
# of every value under the 8 MiB line, which is all the opt-in band-matmul
# forward takes; `msda_level_fwd.cu` computes one level of any size, which
# is all `_sample_kernel_onehot_pf` takes (levels of at most 1024 cells)
COVERS = {
    "msda_fwd": ["vitadapter/ops/msda_pallas.py:514"],
    "msda_level_fwd": ["vitadapter/ops/msda_pallas.py:177"],
}


# kernels that keep every value in registers (the fused MSDA kernels'
# level table in shared memory): phase 2 fails on a stack frame in any of
# their instantiations
NO_FRAME = ("msda_fwd", "msda_bwd", "msda_level_dv", "auction",
            "point_sample_bwd")
# `time_ms`'s spin before each call: about 1 ms at the H100's SM clock
SPIN_CYCLES = 2_000_000


def log(*a):
    print(*a, flush=True)


def time_ms(fn, flush, iters=10):
    """Median ms of one call of fn over `iters` calls on the card (a host
    stall moves a mean, not the median): CUDA events around each call, L2
    flushed before each (the main path finds its inputs mostly cold).
    Between the flush and the first event the card spins for about 1 ms,
    so the host has queued the call's launches before the card reaches
    them: the time is the card's, not the host's launch overhead, unless
    the call waits on the host (a plain version that reads a result back).
    torch.profiler's kernel records are not used: on the H100 a trace of
    many launches lost some of them."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def close(got, ref, dtype):
    atol, rtol = TOL[dtype]
    err = (got.detach().float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    return ok, float(err.max())


def close_grad(got, ref):
    """A gradient against the plain one (see GRAD_TOL); not None."""
    if got is None:
        return False, float("inf")
    rtol = GRAD_TOL if got.dtype == torch.float32 else 2.0 ** -7
    r = ref.float()
    err = (got.float() - r).abs()
    ok = bool((err <= GRAD_TOL * float(r.abs().max()) + rtol * r.abs()).all())
    return ok and got.dtype == ref.dtype, float(err.max())


def demangle(names):
    """{mangled: short C++ name} of kernel symbols (cu++filt from the CUDA
    toolkit, else c++filt; the argument list and the anonymous namespace
    dropped), or the names as given when neither tool is there."""
    from vitadapter_torch.ops import cuda_ext

    names = sorted(set(names))
    for tool in (os.path.join(os.path.dirname(cuda_ext.nvcc_path()),
                              "cu++filt"), shutil.which("c++filt")):
        if not names or not tool or not os.path.isfile(tool):
            continue
        out = subprocess.run([tool, *names], capture_output=True, text=True,
                             check=True).stdout.splitlines()
        if len(out) == len(names):
            return {n: short_name(d) for n, d in zip(names, out)}
    return {n: n for n in names}


def short_name(decl):
    """A demangled kernel's name with its template arguments: the return
    type, the anonymous namespace and the parameter list dropped."""
    decl = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::", "", decl)
    depth = 0
    for i, ch in enumerate(decl):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            return decl[:i]
    return decl


def ptxas_lines(text):
    """(kernel, line) of the register, shared-memory and spill lines of an
    `nvcc -Xptxas -v` log, each named by the kernel instantiation whose
    entry ptxas was compiling."""
    entries = re.findall(r"Compiling entry function '([^']+)'", text)
    names = demangle(entries)
    kernel, out = "?", []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = names[m.group(1)]
        elif "registers" in line or "spill" in line:
            out.append((kernel, line.split(":", 1)[-1].strip()
                        if "ptxas info" in line else line.strip()))
    return out


def sass_counts(lib):
    """Tensor-core instructions in a built library's SASS, by kernel
    instantiation: Hopper warpgroup products by input type ("HGMMA.TF32",
    "HGMMA.BF16") and warp ones ("HMMA"); or a note when the toolkit has
    no cuobjdump."""
    from vitadapter_torch.ops import cuda_ext

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_ext.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return "cuobjdump not available"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)", sass)[1:]
    names = demangle(parts[0::2])
    counts = {}
    for fn, body in zip(parts[0::2], parts[1::2]):
        c = {"HGMMA.TF32": len(re.findall(r"\bHGMMA\.\S*\.TF32\b", body)),
             "HGMMA.BF16": len(re.findall(r"\bHGMMA\.\S*\.BF16\b", body)),
             "HMMA": len(re.findall(r"\bHMMA\b", body))}
        counts[names[fn]] = c
    return counts


def bound_ms(nbytes, flops, dtype):
    """Least time for the work: bytes over HBM rate, or operations over the
    peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_bound_ms(nbytes, flops, dtype, split_bytes):
    """`bound_ms` of an attention kernel; for fp32, the split-TF32 floor:
    the bytes plus the pre-pass's (`split_bytes`: its hi/lo copies written
    and read once) over HBM rate, or three TF32 products per product over
    the TF32 peak. Also returns the CUDA-core figure (`bound_ms` at the
    fp32 FMA peak, without the pre-pass), None for bf16."""
    if dtype != torch.float32:
        return bound_ms(nbytes, flops, dtype), None
    t_bytes = (nbytes + split_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = SPLIT_PRODUCTS * flops / TF32_FLOPS * 1e3
    return ((max(t_bytes, t_ops),
             "bytes" if t_bytes >= t_ops else "operations"),
            bound_ms(nbytes, flops, dtype))


def split_copy_bytes(shape, rows, cols):
    """Bytes of the fp32 attention's split copies, written once and read
    once: hi and lo of `rows` operands as laid out and of `cols` transposed
    with N padded to 64 (`attention.split_scratch_floats`)."""
    from vitadapter_torch.ops import attention as at

    B, H, N, D = shape
    return 2 * 4 * at.split_scratch_floats(B * H, N, D, rows, cols)


def corners_in_map(x01, y01, H, W):
    """Bilinear corners inside an (H, W) map of points (x, y) in [0, 1]."""
    x0 = torch.floor(x01 * W - 0.5)
    y0 = torch.floor(y01 * H - 0.5)
    n = 0
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            n += int(((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).sum())
    return n


def touched_rows(loc_l, H, W):
    """Distinct (batch, head, cell) rows of one (H, W) level that the
    in-map bilinear corners of the points loc_l (B, Lq, M, P, 2) read: the
    value rows a sampling function must load at least once."""
    B, _, M = loc_l.shape[:3]
    dev = loc_l.device
    x0 = torch.floor(loc_l[..., 0] * W - 0.5).long()
    y0 = torch.floor(loc_l[..., 1] * H - 0.5).long()
    bm = (torch.arange(B, device=dev)[:, None, None, None] * M
          + torch.arange(M, device=dev)[None, None, :, None]) * (H * W)
    seen = torch.zeros(B * M * H * W, dtype=torch.bool, device=dev)
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            seen[(bm + yi * W + xi)[inside]] = True
    return int(seen.sum())


def msda_touched_bytes(shapes, value, loc):
    """Bytes of the value rows that the points of all levels read."""
    row = value.shape[-1] * value.element_size()
    return row * sum(touched_rows(loc[:, :, :, lvl], H, W)
                     for lvl, (H, W) in enumerate(shapes))


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def new_row(library=True, plain=True):
    row = dict(max_abs_err=0.0, ms=0.0, bound_ms=0.0,
               library_ms=0.0 if library else None, bound_by=set())
    if plain:
        row["plain_ms"] = 0.0
    return row


def add_to_row(row, calls, err, k_ms, p_ms, b, lib_ms=None):
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["ms"] += calls * k_ms
    if p_ms is not None:
        row["plain_ms"] += calls * p_ms
    row["bound_ms"] += calls * b[0]
    row["bound_by"].add(b[1])
    if lib_ms is not None:
        row["library_ms"] += calls * lib_ms


def msda_inputs(shapes, Lq, M, dtype, gen, B=2, D=32, P=4):
    dev = "cuda"
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, M, D, generator=gen, device=dev).to(dtype)
    loc = torch.rand(B, Lq, M, L, P, 2, generator=gen, device=dev) * 1.2 - 0.1
    # some integer-valued pixel coordinates (loc * size - 0.5 integer) ...
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=dev)[None, None, None, :, None, :]
    snap = torch.rand(B, Lq, M, L, P, 1, generator=gen, device=dev) < 0.1
    loc = torch.where(snap, (torch.floor(loc * size) + 0.5) / size, loc)
    # ... and some far off the map
    far = torch.rand(B, Lq, M, L, P, 1, generator=gen, device=dev) < 0.02
    loc = torch.where(far, loc * 7.0 - 3.0, loc)
    attn = torch.softmax(torch.randn(B, Lq, M, L * P, generator=gen,
                                     device=dev), -1).reshape(B, Lq, M, L, P)
    g = torch.randn(B, Lq, M * D, generator=gen, device=dev).to(dtype)
    return value, loc.contiguous(), attn.contiguous(), g


def msda_model_locations(shapes, grid, M, P, gen, device="cuda", B=1):
    """Sampling locations (B, Lq, M, L, P, 2) shaped as the model makes
    them: each query's reference point, plus `msda.msda_grid_init(M, L, P)`'s
    offsets (head h along angle 2 pi h / M, point p at p + 1 pixels) and
    N(0, 1) pixels of noise, over the level's (W, H). `grid` None: the
    queries are the value's cells, level by level, each at its own cell's
    centre (the pixel decoder); (h, w): the cell centres of an h x w grid
    (the injectors' 1/16 token grid); a tuple of (h, w) grids: the cell
    centres of each in turn (the extractors' queries, the SPM pyramid's
    cells, over the one 1/16 level). About 10% of the points are snapped
    to integer pixel coordinates (loc * size - 0.5 integer) and about 2%
    moved onto a border cell (one coordinate into the map's first or last
    cell). `gen` is a generator on `device`."""
    from vitadapter_torch.ops import msda

    L = len(shapes)
    if grid == "boxes":
        return msda_box_locations(shapes, M, P, gen, device, B)
    refs = []
    grids = (shapes if grid is None else (grid,) if isinstance(grid[0], int)
             else grid)
    for h, w in grids:
        y, x = torch.meshgrid((torch.arange(h, device=device) + 0.5) / h,
                              (torch.arange(w, device=device) + 0.5) / w,
                              indexing="ij")
        refs.append(torch.stack([x, y], -1).reshape(h * w, 2))
    ref = torch.cat(refs)[None, :, None, None, None, :]
    Lq = ref.shape[1]
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=device)[:, None, :]               # (L, 1, 2)
    offsets = msda.msda_grid_init(M, L, P).to(device).reshape(M, L, P, 2)

    def rand(last):
        return torch.rand(B, Lq, M, L, P, last, generator=gen, device=device)

    noise = torch.randn(B, Lq, M, L, P, 2, generator=gen, device=device)
    loc = ref + (offsets + noise) / size
    edge = torch.where(rand(2) < 0.5, 0.0, size - 1.0)
    first = rand(1) < 0.5
    border = (rand(1) < 0.02) & torch.cat([first, ~first], -1)
    loc = torch.where(border, (edge + rand(2)) / size, loc)
    snap = rand(1) < 0.1
    loc = torch.where(snap, (torch.floor(loc * size) + 0.5) / size, loc)
    return loc.contiguous()


def msda_box_locations(shapes, M, P, gen, device="cuda", B=1, Lq=104):
    """Sampling locations (B, Lq, M, L, P, 2) as `MSDeformAttn` makes them
    from 4-d reference boxes: centre + (msda_grid_init offsets + N(0, 1)
    noise) / P * box side / 2, 10% of the points snapped to integer pixel
    coordinates of their level."""
    from vitadapter_torch.ops import msda

    L = len(shapes)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    centre = 0.05 + 0.9 * rand(B, Lq, 1, 1, 1, 2)
    side = 0.02 + 0.58 * rand(B, Lq, 1, 1, 1, 2)
    offsets = msda.msda_grid_init(M, L, P).to(device).reshape(M, L, P, 2)
    noise = torch.randn(B, Lq, M, L, P, 2, generator=gen, device=device)
    loc = centre + (offsets + noise) / P * side * 0.5
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=device)[:, None, :]
    snap = rand(B, Lq, M, L, P, 1) < 0.1
    loc = torch.where(snap, (torch.floor(loc * size) + 0.5) / size, loc)
    return loc.contiguous()


def msda_corners(shapes, loc):
    return sum(corners_in_map(loc[:, :, :, lvl, :, 0], loc[:, :, :, lvl, :, 1],
                              H, W) for lvl, (H, W) in enumerate(shapes))


def auction_costs(gen, B, Q, G, contested, P=12544, K=150):
    """Cost matrices as the loss builds them (class, point BCE and dice
    costs with the loss's weights) for random logits against random binary
    gt masks at P points: (B, Q, G) fp32. `contested`: the gt masks are
    sparse (one pixel in K, as uniform labels over K classes make them) and
    the queries' mask logits share one map and differ mostly by an offset,
    as in an untrained model, so every gt prefers the same few queries and
    the auction runs hundreds of rounds; otherwise every query and gt is
    independent and a few rounds settle it."""
    from vitadapter_torch.ops import matching as mt

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    labels = torch.randint(0, K, (B, G), generator=gen, device="cuda")
    if contested:
        cls = 0.3 * randn(B, Q, K + 1)
        pred = (2 * randn(B, 1, P) + 0.5 * randn(B, Q, 1)
                + 0.5 * randn(B, Q, P))
        density = 1 / K
    else:
        cls, pred, density = 2 * randn(B, Q, K + 1), 3 * randn(B, Q, P), 0.3
    gt = (torch.rand(B, G, P, generator=gen, device="cuda") < density).float()
    return (mt.classification_cost(cls, labels, 2.0)
            + mt.bce_mask_cost(pred, gt, 5.0)
            + mt.dice_cost(pred, gt, 5.0)).contiguous()


def scipy_totals(cost, n_valid):
    """Optimal total matched cost of each matrix (scipy, float64)."""
    from scipy.optimize import linear_sum_assignment

    c = cost.double().cpu().numpy()
    out = []
    for b, n in enumerate(n_valid.tolist()):
        rows, cols = linear_sum_assignment(c[b, :, :n]) if n else ([], [])
        out.append(float(c[b][rows, cols].sum()))
    return out


def auction_cases(gen):
    """{case: (cost (B, Q, G) fp32, n_valid (B,))} of the auction's checks
    and timings at `AUCTION_SHAPE`'s Q and G: "flagship", the flagship
    step's 20 matrices with every gt valid and contested costs (the timed
    case); "n_valid", 8 matrices of independent costs with 0 to 60 valid
    gts; "ties", 20 matrices of integer costs 0-3 with every gt valid (as
    `tests/test_torch_train_ops.py::_auction_case("ties")` makes them):
    ties among queries and among equal bids."""
    B, Q, G = AUCTION_SHAPE
    nv = [G, 37, 7, 1, 0, G, 12, 2]
    full = torch.full((B,), G, device="cuda")
    cases = {"flagship": (auction_costs(gen, B, Q, G, contested=True), full),
             "n_valid": (auction_costs(gen, len(nv), Q, G, contested=False),
                         torch.tensor(nv, device="cuda"))}
    cases["ties"] = (torch.randint(0, 4, (B, Q, G), generator=gen,
                                   device="cuda").float(), full)
    # phase 11's step: contested and tied costs at AUCTION_CLI
    B, Q, G = AUCTION_CLI
    full = torch.full((B,), G, device="cuda")
    cases["cli"] = (auction_costs(gen, B, Q, G, contested=True), full)
    cases["cli_ties"] = (torch.randint(0, 4, (B, Q, G), generator=gen,
                                       device="cuda").float(), full)
    # phase 20's GroundingDINO step: 7 launches of batch-2 matrices of 100
    # queries x 1 gt (DINO's focal + L1 + GIoU costs, of order 1-10), the
    # gt valid; and an image whose one box the crop removed (n_valid 0:
    # every query unmatched)
    B, Q, G = AUCTION_GROUNDING
    cost = 10 * torch.rand(B, Q, G, generator=gen, device="cuda") - 2
    cases["grounding"] = (cost, torch.full((B,), G, device="cuda"))
    cases["grounding_nv0"] = (cost.clone(),
                              torch.tensor([0, G], device="cuda"))
    return cases


def check_auction(rows, flush, gen):
    """auction: the kernel against the plain auction on the card (the same
    matches and the same rounds), and its total matched cost against
    scipy's optimum: within n_valid * eps above it (the auction's bound)
    plus fp32 rounding, at `auction_cases`. The log gives microseconds per
    round: the kernel's time over the most rounds of any matrix (the
    blocks run side by side). Then the shared memory the kernel asks for
    (`auction.cu`'s `smem_bytes` and `kStaticSmem`) against
    `matching.auction_smem_bytes`, which `check_kernel_inputs` applies: at
    Q = 200 the largest G the formula lets through must launch and give
    the plain version's matches, and one more gt must be refused by the
    formula and by the kernel's entry point alike."""
    from vitadapter_torch.ops import cuda_ext, matching as mt

    ok = True
    for case, (cost, n_valid) in auction_cases(gen).items():
        B, Q, G = cost.shape
        nv = n_valid.tolist()
        owner, iters = mt._kernel_auction(cost, n_valid)
        ref, ref_iters = mt.auction_assign_plain(cost, n_valid)
        torch.cuda.synchronize()
        same = bool((owner.long() == ref).all()) and bool(
            (iters.long() == ref_iters).all())
        err = float((owner.long() - ref).abs().max())
        scipy_totals(cost[:1], n_valid[:1])      # import scipy untimed
        t0 = time.perf_counter()
        opt = scipy_totals(cost, n_valid)
        scipy_ms = (time.perf_counter() - t0) * 1e3
        own = owner.long()
        got = torch.where(own >= 0, cost.gather(2, own.clamp(min=0)[..., None])
                          [..., 0], 0.0).double().sum(1).tolist()
        span = torch.where(torch.arange(G, device="cuda")[None, None]
                           < n_valid[:, None, None], cost.abs(), 0.0).amax(
            dim=(1, 2)).clamp(min=1e-6)
        gap = [g - o for g, o in zip(got, opt)]
        within = all(-1e-5 * abs(o) <= d <= n * float(s) / mt.EPS_DIV
                     + 1e-5 * abs(o)
                     for d, o, n, s in zip(gap, opt, nv, span.tolist()))
        matched = [int((own[b] >= 0).sum()) for b in range(len(nv))]
        good = same and within and matched == nv
        ok &= good
        k_ms = time_ms(lambda: mt._kernel_auction(cost, n_valid), flush)
        p_ms = time_ms(lambda: mt.auction_assign_plain(cost, n_valid), flush,
                       iters=3)
        # per round, each free gt scans its Q values (a subtraction and two
        # comparisons) and each query its G bids: 4 G Q operations at most
        rounds = iters.long().tolist()
        ops = sum(4 * G * Q * r for r in rounds)
        b = bound_ms(nbytes(cost, n_valid, owner, iters), ops, torch.float32)
        us_round = k_ms * 1e3 / max(max(rounds), 1)
        log(f"auction {case:8s} ({len(nv)}, {Q}, {G}) fp32 n_valid={nv[:8]} "
            f"same matches and rounds as plain={same} max_abs_err={err:.1f} "
            f"total - scipy optimum max {max(gap):.3e} within "
            f"n_valid*eps={within} rounds min/mean/max {min(rounds)}/"
            f"{sum(rounds) / len(rounds):.1f}/{max(rounds)} ok={good} "
            f"kernel_ms={k_ms:.4f} us_per_round={us_round:.3f} "
            f"plain_ms={p_ms:.4f} scipy_host_ms={scipy_ms:.2f} "
            f"bound_ms={b[0]:.6f} ({b[1]})")
        if case == "flagship":
            add_to_row(rows["auction"], 1, err, k_ms, p_ms, b)
            rows["auction"]["us_per_round"] = us_round
        elif case == "cli":
            add_to_row(rows["auction"].setdefault("paths", {}).setdefault(
                "cli", new_row(library=False)), 1, err, k_ms, p_ms, b)
        elif case == "grounding":
            # 7 assignments a phase 20 step: 6 decoder layers, the encoder
            add_to_row(rows["auction"].setdefault("paths", {}).setdefault(
                "grounding", new_row(library=False)), 7, err, k_ms, p_ms, b)

    def refused(fn, exc, words):
        try:
            fn()
        except exc as e:
            return words in str(e)
        return False

    B, Q, G = AUCTION_SHAPE
    g_max = max(g for g in range(1, 4096)
                if mt.auction_smem_bytes(Q, g) <= mt.SMEM_OPTIN)
    big = auction_costs(gen, 1, Q, g_max + 1, contested=False).contiguous()
    fits = big[..., :g_max].contiguous()
    nv1 = torch.tensor([G], device="cuda")
    mt.check_kernel_inputs(fits, nv1)
    owner, iters = mt._kernel_auction(fits, nv1)
    ref, ref_iters = mt.auction_assign_plain(fits, nv1)
    same = bool((owner.long() == ref).all()) and bool(
        (iters.long() == ref_iters).all())
    by_formula = refused(lambda: mt.check_kernel_inputs(big, nv1), ValueError,
                         "shared memory")
    nv32 = nv1.int()
    out = torch.empty((1, Q), dtype=torch.int32, device="cuda")
    by_kernel = refused(lambda: cuda_ext.launch(
        "auction", big.device, big.data_ptr(), nv32.data_ptr(),
        out.data_ptr(), iters.data_ptr(), 1, Q, g_max + 1, mt.EPS_DIV,
        mt.MAX_ITERS), RuntimeError, "invalid argument")
    torch.cuda.synchronize()
    good = same and by_formula and by_kernel
    ok &= good
    log(f"auction shared memory: (1, {Q}, {g_max}) takes "
        f"{mt.auction_smem_bytes(Q, g_max)} of {mt.SMEM_OPTIN} bytes, "
        f"launches, same matches and rounds as plain={same}; "
        f"(1, {Q}, {g_max + 1}) refused by auction_smem_bytes={by_formula}, "
        f"by the kernel's entry point={by_kernel} ok={good}")
    return ok


def fused_launch(value, shapes, loc, attn, g):
    """msda_fwd and msda_bwd launched once each, as `msda._kernel_forward`
    and `_kernel_backward` launch them, into fresh outputs filled with NaN
    first, so that an entry a kernel leaves unwritten fails every
    comparison: (out, d value, d loc, d attn)."""
    from vitadapter_torch.ops import cuda_ext, msda

    B, S, M, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    nan = float("nan")
    out = torch.full((B, Lq, M * D), nan, dtype=value.dtype, device="cuda")
    dvalue = torch.full_like(value, nan)
    acc = dvalue if value.dtype == F32 else torch.full(
        value.shape, nan, dtype=F32, device="cuda")
    dloc, dattn = torch.full_like(loc, nan), torch.full_like(attn, nan)
    levels, starts, _keep = msda._level_arrays(shapes)
    bf16 = int(value.dtype == BF16)
    cuda_ext.launch("msda_fwd", value.device, value.data_ptr(),
                    loc.data_ptr(), attn.data_ptr(), out.data_ptr(), B, S, M,
                    D, Lq, L, P, levels, starts, bf16)
    cuda_ext.launch("msda_bwd", value.device, value.data_ptr(),
                    loc.data_ptr(), attn.data_ptr(), g.data_ptr(),
                    acc.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(),
                    dattn.data_ptr(), B, S, M, D, Lq, L, P, levels, starts,
                    bf16)
    return out, dvalue, dloc, dattn


def msda_plain(value, shapes, loc, attn, g, heads=None, backward=True):
    """`ms_deform_attn_plain` and (with `backward`) its gradients by
    `ms_deform_attn_plain_backward` on `heads` heads at a time (all by
    default), joined along the heads: (out, d value, d loc, d attn), or
    (out,). At the paths' sizes the plain version's gathered corners of
    all heads would not fit beside the rest."""
    from vitadapter_torch.ops import msda

    B, Lq, M = loc.shape[:3]
    D = value.shape[-1]
    heads = heads or M
    g4 = g.reshape(B, Lq, M, D)
    parts = []
    for h in range(0, M, heads):
        v, lc, a = (t[:, :, h:h + heads].contiguous()
                    for t in (value, loc, attn))
        gh = g4[:, :, h:h + heads].reshape(B, Lq, -1)
        out = msda.ms_deform_attn_plain(v, shapes, lc, a)
        grads = (msda.ms_deform_attn_plain_backward(v, shapes, lc, a, gh)
                 if backward else ())
        parts.append((out.reshape(B, Lq, -1, D), *grads))
    out, *grads = (torch.cat(p, 2) for p in zip(*parts))
    return (out.reshape(B, Lq, M * D), *grads)


def check_fused(value, shapes, loc, attn, g, heads=None):
    """The fused kernels on one set of inputs: launched twice into fresh
    outputs (`fused_launch`), the output, d loc and d attn bitwise equal
    across the launches, and each launch against the plain version
    (`msda_plain`): the output within `TOL`, each gradient within
    `GRAD_TOL` (d value from atomics, so not bitwise). Returns (ok,
    words for the log, the output's error, the gradients' largest)."""
    first, second = (fused_launch(value, shapes, loc, attn, g)
                     for _ in range(2))
    same = all(torch.equal(first[i], second[i]) for i in (0, 2, 3))
    ref = msda_plain(value, shapes, loc, attn, g, heads)
    torch.cuda.synchronize()
    fwd = [close(r[0], ref[0], value.dtype) for r in (first, second)]
    grads = [close_grad(r[i], ref[i]) for r in (first, second)
             for i in (1, 2, 3)]
    ok = same and all(c[0] for c in fwd + grads)
    err = max(c[1] for c in fwd)
    err_b = max(c[1] for c in grads)
    words = (f"max_abs_err={err:.3e}, grads (value, loc, attn)="
             f"{[f'{c[1]:.3e}' for c in grads[:3]]}; relaunch bitwise equal "
             f"(out, d loc, d attn)={same} ok={ok}")
    return ok, words, err, err_b


def msda_bounds(shapes, value, loc, attn, g):
    """(forward bound, backward bound) of the fused kernels: the sampling
    arithmetic is fp32 whatever the value dtype, 2 flops per channel per
    in-map corner forward, 4 backward (the g.v dot and the scaled scatter
    into d value); bytes: the value rows the points touch, read once, the
    output (the size and dtype of g) written once; the backward reads g and
    writes the whole d value, d loc and d attn."""
    D = value.shape[-1]
    corners = msda_corners(shapes, loc)
    touched = msda_touched_bytes(shapes, value, loc)
    return (bound_ms(touched + nbytes(loc, attn, g), 2 * D * corners, F32),
            bound_ms(touched + nbytes(value) + 2 * nbytes(loc, attn)
                     + nbytes(g), 4 * D * corners, F32))


def check_msda(rows, flush, gen):
    """msda_fwd and msda_bwd at the flagship's geometries, fp32 and bf16,
    on `msda_inputs`' uniform locations (through `MSDeformAttnFunction`,
    timed beside the plain versions: the rows' numbers) and on
    `msda_model_locations`' model-shaped ones (the rows' `model_shaped`
    numbers); on both, `check_fused`'s relaunch. The row sums are bf16's,
    per forward (msda_fwd) and per train step (msda_bwd)."""
    from vitadapter_torch.ops import msda

    ok = True
    for dtype in (F32, BF16):
        for name, (shapes, Lq, M, calls) in MSDA_GEOMETRIES.items():
            value, loc, attn, g = msda_inputs(shapes, Lq, M, dtype, gen)
            loc_m = msda_model_locations(shapes, MSDA_QUERY_GRID[name], M, 4,
                                         gen, B=2)
            ok &= loc_m.shape == loc.shape
            ins = [t.detach().clone().requires_grad_()
                   for t in (value, loc, attn)]
            got = msda.ms_deform_attn(ins[0], shapes, ins[1], ins[2])
            got.backward(g)
            ref = msda.ms_deform_attn_plain(value, shapes, loc, attn)
            ref_g = msda.ms_deform_attn_plain_backward(value, shapes, loc,
                                                       attn, g)
            torch.cuda.synchronize()
            good, err = close(got, ref, dtype)
            checks = [close_grad(t.grad, r) for t, r in zip(ins, ref_g)]
            good_b = all(c[0] for c in checks)
            err_b = max(c[1] for c in checks)
            ok &= good and good_b
            del ins, got, ref, ref_g
            head = f"{name:13s} {str(dtype):14s} B=2 Lq={Lq} M={M}"
            for kind, lc in (("uniform", loc), ("model-shaped", loc_m)):
                good_r, words, err_r, err_rb = check_fused(value, shapes, lc,
                                                           attn, g)
                ok &= good_r
                log(f"msda_fwd/msda_bwd {head} {kind} launched twice: "
                    f"{words}")
                with torch.no_grad():
                    k_ms = time_ms(lambda: msda.ms_deform_attn(
                        value, shapes, lc, attn), flush)
                    kb_ms = time_ms(lambda: msda._kernel_backward(
                        value, shapes, lc, attn, g), flush)
                fb, bb = msda_bounds(shapes, value, lc, attn, g)
                if kind == "uniform":
                    with torch.no_grad():
                        p_ms = time_ms(lambda: msda.ms_deform_attn_plain(
                            value, shapes, loc, attn), flush, iters=3)
                    pb_ms = time_ms(lambda: msda.ms_deform_attn_plain_backward(
                        value, shapes, loc, attn, g), flush, iters=3)
                    log(f"msda_fwd {head} S={value.shape[1]} max_abs_err="
                        f"{err:.3e} ok={good} kernel_ms={k_ms:.4f} plain_ms="
                        f"{p_ms:.4f} bound_ms={fb[0]:.4f} ({fb[1]})")
                    log(f"msda_bwd {head} grads via the autograd wrapper: "
                        f"max_abs_err (value, loc, attn)="
                        f"{[f'{c[1]:.3e}' for c in checks]} ok={good_b} "
                        f"kernel_ms={kb_ms:.4f} plain_ms={pb_ms:.4f} "
                        f"bound_ms={bb[0]:.4f} ({bb[1]})")
                    if dtype == BF16:
                        add_to_row(rows["msda_fwd"], calls, max(err, err_r),
                                   k_ms, p_ms, fb)
                        add_to_row(rows["msda_bwd"], calls,
                                   max(err_b, err_rb), kb_ms, pb_ms, bb)
                    continue
                log(f"msda_fwd {head} model-shaped kernel_ms={k_ms:.4f} "
                    f"bound_ms={fb[0]:.4f} ({fb[1]}); msda_bwd kernel_ms="
                    f"{kb_ms:.4f} bound_ms={bb[0]:.4f} ({bb[1]})")
                if dtype == BF16:
                    for kernel, e, t, b in (("msda_fwd", err_r, k_ms, fb),
                                            ("msda_bwd", err_rb, kb_ms, bb)):
                        add_to_row(rows[kernel].setdefault(
                            "model_shaped", new_row(library=False,
                                                    plain=False)),
                                   calls, e, t, None, b)
            del value, loc, loc_m, attn, g
    torch.cuda.empty_cache()
    return ok


def check_msda_paths(rows, flush, gen):
    """msda_fwd and msda_bwd at `MSDA_PATH_CASES`, on uniform locations
    (the `MODEL_SHAPED_PATHS` cases on model-shaped ones too), at the
    path's batch, dtype and head dim (`PATH_BATCH`, `PATH_DTYPE`,
    `PATH_D`; else 1, fp32, 32): `check_fused` against the plain versions
    four heads at a time, then the forward (and, where the path takes one,
    the backward) timed beside the plain version on the uniform locations.
    The numbers go to the rows' `paths`, summed over each path's calls."""
    from vitadapter_torch.ops import msda

    ok = True
    for name, (shapes, Lq, M, grid, path, calls, backward) in \
            MSDA_PATH_CASES.items():
        B = PATH_BATCH.get(path, 1)
        dtype = PATH_DTYPE.get(path, F32)
        value, loc, attn, g = msda_inputs(shapes, Lq, M, dtype, gen, B=B,
                                          D=PATH_D.get(path, 32))
        good, words, err, err_b = check_fused(value, shapes, loc, attn, g,
                                              heads=4)
        ok &= good
        if path in MODEL_SHAPED_PATHS:
            loc_m = msda_model_locations(shapes, grid, M, 4, gen, B=B)
            good_m, words_m, err_m, err_mb = check_fused(
                value, shapes, loc_m, attn, g, heads=4)
            ok &= good_m and loc_m.shape == loc.shape
            err, err_b = max(err, err_m), max(err_b, err_mb)
            words += f"; model-shaped: {words_m}"
            del loc_m
        fb, bb = msda_bounds(shapes, value, loc, attn, g)
        with torch.no_grad():
            k_ms = time_ms(lambda: msda.ms_deform_attn(value, shapes, loc,
                                                       attn), flush, iters=5)
            p_ms = time_ms(lambda: msda_plain(value, shapes, loc, attn, g,
                                              heads=4, backward=False),
                           flush, iters=1)
        text = (f"msda {name} {dtype} B={B} Lq={Lq} M={M} "
                f"D={value.shape[-1]} S={value.shape[1]} "
                f"({path}, {calls} calls): {words}; msda_fwd kernel_ms="
                f"{k_ms:.4f} plain_ms={p_ms:.4f} (4 heads at a time) "
                f"bound_ms={fb[0]:.4f} ({fb[1]})")
        add_to_row(rows["msda_fwd"].setdefault("paths", {}).setdefault(
            path, new_row(library=False)), calls, err, k_ms, p_ms, fb)
        if backward:
            with torch.no_grad():
                kb_ms = time_ms(lambda: msda._kernel_backward(
                    value, shapes, loc, attn, g), flush, iters=5)
            pb_ms = time_ms(lambda: msda_plain(value, shapes, loc, attn, g,
                                               heads=4), flush, iters=1)
            text += (f"; msda_bwd kernel_ms={kb_ms:.4f} plain_ms="
                     f"{pb_ms:.4f} bound_ms={bb[0]:.4f} ({bb[1]})")
            add_to_row(rows["msda_bwd"].setdefault("paths", {}).setdefault(
                path, new_row(library=False)), calls, err_b, kb_ms, pb_ms,
                bb)
        log(text)
        del value, loc, attn, g
        torch.cuda.empty_cache()
    return ok


def check_msda_fused_layouts(gen):
    """msda_fwd and msda_bwd at the `FUSED_LAYOUTS` cases (other P, ragged
    and narrow rows, one to eight levels, a misaligned value), fp32 and
    bf16, on both sets of locations, through `check_fused`."""
    ok = True
    for name, (shapes, grid, M, D, P, misaligned) in FUSED_LAYOUTS.items():
        loc_m = msda_model_locations(shapes, grid, M, P, gen)
        Lq = loc_m.shape[1]
        for dtype in (F32, BF16):
            value, loc, attn, g = msda_inputs(shapes, Lq, M, dtype, gen, B=1,
                                              D=D, P=P)
            if misaligned:
                buf = torch.empty(value.numel() + 1, dtype=dtype,
                                  device="cuda")
                buf[1:].copy_(value.reshape(-1))
                value = buf[1:].view(value.shape)
                ok &= value.data_ptr() % 16 != 0
            for kind, lc in (("uniform", loc), ("model-shaped", loc_m)):
                good, words, _, _ = check_fused(value, shapes, lc, attn, g)
                ok &= good
                log(f"msda_fwd/msda_bwd layout {name} {str(dtype):14s} "
                    f"{kind} L={len(shapes)} B=1 Lq={Lq} M={M} D={D} P={P}: "
                    f"{words}")
    torch.cuda.empty_cache()
    return ok


def grid_sample_inputs(value_l, loc_l, H, W):
    """One level as `F.grid_sample` takes it (the yardstick): the value as
    fp32 (B * M, D, H, W) maps, the points as (B * M, Lq, P, 2) in [-1, 1]."""
    B, _, M, D = value_l.shape
    Lq, P = loc_l.shape[1], loc_l.shape[3]
    inp = value_l.float().reshape(B, H, W, M, D).permute(0, 3, 4, 1, 2)
    grid = (loc_l * 2 - 1).permute(0, 2, 1, 3, 4)
    return (inp.reshape(B * M, D, H, W).contiguous(),
            grid.reshape(B * M, Lq, P, 2).contiguous())


SAMPLE = dict(mode="bilinear", padding_mode="zeros", align_corners=False)


def check_level(value, shapes, lvl, loc, attn, g, flush, gen, full):
    """One level of the per-level route on one set of locations:
    msda_level_fwd and msda_level_dgrid against their plain versions
    (`_sample_one_level`, `level_dgrid_plain`), each launched twice into
    fresh outputs that must agree bit for bit, and msda_level_dv against
    `level_dv_plain` (`close_grad`: its sums come from atomics) in a
    zeroed fp32 buffer whose rows off the level must stay zero; the buffer
    is 4 bytes off 16-byte alignment when the value is (the scalar
    instantiation). Times each launch beside its bound and `F.grid_sample`
    (forward; backward to the grid for d loc, to the input for d value),
    with `full` beside its plain version too; msda_level_dv's words give
    its atomic payload (in-map corners x D x 4 bytes) and that payload's
    rate. Bounds count the value rows the points touch, read once, and
    each output written once: the forward's fp32 (B, Lq, M, D), d value's
    whole level, d loc's and d attn's level slices. Returns (ok, {kernel:
    (err, ms, plain ms or None, bound, library ms)}, words for the log)."""
    from vitadapter_torch.ops import msda

    B, S, M, D = value.shape
    Lq = loc.shape[1]
    H, W = shapes[lvl]
    start = msda.level_start_index(shapes)[lvl]
    value_l = value[:, start:start + H * W]
    loc_l, attn_l = loc[:, :, :, lvl], attn[:, :, :, lvl]
    g4 = g.reshape(B, Lq, M, D)
    runs = []
    for _ in range(2):
        out = torch.zeros((B, Lq, M, D), dtype=F32, device="cuda")
        dloc = torch.full_like(loc, float("nan"))
        dattn = torch.full_like(attn, float("nan"))
        msda.level_forward(value, shapes, lvl, loc, attn, out)
        msda.level_grad_grid(value, shapes, lvl, loc, attn, g, dloc, dattn)
        runs.append((out, dloc[:, :, :, lvl], dattn[:, :, :, lvl]))
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    out, dl, da = runs[0]
    ref = msda._sample_one_level(value_l, loc_l, attn_l, H, W)
    ref_dl, ref_da = msda.level_dgrid_plain(value_l, loc_l, attn_l, g4, H, W)
    torch.cuda.synchronize()
    good_f, err_f = close(out, ref, F32)
    c_l, c_a = close_grad(dl, ref_dl), close_grad(da, ref_da)
    good_g, err_g = c_l[0] and c_a[0], max(c_l[1], c_a[1])
    ok = good_f and good_g and same
    del runs, ref, ref_dl, ref_da, dl, da

    corners = corners_in_map(loc_l[..., 0], loc_l[..., 1], H, W)
    touched = touched_rows(loc_l, H, W) * D * value.element_size()
    ops = 2 * D * corners
    la = nbytes(loc_l, attn_l)
    fb = bound_ms(touched + la + B * Lq * M * D * 4, ops, F32)
    gb = bound_ms(touched + nbytes(g) + 2 * la, ops, F32)
    dloc = torch.empty_like(loc)
    dattn = torch.empty_like(attn)
    inp, grid = grid_sample_inputs(value_l, loc_l, H, W)
    with torch.no_grad():
        k_f = time_ms(lambda: msda.level_forward(
            value, shapes, lvl, loc, attn, out), flush)
        k_g = time_ms(lambda: msda.level_grad_grid(
            value, shapes, lvl, loc, attn, g, dloc, dattn), flush)
        l_f = time_ms(lambda: F.grid_sample(inp, grid, **SAMPLE), flush)
    inp.requires_grad_()
    grid.requires_grad_()
    lib_out = F.grid_sample(inp, grid, **SAMPLE)
    go = torch.randn(lib_out.shape, generator=gen, device="cuda")
    l_g = time_ms(lambda: torch.autograd.grad(lib_out, grid, go,
                                              retain_graph=True), flush)
    numbers = {"msda_level_fwd": [err_f, k_f, None, fb, l_f],
               "msda_level_dgrid": [err_g, k_g, None, gb, l_g]}
    words = {"msda_level_fwd": f"max_abs_err={err_f:.3e} ok={good_f}",
             "msda_level_dgrid": (f"max_abs_err (loc, attn)=({c_l[1]:.3e}, "
                                  f"{c_a[1]:.3e}) ok={good_g}")}
    words["msda_level_fwd"] += (
        f" bitwise-equal twice={same}; touched {touched / 2 ** 20:.1f} of "
        f"the level's {nbytes(value_l) / 2 ** 20:.1f} MiB of value")
    off = int(value.data_ptr() % 16 != 0)
    dv = torch.zeros(B * S * M * D + off, dtype=F32, device="cuda")[off:]
    dv = dv.view(B, S, M, D)
    msda.level_grad_value(value, shapes, lvl, loc, attn, g, dv)
    ref_dv = msda.level_dv_plain(loc_l, attn_l, g4, H, W)
    torch.cuda.synchronize()
    good_v, err_v = close_grad(dv[:, start:start + H * W], ref_dv)
    good_v &= not (dv[:, :start].any() or dv[:, start + H * W:].any())
    ok &= good_v
    del ref_dv
    vb = bound_ms(la + nbytes(g) + B * H * W * M * D * 4, ops, F32)
    with torch.no_grad():
        k_v = time_ms(lambda: msda.level_grad_value(
            value, shapes, lvl, loc, attn, g, dv), flush)
    l_v = time_ms(lambda: torch.autograd.grad(lib_out, inp, go,
                                              retain_graph=True), flush)
    payload = corners * D * 4
    numbers["msda_level_dv"] = [err_v, k_v, None, vb, l_v]
    words["msda_level_dv"] = (
        f"max_abs_err={err_v:.3e} ok={good_v} (dv 16-byte aligned="
        f"{dv.data_ptr() % 16 == 0}); atomic payload "
        f"{payload / 1e9:.4f} GB at {payload / k_v / 1e9:.3f} TB/s")
    del dv
    if full:
        with torch.no_grad():
            numbers["msda_level_fwd"][2] = time_ms(
                lambda: msda._sample_one_level(value_l, loc_l, attn_l, H, W),
                flush, iters=3)
        numbers["msda_level_dgrid"][2] = time_ms(
            lambda: msda.level_dgrid_plain(value_l, loc_l, attn_l, g4, H, W),
            flush, iters=3)
        numbers["msda_level_dv"][2] = time_ms(
            lambda: msda.level_dv_plain(loc_l, attn_l, g4, H, W), flush,
            iters=3)
    return ok, numbers, words


def log_level(words, numbers, head):
    """One line per kernel of `check_level`'s result."""
    library = {"msda_level_fwd": "grid_sample_ms",
               "msda_level_dv": "grid_sample_bwd_input_ms",
               "msda_level_dgrid": "grid_sample_bwd_grid_ms"}
    for kernel, (err, k_ms, p_ms, b, l_ms) in numbers.items():
        plain = "" if p_ms is None else f" plain_ms={p_ms:.4f}"
        log(f"{kernel} {head} {words[kernel]} kernel_ms={k_ms:.4f}{plain} "
            f"{library[kernel]}={l_ms:.4f} bound_ms={b[0]:.4f} ({b[1]})")


def check_msda_levels(rows, flush, gen):
    """msda_level_fwd, msda_level_dv and msda_level_dgrid at every
    `LEVEL_GEOMETRIES` shape, level by level (`check_level`), on two sets
    of locations: `msda_inputs`' uniform ones (the numbers of the kernels'
    rows, plain versions timed) and `msda_model_locations`' model-shaped
    ones (the rows' `model_shaped` numbers); then the whole
    per-level route through the wrapper (`MSDeformAttnLevelFunction`)
    against `ms_deform_attn_plain` and its autograd, and in fp32 against
    the fused kernels (`MSDeformAttnFunction`, which takes any S): output
    and all three gradients within 1e-5 of the fused result's largest
    entry."""
    from vitadapter_torch.ops import msda

    ok = True
    payload_gb = {}  # msda_level_dv's atomic payload per over-line step
    for name, (shapes, Lq, M, dtypes, on_path) in LEVEL_GEOMETRIES.items():
        for dtype in dtypes:
            value, loc, attn, g = msda_inputs(shapes, Lq, M, dtype, gen, B=1)
            loc_m = msda_model_locations(shapes, LEVEL_QUERY_GRID[name], M,
                                         4, gen)
            ok &= loc_m.shape == loc.shape
            S, D = value.shape[1], value.shape[3]
            # the fp32 values pass the 8 MiB line; the bf16 one, half the
            # bytes, stays under it (the route test below then applies
            # `MSDeformAttnLevelFunction` itself)
            route = msda.msda_route(value.shape, dtype)
            ok &= route == ("level" if dtype == F32 else "fused")
            for lvl, (H, W) in enumerate(shapes):
                for kind, lc in (("uniform", loc), ("model-shaped", loc_m)):
                    good, numbers, words = check_level(
                        value, shapes, lvl, lc, attn, g, flush, gen,
                        full=kind == "uniform")
                    ok &= good
                    which = ("_sample_kernel_onehot_pf" if H * W <= 1024
                             else "_sample_kernel")
                    words["msda_level_fwd"] = (f"(the TPU's {which}) "
                                               + words["msda_level_fwd"])
                    log_level(words, numbers,
                              f"{name} {str(dtype):14s} {kind} level {lvl} "
                              f"({H}, {W}) B=1 Lq={Lq} M={M}")
                    for kernel, (err, k_ms, p_ms, b, l_ms) in numbers.items():
                        if not on_path or on_path[0] != LEVEL_ROW_PATH[kernel]:
                            continue
                        row = rows[kernel]
                        if kind != "uniform":
                            row = row.setdefault("model_shaped", new_row(
                                plain=False))
                        add_to_row(row, on_path[1], err, k_ms, p_ms, b, l_ms)
                        if kernel == "msda_level_dv":
                            # in-map corners x D x 4 bytes, as check_level
                            # logs it; a log line, not a row's number
                            gb = corners_in_map(lc[:, :, :, lvl, :, 0],
                                                lc[:, :, :, lvl, :, 1], H,
                                                W) * D * 4 / 1e9
                            payload_gb[kind] = (payload_gb.get(kind, 0.0)
                                                + on_path[1] * gb)
                    if dtype == F32 and H * W <= 1024:
                        err, k_ms, p_ms, b, l_ms = numbers["msda_level_fwd"]
                        row = rows["msda_level_fwd"].setdefault(
                            "small_level", {})
                        if kind != "uniform":
                            row = row.setdefault("model_shaped", {})
                        row.update(shape=[H, W], ms=k_ms, library_ms=l_ms,
                                   bound_ms=b[0], bound_by=b[1],
                                   max_abs_err=err)
                        if p_ms is not None:
                            row["plain_ms"] = p_ms

            # the whole route, through the wrapper where it takes it
            ins = [t.detach().clone().requires_grad_()
                   for t in (value, loc, attn)]
            fn = (msda.ms_deform_attn if route == "level"
                  else msda.MSDeformAttnLevelFunction.apply)
            got = fn(ins[0], tuple(shapes), ins[1], ins[2])
            got.backward(g)
            ref = msda.ms_deform_attn_plain(value, shapes, loc, attn)
            ref_g = msda.ms_deform_attn_plain_backward(value, shapes, loc,
                                                       attn, g)
            torch.cuda.synchronize()
            good, err = close(got, ref, dtype)
            checks = [close_grad(t.grad, r) for t, r in zip(ins, ref_g)]
            good_b = all(c[0] for c in checks)
            ok &= good and good_b
            del ref, ref_g
            vs_fused = ""
            if dtype == F32:
                fused = [t.detach().clone().requires_grad_()
                         for t in (value, loc, attn)]
                f_out = msda.MSDeformAttnFunction.apply(
                    fused[0], tuple(shapes), fused[1], fused[2])
                f_out.backward(g)
                rel = [float((a - b).abs().max() / b.abs().max())
                       for a, b in zip((got.detach(), *(t.grad for t in ins)),
                                       (f_out.detach(),
                                        *(t.grad for t in fused)))]
                good_fused = all(r <= 1e-5 for r in rel)
                ok &= good_fused
                vs_fused = (f" vs the fused kernels (out, d value, d loc, "
                            f"d attn) err/max={[f'{r:.2e}' for r in rel]} "
                            f"ok={good_fused}")
                del fused, f_out
            log(f"msda route {name} {str(dtype):14s} S={S} "
                f"({S * D * value.element_size() / 2 ** 20:.2f} MiB per "
                f"head) route={route}: out max_abs_err={err:.3e} ok={good}; "
                f"grads via MSDeformAttnLevelFunction max_abs_err (value, "
                f"loc, attn)={[f'{c[1]:.3e}' for c in checks]} ok={good_b}"
                + vs_fused)
            del value, loc, loc_m, attn, g, ins, got
            torch.cuda.empty_cache()
    dv = rows["msda_level_dv"]
    for kind, row in (("uniform", dv), ("model-shaped", dv["model_shaped"])):
        log(f"msda_level_dv per over-line step ({kind}): atomic payload "
            f"{payload_gb[kind]:.2f} GB in {row['ms']:.3f} ms, "
            f"{payload_gb[kind] / row['ms']:.3f} TB/s")
    return ok


def check_msda_level_layouts(flush, gen):
    """msda_level_fwd, msda_level_dv and msda_level_dgrid at the
    `LEVEL_LAYOUTS` cases (another P, ragged and narrow rows, a misaligned
    value and d value buffer), fp32 and bf16, on both sets of locations,
    through `check_level`."""
    ok = True
    for name, (shapes, grid, M, D, P, misaligned) in LEVEL_LAYOUTS.items():
        Lq = grid[0] * grid[1]
        for dtype in (F32, BF16):
            value, loc, attn, g = msda_inputs(shapes, Lq, M, dtype, gen, B=1,
                                              D=D, P=P)
            if misaligned:
                buf = torch.empty(value.numel() + 1, dtype=dtype,
                                  device="cuda")
                buf[1:].copy_(value.reshape(-1))
                value = buf[1:].view(value.shape)
                ok &= value.data_ptr() % 16 != 0
            loc_m = msda_model_locations(shapes, grid, M, P, gen)
            for kind, lc in (("uniform", loc), ("model-shaped", loc_m)):
                for lvl, (H, W) in enumerate(shapes):
                    good, numbers, words = check_level(
                        value, shapes, lvl, lc, attn, g, flush, gen,
                        full=False)
                    ok &= good
                    log_level(words, numbers,
                              f"{name} {str(dtype):14s} {kind} level {lvl} "
                              f"({H}, {W}) B=1 Lq={Lq} M={M} D={D} P={P}")
            del value, loc, loc_m, attn, g
    torch.cuda.empty_cache()
    return ok


def check_attention(rows, flush, gen):
    """attention_fwd and attention_bwd (through `FusedAttentionFunction`),
    with the row log-sum-exp and fp32 output the forward saves for the
    backward. The forward is checked and timed as a forward alone (serving)
    and as it runs before a backward (the fp32 output written too)."""
    from vitadapter_torch.ops import attention as at

    ok = True
    sdpa = F.scaled_dot_product_attention
    for dtype in (torch.float32, torch.bfloat16):
        # ragged lengths, the other head dims, and N under one 64-row tile
        cases = [ATTN_SHAPE, (2, 16, 1000, 64), (1, 3, 130, 32),
                 (1, 2, 77, 128), (1, 4, 40, 64), (1, 2, 20, 128)]
        for shape in cases:
            q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda")
                          .to(dtype) for _ in range(4))
            ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            scale = shape[-1] ** -0.5
            got = at.fused_attention(*ins)
            saved_out32, saved_lse = got.grad_fn.saved_tensors[3:]
            got.backward(g)
            same = relaunch_equal(at, got, saved_lse, ins, g) \
                if dtype == torch.float32 else None
            ref, ref_lse, ref_out32 = at.attention_plain_lse(q, k, v)
            ref_g = at.attention_plain_backward(q, k, v, g)
            with torch.no_grad():
                served = at.fused_attention(q, k, v)
            torch.cuda.synchronize()
            good, err = close(got, ref, dtype)
            good_s, err_s = close(served, ref, dtype)
            # the saved log-sum-exp and output are fp32 in every version
            good_l, err_l = close(saved_lse, ref_lse, torch.float32)
            good_o, err_o = close(saved_out32, ref_out32, torch.float32)
            checks = [close_grad(t.grad, r) for t, r in zip(ins, ref_g)]
            good_b = all(c[0] for c in checks)
            err_b = max(c[1] for c in checks)
            good_f = good and good_s and good_l and good_o
            ok &= good_f and good_b and same is not False
            lib = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lib_out = sdpa(*lib)
            with torch.no_grad():
                _, lse, out32 = at._kernel_forward(q, k, v, scale, True)
                k_ms = time_ms(lambda: at.fused_attention(q, k, v), flush)
                kt_ms = time_ms(lambda: at._kernel_forward(q, k, v, scale,
                                                           True), flush)
                p_ms = time_ms(lambda: at.attention_plain(q, k, v), flush)
                kb_ms = time_ms(lambda: at._kernel_backward(
                    q, k, v, out32, lse, g, scale), flush)
                lib_ms = time_ms(lambda: sdpa(q, k, v), flush)
            pb_ms = time_ms(lambda: at.attention_plain_backward(q, k, v, g),
                            flush)
            libb_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, lib, g, retain_graph=True), flush)
            fb, fcc, bb, bcc = attention_bounds(q, lse, out32)
            log(f"attention_fwd {str(shape):18s} {str(dtype):14s} "
                f"max_abs_err serving={err_s:.3e} before a backward={err:.3e}"
                f" (saved fp32 output {err_o:.3e}, lse {err_l:.3e}) "
                f"ok={good_f} kernel_ms={k_ms:.4f} (before a backward "
                f"{kt_ms:.4f}) plain_ms={p_ms:.4f} sdpa_ms={lib_ms:.4f} "
                f"bound_ms={fb[0]:.4f} ({fb[1]}{cuda_core_note(fcc)})"
                f"{relaunch_note(same)}")
            log(f"attention_bwd {str(shape):18s} {str(dtype):14s} grads via "
                f"the autograd wrapper: max_abs_err (q, k, v)="
                f"{[f'{c[1]:.3e}' for c in checks]} ok={good_b} "
                f"kernel_ms={kb_ms:.4f} plain_ms={pb_ms:.4f} "
                f"sdpa_bwd_ms={libb_ms:.4f} bound_ms={bb[0]:.4f} ({bb[1]}"
                f"{cuda_core_note(bcc)})")
            if dtype == torch.bfloat16 and shape == ATTN_SHAPE:
                # the library's own agreement with the plain version
                lib_g = torch.autograd.grad(lib_out, lib, g)
                lib_f = close(lib_out, ref, dtype)
                lib_b = [close_grad(a, b) for a, b in zip(lib_g, ref_g)]
                log(f"attention {str(shape)} bf16: SDPA against the plain "
                    f"version: forward ok={lib_f[0]} max_abs_err="
                    f"{lib_f[1]:.3e}, backward ok="
                    f"{all(c[0] for c in lib_b)} max_abs_err (q, k, v)="
                    f"{[f'{c[1]:.3e}' for c in lib_b]}")
                add_to_row(rows["attention_fwd"], ATTN_CALLS, max(err, err_s),
                           k_ms, p_ms, fb, lib_ms)
                add_to_row(rows["attention_bwd"], ATTN_CALLS, err_b, kb_ms,
                           pb_ms, bb, libb_ms)
    return ok


def relaunch_equal(at, got, lse, ins, g):
    """Whether a second launch of the attention forward and backward on the
    inputs `ins` gives bitwise the output `got`, its saved log-sum-exp
    `lse` and the gradients in `ins` (the kernels sum in a fixed order)."""
    again = [t.detach().clone().requires_grad_(t.requires_grad) for t in ins]
    out = at.fused_attention(*again)
    same = torch.equal(out, got)
    if got.grad_fn is not None:
        same &= torch.equal(out.grad_fn.saved_tensors[4], lse)
        out.backward(g)
        same &= all(torch.equal(a.grad, b.grad) for a, b in zip(again, ins))
    return same


def relaunch_note(same):
    return "" if same is None else f"; relaunch bitwise equal={same}"


def cuda_core_note(cc):
    return "" if cc is None else (f"; split-TF32 floor, CUDA-core bound "
                                  f"{cc[0]:.4f} ({cc[1]})")


def attention_bounds(q, lse, out32):
    """(forward bound, its CUDA-core figure, backward bound, its figure) of
    the attention kernels on q's shape (`attention_bound_ms`)."""
    B, H, N, D = q.shape
    # forward: reads q, k, v, writes out and the log-sum-exp; fp32 splits
    # q, k (rows) and v (columns)
    fb, fcc = attention_bound_ms(4 * nbytes(q) + nbytes(lse),
                                 4 * B * H * N * N * D, q.dtype,
                                 split_copy_bytes(q.shape, 2, 1))
    # backward: reads q, k, v, dO, the fp32 output and the log-sum-exp,
    # writes dq, dk, dv; q k^T again, dP = dO v^T, dv = P^T dO, dq, dk;
    # fp32 splits q, k, v, dO (rows) and k, q, dO (columns)
    bb, bcc = attention_bound_ms(7 * nbytes(q) + nbytes(out32, lse),
                                 10 * B * H * N * N * D, q.dtype,
                                 split_copy_bytes(q.shape, 4, 3))
    return fb, fcc, bb, bcc


def add_cuda_core_bound(row, calls, cc):
    """The fp32 attention rows' CUDA-core figure beside their bound."""
    row["cuda_core_bound_ms"] = row.get("cuda_core_bound_ms", 0.0) \
        + calls * cc[0]


def by_heads(fn, *ts, heads=4):
    """fn on `heads` heads of (B, H, N, D) inputs at a time, its outputs
    joined along the heads: at the main paths' lengths the plain version's
    (N, N) fp32 scores of all 16 heads would not fit beside the rest."""
    parts = [fn(*(t[:, h:h + heads] for t in ts))
             for h in range(0, ts[0].shape[1], heads)]
    return tuple(torch.cat(p, 1) for p in zip(*parts))


def check_attention_paths(rows, flush, gen):
    """Attention at the shapes of the paths that run it (`ATTN_PATH_CASES`):
    the whole-image evaluation's forwards (phase 8; `fused_attention`
    without a gradient), the over-line step (phase 9; forward, saved output
    and log-sum-exp, and the three gradients through
    `FusedAttentionFunction`), phase 13's UperNet step (batch 2, N 1024,
    with a backward), phase 15's Mask R-CNN step and test model call
    (windows of N 196, the kernels' masked key tail, and global N 4096 and
    4200), the bf16 DeiT-S Mask R-CNN step and phase 17's HTC++ step
    (ExtraAttention at head dim 128 on 2200 tokens, global N 8800),
    against the plain versions
    taken four heads at a time. The numbers go to the attention rows'
    `paths`, summed over each path's calls."""
    from vitadapter_torch.ops import attention as at

    ok = True
    sdpa = F.scaled_dot_product_attention
    for name, (B, H, N, dtype, path, calls, bwd_calls) in \
            ATTN_PATH_CASES.items():
        backward = bwd_calls > 0
        D = ATTN_PATH_D.get(name, 64)
        shape = (B, H, N, D)
        scale = D ** -0.5
        q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda")
                      .to(dtype) for _ in range(4))
        ref, ref_lse, ref32 = by_heads(
            lambda *t: at.attention_plain_lse(*t, scale), q, k, v)
        ins = [t.detach().clone().requires_grad_(backward) for t in (q, k, v)]
        got = at.fused_attention(*ins)
        good, err = close(got, ref, dtype)
        line = f"max_abs_err={err:.3e}"
        checks = []
        saved_lse = None
        if backward:
            saved_out32, saved_lse = got.grad_fn.saved_tensors[3:]
            good_l, err_l = close(saved_lse, ref_lse, F32)
            good_o, err_o = close(saved_out32, ref32, F32)
            got.backward(g)
            ref_g = by_heads(lambda *t: at.attention_plain_backward(
                *t, scale), q, k, v, g)
            checks = [close_grad(t.grad, r) for t, r in zip(ins, ref_g)]
            good &= good_l and good_o
            line += (f" (saved fp32 output {err_o:.3e}, lse {err_l:.3e}); "
                     f"grads via the autograd wrapper: max_abs_err (q, k, v)="
                     f"{[f'{c[1]:.3e}' for c in checks]}")
            del ref_g, saved_out32
        # the fp32 kernels sum in a fixed order
        same = (relaunch_equal(at, got, saved_lse, ins, g)
                if dtype == F32 else None)
        line += relaunch_note(same)
        torch.cuda.synchronize()
        good &= all(c[0] for c in checks) and same is not False
        ok &= good
        del got, ins, ref, ref_lse, ref32, saved_lse
        torch.cuda.empty_cache()
        with torch.no_grad():
            if backward:
                k_ms = time_ms(lambda: at.FusedAttentionFunction.apply(
                    q, k, v, scale, True), flush, iters=3)
            else:
                k_ms = time_ms(lambda: at.fused_attention(q, k, v), flush,
                               iters=3)
            p_ms = time_ms(lambda: by_heads(
                lambda *t: at.attention_plain_lse(*t, scale), q, k, v),
                flush, iters=3)
            lib_ms = time_ms(lambda: sdpa(q, k, v), flush, iters=3)
            out, lse, out32 = at._kernel_forward(q, k, v, scale, backward)
        fb, fcc, bb, bcc = attention_bounds(q, lse, out32)
        row = rows["attention_fwd"].setdefault("paths", {}).setdefault(
            path, new_row())
        add_to_row(row, calls, err, k_ms, p_ms, fb, lib_ms)
        if fcc is not None:
            add_cuda_core_bound(row, calls, fcc)
        text = (f"attention {name} {shape} {dtype} ({path}, {calls} forward "
                f"and {bwd_calls} backward calls): "
                f"{line} ok={good}; forward kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} sdpa_ms={lib_ms:.4f} "
                f"bound_ms={fb[0]:.4f} ({fb[1]}{cuda_core_note(fcc)})")
        if backward:
            with torch.no_grad():
                kb_ms = time_ms(lambda: at._kernel_backward(
                    q, k, v, out32, lse, g, scale), flush, iters=3)
            pb_ms = time_ms(lambda: by_heads(
                lambda *t: at.attention_plain_backward(*t, scale),
                q, k, v, g), flush, iters=3)
            lib = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lib_out = sdpa(*lib)
            libb_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, lib, g, retain_graph=True), flush, iters=3)
            row = rows["attention_bwd"].setdefault("paths", {}).setdefault(
                path, new_row())
            add_to_row(row, bwd_calls, max(c[1] for c in checks), kb_ms,
                       pb_ms, bb, libb_ms)
            if bcc is not None:
                add_cuda_core_bound(row, bwd_calls, bcc)
            text += (f"; backward kernel_ms={kb_ms:.4f} plain_ms="
                     f"{pb_ms:.4f} sdpa_bwd_ms={libb_ms:.4f} bound_ms="
                     f"{bb[0]:.4f} ({bb[1]}{cuda_core_note(bcc)})")
            del lib, lib_out
        log(text)
        del q, k, v, g, out, lse, out32
        torch.cuda.empty_cache()
    return ok


def point_bwd_points(N, P, kind, H, W, gen):
    """Points (N, P, 2) of a `POINT_BWD_LAYOUTS` kind on the card."""
    from vitadapter_torch.ops import point_sample as ps

    pts = torch.rand(N, P, 2, generator=gen, device="cuda")
    if kind == "sorted":
        return ps.sort_points_by_y(pts)
    if kind == "edges":
        r = torch.rand(N, P, 1, generator=gen, device="cuda")
        size = torch.tensor([W, H], dtype=torch.float32, device="cuda")
        pts = pts * 1.2 - 0.1
        pts = torch.where(r < 0.05, (torch.floor(pts.clamp(0, 1) * size)
                                     + 0.5) / size, pts)   # pixel centres
        pts = torch.where((r >= 0.05) & (r < 0.15), pts * 7.0 - 3.0, pts)
        pts = torch.where((r >= 0.15) & (r < 0.2),
                          torch.round(pts.clamp(0, 1)), pts)  # the borders
        nan = torch.cat([(r >= 0.2) & (r < 0.22),
                         (r >= 0.21) & (r < 0.23)], dim=-1)
        pts = torch.where(nan, float("nan"), pts)
    return pts.contiguous()


def point_bwd_nan_filled(masks, pts, g):
    """point_sample_bwd launched once into a NaN-filled d masks, against
    `point_sample_plain_backward` (`close_grad`)."""
    from vitadapter_torch.ops import point_sample as ps

    out = torch.full_like(masks, float("nan"))
    ps._launch_backward(pts, g, out)
    torch.cuda.synchronize()
    return close_grad(out, ps.point_sample_plain_backward(masks, pts, g))


def plan_words(H, W):
    from vitadapter_torch.ops import point_sample as ps

    p = ps.bwd_plan(H, W)
    return (f"plan: cluster {p.cluster}, {p.rows} rows and {p.smem_bytes} "
            f"bytes of shared memory a CTA, {p.groups} row group(s)")


def log_point_bwd_plans():
    """Phase 2: the launch plan of each point_sample_bwd call of phase 3."""
    N, H, W = POINT_GEOMETRIES[POINT_BWD][:3]
    log(f"  point_sample_bwd {POINT_BWD} ({N}, {H}, {W}) {plan_words(H, W)}")
    N, H, W = POINT_CLI[POINT_BWD][:3]
    log(f"  point_sample_bwd cli {POINT_BWD} ({N}, {H}, {W}) "
        f"{plan_words(H, W)}")
    for name, (N, H, W, *_) in POINT_BWD_LAYOUTS.items():
        log(f"  point_sample_bwd {name} ({N}, {H}, {W}) {plan_words(H, W)}")


def time_point_bwd(masks, pts, g, flush):
    """ms of the kernel (through `_kernel_backward`), the plain version and
    `F.grid_sample`'s backward on fp32 copies of the masks, and the bound,
    for one point_sample_bwd call."""
    from vitadapter_torch.ops import point_sample as ps

    H, W = masks.shape[1:]
    m4r = masks.float()[:, None].detach().clone().requires_grad_()
    lib_out = F.grid_sample(m4r, (pts * 2 - 1)[:, None], mode="bilinear",
                            padding_mode="zeros", align_corners=False)
    g4 = g[:, None, None, :]
    with torch.no_grad():
        kb_ms = time_ms(lambda: ps._kernel_backward(masks, pts, g), flush)
    pb_ms = time_ms(lambda: ps.point_sample_plain_backward(
        masks, pts, g), flush, iters=3)
    libb_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, m4r, g4, retain_graph=True), flush)
    corners = corners_in_map(pts[..., 0], pts[..., 1], H, W)
    bb = bound_ms(nbytes(pts, g, masks), 2 * corners, torch.float32)
    return kb_ms, pb_ms, libb_ms, bb


def check_point_bwd_layouts(rows, flush, gen):
    """point_sample_bwd at `POINT_BWD_LAYOUTS`, fp32 and bf16, each launched
    into a NaN-filled output; the path cases timed (bf16, the path's
    dtype) under the row's `paths`."""
    ok = True
    for name, (N, H, W, P, kind, on_path) in POINT_BWD_LAYOUTS.items():
        for dtype in (torch.float32, torch.bfloat16):
            masks = torch.randn(N, H, W, generator=gen, device="cuda") \
                .to(dtype)
            pts = point_bwd_points(N, P, kind, H, W, gen)
            g = torch.randn(N, P, generator=gen, device="cuda")
            good, err = point_bwd_nan_filled(masks, pts, g)
            ok &= good
            text = (f"point_sample_bwd layout {name:10s} {str(dtype):14s} "
                    f"({N}, {H}, {W}) x {P} {kind} points, {plan_words(H, W)}"
                    f": NaN-filled output max_abs_err={err:.3e} ok={good}")
            if on_path is not None and dtype == torch.bfloat16:
                path, calls = on_path
                kb_ms, pb_ms, libb_ms, bb = time_point_bwd(masks, pts, g,
                                                           flush)
                text += (f"; {path}, {calls} calls: kernel_ms={kb_ms:.4f} "
                         f"plain_ms={pb_ms:.4f} grid_sample_bwd_ms="
                         f"{libb_ms:.4f} bound_ms={bb[0]:.4f} ({bb[1]})")
                add_to_row(rows["point_sample_bwd"].setdefault(
                    "paths", {}).setdefault(path, new_row()), calls, err,
                    kb_ms, pb_ms, bb, libb_ms)
            log(text)
            del masks, pts, g
        torch.cuda.empty_cache()
    return ok


def check_point_sample(rows, flush, gen, geometries=POINT_GEOMETRIES,
                       path=None):
    """point_sample_fwd and point_sample_bwd (through
    `PointSampleFunction`) at `geometries`, fp32 and bf16 masks; the bf16
    numbers (the loss samples bf16 mask logits) go to the rows, or to
    their `paths[path]`. The yardstick is `F.grid_sample` on fp32 copies
    of the masks, the points mapped to [-1, 1]."""
    from vitadapter_torch.ops import point_sample as ps

    def row(name):
        if path is None:
            return rows[name]
        return rows[name].setdefault("paths", {}).setdefault(path, new_row())

    ok = True
    head = "" if path is None else f"{path} "
    for dtype in (torch.float32, torch.bfloat16):
        for name, (N, H, W, P, sort, calls) in geometries.items():
            masks = torch.randn(N, H, W, generator=gen, device="cuda") \
                .to(dtype)
            pts = torch.rand(N, P, 2, generator=gen, device="cuda")
            if sort:
                pts = ps.sort_points_by_y(pts)
            has_grad = name == POINT_BWD
            m_in = masks.detach().clone().requires_grad_(has_grad)
            got = ps.point_sample(m_in, pts)
            ref = ps.point_sample_plain(masks, pts)
            good, err = close(got, ref, torch.float32)
            checks = []
            if has_grad:
                g = torch.randn(N, P, generator=gen, device="cuda")
                got.backward(g)
                checks = [close_grad(m_in.grad, ps.point_sample_plain_backward(
                    masks, pts, g)), point_bwd_nan_filled(masks, pts, g)]
            torch.cuda.synchronize()
            good_b = all(c[0] for c in checks)
            ok &= good and good_b
            corners = corners_in_map(pts[..., 0], pts[..., 1], H, W)
            m4 = masks.float()[:, None]
            grid = (pts * 2 - 1)[:, None]
            with torch.no_grad():
                k_ms = time_ms(lambda: ps.point_sample(masks, pts), flush)
                p_ms = time_ms(lambda: ps.point_sample_plain(masks, pts),
                               flush, iters=3)
                lib_ms = time_ms(lambda: F.grid_sample(
                    m4, grid, mode="bilinear", padding_mode="zeros",
                    align_corners=False), flush)
            fb = bound_ms(nbytes(masks, pts) + N * P * 4, 2 * corners,
                          torch.float32)
            log(f"point_sample_fwd {head}{name:12s} {str(dtype):14s} "
                f"({N}, {H}, {W}) x {P} {'sorted' if sort else 'unsorted'} "
                f"points max_abs_err={err:.3e} ok={good} kernel_ms="
                f"{k_ms:.4f} plain_ms={p_ms:.4f} grid_sample_ms={lib_ms:.4f} "
                f"bound_ms={fb[0]:.4f} ({fb[1]}), {calls} calls a step")
            if dtype == torch.bfloat16:
                add_to_row(row("point_sample_fwd"), calls, err, k_ms, p_ms,
                           fb, lib_ms)
            if not has_grad:
                continue
            kb_ms, pb_ms, libb_ms, bb = time_point_bwd(masks, pts, g, flush)
            err_b = max(c[1] for c in checks)
            log(f"point_sample_bwd {head}{name:12s} {str(dtype):14s} d "
                f"masks via the autograd wrapper and launched into a "
                f"NaN-filled output, {plan_words(H, W)}: max_abs_err="
                f"{checks[0][1]:.3e}, {checks[1][1]:.3e} ok={good_b} "
                f"kernel_ms={kb_ms:.4f} plain_ms={pb_ms:.4f} "
                f"grid_sample_bwd_ms={libb_ms:.4f} bound_ms={bb[0]:.4f} "
                f"({bb[1]}), {calls} calls a step")
            if dtype == torch.bfloat16:
                add_to_row(row("point_sample_bwd"), calls, err_b, kb_ms,
                           pb_ms, bb, libb_ms)
    return ok


def check_kernels(flush):
    """Phase 3. Returns each kernel's numbers at the flagship's bf16 shapes,
    summed over its calls in one batch-2 forward (forward kernels) or one
    batch-2 train step (the others; one forward runs in each step); the
    per-level MSDA kernels' in fp32 at their main path's shapes, summed
    over its level launches in one flagship forward at ratio 1.5
    (msda_level_fwd, phase 8) or in one over-line train step (msda_level_dv
    and _dgrid, phase 9)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    rows = {name: new_row(library=name not in ("msda_fwd", "msda_bwd",
                                                 "auction", "nms"))
            for name in REPLACES}
    ok = check_msda(rows, flush, gen)
    ok &= check_msda_paths(rows, flush, gen)
    ok &= check_msda_fused_layouts(gen)
    ok &= check_msda_levels(rows, flush, gen)
    ok &= check_msda_level_layouts(flush, gen)
    ok &= check_attention(rows, flush, gen)
    ok &= check_attention_paths(rows, flush, gen)
    ok &= check_point_sample(rows, flush, gen)
    ok &= check_point_sample(rows, flush, gen, POINT_CLI, "cli")
    ok &= check_point_bwd_layouts(rows, flush, gen)
    ok &= check_auction(rows, flush, gen)
    ok &= check_nms(rows, flush, gen)
    if not ok:
        raise SystemExit("FAIL: a kernel disagrees with its plain version")
    log("TPU kernels covered by a ported kernel: " + json.dumps(COVERS)
        + "; at D = 32 the flagship's 64x64 and 32x32 levels are JAX's "
        "band-matmul levels (msda_pallas._bandmm_mode), so with "
        "VITADAPTER_MSDA_BANDMM=1 its injector and pixel-decoder forwards "
        "take that kernel; msda_fwd's numbers above are at those inputs")
    for r in rows.values():
        for row in (r, *r.get("paths", {}).values(),
                    *([r["model_shaped"]] if "model_shaped" in r else [])):
            row["bound_by"] = "/".join(sorted(row["bound_by"]))
    return rows


def serve_flagship(requests=SERVE_REQUESTS):
    """Phase 4: the flagship eval forward on batch-2 uint8 requests."""
    from vitadapter_torch import zoo
    from vitadapter_torch.data.preprocess import normalize
    from vitadapter_torch.ops import cuda_ext

    t0 = time.perf_counter()
    model = zoo.mask2former_vit_adapter(
        "large", dtype=torch.bfloat16,
        generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"flagship built: {n_params / 1e6:.1f} M params fp32, "
        f"{time.perf_counter() - t0:.1f} s")
    host = torch.Generator().manual_seed(1)
    batches = [torch.randint(0, 256, (2, 512, 512, 3), dtype=torch.uint8,
                             generator=host) for _ in range(requests)]
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.launches.clear()
    times = []
    with torch.inference_mode():
        for img in batches:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = model(normalize(img.cuda(), dtype=torch.bfloat16))
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
            if tuple(out.shape) != (2, 512, 512, 150):
                raise SystemExit(f"FAIL: logits shape {tuple(out.shape)}")
            if not bool(torch.isfinite(out).all()):
                raise SystemExit("FAIL: non-finite logits")
    counts = dict(cuda_ext.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"msda_fwd": 16 * requests, "attention_fwd": 24 * requests}
    log(f"flagship requests (ms, CUDA events, host->device copy included): "
        f"{[round(t, 2) for t in times]}")
    steady = times[1:]
    log(f"flagship bf16 batch 2: {2 * len(steady) / (sum(steady) / 1e3):.3f} "
        f"img/s over requests 2..{requests}, first request "
        f"{times[0]:.1f} ms, peak memory {peak:.2f} GiB")
    log(f"launches in {requests} requests: {counts} (want {want})")
    if counts != want:
        raise SystemExit("FAIL: the flagship path did not launch each "
                         "kernel as often as expected")
    del model
    torch.cuda.empty_cache()
    return counts


def randomize(model, gen):
    """Give every zero/one-initialized weight random values (injector gamma,
    MSDA offset and weight heads, biases, norm scales, BN statistics)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1 and (name.endswith("weight") or "gamma" in name):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            elif p.ndim == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif name.endswith(("sampling_offsets.weight",
                                "attention_weights.weight",
                                "relative_position_bias_table")):
                p.copy_(torch.randn(p.shape, generator=gen)
                        / p.shape[1] ** 0.5)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.3 * torch.randn(m.running_mean.shape,
                                                       generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=gen))


def reduced_model(gen, **kw):
    """Depth 4 at full width on the CPU, one block per interaction."""
    from vitadapter_torch import zoo

    model = zoo.mask2former_vit_adapter(
        "large", device="cpu", generator=gen, depth=4,
        interaction_indexes=((0, 0), (1, 1), (2, 2), (3, 3)), **kw)
    randomize(model, gen)
    return model


def card_vs_cpu():
    """Phase 5: reduced depth, full width, fp32; kernels vs plain versions."""
    from vitadapter_torch.data.preprocess import normalize
    from vitadapter_torch.ops import cuda_ext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(2)
    cpu = reduced_model(gen)
    card = copy.deepcopy(cpu).cuda()
    img = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                        generator=gen)
    before = dict(cuda_ext.launches)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu(normalize(img))
        t_cpu = time.perf_counter() - t0
        got = card(normalize(img.cuda())).cpu()
    used = {k: v - before.get(k, 0) for k, v in cuda_ext.launches.items()}
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    ok = (err <= E2E_RTOL * scale and tuple(got.shape) == (2, 128, 128, 150)
          and bool(torch.isfinite(got).all()))
    log(f"reduced model (depth 4, full width) fp32 card vs CPU: "
        f"max_abs_err={err:.3e} max|ref|={scale:.3e} rel={err / scale:.3e} "
        f"(tol {E2E_RTOL}) ok={ok}; CPU forward {t_cpu:.1f} s; "
        f"kernel launches {used}")
    if not ok or used.get("msda_fwd", 0) != 16 or used.get("attention_fwd",
                                                           0) != 4:
        raise SystemExit("FAIL: reduced model card vs CPU")


def train_flagship(steps=TRAIN_STEPS):
    """Phase 6: the flagship train step, as the JAX package's bench sets it
    up: batch 2 at 512x512, fp32 parameters, bf16 compute, DropPath 0.4,
    labels in [0, 150), 60 instances, 12544 points, AdamW with layer decay
    (total 1000 steps, warmup 10, clip 0.01), the auction assignment."""
    from vitadapter_torch import zoo
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_m2f_train_step

    model = zoo.mask2former_vit_adapter(
        "large", dtype=torch.bfloat16,
        generator=torch.Generator("cuda").manual_seed(0))
    opt, _ = make_optimizer(model, depth=24, total_steps=1000,
                            warmup_steps=10, grad_clip=0.01)
    state = TrainState.create(model, opt)
    step = make_m2f_train_step(model, num_classes=150, max_instances=60,
                               num_points=12544)
    gen = torch.Generator("cuda").manual_seed(3)
    batch = {"image": torch.randn(2, 512, 512, 3, generator=gen,
                                  device="cuda").to(torch.bfloat16),
             "label": torch.randint(0, 150, (2, 512, 512), generator=gen,
                                    device="cuda")}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.launches.clear()
    times, losses, norms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, logs = step(state, batch, gen)
        loss, norm = float(logs["loss"]), float(logs["grad_norm"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        norms.append(norm)
    counts = dict(cuda_ext.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    n_params = len(before)
    changed = n_params - len(still)
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    log(f"flagship train steps (s, host clock to a synchronize): "
        f"{[round(t, 3) for t in times]}; losses {losses}; grad norms "
        f"{norms}; last logs {({k: float(v) for k, v in logs.items()})}")
    log(f"flagship bf16 batch-2 train step: {sum(times[1:]) / (steps - 1):.3f}"
        f" s/step over steps 2..{steps}, first step {times[0]:.3f} s, peak "
        f"memory {peak:.2f} GiB; {changed} of {n_params} parameter tensors "
        f"changed (unchanged: {still})")
    log(f"launches in {steps} train steps: {counts} (want {want})")
    finite = all(map(lambda x: x == x and abs(x) != float("inf"),
                     losses + norms))
    if not finite or changed < 0.95 * n_params or state.step != steps:
        raise SystemExit("FAIL: flagship train step (non-finite loss or "
                         "gradient norm, or parameters did not move)")
    if counts != want:
        raise SystemExit("FAIL: the flagship train step did not launch each "
                         "kernel as often as expected")
    del model, opt, state, before
    torch.cuda.empty_cache()
    return counts


def train_card_vs_cpu():
    """Phase 7: one train step of the reduced model, fp32, TF32 off, drop
    path 0, 1024 points, on the card (kernels) and on the CPU (plain
    versions), with the same weights, batch and sampler draws; compares the
    loss and the gradient norm. Each label map holds 8 classes in blocks,
    as an ADE20K image holds about ten: the auction then matches 8 gts per
    image, so costs that differ between the sides by float rounding have
    few near-equal bids to flip."""
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.ops.point_sample import uniform_sampler
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_m2f_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(4)
    cpu = reduced_model(gen, drop_path_rate=0.0)
    card = copy.deepcopy(cpu).cuda()
    ids = torch.randint(0, 150, (2, 8), generator=gen)
    cells = torch.randint(0, 8, (2, 16), generator=gen)
    label = ids.gather(1, cells).reshape(2, 4, 4)
    batch = {"image": torch.randn(2, 128, 128, 3, generator=gen),
             "label": label.repeat_interleave(32, 1).repeat_interleave(32, 2)}
    results = {}
    for side, model in (("cpu", cpu), ("cuda", card)):
        opt, _ = make_optimizer(model, depth=4, total_steps=1000,
                                warmup_steps=0, grad_clip=0.01)
        step = make_m2f_train_step(model, num_classes=150, num_points=1024)
        b = {k: v.to(side) for k, v in batch.items()}
        sampler = uniform_sampler(torch.Generator().manual_seed(5))
        before = dict(cuda_ext.launches)
        t0 = time.perf_counter()
        _, logs = step(TrainState.create(model, opt), b,
                       torch.Generator(side).manual_seed(6), sampler)
        logs = {k: float(v) for k, v in logs.items()}
        results[side] = (logs, time.perf_counter() - t0, {
            k: v - before.get(k, 0) for k, v in cuda_ext.launches.items()
            if v != before.get(k, 0)})
    (ref, t_cpu, _), (got, t_card, used) = results["cpu"], results["cuda"]
    rel = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12)
           for k in ("loss", "grad_norm")}
    ok = all(r <= TRAIN_RTOL for r in rel.values())
    log(f"reduced model (depth 4, full width) fp32 train step card vs CPU: "
        f"card {got} CPU {ref} rel {rel} (tol {TRAIN_RTOL}) ok={ok}; "
        f"CPU step {t_cpu:.1f} s, card step {t_card:.2f} s; kernel launches "
        f"{used}")
    want = dict(TRAIN_LAUNCHES, attention_fwd=4, attention_bwd=4)
    if not ok or used != want:
        raise SystemExit("FAIL: reduced model train step card vs CPU "
                         f"(launches {used}, want {want})")


class Items:
    """A dataset of given (uint8 HxWx3 image, int HxW label) pairs."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def load(self, i):
        return self.items[i]


def block_labels(gen, h, w, classes, cell):
    """A label map of cell x cell blocks of random classes in [0, classes)
    (cropped at the edges)."""
    ids = torch.randint(0, classes, (-(-h // cell), -(-w // cell)),
                        generator=gen)
    lab = ids.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    return lab[:h, :w].numpy().astype("int32")


def eval_flagship_whole():
    """Phase 8: the flagship in fp32 (as the JAX configs evaluate it: no
    dtype set) through `run_eval` on one uint8 1024x2048 image, whole mode,
    img_scale (2048, 1024), ratios (1.0, 1.5) with flip. At ratio 1.5 the
    injectors' and the pixel decoder's values hold 11.8 MiB per head and
    take the per-level kernels; the extractors' 2.25 MiB stay fused."""
    from vitadapter_torch import zoo
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.train.loop import run_eval

    model = zoo.mask2former_vit_adapter(
        "large", generator=torch.Generator("cuda").manual_seed(0))
    host = torch.Generator().manual_seed(8)
    h, w = EVAL_HW
    img = torch.randint(0, 256, (h, w, 3), dtype=torch.uint8,
                        generator=host).numpy()
    label = block_labels(host, h, w, 150, 128)
    label[:64] = 255                     # an ignored band
    calls = []

    def pre(_m, args):
        s = torch.cuda.Event(enable_timing=True)
        s.record()
        calls.append([tuple(args[0].shape), s, None, None])

    def post(_m, _args, out):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        calls[-1][2] = e
        calls[-1][3] = torch.isfinite(out).all()

    hooks = [model.register_forward_pre_hook(pre),
             model.register_forward_hook(post)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.launches.clear()
    t0 = time.perf_counter()
    metrics = run_eval(EVAL_CFG, model, Items([(img, label)]),
                       aug_test=True, log_fn=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(cuda_ext.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for hk in hooks:
        hk.remove()
    fwd = [(shape, s.elapsed_time(e), bool(fin))
           for shape, s, e, fin in calls]
    cm = metrics["confusion"]
    labelled = int((label != 255).sum())
    log(f"flagship fp32 whole-image eval of one {h}x{w} image, ratios "
        f"{EVAL_CFG['aug_test']['img_ratios']} with flip: forwards (input "
        f"shape, ms, logits finite) {[(s, round(t, 2), f) for s, t, f in fwd]}"
        f"; run_eval {wall:.2f} s in all, peak memory {peak:.2f} GiB; "
        f"confusion sums to {int(cm.sum())} of {labelled} labelled pixels; "
        f"mIoU {metrics['mIoU']:.4f} (random weights)")
    log(f"launches in the evaluation: {counts} (want {EVAL_LAUNCHES})")
    finite = all(f for _, _, f in fwd) and len(fwd) == 4
    if not finite or int(cm.sum()) != labelled \
            or metrics["mIoU"] != metrics["mIoU"]:
        raise SystemExit("FAIL: flagship whole-image evaluation (non-finite "
                         "logits or a confusion matrix that does not count "
                         "the labelled pixels)")
    if counts != EVAL_LAUNCHES:
        raise SystemExit("FAIL: the evaluation did not launch each kernel "
                         "as often as expected")
    del model
    torch.cuda.empty_cache()
    return counts


def train_overline():
    """Phase 9: one fp32 train step of the reduced model (depth 4, full
    width), drop path 0, batch 1 at 1792x1792: the injectors' and the pixel
    decoder's values hold 8.04 MiB per head, over the line, so their
    forward and backward take the per-level kernels."""
    from vitadapter_torch import zoo
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_m2f_train_step

    model = zoo.mask2former_vit_adapter(
        "large", num_queries=OVERLINE_QUERIES, depth=4,
        interaction_indexes=((0, 0), (1, 1), (2, 2), (3, 3)),
        drop_path_rate=0.0, generator=torch.Generator("cuda").manual_seed(0))
    randomize(model, torch.Generator().manual_seed(9))
    opt, _ = make_optimizer(model, depth=4, total_steps=1000,
                            warmup_steps=0, grad_clip=0.01)
    state = TrainState.create(model, opt)
    step = make_m2f_train_step(model, num_classes=150)
    gen = torch.Generator("cuda").manual_seed(10)
    n = OVERLINE_HW
    label = block_labels(torch.Generator().manual_seed(11), n, n, 150, 448)
    batch = {"image": torch.randn(1, n, n, 3, generator=gen, device="cuda"),
             "label": torch.from_numpy(label).long()[None].cuda()}
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.launches.clear()
    t0 = time.perf_counter()
    state, logs = step(state, batch, gen)
    logs = {k: float(v) for k, v in logs.items()}
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    counts = dict(cuda_ext.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    still = [k for k, p in model.named_parameters()
             if torch.equal(p.detach(), before[k])]
    log(f"reduced fp32 train step at {n}x{n}, batch 1, {OVERLINE_QUERIES} "
        f"queries: {took:.2f} s (the first step: builds included), peak "
        f"memory {peak:.2f} GiB; logs {logs}; {len(before) - len(still)} "
        f"of {len(before)} parameter tensors changed (unchanged: {still})")
    log(f"launches in the step: {counts} (want {OVERLINE_LAUNCHES})")
    finite = all(v == v and abs(v) != float("inf") for v in logs.values())
    if not finite or len(still) > 0.05 * len(before):
        raise SystemExit("FAIL: over-line train step (non-finite loss or "
                         "gradient norm, or parameters did not move)")
    if counts != OVERLINE_LAUNCHES:
        raise SystemExit("FAIL: the over-line train step did not launch each "
                         "kernel as often as expected")
    del model, opt, state, before
    torch.cuda.empty_cache()
    return counts


def eval_card_vs_cpu():
    """Phase 10: `run_eval` with the reduced model in fp32, whole mode, on
    two odd-sized non-square images, ratios (0.75, 1.0) with flip, on the
    card (kernels) and on the CPU (plain versions): the confusion matrices
    may differ in at most EVAL_CM_SHARE of the labelled pixels."""
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.train.loop import run_eval

    gen = torch.Generator().manual_seed(12)
    cpu = reduced_model(gen)
    card = copy.deepcopy(cpu).cuda()
    items = []
    for h, w in ((97, 151), (131, 83)):
        img = torch.randint(0, 256, (h, w, 3), dtype=torch.uint8,
                            generator=gen).numpy()
        items.append((img, block_labels(gen, h, w, 150, 24)))
    cfg = {"num_classes": 150,
           "test_cfg": {"mode": "whole", "img_scale": (192, 128)},
           "aug_test": {"img_ratios": [0.75, 1.0], "flip": True}}
    cms, secs = {}, {}
    before = dict(cuda_ext.launches)
    for side, model in (("cpu", cpu), ("cuda", card)):
        t0 = time.perf_counter()
        cms[side] = run_eval(cfg, model, Items(items), aug_test=True,
                             log_fn=lambda *_: None)["confusion"]
        secs[side] = time.perf_counter() - t0
    used = {k: v - before.get(k, 0) for k, v in cuda_ext.launches.items()
            if v != before.get(k, 0)}
    labelled = sum(int(lab.size) for _, lab in items)
    moved = int(abs(cms["cuda"] - cms["cpu"]).sum()) // 2
    ok = (moved <= EVAL_CM_SHARE * labelled
          and int(cms["cuda"].sum()) == labelled)
    want = {"msda_fwd": 8 * 16, "attention_fwd": 8 * 4}
    log(f"reduced model fp32 run_eval card vs CPU, images (97, 151) and "
        f"(131, 83), ratios (0.75, 1.0) with flip: {moved} of {labelled} "
        f"labelled pixels predicted differently (tol {EVAL_CM_SHARE} of "
        f"them) ok={ok}; CPU {secs['cpu']:.1f} s, card {secs['cuda']:.2f} s;"
        f" kernel launches {used} (want {want})")
    if not ok or used != want:
        raise SystemExit("FAIL: run_eval card vs CPU")


def write_ade_images(root, sizes, seed):
    """uint8 JPEG images and PNG labels in 0..150 (0 is ADE20K's ignored
    label) in the ADE20K layout under `root`, in blocks of 64 pixels."""
    import numpy as np
    from PIL import Image

    img_dir = os.path.join(root, "images", "validation")
    ann_dir = os.path.join(root, "annotations", "validation")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    host = torch.Generator().manual_seed(seed)
    for i, (h, w) in enumerate(sizes):
        img = torch.randint(0, 256, (h, w, 3), dtype=torch.uint8,
                            generator=host).numpy()
        Image.fromarray(img).save(os.path.join(img_dir, f"{i:04d}.jpg"),
                                  quality=95)
        lab = block_labels(host, h, w, 151, 64).astype(np.uint8)
        Image.fromarray(lab).save(os.path.join(ann_dir, f"{i:04d}.png"))


def launch_diff(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def run_config_cli(name, config, options, step_launches, never, aug_options,
                   forward_launches=None, refuse_small_crops=False):
    """The config entry points in this process, so that the launch counters
    can be read: `tools.train.main` for `CLI_STEPS` steps on synthetic data
    with `options` (checkpoints, the eval hook), `--resume` for one more
    step, then `tools.test.main` on two ADE20K-layout images (`CLI_IMAGES`),
    slide mode, without and with `--aug-test` (one image, `aug_options`),
    and `run_eval` called directly on the same weights. Checks the launches
    of each train step (`step_launches`), those of each model call of the
    test CLI (`forward_launches`, when given), that no kernel of `never`
    runs, the resume, finite losses and mIoU, and the test CLI's confusion
    matrix against `run_eval`'s; with `refuse_small_crops`, that the
    default `--aug-test` ratios raise (BEiT's tables). Everything is
    written into a temporary directory, removed at the end. Logs under
    `name`; returns the launches of the first run's train steps."""
    import tempfile

    from vitadapter_torch.builder import build_model
    from vitadapter_torch.models.segmentor import EncoderDecoder
    from vitadapter_torch.models.mask2former_segmentor import \
        EncoderDecoderMask2Former
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.tools import test as test_cli
    from vitadapter_torch.tools import train as train_cli
    from vitadapter_torch.train.loop import (build_dataset, eval_config,
                                             run_eval)
    from vitadapter_torch.utils.checkpoint_io import load_model_weights
    from vitadapter_torch.utils.config import Config

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    steps = CLI_STEPS
    calls = [0]
    forwards = {cls: cls.forward for cls in (EncoderDecoder,
                                             EncoderDecoderMask2Former)}

    def counted(cls):
        def forward(self, *a, **kw):
            calls[0] += 1
            return forwards[cls](self, *a, **kw)
        return forward

    try:
        for cls in forwards:
            cls.forward = counted(cls)
        work, root = os.path.join(tmp, "work"), os.path.join(tmp, "ade")
        lines, marks = [], {}

        def log_fn(line):
            log(f"  | {line}")
            lines.append(line)
            m = re.match(r"iter (\d+)/", line)
            if m:       # the step's launches, before its checkpoint or eval
                marks[int(m.group(1))] = dict(cuda_ext.launches)

        train_args = [config, "--synthetic-data", "--work-dir", work,
                      "--cfg-options", *options]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_ext.launches.clear()
        t0 = time.perf_counter()
        state = train_cli.main(train_args + ["--max-iters", str(steps)],
                               log_fn=log_fn)
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_params = sum(p.numel() for p in state.model.parameters())
        del state
        torch.cuda.empty_cache()
        first_run = dict(cuda_ext.launches)
        per_step = [launch_diff(marks[k], marks.get(k - 1, {}))
                    for k in range(1, steps + 1)]
        train_counts = marks[steps]
        iters = [l for l in lines if re.match(r"iter \d+/", l)]
        secs = [float(re.search(r"time=([0-9.]+)s", l).group(1))
                for l in iters]
        vals = {k: [float(re.search(rf"{k}=(\S+)", l).group(1)) for l in iters]
                for k in ("loss", "grad_norm")}
        ckpts = [(int(a), float(b)) for a, b in
                 re.findall(r"checkpoint of step \d+: (\d+) bytes in "
                            r"([0-9.]+) s", "\n".join(lines))]
        built = next(l for l in lines if "parameters;" in l)

        mark = len(lines)
        state = train_cli.main(train_args + ["--max-iters", str(steps + 1),
                                             "--resume"], log_fn=log_fn)
        resumed = lines[mark:]
        resumed_ok = (f"resumed from step {steps}" in resumed
                      and state.step == steps + 1
                      and any(l.startswith(f"iter {steps + 1}/")
                              for l in resumed))
        del state
        torch.cuda.empty_cache()

        write_ade_images(root, CLI_IMAGES, 13)
        ckpt = os.path.join(work, "ckpt")

        def test_args(flags, options=()):
            return [config, ckpt, "--eval", "mIoU", *flags,
                    "--cfg-options", f"data.data_root={root}", *options]

        aug = ["--aug-test", "--max-images", "1"]
        results, eval_s, eval_counts, n_calls = {}, {}, {}, {}
        for kind, args in (("slide", test_args([])),
                           ("aug_test", test_args(aug, aug_options))):
            before = dict(cuda_ext.launches)
            calls[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[kind] = test_cli.main(args, log_fn=log_fn)
            torch.cuda.synchronize()
            eval_s[kind] = time.perf_counter() - t0
            eval_counts[kind] = launch_diff(cuda_ext.launches, before)
            n_calls[kind] = calls[0]

        refused = True
        if refuse_small_crops:
            # the default --aug-test ratios give crops smaller than img_size
            try:
                test_cli.main(test_args(aug), log_fn=lambda *_: None)
                refused = False
            except ValueError as e:
                refused = "patch grid" in str(e)

        cfg = Config.fromfile(config)
        cfg.merge_from_options({"data.data_root": root})
        model = load_model_weights(ckpt, build_model(dict(cfg.model)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct = run_eval(eval_config(cfg), model,
                          build_dataset(cfg.data, "val"),
                          log_fn=lambda *_: None)
        torch.cuda.synchronize()
        eval_s["run_eval"] = time.perf_counter() - t0
        del model
        torch.cuda.empty_cache()
    finally:
        for cls, fwd in forwards.items():
            cls.forward = fwd
        shutil.rmtree(tmp, ignore_errors=True)

    same_cm = bool((results["slide"]["confusion"]
                    == direct["confusion"]).all())
    finite = all(v == v and abs(v) != float("inf")
                 for v in vals["loss"] + vals["grad_norm"]
                 + [r["mIoU"] for r in results.values()])
    ran = dict(first_run)
    for counts in eval_counts.values():
        ran.update({k: ran.get(k, 0) + v for k, v in counts.items()})
    bad_never = {k: v for k, v in ran.items() if k in never}
    forwards_ok = forward_launches is None or all(
        counts == {k: v * n_calls[kind] for k, v in forward_launches.items()}
        for kind, counts in eval_counts.items())
    log(f"{name} {config}: {built}")
    log(f"{name} train steps (s, CUDA events): {secs}; "
        f"{sum(secs[1:]) / (len(secs) - 1):.3f} s/step over steps "
        f"2..{steps}, first step {secs[0]:.3f} s; losses {vals['loss']}; "
        f"grad norms {vals['grad_norm']}; peak memory {peak:.2f} GiB; "
        f"{n_params} parameters; {train_s:.1f} s for the run with its "
        f"checkpoints and eval hook")
    log(f"{name} checkpoints (bytes, s to write): {ckpts}")
    log(f"{name} launches per train step: {per_step} (want "
        f"{step_launches} each); resumed at step {steps} and took "
        f"step {steps + 1}: {resumed_ok}")
    n_img = len(CLI_IMAGES)
    log(f"{name} test (host clock to a synchronize, the model's build "
        f"and weight load included): slide {eval_s['slide']:.2f} s for "
        f"{n_img} images, {eval_s['slide'] / n_img:.2f} s/image (mIoU "
        f"{results['slide']['mIoU']:.4f}, random weights); --aug-test "
        f"{aug_options or 'at the reference ratios'} with flip "
        f"{eval_s['aug_test']:.2f} s/image (mIoU "
        f"{results['aug_test']['mIoU']:.4f}); run_eval alone "
        f"{eval_s['run_eval'] / n_img:.2f} s/image; launches {eval_counts} "
        f"over {n_calls} model calls (want {forward_launches} a call); "
        f"confusion equal to run_eval's={same_cm}"
        + (f"; default --aug-test ratios refused for crops under "
           f"img_size={refused}" if refuse_small_crops else ""))
    if not (finite and resumed_ok and same_cm and refused):
        raise SystemExit(f"FAIL: {name} (non-finite loss, grad norm or "
                         "mIoU, resume, the test CLI's confusion matrix, or "
                         "the small-crop refusal)")
    if (any(st != step_launches for st in per_step) or bad_never
            or not forwards_ok):
        raise SystemExit(f"FAIL: {name} launches per step {per_step}, per "
                         f"test call {eval_counts} over {n_calls}, kernels "
                         f"that must not run {bad_never}")
    return train_counts


def config_cli():
    """Phase 11: the config entry points on the 640 px BEiT-Adapter-L +
    Mask2Former config (fp32, batch 1, 100 queries, 150 classes): 4 steps
    (checkpoints every 2 steps, the eval hook at the last), a resumed
    fifth, the test CLI with `--aug-test` at ratios 1.0-1.75 and the
    default ratios refused (`run_config_cli`). No attention kernel runs
    (BEiT's biased attention is plain PyTorch) and no per-level one."""
    return run_config_cli("config CLI", CLI_CONFIG, CLI_OPTIONS,
                          CLI_STEP_LAUNCHES, CLI_NEVER, [CLI_AUG_RATIOS],
                          refuse_small_crops=True)


def upernet_cli():
    """Phase 13: the config entry points on the AugReg-L UperNet config at
    full width as shipped (`UPERNET_CONFIG`: fp32 ViT-L with `with_cp`,
    bf16 heads, batch 2 at 512x512): 4 steps, a resumed fifth, the test
    CLI in slide mode and with `--aug-test` at the reference ratios
    (`run_config_cli`), with the launches of each step and of each model
    call of the test CLI, and no point sampling, auction or per-level
    kernel."""
    return run_config_cli("UperNet CLI", UPERNET_CONFIG, UPERNET_OPTIONS,
                          UPERNET_STEP_LAUNCHES, UPERNET_NEVER, [],
                          forward_launches=UPERNET_FORWARD_LAUNCHES)


def assignment_cost(cost, owner):
    """Total matched cost of each matrix (B, Q, G) under owners (B, Q)."""
    got = cost.gather(2, owner.clamp(min=0)[..., None])[..., 0]
    return torch.where(owner >= 0, got, 0.0).double().sum(1)


def beit_card_vs_cpu():
    """Phase 12: the 640 config reduced to depth 4 (one block per
    interaction) at img_size 256, full width, fp32, TF32 off, drop path 0:
    the card's eval logits against the CPU's (E2E_RTOL of their scale), then
    one train step each (1024 points, the same sampler draws) compared by
    loss and gradient norm (TRAIN_RTOL). The auction is eps-optimal, so two
    sides whose costs differ by float rounding may match a near-tied
    matrix differently (one decoder layer of this step did on the H100),
    and that moves the loss by a whole layer's difference: the CPU step
    therefore takes the card's assignment, and its own auction's is
    reported beside it (the matrices that differ, and whether the card's
    total cost on the CPU's costs is within n_valid * eps of the CPU's).
    The card's auction kernel runs in its step, and phase 3 holds it to
    the plain auction exactly."""
    from vitadapter_torch.heads import mask2former_loss as loss_mod
    from vitadapter_torch.ops import matching as mt
    from vitadapter_torch.builder import build_model
    from vitadapter_torch.data.preprocess import normalize
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.ops.point_sample import uniform_sampler
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_m2f_train_step
    from vitadapter_torch.utils.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.fromfile(CLI_CONFIG)
    cfg.merge_from_options({
        "model.backbone.depth": 4, "model.backbone.img_size": 256,
        "model.backbone.drop_path_rate": 0.0,
        "model.backbone.interaction_indexes": [[0, 0], [1, 1], [2, 2],
                                               [3, 3]]})
    gen = torch.Generator().manual_seed(14)
    cpu = build_model(dict(cfg.model), device="cpu", generator=gen)
    randomize(cpu, gen)
    card = copy.deepcopy(cpu).cuda()
    img = torch.randint(0, 256, (1, 256, 256, 3), dtype=torch.uint8,
                        generator=gen)
    before = dict(cuda_ext.launches)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu(normalize(img))
        t_cpu = time.perf_counter() - t0
        got = card(normalize(img.cuda())).cpu()
    used = launch_diff(cuda_ext.launches, before)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    ok = (err <= E2E_RTOL * scale and tuple(got.shape) == (1, 256, 256, 150)
          and bool(torch.isfinite(got).all()))
    log(f"BEiT-Adapter-L + Mask2Former (depth 4, full width, 256 px) fp32 "
        f"card vs CPU: max_abs_err={err:.3e} max|ref|={scale:.3e} "
        f"rel={err / scale:.3e} (tol {E2E_RTOL}) ok={ok}; CPU forward "
        f"{t_cpu:.1f} s; kernel launches {used}")
    if not ok or used != {"msda_fwd": 16}:
        raise SystemExit("FAIL: BEiT-Adapter card vs CPU logits")

    ids = torch.randint(0, 150, (1, 8), generator=gen)
    cells = torch.randint(0, 8, (1, 16), generator=gen)
    label = ids.gather(1, cells).reshape(1, 4, 4)
    batch = {"image": torch.randn(1, 256, 256, 3, generator=gen),
             "label": label.repeat_interleave(64, 1).repeat_interleave(64, 2)}
    results, card_assign, cpu_assign = {}, [], []

    def card_auction(cost, n_valid):
        owner = mt.hungarian_assign(cost, n_valid)
        card_assign.append(owner.cpu())
        return owner

    def cpu_auction(cost, n_valid):
        cpu_assign.append((cost, n_valid, mt.hungarian_assign(cost, n_valid)))
        return card_assign[0]

    for side, model, auction in (("cuda", card, card_auction),
                                 ("cpu", cpu, cpu_auction)):
        opt, _ = make_optimizer(model, depth=4, total_steps=1000,
                                warmup_steps=0, grad_clip=0.01)
        step = make_m2f_train_step(model, num_classes=150, num_points=1024)
        b = {k: v.to(side) for k, v in batch.items()}
        sampler = uniform_sampler(torch.Generator().manual_seed(15))
        before = dict(cuda_ext.launches)
        loss_mod.hungarian_assign = auction
        try:
            t0 = time.perf_counter()
            _, logs = step(TrainState.create(model, opt), b,
                           torch.Generator(side).manual_seed(16), sampler)
            logs = {k: float(v) for k, v in logs.items()}
        finally:
            loss_mod.hungarian_assign = mt.hungarian_assign
        results[side] = (logs, time.perf_counter() - t0,
                         launch_diff(cuda_ext.launches, before))
    (ref, t_cpu, _), (got, t_card, used) = results["cpu"], results["cuda"]
    rel = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12)
           for k in ("loss", "grad_norm")}
    cost, n_valid, own = cpu_assign[0]
    differ = int((own != card_assign[0]).any(1).sum())
    span = torch.where(torch.arange(cost.shape[2])[None, None]
                       < n_valid[:, None, None], cost.abs(), 0.0).amax(
        dim=(1, 2)).clamp(min=1e-6)
    gap = assignment_cost(cost, card_assign[0]) - assignment_cost(cost, own)
    eps_ok = bool((gap.abs() <= n_valid * span / mt.EPS_DIV + 1e-5
                   * assignment_cost(cost, own).abs()).all())
    ok = all(r <= TRAIN_RTOL for r in rel.values()) and eps_ok
    log(f"BEiT-Adapter-L + Mask2Former (depth 4, full width, 256 px) fp32 "
        f"train step card vs CPU, the CPU on the card's assignment: card "
        f"{got} CPU {ref} rel {rel} (tol {TRAIN_RTOL}); the CPU's own "
        f"auction matches {differ} of {len(own)} matrices otherwise, the "
        f"card's total cost on the CPU's costs minus the CPU's "
        f"{[round(float(g), 6) for g in gap]} within n_valid*eps={eps_ok}; "
        f"ok={ok}; CPU step {t_cpu:.1f} s, card step {t_card:.2f} s; kernel "
        f"launches {used}")
    if not ok or used != CLI_STEP_LAUNCHES:
        raise SystemExit("FAIL: BEiT-Adapter train step card vs CPU "
                         f"(launches {used}, want {CLI_STEP_LAUNCHES})")


def upernet_card_vs_cpu():
    """Phase 14: the AugReg-L UperNet config reduced to depth 4 (one block
    per interaction) at 256 px, full width (embed 1024, 16 heads, UPerHead
    1024 wide), all fp32 (the heads too), TF32 off, drop path and dropout
    0 so that neither side draws: the card's eval logits against the
    CPU's (E2E_RTOL of their scale), then one `make_seg_train_step` each
    on the same batch (batch 2, block labels with ignored pixels),
    compared by loss and gradient norm (TRAIN_RTOL). The gradient norm
    compared is each side's float64 norm of the step's gradients: the
    step's own (`clip_grad_norm_` in fp32) sums 250 million squares, and
    on the CPU that fp32 sum was 1.6e-3 below the float64 norm of the same
    gradients (the card's 1e-7 from it), so it is logged beside."""
    from vitadapter_torch.builder import build_model
    from vitadapter_torch.data.preprocess import normalize
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_seg_train_step
    from vitadapter_torch.utils.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.fromfile(UPERNET_CONFIG)
    cfg.merge_from_options({
        "model.backbone.depth": 4, "model.backbone.img_size": 256,
        "model.backbone.drop_path_rate": 0.0,
        "model.backbone.interaction_indexes": [[0, 0], [1, 1], [2, 2],
                                               [3, 3]],
        "model.decode_head.dtype": "float32",
        "model.decode_head.dropout_ratio": 0.0,
        "model.auxiliary_head.dtype": "float32",
        "model.auxiliary_head.dropout_ratio": 0.0})
    gen = torch.Generator().manual_seed(17)
    cpu = build_model(dict(cfg.model), device="cpu", generator=gen)
    randomize(cpu, gen)
    card = copy.deepcopy(cpu).cuda()
    img = torch.randint(0, 256, (1, 256, 256, 3), dtype=torch.uint8,
                        generator=gen)
    before = dict(cuda_ext.launches)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu(normalize(img))
        t_cpu = time.perf_counter() - t0
        got = card(normalize(img.cuda())).cpu()
    used = launch_diff(cuda_ext.launches, before)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    ok = (err <= E2E_RTOL * scale and tuple(got.shape) == (1, 256, 256, 150)
          and bool(torch.isfinite(got).all()))
    want = {"attention_fwd": 4, "msda_fwd": 10}
    log(f"AugReg-L + UperNet (depth 4, full width, 256 px) fp32 card vs "
        f"CPU: max_abs_err={err:.3e} max|ref|={scale:.3e} "
        f"rel={err / scale:.3e} (tol {E2E_RTOL}) ok={ok}; CPU forward "
        f"{t_cpu:.1f} s; kernel launches {used} (want {want})")
    if not ok or used != want:
        raise SystemExit("FAIL: UperNet card vs CPU logits")

    label = torch.stack([torch.from_numpy(block_labels(gen, 256, 256, 150,
                                                       32))
                         for _ in range(2)]).long()
    label[:, :16] = 255
    batch = {"image": torch.randn(2, 256, 256, 3, generator=gen),
             "label": label}
    results = {}
    for side, model in (("cpu", cpu), ("cuda", card)):
        opt, _ = make_optimizer(model, base_lr=cfg.optimizer["lr"],
                                weight_decay=cfg.optimizer["weight_decay"],
                                depth=4, total_steps=1000, warmup_steps=0)
        step = make_seg_train_step(model, cfg.get("aux_loss_weight", 0.4))
        b = {k: v.to(side) for k, v in batch.items()}
        before = dict(cuda_ext.launches)
        t0 = time.perf_counter()
        _, logs = step(TrainState.create(model, opt), b,
                       torch.Generator(side).manual_seed(18))
        logs = {k: float(v) for k, v in logs.items()}
        logs["grad_norm_f64"] = float(sum(
            p.grad.double().square().sum() for p in model.parameters()
            if p.grad is not None).sqrt())
        results[side] = (logs, time.perf_counter() - t0,
                         launch_diff(cuda_ext.launches, before))
    (ref, t_cpu, _), (got, t_card, used) = results["cpu"], results["cuda"]
    rel = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12)
           for k in ("loss", "grad_norm_f64", "grad_norm")}
    ok = all(rel[k] <= TRAIN_RTOL for k in ("loss", "grad_norm_f64"))
    # `with_cp` recomputes the 4 blocks' forwards in the backward
    want = {"attention_fwd": 8, "attention_bwd": 4, "msda_fwd": 10,
            "msda_bwd": 10}
    log(f"AugReg-L + UperNet (depth 4, full width, 256 px) fp32 train step "
        f"card vs CPU: card {got} CPU {ref} rel {rel} (tol {TRAIN_RTOL} on "
        f"the loss and the float64 gradient norm) ok={ok}; CPU step "
        f"{t_cpu:.1f} s, card step {t_card:.2f} s; kernel launches {used} "
        f"(want {want})")
    if not ok or used != want:
        raise SystemExit("FAIL: UperNet train step card vs CPU "
                         f"(launches {used}, want {want})")


def nms_inputs(n, classes, gen):
    """`n` proposal-like boxes on a 1024 canvas (clustered, so that many
    pairs overlap near the thresholds), scores with 5% -inf, sorted as
    `det.boxes.nms` sorts them; with `classes`, offset by class as
    `batched_nms` offsets them. Returns (boxes, finite flags) on the card."""
    dev = "cuda"
    centers = torch.rand(n // 16 + 1, 2, generator=gen, device=dev) * 1024
    pick = torch.randint(0, len(centers), (n,), generator=gen, device=dev)
    c = centers[pick] + 12 * torch.randn(n, 2, generator=gen, device=dev)
    wh = 16 + 200 * torch.rand(n, 2, generator=gen, device=dev)
    boxes = torch.cat([c - wh / 2, c + wh / 2], 1)
    scores = torch.rand(n, generator=gen, device=dev)
    scores[torch.rand(n, generator=gen, device=dev) < 0.05] = -torch.inf
    if classes:
        labels = torch.randint(0, classes, (n,), generator=gen, device=dev)
        boxes = boxes + labels.float()[:, None] * (boxes.max() + 1.0)
    order = torch.sort(-scores, stable=True)[1]
    return boxes[order].contiguous(), torch.isfinite(scores[order])


def check_nms(rows, flush, gen):
    """nms.cu (not a TPU kernel: it replaces the `lax.scan` of
    `vitadapter/det/boxes.py::nms`) against `nms_keep_plain` at the Mask
    R-CNN and HTC++ paths' sizes (`NMS_CASES`): the kept flags bitwise
    equal, the kernel launched twice (bitwise equal), the pairs whose IoU
    lies within 1e-6 of the threshold counted; timed beside the plain version
    (the IoU on the card, the walk on the host). The bound counts 24
    fp32 operations a pair of the upper triangle and the boxes, flags
    and kept flags moved once. No single PyTorch call computes it
    (`library_ms` null)."""
    from vitadapter_torch.ops import nms

    ok = True
    row = rows["nms"]
    for name, (n, classes, thr, paths) in NMS_CASES.items():
        boxes, finite = nms_inputs(n, classes, gen)
        got = nms._kernel_keep(boxes, finite, thr)
        again = nms._kernel_keep(boxes, finite, thr)
        ref = nms.nms_keep_plain(boxes, finite, thr)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        equal = torch.equal(got, ref)
        iou = nms.bbox_overlaps(boxes, boxes)
        near = int(((iou - thr).abs() < 1e-6).triu(1).sum())
        del iou
        good = same and equal
        ok &= good
        k_ms = time_ms(lambda: nms._kernel_keep(boxes, finite, thr), flush)
        p_ms = time_ms(lambda: nms.nms_keep_plain(boxes, finite, thr), flush,
                       iters=3)
        b = bound_ms(nbytes(boxes, finite) + n, 24 * n * (n - 1) / 2, F32)
        log(f"nms {name}: {n} boxes{f', {classes} classes' if classes else ''}"
            f" IoU > {thr}: kept {int(got.sum())}; kept flags equal to the "
            f"plain version's={equal}, relaunch bitwise equal={same}, pairs "
            f"within 1e-6 of the threshold {near}; ok={good} kernel_ms="
            f"{k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b[0]:.4f} ({b[1]})")
        err = 0.0 if equal else 1.0
        for path, calls in paths:
            target = row if path == "det" else row.setdefault(
                "paths", {}).setdefault(path, new_row(library=False))
            add_to_row(target, calls, err, k_ms, p_ms, b)
    return ok


def write_coco(root, sizes, seed):
    """uint8 JPEG images of `sizes` and a COCO instances JSON for them
    (split `val2017`) under `root`: on each image three polygon
    instances, one RLE instance and, on the second, a crowd region, of 3
    categories with ids 1, 3, 7."""
    import numpy as np
    from PIL import Image

    from vitadapter_torch.data.coco import encode_rle

    img_dir = os.path.join(root, "val2017")
    os.makedirs(img_dir)
    os.makedirs(os.path.join(root, "annotations"))
    host = torch.Generator().manual_seed(seed)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        name = f"{i:012d}.jpg"
        img = torch.randint(0, 256, (h, w, 3), dtype=torch.uint8,
                            generator=host).numpy()
        Image.fromarray(img).save(os.path.join(img_dir, name), quality=95)
        images.append({"id": i + 1, "file_name": name, "height": h,
                       "width": w})
        for k in range(3):
            x, y = (float(v) for v in torch.rand(2, generator=host) * 0.5
                    * torch.tensor([w, h]))
            bw, bh = (float(v) for v in (0.05 + 0.4 * torch.rand(
                2, generator=host)) * torch.tensor([w, h]))
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": (1, 3, 7)[k], "area": bw * bh,
                         "bbox": [x, y, bw, bh], "iscrowd": 0,
                         "segmentation": [[x, y, x + bw, y, x + bw, y + bh,
                                           x, y + bh]]})
        m = np.zeros((h, w), np.uint8)
        m[h // 4:h // 2, w // 4:w // 2] = 1
        anns.append({"id": len(anns) + 1, "image_id": i + 1,
                     "category_id": 3, "area": float(m.sum()),
                     "bbox": [w // 4, h // 4, w // 2 - w // 4,
                              h // 2 - h // 4],
                     "iscrowd": i % 2, "segmentation": encode_rle(m)})
    with open(os.path.join(root, "annotations", "instances_val2017.json"),
              "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c, "name": f"c{c}"}
                                  for c in (1, 3, 7)]}, f)


def det_cli():
    """Phase 15: the config entry points in this process on the AugReg-L
    Mask R-CNN config as shipped (`DET_CONFIG`: ViT-Adapter-L in fp32 with
    `with_cp`, drop path 0.4, 20 windowed and 4 global blocks, batch 1 on
    the 1024 canvas, 100 synthetic instances), through `run_cli`.
    Returns the launches of the first run's train steps and of one model
    call of the test CLI."""
    from vitadapter_torch.det.mask_rcnn import MaskRCNN

    train_counts, test_counts, _, _ = run_cli(
        "det", MaskRCNN, DET_CONFIG, DET_STEPS, DET_STEP_LAUNCHES,
        DET_FORWARD_LAUNCHES, det_cli_data(DET_OPTIONS), det_eval,
        DET_EVAL_ARGS, DET_HEADLINE, never=DET_NEVER,
        per_input=DET_PER_INPUT)
    return train_counts, test_counts


# the detection test CLIs' metrics (those that must be finite: no
# small objects, so mAP_s is NaN), and the NMS launches of one input: a
# proposal and a detection NMS
DET_EVAL_ARGS = ["--eval", "bbox", "segm"]
DET_HEADLINE = ("bbox_mAP", "segm_mAP")
DET_PER_INPUT = {"nms": 2}


def det_cli_data(options):
    """`run_cli`'s `prepare` for a detection phase: the train runs take
    synthetic data and `options`; the tests take `DET_IMAGES` (one
    landscape, one portrait image, so both canvases run) written as a
    COCO-layout set under the run's directory."""
    def prepare(tmp):
        root = os.path.join(tmp, "coco")
        write_coco(root, DET_IMAGES, 15)
        return (["--synthetic-data", "--cfg-options", *options],
                [f"data.data_root={root}"])
    return prepare


def det_eval(cfg, model, aug_test):
    """`run_det_eval` on the val split, as `tools.test --eval bbox segm`
    calls it."""
    from vitadapter_torch.train.det_loop import build_det_dataset, run_det_eval

    return run_det_eval(cfg, model, build_det_dataset(cfg.data, "val"),
                        ("bbox", "segm"), aug_test=aug_test,
                        log_fn=lambda *_: None)


def cli_log(lines, marks, line):
    """`log_fn` body of the config CLI runs: echo, keep, and at each
    step's log line snapshot the launches (before its checkpoint)."""
    from vitadapter_torch.ops import cuda_ext

    log(f"  | {line}")
    lines.append(line)
    m = re.match(r"iter (\d+)/", line)
    if m:
        marks[int(m.group(1))] = dict(cuda_ext.launches)


def run_cli(label, model_cls, config, steps, step_launches, call_launches,
            prepare, evaluate, eval_args, headline, never=(),
            per_input=None, inputs_per_call=1, aug_config=None, aug_augs=12,
            after=None):
    """The config entry points in this process on `config`. `prepare(tmp)`
    writes the data under a temporary directory and returns the train CLI's
    arguments and the test CLI's `--cfg-options`. Then `tools.train.main`
    for `steps` steps (a checkpoint at the last), `--resume` for one more,
    `tools.test.main` with `eval_args` on the val split and `evaluate(cfg,
    model, aug_test)` (the eval function the test CLI calls) directly on
    the same weights; with `aug_config`, the test CLI again with
    `--aug-test` on that config and `evaluate(..., True)` on those weights;
    then `after(tmp, ckpt, test_options)`, if given, with the checkpoint.
    Checks the launches of each train step (`step_launches`) and of each
    model call of the tests (`call_launches` a call and `per_input` an
    input; `inputs_per_call` inputs a call of the plain test), that no
    kernel of `never` runs, the resume, finite losses and gradient norms,
    finite `headline` metrics (logged), `aug_augs` augs an image, and each
    test CLI's metrics (predicted boxes included) equal to the direct
    call's. Logs s/step (CUDA events, the first step apart), peak memory,
    the checkpoint's bytes and seconds, and the tests' s/image with and
    without the model's build, model-call seconds beside host seconds.
    Returns the launches of the first run's train steps, the plain test
    CLI's launches divided by its model calls, the `--aug-test` run's
    metrics (or None) and what `after` returned."""
    import tempfile

    from vitadapter_torch.builder import build_model
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.tools import test as test_cli
    from vitadapter_torch.tools import train as train_cli
    from vitadapter_torch.utils.checkpoint_io import load_model_weights
    from vitadapter_torch.utils.config import Config, parse_cfg_options

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
    calls, inputs = [0], [0]
    forward = model_cls.forward
    per_input = per_input or {}

    def counted(self, img, *a, **kw):
        calls[0] += 1
        inputs[0] += img.shape[0]
        return forward(self, img, *a, **kw)

    def call_counts():
        want = {k: v * calls[0] for k, v in call_launches.items()}
        want.update({k: v * inputs[0] for k, v in per_input.items()})
        return want

    def run_test(cfg_path, extra):
        before = dict(cuda_ext.launches)
        calls[0] = inputs[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = test_cli.main([cfg_path, ckpt, *eval_args, *extra,
                                 "--cfg-options", *test_options],
                                log_fn=log_fn)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        used = launch_diff(cuda_ext.launches, before)
        return metrics, secs, used, calls[0], inputs[0], used == call_counts()

    def direct(cfg_path, aug_test):
        cfg = Config.fromfile(cfg_path)
        cfg.merge_from_options(parse_cfg_options(test_options))
        model = load_model_weights(ckpt, build_model(dict(cfg.model)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(cfg, model, aug_test)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del model
        torch.cuda.empty_cache()
        return out, secs

    try:
        model_cls.forward = counted
        train_args, test_options = prepare(tmp)
        work = os.path.join(tmp, "work")
        ckpt = os.path.join(work, "ckpt")
        train_args = [config, "--work-dir", work, *train_args]
        lines, marks = [], {}

        def log_fn(line):
            cli_log(lines, marks, line)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_ext.launches.clear()
        t0 = time.perf_counter()
        state = train_cli.main(train_args + ["--max-iters", str(steps)],
                               log_fn=log_fn)
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_params = sum(p.numel() for p in state.model.parameters())
        del state
        torch.cuda.empty_cache()
        per_step = [launch_diff(marks[k], marks.get(k - 1, {}))
                    for k in range(1, steps + 1)]
        train_counts = marks[steps]
        iters = [l for l in lines if re.match(r"iter \d+/", l)]
        secs = [float(re.search(r"time=([0-9.]+)s", l).group(1))
                for l in iters]
        vals = {k: [float(re.search(rf"{k}=(\S+)", l).group(1))
                    for l in iters] for k in ("loss", "grad_norm")}
        ckpts = [(int(a), float(b)) for a, b in
                 re.findall(r"checkpoint of step \d+: (\d+) bytes in "
                            r"([0-9.]+) s", "\n".join(lines))]
        built = next(l for l in lines if "parameters;" in l)

        mark = len(lines)
        state = train_cli.main(train_args + ["--max-iters", str(steps + 1),
                                             "--resume"], log_fn=log_fn)
        resumed = lines[mark:]
        resumed_ok = (f"resumed from step {steps}" in resumed
                      and state.step == steps + 1
                      and any(l.startswith(f"iter {steps + 1}/")
                              for l in resumed))
        del state
        torch.cuda.empty_cache()

        (metrics, test_s, test_counts, n_calls, n_inputs,
         forwards_ok) = run_test(config, [])
        forwards_ok &= n_inputs == inputs_per_call * n_calls
        ref, direct_s = direct(config, False)
        aug = None
        if aug_config is not None:
            (aug, aug_s, aug_counts, aug_calls, aug_inputs,
             aug_launch_ok) = run_test(aug_config, ["--aug-test"])
            aug_want = call_counts()
            ref_aug, _ = direct(aug_config, True)
        extra = after(tmp, ckpt, test_options) if after else None
    finally:
        model_cls.forward = forward
        shutil.rmtree(tmp, ignore_errors=True)

    def summary(m):
        return json.dumps({k: v.tolist() if hasattr(v, "tolist") else v
                           for k, v in m.items() if k != "timing"},
                          sort_keys=True)

    def scalars(m):
        return {k: m[k] for k in headline if isinstance(m[k], float)}

    def finite(m):
        return all(bool(torch.isfinite(torch.as_tensor(m[k])).all())
                   for k in headline)

    same = summary(metrics) == summary(ref)
    finite_train = all(v == v and abs(v) != float("inf")
                       for v in vals["loss"] + vals["grad_norm"])
    ran = dict(marks[steps])
    for k, v in test_counts.items():
        ran[k] = ran.get(k, 0) + v
    bad_never = {k: v for k, v in ran.items() if k in never}
    timing = ref["timing"]
    n_img = timing["images"]
    words = " ".join(eval_args)
    log(f"{label} CLI {config}: {built}")
    log(f"{label} CLI train steps (s, CUDA events): {secs}; "
        f"{sum(secs[1:]) / (len(secs) - 1):.3f} s/step over steps "
        f"2..{steps}, first step {secs[0]:.3f} s; losses {vals['loss']}; "
        f"grad norms {vals['grad_norm']}; peak memory {peak:.2f} GiB; "
        f"{n_params} parameters; {train_s:.1f} s for the run with its "
        f"checkpoint")
    log(f"{label} CLI checkpoints (bytes, s to write): {ckpts}")
    log(f"{label} CLI launches per train step: {per_step} (want "
        f"{step_launches} each); resumed at step {steps} and took step "
        f"{steps + 1}: {resumed_ok}")
    log(f"{label} CLI test {words} (host clock to a synchronize): "
        f"{test_s:.2f} s for {n_img} images with the model's build and "
        f"weight load, {test_s / n_img:.2f} s/image; the eval alone "
        f"{direct_s / n_img:.2f} s/image, of which model calls "
        f"{1e3 * timing['forward_s'] / n_img:.1f} ms/image and host "
        f"{1e3 * timing['host_s'] / n_img:.1f} ms/image; {scalars(metrics)} "
        f"(random weights); metrics equal to the direct call's={same}; "
        f"launches {test_counts} over {n_calls} model calls (want "
        f"{call_launches} a call, {per_input} an input)")
    aug_ok = True
    if aug is not None:
        t = aug["timing"]
        same_aug = summary(aug) == summary(ref_aug)
        aug_ok = (aug_launch_ok and t["augs"] == aug_augs and same_aug
                  and finite(aug))
        log(f"{label} CLI test {words} --aug-test {aug_config}: "
            f"{t['augs']} augs an image, {aug_s:.2f} s for {n_img} images "
            f"with the model's build and weight load, "
            f"{aug_s / n_img:.2f} s/image; model calls "
            f"{t['forward_s']:.3f} s ({1e3 * t['forward_s'] / n_img:.1f}"
            f" ms/image), host {t['host_s']:.3f} s "
            f"({1e3 * t['host_s'] / n_img:.1f} ms/image: load, resizes, "
            f"merge or vote, evaluator); {scalars(aug)}; metrics equal to "
            f"the direct call's with aug_test={same_aug}; launches "
            f"{aug_counts} over {aug_calls} model calls of {aug_inputs} "
            f"inputs (want {aug_want}) ok={aug_ok}")
    if not (finite_train and resumed_ok and same and finite(metrics)
            and aug_ok):
        raise SystemExit(f"FAIL: {label} CLI (non-finite loss, grad norm "
                         "or metrics, resume, the test CLI's metrics or "
                         "--aug-test)")
    if (any(st != step_launches for st in per_step) or bad_never
            or not forwards_ok):
        raise SystemExit(f"FAIL: {label} CLI launches per step {per_step}, "
                         f"per test call {test_counts} over {n_calls}, "
                         f"kernels that must not run {bad_never}")
    return (train_counts, {k: v // n_calls for k, v in test_counts.items()},
            aug, extra)


def flat_detection_ids(cls_logits, deltas, props, valid, hw):
    """The kept detections of `decode_detections` on one image as
    proposal * K + class ids (the set that NMS keeps), and their boxes by
    id."""
    from vitadapter_torch.det.boxes import stable_top_k
    from vitadapter_torch.det.roi_heads import decode_detections

    K = cls_logits.shape[-1] - 1
    probs = torch.softmax(cls_logits, dim=-1)[:, :K].reshape(-1)
    ok = (probs > 0.05) & valid.repeat_interleave(K)
    _, top_i = stable_top_k(torch.where(ok, probs, -torch.inf),
                            min(2048, len(probs)))
    boxes, _, _, keep = decode_detections(cls_logits, deltas, props, hw,
                                          valid=valid)
    kept = keep >= 0
    ids = top_i[keep[kept]].tolist()
    return dict(zip(ids, boxes[kept].cpu()))


def det_card_vs_cpu():
    """Phase 16: `DET_CONFIG` reduced to depth 4 (three windowed blocks and
    one global, one block per interaction) at full width (embed 1024, 16
    heads, FPN 256), fp32, TF32 off, drop path 0, at 256 px, batch 2
    (the 16x16 token grid pads to 28x28 for the 14x14 windows): on the
    card and on the CPU from the same weights. Eval: the FPN maps and the
    RPN outputs within `E2E_RTOL` of each one's scale; the RoI stage on
    the card's proposals (the CPU's own proposals reported beside:
    top-k and NMS can flip on float noise), its class logits and deltas
    within `E2E_RTOL`; the detections' kept sets (proposal x class ids)
    compared, the share that agrees reported, and where they agree the
    boxes within `E2E_RTOL` of the image size. Train: one
    `make_det_train_step` each on the same batch and the same sampler
    draws, the CPU on the card's proposals, compared by the losses and
    the float64 gradient norm (`TRAIN_RTOL`)."""
    from vitadapter_torch.builder import build_model
    from vitadapter_torch.data.preprocess import normalize
    from vitadapter_torch.det import rpn
    from vitadapter_torch.det.roi_align import multi_level_roi_align
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_det_train_step
    from vitadapter_torch.utils.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.fromfile(DET_CONFIG)
    cfg.merge_from_options({
        "model.backbone.depth": 4, "model.backbone.drop_path_rate": 0.0,
        "model.backbone.window_attn": [True, True, True, False],
        "model.backbone.window_size": [14, 14, 14, None],
        "model.backbone.interaction_indexes": [[0, 0], [1, 1], [2, 2],
                                               [3, 3]]})
    gen = torch.Generator().manual_seed(19)
    cpu = build_model(dict(cfg.model), device="cpu", generator=gen)
    randomize(cpu, gen)
    card = copy.deepcopy(cpu).cuda()
    hw = (256, 256)
    img = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8, generator=gen)

    def stages(model, x, props=None):
        """FPN maps, RPN outputs, proposals and the RoI stage's outputs
        (on `props` when given) of the model on x."""
        with torch.inference_mode():
            feats = model.extract_feats(normalize(x))
            cls_out, reg_out, _, (p, _, valid) = rpn.rpn_proposals(
                model.rpn_head, feats, hw, 1000)
            props = (p, valid) if props is None else props
            roi = []
            for b in range(x.shape[0]):
                fb = [f[b] for f in feats[:4]]
                pb = props[0][b].to(x.device)
                roi.append(model.roi_head.bbox_head(multi_level_roi_align(
                    fb, pb, 7, rpn.FPN_STRIDES[:4])))
        return feats, cls_out + reg_out, (p, valid), roi

    before = dict(cuda_ext.launches)
    g_feats, g_rpn, g_props, g_roi = stages(card, img.cuda())
    used = launch_diff(cuda_ext.launches, before)
    shared = tuple(t.cpu() for t in g_props)
    t0 = time.perf_counter()
    c_feats, c_rpn, c_props, c_roi = stages(cpu, img, shared)
    t_cpu = time.perf_counter() - t0

    def rel(got, ref):
        return float((got.cpu() - ref).abs().max() / ref.abs().max())

    errs = {"fpn": max(rel(a, b) for a, b in zip(g_feats, c_feats)),
            "rpn": max(rel(a, b) for a, b in zip(g_rpn, c_rpn)),
            "roi": max(rel(a, b) for g, c in zip(g_roi, c_roi)
                       for a, b in zip(g, c))}
    prop_same = [bool(torch.equal(a.cpu(), b))
                 for a, b in zip(g_props[1], c_props[1])]
    prop_err = float((g_props[0].cpu() - c_props[0]).abs().max())
    agree, total, box_err = 0, 0, 0.0
    for b in range(img.shape[0]):
        g = flat_detection_ids(*g_roi[b], g_props[0][b], g_props[1][b], hw)
        c = flat_detection_ids(*c_roi[b], shared[0][b], shared[1][b], hw)
        common = set(g) & set(c)
        agree += len(common)
        total += len(set(g) | set(c))
        for i in common:
            box_err = max(box_err, float((g[i] - c[i]).abs().max()))
    share = agree / max(total, 1)
    ok = (all(e <= E2E_RTOL for e in errs.values())
          and box_err <= E2E_RTOL * max(hw) and total > 0)
    want = {"attention_fwd": 4, "msda_fwd": 10, "nms": 2}
    log(f"AugReg-L Mask R-CNN (depth 4, full width, 256 px, batch 2) fp32 "
        f"card vs CPU: relative errors {errs} (tol {E2E_RTOL} of each "
        f"output's scale); the CPU's own proposals: valid flags equal "
        f"{prop_same}, boxes max_abs_err {prop_err:.3e}; detections on the "
        f"card's proposals: {agree} of {total} kept (proposal, class) ids "
        f"agree ({share:.4f}), their boxes max_abs_err {box_err:.3e} (tol "
        f"{E2E_RTOL * max(hw):.3f}) ok={ok}; CPU {t_cpu:.1f} s; kernel "
        f"launches {used} (want {want})")
    if not ok or used != want:
        raise SystemExit("FAIL: Mask R-CNN card vs CPU")

    G = 20
    xy = torch.rand(2, G, 2, generator=gen) * 200
    wh = 8 + torch.rand(2, G, 2, generator=gen) * 48
    boxes = torch.cat([xy, xy + wh], -1)
    masks = torch.zeros(2, G, *hw, dtype=torch.bool)
    for b in range(2):
        for i in range(G):
            x1, y1, x2, y2 = boxes[b, i].long().tolist()
            masks[b, i, y1:y2, x1:x2] = True
    batch = {"image": torch.randn(2, *hw, 3, generator=gen),
             "gt_boxes": boxes,
             "gt_labels": torch.randint(0, 80, (2, G), generator=gen),
             "gt_masks": masks,
             "gt_valid": torch.arange(G).expand(2, G) < G - 3}
    draws = []

    def recorded(shape):
        u = torch.rand(tuple(shape), generator=gen)
        draws.append(u)
        return u

    captured = []
    get_proposals = rpn.get_proposals

    def capture(*a, **kw):
        out = get_proposals(*a, **kw)
        captured.append(tuple(t.cpu() for t in out))
        return out

    results = {}
    try:
        for side, model in (("cuda", card), ("cpu", cpu)):
            if side == "cuda":
                rpn.get_proposals = capture
                sampler = recorded
            else:
                rpn.get_proposals = lambda *a, **kw: captured[0]
                replay = list(draws)
                sampler = lambda shape: replay.pop(0)  # noqa: E731
            opt, _ = make_optimizer(model, base_lr=cfg.optimizer["lr"],
                                    weight_decay=cfg.optimizer["weight_decay"],
                                    depth=4, total_steps=1000, warmup_steps=0)
            step = make_det_train_step(model)
            bd = {k: v.to(side) for k, v in batch.items()}
            before = dict(cuda_ext.launches)
            t0 = time.perf_counter()
            _, logs = step(TrainState.create(model, opt), bd,
                           torch.Generator(side).manual_seed(20), sampler)
            logs = {k: float(v) for k, v in logs.items()}
            logs["grad_norm_f64"] = float(sum(
                p.grad.double().square().sum() for p in model.parameters()
                if p.grad is not None).sqrt())
            results[side] = (logs, time.perf_counter() - t0,
                             launch_diff(cuda_ext.launches, before))
    finally:
        rpn.get_proposals = get_proposals
    (got, t_card, used), (ref, t_cpu, _) = results["cuda"], results["cpu"]
    keys = ("loss", "loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
            "loss_bbox", "loss_mask", "grad_norm_f64")
    rel = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in keys}
    ok = all(v <= TRAIN_RTOL for v in rel.values())
    # `with_cp` recomputes the 4 blocks' forwards in the backward
    want = {"attention_fwd": 8, "attention_bwd": 4, "msda_fwd": 10,
            "msda_bwd": 10, "nms": 2}
    log(f"AugReg-L Mask R-CNN (depth 4, full width, 256 px, batch 2) fp32 "
        f"train step card vs CPU (same draws, the CPU on the card's "
        f"proposals): card {got} CPU {ref} rel {rel} (tol {TRAIN_RTOL}) "
        f"ok={ok}; CPU step {t_cpu:.1f} s, card step {t_card:.2f} s; "
        f"kernel launches {used} (want {want})")
    if not ok or used != want:
        raise SystemExit("FAIL: Mask R-CNN train step card vs CPU "
                         f"(launches {used}, want {want})")


def htc_cli():
    """Phase 17: the shipped crop raises the port's ValueError (one
    `tools.train.main` step as shipped), then `run_cli` on
    `HTC_CONFIG` at the 1600x1408 canvas with `--aug-test` on
    `HTC_MS_CONFIG`. Returns the launches of the first run's train steps
    and of one model call of the test CLI."""
    import gc
    import tempfile

    from vitadapter_torch.det.cascade import CascadeRCNN
    from vitadapter_torch.tools import train as train_cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_htc_crop_")
    error = None
    try:
        train_cli.main([HTC_CONFIG, "--synthetic-data", "--work-dir", tmp,
                        "--max-iters", "1"], log_fn=lambda *_: None)
    except ValueError as e:
        error = str(e)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"htc CLI as shipped (crop_size [1600, 1400]): ValueError "
        f"{error!r}; the runs below take {HTC_CROP}")
    if error is None or "multiple of 32" not in error:
        raise SystemExit("FAIL: the HTC++ configs' shipped crop did not "
                         "raise the port's ValueError")
    train_counts, test_counts, _, _ = run_cli(
        "htc", CascadeRCNN, HTC_CONFIG, HTC_STEPS, HTC_STEP_LAUNCHES,
        HTC_CALL_LAUNCHES, det_cli_data(HTC_OPTIONS), det_eval,
        DET_EVAL_ARGS, DET_HEADLINE, never=DET_NEVER,
        per_input=DET_PER_INPUT, aug_config=HTC_MS_CONFIG)
    return train_counts, test_counts


def one_det_steps():
    """Phase 18: one train step of each `ONE_STEP_CONFIGS` config at full
    size on a synthetic batch (the config's `samples_per_chip` and crop,
    100 instances): `build_model`, `make_optimizer` as the det loop builds
    it, `make_det_train_step`. Checks finite losses and gradient norm and
    the step's launches; logs the step's seconds (host clock to a
    synchronize, its first step: the kernels are built) and peak
    memory."""
    from vitadapter_torch.builder import build_model
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.train.det_loop import (det_batch_to_device,
                                                 synthetic_det_batches)
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_det_train_step
    from vitadapter_torch.utils.config import Config

    for config, (options, want) in ONE_STEP_CONFIGS.items():
        cfg = Config.fromfile(config)
        cfg.merge_from_options(options)
        model = build_model(dict(cfg.model))
        opt = cfg.optimizer
        optimizer, _ = make_optimizer(
            model, base_lr=opt["lr"], weight_decay=opt["weight_decay"],
            depth=cfg.model["backbone"]["depth"],
            layer_decay_rate=opt.get("layer_decay_rate", 1.0),
            total_steps=1000, warmup_steps=500)
        crop = tuple(cfg.data["crop_size"])
        b = next(synthetic_det_batches(cfg.data["samples_per_chip"], crop,
                                       100, cfg.model["num_classes"]))
        b = det_batch_to_device(b, torch.device("cuda"))
        step = make_det_train_step(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(cuda_ext.launches)
        t0 = time.perf_counter()
        _, logs = step(TrainState.create(model, optimizer), b,
                       torch.Generator("cuda").manual_seed(18))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        used = launch_diff(cuda_ext.launches, before)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        logs = {k: float(v) for k, v in logs.items()}
        finite = all(v == v and abs(v) != float("inf")
                     for v in logs.values())
        dtype = cfg.model.get("dtype", "float32")
        log(f"one det step {config} (crop {list(crop)}, batch "
            f"{cfg.data['samples_per_chip']}, {dtype}): {secs:.2f} s (host clock, first step), peak memory "
            f"{peak:.2f} GiB; logs {logs}; launches {used} (want {want})")
        del model, optimizer, step, b, logs
        torch.cuda.empty_cache()
        if not finite or used != want:
            raise SystemExit(f"FAIL: one det step of {config}")


def cascade_detection_ids(stage_outs, rois, valid, K, hw):
    """The kept detections of `CascadeRCNN.forward` on one image, from its
    stages' (class logits, deltas) and the last stage's rois before its
    regression: roi * K + class ids (the set that NMS keeps) and their
    boxes by id."""
    from vitadapter_torch.det.boxes import (batched_nms, delta2bbox,
                                            stable_top_k)
    from vitadapter_torch.det.cascade import STAGE_STDS

    probs = sum(torch.softmax(c, -1) for c, _ in stage_outs) / len(stage_outs)
    final = delta2bbox(rois, stage_outs[-1][1][:, 0], STAGE_STDS[-1], hw)
    flat = probs[:, :K].reshape(-1)
    ok = (flat > 0.05) & valid.repeat_interleave(K)
    top_s, top_i = stable_top_k(torch.where(ok, flat, -torch.inf),
                                min(2048, len(flat)))
    labels = torch.arange(K, device=flat.device).repeat(len(rois))
    boxes, _, _, keep = batched_nms(
        final.repeat_interleave(K, 0)[top_i], top_s, labels[top_i], 0.5,
        100, valid=torch.isfinite(top_s))
    kept = keep >= 0
    return dict(zip(top_i[keep[kept]].tolist(), boxes[kept].cpu()))


def htc_card_vs_cpu():
    """Phase 19: `HTC_CONFIG` reduced to depth 4 (three windowed blocks and
    one global, one block per interaction) at full width (embed 1024, 16
    heads, ExtraAttention 8 heads of 128, FPN 256), fp32, TF32 off, drop
    path 0, at 256 px, batch 2: on the card and on the CPU from the same
    weights. Eval: the FPN maps, the RPN outputs and the semantic
    embedding within `E2E_RTOL` of each one's scale; the three stages on
    the card's proposals (each side refining its own rois), their class
    logits and deltas within `E2E_RTOL`; the detections' kept sets
    (proposal x class ids) compared, the share that agrees reported, and
    where they agree the boxes within `E2E_RTOL` of the image size. Train:
    one `make_det_train_step` each on the same batch and the same sampler
    draws, the CPU on the card's proposals, compared by the eleven losses
    and the float64 gradient norm (`TRAIN_RTOL`)."""
    from vitadapter_torch.builder import build_model
    from vitadapter_torch.data.preprocess import normalize
    from vitadapter_torch.det import rpn
    from vitadapter_torch.det.boxes import delta2bbox
    from vitadapter_torch.det.cascade import STAGE_STDS
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_det_train_step
    from vitadapter_torch.utils.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.fromfile(HTC_CONFIG)
    cfg.merge_from_options({
        "model.backbone.depth": 4, "model.backbone.drop_path_rate": 0.0,
        "model.backbone.window_attn": [True, True, True, False],
        "model.backbone.window_size": [14, 14, 14, None],
        "model.backbone.interaction_indexes": [[0, 0], [1, 1], [2, 2],
                                               [3, 3]]})
    gen = torch.Generator().manual_seed(23)
    cpu = build_model(dict(cfg.model), device="cpu", generator=gen)
    randomize(cpu, gen)
    card = copy.deepcopy(cpu).cuda()
    hw = (256, 256)
    K = cfg.model["num_classes"]
    img = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8, generator=gen)

    def stages(model, x, props=None):
        """FPN maps, RPN outputs, proposals, the semantic embedding and,
        per image, the stages' (class logits, deltas) on `props` (the
        model's own when None) and the rois the last stage regresses."""
        with torch.inference_mode():
            feats = model.extract_feats(normalize(x))
            cls_out, reg_out, _, (p, _, valid) = rpn.rpn_proposals(
                model.rpn_head, feats, hw, 1000)
            props = (p, valid) if props is None else props
            _, sem = model.semantic_feats(feats)
            per_image = []
            for b in range(x.shape[0]):
                fb = [f[b] for f in feats[:4]]
                rois, outs = props[0][b].to(x.device), []
                for s, head in enumerate(model.roi_head.bbox_head):
                    outs.append(head(model.roi_feats(fb, sem[b], rois, 7)))
                    if s < len(STAGE_STDS) - 1:
                        rois = delta2bbox(rois, outs[-1][1][:, 0],
                                          STAGE_STDS[s], hw)
                per_image.append((outs, rois))
        return feats, cls_out + reg_out, (p, valid), sem, per_image

    before = dict(cuda_ext.launches)
    g_feats, g_rpn, g_props, g_sem, g_img = stages(card, img.cuda())
    used = launch_diff(cuda_ext.launches, before)
    shared = tuple(t.cpu() for t in g_props)
    t0 = time.perf_counter()
    c_feats, c_rpn, c_props, c_sem, c_img = stages(cpu, img, shared)
    t_cpu = time.perf_counter() - t0

    def rel(got, ref):
        return float((got.cpu() - ref).abs().max() / ref.abs().max())

    errs = {"fpn": max(rel(a, b) for a, b in zip(g_feats, c_feats)),
            "rpn": max(rel(a, b) for a, b in zip(g_rpn, c_rpn)),
            "semantic": rel(g_sem, c_sem),
            "stages": max(rel(a, b) for (go, _), (co, _) in zip(g_img, c_img)
                          for g, c in zip(go, co) for a, b in zip(g, c))}
    prop_same = [bool(torch.equal(a.cpu(), b))
                 for a, b in zip(g_props[1], c_props[1])]
    prop_err = float((g_props[0].cpu() - c_props[0]).abs().max())
    agree, total, box_err = 0, 0, 0.0
    for b in range(img.shape[0]):
        g = cascade_detection_ids(*g_img[b], g_props[1][b], K, hw)
        c = cascade_detection_ids(*c_img[b], shared[1][b], K, hw)
        common = set(g) & set(c)
        agree += len(common)
        total += len(set(g) | set(c))
        for i in common:
            box_err = max(box_err, float((g[i] - c[i]).abs().max()))
    share = agree / max(total, 1)
    ok = (all(e <= E2E_RTOL for e in errs.values())
          and box_err <= E2E_RTOL * max(hw) and total > 0)
    want = {"attention_fwd": 5, "msda_fwd": 10, "nms": 2}
    log(f"AugReg-L HTC++ (depth 4, full width, 256 px, batch 2) fp32 card "
        f"vs CPU: relative errors {errs} (tol {E2E_RTOL} of each output's "
        f"scale); the CPU's own proposals: valid flags equal {prop_same}, "
        f"boxes max_abs_err {prop_err:.3e}; detections on the card's "
        f"proposals: {agree} of {total} kept (proposal, class) ids agree "
        f"({share:.4f}), their boxes max_abs_err {box_err:.3e} (tol "
        f"{E2E_RTOL * max(hw):.3f}) ok={ok}; CPU {t_cpu:.1f} s; kernel "
        f"launches {used} (want {want})")
    if not ok or used != want:
        raise SystemExit("FAIL: HTC++ card vs CPU")

    G = 20
    xy = torch.rand(2, G, 2, generator=gen) * 200
    wh = 8 + torch.rand(2, G, 2, generator=gen) * 48
    boxes = torch.cat([xy, xy + wh], -1)
    masks = torch.zeros(2, G, *hw, dtype=torch.bool)
    for b in range(2):
        for i in range(G):
            x1, y1, x2, y2 = boxes[b, i].long().tolist()
            masks[b, i, y1:y2, x1:x2] = True
    batch = {"image": torch.randn(2, *hw, 3, generator=gen),
             "gt_boxes": boxes,
             "gt_labels": torch.randint(0, K, (2, G), generator=gen),
             "gt_masks": masks,
             "gt_valid": torch.arange(G).expand(2, G) < G - 3}
    draws = []

    def recorded(shape):
        u = torch.rand(tuple(shape), generator=gen)
        draws.append(u)
        return u

    captured = []
    get_proposals = rpn.get_proposals

    def capture(*a, **kw):
        out = get_proposals(*a, **kw)
        captured.append(tuple(t.cpu() for t in out))
        return out

    results = {}
    try:
        for side, model in (("cuda", card), ("cpu", cpu)):
            if side == "cuda":
                rpn.get_proposals = capture
                sampler = recorded
            else:
                rpn.get_proposals = lambda *a, **kw: captured[0]
                replay = list(draws)
                sampler = lambda shape: replay.pop(0)  # noqa: E731
            opt, _ = make_optimizer(model, base_lr=cfg.optimizer["lr"],
                                    weight_decay=cfg.optimizer["weight_decay"],
                                    depth=4, total_steps=1000, warmup_steps=0)
            step = make_det_train_step(model)
            bd = {k: v.to(side) for k, v in batch.items()}
            before = dict(cuda_ext.launches)
            t0 = time.perf_counter()
            _, logs = step(TrainState.create(model, opt), bd,
                           torch.Generator(side).manual_seed(20), sampler)
            logs = {k: float(v) for k, v in logs.items()}
            logs["grad_norm_f64"] = float(sum(
                p.grad.double().square().sum() for p in model.parameters()
                if p.grad is not None).sqrt())
            results[side] = (logs, time.perf_counter() - t0,
                             launch_diff(cuda_ext.launches, before))
    finally:
        rpn.get_proposals = get_proposals
    (got, t_card, used), (ref, t_cpu, _) = results["cuda"], results["cpu"]
    keys = ["loss", "loss_rpn_cls", "loss_rpn_bbox", "grad_norm_f64"] + [
        f"s{s}.{k}" for s in range(3)
        for k in ("loss_cls", "loss_bbox", "loss_mask")]
    rel = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in keys}
    ok = all(v <= TRAIN_RTOL for v in rel.values()) and not replay
    # `with_cp` recomputes the 4 blocks' forwards in the backward;
    # ExtraAttention runs once each way
    want = {"attention_fwd": 9, "attention_bwd": 5, "msda_fwd": 10,
            "msda_bwd": 10, "nms": 2}
    log(f"AugReg-L HTC++ (depth 4, full width, 256 px, batch 2) fp32 train "
        f"step card vs CPU (same draws, the CPU on the card's proposals): "
        f"card {got} CPU {ref} rel {rel} (tol {TRAIN_RTOL}) ok={ok}; CPU "
        f"step {t_cpu:.1f} s, card step {t_card:.2f} s; kernel launches "
        f"{used} (want {want})")
    if not ok or used != want:
        raise SystemExit("FAIL: HTC++ train step card vs CPU "
                         f"(launches {used}, want {want})")


# phase 20: the config CLIs on the large WSDM2023 GroundingDINO config (the
# Uni-Perceiver-Adapter-L, 24 joint layers, fp32, the config's batch of 2
# on the 1024 canvas) on a few synthetic WSDM-layout images with questions
# and a tiny CLIP merge table; phase 21: one step of the base GQA config
# on VG-layout records (its eval hook, which calls the detector without
# its text as the JAX package's does, off); phase 22: the large config at
# depth 4 (one joint layer per interaction) on the 256 canvas, card vs CPU
GROUNDING_CONFIG = ("configs/wsdm2023/dino_4scale_uniperceiver_adapter_"
                    "large_24ep_gqa_wsdm2023.py")
GQA_CONFIG = ("configs/wsdm2023/dino_4scale_uniperceiver_adapter_base_"
              "6ep_gqa.py")
GROUNDING_STEPS = 4
GROUNDING_OPTIONS = ["log_config.interval=1", "checkpoint_config.interval=4",
                     "data.workers=2"]
# landscape and portrait images: both test canvases (800x1344, 1344x800)
GROUNDING_IMAGES = ((600, 800), (800, 600), (480, 640), (640, 480))
GROUNDING_QUESTIONS = ("What is the object on the left side?",
                       "Which thing is right of the cup?",
                       "the red square", "Where can I sit down?")
# a train step: the adapter's 4 injectors and 6 extractors, the DINO
# encoder's 6 and decoder's 6 layers, each forward and backward; 7
# assignments (6 decoder layers and the encoder's proposals); a model call
# of the tests: the 22 forwards
GROUNDING_STEP_LAUNCHES = {"msda_fwd": 22, "msda_bwd": 22, "auction": 7}
GROUNDING_CALL_LAUNCHES = {"msda_fwd": 22}
GROUNDING_CALL_INPUTS = 2  # `test_cfg.images_per_device`, with batch slack
GROUNDING_TEST_AUGS = 6   # the default 3 scales x flip of `--aug-test`
# a train step of the config as shipped (no `with_cp`) keeps every joint
# layer's fp32 softmax (16 heads x 4224^2 tokens x 4 B = 1.14 GB an image a
# layer) for the backward: with 2 images x 24 layers it may not fit in
# 80 GB, and then the CLI runs recompute the trunk in the backward
WITH_CP = "model.backbone.with_cp=True"


def write_grounding_set(root, layout):
    """Synthetic grounding data under `root`: `GROUNDING_IMAGES` as JPEGs
    with one box each and a question, as a WSDM-layout COCO json
    (`annotations/{train,val}.json`, layout "wsdm") or VG-layout records
    (`annotations/{train,val}.json` lists, layout "vg"); the val split is
    the first two images. And a tiny CLIP merge table (`bpe.txt.gz`).
    Returns its path."""
    import gzip

    from PIL import Image

    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "annotations"))
    host = torch.Generator().manual_seed(20)
    images, anns, records = [], [], []
    for i, (h, w) in enumerate(GROUNDING_IMAGES):
        name = f"{i}.jpg"
        img = torch.randint(0, 256, (h, w, 3), dtype=torch.uint8,
                            generator=host).numpy()
        Image.fromarray(img).save(os.path.join(root, "images", name),
                                  quality=95)
        x, y = (float(v) for v in torch.rand(2, generator=host) * 0.5
                * torch.tensor([w, h]))
        bw, bh = (float(v) for v in (0.1 + 0.3 * torch.rand(
            2, generator=host)) * torch.tensor([w, h]))
        images.append({"id": i + 1, "file_name": name, "height": h,
                       "width": w, "question": GROUNDING_QUESTIONS[i]})
        anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1,
                     "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0})
        records.append({"image": name, "expression": GROUNDING_QUESTIONS[i],
                        "bbox": [x, y, x + bw, y + bh]})
    for split, n in (("train", len(images)), ("val", 2)):
        with open(os.path.join(root, "annotations", f"{split}.json"),
                  "w") as f:
            json.dump(records[:n] if layout == "vg" else {
                "images": images[:n], "annotations": anns[:n],
                "categories": [{"id": 1, "name": "object"}]}, f)
    path = os.path.join(root, "bpe.txt.gz")
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: tiny\nt h\ne d</w>\nr e\nl e\nf t</w>\n")
    return path


def grounding_step_as_shipped():
    """One train step of `GROUNDING_CONFIG` as shipped on a synthetic batch
    (`make_det_train_step`, the det loop's optimizer). Returns the peak
    GiB, or None where the card's memory ran out (logged either way)."""
    from vitadapter_torch.builder import build_model
    from vitadapter_torch.train.det_loop import (det_batch_to_device,
                                                 synthetic_det_batches)
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_det_train_step
    from vitadapter_torch.utils.config import Config

    cfg = Config.fromfile(GROUNDING_CONFIG)
    model = build_model(dict(cfg.model))
    opt = cfg.optimizer
    optimizer, _ = make_optimizer(
        model, base_lr=opt["lr"], weight_decay=opt["weight_decay"],
        depth=cfg.model["backbone"]["depth"],
        layer_decay_rate=opt["layer_decay_rate"], total_steps=1000,
        warmup_steps=500, grad_clip=opt.get("grad_clip"))
    b = det_batch_to_device(next(synthetic_det_batches(
        cfg.data["samples_per_chip"], tuple(cfg.data["crop_size"]), 1, 1,
        masks=False, text=(49411, cfg.data["max_sent_len"]))),
        torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    peak, words = None, ""
    try:
        make_det_train_step(model)(TrainState.create(model, optimizer), b,
                                   torch.Generator("cuda").manual_seed(20))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    except torch.cuda.OutOfMemoryError as e:
        words = str(e).split(". ")[0]
    high = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, optimizer, b
    torch.cuda.empty_cache()
    if peak:
        verdict = f"fits, peak {peak:.2f} GiB"
    else:
        verdict = (f"out of memory ({words}; {high:.2f} GiB allocated at "
                   f"the failure); the CLI runs take {WITH_CP}")
    log(f"grounding step as shipped (no with_cp, batch 2, 1024 canvas, "
        f"fp32): {verdict}")
    return peak


def grounding_cli():
    """Phase 20: one train step of `GROUNDING_CONFIG` as shipped
    (`grounding_step_as_shipped`); where it runs out of the card's memory
    the runs below take `WITH_CP`. Then `run_cli` on the config (fp32,
    TF32 off, batch 2 on the 1024 canvas, drop path 0.3, the box-rectangle
    aux loss) for `GROUNDING_STEPS` steps on `write_grounding_set` data
    (the real pipeline: AutoAugment, flip with the question's left/right
    swap, the CLIP tokenizer), a checkpoint at the last, and the resume;
    `tools.test --eval IoU` on the two val images and `--aug-test` (3
    scales x flip, the vote), each equal to `run_grounding_eval` called
    directly, boxes included; then `grounding_submission`. Returns the
    launches of the train steps and of one test model call."""
    from vitadapter_torch.det.grounding_dino import GroundingDINO

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with_cp = [] if grounding_step_as_shipped() else [WITH_CP]

    def prepare(tmp):
        root = os.path.join(tmp, "data")
        bpe = write_grounding_set(root, "wsdm")
        options = GROUNDING_OPTIONS + with_cp + [
            f"data.data_root={root}", f"data.bpe_vocab={bpe}"]
        return ["--cfg-options", *options], options

    log(f"grounding CLI {GROUNDING_CONFIG}: "
        f"{'with_cp' if with_cp else 'as shipped'}; TF32 off")
    train_counts, test_counts, _, _ = run_cli(
        "grounding", GroundingDINO, GROUNDING_CONFIG, GROUNDING_STEPS,
        GROUNDING_STEP_LAUNCHES, GROUNDING_CALL_LAUNCHES, prepare,
        grounding_eval, ["--eval", "IoU"], ("mIoU", "Acc@0.5", "boxes"),
        inputs_per_call=GROUNDING_CALL_INPUTS, aug_config=GROUNDING_CONFIG,
        aug_augs=GROUNDING_TEST_AUGS, after=grounding_submission)
    return train_counts, test_counts


def grounding_eval(cfg, model, aug_test):
    """`run_grounding_eval` on the val split, as `tools.test --eval IoU`
    calls it."""
    from vitadapter_torch.train.det_loop import (build_det_dataset,
                                                 run_grounding_eval)

    return run_grounding_eval(
        cfg, model, build_det_dataset(cfg.data, "val", with_masks=False),
        aug_test=aug_test, log_fn=lambda *_: None)


def grounding_submission(tmp, ckpt, options):
    """`tools.generate_results` with the checkpoint on a 2-row CSV of the
    set's images: the header and a row each, and one model call of
    `GROUNDING_CALL_LAUNCHES` a row."""
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.tools import generate_results as gen_cli

    csv_in, csv_out = (os.path.join(tmp, "in.csv"),
                       os.path.join(tmp, "out.csv"))
    with open(csv_in, "w") as f:
        f.write("image,question\n0.jpg,the left one\n"
                "1.jpg,what is right of it\n")
    before = dict(cuda_ext.launches)
    t0 = time.perf_counter()
    rows = gen_cli.main([GROUNDING_CONFIG, ckpt, csv_in, csv_out,
                         "--img-root", os.path.join(tmp, "data", "images"),
                         "--cfg-options", *options],
                        log_fn=lambda line: log(f"  | {line}"))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    used = launch_diff(cuda_ext.launches, before)
    with open(csv_out) as f:
        written = f.read().splitlines()
    ok = (len(rows) == 2 and len(written) == 3
          and written[0] == "image,left,top,right,bottom"
          and used == {k: 2 * v for k, v in GROUNDING_CALL_LAUNCHES.items()})
    log(f"grounding CLI generate_results: {gen_s:.2f} s for 2 rows with the "
        f"build; launches {used}; wrote {written} ok={ok}")
    if not ok:
        raise SystemExit("FAIL: grounding CLI generate_results")


def gqa_step():
    """Phase 21: one `tools.train` step of `GQA_CONFIG` (the base
    Uni-Perceiver-Adapter, `VGDataset`, questions of 64 tokens, batch 2 on
    the 1024 canvas) on VG-layout records of `write_grounding_set`, with
    `evaluation.interval=0`: finite loss and grad norm and the step's
    launches."""
    import tempfile

    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.tools import train as train_cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_gqa_")
    try:
        root = os.path.join(tmp, "data")
        bpe = write_grounding_set(root, "vg")
        lines, marks = [], {0: dict(cuda_ext.launches)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_cli.main([GQA_CONFIG, "--work-dir", os.path.join(tmp, "work"),
                        "--max-iters", "1", "--cfg-options",
                        "log_config.interval=1", "evaluation.interval=0",
                        "data.workers=2", f"data.data_root={root}",
                        f"data.bpe_vocab={bpe}"],
                       log_fn=lambda line: cli_log(lines, marks, line))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    used = launch_diff(marks[1], marks[0])
    it = next(l for l in lines if l.startswith("iter 1/"))
    loss = float(re.search(r"loss=(\S+)", it).group(1))
    norm = float(re.search(r"grad_norm=(\S+)", it).group(1))
    ok = (used == GROUNDING_STEP_LAUNCHES and loss == loss and norm == norm
          and abs(loss) != float("inf") and abs(norm) != float("inf"))
    log(f"gqa step {GQA_CONFIG} (batch 2, 1024 canvas, max_sent_len 64, "
        f"evaluation.interval=0): {secs:.2f} s with the build and the "
        f"checkpoint (host clock); peak memory {peak:.2f} GiB; loss {loss} "
        f"grad_norm {norm}; launches {used} (want {GROUNDING_STEP_LAUNCHES}) "
        f"ok={ok}")
    if not ok:
        raise SystemExit("FAIL: the GQA config's train step")


def grounding_card_vs_cpu():
    """Phase 22: `GROUNDING_CONFIG` at depth 4 (one joint layer per
    interaction) and full width (the trunk 1024 wide, 16 heads; the DINO
    head 256 wide, 6 + 6 layers, 100 queries), fp32, TF32 off, drop path
    0, on the 256 canvas with batch 2 and questions of 16 tokens (the
    second padded), on the card and on the CPU from the same random
    weights. Eval: the encoder keeps the same 100 proposals (the cut's
    margin logged), the last layer's class logits and boxes of every
    query within `GROUNDING_RTOL` of their scale, the decoded top box the
    same and the decoded scores within `GROUNDING_RTOL`. Train: one
    `make_det_train_step` each on the same batch (the config's optimizer
    without its clipping, so that the gradients stay as the loss gave
    them), the denoising draws made on the card and the CPU on the card's
    assignments, compared by the losses and the float64 gradient norm
    (`GROUNDING_TRAIN_RTOL`)."""
    from vitadapter_torch.builder import build_model
    from vitadapter_torch.data.preprocess import normalize
    from vitadapter_torch.det.dino import cdn_draws
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.ops.matching import hungarian_assign
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_det_train_step
    from vitadapter_torch.utils.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.fromfile(GROUNDING_CONFIG)
    cfg.merge_from_options({
        "model.backbone.depth": 4, "model.backbone.drop_path_rate": 0.0,
        "model.backbone.interaction_indexes": [[0, 0], [1, 1], [2, 2],
                                               [3, 3]]})
    gen = torch.Generator().manual_seed(22)
    cpu = build_model(dict(cfg.model), device="cpu", generator=gen)
    randomize(cpu, gen)
    card = copy.deepcopy(cpu).cuda()
    hw, T = (256, 256), 16
    img = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8, generator=gen)
    refer = torch.randint(0, 49408, (2, T), generator=gen)
    r_mask = torch.ones(2, T, dtype=torch.int32)
    r_mask[1, 9:] = 0

    def outputs(model, dev):
        scores = []
        n_dec = len(model.bbox_head.transformer.decoder.layers)
        hook = model.bbox_head.cls_branches[n_dec].register_forward_hook(
            lambda m, i, o: scores.append(o.float().amax(-1)))
        with torch.inference_mode():
            x = normalize(img.to(dev))
            outs = model.bbox_head(model.extract(x, refer.to(dev),
                                                 r_mask.to(dev)))
            dec = model(x, refer.to(dev), r_mask.to(dev))
        hook.remove()
        return ({k: v.float().cpu() for k, v in dec.items()},
                outs["cls"][-1].float().cpu(),
                outs["boxes"][-1].float().cpu(), scores[0].cpu())

    before = dict(cuda_ext.launches)
    t0 = time.perf_counter()
    dec_c, cls_c, box_c, enc_c = outputs(cpu, "cpu")
    t_cpu = time.perf_counter() - t0
    dec_g, cls_g, box_g, enc_g = outputs(card, "cuda")
    used = launch_diff(cuda_ext.launches, before)
    top = torch.sort(enc_c, -1, descending=True)
    k = cfg.model["num_queries"]
    margin = float((top.values[:, k - 1] - top.values[:, k]).min())
    same_set = all(set(a.tolist()) == set(b.tolist()) for a, b in zip(
        torch.sort(enc_g, -1, descending=True).indices[:, :k],
        top.indices[:, :k]))

    def rel(got, ref):
        return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                    1e-12)

    errs = {"cls": rel(cls_g, cls_c), "boxes": rel(box_g, box_c),
            "scores": rel(dec_g["scores"], dec_c["scores"]),
            "top_box": rel(dec_g["boxes"][:, 0], dec_c["boxes"][:, 0])}
    s = dec_c["scores"]
    top_gap = float((s[:, 0] - s[:, 1]).min())
    eval_ok = (same_set and max(errs.values()) <= GROUNDING_RTOL
               and used == {"msda_fwd": 44})
    log(f"grounding card vs CPU (depth 4, full width, 256 canvas, batch 2) "
        f"eval: encoder top-{k} sets equal={same_set} (cut margin "
        f"{margin:.3e}); relative errors {json.dumps(errs)} (tol "
        f"{GROUNDING_RTOL}); decoded top-score gap {top_gap:.3e}; CPU eval "
        f"{t_cpu:.1f} s; card launches {used} (two model calls) "
        f"ok={eval_ok}")

    # one train step each: the card's denoising draws and assignments
    H, W = hw
    boxes = torch.tensor([[[30.0, 40.0, 150.0, 200.0]],
                          [[100.0, 20.0, 240.0, 120.0]]])
    batch = {"image": normalize(img), "refer": refer, "r_mask": r_mask,
             "gt_boxes": boxes, "gt_labels": torch.zeros(2, 1,
                                                         dtype=torch.long),
             "gt_valid": torch.ones(2, 1, dtype=torch.bool)}
    draws = cdn_draws(torch.Generator("cuda").manual_seed(23), 2, 1,
                      cfg.model["dn_groups"], 1, device="cuda")
    assigned = []

    def card_assigner(cost, n_valid):
        out = hungarian_assign(cost, n_valid)
        assigned.append(out.cpu())
        return out

    replayed = []

    def cpu_assigner(cost, n_valid):
        replayed.append(cost)
        return assigned[len(replayed) - 1]

    logs = {}
    for name, model, dev, assigner in (("card", card, "cuda", card_assigner),
                                       ("cpu", cpu, "cpu", cpu_assigner)):
        opt = cfg.optimizer
        optimizer, _ = make_optimizer(
            model, base_lr=opt["lr"], weight_decay=opt["weight_decay"],
            depth=4, layer_decay_rate=opt.get("layer_decay_rate", 1.0),
            total_steps=100, warmup_steps=0)
        b = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        _, out = make_det_train_step(model)(
            TrainState.create(model, optimizer), b,
            torch.Generator(dev).manual_seed(24),
            dn_draws=type(draws)(*(d.to(dev) for d in draws)),
            assigner=assigner)
        secs = time.perf_counter() - t0
        norm64 = float(torch.sqrt(sum(
            p.grad.double().square().sum() for p in model.parameters())))
        logs[name] = ({k: float(v) for k, v in out.items()}, norm64, secs)
    (lg, ng, sg), (lc, nc, sc) = logs["card"], logs["cpu"]
    loss_err = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc
                if k != "grad_norm"}
    norm_err = abs(ng - nc) / nc
    train_ok = (len(assigned) == 7 and len(replayed) == 7
                and max(loss_err.values()) <= GROUNDING_TRAIN_RTOL
                and norm_err <= GROUNDING_TRAIN_RTOL)
    log(f"grounding card vs CPU train step (the CPU on the card's 7 "
        f"assignments and denoising draws): loss card {lg['loss']:.6f} cpu "
        f"{lc['loss']:.6f}; largest relative loss error "
        f"{max(loss_err.values()):.3e} ({max(loss_err, key=loss_err.get)}); "
        f"float64 grad norm card {ng:.6f} cpu {nc:.6f} rel {norm_err:.3e} "
        f"(tol {GROUNDING_TRAIN_RTOL}); card {sg:.2f} s, CPU {sc:.2f} s "
        f"(host clock) "
        f"ok={train_ok}")
    if not (eval_ok and train_ok):
        raise SystemExit("FAIL: grounding card vs CPU")



def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from vitadapter_torch.ops import cuda_ext

    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")

    # phase 2: build
    t0 = time.perf_counter()
    logs = cuda_ext.build()
    log(f"built {sorted(cuda_ext.SIGNATURES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    spills, frames = [], []
    for name, text in logs.items():
        for kernel, line in ptxas_lines(text):
            log(f"  {name}: {kernel}: {line}")
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)):
                spills.append(f"{name}: {kernel}")
            m = re.search(r"(\d+) bytes stack frame", line)
            if name in NO_FRAME and m and int(m.group(1)):
                frames.append(f"{name}: {kernel}")
    log(f"  instantiations that spill: {spills or 'none'}")
    log_point_bwd_plans()
    if frames:
        raise SystemExit(f"FAIL: a stack frame in {frames}")
    for name in ("attention_fwd", "attention_bwd"):
        counts = sass_counts(cuda_ext.library_path(name))
        log(f"  {name}: tensor-core instructions in the built library's "
            f"SASS by kernel: {counts}")
        # every fp32 product runs split TF32 on the tensor cores
        f32 = [c for k, c in counts.items()
               if re.search(r"_f32(<|ILi)", k)] \
            if isinstance(counts, dict) else [{"HGMMA.TF32": 1}]
        if not f32 or not all(c["HGMMA.TF32"] for c in f32):
            raise SystemExit(f"FAIL: {name}: an fp32 kernel without TF32 "
                             "HGMMA")

    # phase 3: kernels against their plain versions
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = check_kernels(flush)
    del flush

    # phase 4: the flagship serving path
    serve_counts = serve_flagship()

    # phase 5: end to end, kernels against plain versions
    card_vs_cpu()

    # phase 6: the flagship train step
    train_counts = train_flagship()

    # phase 7: a train step, kernels against plain versions
    train_card_vs_cpu()

    # phase 8: whole-image evaluation, the per-level forward on its path
    eval_counts = eval_flagship_whole()

    # phase 9: an over-line train step, all ten kernels
    overline_counts = train_overline()

    # phase 10: run_eval, card against CPU
    eval_card_vs_cpu()

    # phase 11: the config CLI on the 640 BEiT-Adapter-L + Mask2Former config
    cli_counts = config_cli()

    # phase 12: BEiT-Adapter, card against CPU
    beit_card_vs_cpu()

    # phase 13: the config CLI on the AugReg-L UperNet config
    t0 = time.perf_counter()
    upernet_counts = upernet_cli()
    t13 = time.perf_counter() - t0

    # phase 14: UperNet, card against CPU
    t0 = time.perf_counter()
    upernet_card_vs_cpu()
    log(f"phases 13 and 14 took {t13:.1f} and "
        f"{time.perf_counter() - t0:.1f} s (host clock)")

    # phase 15: the config CLI on the AugReg-L Mask R-CNN config
    t0 = time.perf_counter()
    det_counts, det_test_counts = det_cli()
    t15 = time.perf_counter() - t0

    # phase 16: Mask R-CNN, card against CPU
    t0 = time.perf_counter()
    det_card_vs_cpu()
    log(f"phases 15 and 16 took {t15:.1f} and "
        f"{time.perf_counter() - t0:.1f} s (host clock)")

    # phase 17: the config CLI on the AugReg-L HTC++ config, --aug-test
    t0 = time.perf_counter()
    htc_counts, htc_test_counts = htc_cli()
    t17 = time.perf_counter() - t0

    # phase 18: one step each of the BEiTv2 HTC++ and the bf16 Cascade
    t0 = time.perf_counter()
    one_det_steps()
    t18 = time.perf_counter() - t0

    # phase 19: HTC++, card against CPU
    t0 = time.perf_counter()
    htc_card_vs_cpu()
    log(f"phases 17, 18 and 19 took {t17:.1f}, {t18:.1f} and "
        f"{time.perf_counter() - t0:.1f} s (host clock)")

    # phase 20: the grounding CLIs on the large WSDM2023 config
    t0 = time.perf_counter()
    grounding_counts, grounding_test_counts = grounding_cli()
    t20 = time.perf_counter() - t0

    # phase 21: one step of the base GQA config
    t0 = time.perf_counter()
    gqa_step()
    t21 = time.perf_counter() - t0

    # phase 22: GroundingDINO, card against CPU
    t0 = time.perf_counter()
    grounding_card_vs_cpu()
    log(f"phases 20, 21 and 22 took {t20:.1f}, {t21:.1f} and "
        f"{time.perf_counter() - t0:.1f} s (host clock)")

    paths = {"serve": serve_counts, "train": train_counts,
             "eval_whole": eval_counts, "train_overline": overline_counts,
             "cli": cli_counts, "upernet": upernet_counts, "det": det_counts,
             "det_test": det_test_counts, "htc": htc_counts,
             "htc_test": htc_test_counts, "grounding": grounding_counts,
             "grounding_test": grounding_test_counts}
    kernels = []
    for name in sorted(rows):
        r = rows[name]
        # each kernel's main path: the first of these paths that runs it
        path = next(p for p in ("serve", "train", "eval_whole",
                                "train_overline", "det") if name in paths[p])
        if name == "msda_level_fwd":
            per = ("times per flagship fp32 forward of a 1024x2048 image at "
                   "ratio 1.5 (6 pixel-decoder and 4 injector MSDA calls, 3 "
                   "level launches each, at phase 8's shapes)")
        elif name.startswith("msda_level"):
            per = ("times per reduced fp32 train step at 1792x1792 (6 "
                   "pixel-decoder and 4 injector MSDA calls, 3 level "
                   "launches each, at phase 9's shapes)")
        elif name in serve_counts:
            per = ("times per flagship bf16 batch-2 forward (one runs in "
                   "each train step)")
        else:
            per = "times per flagship bf16 batch-2 train step"
        if "cli" in r.get("paths", {}):
            per += ("; paths.cli: per phase 11 train step (640 px, batch "
                    "1, fp32; point sampling in bf16, as the loss samples)")
        if name == "nms":
            per = ("times per phase 15 train step (AugReg-L Mask R-CNN, "
                   "batch 1, 1024 canvas: one proposal NMS of 4768 boxes)")
        if "upernet" in r.get("paths", {}):
            per += ("; paths.upernet: per phase 13 train step (AugReg-L "
                    "UperNet, 512 px, batch 2, fp32)")
        if "det" in r.get("paths", {}):
            per += ("; paths.det: per phase 15 train step (AugReg-L Mask "
                    "R-CNN, 1024 canvas, batch 1, fp32)")
        if "det_test" in r.get("paths", {}):
            per += ("; paths.det_test: per phase 15 test model call (one "
                    "800x1344 image)")
        if "htc" in r.get("paths", {}):
            per += ("; paths.htc: per phase 17 train step (AugReg-L HTC++, "
                    "1600x1408 canvas, batch 1, fp32)")
        if "grounding" in r.get("paths", {}):
            per += ("; paths.grounding: per phase 20 train step (the large "
                    "WSDM2023 GroundingDINO, 1024 canvas, batch 2, fp32)")
        if "det_bf16" in r.get("paths", {}):
            per += ("; paths.det_bf16: per train step of the DeiT-S Mask "
                    "R-CNN configs (1024 canvas, batch 2, bf16; not run "
                    "end to end here)")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"vitadapter_torch/ops/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "status": ("not a TPU kernel" if name in NOT_TPU_KERNELS
                       else "ported"),
            "covers": COVERS.get(name, []),
            "launches": paths[path][name], "main_path": path,
            **{f"launches_{p}": c.get(name, 0) for p, c in paths.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{key: r[key] for key in ("paths", "small_level", "model_shaped",
                                       "us_per_round")
               if key in r},
            "per": per + f"; launches over the {path} phase"})
    # the card again near the end, where a tail of the output shows it
    log(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
