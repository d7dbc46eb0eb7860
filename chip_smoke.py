#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--reps 20]

Phases, each of which raises (exit code 1) on failure:
  1. environment: torch/CUDA versions, the card's name and power limit,
     and the card's peak rates from NVIDIA's data sheet (an unknown card
     raises); TF32 is switched off for matmuls and convolutions;
  2. build every CUDA kernel of the port from `poco_tpu_torch/csrc/`
     (nvcc, in parallel), printing the `-Xptxas -v` report;
  3. kernel check: the skinning kernel (`skinning`, 3xTF32 tensor cores)
     and its fp32-FMA yardstick (`skinning_simt`) against the plain torch
     version on the card, at every batch the main paths launch it with
     (B = 1, 2, 4, 8, 16, 32, 64, 128 at V=6890; the launch layout depends on B),
     a ragged shape and the model axis's vertex shards (B = 64 at V = 3445
     and 1723, B = 4 at V = 64); the backward kernel (`skinning_backward`, 3xTF32
     tensor cores) and its fp32-FMA yardstick (`skinning_backward_simt`)
     against their plain version at the same shapes (both gradients within
     1e-5 x max |plain| + 1e-7); 3b. the 3xTF32 linear kernel
     (`linear_3xtf32`, HMR 2.0's ViT-H products) at the four products of
     a ViT-H block (qkv; proj and fc2 with the residual; fc1 with GELU) at
     24,576 rows (a 128-box request): each output's error against the
     same epilogue over an fp64 product, scaled by |x| @ |w|^T + |b|
     (+ |residual|), within 4 x that of `linear_reference` (cuBLAS fp32,
     TF32 off) on the same inputs, a bar the same call in TF32 must fail;
  4. main path at full width: POCO-CLIFF (HRNet-W48-cls, configs/
     poco_cliff.yaml) with seeded random weights and a V=6890 synthetic
     SMPL answers `detect_forward` requests of 1, 8 and 128 boxes on a
     720x1280 image; `skinning` must launch once per request and
     `skinning_simt` never; a 2-box request is held against the same
     weights on the CPU; a 128-box request with a NaN centre and an
     infinite scale (`nonfinite_request`) answers, its other rows bitwise
     those of the request with the two boxes finite, the two NaN where
     the CPU's are, and a 1-box request is the same before and after it;
     the port's other indices taken from data run on NaN and infinite
     inputs and agree with the CPU (`nonfinite_indices`);
  4b. POCO-PARE (HRNet-W32, PARE head, feat-pose uncertainty, 3-layer
     flow; configs/poco_pare.yaml) the same way: requests of 1, 8 and 128
     boxes, launches, shapes, card against CPU (the vertices against the
     CPU's float64 forward, see `vertices_gate`);
  4c. the flow head: `model(batch, smpl)` with a GT pose at B=128 for both
     POCO models gives a finite (B, 24) `log_phi`; card against CPU at B=2;
  4d. the HMR baseline (ResNet-50, configs/spin_hmr.yaml): one 8-box
     request, launches, shapes, card against CPU (the vertices as in 4b);
  4e. evaluation at full width: `run_eval` of POCO-CLIFF over 1024
     synthetic 3DPW-style samples in batches of 64 (gendered GT meshes
     from three V=6890 SMPLs), flip-TTA off and on; `skinning` must launch
     5 times a batch, 7 with flip-TTA; the first 16 samples against the
     CPU, the card's Procrustes against float64 numpy, flip-TTA of a
     flip-equivariant stub exact, one batch of POCO-PARE; samples/s (and
     at batch 128 without flip-TTA), and whether the SVD syncs the host;
  4f. training at full width: POCO-CLIFF (configs/poco_cliff.yaml) through
     `Trainer.fit` for one epoch of 10 steps at the config's batch of 64 on
     synthetic samples of the config's five-dataset mix, then validation
     (`run_eval`) on 128 samples; every loss term finite at every step;
     each step launches `skinning` twice and `skinning_backward` once;
     resumed from `last`, one more step repeats the uninterrupted one
     (loss within 1e-5 relative, cuDNN deterministic); card against CPU at
     batch 2, dropout all-keep (loss within 1e-4 relative; each module
     group's gradient within 1e-3 relative L2, or 3 x the CPU's own fp32
     distance from float64 where fp32 cannot do better); the loss falls
     over 13 steps on one batch; step ms and crops/s over 10 steps after 3;
     then POCO-PARE (configs/poco_pare.yaml, phase 4b's weights): card
     against CPU at batch 2 the same way, and 13 steps at batch 64 on one
     device-side batch (2 + 1 launches a step, finite loss terms, step ms);
  4g. real images: the port's loader (`poco_tpu_torch/runtime/loader.py`)
     is built and prints its route (libjpeg, or nvJPEG where the host has
     no libjpeg); the 48 smoke JPEGs (`data/dataset_folders/smoke/`)
     decode within 2 grey levels of cv2's 16x16 area-mean thumbnails
     (means within 0.5; `tests/data/torch_smoke_thumbs.npz`, made on a
     host with OpenCV); `PocoDataset.get_batch` over smoke_train.npz with
     augmentation equals the per-item path (crops within 1e-5, every other
     key exact); synthetic occlusion changes pixels only under the pasted
     occluders; `python -m poco_tpu_torch.cli.train` (configs/
     tiny_smoke.yaml, one epoch) and `cli.eval` of its checkpoint over the
     smoke JPEGs, and at full width `cli.eval` of POCO-CLIFF (batch 8,
     random weights) and `Trainer.fit` of POCO-CLIFF from configs/
     poco_cliff.yaml on smoke_train (batch 16, 2 epochs, validation on
     smoke_test): finite losses, reports with summary / splits /
     per_joint, and each run's kernel launches; the loader's crops/s at
     batch 64 on the smoke JPEGs and on a 1920x1080 JPEG
     (`tests/data/torch_fullhd.jpg`), the POCO-CLIFF train step alone
     and with a loader thread decoding full-HD batches beside it, and a
     `Trainer.fit` of POCO-CLIFF at batch 64 over crops of that JPEG (the
     trainer's crops/s, the loader in the loop);
  4h. serving: POCO-CLIFF (phase 4's weights) exported on the card with
     `runtime/export.py` (uint8 input, buckets 1, 8, 32, 128; export, load
     and per-bucket warm-up seconds, the artifact's size; 4h's compact
     artifact and 4r's bf16, data-parallel and CPU-exported ones are
     exported beside it, each by a process of its own); the exported
     program against eager `model(batch, smpl)` at 1, 8, 32 and 128 crops
     (joints3d / vertices within 1e-6 m, every other output within 1e-5
     absolute and relative), `skinning` once per bucket dispatch; a
     torch.profiler trace of `ExportedPoco.predict` at 1 and 32 crops
     (device busy share); then a `PocoServer` on loopback driven by
     `cli/bench_serving.run_combo` at 1x1, 8x1, 1x8, 64x1 and 1x128
     (clients x crops a request, at least 50 timed requests each): p50/p99
     latency, crops/s and requests per dispatch, one `skinning` launch a
     dispatch, and every response's shapes and its rows against
     `ExportedPoco.predict` on that client's own crops at the bucket its
     wave ran at, to the same tolerances; a compact artifact's fp16
     vertices within 1 mm of the fp32 ones;
  4i. multi-process (`poco_tpu_torch/parallel/`): (a) `cli.train --dist`
     (tiny_smoke, one epoch on the smoke JPEGs) and `cli.eval --dist` of
     its checkpoint under torchrun's environment for one process, an
     NCCL world of one, against the same runs without --dist (losses and
     report within rtol 2e-4); (b) two ranks of this script (subprocesses)
     sharing the card over gloo train POCO-CLIFF (configs/poco_cliff.yaml
     as it is, phase 4's weights, phase 4f's synthetic samples) for 2
     steps at the global batch of 64, 32 a rank, and evaluate the fitted
     weights sharded on phase 4e's first 256 samples; one process fits
     the same steps (twice: the card's run-to-run difference is printed
     beside) and evaluates the ranks' fitted weights: per-step losses
     within rtol 2e-4, the parameter checksum within 1e-5, the first
     step's summed gradients the same on both ranks and each top-level
     module's within relative L2 1e-3 of one process's (the backbone's,
     whose ReLU units flip with rounding, 0.1), every sample's
     MPJPE / PA-MPJPE / V2V within 1e-4 m; each rank's launches (2 + 1 a
     step, 5 an evaluation batch) are added to the record; the step time
     of the ranks against one process and each step's gradient
     all-reduce (two ranks on one card show correctness, not scaling);
  4j. the demo (`python -m poco_tpu_torch.cli.demo`): (a) YOLOv3 at full
     width (width 32, 80 classes, 416 px) from a seeded Darknet file
     (BN affine randomized, statistics calibrated on 12 smoke canvases)
     loaded through `load_darknet_weights`: the raw maps of three canvases,
     card fp32 against CPU float64 (1e-3 x max(1, max |map|)), the decoded
     boxes and scores before the threshold against the CPU in fp32 on the
     card's canvases (1e-2 px + 1e-4 relative, 1e-4), the kept box counts of
     `detect_batch` at batch 12 over the smoke JPEGs and the full-HD one
     with a lowered `conf_threshold` (random weights score near 0.25),
     images/s; (b) `cli.demo --mode folder` with POCO-CLIFF (phase 4's
     weights through --ckpt, its V=6890 SMPL through --smpl_dir) over the
     first 11 smoke JPEGs and the full-HD frame, `--detector refine --sideview
     --save_obj` then `--detector yolo`: one PNG an image of its width
     (twice with the side view), `skinning` twice a frame (refine) or
     once a frame with boxes (yolo), the mesh drawn by a fixed in-frame
     camera, the full-HD frame's results against a CPU tester on the same
     image and boxes (vertices 1e-4 m + one fp16 ulp, orig_cam, var and
     var_global 2e-3 x max(1, |CPU|)); (c) `cli.demo
     --mode video --smooth` over `tests/data/torch_video/` (16 shifting
     960x540 crops of the full-HD JPEG): tracking, inference, smoothing,
     16 rendered frames, the uncertainty log, `skinning` 2 tracking
     dispatches + one a chunk and one a smoothed track + the warm-up's
     forwards at the frame's size and the tracking pass's; (d) `cli.demo
     --mode webcam --smooth` over the first 8 of those frames as a
     replayed camera, pipelined and `--stream_sequential` with one tester:
     fps and the end-to-end and model latencies (p50, p90), `skinning`
     twice a frame, the two runs' frames bit-identical; (e) Motion-JPEG
     with neither cv2 nor ffmpeg on the host (`utils/mjpeg.py`): the 16
     JPEGs stored unchanged in `clip.avi`, `--mode video --vid_file
     clip.avi --smooth` on (c)'s tester (frames extracted byte-equal to
     the sources, (c)'s launch count, every result bitwise (c)'s, the
     written `clip_poco.avi` reading back a frame a rendered PNG), `--mode
     webcam --display` over the first 8 served as an HTTP
     multipart/x-mixed-replace stream on loopback, on (d)'s tester (its
     PNGs bitwise (d)'s pipelined run's, `skinning` twice a frame, the
     display notice once), `--detector maskrcnn` falling back with the JAX
     demo's notice, and a camera index raising, naming cv2; the folder pass
     writes each input's own name, the JPEGs as JPEG (nvJPEG's encoder on
     the card's host): the full-HD frame's overlay, decoded by the port's
     loader, within 30 dB PSNR of the frame rendered again, and the
     encoder on the decoded full-HD input within 0.5 dB of cv2.imwrite's
     default quality (FULLHD_CV2_PSNR); then `skinning` against its plain
     version at every batch the demo launched; ms a frame by stage;
  4k. the render and part-segmentation losses at full width (the soft
     rasterizer, `ops/soft_raster.py`): POCO-PARE (configs/poco_pare.yaml
     as it is, batch 64, phase 4b's weights, phase 4f's samples) with
     TRAINING.USE_SMPL_RENDER_LOSS and USE_SMPL_SEGM_LOSS set on in code:
     card against CPU at batch 2 as phase 4f holds it (the float64
     forward's ReLU branches; each leaf within 1e-3 relative), every loss
     term finite and both new terms present, 1 + 13 steps on one batch
     (ms a step over 10 after 3 of warm-up), 2 + 1 launches a step, the
     peak `max_memory_allocated`, a profile of the step by `TRAIN_STAGES`
     (uncounted: after the launch check); then POCO-CLIFF with the render
     loss only (no `pred_segm_mask`, so no segmentation term, as in JAX);
  4l. TRAINING.SAVE_IMAGES and the profile hook: a `Trainer.fit` of
     POCO-CLIFF (configs/poco_cliff.yaml, batch 64, 5 steps) with
     POCO_TPU_PROFILE_DIR set: a (896, 672, 3) grid a step under
     `<logdir>/images/`, its render time, and the Chrome trace of the
     first 5 steps with every `TRAIN_STAGES` range and the skinning
     kernels' launches in it;
  4m. launchers: `cli.train --make_launcher bash` on
     tests/data/tiny_smoke_grid.yaml (configs/tiny_smoke.yaml with two
     learning rates), the script run on the card: both runs' logdirs and
     checkpoints (removed after); `cli.eval --make_launcher bash` parsed
     by `bash -n`;
  4n. the SMPL "model" axis (`parallel/distributed.form_grid`,
     `parallel/mesh.shard_smpl_params`, the sharded forward of
     `smpl/lbs.py`), run at the end of 4i: (a) 4i's two gloo ranks as
     data 1 x model 2, the V=6890 SMPL split 3445 / 3445: `smplcam_head`
     on 64 rows against each rank's unsharded SMPL (vertices and joints3d
     within 1e-5 m, joints2d 1e-2 px; the SMPL stage's time both ways,
     two ranks on one card: correctness, not scaling), then one POCO-CLIFF
     train step at the config's batch of 64, every row on both ranks,
     from phase 4's weights, against this process's step on the same rows:
     the loss terms within rtol 2e-4, the gradient checksum within 1e-5
     and each top-level module's gradient at 4i's bars, the same on both
     ranks; `skinning` twice and `skinning_backward` once a step at the
     shard's shape, their peak memory; (b) four ranks of this script, data
     2 x model 2, tiny-cliff with a V=128 synthetic SMPL, one step at the
     global batch of 8 against one process, the same way;
  4o. the demo's drawing flags and pose tracking, in 4j's tester: folder
     mode `--draw_keypoints` (every in-frame joint drawn), video mode
     `--sideview --wireframe` over 4 frames (twice the width, the side
     view's caption box equal to cv2's, kept in
     tests/data/torch_caption_cv2.npz: the box exact, at most 0.5% of
     its pixels differing, by one grey level at most; a fixed-camera wireframe
     and filled render timed), `--tracking_method pose` over seeded
     posetrack JSON (a track a person, one inference a track); each run's
     launches and render ms a frame;
  4p. `crop_and_resize_mxu` against the gather on the full-HD frame at 8
     and 128 boxes: the largest difference (within 1e-2 grey levels) and
     both times;
  4q. the tools (`python -m poco_tpu_torch.cli.<tool>`), at full width:
     (a) `convergence_bench --which cliff` for 11 epochs (the tool's 150
     cut) on a fresh synthetic `conv` set, in a process of its own: every
     logged loss term finite, val MPJPE at epoch 9 (and the best model's)
     within the tool's 120 mm, the 3D joint loss lower over epochs 10-11,
     past the freeze boundary, than over 0-9 (the correlation and the
     tool's pass printed, not gated), and one epoch of the recipe in this
     process through `cli.train.main`: 2 `skinning` + 1 `skinning_backward`
     a step; (b) `calibration_decay` over (a)'s run: each row's MPJPE
     within 1e-3 mm of the trainer's validation of that epoch; (c)
     `camera_bringup` on (a)'s best model for 2 epochs (the tool's 40
     cut): every tensor but `head.deccam`'s bit-identical,
     `skinning_backward` once a step, the 2D error of its output below its
     input's; (d) `detector_quality` on (a)'s test set with (c)'s
     checkpoint: full_frame's mean IoU its closed form; (e) `golden_gate`
     on a reference-format checkpoint of phase 4's POCO-CLIFF, gendered
     synthetic SMPL files and the repo's smoke set: the card within
     METERS_TOL of the same gate on the CPU, and a failed verdict with a
     reference 1 mm off; (f) `profile_model --precision 32`, inference at
     128 and a train step at 64, 3 steps each: the trace holds the
     skinning kernels (and the train step's TRAIN_STAGES ranges); then
     both kernels against their plain versions at the phase's shapes
     (V=432, the recipe's SMPL; V=512, the gate's);
  4r. precision and artifacts: (a) POCO-CLIFF and POCO-PARE in bf16
     (`models.poco.compute_precision`) at 128 boxes beside fp32, each
     output's largest distance from fp32 (joints and vertices in mm),
     `skinning` once a request (its wrapper takes fp32 only), and the
     card's bf16 against the CPU's at batch 2 by the bars of
     tests/test_torch_precision.py, or within twice the card's own bf16
     through cuDNN against the native convolutions, the camera
     translations against the card's own `pred_cam`; (b) the bf16 artifact of POCO-CLIFF
     (uint8, buckets 1, 8, 32, 128) against the eager bf16 forward at
     every bucket (the fp32 artifact's tolerances, or a tenth of bf16's
     distance from fp32 where cuDNN picks other algorithms), `predict` at 1
     and 128 crops beside 4h's fp32 artifact, 8x1 over HTTP held to
     `predict`; (c) a TRAINING.PRECISION: 16 train step of POCO-CLIFF at 64
     (first step's loss beside fp32's from the same weights, 13 steps:
     finite, 2 + 1 launches, ms beside 4f's); (d) a data_parallel=2
     artifact with its replicas named on the one card: against 4h's
     artifact at 8, 32, 128 crops within the JAX package's bars, `skinning`
     once a shard, 8x1 over HTTP held to `predict` (correctness, not
     scaling); (e) POCO-CLIFF exported on the CPU for ("cpu", "cuda"),
     served on the card: against 4h's artifact within the same bars,
     `skinning` launched on the card; (f) `cli.bench_serving --overload
     --server-subproc` on 4h's artifact (64 clients of 8 crops, a budget
     of 32 rows, two floods of 2 s: rejections, each a 429 or 503 with a
     Retry-After, and the pending rows within the budget) and
     `--sweep-window 0,5` at 64x1;
  4s. HMR 2.0 (ViT-H/16 trunk and the cross-attention SMPL decoder,
     configs/hmr2_vith.yaml) with seeded random weights: one 128-box
     `detect_forward` request launches `linear_3xtf32` 128 times (4 a
     block, 32 blocks) and `skinning` once, with finite outputs of the
     right shapes; no other main path launches `linear_3xtf32`;
  5. request time of POCO-CLIFF's `detect_forward` at 1 and 8 boxes
     (median, min, max); crops/s at batch 128, fp32: POCO-CLIFF with the
     kernel and, in turns, with the plain skinning in its place (the
     yardstick); POCO-PARE with the kernel;
  6. a torch.profiler trace of 128-crop requests of POCO-CLIFF and of
     POCO-PARE, of POCO-CLIFF's eval step on a batch of 64 with flip-TTA
     off and on, of one train step at batch 64 of each POCO model, and of
     the POCO-CLIFF step with the loader decoding beside it: device busy
     and idle share, the skinning kernels' share, the top device kernels,
     the eval and train steps' device time by stage (their `EVAL_STAGES`
     and `TRAIN_STAGES` profiler ranges); and the SMPL stage alone with the
     kernel and with the plain skinning;
  7. kernel timing, last (after CUDA-graph capture the eager launches of
     phases 5 and 6 would run slower): both kernels at phase 3's shapes,
     in turns, from CUDA events around CUDA-graph replays, with the
     inputs hot in L2 and cold (rotating over sets larger than L2),
     beside the card's bound for the same work; 7b. the backward kernel
     and its yardstick the same way at B = 64 and 128, in turns, beside
     autograd through the plain forward; 7c. `linear_3xtf32` (the weight's
     split and the kernel, as the ViT calls it) at phase 3b's shapes, in
     turns with `linear_reference` (the library's fp32 GEMM, which the
     port no longer calls there), from CUDA events, beside the bound of
     three TF32 products at the card's peak.
Every phase boundary (`mark`) synchronizes with the card and names
itself in a CUDA fault's message: a device-side assert surfaces at the
first synchronization after the kernel that raised it. 4j has boundaries
of its own: after its image read (nvJPEG decodes on 8 threads) and after
each of (a)-(d).
The yardsticks never launch on the main paths (checked in 4-4r, in
every rank). The line before the last is the kernels' JSON record
(`skinning`, `skinning_simt`, `skinning_backward`,
`skinning_backward_simt`, `linear_3xtf32`, launches summed over phases
4-4s and the ranks of 4i and 4n); the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.utils.data import Subset

from poco_tpu_torch.cli import bench_serving
from poco_tpu_torch.cli import demo as cli_demo
from poco_tpu_torch.cli import eval as cli_eval
from poco_tpu_torch.cli import train as cli_train
from poco_tpu_torch.config import model_config_from_hparams, update_hparams
from poco_tpu_torch.constants import (
    FOCAL_LENGTH,
    IMG_NORM_STD,
    IMG_RES,
    PW3D_OCCLUDED_SEQUENCES,
    PW3D_TEST_SEQUENCES,
)
from poco_tpu_torch.data import occlusion
from poco_tpu_torch.data.inference import images_in_folder
from poco_tpu_torch.data.dataset import PocoDataset, calculate_bbox_info_np, collate
from poco_tpu_torch.data.transforms import affine_output_to_source
from poco_tpu_torch.demo import yolo as demo_yolo_module
from poco_tpu_torch.demo.tester import detect_forward
from poco_tpu_torch.eval import metrics as eval_metrics
from poco_tpu_torch.eval import runner as eval_runner
from poco_tpu_torch.eval.checks import equivariant_case, procrustes_f64
from poco_tpu_torch.eval.runner import (
    EVAL_STAGES,
    make_gendered_eval_step,
    pw3d_split_report,
    run_eval,
)
from poco_tpu_torch.losses.segmentation import part_segmentation_loss
from poco_tpu_torch.models.layers import get_heatmap_preds, grid_sample_bilinear
from poco_tpu_torch.models.poco import (
    build_hmr,
    build_hmr2,
    build_poco_cliff,
    build_poco_pare,
    compute_precision,
)
from poco_tpu_torch.ops import kernels
from poco_tpu_torch.ops.camera import crop_cam_to_full_img_cam, weak_perspective_to_perspective
from poco_tpu_torch.ops.linear import linear_3xtf32, linear_reference
from poco_tpu_torch.ops.preprocess import normalize_image, preprocess_crops
from poco_tpu_torch.ops.rotation import average_rotmats, axis_angle_to_rotmat, rotmat_to_quat
from poco_tpu_torch.ops.skinning import (
    skinning,
    skinning_backward,
    skinning_backward_reference,
    skinning_backward_simt,
    skinning_reference,
    skinning_simt,
)
from poco_tpu_torch.ops.soft_raster import soft_part_probs
from poco_tpu_torch.runtime import loader as image_loader
from poco_tpu_torch.runtime.export import export_poco, load_exported
from poco_tpu_torch.runtime.server import PocoServer, prepare_request_batch
from poco_tpu_torch.smpl import lbs as lbs_module
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.smpl.lbs import smpl_forward
from poco_tpu_torch.train.step import TRAIN_STAGES
from poco_tpu_torch.utils import spans
from poco_tpu_torch.utils.weights import calibrate_batchnorm, randomize_batchnorm

REPO = Path(__file__).resolve().parent
# profiler ranges, which the profile mirrors on the device but are not
# kernels: the port's spans (the steps' stages among them) and torch.optim's
# own ("Optimizer.step#Adam.step")
RANGES = set(spans.names())


def is_range(name: str) -> bool:
    return name in RANGES or name.startswith("Optimizer.")


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Published peaks of one card at its full power limit, dense rates."""

    bytes_per_s: float      # device memory
    fp32_flop_per_s: float  # fp32 outside the tensor cores
    tf32_flop_per_s: float  # TF32 on the tensor cores


# NVIDIA's data sheets, keyed by the name nvidia-smi prints (sparse
# tensor rates halved to dense). A card not listed raises.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(3.35e12, 67e12, 495e12),  # H100 SXM
    "NVIDIA H100 PCIe": Peaks(2.0e12, 51e12, 378e12),
    "NVIDIA H100 NVL": Peaks(3.9e12, 60e12, 417.5e12),
    "NVIDIA H200": Peaks(4.8e12, 67e12, 494.5e12),  # H200 SXM
}

SKIN_TOL = 1e-4       # kernel vs plain, fp32 sums in another order
# backward kernel vs plain, both gradients: fp32 sums over V in another order
BACKWARD_RTOL, BACKWARD_ATOL = 1e-5, 1e-7
HEAD_TOL = 2e-3       # pred_cam / pred_shape / var_pose, card vs CPU
METERS_TOL = 1e-4     # joints3d / vertices, card vs CPU (0.1 mm budget)
GOLDEN_TOL = 5e-4     # vertices, the 0.5 mm golden-gate budget (BASELINE.md)
CROP_TOL = 0.1        # crop pixels, card vs CPU, in grey levels (see card_vs_cpu)
LOG_PHI_ATOL, LOG_PHI_RTOL = 2e-3, 1e-4   # flow log-likelihood, card vs CPU
POSE_DIST_TOL = 1e-5  # per-joint rotmat MSE of the eval step, card vs CPU
SUMMARY_RTOL, SUMMARY_ATOL = 1e-3, 1e-4   # eval summary scalars, card vs CPU
PROCRUSTES_TOL = 1e-5  # pa_mpjpe on the card against float64 numpy, m
EVAL_SAMPLES, EVAL_BATCH = 1024, 64
EVAL_LAUNCHES = {False: 5, True: 7}   # skinning launches an eval batch, by flip-TTA


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


RUN_START = time.perf_counter()


def mark(label: str) -> None:
    """Where the run stands, so that each phase's share of the time limit
    shows. It synchronizes with the card first: a kernel's fault (a
    device-side assert) surfaces at the first synchronization after it,
    so the fault is raised again here, named after the work that ended
    at this boundary, and the run still fails."""
    try:
        torch.cuda.synchronize()
    except RuntimeError as err:   # torch.AcceleratorError is one
        raise RuntimeError(f"CUDA fault in the work of {label} (the last boundary "
                           f"before it synchronized): {err}") from err
    print(f"-- {label} done, {time.perf_counter() - RUN_START:.1f} s into the run", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean device time of one call, from CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card_peaks(name: str) -> Peaks:
    if name not in PEAKS:
        raise RuntimeError(
            f"no published peaks for {name!r}: add its data sheet figures to "
            f"PEAKS (known: {sorted(PEAKS)})"
        )
    return PEAKS[name]


def phase_environment() -> tuple[str, Peaks]:
    print("== 1. environment")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"{torch.cuda.get_device_name(0)}, power limit not read"
    )
    peaks = card_peaks(card.split(",")[0].strip())
    print(f"card: {card}; peaks used: {peaks.bytes_per_s / 1e12:g} TB/s, "
          f"fp32 {peaks.fp32_flop_per_s / 1e12:g} TFLOP/s, "
          f"TF32 {peaks.tf32_flop_per_s / 1e12:g} TFLOP/s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul.allow_tf32=False cudnn.allow_tf32=False")
    return card, peaks


def phase_build() -> None:
    print("== 2. build")
    start = time.perf_counter()
    reports = kernels.build()
    print(f"built {sorted(reports)} in {time.perf_counter() - start:.2f} s "
          f"(nvcc {kernels.nvcc_path()})")
    for name, rep in reports.items():
        print(f"-- {name}: {rep['seconds']:.2f} s\n{rep['log'].strip()}")


def skinning_inputs(batch: int, num_verts: int, seed: int):
    rng = np.random.RandomState(seed)
    w = rng.randn(num_verts, 24).astype(np.float32) * 2.0
    w = np.exp(w - w.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    tfms = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, 24, 4, 4)).copy()
    aa = torch.from_numpy((0.5 * rng.randn(batch * 24, 3)).astype(np.float32))
    tfms[:, :, :3, :3] = axis_angle_to_rotmat(aa).numpy().reshape(batch, 24, 3, 3)
    tfms[:, :, :3, 3] = 0.2 * rng.randn(batch, 24, 3)
    vp = rng.randn(batch, num_verts, 3).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (w, tfms, vp)]


def backward_grad(batch: int, num_verts: int, seed: int) -> torch.Tensor:
    """An output gradient for the backward kernel: 0.1 x N(0, 1) a coordinate."""
    rng = np.random.RandomState(seed + 1)
    return torch.from_numpy(0.1 * rng.randn(batch, num_verts, 3).astype(np.float32)).cuda()


def skinning_bytes(batch: int, num_verts: int) -> int:
    """W, the transforms and v_posed read once, out written once."""
    return 4 * (num_verts * 24 + batch * 24 * 16 + 2 * batch * num_verts * 3)


def skinning_bound(batch: int, num_verts: int, peaks: Peaks) -> dict:
    """Least time for the work: bytes once each way against operations on
    the fastest engine that keeps fp32 accuracy, the tensor cores with a
    3xTF32 split (three TF32 products of the 24 x 12 blend) plus the
    affine in fp32. `fp32_fma_ms` is the blend and affine all in fp32 FMA,
    the operation bound of the fp32-FMA kernel."""
    t_bytes = skinning_bytes(batch, num_verts) / peaks.bytes_per_s * 1e3
    t_ops = (3 * 2 * 24 * 12 * batch * num_verts / peaks.tf32_flop_per_s
             + 18 * batch * num_verts / peaks.fp32_flop_per_s) * 1e3
    t_fma = (24 * 12 * 2 + 18) * batch * num_verts / peaks.fp32_flop_per_s * 1e3
    return {
        "ms": max(t_bytes, t_ops),
        "by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes,
        "ops_ms": t_ops,
        "fp32_fma_ms": t_fma,
    }


def cold_sets(args, l2_bytes: int = 50 * 2**20):
    """Copies of one input set at distinct addresses, at least 4 and more
    than twice the L2 in all, so that none is in L2 when its turn comes."""
    batch, num_verts = args[2].shape[:2]
    n = max(4, math.ceil(2 * l2_bytes / skinning_bytes(batch, num_verts)))
    return [[a.clone() for a in args] for _ in range(n)]


def graph_ms(fn, arg_sets, replays: int, keep_outputs: bool) -> float:
    """Mean device time of one call of `fn`, from CUDA events around
    replays of a CUDA graph that holds one call for each input set in
    turn, so that the host's cost of a launch is not counted (the gaps
    between the graph's kernels are). With `keep_outputs` every call
    writes a fresh output, so no call finds its output in L2."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for a in arg_sets:
            out = fn(*a)
            if keep_outputs:
                outs.append(out)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del out, outs, graph
    return start.elapsed_time(end) / (replays * len(arg_sets))


def hot_ms(fn, args, calls: int = 200) -> float:
    """Device time of one call on inputs that stay in L2."""
    return graph_ms(fn, [args] * 20, replays=calls // 20, keep_outputs=False)


def cold_ms(fn, sets, calls: int = 40) -> float:
    """Device time of one call on inputs and outputs that are not in L2."""
    return graph_ms(fn, sets, replays=max(1, calls // len(sets)), keep_outputs=True)


# every batch size the main paths launch `skinning` with (the launch
# layout, `group_size` in csrc/skinning.cu, depends on it): requests of
# 128, 8, 1, card-vs-CPU checks of 2, eval batches of 64 and 16, train
# steps of 64 (and `skinning_backward` there); phase 4g's tiny_smoke
# training and validation at 4, its full-width eval at 8 and its
# full-width fit at 16 (the smoke sets hold 16 samples: no ragged batch);
# phase 4h's served buckets 1, 8, 32 and 128, and its export's batch of 2;
# phase 4n's vertex shards: 6890 over 2 (the train step and smplcam_head at
# 64), over 4 (1723, an odd shard) and the 2 x 2 grid's V = 128 over 2 at 4
SKIN_SHAPES = ((128, 6890), (64, 6890), (32, 6890), (16, 6890), (8, 6890), (4, 6890),
               (2, 6890), (1, 6890), (3, 1001), (64, 3445), (64, 1723), (4, 64))


KERNELS_UNDER_TEST = {"v2": skinning, "v1": skinning_simt}
BACKWARD_UNDER_TEST = {"backward": skinning_backward, "backward_simt": skinning_backward_simt}
YARDSTICKS = (skinning_simt, skinning_backward_simt)  # never launched on the main paths
COUNTED = (skinning, skinning_backward, linear_3xtf32, *YARDSTICKS)


def reset_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def read_counts(label: str) -> Counter:
    """Every kernel's launches since `reset_counts`, once no yardstick ran."""
    for fn in YARDSTICKS:
        check(fn.launches == 0, f"{label}: the yardstick kernel {fn.__name__} ran on the main path")
    return Counter({fn.__name__: fn.launches for fn in COUNTED})


def phase_kernel_check() -> dict[str, float]:
    """`skinning` (v2) and `skinning_simt` (v1) against the plain version
    at each shape, and `skinning_backward` and `skinning_backward_simt`
    against their plain version (both gradients within 1e-5 x max |plain|
    + 1e-7); returns each one's largest error."""
    print("== 3. kernel check")
    worst = {label: 0.0 for label in KERNELS_UNDER_TEST}
    for batch, num_verts in SKIN_SHAPES:
        args = skinning_inputs(batch, num_verts, seed=batch + num_verts)
        ref = skinning_reference(*args)
        for label, fn in KERNELS_UNDER_TEST.items():
            out = fn(*args)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            print(f"skinning {label} B={batch} V={num_verts}: max_abs_err "
                  f"{err:.3e} (tolerance {SKIN_TOL}, rtol 0)")
            check(err <= SKIN_TOL, f"skinning {label} disagrees with its plain version: {err}")
            worst[label] = max(worst[label], err)
        grad_out = backward_grad(batch, num_verts, seed=batch + num_verts)
        ref = skinning_backward_reference(*args, grad_out)
        for label, fn in BACKWARD_UNDER_TEST.items():
            got = fn(*args, grad_out)
            torch.cuda.synchronize()
            for name, g, r in zip(("grad_v_posed", "grad_rel_tfms"), got, ref):
                err = float((g - r).abs().max())
                bar = BACKWARD_RTOL * float(r.abs().max()) + BACKWARD_ATOL
                print(f"{fn.__name__} B={batch} V={num_verts} {name}: max_abs_err {err:.3e} "
                      f"(tolerance {bar:.3e} = {BACKWARD_RTOL} x max |plain| "
                      f"{float(r.abs().max()):.3e} + {BACKWARD_ATOL})")
                check(err <= bar, f"{fn.__name__} {name} disagrees with its plain version: {err}")
                worst[label] = max(worst.get(label, 0.0), err)
    return worst


# (name, K, N, epilogue) of a ViT-H block's four products, at the rows of
# a 128-box request (192 tokens a crop)
LINEAR_SHAPES = (("qkv", 1280, 3840, "none"), ("proj", 1280, 1280, "residual"),
                 ("fc1", 1280, 5120, "gelu"), ("fc2", 5120, 1280, "residual"))
LINEAR_ROWS = 128 * 192
LINEAR_TOL = 4.0   # the kernel's scaled error, as a multiple of cuBLAS fp32's


def linear_inputs(k: int, n: int, epilogue: str, seed: int):
    """x ~ N(0, 1), w at nn.Linear's spread (U(+-1/sqrt(k))), b ~ 0.1 N(0, 1),
    and a N(0, 1) residual for the residual epilogue."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(LINEAR_ROWS, k, device="cuda", generator=gen)
    w = (2 * torch.rand(n, k, device="cuda", generator=gen) - 1) * k ** -0.5
    b = 0.1 * torch.randn(n, device="cuda", generator=gen)
    r = (torch.randn(LINEAR_ROWS, n, device="cuda", generator=gen)
         if epilogue == "residual" else None)
    return x, w, b, epilogue, r


def phase_linear_check() -> dict[str, float]:
    """Phase 3b: `linear_3xtf32` against the same epilogue over an fp64
    product at each ViT-H shape, beside `linear_reference` in fp32 (the
    bar, times LINEAR_TOL) and in TF32 (which must miss the bar); returns
    the kernel's largest scaled error and its largest ratio to fp32's."""
    print("== 3b. linear kernel check")
    worst = {"max_scaled_err": 0.0, "ratio_to_fp32": 0.0}
    for name, k, n, epilogue in LINEAR_SHAPES:
        x, w, b, epilogue, r = linear_inputs(k, n, epilogue, seed=k + n)
        want = linear_reference(x.double(), w.double(), b.double(), epilogue,
                                None if r is None else r.double())
        scale = x.double().abs() @ w.double().abs().T + b.double().abs()
        if r is not None:
            scale += r.double().abs()

        def err(y):
            return float(((y.double() - want) / scale).abs().max())

        with torch.no_grad():
            ours = err(linear_3xtf32(x, w, b, epilogue, r))
            fp32 = err(linear_reference(x, w, b, epilogue, r))
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = err(linear_reference(x, w, b, epilogue, r))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        bar = LINEAR_TOL * fp32
        print(f"linear_3xtf32 {name} M={LINEAR_ROWS} K={k} N={n} {epilogue}: max scaled err "
              f"{ours:.3e} (fp32 {fp32:.3e}, bar {LINEAR_TOL:g} x fp32 = {bar:.3e}; "
              f"TF32 {tf32:.3e} = {tf32 / bar:.1f} x the bar)")
        check(ours <= bar, f"linear_3xtf32 {name}: scaled error {ours:.3e} above {bar:.3e}")
        check(tf32 > bar, f"linear_3xtf32 {name}: TF32 ({tf32:.3e}) passes the bar {bar:.3e}, "
                          "which then cannot tell the kernel from TF32")
        worst["max_scaled_err"] = max(worst["max_scaled_err"], ours)
        worst["ratio_to_fp32"] = max(worst["ratio_to_fp32"], ours / fp32)
        del x, w, b, r, want, scale
    torch.cuda.empty_cache()
    return worst


LIBRARY_TOL = 1e-5   # the one-call einsum against the plain version


def skinning_library(w, tfms, v_homog):
    """The skinning forward as one PyTorch call: `torch.einsum` over the
    weights, the transforms' top three rows and the posed vertices with a
    1 appended (`v_homog`, made before the call)."""
    return torch.einsum("vj,bjxy,bvy->bvx", w, tfms[:, :, :3, :], v_homog)


def phase_kernel_timing(peaks: Peaks) -> dict:
    """v2 and v1 timed hot and cold at each shape, in turns v2, v1, v1,
    v2, beside the bound. It runs last: once a CUDA graph has been
    captured, the process's eager launches run slower (a 128-crop request
    about 2% longer on an H100), so phases 5 and 6 must come first."""
    print("== 7. kernel timing")
    times = None
    for batch, num_verts in SKIN_SHAPES:
        args = skinning_inputs(batch, num_verts, seed=batch + num_verts)
        sets = cold_sets(args)
        hot = {k: [] for k in KERNELS_UNDER_TEST}
        cold = {k: [] for k in KERNELS_UNDER_TEST}
        for label in ("v2", "v1", "v1", "v2"):
            fn = KERNELS_UNDER_TEST[label]
            hot[label].append(hot_ms(fn, args))
            cold[label].append(cold_ms(fn, sets))
        plain_hot = hot_ms(skinning_reference, args, calls=40)
        plain_cold = cold_ms(skinning_reference, sets, calls=len(sets))
        library = None
        if times is None:  # the main path's largest request: the library call beside it
            lib_args = args[:2] + [torch.cat([args[2], torch.ones_like(args[2][..., :1])], -1)]
            lib_err = float((skinning_library(*lib_args) - skinning_reference(*args)).abs().max())
            lib_sets = [[a.clone() for a in lib_args] for _ in sets]
            library = {"hot": hot_ms(skinning_library, lib_args, calls=40),
                       "cold": cold_ms(skinning_library, lib_sets, calls=len(lib_sets))}
            del lib_sets
        del sets
        bound = skinning_bound(batch, num_verts, peaks)
        print(f"skinning B={batch} V={num_verts}: bound {bound['ms']:.5f} ms "
              f"({bound['by']}: bytes {bound['bytes_ms']:.5f}, 3xTF32 + fp32 affine "
              f"{bound['ops_ms']:.5f}; fp32 FMA alone {bound['fp32_fma_ms']:.5f})")
        for label in KERNELS_UNDER_TEST:
            for kind, ts in (("hot", hot[label]), ("cold", cold[label])):
                mean = statistics.fmean(ts)
                print(f"  {label} {kind:4s} {mean:.5f} ms (turns {ts[0]:.5f}, "
                      f"{ts[1]:.5f}) = {bound['ms'] / mean:.3f} of bound")
        if library is None:
            print(f"  plain hot {plain_hot:.5f} ms, cold {plain_cold:.5f} ms")
        else:
            print(f"  plain hot {plain_hot:.5f} ms, cold {plain_cold:.5f} ms; library "
                  f"torch.einsum(\"vj,bjxy,bvy->bvx\") hot {library['hot']:.5f} ms, cold "
                  f"{library['cold']:.5f} ms = {bound['ms'] / library['hot']:.3f} of bound, "
                  f"max_abs_err against the plain version {lib_err:.3e} (tolerance "
                  f"{LIBRARY_TOL})")
            check(lib_err <= LIBRARY_TOL, f"the einsum disagrees with the plain version: {lib_err}")
        if times is None:  # the main path's largest request
            times = {
                "library_ms": library["hot"],
                "library_cold_ms": library["cold"],
                "ms": statistics.fmean(hot["v2"]),
                "cold_ms": statistics.fmean(cold["v2"]),
                "earlier_ms": statistics.fmean(hot["v1"]),
                "earlier_cold_ms": statistics.fmean(cold["v1"]),
                "plain_ms": plain_hot,
                "bound_ms": bound["ms"],
                "bound_by": bound["by"],
            }
    return times


# the training batch, twice it, and the training batch on phase 4n's shard
BACKWARD_SHAPES = ((64, 6890), (128, 6890), (64, 3445))


def backward_bytes(batch: int, num_verts: int) -> int:
    """W and the transforms read once, v_posed and the output gradient
    read once, grad_v_posed and grad_rel_tfms written once."""
    return 4 * (num_verts * 24 + 2 * batch * 24 * 16 + 3 * batch * num_verts * 3)


def backward_bound(batch: int, num_verts: int, peaks: Peaks) -> dict:
    """Least time for the backward's work, as `skinning_bound` reckons the
    forward's: its bytes against its operations on the fastest engine that
    keeps fp32 accuracy. Its two GEMM-shaped products, the 24 x 9 blend of
    T's 3x3 block and the 24 x 12 W^T E of grad_rel_tfms, go to the tensor
    cores as 3xTF32; the 9 FMAs of grad_v_posed and the 12 products
    g[x] p[y] stay fp32, a (vertex, sample). `fp32_fma_ms` is all of it in
    fp32 FMA, the operation bound of the kernel as it is written."""
    per_vertex = batch * num_verts
    t_bytes = backward_bytes(batch, num_verts) / peaks.bytes_per_s * 1e3
    t_ops = (3 * 2 * 24 * (9 + 12) * per_vertex / peaks.tf32_flop_per_s
             + (2 * 9 + 12) * per_vertex / peaks.fp32_flop_per_s) * 1e3
    t_fma = (2 * (24 * 9 + 9 + 24 * 12) + 12) * per_vertex / peaks.fp32_flop_per_s * 1e3
    return {"ms": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops, "fp32_fma_ms": t_fma}


def phase_backward_timing(peaks: Peaks) -> dict:
    """The backward kernel (v2) and its fp32-FMA yardstick (v1) hot and
    cold at the training batch and twice it, in turns v2, v1, v1, v2,
    beside the bound, the plain version and autograd through
    `skinning_reference` (the plain forward's own backward)."""
    print("== 7b. backward kernel timing")
    fns = {"v2": skinning_backward, "v1": skinning_backward_simt}
    times = None
    for batch, num_verts in BACKWARD_SHAPES:
        args = skinning_inputs(batch, num_verts, seed=batch + num_verts)
        full = args + [backward_grad(batch, num_verts, seed=batch + num_verts)]
        n = max(4, math.ceil(2 * 50 * 2**20 / backward_bytes(batch, num_verts)))
        sets = [[a.clone() for a in full] for _ in range(n)]
        hot = {k: [] for k in fns}
        cold = {k: [] for k in fns}
        for label in ("v2", "v1", "v1", "v2"):
            hot[label].append(hot_ms(fns[label], full))
            cold[label].append(cold_ms(fns[label], sets))
        plain_hot = hot_ms(skinning_backward_reference, full, calls=40)
        tfms = args[1].clone().requires_grad_(True)
        vp = args[2].clone().requires_grad_(True)

        def autograd_plain():
            return torch.autograd.grad(skinning_reference(args[0], tfms, vp), (tfms, vp), full[3])

        auto_ms = cuda_ms(autograd_plain, iters=20)
        del sets
        bound = backward_bound(batch, num_verts, peaks)
        print(f"skinning_backward B={batch} V={num_verts}: bound {bound['ms']:.5f} ms "
              f"({bound['by']}: bytes {bound['bytes_ms']:.5f}, 3xTF32 products + fp32 rest "
              f"{bound['ops_ms']:.5f}; fp32 FMA alone {bound['fp32_fma_ms']:.5f})")
        for label, fn in fns.items():
            for kind, ts in (("hot", hot[label]), ("cold", cold[label])):
                mean = statistics.fmean(ts)
                print(f"  {label} ({fn.__name__}) {kind:4s} {mean:.5f} ms (turns {ts[0]:.5f}, {ts[1]:.5f}) = "
                      f"{bound['ms'] / mean:.3f} of bound")
        faster = all(a < b for k in (hot, cold) for a in k["v2"] for b in k["v1"])
        print(f"  v1 / v2: hot {statistics.fmean(hot['v1']) / statistics.fmean(hot['v2']):.2f}x, "
              f"cold {statistics.fmean(cold['v1']) / statistics.fmean(cold['v2']):.2f}x; v2 "
              f"faster in every turn: {faster}")
        print(f"  plain (skinning_backward_reference) hot {plain_hot:.5f} ms; autograd through "
              f"skinning_reference {auto_ms:.5f} ms (forward and backward, CUDA events); "
              "no single PyTorch call computes it")
        if times is None:  # the training batch
            times = {"ms": statistics.fmean(hot["v2"]), "cold_ms": statistics.fmean(cold["v2"]),
                     "earlier_ms": statistics.fmean(hot["v1"]),
                     "earlier_cold_ms": statistics.fmean(cold["v1"]),
                     "plain_ms": plain_hot, "autograd_plain_ms": auto_ms,
                     "bound_ms": bound["ms"], "bound_by": bound["by"]}
    return times


def phase_linear_timing(peaks: Peaks) -> dict:
    """Phase 7c: `linear_3xtf32` (split and kernel) and `linear_reference`
    (cuBLAS fp32) at each ViT-H shape, in turns kernel, library, library,
    kernel, from CUDA events, beside the bound: three TF32 products at the
    card's peak, or the bytes read and written once. Returns the times by
    shape, and fc1's (the largest product) at the top."""
    print("== 7c. linear kernel timing")
    by_shape = {}
    with torch.no_grad():
        for name, k, n, epilogue in LINEAR_SHAPES:
            x, w, b, epilogue, r = linear_inputs(k, n, epilogue, seed=k + n)
            fns = {"kernel": lambda: linear_3xtf32(x, w, b, epilogue, r),
                   "library": lambda: linear_reference(x, w, b, epilogue, r)}
            turns = {label: [] for label in fns}
            for label in ("kernel", "library", "library", "kernel"):
                turns[label].append(cuda_ms(fns[label], iters=40, warmup=5))
            flops = 2 * LINEAR_ROWS * n * k
            bytes_ = 4 * (LINEAR_ROWS * k + n * k + n
                          + LINEAR_ROWS * n * (2 if r is not None else 1))
            t_ops = 3 * flops / peaks.tf32_flop_per_s * 1e3
            t_bytes = bytes_ / peaks.bytes_per_s * 1e3
            bound = max(t_ops, t_bytes)
            ms, library = statistics.fmean(turns["kernel"]), statistics.fmean(turns["library"])
            by_shape[name] = {"M": LINEAR_ROWS, "K": k, "N": n, "epilogue": epilogue,
                              "ms": ms, "library_ms": library, "bound_ms": bound,
                              "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            print(f"linear_3xtf32 {name} M={LINEAR_ROWS} K={k} N={n} {epilogue}: bound "
                  f"{bound:.4f} ms (3xTF32 operations {t_ops:.4f}, bytes {t_bytes:.4f}); "
                  f"kernel {ms:.4f} ms (turns {turns['kernel'][0]:.4f}, "
                  f"{turns['kernel'][1]:.4f}) = {bound / ms:.3f} of bound, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s; library F.linear fp32 {library:.4f} ms "
                  f"= {library / ms:.2f} x the kernel")
            del x, w, b, r, fns
    torch.cuda.empty_cache()
    return {**{key: by_shape["fc1"][key] for key in ("ms", "library_ms", "bound_ms", "bound_by")},
            "by_shape": by_shape}


def random_boxes(rng, n: int, h: int, w: int):
    centers = np.stack(
        [rng.uniform(100, w - 100, n), rng.uniform(100, h - 100, n)], axis=1
    ).astype(np.float32)
    scales = rng.uniform(0.8, 3.0, n).astype(np.float32)
    return centers, scales


def max_point_dist(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a.cpu() - b.cpu(), dim=-1).max())


def calibrated_model(build, config: Path, seed: int, device, crops: torch.Tensor):
    """`build` on `device` with the config's settings and seeded weights;
    every BN layer randomized, then pinned to the statistics of `crops`
    (the head's too, where it has BN layers)."""
    cfg = model_config_from_hparams(update_hparams(str(config)))
    torch.manual_seed(seed)
    model = build(device=device, **dataclasses.asdict(cfg))
    randomize_batchnorm(model, torch.Generator().manual_seed(seed + 1))
    crops = crops.to(device)
    calibrate_batchnorm(model.backbone, crops)
    if any(isinstance(m, torch.nn.BatchNorm2d) for m in model.head.modules()):
        with torch.no_grad():
            calibrate_batchnorm(model.head, model.backbone(crops))
    return model


def request_crops(image, centers, scales, device="cuda") -> dict:
    return preprocess_crops(
        torch.from_numpy(image).to(device), torch.from_numpy(centers).to(device),
        torch.from_numpy(scales).to(device),
    )


def check_shapes(out: dict, n: int, extra: dict) -> None:
    expect = {
        "pred_pose": (n, 24, 3, 3), "pred_shape": (n, 10), "pred_cam": (n, 3),
        "smpl_vertices": (n, 6890, 3), "smpl_joints3d": (n, 49, 3),
        "smpl_joints2d": (n, 49, 2), **extra,
    }
    for key, shape in expect.items():
        check(tuple(out[key].shape) == shape, f"{key}: {tuple(out[key].shape)}")
        check(bool(torch.isfinite(out[key]).all()), f"{key}: not finite")


def drive_requests(label: str, model, smpl, image, requests) -> tuple[Counter, list]:
    """The main path: `detect_forward` once per request, with the kernels'
    counts set to 0 just before and read just after."""
    reset_counts()
    outputs = [detect_forward(model, smpl, image, c, s) for c, s in requests]
    torch.cuda.synchronize()
    counts = read_counts(label)
    print(f"{label} requests {[len(c) for c, _ in requests]}: launches {dict(counts)}")
    check(counts["skinning"] == len(requests), f"{label}: skinning must launch once per request")
    return counts, outputs


def fp64_forward(model, smpl, batch: dict) -> dict:
    """The model in float64 on the CPU, on the same float32 crops."""
    model64 = copy.deepcopy(model).cpu().double()
    smpl64 = dataclasses.replace(smpl.to("cpu"), **{
        f.name: getattr(smpl, f.name).cpu().double() for f in dataclasses.fields(smpl)
        if torch.is_tensor(getattr(smpl, f.name)) and getattr(smpl, f.name).is_floating_point()
    })
    with torch.inference_mode():
        return model64({k: v.cpu().double() for k, v in batch.items()}, smpl64)


def vertices_gate(label: str, on_card, on_cpu, truth) -> None:
    """Vertices against the float64 forward on the same crops: one fp32
    forward sits up to about 1e-4 m from its float64 forward here (PARE's
    random part attention and 6D decoder carry fp32 reassociation noise to
    the vertices), so two fp32 forwards cannot be held to 0.1 mm of each
    other. The card must lie within max(0.1 mm, 3 x the CPU's fp32
    distance) of the float64 truth, and within the 0.5 mm golden-gate
    budget (the JAX package's own PARE gate,
    tests/test_fullwidth_parity.py:105-134)."""
    card = max_point_dist(on_card, truth)
    cpu = max_point_dist(on_cpu, truth)
    limit = min(max(METERS_TOL, 3.0 * cpu), GOLDEN_TOL)
    print(f"{label} smpl_vertices on the card's crops: from the float64 forward card "
          f"{card:.3e} m, CPU fp32 {cpu:.3e} m (tolerance {limit:.3e} m)")
    check(card <= limit, f"{label} smpl_vertices: {card} m from the float64 forward")


def card_vs_cpu(label, model, build, smpl, image, centers, scales, head_keys,
                vertices_vs_fp64: bool = False) -> None:
    """The same weights and request on the CPU: head outputs within
    HEAD_TOL, joints3d (and vertices) within METERS_TOL.

    With `vertices_vs_fp64` (POCO-PARE, HMR) the vertices are held apart
    from the crop: the card's crop gather rounds its bilinear weights
    otherwise than the CPU's (sample coordinates near 1e3 px carry ~1e-4
    px of fp32 rounding, a few hundredths of a grey level), and these
    random models carry that input difference to ~1e-4 m at the
    vertices. So the crops are compared on their own (within CROP_TOL
    grey levels), and the model's vertices on the card's crops go to
    `vertices_gate`."""
    cpu_model = build(device="cpu", **dataclasses.asdict(model.cfg))
    cpu_model.load_state_dict(model.state_dict())
    on_card = detect_forward(model, smpl, image, centers, scales)
    cpu_smpl = smpl.to("cpu")
    on_cpu = detect_forward(cpu_model, cpu_smpl, image, centers, scales)
    for key in head_keys:
        err = float((on_card[key].cpu() - on_cpu[key]).abs().max())
        print(f"{label} card vs cpu {key}: max_abs_err {err:.3e} (tolerance {HEAD_TOL})")
        check(err <= HEAD_TOL, f"{label} {key}: card and CPU disagree by {err}")
    for key in ("smpl_joints3d",) if vertices_vs_fp64 else ("smpl_joints3d", "smpl_vertices"):
        dist = max_point_dist(on_card[key], on_cpu[key])
        print(f"{label} card vs cpu {key}: max distance {dist:.3e} m (tolerance {METERS_TOL})")
        check(dist <= METERS_TOL, f"{label} {key}: card and CPU disagree by {dist} m")
    if not vertices_vs_fp64:
        return
    card_crops = {k: v.cpu() for k, v in request_crops(image, centers, scales).items()}
    cpu_crops = request_crops(image, centers, scales, "cpu")
    grey = float((card_crops["img"] - cpu_crops["img"]).abs().max()) * 255 * max(IMG_NORM_STD)
    print(f"{label} card vs cpu crops: max difference {grey:.4f} grey levels "
          f"(tolerance {CROP_TOL}); whole request smpl_vertices "
          f"{max_point_dist(on_card['smpl_vertices'], on_cpu['smpl_vertices']):.3e} m apart")
    check(grey <= CROP_TOL, f"{label}: card and CPU crops disagree by {grey} grey levels")
    truth = fp64_forward(cpu_model, cpu_smpl, card_crops)
    with torch.inference_mode():
        cpu_fp32 = cpu_model(card_crops, cpu_smpl)
    vertices_gate(label, on_card["smpl_vertices"].cpu(), cpu_fp32["smpl_vertices"],
                  truth["smpl_vertices"].float())


def phase_main_path(seed: int) -> dict:
    print("== 4. main path: POCO-CLIFF detect_forward at full width")
    rng = np.random.RandomState(seed)
    h, w = 720, 1280
    image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    centers, scales = random_boxes(rng, 16, h, w)
    with torch.no_grad():
        calib = request_crops(image, centers, scales)["img"].permute(0, 3, 1, 2)
    model = calibrated_model(build_poco_cliff, REPO / "configs/poco_cliff.yaml", seed,
                             "cuda", calib)
    print(f"config: {model.cfg}")
    smpl = synthetic_smpl_model(num_verts=6890, seed=seed, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters; SMPL V={smpl.v_template.shape[0]}")

    requests = [random_boxes(rng, n, h, w) for n in (1, 8, 128)]
    counts, outputs = drive_requests("cliff", model, smpl, image, requests)
    for (c, _), out in zip(requests, outputs):
        n = len(c)
        check_shapes(out, n, {"pred_fullimg_cam_t": (n, 3), "var_pose": (n, 24)})

    c2, s2 = random_boxes(rng, 2, h, w)
    card_vs_cpu("cliff", model, build_poco_cliff, smpl, image, c2, s2,
                ("pred_cam", "pred_shape", "var_pose"))
    nonfinite_counts = nonfinite_request(model, smpl, image, seed)
    nonfinite_indices()
    return {"counts": counts, "model": model, "smpl": smpl, "image": image,
            "requests": requests, "request": requests[-1], "calib": calib, "rng": rng,
            "nonfinite_counts": nonfinite_counts}


NAN_ROW, INF_ROW = 17, 90   # the non-finite boxes of phase 4's 128-box request


def nonfinite_request(model, smpl, image, seed: int) -> Counter:
    """Phase 4's non-finite request: 128 boxes through `detect_forward`,
    one with a NaN centre and one with an infinite scale, between a
    1-box request and the same request again, and beside the 128 boxes
    with those two finite. The process must live on (the crop gather
    used to index out of range there: a device-side assert); every other
    row bitwise equal to the finite request's (else within HEAD_TOL /
    METERS_TOL, stated); the two rows NaN where the CPU's are; the 1-box
    request the same before and after; `skinning` once a request. Its
    boxes come from a generator of their own: the rest of the run draws
    what it drew before."""
    h, w = image.shape[:2]
    centers, scales = random_boxes(np.random.RandomState(seed + 90), 128, h, w)
    bad_c, bad_s = centers.copy(), scales.copy()
    bad_c[NAN_ROW] = np.nan
    bad_s[INF_ROW] = np.inf
    reset_counts()
    before = detect_forward(model, smpl, image, centers[:1], scales[:1])
    finite = detect_forward(model, smpl, image, centers, scales)
    bad = detect_forward(model, smpl, image, bad_c, bad_s)
    after = detect_forward(model, smpl, image, centers[:1], scales[:1])
    torch.cuda.synchronize()
    counts = read_counts("cliff non-finite")
    keys = sorted(k for k, v in bad.items() if torch.is_tensor(v))
    rows = [r for r in range(len(centers)) if r not in (NAN_ROW, INF_ROW)]
    unequal = {k: float((bad[k][rows] - finite[k][rows]).abs().max()) for k in keys
               if not torch.equal(bad[k][rows], finite[k][rows])}
    print(f"cliff non-finite request (128 boxes, row {NAN_ROW} a NaN centre, row {INF_ROW} an "
          f"infinite scale): the process lives; the other 126 rows against the finite "
          f"request: {len(keys) - len(unequal)} of {len(keys)} keys bitwise equal"
          + (f", the rest largest difference {unequal}" if unequal else ""))
    check(counts["skinning"] == 4, f"cliff non-finite: skinning must launch once per request, "
          f"launched {dict(counts)} for 4")
    for k, err in unequal.items():
        bar = METERS_TOL if k in ("smpl_vertices", "smpl_joints3d") else HEAD_TOL
        check(err <= bar, f"cliff non-finite: {k} of the finite rows moved by {err} (bar {bar})")
    check(all(torch.equal(before[k], after[k]) for k in keys),
          "cliff non-finite: the 1-box request changed after the non-finite one")
    check_shapes(after, 1, {"pred_fullimg_cam_t": (1, 3), "var_pose": (1, 24)})

    cpu_model = build_poco_cliff(device="cpu", **dataclasses.asdict(model.cfg))
    cpu_model.load_state_dict(model.state_dict())
    pick = [NAN_ROW, INF_ROW, 0]
    on_cpu = detect_forward(cpu_model, smpl.to("cpu"), image, bad_c[pick], bad_s[pick])
    nan_keys = []
    for k in keys:
        card_nan = torch.isnan(bad[k][pick].cpu())
        check(torch.equal(card_nan, torch.isnan(on_cpu[k])),
              f"cliff non-finite: {k} is NaN elsewhere on the card than on the CPU")
        if bool(card_nan[:2].all()):
            nan_keys.append(k)
    print(f"cliff non-finite rows: NaN where the CPU's are on all {len(keys)} keys (wholly NaN "
          f"on {len(nan_keys)}: {nan_keys}); launches {dict(counts)}")
    return counts


def nonfinite_indices() -> None:
    """The port's other device indices taken from data, on the card with
    NaN and infinite inputs, against the CPU (tests/test_torch_ops.py
    holds the CPU to the JAX package): `rotmat_to_quat`'s candidate pick,
    the hard heatmap argmax, PARE's `grid_sample`, and the part labels
    (argmax of `soft_part_probs`) that `part_segmentation_loss` gathers
    at. Each must run; values finite on both sides within 1e-5; NaN where
    the CPU's is (`grid_sample` too: the point 1e30 out, which the card
    sampled as NaN before `grid_sample_bilinear` clamped finite points to
    just outside the map, is zero on both sides); the labels in [0, 25),
    the loss on them as the CPU's."""
    gen = torch.Generator().manual_seed(5)
    rot = torch.eye(3).repeat(4, 1, 1)
    rot[1], rot[2, 0, 1], rot[3, 1, 1] = float("nan"), float("nan"), float("inf")
    hm = torch.randn(2, 3, 5, 6, generator=gen)
    hm[0, 1], hm[1, 2, 2, 3] = float("nan"), float("inf")
    feats, uv = torch.randn(2, 4, 5, 6, generator=gen), torch.rand(2, 5, 2, generator=gen) * 2 - 1
    uv[0, 1], uv[0, 2, 0], uv[1, 3] = float("nan"), float("inf"), 1e30
    verts = 0.3 * torch.randn(3, 40, 3, generator=gen)
    verts[1], verts[2, 5] = float("nan"), float("inf")
    cam = torch.tensor([[0.9, 0.0, 0.0]]).expand(3, 3)
    parts = torch.eye(24)[torch.randint(0, 24, (40,), generator=gen)]
    logits = 3 * torch.randn(3, 25, 16, 16, generator=gen)
    probs = soft_part_probs(verts.cuda(), cam.cuda(), parts.cuda(), out_res=16)
    labels = probs.argmax(-1)

    def run(device):
        return {"rotmat_to_quat": rotmat_to_quat(rot.to(device)),
                "get_heatmap_preds": torch.cat(
                    [t.flatten() for t in get_heatmap_preds(hm.to(device))]),
                "grid_sample_bilinear": grid_sample_bilinear(feats.to(device), uv.to(device)),
                "soft_part_probs": soft_part_probs(verts.to(device), cam.to(device),
                                                   parts.to(device), out_res=16),
                "part_segmentation_loss": part_segmentation_loss(logits.to(device),
                                                                 labels.to(device))}

    on_card, on_cpu = run("cuda"), run("cpu")
    torch.cuda.synchronize()
    for name, got in on_card.items():
        got, want = got.cpu(), on_cpu[name]
        both = torch.isfinite(got) & torch.isfinite(want)
        close = torch.allclose(got[both].double(), want[both].double(), rtol=0, atol=1e-5)
        same_nan = torch.equal(torch.isnan(got), torch.isnan(want))
        apart = (torch.isnan(got) != torch.isnan(want)).nonzero().tolist()
        print(f"non-finite inputs, {name}: finite values {'agree' if close else 'DISAGREE'}; "
              f"NaN {int(torch.isnan(got).sum())} of {got.numel()} on the card, "
              f"{int(torch.isnan(want).sum())} on the CPU"
              + (f" (NaN on one side only at {apart[:8]})" if apart else ""))
        check(close and same_nan, f"non-finite inputs, {name}: the card and the CPU disagree")
    print(f"non-finite inputs, part labels: in [{int(labels.min())}, {int(labels.max())}]")
    check(0 <= int(labels.min()) and int(labels.max()) < 25, "part labels out of [0, 25)")


def phase_pare(ctx: dict, seed: int) -> dict:
    print("== 4b. POCO-PARE detect_forward at full width")
    model = calibrated_model(build_poco_pare, REPO / "configs/poco_pare.yaml", seed + 2,
                             "cuda", ctx["calib"])
    print(f"config: {model.cfg}")
    print(f"model: {sum(p.numel() for p in model.parameters())} parameters")
    rng, (h, w) = ctx["rng"], ctx["image"].shape[:2]
    requests = [random_boxes(rng, n, h, w) for n in (1, 8, 128)]
    counts, outputs = drive_requests("pare", model, ctx["smpl"], ctx["image"], requests)
    for (c, _), out in zip(requests, outputs):
        n = len(c)
        check_shapes(out, n, {"var_pose": (n, 24), "pred_segm_mask": (n, 25, 56, 56),
                              "uncert_feat": (n, 24 * 128)})
        check("pred_fullimg_cam_t" not in out, "pare: a full-image camera was emitted")
    c2, s2 = random_boxes(rng, 2, h, w)
    card_vs_cpu("pare", model, build_poco_pare, ctx["smpl"], ctx["image"], c2, s2,
                ("pred_cam", "pred_shape", "var_pose"), vertices_vs_fp64=True)
    return {"counts": counts, "model": model, "request": requests[-1]}


def gt_batch(image, centers, scales, rng, device) -> dict:
    """A request's crops with a seeded GT pose and GT_POSE_COND mask."""
    n = len(centers)
    batch = request_crops(image, centers, scales, device)
    aa = torch.from_numpy((0.3 * rng.randn(n, 24, 3)).astype(np.float32))
    batch["gt_pose_rotmat"] = axis_angle_to_rotmat(aa).to(device)
    batch["gt_pose_cond_mask"] = torch.from_numpy(rng.rand(n) < 0.5).to(device)
    return batch


def phase_flow(ctx: dict, pare: dict, seed: int) -> Counter:
    """log_phi with a GT pose at B=128 on the card (both POCO models),
    and card against CPU at B=2. Returns the kernels' launches."""
    print("== 4c. flow head: log_phi with a GT pose")
    rng, image, smpl = np.random.RandomState(seed + 3), ctx["image"], ctx["smpl"]
    h, w = image.shape[:2]
    big = gt_batch(image, *random_boxes(rng, 128, h, w), rng, "cuda")
    small = gt_batch(image, *random_boxes(rng, 2, h, w), rng, "cpu")
    total = Counter()
    for label, model, build in (("cliff", ctx["model"], build_poco_cliff),
                                ("pare", pare["model"], build_poco_pare)):
        reset_counts()
        with torch.inference_mode():
            out = model(big, smpl)
        torch.cuda.synchronize()
        counts = read_counts(f"{label} flow")
        total.update(counts)
        log_phi = out["log_phi"]
        print(f"{label} log_phi: shape {tuple(log_phi.shape)}, range "
              f"[{float(log_phi.min()):.4f}, {float(log_phi.max()):.4f}], "
              f"launches {dict(counts)}")
        check(tuple(log_phi.shape) == (128, 24), f"{label} log_phi: {tuple(log_phi.shape)}")
        check(bool(torch.isfinite(log_phi).all()), f"{label} log_phi: not finite")
        check(counts["skinning"] == 1, f"{label}: skinning must launch once a forward")
        cpu_model = build(device="cpu", **dataclasses.asdict(model.cfg))
        cpu_model.load_state_dict(model.state_dict())
        with torch.inference_mode():
            on_card = model({k: v.cuda() for k, v in small.items()}, smpl)["log_phi"].cpu()
            on_cpu = cpu_model(small, smpl.to("cpu"))["log_phi"]
        excess = float(((on_card - on_cpu).abs() - LOG_PHI_RTOL * on_cpu.abs()).max())
        print(f"{label} card vs cpu log_phi: max_abs_err "
              f"{float((on_card - on_cpu).abs().max()):.3e} (tolerance {LOG_PHI_ATOL} + "
              f"{LOG_PHI_RTOL} x |log_phi|)")
        check(excess <= LOG_PHI_ATOL, f"{label} log_phi: card and CPU disagree")
    return total


def phase_hmr2(ctx: dict, seed: int) -> Counter:
    """Phase 4s: HMR 2.0 at full width, one 128-box request on the main
    path: `linear_3xtf32` 4 times a ViT block, `skinning` once."""
    print("== 4s. HMR 2.0 detect_forward at full width")
    torch.manual_seed(seed + 6)
    model = build_hmr2(device="cuda")
    blocks = len(model.backbone.blocks)
    print(f"model: {sum(p.numel() for p in model.parameters())} parameters, {blocks} ViT blocks")
    rng, (h, w) = ctx["rng"], ctx["image"].shape[:2]
    counts, (out,) = drive_requests("hmr2", model, ctx["smpl"], ctx["image"],
                                    [random_boxes(rng, 128, h, w)])
    check_shapes(out, 128, {"uncert_feat": (128, 1024)})
    check(counts["linear_3xtf32"] == 4 * blocks,
          f"hmr2: linear_3xtf32 must launch 4 times a block ({4 * blocks}), "
          f"launched {counts['linear_3xtf32']}")
    del model, out
    torch.cuda.empty_cache()
    return counts


def phase_hmr(ctx: dict, seed: int) -> Counter:
    print("== 4d. HMR baseline detect_forward at full width")
    model = calibrated_model(build_hmr, REPO / "configs/spin_hmr.yaml", seed + 4,
                             "cuda", ctx["calib"])
    print(f"config: {model.cfg}")
    print(f"model: {sum(p.numel() for p in model.parameters())} parameters")
    rng, (h, w) = ctx["rng"], ctx["image"].shape[:2]
    requests = [random_boxes(rng, 8, h, w)]
    counts, (out,) = drive_requests("hmr", model, ctx["smpl"], ctx["image"], requests)
    check_shapes(out, 8, {"uncert_feat": (8, 2048)})
    check("var_pose" not in out and out["log_phi"] is None, "hmr: an uncertainty was emitted")
    c2, s2 = random_boxes(rng, 2, h, w)
    card_vs_cpu("hmr", model, build_hmr, ctx["smpl"], ctx["image"], c2, s2,
                ("pred_cam", "pred_shape"), vertices_vs_fp64=True)
    return counts


class SyntheticEvalSet:
    """An in-memory 3DPW-style test set with `PocoDataset`'s item schema
    (`poco_tpu_torch/data/dataset.py`, `_finish_item`) and no image files,
    so no OpenCV: seeded float32 crops in [0, 255], each of its own
    brightness and contrast; GT pose uniform in +-0.3 rad axis-angle,
    betas in +-0.5; genders m, f and n; 1080x1920 portrait frames; image
    names spread over the 3DPW test sequences, the occluded ones and
    others, so that every split of `pw3d_split_report` is filled."""

    def __init__(self, n: int, seed: int):
        rng = np.random.RandomState(seed)
        seqs = (list(PW3D_TEST_SEQUENCES) + list(PW3D_OCCLUDED_SEQUENCES)
                + [f"other_sequence_{k:02d}" for k in range(8)])
        self.imgname = [f"imageFiles/{seqs[k]}/image_{i:05d}.jpg"
                        for i, k in enumerate(rng.randint(0, len(seqs), n))]
        self.noise = rng.randint(0, 256, (n, 224, 224, 3), dtype=np.uint8)
        self.gain = rng.uniform(0.2, 1.0, n).astype(np.float32)
        self.offset = rng.uniform(0.0, 120.0, n).astype(np.float32)
        self.pose = rng.uniform(-0.3, 0.3, (n, 72)).astype(np.float32)
        self.betas = rng.uniform(-0.5, 0.5, (n, 10)).astype(np.float32)
        self.gender = rng.choice(np.asarray([0, 1, -1], np.int32), n)  # m, f, n
        self.orig_shape = np.asarray([1920.0, 1080.0], np.float32)
        self.center = np.stack([rng.uniform(300, 780, n), rng.uniform(500, 1420, n)],
                               axis=1).astype(np.float32)
        self.scale = rng.uniform(2.0, 4.5, n).astype(np.float32)

    def __len__(self) -> int:
        return len(self.imgname)

    def __getitem__(self, i: int) -> dict:
        crop = np.clip(self.offset[i] + self.gain[i] * self.noise[i], 0.0, 255.0)
        h, w = self.orig_shape
        return {
            "img": crop.astype(np.float32),
            "pose": self.pose[i],
            "betas": self.betas[i],
            "pose_3d": np.zeros((24, 4), np.float32),
            "keypoints": np.zeros((49, 3), np.float32),
            "keypoints_fullimg": np.zeros((49, 3), np.float32),
            "has_smpl": np.float32(1.0),
            "has_pose_3d": np.float32(0.0),
            "scale": self.scale[i],
            "center": self.center[i],
            "orig_shape": self.orig_shape,
            "focal_length": np.float32(np.sqrt(h**2 + w**2)),
            "bbox_info": calculate_bbox_info_np(self.center[i], self.scale[i], self.orig_shape),
            "is_flipped": np.float32(0.0),
            "rot_angle": np.float32(0.0),
            "gender": self.gender[i],
            "sample_index": np.int32(i),
            "dataset_name": "3dpw",
            "imgname": self.imgname[i],
        }


def device_batch(data, indices, device="cuda") -> dict:
    """Items of `data` collated and moved as `run_eval` moves them."""
    host = collate([data[i] for i in indices])
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in host.items() if not isinstance(v, list)}
    batch["img"] = normalize_image(batch["img"])
    return batch


def spread_sigma(model, smpl, batch: dict) -> None:
    """Rescale the uncertainty head's last layer so that its logits have
    mean 0 and std 1 a joint over `batch`. A randomly initialized head
    gives every sample nearly the same sigma (they span ~1e-5), which
    would leave the calibration correlations of the eval summary to fp32
    noise; a trained head's sigma spans most of (0, 1)."""
    head = model.uncert_head
    last = getattr(head, f"uncert_fc{head.num_fc}")
    logits = []
    hook = last.register_forward_hook(lambda module, inputs, out: logits.append(out))
    try:
        with torch.inference_mode():
            model(batch, smpl)
    finally:
        hook.remove()
    mean, std = logits[0].mean(0), logits[0].std(0).clamp_min(1e-12)
    with torch.no_grad():
        last.weight.div_(std[:, None])
        last.bias.sub_(mean).div_(std)


def eval_card_vs_cpu(model, data, smpls) -> None:
    """The first 16 samples through the same `run_eval` on the card and on
    a CPU copy of the model and SMPLs, flip-TTA off and on: per-sample
    mpjpe, pa_mpjpe, v2v within METERS_TOL, the prepared sigma within
    HEAD_TOL, pose_dist within POSE_DIST_TOL, summary scalars within
    SUMMARY_RTOL or SUMMARY_ATOL, whichever is looser."""
    cpu_model = build_poco_cliff(device="cpu", **dataclasses.asdict(model.cfg))
    cpu_model.load_state_dict(model.state_dict())
    cpu_smpls = [s.to("cpu") for s in smpls]
    sub = Subset(data, range(16))
    for flip in (False, True):
        card = run_eval(model, sub, *smpls, batch_size=EVAL_BATCH,
                        loss_ver=model.cfg.loss_ver, flip_test=flip)
        cpu = run_eval(cpu_model, sub, *cpu_smpls, batch_size=EVAL_BATCH,
                       loss_ver=model.cfg.loss_ver, flip_test=flip)
        check(card.imgnames == cpu.imgnames, "eval: card and CPU sample names differ")
        for key in ("mpjpe_mm", "pa_mpjpe_mm", "v2v_mm"):
            err = float(np.abs(getattr(card, key) - getattr(cpu, key)).max()) / 1000.0
            print(f"eval flip={flip} card vs cpu {key[:-3]}: max {err:.3e} m "
                  f"(tolerance {METERS_TOL})")
            check(err <= METERS_TOL, f"eval {key}: card and CPU disagree by {err} m")
        for key, tol in (("uncert", HEAD_TOL), ("pose_dist", POSE_DIST_TOL)):
            err = float(np.abs(getattr(card, key) - getattr(cpu, key)).max())
            print(f"eval flip={flip} card vs cpu {key}: max_abs_err {err:.3e} (tolerance {tol})")
            check(err <= tol, f"eval {key}: card and CPU disagree by {err}")
        print(f"eval flip={flip}: sigma a sample spans "
              f"{float(np.ptp(cpu.uncert.mean(-1))):.3e} over the 16 samples")
        s_card, s_cpu = card.summary(), cpu.summary()
        for key, ref in s_cpu.items():
            err = abs(s_card[key] - ref)
            tol = max(SUMMARY_RTOL * abs(ref), SUMMARY_ATOL)
            print(f"eval flip={flip} summary {key}: card {s_card[key]:.6f} cpu {ref:.6f} "
                  f"(tolerance {tol:.2e})")
            check(err <= tol, f"eval summary {key}: card and CPU disagree by {err}")


def eval_procrustes_vs_fp64(model, data, smpls) -> None:
    """The card's `pa_mpjpe` on its own joints (4 batches, captured where
    the eval step calls it) against float64 numpy Procrustes."""
    captured = []

    def recording(pred, gt):
        out = eval_metrics.pa_mpjpe(pred, gt)
        captured.append((pred.cpu().numpy(), gt.cpu().numpy(), out.cpu().numpy()))
        return out

    eval_runner.pa_mpjpe = recording
    try:
        run_eval(model, data, *smpls, batch_size=EVAL_BATCH, loss_ver=model.cfg.loss_ver,
                 max_batches=4)
    finally:
        eval_runner.pa_mpjpe = eval_metrics.pa_mpjpe
    pred, gt, card = (np.concatenate(x) for x in zip(*captured))
    ref = np.linalg.norm(procrustes_f64(pred, gt) - gt, axis=-1).mean(-1)
    err = float(np.abs(card - ref).max())
    print(f"eval pa_mpjpe on the card vs float64 numpy Procrustes, {len(card)} samples: "
          f"max {err:.3e} m (tolerance {PROCRUSTES_TOL})")
    check(err <= PROCRUSTES_TOL, f"eval: card Procrustes off float64 by {err} m")


def eval_flip_exact() -> None:
    """Flip-TTA of a flip-equivariant stub equals the ground truth:
    mpjpe and v2v 0 within METERS_TOL (tests/test_eval.py:206-261)."""
    stub, batch = equivariant_case("cuda")
    smpl = synthetic_smpl_model(num_verts=6890, seed=3, device="cuda")
    m = make_gendered_eval_step(stub, flip_test=True)(batch, smpl, smpl, smpl)
    worst = max(float(m["mpjpe"].abs().max()), float(m["v2v"].abs().max()))
    print(f"eval flip-TTA of a flip-equivariant stub: mpjpe/v2v max {worst:.3e} m "
          f"(tolerance {METERS_TOL})")
    check(worst <= METERS_TOL, f"eval: flip-TTA of an equivariant model is off by {worst} m")


def svd_sync_report(card: str) -> None:
    """Whether the linear algebra of the eval step waits for the card
    (torch.cuda sync debug mode turns a synchronizing call into an
    error), and the device and host time of each call at batch 64."""
    rng = np.random.RandomState(9)
    k = torch.from_numpy(rng.randn(EVAL_BATCH, 3, 3).astype(np.float32)).cuda()
    ra = axis_angle_to_rotmat(torch.from_numpy(rng.randn(EVAL_BATCH, 24, 3).astype(np.float32)).cuda())
    joints = torch.from_numpy(rng.randn(2, EVAL_BATCH, 14, 3).astype(np.float32)).cuda()
    calls = {
        "torch.linalg.svd (64,3,3)": lambda: torch.linalg.svd(k),
        "torch.linalg.det (64,3,3)": lambda: torch.linalg.det(k),
        "procrustes_align (64,14,3)": lambda: eval_metrics.procrustes_align(*joints),
        "average_rotmats (64,24,3,3)": lambda: average_rotmats(ra, ra),
    }
    for label, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            syncs = "no"
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            syncs = "yes"
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        reps = 50
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - start) / reps * 1e3
        print(f"{label}: syncs the host: {syncs}; {cuda_ms(fn, iters=reps):.4f} ms device "
              f"(CUDA events), {host_ms:.4f} ms a call on the host clock, on {card}")


def phase_eval(ctx: dict, pare: dict, seed: int, card: str) -> dict:
    """3DPW-style evaluation at full width; returns the kernels' launches
    in its main-path runs and the eval step on a batch of 64, flip-TTA off
    and on, for the profile."""
    print("== 4e. evaluation at full width: POCO-CLIFF run_eval, 3DPW-style synthetic set")
    smpls = (ctx["smpl"],
             synthetic_smpl_model(num_verts=6890, seed=seed + 11, device="cuda"),
             synthetic_smpl_model(num_verts=6890, seed=seed + 12, device="cuda"))
    data = SyntheticEvalSet(EVAL_SAMPLES, seed + 5)
    model = copy.deepcopy(ctx["model"])  # phase 4's weights, its sigma spread out
    spread_sigma(model, smpls[0], device_batch(data, range(EVAL_BATCH)))
    n_batches = math.ceil(EVAL_SAMPLES / EVAL_BATCH)
    print(f"{EVAL_SAMPLES} samples in {n_batches} batches of {EVAL_BATCH}; SMPL neutral, "
          f"male, female at V=6890 from seeds {seed}, {seed + 11}, {seed + 12}")
    total = Counter()
    for flip in (False, True):
        reset_counts()
        result = run_eval(model, data, *smpls, batch_size=EVAL_BATCH,
                          loss_ver=model.cfg.loss_ver, flip_test=flip)
        torch.cuda.synchronize()
        counts = read_counts("eval")
        total.update(counts)
        n = counts["skinning"]
        print(f"eval flip_test={flip}: launches {dict(counts)} (skinning "
              f"{n / n_batches:g} a batch)")
        check(n == EVAL_LAUNCHES[flip] * n_batches,
              f"eval: skinning must launch {EVAL_LAUNCHES[flip]} times a batch")
        check(len(result.imgnames) == EVAL_SAMPLES, "eval: samples lost")
        for key in ("mpjpe_mm", "pa_mpjpe_mm", "v2v_mm", "uncert", "pose_dist"):
            check(bool(np.isfinite(getattr(result, key)).all()), f"eval {key}: not finite")
        report = pw3d_split_report(result.imgnames, result.mpjpe_mm, result.pa_mpjpe_mm,
                                   result.v2v_mm)
        check(set(report) == {"all", "test_seq", "occluded_seq"}, f"eval splits: {set(report)}")
        print(f"eval flip_test={flip} summary: {json.dumps(result.summary())}")
        print(f"eval flip_test={flip} splits: {json.dumps(report)}")

    eval_card_vs_cpu(model, data, smpls)
    eval_procrustes_vs_fp64(model, data, smpls)
    eval_flip_exact()

    reset_counts()
    pare_result = run_eval(pare["model"], Subset(data, range(EVAL_BATCH)), *smpls,
                           batch_size=EVAL_BATCH, loss_ver=pare["model"].cfg.loss_ver)
    torch.cuda.synchronize()
    counts = read_counts("eval pare")
    total.update(counts)
    print(f"eval POCO-PARE, one batch of {EVAL_BATCH}: launches {dict(counts)}; "
          f"summary {json.dumps(pare_result.summary())}")
    check(counts["skinning"] == EVAL_LAUNCHES[False], "eval pare: 5 skinning launches a batch")
    for key in ("mpjpe_mm", "pa_mpjpe_mm", "v2v_mm", "uncert"):
        check(bool(np.isfinite(getattr(pare_result, key)).all()), f"eval pare {key}: not finite")

    # samples/s at batch 64 with flip-TTA off and on, in turns; and at
    # batch 128 without it, the serving phases' batch, for comparison
    # (2 passes each: 6, 6 and 3 before 4q joined the run, 4, 4 and 3
    # before 4r did)
    runs = ((EVAL_BATCH, False), (EVAL_BATCH, True), (EVAL_BATCH, True),
            (EVAL_BATCH, False)) + ((2 * EVAL_BATCH, False),) * 2
    times = {run: [] for run in runs}
    for batch_size, flip in runs:
        torch.cuda.synchronize()
        start = time.perf_counter()
        run_eval(model, data, *smpls, batch_size=batch_size, loss_ver=model.cfg.loss_ver,
                 flip_test=flip)
        torch.cuda.synchronize()
        times[(batch_size, flip)].append(time.perf_counter() - start)
    for (batch_size, flip), ts in times.items():
        med = statistics.median(ts)
        print(f"eval throughput, POCO-CLIFF, batch {batch_size}, flip_test={flip}, "
              f"{len(ts)} passes of {EVAL_SAMPLES} samples: median {med:.4f} s "
              f"(min {min(ts):.4f}, max {max(ts):.4f}) = {EVAL_SAMPLES / med:.1f} samples/s "
              f"(min {EVAL_SAMPLES / max(ts):.1f}, max {EVAL_SAMPLES / min(ts):.1f}) on {card}")
    svd_sync_report(card)
    batch = device_batch(data, range(EVAL_BATCH))
    steps = {flip: make_gendered_eval_step(model, flip_test=flip) for flip in (False, True)}
    return {"counts": total,
            "run_batch": {flip: (lambda s=s: s(batch, *smpls)) for flip, s in steps.items()}}


# -- training ----------------------------------------------------------------

TRAIN_STEPS = 10          # steps of the smoke's one epoch, at the config's batch
TRAIN_VAL_SAMPLES = 128   # validation samples after the epoch
TRAIN_LAUNCHES = (2, 1)   # skinning, skinning_backward launches a train step
RESUME_RTOL = 1e-5        # loss of the resumed step against the uninterrupted run
TRAIN_LOSS_RTOL = 1e-4    # loss, card against CPU, one step at batch 2
GRAD_GROUP_RTOL = 1e-3    # a module group's gradient, card against CPU, relative L2
GRAD_LEAF_ATOL = 1e-5     # with GRAD_GROUP_RTOL, a leaf's bar in L2 form (see train_card_vs_cpu)
RESUME_PARAM_ATOL = 1e-7  # weights after the resumed step vs the uninterrupted run: 1e-3 of
                          # the LR, which a fresh Adam's first step (lr g / |g|) would exceed
TRAIN_DATASETS = ("h36m", "coco", "lspet", "mpii", "mpi-inf-3dhp-spin")
TRAIN_RATIOS = (0.5, 0.233, 0.046, 0.021, 0.2)  # the config's DATASETS_AND_RATIOS


class SyntheticTrainSet:
    """An in-memory training set with `PocoDataset`'s item schema
    (`poco_tpu_torch/data/dataset.py`, `_finish_item`) and no image files,
    so no OpenCV: seeded float32 crops in [0, 255], GT pose uniform in
    +-0.3 rad axis-angle, betas in +-0.5, 720x1280 frames, the five
    datasets of the config's default mix drawn by its ratios (h36m rows
    feed GT_POSE_COND). The GT 3D joints (h36m and MPI-INF rows; the others
    carry none, has_pose_3d 0) come from the neutral SMPL on the CPU, and
    `keypoints_fullimg` places them in the box, for KEYPOINT_2D_NONCROP."""

    def __init__(self, n: int, seed: int, smpl_cpu):
        from poco_tpu_torch.smpl.model import smpl_49

        rng = np.random.RandomState(seed)
        self.noise = rng.randint(0, 256, (n, 224, 224, 3), dtype=np.uint8)
        self.gain = rng.uniform(0.2, 1.0, n).astype(np.float32)
        self.offset = rng.uniform(0.0, 120.0, n).astype(np.float32)
        self.pose = rng.uniform(-0.3, 0.3, (n, 72)).astype(np.float32)
        self.betas = rng.uniform(-0.5, 0.5, (n, 10)).astype(np.float32)
        self.names = rng.choice(TRAIN_DATASETS, n, p=np.asarray(TRAIN_RATIOS) / sum(TRAIN_RATIOS))
        self.orig_shape = np.asarray([720.0, 1280.0], np.float32)
        self.center = np.stack([rng.uniform(300, 980, n), rng.uniform(200, 520, n)],
                               axis=1).astype(np.float32)
        self.scale = rng.uniform(1.5, 3.0, n).astype(np.float32)
        joints = []
        with torch.no_grad():
            for lo in range(0, n, 64):
                rot = axis_angle_to_rotmat(torch.from_numpy(self.pose[lo:lo + 64]).reshape(-1, 3))
                _, j49 = smpl_49(smpl_cpu, torch.from_numpy(self.betas[lo:lo + 64]),
                                 rot.reshape(-1, 24, 3, 3))
                joints.append(j49.numpy())
        self.joints = np.concatenate(joints)
        self.has_3d = np.isin(self.names, ("h36m", "mpi-inf-3dhp-spin")).astype(np.float32)

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int) -> dict:
        crop = np.clip(self.offset[i] + self.gain[i] * self.noise[i], 0.0, 255.0)
        h, w = self.orig_shape
        box = self.scale[i] * 200.0
        kp_full = np.concatenate([self.center[i] + 0.5 * box * self.joints[i, :, :2],
                                  np.ones((49, 1), np.float32)], axis=1).astype(np.float32)
        keypoints = kp_full.copy()
        keypoints[:, :2] = 2.0 * (kp_full[:, :2] - self.center[i]) / box
        pose_3d = np.concatenate([self.joints[i, 25:], np.ones((24, 1), np.float32)], axis=1)
        return {
            "img": crop.astype(np.float32),
            "pose": self.pose[i],
            "betas": self.betas[i],
            "pose_3d": (pose_3d * self.has_3d[i]).astype(np.float32),
            "keypoints": keypoints,
            "keypoints_fullimg": kp_full,
            "has_smpl": np.float32(1.0),
            "has_pose_3d": self.has_3d[i],
            "scale": self.scale[i],
            "center": self.center[i],
            "orig_shape": self.orig_shape,
            "focal_length": np.float32(np.sqrt(h**2 + w**2)),
            "bbox_info": calculate_bbox_info_np(self.center[i], self.scale[i], self.orig_shape),
            "is_flipped": np.float32(0.0),
            "rot_angle": np.float32(0.0),
            "gender": np.int32(-1),
            "sample_index": np.int32(i),
            "dataset_name": str(self.names[i]),
            "imgname": f"synthetic/{self.names[i]}/{i:05d}.jpg",
        }

    def get_batch(self, indices, keep=None) -> dict:
        """The rows of `indices` (the kept positions only, with the global
        batch's `_global_row_names`, for a loader shard: phase 4i)."""
        indices = [int(i) for i in indices]
        if keep is None:
            return collate([self[i] for i in indices])
        batch = collate([self[i] for i in indices[keep]])
        batch["_global_row_names"] = [str(self.names[i]) for i in indices]
        return batch


def train_hparams(logdir: str, config: str = "configs/poco_cliff.yaml"):
    hparams = update_hparams(str(REPO / config))
    hparams.LOG_DIR = logdir
    hparams.TRAINING.MAX_EPOCHS = 1
    hparams.TRAINING.LOG_SAVE_INTERVAL = 1   # every step's loss terms in metrics.jsonl
    return hparams


def counted_steps(trainer, counts: list, losses: list):
    """Wrap the trainer's step: per step, the skinning and backward
    launches it made and its loss terms (fetched, so each step is checked
    finite)."""
    inner = trainer.train_step

    def step(batch, smpl):
        fwd, bwd = skinning.launches, skinning_backward.launches
        metrics = inner(batch, smpl)
        counts.append((skinning.launches - fwd, skinning_backward.launches - bwd))
        losses.append({k: float(v) for k, v in metrics.items() if k.startswith("loss/")})
        return metrics

    trainer.train_step = step


def loss_and_grads(model, batch, smpl, loss_cfg, relu) -> tuple[float, dict]:
    """One forward and backward in train mode (no optimizer step), the
    forward inside the context `relu` (a `ReluMasks` record or replay):
    the loss and each parameter's gradient, in float64 on the CPU."""
    from poco_tpu_torch.losses.losses import poco_loss
    from poco_tpu_torch.train.step import add_pred_render, prepare_gt, render_targets

    gt = prepare_gt(batch, smpl)
    gt.update(render_targets(batch, gt, smpl, loss_cfg))
    model.train()
    with relu:
        out = model(dict(batch, gt_pose_rotmat=gt["gt_pose_rotmat"]), smpl)
    loss, _ = poco_loss(add_pred_render(out, gt), gt, loss_cfg)
    model.zero_grad(set_to_none=True)
    loss.backward()
    return loss.item(), {k: p.grad.double().cpu() for k, p in model.named_parameters()}


def to64(tree):
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: getattr(tree, f.name).double() for f in dataclasses.fields(tree)
            if torch.is_tensor(getattr(tree, f.name)) and getattr(tree, f.name).is_floating_point()
        })
    return {k: v.double() if v.is_floating_point() else v for k, v in tree.items()}


def train_card_vs_cpu(trainer, data) -> None:
    """One full-width step's loss and gradients at batch 2, the same weights
    and batch on the card and on the CPU, dropout all-keep on both. Both
    take the ReLU branches of the CPU's float64 forward (`train.checks.
    ReluMasks`: without them, the units that rounding puts on the other
    side of 0 move the backbone's gradient by whole units, a few % in
    relative L2; printed). The loss within TRAIN_LOSS_RTOL; each module
    group's gradient within GRAD_GROUP_RTOL relative L2; each leaf within
    the L2 form of atol GRAD_LEAF_ATOL + rtol GRAD_GROUP_RTOL."""
    from poco_tpu_torch.models import layers
    from poco_tpu_torch.train.checks import ReluMasks

    keep = layers.dropout_keep_mask
    layers.dropout_keep_mask = lambda x, p: torch.ones_like(x, dtype=torch.bool)
    masks = ReluMasks()
    try:
        host = collate([data[i] for i in range(2)])
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()
                 if not isinstance(v, list)}
        batch["img"] = normalize_image(batch["img"])
        batch["gt_pose_cond_mask"] = torch.tensor([True, False])
        smpl_cpu = trainer.smpl.to("cpu")
        cpu_model = copy.deepcopy(trainer.model).cpu()
        f64_loss, f64 = loss_and_grads(copy.deepcopy(cpu_model).double(), to64(batch),
                                       to64(smpl_cpu), trainer.loss_cfg, masks.record())
        card_batch = {k: v.cuda() for k, v in batch.items()}
        _, free = loss_and_grads(copy.deepcopy(trainer.model), card_batch, trainer.smpl,
                                 trainer.loss_cfg, contextlib.nullcontext())
        card_loss, card = loss_and_grads(copy.deepcopy(trainer.model), card_batch,
                                         trainer.smpl, trainer.loss_cfg, masks.replay())
        card_flips = masks.flips
        cpu_loss, cpu = loss_and_grads(cpu_model, batch, smpl_cpu, trainer.loss_cfg,
                                       masks.replay())
        cpu_flips = masks.flips
    finally:
        layers.dropout_keep_mask = keep
    print(f"train card vs cpu, batch 2, dropout all-keep, ReLU branches of the float64 forward "
          f"({masks.units} units; the card's fp32 forward puts {card_flips}, the CPU's "
          f"{cpu_flips} on the other side of 0)")
    err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"  loss card {card_loss:.6f} cpu {cpu_loss:.6f} float64 {f64_loss:.6f}: relative "
          f"{err:.3e} (tolerance {TRAIN_LOSS_RTOL})")
    check(err <= TRAIN_LOSS_RTOL, f"train step loss: card and CPU disagree by {err}")

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def group(names):
        return lambda grads: torch.cat([grads[k].reshape(-1) for k in names])

    by_group = {}
    for name in cpu:
        by_group.setdefault(name.split(".")[0], []).append(name)
    for name, leaves in by_group.items():
        flat = group(leaves)
        vs_cpu = rel(flat(card), flat(cpu))
        print(f"  gradient {name}: card vs cpu relative L2 {vs_cpu:.3e} (tolerance "
              f"{GRAD_GROUP_RTOL}); card vs float64 {rel(flat(card), flat(f64)):.3e}, cpu vs "
              f"float64 {rel(flat(cpu), flat(f64)):.3e}; card without the masks vs float64 "
              f"{rel(flat(free), flat(f64)):.3e}")
        check(vs_cpu <= GRAD_GROUP_RTOL, f"train {name} gradient: card and CPU disagree by {vs_cpu}")
    worst = (0.0, "")
    for name in cpu:
        err = float((card[name] - cpu[name]).norm())
        bar = GRAD_GROUP_RTOL * float(cpu[name].norm()) + GRAD_LEAF_ATOL * cpu[name].numel() ** 0.5
        check(err <= bar, f"train gradient leaf {name}: card vs CPU {err:.3e} > {bar:.3e}")
        worst = max(worst, (err / bar, name))
    print(f"  every one of {len(cpu)} gradient leaves within |card - cpu| <= {GRAD_GROUP_RTOL} "
          f"|cpu| + {GRAD_LEAF_ATOL} sqrt(n); the closest to its bar: {worst[1]} at "
          f"{worst[0]:.3f} of it")


def phase_train(ctx: dict, pare: dict, seed: int, card: str) -> dict:
    """Training at full width: POCO-CLIFF through `Trainer.fit` for one
    epoch of TRAIN_STEPS steps at the config's batch, validation on
    TRAIN_VAL_SAMPLES samples, resume from `last`, card against CPU, step
    time. Returns the main path's launches and a device batch and step for
    the profile."""
    import tempfile

    from poco_tpu_torch.train.step import make_train_step
    from poco_tpu_torch.train.trainer import Trainer

    print("== 4f. training at full width: POCO-CLIFF Trainer.fit, synthetic samples")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    hparams = train_hparams(tmp.name)
    batch_size = hparams.DATASET.BATCH_SIZE
    check(batch_size == 64, f"configs/poco_cliff.yaml trains at batch {batch_size}, not 64")
    smpl = ctx["smpl"]
    data = SyntheticTrainSet(TRAIN_STEPS * batch_size, seed + 31, smpl.to("cpu"))
    val = SyntheticEvalSet(TRAIN_VAL_SAMPLES, seed + 32)
    names, counts_by_name = np.unique(data.names, return_counts=True)
    print(f"{len(data)} training samples ({dict(zip(names.tolist(), counts_by_name.tolist()))}), "
          f"{len(val)} validation samples, batch {batch_size}, fp32, TF32 off")

    def new_trainer():
        return Trainer(hparams, smpl, train_dataset_fn=lambda epoch: data, val_dataset=val,
                       device="cuda")

    trainer = new_trainer()
    # phase 4's weights: seeded, BN randomized and calibrated
    trainer.model.load_state_dict(ctx["model"].state_dict())
    print(f"config: {trainer.model.cfg}; loss: {trainer.loss_cfg}")
    counts, losses = [], []
    counted_steps(trainer, counts, losses)

    reset_counts()
    start = time.perf_counter()
    summary = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - start
    launches = read_counts("train")
    n_val = math.ceil(TRAIN_VAL_SAMPLES / batch_size) * EVAL_LAUNCHES[False]
    print(f"fit: {len(counts)} steps and validation in {fit_s:.3f} s; launches "
          f"{dict(launches)} (skinning in validation {n_val}); per step "
          f"{sorted(set(counts))}")
    check(len(counts) == TRAIN_STEPS, f"train: {len(counts)} steps, not {TRAIN_STEPS}")
    check(all(c == TRAIN_LAUNCHES for c in counts),
          f"train: each step must launch skinning 2 and skinning_backward 1 times: {counts}")
    check(launches["skinning"] == TRAIN_LAUNCHES[0] * TRAIN_STEPS + n_val,
          "train: validation must launch skinning 5 times a batch")
    for i, terms in enumerate(losses):
        check(all(math.isfinite(v) for v in terms.values()), f"train step {i}: {terms}")
    print(f"train losses by step: {[round(t['loss/total_loss'], 4) for t in losses]}")
    print(f"train first step: {json.dumps(losses[0])}")
    check(all(math.isfinite(v) for v in summary.values()), f"validation: {summary}")
    print(f"validation summary: {json.dumps(summary)}")
    with open(Path(tmp.name) / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f if '"loss/total_loss"' in line]
    check(len([r for r in logged if "step" in r]) == TRAIN_STEPS, "train: steps missing in the log")

    # resume from `last`: one more step, against the same step without the
    # restart; the weights after it read the restored Adam moments too
    host = collate([data[i] for i in range(batch_size)])
    batch = trainer._device_batch(host)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    torch.backends.cudnn.deterministic = True
    try:
        uninterrupted = trainer.train_step(batch, smpl)
        resumed_trainer = new_trainer()
        resumed_trainer.load_checkpoint(str(Path(tmp.name) / "last"))
        resumed = resumed_trainer.train_step(batch, smpl)
        a, b = (float(m["loss/total_loss"]) for m in (uninterrupted, resumed))
        ga, gb = (float(m["grad_norm"]) for m in (uninterrupted, resumed))
    finally:
        torch.backends.cudnn.deterministic = False
    after = [p.detach() for p in trainer.model.parameters()]
    moved = max(float((p - q).abs().max()) for p, q in zip(after, before))
    off = max(float((p - q.detach()).abs().max())
              for p, q in zip(after, resumed_trainer.model.parameters()))
    del before
    err = abs(a - b) / abs(a)
    print(f"resume from last (cudnn.deterministic): step loss uninterrupted {a:.7f}, resumed "
          f"{b:.7f}, relative {err:.3e} (tolerance {RESUME_RTOL}); grad_norm {ga:.7f} / {gb:.7f}; "
          f"weights after the step: largest difference {off:.3e} (tolerance {RESUME_PARAM_ATOL}; "
          f"the step itself moved a weight by up to {moved:.3e})")
    check(resumed_trainer.epoch == 1 and resumed_trainer.step == TRAIN_STEPS,
          "resume: epoch or step counter not restored")
    check(err <= RESUME_RTOL, f"resume: the resumed step's loss is off by {err}")
    check(off <= RESUME_PARAM_ATOL, f"resume: the weights after the resumed step are off by {off}")
    resumed_trainer.close()
    del resumed_trainer, uninterrupted, resumed
    torch.cuda.empty_cache()

    train_card_vs_cpu(trainer, data)
    step = make_train_step(trainer.model, trainer.optimizer, trainer.loss_cfg)
    ts = time_train_step("POCO-CLIFF", step, batch, smpl, card)
    trainer.close()
    pare_step, pare_launches = train_pare(ctx, pare, data, host, card)
    return {"counts": launches, "pare_counts": pare_launches,
            "run_step": lambda: step(batch, smpl), "run_pare_step": pare_step,
            "step_crops_per_s": batch_size / statistics.median(ts), "tmp": tmp,
            "data": data, "host": host}


def time_train_step(label: str, step, batch: dict, smpl, card: str,
                    precision: str = "fp32") -> list[float]:
    """One batch, 3 warm-up and 10 timed steps: every metric finite, the
    loss falling; prints the median step time with min and max and
    returns the timed steps' seconds."""
    batch_size = len(batch["img"])
    totals, times = [], []
    for i in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch, smpl)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        totals.append(float(metrics["loss/total_loss"]))
        check(all(math.isfinite(float(v)) for k, v in metrics.items() if not k.startswith("_")),
              f"{label} overfit step {i}: not finite")
    print(f"{label} overfitting one batch of {batch_size}: total loss "
          f"{[round(t, 4) for t in totals]}")
    check(totals[-1] < totals[0], f"{label}: the loss did not fall over 13 steps on one batch")
    ts = times[3:]
    med = statistics.median(ts)
    print(f"train step {precision}, batch {batch_size}, {label}, {len(ts)} steps after 3 "
          f"warm-up: "
          f"median {med * 1e3:.3f} ms (min {min(ts) * 1e3:.3f}, max {max(ts) * 1e3:.3f}) = "
          f"{batch_size / med:.1f} crops/s (min {batch_size / max(ts):.1f}, max "
          f"{batch_size / min(ts):.1f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}")
    return ts


def train_pare(ctx: dict, pare: dict, data, host: dict, card: str):
    """POCO-PARE's train step (configs/poco_pare.yaml, phase 4b's weights)
    at the config's batch on one device-side batch of phase 4f's samples:
    card against CPU at batch 2 (`train_card_vs_cpu`), then 13 steps, each
    launching `skinning` twice and `skinning_backward` once. Returns the
    step (for the profile) and the timed steps' launches."""
    import tempfile

    from poco_tpu_torch.train.step import make_train_step
    from poco_tpu_torch.train.trainer import Trainer

    print("== 4f. training at full width: POCO-PARE train step")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pare_") as logdir:
        hparams = train_hparams(logdir, "configs/poco_pare.yaml")
        check(hparams.DATASET.BATCH_SIZE == len(host["img"]),
              f"configs/poco_pare.yaml trains at batch {hparams.DATASET.BATCH_SIZE}")
        trainer = Trainer(hparams, ctx["smpl"], train_dataset_fn=lambda epoch: data,
                          device="cuda")
        trainer.close()
    trainer.model.load_state_dict(pare["model"].state_dict())
    print(f"config: {trainer.model.cfg}; loss: {trainer.loss_cfg}")
    train_card_vs_cpu(trainer, data)
    batch = trainer._device_batch(host)
    step = make_train_step(trainer.model, trainer.optimizer, trainer.loss_cfg)
    reset_counts()
    time_train_step("POCO-PARE", step, batch, ctx["smpl"], card)
    launches = read_counts("train POCO-PARE")
    print(f"POCO-PARE train steps: launches {dict(launches)}")
    check((launches["skinning"], launches["skinning_backward"])
          == tuple(13 * n for n in TRAIN_LAUNCHES),
          "train POCO-PARE: each step must launch skinning 2 and skinning_backward 1 times")
    return (lambda: step(batch, ctx["smpl"])), launches


# -- the render and part-segmentation losses, training images, launchers ------

RENDER_TERMS = ("loss/loss_smpl_render", "loss/loss_smpl_segm")
IMAGE_STEPS = 5           # phase 4l's fit: the profile hook traces steps 0-4
GRID_SHAPE = (4 * 224, 3 * 224, 3)   # 4 rows of [crop | GT | prediction]


def read_png(path: Path) -> np.ndarray:
    """An 8-bit RGB PNG as `runtime/image_write.encode_png` writes it
    (filter 0 on every row): the card's host has no libpng."""
    import zlib

    data = path.read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    check(data[24:26] == b"\x08\x02", f"{path}: not 8-bit RGB")
    pos, idat = 8, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += n + 12
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(bool((rows[:, 0] == 0).all()), f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 3)


def loss_trainer(ctx: dict, config: str, weights, render: bool, segm: bool, data,
                 precision: int = 32):
    """A full-width Trainer of `config` as it is, the render and part-
    segmentation losses and TRAINING.PRECISION set in code, with `weights`
    loaded."""
    import tempfile

    from poco_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_losses_") as logdir:
        hparams = train_hparams(logdir, config)
        hparams.TRAINING.USE_SMPL_RENDER_LOSS = render
        hparams.TRAINING.USE_SMPL_SEGM_LOSS = segm
        hparams.TRAINING.PRECISION = precision
        trainer = Trainer(hparams, ctx["smpl"], train_dataset_fn=lambda epoch: data,
                          device="cuda")
        trainer.close()
    trainer.model.load_state_dict(weights.state_dict())
    return trainer


def phase_render_losses(ctx: dict, pare: dict, train: dict, card: str) -> dict[str, Counter]:
    """Phase 4k: the render and part-segmentation losses at full width
    (see the module docstring). Returns each model's launches."""
    from poco_tpu_torch.train.step import make_train_step

    print("== 4k. the render and part-segmentation losses at full width (soft rasterizer)")
    phase_start = time.perf_counter()
    data, host = train["data"], train["host"]
    counts = {}
    for label, config, weights, segm in (
            ("POCO-PARE, render + segmentation", "configs/poco_pare.yaml", pare["model"], True),
            ("POCO-CLIFF, render", "configs/poco_cliff.yaml", ctx["model"], False)):
        trainer = loss_trainer(ctx, config, weights, True, segm, data)
        cfg = trainer.loss_cfg
        check(cfg.use_smpl_render_loss and cfg.use_smpl_segm_loss == segm,
              f"{label}: the loss flags did not reach the loss")
        check(trainer.hparams.DATASET.BATCH_SIZE == len(host["img"]),
              f"{config} trains at batch {trainer.hparams.DATASET.BATCH_SIZE}")
        print(f"{label}: {config} as it is (batch {len(host['img'])}), "
              f"TRAINING.USE_SMPL_RENDER_LOSS on, USE_SMPL_SEGM_LOSS {'on' if segm else 'off'}; "
              f"render weight {cfg.smpl_render_loss_weight}, segmentation weight "
              f"{cfg.smpl_segm_loss_weight}")
        if segm:
            train_card_vs_cpu(trainer, data)
        batch = trainer._device_batch(host)
        step = make_train_step(trainer.model, trainer.optimizer, cfg)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        first = step(batch, ctx["smpl"])
        terms = {k: float(v) for k, v in first.items() if k.startswith("loss/")}
        print(f"{label} first step: {json.dumps(terms)}")
        want = set(RENDER_TERMS) if segm else {RENDER_TERMS[0]}
        check(want <= set(terms) and (segm or RENDER_TERMS[1] not in terms),
              f"{label}: loss terms {sorted(terms)}")
        check(all(math.isfinite(v) for v in terms.values()), f"{label}: {terms}")
        time_train_step(label, step, batch, ctx["smpl"], card)
        counts[label] = read_counts(label)
        peak = torch.cuda.max_memory_allocated()
        print(f"{label}: launches {dict(counts[label])} over 14 steps; peak memory "
              f"{peak / 2**30:.3f} GiB (max_memory_allocated; {resident / 2**30:.3f} GiB "
              f"resident before the steps) on {card}")
        check((counts[label]["skinning"], counts[label]["skinning_backward"])
              == tuple(14 * n for n in TRAIN_LAUNCHES),
              f"{label}: each step must launch skinning 2 and skinning_backward 1 times")
        profile_request(f"train step, {label}, batch 64, fp32", lambda: step(batch, ctx["smpl"]),
                        card, stages=TRAIN_STAGES)
        trainer.close()
        del trainer, step, batch, first
        torch.cuda.empty_cache()
    print(f"phase 4k: {time.perf_counter() - phase_start:.3f} s")
    return {"render_" + k.split(",")[0].lower().replace("-", "_"): v for k, v in counts.items()}


def phase_train_images(ctx: dict, train: dict, card: str) -> Counter:
    """Phase 4l: TRAINING.SAVE_IMAGES and the profile hook in a short
    `Trainer.fit` of POCO-CLIFF at batch 64: a grid a step of the right
    shape, its render time, and the Chrome trace of the first steps with
    every TRAIN_STAGES range and the skinning kernels in it."""
    import tempfile

    from poco_tpu_torch.train.trainer import Trainer

    print(f"== 4l. TRAINING.SAVE_IMAGES and POCO_TPU_PROFILE_DIR: POCO-CLIFF Trainer.fit, "
          f"{IMAGE_STEPS} steps at batch 64")
    phase_start = time.perf_counter()
    data = Subset(train["data"], range(IMAGE_STEPS * 64))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_images_") as logdir:
        hparams = train_hparams(logdir)
        hparams.TRAINING.SAVE_IMAGES = True
        profile_dir = Path(logdir) / "profile"
        os.environ["POCO_TPU_PROFILE_DIR"] = str(profile_dir)
        try:
            trainer = Trainer(hparams, ctx["smpl"], train_dataset_fn=lambda epoch: data,
                              device="cuda")
            trainer.model.load_state_dict(ctx["model"].state_dict())
            render_s = []
            save = trainer._save_images

            def timed_save(*args, **kwargs):
                start = time.perf_counter()
                save(*args, **kwargs)
                render_s.append(time.perf_counter() - start)

            trainer._save_images = timed_save
            reset_counts()
            start = time.perf_counter()
            trainer.fit()
            fit_s = time.perf_counter() - start
            counts = read_counts("train images")
            trainer.close()
        finally:
            del os.environ["POCO_TPU_PROFILE_DIR"]
        grids = sorted((Path(logdir) / "images").glob("*.png"))
        check([g.name for g in grids] == sorted(f"train_e0_s{i}.png" for i in range(IMAGE_STEPS)),
              f"SAVE_IMAGES wrote {[g.name for g in grids]}")
        for g in grids:
            check(read_png(g).shape == GRID_SHAPE, f"{g.name}: not {GRID_SHAPE}")
        traces = sorted(profile_dir.glob("*.json"))
        check([t.name for t in traces] == ["train_e0_rank0.json"], f"traces {traces}")
        size = traces[0].stat().st_size
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    names = Counter(e.get("name", "") for e in events)
    missing = [s for s in TRAIN_STAGES if names[s] == 0]
    check(not missing, f"the trace lacks the ranges {missing}")
    kernels = {k: sum(n for name, n in names.items() if any(m in name for m in marks))
               for k, marks in SKIN_KERNELS.items()}
    print(f"fit: {IMAGE_STEPS} steps in {fit_s:.3f} s (the profiler on for all of them), "
          f"launches {dict(counts)}; {len(grids)} grids of {GRID_SHAPE}, render and write "
          f"{1e3 * statistics.median(render_s):.1f} ms a grid (min {1e3 * min(render_s):.1f}, "
          f"max {1e3 * max(render_s):.1f}; host clock, the synthetic SMPL's random faces); "
          f"trace {size / 2**20:.1f} MiB, {len(events)} events, ranges "
          f"{ {s: names[s] for s in TRAIN_STAGES} }, skinning kernels {kernels} on {card}")
    check((counts["skinning"], counts["skinning_backward"])
          == tuple(IMAGE_STEPS * n for n in TRAIN_LAUNCHES), "train images: launches a step")
    check(kernels["skinning"] >= 2 * IMAGE_STEPS and kernels["skinning_backward"] >= IMAGE_STEPS,
          f"the trace does not hold the skinning kernels' launches: {kernels}")
    print(f"phase 4l: {time.perf_counter() - phase_start:.3f} s")
    return counts


def phase_launchers(card: str) -> None:
    """Phase 4m: `cli.train --make_launcher bash` on a 2-experiment grid of
    configs/tiny_smoke.yaml (tests/data/tiny_smoke_grid.yaml), the script
    run on the card (both runs' logdirs and checkpoints checked, then
    removed), and `cli.eval --make_launcher bash` parsed by `bash -n`."""
    import shutil
    import tempfile

    print("== 4m. grid-search launchers: cli.train / cli.eval --make_launcher bash")
    phase_start = time.perf_counter()
    grid = REPO / "tests" / "data" / "tiny_smoke_grid.yaml"
    runs = REPO / "logs" / "experiments" / "poco" / "tiny_smoke_grid"
    before = set(runs.glob("*")) if runs.exists() else set()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
        scripts = {}
        cwd = os.getcwd()
        try:
            # each in a directory of its own: both are named after the config
            for name, cli in (("train", cli_train), ("eval", cli_eval)):
                os.makedirs(Path(tmp) / name)
                os.chdir(Path(tmp) / name)
                scripts[name] = Path(tmp) / name / cli.main(
                    ["--cfg", str(grid), "--make_launcher", "bash"])["launcher"]
        finally:
            os.chdir(cwd)
        train_script, eval_script = scripts["train"], scripts["eval"]
        print(train_script.read_text().strip())
        parsed = subprocess.run(["bash", "-n", str(eval_script)], capture_output=True, text=True)
        check(parsed.returncode == 0, f"bash -n {eval_script.name}: {parsed.stderr}")
        # the launchers call `python`, as the JAX package's do: this interpreter
        (Path(tmp) / "bin").mkdir()
        (Path(tmp) / "bin" / "python").write_text(f'#!/bin/sh\nexec {sys.executable} "$@"\n')
        (Path(tmp) / "bin" / "python").chmod(0o755)
        env = dict(os.environ, PATH=f"{tmp}/bin:{os.environ.get('PATH', '')}")
        start = time.perf_counter()
        proc = subprocess.run(["bash", str(train_script)], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - start
    check(proc.returncode == 0, f"the train launcher failed:\n{proc.stdout[-3000:]}\n"
                                f"{proc.stderr[-3000:]}")
    made = sorted(set(runs.glob("*")) - before)
    try:
        print(f"train launcher: 2 runs in {seconds:.1f} s on {card}; logdirs "
              f"{[d.name for d in made]}")
        check(len(made) == 2 and {d.name.split("_")[3] for d in made} == {"ID00", "ID01"},
              f"the launcher's runs made the logdirs {made}")
        for d in made:
            check((d / "last.pt").exists() and (d / "last.trainer.json").exists(),
                  f"{d.name}: no last checkpoint")
            with open(d / "config_to_run.yaml") as f:
                lr = [line for line in f if line.strip().startswith("LR:")]
            print(f"  {d.name}: {sorted(p.name for p in d.glob('*.pt'))}, {lr[0].strip()}")
    finally:
        for d in made:
            shutil.rmtree(d, ignore_errors=True)
    print(f"phase 4m: {time.perf_counter() - phase_start:.3f} s")


# -- the tools (phase 4q) ------------------------------------------------------

TOOLS_EPOCHS = 11         # 4q's convergence budget (the tool's 150 cut; 20 before 4r joined the
#                           run, 12 before 4j (e)): the validation at epoch 9, an epoch past
#                           the freeze at 10
TOOLS_MPJPE_MM = 120.0    # the tool's own --mpjpe_thresh, held at epoch 9
TOOLS_STEPS = 10          # steps an epoch: 500 samples at configs/convergence.yaml's batch of 50
TOOLS_LOG_INTERVAL = 10   # the recipe's LOG_SAVE_INTERVAL: the steps metrics.jsonl logs
DECAY_TOL_MM = 1e-3       # a calibration-decay row's MPJPE against the trainer's validation
CAMERA_EPOCHS = 2         # cli.camera_bringup's --epochs (the tool's 40 cut)
CAMERA_EVAL_BATCHES = 2   # its evaluations: the 100 test samples at 50
IOU_TOL = 5e-5            # full_frame's mean IoU (rounded to 4 places) against its closed form
PROFILE_RUNS = (("infer", 128), ("train", 64))   # cli.profile_model's mode and batch
PROFILE_STEPS = 3
GATE_SMPL_VERTS = 512     # the golden gate's synthetic SMPL files (tests/test_golden.py's)
TOOLS_SKIN_SHAPES = ((50, 432), (32, 432), (16, 512), (8, 432), (4, 432), (2, 432), (1, 432))


def tool_cli(module: str, args: list[str], check_rc=(0,)) -> tuple[int, list[str]]:
    """`python -m poco_tpu_torch.cli.<module> args` from the repo root: its
    exit code and its standard output's lines (its errors pass through)."""
    proc = subprocess.run([sys.executable, "-m", f"poco_tpu_torch.cli.{module}", *args],
                          cwd=REPO, stdout=subprocess.PIPE, text=True)
    check(proc.returncode in check_rc, f"cli.{module} exited {proc.returncode}:\n"
                                       f"{proc.stdout[-3000:]}")
    return proc.returncode, proc.stdout.strip().splitlines()


def logged_steps(logdir: Path) -> tuple[list[dict], list[str]]:
    """The train-step records of metrics.jsonl, and the loss terms among
    them that are not finite."""
    with open(logdir / "metrics.jsonl") as f:
        steps = [rec for rec in map(json.loads, f) if "event" not in rec]
    bad = [f"epoch {rec['epoch']} step {rec['step']} {k}" for rec in steps
           for k, v in rec.items() if k.startswith("loss/") and not math.isfinite(v)]
    return steps, bad


def write_gate_smpl(path: Path) -> None:
    """Neutral, male and female synthetic SMPLs in the distribution layout,
    the three distinct (tests/test_golden.py:177-194)."""
    from poco_tpu_torch.constants import SMPL_PARENTS

    path.mkdir(parents=True, exist_ok=True)
    for gender, seed in (("NEUTRAL", 0), ("MALE", 1), ("FEMALE", 2)):
        p = synthetic_smpl_model(num_verts=GATE_SMPL_VERTS, seed=seed, device="cpu")
        np.savez(path / f"SMPL_{gender}.npz", v_template=p.v_template.numpy(),
                 shapedirs=p.shapedirs.numpy(), posedirs=p.posedirs.numpy(),
                 J_regressor=p.j_regressor.numpy(), weights=p.lbs_weights.numpy(),
                 kintree_table=np.stack([np.asarray(SMPL_PARENTS, np.int64),
                                         np.arange(24, dtype=np.int64)]),
                 f=p.faces.numpy())


def full_frame_iou(gts: list[np.ndarray], size: float) -> tuple[float, int]:
    """full_frame's mean IoU in closed form: its box is the frame's centred
    square of 0.95 x the longer side; a GT box inside it scores its area
    over the square's. Returns the mean and how many boxes lie inside."""
    boxes = np.concatenate([g for g in gts if len(g)]).astype(np.float64)
    side = 0.95 * size
    lo, hi = size / 2.0 - side / 2.0, size / 2.0 + side / 2.0
    g_lo, g_hi = boxes[:, :2] - boxes[:, 2:] / 2.0, boxes[:, :2] + boxes[:, 2:] / 2.0
    inter = np.prod(np.clip(np.minimum(g_hi, hi) - np.maximum(g_lo, lo), 0.0, None), axis=1)
    area = boxes[:, 2] * boxes[:, 3]
    inside = int(((g_lo >= lo) & (g_hi <= hi)).all(axis=1).sum())
    return float(np.mean(inter / (area + side * side - inter))), inside


def phase_tools(ctx: dict, card: str) -> dict[str, Counter]:
    """Phase 4q: the JAX package's training-science and gate tools on the
    port, at full width: (a) `cli.convergence_bench --which cliff` for
    TOOLS_EPOCHS epochs on a fresh `conv` set (val MPJPE at epoch 9 within
    the tool's 120 mm, the 3D joint loss falling across the freeze
    boundary, every logged loss term finite; the correlation recorded),
    and one epoch of the same
    recipe in this process through `cli.train.main` for the launches a
    step; (b) `cli.calibration_decay` over (a)'s run, each row's MPJPE the
    trainer's validation of that epoch; (c) `cli.camera_bringup` on (a)'s
    best model (every other parameter and BN statistic bit-identical, the
    backward kernel launched, the 2D error of the output below the
    input's); (d) `cli.detector_quality` on (a)'s test set with (c)'s
    checkpoint (full_frame's mean IoU its closed form); (e)
    `cli.golden_gate` on a reference-format checkpoint of phase 4's
    POCO-CLIFF, gendered synthetic SMPL files and the smoke set: on the
    card against its own CPU result within METERS_TOL, and failing with a
    reference 1 mm off; (f) `cli.profile_model --precision 32`, inference
    at 128 and a train step at 64, 3 steps each: the Chrome trace holds the
    skinning kernels (and the train step's TRAIN_STAGES ranges)."""
    import shutil
    import tempfile

    from poco_tpu_torch.cli import calibration_decay, camera_bringup, convergence_bench
    from poco_tpu_torch.cli import detector_quality, golden_gate, profile_model

    print(f"== 4q. the tools: convergence ({TOOLS_EPOCHS} epochs), calibration decay, camera "
          "bring-up, detector quality, golden gate, profile")
    phase_start = time.perf_counter()
    counts = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tools_"))
    try:
        data, work = tmp / "data", tmp / "work"
        conv_cfg = str(REPO / "configs" / "convergence.yaml")

        # (a) the convergence bench, in a process of its own as a user runs it
        start = time.perf_counter()
        rc, lines = tool_cli("convergence_bench", [
            "--which", "cliff", "--epochs", str(TOOLS_EPOCHS), "--root", str(data),
            "--work_dir", str(work), "--fresh"], check_rc=(0, 1))
        conv = json.loads(lines[-1])
        conv_s = time.perf_counter() - start
        print(f"convergence_bench: {lines[-1]}")
        logdir = Path(conv["logdir"])
        steps, bad = logged_steps(logdir)
        curve = {c["epoch"]: c["mpjpe"] for c in conv["curve"]}
        # the 3D joint loss, the term that drives MPJPE, before and after the
        # freeze boundary at epoch 10 (one logged step an epoch)
        k3d = [statistics.fmean(r["loss/loss_keypoints_3d"] for r in steps
                                if lo <= r["epoch"] < lo + 10) for lo in (0, 10)]
        print(f"convergence: {TOOLS_EPOCHS} epochs in {conv_s:.1f} s (data, training, two "
              f"evaluations), val MPJPE by epoch {curve} mm, uncert_pose_corr {conv['uncert_pose_corr']} (recorded, not gated at "
              f"{TOOLS_EPOCHS} epochs), the tool's pass {conv['pass']} (exit {rc}); the 3D joint "
              f"loss over epochs 0-9 {k3d[0]:.4f}, over 10-{TOOLS_EPOCHS - 1} {k3d[1]:.4f}; "
              f"{len(steps)} logged "
              f"steps, every loss term finite: {not bad} on {card}")
        check(rc == (0 if conv["pass"] else 1), f"convergence_bench exited {rc}, pass "
                                                f"{conv['pass']}")
        check(not bad, f"non-finite loss terms: {bad[:5]}")
        # LOG_SAVE_INTERVAL 10 in the recipe: one logged step an epoch
        check(len(steps) == TOOLS_EPOCHS * math.ceil(TOOLS_STEPS / TOOLS_LOG_INTERVAL),
              f"{len(steps)} logged steps")
        check(sorted(curve) == [9], f"validations at epochs {sorted(curve)}")
        check(curve[9] <= TOOLS_MPJPE_MM and conv["val_mpjpe_mm"] <= TOOLS_MPJPE_MM,
              f"val MPJPE {curve} mm, best model {conv['val_mpjpe_mm']}: past {TOOLS_MPJPE_MM}")
        check(k3d[1] < k3d[0], f"the 3D joint loss did not fall: {k3d}")

        # the same recipe for one epoch in this process: the launches a step
        reset_counts()
        cli_train.main(["--cfg", conv_cfg, "--data_dir", str(data), "--max_epochs", "1",
                        "--logdir", str(tmp / "counted")])
        counts["tools_convergence"] = read_counts("convergence epoch")
        print(f"convergence recipe, one epoch in-process: launches "
              f"{dict(counts['tools_convergence'])} over {TOOLS_STEPS} steps "
              f"({time.perf_counter() - phase_start:.1f} s into 4q)")
        check((counts["tools_convergence"]["skinning"],
               counts["tools_convergence"]["skinning_backward"])
              == tuple(TOOLS_STEPS * n for n in TRAIN_LAUNCHES), "convergence: launches a step")
        shutil.rmtree(tmp / "counted")

        # (b) calibration decay over (a)'s epoch checkpoints
        decay = calibration_decay.main(["--logdir", str(logdir), "--root", str(data)])
        with open(logdir / "val_accuracy.json") as f:
            val = {rec["epoch"]: rec["mpjpe"] for rec in json.load(f)}
        diffs = {}
        for row in decay["rows"]:
            with open(logdir / f"calibration_decay_{row['ckpt']}.json") as f:
                mpjpe = json.load(f)["summary"]["mpjpe"]
            diffs[row["ckpt"]] = abs(mpjpe - val[int(row["ckpt"].split("_")[1])])
        print(f"calibration_decay: rows {decay['rows']}, homogenization_confirmed "
              f"{decay['homogenization_confirmed']}; |cli.eval - the trainer's validation| "
              f"{diffs} mm (tolerance {DECAY_TOL_MM}; {time.perf_counter() - phase_start:.1f} s "
              "into 4q)")
        check([r["ckpt"] for r in decay["rows"]] == ["epoch_009"],
              f"calibration decay rows {decay['rows']}")
        check(max(diffs.values()) <= DECAY_TOL_MM, f"calibration decay vs validation {diffs}")

        # (c) camera bring-up on (a)'s best model, in this process
        reset_counts()
        start = time.perf_counter()
        cam = camera_bringup.main([
            "--ckpt", str(logdir), "--cfg", str(REPO / "configs" / "convergence_ft2d.yaml"),
            "--data_dir", str(data), "--epochs", str(CAMERA_EPOCHS)])
        cam_s = time.perf_counter() - start
        counts["tools_camera"] = read_counts("camera bring-up")
        base = torch.load(logdir / "best_model.pt", map_location="cpu", weights_only=False)
        tuned = torch.load(cam["out"], map_location="cpu", weights_only=False)["model"]
        changed = sorted(k for k in base["model"] if not torch.equal(base["model"][k], tuned[k]))
        cam_steps = CAMERA_EPOCHS * TOOLS_STEPS
        evals = 3 * CAMERA_EVAL_BATCHES * (1 + EVAL_LAUNCHES[False])
        print(f"camera_bringup: {json.dumps(cam)} in {cam_s:.1f} s; tensors that changed "
              f"{changed}; launches {dict(counts['tools_camera'])} ({cam_steps} steps of 2 + 1, "
              f"{evals} in its 3 evaluations) on {card}")
        check(set(changed) == {"head.deccam.weight", "head.deccam.bias"},
              f"camera bring-up changed {changed}")
        check(set(tuned) == set(base["model"]), "camera bring-up: another set of tensors")
        check(counts["tools_camera"]["skinning_backward"] == cam_steps
              and counts["tools_camera"]["skinning"] == 2 * cam_steps + evals,
              f"camera bring-up launches {dict(counts['tools_camera'])}")
        # the tool's output against its input: the zeroed decoder's mean
        # camera and the SGD steps after it (the steps alone move it by
        # hundredths of a pixel at the tool's lr of 1e-5: PERF.md §6 PR 13)
        check(cam["px2d_after"] < cam["px2d_raw_ckpt"],
              f"the 2D error did not fall: {cam['px2d_raw_ckpt']} -> {cam['px2d_after']} px")

        # (d) detector quality with (c)'s checkpoint on (a)'s test set
        reset_counts()
        gt_npz = data / "dataset_extras" / "conv_test.npz"
        start = time.perf_counter()
        dq = detector_quality.main(["--gt", str(gt_npz), "--img_root", str(data),
                                    "--cfg", conv_cfg, "--ckpt", cam["out"]])
        dq_s = time.perf_counter() - start
        counts["tools_detectors"] = read_counts("detector quality")
        _, gts = detector_quality.gt_boxes_from_npz(str(gt_npz))
        closed, inside = full_frame_iou(gts[:100], convergence_bench.IMG)
        got = dq["detectors"]["full_frame"]["mean_iou"]
        print(f"detector_quality: {json.dumps(dq)} in {dq_s:.1f} s; full_frame mean IoU {got} "
              f"against its closed form {closed:.6f} ({inside} of {sum(map(len, gts[:100]))} GT "
              f"boxes inside the frame's box); launches {dict(counts['tools_detectors'])}")
        check(abs(got - closed) <= IOU_TOL, f"full_frame mean IoU {got} != {closed}")
        check(dq["detectors"]["hog"] == dq["detectors"]["full_frame"], "hog is not full_frame")

        # (e) the golden gate: the card against its own CPU result
        gate_dir = tmp / "gate"
        write_gate_smpl(gate_dir / "smpl")
        ref_ckpt = gate_dir / "ref_poco_cliff.pt"
        torch.save({"model": {k: v.cpu() for k, v in ctx["model"].state_dict().items()}},
                   ref_ckpt)
        gate_args = ["--smpl_dir", str(gate_dir / "smpl"), "--torch_ckpt", str(ref_ckpt),
                     "--data_dir", str(REPO / "data"), "--dataset", "smoke",
                     "--cfg", str(REPO / "configs" / "poco_cliff.yaml")]
        cpu = golden_gate.main(gate_args + ["--device", "cpu", "--ref_mpjpe", "0"])
        reset_counts()
        gate = golden_gate.main(gate_args + ["--ref_mpjpe", str(cpu["mpjpe_port_mm"])])
        counts["tools_gate"] = read_counts("golden gate")
        # the CLI exits with 1 - pass (its exit code is held on the CPU,
        # tests/test_torch_tools.py)
        off = golden_gate.main(gate_args + ["--ref_mpjpe", str(cpu["mpjpe_port_mm"] + 1.0)])
        print(f"golden_gate: CPU {cpu['mpjpe_port_mm']} mm; card {json.dumps(gate)}; a reference "
              f"1 mm off: {json.dumps(off)}; launches {dict(counts['tools_gate'])} "
              f"on {card} ({time.perf_counter() - phase_start:.1f} s into 4q)")
        check(gate["pass"] and gate["delta_mm"] <= METERS_TOL * 1e3,
              f"golden gate: card {gate['mpjpe_port_mm']} vs CPU {cpu['mpjpe_port_mm']} mm")
        check(off["pass"] is False, "the golden gate passed a reference 1 mm off")
        check(counts["tools_gate"]["skinning"] == EVAL_LAUNCHES[False],
              f"golden gate launches {dict(counts['tools_gate'])}: one batch of 16")

        # (f) the profile of the inference and train steps
        for mode, batch in PROFILE_RUNS:
            reset_counts()
            start = time.perf_counter()
            path = profile_model.main(["--mode", mode, "--batch", str(batch), "--steps",
                                       str(PROFILE_STEPS), "--precision", "32",
                                       "--out", str(tmp / "profile")])
            seconds = time.perf_counter() - start
            key = f"tools_profile_{mode}"
            counts[key] = read_counts(f"profile {mode}")
            size = os.path.getsize(path)
            with open(path) as f:
                names = Counter(e.get("name", "") for e in json.load(f)["traceEvents"])
            kernels = {k: sum(n for name, n in names.items() if any(m in name for m in marks))
                       for k, marks in SKIN_KERNELS.items()}
            stages = {s: names[s] for s in TRAIN_STAGES}
            print(f"profile_model {mode} at {batch}: {seconds:.1f} s, trace "
                  f"{size / 2**20:.1f} MiB, skinning kernels {kernels}, ranges {stages}, "
                  f"launches {dict(counts[key])}")
            runs = PROFILE_STEPS + 1   # the warm-up outside the trace
            per_step = TRAIN_LAUNCHES if mode == "train" else (1, 0)
            check((counts[key]["skinning"], counts[key]["skinning_backward"])
                  == tuple(runs * n for n in per_step), f"profile {mode} launches")
            check(kernels["skinning"] >= PROFILE_STEPS * per_step[0]
                  and kernels["skinning_backward"] >= PROFILE_STEPS * per_step[1],
                  f"profile {mode}: the trace lacks the skinning kernels {kernels}")
            check(all(stages.values()) == (mode == "train"), f"profile {mode}: ranges {stages}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the kernel at this phase's shapes (the synthetic SMPL of the
    # convergence recipe has 432 vertices, the gate's files 512)
    for batch, num_verts in TOOLS_SKIN_SHAPES:
        args_ = skinning_inputs(batch, num_verts, seed=batch + num_verts)
        err = float((skinning(*args_) - skinning_reference(*args_)).abs().max())
        grads = skinning_backward(*args_, backward_grad(batch, num_verts, seed=batch))
        refs = skinning_backward_reference(*args_, backward_grad(batch, num_verts, seed=batch))
        bwd = max(float((g - r).abs().max() / (r.abs().max() * BACKWARD_RTOL + BACKWARD_ATOL))
                  for g, r in zip(grads, refs))
        print(f"skinning v2 B={batch} V={num_verts} (a 4q shape): max_abs_err {err:.3e} "
              f"(tolerance {SKIN_TOL}); skinning_backward at {bwd:.3f} of its tolerance")
        check(err <= SKIN_TOL and bwd <= 1.0, f"skinning disagrees at B={batch} V={num_verts}")
    print(f"phase 4q: {time.perf_counter() - phase_start:.3f} s")
    return counts


SMOKE_DIR = REPO / "data" / "dataset_folders" / "smoke"
THUMBS_NPZ = REPO / "tests" / "data" / "torch_smoke_thumbs.npz"
FULLHD_JPEG = REPO / "tests" / "data" / "torch_fullhd.jpg"
THUMB_SIZE = 16
THUMB_TOL = 2.0    # grey levels, a thumbnail pixel against cv2.imread's (IDCTs differ)
MEAN_TOL = 0.5     # grey levels, an image's channel mean against cv2.imread's
GET_BATCH_TOL = 1e-5  # crops of get_batch against the per-item path
LOADER_BATCH = 64  # the training batch


def smoke_thumbnails(read) -> dict:
    """Per smoke JPEG (sorted by name), read by `read(path)` as (H, W, 3)
    RGB uint8: its channel means and its THUMB_SIZE x THUMB_SIZE area-mean
    thumbnail, both float64. `tests/data/torch_smoke_thumbs.npz` holds
    them for `cv2.imread`, the thumbnails rounded to uint8."""
    names, means, thumbs = [], [], []
    for path in sorted(SMOKE_DIR.glob("*.jpg")):
        img = read(str(path)).astype(np.float64)
        h, w = img.shape[:2]
        names.append(path.name)
        means.append(img.mean(axis=(0, 1)))
        thumbs.append(img.reshape(THUMB_SIZE, h // THUMB_SIZE, THUMB_SIZE, w // THUMB_SIZE, 3)
                      .mean(axis=(1, 3)))
    return {"names": np.asarray(names), "means": np.stack(means), "thumbs": np.stack(thumbs)}


def host_cpu() -> str:
    """The host CPU's model (its /proc/cpuinfo name, vendor, family and
    model numbers) and core count."""
    fields = {}
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    model = (f"{fields.get('model name', 'unknown')} ({fields.get('vendor_id', '?')} family "
             f"{fields.get('cpu family', '?')} model {fields.get('model', '?')})")
    return f"{model}, {os.cpu_count()} cores ({len(os.sched_getaffinity(0))} usable)"


def check_report(label: str, report: dict) -> None:
    check(set(report) == {"summary", "splits", "per_joint"}, f"{label}: report keys {set(report)}")
    check(all(math.isfinite(v) for v in report["summary"].values()),
          f"{label}: summary not finite: {report['summary']}")
    print(f"{label}: summary {json.dumps(report['summary'])}; splits {sorted(report['splits'])}")


def logged_losses(logdir: str) -> list[dict]:
    with open(Path(logdir) / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if "step" in r and "loss/total_loss" in r]


def loader_crops(paths: list[str], seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded training-style warps (scale, rotation, flip, channel noise)
    of the middle of each image, for `batch_decode_affine`."""
    from poco_tpu_torch.data.transforms import sample_augment_params

    rng = np.random.RandomState(seed)
    affines, gains = [], []
    for path in paths:
        h, w = image_loader.image_size(path)
        aug = sample_augment_params(rng)
        affines.append(affine_output_to_source(np.array([w / 2, h / 2], np.float32),
                                               0.6 * min(h, w) * aug.scale, 224, aug.rot,
                                               aug.flip))
        gains.append(aug.pixel_noise)
    return np.stack(affines), np.stack(gains)


def loader_throughput(label: str, paths: list[str], card: str, reps: int = 10) -> float:
    """batch_decode_affine of `paths` (one batch) with its default threads,
    2 warm-up and `reps` timed calls; returns the median seconds."""
    affines, gains = loader_crops(paths, seed=len(paths))
    for _ in range(2):
        image_loader.batch_decode_affine(paths, affines, gains)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        image_loader.batch_decode_affine(paths, affines, gains)
        ts.append(time.perf_counter() - t0)
    med = statistics.median(ts)
    n = len(paths)
    print(f"loader batch_decode_affine, batch {n}, {label}, route {image_loader.route()}: median "
          f"{med * 1e3:.3f} ms (min {min(ts) * 1e3:.3f}, max {max(ts) * 1e3:.3f}) = "
          f"{n / med:.1f} crops/s, {med / n * 1e3:.3f} ms a crop; host {host_cpu()}; card {card}")
    return med


@contextlib.contextmanager
def loader_beside(paths: list[str], num_threads: int = 0):
    """A thread decoding and warping batches of `paths` (on `num_threads`
    loader threads, 0: one a core) without pause for as long as the
    context lasts; yields a dict whose "crops" and "seconds" it fills when
    the context ends."""
    import threading

    affines, gains = loader_crops(paths, seed=1)
    stop, stats, errors = threading.Event(), {"crops": 0, "seconds": 0.0}, []

    def run():
        start = time.perf_counter()
        try:
            while not stop.is_set():
                image_loader.batch_decode_affine(paths, affines, gains, num_threads=num_threads)
                stats["crops"] += len(paths)
        except Exception as e:  # raised in the main thread below
            errors.append(e)
        stats["seconds"] = time.perf_counter() - start

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        yield stats
    finally:
        stop.set()
        thread.join(timeout=120)
    check(not thread.is_alive(), "the loader thread did not stop")
    if errors:
        raise errors[0]


def phase_images(ctx: dict, train: dict, seed: int, card: str) -> dict:
    """Phase 4g: the loader, the smoke JPEGs through the dataset, the two
    CLIs and a full-width fit over them, and the loader's throughput on
    the card's host. Returns each main-path run's launches, and the
    POCO-CLIFF step with the loader beside it for the profile."""
    import tempfile

    print("== 4g. real images: the loader, the smoke JPEGs, the CLIs")
    route = image_loader.route()
    print(f"loader route={route} png={image_loader.png_available()}")

    # 1. the 48 smoke JPEGs against cv2.imread's thumbnails on a host with OpenCV
    ref = np.load(THUMBS_NPZ)
    got = smoke_thumbnails(image_loader.decode_image)
    check(got["names"].tolist() == ref["names"].tolist(),
          f"smoke JPEGs {got['names'].tolist()} are not the fixture's")
    thumb_err = float(np.abs(got["thumbs"] - ref["thumbs"]).max())
    mean_err = float(np.abs(got["means"] - ref["means"]).max())
    print(f"{len(got['names'])} smoke JPEGs decoded ({route}): {THUMB_SIZE}x{THUMB_SIZE} "
          f"thumbnails within {thumb_err:.3f} grey levels of cv2.imread's (tolerance "
          f"{THUMB_TOL}), channel means within {mean_err:.4f} (tolerance {MEAN_TOL})")
    check(thumb_err <= THUMB_TOL and mean_err <= MEAN_TOL, "smoke JPEGs disagree with cv2's")

    # 2. get_batch against the per-item path, augmentation on
    npz = REPO / "data" / "dataset_extras" / "smoke_train.npz"
    data_dir = str(REPO / "data")

    def smoke_set(**kwargs):
        return PocoDataset(str(npz), img_dir=data_dir, is_train=True, seed=seed + 41, **kwargs)

    rows = list(range(len(smoke_set())))
    whole = smoke_set().get_batch(rows)
    per_item_set = smoke_set()
    items = collate([per_item_set[i] for i in rows])
    crop_err = float(np.abs(whole["img"] - items["img"]).max())
    check(crop_err <= GET_BATCH_TOL, f"get_batch crops differ from the per-item path by {crop_err}")
    for key, value in items.items():
        if key != "img":
            check(np.array_equal(np.asarray(whole[key]), np.asarray(value)),
                  f"get_batch {key} differs from the per-item path")
    print(f"get_batch of {len(rows)} augmented smoke_train rows equals the per-item path: crops "
          f"within {crop_err:.2e} (tolerance {GET_BATCH_TOL}), {len(items) - 1} other keys "
          f"exact; rotated {int((items['rot_angle'] != 0).sum())}, flipped "
          f"{int(items['is_flipped'].sum())}")

    # 3. synthetic occlusion changes pixels only under the pasted occluders
    options = {"USE_SYNTHETIC_OCCLUSION": True}
    occluded_set = smoke_set(options=options, occluders=occlusion.synthetic_occluders(seed=seed))
    footprints = []
    paste = occlusion.paste_over

    def recording_paste(src, dst, center):
        probe = np.zeros(dst.shape, np.float32)
        white = src.copy()
        white[..., :3] = 255
        paste(white, probe, center)
        footprints[-1] |= probe.any(axis=-1)
        paste(src, dst, center)

    occlude = occluded_set._occlude

    def recording_occlude(crop, kp2d, scale):
        footprints.append(np.zeros(crop.shape[:2], bool))
        return occlude(crop, kp2d, scale)

    occlusion.paste_over = recording_paste
    occluded_set._occlude = recording_occlude
    try:
        occluded = occluded_set.get_batch(rows)
    finally:
        occlusion.paste_over = paste
    changed = (occluded["img"] != whole["img"]).any(axis=-1)
    check(len(footprints) == len(rows), f"occlusion ran on {len(footprints)} of {len(rows)} rows")
    outside = int((changed & ~np.stack(footprints)).sum())
    check(outside == 0, f"occlusion changed {outside} pixels outside the occluders")
    check(changed.any(), "occlusion changed no pixel")
    for key, value in whole.items():
        if key != "img":
            check(np.array_equal(np.asarray(occluded[key]), np.asarray(value)),
                  f"occlusion changed {key}")
    print(f"synthetic occlusion: {int(changed.sum())} pixels changed in {int(changed.any((1, 2)).sum())}"
          f" of {len(rows)} crops, all under the occluders ({int(np.stack(footprints).sum())} "
          f"pixels); every other key unchanged")

    counts = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_images_") as tmp:
        # 4. the CLIs at tiny width over the smoke JPEGs
        tiny = str(REPO / "configs" / "tiny_smoke.yaml")
        logdir = str(Path(tmp) / "tiny")
        reset_counts()
        cli_train.main(["--cfg", tiny, "--logdir", logdir, "--max_epochs", "1",
                        "--data_dir", data_dir])
        counts["cli_train"] = read_counts("cli.train tiny_smoke")
        losses = logged_losses(logdir)
        steps = len(losses)
        check(steps > 0 and all(math.isfinite(v) for r in losses for k, v in r.items()
                                if k.startswith("loss/")), f"cli.train: losses {losses}")
        n_val = math.ceil(16 / 4) * EVAL_LAUNCHES[False]
        print(f"cli.train tiny_smoke: {steps} steps, total loss "
              f"{[round(r['loss/total_loss'], 4) for r in losses]}; launches "
              f"{dict(counts['cli_train'])}")
        check(counts["cli_train"]["skinning_backward"] == steps
              and counts["cli_train"]["skinning"] == 2 * steps + n_val,
              "cli.train: each step must launch skinning 2 and skinning_backward 1 times, "
              "each validation batch skinning 5")
        reset_counts()
        report = cli_eval.main(["--cfg", tiny, "--ckpt", logdir, "--dataset", "smoke",
                                "--data_dir", data_dir, "--out", str(Path(tmp) / "tiny.json")])
        counts["cli_eval"] = read_counts("cli.eval tiny_smoke")
        check_report("cli.eval tiny_smoke", report)
        check(counts["cli_eval"]["skinning"] == EVAL_LAUNCHES[False],
              f"cli.eval tiny_smoke: launches {dict(counts['cli_eval'])}")

        # 5. full width: cli.eval of POCO-CLIFF, and Trainer.fit on smoke_train
        cliff = str(REPO / "configs" / "poco_cliff.yaml")
        reset_counts()
        report = cli_eval.main(["--cfg", cliff, "--dataset", "smoke", "--data_dir", data_dir,
                                "--batch_size", "8", "--out", str(Path(tmp) / "cliff.json")])
        counts["cli_eval_cliff"] = read_counts("cli.eval POCO-CLIFF")
        check_report("cli.eval POCO-CLIFF, batch 8", report)
        check(counts["cli_eval_cliff"]["skinning"] == 2 * EVAL_LAUNCHES[False],
              f"cli.eval POCO-CLIFF: launches {dict(counts['cli_eval_cliff'])}")

        from poco_tpu_torch.train.trainer import Trainer

        hparams = train_hparams(str(Path(tmp) / "cliff"))
        hparams.DATASET.DATA_DIR = data_dir
        hparams.DATASET.TRAIN_DS = "all"
        hparams.DATASET.DATASETS_AND_RATIOS = "smoke_1.0"
        hparams.DATASET.VAL_DS = "smoke"
        hparams.DATASET.BATCH_SIZE = 16
        hparams.TRAINING.MAX_EPOCHS = 2
        train_fn, val = cli_train.build_datasets(hparams)
        trainer = Trainer(hparams, ctx["smpl"], train_dataset_fn=train_fn, val_dataset=val,
                          device="cuda")
        trainer.model.load_state_dict(ctx["model"].state_dict())
        steps, fit_losses = [], []
        counted_steps(trainer, steps, fit_losses)
        reset_counts()
        start = time.perf_counter()
        summary = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - start
        counts["fit_cliff"] = read_counts("Trainer.fit POCO-CLIFF smoke")
        trainer.close()
        del trainer
        print(f"Trainer.fit POCO-CLIFF on smoke_train, batch 16, 2 epochs: {len(steps)} steps and"
              f" validation in {fit_s:.3f} s; total loss "
              f"{[round(t['loss/total_loss'], 4) for t in fit_losses]}; launches "
              f"{dict(counts['fit_cliff'])}; validation {json.dumps(summary)}")
        check(len(steps) == 2 and all(c == TRAIN_LAUNCHES for c in steps),
              f"Trainer.fit smoke: per-step launches {steps}")
        check(counts["fit_cliff"]["skinning"] == 2 * TRAIN_LAUNCHES[0] + 2 * EVAL_LAUNCHES[False],
              "Trainer.fit smoke: validation must launch skinning 5 times a batch")
        check(all(math.isfinite(v) for t in fit_losses for v in t.values()), "fit: loss")
        check(all(math.isfinite(v) for v in summary.values()), f"fit validation: {summary}")
    torch.cuda.empty_cache()

    # 6. the loader's throughput on this host, and beside the train step
    smoke_paths = sorted(str(p) for p in SMOKE_DIR.glob("*.jpg"))
    smoke_batch = (smoke_paths * 2)[:LOADER_BATCH]
    fullhd = [str(FULLHD_JPEG)] * LOADER_BATCH
    h, w = image_loader.image_size(str(FULLHD_JPEG))
    check((h, w) == (1080, 1920), f"{FULLHD_JPEG} is {h}x{w}")
    loader_throughput("smoke JPEGs 256x256", smoke_batch, card)
    fullhd_s = loader_throughput("one 1920x1080 JPEG", fullhd, card)
    print(f"beside it: the POCO-CLIFF train step at batch 64 takes "
          f"{train['step_crops_per_s']:.1f} crops/s (phase 4f)")
    run_step = train["run_step"]
    half = max(1, len(os.sched_getaffinity(0)) // 2)
    threads = {"alone": None, "loader": 0, f"loader on {half} threads": half}
    times = {turn: [] for turn in threads}
    loaded = {turn: [] for turn in threads}
    for turn in (*threads, *reversed(threads)):
        with contextlib.ExitStack() as stack:
            if threads[turn] is not None:
                loaded[turn].append(stack.enter_context(loader_beside(fullhd, threads[turn])))
            for i in range(8):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_step()
                torch.cuda.synchronize()
                if i >= 3:
                    times[turn].append(time.perf_counter() - t0)
    for turn, ts in times.items():
        med = statistics.median(ts)
        beside = ("" if threads[turn] is None else
                  f", full-HD batches decoding beside it at "
                  f"{sum(s['crops'] for s in loaded[turn]) / sum(s['seconds'] for s in loaded[turn]):.1f}"
                  f" crops/s ({LOADER_BATCH / fullhd_s:.1f} alone; keeps up with the step: "
                  f"{sum(s['crops'] for s in loaded[turn]) / sum(s['seconds'] for s in loaded[turn]) >= 64 / med})")
        print(f"train step fp32, batch 64, POCO-CLIFF, {turn}, {len(ts)} steps in turns: median "
              f"{med * 1e3:.3f} ms (min {min(ts) * 1e3:.3f}, max {max(ts) * 1e3:.3f}) = "
              f"{64 / med:.1f} crops/s{beside}; on {card}, host {host_cpu()}")
    counts["fit_fullhd"] = fit_on_fullhd(ctx, train, seed, card)
    return {"counts": counts, "fullhd": fullhd}


FULLHD_FIT_STEPS = 20


def fit_on_fullhd(ctx: dict, train: dict, seed: int, card: str) -> Counter:
    """Training crops/s with the loader in the loop: `Trainer.fit` of
    POCO-CLIFF (configs/poco_cliff.yaml, batch 64, phase 4's weights) for
    FULLHD_FIT_STEPS steps over augmented crops of the 1920x1080 JPEG
    (seeded boxes, GT pose and 2D keypoints), read by the trainer's
    DataLoader through `get_batch`: the trainer's own crops/s (its first
    batch's decode included) beside the step's on a device-side batch.
    Returns the run's launches."""
    import tempfile

    from poco_tpu_torch.train.trainer import Trainer

    n = FULLHD_FIT_STEPS * LOADER_BATCH
    rng = np.random.RandomState(seed + 51)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fullhd_") as tmp:
        center = np.stack([rng.uniform(660, 1260, n), rng.uniform(390, 690, n)], 1)
        part = np.concatenate([center[:, None] + rng.uniform(-150, 150, (n, 24, 2)),
                               np.ones((n, 24, 1))], axis=2)
        np.savez(Path(tmp) / "fullhd_train.npz", imgname=np.array([FULLHD_JPEG.name] * n),
                 center=center.astype(np.float32), scale=rng.uniform(2.0, 4.0, n).astype(np.float32),
                 pose=rng.uniform(-0.3, 0.3, (n, 72)).astype(np.float32),
                 shape=rng.uniform(-0.5, 0.5, (n, 10)).astype(np.float32),
                 part=part.astype(np.float32))
        data = PocoDataset(str(Path(tmp) / "fullhd_train.npz"), img_dir=str(FULLHD_JPEG.parent),
                           dataset_name="fullhd", is_train=True, seed=seed)
        hparams = train_hparams(str(Path(tmp) / "run"))
        trainer = Trainer(hparams, ctx["smpl"], train_dataset_fn=lambda epoch: data,
                          device="cuda")
        trainer.model.load_state_dict(ctx["model"].state_dict())
        steps, losses = [], []
        counted_steps(trainer, steps, losses)
        reset_counts()
        trainer.fit()
        counts = read_counts("Trainer.fit POCO-CLIFF over full-HD JPEGs")
        trainer.close()
        with open(Path(tmp) / "run" / "metrics.jsonl") as f:
            epoch = [r for r in map(json.loads, f) if r.get("event") == "epoch_end"][-1]
    check(len(steps) == FULLHD_FIT_STEPS and all(c == TRAIN_LAUNCHES for c in steps),
          f"Trainer.fit over full-HD JPEGs: per-step launches {steps}")
    check(all(math.isfinite(v) for t in losses for v in t.values()), "full-HD fit: loss")
    print(f"Trainer.fit POCO-CLIFF over augmented crops of the 1920x1080 JPEG, batch 64, "
          f"{len(steps)} steps: the trainer's crops/s {epoch['crops_per_sec']:.1f} (the loader "
          f"in the loop, its first batch included; the step alone on a device-side batch "
          f"{train['step_crops_per_s']:.1f}); launches {dict(counts)}; on {card}, host "
          f"{host_cpu()}")
    return counts


SERVE_BUCKETS = (1, 8, 32, 128)
DP_REPLICAS = ["cuda:0", "cuda:0"]   # 4r (d): two replicas named on the one card
DP_BUCKETS = (2, 8, 32, 128)
# The artifacts of 4h and 4r other than 4h's own, from phase 4's POCO-CLIFF:
# each is exported by a process of its own (`--export-job`), all of them
# beside 4h's export (an export is ~40 s of single-threaded tracing; one
# after another they took ~200 s of the time limit)
EXPORT_JOBS = {
    "compact": dict(batch_sizes=(8,), uint8_input=True, compact=True, device="cuda"),
    "bf16": dict(batch_sizes=SERVE_BUCKETS, uint8_input=True, device="cuda", dtype="bf16"),
    "dp2": dict(batch_sizes=DP_BUCKETS, uint8_input=True, device="cuda",
                data_parallel=len(DP_REPLICAS)),
    "cpu": dict(batch_sizes=SERVE_BUCKETS, uint8_input=True, device="cpu",
                platforms=("cpu", "cuda")),
}


def start_exports(model, smpl, tmp: str) -> dict[str, subprocess.Popen]:
    """Write the weights once and start one `--export-job` process an
    entry of EXPORT_JOBS, each exporting into `tmp`/<name>."""
    torch.save({"model": model.state_dict(), "smpl": smpl.to("cpu")}, f"{tmp}/weights.pt")
    return {name: subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--export-job", name, "--dist-dir", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in EXPORT_JOBS}


def finish_exports(procs: dict[str, subprocess.Popen]) -> dict[str, float]:
    """Wait for every export process; each must exit 0. Returns each
    export's seconds (taken beside the others)."""
    seconds, failed = {}, []
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=DIST_TIMEOUT)
        found = [ln for ln in out.splitlines() if ln.startswith(f"export {name}: ")]
        if proc.returncode != 0 or not found:
            failed.append(name)
            print(f"export job {name} (exit {proc.returncode}):\n{out[-3000:]}")
        else:
            seconds[name] = float(found[-1].split()[2])
    check(not failed, f"export jobs failed: {failed}")
    return seconds


def export_job(name: str, tmp: Path) -> int:
    """One entry of EXPORT_JOBS: phase 4's POCO-CLIFF rebuilt from the
    weights `start_exports` wrote, exported into `tmp`/<name>."""
    spec = EXPORT_JOBS[name]
    blob = torch.load(tmp / "weights.pt", weights_only=False)   # written by this run
    cfg = model_config_from_hparams(update_hparams(str(REPO / "configs/poco_cliff.yaml")))
    model = build_poco_cliff(device=spec["device"], **dataclasses.asdict(cfg))
    model.load_state_dict(blob["model"])
    start = time.perf_counter()
    export_poco(model, blob["smpl"].to(spec["device"]), str(tmp / name), **spec)
    print(f"export {name}: {time.perf_counter() - start:.2f} s", flush=True)
    return 0
SERVE_HELD = SERVE_BUCKETS        # crops held against eager, each a bucket (no padding)
# (clients, crops a request, requests a client): the HTTP combos, each with
# at least 50 timed requests (100 before 4r joined the run: the time limit);
# the p99 of 50 lies between the two largest, so it reads the worst requests
SERVE_COMBOS = ((1, 1, 50), (8, 1, 7), (1, 8, 50), (64, 1, 4), (1, 128, 50))
SERVE_METERS_TOL = 1e-6   # joints3d / vertices, exported program vs eager, m
SERVE_HEAD_TOL = 1e-5     # every other output, absolute and relative (pixels near 1e3)
COMPACT_TOL = 1e-3        # fp16 vertices of a compact artifact vs fp32, m (export.py:46-49)


def served_diffs(got: dict, want: dict) -> tuple[dict[str, float], list[str]]:
    """The largest difference per key of `got` against `want`, and the keys
    beyond SERVE_METERS_TOL / SERVE_HEAD_TOL."""
    diffs = {k: float(np.abs(got[k].astype(np.float64) - want[k]).max()) for k in want}
    bad = [k for k in want
           if (diffs[k] > SERVE_METERS_TOL if k in ("smpl_vertices", "smpl_joints3d")
               else not np.allclose(got[k], want[k], atol=SERVE_HEAD_TOL, rtol=SERVE_HEAD_TOL))]
    return diffs, bad


def served_vs(label: str, got: dict, want: dict) -> None:
    """Every output of `got` against `want`: the largest difference per
    key printed, then held to SERVE_METERS_TOL / SERVE_HEAD_TOL."""
    check(sorted(got) == sorted(want), f"{label}: keys {sorted(got)} != {sorted(want)}")
    diffs, bad = served_diffs(got, want)
    print(f"{label}: largest difference by key {diffs}")
    check(not bad, f"{label}: {bad} differ by {[diffs[k] for k in bad]}")


def served_batch(ctx: dict, n: int) -> dict[str, np.ndarray]:
    """`n` uint8 crops from the phase's rng, with the CLIFF conditioning
    of `n` random boxes on the phase-4 image."""
    rng, (h, w) = ctx["rng"], ctx["image"].shape[:2]
    centers, scales = random_boxes(rng, n, h, w)
    cond = request_crops(ctx["image"], centers, scales)
    batch = {k: np.ascontiguousarray(v.cpu().numpy()) for k, v in cond.items() if k != "img"}
    batch["img"] = rng.randint(0, 256, (n, 224, 224, 3)).astype(np.uint8)
    return batch


def bucket_refs(served, crops: np.ndarray, buckets) -> dict[int, dict[str, np.ndarray]]:
    """`served.predict` of every row of `crops` (uint8, with a request's
    defaults for the other keys) in a program call of exactly `b` rows, for
    each bucket `b`: the rows cut into groups of `b`, the last group filled
    up with rows from the start."""
    batch = prepare_request_batch(served, {"img": crops})
    m, refs = len(crops), {}
    for b in buckets:
        outs = []
        for start in range(0, m, b):
            out = served.predict({k: v[np.arange(start, start + b) % m] for k, v in batch.items()})
            outs.append({k: v[:min(b, m - start)] for k, v in out.items()})
        refs[b] = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    return refs


def check_served_pairs(served, clients: int, crops: int, pairs, num_verts: int) -> None:
    """Every response of an HTTP combo: its keys, shapes and finiteness,
    then its rows against `predict` on the request's own crops at each
    bucket a wave of the combo can run at (one request up to one from
    every client). A response must match at one of them: a row scattered
    to the wrong client, or a wrong program at a bucket, matches at none."""
    largest = served.batch_sizes[-1]
    buckets = sorted({served.buckets_for(k * crops)[0] for k in range(1, clients + 1)
                      if k * crops <= largest})
    label = f"served {clients}x{crops} over HTTP vs predict"
    requests = list(dict.fromkeys(req for req, _ in pairs))
    crops_of = [np.load(io.BytesIO(req))["img"] for req in requests]
    refs = bucket_refs(served, np.concatenate(crops_of), buckets)
    offsets = np.cumsum([0] + [len(c) for c in crops_of])
    index = {req: i for i, req in enumerate(requests)}
    distinct = {}
    for req, resp in pairs:
        distinct.setdefault((index[req], hashlib.sha256(resp).digest()), resp)
    matched, worst = Counter(), {}
    for (i, _), resp in distinct.items():
        out, n = dict(np.load(io.BytesIO(resp))), len(crops_of[i])
        check(sorted(out) == served.meta["output_keys"], f"{label}: keys {sorted(out)}")
        for key, shape in {"pred_pose": (n, 24, 3, 3), "smpl_vertices": (n, num_verts, 3),
                           "smpl_joints3d": (n, 49, 3), "var_pose": (n, 24)}.items():
            check(out[key].shape == shape, f"{label}: {key} {out[key].shape}")
        check(all(np.isfinite(v).all() for v in out.values()), f"{label}: not finite")
        tried = {}
        for b in buckets:
            want = {k: v[offsets[i]:offsets[i + 1]] for k, v in refs[b].items()}
            diffs, bad = served_diffs(out, want)
            tried[b] = (max(diffs.values()), bad, diffs)
        fits = [b for b in buckets if not tried[b][1]]
        check(bool(fits), f"{label}: request {i}'s response matches predict at no bucket: "
                          f"{ {b: (t[0], t[1]) for b, t in tried.items()} }")
        best = min(fits, key=lambda b: tried[b][0])
        matched[best] += 1
        for k, d in tried[best][2].items():
            worst[k] = max(worst.get(k, 0.0), d)
    print(f"{label}: {len(pairs)} responses ({len(distinct)} distinct) to {len(requests)} "
          f"clients' crops, held at buckets {buckets}; matched at {dict(matched)}; largest "
          f"difference by key {worst}")


def phase_serving(ctx: dict, card: str) -> Counter:
    """Phase 4h: POCO-CLIFF (phase 4's weights) exported on the card with
    uint8 input and buckets SERVE_BUCKETS, loaded, held against eager
    `model(batch, smpl)` at every bucket, profiled at 1 and 32 crops,
    served over loopback HTTP at SERVE_COMBOS with every response held to
    `predict`, and a compact artifact against the fp32 one. Returns the
    launches of the served runs (one `skinning` a bucket dispatch)."""
    import tempfile

    print("== 4h. serving: export, load, HTTP on loopback")
    model, smpl = ctx["model"], ctx["smpl"]
    device, num_verts = smpl.v_template.device, smpl.v_template.shape[0]
    counts = Counter()
    # the artifact, its loaded program and the held batches stay for 4r,
    # which removes the directory
    ctx["serve_tmp"] = tempfile.TemporaryDirectory(prefix="chip_smoke_serve_")
    with contextlib.nullcontext(ctx["serve_tmp"].name) as tmp:
        art = f"{tmp}/cliff_u8"
        jobs = start_exports(model, smpl, tmp)
        start = time.perf_counter()
        export_poco(model, smpl, art, batch_sizes=SERVE_BUCKETS, uint8_input=True, device=device)
        export_s = time.perf_counter() - start
        job_s = finish_exports(jobs)
        print(f"exports of 4h and 4r in processes of their own, beside this one (seconds each, "
              f"taken side by side): {job_s}; all done {time.perf_counter() - start:.2f} s "
              f"after this one began")
        size = sum(p.stat().st_size for p in Path(art).iterdir())
        print(f"export: {export_s:.2f} s, artifact {size / 1e6:.1f} MB "
              f"({sorted(p.name for p in Path(art).iterdir())}), buckets {SERVE_BUCKETS}")
        served = load_exported(art, device=device)
        served.warmup()
        print(f"load: {served.load_seconds:.2f} s (one program for every bucket); warm-up by "
              f"bucket: { {b: round(t, 3) for b, t in served.warmup_seconds.items()} } s")

        # the exported program against eager on the same crops
        held = {n: served_batch(ctx, n) for n in SERVE_HELD}
        for n, batch in held.items():
            tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            tb["img"] = normalize_image(tb["img"].float())
            with torch.inference_mode():
                want = {k: v.cpu().numpy() for k, v in model(tb, smpl).items() if v is not None}
            reset_counts()
            got = served.predict(batch)
            torch.cuda.synchronize()
            run = read_counts(f"serving predict {n}")
            check(run["skinning"] == len(served.buckets_for(n)),
                  f"serving: {run['skinning']} skinning launches for {n} crops")
            counts.update(run)
            served_vs(f"exported vs eager, {n} crops", got, want)
        print(f"exported predict launches (one a bucket dispatch): {dict(counts)}")
        for n in (1, 128):
            ts = timed_requests(lambda: served.predict(held[n]), reps=10)
            print_times("ExportedPoco.predict in-process, uint8 crops", n, ts, card)
        # a 1-crop wave and a 32-crop wave (what 64 one-crop clients coalesce
        # into): how much of the call the card is busy
        for n in (1, 32):
            profile_request(f"ExportedPoco.predict, {n} uint8 crops",
                            lambda: served.predict(held[n]), card)

        # HTTP on loopback, every combo's launches counted on their own
        server = PocoServer(served, port=0, batch_window_ms=5.0).start(warmup=False)
        base = f"http://127.0.0.1:{server.port}"
        try:
            for clients, crops, reqs in SERVE_COMBOS:
                pairs = []
                reset_counts()
                dispatch0 = server.batcher.dispatch_count
                row = bench_serving.run_combo(base, server.batcher, clients, crops, reqs,
                                              check=pairs.extend)
                torch.cuda.synchronize()
                run = read_counts(f"serving http {clients}x{crops}")
                dispatches = server.batcher.dispatch_count - dispatch0
                print(f"serving {clients}x{crops}: " + json.dumps({"card": card, **row}))
                print(f"serving {clients}x{crops}: launches {dict(run)} over {dispatches} "
                      f"dispatches, the settling request's included")
                check(run["skinning"] == dispatches,
                      "serving: skinning must launch once per dispatch (each wave <= 128 rows)")
                counts.update(run)
                check_served_pairs(served, clients, crops, pairs, num_verts)
        finally:
            server.stop()

        # a compact artifact: fp16 vertices within 1 mm of the fp32 ones
        compact = f"{tmp}/compact"
        reset_counts()
        small = load_exported(compact, device=device).predict(held[8])
        counts.update(read_counts("serving compact"))
        full = served.predict(held[8])
        dist = float(np.linalg.norm(small["smpl_vertices"].astype(np.float32)
                                    - full["smpl_vertices"], axis=-1).max())
        print(f"compact: smpl_vertices {small['smpl_vertices'].dtype}, largest distance to "
              f"fp32 {dist:.3e} m (tolerance {COMPACT_TOL})")
        check(small["smpl_vertices"].dtype == np.float16 and dist <= COMPACT_TOL,
              f"compact vertices {dist} m from the fp32 artifact's")
        ctx.update(serve_artifact=art, served=served, serve_held=held, export_seconds=job_s)
    return counts


# -- precision and artifacts (phase 4r) ----------------------------------------

BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -8   # one bf16 step (tests/test_torch_precision.py)
BF16_SHARE = 0.5          # of the CPU's own bf16-to-fp32 distance, on a float32 output
BF16_SPREAD = 2.0         # of the card's own bf16 spread (cuDNN against the native convolutions)
# a key's fp32 tolerance, card against CPU (tests/test_torch_model.py:SLICE_TOLERANCES, the
# PARE segmentation logits of tests/test_torch_pare.py)
BF16_KEY_TOLS = {
    "pred_pose": 2e-3, "pred_pose_6d": 2e-3, "pred_cam": 2e-3, "pred_shape": 2e-3,
    "var_pose": 2e-3, "body_feat2": 2e-3, "uncert_feat": 5e-3, "pred_cam_t": 2e-3,
    "pred_fullimg_cam_t": 2e-3, "smpl_vertices": 1e-4, "smpl_joints3d": 1e-4,
    "smpl_joints2d": 1e-2, "pred_segm_mask": 2e-3,
}
# the camera translations, functions of `pred_cam` that multiply its rounding by t_z / s
# (~80 at the smoke's boxes): held to the same function of the card's own `pred_cam` in
# float64, within this share of it (bf16: the camera maths' two roundings; fp32: ~10 ulps)
BF16_DERIVED_RTOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-6}
BF16_ARTIFACT_SHARE = 0.1  # bf16 artifact vs eager bf16 where cuDNN picks other algorithms:
#                            this share of the eager bf16 output's distance from fp32
DP_HELD = (8, 32, 128)
JAX_DP_POSE = (2e-5, 1e-5)  # rtol, atol: pred_pose, tests/test_export.py:174-179
JAX_DP_VERTS = 1e-5         # vertices atol, the same
OVERLOAD = ["--overload-clients", "64", "--overload-crops", "8", "--overload-duration", "2",
            "--overload-floods", "2", "--max-pending-rows", "32"]


def jax_dp_bars(label: str, got: dict, want: dict) -> None:
    """The JAX package's bars for an artifact against another
    (tests/test_export.py:174-179), with the largest differences printed."""
    check(sorted(got) == sorted(want), f"{label}: keys {sorted(got)} != {sorted(want)}")
    pose = float(np.abs(got["pred_pose"] - want["pred_pose"]).max())
    verts = float(np.abs(got["smpl_vertices"] - want["smpl_vertices"]).max())
    print(f"{label}: pred_pose {pose:.3e}, smpl_vertices {verts:.3e} m")
    check(np.allclose(got["pred_pose"], want["pred_pose"], rtol=JAX_DP_POSE[0],
                      atol=JAX_DP_POSE[1]), f"{label}: pred_pose off by {pose}")
    check(verts <= JAX_DP_VERTS, f"{label}: vertices off by {verts} m")


def bf16_forward(model, smpl, batch: dict, dtype) -> dict:
    with torch.inference_mode(), compute_precision(batch["img"].device.type, dtype):
        return {k: v for k, v in model(batch, smpl).items() if v is not None}


def derived_translations(out: dict, batch: dict) -> dict[str, torch.Tensor]:
    """The camera translations of `out` computed again in float64 from its
    own `pred_cam` and the batch, as `smpl.model`'s heads compute them."""
    cam = out["pred_cam"].double().cpu()
    got = {"pred_cam_t": weak_perspective_to_perspective(cam, FOCAL_LENGTH, IMG_RES)}
    if "pred_fullimg_cam_t" in out:
        b = {k: batch[k].double().cpu() for k in ("scale", "center", "orig_shape", "focal_length")}
        got["pred_fullimg_cam_t"] = crop_cam_to_full_img_cam(
            crop_cam=cam, bbox_height=b["scale"] * 200.0, bbox_center=b["center"],
            img_w=b["orig_shape"][:, 1], img_h=b["orig_shape"][:, 0],
            focal_length=b["focal_length"], crop_res=IMG_RES)
    return got


def bf16_card_vs_cpu(label: str, model, smpl, batch: dict) -> None:
    """The card's bf16 forward against the CPU's on the same weights and
    crops, by tests/test_torch_precision.py's rule: the same dtype; a
    float32 output within BF16_SHARE x the CPU's own bf16-to-fp32
    distance + the key's fp32 tolerance, a bf16 output within one bf16
    step; an output that misses them (the rounding of cuDNN's and oneDNN's
    bf16 kernels, in other orders, grows through the net, as with the CPU
    test's narrow PARE twin) passes within BF16_SPREAD x the distance of
    the card's own two bf16 forwards, through cuDNN and through the native
    convolutions, + the tolerance. The camera translations are held to
    the same function of the card's own `pred_cam` (`derived_translations`):
    at two rows their rounding is `pred_cam`'s times a random factor near
    80 (PERF.md §6)."""
    card16, card32 = (bf16_forward(model, smpl, batch, d) for d in (torch.bfloat16, None))
    with torch.backends.cudnn.flags(enabled=False):
        native16 = bf16_forward(model, smpl, batch, torch.bfloat16)
    cpu_model, cpu_smpl = copy.deepcopy(model).cpu(), smpl.to("cpu")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    cpu16, cpu32 = (bf16_forward(cpu_model, cpu_smpl, cpu_batch, d)
                    for d in (torch.bfloat16, None))
    check(sorted(card16) == sorted(cpu16), f"{label}: keys differ")
    derived = derived_translations(card16, batch)
    readings, failed = {}, []
    for key in sorted(cpu16):
        check(card16[key].dtype == cpu16[key].dtype,
              f"{label}: {key} is {card16[key].dtype} on the card, {cpu16[key].dtype} on the CPU")
        got, want = card16[key].float().cpu(), cpu16[key].float()
        own = float((want - cpu32[key].float()).abs().max())
        err = float((got - want).abs().max())
        spread = float((got - native16[key].float().cpu()).abs().max())
        tol = BF16_KEY_TOLS.get(key, HEAD_TOL)
        if key in derived:
            again = derived[key]
            err = float((card16[key].double().cpu() - again).abs().max())
            bar = BF16_DERIVED_RTOL[card16[key].dtype] * float(again.abs().max())
            close, verdict = err <= bar, f"card's pred_cam, bar {bar:.3e}"
        else:
            if cpu16[key].dtype == torch.bfloat16:
                close = bool(torch.allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL))
            else:
                close = err <= BF16_SHARE * own + tol
            verdict = "close"
            if not close:
                close = err <= BF16_SPREAD * spread + tol
                verdict = f"spread x{err / max(spread, 1e-30):.2f}"
        if not close:
            failed.append(key)
        readings[key] = (f"{err:.3e}", f"cpu own {own:.3e}", f"card spread {spread:.3e}", verdict)
    print(f"{label} bf16, card vs CPU at batch {len(batch['img'])} (difference, the CPU's own "
          f"distance from fp32, the card's cuDNN-to-native distance, which bar): {readings}")
    check(not failed, f"{label} bf16 card vs CPU: {failed} past the bars")


def phase_precision(ctx: dict, pare: dict, train: dict, card: str) -> dict[str, Counter]:
    """Phase 4r: bf16 at full width, the bf16 artifact, a PRECISION 16
    train step, a data-parallel artifact, a CPU-exported artifact served
    on the card, and `cli.bench_serving`'s overload and window-sweep modes
    (see the module docstring). Uses 4h's artifact and removes its
    directory. Returns each path's launches."""
    from poco_tpu_torch.train.step import make_train_step

    print("== 4r. precision and artifacts: bf16, data-parallel, exported on the CPU")
    phase_start = time.perf_counter()
    model, smpl, image = ctx["model"], ctx["smpl"], ctx["image"]
    check(not model.training and not pare["model"].training, "4r: the models must be in eval mode")
    device, num_verts = smpl.v_template.device, smpl.v_template.shape[0]
    art, served, held = ctx["serve_artifact"], ctx["served"], ctx["serve_held"]
    tmp = ctx["serve_tmp"].name
    counts: dict[str, Counter] = {}

    def stage(label: str) -> None:
        print(f"-- 4r {label}: {time.perf_counter() - phase_start:.1f} s into 4r", flush=True)

    # (a) bf16 at full width, 128 boxes, beside fp32
    rng, (h, w) = ctx["rng"], image.shape[:2]
    centers, scales = random_boxes(rng, 128, h, w)
    batch = request_crops(image, centers, scales)
    pare_model = pare["model"]
    reset_counts()
    outs16 = {name: bf16_forward(m, smpl, batch, torch.bfloat16)
              for name, m in (("POCO-CLIFF", model), ("POCO-PARE", pare_model))}
    torch.cuda.synchronize()
    counts["bf16"] = read_counts("bf16 requests")
    check(counts["bf16"]["skinning"] == 2,
          f"bf16: skinning must launch once per request (fp32 inputs), got {dict(counts['bf16'])}")
    for name, m in (("POCO-CLIFF", model), ("POCO-PARE", pare_model)):
        out16, out32 = outs16[name], bf16_forward(m, smpl, batch, None)
        dist = {}
        for key in sorted(out32):
            d = float((out16[key].float() - out32[key].float()).abs().max())
            if key in ("smpl_vertices", "smpl_joints3d"):
                d = max_point_dist(out16[key], out32[key]) * 1e3
            dist[key] = f"{d:.4g}" + (" mm" if key in ("smpl_vertices", "smpl_joints3d") else "")
        check(all(bool(torch.isfinite(v).all()) for v in out16.values()), f"{name} bf16: not finite")
        print(f"{name} bf16 at 128 boxes, largest distance from fp32 by key: {dist}; dtypes "
              f"{ {k: str(v.dtype).replace('torch.', '') for k, v in out16.items()} }")
    c2, s2 = random_boxes(rng, 2, h, w)
    two = request_crops(image, c2, s2)   # held to the CPU last, after (f)
    stage("(a) bf16 forward")

    # (b) the bf16 artifact, beside 4h's fp32 one
    served16 = load_exported(f"{tmp}/bf16", device=device)
    served16.warmup()
    check(served16.meta["compute_dtype"] == "bfloat16", "bf16 artifact: compute_dtype")
    print(f"bf16 artifact: export {ctx['export_seconds']['bf16']:.2f} s (4h's side by side), "
          f"load {served16.load_seconds:.2f} s, warm-up "
          f"{ {b: round(t, 3) for b, t in served16.warmup_seconds.items()} } s")
    counts["bf16_artifact"] = Counter()
    for n, hb in held.items():
        tb = {k: torch.from_numpy(v).to(device) for k, v in hb.items()}
        tb["img"] = normalize_image(tb["img"].float())
        eager16 = {k: v.float().cpu().numpy() for k, v in bf16_forward(model, smpl, tb,
                                                                      torch.bfloat16).items()}
        eager32 = {k: v.cpu().numpy() for k, v in bf16_forward(model, smpl, tb, None).items()}
        reset_counts()
        got = served16.predict(hb)
        torch.cuda.synchronize()
        run = read_counts(f"bf16 artifact predict {n}")
        check(run["skinning"] == len(served16.buckets_for(n)),
              f"bf16 artifact: {run['skinning']} skinning launches for {n} crops")
        counts["bf16_artifact"].update(run)
        check(sorted(got) == sorted(eager16), f"bf16 artifact: keys {sorted(got)}")
        diffs, bad = served_diffs(got, eager16)
        # where the program and eager call cuDNN with other algorithms: a
        # tenth of the eager bf16 output's distance from fp32
        far = [k for k in bad if diffs[k] > BF16_ARTIFACT_SHARE * float(
            np.abs(eager16[k] - eager32[k]).max())]
        print(f"bf16 artifact vs eager bf16, {n} crops: largest difference by key {diffs}; "
              f"past the fp32 artifact's tolerances {bad}, past a tenth of bf16's distance "
              f"from fp32 {far}")
        check(not far, f"bf16 artifact vs eager bf16, {n} crops: {far}")
        check(all(v.dtype != np.float16 and np.isfinite(v).all() for v in got.values()),
              "bf16 artifact: outputs must be finite float32")
    for n in (1, 128):
        print_times("ExportedPoco.predict in-process, uint8 crops", n,
                    timed_requests(lambda: served16.predict(held[n]), reps=10), card, "bf16")
        print_times("ExportedPoco.predict in-process, uint8 crops (4h's artifact)", n,
                    timed_requests(lambda: served.predict(held[n]), reps=10), card)
    server = PocoServer(served16, port=0, batch_window_ms=5.0).start(warmup=False)
    try:
        pairs = []
        reset_counts()
        dispatch0 = server.batcher.dispatch_count
        row = bench_serving.run_combo(f"http://127.0.0.1:{server.port}", server.batcher, 8, 1,
                                      13, check=pairs.extend)
        torch.cuda.synchronize()
        run = read_counts("bf16 artifact http 8x1")
        check(run["skinning"] == server.batcher.dispatch_count - dispatch0,
              "bf16 artifact over HTTP: skinning must launch once per dispatch")
        counts["bf16_artifact"].update(run)
        print(f"bf16 artifact serving 8x1: " + json.dumps({"card": card, **row}))
        check_served_pairs(served16, 8, 1, pairs, num_verts)
    finally:
        server.stop()
    del served16
    stage("(b) bf16 artifact")

    # (c) a TRAINING.PRECISION: 16 step at the config's batch, beside fp32
    trainers = {}
    for precision in (16, 32):
        trainers[precision] = loss_trainer(ctx, "configs/poco_cliff.yaml", model, False, False,
                                           train["data"], precision=precision)
    check(trainers[16].autocast_dtype == torch.bfloat16 and trainers[32].autocast_dtype is None,
          "PRECISION 16 did not reach the trainer")
    first = {}
    for precision, trainer in trainers.items():
        step = make_train_step(trainer.model, trainer.optimizer, trainer.loss_cfg,
                               autocast_dtype=trainer.autocast_dtype)
        batch64 = trainer._device_batch(train["host"])
        first[precision] = {k: float(v) for k, v in step(batch64, smpl).items()
                            if k.startswith("loss/")}
    print(f"PRECISION 16 vs 32, first step on one batch of {len(train['host']['img'])} from "
          f"the same weights: total loss {first[16]['loss/total_loss']:.6f} / "
          f"{first[32]['loss/total_loss']:.6f}; terms bf16 {first[16]}")
    check(all(math.isfinite(v) for v in first[16].values()), "PRECISION 16: a term not finite")
    del trainers[32]
    trainer = trainers[16]
    step = make_train_step(trainer.model, trainer.optimizer, trainer.loss_cfg,
                           autocast_dtype=trainer.autocast_dtype)
    batch64 = trainer._device_batch(train["host"])
    reset_counts()
    ts = time_train_step("POCO-CLIFF, PRECISION 16", step, batch64, smpl, card, "bf16")
    counts["train_bf16"] = read_counts("train PRECISION 16")
    check((counts["train_bf16"]["skinning"], counts["train_bf16"]["skinning_backward"])
          == tuple(13 * n for n in TRAIN_LAUNCHES),
          "PRECISION 16: each step must launch skinning 2 and skinning_backward 1 times")
    print(f"PRECISION 16 step {statistics.median(ts) * 1e3:.3f} ms beside 4f's fp32 step "
          f"{64 / train['step_crops_per_s'] * 1e3:.3f} ms (median, batch 64) on {card}")
    del trainers, trainer, step, batch64
    torch.cuda.empty_cache()
    stage("(c) PRECISION 16 step")

    # (d) a data-parallel artifact, two replicas named on the one card
    dp = load_exported(f"{tmp}/dp2", devices=DP_REPLICAS)
    dp.warmup()
    print(f"data-parallel artifact: {len(DP_REPLICAS)} replicas on {DP_REPLICAS} (one card: "
          f"this shows the replicas correct, not that they scale); export "
          f"{ctx['export_seconds']['dp2']:.2f} s (4h's side by side), "
          f"load {dp.load_seconds:.2f} s, meta platforms {dp.meta['platforms']}")
    counts["data_parallel"] = Counter()
    for n in DP_HELD:
        reset_counts()
        got = dp.predict(held[n])
        torch.cuda.synchronize()
        run = read_counts(f"data-parallel predict {n}")
        check(run["skinning"] == len(DP_REPLICAS) * len(dp.buckets_for(n)),
              f"data-parallel: skinning must launch once a shard, got {dict(run)} for {n}")
        counts["data_parallel"].update(run)
        jax_dp_bars(f"data-parallel vs single artifact, {n} crops", got, served.predict(held[n]))
    server = PocoServer(dp, port=0, batch_window_ms=5.0).start(warmup=False)
    try:
        pairs = []
        reset_counts()
        dispatch0 = server.batcher.dispatch_count
        row = bench_serving.run_combo(f"http://127.0.0.1:{server.port}", server.batcher, 8, 1,
                                      13, check=pairs.extend)
        torch.cuda.synchronize()
        run = read_counts("data-parallel http 8x1")
        check(run["skinning"] == len(DP_REPLICAS) * (server.batcher.dispatch_count - dispatch0),
              "data-parallel over HTTP: skinning must launch once a shard")
        counts["data_parallel"].update(run)
        print("data-parallel serving 8x1 (two replicas on one card: correctness, not "
              "scaling): " + json.dumps({"card": card, **row}))
        check_served_pairs(dp, 8, 1, pairs, num_verts)
    finally:
        server.stop()
    dp.close()
    del dp
    stage("(d) data-parallel artifact")

    # (e) exported on the CPU for ("cpu", "cuda"), served on the card
    moved = load_exported(f"{tmp}/cpu", device=device)
    moved.warmup()
    print(f"CPU-exported artifact: export on the CPU {ctx['export_seconds']['cpu']:.2f} s "
          f"(4h's side by side), platforms "
          f"{moved.meta['platforms']}, loaded on {moved.device} in {moved.load_seconds:.2f} s")
    counts["cpu_exported"] = Counter()
    for n in (8, 128):
        reset_counts()
        got = moved.predict(held[n])
        torch.cuda.synchronize()
        run = read_counts(f"CPU-exported predict {n}")
        check(run["skinning"] == len(moved.buckets_for(n)),
              f"CPU-exported artifact on the card: skinning must launch once a dispatch (the "
              f"CPU's plain version would show none), got {dict(run)}")
        counts["cpu_exported"].update(run)
        jax_dp_bars(f"CPU-exported vs card-exported artifact, {n} crops", got,
                    served.predict(held[n]))
    del moved
    stage("(e) CPU-exported artifact")

    # (f) the bench's overload (the server a process of its own) and window sweep
    rows = bench_serving.main(["--artifact", art, "--device", "cuda", "--overload",
                               "--server-subproc", *OVERLOAD])
    check([r["flood"] for r in rows] == [0, 1], "overload: two floods")
    for row in rows:
        print(f"overload flood {row['flood']}: " + json.dumps({"card": card, **row}))
        check(row["rejected"] > 0 and row["pending_rows_hwm"] <= row["budget_rows"]
              and set(row["rejected_by_code"]) <= {429, 503}
              and row["rejected_without_retry_after"] == 0,
              f"overload flood {row['flood']}: {row}")
    reset_counts()
    rows = bench_serving.main(["--artifact", art, "--device", "cuda", "--sweep-window", "0,5",
                               "--sweep-combo", "64x1", "--requests-per-client", "1"])
    torch.cuda.synchronize()
    counts["sweep"] = read_counts("bench_serving --sweep-window")
    for row in rows:
        print("sweep-window: " + json.dumps({"card": card, **row}))
    check([r["window_ms"] for r in rows] == [0.0, 5.0] and counts["sweep"]["skinning"] > 0,
          f"sweep: rows {rows}, launches {dict(counts['sweep'])}")
    stage("(f) cli.bench_serving")
    for name, m in (("POCO-CLIFF", model), ("POCO-PARE", pare_model)):
        bf16_card_vs_cpu(name, m, smpl, two)
    stage("(a) bf16 card vs CPU")
    ctx["serve_tmp"].cleanup()
    for key in ("served", "serve_held", "serve_artifact", "serve_tmp"):
        ctx.pop(key)
    torch.cuda.empty_cache()
    return counts


# -- multi-process (phase 4i) ---------------------------------------------------

DIST_WORLD = 2            # ranks sharing the one card over gloo
DIST_STEPS = 2            # steps of the ranks' fit and of one process's (why 2: phase_dist)
DIST_EVAL_SAMPLES = 256   # phase 4e's first samples, evaluated sharded
DIST_LOSS_RTOL = 2e-4     # per-step loss, ranks against one process (tests/test_multiprocess.py)
DIST_PARAM_RTOL = 1e-5    # parameter checksum, the same
DIST_GRAD_RTOL = {        # a top-level module's step-1 gradient, ranks against one
    "backbone": 0.1,      # process, relative L2: the backbone's ReLU units flip with
}                         # fp32 rounding (phase 4f: 1-2% from float64 without the masks)
DIST_TIMEOUT = 600        # seconds the ranks may take


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_environment():
    """torchrun's variables for a world of one process on a free localhost
    port, for `--dist`; the old values restored after."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dist_clis(tmp: Path) -> dict[str, Counter]:
    """Phase 4i (a): `cli.train --dist` (tiny_smoke, one epoch on the smoke
    JPEGs) and `cli.eval --dist` of its checkpoint under torchrun's
    environment for one process: an NCCL world of one, held to the same
    runs without --dist (per-step losses and the report's mpjpe, pa_mpjpe,
    v2v within rtol DIST_LOSS_RTOL)."""
    tiny, data_dir = str(REPO / "configs" / "tiny_smoke.yaml"), str(REPO / "data")
    counts, runs = {}, {}
    for label, extra in (("plain", []), ("dist", ["--dist"])):
        logdir = str(tmp / f"tiny_{label}")
        out = io.StringIO()
        with torchrun_environment(), contextlib.redirect_stdout(out):
            reset_counts()
            cli_train.main(["--cfg", tiny, "--logdir", logdir, "--max_epochs", "1",
                            "--data_dir", data_dir, *extra])
            counts[f"cli_train_{label}"] = read_counts(f"cli.train {label}")
        with torchrun_environment(), contextlib.redirect_stdout(out):
            reset_counts()
            report = cli_eval.main(["--cfg", tiny, "--ckpt", logdir, "--dataset", "smoke",
                                    "--data_dir", data_dir, *extra])
            counts[f"cli_eval_{label}"] = read_counts(f"cli.eval {label}")
        check(not torch.distributed.is_initialized(), f"cli {label}: a process group was left")
        worlds = [line for line in out.getvalue().splitlines() if line.startswith("world:")]
        losses = [r["loss/total_loss"] for r in logged_losses(logdir)]
        runs[label] = (losses, report["summary"])
        print(f"cli.train / cli.eval tiny_smoke {label}: {worlds or 'no process group'}; "
              f"losses {losses}; launches {dict(counts[f'cli_train_{label}'])} / "
              f"{dict(counts[f'cli_eval_{label}'])}")
        check(worlds == ([] if label == "plain" else ["world: rank 0 of 1 (backend nccl)"] * 2),
              f"cli {label}: worlds {worlds}")
        steps, n_val = len(losses), math.ceil(16 / 4) * EVAL_LAUNCHES[False]
        check(counts[f"cli_train_{label}"]["skinning_backward"] == steps > 0
              and counts[f"cli_train_{label}"]["skinning"] == 2 * steps + n_val
              and counts[f"cli_eval_{label}"]["skinning"] == EVAL_LAUNCHES[False],
              f"cli {label}: each step must launch skinning 2 and skinning_backward 1 times, "
              "each evaluation batch skinning 5")
    (plain, plain_summary), (dist, dist_summary) = runs["plain"], runs["dist"]
    check(len(plain) == len(dist) > 0
          and np.allclose(dist, plain, rtol=DIST_LOSS_RTOL, atol=0),
          f"cli.train --dist losses {dist} against {plain}")
    for key in ("mpjpe", "pa_mpjpe", "v2v"):
        check(math.isclose(dist_summary[key], plain_summary[key], rel_tol=DIST_LOSS_RTOL),
              f"cli.eval --dist {key} {dist_summary[key]} against {plain_summary[key]}")
    print(f"NCCL world of one: losses and report within rtol {DIST_LOSS_RTOL} of the runs "
          f"without --dist")
    return counts


def dist_fit(workdir: Path, seed: int, label: str) -> tuple:
    """Phase 4i's fit in one process of any world: POCO-CLIFF (configs/
    poco_cliff.yaml as it is, phase 4's weights from workdir/weights.pt)
    through `Trainer.fit` for DIST_STEPS steps at the config's global
    batch on phase 4f's synthetic samples. Returns the trainer and the
    per-step losses, gradient norms and seconds, the seconds of each
    step's gradient all-reduce, the parameter checksum and the launches;
    writes the first step's gradients as the optimizer takes them (summed
    over processes), flat by top-level module, to workdir/grad1_<label>.pt."""
    from poco_tpu_torch.parallel import distributed
    from poco_tpu_torch.train.trainer import Trainer

    smpl = synthetic_smpl_model(num_verts=6890, seed=seed, device="cuda")
    hparams = train_hparams(str(workdir / f"logs_{label}"))
    batch_size = hparams.DATASET.BATCH_SIZE
    data = SyntheticTrainSet(DIST_STEPS * batch_size, seed + 31, smpl.to("cpu"))
    trainer = Trainer(hparams, smpl, train_dataset_fn=lambda epoch: data, device="cuda")
    trainer.model.load_state_dict(torch.load(workdir / "weights.pt", map_location="cuda"))
    rec = {"world": distributed.process_count(), "losses": [], "grad_norm": [], "step_s": [],
           "reduce_s": []}
    inner_step, inner_reduce = trainer.train_step, distributed.all_reduce_gradients
    names = {id(p): name for name, p in trainer.model.named_parameters()}

    def timed_step(batch, smpl):
        torch.cuda.synchronize()
        start = time.perf_counter()
        metrics = inner_step(batch, smpl)
        rec["losses"].append(float(metrics["loss/total_loss"]))
        rec["grad_norm"].append(float(metrics["grad_norm"]))
        rec["step_s"].append(time.perf_counter() - start)
        return metrics

    def timed_reduce(params):
        torch.cuda.synchronize()
        start = time.perf_counter()
        inner_reduce(params)
        torch.cuda.synchronize()
        rec["reduce_s"].append(time.perf_counter() - start)
        if len(rec["reduce_s"]) == 1:
            groups = {}
            for p in params:
                if p.grad is not None:
                    groups.setdefault(names[id(p)].split(".")[0], []).append(p.grad.reshape(-1))
            torch.save({k: torch.cat(v).cpu() for k, v in groups.items()},
                       workdir / f"grad1_{label}.pt")

    trainer.train_step = timed_step
    distributed.all_reduce_gradients = timed_reduce   # measured here only
    try:
        reset_counts()
        trainer.fit()
        rec["counts"] = dict(read_counts(f"dist fit {label}"))
    finally:
        distributed.all_reduce_gradients = inner_reduce
        trainer.close()
    rec["param_sum"] = sum(float(p.detach().double().abs().sum())
                           for p in trainer.model.parameters())
    return trainer, rec


def dist_eval(model, seed: int, label: str) -> dict:
    """`run_eval` of `model` on phase 4e's first DIST_EVAL_SAMPLES samples
    at its batch, with its three SMPLs (sharded over the world's
    processes): the per-sample metrics and the launches."""
    smpls = tuple(synthetic_smpl_model(num_verts=6890, seed=s, device="cuda")
                  for s in (seed, seed + 11, seed + 12))
    evaluation = Subset(SyntheticEvalSet(EVAL_SAMPLES, seed + 5), range(DIST_EVAL_SAMPLES))
    model.eval()
    reset_counts()
    result = run_eval(model, evaluation, *smpls, batch_size=EVAL_BATCH,
                      loss_ver=model.cfg.loss_ver)
    torch.cuda.synchronize()
    return {"imgnames": result.imgnames, "eval_counts": dict(read_counts(f"dist eval {label}")),
            **{key: getattr(result, key).tolist()
               for key in ("mpjpe_mm", "pa_mpjpe_mm", "v2v_mm")}}


def dist_rank(rank: int, workdir: Path, seed: int) -> int:
    """One of phase 4i's ranks (a subprocess of this script): the fit in a
    world of DIST_WORLD processes on this card, rank 0 saving the fitted
    weights, then their sharded evaluation, then phase 4n (a) on the same
    processes as data 1 x model 2 (`model_axis_rank`). NCCL refuses two
    ranks on one device, so the ranks talk over gloo, whose collectives
    the port stages through host memory."""
    from poco_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.maybe_initialize(coordinator=f"file://{workdir / 'init'}",
                                 num_processes=DIST_WORLD, process_id=rank, backend="gloo")
    try:
        trainer, rec = dist_fit(workdir, seed, f"rank{rank}")
        if rank == 0:
            torch.save(trainer.model.state_dict(), workdir / "fitted.pt")
        rec.update(dist_eval(trainer.model, seed, f"rank{rank}"))
        del trainer
        torch.cuda.empty_cache()
        rec["axis"] = model_axis_rank(rank, workdir, seed)   # phase 4n (a)
    finally:
        distributed.shutdown()
    with open(workdir / f"rank{rank}.json", "w") as f:
        json.dump(rec, f)
    return 0


def run_ranks(workdir: Path, seed: int, world: int = DIST_WORLD, flag: str = "--dist-rank",
              stem: str = "rank") -> list[dict]:
    """Start `world` ranks of this script together (`flag` r) and wait for
    all; a rank that fails or outlasts DIST_TIMEOUT fails the phase (the
    others are killed). Returns each rank's workdir/<stem><r>.json."""
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
         flag, str(r), "--dist-dir", str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{stem} {r} failed (exit {p.returncode}):\n{out[-4000:]}")
    results = []
    for r in range(world):
        with open(workdir / f"{stem}{r}.json") as f:
            results.append(json.load(f))
    return results


def rel_diffs(a, b) -> list[float]:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.abs(a - b) / np.abs(b)).tolist()


def dist_gradient_faults(grads: dict, ranks: list[str], label: str = "step-1") -> list[str]:
    """The first step's gradients as the optimizer takes them: the same
    on every rank (every rank applies one update), and each top-level
    module's within relative L2 DIST_GRAD_RTOL (else GRAD_GROUP_RTOL, as
    phase 4f) of one process's (`grads["one"]`). A rank that skipped the
    sum over processes would hold its own rows' share: off by tens of
    percent (PERF.md, section 6, the multi-GPU findings). Prints each
    module's distance, with a second one-process fit's beside it where
    `grads` has one ("again": the card's own run-to-run difference);
    returns what failed."""
    one, faults = grads["one"], []
    if any(grads[r].keys() != one.keys() for r in ranks):
        return [f"{label}: the ranks' gradients are of other modules than one process's"]
    for r in ranks[1:]:
        diff = max(float((grads[r][k] - grads[ranks[0]][k]).abs().max()) for k in one)
        if diff != 0.0:
            faults.append(f"{label}: {r}'s gradients differ from {ranks[0]}'s by up to {diff}")

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))

    for k in one:
        pair, bar = rel(grads[ranks[0]][k], one[k]), DIST_GRAD_RTOL.get(k, GRAD_GROUP_RTOL)
        again = (f"; one process again {rel(grads['again'][k], one[k]):.3e}"
                 if "again" in grads else "")
        print(f"{label} gradient {k} ({one[k].numel()} values): {len(ranks)} ranks vs one "
              f"process relative L2 {pair:.3e} (tolerance {bar}){again}")
        if pair > bar:
            faults.append(f"{label}: the {k} gradient is {pair:.3e} from one process's")
    return faults


def phase_dist(ctx: dict, seed: int, card: str) -> dict[str, Counter]:
    """Phase 4i: (a) both CLIs with --dist in an NCCL world of one; (b)
    DIST_WORLD gloo ranks sharing the card train POCO-CLIFF at full width
    (global batch 64, 32 a rank) and evaluate the fitted weights sharded,
    held to one process: per-step losses within DIST_LOSS_RTOL, the
    parameter checksum within DIST_PARAM_RTOL and the first step's summed
    gradients (`check_dist_gradients`) of one process's fit on the same
    steps, and every sample's MPJPE / PA-MPJPE / V2V within
    METERS_TOL of one process's evaluation of the same fitted weights. A
    second one-process fit gives the card's own run-to-run difference
    beside the ranks'. The fit stops at DIST_STEPS = 2: the pair's
    arithmetic differs from one process's (its own batch norm, sums in
    another order), and Adam's first steps move each weight by about the
    learning rate in the sign of its gradient, so gradients that differ a
    little where they are near zero move weights apart by whole steps;
    by the third step the pair's loss is past the loss bar (PERF.md
    section 6, the multi-GPU findings). Two ranks on one card show correctness, not
    scaling. Returns the launches of every run, the ranks' summed."""
    import tempfile

    print("== 4i. multi-process: --dist on NCCL (world of one); two gloo ranks on the card")
    phase_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        tmp = Path(tmp)
        counts = dist_clis(tmp)
        torch.save(ctx["model"].state_dict(), tmp / "weights.pt")
        torch.cuda.empty_cache()
        start = time.perf_counter()
        ranks = run_ranks(tmp, seed)
        pair_s = time.perf_counter() - start
        start = time.perf_counter()
        trainer, one = dist_fit(tmp, seed, "one")
        one_s = time.perf_counter() - start
        _, again = dist_fit(tmp, seed, "again")
        grads = {label: torch.load(tmp / f"grad1_{label}.pt")
                 for label in [f"rank{r}" for r in range(DIST_WORLD)] + ["one", "again"]}
        trainer.model.load_state_dict(torch.load(tmp / "fitted.pt", map_location="cuda"))
        one.update(dist_eval(trainer.model, seed, "one"))
        del trainer
        torch.cuda.empty_cache()
        mark("phase 4i's runs")
        axis_counts = phase_model_axis(ranks, tmp, seed, card)

    fit_want = {"skinning": TRAIN_LAUNCHES[0] * DIST_STEPS,
                "skinning_backward": TRAIN_LAUNCHES[1] * DIST_STEPS}
    eval_want = {"skinning": EVAL_LAUNCHES[False] * math.ceil(DIST_EVAL_SAMPLES / EVAL_BATCH),
                 "skinning_backward": 0}
    pair = Counter()
    for label, res in [(f"rank {r}", res) for r, res in enumerate(ranks)] + [("one", one)]:
        for key, want in (("counts", fit_want), ("eval_counts", eval_want)):
            got = res[key]
            check(got.get("skinning_simt", 0) == 0 and got.get("skinning_backward_simt", 0) == 0,
                  f"dist {label}: a yardstick kernel ran: {got}")
            check(all(got.get(k, 0) == v for k, v in want.items()),
                  f"dist {label} {key}: launches {got}, not {want}")
    for res in ranks:
        pair.update(res["counts"])
        pair.update(res["eval_counts"])
    counts["dist_pair"] = pair
    counts["dist_one"] = Counter(one["counts"]) + Counter(one["eval_counts"])
    counts["dist_again"] = Counter(again["counts"])
    print(f"launches: each rank {ranks[0]['counts']} fitting, {ranks[0]['eval_counts']} "
          f"evaluating; one process {one['counts']} + {one['eval_counts']}")

    check(all(res["world"] == DIST_WORLD for res in ranks) and one["world"] == 1,
          f"dist: worlds {[res['world'] for res in ranks]}, {one['world']}")
    rel = rel_diffs(ranks[0]["losses"], one["losses"])
    print(f"per-step total loss: {DIST_WORLD} ranks {ranks[0]['losses']}, one process "
          f"{one['losses']}, relative {rel} (tolerance {DIST_LOSS_RTOL}); one process again "
          f"{again['losses']}, relative {rel_diffs(again['losses'], one['losses'])}")
    print(f"gradient norm by step: {DIST_WORLD} ranks {ranks[0]['grad_norm']}, one process "
          f"{one['grad_norm']} (relative {rel_diffs(ranks[0]['grad_norm'], one['grad_norm'])}), "
          f"again relative {rel_diffs(again['grad_norm'], one['grad_norm'])}")
    sums = [res["param_sum"] for res in ranks]
    err = max(rel_diffs(sums, [one["param_sum"]] * len(sums)))
    print(f"parameter checksum (sum |w|): ranks {sums}, one process {one['param_sum']}, "
          f"relative {err:.3e} (tolerance {DIST_PARAM_RTOL}); again "
          f"{rel_diffs([again['param_sum']], [one['param_sum']])[0]:.3e}")
    # every reading is printed before the first of these checks fails
    faults = dist_gradient_faults(grads, [f"rank{r}" for r in range(DIST_WORLD)])
    if not all(res["losses"] == ranks[0]["losses"] for res in ranks):
        faults.append("the ranks log other global losses")
    if not (len(rel) == DIST_STEPS and max(rel) <= DIST_LOSS_RTOL):
        faults.append("per-step losses differ from one process")
    if err > DIST_PARAM_RTOL:
        faults.append("the fitted weights' checksum differs from one process's")
    check(not faults, f"dist: {'; '.join(faults)}")
    for r, res in enumerate(ranks):
        check(res["imgnames"] == one["imgnames"] and len(one["imgnames"]) == DIST_EVAL_SAMPLES,
              f"dist rank {r}: sample names differ")
        worst = {key: float(np.abs(np.asarray(res[key]) - one[key]).max()) / 1000.0
                 for key in ("mpjpe_mm", "pa_mpjpe_mm", "v2v_mm")}
        print(f"dist rank {r}: the fitted weights' {DIST_EVAL_SAMPLES} samples evaluated "
              f"sharded, largest difference to one process (m) {worst} (tolerance {METERS_TOL})")
        check(all(v <= METERS_TOL for v in worst.values()),
              f"dist rank {r}: per-sample metrics differ from one process: {worst}")

    def ms(ts):
        return (f"median {1e3 * statistics.median(ts):.3f} ms (min {1e3 * min(ts):.3f}, "
                f"max {1e3 * max(ts):.3f}) over {len(ts)}")

    for r, res in enumerate(ranks):
        print(f"dist rank {r}: train step (32 rows, two ranks on one card) "
              f"{[round(1e3 * t, 3) for t in res['step_s']]} ms; gradient all-reduce (gloo, "
              f"staged through host) {[round(1e3 * t, 3) for t in res['reduce_s']]} ms on {card}")
    print(f"dist step time: {DIST_WORLD} ranks {ms([t for res in ranks for t in res['step_s']])}"
          f"; one process (batch 64) {ms(one['step_s'] + again['step_s'])}; gradient "
          f"all-reduce {ms([t for res in ranks for t in res['reduce_s']])}; first steps "
          f"included; the ranks {pair_s:.3f} s (start-up and evaluation included), one "
          f"process's fit {one_s:.3f} s; on {card}. Two ranks on one card show correctness, "
          f"not scaling.")
    print(f"phase 4i: {time.perf_counter() - phase_start:.3f} s (4n's included)")
    counts.update(axis_counts)
    return counts


# -- the SMPL model axis (phase 4n) ---------------------------------------------

AXIS_MODEL = 2            # (a) the two 4i ranks as data 1 x model 2
AXIS_ROWS = 64            # (a) the config's batch, every row on both ranks
AXIS_METERS_TOL = 1e-5    # smplcam_head vertices / joints3d, sharded vs one process, m
AXIS_PX_TOL = 1e-2        # its joints2d, px (1e-5 m at the synthetic cameras' depths)
GRID_WORLD, GRID_MODEL = 4, 2   # (b) data 2 x model 2, tiny-cliff, as JAX's dry run
GRID_ROWS, GRID_VERTS = 8, 128  # (b) 2 rows a rank (the dry run's 2 x devices), V = 128


def axis_head_inputs(rows: int, seed: int) -> dict:
    """Seeded `smplcam_head` inputs on the card: rotations within 0.4 rad,
    shapes, crop cameras and full-image boxes of 720x1280 frames."""
    rng = np.random.RandomState(seed)
    aa = torch.from_numpy((0.4 * rng.randn(rows * 24, 3)).astype(np.float32))
    img_h, img_w = torch.full((rows,), 720.0), torch.full((rows,), 1280.0)
    x = {
        "rotmat": axis_angle_to_rotmat(aa).reshape(rows, 24, 3, 3),
        "shape": torch.from_numpy(rng.randn(rows, 10).astype(np.float32)),
        "cam": torch.from_numpy(np.stack([rng.uniform(0.6, 1.2, rows), rng.uniform(
            -0.2, 0.2, rows), rng.uniform(-0.2, 0.2, rows)], 1).astype(np.float32)),
        "focal_length": torch.sqrt(img_h ** 2 + img_w ** 2),
        "bbox_scale": torch.from_numpy(rng.uniform(1.5, 3.0, rows).astype(np.float32)),
        "bbox_center": torch.from_numpy(np.stack([rng.uniform(300, 980, rows), rng.uniform(
            200, 520, rows)], 1).astype(np.float32)),
        "img_w": img_w, "img_h": img_h,
    }
    return {k: v.cuda() for k, v in x.items()}


def axis_step(hparams, smpl, weights, host: dict, label: str) -> tuple[dict, dict]:
    """One `Trainer.train_step` of `host` (a host batch) from `weights` (a
    state_dict file, or None for the seeded model) with `smpl` (sharded or
    not): the loss terms, the launches, the weights' checksum after the
    step and the peak memory; and the gradients flat by top-level module."""
    from poco_tpu_torch.train.trainer import Trainer

    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(hparams, smpl, train_dataset_fn=None, device="cuda")
    if weights is not None:
        trainer.model.load_state_dict(torch.load(weights, map_location="cuda"))
    batch = trainer._device_batch(host)
    reset_counts()
    metrics = trainer.train_step(batch, trainer.smpl)
    torch.cuda.synchronize()
    counts = read_counts(label)
    groups = {}
    for name, p in trainer.model.named_parameters():
        if p.grad is not None:
            groups.setdefault(name.split(".")[0], []).append(p.grad.reshape(-1))
    grads = {k: torch.cat(v).cpu() for k, v in groups.items()}
    rec = {"losses": {k: float(v) for k, v in metrics.items() if k.startswith("loss/")},
           "counts": dict(counts),
           "grad_sum": sum(float(g.double().abs().sum()) for g in grads.values()),
           "param_sum": sum(float(p.detach().double().abs().sum())
                            for p in trainer.model.parameters()),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    trainer.close()
    del trainer, batch, metrics
    torch.cuda.empty_cache()
    return rec, grads


def smpl_stage_ms(smpl, x: dict, reps: int = 20) -> list[float]:
    """Host-clock ms of `smplcam_head` (the SMPL stage of a forward),
    synchronized, after 3 calls of warm-up."""
    from poco_tpu_torch.smpl.model import smplcam_head

    ts = []
    with torch.no_grad():
        for i in range(reps + 3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            smplcam_head(smpl, **x)
            torch.cuda.synchronize()
            if i >= 3:
                ts.append(1e3 * (time.perf_counter() - start))
    return ts


def model_axis_rank(rank: int, workdir: Path, seed: int) -> dict:
    """Phase 4n (a) in one of the two 4i ranks, after 4i's work: the grid
    re-formed as data 1 x model AXIS_MODEL, the V=6890 SMPL sharded by
    vertex. `smplcam_head` on AXIS_ROWS seeded rows, sharded against this
    process's own unsharded SMPL (errors and the SMPL stage's time both
    ways), then one POCO-CLIFF train step from phase 4's weights on the
    first AXIS_ROWS rows of a synthetic set, all on both ranks (its
    gradients to workdir/axis_grad_rank<r>.pt)."""
    from poco_tpu_torch.parallel import distributed
    from poco_tpu_torch.parallel.mesh import shard_smpl_params
    from poco_tpu_torch.smpl.model import smplcam_head

    distributed.form_grid(AXIS_MODEL)
    smpl = synthetic_smpl_model(num_verts=6890, seed=seed, device="cuda")
    sharded = shard_smpl_params(smpl)
    x = axis_head_inputs(AXIS_ROWS, seed + 51)
    reset_counts()
    with torch.no_grad():
        got = smplcam_head(sharded, **x)
    torch.cuda.synchronize()
    head_counts = read_counts(f"model axis head rank{rank}")
    with torch.no_grad():
        want = smplcam_head(smpl, **x)
    errs = {k: float((getattr(got, k) - getattr(want, k)).abs().max())
            for k in ("vertices", "joints3d", "joints2d", "cam_t", "fullimg_cam_t")}
    rec = {"shard": [sharded.shard.lo, sharded.shard.hi], "head_err": errs,
           "head_counts": dict(head_counts),
           "stage_ms": {"sharded": smpl_stage_ms(sharded, x), "whole": smpl_stage_ms(smpl, x)}}
    data = SyntheticTrainSet(AXIS_ROWS, seed + 53, smpl.to("cpu"))
    step, grads = axis_step(train_hparams(str(workdir / f"axis_rank{rank}")), sharded,
                            workdir / "weights.pt", data.get_batch(range(AXIS_ROWS)),
                            f"model axis step rank{rank}")
    torch.save(grads, workdir / f"axis_grad_rank{rank}.pt")
    rec["step"] = step
    return rec


def grid_rank(rank: int, workdir: Path, seed: int) -> int:
    """One of phase 4n (b)'s GRID_WORLD ranks (a subprocess of this
    script): data 2 x model GRID_MODEL over gloo on this card, tiny-cliff
    (configs/tiny_smoke.yaml, its seeded weights) with a V=GRID_VERTS
    synthetic SMPL sharded over the model group, one train step on this
    data index's rows of a global batch of GRID_ROWS."""
    from poco_tpu_torch.parallel import distributed
    from poco_tpu_torch.parallel.mesh import shard_smpl_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.maybe_initialize(coordinator=f"file://{workdir / 'grid_init'}",
                                 num_processes=GRID_WORLD, process_id=rank, backend="gloo")
    try:
        distributed.form_grid(GRID_MODEL)
        smpl = synthetic_smpl_model(num_verts=GRID_VERTS, seed=seed, device="cuda")
        data = SyntheticTrainSet(GRID_ROWS, seed + 57, smpl.to("cpu"))
        lo, hi = distributed.local_shard_bounds(GRID_ROWS)
        rec, grads = axis_step(train_hparams(str(workdir / f"grid_rank{rank}"),
                                             "configs/tiny_smoke.yaml"),
                               shard_smpl_params(smpl), None,
                               data.get_batch(range(GRID_ROWS), keep=slice(lo, hi)),
                               f"grid rank{rank}")
        rec.update(data_index=distributed.data_index(), model_index=distributed.model_index())
    finally:
        distributed.shutdown()
    torch.save(grads, workdir / f"grid_grad_rank{rank}.pt")
    with open(workdir / f"grid_rank{rank}.json", "w") as f:
        json.dump(rec, f)
    return 0


def step_faults(label: str, ranks: list[dict], one: dict) -> list[str]:
    """Loss terms within DIST_LOSS_RTOL and the gradient checksum within
    DIST_PARAM_RTOL of one process's (printed)."""
    faults = []
    rel = {k: abs(ranks[0]["losses"][k] - v) / max(abs(v), 1e-30)
           for k, v in one["losses"].items()}
    grad_rel = abs(ranks[0]["grad_sum"] - one["grad_sum"]) / one["grad_sum"]
    print(f"{label}: total loss {ranks[0]['losses']['loss/total_loss']:.6f} against one "
          f"process's {one['losses']['loss/total_loss']:.6f}; the loss terms' largest relative "
          f"difference {max(rel.values()):.3e} (tolerance {DIST_LOSS_RTOL}); gradient checksum "
          f"(sum |g|) {ranks[0]['grad_sum']:.6e} against {one['grad_sum']:.6e}, relative "
          f"{grad_rel:.3e} (tolerance {DIST_PARAM_RTOL})")
    if any(res["losses"] != ranks[0]["losses"] for res in ranks):
        faults.append(f"{label}: the ranks log other loss terms")
    if not all(math.isfinite(v) for v in ranks[0]["losses"].values()):
        faults.append(f"{label}: a loss term is not finite")
    if max(rel.values()) > DIST_LOSS_RTOL:
        faults.append(f"{label}: the loss terms differ from one process's")
    if grad_rel > DIST_PARAM_RTOL:
        faults.append(f"{label}: the gradient checksum differs from one process's")
    return faults


def phase_model_axis(ranks: list[dict], workdir: Path, seed: int, card: str) -> dict[str, Counter]:
    """Phase 4n: the SMPL "model" axis. (a) The two ranks of phase 4i,
    re-formed as data 1 x model AXIS_MODEL after 4i's work (their
    results in `ranks[r]["axis"]`): `smplcam_head` sharded against one
    process within AXIS_METERS_TOL m (joints2d AXIS_PX_TOL px), and one
    POCO-CLIFF train step at batch AXIS_ROWS, every row on both ranks,
    against this process's step on the same rows and weights: the loss
    terms, the gradient checksum and each module's gradient at phase 4i's
    bars; `skinning` (2) and `skinning_backward` (1) launch at the shard's
    shape (B = 64, V = 3445). Two ranks sharing a card over gloo (staged
    through host memory) show correctness, not scaling: the SMPL stage's
    time is printed both ways. (b) GRID_WORLD ranks, data 2 x model
    GRID_MODEL, tiny-cliff, one step at the global batch GRID_ROWS against
    one process. Returns the launches of every rank, summed."""
    import tempfile

    print(f"== 4n. the SMPL model axis: (a) the two 4i ranks as data 1 x model {AXIS_MODEL}, "
          f"POCO-CLIFF at full width; (b) {GRID_WORLD} ranks, data 2 x model {GRID_MODEL}, "
          "tiny-cliff")
    phase_start = time.perf_counter()
    axis = [res["axis"] for res in ranks]
    smpl = synthetic_smpl_model(num_verts=6890, seed=seed, device="cuda")
    faults = []
    for r, res in enumerate(axis):
        err = res["head_err"]
        print(f"4n (a) rank {r}: vertices [{res['shard'][0]}, {res['shard'][1]}) of 6890; "
              f"smplcam_head on {AXIS_ROWS} rows sharded vs one process, largest difference "
              f"{err} (vertices and joints3d m, tolerance {AXIS_METERS_TOL}; joints2d px, "
              f"{AXIS_PX_TOL}); launches {res['head_counts']}; SMPL stage "
              f"(smplcam_head, B={AXIS_ROWS}) sharded median "
              f"{statistics.median(res['stage_ms']['sharded']):.3f} ms, one process "
              f"{statistics.median(res['stage_ms']['whole']):.3f} ms on {card} (two ranks "
              "on one card, gloo through host memory: correctness, not scaling)")
        if max(err["vertices"], err["joints3d"]) > AXIS_METERS_TOL or \
                err["joints2d"] > AXIS_PX_TOL:
            faults.append(f"rank {r}: smplcam_head sharded differs from one process: {err}")
    shard_verts = axis[0]["shard"][1] - axis[0]["shard"][0]
    data = SyntheticTrainSet(AXIS_ROWS, seed + 53, smpl.to("cpu"))
    one, one_grads = axis_step(train_hparams(str(workdir / "axis_one")), smpl,
                               workdir / "weights.pt", data.get_batch(range(AXIS_ROWS)),
                               "model axis step one process")
    steps = [res["step"] for res in axis]
    for r, step in enumerate(steps):
        print(f"4n (a) rank {r}: train step at batch {AXIS_ROWS} (every row), launches "
              f"{step['counts']} at B={AXIS_ROWS}, V={shard_verts}; peak memory "
              f"{step['peak_gib']:.3f} GiB (one process: {one['peak_gib']:.3f} GiB)")
        if step["counts"].get("skinning") != TRAIN_LAUNCHES[0] or \
                step["counts"].get("skinning_backward") != TRAIN_LAUNCHES[1]:
            faults.append(f"rank {r}: the step launched {step['counts']}")
        if axis[r]["head_counts"].get("skinning") != 1:
            faults.append(f"rank {r}: smplcam_head launched {axis[r]['head_counts']}")
    faults += step_faults("4n (a)", steps, one)
    grads = {f"rank{r}": torch.load(workdir / f"axis_grad_rank{r}.pt") for r in range(len(axis))}
    faults += dist_gradient_faults(grads | {"one": one_grads}, sorted(grads), "4n (a)")
    counts = {"axis_pair": Counter()}
    for res in axis:
        counts["axis_pair"].update(res["head_counts"])
        counts["axis_pair"].update(res["step"]["counts"])
    counts["axis_one"] = Counter(one["counts"])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_grid_") as tmp:
        tmp = Path(tmp)
        start = time.perf_counter()
        grid = run_ranks(tmp, seed, GRID_WORLD, "--grid-rank", "grid_rank")
        grid_s = time.perf_counter() - start
        small = synthetic_smpl_model(num_verts=GRID_VERTS, seed=seed, device="cuda")
        data = SyntheticTrainSet(GRID_ROWS, seed + 57, small.to("cpu"))
        one, one_grads = axis_step(train_hparams(str(tmp / "grid_one"), "configs/tiny_smoke.yaml"),
                                   small, None, data.get_batch(range(GRID_ROWS)),
                                   "grid one process")
        grads = {f"rank{r}": torch.load(tmp / f"grid_grad_rank{r}.pt") for r in range(GRID_WORLD)}
    places = [(res["data_index"], res["model_index"]) for res in grid]
    print(f"4n (b) {GRID_WORLD} ranks (data, model) {places}: launches "
          f"{[res['counts'] for res in grid]} at B={GRID_ROWS // (GRID_WORLD // GRID_MODEL)}, "
          f"V={GRID_VERTS // GRID_MODEL}; {grid_s:.3f} s with start-up on {card}")
    if places != [(r // GRID_MODEL, r % GRID_MODEL) for r in range(GRID_WORLD)]:
        faults.append(f"4n (b): the grid's places are {places}")
    for r, res in enumerate(grid):
        if res["counts"].get("skinning") != TRAIN_LAUNCHES[0] or \
                res["counts"].get("skinning_backward") != TRAIN_LAUNCHES[1]:
            faults.append(f"4n (b) rank {r}: the step launched {res['counts']}")
    faults += step_faults("4n (b)", grid, one)
    faults += dist_gradient_faults(grads | {"one": one_grads}, sorted(grads), "4n (b)")
    counts["grid"] = Counter()
    for res in grid:
        counts["grid"].update(res["counts"])
    counts["grid_one"] = Counter(one["counts"])
    check(not faults, "model axis: " + "; ".join(faults))
    print(f"phase 4n: {time.perf_counter() - phase_start:.3f} s")
    return counts


# -- the demo (phase 4j) --------------------------------------------------------

DEMO_VIDEO_DIR = REPO / "tests" / "data" / "torch_video"   # 16 frames cut from FULLHD_JPEG
YOLO_SIZE, YOLO_BATCH = 416, 12       # --yolo_img_size and --tracker_batch_size defaults
YOLO_MAPS_RTOL = 1e-3     # raw maps, card fp32 vs CPU float64, relative to max(1, max |map|)
# decoded scores, and boxes (px: anchor x exp(t), up to e^10 x 373) card vs CPU fp32
YOLO_SCORE_TOL, YOLO_BOX_ATOL, YOLO_BOX_RTOL = 1e-4, 1e-2, 1e-4
YOLO_QUANTILE = 0.999     # the lowered threshold: this quantile of the first batch's scores
YOLO_TOPK = 8             # rows an image that reach NMS in the folder pass (200 by default)
OVERLAY_SHARE = 0.01      # least share of a frame a fixed in-frame camera's mesh must change
STREAM_FRAMES = 8         # frames of the webcam-replay stream, each run
DEMO_SMOKE_IMAGES = 11    # the smoke JPEGs of 4j's folder passes, YOLO_BATCH with the full-HD
#                           one (48 before 4q joined the run, 16 before 4j (e))
# cv2.imwrite (OpenCV 5.0.0) at its default quality 95 on tests/data/torch_fullhd.jpg
# as cv2 decodes it: the re-encoded file's PSNR (tests/test_torch_demo.py checks it)
FULLHD_CV2_PSNR = 45.0148
JPEG_PSNR_DB = 0.5        # the card's JPEG encoder against FULLHD_CV2_PSNR
JPEG_OVERLAY_DB = 30.0    # the demo's JPEG against the frame it encodes


def write_smpl_dir(path: Path, smpl) -> None:
    """`smpl` as the SMPL_NEUTRAL.npz + J_regressor_extra.npy that
    `resolve_smpl_params(path)` loads back unchanged (the CLI's --smpl_dir)."""
    path.mkdir(parents=True, exist_ok=True)
    arr = {f: getattr(smpl, f).cpu().numpy() for f in
           ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "faces",
            "j_regressor_extra")}
    np.savez(path / "SMPL_NEUTRAL.npz", v_template=arr["v_template"],
             shapedirs=arr["shapedirs"], posedirs=arr["posedirs"],
             J_regressor=arr["j_regressor"], weights=arr["lbs_weights"], f=arr["faces"])
    np.save(path / "J_regressor_extra.npy", arr["j_regressor_extra"])


def demo_yolo(tmp: Path, imgs: list, fullhd: int, seed: int, card: str) -> tuple[str, float]:
    """4j (a): YOLOv3 at full width from a seeded Darknet file, held to
    the CPU; returns the file and the lowered threshold."""
    print(f"-- 4j (a) YOLOv3: width 32, 80 classes, {YOLO_SIZE} px, batch {YOLO_BATCH}")
    torch.manual_seed(seed + 70)
    model = demo_yolo_module.YoloV3(32, 80).cuda().eval()
    randomize_batchnorm(model, torch.Generator().manual_seed(seed + 71))
    batch = [im for k, im in enumerate(imgs) if k != fullhd][:YOLO_BATCH - 1] + [imgs[fullhd]]
    boxed = [demo_yolo_module.letterbox(im, YOLO_SIZE, device="cuda")[0] for im in batch]
    calibrate_batchnorm(model, torch.stack(boxed).permute(0, 3, 1, 2))
    weights = tmp / "yolov3.weights"
    demo_yolo_module.save_darknet_weights(model, str(weights))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"seeded Darknet file: {n_params} parameters, {weights.stat().st_size} bytes "
          f"(BN affine randomized, statistics calibrated on {YOLO_BATCH} smoke canvases)")
    det = demo_yolo_module.YoloDetector(str(weights), img_size=YOLO_SIZE, batch_size=YOLO_BATCH)
    canvases, _ = det.letterbox_batch(batch)
    x = canvases[[0, 1, -1]].permute(0, 3, 1, 2)
    with torch.inference_mode():
        card_maps = det.model(x)
    cpu64 = demo_yolo_module.load_darknet_weights(
        str(weights), demo_yolo_module.YoloV3(32, 80)).double().eval()
    with torch.inference_mode():
        cpu_maps = cpu64(x.cpu().double())
    for i, (c, r) in enumerate(zip(card_maps, cpu_maps)):
        err = float((c.double().cpu() - r).abs().max())
        bar = YOLO_MAPS_RTOL * max(1.0, float(r.abs().max()))
        print(f"yolo map {i} {tuple(c.shape)}: card fp32 vs CPU float64 max_abs_err {err:.3e} "
              f"(tolerance {bar:.3e} = {YOLO_MAPS_RTOL} x max(1, max |map| "
              f"{float(r.abs().max()):.3f}))")
        check(err <= bar, f"YOLO map {i} disagrees with the CPU: {err}")
    boxes, scores = det.forward_decode(canvases)
    cpu_det = demo_yolo_module.YoloDetector(str(weights), img_size=YOLO_SIZE, device="cpu")
    rows = [0, 1, YOLO_BATCH - 1]   # two smoke canvases and the full-HD one
    ref_boxes, ref_scores = cpu_det.forward_decode(canvases[rows].cpu())
    s_err = float((scores[rows].cpu() - ref_scores).abs().max())
    b_diff = (boxes[rows].cpu() - ref_boxes).abs()
    b_excess = float((b_diff / (YOLO_BOX_ATOL + YOLO_BOX_RTOL * ref_boxes.abs())).max())
    print(f"decoded before the threshold ({boxes.shape[1]} rows a canvas), card vs CPU fp32 on "
          f"the card's canvases: scores {s_err:.3e} (tolerance {YOLO_SCORE_TOL}), boxes "
          f"{float(b_diff.max()):.3e} px at most, {b_excess:.3f} of the tolerance "
          f"({YOLO_BOX_ATOL} px + {YOLO_BOX_RTOL} x |CPU|; largest box side "
          f"{float(ref_boxes[..., 2:].max()):.1f} px)")
    check(s_err <= YOLO_SCORE_TOL and b_excess <= 1.0, "YOLO decode disagrees with the CPU")
    threshold = float(torch.quantile(scores.flatten().float().cpu(), YOLO_QUANTILE))
    det.conf_threshold = threshold
    kept = det.detect_batch(imgs)
    counts = [len(k) for k in kept]
    print(f"lowered conf_threshold {threshold:.6f} (the {YOLO_QUANTILE} quantile of the first "
          f"batch's scores; random weights put sigmoid(obj) x sigmoid(cls) near 0.25, under "
          f"the 0.5 default): kept boxes by image {counts} (total {sum(counts)})")
    check(all(np.isfinite(k).all() for k in kept) and sum(counts) > 0, "YOLO kept no box")

    def forward():
        det.forward_decode(canvases)

    ms = [cuda_ms(forward, iters=5, warmup=2) for _ in range(5)]
    start = time.perf_counter()
    for _ in range(3):
        det.detect_batch(batch)
    e2e = (time.perf_counter() - start) / 3
    print(f"yolo forward + decode, batch {YOLO_BATCH} at {YOLO_SIZE} px, fp32 (TF32 off): "
          f"median {statistics.median(ms):.3f} ms (min {min(ms):.3f}, max {max(ms):.3f}), "
          f"{1e3 * YOLO_BATCH / statistics.median(ms):.1f} images/s; detect_batch of "
          f"{YOLO_BATCH - 1} smoke JPEGs and the full-HD one (letterbox, NMS) {1e3 * e2e:.3f} ms, "
          f"{YOLO_BATCH / e2e:.1f} images/s; on {card}")
    return str(weights), threshold


def demo_folder(label: str, argv: list[str], images: list[str], sideview: bool,
                yolo_threshold: float | None = None):
    """One `cli.demo --mode folder` pass on the card: its results, tester
    and launches; one image an input under its name (a JPEG for a JPEG), of
    the input's width (twice with `sideview`), decoded by the port's loader."""
    args = cli_demo.parse_args(argv)
    tester = cli_demo.build_tester(args)
    if yolo_threshold is not None:
        tester.detector.conf_threshold = yolo_threshold
        # random weights score the noisy full-HD frame high everywhere: at
        # most YOLO_TOPK rows an image reach NMS, bounding the render time
        # of the synthetic SMPL's random faces
        tester.detector.pre_nms_topk = YOLO_TOPK
    reset_counts()
    start = time.perf_counter()
    results = cli_demo.run_folder(args, tester)
    seconds = time.perf_counter() - start
    counts = read_counts(label)
    for path, res in zip(images, results):
        out = Path(args.output_folder) / Path(path).name
        if not res:
            check(not out.exists(), f"{label}: {out} written for an image without boxes")
            continue
        h, w = image_loader.image_size(path)
        written = image_loader.decode_image(str(out))
        check(written.shape == (h, 2 * w if sideview else w, 3),
              f"{label}: {out} is {written.shape}, input {h}x{w}")
        check(all(np.isfinite(res[k]).all() for k in ("verts", "orig_cam", "var")),
              f"{label}: non-finite results for {path}")
    return results, tester, counts, seconds


def fixed_camera(verts: np.ndarray, h: int, w: int) -> np.ndarray:
    """An [sx, sy, tx, ty] camera that puts the mesh in the frame's middle half."""
    x, y = verts[:, 0], -verts[:, 1]
    sy = 0.5 / max(float(np.abs(y - y.mean()).max()), 1e-6)
    return np.array([sy * h / w, sy, -x.mean(), -y.mean()], np.float32)


def demo_frame_vs_cpu(tester, img: np.ndarray, res: dict) -> None:
    """One folder-mode frame held to a CPU tester with the same weights on
    the same image and boxes: the vertices (fp16-rounded on both sides)
    within METERS_TOL + one fp16 ulp, orig_cam, var and var_global within
    HEAD_TOL x max(1, |CPU|)."""
    cpu = type(tester)(copy.deepcopy(tester.model).cpu(), tester.smpl.to("cpu"),
                       kinematic_uncert=tester.kinematic_uncert).infer_frame(img, res["bboxes"])
    ulp = np.spacing(np.abs(cpu["verts"]).astype(np.float16)).astype(np.float32)
    v_err = float(np.abs(res["verts"] - cpu["verts"]).max())
    print(f"demo frame verts, card vs CPU: {v_err:.3e} m (tolerance {METERS_TOL} m + one fp16 "
          f"ulp, at most {float(ulp.max()):.3e})")
    check(bool((np.abs(res["verts"] - cpu["verts"]) <= METERS_TOL + ulp).all()),
          f"demo frame verts: card and CPU disagree by {v_err} m")
    for key in ("orig_cam", "var", "var_global"):
        err = float(np.abs(res[key] - cpu[key]).max())
        bar = HEAD_TOL * max(1.0, float(np.abs(cpu[key]).max()))
        print(f"demo frame {key}, card vs CPU: {err:.3e} (tolerance {bar:.3e})")
        check(err <= bar, f"demo frame {key}: card and CPU disagree by {err}")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    return float(10 * np.log10(255.0**2 / np.mean((a.astype(np.float64) - b) ** 2)))


def demo_jpeg(tmp: Path, frames: dict[str, np.ndarray], img: np.ndarray) -> None:
    """The folder pass's JPEG of the full-HD frame, decoded by the port's
    loader, against the frame the pass encoded (`frames`: path -> frame);
    and the card's JPEG encoder (`image_write.write_image`, nvJPEG here) on
    the decoded full-HD input against cv2.imwrite's default quality on the
    same picture (FULLHD_CV2_PSNR)."""
    from poco_tpu_torch.runtime.image_write import write_image

    check(len(frames) == 1, f"the folder pass wrote {len(frames)} full-HD frames")
    (path, frame), = frames.items()
    decoded = image_loader.decode_image(path)
    check(decoded.shape == frame.shape, f"the demo's JPEG is {decoded.shape}, not {frame.shape}")
    overlay_db = psnr(decoded, frame)
    start = time.perf_counter()
    write_image(str(tmp / "reencoded.jpg"), img)
    encode_s = time.perf_counter() - start
    reencoded_db = psnr(image_loader.decode_image(str(tmp / "reencoded.jpg")), img)
    print(f"demo JPEG ({image_loader.route()} route): {Path(path).name} with its side view "
          f"decodes to {overlay_db:.3f} dB PSNR of the rendered frame (at least "
          f"{JPEG_OVERLAY_DB}); the full-HD input re-encoded: {reencoded_db:.3f} dB against "
          f"cv2.imwrite's {FULLHD_CV2_PSNR} (within {JPEG_PSNR_DB}), "
          f"{(tmp / 'reencoded.jpg').stat().st_size} bytes, encode and write "
          f"{1e3 * encode_s:.1f} ms")
    check(overlay_db >= JPEG_OVERLAY_DB, f"the demo's JPEG is {overlay_db} dB off its frame")
    check(abs(reencoded_db - FULLHD_CV2_PSNR) <= JPEG_PSNR_DB,
          f"the JPEG encoder's {reencoded_db} dB is not within {JPEG_PSNR_DB} of cv2's")


def stage_split(tester, n: int, unit: str) -> str:
    return ", ".join(f"{k} {1e3 * v / n:.3f} ms" for k, v in sorted(tester.stage_seconds.items())
                     ) + f" a {unit}"


def phase_demo(ctx: dict, seed: int, card: str) -> tuple[dict[str, Counter], float]:
    """Phase 4j: the demo on the card (see the module docstring). Returns
    each run's launches and the skinning kernel's largest error against
    its plain version at the batches the demo launched it with."""
    import shutil
    import tempfile

    print("== 4j. the demo: YOLOv3, cli.demo folder and video modes")
    phase_start = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    folder = tmp / "images"
    folder.mkdir()
    for p in [*sorted(SMOKE_DIR.glob("*.jpg"))[:DEMO_SMOKE_IMAGES], FULLHD_JPEG]:
        shutil.copy(p, folder)
    images = images_in_folder(str(folder))   # the CLI's order
    fullhd = images.index(str(folder / FULLHD_JPEG.name))
    imgs = image_loader.read_images_rgb(images)
    mark("4j's image read (nvJPEG decodes on 8 threads)")
    weights, threshold = demo_yolo(tmp, imgs, fullhd, seed, card)
    mark("4j (a)")

    write_smpl_dir(tmp / "smpl", ctx["smpl"])
    torch.save(ctx["model"].state_dict(), tmp / "poco_cliff.pt")
    base = ["--cfg", str(REPO / "configs/poco_cliff.yaml"), "--ckpt", str(tmp / "poco_cliff.pt"),
            "--smpl_dir", str(tmp / "smpl")]
    counts, batches = {}, {1}

    print(f"-- 4j (b) cli.demo --mode folder over {len(images)} JPEGs ({DEMO_SMOKE_IMAGES} of "
          f"the smoke set and {FULLHD_JPEG.name}), POCO-CLIFF at full width, SMPL V=6890")
    # the full-HD frame as the folder pass hands it to the writer
    from poco_tpu_torch.demo import tester as tester_module

    written, write = {}, tester_module.write_image

    def keeping(path, frame):
        if Path(path).name == FULLHD_JPEG.name:
            written[path] = frame.copy()
        write(path, frame)

    tester_module.write_image = keeping
    try:
        refine, tester, counts["demo_folder_refine"], refine_s = demo_folder(
            "demo folder refine",
            base + ["--image_folder", str(folder), "--output_folder", str(tmp / "refine"),
                    "--sideview", "--save_obj"], images, sideview=True)
    finally:
        tester_module.write_image = write
    check(tester.model.cfg.backbone == "hrnet_w48_cls-cliff"
          and tester.smpl.v_template.shape[0] == 6890, "the demo did not run POCO-CLIFF at V=6890")
    # mixed sizes: the refine detector runs one dispatch a frame, then one a frame to infer
    expected = 2 * len(images)
    print(f"--detector refine --sideview --save_obj: {len(refine)} images, launches "
          f"{dict(counts['demo_folder_refine'])} (expected skinning {expected}: a refine "
          f"dispatch and an inference a frame); {len(list((tmp / 'refine').glob('*.obj')))} OBJs; "
          f"{len(images) / refine_s:.2f} frames/s; {stage_split(tester, len(images), 'frame')} "
          f"on {card}")
    check(counts["demo_folder_refine"]["skinning"] == expected, "folder refine launches")
    i = fullhd
    res = refine[i]
    h, w = imgs[i].shape[:2]
    cam = fixed_camera(res["verts"][0], h, w)
    drawn = tester.renderer.render(imgs[i], res["verts"][0], cam,
                                   vertex_colors=tester._vertex_colors(res["var"][0]))
    share = float((np.abs(drawn.astype(int) - imgs[i]).max(axis=2) > 0).mean())
    print(f"fixed in-frame camera {cam.round(4).tolist()} on {FULLHD_JPEG.name}: the overlay "
          f"changes {share:.4f} of the frame (at least {OVERLAY_SHARE}); the predicted camera "
          f"{res['orig_cam'][0].round(4).tolist()}")
    check(share >= OVERLAY_SHARE, "the fixed-camera overlay drew nothing")
    demo_frame_vs_cpu(tester, imgs[i], res)
    demo_jpeg(tmp, written, imgs[i])

    yolo_res, tester, counts["demo_folder_yolo"], yolo_s = demo_folder(
        "demo folder yolo",
        base + ["--image_folder", str(folder), "--output_folder", str(tmp / "yolo"),
                "--detector", "yolo", "--yolo_weights", weights], images, sideview=False,
        yolo_threshold=threshold)
    boxes = [len(r.get("bboxes", [])) for r in yolo_res]
    batches |= {b for b in boxes if b}
    expected = sum(1 for b in boxes if b)
    print(f"--detector yolo (threshold {threshold:.6f}, pre_nms_topk {YOLO_TOPK}): boxes by "
          f"image {boxes}, launches "
          f"{dict(counts['demo_folder_yolo'])} (expected skinning {expected}: one a frame "
          f"with boxes); {len(images) / yolo_s:.2f} frames/s; "
          f"{stage_split(tester, len(images), 'frame')} on {card}")
    check(counts["demo_folder_yolo"]["skinning"] == expected, "folder yolo launches")
    mark("4j (b)")

    frames = sorted(DEMO_VIDEO_DIR.glob("*.jpg"))
    print(f"-- 4j (c) cli.demo --mode video --smooth over {len(frames)} frames of "
          f"{DEMO_VIDEO_DIR.relative_to(REPO)} (960x540 crops of {FULLHD_JPEG.name}, shifting); "
          f"ffmpeg on PATH: {shutil.which('ffmpeg') is not None}")
    args = cli_demo.parse_args(base + ["--mode", "video", "--image_folder", str(DEMO_VIDEO_DIR),
                                       "--output_folder", str(tmp / "video"), "--smooth"])
    tester = cli_demo.build_tester(args)
    reset_counts()
    start = time.perf_counter()
    video = cli_demo.run_video(args, tester)
    video_s = time.perf_counter() - start
    counts["demo_video"] = read_counts("demo video")
    lengths = [len(r["frame_ids"]) for r in video.values()]
    expected, why = video_launches(tester, frames, lengths, args.batch_size)
    batches |= {8, len(frames) % 8 or 8} | set(lengths) | {
        min(args.batch_size, n - s) for n in lengths for s in range(0, n, args.batch_size)}
    rendered = sorted((tmp / "video" / "rendered").glob("*.png"))
    log = (tmp / "video" / "uncertainty.log").read_text().splitlines()
    print(f"video: tracks of {lengths} frames; launches {dict(counts['demo_video'])} (expected "
          f"skinning {expected}: {why}); {len(rendered)} frames rendered; {len(log)} log lines; "
          f"{len(frames) / video_s:.2f} frames/s; {stage_split(tester, len(frames), 'frame')} "
          f"on {card}")
    check(counts["demo_video"]["skinning"] == expected, "video launches")
    check(len(rendered) == len(frames) and len(log) == sum(lengths), "video outputs")
    check(all(np.isfinite(r["verts"]).all() for r in video.values()), "video verts not finite")
    mark("4j (c)")
    video_tester = tester

    print(f"-- 4j (d) cli.demo --mode webcam over the first {STREAM_FRAMES} frames of "
          f"{DEMO_VIDEO_DIR.relative_to(REPO)} (a replayed camera), --smooth, pipelined and "
          f"--stream_sequential")
    streams = {}
    tester = None
    for label, flags in (("pipelined", []), ("sequential", ["--stream_sequential"])):
        args = cli_demo.parse_args(base + [
            "--mode", "webcam", "--webcam_source", str(DEMO_VIDEO_DIR), "--smooth",
            "--max_frames", str(STREAM_FRAMES), "--output_folder", str(tmp / f"stream_{label}"),
            *flags])
        tester = tester or cli_demo.build_tester(args)   # one tester for both runs
        reset_counts()
        stats = cli_demo.run_webcam(args, tester)
        counts[f"demo_stream_{label}"] = read_counts(f"demo stream {label}")
        written = {p.name: p.read_bytes() for p in sorted((tmp / f"stream_{label}").glob("*.png"))}
        streams[label] = written
        print(f"stream {label}: {json.dumps(stats)}; launches "
              f"{dict(counts[f'demo_stream_{label}'])} (expected skinning {2 * STREAM_FRAMES}: a "
              f"refine dispatch and an inference a frame) on {card}")
        check(stats["frames"] == STREAM_FRAMES and len(written) == STREAM_FRAMES,
              f"stream {label}: {stats['frames']} frames, {len(written)} written")
        check(counts[f"demo_stream_{label}"]["skinning"] == 2 * STREAM_FRAMES,
              f"stream {label} launches")
    same = streams["pipelined"] == streams["sequential"]
    print(f"stream: the pipelined and the sequential runs' {STREAM_FRAMES} frames "
          f"{'are' if same else 'are NOT'} bit-identical")
    check(same, "the pipelined stream differs from the sequential one")
    mark("4j (d)")
    counts.update(demo_live_sources(tmp, base, video_tester, video, tester,
                                    streams["pipelined"], card))
    mark("4j (e)")
    counts.update(demo_drawing(tmp, tester, base, card))   # phase 4o

    # the kernel at the batches the demo launched it with, beside phase 3's
    worst = 0.0
    for batch in sorted(batches - {b for b, v in SKIN_SHAPES if v == 6890}):
        args_ = skinning_inputs(batch, 6890, seed=batch)
        err = float((skinning(*args_) - skinning_reference(*args_)).abs().max())
        print(f"skinning v2 B={batch} V=6890 (a demo batch): max_abs_err {err:.3e} "
              f"(tolerance {SKIN_TOL})")
        check(err <= SKIN_TOL, f"skinning disagrees with its plain version at B={batch}")
        worst = max(worst, err)
    tmp_dir.cleanup()
    print(f"phase 4j: {time.perf_counter() - phase_start:.3f} s")
    return counts, worst


def video_launches(tester, frames: list, lengths: list[int], batch_size: int) -> tuple[int, str]:
    """`skinning` launches of a `cli.demo --mode video --smooth` run with
    the refine detector over `frames`, whose tracks have `lengths` frames,
    and how they add up."""
    warm = len(tester.warmup_sizes(image_loader.image_size(str(frames[0]))))
    tracking = math.ceil(len(frames) / 8)   # refine: 8 frames a dispatch
    chunks = sum(math.ceil(n / batch_size) for n in lengths)
    return warm + tracking + chunks + len(lengths), (
        f"{warm} warm-up forwards, {tracking} tracking dispatches, {chunks} chunks of "
        f"{batch_size}, {len(lengths)} smoothed tracks")


def printed(fn, *args) -> tuple[object, str]:
    """`fn(*args)` and what it printed (printed here too)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    print(out.getvalue(), end="")
    return result, out.getvalue()


DISPLAY_NOTICE = "--display requested but no GUI backend; skipping"   # the JAX tester's
MASKRCNN_NOTICE = ("--detector maskrcnn: torchvision (or its pretrained weights) is unavailable "
                   "in this environment; falling back to --detector yolo (TPU-native).")


@contextlib.contextmanager
def without_cv2():
    """cv2 unimportable inside the block, as on a host without it (this
    one may have it): the port then takes its Motion-JPEG routes."""
    kept = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if kept is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = kept


def demo_live_sources(tmp: Path, base: list[str], video_tester, video: dict, stream_tester,
                      stream_pngs: dict[str, bytes], card: str) -> dict[str, Counter]:
    """4j (e): the demo's video file and stream routes where neither cv2
    nor ffmpeg is (Motion-JPEG, `utils/mjpeg.py`; cv2 hidden where the
    host has it), on (c)'s and (d)'s testers: `--vid_file clip.avi`
    against (c), an HTTP Motion-JPEG stream on loopback (with `--display`)
    against (d)'s pipelined run, `--detector maskrcnn`, and a camera index
    without cv2 and, where the host has cv2, with it."""
    from poco_tpu_torch.utils.demo_utils import optional_cv2

    cv2 = optional_cv2()
    print(f"cv2 on this host: {cv2.__version__ if cv2 else 'does not import'}; hidden for the "
          f"Motion-JPEG routes")
    with without_cv2():
        counts = motion_jpeg_routes(tmp, base, video_tester, video, stream_tester, stream_pngs,
                                    card)
    if cv2 is not None:   # the JAX package's route: no camera on this host
        args = cli_demo.parse_args(base + ["--mode", "webcam", "--webcam_source", "0"])
        try:
            cli_demo.run_webcam(args, stream_tester)
            raised = "nothing"
        except RuntimeError as err:
            raised = str(err)
        print(f"--webcam_source 0 with cv2 {cv2.__version__}: {raised}")
        check(raised.startswith("cannot open video capture 0"),
              "a camera index with cv2 did not raise the JAX package's error")
    return counts


def motion_jpeg_routes(tmp: Path, base: list[str], video_tester, video: dict, stream_tester,
                       stream_pngs: dict[str, bytes], card: str) -> dict[str, Counter]:
    import shutil

    from poco_tpu_torch.utils import mjpeg

    frames = sorted(DEMO_VIDEO_DIR.glob("*.jpg"))
    data = [p.read_bytes() for p in frames]
    h, w = image_loader.image_size(str(frames[0]))
    clip = tmp / "clip.avi"
    mjpeg.write_avi_mjpeg(str(clip), data, 25, (w, h))
    print(f"-- 4j (e) Motion-JPEG: {clip.name} ({len(data)} JPEGs of "
          f"{DEMO_VIDEO_DIR.relative_to(REPO)} stored unchanged, {clip.stat().st_size} bytes, "
          f"header {mjpeg.avi_frame_size(str(clip))}); ffmpeg on PATH: "
          f"{shutil.which('ffmpeg') is not None}")
    check(shutil.which("ffmpeg") is None,
          "4j (e) holds the Motion-JPEG route, taken only where ffmpeg is not on PATH")
    counts = {}

    args = cli_demo.parse_args(base + ["--mode", "video", "--vid_file", str(clip),
                                       "--output_folder", str(tmp / "video_avi"), "--smooth"])
    reset_counts()
    start = time.perf_counter()
    got = cli_demo.run_video(args, video_tester)
    seconds = time.perf_counter() - start
    counts["demo_video_avi"] = read_counts("demo video avi")
    extracted = sorted((tmp / "video_avi" / f"frames_{clip.stem}").glob("*.jpg"))
    same_files = [p.read_bytes() for p in extracted] == data
    lengths = [len(r["frame_ids"]) for r in got.values()]
    expected, why = video_launches(video_tester, frames, lengths, args.batch_size)
    differ = sorted(f"{pid}/{key}" for pid in video for key in video[pid]
                    if pid not in got or key not in got[pid]
                    or np.asarray(got[pid][key]).tobytes() != np.asarray(video[pid][key]).tobytes())
    rendered = sorted((tmp / "video_avi" / "rendered").glob("*.png"))
    written = tmp / "video_avi" / f"{clip.stem}_poco.avi"
    read_back = len(list(mjpeg.read_avi_mjpeg(str(written)))) if written.exists() else 0
    print(f"--vid_file {clip.name}: {len(extracted)} frames extracted, "
          f"{'byte-equal to' if same_files else 'NOT equal to'} the sources; tracks of "
          f"{lengths} frames; launches {dict(counts['demo_video_avi'])} (expected skinning "
          f"{expected}: {why}); results against (c)'s: "
          f"{'every key bitwise equal' if got.keys() == video.keys() and not differ else differ}; "
          f"{written.name} reads back {read_back} frames of {len(rendered)} rendered; "
          f"{len(frames) / seconds:.2f} frames/s with extraction on {card}")
    check(same_files, "the extracted frames differ from the sources")
    check(counts["demo_video_avi"]["skinning"] == expected, "video avi launches")
    check(got.keys() == video.keys() and not differ, f"the AVI's results differ from (c)'s: {differ}")
    check(read_back == len(rendered) == len(frames), "the written AVI does not read back")

    with mjpeg.MjpegHttpServer(data[:STREAM_FRAMES]) as server:
        args = cli_demo.parse_args(base + [
            "--mode", "webcam", "--webcam_source", server.url, "--smooth", "--display",
            "--max_frames", str(STREAM_FRAMES), "--output_folder", str(tmp / "stream_http")])
        reset_counts()
        stats, out = printed(cli_demo.run_webcam, args, stream_tester)
        counts["demo_stream_http"] = read_counts("demo stream http")
    pngs = {p.name: p.read_bytes() for p in sorted((tmp / "stream_http").glob("*.png"))}
    print(f"stream {server.url} --display: {json.dumps(stats)}; launches "
          f"{dict(counts['demo_stream_http'])} (expected skinning {2 * STREAM_FRAMES}); "
          f"{len(pngs)} frames, {'bitwise equal to' if pngs == stream_pngs else 'NOT equal to'} "
          f"(d)'s pipelined run; the display notice printed {out.count(DISPLAY_NOTICE)} times "
          f"on {card}")
    check(pngs == stream_pngs and len(pngs) == STREAM_FRAMES, "the HTTP stream's frames differ")
    check(counts["demo_stream_http"]["skinning"] == 2 * STREAM_FRAMES, "stream http launches")
    check(out.count(DISPLAY_NOTICE) == 1, "--display did not print its notice once")

    args = cli_demo.parse_args(base + ["--detector", "maskrcnn"])
    _, out = printed(cli_demo.build_tester, args)
    print(f"--detector maskrcnn: ran as --detector {args.detector}")
    check(MASKRCNN_NOTICE in out and args.detector == "refine", "maskrcnn did not fall back")
    args = cli_demo.parse_args(base + ["--mode", "webcam", "--webcam_source", "0"])
    try:
        cli_demo.run_webcam(args, stream_tester)
        raised = "nothing"
    except RuntimeError as err:
        raised = str(err)
    print(f"--webcam_source 0: {raised}")
    check("needs cv2.VideoCapture" in raised, "a camera index did not raise naming cv2")
    return counts


DRAW_FRAMES = 4           # frames of phase 4o's video runs (the first of DEMO_VIDEO_DIR; 8
#                           before 4j (e))
POSE_PEOPLE = 2           # seeded keypoint tracks of 4o's pose-tracking run
CAPTION = "Other View"
CAPTION_REFERENCE = REPO / "tests" / "data" / "torch_caption_cv2.npz"   # cv2's, 540 and 1080
CAPTION_SHARE = 0.005     # at most this share of the caption box's pixels differ from cv2's,
CAPTION_LEVELS = 1        # none by more than this many grey levels


def write_posetrack(folder: Path, frames: int, h: int, w: int, seed: int) -> None:
    """OpenPose/STAF posetrack JSON, one file a frame: POSE_PEOPLE people
    (ids 0, 1, ...), 21 joints each, drifting about two places in the
    frame, confidences in [0.5, 1]."""
    rng = np.random.RandomState(seed)
    folder.mkdir(parents=True, exist_ok=True)
    base = [rng.uniform([0.2 * w, 0.2 * h], [0.8 * w, 0.8 * h], (21, 2))
            for _ in range(POSE_PEOPLE)]
    for t in range(frames):
        people = []
        for pid, joints in enumerate(base):
            xy = joints + rng.uniform(-4, 4, joints.shape)
            kp = np.concatenate([xy, rng.uniform(0.5, 1.0, (21, 1))], 1)
            people.append({"person_id": [pid], "pose_keypoints_2d": kp.ravel().tolist()})
        with open(folder / f"frame_{t:012d}_keypoints.json", "w") as f:
            json.dump({"version": 1.3, "people": people}, f)


def demo_drawing(tmp: Path, tester, base: list[str], card: str) -> dict[str, Counter]:
    """Phase 4o: the demo's drawing flags and pose tracking with one
    POCO-CLIFF tester on the card. (i) Folder mode with `--draw_keypoints`
    (and `--wireframe`, which the folder mode takes and does not use, as
    demo.py) over the full-HD frame and 3 smoke JPEGs: every projected
    joint in the frame is the keypoint colour in the frame handed to the
    writer; (ii) video mode with `--sideview --wireframe` over the first
    DRAW_FRAMES frames of DEMO_VIDEO_DIR: frames twice the width, the
    side view's caption equal to cv2's (CAPTION_REFERENCE) within
    CAPTION_SHARE and CAPTION_LEVELS, its box exactly; the wireframe of a
    fixed in-frame camera changes the frame; (iii) video mode with
    `--tracking_method pose` over the same frames and seeded posetrack
    JSON: a track a person over every frame, one inference a track. Each
    run's launches, and its render time a frame."""
    from poco_tpu_torch.demo import tester as tester_module

    print("== 4o. the demo's drawing flags and pose tracking: --draw_keypoints, video-mode "
          "--sideview --wireframe, --tracking_method pose (cli.demo, POCO-CLIFF at full width)")
    phase_start = time.perf_counter()
    # the frames as the tester hands them to its writers (the card's host
    # decodes JPEG only, and the video mode writes PNG)
    written, write_image, write_png = {}, tester_module.write_image, tester_module.write_png

    def keeping(write):
        def keep(path, frame):
            written[Path(path).name] = frame.copy()
            write(path, frame)
        return keep

    tester_module.write_image = keeping(write_image)
    tester_module.write_png = keeping(write_png)
    try:
        counts = drawn_runs(tmp, tester, base, written, card)
    finally:
        tester_module.write_image, tester_module.write_png = write_image, write_png
    print(f"phase 4o: {time.perf_counter() - phase_start:.3f} s")
    return counts


def drawn_runs(tmp: Path, tester, base: list[str], written: dict, card: str
               ) -> dict[str, Counter]:
    """Phase 4o's three runs (see `demo_drawing`); `written` collects the
    frames the tester writes, by file name."""
    import shutil

    from poco_tpu_torch.viz.text import get_text_size

    counts = {}
    folder = tmp / "draw_images"
    folder.mkdir()
    for p in [FULLHD_JPEG, *sorted(SMOKE_DIR.glob("*.jpg"))[:3]]:
        shutil.copy(p, folder)
    args = cli_demo.parse_args(base + ["--image_folder", str(folder), "--output_folder",
                                       str(tmp / "draw_out"), "--draw_keypoints", "--wireframe"])
    tester.stage_seconds.clear()
    reset_counts()
    results = cli_demo.run_folder(args, tester)
    counts["demo_keypoints"] = read_counts("demo keypoints")
    names = [Path(p).name for p in images_in_folder(str(folder))]
    marked = total = 0
    for name, res in zip(names, results):
        frame = written[name]
        h, w = frame.shape[:2]
        for person in np.atleast_3d(res["smpl_joints2d"]):
            for x, y in np.trunc(person[:, :2]).astype(int):
                if 0 <= x < w and 0 <= y < h:
                    total += 1
                    marked += bool((frame[y, x] == (0, 255, 0)).all())
    print(f"4o (i) folder --draw_keypoints over {len(names)} images: {marked} of {total} "
          f"in-frame joints drawn in the keypoint colour; launches "
          f"{dict(counts['demo_keypoints'])} (expected skinning {2 * len(names)}); "
          f"{stage_split(tester, len(names), 'frame')} on {card}")
    check(total > 0 and marked == total, "--draw_keypoints: joints not drawn")
    check(counts["demo_keypoints"]["skinning"] == 2 * len(names), "keypoints launches")

    video = tmp / "draw_video"
    video.mkdir()
    frames = sorted(DEMO_VIDEO_DIR.glob("*.jpg"))[:DRAW_FRAMES]
    for p in frames:
        shutil.copy(p, video)
    h, w = image_loader.image_size(str(frames[0]))
    args = cli_demo.parse_args(base + ["--mode", "video", "--image_folder", str(video),
                                       "--output_folder", str(tmp / "side_out"), "--sideview",
                                       "--wireframe"])
    tester.stage_seconds.clear()
    reset_counts()
    side = cli_demo.run_video(args, tester)
    counts["demo_sideview"] = read_counts("demo sideview")
    rendered = sorted((tmp / "side_out" / "rendered").glob("*.png"))
    out = written[rendered[0].name]
    tw, th = get_text_size(CAPTION, h * 0.0016, max(int(h * 0.005), 1))
    off, x0, y0 = int(h * 0.01), int(w * 0.02), int(h * 0.06)
    reference = np.load(CAPTION_REFERENCE)
    ref_box, ref = reference[f"box_{h}"], reference[f"caption_{h}"]
    box = out[y0 - th - off:y0 + off + 1, w + x0:w + x0 + tw + off + 1]
    box_equal = [x0, y0 - th - off, x0 + tw + off, y0 + off] == ref_box.tolist()
    diff = np.abs(box.astype(int) - ref).max(-1) if box.shape == ref.shape else None
    lengths = [len(r["frame_ids"]) for r in side.values()]
    warm = len(tester.warmup_sizes((h, w)))   # `cli.demo.run_video` warms the tester up first
    expected = warm + math.ceil(DRAW_FRAMES / 8) + sum(
        math.ceil(n / args.batch_size) for n in lengths)
    print(f"4o (ii) video --sideview --wireframe over {DRAW_FRAMES} frames: {len(rendered)} "
          f"frames of {out.shape[1]}x{out.shape[0]}; the caption's box {box.shape[1]}x"
          f"{box.shape[0]} {'equals' if box_equal else 'differs from'} cv2's, "
          f"{'-' if diff is None else int((diff > 0).sum())} of its pixels differ from cv2's "
          f"(at most {'-' if diff is None else int(diff.max())} levels; bar "
          f"{CAPTION_SHARE} of them, {CAPTION_LEVELS} level); launches "
          f"{dict(counts['demo_sideview'])} (expected skinning {expected}); "
          f"{stage_split(tester, DRAW_FRAMES, 'frame')} on {card}")
    check(len(rendered) == DRAW_FRAMES and out.shape == (h, 2 * w, 3), "sideview frames")
    check(box_equal and diff is not None and (diff > 0).mean() <= CAPTION_SHARE
          and diff.max() <= CAPTION_LEVELS, "the side view's caption is not cv2's")
    check(counts["demo_sideview"]["skinning"] == expected, "sideview launches")
    res = next(iter(side.values()))
    img = image_loader.read_image_rgb(str(frames[int(res["frame_ids"][0])]))
    cam = fixed_camera(res["verts"][0], h, w)
    for wire in (False, True):
        start = time.perf_counter()
        drawn = tester.renderer.render(img, res["verts"][0], cam, wireframe=wire)
        took = time.perf_counter() - start
        share = float((np.abs(drawn.astype(int) - img).max(axis=2) > 0).mean())
        print(f"4o (ii) {'wireframe' if wire else 'filled'} render of a fixed in-frame camera "
              f"on a {w}x{h} frame: {1e3 * took:.3f} ms, {share:.4f} of the frame changed")
        check(share >= OVERLAY_SHARE / 4, "the fixed-camera render drew nothing")

    write_posetrack(tmp / "pose_out" / "posetrack", DRAW_FRAMES, h, w, seed=7)
    args = cli_demo.parse_args(base + ["--mode", "video", "--image_folder", str(video),
                                       "--output_folder", str(tmp / "pose_out"),
                                       "--tracking_method", "pose"])
    tester.stage_seconds.clear()
    reset_counts()
    tracks = cli_demo.run_video(args, tester)
    counts["demo_pose"] = read_counts("demo pose")
    lengths = {pid: len(r["frame_ids"]) for pid, r in tracks.items()}
    rendered = sorted((tmp / "pose_out" / "rendered").glob("*.png"))
    expected = warm + sum(math.ceil(n / args.batch_size) for n in lengths.values())
    print(f"4o (iii) --tracking_method pose over {DRAW_FRAMES} frames: tracks {lengths}; "
          f"launches {dict(counts['demo_pose'])} (expected skinning {expected}: {warm} warm-up "
          f"forwards, no detector, one chunk a track); {len(rendered)} frames rendered; "
          f"{stage_split(tester, DRAW_FRAMES, 'frame')} on {card}")
    check(sorted(lengths) == list(range(POSE_PEOPLE))
          and all(n == DRAW_FRAMES for n in lengths.values()), "pose tracks")
    check(all(np.isfinite(r["verts"]).all() for r in tracks.values()), "pose verts not finite")
    check(counts["demo_pose"]["skinning"] == expected and len(rendered) == DRAW_FRAMES,
          "pose launches / frames")
    return counts


CROP_BOXES = (8, 128)     # phase 4p: the demo's boxes of a frame, and a large batch
MXU_CROP_TOL = 1e-2       # phase 4p: matmul crop vs gather, in grey levels (JAX's own bar,
                          # tests/test_preprocess.py; measured 3.4e-3 on the card)


def phase_crop(seed: int, card: str) -> None:
    """Phase 4p: `crop_and_resize_mxu` (two fp32 products) against the
    gather of `crop_and_resize` on the full-HD frame (on the card, uint8)
    at the demo's crop size: the largest difference in grey levels, within
    MXU_CROP_TOL, JAX's own bar between its two crops (the two place a
    sample from fp32 coordinates up to 1920 px computed in another order:
    ~1e-5 px, times a pixel step of up to 255 levels), and both times
    (CUDA events)."""
    from poco_tpu_torch.ops.preprocess import crop_and_resize, crop_and_resize_mxu

    print("== 4p. the matmul crop against the gather, 224 px crops of the full-HD frame")
    img = torch.from_numpy(image_loader.read_image_rgb(str(FULLHD_JPEG))).cuda()
    h, w = img.shape[:2]
    rng = np.random.RandomState(seed + 61)
    for boxes in CROP_BOXES:
        centers, scales = random_boxes(rng, boxes, h, w)
        c = torch.from_numpy(centers).cuda()
        s = torch.from_numpy(scales * 200.0).cuda()
        gather = crop_and_resize(img, c, s)
        mxu = crop_and_resize_mxu(img, c, s)
        diff = float((gather - mxu).abs().max())
        gather_ms = cuda_ms(lambda: crop_and_resize(img, c, s), iters=20)
        mxu_ms = cuda_ms(lambda: crop_and_resize_mxu(img, c, s), iters=20)
        print(f"crop {boxes} boxes of {w}x{h}: largest difference {diff:.3e} grey levels "
              f"(tolerance {MXU_CROP_TOL}); gather {gather_ms:.4f} ms, matmul {mxu_ms:.4f} ms a "
              f"call on {card}")
        check(mxu.shape == gather.shape and diff <= MXU_CROP_TOL, "the matmul crop differs")


def timed_requests(run, reps: int) -> list[float]:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    return times


def print_times(label: str, batch: int, ts: list[float], card: str,
                precision: str = "fp32") -> None:
    med = statistics.median(ts)
    print(f"throughput {precision}, batch {batch}, {label}, {len(ts)} requests: "
          f"median {med * 1e3:.3f} ms (min {min(ts) * 1e3:.3f}, "
          f"max {max(ts) * 1e3:.3f}) = {batch / med:.1f} crops/s on {card}")


def phase_throughput(ctx: dict, pare: dict, reps: int, card: str) -> None:
    """Request time of POCO-CLIFF's `detect_forward` at 1 and 8 boxes, and
    crops/s at batch 128. POCO-CLIFF: the plain skinning swapped into the
    SMPL stage is timed in turns (kernel, plain, plain, kernel) as its
    yardstick. POCO-PARE: with the kernel, at least 10 requests."""
    print("== 5. throughput")
    for c, s in ctx["requests"][:2]:   # the 1- and 8-box requests of phase 4
        def run_small(c=c, s=s):
            detect_forward(ctx["model"], ctx["smpl"], ctx["image"], c, s)

        for _ in range(3):
            run_small()
        print_times("POCO-CLIFF detect_forward request, skinning kernel", len(c),
                    timed_requests(run_small, max(10, reps)), card)
    c, s = ctx["request"]

    def run():
        detect_forward(ctx["model"], ctx["smpl"], ctx["image"], c, s)

    for _ in range(3):
        run()
    times = {"kernel": [], "plain": []}
    for turn in ("kernel", "plain", "plain", "kernel"):
        if turn == "plain":
            lbs_module.skinning = skinning_reference
        try:
            times[turn] += timed_requests(run, max(1, reps // 2))
        finally:
            lbs_module.skinning = skinning
    for turn, ts in times.items():
        print_times(f"POCO-CLIFF, skinning {turn}", len(c), ts, card)

    pc, ps = pare["request"]

    def run_pare():
        detect_forward(pare["model"], ctx["smpl"], ctx["image"], pc, ps)

    for _ in range(3):
        run_pare()
    print_times("POCO-PARE, skinning kernel", len(pc), timed_requests(run_pare, max(10, reps)),
                card)


def launched_us(event) -> float:
    """Device time of the kernels launched under a CPU event of a profile,
    its children's included (profiler ranges mirrored on the device are
    not kernels and are left out)."""
    return (sum(k.duration for k in event.kernels if not is_range(k.name))
            + sum(launched_us(c) for c in event.cpu_children))


def staged_us(prof, stages) -> dict[str, float]:
    """Device time of the kernels launched inside each profiler range of
    `stages`. The eval step's ranges hold their ops as children; a train
    step's backward runs on autograd's own threads, so there each kernel
    goes to the range whose host time window holds its launching op."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    out = {name: 0.0 for name in stages}
    if stages == EVAL_STAGES:
        for e in events:
            if e.name in out:
                out[e.name] += launched_us(e)
        return out
    windows = [(e.time_range.start, e.time_range.end, e.name) for e in events if e.name in out]
    for e in events:
        kernels = [k for k in e.kernels if not is_range(k.name)]
        if not kernels:
            continue
        for start, end, name in windows:
            if start <= e.time_range.start <= end:
                out[name] += sum(k.duration for k in kernels)
                break
    return out


# device kernel names of each wrapper (the backward's two kernels overlap
# under programmatic dependent launch, so their spans are merged)
SKIN_KERNELS = {"skinning": ("skin_tc_kernel",),
                "skinning_backward": ("grad_tc_kernel", "reduce_tiles")}


def merged_us(spans) -> float:
    """Time covered by (start, end) spans, overlaps counted once."""
    total, end = 0.0, float("-inf")
    for s0, s1 in sorted(spans):
        total += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
    return total


PROFILE_CALLS = 1   # profiled calls a run in phase 6 (3 before 4q joined the run, 2 before 4r
#                     did: the time limit)


def profile_request(label: str, run, card: str, stages=EVAL_STAGES) -> None:
    """Device busy and idle share, ops, the skinning kernels' share and the
    top device kernels of `run` (one request, eval step or train step),
    over PROFILE_CALLS calls; for the eval and train steps, their device
    time by profiler range (`EVAL_STAGES`, `TRAIN_STAGES`)."""
    from torch.profiler import ProfilerActivity, profile

    n = PROFILE_CALLS
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not is_range(e.name)
    )
    if not spans:
        print(f"{label} device time: not measured (the profiler recorded no device events)")
        return
    busy = merged_us((s0, s1) for s0, s1, _ in spans)
    by_name = {}
    for s0, s1, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (s1 - s0)
    print(f"{label}: device busy {busy / n / 1e3:.3f} ms a call of "
          f"{wall_us / n / 1e3:.3f} ms wall: busy share {busy / wall_us:.4f}, "
          f"idle share {1 - busy / wall_us:.4f}, on {card}")
    for kernel, marks in SKIN_KERNELS.items():
        t = merged_us((s0, s1) for s0, s1, name in spans if any(m in name for m in marks))
        if t > 0:
            print(f"{label}: {kernel} kernel {t / n / 1e3:.4f} ms a call = "
                  f"{t / busy:.5f} of device time")
    print(f"{label}: {len(spans) // n} device ops a call")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {t / busy:7.4f}  {t / n / 1e3:9.4f} ms  {name[:100]}")
    staged = staged_us(prof, stages)
    total = sum(staged.values())
    if total > 0:
        print(f"{label}: device time by stage (kernels launched in each profiler range), "
              f"{total / n / 1e3:.3f} ms a call in all:")
        for name, t in staged.items():
            if t > 0:
                print(f"  {name:20s} {t / n / 1e3:9.4f} ms = {t / total:.4f}")


def phase_profile(ctx: dict, pare: dict, evaluation: dict, train: dict, images: dict,
                  card: str) -> None:
    """Where a 128-crop request spends device time (torch.profiler), for
    POCO-CLIFF and POCO-PARE, the SMPL stage alone, one eval step on a
    batch of 64 with flip-TTA off and on, and one train step at batch 64
    of each POCO model (device-side batches, without the loader), and the
    POCO-CLIFF step again while the loader decodes full-HD batches beside
    it (its device time then includes the loader's own, on the card's
    decoder route)."""
    print("== 6. profile: one 128-crop request")
    c, s = ctx["request"]
    smpl = ctx["smpl"]
    rot = axis_angle_to_rotmat(0.3 * torch.randn(len(c), 24, 3, device="cuda"))
    betas = torch.randn(len(c), 10, device="cuda")
    stage_ms = cuda_ms(lambda: smpl_forward(smpl, betas, rot), iters=20)
    lbs_module.skinning = skinning_reference
    try:
        stage_plain_ms = cuda_ms(lambda: smpl_forward(smpl, betas, rot), iters=20)
    finally:
        lbs_module.skinning = skinning
    print(f"SMPL stage (smpl_forward, B={len(c)}, V=6890): {stage_ms:.4f} ms with the "
          f"kernel, {stage_plain_ms:.4f} ms with the plain skinning")
    profile_request(
        "POCO-CLIFF", lambda: detect_forward(ctx["model"], smpl, ctx["image"], c, s), card
    )
    pc, ps = pare["request"]
    profile_request(
        "POCO-PARE", lambda: detect_forward(pare["model"], smpl, ctx["image"], pc, ps), card
    )
    for flip, run in evaluation["run_batch"].items():
        profile_request(f"eval step, POCO-CLIFF, batch 64, flip_test={flip}", run, card)
    profile_request("train step, POCO-CLIFF, batch 64, fp32", train["run_step"], card,
                    stages=TRAIN_STAGES)
    profile_request("train step, POCO-PARE, batch 64, fp32", train["run_pare_step"], card,
                    stages=TRAIN_STAGES)
    with loader_beside(images["fullhd"]):
        profile_request("train step, POCO-CLIFF, batch 64, fp32, loader beside it",
                        train["run_step"], card, stages=TRAIN_STAGES)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--dist-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dist-dir", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--grid-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--export-job", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.dist_rank is not None:  # one of phase 4i's ranks
        return dist_rank(args.dist_rank, Path(args.dist_dir), args.seed)
    if args.grid_rank is not None:  # one of phase 4n (b)'s ranks
        return grid_rank(args.grid_rank, Path(args.dist_dir), args.seed)
    if args.export_job is not None:  # one of 4h's export processes
        return export_job(args.export_job, Path(args.dist_dir))
    # The card's host sets PYTHONDONTWRITEBYTECODE and its site-packages is
    # read-only, so every process this run starts compiled torch's sources
    # again: one shared bytecode cache in the checkout's build directory
    # takes an import of the port from 7.0-7.3 s to 4.6 s (PERF.md §6 PR 13).
    os.environ["PYTHONPYCACHEPREFIX"] = str(REPO / "poco_tpu_torch" / "_build" / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

    card, peaks = phase_environment()
    phase_build()
    errs = phase_kernel_check()
    linear_errs = phase_linear_check()
    mark("phases 1-3b")
    ctx = phase_main_path(args.seed)
    paths = {"cliff": ctx["counts"], "cliff_nonfinite": ctx["nonfinite_counts"]}
    mark("phase 4")
    pare = phase_pare(ctx, args.seed)
    paths["pare"] = pare["counts"]
    mark("phase 4b")
    paths["flow"] = phase_flow(ctx, pare, args.seed)
    mark("phase 4c")
    paths["hmr"] = phase_hmr(ctx, args.seed)
    mark("phase 4d")
    evaluation = phase_eval(ctx, pare, args.seed, card)
    paths["eval"] = evaluation["counts"]
    mark("phase 4e")
    train = phase_train(ctx, pare, args.seed, card)
    paths["train"] = train["counts"]
    paths["train_pare"] = train["pare_counts"]
    mark("phase 4f")
    images = phase_images(ctx, train, args.seed, card)
    paths.update(images["counts"])
    mark("phase 4g")
    paths["serving"] = phase_serving(ctx, card)
    mark("phase 4h")
    paths.update(phase_dist(ctx, args.seed, card))
    mark("phases 4i, 4n")
    demo_counts, demo_err = phase_demo(ctx, args.seed, card)
    paths.update(demo_counts)
    errs["v2"] = max(errs["v2"], demo_err)
    mark("phases 4j, 4o")
    phase_crop(args.seed, card)
    mark("phase 4p")
    paths.update(phase_render_losses(ctx, pare, train, card))
    mark("phase 4k")
    paths["train_images"] = phase_train_images(ctx, train, card)
    mark("phase 4l")
    phase_launchers(card)
    mark("phase 4m")
    paths.update(phase_tools(ctx, card))
    mark("phase 4q")
    paths.update(phase_precision(ctx, pare, train, card))
    mark("phase 4r")
    paths["hmr2"] = phase_hmr2(ctx, args.seed)
    mark("phase 4s")
    launches = Counter()
    for counts in paths.values():
        launches.update(counts)
    check(launches["linear_3xtf32"] == paths["hmr2"]["linear_3xtf32"],
          "linear_3xtf32 ran on a main path other than HMR 2.0's")
    print(f"launches on the main paths: {dict(launches)}; by path "
          f"{ {path: dict(counts) for path, counts in paths.items()} }")
    phase_throughput(ctx, pare, args.reps, card)
    mark("phase 5")
    phase_profile(ctx, pare, evaluation, train, images, card)
    mark("phase 6")
    train["tmp"].cleanup()
    times = phase_kernel_timing(peaks)
    backward_times = phase_backward_timing(peaks)
    linear_times = phase_linear_timing(peaks)
    mark("phases 7-7c")
    common = {"route": "cuda", "replaces": "poco_tpu/ops/pallas_lbs.py:87", "library_ms": None}
    records = [
        {"name": "skinning", "source": "poco_tpu_torch/csrc/skinning.cu", **common,
         "launches": launches["skinning"], "max_abs_err": errs["v2"],
         **{k: v for k, v in times.items() if not k.startswith("earlier")}},
        {"name": "skinning_simt", "source": "poco_tpu_torch/csrc/skinning_simt.cu", **common,
         "launches": launches["skinning_simt"], "max_abs_err": errs["v1"],
         "ms": times["earlier_ms"],
         "cold_ms": times["earlier_cold_ms"], "plain_ms": times["plain_ms"],
         "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
         "library_ms": times["library_ms"]},
        # the JAX package differentiates its einsum path with XLA: no Pallas kernel
        {"name": "skinning_backward", "source": "poco_tpu_torch/csrc/skinning_backward.cu",
         **common, "replaces": "poco_tpu/smpl/lbs.py:177",
         "launches": launches["skinning_backward"], "max_abs_err": errs["backward"],
         **backward_times},
        {"name": "skinning_backward_simt",
         "source": "poco_tpu_torch/csrc/skinning_backward_simt.cu", **common,
         "replaces": "poco_tpu/smpl/lbs.py:177", "launches": launches["skinning_backward_simt"],
         "max_abs_err": errs["backward_simt"], "ms": backward_times["earlier_ms"],
         "cold_ms": backward_times["earlier_cold_ms"], "plain_ms": backward_times["plain_ms"],
         "bound_ms": backward_times["bound_ms"], "bound_by": backward_times["bound_by"]},
        # the JAX package has no ViT: no TPU kernel to replace
        {"name": "linear_3xtf32", "source": "poco_tpu_torch/csrc/linear_3xtf32.cu",
         "route": "cuda", "replaces": None, "launches": launches["linear_3xtf32"],
         **linear_errs, **linear_times},
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
