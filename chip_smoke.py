"""Chip smoke test of skix_torch on one NVIDIA GPU (an H100 at full size).

    python3 chip_smoke.py

Phases, one line each (the last line is the JSON verdict):

1. device     the card's name and power limit (nvidia-smi);
2. build      every CUDA kernel of the main paths, from skix_torch/ops/csrc,
              one nvcc process per source, all started together; each
              kernel's registers, spills and shared memory (-Xptxas -v; the
              dynamic shared memory of the forward and backward cores from
              their libraries), ptxas's wgmma warnings, and the count of
              HGMMA (wgmma) instructions in the SASS of K1-K5 (cuobjdump
              -sass), which fails the phase at 0, as does a spill in a
              backward kernel;
3. kernel     each forward kernel against its plain PyTorch version on the
              card at the main paths' shapes, with its time (CUDA events),
              the plain version's, F.scaled_dot_product_attention's on the
              same pre-roped inputs (a yardstick only) and the bound of the
              card (float32 as split-TF32: three tf32 products at 495
              TFLOP/s; the FMA bound of 67 TFLOP/s beside it): K1 (flash_fwd) at the VGGT and SAM3 shapes, K1 with its
              lse output (flash_fwd_lse) at the memory tracker's shape and
              the training shapes, K2 (flash_fwd_single_tile, and with its
              lse) at the ViT-Det window shape, and a small ragged case of
              each; then the same kernels with the sam3 configuration's
              interleaved rope at its global-block and window shapes
              (inference and training), ragged and bf16, and with the
              segmented rope; and K1 at the vggt CLI's shapes (single mode's
              S = 30 and sfm's S = 8: frame and global blocks, the camera
              trunk, the DINOv2 patch embed; bf16 errors count in units of
              max(1, 2|plain|), one bf16 step at any magnitude); and K1 at
              the image_edit MMDiT's joint attention (1,24,2064,128) f32
              with the interleaved rope from its [text, image] tables; and
              K1 and K1-lse at head dims 8, 24 and 48, which the wrappers
              zero-pad to the next kernel width (the tracker fixtures'
              memory attention at D = 24, also in bf16);
   backward   each backward kernel against its plain version: K3 + K4
              (flash_bwd_dkv, flash_bwd_dq) at the ViT-Det global and
              fusion-encoder training shapes, K5 (flash_bwd_single_tile) at
              the window shape, ragged, bf16 and head-dim-128 cases, the
              same with the interleaved rope and K3/K4 with the segmented
              rope, each launched twice, the two results bitwise equal
              (no atomics); the yardstick is autograd through SDPA,
              its backward alone; the bound as for the forward (float32
              as split-TF32, the FMA bound beside it);
   window_probe K2's probes B1-B7 (skix_torch.ops.window_probe): each
              compile-time variant against its plain version on the card,
              then its time, spread and share of the bound;
4. reference  the VGGT stage at a small width in float32 on the card
              (kernels) and on the CPU (plain versions), same weights, same
              records;
5. main       run_all's vggt stage at full VGGT-1B width (embed 1024, depth
              24, 16 heads, 518 px, bf16, seeded random weights) on two
              1080p records, launch counts reset just before and read just
              after; then the same run warm, and once under torch.profiler
              (device activity: device time by kernel, the device's idle
              share);
6. front_ref  the prepare_front_results stage at the tiny detector width in
              float32 on the card and on the CPU, same weights, same frames;
7. front      run_all's prepare_front_results stage at the full-size
              Sam3Detector (1008 px, ViT-Det 1024 x 32) and the default
              memory tracker, 4 frames of 720x1280, prompts person and snow,
              launch counts reset just before and read just after; then warm,
              and once under torch.profiler;
7b. sam3      the front stage in the reference SAM3 configuration
              (rope_style sam3, pretrain 336, prompts through the CLIP
              tower): front_sam3_ref tiny on the card against the CPU; then
              reference-layout checkpoints of the full-size ViT-Det trunk,
              fusion encoder and VE text encoder through the port's
              converters (sam3_checkpoints); then front_sam3 at full size
              through run_all, launches counted by kernel and rope style,
              warm and profiled;
7c. chain    run_all's default chain (videopose3d → triangulation →
              bundle_adjustment → fuse → front_side → angle → metrics):
              chain_ref at skix's run_all-test size on the card and on the
              CPU from the same records and lifter weights (per kind of
              artifact the largest difference against its limit, the RANSAC
              inlier masks, the committed lifter fixture's held-out MPJPE);
              then chain at configs/run_all.yaml's full width (VideoPose3D
              channels 1024, widths 3x5, kpt RANSAC, LM BA) on 2 persons x
              2 views x 900 frames of 1080p, every person's every artifact
              checked, cold (launch counts reset just before and read just
              after: no flash-attention kernel is on this path), warm,
              profiled, and the lifter, the RANSAC and the adaptive EMA
              timed alone; chain_ref also runs run_all's side branch
              (sam3d_body → fuse, paths.sam3d_root unset, stored 1080p
              frames, a tiny SAM3DBody checkpoint) card against CPU, while
              the chains keep their pre-written side views;
7d. side      the side-view stage (prepare_side_results): side_ref tiny on
              the card and on the CPU from the same checkpoints (vit_hmr
              with masks, a DINOv3 trunk, full inference; the tiny MoGe's
              point maps and its focal search on synthetic maps), each
              output field's largest difference beside its limit; side at
              the published DINOv3 ViT-H+/16 width at crop 512 with the
              MoGe-2 ViT-L/14 FOV estimator at its full width, seeded
              weights, on two 64-frame 1080p records: cold (exactly 128 K1
              launches a batch and 24 a MoGe batch), warm, each model pass
              alone, profiled; side_chain: run_all's sam3d_body → fuse →
              angle → metrics at the stage's defaults (vit_hmr 384 × 8,
              crop 256) on 1 person × 2 records × 160 frames of 1080p
              (exactly 32 K1 launches a batch a record);
7e. vggt     the vggt CLI's modes single (its default) and sfm:
              vggt_ref at a small width (embed 256, 8 heads) in float32 with
              both DPT heads, the track head and SuperPoint + ALIKED from
              seeded reference-layout checkpoints, card against CPU (the
              card's tracker fed the CPU's keypoints; cameras, dense maps,
              tracks, visibility, BA costs and the sparse model against
              their limits, the choices equal); vggt_single at
              configs/vggt.yaml's defaults (VGGT-1B, bf16, 518 px, seeded
              weights) on a 30 s 1080p clip at stride 30 (one forward of
              S = 30: K1 at (1,16,41220,64)), cold with launch counts by
              shape, warm, profiled; vggt_sfm at the config's sfm settings
              on a 240-frame clip (8 frames, both DPT heads, the track head,
              BA full, the COLMAP text), cold, profiled, its pieces
              timed alone, then one forward of VGGT(patch_embed_kind="vit"),
              the DINOv2 ViT-L/14 patch embed, with its launches;
7f. prep      prepare_dataset (video → records): prep_ref tiny (YOLO11-n
              pose, seg and detect, Keypoint R-CNN, a 64-wide DPT, RAFT at
              the CPU twin's width) on the card against the CPU, stage by
              stage (raw heads before any NMS, detections where both made
              the same picks, depth and flow maps, ByteTrack and selection
              on the CPU's detections, greedy and exact_match, the stage's
              records), each limit
              printed; prep at configs/prepare_dataset.yaml with the skix
              backend and bbox_model detect (YOLO11-s pose, seg, detect,
              Keypoint R-CNN R50-FPN, the depth task 384 / 12 / 6 through K1,
              RAFT 96 / 64 × 8 iterations, ByteTrack; seeded weights) on 2
              videos × 40 frames of 1080p: cold (K1 launches by shape, 12 a
              batch of 4 frames), each task warm in ms a frame, the stage
              warm on 16 frames under torch.profiler, then run_all with stages
              [prepare_dataset, videopose3d]; dpt_large: one warm forward of
              the depth model at Intel/dpt-large width (1024 / 24 / 16) on 4
              frames of 1080p (K1 at (4,16,8041,64), 24 launches); prep_ref
              also holds the mask slot card against CPU (the share of
              differing pixels, at the twin's size and at 1080p);
7g. views     the view stages' options: side_det_ref (the cascade at
              skix's test trunk, raw heads before the box stages' NMS,
              detections, then the side stage with the detector in the loop,
              card against CPU); side_det (prepare_side_results with
              detector_name vitdet at ViTDet-H width, 1024 px, batches of 4,
              4 person slots, the estimator at its defaults, on 2 records ×
              64 frames of 1080p without boxes: cold with its K1 launches,
              each model alone, warm, profiled, peak memory);
              front_compact_ref and front_compact (model compact at
              configs/prepare_front_results.yaml's keys, card against CPU,
              then 64 frames of 720p, K1 launches by shape); trunk_ref and
              front_trunk (the tracker's ViT-Det trunk tiny card against CPU,
              then the front stage with it at full width and the overlay
              video, launches by kernel and shape); render3d (front_side
              with render3d at 1280 × 720 on 1 person × 300 frames, ms a
              frame, card against CPU as a share of differing pixels);
7h. image_edit the image_edit CLI (configs/image_edit.yaml):
              image_edit_ref at a tiny width (dim 256 = 2 heads of 128,
              depth 2, the config's towers, VAE, 512 px and a LoRA) on the
              card and on the CPU from the same weights, 1080p frame and
              noise (prompt embeddings, a velocity, an edit's output
              latents and image, each against its limit); image_edit at the
              published widths (the Qwen-Image transformer at 16 of its 60
              blocks, the Qwen2.5-VL-7B language tower at 4 of 28 layers
              with the CLIP stand-in vocabulary, its vision tower whole) on
              a 1080p clip: cold through main (exactly 16 K1 launches a DiT
              forward, all at (1,24,2064,128), interleaved), the PNGs and
              the summary checked, a DiT forward and an edit warm, an edit
              profiled;
8. train_ref  one train_detector step of the tiny detector on the card and
              on the CPU from the same weights and batch: loss, gradients
              and updated parameters;
9. train      train_detector's CLI at configs/train_detector.yaml's
              defaults (preset full: the 482M-parameter Sam3Detector at
              1008 px, batch 4, DAC, IoU-aware BCE, AdamW + cosine) for 4
              steps on a synthetic COCO fixture written with OpenCV, launch
              counts reset just before and read just after (exactly 28 K2,
              28 K5, 10 K1, 10 K3 and 10 K4 per step); warm step time and
              its forward/backward/optimizer split, peak memory; then one
              warm step under torch.profiler;
9b. train_sam3 the tiny step in the sam3 configuration and optimizer scheme
              with exact matching and PointRend's sampled mask loss
              (train_sam3_ref: every assignment equal card against CPU),
              then the full-size run with model rope_style sam3,
              optim.scheme sam3, the converted detector as its initial
              weights and the reference recipe's loss (exact_match,
              mask_points 12544), launches by kernel and rope style, the
              matching's ms a step and the auction's rounds a phase;
9c. train_cli the training CLIs: lifter_train_ref (train_lifter at a small
              width, 2 epochs and a resume, card against CPU: every epoch's
              checkpoint), lifter_train (configs/train_lifter.yaml as it is
              on 8 synthetic clips × 1000 frames: 2 epochs and a resume, s
              an epoch, ms a step, peak memory, the checkpoints read back),
              pose_train_ref (train_pose with YOLOv8-n at 96 px, 2 steps
              card against CPU from one npz) and pose_train
              (configs/train_pose.yaml as it is, YOLOv8-s at 640 px, batch
              8, 6 steps on a 16-image keypoints fixture, ms a step, peak
              memory, the checkpoint read back and a resume from it);
9d. tools     the post-run tools: tools_ref (card against CPU on seeded
              inputs: solve_rt_from_3d on 2 views x 300 frames x 17 joints,
              cameras only and with refine_points; icp on 4096-point maps;
              the FovEstimator from converted variables; report's
              pose_summary; device_prefetch against synchronous copies),
              then tools at the sizes users run them, each step's time and
              peak device memory: rt_solver at the chain's size (2 x 900 x
              17, refine_points, 60 LM steps x 30 CG), icp on 16384-point
              maps, estimate_focal_lengths on 64 frames of 1080p,
              read_video_chunks with and without device_prefetch,
              validate_records, report over a run_all-shaped tree,
              vis_3d_kpt (where matplotlib is installed; said so where it
              is not), camera_calibration on a 600-frame 1080p chessboard
              video, and the launcher's two processes running fuse over 4
              persons on the card;
9e. vos       mask-prompted video object segmentation and the tracking
              suite: vos_ref (the committed trained trackers of
              tests/fixtures/tracker_tiny224.npz, head dim 24 through K1
              padded to 32, card against CPU: propagate_object on the
              fixture script's held-out clips, held at skix's mIoU and
              identity floors; MaskletVideoModel with fill_holes on 3
              clips × 12 frames, scored by evaluate_tracking_suite, skix's
              HOTA floors printed beside; the interactive predictor forward
              and reverse; K1-lse launches 2 a frame), then vos at full
              width (the default tracker on the disk world at 1008 px:
              propagate_objects 4 objects × 24 frames, warm and profiled;
              the predictor 2 objects × 16 frames forward and reverse, no
              launch; the hole fill; the EDT click at 1008²; the suite),
              each step's time and peak device memory;
9f. prompts   point and box prompts: prompts_ref (the CPU twins' items on
              tests/fixtures/tracker_tiny224.npz with a geometry branch
              grafted from a seeded generator, card against CPU: the
              samplers, the geometry encoder, the detector with text ‖
              geometry and geometry alone, Sam3Processor's sequence, the
              prompt encoder, the SAM decoder's selection, the image
              predictor, the masklet session through the request protocol
              both ways, the box session, track_masklets, the VOS
              predictor's clicks and box), then prompts at full width
              (Sam3Processor on the full-size detector, 4 frames of 1080p
              × 4 prompts; the session on 16 frames of 1080p both ways;
              the VOS predictor with the ViT-Det segmenter at 1008 px),
              K1 and K2 launches held, times, peak memory, one profile of
              the processor and of the session;
10. kernels   one JSON object per kernel (and K1/K2 mode) of the paths, its
              rope styles under "modes", then one per TPU probe B1-B7 (K2's
              variants, launched on no path) with its variants' rows.

``python3 chip_smoke.py --only views,prep`` runs the build and these
phase groups alone (GROUPS), with no kernels line and no verdict;
``--only tools`` runs the post-run tools' phases, which make their own
inputs, ``--only vos`` the VOS phases, which read the committed
tracker fixture and make their clips, and ``--only prompts`` the prompt
phases.

cuDNN's TF32 is turned off in phase 4 (float32 convolutions, to compare
card and CPU) and stays off for the phases after it; matmuls keep
PyTorch's default (full float32). Any failed phase exits non-zero and
prints no verdict. Without a CUDA device, or without the skix_torch
package beside this file, it exits 1.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12,         # dense tensor-core bf16
                  "float32": 67e12}           # f32 outside the tensor cores
TF32_OPS_PER_S = 495e12                       # dense tensor-core tf32
# the kernels' float32 products: split-TF32, three tf32 products (lo*hi +
# hi*lo + hi*hi) per f32 product (skix_torch/ops/csrc/flash_tc.cuh,
# flash_bwd_tc.cuh)
F32_TF32_PASSES = 3
KERNELS = {  # name → (source, the TPU kernel it replaces)
    "flash_fwd": ("skix_torch/ops/csrc/flash_fwd.cu",
                  "skix/ops/attention.py:184"),
    "flash_fwd_lse": ("skix_torch/ops/csrc/flash_fwd.cu",
                      "skix/ops/attention.py:184"),
    "flash_fwd_single_tile": ("skix_torch/ops/csrc/flash_fwd_single_tile.cu",
                              "skix/ops/attention.py:313"),
    "flash_fwd_single_tile_lse": (
        "skix_torch/ops/csrc/flash_fwd_single_tile.cu",
        "skix/ops/attention.py:313"),
    "flash_bwd_dkv": ("skix_torch/ops/csrc/flash_bwd.cu",
                      "skix/ops/attention.py:558"),
    "flash_bwd_dq": ("skix_torch/ops/csrc/flash_bwd.cu",
                     "skix/ops/attention.py:631"),
    "flash_bwd_single_tile": ("skix_torch/ops/csrc/flash_bwd_single_tile.cu",
                              "skix/ops/attention.py:691"),
}

FULL = dict(vggt_img_size=518, vggt_embed_dim=1024, vggt_depth=24,
            vggt_num_heads=16, vggt_taps=[4, 11, 17, 23])
MAIN_T, MAIN_STRIDE, MAIN_HW = 8, 2, (1080, 1920)
# a two-view rig as pose encodings [t(3), quat(4), fov_h, fov_w]: view 1
# turned 0.3 rad about y and moved one unit along x
RIG_POSES = [[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 1.0],
             [-1.0, 0.0, 0.1, math.cos(-0.15), 0.0, math.sin(-0.15), 0.0,
              1.0, 1.0]]
# the front path: frames, prompts, and launches per frame and prompt at the
# full-size Sam3Detector (32 ViT-Det blocks, 4 global) and default tracker
FRONT_T, FRONT_HW, FRONT_PROMPTS = 4, (720, 1280), ["person", "snow"]
FRONT_PER_FRAME = {"flash_fwd_single_tile": 28,   # window blocks
                   "flash_fwd": 4 + 6,            # global blocks + encoder
                   "flash_fwd_lse": 2}            # tracker memory attention
# the training path: steps, the fixture, and launches per step (forward
# with lse, backward) and per evaluation forward of the full-size detector
TRAIN_STEPS, TRAIN_IMAGES, TRAIN_HW = 4, 8, (480, 640)
TRAIN_PER_STEP = {"flash_fwd_single_tile_lse": 28, "flash_bwd_single_tile": 28,
                  "flash_fwd_lse": 4 + 6, "flash_bwd_dkv": 4 + 6,
                  "flash_bwd_dq": 4 + 6}
TRAIN_PER_EVAL = {"flash_fwd_single_tile": 28, "flash_fwd": 4 + 6}
# the sam3 configuration (the detector that converted SAM3 weights need, a
# CLIP checkpoint for the prompts): launches by "<kernel>/<rope style>" per
# frame and prompt, per training step, per evaluation forward
SAM3_DETECTOR = {"rope_style": "sam3", "pretrain_img_size": 336}
FRONT_SAM3_PER_FRAME = {"flash_fwd_single_tile/interleaved": 28,
                        "flash_fwd/interleaved": 4, "flash_fwd/none": 6,
                        "flash_fwd_lse/none": 2}
TRAIN_SAM3_PER_STEP = {"flash_fwd_single_tile_lse/interleaved": 28,
                       "flash_bwd_single_tile/interleaved": 28,
                       "flash_fwd_lse/interleaved": 4, "flash_fwd_lse/none": 6,
                       "flash_bwd_dkv/interleaved": 4, "flash_bwd_dkv/none": 6,
                       "flash_bwd_dq/interleaved": 4, "flash_bwd_dq/none": 6}
# the training CLIs: train_lifter on LIFTER_CLIPS synthetic clips of LIFTER_T
# frames at configs/train_lifter.yaml (63 steps an epoch at batch 128), its
# card-vs-CPU check at a small width; train_pose at configs/train_pose.yaml
# for POSE_STEPS steps on POSE_IMAGES images, its check YOLOv8-n at 96 px
LIFTER_CLIPS, LIFTER_T = 8, 1000
LIFTER_REF = dict(filter_widths=[3, 3], channels=64, batch_size=16)
POSE_STEPS, POSE_IMAGES = 6, 16
POSE_REF = dict(scale="n", image_size=96, batch_size=4, steps=1,
                final_eval=True)
# train_sam3's loss: the reference recipe's exact matching and PointRend
# mask loss on 112 × 112 points a mask (train_sam3_ref: 64 points)
TRAIN_SAM3_LOSS = {"exact_match": True, "mask_points": 12544}
REF_MASK_POINTS = 64
TRAIN_SAM3_PER_EVAL = {"flash_fwd_single_tile/interleaved": 28,
                       "flash_fwd/interleaved": 4, "flash_fwd/none": 6}
# run_all's default chain (configs/run_all.yaml) plus front_side: the full
# width and data of the chain phase, and the small size of chain_ref (skix's
# run_all test: T 24, lifter channels 32, widths [3, 3], BA 8 × 10 CG)
CHAIN_STAGES = ["videopose3d", "triangulation", "bundle_adjustment", "fuse",
                "front_side", "angle", "metrics"]
# 2 persons (4 once; cut for the script's 1200 s limit as phases were added)
CHAIN_PERSONS, CHAIN_T, CHAIN_HW = 2, 900, (1080, 1920)   # 30 s at 30 fps
CHAIN_FULL = dict(filter_widths=[3, 3, 3, 3, 3], channels=1024,
                  ba_max_steps=30, ba_cg_iters=20)
CHAIN_REF_T = 24
CHAIN_REF = dict(filter_widths=[3, 3], channels=32, ba_max_steps=8,
                 ba_cg_iters=10)
# chain_ref's side branch: run_all's sam3d keys at a tiny
# width whose 6 heads are 32 wide (the kernels take head dims 32, 64, 128)
CHAIN_REF_SIDE = dict(sam3d_crop_size=64, sam3d_embed_dim=192, sam3d_depth=1,
                      sam3d_batch_size=8, sam3d_inference_type="full")
SEGMENT_AXES = (8, 12, 8)      # the segmented rope's case: a tail of 4 of 32
# the side-view stage (prepare_side_results) at the published DINOv3
# SAM-3D-Body width (ViT-H+/16: 1280 wide, 32 deep, 20 heads of 64, SwiGLU)
# at crop 512 with the MoGe-2 FOV estimator at its full width (the stage's
# defaults: ViT-L/14, 1024 wide, 24 deep, 16 heads); two 64-frame 1080p
# records; K1 launches per batch: 4 backbone passes (body, two hand crops,
# body again with the refined hands) × 32 blocks, and MoGe's 24 blocks per
# batch of 4 strided frames. side_chain: run_all's default side stage
# (vit_hmr 384 × 8, 6 heads, crop 256, batch 8, full) on 1 person × 2
# records × 160 frames of 1080p, through fuse, angle and metrics
SIDE_T, SIDE_HW = 64, (1080, 1920)
SIDE_CFG = dict(backbone="dinov3_vith16plus", embed_dim=1280, crop_size=512,
                batch_size=8, inference_type="full", fov_name="moge2",
                fov_stride=8)
SIDE_PER_BATCH, MOGE_PER_BATCH, MOGE_BATCH = 4 * 32, 24, 4
# side_chain's frames a record: 160 (300 until the training CLIs' phases
# needed the script's time)
SIDE_CHAIN_T, SIDE_CHAIN_PER_BATCH = 160, 4 * 8
SIDE_CHAIN_STAGES = ["sam3d_body", "fuse", "angle", "metrics"]
# side_ref's limits on |card − CPU| by output field: 3D in metres, 2D in
# pixels, the model's parameters; the focal relative
SIDE_REF_LIMITS = {"pred_keypoints_3d": 1e-4, "pred_vertices": 1e-4,
                   "pred_cam_t": 1e-4, "pred_keypoints_2d": 0.05,
                   "pred_global_rots": 1e-4, "body_pose_params": 1e-4,
                   "hand_pose_params": 1e-4, "scale_params": 1e-4,
                   "shape_params": 1e-4, "focal_length": 1e-4, "bbox": 0.0}
# the vggt CLI (configs/vggt.yaml): single mode on a 30 s 1080p clip at 30
# fps (stride 30: one forward of S = 30 frames), sfm mode on a 240-frame
# clip (8 frames a forward); vggt_ref's small width (8 heads of 32, the
# kernels' smallest head dim; the camera trunk's 16 heads of 32) and the
# skix sfm test's settings, with SuperPoint and ALIKED
CLIP_HW, SINGLE_T, SFM_T = (1080, 1920), 900, 240
VGGT_REF = dict(img_size=56, patch_size=14, embed_dim=256, depth=2,
                num_heads=8, intermediate_layer_idx=[0, 0, 1, 1],
                dtype="float32", max_frames=16, ba_max_steps=5,
                sfm_max_frames=4, sfm_max_query_pts=32, sfm_query_frames=2,
                sfm_min_vis=1, sfm_vis_thresh=0.0, sfm_min_inlier_per_frame=0,
                track_dim=16, sfm_extractor="sp+aliked")
# vggt_ref's limits on |card − CPU| (relative to a quantity's scale where
# it exceeds 1; tracks and visibility absolute)
VGGT_REF_LIMITS = {"cameras": 1e-5, "dense_depth": 1e-4,
                   "dense_depth_conf": 1e-4, "dense_world_points": 1e-4,
                   "dense_world_points_conf": 1e-4, "points": 1e-4,
                   "tracks_px": 1e-3, "vis": 1e-4, "ba_cost_rel": 1e-4}
# vggt_sfm: the gates relaxed, and only these, where seeded weights leave
# no reconstruction at the config's defaults
VGGT_SFM_GATES = {"sfm_min_inlier_per_frame": 0}
# the image_edit CLI (configs/image_edit.yaml) at the published widths:
# the Qwen-Image transformer (Qwen/Qwen-Image transformer/config.json: dim
# 3072 = 24 heads of 128, rope axes [16, 56, 56], joint_attention_dim 3584)
# at 16 of its 60 blocks (all 60 in float32, ~82 GB, do not fit the card);
# the Qwen2.5-VL-7B language tower at its width (hidden 3584, 28 heads, 4
# kv heads, intermediate 18944, rope theta 1e6, mrope [16, 24, 24]) at 4 of
# 28 layers with the CLIP stand-in vocabulary (49 411); its vision tower at
# full size (depth 32, hidden 1280, 16 heads, intermediate 3420, window
# 112, full attention in blocks 7/15/23/31, out 3584); the config's VAE,
# LoRA scale, image size, image tokens, steps and true-CFG scale. One
# 1080p clip of 30 frames at the config's stride 30: one frame × the
# config's 4 edits, 4 steps each: 16 DiT forwards of 16 K1 launches at
# (1,24,2064,128). image_edit_ref: dim 256 = 2 heads of 128, depth 2, the
# config's tiny towers, card against CPU from the same weights and noise
EDIT_FULL = {"dim": 3072, "num_heads": 24, "depth": 16, "text_dim": 3584,
             "axes_dim": [16, 56, 56],
             "text_encoder": {"layers": 4, "heads": 28, "kv_heads": 4,
                              "intermediate": 18944},
             "vision_encoder": {"depth": 32, "hidden": 1280, "heads": 16,
                                "intermediate": 3420, "window_size": 112,
                                "fullatt_block_indexes": [7, 15, 23, 31]}}
EDIT_CUTS = "dit_depth_16_of_60,text_layers_4_of_28,vocab_49411_clip_bpe"
EDIT_REF = {"dim": 256, "num_heads": 2, "depth": 2, "axes_dim": [16, 56, 56]}
EDIT_T, EDIT_HW, EDIT_TEXT_LEN, EDIT_AXES = 30, (1080, 1920), 16, (16, 56, 56)
EDIT_LORA_RANK = 16
# image_edit_ref's limits: the prompt embeddings, the velocity and the
# output latents relative to their scale; the images: the largest grey
# level difference and the share of differing pixels
EDIT_REF_LIMITS = {"prompt_emb": 1e-4, "velocity": 1e-4, "latents": 1e-4,
                   "png_levels": 1, "png_diff_share": 1e-3}
# train_ref, train_sam3_ref: a gradient leaf that moves on the CPU by more
# than this share of its largest element when the batch is reversed is
# rounding noise (its exact gradient is 0), left out of the gradient check
NOISE_SHARE = 0.1


_T0 = time.perf_counter()


def say(phase: str, **fields) -> None:
    """One result line of a phase, with the script's seconds so far
    (``t``)."""
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items())
          + f" t={time.perf_counter() - _T0:.1f}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def reset_counts() -> None:
    """Set the wrappers' launch counts (by kernel and by rope style) to 0,
    just before a main path runs."""
    from skix_torch.ops import attention as A

    A.LAUNCHES.clear()
    A.LAUNCHES_BY_STYLE.clear()
    A.LAUNCHES_BY_SHAPE.clear()


# --------------------------------------------------------------------------
# phase 2: the build
# --------------------------------------------------------------------------
def ptxas_entries(log: str):
    """Per kernel entry of an ``nvcc -Xptxas -v`` report: ``[name,
    registers, spill stores, spill loads, static shared memory]``."""
    import re

    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = [m.group(1), None, None, None, 0]
            rows.append(cur)
        elif cur is not None and "spill stores" in ln:
            n = re.findall(r"(\d+) bytes spill", ln)
            cur[2], cur[3] = int(n[0]), int(n[1])
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur[1] = int(re.search(r"Used (\d+) registers", ln).group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur[4] = int(m.group(1)) if m else 0
    names = [r[0] for r in rows]
    try:        # demangled, where binutils is installed
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(rows):
            for r, n in zip(rows, out.stdout.splitlines()):
                r[0] = (n.replace("(anonymous namespace)::", "")
                        .removeprefix("void ").split("(")[0])
    except OSError:
        pass
    return rows


def build_phase(sources):
    """Build every kernel source (one nvcc each, all at once); print each
    kernel's registers, spills and shared memory (``-Xptxas -v``; the
    dynamic shared memory of the forward and backward cores from their
    libraries), ptxas's warnings about wgmma, and the number of HGMMA
    (wgmma) instructions in the SASS of each source, which must not be 0;
    a backward kernel must not spill."""
    import ctypes

    from skix_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build(sources)
    say("build", seconds=round(time.perf_counter() - t0, 2))
    spills = []
    for s in sources:
        log = _build.build_log(s)
        for name, regs, st, ld, smem in ptxas_entries(log):
            say("build", source=s, kernel=json.dumps(name).replace(" ", ""),
                registers=regs, spill_stores=st, spill_loads=ld,
                static_smem=smem)
            if s.startswith("flash_bwd") and (st or ld):
                spills.append(name)
        for ln in log.splitlines():
            if "wgmma" in ln or "C7515" in ln:
                say("build", source=s, ptxas_warning=json.dumps(ln.strip()))
    fwd = ctypes.CDLL(str(libs["flash_fwd"]))
    fwd.skix_flash_fwd_smem_bytes.restype = ctypes.c_longlong
    bwd = ctypes.CDLL(str(libs["flash_bwd"]))
    bwd.skix_flash_bwd_smem_bytes.restype = ctypes.c_longlong
    k5 = ctypes.CDLL(str(libs["flash_bwd_single_tile"]))
    k5.skix_bwd_single_tile_smem_bytes.restype = ctypes.c_longlong
    say("build", dynamic_smem=json.dumps({
        f"{kern}/{dt}/D{D}": fn(D, code)
        for kern, fn in (
            ("fwd", fwd.skix_flash_fwd_smem_bytes),
            ("dkv", lambda D, c: bwd.skix_flash_bwd_smem_bytes(D, c, 1)),
            ("dq", lambda D, c: bwd.skix_flash_bwd_smem_bytes(D, c, 0)),
            ("single_tile", k5.skix_bwd_single_tile_smem_bytes))
        for dt, code in (("float32", 0), ("bfloat16", 1))
        for D in (32, 64, 128)}).replace(" ", ""))
    if spills:
        fail(f"backward kernels spill registers: {spills}")
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    for s in sources:
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs[s])],
                              capture_output=True, text=True, timeout=300)
        n = sum("HGMMA" in ln for ln in sass.stdout.splitlines())
        say("build", source=s, hgmma_instructions=n)
        if sass.returncode != 0 or n == 0:
            fail(f"{s}: no HGMMA instruction in its SASS (cuobjdump exit "
                 f"{sass.returncode})")


# --------------------------------------------------------------------------
# phase 3: the kernels against their plain versions
# --------------------------------------------------------------------------
def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after two warm-ups."""
    import torch

    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def attention_bound_ms(q, k, rope: bool, lse: bool):
    """The least time the card needs for K1 or K2: each distinct input
    element read once (a q shared by every batch row counts once), o (and
    the lse) written once, the f32 rope tables read once, against 4·B·H·Sq·
    Sk·D operations (QKᵀ and P·V) at the rate the kernel's products run at:
    bf16 at 989 TFLOP/s, float32 as F32_TF32_PASSES tf32 products at 495;
    the larger of the two. Also the float32 FMA bound (67 TFLOP/s) that a
    kernel on the FMA units would face, which this one does not: ``(ms,
    bound_by, fma_ms)``, fma_ms None for bf16."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    item = q.element_size()
    q_rows = 1 if q.stride(0) == 0 else B
    nbytes = item * (q_rows * H * Sq * D + 2 * B * H * Sk * D + B * H * Sq * D)
    if rope:
        nbytes += 2 * 4 * Sq * D
    if lse:
        nbytes += 4 * B * H * Sq
    ops = 4.0 * B * H * Sq * Sk * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    f32 = q.element_size() == 4
    t_ops = (F32_TF32_PASSES * ops / TF32_OPS_PER_S if f32
             else ops / PEAK_OPS_PER_S["bfloat16"]) * 1e3
    fma_ms = (max(t_bytes, ops / PEAK_OPS_PER_S["float32"] * 1e3) if f32
              else None)
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", fma_ms)


def plain_chunked(q, k, v, kw, lse: bool, rows: int = 2048):
    """The plain version over (batch row, 2048 q rows) chunks: its (Sq, Sk)
    f32 score matrix would not fit the card at the tracker's shape (64 GB
    for 16 × 15876 × 63504). With rope (one table for q and k) the chunks
    are (batch row, 4 heads, or 1 at the largest shapes) over the whole
    sequence instead."""
    import torch

    from skix_torch.ops import attention as A

    if kw.get("rope_cos") is not None:
        # 4 heads a chunk; one where 4 would need more than 8 GB of f32
        # scores (the single-mode global blocks, 41220 tokens: 6.8 GB a head)
        hc = 4 if 4 * q.shape[2] * k.shape[2] * 4 <= 8e9 else 1
        heads = [A.attention_reference(q[b:b + 1, h:h + hc],
                                       k[b:b + 1, h:h + hc],
                                       v[b:b + 1, h:h + hc], return_lse=lse,
                                       **kw)
                 for b in range(q.shape[0]) for h in range(0, q.shape[1], hc)]
        nh = -(-q.shape[1] // hc)
        rows_of = [torch.cat([(r[0] if lse else r) for r in
                              heads[b * nh:(b + 1) * nh]], 1)
                   for b in range(q.shape[0])]
        out = torch.cat(rows_of)
        if not lse:
            return out
        return out, torch.cat([torch.cat([r[1] for r in
                                          heads[b * nh:(b + 1) * nh]], 1)
                               for b in range(q.shape[0])])

    outs, lses = [], []
    for b in range(q.shape[0]):
        o_b, l_b = [], []
        for i in range(0, q.shape[2], rows):
            r = A.attention_reference(q[b:b + 1, :, i:i + rows], k[b:b + 1],
                                      v[b:b + 1], return_lse=lse, **kw)
            o_b.append(r[0] if lse else r)
            if lse:
                l_b.append(r[1])
        outs.append(torch.cat(o_b, 2))
        if lse:
            lses.append(torch.cat(l_b, 2))
    out = torch.cat(outs)
    return (out, torch.cat(lses)) if lse else out


def rope_tables(style, S: int, D: int, gen):
    """(cos, sin) tables on the card for a rope of ``style`` over S
    positions (None: no rope). ``"half"``: skix's 2D rope of a ViT-Det grid
    or window (S a square) or of the VGGT layout (5 special tokens, then
    the 37 × 37 grid); ``"interleaved"``: the sam3 axial angles of the
    square grid (or of one row of S); ``("segments", axes)``: the 3D rope
    of random integer (t, y, x) positions; ``"dinov3"``: the DINOv3 trunk's
    tables, identity rows (cos 1, sin 0) for its 5 prefix tokens, then its
    axial angles of the square patch grid (style ``("segments", (D,))``);
    ``"mmdit"``: the MMDiT's joint tables, EDIT_TEXT_LEN text rows first,
    then two square token grids (style ``"interleaved"``)."""
    import torch

    from skix_torch.models.layers import make_grid_positions
    from skix_torch.ops import attention as A
    from skix_torch.tracking.vitdet import axial_rope_angles

    if style is None:
        return None, None
    dev = torch.device("cuda")
    if style == "mmdit":                # [text, target grid, source grid]
        from skix_torch.models.mmdit import rope_tables as mmdit_tables

        g = math.isqrt((S - EDIT_TEXT_LEN) // 2)
        return mmdit_tables(((1, g, g), (1, g, g)), EDIT_TEXT_LEN, EDIT_AXES,
                            10000.0, dev)
    if style == "dinov3":               # 5 prefix rows, then a square grid
        from skix_torch.models.dinov3 import (dinov3_rope_periods,
                                              rope_tables_with_prefix)

        g = math.isqrt(S - 5)
        return rope_tables_with_prefix(torch.as_tensor(
            dinov3_rope_periods(D), device=dev), g, g, 5)
    side = math.isqrt(S)
    if style == "half":
        if side * side == S:            # a ViT-Det grid or window
            pos = torch.as_tensor(make_grid_positions(side, side), device=dev)
        else:                           # the VGGT layout: specials + grid
            grid = torch.as_tensor(make_grid_positions(37, 37) + 1, device=dev)
            pos = torch.cat([torch.zeros(5, 2, dtype=grid.dtype, device=dev),
                             grid])
            pos = pos.repeat(-(-S // len(pos)), 1)[:S]
        return A.rope_2d_tables(pos, D, 100.0)
    if style == "interleaved":
        gh, gw = (side, side) if side * side == S else (1, S)
        return A.interleaved_rope_tables(torch.as_tensor(
            axial_rope_angles(gh, gw, D), device=dev))
    pos = torch.randint(0, 12, (S, 3), generator=gen, device=dev)
    return A.rope_3d_tables(pos, D, style[1])


def kernel_style(rope, D: int):
    """The kernels' rope style of a case's ``rope`` (``"dinov3"``: rotate-half
    over the whole head, one segment; ``"mmdit"``: interleaved)."""
    if rope == "mmdit":
        return "interleaved"
    return ("segments", (D,)) if rope == "dinov3" else (rope or "half")


def style_label(style) -> str:
    from skix_torch.ops import attention as A

    return "none" if style is None else A.style_name(kernel_style(style, 0))


def check_kernel(case, gen):
    """One kernel-vs-plain case: ``(name, label, shape_q, Sk, dtype,
    fixed_max, rope, atol, shared_q, sm_scale)``, ``rope`` a rope style or
    None. Launches are counted by the wrappers; the caller resets the
    counts before the main paths."""
    import torch
    import torch.nn.functional as F

    from skix_torch.ops import attention as A

    name, label, shape, Sk, dtype, fixed_max, rope, atol, shared_q, scale = case
    B, H, Sq, D = shape
    dev = torch.device("cuda")
    q = torch.randn((1 if shared_q else B, H, Sq, D), generator=gen,
                    device=dev) * (scale or 1.0)
    k, v = (torch.randn((B, H, Sk, D), generator=gen, device=dev)
            for _ in range(2))
    if fixed_max is not None:           # qk-normed, as the aggregator's
        q = F.layer_norm(q, (D,))
        k = F.layer_norm(k, (D,))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    q = q.expand(B, H, Sq, D)
    cos, sin = rope_tables(rope, Sq, D, gen)
    style = kernel_style(rope, D)
    sm = 1.0 if scale else 1.0 / math.sqrt(D)
    kw = dict(sm_scale=sm, fixed_max=fixed_max, rope_cos=cos, rope_sin=sin,
              rope_rotate=style)
    lse = name.endswith("_lse")
    if name == "flash_fwd_lse" and not rope:    # the memory tracker's call
        run = lambda: A.flash_attention_with_lse(q, k, v, sm)  # noqa: E731
    elif lse:   # the training forward: the wrapper the autograd Function calls
        run = lambda: A._launch(name[:-4], q, k, v, sm, fixed_max,  # noqa: E731
                                cos, sin, True, style)
    else:
        blocks = ({"block_q": Sq, "block_k_major": Sk, "block_k": Sk}
                  if name == "flash_fwd_single_tile" else {})
        run = lambda: A.flash_attention(q, k, v, **kw, **blocks)  # noqa: E731
    big = B * H * Sq * Sk > 2 ** 30
    plain = ((lambda: plain_chunked(q, k, v, kw, lse)) if big else
             (lambda: A.attention_reference(q, k, v, return_lse=lse, **kw)))
    with torch.no_grad():
        before = A.LAUNCHES[name]
        got = run()
        torch.cuda.synchronize()
        if A.LAUNCHES[name] != before + 1:
            fail(f"{name} {label}: the wrapper did not launch its kernel")
        ref = plain()
        out, ref_out = (got[0], ref[0]) if lse else (got, ref)
        # bf16 outputs: one rounding step is up to 2⁻⁷ of the value, so the
        # error counts in units of max(1, 2|plain|): one step stays within
        # 4e-3 at any magnitude (the camera trunk's few-token averages reach
        # 2-3; the longer rows stay below 0.5, where nothing changes)
        scale = ((2 * ref_out.float().abs()).clamp(min=1.0)
                 if out.dtype == torch.bfloat16 else 1.0)
        err = ((out.float() - ref_out.float()).abs() / scale).max().item()
        lse_err = (got[1] - ref[1]).abs().max().item() if lse else None
        finite = bool(torch.isfinite(out).all())
        slow = B * H * Sq * Sk * D > 2 ** 38
        ms = cuda_ms(run, 3 if slow else 20)
        plain_ms = cuda_ms(plain, 1 if slow else 5)
        qr = A.apply_rope_tables(q, cos, sin, style) if rope else q
        kr = A.apply_rope_tables(k, cos, sin, style) if rope else k
        qr, kr, vc = qr.contiguous(), kr.contiguous(), v.contiguous()
        try:
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qr, kr, vc, scale=sm), 3 if slow else 20)
        except RuntimeError as e:   # no fused SDPA backend took the call
            say("kernel", name=name, case=label, library_error=json.dumps(
                str(e)[:200]))
            lib_ms = None
    bound, bound_by, fma_ms = attention_bound_ms(q, k, rope, lse)
    row = {"name": name, "case": label, "shape_q": list(shape), "Sk": Sk,
           "dtype": str(dtype).split(".")[-1], "fixed_max": fixed_max,
           "rope": style_label(rope), "max_abs_err": err, "tol": atol,
           "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
           "bound_by": bound_by, "fma_bound_ms": fma_ms,
           "bound_share": bound / ms}
    if lse:
        row["lse_max_abs_err"] = lse_err
    say("kernel", **row)
    if not finite or out.shape != q.shape or out.dtype != q.dtype:
        fail(f"{name} {label}: non-finite or misshapen output")
    if not err <= atol:
        fail(f"{name} {label}: max |kernel - plain| = {err} > {atol}")
    if lse and not lse_err <= 1e-5:
        fail(f"{name} {label}: max |lse - plain lse| = {lse_err} > 1e-5")
    return row


# every case: (kernel, label, shape_q, Sk, dtype, fixed_max, rope, atol,
# q shared by the batch rows, sm_scale 1 on a pre-scaled q). bf16
# tolerance: the output rounds to bf16 (a step of 2⁻⁸ relative) after f32
# sums taken in another order than the plain version's; f32: the order
# alone.
def kernel_cases():
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    return [
        ("flash_fwd", "vggt_frame", (2, 16, 1374, 64), 1374, bf, 12.0, "half",
         4e-3, False, None),
        ("flash_fwd", "vggt_global", (1, 16, 2748, 64), 2748, bf, 12.0, "half",
         4e-3, False, None),
        ("flash_fwd", "vggt_camera_trunk", (1, 16, 2, 128), 2, bf, None,
         None, 4e-3, False, None),
        ("flash_fwd", "vitdet_global", (1, 16, 5184, 64), 5184, f32, None,
         "half", 1e-5, False, None),
        ("flash_fwd", "fusion_encoder", (1, 8, 5184, 32), 5184, f32, None,
         None, 1e-5, False, None),
        ("flash_fwd", "ragged", (2, 3, 100, 64), 100, f32, None, "half", 1e-5,
         False, None),
        ("flash_fwd_lse", "memory_tracker", (16, 1, 15876, 64), 63504, f32,
         None, None, 1e-5, True, 0.125),
        ("flash_fwd_lse", "ragged", (4, 1, 1000, 32), 4100, f32, None, None,
         1e-5, True, 0.125),
        ("flash_fwd_single_tile", "vitdet_window", (9, 16, 576, 64), 576, f32,
         None, "half", 1e-5, False, None),
        ("flash_fwd_single_tile", "window_bf16", (2, 4, 576, 64), 576, bf,
         None, "half", 4e-3, False, None),
        ("flash_fwd_single_tile", "ragged", (1, 4, 40, 32), 72, f32, 8.0,
         None, 1e-5, False, None),
        # the training forward (batch 4): K1 and K2 with their lse output
        ("flash_fwd_lse", "vitdet_global_train", (4, 16, 5184, 64), 5184,
         f32, None, "half", 1e-5, False, None),
        ("flash_fwd_lse", "fusion_encoder_train", (4, 8, 5184, 32), 5184,
         f32, None, None, 1e-5, False, None),
        ("flash_fwd_single_tile_lse", "vitdet_window_train",
         (36, 16, 576, 64), 576, f32, None, "half", 1e-5, False, None),
        ("flash_fwd_single_tile_lse", "ragged", (2, 2, 77, 32), 77, f32, 8.0,
         "half", 1e-5, False, None),
        # the sam3 configuration: the interleaved rope at the global blocks
        # and windows, inference (batch 1) and training (batch 4)
        ("flash_fwd", "vitdet_global_sam3", (1, 16, 5184, 64), 5184, f32,
         None, "interleaved", 1e-5, False, None),
        ("flash_fwd_single_tile", "vitdet_window_sam3", (9, 16, 576, 64),
         576, f32, None, "interleaved", 1e-5, False, None),
        ("flash_fwd_lse", "vitdet_global_train_sam3", (4, 16, 5184, 64),
         5184, f32, None, "interleaved", 1e-5, False, None),
        ("flash_fwd_single_tile_lse", "vitdet_window_train_sam3",
         (36, 16, 576, 64), 576, f32, None, "interleaved", 1e-5, False,
         None),
        ("flash_fwd", "ragged_sam3", (2, 3, 1000, 64), 1000, f32, None,
         "interleaved", 1e-5, False, None),
        ("flash_fwd_single_tile", "window_bf16_sam3", (2, 4, 576, 64), 576,
         bf, None, "interleaved", 4e-3, False, None),
        # the segmented style (the MMDiT rope; no ported path runs it) at
        # tests/test_ops.py:237-261's shape: axes (8, 12, 8), a tail of 4
        ("flash_fwd", "segments", (1, 2, 64, 32), 64, f32, None,
         ("segments", SEGMENT_AXES), 1e-5, False, None),
        # the side-view path: run_all's vit_hmr backbone (batch 8, 6 heads,
        # 16² patches), the DINOv3 ViT-H+/16 trunk at crop 512 (32² patches
        # and 5 prefix tokens, its rope on the patch rows only) and MoGe's
        # ViT-L/14 on a batch of 4 padded 1080p frames (78 × 138 patches
        # and 5 prefix tokens)
        ("flash_fwd", "sam3d_vit_hmr", (8, 6, 256, 64), 256, f32, None, None,
         1e-5, False, None),
        ("flash_fwd", "sam3d_dinov3", (8, 20, 1029, 64), 1029, f32, None,
         "dinov3", 1e-5, False, None),
        ("flash_fwd", "moge_vitl", (4, 16, 10769, 64), 10769, f32, None, None,
         1e-5, False, None),
        # the vggt CLI's single mode (S = 30 frames a forward: a 30 s clip
        # at stride 30) and sfm mode (S = 8), VGGT-1B in bf16: frame and
        # global blocks (41220 = 30 × 1374 tokens, no multiple of a tile),
        # the camera trunk over S tokens, and the DINOv2 patch embed of
        # patch_embed_kind "vit" (no rope, online max)
        ("flash_fwd", "vggt_single_global", (1, 16, 41220, 64), 41220, bf,
         12.0, "half", 4e-3, False, None),
        ("flash_fwd", "vggt_single_frame", (30, 16, 1374, 64), 1374, bf, 12.0,
         "half", 4e-3, False, None),
        ("flash_fwd", "vggt_single_camera", (1, 16, 30, 128), 30, bf, None,
         None, 4e-3, False, None),
        ("flash_fwd", "vggt_sfm_global", (1, 16, 10992, 64), 10992, bf, 12.0,
         "half", 4e-3, False, None),
        ("flash_fwd", "vggt_sfm_frame", (8, 16, 1374, 64), 1374, bf, 12.0,
         "half", 4e-3, False, None),
        ("flash_fwd", "vggt_sfm_camera", (1, 16, 8, 128), 8, bf, None, None,
         4e-3, False, None),
        ("flash_fwd", "vggt_dinov2_patch_embed", (8, 16, 1374, 64), 1374, bf,
         None, None, 4e-3, False, None),
        # prepare_dataset's depth task: a batch of 4 frames cropped to
        # 1072 × 1920 (cls + 67 × 120 patches = 8041 tokens), no rope,
        # online max, at the stage's defaults (384 / 12 / 6) and at
        # Intel/dpt-large width (1024 / 24 / 16)
        ("flash_fwd", "dpt_depth", (4, 6, 8041, 64), 8041, f32, None, None,
         1e-5, False, None),
        ("flash_fwd", "dpt_large", (4, 16, 8041, 64), 8041, f32, None, None,
         1e-5, False, None),
        # the compact front model at configs/prepare_front_results.yaml's
        # keys: a batch of 4 frames of 16 × 16 patches, 6 heads of 32, no
        # rope; skix's dispatcher sends it to K1 (no tile edge is given)
        ("flash_fwd", "compact_detector", (4, 6, 256, 32), 256, f32, None,
         None, 1e-5, False, None),
        # the image_edit CLI's MMDiT joint attention at the published width:
        # 16 text rows, then 2 × 32² image tokens (2064: a ragged q tile),
        # 24 heads of 128, f32, the interleaved rope from the joint tables
        ("flash_fwd", "mmdit_joint", (1, 24, 2064, 128), 2064, f32, None,
         "mmdit", 1e-5, False, None),
        # head dims the kernels do not instantiate, zero-padded to the next
        # kernel width by the wrappers: the committed fixture trackers'
        # memory attention (48 features over 2 heads: D = 24, padded to 32;
        # 4 objects × 3 slots of the 224 px fixture's 28² grid), also in
        # bf16; configs/prepare_front_results.yaml's smoke tracker (16
        # features over 2 heads: D = 8) at 4 objects × 4 slots of a 56²
        # grid; D = 48 (padded to 64); K1 alone at the same dims
        ("flash_fwd_lse", "tracker_fixture_d24", (4, 2, 784, 24), 2352, f32,
         None, None, 1e-5, True, 0.125),
        # the VOS path at full width (phase vos): the default tracker's
        # memory attention over 4 objects' banks of 4 slots at 1008 px
        ("flash_fwd_lse", "vos_propagate", (4, 1, 15876, 64), 63504, f32,
         None, None, 1e-5, True, 0.125),
        ("flash_fwd_lse", "tracker_fixture_d24_bf16", (4, 2, 784, 24), 2352,
         bf, None, None, 4e-3, True, 0.125),
        ("flash_fwd_lse", "smoke_tracker_d8", (4, 2, 3136, 8), 12544, f32,
         None, None, 1e-5, True, 0.125),
        ("flash_fwd_lse", "d48", (2, 2, 784, 48), 2352, f32, None, None,
         1e-5, True, 0.125),
        ("flash_fwd", "d24", (1, 2, 784, 24), 784, f32, None, None, 1e-5,
         False, None),
        ("flash_fwd", "d8", (2, 2, 3136, 8), 3136, f32, None, None, 1e-5,
         False, None),
        ("flash_fwd", "d48_bf16", (2, 4, 1000, 48), 1000, bf, None, None,
         4e-3, False, None),
    ]


# --------------------------------------------------------------------------
# phase 3b: the backward kernels against their plain versions
# --------------------------------------------------------------------------
# the forward kernel whose backward each case runs, and that backward
BWD_OF = {"flash_fwd": ("flash_bwd_dkv", "flash_bwd_dq"),
          "flash_fwd_single_tile": ("flash_bwd_single_tile",)}
# operations per B·H·Sq·Sk·D of each backward kernel: its matrix products
# (K3: s, dP, dV, dK; K4: s, dP, dQ; K5: all five)
BWD_OPS = {"flash_bwd_dkv": 8.0, "flash_bwd_dq": 6.0,
           "flash_bwd_single_tile": 10.0}


def backward_bound_ms(name, q, k, rope: bool):
    """The least time the card needs for one backward kernel: its inputs
    (q, k, v, dO, lse, di; the f32 rope tables) read once and its outputs
    written once, against its products at the rate they run at: bf16 at
    989 TFLOP/s, float32 as F32_TF32_PASSES tf32 products at 495; the
    larger of the two. Also the float32 FMA bound (67 TFLOP/s) that a
    kernel on the FMA units would face: ``(ms, bound_by, fma_ms)``, fma_ms
    None for bf16."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    item = q.element_size()
    outs = {"flash_bwd_dkv": 2 * Sk, "flash_bwd_dq": Sq,
            "flash_bwd_single_tile": Sq + 2 * Sk}[name]
    nbytes = (item * B * H * D * (2 * Sq + 2 * Sk + outs)
              + 2 * 4 * B * H * Sq)
    if rope:
        nbytes += 2 * 4 * Sq * D
    ops = BWD_OPS[name] * B * H * Sq * Sk * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    f32 = item == 4
    t_ops = (F32_TF32_PASSES * ops / TF32_OPS_PER_S if f32
             else ops / PEAK_OPS_PER_S["bfloat16"]) * 1e3
    fma_ms = (max(t_bytes, ops / PEAK_OPS_PER_S["float32"] * 1e3) if f32
              else None)
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", fma_ms)


def plain_backward(q, k, v, do, lse, di, sm, cos, sin, style="half",
                   heads: int = 4):
    """The plain K3/K4 (= plain K5) over (batch row, ``heads`` heads)
    chunks: at (4, 16, 5184, 64) one unchunked f32 score matrix is 6.9 GB,
    and the backward holds several."""
    import torch

    from skix_torch.ops import attention as A

    B, H = q.shape[:2]
    grads = [torch.empty_like(x) for x in (q, k, v)]
    for b in range(B):
        for h in range(0, H, heads):
            sl = (slice(b, b + 1), slice(h, h + heads))
            got = A.attention_backward_reference(
                q[sl], k[sl], v[sl], do[sl], lse[sl], di[sl], sm, cos, sin,
                style)
            for g, x in zip(grads, got):
                g[sl] = x
    return grads


def check_backward(case, gen):
    """One backward case: ``(forward kernel, label, shape_q, Sk, dtype,
    fixed_max, rope, tol)``, ``rope`` a rope style or None. The forward
    kernel runs with its lse output,
    then its backward kernels (K3 and K4, or K5) through the wrapper the
    autograd Function calls, against the plain backward on the same
    inputs; each backward kernel is also timed alone. ``tol`` bounds
    max |kernel − plain| over dq, dk, dv relative to max |plain| of each."""
    import torch
    import torch.nn.functional as F

    from skix_torch.ops import attention as A

    fwd, label, shape, Sk, dtype, fixed_max, rope, tol = case
    B, H, Sq, D = shape
    dev = torch.device("cuda")
    q = torch.randn((B, H, Sq, D), generator=gen, device=dev)
    k, v = (torch.randn((B, H, Sk, D), generator=gen, device=dev)
            for _ in range(2))
    do = torch.randn((B, H, Sq, D), generator=gen, device=dev)
    if fixed_max is not None:
        q = F.layer_norm(q, (D,))
        k = F.layer_norm(k, (D,))
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    cos, sin = rope_tables(rope, Sq, D, gen)
    style = kernel_style(rope, D)
    sm = 1.0 / math.sqrt(D)
    kernels = BWD_OF[fwd]
    with torch.no_grad():
        o, lse = A._launch(fwd, q, k, v, sm, fixed_max, cos, sin, True, style)
        di = (o.float() * do.float()).sum(-1)
        before = {n: A.LAUNCHES[n] for n in kernels}
        got = A._launch_backward(kernels, q, k, v, do, lse, di, sm, cos, sin,
                                 style)
        torch.cuda.synchronize()
        if any(A.LAUNCHES[n] != before[n] + 1 for n in kernels):
            fail(f"{kernels} {label}: the wrapper did not launch its kernels")
        # no atomics: a second launch gives the same bits
        again = A._launch_backward(kernels, q, k, v, do, lse, di, sm, cos,
                                   sin, style)
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        big = B * H * Sq * Sk > 2 ** 28
        plain = ((lambda: plain_backward(q, k, v, do, lse, di, sm, cos, sin,
                                         style))
                 if big else (lambda: A.attention_backward_reference(
                     q, k, v, do, lse, di, sm, cos, sin, style)))
        ref = plain()
        errs = {f"d{n}": (g.float() - r.float()).abs().max().item()
                for n, g, r in zip("qkv", got, ref)}
        scales = {f"d{n}": r.float().abs().max().item()
                  for n, r in zip("qkv", ref)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        slow = B * H * Sq * Sk * D > 2 ** 38
        reps = 3 if slow else 10
        ms = {n: cuda_ms(lambda n=n: A._launch_backward(
            (n,), q, k, v, do, lse, di, sm, cos, sin, style), reps)
              for n in kernels}
        plain_ms = cuda_ms(plain, 1 if slow else 3)
    # the yardstick: autograd through SDPA on the pre-roped inputs, its
    # backward alone (the forward runs outside the timed region)
    qr = (A.apply_rope_tables(q, cos, sin, style) if rope else q).detach()
    kr = (A.apply_rope_tables(k, cos, sin, style) if rope else k).detach()
    leaves = [x.contiguous().requires_grad_() for x in (qr, kr, v)]
    out = None
    try:
        out = F.scaled_dot_product_attention(*leaves, scale=sm)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), reps)
    except RuntimeError as e:   # no fused SDPA backend took the call
        say("backward", case=label, library_error=json.dumps(str(e)[:200]))
        lib_ms = None
    del leaves, out
    rows = []
    for n in kernels:
        bound, bound_by, fma_ms = backward_bound_ms(n, q, k, rope is not None)
        row = {"name": n, "case": label, "shape_q": list(shape), "Sk": Sk,
               "dtype": str(dtype).split(".")[-1], "fixed_max": fixed_max,
               "rope": style_label(rope), "max_abs_err": max(errs.values()),
               "errs": errs, "grad_scale": scales, "tol": tol, "ms": ms[n],
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound, "bound_by": bound_by,
               "fma_bound_ms": fma_ms, "bound_share": bound / ms[n],
               "deterministic": deterministic}
        say("backward", **{k_: (json.dumps(v_).replace(" ", "")
                                if isinstance(v_, dict) else v_)
                           for k_, v_ in row.items()})
        rows.append(row)
    if not finite:
        fail(f"{kernels} {label}: non-finite gradients")
    if not deterministic:
        fail(f"{kernels} {label}: two launches gave different gradients")
    bad = [n for n in errs if not errs[n] <= tol * max(scales[n], 1e-30)]
    if bad:
        fail(f"{kernels} {label}: {bad} off by {errs} (scales {scales}, "
             f"tol {tol} relative)")
    return rows


# every backward case: (forward kernel, label, shape_q, Sk, dtype, fixed_max,
# rope, tol relative to max |plain gradient|). f32: the sum order alone
# (sums over up to 5184 rows); bf16: p, dS and the gradients round to bf16,
# and a sum taken in another order can tip one rounding of p or dS (a step
# of 2⁻⁸ relative).
def backward_cases():
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    return [
        ("flash_fwd_single_tile", "vitdet_window", (36, 16, 576, 64), 576,
         f32, None, "half", 1e-5),
        ("flash_fwd", "vitdet_global", (4, 16, 5184, 64), 5184, f32, None,
         "half", 1e-5),
        ("flash_fwd", "fusion_encoder", (4, 8, 5184, 32), 5184, f32, None,
         None, 1e-5),
        ("flash_fwd", "ragged", (2, 3, 1000, 64), 1000, f32, None, "half",
         1e-5),
        ("flash_fwd", "ragged_cross_d128", (1, 2, 77, 128), 130, f32, None,
         None, 1e-5),
        ("flash_fwd", "ragged_d128_bf16", (1, 2, 300, 128), 300, bf, None,
         "half", 2e-2),
        ("flash_fwd_single_tile", "window_d128", (2, 2, 128, 128), 128, f32,
         None, None, 1e-5),
        ("flash_fwd_single_tile", "ragged", (2, 2, 77, 32), 77, f32, 8.0,
         "half", 1e-5),
        ("flash_fwd", "vggt_frame_bf16", (2, 16, 1374, 64), 1374, bf, 12.0,
         "half", 2e-2),
        ("flash_fwd_single_tile", "window_bf16", (2, 4, 576, 64), 576, bf,
         None, "half", 2e-2),
        # the sam3 configuration's training shapes, interleaved rope
        ("flash_fwd_single_tile", "vitdet_window_sam3", (36, 16, 576, 64),
         576, f32, None, "interleaved", 1e-5),
        ("flash_fwd", "vitdet_global_sam3", (4, 16, 5184, 64), 5184, f32,
         None, "interleaved", 1e-5),
        ("flash_fwd", "ragged_sam3", (2, 3, 1000, 64), 1000, f32, None,
         "interleaved", 1e-5),
        ("flash_fwd_single_tile", "window_bf16_sam3", (2, 4, 576, 64), 576,
         bf, None, "interleaved", 2e-2),
        ("flash_fwd", "segments", (1, 2, 64, 32), 64, f32, None,
         ("segments", SEGMENT_AXES), 1e-5),
    ]


# --------------------------------------------------------------------------
# phase 3c: K2's probes
# --------------------------------------------------------------------------
def window_probe_phase():
    """skix_torch.ops.window_probe: every variant of B1-B7 held against its
    plain version on the card, then timed; one line per variant (time,
    spread, share of the bound)."""
    import torch

    from skix_torch.ops import window_probe as W

    def show(r):
        say("window_probe", **{k: (json.dumps(v).replace(" ", "")
                                   if isinstance(v, list) else v)
                               for k, v in r.items()})

    try:
        rows = W.run(reps=20, say=show)
    except RuntimeError as e:
        fail(str(e))
    torch.cuda.empty_cache()
    return rows


def probe_entries(probe_rows):
    """One kernels-line entry per TPU probe B1-B7: K2's variants, no main
    path launches them. ms, plain, SDPA and bound are its first variant's;
    B6's library time is torch.matmul of the same score products; B7's
    times are the A/B's kv_other_major median, checked under B3."""
    from skix_torch.ops import window_probe as W

    out = []
    for row, (script, kline, call, question) in W.PROBES.items():
        mine = [r for r in probe_rows if r["row"] == row]
        checked = [r for r in mine if "max_abs_err" in r]
        if row == "B7":
            ab = mine[0]
            head = dict(next(r for r in probe_rows if r["row"] == "B3"
                             and r["variant"] == "kv_other_major"),
                        ms=ab["kv_other_major_ms"])
            checked = [head]
        else:
            head = checked[0]
        lib = head.get("library_ms")
        if row == "B6":
            lib = next(r["ms"] for r in mine if r["variant"] == "matmul_scores"
                       and r["dtype"] == head["dtype"])
        out.append({
            "name": f"window_probe_{row}", "route": "cuda",
            "source": KERNELS["flash_fwd_single_tile"][0],
            "replaces": f"{script}:{kline}", "pallas_call": f"{script}:{call}",
            "question": question, "launches": 0,
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": lib, "variants": mine})
    return out


# --------------------------------------------------------------------------
# records and weights
# --------------------------------------------------------------------------
def rig(img_size, hw):
    """K per view (at the video size), R_rel, t_rel of ``RIG_POSES``."""
    import numpy as np
    import torch

    from skix_torch.models.vggt import pose_encoding_to_extri_intri

    extr, K = pose_encoding_to_extri_intri(torch.tensor(RIG_POSES),
                                           (img_size, img_size))
    K = K.numpy().copy()
    K[:, 0] *= hw[1] / img_size
    K[:, 1] *= hw[0] / img_size
    R, t = extr[:, :, :3].numpy(), extr[:, :, 3].numpy()
    R_rel = R[1] @ R[0].T
    return K, R_rel, t[1] - R_rel @ t[0]


def write_records(root: Path, T: int, hw, img_size: int, seed: int):
    """Two pt records (person p01) with random uint8 frames and the COCO-17
    keypoints of a skeleton 4 units in front of the rig, 0.3 px noise."""
    import numpy as np

    from skix_torch.io.contracts import PTInfo, save_pt_info

    rng = np.random.default_rng(seed)
    K, R_rel, t_rel = rig(img_size, hw)
    X = (rng.normal(size=(1, 17, 3)) * 0.5
         + rng.normal(size=(T, 17, 3)).cumsum(0) * 0.02
         + np.array([0.0, 0.0, 4.0]))
    xa = X @ K[0].T
    xb = (X @ R_rel.T + t_rel) @ K[1].T
    obs = np.stack([xa[..., :2] / xa[..., 2:], xb[..., :2] / xb[..., 2:]])
    obs = obs + rng.normal(size=obs.shape) * 0.3
    for c, view in enumerate(("osmo_1", "osmo_2")):
        frames = rng.integers(0, 255, (T, *hw, 3), dtype=np.uint8)
        score = np.ones((T, 17), np.float32)
        save_pt_info(root / "p01" / f"{view}.npz", PTInfo(
            video_name=view, frame_count=T, img_shape=tuple(hw), fps=30.0,
            duration=T / 30.0, frames=frames,
            d2_keypoints=np.concatenate([obs[c].astype(np.float32),
                                         score[..., None]], -1),
            d2_keypoints_score=score))
    return X


def fit_rig_head(model, pair):
    """Zero the adaLN modulation and solve pose_branch.fc2 so that the
    model's pose encodings on ``pair`` are ``RIG_POSES``: the cameras are
    then well posed, and the comparison below measures the arithmetic,
    not the conditioning of random cameras."""
    import numpy as np
    import torch

    head = model.camera_head
    with torch.no_grad():
        head.poseLN_modulation.weight.zero_()
        head.poseLN_modulation.bias.zero_()
        seen = []
        hook = head.pose_branch.fc2.register_forward_hook(
            lambda m, inp, out: seen.append(inp[0][0].double().cpu().numpy()))
        model(pair[None])
        hook.remove()
        g = seen[-1]
        dg = g[1] - g[0]
        target = np.asarray(RIG_POSES, np.float64) / 4.0
        Wt = np.outer(target[1] - target[0], dg) / (dg @ dg)
        b = target[0] - Wt @ g[0]
        head.pose_branch.fc2.weight.copy_(torch.as_tensor(Wt, dtype=torch.float32))
        head.pose_branch.fc2.bias.copy_(torch.as_tensor(b, dtype=torch.float32))


# --------------------------------------------------------------------------
# phase 4: small-input reference, card against CPU
# --------------------------------------------------------------------------
def reference_phase(tmp: Path):
    import numpy as np
    import torch

    from skix_torch.config import config_from_mapping
    from skix_torch.pipelines import vggt as V

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size, hw = 56, (112, 112)
    body = {"img_size": size, "embed_dim": 512, "depth": 2, "num_heads": 8,
            "intermediate_layer_idx": [0, 0, 1, 1], "dtype": "float32",
            "frame_stride": 30}
    cfg = config_from_mapping(body)
    root = tmp / "ref_pt"
    X_true = write_records(root, 6, hw, size, seed=5)
    recs = sorted((root / "p01").glob("*.npz"))

    cpu_model = V.load_or_init_variables(
        V.build_model(cfg, torch.device("cpu"), heads=False), cfg)
    from skix_torch.io.contracts import load_pt_info

    frames = [load_pt_info(r).frames[0] for r in recs]
    pair = torch.cat([V.preprocess_frames(f[None], size, "cpu") for f in frames])
    fit_rig_head(cpu_model, pair)
    gpu_model = V.build_model(cfg, torch.device("cuda"), heads=False)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.eval()

    out = {}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        V.process_multi_view(model, recs[0], recs[1], tmp / f"ref_{name}", cfg)
        with np.load(tmp / f"ref_{name}" / "multi_view_refined.npz") as z:
            out[name] = {k: z[k] for k in z.files}
    a, b = out["cpu"], out["cuda"]
    # float32 on both sides; the card sums in another order (the kernel's
    # tiles, cuBLAS, its eigensolver), the LM probes are the same draws.
    # Limits on |card − CPU| / max(1, |CPU|), about 100× what an H100 gave
    tol = {"R": 1e-5, "t": 1e-5, "K": 1e-5, "K_right": 1e-5, "X3d": 1e-4,
           "initial_cost": 1e-5, "final_cost": 1e-5}
    diffs = {}
    for k in tol:
        scale = max(1.0, float(np.abs(a[k]).max()))
        diffs[k] = float(np.abs(a[k] - b[k]).max()) / scale
    err_truth = float(np.abs(b["X3d"] - X_true).max())
    say("reference", **{f"rel_{k}": v for k, v in diffs.items()},
        X3d_vs_truth=err_truth, tol=json.dumps(tol).replace(" ", ""))
    bad = [k for k, limit in tol.items() if not diffs[k] <= limit]
    if bad or not np.isfinite(b["X3d"]).all():
        fail(f"reference: card and CPU disagree on {bad}")
    if not err_truth < 0.5:
        fail(f"reference: X3d is {err_truth} from the rig's skeleton")


# --------------------------------------------------------------------------
# phase 5: the main path at full width
# --------------------------------------------------------------------------
def main_phase(tmp: Path, device: str = "cuda"):
    import numpy as np
    import torch

    from skix_torch.ops import attention as A
    from skix_torch.pipelines.run_all import main as run_all

    pt_root = tmp / "pt"
    t0 = time.perf_counter()
    write_records(pt_root, MAIN_T, MAIN_HW, FULL["vggt_img_size"], seed=11)
    setup_s = time.perf_counter() - t0
    work = tmp / "work"
    cfg = {"paths": {"pt_root": str(pt_root), "work_root": str(work),
                     "video_root": None, "sam3d_root": None},
           "stages": ["vggt"], "kpt_source": "detectron2",
           "vggt_frame_stride": MAIN_STRIDE, "vggt_checkpoint": None,
           "device": device, **FULL}
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run_all(cfg)
    if on_card:
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, by_style = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_STYLE)

    out = work / "vggt" / "p01" / "multi_view_refined.npz"
    if not out.exists():
        fail(f"main path wrote no {out}")
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    summary = json.loads((work / "vggt" / "vggt_summary.json").read_text())
    timing = json.loads((work / "pipeline_timing.json").read_text())
    pairs = len(range(0, MAIN_T, MAIN_STRIDE))
    per_pair = 2 * FULL["vggt_depth"] + 4 * 4   # aggregator + camera trunk
    spans = json.loads((work / "vggt" / "vggt_timing.json").read_text())
    say("main", stage_s=timing["vggt"]["total_s"], wall_s=round(wall_s, 3),
        records_setup_s=round(setup_s, 3),
        vggt_forward_ms_per_pair=spans["vggt_forward"]["mean_ms"],
        triangulate_ms=spans["triangulate"]["mean_ms"],
        bundle_adjust_ms=spans["bundle_adjust"]["mean_ms"],
        pairs=pairs, launches=json.dumps(launches).replace(" ", ""),
        expected_launches=pairs * per_pair,
        peak_mem_gib=(round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
                      if on_card else "not measured"),
        X3d_shape=list(res["X3d"].shape),
        initial_cost=float(res["initial_cost"]),
        final_cost=float(res["final_cost"]))
    if "p01" not in summary or summary["p01"]["vggt_pairs"] != pairs:
        fail(f"vggt summary {summary}")
    if res["X3d"].shape != (MAIN_T, 17, 3) or not np.isfinite(res["X3d"]).all():
        fail(f"X3d {res['X3d'].shape} not a finite ({MAIN_T}, 17, 3)")
    for k in ("R", "t", "K", "K_right"):
        if not np.isfinite(res[k]).all():
            fail(f"{k} not finite")
    if not float(res["final_cost"]) <= float(res["initial_cost"]):
        fail("bundle adjustment raised the cost")
    if launches.get("flash_fwd", 0) != pairs * per_pair:
        fail(f"flash_fwd launched {launches} times on the main path, "
             f"expected {pairs * per_pair}")
    return launches, by_style, cfg


# --------------------------------------------------------------------------
# phase 5b: the same run warm, then once more under the profiler
# --------------------------------------------------------------------------
def device_kernels(prof):
    """The device's kernels (and copies) of a ``torch.profiler`` run, by
    name: ``key``, ``count`` and ``self_device_time_total`` (µs), as
    ``key_averages()`` gives them for device events, summed from the raw
    activity records. ``key_averages()`` first builds a Python object per
    event and its CPU-side tree: 30–60 s for a run of 150 000–300 000
    kernels (the host-bound LM's), against well under a second here."""
    from types import SimpleNamespace

    import torch

    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.duration_ns() / 1e3
        if us <= 0:
            continue
        agg = by_name.setdefault(ev.name(), SimpleNamespace(
            key=ev.name(), count=0, self_device_time_total=0.0))
        agg.count += 1
        agg.self_device_time_total += us
    return list(by_name.values())


def profile_phase(tmp: Path, cfg: dict):
    """A warm rerun of the main path (host clock, per-span means), then one
    under ``torch.profiler`` (device activity only: the host's events of
    the LM's small ops took minutes to aggregate): device time by kernel,
    and the device's idle share of the profiled wall time (one stream, so
    kernels do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skix_torch.pipelines.run_all import main as run_all

    warm = dict(cfg, paths=dict(cfg["paths"], work_root=str(tmp / "warm")))
    t0 = time.perf_counter()
    run_all(warm)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    spans = json.loads((tmp / "warm" / "vggt" / "vggt_timing.json").read_text())
    say("warm", wall_s=round(wall_s, 3),
        **{f"{k}_ms_mean": v["mean_ms"] for k, v in spans.items()},
        **{f"{k}_s_total": v["total_s"] for k, v in spans.items()})

    prof_cfg = dict(cfg, paths=dict(cfg["paths"], work_root=str(tmp / "prof")))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_all(prof_cfg)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    flash_ms = sum(e.self_device_time_total for e in kernels
                   if "flash_fwd" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    say("profile", wall_ms=round(prof_wall_ms, 1),
        device_busy_ms=round(busy_ms, 2),
        device_idle_share=round(1.0 - busy_ms / prof_wall_ms, 4),
        flash_fwd_ms=round(flash_ms, 2), kernels_launched=sum(
            e.count for e in kernels))
    say("profile_top", kernels=json.dumps(
        [[e.key[:60], round(e.self_device_time_total / 1e3, 2), e.count]
         for e in top]).replace(" ", ""))


# --------------------------------------------------------------------------
# phase 6: the front stage at the tiny width, card against CPU
# --------------------------------------------------------------------------
def _front_predictor(device, sam3: bool, state=None):
    """The tiny Sam3Detector of skix's stage test with a tracker whose head
    dim is 64 (the test's features 16 / 2 heads give head dim 8, which the
    kernel does not take), seeded random weights or the given ``state``
    (detector, tracker and CLIP state dicts). ``sam3``: the detector in the
    reference configuration (interleaved rope, a 56-px pretrain position
    table) and prompts through a tiny CLIP tower (width 64, 2 heads, 1
    layer, context 32, CLIP's vocabulary); otherwise hash prompts."""
    import torch

    from skix_torch.tracking.clip_text import VETextEncoder
    from skix_torch.tracking.clip_tokenizer import ClipTokenizer
    from skix_torch.tracking.masklet import MaskletConfig
    from skix_torch.tracking.memory_tracker import MaskMemoryTracker
    from skix_torch.tracking.sam3_detector import Sam3Detector
    from skix_torch.tracking.session import VideoPredictor

    det_kw = dict(rope_style="sam3", pretrain_img_size=56) if sam3 else {}
    det = Sam3Detector.tiny(**det_kw).to(device)
    trk = MaskMemoryTracker(features=64, num_heads=1, mem_slots=3).to(device)
    modules = [det, trk]
    clip = None
    if sam3:
        enc = VETextEncoder(d_model=64, width=64, heads=2, layers=1).to(device)
        modules.append(enc)
        clip = (ClipTokenizer(context_length=enc.context_length), enc.eval())
    for seed, m in enumerate(modules):
        if state is None:
            m.init_weights(torch.Generator(device=device).manual_seed(seed))
        else:
            m.load_state_dict(state[seed])
    cfg = MaskletConfig(max_objects=4, max_dets=6,
                        score_threshold_detection=0.0, new_det_thresh=0.0)
    pred = VideoPredictor(det.eval(), trk.eval(), masklet_cfg=cfg,
                          smoke_prompts=clip is None, clip=clip)
    return pred, [m.state_dict() for m in modules]


def front_reference_phase(tmp: Path, sam3: bool = False):
    """``front_ref`` (hash prompts, skix's rope) or, with ``sam3``,
    ``front_sam3_ref`` (the sam3 rope and the CLIP tower)."""
    import numpy as np

    from skix_torch.config import config_from_mapping
    from skix_torch.ops import attention as A
    from skix_torch.pipelines.prepare_front_results import process_frames

    phase = "front_sam3_ref" if sam3 else "front_ref"
    frames = np.random.default_rng(7).integers(0, 255, (4, 48, 64, 3),
                                               dtype=np.uint8)
    cfg = config_from_mapping({"prompts": FRONT_PROMPTS, "save_mask_size": 24})
    cpu, state = _front_predictor("cpu", sam3)
    gpu, _ = _front_predictor("cuda", sam3, state)
    process_frames(cpu, frames, tmp / f"{phase}_cpu", cfg)
    reset_counts()
    process_frames(gpu, frames, tmp / f"{phase}_cuda", cfg)
    launches, by_style = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_STYLE)
    worst = {}
    for f in sorted((tmp / f"{phase}_cpu").glob("*.npy")):
        a, b = np.load(f), np.load(tmp / f"{phase}_cuda" / f.name)
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{phase}: {f.name} {a.shape}/{a.dtype} on the CPU, "
                 f"{b.shape}/{b.dtype} on the card")
        kind = f.stem.split("_", 1)[1]
        if a.dtype == bool and kind == "masks":
            worst[f.stem] = float((a == b).mean())
        elif a.dtype == bool or a.dtype.kind == "i":
            worst[f.stem] = int((a != b).sum())
        else:
            worst[f.stem] = float(np.abs(a - b).max())
    # limits: the lifecycle (active, ids, valid) exactly; scores 1e-4
    # (float32 sums in another order on each side); boxes within one pixel
    # of the 14×14 tracker grid in frame pixels; masks pixel by pixel
    box_tol = 64 / 14 + 1e-3
    bad = []
    for k, val in worst.items():
        kind = k.split("_", 1)[1]
        ok = (val >= 0.999 if kind == "masks"
              else val <= box_tol if kind == "bboxes"
              else val <= 1e-4 if kind in ("scores", "tracker_scores")
              else val == 0)
        if not ok:
            bad.append(k)
    say(phase, **{k: v for k, v in worst.items()},
        launches=json.dumps(launches).replace(" ", ""),
        launches_by_style=json.dumps(by_style).replace(" ", ""))
    if bad:
        fail(f"{phase}: card and CPU disagree on {bad}")
    # per frame and prompt: one window block (K2), the global block (K1),
    # two tracker memory-attention layers (K1 with lse); the tiny fusion
    # encoder's 64 tokens stay below the flash threshold
    rope = "interleaved" if sam3 else "half"
    want = {"flash_fwd_single_tile": 8, "flash_fwd": 8, "flash_fwd_lse": 16}
    want_style = {f"flash_fwd_single_tile/{rope}": 8,
                  f"flash_fwd/{rope}": 8, "flash_fwd_lse/none": 16}
    if launches != want or by_style != want_style:
        fail(f"{phase}: launches {launches} {by_style}, expected {want} "
             f"{want_style}")


# --------------------------------------------------------------------------
# phase 7: the front stage at full size, then warm, then profiled
# --------------------------------------------------------------------------
def _front_run(tmp: Path, work: Path, frames, extra=None):
    """run_all's prepare_front_results stage on one front video, written
    with the port's write_video (OpenCV) on the first call, with ``extra``
    run_all keys (the sam3 configuration's detector and checkpoints);
    returns the stage's time from ``pipeline_timing.json``."""
    from skix_torch.pipelines.run_all import main as run_all

    video_root = tmp / "front_raw"
    if not video_root.exists():
        from skix_torch.io.video import write_video

        write_video(video_root / "p01" / "clip.mp4", frames, fps=10)
    run_all({"paths": {"pt_root": str(tmp), "work_root": str(work),
                       "video_root": str(video_root)},
             "stages": ["prepare_front_results"], "device": "cuda",
             **(extra or {})})
    timing = json.loads((work / "pipeline_timing.json").read_text())
    return timing["prepare_front_results"]["total_s"]


def front_phase(tmp: Path, phase: str = "front", extra=None,
                per_frame_by_style=None):
    """``front`` (the stage's defaults) or ``front_sam3`` (``extra``: the
    sam3 detector, its checkpoint and the CLIP checkpoint; launches also
    checked by rope style)."""
    import numpy as np
    import torch

    from skix_torch.ops import attention as A

    frames = np.random.default_rng(3).integers(
        0, 255, (FRONT_T, *FRONT_HW, 3), dtype=np.uint8)
    work = tmp / f"{phase}_work"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    stage_s = _front_run(tmp, work, frames, extra)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, by_style = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_STYLE)

    out = work / "front" / "p01"
    summary = work / "front" / "front_summary.json"
    if not summary.exists():
        fail(f"{phase}: no {summary}")
    want = {"person_masks.npy": ((FRONT_T, 16, *FRONT_HW), bool),
            "person_bboxes.npy": ((FRONT_T, 4), np.float32)}
    for name, (shape, dtype) in want.items():
        if not (out / name).exists():
            fail(f"{phase}: the stage wrote no {name} (its per-video errors "
                 "are logged, not raised)")
        a = np.load(out / name)
        if a.shape != shape or a.dtype != dtype:
            fail(f"{phase}: {name} is {a.shape} {a.dtype}, not {shape} "
                 f"{dtype}")
        if a.dtype != bool and not np.isfinite(a).all():
            fail(f"{phase}: {name} is not finite")
    for p in FRONT_PROMPTS[1:]:
        for kind in ("masks", "bboxes", "scores", "tracker_scores", "active",
                     "obj_ids"):
            if not (out / f"{p}_{kind}.npy").exists():
                fail(f"{phase}: no {p}_{kind}.npy")
    spans = json.loads((work / "front" / "front_timing.json").read_text())
    n = FRONT_T * len(FRONT_PROMPTS)
    expected = {k: n * v for k, v in FRONT_PER_FRAME.items()}
    expected_style = {k: n * v for k, v in (per_frame_by_style or {}).items()}
    clip = ({"clip_ms_per_prompt": spans["clip"]["mean_ms"],
             "clip_prompts": spans["clip"]["count"]} if "clip" in spans else {})
    say(phase, stage_s=round(stage_s, 3),
        wall_s=round(wall_s, 3),
        detector_ms_per_frame=spans["detector"]["mean_ms"],
        tracker_ms_per_frame=spans["tracker"]["mean_ms"],
        outputs_ms_per_frame=spans["outputs"]["mean_ms"], **clip, frames=n,
        launches=json.dumps(launches).replace(" ", ""),
        expected_launches=json.dumps(expected).replace(" ", ""),
        launches_by_style=json.dumps(by_style).replace(" ", ""),
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
        person_active_mean=float(np.load(out / "person_active.npy").mean()))
    if launches != expected:
        fail(f"{phase}: launches {launches}, expected {expected}")
    if per_frame_by_style is not None and by_style != expected_style:
        fail(f"{phase}: launches by style {by_style}, expected "
             f"{expected_style}")
    if extra and spans.get("clip", {}).get("count") != len(FRONT_PROMPTS):
        fail(f"{phase}: the prompts did not go through the CLIP tower")
    return launches, by_style, frames


def front_profile_phase(tmp: Path, frames, phase: str = "front", extra=None):
    """A warm rerun of the front stage, then one under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    stage_s = _front_run(tmp, tmp / f"{phase}_warm", frames, extra)
    torch.cuda.synchronize()
    spans = json.loads((tmp / f"{phase}_warm" / "front" / "front_timing.json"
                        ).read_text())
    say(f"{phase}_warm", stage_s=round(stage_s, 3),
        wall_s=round(time.perf_counter() - t0, 3),
        **{f"{k}_ms_mean": v["mean_ms"] for k, v in spans.items()})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _front_run(tmp, tmp / f"{phase}_prof", frames, extra)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_kernel = {name: sum(e.self_device_time_total for e in kernels
                           if name in e.key) / 1e3
                 for name in ("single_tile_kernel", "flash_fwd_kernel")}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    say(f"{phase}_profile", wall_ms=round(prof_wall_ms, 1),
        device_busy_ms=round(busy_ms, 2),
        device_idle_share=round(1.0 - busy_ms / prof_wall_ms, 4),
        k2_ms=round(by_kernel["single_tile_kernel"], 2),
        k1_ms=round(by_kernel["flash_fwd_kernel"], 2),
        kernels_launched=sum(e.count for e in kernels))
    say(f"{phase}_profile_top", kernels=json.dumps(
        [[e.key[:60], round(e.self_device_time_total / 1e3, 2), e.count]
         for e in top]).replace(" ", ""))


# --------------------------------------------------------------------------
# phase 7b: checkpoints of the sam3 configuration, in the reference layout
# --------------------------------------------------------------------------
def write_sam3_checkpoints(tmp: Path):
    """Seeded state dicts in the layouts of the reference checkpoints,
    through the port's converters into skix's checkpoint npz, which the
    stages read: the full-size Sam3Detector of the sam3 configuration
    (``null_prompt`` included, for training; the front stage ignores it),
    whose ViT-Det trunk (1024 × 32, a pos_embed with its cls entry, no
    patch bias) and fusion encoder (6 layers) come from reference-layout
    dicts and whose other leaves are seeded; and a full-size VETextEncoder
    (width 1024, 16 heads, 24 layers, context 32, vocabulary 49408). The
    sizes are read from the port's modules. Returns the two paths."""
    import torch

    from skix_torch.convert import load_into, state_dict_to_flax
    from skix_torch.pipelines.videopose3d import save_checkpoint
    from skix_torch.tracking import clip_text
    from skix_torch.tracking.sam3_detector import (Sam3Detector,
                                                   convert_fusion_encoder)
    from skix_torch.tracking.vitdet import convert_vitdet_state_dict

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def n(*shape, std=0.02, mean=0.0):
        return torch.randn(shape, generator=gen, device=dev) * std + mean

    def ln(sd, key, dim):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = n(dim, mean=1.0), n(dim)

    def lin(sd, key, out, inp):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = n(out, inp), n(out)

    with torch.device("meta"):
        det = Sam3Detector.full_size(null_prompt=True, **SAM3_DETECTOR)
        enc = clip_text.VETextEncoder(d_model=det.d_model)
    bb = det.backbone
    C, grid, p = bb.embed_dim, bb.pos_embed.shape[1], bb.patch_size
    hidden = bb.block_0.mlp.fc1.out_features
    vit = {"patch_embed.proj.weight": n(C, 3, p, p),
           "pos_embed": n(1, 1 + grid * grid, C)}
    ln(vit, "ln_pre", C)
    for i in range(bb.depth):
        ln(vit, f"blocks.{i}.norm1", C)
        ln(vit, f"blocks.{i}.norm2", C)
        lin(vit, f"blocks.{i}.attn.qkv", 3 * C, C)
        lin(vit, f"blocks.{i}.attn.proj", C, C)
        lin(vit, f"blocks.{i}.mlp.fc1", hidden, C)
        lin(vit, f"blocks.{i}.mlp.fc2", C, hidden)
    d, ff = det.d_model, det.encoder.layer_0.ffn.linear1.out_features
    fusion = {}
    for i in range(det.encoder.num_layers):
        pre = f"layers.{i}."
        for name in ("norm1", "norm2", "norm3"):
            ln(fusion, pre + name, d)
        for name in ("self_attn", "cross_attn_image"):
            fusion[pre + name + ".in_proj_weight"] = n(3 * d, d)
            fusion[pre + name + ".in_proj_bias"] = n(3 * d)
            lin(fusion, pre + name + ".out_proj", d, d)
        lin(fusion, pre + "linear1", ff, d)
        lin(fusion, pre + "linear2", d, ff)
    det = det.to_empty(device=dev).init_weights(gen)
    with torch.no_grad():
        load_into(det.backbone, convert_vitdet_state_dict(vit))
        load_into(det.encoder, convert_fusion_encoder(
            fusion, det.encoder.num_layers))
    det_path = tmp / "sam3_detector.npz"
    save_checkpoint(det_path, state_dict_to_flax(det.state_dict()))
    del det, vit, fusion

    tower = enc.encoder
    W = tower.token_embedding.embedding_dim
    vocab = tower.token_embedding.num_embeddings
    ve = {"encoder.token_embedding.weight": n(vocab, W),
          "encoder.positional_embedding": n(enc.context_length, W, std=0.01)}
    for i in range(tower.layers):
        pre = f"encoder.transformer.resblocks.{i}."
        ln(ve, pre + "ln_1", W)
        ln(ve, pre + "ln_2", W)
        ve[pre + "attn.in_proj_weight"] = n(3 * W, W)
        ve[pre + "attn.in_proj_bias"] = n(3 * W)
        lin(ve, pre + "attn.out_proj", W, W)
        lin(ve, pre + "mlp.c_fc", 4 * W, W)
        lin(ve, pre + "mlp.c_proj", W, 4 * W)
    ln(ve, "encoder.ln_final", W)
    lin(ve, "resizer", enc.resizer.out_features, W)
    clip_path = tmp / "sam3_clip.npz"
    save_checkpoint(clip_path, state_dict_to_flax(
        clip_text.convert_ve_text_encoder(ve)))
    del ve, enc
    gc.collect()
    torch.cuda.empty_cache()
    say("sam3_checkpoints", seconds=round(time.perf_counter() - t0, 2),
        detector_mb=round(det_path.stat().st_size / 2 ** 20, 1),
        clip_mb=round(clip_path.stat().st_size / 2 ** 20, 1))
    return det_path, clip_path


# --------------------------------------------------------------------------
# phase 7c: run_all's default chain, card against CPU, then at full width
# --------------------------------------------------------------------------
def chain_rig():
    """K (the stage's default DJI Osmo intrinsics), and view B's R, t: turned
    0.35 rad about y, 6.1 m from view A (the two-view geometry of skix's
    triangulation CLI test)."""
    import numpy as np
    import torch

    from skix_torch.geometry.rotations import rotvec_to_matrix
    from skix_torch.pipelines.triangulation import default_K

    R = rotvec_to_matrix(torch.tensor([0.03, 0.35, 0.01],
                                      dtype=torch.float64)).numpy()
    return default_K(), R, np.array([-6.0, 0.2, 1.0])


def write_chain_inputs(root: Path, persons: int, T: int, seed: int,
                       frames: bool = False):
    """For each person ``pNN``: two pt records (1920×1080, 30 fps) with the
    COCO-17 keypoints of a skier coming down the slope from 20 to 8 m in
    front of the rig (0.5 px noise); the two MHR-70 side views of a moving pose, the
    right one in a rigidly misaligned frame (20 mm noise), as skix's
    run_all test writes them; the front SAM3 person track. With ``frames``
    the records also store frames (``shifted_frames``) and the skier's
    person boxes, for the sam3d_body stage. Returns
    per person the skeleton in view A's frame and the side views' truth."""
    import numpy as np

    from skix_torch.io.contracts import PTInfo, save_pt_info

    rng = np.random.default_rng(seed)
    K, R, t = chain_rig()
    # COCO-17 skeleton (metres, y down): face, shoulders, elbows, wrists,
    # hips, knees, ankles
    base = np.array([[0, -1.6, 0], [-0.04, -1.64, -0.03], [0.04, -1.64, -0.03],
                     [-0.08, -1.62, 0.02], [0.08, -1.62, 0.02],
                     [-0.2, -1.4, 0], [0.2, -1.4, 0], [-0.3, -1.1, 0.05],
                     [0.3, -1.1, 0.05], [-0.35, -0.85, 0.1],
                     [0.35, -0.85, 0.1], [-0.12, -0.9, 0], [0.12, -0.9, 0],
                     [-0.14, -0.48, 0.08], [0.14, -0.48, 0.08],
                     [-0.14, -0.05, 0], [0.14, -0.05, 0]])
    s = np.linspace(0.0, 1.0, T)[:, None, None]
    sec = np.arange(T)[:, None, None] / 30.0
    truth = {}
    for p in range(persons):
        name = f"p{p + 1:02d}"
        phase = rng.uniform(0, 2 * np.pi)
        # a turn every 5 s
        sway = 0.15 * np.sin(2 * np.pi * 0.2 * sec + phase
                             + np.arange(17)[:, None] / 3)
        # down the slope toward the rig: from 20 m up to the left to 8 m
        # down to the right, so the pooled correspondences span the image
        X = (base[None] + sway * np.array([1.0, 0.3, 1.0])
             + s * np.array([10.0, 3.5, -12.0]) + np.array([-5.0, -1.0, 20.0]))
        uv = []
        for Rm, tv in ((np.eye(3), np.zeros(3)), (R, t)):
            Xc = X @ Rm.T + tv
            px = Xc[..., :2] / Xc[..., 2:] * K[[0, 1], [0, 1]] + K[:2, 2]
            uv.append(px + rng.normal(size=px.shape) * 0.5)
        for view, px in zip(("osmo_1", "osmo_2"), uv):
            score = np.ones((T, 17), np.float32)
            extra = {}
            if frames:
                lo, hi = px.min(1), px.max(1)
                extra = dict(frames=shifted_frames(
                    np.random.default_rng(seed + 1), T, CHAIN_HW),
                             yolo_bbox=np.concatenate([lo - 20, hi + 20],
                                                      -1).astype(np.float32))
            save_pt_info(root / "pt" / name / f"{view}.npz", PTInfo(
                video_name=view, frame_count=T, img_shape=CHAIN_HW, fps=30.0,
                duration=T / 30.0,
                d2_keypoints=np.concatenate([px.astype(np.float32),
                                             score[..., None]], -1),
                d2_keypoints_score=score, **extra))
        gt = (rng.normal(size=(1, 70, 3)) * 0.3
              + rng.normal(size=(T, 70, 3)).cumsum(0) * 0.01)
        ang = 0.3
        R_mis = np.array([[np.cos(ang), -np.sin(ang), 0],
                          [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
        side = root / "sam3d" / name
        side.mkdir(parents=True)
        np.save(side / "left_view.npy",
                (gt + rng.normal(size=gt.shape) * 0.02).astype(np.float32))
        np.save(side / "right_view.npy",
                (gt @ R_mis.T + np.array([0.5, -0.2, 1.0])
                 + rng.normal(size=gt.shape) * 0.02).astype(np.float32))
        front = root / "front" / name
        front.mkdir(parents=True)
        xs = np.linspace(300, 900, T)
        np.save(front / "person_bboxes.npy", np.stack(
            [xs, np.full(T, 400.0), xs + 80, np.full(T, 700.0)],
            -1).astype(np.float32))
        truth[name] = (X, gt)
    return truth


def shifted_frames(rng, T: int, hw):
    """T uint8 frames: one smooth random frame (noise at 1/32 of the size,
    upsampled bilinearly), shifted 7 px to the right a frame (made in bulk:
    set-up, not the path). Smooth, so that a crop's pixels move as little
    as its box does: the hand crops follow predicted keypoints, and on
    pixel noise a 1e-3 px shift of a box changes what a random model sees
    by far more than the card's rounding."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    H, W = hw
    low = torch.tensor(rng.random((1, 3, H // 32 + 2, W // 32 + 2)),
                       dtype=torch.float32)
    base = F.interpolate(low, size=(H, W), mode="bilinear",
                         align_corners=False)[0].permute(1, 2, 0)
    base = (base * 255).round().to(torch.uint8).numpy()
    return np.stack([np.roll(base, 7 * t, axis=1) for t in range(T)])


def chain_cfg(root: Path, work: Path, device: str, **size):
    """run_all over ``root``'s inputs: the default stages and front_side,
    ``configs/run_all.yaml``'s settings but for ``size`` and the rig's
    baseline; no lifter checkpoint unless ``size`` names one."""
    import numpy as np

    return {"paths": {"pt_root": str(root / "pt"), "work_root": str(work),
                      "video_root": None, "sam3d_root": str(root / "sam3d"),
                      "front_root": str(root / "front")},
            "stages": CHAIN_STAGES, "lifter_checkpoint": None,
            "kpt_source": "detectron2", "tri_methods": ["kpt"],
            "baseline_m": float(np.linalg.norm(chain_rig()[2])),
            "single_view": False, "plots": False, "render_video": False,
            "gt_root": None, "ba_mode": "pose_only", "ba_method": "lm",
            "device": device, **size}


def check_chain_outputs(phase: str, work: Path, truth: dict, T: int):
    """Every person wrote every artifact of every stage, finite and of the
    expected shape (the stages log a person's exception and go on, so the
    files are the proof); the BA did not raise its cost; the fused MPJPE
    against the side views' truth is below 50 mm. Returns the accuracy by
    person (with the triangulated and refined joints' distance from the
    skeleton)."""
    import numpy as np

    want = {"videopose3d": ["osmo_1_left.npy", "osmo_2_right.npy",
                            "{p}_fused.npz", "{p}_metrics.json"],
            "joints_3d": ["joints_3d_kpt.json", "joints_3d_kpt_smoothed.npy",
                          "ba_input_kpt.npz", "{p}_poses.npz",
                          "{p}_poses.csv"],
            "ba": ["ba_input_kpt_refined.npz", "ba_input_kpt_ba_report.json"],
            "fused": ["{p}_fused.npy", "{p}_smoothed.npy"],
            "front_side": ["{p}_bev.mp4", "{p}_world.npy", "{p}_feet_bev.npy"],
            "angle": ["angles.csv", "turns.csv", "changes.json",
                      "before_after_comparison.json",
                      "turn_comparison.json"]}
    summaries = {"videopose3d/summary.json", "fused/fuse_summary.json",
                 "front_side/front_side_summary.json",
                 "angle/angle_summary.json", "metrics/metrics_report.json"}
    missing = [f"{stage}/{p}/{f.format(p=p)}" for p in truth
               for stage, files in want.items() for f in files
               if not (work / stage / p / f.format(p=p)).exists()]
    missing += [s for s in sorted(summaries) if not (work / s).exists()]
    if missing:
        fail(f"{phase}: artifacts missing (a stage logged and skipped a "
             f"person): {missing[:8]}")
    for s in summaries:
        doc = json.loads((work / s).read_text())
        if sorted(doc) != sorted(truth):
            fail(f"{phase}: {s} covers {sorted(doc)}, not {sorted(truth)}")
    acc = {}
    for p, (X, gt) in truth.items():
        shapes = {f"videopose3d/{p}/osmo_1_left.npy": (T, 17, 3),
                  f"joints_3d/{p}/joints_3d_kpt_smoothed.npy": (T, 17, 3),
                  f"fused/{p}/{p}_fused.npy": (T, 70, 3),
                  f"fused/{p}/{p}_smoothed.npy": (T, 70, 3),
                  f"front_side/{p}/{p}_world.npy": (T, 70, 3)}
        for rel, shape in shapes.items():
            a = np.load(work / rel)
            if a.shape != shape or not np.isfinite(a).all():
                fail(f"{phase}: {rel} is {a.shape}, finite "
                     f"{bool(np.isfinite(a).all())}; want finite {shape}")
        with np.load(work / "ba" / p / "ba_input_kpt_refined.npz") as z:
            X_ba = z["X3d"]
        rep = json.loads((work / "ba" / p / "ba_input_kpt_ba_report.json"
                          ).read_text())
        if not (np.isfinite(X_ba).all() and rep["final_cost"]
                <= rep["initial_cost"]):
            fail(f"{phase}: {p}'s bundle adjustment: {rep}")
        fused = np.load(work / "fused" / p / f"{p}_fused.npy")
        tri = np.load(work / "joints_3d" / p / "joints_3d_kpt_smoothed.npy")
        acc[p] = {"fused_mpjpe_m": float(np.linalg.norm(fused - gt,
                                                        axis=-1).mean()),
                  "ba_joint_err_m": float(np.linalg.norm(X_ba - X,
                                                         axis=-1).mean()),
                  "smoothed_joint_err_m": float(np.linalg.norm(tri - X,
                                                               axis=-1).mean())}
        if not acc[p]["fused_mpjpe_m"] < 0.050:
            fail(f"{phase}: {p}'s fused MPJPE {acc[p]['fused_mpjpe_m']} m")
    # the triangulated joints' distance from the skeleton is reported, not
    # held: the kpt route's pooled pose is skix's unnormalized 8-point
    # RANSAC, which on a skier ~130-300 px tall misses the rig (0.29-2.0
    # rad off on these records, in skix as in the port; ROADMAP Queue 3)
    return acc


def _compare_trees(cpu: Path, card: Path, limits: dict, skip: tuple):
    """The largest |card − CPU| / max(1, |CPU|) of each artifact's numbers
    (arrays, JSON, CSV cells; equality for the rest), by the limit's kind
    (``limits``: file name → kind); files in ``skip`` only have to exist."""
    import csv

    import numpy as np

    def numbers(path):
        if path.suffix == ".npy":
            return {"": np.load(path)}
        if path.suffix == ".npz":
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        if path.suffix == ".json":
            flat = {}

            def walk(prefix, node):
                if isinstance(node, dict):
                    for k, v in node.items():
                        walk(f"{prefix}/{k}", v)
                elif isinstance(node, list):
                    for i, v in enumerate(node):
                        walk(f"{prefix}[{i}]", v)
                else:
                    flat[prefix] = node
            walk("", json.loads(path.read_text()))
            return flat
        rows = list(csv.reader(open(path)))
        return {f"{i}": np.array([float(c) if c else np.nan for c in r])
                for i, r in enumerate(rows[1:])} | {"header": rows[0]}

    worst, bad, by_file = {}, [], {}
    files = sorted(p.relative_to(cpu) for p in cpu.rglob("*") if p.is_file())
    for rel in files:
        b = card / rel
        if not b.exists():
            bad.append(f"{rel}: missing on the card")
            continue
        if rel.name in skip or rel.suffix == ".mp4":
            continue
        kind = limits.get(rel.name, "joints_m")
        na, nb = numbers(cpu / rel), numbers(b)
        if set(na) != set(nb):
            bad.append(f"{rel}: keys {sorted(set(na) ^ set(nb))[:4]}")
            continue
        for k, va in na.items():
            vb = nb[k]
            if isinstance(va, str):       # a path names its own work dir
                va, vb = va.replace(str(cpu), ""), vb.replace(str(card), "")
            if kind == "equal" or isinstance(va, (str, bool, list)) or (
                    isinstance(va, np.ndarray) and va.dtype.kind not in "fc"):
                if not np.array_equal(np.asarray(va), np.asarray(vb)):
                    bad.append(f"{rel}{k}: not equal")
                continue
            va, vb = np.asarray(va, np.float64), np.asarray(vb, np.float64)
            if va.shape != vb.shape or not np.array_equal(np.isnan(va),
                                                          np.isnan(vb)):
                bad.append(f"{rel}{k}: shape or missing values differ")
                continue
            ok = ~np.isnan(va)
            d = (np.abs(va - vb)[ok] / np.maximum(1.0, np.abs(va[ok]))
                 ).max(initial=0.0)
            by_file[f"{rel}{k}"] = float(d)
            if d > worst.get(kind, (-1.0, ""))[0]:
                worst[kind] = (float(d), f"{rel}{k}")
    top = sorted(by_file.items(), key=lambda kv: -kv[1])[:8]
    return worst, bad, top


def chain_reference_phase(tmp: Path, device: str = "cuda"):
    """run_all's chain at skix's run_all-test size (T 24, lifter channels
    32 and widths [3, 3], BA 8 steps × 10 CG) on the card and on the CPU,
    from the same records and the same lifter weights (an npz written
    once): per kind of artifact, the largest difference against its limit.
    Then run_all's side branch, sam3d_body → fuse with ``paths.sam3d_root``
    unset, on the same records (they store 1080p frames and the skier's
    boxes) from a tiny SAM3DBody checkpoint at run_all's keys
    (CHAIN_REF_SIDE), card against CPU: each side-view field against
    side_ref's limit, the fused joints against 1e-4 (the chain above keeps
    its pre-written side views: fed a random model's side views, the angle
    stage's turn boundaries and its angles at straight limbs move with the
    CPU's own thread count). Then the committed
    tests/fixtures/lifter_tiny.npz on the card against the CPU on
    scripts/make_lifter_fixture.py's held-out clips."""
    import importlib.util

    import numpy as np
    import torch

    from skix_torch.convert import state_dict_to_flax
    from skix_torch.models.sam3d_body import SAM3DBody
    from skix_torch.models.videopose3d import TemporalLifter, infer_sequence
    from skix_torch.pipelines.run_all import main as run_all
    from skix_torch.pipelines.videopose3d import (build_lifter, init_lifter,
                                                  save_checkpoint)

    root = tmp / "chain_ref"
    truth = write_chain_inputs(root, 1, CHAIN_REF_T, seed=21, frames=True)
    ckpt = root / "lifter.npz"
    save_checkpoint(ckpt, state_dict_to_flax(init_lifter(TemporalLifter(
        filter_widths=CHAIN_REF["filter_widths"],
        channels=CHAIN_REF["channels"])).state_dict()))
    for dev in ("cpu", device):
        run_all(chain_cfg(root, root / dev, dev, lifter_checkpoint=str(ckpt),
                          **CHAIN_REF))
    check_chain_outputs("chain_ref", root / device, truth, CHAIN_REF_T)
    # limits on |card − CPU| / max(1, |CPU|) by kind: 3D joints in metres
    # (and every other number) 1e-4, angles in degrees 1e-3; the turn
    # segments and the RANSAC's per-frame inlier counts equal
    tol = {"joints_m": 1e-4, "angles_deg": 1e-3, "equal": 0.0}
    limits = {"angles.csv": "angles_deg", "changes.json": "angles_deg",
              "before_after_comparison.json": "angles_deg",
              "turn_comparison.json": "angles_deg", "turns.csv": "equal"}
    worst, bad, top = _compare_trees(root / "cpu", root / device, limits,
                                skip=("pipeline_timing.json",
                                      "ba_input_kpt_ba_report.json",
                                      "ba_summary.json", "p01_poses.csv"))
    reps = [json.loads((root / s / "ba" / "p01" / "ba_input_kpt_ba_report.json"
                        ).read_text()) for s in ("cpu", device)]
    for k in reps[0]:
        if k != "solve_ms":
            d = abs(reps[0][k] - reps[1][k]) / max(1.0, abs(reps[0][k]))
            if d > worst.get("joints_m", (-1.0, ""))[0]:
                worst["joints_m"] = (d, f"ba_report/{k}")
    inl = [np.loadtxt(root / s / "joints_3d" / "p01" / "p01_poses.csv",
                      delimiter=",", skiprows=1, usecols=5)
           for s in ("cpu", device)]
    if not np.array_equal(*inl):
        bad.append("p01_poses.csv: per-frame inlier counts differ")
    # the RANSAC's inlier masks themselves, on the chain's records
    from skix_torch.geometry.epipolar import estimate_relative_pose
    from skix_torch.pipelines.videopose3d import load_2d_keypoints

    recs = sorted((root / "pt" / "p01").glob("*.npz"))
    ka, _, _ = load_2d_keypoints(str(recs[0]))
    kb, _, _ = load_2d_keypoints(str(recs[1]))
    K = torch.tensor(chain_rig()[0], dtype=torch.float32)
    masks = [estimate_relative_pose(
        torch.tensor(ka, device=d), torch.tensor(kb, device=d), K.to(d),
        generator=torch.Generator().manual_seed(0)).inliers.cpu()
        for d in ("cpu", device)]
    if not torch.equal(*masks):
        bad.append("RANSAC inlier masks differ")

    # the committed lifter fixture on the card against the CPU
    spec = importlib.util.spec_from_file_location(
        "make_lifter_fixture", ROOT / "scripts" / "make_lifter_fixture.py")
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    from skix_torch.geometry.camera import normalize_screen_coordinates

    cfg = {"checkpoint": str(ROOT / "tests" / "fixtures" / "lifter_tiny.npz"),
           "filter_widths": [3, 3, 3], "channels": 128}
    mpjpe = {}
    for d in ("cpu", device):
        model = build_lifter(cfg, torch.device(d))
        errs = []
        for seed in (1000, 1001, 1002):
            x3, px = fixture.synth_clip(seed=seed, T=120)
            pred = infer_sequence(model, normalize_screen_coordinates(
                torch.tensor(px, device=d), fixture.W, fixture.H))
            errs.append(float(torch.linalg.norm(
                pred.cpu() - torch.tensor(x3), dim=-1).mean()))
        mpjpe[d] = float(np.mean(errs))
    say("chain_ref", **{f"max_{k}": v[0] for k, v in worst.items()},
        worst_at=json.dumps({k: v[1] for k, v in worst.items()}
                            ).replace(" ", ""),
        largest=json.dumps([[k, float(f"{v:.3g}")] for k, v in top]
                           ).replace(" ", ""),
        tol=json.dumps(tol).replace(" ", ""), ransac_masks_equal=not any(
            "RANSAC" in b for b in bad),
        lifter_tiny_mpjpe_m=mpjpe[device], lifter_tiny_mpjpe_cpu_m=mpjpe["cpu"])
    bad += [f"{k}: {v[0]} at {v[1]} > {tol[k]}" for k, v in worst.items()
            if v[0] > tol[k]]
    if abs(mpjpe[device] - mpjpe["cpu"]) > 1e-5 or not mpjpe[device] < 0.050:
        bad.append(f"lifter_tiny MPJPE {mpjpe}")
    if bad:
        fail(f"chain_ref: card and CPU disagree: {bad[:8]}")

    # the side branch: the side-view model at run_all's keys (the stage's 6
    # heads and decoder depth 4), seeded on the CPU, read by both runs
    side = SAM3DBody(crop_size=CHAIN_REF_SIDE["sam3d_crop_size"],
                     embed_dim=CHAIN_REF_SIDE["sam3d_embed_dim"],
                     depth=CHAIN_REF_SIDE["sam3d_depth"])
    side.init_weights(torch.Generator().manual_seed(5))
    condition_side_model(side)
    save_checkpoint(root / "sam3d.npz", state_dict_to_flax(side.state_dict()))
    for name, dev in (("side_cpu", "cpu"), ("side_card", device)):
        run_all({"paths": {"pt_root": str(root / "pt"),
                           "work_root": str(root / name), "video_root": None,
                           "sam3d_root": None},
                 "stages": ["sam3d_body", "fuse"],
                 "sam3d_checkpoint": str(root / "sam3d.npz"),
                 **CHAIN_REF_SIDE, "device": dev})
    card = root / "side_card"
    files = sorted((card / "sam3d" / "p01").glob("*/frame_*.npz"))
    if len(files) != 2 * CHAIN_REF_T:
        fail(f"chain_ref: the sam3d_body stage wrote {len(files)} frames")
    worst = side_diffs(root / "side_cpu" / "sam3d", card / "sam3d")
    a, b = (np.load(root / d / "fused" / "p01" / "p01_fused.npy")
            for d in ("side_cpu", "side_card"))
    if a.shape != (CHAIN_REF_T, 70, 3) or not np.isfinite(b).all():
        fail(f"chain_ref: the side branch's fused joints are {b.shape}")
    worst["fused_m"] = float(np.abs(a - b).max())
    limits = {k: SIDE_REF_LIMITS.get(k, 1e-4) for k in worst}
    say("chain_ref_side", worst=json.dumps({k: float(f"{v:.3g}")
                                            for k, v in worst.items()}
                                           ).replace(" ", ""),
        limits=json.dumps(limits).replace(" ", ""))
    bad = [k for k, v in worst.items() if not v <= limits[k]]
    if bad:
        fail(f"chain_ref: the side branch's card and CPU disagree on {bad}")


def chain_phase(tmp: Path, device: str = "cuda", persons=None, T=None,
                **size):
    """run_all's default chain plus front_side at configs/run_all.yaml's
    full width (lifter channels 1024, widths 3×5, flip on; kpt RANSAC 256
    hypotheses a frame; BA pose_only, LM 30 × 20 CG) on 2 persons × 2 views
    × 900 frames at 1080p: cold (launch counts reset just before, read just
    after), warm, then the lifter's forward, the kpt route's RANSAC and the
    adaptive EMA's loop timed alone, and once more for one person under
    torch.profiler."""
    import numpy as np
    import torch

    from skix_torch.ops import attention as A
    from skix_torch.pipelines.run_all import main as run_all

    persons = persons or CHAIN_PERSONS
    T = T or CHAIN_T
    size = size or CHAIN_FULL
    on_card = device == "cuda"
    root = tmp / "chain"
    t0 = time.perf_counter()
    truth = write_chain_inputs(root, persons, T, seed=31)
    setup_s = time.perf_counter() - t0

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run_all(chain_cfg(root, root / "cold", device, **size))
    sync()
    cold_s = time.perf_counter() - t0
    launches, by_style = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_STYLE)
    peak = (round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)
            if on_card else "not measured")
    acc = check_chain_outputs("chain", root / "cold", truth, T)
    timing = json.loads((root / "cold" / "pipeline_timing.json").read_text())
    say("chain", persons=persons, frames=T, cold_wall_s=round(cold_s, 3),
        inputs_setup_s=round(setup_s, 3),
        **{f"{k}_s": v["total_s"] for k, v in timing.items()},
        peak_mem_gib=peak, launches=json.dumps(launches).replace(" ", ""),
        accuracy=json.dumps({p: {k: round(v, 5) for k, v in a.items()}
                             for p, a in acc.items()}).replace(" ", ""))
    if any(launches.values()):
        fail(f"chain: flash-attention kernels launched on a path that runs "
             f"none: {launches}")

    t0 = time.perf_counter()
    run_all(chain_cfg(root, root / "warm", device, **size))
    sync()
    warm_s = time.perf_counter() - t0
    timing = json.loads((root / "warm" / "pipeline_timing.json").read_text())
    ba = {p: json.loads((root / "warm" / "ba" / p /
                         "ba_input_kpt_ba_report.json").read_text())
          for p in truth}
    say("chain_warm", wall_s=round(warm_s, 3),
        **{f"{k}_s": v["total_s"] for k, v in timing.items()},
        ba_solve_ms=json.dumps({p: r["solve_ms"] for p, r in ba.items()}
                               ).replace(" ", ""),
        ba_iterations=json.dumps({p: r["iterations"] for p, r in ba.items()}
                                 ).replace(" ", ""))

    # the pieces alone, warm, on the chain's own inputs
    from skix_torch.geometry.smoothing import adaptive_ema
    from skix_torch.pipelines.triangulation import (default_K,
                                                    estimate_poses_kpt)
    from skix_torch.pipelines.videopose3d import (build_lifter, lift_clip,
                                                  load_2d_keypoints)

    recs = sorted((root / "pt" / "p01").glob("*.npz"))
    ka, sa, (H, W) = load_2d_keypoints(str(recs[0]))
    kb, sb, _ = load_2d_keypoints(str(recs[1]))
    model = build_lifter({"filter_widths": size["filter_widths"],
                          "channels": size["channels"]}, torch.device(device))
    x = torch.tensor(ka, device=device)

    def timed(fn, reps):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3

    lift_ms = timed(lambda: lift_clip(x, (W, H), model), 5)
    kpt_ms = timed(lambda: estimate_poses_kpt(ka, kb, sa, sb, default_K(),
                                              6.0, device=device), 3)
    fused = torch.tensor(np.load(root / "warm" / "fused" / "p01" /
                                 "p01_fused.npy"), device=device)
    ema_ms = timed(lambda: adaptive_ema(fused), 3)
    say("chain_pieces", lifter_forward_ms_per_clip=round(lift_ms, 3),
        lifter_frames=T, kpt_ransac_ms_per_frame=round(kpt_ms / T, 4),
        kpt_ransac_ms_per_clip=round(kpt_ms, 3),
        adaptive_ema_ms_per_clip=round(ema_ms, 3),
        adaptive_ema_us_per_frame=round(ema_ms / T * 1e3, 2))
    del model
    if not on_card:
        return launches, by_style

    import shutil

    from torch.profiler import ProfilerActivity, profile

    # the profiled run: one person (p01) of the four, device activity only
    # (the profiler's own processing of the four persons' ~480,000 kernels
    # and their host events took ~4 minutes)
    one = root / "one"
    for part in ("pt", "sam3d", "front"):
        shutil.copytree(root / part / "p01", one / part / "p01")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_all(chain_cfg(one, one / "prof", device, **size))
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    say("chain_profile", persons=1, wall_ms=round(prof_wall_ms, 1),
        device_busy_ms=round(busy_ms, 2),
        device_idle_share=round(1.0 - busy_ms / prof_wall_ms, 4),
        kernels_launched=sum(e.count for e in kernels))
    say("chain_profile_top", kernels=json.dumps(
        [[e.key[:60], round(e.self_device_time_total / 1e3, 2), e.count]
         for e in top]).replace(" ", ""))
    return launches, by_style


# --------------------------------------------------------------------------
# phase 7d: the side-view stage (SAM-3D-Body, MoGe), card against CPU, then
# at the published DINOv3 width; run_all's side branch at its defaults
# --------------------------------------------------------------------------
SIDE_FIELDS = {"pred_keypoints_2d": (70, 2), "pred_keypoints_3d": (70, 3),
               "pred_vertices": (64, 3), "pred_cam_t": (3,),
               "focal_length": (), "bbox": (4,), "pred_global_rots": (70, 3, 3),
               "body_pose_params": (133,), "hand_pose_params": (108,),
               "scale_params": (28,), "shape_params": (45,)}


def write_side_records(root: Path, T: int, seed: int, hw=SIDE_HW,
                       masks: bool = False):
    """Person p01's two side-view records ``cam_left`` and ``cam_right`` of T
    frames of ``hw`` (``shifted_frames``) with the boxes of a skier 300–600
    px tall (scaled to ``hw``'s height over 1080) crossing the frame; the
    right record's box starts across the left edge.
    ``masks``: YOLO person masks (the box's inner half)."""
    import numpy as np

    from skix_torch.io.contracts import PTInfo, save_pt_info

    rng = np.random.default_rng(seed)
    H, W = hw
    frames = shifted_frames(rng, T, hw)
    k = H / 1080.0
    h = np.linspace(300.0, 600.0, T) * k
    for i, view in enumerate(("cam_left", "cam_right")):
        cx = (np.linspace(0.25 * W, 0.75 * W, T) if i == 0
              else np.linspace(40.0 * k, 0.5 * W, T))
        cy = 0.55 * H + 20.0 * k * np.sin(np.arange(T) / 5.0 + i)
        boxes = np.stack([cx - 0.2 * h, cy - 0.5 * h, cx + 0.2 * h,
                          cy + 0.5 * h], -1).astype(np.float32)
        extra = {}
        if masks:
            m = np.zeros((T, 1, H, W), np.uint8)
            for t, (x0, y0, x1, y1) in enumerate(boxes):
                qx, qy = (x1 - x0) / 4, (y1 - y0) / 4
                m[t, 0, max(int(y0 + qy), 0):max(int(y1 - qy), 0),
                  max(int(x0 + qx), 0):max(int(x1 - qx), 0)] = 1
            extra["yolo_mask"] = m
        save_pt_info(root / "p01" / f"{view}.npz", PTInfo(
            video_name=view, frame_count=T, img_shape=hw, fps=30.0,
            duration=T / 30.0, frames=frames, yolo_bbox=boxes, **extra))


def check_side_outputs(phase: str, out: Path, T: int):
    """The stage's summary covers both records with T frames each, every
    frame's npz holds every field, finite and of its shape, and the fuse
    stage's loader reads each record's directory back."""
    import numpy as np

    from skix_torch.pipelines.fuse import load_sam3d_sequence

    summary = json.loads((out / "sam3d_summary.json").read_text())
    want = {f"p01/{v}": T for v in ("cam_left", "cam_right")}
    if summary != want:
        fail(f"{phase}: sam3d_summary {summary}, expected {want}")
    for view in ("cam_left", "cam_right"):
        files = sorted((out / "p01" / view).glob(
            "frame_*_sam_3d_body_outputs.npz"))
        if len(files) != T:
            fail(f"{phase}: {view} has {len(files)} frames, not {T}")
        for f in files:
            with np.load(f) as z:
                for k, shape in SIDE_FIELDS.items():
                    if k not in z.files or z[k].shape != shape \
                            or not np.isfinite(z[k]).all():
                        fail(f"{phase}: {f.name}: {k} missing, misshapen or "
                             f"not finite")
        k3, k2 = load_sam3d_sequence(out / "p01" / view)
        if k3.shape != (T, 70, 3) or k2.shape != (T, 70, 2):
            fail(f"{phase}: the fuse loader read {k3.shape}, {k2.shape}")


def side_diffs(cpu: Path, card: Path) -> dict:
    """The largest |card − CPU| of each side-view output field over every
    frame npz under ``cpu`` and its twin under ``card`` (the focal
    relative)."""
    import numpy as np

    worst = {}
    for f in sorted(cpu.rglob("frame_*.npz")):
        with np.load(f) as a, np.load(card / f.relative_to(cpu)) as b:
            for k in SIDE_REF_LIMITS:
                d = float(np.abs(a[k].astype(np.float64) - b[k]).max())
                if k == "focal_length":
                    d /= float(np.abs(a[k]).max())
                worst[k] = max(worst.get(k, 0.0), d)
    return worst


def condition_side_model(model) -> None:
    """Seeded SAM3DBody weights in a regime where card and CPU are compared
    on arithmetic, not on conditioning: the camera ~15 m away (random
    weights put the joints up to 7 m from the root and the camera 2-3 m
    off, projecting to 7e4 px, where float32's rounding alone exceeds the
    0.05 px limit), the pose heads' last layer at a tenth (poses near the
    rest pose, as a trained head predicts: a random head's rotations reach
    the euler gimbal lock), and the hands' PCA outputs biased to the rest
    hand's continuous pose (what a real PCA mean supplies: with the
    stand-in zero mean the hands' 6D vectors sit near 0, where normalizing
    them amplifies rounding ~1000×)."""
    import torch

    from skix_torch.models import mhr

    rest_hand = mhr.model_params_to_cont_hand(torch.zeros(27))
    with torch.no_grad():
        model.camera_head.fc2.bias[2] = 4.0
        for head in (model.head_pose, model.head_hand):
            head.proj_fc2.weight.mul_(0.1)
            o = 6 + head.body_cont + head.num_shape + head.num_scale
            head.proj_fc2.bias[o:o + 2 * head.num_hand] = rest_hand.repeat(2)


def side_reference_phase(tmp: Path, device: str = "cuda"):
    """The side-view stage tiny on the card and on the CPU from the same
    checkpoints and records: ``inference_type: full`` with the vit_hmr
    backbone and the records' masks, and with a bare DINOv3 trunk (head dim
    64, rope on the patch rows); each output field's largest |card − CPU|
    beside its limit. Then the tiny MoGe estimator on both: its point maps
    and mask logits at two grids (1e-4), and its focal search on synthetic
    perspective maps (1e-4 relative; on a random model's maps the search is
    ill-conditioned, so the stage's MoGe focal is not compared)."""
    import numpy as np
    import torch

    from skix_torch.convert import state_dict_to_flax
    from skix_torch.models.moge import (MoGeFovEstimator, MoGePointModel,
                                        image_uv, recover_focal_shift)
    from skix_torch.models.sam3d_body import SAM3DBody
    from skix_torch.pipelines.prepare_side_results import main as side_main
    from skix_torch.pipelines.videopose3d import save_checkpoint

    root = tmp / "side_ref"
    T = 6
    write_side_records(root / "pt", T, seed=45, hw=(120, 160), masks=True)
    worst, k2_max = {}, 0.0
    for backbone, mask in (("vit_hmr", True), ("dinov3", False)):
        kw = dict(crop_size=64, embed_dim=128, vit_depth=2, num_heads=2,
                  decoder_depth=2, batch_size=4, backbone=backbone)
        model = SAM3DBody(crop_size=64, embed_dim=128, depth=2, num_heads=2,
                          decoder_depth=2, backbone=backbone)
        model.init_weights(torch.Generator().manual_seed(7))
        condition_side_model(model)
        ckpt = root / f"{backbone}.npz"
        save_checkpoint(ckpt, state_dict_to_flax(model.state_dict()))
        for name, dev in (("cpu", "cpu"), ("card", device)):
            side_main({"paths": {"pt_root": str(root / "pt"),
                                 "out_root": str(root / backbone / name)},
                       "checkpoint": str(ckpt), "inference_type": "full",
                       "use_mask": mask, "device": dev, **kw})
        check_side_outputs("side_ref", root / backbone / "card", T)
        worst.update({f"{backbone}/{k}": v for k, v in side_diffs(
            root / backbone / "cpu", root / backbone / "card").items()})
        k2_max = max(k2_max, max(
            float(np.abs(np.load(f)["pred_keypoints_2d"]).max())
            for f in (root / backbone / "cpu").rglob("frame_*.npz")))
    # the tiny MoGe: head dim 32, a 3 × 4 base grid
    moge = MoGePointModel(patch_size=14, embed_dim=64, depth=2, num_heads=2,
                          taps=(0, 0, 0, 1), features=32, num_patches=12)
    moge.init_weights(torch.Generator().manual_seed(8))
    sd = {k: v.clone() for k, v in moge.state_dict().items()}
    ests = {name: MoGeFovEstimator(MoGePointModel(
        patch_size=14, embed_dim=64, depth=2, num_heads=2, taps=(0, 0, 0, 1),
        features=32), sd, grid=(3, 4), device=dev)
        for name, dev in (("cpu", "cpu"), ("card", device))}
    rng = np.random.default_rng(9)
    for grid in ((3, 4), (5, 6)):
        x = torch.tensor(rng.random((2, 14 * grid[0], 14 * grid[1], 3)),
                         dtype=torch.float32)
        outs = {}
        with torch.no_grad():
            for name, est in ests.items():
                pts, msk = est.model(x.to(est.device),
                                     est._pos_embed_for(*grid))
                outs[name] = (pts.cpu(), msk.cpu())
        for i, name in enumerate(("moge/points", "moge/mask_logits")):
            a, b = outs["cpu"][i], outs["card"][i]
            d = float((a - b).abs().max()) / max(1.0, float(a.abs().max()))
            worst[name] = max(worst.get(name, 0.0), d)
    H, W = 60, 80
    u, v = (t.numpy() for t in image_uv(H, W))
    z = 1.0 + 2.0 * rng.random((3, H, W)).astype(np.float32)
    f_true = np.array([0.6, 0.8, 1.1], np.float32)[:, None, None]
    synth = torch.tensor(np.stack([u * z / f_true, v * z / f_true, z - 0.3],
                                  -1), dtype=torch.float32)
    fs = [recover_focal_shift(synth.to(dev))[0].cpu()
          for dev in ("cpu", device)]
    worst["moge/focal_synthetic"] = float(
        ((fs[0] - fs[1]).abs() / fs[0]).max())
    limits = {k: SIDE_REF_LIMITS[k.split("/")[1]] if k.split("/")[1] in
              SIDE_REF_LIMITS else 1e-4 for k in worst}
    say("side_ref", worst=json.dumps({k: float(f"{v:.3g}")
                                      for k, v in worst.items()}
                                     ).replace(" ", ""),
        limits=json.dumps(limits).replace(" ", ""),
        keypoints_2d_max_px=round(k2_max, 1))
    bad = [k for k, v in worst.items() if not v <= limits[k]]
    if bad:
        fail(f"side_ref: card and CPU disagree on {bad}")


def side_phase(tmp: Path, device: str = "cuda"):
    """``prepare_side_results`` at SIDE_CFG (the published DINOv3 ViT-H+/16
    width at crop 512, full inference, MoGe-2 at its full width every 8th
    frame; seeded weights) on two 64-frame 1080p records: cold (launch
    counts reset just before and read just after: exactly 128 K1 launches a
    SAM-3D-Body batch and 24 a MoGe batch, and no other kernel), every
    output checked; warm; each model pass timed alone; then once under
    torch.profiler (device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skix_torch.ops import attention as A
    from skix_torch.pipelines.prepare_side_results import main as side_main

    root = tmp / "side"
    t0 = time.perf_counter()
    write_side_records(root / "pt", SIDE_T, seed=41)
    setup_s = time.perf_counter() - t0

    on_card = device == "cuda"

    def cfg(out):
        return {"paths": {"pt_root": str(root / "pt"), "out_root": str(out)},
                **SIDE_CFG, "device": device}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    side_main(cfg(root / "cold"))
    sync()
    cold_s = time.perf_counter() - t0
    launches, by_style = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_STYLE)
    peak = (round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)
            if on_card else "not measured")
    check_side_outputs("side", root / "cold", SIDE_T)
    batches = 2 * -(-SIDE_T // SIDE_CFG["batch_size"])
    strided = len(range(0, SIDE_T, SIDE_CFG["fov_stride"]))
    moge_batches = 2 * -(-strided // MOGE_BATCH)
    expected_style = {"flash_fwd/segments": batches * SIDE_PER_BATCH,
                      "flash_fwd/none": moge_batches * MOGE_PER_BATCH}
    expected = {"flash_fwd": sum(expected_style.values())}
    frames = 2 * SIDE_T
    say("side", frames=frames, cold_wall_s=round(cold_s, 3),
        cold_ms_per_frame=round(cold_s / frames * 1e3, 2),
        records_setup_s=round(setup_s, 3), peak_mem_gib=peak,
        launches=json.dumps(launches).replace(" ", ""),
        launches_by_style=json.dumps(by_style).replace(" ", ""),
        expected=json.dumps(expected_style).replace(" ", ""))
    if launches != expected or by_style != expected_style:
        fail(f"side: launches {launches} by style {by_style}, expected "
             f"{expected_style}")

    t0 = time.perf_counter()
    side_main(cfg(root / "warm"))
    sync()
    warm_s = time.perf_counter() - t0
    say("side_warm", wall_s=round(warm_s, 3),
        ms_per_frame=round(warm_s / frames * 1e3, 2))
    side_pass_times(root, device)
    if not on_card:
        return launches, by_style

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        side_main(cfg(root / "prof"))
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1_ms = sum(e.self_device_time_total for e in kernels
                if "flash_fwd_kernel" in e.key) / 1e3
    rope_ms = sum(e.self_device_time_total for e in kernels
                  if "rope_rows_kernel" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    say("side_profile", wall_ms=round(prof_wall_ms, 1),
        device_busy_ms=round(busy_ms, 2),
        device_idle_share=round(1.0 - busy_ms / prof_wall_ms, 4),
        k1_ms=round(k1_ms, 2), k1_busy_share=round(k1_ms / busy_ms, 4),
        rope_pass_ms=round(rope_ms, 2),
        kernels_launched=sum(e.count for e in kernels))
    say("side_profile_top", kernels=json.dumps(
        [[e.key[:60], round(e.self_device_time_total / 1e3, 2), e.count]
         for e in top]).replace(" ", ""))
    gc.collect()
    torch.cuda.empty_cache()
    return launches, by_style


def side_pass_times(root: Path, device: str = "cuda"):
    """Each model pass of a SAM-3D-Body batch (8 frames of 1080p) alone,
    warm (CUDA events, median of 3): the crop, the body pass, a hand pass,
    the body pass with the refined hands, the whole batch; MoGe's forward
    on a batch of 4 padded frames and its focal search; per frame."""
    import torch

    from skix_torch.io.contracts import load_pt_info
    from skix_torch.models.moge import recover_focal_shift
    from skix_torch.models.sam3d_body import bbox_center_scale, crop_resize
    from skix_torch.pipelines.prepare_side_results import (
        build_estimator, build_fov_estimator)

    cfg = {**SIDE_CFG, "device": device}
    est, fov = build_estimator(cfg), build_fov_estimator(cfg)
    info = load_pt_info(root / "pt" / "p01" / "cam_right.npz")
    B, S = SIDE_CFG["batch_size"], SIDE_CFG["crop_size"]
    dev = est.device
    with torch.no_grad():
        frames = torch.from_numpy(info.frames[:B]).to(dev).float() / 255.0
        c, s = bbox_center_scale(torch.as_tensor(info.yolo_bbox[:B],
                                                 device=dev))
        crops = crop_resize(frames, c, s, S)
        hand = est.model(crops).mhr.hand
        ms = {"crop": cuda_ms(lambda: crop_resize(frames, c, s, S), 3),
              "body_pass": cuda_ms(lambda: est.model(crops), 3),
              "hand_pass": cuda_ms(lambda: est.model(
                  crops, decoder_type="hand"), 3),
              "body_override_pass": cuda_ms(lambda: est.model(
                  crops, hand_override=hand), 3),
              "batch_full": cuda_ms(lambda: est._forward_batch(
                  frames, c, s, True), 3)}
        H, W = frames.shape[1:3]
        ps = fov.model.patch_size
        Hp, Wp = H + (-H) % ps, W + (-W) % ps
        pos = fov._pos_embed_for(Hp // ps, Wp // ps)
        chunk = torch.nn.functional.pad(frames[:MOGE_BATCH],
                                        (0, 0, 0, Wp - W, 0, Hp - H))
        pts, msk = fov.model(chunk, pos)
        moge_ms = cuda_ms(lambda: fov.model(chunk, pos), 3)
        focal_ms = cuda_ms(lambda: recover_focal_shift(
            pts, torch.sigmoid(msk) > 0.5), 3)
    say("side_passes", **{f"{k}_ms_per_frame": round(v / B, 3)
                          for k, v in ms.items()},
        moge_forward_ms_per_strided_frame=round(moge_ms / MOGE_BATCH, 3),
        moge_focal_search_ms_per_strided_frame=round(focal_ms / MOGE_BATCH, 3),
        sam3d_params_m=round(sum(p.numel() for p in est.model.parameters())
                             / 1e6, 1),
        moge_params_m=round(sum(p.numel() for p in fov.model.parameters())
                            / 1e6, 1))
    del est, fov


def side_chain_phase(tmp: Path, device: str = "cuda", T=None, hw=None):
    """run_all with the sam3d_body stage (``paths.sam3d_root`` unset) at its
    default widths, then fuse, angle and metrics on 1 person × 2 records ×
    160 frames of 1080p (cut from 4 persons × 900 frames: disk, host memory
    and the time limit): cold, launch counts reset just before and read
    just after (exactly 32 K1 launches a batch a record), every artifact
    checked."""
    import numpy as np
    import torch

    from skix_torch.ops import attention as A
    from skix_torch.pipelines.run_all import main as run_all

    T = T or SIDE_CHAIN_T
    on_card = device == "cuda"
    root = tmp / "side_chain"
    t0 = time.perf_counter()
    write_side_records(root / "pt", T, seed=43, hw=hw or SIDE_HW)
    setup_s = time.perf_counter() - t0
    work = root / "work"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run_all({"paths": {"pt_root": str(root / "pt"), "work_root": str(work),
                       "video_root": None, "sam3d_root": None},
             "stages": SIDE_CHAIN_STAGES, "plots": False, "gt_root": None,
             "device": device})
    if on_card:
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, by_style = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_STYLE)
    check_side_outputs("side_chain", work / "sam3d", T)
    fused = np.load(work / "fused" / "p01" / "p01_fused.npy")
    if fused.shape != (T, 70, 3) or not np.isfinite(fused).all():
        fail(f"side_chain: fused {fused.shape}, not a finite ({T}, 70, 3)")
    for rel in ("angle/p01/angles.csv", "angle/angle_summary.json",
                "metrics/metrics_report.json", "fused/fuse_summary.json"):
        if not (work / rel).exists():
            fail(f"side_chain: no {rel}")
    timing = json.loads((work / "pipeline_timing.json").read_text())
    batches = 2 * -(-T // 8)
    expected = {"flash_fwd": batches * SIDE_CHAIN_PER_BATCH}
    say("side_chain", persons=1, records=2, frames=T,
        wall_s=round(wall_s, 3), inputs_setup_s=round(setup_s, 3),
        **{f"{k}_s": v["total_s"] for k, v in timing.items()},
        sam3d_ms_per_frame=round(timing["sam3d_body"]["total_s"]
                                 / (2 * T) * 1e3, 3),
        peak_mem_gib=(round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)
                      if on_card else "not measured"),
        launches=json.dumps(launches).replace(" ", ""),
        expected=json.dumps(expected).replace(" ", ""))
    if launches != expected or set(by_style) != {"flash_fwd/none"}:
        fail(f"side_chain: launches {launches} ({by_style}), expected "
             f"{expected}")
    return launches, by_style


# --------------------------------------------------------------------------
# phase 7e: the vggt CLI's single and sfm modes
# --------------------------------------------------------------------------
def write_clip(path: Path, T: int, hw, seed: int, drift=(3, 1)):
    """A T-frame mp4 of smooth texture (noise at 1/8 of the size, upsampled
    bilinearly) that drifts ``drift`` px (x, y) a frame, so that a corner
    detector finds corners that move; written frame by frame with OpenCV
    (set-up, not the path), once: a clip already at ``path`` is kept."""
    import cv2
    import numpy as np

    if path.exists():
        return

    H, W = hw
    rng = np.random.default_rng(seed)
    low = rng.random((H // 8 + 2, W // 8 + 2, 3)).astype(np.float32)
    base = cv2.resize(low, (W + 16, H + 16), interpolation=cv2.INTER_LINEAR)
    base = (base[8:H + 8, 8:W + 8] * 255).round().astype(np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                          (W, H))
    try:
        for t in range(T):
            frame = np.roll(base, (drift[1] * t, drift[0] * t), axis=(0, 1))
            out.write(frame[..., ::-1])
    finally:
        out.release()


def vggt_cfg(mode: str, videos: Path, out: Path, device: str, **over):
    """configs/vggt.yaml with ``mode``, the paths, the device and ``over``."""
    from skix_torch.config import load_config

    cfg = load_config("vggt", config_dir=ROOT / "configs").to_dict()
    cfg.update(mode=mode, device=device, **over)
    cfg["paths"] = {"video_root": str(videos), "pt_root": str(videos),
                    "out_root": str(out)}
    return cfg


def _read_tokens(path: Path):
    rows = []
    for ln in path.read_text().splitlines():
        if ln.startswith("#"):
            continue
        toks = []
        for t in ln.split():
            try:
                toks.append(float(t))
            except ValueError:
                toks.append(t)
        rows.append(toks)
    return rows


def condition_vggt(model, images) -> None:
    """Seeded VGGT weights whose sfm problem is well posed, so that card
    and CPU are compared on arithmetic, not on conditioning (the way
    ``fit_rig_head`` does for two views). A random camera head drives the
    field of view towards 0, where the focal length amplifies rounding
    without bound, and gives every view the same pose, where bundle
    adjustment cannot see depth: the adaLN modulation zeroed (every
    refinement step adds the same delta) and the pose branch's last layer
    solved (least squares, minimal norm) so that the S views of ``images``
    (1, S, H, W, 3) get cameras 0.3 units apart along x, facing +z, with a
    field of view of 1 rad. A random point head puts points on the camera
    plane, where a projection explodes (BA costs of 1e26): its last layer
    at a hundredth, its bias at points 3 units in front (inv_log:
    expm1(log 4))."""
    import numpy as np
    import torch

    head = model.camera_head
    out = model.point_head.out_conv2b
    S = images.shape[1]
    with torch.no_grad():
        head.poseLN_modulation.weight.zero_()
        head.poseLN_modulation.bias.zero_()
        seen = []
        hook = head.pose_branch.fc2.register_forward_hook(
            lambda m, inp, o: seen.append(inp[0][0].double().cpu().numpy()))
        model(images)
        hook.remove()
        G = np.concatenate([seen[-1], np.ones((S, 1))], axis=1)
        target = np.zeros((S, 9))
        target[:, 0] = -0.3 * np.arange(S)          # t = −R·C, R = I
        target[:, 3] = 1.0                          # quaternion w
        target[:, 7:] = 1.0                         # fov_h, fov_w
        Wb = np.linalg.lstsq(G, target / 4.0, rcond=None)[0]   # (hidden+1, 9)
        head.pose_branch.fc2.weight.copy_(torch.as_tensor(Wb[:-1].T))
        head.pose_branch.fc2.bias.copy_(torch.as_tensor(Wb[-1]))
        out.weight.mul_(0.01)
        out.bias.copy_(torch.tensor([0.0, 0.0, math.log(4.0), 0.0]))


def vggt_reference_phase(tmp: Path, device: str = "cuda"):
    """The vggt CLI's single and sfm modes at a small width (embed 256, 8
    heads of 32: the kernels' smallest head dim; camera trunk 16 heads of
    32), float32, both DPT heads, on the card and on the CPU from the same
    checkpoints: VGGT and the track head seeded on the CPU and written as
    skix npz files (cameras and points conditioned: ``condition_vggt``),
    SuperPoint and ALIKED (aliked-n16) seeded and written
    in their reference layouts (``sfm_extractor: sp+aliked``), so that
    their converters and forwards run on both. The card's tracker gets the
    CPU's query keypoints (its own are compared beside); the ranked query
    frames, the numbers of tracks and every choice of the reconstruction
    must be the same. Limits: cameras 1e-5, the dense maps and points 1e-4
    relative to their scale, tracks (and the sparse model's observations)
    1e-3 px, visibility 1e-4, BA costs 1e-4 of the initial cost; the
    refined poses and points are reported (full BA leaves the similarity
    gauge free)."""
    import numpy as np
    import torch

    from skix_torch.config import config_from_mapping
    from skix_torch.convert import state_dict_to_flax
    from skix_torch.perception import sfm_tracks as ST
    from skix_torch.perception.aliked import reference_aliked_spec
    from skix_torch.perception.superpoint import SuperPoint
    from skix_torch.pipelines import vggt as V
    from skix_torch.pipelines.videopose3d import save_checkpoint

    root = tmp / "vggt_ref"
    write_clip(root / "videos" / "p01" / "clip.mp4", 16, (112, 112), seed=3)
    small = dict(VGGT_REF, checkpoint=str(root / "vggt.npz"),
                 track_checkpoint=str(root / "track.npz"),
                 sfm_superpoint_checkpoint=str(root / "superpoint.pth"),
                 sfm_aliked_checkpoint=str(root / "aliked.pth"))
    cfg0 = config_from_mapping(small)
    # the sfm run's frames (every 2nd, the first 4), for the conditioning
    # and for the dense heads' check
    frames = V._strided_frames(root / "videos" / "p01" / "clip.mp4", 2)[0][:4]
    x = V.preprocess_frames(frames, VGGT_REF["img_size"], "cpu")[None]
    model = V.build_model(cfg0, torch.device("cpu"))
    model.init_weights(torch.Generator().manual_seed(9))
    condition_vggt(model, x)
    save_checkpoint(root / "vggt.npz", state_dict_to_flax(model.state_dict()))
    head = V.build_track_head(cfg0, 2 * VGGT_REF["embed_dim"], 5,
                              torch.device("cpu"))
    head.init_weights(torch.Generator().manual_seed(10))
    save_checkpoint(root / "track.npz", state_dict_to_flax(head.state_dict()))
    # the magicleap layout is the port's own; lightglue's ALIKED from its spec
    torch.save(SuperPoint().init_weights(torch.Generator().manual_seed(11))
               .state_dict(), root / "superpoint.pth")
    g = np.random.default_rng(12)
    aliked = {}
    for k, shape in reference_aliked_spec("aliked-n16").items():
        a = g.normal(size=shape) / np.sqrt(max(1, np.prod(shape[1:])))
        if k.endswith("running_var"):
            a = 1.0 + np.abs(a)
        elif k.endswith(("bn1.weight", "bn2.weight")):
            a = 1.0 + 0.1 * a
        aliked[k] = torch.as_tensor(a.astype(np.float32))
    torch.save(aliked, root / "aliked.pth")

    # the dense heads alone, card against CPU on the same frames
    dense = {}
    for name, dev in (("cpu", "cpu"), ("card", device)):
        m = V.load_or_init_variables(V.build_model(cfg0, torch.device(dev)),
                                     cfg0)
        with torch.no_grad():
            out = m(x.to(dev))
        dense[name] = {k: out[k].float().cpu().numpy() for k in (
            "pose_enc", "depth", "depth_conf", "world_points",
            "world_points_conf")}
        del m, out
    rel = {k: float(np.abs(dense["card"][k] - dense["cpu"][k]).max()
                    / max(1.0, float(np.abs(dense["cpu"][k]).max())))
           for k in dense["cpu"]}

    cpu_kps, card_own, ranks = [], [], {"cpu": [], "card": []}
    extract, rank = ST.extract_keypoints, ST.rank_frames_by_similarity

    def record(side):
        def ranked(*a, **k):
            r = rank(*a, **k)
            ranks[side].append(list(r))
            return r

        def keypoints(image, extractors):
            kp = extract(image, extractors)
            if side == "cpu":
                cpu_kps.append(kp)
                return kp
            card_own.append(kp)
            return cpu_kps[len(card_own) - 1]
        return ranked, keypoints

    outs = {}
    try:
        for side, dev in (("cpu", "cpu"), ("card", device)):
            ST.rank_frames_by_similarity, ST.extract_keypoints = record(side)
            for mode, stride in (("single", 4), ("sfm", 2)):
                out = root / f"{side}_{mode}"
                V.main(vggt_cfg(mode, root / "videos", out, dev,
                                frame_stride=stride, **small))
                outs[side, mode] = out
    finally:
        ST.extract_keypoints, ST.rank_frames_by_similarity = extract, rank

    diffs, bad = {}, []

    def worst(key, a, b, scale_rel=True):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape:
            bad.append(f"{key} shape {a.shape} vs {b.shape}")
            return
        d = float(np.abs(a - b).max()) if a.size else 0.0
        if scale_rel and a.size:
            d /= max(1.0, float(np.abs(a).max()))
        diffs[key] = max(diffs.get(key, 0.0), d)

    with np.load(outs["cpu", "single"] / "p01" / "clip_multi_view_3d_info.npz") as a, \
         np.load(outs["card", "single"] / "p01" / "clip_multi_view_3d_info.npz") as b:
        for k in ("extrinsic", "intrinsic", "R", "t", "C"):
            worst("cameras", a[k], b[k])
            worst(f"single_{k}", a[k], b[k])
        if not np.array_equal(a["frame_indices"], b["frame_indices"]):
            bad.append("frame_indices")
    with np.load(outs["cpu", "sfm"] / "p01" / "clip_sfm_tracks.npz") as a, \
         np.load(outs["card", "sfm"] / "p01" / "clip_sfm_tracks.npz") as b:
        for k in ("R", "t", "K"):
            worst("cameras", a[k], b[k])
            worst(f"sfm_{k}", a[k], b[k])
        worst("tracks_px", a["tracks"], b["tracks"], scale_rel=False)
        worst("vis", a["vis"], b["vis"], scale_rel=False)
        worst("points", a["points_3d"], b["points_3d"])
        if not np.array_equal(a["colors"], b["colors"]):
            bad.append("colors")
        n_tracks = a["tracks"].shape[1]
    for k in ("depth", "depth_conf", "world_points", "world_points_conf"):
        diffs[f"dense_{k}"] = rel[k]
    diffs["pose_enc"] = rel["pose_enc"]
    diffs["cameras"] = max(diffs.get("cameras", 0.0), rel["pose_enc"])
    s_a = json.loads((outs["cpu", "sfm"] / "vggt_summary.json").read_text())["p01/clip"]
    s_b = json.loads((outs["card", "sfm"] / "vggt_summary.json").read_text())["p01/clip"]
    for k in ("frames", "num_tracks", "reconstruction", "valid_tracks"):
        if s_a.get(k) != s_b.get(k):
            bad.append(f"summary {k}: {s_a.get(k)} vs {s_b.get(k)}")
    # BA costs relative to the initial cost (the final one converges
    # towards 0, where a ratio of the two measures nothing)
    for k in ("ba_initial_cost", "ba_final_cost"):
        diffs["ba_cost_rel"] = max(diffs.get("ba_cost_rel", 0.0),
                                   abs(s_b[k] - s_a[k])
                                   / max(abs(s_a["ba_initial_cost"]), 1e-30))
    # the sparse model: identifiers, colors and tracks' element lists equal,
    # observations (the tracks) at the tracks' limit, intrinsics at the
    # cameras'; the refined poses and points are reported: full BA leaves
    # the similarity gauge free, and rounding moves along it
    sparse = {side: outs[side, "sfm"] / "p01" / "clip_sparse"
              for side in ("cpu", "card")}
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        ra, rb = (_read_tokens(sparse[side] / name) for side in ("cpu", "card"))
        if [len(r) for r in ra] != [len(r) for r in rb]:
            bad.append(f"{name}: the lines differ")
            continue
        for row, (la, lb) in enumerate(zip(ra, rb)):
            if name == "cameras.txt":
                kinds = ["id"] * 4 + ["K"] * (len(la) - 4)
            elif name == "points3D.txt":
                kinds = ["id"] + ["refined"] * 3 + ["id"] * (len(la) - 4)
            elif len(la) == 10 and isinstance(la[-1], str):   # an image's pose
                kinds = ["id"] + ["refined"] * 7 + ["id"] * 2
            else:                                            # its observations
                kinds = ["obs", "obs", "id"] * (len(la) // 3)
            for kind, u, w in zip(kinds, la, lb):
                if kind == "id":
                    if u != w:
                        bad.append(f"{name} line {row}: {u} vs {w}")
                        break
                    continue
                key = {"K": "cameras", "obs": "tracks_px",
                       "refined": "colmap_refined"}[kind]
                worst(key, u, w, scale_rel=kind != "obs")
    if ranks["cpu"] != ranks["card"]:
        bad.append(f"ranked query frames {ranks['cpu']} vs {ranks['card']}")
    agree = [len({tuple(p) for p in own} & {tuple(p) for p in kp})
             / max(1, len(kp)) for own, kp in zip(card_own, cpu_kps)]
    limits = VGGT_REF_LIMITS
    say("vggt_ref", **{k: v for k, v in sorted(diffs.items())},
        tracks=n_tracks, query_calls=len(cpu_kps),
        keypoints_per_call=json.dumps([len(k) for k in cpu_kps]).replace(" ", ""),
        card_keypoints_equal_share=round(min(agree, default=0.0), 4),
        ranked=json.dumps(ranks["cpu"]).replace(" ", ""),
        reconstruction=s_b.get("reconstruction"),
        ba_costs_cpu=[s_a.get("ba_initial_cost"), s_a.get("ba_final_cost")],
        ba_costs_card=[s_b.get("ba_initial_cost"), s_b.get("ba_final_cost")],
        limits=json.dumps(limits).replace(" ", ""))
    bad += [f"{k} {diffs[k]} > {limit}" for k, limit in limits.items()
            if not diffs.get(k, float("inf")) <= limit]
    if len(card_own) != len(cpu_kps) or not cpu_kps or n_tracks == 0:
        bad.append(f"{len(card_own)} card and {len(cpu_kps)} CPU query calls, "
                   f"{n_tracks} tracks")
    if not s_b.get("reconstruction"):
        bad.append("no reconstruction written")
    if bad:
        fail(f"vggt_ref: {bad}")


def _vggt_run(phase: str, cfg: dict, expected_by_shape: dict, out: Path):
    """One CLI run of the vggt stage with launch counts reset just before
    and read just after: (wall s, launches, launches by rope style, by
    shape, spans)."""
    import torch

    from skix_torch.ops import attention as A
    from skix_torch.pipelines import vggt as V

    on_card = cfg["device"] == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    V.main(cfg)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_style = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_STYLE)
    by_shape = dict(A.LAUNCHES_BY_SHAPE)
    spans = json.loads((out / "vggt_timing.json").read_text())
    expected = {"flash_fwd": sum(expected_by_shape.values())}
    if on_card and (launches != expected or by_shape != expected_by_shape):
        fail(f"{phase}: launches {launches} by shape {by_shape}, expected "
             f"{expected_by_shape}")
    return wall, launches, by_style, by_shape, spans


def _vggt_profile(phase: str, cfg: dict, forward_ms: float):
    """One more CLI run under torch.profiler (device activity): busy, idle
    share of the wall, K1's device time and its share of busy and of the
    warm forward."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skix_torch.pipelines import vggt as V

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        V.main(cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    k1 = sum(e.self_device_time_total for e in kernels
             if "flash_fwd_kernel" in e.key) / 1e3
    rope = sum(e.self_device_time_total for e in kernels
               if "rope_rows_kernel" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    say(f"{phase}_profile", wall_ms=round(wall_ms, 1),
        device_busy_ms=round(busy, 2),
        device_idle_share=round(1.0 - busy / wall_ms, 4),
        k1_ms=round(k1, 2), k1_busy_share=round(k1 / busy, 4),
        k1_share_of_warm_forward=round(k1 / forward_ms, 4),
        rope_pass_ms=round(rope, 2),
        kernels_launched=sum(e.count for e in kernels))
    say(f"{phase}_profile_top", kernels=json.dumps(
        [[e.key[:60], round(e.self_device_time_total / 1e3, 2), e.count]
         for e in top]).replace(" ", ""))


def vggt_single_phase(tmp: Path, device: str = "cuda", T: int = SINGLE_T,
                      hw=CLIP_HW, **model):
    """The vggt CLI's default: mode single at configs/vggt.yaml (VGGT-1B,
    bf16, 518 px, seeded weights, frame_stride 30) on one 30 s 1080p clip
    at 30 fps: one forward of S = 30 frames (frame blocks (30,16,1374,64),
    global blocks (1,16,41220,64), the camera trunk over 30 tokens). Cold
    (launch counts by shape), warm, profiled. ``device``, ``T``, ``hw`` and
    ``model`` (config overrides) serve a small dry run on the CPU."""
    import numpy as np
    import torch

    root = tmp / "vggt_single"
    videos = tmp / "vggt_clip"
    on_card = device == "cuda"
    t0 = time.perf_counter()
    write_clip(videos / "p01" / "clip.mp4", T, hw, seed=21)
    setup_s = time.perf_counter() - t0
    S = len(range(0, T, 30))
    expected = {f"flash_fwd/1x16x{S * 1374}x64": 24,
                f"flash_fwd/{S}x16x1374x64": 24,
                f"flash_fwd/1x16x{S}x128": 16}
    cfg = lambda out: vggt_cfg("single", videos, out, device,  # noqa: E731
                               **model)
    wall, launches, by_style, by_shape, spans = _vggt_run(
        "vggt_single", cfg(root / "cold"), expected, root / "cold")
    peak = (round(torch.cuda.max_memory_allocated() / 2 ** 30, 3) if on_card
            else "not measured")
    with np.load(root / "cold" / "p01" / "clip_multi_view_3d_info.npz") as z:
        ok = (z["extrinsic"].shape == (S, 3, 4) and z["intrinsic"].shape == (S, 3, 3)
              and all(np.isfinite(z[k]).all() for k in z.files)
              and np.array_equal(z["frame_indices"], np.arange(S) * 30))
    if not ok:
        fail("vggt_single: the cameras npz is not S finite cameras")
    warm_wall, *_, warm = _vggt_run("vggt_single", cfg(root / "warm"),
                                    expected, root / "warm")
    say("vggt_single", frames=T, S=S, clip_setup_s=round(setup_s, 3),
        cold_wall_s=round(wall, 3), warm_wall_s=round(warm_wall, 3),
        forward_ms_cold=spans["vggt_forward"]["mean_ms"],
        forward_ms_warm=warm["vggt_forward"]["mean_ms"], peak_mem_gib=peak,
        launches=json.dumps(launches).replace(" ", ""),
        launches_by_shape=json.dumps(by_shape).replace(" ", ""))
    if on_card:
        _vggt_profile("vggt_single", cfg(root / "prof"),
                      warm["vggt_forward"]["mean_ms"])
    return launches, by_style


def vggt_sfm_phase(tmp: Path, device: str = "cuda", T: int = SFM_T,
                   hw=CLIP_HW, **model):
    """The vggt CLI's sfm mode at configs/vggt.yaml's settings (VGGT-1B
    bf16 with both DPT heads, 8 frames a forward, the track head at
    track_dim 128, hidden 384, 4 iterations, 3 query frames × 512 points,
    sp without weights → Shi–Tomasi, BA full, the COLMAP text) on a
    240-frame 1080p clip (vggt_single's clip read to its frame 240,
    ``max_frames``: the same frames a 240-frame clip gives): cold (launch counts by shape, every span of the
    CLI), profiled; then its pieces alone, warm (CUDA events): the VGGT
    forward, each DPT
    head, the track head's feature extractor, a tracker chunk of 256
    queries; then one forward of VGGT(patch_embed_kind="vit"), the DINOv2
    ViT-L/14 patch embed, on the same 8 frames. ``device``, ``T``, ``hw``
    and ``model`` (config overrides) serve a small dry run on the CPU."""
    import numpy as np
    import torch

    from skix_torch.config import config_from_mapping
    from skix_torch.models.layers import cast_to_compute_dtype
    from skix_torch.models.vggt import VGGT
    from skix_torch.ops import attention as A
    from skix_torch.pipelines import vggt as V

    root = tmp / "vggt_sfm"
    videos = tmp / "vggt_clip"
    on_card = device == "cuda"
    t0 = time.perf_counter()
    write_clip(videos / "p01" / "clip.mp4", T, hw, seed=21)
    setup_s = time.perf_counter() - t0
    S = 8
    expected = {f"flash_fwd/1x16x{S * 1374}x64": 24,
                f"flash_fwd/{S}x16x1374x64": 24,
                f"flash_fwd/1x16x{S}x128": 16}
    gates = {}

    def cfg(out):   # the clip's first T frames, as a T-frame clip reads
        return vggt_cfg("sfm", videos, out, device, max_frames=T, **model,
                        **gates)

    wall, launches, by_style, by_shape, spans = _vggt_run(
        "vggt_sfm", cfg(root / "cold"), expected, root / "cold")
    rep = json.loads((root / "cold" / "vggt_summary.json").read_text()).get(
        "p01/clip", {})
    if rep.get("num_tracks", 0) > 0 and not rep.get("reconstruction"):
        # seeded weights left no reconstruction at the defaults' gates: relax
        # only those gates (a cut, reported) and run again
        gates = dict(VGGT_SFM_GATES)
        wall, launches, by_style, by_shape, spans = _vggt_run(
            "vggt_sfm", cfg(root / "cold"), expected, root / "cold")
        rep = json.loads((root / "cold" / "vggt_summary.json").read_text()
                         ).get("p01/clip", {})
    peak = (round(torch.cuda.max_memory_allocated() / 2 ** 30, 3) if on_card
            else "not measured")
    with np.load(root / "cold" / "p01" / "clip_sfm_tracks.npz") as z:
        shapes = {k: list(z[k].shape) for k in z.files}
        finite = all(np.isfinite(z[k]).all() for k in z.files)
    sparse = root / "cold" / "p01" / "clip_sparse"
    written = all((sparse / f).exists() for f in
                  ("cameras.txt", "images.txt", "points3D.txt"))
    if not (rep.get("reconstruction") and written and finite
            and "bundle_adjust" in spans and "write_colmap" in spans
            and rep.get("num_tracks", 0) > 0):
        fail(f"vggt_sfm: report {rep}, sparse written {written}, finite "
             f"{finite}, spans {sorted(spans)}")
    say("vggt_sfm", frames=T, S=S, clip_setup_s=round(setup_s, 3),
        cold_wall_s=round(wall, 3),
        **{f"{k}_ms": v["mean_ms"] for k, v in spans.items()},
        **{f"{k}_count": v["count"] for k, v in spans.items()},
        num_tracks=rep["num_tracks"], valid_tracks=rep.get("valid_tracks"),
        reconstruction=rep["reconstruction"],
        ba_initial_cost=rep.get("ba_initial_cost"),
        ba_final_cost=rep.get("ba_final_cost"), peak_mem_gib=peak,
        gates_relaxed=json.dumps(gates).replace(" ", ""),
        npz_shapes=json.dumps(shapes).replace(" ", ""),
        launches=json.dumps(launches).replace(" ", ""),
        launches_by_shape=json.dumps(by_shape).replace(" ", ""))
    if not on_card:
        return (launches, by_style), ({}, {})
    _vggt_profile("vggt_sfm", cfg(root / "prof"),
                  spans["vggt_forward"]["mean_ms"])

    # the pieces alone, warm
    gc.collect()
    torch.cuda.empty_cache()
    c = config_from_mapping(cfg(root / "pieces"))
    dev = torch.device("cuda")
    vggt = V.load_or_init_variables(V.build_model(c, dev), c)
    frames = V._strided_frames(videos / "p01" / "clip.mp4", 30, T, S)[0]
    x = V.preprocess_frames(frames, 518, dev)[None]
    head = V.load_or_init_track_head(V.build_track_head(c, 2048, 5, dev), c)
    with torch.no_grad():
        vggt.return_taps = True
        taps = vggt(x)["taps"]
        vggt.return_taps = False
        fmaps = head.features(taps)
        g = torch.Generator(device=dev).manual_seed(5)
        q = torch.rand((1, 256, 2), generator=g, device=dev) * 517
        qv = torch.ones((1, 256), dtype=torch.bool, device=dev)
        t = {"vggt_forward": cuda_ms(lambda: vggt(x), 3),
             "depth_head": cuda_ms(lambda: vggt.depth_head(
                 taps, (518, 518), 5), 5),
             "point_head": cuda_ms(lambda: vggt.point_head(
                 taps, (518, 518), 5), 5),
             "track_features": cuda_ms(lambda: head.features(taps), 5),
             "track_chunk": cuda_ms(lambda: head.track(fmaps, q, qv), 5)}
    del vggt, head, taps, fmaps
    gc.collect()
    torch.cuda.empty_cache()

    # the DINOv2 ViT-L/14 patch embed: one library-level forward, counted
    with torch.device("meta"):
        vit = VGGT(patch_embed_kind="vit", dtype=torch.bfloat16)
    vit = vit.to_empty(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(1))
    vit = cast_to_compute_dtype(vit).eval()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        out = vit(x)
        torch.cuda.synchronize()
        vit_cold_ms = (time.perf_counter() - t0) * 1e3
        vit_launches = dict(A.LAUNCHES)
        vit_by_style = dict(A.LAUNCHES_BY_STYLE)
        vit_by_shape = dict(A.LAUNCHES_BY_SHAPE)
        finite = all(bool(torch.isfinite(out[k]).all()) for k in (
            "pose_enc", "depth", "world_points"))
        vit_ms = cuda_ms(lambda: vit(x), 3)
    say("vggt_sfm_pieces", **{f"{k}_ms": round(v, 3) for k, v in t.items()},
        vit_forward_ms_cold=round(vit_cold_ms, 2),
        vit_forward_ms_warm=round(vit_ms, 3),
        vit_launches=json.dumps(vit_launches).replace(" ", ""),
        vit_launches_by_shape=json.dumps(vit_by_shape).replace(" ", ""))
    vit_expected = dict(expected)
    vit_expected[f"flash_fwd/{S}x16x1374x64"] += 24
    if vit_by_shape != vit_expected or not finite:
        fail(f"vggt_vit: launches by shape {vit_by_shape}, expected "
             f"{vit_expected}; finite {finite}")
    del vit, out
    gc.collect()
    torch.cuda.empty_cache()
    return (launches, by_style), (vit_launches, vit_by_style)


# --------------------------------------------------------------------------
# phase 7f: prepare_dataset (video → records)
# --------------------------------------------------------------------------
def seeded(model, seed: int):
    """Draw every parameter and buffer of ``model`` from a CPU generator
    seeded ``seed`` (kernels with variance 1/fan_in, 1-D weights near 1,
    running variances in [0.5, 1.5], everything else small), in place: a
    random model whose normalizations are not the identity."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if not t.is_floating_point():
                continue
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "running_var":
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif leaf == "weight" and t.dim() >= 2:
                t.copy_(torch.randn(t.shape, generator=g)
                        / math.sqrt(t[0].numel()))
            elif leaf == "weight":
                t.copy_(1.0 + 0.05 * torch.randn(t.shape, generator=g))
            else:
                t.copy_(0.05 * torch.randn(t.shape, generator=g))
    return model.eval()


def save_skix_npz(path: Path, model) -> None:
    """``model``'s weights as a skix checkpoint npz (flat ``params/...``
    keys through ``convert.state_dict_to_flax``; FrozenBN's statistics stay
    parameters), which both the port and skix load."""
    import numpy as np

    from skix_torch.convert import flatten_tree, state_dict_to_flax

    stats = {k.rsplit(".", 1)[0] for k, _ in model.named_parameters()
             if k.endswith("running_mean")}
    frozen = {k.replace(".", "/"): np.zeros(tuple(p.shape))
              for k, p in model.named_parameters()
              if k.rsplit(".", 1)[0] in stats}
    np.savez(path, **flatten_tree(state_dict_to_flax(model.state_dict(),
                                                     frozen or None)))


def scaled_err(got, want) -> float:
    """max |got − want| over max(1, max |want|)."""
    import numpy as np

    got = np.asarray(got.cpu() if hasattr(got, "cpu") else got, np.float64)
    want = np.asarray(want.cpu() if hasattr(want, "cpu") else want,
                      np.float64)
    if got.shape != want.shape:
        return math.inf
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _pick_check(got, want, box_field: str, tol: float):
    """Per image: the same picks (the same valid slots, their boxes within
    ``tol`` scaled) → (images whose picks differ, the largest scaled error
    of every field over the images whose picks agree)."""
    import numpy as np

    differ, worst = 0, {}
    for b in range(want.valid.shape[0]):
        same = (bool(np.array_equal(got.valid[b].cpu().numpy(),
                                    want.valid[b].numpy()))
                and scaled_err(getattr(got, box_field)[b],
                               getattr(want, box_field)[b]) <= tol)
        if not same:
            differ += 1
            continue
        for f in want._fields:
            e = scaled_err(getattr(got, f)[b].float(),
                           getattr(want, f)[b].float())
            worst[f] = max(worst.get(f, 0.0), e)
    return differ, worst


def track_stream(seed: int, T: int = 32, N: int = 6):
    """Synthetic detections (xyxy boxes, scores, valid): four people moving,
    crossing, leaving and arriving, scores over ByteTrack's three bands,
    dropped detections and clutter; and a camera pan-and-zoom as flow."""
    import numpy as np

    rng = np.random.default_rng(seed)
    people = [(0, T, 60, 50, 2.5, 0.5, 30, 70, 0.9),
              (0, T - 6, 150, 60, -2.0, 0.2, 28, 66, 0.6),
              (5, T, 20, 120, 1.0, -1.0, 26, 60, 0.2),
              (10, T, 200, 30, -1.5, 1.5, 32, 72, 0.35)]
    boxes = np.zeros((T, N, 4), np.float32)
    scores = np.zeros((T, N), np.float32)
    valid = np.zeros((T, N), bool)
    for t in range(T):
        slots, si = rng.permutation(N), 0
        for (t0, t1, x0, y0, vx, vy, w, h, sc) in people:
            if not (t0 <= t < t1) or rng.random() < 0.1:
                continue
            n, si = slots[si], si + 1
            cx, cy = x0 + vx * t + rng.normal(), y0 + vy * t + rng.normal()
            boxes[t, n] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
            scores[t, n] = np.clip(sc + 0.05 * rng.normal(), 0.05, 1.0)
            valid[t, n] = True
    ys, xs = np.mgrid[0:64, 0:96].astype(np.float32)
    flow = []
    for _ in range(T - 1):
        a, b = 1.0 + 0.01 * rng.normal(), rng.normal(size=2) * 2.0
        flow.append(np.stack([(a - 1) * xs + b[0], (a - 1) * ys + b[1]]))
    return boxes, scores, valid, np.asarray(flow, np.float32)


def prep_stage_cfg(videos: Path, out: Path, device: str, **over) -> dict:
    """configs/prepare_dataset.yaml with the skix backend, the paths, the
    device and ``over``."""
    from skix_torch.config import load_config

    cfg = load_config("prepare_dataset", config_dir=ROOT / "configs").to_dict()
    cfg.update(backend="skix", device=device, **over)
    cfg["paths"] = {"video_root": str(videos), "out_root": str(out)}
    return cfg


def prep_reference_phase(tmp: Path, device: str = "cuda"):
    """prepare_dataset tiny (the CPU twin's sizes; the depth model 64 wide
    over 2 heads, the kernels' head dim 32), on ``device`` against the CPU,
    stage by stage, with the same seeded weights: YOLO11-n pose, seg and
    detect and Keypoint R-CNN (the raw heads before any NMS within 1e-4,
    the detections where both sides made the same picks within 1e-4, the
    images whose picks differ counted), the DPT depth (1e-4) and RAFT
    (1e-3) maps, ByteTrack (both modes) and the selection on the CPU's
    detections (equal); then the stage (compact detector, depth, flow,
    botsort) through its CLI on both (depth 1e-4, flow 1e-3, the
    keypoints, scores and boxes 1e-4 on the frames whose picks agree,
    at most one frame in ten differing). Every number is relative to the
    quantity's largest element where that exceeds 1 (pixels)."""
    import copy

    import numpy as np
    import torch

    from skix_torch.io.contracts import load_pt_info
    from skix_torch.models import dpt as D
    from skix_torch.models import keypoint_rcnn as R
    from skix_torch.models import raft as F_
    from skix_torch.models import yolo_pose as Y
    from skix_torch.models.pose_detector import PoseDetector
    from skix_torch.ops import attention as A
    from skix_torch.perception import byte_track as BT
    from skix_torch.perception import selection as SEL
    from skix_torch.pipelines.prepare_dataset import main as prep_main

    dev = torch.device(device)
    rng = np.random.default_rng(61)
    imgs = torch.as_tensor(rng.random((4, 64, 96, 3)).astype(np.float32))
    res, bad = {}, []

    def pair(model):
        return model, copy.deepcopy(model).to(dev)

    def hold(key, err, limit):
        res[key] = err
        if not err <= limit:
            bad.append(f"{key}={err} > {limit}")

    # YOLO11-n pose, seg, detect: raw heads, then the decoded detections
    kw = dict(top_k=6, score_threshold=0.3, pre_nms_k=40)
    for kind, model, dec, box in (
            ("pose", Y.YoloPose("n", version=11), lambda r: Y.detect(r, **kw),
             "boxes_xyxy"),
            ("seg", Y.YoloSeg("n", version=11),
             lambda r: Y.detect_seg(r, **kw), "boxes_xyxy"),
            ("detect", Y.YoloDetect("n", num_classes=80, version=11),
             lambda r: Y.detect_boxes(r, classes=(0,), **kw), "boxes_xyxy")):
        cpu, card = pair(seeded(model, 5))
        with torch.no_grad():
            want, got = cpu(imgs), card(imgs.to(dev))
        hold(f"yolo_{kind}_raw", max(scaled_err(getattr(got, f),
                                                getattr(want, f))
                                     for f in want._fields), 1e-4)
        want_dets = dec(want)
        differ, worst = _pick_check(dec(got), want_dets, box, 1e-3)
        res[f"yolo_{kind}_detections"] = int(want_dets.valid.sum())
        res[f"yolo_{kind}_images_picks_differ"] = differ
        hold(f"yolo_{kind}_dets", max(worst.values(), default=0.0), 1e-4)
        if differ > 1:
            bad.append(f"yolo_{kind}: {differ} of 4 images picked otherwise")

    # Keypoint R-CNN R50-FPN: raw RPN heads, then the detections
    rk = dict(pre_nms_topk=32, post_nms_topk=8, detections=4,
              score_threshold=0.3)
    cpu, card = pair(seeded(R.KeypointRCNN(**rk), 6))
    with torch.no_grad():
        want_raw, got_raw = cpu.raw_heads(imgs), card.raw_heads(imgs.to(dev))
        want, got = cpu(imgs), card(imgs.to(dev))
    hold("rcnn_rpn_raw", max(scaled_err(g, w) for gr, wr in
                             zip(got_raw, want_raw)
                             for g, w in zip(gr.rpn_logits + gr.rpn_deltas,
                                             wr.rpn_logits + wr.rpn_deltas)),
         1e-4)
    differ, worst = _pick_check(got, want, "boxes_xyxy", 1e-3)
    res["rcnn_detections"] = int(want.valid.sum())
    res["rcnn_images_picks_differ"] = differ
    hold("rcnn_dets", max(worst.values(), default=0.0), 1e-4)
    if differ > 1:
        bad.append(f"rcnn: {differ} of 4 images picked otherwise")
    del cpu, card

    # DPT depth through the attention path (K1 on the card), RAFT
    dk = dict(patch_size=16, embed_dim=64, depth=4, num_heads=2,
              taps=(0, 1, 2, 3), features=16, image_hw=(64, 96))
    cpu, card = pair(seeded(D.MonocularDepth(**dk), 7))
    reset_counts()
    with torch.no_grad():
        want, got = cpu(imgs), card(imgs.to(dev))
    res["depth_k1_launches"] = dict(A.LAUNCHES)
    hold("depth", scaled_err(got, want), 1e-4)
    fk = dict(hidden=32, context=32, corr_levels=3, corr_radius=3, iters=2)
    cpu, card = pair(seeded(F_.RAFT(**fk), 8))
    with torch.no_grad():
        want = cpu(imgs[:2], imgs[2:])
        got = card(imgs[:2].to(dev), imgs[2:].to(dev))
    hold("flow", scaled_err(got, want), 1e-3)

    # the card's tracker and selection given the CPU's detections
    boxes, scores, valid, flow = track_stream(62)
    gy, gx = BT.motion_grid(64, 96)
    pts = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    samples = np.ascontiguousarray(
        flow[:, :, gy, gx].reshape(len(flow), 2, -1).transpose(0, 2, 1))
    # greedy and exact (bytetrack.exact_match: the auction) association,
    # each without and with the camera motion
    cfgs = [BT.ByteTrackConfig(max_tracks=8),
            BT.ByteTrackConfig(max_tracks=8, exact_match=True)]
    ids_equal = True
    for on in (torch.device("cpu"), dev):
        motion = BT.fit_global_motion(torch.as_tensor(pts, device=on),
                                      torch.as_tensor(samples, device=on))
        ids = [BT.track_sequence_ids(torch.as_tensor(boxes, device=on),
                                     torch.as_tensor(scores, device=on),
                                     torch.as_tensor(valid, device=on), cfg,
                                     motion=m).cpu().numpy()
               for cfg in cfgs for m in (None, motion)]
        cx = torch.as_tensor(np.concatenate(
            [(boxes[..., :2] + boxes[..., 2:]) / 2,
             boxes[..., 2:] - boxes[..., :2]], -1), device=on)
        sel = SEL.select_person_sequence(
            cx, torch.zeros((*boxes.shape[:2], 17, 3), device=on),
            det_valid=torch.as_tensor(valid, device=on),
            track_ids=torch.as_tensor(ids[0], device=on))
        picks = (sel.sel_idx.cpu().numpy(), SEL.fill_invalid_frames(
            sel.boxes, sel.valid).cpu().numpy())
        if on.type == "cpu":
            ref = (ids, picks)
        else:
            ids_equal = (all(np.array_equal(a, b) for a, b in zip(ids, ref[0]))
                         and np.array_equal(picks[0], ref[1][0])
                         and np.array_equal(picks[1], ref[1][1]))
    res["track_ids_and_picks_equal"] = ids_equal
    res["track_ids_emitted"] = int((ref[0][0] >= 0).sum())
    res["track_ids_emitted_exact"] = int((ref[0][2] >= 0).sum())
    if not ids_equal:
        bad.append("the card's tracker or selection differs on the CPU's "
                   "detections")

    # the stage through its CLI, card and CPU, the same checkpoints
    root = tmp / "prep_ref"
    for i in range(2):
        write_clip(root / "videos" / "p01" / f"osmo_{i + 1}.mp4", 8, (64, 96),
                   seed=63 + i, drift=(2, 1))
    ck = root / "ckpt"
    ck.mkdir(parents=True, exist_ok=True)
    save_skix_npz(ck / "det.npz", seeded(PoseDetector(width=16, depth=1), 9))
    save_skix_npz(ck / "depth.npz", seeded(D.MonocularDepth(**dk), 10))
    save_skix_npz(ck / "flow.npz", seeded(F_.RAFT(**fk), 11))
    over = dict(pose_model="compact", d2_model="none",
                tasks=["pose", "depth", "optical_flow"], detector_width=16,
                detector_depth=1, detector_checkpoint=str(ck / "det.npz"),
                top_k=4, score_threshold=0.45, det_batch=4, depth_dim=64,
                depth_layers=4, depth_heads=2, depth_features=16,
                depth_batch=4, depth_checkpoint=str(ck / "depth.npz"),
                flow_hidden=32, flow_context=32, flow_iters=2,
                flow_checkpoint=str(ck / "flow.npz"),
                bytetrack={"tracker_type": "botsort", "max_tracks": 8})
    for side in ("cpu", device):
        prep_main(prep_stage_cfg(root / "videos", root / side, side, **over))
    frames_differ, frames = 0, 0
    for i in range(2):
        name = f"p01/osmo_{i + 1}.npz"
        if not ((root / "cpu" / name).exists()
                and (root / device / name).exists()):
            fail(f"prep_ref: {name} missing (a video failed: see the log)")
        a, b = load_pt_info(root / "cpu" / name), load_pt_info(
            root / device / name)
        hold(f"stage_depth_{i}", scaled_err(b.depth, a.depth), 1e-4)
        hold(f"stage_flow_{i}", scaled_err(b.optical_flow, a.optical_flow),
             1e-3)
        for t in range(a.frame_count):
            frames += 1
            errs = [scaled_err(getattr(b, f)[t], getattr(a, f)[t])
                    for f in ("yolo_keypoints", "yolo_keypoints_score",
                              "yolo_bbox")]
            if max(errs) > 1e-4:
                frames_differ += 1
        if not np.array_equal(a.none_index, b.none_index):
            frames_differ += 1
    res["stage_frames_picks_differ"] = f"{frames_differ}/{frames}"
    if frames_differ * 10 > frames:
        bad.append(f"stage: {frames_differ} of {frames} frames differ")
    from skix_torch.pipelines import prepare_dataset as PD

    PD._MODELS.clear()
    # the mask slot (ROADMAP Queue 3's watch): the picked slot's proto-grid
    # probabilities upsampled (jax's bilinear) to the padded frame and
    # thresholded at 0.5, on the card and on the CPU from the same
    # detections, at the CPU twin's size and at 1080p (proto grid 272 ×
    # 480); a pixel whose value rounds across 0.5 flips (limit 1e-3)
    mr = np.random.default_rng(64)
    shares = []
    for (Hf, Wf), grid in (((60, 70), (16, 24)), ((1080, 1920), (272, 480))):
        boxes = np.abs(mr.normal(size=(8, 3, 4))).astype(np.float32) * 20 + 4
        det = {"seg_boxes": boxes, "seg_valid": mr.random((8, 3)) < 0.7,
               "seg_masks": mr.random((8, 3, *grid)).astype(np.float32)}
        a = PD._assemble_person_mask(det, Hf, Wf, device="cpu")
        b = PD._assemble_person_mask(det, Hf, Wf, device=device)
        shares.append(float((a != b).mean()))
    hold("mask_slot_pixels_differ", max(shares), 1e-3)
    res["mask_slot_pixels_differ_by_size"] = {"60x70": shares[0],
                                              "1080x1920": shares[1]}
    say("prep_ref", **{k: (json.dumps(v).replace(" ", "")
                           if isinstance(v, dict) else v)
                       for k, v in res.items()})
    if device == "cuda" and res["depth_k1_launches"] != {"flash_fwd": 4}:
        bad.append(f"depth launches {res['depth_k1_launches']}, expected "
                   "4 flash_fwd")
    if bad:
        fail("prep_ref: " + "; ".join(bad))


PREP_T, PREP_HW = 40, (1080, 1920)   # 2 videos × 40 frames (a 30 s clip
#                                      is 900; 64 until the training CLIs'
#                                      phases needed the script's time): the
#                                      cut is frames per video
PREP_OVER = dict(bbox_model="detect")   # the yaml's tasks + the detect run


def _prep_records_ok(out: Path, T: int, hw, phase: str) -> None:
    import numpy as np

    from skix_torch.io.contracts import load_pt_info

    H, W = hw
    for i in range(2):
        p = out / "p01" / f"osmo_{i + 1}.npz"
        if not p.exists():
            fail(f"{phase}: no {p.name} (a video failed: see the log)")
        r = load_pt_info(p)
        shapes = {"depth": (T, 1, H, W), "optical_flow": (T - 1, 2, H, W),
                  "yolo_mask": (T, 1, H, W), "yolo_keypoints": (T, 17, 3),
                  "d2_keypoints": (T, 17, 3), "yolo_bbox": (T, 4),
                  "d2_bbox": (T, 4)}
        for k, shape in shapes.items():
            a = getattr(r, k)
            if a is None or a.shape != shape or not np.isfinite(a).all():
                fail(f"{phase}: {p.name} {k} is "
                     f"{None if a is None else a.shape}, not finite {shape}")


def prep_phase(tmp: Path, device: str = "cuda", T: int = PREP_T,
               hw=PREP_HW, **over):
    """prepare_dataset at configs/prepare_dataset.yaml with the skix
    backend and ``bbox_model: detect`` (YOLO11-s pose, seg and detect,
    Keypoint R-CNN R50-FPN, the DPT depth task at the stage's defaults 384
    / 12 / 6 through K1, RAFT 96 / 64 with 8 iterations, ByteTrack; seeded
    weights) on 2 videos × 40 frames of 1080p in one person directory:
    cold (K1 launches by shape: 12 a batch of 4 frames), every record
    checked; each task warm on a quarter of one video's frames, ms a frame;
    the stage warm on the same frames under torch.profiler (device activity:
    busy, idle, K1's share);
    then run_all with ``stages: [prepare_dataset, videopose3d]`` on the
    same videos (the stage at run_all's keys: the compact detector) and the
    records and the lifter's output checked. ``device``, ``T``, ``hw`` and
    ``over`` serve a small dry run on the CPU."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skix_torch.io.video import read_video
    from skix_torch.ops import attention as A
    from skix_torch.pipelines import prepare_dataset as PD
    from skix_torch.pipelines.run_all import main as run_all

    root = tmp / "prep"
    videos = root / "videos"
    on_card = device == "cuda"
    t0 = time.perf_counter()
    for i in range(2):
        write_clip(videos / "p01" / f"osmo_{i + 1}.mp4", T, hw, seed=71 + i,
                   drift=(4 - i, 1 + i))
    setup_s = time.perf_counter() - t0
    cfg = lambda out: prep_stage_cfg(videos, out, device,  # noqa: E731
                                     **{**PREP_OVER, **over})

    def sync():
        if on_card:
            torch.cuda.synchronize()

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    PD.main(cfg(root / "cold"))
    sync()
    cold_s = time.perf_counter() - t0
    launches, by_style = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_STYLE)
    by_shape = dict(A.LAUNCHES_BY_SHAPE)
    peak = (round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)
            if on_card else "not measured")
    _prep_records_ok(root / "cold", T, hw, "prep")
    c = cfg(root / "cold")
    dd, nh = int(c.get("depth_dim", 384)), int(c.get("depth_heads", 6))
    layers, batch = int(c.get("depth_layers", 12)), int(c.get("depth_batch",
                                                              4))
    tokens = (hw[0] // 16) * (hw[1] // 16) + 1
    expected = {f"flash_fwd/{batch}x{nh}x{tokens}x{dd // nh}":
                2 * layers * -(-T // batch)}
    say("prep", videos=2, frames=2 * T, cold_wall_s=round(cold_s, 3),
        cold_ms_per_frame=round(cold_s / (2 * T) * 1e3, 2),
        clips_setup_s=round(setup_s, 3), peak_mem_gib=peak,
        launches=json.dumps(launches).replace(" ", ""),
        launches_by_shape=json.dumps(by_shape).replace(" ", ""),
        expected=json.dumps(expected).replace(" ", ""))
    if on_card and (by_shape != expected or launches != {
            "flash_fwd": sum(expected.values())}):
        fail(f"prep: launches {launches} by shape {by_shape}, expected "
             f"{expected}")
    shutil.rmtree(root / "cold")

    # each task warm on the first quarter of one video (the models built by
    # the cold run), ms a frame
    dev = torch.device(device)
    n = max(T // 4, 2)
    t0 = time.perf_counter()
    frames = read_video(videos / "p01" / "osmo_1.mp4", max_frames=n)
    decode_s = time.perf_counter() - t0
    fd = torch.as_tensor(frames, device=dev)
    ms = {"decode": decode_s * 1e3 / n}

    def timed(name, fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        ms[name] = (time.perf_counter() - t) * 1e3 / n
        return out

    with torch.no_grad():
        bx, kp, vl, sc = timed("yolo_pose", lambda: PD._detect_clip_yolo(
            c, fd, dev))
        timed("yolo_detect", lambda: PD._detect_clip_boxes(c, fd, dev))
        sb, sm, sv, _ = timed("yolo_seg", lambda: PD._detect_clip_seg(
            c, fd, dev))
        timed("rcnn", lambda: PD._detect_clip_rcnn(c, fd, dev))
        timed("depth", lambda: PD._depth_task(c, fd, dev))
        flow = timed("flow", lambda: PD._flow_task(c, fd, dev))
        tid = timed("track", lambda: PD._compute_track_ids(
            c, bx, sc, vl, flow=flow, device=dev))
        timed("select", lambda: PD._select_and_fill(
            {"boxes": bx, "keypoints": kp, "det_valid": vl,
             "track_ids": tid}, dev))
        timed("mask", lambda: PD._assemble_person_mask(
            {"seg_boxes": sb, "seg_masks": sm, "seg_valid": sv}, *hw, dev))
    del fd, flow
    say("prep_tasks", frames=n, **{f"{k}_ms_per_frame": round(v, 3)
                                   for k, v in ms.items()})

    if on_card:
        # the stage warm on the same frames of one of the two videos, under
        # the profiler (its aggregation grows with the kernels launched)
        one = root / "videos_one" / "p01"
        one.mkdir(parents=True)
        (one / "osmo_1.mp4").symlink_to(videos / "p01" / "osmo_1.mp4")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            PD.main(prep_stage_cfg(root / "videos_one", root / "prof",
                                   device, max_frames=n,
                                   **{**PREP_OVER, **over}))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = device_kernels(prof)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        k1_ms = sum(e.self_device_time_total for e in kernels
                    if "flash_fwd_kernel" in e.key) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
        say("prep_profile", videos=1, frames=n,
            warm_wall_s=round(wall_ms / 1e3, 3),
            warm_ms_per_frame=round(wall_ms / n, 2),
            device_busy_ms=round(busy_ms, 2),
            device_idle_share=round(1.0 - busy_ms / wall_ms, 4),
            k1_ms=round(k1_ms, 2), k1_busy_share=round(k1_ms / busy_ms, 4),
            kernels_launched=sum(e.count for e in kernels))
        say("prep_profile_top", kernels=json.dumps(
            [[e.key[:60], round(e.self_device_time_total / 1e3, 2), e.count]
             for e in top]).replace(" ", ""))
        shutil.rmtree(root / "prof")
    PD._MODELS.clear()          # the stage's models, kept across videos

    # run_all's first stage, then the lifter, on the same videos
    work = root / "run_all"
    t0 = time.perf_counter()
    run_all({"paths": {"video_root": str(videos), "pt_root": str(work / "pt"),
                       "work_root": str(work / "work")},
             "stages": ["prepare_dataset", "videopose3d"], "backend": "skix",
             "device": device})
    sync()
    ra_s = time.perf_counter() - t0
    from skix_torch.io.contracts import load_pt_info

    for i in range(2):
        r = load_pt_info(work / "pt" / "p01" / f"osmo_{i + 1}.npz")
        if r.yolo_keypoints.shape != (T, 17, 3) or not np.isfinite(
                r.yolo_keypoints).all():
            fail(f"prep_run_all: record {i + 1} is not T finite keypoints")
    summary = json.loads((work / "work" / "videopose3d" / "summary.json")
                         .read_text())
    lifted = sorted((work / "work" / "videopose3d" / "p01").glob("*.npy"))
    if "p01" not in summary or not lifted or not all(
            np.isfinite(np.load(p)).all() for p in lifted):
        fail(f"prep_run_all: the lifter wrote {summary}, {lifted}")
    timing = json.loads((work / "work" / "pipeline_timing.json").read_text())
    say("prep_run_all", wall_s=round(ra_s, 3),
        prepare_dataset_s=round(timing["prepare_dataset"]["total_s"], 3),
        videopose3d_s=round(timing["videopose3d"]["total_s"], 3),
        lifted=len(lifted))
    PD._MODELS.clear()
    shutil.rmtree(root)
    return launches, by_style


def dpt_large_phase(tmp: Path, device: str = "cuda", hw=PREP_HW, B: int = 4,
                    **width):
    """One warm ``MonocularDepth`` forward at Intel/dpt-large width (1024
    wide, 24 blocks of 16 heads, taps 5/11/17/23, seeded weights) on 4
    frames of 1080p cropped to /16: K1 at (4,16,8041,64), 24 launches a
    forward; ``width`` and ``hw`` serve a small dry run on the CPU."""
    import numpy as np
    import torch

    from skix_torch.models.dpt import MonocularDepth
    from skix_torch.ops import attention as A

    H, W = (hw[0] // 16) * 16, (hw[1] // 16) * 16
    kw = dict(embed_dim=1024, depth=24, num_heads=16, taps=(5, 11, 17, 23),
              features=256)
    kw.update(width)
    model = seeded(MonocularDepth(image_hw=(H, W), **kw), 81).to(device)
    rng = np.random.default_rng(82)
    x = torch.as_tensor(rng.random((B, H, W, 3)).astype(np.float32),
                        device=device)
    on_card = device == "cuda"
    with torch.no_grad():
        model(x)                                   # cold
        if on_card:
            torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        d = model(x)
        if on_card:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    by_shape = dict(A.LAUNCHES_BY_SHAPE)
    nh = kw["num_heads"]
    tokens = (H // 16) * (W // 16) + 1
    expected = {f"flash_fwd/{B}x{nh}x{tokens}x{kw['embed_dim'] // nh}":
                kw["depth"]}
    say("dpt_large", frames=B, warm_forward_ms=round(ms, 2),
        ms_per_frame=round(ms / B, 2), launches_by_shape=json.dumps(
            by_shape).replace(" ", ""))
    if d.shape != (B, H, W) or not bool(torch.isfinite(d).all()):
        fail(f"dpt_large: depth {tuple(d.shape)} not finite {(B, H, W)}")
    if on_card and by_shape != expected:
        fail(f"dpt_large: launches {by_shape}, expected {expected}")
    launches, by_style = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_STYLE)
    del model, x, d
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return launches, by_style


# --------------------------------------------------------------------------
# phase 7g: the view stages' options: the side stage's cascade detector in
# the loop, the compact front model, the ViT-Det tracker trunk with the
# overlay video, front_side's 3D BEV render
# --------------------------------------------------------------------------
# side_det: prepare_side_results with detector_name vitdet at the published
# ViTDet-H width (Cascade Mask R-CNN, 1024 px, batches of 4, 4 person
# slots), the estimator at the stage's defaults (vit_hmr 384 × 8, crop 256,
# batch 8, body), on 2 records × 64 frames of 1080p without person boxes;
# K1 launches a record: 4 slots × 8 batches × 8 blocks (the cascade's
# attention is plain torch)
SIDE_DET_T = 64
SIDE_DET_CFG = dict(detector_name="vitdet", detector_embed_dim=1280,
                    detector_depth=32, detector_num_heads=16,
                    detector_window=14,
                    detector_global_indexes=[7, 15, 23, 31],
                    detector_image_size=1024, detector_batch=4, max_people=4)
SIDE_DET_K1 = 2 * 4 * (SIDE_DET_T // 8) * 8
# side_det_ref: skix's test trunk (32 wide, 2 heads) under the stage's heads,
# the tiny estimator of chain_ref's side branch (6 heads of 32)
DET_REF = dict(embed_dim=32, depth=2, num_heads=2, window_size=2,
               global_indexes=(1,))
SIDE_DET_REF = dict(detector_name="vitdet", detector_embed_dim=32,
                    detector_depth=2, detector_num_heads=2, detector_window=2,
                    detector_global_indexes=[1], detector_image_size=64,
                    detector_batch=3, detector_bbox_thr=0.3, max_people=3,
                    crop_size=64, embed_dim=192, vit_depth=1, num_heads=6,
                    decoder_depth=1, batch_size=4)
# the compact front model at configs/prepare_front_results.yaml's keys on
# 64 frames of 720 × 1280: K1 at (4, 6, 256, 32), 6 blocks a batch of 4
COMPACT_T, COMPACT_HW = 64, (720, 1280)
COMPACT_SHAPE = "flash_fwd/4x6x256x32"
# front_trunk: the default front stage with the memory tracker's ViT-Det
# trunk (patch 14, 1024 wide, 32 deep, 16 heads, window 24) and the overlay
# video; per frame and prompt the detector's and the trunk's 28 window
# blocks (K2) and 4 global blocks (K1), the fusion encoder's 6 (K1), the
# memory attention's 2 (K1 with lse)
TRUNK_PER_FRAME = {"flash_fwd_single_tile": 28 + 28, "flash_fwd": 4 + 6 + 4,
                   "flash_fwd_lse": 2}
# render3d: front_side with render3d at its 1280 × 720 default on 1 person ×
# 300 frames (cut: persons, frames)
RENDER_T = 300


def _smooth_record(root: Path, name: str, T: int, hw, seed: int):
    """A side-view record of T smooth frames (``shifted_frames``) stored
    without person boxes."""
    import numpy as np

    from skix_torch.io.contracts import PTInfo, save_pt_info

    frames = shifted_frames(np.random.default_rng(seed), T, hw)
    save_pt_info(root / "p01" / f"{name}.npz", PTInfo(
        video_name=name, frame_count=T, img_shape=hw, fps=30.0,
        duration=T / 30.0, frames=frames))


def side_det_reference_phase(tmp: Path, device: str = "cuda"):
    """The cascade at skix's test trunk under the stage's heads (the person
    logits lifted so that boxes pass the thresholds), seeded, on the card
    against the CPU: the raw heads before the box stages' NMS (RPN logits
    and deltas, the proposal slots where both picked the same, and each of
    the three stages' logits and deltas on the CPU's input boxes, 1e-4;
    the freely chained stages reported), the detections where both made
    the same picks (1e-4), the images picked otherwise; then the side stage with the
    detector in the loop through its CLI on one record without boxes (the
    tiny estimator, conditioned as side_ref's): the frames whose person
    slots differ counted, and on the others each npz field against
    side_ref's limits (the boxes 1e-4 of the frame). Every number relative
    to the quantity's largest element where that exceeds 1."""
    import copy

    import numpy as np
    import torch

    from skix_torch.models import cascade_rcnn as C
    from skix_torch.models.sam3d_body import SAM3DBody
    from skix_torch.pipelines import prepare_side_results as PS

    dev = torch.device(device)
    res, bad = {}, []
    # float32 convolutions on the card, as phase 4 leaves them (this group
    # may run alone: --only views)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def hold(key, err, limit):
        res[key] = err
        if not err <= limit:
            bad.append(f"{key}={err} > {limit}")

    cpu = seeded(C.CascadeMaskRCNN(**DET_REF, image_size=64), 71)
    with torch.no_grad():
        for k in range(3):
            getattr(cpu, f"box_head{k}").cls_score.bias[0] += 4.5
    card = copy.deepcopy(cpu).to(dev)
    imgs = torch.as_tensor(shifted_frames(np.random.default_rng(72), 4,
                                          (64, 64)), dtype=torch.float32)
    imgs = imgs / 255.0
    want_raw, got_raw = cpu.raw_heads(imgs), card.raw_heads(imgs.to(dev))
    hold("rpn_raw", max(scaled_err(g, w) for gr, wr in zip(got_raw, want_raw)
                        for g, w in zip(gr.rpn_logits + gr.rpn_deltas,
                                        wr.rpn_logits + wr.rpn_deltas)), 1e-4)
    same_props = [scaled_err(g.proposals, w.proposals) <= 1e-3
                  for g, w in zip(got_raw, want_raw)]
    res["images_proposals_differ"] = same_props.count(False)
    hold("proposals", max((scaled_err(g.proposals, w.proposals)
                           for g, w, ok in zip(got_raw, want_raw, same_props)
                           if ok), default=0.0), 1e-4)
    # each box stage on the CPU's own input boxes (its proposals, then its
    # refined boxes): the card's arithmetic; the chain run free on each
    # side moves every stage's RoIs by the last stage's rounding as well,
    # reported beside it
    from skix_torch.models.keypoint_rcnn import multilevel_roi_align
    from skix_torch.utils.device import full_float32_convs

    forced = []
    with torch.no_grad(), full_float32_convs():
        feats = card._trunk(imgs.to(dev))[0]
        for b, wr in enumerate(want_raw):
            boxes = wr.proposals
            for k in range(3):
                rois = multilevel_roi_align([f[b] for f in feats],
                                            boxes.to(dev), 7)
                s, d = getattr(card, f"box_head{k}")(rois)
                forced += [scaled_err(s, wr.stage_logits[k]),
                           scaled_err(d, wr.stage_deltas[k])]
                boxes = C._clip(C.apply_deltas(
                    boxes, wr.stage_deltas[k], C.CASCADE_STAGE_WEIGHTS[k]),
                    64, 64)
    hold("box_stages_raw", max(forced), 1e-4)
    res["box_stages_chained"] = max(
        (scaled_err(g, w) for gr, wr, ok in zip(got_raw, want_raw,
                                                same_props) if ok
         for g, w in zip(gr.stage_logits + gr.stage_deltas + [gr.boxes],
                         wr.stage_logits + wr.stage_deltas + [wr.boxes])),
        default=0.0)
    want, got = cpu(imgs), card(imgs.to(dev))
    differ, worst = _pick_check(got, want, "boxes_xyxy", 1e-3)
    res["detections"] = int(want.valid.sum())
    res["images_picks_differ"] = differ
    hold("detections_err", max(worst.values(), default=0.0), 1e-4)
    if differ > 1 or res["images_proposals_differ"] > 1:
        bad.append(f"{differ} of 4 images picked otherwise")

    root = tmp / "side_det_ref"
    _smooth_record(root / "pt", "cam_left", 6, (180, 320), 73)
    (root / "ckpt").mkdir(parents=True, exist_ok=True)
    save_skix_npz(root / "ckpt" / "det.npz", cpu)
    est = SAM3DBody(crop_size=64, embed_dim=192, depth=1, num_heads=6,
                    decoder_depth=1)
    condition_side_model(seeded(est, 74))
    save_skix_npz(root / "ckpt" / "sam3d.npz", est)
    slots, run = {}, [None]
    build = PS.build_human_detector

    def recording(cfg, device=None):
        det = build(cfg, device)
        clip = det.detect_clip

        def detect_clip(*a, **k):
            slots[run[0]] = clip(*a, **k)
            return slots[run[0]]
        det.detect_clip = detect_clip
        return det

    PS.build_human_detector = recording
    try:
        for run[0] in ("cpu", "card"):
            side = "cpu" if run[0] == "cpu" else device
            PS.main({"paths": {"pt_root": str(root / "pt"),
                               "out_root": str(root / run[0])},
                     "checkpoint": str(root / "ckpt" / "sam3d.npz"),
                     "detector_checkpoint": str(root / "ckpt" / "det.npz"),
                     **SIDE_DET_REF, "device": side})
    finally:
        PS.build_human_detector = build
    (wb, wv), (gb, gv) = slots["cpu"], slots["card"]
    T = wv.shape[0]
    agree = [bool(np.array_equal(gv[t], wv[t])
                  and scaled_err(gb[t], wb[t]) <= 1e-3) for t in range(T)]
    res["frames_slots_differ"] = f"{agree.count(False)}/{T}"
    res["slots_valid"] = int(wv.sum())
    if agree.count(False) * 10 > T:
        bad.append(f"stage: {agree.count(False)} of {T} frames' slots differ")
    limits = dict(SIDE_REF_LIMITS, bbox=1e-4)
    for t in range(T):
        if not agree[t]:
            continue
        name = f"p01/cam_left/frame_{t:06d}_sam_3d_body_outputs.npz"
        with np.load(root / "cpu" / name) as a, \
                np.load(root / "card" / name) as b:
            if bool(a["det_valid"]) != bool(b["det_valid"]):
                bad.append(f"frame {t}: det_valid differs")
            for k, lim in limits.items():
                e = scaled_err(b[k], a[k])
                res[f"npz_{k}"] = max(res.get(f"npz_{k}", 0.0), e)
    for k, lim in limits.items():
        if not res.get(f"npz_{k}", 0.0) <= lim:
            bad.append(f"npz_{k}={res[f'npz_{k}']} > {lim}")
    say("side_det_ref", **res)
    if bad:
        fail("side_det_ref: " + "; ".join(bad))


def side_det_phase(tmp: Path, device: str = "cuda"):
    """``prepare_side_results`` with the detector in the loop at
    SIDE_DET_CFG (seeded weights) on 2 records × 64 frames of 1080p without
    person boxes: cold (launch counts reset just before and read just
    after: exactly SIDE_DET_K1 K1 launches, the estimator's), every output
    checked (det_valid among the fields), the peak memory; the detector's
    and the estimator's ms a frame alone (warm, 16 frames); the stage warm
    and then under torch.profiler (busy, idle), each on 16 frames of one
    record."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skix_torch.io.contracts import load_pt_info
    from skix_torch.ops import attention as A
    from skix_torch.pipelines import prepare_side_results as PS

    root = tmp / "side_det"
    t0 = time.perf_counter()
    for i, view in enumerate(("cam_left", "cam_right")):
        _smooth_record(root / "pt", view, SIDE_DET_T, SIDE_HW, 81 + i)
    setup_s = time.perf_counter() - t0

    def cfg(out):
        return {"paths": {"pt_root": str(root / "pt"), "out_root": str(out)},
                **SIDE_DET_CFG, "device": device}

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    PS.main(cfg(root / "cold"))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
    peak = round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)
    check_side_outputs("side_det", root / "cold", SIDE_DET_T)
    valid = [bool(np.load(f)["det_valid"])
             for f in sorted((root / "cold").rglob("frame_*.npz"))]
    frames = 2 * SIDE_DET_T
    expected = {"flash_fwd": SIDE_DET_K1}
    by_style = dict(A.LAUNCHES_BY_STYLE)
    say("side_det", frames=frames, cold_wall_s=round(cold_s, 3),
        cold_ms_per_frame=round(cold_s / frames * 1e3, 2),
        records_setup_s=round(setup_s, 3), peak_mem_gib=peak,
        frames_with_a_detection=sum(valid),
        launches=json.dumps(launches).replace(" ", ""),
        expected=json.dumps(expected).replace(" ", ""))
    if launches != expected:
        fail(f"side_det: launches {launches}, expected {expected}")

    # each model alone, warm: the detector on a record, the estimator on
    # one person slot of it
    det = PS.build_human_detector(cfg(None))
    est = PS.build_estimator(cfg(None))
    frames16 = load_pt_info(root / "pt" / "p01" / "cam_left.npz").frames[:16]
    kw = dict(batch_size=SIDE_DET_CFG["detector_batch"],
              max_people=SIDE_DET_CFG["max_people"])
    # the stage ran: every kernel is loaded and cuDNN's choices are made
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    boxes, _ = det.detect_clip(frames16, **kw)
    torch.cuda.synchronize()
    det_ms = (time.perf_counter() - t0) / len(frames16) * 1e3
    t0 = time.perf_counter()
    est.process_clip(frames16, boxes[:, 0], batch_size=8)
    torch.cuda.synchronize()
    slot_ms = (time.perf_counter() - t0) / len(frames16) * 1e3
    size, B = (SIDE_DET_CFG["detector_image_size"],
               SIDE_DET_CFG["detector_batch"])
    x = torch.zeros((B, size, size, 3), device=device)
    forward_ms = cuda_ms(lambda: det.model(x), 3)
    say("side_det_models", detector_ms_per_frame=round(det_ms, 3),
        detector_forward_ms_per_batch=round(forward_ms, 3),
        estimator_ms_per_frame_per_slot=round(slot_ms, 3),
        estimator_ms_per_frame=round(slot_ms * SIDE_DET_CFG["max_people"], 3),
        detector_params_m=round(sum(p.numel() for p in det.model.parameters())
                                / 1e6, 1))
    del det, est, x
    gc.collect()
    torch.cuda.empty_cache()

    # warm and profiled on the first 16 frames of one record
    def one(out):
        return dict(cfg(out), paths={"pt_root": str(root / "one"),
                                     "out_root": str(out)})

    _smooth_record(root / "one", "cam_left", 16, SIDE_HW, 81)
    t0 = time.perf_counter()
    PS.main(one(root / "warm"))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    say("side_det_warm", frames=16, wall_s=round(warm_s, 3),
        ms_per_frame=round(warm_s / 16 * 1e3, 2))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        PS.main(one(root / "prof"))
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    gemm_ms = sum(e.self_device_time_total for e in kernels
                  if "gemm" in e.key.lower() or "sgemm" in e.key.lower()
                  or "cutlass" in e.key.lower()) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    say("side_det_profile", wall_ms=round(prof_wall_ms, 1),
        device_busy_ms=round(busy_ms, 2),
        device_idle_share=round(1.0 - busy_ms / prof_wall_ms, 4),
        gemm_ms=round(gemm_ms, 2),
        kernels_launched=sum(e.count for e in kernels))
    say("side_det_profile_top", kernels=json.dumps(
        [[e.key[:60], round(e.self_device_time_total / 1e3, 2), e.count]
         for e in top]).replace(" ", ""))
    gc.collect()
    torch.cuda.empty_cache()
    return launches, by_style


def _compact_cfg(videos: Path, out: Path, device: str, **over) -> dict:
    """configs/prepare_front_results.yaml with ``model: compact``."""
    from skix_torch.config import load_config

    cfg = load_config("prepare_front_results",
                      config_dir=ROOT / "configs").to_dict()
    cfg.update(model="compact", device=device, **over)
    cfg["paths"] = {"video_root": str(videos), "out_root": str(out)}
    return cfg


def front_compact_reference_phase(tmp: Path, device: str = "cuda"):
    """The stage with ``model: compact`` at the config's keys on 8 frames of
    180 × 320, the same seeded checkpoint, on the card and on the CPU: the
    lifecycle files (active, ids, valid) equal, scores within 1e-4, boxes
    within 1e-4 of the frame; K1 at the compact shape on the card."""
    import numpy as np

    from skix_torch.ops import attention as A
    from skix_torch.pipelines.prepare_front_results import main as front_main
    from skix_torch.tracking.detector import DetrDetector

    root = tmp / "front_compact_ref"
    write_clip(root / "videos" / "p01" / "clip.mp4", 8, (180, 320), seed=91)
    keys = _compact_cfg(root, root, "cpu")
    det = seeded(DetrDetector(
        img_size=keys["img_size"], patch_size=keys["patch_size"],
        embed_dim=keys["embed_dim"], depth=keys["vit_depth"],
        num_heads=keys["num_heads"], num_queries=keys["num_queries"],
        decoder_depth=keys["decoder_depth"], prompt_dim=keys["prompt_dim"]),
        92)
    save_skix_npz(root / "det.npz", det)
    for side in ("cpu", device):
        if side == device:
            reset_counts()
        front_main(_compact_cfg(root / "videos", root / side, side,
                                checkpoint=str(root / "det.npz")))
    by_shape = dict(A.LAUNCHES_BY_SHAPE)
    res, bad = {}, []
    for f in sorted((root / "cpu" / "p01").glob("*.npy")):
        a, b = np.load(f), np.load(root / device / "p01" / f.name)
        if a.dtype.kind in "bi":
            res[f.stem] = int((a != b).sum())
            ok = res[f.stem] == 0
        else:
            res[f.stem] = scaled_err(b, a)
            ok = res[f.stem] <= 1e-4
        if not ok:
            bad.append(f.stem)
    want = {COMPACT_SHAPE: 6 * 2 * 2}
    say("front_compact_ref", **res,
        launches_by_shape=json.dumps(by_shape).replace(" ", ""))
    if bad:
        fail(f"front_compact_ref: card and CPU disagree on {bad}")
    if by_shape != want:
        fail(f"front_compact_ref: launches {by_shape}, expected {want}")


def front_compact_phase(tmp: Path, device: str = "cuda"):
    """The stage with ``model: compact`` at the config's keys (seeded
    weights) on 64 frames of 720 × 1280, prompts person and snow: cold with
    launches by kernel and shape (6 K1 a batch of 4 frames and prompt),
    every file checked; warm (ms a batch from the stage's spans); then
    profiled."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skix_torch.ops import attention as A
    from skix_torch.pipelines.prepare_front_results import main as front_main

    root = tmp / "front_compact"
    write_clip(root / "videos" / "p01" / "clip.mp4", COMPACT_T, COMPACT_HW,
               seed=93)
    reset_counts()
    t0 = time.perf_counter()
    front_main(_compact_cfg(root / "videos", root / "cold", device))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches, by_shape = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_SHAPE)
    by_style = dict(A.LAUNCHES_BY_STYLE)
    out = root / "cold" / "p01"
    B = 4
    for p in FRONT_PROMPTS:
        for kind, shape in (("bboxes", (COMPACT_T, 16, 4)),
                            ("scores", (COMPACT_T, 16)),
                            ("active", (COMPACT_T, 16)),
                            ("obj_ids", (COMPACT_T, 16))):
            if kind == "bboxes" and p == "person":
                shape = (COMPACT_T, 4)      # person_bboxes overwrites it
            f = out / f"{p}_{kind}.npy"
            if not f.exists() or np.load(f).shape != shape:
                fail(f"front_compact: {f.name} missing or not {shape}")
        if (out / f"{p}_masks.npy").exists():
            fail("front_compact: the compact path wrote masks")
    batches = len(FRONT_PROMPTS) * (COMPACT_T // B)
    expected = {"flash_fwd": 6 * batches}
    spans = json.loads((root / "cold" / "front_timing.json").read_text())
    say("front_compact", frames=COMPACT_T, prompts=len(FRONT_PROMPTS),
        cold_wall_s=round(cold_s, 3),
        launches=json.dumps(launches).replace(" ", ""),
        launches_by_shape=json.dumps(by_shape).replace(" ", ""),
        expected=json.dumps(expected).replace(" ", ""),
        person_active_mean=float(np.load(out / "person_active.npy").mean()))
    if launches != expected or by_shape != {COMPACT_SHAPE: 6 * batches}:
        fail(f"front_compact: launches {launches} {by_shape}, expected "
             f"{expected}")
    t0 = time.perf_counter()
    front_main(_compact_cfg(root / "videos", root / "warm", device))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    spans = json.loads((root / "warm" / "front_timing.json").read_text())
    say("front_compact_warm", wall_s=round(warm_s, 3),
        ms_per_frame_and_prompt=round(warm_s / (COMPACT_T * 2) * 1e3, 3),
        detector_ms_per_batch=spans["detector"]["mean_ms"],
        tracker_ms_per_batch=spans["tracker"]["mean_ms"])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        front_main(_compact_cfg(root / "videos", root / "prof", device))
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1_ms = sum(e.self_device_time_total for e in kernels
                if "flash_fwd_kernel" in e.key) / 1e3
    say("front_compact_profile", wall_ms=round(prof_wall_ms, 1),
        device_busy_ms=round(busy_ms, 2),
        device_idle_share=round(1.0 - busy_ms / prof_wall_ms, 4),
        k1_ms=round(k1_ms, 3), kernels_launched=sum(e.count for e in kernels))
    return launches, by_style


def trunk_reference_phase(device: str = "cuda"):
    """The memory tracker with a tiny ViT-Det trunk (512 wide for 16 heads
    of 32, 8 blocks: block 7 global), seeded, on the card against the CPU:
    a 112 px frame's features and one step (the dense memory attention) on
    a bank with a conditioning memory (1e-4); K2, K1 and K1 with its lse
    on the card."""
    import copy

    import numpy as np
    import torch

    from skix_torch.ops import attention as A
    from skix_torch.tracking import memory_tracker as M

    cpu = seeded(M.MaskMemoryTracker(features=64, num_heads=1, mem_slots=3,
                                     trunk="vitdet", vit_embed_dim=512,
                                     vit_depth=8), 101)
    card = copy.deepcopy(cpu).to(device)
    x = torch.as_tensor(shifted_frames(np.random.default_rng(102), 1,
                                       (112, 112)), dtype=torch.float32) / 255
    mem = torch.randn((1, 8, 8, 64), generator=torch.Generator().manual_seed(3))
    out = {}
    for side, m in (("cpu", cpu), (device, card)):
        if side == device:
            reset_counts()
        with torch.no_grad():
            f = m.encode_frame(x.to(side))
            bank = M.write_conditioning(M.init_memory(3, 8, 8, 64,
                                                      device=side),
                                        mem.to(side))
            logits, score, bank = m.step_from_feats(f, bank, dense=True)
        out[side] = [f, logits, score, bank.mem]
    launches = dict(A.LAUNCHES)
    errs = [scaled_err(g, w) for g, w in zip(out[device], out["cpu"])]
    say("trunk_ref", features_err=errs[0], mask_logits_err=errs[1],
        score_err=errs[2], memory_err=errs[3],
        launches=json.dumps(launches).replace(" ", ""))
    if max(errs) > 1e-4:
        fail(f"trunk_ref: card against CPU {errs} > 1e-4")
    want = {"flash_fwd_single_tile": 7, "flash_fwd": 1, "flash_fwd_lse": 2}
    if launches != want:
        fail(f"trunk_ref: launches {launches}, expected {want}")


def front_trunk_phase(tmp: Path, device: str = "cuda"):
    """The front stage at its full-size default with ``tracker: {trunk:
    vitdet}`` (the ViT-Det trunk at full width, seeded) and
    ``overlay_video: true`` on 4 frames of 720 × 1280 × 2 prompts, through
    run_all's stage entry: launches by kernel and shape (TRUNK_PER_FRAME a
    frame and prompt), the files and each overlay video's frame count."""
    import cv2
    import numpy as np
    import torch

    from skix_torch.ops import attention as A
    from skix_torch.pipelines.prepare_front_results import main as front_main

    frames = np.random.default_rng(3).integers(
        0, 255, (FRONT_T, *FRONT_HW, 3), dtype=np.uint8)
    root = tmp / "front_trunk"
    from skix_torch.io.video import write_video

    write_video(root / "videos" / "p01" / "clip.mp4", frames, fps=10)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    front_main({"paths": {"video_root": str(root / "videos"),
                          "out_root": str(root / "out")},
                "prompts": FRONT_PROMPTS, "tracker": {"trunk": "vitdet"},
                "overlay_video": True, "device": device})
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, by_shape = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_SHAPE)
    by_style = dict(A.LAUNCHES_BY_STYLE)
    out = root / "out" / "p01"
    counts = {}
    for p in FRONT_PROMPTS:
        if not (out / f"{p}_masks.npy").exists():
            fail(f"front_trunk: no {p}_masks.npy (see the log)")
        cap = cv2.VideoCapture(str(out / f"{p}_overlay.mp4"))
        counts[p] = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
    spans = json.loads((root / "out" / "front_timing.json").read_text())
    n = FRONT_T * len(FRONT_PROMPTS)
    expected = {k: n * v for k, v in TRUNK_PER_FRAME.items()}
    say("front_trunk", wall_s=round(wall_s, 3), frames=n,
        detector_ms_per_frame=spans["detector"]["mean_ms"],
        tracker_ms_per_frame=spans["tracker"]["mean_ms"],
        outputs_ms_per_frame=spans["outputs"]["mean_ms"],
        overlay_frames=json.dumps(counts).replace(" ", ""),
        launches=json.dumps(launches).replace(" ", ""),
        launches_by_shape=json.dumps(by_shape).replace(" ", ""),
        expected=json.dumps(expected).replace(" ", ""),
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    if launches != expected:
        fail(f"front_trunk: launches {launches}, expected {expected}")
    if set(counts.values()) != {FRONT_T}:
        fail(f"front_trunk: overlay frame counts {counts}, not {FRONT_T}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, by_style


def _front_side_inputs(root: Path, T: int, seed: int):
    """front_side's inputs for person p01: two side views (70-joint world
    skeletons walking downhill, the right view 1 cm off) and the front
    person boxes moving downhill."""
    import numpy as np

    rng = np.random.default_rng(seed)
    side = root / "side" / "p01"
    side.mkdir(parents=True, exist_ok=True)
    base = (rng.normal(size=(T, 70, 3)).cumsum(0) * 0.002
            + rng.normal(size=(1, 70, 3)) * 0.3)
    np.save(side / "left_view.npy", base.astype(np.float32))
    np.save(side / "right_view.npy",
            (base + rng.normal(size=base.shape) * 0.01).astype(np.float32))
    front = root / "front" / "p01"
    front.mkdir(parents=True, exist_ok=True)
    bbox = np.tile(np.array([900.0, 400, 1000, 800], np.float32), (T, 1))
    bbox[:, [1, 3]] += np.linspace(0, 200, T)[:, None]
    np.save(front / "person_bboxes.npy", bbox.astype(np.float32))


def render3d_phase(tmp: Path, device: str = "cuda"):
    """front_side with ``render3d: true`` at its 1280 × 720 default on
    1 person × 300 frames: the stage without the render (it warms the
    fusion), then with it (ms a frame of the 3D BEV video, launches
    counted), the renderer alone (CUDA events), and 3 frames rendered on
    the card and on the CPU: the share of differing pixels (limit
    1e-3)."""
    import numpy as np
    import torch

    from skix_torch.front_side.bev import BEV_EDGES_MINIMAL
    from skix_torch.ops import attention as A
    from skix_torch.pipelines.front_side import main as fs_main
    from skix_torch.vis.render3d import BevVideoRenderer, BevView

    root = tmp / "render3d"
    _front_side_inputs(root, RENDER_T, 111)

    def run(out, render3d):
        t0 = time.perf_counter()
        fs_main({"paths": {"side_root": str(root / "side"),
                           "front_root": str(root / "front"),
                           "out_root": str(root / out)},
                 "render3d": render3d, "device": device})
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    without_s = run("plain", False)
    reset_counts()
    with_s = run("cold", True)
    launches = dict(A.LAUNCHES)
    video = root / "cold" / "p01" / "p01_bev3d.mp4"
    import cv2

    cap = cv2.VideoCapture(str(video))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    if n != RENDER_T:
        fail(f"render3d: {video.name} holds {n} frames, not {RENDER_T}")
    world = np.load(root / "cold" / "p01" / "p01_world.npy")
    center = np.nanmean(world.reshape(-1, 3), axis=0)
    kw = dict(edges=BEV_EDGES_MINIMAL, view=BevView(lookat=tuple(center)))
    r = BevVideoRenderer(None, device=device, **kw)
    frame_ms = cuda_ms(lambda: r.render(world[0]), 5)
    r_cpu = BevVideoRenderer(None, device="cpu", **kw)
    differ = [float((r.render(world[t]) != r_cpu.render(world[t])).any(-1)
                    .mean()) for t in (0, RENDER_T // 2, RENDER_T - 1)]
    say("render3d", frames=RENDER_T,
        stage_ms_per_frame=round(with_s / RENDER_T * 1e3, 3),
        stage_without_render_ms_per_frame=round(without_s / RENDER_T * 1e3,
                                                3),
        render_ms_per_frame=round((with_s - without_s) / RENDER_T * 1e3, 3),
        render_frame_ms=round(frame_ms, 3),
        card_vs_cpu_pixels_differ=json.dumps(differ).replace(" ", ""),
        launches=json.dumps(launches).replace(" ", ""))
    if max(differ) > 1e-3:
        fail(f"render3d: card and CPU differ on {differ} of the pixels")
    return launches, dict(A.LAUNCHES_BY_STYLE)


# --------------------------------------------------------------------------
# phase 7h: the image_edit CLI
# --------------------------------------------------------------------------
def image_edit_cfg(videos: Path, out: Path, device: str, **over) -> dict:
    """configs/image_edit.yaml with the paths, the device and ``over``."""
    from skix_torch.config import load_config

    cfg = load_config("image_edit", config_dir=ROOT / "configs").to_dict()
    cfg.update(device=device, **over)
    cfg["paths"] = {"video_root": str(videos), "out_root": str(out)}
    return cfg


def write_edit_lora(path: Path, depth: int, dim: int, seed: int) -> Path:
    """A safetensors-shaped LoRA npz (lora_A/lora_B, rank EDIT_LORA_RANK) on
    the attention projections of every block, as the reference's
    multiple-angles LoRA adapts them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r = EDIT_LORA_RANK
    arrays = {}
    for i in range(depth):
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            arrays[f"blocks_{i}.{proj}.lora_A.weight"] = (
                rng.standard_normal((r, dim), np.float32) / math.sqrt(dim))
            arrays[f"blocks_{i}.{proj}.lora_B.weight"] = (
                0.01 * rng.standard_normal((dim, r), np.float32))
    np.savez(path, **arrays)
    return path


def _edit_clip(tmp: Path) -> Path:
    videos = tmp / "edit_videos"
    write_clip(videos / "p01" / "clip.mp4", EDIT_T, EDIT_HW, seed=41)
    return videos


def image_edit_reference_phase(tmp: Path):
    """The image_edit CLI's editor at a tiny width (dim 256 = 2 heads of
    128, so K1 runs at (1,2,2064,128) on the card; the config's towers,
    VAE and image size, a LoRA) on the card and on the CPU with the same
    weights (the CPU's seeded ones), the same 1080p frame and the same
    noise: the prompt embeddings (the frame's vision tokens spliced in),
    one velocity, the output latents of an edit and its image."""
    import numpy as np
    import torch

    from skix_torch.io.video import read_video
    from skix_torch.models.mmdit import build_camera_prompt, pack_latents
    from skix_torch.ops import attention as A
    from skix_torch.pipelines import image_edit as E

    videos = _edit_clip(tmp)
    frame = read_video(videos / "p01" / "clip.mp4", max_frames=1)[0]
    lora = write_edit_lora(tmp / "edit_ref_lora.npz", EDIT_REF["depth"],
                           EDIT_REF["dim"], seed=5)
    cfg = image_edit_cfg(videos, tmp / "edit_ref", "cpu", lora_path=str(lora),
                         **EDIT_REF)
    eds = {"cpu": E.CameraEditor(cfg),
           "cuda": E.CameraEditor(dict(cfg, device="cuda"))}
    cpu, card = eds["cpu"], eds["cuda"]
    for name in ("model", "vae"):
        getattr(card, name).load_state_dict(getattr(cpu, name).state_dict())
    for name in ("vision", "text"):
        getattr(card.text_encoder, name).load_state_dict(
            getattr(cpu.text_encoder, name).state_dict())
    prompt = build_camera_prompt(rotate_deg=30.0)
    errs, got = {}, {}
    with torch.no_grad():
        for dev, ed in eds.items():
            f = torch.as_tensor(frame, device=dev)
            got[dev] = {"prompt_emb": ed._embed_prompt_vl(prompt, f).cpu()}
        errs["prompt_emb"] = scaled_err(got["cuda"]["prompt_emb"],
                                        got["cpu"]["prompt_emb"])
        # one velocity from the CPU's inputs: noise and source tokens
        img = torch.as_tensor(frame).float() / 127.5 - 1.0
        from skix_torch.utils.image import resize

        img = resize(img, (cpu.size, cpu.size, 3), "bilinear")
        tokens = pack_latents(cpu.vae.encode(img[None])[0]
                              * cpu.vae.scaling_factor)
        x_in = torch.cat([E.initial_noise(tokens.shape, 0, "cpu"), tokens], 1)
        t = torch.ones(1)
        emb = got["cpu"]["prompt_emb"][None]
        before = A.LAUNCHES["flash_fwd"]
        vel = {dev: ed.model(x_in.to(dev), emb.to(dev), t.to(dev),
                             ed._fhw).cpu() for dev, ed in eds.items()}
        if A.LAUNCHES["flash_fwd"] != before + EDIT_REF["depth"]:
            fail("image_edit_ref: the card's DiT did not launch K1 once a "
                 "block")
        errs["velocity"] = scaled_err(vel["cuda"], vel["cpu"])
    # one edit each, the latents recorded where they are decoded
    for dev, ed in eds.items():
        decode = ed.decode

        def recording(z, _decode=decode, _dev=dev):
            got[_dev]["latents"] = z.cpu()
            return _decode(z)
        ed.decode = recording
        got[dev]["image"], _ = ed.infer_camera_edit(frame, rotate_deg=30.0)
    errs["latents"] = scaled_err(got["cuda"]["latents"],
                                 got["cpu"]["latents"])
    diff = np.abs(got["cuda"]["image"].astype(int)
                  - got["cpu"]["image"].astype(int))
    errs["png_levels"] = int(diff.max())
    errs["png_diff_share"] = float((diff > 0).mean())
    say("image_edit_ref", size=cpu.size, dim=EDIT_REF["dim"],
        depth=EDIT_REF["depth"], seq=int(x_in.shape[1]) + cpu.text_len,
        errs=json.dumps(errs).replace(" ", ""),
        limits=json.dumps(EDIT_REF_LIMITS).replace(" ", ""))
    shape = (cpu.size, cpu.size, 3)
    for dev in eds:
        if got[dev]["image"].shape != shape or not all(
                bool(torch.isfinite(got[dev][k]).all())
                for k in ("prompt_emb", "latents")):
            fail(f"image_edit_ref: the {dev} edit is misshapen or not finite")
    bad = {k: v for k, v in errs.items() if not v <= EDIT_REF_LIMITS[k]}
    if bad:
        fail(f"image_edit_ref: card against CPU past the limits: {bad}")
    del eds, cpu, card
    gc.collect()
    torch.cuda.empty_cache()


def image_edit_phase(tmp: Path):
    """The image_edit CLI at the published widths (EDIT_FULL, the cuts in
    EDIT_CUTS) on one 1080p clip: cold through ``main`` (the weights drawn
    on the card, the LoRA fused, one frame × 4 edits; launch counts reset
    just before and read just after: 16 K1 launches a DiT forward, all at
    (1,24,2064,128) with the interleaved rope), the PNGs and the summary
    checked; then one DiT forward and one edit warm, and one edit under
    torch.profiler (busy, idle share, K1's and the GEMMs' device time)."""
    import cv2
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skix_torch.io.video import read_video
    from skix_torch.ops import attention as A
    from skix_torch.pipelines import image_edit as E

    videos = _edit_clip(tmp)
    lora = write_edit_lora(tmp / "edit_lora.npz", EDIT_FULL["depth"],
                           EDIT_FULL["dim"], seed=6)
    out = tmp / "edit_out"
    cfg = image_edit_cfg(videos, out, "cuda", lora_path=str(lora),
                         **EDIT_FULL)
    steps, edits = int(cfg["num_inference_steps"]), cfg["edits"]
    frames = -(-EDIT_T // int(cfg["frame_stride"]))
    per = frames * len(edits) * steps * EDIT_FULL["depth"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run = E.main(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_style = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_STYLE)
    by_shape = dict(A.LAUNCHES_BY_SHAPE)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want_shape = {f"flash_fwd/1x{EDIT_FULL['num_heads']}x"
                  f"{2 * (cfg['image_size'] // 16) ** 2 + EDIT_TEXT_LEN}x"
                  f"{EDIT_FULL['dim'] // EDIT_FULL['num_heads']}": per}
    say("image_edit", wall_s=round(wall, 2), frames=frames,
        edits=frames * len(edits), dit_forwards=frames * len(edits) * steps,
        peak_gib=round(peak, 2), cuts=EDIT_CUTS,
        params_m=json.dumps({k: round(sum(p.numel() for p in m.parameters())
                                      / 1e6, 1) for k, m in (
            ("dit", run.editor.model), ("text", run.editor.text_encoder.text),
            ("vision", run.editor.text_encoder.vision),
            ("vae", run.editor.vae))}).replace(" ", ""),
        launches=json.dumps(launches).replace(" ", ""),
        by_shape=json.dumps(by_shape).replace(" ", ""))
    if (launches != {"flash_fwd": per} or by_shape != want_shape
            or by_style != {"flash_fwd/interleaved": per}):
        fail(f"image_edit: launches {launches} by shape {by_shape} by style "
             f"{by_style}, expected {want_shape} interleaved")
    summary = json.loads((out / "image_edit_summary.json").read_text())
    pngs = sorted((out / "p01" / "clip").glob("*.png"))
    if summary != {"p01/clip": frames * len(edits)} or len(pngs) != (
            frames * len(edits)):
        fail(f"image_edit: summary {summary}, {len(pngs)} PNGs")
    for png in pngs:
        img = cv2.imread(str(png))
        if img is None or img.shape != (cfg["image_size"],) * 2 + (3,):
            fail(f"image_edit: {png.name} is missing or misshapen")
    # warm: one DiT forward at the path's shape, one edit
    ed = run.editor
    frame = read_video(videos / "p01" / "clip.mp4", max_frames=1)[0]
    lat = cfg["image_size"] // ed.latent_down
    S = 2 * (lat // 2) ** 2
    x = torch.randn((1, S, 4 * ed.latent_channels), device="cuda")
    emb = torch.randn((1, ed.text_len, EDIT_FULL["text_dim"]), device="cuda")
    t = torch.ones(1, device="cuda")
    with torch.no_grad():
        dit_ms = cuda_ms(lambda: ed.model(x, emb, t, ed._fhw), 3)
    floats = []
    decode = ed.decode
    ed.decode = lambda z: floats.append(decode(z)) or floats[-1]
    edit = dict(edits[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, _ = ed.infer_camera_edit(frame, **edit)
    edit_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(floats[-1]).all()) or img.dtype != np.uint8:
        fail("image_edit: the warm edit's decoded image is not finite")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ed.infer_camera_edit(frame, **edit)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    k1 = sum(e.self_device_time_total for e in kernels
             if "flash_fwd_kernel" in e.key) / 1e3
    rope = sum(e.self_device_time_total for e in kernels
               if "rope_rows_kernel" in e.key) / 1e3
    gemm = sum(e.self_device_time_total for e in kernels
               if "gemm" in e.key.lower() or "cutlass" in e.key.lower()) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    say("image_edit_warm", dit_forward_ms=round(dit_ms, 2),
        edit_ms=round(edit_ms, 1), steps=steps,
        dit_share_of_edit=round(steps * dit_ms / edit_ms, 4))
    say("image_edit_profile", wall_ms=round(prof_ms, 1),
        device_busy_ms=round(busy, 2),
        device_idle_share=round(1.0 - busy / prof_ms, 4),
        k1_ms=round(k1, 2), k1_busy_share=round(k1 / busy, 4),
        rope_pass_ms=round(rope, 2), gemm_ms=round(gemm, 2),
        gemm_busy_share=round(gemm / busy, 4),
        kernels_launched=sum(e.count for e in kernels))
    say("image_edit_profile_top", kernels=json.dumps(
        [[e.key[:60], round(e.self_device_time_total / 1e3, 2), e.count]
         for e in top]).replace(" ", ""))
    del run, ed, x, emb, floats
    gc.collect()
    torch.cuda.empty_cache()
    return launches, by_style


# --------------------------------------------------------------------------
# phase 8: one training step of the tiny detector, card against CPU
# --------------------------------------------------------------------------
def write_coco(root: Path, n: int, hw, seed: int,
               keypoints: bool = False) -> Path:
    """A COCO instances file of ``n`` images of ``hw`` pixels, each with 1–3
    objects (a bright random pentagon on noise, its polygon as the
    segmentation), written with OpenCV; returns the json path. With
    ``keypoints`` each object also has 17 visible keypoints inside its box,
    drawn as coloured dots (a person-keypoints file)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / "img").mkdir(parents=True, exist_ok=True)
    H, W = hw
    images, anns = [], []
    for i in range(n):
        img = (rng.random((H, W, 3)) * 60).astype(np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            c = rng.uniform(0.2, 0.8, 2) * (W, H)
            r = rng.uniform(0.06, 0.2) * min(H, W)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 5))
            poly = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)],
                            -1).round()
            cv2.fillPoly(img, [poly.astype(np.int32)],
                         tuple(int(x) for x in rng.integers(120, 255, 3)))
            (x0, y0), (x1, y1) = poly.min(0), poly.max(0)
            ann = {"id": len(anns), "image_id": i, "category_id": 1,
                   "bbox": [float(x0), float(y0), float(x1 - x0),
                            float(y1 - y0)], "iscrowd": 0,
                   "area": float((x1 - x0) * (y1 - y0)),
                   "segmentation": [poly.ravel().tolist()]}
            if keypoints:
                kx = rng.uniform(x0, x1, 17)
                ky = rng.uniform(y0, y1, 17)
                for j in range(17):
                    cv2.circle(img, (int(kx[j]), int(ky[j])), 3,
                               (255 * (j % 3 == 0), 255 * (j % 3 == 1),
                                255 * (j % 3 == 2)), -1)
                ann["keypoints"] = np.stack(
                    [kx, ky, np.full(17, 2.0)], -1).ravel().tolist()
            anns.append(ann)
        cv2.imwrite(str(root / "img" / f"{i}.png"), img)
        images.append({"id": i, "file_name": f"img/{i}.png", "width": W,
                       "height": H})
    path = root / "coco.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": 1, "name": "skier"}]}))
    return path


def train_reference_phase(tmp: Path, sam3: bool = False):
    """One step of train_detector's loss and optimizer, tiny preset, on the
    card and on the CPU from the same weights and the same collated batch.
    The tiny trunk's head dim is 32: its window blocks (16 tokens) launch
    K2 and K5, its global block K1, K3 and K4. ``sam3`` (phase
    ``train_sam3_ref``): the detector in the sam3 configuration (the
    interleaved rope in all five kernels) and the ``sam3`` optimizer scheme
    with no warmup, so that the step moves the weights.
    ``train_sam3_ref`` also matches exactly (``loss.exact_match``: the
    auction in the detection loss) and samples the mask loss on
    ``REF_MASK_POINTS`` PointRend points (``loss.mask_points``), drawn on
    the CPU for both runs: every assignment of the loss, auction and
    greedy, must be the same on the card as on the CPU. The CPU's
    reversed-batch run gets the same points per image (the draws flipped
    along the batch)."""
    import numpy as np
    import torch

    from skix_torch.config import config_from_mapping
    from skix_torch.data import CocoDataset, CocoLoader
    from skix_torch.ops import attention as A
    from skix_torch.pipelines import train_detector as T
    from skix_torch.tracking import matcher as TM

    torch.backends.cudnn.allow_tf32 = False
    phase = "train_sam3_ref" if sam3 else "train_ref"
    root = tmp / "coco_ref"
    jp = root / "coco.json"
    if not jp.exists():
        write_coco(root, 4, (96, 128), seed=2)
    lr = 5e-4
    body = {"preset": "tiny", "lr": lr, "weight_decay": 1e-4,
            "grad_clip": 1.0, "dac": True, "loss": {"cls": "iabce"}}
    if sam3:
        body.update(model={"rope_style": "sam3", "pretrain_img_size": 56},
                    optim={"scheme": "sam3", "warmup_steps": 0,
                           "layer_decay": 0.9},
                    loss={"cls": "iabce", "exact_match": True,
                          "mask_points": REF_MASK_POINTS})
    cfg = config_from_mapping(body)
    # every assignment the loss makes, by run
    assigns = {"cpu": [], "cuda": [], "rev": []}
    run = ["rev"]
    draw = TM.uniform_points

    def recorded(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            assigns[run[0]].append(out.cpu())
            return out
        return wrapped

    orig_assign = (TM.auction_assign, TM.greedy_assign)
    TM.auction_assign, TM.greedy_assign = map(recorded, orig_assign)
    # the reversed batch's images take the points of their forward twins
    TM.uniform_points = lambda g, shape, d: draw(g, shape, d).flip(0)
    batch = next(iter(CocoLoader(CocoDataset(jp, image_root=root),
                                 batch_size=4, image_size=112, max_objects=4,
                                 seed=0)))
    cpu = T.build_detector(cfg, "cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    gpu = T.build_detector(cfg, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    res = {}
    # the CPU gradient of the batch in reverse order: the same loss in exact
    # arithmetic, other rounding in every sum over the batch
    loss_fn = T.make_loss_fn(cpu, cfg, 112)
    loss_fn(T.batch_to({k: np.ascontiguousarray(v[::-1])
                        for k, v in batch.items()}, "cpu"))[0].backward()
    g_rev = {n: (p.grad.clone() if p.grad is not None
                 else torch.zeros(p.shape)) for n, p in cpu.named_parameters()}
    cpu.zero_grad(set_to_none=True)
    TM.uniform_points = draw
    TM.AUCTION_ROUNDS.update(phases=0, rounds=0, max_per_phase=0)
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        run[0] = name
        dev = next(model.parameters()).device
        opt = T.build_optimizer(cfg, model, 10)
        reset_counts()
        loss, _, _ = T.make_loss_fn(model, cfg, 112)(T.batch_to(batch, dev))
        opt.zero_grad()
        loss.backward()
        launches = (dict(A.LAUNCHES), dict(A.LAUNCHES_BY_STYLE))
        grads = {n: (p.grad.detach().cpu().clone() if p.grad is not None
                     else torch.zeros(p.shape)) for n, p in
                 model.named_parameters()}
        norm = opt.step()
        res[name] = (loss.item(), grads, launches,
                     {n: p.detach().cpu() for n, p in model.named_parameters()},
                     norm)
    TM.auction_assign, TM.greedy_assign = orig_assign
    (l_c, g_c, _, p_c, norm), (l_g, g_g, launches, p_g, _) = (res["cpu"],
                                                              res["cuda"])
    assign_equal = (len(assigns["cpu"]) == len(assigns["cuda"]) > 0
                    and all(torch.equal(a, b) for a, b in
                            zip(assigns["cpu"], assigns["cuda"])))
    rev_equal = all(torch.equal(a, b.flip(-2))      # (..., B, Q)
                    for a, b in zip(assigns["cpu"], assigns["rev"]))
    # limits: f32 on both sides, sums in other orders (cuBLAS, the kernels,
    # MKL); each gradient leaf within 1e-4·max|g| + 1e-6 (g_err, the worst
    # leaf's error over its limit, ≤ 1); after Adam's first step (±lr where
    # the sign holds), lr/50 where |g| is above a floor. A leaf whose CPU
    # gradient moves by more than NOISE_SHARE of its largest element when
    # the batch is reversed is left out of the gradient check and listed:
    # its exact gradient is 0 and both sides give rounding noise (the
    # softmax-invariant biases: box-RPB output biases and attention key
    # biases, each shifting every logit of a row by one constant); such
    # leaves must hold at most 1 % of the gradient's elements. The
    # parameter floor is 1e-5 in train_ref; in train_sam3_ref it is where
    # the clipped gradient |g|·min(1, clip/norm) is above 1e-7, ten times
    # Adam's eps, where the first step is within 10 % of ±lr: its loss, and
    # so the global norm that clipping divides by, is larger than
    # train_ref's, which brings |g| = 1e-5 below eps, where the step
    # follows rounding-level differences of g linearly. The counts of
    # compared leaves and elements are printed
    skip = sorted(n for n in g_c if (g_rev[n] - g_c[n]).abs().max()
                  > NOISE_SHARE * g_c[n].abs().max())
    ratio = {n: ((g_g[n] - g_c[n]).abs().max()
                 / (1e-4 * g_c[n].abs().max() + 1e-6)).item()
             for n in g_c if n not in skip}
    worst = sorted(ratio, key=ratio.get)[::-1][:3]
    g_err = ratio[worst[0]]
    total = sum(t.numel() for t in g_c.values())
    skipped_elems = sum(g_c[n].numel() for n in skip)
    floor = 1e-7 * max(1.0, norm) if sam3 else 1e-5
    compared = sum(int((g_c[n].abs() > floor).sum()) for n in p_c)
    p_err = max(((p_g[n] - p_c[n]).abs()[g_c[n].abs() > floor].max().item()
                 if (g_c[n].abs() > floor).any() else 0.0) for n in p_c)
    loss_rel = abs(l_g - l_c) / abs(l_c)
    want = {"flash_fwd_single_tile_lse": 1, "flash_bwd_single_tile": 1,
            "flash_fwd_lse": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    rope = "interleaved" if sam3 else "half"
    want = (want, {f"{k}/{rope}": v for k, v in want.items()})
    say(phase, loss_cpu=l_c, loss_card=l_g, loss_rel=loss_rel,
        grad_norm=norm, grad_err_over_limit=g_err,
        worst_leaf_share_of_limit=f"{worst[0]}:{g_err}", param_err=p_err,
        param_floor=floor, params_compared=f"{compared}/{total}",
        grad_leaves_compared=f"{len(ratio)}/{len(g_c)}",
        skipped=json.dumps({
            n: [(g_g[n] - g_c[n]).abs().max().item(),
                (g_rev[n] - g_c[n]).abs().max().item(),
                g_c[n].abs().max().item()] for n in skip}).replace(" ", ""),
        worst_leaves=json.dumps([[n, ratio[n], (g_g[n] - g_c[n]).abs().max()
                                  .item(), g_c[n].abs().max().item()]
                                 for n in worst]).replace(" ", ""),
        launches=json.dumps(launches[0]).replace(" ", ""),
        launches_by_style=json.dumps(launches[1]).replace(" ", ""),
        loss_cfg=json.dumps(body["loss"]).replace(" ", ""),
        assignments_equal=assign_equal,
        assignments_compared=len(assigns["cuda"]),
        assigned_pairs=sum(int((a >= 0).sum()) for a in assigns["cuda"]),
        reversed_batch_assignments_equal=rev_equal,
        auction_rounds_per_phase_max=TM.AUCTION_ROUNDS["max_per_phase"])
    if not assign_equal:
        fail(f"{phase}: the card's assignments differ from the CPU's")
    if skipped_elems > 0.01 * total:
        fail(f"{phase}: {skipped_elems} of {total} gradient elements lie in "
             f"rounding-noise leaves: the check would cover too little")
    if not (loss_rel <= 1e-5 and g_err <= 1.0 and p_err <= lr / 50):
        fail(f"{phase}: card and CPU disagree (loss {loss_rel}, grads "
             f"{g_err}, params {p_err})")
    if launches != want:
        fail(f"{phase}: launches {launches}, expected {want}")


# --------------------------------------------------------------------------
# phase 9: train_detector at full size, warm split, profiled
# --------------------------------------------------------------------------
def _train_argv(tmp: Path):
    """The CLI overrides of the training path: configs/train_detector.yaml
    as it is, on the synthetic fixture, for TRAIN_STEPS steps."""
    root = tmp / "coco_train"
    return root, [f"paths.checkpoint_dir={tmp / 'train_ckpt'}",
                  f"coco_json={root / 'coco.json'}", f"image_root={root}",
                  f"steps={TRAIN_STEPS}", "log_every=1"]


def train_phase(tmp: Path, phase: str = "train", init_checkpoint=None):
    """``train`` (configs/train_detector.yaml as it is) or, with
    ``init_checkpoint``, ``train_sam3``: the same run with ``model:
    SAM3_DETECTOR``, ``optim.scheme: sam3``, the converted detector as
    its initial weights and the reference recipe's ``loss:
    TRAIN_SAM3_LOSS`` (exact matching, PointRend points), launches also
    checked by rope style; every assignment call timed (synchronized on
    the card) and the auction's rounds a phase counted."""
    import numpy as np
    import torch

    from skix_torch.config import load_config
    from skix_torch.convert import flax_leaf
    from skix_torch.ops import attention as A
    from skix_torch.pipelines import train_detector as T
    from skix_torch.tracking import matcher as TM

    root, argv = _train_argv(tmp)
    t0 = time.perf_counter()
    if not (root / "coco.json").exists():
        write_coco(root, TRAIN_IMAGES, TRAIN_HW, seed=4)
    setup_s = time.perf_counter() - t0
    cfg = load_config("train_detector", argv).to_dict()
    ckpt = tmp / f"{phase}_ckpt"
    cfg["paths"]["checkpoint_dir"] = str(ckpt)
    if init_checkpoint is not None:
        cfg["model"] = dict(SAM3_DETECTOR)
        cfg["optim"]["scheme"] = "sam3"
        cfg["init_checkpoint"] = str(init_checkpoint)
        cfg["loss"] = {**(cfg.get("loss") or {}), **TRAIN_SAM3_LOSS}
    match_s = []            # (step index, seconds) of every assignment call
    orig_assign = (TM.auction_assign, TM.greedy_assign)

    def timed(fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            match_s.append(time.perf_counter() - t)
            return out
        return wrapped

    if init_checkpoint is not None:
        TM.auction_assign, TM.greedy_assign = map(timed, orig_assign)
    TM.AUCTION_ROUNDS.update(phases=0, rounds=0, max_per_phase=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run = T.main(cfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    TM.auction_assign, TM.greedy_assign = orig_assign
    rounds = dict(TM.AUCTION_ROUNDS)
    launches, by_style = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_STYLE)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    res = json.loads((ckpt / "final_eval.json").read_text())
    npz = ckpt / f"sam3_detector_{TRAIN_STEPS:06d}.npz"
    if not npz.exists():
        fail(f"{phase}: no {npz.name}")
    # the key set of the converted tree of the same model (names and
    # shapes, from the port's own state_dict, no data copied)
    want = {}
    for key, t in run.model.state_dict().items():
        parts = key.split(".")
        leaf, arr = flax_leaf(parts[-1], np.broadcast_to(np.float32(0),
                                                         tuple(t.shape)))
        want["/".join(["params", *parts[:-1], leaf])] = arr.shape
    with np.load(npz) as z:
        got = {k: z[k].shape for k in z.files}
    ckpt_mb = npz.stat().st_size / 2 ** 20
    npz.unlink()
    # the eval loader yields len(fixture) // batch batches (at most 8),
    # before and after training
    n_eval = 2 * min(8, TRAIN_IMAGES // int(cfg["batch_size"]))
    expected = {k: TRAIN_STEPS * v for k, v in TRAIN_PER_STEP.items()}
    expected.update({k: n_eval * v for k, v in TRAIN_PER_EVAL.items()})
    expected_style = {k: TRAIN_STEPS * v for k, v in TRAIN_SAM3_PER_STEP.items()}
    expected_style.update({k: n_eval * v
                           for k, v in TRAIN_SAM3_PER_EVAL.items()})
    warm = run.steps[1:]
    split = {k: sum(s[k] for s in warm) / len(warm) * 1e3
             for k in ("data_s", "forward_s", "backward_s", "optimizer_s")}
    # the assignment calls of the steps (the eval forwards make none): as
    # many a step; the warm steps' share
    per_step = len(match_s) // TRAIN_STEPS
    warm_match_ms = sum(match_s[per_step:]) / (TRAIN_STEPS - 1) * 1e3
    match = {} if not match_s else dict(matching_calls_per_step=per_step,
                 warm_matching_ms=warm_match_ms,
                 warm_matching_share=warm_match_ms / sum(split.values()),
                 auction_phases=rounds["phases"],
                 auction_rounds_per_phase_mean=(rounds["rounds"]
                                                / max(rounds["phases"], 1)),
                 auction_rounds_per_phase_max=rounds["max_per_phase"],
                 loss_cfg=json.dumps(cfg.get("loss")).replace(" ", ""))
    say(phase, wall_s=round(wall_s, 3), fixture_setup_s=round(setup_s, 3),
        steps=TRAIN_STEPS, final_loss=res.get("final_loss"),
        ap_before=res.get("ap_before"), ap_after=res.get("ap_after"),
        warm_step_ms=sum(split.values()),
        **{f"warm_{k[:-2]}_ms": v for k, v in split.items()},
        first_step_ms=sum(run.steps[0].values()) * 1e3,
        peak_mem_gib=round(peak_gib, 2), checkpoint_mb=round(ckpt_mb, 1),
        checkpoint_leaves=len(got),
        launches=json.dumps(launches).replace(" ", ""),
        expected_launches=json.dumps(expected).replace(" ", ""),
        launches_by_style=json.dumps(by_style).replace(" ", ""), **match)
    for k in ("final_loss", "ap_before", "ap_after"):
        if not (isinstance(res.get(k), float) and math.isfinite(res[k])):
            fail(f"{phase}: final_eval.json {k} = {res.get(k)}")
    if got != want:
        fail(f"{phase}: the checkpoint's keys/shapes differ from the model's "
             f"converted tree ({len(got)} vs {len(want)} leaves)")
    if launches != expected:
        fail(f"{phase}: launches {launches}, expected {expected}")
    if init_checkpoint is not None and by_style != expected_style:
        fail(f"{phase}: launches by style {by_style}, expected "
             f"{expected_style}")
    return run, launches, by_style


def train_profile_phase(tmp: Path, run):
    """One warm training step of the full-size detector (the main path's
    trained model, a fresh optimizer, one augmented batch) under
    ``torch.profiler``: device busy, idle share, top kernels, and the
    attention kernels' device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skix_torch.config import load_config
    from skix_torch.data import CocoDataset, CocoLoader
    from skix_torch.pipelines import train_detector as T

    root, argv = _train_argv(tmp)
    cfg = load_config("train_detector", argv)
    model = run.model
    size = model.img_size
    loader = CocoLoader(CocoDataset(cfg.coco_json, image_root=root),
                        batch_size=int(cfg.batch_size), image_size=size,
                        max_objects=int(cfg.max_objects),
                        mask_stride=int(cfg.mask_stride), seed=1)
    batch = T.batch_to(next(iter(loader)), "cuda")
    loss_fn = T.make_loss_fn(model, cfg, size)
    opt = T.build_optimizer(cfg, model, TRAIN_STEPS)

    def step():
        loss, _, _ = loss_fn(batch)
        opt.zero_grad()
        loss.backward()
        opt.step()

    step()                      # the fresh optimizer's state, then warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def kind(key):
        for name, tag in (("bwd_single_tile_kernel", "k5"),
                          ("single_tile_kernel", "k2"),
                          ("flash_bwd_dkv_kernel", "k3"),
                          ("flash_bwd_dq_kernel", "k4"),
                          ("flash_fwd_kernel", "k1")):
            if name in key:
                return tag
        return None

    by = {t: 0.0 for t in ("k1", "k2", "k3", "k4", "k5")}
    for e in kernels:
        t = kind(e.key)
        if t:
            by[t] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    say("train_profile", wall_ms=round(wall_ms, 1),
        device_busy_ms=round(busy_ms, 2),
        device_idle_share=round(1.0 - busy_ms / wall_ms, 4),
        **{f"{t}_ms": round(v, 2) for t, v in by.items()},
        **{f"{t}_share": round(v / busy_ms, 4) for t, v in by.items()},
        kernels_launched=sum(e.count for e in kernels))
    say("train_profile_top", kernels=json.dumps(
        [[e.key[:60], round(e.self_device_time_total / 1e3, 2), e.count]
         for e in top]).replace(" ", ""))


# --------------------------------------------------------------------------
# phase 9c: the training CLIs train_lifter and train_pose
# --------------------------------------------------------------------------
def write_lifter_clips(root: Path, n: int, T: int, seed: int) -> None:
    """``n`` clips ``<clip>.npz`` of T frames: a random walk of 17 joints in
    metres (``pose_3d``) and its perspective projection 5 m out
    (``pose_2d``, normalized), as train_lifter's data files hold them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for c in range(n):
        base = rng.normal(0, 0.3, (1, 17, 3))
        walk = np.cumsum(rng.normal(0, 0.01, (T, 1, 3)), 0)
        p3 = (base + walk + rng.normal(0, 0.02, (T, 17, 3))).astype(
            np.float32)
        p2 = (p3[..., :2] / (p3[..., 2:] + 5.0)).astype(np.float32)
        np.savez(root / f"clip_{c:03d}.npz", pose_2d=p2, pose_3d=p3)


def lifter_cfg(data: Path, ckpt: Path, device: str, epochs: int,
               resume: bool, **over) -> dict:
    """configs/train_lifter.yaml with the paths, the device, ``epochs``,
    ``resume`` and ``over``."""
    from skix_torch.config import load_config

    cfg = load_config("train_lifter", config_dir=ROOT / "configs").to_dict()
    cfg.update(device=device, epochs=epochs, resume=resume, **over)
    cfg["paths"] = {"data_root": str(data), "checkpoint_dir": str(ckpt)}
    return cfg


def _npz(path: Path) -> dict:
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _ckpt_errs(got: dict, want: dict):
    """Per group of leaves (params, batch_stats, opt_state, …) the largest
    |got − want| over the leaf's largest |want|, and the largest absolute
    parameter difference."""
    import numpy as np

    errs, p_abs = {}, 0.0
    for k, w in want.items():
        d = float(np.abs(got[k].astype(np.float64) - w).max(initial=0.0))
        group = k.split("/")[0] if "/" in k else k
        if group == "opt_state":
            group = "/".join(k.split("/")[:2])
        errs[group] = max(errs.get(group, 0.0),
                          d / max(float(np.abs(w).max(initial=0.0)), 1e-6))
        if group == "params":
            p_abs = max(p_abs, d)
    return errs, p_abs


def lifter_train_reference_phase(tmp: Path):
    """train_lifter at LIFTER_REF on the card and on the CPU from the same
    clips: 2 epochs, then a resume to a third. The lifters are built with
    dropout 0 (``TemporalLifter`` patched on both runs): the card's and the
    CPU's dropout generators draw different streams. Every epoch's
    checkpoint read back: parameters within Adam's 2·lr a step of each
    other (a rounding-level gradient's sign) and 99 % of their elements
    within 1e-4 of their leaf's scale; BatchNorm statistics and Adam's
    moments within 1e-3 of their scale; the meta files equal; each epoch's
    mean MPJPE within 1e-4 relative."""
    import functools

    import numpy as np

    from skix_torch.models import videopose3d as VP
    from skix_torch.pipelines import train_lifter as TL

    data = tmp / "lifter_ref_data"
    write_lifter_clips(data, 2, 40, seed=70)
    orig = VP.TemporalLifter
    VP.TemporalLifter = functools.partial(orig, dropout=0.0)
    runs = {}
    try:
        for dev in ("cpu", "cuda"):
            ck = tmp / f"lifter_ref_{dev}"
            a = TL.main(lifter_cfg(data, ck, dev, 2, False, **LIFTER_REF))
            b = TL.main(lifter_cfg(data, ck, dev, 3, True, **LIFTER_REF))
            runs[dev] = (ck, a.epochs + b.epochs)
    finally:
        VP.TemporalLifter = orig
    (ck_c, ep_c), (ck_g, ep_g) = runs["cpu"], runs["cuda"]
    steps = sum(e["steps"] for e in ep_c)
    lr = float(lifter_cfg(data, ck_c, "cpu", 1, False)["lr"])
    worst, p_abs, near = {}, 0.0, []
    for e in range(3):
        want = _npz(ck_c / f"epoch_{e:04d}.npz")
        got = _npz(ck_g / f"epoch_{e:04d}.npz")
        if set(got) != set(want):
            fail(f"lifter_train_ref: epoch {e}'s checkpoint keys differ")
        errs, d = _ckpt_errs(got, want)
        p_abs = max(p_abs, d)
        for g, v in errs.items():
            worst[g] = max(worst.get(g, 0.0), v)
        near += [np.abs(got[k] - want[k]) <= 1e-4 * max(
            np.abs(want[k]).max(), 1e-6) for k in want
            if k.startswith("params/")]
        if ((ck_c / f"epoch_{e:04d}_meta.json").read_text()
                != (ck_g / f"epoch_{e:04d}_meta.json").read_text()):
            fail(f"lifter_train_ref: epoch {e}'s meta files differ")
    near_share = float(np.concatenate([n.ravel() for n in near]).mean())
    loss_rel = max(abs(a["mpjpe"] - b["mpjpe"]) / abs(b["mpjpe"])
                   for a, b in zip(ep_g, ep_c))
    say("lifter_train_ref", epochs=len(ep_c), steps=steps,
        mpjpe_cpu=json.dumps([e["mpjpe"] for e in ep_c]).replace(" ", ""),
        mpjpe_rel=loss_rel, param_abs_max=p_abs,
        param_abs_limit=2 * lr * steps, params_within_1e4th_share=near_share,
        errs=json.dumps(worst).replace(" ", ""))
    stats_ok = all(v <= 1e-3 for g, v in worst.items() if g != "params")
    if not (loss_rel <= 1e-4 and p_abs <= 2 * lr * steps
            and near_share >= 0.99 and stats_ok):
        fail("lifter_train_ref: card and CPU disagree")


def lifter_train_phase(tmp: Path):
    """train_lifter at configs/train_lifter.yaml as it is (VideoPose3D
    channels 1024, widths 3 × 5, strided, batch 128, dropout 0.25, Adam
    with the per-epoch decay) on LIFTER_CLIPS synthetic clips of LIFTER_T
    frames: 2 epochs, then a resume to a third; launch counts (none of the
    kernels), s an epoch and ms a step (the warm epochs), peak memory, the
    checkpoints read back (the leaves of the model's tree, Adam's count
    and the step), the resumed run's step count; then the host's share:
    an epoch of the generator's batches alone (ms a batch)."""
    import numpy as np
    import torch

    from skix_torch.convert import flatten_tree, state_dict_to_flax
    from skix_torch.models.generators import ChunkedGenerator
    from skix_torch.ops import attention as A
    from skix_torch.pipelines import train_lifter as TL

    data = tmp / "lifter_data"
    write_lifter_clips(data, LIFTER_CLIPS, LIFTER_T, seed=71)
    ck = tmp / "lifter_ckpt"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    first = TL.main(lifter_cfg(data, ck, "cuda", 2, False))
    resumed = TL.main(lifter_cfg(data, ck, "cuda", 3, True))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    epochs = first.epochs + resumed.epochs
    steps = epochs[0]["steps"]
    warm = epochs[1:]
    epoch_s = sum(e["seconds"] for e in warm) / len(warm)
    want = {f"params/{k}" for k in flatten_tree(state_dict_to_flax(
        first.state.model.state_dict())["params"])}
    last = _npz(ck / "epoch_0002.npz")
    got = {k for k in last if k.startswith("params/")}
    p2, p3 = TL.load_training_data(data)
    gen = ChunkedGenerator(p2, p3, first.state.model.rf, batch_size=128)
    t1 = time.perf_counter()
    n_batches = sum(1 for _ in gen.epoch())
    host_batch_ms = (time.perf_counter() - t1) / n_batches * 1e3
    say("lifter_train", wall_s=round(wall_s, 3), clips=LIFTER_CLIPS,
        frames=LIFTER_CLIPS * LIFTER_T, steps_per_epoch=steps,
        epochs=len(epochs), warm_epoch_s=epoch_s,
        warm_step_ms=epoch_s / steps * 1e3, host_batch_ms=host_batch_ms,
        first_epoch_s=epochs[0]["seconds"],
        mpjpe=json.dumps([e["mpjpe"] for e in epochs]).replace(" ", ""),
        peak_mem_gib=round(peak_gib, 3), checkpoint_leaves=len(last),
        adam_count=int(last["opt_state/count"]), step=int(last["step"]),
        launches=json.dumps(launches).replace(" ", ""))
    if got != want:
        fail(f"lifter_train: the checkpoint's parameters differ from the "
             f"model's tree ({len(got)} vs {len(want)} leaves)")
    if not (int(last["step"]) == int(last["opt_state/count"]) == 3 * steps
            and resumed.state.step == 3 * steps):
        fail(f"lifter_train: the resumed run's step {int(last['step'])}, "
             f"expected {3 * steps}")
    if not all(math.isfinite(e["mpjpe"]) for e in epochs) or not all(
            np.isfinite(v).all() for v in last.values()):
        fail("lifter_train: a loss or checkpoint value is not finite")
    if any(launches.values()):
        fail(f"lifter_train: kernels launched {launches}; none expected")
    return launches, {}


def pose_cfg(coco: Path, ckpt: Path, device: str, **over) -> dict:
    """configs/train_pose.yaml with the fixture, the checkpoint directory,
    the device and ``over``."""
    from skix_torch.config import load_config

    cfg = load_config("train_pose", config_dir=ROOT / "configs").to_dict()
    cfg.update(coco_json=str(coco / "coco.json"), image_root=str(coco),
               device=device, **over)
    cfg["paths"] = {"checkpoint_dir": str(ckpt)}
    return cfg


def pose_train_reference_phase(tmp: Path):
    """train_pose at POSE_REF (YOLOv8-n, one step) on the card and on the
    CPU from one seeded skix npz (``init_checkpoint``) on a keypoints
    fixture: the step's loss within 1e-4 relative; the written checkpoint's
    parameters within Adam's 2·lr a step and 99 % of them within lr/10,
    its BatchNorm statistics (moved by the step's forward, from the same
    weights) within 1e-4 of their scale; final_eval.txt within 1e-3
    relative. (After a second step the statistics come from weights that
    Adam's sign has parted by up to 2·lr: 1.1e-3 of their scale apart.)"""
    import numpy as np
    import torch

    from skix_torch.models.layers import init_like_flax
    from skix_torch.models.yolo_pose import YoloPose
    from skix_torch.pipelines import train_pose as TP

    torch.backends.cudnn.allow_tf32 = False
    coco = tmp / "pose_ref_coco"
    write_coco(coco, 4, (96, 96), seed=72, keypoints=True)
    init = tmp / "pose_ref_init.npz"
    model = YoloPose(scale=POSE_REF["scale"], version=8)
    init_like_flax(model, torch.Generator().manual_seed(5))
    save_skix_npz(init, model)
    runs = {}
    for dev in ("cpu", "cuda"):
        ck = tmp / f"pose_ref_{dev}"
        runs[dev] = (ck, TP.main(pose_cfg(coco, ck, dev, **POSE_REF,
                                          init_checkpoint=str(init))))
    (ck_c, r_c), (ck_g, r_g) = runs["cpu"], runs["cuda"]
    name = f"yolo_pose_{POSE_REF['steps']:06d}.npz"
    want, got = _npz(ck_c / name), _npz(ck_g / name)
    if set(got) != set(want):
        fail("pose_train_ref: the checkpoints' keys differ")
    errs, p_abs = _ckpt_errs(got, want)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want
                           if k.startswith("params/")])
    lr = float(pose_cfg(coco, ck_c, "cpu")["lr"])
    steps = POSE_REF["steps"]
    loss_rel = abs(r_g.steps[0]["loss"] - r_c.steps[0]["loss"]) / abs(
        r_c.steps[0]["loss"])
    err_rel = abs(r_g.final_error - r_c.final_error) / abs(r_c.final_error)
    say("pose_train_ref", steps=steps, loss_cpu=r_c.steps[0]["loss"],
        loss_card=r_g.steps[0]["loss"], loss_rel=loss_rel,
        param_abs_max=p_abs, param_abs_limit=2 * steps * lr,
        params_within_lr_10_share=float((diff <= lr / 10).mean()),
        stats_err=errs.get("batch_stats"), final_error_cpu=r_c.final_error,
        final_error_rel=err_rel)
    if not (loss_rel <= 1e-4 and p_abs <= 2 * steps * lr * 1.01
            and (diff <= lr / 10).mean() >= 0.99
            and errs.get("batch_stats", 0.0) <= 1e-4 and err_rel <= 1e-3):
        fail("pose_train_ref: card and CPU disagree")


def pose_train_phase(tmp: Path):
    """train_pose at configs/train_pose.yaml as it is (YOLOv8-s, 640 px,
    batch 8, clip 10 then AdamW with the cosine rate) for POSE_STEPS steps
    on a POSE_IMAGES-image keypoints fixture written with OpenCV, seeded
    weights; then a resume: 2 more steps from the written npz as
    ``init_checkpoint``. Launch counts (none of the kernels), ms a step
    (warm), peak memory, the checkpoint read back (its leaves the model's
    tree; loaded into a fresh model it gives the trained model's outputs),
    final_eval.txt finite."""
    import torch

    from skix_torch.convert import (flatten_tree, flax_to_state_dict,
                                    load_into, state_dict_to_flax)
    from skix_torch.models.yolo_pose import YoloPose
    from skix_torch.ops import attention as A
    from skix_torch.pipelines import train_pose as TP

    coco = tmp / "pose_coco"
    write_coco(coco, POSE_IMAGES, TRAIN_HW, seed=73, keypoints=True)
    ck = tmp / "pose_ckpt"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run = TP.main(pose_cfg(coco, ck, "cuda", steps=POSE_STEPS, log_every=1))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    npz = ck / f"yolo_pose_{POSE_STEPS:06d}.npz"
    saved = _npz(npz)
    want = set(flatten_tree(state_dict_to_flax(run.model.state_dict())))
    fresh = YoloPose(scale="s", version=8)
    load_into(fresh, flax_to_state_dict(npz))
    fresh = fresh.cuda().eval()
    run.model.eval()
    x = torch.rand(2, 640, 640, 3, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    with torch.no_grad():
        same = torch.equal(fresh(x).cls_logits, run.model(x).cls_logits)
    resumed = TP.main(pose_cfg(coco, tmp / "pose_ckpt_resumed", "cuda",
                               steps=2, init_checkpoint=str(npz),
                               final_eval=False))
    warm = [s["step_s"] for s in run.steps[1:]]
    say("pose_train", wall_s=round(wall_s, 3), steps=POSE_STEPS,
        images=POSE_IMAGES, warm_step_ms=sum(warm) / len(warm) * 1e3,
        first_step_ms=run.steps[0]["step_s"] * 1e3,
        losses=json.dumps([round(s["loss"], 5) for s in run.steps]).replace(
            " ", ""), final_error_px=run.final_error,
        peak_mem_gib=round(peak_gib, 3), checkpoint_leaves=len(saved),
        checkpoint_mb=round(npz.stat().st_size / 2 ** 20, 2),
        reloaded_outputs_equal=same,
        resumed_losses=json.dumps([round(s["loss"], 5)
                                   for s in resumed.steps]).replace(" ", ""),
        launches=json.dumps(launches).replace(" ", ""))
    if set(saved) != want:
        fail("pose_train: the checkpoint's leaves differ from the model's "
             "tree")
    if not (same and math.isfinite(run.final_error)
            and all(math.isfinite(s["loss"]) for s in run.steps
                    + resumed.steps)):
        fail("pose_train: a reloaded output, loss or the final error is off")
    if any(launches.values()):
        fail(f"pose_train: kernels launched {launches}; none expected")
    return launches, {}


# --------------------------------------------------------------------------
# phase 9d: the post-run tools (report, vis_3d_kpt, camera_calibration,
# validate_records, the R|t solver, ICP, the FOV estimator, prefetch, the
# launcher); host code where skix's is (OpenCV, matplotlib), the rest on
# the card. No kernel of ours is on this path.
# --------------------------------------------------------------------------
TOOLS_REF_T, TOOLS_T, TOOLS_J = 300, 900, 17     # frames × joints a view
TOOLS_K = [[1400.0, 0.0, 960.0], [0.0, 1400.0, 540.0], [0.0, 0.0, 1.0]]
TOOLS_RIG_ROTVEC = (0.05, 0.4, 0.02)             # the right camera's turn
TOOLS_REF_STEPS = dict(max_steps=20, cg_iters=20)
TOOLS_ICP_REF_N, TOOLS_ICP_N, TOOLS_ICP_ITERS = 4096, 16384, 10
TOOLS_FOV_REF = (16, (270, 480))                 # frames, (H, W)
TOOLS_FOV = (64, (1080, 1920), 16)               # frames, (H, W), batch
TOOLS_CLIP_T, TOOLS_PREFETCH_CHUNKS = 256, 32
TOOLS_PERSONS = 2
# vis_3d_kpt every 10th frame (the config's stride 1 draws 900 matplotlib
# figures a person): 90 frames a person
TOOLS_VIS_STRIDE = 10
CALIB_VIEWS, CALIB_STRIDE, CALIB_BOARD, CALIB_SQUARE_MM = 60, 10, (9, 6), 25.0
MATPLOTLIB_DRAWN = ("vis_3d_kpt,plot_3d_frame,plot_scene,render_animation,"
                    "report_plot")


def rotvec_matrix(rv):
    """Rodrigues: a rotation vector → its matrix (numpy, float64)."""
    import numpy as np

    a = np.asarray(rv, float)
    th = np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def skier_rig(T: int, seed: int, noise_px: float):
    """Two views of a 17-joint skier crossing 12 m of slope 18–22 m out
    over T frames: the left camera at the origin, the right one 8 m to the
    side and turned 0.4 rad; 1080p pixels with ``noise_px`` of noise,
    confidences in [0.3, 1], the 3D points perturbed by 5 cm (a lifted
    pose's error). Returns (K, t_right, X, uv_left, uv_right, conf)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    K = np.asarray(TOOLS_K)
    R_r, t_r = rotvec_matrix(TOOLS_RIG_ROTVEC), np.array([-8.0, 0.3, 1.0])
    body = rng.normal(size=(TOOLS_J, 3)) * [0.25, 0.5, 0.2]
    s = np.linspace(0.0, 1.0, T)[:, None]
    path = np.concatenate([-6 + 12 * s, 0.3 * np.sin(6 * s),
                           18 + 4 * s], -1)
    X = (body[None] + path[:, None]
         + rng.normal(size=(T, TOOLS_J, 3)) * 0.01).reshape(-1, 3)

    def proj(R, t):
        Xc = X @ R.T + t
        return Xc[:, :2] / Xc[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]

    n = len(X)
    uv_l = proj(np.eye(3), np.zeros(3)) + rng.normal(size=(n, 2)) * noise_px
    uv_r = proj(R_r, t_r) + rng.normal(size=(n, 2)) * noise_px
    conf = rng.uniform(0.3, 1.0, n)
    return K, t_r, X + rng.normal(size=X.shape) * 0.05, uv_l, uv_r, conf


def skier_init(t_r):
    """The right camera's start: 0.05 rad and 0.5 m off the rig."""
    import numpy as np

    return {"rl": np.zeros(3, np.float32), "tl": np.zeros(3, np.float32),
            "rr": np.array([0.08, 0.36, 0.0], np.float32),
            "tr": (t_r + [0.4, -0.2, 0.3]).astype(np.float32)}


def point_maps(n: int, seed: int):
    """Two seeded point maps of ``n`` points (a skier-sized surface 6 m
    out, a second view's map of it turned 0.15 rad and shifted 10 cm, with
    1 cm of noise and 1 point in 20 an outlier), the source's projections
    (1080p) and the person box around them (their 3rd to 97th
    percentiles), for the bbox gate."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 2 * np.pi, n)
    h = rng.uniform(-0.9, 0.9, n)
    tgt = np.stack([0.25 * np.cos(u), h, 6.0 + 0.2 * np.sin(u)], -1)
    tgt += rng.normal(size=tgt.shape) * 0.02
    a = 0.15
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    src = (tgt[rng.permutation(n)] - [0.1, 0.02, -0.05]) @ R
    src += rng.normal(size=src.shape) * 0.01
    src[::20] += rng.normal(size=src[::20].shape) * 0.5
    uv = src[:, :2] / src[:, 2:] * 1400.0 + [960.0, 540.0]
    box = [*np.percentile(uv, 3, axis=0), *np.percentile(uv, 97, axis=0)]
    return src.astype(np.float32), tgt.astype(np.float32), uv, box


def fov_variables(seed: int, width: int = 32, depth: int = 4) -> dict:
    """skix FovEstimator variables (flax layout, numpy) drawn from ``seed``:
    kernels with variance 1/fan_in, GroupNorm scales near 1, small biases."""
    import numpy as np

    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for i in range(depth):
        c = width * (1 + i // 2)
        params[f"conv_{i}"] = {
            "kernel": (rng.normal(size=(3, 3, cin, c)) / np.sqrt(9 * cin)
                       ).astype(np.float32),
            "bias": (0.05 * rng.normal(size=c)).astype(np.float32)}
        params[f"norm_{i}"] = {
            "scale": (1 + 0.05 * rng.normal(size=c)).astype(np.float32),
            "bias": (0.05 * rng.normal(size=c)).astype(np.float32)}
        cin = c
    params["head"] = {"kernel": (rng.normal(size=(cin, 2)) / np.sqrt(cin)
                                 ).astype(np.float32),
                      "bias": (0.05 * rng.normal(size=2)).astype(np.float32)}
    return {"params": params}


def _rt_errs(cpu, card, baseline: float):
    import torch

    def d(a, b):
        return float((a.cpu() - b.cpu()).abs().max())

    def rel(s):
        return (s.R_right @ s.R_left.T).cpu()

    R = max(d(cpu.R_left, card.R_left), d(cpu.R_right, card.R_right))
    t = max(d(cpu.t_left, card.t_left), d(cpu.t_right, card.t_right))
    return {"R": R, "R_rel": d(rel(cpu), rel(card)),
            "t_of_baseline": t / baseline, "X": d(cpu.X, card.X),
            "cost_cpu": float(cpu.final_cost),
            "cost_card": float(card.final_cost),
            "initial_cost": float(cpu.initial_cost),
            "finite": all(bool(torch.isfinite(x).all()) for x in card)}


def tools_reference_phase(tmp: Path):
    """The card against the CPU on the same seeded inputs: solve_rt_from_3d
    on 2 views × TOOLS_REF_T frames × 17 joints, cameras only (from the
    RANSAC start, 0.5 px of noise): R within 1e-4, t within 1e-4 of the
    baseline, the final cost within 1e-4 relative; with refine_points
    (exact observations, the points 5 cm off), TOOLS_REF_STEPS each: both
    final costs below 1e-6 of the initial cost. With the points free skix's
    problem leaves the cameras' and points' similarity gauge free and has a
    flat bas-relief direction (a narrow view of a skier 20 m out), so its
    poses are not a function of the data at float32: on the CPU alone a
    1e-7 relative change of the input points moves R by 2.1e-4 and the
    relative rotation by 5.6e-5 (20 × 20; 5.4e-4 at 60 × 30); their
    differences are printed, not held; icp on TOOLS_ICP_REF_N points a
    map, bbox-gated:
    the last iteration's nearest indices equal, R, t, rms and inlier_frac
    within 1e-5; the FovEstimator forward on TOOLS_FOV_REF frames from
    seeded, converted variables within 1e-5 rad; report's pose_summary on a
    (TOOLS_REF_T, 70, 3) and a (TOOLS_REF_T, 17, 3) sequence within 1e-5
    relative; device_prefetch over TOOLS_PREFETCH_CHUNKS chunks each equal
    to a synchronous copy, in order."""
    import numpy as np
    import torch

    from skix_torch.geometry.icp import bbox_gate_mask, icp
    from skix_torch.io.prefetch import device_prefetch
    from skix_torch.models.fov import load_fov_estimator
    from skix_torch.pipelines.report import pose_summary
    from skix_torch.solvers.rt_solver import solve_rt_from_3d

    t0 = time.perf_counter()
    bad = []
    for mode in ("cameras", "points"):
        points = mode == "points"
        K, t_r, X, uv_l, uv_r, conf = skier_rig(TOOLS_REF_T, 211,
                                                0.0 if points else 0.5)
        base = float(np.linalg.norm(t_r))
        kw = dict(conf=conf, refine_points=points, **TOOLS_REF_STEPS)
        if points:
            kw["init"] = skier_init(t_r)
        else:
            kw["baseline_m"] = base
        sols = {dev: solve_rt_from_3d(X, uv_l, uv_r, K, device=dev, **kw)
                for dev in ("cpu", "cuda")}
        e = _rt_errs(sols["cpu"], sols["cuda"], base)
        if points:
            held = "costs<1e-6*initial"
            ok = max(e["cost_cpu"], e["cost_card"]) <= 1e-6 * e["initial_cost"]
        else:
            held = "R1e-4,t1e-4_of_baseline,cost1e-4_rel"
            ok = (e["R"] <= 1e-4 and e["t_of_baseline"] <= 1e-4
                  and abs(e["cost_card"] - e["cost_cpu"])
                  <= 1e-4 * e["cost_cpu"])
        say("tools_ref", check=f"rt_{mode}", points=len(X),
            R_err=e["R"], R_rel_err=e["R_rel"],
            t_err_of_baseline=e["t_of_baseline"], X_err=e["X"],
            cost_cpu=e["cost_cpu"], cost_card=e["cost_card"],
            initial_cost=e["initial_cost"], held=held)
        if not (ok and e["finite"]):
            bad.append(f"rt_{mode}")

    src, tgt, uv, box = point_maps(TOOLS_ICP_REF_N, 223)
    gate = bbox_gate_mask(torch.as_tensor(uv), box)
    res = {dev: icp(src, tgt, source_valid=gate, iterations=TOOLS_ICP_ITERS,
                    device=dev) for dev in ("cpu", "cuda")}
    same_nn = torch.equal(res["cpu"].nn_idx, res["cuda"].nn_idx.cpu())
    errs = {k: float((getattr(res["cpu"], k) - getattr(res["cuda"], k).cpu())
                     .abs().max()) for k in ("R", "t", "rms", "inlier_frac")}
    say("tools_ref", check="icp", points=TOOLS_ICP_REF_N,
        gated=int(gate.sum()), nn_idx_equal=same_nn,
        rms=float(res["cuda"].rms), **{f"{k}_err": v for k, v in errs.items()},
        limit=1e-5)
    if not same_nn or max(errs.values()) > 1e-5:
        bad.append("icp")

    n, (H, W) = TOOLS_FOV_REF
    frames = np.random.default_rng(227).integers(0, 256, (n, H, W, 3),
                                                 dtype=np.uint8)
    variables = fov_variables(229)
    fov = {}
    for dev in ("cpu", "cuda"):
        model = load_fov_estimator(variables, device=dev)
        with torch.no_grad():
            x = torch.as_tensor(frames, device=dev).float() / 255.0
            fov[dev] = model(x).cpu()
    err = float((fov["cpu"] - fov["cuda"]).abs().max())
    say("tools_ref", check="fov", frames=n, hw=f"{H}x{W}", max_abs_err_rad=err,
        fov_deg=json.dumps([round(float(v), 3) for v in torch.rad2deg(
            fov["cuda"]).aminmax()]),
        limit=1e-5)
    if not err <= 1e-5:
        bad.append("fov")

    rng = np.random.default_rng(233)
    worst = 0.0
    for J in (70, 17):
        seq = (rng.normal(size=(1, J, 3)) * 0.3 + rng.normal(
            size=(TOOLS_REF_T, J, 3)).cumsum(0) * 0.01).astype(np.float32)
        a, b = pose_summary(seq, "cpu"), pose_summary(seq, "cuda")
        for k, v in a.items():
            if isinstance(v, float):
                worst = max(worst, abs(b[k] - v) / max(abs(v), 1e-30))
            elif b[k] != v:
                worst = float("inf")
    say("tools_ref", check="pose_summary", shapes="300x70x3,300x17x3",
        max_rel_err=worst, limit=1e-5)
    if not worst <= 1e-5:
        bad.append("pose_summary")

    chunks = [np.random.default_rng(239 + i).integers(
        0, 256, (4, 270, 480, 3), dtype=np.uint8)
        for i in range(TOOLS_PREFETCH_CHUNKS)]
    got = list(device_prefetch(iter(chunks)))
    ok = len(got) == len(chunks) and all(
        g.is_cuda and torch.equal(g, torch.as_tensor(c).cuda())
        for g, c in zip(got, chunks))
    say("tools_ref", check="device_prefetch", chunks=len(got),
        equal_in_order=ok)
    if not ok:
        bad.append("device_prefetch")
    say("tools_ref", wall_s=round(time.perf_counter() - t0, 1),
        failed=",".join(bad) or "none")
    if bad:
        fail(f"tools_ref: {bad} off the card-vs-CPU limits")


def write_tools_tree(root: Path, persons: int, T: int, seed: int):
    """A run_all-shaped output tree: per person fused/<p>/<p>_fused.npy and
    <p>_smoothed.npy (T, 70, 3) and sam3d/<p>/cam_{left,right}/frame_*.npz
    (SAM-3D-Body's per-frame fields), and a Unity-GT npy; returns its
    path."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for i in range(persons):
        p = f"p{i + 1:02d}"
        seq = (rng.normal(size=(1, 70, 3)) * 0.3 + [0, 0, 6.0]
               + rng.normal(size=(T, 70, 3)).cumsum(0) * 0.005
               ).astype(np.float32)
        d = root / "fused" / p
        d.mkdir(parents=True)
        np.save(d / f"{p}_fused.npy", seq)
        np.save(d / f"{p}_smoothed.npy", seq)
        for view in ("cam_left", "cam_right"):
            v = root / "sam3d" / p / view
            v.mkdir(parents=True)
            for t in range(T):
                np.savez(v / f"frame_{t:06d}.npz",
                         pred_keypoints_3d=seq[t],
                         pred_keypoints_2d=(rng.uniform(0, 1080, (70, 2))
                                            .astype(np.float32)))
    gt = root.parent / "unity_gt.npy"
    np.save(gt, (rng.normal(size=(T, 70, 3)) * 0.3).astype(np.float32))
    return gt


def chessboard_clip(path: Path):
    """A 1080p mp4 of CALIB_VIEWS × CALIB_STRIDE frames: each of
    CALIB_VIEWS seeded poses of a 9 × 6-corner, 25 mm board, rendered on the
    host with a perspective warp through TOOLS_K, held for CALIB_STRIDE
    frames. Returns the true K."""
    import cv2
    import numpy as np

    cols, rows = CALIB_BOARD
    px = 40                                   # board pixels a square
    board = np.full(((rows + 3) * px, (cols + 3) * px), 255, np.uint8)
    for r in range(rows + 1):
        for c in range(cols + 1):
            if (r + c) % 2 == 0:
                board[(r + 1) * px:(r + 2) * px, (c + 1) * px:(c + 2) * px] = 0
    # board pixel (u, v) → plane mm; the first inner corner is the edge at
    # pixel 2·px, i.e. coordinate 2·px − 0.5 in OpenCV's pixel centres
    mm = CALIB_SQUARE_MM / px
    A = np.array([[mm, 0, -(2 * px - 0.5) * mm], [0, mm, -(2 * px - 0.5) * mm],
                  [0, 0, 1]])
    K = np.asarray(TOOLS_K)
    outer = np.array([[-2, -2, 0], [cols + 1, -2, 0], [cols + 1, rows + 1, 0],
                      [-2, rows + 1, 0]], float) * CALIB_SQUARE_MM
    rng = np.random.default_rng(241)
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                          (1920, 1080))
    try:
        made = 0
        while made < CALIB_VIEWS:
            rvec = rng.normal(size=3) * [0.35, 0.35, 0.2]
            tvec = np.array([rng.uniform(-150, 50), rng.uniform(-100, 30),
                             rng.uniform(450, 750)])
            R, _ = cv2.Rodrigues(rvec)
            corners, _ = cv2.projectPoints(outer, rvec, tvec, K, None)
            c = corners.reshape(-1, 2)
            if (c[:, 0].min() < 20 or c[:, 1].min() < 20
                    or c[:, 0].max() > 1900 or c[:, 1].max() > 1060):
                continue
            H = K @ np.column_stack([R[:, 0], R[:, 1], tvec]) @ A
            img = cv2.warpPerspective(board, H, (1920, 1080),
                                      flags=cv2.INTER_LINEAR,
                                      borderValue=110)
            frame = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
            for _ in range(CALIB_STRIDE):
                out.write(frame)
            made += 1
    finally:
        out.release()
    return K


def write_fuse_persons(root: Path, n: int, T: int, seed: int) -> list:
    """``n`` person dirs of fuse's input: cam_left.npz and cam_right.npz
    with SAM-3D-Body's ``pred_keypoints_3d`` (T, 70, 3) and
    ``pred_keypoints_2d``; returns the person names."""
    import numpy as np

    rng = np.random.default_rng(seed)
    names = [f"p{i + 1:02d}" for i in range(n)]
    for p in names:
        seq = rng.normal(size=(1, 70, 3)) * 0.3 + rng.normal(
            size=(T, 70, 3)).cumsum(0) * 0.005
        for view in ("cam_left", "cam_right"):
            (root / p).mkdir(parents=True, exist_ok=True)
            np.savez(root / p / f"{view}.npz",
                     pred_keypoints_3d=(seq + rng.normal(size=seq.shape)
                                        * 0.01).astype(np.float32),
                     pred_keypoints_2d=rng.uniform(0, 1080, (T, 70, 2)
                                                   ).astype(np.float32))
    return names


def tools_phase(tmp: Path):
    """The post-run tools at the sizes users run, each step's time and peak
    device memory: rt_solver at the chain's size (2 views × TOOLS_T × 17,
    refine_points: 45 912 unknowns, from the RANSAC start, configs' 60 LM
    steps × 30 CG); icp on two TOOLS_ICP_N-point maps, bbox-gated;
    estimate_focal_lengths on 64 frames of 1080p; read_video_chunks with and
    without device_prefetch over 256 frames of 1080p; validate_records
    over 4 records, one malformed; report over a run_all-shaped tree
    (TOOLS_PERSONS persons × TOOLS_T frames, max_artifacts 64, unity_gt);
    vis_3d_kpt (fused, stride TOOLS_VIS_STRIDE) where matplotlib is
    installed, said so where it is not; camera_calibration on a 600-frame
    1080p chessboard video; the launcher: two processes on the card
    running fuse over a shard root of 4 persons."""
    import importlib.util

    import numpy as np
    import torch

    from skix_torch.geometry.icp import bbox_gate_mask, icp
    from skix_torch.io.prefetch import device_prefetch
    from skix_torch.io.video import probe_video, read_video_chunks
    from skix_torch.models.fov import (estimate_focal_lengths,
                                       load_fov_estimator)
    from skix_torch.ops import attention as A
    from skix_torch.pipelines import camera_calibration, report
    from skix_torch.pipelines import validate_records, vis_3d_kpt
    from skix_torch.solvers.rt_solver import solve_rt_from_3d
    from skix_torch.utils.launch import shard_work

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    say("tools_device", card=json.dumps(smi.stdout.strip()))
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    say("tools_matplotlib", installed=have_mpl,
        left_out="none" if have_mpl else MATPLOTLIB_DRAWN,
        held_by="tests/test_torch_post_tools.py (CPU twins)")
    times = {}

    def step():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def done(name, t0, **fields):
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        times[name] = ms
        say("tools", step=name, ms=round(ms, 3), peak_mib=round(peak, 1),
            **fields)

    reset_counts()
    # the R|t solver at the chain's size
    K, t_r, X, uv_l, uv_r, conf = skier_rig(TOOLS_T, 251, 1.0)
    base = float(np.linalg.norm(t_r))
    t0 = step()
    sol = solve_rt_from_3d(X, uv_l, uv_r, K, conf=conf, refine_points=True,
                           baseline_m=base)
    done("rt_solver", t0, points=len(X), unknowns=12 + X.size,
         steps_cg="60x30", initial_cost=float(sol.initial_cost),
         final_cost=float(sol.final_cost),
         R_right_err=float(np.abs(sol.R_right.cpu().numpy()
                                  - rotvec_matrix(TOOLS_RIG_ROTVEC)).max()))
    if not (float(sol.final_cost) < float(sol.initial_cost)
            and torch.isfinite(sol.X).all()):
        fail("tools: rt_solver left the cost or non-finite points")

    # ICP on two point maps, bbox-gated
    src, tgt, uv, box = point_maps(TOOLS_ICP_N, 257)
    gate = bbox_gate_mask(torch.as_tensor(uv, device="cuda"), box)
    start = icp(src, tgt, source_valid=gate, iterations=0)    # warm
    t0 = step()
    res = icp(src, tgt, source_valid=gate, iterations=TOOLS_ICP_ITERS)
    done("icp", t0, points=f"{TOOLS_ICP_N}x{TOOLS_ICP_N}",
         gated=int(gate.sum()), iterations=TOOLS_ICP_ITERS,
         rms=float(res.rms), rms_at_start=float(start.rms),
         inlier_frac=float(res.inlier_frac))
    if not float(res.rms) < float(start.rms):
        fail(f"tools: icp rms {float(res.rms)} from {float(start.rms)}")

    # the FOV estimator on 1080p frames
    n, (H, W), batch = TOOLS_FOV
    frames = np.random.default_rng(263).integers(0, 256, (n, H, W, 3),
                                                 dtype=np.uint8)
    model = load_fov_estimator(fov_variables(229))
    estimate_focal_lengths(model, frames[:batch], batch_size=batch)  # warm
    t0 = step()
    f = estimate_focal_lengths(model, frames, batch_size=batch)
    done("fov", t0, frames=n, batch=batch, hw=f"{H}x{W}")
    say("tools", step="fov_per_frame", ms=round(times["fov"] / n, 4),
        focal_px_range=json.dumps([round(float(f.min()), 2),
                                   round(float(f.max()), 2)]))
    if f.shape != (n, 2) or not np.isfinite(f).all():
        fail("tools: estimate_focal_lengths gave no finite (fx, fy) a frame")

    # read_video_chunks without and with device_prefetch, over the first
    # TOOLS_CLIP_T frames of the calibration's 1080p chessboard clip
    board = tmp / "tools_board.mp4"
    K_true = chessboard_clip(board)

    def frames_per_s(prefetch: bool) -> float:
        t0 = step()
        chunks = read_video_chunks(board, chunk_size=32,
                                   max_frames=TOOLS_CLIP_T)
        seen = 0
        for c in device_prefetch(chunks) if prefetch else chunks:
            x = c if prefetch else torch.as_tensor(c).cuda()
            x.float().mean()
            seen += len(x)
        torch.cuda.synchronize()
        if seen != TOOLS_CLIP_T:
            fail(f"tools: read {seen} of {TOOLS_CLIP_T} frames")
        return seen / (time.perf_counter() - t0)

    sync_fps, prefetch_fps = frames_per_s(False), frames_per_s(True)
    say("tools", step="prefetch", frames=TOOLS_CLIP_T, hw="1080x1920",
        sync_fps=round(sync_fps, 2), prefetch_fps=round(prefetch_fps, 2),
        peak_mib=round(torch.cuda.max_memory_allocated() / 2 ** 20, 1))

    # validate_records over 4 records, one malformed
    from skix_torch.io.contracts import PTInfo, save_pt_info

    recs = tmp / "tools_records"
    kp = np.zeros((30, 17, 3), np.float32)
    for i in range(4):
        save_pt_info(recs / f"p0{i % 2 + 1}" / f"v{i}.npz", PTInfo(
            video_name=f"v{i}", frame_count=30 if i != 2 else 31,
            img_shape=(1080, 1920), fps=30.0, duration=1.0,
            yolo_keypoints=kp, yolo_bbox=np.zeros((30, 4), np.float32)),
            validate=i != 2)
    t0 = step()
    validate_records.main({"paths": {"pt_root": str(recs)}, "strict": False})
    rep = json.loads((recs / "validation_report.json").read_text())
    named = sorted(k for k, v in rep.items() if v)
    done("validate_records", t0, records=len(rep),
         with_problems=json.dumps(named))
    if named != ["p01/v2.npz"] or len(rep) != 4:
        fail(f"tools: validate_records named {named}, not p01/v2.npz")

    # report over a run_all-shaped tree
    tree = tmp / "tools_run" / "work"
    gt = write_tools_tree(tree, TOOLS_PERSONS, TOOLS_T, 271)
    out = tmp / "tools_report"
    t0 = step()
    results = report.main({
        "paths": {"in_root": str(tree), "out_root": str(out)},
        "patterns": ["**/*.npy", "**/*.npz"], "max_artifacts": 64,
        "plot": have_mpl, "unity_gt": str(gt)})
    rj = json.loads((out / "report.json").read_text())
    poses = {k: r for k, r in rj.items() if "pose" in r}
    done("report", t0, artifacts=len(rj), pose_artifacts=len(poses),
         gt_entries=sum("gt" in r for r in rj.values()),
         errors=sum("error" in r for r in rj.values()), plot=have_mpl)
    want_pose = {f"fused/p{i + 1:02d}/p{i + 1:02d}_{k}.npy"
                 for i in range(TOOLS_PERSONS) for k in ("fused", "smoothed")}
    if (len(rj) != 64 or set(poses) != want_pose or results is None
            or not all("gt" in r and math.isfinite(r["gt"][
                "mpjpe_root_centered"]) for r in poses.values())
            or not (out / "report.md").exists()):
        fail(f"tools: report.json holds {sorted(poses)} pose entries of "
             f"{len(rj)} artifacts; wanted {sorted(want_pose)} with gt")

    # vis_3d_kpt over the fused sequences (matplotlib on the host)
    if have_mpl:
        vis = tmp / "tools_vis"
        t0 = step()
        vis_3d_kpt.main({"paths": {"in_root": str(tree / "fused"),
                                   "out_root": str(vis)},
                         "mode": "fused", "layout": "mhr70", "fps": 30.0,
                         "stride": TOOLS_VIS_STRIDE})
        counts = {p.name: probe_video(p).frame_count
                  for p in sorted(vis.rglob("*_3d.mp4"))}
        done("vis_3d_kpt", t0, videos=json.dumps(counts).replace(" ", ""))
        want = {f"p{i + 1:02d}_smoothed_3d.mp4": TOOLS_T // TOOLS_VIS_STRIDE
                for i in range(TOOLS_PERSONS)}
        if counts != want:
            fail(f"tools: vis_3d_kpt wrote {counts}, wanted {want}")
    else:
        say("tools", step="vis_3d_kpt", run=False,
            reason="matplotlib_not_installed")

    # camera_calibration on the 1080p chessboard video
    calib = tmp / "tools_calib"
    t0 = step()
    try:
        camera_calibration.main({"paths": {"input": str(board),
                                           "out_dir": str(calib)}})
    except SystemExit as e:
        fail(f"tools: camera_calibration stopped: {e}")
    with np.load(calib / "calibration_parameters.npz") as z:
        K_est, rms = z["K"], float(z["rms"])
    views = len((calib / "reprojection_errors.csv").read_text()
                .splitlines()) - 1
    focal_err = float(max(abs(K_est[0, 0] / K_true[0, 0] - 1),
                          abs(K_est[1, 1] / K_true[1, 1] - 1)))
    done("camera_calibration", t0, frames=CALIB_VIEWS * CALIB_STRIDE,
         views_kept=views, rms_px=rms, focal_rel_err=focal_err,
         fx=float(K_est[0, 0]), fy=float(K_est[1, 1]),
         cx=float(K_est[0, 2]), cy=float(K_est[1, 2]))
    if views < 3 or not rms < 1.0:
        fail(f"tools: camera_calibration kept {views} views at rms {rms}")

    # the launcher: two processes on the card, fuse over 4 persons
    shard = tmp / "tools_shard"
    persons = write_fuse_persons(shard, 4, 300, 277)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = step()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "skix_torch.utils.launch", "fuse",
         f"--shard-root={shard}", f"paths.in_root={shard}",
         f"paths.out_root={tmp / 'tools_fused' / f'proc{r}'}"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT),
                 SKIX_COORDINATOR=f"localhost:{port}", SKIX_NUM_PROCESSES="2",
                 SKIX_PROCESS_ID=str(r))) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    shares, ok = {}, all(p.returncode == 0 for p in procs)
    for r in range(2):
        summ = tmp / "tools_fused" / f"proc{r}" / "fuse_summary.json"
        got = json.loads(summ.read_text()) if summ.exists() else {}
        shares[r] = sorted(got)
        dirs = sorted(d.name for d in summ.parent.iterdir() if d.is_dir()
                      ) if summ.exists() else []
        ok &= (shares[r] == dirs == shard_work(persons, r, 2)
               and all(v.get("frames") == 300 for v in got.values()))
    done("launch", t0, processes=2,
         shares=json.dumps(shares).replace(" ", ""),
         rcs=json.dumps([p.returncode for p in procs]))
    if not ok:
        fail("tools: the launcher's processes did not each write exactly "
             f"their share: {shares}\n" + "\n".join(
                 log[-2000:] for log in logs))
    launches = dict(A.LAUNCHES)
    say("tools", step="total", ms=round(sum(times.values()), 1),
        launches=json.dumps(launches).replace(" ", ""))
    if any(launches.values()):
        fail(f"tools: kernels launched {launches}; none expected")
    return launches, {}


# --------------------------------------------------------------------------
# phase 9e: mask-prompted video object segmentation and the tracking suite
# --------------------------------------------------------------------------
# vos_ref: the committed trained trackers (tests/fixtures/tracker_tiny224.npz:
# Sam3Detector.tiny at 224 px and a MaskMemoryTracker of 48 features over 2
# heads, head dim 24, which K1 runs padded to 32) on the card against the
# CPU, on scripts/make_tracker_fixture.py's clips: eval_tracker's held-out
# propagation (4 clips from seed 31 000, 2 objects, 6 frames) held at skix's
# floors (tests/test_tracker_fixture224.py:107-108); the masklet at that
# test's config with fill_holes on seeds 5000-5002 × 12 frames, scored by
# evaluate_tracking_suite with masks (skix's HOTA floors, :133-135, printed
# beside, not held); the interactive predictor on one 12-frame clip
VOS_FIXTURE = ROOT / "tests" / "fixtures" / "tracker_tiny224.npz"
VOS_PROP_SEED, VOS_PROP_CLIPS, VOS_PROP_T = 31_000, 4, 6
VOS_PROP_FLOORS = {"miou": 0.6, "identity": 0.9}
VOS_MASKLET_SEEDS, VOS_MASKLET_T = (5000, 5001, 5002), 12
VOS_MASKLET_CFG = dict(max_objects=4, max_dets=6,
                       score_threshold_detection=0.25, new_det_thresh=0.45,
                       det_nms_thresh=0.6, assoc_iou_thresh=0.2,
                       trk_assoc_iou_thresh=0.2, hotstart_delay=1000,
                       hotstart_unmatch_thresh=4, hotstart_dup_thresh=2)
VOS_HOTA_FLOORS = {"HOTA": 0.53, "DetA": 0.35, "AssA_alpha0": 0.85}
# vos_ref's limits, card against CPU: logits relative to their scale, the
# share of mask pixels that differ, masklet (frame, slot) ids that differ,
# and |card − CPU| of each suite metric
VOS_REF_LIMITS = {"logits": 1e-4, "mask_pixels": 1e-3, "ids": 0,
                  "metrics": 1e-2}
# vos: the front stage's tracker at its defaults (MaskMemoryTracker(): 64
# features, 1 head, 4 memory slots, the conv trunk; seeded weights) on the
# disk world at 1008 px (a 126 × 126 grid): propagate_objects with 4 objects
# × 24 frames (K1-lse at (4, 1, 15876, 64) × 63504, 2 a frame); the
# predictor (2 conditioning frames, 2 recent) on 2 objects × 16 frames,
# forward then reverse (the slot scan: no launch); the hole fill (area 16)
# on the 4 × 24 grid masks; get_next_point("center") (the EDT) on 4 masks
# at 1008²; evaluate_tracking_suite over the 4 × 24 outputs
VOS_HW, VOS_OBJECTS, VOS_T = 1008, 4, 24
VOS_PRED_OBJECTS, VOS_PRED_T = 2, 16


def tracker_world():
    """scripts/make_tracker_fixture.py as a module (its world and clips are
    numpy; the functions that import JAX are not called)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_tracker_fixture", ROOT / "scripts" / "make_tracker_fixture.py")
    mtf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mtf)
    return mtf


def _masklet_tracks(outs):
    """Per-frame (boxes xyxy px, ids, spawn scores, masks) of the active,
    non-empty slots of a masklet stream (the fixture test's reading)."""
    import numpy as np
    import torch

    from skix_torch.ops.masks import masks_to_boxes

    pb, pi, ps, pm = [], [], [], []
    for o in outs:
        out = o["outputs"]
        keep = out["active"] & out["mask"].reshape(
            len(out["mask"]), -1).any(1)
        pb.append(masks_to_boxes(torch.as_tensor(out["mask"][keep])).numpy())
        pi.append(np.asarray(out["obj_id"])[keep])
        ps.append(np.asarray(out["score"])[keep])
        pm.append(out["mask"][keep])
    return pb, pi, ps, pm


def _gt_tracks(masks, valid):
    """Per-frame (boxes, ids, masks) of the visible ground-truth objects."""
    import numpy as np
    import torch

    from skix_torch.ops.masks import masks_to_boxes

    gb, gi, gm = [], [], []
    for t in range(len(masks)):
        keep = valid[t] & masks[t].reshape(len(masks[t]), -1).any(1)
        gb.append(masks_to_boxes(torch.as_tensor(masks[t][keep])).numpy())
        gi.append(np.where(keep)[0])
        gm.append(masks[t][keep])
    return gb, gi, gm


def vos_reference_phase():
    """The trained fixture trackers on the card against the CPU: propagation
    (held at skix's floors), the masklet with fill_holes and the suite, the
    interactive predictor; K1-lse launches counted on the card."""
    import numpy as np
    import torch

    from skix_torch.metrics.suite import evaluate_tracking_suite
    from skix_torch.ops import attention as A
    from skix_torch.tracking.fixture import fixture_prompt, load_tracker_fixture
    from skix_torch.tracking.masklet import MaskletConfig, MaskletVideoModel
    from skix_torch.tracking.memory_tracker import (propagate_object,
                                                    propagate_objects)
    from skix_torch.tracking.vos_predictor import InteractiveVideoPredictor

    # float32 convolutions on both sides (as phase 4 sets them in a full
    # run; this group may run alone: --only vos)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mtf = tracker_world()
    mtf.set_world_size(224)
    models = {d: load_tracker_fixture(VOS_FIXTURE, device=d)
              for d in ("cpu", "cuda")}
    bad, errs, px = [], {}, []

    def compare(part, card, cpu):
        errs.setdefault(part, []).append(scaled_err(card, cpu))
        px.append(float(np.mean((np.asarray(card) > 0)
                                != (np.asarray(cpu) > 0))))

    # 1. propagation on eval_tracker's held-out clips
    gh = mtf.H // 8
    ious, correct = [], []
    for s in range(VOS_PROP_CLIPS):
        fr, _, mk, _ = mtf.synth_clip(VOS_PROP_SEED + s, T=VOS_PROP_T,
                                      n_obj=2, min_sep=1.5)
        for k in (0, 1):
            lg = {}
            for d in ("cpu", "cuda"):
                reset_counts()
                lg[d], _ = propagate_object(models[d][1], fr, mk[0, k])
                if d == "cuda" and dict(A.LAUNCHES) != {
                        "flash_fwd_lse": 2 * VOS_PROP_T}:
                    bad.append(f"propagate_object launched "
                               f"{dict(A.LAUNCHES)}")
            compare("propagate_object", lg["cuda"], lg["cpu"])
            for t in range(1, VOS_PROP_T):
                pred = lg["cuda"][t] > 0

                def iou(g):
                    g = mtf.jax_resize(g, gh, gh)
                    return (pred & g).sum() / max((pred | g).sum(), 1)
                ious.append(iou(mk[t, k]))
                correct.append(iou(mk[t, k]) > iou(mk[t, 1 - k]))
    miou, identity = float(np.mean(ious)), float(np.mean(correct))
    if not (miou > VOS_PROP_FLOORS["miou"]
            and identity > VOS_PROP_FLOORS["identity"]):
        bad.append(f"propagation mIoU {miou}, identity {identity} under "
                   f"skix's floors {VOS_PROP_FLOORS}")
    # both objects of the last clip as one batch of banks
    lg = {}
    for d in ("cpu", "cuda"):
        reset_counts()
        lg[d], _ = propagate_objects(models[d][1], fr, mk[0, :2])
    batched = dict(A.LAUNCHES_BY_SHAPE)
    if batched != {"flash_fwd_lse/2x2x784x32": 2 * VOS_PROP_T}:
        bad.append(f"propagate_objects launched {batched}")
    compare("propagate_objects", lg["cuda"], lg["cpu"])
    say("vos_ref_propagation", miou=round(miou, 4),
        identity=round(identity, 4), floors=json.dumps(
            VOS_PROP_FLOORS).replace(" ", ""),
        k1_lse_per_frame=2, batched=json.dumps(batched).replace(" ", ""))

    # 2. the masklet with fill_holes, scored by the suite
    cfg = MaskletConfig(**VOS_MASKLET_CFG)
    tracks, ids_differ, slots = {}, 0, 0
    per_frame = {}
    for d in ("cpu", "cuda"):
        det, trk = models[d]
        mdl = MaskletVideoModel(det, trk, cfg, fill_holes=True)
        prompt = fixture_prompt(device=d)
        pb, pi, ps, pm, gb, gi, gm, streams = [], [], [], [], [], [], [], []
        reset_counts()
        for seed in VOS_MASKLET_SEEDS:
            frames, _, masks, valid = mtf.synth_clip(seed, T=VOS_MASKLET_T,
                                                     n_obj=2)
            outs = list(mdl.propagate((frames * 255).astype(np.uint8),
                                      prompt))
            streams.append(outs)
            b, i, sc, m = _masklet_tracks(outs)
            g, gid, g_m = _gt_tracks(masks, valid)
            pb += b
            pi += [x + 100 * seed for x in i]
            ps += sc
            pm += m
            gb += g
            gi += [x + 100 * seed for x in gid]
            gm += g_m
        if d == "cuda":
            n = len(VOS_MASKLET_SEEDS) * VOS_MASKLET_T
            per_frame = {k: v / n for k, v in A.LAUNCHES.items()}
            if per_frame.get("flash_fwd_lse") != 2:
                bad.append(f"masklet launched {dict(A.LAUNCHES)}")
        tracks[d] = (streams, evaluate_tracking_suite(
            pb, pi, ps, gb, gi, pred_masks=pm, gt_masks=gm))
    for so_cpu, so_card in zip(tracks["cpu"][0], tracks["cuda"][0]):
        for a, b in zip(so_cpu, so_card):
            oa, ob = a["outputs"], b["outputs"]
            slots += oa["obj_id"].size
            ids_differ += int((oa["obj_id"] != ob["obj_id"]).sum()
                              + (oa["active"] != ob["active"]).sum())
            compare("masklet", ob["mask_logits_lowres"],
                    oa["mask_logits_lowres"])
            px.append(float((oa["mask"] != ob["mask"]).mean()))
    keys = ("HOTA", "DetA", "AssA", "MOTA", "TETA", "cgF1", "mask_AP")
    suite = {d: {k: tracks[d][1][k] for k in keys} for d in tracks}
    metric_diff = max(abs(suite["cuda"][k] - suite["cpu"][k]) for k in keys)
    if ids_differ > VOS_REF_LIMITS["ids"]:
        bad.append(f"masklet ids/active differ on {ids_differ} of {slots} "
                   f"(frame, slot) entries")
    if not metric_diff <= VOS_REF_LIMITS["metrics"]:
        bad.append(f"suite metrics differ by {metric_diff}")
    say("vos_ref_masklet", fill_holes=True, frames=n,
        launches_per_frame=json.dumps(per_frame).replace(" ", ""),
        card=json.dumps({k: round(v, 6) for k, v in suite["cuda"].items()}
                        ).replace(" ", ""),
        cpu=json.dumps({k: round(v, 6) for k, v in suite["cpu"].items()}
                       ).replace(" ", ""),
        skix_floors_not_held=json.dumps(VOS_HOTA_FLOORS).replace(" ", ""),
        ids_differ=ids_differ, metric_max_diff=metric_diff)

    # 3. the interactive predictor: two masks at frame 0, forward; a second
    # mask of object 1 at frame 6, reverse
    fr, _, mk, _ = mtf.synth_clip(VOS_PROP_SEED, T=12, n_obj=2, min_sep=1.5)
    u8 = (fr * 255).astype(np.uint8)
    runs, chosen = {}, {}
    for d in ("cpu", "cuda"):
        pred = InteractiveVideoPredictor(models[d][1])
        st = pred.init_state(u8)
        reset_counts()
        for obj in (1, 2):
            pred.add_new_mask(st, 0, obj, mk[0, obj - 1])
        outs = list(pred.propagate_in_video(st))
        pred.add_new_mask(st, 6, 1, mk[6, 0])
        outs += list(pred.propagate_in_video(st, reverse=True))
        runs[d], chosen[d] = outs, st["last_cond_selected"]
        if d == "cuda" and sum(A.LAUNCHES.values()):
            bad.append(f"the predictor's slot scan launched "
                       f"{dict(A.LAUNCHES)}")
    for a, b in zip(runs["cpu"], runs["cuda"]):
        if a["obj_ids"] != b["obj_ids"] or a["frame_index"] != b[
                "frame_index"]:
            bad.append("the predictor's frames or ids differ")
        compare("predictor", b["logits"], a["logits"])
        px.append(float((a["masks"] != b["masks"]).mean()))
    if chosen["cpu"] != chosen["cuda"]:
        bad.append(f"conditioning frames differ: {chosen}")
    worst_by = {k: max(v) for k, v in errs.items()}
    worst, worst_px = max(worst_by.values()), max(px)
    if not worst <= VOS_REF_LIMITS["logits"]:
        bad.append(f"logits {worst} of scale apart")
    if not worst_px <= VOS_REF_LIMITS["mask_pixels"]:
        bad.append(f"{worst_px} of mask pixels differ")
    say("vos_ref", frames_predicted=len(runs["cuda"]),
        logits_max_scaled_err=worst, by_part=json.dumps(worst_by).replace(
            " ", ""), mask_pixels_differ=worst_px,
        limits=json.dumps(VOS_REF_LIMITS).replace(" ", ""),
        s=round(time.perf_counter() - t0, 1))
    if bad:
        fail("vos_ref: " + "; ".join(bad))


def vos_phase():
    """The VOS path at full width, each step's time and peak device memory,
    propagate_objects warm and once profiled (device time by kernel from the
    raw records, the idle share); returns propagate_objects' launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skix_torch.metrics.suite import evaluate_tracking_suite
    from skix_torch.ops import attention as A
    from skix_torch.ops.masks import fill_holes_in_mask_scores, masks_to_boxes
    from skix_torch.tracking.memory_tracker import (MaskMemoryTracker,
                                                    propagate_objects)
    from skix_torch.tracking.point_sampling import get_next_point
    from skix_torch.tracking.vos_predictor import InteractiveVideoPredictor
    from skix_torch.utils.image import resize

    t0 = time.perf_counter()
    mtf = tracker_world()
    mtf.set_world_size(VOS_HW)
    mtf.MAXG = VOS_OBJECTS              # the world's ground-truth slots
    frames, _, masks, valid = mtf.synth_clip(41_000, T=VOS_T,
                                             n_obj=VOS_OBJECTS, min_sep=1.5)
    synth_s = time.perf_counter() - t0
    trk = MaskMemoryTracker().init_weights(
        torch.Generator().manual_seed(0)).to("cuda").eval()
    dev = torch.device("cuda")
    first = masks[0, :VOS_OBJECTS]
    propagate_objects(trk, frames[:2], first)          # warm-up
    torch.cuda.synchronize()

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, (time.perf_counter() - t) * 1e3,
                (torch.cuda.max_memory_allocated() - base) / 2 ** 20)

    # propagate_objects: 4 objects × 24 frames
    reset_counts()
    (logits, scores), prop_ms, prop_mib = timed(
        lambda: propagate_objects(trk, frames, first))
    launches = dict(A.LAUNCHES), dict(A.LAUNCHES_BY_STYLE)
    shapes = dict(A.LAUNCHES_BY_SHAPE)
    want = {f"flash_fwd_lse/{VOS_OBJECTS}x1x{(VOS_HW // 8) ** 2}x64":
            2 * VOS_T}
    if shapes != want:
        fail(f"vos: propagate_objects launched {shapes}, not {want}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        propagate_objects(trk, frames, first)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t) * 1e3
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    k1 = sum(e.self_device_time_total for e in kernels
             if "flash_fwd_kernel" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    say("vos_propagate", objects=VOS_OBJECTS, frames=VOS_T,
        grid=VOS_HW // 8, ms_per_frame=round(prop_ms / VOS_T, 3),
        peak_mib=round(prop_mib, 1),
        launches=json.dumps(shapes).replace(" ", ""),
        profiled_ms_per_frame=round(prof_ms / VOS_T, 3),
        device_busy_ms=round(busy, 2),
        device_idle_share=round(1.0 - busy / prof_ms, 4),
        k1_lse_ms=round(k1, 2), k1_lse_share_of_busy=round(k1 / busy, 4),
        top=json.dumps([[e.key[:50], round(e.self_device_time_total / 1e3,
                                           2), e.count] for e in top]
                       ).replace(" ", ""))

    # the interactive predictor: 2 objects × 16 frames, forward, then a mask
    # of object 1 on the last frame and the reverse pass
    u8 = (frames[:VOS_PRED_T] * 255).astype(np.uint8)
    pred = InteractiveVideoPredictor(trk, max_cond_frames=2, num_recent=2)

    def run_predictor():
        st = pred.init_state(u8)
        for obj in range(VOS_PRED_OBJECTS):
            pred.add_new_mask(st, 0, obj, masks[0, obj])
        n = len(list(pred.propagate_in_video(st)))
        pred.add_new_mask(st, VOS_PRED_T - 1, 0, masks[VOS_PRED_T - 1, 0])
        return n + len(list(pred.propagate_in_video(st, reverse=True)))
    reset_counts()
    n_pred, pred_ms, pred_mib = timed(run_predictor)
    if sum(A.LAUNCHES.values()):
        fail(f"vos: the predictor's slot scan launched {dict(A.LAUNCHES)}")
    say("vos_predictor", objects=VOS_PRED_OBJECTS, frames=n_pred,
        ms_per_frame=round(pred_ms / n_pred, 3), peak_mib=round(pred_mib, 1),
        launches=0)

    # the hole fill on the 4 × 24 grid masks
    grid = torch.as_tensor(logits, device=dev).reshape(
        -1, *logits.shape[-2:])
    filled, fill_ms, fill_mib = timed(
        lambda: fill_holes_in_mask_scores(grid, 16))
    changed = int((filled != grid).sum())
    # the EDT click on 4 masks at 1008²
    gt = torch.as_tensor(masks[-1, :VOS_OBJECTS], device=dev)[:, None]
    up = resize(torch.as_tensor(logits[-1], device=dev),
                (VOS_OBJECTS, VOS_HW, VOS_HW), "bilinear")[:, None] > 0
    (pts, labels), edt_ms, edt_mib = timed(
        lambda: get_next_point(gt, up, "center"))
    # the suite over the 4 × 24 outputs against the world's ground truth
    t = time.perf_counter()
    pb, pi, ps, pm = [], [], [], []
    sig = 1 / (1 + np.exp(-scores))
    for f in range(VOS_T):
        m = resize(torch.as_tensor(logits[f], device=dev),
                   (VOS_OBJECTS, VOS_HW, VOS_HW), "bilinear") > 0
        keep = m.reshape(VOS_OBJECTS, -1).any(1).cpu().numpy()
        pb.append(masks_to_boxes(m).cpu().numpy()[keep])
        pm.append(m.cpu().numpy()[keep])
        pi.append(np.arange(VOS_OBJECTS)[keep])
        ps.append(sig[f][keep])
    gb, gi, gm = _gt_tracks(masks, valid)
    suite = evaluate_tracking_suite(pb, pi, ps, gb, gi, pred_masks=pm,
                                    gt_masks=gm)
    suite_ms = (time.perf_counter() - t) * 1e3
    if not all(np.isfinite(v) for k, v in suite.items() if k != "mask_AP"):
        fail(f"vos: non-finite suite metrics {suite}")
    say("vos_tools", fill_holes_ms=round(fill_ms, 3),
        fill_holes_peak_mib=round(fill_mib, 1), fill_changed_px=changed,
        edt_center_ms=round(edt_ms, 3), edt_peak_mib=round(edt_mib, 1),
        edt_points=json.dumps(pts[:, 0].tolist()).replace(" ", ""),
        suite_ms=round(suite_ms, 1), suite=json.dumps(
            {k: round(float(v), 4) for k, v in suite.items()}).replace(
            " ", ""), synth_s=round(synth_s, 1),
        s=round(time.perf_counter() - t0, 1))
    return launches


# prompts: point and box prompts. prompts_ref holds the card to the CPU on
# the trained 224 px fixture (tests/fixtures/tracker_tiny224.npz) with a
# geometry branch grafted from a seeded generator, at the CPU twins' items
# (tests/test_torch_{sam_interactive,geometry_prompts,session_prompts}.py);
# prompts runs them at full width: Sam3Processor on the full-size detector
# (1008 px, f32, 8 point and 4 box slots) over 4 frames of 1080p with text,
# +box, +point, +negative point; the video session (the full-size detector
# and the default tracker) through handle_request / handle_stream_request
# on 16 frames of 1080p, a normalized box on frame 0 and clicks on frame
# 8, both ways from frame 8; the VOS predictor with the reference SAM
# decoder width (256 features, 8 heads, MLP 2048, depth 2) on the ViT-Det
# trunk (1024 × 32) at 1008 px, a box and a correction click, then 16
# frames at 1008 px
PROMPTS_REF_LIMITS = {"logits": 1e-4, "mask_pixels": 1e-3, "ids": 0}
PROMPTS_HW, PROMPTS_FRAMES, PROMPTS_SESSION_T = (1080, 1920), 4, 16
PROMPTS_VOS_HW, PROMPTS_VOS_T = 1008, 16
PROMPTS_KEPT = 8          # the fewest queries a processor prompt keeps
# launches of one full-size detector forward (trunk windows and global
# blocks, fusion encoder) and of one ViT-Det segmenter encode; the session's
# tracker adds its dense memory attention, 2 a frame
PROMPTS_PER_FORWARD = {"flash_fwd_single_tile": 28, "flash_fwd": 4 + 6}
PROMPTS_PER_ENCODE = {"flash_fwd_single_tile": 28, "flash_fwd": 4}
PROMPTS_SESSION_PER_FRAME = {**PROMPTS_PER_FORWARD, "flash_fwd_lse": 2}


def _prompt_slots(rng, B: int = 1, Np: int = 8, Nb: int = 4):
    """Random point and box slots as the detector's keywords, some slots
    invalid, labels −1..2 (clipped to 0/1 by the encoder)."""
    import numpy as np

    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, Nb, 2)),
                            rng.uniform(0.1, 0.6, (B, Nb, 2))], -1)
    return {"points": rng.random((B, Np, 2)).astype(np.float32),
            "point_labels": rng.integers(-1, 3, (B, Np)).astype(np.int32),
            "point_valid": rng.random((B, Np)) < 0.6,
            "boxes": boxes.astype(np.float32),
            "box_labels": rng.integers(0, 2, (B, Nb)).astype(np.int32),
            "box_valid": rng.random((B, Nb)) < 0.6}


def _selected(out):
    """Per image, the index of the decoder's returned mask among its four."""
    import torch

    return [int(torch.nonzero((ms == s).all(-1).all(-1))[0])
            for s, ms in zip(out.mask_logits, out.all_mask_logits)]


def prompts_reference_phase():
    """Every item of the CPU twins on the card against the CPU, small: the
    samplers at the border, the geometry encoder, the fixture detector
    with text ‖ geometry, geometry only and every slot invalid, the
    processor's sequence, the prompt encoder and decoder (the stability
    fallback on both sides), the image predictor, the masklet session both
    ways through the request protocol, geometry alone, the box session,
    track_masklets and the VOS predictor's clicks and box."""
    import copy

    import numpy as np
    import torch

    from skix_torch.ops import attention as A
    from skix_torch.tracking import sam3_detector as SD
    from skix_torch.tracking.fixture import (fixture_prompt,
                                             load_tracker_fixture)
    from skix_torch.tracking.image_processor import Sam3Processor
    from skix_torch.tracking.masklet import MaskletConfig, track_masklets
    from skix_torch.tracking.sam_decoder import SamMaskDecoder
    from skix_torch.tracking.sam_prompt_encoder import (InteractiveSegmenter,
                                                        SamImagePredictor)
    from skix_torch.tracking.session import VideoPredictor
    from skix_torch.tracking.vos_predictor import InteractiveVideoPredictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mtf = tracker_world()
    mtf.set_world_size(224)
    det, trk = load_tracker_fixture(VOS_FIXTURE, device="cpu")
    det.geometry_encoder = det.make_geometry_encoder(
        torch.Generator().manual_seed(17))
    seg = InteractiveSegmenter(features=32, img_size=224, num_heads=2)
    seg.init_weights(torch.Generator().manual_seed(18))
    dec = SamMaskDecoder(32, 2, mlp_dim=64, iou_hidden_dim=32, high_res=True
                         ).init_weights(torch.Generator().manual_seed(19))
    models = {"cpu": [m.eval() for m in (det, trk, seg, dec)]}
    models["cuda"] = [copy.deepcopy(m).to("cuda") for m in models["cpu"]]
    bad, errs, px = [], {}, []
    ids_differ = sel_differ = 0
    reset_counts()

    def compare(part, card, cpu, masks=False):
        card = card.cpu() if hasattr(card, "cpu") else card
        cpu = cpu.cpu() if hasattr(cpu, "cpu") else cpu
        if masks:
            px.append(float(np.mean(np.asarray(card) != np.asarray(cpu))))
        else:
            errs[part] = max(errs.get(part, 0.0), scaled_err(card, cpu))

    def both(fn):
        """``fn(device, models)`` on the CPU and on the card, no grad."""
        with torch.no_grad():
            return [fn(d, models[d]) for d in ("cpu", "cuda")]

    def t(x, d):
        return torch.as_tensor(x, device=d)

    # 1. samplers at the border, the geometry encoder, the detector
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(6, 8, 5)).astype(np.float32)
    pts = np.array([[0, 0], [1, 1], [0, 1], [1, 0], [1.3, -0.2],
                    [-0.1, 1.1], [0.999, 0.001]], np.float32)
    boxes = np.array([[0.05, 0.05, 0.2, 0.3], [0.95, 0.9, 0.3, 0.4],
                      [0.5, 0.5, 1.2, 1.2]], np.float32)
    for name, fn, arg in (("bilinear_sample", SD.bilinear_sample, pts),
                          ("box_grid_sample", SD.box_grid_sample, boxes)):
        cpu, card = both(lambda d, _: fn(t(feat, d), t(arg, d)))
        compare(name, card, cpu)
    slots = _prompt_slots(rng)
    gfeat = rng.normal(size=(1, 16, 16, 64)).astype(np.float32)
    for case in ("some_invalid", "all_invalid"):
        if case == "all_invalid":
            slots["point_valid"][:] = slots["box_valid"][:] = False
        cpu, card = both(lambda d, m: m[0].geometry_encoder(
            t(gfeat, d), *(t(v, d) for v in slots.values())))
        compare("geometry_encoder", card[0], cpu[0])
        if not torch.equal(card[1].cpu(), cpu[1]):
            bad.append(f"geometry pads differ ({case})")
    frame = mtf.synth_scene(7, n_obj=2)[0][None]
    text = fixture_prompt(device="cpu").numpy()[None]
    for case in ("text_geometry", "geometry_only", "all_invalid"):
        slots = _prompt_slots(rng)
        if case == "all_invalid":
            slots["point_valid"][:] = slots["box_valid"][:] = False
        cpu, card = both(lambda d, m: m[0](
            t(frame, d), None if case == "geometry_only" else t(text, d),
            **{k: t(v, d) for k, v in slots.items()}))
        for field in ("boxes_cxcywh", "scores", "mask_logits", "presence"):
            compare("detector", getattr(card, field), getattr(cpu, field))

    # 2. Sam3Processor: text → box → point → negative point → threshold →
    # reset → a box alone ("visual"); keep sets equal
    image = (np.pad(frame[0], ((0, 0), (0, 96), (0, 0))) * 255).astype(
        np.uint8)
    procs = {d: Sam3Processor(models[d][0], confidence_threshold=0.3)
             for d in ("cpu", "cuda")}
    states = {d: p.set_image(image) for d, p in procs.items()}
    steps = [lambda p, s: p.set_text_prompt("person", s),
             lambda p, s: p.add_geometric_prompt([0.4, 0.5, 0.3, 0.4], True,
                                                 s),
             lambda p, s: p.add_point_prompt([0.3, 0.6], True, s),
             lambda p, s: p.add_point_prompt([0.8, 0.2], False, s),
             lambda p, s: p.set_confidence_threshold(0.35, s),
             lambda p, s: p.add_geometric_prompt(
                 [0.5, 0.5, 0.3, 0.3], True, p.reset_all_prompts(s))]
    keep_differ = 0
    for step in steps:
        cpu, card = (step(procs[d], states[d]) for d in ("cpu", "cuda"))
        keep_differ += int(len(cpu["scores"]) != len(card["scores"])
                           or not np.array_equal(
                               cpu["all_scores"] >= procs["cpu"]
                               .confidence_threshold,
                               card["all_scores"] >= procs["cuda"]
                               .confidence_threshold))
        for k in ("all_scores", "all_boxes_xyxy", "masks_lowres", "presence"):
            compare("processor", card[k], cpu[k])
    if keep_differ:
        bad.append(f"the processor's keep sets differ in {keep_differ} steps")

    # 3. the prompt encoder, the decoder's four cases, the image predictor
    for case in ("multimask", "stable", "unstable", "high_res"):
        rng = np.random.default_rng(6)
        emb, pe = (rng.normal(size=s).astype(np.float32)
                   for s in ((2, 8, 8, 32), (1, 8, 8, 32)))
        prompt = rng.normal(size=(2, 3, 32)).astype(np.float32)
        f4 = rng.normal(size=(2, 32, 32, 32)).astype(np.float32)
        f2 = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)

        def run(d, m):
            dm = copy.deepcopy(m[3])
            if case == "stable":
                dm.upscale2.bias.add_(6.0)
                dm.hyper_0.fc2.bias.fill_(1.0)
            if case == "unstable":
                dm.hyper_0.fc2.weight.zero_()
                dm.hyper_0.fc2.bias.zero_()
            return dm(t(emb, d), t(pe, d), t(prompt, d), case == "multimask",
                      (t(f4, d), t(f2, d)) if case == "high_res" else None)
        cpu, card = both(run)
        for field in cpu._fields:
            compare("decoder", getattr(card, field), getattr(cpu, field))
        sel = _selected(cpu)
        sel_differ += int(_selected(card) != sel)
        if (case == "stable") != (sel == [0, 0]):
            bad.append(f"decoder case {case} selected {sel}")
    image = (rng.random((150, 200, 3)) * 255).astype(np.uint8)
    preds = {d: SamImagePredictor(models[d][2]) for d in ("cpu", "cuda")}
    for p in preds.values():
        p.set_image(image)
    for args, kw in ((([[30, 20], [80, 40]], [1, 0]), {}),
                     ((None, None, [10, 5, 150, 120]), {}),
                     (([[60, 50]], [1], [10, 5, 150, 120]), {}),
                     (([[60, 50]], [1]), {"multimask_output": False})):
        cpu, card = (preds[d].predict(*args, **kw) for d in ("cpu", "cuda"))
        compare("image_predictor", card[2], cpu[2])
        compare("image_predictor", card[1], cpu[1])
        compare("image_predictor", card[0], cpu[0], masks=True)

    # 4. the masklet session through the request protocol, both ways;
    # geometry alone; the box session; track_masklets
    frames, gt_boxes, gt_masks, gt_valid = mtf.synth_clip(
        20_001, T=6, n_obj=2, min_sep=1.5)
    u8 = (frames * 255).astype(np.uint8)
    cx, cy, w, h = gt_boxes[0, 0]
    px1 = (gt_boxes[1, 1, :2] * 224).tolist()
    cfg = MaskletConfig(**VOS_MASKLET_CFG)
    streams = {}
    for d in ("cpu", "cuda"):
        pred = VideoPredictor(models[d][0], models[d][1], cfg,
                              smoke_prompts=True, batch_size=2)
        sid = pred.handle_request({"type": "start_session",
                                   "frames": u8})["session_id"]
        pred.handle_request({"type": "add_prompt", "session_id": sid,
                             "text": "person", "frame_index": 0,
                             "bounding_boxes": [[cx - w / 2, cy - h / 2, w,
                                                 h]],
                             "bounding_box_labels": [1]})
        pred.handle_request({"type": "add_prompt", "session_id": sid,
                             "frame_index": 1, "points": [px1, [5.0, 5.0]],
                             "point_labels": [1, 0]})
        outs = list(pred.handle_stream_request({
            "type": "propagate_in_video", "session_id": sid,
            "start_frame_index": 1}))
        pred.handle_request({"type": "reset_session", "session_id": sid})
        pred.add_prompt(sid, frame_idx=1, points=[px1])
        outs += list(pred.handle_stream_request({
            "type": "propagate_in_video", "session_id": sid,
            "start_frame_index": 1, "max_frame_num_to_track": 2,
            "propagation_direction": "forward"}))
        boxes_pred = VideoPredictor(models[d][0], None, smoke_prompts=True,
                                    batch_size=2)
        sid = boxes_pred.start_session(u8[:3])
        boxes_pred.add_prompt(sid, "person", frame_idx=1,
                              boxes_xyxy=[[40, 40, 120, 140]])
        streams[d] = outs, list(boxes_pred.propagate_in_video(sid))
    for part, i in (("session", 0), ("box_session", 1)):
        cpu_s, card_s = streams["cpu"][i], streams["cuda"][i]
        if [o["frame_index"] for o in cpu_s] != [o["frame_index"]
                                                 for o in card_s]:
            bad.append(f"{part}: frames differ")
        for a, b in zip(cpu_s, card_s):
            oa, ob = a["outputs"], b["outputs"]
            ids_differ += int((oa["obj_id"] != ob["obj_id"]).sum()
                              + (oa["active"] != ob["active"]).sum())
            for k, v in oa.items():
                if k == "mask":
                    compare(part, ob[k], v, masks=True)
                elif v.dtype.kind == "f":
                    compare(part, ob[k], v)
    if [o["frame_index"] for o in streams["cuda"][0]] != [
            1, 2, 3, 4, 5, 1, 0, 1, 2]:
        bad.append("the session's frames are not [1..5, 1, 0, 1, 2]")
    rng = np.random.default_rng(0)
    grid = np.stack([mtf.jax_resize(m, 28, 28) for m in
                     gt_masks[:, :2].reshape(-1, 224, 224)]).reshape(
        6, 2, 28, 28)
    logits = (np.where(grid, 8.0, -8.0)
              + rng.normal(0, 2, grid.shape)).astype(np.float32)
    scores = rng.uniform(0.5, 0.9, (6, 2)).astype(np.float32)
    valid = gt_valid[:, :2].copy()
    valid[2, 0] = False
    kw = dict(VOS_MASKLET_CFG, max_dets=2, hotstart_delay=2)
    cpu, card = (track_masklets(t(logits, d), t(scores, d), t(valid, d),
                                MaskletConfig(**kw)) for d in ("cpu", "cuda"))
    for k, v in cpu.items():
        if v.is_floating_point():
            compare("track_masklets", card[k], v)
        elif not torch.equal(card[k].cpu(), v):
            bad.append(f"track_masklets {k} differs")

    # 5. the VOS predictor's box, correction click, relative click, a mask
    # then a click, forward and reverse
    calls = [
        lambda p, s: p.add_new_points_or_box(s, 0, 1, box=[40, 48, 140,
                                                           160]),
        lambda p, s: p.add_new_points_or_box(s, 0, 1, points=[[80.0, 100.0]],
                                             labels=[1],
                                             clear_old_points=False),
        lambda p, s: p.add_new_points_or_box(s, 0, 2, points=[[0.5, 0.25]],
                                             labels=[1],
                                             rel_coordinates=True),
        lambda p, s: p.add_new_mask(s, 2, 3, gt_masks[2, 0]),
        lambda p, s: p.add_new_points_or_box(s, 2, 3, points=[[60.0, 60.0]],
                                             labels=[0],
                                             clear_old_points=False)]
    vos = {}
    for d in ("cpu", "cuda"):
        p = InteractiveVideoPredictor(models[d][1], models[d][2])
        s = p.init_state(u8)
        grids = [call(p, s) for call in calls]
        outs = list(p.propagate_in_video(s))
        outs += list(p.propagate_in_video(s, reverse=True,
                                          max_frame_num_to_track=2))
        vos[d] = grids, outs
    for a, b in zip(vos["cpu"][0], vos["cuda"][0]):
        compare("vos_prompts", b, a)
    for a, b in zip(vos["cpu"][1], vos["cuda"][1]):
        if a["obj_ids"] != b["obj_ids"] or a["frame_index"] != b[
                "frame_index"]:
            bad.append("the VOS predictor's frames or ids differ")
        compare("vos_propagate", b["logits"], a["logits"])
        compare("vos_propagate", b["masks"], a["masks"], masks=True)

    card_launches = dict(A.LAUNCHES)
    worst, worst_px = max(errs.values()), max(px)
    if not worst <= PROMPTS_REF_LIMITS["logits"]:
        bad.append(f"outputs {worst} of scale apart")
    if not worst_px <= PROMPTS_REF_LIMITS["mask_pixels"]:
        bad.append(f"{worst_px} of mask pixels differ")
    if ids_differ > PROMPTS_REF_LIMITS["ids"] or sel_differ:
        bad.append(f"ids/active differ on {ids_differ} entries, the "
                   f"decoder's selection in {sel_differ} cases")
    if not card_launches.get("flash_fwd") or not card_launches.get(
            "flash_fwd_lse"):
        bad.append(f"the card's runs launched {card_launches}")
    say("prompts_ref", max_scaled_err=worst, by_part=json.dumps(
        {k: float(f"{v:.3g}") for k, v in errs.items()}).replace(" ", ""),
        mask_pixels_differ=worst_px, ids_differ=ids_differ,
        selection_differs=sel_differ, keep_sets_differ=keep_differ,
        card_launches=json.dumps(card_launches).replace(" ", ""),
        limits=json.dumps(PROMPTS_REF_LIMITS).replace(" ", ""),
        s=round(time.perf_counter() - t0, 1))
    if bad:
        fail("prompts_ref: " + "; ".join(bad))


def _profiled(fn):
    """``fn()`` once under torch.profiler: (wall ms, device busy ms, idle
    share, the top kernels by device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return ms, busy, 1.0 - busy / ms, json.dumps(
        [[e.key[:50], round(e.self_device_time_total / 1e3, 2), e.count]
         for e in top]).replace(" ", "")


def prompts_phase():
    """The prompt paths at full width, each with its launches counted from
    0 and held to PROMPTS_PER_*, its time and peak device memory; one
    processor frame, two session frames and two VOS frames profiled.
    Returns the three paths' launches, summed."""
    import numpy as np
    import torch

    from skix_torch.ops import attention as A
    from skix_torch.tracking.image_processor import Sam3Processor
    from skix_torch.tracking.memory_tracker import MaskMemoryTracker
    from skix_torch.tracking.sam3_detector import Sam3Detector
    from skix_torch.tracking.sam_prompt_encoder import InteractiveSegmenter
    from skix_torch.tracking.session import VideoPredictor
    from skix_torch.tracking.vos_predictor import InteractiveVideoPredictor

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device("meta"):
        det = Sam3Detector.full_size(geometry=True)
        seg = InteractiveSegmenter(features=256, trunk="vitdet",
                                   img_size=PROMPTS_VOS_HW, num_heads=8)
    det = det.to_empty(device=dev).init_weights(gen).eval()
    seg = seg.to_empty(device=dev).init_weights(gen).eval()
    trk = MaskMemoryTracker().init_weights(
        torch.Generator().manual_seed(1)).to(dev).eval()
    rng = np.random.default_rng(5)
    frames = shifted_frames(rng, max(PROMPTS_FRAMES, PROMPTS_SESSION_T),
                            PROMPTS_HW)
    total, by_style, fields = {}, {}, {}

    def counted(name, fn, expected):
        """``fn()`` with the launch counts from 0, timed, peak memory."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = dict(A.LAUNCHES)
        if launches != expected:
            fail(f"prompts: {name} launched {launches}, expected {expected}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        for k, v in A.LAUNCHES_BY_STYLE.items():
            by_style[k] = by_style.get(k, 0) + v
        fields[f"{name}_peak_mib"] = round(
            (torch.cuda.max_memory_allocated() - base) / 2 ** 20, 1)
        return out, ms

    # Sam3Processor: 4 frames × (text, +box, +point, +negative point). Each
    # prompt runs at the threshold that kept PROMPTS_KEPT queries of it in
    # the warm-up, which runs the same prompts: seeded weights put every
    # score far below the default 0.5, and the scores' spread from prompt
    # to prompt is wide
    proc = Sam3Processor(det)
    steps = [lambda s: proc.set_text_prompt("person", s),
             lambda s: proc.add_geometric_prompt([0.45, 0.5, 0.2, 0.6], True,
                                                 s),
             lambda s: proc.add_point_prompt([0.45, 0.4], True, s),
             lambda s: proc.add_point_prompt([0.1, 0.1], False, s)]
    thresholds = []
    for f in frames[:PROMPTS_FRAMES]:
        state = proc.set_image(f)
        thresholds += [float(np.sort(step(state)["all_scores"])[-PROMPTS_KEPT])
                       for step in steps]
    prompt_ms, kept = [], []

    def run_processor():
        for i, f in enumerate(frames[:PROMPTS_FRAMES]):
            state = proc.set_image(f)
            for j, step in enumerate(steps):
                proc.set_confidence_threshold(thresholds[i * len(steps) + j])
                t = time.perf_counter()
                out = step(state)          # host copies: synchronized
                prompt_ms.append((time.perf_counter() - t) * 1e3)
                kept.append(len(out["scores"]))
                masks = out["masks_lowres"]
                if (out["all_scores"].shape != (det.num_queries,)
                        or not np.isfinite(out["all_scores"]).all()
                        or masks.shape[0] != kept[-1] or masks.ndim != 3
                        or not np.isfinite(masks).all()):
                    fail("prompts: the processor's outputs are not finite "
                         f"({det.num_queries},) scores and (kept, h, w) "
                         f"masks: {masks.shape}")
                if not kept[-1]:
                    fail("prompts: a processor prompt kept no query")
        return out
    n = PROMPTS_FRAMES * len(steps)
    out, proc_ms = counted("processor", run_processor, {
        k: n * v for k, v in PROMPTS_PER_FORWARD.items()})
    state = proc.set_image(frames[0])

    def first_frame():
        for j, step in enumerate(steps):
            proc.set_confidence_threshold(thresholds[j])
            step(state)
    prof = _profiled(first_frame)
    say("prompts_processor", frames=PROMPTS_FRAMES, prompts=n,
        ms_per_prompt=round(float(np.mean(prompt_ms)), 3),
        median_ms_per_prompt=round(float(np.median(prompt_ms)), 3),
        wall_ms=round(proc_ms, 1),
        thresholds=[round(min(thresholds), 4), round(max(thresholds), 4)],
        kept_mean=float(np.mean(kept)), kept_min=min(kept),
        kept_max=max(kept), mask_hw=list(out["masks_lowres"].shape[1:]),
        peak_mib=fields["processor_peak_mib"],
        profiled_ms_per_prompt=round(prof[0] / len(steps), 3),
        device_busy_ms=round(prof[1], 2), device_idle_share=round(prof[2], 4),
        top=prof[3])

    # the session: 16 frames of 1080p, a normalized box on frame 0 and
    # clicks on frame 8, both ways from frame 8
    pred = VideoPredictor(det, trk, smoke_prompts=True)
    sid = pred.handle_request({"type": "start_session",
                               "frames": frames[:PROMPTS_SESSION_T]}
                              )["session_id"]
    pred.handle_request({"type": "add_prompt", "session_id": sid,
                         "text": "person", "frame_index": 0,
                         "bounding_boxes": [[0.35, 0.2, 0.2, 0.6]],
                         "bounding_box_labels": [1]})
    pred.handle_request({"type": "add_prompt", "session_id": sid,
                         "frame_index": 8, "points": [[870.0, 560.0],
                                                      [100.0, 100.0]],
                         "point_labels": [1, 0]})
    stream = {"type": "propagate_in_video", "session_id": sid,
              "start_frame_index": 8}
    two = {**stream, "max_frame_num_to_track": 2,
           "propagation_direction": "forward"}
    list(pred.handle_stream_request(two))                # warm-up

    def run_session():
        order, active = [], 0
        for item in pred.handle_stream_request(stream):
            o = item["outputs"]
            if (o["mask"].shape != (16, *PROMPTS_HW)
                    or not np.isfinite(o["bbox"]).all()):
                fail(f"prompts: session outputs {o['mask'].shape}")
            order.append(item["frame_index"])
            active += int(o["active"].sum())
        return order, active
    n = len(range(8, PROMPTS_SESSION_T)) + len(range(8, -1, -1))
    (order, active), session_ms = counted("session", run_session, {
        k: n * v for k, v in PROMPTS_SESSION_PER_FRAME.items()})
    if order != list(range(8, 16)) + list(range(8, -1, -1)):
        fail(f"prompts: the session yielded frames {order}")
    prof = _profiled(lambda: list(pred.handle_stream_request(two)))
    say("prompts_session", frames=n, ms_per_frame=round(session_ms / n, 3),
        active_slot_frames=active, peak_mib=fields["session_peak_mib"],
        profiled_ms_per_frame=round(prof[0] / 2, 3),
        device_busy_ms=round(prof[1], 2), device_idle_share=round(prof[2], 4),
        top=prof[3], stats=json.dumps(pred.session_stats(sid)).replace(
            " ", ""))
    del pred, proc
    gc.collect()
    torch.cuda.empty_cache()

    # the VOS predictor with the full-width segmenter: a box and a
    # correction click on frame 0, then 16 frames forward
    u8 = shifted_frames(rng, PROMPTS_VOS_T, (PROMPTS_VOS_HW,) * 2)
    vos = InteractiveVideoPredictor(trk, seg)
    warm = vos.init_state(u8[:2])
    vos.add_new_points_or_box(warm, 1, 0, box=[300, 200, 700, 900])

    def run_vos():
        st = vos.init_state(u8)
        vos.add_new_points_or_box(st, 0, 1, box=[300, 200, 700, 900])
        vos.add_new_points_or_box(st, 0, 1, points=[[500.0, 550.0]],
                                  labels=[1], clear_old_points=False)
        outs = list(vos.propagate_in_video(st))
        if len(outs) != PROMPTS_VOS_T or outs[-1]["masks"].shape != (
                1, PROMPTS_VOS_HW, PROMPTS_VOS_HW):
            fail("prompts: the VOS predictor's outputs are malformed")
        return st
    st, vos_ms = counted("vos", run_vos, dict(PROMPTS_PER_ENCODE))

    def two_vos_frames():
        st2 = vos.init_state(u8[:2])
        vos.add_new_points_or_box(st2, 0, 1, box=[300, 200, 700, 900])
        list(vos.propagate_in_video(st2))
    prof = _profiled(two_vos_frames)
    x = torch.zeros((1, PROMPTS_VOS_HW, PROMPTS_VOS_HW, 3), device=dev)
    feats = st["seg_feats"][0]
    pts = torch.tensor([[[300.0, 200.0], [700.0, 900.0], [500.0, 550.0]
                         ] + [[0.0, 0.0]] * 5], device=dev)
    labels = torch.tensor([[2, 3, 1] + [-1] * 5], device=dev)
    mask_in = torch.zeros((1, 4 * feats.shape[1], 4 * feats.shape[2], 1),
                          device=dev)
    with torch.no_grad():
        encode_ms = cuda_ms(lambda: seg.encode_image(x), 3)
        decode_ms = cuda_ms(lambda: seg.predict_from_embedding(
            feats, pts, labels, None, mask_in), 10)
    say("prompts_vos", frames=PROMPTS_VOS_T, hw=PROMPTS_VOS_HW,
        encode_ms=round(encode_ms, 3), decode_ms=round(decode_ms, 3),
        ms_per_frame=round(vos_ms / PROMPTS_VOS_T, 3),
        seg_grid=list(feats.shape[1:3]), peak_mib=fields["vos_peak_mib"],
        profiled_ms_two_frames=round(prof[0], 3),
        device_busy_ms=round(prof[1], 2), device_idle_share=round(prof[2], 4),
        top=prof[3],
        launches=json.dumps(PROMPTS_PER_ENCODE).replace(" ", ""),
        launches_total=json.dumps(total).replace(" ", ""),
        s=round(time.perf_counter() - t0, 1))
    del det, seg, trk, vos, st
    gc.collect()
    torch.cuda.empty_cache()
    return total, by_style


GROUPS = ("kernels", "vggt", "front", "chain", "side", "vggt_cli", "prep",
          "views", "image_edit", "train", "train_cli", "tools",
          "vos", "prompts")


def main() -> int:
    # ``--only a,b``: a partial run of these phase groups (GROUPS; "train"
    # needs "front", whose sam3 checkpoints it starts from; "train_cli",
    # "tools", "vos" and "prompts" need none) after the build,
    # with no kernels line and no verdict. Without arguments every group
    # runs, as the verdict needs.
    only = None
    if len(sys.argv) > 1:
        if len(sys.argv) != 3 or sys.argv[1] != "--only" or not set(
                sys.argv[2].split(",")) <= set(GROUPS):
            fail(f"usage: chip_smoke.py [--only {{{','.join(GROUPS)}}}[,...]]")
        only = set(sys.argv[2].split(","))

    def want(group: str) -> bool:
        return only is None or group in only

    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    # the full-size training step peaks at ~74 GiB of the card's 79.1 GiB
    # (phase train): expandable segments keep the blocks that the earlier
    # phases freed from fragmenting what it needs
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        import torch

        import skix_torch
        from skix_torch.ops import _build
    except ImportError as e:
        fail(f"cannot import the port beside this script: {e}")
    if Path(skix_torch.__file__).resolve().parent.parent != here:
        fail(f"skix_torch was imported from {skix_torch.__file__}, not from "
             f"beside this script")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a card")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(card, flush=True)
    say("device", kind=json.dumps(kind), count=count, torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. build
    build_phase(sorted({Path(src).stem for src, _ in KERNELS.values()}))

    # 3. kernels against plain, at the main paths' shapes
    rows, probe_rows = [], []
    if want("kernels"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = [check_kernel(c, gen) for c in kernel_cases()]
        torch.cuda.empty_cache()
        for c in backward_cases():
            rows += check_backward(c, gen)
            torch.cuda.empty_cache()
        # 3c. K2's probes B1-B7, each variant against its plain version
        probe_rows = window_probe_phase()

    with tempfile.TemporaryDirectory(prefix="skix_chip_smoke_") as tmpdir:
        tmp = Path(tmpdir)
        paths = {}      # main path → (launches, launches by rope style)
        # 4. small-input reference, 5. the VGGT main path, warm, profiled
        if want("vggt"):
            reference_phase(tmp)
            *paths["vggt"], cfg = main_phase(tmp)
            profile_phase(tmp, cfg)
        if want("front"):
            # 6. the front stage, tiny, card against CPU
            front_reference_phase(tmp)
            # 7. the front main path, warm, profiled
            *paths["front"], frames = front_phase(tmp)
            front_profile_phase(tmp, frames)
            # 7b. the same in the sam3 configuration: the interleaved rope
            # and the CLIP tower, tiny card against CPU, then at full size
            # from converted reference-layout checkpoints, warm, profiled
            from skix_torch.tracking.clip_tokenizer import PATTERN_MODULE

            say("clip", tokenizer_pattern_module=PATTERN_MODULE)
            front_reference_phase(tmp, sam3=True)
            det_ckpt, clip_ckpt = write_sam3_checkpoints(tmp)
            sam3 = {"front_detector": SAM3_DETECTOR,
                    "front_detector_checkpoint": str(det_ckpt),
                    "front_clip": {"checkpoint": str(clip_ckpt)}}
            *paths["front_sam3"], _ = front_phase(tmp, "front_sam3", sam3,
                                                  FRONT_SAM3_PER_FRAME)
            front_profile_phase(tmp, frames, "front_sam3", sam3)
            clip_ckpt.unlink()
            gc.collect()
            torch.cuda.empty_cache()
        if want("chain"):
            # 7c. run_all's default chain: small, card against CPU; then at
            # the full width, warm, profiled, and its pieces timed alone
            chain_reference_phase(tmp)
            paths["chain"] = chain_phase(tmp)
            gc.collect()
            torch.cuda.empty_cache()
        if want("side"):
            # 7d. the side-view stage: tiny, card against CPU; at the
            # published DINOv3 width with MoGe, warm, per pass, profiled;
            # run_all's side branch at its defaults
            side_reference_phase(tmp)
            paths["side"] = side_phase(tmp)
            paths["side_chain"] = side_chain_phase(tmp)
            gc.collect()
            torch.cuda.empty_cache()
        if want("vggt_cli"):
            # 7e. the vggt CLI's single and sfm modes: small, card against
            # CPU; at VGGT-1B width, warm, profiled; sfm's pieces and the
            # DINOv2 patch embed's forward
            vggt_reference_phase(tmp)
            paths["vggt_single"] = vggt_single_phase(tmp)
            paths["vggt_sfm"], paths["vggt_vit"] = vggt_sfm_phase(tmp)
            gc.collect()
            torch.cuda.empty_cache()
        if want("prep"):
            # 7f. prepare_dataset: tiny, card against CPU stage by stage
            # (and the mask slot); at the published widths on 2 × 64 frames
            # of 1080p, per task, profiled, and through run_all; the DPT at
            # Intel/dpt-large width
            prep_reference_phase(tmp)
            paths["prep"] = prep_phase(tmp)
            paths["dpt_large"] = dpt_large_phase(tmp)
            gc.collect()
            torch.cuda.empty_cache()
        if want("views"):
            # 7g. the view stages' options: the side stage's cascade
            # detector (tiny card against CPU, then ViTDet-H in the loop),
            # the compact front model (the config's keys, card against CPU,
            # then 64 frames of 720p), the tracker's ViT-Det trunk (tiny
            # card against CPU, then at full width with the overlay video),
            # front_side's 3D BEV render
            side_det_reference_phase(tmp)
            paths["side_det"] = side_det_phase(tmp)
            front_compact_reference_phase(tmp)
            paths["front_compact"] = front_compact_phase(tmp)
            trunk_reference_phase()
            paths["front_trunk"] = front_trunk_phase(tmp)
            paths["render3d"] = render3d_phase(tmp)
            gc.collect()
            torch.cuda.empty_cache()
        if want("image_edit"):
            # 7h. the image_edit CLI: tiny, card against CPU; at the
            # published widths (depth cut), warm, profiled
            image_edit_reference_phase(tmp)
            paths["image_edit"] = image_edit_phase(tmp)
        if want("train"):
            # 8. one training step, tiny, card against CPU
            train_reference_phase(tmp)
            # 9. the training main path at full size, profiled
            train_run, *paths["train"] = train_phase(tmp)
            train_profile_phase(tmp, train_run)
            del train_run
            # 9b. the same in the sam3 configuration (the first run's
            # model, optimizer and cached blocks freed first)
            train_reference_phase(tmp, sam3=True)
            train_run, *paths["train_sam3"] = train_phase(tmp, "train_sam3",
                                                          det_ckpt)
            del train_run
            gc.collect()
            torch.cuda.empty_cache()
        if want("train_cli"):
            # 9c. the training CLIs train_lifter and train_pose: small, card
            # against CPU; at the configs' widths, with checkpoints read
            # back and a resume
            lifter_train_reference_phase(tmp)
            paths["lifter_train"] = lifter_train_phase(tmp)
            pose_train_reference_phase(tmp)
            paths["pose_train"] = pose_train_phase(tmp)
        if want("tools"):
            # 9d. the post-run tools: card against CPU on seeded inputs;
            # then each at the size users run it
            tools_reference_phase(tmp)
            paths["tools"] = tools_phase(tmp)
        if want("vos"):
            # 9e. mask-prompted VOS and the tracking suite: the trained
            # fixture trackers card against CPU; then at full width
            vos_reference_phase()
            paths["vos"] = vos_phase()
        if want("prompts"):
            # 9f. point and box prompts: the CPU twins' items on the
            # trained fixture card against CPU; then at full width
            prompts_reference_phase()
            paths["prompts"] = prompts_phase()

    if only is not None:
        say("only", groups=",".join(sorted(only)),
            paths=json.dumps({p: l for p, (l, _) in paths.items()}).replace(
                " ", ""))
        print("chip_smoke: a partial run (--only): no kernels line, no "
              "verdict", flush=True)
        return 0

    # 10. kernels line: per kernel (K1 and K2 per mode) its launches on
    # each main path, and the times of its case at the path's largest
    # shape; under "modes", per rope style its launches and checks. Every
    # case checked above passed its tolerance
    headline = {"flash_fwd": "vggt_global", "flash_fwd_lse": "memory_tracker",
                "flash_fwd_single_tile": "vitdet_window",
                "flash_fwd_single_tile_lse": "vitdet_window_train",
                "flash_bwd_dkv": "vitdet_global",
                "flash_bwd_dq": "vitdet_global",
                "flash_bwd_single_tile": "vitdet_window"}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        h = next(r for r in mine if r["case"] == headline[name])
        by_path = {p: launches.get(name, 0)
                   for p, (launches, _) in paths.items()}
        modes = {}
        for style in ("none", "half", "interleaved", "segments"):
            checks = [r for r in mine if r["rope"] == style]
            n = sum(by_style.get(f"{name}/{style}", 0)
                    for _, by_style in paths.values())
            if checks or n:
                modes[style] = {
                    "launches": n,
                    "max_abs_err": max((r["max_abs_err"] for r in checks),
                                       default=None),
                    "cases": [r["case"] for r in checks]}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "modes": modes,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"],
            "case": h["case"], "shape_q": h["shape_q"], "Sk": h["Sk"],
            "dtype": h["dtype"],
            "checks": [{k: r.get(k) for k in (
                "case", "shape_q", "Sk", "dtype", "rope", "max_abs_err",
                "errs", "grad_scale", "lse_max_abs_err", "tol", "ms",
                "plain_ms", "library_ms", "bound_ms", "bound_by",
                "fma_bound_ms")}
                for r in mine]})
    kernels += probe_entries(probe_rows)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
