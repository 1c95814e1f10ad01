"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. card name and power limit; build every kernel from xpoint_tpu_torch/csrc
     (one nvcc per source, started together);
  2. K1 (bidirectional selective scan): kernel against its plain version at
     each flagship serving stage shape (512^2, B=8), bf16 operands from a
     seeded generator; max abs error (limit 2e-2: one bf16 ulp at |y| < 4
     over fp32-carry sums in both) and times (CUDA events, fresh inputs,
     median); a second run on the same inputs must give the same bits; the
     same checks at two shapes with tails (L = 300 and 64, 240 lanes); K1's
     launch at each stage shape (registers, spills and static shared memory
     from nvcc -Xptxas -v; resident blocks an SM, threads and dynamic
     shared memory a block, blocks) and the chain's share of a launch at
     L = 16384 (against the same bytes as spans that need no chain);
  3. serving path: the flagship VMamba XPoint (bf16, port initialisation,
     seed 0) through make_pair_pipeline at 512^2, B=8, on fresh random
     images; launch counts are zeroed just before and read just after (one
     K2 launch per call);
  4. K2 (grid box-NMS, one cooperative launch running every sweep): keep
     mask and sweep count against the plain version on the real heatmaps of
     phase 3 (16 planes, exact equality) and on a 1 x 512^2 plane with a
     strictly decreasing ramp along each row at size 8 (well over 100
     sweeps in the one launch), a second run bit for bit, one launch per
     call; box_nms_extract on the heatmaps under
     torch.cuda.set_sync_debug_mode("error") (no synchronising call);
     device time behind queued work (ms), the time with the host's launch
     path, both bounds (the function's and the bytes of every sweep through
     device memory) and the plain version's time; then boxes of 24 and 32
     (the kernel's banded instance, which stages each neighbourhood in
     shared memory a band of rows at a time) on the 16 heatmaps and on one
     of them: exactly the plain version's mask and sweeps in one launch a
     call, device time, bound and plain time; the banded instance's
     registers, spills and static shared memory (nvcc -Xptxas -v) and each
     launch's dynamic shared memory, resident blocks an SM and band plan;
  5. a small-input reference check: the tiny fp32 model on the card against
     the same model on the CPU (plain versions);
  6. K1 with checkpoints and K3 (the scan's backward) at the flagship
     training stage shapes (256^2, B=16): checkpoints against the plain
     recomputation (limit 1e-4 of max |plain|), K3's outputs against
     selective_scan_bidir_bwd_plain (bf16 planes 2e-2 of max |plain|: a
     bf16 ulp; fp32 dA/dD/dbias 1e-3 of max |plain|: sums over L in
     another order) and a second K3 run on the same inputs bit for bit,
     K3's device time (events behind queued work) and its time with the
     host's launch path, bound and the plain version's time; K1's bit-equal
     repeat and tail shapes as in phase 2, with checkpoints; K3 with tails
     and across its 256-token spans (L = 300, 64, 255, 256, 257, 511, 512
     and 513, B = 3, Dim = 40: 240 lanes; a chain of 64 spans on one lane
     group, L = 16384, B = 1, Dim = 16) against its plain version and
     repeated bit for bit; K3's registers, spills and static shared memory
     (nvcc -Xptxas -v) and its launch shape (resident blocks an SM, threads
     and dynamic shared memory a block, blocks) at every training stage
     shape; how far K3's ddt and dA move between K1's checkpoints and the
     plain ones (printed; also alone with ``python3 chip_smoke.py
     --k3-checkpoint-gap``); K3's time at each training stage shape of a
     step and of a rank's DP step is printed alone by ``python3
     chip_smoke.py --k3-stage-times`` (a copy of the script in a parent's
     tree times the parent's K3);
  7. train path: the flagship training config (VMAMBA_TRAIN_CFG: 256^2,
     B=16, bf16, DropPath 0.2, RegNet + HM loss, hard negatives) from seed
     0 on a seeded synthetic resident corpus through make_resident_batch_fn
     and make_train_step; per-step loss, components, skip flag and ms,
     samples/s, peak memory, K1/K3 launches per step (counts zeroed just
     before, read just after);
  8. the tiny fp32 train step (no DropPath, no HM head) on the card against
     the CPU from the same weights and batch: loss and every gradient;
  9. K4 (projective warp): kernel against its plain version at the calls
     one homographic-adaptation (HA) step makes at 512^2 with 8 warps
     (image warp multi bilinear/reflection, probability unwarp batch
     bilinear/zeros of one map (prod, sum) or two (window), mask unwarp
     batch nearest/zeros), homographies from the HA sampler plus a
     near-90-degree rotation and the identity: bilinear max abs error
     (limit 1e-5: only the blend's FMA contraction differs), nearest
     exactly equal; device times (events behind queued work, so that the
     host's launch path is not in them), bytes bound, and the time of
     F.grid_sample(align_corners=True) on the same coordinates, held to the
     kernel loosely (mean 1e-3; nearest 1% of the values), alone
     (library_ms: its normalised grid prepared outside the timed call) and
     with the grid built from the inverse homographies inside the call
     (library_with_grid_ms: what the library costs from the kernel's own
     inputs); the bilinear calls once more at 301 x 511, an odd size;
 10. HA label export at full width: the flagship detector (bf16, seed 0)
     on 512^2 synthetic pairs, HA_DEFAULT_CONFIG (num 100, prod) for three
     timed samples after a warm-up, then the export settings
     (EXPORT_HA_CONFIG: window, num 10) through export_keypoints into the
     numpy sink; finite non-zero maps in [0, 1], count within [min_count,
     num], keypoints for every sample, K4 / K1 / K2 launches per sample
     (counts zeroed just before, read just after) as the code predicts
     (one K2 launch an NMS call: 1 a sample, 2 an exported pair);
 11. K5 (single-direction fused scan): kernel against its plain version at
     the serving stage shapes (B=8, bf16; limit 2e-2 as K1's), a second run
     bit for bit, device time and time with the host's launch path, tails
     at L = 300 and 64 (B = 3, Dim = 40) as K3's, then the
     v052d_noz flagship-width model through make_pair_pipeline at 512^2,
     B=8 (16 K5 launches and 1 K2 launch per call);
 12. the tiny fp32 model's HA (prod, num 5, 64^2) on the card against the
     CPU: prob within 1e-4 where both hold the same count, keypoint sets;
 13. K6 (linear recurrence) against its plain version at the shapes the
     v052d_noz train step gives it (256^2, B=16: fp32 (16, 4, L, Dim) planes
     scanned along L, a = exp(-delta) in (0, 1]), forward and reversed with
     the shifted coefficient (the backward's form), and at one N > 1 shape
     in the general scan's time-major layout ((L, M) for d_state 4, B=4 at
     the first stage); limit 1e-5 of max |plain| (the segments are combined
     in scan order, only the rounding of the segment products differs);
     device times (events behind queued work, as K4's), the bytes bound 12 L M / 3.35e12 s and the plain version's time;
     K5 against its plain version at the same training stage shapes
     (checks and times as in phase 11);
 14. the v052d_noz train path at full width: VMAMBA_TRAIN_CFG with that
     forward type, otherwise as phase 7, for 5 steps; per step 16 K5
     launches (forward) and 32 K6 launches (in each of the 16 block
     backwards one to rebuild h and one reversed), no K1 or K3;
 15. the tiny fp32 train step on the card against the CPU, as phase 8, for
     v052d_noz (K5, K6), the gated v05 with d_state 4 (the general scan: K6
     forward and backward) and cascade2d v052dc_noz (K5 fed from the
     reference layout, K6 in its backward): loss and every gradient;
which of yaml, h5py, cv2 and tqdm import on the machine (printed); then the
full cycle's CNN models (tools/full_cycle.py) and the flagship on the host
data path, in a scratch directory under build/ that is removed at the end:
 16. the synthetic pretrain through the port's Trainer: SYNTH_CFG (two CNN
     encoders, no descriptor head, final BatchNorm, reflect pad,
     takes_pair false, B=16, lr 1e-3, fp32) on SyntheticShapes generated on
     the fly by the host loader (8 workers) with the dataset section of
     configs/config_synthetic_shapes.yaml (960 x 1280 drawn, blurred,
     resized to 240 x 320, photometric and homographic augmentation), 256
     samples an epoch (drawn anew every epoch), the Trainer building it
     from the config: two epochs of 16 steps with e1, e2 and latest
     checkpoints, then a second Trainer resumed from e1 that must end bit
     for bit where the first ended
     (cuDNN deterministic in this phase); each step call runs under
     torch.cuda.set_sync_debug_mode("error"); finite losses, no skipped
     step, ms per step (median after the first), the loop's ms per step,
     the loader wait a step, the batch's copy to the device, the host's ms
     a sample in a worker, samples/s,
     peak memory, the idle share against one profiled step and against the
     loop; then the tiny fp32 two-encoder CNN with per-spectrum statistics,
     one single-image and one pair step, on the card against the CPU (loss
     rtol 1e-4, gradients 1e-3 of each leaf's max, as phase 8);
 17. the HA label export of that detector, fine-tuned first: a Trainer
     initialised from phase 16's latest checkpoint by load_weights (every
     tensor taken) trains it two epochs of 16 steps on the block corners of
     SyntheticPairs images (SingleImageCorpus), since 32 steps of
     SyntheticShapes leave it predicting no keypoint (its loss flat) and
     the export pairs are SyntheticPairs; then loaded by
     model_io.load_model from the fine-tuning's directory: the full cycle's
     EXPORT_CFG (window, num 50, min_count 2, erosion radius 5, NMS 4,
     threshold 0.015) on four 512^2 synthetic pairs through
     export_keypoints after a warm-up pair; maps finite in [0, 1],
     keypoints in both spectra of every pair, per pair 21 K4 launches
     (three a chunk of 8 warps) and 2 K2 launches; s per pair; K2 on the
     export's maps against its plain version with its times;
 18. pair training and serving of the two-encoder CNN: PAIR_CFG
     (multispectral, per-spectrum statistics, bf16, descriptor loss, B=8,
     256^2 crops, device_data) through the Trainer on 64 SyntheticPairs
     at 512^2 for one epoch of 8 steps, checked as phase 16's; then the
     trained model through make_pair_pipeline at 512^2, B=8, k=1024, NMS
     8, threshold 0.015: latency per call as phase 3, one K2 launch a
     call, and K2 on its heatmaps against its plain version with times;
 19. the flagship config's own training path: VMAMBA_TRAIN_CFG at full
     width and depth (seed 0) with its own dataset section, ImagePairDataset
     in pair mode with 256^2 crops, host homographic augmentation and the
     hm-regression input, B=16, 8 loader workers, through the Trainer, on a
     folder corpus (optical/, thermal/) of 128 SyntheticPairs at 512^2
     written as PNG files here (labels: SyntheticPairs' keypoints in an
     .npz label file, keypoints_filename); get_dataset on the same folder
     config without labels once; the first batch with 1 and 8 workers bit for bit;
     a warm-up epoch and a measured one of 8 steps, each under the sync
     check, finite, none skipped, 16 K1 and 16 K3 launches a step (counts
     zeroed just before, read just after); ms a step beside phase 7's,
     the loop's ms a step, the loader wait, the batch's copy to the
     device, the host's ms a sample in a
     worker, os.cpu_count(), samples/s, peak memory, idle share against
     one profiled step and against the loop; then a straight run and one
     resumed from its e1, cuDNN deterministic, bit for bit; the host's
     homographic augmentation runs the native engine (the default path);
 20. evaluation at full width: cv2's version (USAC_MAGSAC must exist);
     phase 19's flagship, loaded from its directory by model_io.load_model
     (-v latest, the hm head dropped by configs/cipdp.yaml's
     disable_hmhead), through the port's benchmark entry point
     (cli.benchmark.main) with configs/cipdp.yaml (NMS 8, threshold 0.015,
     bfmatcher with cross-check, 256^2 crops of host homographic pairs)
     whose dataset is pointed at phase 19's PNG folder corpus (the cut:
     data/MULTIPOINT/test.hdf5 is not in the repository and this machine
     has no h5py), -e over 32 pairs, once with the MAGSAC estimator and
     once with the device one: the JSON read back with the JAX package's
     keys, every metric finite, the unit ones in [0, 1], h_correctness
     non-decreasing in the threshold and the corner error not negative;
     the timing harness's ms a stage, s a pair of the
     sweep, and K1 / K2 launches against what the code predicts (16 K1 a
     pair forward, one K2 an NMS call; counts zeroed before, read after);
     the metrics of a flagship trained 16 steps are printed as a
     functional check, not a result; K1 against its plain version at the
     sweep's stage shapes (256^2, B=1) as in phase 2, and K2 exact on one
     masked 256^2 plane the timing harness handed to NMS, as in phase 4,
     each with its device time; then phase 3's serving model through
     make_pair_pipeline with estimate_homography at 512^2, B=8, k=1024,
     512 hypotheses, the same images on both sides: H_est within 0.3 of the
     identity and more than 10 inliers a sample, latency beside the same
     pipeline without the estimator, and one call under
     torch.cuda.set_sync_debug_mode("error") with torch.linalg.svd (no
     _ex form) in "warn" mode and its syncs counted, and one profiled
     call: device time by kernel and by the host op that launched it, and
     the idle share; then
     ransac_homography on 1,024 planted matches (70% from a known H with
     1 px noise): corner error to the known H under 2 px, the card's H
     within 0.01 px of the CPU's on the same Gumbel array with the same
     inliers away from the threshold, a second run bit for bit, its time;
 21. the port's full cycle at the smoke size: python -m
     xpoint_tpu_torch.tools.full_cycle (4 train and 2 test pairs at 256^2,
     20 cached synthetic samples, 2 pretrain and 2 pair epochs, HA with 5
     warps, --classical) on the card, its eight stages each a process of
     its own with $XPOINT_TORCH_RUN_REPORT set: the metrics JSON and the
     SIFT baseline's <out>_classical.json read back with the JAX file's
     keys and nesting (homography_device included in the first), finite
     and in range; the stages in order, none of which imported h5py; each
     stage's wall seconds; the K4 and K2 launches each stage's process
     counted against what the code predicts (3 K4 calls a chunk of warps
     and 2 NMS calls an exported pair; 1 + 2 x 2 x 2 NMS calls a sweep, the
     classical one's included); then, in
     this process, the masked (1, 256, 256) planes the sweep's timing
     harness hands NMS, from the cycle's model and eval config: K2 exact
     against its plain version at NMS 4 on each, with times; K4 against
     its plain version at the export's three calls (4 warps at 256^2);
 22. the other entry points on phase 19's flagship checkpoint through
     their main(): predict_keypoints (-p) and predict_align_image_pair
     (-p) on pair 3 of phase 19's folder corpus at 512^2 (phase 20's
     config, MAGSAC), the demo (no --plot) on that pair's PNGs, and
     export_keypoints (window, 5 warps) on two pairs, then with -skip on
     three: one pair exported, none twice; the K1 / K2 / K4 launches of
     each against what the code predicts (counts zeroed before, read
     after); K2 exact on one 512^2 plane at size 8, K1 at the 512^2 stage
     shapes with B=1 and K4 at the export's three calls (4 warps at 512^2)
     against their plain versions, with times;
 23. SwinV2 serving: the model section of configs/cmt.yaml (SwinV2-T: embed
     96, depths [2, 2, 6, 2], heads [3, 6, 12, 24], window 8, RegNet, bf16)
     read by the port's load_yaml, built at full width from seed 0, through
     make_pair_pipeline at 512^2, B=8, k=1024, NMS 8, threshold 0.015 on
     fresh random images each call: latency and pairs/s (median of five
     after a warm-up), one K2 launch a call (counts zeroed just before,
     read just after), one more call profiled by kernel and by host op
     (launches, device ms, idle share), K2 exact against its plain version
     on the last timed call's heatmaps, and the tiny Swin XPoint (depths
     [2, 2], embed 24, window 4, fp32) on the card against the CPU (1e-4
     of max |CPU|);
 24. SwinV2 training through the Trainer from the whole of configs/cmt.yaml
     with two changes: its dataset is a mini corpus of 128 pairs at 256^2
     written in the scratch directory by the port's
     tools.make_mini_corpus with seeded random keypoints as .npz labels
     (data/MULTIPOINT is not in the repository), and its pretrained block
     points at an ImageNet-style checkpoint under the reference's key names
     that the phase writes (the port's Swin encoder from seed 1, with the
     relative-position buffers and a 1000-class head); 256^2 crops, B=16,
     bf16, RegNet and the hm loss, 8 loader workers, two epochs of 8 steps,
     every step under the sync check: ms a step, samples/s, peak memory,
     loader wait, idle share against one profiled step; the encoder the
     Trainer built equal to the checkpoint's (a device copy taken after
     __init__, compared after the steps); then one epoch each with the
     sparse descriptor loss and with the HomographyNet head;
 25. one HA-labelled pair with phase 23's Swin model: export_keypoints with
     the export settings at num 10 (window) on 512^2 synthetic pairs after
     a warm-up pair, 6 K4 and 2 K2 launches for the pair, K2 exact against
     its plain version on the Swin HA maps, and K4 against its plain
     version at the export's calls (8 warps at 512^2);
 26. xv / m0 serving: the flagship model section with only
     SSM_FORWARDTYPE changed, for each of xv1a, xv2a, xv3a (SS2Dv3) and
     m0_noz (SS2Dm0, the chunked SSD scan), from seed 0 through
     make_pair_pipeline at 512^2, B=8, k=1024, NMS 8, threshold 0.015 on
     fresh images each call: latency and pairs/s (median of five after a
     warm-up), peak memory, the launches against the code's prediction (16
     K5 and 1 K2 a call for each xv type, no scan kernel and 1 K2 for m0);
     the K5 operand shapes of xv1a's blocks recorded and checked equal to
     phase 11's (whose K5 checks and times stand for them); then the tiny
     model (depths [1, 1, 1, 1], embed 24, fp32) in every postfix family
     the CPU tests cover, on the card against the CPU (1e-4 of max |CPU|);
 27. xv / m0 training at full width (256^2, B=16, resident data as in
     phase 7, 8 steps each, every step under
     torch.cuda.set_sync_debug_mode("error")): xv1a (16 K5 forward and 32
     K6 backward a step), xv1a with SSM_D_STATE 16 (the general scan: 32 K6
     a step, forward and backward, its (L, B, K, C, N) fp32 planes saved)
     and m0_noz (no scan kernel): ms a step, samples/s, peak memory,
     launches against the prediction; K6 against its plain version at the
     N = 16 shapes ((L, B K C N) time-major planes of each stage, fwd and
     reversed-shifted, 1e-5 of max |plain|), with times;
 28. the baselines: the SIFT ClassicDetectors through python -m
     xpoint_tpu_torch.cli.benchmark -m none -v none -e (its main() in this
     process) with phase 20's config and a ClassicDetectors model section
     on phase 19's folder corpus (32 pairs): the JSON's keys, finite
     metrics in range, s a pair, K2 launches against the prediction (1 +
     2 x 37 NMS calls), K2 exact against its plain version on one masked
     SIFT plane, with times; LGHD and RIFT2 over two pairs each at 256^2
     (host s a pair); MagicLeap SuperPoint (seed-0 weights) through
     make_pair_pipeline at 512^2, B=8 (latency, pairs/s, 1 K2 a call, K2
     exact on its heatmaps) and in fp32 at 64^2 on the card against the
     CPU; a reference-named .model of the full cycle's pair CNN (seeded
     numpy under the reference's names) read by model_io.load_model on the
     card and on the CPU to the same bits, then one pipeline call;
 29. multi-device: 2 ranks, one process each, through
     xpoint_tpu_torch.parallel.launch: nccl with a card a rank where the
     machine has two cards, else gloo with both ranks on cuda:0 (printed on
     a line of its own; gloo stages CUDA collectives through the host, so
     its times are no scale-out figure). In the ranks: (a) 3 data-parallel
     flagship steps (phase 7's step with a mesh: 256^2, global B=16, 8 a
     rank, resident data; under nccl each under
     torch.cuda.set_sync_debug_mode("error")), 16 K1 + 16 K3 a rank a
     step; (b) the Trainer on the resident corpus, two epochs of 4 steps,
     e1 written by rank 0, and a second Trainer resumed from it that must
     end bit for bit where the first ended (cuDNN deterministic); (c)
     ring_linear_scan at L = 4096, M = 24,576 fp32 against one K6 launch
     over the whole L (1e-5 of max |h|) and ring_selective_scan at the
     flagship's first-stage SS2D shapes (256^2, B=16) against
     selective_scan (1e-4 of max |y|), 2 K6 a rank each; (d) the flagship
     serving model through make_sharded_pair_pipeline at 512^2, B=8 (4 a
     rank), 1 K2 + 16 K1 a rank a call; (e) cli.export_keypoints' rank
     path on 4 pairs of phase 19's corpus and checkpoint (window, num 10,
     default batch 2: the ranks), rank 0 writing the file. In this
     process, the one-rank runs on the same inputs: (a) the same steps,
     step 1's loss within 1e-4 and later ones within 1e-2 relative, every
     component of step 1 within 1e-2 relative (ratios 2e-3), each step's
     gradient (from Adam's mu) within MD_GRAD_TOL (step 1 leaf by leaf,
     steps 2-3 as one vector), which the first half of the first batch's
     gradient must miss, the running statistics after step 1 within 1e-5
     of their max, the update of the 3 steps within MD_UPDATE_TOL of its
     norm; (d) the same 4-sample calls bit for bit, and one B=8 call (bf16
     at B=8 against 4: other algorithms): probabilities within 2e-2,
     keypoint sets sharing 95% and match sets 80% of their union, which
     the sets with the two ranks' rows swapped must miss; (e) the export
     with --batch 2 (cli.export_keypoints' rank path, one rank), labels
     sharing 95% of their union, the K4 / K1 / K2 launches a rank as
     predicted (NMS on rank 0 alone); then K1 and K3 at a rank's train
     shapes (B=8), K1 at a rank's serving shapes (B=4), K2 on a rank's
     heatmaps and K6 on a rank's ring block against their plain versions,
     with times; ms a step a rank and pairs/s beside the card's name and
     power limit; (a) also one data-parallel step in fp32: step 1's
     gradient within MD_FP32_GRAD_TOL of one rank's as one vector, and
     leaf by leaf within MD_FP32_LEAF_TOL of one rank computing with the
     ranks' rounding and no collective (_RankArithmetic: convolutions,
     products and BatchNorm sums on the ranks' slices of the batch), the
     worst leaves of each comparison named; (g) Trainer(n_devices=1) on
     every rank of the launch: rank 0 trains MD_SUB_STEPS steps and ends
     bit for bit where the one-rank Trainer in this process ends (cuDNN
     deterministic), rank 1 takes no step and issues no collective;
 30. the measuring tools and the last CLIs at full width (the flagship,
     512^2, B=8): (a) eval.benchmark.model_cost of one pair forward, FLOPs
     and bytes a pair, its K1 terms equal to the bound's formulas at the
     serving shapes (and to phase 2's bound); (b) tools.roofline: a row a
     stage of one encoder pass (patch embed, each stage's blocks and one
     block's SS2D, downsamples, heads) with its bound from the H100's
     peaks and an exp rate calibrated here, no stage above 105% of its
     bound; (c) tools.stage_table: host-staged at B=1 and on the device at
     B=8, the on-device stages summing to phase 3's call time (its
     synchronised calls timed again in the same rounds as the stages'
     prefix streams: the host's speed drifts within seconds) within 25%;
     (d) a torch.profiler trace of 3 pipeline calls through
     tools.parse_trace: 16 K1 and 1 K2 launches a call by kernel name
     (K1's one kernel a call: bidir_chain_kernel, or bidir_span_kernel for
     a scan of at most 64 tokens; K2's nms_resident_kernel), equal to the
     wrappers' counts; (e)
     tools.op_sweep on phase 20's config, model and 32 pairs at two
     operating points, its processes
     python -m xpoint_tpu_torch.cli.benchmark: the first (phase 20's)
     gives phase 20's MAGSAC metrics; (f) the native augmentation engine
     built with g++ on this host: homographic_augmentation through it and
     through cv2 (XPOINT_NO_NATIVE=1) on 512^2 corpus images: the engine
     within 2e-3 of float64 bilinear sampling with BORDER_REFLECT_101 on
     every pixel; where the pixels sample inside the image, within cv2's
     1/32-pixel rounding of cv2 (OpenCV's version printed); the masks
     within 1% of cv2's; ms a sample each; one
     epoch of phase 19's Trainer on each path, alternated, its loop's ms a
     step beside its step's; (h) the show_* CLIs on phase 19's corpus and
     labels (an .npz of groups) and SyntheticShapes, and
     tools.make_multipoint_fixture as an .npz;
then a details JSON line, the per-kernel JSON line, the card line and the
final JSON line, and the whole script's wall time.
"""
import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B, H, W = 8, 512, 512
N_CALLS = 5
TRAIN_B, TRAIN_S = 16, 256     # the flagship training batch and crop
TRAIN_STEPS = 8                # step 1 warms up; ms is the median of 2..n


def cuda_ms(fn, inputs):
    """Median CUDA-event time of fn(*args) over the argument sets (each set
    used once, so every timed launch sees fresh inputs)."""
    times = []
    for args in inputs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def cuda_ms_queued(fn, inputs, delay):
    """As cuda_ms, for work of some microseconds: ``delay()`` first queues a
    few milliseconds of device work, so that the start event, the launches
    of ``fn`` and the end event are all enqueued while the card is still
    busy and the events bracket device time only, not the host's launch
    path."""
    times = []
    for args in inputs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        delay()
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def queued_delay(dev):
    """A ``delay`` for cuda_ms_queued: ~10 ms of device work (eight 8192^3
    bf16 products) ahead of each timed call; a plain version may enqueue
    some 40 small kernels behind it."""
    big = torch.ones(8192, 8192, dtype=torch.bfloat16, device=dev)
    return lambda: [torch.mm(big, big) for _ in range(8)]


def ptxas_summary(log, entry):
    """Registers, spill bytes and static shared memory of the entry
    functions whose mangled names contain ``entry``, from nvcc's ``-Xptxas
    -v`` output (``build.build_all(verbose=True)``)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1) if entry in m.group(1) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m:
            out.setdefault(name, {}).update(registers=int(m.group(1)),
                                            static_smem=int(m.group(2)))
    return out


def bound(work):
    """(ms, "bytes" or "operations"): the least time the card could take
    for a kernel's ``work`` (xpoint_tpu_torch/kernels/cost.py counts it
    from the shapes, for these bounds and for eval.benchmark.model_cost):
    its bytes at the memory rate or its operations at the fp32 rate."""
    from xpoint_tpu_torch.kernels import cost
    return cost.bound_ms(work)


def scan_operands(g, L, Dim, dev, batch=B):
    """bf16 operands at one stage shape; the constants are the flagship's
    initialisation (A = -1, D = 1, dt bias from log-uniform dt)."""
    bf = torch.bfloat16
    u = (torch.randn(L, batch, 2, Dim, generator=g, device=dev) * 0.5).to(bf)
    dt = (torch.randn(2, L, batch, 2, Dim, generator=g, device=dev)
          * 0.5).to(bf)
    bc = (torch.randn(2, L, batch, 2, generator=g, device=dev) * 0.5).to(bf)
    cc = (torch.randn(2, L, batch, 2, generator=g, device=dev) * 0.5).to(bf)
    A = -torch.ones(4 * Dim, device=dev)
    D = torch.ones(4 * Dim, device=dev)
    lo, hi = math.log(0.001), math.log(0.1)
    dt0 = torch.exp(torch.rand(4 * Dim, generator=g, device=dev) * (hi - lo)
                    + lo)
    bias = dt0 + torch.log(-torch.expm1(-dt0))
    return u, dt, bc, cc, A, D, bias


def phase_scan(dev, stages, blocks_per_stage, batch=B, tails=True):
    from xpoint_tpu_torch.kernels import cost
    from xpoint_tpu_torch.ops.selective_scan_cuda import (
        selective_scan_bidir, selective_scan_bidir_plain)
    g = torch.Generator(device=dev).manual_seed(1)
    rows, tot = [], {"ms": 0.0, "ms_with_host_launch": 0.0, "plain_ms": 0.0,
                     "bound_ms": 0.0}
    max_err = 0.0
    delay = queued_delay(dev)
    for (L, Dim), n_launch in zip(stages, blocks_per_stage):
        inputs = [scan_operands(g, L, Dim, dev, batch) for _ in range(6)]
        y_f, y_r = selective_scan_bidir(*inputs[0])          # warm-up + check
        again = selective_scan_bidir(*inputs[0])
        p_f, p_r = selective_scan_bidir_plain(*inputs[0])
        torch.cuda.synchronize()
        if not (torch.equal(y_f, again[0]) and torch.equal(y_r, again[1])):
            raise SystemExit(f"K1 gave other bits on the same inputs at "
                             f"L={L} Dim={Dim}")
        err = max(float((y_f.float() - p_f.float()).abs().max()),
                  float((y_r.float() - p_r.float()).abs().max()))
        rel = max(float(((y_f.float() - p_f.float()).abs()
                         / p_f.float().abs().clamp_min(1e-3)).max()),
                  float(((y_r.float() - p_r.float()).abs()
                         / p_r.float().abs().clamp_min(1e-3)).max()))
        finite = bool(torch.isfinite(y_f).all() and torch.isfinite(y_r).all())
        # device time (a launch takes tens of microseconds at the late
        # stages, as long as the host's path to it), and the time with that
        # path, as an idle card sees one call
        ms = cuda_ms_queued(selective_scan_bidir, inputs[1:], delay)
        launch_ms = cuda_ms(selective_scan_bidir, inputs[1:])
        plain_ms = cuda_ms(selective_scan_bidir_plain, inputs[1:3])
        M, G = batch * 2 * Dim, batch * 2
        b_ms, b_by = bound(cost.scan_bidir(L, M, G, Dim))
        rows.append({"L": L, "Dim": Dim, "M": M, "max_abs_err": err,
                     "max_rel_err": rel, "finite": finite, "ms": ms,
                     "ms_with_host_launch": launch_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "launches_per_pipeline_call": n_launch})
        print(f"K1 L={L} Dim={Dim} B={batch} M={M}: max_abs_err={err} "
              f"max_rel_err={rel} kernel_ms={ms} (with the host's launch "
              f"path {launch_ms}) plain_ms={plain_ms} "
              f"bound_ms={b_ms} ({b_by})", flush=True)
        max_err = max(max_err, err)
        if not finite or err > 2e-2:
            raise SystemExit(f"K1 disagrees with its plain version at "
                             f"L={L} Dim={Dim}: {err}")
        tot["ms"] += ms * n_launch
        tot["ms_with_host_launch"] += launch_ms * n_launch
        tot["plain_ms"] += plain_ms * n_launch
        tot["bound_ms"] += b_ms * n_launch
        del inputs
    print(f"K1 per pipeline call (B={batch}): kernel_ms={tot['ms']} (with "
          f"the host's launch path {tot['ms_with_host_launch']}) "
          f"bound_ms={tot['bound_ms']}", flush=True)
    if not tails:
        return rows, tot, max_err, None
    tails = scan_tail_checks(g, dev, emit_ckpt=False)
    return rows, tot, max(max_err, tails["max_abs_err"]), tails


def k1_design_report(dev, build_log, stages, batch=B):
    """K1's launches at the serving stage shapes: registers, spill bytes
    and static shared memory of its two kernels (nvcc -Xptxas -v), and at
    each shape the resident blocks an SM, threads and dynamic shared memory
    a block and blocks of its one launch; then the chain's share of a
    launch at the first stage (L = 16384): its device time against a launch
    of the same bytes as spans that need no chain (L = 128, 128 times the
    lanes), both behind queued work."""
    from xpoint_tpu_torch.ops.selective_scan_cuda import (
        selective_scan_bidir, selective_scan_bidir_launch_shape)
    ptxas = {}
    for name in ("bidir_chain_kernel", "bidir_span_kernel"):
        ptxas.update(ptxas_summary(build_log["selective_scan_bidir"], name))
    shapes = []
    for L, Dim in stages:
        M = batch * 2 * Dim
        shapes.append({"L": L, "Dim": Dim, "M": M,
                       **selective_scan_bidir_launch_shape(L, M, Dim)})
    g = torch.Generator(device=dev).manual_seed(2)
    delay = queued_delay(dev)
    (L0, Dim0), L1 = stages[0], 128
    times = {}
    for L, b in ((L0, batch), (L1, batch * L0 // L1)):
        inputs = [scan_operands(g, L, Dim0, dev, b) for _ in range(5)]
        selective_scan_bidir(*inputs[0])
        times[L] = cuda_ms_queued(selective_scan_bidir, inputs, delay)
        del inputs
    share = (times[L0] - times[L1]) / times[L0]
    res = {"ptxas": ptxas, "launch_shapes": shapes,
           "chain_share": {"L": L0, "M": batch * 2 * Dim0, "ms": times[L0],
                           "same_bytes_one_span_ms": times[L1],
                           "share": share}}
    print("K1 launch: ptxas " + json.dumps(ptxas) + "; at the serving "
          "stages " + json.dumps(shapes) + f"; chain share at L={L0}: "
          f"{times[L0]} ms against {times[L1]} ms for the same bytes as "
          f"spans of L={L1} (share {share})", flush=True)
    return res


def scan_tail_checks(g, dev, emit_ckpt):
    """K1 where its blocks have tails: L = 300 (three spans, the last of 44
    tokens) and L = 64 (the one-span kernel) with B = 3, Dim = 40
    (240 lanes: no multiple of a block's 32), bf16: against the plain version
    (y 2e-2 abs, checkpoints 1e-4 of max |plain|), and a second run on the
    same inputs bit for bit."""
    from xpoint_tpu_torch.ops.selective_scan_cuda import (
        selective_scan_bidir, selective_scan_bidir_plain)
    res = {"shapes": [], "max_abs_err": 0.0, "ckpt_rel_err": 0.0}
    for L in (300, 64):
        args = scan_operands(g, L, 40, dev, batch=3)
        out = selective_scan_bidir(*args, emit_ckpt=emit_ckpt)
        again = selective_scan_bidir(*args, emit_ckpt=emit_ckpt)
        ref = selective_scan_bidir_plain(*args, emit_ckpt=emit_ckpt)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(out[:2], ref[:2]))
        ck = max((_rel_err(a, b) for a, b in zip(out[2:], ref[2:])),
                 default=0.0)
        same = all(torch.equal(a, b) for a, b in zip(out, again))
        print(f"K1 tails L={L} B=3 Dim=40 emit_ckpt={emit_ckpt}: "
              f"max_abs_err={err} ckpt_rel_err={ck} bit-equal repeat={same}",
              flush=True)
        if (not same or err > 2e-2 or ck > 1e-4
                or not all(bool(torch.isfinite(x).all()) for x in out)):
            raise SystemExit(f"K1 fails at the tail shape L={L}: {err} {ck} "
                             f"repeat {same}")
        res["shapes"].append([L, 3, 40])
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["ckpt_rel_err"] = max(res["ckpt_rel_err"], ck)
    return res


def phase_main_path(dev):
    from xpoint_tpu_torch.eval import make_pair_pipeline
    from xpoint_tpu_torch.models import VMAMBA_MODEL_CFG, build_xpoint
    from xpoint_tpu_torch.ops.nms import grid_nms_keep
    from xpoint_tpu_torch.ops.selective_scan_cuda import selective_scan_bidir

    t0 = time.time()
    module, _ = build_xpoint(VMAMBA_MODEL_CFG, device=dev, seed=0)
    init_s = time.time() - t0
    run = make_pair_pipeline(module, (H, W), k=1024, nms_size=8,
                             detection_threshold=0.015)
    g = torch.Generator(device=dev).manual_seed(0)
    images = [(torch.rand(B, H, W, 1, generator=g, device=dev),
               torch.rand(B, H, W, 1, generator=g, device=dev))
              for _ in range(N_CALLS + 1)]
    out = run(*images[0])                                   # warm-up
    torch.cuda.synchronize()

    selective_scan_bidir.launches = 0
    grid_nms_keep.launches = 0
    lat, matches = [], []
    for img_o, img_t in images[1:]:
        t0 = time.perf_counter()
        out = run(img_o, img_t)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        matches.append(int(out["matched"].sum()))
        for key, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise SystemExit(f"main path: non-finite {key}")
    launches = {"selective_scan_bidir": selective_scan_bidir.launches,
                "nms_sweep": grid_nms_keep.launches}
    if launches["nms_sweep"] != N_CALLS:
        raise SystemExit(f"main path: {launches['nms_sweep']} K2 launches in "
                         f"{N_CALLS} calls, expected one a call")
    expect = {"prob_optical": (B, H, W), "keypoints_optical": (B, 1024, 2),
              "desc_optical": (B, 1024, 256), "matched": (B, 1024)}
    for key, shape in expect.items():
        if tuple(out[key].shape) != shape:
            raise SystemExit(f"main path: {key} has shape "
                             f"{tuple(out[key].shape)}, expected {shape}")
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"main path never launched kernel {name}")
    lat_ms = sorted(lat)[len(lat) // 2]
    res = {"init_s": init_s, "latency_ms": lat_ms, "latency_all_ms": lat,
           "pairs_per_s": B / lat_ms * 1e3, "matches": matches,
           "keypoints_optical": int(out["mask_optical"].sum()),
           "k1_launches_per_call": launches["selective_scan_bidir"] / N_CALLS,
           "launches": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"main path 512^2 B={B}: latency_ms={lat_ms} "
          f"pairs_per_s={res['pairs_per_s']} matches={matches} "
          f"launches={launches}", flush=True)
    probs = torch.cat([out["prob_optical"], out["prob_thermal"]])
    return res, probs, module


def phase_nms(probs):
    from xpoint_tpu_torch.kernels import cost
    from xpoint_tpu_torch.ops.nms import (_grid_nms_keep_cuda, box_nms_extract,
                                          grid_nms_keep, grid_nms_keep_plain,
                                          last_launch_shape)
    valid = probs > 0.015
    before = grid_nms_keep.launches
    keep, sweeps = grid_nms_keep(probs, valid, 8, 0.1)
    serve_shape = last_launch_shape()
    print(f"K2 serving launch: {serve_shape}", flush=True)
    again, again_sweeps = grid_nms_keep(probs, valid, 8, 0.1)
    ref, ref_sweeps = grid_nms_keep_plain(probs, valid, 8, 0.1)
    # a ramp along each row (every box suppresses the next, ~2 sweeps a box)
    # beside three of the heatmaps: enough planes for the resident instance,
    # each stopping at its own fixed point
    ramp = torch.cat([torch.linspace(1.0, 0.5, W, device=probs.device)
                      .expand(1, H, W), probs[:3]])
    ramp_keep, ramp_sweeps = grid_nms_keep(ramp, ramp > 0.015, 8, 0.1)
    ramp_shape = last_launch_shape()
    ramp_ref, ramp_ref_sweeps = grid_nms_keep_plain(ramp, ramp > 0.015, 8,
                                                    0.1)
    torch.cuda.synchronize()
    launches = grid_nms_keep.launches - before
    n_diff = int((keep != ref).sum())
    ramp_diff = int((ramp_keep != ramp_ref).sum())
    print(f"K2 {probs.shape[0]} planes {H}x{W}: sweeps={sweeps} "
          f"(plain {ref_sweeps}) pixels differing={n_diff} bit-equal repeat="
          f"{torch.equal(keep, again) and sweeps == again_sweeps}; ramp "
          f"and 3 heatmaps 4x{H}x{W}: sweeps={ramp_sweeps} (plain "
          f"{ramp_ref_sweeps}) pixels differing={ramp_diff} launch "
          f"{ramp_shape}; launches={launches}", flush=True)
    if (n_diff or sweeps != ref_sweeps or not torch.equal(keep, again)
            or again_sweeps != sweeps or ramp_diff
            or ramp_sweeps != ramp_ref_sweeps or ramp_sweeps < 100
            or ramp_shape["cluster"] == 0 or launches != 3):
        raise SystemExit("K2 disagrees with its plain version, with itself "
                         "or with one launch a call")

    # the serving path's NMS reads nothing back from the card
    box_nms_extract(probs, 8, 0.015, 0.1, 1024)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        box_nms_extract(probs, 8, 0.015, 0.1, 1024)
    except RuntimeError as e:
        raise SystemExit(f"box_nms_extract synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    delay = queued_delay(probs.device)
    args = [(probs, valid, 8, 0.1)] * 5
    ms = cuda_ms_queued(_grid_nms_keep_cuda, args, delay)
    launch_ms = cuda_ms(_grid_nms_keep_cuda, args)
    plain_ms = cuda_ms(grid_nms_keep_plain, args[:3])
    n_px = probs.shape[0] * H * W
    compares = cost.nms_compares(8, 0.1)
    b_ms, b_by = bound(cost.nms(n_px, sweeps, 8, 0.1))
    sweep_bytes_ms = sweeps * n_px * (4 + 1 + 1) / cost.HBM_BYTES_PER_S * 1e3
    res = {"planes": probs.shape[0], "sweeps": sweeps,
           "ramp_sweeps": ramp_sweeps, "valid_px": int(valid.sum()),
           "kept_px": int(keep.sum()), "ms": ms,
           "ms_with_host_launch": launch_ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_sweep_bytes_ms": sweep_bytes_ms,
           "compares_per_px_sweep": compares, "no_host_read": True,
           "launch_shape": serve_shape}
    print(f"K2 times: kernel_ms={ms} (with the host's launch path "
          f"{launch_ms}) plain_ms={plain_ms} bound_ms={b_ms} ({b_by}; "
          f"every sweep's bytes through device memory {sweep_bytes_ms})",
          flush=True)
    res["edges"] = k2_edge_checks(probs)
    res["shapes"] = k2_shape_times(probs)
    return res


def k2_edge_checks(probs):
    """K2 exactly against its plain version at the edges of its design: 1 x
    W row ramps at size 2 that are still changing at the H * W sweep cap (W
    = 64 and 65), 40 a call (the resident instance) and one (the staged
    one), and a plane that does not fit a cluster (the serving heatmaps
    tiled to 2048^2, size 8), each one launch with its shape."""
    from xpoint_tpu_torch.ops.nms import (grid_nms_keep, grid_nms_keep_plain,
                                          last_launch_shape)
    dev = probs.device
    cases = [(torch.linspace(1.0, 0.5, n, device=dev).expand(m, 1, n)
              .contiguous(), 2, f"sweep cap {m}x1x{n}", m > 1)
             for m, n in ((40, 64), (40, 65), (1, 65))]
    cases.append((probs[:1].repeat(1, 4, 4), 8, "no fit 1x2048x2048", False))
    rows = []
    for p, size, tag, resident_expected in cases:
        valid = p > 0.015
        before = grid_nms_keep.launches
        keep, sweeps = grid_nms_keep(p, valid, size, 0.1)
        shape = last_launch_shape()
        launches = grid_nms_keep.launches - before
        ref, ref_sweeps = grid_nms_keep_plain(p, valid, size, 0.1)
        n_diff = int((keep != ref).sum())
        rows.append({"case": tag, "size": size, "sweeps": sweeps,
                     "plain_sweeps": ref_sweeps, "pixels_differing": n_diff,
                     "launches": launches, "launch_shape": shape})
        print(f"K2 {tag}, size {size}: {rows[-1]}", flush=True)
        cap = p.shape[1] * p.shape[2] if tag.startswith("sweep cap") else None
        resident = shape["cluster"] > 0
        if (n_diff or sweeps != ref_sweeps or launches != 1
                or (cap is not None and sweeps != cap)
                or resident != resident_expected):
            raise SystemExit(f"K2 {tag}: disagrees with its plain version, "
                             f"its sweep cap or its instance: {rows[-1]}")
    return rows


# K2's shapes on the paths (PERF.md's rows), cut from the serving heatmaps:
# (planes, rows, columns), box
K2_SHAPES = (((16, 512, 512), 8), ((16, 512, 512), 4), ((8, 512, 512), 8),
             ((2, 512, 512), 4), ((1, 512, 512), 8), ((1, 512, 512), 4),
             ((1, 256, 256), 8), ((1, 256, 256), 4))


def sparse_plane(dev):
    """A masked (1, 256, 256) plane of isolated responses 12 pixels apart
    (none in another's box at size 8), like the SIFT sweep's: one sweep."""
    g = torch.Generator().manual_seed(14)
    p = torch.zeros(1, 256, 256)
    p[0, 6::12, 6::12] = 0.02 + torch.rand(21, 21, generator=g)
    return p.to(dev)


def k2_earlier(src):
    """K2 of another tree, built here from its csrc/nms_sweep.cu, for boxes
    up to 16; returns fn(prob, valid, size, iou) -> (keep, sweeps on the
    device), as ops.nms._grid_nms_keep_cuda. A source from before the
    resident instance (no xp_nms_fit_rows) sizes its scratch by the shape
    alone, a later one by the shape and the box; a source that counts plane
    sweeps (``plane_sweeps``) takes a null counter."""
    import ctypes
    import hashlib
    from xpoint_tpu_torch.kernels import build
    from xpoint_tpu_torch.ops.nms import _widths_arg
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    out = os.path.join(build.BUILD_DIR, f"libnms_sweep_earlier-{tag}.so")
    if not os.path.exists(out):
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out, src],
                       check=True, capture_output=True)
    with open(src) as f:
        counted = "plane_sweeps" in f.read()
    lib = ctypes.CDLL(out)
    lib.xp_nms.restype = ctypes.c_int
    lib.xp_nms.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p] * (3 if counted else 2))
    resident = hasattr(lib, "xp_nms_fit_rows")
    lib.xp_nms_scratch.restype = ctypes.c_longlong
    lib.xp_nms_scratch.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p]
                                   if resident else [ctypes.c_int] * 3)

    def run(prob, valid, size, iou):
        B, H_, W_ = prob.shape
        keep = torch.empty_like(valid)
        box = (size, _widths_arg(size, iou)) if resident else ()
        scratch = torch.empty(lib.xp_nms_scratch(B, H_, W_, *box),
                              dtype=torch.uint8, device=prob.device)
        state = torch.empty(4, dtype=torch.int32, device=prob.device)
        err = lib.xp_nms(prob.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                         scratch.data_ptr(), state.data_ptr(), B, H_, W_,
                         size, _widths_arg(size, iou),
                         *([None] if counted else []),
                         torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"the earlier K2 failed to launch: {err}")
        return keep, state[3]
    return run


def k2_shape_times(probs, earlier=None):
    """K2 at K2_SHAPES cut from the serving heatmaps and on sparse_plane:
    exactly the plain version's mask and sweeps, device time behind queued
    work (median of 5), bound and launch shape. With ``earlier`` (an
    earlier tree's nms_sweep.cu, ``python3 chip_smoke.py --k2-shape-times
    SRC``) that tree's K2 on the same inputs too, exact as well, the two
    timed in turns: earlier, this, this, earlier."""
    from xpoint_tpu_torch.kernels import cost
    from xpoint_tpu_torch.ops.nms import (_grid_nms_keep_cuda,
                                          grid_nms_keep_plain,
                                          last_launch_shape)
    old = k2_earlier(earlier) if earlier else None
    delay = queued_delay(probs.device)
    cases = [(probs[:n, :h, :w].contiguous(), size)
             for (n, h, w), size in K2_SHAPES]
    cases.append((sparse_plane(probs.device), 8))
    rows = []
    for p, size in cases:
        valid = p > 0.015
        ref, ref_sweeps = grid_nms_keep_plain(p, valid, size, 0.1)
        runs = {"this": _grid_nms_keep_cuda, "earlier": old}
        for who in ("this", "earlier") if old else ("this",):
            keep, sweeps = runs[who](p, valid, size, 0.1)
            if not torch.equal(keep, ref) or int(sweeps) != ref_sweeps:
                raise SystemExit(f"K2 ({who}) at {tuple(p.shape)}, size "
                                 f"{size}: not the plain version's answer")
        _grid_nms_keep_cuda(p, valid, size, 0.1)
        shape = last_launch_shape()
        args = [(p, valid, size, 0.1)] * 5
        times = {"this": [], "earlier": []}
        for who in (("earlier", "this", "this", "earlier") if old
                    else ("this",)):
            times[who].append(cuda_ms_queued(runs[who], args, delay))
        b_ms, b_by = bound(cost.nms(p.numel(), ref_sweeps, size, 0.1))
        rows.append({"shape": list(p.shape), "size": size,
                     "sweeps": ref_sweeps, "ms": times["this"],
                     "earlier_ms": times["earlier"], "bound_ms": b_ms,
                     "bound_by": b_by, "launch_shape": shape})
        print(f"K2 at {tuple(p.shape)}, size {size}: {rows[-1]}", flush=True)
    return rows


def serving_heatmaps(dev):
    """The 16 heatmaps of one flagship serving call (seed-0 model and
    images, 512^2, B=8), as phase 3 hands them to K2."""
    from xpoint_tpu_torch.eval import make_pair_pipeline
    from xpoint_tpu_torch.models import VMAMBA_MODEL_CFG, build_xpoint
    module, _ = build_xpoint(VMAMBA_MODEL_CFG, device=dev, seed=0)
    run = make_pair_pipeline(module, (H, W), k=1024, nms_size=8,
                             detection_threshold=0.015)
    g = torch.Generator(device=dev).manual_seed(0)
    out = run(torch.rand(B, H, W, 1, generator=g, device=dev),
              torch.rand(B, H, W, 1, generator=g, device=dev))
    return torch.cat([out["prob_optical"], out["prob_thermal"]])


def phase_reference(dev):
    """Tiny fp32 model: the card's path against the CPU path."""
    from xpoint_tpu_torch.eval import make_pair_pipeline
    from xpoint_tpu_torch.models import VMAMBA_MODEL_CFG, build_xpoint
    cfg = copy.deepcopy(VMAMBA_MODEL_CFG)
    cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"].update(
        DEPTHS=[1, 1, 1, 1], EMBED_DIM=24)
    cfg["descriptor_size"] = 32
    cfg["mixed_precision"] = False
    g = torch.Generator().manual_seed(0)
    imgs = [torch.rand(2, 64, 64, 1, generator=g) for _ in range(2)]
    outs = []
    for d in ("cpu", dev):
        m, _ = build_xpoint(cfg, device=d)
        o = make_pair_pipeline(m, (64, 64), k=64)(*(x.to(d) for x in imgs))
        outs.append({k: v.cpu() for k, v in o.items()})
    cpu, gpu = outs
    prob_err = max(float((gpu[f"prob_{s}"] - cpu[f"prob_{s}"]).abs().max())
                   for s in ("optical", "thermal"))
    sets = lambda o, s, b: {tuple(p.tolist()) for p, ok in zip(  # noqa: E731
        o[f"keypoints_{s}"][b], o[f"mask_{s}"][b]) if ok}
    inter = union = 0
    for s in ("optical", "thermal"):
        for b in range(2):
            a, c = sets(cpu, s, b), sets(gpu, s, b)
            inter += len(a & c)
            union += len(a | c)
    jaccard = inter / max(union, 1)
    print(f"reference (tiny fp32, card vs CPU): prob max_abs_err={prob_err} "
          f"keypoint jaccard={jaccard}", flush=True)
    if prob_err > 1e-4 or jaccard < 0.95:
        raise SystemExit("card path disagrees with the CPU reference")
    return {"prob_max_abs_err": prob_err, "keypoint_jaccard": jaccard}


def _rel_err(a, b):
    """max |a - b| / max |b| (both as fp32)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


K3_NAMES = ("du", "ddt", "dbc", "dcc", "dA", "dD", "dbias")


def _k3_errors(out, ref):
    """Relative (max |k - p| / max |p|) and absolute errors of K3's seven
    outputs, and the names over their limits: bf16 planes 2e-2 (a bf16
    ulp), fp32 dA/dD/dbias 1e-3 (sums over L in another order)."""
    rel = {n: _rel_err(a, b) for n, a, b in zip(K3_NAMES, out, ref)}
    ab = {n: float((a.float() - b.float()).abs().max())
          for n, a, b in zip(K3_NAMES, out, ref)}
    bad = [n for i, n in enumerate(K3_NAMES)
           if rel[n] > (2e-2 if i < 4 else 1e-3)]
    return rel, ab, bad


def _train_grads(g, L, Dim, dev, batch):
    return tuple((torch.randn(L, batch, 2, Dim, generator=g, device=dev)
                  * 0.1).to(torch.bfloat16) for _ in range(2))


def phase_train_scan(dev, stages, launches_per_stage, batch=TRAIN_B,
                     tails=True):
    """K1 with checkpoints and K3 at the training stage shapes (``batch``
    samples), against their plain versions; times of one launch per stage
    shape; with ``tails``, the tail shapes too."""
    from xpoint_tpu_torch.kernels import cost
    from xpoint_tpu_torch.ops.selective_scan_cuda import (
        selective_scan_bidir, selective_scan_bidir_bwd,
        selective_scan_bidir_bwd_plain, selective_scan_bidir_plain)
    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    tot = {k: 0.0 for k in ("k1_ms", "k1_ms_with_host_launch", "k1_plain_ms",
                            "k1_bound_ms", "k3_ms", "k3_ms_with_host_launch",
                            "k3_plain_ms", "k3_bound_ms")}
    k1_err = k3_err = 0.0
    delay = queued_delay(dev)
    for (L, Dim), n_launch in zip(stages, launches_per_stage):
        sets = [(scan_operands(g, L, Dim, dev, batch=batch),
                 _train_grads(g, L, Dim, dev, batch)) for _ in range(6)]
        args, (g_f, g_r) = sets[0]
        out = selective_scan_bidir(*args, emit_ckpt=True)
        again = selective_scan_bidir(*args, emit_ckpt=True)
        ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise SystemExit(f"K1 with checkpoints gave other bits on the "
                             f"same inputs at L={L} Dim={Dim}")
        del again
        bwd = selective_scan_bidir_bwd(*args, *out[2:], g_f, g_r)
        bwd_again = selective_scan_bidir_bwd(*args, *out[2:], g_f, g_r)
        bwd_ref = selective_scan_bidir_bwd_plain(*args, *ref[2:], g_f, g_r)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(bwd, bwd_again))
        del bwd_again
        ck_err = max(_rel_err(a, b) for a, b in zip(out[2:], ref[2:]))
        y_err = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(out[:2], ref[:2]))
        errs, abs_errs, bad = _k3_errors(bwd, bwd_ref)
        finite = all(bool(torch.isfinite(x).all()) for x in (*out, *bwd))
        print(f"K3 L={L} Dim={Dim} B={batch}: rel err (max|k-p|/max|p|) "
              + " ".join(f"{n}={errs[n]:.3g}" for n in K3_NAMES)
              + " abs err " + " ".join(f"{n}={abs_errs[n]:.3g}"
                                       for n in K3_NAMES)
              + f"; bit-equal repeat={same}; K1 checkpoint rel err "
              f"{ck_err:.3g}, y abs err {y_err}", flush=True)
        if not finite or bad or not same or ck_err > 1e-4 or y_err > 2e-2:
            raise SystemExit(f"K1/K3 disagree with their plain versions at "
                             f"L={L} Dim={Dim}: {bad} ckpt {ck_err} "
                             f"y {y_err} repeat {same}")
        k1_call = lambda a: selective_scan_bidir(  # noqa: E731
            *a, emit_ckpt=True)
        k1_ms = cuda_ms_queued(k1_call, [(a,) for a, _ in sets[1:]], delay)
        k1_launch_ms = cuda_ms(k1_call, [(a,) for a, _ in sets[1:]])
        ckpts = [selective_scan_bidir(*a, emit_ckpt=True)[2:]
                 for a, _ in sets]
        k3_sets = [(*a, *c, *gy) for (a, gy), c in zip(sets[1:], ckpts[1:])]
        # device time behind queued work, and with the host's launch path
        k3_ms = cuda_ms_queued(selective_scan_bidir_bwd, k3_sets, delay)
        k3_launch_ms = cuda_ms(selective_scan_bidir_bwd, k3_sets)
        k1_plain = cuda_ms(lambda a: selective_scan_bidir_plain(
            *a, emit_ckpt=True), [(sets[1][0],)])
        k3_plain = cuda_ms(selective_scan_bidir_bwd_plain,
                           [(*sets[1][0], *ckpts[1], *sets[1][1])])
        M, G = batch * 2 * Dim, batch * 2
        k1_b, k1_by = bound(cost.scan_bidir(L, M, G, Dim, emit_ckpt=True))
        k3_b, k3_by = bound(cost.scan_bidir_bwd(L, M, G))
        rows.append({"L": L, "Dim": Dim, "M": M, "k3_rel_err": errs,
                     "k3_abs_err": abs_errs, "k3_bit_equal_repeat": same,
                     "k1_ckpt_rel_err": ck_err,
                     "k1_ms": k1_ms, "k1_ms_with_host_launch": k1_launch_ms,
                     "k1_plain_ms": k1_plain,
                     "k1_bound_ms": k1_b, "k3_ms": k3_ms,
                     "k3_ms_with_host_launch": k3_launch_ms,
                     "k3_plain_ms": k3_plain, "k3_bound_ms": k3_b,
                     "k3_bound_by": k3_by,
                     "launches_per_train_step": n_launch})
        print(f"  K1+ckpt ms={k1_ms} (with the host's launch path "
              f"{k1_launch_ms}) plain_ms={k1_plain} bound_ms={k1_b} "
              f"({k1_by}); K3 ms={k3_ms} (with the host's launch path "
              f"{k3_launch_ms}) plain_ms={k3_plain} bound_ms={k3_b} "
              f"({k3_by})", flush=True)
        for k, v in (("k1_ms", k1_ms),
                     ("k1_ms_with_host_launch", k1_launch_ms),
                     ("k1_plain_ms", k1_plain),
                     ("k1_bound_ms", k1_b), ("k3_ms", k3_ms),
                     ("k3_ms_with_host_launch", k3_launch_ms),
                     ("k3_plain_ms", k3_plain), ("k3_bound_ms", k3_b)):
            tot[k] += v * n_launch
        k1_err = max(k1_err, y_err)
        k3_err = max(k3_err, max(abs_errs.values()))
        del sets, ckpts, k3_sets
    if not tails:
        return rows, tot, k1_err, k3_err, None, None
    tails = scan_tail_checks(g, dev, emit_ckpt=True)
    k3_tails = bwd_tail_checks(g, dev)
    return (rows, tot, max(k1_err, tails["max_abs_err"]),
            max(k3_err, k3_tails["max_abs_err"]), tails, k3_tails)


BWD_TAILS = [(L, 3, 40) for L in (300, 64, 255, 256, 257, 511, 512, 513)] \
    + [(16384, 1, 16)]


def bwd_tail_checks(g, dev):
    """K3 where its blocks have tails and across its 256-token spans (one
    checkpoint chunk each): L = 300 (a full span and one of 44 tokens), 64
    (the one-span kernel's 8 steps a thread), 255 and 256 (one span), 257,
    511, 512 and 513 (two or three spans, the last of one token, short or
    full) with B = 3, Dim = 40 (240 lanes: no multiple of a block's 32,
    groups that straddle its slices), and a chain of 64 spans a direction on
    one lane group (L = 16384, B = 1, Dim = 16), bf16, from K1's own
    checkpoints: against the plain version (the limits of _k3_errors) and a
    second run on the same inputs bit for bit."""
    from xpoint_tpu_torch.ops.selective_scan_cuda import (
        selective_scan_bidir, selective_scan_bidir_bwd,
        selective_scan_bidir_bwd_plain)
    res = {"shapes": [], "max_abs_err": 0.0, "rel_err": {}}
    for L, batch, Dim in BWD_TAILS:
        args = scan_operands(g, L, Dim, dev, batch=batch)
        gy = _train_grads(g, L, Dim, dev, batch)
        ck = selective_scan_bidir(*args, emit_ckpt=True)[2:]
        out = selective_scan_bidir_bwd(*args, *ck, *gy)
        again = selective_scan_bidir_bwd(*args, *ck, *gy)
        ref = selective_scan_bidir_bwd_plain(*args, *ck, *gy)
        torch.cuda.synchronize()
        rel, ab, bad = _k3_errors(out, ref)
        same = all(torch.equal(a, b) for a, b in zip(out, again))
        print(f"K3 tails L={L} B={batch} Dim={Dim}: rel err "
              + " ".join(f"{n}={rel[n]:.3g}" for n in K3_NAMES)
              + f" bit-equal repeat={same}", flush=True)
        if (bad or not same
                or not all(bool(torch.isfinite(x).all()) for x in out)):
            raise SystemExit(f"K3 fails at the tail shape L={L}: {bad} "
                             f"repeat {same}")
        res["shapes"].append([L, batch, Dim])
        res["max_abs_err"] = max(res["max_abs_err"], max(ab.values()))
        res["rel_err"][f"{L},{batch},{Dim}"] = rel
        del args, gy, ck, out, again, ref
    return res


def k3_design_report(dev, build_log, stages,
                     batches=(TRAIN_B, TRAIN_B // 2)):
    """K3's registers, spill bytes and static shared memory (nvcc -Xptxas
    -v) of its three kernels, and its recurrence's launch shape (resident
    blocks an SM, threads and dynamic shared memory a block, blocks) at the
    training stage shapes of a step (B=16) and of a rank's DP step (B=8)."""
    from xpoint_tpu_torch.ops.selective_scan_cuda import (
        selective_scan_bidir_bwd_launch_shape)
    ptxas = {}
    for name in ("bwd_chain_kernel", "bwd_span_kernel", "finish_kernel"):
        ptxas.update(ptxas_summary(build_log["selective_scan_bidir_bwd"],
                                   name))
    shapes = [{"B": batch, "L": L, "Dim": Dim, "M": batch * 2 * Dim,
               **selective_scan_bidir_bwd_launch_shape(L, batch * 2 * Dim,
                                                       Dim)}
              for batch in batches for L, Dim in stages]
    print("K3 launch: ptxas " + json.dumps(ptxas) + "; at the training "
          "stages " + json.dumps(shapes), flush=True)
    return {"ptxas": ptxas, "launch_shapes": shapes}


def k3_checkpoint_gap(dev, stages):
    """Whether K3 differentiates the function K1 computed, per training
    stage shape:
      ddt, dA: how far K3's ddt and dA move (max |d| / max |result|) when it
        is fed K1's checkpoints instead of the plain version's (bf16);
      dC: fp32 operands with D = 0 and |C| >= 0.5, so that K1's own h is
        y / C to fp32 rounding: K3's dC (rebuilt from K1's checkpoints)
        against sum over each group of g * y / C. A K3 that rebuilds h with
        other softplus / exp forms than K1 shows the difference here.
    ``python3 chip_smoke.py --k3-checkpoint-gap`` prints it for the package
    that sits beside the script."""
    from xpoint_tpu_torch.ops.selective_scan_cuda import (
        selective_scan_bidir, selective_scan_bidir_bwd,
        selective_scan_bidir_plain)
    g = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for L, Dim in stages:
        args = scan_operands(g, L, Dim, dev, batch=TRAIN_B)
        gy = _train_grads(g, L, Dim, dev, TRAIN_B)
        ck_k1 = selective_scan_bidir(*args, emit_ckpt=True)[2:]
        ck_plain = selective_scan_bidir_plain(*args, emit_ckpt=True)[2:]
        a = selective_scan_bidir_bwd(*args, *ck_k1, *gy)
        b = selective_scan_bidir_bwd(*args, *ck_plain, *gy)
        row = {"L": L, "Dim": Dim, "ddt": _rel_err(a[1], b[1]),
               "dA": _rel_err(a[4], b[4])}
        del a, b, ck_plain
        u, dt, bc, cc, A, D, bias = (x.float() for x in args)
        cc = torch.where(cc < 0, -0.5, 0.5) + cc.clamp(-1, 1)
        D = torch.zeros_like(D)
        gf = tuple(x.float() for x in gy)
        y_f, y_r, hck_f, hck_r = selective_scan_bidir(
            u, dt, bc, cc, A, D, bias, emit_ckpt=True)
        dcc = selective_scan_bidir_bwd(u, dt, bc, cc, A, D, bias, hck_f,
                                       hck_r, *gf)[3]
        want = torch.stack([(gr * y / c[..., None]).sum(-1) for gr, y, c in
                            zip(gf, (y_f, y_r), cc)])
        row["dC"] = _rel_err(dcc, want)
        rows.append(row)
        print(f"K3 checkpoint gap L={L} Dim={Dim}: {row}", flush=True)
    return rows


def k3_stage_times(dev, stages, batches=(TRAIN_B, TRAIN_B // 2)):
    """K3's device time (events behind queued work, median of 5 launches on
    fresh inputs with K1's own checkpoints) at each training stage shape of
    a step (B=16) and of a rank's DP step (B=8), its bound, and the sum over
    a step's launches (2 blocks x 2 directions a stage). ``python3
    chip_smoke.py --k3-stage-times`` prints it for the package that sits
    beside the script, so a copy of the script in a parent's tree times the
    parent's K3 on the same card."""
    from xpoint_tpu_torch.kernels import cost
    from xpoint_tpu_torch.ops.selective_scan_cuda import (
        selective_scan_bidir, selective_scan_bidir_bwd)
    g = torch.Generator(device=dev).manual_seed(2)
    delay = queued_delay(dev)
    rows, steps = [], {}
    for batch in batches:
        steps[batch] = 0.0
        for L, Dim in stages:
            sets = []
            for _ in range(6):
                args = scan_operands(g, L, Dim, dev, batch=batch)
                ck = selective_scan_bidir(*args, emit_ckpt=True)[2:]
                sets.append((*args, *ck, *_train_grads(g, L, Dim, dev,
                                                       batch)))
            selective_scan_bidir_bwd(*sets[0])
            ms = cuda_ms_queued(selective_scan_bidir_bwd, sets[1:], delay)
            b_ms, _ = bound(cost.scan_bidir_bwd(L, batch * 2 * Dim,
                                                batch * 2))
            rows.append({"B": batch, "L": L, "Dim": Dim, "ms": ms,
                         "bound_ms": b_ms})
            steps[batch] += 4 * ms
            del sets
    res = {"stages": rows, "per_step_ms": steps}
    print("K3 stage times: " + json.dumps(res), flush=True)
    return res


# parameters whose gradient is zero in exact arithmetic: a bias right
# before a train-mode BatchNorm (its shift is removed by the batch mean);
# JAX leaves them at zero too, and fp32 roundoff is all either side holds
ZERO_GRAD_PARAMS = ("detector_head.Conv_0.bias",
                    "descriptor_head.Conv_0.bias",
                    "detector_head.ConvBNRelu_0.BatchNorm_0.bias",
                    "descriptor_head.ConvBNRelu_0.BatchNorm_0.bias")


# launches per train step by forward type (and d_state, where not 1), as
# the code predicts: 16 SS2D blocks a step (8 blocks x 2 images); v05_noz
# runs K1 with checkpoints forward and K3 backward; v052d_noz and xv1a run
# K5 forward and, in each block's backward, K6 once to rebuild h and once
# reversed; xv1a with d_state 16 runs the general scan, K6 once forward and
# once reversed in the backward; m0_noz's SSD scan is products, no kernel
_NO_SCAN = {"selective_scan_bidir": 0, "selective_scan_bidir_bwd": 0,
            "selective_scan_fused": 0, "linear_scan": 0}
TRAIN_LAUNCHES = {
    None: dict(_NO_SCAN, selective_scan_bidir=16,
               selective_scan_bidir_bwd=16),
    "v052d_noz": dict(_NO_SCAN, selective_scan_fused=16, linear_scan=32),
    "xv1a": dict(_NO_SCAN, selective_scan_fused=16, linear_scan=32),
    ("xv1a", 16): dict(_NO_SCAN, linear_scan=32),
    "m0_noz": dict(_NO_SCAN)}


def phase_train(dev, forward_type=None, n_steps=TRAIN_STEPS, d_state=None,
                sync_check=False):
    """The flagship train step (with ``forward_type`` in place of v05_noz
    and ``d_state`` in place of 1) on the resident synthetic corpus, as
    xpoint_tpu_torch.train.profile_step builds and profiles it; with
    ``sync_check`` every step runs under
    torch.cuda.set_sync_debug_mode("error")."""
    from xpoint_tpu_torch.train.profile_step import flagship_train
    tag = forward_type or "v05_noz"
    if d_state is not None:
        tag = f"{tag}, d_state {d_state}"
    t0 = time.time()
    state, step, data, meta = flagship_train(dev, forward_type, d_state)
    init_s = time.time() - t0
    gen = torch.Generator(device=dev).manual_seed(0)
    idx_gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    read = _zero_counts()
    per_step, ms = [], []
    for i in range(n_steps):
        idx = torch.randperm(meta["n"], generator=idx_gen,
                             device=dev)[:TRAIN_B]
        t1 = time.perf_counter()
        if sync_check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            comps = step(state, {"data": data, "idx": idx}, gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        row = {k: float(v) for k, v in comps.items()}
        per_step.append(row)
        print(f"train step {i + 1} ({tag}): ms={ms[-1]:.3f} "
              f"loss={row['loss']} "
              f"skipped_nonfinite={row['skipped_nonfinite']} " + " ".join(
                  f"{k}={v:.5g}" for k, v in row.items()
                  if k not in ("loss", "skipped_nonfinite")), flush=True)
        if not math.isfinite(row["loss"]) or row["skipped_nonfinite"]:
            raise SystemExit(f"train step {i + 1} ({tag}): non-finite loss "
                             f"or a skipped step")
    expect = TRAIN_LAUNCHES[forward_type if d_state is None
                            else (forward_type, d_state)]
    launches = {k: v for k, v in read().items() if k in expect}
    for name, n in launches.items():
        if n != expect[name] * n_steps:
            raise SystemExit(f"{tag} train path launched {name} {n} times, "
                             f"expected {expect[name]} per step")
    # every parameter that should get a gradient got a finite, non-zero
    # one: Adam's first moment is an average of them
    mu = dict(zip(state.names, state.opt_state["mu"]))
    bad = [n for n, m in mu.items() if not bool(torch.isfinite(m).all())]
    zero = sorted(n for n, m in mu.items() if float(m.abs().max()) == 0.0)
    if bad or set(zero) - set(ZERO_GRAD_PARAMS):
        raise SystemExit(f"gradients: non-finite {bad}, zero "
                         f"{sorted(set(zero) - set(ZERO_GRAD_PARAMS))}")
    step_ms = sorted(ms[1:])[len(ms[1:]) // 2]
    res = {"init_s": init_s, "step_ms": step_ms, "step_ms_all": ms,
           "samples_per_s": TRAIN_B / step_ms * 1e3,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches,
           "launches_per_step": {k: v / n_steps
                                 for k, v in launches.items()},
           "zero_grad_params": zero, "steps": per_step,
           "n_params": sum(m.numel() for m in mu.values()),
           "sync_checked": sync_check}
    print(f"train path {tag} {TRAIN_S}^2 B={TRAIN_B} bf16: "
          f"step_ms={step_ms} "
          f"samples_per_s={res['samples_per_s']} peak_mem_gib="
          f"{res['peak_mem_gib']} launches={launches} params="
          f"{res['n_params']} exactly-zero-gradient params={zero}",
          flush=True)
    return res


def phase_train_reference(dev, forward_type=None, d_state=1, ran=()):
    """The tiny fp32 train step (no DropPath, no HM head; ``forward_type``
    and ``d_state`` in place of v05_noz and 1) on the card and
    on the CPU from the same weights and batch: the loss within rtol 1e-4,
    every gradient (Adam's first moment after one step, 0.1 g) within 1e-3
    of its leaf's max |g| + 1e-6 of the largest (fp32 sums in other
    orders: cuBLAS/cuDNN with TF32 off, K3's atomics, K6's segments). The
    card's step must launch every kernel named in ``ran``."""
    from xpoint_tpu_torch.losses import XPointLoss
    from xpoint_tpu_torch.models import VMAMBA_MODEL_CFG, build_xpoint
    from xpoint_tpu_torch.train import (TrainState, make_optimizer,
                                        make_train_step)
    cfg = copy.deepcopy(VMAMBA_MODEL_CFG)
    mp = cfg["use_attention"]["model_parameters"]["MODEL"]
    mp["VSSM"].update(DEPTHS=[1, 1, 1, 1], EMBED_DIM=24,
                      SSM_D_STATE=d_state)
    if forward_type is not None:
        mp["VSSM"]["SSM_FORWARDTYPE"] = forward_type
    tag = f"{forward_type or 'v05_noz'}, d_state {d_state}"
    mp["DROP_PATH_RATE"] = 0.0
    cfg.update(descriptor_size=32, mixed_precision=False,
               homography_regression_head={"check": False})
    loss_cfg = {"detector_dustbin_loss_weight": 0.025,
                "descriptor_loss_threshold": 4.0, "lambda": 1.0,
                "hard_negative_weighting": {"check": True}}
    g = torch.Generator().manual_seed(3)
    S, nb = 64, 2
    kp = (torch.rand(nb, S, S, generator=g) < 0.01).float()
    batch = {side: {"image": torch.rand(nb, S, S, 1, generator=g),
                    "keypoints": kp, "valid_mask": torch.ones(nb, S, S),
                    "homography": torch.eye(3).expand(nb, 3, 3).clone()}
             for side in ("optical", "thermal")}
    batch["thermal"]["homography"][:, 0, 2] = 3.0
    out = []
    read = _zero_counts()
    for d in ("cpu", dev):
        m, _ = build_xpoint(cfg, device=d, seed=4)
        st = TrainState(m, make_optimizer({"learningrate": 1e-4})[0])
        b = {k: {kk: vv.to(d) for kk, vv in v.items()}
             for k, v in batch.items()}
        comps = make_train_step(m, XPointLoss(loss_cfg))(
            st, b, torch.Generator(device=d).manual_seed(0))
        out.append((float(comps["loss"]),
                    {n: t.cpu() for n, t in zip(st.names,
                                                st.opt_state["mu"])}))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out
    top = max(float(t.abs().max()) for t in g_cpu.values())
    worst = max(float((g_gpu[n] - g_cpu[n]).abs().max())
                / (float(g_cpu[n].abs().max()) + 1e-3 * top) for n in g_cpu)
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    counts = {k: v for k, v in read().items() if v}
    print(f"train reference (tiny fp32 {tag}, card vs CPU): loss {l_gpu} vs "
          f"{l_cpu} (rel {loss_rel:.3g}); worst gradient error "
          f"{worst:.3g} of (leaf max + 1e-3 x largest); launches {counts}",
          flush=True)
    if loss_rel > 1e-4 or worst > 1e-3:
        raise SystemExit(f"the card's train step ({tag}) disagrees with the "
                         f"CPU's")
    if any(k not in counts for k in ran):
        raise SystemExit(f"the card's train step ({tag}) launched {counts}, "
                         f"expected every one of {ran}")
    return {"forward_type": forward_type or "v05_noz", "d_state": d_state,
            "loss_gpu": l_gpu, "loss_cpu": l_cpu, "loss_rel_err": loss_rel,
            "grad_err": worst, "launches": counts}


HA_S, HA_WB = 512, 8            # the HA image size and warps per step


def _ha_homography_sets(n_sets, dev, S=HA_S, n=HA_WB):
    """n_sets stacks of n fp32 homographies at S^2: n - 2 from the HA
    sampler (max_angle pi), a rotation 0.05 rad short of 90 degrees about
    the image centre, and the identity."""
    from xpoint_tpu_torch.geometry.homography import sample_homography
    from xpoint_tpu_torch.selfsup.homographic_adaptation import (
        HA_DEFAULT_CONFIG)
    rng = np.random.default_rng(9)
    c, th = (S - 1) / 2.0, math.pi / 2 - 0.05
    rot = np.array([[math.cos(th), -math.sin(th), 0],
                    [math.sin(th), math.cos(th), 0], [0, 0, 1]])
    shift = np.array([[1, 0, c], [0, 1, c], [0, 0, 1]])
    near90 = shift @ rot @ np.linalg.inv(shift)
    sets = []
    for _ in range(n_sets):
        hs = [sample_homography((S, S), rng=rng,
                                **HA_DEFAULT_CONFIG["homographies"])
              for _ in range(n - 2)] + [near90, np.eye(3)]
        sets.append(torch.from_numpy(np.stack(hs).astype(np.float32)).to(dev))
    return sets


K4_CALLS = (("image warp", True, "bilinear", "reflection", 2),
            ("prob unwarp", False, "bilinear", "zeros", 1),
            ("prob unwarp, 2 maps", False, "bilinear", "zeros", 2),
            ("mask unwarp", False, "nearest", "zeros", 1))


def phase_warp(dev, S=HA_S, n=HA_WB, calls=K4_CALLS, odd_size=True,
               turns=False):
    """K4 against its plain version at the calls of one HA step (n warps
    at S^2), then at an odd size. With ``turns`` the kernel and
    F.grid_sample are also timed in turns (kernel, library, library,
    kernel, each a median over the 5 timing sets), so that both see the
    same state of the card."""
    import torch.nn.functional as F
    from xpoint_tpu_torch.geometry.homography import (
        compute_valid_mask_device)
    from xpoint_tpu_torch.kernels import cost
    from xpoint_tpu_torch.ops.warp import (_source_coords_from_inverse,
                                           inverse_homographies,
                                           multi_source, warp_from_inverse)
    from xpoint_tpu_torch.ops.warp_projective import (warp_batch,
                                                      warp_projective)
    g = torch.Generator(device=dev).manual_seed(3)
    h_sets = _ha_homography_sets(6, dev, S, n)
    delay = queued_delay(dev)
    rows = []
    for name, multi, mode, padding, C in calls:
        inputs = []
        for hs in h_sets:
            if multi:
                img, hinv = torch.rand(1, S, S, C, generator=g,
                                       device=dev), inverse_homographies(hs)
            else:
                # HA unwarps by the inverse homographies: the sampling
                # matrix is the inverse of the inverse
                hinv = inverse_homographies(torch.linalg.inv(hs))
                img = (compute_valid_mask_device(hs, (S, S), 5, True)[
                    ..., None] if mode == "nearest" else
                    torch.rand(n, S, S, C, generator=g, device=dev))
            inputs.append((img.contiguous(), hinv))
        kernel = lambda img, hinv: warp_projective(  # noqa: E731
            img, hinv, mode, padding, multi)
        plain = lambda img, hinv: warp_from_inverse(  # noqa: E731
            multi_source(img, n) if multi else img, hinv, mode, padding)
        # the library's form: grid_sample on channels-first images and the
        # normalised source coordinates, both prepared outside its time
        library = lambda x, gr: F.grid_sample(  # noqa: E731
            x, gr, mode=mode, padding_mode=padding, align_corners=True)

        def norm_grid(hinv):
            ys, xs = _source_coords_from_inverse(hinv, S, S)
            return torch.stack([xs / (S - 1) * 2 - 1, ys / (S - 1) * 2 - 1],
                               -1).reshape(n, S, S, 2)

        # what the library costs from the kernel's own inputs: the grid
        # built from hinv inside the timed call
        library_with_grid = lambda x, hinv: library(  # noqa: E731
            x, norm_grid(hinv))
        grids, with_grid = [], []
        for img, hinv in inputs:
            x = img.permute(0, 3, 1, 2).contiguous()
            x = x.expand(n, C, S, S) if multi else x
            grids.append((x, norm_grid(hinv)))
            with_grid.append((x, hinv))
        out = kernel(*inputs[0])
        ref = plain(*inputs[0])
        lib = library(*grids[0]).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        if multi:
            ref = ref.reshape(n, S, S, 1, C).permute(0, 3, 1, 2, 4)
            lib = lib.reshape(n, 1, S, S, C)
        err = float((out - ref).abs().max())
        n_diff = int((out != ref).sum())
        finite = bool(torch.isfinite(out).all())
        # grid_sample's coordinates pass through the normalisation, a few
        # ulps away from the kernel's: held loosely, to show that it is the
        # same function that is timed
        lib_mean = float((out - lib).abs().mean())
        lib_max = float((out - lib).abs().max())
        lib_share = float((out != lib).float().mean())
        ms = cuda_ms_queued(kernel, inputs[1:], delay)
        launch_ms = cuda_ms(kernel, inputs[1:])     # host launch path incl.
        plain_ms = cuda_ms_queued(plain, inputs[1:4], delay)
        library_ms = cuda_ms_queued(library, grids[1:], delay)
        library_with_grid_ms = cuda_ms_queued(library_with_grid,
                                              with_grid[1:], delay)
        in_turns = None
        if turns:
            in_turns = {"kernel_ms": [], "library_ms": []}
            for who in ("kernel_ms", "library_ms", "library_ms",
                        "kernel_ms"):
                fn, sets = ((kernel, inputs[1:]) if who == "kernel_ms"
                            else (library, grids[1:]))
                in_turns[who].append(cuda_ms_queued(fn, sets, delay))
        # the whole entry point (inverse included), for the record
        entry_ms = None if multi else cuda_ms(
            lambda img, hs: warp_batch(img, hs, mode, padding),
            [(i[0], torch.linalg.inv(hs)) for i, hs in
             zip(inputs[1:], h_sets[1:])])
        n_src = inputs[0][0].numel()
        b_ms, b_by = bound(cost.warp(n_src, out.numel(), n, S, S))
        rows.append({"call": name, "multi": multi, "mode": mode,
                     "padding": padding, "src": list(inputs[0][0].shape),
                     "out": list(out.shape), "max_abs_err": err,
                     "n_diff": n_diff, "ms": ms,
                     "ms_with_host_launch": launch_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms,
                     "library_with_grid_ms": library_with_grid_ms,
                     "library_mean_abs_diff": lib_mean,
                     "library_max_abs_diff": lib_max,
                     "library_share_differing": lib_share,
                     "entry_point_ms": entry_ms, "in_turns": in_turns})
        print(f"K4 {name} {mode}/{padding} {list(inputs[0][0].shape)} x {n} "
              f"-> {list(out.shape)}: max_abs_err={err} differing={n_diff} "
              f"kernel_ms={ms} (with the host's launch path {launch_ms}) "
              f"plain_ms={plain_ms} bound_ms={b_ms} ({b_by}) "
              f"library_ms={library_ms} library_with_grid_ms="
              f"{library_with_grid_ms} (grid_sample against the kernel: "
              f"mean {lib_mean} max {lib_max} share differing {lib_share}) "
              f"entry_point_ms={entry_ms}"
              + (f" in turns {in_turns}" if turns else ""), flush=True)
        if not finite or (n_diff if mode == "nearest" else err > 1e-5):
            raise SystemExit(f"K4 disagrees with its plain version in the "
                             f"{name}: {err}, {n_diff} values differ")
        if lib_share > 1e-2 if mode == "nearest" else lib_mean > 1e-3:
            raise SystemExit(f"grid_sample does not compute the {name}: "
                             f"mean {lib_mean}, share {lib_share}")
    return rows, (warp_odd_size_check(g, dev) if odd_size else None)


def warp_odd_size_check(g, dev):
    """K4's bilinear calls at 301 x 511 (rows that are no multiple of a
    thread's 4 pixels, so the scalar stores run; neither side a multiple of
    the 32 x 8 tile) against the plain version, limit 1e-5."""
    from xpoint_tpu_torch.geometry.homography import sample_homography
    from xpoint_tpu_torch.ops.warp import warp_image_batch, warp_image_multi
    from xpoint_tpu_torch.ops.warp_projective import warp_batch, warp_multi
    from xpoint_tpu_torch.selfsup.homographic_adaptation import (
        HA_DEFAULT_CONFIG)
    Ho, Wo, n = 301, 511, HA_WB
    rng = np.random.default_rng(10)
    hs = torch.from_numpy(np.stack([
        sample_homography((Ho, Wo), rng=rng,
                          **HA_DEFAULT_CONFIG["homographies"])
        for _ in range(n)]).astype(np.float32)).to(dev)
    errs = {}
    for name, kernel, plain, shape, padding in (
            ("image warp", warp_multi, warp_image_multi, (1, Ho, Wo, 2),
             "reflection"),
            ("prob unwarp", warp_batch, warp_image_batch, (n, Ho, Wo, 1),
             "zeros"),
            ("prob unwarp, 2 maps", warp_batch, warp_image_batch,
             (n, Ho, Wo, 2), "zeros")):
        img = torch.rand(*shape, generator=g, device=dev)
        out = kernel(img, hs, "bilinear", padding)
        ref = plain(img, hs, "bilinear", padding)
        torch.cuda.synchronize()
        errs[name] = float((out - ref).abs().max())
        if (out.shape != ref.shape or not bool(torch.isfinite(out).all())
                or errs[name] > 1e-5):
            raise SystemExit(f"K4 disagrees with its plain version in the "
                             f"{name} at {Ho}x{Wo}: {errs[name]}")
    print(f"K4 bilinear at {Ho}x{Wo} x {n}: max_abs_err {errs}", flush=True)
    return {"size": [Ho, Wo], "max_abs_err": errs}


def _zero_counts():
    """Set every kernel wrapper's launch count to 0; returns the function
    that reads them."""
    import importlib
    from xpoint_tpu_torch.obs import KERNEL_COUNTERS
    fns = {name: getattr(importlib.import_module(mod), fn)
           for name, (mod, fn) in KERNEL_COUNTERS.items()}
    for f in fns.values():
        f.launches = 0
    return lambda: {k: f.launches for k, f in fns.items()}


def phase_ha(dev):
    """HA at full width, then the label export (see the module docstring)."""
    from xpoint_tpu_torch.eval.infer import XPointInference
    from xpoint_tpu_torch.selfsup.export import NumpySink, export_keypoints
    from xpoint_tpu_torch.selfsup.homographic_adaptation import (
        EXPORT_HA_CONFIG, EXPORT_PREDICTION_CONFIG)
    from xpoint_tpu_torch.selfsup.profile_ha import flagship_ha
    module, sample_fn, cfg, dataset = flagship_ha(dev)
    infer = XPointInference(module, EXPORT_PREDICTION_CONFIG)
    rng = np.random.default_rng(0)
    n_warps = cfg["num"] - 1
    chunks = -(-n_warps // HA_WB)
    # per sample: three warps a chunk; 8 SS2D blocks a forward, two forwards
    # for the originals and two a chunk
    expect = {"warp_projective": 3 * chunks,
              "selective_scan_bidir": 8 * 2 * (1 + chunks)}
    sample_fn(0, rng)                                       # warm-up
    torch.cuda.synchronize()
    samples = []
    for i in (1, 2, 3):
        read = _zero_counts()
        t0 = time.perf_counter()
        out = sample_fn(i, rng)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        prob, count = out["prob"], out["count"]
        kps = infer.keypoints_from_prob(infer.nms(prob)[0])
        counts = read()
        row = {"seconds": sec, "forwards_per_s": 2 * cfg["num"] / sec,
               "prob_max": float(prob.max()), "prob_mean": float(prob.mean()),
               "count_max": float(count.max()),
               "count_min": float(count.min()), "keypoints": len(kps),
               "nms_launches": counts["nms_sweep"], "launches": counts}
        samples.append(row)
        print(f"HA sample {i} ({HA_S}^2, num {cfg['num']}, "
              f"{cfg['aggregation']}): {row}", flush=True)
        ok = (bool(torch.isfinite(prob).all()) and float(prob.min()) >= 0
              and float(prob.max()) <= 1 and float(prob.max()) > 0
              and cfg["min_count"] <= row["count_max"] <= cfg["num"]
              and len(kps) > 0 and row["nms_launches"] == 1)
        if not ok or any(counts[k] != v for k, v in expect.items()):
            raise SystemExit(f"HA sample {i} failed its checks (expected "
                             f"launches {expect})")

    # the label export with the export settings
    n_exp = 3
    exp_chunks = -(-(EXPORT_HA_CONFIG["num"] - 1) // HA_WB)
    sink = NumpySink()
    kw = dict(ha_config=EXPORT_HA_CONFIG,
              prediction_config=EXPORT_PREDICTION_CONFIG, seed=0)
    export_keypoints(module, dataset, sink, max_samples=1, **kw)  # warm-up
    torch.cuda.synchronize()
    read = _zero_counts()
    t0 = time.perf_counter()
    n_done = export_keypoints(module, dataset, sink, max_samples=n_exp, **kw)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / max(n_done, 1)
    counts = read()
    exp_expect = {"warp_projective": 3 * exp_chunks * n_done,
                  "selective_scan_bidir": 8 * 2 * (1 + exp_chunks) * n_done}
    n_kps = {n: {k: len(v) for k, v in g.items()}
             for n, g in sink.groups.items()}
    print(f"HA export ({HA_S}^2, num {EXPORT_HA_CONFIG['num']}, window): "
          f"{n_done} samples, {sec} s/sample, launches {counts}, keypoints "
          f"{n_kps}", flush=True)
    if (n_done != n_exp - 1 or len(n_kps) != n_exp
            or any(v == 0 for g in n_kps.values() for v in g.values())
            or sorted(next(iter(n_kps.values()))) != ["keypoints_optical",
                                                      "keypoints_thermal"]
            or any(counts[k] != v for k, v in exp_expect.items())
            or counts["nms_sweep"] != 2 * n_done):
        raise SystemExit(f"HA export failed its checks (expected launches "
                         f"{exp_expect})")
    sec_med = sorted(r["seconds"] for r in samples)[len(samples) // 2]
    launches = {k: sum(r["launches"][k] for r in samples) + counts[k]
                for k in counts}
    return {"num": cfg["num"], "chunks": chunks, "samples": samples,
            "seconds_per_sample": sec_med,
            "forwards_per_s": 2 * cfg["num"] / sec_med,
            "launches_per_sample": expect,
            "export": {"samples": n_done, "seconds_per_sample": sec,
                       "launches": counts, "keypoints": n_kps},
            "launches": launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def fused_operands(g, L, Dim, dev, batch=B):
    """bf16 operands of the single-direction scan at one stage shape; the
    constants are the flagship's initialisation, as scan_operands'."""
    bf = torch.bfloat16
    r = lambda *s: (torch.randn(*s, generator=g, device=dev)  # noqa: E731
                    * 0.5).to(bf)
    u, dt = r(batch, 4, L, Dim), r(batch, 4, L, Dim)
    bs, cs = r(batch, 4, L, 1), r(batch, 4, L, 1)
    A = -torch.ones(4 * Dim, device=dev)
    D = torch.ones(4 * Dim, device=dev)
    lo, hi = math.log(0.001), math.log(0.1)
    dt0 = torch.exp(torch.rand(4 * Dim, generator=g, device=dev) * (hi - lo)
                    + lo)
    return u, dt, A, bs, cs, D, dt0 + torch.log(-torch.expm1(-dt0))


def phase_fused_scan(dev, stages, blocks_per_stage, batch=B):
    """K5 against its plain version at the stage shapes of one path: limit
    2e-2 (one bf16 ulp), a second run on the same inputs bit for bit; device
    time behind queued work (``ms``) and with the host's launch path."""
    from xpoint_tpu_torch.kernels import cost
    from xpoint_tpu_torch.ops.selective_scan_cuda import (
        selective_scan_fused_bkld, selective_scan_fused_bkld_plain)
    g = torch.Generator(device=dev).manual_seed(5)
    rows, tot = [], {"ms": 0.0, "ms_with_host_launch": 0.0, "plain_ms": 0.0,
                     "bound_ms": 0.0}
    max_err = 0.0
    delay = queued_delay(dev)
    with torch.no_grad():
        for (L, Dim), n_launch in zip(stages, blocks_per_stage):
            inputs = [fused_operands(g, L, Dim, dev, batch)
                      for _ in range(6)]
            y = selective_scan_fused_bkld(*inputs[0])
            same = torch.equal(y, selective_scan_fused_bkld(*inputs[0]))
            p = selective_scan_fused_bkld_plain(*inputs[0])
            torch.cuda.synchronize()
            err = float((y.float() - p.float()).abs().max())
            finite = bool(torch.isfinite(y).all())
            ms = cuda_ms_queued(selective_scan_fused_bkld, inputs[1:], delay)
            launch_ms = cuda_ms(selective_scan_fused_bkld, inputs[1:])
            plain_ms = cuda_ms(selective_scan_fused_bkld_plain, inputs[1:3])
            M, G = batch * 4 * Dim, batch * 4
            b_ms, b_by = bound(cost.scan_fused(L, M, G, Dim))
            rows.append({"L": L, "Dim": Dim, "M": M, "max_abs_err": err,
                         "bit_equal_repeat": same, "ms": ms,
                         "ms_with_host_launch": launch_ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "launches_per_call": n_launch})
            print(f"K5 B={batch} L={L} Dim={Dim} M={M}: max_abs_err={err} "
                  f"bit-equal repeat={same} kernel_ms={ms} (with the "
                  f"host's launch path {launch_ms}) plain_ms={plain_ms} "
                  f"bound_ms={b_ms} ({b_by})", flush=True)
            if not finite or err > 2e-2 or not same:
                raise SystemExit(f"K5 disagrees with its plain version at "
                                 f"L={L} Dim={Dim}: {err} repeat {same}")
            max_err = max(max_err, err)
            tot["ms"] += ms * n_launch
            tot["ms_with_host_launch"] += launch_ms * n_launch
            tot["plain_ms"] += plain_ms * n_launch
            tot["bound_ms"] += b_ms * n_launch
            del inputs
        tails = fused_tail_checks(g, dev)
    return rows, tot, max(max_err, tails["max_abs_err"]), tails


def fused_tail_checks(g, dev):
    """K5 where its blocks have tails: L = 300 (five spans of 64 tokens, the
    last of 44) and L = 64 (one span: pass 3 alone) with B = 3, Dim = 40
    (a (b, k) group of 40 d: one full 32-lane block and one of 8), bf16:
    against the plain version (2e-2) and a second run bit for bit."""
    from xpoint_tpu_torch.ops.selective_scan_cuda import (
        selective_scan_fused_bkld, selective_scan_fused_bkld_plain)
    res = {"shapes": [], "max_abs_err": 0.0}
    for L in (300, 64):
        args = fused_operands(g, L, 40, dev, batch=3)
        y = selective_scan_fused_bkld(*args)
        same = torch.equal(y, selective_scan_fused_bkld(*args))
        err = float((y.float() - selective_scan_fused_bkld_plain(*args)
                     .float()).abs().max())
        print(f"K5 tails L={L} B=3 Dim=40: max_abs_err={err} bit-equal "
              f"repeat={same}", flush=True)
        if not same or err > 2e-2 or not bool(torch.isfinite(y).all()):
            raise SystemExit(f"K5 fails at the tail shape L={L}: {err} "
                             f"repeat {same}")
        res["shapes"].append([L, 3, 40])
        res["max_abs_err"] = max(res["max_abs_err"], err)
    return res


def recurrence_operands(g, shape, dev):
    """fp32 planes of the linear recurrence as the selective scan forms
    them: a = exp(-delta) in (0, 1] with delta = softplus(0.5 n + bias), bias
    from the flagship's log-uniform dt initialisation, and b = 0.1 n."""
    lo, hi = math.log(0.001), math.log(0.1)
    dt0 = torch.exp(torch.rand(shape[-1], generator=g, device=dev)
                    * (hi - lo) + lo)
    delta = torch.nn.functional.softplus(
        torch.randn(shape, generator=g, device=dev) * 0.5
        + dt0 + torch.log(-torch.expm1(-dt0)))
    return (torch.exp(-delta),
            torch.randn(shape, generator=g, device=dev) * 0.1)


def phase_linear_scan(dev, stages, blocks_per_stage, cases=None, n_sets=6):
    """K6 against its plain version: forward and reversed-shifted at the
    shapes the v052d_noz train step gives it, and in the time-major layout
    of the general (N > 1) scan; or at ``cases`` ((shape, scanned dim,
    launches a step in each direction, name)), with ``n_sets`` input sets
    (the first checked, the rest timed)."""
    from xpoint_tpu_torch.kernels import cost
    from xpoint_tpu_torch.ops.linear_scan import (linear_scan_launch,
                                                  linear_scan_plain)
    g = torch.Generator(device=dev).manual_seed(7)
    if cases is None:
        cases = [((TRAIN_B, 4, L, Dim), 2, n, f"train L={L} Dim={Dim}")
                 for (L, Dim), n in zip(stages, blocks_per_stage)]
        # the general scan at the first stage with d_state 4, B=4: (L, M)
        # planes with M = B * 4 * Dim * N lanes, as many as the first train
        # shape has
        L0, Dim0 = stages[0]
        cases.append(((L0, 4 * 4 * Dim0 * 4), 0, 0,
                      f"N=4 B=4 L={L0} Dim={Dim0}"))
    rows, max_err = [], 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    delay = queued_delay(dev)
    for shape, dim, n_launch, name in cases:
        inputs = [recurrence_operands(g, shape, dev) for _ in range(n_sets)]
        L, M = shape[dim], math.prod(shape) // shape[dim]
        b_ms, b_by = bound(cost.linear_scan(L, M))
        row = {"case": name, "shape": list(shape), "dim": dim, "L": L,
               "M": M, "bound_ms": b_ms, "bound_by": b_by,
               "launches_per_train_step": 2 * n_launch}
        for tag, kw in (("fwd", {}), ("rev", {"reverse": True, "shift": 1})):
            h = linear_scan_launch(*inputs[0], dim=dim, **kw)
            p = linear_scan_plain(*inputs[0], dim=dim, **kw)
            torch.cuda.synchronize()
            err, top = float((h - p).abs().max()), float(p.abs().max())
            # device time: a launch takes tens of microseconds, as long as
            # the host's path to it
            ms = cuda_ms_queued(lambda a, b: linear_scan_launch(
                a, b, dim=dim, **kw), inputs[1:], delay)
            plain_ms = cuda_ms(lambda a, b: linear_scan_plain(
                a, b, dim=dim, **kw), inputs[1:2])
            row.update({f"{tag}_max_abs_err": err, f"{tag}_max_plain": top,
                        f"{tag}_ms": ms, f"{tag}_plain_ms": plain_ms})
            print(f"K6 {name} {tag} shape={list(shape)} dim={dim} M={M}: "
                  f"max_abs_err={err} (max |plain| {top}) kernel_ms={ms} "
                  f"plain_ms={plain_ms} bound_ms={b_ms} ({b_by})", flush=True)
            if not bool(torch.isfinite(h).all()) or err > 1e-5 * top:
                raise SystemExit(f"K6 disagrees with its plain version at "
                                 f"{name} {tag}: {err} of {top}")
            max_err = max(max_err, err)
            tot["ms"] += ms * n_launch
            tot["plain_ms"] += plain_ms * n_launch
            tot["bound_ms"] += b_ms * n_launch
        rows.append(row)
        del inputs
    return rows, tot, max_err


def phase_bidi_path(dev):
    """The v052d_noz model at the flagship's width and depth through the
    serving pipeline."""
    from xpoint_tpu_torch.eval import make_pair_pipeline
    from xpoint_tpu_torch.models import VMAMBA_MODEL_CFG, build_xpoint
    cfg = copy.deepcopy(VMAMBA_MODEL_CFG)
    cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"][
        "SSM_FORWARDTYPE"] = "v052d_noz"
    module, _ = build_xpoint(cfg, device=dev, seed=0)
    run = make_pair_pipeline(module, (H, W), k=1024, nms_size=8,
                             detection_threshold=0.015)
    g = torch.Generator(device=dev).manual_seed(6)
    images = [(torch.rand(B, H, W, 1, generator=g, device=dev),
               torch.rand(B, H, W, 1, generator=g, device=dev))
              for _ in range(4)]
    run(*images[0])                                          # warm-up
    torch.cuda.synchronize()
    read = _zero_counts()
    lat = []
    for img_o, img_t in images[1:]:
        t0 = time.perf_counter()
        out = run(img_o, img_t)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        for key, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise SystemExit(f"v052d_noz path: non-finite {key}")
    counts = read()
    n_calls = len(images) - 1
    if (counts["selective_scan_fused"] != 16 * n_calls
            or counts["selective_scan_bidir"] != 0
            or counts["nms_sweep"] != n_calls
            or tuple(out["prob_optical"].shape) != (B, H, W)):
        raise SystemExit(f"v052d_noz path: launches {counts}, expected 16 "
                         f"selective_scan_fused and 1 nms_sweep per call")
    lat_ms = sorted(lat)[len(lat) // 2]
    res = {"latency_ms": lat_ms, "latency_all_ms": lat,
           "pairs_per_s": B / lat_ms * 1e3, "launches": counts,
           "k5_launches_per_call": counts["selective_scan_fused"] / n_calls,
           "matches": int(out["matched"].sum())}
    print(f"v052d_noz path 512^2 B={B}: {res}", flush=True)
    return res


def phase_ha_reference(dev):
    """The tiny fp32 model's HA on the card against the CPU. The two invert
    the homographies with different last bits, so a mask pixel can flip and
    move that pixel's count; the maps are compared where the counts agree."""
    from xpoint_tpu_torch.eval.infer import XPointInference
    from xpoint_tpu_torch.models import VMAMBA_MODEL_CFG, build_xpoint
    from xpoint_tpu_torch.selfsup.export import make_prob_fn
    from xpoint_tpu_torch.selfsup.homographic_adaptation import (
        make_ha_fn, sample_ha_homographies)
    cfg = copy.deepcopy(VMAMBA_MODEL_CFG)
    cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"].update(
        DEPTHS=[1, 1, 1, 1], EMBED_DIM=24)
    cfg.update(descriptor_size=32, mixed_precision=False)
    ha_cfg = {"aggregation": "prod", "num": 5, "erosion_radius": 2}
    g = torch.Generator().manual_seed(0)
    img_o, img_t = (torch.rand(2, 64, 64, 1, generator=g) for _ in range(2))
    outs = []
    for d in ("cpu", dev):
        m, _ = build_xpoint(cfg, device=d)
        run, merged = make_ha_fn(make_prob_fn(m), ha_cfg)
        hs = torch.from_numpy(sample_ha_homographies(
            merged, (64, 64), np.random.default_rng(1)))
        out = run(img_o.to(d), img_t.to(d), hs.to(d))
        infer = XPointInference(m, {"detection_threshold": 0.001, "nms": 4})
        nms = infer.nms(out["prob"])
        outs.append((out["prob"].cpu(), out["count"].cpu(),
                     [{tuple(p) for p in infer.keypoints_from_prob(x)}
                      for x in nms]))
    (p_cpu, c_cpu, k_cpu), (p_gpu, c_gpu, k_gpu) = outs
    same = c_cpu == c_gpu
    err = float((p_cpu - p_gpu)[same].abs().max())
    n_kp = sum(len(a | b) for a, b in zip(k_cpu, k_gpu))
    n_kp_diff = sum(len(a ^ b) for a, b in zip(k_cpu, k_gpu))
    res = {"prob_max_abs_err": err, "prob_max": float(p_cpu.max()),
           "count_differs_px": int((~same).sum()), "pixels": same.numel(),
           "keypoints": n_kp, "keypoints_differing": n_kp_diff}
    print(f"HA reference (tiny fp32, card vs CPU): {res}", flush=True)
    if (err > 1e-4 or (~same).float().mean() > 5e-3 or n_kp == 0
            or n_kp_diff > 0.05 * n_kp):
        raise SystemExit("the card's HA disagrees with the CPU's")
    return res


# The full cycle's configurations (tools/full_cycle.py SYNTH_CFG,
# EXPORT_CFG and PAIR_CFG at its defaults, with --multispectral), own
# copies. The synthetic pretrain generates SyntheticShapes on the fly with
# the dataset section of configs/config_synthetic_shapes.yaml (the cycle
# replays them from an HDF5 file, which the card's machine cannot open: no
# h5py there); the pair corpora are seeded ones made here.
SYNTH_N, SYNTH_HW = 256, (240, 320)  # 16 steps an epoch; SyntheticShapes'
SYNTH_CFG = {
    "dataset": {
        "type": "SyntheticShapes", "primitives": "all", "length": SYNTH_N,
        "generation_size": [960, 1280], "image_size": list(SYNTH_HW),
        "processing": {"blur_size": 21, "additional_ir_blur": True,
                       "additional_ir_blur_size": 51},
        "augmentation": {
            "photometric": {
                "enable": True,
                "primitives": ["random_brightness", "random_contrast",
                               "additive_speckle_noise",
                               "additive_gaussian_noise", "additive_shade",
                               "motion_blur"],
                "params": {
                    "random_brightness": {"max_abs_change": 0.15},
                    "random_contrast": {"strength_range": [0.3, 1.8]},
                    "additive_gaussian_noise": {"stddev_range": [0, 0.06]},
                    "additive_speckle_noise": {"prob_range": [0, 0.0035]},
                    "additive_shade": {"transparency_range": [-0.5, 0.8],
                                       "kernel_size_range": [250, 350]},
                    "motion_blur": {"max_kernel_size": 7}}},
            "homographic": {
                "enable": True,
                "params": {"translation": True, "rotation": True,
                           "scaling": True, "perspective": True,
                           "scaling_amplitude": 0.2,
                           "perspective_amplitude_x": 0.2,
                           "perspective_amplitude_y": 0.2,
                           "patch_ratio": 0.85, "max_angle": 1.57,
                           "allow_artifacts": True,
                           "translation_overflow": 0.05},
                "valid_border_margin": 0, "border_reflect": True}}},
    "model": {"type": "XPoint", "multispectral": True,
              "descriptor_head": False, "final_batchnorm": True,
              "reflection_pad": True, "takes_pair": False,
              "homography_regression_head": {"check": False}},
    "loss": {"type": "XPointLoss", "detector_loss": True,
             "detector_loss_function": "cross_entropy",
             "detector_handle_multiple_keypoints": "soft_assignment",
             "detector_dustbin_loss_weight": 0.025, "descriptor_loss": False},
    "training": {"batchsize": 16, "learningrate": 1e-3, "n_epochs": 2,
                 "save_every_n_epoch": 1, "use_writer": False,
                 "num_worker": 8},
}
EXPORT_HA_CFG = {
    "num": 50, "aggregation": "window", "min_count": 2, "erosion_radius": 5,
    "mask_border": True,
    "homographies": {"translation": True, "rotation": True, "scaling": True,
                     "perspective": True, "scaling_amplitude": 0.15,
                     "perspective_amplitude_x": 0.15,
                     "perspective_amplitude_y": 0.15, "patch_ratio": 0.9,
                     "max_angle": 3.14159, "allow_artifacts": True}}
EXPORT_PRED_CFG = {"detection_threshold": 0.015, "nms": 4}
PAIR_CFG = {
    "dataset": {
        "type": "ImagePairDataset", "single_image": False,
        "random_pairs": False, "height": 256, "width": 256,
        "augmentation": {
            "photometric": {"enable": False},
            "homographic": {
                "enable": True,
                "params": {"translation": True, "rotation": True,
                           "scaling": True, "perspective": True,
                           "scaling_amplitude": 0.2,
                           "perspective_amplitude_x": 0.2,
                           "perspective_amplitude_y": 0.2,
                           "patch_ratio": 0.85, "max_angle": 1.57,
                           "allow_artifacts": True,
                           "translation_overflow": 0.05},
                "valid_border_margin": 0, "border_reflect": True}}},
    "model": {"type": "XPoint", "multispectral": True,
              "descriptor_head": True, "descriptor_size": 256,
              "intepolation_mode": "bilinear",
              "normalize_descriptors": True, "final_batchnorm": True,
              "reflection_pad": True, "mixed_precision": True,
              "takes_pair": True, "spectral_norm_stats": True,
              "homography_regression_head": {"check": False}},
    "loss": {"type": "XPointLoss", "detector_loss": True,
             "detector_loss_function": "cross_entropy",
             "detector_handle_multiple_keypoints": "soft_assignment",
             "detector_dustbin_loss_weight": 0.025, "descriptor_loss": True,
             "descriptor_loss_threshold": 4.0,
             "descriptor_loss_use_mask": True,
             "sparse_descriptor_loss": False, "positive_margin": 1.0,
             "negative_margin": 0.2, "lambda_d": 250, "lambda": 1.0,
             "hard_negative_weighting": {"check": False, "temperature": 0.1,
                                         "weight": 0.0,
                                         "keep_uniform": True}},
    "training": {"batchsize": 8, "learningrate": 3e-4, "n_epochs": 1,
                 "device_data": True,
                 "scheduler": {"use_scheduler": False, "type": "StepLR",
                               "gamma": 1.0, "step_size": 600},
                 "save_every_n_epoch": 0, "use_writer": False},
}
PAIR_N, PAIR_SIZE = 64, 512          # the mini corpus's image size
FLAGSHIP_N, FLAGSHIP_SIZE = 128, 512  # phase 19's folder corpus


class SingleImageCorpus:
    """Single-image samples in SyntheticShapes' layout at its output size
    (240 x 320), cut from SyntheticPairs' images at a seeded offset of 0-7
    pixels: the optical image of even samples and the thermal one of odd
    ones (is_optical alternating), an all-valid mask, and a keypoint map of
    the images' corners: the intersections of the 8-pixel block grid where
    one block differs by more than 0.35 from three that agree within 0.2
    (an L-shaped corner, in both spectra). Phase 17 fine-tunes the
    pretrained detector on it before the export of SyntheticPairs."""

    def __init__(self, n, hw=SYNTH_HW, seed=0):
        from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs
        h, w = hw
        S = (max(hw) // 8 + 2) * 8
        pairs = SyntheticPairs(n_pairs=n, size=S, n_kp=1, seed=seed)
        blocks = pairs.optical.reshape(n, S // 8, 8, S // 8, 8).mean((2, 4))
        offsets = np.random.default_rng(seed).integers(0, 8, (n, 2))
        self.images, self.kps = [], []
        for i in range(n):
            b = blocks[i]
            quad = np.stack([b[:-1, :-1], b[:-1, 1:], b[1:, :-1], b[1:, 1:]])
            corner = np.zeros(quad.shape[1:], bool)
            for k in range(4):
                rest = np.delete(quad, k, axis=0)
                corner |= ((rest.max(0) - rest.min(0) < 0.2)
                           & (np.abs(quad[k] - rest.mean(0)) > 0.35))
            oy, ox = offsets[i]
            rc = (np.argwhere(corner) + 1) * 8 - [oy, ox]
            rc = rc[(rc[:, 0] >= 0) & (rc[:, 0] < h) & (rc[:, 1] >= 0)
                    & (rc[:, 1] < w)]
            kp = np.zeros((h, w), np.float32)
            kp[rc[:, 0], rc[:, 1]] = 1.0
            img = (pairs.optical if i % 2 == 0 else pairs.thermal)[i]
            self.images.append(img[oy:oy + h, ox:ox + w, None].copy())
            self.kps.append(kp)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "keypoints": self.kps[i],
                "valid_mask": np.ones(self.kps[i].shape, bool),
                "is_optical": np.array([i % 2 == 0])}

    def returns_pair(self):
        return False


class TimedLoader:
    """A trainer's loader, with the time the training loop waits for each
    batch (ms) kept in ``waits``: one list an epoch."""

    def __init__(self, loader, waits):
        self.loader = loader
        self.waits = waits

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        self.waits.append([])
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            self.waits[-1].append((time.perf_counter() - t0) * 1e3)
            yield batch


def _time_samples(dataset, times):
    """Keep the wall time of every sample the dataset builds (ms, in the
    loader's worker threads) in ``times``."""
    inner = dataset.sample

    def sample(*args):
        t0 = time.perf_counter()
        out = inner(*args)
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    dataset.sample = sample


def _time_to_device(times):
    """Keep the wall time (ms) of every batch's copy to the device in the
    Trainer (batch_to_device_pair / _single) in ``times``; returns the
    function that puts the two back."""
    from xpoint_tpu_torch import trainer as trainer_mod
    saved = {}
    for name in ("batch_to_device_pair", "batch_to_device_single"):
        inner = saved[name] = getattr(trainer_mod, name)

        def timed(batch, device, inner=inner):
            t0 = time.perf_counter()
            out = inner(batch, device)
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(trainer_mod, name, timed)

    def restore():
        for name, fn in saved.items():
            setattr(trainer_mod, name, fn)
    return restore


def _median(values):
    values = sorted(values)
    return values[len(values) // 2]


def _host_summary(rows, waits, sample_ms, to_device_ms, batch, busy_ms,
                  epoch_rows):
    """What the host data path costs the loop, from the last epoch's
    ``epoch_rows`` steps: the loader wait a step (median; the epoch's first
    batch, which fills the pipeline, apart), the batch's copy to the
    device, the loop's time a step (from step start to step start), the
    host's ms a sample in a worker, and the device's idle share against
    the loop."""
    last = rows[-epoch_rows:]
    loop_ms = ((last[-1]["t0"] - last[0]["t0"]) * 1e3 / (len(last) - 1))
    steady = [w for epoch in waits for w in epoch[1:]]
    return {"loader_wait_ms": _median(steady),
            "to_device_ms": _median(to_device_ms),
            "loader_wait_first_ms": [epoch[0] for epoch in waits if epoch],
            "loader_wait_ms_all": waits,
            "loop_ms_per_step": loop_ms,
            "samples_per_s_loop": batch / loop_ms * 1e3,
            "idle_share_loop": 1.0 - busy_ms / loop_ms,
            "host_ms_per_sample": _median(sample_ms),
            "host_samples_timed": len(sample_ms),
            "cpu_count": os.cpu_count()}


def _watch_steps(trainer, rows, tag):
    """Wrap the trainer's step: each call runs under
    torch.cuda.set_sync_debug_mode("error") (a synchronising call inside
    the step raises), then the card is synchronised outside it and the
    step's wall time, loss and skip flag are kept in ``rows``."""
    inner = trainer.train_step
    trainer.unwatched_step = inner

    def step(*args):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            comps = inner(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        rows.append({"t0": t0, "ms": (time.perf_counter() - t0) * 1e3,
                     "loss": float(comps["loss"]),
                     "skipped_nonfinite": float(comps["skipped_nonfinite"])})
        r = rows[-1]
        print(f"{tag} step {len(rows)}: ms={r['ms']:.3f} loss={r['loss']} "
              f"skipped_nonfinite={r['skipped_nonfinite']}", flush=True)
        if not math.isfinite(r["loss"]) or r["skipped_nonfinite"]:
            raise SystemExit(f"{tag} step {len(rows)}: non-finite loss or a "
                             f"skipped step")
        return comps
    trainer.train_step = step


def device_time_by_op(prof, top=12):
    """The host ops that launched the most device time themselves (the
    profiler's self device time of a CPU-side event: the kernels launched
    inside it and not inside an op it called), with their calls and their
    host time including what they called (waits for the device too). The
    profiler's own buffer events, to which it also credits device time,
    are left out."""
    rows = [{"op": e.key, "count": e.count,
             "device_ms": e.self_device_time_total / 1e3,
             "host_ms": e.cpu_time_total / 1e3}
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0
            and e.key not in ("Activity Buffer Request", "Buffer Flush")]
    rows.sort(key=lambda r: -r["device_ms"])
    for r in rows[:top]:
        print(f"{r['device_ms']:10.3f} ms  x{r['count']:<5d} host "
              f"{r['host_ms']:10.3f} ms  {r['op']}", flush=True)
    return rows[:top]


def profile_once(fn, what, unprofiled_ms, by_op=False, **info):
    """One more call of ``fn`` under torch.profiler (CPU + CUDA): device
    time by kernel (eval/profile_pipeline.report), with ``by_op`` also by
    the host op that launched it, and the device's idle share against
    ``unprofiled_ms`` (the profiler's CPU tracing inflates the profiled
    call's wall time)."""
    from torch.profiler import ProfilerActivity, profile
    from xpoint_tpu_torch.eval.profile_pipeline import report
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = report(prof, wall_ms, what, **info)
    res = {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "unprofiled_ms": unprofiled_ms,
           "idle_share": 1.0 - busy_ms / unprofiled_ms}
    if by_op:
        res["by_op"] = device_time_by_op(prof)
    print(f"{what}: device busy {busy_ms:.3f} ms of an unprofiled "
          f"{unprofiled_ms:.3f} ms: idle {100 * res['idle_share']:.1f}%",
          flush=True)
    return res


def _step_summary(rows, batch):
    ms = sorted(r["ms"] for r in rows[1:])
    step_ms = ms[len(ms) // 2]
    return {"steps": len(rows), "step_ms": step_ms,
            "step_ms_all": [r["ms"] for r in rows],
            "samples_per_s": batch / step_ms * 1e3,
            "losses": [r["loss"] for r in rows]}


def _trainer_state(trainer):
    st = trainer.state
    opt = st.opt_state
    return [t.clone() for t in (*trainer.module.state_dict().values(),
                                *opt["mu"], *opt["nu"], opt["count"],
                                st.step)]


def k2_on(probs, size, min_prob, tag):
    """K2 on the heatmaps a path gave it: keep mask and sweep count against
    the plain version (exact), then its device time behind queued work,
    the plain version's time and the bound, as phase 4 measures them. These
    launches are not the path's: its counts are read before."""
    from xpoint_tpu_torch.kernels import cost
    from xpoint_tpu_torch.ops.nms import (_grid_nms_keep_cuda, grid_nms_keep,
                                          grid_nms_keep_plain,
                                          last_launch_shape)
    valid = probs > min_prob
    before = grid_nms_keep.launches
    keep, sweeps = grid_nms_keep(probs, valid, size, 0.1)
    launches = grid_nms_keep.launches - before
    ref, ref_sweeps = grid_nms_keep_plain(probs, valid, size, 0.1)
    n_diff = int((keep != ref).sum())
    if n_diff or sweeps != ref_sweeps or launches != 1:
        raise SystemExit(f"K2 on the {tag} heatmaps disagrees with its plain "
                         f"version or with one launch a call: {n_diff} "
                         f"pixels, sweeps {sweeps} vs {ref_sweeps}, "
                         f"{launches} launches")
    args = [(probs, valid, size, 0.1)] * 5
    ms = cuda_ms_queued(_grid_nms_keep_cuda, args, queued_delay(probs.device))
    shape = last_launch_shape()             # of the launches just timed
    plain_ms = cuda_ms(grid_nms_keep_plain, args[:3])
    b_ms, b_by = bound(cost.nms(probs.numel(), sweeps, size, 0.1))
    res = {"planes": probs.shape[0], "shape": list(probs.shape),
           "size": size, "sweeps": sweeps, "launches": launches,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "max_abs_err": 0.0, "launch_shape": shape}
    print(f"K2 on the {tag} heatmaps ({tuple(probs.shape)}, size {size}): "
          f"{res}", flush=True)
    return res


def phase_synth_pretrain(dev, workdir):
    """16: the full cycle's synthetic pretrain through the port's Trainer
    on SyntheticShapes generated on the fly (see the module docstring)."""
    from xpoint_tpu_torch.data import SyntheticShapes
    from xpoint_tpu_torch.trainer import Trainer
    deterministic = torch.backends.cudnn.deterministic
    # cuDNN may pick algorithms that add with atomics; the resume check
    # compares bits
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        straight = Trainer(SYNTH_CFG, f"{workdir}/synth", seed=0, device=dev)
        init_s = time.time() - t0
        if not isinstance(straight.dataset, SyntheticShapes):
            raise SystemExit(f"the Trainer built {type(straight.dataset)}")
        rows, waits, sample_ms, to_device_ms = [], [], [], []
        _watch_steps(straight, rows, "synthetic pretrain")
        straight.loader = TimedLoader(straight.loader, waits)
        _time_samples(straight.dataset, sample_ms)
        restore = _time_to_device(to_device_ms)
        try:
            straight.train()
        finally:
            restore()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        files = sorted(os.listdir(f"{workdir}/synth"))
        if files != ["e1.pt", "e2.pt", "latest.pt", "params.yaml"]:
            raise SystemExit(f"synthetic pretrain wrote {files}")
        steps_per_epoch = SYNTH_N // SYNTH_CFG["training"]["batchsize"]
        if len(rows) != 2 * steps_per_epoch:
            raise SystemExit(f"synthetic pretrain ran {len(rows)} steps")
        os.makedirs(f"{workdir}/synth_resumed")
        shutil.copy(f"{workdir}/synth/e1.pt", f"{workdir}/synth_resumed")
        resumed = Trainer(SYNTH_CFG, f"{workdir}/synth_resumed", seed=0,
                          device=dev)
        resumed_rows = []
        _watch_steps(resumed, resumed_rows, "synthetic pretrain (resumed)")
        if resumed.resume("e1") != 1:
            raise SystemExit("resume from e1 did not start at epoch 1")
        resumed.train()
        a, b = _trainer_state(straight), _trainer_state(resumed)
        n_diff = sum(not torch.equal(x, y) for x, y in zip(a, b))
        if len(a) != len(b) or n_diff:
            raise SystemExit(f"the run resumed from e1 differs from the "
                             f"straight run in {n_diff} of {len(a)} tensors")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    from xpoint_tpu_torch.trainer import batch_to_device_single
    batch = batch_to_device_single(next(iter(resumed.loader)), dev)
    bs = SYNTH_CFG["training"]["batchsize"]
    summary = _step_summary(rows, bs)
    prof = profile_once(
        lambda: resumed.unwatched_step(resumed.state, batch, resumed.gen),
        "synthetic pretrain step (profiled)", summary["step_ms"],
        size=list(SYNTH_HW), batch=bs)
    host = _host_summary(rows, waits, sample_ms, to_device_ms, bs,
                         prof["device_busy_ms"], steps_per_epoch)
    res = {**summary, **host, "profile": prof,
           "init_s": init_s, "peak_mem_gib": peak,
           "samples": SYNTH_N, "size": list(SYNTH_HW),
           "workers": straight.loader.workers,
           "resumed_steps": len(resumed_rows),
           "resume_bit_equal_tensors": len(a),
           "n_params": sum(p.numel() for p in straight.state.params)}
    print(f"synthetic pretrain {SYNTH_HW[0]}x{SYNTH_HW[1]} B={bs} fp32 "
          f"(multispectral CNN, on-the-fly SyntheticShapes, "
          f"{res['workers']} workers): step_ms={res['step_ms']} "
          f"loop_ms_per_step={host['loop_ms_per_step']} loader_wait_ms="
          f"{host['loader_wait_ms']} to_device_ms={host['to_device_ms']} "
          f"host_ms_per_sample={host['host_ms_per_sample']} "
          f"cpu_count={host['cpu_count']} "
          f"samples_per_s_loop={host['samples_per_s_loop']} idle_share_loop="
          f"{host['idle_share_loop']} peak_mem_gib={peak} resume from e1 "
          f"bit-equal in all {len(a)} tensors", flush=True)
    return res


def phase_cnn_train_reference(dev):
    """16 (tiny fp32 check): the two-encoder CNN with per-spectrum
    statistics (channel version 2), one single-image step and one pair
    step with per-sample routing, on the card and on the CPU from the same
    weights and batch: loss within rtol 1e-4, every gradient (Adam's first
    moment, 0.1 g) within 1e-3 of its leaf's max + 1e-6 of the largest."""
    from xpoint_tpu_torch.losses import XPointLoss
    from xpoint_tpu_torch.models import build_xpoint
    from xpoint_tpu_torch.train import (TrainState, make_optimizer,
                                        make_train_step)
    g = torch.Generator().manual_seed(9)
    nb, S = 4, 64
    kp = (torch.rand(nb, S, S, generator=g) < 0.01).float()
    is_o = torch.tensor([[True], [False], [True], [False]])
    single = {"image": torch.rand(nb, S, S, 1, generator=g),
              "keypoints": kp, "valid_mask": torch.ones(nb, S, S),
              "is_optical": is_o}
    pair = {side: {"image": torch.rand(nb, S, S, 1, generator=g),
                   "keypoints": kp, "valid_mask": torch.ones(nb, S, S),
                   "homography": torch.eye(3).expand(nb, 3, 3).clone(),
                   "is_optical": flag}
            for side, flag in (("optical", is_o), ("thermal", ~is_o))}
    pair["thermal"]["homography"][:, 0, 2] = 3.0
    res = {}
    for kind, batch in (("single", single), ("pair", pair)):
        cfg = dict(SYNTH_CFG["model"], channel_version=2,
                   spectral_norm_stats=True, descriptor_size=16,
                   descriptor_head=kind == "pair")
        loss_cfg = dict(SYNTH_CFG["loss"], descriptor_loss=kind == "pair",
                        descriptor_loss_threshold=4.0, **{"lambda": 1.0})
        out = []
        for d in ("cpu", dev):
            m, _ = build_xpoint(cfg, device=d, seed=5)
            st = TrainState(m, make_optimizer({"learningrate": 1e-3})[0])
            b = ({k: {kk: vv.to(d) for kk, vv in v.items()}
                  for k, v in batch.items()} if kind == "pair"
                 else {k: v.to(d) for k, v in batch.items()})
            comps = make_train_step(m, XPointLoss(loss_cfg),
                                    takes_pair=kind == "pair")(
                st, b, torch.Generator(device=d).manual_seed(0))
            out.append((float(comps["loss"]),
                        {n: t.cpu() for n, t in zip(st.names,
                                                    st.opt_state["mu"])}))
        (l_cpu, g_cpu), (l_gpu, g_gpu) = out
        top = max(float(t.abs().max()) for t in g_cpu.values())
        worst = max(float((g_gpu[n] - g_cpu[n]).abs().max())
                    / (float(g_cpu[n].abs().max()) + 1e-3 * top)
                    for n in g_cpu)
        loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        print(f"CNN train reference ({kind} step, tiny fp32, card vs CPU): "
              f"loss {l_gpu} vs {l_cpu} (rel {loss_rel:.3g}); worst "
              f"gradient error {worst:.3g} of (leaf max + 1e-3 x largest)",
              flush=True)
        if loss_rel > 1e-4 or worst > 1e-3:
            raise SystemExit(f"the card's CNN {kind} step disagrees with "
                             f"the CPU's")
        res[kind] = {"loss_gpu": l_gpu, "loss_cpu": l_cpu,
                     "loss_rel_err": loss_rel, "grad_err": worst}
    return res


def phase_cnn_export(dev, model_dir):
    """17: HA label export of the phase-16 detector (see the module
    docstring)."""
    from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs
    from xpoint_tpu_torch.model_io import load_model
    from xpoint_tpu_torch.selfsup.export import (NumpySink, export_keypoints,
                                                 make_prob_fn)
    from xpoint_tpu_torch.selfsup.homographic_adaptation import (
        make_ha_fn, sample_ha_homographies)
    from xpoint_tpu_torch.trainer import Trainer
    tuned_dir = f"{model_dir}_tuned"
    t0 = time.time()
    tuner = Trainer(SYNTH_CFG, tuned_dir, seed=0, device=dev,
                    dataset=SingleImageCorpus(SYNTH_N, SYNTH_HW))
    loaded = tuner.load_weights(f"{model_dir}/latest.pt")
    if (loaded["used"] != len(tuner.module.state_dict())
            or loaded["unexpected"] or loaded["shape"]):
        raise SystemExit(f"load_weights of phase 16's detector: {loaded}")
    tuner.train()
    tune_s = time.time() - t0
    module, cfg = load_model(tuned_dir, "latest", device=dev)
    if not (cfg["multispectral"] and hasattr(module, "encoder_thermal")):
        raise SystemExit("load_model did not rebuild the two-encoder model")
    dataset = SyntheticPairs(n_pairs=4, size=HA_S, n_kp=1, seed=7)
    chunks = -(-(EXPORT_HA_CFG["num"] - 1) // HA_WB)
    # per pair: the image warp, the mask unwarp and the two-map probability
    # unwarp each chunk; one NMS launch for each spectrum
    expect = {"warp_projective": 3 * chunks, "nms_sweep": 2}
    run_ha, ha_cfg = make_ha_fn(make_prob_fn(module), EXPORT_HA_CFG)
    s0 = dataset[0]
    img_o, img_t = (torch.from_numpy(s0[k]["image"][None]).to(dev)
                    for k in ("optical", "thermal"))
    hs = torch.from_numpy(sample_ha_homographies(
        ha_cfg, (HA_S, HA_S), np.random.default_rng(0))).to(dev)
    maps = run_ha(img_o, img_t, hs)
    for key in ("prob_optical", "prob_thermal"):
        p = maps[key]
        if (not bool(torch.isfinite(p).all()) or float(p.min()) < 0
                or float(p.max()) > 1 or float(p.max()) == 0):
            raise SystemExit(f"HA export: {key} not finite in [0, 1]")
    kw = dict(ha_config=EXPORT_HA_CFG, prediction_config=EXPORT_PRED_CFG,
              seed=0)
    sink = NumpySink()
    export_keypoints(module, dataset, sink, max_samples=1, **kw)  # warm-up
    torch.cuda.synchronize()
    read = _zero_counts()
    t0 = time.perf_counter()
    n_done = export_keypoints(module, dataset, sink, **kw)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / max(n_done, 1)
    counts = read()
    n_kps = {n: {k: len(v) for k, v in g.items()}
             for n, g in sink.groups.items()}
    print(f"CNN HA export ({HA_S}^2, num {EXPORT_HA_CFG['num']}, window, "
          f"NMS {EXPORT_PRED_CFG['nms']}): {n_done} pairs, {sec} s/pair, "
          f"launches {counts}, keypoints {n_kps}", flush=True)
    if (n_done != len(dataset) - 1 or len(n_kps) != len(dataset)
            or any(v == 0 for g in n_kps.values() for v in g.values())
            or any(counts[k] != v * n_done for k, v in expect.items())):
        raise SystemExit(f"CNN HA export failed its checks (expected "
                         f"launches per pair {expect})")
    k2 = k2_on(torch.cat([maps["prob_optical"], maps["prob_thermal"]]),
               EXPORT_PRED_CFG["nms"], EXPORT_PRED_CFG["detection_threshold"],
               "CNN export")
    return {"num": EXPORT_HA_CFG["num"], "chunks": chunks, "pairs": n_done,
            "fine_tune_s": tune_s, "load_weights": loaded,
            "seconds_per_pair": sec, "launches": counts,
            "launches_per_pair": expect, "keypoints": n_kps,
            "prob_max": {k: float(maps[k].max())
                         for k in ("prob_optical", "prob_thermal")},
            "k2": k2}


def phase_cnn_pair(dev, workdir):
    """18: pair training and serving of the two-encoder CNN (see the
    module docstring)."""
    from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs
    from xpoint_tpu_torch.eval import make_pair_pipeline
    from xpoint_tpu_torch.trainer import Trainer
    dataset = SyntheticPairs(n_pairs=PAIR_N, size=PAIR_SIZE, n_kp=256,
                             seed=2, config=PAIR_CFG["dataset"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    trainer = Trainer(PAIR_CFG, f"{workdir}/pair", seed=0, device=dev,
                      dataset=dataset)
    init_s = time.time() - t0
    rows = []
    _watch_steps(trainer, rows, "CNN pair train")
    trainer.train()
    bs = PAIR_CFG["training"]["batchsize"]
    if len(rows) != PAIR_N // bs:
        raise SystemExit(f"CNN pair training ran {len(rows)} steps")
    train_res = {**_step_summary(rows, bs), "init_s": init_s,
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                 "n_params": sum(p.numel() for p in trainer.state.params)}
    train_res["profile"] = profile_once(
        lambda: trainer.unwatched_step(trainer.state,
                                       next(trainer._epoch_batches()),
                                       trainer.gen),
        "CNN pair train step (profiled)", train_res["step_ms"], batch=bs,
        size=PAIR_CFG["dataset"]["height"])
    print(f"CNN pair train 256^2 B={bs} bf16 device data: "
          f"step_ms={train_res['step_ms']} samples_per_s="
          f"{train_res['samples_per_s']} peak_mem_gib="
          f"{train_res['peak_mem_gib']}", flush=True)

    run = make_pair_pipeline(trainer.module.eval(), (H, W), k=1024,
                             nms_size=8, detection_threshold=0.015)
    g = torch.Generator(device=dev).manual_seed(8)
    images = [(torch.rand(B, H, W, 1, generator=g, device=dev),
               torch.rand(B, H, W, 1, generator=g, device=dev))
              for _ in range(N_CALLS + 1)]
    run(*images[0])                                          # warm-up
    torch.cuda.synchronize()
    read = _zero_counts()
    lat = []
    for img_o, img_t in images[1:]:
        t0 = time.perf_counter()
        out = run(img_o, img_t)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        for key, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise SystemExit(f"CNN pair serving: non-finite {key}")
    counts = read()
    if (counts["nms_sweep"] != N_CALLS
            or tuple(out["desc_optical"].shape)
            != (B, 1024, PAIR_CFG["model"]["descriptor_size"])):
        raise SystemExit(f"CNN pair serving: launches {counts}, expected one "
                         f"nms_sweep per call")
    lat_ms = sorted(lat)[len(lat) // 2]
    serve_res = {"latency_ms": lat_ms, "latency_all_ms": lat,
                 "pairs_per_s": B / lat_ms * 1e3, "launches": counts,
                 "matches": int(out["matched"].sum()),
                 "keypoints_optical": int(out["mask_optical"].sum())}
    print(f"CNN pair serving 512^2 B={B}: latency_ms={lat_ms} pairs_per_s="
          f"{serve_res['pairs_per_s']} launches={counts}", flush=True)
    serve_res["profile"] = profile_once(
        lambda: run(*images[1]), "CNN pair serving call (profiled)", lat_ms,
        batch=B, size=H)
    serve_res["k2"] = k2_on(torch.cat([out["prob_optical"],
                                       out["prob_thermal"]]), 8, 0.015,
                            "CNN serving")
    return {"train": train_res, "serve": serve_res}


def _equal_batches(a, b, path="batch"):
    """Where two collated batches differ (None if nowhere)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return path
        for k in a:
            where = _equal_batches(a[k], b[k], f"{path}.{k}")
            if where:
                return where
        return None
    if isinstance(a, np.ndarray):
        same = (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
        return None if same else path
    return None if a == b else path


def phase_flagship_host(dev, workdir, phase7_step_ms):
    """19: the flagship config's own training path, on the host data path
    (see the module docstring). The corpus's labels, SyntheticPairs'
    keypoints, are an .npz file (this machine has no h5py); everything else
    is the config's own dataset section."""
    import cv2
    from xpoint_tpu_torch.data import DataLoader, ImagePairDataset, get_dataset
    from xpoint_tpu_torch.data.group_file import write_npz_groups
    from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs
    from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG
    from xpoint_tpu_torch.trainer import Trainer, batch_to_device_pair

    root = f"{workdir}/flagship_corpus"
    pairs = SyntheticPairs(n_pairs=FLAGSHIP_N, size=FLAGSHIP_SIZE, n_kp=256,
                           seed=3)
    t0 = time.time()
    for side, images in (("optical", pairs.optical),
                         ("thermal", pairs.thermal)):
        os.makedirs(f"{root}/{side}")
        for i, img in enumerate(images):
            cv2.imwrite(f"{root}/{side}/{i:04d}.png",
                        np.round(img * 255).astype(np.uint8))
    labels = f"{workdir}/flagship_labels.npz"
    write_npz_groups(labels, {f"{i:04d}.png": {"keypoints": kp}
                              for i, kp in enumerate(pairs.kps)})
    write_s = time.time() - t0
    cfg = copy.deepcopy(VMAMBA_TRAIN_CFG)
    ds_cfg = cfg["dataset"]
    del ds_cfg["filename"], ds_cfg["keypoints_filename"]
    ds_cfg["foldername"] = root
    # a warm-up epoch, then the measured one; no TensorBoard files
    cfg["training"].update(n_epochs=2, save_every_n_epoch=1,
                           use_writer=False)
    workers = cfg["training"]["num_worker"]
    bs = cfg["training"]["batchsize"]

    # the factory itself, on the folder config without labels
    unlabelled = get_dataset(ds_cfg)
    s = unlabelled[0]
    if (type(unlabelled) is not ImagePairDataset
            or len(unlabelled) != FLAGSHIP_N
            or s["optical"]["image"].shape != (TRAIN_S, TRAIN_S, 1)
            or "keypoints" in s["optical"]
            or s["hm_input"].shape != (128, 128, 2)
            or s["hfour_points"].shape != (4, 2)):
        raise SystemExit("get_dataset on the flagship's folder config built "
                         "an unexpected dataset or sample")

    dataset = get_dataset(dict(ds_cfg, keypoints_filename=labels))
    if not np.array_equal(dataset._load_keypoints(5), pairs.kps[5]):
        raise SystemExit("the .npz labels do not read back as written")
    firsts = []
    for n in (1, workers):
        dataset.set_epoch(0, 0)
        firsts.append(next(iter(DataLoader(dataset, bs, shuffle=True,
                                           seed=0, workers=n))))
    where = _equal_batches(firsts[0], firsts[1])
    if where:
        raise SystemExit(f"the first batch differs between 1 and {workers} "
                         f"loader workers at {where}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    trainer = Trainer(cfg, f"{workdir}/flagship", seed=0, device=dev,
                      dataset=dataset)
    init_s = time.time() - t0
    rows, waits, sample_ms, to_device_ms = [], [], [], []
    _watch_steps(trainer, rows, "flagship host-data train")
    trainer.loader = TimedLoader(trainer.loader, waits)
    _time_samples(dataset, sample_ms)
    restore = _time_to_device(to_device_ms)
    read = _zero_counts()
    try:
        trainer.train()
    finally:
        restore()
    launches = read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del dataset.sample                  # the timing wrapper
    steps = FLAGSHIP_N // bs
    if len(rows) != 2 * steps:
        raise SystemExit(f"flagship host-data training ran {len(rows)} "
                         f"steps, expected {2 * steps}")
    expect = TRAIN_LAUNCHES[None]
    launches = {k: v for k, v in launches.items() if k in expect}
    for name, n in launches.items():
        if n != expect[name] * len(rows):
            raise SystemExit(f"flagship host-data training launched {name} "
                             f"{n} times, expected {expect[name]} per step")

    # resume from e1 bit for bit (cuDNN deterministic in both runs)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for tag in ("straight", "resumed"):
            t = Trainer(cfg, f"{workdir}/flagship_{tag}", seed=0, device=dev,
                        dataset=dataset)
            if tag == "resumed":
                shutil.copy(f"{workdir}/flagship_straight/e1.pt",
                            f"{workdir}/flagship_resumed")
                if t.resume("e1") != 1:
                    raise SystemExit("resume from e1 did not start at "
                                     "epoch 1")
            t.train()
            runs[tag] = _trainer_state(t)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = runs["straight"], runs["resumed"]
    n_diff = sum(not torch.equal(x, y) for x, y in zip(a, b))
    if len(a) != len(b) or n_diff:
        raise SystemExit(f"the flagship run resumed from e1 differs from the "
                         f"straight run in {n_diff} of {len(a)} tensors")

    summary = _step_summary(rows[steps:], bs)
    batch = batch_to_device_pair(firsts[1], dev)
    prof = profile_once(
        lambda: trainer.unwatched_step(trainer.state, batch, trainer.gen),
        "flagship host-data train step (profiled)", summary["step_ms"],
        batch=bs, size=TRAIN_S)
    host = _host_summary(rows, waits, sample_ms, to_device_ms, bs,
                         prof["device_busy_ms"], steps)
    res = {**summary, **host, "profile": prof, "init_s": init_s,
           "corpus_write_s": write_s, "peak_mem_gib": peak,
           "workers": workers, "pairs": FLAGSHIP_N,
           "pair_size": FLAGSHIP_SIZE, "launches": launches,
           "launches_per_step": {k: v / len(rows)
                                 for k, v in launches.items()},
           "resume_bit_equal_tensors": len(a),
           "phase7_step_ms": phase7_step_ms}
    print(f"flagship host-data train {TRAIN_S}^2 B={bs} bf16 "
          f"(ImagePairDataset, {workers} workers, {os.cpu_count()} cpus): "
          f"step_ms={res['step_ms']} (phase 7, resident data: "
          f"{phase7_step_ms}) loop_ms_per_step={host['loop_ms_per_step']} "
          f"loader_wait_ms={host['loader_wait_ms']} to_device_ms="
          f"{host['to_device_ms']} host_ms_per_sample="
          f"{host['host_ms_per_sample']} samples_per_s_loop="
          f"{host['samples_per_s_loop']} idle_share={prof['idle_share']} "
          f"idle_share_loop={host['idle_share_loop']} peak_mem_gib={peak} "
          f"launches={launches}; first batch equal with 1 and {workers} "
          f"workers; resume from e1 bit-equal in all {len(a)} tensors",
          flush=True)
    return res


EVAL_SAMPLES = 32      # phase 20's sweep: pairs of phase 19's corpus
EVAL_KEYS = {          # the JSON of the JAX package's cli/benchmark.py -e
    "repeatability": [str(t) for t in range(1, 11)],
    "descriptor": {str(t): ["nn_map_optical", "m_score_optical",
                            "nn_map_thermal", "m_score_thermal", "nn_map",
                            "m_score"] for t in range(1, 11)},
    "homography": {"2": ["average_h_error", "h_correctness"]},
    "timing_seconds": ["two_forward", "nms", "interpolate"],
    "n_kp_optical": None, "n_kp_thermal": None,
}


def _check_keys(tree, keys, path="json"):
    if keys is None:
        return
    names = keys if isinstance(keys, list) else list(keys)
    if sorted(tree) != sorted(names):
        raise SystemExit(f"benchmark JSON {path} has keys {sorted(tree)}, "
                         f"the JAX package's are {sorted(names)}")
    if isinstance(keys, dict):
        for k, sub in keys.items():
            _check_keys(tree[k], sub, f"{path}[{k!r}]")


def _check_metrics(res, n_pairs, what, curves=("homography",)):
    """The benchmark JSON's unit metrics finite in [0, 1], h_correctness
    non-decreasing in the threshold, the corner errors finite and not
    negative (999 stands in for a failed estimate; an estimate that succeeds
    may lie further off, as tests/test_torch_full_cycle.py holds the
    cycle's), n_pairs keypoint counts."""
    unit = [res["repeatability"][t] for t in res["repeatability"]]
    for d in res["descriptor"].values():
        unit += list(d.values())
    errs, rising = [], True
    for curve in curves:
        h = res[curve]["2"]
        if sorted(h["h_correctness"]) != sorted(
                f"epsilon_warp_th{t}" for t in range(1, 11)):
            raise SystemExit(f"{what}: {curve} has thresholds "
                             f"{sorted(h['h_correctness'])}")
        unit += list(h["h_correctness"].values())
        ladder = [h["h_correctness"][f"epsilon_warp_th{t}"]
                  for t in range(1, 11)]
        rising = rising and all(a <= b for a, b in zip(ladder, ladder[1:]))
        errs.append(h["average_h_error"])
    if (not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in unit)
            or not rising
            or not all(math.isfinite(e) and e >= 0.0 for e in errs)
            or len(res["n_kp_optical"]) != n_pairs):
        raise SystemExit(f"{what} wrote metrics out of range: {res}")


def _timed_attr(obj, name, times):
    """Wrap obj.name to append each call's wall seconds to ``times``;
    returns the function that restores it."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            times.append(time.perf_counter() - t0)
    setattr(obj, name, timed)
    return lambda: setattr(obj, name, fn)


def eval_sweep(dev, workdir):
    """20a: the metric sweep of phase 19's flagship through the port's
    benchmark entry point (see the module docstring), once with each
    homography estimator."""
    from xpoint_tpu_torch.cli import benchmark as bench_cli
    from xpoint_tpu_torch.config import load_yaml, save_yaml
    from xpoint_tpu_torch.eval import benchmark as eval_benchmark
    from xpoint_tpu_torch.eval.infer import XPointInference
    from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG

    cfg = load_yaml(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "configs", "cipdp.yaml"))
    # the cut: phase 19's PNG folder corpus in place of test.hdf5
    cfg["dataset"].update(foldername=f"{workdir}/flagship_corpus",
                          filename=None, keypoints_filename=None)
    n_timed = min(5, FLAGSHIP_N)
    pairs = 1 + n_timed + EVAL_SAMPLES       # warm-up, timed, swept
    depths = VMAMBA_TRAIN_CFG["model"]["use_attention"]["model_parameters"][
        "MODEL"]["VSSM"]["DEPTHS"]
    # one K1 launch a block and spectrum; one K2 launch an nms call: one in
    # the warm-up, two a pair after it
    expect = {"selective_scan_bidir": 2 * sum(depths) * pairs,
              "nms_sweep": 1 + 2 * (n_timed + EVAL_SAMPLES)}
    # the timing harness hands nms its masked maps on the device (the
    # metric loops hand it host arrays): the last is kept for K2's check
    heatmaps, nms = [], XPointInference.nms

    def keep_heatmap(self, prob):
        if isinstance(prob, torch.Tensor):
            heatmaps[:] = [prob]
        return nms(self, prob)
    runs = {}
    for est in ("magsac", "device"):
        cfg["prediction"]["h_estimator"] = est
        path = f"{workdir}/eval_{est}.yaml"
        save_yaml(cfg, path)
        sweep_s = []
        restore = _timed_attr(eval_benchmark, "compute_metrics", sweep_s)
        XPointInference.nms = keep_heatmap
        read = _zero_counts()
        t0 = time.perf_counter()
        try:
            out_path = bench_cli.main([
                "-y", path, "-m", f"{workdir}/flagship", "-v", "latest",
                "-e", "--max-samples", str(EVAL_SAMPLES), "-o",
                f"{workdir}/eval_{est}", "--device", str(dev)])
        finally:
            restore()
            XPointInference.nms = nms
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = {k: v for k, v in read().items() if k in expect}
        if launches != expect:
            raise SystemExit(f"the {est} sweep launched {launches}, the "
                             f"code predicts {expect}")
        with open(out_path) as f:
            res = json.load(f)
        _check_keys(res, EVAL_KEYS)
        _check_metrics(res, EVAL_SAMPLES, f"the {est} sweep")
        h = res["homography"]["2"]
        stage_ms = {k: 1e3 * sum(v) / len(v)
                    for k, v in res["timing_seconds"].items()}
        runs[est] = {
            "stage_ms": stage_ms, "sweep_s": sweep_s[0],
            "s_per_pair": sweep_s[0] / EVAL_SAMPLES, "total_s": total_s,
            "launches": launches,
            "launches_per_pair": {k: v / pairs for k, v in launches.items()},
            "repeatability@3": res["repeatability"]["3"],
            "nn_map@3": res["descriptor"]["3"]["nn_map"],
            "m_score@3": res["descriptor"]["3"]["m_score"],
            "h_correctness@3": h["h_correctness"]["epsilon_warp_th3"],
            "average_h_error": h["average_h_error"],
            "keypoints_per_image": sum(res["n_kp_optical"]) / EVAL_SAMPLES}
        metrics = {k: runs[est][k] for k in (
            "repeatability@3", "nn_map@3", "m_score@3", "h_correctness@3",
            "average_h_error", "keypoints_per_image")}
        print(f"eval sweep ({est}; the flagship after 16 steps: a functional "
              f"check, not an accuracy): stage_ms={stage_ms} "
              f"s_per_pair={runs[est]['s_per_pair']} over {EVAL_SAMPLES} "
              f"pairs, launches={launches} (as predicted), {metrics}",
              flush=True)
    return runs, heatmaps[0]


def _svd_sync_counter(counts):
    """torch.linalg.svd run in the sync debug mode "warn", its warnings
    counted into ``counts``; the caller's mode ("error") everywhere else."""
    import warnings
    svd = torch.linalg.svd

    def counted(*args, **kwargs):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = svd(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        counts.append(sum("synchroniz" in str(w.message) for w in caught))
        return out
    return svd, counted


def eval_pipeline_ransac(dev, module, phase3_latency_ms):
    """20b: the serving pipeline with the homography estimator, the same
    images on both sides, against the same pipeline without it."""
    from xpoint_tpu_torch.eval import make_pair_pipeline

    kw = dict(k=1024, nms_size=8, detection_threshold=0.015)
    plain = make_pair_pipeline(module, (H, W), **kw)
    run = make_pair_pipeline(module, (H, W), estimate_homography=True,
                             ransac_iters=512, **kw)
    g = torch.Generator(device=dev).manual_seed(20)
    images = [torch.rand(B, H, W, 1, generator=g, device=dev)
              for _ in range(N_CALLS + 1)]
    gen = torch.Generator(device=dev).manual_seed(0)
    plain(images[0], images[0])
    run(images[0], images[0], gen)
    torch.cuda.synchronize()
    lat, lat_plain = [], []
    for img in images[1:]:
        for fn, times, args in ((plain, lat_plain, ()), (run, lat, (gen,))):
            t0 = time.perf_counter()
            out = fn(img, img, *args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        err = float((out["H_est"] - torch.eye(3, device=dev)).abs().amax())
        n_inl = out["ransac_n_inliers"].tolist()
        if not err < 0.3 or min(n_inl) <= 10 or not bool(
                torch.isfinite(out["H_est"]).all()):
            raise SystemExit(f"pipeline RANSAC on identical images: H_est "
                             f"off the identity by {err}, inliers {n_inl}")
    # one more call with every synchronising operation an error, except
    # torch.linalg.svd (no _ex form), whose syncs are counted
    counts = []
    svd, counted = _svd_sync_counter(counts)
    mode = torch.cuda.get_sync_debug_mode()
    torch.linalg.svd = counted
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(images[1], images[1], gen)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
        torch.linalg.svd = svd
    torch.cuda.synchronize()
    # where the estimator's time goes: device time by kernel and by the
    # host op that launched it, and the idle share of one call
    prof = profile_once(lambda: run(images[1], images[1], gen),
                        f"pipeline with RANSAC {H}^2 B={B}", _median(lat),
                        by_op=True, phase=20)
    res = {"latency_ms": _median(lat), "latency_all_ms": lat,
           "plain_latency_ms": _median(lat_plain),
           "phase3_latency_ms": phase3_latency_ms,
           "max_identity_err": err, "inliers": n_inl,
           "svd_calls": len(counts), "svd_syncs": sum(counts),
           "profile": prof}
    print(f"pipeline with RANSAC {H}^2 B={B} (512 hypotheses, identical "
          f"images): latency_ms={res['latency_ms']} without it "
          f"{res['plain_latency_ms']} (phase 3: {phase3_latency_ms}); "
          f"H_est within {err} of the identity, inliers {n_inl}; under "
          f"sync debug 'error' only torch.linalg.svd synchronised: "
          f"{res['svd_syncs']} syncs in {res['svd_calls']} calls", flush=True)
    return res


def eval_ransac_planted(dev):
    """20c: ransac_homography on 1,024 planted matches, the card against
    the CPU on the same Gumbel array, and repeated bit for bit."""
    from xpoint_tpu_torch.geometry.ransac import (gumbel_noise,
                                                  ransac_homography)
    rng = np.random.default_rng(20)
    n, n_in = 1024, 717                                  # 70% inliers
    H_true = np.array([[1.05, 0.03, 8.0], [-0.02, 0.97, -5.0],
                       [2e-5, -3e-5, 1.0]])
    p1 = rng.uniform(0, 512, (n, 2))
    q = np.c_[p1, np.ones(n)] @ H_true.T
    p2 = q[:, :2] / q[:, 2:]
    p2[:n_in] += rng.normal(0, 1.0, (n_in, 2))
    p2[n_in:] = rng.uniform(0, 512, (n - n_in, 2))
    args = [torch.from_numpy(a.astype(np.float32)) for a in (p1, p2)]
    args += [torch.ones(n, dtype=torch.bool),
             gumbel_noise((512, n), torch.Generator().manual_seed(20), "cpu")]
    cpu = ransac_homography(*args, threshold=3.0)
    card_args = [a.to(dev) for a in args]
    card = ransac_homography(*card_args, threshold=3.0)
    again = ransac_homography(*card_args, threshold=3.0)
    torch.cuda.synchronize()
    for k in card:
        if not torch.equal(card[k], again[k]):
            raise SystemExit(f"ransac_homography on the card is not "
                             f"repeatable: {k} differs")

    def corners(Ha, Hb):
        c = np.array([[0, 0, 1], [512, 0, 1], [0, 512, 1], [512, 512, 1.0]])
        a, b = c @ np.asarray(Ha, float).T, c @ np.asarray(Hb, float).T
        return float(np.linalg.norm(a[:, :2] / a[:, 2:] - b[:, :2]
                                    / b[:, 2:], axis=1).max())
    H_card = card["H"].cpu().numpy()
    err_true = corners(H_card, H_true)
    err_cpu = corners(H_card, cpu["H"].numpy())
    e = np.linalg.norm((np.c_[p1, np.ones(n)] @ H_card.T)[:, :2]
                       / (np.c_[p1, np.ones(n)] @ H_card.T)[:, 2:] - p2,
                       axis=1)
    away = np.abs(e - 3.0) > 1e-3
    n_diff = int((card["inliers"].cpu().numpy() != cpu["inliers"].numpy())
                 [away].sum())
    if err_true >= 2.0 or err_cpu >= 0.01 or n_diff:
        raise SystemExit(f"planted RANSAC: corner error {err_true} px to the "
                         f"true H, {err_cpu} px to the CPU's, {n_diff} "
                         f"inlier flags differ away from the threshold")
    ms = cuda_ms(lambda: ransac_homography(*card_args, threshold=3.0),
                 [()] * 5)
    res = {"corner_err_px": err_true, "card_vs_cpu_px": err_cpu,
           "n_inliers": int(card["n_inliers"]), "planted_inliers": n_in,
           "ms": ms}
    print(f"planted RANSAC (1024 matches, 70% inliers, 512 hypotheses): "
          f"{res}; bit-equal on a second run", flush=True)
    return res


def phase_eval(dev, workdir, module, phase3_latency_ms, stages, depths):
    """20: evaluation at full width (see the module docstring). K1 and K2
    are held against their plain versions at the shapes the sweep gives
    them: K1 at the 256^2 stage shapes with B=1 (one spectrum's image a
    launch, 2 x depth launches a stage and pair), K2 on one masked
    256^2 plane of the timing harness."""
    import cv2
    print(f"cv2 {cv2.__version__}", flush=True)
    if not hasattr(cv2, "USAC_MAGSAC"):
        raise SystemExit("cv2 has no USAC_MAGSAC: the metric sweep's "
                         "homography estimator")
    sweep, heatmap = eval_sweep(dev, workdir)
    k1_rows, k1_tot, k1_err, _ = phase_scan(
        dev, stages, [2 * d for d in depths], batch=1, tails=False)
    return {"cv2": cv2.__version__, "sweep": sweep,
            "k1_stages": k1_rows, "k1_per_pair": k1_tot, "k1_err": k1_err,
            "k2": k2_on(heatmap, 8, 0.015, "eval 256^2, one plane"),
            "pipeline_ransac": eval_pipeline_ransac(dev, module,
                                                    phase3_latency_ms),
            "ransac_planted": eval_ransac_planted(dev)}


# the full cycle at its smoke size (phase 21): seven stage processes
CYCLE_ARGS = ["--n-train", "4", "--n-test", "2", "--size", "256",
              "--synth-epochs", "2", "--synth-samples", "20",
              "--pair-epochs", "2", "--ha-num", "5", "--classical"]
CYCLE_TEST_PAIRS, CYCLE_TRAIN_PAIRS, CYCLE_WARPS = 2, 4, 4
CYCLE_STAGES = ["make_mini_corpus", "synthetic_set", "train",
                "export_keypoints", "train", "benchmark", "benchmark",
                "benchmark"]
CYCLE_KEYS = dict(EVAL_KEYS, homography_device=EVAL_KEYS["homography"])
CYCLE_TIMEOUT_S = 600


def _eval_planes(dev, eval_yaml, model_dir):
    """The masked (1, H, W) planes the benchmark's timing harness hands
    NMS for one test pair, run in this process on the model and config of
    a cycle's evaluation."""
    from types import SimpleNamespace
    from xpoint_tpu_torch.cli._common import load_eval_setup
    from xpoint_tpu_torch.eval.benchmark import timing_harness
    from xpoint_tpu_torch.eval.infer import XPointInference
    ns = SimpleNamespace(yaml_config=eval_yaml, model_dir=model_dir,
                         version="latest", yaml_variable=None, device=dev)
    config, _, infer, dataset = load_eval_setup(ns,
                                                single_image_override=False)
    planes, nms = [], XPointInference.nms

    def keep(self, prob):
        if isinstance(prob, torch.Tensor):
            planes.append(prob)
        return nms(self, prob)
    XPointInference.nms = keep
    try:
        timing_harness(infer, dataset, [0], config, n_warmup=0)
    finally:
        XPointInference.nms = nms
    return planes, config["prediction"]


def phase_cycle(dev, workdir):
    """21: the port's full cycle at the smoke size, each stage a process
    of its own (see the module docstring)."""
    from xpoint_tpu_torch.cli._common import RUN_REPORT_ENV
    from xpoint_tpu_torch.tools.cycle_report import report as cycle_report
    work, reports = f"{workdir}/cycle", f"{workdir}/cycle_reports"
    log = f"{workdir}/cycle_log.txt"
    env = dict(os.environ, **{RUN_REPORT_ENV: reports})
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.run(
            [sys.executable, "-m", "xpoint_tpu_torch.tools.full_cycle",
             "--work", work, *CYCLE_ARGS, "--device", str(dev)],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=f, stderr=subprocess.STDOUT, timeout=CYCLE_TIMEOUT_S)
    total_s = time.perf_counter() - t0
    if proc.returncode != 0:
        with open(log) as f:
            tail = f.read()[-4000:]
        raise SystemExit(f"the full cycle failed ({proc.returncode}):\n{tail}")
    with open(f"{work}/mini_corpus_metrics.json") as f:
        res = json.load(f)
    _check_keys(res, CYCLE_KEYS)
    _check_metrics(res, CYCLE_TEST_PAIRS, "the full cycle",
                   ("homography", "homography_device"))
    # the SIFT baseline of --classical (stage 5a)
    with open(f"{work}/mini_corpus_metrics_classical.json") as f:
        classical = json.load(f)
    _check_keys(classical, EVAL_KEYS)
    _check_metrics(classical, CYCLE_TEST_PAIRS, "the cycle's SIFT baseline")
    rep = cycle_report(work, reports, log)
    stages = [r["stage"] for r in rep["stages"]]
    if stages != CYCLE_STAGES:
        raise SystemExit(f"the cycle ran the stages {stages}, expected "
                         f"{CYCLE_STAGES}")
    if any(r["h5py_imported"] for r in rep["stages"]):
        raise SystemExit(f"a stage of the cycle imported h5py: "
                         f"{rep['stages']}")
    # one launch of each kernel per call, counted in each stage's own
    # process (its counts start at 0): the export's HA makes 3 K4 calls a
    # chunk of up to 8 warps and 2 NMS calls a pair; a sweep one NMS call
    # in the timing harness's warm-up and two a pair after it (both test
    # pairs timed, then swept), three sweeps with the classical one; the
    # CNNs run no scan kernel
    by_stage = {}
    for r in rep["stages"]:
        for k, v in r["launches"].items():
            by_stage.setdefault(r["stage"], {}).setdefault(k, 0)
            by_stage[r["stage"]][k] += v
    chunks = -(-CYCLE_WARPS // 8)
    expect = {"export_keypoints": {"warp_projective":
                                   3 * chunks * CYCLE_TRAIN_PAIRS,
                                   "nms_sweep": 2 * CYCLE_TRAIN_PAIRS},
              "benchmark": {"nms_sweep":
                            3 * (1 + 2 * 2 * CYCLE_TEST_PAIRS)}}
    got = {k: v for k, v in by_stage.items() if v}
    if got != expect:
        raise SystemExit(f"the cycle's stages launched {got}, the code "
                         f"predicts {expect}")
    stage_s = [(r["stage"], r["wall_s"]) for r in rep["stages"]]
    print(f"full cycle (smoke size, {len(stages)} stage processes): "
          f"{total_s:.1f} s; stage wall s {stage_s}; labels "
          f"{rep['labels']}; launches {got} (as predicted); no stage "
          f"imported h5py; metrics at seed 0 {rep['metrics_seed0']}; SIFT "
          f"baseline h-correctness@3 "
          f"{classical['homography']['2']['h_correctness']['epsilon_warp_th3']}"
          f" (a functional check, not an accuracy)", flush=True)

    planes, pred = _eval_planes(dev, f"{work}/eval.yaml",
                                f"{work}/pair-train")
    if len(planes) != 2 or tuple(planes[0].shape) != (1, 256, 256):
        raise SystemExit(f"the cycle's eval handed NMS "
                         f"{[tuple(p.shape) for p in planes]}")
    k2 = [k2_on(p, pred["nms"], pred["detection_threshold"],
                f"cycle eval ({side}, one masked plane)")
          for p, side in zip(planes, ("optical", "thermal"))]
    # K4 at the calls of one HA step of the cycle's export: 4 warps at 256^2
    k4_rows, _ = phase_warp(dev, S=256, n=CYCLE_WARPS, odd_size=False,
                            calls=[c for c in K4_CALLS
                                   if c[0] != "prob unwarp"], turns=True)
    return {"total_s": total_s, "stage_s": stage_s, "report": rep,
            "launches": got, "k2": k2[0], "k2_thermal": k2[1],
            "k4": k4_rows, "classical_h_correctness@3": classical[
                "homography"]["2"]["h_correctness"]["epsilon_warp_th3"]}


def phase_clis(dev, workdir, depths):
    """22: the other entry points on phase 19's flagship checkpoint (see
    the module docstring), each through its main() in this process, with
    K1 and K2 held at their shapes (512^2, B=1)."""
    from xpoint_tpu_torch.cli import (demo, export_keypoints,
                                      predict_align_image_pair,
                                      predict_keypoints)
    from xpoint_tpu_torch.config import load_yaml, save_yaml
    from xpoint_tpu_torch.data.group_file import open_group_file
    from xpoint_tpu_torch.eval.infer import XPointInference
    model = f"{workdir}/flagship"
    cfg = load_yaml(f"{workdir}/eval_magsac.yaml")
    cfg["dataset"].update(height=-1, width=-1)      # the PNGs' 512^2
    cfg["homographic_adaptation"] = {
        "num": 5, "aggregation": "window", "min_count": 2,
        "erosion_radius": 5, "mask_border": True}
    path = f"{workdir}/clis.yaml"
    save_yaml(cfg, path)
    out = f"{workdir}/clis"
    per_forward = sum(depths)              # one K1 launch a block and image
    base = ["-m", model, "--device", str(dev)]
    planes, nms = [], XPointInference.nms

    def keep(self, prob):
        planes.append(torch.as_tensor(prob).to(dev))
        return nms(self, prob)
    corpus = f"{workdir}/flagship_corpus"
    runs = [
        ("predict_keypoints", lambda: predict_keypoints.main(
            ["-y", path, "-i", "3", "-p", "-o", out] + base),
         {"selective_scan_bidir": 2 * per_forward, "nms_sweep": 2}),
        ("predict_align_image_pair", lambda: predict_align_image_pair.main(
            ["-y", path, "-i", "3", "-p", "-o", out] + base),
         {"selective_scan_bidir": 2 * per_forward, "nms_sweep": 2}),
        ("demo", lambda: demo.main(
            ["--visible", f"{corpus}/optical/0003.png", "--other",
             f"{corpus}/thermal/0003.png", "--config", path, "--model-dir",
             model, "--output", f"{out}/demo", "--device", str(dev)]),
         {"selective_scan_bidir": 2 * per_forward, "nms_sweep": 2}),
        # HA with 4 warps in one chunk: two base forwards and two of the
        # warped stack a pair, 3 K4 calls and 2 NMS calls a pair
        ("export_keypoints", lambda: export_keypoints.main(
            ["-y", path, "-o", f"{out}/labels.npz", "--max-samples", "2"]
            + base),
         {"selective_scan_bidir": 2 * 4 * per_forward,
          "warp_projective": 2 * 3, "nms_sweep": 2 * 2}),
        ("export_keypoints -skip", lambda: export_keypoints.main(
            ["-y", path, "-o", f"{out}/labels.npz", "--max-samples", "3",
             "-skip"] + base),
         {"selective_scan_bidir": 4 * per_forward, "warp_projective": 3,
          "nms_sweep": 2}),
    ]
    res = {}
    for name, run, expect in runs:
        XPointInference.nms = keep
        read = _zero_counts()
        t0 = time.perf_counter()
        try:
            value = run()
        finally:
            XPointInference.nms = nms
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {k: v for k, v in read().items() if v}
        if launches != expect:
            raise SystemExit(f"{name} launched {launches}, the code predicts "
                             f"{expect}")
        res[name] = {"wall_s": wall_s, "launches": launches}
        if name == "predict_keypoints":
            res[name]["keypoints"] = [len(k) for k in value]
        elif name == "predict_align_image_pair":
            res[name]["matches"] = len(value[2])
            res[name]["homography"] = value[3] is not None
        elif name == "demo":
            res[name]["keypoints"] = value[0]["keypoints"]
        else:
            res[name]["exported"] = value
        print(f"cli {name} on the flagship: {res[name]}", flush=True)
    if (res["export_keypoints"]["exported"] != 2
            or res["export_keypoints -skip"]["exported"] != 1):
        raise SystemExit("export_keypoints -skip exported a sample twice")
    with open_group_file(f"{out}/labels.npz") as f:
        names = f.keys()
        if names != ["0000.png", "0001.png", "0002.png"] or any(
                f[n][k].shape[1:] != (2,) for n in names
                for k in ("keypoints_optical", "keypoints_thermal")):
            raise SystemExit(f"the exported labels hold {names}")
    for png in ("keypoints_optical_i3.png", "matches_i3.png",
                "demo/matches.png"):
        if not os.path.exists(f"{out}/{png}"):
            raise SystemExit(f"{png} was not written")
    plane = planes[0][:1]
    if tuple(plane.shape) != (1, 512, 512):
        raise SystemExit(f"predict_keypoints handed NMS {plane.shape}")
    k2 = k2_on(plane, cfg["prediction"]["nms"],
               cfg["prediction"]["detection_threshold"],
               "predict_keypoints (512^2, one plane)")
    stages = [((512 // 4 >> i) ** 2, 96 << i) for i in range(4)]
    k1_rows, k1_tot, k1_err, _ = phase_scan(
        dev, stages, [2 * d for d in depths], batch=1, tails=False)
    k4_rows, _ = phase_warp(dev, S=512, n=4, odd_size=False,
                            calls=[c for c in K4_CALLS
                                   if c[0] != "prob unwarp"])
    return {"runs": res, "k2": k2, "k1_stages": k1_rows, "k1_per_pair": k1_tot,
            "k1_err": k1_err, "k4": k4_rows,
            "launches": {k: sum(r["launches"].get(k, 0)
                                for r in res.values())
                         for k in ("selective_scan_bidir", "nms_sweep",
                                   "warp_projective")}}


SWIN_N, SWIN_SIZE = 128, 256    # phase 24's corpus: pairs and their size
SWIN_TINY = {"EMBED_DIM": 24, "DEPTHS": [2, 2], "NUM_HEADS": [3, 6],
             "WINDOW_SIZE": 4}


def swin_config():
    """configs/cmt.yaml, read by the port's load_yaml."""
    from xpoint_tpu_torch.config import load_yaml
    return load_yaml(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "configs", "cmt.yaml"))


def phase_swin_serve(dev):
    """23: the SwinV2 XPoint of configs/cmt.yaml serving at full width (see
    the module docstring)."""
    from xpoint_tpu_torch.eval.profile_pipeline import pipeline
    from xpoint_tpu_torch.models import build_xpoint
    model_cfg = swin_config()["model"]
    t0 = time.time()
    module, _ = build_xpoint(model_cfg, device=dev, seed=0)
    init_s = time.time() - t0
    run = pipeline(module)
    g = torch.Generator(device=dev).manual_seed(5)
    images = [(torch.rand(B, H, W, 1, generator=g, device=dev),
               torch.rand(B, H, W, 1, generator=g, device=dev))
              for _ in range(N_CALLS + 2)]
    run(*images[0])                                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = _zero_counts()
    lat = []
    for img_o, img_t in images[1:-1]:
        t0 = time.perf_counter()
        out = run(img_o, img_t)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        for key, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise SystemExit(f"Swin serving: non-finite {key}")
    launches = read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect = {"prob_optical": (B, H, W), "keypoints_optical": (B, 1024, 2),
              "desc_optical": (B, 1024, 256), "matched": (B, 1024)}
    for key, shape in expect.items():
        if tuple(out[key].shape) != shape:
            raise SystemExit(f"Swin serving: {key} has shape "
                             f"{tuple(out[key].shape)}, expected {shape}")
    if launches["nms_sweep"] != N_CALLS:
        raise SystemExit(f"Swin serving launched K2 {launches['nms_sweep']} "
                         f"times in {N_CALLS} calls, expected one a call")
    lat_ms = _median(lat)
    res = {"init_s": init_s, "latency_ms": lat_ms, "latency_all_ms": lat,
           "pairs_per_s": B / lat_ms * 1e3, "launches": launches,
           "matches": int(out["matched"].sum()),
           "keypoints_optical": int(out["mask_optical"].sum()),
           "peak_mem_gib": peak}
    print(f"Swin serving (configs/cmt.yaml, SwinV2-T, bf16) {H}^2 B={B}: "
          f"latency_ms={lat_ms} pairs_per_s={res['pairs_per_s']} "
          f"peak_mem_gib={peak} launches={launches}", flush=True)
    res["profile"] = profile_once(lambda: run(*images[-1]),
                                  "Swin serving call (profiled)", lat_ms,
                                  by_op=True, batch=B, size=H,
                                  model="configs/cmt.yaml")
    probs = torch.cat([out["prob_optical"], out["prob_thermal"]])
    res["k2"] = k2_on(probs, 8, 0.015, "Swin serving")

    # the tiny Swin XPoint in fp32 on the card against the CPU
    cfg = copy.deepcopy(model_cfg)
    cfg["mixed_precision"] = False
    cfg["use_attention"]["model_parameters"]["MODEL"]["SWINV2"].update(
        SWIN_TINY)
    img = torch.rand(2, 64, 64, 1, generator=torch.Generator().manual_seed(6))
    outs = {}
    for d in ("cpu", dev):
        m, _ = build_xpoint(cfg, device=d, seed=3)
        with torch.no_grad():
            outs[str(d)] = {k: v.cpu() for k, v in m(img.to(d)).items()}
    err = {k: float((outs[str(dev)][k] - v).abs().max() / v.abs().max())
           for k, v in outs["cpu"].items()}
    print(f"tiny fp32 Swin XPoint, card against CPU: max |diff| / max |CPU| "
          f"{err}", flush=True)
    if max(err.values()) > 1e-4:
        raise SystemExit("the Swin XPoint on the card disagrees with the CPU")
    res["tiny_card_vs_cpu"] = err
    return res, module


def _swin_reference_key(k):
    """A port Swin encoder key -> the reference's (SwinTransformerV2.py)
    name for it."""
    if k in ("patch_embed.weight", "patch_embed.bias"):
        return k.replace("patch_embed.", "patch_embed.proj.")
    k = re.sub(r"layers_(\d+)_blocks_(\d+)", r"layers.\1.blocks.\2", k)
    k = re.sub(r"layers_(\d+)_downsample", r"layers.\1.downsample", k)
    for a, b in (("patch_embed_norm", "patch_embed.norm"),
                 ("attn.cpb_fc1", "attn.cpb_mlp.0"),
                 ("attn.cpb_fc2", "attn.cpb_mlp.2"),
                 ("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2"),
                 ("attn.qkv_kernel", "attn.qkv.weight")):
        k = k.replace(a, b)
    return k


def write_swin_checkpoint(model_cfg, path):
    """An ImageNet-style SwinV2 checkpoint under the reference's names,
    ``{"model": state_dict}``: the port's Swin encoder initialised from
    seed 1 (the trainer's is seed 0), qkv as (3C, C), with the relative
    position buffers and a 1000-class head beside it. Returns the encoder
    state it holds."""
    from xpoint_tpu_torch.models import build_xpoint
    src, _ = build_xpoint(model_cfg, device="cpu", seed=1)
    enc = src.encoder.state_dict()
    sd = {}
    for k, v in enc.items():
        sd[_swin_reference_key(k)] = (v.t().contiguous()
                                      if k.endswith("qkv_kernel") else v)
        if k.endswith("attn.logit_scale"):
            blk = _swin_reference_key(k)[:-len("logit_scale")]
            ws = 8
            sd[blk + "relative_coords_table"] = torch.zeros(
                1, 2 * ws - 1, 2 * ws - 1, 2)
            sd[blk + "relative_position_index"] = torch.zeros(
                ws * ws, ws * ws, dtype=torch.int64)
    dim = enc["norm.weight"].numel()
    sd["head.weight"] = torch.zeros(1000, dim)
    sd["head.bias"] = torch.zeros(1000)
    torch.save({"model": sd}, path)
    return enc


def _swin_trainer(dev, cfg, out_dir, tag):
    """A Trainer from ``cfg`` with phase 19's instruments: every step under
    the sync check, loader waits, samples' and batches' host times."""
    from xpoint_tpu_torch.trainer import Trainer
    t0 = time.time()
    trainer = Trainer(cfg, out_dir, seed=0, device=dev)
    init_s = time.time() - t0
    rows, waits, sample_ms = [], [], []
    _watch_steps(trainer, rows, tag)
    trainer.loader = TimedLoader(trainer.loader, waits)
    _time_samples(trainer.dataset, sample_ms)
    return trainer, {"init_s": init_s, "rows": rows, "waits": waits,
                     "sample_ms": sample_ms}


def phase_swin_train(dev, workdir):
    """24: the SwinV2 XPoint trained through the Trainer from the whole of
    configs/cmt.yaml (see the module docstring)."""
    from xpoint_tpu_torch.data.group_file import write_npz_groups
    from xpoint_tpu_torch.tools import make_mini_corpus
    from xpoint_tpu_torch.trainer import batch_to_device_pair
    t0 = time.time()
    corpus = f"{workdir}/swin_corpus"
    make_mini_corpus.main(["--out", corpus, "--n-train", str(SWIN_N),
                           "--size", str(SWIN_SIZE), "--splits", "train"])
    rng = np.random.default_rng(4)
    labels = f"{workdir}/swin_labels.npz"
    write_npz_groups(labels, {
        f"sample_{i:04d}": {"keypoints": rng.uniform(
            0, SWIN_SIZE, size=(200, 2)).astype(np.float32)}
        for i in range(SWIN_N)})
    pre_dir = f"{workdir}/swinv2-imagenet"
    os.makedirs(pre_dir)
    cfg = swin_config()
    enc_ref = write_swin_checkpoint(cfg["model"], f"{pre_dir}/tiny256.pth")
    setup_s = time.time() - t0
    cfg["dataset"].update(filename=f"{corpus}/training.npz",
                          keypoints_filename=labels)
    cfg["model"]["use_attention"]["pretrained"]["type_dir"] = pre_dir
    cfg["training"].update(n_epochs=2, save_every_n_epoch=1,
                           use_writer=False, num_worker=8)
    bs = cfg["training"]["batchsize"]
    steps = SWIN_N // bs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer, inst = _swin_trainer(dev, cfg, f"{workdir}/swin", "Swin train")
    # a device copy of the encoder as __init__ left it, compared after the
    # steps so that no host read falls inside them
    enc_init = {k: v.clone() for k, v in
                trainer.module.encoder.state_dict().items()}
    to_device_ms = []
    restore = _time_to_device(to_device_ms)
    read = _zero_counts()
    try:
        trainer.train()
    finally:
        restore()
    launches = read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = inst["rows"]
    if len(rows) != 2 * steps:
        raise SystemExit(f"Swin training ran {len(rows)} steps, expected "
                         f"{2 * steps}")
    n_diff = [k for k, v in enc_init.items()
              if not torch.equal(v.cpu(), enc_ref[k])]
    if n_diff or set(enc_init) != set(enc_ref):
        raise SystemExit(f"the Trainer's Swin encoder after __init__ is not "
                         f"the pretrained checkpoint's: {n_diff[:5]}")
    summary = _step_summary(rows[steps:], bs)
    batch = batch_to_device_pair(next(iter(trainer.loader.loader)), dev)
    prof = profile_once(
        lambda: trainer.unwatched_step(trainer.state, batch, trainer.gen),
        "Swin train step (profiled)", summary["step_ms"], by_op=True,
        batch=bs, size=SWIN_SIZE)
    host = _host_summary(rows, inst["waits"], inst["sample_ms"],
                         to_device_ms, bs, prof["device_busy_ms"], steps)
    del trainer.dataset.sample
    res = {**summary, **host, "profile": prof, "init_s": inst["init_s"],
           "setup_s": setup_s, "peak_mem_gib": peak, "pairs": SWIN_N,
           "launches": launches, "pretrained_tensors": len(enc_ref)}
    print(f"Swin train (configs/cmt.yaml, SwinV2-T, {SWIN_SIZE}^2 B={bs} "
          f"bf16, RegNet + hm loss, 8 workers): step_ms={res['step_ms']} "
          f"samples_per_s={res['samples_per_s']} loop_ms_per_step="
          f"{host['loop_ms_per_step']} loader_wait_ms="
          f"{host['loader_wait_ms']} idle_share={prof['idle_share']} "
          f"peak_mem_gib={peak}; encoder after __init__ equal to the "
          f"pretrained checkpoint in all {len(enc_ref)} tensors", flush=True)

    # a few steps with the sparse descriptor loss, then with HomographyNet
    for tag, change in (
            ("sparse descriptor loss",
             lambda c: c["loss"].update(sparse_descriptor_loss=True)),
            ("HomographyNet head",
             lambda c: c["model"]["homography_regression_head"].update(
                 type="HomographyNet"))):
        c = copy.deepcopy(cfg)
        change(c)
        c["training"]["n_epochs"] = 1
        name = tag.split()[0]
        t, inst = _swin_trainer(dev, c, f"{workdir}/swin_{name}",
                                f"Swin train, {tag}")
        t.train()
        if len(inst["rows"]) != steps:
            raise SystemExit(f"Swin training with the {tag} ran "
                             f"{len(inst['rows'])} steps, expected {steps}")
        del t.dataset.sample
        res[f"{name}_step"] = _step_summary(inst["rows"], bs)
        print(f"Swin train with the {tag}: {res[f'{name}_step']}",
              flush=True)
    return res


def phase_swin_export(dev, module):
    """25: one HA-labelled pair with the Swin serving model (see the module
    docstring)."""
    from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs
    from xpoint_tpu_torch.selfsup.export import (NumpySink, export_keypoints,
                                                 make_prob_fn)
    from xpoint_tpu_torch.selfsup.homographic_adaptation import (
        make_ha_fn, sample_ha_homographies)
    ha_cfg = dict(EXPORT_HA_CFG, num=10)
    dataset = SyntheticPairs(n_pairs=2, size=HA_S, n_kp=1, seed=8)
    chunks = -(-(ha_cfg["num"] - 1) // HA_WB)
    expect = {"warp_projective": 3 * chunks, "nms_sweep": 2}
    kw = dict(ha_config=ha_cfg, prediction_config=EXPORT_PRED_CFG, seed=0)
    sink = NumpySink()
    export_keypoints(module, dataset, sink, max_samples=1, **kw)  # warm-up
    torch.cuda.synchronize()
    read = _zero_counts()
    t0 = time.perf_counter()
    n_done = export_keypoints(module, dataset, sink, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read()
    n_kps = {n: {k: len(v) for k, v in g.items()}
             for n, g in sink.groups.items()}
    print(f"Swin HA export ({HA_S}^2, num {ha_cfg['num']}, window, NMS "
          f"{EXPORT_PRED_CFG['nms']}): {n_done} pair in {sec} s, launches "
          f"{counts}, keypoints {n_kps}", flush=True)
    if (n_done != 1 or len(n_kps) != 2
            or any(counts[k] != v for k, v in expect.items())):
        raise SystemExit(f"Swin HA export failed its checks (expected "
                         f"launches per pair {expect})")
    run_ha, cfg = make_ha_fn(make_prob_fn(module), ha_cfg)
    s = dataset[1]
    img_o, img_t = (torch.from_numpy(s[k]["image"][None]).to(dev)
                    for k in ("optical", "thermal"))
    hs = torch.from_numpy(sample_ha_homographies(
        cfg, (HA_S, HA_S), np.random.default_rng(1))).to(dev)
    maps = run_ha(img_o, img_t, hs)
    # the window aggregation weighs each map by the other spectrum's mass
    # around it, which an untrained detector may put above 1
    for key in ("prob_optical", "prob_thermal"):
        p = maps[key]
        if (not bool(torch.isfinite(p).all()) or float(p.min()) < 0
                or float(p.max()) == 0):
            raise SystemExit(f"Swin HA: {key} not finite, non-negative and "
                             f"non-zero: {float(p.min())} {float(p.max())}")
    k2 = k2_on(torch.cat([maps["prob_optical"], maps["prob_thermal"]]),
               EXPORT_PRED_CFG["nms"], EXPORT_PRED_CFG["detection_threshold"],
               "Swin export")
    k4_rows, _ = phase_warp(dev, S=HA_S, n=HA_WB, odd_size=False,
                            calls=[c for c in K4_CALLS
                                   if c[0] != "prob unwarp"])
    return {"num": ha_cfg["num"], "chunks": chunks, "seconds_per_pair": sec,
            "launches": counts, "launches_per_pair": expect,
            "keypoints": n_kps, "k2": k2, "k4": k4_rows}


# ---- xv / m0 forward types and the baselines (phases 26-28) --------------

XV_M0_TYPES = ("xv1a", "xv2a", "xv3a", "m0_noz")
# every postfix family the CPU tests cover, with d_state 1 and 2
TINY_FAMILIES = (
    ("xv1a", 1), ("xv2a", 1), ("xv3a", 1), ("xv1a", 2), ("xv3a", 2),
    ("xv1a_onnone", 1), ("xv2a_ondwconv3", 1), ("xv3a_oncnorm", 2),
    ("xv1a_onsoftmax", 1), ("xv2a_onsigmoid", 1), ("xv3a_mul", 1),
    ("xv1a_act", 2), ("xv2a_ca", 1), ("xv3a_ca1", 1), ("xv1a_ocov", 1),
    ("xv2a_ocov2", 2), ("xv3a_ocov_cpos", 1), ("xv1a_ca1_ocov_mul_act", 1),
    ("m0_noz", 1), ("m0", 2))


def flagship_with(ftype, **vssm):
    """The flagship model section with SSM_FORWARDTYPE (and any other VSSM
    key) changed."""
    from xpoint_tpu_torch.models import VMAMBA_MODEL_CFG
    cfg = copy.deepcopy(VMAMBA_MODEL_CFG)
    cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"].update(
        SSM_FORWARDTYPE=ftype, **vssm)
    return cfg


def _serve_calls(dev, module, tag, seed):
    """make_pair_pipeline of ``module`` at 512^2, B=8, k 1024, NMS 8,
    threshold 0.015: a warm-up, then N_CALLS timed calls on fresh images,
    counts zeroed just before and read just after. Returns (result, the
    last call's output)."""
    from xpoint_tpu_torch.eval import make_pair_pipeline
    run = make_pair_pipeline(module, (H, W), k=1024, nms_size=8,
                             detection_threshold=0.015)
    g = torch.Generator(device=dev).manual_seed(seed)
    images = [(torch.rand(B, H, W, 1, generator=g, device=dev),
               torch.rand(B, H, W, 1, generator=g, device=dev))
              for _ in range(N_CALLS + 1)]
    run(*images[0])                                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = _zero_counts()
    lat = []
    for img_o, img_t in images[1:]:
        t0 = time.perf_counter()
        out = run(img_o, img_t)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        for key, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise SystemExit(f"{tag} serving: non-finite {key}")
    launches = read()
    if (tuple(out["prob_optical"].shape) != (B, H, W)
            or tuple(out["desc_optical"].shape) != (B, 1024, 256)):
        raise SystemExit(f"{tag} serving: output shapes "
                         f"{ {k: tuple(v.shape) for k, v in out.items()} }")
    lat_ms = _median(lat)
    return {"latency_ms": lat_ms, "latency_all_ms": lat,
            "pairs_per_s": B / lat_ms * 1e3, "launches": launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "matches": int(out["matched"].sum())}, out


def _tiny_card_vs_cpu(dev, families):
    """The tiny model (depths [1, 1, 1, 1], embed 24, descriptor 32, fp32)
    in each (forward type, d_state) on the card and on the CPU from the
    same seed: max |diff| / max |CPU| of the logits and descriptors."""
    from xpoint_tpu_torch.models import build_xpoint
    img = torch.rand(2, 64, 64, 1, generator=torch.Generator().manual_seed(9))
    errs = {}
    for ftype, n in families:
        cfg = flagship_with(ftype, DEPTHS=[1, 1, 1, 1], EMBED_DIM=24,
                            SSM_D_STATE=n)
        cfg.update(descriptor_size=32, mixed_precision=False)
        outs = []
        for d in ("cpu", dev):
            m, _ = build_xpoint(cfg, device=d, seed=3)
            with torch.no_grad():
                outs.append({k: m(img.to(d))[k].cpu()
                             for k in ("logits", "desc")})
        errs[f"{ftype}, N={n}"] = max(
            float((outs[1][k] - v).abs().max() / v.abs().max())
            for k, v in outs[0].items())
    worst = max(errs.values())
    print(f"tiny fp32 xv / m0 XPoints, card against CPU: max |diff| / max "
          f"|CPU| {errs}", flush=True)
    if worst > 1e-4:
        raise SystemExit("an xv / m0 model on the card disagrees with the "
                         "CPU")
    return errs


def phase_xv_m0_serve(dev, stages):
    """26: the xv and m0 forward types serving at full width (see the
    module docstring)."""
    from xpoint_tpu_torch.models import build_xpoint
    from xpoint_tpu_torch.models.vssm import SS2Dv3
    res, k5_shapes, heatmaps = {}, set(), None
    for i, ftype in enumerate(XV_M0_TYPES):
        module, _ = build_xpoint(flagship_with(ftype), device=dev, seed=0)
        hooks = []
        if ftype == "xv1a":
            # the (B, K, L, Dim) operands K5 gets from each block
            def record(op, args):
                b, h, w, _ = args[0].shape
                k5_shapes.add((b, 4, h * w, op.d_inner))
            hooks = [m.register_forward_pre_hook(record)
                     for m in module.modules() if isinstance(m, SS2Dv3)]
        row, out = _serve_calls(dev, module, ftype, 40 + i)
        for hk in hooks:
            hk.remove()
        xv = ftype.startswith("xv")
        expect = dict(_NO_SCAN, selective_scan_fused=16 * N_CALLS if xv
                      else 0, nms_sweep=N_CALLS)
        got = {k: row["launches"][k] for k in expect}
        if got != expect:
            raise SystemExit(f"{ftype} serving launched {got}, the code "
                             f"predicts {expect}")
        row["launches_per_call"] = {k: v / N_CALLS for k, v in got.items()}
        print(f"{ftype} serving (flagship width, bf16) {H}^2 B={B}: "
              f"latency_ms={row['latency_ms']} pairs_per_s="
              f"{row['pairs_per_s']} peak_mem_gib={row['peak_mem_gib']} "
              f"launches per call {row['launches_per_call']} (as predicted)",
              flush=True)
        res[ftype] = row
        if ftype == "m0_noz":
            heatmaps = torch.cat([out["prob_optical"], out["prob_thermal"]])
        del module, out
    want = {(B, 4, L, Dim) for L, Dim in stages}
    if k5_shapes != want:
        raise SystemExit(f"xv1a gave K5 the shapes {sorted(k5_shapes)}, "
                         f"phase 11 checks {sorted(want)}")
    res["k5_shapes"] = sorted(k5_shapes)
    res["k2_m0"] = k2_on(heatmaps, 8, 0.015, "m0_noz serving")
    res["tiny_card_vs_cpu"] = _tiny_card_vs_cpu(dev, TINY_FAMILIES)
    return res


def phase_xv_m0_train(dev, train_stages, depths):
    """27: xv / m0 training at full width (see the module docstring)."""
    res = {}
    for ftype, n in (("xv1a", None), ("xv1a", 16), ("m0_noz", None)):
        torch.cuda.empty_cache()
        res[ftype if n is None else f"{ftype}_n{n}"] = phase_train(
            dev, ftype, d_state=n, sync_check=True)
    torch.cuda.empty_cache()
    # K6 at the N = 16 general scan's shapes: (L, B, K, C, N) planes scanned
    # along L, one launch forward and one reversed a block and image
    cases = [((L, TRAIN_B * 4 * Dim * 16), 0, 2 * d,
              f"N=16 B={TRAIN_B} L={L} Dim={Dim}")
             for (L, Dim), d in zip(train_stages, depths)]
    rows, tot, err = phase_linear_scan(dev, None, None, cases=cases,
                                       n_sets=3)
    res["k6_n16"] = {"cases": rows, "per_step": tot, "max_abs_err": err}
    return res


def _reference_cnn_state(module, seed):
    """A reference XPoint state_dict for a CNN ``module`` from seeded numpy
    values, under the names the reference's Sequentials give
    (``XPoint.py:112-138, 452-466``): an encoder block b's convs at 9b+1
    and 9b+5 with BatchNorms at 9b+3 and 9b+7, a head's conv3 at 1, BN at 3,
    conv1 at 4, final BN at 5."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, w):
        sd[f"{name}.weight"] = torch.from_numpy(
            rng.normal(0, 0.1, tuple(w.shape)).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(
            rng.normal(0, 0.1, w.shape[0]).astype(np.float32))

    def bn(name, n):
        for leaf in ("weight", "bias", "running_mean"):
            sd[f"{name}.{leaf}"] = torch.from_numpy(
                rng.normal(0, 0.1, n).astype(np.float32))
        sd[f"{name}.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 2.0, n).astype(np.float32))
    for name in ("encoder_optical", "encoder_thermal"):
        enc, seq, k = getattr(module, name), 0, 0
        for block in range(4):
            for _ in range(2 if enc.double_convolution else 1):
                w = getattr(enc, f"ConvBNRelu_{k}").Conv_0.weight
                conv(f"{name}.{seq + 1}", w)
                bn(f"{name}.{seq + 3}", w.shape[0])
                seq, k = seq + 4, k + 1
            seq += block < 3
    for name in ("detector_head", "descriptor_head"):
        head = getattr(module, name)
        w3, w1 = head.ConvBNRelu_0.Conv_0.weight, head.Conv_0.weight
        conv(f"{name}_convolutions.1", w3)
        bn(f"{name}_convolutions.3", w3.shape[0])
        conv(f"{name}_convolutions.4", w1)
        bn(f"{name}_convolutions.5", w1.shape[0])
    return sd


def phase_baselines(dev, workdir):
    """28: the classical baselines, SuperPoint and a reference checkpoint
    (see the module docstring)."""
    from xpoint_tpu_torch.cli import benchmark as bench_cli
    from xpoint_tpu_torch.config import load_yaml, save_yaml
    from xpoint_tpu_torch.data import DataLoader, get_dataset
    from xpoint_tpu_torch.eval import benchmark as eval_benchmark
    from xpoint_tpu_torch.eval.infer import ClassicInference, XPointInference
    from xpoint_tpu_torch.model_io import load_model
    from xpoint_tpu_torch.models import build_xpoint, get_model
    from xpoint_tpu_torch.models.classic import ClassicDetectors
    res = {}
    cfg = load_yaml(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "configs", "cipdp.yaml"))
    cfg["dataset"].update(foldername=f"{workdir}/flagship_corpus",
                          filename=None, keypoints_filename=None)
    cfg["model"] = {"type": "ClassicDetectors", "method": "SIFT",
                    "takes_pair": False}
    path = f"{workdir}/eval_sift.yaml"
    save_yaml(cfg, path)
    n_timed = min(5, FLAGSHIP_N)
    # one K2 launch an NMS call: one in the timing harness's warm-up, two a
    # pair after it; no scan kernel
    expect = dict(_NO_SCAN, nms_sweep=1 + 2 * (n_timed + EVAL_SAMPLES))
    planes, nms = [], XPointInference.nms

    def keep(self, prob):
        if isinstance(prob, torch.Tensor):
            planes[:] = [prob]
        return nms(self, prob)
    sweep_s = []
    restore = _timed_attr(eval_benchmark, "compute_metrics", sweep_s)
    XPointInference.nms = keep
    read = _zero_counts()
    t0 = time.perf_counter()
    try:
        out_path = bench_cli.main([
            "-y", path, "-m", "none", "-v", "none", "-e", "--max-samples",
            str(EVAL_SAMPLES), "-o", f"{workdir}/eval_sift", "--device",
            str(dev)])
    finally:
        restore()
        XPointInference.nms = nms
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k: v for k, v in read().items() if k in expect}
    if launches != expect:
        raise SystemExit(f"the SIFT sweep launched {launches}, the code "
                         f"predicts {expect}")
    with open(out_path) as f:
        sift = json.load(f)
    _check_keys(sift, EVAL_KEYS)
    _check_metrics(sift, EVAL_SAMPLES, "the SIFT sweep")
    h = sift["homography"]["2"]
    res["sift"] = {
        "sweep_s": sweep_s[0], "s_per_pair": sweep_s[0] / EVAL_SAMPLES,
        "total_s": total_s, "launches": launches,
        "k2_launches_per_pair": launches["nms_sweep"] / (
            1 + n_timed + EVAL_SAMPLES),
        "stage_ms": {k: 1e3 * sum(v) / len(v)
                     for k, v in sift["timing_seconds"].items()},
        "repeatability@3": sift["repeatability"]["3"],
        "m_score@3": sift["descriptor"]["3"]["m_score"],
        "h_correctness@3": h["h_correctness"]["epsilon_warp_th3"],
        "keypoints_per_image": sum(sift["n_kp_optical"]) / EVAL_SAMPLES}
    print(f"SIFT sweep (cli.benchmark -m none -v none -e, {EVAL_SAMPLES} "
          f"pairs at {FLAGSHIP_SIZE}^2): {res['sift']} (launches as "
          f"predicted)", flush=True)
    res["sift"]["k2"] = k2_on(planes[0], cfg["prediction"]["nms"],
                              cfg["prediction"]["detection_threshold"],
                              "SIFT sweep (one masked plane)")

    # LGHD and RIFT2: two pairs each at 256^2 through the same metric code
    ds_cfg = dict(cfg["dataset"], height=256, width=256)
    batches = list(DataLoader(bench_cli._Head(get_dataset(ds_cfg), 2),
                              batch_size=1, shuffle=False))
    for method in ("LGHD", "RIFT2"):
        infer = ClassicInference(ClassicDetectors(
            {"method": method, "image_H": 256, "image_W": 256}),
            cfg["prediction"], device=dev)
        t0 = time.perf_counter()
        out = eval_benchmark.compute_metrics(
            infer, batches, dict(cfg, dataset=ds_cfg), threshold_ransac=[2],
            verbose=False)
        s = time.perf_counter() - t0
        rep = out["repeatability"][3]
        if not (math.isfinite(rep) and sum(out["n_kp_optical"]) > 0):
            raise SystemExit(f"{method}: {out}")
        res[method] = {"host_s_per_pair": s / len(batches),
                       "repeatability@3": rep,
                       "keypoints": out["n_kp_optical"]}
        print(f"{method} on {len(batches)} pairs at 256^2: {res[method]}",
              flush=True)

    # SuperPoint (seed-0 weights: MagicLeap's file is not in the repository)
    module, _ = get_model({"type": "SuperPointMagicLeap"}, device=dev,
                          seed=0)
    row, out = _serve_calls(dev, module, "SuperPoint", 50)
    if row["launches"]["nms_sweep"] != N_CALLS or any(
            row["launches"][k] for k in _NO_SCAN):
        raise SystemExit(f"SuperPoint serving launched {row['launches']}, "
                         f"expected one K2 a call")
    row["k2"] = k2_on(torch.cat([out["prob_optical"], out["prob_thermal"]]),
                      8, 0.015, "SuperPoint serving")
    img = torch.rand(2, 64, 64, 1, generator=torch.Generator().manual_seed(2))
    outs = []
    for d in ("cpu", dev):
        m, _ = get_model({"type": "SuperPointMagicLeap"}, device=d, seed=0)
        with torch.no_grad():
            outs.append({k: v.cpu() for k, v in m(img.to(d)).items()})
    row["card_vs_cpu"] = {k: float((outs[1][k] - v).abs().max()
                                   / v.abs().max())
                          for k, v in outs[0].items()}
    print(f"SuperPoint serving {H}^2 B={B}: latency_ms={row['latency_ms']} "
          f"pairs_per_s={row['pairs_per_s']} peak_mem_gib="
          f"{row['peak_mem_gib']} launches={row['launches']}; fp32 64^2 "
          f"card against CPU {row['card_vs_cpu']}", flush=True)
    if max(row["card_vs_cpu"].values()) > 1e-4:
        raise SystemExit("SuperPoint on the card disagrees with the CPU")
    res["superpoint"] = row
    del module, out

    # a reference checkpoint of the full cycle's pair CNN, read by model_io
    ref_dir = f"{workdir}/reference_pair"
    os.makedirs(ref_dir, exist_ok=True)
    model_cfg = copy.deepcopy(PAIR_CFG["model"])
    src, merged = build_xpoint(model_cfg, device="cpu")
    save_yaml({"model": merged}, f"{ref_dir}/params.yaml")
    torch.save(_reference_cnn_state(src, 11), f"{ref_dir}/ref.model")
    loaded = {}
    for d in ("cpu", dev):
        m, _ = load_model(ref_dir, "ref", device=d)
        loaded[str(d)] = m
    cpu_sd = loaded["cpu"].state_dict()
    differ = [k for k, v in loaded[str(dev)].state_dict().items()
              if not torch.equal(v.cpu(), cpu_sd[k])]
    if differ:
        raise SystemExit(f"the reference checkpoint loads differently on "
                         f"the card: {differ}")
    ref_row, _ = _serve_calls(dev, loaded[str(dev)], "reference pair CNN",
                              60)
    res["reference_checkpoint"] = {"entries": len(cpu_sd),
                                   "serving": ref_row}
    print(f"reference .model of the pair CNN: {len(cpu_sd)} entries, the "
          f"same bits on the card and the CPU; pipeline latency_ms="
          f"{ref_row['latency_ms']}", flush=True)
    return res


# ---- 29: multi-device ------------------------------------------------------

MD_RANKS, MD_STEPS = 2, 3        # ranks; data-parallel flagship steps
MD_TRAINER_STEPS = 4             # the Trainer's steps an epoch (2 epochs)
MD_RING = (4096, 24576)          # ring_linear_scan's (L, M), fp32
MD_EXPORT_PAIRS = 4
MD_GRAD_FLOOR = 1e-3             # of the largest gradient: bf16's roundoff
# (a)'s limits (_md_grad_err), about 3x what sound runs show on an NVIDIA
# H100 80GB HBM3 at 700 W: step 1's gradient leaf by leaf (0.0155), steps
# 2-3's as one vector (0.0415; from the second step on, the parameters
# differ by up to 2 lr on each element whose step-1 gradient was roundoff,
# which Adam moves by lr either way); the 3 steps' update, |dp - one rank|
# / |one rank's update| (0.067). A rank's own half-batch gradient scores
# 0.91 and 0.65.
MD_GRAD_TOL = (0.05, 0.15)
MD_UPDATE_TOL = 0.2
# (d): the match sets' least Jaccard index against one B=8 call (bf16 picks
# other algorithms at B=4); a wrong pairing of rows must score below it
MD_MATCH_JACCARD = 0.8
MD_EXPORT_HA = {"num": 10, "aggregation": "window", "min_count": 2,
                "erosion_radius": 5, "mask_border": True}
# (a) in fp32, step 1's gradient. Against one rank as one vector: over
# five global batches on an NVIDIA H100 80GB HBM3 at 700 W it read 4.1e-6
# to 1.1e-4; a rank's own half-batch gradient reads 0.65. By leaf it read
# up to 7.1e-3 against one rank (RegNet's conv1), and so did one rank
# computing with the ranks' rounding (_RankArithmetic: 7.1e-3 on the same
# leaves, from its convolutions and products at the ranks' shapes alone;
# its BatchNorm sums alone move them 1.3e-5). Against that computation,
# leaf by leaf: 5.4e-6 on the phase's batch.
MD_FP32_GRAD_TOL = 1e-3
MD_FP32_LEAF_TOL = 2e-3
MD_SUB_STEPS = 2                 # (g): Trainer(n_devices=1)'s steps


def md_placement():
    """Two ranks: nccl with a card each where the machine has two, else
    gloo with both ranks on cuda:0 (nccl refuses two ranks on one card)."""
    if torch.cuda.device_count() >= MD_RANKS:
        return [f"cuda:{r}" for r in range(MD_RANKS)], "nccl"
    return ["cuda:0"] * MD_RANKS, "gloo"


def _md_indices():
    """The global batches of the data-parallel steps: TRAIN_B of the 32
    resident pairs each, from a seed."""
    rng = np.random.default_rng(29)
    return [rng.permutation(32)[:TRAIN_B] for _ in range(MD_STEPS)]


def _md_steps(dev, mesh=None, sync_check=False, fp32=False,
              n_steps=MD_STEPS, indices=None):
    """``n_steps`` flagship train steps (phase 7's step, on ``mesh`` when
    given; with ``fp32`` its mixed precision off) on the global batches
    ``indices`` (default _md_indices): components, ms, launches (counts
    zeroed just before, read just after) and the gradient of each step
    (from Adam's mu: mu_t = 0.9 mu_(t-1) + 0.1 g_t), the running
    statistics after step 1, and the parameters before and after. ``dev``
    may be the CPU (the fences are then no-ops)."""
    fence = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
             else (lambda: None))
    from xpoint_tpu_torch.train.profile_step import flagship_train
    state, step, data, meta = flagship_train(dev, mesh=mesh, fp32=fp32)
    opt = state.optimizer
    gen = torch.Generator(device=dev).manual_seed(0)
    theta0 = torch.cat([p.detach().reshape(-1) for p in opt.params]).cpu()
    comps, ms, launches, grads, buffers = [], [], [], [], None
    mu_prev = torch.zeros_like(opt.mu)
    for idx in (_md_indices() if indices is None else indices)[:n_steps]:
        idx = torch.from_numpy(idx).to(dev)
        fence()
        read = _zero_counts()
        t0 = time.perf_counter()
        if sync_check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            c = step(state, {"data": data, "idx": idx}, gen)
        finally:
            if sync_check:
                torch.cuda.set_sync_debug_mode(0)
        fence()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(read())
        comps.append({k: float(v) for k, v in c.items()})
        grads.append(((opt.mu - opt.b1 * mu_prev) / (1 - opt.b1)).cpu())
        mu_prev = opt.mu.clone()
        if buffers is None:
            buffers = {k: v.float().cpu()
                       for k, v in state.module.named_buffers()}
    theta = torch.cat([p.detach().reshape(-1) for p in opt.params]).cpu()
    return {"comps": comps, "ms": ms, "launches": launches, "grads": grads,
            "buffers_first": buffers, "theta0": theta0, "theta": theta,
            "sizes": list(opt.sizes), "names": list(state.names)}


class _RankArithmetic:
    """A context in which one process computes as the MD_RANKS ranks of a
    data-parallel step do, with no collective: every convolution, dense
    layer, einsum over a leading batch axis and batched product runs on
    MD_RANKS equal slices of its leading axis, and every BatchNorm moment
    and the loss's global means are the sum of the slices' sums (the
    ranks' all-reduce) over the whole count. The mathematics is the
    one-rank step's; only the rounding is that of the ranks' shapes."""

    def __init__(self, n=MD_RANKS):
        self.n, self._saved = n, []

    def _split(self, x):
        return (torch.is_tensor(x) and x.dim() >= 2
                and x.shape[0] >= self.n and x.shape[0] % self.n == 0)

    def __enter__(self):
        import torch.nn.functional as F
        from xpoint_tpu_torch.losses import xpoint_loss
        from xpoint_tpu_torch.models import heads
        n, split = self.n, self._split
        conv2d, linear = F.conv2d, F.linear
        einsum, bmm = torch.einsum, torch.bmm

        def by_rows(fn):
            def run(x, *a, **k):
                if not split(x):
                    return fn(x, *a, **k)
                return torch.cat([fn(c, *a, **k) for c in x.chunk(n)])
            return run

        def einsum_rows(eq, *ops):
            # only "b...,...->b..." with b in no other operand
            ins, _, out = eq.replace(" ", "").partition("->")
            first = ins.split(",")
            lead = first[0][:1]
            if (lead and out[:1] == lead and split(ops[0])
                    and all(lead not in f for f in first[1:])):
                return torch.cat([einsum(eq, c, *ops[1:])
                                  for c in ops[0].chunk(n)])
            return einsum(eq, *ops)

        def bmm_rows(a, b):
            if not (split(a) and b.shape[0] == a.shape[0]):
                return bmm(a, b)
            return torch.cat([bmm(x, y) for x, y in zip(a.chunk(n),
                                                        b.chunk(n))])

        def sums(x, dims, fn):
            if 0 not in dims or not split(x):
                return fn(x)
            s = None
            for c in x.chunk(n):
                s = fn(c) if s is None else s + fn(c)
            return s

        def batch_moments(x, dims):
            count = math.prod(x.shape[d] for d in dims)
            s = sums(x, dims, lambda c: torch.stack([c.sum(dims),
                                                     (c * c).sum(dims)]))
            return s[0] / count, s[1] / count

        def global_mean(x, dims):
            return (sums(x, dims, lambda c: c.sum(dims))
                    / math.prod(x.shape[d] for d in dims))

        for obj, name, fn in (
                (F, "conv2d", by_rows(conv2d)), (F, "linear", by_rows(linear)),
                (torch, "einsum", einsum_rows), (torch, "bmm", bmm_rows),
                (heads, "batch_moments", batch_moments),
                (xpoint_loss, "global_mean", global_mean)):
            self._saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, fn)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)
        self._saved = []


def _md_half_batch_grad(dev):
    """What a rank that kept its own gradient would step with: one rank's
    first-step gradient on the first half of the first global batch."""
    from xpoint_tpu_torch.train.profile_step import flagship_train
    state, step, data, meta = flagship_train(dev)
    idx = torch.from_numpy(_md_indices()[0][:TRAIN_B // MD_RANKS]).to(dev)
    step(state, {"data": data, "idx": idx},
         torch.Generator(device=dev).manual_seed(0))
    return (state.optimizer.mu / (1 - state.optimizer.b1)).cpu()


def _leaf_errs(a, b, sizes):
    """Leaf by leaf, max |a - b| over (the leaf's max |b| + MD_GRAD_FLOOR
    of the largest |b|)."""
    top = float(b.abs().max())
    return [float((x - y).abs().max())
            / (float(y.abs().max()) + MD_GRAD_FLOOR * top)
            for x, y in zip(a.split(sizes), b.split(sizes))]


def _md_grad_err(a, b, sizes):
    """Two distances of gradient ``a`` from ``b``: |a - b| / |b| over the
    whole vector, and by leaf (_leaf_errs), the worst leaf's with its
    index."""
    leaf = _leaf_errs(a, b, sizes)
    worst = max(range(len(leaf)), key=leaf.__getitem__)
    return float((a - b).norm() / b.norm()), leaf[worst], worst


def _md_fp32(dev, dp):
    """(a) in fp32: the data-parallel step 1 ``dp`` (a rank's _md_steps
    with fp32) against one rank's step 1 on the same global batch, and
    against one rank computing with the ranks' rounding (_RankArithmetic,
    no collective); each pair as one vector and by leaf, the worst leaves
    named, and the leaves of ``dp`` over MD_FP32_LEAF_TOL from the
    latter. Returns (the row, whether all three started from the same
    parameters)."""
    one = _md_steps(dev, fp32=True, n_steps=1)
    with _RankArithmetic():
        wit = _md_steps(dev, fp32=True, n_steps=1)
    sizes, names = one["sizes"], one["names"]
    g_dp, g_one, g_wit = dp["grads"][0], one["grads"][0], wit["grads"][0]

    def cmp(a, b):
        leaf = _leaf_errs(a, b, sizes)
        worst = sorted(range(len(leaf)), key=leaf.__getitem__,
                       reverse=True)[:3]
        return leaf, {"vector": float((a - b).norm() / b.norm()),
                      "leaf": leaf[worst[0]],
                      "worst_leaves": [[names[i], leaf[i]] for i in worst]}

    leaf, row = cmp(g_dp, g_wit)
    row = {"dp_vs_one_rank": cmp(g_dp, g_one)[1],
           "ranks_rounding_vs_one_rank": cmp(g_wit, g_one)[1],
           "dp_vs_ranks_rounding": row,
           "leaves_over_limit": [[n, e] for n, e in zip(names, leaf)
                                 if e > MD_FP32_LEAF_TOL],
           "vector_limit": MD_FP32_GRAD_TOL, "leaf_limit": MD_FP32_LEAF_TOL}
    same_start = (torch.equal(dp["theta0"], one["theta0"])
                  and torch.equal(wit["theta0"], one["theta0"]))
    return row, same_start


def _digest(tensors):
    """A sha256 of the tensors' bytes, in order (bit-equality of two
    states without moving them between processes)."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _md_subgroup(dev, workdir, tag):
    """(g): ``Trainer(n_devices=1)`` on the resident corpus, MD_SUB_STEPS
    steps (cuDNN deterministic): in the launch every rank builds it, rank 0
    trains as one device and the others take no step; in this process the
    same Trainer without a process group. Returns whether this rank is in
    the mesh, its steps, whether train() returned a state, and the digest
    of the state it ended in."""
    from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs
    from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG
    from xpoint_tpu_torch.trainer import Trainer
    cfg = copy.deepcopy(VMAMBA_TRAIN_CFG)
    cfg["training"].update(n_epochs=1, save_every_n_epoch=0, use_writer=False,
                           device_data=True, validation={})
    ds = SyntheticPairs(n_pairs=TRAIN_B * MD_SUB_STEPS, config=cfg["dataset"])
    steps = [0]
    torch.backends.cudnn.deterministic = True
    try:
        t = Trainer(cfg, f"{workdir}/md_sub_{tag}", n_devices=1, seed=0,
                    device=str(dev), dataset=ds)
        if t.mesh.member:
            inner = t.train_step

            def counted(*args):
                steps[0] += 1
                return inner(*args)
            t.train_step = counted
        state = t.train()
    finally:
        torch.backends.cudnn.deterministic = False
    return {"member": t.mesh.member, "steps": steps[0],
            "returned": state is not None,
            "digest": _digest(_trainer_state(t)) if t.mesh.member else None}


def _md_trainer(dev, mesh, workdir):
    """(b): the Trainer on the resident corpus, two epochs of
    MD_TRAINER_STEPS steps with e1 written by rank 0, then a second Trainer
    resumed from e1: does it end bit for bit where the first ended?"""
    from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs
    from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG
    from xpoint_tpu_torch.parallel.mesh import all_reduce, barrier
    from xpoint_tpu_torch.trainer import Trainer
    cfg = copy.deepcopy(VMAMBA_TRAIN_CFG)
    cfg["training"].update(n_epochs=2, save_every_n_epoch=1, use_writer=False,
                           device_data=True, validation={})
    ds = SyntheticPairs(n_pairs=TRAIN_B * MD_TRAINER_STEPS,
                        config=cfg["dataset"])
    root = f"{workdir}/md_trainer"
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        straight = Trainer(cfg, f"{root}/straight", seed=0, device=str(dev),
                           dataset=ds)
        straight.train(max_steps_per_epoch=MD_TRAINER_STEPS)
        torch.cuda.synchronize(dev)
        train_s = time.perf_counter() - t0
        if mesh.rank == 0:
            os.makedirs(f"{root}/resumed")
            shutil.copy(f"{root}/straight/e1.pt", f"{root}/resumed/e1.pt")
        barrier(mesh)
        resumed = Trainer(cfg, f"{root}/resumed", seed=0, device=str(dev),
                          dataset=ds)
        start = resumed.resume("e1")
        resumed.train(max_steps_per_epoch=MD_TRAINER_STEPS)
    finally:
        torch.backends.cudnn.deterministic = False
    a, b = (torch.cat([t.reshape(-1).float() for t in (
        *tr.module.state_dict().values(), tr.state.optimizer.mu,
        tr.state.optimizer.nu)]) for tr in (straight, resumed))
    equal = torch.equal(a, b)
    both = all_reduce(torch.tensor([float(equal)], device=dev), mesh)
    return {"start_epoch": start, "resume_bit_equal": float(both) == 2.0,
            "steps": int(straight.state.step), "train_s": train_s,
            "files": sorted(os.listdir(f"{root}/straight"))
            if mesh.rank == 0 else None}


def _md_ring(dev, mesh):
    """(c): ring_linear_scan at MD_RING against one K6 launch over the
    whole L, and ring_selective_scan at the flagship's first-stage SS2D
    shapes (256^2, B=16: L 4096, K*D 384, N 1) against selective_scan."""
    from xpoint_tpu_torch.ops.linear_scan import linear_scan_launch
    from xpoint_tpu_torch.ops.selective_scan import selective_scan
    from xpoint_tpu_torch.parallel import ring_linear_scan, ring_selective_scan
    g = torch.Generator(device=dev).manual_seed(29)
    L, M = MD_RING
    a, b = recurrence_operands(g, (L, M), dev)
    res = {}
    for i in range(2):                              # a warm-up, then timed
        torch.cuda.synchronize(dev)
        read = _zero_counts()
        t0 = time.perf_counter()
        h = ring_linear_scan(a, b, mesh)
        torch.cuda.synchronize(dev)
        res["linear_ms"] = (time.perf_counter() - t0) * 1e3
        res["linear_launches"] = read()["linear_scan"]
    one = linear_scan_launch(a, b)
    res["linear_max_abs_err"] = float((h - one).abs().max())
    res["linear_max_abs"] = float(one.abs().max())
    del a, b, h, one
    Bn, KC, K, Ls = TRAIN_B, 4 * 96, 4, (TRAIN_S // 4) ** 2
    u = torch.randn(Bn, KC, Ls, generator=g, device=dev) * 0.5
    delta = torch.randn(Bn, KC, Ls, generator=g, device=dev) * 0.5
    A = -torch.exp(torch.randn(KC, 1, generator=g, device=dev) * 0.5)
    Bm = torch.randn(Bn, K, 1, Ls, generator=g, device=dev)
    Cm = torch.randn(Bn, K, 1, Ls, generator=g, device=dev)
    D = torch.randn(KC, generator=g, device=dev)
    bias = torch.randn(KC, generator=g, device=dev) * 0.1
    torch.cuda.synchronize(dev)
    read = _zero_counts()
    t0 = time.perf_counter()
    y = ring_selective_scan(u, delta, A, Bm, Cm, D, bias, mesh=mesh)
    torch.cuda.synchronize(dev)
    res["selective_ms"] = (time.perf_counter() - t0) * 1e3
    res["selective_launches"] = read()["linear_scan"]
    y1 = selective_scan(u, delta, A, Bm, Cm, D, bias)
    res["selective_max_abs_err"] = float((y - y1).abs().max())
    res["selective_max_abs"] = float(y1.abs().max())
    return res


def _md_serve_images(dev):
    g = torch.Generator(device=dev).manual_seed(290)
    return [(torch.rand(B, H, W, 1, generator=g, device=dev),
             torch.rand(B, H, W, 1, generator=g, device=dev))
            for _ in range(N_CALLS + 1)]


def _md_serve(dev, mesh):
    """(d): the flagship serving model (seed 0, bf16) through
    make_sharded_pair_pipeline at 512^2, B=8 over the ranks: a warm-up
    call, then N_CALLS timed ones, launches counted over them; the last
    call's outputs (gathered)."""
    from xpoint_tpu_torch.eval import make_sharded_pair_pipeline
    from xpoint_tpu_torch.models import VMAMBA_MODEL_CFG, build_xpoint
    module, _ = build_xpoint(VMAMBA_MODEL_CFG, device=dev, seed=0)
    run = make_sharded_pair_pipeline(module, (H, W), mesh, k=1024,
                                     nms_size=8, detection_threshold=0.015)
    images = _md_serve_images(dev)
    run(*images[0])
    torch.cuda.synchronize(dev)
    read = _zero_counts()
    lat = []
    for img_o, img_t in images[1:]:
        t0 = time.perf_counter()
        out = run(img_o, img_t)
        torch.cuda.synchronize(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
    return {"latency_ms": sorted(lat)[len(lat) // 2], "latency_all_ms": lat,
            "launches": read(),
            "out": {k: v.cpu() for k, v in out.items()}}


def _md_export_argv(workdir, out, dev):
    return ["-y", f"{workdir}/md_export.yaml", "-o", out, "-m",
            f"{workdir}/flagship", "--device", dev, "--max-samples",
            str(MD_EXPORT_PAIRS), "-s", "0"]


def _md_export(dev, mesh, workdir):
    """(e): cli.export_keypoints' rank path (default batch: the ranks) on
    phase 19's corpus and checkpoint; rank 0 writes the file."""
    from xpoint_tpu_torch.cli import export_keypoints as cli
    read = _zero_counts()
    t0 = time.perf_counter()
    n = cli._export(cli.parse_args(_md_export_argv(
        workdir, f"{workdir}/md_export_2.npz", dev.type)))
    torch.cuda.synchronize(dev)
    return {"pairs": n, "s": time.perf_counter() - t0, "launches": read()}


def _md_per_rank(values, mesh, dev):
    """Each rank's flat dict of numbers, as a list over the ranks."""
    from xpoint_tpu_torch.parallel.mesh import all_gather
    keys = sorted(values)
    g = all_gather(torch.tensor([float(values[k]) for k in keys],
                                dtype=torch.float64, device=dev), mesh)
    return [dict(zip(keys, row.tolist())) for row in g.cpu()]


def md_rank(job):
    """The body of each rank of phase 29 (runs in a process of its own)."""
    from xpoint_tpu_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(MD_RANKS)
    dev = mesh.device
    out = {"device": str(dev), "card": torch.cuda.get_device_name(dev)}
    t0 = time.perf_counter()
    out["train"] = _md_steps(dev, mesh, job["sync_check"])
    out["trainer"] = _md_trainer(dev, mesh, job["workdir"])
    out["ring"] = _md_ring(dev, mesh)
    out["serve"] = _md_serve(dev, mesh)
    out["export"] = _md_export(dev, mesh, job["workdir"])
    out["train_fp32"] = _md_steps(dev, mesh, fp32=True, n_steps=1)
    out["subgroup"] = _md_subgroup(dev, job["workdir"], "two")
    out["rank_s"] = time.perf_counter() - t0
    flat = {"rank_s": out["rank_s"],
            "serve_ms": out["serve"]["latency_ms"],
            "export_s": out["export"]["s"],
            "ring_linear_ms": out["ring"]["linear_ms"],
            "ring_selective_ms": out["ring"]["selective_ms"],
            "ring_linear_k6": out["ring"]["linear_launches"],
            "ring_selective_k6": out["ring"]["selective_launches"],
            "sub_member": out["subgroup"]["member"],
            "sub_steps": out["subgroup"]["steps"],
            "sub_returned": out["subgroup"]["returned"]}
    for i, ms in enumerate(out["train"]["ms"]):
        flat[f"step{i}_ms"] = ms
    for tag, counts in ([(f"step{i}", c) for i, c in
                         enumerate(out["train"]["launches"])]
                        + [("serve", out["serve"]["launches"]),
                           ("export", out["export"]["launches"])]):
        for k, v in counts.items():
            flat[f"{tag}:{k}"] = v
    out["per_rank"] = _md_per_rank(flat, mesh, dev)
    return out


def _keypoint_sets(out, b, side):
    return {tuple(p) for p, ok in zip(out[f"keypoints_{side}"][b].tolist(),
                                      out[f"mask_{side}"][b].tolist()) if ok}


def _match_set(out, b):
    ko, kt = out["keypoints_optical"][b], out["keypoints_thermal"][b]
    return {(tuple(ko[i].tolist()), tuple(kt[j].tolist()))
            for i, (j, m) in enumerate(zip(out["match_idx"][b].tolist(),
                                           out["matched"][b].tolist())) if m}


def phase_multidevice(dev, workdir, serve_module, card):
    """29: the multi-device paths on 2 ranks through the launcher, each
    held against its one-rank run in this process (see the module
    docstring)."""
    from xpoint_tpu_torch.cli import export_keypoints as cli
    from xpoint_tpu_torch.config import load_yaml, save_yaml
    from xpoint_tpu_torch.data.group_file import open_group_file
    from xpoint_tpu_torch.eval import make_pair_pipeline
    from xpoint_tpu_torch.parallel import launch
    devices, backend = md_placement()
    sync_check = backend == "nccl"
    print(f"multi-device: {MD_RANKS} ranks, backend {backend}, devices "
          f"{devices}", flush=True)
    cfg = load_yaml(f"{workdir}/eval_magsac.yaml")
    cfg["dataset"].update(height=-1, width=-1)      # the PNGs' 512^2
    cfg["homographic_adaptation"] = MD_EXPORT_HA
    save_yaml(cfg, f"{workdir}/md_export.yaml")

    t0 = time.perf_counter()
    got = launch(md_rank, MD_RANKS, args=({"workdir": workdir,
                                           "sync_check": sync_check},),
                 devices=devices, backend=backend, timeout=900)
    launch_s = time.perf_counter() - t0

    # one rank, in this process, on the same inputs
    ref = _md_steps(dev)
    images = _md_serve_images(dev)
    one = make_pair_pipeline(serve_module, (H, W), k=1024, nms_size=8,
                             detection_threshold=0.015)(*images[-1])
    one = {k: v.cpu() for k, v in one.items()}
    n_one = cli._export(cli.parse_args(_md_export_argv(
        workdir, f"{workdir}/md_export_1.npz", dev.type) + ["--batch", "2"]))
    res = {"backend": backend, "devices": devices, "launch_s": launch_s,
           "card": card, "rank_card": got["card"],
           "per_rank": got["per_rank"], "trainer": got["trainer"],
           "ring": got["ring"]}
    fail = []

    # (a) the data-parallel steps against the one-rank steps on the same
    # global batches, from the same parameters: each step's loss and
    # gradient, the statistics of step 1 and the whole update of the 3
    # steps; a rank's own half-batch gradient must fail the gradient limit
    dp, one_c, tr_a = got["train"]["comps"], ref["comps"], got["train"]
    loss_err = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(dp, one_c)]
    comp_err = {k: abs(dp[0][k] - one_c[0][k]) for k in one_c[0]}
    grad_err = [_md_grad_err(a, b, ref["sizes"])
                for a, b in zip(tr_a["grads"], ref["grads"])]
    half_grad = _md_grad_err(_md_half_batch_grad(dev), ref["grads"][0],
                             ref["sizes"])
    bufs_a, bufs_b = tr_a["buffers_first"], ref["buffers_first"]
    stat_err = (max(float((bufs_a[k] - v).abs().max())
                    for k, v in bufs_b.items())
                / max(float(v.abs().max()) for v in bufs_b.values()))
    update_err = float((tr_a["theta"] - ref["theta"]).norm()
                       / (ref["theta"] - ref["theta0"]).norm())
    res["train"] = {"loss_rel_err": loss_err, "component_abs_err": comp_err,
                    "grad_rel_err": [e[0] for e in grad_err],
                    "grad_leaf_rel_err": [e[1] for e in grad_err],
                    "grad_worst_leaf": [ref["names"][e[2]] for e in grad_err],
                    "half_batch_grad_rel_err": half_grad[:2],
                    "grad_limits": MD_GRAD_TOL, "stat_rel_err": stat_err,
                    "update_rel_err": update_err,
                    "update_limit": MD_UPDATE_TOL, "dp_comps": dp,
                    "one_rank_comps": one_c, "one_rank_ms": ref["ms"],
                    "sync_checked": sync_check}
    if (not torch.equal(tr_a["theta0"], ref["theta0"])
            or loss_err[0] > 1e-4 or max(loss_err) > 1e-2
            or grad_err[0][1] > MD_GRAD_TOL[0]
            or any(e[0] > MD_GRAD_TOL[1] for e in grad_err[1:])
            or half_grad[1] <= MD_GRAD_TOL[0]
            or half_grad[0] <= MD_GRAD_TOL[1]
            or stat_err > 1e-5 or update_err > MD_UPDATE_TOL
            or any(comp_err[k] > (2e-3 if "ratio" in k
                                  else 1e-2 * abs(one_c[0][k]) + 1e-4)
                   for k in comp_err)
            or any(c["skipped_nonfinite"] for c in dp)):
        fail.append("(a) the data-parallel steps")
    for r, pr in enumerate(got["per_rank"]):
        for i in range(MD_STEPS):
            if (pr[f"step{i}:selective_scan_bidir"],
                    pr[f"step{i}:selective_scan_bidir_bwd"]) != (16, 16):
                fail.append(f"(a) rank {r} step {i + 1} launches")
    # (a) in fp32: step 1's gradient against one rank as one vector, and
    # leaf by leaf against one rank computing with the ranks' rounding
    row32, same_start = _md_fp32(dev, got["train_fp32"])
    res["train"]["fp32"] = row32
    print("multi-device (a) in fp32: " + json.dumps(row32), flush=True)
    if (not same_start or row32["leaves_over_limit"]
            or row32["dp_vs_one_rank"]["vector"] > MD_FP32_GRAD_TOL):
        fail.append("(a) the data-parallel step in fp32")
    # (g) Trainer(n_devices=1) in the 2-rank launch against one rank
    sub_one = _md_subgroup(dev, workdir, "one")
    subs = [(pr["sub_member"], pr["sub_steps"], pr["sub_returned"])
            for pr in got["per_rank"]]
    res["subgroup"] = {
        "member_steps_returned_per_rank": subs,
        "one_rank_steps": sub_one["steps"],
        "bit_equal_to_one_rank":
            got["subgroup"]["digest"] == sub_one["digest"]}
    if (subs != [(1.0, float(MD_SUB_STEPS), 1.0)]
            + [(0.0, 0.0, 0.0)] * (MD_RANKS - 1)
            or sub_one["steps"] != MD_SUB_STEPS
            or not res["subgroup"]["bit_equal_to_one_rank"]):
        fail.append("(g) Trainer(n_devices=1) on the first rank")
    # (b) the Trainer's resume on 2 ranks
    tr = got["trainer"]
    if not (tr["resume_bit_equal"] and tr["start_epoch"] == 1
            and tr["steps"] == 2 * MD_TRAINER_STEPS
            and tr["files"] == ["e1.pt", "e2.pt", "latest.pt",
                                "params.yaml"]):
        fail.append("(b) the Trainer's resume")
    # (c) the ring against one device
    ring = got["ring"]
    if (ring["linear_max_abs_err"] > 1e-5 * ring["linear_max_abs"]
            or ring["selective_max_abs_err"] > 1e-4 * ring["selective_max_abs"]
            or any((pr["ring_linear_k6"], pr["ring_selective_k6"]) != (2, 2)
                   for pr in got["per_rank"])):
        fail.append("(c) the ring scans")
    # (d) sharded serving: against the same 4-sample calls on one rank bit
    # for bit, and against one B=8 call
    out = got["serve"]["out"]
    half = B // MD_RANKS
    run_one = make_pair_pipeline(serve_module, (H, W), k=1024, nms_size=8,
                                 detection_threshold=0.015)
    rows = [run_one(images[-1][0][r * half:(r + 1) * half],
                    images[-1][1][r * half:(r + 1) * half])
            for r in range(MD_RANKS)]
    same_shape_equal = all(
        torch.equal(out[k], torch.cat([x[k] for x in rows]).cpu())
        for k in out)
    jacc_kp = [len(_keypoint_sets(out, b, s) & _keypoint_sets(one, b, s))
               / max(len(_keypoint_sets(out, b, s)
                         | _keypoint_sets(one, b, s)), 1)
               for b in range(B) for s in ("optical", "thermal")]
    jacc_m = [len(_match_set(out, b) & _match_set(one, b))
              / max(len(_match_set(out, b) | _match_set(one, b)), 1)
              for b in range(B)]
    # a wrong pairing: the rows of the two ranks swapped
    swapped = {k: torch.cat([v[half:], v[:half]]) for k, v in out.items()}
    jacc_m_swapped = [len(_match_set(swapped, b) & _match_set(one, b))
                      / max(len(_match_set(swapped, b) | _match_set(one, b)),
                            1) for b in range(B)]
    prob_err = max(float((out[f"prob_{s}"] - one[f"prob_{s}"]).abs().max())
                   for s in ("optical", "thermal"))
    res["serve"] = {"equal_to_one_rank_at_b4": same_shape_equal,
                    "keypoint_jaccard_vs_b8": jacc_kp,
                    "match_jaccard_vs_b8": jacc_m,
                    "match_jaccard_rows_swapped": jacc_m_swapped,
                    "prob_max_abs_err_vs_b8": prob_err,
                    "latency_ms": got["serve"]["latency_ms"],
                    "pairs_per_s": B / got["serve"]["latency_ms"] * 1e3}
    if (not same_shape_equal or prob_err > 2e-2 or min(jacc_kp) < 0.95
            or min(jacc_m) < MD_MATCH_JACCARD
            or max(jacc_m_swapped) >= MD_MATCH_JACCARD
            or any((pr["serve:nms_sweep"], pr["serve:selective_scan_bidir"])
                   != (N_CALLS, 16 * N_CALLS) for pr in got["per_rank"])):
        fail.append("(d) sharded serving")
    # (e) the export on 2 ranks against 1 rank with --batch 2
    jacc = []
    with open_group_file(f"{workdir}/md_export_2.npz") as f2, \
            open_group_file(f"{workdir}/md_export_1.npz") as f1:
        names = (f2.keys(), f1.keys())
        for name in f1.keys():
            for k in ("keypoints_optical", "keypoints_thermal"):
                a = {tuple(p) for p in np.asarray(f2[name][k]).tolist()}
                b = {tuple(p) for p in np.asarray(f1[name][k]).tolist()}
                jacc.append(len(a & b) / max(len(a | b), 1))
    chunks = -(-(MD_EXPORT_HA["num"] - 1) // HA_WB)
    calls = MD_EXPORT_PAIRS // MD_RANKS          # HA calls a rank, B=1
    expect = {"warp_projective": 3 * chunks * calls,
              "selective_scan_bidir": 16 * (1 + chunks) * calls}
    res["export"] = {"pairs": got["export"]["pairs"], "one_rank_pairs": n_one,
                     "same_names": names[0] == names[1],
                     "keypoint_jaccard": jacc, "s": got["export"]["s"],
                     "launches_expected_a_rank": expect}
    if (got["export"]["pairs"] != MD_EXPORT_PAIRS or n_one != MD_EXPORT_PAIRS
            or names[0] != names[1] or min(jacc) < 0.95
            or any(pr[f"export:{k}"] != v for pr in got["per_rank"]
                   for k, v in expect.items())
            or [pr["export:nms_sweep"] for pr in got["per_rank"]]
            != [2 * MD_EXPORT_PAIRS // MD_RANKS] + [0] * (MD_RANKS - 1)):
        fail.append("(e) the export")

    # the kernels at the shapes a rank gives them
    train_stages = [((TRAIN_S // 4 >> i) ** 2, 96 << i) for i in range(4)]
    serve_stages = [((H // 4 >> i) * (W // 4 >> i), 96 << i)
                    for i in range(4)]
    _, res["k1k3_per_step"], res["k1_train_err"], res["k3_err"], _, _ = \
        phase_train_scan(dev, train_stages, [4] * 4,
                         batch=TRAIN_B // MD_RANKS, tails=False)
    _, res["k1_per_call"], res["k1_serve_err"], _ = phase_scan(
        dev, serve_stages, [4] * 4, batch=half, tails=False)
    local = torch.cat([out["prob_optical"][:half],
                       out["prob_thermal"][:half]]).to(dev)
    res["k2"] = k2_on(local, 8, 0.015, "multi-device serving, a rank's")
    L, M = MD_RING
    k6_rows, _, res["k6_err"] = phase_linear_scan(
        dev, None, None, cases=[((L // MD_RANKS, M), 0, 1,
                                 "ring block a rank")], n_sets=4)
    res["k6"] = k6_rows[0]
    print("multi-device: " + json.dumps(res, default=str), flush=True)
    for r, pr in enumerate(got["per_rank"]):
        print(f"multi-device rank {r}: flagship DP step ms "
              f"{[pr[f'step{i}_ms'] for i in range(MD_STEPS)]} "
              f"(one rank {ref['ms']}), serving {pr['serve_ms']} ms a call "
              f"of {B} pairs ({B / pr['serve_ms'] * 1e3} pairs/s), "
              f"export {pr['export_s']} s for {MD_EXPORT_PAIRS} pairs; "
              f"{card}" + ("; two ranks share one card over gloo, which "
                           "stages every collective through the host: "
                           "not a scale-out figure" if backend == "gloo"
                           else ""), flush=True)
    if not sync_check:
        print("multi-device: the sync check of the data-parallel steps was "
              "not made (gloo stages CUDA collectives through the host)",
              flush=True)
    if fail:
        raise SystemExit(f"multi-device: {fail} failed their checks")
    return res


def md_kernel_rows(md, warp_rows, k1):
    """The kernels line's rows of phase 29: rank 0's launches, each kernel
    timed at the shapes a rank gives it."""
    pr = md["per_rank"][0]

    def total(name, tags):
        return int(sum(pr[f"{t}:{name}"] for t in tags))
    steps = [f"step{i}" for i in range(MD_STEPS)]
    t, c = md["k1k3_per_step"], md["k1_per_call"]
    k6 = md["k6"]
    return [
        {"name": "selective_scan_bidir",
         "path": "multi-device DP train, a rank (emit_ckpt, B=8)", **k1,
         "launches": total("selective_scan_bidir", steps),
         "max_abs_err": md["k1_train_err"], "ms": t["k1_ms"],
         "ms_with_host_launch": t["k1_ms_with_host_launch"],
         "plain_ms": t["k1_plain_ms"], "bound_ms": t["k1_bound_ms"]},
        {"name": "selective_scan_bidir_bwd",
         "path": "multi-device DP train, a rank (B=8)", "route": "cuda",
         "source": "xpoint_tpu_torch/csrc/selective_scan_bidir_bwd.cu",
         "replaces": "xpoint_tpu/ops/selective_scan_pallas.py:530",
         "launches": total("selective_scan_bidir_bwd", steps),
         "max_abs_err": md["k3_err"], "ms": t["k3_ms"],
         "ms_with_host_launch": t["k3_ms_with_host_launch"],
         "plain_ms": t["k3_plain_ms"], "bound_ms": t["k3_bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "selective_scan_bidir",
         "path": "multi-device sharded serving, a rank (512^2, B=4)", **k1,
         "launches": total("selective_scan_bidir", ["serve"]),
         "max_abs_err": md["k1_serve_err"], "ms": c["ms"],
         "ms_with_host_launch": c["ms_with_host_launch"],
         "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"]},
        {"name": "nms_sweep",
         "path": "multi-device sharded serving, a rank (8 planes 512^2)",
         "route": "cuda", "source": "xpoint_tpu_torch/csrc/nms_sweep.cu",
         "replaces": "xpoint_tpu/ops/nms.py:36",
         "launches": total("nms_sweep", ["serve"]), "max_abs_err": 0.0,
         "ms": md["k2"]["ms"], "plain_ms": md["k2"]["plain_ms"],
         "bound_ms": md["k2"]["bound_ms"], "bound_by": md["k2"]["bound_by"],
         "library_ms": None},
        {"name": "linear_scan",
         "path": "multi-device ring_linear_scan, a rank's block "
                 f"({k6['L']}, {k6['M']})", "route": "cuda",
         "source": "xpoint_tpu_torch/csrc/linear_scan.cu",
         "replaces": "xpoint_tpu/ops/selective_scan_pallas.py:34",
         "launches": int(pr["ring_linear_k6"]),
         "max_abs_err": md["k6_err"], "ms": k6["fwd_ms"],
         "plain_ms": k6["fwd_plain_ms"], "bound_ms": k6["bound_ms"],
         "bound_by": k6["bound_by"], "library_ms": None},
        *[{"name": "warp_projective",
           "path": f"multi-device export, a rank ({r['call']}, 8 warps at "
                   "512^2)", "route": "cuda",
           "source": "xpoint_tpu_torch/csrc/warp_projective.cu",
           "replaces": "xpoint_tpu/ops/warp_tiled.py:129",
           "launches": total("warp_projective", ["export"]) // 3,
           "max_abs_err": r["max_abs_err"], "ms": r["ms"],
           "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
           "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
          for r in warp_rows if r["call"] in (
              "image warp", "mask unwarp", "prob unwarp, 2 maps")],
    ]


P30_CALLS = 3                       # (d): the profiled pipeline calls
P30_GRID = "0.015,8,0;0.010,8,0"    # (e): phase 20's operating point first
P30_SAMPLES = 8                     # (f): 512^2 samples timed on each path
P30_ROOF_LIMIT = 1.05               # (b): no stage above its bound


def _p30_model_cost(module, stages, depths, scan_tot):
    """30a: model_cost of one pair forward at full width; its K1 terms
    against the bound's formulas at phase 2's stage shapes (two images a
    pair: 2 x depth launches a stage), written out here."""
    from xpoint_tpu_torch.eval.benchmark import model_cost
    from xpoint_tpu_torch.kernels import cost
    t0 = time.perf_counter()
    got = model_cost(module, (H, W), batch=B)
    count_s = time.perf_counter() - t0
    want = {"launches": 0, "bytes": 0, "flops": 0}
    for (L, Dim), depth in zip(stages, depths):
        M, G, n = B * 2 * Dim, B * 2, 2 * depth
        want["launches"] += n
        want["bytes"] += n * (2 * (5 * L * M + 4 * L * G) + 3 * 4 * 4 * Dim)
        want["flops"] += n * 2 * 14 * L * M
    k1 = got["kernels"].get("selective_scan_bidir", {})
    k1_bound_ms = k1.get("bytes", 0) / cost.HBM_BYTES_PER_S * 1e3
    ca = got["cost_analysis"]
    res = {"flops_per_pair": got["flops"] / B,
           "bytes_per_pair": got["bytes_accessed"] / B,
           "transcendentals_per_pair": ca["transcendentals"] / B,
           "cost_analysis": ca, "kernels": got["kernels"],
           "k1_expected": want, "k1_bound_ms": k1_bound_ms,
           "phase2_k1_bound_ms": scan_tot["bound_ms"], "count_s": count_s}
    print("phase 30 model_cost: " + json.dumps(res), flush=True)
    if (set(got["kernels"]) != {"selective_scan_bidir"}
            or {k: k1[k] for k in want} != want
            or abs(k1_bound_ms - scan_tot["bound_ms"])
            > 1e-9 * scan_tot["bound_ms"]):
        raise SystemExit("model_cost's kernel terms differ from the bound's "
                         "formulas at the serving shapes")
    return res


def _p30_roofline(module):
    """30b: the per-stage roofline of one 512^2 encoder pass at B=8."""
    from xpoint_tpu_torch.tools import roofline
    rows, exp_rate = roofline.stage_table(module, B, S=H)
    res = {"exp_rate_per_s": exp_rate, "stages": rows}
    print("phase 30 roofline: " + json.dumps(res), flush=True)
    above = [r["stage"] for r in rows
             if r.get("achieved") is not None
             and r["achieved"] > P30_ROOF_LIMIT]
    if above or any(r.get("achieved") is None for r in rows[:-1]):
        raise SystemExit(f"roofline: stages above {P30_ROOF_LIMIT} of their "
                         f"bound (their count is wrong) or untimed: {above}")
    return res


def _p30_stage_table(dev, module, phase3_latency_ms):
    """30c: both stage tables; the on-device stages' sum against phase
    3's call (the serving pipeline at 512^2, B=8, each call synchronised),
    timed in the same rounds as the stages' prefix streams
    (stage_table.CALLS_PER_ROUND after each round), and taken as their
    median: the host's speed drifts within seconds (phase 3 ran minutes
    earlier, and calls timed before and after the table once read 30%
    apart from it); phase 3's own figure is printed beside."""
    from xpoint_tpu_torch.eval import make_pair_pipeline
    from xpoint_tpu_torch.tools import stage_table
    host = stage_table.host_staged_table(module, H, W)
    host_ms = {k: 1e3 * sum(v) / len(v) for k, v in host.items()}
    print("phase 30 stage_table host-staged (B=1, ms): "
          + json.dumps(host_ms), flush=True)
    run = make_pair_pipeline(module, (H, W), k=1024, nms_size=8,
                             detection_threshold=0.015)
    stages, cumulative, calls = stage_table.on_device_table(module, B, H, W,
                                                            call=run)
    call_ms = _median(calls)
    dev_ms = {k: 1e3 * v for k, v in stages.items()}
    cum_ms = {k: 1e3 * v for k, v in cumulative.items()}
    total_ms = sum(dev_ms.values())
    print(f"phase 30 stage_table on-device (B={B}, ms a batch): "
          + json.dumps(dev_ms) + f"; sum {total_ms} against phase 3's "
          f"call {call_ms} timed in turns with the stages (calls "
          f"{calls}; phase 3: {phase3_latency_ms}); cumulative "
          f"{json.dumps(cum_ms)}", flush=True)
    if abs(total_ms - call_ms) > 0.25 * call_ms:
        raise SystemExit(f"stage_table: the on-device stages sum to "
                         f"{total_ms} ms, phase 3's call {call_ms}")
    return {"host_staged_ms": host_ms, "on_device_ms": dev_ms,
            "on_device_sum_ms": total_ms, "cumulative_ms": cum_ms,
            "call_ms": call_ms, "call_all_ms": calls,
            "phase3_latency_ms": phase3_latency_ms}


def _p30_parse_trace(dev, module, workdir):
    """30d: a torch.profiler trace of P30_CALLS pipeline calls through
    tools.parse_trace: K1's and K2's launches by their kernels' names
    (one bidir_chain_kernel or bidir_span_kernel a K1 launch; K2's
    serving call is one nms_resident_kernel), against the wrappers' counts
    (zeroed just before the calls, read just after)."""
    from torch.profiler import ProfilerActivity, profile
    from xpoint_tpu_torch.eval import make_pair_pipeline
    from xpoint_tpu_torch.tools import parse_trace
    run = make_pair_pipeline(module, (H, W), k=1024, nms_size=8,
                             detection_threshold=0.015)
    g = torch.Generator(device=dev).manual_seed(30)
    images = [(torch.rand(B, H, W, 1, generator=g, device=dev),
               torch.rand(B, H, W, 1, generator=g, device=dev))
              for _ in range(P30_CALLS + 1)]
    run(*images[0])
    torch.cuda.synchronize()
    read = _zero_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for img_o, img_t in images[1:]:
            run(img_o, img_t)
        torch.cuda.synchronize()
    launches = {k: v for k, v in read().items()
                if k in ("selective_scan_bidir", "nms_sweep")}
    path = f"{workdir}/p30_trace.json"
    prof.export_chrome_trace(path)
    total, by_cat, by_name, counts = parse_trace.summarize(
        parse_trace.load_events(parse_trace.find_trace(path)))
    found = {"selective_scan_bidir": sum(
                 parse_trace.launches(counts, name) for name in
                 ("bidir_chain_kernel", "bidir_span_kernel")),
             "nms_sweep": parse_trace.launches(counts,
                                               "nms_resident_kernel")}
    top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    res = {"calls": P30_CALLS, "device_ms": total,
           "device_ms_per_call": total / P30_CALLS, "by_category_ms": by_cat,
           "top_ms": [[c, n, ms] for (c, n), ms in top],
           "launches_by_name": found, "launches_counted": launches}
    print("phase 30 parse_trace: " + json.dumps(res), flush=True)
    want = {"selective_scan_bidir": 16 * P30_CALLS, "nms_sweep": P30_CALLS}
    if found != want or launches != want:
        raise SystemExit(f"parse_trace found {found} launches, the counts "
                         f"{launches}, the pipeline makes {want}")
    return res


def _p30_op_sweep(dev, workdir, phase20):
    """30e: tools.op_sweep over a 2-point grid on phase 20's config,
    model and pairs (its processes: python -m
    xpoint_tpu_torch.cli.benchmark); the first point is phase 20's
    operating point and must give its MAGSAC sweep's metrics."""
    from xpoint_tpu_torch.tools import op_sweep
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "configs", "cipdp.yaml")) as f:
        text = f.read()
    old = "    filename: data/MULTIPOINT/test.hdf5\n"
    if old not in text:
        raise SystemExit("configs/cipdp.yaml names no test.hdf5 to replace")
    eval_yaml = f"{workdir}/p30_eval.yaml"
    with open(eval_yaml, "w") as f:
        f.write(text.replace(old, f"    filename:\n    foldername: "
                                  f"{workdir}/flagship_corpus\n"))
    t0 = time.perf_counter()
    rows = op_sweep.main([
        "--work", f"{workdir}/p30_opsweep", "--model", f"{workdir}/flagship",
        "--eval-yaml", eval_yaml, "--seed", "0", "--grid", P30_GRID,
        "--max-samples", str(EVAL_SAMPLES), "--device", dev.type,
        "--out", f"{workdir}/p30_opsweep.json"])
    sweep_s = time.perf_counter() - t0
    want = phase20["sweep"]["magsac"]
    pairs = {"rep3": "repeatability@3", "nn_map3": "nn_map@3",
             "m_score3": "m_score@3", "h3": "h_correctness@3"}
    diff = {k: (rows[0][k], want[v]) for k, v in pairs.items()
            if rows[0][k] != want[v]}
    res = {"grid": rows, "s": sweep_s, "first_point_vs_phase20": diff}
    print("phase 30 op_sweep: " + json.dumps(res), flush=True)
    if len(rows) != 2 or diff:
        raise SystemExit(f"op_sweep's first point differs from phase 20's "
                         f"sweep: {diff}")
    return res


def _read_gray(path):
    import cv2
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY) / 255.0


def _cv2_bound(img):
    """The most cv2's bilinear warp may differ from exact sampling on
    ``img``: OpenCV 4 looks its weights up at sample positions rounded to
    1/32 pixel (INTER_BITS 5), half a step off on each axis at most, so
    by the image's largest neighbour difference on each axis / 64."""
    dy = float(np.abs(np.diff(img, axis=0)).max())
    dx = float(np.abs(np.diff(img, axis=1)).max())
    return (dx + dy) / 64


def _exact_warp(img, H, reflect=True):
    """``img`` sampled bilinearly in float64 at H^-1 of each pixel (cv2's
    convention: pixel centres at integers), the sample positions in
    float64, every tap outside the image mirrored into it without
    repeating the edge (BORDER_REFLECT_101) or, with ``reflect`` False,
    read as 0 (BORDER_CONSTANT); with the (h, w) mask of the pixels whose
    four taps lie inside the image."""
    h, w = img.shape
    Hi = np.linalg.inv(np.asarray(H, np.float64))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    den = Hi[2, 0] * xs + Hi[2, 1] * ys + Hi[2, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = (Hi[0, 0] * xs + Hi[0, 1] * ys + Hi[0, 2]) / den
        sy = (Hi[1, 0] * xs + Hi[1, 1] * ys + Hi[1, 2]) / den
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    inside = (x0 >= 0) & (y0 >= 0) & (x0 < w - 1) & (y0 < h - 1)
    src = img.astype(np.float64)

    def tap(yy, xx):
        if reflect:
            py, px = 2 * (h - 1), 2 * (w - 1)
            yy, xx = np.mod(yy, py), np.mod(xx, px)
            yy, xx = np.where(yy >= h, py - yy, yy), np.where(xx >= w, px - xx,
                                                             xx)
            return src[yy, xx]
        ok = (yy >= 0) & (xx >= 0) & (yy < h) & (xx < w)
        return np.where(ok, src[yy.clip(0, h - 1), xx.clip(0, w - 1)], 0.0)

    out = ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1))
           + fy * ((1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)))
    return out, inside


def _p30_native(workdir):
    """30f (the engine): built on this host; homographic_augmentation on
    512^2 corpus images with the flagship's homographic settings, through
    the engine (the default) and through cv2 (XPOINT_NO_NATIVE=1) from the
    same generator states. The engine within test_native.py's 2e-3 of
    float64 sampling at the same homography (_exact_warp) on every pixel,
    the reflected border included; on the pixels that sample inside the
    image, within cv2's own rounding of cv2 (_cv2_bound: OpenCV 4 rounds
    sample positions to 1/32 pixel, which test_native.py's 2e-3 against
    cv2 does not allow for on images with edges; on the reflected border
    its 16-bit coordinates saturate at the extreme homographies of this
    config); the masks within test_native.py's 1% (2% with erosion); on
    float32 images and on the float64 images the folder dataset reads; ms
    a float32 sample each."""
    import cv2
    from xpoint_tpu_torch import native
    from xpoint_tpu_torch.data.augmentation import homographic_augmentation
    from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG
    t0 = time.perf_counter()
    lib = native.build()
    native.load()
    build_s = time.perf_counter() - t0
    hcfg = VMAMBA_TRAIN_CFG["dataset"]["augmentation"]["homographic"]
    reflect = hcfg.get("border_reflect", True)
    kw = dict(params=dict(hcfg["params"]), border_reflect=reflect,
              valid_border_margin=hcfg.get("valid_border_margin", 0),
              return_homography=True)
    # test_native.py's limits on the masks' differing share: 1% without
    # erosion, 2% with
    mask_limit = 0.02 if kw["valid_border_margin"] else 0.01
    res = {"library": os.path.basename(lib), "build_s": build_s,
           "cv2": cv2.__version__, "border_reflect": reflect,
           "mask_limit": mask_limit}
    ms = {"engine": [], "cv2": []}
    fail = []
    for dtype in (np.float32, np.float64):
        row = {"exact_max_abs_err": 0.0, "exact_max_abs_err_inside": 0.0,
               "cv2_max_abs_err_inside": 0.0, "cv2_bound": 0.0,
               "mask_share_differing": 0.0}
        for i in range(P30_SAMPLES):
            img = _read_gray(f"{workdir}/flagship_corpus/optical/"
                             f"{i:04d}.png").astype(dtype)
            out = {}
            for path in ("engine", "cv2"):
                if path == "cv2":
                    os.environ["XPOINT_NO_NATIVE"] = "1"
                t0 = time.perf_counter()
                try:
                    out[path] = homographic_augmentation(
                        img, np.random.RandomState(i), **kw)
                finally:
                    os.environ.pop("XPOINT_NO_NATIVE", None)
                if dtype is np.float32:
                    ms[path].append((time.perf_counter() - t0) * 1e3)
            a, b = out["engine"], out["cv2"]
            exact, inside = _exact_warp(img, a[3], reflect)
            off = np.abs(a[0] - exact)
            bound = _cv2_bound(img)
            err = float(np.abs(a[0] - b[0])[inside].max())
            row["exact_max_abs_err"] = max(row["exact_max_abs_err"],
                                           float(off.max()))
            row["exact_max_abs_err_inside"] = max(
                row["exact_max_abs_err_inside"], float(off[inside].max()))
            row["cv2_max_abs_err_inside"] = max(
                row["cv2_max_abs_err_inside"], err)
            row["cv2_bound"] = max(row["cv2_bound"], bound)
            row["mask_share_differing"] = max(
                row["mask_share_differing"], float((a[2] != b[2]).mean()))
            if err > bound + 1e-6:
                fail.append(f"{np.dtype(dtype).name} sample {i}: {err} "
                            f"against cv2's rounding {bound}")
        res[np.dtype(dtype).name] = row
        if row["exact_max_abs_err"] >= 2e-3:
            fail.append(f"{np.dtype(dtype).name}: {row['exact_max_abs_err']}"
                        f" from exact sampling")
        if row["mask_share_differing"] >= mask_limit:
            fail.append(f"{np.dtype(dtype).name}: masks differ on "
                        f"{row['mask_share_differing']} of the pixels")
    res["ms_per_sample"] = {k: _median(v) for k, v in ms.items()}
    if fail:
        raise SystemExit(f"the native engine: {fail}")
    return res


def _p30_loop(dev, workdir):
    """30f (phase 19's loop): one epoch of phase 19's Trainer on its corpus,
    alternately with the engine (the default) and with cv2
    (XPOINT_NO_NATIVE=1), twice each: the loop's ms a step (from the first
    step's start to the last's) and the step's own ms (median)."""
    from xpoint_tpu_torch.data import get_dataset
    from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG
    from xpoint_tpu_torch.trainer import Trainer
    cfg = copy.deepcopy(VMAMBA_TRAIN_CFG)
    ds_cfg = cfg["dataset"]
    del ds_cfg["filename"], ds_cfg["keypoints_filename"]
    ds_cfg.update(foldername=f"{workdir}/flagship_corpus",
                  keypoints_filename=f"{workdir}/flagship_labels.npz")
    cfg["training"].update(n_epochs=1, save_every_n_epoch=0,
                           use_writer=False)
    dataset = get_dataset(ds_cfg)
    runs = {"engine": [], "cv2": []}
    for i, path in enumerate(("engine", "cv2", "engine", "cv2")):
        if path == "cv2":
            os.environ["XPOINT_NO_NATIVE"] = "1"
        try:
            t = Trainer(cfg, f"{workdir}/p30_loop_{i}", seed=0, device=dev,
                        dataset=dataset)
            rows, inner = [], t.train_step

            def step(*args, inner=inner, rows=rows):
                t0 = time.perf_counter()
                comps = inner(*args)
                torch.cuda.synchronize()
                rows.append((t0, (time.perf_counter() - t0) * 1e3))
                return comps
            t.train_step = step
            t.train()
        finally:
            os.environ.pop("XPOINT_NO_NATIVE", None)
        runs[path].append({
            "loop_ms_per_step": (rows[-1][0] - rows[0][0]) * 1e3
            / (len(rows) - 1),
            "step_ms": _median([ms for _, ms in rows[1:]])})
    res = {k: {"loop_ms_per_step": [r["loop_ms_per_step"] for r in v],
               "step_ms": [r["step_ms"] for r in v]}
           for k, v in runs.items()}
    print("phase 30 phase-19 loop, engine against cv2: " + json.dumps(res),
          flush=True)
    return res


def _p30_clis(workdir):
    """30h: the show_* CLIs on three pairs of phase 19's corpus (an .npz of
    groups) and its labels, SyntheticShapes samples, and the MULTIPOINT
    fixture as an .npz."""
    import cv2
    from xpoint_tpu_torch.cli import (show_image_pair_sample, show_keypoints,
                                      show_synthetic_images)
    from xpoint_tpu_torch.data.group_file import open_group_file, write_groups
    from xpoint_tpu_torch.tools import make_multipoint_fixture
    corpus = f"{workdir}/flagship_corpus"
    data = f"{workdir}/p30_pairs.npz"
    write_groups(data, {f"{i:04d}.png": {
        side: _read_gray(f"{corpus}/{side}/{i:04d}.png").astype(np.float32)
        for side in ("optical", "thermal")} for i in range(3)})
    labels, out = f"{workdir}/flagship_labels.npz", f"{workdir}/p30_show"
    show_keypoints.main(["-d", data, "-k", labels, "-n", "0", "-o", out])
    show_image_pair_sample.main(["-i", data, "-k", labels, "-n", "1",
                                 "-o", out])
    show_synthetic_images.main(["-n", "2", "-o", out])
    fixture = f"{workdir}/p30_fixture.npz"
    make_multipoint_fixture.main(["--out", fixture])
    shapes, green = {}, {}
    for name in sorted(os.listdir(out)):
        im = cv2.imread(os.path.join(out, name))
        shapes[name] = list(im.shape)
        green[name] = int(((im[..., 0] == 0) & (im[..., 1] == 255)
                           & (im[..., 2] == 0)).sum())
    with open_group_file(fixture) as f:
        members = {n: {d: [list(f[n][d].shape), str(f[n][d].dtype)]
                       for d in f[n].keys()} for n in f.keys()}
    res = {"png_shapes": shapes, "green_pixels": green,
           "fixture": members}
    print("phase 30 show CLIs and fixture: " + json.dumps(res), flush=True)
    want = {"show_optical_0000.png.png": [H, W, 3],
            "show_thermal_0000.png.png": [H, W, 3],
            "pair_0001.png.png": [H, 2 * W, 3]}
    if (any(shapes.get(k) != v for k, v in want.items())
            or any(green[k] == 0 for k in want)
            or sum(k.startswith("synthetic_") for k in shapes) != 2
            or len(members) != 3
            or sum("thermal_raw" in m for m in members.values()) != 1):
        raise SystemExit(f"the show_* CLIs or the fixture wrote unexpected "
                         f"files: {res}")
    return res


def phase_tools(dev, workdir, module, stages, depths, scan_tot,
                phase3_latency_ms, phase20):
    """30: the measuring tools, the CLIs of the last slice and the native
    engine at full width (see the module docstring)."""
    res = {"model_cost": _p30_model_cost(module, stages, depths, scan_tot),
           "roofline": _p30_roofline(module),
           "stage_table": _p30_stage_table(dev, module, phase3_latency_ms),
           "parse_trace": _p30_parse_trace(dev, module, workdir),
           "op_sweep": _p30_op_sweep(dev, workdir, phase20),
           "native": _p30_native(workdir),
           "loop": _p30_loop(dev, workdir),
           "clis": _p30_clis(workdir)}
    n = res["native"]
    print(f"phase 30 native engine (OpenCV {n['cv2']} for the cv2 path): "
          f"build {n['build_s']:.2f} s, ms a 512^2 "
          f"sample {n['ms_per_sample']}, float32 {n['float32']}, float64 "
          f"(the folder dataset's images) {n['float64']}", flush=True)
    return res


def host_modules():
    """Which of the host data path's modules (and tqdm, which the JAX
    package's evaluation imports and the port does not) import here."""
    import importlib
    found = {}
    for name in ("yaml", "h5py", "cv2", "tqdm"):
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    from xpoint_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.time()
    build_log = build.build_all(verbose=True)
    build_s = time.time() - t0
    for name, log in build_log.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)
    print(f"kernel build: {build_s:.1f} s", flush=True)
    train_stages = [((TRAIN_S // 4 >> i) ** 2, 96 << i) for i in range(4)]
    if sys.argv[1:] == ["--k3-checkpoint-gap"]:
        print(json.dumps({"k3_checkpoint_gap": k3_checkpoint_gap(
            dev, train_stages)}), flush=True)
        return 0
    if sys.argv[1:] == ["--k3-stage-times"]:
        print(json.dumps({"k3_stage_times": k3_stage_times(
            dev, train_stages)}), flush=True)
        return 0
    if sys.argv[1:2] == ["--k2-shape-times"]:
        earlier = sys.argv[2] if len(sys.argv) > 2 else None
        print(json.dumps({"k2_shape_times": k2_shape_times(
            serving_heatmaps(dev), earlier)}), flush=True)
        return 0

    # stage shapes the main path gives K1: L = (H/4 / 2^i)^2, Dim = 96 * 2^i
    depths = (2, 2, 2, 2)
    stages = [((H // 4 >> i) * (W // 4 >> i), 96 << i) for i in range(4)]
    scan_rows, scan_tot, scan_err, scan_tails = phase_scan(
        dev, stages, [2 * d for d in depths])
    k1_design = k1_design_report(dev, build_log, stages)
    main_res, probs, serve_module = phase_main_path(dev)
    nms_res = phase_nms(probs)
    main_res["nms_sweeps_per_call"] = nms_res["sweeps"]
    # boxes above 16 (the banded instance) on the serving heatmaps and on
    # one of their planes
    k2_large = [k2_on(p, size, 0.015, f"serving, {tag}")
                for size in (24, 32)
                for p, tag in ((probs, "16 planes"), (probs[:1], "1 plane"))]
    print("K2 banded instance (boxes above 16): ptxas "
          f"{ptxas_summary(build_log['nms_sweep'], 'nms_kernelILi0E')}; "
          "launch shape (smem_bytes a block, blocks_per_sm resident, band "
          "rows, table levels, staged columns) " + "; ".join(
              f"size {r['size']} {tuple(r['shape'])}: {r['launch_shape']}"
              for r in k2_large), flush=True)
    ref_res = phase_reference(dev)
    # the training stage shapes (256^2, B=16); each stage has 2 passes x 2
    # blocks, as a serving call has
    (tscan_rows, tscan_tot, k1t_err, k3_err, tscan_tails,
     k3_tails) = phase_train_scan(dev, train_stages, [2 * d for d in depths])
    k3_design = k3_design_report(dev, build_log, train_stages)
    k3_gap = k3_checkpoint_gap(dev, train_stages)
    train_res = phase_train(dev)
    tref_res = phase_train_reference(dev)
    warp_rows, warp_odd = phase_warp(dev)
    ha_res = phase_ha(dev)
    fused_rows, fused_tot, fused_err, fused_tails = phase_fused_scan(
        dev, stages, [2 * d for d in depths])
    bidi_res = phase_bidi_path(dev)
    haref_res = phase_ha_reference(dev)
    k6_rows, k6_tot, k6_err = phase_linear_scan(
        dev, train_stages, [2 * d for d in depths])
    tfused_rows, tfused_tot, tfused_err, _ = phase_fused_scan(
        dev, train_stages, [2 * d for d in depths], batch=TRAIN_B)
    bidi_train_res = phase_train(dev, "v052d_noz", n_steps=5)
    trefs = [phase_train_reference(dev, *args) for args in (
        ("v052d_noz", 1, ("selective_scan_fused", "linear_scan")),
        ("v05", 4, ("linear_scan",)),
        ("v052dc_noz", 1, ("selective_scan_fused", "linear_scan")))]

    host = host_modules()
    print(f"host data path modules that import here: {host}", flush=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        synth_res = phase_synth_pretrain(dev, workdir)
        cnn_ref = phase_cnn_train_reference(dev)
        cnn_export = phase_cnn_export(dev, f"{workdir}/synth")
        cnn_pair = phase_cnn_pair(dev, workdir)
        flagship_host = phase_flagship_host(dev, workdir,
                                            train_res["step_ms"])
        eval_res = phase_eval(dev, workdir, serve_module,
                              main_res["latency_ms"], train_stages, depths)
        cycle_res = phase_cycle(dev, workdir)
        clis_res = phase_clis(dev, workdir, depths)
        swin_serve, swin_module = phase_swin_serve(dev)
        swin_train = phase_swin_train(dev, workdir)
        swin_export = phase_swin_export(dev, swin_module)
        del swin_module
        xv_serve = phase_xv_m0_serve(dev, stages)
        xv_train = phase_xv_m0_train(dev, train_stages, depths)
        base = phase_baselines(dev, workdir)
        md = phase_multidevice(dev, workdir, serve_module, card)
        tools_res = phase_tools(dev, workdir, serve_module, stages, depths,
                                scan_tot, main_res["latency_ms"], eval_res)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # each HA step makes the image warp, the mask unwarp and one probability
    # unwarp: of one map per pair in prod aggregation (the three samples),
    # of two in window aggregation (the export)
    k4_prod = sum(r["launches"]["warp_projective"] for r in ha_res["samples"])
    k4_export = ha_res["export"]["launches"]["warp_projective"]
    if k4_prod % 3 or k4_export % 3:
        raise SystemExit("HA launched K4 a number of times that is no "
                         "multiple of its three calls per step")
    k4_launches = {"image warp": (k4_prod + k4_export) // 3,
                   "mask unwarp": (k4_prod + k4_export) // 3,
                   "prob unwarp": k4_prod // 3,
                   "prob unwarp, 2 maps": k4_export // 3}
    # both sweeps are checked to launch what the code predicts: the MAGSAC
    # sweep's counts stand for the path's
    eval_launches = eval_res["sweep"]["magsac"]["launches"]
    k1 = {"route": "cuda",
          "source": "xpoint_tpu_torch/csrc/selective_scan_bidir.cu",
          "replaces": "xpoint_tpu/ops/selective_scan_pallas.py:306",
          "bound_by": "bytes", "library_ms": None}
    kernels = [
        {"name": "selective_scan_bidir", "path": "serve", **k1,
         "launches": main_res["launches"]["selective_scan_bidir"],
         "max_abs_err": scan_err, "ms": scan_tot["ms"],
         "ms_with_host_launch": scan_tot["ms_with_host_launch"],
         "plain_ms": scan_tot["plain_ms"], "bound_ms": scan_tot["bound_ms"]},
        {"name": "nms_sweep", "path": "serve", "route": "cuda",
         "source": "xpoint_tpu_torch/csrc/nms_sweep.cu",
         "replaces": "xpoint_tpu/ops/nms.py:36",
         "launches": main_res["launches"]["nms_sweep"],
         "max_abs_err": 0.0, "ms": nms_res["ms"],
         "ms_with_host_launch": nms_res["ms_with_host_launch"],
         "plain_ms": nms_res["plain_ms"], "bound_ms": nms_res["bound_ms"],
         "bound_by": nms_res["bound_by"],
         "bound_sweep_bytes_ms": nms_res["bound_sweep_bytes_ms"],
         "launch_shape": nms_res["launch_shape"],
         "library_ms": None},
        {"name": "selective_scan_bidir", "path": "train (emit_ckpt)", **k1,
         "launches": train_res["launches"]["selective_scan_bidir"],
         "max_abs_err": k1t_err, "ms": tscan_tot["k1_ms"],
         "ms_with_host_launch": tscan_tot["k1_ms_with_host_launch"],
         "plain_ms": tscan_tot["k1_plain_ms"],
         "bound_ms": tscan_tot["k1_bound_ms"]},
        {"name": "selective_scan_bidir_bwd", "path": "train",
         "route": "cuda",
         "source": "xpoint_tpu_torch/csrc/selective_scan_bidir_bwd.cu",
         "replaces": "xpoint_tpu/ops/selective_scan_pallas.py:530",
         "launches": train_res["launches"]["selective_scan_bidir_bwd"],
         "max_abs_err": k3_err, "ms": tscan_tot["k3_ms"],
         "ms_with_host_launch": tscan_tot["k3_ms_with_host_launch"],
         "plain_ms": tscan_tot["k3_plain_ms"],
         "bound_ms": tscan_tot["k3_bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "selective_scan_bidir",
         "path": "train on host data (emit_ckpt)", **k1,
         "launches": flagship_host["launches"]["selective_scan_bidir"],
         "max_abs_err": k1t_err, "ms": tscan_tot["k1_ms"],
         "ms_with_host_launch": tscan_tot["k1_ms_with_host_launch"],
         "plain_ms": tscan_tot["k1_plain_ms"],
         "bound_ms": tscan_tot["k1_bound_ms"]},
        {"name": "selective_scan_bidir_bwd", "path": "train on host data",
         "route": "cuda",
         "source": "xpoint_tpu_torch/csrc/selective_scan_bidir_bwd.cu",
         "replaces": "xpoint_tpu/ops/selective_scan_pallas.py:530",
         "launches": flagship_host["launches"]["selective_scan_bidir_bwd"],
         "max_abs_err": k3_err, "ms": tscan_tot["k3_ms"],
         "ms_with_host_launch": tscan_tot["k3_ms_with_host_launch"],
         "plain_ms": tscan_tot["k3_plain_ms"],
         "bound_ms": tscan_tot["k3_bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ] + [
        {"name": "nms_sweep",
         "path": f"serve heatmaps {tuple(r['shape'])}, size {r['size']}",
         "route": "cuda", "source": "xpoint_tpu_torch/csrc/nms_sweep.cu",
         "replaces": "xpoint_tpu/ops/nms.py:36", "launches": r["launches"],
         "max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": None}
        for r in k2_large
    ] + [
        {"name": "warp_projective", "path": f"ha ({r['call']})",
         "route": "cuda",
         "source": "xpoint_tpu_torch/csrc/warp_projective.cu",
         "replaces": "xpoint_tpu/ops/warp_tiled.py:129",
         "launches": k4_launches[r["call"]],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "library_with_grid_ms": r["library_with_grid_ms"]}
        for r in warp_rows
    ] + [
        {"name": "selective_scan_fused", "path": "serve (v052d_noz)",
         "route": "cuda",
         "source": "xpoint_tpu_torch/csrc/selective_scan_fused.cu",
         "replaces": "xpoint_tpu/ops/selective_scan_pallas.py:121",
         "launches": bidi_res["launches"]["selective_scan_fused"],
         "max_abs_err": fused_err, "ms": fused_tot["ms"],
         "ms_with_host_launch": fused_tot["ms_with_host_launch"],
         "plain_ms": fused_tot["plain_ms"],
         "bound_ms": fused_tot["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "selective_scan_fused", "path": "train (v052d_noz)",
         "route": "cuda",
         "source": "xpoint_tpu_torch/csrc/selective_scan_fused.cu",
         "replaces": "xpoint_tpu/ops/selective_scan_pallas.py:121",
         "launches": bidi_train_res["launches"]["selective_scan_fused"],
         "max_abs_err": tfused_err, "ms": tfused_tot["ms"],
         "ms_with_host_launch": tfused_tot["ms_with_host_launch"],
         "plain_ms": tfused_tot["plain_ms"],
         "bound_ms": tfused_tot["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        *[{"name": "nms_sweep", "path": path, "route": "cuda",
           "source": "xpoint_tpu_torch/csrc/nms_sweep.cu",
           "replaces": "xpoint_tpu/ops/nms.py:36", "launches": n,
           "max_abs_err": 0.0, "ms": k2["ms"], "plain_ms": k2["plain_ms"],
           "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
           "library_ms": None}
          for path, n, k2 in (
              ("cnn export", cnn_export["launches"]["nms_sweep"],
               cnn_export["k2"]),
              ("cnn serve", cnn_pair["serve"]["launches"]["nms_sweep"],
               cnn_pair["serve"]["k2"]))],
        *[{"name": "warp_projective", "path": f"cnn export ({r['call']})",
           "route": "cuda",
           "source": "xpoint_tpu_torch/csrc/warp_projective.cu",
           "replaces": "xpoint_tpu/ops/warp_tiled.py:129",
           "launches": cnn_export["launches"]["warp_projective"] // 3,
           "max_abs_err": r["max_abs_err"], "ms": r["ms"],
           "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
           "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
          for r in warp_rows if r["call"] in (
              "image warp", "mask unwarp", "prob unwarp, 2 maps")],
        {"name": "linear_scan", "path": "train (v052d_noz)",
         "route": "cuda",
         "source": "xpoint_tpu_torch/csrc/linear_scan.cu",
         "replaces": "xpoint_tpu/ops/selective_scan_pallas.py:34",
         "launches": bidi_train_res["launches"]["linear_scan"],
         "max_abs_err": k6_err, "ms": k6_tot["ms"],
         "plain_ms": k6_tot["plain_ms"], "bound_ms": k6_tot["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "selective_scan_bidir", "path": "eval (256^2, B=1)", **k1,
         "launches": eval_launches["selective_scan_bidir"],
         "max_abs_err": eval_res["k1_err"],
         "ms": eval_res["k1_per_pair"]["ms"],
         "ms_with_host_launch": eval_res["k1_per_pair"][
             "ms_with_host_launch"],
         "plain_ms": eval_res["k1_per_pair"]["plain_ms"],
         "bound_ms": eval_res["k1_per_pair"]["bound_ms"]},
        {"name": "nms_sweep", "path": "eval (256^2, one plane)",
         "route": "cuda", "source": "xpoint_tpu_torch/csrc/nms_sweep.cu",
         "replaces": "xpoint_tpu/ops/nms.py:36",
         "launches": eval_launches["nms_sweep"], "max_abs_err": 0.0,
         "ms": eval_res["k2"]["ms"], "plain_ms": eval_res["k2"]["plain_ms"],
         "bound_ms": eval_res["k2"]["bound_ms"],
         "bound_by": eval_res["k2"]["bound_by"], "library_ms": None},
        {"name": "nms_sweep",
         "path": "cycle eval (256^2, one masked plane, size 4)",
         "route": "cuda", "source": "xpoint_tpu_torch/csrc/nms_sweep.cu",
         "replaces": "xpoint_tpu/ops/nms.py:36",
         "launches": cycle_res["launches"]["benchmark"]["nms_sweep"],
         "max_abs_err": 0.0, "ms": cycle_res["k2"]["ms"],
         "plain_ms": cycle_res["k2"]["plain_ms"],
         "bound_ms": cycle_res["k2"]["bound_ms"],
         "bound_by": cycle_res["k2"]["bound_by"], "library_ms": None},
        *[{"name": "warp_projective",
           "path": f"cycle export ({r['call']}, 4 warps at 256^2)",
           "route": "cuda",
           "source": "xpoint_tpu_torch/csrc/warp_projective.cu",
           "replaces": "xpoint_tpu/ops/warp_tiled.py:129",
           "launches": cycle_res["launches"]["export_keypoints"][
               "warp_projective"] // 3,
           "max_abs_err": r["max_abs_err"], "ms": r["ms"],
           "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
           "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
          for r in cycle_res["k4"]],
        {"name": "selective_scan_bidir", "path": "clis (512^2, B=1)", **k1,
         "launches": clis_res["launches"]["selective_scan_bidir"],
         "max_abs_err": clis_res["k1_err"],
         "ms": clis_res["k1_per_pair"]["ms"],
         "ms_with_host_launch": clis_res["k1_per_pair"][
             "ms_with_host_launch"],
         "plain_ms": clis_res["k1_per_pair"]["plain_ms"],
         "bound_ms": clis_res["k1_per_pair"]["bound_ms"]},
        {"name": "nms_sweep", "path": "clis (512^2, one plane, size 8)",
         "route": "cuda", "source": "xpoint_tpu_torch/csrc/nms_sweep.cu",
         "replaces": "xpoint_tpu/ops/nms.py:36",
         "launches": clis_res["launches"]["nms_sweep"], "max_abs_err": 0.0,
         "ms": clis_res["k2"]["ms"], "plain_ms": clis_res["k2"]["plain_ms"],
         "bound_ms": clis_res["k2"]["bound_ms"],
         "bound_by": clis_res["k2"]["bound_by"], "library_ms": None},
        *[{"name": "warp_projective",
           "path": f"clis export ({r['call']}, 4 warps at 512^2)",
           "route": "cuda",
           "source": "xpoint_tpu_torch/csrc/warp_projective.cu",
           "replaces": "xpoint_tpu/ops/warp_tiled.py:129",
           "launches": clis_res["launches"]["warp_projective"] // 3,
           "max_abs_err": r["max_abs_err"], "ms": r["ms"],
           "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
           "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
          for r in clis_res["k4"]],
        *[{"name": "nms_sweep", "path": path, "route": "cuda",
           "source": "xpoint_tpu_torch/csrc/nms_sweep.cu",
           "replaces": "xpoint_tpu/ops/nms.py:36", "launches": n,
           "max_abs_err": 0.0, "ms": k2["ms"], "plain_ms": k2["plain_ms"],
           "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
           "library_ms": None}
          for path, n, k2 in (
              ("swin serve (16 planes 512^2, size 8)",
               swin_serve["launches"]["nms_sweep"], swin_serve["k2"]),
              ("swin export (2 planes 512^2, size 4)",
               swin_export["launches"]["nms_sweep"], swin_export["k2"]))],
        *[{"name": "warp_projective",
           "path": f"swin export ({r['call']}, 8 warps at 512^2)",
           "route": "cuda",
           "source": "xpoint_tpu_torch/csrc/warp_projective.cu",
           "replaces": "xpoint_tpu/ops/warp_tiled.py:129",
           "launches": swin_export["launches"]["warp_projective"] // 3,
           "max_abs_err": r["max_abs_err"], "ms": r["ms"],
           "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
           "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
          for r in swin_export["k4"]],
        {"name": "selective_scan_fused", "path": "serve (xv1a)",
         "route": "cuda",
         "source": "xpoint_tpu_torch/csrc/selective_scan_fused.cu",
         "replaces": "xpoint_tpu/ops/selective_scan_pallas.py:121",
         "launches": xv_serve["xv1a"]["launches"]["selective_scan_fused"],
         "max_abs_err": fused_err, "ms": fused_tot["ms"],
         "ms_with_host_launch": fused_tot["ms_with_host_launch"],
         "plain_ms": fused_tot["plain_ms"],
         "bound_ms": fused_tot["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "selective_scan_fused", "path": "train (xv1a)",
         "route": "cuda",
         "source": "xpoint_tpu_torch/csrc/selective_scan_fused.cu",
         "replaces": "xpoint_tpu/ops/selective_scan_pallas.py:121",
         "launches": xv_train["xv1a"]["launches"]["selective_scan_fused"],
         "max_abs_err": tfused_err, "ms": tfused_tot["ms"],
         "ms_with_host_launch": tfused_tot["ms_with_host_launch"],
         "plain_ms": tfused_tot["plain_ms"],
         "bound_ms": tfused_tot["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "linear_scan", "path": "train (xv1a, N=1 backward)",
         "route": "cuda",
         "source": "xpoint_tpu_torch/csrc/linear_scan.cu",
         "replaces": "xpoint_tpu/ops/selective_scan_pallas.py:34",
         "launches": xv_train["xv1a"]["launches"]["linear_scan"],
         "max_abs_err": k6_err, "ms": k6_tot["ms"],
         "plain_ms": k6_tot["plain_ms"], "bound_ms": k6_tot["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "linear_scan", "path": "train (xv1a, N=16)",
         "route": "cuda",
         "source": "xpoint_tpu_torch/csrc/linear_scan.cu",
         "replaces": "xpoint_tpu/ops/selective_scan_pallas.py:34",
         "launches": xv_train["xv1a_n16"]["launches"]["linear_scan"],
         "max_abs_err": xv_train["k6_n16"]["max_abs_err"],
         "ms": xv_train["k6_n16"]["per_step"]["ms"],
         "plain_ms": xv_train["k6_n16"]["per_step"]["plain_ms"],
         "bound_ms": xv_train["k6_n16"]["per_step"]["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        *[{"name": "nms_sweep", "path": path, "route": "cuda",
           "source": "xpoint_tpu_torch/csrc/nms_sweep.cu",
           "replaces": "xpoint_tpu/ops/nms.py:36", "launches": n,
           "max_abs_err": 0.0, "ms": k2["ms"], "plain_ms": k2["plain_ms"],
           "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
           "library_ms": None}
          for path, n, k2 in (
              ("serve (m0_noz, 16 planes 512^2, size 8)",
               xv_serve["m0_noz"]["launches"]["nms_sweep"],
               xv_serve["k2_m0"]),
              ("SIFT sweep (one masked plane 256^2, size 8)",
               base["sift"]["launches"]["nms_sweep"], base["sift"]["k2"]),
              ("SuperPoint serve (16 planes 512^2, size 8)",
               base["superpoint"]["launches"]["nms_sweep"],
               base["superpoint"]["k2"]))],
    ] + md_kernel_rows(md, warp_rows, k1) + [
        {"name": "selective_scan_bidir",
         "path": f"profiled pipeline (phase 30, {P30_CALLS} calls)", **k1,
         "launches": tools_res["parse_trace"]["launches_counted"][
             "selective_scan_bidir"],
         "max_abs_err": scan_err, "ms": scan_tot["ms"],
         "ms_with_host_launch": scan_tot["ms_with_host_launch"],
         "plain_ms": scan_tot["plain_ms"], "bound_ms": scan_tot["bound_ms"]},
        {"name": "nms_sweep",
         "path": f"profiled pipeline (phase 30, {P30_CALLS} calls)",
         "route": "cuda", "source": "xpoint_tpu_torch/csrc/nms_sweep.cu",
         "replaces": "xpoint_tpu/ops/nms.py:36",
         "launches": tools_res["parse_trace"]["launches_counted"][
             "nms_sweep"],
         "max_abs_err": 0.0, "ms": nms_res["ms"],
         "ms_with_host_launch": nms_res["ms_with_host_launch"],
         "plain_ms": nms_res["plain_ms"], "bound_ms": nms_res["bound_ms"],
         "bound_by": nms_res["bound_by"], "library_ms": None}]
    print("details: " + json.dumps(
        {"card": card, "build_s": build_s, "k1_stages": scan_rows,
         "k1_design": k1_design,
         "k1_tails": scan_tails, "k1_ckpt_tails": tscan_tails,
         "k3_tails": k3_tails, "k3_design": k3_design,
         "k3_checkpoint_gap": k3_gap,
         "k5_tails": fused_tails,
         "main_path": main_res, "k2": nms_res, "k2_large": k2_large,
         "reference": ref_res,
         "train_scan_stages": tscan_rows, "train_path": train_res,
         "train_reference": tref_res, "k4_calls": warp_rows,
         "k4_odd_size": warp_odd, "ha": ha_res,
         "k5_stages": fused_rows, "v052d_path": bidi_res,
         "ha_reference": haref_res, "k6_cases": k6_rows,
         "k5_train_stages": tfused_rows, "v052d_train_path": bidi_train_res,
         "forward_type_train_references": trefs, "host_modules": host,
         "cnn_synth_pretrain": synth_res, "cnn_train_reference": cnn_ref,
         "cnn_export": cnn_export, "cnn_pair": cnn_pair,
         "flagship_host_data": flagship_host, "eval": eval_res,
         "cycle": cycle_res, "clis": clis_res, "swin_serve": swin_serve,
         "swin_train": swin_train, "swin_export": swin_export,
         "xv_m0_serve": xv_serve, "xv_m0_train": xv_train,
         "baselines": base, "multi_device": md, "tools": tools_res},
        default=str),
        flush=True)
    print("serve: K1 ms/plain_ms/bound_ms are per pipeline call (sum over "
          "stage shapes x launches), K2's per call (one launch runs every "
          "sweep; bound_sweep_bytes_ms: 6 B a pixel a sweep at the memory "
          "rate); "
          "train: K1 and K3 per train step (sum over stage shapes x 4 "
          "launches); K4: one row per call of an HA step (8 warps at 512^2), "
          "one launch each; each step makes the image warp, the mask unwarp "
          "and one probability unwarp (one map in the prod samples, two in "
          "the window export), and launches are the HA phase's; K5 per v052d_noz "
          "pipeline call (16 launches) and per v052d_noz train step (16); K6 "
          "per v052d_noz train step (sum over stage shapes x 4 forward and 4 "
          "reversed launches); launches count the whole run of each path; "
          "K1, K2, K3, K4, K5 and K6 ms are device times (events behind "
          "queued work), ms_with_host_launch the same calls with the host's "
          "launch path; cnn export / cnn serve: K2 timed on the heatmaps of "
          "that path (the export's maps at NMS 4, the CNN pipeline's at 8), "
          "K4 rows the HA-step calls of phase 9 (the export's shapes), "
          "launches those of phases 17 and 18; train on host data: K1 and K3 "
          "launches of phase 19 (its 16 steps), times those of phase 6 (the "
          "same shapes); nms_sweep at sizes 24 and 32: the banded instance "
          "on phase 3's heatmaps, launches per call (no path runs these "
          "sizes); eval: launches of phase 20's MAGSAC sweep (38 pair "
          "forwards, the device sweep's are equal), K1 times per pair (sum "
          "over the 256^2 stage shapes at B=1 x 4 launches), K2's per call "
          "on one masked 256^2 plane of the timing harness; cycle: "
          "launches counted in the stage processes of phase 21 (K2 in its "
          "two sweeps, K4 a call of the export), K2 timed on the sweep's "
          "masked optical plane at NMS 4, K4 at the export's three calls "
          "(4 warps at 256^2); clis: launches of phase 22's five entry-point "
          "runs, K1 per pair at the 512^2 stage shapes (B=1), K2 on one "
          "512^2 plane at size 8, K4 a call of the export (4 warps at "
          "512^2); swin serve: launches of phase 23's five timed calls of "
          "the SwinV2 pipeline, K2 timed on its heatmaps; swin export: "
          "launches of phase 25's one exported pair, K2 timed on the Swin "
          "HA maps at NMS 4, K4 at the export's calls (8 warps at 512^2); "
          "serve (xv1a): launches of phase 26's five xv1a calls, K5 times "
          "those of phase 11 (the same (B, K, L, Dim) shapes, checked); train "
          "(xv1a): launches of phase 27's 8 xv1a steps, K5 and K6 times "
          "those of phase 14 (the same shapes); train (xv1a, N=16): K6 per "
          "step over the (L, B K C N) time-major planes of each stage (4 "
          "forward and 4 reversed launches a stage); K2 rows of phases 26 "
          "and 28 timed on the heatmaps or the masked plane of that path; "
          "multi-device (phase 29): launches are rank 0's over the whole "
          "phase (3 DP train steps, 5 sharded serving calls, one ring scan, "
          "the export of 4 pairs), times at a rank's shapes (K1 and K3 per "
          "DP step at 256^2, B=8; K1 per sharded call at 512^2, B=4; K2 on "
          "a rank's 8 heatmap planes; K6 one launch on a rank's (2048, "
          "24576) block; K4 rows the HA-step calls of phase 9, the export's "
          "shapes); profiled pipeline (phase 30): launches of its 3 "
          "profiled calls (counted and found by name in the trace), times "
          "those of phases 2 and 4 (the same shapes)",
          flush=True)
    print(f"chip_smoke wall time: {time.time() - t_start:.1f} s "
          f"({card})", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
