#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two main paths, the flagship RefineNet ×4 eval
(``configs/test/refine_net/exp1_x4.yaml``: features [64, 64, 64], 3 stages,
6 warm-up frames each side, window 5, phase code on) and its training
(``configs/train/refine_net/exp1_x4.yaml``: the same net, batch 16, LR
patches 32×32, 7 core frames + 2×6 warm-up, Adam at 1e-4), at full width
on the card, and holds every hand-written kernel of those paths against its
plain PyTorch version; then the single-image family's serving and training
(EDSR, SRFB, Bicubic ×4), the multi-frame family's (DUF, RBPN, TOFlow ×4)
and the plain video family's (DRF, FRVSR ×4), whose paths run no
hand-written kernel; then EDVR ×4 with the deformable conv's three
hand-written kernels, each held against its plain version; then the
serving daemon, the parallel runs and the training remainders; then the
offline data pipeline, the flagship trained from scratch against Bicubic,
the DSB15 external eval, and the spatial axis of the flagship, of the zoo
and of the warping and deformable nets.  Phases, one or more lines each;
any failure
exits non-zero and no result is printed:

1. device: ``nvidia-smi`` name and power limit, the torch device name;
   TF32 off for convolutions and matrix products.
2. build: every kernel of the paths from ``csrc/`` with ``nvcc`` (sm_90a),
   one ``nvcc`` a source, started together.
3. kernel vs plain: the ConvLSTM gate tail with the gate conv's bias at
   the main path's shape, in fp32 and bf16, in the layout the recurrence
   hands it (``recurrence_format``: fp32 NCHW, bf16 channels-last) and in
   the other; on rows of an unaligned count (16-byte path) and one element
   off an aligned allocation (scalar path); its gradient, d_bias included.
4. eval main path: a synthetic ACDC tree (test: 1 patient, 2 slices;
   train: 2 patients × 2 slices; valid: 1 patient × 1 slice; a 30-frame
   cycle, HR 256×256, LR 64×64) written with the port's NIfTI writer, a
   RefineNet with seeded random weights saved as ``{'net': state_dict}``,
   then ``main.test_from_config`` on ``cuda:0``; the kernel's launch count
   must be exactly 756 per clip and every metric finite.
5. whole forward: one clip through the net with the kernel and with the
   plain gate tail, and a small clip on the card against the CPU.
6. times: the kernel's, the plain version's and the PyTorch yardstick's
   (``aten::_thnn_fused_lstm_cell``) time per launch in the main path's
   layout with the bias (CUDA graphs of 100 launches over buffers larger
   than L2), beside the bound and a ``copy_`` of as many bytes.
7. training main path: ``main.train_from_config`` on ``cuda:0`` for 2
   epochs of 8 steps (120 items at batch 16), one valid clip an epoch; the
   forward kernel launches exactly 342 per step + 756 per valid clip, the
   backward kernel 126 per step; every logged value finite; the monitor's
   checkpoints written and ``model_best.pth`` reloaded through the port's
   loader.
8. training step: one batch of the training shape, forward + the
   stage-discounted L1 + backward through the kernels and through the plain
   gate tail (autograd of the plain version): the loss and every gradient.
9. forward and backward kernel vs plain at the training shape in fp32 and
   bf16 with the bias, in the main path's layout, the backward also on
   unaligned rows and on the scalar path; both kernels' times at the
   training shape as in phase 6, the backward's yardstick
   ``aten::_thnn_fused_lstm_cell_backward_impl``.
10. bf16 serving: phase 4's run with the predictor knobs of
    ``configs/test/refine_net/exp1_x4_tpu.yaml`` (``compute_dtype:
    bfloat16``, ``t_bucket: 8``, ``aot_cache``): exactly 792 bf16 gate
    launches a clip (the 30-frame cycle extended to 32, plus 2×6 warm-up),
    every metric finite, PSNR/SSIM within ~5x the measured gap of phase 4's
    fp32 run; clip latency and frames/s; the device's busy share in the
    predictor's step on a warm clip, with the launches of ATen's adds and
    cuDNN's NCHW↔NHWC transposes in its trace.
11. bf16 + remat training: phase 7's run with the knobs of
    ``configs/train/refine_net/exp1_x4_tpu.yaml`` (``remat``,
    ``compute_dtype: bfloat16``, ``int_feed``, ``aot_cache``, ``parallel:
    {num_devices: 1}``): exactly 468 bf16 forward launches a step (342 +
    the 126 core steps recomputed in the backward) + 756 a valid clip and
    126 bf16 backward launches a step; no "int_feed disabled" warning;
    every logged value finite; masters and Adam state fp32; ms a step,
    frames/s and peak memory beside phase 7's.  Then, as phase 8 in fp32,
    one bf16 + remat step through the kernels against the plain gate tail;
    one step with ``grad_accum_steps: 2`` against the same step with 1;
    the device's busy share in the trainer's step, with the same counts.
12. tiled serving: ``configs/test/refine_net/exp1_x4_dsb15_tile_tpu.yaml``'s
    knobs (``Dsb15VSRRefineNetDataset``, ``tile: 64``, ``tile_overlap: 12``,
    bf16) on a tree of LR 96×80 and 80×96 frames: the bf16 launch count of
    the window and seam-probe plan, the seam statistics, and tiled against
    untiled output on one clip in gray levels.

13. single-image serving: ``configs/test/{edsr_net,srfb_net,bicubic}/exp1_x4.yaml``
    (EDSR 32 blocks × 256 features, SRFB 4 steps × 6 groups × 32 features,
    Bicubic) through ``main.test_from_config`` on ``cuda:0`` over the
    tree's ``imgs/`` frames (60 LR 64×64 frames), EDSR and SRFB from seeded
    random weights saved as ``{'net': state_dict}``, Bicubic from none: every
    metric finite, no gate kernel launched, one frame on the card against
    the CPU within 1e-4 of its largest value; frames/s, the warm ms a frame,
    peak memory and the arithmetic bound of a frame.
14. single-image training: ``configs/train/{edsr_net,srfb_net}/exp1_x4.yaml``
    (batch 16, LR patches 32×32, Adam at 1e-4) through
    ``main.train_from_config`` on ``cuda:0`` for 2 epochs of 8 steps, one
    30-frame valid slice an epoch: every logged value finite, no gate kernel
    launched, ``model_best.pth`` written and reloaded; ms a step, LR
    frames/s, peak memory and the arithmetic bound of a step.
15. multi-frame serving: ``configs/test/{duf_net,rbp_net,toflow_net}/exp1_x4.yaml``
    (DUF ``_DenseLayer16`` with size_filter 5; RBPN base_filter 256, feat
    64, 3 stages, 5 resblocks; TOFlow; 7 frames each) and then
    ``toflow_net/exp1_x4_tpu.yaml`` (bf16, ``max_flow: 4``) through
    ``main.test_from_config`` on ``cuda:0`` over the tree's ``videos/`` (60
    windows of 7 LR 64×64 frames), from seeded random weights (running
    statistics drawn off their init values) saved as ``{'net':
    state_dict}``: every metric finite, no gate kernel launched, one window
    on the card against the CPU within 1e-4 of its largest value, bf16
    TOFlow's PSNR/SSIM within the stated bound of the fp32 run's and its
    windowed-warp exceedance summary (``ops/telemetry.py``) printed; the
    warm ms a window, frames/s, peak memory, the device's busy share and the
    arithmetic bound of a window.
16. multi-frame training: ``configs/train/{duf_net,rbp_net,toflow_net}/exp1_x4.yaml``
    and ``rbp_net/exp1_x4_tpu.yaml`` (bf16, ``grad_accum_steps: 2``) at
    their batch (12 for DUF, 16 otherwise) of 32×32 LR patches × 7 frames,
    with their ``logger:`` sections, through ``main.train_from_config`` on
    ``cuda:0`` for 2 epochs (120 windows an epoch), one 30-window valid
    slice an epoch: every logged value finite, event files written, no gate
    kernel launched, ``model_best.pth`` written and reloaded, running
    statistics included (the final checkpoint's equal the trainer's); ms a
    step, LR frames/s, peak memory and the arithmetic bound of a step.
17. plain video serving: ``configs/test/drf_net/exp1_x4.yaml`` (32 features
    × 6 groups), ``frvsr_net/exp1_x4.yaml`` (10 resblocks) and then
    ``frvsr_net/exp1_x4_tpu.yaml`` (bf16, ``max_flow: 4``) through
    ``main.test_from_config`` on ``cuda:0`` over the tree's whole test
    sequences (2 clips of 30 LR 64×64 frames), from seeded random weights
    saved as ``{'net': state_dict}``: every metric finite, no gate kernel
    launched, one fp32 clip on the card against the CPU within 1e-4 of its
    largest value, ``FRVSRStream`` fed the clip frame by frame against the
    clip forward within 1e-5, the bf16 + ``max_flow`` run's PSNR/SSIM within
    the stated bound of the fp32 run's and its exceedance summary printed;
    the warm ms a clip, frames/s, peak memory, the device's busy share and
    the arithmetic bound of a clip (convs, transposed convs and resize
    products).
18. plain video training: ``configs/train/drf_net/exp1_x4.yaml`` (batch 16
    × 7 frames, L1) and ``frvsr_net/exp1_x4.yaml`` (batch 16 × 10 frames,
    ``FlowLoss`` + ``MSELoss``) at 32×32 LR patches, with their ``logger:``
    sections, through ``main.train_from_config`` on ``cuda:0`` for 2 epochs
    (120 windows an epoch), one 30-frame valid sequence an epoch: every
    logged value finite, event files written, no gate kernel launched,
    ``model_best.pth`` written and reloaded; ms a step, LR frames/s, peak
    memory and the arithmetic bound of a step.
19. DCN kernels (``csrc/deform_conv.cu``: ``deform_im2col``,
    ``deform_col2im``, ``deform_col2im_coord``) against their plain
    versions at EDVR's serving L1 shape (x (1, 128, 64, 64), 8 deformable
    groups, K 9) and its training L1 shape (x (16, 128, 32, 32)), in fp32
    and bf16: each kernel on the same inputs at offsets of up to 3.5 px,
    of up to 12 px and EDVR-like ones (N(0, 0.5 px) clipped to ±1.5 px),
    col2im_coord also bit-equal across two calls; the autograd function's
    forward and its five gradients
    at zero offsets with a unit mask (the integer knife edge, also against
    the dense conv), at fractional offsets reaching outside the image, and
    at R = 2 with offsets beyond the window (output exactly the bias,
    gradients exactly 0); each kernel's time per launch beside its plain
    version's, its bound and the first design's recorded time (CUDA graphs over
    operand sets larger than L2; im2col and col2im_coord also without their
    transpose, on a channels-last x), each kernel also at zero and
    EDVR-like offsets, and the whole DCN (im2col + GEMM) beside a dense
    ``F.conv2d`` of the same shapes.
20. EDVR serving: ``configs/test/edvr_net/exp1_x4.yaml`` (nf 128, 8
    groups, 5 + 40 residual blocks, 5 frames) and ``exp1_x4_tpu.yaml``
    (bf16, ``dcn_max_offset: 2``) through ``main.test_from_config`` on
    ``cuda:0`` over the tree's 60 windows, from seeded random weights with
    the offset convs drawn off their zero init (fractional offsets): every
    metric finite, exactly 20 im2col launches a window (5 neighbours × L3,
    L2, L1, cascade; under bf16 the 5 L3 ones bf16) and no backward or gate
    launch, one fp32 window on the card against the CPU within 1e-4 of its
    largest value, the bf16 run's PSNR/SSIM within the stated bound of the
    fp32 run's and its four ``dcn_offset_window`` sites printed; the warm ms
    a window, frames/s, peak memory, the device's busy share, the DCN
    kernels' share of the device time (traced) and the arithmetic bound
    (the DCN GEMMs counted).
21. EDVR training: ``configs/train/edvr_net/exp1_x4.yaml`` (batch 16 × 5
    frames, 32×32 LR patches, Charbonnier, Adam at 4e-4) and
    ``exp1_x4_tpu.yaml`` (bf16, ``grad_accum_steps: 2``, ``dcn_max_offset:
    2``) with their ``logger:`` sections for 2 epochs (8 steps each) and one
    30-window valid slice an epoch: every logged value finite, the DCN
    launches of 20 im2col + 20 col2im + 20 col2im_coord a microbatch step
    and 20 im2col a valid window, no gate launch, ``model_best.pth``
    written and reloaded; the DCN kernels' launches, per-launch time and
    share of an fp32 forward and backward's device time (traced); one fp32
    step through the kernels against the same step through the plain
    versions (loss and every gradient); ms a step, LR frames/s, peak memory
    and the bound.

22. serving daemon, RefineNet: ``python -m <torch pkg>.tools.serve``'s
    ``serve`` on ``cuda:0`` with ``configs/test/refine_net/exp1_x4.yaml``'s
    net and phase 4's seeded weights (``--ckpt``) over a fresh LR
    ``videos/`` tree (2 patients × 2 slices × 30 frames of 64×64, one
    (H, W, 1, T) file a slice, plus one file stacking patient001's slices as
    (H, W, 2, T)), ``--pos-code`` holding patient001's code only, so
    patient002's is generated: exactly 756 gate launches a clip, each served
    slice within 1 gray level of the same clip through the net's forward on
    the card, a second run serving 0 volumes; then timed fp32 and
    ``--dtype bfloat16`` runs (ms a volume, frames/s).
23. serving daemon, EDVR: ``configs/test/edvr_net/exp1_x4.yaml``'s net in
    the window workload on one slice of 30 frames (30 windows of 5 in one
    forward): exactly 20 im2col launches, the output within 1 gray level of
    the same windows' direct forward on the card; timed.
24. the predictor's double-buffered loop against ``EVSR_EAGER_EVAL=1`` on
    phase 10's bf16 RefineNet config and phase 20's EDVR config, both with
    ``export_nifti``: equal Test logs, byte-equal NIfTI files; frames/s and
    the device's busy share (traced kernel time over the untraced wall of a
    whole ``predict``) of each mode, beside each other.
25. one epoch of phase 7's training (a 16-feature, one-stage net) with
    ``EVSR_PROFILE_DIR`` set: a ``torch.profiler`` trace holding device
    kernels for ``train_epoch_1`` and ``valid_epoch_1``.

26. the data axis at world size 1: phase 7's training for one epoch (8
    steps) with ``parallel: {num_devices: 1}`` (a process group of one made
    by the run: NCCL, the net wrapped in DDP) and unwrapped, in turns
    (unwrapped, wrapped, wrapped, unwrapped), cuDNN deterministic: equal
    logs and gate launches, no process group left after each run, ms a step
    of each.
27. two gloo ranks sharing ``cuda:0``, 4 steps of batch 16 (8 items a rank,
    SGD) against the same steps at world size 1 in a group of one made for
    them: loss and parameters within 1e-5 (correctness only, no rate).
28. ``skip_nonfinite: 3`` at full width: a poisoned batch leaves the
    weights and Adam's state bit-equal, the next step moves them, three in
    a row raise.
29. one epoch, a checkpoint and a resumed second epoch against two
    uninterrupted epochs, for each ``checkpoint_backend`` (pickle, orbax,
    orbax_async; cuDNN deterministic): equal logs.
30. ``tools/batch_infer.py`` over phase 4's 2 clips against the predictor's
    per-frame rows (its CSV, its GIFs and PNGs written by
    ``utils/imgio.py``): PSNR within 1e-4 dB, SSIM within 1e-5; 756 gate
    launches a clip; frames/s.

31. the offline pipeline on the card's machine (numpy, no OpenCV or
    imageio): ``tools/gen_synthetic_data`` at the convergence size (4 + 2
    patients, 2 slices, 16 frames, HR 144, ×4) through ``acdc_preprocess``,
    ``cardiac_cropping`` and ``gen_positional_encoding``, timed: the tree's
    file counts, its 3/1/2 split, 16 frames a cropped GIF, both pickles;
    then ``dsb15_preprocess`` on a DSB15 tree of the phantom (one test
    patient, two sax series of 30 frames and a malformed one of 29 between
    them, ×2 ×3 ×4): the malformed series skipped and its number kept.
    ``dsb15_dicom2nifty`` runs only where ``dcm2niix`` is on ``PATH``;
    otherwise the phase logs that it was skipped and why.
32. the flagship's convergence: ``tools/convergence.py refine_net/exp1_x4``
    on ``cuda:0`` for ``CONV_EPOCHS`` epochs of the shipped train YAML on
    phase 31's phantom, then the shipped test YAMLs of RefineNet and
    Bicubic with their export on: both gate kernels launched, every logged
    loss finite, trained PSNR at least 1.0 dB over Bicubic's on the
    held-out split, each export's CSV rows, GIFs (``GIF89a``, one image
    block a frame) and PNGs (``\x89PNG``); the delta, the wall, ms a step
    and the epochs printed.
33. DSB15 external eval: ``configs/test/refine_net/exp1_x{2,3,4}_dsb15.yaml``
    at full width with seeded weights on phase 31's DSB15 tree: finite
    logs, exactly 756 gate launches a clip, a CSV row and a PNG a frame, a
    GIF a series.

34. the spatial axis: two gloo ranks sharing ``cuda:0`` as one spatial
    group (``parallel: {num_devices: 2, spatial_parallel: 2}``), each
    holding half the rows of every frame, a halo exchange at every conv
    (``parallel/halo.py``): (a) phase 4's clips through
    ``main.test_from_config``: the Test log within 1e-5 relative of phase
    4's, the gathered fused frames within 1e-4 of phase 5's, 756 gate
    launches and 792 exchanges a clip; (b) phase 27's 4 SGD steps against
    its world 1 (1e-5), 342 + 126 launches and 378 + 159 exchanges a step,
    then one step with remat against the plain step (1e-6); (c) ``pad_h``
    on a tree of LR height 63: no downgrade warning, the scores within the
    JAX package's ``pad_h`` bounds of the meshless run; (d)
    ``tools/batch_infer.py --spatial-parallel 2 --pad-h`` within phase
    30's bounds of (c)'s rows; (e) the gate kernels against their plain
    versions at a rank's shapes (forward (1, 256, 32, 64), forward and
    backward (16, 256, 16, 32), fp32 and bf16).  ms a clip and a step are
    printed as correctness only: two ranks share one card.
35. the spatial axis of the zoo, on the same two gloo ranks: the shipped
    test YAMLs of EDSR, SRFB, DRF-SISR (SRFB's widths), Bicubic, DUF, RBPN
    and DRF ×4 at full width with the seeded weights of phases 13, 15 and
    17, on one 8-frame slice of their tree, through
    ``main.test_from_config``, each against its meshless run of the same
    items (``TOL_ZOO_LOG`` relative on the Test log, ``TOL_ZOO_SR`` on the
    first item's gathered SR frame) with the halo exchanges predicted an
    item (``zoo_exchanges``: EDSR 69, SRFB 58, DRF-SISR 61, Bicubic 1, DUF
    9, RBPN 285, DRF 1 + 15 a frame); one step of
    ``train/{srfb_net,duf_net}/exp1_x4.yaml`` on a tree of one batch against
    the same step at world 1 from the same weights, with the YAML's Adam
    (losses and running statistics 1e-5, the step's gradient from Adam's
    first moment in norm, ``TOL_ZOO_GRAD``) and with SGD (losses,
    parameters and running statistics 1e-5); DUF's gradient through each
    BatchNorm path against a float64 step (``duf_batch_norm_precision``);
    no gate or DCN launch.  ms an item and a step are printed as
    correctness only.
36. the spatial axis of TOFlow, FRVSR and EDVR, on the same two gloo ranks:
    first the three DCN kernels on a band with its window rows and a
    negative row origin, and on the whole frame read from a band's first
    row, each against its plain version at that geometry (fp32 and bf16)
    and the band's im2col against the whole frame's; then each net's test
    YAML and its ``_tpu`` knobs (bf16, ``max_flow: 4`` / ``dcn_max_offset:
    2``) at full width with the seeded weights of phases 15, 17 and 20 on
    phase 35's slice, each against its meshless run (``TOL_ZOO_LOG`` and
    ``TOL_ZOO_SR``; the bf16 SSIMs ``TOL_VIDEO_BF16_SSIM`` absolute and
    FRVSR ``_tpu``'s SR ``TOL_VIDEO_FRVSR_BF16_SR``, each between its sound
    and its faulted reading; the windowed runs' telemetry), with the halo exchanges, whole-frame gathers, DCN launches
    and DCN operands ``video_counts`` predicts; one SGD step of each
    family's train YAML (``edvr_net/exp1_x4_tpu.yaml`` too) against world 1
    (losses, parameters, running statistics).  ms an item and a step are
    printed as correctness only.

Phase 4 also checks the data path's native NIfTI reader
(``utils/native_io.py``, built by g++ at first use): it is enabled, it
equals the Python reader on the tree's test files, and the eval's dataset
reads through it.

Phases 6 and 9 also time the kernels on bf16 operands, beside a bound at
2-byte elements.  The second-to-last line is the ``{"kernels": [...]}``
record; the last is ``{"ok": true, "device": {...}}``.  Needs torch, numpy
and PyYAML (the daemon reads its net from a config file; phases 22–23 write
theirs as JSON), a C++ compiler with zlib for the native reader; no imageio
or OpenCV (the exports are ``utils/imgio.py``'s), nothing of JAX.
"""
from __future__ import annotations

import json
import logging
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch"

# exp1_x4.yaml's serving shapes (the JAX package's bench protocol)
CYCLE, HR, SCALE, SLICES = 30, 256, 4, 2
NET_KWARGS = {  # configs/test/refine_net/exp1_x4.yaml:26-40
    "in_channels": 1, "out_channels": 1, "num_features": [64, 64, 64], "upscale_factor": 4,
    "num_stages": 3, "update_memory": True, "num_updated_frames": 6,
    "refine_window_size": 5, "positional_encoding": True,
}
U = NET_KWARGS["num_updated_frames"]
T_CLIP = CYCLE + 2 * U  # 42 frames a clip
LAYER_STEPS = len(NET_KWARGS["num_features"]) * 2 * NET_KWARGS["num_stages"]  # per frame
LAUNCHES_PER_CLIP = LAYER_STEPS * T_CLIP  # 756

# configs/train/refine_net/exp1_x4.yaml: batch 16, LR patches 32×32, 7 core frames
TRAIN_BATCH, PATCH, CORE = 16, 32, 7
T_TRAIN = CORE + 2 * U  # 19 frames an item
FWD_PER_STEP = LAYER_STEPS * T_TRAIN  # 342: every frame runs the gate tail
BWD_PER_STEP = LAYER_STEPS * CORE  # 126: the warm-up frames carry no gradient
TREE_SPLITS = {"test": (1, SLICES), "train": (2, 2), "valid": (1, 1)}  # (patients, slices)
EPOCHS = 2
STEPS_PER_EPOCH = math.ceil(2 * 2 * CYCLE / TRAIN_BATCH)  # 120 items (windows or frames) → 8 steps
VALID_CLIPS = 1

# the _tpu configurations' knobs (configs/{test,train}/refine_net/exp1_x4_tpu.yaml)
T_BUCKET = 8
BUCKET_CLIP = -(-CYCLE // T_BUCKET) * T_BUCKET + 2 * U  # 32 core + 12 warm-up frames
BUCKET_LAUNCHES_PER_CLIP = LAYER_STEPS * BUCKET_CLIP  # 792
REMAT_FWD_PER_STEP = FWD_PER_STEP + BWD_PER_STEP  # 468: the core steps rerun in the backward
# configs/test/refine_net/exp1_x4_dsb15_tile_tpu.yaml on frames of two sizes
# (DSB15's frames differ by patient), each larger than the tile
TILE, TILE_OVERLAP = 64, 12
TILE_HR = [(384, 320), (320, 384)]  # LR 96×80 and 80×96; slice s takes TILE_HR[(s-1) % 2]
TILE_SLICES = 3  # the third repeats the first size: no seam probes for it
# bf16 + t_bucket serving against phase 4's fp32 run on the same clips: ~5x the
# gap measured on an H100 (PSNR -2.0e-4 dB, CardiacPSNR -1.9e-4 dB, SSIM
# +1.9e-5, CardiacSSIM +1.4e-5; the same in every run, the data and weights
# being seeded).  The SSIM of seeded random weights is ~0.02, so the JAX
# package's own bound (|dPSNR| < 0.5, |dSSIM| < 0.05) would pass a wrong path.
BF16_DPSNR, BF16_DSSIM = 1e-3, 1e-4
# one bf16 step as 2 microbatches of 8 against 1 of 16: the loss relative to
# itself, each gradient relative to its largest element (bf16 rounds each
# conv output to 8 bits, and the microbatches round differently)
TOL_ACCUM_LOSS, TOL_ACCUM_GRAD = 1e-2, 5e-2
# one bf16 + remat step through the kernels against the same step through the
# plain gate tail in bf16 (which rounds after every op; the kernel computes in
# fp32 and rounds once): the loss relative to itself, each gradient relative
# to its largest element; ~3x the gaps measured on an H100 (loss 5.97e-5,
# gradients 1.79e-2 at most, 6.9e-3 the median)
TOL_BF16_STEP_LOSS, TOL_BF16_STEP_GRAD = 2e-4, 5e-2

# the single-image family's x4 configs (phases 13-14)
SISR_NETS = {
    "EDSRNet": {"in_channels": 1, "out_channels": 1, "num_resblocks": 32,  # configs/*/edsr_net/exp1_x4.yaml
                "num_features": 256, "upscale_factor": SCALE, "res_scale": 0.1},
    "SRFBNet": {"in_channels": 1, "out_channels": 1, "num_steps": 4,  # configs/*/srfb_net/exp1_x4.yaml
                "num_features": 32, "num_groups": 6, "upscale_factor": SCALE},
    "Bicubic": {"upscale_factor": SCALE},  # configs/test/bicubic/exp1_x4.yaml
}
SISR_WORKLOAD = {"EDSRNet": "SISR", "SRFBNet": "SISRSRFB", "Bicubic": "SISR"}
# one frame on the card against the CPU, relative to its largest value
# (fp32 without TF32 on both sides; the sums run in another order)
TOL_SISR_CARD_CPU = 1e-4

# the multi-frame family's x4 configs (phases 15-16), 7 frames a window
MISR_T = 7
MISR_NETS = {
    "DUFNet": {"in_channels": 1, "out_channels": 1, "num_frames": MISR_T,  # configs/*/duf_net/exp1_x4.yaml
               "size_filter": 5, "upscale_factor": SCALE, "backbone": "_DenseLayer16"},
    "RBPNet": {"in_channels": 1, "out_channels": 1, "base_filter": 256,  # configs/*/rbp_net/exp1_x4.yaml
               "feat": 64, "num_stages": 3, "num_resblocks": 5, "num_frames": MISR_T,
               "upscale_factor": SCALE},
    "TOFlowNet": {"in_channels": 1, "out_channels": 1, "num_frames": MISR_T,  # configs/*/toflow_net/exp1_x4.yaml
                  "upscale_factor": SCALE},
}
# configs/test/toflow_net/exp1_x4_tpu.yaml
TOFLOW_TPU_NET = {**MISR_NETS["TOFlowNet"], "max_flow": 4}
# configs/train/*/exp1_x4.yaml (and rbp_net/exp1_x4_tpu.yaml): batch, loss,
# Adam's lr and weight decay, the trainer's knobs
MISR_TRAIN = {
    "DUFNet": (12, {"name": "HuberLoss", "kwargs": {"delta": 0.01}, "weight": 1.0}, 1e-3, 0, {}),
    "RBPNet": (16, {"name": "L1Loss", "weight": 1.0}, 1e-4, 0, {}),
    "TOFlowNet": (16, {"name": "L1Loss", "weight": 1.0}, 1e-4, 1e-4, {}),
    "RBPNet_tpu": (16, {"name": "L1Loss", "weight": 1.0}, 1e-4, 0,
                   {"compute_dtype": "bfloat16", "grad_accum_steps": 2}),
}
# bf16 + max_flow TOFlow serving against the fp32 exact run on the same
# windows: bf16 TOFlow computes in fp32 on bf16-rounded weights and frames
# (the fp32 resize promotes), so its gap is that rounding's (and the window's,
# exact while |flow| <= 4).  Measured on an H100: PSNR -7.5e-4 dB,
# CardiacPSNR -6.8e-4 dB, SSIM -1.5e-6, CardiacSSIM -1.2e-5 (seeded data and
# weights); the bounds are ~5x and ~8x the larger of each pair
TOL_TOFLOW_BF16_DPSNR, TOL_TOFLOW_BF16_DSSIM = 4e-3, 1e-4

# the plain video family's x4 configs (phases 17-18)
VSR_NETS = {
    "DRFNet": {"in_channels": 1, "out_channels": 1, "num_features": 32,  # configs/*/drf_net/exp1_x4.yaml
               "num_groups": 6, "upscale_factor": SCALE},
    "FRVSRNet": {"in_channels": 1, "out_channels": 1, "num_resblocks": 10,  # configs/*/frvsr_net/exp1_x4.yaml
                 "upscale_factor": SCALE},
}
VSR_WORKLOAD = {"DRFNet": "VSR", "FRVSRNet": "FRVSR"}
VSR_TEST_LOSS = {"DRFNet": "L1Loss", "FRVSRNet": "MSELoss"}  # configs/test/*/exp1_x4.yaml
# configs/test/frvsr_net/exp1_x4.yaml and exp1_x4_tpu.yaml (bf16, max_flow: 4)
VSR_SERVE = [("DRFNet", "DRFNet", VSR_NETS["DRFNet"], {}),
             ("FRVSRNet", "FRVSRNet", {**VSR_NETS["FRVSRNet"], "is_prediction": True}, {}),
             ("FRVSRNet_tpu", "FRVSRNet",
              {**VSR_NETS["FRVSRNet"], "is_prediction": True, "max_flow": 4},
              {"compute_dtype": "bfloat16"})]
# configs/train/{drf_net,frvsr_net}/exp1_x4.yaml: batch, frames a window, losses
VSR_TRAIN = {
    "DRFNet": (16, 7, [{"name": "L1Loss", "weight": 1.0}]),
    "FRVSRNet": (16, 10, [{"name": "FlowLoss", "weight": 1.0}, {"name": "MSELoss", "weight": 1.0}]),
}
# FRVSRStream fed a clip frame by frame against the clip forward, relative to
# the largest value: the same per-frame step on the same inputs, bit-equal on
# the CPU; on an H100 cuDNN's fp32 convs differ between the two by 3.3e-6
# (bf16: 0)
TOL_STREAM = 1e-5
# bf16 + max_flow FRVSR serving against the fp32 exact run on the same clips.
# The seeded random FNet makes HR flows of up to 15 px, so 99% of the
# samples leave the 4 px window and its telemetry warns; measured on an H100:
# PSNR +1.3e-3 dB, CardiacPSNR +4.7e-3 dB, SSIM +8.2e-5, CardiacSSIM +1.6e-4
# (seeded data and weights); the bounds are ~5x and ~6x the larger of each pair
TOL_FRVSR_BF16_DPSNR, TOL_FRVSR_BF16_DSSIM = 2.5e-2, 1e-3

TOL_FP32 = 2e-6  # expf/tanhf against ATen's: an ulp or two
TOL_BF16 = 1e-2  # one rounding to bf16 of values below 4, against the fp32 plain version
TOL_BF16_REL = 1e-2  # the backward's values reach ~5: error / max(1, |value|)
TOL_GRAD = 2e-6  # the backward kernel against autograd of the plain version
# d_bias: the same reduction over N, H, W of the kernel's and of autograd's
# d_gates (4096 rows, each within TOL_GRAD), relative to its largest element
TOL_DBIAS_REL = 1e-5
TOL_FORWARD = 1e-4  # 42 recurrent steps × 3 stages in fp32
# one training step, kernels vs plain tail: the loss and each parameter's
# gradient, relative to that parameter's largest gradient (fp32 recurrences
# of 19 steps, 3 stages and their backward, each side rounding differently)
TOL_TRAIN_STEP = 1e-4

# Memory rate, fp32 (non-tensor-core) peak and dense bf16 tensor-core peak
# by part, from NVIDIA's H100 data sheets (PCIe, NVL, SXM).
CARDS = [("PCIe", 2.0e12, 51e12, 756e12), ("NVL", 3.9e12, 60e12, 835e12),
         ("", 3.35e12, 67e12, 989e12)]
GATE_OPS_PER_ELEMENT = 19  # 3 sigmoids (3 each) + 2 tanh (3 each) + 4 for c' and h'
# 3 sigmoids + 2 tanh (15), c' (3), dct (5), dgi, dgf, dgo, dgg (4 each), dc (1)
GATE_BWD_OPS_PER_ELEMENT = 40
# kernels counted by name in the traced warm clip and step (phases 10, 11):
# ATen's broadcast add (once the gate convs' bias add) and cuDNN's layout
# transposes around a conv whose operands are not in its NHWC layout
TRACE_COUNTS = {"aten_add": "CUDAFunctor_add", "nchw_to_nhwc": "nchwToNhwc",
                "nhwc_to_nchw": "nhwcToNchw"}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_graph_ms(fns) -> float:
    """Device time per call of ``fns`` (one call each, in order) replayed as
    one CUDA graph, so host launch cost is not in the time."""
    import torch

    for fn in fns[:4]:  # warm-up outside the capture
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def device_busy(fn, reps: int = 3) -> tuple[float, float, int, dict, dict]:
    """(median host wall ms of ``fn()`` to the device's drain over ``reps``
    warm calls without a profiler; device ms of the kernels of one more call
    from a ``torch.profiler`` trace; their number; the launches of the
    kernels named in ``TRACE_COUNTS`` in that trace; device ms and launches
    by kernel name).  The kernels run on one stream, so their sum is the
    busy time; host tracing slows the host, not the kernels, so the wall is
    taken untraced."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler traced no device activity")
    counts = {key: sum(part in e.name for e in kernels) for key, part in TRACE_COUNTS.items()}
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return (sorted(walls)[reps // 2], sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            len(kernels), counts, by_name)


def gate_operands(shape_c, fmt, dtype, dev, gen):
    """Gate-conv output (no bias), c and the conv's bias for c of
    ``shape_c`` (N, F, H, W), in memory layout ``fmt``, as the recurrence
    hands them to the gate tail."""
    import torch

    N, F_, H, W = shape_c
    g = (torch.randn(N, 4 * F_, H, W, device=dev, generator=gen) * 2).to(dtype)
    c = (torch.randn(shape_c, device=dev, generator=gen) * 0.5).to(dtype)
    b = (torch.randn(4 * F_, device=dev, generator=gen) * 0.5).to(dtype)
    return g.contiguous(memory_format=fmt), c.contiguous(memory_format=fmt), b


def fmt_name(fmt) -> str:
    import torch

    return "channels-last" if fmt == torch.channels_last else "NCHW"


def library_time(calls, what: str):
    """(ms, None) for the PyTorch yardstick ``calls``, or (None, the error)
    where it refuses the operands."""
    try:
        return time_graph_ms(calls), None
    except Exception as exc:  # noqa: BLE001 - the yardstick is optional per dtype
        reason = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
        log("times", f"{what} refused: {reason}")
        return None, reason


def rel_diffs(grads_a: dict, grads_b: dict) -> dict:
    """Per parameter, the largest difference of two gradients relative to
    the largest element of the second."""
    return {n: ((grads_a[n] - g).abs().max() / g.abs().max()).item() for n, g in grads_b.items()}


def reset_launches(lstm_gates) -> None:
    lstm_gates.LAUNCHES = lstm_gates.BWD_LAUNCHES = 0
    lstm_gates.BF16_LAUNCHES = lstm_gates.BF16_BWD_LAUNCHES = 0


def launches(lstm_gates) -> tuple[int, int, int, int]:
    """(forward, backward, bf16 forward, bf16 backward) launches since the reset."""
    return (lstm_gates.LAUNCHES, lstm_gates.BWD_LAUNCHES, lstm_gates.BF16_LAUNCHES,
            lstm_gates.BF16_BWD_LAUNCHES)


class _Records(logging.Handler):
    """Keeps the log records of a run, to read its warnings."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def bound_ms(nbytes: int, ops: int, mem_rate: float, fp32_peak: float) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or operations
    over the fp32 rate, whichever is larger, and which one it is."""
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, ops / fp32_peak * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _cycled(sets, n: int = 100) -> list:
    return (sets * (n // len(sets) + 1))[:n]


def _n_sets(set_bytes: int) -> int:
    """Operand sets to cycle through so that every launch reads cold
    inputs: more than twice the 50 MB L2 in all."""
    return max(4, math.ceil(120e6 / set_bytes))


def time_gate_forward(lstm_gates, shape_c, fmt, dtype, dev, gen, rates) -> dict:
    """The forward kernel, its plain version and the PyTorch yardstick per
    launch on (gates, c, bias) of c's ``shape_c`` in layout ``fmt``, over
    operand sets larger than L2, beside the bound.  The yardstick,
    ``aten::_thnn_fused_lstm_cell`` (gate order i, f, g, o), computes the
    same tail with the bias add fused in on (M, 4F) rows; it also reads a
    hidden-gates operand and a hidden bias (zeros here) and writes a 4F
    workspace: 13F elements a row against the kernel's 7F."""
    import torch

    N, F_, H, W = shape_c
    M, el = N * H * W, torch.empty((), dtype=dtype).element_size()
    nbytes = (M * 7 * F_ + 4 * F_) * el  # read gates, c, bias; write h', c'
    sets = [gate_operands(shape_c, fmt, dtype, dev, gen) for _ in range(_n_sets(nbytes))]
    cyc = _cycled(sets)
    out = {"layout": fmt_name(fmt), "bytes": nbytes, "sets": len(sets)}
    out["ms"] = time_graph_ms([lambda a=a: lstm_gates.fused_lstm_gates(a[0], a[1], dim=1, bias=a[2])
                               for a in cyc])
    out["plain_ms"] = time_graph_ms(
        [lambda a=a: lstm_gates.lstm_gates_reference(a[0], a[1], dim=1, bias=a[2]) for a in cyc])
    del sets, cyc
    lib_sets = []
    for _ in range(_n_sets(M * 13 * F_ * el)):
        ig = torch.randn(M, 4 * F_, device=dev, generator=gen).to(dtype)
        cx = torch.randn(M, F_, device=dev, generator=gen).to(dtype)
        ib = torch.randn(4 * F_, device=dev, generator=gen).to(dtype)
        lib_sets.append((ig, torch.zeros_like(ig), cx, ib, torch.zeros_like(ib)))
    out["library_ms"], out["library_error"] = library_time(
        [lambda a=a: torch.ops.aten._thnn_fused_lstm_cell(*a) for a in _cycled(lib_sets)],
        f"aten::_thnn_fused_lstm_cell on {dtype} ({M}, {4 * F_})")
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, GATE_OPS_PER_ELEMENT * M * F_, *rates)
    # what one launch that only moves as many bytes costs at this size: a
    # copy_ of nbytes / 2 into another buffer, timed the same way
    n = nbytes // (2 * el)
    copies = [(torch.empty(n, device=dev, dtype=dtype), torch.randn(n, device=dev, generator=gen)
               .to(dtype)) for _ in range(_n_sets(nbytes))]
    out["copy_ms"] = time_graph_ms([lambda a=a: a[0].copy_(a[1]) for a in _cycled(copies)])
    return out


def time_gate_backward(lstm_gates, shape_c, fmt, dtype, dev, gen, rates) -> dict:
    """As :func:`time_gate_forward` for the backward kernel, beside
    ``aten::_thnn_fused_lstm_cell_backward_impl`` (reads dh', dc', c, c'
    and the forward's 4F workspace; writes d_gates, d_c and d_bias)."""
    import torch

    N, F_, H, W = shape_c
    M, el = N * H * W, torch.empty((), dtype=dtype).element_size()
    nbytes = (M * 12 * F_ + 4 * F_) * el  # read gates, c, dh, dc', bias; write dgates, dc
    sets = []
    for _ in range(_n_sets(nbytes)):
        g, c, b = gate_operands(shape_c, fmt, dtype, dev, gen)
        dh, dc = (torch.randn(shape_c, device=dev, generator=gen).to(dtype).contiguous(
            memory_format=fmt) for _ in range(2))
        sets.append((g, c, dh, dc, b))
    cyc = _cycled(sets)
    out = {"layout": fmt_name(fmt), "bytes": nbytes, "sets": len(sets)}
    out["ms"] = time_graph_ms([lambda a=a: lstm_gates._launch_bwd(*a[:4], 1, a[4]) for a in cyc])
    out["plain_ms"] = time_graph_ms(
        [lambda a=a: lstm_gates.lstm_gates_backward_reference(*a[:4], dim=1, bias=a[4])
         for a in cyc])
    del sets, cyc
    lib_sets, lib_error = [], None
    try:
        for _ in range(_n_sets(M * 12 * F_ * el)):
            ig = torch.randn(M, 4 * F_, device=dev, generator=gen).to(dtype)
            cx = torch.randn(M, F_, device=dev, generator=gen).to(dtype)
            ib = torch.randn(4 * F_, device=dev, generator=gen).to(dtype)
            _, cy, ws = torch.ops.aten._thnn_fused_lstm_cell(
                ig, torch.zeros_like(ig), cx, ib, torch.zeros_like(ib))
            dhy, dcy = (torch.randn(M, F_, device=dev, generator=gen).to(dtype) for _ in range(2))
            lib_sets.append((dhy, dcy, cx, cy, ws))
    except Exception as exc:  # noqa: BLE001 - the forward refused the dtype
        lib_error = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
        log("times", f"aten::_thnn_fused_lstm_cell on {dtype} refused: {lib_error}")
    if lib_error is None:
        out["library_ms"], out["library_error"] = library_time(
            [lambda a=a: torch.ops.aten._thnn_fused_lstm_cell_backward_impl(*a, True)
             for a in _cycled(lib_sets)],
            f"aten::_thnn_fused_lstm_cell_backward_impl on {dtype} ({M}, {4 * F_})")
    else:
        out["library_ms"], out["library_error"] = None, lib_error
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, GATE_BWD_OPS_PER_ELEMENT * M * F_, *rates)
    return out


def times_line(name: str, shape, dtype, t: dict) -> str:
    lib = (f"{t['library_ms'] * 1e3:.2f} us" if t["library_ms"] is not None
           else f"refused ({t['library_error']})")
    copy = (f"; a copy_ of as many bytes {t['copy_ms'] * 1e3:.2f} us" if "copy_ms" in t else "")
    return (f"{name} {dtype} {t['layout']} c {tuple(shape)} with bias: kernel {t['ms'] * 1e3:.2f} us, "
            f"plain {t['plain_ms'] * 1e3:.2f} us, library {lib}, bound {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_by']}: {t['bytes']} bytes), {t['bound_ms'] / t['ms']:.0%} of the bound; "
            f"{t['sets']} operand sets{copy}")


def eval_config(tree: dict, ckpt: Path, saved_dir: Path) -> dict:
    """configs/test/refine_net/exp1_x4.yaml with paths into the synthetic
    tree, on cuda:0, without the GIF/PNG export."""
    coords = str(tree["coordinates"])
    return {
        "main": {"saved_dir": str(saved_dir), "loaded_path": str(ckpt)},
        "dataset": {
            "name": "AcdcVSRRefineNetDataset",
            "kwargs": {
                "data_dir": str(tree["videos"]), "downscale_factor": SCALE,
                "transforms": [
                    {"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                    {"name": "ToTensor"},
                ],
                "num_frames": 7, "num_updated_frames": U, "pos_code_path": str(tree["pos_code"]),
            },
        },
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"batch_size": 1, "shuffle": False, "num_workers": 8}},
        "net": {"name": "RefineNet", "kwargs": NET_KWARGS},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [
            {"name": "PSNR"}, {"name": "SSIM"},
            {"name": "CardiacPSNR", "kwargs": {"coordinates_path": coords}},
            {"name": "CardiacSSIM", "kwargs": {"coordinates_path": coords}},
        ],
        "predictor": {"name": "AcdcVSRRefineNetPredictor",
                      "kwargs": {"device": "cuda:0", "saved_dir": str(saved_dir), "exported": False}},
    }


def train_config(tree: dict, saved_dir: Path) -> dict:
    """configs/train/refine_net/exp1_x4.yaml with paths into the synthetic
    tree, on cuda:0, for EPOCHS epochs with a checkpoint every epoch, and
    without the ``logger:`` section (tensorboardX is not installed on the
    machine with the card)."""
    return {
        "main": {"random_seed": "vsr", "saved_dir": str(saved_dir), "loaded_path": None},
        "dataset": {
            "name": "AcdcVSRRefineNetDataset",
            "kwargs": {
                "data_dir": str(tree["videos"]), "downscale_factor": SCALE,
                "transforms": [
                    {"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                    {"name": "ToTensor"},
                ],
                "augments": [
                    {"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
                    {"name": "RandomCropPatch", "kwargs": {"size": [PATCH, PATCH], "ratio": SCALE}},
                ],
                "num_frames": CORE, "num_updated_frames": U, "pos_code_path": str(tree["pos_code"]),
            },
        },
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"train_batch_size": TRAIN_BATCH, "valid_batch_size": 1,
                                  "shuffle": True, "num_workers": 8}},
        "net": {"name": "RefineNet", "kwargs": NET_KWARGS},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [{"name": "PSNR"}, {"name": "SSIM"}],
        "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-4, "weight_decay": 0}},
        "monitor": {"name": "Monitor",
                    "kwargs": {"mode": "min", "target": "Loss", "saved_freq": 1, "early_stop": 0}},
        "trainer": {"name": "AcdcVSRRefineNetTrainer",
                    "kwargs": {"device": "cuda:0", "num_epochs": EPOCHS}},
    }


def sisr_eval_config(tree: dict, name: str, ckpt: Path, saved_dir: Path) -> dict:
    """configs/test/{edsr_net,srfb_net,bicubic}/exp1_x4.yaml with paths into
    the synthetic tree's frames, on cuda:0, without the GIF/PNG export."""
    coords = str(tree["coordinates"])
    return {
        "main": {"saved_dir": str(saved_dir), "loaded_path": str(ckpt)},
        "dataset": {"name": "AcdcSISRDataset",
                    "kwargs": {"data_dir": str(tree["imgs"]), "downscale_factor": SCALE,
                               "transforms": [{"name": "Normalize",
                                               "kwargs": {"means": [54.089], "stds": [48.084]}},
                                              {"name": "ToTensor"}]}},
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"batch_size": 1, "shuffle": False, "num_workers": 8}},
        "net": {"name": name, "kwargs": SISR_NETS[name]},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [
            {"name": "PSNR"}, {"name": "SSIM"},
            {"name": "CardiacPSNR", "kwargs": {"coordinates_path": coords}},
            {"name": "CardiacSSIM", "kwargs": {"coordinates_path": coords}},
        ],
        "predictor": {"name": f"Acdc{SISR_WORKLOAD[name]}Predictor",
                      "kwargs": {"device": "cuda:0", "saved_dir": str(saved_dir), "exported": False}},
    }


def sisr_train_config(tree: dict, name: str, saved_dir: Path) -> dict:
    """configs/train/{edsr_net,srfb_net}/exp1_x4.yaml with paths into the
    synthetic tree's frames, on cuda:0, for EPOCHS epochs with a checkpoint
    every epoch, and without the ``logger:`` section."""
    return {
        "main": {"random_seed": "vsr", "saved_dir": str(saved_dir), "loaded_path": None},
        "dataset": {
            "name": "AcdcSISRDataset",
            "kwargs": {
                "data_dir": str(tree["imgs"]), "downscale_factor": SCALE,
                "transforms": [
                    {"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                    {"name": "ToTensor"},
                ],
                "augments": [
                    {"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
                    {"name": "RandomCropPatch", "kwargs": {"size": [PATCH, PATCH], "ratio": SCALE}},
                ],
            },
        },
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"train_batch_size": TRAIN_BATCH, "valid_batch_size": 1,
                                  "shuffle": True, "num_workers": 8}},
        "net": {"name": name, "kwargs": SISR_NETS[name]},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [{"name": "PSNR"}, {"name": "SSIM"}],
        "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-4, "weight_decay": 0}},
        "monitor": {"name": "Monitor",
                    "kwargs": {"mode": "min", "target": "Loss", "saved_freq": 1, "early_stop": 0}},
        "trainer": {"name": f"Acdc{SISR_WORKLOAD[name]}Trainer",
                    "kwargs": {"device": "cuda:0", "num_epochs": EPOCHS}},
    }


def forward_flops(net, x) -> int:
    """Operations (a multiply-add is 2) of one forward of ``net`` on ``x``
    ((B, h, w, C) frames or (B, T, h, w, C) windows and clips): every conv,
    3D conv and transposed conv, counted from its shapes by a forward hook;
    every dense resize product of ``ops/resize.py`` (Bicubic, SRFB's
    bilinear skip, TOFlow's bicubic upscale of every frame and its flow
    pyramid, FNet's decoder and FRVSR's ×4 flow), counted from its shapes
    as it runs: rows, then columns; DUF's filter product (sf² taps × r²
    subpixels a pixel); and every deformable conv's (Cout, Cin·K) @ col
    GEMM (EDVR's 20 a window, which no conv hook sees)."""
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        deform_conv,
        resize,
    )

    total = 0

    def hook(mod, args, out):
        nonlocal total
        k = math.prod(mod.weight.shape[1:])  # in·kh·kw, in·kd·kh·kw, or out·kh·kw
        # a conv: each output element sums in·k products; a transposed conv:
        # each input element meets out·kh·kw weights
        total += 2 * k * (args[0].numel() if isinstance(mod, torch.nn.ConvTranspose2d)
                          else out.numel())

    plain_resize = resize._resize

    def counted_resize(y, out_hw, align_corners, kind, axis=None):
        nonlocal total
        h, w = y.shape[-3], y.shape[-2]
        planes = y.numel() // (h * w)  # every leading axis and the channels
        total += 2 * planes * (out_hw[0] * h * w + out_hw[0] * out_hw[1] * w)
        return plain_resize(y, out_hw, align_corners, kind, axis)

    plain_contract = deform_conv._contract

    def counted_contract(col, weight, bias, g):
        nonlocal total
        total += 2 * weight.numel() * g.B * g.Ho * g.Wo
        return plain_contract(col, weight, bias, g)

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Conv3d))]
    resize._resize, deform_conv._contract = counted_resize, counted_contract
    try:
        with torch.inference_mode():
            net(x)
    finally:
        resize._resize, deform_conv._contract = plain_resize, plain_contract
        for h in handles:
            h.remove()
    name = type(net).__name__
    if name == "DUFNet":
        B, _, h, w, C = x.shape
        total += 2 * B * C * net.size_filter ** 2 * net.upscale_factor ** 2 * h * w
    return total


def sisr_serving(port_main, Cfg, lstm_gates, tree: dict, tmp: Path, dev, rates, card_line) -> dict:
    """Phase 13: each single-image net serves the tree's test frames."""
    import copy

    import numpy as np
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        Bicubic,
        EDSRNet,
        SRFBNet,
    )

    classes = {"EDSRNet": EDSRNet, "SRFBNet": SRFBNet, "Bicubic": Bicubic}
    results = {}
    for name, kwargs in SISR_NETS.items():
        net = classes[name](**kwargs, generator=torch.Generator().manual_seed(0))
        ckpt = tmp / f"{name}.pth"
        if name == "Bicubic":
            ckpt = tmp / "no_checkpoint.pth"  # Bicubic reads none
        else:
            torch.save({"net": net.state_dict()}, ckpt)
        cfg = Cfg(sisr_eval_config(tree, name, ckpt, tmp / f"test_{name}"))
        held = torch.cuda.memory_allocated(dev)  # by the earlier phases
        reset_launches(lstm_gates)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pred = port_main.test_from_config(cfg)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        if launches(lstm_gates) != (0, 0, 0, 0):
            raise AssertionError(f"{name} serving launched the gate kernels {launches(lstm_gates)}")
        frames = pred.throughput["frames"]
        if frames != CYCLE * SLICES or not all(math.isfinite(v) for v in pred.log.values()):
            raise AssertionError(f"{name} serving scored {frames} frames: {pred.log}")
        warm_ms = float(np.median(pred.item_seconds[1:])) * 1e3
        n_params = sum(p.numel() for p in pred.net.parameters())
        log("sisr eval", f"{name} {kwargs}: {n_params:,} params; Test log {pred.log}")

        # one frame on the card against the same weights on the CPU
        item = pred.test_dataloader.dataset[0]
        lr = torch.from_numpy(item["lr_img"][None])
        with torch.inference_mode():
            on_card = pred._forward(lr.to(dev)).cpu()
            cpu_net = copy.deepcopy(pred.net).cpu()
            on_cpu = pred._select_output(cpu_net(lr))
        gap = ((on_card - on_cpu).abs().max() / on_cpu.abs().max()).item()
        if tuple(on_card.shape) != (1, HR, HR, 1) or not gap <= TOL_SISR_CARD_CPU:
            raise AssertionError(f"{name}: card vs CPU {gap:.3e} of the largest value, "
                                 f"shape {tuple(on_card.shape)}")
        # the device's busy share in the predictor's own step on a warm item
        batch = next(iter(pred.test_dataloader))
        patient = pred._item_meta(int(batch["index"][0]))[0]
        masks = pred._metric_masks(patient, (HR, HR))
        busy = device_busy(lambda: pred._step(batch, masks))
        flops = forward_flops(pred.net, lr.to(dev))
        nbytes = 4 * (lr.numel() + HR * HR + n_params)  # input, output, weights once
        bound, bound_by = bound_ms(nbytes, flops, *rates)
        log("sisr eval", f"{name}: frames/s {pred.throughput['frames_per_sec']:.2f} over {frames} "
                         f"frames; warm {warm_ms:.3f} ms a frame (median of items 2-{frames}); "
                         f"test_from_config wall {wall:.2f} s; peak device memory "
                         f"{peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} above the "
                         f"{held / 2**30:.3f} held before); {flops:.4g} operations a frame, bound "
                         f"{bound:.3f} ms ({bound_by}), {bound / warm_ms:.1%} of it; card vs CPU "
                         f"{gap:.3e} of the largest value (tol {TOL_SISR_CARD_CPU})")
        log("sisr eval", f"{name}: predictor step on a warm item: wall {busy[0]:.3f} ms, "
                         f"{busy[2]} kernels {busy[1]:.3f} ms, device busy {busy[1] / busy[0]:.1%}; "
                         f"the bound is {bound / busy[1]:.1%} of the kernel time")
        results[name] = {"frames_per_sec": pred.throughput["frames_per_sec"], "warm_ms": warm_ms,
                         "item_ms": [x * 1e3 for x in pred.item_seconds], "peak_gib": peak / 2**30,
                         "held_gib": held / 2**30,
                         "flops_per_frame": flops, "bound_ms": bound, "bound_by": bound_by,
                         "card_vs_cpu_rel": gap, "log": pred.log, "wall_s": wall,
                         "step_wall_ms": busy[0], "step_kernel_ms": busy[1],
                         "step_kernels": busy[2]}
        del pred, cpu_net, net
    print(json.dumps({"sisr_serving": results, "card": card_line}), flush=True)
    return results


def sisr_training(port_main, Cfg, lstm_gates, tree: dict, tmp: Path, dev, rates, card_line) -> dict:
    """Phase 14: EDSR and SRFB train on the tree's frames."""
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        EDSRNet,
        SRFBNet,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
        load_checkpoint,
    )

    results = {}
    for name, cls in (("EDSRNet", EDSRNet), ("SRFBNet", SRFBNet)):
        saved = tmp / f"train_{name}"
        held = torch.cuda.memory_allocated(dev)  # by the earlier phases
        reset_launches(lstm_gates)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer = port_main.train_from_config(Cfg(sisr_train_config(tree, name, saved)))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        if launches(lstm_gates) != (0, 0, 0, 0):
            raise AssertionError(f"{name} training launched the gate kernels {launches(lstm_gates)}")
        history = trainer.history["train"] + trainer.history["valid"]
        if len(trainer.history["train"]) != EPOCHS or not all(
                math.isfinite(v) for h in history for v in h.values()):
            raise AssertionError(f"{name} training logs incomplete or non-finite: {trainer.history}")
        for epoch, (t_log, v_log) in enumerate(zip(trainer.history["train"],
                                                   trainer.history["valid"]), 1):
            log("sisr train", f"{name} epoch {epoch}: Train log {t_log}; Valid log {v_log}")
        ckpts = saved / "checkpoints"
        best = load_checkpoint(ckpts / "model_best.pth")
        reloaded = cls(**SISR_NETS[name])
        reloaded.load_state_dict(best["net"], strict=True)
        same_epoch = load_checkpoint(ckpts / f"model_{best['epoch']}.pth")["net"]
        final = load_checkpoint(ckpts / f"model_{EPOCHS}.pth")["net"]
        reloaded_sd = reloaded.state_dict()
        for key, value in trainer.net.state_dict().items():
            if not (torch.equal(reloaded_sd[key], same_epoch[key])
                    and torch.equal(final[key], value.cpu())):
                raise AssertionError(f"{name}: checkpointed {key} differs from the trainer's")
        tp = trainer.throughput  # of the last epoch: every step warm
        step_ms = 1e3 / tp["train_steps_per_sec"]
        # forward + backward ≈ 3 forwards (the backward's data and weight
        # gradients each cost one), at the full batch's shape
        x = torch.zeros(TRAIN_BATCH, PATCH, PATCH, 1, device=dev)
        flops = 3 * forward_flops(trainer.net, x)
        n_params = sum(p.numel() for p in trainer.net.parameters())
        # batch in and out, weights read and written, Adam's two moments read and written
        nbytes = 4 * (x.numel() * (1 + SCALE * SCALE) + 6 * n_params)
        bound, bound_by = bound_ms(nbytes, flops, *rates)
        log("sisr train", f"{name}: model_best.pth (epoch {best['epoch']}) and model_{EPOCHS}.pth "
                          f"reload equal to the trainer's weights")
        print(f"sisr training {name}: {tp['train_steps_per_sec']:.4f} steps/s, "
              f"{tp['frames_per_sec']:.2f} LR frames/s, {step_ms:.2f} ms a step (epoch {EPOCHS}: "
              f"{STEPS_PER_EPOCH} warm steps, the last of "
              f"{2 * 2 * CYCLE - (STEPS_PER_EPOCH - 1) * TRAIN_BATCH} frames, and the valid "
              f"epoch not in it), peak device memory {peak / 2**30:.3f} GiB ("
              f"{(peak - held) / 2**30:.3f} above the {held / 2**30:.3f} held before), train_from_config "
              f"wall {wall:.1f} s; {flops:.4g} operations a step, bound {bound:.3f} ms "
              f"({bound_by}), {bound / step_ms:.1%} of it", flush=True)
        results[name] = {"steps_per_sec": tp["train_steps_per_sec"],
                         "frames_per_sec": tp["frames_per_sec"], "step_ms": step_ms,
                         "peak_gib": peak / 2**30, "held_gib": held / 2**30,
                         "flops_per_step": flops, "bound_ms": bound,
                         "bound_by": bound_by, "wall_s": wall, "best_epoch": best["epoch"]}
        del trainer
    print(json.dumps({"sisr_training": results, "card": card_line}), flush=True)
    return results


def misr_eval_config(tree: dict, name: str, net_kwargs: dict, ckpt: Path, saved_dir: Path,
                     num_frames: int = MISR_T, loss: dict | None = None, **pred_kwargs) -> dict:
    """configs/test/{duf_net,rbp_net,toflow_net,edvr_net}/exp1_x4[_tpu].yaml
    with paths into the synthetic tree's windows of ``num_frames``, on
    cuda:0, without the GIF/PNG export."""
    coords = str(tree["coordinates"])
    if loss is None:
        loss = ({"name": "HuberLoss", "kwargs": {"delta": 0.01}, "weight": 1.0}
                if name == "DUFNet" else {"name": "L1Loss", "weight": 1.0})
    return {
        "main": {"saved_dir": str(saved_dir), "loaded_path": str(ckpt)},
        "dataset": {"name": "AcdcMISRDataset",
                    "kwargs": {"data_dir": str(tree["videos"]), "downscale_factor": SCALE,
                               "transforms": [{"name": "Normalize",
                                               "kwargs": {"means": [54.089], "stds": [48.084]}},
                                              {"name": "ToTensor"}],
                               "num_frames": num_frames}},
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"batch_size": 1, "shuffle": False, "num_workers": 8}},
        "net": {"name": name, "kwargs": net_kwargs},
        "losses": [loss],
        "metrics": [
            {"name": "PSNR"}, {"name": "SSIM"},
            {"name": "CardiacPSNR", "kwargs": {"coordinates_path": coords}},
            {"name": "CardiacSSIM", "kwargs": {"coordinates_path": coords}},
        ],
        "predictor": {"name": "AcdcMISRPredictor",
                      "kwargs": {"device": "cuda:0", "saved_dir": str(saved_dir), "exported": False,
                                 **pred_kwargs}},
    }


def misr_train_config(tree: dict, key: str, saved_dir: Path) -> dict:
    """configs/train/{duf_net,rbp_net,toflow_net}/exp1_x4.yaml (``key``
    RBPNet_tpu: rbp_net/exp1_x4_tpu.yaml) with paths into the synthetic
    tree's windows, on cuda:0, for EPOCHS epochs with a checkpoint every
    epoch, with its ``logger:`` section."""
    name = key.split("_")[0]
    batch, loss, lr, weight_decay, knobs = MISR_TRAIN[key]
    return {
        "main": {"random_seed": "vsr", "saved_dir": str(saved_dir), "loaded_path": None},
        "dataset": {
            "name": "AcdcMISRDataset",
            "kwargs": {
                "data_dir": str(tree["videos"]), "downscale_factor": SCALE,
                "transforms": [
                    {"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                    {"name": "ToTensor"},
                ],
                "augments": [
                    {"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
                    {"name": "RandomCropPatch", "kwargs": {"size": [PATCH, PATCH], "ratio": SCALE}},
                ],
                "num_frames": MISR_T,
            },
        },
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"train_batch_size": batch, "valid_batch_size": 1,
                                  "shuffle": True, "num_workers": 8}},
        "net": {"name": name, "kwargs": MISR_NETS[name]},
        "losses": [loss],
        "metrics": [{"name": "PSNR"}, {"name": "SSIM"}],
        "optimizer": {"name": "Adam", "kwargs": {"lr": lr, "weight_decay": weight_decay}},
        "logger": {"name": "AcdcMISRLogger", "kwargs": {"dummy_input": [batch, 1, PATCH, PATCH]}},
        "monitor": {"name": "Monitor",
                    "kwargs": {"mode": "min", "target": "Loss", "saved_freq": 1, "early_stop": 0}},
        "trainer": {"name": "AcdcMISRTrainer",
                    "kwargs": {"device": "cuda:0", "num_epochs": EPOCHS, **knobs}},
    }


def seeded_misr_net(cls, kwargs: dict):
    """``cls(**kwargs)`` from seed 0, its BatchNorm running statistics drawn
    off their init values (mean 0, variance 1) so that serving reads them."""
    import torch

    net = cls(**kwargs, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for key, buf in net.named_buffers():
            if key.endswith("running_mean"):
                buf.uniform_(-0.1, 0.1, generator=gen)
            elif key.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=gen)
    return net


def misr_serving(port_main, Cfg, lstm_gates, tree: dict, tmp: Path, dev, rates, card_line) -> dict:
    """Phase 15: each multi-frame net serves the tree's test windows; then
    TOFlow with the ``_tpu`` config's knobs (bf16, ``max_flow: 4``)."""
    import copy

    import numpy as np
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        telemetry,
    )

    runs = [(name, name, kwargs, {}) for name, kwargs in MISR_NETS.items()]
    runs.append(("TOFlowNet_tpu", "TOFlowNet", TOFLOW_TPU_NET, {"compute_dtype": "bfloat16"}))
    results, windows = {}, CYCLE * SLICES
    for key, name, kwargs, pred_kwargs in runs:
        ckpt = tmp / f"{name}.pth"
        if not ckpt.exists():
            torch.save({"net": seeded_misr_net(getattr(models, name),
                                               MISR_NETS[name]).state_dict()}, ckpt)
        cfg = Cfg(misr_eval_config(tree, name, kwargs, ckpt, tmp / f"test_{key}", **pred_kwargs))
        held = torch.cuda.memory_allocated(dev)  # by the earlier phases
        reset_launches(lstm_gates)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pred = port_main.test_from_config(cfg)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        if launches(lstm_gates) != (0, 0, 0, 0):
            raise AssertionError(f"{key} serving launched the gate kernels {launches(lstm_gates)}")
        frames = pred.throughput["frames"]
        if frames != windows or not all(math.isfinite(v) for v in pred.log.values()):
            raise AssertionError(f"{key} serving scored {frames} windows: {pred.log}")
        warm_ms = float(np.median(pred.item_seconds[1:])) * 1e3
        n_params = sum(p.numel() for p in pred.net.parameters())
        log("misr eval", f"{key} {kwargs} {pred_kwargs}: {n_params:,} params; Test log {pred.log}")
        if "max_flow" in kwargs:
            if sorted(pred.telemetry_summary) != ["flow_window", "spy_net/pyramid_flow_window"]:
                raise AssertionError(f"{key}: telemetry sites {sorted(pred.telemetry_summary)}")
            log("misr eval", f"{key}: Windowed-op telemetry: "
                             f"{telemetry.format_summary(pred.telemetry_summary)}")

        # one window on the card against the same weights on the CPU, in
        # the predictor's compute dtype
        item = pred.test_dataloader.dataset[0]
        lr = torch.from_numpy(item["lr_imgs"][None])
        with torch.inference_mode():
            on_card = pred._forward(lr.to(dev)).cpu()
            cpu_pred = copy.copy(pred)
            cpu_pred.net = copy.deepcopy(pred.net).cpu()
            on_cpu = cpu_pred._forward(lr)
        gap = ((on_card - on_cpu).abs().max() / on_cpu.abs().max()).item()
        if tuple(on_card.shape) != (1, HR, HR, 1) or not gap <= TOL_SISR_CARD_CPU:
            raise AssertionError(f"{key}: card vs CPU {gap:.3e} of the largest value, "
                                 f"shape {tuple(on_card.shape)}")
        # the device's busy share in the predictor's own step on a warm window
        batch = next(iter(pred.test_dataloader))
        patient = pred._item_meta(int(batch["index"][0]))[0]
        masks = pred._metric_masks(patient, (HR, HR))
        busy = device_busy(lambda: pred._step(batch, masks))
        flops = forward_flops(pred.net, lr.to(dev))
        nbytes = 4 * (lr.numel() + HR * HR + n_params)  # input, output, weights once
        bound, bound_by = bound_ms(nbytes, flops, *rates)
        log("misr eval", f"{key}: frames/s {pred.throughput['frames_per_sec']:.2f} over {frames} "
                         f"windows; warm {warm_ms:.3f} ms a window (median of items 2-{frames}); "
                         f"test_from_config wall {wall:.2f} s; peak device memory "
                         f"{peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} above the "
                         f"{held / 2**30:.3f} held before); {flops:.4g} operations a window, bound "
                         f"{bound:.3f} ms ({bound_by}), {bound / warm_ms:.1%} of it; card vs CPU "
                         f"{gap:.3e} of the largest value (tol {TOL_SISR_CARD_CPU})")
        log("misr eval", f"{key}: predictor step on a warm window: wall {busy[0]:.3f} ms, "
                         f"{busy[2]} kernels {busy[1]:.3f} ms, device busy {busy[1] / busy[0]:.1%}; "
                         f"the bound is {bound / busy[1]:.1%} of the kernel time")
        results[key] = {"frames_per_sec": pred.throughput["frames_per_sec"], "warm_ms": warm_ms,
                        "item_ms": [x * 1e3 for x in pred.item_seconds], "peak_gib": peak / 2**30,
                        "held_gib": held / 2**30, "flops_per_window": flops, "bound_ms": bound,
                        "bound_by": bound_by, "card_vs_cpu_rel": gap, "log": pred.log,
                        "wall_s": wall, "step_wall_ms": busy[0], "step_kernel_ms": busy[1],
                        "step_kernels": busy[2], "telemetry": pred.telemetry_summary}
        del pred, cpu_pred
    fp32, bf16 = results["TOFlowNet"]["log"], results["TOFlowNet_tpu"]["log"]
    gaps = {k: bf16[k] - fp32[k] for k in ("PSNR", "SSIM", "CardiacPSNR", "CardiacSSIM")}
    log("misr eval", f"TOFlow bf16 + max_flow 4 - fp32: {gaps} (bound |dPSNR| < "
                     f"{TOL_TOFLOW_BF16_DPSNR}, |dSSIM| < {TOL_TOFLOW_BF16_DSSIM})")
    if not all(abs(v) < (TOL_TOFLOW_BF16_DPSNR if "PSNR" in k else TOL_TOFLOW_BF16_DSSIM)
               for k, v in gaps.items()):
        raise AssertionError(f"bf16 TOFlow serving left the bound of the fp32 run: {gaps}")
    results["toflow_bf16_minus_fp32"] = gaps
    print(json.dumps({"misr_serving": results, "card": card_line}), flush=True)
    return results


def misr_training(port_main, Cfg, lstm_gates, tree: dict, tmp: Path, dev, rates, card_line,
                  bf16_peak: float) -> dict:
    """Phase 16: DUF, RBPN and TOFlow train on the tree's windows, and RBPN
    with the ``_tpu`` config's knobs (bf16, 2 microbatches: its convs run on
    the tensor cores, so its bound takes the bf16 peak)."""
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
        load_checkpoint,
    )

    results = {}
    for key in MISR_TRAIN:
        name = key.split("_")[0]
        batch_size = MISR_TRAIN[key][0]
        saved = tmp / f"train_{key}"
        held = torch.cuda.memory_allocated(dev)  # by the earlier phases
        reset_launches(lstm_gates)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer = port_main.train_from_config(Cfg(misr_train_config(tree, key, saved)))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        if launches(lstm_gates) != (0, 0, 0, 0):
            raise AssertionError(f"{key} training launched the gate kernels {launches(lstm_gates)}")
        history = trainer.history["train"] + trainer.history["valid"]
        if len(trainer.history["train"]) != EPOCHS or not all(
                math.isfinite(v) for h in history for v in h.values()):
            raise AssertionError(f"{key} training logs incomplete or non-finite: {trainer.history}")
        events = list((saved / "log").rglob("events.out.tfevents.*"))
        if not events:
            raise AssertionError(f"{key}: the logger wrote no event file")
        for epoch, (t_log, v_log) in enumerate(zip(trainer.history["train"],
                                                   trainer.history["valid"]), 1):
            log("misr train", f"{key} epoch {epoch}: Train log {t_log}; Valid log {v_log}")
        ckpts = saved / "checkpoints"
        best = load_checkpoint(ckpts / "model_best.pth")
        reloaded = getattr(models, name)(**MISR_NETS[name])
        reloaded.load_state_dict(best["net"], strict=True)
        same_epoch = load_checkpoint(ckpts / f"model_{best['epoch']}.pth")["net"]
        final = load_checkpoint(ckpts / f"model_{EPOCHS}.pth")["net"]
        reloaded_sd = reloaded.state_dict()
        trained_sd = trainer.net.state_dict()
        for k, value in trained_sd.items():  # running statistics included
            if not (torch.equal(reloaded_sd[k], same_epoch[k]) and torch.equal(final[k], value.cpu())):
                raise AssertionError(f"{key}: checkpointed {k} differs from the trainer's")
        n_stats = sum("running" in k for k in trained_sd)
        state_dtypes = {p.dtype for p in trainer.net.parameters()} | {
            b.dtype for b in trainer.net.buffers() if b.is_floating_point()}
        if state_dtypes != {torch.float32}:
            raise AssertionError(f"{key}: the masters left fp32: {state_dtypes}")
        tp = trainer.throughput  # of the last epoch: every step warm
        step_ms = 1e3 / tp["train_steps_per_sec"]
        # forward + backward ≈ 3 forwards at the full batch's shape
        x = torch.zeros(batch_size, MISR_T, PATCH, PATCH, 1, device=dev)
        flops = 3 * forward_flops(trainer.net, x)
        n_params = sum(p.numel() for p in trainer.net.parameters())
        # batch in and out, weights read and written, Adam's two moments read and written
        nbytes = 4 * (x.numel() + batch_size * (PATCH * SCALE) ** 2 + 6 * n_params)
        bf16 = MISR_TRAIN[key][4].get("compute_dtype") == "bfloat16"
        bound, bound_by = bound_ms(nbytes, flops, rates[0], bf16_peak if bf16 else rates[1])
        steps = math.ceil(2 * 2 * CYCLE / batch_size)
        log("misr train", f"{key}: model_best.pth (epoch {best['epoch']}) and model_{EPOCHS}.pth "
                          f"reload equal to the trainer's weights and {n_stats} running "
                          f"statistics; {len(events)} event files")
        print(f"misr training {key}: {tp['train_steps_per_sec']:.4f} steps/s, "
              f"{tp['frames_per_sec']:.2f} LR frames/s, {step_ms:.2f} ms a step (epoch {EPOCHS}: "
              f"{steps} warm steps of {batch_size} windows x {MISR_T} frames, the last of "
              f"{2 * 2 * CYCLE - (steps - 1) * batch_size}, and the valid epoch not in it), peak "
              f"device memory {peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} above the "
              f"{held / 2**30:.3f} held before), train_from_config wall {wall:.1f} s; "
              f"{flops:.4g} operations a step, bound {bound:.3f} ms ({bound_by}), "
              f"{bound / step_ms:.1%} of it", flush=True)
        results[key] = {"steps_per_sec": tp["train_steps_per_sec"],
                        "frames_per_sec": tp["frames_per_sec"], "step_ms": step_ms,
                        "peak_gib": peak / 2**30, "held_gib": held / 2**30,
                        "flops_per_step": flops, "bound_ms": bound, "bound_by": bound_by,
                        "wall_s": wall, "best_epoch": best["epoch"], "batch": batch_size,
                        "bound_peak": "bf16" if bf16 else "fp32"}
        del trainer
    print(json.dumps({"misr_training": results, "card": card_line}), flush=True)
    return results


def vsr_eval_config(tree: dict, name: str, net_kwargs: dict, ckpt: Path, saved_dir: Path,
                    dev, **pred_kwargs) -> dict:
    """configs/test/{drf_net,frvsr_net}/exp1_x4[_tpu].yaml with paths into
    the synthetic tree's whole sequences, on ``dev``, without the GIF/PNG
    export."""
    coords = str(tree["coordinates"])
    return {
        "main": {"saved_dir": str(saved_dir), "loaded_path": str(ckpt)},
        "dataset": {"name": "AcdcVSRDataset",
                    "kwargs": {"data_dir": str(tree["videos"]), "downscale_factor": SCALE,
                               "transforms": [{"name": "Normalize",
                                               "kwargs": {"means": [54.089], "stds": [48.084]}},
                                              {"name": "ToTensor"}],
                               "num_frames": VSR_TRAIN[name][1]}},
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"batch_size": 1, "shuffle": False, "num_workers": 8}},
        "net": {"name": name, "kwargs": net_kwargs},
        "losses": [{"name": VSR_TEST_LOSS[name], "weight": 1.0}],
        "metrics": [
            {"name": "PSNR"}, {"name": "SSIM"},
            {"name": "CardiacPSNR", "kwargs": {"coordinates_path": coords}},
            {"name": "CardiacSSIM", "kwargs": {"coordinates_path": coords}},
        ],
        "predictor": {"name": f"Acdc{VSR_WORKLOAD[name]}Predictor",
                      "kwargs": {"device": str(dev), "saved_dir": str(saved_dir),
                                 "exported": False, **pred_kwargs}},
    }


def vsr_train_config(tree: dict, name: str, saved_dir: Path, dev) -> dict:
    """configs/train/{drf_net,frvsr_net}/exp1_x4.yaml with paths into the
    synthetic tree, on ``dev``, for EPOCHS epochs with a checkpoint every
    epoch, with its ``logger:`` section."""
    batch, frames, losses = VSR_TRAIN[name]
    return {
        "main": {"random_seed": "vsr", "saved_dir": str(saved_dir), "loaded_path": None},
        "dataset": {
            "name": "AcdcVSRDataset",
            "kwargs": {
                "data_dir": str(tree["videos"]), "downscale_factor": SCALE,
                "transforms": [
                    {"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                    {"name": "ToTensor"},
                ],
                "augments": [
                    {"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
                    {"name": "RandomCropPatch", "kwargs": {"size": [PATCH, PATCH], "ratio": SCALE}},
                ],
                "num_frames": frames,
            },
        },
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"train_batch_size": batch, "valid_batch_size": 1,
                                  "shuffle": True, "num_workers": 8}},
        "net": {"name": name, "kwargs": VSR_NETS[name]},
        "losses": losses,
        "metrics": [{"name": "PSNR"}, {"name": "SSIM"}],
        "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-4, "weight_decay": 0}},
        "logger": {"name": "AcdcVSRLogger", "kwargs": {"dummy_input": [batch, 1, PATCH, PATCH]}},
        "monitor": {"name": "Monitor",
                    "kwargs": {"mode": "min", "target": "Loss", "saved_freq": 1, "early_stop": 0}},
        "trainer": {"name": f"Acdc{VSR_WORKLOAD[name]}Trainer",
                    "kwargs": {"device": str(dev), "num_epochs": EPOCHS}},
    }


def vsr_serving(port_main, Cfg, lstm_gates, tree: dict, tmp: Path, dev, rates, card_line) -> dict:
    """Phase 17: DRF and FRVSR serve the tree's whole test sequences; then
    FRVSR with the ``_tpu`` config's knobs (bf16, ``max_flow: 4``); the fp32
    clips against the CPU and every FRVSR clip against ``FRVSRStream``."""
    import copy

    import numpy as np
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        telemetry,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.streaming import (
        FRVSRStream,
    )

    results, clips = {}, SLICES
    for key, name, kwargs, pred_kwargs in VSR_SERVE:
        ckpt = tmp / f"{name}.pth"
        if not ckpt.exists():
            net = getattr(models, name)(**VSR_NETS[name], generator=torch.Generator().manual_seed(0))
            torch.save({"net": net.state_dict()}, ckpt)
        cfg = Cfg(vsr_eval_config(tree, name, kwargs, ckpt, tmp / f"test_{key}", dev,
                                  **pred_kwargs))
        held = torch.cuda.memory_allocated(dev)  # by the earlier phases
        reset_launches(lstm_gates)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pred = port_main.test_from_config(cfg)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        if launches(lstm_gates) != (0, 0, 0, 0):
            raise AssertionError(f"{key} serving launched the gate kernels {launches(lstm_gates)}")
        frames = pred.throughput["frames"]
        if frames != CYCLE * clips or not all(math.isfinite(v) for v in pred.log.values()):
            raise AssertionError(f"{key} serving scored {frames} frames: {pred.log}")
        n_params = sum(p.numel() for p in pred.net.parameters())
        log("vsr eval", f"{key} {kwargs} {pred_kwargs}: {n_params:,} params; Test log {pred.log}")
        tel_line = telemetry.format_summary(pred.telemetry_summary)
        if "max_flow" in kwargs:
            if sorted(pred.telemetry_summary) != ["lr_flow_window", "sr_flow_window"]:
                raise AssertionError(f"{key}: telemetry sites {sorted(pred.telemetry_summary)}")
            log("vsr eval", f"{key}: Windowed-op telemetry: {tel_line}")

        # one clip on the card; the fp32 ones against the same weights on
        # the CPU, every FRVSR one against the stream fed frame by frame
        item = pred.test_dataloader.dataset[0]
        lr = torch.from_numpy(item["lr_imgs"][None])
        with torch.inference_mode():
            on_card = pred._forward(lr.to(dev))
        gap = None
        if pred.compute_dtype is None:
            cpu_pred = copy.copy(pred)
            cpu_pred.net = copy.deepcopy(pred.net).cpu()
            with torch.inference_mode():
                on_cpu = cpu_pred._forward(lr)
            gap = ((on_card.cpu() - on_cpu).abs().max() / on_cpu.abs().max()).item()
            del cpu_pred
            if tuple(on_card.shape) != (1, CYCLE, HR, HR, 1) or not gap <= TOL_SISR_CARD_CPU:
                raise AssertionError(f"{key}: card vs CPU {gap:.3e} of the largest value, "
                                     f"shape {tuple(on_card.shape)}")
        stream_gap = None
        if name == "FRVSRNet":
            stream = FRVSRStream(pred.net, compute_dtype=pred_kwargs.get("compute_dtype"))
            pushed = torch.stack([stream.push(lr[:, t].to(dev)) for t in range(CYCLE)], dim=1)
            stream_gap = ((pushed - on_card).abs().max() / on_card.abs().max()).item()
            if not stream_gap <= TOL_STREAM:
                raise AssertionError(f"{key}: FRVSRStream vs the clip forward {stream_gap:.3e}")
            del stream, pushed
        # the device's busy share in the predictor's own step on a warm clip
        batch = next(iter(pred.test_dataloader))
        patient = pred._item_meta(int(batch["index"][0]))[0]
        masks = pred._metric_masks(patient, (HR, HR))
        busy = device_busy(lambda: pred._step(batch, masks))
        flops = forward_flops(pred.net, lr.to(dev))
        nbytes = 4 * (lr.numel() + CYCLE * HR * HR + n_params)  # input, output, weights once
        bound, bound_by = bound_ms(nbytes, flops, *rates)
        log("vsr eval", f"{key}: frames/s {pred.throughput['frames_per_sec']:.2f} over {frames} "
                        f"frames ({clips} clips of {CYCLE}); warm clip {busy[0]:.3f} ms (median of "
                        f"3 predictor steps), {busy[0] / CYCLE:.3f} ms a frame; item seconds "
                        f"{[round(x, 4) for x in pred.item_seconds]}; test_from_config wall "
                        f"{wall:.2f} s; peak device memory {peak / 2**30:.3f} GiB "
                        f"({(peak - held) / 2**30:.3f} above the {held / 2**30:.3f} held before); "
                        f"{flops:.4g} operations a clip, bound {bound:.3f} ms ({bound_by}), "
                        f"{bound / busy[0]:.1%} of it; card vs CPU "
                        f"{'not run (bf16)' if gap is None else f'{gap:.3e}'} of the largest "
                        f"value (tol {TOL_SISR_CARD_CPU}); stream vs clip "
                        f"{'n/a' if stream_gap is None else f'{stream_gap:.3e}'} (tol {TOL_STREAM})")
        log("vsr eval", f"{key}: predictor step on a warm clip: {busy[2]} kernels {busy[1]:.3f} ms, "
                        f"device busy {busy[1] / busy[0]:.1%}; the bound is "
                        f"{bound / busy[1]:.1%} of the kernel time")
        results[key] = {"frames_per_sec": pred.throughput["frames_per_sec"],
                        "clip_ms": busy[0], "item_ms": [x * 1e3 for x in pred.item_seconds],
                        "peak_gib": peak / 2**30, "held_gib": held / 2**30,
                        "flops_per_clip": flops, "bound_ms": bound, "bound_by": bound_by,
                        "card_vs_cpu_rel": gap, "stream_vs_clip_rel": stream_gap,
                        "log": pred.log, "telemetry": pred.telemetry_summary, "wall_s": wall,
                        "step_kernel_ms": busy[1], "step_kernels": busy[2]}
        del pred, on_card
    fp32, bf16 = results["FRVSRNet"]["log"], results["FRVSRNet_tpu"]["log"]
    gaps = {k: bf16[k] - fp32[k] for k in ("PSNR", "SSIM", "CardiacPSNR", "CardiacSSIM")}
    log("vsr eval", f"FRVSR bf16 + max_flow 4 - fp32: {gaps} (bound |dPSNR| < "
                    f"{TOL_FRVSR_BF16_DPSNR}, |dSSIM| < {TOL_FRVSR_BF16_DSSIM})")
    if not all(abs(v) < (TOL_FRVSR_BF16_DPSNR if "PSNR" in k else TOL_FRVSR_BF16_DSSIM)
               for k, v in gaps.items()):
        raise AssertionError(f"bf16 FRVSR serving left the bound of the fp32 run: {gaps}")
    results["frvsr_bf16_minus_fp32"] = gaps
    print(json.dumps({"vsr_serving": results, "card": card_line}), flush=True)
    return results


def vsr_training(port_main, Cfg, lstm_gates, tree: dict, tmp: Path, dev, rates, card_line) -> dict:
    """Phase 18: DRF and FRVSR train on the tree's windows."""
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
        load_checkpoint,
    )

    results = {}
    for name, (batch_size, frames, _) in VSR_TRAIN.items():
        saved = tmp / f"train_{name}"
        held = torch.cuda.memory_allocated(dev)  # by the earlier phases
        reset_launches(lstm_gates)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer = port_main.train_from_config(Cfg(vsr_train_config(tree, name, saved, dev)))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        if launches(lstm_gates) != (0, 0, 0, 0):
            raise AssertionError(f"{name} training launched the gate kernels {launches(lstm_gates)}")
        history = trainer.history["train"] + trainer.history["valid"]
        if len(trainer.history["train"]) != EPOCHS or not all(
                math.isfinite(v) for h in history for v in h.values()):
            raise AssertionError(f"{name} training logs incomplete or non-finite: {trainer.history}")
        if not list((saved / "log").rglob("events.out.tfevents.*")):
            raise AssertionError(f"{name}: the logger wrote no event file")
        for epoch, (t_log, v_log) in enumerate(zip(trainer.history["train"],
                                                   trainer.history["valid"]), 1):
            log("vsr train", f"{name} epoch {epoch}: Train log {t_log}; Valid log {v_log}")
        ckpts = saved / "checkpoints"
        best = load_checkpoint(ckpts / "model_best.pth")
        reloaded = getattr(models, name)(**VSR_NETS[name])
        reloaded.load_state_dict(best["net"], strict=True)
        final = load_checkpoint(ckpts / f"model_{EPOCHS}.pth")["net"]
        if not all(torch.equal(final[k], v.cpu()) for k, v in trainer.net.state_dict().items()):
            raise AssertionError(f"{name}: the final checkpoint differs from the trainer's weights")
        if {p.dtype for p in trainer.net.parameters()} != {torch.float32}:
            raise AssertionError(f"{name}: the masters left fp32")
        tp = trainer.throughput  # of the last epoch: every step warm
        step_ms = 1e3 / tp["train_steps_per_sec"]
        # forward + backward ≈ 3 forwards at the full batch's shape
        x = torch.zeros(batch_size, frames, PATCH, PATCH, 1, device=dev)
        flops = 3 * forward_flops(trainer.net, x)
        n_params = sum(p.numel() for p in trainer.net.parameters())
        # batch in and out, weights read and written, Adam's two moments read and written
        nbytes = 4 * (x.numel() + batch_size * frames * (PATCH * SCALE) ** 2 + 6 * n_params)
        bound, bound_by = bound_ms(nbytes, flops, *rates)
        steps = math.ceil(2 * 2 * CYCLE / batch_size)
        log("vsr train", f"{name}: model_best.pth (epoch {best['epoch']}) reloads, "
                         f"model_{EPOCHS}.pth equals the trainer's weights")
        print(f"vsr training {name}: {tp['train_steps_per_sec']:.4f} steps/s, "
              f"{tp['frames_per_sec']:.2f} LR frames/s, {step_ms:.2f} ms a step (epoch {EPOCHS}: "
              f"{steps} warm steps of {batch_size} windows x {frames} frames, the last of "
              f"{2 * 2 * CYCLE - (steps - 1) * batch_size}, and the valid epoch not in it), peak "
              f"device memory {peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} above the "
              f"{held / 2**30:.3f} held before), train_from_config wall {wall:.1f} s; "
              f"{flops:.4g} operations a step, bound {bound:.3f} ms ({bound_by}), "
              f"{bound / step_ms:.1%} of it", flush=True)
        results[name] = {"steps_per_sec": tp["train_steps_per_sec"],
                         "frames_per_sec": tp["frames_per_sec"], "step_ms": step_ms,
                         "peak_gib": peak / 2**30, "held_gib": held / 2**30,
                         "flops_per_step": flops, "bound_ms": bound, "bound_by": bound_by,
                         "wall_s": wall, "best_epoch": best["epoch"], "batch": batch_size,
                         "frames": frames}
        del trainer
    print(json.dumps({"vsr_training": results, "card": card_line}), flush=True)
    return results


# ------------------------------------------------------------ EDVR (19-21)
# configs/{test,train}/edvr_net/exp1_x4.yaml: the net at its published width
EDVR_T = 5
EDVR_NET = {"in_channels": 1, "out_channels": 1, "nf": 128, "nframes": EDVR_T, "groups": 8,
            "front_RBs": 5, "back_RBs": 40}
EDVR_TPU_R = 2  # configs/{test,train}/edvr_net/exp1_x4_tpu.yaml: dcn_max_offset
EDVR_LOSS = {"name": "CharbonnierLoss", "kwargs": {"epsilon": 1e-6}, "weight": 1.0}
# DCN calls a forward: 5 neighbours (the centre included, as the reference
# loops) x {L3, L2, L1, cascading}; under the _tpu knobs the L3 level's col
# is bf16 (its offsets come from bf16 convs) and the other three fp32 (their
# offsets follow an fp32 resize product, which promotes, as in JAX)
DCN_PER_FORWARD, DCN_BF16_PER_FORWARD = EDVR_T * 4, EDVR_T
EDVR_TRAIN = {"EDVRNet": (16, {}), "EDVRNet_tpu": (16, {"compute_dtype": "bfloat16",
                                                        "grad_accum_steps": 2})}
# phase 19's shapes: EDVR's L1 DCN call at the serving window (64x64) and at
# the training batch (16 windows of 32x32), nf 128, 8 deformable groups
DCN_SHAPES = {"serving": (1, 128, 64, 64), "training": (16, 128, 32, 32)}
DCN_DG = 8
# operations per col element (one (b, c, tap, pixel) sample), counted from
# the kernels: im2col, 2 coordinates, 2 floors and fractions (4), 4 corner
# weights (8), 4 multiply-adds (8) and the mask (1); col2im, the same
# coordinates and weights (14), grad x mask (1) and 4 weighted adds (8);
# col2im_coord, 3 multiply-adds a corner (24) and 3 with the gradient (6)
DCN_OPS = {"deform_im2col": 23, "deform_col2im": 23, "deform_col2im_coord": 30}
# kernels against the plain version on the same inputs, relative to the
# largest element: fp32 sums in another order (col2im's atomics in a
# different order every run); bf16 rounds col (and d_weight's product) to
# 8 bits where the plain version stays fp32
TOL_DCN_FP32, TOL_DCN_BF16 = 1e-5, 2e-2
# the first designs' per-launch times at these shapes, recorded from three
# runs of this phase on an H100 80GB HBM3 at 700.00 W (a thread per output
# element, fp32 atomics in col2im; col2im_coord's a thread per (b, group,
# tap, p) looping over the group's channels, from the three runs of the
# commit that redesigned im2col and col2im), in us: printed beside the
# redesigned kernels' times as recorded values, not measured by this script
FIRST_DESIGN_US = {
    ("deform_im2col", "serving", "torch.float32"): (43.95, 44.14),
    ("deform_im2col", "serving", "torch.bfloat16"): (43.67, 44.03),
    ("deform_im2col", "training", "torch.float32"): (170.3, 170.7),
    ("deform_im2col", "training", "torch.bfloat16"): (167.6, 168.7),
    ("deform_col2im", "serving", "torch.float32"): (187.65, 188.17),
    ("deform_col2im", "serving", "torch.bfloat16"): (187.76, 188.44),
    ("deform_col2im", "training", "torch.float32"): (702.8, 704.5),
    ("deform_col2im", "training", "torch.bfloat16"): (702.9, 703.8),
    ("deform_col2im_coord", "serving", "torch.float32"): (28.43, 28.68),
    ("deform_col2im_coord", "serving", "torch.bfloat16"): (28.08, 28.29),
    ("deform_col2im_coord", "training", "torch.float32"): (95.95, 96.34),
    ("deform_col2im_coord", "training", "torch.bfloat16"): (89.89, 90.06),
}
# offsets far beyond the 3x3 taps' reach (up to 12 px): corners land far from
# their output position, in any tile
DCN_WIDE_OFFSET = 12.0
# EDVR offsets drawn off the zero init: conv_offset_mask ~ N(0, 0.1), so
# the offsets are fractional (up to ~1.5 px at the published width) and
# mostly inside the 2 px window
EDVR_OFFSET_STD = 0.1
# phase 19's stand-in for such offsets, drawn directly: N(0, 0.5 px)
# clipped to +-1.5 px
DCN_EDVR_OFFSET_STD, DCN_EDVR_OFFSET_CLIP = 0.5, 1.5
# bf16 + dcn_max_offset 2 EDVR serving against the fp32 exact run on the
# same windows (most of bf16 EDVR computes in fp32, as in JAX; the window
# drops the corners beyond 2 px).  Measured on an H100 with offsets of
# 0.14 px at most: PSNR -5.7e-4 dB, CardiacPSNR -4.9e-4 dB, SSIM +3.8e-6,
# CardiacSSIM +1.1e-5 (seeded data and weights)
TOL_EDVR_BF16_DPSNR, TOL_EDVR_BF16_DSSIM = 1e-2, 5e-4
# one fp32 training step through the DCN kernels against the same step
# through their plain versions on the card, each gradient relative to its
# largest element.  Measured on an H100: 3.25e-4 and 1.08e-3 at most (two
# runs), 1.4e-5 and 2.8e-5 the median, where the kernels against themselves
# differ by 7.2e-7 at most (col2im's atomics).  The forwards differ by ~1e-7
# (phase 19), and Charbonnier's eps of 1e-6 turns that into much more: its
# derivative (out - hr) / sqrt((out - hr)^2 + eps) swings from -1 to 1
# within 1e-3 of the target.  The step is also run through the kernels on
# frames one ulp apart, which shows that amplification; the bound is ~10x
# the largest measured
TOL_EDVR_STEP = 1e-2


def dcn_launches(dcn) -> tuple[int, ...]:
    """(im2col, col2im, col2im_coord, and the same on bf16) since the reset."""
    return (*(dcn.LAUNCHES[k] for k in dcn.KERNELS), *(dcn.BF16_LAUNCHES[k] for k in dcn.KERNELS))


class plain_dcn:
    """Inside the block the DCN's autograd function runs the plain versions
    on CUDA tensors too (the comparison of phase 21)."""

    def __init__(self, dcn):
        self.dcn = dcn

    def __enter__(self):
        d = self.dcn
        self.saved = (d.deform_im2col, d.deform_col2im, d.deform_col2im_coord)
        d.deform_im2col = d.deform_im2col_reference
        d.deform_col2im = d.deform_col2im_reference
        d.deform_col2im_coord = d.deform_col2im_coord_reference

    def __exit__(self, *exc):
        d = self.dcn
        d.deform_im2col, d.deform_col2im, d.deform_col2im_coord = self.saved


def dcn_operands(dcn, shape, dtype, dev, gen, offsets="fractional", R=None):
    """x, offset (fp32), mask, grad_col and the geometry of one L1 DCN call."""
    import torch

    g = dcn.geometry(shape, 3, 3, 1, 1, 1, DCN_DG, R)
    B, C = shape[:2]
    x = torch.randn(shape, device=dev, generator=gen).to(dtype)
    oshape = (B, DCN_DG * 18, g.Ho, g.Wo)
    if offsets == "zero":
        off = torch.zeros(oshape, device=dev)
    elif offsets == "fractional":  # reaches outside the image from the border taps
        off = (torch.rand(oshape, device=dev, generator=gen) * 2 - 1) * 3.5
    elif offsets == "wide":
        off = (torch.rand(oshape, device=dev, generator=gen) * 2 - 1) * DCN_WIDE_OFFSET
    elif offsets == "edvr":
        off = (torch.randn(oshape, device=dev, generator=gen) * DCN_EDVR_OFFSET_STD).clamp(
            -DCN_EDVR_OFFSET_CLIP, DCN_EDVR_OFFSET_CLIP)
    else:  # "beyond": |o| >= R + 1: every corner out of the window
        off = (R + 1 + 2 * torch.rand(oshape, device=dev, generator=gen)) * torch.sign(
            torch.randn(oshape, device=dev, generator=gen))
    mask = torch.rand(B, DCN_DG * 9, g.Ho, g.Wo, device=dev, generator=gen).to(dtype)
    grad_col = torch.randn(B, C * 9, g.Ho * g.Wo, device=dev, generator=gen).to(dtype)
    return x, off, mask, grad_col, g


def dcn_times_line(name, shape_name, shape, dtype, t) -> str:
    first = FIRST_DESIGN_US.get((name, shape_name, str(dtype)))
    line = (f"{name} {dtype} x {tuple(shape)} dg {DCN_DG}: kernel {t['ms'] * 1e3:.2f} us, plain "
            f"{t['plain_ms'] * 1e3:.2f} us ({t['plain_ms'] / t['ms']:.1f}x), bound "
            f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}: {t['bytes']} bytes, {t['ops']} "
            f"operations), {t['bound_ms'] / t['ms']:.0%} of the bound; {t['sets']} operand sets")
    if "ms_gather_only" in t:
        line += (f"; without the transpose (x channels-last) {t['ms_gather_only'] * 1e3:.2f} us "
                 f"({t['bound_ms'] / t['ms_gather_only']:.0%} of the bound)")
    line += "; at offsets " + ", ".join(
        f"{name} {t[f'ms_{name}_offsets'] * 1e3:.2f} us" for name in DCN_TIMED_OFFSETS[1:])
    if first:
        line += (f"; the first design's recorded time {first[0]:.2f}-{first[1]:.2f} us "
                 f"(not measured here; {first[0] / (t['ms'] * 1e3):.1f}x this one's time)")
    return line


def dcn_kernels(dcn, dev, rates, card_line, bf16_peak: float) -> dict:
    """Phase 19: the three DCN kernels against their plain versions at EDVR's
    serving and training L1 shapes, in fp32 and bf16 (zero offsets with a
    unit mask against the dense conv; fractional offsets reaching outside
    the image, wide ones and EDVR-like ones; R = 2 with offsets beyond the
    window: exactly no contribution; the forward and all five gradients
    through the autograd function; col2im_coord bit-equal across two calls),
    then each kernel's time beside its plain version's and its bound, at
    three offset draws, and the whole DCN (im2col + GEMM) beside a dense
    ``F.conv2d`` of the same shapes."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(19)
    f32, b16 = torch.float32, torch.bfloat16
    errors = {k: {} for k in dcn.KERNELS}  # kernel → dtype → max abs error
    results = {"errors": errors, "times": {}}

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()

    for shape_name, shape in DCN_SHAPES.items():
        C = shape[1]
        for dtype, tol in ((f32, TOL_DCN_FP32), (b16, TOL_DCN_BF16)):
            # each kernel against its plain version on the same inputs, at
            # offsets of up to 3.5 px, of up to DCN_WIDE_OFFSET px and
            # EDVR-like ones
            for offsets in ("fractional", "wide", "edvr"):
                x, off, mask, grad_col, g = dcn_operands(dcn, shape, dtype, dev, gen, offsets)
                got = {"deform_im2col": dcn.deform_im2col(x, off, mask, g),
                       "deform_col2im": dcn.deform_col2im(grad_col, off, mask, g),
                       "deform_col2im_coord": dcn.deform_col2im_coord(grad_col, x, off, mask, g)}
                want = {"deform_im2col": dcn.deform_im2col_reference(x, off, mask, g),
                        "deform_col2im": dcn.deform_col2im_reference(grad_col, off, mask, g),
                        "deform_col2im_coord": dcn.deform_col2im_coord_reference(
                            grad_col, x, off, mask, g)}
                for k in dcn.KERNELS:
                    pairs = list(zip(*(v if isinstance(v, tuple) else (v,)
                                       for v in (got[k], want[k]))))
                    err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
                    r = max(rel(a, b) for a, b in pairs)
                    errors[k][str(dtype)] = max(err, errors[k].get(str(dtype), 0.0))
                    log("dcn", f"{k} {dtype} {shape_name} x {tuple(shape)} {offsets} offsets: max "
                               f"abs err {err:.3e}, {r:.3e} of the largest element (tol {tol})")
                    if not r <= tol:
                        raise AssertionError(f"{k} disagrees with its plain version: {r}")
                # no atomics: the same bits from run to run
                again = dcn.deform_col2im_coord(grad_col, x, off, mask, g)
                same = all(torch.equal(a, b) for a, b in zip(again, got["deform_col2im_coord"]))
                log("dcn", f"deform_col2im_coord {dtype} {shape_name} {offsets} offsets: two "
                           f"calls bit-equal {same}")
                if not same:
                    raise AssertionError("deform_col2im_coord differs between two calls")
                del got, want, grad_col, again
            # the autograd function: forward and the five gradients
            w = (torch.randn(C, C, 3, 3, device=dev, generator=gen) / 34).to(dtype)
            b = torch.randn(C, device=dev, generator=gen).to(dtype)
            for case in ("zero", "fractional", "beyond"):
                R = EDVR_TPU_R if case == "beyond" else None
                x, off, mask, _, g = dcn_operands(dcn, shape, dtype, dev, gen, case, R)
                if case == "zero":
                    mask = torch.ones_like(mask)
                kw = dict(padding=1, deformable_groups=DCN_DG, max_offset=R)
                leaves = [t.clone().requires_grad_() for t in (x, off, mask, w, b)]
                out = dcn.deform_conv2d(leaves[0], leaves[1], leaves[3], leaves[2], leaves[4], **kw)
                cot = torch.randn(out.shape, device=dev, generator=gen)
                (out.float() * cot).sum().backward()
                ref = [t.detach().float().clone().requires_grad_() for t in (x, off, mask, w, b)]
                want = dcn.deform_conv2d_reference(ref[0], ref[1], ref[3], ref[2], ref[4], **kw)
                (want * cot).sum().backward()
                rels = {"out": rel(out, want)}
                rels.update({n: rel(a.grad, r.grad) for n, a, r in
                             zip(("x", "offset", "mask", "weight", "bias"), leaves, ref)
                             if r.grad.abs().max() > 0})
                worst = max(rels.values())
                note = ""
                if case == "zero":  # the integer knife edge is the dense conv
                    dense = F.conv2d(x.float(), w.float(), b.float(), padding=1)
                    rels["dense_conv"] = rel(out, dense)
                    worst = max(worst, rels["dense_conv"])
                    note = f"; against the dense conv {rels['dense_conv']:.3e}"
                if case == "beyond":
                    exact_bias = torch.equal(out.detach(), b.view(1, -1, 1, 1).expand_as(out))
                    zero_grads = all(torch.count_nonzero(t.grad) == 0 for t in leaves[:4])
                    note = (f"; beyond the window: output exactly the bias {exact_bias}, "
                            f"x/offset/mask/weight gradients exactly 0 {zero_grads}")
                    if not (exact_bias and zero_grads):
                        raise AssertionError("out-of-window offsets contributed")
                log("dcn", f"autograd function {dtype} {shape_name} {case} offsets: relative "
                           f"errors { {k: f'{v:.2e}' for k, v in rels.items()} } (tol {tol}){note}")
                if not worst <= tol:
                    raise AssertionError(f"the DCN autograd function disagrees: {case} {rels}")
                del leaves, ref, out, want
            # times
            times = time_dcn(dcn, shape, dtype, dev, gen, rates, w, b, bf16_peak)
            results["times"][f"{shape_name} {dtype}"] = times
            for k in dcn.KERNELS:
                print(f"times {dcn_times_line(k, shape_name, shape, dtype, times[k])}", flush=True)
            t = times["dcn"]
            print(f"times deform_conv2d (im2col + GEMM) {dtype} {shape_name} x {tuple(shape)}: "
                  f"{t['ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}); "
                  f"dense F.conv2d of the same shapes {t['dense_conv_ms'] * 1e3:.2f} us "
                  f"({t['ms'] / t['dense_conv_ms']:.1f}x)", flush=True)
    print(json.dumps({"dcn_kernels": results, "card": card_line}), flush=True)
    return results


# the offsets each kernel is timed at: the first also times the plain
# version, the whole DCN and the kernels without their transpose
DCN_TIMED_OFFSETS = ("fractional", "zero", "edvr")


def time_dcn(dcn, shape, dtype, dev, gen, rates, w, b, bf16_peak: float) -> dict:
    """Per launch, CUDA graphs over operand sets larger than L2: each kernel
    and its plain version, with the bound (at ±3.5 px offsets), and each
    kernel at zero and EDVR-like offsets; the whole DCN forward and a dense
    conv of the same shapes."""
    import torch
    import torch.nn.functional as F

    el = torch.empty((), dtype=dtype).element_size()
    x, off, mask, grad_col, g = dcn_operands(dcn, shape, dtype, dev, gen)
    n_x, n_off, n_mask, n_col = x.numel(), off.numel(), mask.numel(), grad_col.numel()
    nbytes = {"deform_im2col": el * (n_x + n_mask + n_col) + 4 * n_off,
              "deform_col2im": el * (n_col + n_mask) + 4 * (n_off + n_x),
              "deform_col2im_coord": el * (n_col + n_x + n_mask) + 4 * (n_off + n_off + n_mask)}
    sets = [dcn_operands(dcn, shape, dtype, dev, gen)[:4]
            for _ in range(_n_sets(el * (n_x + n_mask + 2 * n_col) + 4 * n_off))]
    calls = {"deform_im2col": (lambda a: dcn.deform_im2col(a[0], a[1], a[2], g),
                               lambda a: dcn.deform_im2col_reference(a[0], a[1], a[2], g)),
             "deform_col2im": (lambda a: dcn.deform_col2im(a[3], a[1], a[2], g),
                               lambda a: dcn.deform_col2im_reference(a[3], a[1], a[2], g)),
             "deform_col2im_coord": (
                 lambda a: dcn.deform_col2im_coord(a[3], a[0], a[1], a[2], g),
                 lambda a: dcn.deform_col2im_coord_reference(a[3], a[0], a[1], a[2], g))}
    out = {}
    for k, (kernel, plain) in calls.items():
        t = {"bytes": nbytes[k], "ops": DCN_OPS[k] * n_col, "sets": len(sets)}
        t["ms"] = time_graph_ms([lambda a=a: kernel(a) for a in _cycled(sets)])
        t["plain_ms"] = time_graph_ms([lambda a=a: plain(a) for a in _cycled(sets, 20)])
        t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["ops"], *rates)
        t["ms_fractional_offsets"] = t["ms"]
        out[k] = t
    # the gathers alone: on a channels-last x the entry points of im2col and
    # col2im_coord skip the transpose
    cl = [(a[0].contiguous(memory_format=torch.channels_last), *a[1:]) for a in sets]
    for k in ("deform_im2col", "deform_col2im_coord"):
        out[k]["ms_gather_only"] = time_graph_ms(
            [lambda a=a, f=calls[k][0]: f(a) for a in _cycled(cl)])
    del cl
    # the kernels at the other offsets, on operand sets of the same size
    for offsets in DCN_TIMED_OFFSETS[1:]:
        other = [dcn_operands(dcn, shape, dtype, dev, gen, offsets)[:4] for _ in sets]
        for k, (kernel, _) in calls.items():
            out[k][f"ms_{offsets}_offsets"] = time_graph_ms(
                [lambda a=a: kernel(a) for a in _cycled(other)])
        del other
    # the whole forward (im2col + the GEMM in the promoted dtype) and the
    # dense conv it would be at zero offsets
    Cout = w.shape[0]
    gemm_ops = 2 * Cout * n_col
    t = {"ms": time_graph_ms([lambda a=a: dcn.deform_conv2d(a[0], a[1], w, a[2], b, padding=1,
                                                              deformable_groups=DCN_DG)
                              for a in _cycled(sets)])}
    t["dense_conv_ms"] = time_graph_ms([lambda a=a: F.conv2d(a[0], w, b, padding=1)
                                        for a in _cycled(sets)])
    dcn_bytes = el * (n_x + n_mask + w.numel() + Cout + g.B * Cout * g.Ho * g.Wo) + 4 * n_off
    # the GEMM at the tensor cores' rate in bf16, the sampling at the fp32 rate
    gemm_peak = bf16_peak if dtype == torch.bfloat16 else rates[1]
    bytes_ms = dcn_bytes / rates[0] * 1e3
    ops_ms = (gemm_ops / gemm_peak + DCN_OPS["deform_im2col"] * n_col / rates[1]) * 1e3
    t["bound_ms"], t["bound_by"] = max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                                            else "operations")
    out["dcn"] = t
    del sets
    return out


def seeded_edvr(kwargs: dict):
    """EDVR from seed 0, its offset convs drawn off their zero init so that
    every DCN samples at fractional offsets."""
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        EDVRNet,
    )

    net = EDVRNet(**kwargs, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "conv_offset_mask" in name:
                p.normal_(0.0, EDVR_OFFSET_STD, generator=gen)
    return net


def edvr_serving(port_main, Cfg, lstm_gates, dcn, tree: dict, tmp: Path, dev, rates,
                 card_line) -> dict:
    """Phase 20: EDVR serves the tree's test windows of 5 frames in fp32 and
    with the ``_tpu`` config's knobs (bf16, ``dcn_max_offset: 2``)."""
    import copy

    import numpy as np
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        telemetry,
    )

    ckpt = tmp / "EDVRNet.pth"
    torch.save({"net": seeded_edvr(EDVR_NET).state_dict()}, ckpt)
    runs = [("EDVRNet", EDVR_NET, {}),
            ("EDVRNet_tpu", {**EDVR_NET, "dcn_max_offset": EDVR_TPU_R},
             {"compute_dtype": "bfloat16"})]
    results, windows = {}, CYCLE * SLICES
    for key, kwargs, pred_kwargs in runs:
        cfg = Cfg(misr_eval_config(tree, "EDVRNet", kwargs, ckpt, tmp / f"test_{key}",
                                   num_frames=EDVR_T, loss=EDVR_LOSS, **pred_kwargs))
        held = torch.cuda.memory_allocated(dev)
        reset_launches(lstm_gates)
        dcn.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pred = port_main.test_from_config(cfg)
        wall = time.perf_counter() - t0
        counts = dcn_launches(dcn)
        gates = launches(lstm_gates)
        peak = torch.cuda.max_memory_allocated(dev)
        bf16 = "compute_dtype" in pred_kwargs
        want = (DCN_PER_FORWARD * windows, 0, 0,
                DCN_BF16_PER_FORWARD * windows if bf16 else 0, 0, 0)
        log("edvr eval", f"{key}: DCN launches (im2col, col2im, col2im_coord; bf16 of each) "
                         f"{counts}, expected {want} ({DCN_PER_FORWARD} im2col a window x "
                         f"{windows} windows); gate launches {gates}")
        if counts != want or gates != (0, 0, 0, 0):
            raise AssertionError(f"{key} serving launched {counts} DCN and {gates} gate kernels")
        frames = pred.throughput["frames"]
        if frames != windows or not all(math.isfinite(v) for v in pred.log.values()):
            raise AssertionError(f"{key} serving scored {frames} windows: {pred.log}")
        warm_ms = float(np.median(pred.item_seconds[1:])) * 1e3
        n_params = sum(p.numel() for p in pred.net.parameters())
        log("edvr eval", f"{key} {kwargs} {pred_kwargs}: {n_params:,} params; Test log {pred.log}")
        if "dcn_max_offset" in kwargs:
            sites = sorted(f"pcd_align/{lvl}_dcnpack/dcn_offset_window"
                           for lvl in ("L3", "L2", "L1", "cas"))
            if sorted(pred.telemetry_summary) != sites:
                raise AssertionError(f"{key}: telemetry sites {sorted(pred.telemetry_summary)}")
            log("edvr eval", f"{key}: Windowed-op telemetry: "
                             f"{telemetry.format_summary(pred.telemetry_summary)}")
        item = pred.test_dataloader.dataset[0]
        lr = torch.from_numpy(item["lr_imgs"][None])
        gap = None
        if not bf16:  # one window on the card against the same weights on the CPU
            with torch.inference_mode():
                on_card = pred._forward(lr.to(dev)).cpu()
                cpu_pred = copy.copy(pred)
                cpu_pred.net = copy.deepcopy(pred.net).cpu()
                on_cpu = cpu_pred._forward(lr)
            gap = ((on_card - on_cpu).abs().max() / on_cpu.abs().max()).item()
            if tuple(on_card.shape) != (1, HR, HR, 1) or not gap <= TOL_SISR_CARD_CPU:
                raise AssertionError(f"{key}: card vs CPU {gap:.3e} of the largest value, "
                                     f"shape {tuple(on_card.shape)}")
            del cpu_pred
        batch = next(iter(pred.test_dataloader))
        patient = pred._item_meta(int(batch["index"][0]))[0]
        masks = pred._metric_masks(patient, (HR, HR))
        busy = device_busy(lambda: pred._step(batch, masks))
        flops = forward_flops(pred.net, lr.to(dev))
        nbytes = 4 * (lr.numel() + HR * HR + n_params)
        bound, bound_by = bound_ms(nbytes, flops, *rates)
        log("edvr eval", f"{key}: frames/s {pred.throughput['frames_per_sec']:.2f} over {frames} "
                         f"windows; warm {warm_ms:.3f} ms a window (median of items 2-{frames}); "
                         f"test_from_config wall {wall:.2f} s; peak device memory "
                         f"{peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} above the "
                         f"{held / 2**30:.3f} held before); {flops:.4g} operations a window "
                         f"(DCN GEMMs included), bound {bound:.3f} ms ({bound_by}), "
                         f"{bound / warm_ms:.1%} of it; card vs CPU "
                         f"{'not run (bf16)' if gap is None else f'{gap:.3e}'} of the largest "
                         f"value (tol {TOL_SISR_CARD_CPU})")
        dcn_share = dcn.trace_share(busy[4])
        dcn_ms = sum(t for t, _ in dcn_share.values())
        log("edvr eval", f"{key}: predictor step on a warm window: wall {busy[0]:.3f} ms, "
                         f"{busy[2]} kernels {busy[1]:.3f} ms, device busy {busy[1] / busy[0]:.1%}; "
                         f"the bound is {bound / busy[1]:.1%} of the kernel time; the DCN's kernels "
                         f"{dcn_ms:.3f} ms ({dcn_ms / busy[1]:.1%} of the device time): "
                         f"{ {k: f'{n} launches, {t:.4f} ms' for k, (t, n) in dcn_share.items()} }")
        results[key] = {"frames_per_sec": pred.throughput["frames_per_sec"], "warm_ms": warm_ms,
                        "item_ms": [t * 1e3 for t in pred.item_seconds], "peak_gib": peak / 2**30,
                        "held_gib": held / 2**30, "flops_per_window": flops, "bound_ms": bound,
                        "bound_by": bound_by, "card_vs_cpu_rel": gap, "log": pred.log,
                        "wall_s": wall, "step_wall_ms": busy[0], "step_kernel_ms": busy[1],
                        "step_kernels": busy[2], "telemetry": pred.telemetry_summary,
                        "dcn_launches": counts, "dcn_step_ms": dcn_ms,
                        "dcn_share_of_device": dcn_ms / busy[1],
                        "dcn_by_kernel": {k: {"ms": t, "launches": n}
                                          for k, (t, n) in dcn_share.items()}}
        del pred
    fp32, b16 = results["EDVRNet"]["log"], results["EDVRNet_tpu"]["log"]
    gaps = {k: b16[k] - fp32[k] for k in ("PSNR", "SSIM", "CardiacPSNR", "CardiacSSIM")}
    log("edvr eval", f"EDVR bf16 + dcn_max_offset {EDVR_TPU_R} - fp32: {gaps} (bound |dPSNR| < "
                     f"{TOL_EDVR_BF16_DPSNR}, |dSSIM| < {TOL_EDVR_BF16_DSSIM})")
    if not all(abs(v) < (TOL_EDVR_BF16_DPSNR if "PSNR" in k else TOL_EDVR_BF16_DSSIM)
               for k, v in gaps.items()):
        raise AssertionError(f"bf16 EDVR serving left the bound of the fp32 run: {gaps}")
    results["edvr_bf16_minus_fp32"] = gaps
    print(json.dumps({"edvr_serving": results, "card": card_line}), flush=True)
    return results


def edvr_train_config(tree: dict, key: str, saved_dir: Path) -> dict:
    """configs/train/edvr_net/exp1_x4[_tpu].yaml with paths into the
    synthetic tree's windows of 5 frames, on cuda:0, for EPOCHS epochs with a
    checkpoint every epoch, with its ``logger:`` section."""
    batch, knobs = EDVR_TRAIN[key]
    net = {**EDVR_NET, **({"dcn_max_offset": EDVR_TPU_R} if key.endswith("_tpu") else {})}
    return {
        "main": {"random_seed": "vsr", "saved_dir": str(saved_dir), "loaded_path": None},
        "dataset": {
            "name": "AcdcMISRDataset",
            "kwargs": {
                "data_dir": str(tree["videos"]), "downscale_factor": SCALE,
                "transforms": [
                    {"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
                    {"name": "ToTensor"},
                ],
                "augments": [
                    {"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"},
                    {"name": "RandomCropPatch", "kwargs": {"size": [PATCH, PATCH], "ratio": SCALE}},
                ],
                "num_frames": EDVR_T,
            },
        },
        "dataloader": {"name": "Dataloader",
                       "kwargs": {"train_batch_size": batch, "valid_batch_size": 1,
                                  "shuffle": True, "num_workers": 8}},
        "net": {"name": "EDVRNet", "kwargs": net},
        "losses": [EDVR_LOSS],
        "metrics": [{"name": "PSNR"}, {"name": "SSIM"}],
        "optimizer": {"name": "Adam", "kwargs": {"lr": 4e-4, "weight_decay": 0}},
        "logger": {"name": "AcdcMISRLogger", "kwargs": {"dummy_input": [batch, 1, PATCH, PATCH]}},
        "monitor": {"name": "Monitor",
                    "kwargs": {"mode": "min", "target": "Loss", "saved_freq": 1, "early_stop": 0}},
        "trainer": {"name": "AcdcMISRTrainer",
                    "kwargs": {"device": "cuda:0", "num_epochs": EPOCHS, **knobs}},
    }


def edvr_training(port_main, Cfg, lstm_gates, dcn, tree: dict, tmp: Path, dev, rates, card_line,
                  bf16_peak: float) -> dict:
    """Phase 21: EDVR trains on the tree's windows, fp32 and with the
    ``_tpu`` config's knobs (bf16, 2 microbatches, ``dcn_max_offset: 2``);
    one fp32 step through the DCN kernels against the same step through
    their plain versions."""
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import losses
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
        EDVRNet,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
        load_checkpoint,
    )

    results = {}
    items = 2 * 2 * CYCLE  # train windows an epoch
    valid_windows = CYCLE * VALID_CLIPS
    for key, (batch_size, knobs) in EDVR_TRAIN.items():
        micro = knobs.get("grad_accum_steps", 1)
        bf16 = knobs.get("compute_dtype") == "bfloat16"
        saved = tmp / f"train_{key}"
        held = torch.cuda.memory_allocated(dev)
        reset_launches(lstm_gates)
        dcn.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer = port_main.train_from_config(Cfg(edvr_train_config(tree, key, saved)))
        wall = time.perf_counter() - t0
        counts, gates = dcn_launches(dcn), launches(lstm_gates)
        peak = torch.cuda.max_memory_allocated(dev)
        steps = math.ceil(items / batch_size) * EPOCHS
        fwd = DCN_PER_FORWARD * (steps * micro + valid_windows * EPOCHS)
        bwd = DCN_PER_FORWARD * steps * micro
        per = DCN_BF16_PER_FORWARD if bf16 else 0
        want = (fwd, bwd, bwd, per * (steps * micro + valid_windows * EPOCHS), per * steps * micro,
                per * steps * micro)
        log("edvr train", f"{key}: DCN launches (im2col, col2im, col2im_coord; bf16 of each) "
                          f"{counts}, expected {want} ({steps} steps x {micro} microbatches x "
                          f"{DCN_PER_FORWARD} a forward and a backward, + {EPOCHS} x "
                          f"{valid_windows} valid windows x {DCN_PER_FORWARD}); gate launches {gates}")
        if counts != want or gates != (0, 0, 0, 0):
            raise AssertionError(f"{key} training launched {counts} DCN and {gates} gate kernels")
        history = trainer.history["train"] + trainer.history["valid"]
        if len(trainer.history["train"]) != EPOCHS or not all(
                math.isfinite(v) for h in history for v in h.values()):
            raise AssertionError(f"{key} training logs incomplete or non-finite: {trainer.history}")
        if not list((saved / "log").rglob("events.out.tfevents.*")):
            raise AssertionError(f"{key}: the logger wrote no event file")
        for epoch, (t_log, v_log) in enumerate(zip(trainer.history["train"],
                                                   trainer.history["valid"]), 1):
            log("edvr train", f"{key} epoch {epoch}: Train log {t_log}; Valid log {v_log}")
        if bf16:
            log("edvr train", f"{key}: valid-epoch telemetry {trainer.telemetry_history}")
        best = load_checkpoint(saved / "checkpoints" / "model_best.pth")
        EDVRNet(**edvr_train_config(tree, key, saved)["net"]["kwargs"]).load_state_dict(
            best["net"], strict=True)
        tp = trainer.throughput
        step_ms = 1e3 / tp["train_steps_per_sec"]
        x = torch.zeros(batch_size, EDVR_T, PATCH, PATCH, 1, device=dev)
        flops = 3 * forward_flops(trainer.net, x)
        n_params = sum(p.numel() for p in trainer.net.parameters())
        nbytes = 4 * (x.numel() + batch_size * (PATCH * SCALE) ** 2 + 6 * n_params)
        bound, bound_by = bound_ms(nbytes, flops, rates[0], bf16_peak if bf16 else rates[1])
        print(f"edvr training {key}: {tp['train_steps_per_sec']:.4f} steps/s, "
              f"{tp['frames_per_sec']:.2f} LR frames/s, {step_ms:.2f} ms a step (epoch {EPOCHS}: "
              f"{steps // EPOCHS} warm steps of {batch_size} windows x {EDVR_T} frames, the last of "
              f"{items - (steps // EPOCHS - 1) * batch_size}, and the valid epoch not in it), peak "
              f"device memory {peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} above the "
              f"{held / 2**30:.3f} held before), train_from_config wall {wall:.1f} s; "
              f"{flops:.4g} operations a step, bound {bound:.3f} ms ({bound_by}), "
              f"{bound / step_ms:.1%} of it; model_best.pth (epoch {best['epoch']}) reloaded",
              flush=True)
        results[key] = {"steps_per_sec": tp["train_steps_per_sec"],
                        "frames_per_sec": tp["frames_per_sec"], "step_ms": step_ms,
                        "peak_gib": peak / 2**30, "held_gib": held / 2**30,
                        "flops_per_step": flops, "bound_ms": bound, "bound_by": bound_by,
                        "wall_s": wall, "best_epoch": best["epoch"], "batch": batch_size,
                        "bound_peak": "bf16" if bf16 else "fp32", "dcn_launches": counts}
        if not bf16:  # one step through the kernels against the plain versions
            net = trainer.net.train()
            batch = next(iter(trainer.train_dataloader))
            lr_b = torch.as_tensor(batch["lr_imgs"]).to(dev)
            hr_b = torch.as_tensor(batch["hr_img"]).to(dev)
            loss_fn = losses.CharbonnierLoss(epsilon=1e-6)

            def step(lr_in=lr_b):
                net.zero_grad(set_to_none=True)
                loss = loss_fn(net(lr_in), hr_b)
                loss.backward()
                return loss.item(), {n: p.grad.clone() for n, p in net.named_parameters()}

            def train_pass():
                net.zero_grad(set_to_none=True)
                loss_fn(net(lr_b), hr_b).backward()

            # the DCN's share of a forward and backward's device time
            busy = device_busy(train_pass)
            dcn_share = dcn.trace_share(busy[4])
            dcn_ms = sum(t for t, _ in dcn_share.values())
            log("edvr train", f"fp32 forward + backward on batch {tuple(lr_b.shape)}: wall "
                              f"{busy[0]:.2f} ms, {busy[2]} kernels {busy[1]:.2f} ms; the DCN's "
                              f"kernels {dcn_ms:.3f} ms ({dcn_ms / busy[1]:.1%} of the device "
                              f"time): " + "; ".join(
                                  f"{k} {n} launches, {t:.3f} ms, {t / n * 1e3:.1f} us a launch"
                                  for k, (t, n) in dcn_share.items()))
            results[key].update({"pass_kernel_ms": busy[1], "dcn_pass_ms": dcn_ms,
                                 "dcn_share_of_device": dcn_ms / busy[1],
                                 "dcn_by_kernel": {k: {"ms": t, "launches": n}
                                                   for k, (t, n) in dcn_share.items()}})
            dcn.reset_launches()
            loss_k, grads_k = step()
            step_counts = dcn_launches(dcn)
            with plain_dcn(dcn):
                loss_p, grads_p = step()
            _, grads_k2 = step()  # the kernels again: the run-to-run noise
            noise = rel_diffs(grads_k2, grads_k)
            # the kernels on frames one ulp apart: the loss's amplification
            _, grads_ulp = step(torch.nextafter(lr_b, torch.full_like(lr_b, math.inf)))
            ulp = rel_diffs(grads_ulp, grads_k)
            grad_rel = rel_diffs(grads_k, grads_p)
            worst = max(grad_rel, key=grad_rel.get)
            loss_rel = abs(loss_k - loss_p) / abs(loss_p)
            log("edvr train", f"fp32 step, DCN kernels vs plain versions on batch "
                              f"{tuple(lr_b.shape)}: kernel launches {step_counts[:3]}; loss "
                              f"{loss_k:.7f} vs {loss_p:.7f} (rel {loss_rel:.2e}); {len(grads_p)} "
                              f"gradients, largest relative difference {grad_rel[worst]:.2e} at "
                              f"{worst} (tol {TOL_EDVR_STEP}); median "
                              f"{sorted(grad_rel.values())[len(grad_rel) // 2]:.2e}; the kernels "
                              f"against themselves: largest {max(noise.values()):.2e}, median "
                              f"{sorted(noise.values())[len(noise) // 2]:.2e}; on frames one ulp "
                              f"apart: largest {max(ulp.values()):.2e}, median "
                              f"{sorted(ulp.values())[len(ulp) // 2]:.2e}")
            if (step_counts[:3] != (DCN_PER_FORWARD,) * 3 or loss_rel > TOL_EDVR_STEP
                    or grad_rel[worst] > TOL_EDVR_STEP):
                raise AssertionError("an EDVR step through the DCN kernels disagrees with the "
                                     "plain versions")
            results[key]["kernels_vs_plain_loss_rel"] = loss_rel
            results[key]["kernels_vs_plain_grad_rel"] = grad_rel[worst]
            results[key]["kernels_vs_kernels_grad_rel"] = max(noise.values())
            results[key]["kernels_one_ulp_apart_grad_rel"] = max(ulp.values())
            net.zero_grad(set_to_none=True)
            del grads_k, grads_p, grads_k2, grads_ulp
        del trainer
    print(json.dumps({"edvr_training": results, "card": card_line}), flush=True)
    return results


# ------------------------------------------------------ 22-25 serving daemon
SERVE_SPLITS = {"test": (2, SLICES)}  # 2 patients x 2 slices, one (H, W, 1, T) file a slice
SERVE_CLIPS = 2 * SLICES + SLICES  # + one file stacking patient001's slices as (H, W, 2, T)
TOL_SERVE_GRAY = 1  # a served frame against the same clip's direct forward, gray levels
PROFILE_NET = {**NET_KWARGS, "num_features": [16], "num_stages": 1}  # phase 25's cheap net


class _InfoRecords(logging.Handler):
    """Keeps the INFO (and higher) records of one logger while attached."""

    def __init__(self, name: str):
        super().__init__(logging.INFO)
        self.records, self.logger = [], logging.getLogger(name)

    def __enter__(self):
        self.level_before = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level_before)

    def emit(self, record):
        self.records.append(record.getMessage())


def native_reader_check(tree: dict) -> dict:
    """Phase 4's data path: the native NIfTI reader is built, enabled, and
    gives the Python reader's arrays on every file of the tree's test
    split (both trees)."""
    import numpy as np

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import (
        native_io,
        nifti,
    )

    if not native_io.enabled():
        raise AssertionError("the native NIfTI reader is not built or not enabled")
    paths = sorted((Path(tree["videos"]) / "test").rglob("*.nii.gz")) + sorted(
        (Path(tree["imgs"]) / "test").rglob("*.nii.gz"))[:8]
    t0 = time.perf_counter()
    native = native_io.load_volumes(paths)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = [np.asarray(nifti.load(q).get_data(), np.float32) for q in paths]
    t_python = time.perf_counter() - t0
    for q, a, b in zip(paths, native, python):
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"native reader disagrees with the Python reader on {q}")
    log("main", f"native NIfTI reader {native_io.library_path().name}: {len(paths)} files equal "
                f"to the Python reader's ({t_native * 1e3:.1f} ms threaded vs "
                f"{t_python * 1e3:.1f} ms)")
    return {"files": len(paths), "native_ms": t_native * 1e3, "python_ms": t_python * 1e3}


class count_native_reads:
    """Counts the datasets' reads through the native reader while open."""

    def __enter__(self):
        from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import (
            native_io,
        )

        self.module, self.original, self.count = native_io, native_io.load_volume, 0

        def counted(path):
            self.count += 1
            return self.original(path)

        native_io.load_volume = counted
        return self

    def __exit__(self, *exc):
        self.module.load_volume = self.original


def _serve(serve, argv) -> tuple[int, float, list]:
    """The daemon once, as its CLI runs it (without its logging setup) →
    (volumes served, seconds from the first volume's load to the last
    write, which leaves out the server's start, its log lines)."""
    import re

    with _InfoRecords("evsr.serve") as rec:
        t0 = time.perf_counter()
        n = serve.serve(serve._parse_args(argv))
        wall = time.perf_counter() - t0
    busy = [float(m.group(1)) for m in (re.search(r"in ([0-9.]+)s busy", x) for x in rec.records)
            if m]
    return n, busy[0] if busy else wall, rec.records


def _served_slices(nifti, path: Path):
    """(S, T, H, W) uint8 of a served (H, W, S, T) float32 volume."""
    import numpy as np

    sr = nifti.load(path).get_data()
    if sr.dtype != np.float32 or not np.array_equal(sr, np.round(sr)):
        raise AssertionError(f"{path}: served values are not float32 integers")
    return np.transpose(sr, (2, 3, 0, 1)).astype(np.uint8)


def serve_refine(lstm_gates, tmp: Path, dev, net, card_line) -> dict:
    """Phase 22: the daemon serves RefineNet x4 at full width on a fresh LR
    tree; each served slice against the same clip's direct forward."""
    import pickle
    import re

    import numpy as np
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import (
        common,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (
        serve,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.synthetic_tree import (
        write_acdc_tree,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import (
        nifti,
    )

    tree = write_acdc_tree(tmp / "serve_tree", SERVE_SPLITS, cycle=CYCLE, hr=HR, scale=SCALE, seed=2)
    lr_dir = Path(tree["videos"]) / "test" / "LR" / f"X{SCALE}"
    stack = [nifti.load(lr_dir / "patient001" / f"patient001_2d+1d_sequence{s:0>2d}.nii.gz").get_data()
             for s in range(1, SLICES + 1)]
    nifti.save(np.concatenate(stack, axis=2), lr_dir / "stacked" / "patient001_2d+1d_stack.nii.gz")
    with open(tree["pos_code"], "rb") as f:
        codes = pickle.load(f)
    pos_pkl = tmp / "serve_pos_code.pkl"  # patient001's code; patient002's is generated
    with open(pos_pkl, "wb") as f:
        pickle.dump({"patient001": codes["patient001"]}, f)
    cfg = tmp / "serve_refine.json"  # the YAML loader reads JSON, a YAML subset
    cfg.write_text(json.dumps({"net": {"name": "RefineNet", "kwargs": NET_KWARGS}}))
    ckpt = tmp / "model.pth"
    out = tmp / "served_refine"
    argv = [str(cfg), "--in", str(lr_dir), "--out", str(out), "--ckpt", str(ckpt),
            "--pos-code", str(pos_pkl), "--device", str(dev)]

    reset_launches(lstm_gates)
    n, wall, lines = _serve(serve, argv)
    counts = launches(lstm_gates)
    want = (LAUNCHES_PER_CLIP * SERVE_CLIPS, 0, 0, 0)
    log("serve", f"RefineNet x4: served {n} volumes ({SERVE_CLIPS} clips of {CYCLE} frames, LR "
                 f"{HR // SCALE}x{HR // SCALE}) in {wall:.3f} s; gate launches (forward, backward, "
                 f"bf16 forward, bf16 backward) {counts}, expected {want} ({LAUNCHES_PER_CLIP} a clip)")
    if n != 2 * SLICES + 1 or counts != want:
        raise AssertionError(f"serving RefineNet: {n} volumes, launches {counts}")
    generated = [m for m in lines if "generating" in m]
    if len(generated) != SLICES or not all("patient002" in m for m in generated):
        raise AssertionError(f"expected patient002's code generated per slice: {generated}")

    # each served slice against the same clip through the net on the card
    mean, std = serve._parse_stats("acdc")
    worst, equal, total = 0, 0, 0
    for src in sorted(lr_dir.rglob("*.nii.gz")):
        vol = np.asarray(nifti.load(src).get_data(), np.float32)
        served = _served_slices(nifti, out / src.relative_to(lr_dir))
        if served.shape != (vol.shape[2], CYCLE, HR, HR):
            raise AssertionError(f"{src.name}: served shape {served.shape}")
        patient = src.name.split("_")[0]
        for s in range(vol.shape[2]):
            raw = vol[:, :, s:s + 1, :]
            core = (np.transpose(raw, (3, 0, 1, 2)) - mean) / std
            clip = np.concatenate([core[-U:], core, core[:U]])[None].astype(np.float32)
            code = (np.asarray(codes[patient], np.float32) if patient == "patient001"
                    else serve.generate_phase_code(raw))
            pos = np.concatenate([code[-U:], code, code[:U]])[None, :, None].astype(np.float32)
            with torch.inference_mode():
                direct = common.denorm_uint8(
                    net(torch.from_numpy(clip).to(dev), torch.from_numpy(pos).to(dev))[-1],
                    mean, std).to(torch.uint8).cpu().numpy()[0, ..., 0]
            diff = np.abs(direct.astype(np.int16) - served[s])
            worst = max(worst, int(diff.max()))
            equal += int((diff == 0).sum())
            total += diff.size
    log("serve", f"served slices vs the direct forward on the card: max {worst} gray levels "
                 f"(tol {TOL_SERVE_GRAY}), {equal / total:.6%} of voxels equal")
    if worst > TOL_SERVE_GRAY:
        raise AssertionError(f"a served slice is {worst} gray levels off the direct forward")

    again, _, _ = _serve(serve, argv)
    log("serve", f"second run: served {again} volumes (expected 0)")
    if again != 0:
        raise AssertionError(f"the second run served {again} volumes")

    # timed runs into fresh directories: fp32, then --dtype bfloat16
    frames = CYCLE * SERVE_CLIPS
    times = {}
    for key, extra in (("fp32", []), ("bf16", ["--dtype", "bfloat16"])):
        reset_launches(lstm_gates)
        argv_t = [*argv[:4], str(tmp / f"served_refine_{key}"), *argv[5:], *extra]
        n_t, wall_t, lines_t = _serve(serve, argv_t)
        counts_t = launches(lstm_gates)
        want_t = (want if key == "fp32" else
                  (LAUNCHES_PER_CLIP * SERVE_CLIPS, 0, LAUNCHES_PER_CLIP * SERVE_CLIPS, 0))
        if n_t != 2 * SLICES + 1 or counts_t != want_t:
            raise AssertionError(f"timed {key} serving: {n_t} volumes, launches {counts_t}")
        per_file = [float(m.group(1)) * 1e3 for m in
                    (re.search(r"frames in ([0-9.]+)s", x) for x in lines_t) if m]
        times[key] = {"wall_s": wall_t, "ms_per_volume": wall_t * 1e3 / n_t,
                      "frames_per_sec": frames / wall_t, "volume_latency_ms": per_file,
                      "launches": counts_t}
        log("serve", f"RefineNet x4 {key}: {n_t} volumes ({frames} frames) in {wall_t:.3f} s, "
                     f"{wall_t * 1e3 / n_t:.1f} ms a volume, {frames / wall_t:.2f} frames/s "
                     f"(server start excluded); launch-to-write latency a volume "
                     f"{', '.join(f'{x:.0f}' for x in per_file)} ms; gate launches {counts_t}")
    bf16_gap = 0
    for src in sorted(lr_dir.rglob("*.nii.gz")):
        rel = src.relative_to(lr_dir)
        a = _served_slices(nifti, tmp / "served_refine_fp32" / rel).astype(np.int16)
        b = _served_slices(nifti, tmp / "served_refine_bf16" / rel).astype(np.int16)
        bf16_gap = max(bf16_gap, int(np.abs(a - b).max()))
    log("serve", f"bf16 against fp32 serving: max {bf16_gap} gray levels")
    result = {"volumes": n, "clips": SERVE_CLIPS, "launches": counts[0], "max_gray_vs_direct": worst,
              "equal_share": equal / total, "bf16_launches": times["bf16"]["launches"][2],
              "bf16_max_gray_vs_fp32": bf16_gap, "times": times, "card": card_line}
    print(json.dumps({"serve_refine": result}), flush=True)
    return result


def serve_edvr(dcn, tree: dict, tmp: Path, dev, card_line) -> dict:
    """Phase 23: the daemon serves EDVR x4 at full width in the window
    workload: one slice's 30 windows of 5 frames as one batched forward."""
    import numpy as np
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import (
        common,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (
        serve,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import (
        nifti,
    )

    net = seeded_edvr(EDVR_NET)
    ckpt = tmp / "EDVRNet_serve.pth"
    torch.save({"net": net.state_dict()}, ckpt)
    net.to(dev).eval()
    cfg = tmp / "serve_edvr.json"
    cfg.write_text(json.dumps({"net": {"name": "EDVRNet", "kwargs": EDVR_NET}}))
    lr_dir = Path(tree["videos"]) / "test" / "LR" / f"X{SCALE}"
    name = "patient001_2d+1d_sequence01.nii.gz"
    out = tmp / "served_edvr"
    argv = [str(cfg), "--in", str(lr_dir), "--out", str(out), "--ckpt", str(ckpt),
            "--glob", f"**/{name}", "--device", str(dev)]
    dcn.reset_launches()
    n, wall, lines = _serve(serve, argv)
    counts = dcn_launches(dcn)
    want = (DCN_PER_FORWARD, 0, 0, 0, 0, 0)
    log("serve", f"EDVR x4 window workload: served {n} volume ({CYCLE} windows of {EDVR_T} frames "
                 f"in one forward) in {wall:.3f} s, {CYCLE / wall:.2f} frames/s (server start "
                 f"included); DCN launches {counts}, expected {want}")
    if n != 1 or counts != want:
        raise AssertionError(f"serving EDVR: {n} volumes, DCN launches {counts}")
    mean, std = serve._parse_stats("acdc")
    vol = np.asarray(nifti.load(lr_dir / "patient001" / name).get_data(), np.float32)
    core = (np.transpose(vol[:, :, :1, :], (3, 0, 1, 2)) - mean) / std
    half = (EDVR_T - 1) // 2
    windows = np.stack([core[np.arange(t - half, t + EDVR_T - half) % CYCLE] for t in range(CYCLE)])
    with torch.inference_mode():
        direct = common.denorm_uint8(net(torch.from_numpy(windows.astype(np.float32)).to(dev)),
                                     mean, std).to(torch.uint8).cpu().numpy()[..., 0]
    served = _served_slices(nifti, out / "patient001" / name)[0]
    diff = np.abs(direct.astype(np.int16) - served)
    log("serve", f"EDVR served windows vs the direct forward on the card: max {int(diff.max())} gray "
                 f"levels (tol {TOL_SERVE_GRAY}), {(diff == 0).mean():.6%} of voxels equal")
    if served.shape != (CYCLE, HR, HR) or diff.max() > TOL_SERVE_GRAY:
        raise AssertionError(f"EDVR serving: shape {served.shape}, max gray diff {diff.max()}")
    # timed: the same volume into a fresh directory
    argv_t = [*argv[:4], str(tmp / "served_edvr_timed"), *argv[5:]]
    n_t, wall_t, _ = _serve(serve, argv_t)
    result = {"launches": counts[0], "max_gray_vs_direct": int(diff.max()),
              "equal_share": float((diff == 0).mean()), "ms_per_volume": wall_t * 1e3,
              "frames_per_sec": CYCLE / wall_t, "card": card_line}
    log("serve", f"EDVR x4 timed: {wall_t * 1e3:.1f} ms a volume of {CYCLE} frames, "
                 f"{CYCLE / wall_t:.2f} frames/s (server start excluded)")
    print(json.dumps({"serve_edvr": result}), flush=True)
    del net
    return result


def eval_loop_ab(port_main, Cfg, lstm_gates, dcn, tree: dict, tmp: Path, card_line) -> dict:
    """Phase 24: the predictor's double-buffered loop against
    ``EVSR_EAGER_EVAL=1`` on phase 10's bf16 RefineNet clips and phase 20's
    EDVR windows: equal Test logs and byte-equal NIfTI exports, then each
    mode's frames/s and the device's busy share over a whole ``predict``."""
    import os

    import torch

    ckpt_edvr = tmp / "EDVRNet_serve.pth"
    configs = {
        "refine_bf16": lambda d: {**eval_config(tree, tmp / "model.pth", d),
                                  "predictor": {"name": "AcdcVSRRefineNetPredictor", "kwargs": {
                                      "device": "cuda:0", "saved_dir": str(d), "exported": False,
                                      "compute_dtype": "bfloat16", "t_bucket": T_BUCKET,
                                      "export_nifti": True}}},
        "edvr": lambda d: misr_eval_config(tree, "EDVRNet", EDVR_NET, ckpt_edvr, d,
                                           num_frames=EDVR_T, loss=EDVR_LOSS, export_nifti=True),
    }
    results, counts = {}, {}
    for key, make in configs.items():
        preds, runs = {}, {}
        reset_launches(lstm_gates)
        dcn.reset_launches()
        for mode in ("eager", "double", "eager", "double"):
            if mode == "eager":
                os.environ["EVSR_EAGER_EVAL"] = "1"
            try:
                if mode not in preds:  # first run: through main, exports compared
                    preds[mode] = port_main.test_from_config(Cfg(make(tmp / f"ab_{key}_{mode}")))
                    continue
                pred = preds[mode]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred.predict()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    pred.predict()
                    torch.cuda.synchronize()
                kernel_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
                runs[mode] = {"frames_per_sec": pred.throughput["frames"] / wall,
                              "wall_ms": wall * 1e3, "kernel_ms": kernel_ms,
                              "busy": kernel_ms / (wall * 1e3)}
            finally:
                os.environ.pop("EVSR_EAGER_EVAL", None)
        counts[key] = (launches(lstm_gates), dcn_launches(dcn))
        a, b = preds["eager"], preds["double"]
        if a.log != b.log:
            raise AssertionError(f"{key}: eager and double-buffered Test logs differ: {a.log} vs {b.log}")
        files = {m: sorted(q.relative_to(tmp / f"ab_{key}_{m}")
                           for q in (tmp / f"ab_{key}_{m}" / "nifti").rglob("*.nii.gz"))
                 for m in ("eager", "double")}
        if not files["eager"] or files["eager"] != files["double"] or any(
                (tmp / f"ab_{key}_eager" / f).read_bytes() != (tmp / f"ab_{key}_double" / f).read_bytes()
                for f in files["eager"]):
            raise AssertionError(f"{key}: the NIfTI exports differ between the modes: {files}")
        if len(a.item_seconds) != len(b.item_seconds):
            raise AssertionError(f"{key}: item_seconds {len(a.item_seconds)} vs {len(b.item_seconds)}")
        log("eval loop", f"{key}: Test logs equal, {len(files['eager'])} NIfTI files byte-equal; "
                         f"frames/s double-buffered {runs['double']['frames_per_sec']:.2f} vs eager "
                         f"{runs['eager']['frames_per_sec']:.2f}; device busy over a whole predict "
                         f"{runs['double']['busy']:.1%} vs {runs['eager']['busy']:.1%} "
                         f"({runs['double']['kernel_ms']:.1f} / {runs['double']['wall_ms']:.1f} ms "
                         f"vs {runs['eager']['kernel_ms']:.1f} / {runs['eager']['wall_ms']:.1f} ms)")
        results[key] = {"log": a.log, "nifti_files": len(files["eager"]), **runs}
        del preds, a, b
    print(json.dumps({"eval_loop_ab": results, "card": card_line}), flush=True)
    return {"results": results, "counts": counts}


def profiled_training(port_main, Cfg, tree: dict, tmp: Path) -> dict:
    """Phase 25: one epoch of phase 7's training (a 16-feature, one-stage
    net) with ``EVSR_PROFILE_DIR`` set: a torch.profiler trace, with
    device kernels, for the train and the valid epoch."""
    import os

    cfg = train_config(tree, tmp / "train_profiled")
    cfg["net"] = {"name": "RefineNet", "kwargs": PROFILE_NET}
    cfg["trainer"]["kwargs"]["num_epochs"] = 1
    prof_dir = tmp / "profile"
    os.environ["EVSR_PROFILE_DIR"] = str(prof_dir)
    try:
        t0 = time.perf_counter()
        trainer = port_main.train_from_config(Cfg(cfg))
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("EVSR_PROFILE_DIR", None)
    found = {}
    for label in ("train_epoch_1", "valid_epoch_1"):
        traces = sorted((prof_dir / label).glob("*.json"))
        if not traces:
            raise AssertionError(f"no trace under {prof_dir / label}")
        events = json.loads(traces[0].read_text()).get("traceEvents", [])
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        found[label] = {"bytes": traces[0].stat().st_size, "events": len(events), "kernels": kernels}
        if not kernels:
            raise AssertionError(f"{traces[0]} holds no device kernel")
    if not all(math.isfinite(v) for h in trainer.history["train"] + trainer.history["valid"]
               for v in h.values()):
        raise AssertionError(f"profiled training logs non-finite: {trainer.history}")
    log("profile", f"one epoch with EVSR_PROFILE_DIR in {wall:.1f} s: {found}")
    return found


# ----------------------------------------- 26-30 parallel runs and remainders
TOL_WRAPPED = 1e-5  # phase 26: the losses of the world-1 DDP run, relative to the unwrapped run's
TOL_TWO_RANKS = 1e-5  # phase 27: loss and parameters of 2 ranks against world 1
TOL_RESUME = 1e-6  # phase 29: resumed against uninterrupted losses, relative
TOL_BATCH_PSNR, TOL_BATCH_SSIM = 1e-4, 1e-5  # phase 30: CSV rows against the predictor's
DDP_STEPS = 4  # phase 27: steps of batch 16, 8 items a rank
# phase 27 steps with SGD, as the JAX package's mesh tests do: Adam's
# g / (sqrt(v) + eps) turns the reduction-order noise of a gradient near 0
# into a whole lr step of either sign (measured on an H100: parameters
# 4.6e-4 apart after 4 Adam steps, the losses equal)
PHASE27_OPTIMIZER = {"name": "SGD", "lr": 1e-2}
RESUME_BACKENDS = ("pickle", "orbax", "orbax_async")


def deterministic_cudnn(torch, on: bool = True) -> tuple:
    """cuDNN's deterministic algorithms (the comparisons of phases 26-29
    are between runs); returns the previous (deterministic, benchmark)."""
    before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = on, False
    return before


def train_items(n: int, seed: int) -> list:
    """``n`` items of the training shape (19 LR frames of 32x32, 7 HR
    frames of 128x128, the phase code), drawn from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"lr_imgs": rng.standard_normal((T_TRAIN, PATCH, PATCH, 1)).astype(np.float32),
             "hr_imgs": rng.standard_normal((CORE, PATCH * SCALE, PATCH * SCALE, 1)).astype(np.float32),
             "pos_code": rng.uniform(-1, 1, (T_TRAIN, 1)).astype(np.float32)} for _ in range(n)]


def step_trainer(state: dict, items: list, mesh, dev, name: str = "Adam",
                 net_kwargs: dict | None = None, **optimizer):
    """exp1_x4.yaml's trainer (Adam at 1e-4, the stage-discounted L1) over
    ``items`` in order, batch 16, from the weights ``state``; ``name`` and
    ``optimizer`` replace the optimizer or add its knobs, ``net_kwargs``
    the net's."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import Dataloader
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.losses import L1Loss
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.metrics import PSNR
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.refine_net import RefineNet
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.optim import Optimizer
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.trainers import (
        VSRRefineNetTrainer,
    )

    net = RefineNet(**(net_kwargs or NET_KWARGS))
    net.load_state_dict(state, strict=True)
    loader = Dataloader(items, batch_size=TRAIN_BATCH)
    return VSRRefineNetTrainer(
        device=dev, train_dataloader=loader, valid_dataloader=loader, net=net,
        loss_fns=[L1Loss()], loss_weights=[1.0], metric_fns=[PSNR()],
        optimizer=Optimizer(name, **{"lr": 1e-4, "weight_decay": 0, **optimizer}), num_epochs=1,
        mesh=mesh, telemetry=False)


def two_rank_steps(state: dict, items: list, saved_dir: str, device: str) -> dict:
    """Phase 27's rank: the port's mesh over the spawned gloo group, both
    ranks on ``device`` (cuda:0), ``DDP_STEPS`` steps, then a checkpoint
    (the lead writes it).  Rank 0's result comes back to the parent."""
    import torch

    sys.path.insert(0, str(REPO))
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import lstm_gates
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic_cudnn(torch)
    dev = torch.device(device)
    mesh = make_mesh(2, device=dev)
    trainer = step_trainer(state, items, mesh, dev, **PHASE27_OPTIMIZER)
    local_batch = next(iter(trainer.train_dataloader))["lr_imgs"].shape[0]
    reset_launches(lstm_gates)
    log_, _, _ = trainer._run_epoch("training")
    counts = launches(lstm_gates)
    trainer.save(Path(saved_dir) / f"model_{DDP_STEPS}.pth")
    return {"log": log_, "state": {k: v.cpu() for k, v in trainer.net.state_dict().items()},
            "launches": counts, "model": type(trainer.model).__name__, "mesh": mesh.shape,
            "backend": torch.distributed.get_backend(), "lead": mesh.is_lead,
            "local_batch": local_batch}


def ddp_phases(port_main, Cfg, lstm_gates, tree: dict, tmp: Path, dev, card_line) -> dict:
    """Phases 26-27: the data axis on the card."""
    import torch
    import torch.distributed as dist

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.refine_net import RefineNet
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
        distributed,
        make_mesh,
    )

    before = deterministic_cudnn(torch)
    out = {"card": card_line}
    # ------------------------------------------ 26: world size 1 against none
    runs = {}
    # in turns: unwrapped, wrapped, wrapped, unwrapped (one call, one card)
    for name, parallel in (("unwrapped", None), ("world_1", {"num_devices": 1}),
                           ("world_1_b", {"num_devices": 1}), ("unwrapped_b", None)):
        cfg = train_config(tree, tmp / f"ddp_{name}")
        cfg["trainer"]["kwargs"].update(num_epochs=1, device=str(dev))
        if parallel:
            cfg["parallel"] = parallel
        reset_launches(lstm_gates)
        trainer = port_main.train_from_config(Cfg(cfg))
        runs[name] = {"history": trainer.history, "launches": launches(lstm_gates),
                      "model": type(trainer.model).__name__,
                      "mesh": trainer.mesh.shape if trainer.mesh is not None else None,
                      "backend": trainer.mesh.backend if trainer.mesh is not None else None,
                      "group_left": dist.is_initialized(),
                      "step_ms": 1e3 / trainer.throughput["train_steps_per_sec"]}
        log("ddp", f"{name}: {runs[name]['model']}, mesh {runs[name]['mesh']}, Train log "
                   f"{trainer.history['train'][0]}, {runs[name]['step_ms']:.1f} ms a step, gate "
                   f"launches {runs[name]['launches']}")
    one, none = runs["world_1"], runs["unwrapped"]
    # main's group of one belongs to its run: none is left after it returns
    if one["model"] != "DistributedDataParallel" or one["mesh"] != {"data": 1} or \
            one["backend"] != distributed.backend_for(dev) or \
            any(run["group_left"] for run in runs.values()):
        raise AssertionError(f"the world-1 run was not wrapped in a group of one of its own: "
                             f"{ {k: {x: v[x] for x in ('model', 'mesh', 'backend', 'group_left')} for k, v in runs.items()} }")
    if one["launches"] != none["launches"] or one["launches"][0] != FWD_PER_STEP * STEPS_PER_EPOCH + \
            LAUNCHES_PER_CLIP * VALID_CLIPS:
        raise AssertionError(f"gate launches differ: {one['launches']} against {none['launches']}")
    worst = 0.0
    for run in runs.values():
        if run["launches"] != none["launches"]:
            raise AssertionError(f"gate launches differ between the runs: {runs}")
        for split in ("train", "valid"):
            for key, want in none["history"][split][0].items():
                got = run["history"][split][0][key]
                worst = max(worst, abs(got - want) / abs(want))
    wrapped = [runs[k]["step_ms"] for k in ("world_1", "world_1_b")]
    plain = [runs[k]["step_ms"] for k in ("unwrapped", "unwrapped_b")]
    log("ddp", f"world 1 ({one['backend']}, DDP) against unwrapped, in turns: largest relative "
               f"log difference {worst:.3e} (tol {TOL_WRAPPED}); ms a step wrapped "
               f"{wrapped[0]:.1f}, {wrapped[1]:.1f} (mean {sum(wrapped) / 2:.1f}), unwrapped "
               f"{plain[0]:.1f}, {plain[1]:.1f} (mean {sum(plain) / 2:.1f}) ({card_line})")
    if not worst <= TOL_WRAPPED:
        raise AssertionError(f"the wrapped step disagrees with the unwrapped one: {worst}")
    out.update(world1_step_ms=wrapped, unwrapped_step_ms=plain, world1_rel_diff=worst,
               world1_launches=one["launches"], unwrapped_launches=none["launches"])

    # ---------------------------------- 27: two ranks on cuda:0 over gloo
    items = train_items(DDP_STEPS * TRAIN_BATCH, seed=5)
    state = RefineNet(**NET_KWARGS, generator=torch.Generator().manual_seed(0)).state_dict()
    # world 1 in a group of one made here for it
    dist.init_process_group(distributed.backend_for(dev), world_size=1, rank=0,
                            init_method=f"tcp://localhost:{distributed.free_port()}")
    reference = step_trainer(state, items, make_mesh(1, device=dev), dev, **PHASE27_OPTIMIZER)
    ref_log, _, _ = reference._run_epoch("training")
    ref_state = {k: v.cpu() for k, v in reference.net.state_dict().items()}
    del reference
    dist.destroy_process_group()
    saved = tmp / "two_ranks"
    saved.mkdir()
    t0 = time.perf_counter()
    ranks = distributed.spawn(two_rank_steps, (state, items, str(saved), str(dev)), world=2,
                              device=dev, backend="gloo")
    wall = time.perf_counter() - t0
    loss_diff = abs(ranks["log"]["Loss"] - ref_log["Loss"]) / abs(ref_log["Loss"])
    # each parameter relative to its largest element
    param_diff = max(((ranks["state"][k] - v).abs().max() / v.abs().max().clamp_min(1e-12)).item()
                     for k, v in ref_state.items() if v.is_floating_point())
    written = sorted(p.name for p in saved.iterdir())
    log("ddp", f"2 ranks on {dev} ({ranks['backend']}, {ranks['model']}, mesh {ranks['mesh']}), "
               f"{DDP_STEPS} steps in {wall:.1f} s with the processes' start: loss "
               f"{ranks['log']['Loss']:.6f} against world 1's {ref_log['Loss']:.6f} (relative "
               f"{loss_diff:.3e}), parameters within {param_diff:.3e} of their largest element (tol "
               f"{TOL_TWO_RANKS}; SGD at {PHASE27_OPTIMIZER['lr']}); {ranks['local_batch']} items a "
               f"rank a step; rank 0's "
               f"gate launches {ranks['launches']}; written: {written} (correctness only: no rate)")
    want_launches = (FWD_PER_STEP * DDP_STEPS, BWD_PER_STEP * DDP_STEPS, 0, 0)
    if ranks["backend"] != "gloo" or ranks["mesh"] != {"data": 2} or not ranks["lead"] or \
            ranks["local_batch"] != TRAIN_BATCH // 2:
        raise AssertionError(f"the two-rank run was not the mesh asked for: {ranks}")
    if not (loss_diff <= TOL_TWO_RANKS and param_diff <= TOL_TWO_RANKS):
        raise AssertionError(f"two ranks disagree with world 1: {loss_diff}, {param_diff}")
    if ranks["launches"] != want_launches or written != [f"model_{DDP_STEPS}.pth"]:
        raise AssertionError(f"rank 0 launched {ranks['launches']}, wrote {written}")
    out.update(two_ranks_loss_rel=loss_diff, two_ranks_param_rel=param_diff,
               two_ranks_launches=ranks["launches"], two_ranks_wall_s=wall,
               world1_reference=(ref_log, ref_state))  # phase 34's reference too
    deterministic_cudnn(torch, before[0])
    torch.backends.cudnn.benchmark = before[1]
    return out


def skip_nonfinite_card(lstm_gates, dev) -> dict:
    """Phase 28: ``skip_nonfinite: 3`` at full width on the card."""
    import numpy as np
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import default_collate
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.refine_net import RefineNet

    items = train_items(TRAIN_BATCH, seed=6)
    state = RefineNet(**NET_KWARGS, generator=torch.Generator().manual_seed(0)).state_dict()
    trainer = step_trainer(state, items, None, dev, skip_nonfinite=3)
    trainer.net.train(True)
    good = default_collate(items)
    bad = {k: v.copy() for k, v in good.items()}
    bad["lr_imgs"][0, 0, 0, 0, 0] = np.nan

    def snapshot():
        return ({k: v.detach().clone() for k, v in trainer.net.named_parameters()},
                {id(p): {k: v.clone() for k, v in trainer.opt.state[p].items()}
                 for p in trainer.net.parameters() if p in trainer.opt.state})

    reset_launches(lstm_gates)
    trainer._train_step(good)
    params, moments = snapshot()
    total, *_ = trainer._train_step(bad)
    after_params, after_moments = snapshot()
    equal = all(torch.equal(after_params[k], v) for k, v in params.items()) and all(
        torch.equal(after_moments[i][k], v) for i, m in moments.items() for k, v in m.items())
    trainer._train_step(good)
    moved = any(not torch.equal(p.detach(), params[k]) for k, p in trainer.net.named_parameters())
    skipped = trainer.optimizer.check_nonfinite(trainer.opt)
    counts = launches(lstm_gates)
    log("skip", f"a poisoned step (loss {float(total)}): parameters and Adam state bit-equal "
                f"across it: {equal}; the next step moves them: {moved}; check_nonfinite reports "
                f"{skipped}; gate launches {counts}")
    if not (equal and moved and skipped == 1 and not math.isfinite(float(total))):
        raise AssertionError("skip_nonfinite did not skip the poisoned step alone")
    for _ in range(3):
        trainer._train_step(bad)
    try:
        trainer.optimizer.check_nonfinite(trainer.opt)
    except RuntimeError as e:
        log("skip", f"three poisoned steps in a row raise: {e}")
    else:
        raise AssertionError("three consecutive non-finite steps did not raise")
    if any(not torch.isfinite(p).all() for p in trainer.net.parameters()):
        raise AssertionError("a non-finite update reached the parameters")
    return {"launches": counts, "skipped": skipped}


def resume_backends(port_main, Cfg, lstm_gates, tree: dict, tmp: Path, dev) -> dict:
    """Phase 29: one epoch, save, resume and one more against two
    uninterrupted epochs, for each checkpoint backend."""
    import torch

    before = deterministic_cudnn(torch)
    reset_launches(lstm_gates)
    cfg = train_config(tree, tmp / "resume_straight")
    cfg["trainer"]["kwargs"]["device"] = str(dev)
    straight = port_main.train_from_config(Cfg(cfg))
    want = straight.history
    out = {}
    for backend in RESUME_BACKENDS:
        saved = tmp / f"resume_{backend}"
        cfg = train_config(tree, saved)
        cfg["trainer"]["kwargs"].update(checkpoint_backend=backend, preempt_after_epochs=1,
                                        device=str(dev))
        port_main.train_from_config(Cfg(cfg))
        ckpt = saved / "checkpoints" / "model_1.pth"
        kind = "directory" if ckpt.is_dir() else "file"
        cfg = train_config(tree, saved)
        cfg["trainer"]["kwargs"].update(checkpoint_backend=backend, device=str(dev))
        cfg["main"]["loaded_path"] = str(ckpt)
        resumed = port_main.train_from_config(Cfg(cfg))
        got = resumed.history
        worst = max(abs(got[split][0][key] - want[split][1][key]) / abs(want[split][1][key])
                    for split in ("train", "valid") for key in want[split][1])
        log("resume", f"{backend} ({kind}): epoch 2 resumed from model_1.pth against the "
                      f"uninterrupted run: largest relative log difference {worst:.3e} (tol "
                      f"{TOL_RESUME})")
        if len(got["train"]) != 1 or not worst <= TOL_RESUME:
            raise AssertionError(f"the {backend} resume disagrees: {worst}, {got}")
        out[backend] = worst
    deterministic_cudnn(torch, before[0])
    torch.backends.cudnn.benchmark = before[1]
    out["launches"] = launches(lstm_gates)
    return out


def batch_infer_card(port_main, Cfg, lstm_gates, tree: dict, tmp: Path, ckpt: Path, dev,
                     eval_fps: float, card_line) -> dict:
    """Phase 30: ``tools/batch_infer.py`` at full width against the
    predictor's per-frame scores on the same clips and weights."""
    import csv

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import batch_infer

    reset_launches(lstm_gates)
    summary = batch_infer.main([str(ckpt), str(tree["videos"]), str(tree["pos_code"]),
                                str(tmp / "batch_infer.csv"), "--net-kwargs", json.dumps(NET_KWARGS),
                                "--device", str(dev)])
    counts = launches(lstm_gates)
    with open(tmp / "batch_infer.csv", newline="") as f:
        rows = list(csv.reader(f))[1:]
    # the predictor's per-frame rows (its CSV, beside its GIFs and PNGs)
    cfg = eval_config(tree, ckpt, tmp / "batch_infer_pred")
    cfg["metrics"] = [{"name": "PSNR"}, {"name": "SSIM"}]
    cfg["predictor"]["kwargs"].update(exported=True, device=str(dev))
    port_main.test_from_config(Cfg(cfg))
    with open(tmp / "batch_infer_pred" / "results.csv", newline="") as f:
        want = {r[0]: (float(r[1]), float(r[2])) for r in list(csv.reader(f))[1:]}
    d_psnr = d_ssim = 0.0
    for name, _, psnr, ssim in rows:
        p, s = want[name.replace("2d+1d", "2d").replace("sequence", "slice")]
        d_psnr, d_ssim = max(d_psnr, abs(float(psnr) - p)), max(d_ssim, abs(float(ssim) - s))
    log("batch_infer", f"{summary['sequences']} sequences, {summary['frames']} frames at "
                       f"{summary['frames_per_sec']:.2f} frames/s (phase 4's predictor: "
                       f"{eval_fps:.2f}; {card_line}); rows against the predictor's: PSNR within "
                       f"{d_psnr:.2e} dB (tol {TOL_BATCH_PSNR}), SSIM within {d_ssim:.2e} (tol "
                       f"{TOL_BATCH_SSIM}); gate launches {counts}")
    if len(rows) != len(want) or counts != (LAUNCHES_PER_CLIP * SLICES, 0, 0, 0):
        raise AssertionError(f"batch_infer wrote {len(rows)} rows, launched {counts}")
    if not (d_psnr <= TOL_BATCH_PSNR and d_ssim <= TOL_BATCH_SSIM):
        raise AssertionError(f"batch_infer's rows disagree with the predictor's: {d_psnr}, {d_ssim}")
    return {"launches": counts, "frames_per_sec": summary["frames_per_sec"],
            "eval_frames_per_sec": eval_fps, "psnr_diff": d_psnr, "ssim_diff": d_ssim}


# ------------------------------------------------------- 34 the spatial axis
SPATIAL = 2  # gloo ranks sharing cuda:0, each holding half of every frame's rows
# (a): the Test log of the spatial run against phase 4's meshless one, relative
# (the JAX package's own bound, tests/test_parallel.py:588-591)
TOL_SPATIAL_LOG = 1e-5
# (b): one step with remat against the plain step on the spatial mesh (the
# recompute reruns the same kernels), loss and parameters, relative
TOL_SPATIAL_REMAT = 1e-6
# (c): the JAX package's pad_h bounds against the meshless run
# (tests/test_parallel.py:686-691): edge-extended rows replace the zero
# padding at the bottom border
PAD_H_DPSNR, PAD_H_DSSIM, PAD_H_LOSS_REL = 0.2, 0.01, 0.05
ODD_HR = [(4 * 63, HR)]  # LR 63x64: spatial 2 does not divide the height
# halo exchanges: every conv with a 3-wide window in H, once a call
# (the window conv, the refine conv, 3 out-block convs a branch, the in-block
# on the core and on each warm-up segment)
EXCHANGES_PER_CLIP = LAUNCHES_PER_CLIP + 3 + 2 * NET_KWARGS["num_stages"] \
    + 3 * 3 * NET_KWARGS["num_stages"]  # 792
EXCHANGES_FWD_PER_STEP = FWD_PER_STEP + 3 + 2 * NET_KWARGS["num_stages"] \
    + 3 * 3 * NET_KWARGS["num_stages"]  # 378
# the backward exchanges where a gradient flows: the core steps' gate convs,
# the refine convs and the out-block (the LR input carries none)
EXCHANGES_BWD_PER_STEP = BWD_PER_STEP + 2 * NET_KWARGS["num_stages"] \
    + 3 * 3 * NET_KWARGS["num_stages"]  # 159
SHARD_EVAL = (1, NET_KWARGS["num_features"][0], HR // SCALE // SPATIAL, HR // SCALE)
SHARD_TRAIN = (TRAIN_BATCH, NET_KWARGS["num_features"][0], PATCH // SPATIAL, PATCH)


def gate_kernel_at_shards(lstm_gates, recurrence_format, dev) -> dict:
    """Phase 34 (e): the gate kernels against their plain versions at a
    spatial rank's shapes, forward at the eval shard and forward and
    backward at the training shard, fp32 NCHW and bf16 channels-last (the
    recurrence's layouts), with the tolerances of phases 3 and 9."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(34)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        fmt = recurrence_format(dtype)
        for name, shape_c in (("eval", SHARD_EVAL), ("train", SHARD_TRAIN)):
            g, c, b = gate_operands(shape_c, fmt, dtype, dev, gen)
            h_k, c_k = lstm_gates.fused_lstm_gates(g, c, dim=1, bias=b)
            h_p, c_p = lstm_gates.lstm_gates_reference(g.float(), c.float(), dim=1, bias=b.float())
            err = max((h_k.float() - h_p).abs().max().item(), (c_k.float() - c_p).abs().max().item())
            tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16
            shape_g = (shape_c[0], 4 * shape_c[1], *shape_c[2:])
            log("spatial", f"gate kernel at the {name} shard {shape_g} {dtype} ({fmt_name(fmt)}): "
                           f"max abs err {err:.3e} (tol {tol})")
            if not err <= tol:
                raise AssertionError(f"gate kernel disagrees at the {name} shard: {dtype} {err}")
            out[f"fwd {name} {dtype}"] = err
        g, c, b = gate_operands(SHARD_TRAIN, fmt, dtype, dev, gen)
        dh, dc = (torch.randn(SHARD_TRAIN, device=dev, generator=gen).to(dtype).contiguous(
            memory_format=fmt) for _ in range(2))
        dg_k, dc_k = lstm_gates._launch_bwd(g, c, dh, dc, 1, b)
        dg_p, dc_p = lstm_gates.lstm_gates_backward_reference(
            g.float(), c.float(), dh.float(), dc.float(), dim=1, bias=b.float())
        torch.cuda.synchronize()
        err = max((dg_k.float() - dg_p).abs().max().item(), (dc_k.float() - dc_p).abs().max().item())
        rel = max(((k.float() - p).abs() / p.abs().clamp_min(1)).max().item()
                  for k, p in ((dg_k, dg_p), (dc_k, dc_p)))
        ok = err <= TOL_FP32 if dtype == torch.float32 else rel <= TOL_BF16_REL
        log("spatial", f"backward kernel at the training shard {dtype}: max abs err {err:.3e}, "
                       f"err / max(1, |value|) {rel:.3e} (tol {TOL_FP32} abs in fp32, "
                       f"{TOL_BF16_REL} relative in bf16)")
        if not ok:
            raise AssertionError(f"backward kernel disagrees at the training shard: {dtype}")
        out[f"bwd train {dtype}"] = err
    return out


def spatial_rank(eval_cfg: dict, pad_cfg: dict, infer_argv: list, state: dict, items: list,
                 clip, pos, device: str) -> dict:
    """Phase 34's rank: ``SPATIAL`` gloo ranks on cuda:0 as one spatial
    group; (a) the eval through ``main.test_from_config`` and the net's
    fused output on a clip, gathered; (b) ``DDP_STEPS`` SGD steps, then one
    step plain and with remat; (c) pad_h serving of a tree of odd LR
    height; (d) ``batch_infer --spatial-parallel --pad-h``.  Rank 0's
    results come back to the parent."""
    import torch

    sys.path.insert(0, str(REPO))
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import main as port_main
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import lstm_gates
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
        gather_rows,
        halo,
        make_mesh,
        mesh as mesh_mod,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import batch_infer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic_cudnn(torch)
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {"backend": torch.distributed.get_backend()}

    def path(name, fn):
        """Run ``fn`` with the gate counts and the halo exchanges set to 0
        just before it and read just after it; its wall in seconds."""
        reset_launches(lstm_gates)
        halo.reset_exchanges()
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        out[name] = {"launches": launches(lstm_gates), "exchanges": dict(halo.EXCHANGES),
                     "wall_s": time.perf_counter() - t0}
        return result

    # (a) the eval of phase 4's clips
    mesh_mod._WARNED.clear()
    predictor = path("eval", lambda: port_main.test_from_config(Cfg(eval_cfg)))
    out["eval"].update(log=predictor.log, mesh=dict(predictor.mesh.shape),
                       clip_ms=[x * 1e3 for x in predictor.item_seconds])
    with torch.inference_mode():
        inputs, axis = predictor._shard_rows([clip, pos])
        fused = predictor.net(*(torch.from_numpy(x).to(dev) for x in inputs))[-1]
        out["fused"] = gather_rows(fused, axis).cpu()
    del predictor
    # (b) the training steps of phase 27 on a (data 1, spatial SPATIAL) mesh
    mesh = make_mesh(SPATIAL, spatial_parallel=SPATIAL, device=dev)
    trainer = step_trainer(state, items, mesh, dev, **PHASE27_OPTIMIZER)
    log_ = path("train", lambda: trainer._run_epoch("training")[0])
    out["train"].update(log=log_, mesh=dict(mesh.shape),
                        state={k: v.cpu() for k, v in trainer.net.state_dict().items()},
                        model=type(trainer.model).__name__,
                        local_items=next(iter(trainer.train_dataloader))["lr_imgs"].shape[0])
    del trainer
    for name, remat in (("step_plain", False), ("step_remat", True)):
        trainer = step_trainer(state, items[:TRAIN_BATCH], mesh, dev,
                               net_kwargs={**NET_KWARGS, "remat": remat}, **PHASE27_OPTIMIZER)
        loss = path(name, lambda: trainer._run_epoch("training")[0]["Loss"])
        out[name].update(loss=loss, state={k: v.cpu() for k, v in trainer.net.state_dict().items()})
        del trainer
    out["warned_train"] = sorted(k[0] for k in mesh_mod._WARNED)
    # (c) pad_h on the tree of odd LR height; (d) batch_infer on it
    mesh_mod._WARNED.clear()
    predictor = path("pad_h", lambda: port_main.test_from_config(Cfg(pad_cfg)))
    out["pad_h"].update(log=predictor.log, pad_h=predictor.pad_h,
                        clip_ms=[x * 1e3 for x in predictor.item_seconds],
                        warned=sorted(k[0] for k in mesh_mod._WARNED))
    del predictor
    summary = path("batch_infer", lambda: batch_infer.main(infer_argv))
    out["batch_infer"]["summary"] = summary
    return out


def spatial_axis_card(port_main, Cfg, lstm_gates, recurrence_format, tree: dict, tmp: Path,
                      ckpt: Path, fp32_log: dict, fused_meshless, clip, pos,
                      reference: tuple, dev, card_line) -> dict:
    """Phase 34: the spatial axis (height sharded over ``SPATIAL`` gloo
    ranks sharing cuda:0, halo exchange at every conv) and pad_h."""
    import csv

    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.refine_net import RefineNet
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import distributed
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.synthetic_tree import (
        write_acdc_tree,
    )

    kernels = gate_kernel_at_shards(lstm_gates, recurrence_format, dev)
    parallel = {"num_devices": SPATIAL, "spatial_parallel": SPATIAL}
    eval_cfg = eval_config(tree, ckpt, tmp / "spatial_test")
    eval_cfg["parallel"] = parallel
    odd = write_acdc_tree(tmp / "odd", {"test": (1, 1)}, cycle=CYCLE, hr=ODD_HR, scale=SCALE)
    pad_cfg = eval_config(odd, ckpt, tmp / "spatial_pad_h")
    pad_cfg["parallel"] = {**parallel, "pad_h": True}
    pad_cfg["predictor"]["kwargs"]["exported"] = True  # its CSV rows for (d)
    meshless_cfg = eval_config(odd, ckpt, tmp / "odd_meshless")
    for cfg in (eval_cfg, pad_cfg, meshless_cfg):
        cfg["predictor"]["kwargs"]["device"] = str(dev)
    infer_csv = tmp / "spatial_batch_infer.csv"
    infer_argv = [str(ckpt), str(odd["videos"]), str(odd["pos_code"]), str(infer_csv),
                  "--net-kwargs", json.dumps(NET_KWARGS), "--device", dev.type,
                  "--num-devices", str(SPATIAL), "--spatial-parallel", str(SPATIAL), "--pad-h"]
    items = train_items(DDP_STEPS * TRAIN_BATCH, seed=5)  # phase 27's steps
    state = RefineNet(**NET_KWARGS, generator=torch.Generator().manual_seed(0)).state_dict()
    t0 = time.perf_counter()
    ranks = distributed.spawn(spatial_rank, (eval_cfg, pad_cfg, infer_argv, state, items,
                                             clip.cpu().numpy(), pos.cpu().numpy(), str(dev)),
                              world=SPATIAL, device=dev, backend="gloo")
    wall = time.perf_counter() - t0
    note = f"{SPATIAL} gloo ranks sharing one card: correctness only, no rate ({card_line})"

    # (a) the eval against phase 4's meshless run
    ev = ranks["eval"]
    log_rel = max(abs(ev["log"][k] - v) / abs(v) for k, v in fp32_log.items())
    sr_err = (ranks["fused"] - fused_meshless.cpu()).abs().max().item()
    log("spatial", f"eval through main --test on mesh {ev['mesh']} ({ranks['backend']}): Test log "
                   f"{ev['log']}; largest relative difference to phase 4's meshless log "
                   f"{log_rel:.3e} (tol {TOL_SPATIAL_LOG}); gathered fused frames "
                   f"{tuple(ranks['fused'].shape)} within {sr_err:.3e} of phase 5's meshless "
                   f"forward (tol {TOL_FORWARD})")
    log("spatial", f"ms a clip {', '.join(f'{x:.1f}' for x in ev['clip_ms'])}; rank 0's gate "
                   f"launches {ev['launches']} ({LAUNCHES_PER_CLIP} x {SLICES} clips expected), "
                   f"halo exchanges {ev['exchanges']} ({EXCHANGES_PER_CLIP} a clip expected); "
                   f"{note}")
    if ev["mesh"] != {"data": 1, "spatial": SPATIAL} or ranks["backend"] != "gloo":
        raise AssertionError(f"the spatial eval ran on {ev['mesh']} over {ranks['backend']}")
    if not (log_rel <= TOL_SPATIAL_LOG and sr_err <= TOL_FORWARD):
        raise AssertionError(f"the spatial eval disagrees with the meshless one: {log_rel}, {sr_err}")
    if ev["launches"] != (LAUNCHES_PER_CLIP * SLICES, 0, 0, 0) or \
            ev["exchanges"] != {"forward": EXCHANGES_PER_CLIP * SLICES, "backward": 0}:
        raise AssertionError(f"the spatial eval launched {ev['launches']}, exchanged {ev['exchanges']}")

    # (b) the steps against phase 27's world 1, and remat against plain
    ref_log, ref_state = reference
    tr = ranks["train"]
    loss_diff = abs(tr["log"]["Loss"] - ref_log["Loss"]) / abs(ref_log["Loss"])
    param_diff = max(((tr["state"][k] - v).abs().max() / v.abs().max().clamp_min(1e-12)).item()
                     for k, v in ref_state.items() if v.is_floating_point())
    plain, remat = ranks["step_plain"], ranks["step_remat"]
    remat_loss = abs(remat["loss"] - plain["loss"]) / abs(plain["loss"])
    remat_param = max(((remat["state"][k] - v).abs().max() / v.abs().max().clamp_min(1e-12)).item()
                      for k, v in plain["state"].items() if v.is_floating_point())
    step_ms = tr["wall_s"] * 1e3 / DDP_STEPS
    log("spatial", f"{DDP_STEPS} SGD steps of batch {TRAIN_BATCH} on mesh {tr['mesh']} "
                   f"({tr['model']}, {tr['local_items']} items a rank, 1/{SPATIAL} of their rows): loss "
                   f"{tr['log']['Loss']:.6f} against world 1's {ref_log['Loss']:.6f} (relative "
                   f"{loss_diff:.3e}), parameters within {param_diff:.3e} of their largest element "
                   f"(tol {TOL_TWO_RANKS}); {step_ms:.1f} ms a step; rank 0's gate launches "
                   f"{tr['launches']}, halo exchanges {tr['exchanges']} ({EXCHANGES_FWD_PER_STEP} "
                   f"forward + {EXCHANGES_BWD_PER_STEP} backward a step expected); {note}")
    log("spatial", f"one step with remat against the plain step on the mesh: loss relative "
                   f"{remat_loss:.3e}, parameters {remat_param:.3e} (tol {TOL_SPATIAL_REMAT}); "
                   f"gate launches {plain['launches']} plain, {remat['launches']} remat; halo "
                   f"exchanges {plain['exchanges']} plain, {remat['exchanges']} remat")
    if tr["mesh"] != {"data": 1, "spatial": SPATIAL} or tr["local_items"] != TRAIN_BATCH:
        raise AssertionError(f"the spatial steps ran on {tr['mesh']}, {tr['local_items']} items")
    if not (loss_diff <= TOL_TWO_RANKS and param_diff <= TOL_TWO_RANKS):
        raise AssertionError(f"the spatial steps disagree with world 1: {loss_diff}, {param_diff}")
    if not (remat_loss <= TOL_SPATIAL_REMAT and remat_param <= TOL_SPATIAL_REMAT):
        raise AssertionError(f"the remat step disagrees with the plain one: {remat_loss}, {remat_param}")
    want = (FWD_PER_STEP * DDP_STEPS, BWD_PER_STEP * DDP_STEPS, 0, 0)
    if tr["launches"] != want or tr["exchanges"] != {
            "forward": EXCHANGES_FWD_PER_STEP * DDP_STEPS,
            "backward": EXCHANGES_BWD_PER_STEP * DDP_STEPS}:
        raise AssertionError(f"the spatial steps launched {tr['launches']}, exchanged {tr['exchanges']}")
    if remat["launches"] != (REMAT_FWD_PER_STEP, BWD_PER_STEP, 0, 0) or ranks["warned_train"]:
        raise AssertionError(f"the remat step launched {remat['launches']}; {ranks['warned_train']}")

    # (c) pad_h against the meshless run of the same tree
    meshless = port_main.test_from_config(Cfg(meshless_cfg))
    pad = ranks["pad_h"]
    gaps = {k: pad["log"][k] - meshless.log[k] for k in meshless.log}
    log("spatial", f"pad_h, LR height {ODD_HR[0][0] // SCALE} over {SPATIAL} ranks: Test log "
                   f"{pad['log']} against the meshless {meshless.log}: gaps {gaps} (bounds: PSNR "
                   f"and CardiacPSNR {PAD_H_DPSNR} dB, SSIM {PAD_H_DSSIM}, Loss {PAD_H_LOSS_REL} "
                   f"relative); spatial warnings {pad['warned']}; ms a clip "
                   f"{', '.join(f'{x:.1f}' for x in pad['clip_ms'])}; gate launches "
                   f"{pad['launches']}, halo exchanges {pad['exchanges']}")
    if not pad["pad_h"] or pad["warned"]:
        raise AssertionError(f"pad_h did not shard the odd height: {pad}")
    if not (abs(gaps["PSNR"]) < PAD_H_DPSNR and abs(gaps["CardiacPSNR"]) < PAD_H_DPSNR
            and abs(gaps["SSIM"]) < PAD_H_DSSIM
            and abs(gaps["Loss"]) <= PAD_H_LOSS_REL * abs(meshless.log["Loss"])):
        raise AssertionError(f"pad_h is outside the JAX package's bounds: {gaps}")
    if pad["launches"] != (LAUNCHES_PER_CLIP, 0, 0, 0):
        raise AssertionError(f"the pad_h eval launched {pad['launches']}")

    # (d) batch_infer against the pad_h predictor's rows
    with open(infer_csv, newline="") as f:
        rows = list(csv.reader(f))[1:]
    with open(tmp / "spatial_pad_h" / "results.csv", newline="") as f:
        want = {r[0]: (float(r[1]), float(r[2])) for r in list(csv.reader(f))[1:]}
    d_psnr = d_ssim = 0.0
    for name, _, psnr, ssim in rows:
        p, q = want[name.replace("2d+1d", "2d").replace("sequence", "slice")]
        d_psnr, d_ssim = max(d_psnr, abs(float(psnr) - p)), max(d_ssim, abs(float(ssim) - q))
    bi = ranks["batch_infer"]
    log("spatial", f"batch_infer --spatial-parallel {SPATIAL} --pad-h: {bi['summary']}; rows "
                   f"against the pad_h predictor's: PSNR within {d_psnr:.2e} dB (tol "
                   f"{TOL_BATCH_PSNR}), SSIM within {d_ssim:.2e} (tol {TOL_BATCH_SSIM}); gate "
                   f"launches {bi['launches']}, halo exchanges {bi['exchanges']}")
    if len(rows) != len(want) or not rows or bi["launches"] != (LAUNCHES_PER_CLIP, 0, 0, 0):
        raise AssertionError(f"batch_infer wrote {len(rows)} rows, launched {bi['launches']}")
    if not (d_psnr <= TOL_BATCH_PSNR and d_ssim <= TOL_BATCH_SSIM):
        raise AssertionError(f"batch_infer's rows disagree: {d_psnr}, {d_ssim}")
    log("spatial", f"phase 34 in {wall:.1f} s with the ranks' start")
    return {"kernels": kernels, "eval_log_rel": log_rel, "eval_sr_err": sr_err,
            "eval_clip_ms": ev["clip_ms"], "eval_launches": ev["launches"],
            "eval_exchanges": ev["exchanges"], "train_loss_rel": loss_diff,
            "train_param_rel": param_diff, "train_step_ms": step_ms,
            "train_launches": tr["launches"], "train_exchanges": tr["exchanges"],
            "remat_loss_rel": remat_loss, "remat_param_rel": remat_param,
            "remat_launches": remat["launches"], "remat_exchanges": remat["exchanges"],
            "pad_h_gaps": gaps, "pad_h_clip_ms": pad["clip_ms"], "pad_h_launches": pad["launches"],
            "batch_infer_launches": bi["launches"], "batch_infer_psnr_diff": d_psnr,
            "batch_infer_ssim_diff": d_ssim, "wall_s": wall, "card": card_line}


# ------------------------------------------ 35 the spatial axis of the zoo
# the nets of phases 13, 15 and 17 at full width with their seeded weights;
# DRFSISRNet has no YAML and runs at SRFB's widths.  The tree is theirs
# (write_acdc_tree, seed 0, HR 256) cut to one slice of ZOO_CYCLE frames:
# on two ranks sharing the card an exchange costs 4-11 ms (PERF.md
# section 5), which made RBPN's 60 windows 212 s
ZOO_CYCLE = 8
ZOO_NETS = {  # name → (family, predictor)
    "EDSRNet": ("sisr", "AcdcSISRPredictor"), "SRFBNet": ("sisr", "AcdcSISRSRFBPredictor"),
    "DRFSISRNet": ("sisr", "AcdcSISRSRFBPredictor"), "Bicubic": ("sisr", "AcdcSISRPredictor"),
    "DUFNet": ("misr", "AcdcMISRPredictor"), "RBPNet": ("misr", "AcdcMISRPredictor"),
    "DRFNet": ("vsr", "AcdcVSRPredictor"),
}
ZOO_TRAIN = ("SRFBNet", "DUFNet")  # train/{srfb_net,duf_net}/exp1_x4.yaml


def zoo_net(name: str) -> tuple[dict, int]:
    """``name``'s net kwargs (DRFSISRNet at SRFB's widths) and the items the
    one-slice tree serves (frames, windows or one clip)."""
    kwargs = {**SISR_NETS, **MISR_NETS, **VSR_NETS, "DRFSISRNet": SISR_NETS["SRFBNet"]}[name]
    return kwargs, 1 if ZOO_NETS[name][0] == "vsr" else ZOO_CYCLE


def zoo_exchanges(name: str, kwargs: dict, frames: int) -> int:
    """Halo exchanges of one forward (an item: a frame, a window, a clip of
    ``frames``): one for each conv with a window in H (3x3, the strided
    down-projections, the transposed up-projections, the 3-D convs), one
    for the band resize or DUF's unfold (PERF.md section 5, phase 35)."""
    up = 3  # x4: two conv + PixelShuffle stages and the final conv
    if name == "EDSRNet":  # head, 2 a block, body conv, 2 upsampler convs, tail conv
        return 2 * kwargs["num_resblocks"] + 5
    if name == "SRFBNet":  # LR conv, the skip; a step: the projections, deconv, conv
        return 2 + kwargs["num_steps"] * (2 * kwargs["num_groups"] + 2)
    if name == "DRFSISRNet":
        return 1 + kwargs["num_steps"] * (2 * kwargs["num_groups"] + up)
    if name == "DRFNet":
        return 1 + frames * (2 * kwargs["num_groups"] + up)
    if name == "Bicubic":
        return 1
    if name == "DUFNet":  # head, 6 blocks' 3x3x3, the tail's (1,3,3), the unfold
        return 9
    n, chain = kwargs["num_frames"] - 1, 2 * kwargs["num_resblocks"] + 1  # RBPNet
    # feat0, feat1 a neighbour, res_feat3 for all but the first, the trunk's
    # 5 projection blocks of 3, res_feat1 and res_feat2, the output conv
    return 1 + n + (n - 1) * chain + 15 * n + 2 * n * chain + 1


# predicted in PERF.md section 5 before the first run, measured there after:
# the Test log against the meshless run's, each value relative (SSIM of
# seeded weights is ~0.02, so a few pixels one gray level off move it by
# ~1e-6 absolute), and the gathered SR frame of the first item against the
# meshless forward's, relative to its largest value
TOL_ZOO_LOG = 1e-4
TOL_ZOO_SR = 1e-5
# one step of a train YAML on the spatial mesh against world 1, both from
# the same checkpoint, twice: with the YAML's Adam and with SGD (phases 27
# and 34's optimizer).  The SGD step bounds the train loss, the valid loss of
# the stepped net, the stepped parameters (the largest difference relative
# to the largest parameter) and the BatchNorm running statistics (phase 27's
# bound).  Its update in norm is printed only: the stepped parameters'
# fp32 rounding (~1e-9 an element) weighs against lr times the gradient (the
# CPU rehearsal: DUF's 2.1e-4 apart with its gradients 8.9e-7 apart).  The Adam step bounds
# the losses, the statistics and the step's gradient, read back from Adam's
# first moment in each checkpoint (exp_avg = (1 - beta1)·g after one step),
# relative in norm; not its parameters: Adam's first step moves an element
# by lr·g/(|g| + 1e-8), so an element whose gradient is near 1e-8 (a sum
# whose terms cancel; a direction a training BatchNorm leaves flat) carries
# the rounding of g into the step at up to 1/4 of its error over 1e-8 (an
# H100 run: SRFB's losses bit-equal, its update 2.8e-4 apart in norm and
# 0.108 lr in one element; PERF.md section 5).
TOL_ZOO_STEP = 1e-5
ZOO_SGD_LR = 1e-2
# the Adam step's gradient against world 1's, relative in norm.  DUF's is
# wider than SRFB's: world 1 normalises with ATen's BatchNorm, the spatial
# ranks with the reduced one of models/common.py, and each fp32 backward
# differs from the float64 gradient (duf_batch_norm_precision measures both
# on the card: 9.084e-4 and 9.961e-4 on an H100 80GB HBM3 at 700 W, the two
# 7.526e-4 apart); two gradients each within those of float64 are within
# their sum, 1.9e-3, of each other (measured 4.591e-4)
TOL_ZOO_GRAD = {"SRFBNet": 1e-4, "DUFNet": 2e-3}


def zoo_eval_config(tree: dict, name: str, ckpt: Path, saved_dir: Path, dev) -> dict:
    """The shipped test YAML of ``name``'s family on the tree, on ``dev``."""
    family, predictor = ZOO_NETS[name]
    kwargs = zoo_net(name)[0]
    if family == "sisr":
        cfg = sisr_eval_config(tree, "SRFBNet" if name == "DRFSISRNet" else name, ckpt, saved_dir)
    elif family == "misr":
        cfg = misr_eval_config(tree, name, kwargs, ckpt, saved_dir)
    else:
        cfg = vsr_eval_config(tree, name, kwargs, ckpt, saved_dir, dev)
    cfg["net"] = {"name": name, "kwargs": kwargs}
    cfg["predictor"]["name"] = predictor
    cfg["predictor"]["kwargs"]["device"] = str(dev)
    return cfg


def zoo_train_config(tree: dict, name: str, start: Path, saved_dir: Path, dev) -> dict:
    """train/{srfb_net,duf_net}/exp1_x4.yaml on a tree of one batch from
    the weights of ``start``: one epoch of one step, its valid clip, a
    checkpoint."""
    cfg = (sisr_train_config(tree, name, saved_dir) if name == "SRFBNet"
           else misr_train_config(tree, name, saved_dir))
    cfg.pop("logger", None)
    cfg["main"]["loaded_path"] = str(start)
    cfg["trainer"]["kwargs"].update(device=str(dev), num_epochs=1)
    return cfg


def _first_sr(pred):
    """The scored output of the predictor's first item, rows gathered."""
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
        gather_rows,
    )

    batch = next(iter(pred.test_dataloader))
    inputs, axis = pred._shard_rows(pred._model_inputs(batch))
    with torch.inference_mode():
        out = pred._forward(*(pred._to_device(x) for x in inputs))
        return gather_rows(out, axis).float().cpu()


def spatial_zoo_rank(eval_cfgs: dict, train_cfgs: dict, device: str) -> dict:
    """Phases 35 and 36's rank: ``SPATIAL`` gloo ranks on cuda:0 as one spatial
    group; each net's test YAML through ``main.test_from_config`` and its
    first item's gathered SR; then one step of each train YAML through
    ``main.train_from_config``.  Rank 0's results come back."""
    import torch

    sys.path.insert(0, str(REPO))
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import main as port_main
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        deform_conv,
        lstm_gates,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
        halo,
        mesh as mesh_mod,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic_cudnn(torch)
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {"backend": torch.distributed.get_backend(), "eval": {}, "train": {}}

    def path(fn):
        """``fn()`` with the kernels' counts, the halo exchanges and gathers
        and the DCN's spatial calls set to 0 just before it and read just
        after it → (its result, its record)."""
        reset_launches(lstm_gates)
        deform_conv.reset_launches()
        halo.reset_exchanges()
        deform_conv.SPATIAL_CALLS.update(band=0, frame=0)
        mesh_mod._WARNED.clear()
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        return result, {"wall_s": time.perf_counter() - t0, "exchanges": dict(halo.EXCHANGES),
                        "gathers": dict(halo.GATHERS), "dcn_calls": dict(deform_conv.SPATIAL_CALLS),
                        "launches": launches(lstm_gates), "dcn_launches": dcn_launches(deform_conv),
                        "warned": sorted(k[0] for k in mesh_mod._WARNED)}

    for name, cfg in eval_cfgs.items():
        pred, record = path(lambda: port_main.test_from_config(Cfg(cfg)))
        record.update(log=pred.log, mesh=dict(pred.mesh.shape), frames=pred.throughput["frames"],
                      item_ms=[x * 1e3 for x in pred.item_seconds], sr=_first_sr(pred),
                      telemetry=pred.telemetry_summary)
        out["eval"][name] = record
        del pred
    for name, cfg in train_cfgs.items():
        trainer, record = path(lambda: port_main.train_from_config(Cfg(cfg)))
        record.update(history=trainer.history, mesh=dict(trainer.mesh.shape),
                      steps_per_sec=trainer.throughput.get("train_steps_per_sec"))
        out["train"][name] = record
        del trainer
    return out


def duf_batch_norm_precision(ckpt: Path, dev) -> dict:
    """DUF's training gradient on the card through each BatchNorm path of
    phase 35's Adam step, against the same gradient in float64 (ATen's
    BatchNorm): world 1's ATen BatchNorm and the spatial ranks' reduced one
    (``models/common.global_batch_norm``, here in a group of one), both in
    fp32 without TF32, on one train batch of the DUF YAML's shape (12
    windows of 7 LR frames 32x32, seeded) with its Huber loss → each path's
    gradient relative to the float64 one in norm, and to each other."""
    import torch
    import torch.distributed as dist

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import (
        losses as port_losses,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import DUFNet
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.common import (
        batch_norm_group,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import distributed
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
        load_checkpoint,
    )

    batch = MISR_TRAIN["DUFNet"][0]
    gen = torch.Generator().manual_seed(35)
    lr = torch.randn(batch, MISR_T, PATCH, PATCH, 1, generator=gen)
    hr = torch.randn(batch, PATCH * SCALE, PATCH * SCALE, 1, generator=gen)
    loss_fn = port_losses.HuberLoss(delta=0.01)
    state = load_checkpoint(ckpt)["net"]

    def gradient(dtype, group=None):
        net = DUFNet(**MISR_NETS["DUFNet"]).to(dev)
        net.load_state_dict(state)
        net = net.to(dtype).train()
        with batch_norm_group(group):
            loss = loss_fn(net(lr.to(dev, dtype)), hr.to(dev, dtype))
        loss.backward()
        return torch.cat([p.grad.flatten().double() for p in net.parameters()])

    g64 = gradient(torch.float64)
    aten = gradient(torch.float32)
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://localhost:{distributed.free_port()}")
    try:
        reduced = gradient(torch.float32, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    out = {"aten_fp32_vs_fp64": ((aten - g64).norm() / g64.norm()).item(),
           "reduced_fp32_vs_fp64": ((reduced - g64).norm() / g64.norm()).item(),
           "aten_vs_reduced": ((aten - reduced).norm() / reduced.norm()).item()}
    log("spatial zoo", f"DUF's training gradient (batch {batch}, full width) in fp32 against "
                       f"float64, relative in norm: world 1's ATen BatchNorm "
                       f"{out['aten_fp32_vs_fp64']:.3e}, the reduced BatchNorm of the spatial "
                       f"ranks {out['reduced_fp32_vs_fp64']:.3e}; the two apart "
                       f"{out['aten_vs_reduced']:.3e} (the Adam step's bound "
                       f"{TOL_ZOO_GRAD['DUFNet']})")
    return out


def spatial_zoo_card(port_main, Cfg, lstm_gates, dcn, tmp: Path, dev, card_line) -> dict:
    """Phase 35: the spatial axis of the zoo (height sharded over ``SPATIAL``
    gloo ranks sharing cuda:0): each net's test YAML at full width against
    its meshless run on the same items, and one step of the SRFB and DUF
    train YAMLs against the same step at world 1."""
    import numpy as np
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import distributed
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
        load_checkpoint,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.synthetic_tree import (
        write_acdc_tree,
    )

    parallel = {"num_devices": SPATIAL, "spatial_parallel": SPATIAL}
    tree = write_acdc_tree(tmp / "zoo", {"test": (1, 1)}, cycle=ZOO_CYCLE, hr=HR, scale=SCALE)
    before = deterministic_cudnn(torch)  # the meshless runs as the ranks run
    eval_cfgs, meshless, starts = {}, {}, {}
    for name, (family, _) in ZOO_NETS.items():
        kwargs, items = zoo_net(name)
        ckpt = tmp / f"{name}.pth"  # phases 13, 15 and 17 wrote most of them
        if name == "Bicubic":
            ckpt = tmp / "no_checkpoint.pth"
        elif not ckpt.exists():
            make = seeded_misr_net if family == "misr" else (
                lambda cls, kw: cls(**kw, generator=torch.Generator().manual_seed(0)))
            torch.save({"net": make(getattr(models, name), kwargs).state_dict()}, ckpt)
        starts[name] = ckpt
        cfg = zoo_eval_config(tree, name, ckpt, tmp / f"zoo_meshless_{name}", dev)
        pred = port_main.test_from_config(Cfg(cfg))
        if pred.throughput["frames"] != items * (ZOO_CYCLE if family == "vsr" else 1):
            raise AssertionError(f"{name}: the meshless run scored {pred.throughput['frames']}")
        meshless[name] = {"log": pred.log, "sr": _first_sr(pred),
                          "item_ms": [x * 1e3 for x in pred.item_seconds]}
        del pred
        cfg = zoo_eval_config(tree, name, ckpt, tmp / f"zoo_spatial_{name}", dev)
        cfg["parallel"] = parallel
        eval_cfgs[name] = cfg
    train_cfgs, reference = {}, {}
    # a tree of one batch each (SRFB 16 frames, DUF 12 windows); its valid
    # clip as long; the YAML's Adam step, then an SGD step
    batches = {"SRFBNet": TRAIN_BATCH, "DUFNet": MISR_TRAIN["DUFNet"][0]}
    for name in ZOO_TRAIN:
        items = batches[name]
        small = write_acdc_tree(tmp / f"zoo_train_{name}", {"train": (1, 1), "valid": (1, 1)},
                                cycle=items, hr=HR, scale=SCALE, seed=35)
        for key in (name, f"{name}_sgd"):
            cfgs = [zoo_train_config(small, name, starts[name], tmp / f"zoo_train_{key}_{where}",
                                     dev) for where in ("world1", "spatial")]
            if key.endswith("_sgd"):
                for cfg in cfgs:
                    cfg["optimizer"] = {"name": "SGD", "kwargs": {"lr": ZOO_SGD_LR}}
            trainer = port_main.train_from_config(Cfg(cfgs[0]))
            ckpt = load_checkpoint(tmp / f"zoo_train_{key}_world1" / "checkpoints" / "model_1.pth")
            reference[key] = {"history": trainer.history, "state": ckpt["net"],
                              "optimizer": ckpt["optimizer"]}
            del trainer
            cfgs[1]["parallel"] = parallel
            train_cfgs[key] = cfgs[1]
    deterministic_cudnn(torch, before[0])
    torch.backends.cudnn.benchmark = before[1]
    t0 = time.perf_counter()
    ranks = distributed.spawn(spatial_zoo_rank, (eval_cfgs, train_cfgs, str(dev)),
                              world=SPATIAL, device=dev, backend="gloo")
    wall = time.perf_counter() - t0
    note = f"{SPATIAL} gloo ranks sharing one card: correctness only, no rate ({card_line})"
    if ranks["backend"] != "gloo":
        raise AssertionError(f"phase 35 ran over {ranks['backend']}")

    results = {"eval": {}, "train": {}}
    for name in ZOO_NETS:
        kwargs, items = zoo_net(name)
        got, want = ranks["eval"][name], meshless[name]
        log_rel = max(abs(got["log"][k] - v) / abs(v) for k, v in want["log"].items())
        scale = want["sr"].abs().max().item()
        sr_rel = (got["sr"] - want["sr"]).abs().max().item() / scale
        per_item = zoo_exchanges(name, kwargs, ZOO_CYCLE)
        want_exchanges = {"forward": per_item * items, "backward": 0}
        # the median of the warm items (of both clips when there are two)
        ms, ms_meshless = (float(np.median(x[1:] or x)) for x in (got["item_ms"], want["item_ms"]))
        log("spatial zoo", f"{name} x{SCALE} on mesh {got['mesh']}: {items} items, Test log "
                           f"{got['log']}; largest relative difference to the meshless log "
                           f"{log_rel:.3e} (tol {TOL_ZOO_LOG}); the first item's gathered SR "
                           f"{tuple(got['sr'].shape)} within {sr_rel:.3e} of the meshless "
                           f"forward's largest value (tol {TOL_ZOO_SR}); halo exchanges "
                           f"{got['exchanges']} ({per_item} an item predicted); gate launches "
                           f"{got['launches']}, DCN launches {got['dcn_launches']}; median "
                           f"{ms:.1f} ms an item (meshless {ms_meshless:.1f}); {note}")
        if got["mesh"] != {"data": 1, "spatial": SPATIAL} or got["warned"]:
            raise AssertionError(f"{name} ran on {got['mesh']}, warned {got['warned']}")
        if not (log_rel <= TOL_ZOO_LOG and sr_rel <= TOL_ZOO_SR):
            raise AssertionError(f"{name} on the spatial mesh disagrees: {log_rel}, {sr_rel}")
        if got["exchanges"] != want_exchanges or any(got["launches"]) or any(got["dcn_launches"]):
            raise AssertionError(f"{name} exchanged {got['exchanges']} (predicted "
                                 f"{want_exchanges}), launched {got['launches']}, "
                                 f"{got['dcn_launches']}")
        results["eval"][name] = {"log_rel": log_rel, "sr_rel": sr_rel,
                                 "exchanges": got["exchanges"], "item_ms": ms,
                                 "meshless_item_ms": ms_meshless, "items": items,
                                 "launches": got["launches"], "dcn_launches": got["dcn_launches"]}
    for key in train_cfgs:
        name, sgd = key.removesuffix("_sgd"), key.endswith("_sgd")
        items = batches[name]
        got, want = ranks["train"][key], reference[key]
        ckpt = load_checkpoint(tmp / f"zoo_train_{key}_spatial" / "checkpoints" / "model_1.pth")
        state, got_opt = ckpt["net"], ckpt["optimizer"]
        loss_rel = {split: abs(got["history"][split][0]["Loss"] - want["history"][split][0]["Loss"])
                    / abs(want["history"][split][0]["Loss"]) for split in ("train", "valid")}
        lr = train_cfgs[key]["optimizer"]["kwargs"]["lr"]
        start = load_checkpoint(starts[name])["net"]
        floats = [k for k, v in want["state"].items() if v.is_floating_point()]
        params = [k for k in floats if "running" not in k]
        gap = torch.cat([(state[k] - want["state"][k]).flatten() for k in params])
        update = torch.cat([(want["state"][k] - start[k]).flatten() for k in params])
        update_rel = (gap.norm() / update.norm()).item()
        param_lr = gap.abs().max().item() / lr
        # the largest parameter difference relative to the largest parameter
        # (not each tensor's own largest element: a BatchNorm bias steps by
        # an ill-conditioned sum of terms that cancel, whose rounding is
        # large against its own ~1e-6 value)
        param_rel = (gap.abs().max() / max(want["state"][k].abs().max() for k in params)).item()
        stats_rel = max([((state[k] - want["state"][k]).abs().max()
                          / want["state"][k].abs().max().clamp_min(1e-12)).item()
                         for k in floats if "running" in k], default=0.0)
        per_item = zoo_exchanges(name, zoo_net(name)[0], items)
        # the step's forward and backward (the LR input carries no gradient:
        # the LR conv and the skip, or the head and the unfold), then the
        # valid epoch's forwards
        want_exchanges = {"forward": per_item * (1 + items), "backward": per_item - 2}
        step_ms = 1e3 / got["steps_per_sec"]
        if sgd:
            what = (f"parameters within {param_rel:.3e} of the largest parameter (tol "
                    f"{TOL_ZOO_STEP}; SGD at {lr}), the update (lr times the gradient) "
                    f"{update_rel:.3e} apart in norm (not bounded: the fp32 rounding of the "
                    f"stepped parameters, ~1e-9 an element, weighs against a small update)")
            ok = param_rel <= TOL_ZOO_STEP
            grad_rel = None
        else:
            grads = [torch.cat([m["exp_avg"].flatten() for _, m in sorted(opt["state"].items())])
                     for opt in (got_opt, want["optimizer"])]
            grad_rel = ((grads[0] - grads[1]).norm() / grads[1].norm()).item()
            what = (f"the step's gradient within {grad_rel:.3e} of world 1's in norm (tol "
                    f"{TOL_ZOO_GRAD[name]}); its Adam update {update_rel:.3e} apart in norm "
                    f"(|update| {update.norm().item():.4g}), {param_lr:.3e} of the learning rate "
                    f"{lr} in its largest element (not bounded)")
            ok = grad_rel <= TOL_ZOO_GRAD[name]
        log("spatial zoo", f"one {'SGD' if sgd else 'Adam'} step of {name}'s train YAML (batch "
                           f"{items}) on mesh {got['mesh']}: train and valid loss relative to "
                           f"world 1's {loss_rel['train']:.3e}, {loss_rel['valid']:.3e}, running "
                           f"statistics {stats_rel:.3e} of their largest element (tol "
                           f"{TOL_ZOO_STEP}); {what}; halo exchanges {got['exchanges']} "
                           f"(predicted {want_exchanges}); {step_ms:.1f} ms a step, the epoch "
                           f"with its valid clip {got['wall_s']:.2f} s; {note}")
        if got["mesh"] != {"data": 1, "spatial": SPATIAL} or got["warned"]:
            raise AssertionError(f"{key}'s step ran on {got['mesh']}, warned {got['warned']}")
        if not (max(*loss_rel.values(), stats_rel) <= TOL_ZOO_STEP and ok):
            raise AssertionError(f"{key}'s step disagrees with world 1: {loss_rel}, {stats_rel}, "
                                 f"{param_rel if sgd else grad_rel}")
        if got["exchanges"] != want_exchanges or any(got["launches"]) or any(got["dcn_launches"]):
            raise AssertionError(f"{key}'s step exchanged {got['exchanges']} (predicted "
                                 f"{want_exchanges}), launched {got['launches']}")
        results["train"][key] = {"loss_rel": loss_rel, "stats_rel": stats_rel,
                                 "grad_rel": grad_rel, "param_rel": param_rel,
                                 "update_rel": update_rel, "param_lr": param_lr,
                                 "exchanges": got["exchanges"], "step_ms": step_ms,
                                 "launches": got["launches"], "dcn_launches": got["dcn_launches"]}
    results["duf_batch_norm"] = duf_batch_norm_precision(starts["DUFNet"], dev)
    log("spatial zoo", f"phase 35 in {wall:.1f} s with the ranks' start")
    results.update(wall_s=wall, card=card_line)
    return results


# ------------------- 36 the spatial axis of the warping and deformable nets
def _resize_count(in_rows: int, out_rows: int, align_corners: bool, kind: str,
                  spatial: int) -> tuple[int, int]:
    """(exchanges, gathers) of one band resize of a frame of ``in_rows`` rows
    to ``out_rows``: a halo, or the frame gathered whole when the halo
    exceeds a band (``ops/resize.band_plan``)."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops.resize import (
        band_plan,
    )

    return (1, 0) if band_plan(in_rows, out_rows, align_corners, kind, spatial)[0] is not None \
        else (0, 1)


def _window_count(rows: int, window: int | None, spatial: int) -> tuple[int, int]:
    """(exchanges, gathers) of a warp or a DCN over a frame of ``rows`` rows
    whose band reads ``window`` rows past its own (None: unbounded): a halo
    while the band can lend it, else the frame gathered whole."""
    return (1, 0) if window is not None and window <= rows // spatial else (0, 1)


def video_counts(name: str, kwargs: dict, lr_hw: tuple[int, int], frames: int, spatial: int,
                 train: bool = False) -> dict:
    """The halo exchanges and whole-frame gathers (``parallel/halo``'s
    ``EXCHANGES`` and ``GATHERS``) of one forward of TOFlowNet, FRVSRNet or
    EDVRNet over an item (a window; FRVSR a clip of ``frames``) of LR
    ``lr_hw`` on ``spatial`` ranks, and with ``train`` of the training
    forward and its backward → {"forward": (exchanges, gathers),
    "backward": (...)}.  One exchange a conv with an H window, one a pool
    pair, one a band resize (or a gather, ``_resize_count``), one a warp or
    a DCN (a gather when unbounded or wider than a band,
    ``_window_count``); a backward for each of those whose input carries a
    gradient (not the LR input's, not a warp's image)."""
    S = spatial
    fwd, bwd = [0, 0], [0, 0]

    def add(acc, counts, n=1):
        acc[0] += counts[0] * n
        acc[1] += counts[1] * n

    conv = (1, 0)
    h, w = lr_hw
    if name == "TOFlowNet":
        from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops.warp import (
            _ceil_div,
        )

        r, R = kwargs["upscale_factor"], kwargs.get("max_flow")
        H, W = (-(-v * r // 16) * 16 for v in (h, w))

        def warp(rows, cols):
            if R is None:
                return (0, 1)
            win = max(_ceil_div(2 * R * cols + cols - 1, 2 * cols - 2),
                      _ceil_div(2 * R * rows + rows - 1, 2 * rows - 2))
            return _window_count(rows, win, S)

        calls = kwargs["num_frames"] - 1 if train else 1  # SpyNet per neighbour, or batched
        add(fwd, _resize_count(h, h * r, False, "cubic", S))
        for level in range(4):
            rows = H // 8 * 2 ** level
            up = _resize_count(rows // 2, rows, True, "linear", S)
            add(fwd, up, calls)
            add(fwd, warp(rows, W // 8 * 2 ** level), calls)
            add(fwd, conv, 5 * calls)
            if train:  # level 0's flow, warp and first conv read no gradient
                add(bwd, up, calls if level else 0)
                add(bwd, conv, (5 if level else 4) * calls)
        add(fwd, warp(H, W), calls)
        add(fwd, conv, 2)
        if train:
            add(bwd, conv, 2)
    elif name == "FRVSRNet":
        r, R, n = kwargs["upscale_factor"], kwargs.get("max_flow"), kwargs["num_resblocks"]
        lh = -(-h // 8) * 8
        window = None if R is None else R + 1
        step, back = [0, 0], [0, 0]
        add(step, conv, 14)  # FNet
        add(back, conv, 13)  # its first conv reads the LR pair
        for k in (8, 4, 2):
            add(step, _resize_count(lh // k, lh // k * 2, False, "linear", S))
            add(back, _resize_count(lh // k, lh // k * 2, False, "linear", S))
        add(step, _resize_count(h, h * r, True, "linear", S))
        add(back, _resize_count(h, h * r, True, "linear", S))
        add(step, _window_count(h * r, window, S))  # the SR warp (a detached frame)
        add(step, _window_count(h, window, S))  # the LR warp (the input frame)
        add(step, conv, 4 + 2 * n)  # SRNet: head, the blocks, two deconvs, tail
        add(back, conv, 4 + 2 * n)
        add(fwd, step, frames)
        if train:
            add(bwd, back, frames)
    elif name == "EDVRNet":
        R, N = kwargs.get("dcn_max_offset"), kwargs["nframes"]
        lh = -(-h // 4) * 4
        window = None if R is None else R + 2
        body = [0, 0]
        add(body, conv, 4 + 2 * kwargs["front_RBs"])  # after conv_first: RBs, L2, L3
        for k in (4, 2, 1):  # PCD: L3, L2, L1, then the cascade at L1
            add(body, conv, (3 if k == 4 else 5) * N)
            add(body, _window_count(lh // k, window, S), N)
            if k < 4:  # the coarser offsets and features upsampled
                add(body, _resize_count(lh // k // 2, lh // k, False, "linear", S), 2 * N)
        add(body, conv, 3 * N)
        add(body, _window_count(lh, window, S), N)
        if kwargs.get("w_TSA", True):  # 6 convs, 2 pool pairs, 2 resizes
            add(body, conv, 8)
            add(body, _resize_count(lh // 4, lh // 2, False, "linear", S))
            add(body, _resize_count(lh // 2, lh, False, "linear", S))
        add(body, conv, 2 * kwargs["back_RBs"] + 4)
        add(fwd, conv)  # conv_first
        add(fwd, body)
        add(fwd, _resize_count(h, h * 4, False, "linear", S))  # the centre frame's base
        if train:
            add(bwd, body)
    else:
        raise ValueError(name)
    out = {"forward": tuple(fwd)}
    if train:
        out["backward"] = tuple(bwd)
    return out


# the nets of phases 15, 17 and 20 at full width with their seeded weights,
# each test YAML and its _tpu knobs (bf16, max_flow 4 / dcn_max_offset 2),
# on phase 35's tree (one slice of ZOO_CYCLE frames, LR 64x64): key → (net,
# kwargs, family, predictor knobs)
VIDEO_NETS = {
    "TOFlowNet": ("TOFlowNet", MISR_NETS["TOFlowNet"], "misr", {}),
    "TOFlowNet_tpu": ("TOFlowNet", TOFLOW_TPU_NET, "misr", {"compute_dtype": "bfloat16"}),
    "FRVSRNet": ("FRVSRNet", {**VSR_NETS["FRVSRNet"], "is_prediction": True}, "vsr", {}),
    "FRVSRNet_tpu": ("FRVSRNet", {**VSR_NETS["FRVSRNet"], "is_prediction": True, "max_flow": 4},
                     "vsr", {"compute_dtype": "bfloat16"}),
    "EDVRNet": ("EDVRNet", EDVR_NET, "edvr", {}),
    "EDVRNet_tpu": ("EDVRNet", {**EDVR_NET, "dcn_max_offset": EDVR_TPU_R}, "edvr",
                    {"compute_dtype": "bfloat16"}),
}
# one SGD step of each family's train YAML (edvr_net/exp1_x4_tpu.yaml too)
# from the same weights, on a tree of one batch of 16 windows or clips
VIDEO_TRAIN = ("TOFlowNet", "FRVSRNet", "EDVRNet", "EDVRNet_tpu")
VIDEO_TRAIN_ITEMS = 16
# every run's Test log within TOL_ZOO_LOG of its meshless run's, and its
# first SR within TOL_ZOO_SR, but the bf16 runs' SSIMs (absolute: a
# CardiacSSIM can be ~0.02) and FRVSR _tpu's SR.  A band's conv on the card
# picks its own cuDNN algorithm, which sums in another order; bf16 rounds
# the difference to a last bit now and then, and FRVSR's recurrence warps
# each SR frame into the next.  Readings on an H100 80GB HBM3 at 700 W
# (tools/spatial_fault_probe.py), sound and with the halo rows of every
# windowed warp and DCN band zeroed: the bf16 logs 1.4e-7 / 1.2e-5 / 0
# against 3.4e-6 / 3.0e-5 / 2.5e-7 (TOFlow / FRVSR / EDVR; the SSIMs
# absolute), the SRs 1.2e-7 / 2.5e-2 / 7.2e-8 against 4.1e-3 / 2.1e-1 /
# 6.9e-5: the SR bounds lie between, the log bounds do not see the fault
TOL_VIDEO_BF16_SSIM = 1e-4
TOL_VIDEO_FRVSR_BF16_SR = 5e-2
# the windowed runs' telemetry against the meshless run's: the same sample
# counts; the share out of the window and the largest displacement from
# flows computed by other cuDNN algorithms (exact on the CPU)
TOL_VIDEO_TELEMETRY = 1e-3
# the bf16 train step (EDVR's _tpu YAML: bf16, grad_accum_steps 2) against
# world 1's: losses and parameters
TOL_VIDEO_BF16_STEP = 1e-3

def video_eval_config(tree: dict, key: str, ckpt: Path, saved_dir: Path, dev) -> dict:
    name, kwargs, family, knobs = VIDEO_NETS[key]
    if family == "vsr":
        cfg = vsr_eval_config(tree, name, kwargs, ckpt, saved_dir, dev, **knobs)
    elif family == "edvr":
        cfg = misr_eval_config(tree, name, kwargs, ckpt, saved_dir, num_frames=EDVR_T,
                               loss=EDVR_LOSS, **knobs)
    else:
        cfg = misr_eval_config(tree, name, kwargs, ckpt, saved_dir, **knobs)
    cfg["predictor"]["kwargs"]["device"] = str(dev)
    return cfg


def video_train_config(tree: dict, key: str, start: Path, saved_dir: Path, dev) -> dict:
    """The train YAML of ``key``'s family on a tree of one batch from the
    weights of ``start``: one epoch of one SGD step, its valid clip."""
    if key.startswith("EDVRNet"):
        cfg = edvr_train_config(tree, key, saved_dir)
    elif key == "FRVSRNet":
        cfg = vsr_train_config(tree, key, saved_dir, dev)
    else:
        cfg = misr_train_config(tree, key, saved_dir)
    cfg.pop("logger", None)
    cfg["main"]["loaded_path"] = str(start)
    cfg["trainer"]["kwargs"].update(device=str(dev), num_epochs=1)
    cfg["optimizer"] = {"name": "SGD", "kwargs": {"lr": ZOO_SGD_LR}}
    return cfg


def _video_train_kwargs(key: str) -> dict:
    """The net of ``key``'s train YAML."""
    return {"TOFlowNet": MISR_NETS["TOFlowNet"], "FRVSRNet": VSR_NETS["FRVSRNet"],
            "EDVRNet": EDVR_NET, "EDVRNet_tpu": {**EDVR_NET, "dcn_max_offset": EDVR_TPU_R}}[key]


def dcn_row_origin(dcn, dev, card_line) -> dict:
    """Phase 36's kernels check: the three DCN kernels on rank 1 of 4 bands
    of EDVR's serving L1 frame (1, 128, 64, 64) in fp32 and bf16: on the
    band with its R + 2 window rows above and below (``dcn_max_offset`` 2,
    pad_h = 1 - 4) and on the whole frame read from the band's first row
    (exact, pad_h = 1 - 16), each against its plain version at that geometry
    and against the whole frame's call cut to the band's rows."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(36)
    shape, S, i = DCN_SHAPES["serving"], 4, 1
    B, C, H, W = shape
    rows = H // S
    r0 = i * rows
    errors = {k: {} for k in dcn.KERNELS}

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()

    for dtype, tol in ((torch.float32, TOL_DCN_FP32), (torch.bfloat16, TOL_DCN_BF16)):
        for case, R in (("band", EDVR_TPU_R), ("frame", None)):
            x, off, mask, grad_col, g = dcn_operands(dcn, shape, dtype, dev, gen, "fractional", R)
            band = slice(r0, r0 + rows)
            off_b, mask_b = off[:, :, band].contiguous(), mask[:, :, band].contiguous()
            gc_b = grad_col.view(B, C * 9, H, W)[:, :, band].reshape(B, C * 9, rows * W)
            if case == "band":
                k = R + 2
                xb = x[:, :, r0 - k:r0 + rows + k].contiguous()
                pad_h = 1 - k
            else:
                xb, pad_h = x, 1 - r0
            gb = dcn.geometry(xb.shape, 3, 3, 1, 1, 1, DCN_DG, R, pad_h=pad_h, out_h=rows)
            got = {"deform_im2col": dcn.deform_im2col(xb, off_b, mask_b, gb),
                   "deform_col2im": dcn.deform_col2im(gc_b, off_b, mask_b, gb),
                   "deform_col2im_coord": dcn.deform_col2im_coord(gc_b, xb, off_b, mask_b, gb)}
            want = {"deform_im2col": dcn.deform_im2col_reference(xb, off_b, mask_b, gb),
                    "deform_col2im": dcn.deform_col2im_reference(gc_b, off_b, mask_b, gb),
                    "deform_col2im_coord": dcn.deform_col2im_coord_reference(
                        gc_b, xb, off_b, mask_b, gb)}
            # the whole frame's im2col cut to the band: the same samples
            whole = dcn.deform_im2col(x, off, mask, g).view(B, C * 9, H, W)[:, :, band]
            cut = rel(got["deform_im2col"].view(B, C * 9, rows, W), whole)
            for name in dcn.KERNELS:
                pairs = list(zip(*(v if isinstance(v, tuple) else (v,)
                                   for v in (got[name], want[name]))))
                err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
                r = max(rel(a, b) for a, b in pairs)
                errors[name][f"{case} {dtype}"] = err
                log("spatial video", f"{name} {dtype} on the {case} of rank {i} of {S} "
                                     f"(x {tuple(xb.shape)}, pad_h {pad_h}, Ho {rows}, R {R}): "
                                     f"max abs err {err:.3e} against its plain version, {r:.3e} "
                                     f"of the largest element (tol {tol})")
                if not r <= tol:
                    raise AssertionError(f"{name} at a row origin disagrees: {case} {dtype} {r}")
            log("spatial video", f"deform_im2col {dtype} on the {case}: against the whole "
                                 f"frame's call cut to the band's rows {cut:.3e} (tol {tol})")
            if not cut <= tol:
                raise AssertionError(f"the {case}'s im2col is not the frame's: {cut}")
            errors["deform_im2col"][f"{case} {dtype} against the frame"] = cut
    return {"errors": errors, "card": card_line}


def spatial_video_card(port_main, Cfg, lstm_gates, dcn, tmp: Path, dev, card_line) -> dict:
    """Phase 36: the spatial axis of TOFlowNet, FRVSRNet and EDVRNet (height
    sharded over ``SPATIAL`` gloo ranks sharing cuda:0): each test YAML and
    its _tpu knobs at full width against its meshless run on the same
    items, the exchanges and gathers ``video_counts`` predicts, and one SGD
    step of each family's train YAML against the same step at world 1; the
    DCN kernels at a row origin first (``dcn_row_origin``)."""
    import numpy as np
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import distributed
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
        load_checkpoint,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.synthetic_tree import (
        write_acdc_tree,
    )

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import models

    kernels = dcn_row_origin(dcn, dev, card_line)
    parallel = {"num_devices": SPATIAL, "spatial_parallel": SPATIAL}
    tree = write_acdc_tree(tmp / "zoo", {"test": (1, 1)}, cycle=ZOO_CYCLE, hr=HR, scale=SCALE)
    before = deterministic_cudnn(torch)  # the meshless runs as the ranks run
    eval_cfgs, meshless, starts = {}, {}, {}
    for key, (name, kwargs, family, _) in VIDEO_NETS.items():
        ckpt = tmp / f"{name}.pth"  # phases 15, 17 and 20 wrote them
        if not ckpt.exists():
            net = {"EDVRNet": lambda: seeded_edvr(EDVR_NET),
                   "TOFlowNet": lambda: seeded_misr_net(models.TOFlowNet, MISR_NETS[name]),
                   "FRVSRNet": lambda: models.FRVSRNet(
                       **VSR_NETS[name], generator=torch.Generator().manual_seed(0))}[name]()
            torch.save({"net": net.state_dict()}, ckpt)
        starts[key] = ckpt
        pred = port_main.test_from_config(Cfg(video_eval_config(
            tree, key, ckpt, tmp / f"video_meshless_{key}", dev)))
        meshless[key] = {"log": pred.log, "sr": _first_sr(pred), "telemetry": pred.telemetry_summary,
                         "item_ms": [x * 1e3 for x in pred.item_seconds],
                         "frames": pred.throughput["frames"]}
        del pred
        cfg = video_eval_config(tree, key, ckpt, tmp / f"video_spatial_{key}", dev)
        cfg["parallel"] = parallel
        eval_cfgs[key] = cfg
    train_cfgs, reference, small = {}, {}, {}
    for key in VIDEO_TRAIN:
        family = "edvr" if key.startswith("EDVR") else key
        if family not in small:
            small[family] = write_acdc_tree(tmp / f"video_train_{family}",
                                            {"train": (1, 1), "valid": (1, 1)},
                                            cycle=VIDEO_TRAIN_ITEMS, hr=HR, scale=SCALE, seed=36)
        start = starts[key]
        cfg = video_train_config(small[family], key, start, tmp / f"video_train_{key}_world1", dev)
        trainer = port_main.train_from_config(Cfg(cfg))
        ckpt = load_checkpoint(tmp / f"video_train_{key}_world1" / "checkpoints" / "model_1.pth")
        reference[key] = {"history": trainer.history, "state": ckpt["net"]}
        del trainer
        cfg = video_train_config(small[family], key, start, tmp / f"video_train_{key}_spatial",
                                 dev)
        cfg["parallel"] = parallel
        train_cfgs[key] = cfg
    deterministic_cudnn(torch, before[0])
    torch.backends.cudnn.benchmark = before[1]
    t0 = time.perf_counter()
    ranks = distributed.spawn(spatial_zoo_rank, (eval_cfgs, train_cfgs, str(dev)),
                              world=SPATIAL, device=dev, backend="gloo")
    wall = time.perf_counter() - t0
    note = f"{SPATIAL} gloo ranks sharing one card: correctness only, no rate ({card_line})"
    if ranks["backend"] != "gloo":
        raise AssertionError(f"phase 36 ran over {ranks['backend']}")

    def log_gap(got_log, want_log, bf16):
        worst = {}
        for k, v in want_log.items():
            d = abs(got_log[k] - v)
            worst[k] = d if bf16 and "SSIM" in k else d / abs(v)
        ok = all(d <= (TOL_VIDEO_BF16_SSIM if bf16 and "SSIM" in k else TOL_ZOO_LOG)
                 for k, d in worst.items())
        return worst, ok

    results = {"eval": {}, "train": {}, "kernels": kernels}
    lr_hw = (HR // SCALE, HR // SCALE)
    for key, (name, kwargs, family, knobs) in VIDEO_NETS.items():
        got, want = ranks["eval"][key], meshless[key]
        bf16 = "compute_dtype" in knobs
        gaps, log_ok = log_gap(got["log"], want["log"], bf16)
        scale = want["sr"].abs().max().item()
        sr_rel = (got["sr"] - want["sr"]).abs().max().item() / scale
        sr_tol = TOL_VIDEO_FRVSR_BF16_SR if bf16 and name == "FRVSRNet" else TOL_ZOO_SR
        items = 1 if family == "vsr" else ZOO_CYCLE
        counts = video_counts(name, kwargs, lr_hw, ZOO_CYCLE if family == "vsr" else 0, SPATIAL)
        want_ex = {"forward": counts["forward"][0] * items, "backward": 0}
        want_ga = {"forward": counts["forward"][1] * items, "backward": 0}
        windowed = kwargs.get("max_flow", kwargs.get("dcn_max_offset")) is not None
        # 4 DCN packs (L3, L2, L1, cascade) a frame of the window, each
        # launching one im2col, on its band while the window's R + 2 rows fit
        # in it (``ops/deform_conv.spatial_operand``), else on the frame
        want_dcn = [DCN_PER_FORWARD * items if name == "EDVRNet" else 0, 0, 0]
        want_calls = {"band": 0, "frame": 0}
        if name == "EDVRNet":
            for k in (4, 2, 1, 1):
                fits = windowed and EDVR_TPU_R + 2 <= lr_hw[0] // k // SPATIAL
                want_calls["band" if fits else "frame"] += kwargs["nframes"] * items
        tel_gap = 0.0
        if set(got["telemetry"]) != set(want["telemetry"]):
            raise AssertionError(f"{key}: telemetry sites {got['telemetry']} against "
                                 f"{want['telemetry']}")
        for site, stats in want["telemetry"].items():
            g = got["telemetry"][site]
            if g["n"] != stats["n"]:
                raise AssertionError(f"{key} {site}: {g['n']} samples against {stats['n']}")
            tel_gap = max(tel_gap, abs(g["frac_out"] - stats["frac_out"]),
                          abs(g["max_abs"] - stats["max_abs"]) / max(stats["max_abs"], 1e-12))
        ms, ms_meshless = (float(np.median(x[1:] or x)) for x in (got["item_ms"], want["item_ms"]))
        log("spatial video", f"{key} x{SCALE} on mesh {got['mesh']}: {items} items, Test log "
                             f"{got['log']}; largest difference to the meshless log "
                             f"{max(gaps.values()):.3e} ({'bf16: SSIM absolute, the rest ' if bf16 else ''}"
                             f"relative; tol {(TOL_ZOO_LOG, TOL_VIDEO_BF16_SSIM) if bf16 else TOL_ZOO_LOG}); "
                             f"the first item's gathered SR {tuple(got['sr'].shape)} within "
                             f"{sr_rel:.3e} of the meshless forward's largest value (tol "
                             f"{sr_tol}); telemetry "
                             f"{got['telemetry']} within {tel_gap:.3e} of the meshless run's (tol "
                             f"{TOL_VIDEO_TELEMETRY}); halo exchanges {got['exchanges']} (predicted "
                             f"{want_ex}), gathers {got['gathers']} (predicted {want_ga}); DCN "
                             f"launches {got['dcn_launches']} (predicted {want_dcn}), calls "
                             f"{got['dcn_calls']}; gate launches {got['launches']}; median "
                             f"{ms:.1f} ms an item (meshless {ms_meshless:.1f}); {note}")
        if got["mesh"] != {"data": 1, "spatial": SPATIAL} or got["warned"]:
            raise AssertionError(f"{key} ran on {got['mesh']}, warned {got['warned']}")
        if not (log_ok and sr_rel <= sr_tol and tel_gap <= TOL_VIDEO_TELEMETRY):
            raise AssertionError(f"{key} on the spatial mesh disagrees: {gaps}, {sr_rel}, "
                                 f"{tel_gap}")
        if (got["exchanges"] != want_ex or got["gathers"] != want_ga or any(got["launches"])
                or list(got["dcn_launches"][:3]) != want_dcn or got["dcn_calls"] != want_calls):
            raise AssertionError(f"{key} exchanged {got['exchanges']} (predicted {want_ex}), "
                                 f"gathered {got['gathers']} (predicted {want_ga}), launched "
                                 f"{got['launches']}, {got['dcn_launches']}, {got['dcn_calls']}")
        results["eval"][key] = {"log_gaps": gaps, "sr_rel": sr_rel, "telemetry_gap": tel_gap,
                                "exchanges": got["exchanges"], "gathers": got["gathers"],
                                "item_ms": ms, "meshless_item_ms": ms_meshless, "items": items,
                                "launches": got["launches"], "dcn_launches": got["dcn_launches"]}
    for key in VIDEO_TRAIN:
        got, want = ranks["train"][key], reference[key]
        name = key.removesuffix("_tpu")
        bf16 = key.endswith("_tpu")
        tol = TOL_VIDEO_BF16_STEP if bf16 else TOL_ZOO_STEP
        state = load_checkpoint(tmp / f"video_train_{key}_spatial" / "checkpoints"
                                / "model_1.pth")["net"]
        loss_rel = {split: abs(got["history"][split][0]["Loss"] - want["history"][split][0]["Loss"])
                    / abs(want["history"][split][0]["Loss"]) for split in ("train", "valid")}
        floats = [k for k, v in want["state"].items() if v.is_floating_point()]
        params = [k for k in floats if "running" not in k]
        start = load_checkpoint(starts[key])["net"]
        gap = torch.cat([(state[k] - want["state"][k]).flatten() for k in params])
        update = torch.cat([(want["state"][k] - start[k]).flatten() for k in params])
        # as phase 35's SGD step: the largest parameter difference relative
        # to the largest parameter, the update apart in norm
        param_rel = (gap.abs().max() / max(want["state"][k].abs().max() for k in params)).item()
        update_rel = (gap.norm() / update.norm()).item()
        stats_rel = max([((state[k] - want["state"][k]).abs().max()
                          / want["state"][k].abs().max().clamp_min(1e-12)).item()
                         for k in floats if "running" in k], default=0.0)
        kwargs = _video_train_kwargs(key)
        accum = 2 if bf16 else 1
        frames = VSR_TRAIN["FRVSRNet"][1] if name == "FRVSRNet" else 0
        step = video_counts(name, kwargs, (PATCH, PATCH), frames, SPATIAL, train=True)
        valid = video_counts(name, kwargs, lr_hw, VIDEO_TRAIN_ITEMS if name == "FRVSRNet" else 0,
                             SPATIAL)["forward"]
        n_valid = 1 if name == "FRVSRNet" else VIDEO_TRAIN_ITEMS
        want_ex = {"forward": accum * step["forward"][0] + n_valid * valid[0],
                   "backward": accum * step["backward"][0]}
        want_ga = {"forward": accum * step["forward"][1] + n_valid * valid[1],
                   "backward": accum * step["backward"][1]}
        dcn_fwd = DCN_PER_FORWARD * (accum + n_valid) if name == "EDVRNet" else 0
        dcn_bwd = DCN_PER_FORWARD * accum if name == "EDVRNet" else 0
        want_dcn = [dcn_fwd, dcn_bwd, dcn_bwd]
        step_ms = 1e3 / got["steps_per_sec"]
        log("spatial video", f"one SGD step of {key}'s train YAML (batch {VIDEO_TRAIN_ITEMS}"
                             f"{', 2 microbatches' if accum == 2 else ''}) on mesh {got['mesh']}: "
                             f"train and valid loss relative to world 1's "
                             f"{loss_rel['train']:.3e}, {loss_rel['valid']:.3e}, parameters "
                             f"within {param_rel:.3e} of the largest parameter, running "
                             f"statistics {stats_rel:.3e} of their largest element (tol {tol}; "
                             f"SGD at {ZOO_SGD_LR}), the update {update_rel:.3e} apart in norm "
                             f"(not bounded: phase 35's SGD note); halo "
                             f"exchanges {got['exchanges']} (predicted {want_ex}), gathers "
                             f"{got['gathers']} (predicted {want_ga}); DCN launches "
                             f"{got['dcn_launches']} (predicted {want_dcn}); {step_ms:.1f} ms a "
                             f"step, the epoch with its valid pass {got['wall_s']:.2f} s; {note}")
        if got["mesh"] != {"data": 1, "spatial": SPATIAL} or got["warned"]:
            raise AssertionError(f"{key}'s step ran on {got['mesh']}, warned {got['warned']}")
        if not max(*loss_rel.values(), param_rel, stats_rel) <= tol:
            raise AssertionError(f"{key}'s step disagrees with world 1: {loss_rel}, {param_rel}, "
                                 f"{stats_rel}")
        if (got["exchanges"] != want_ex or got["gathers"] != want_ga or any(got["launches"])
                or list(got["dcn_launches"][:3]) != want_dcn):
            raise AssertionError(f"{key}'s step exchanged {got['exchanges']} (predicted "
                                 f"{want_ex}), gathered {got['gathers']} (predicted {want_ga}), "
                                 f"launched {got['launches']}, {got['dcn_launches']}")
        results["train"][key] = {"loss_rel": loss_rel, "param_rel": param_rel,
                                 "update_rel": update_rel,
                                 "stats_rel": stats_rel, "exchanges": got["exchanges"],
                                 "gathers": got["gathers"], "step_ms": step_ms,
                                 "launches": got["launches"], "dcn_launches": got["dcn_launches"]}
    log("spatial video", f"phase 36 in {wall:.1f} s with the ranks' start")
    results.update(wall_s=wall, card=card_line)
    return results


# ---------------------- 31-33 the offline pipeline, convergence, DSB15 eval
# phase 31-32: tools/convergence.py's phantom (4 train + 2 test patients, 2
# slices, 16 frames, HR 144x144, x4) and its flagship run
CONV_SIZE, CONV_PATIENTS, CONV_SLICES, CONV_FRAMES = 144, (4, 2), 2, 16
CONV_EPOCHS = 40  # about 5 minutes of an H100 (PERF.md section 5)
CONV_MIN_DELTA_DB = 1.0  # trained RefineNet x4 over Bicubic on the held-out split
CONV_NET_KWARGS = None  # the train YAML's net (a CPU rehearsal shrinks it here)
# phase 31's DSB15 tree, which phase 33 serves: one test patient, two sax
# series of 30 frames (DSB15's shortest) and a malformed one between them
DSB15_SIZE, DSB15_SLICES, DSB15_FRAMES = 144, 2, 30
DSB15_NET_KWARGS = None  # the YAMLs' net (a CPU rehearsal shrinks it here)


def _tree_files(root: Path, pattern: str) -> list:
    return sorted(Path(root).rglob(pattern))


def offline_pipeline(tmp: Path, card_line) -> dict:
    """Phase 31: the port's offline pipeline on the card's machine (numpy
    and the standard library: no OpenCV, imageio or JAX there)."""
    import pickle
    import shutil

    import numpy as np

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (
        cardiac_cropping,
        convergence,
        dsb15_dicom2nifty,
        dsb15_preprocess,
        gen_positional_encoding,
        gen_synthetic_data,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import imgio, nifti

    # the convergence phantom through acdc_preprocess, cardiac_cropping and
    # gen_positional_encoding (phase 32 trains on it)
    t0 = time.perf_counter()
    tree = convergence.phantom_tree(tmp / "convergence", CONV_SIZE)
    acdc_s = time.perf_counter() - t0
    n = sum(CONV_PATIENTS)
    got = {"raw": len(_tree_files(tree["raw_dir"], "*.nii.gz")),
           "videos": len(_tree_files(tree["videos_dir"], "*.nii.gz")),
           "imgs": len(_tree_files(tree["imgs_dir"], "*.nii.gz")),
           "gifs": len(_tree_files(tree["coordinates_path"].parent, "*.gif"))}
    want = {"raw": n, "videos": n * CONV_SLICES * 2, "imgs": n * CONV_SLICES * CONV_FRAMES * 2,
            "gifs": n * CONV_SLICES}
    splits = {s: len(list((tree["videos_dir"] / s / "HR").iterdir()))
              for s in ("train", "valid", "test")}
    with open(tree["pos_code_path"], "rb") as f:
        codes = pickle.load(f)
    with open(tree["coordinates_path"], "rb") as f:
        coords = pickle.load(f)
    gif_frames = {imgio.gif_frame_count(p) for p in _tree_files(tree["coordinates_path"].parent,
                                                                 "*.gif")}
    log("pipeline", f"gen_synthetic_data ({CONV_PATIENTS[0]} + {CONV_PATIENTS[1]} patients, "
                    f"{CONV_SLICES} slices, {CONV_FRAMES} frames, HR {CONV_SIZE}, x4) with "
                    f"acdc_preprocess, cardiac_cropping, gen_positional_encoding: {acdc_s:.2f} s; "
                    f"files {got} (expected {want}); patients by split {splits}; phase codes "
                    f"{len(codes)}, boxes {len(coords)}; frames a cropped GIF {gif_frames}")
    if got != want or splits != {"train": 3, "valid": 1, "test": 2} or gif_frames != {CONV_FRAMES}:
        raise AssertionError(f"the phantom tree is not the one asked for: {got}, {splits}")
    if sorted(codes) != sorted(coords) or len(codes) != n:
        raise AssertionError(f"pickles of {sorted(codes)} and {sorted(coords)}")
    for patient, code in codes.items():
        h0, hn, w0, wn = coords[patient]
        if code.shape != (CONV_FRAMES,) or not np.all(np.abs(code) <= 1) or \
                not (0 <= h0 < hn <= CONV_SIZE and 0 <= w0 < wn <= CONV_SIZE):
            raise AssertionError(f"{patient}: phase code {code}, box {coords[patient]}")

    # a DSB15 tree: the phantoms as sax series, a malformed one among them
    t0 = time.perf_counter()
    root = tmp / "dsb15"
    raw = gen_synthetic_data.gen_dsb15_raw_tree(root, {"test": 1}, DSB15_SIZE, DSB15_SLICES,
                                                DSB15_FRAMES, seed=0)
    nifti.save(np.zeros((DSB15_SIZE, DSB15_SIZE, 1, DSB15_FRAMES - 1), np.int16),
               raw / "test" / "701" / "sax_01b" / "sax_01b.nii.gz")
    pre, crop = root / "preprocessed", root / "cropped"
    dsb15_preprocess.main(raw, pre, factors=(2, 3, 4))
    cardiac_cropping.main(pre / "videos", crop)
    gen_positional_encoding.main(pre / "videos", crop / "coordinates.pkl", pre)
    dsb15_s = time.perf_counter() - t0
    dsb15 = {"videos_dir": pre / "videos", "imgs_dir": pre / "imgs",
             "coordinates_path": crop / "coordinates.pkl", "pos_code_path": pre / "position_code.pkl"}
    names = [p.name for p in _tree_files(pre / "videos" / "test" / "HR", "*.nii.gz")]
    n_files = len(_tree_files(pre, "*.nii.gz"))
    log("pipeline", f"dsb15_preprocess (1 patient, {DSB15_SLICES} series of {DSB15_FRAMES} frames "
                    f"and one of {DSB15_FRAMES - 1}, HR {DSB15_SIZE}, x2 x3 x4) with "
                    f"cardiac_cropping, gen_positional_encoding: {dsb15_s:.2f} s; HR sequences "
                    f"{names}; {n_files} NIfTI files")
    if names != ["701_2d+1d_sequence01.nii.gz", "701_2d+1d_sequence03.nii.gz"] or \
            n_files != DSB15_SLICES * (1 + DSB15_FRAMES) * 4:
        raise AssertionError(f"dsb15_preprocess wrote {names}, {n_files} files")

    if shutil.which("dcm2niix"):
        dicom = tmp / "dsb15_dicom"
        (dicom / "validate" / "501" / "study" / "sax_5").mkdir(parents=True)
        dsb15_dicom2nifty.main(dicom, tmp / "dsb15_nifti")
        converted = (tmp / "dsb15_nifti" / "valid" / "501" / "sax_5").is_dir()
        log("pipeline", f"dsb15_dicom2nifty ran dcm2niix on an empty series: output directory "
                        f"made {converted}")
        if not converted:
            raise AssertionError("dsb15_dicom2nifty made no output directory")
        dicom2nifty = "ran"
    else:
        dicom2nifty = "skipped: dcm2niix is not on PATH"
        log("pipeline", "dsb15_dicom2nifty skipped: dcm2niix (an external program, as in the "
                        "reference) is not on PATH; the DSB15 tree above starts from NIfTI series")
    out = {"acdc_s": acdc_s, "dsb15_s": dsb15_s, "files": got, "dsb15_files": n_files,
           "dicom2nifty": dicom2nifty, "card": card_line}
    print(json.dumps({"offline_pipeline": out}), flush=True)
    return {**out, "tree": tree, "dsb15_tree": dsb15}


def _check_exports(root: Path, sequences: int, frames: int) -> dict:
    """A predictor's export under ``root``: CSV rows per frame, a GIF a
    sequence holding one image block a frame, a PNG a frame, each file
    starting with its signature."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils import imgio

    rows = len((root / "results.csv").read_text().strip().splitlines()) - 1
    gifs = _tree_files(root / "videos", "*.gif")
    pngs = _tree_files(root / "imgs", "*.png")
    gif_frames = sorted({imgio.gif_frame_count(p) for p in gifs})
    bad = [p.name for p in gifs if p.read_bytes()[:6] != b"GIF89a"] + \
          [p.name for p in pngs if p.read_bytes()[:8] != b"\x89PNG\r\n\x1a\n"]
    found = {"rows": rows, "gifs": len(gifs), "gif_frames": gif_frames, "pngs": len(pngs)}
    if found != {"rows": sequences * frames, "gifs": sequences, "gif_frames": [frames],
                 "pngs": sequences * frames} or bad:
        raise AssertionError(f"the export under {root} is {found}, bad signatures {bad}")
    return found


def flagship_convergence(lstm_gates, work: Path, dev, card_line) -> dict:
    """Phase 32: ``tools/convergence.py refine_net/exp1_x4`` on the card:
    the flagship trained from scratch on phase 31's phantom, against
    Bicubic on the held-out split, with the shipped test YAMLs' export."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import convergence

    argv = ["refine_net/exp1_x4", "--epochs", str(CONV_EPOCHS), "--size", str(CONV_SIZE),
            "--workdir", str(work), "--device", str(dev)]
    if CONV_NET_KWARGS:
        argv += ["--net-kwargs", json.dumps(CONV_NET_KWARGS)]
    reset_launches(lstm_gates)
    t0 = time.perf_counter()
    out, trainer = convergence.run(argv)
    wall = time.perf_counter() - t0
    counts = launches(lstm_gates)
    step_ms = 1e3 / trainer.throughput["train_steps_per_sec"]
    steps = sum(1 for _ in trainer.train_dataloader) * CONV_EPOCHS
    log("convergence", f"refine_net/exp1_x4, {CONV_EPOCHS} epochs ({steps} steps) on {dev}: trained "
                       f"PSNR {out['trained']['PSNR']} dB against Bicubic's "
                       f"{out['bicubic']['PSNR']} dB, delta {out['delta_psnr_db']:+.3f} dB (at least "
                       f"+{CONV_MIN_DELTA_DB}); SSIM {out['trained']['SSIM']} against "
                       f"{out['bicubic']['SSIM']}; train wall {out['train_wall_sec']} s, "
                       f"{step_ms:.1f} ms a step, whole run {wall:.1f} s ({card_line})")
    log("convergence", f"valid losses {out['valid_losses']}")
    log("convergence", f"gate launches (forward, backward, bf16 forward, bf16 backward) {counts}")
    values = out["train_losses"] + out["valid_losses"] + [
        v for name in ("trained", "bicubic") for v in out[name].values()]
    if len(out["train_losses"]) != CONV_EPOCHS or len(out["valid_losses"]) != CONV_EPOCHS or \
            not all(math.isfinite(v) for v in values):
        raise AssertionError(f"the convergence run logged non-finite or missing values: {out}")
    if not (counts[0] > 0 and counts[1] > 0):
        raise AssertionError(f"the convergence run launched the gate kernels {counts}")
    if not out["delta_psnr_db"] >= CONV_MIN_DELTA_DB:
        raise AssertionError(f"trained RefineNet is {out['delta_psnr_db']} dB over Bicubic")
    sequences = CONV_PATIENTS[1] * CONV_SLICES
    exports = {name: _check_exports(work / f"test_refine_net_exp1_x4_{name}", sequences,
                                    CONV_FRAMES) for name in ("trained", "bicubic")}
    log("convergence", f"exports of the shipped test YAMLs: {exports}")
    result = {**out, "wall_s": wall, "step_ms": step_ms, "steps": steps, "launches": counts,
              "exports": exports, "card": card_line}
    print(json.dumps({"convergence": result}), flush=True)
    return result


def dsb15_eval(port_main, lstm_gates, tree: dict, tmp: Path, dev, card_line) -> dict:
    """Phase 33: ``configs/test/refine_net/exp1_x{2,3,4}_dsb15.yaml`` at
    full width with seeded weights on phase 31's DSB15 tree, export on."""
    import torch

    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import load_config
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.refine_net import RefineNet
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.convergence import (
        patch_paths_only,
    )

    out = {}
    for r in (2, 3, 4):
        name = f"exp1_x{r}_dsb15"
        cfg = load_config(REPO / "configs" / "test" / "refine_net" / f"{name}.yaml")
        if DSB15_NET_KWARGS:
            cfg.net.kwargs.update(DSB15_NET_KWARGS)
        net = RefineNet(**cfg.net.kwargs, generator=torch.Generator().manual_seed(r))
        ckpt = tmp / f"{name}.pth"
        torch.save({"net": net.state_dict()}, ckpt)
        cfg = patch_paths_only(cfg, tree, tmp / name, loaded_path=ckpt)
        cfg.predictor.kwargs.device = str(dev)
        reset_launches(lstm_gates)
        t0 = time.perf_counter()
        predictor = port_main.test_from_config(cfg)
        wall = time.perf_counter() - t0
        counts = launches(lstm_gates)
        layer_steps = len(cfg.net.kwargs.num_features) * 2 * cfg.net.kwargs.num_stages
        want = layer_steps * (DSB15_FRAMES + 2 * cfg.net.kwargs.num_updated_frames) * DSB15_SLICES
        exports = _check_exports(tmp / name, DSB15_SLICES, DSB15_FRAMES)
        log("dsb15", f"{name} on {dev}: Test log {predictor.log}; "
                     f"{predictor.throughput['frames_per_sec']:.2f} frames/s, wall {wall:.2f} s with "
                     f"export {exports}; gate launches {counts} (expected {want}) ({card_line})")
        if not all(math.isfinite(v) for v in predictor.log.values()) or \
                predictor.throughput["frames"] != DSB15_SLICES * DSB15_FRAMES:
            raise AssertionError(f"{name}: {predictor.log}, {predictor.throughput}")
        if counts != (want, 0, 0, 0):
            raise AssertionError(f"{name} launched {counts}")
        out[name] = {"log": predictor.log, "frames_per_sec": predictor.throughput["frames_per_sec"],
                     "wall_s": wall, "launches": counts, "exports": exports}
    print(json.dumps({"dsb15_eval": {**out, "card": card_line}}), flush=True)
    return out


def main() -> int:
    started = time.perf_counter()
    if not (REPO / PKG / "csrc" / "lstm_gates.cu").is_file():
        print(f"chip_smoke.py: the {PKG} package is not beside this script", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 3
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import main as port_main
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import Cfg
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.parallel import (
        distributed,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.refine_net import (
        RefineNet,
        recurrence_format,
        set_gate_tail,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
        deform_conv,
        lstm_gates,
        tiling,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import common
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.checkpoint import (
        load_checkpoint,
    )
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.synthetic_tree import (
        write_acdc_tree,
    )

    # ---------------------------------------------------------------- 1 device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card_line = smi.splitlines()[0]
    print(card_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    log("device", f"torch: {kind}, {torch.cuda.device_count()} device(s), torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, mem_rate, fp32_peak, bf16_peak = next(c for c in CARDS if c[0] in kind)
    log("device", f"bound rates for this part: {mem_rate / 1e12} TB/s, {fp32_peak / 1e12} fp32 "
                  f"TFLOP/s, {bf16_peak / 1e12} bf16 TFLOP/s")
    dev = torch.device("cuda:0")

    # ----------------------------------------------------------------- 2 build
    # one nvcc a source, all started together
    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = {name: pool.submit(mod.build) for name, mod in
                  (("lstm_gates.cu", lstm_gates), ("deform_conv.cu", deform_conv))}
        builds = {name: future.result() for name, future in builds.items()}
    for name, built in builds.items():
        log("build", f"{name} -> {built.path.name} in {built.seconds:.2f} s")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                log("build", line.strip())

    # ------------------------------------------------------- 3 kernel vs plain
    # the gate conv's raw output, c and its bias, in the layout the recurrence
    # hands the tail (recurrence_format) and in NCHW, against the fp32 plain
    # version on the same (upcast) inputs
    gen = torch.Generator(device=dev).manual_seed(0)
    F_ = NET_KWARGS["num_features"][0]
    h_lr = HR // SCALE
    shape_c = (1, F_, h_lr, h_lr)  # M = 4096 rows
    shape_g = (1, 4 * F_, h_lr, h_lr)
    errors = {}

    def check_fwd(g, c, b, dim, dtype, tol, what):
        width = lstm_gates.vector_width(g, c, dim=dim)
        h_k, c_k = lstm_gates.fused_lstm_gates(g, c, dim=dim, bias=b)
        h_p, c_p = lstm_gates.lstm_gates_reference(g.float(), c.float(), dim=dim, bias=b.float())
        torch.cuda.synchronize()
        err = max((h_k.float() - h_p).abs().max().item(), (c_k.float() - c_p).abs().max().item())
        log("kernel", f"{what} {dtype} with bias ({'16-byte vectors of ' + str(width) if width > 1 else 'scalar'}"
                      f" path): max abs err {err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"gate kernel disagrees with its plain version: {what} {dtype}: {err}")
        return err

    for dtype, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
        fmt = recurrence_format(dtype)
        for layout in dict.fromkeys((fmt, torch.channels_last, torch.contiguous_format)):
            g, c, b = gate_operands(shape_c, layout, dtype, dev, gen)
            err = check_fwd(g, c, b, 1, dtype, tol, f"{fmt_name(layout)} {shape_g}")
            if layout == fmt:
                errors[str(dtype)] = err
    M = 3 * 11 * 7
    g = torch.randn(M, 4 * F_, device=dev, generator=gen) * 2
    c = torch.randn(M, F_, device=dev, generator=gen)
    b = torch.randn(4 * F_, device=dev, generator=gen) * 0.5
    check_fwd(g, c, b, -1, torch.float32, TOL_FP32, f"rows ({M}, {4 * F_})")
    for dtype, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
        # one element past an aligned allocation: the scalar path
        g1 = torch.randn(M * 4 * F_ + 1, device=dev, generator=gen).to(dtype)[1:].view(M, 4 * F_)
        c1 = torch.randn(M * F_ + 1, device=dev, generator=gen).to(dtype)[1:].view(M, F_)
        check_fwd(g1, c1, b.to(dtype), -1, dtype, tol, f"rows ({M}, {4 * F_}) offset by one element")
    g, c, b = gate_operands(shape_c, recurrence_format(torch.float32), torch.float32, dev, gen)
    dh, dc = (torch.randn(shape_c, device=dev, generator=gen) for _ in range(2))
    grads = []
    for fn in (lstm_gates.fused_lstm_gates, lstm_gates.lstm_gates_reference):
        leaves = [t.clone().requires_grad_() for t in (g, c, b)]
        torch.autograd.backward(fn(leaves[0], leaves[1], dim=1, bias=leaves[2]), (dh, dc))
        grads.append([t.grad for t in leaves])
    err = max((a - p).abs().max().item() for a, p in zip(grads[0][:2], grads[1][:2]))
    db_rel = ((grads[0][2] - grads[1][2]).abs().max() / grads[1][2].abs().max()).item()
    log("kernel", f"gradient through the autograd.Function (backward kernel) vs plain autograd, "
                  f"{fmt_name(recurrence_format(torch.float32))} with bias: d_gates, d_c max abs err "
                  f"{err:.3e} (tol {TOL_GRAD}); d_bias {db_rel:.3e} of its largest element (tol "
                  f"{TOL_DBIAS_REL})")
    if not (err <= TOL_GRAD and db_rel <= TOL_DBIAS_REL):
        raise AssertionError(f"gate kernel gradient disagrees: {err}, d_bias {db_rel}")

    # ---------------------------------------------------------- 4 eval main path
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = Path(tmp_dir.name)
    t0 = time.perf_counter()
    tree = write_acdc_tree(tmp / "acdc", TREE_SPLITS, cycle=CYCLE, hr=HR, scale=SCALE)
    log("main", f"synthetic tree {TREE_SPLITS} written in {time.perf_counter() - t0:.1f} s")
    net = RefineNet(**NET_KWARGS, generator=torch.Generator().manual_seed(0))
    ckpt = tmp / "model.pth"
    torch.save({"net": net.state_dict()}, ckpt)
    log("main", f"{CYCLE}-frame cycles, HR {HR}x{HR}, LR {h_lr}x{h_lr}; RefineNet "
                f"{sum(p.numel() for p in net.parameters()):,} params")
    # warm the CUDA context and cuDNN's algorithm choice on one clip first
    net.to(dev).eval()
    rng = np.random.default_rng(1)
    clip = torch.from_numpy(rng.standard_normal((1, T_CLIP, h_lr, h_lr, 1)).astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.uniform(-1, 1, (1, T_CLIP, 1)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        net(clip, pos)
    torch.cuda.synchronize()

    native_reads = native_reader_check(tree)
    cfg = Cfg(eval_config(tree, ckpt, tmp / "test"))
    reset_launches(lstm_gates)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with count_native_reads() as reads:
        predictor = port_main.test_from_config(cfg)
    wall = time.perf_counter() - t0
    log("main", f"the eval's dataset read {reads.count} volumes through the native reader")
    if reads.count != 2 * SLICES:  # each test slice's LR and HR file, once
        raise AssertionError(f"the eval read {reads.count} volumes through the native reader")
    eval_launches = launches(lstm_gates)
    n_eval = eval_launches[0]
    log("main", f"Test log: {predictor.log}")
    log("main", f"lstm_gates launches: {n_eval} (expected {LAUNCHES_PER_CLIP} x {SLICES} clips)")
    if eval_launches != (LAUNCHES_PER_CLIP * SLICES, 0, 0, 0):
        raise AssertionError(f"the eval path launched (forward, backward, bf16 forward, bf16 "
                             f"backward) {eval_launches}")
    if predictor.throughput["frames"] != CYCLE * SLICES:
        raise AssertionError(f"scored {predictor.throughput['frames']} frames")
    if not all(math.isfinite(v) for v in predictor.log.values()):
        raise AssertionError(f"non-finite metric in {predictor.log}")
    clip_s = predictor.item_seconds
    fp32_log = predictor.log
    log("main", f"frames/s {predictor.throughput['frames_per_sec']:.2f} over "
                f"{predictor.throughput['frames']} frames; per-clip latency "
                f"{', '.join(f'{s * 1e3:.1f}' for s in clip_s)} ms; test_from_config wall "
                f"{wall:.2f} s; peak device memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    eval_fps = predictor.throughput["frames_per_sec"]
    print(json.dumps({"main_path": {"frames_per_sec": predictor.throughput["frames_per_sec"],
                                    "clip_ms": [s * 1e3 for s in clip_s], "wall_s": wall,
                                    "card": card_line}}), flush=True)

    # ---------------------------------------------------------- 5 whole forward
    with torch.inference_mode():
        out_kernel = net(clip, pos)
        fused_k = out_kernel[-1]
        set_gate_tail(net, lstm_gates.lstm_gates_reference)
        fused_p = net(clip, pos)[-1]
        set_gate_tail(net, lstm_gates.fused_lstm_gates)
    torch.cuda.synchronize()
    if tuple(fused_k.shape) != (1, CYCLE, HR, HR, 1) or len(out_kernel) != 9:
        raise AssertionError(f"unexpected output shape {tuple(fused_k.shape)}")
    if not torch.isfinite(fused_k).all():
        raise AssertionError("non-finite values in the fused output")
    err = (fused_k - fused_p).abs().max().item()
    log("forward", f"clip (1, {T_CLIP}, {h_lr}, {h_lr}, 1): final fused output, kernel vs plain gate "
                   f"tail: max abs diff {err:.3e} (tol {TOL_FORWARD}); |output| max "
                   f"{fused_k.abs().max().item():.3f}")
    if not err <= TOL_FORWARD:
        raise AssertionError(f"whole forward through the kernel disagrees: {err}")
    small = clip[:, :, :16, :16].contiguous()
    with torch.inference_mode():
        on_card = net(small, pos)[-1].cpu()
        on_cpu = net.to("cpu")(small.cpu(), pos.cpu())[-1]
    err = (on_card - on_cpu).abs().max().item()
    log("forward", f"clip (1, {T_CLIP}, 16, 16, 1): card vs CPU max abs diff {err:.3e} "
                   f"(tol {TOL_FORWARD})")
    if not err <= TOL_FORWARD:
        raise AssertionError(f"the card's forward disagrees with the CPU's: {err}")

    # ----------------------------------------------------------------- 6 times
    # per launch in the recurrence's layout with the bias, CUDA graphs of 100
    # launches over operand sets larger than L2
    rates = (mem_rate, fp32_peak)
    fwd_eval = {}
    for dtype, per_clip, clip_name in ((torch.float32, LAUNCHES_PER_CLIP, "clip"),
                                       (torch.bfloat16, BUCKET_LAUNCHES_PER_CLIP, "t_bucket clip")):
        t = time_gate_forward(lstm_gates, shape_c, recurrence_format(dtype), dtype, dev, gen, rates)
        fwd_eval[dtype] = t
        log("times", times_line("lstm_gates", shape_c, dtype, t) + f"; per {clip_name} {per_clip} "
                     f"launches = {t['ms'] * per_clip:.2f} ms")

    # ------------------------------------------------------ 7 train main path
    cfg = Cfg(train_config(tree, tmp / "train"))
    reset_launches(lstm_gates)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = port_main.train_from_config(cfg)
    train_wall = time.perf_counter() - t0
    train_fwd, train_bwd, train_fwd16, train_bwd16 = launches(lstm_gates)
    train_peak = torch.cuda.max_memory_allocated(dev)
    steps = EPOCHS * STEPS_PER_EPOCH
    for epoch, (t_log, v_log) in enumerate(zip(trainer.history["train"], trainer.history["valid"]), 1):
        log("train", f"epoch {epoch}: Train log {t_log}; Valid log {v_log}")
    want_fwd = FWD_PER_STEP * steps + LAUNCHES_PER_CLIP * VALID_CLIPS * EPOCHS
    want_bwd = BWD_PER_STEP * steps
    log("train", f"lstm_gates launches {train_fwd} (expected {FWD_PER_STEP} x {steps} steps + "
                 f"{LAUNCHES_PER_CLIP} x {VALID_CLIPS * EPOCHS} valid clips = {want_fwd}); "
                 f"lstm_gates_bwd launches {train_bwd} (expected {BWD_PER_STEP} x {steps} = {want_bwd})")
    if (train_fwd, train_bwd, train_fwd16, train_bwd16) != (want_fwd, want_bwd, 0, 0):
        raise AssertionError(f"the training path launched the gate kernels {train_fwd} / {train_bwd} times")
    if len(trainer.history["train"]) != EPOCHS or not all(
            math.isfinite(v) for h in trainer.history["train"] + trainer.history["valid"]
            for v in h.values()):
        raise AssertionError(f"training logs incomplete or non-finite: {trainer.history}")
    ckpts = tmp / "train" / "checkpoints"
    best = load_checkpoint(ckpts / "model_best.pth")
    reloaded = RefineNet(**NET_KWARGS)
    reloaded.load_state_dict(best["net"], strict=True)
    same_epoch = load_checkpoint(ckpts / f"model_{best['epoch']}.pth")["net"]
    final = load_checkpoint(ckpts / f"model_{EPOCHS}.pth")["net"]
    reloaded_sd = reloaded.state_dict()
    for name, value in trainer.net.state_dict().items():
        if not (torch.equal(reloaded_sd[name], same_epoch[name])
                and torch.equal(final[name], value.cpu())):
            raise AssertionError(f"checkpointed {name} differs from the trainer's")
    tp = trainer.throughput  # of the last epoch: every step warm
    step_ms = 1e3 / tp["train_steps_per_sec"]
    log("train", f"model_best.pth (epoch {best['epoch']}) and model_{EPOCHS}.pth reload equal to "
                 f"the trainer's weights")
    print(f"training: {tp['train_steps_per_sec']:.4f} steps/s, {tp['frames_per_sec']:.2f} frames/s, "
          f"{step_ms:.1f} ms per step after the first (epoch {EPOCHS}: {STEPS_PER_EPOCH} warm steps, "
          f"the last of {2 * 2 * CYCLE - (STEPS_PER_EPOCH - 1) * TRAIN_BATCH} items), peak device "
          f"memory {train_peak / 2**30:.2f} GiB, train_from_config wall {train_wall:.1f} s", flush=True)
    print(json.dumps({"train_path": {"steps_per_sec": tp["train_steps_per_sec"],
                                     "frames_per_sec": tp["frames_per_sec"], "step_ms": step_ms,
                                     "peak_gib": train_peak / 2**30, "wall_s": train_wall,
                                     "card": card_line}}), flush=True)

    # ------------------------------------------------ 8 training step vs plain
    rng = np.random.default_rng(2)
    batch = {
        "lr_imgs": rng.standard_normal((TRAIN_BATCH, T_TRAIN, PATCH, PATCH, 1)).astype(np.float32),
        "hr_imgs": rng.standard_normal(
            (TRAIN_BATCH, CORE, PATCH * SCALE, PATCH * SCALE, 1)).astype(np.float32),
        "pos_code": rng.uniform(-1, 1, (TRAIN_BATCH, T_TRAIN, 1)).astype(np.float32),
    }

    def step_grads(trainer):
        trainer.net.zero_grad(set_to_none=True)
        total, *_ = trainer._forward(batch, True)
        total.backward()
        return total.item(), {n: p.grad.clone() for n, p in trainer.net.named_parameters()
                              if p.grad is not None}

    bwd_before = lstm_gates.BWD_LAUNCHES
    loss_k, grads_k = step_grads(trainer)
    if lstm_gates.BWD_LAUNCHES - bwd_before != BWD_PER_STEP:
        raise AssertionError("the kernel step did not run the backward kernel 126 times")
    set_gate_tail(trainer.net, lstm_gates.lstm_gates_reference)
    loss_p, grads_p = step_grads(trainer)
    set_gate_tail(trainer.net, lstm_gates.fused_lstm_gates)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = rel_diffs(grads_k, grads_p)
    worst = max(grad_rel, key=grad_rel.get)
    log("step", f"batch ({TRAIN_BATCH}, {T_TRAIN}, {PATCH}, {PATCH}, 1): loss {loss_k:.6f} vs "
                f"{loss_p:.6f} (rel {loss_rel:.2e}); {len(grads_p)} gradients, largest relative "
                f"difference {grad_rel[worst]:.2e} at {worst} (tol {TOL_TRAIN_STEP})")
    if grads_k.keys() != grads_p.keys() or not max(loss_rel, grad_rel[worst]) <= TOL_TRAIN_STEP:
        raise AssertionError("a training step through the kernels disagrees with the plain tail")
    del trainer, grads_k, grads_p

    # ---------------------------------------------- 9 backward kernel vs plain
    shape_tc = (TRAIN_BATCH, F_, PATCH, PATCH)  # M = 16 384 rows
    shape_tg = (TRAIN_BATCH, 4 * F_, PATCH, PATCH)
    bwd_errors, fwd_train_errors = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        fmt = recurrence_format(dtype)
        g, c, b = gate_operands(shape_tc, fmt, dtype, dev, gen)
        dh, dc = (torch.randn(shape_tc, device=dev, generator=gen).to(dtype).contiguous(
            memory_format=fmt) for _ in range(2))
        tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16
        fwd_train_errors[str(dtype)] = check_fwd(g, c, b, 1, dtype, tol,
                                                 f"{fmt_name(fmt)} {shape_tg}")
        width = lstm_gates.vector_width(g, c, dh, dc, dim=1)
        dg_k, dc_k = lstm_gates._launch_bwd(g, c, dh, dc, 1, b)
        dg_p, dc_p = lstm_gates.lstm_gates_backward_reference(
            g.float(), c.float(), dh.float(), dc.float(), dim=1, bias=b.float())
        torch.cuda.synchronize()
        err = max((dg_k.float() - dg_p).abs().max().item(), (dc_k.float() - dc_p).abs().max().item())
        rel = max(((k.float() - p).abs() / p.abs().clamp_min(1)).max().item()
                  for k, p in ((dg_k, dg_p), (dc_k, dc_p)))
        bwd_errors[str(dtype)] = err
        tol_ok = err <= TOL_FP32 if dtype == torch.float32 else rel <= TOL_BF16_REL
        log("bwd", f"{fmt_name(fmt)} {shape_tg} {dtype} with bias (vectors of {width}): max abs err "
                   f"{err:.3e}, err / max(1, |value|) {rel:.3e} (tol {TOL_FP32} abs in fp32, "
                   f"{TOL_BF16_REL} relative in bf16)")
        if not tol_ok:
            raise AssertionError(f"backward kernel disagrees with its plain version in {dtype}")
    g = torch.randn(M, 4 * F_, device=dev, generator=gen) * 2
    c, dh, dc = (torch.randn(M, F_, device=dev, generator=gen) for _ in range(3))
    b = torch.randn(4 * F_, device=dev, generator=gen) * 0.5
    for what, args in (("", (g, c, dh, dc)),  # and one element past aligned allocations:
                       (" offset by one element", tuple(
                           torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
                           for t in (g, c, dh, dc)))):
        width = lstm_gates.vector_width(*args)
        dg_k, dc_k = lstm_gates._launch_bwd(*args, -1, b)
        dg_p, dc_p = lstm_gates.lstm_gates_backward_reference(*args, bias=b)
        err = max((dg_k - dg_p).abs().max().item(), (dc_k - dc_p).abs().max().item())
        log("bwd", f"rows ({M}, {4 * F_}){what} float32 with bias (vectors of {width}): max abs "
                   f"err {err:.3e} (tol {TOL_FP32})")
        if not err <= TOL_FP32:
            raise AssertionError(f"backward kernel disagrees on rows ({M}, {4 * F_}){what}: {err}")

    fwd_train, bwd_train = {}, {}
    for dtype, fwd_per_step, step_name in ((torch.float32, FWD_PER_STEP, "step"),
                                           (torch.bfloat16, REMAT_FWD_PER_STEP, "bf16 + remat step")):
        fmt = recurrence_format(dtype)
        fwd_train[dtype] = t = time_gate_forward(lstm_gates, shape_tc, fmt, dtype, dev, gen, rates)
        log("times", times_line("lstm_gates", shape_tc, dtype, t))
        bwd_train[dtype] = tb = time_gate_backward(lstm_gates, shape_tc, fmt, dtype, dev, gen, rates)
        log("times", times_line("lstm_gates_bwd", shape_tc, dtype, tb) + f"; per {step_name} "
                     f"{fwd_per_step} + {BWD_PER_STEP} launches = "
                     f"{t['ms'] * fwd_per_step + tb['ms'] * BWD_PER_STEP:.2f} ms")

    # ------------------------------------------------------- 10 bf16 serving
    cfg = eval_config(tree, ckpt, tmp / "test_bf16")
    cfg["predictor"]["kwargs"].update(compute_dtype="bfloat16", t_bucket=T_BUCKET,
                                      aot_cache=str(tmp / "aot_cache"))
    reset_launches(lstm_gates)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pred16 = port_main.test_from_config(Cfg(cfg))
    wall16 = time.perf_counter() - t0
    eval16_launches = launches(lstm_gates)
    n_eval16 = eval16_launches[2]
    eval16_peak = torch.cuda.max_memory_allocated(dev)
    log("bf16 eval", f"Test log: {pred16.log}")
    log("bf16 eval", f"fp32 Test log (phase 4): {fp32_log}")
    want = BUCKET_LAUNCHES_PER_CLIP * SLICES
    log("bf16 eval", f"bf16 lstm_gates launches {n_eval16} (expected {BUCKET_LAUNCHES_PER_CLIP} x "
                     f"{SLICES} clips = {want}); all launches {eval16_launches}")
    if eval16_launches != (want, 0, want, 0):
        raise AssertionError(f"the bf16 eval path launched (forward, backward, bf16 forward, bf16 "
                             f"backward) {eval16_launches}")
    if pred16.throughput["frames"] != CYCLE * SLICES:
        raise AssertionError(f"scored {pred16.throughput['frames']} frames, not the true {CYCLE * SLICES}")
    if not all(math.isfinite(v) for v in pred16.log.values()):
        raise AssertionError(f"non-finite metric in {pred16.log}")
    gaps = {k: pred16.log[k] - fp32_log[k] for k in ("PSNR", "SSIM", "CardiacPSNR", "CardiacSSIM")}
    log("bf16 eval", f"bf16 - fp32: {gaps} (bound |dPSNR| < {BF16_DPSNR}, |dSSIM| < {BF16_DSSIM})")
    if not all(abs(v) < (BF16_DPSNR if "PSNR" in k else BF16_DSSIM) for k, v in gaps.items()):
        raise AssertionError(f"bf16 serving left the bf16 bound of the fp32 run: {gaps}")
    clip16_s = pred16.item_seconds
    log("bf16 eval", f"frames/s {pred16.throughput['frames_per_sec']:.2f} over "
                     f"{pred16.throughput['frames']} frames; per-clip latency "
                     f"{', '.join(f'{x * 1e3:.1f}' for x in clip16_s)} ms (fp32, phase 4: "
                     f"{', '.join(f'{x * 1e3:.1f}' for x in clip_s)} ms); test_from_config wall "
                     f"{wall16:.2f} s; peak device memory {eval16_peak / 2**30:.2f} GiB")
    # the device's busy share in the predictor's own step on a warm clip
    item16 = next(iter(pred16.test_dataloader))
    patient16 = pred16._item_meta(int(item16["index"][0]))[0]
    item16, _ = pred16._bucket_batch(item16)
    masks16 = pred16._metric_masks(patient16, np.shape(pred16._targets(item16))[-3:-1])
    eval16_busy = device_busy(lambda: pred16._step(item16, masks16))
    log("bf16 eval", f"predictor step on a warm {BUCKET_CLIP}-frame clip: wall {eval16_busy[0]:.2f} ms "
                     f"(median of 3, untraced), kernels {eval16_busy[1]:.2f} ms ({eval16_busy[2]} on "
                     f"the device, traced), device busy {eval16_busy[1] / eval16_busy[0]:.1%}; "
                     f"launches by name in the trace: {eval16_busy[3]}")
    print(json.dumps({"eval_bf16": {"frames_per_sec": pred16.throughput["frames_per_sec"],
                                    "clip_ms": [x * 1e3 for x in clip16_s], "wall_s": wall16,
                                    "peak_gib": eval16_peak / 2**30, "log": pred16.log,
                                    "fp32_log": fp32_log, "step_wall_ms": eval16_busy[0],
                                    "step_kernel_ms": eval16_busy[1],
                                    "step_kernels": eval16_busy[2],
                                    "step_kernels_by_name": eval16_busy[3], "card": card_line}}),
          flush=True)

    # ----------------------------------------------- 11 bf16 + remat training
    cfg = train_config(tree, tmp / "train_bf16")
    cfg["net"] = {"name": "RefineNet", "kwargs": {**NET_KWARGS, "remat": True}}
    cfg["trainer"]["kwargs"].update(compute_dtype="bfloat16", int_feed=True,
                                    aot_cache=str(tmp / "aot_cache"))
    cfg["parallel"] = {"num_devices": 1}
    # a group of one held here: the run joins it (a group it made itself
    # would be gone when it returns), so the steps below run the DDP model
    dist.init_process_group(distributed.backend_for(dev), world_size=1, rank=0,
                            init_method=f"tcp://localhost:{distributed.free_port()}")
    records = _Records()
    logging.getLogger().addHandler(records)
    reset_launches(lstm_gates)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer16 = port_main.train_from_config(Cfg(cfg))
    train16_wall = time.perf_counter() - t0
    logging.getLogger().removeHandler(records)
    train16_launches = launches(lstm_gates)
    train16_peak = torch.cuda.max_memory_allocated(dev)
    for epoch, (t_log, v_log) in enumerate(zip(trainer16.history["train"],
                                               trainer16.history["valid"]), 1):
        log("bf16 train", f"epoch {epoch}: Train log {t_log}; Valid log {v_log}")
    want_fwd16 = REMAT_FWD_PER_STEP * steps + LAUNCHES_PER_CLIP * VALID_CLIPS * EPOCHS
    want_bwd16 = BWD_PER_STEP * steps
    log("bf16 train", f"bf16 lstm_gates launches {train16_launches[2]} (expected "
                      f"{REMAT_FWD_PER_STEP} x {steps} steps + {LAUNCHES_PER_CLIP} x "
                      f"{VALID_CLIPS * EPOCHS} valid clips = {want_fwd16}); bf16 lstm_gates_bwd "
                      f"launches {train16_launches[3]} (expected {BWD_PER_STEP} x {steps} = "
                      f"{want_bwd16}); all launches {train16_launches}")
    if train16_launches != (want_fwd16, want_bwd16, want_fwd16, want_bwd16):
        raise AssertionError(f"the bf16 + remat training path launched (forward, backward, bf16 "
                             f"forward, bf16 backward) {train16_launches}")
    warned = [r.getMessage() for r in records.records]
    log("bf16 train", f"warnings during the run: {warned}")
    if trainer16._feed_norm is None or any("int_feed disabled" in m for m in warned):
        raise AssertionError("int_feed did not engage")
    if len(trainer16.history["train"]) != EPOCHS or not all(
            math.isfinite(v) for h in trainer16.history["train"] + trainer16.history["valid"]
            for v in h.values()):
        raise AssertionError(f"bf16 training logs incomplete or non-finite: {trainer16.history}")
    state_dtypes = {p.dtype for p in trainer16.net.parameters()} | {
        v.dtype for st in trainer16.opt.state.values() for v in st.values()
        if torch.is_tensor(v) and v.is_floating_point()}
    log("bf16 train", f"dtypes of the master parameters and Adam's state: {sorted(map(str, state_dtypes))}")
    if state_dtypes != {torch.float32}:
        raise AssertionError(f"the masters or Adam's state left fp32: {state_dtypes}")
    tp16 = trainer16.throughput
    step16_ms = 1e3 / tp16["train_steps_per_sec"]
    print(f"bf16 + remat training: {tp16['train_steps_per_sec']:.4f} steps/s, "
          f"{tp16['frames_per_sec']:.2f} frames/s, {step16_ms:.1f} ms per step after the first "
          f"(fp32, phase 7: {step_ms:.1f} ms, {tp['frames_per_sec']:.2f} frames/s), peak device "
          f"memory {train16_peak / 2**30:.2f} GiB (fp32: {train_peak / 2**30:.2f} GiB), "
          f"train_from_config wall {train16_wall:.1f} s", flush=True)
    print(json.dumps({"train_bf16_remat": {
        "steps_per_sec": tp16["train_steps_per_sec"], "frames_per_sec": tp16["frames_per_sec"],
        "step_ms": step16_ms, "peak_gib": train16_peak / 2**30, "wall_s": train16_wall,
        "card": card_line}}), flush=True)

    # one bf16 + remat step through the kernels against the plain gate tail
    before = launches(lstm_gates)
    loss_k, grads_k = step_grads(trainer16)
    step16_launches = tuple(a - b for a, b in zip(launches(lstm_gates), before))
    if step16_launches[2:] != (REMAT_FWD_PER_STEP, BWD_PER_STEP):
        raise AssertionError(f"the bf16 + remat step launched {step16_launches}")
    set_gate_tail(trainer16.net, lstm_gates.lstm_gates_reference)
    loss_p, grads_p = step_grads(trainer16)
    set_gate_tail(trainer16.net, lstm_gates.fused_lstm_gates)
    step16_loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = rel_diffs(grads_k, grads_p)
    worst = max(grad_rel, key=grad_rel.get)
    step16_grad_rel = grad_rel[worst]
    log("bf16 train", f"bf16 + remat step, kernels vs plain tail on batch ({TRAIN_BATCH}, {T_TRAIN}, "
                      f"{PATCH}, {PATCH}, 1): {step16_launches[2]} + {step16_launches[3]} bf16 launches; "
                      f"loss {loss_k:.6f} vs {loss_p:.6f} (rel {step16_loss_rel:.2e}, tol "
                      f"{TOL_BF16_STEP_LOSS}); {len(grads_p)} gradients, largest relative difference "
                      f"{step16_grad_rel:.2e} at {worst} (tol {TOL_BF16_STEP_GRAD}); median "
                      f"{sorted(grad_rel.values())[len(grad_rel) // 2]:.2e}")
    if (grads_k.keys() != grads_p.keys() or step16_loss_rel > TOL_BF16_STEP_LOSS
            or step16_grad_rel > TOL_BF16_STEP_GRAD):
        raise AssertionError("a bf16 + remat step through the kernels disagrees with the plain tail")
    del grads_k, grads_p

    # one step as 2 microbatches against 1, the optimizer held still
    def accum_step(accum: int):
        trainer16.grad_accum_steps = accum
        total, _, _, display = trainer16._train_step(batch)
        return total.item(), {n: p.grad.clone() for n, p in trainer16.net.named_parameters()
                              if p.grad is not None}, tuple(display.shape)

    trainer16.optimizer.step = lambda opt: None
    (loss1, grads1, disp1), (loss2, grads2, disp2) = accum_step(1), accum_step(2)
    del trainer16.optimizer.step
    loss_rel = abs(loss2 - loss1) / abs(loss1)
    grad_rel = rel_diffs(grads2, grads1)
    worst = max(grad_rel, key=grad_rel.get)
    log("bf16 train", f"grad_accum_steps 2 vs 1 on batch ({TRAIN_BATCH}, {T_TRAIN}, {PATCH}, "
                      f"{PATCH}, 1): loss {loss2:.6f} vs {loss1:.6f} (rel {loss_rel:.2e}, tol "
                      f"{TOL_ACCUM_LOSS}); largest gradient difference relative to its maximum "
                      f"{grad_rel[worst]:.2e} at {worst} (tol {TOL_ACCUM_GRAD}); display {disp2}")
    if (grads1.keys() != grads2.keys() or disp1 != disp2 or loss_rel > TOL_ACCUM_LOSS
            or grad_rel[worst] > TOL_ACCUM_GRAD):
        raise AssertionError("grad_accum_steps 2 disagrees with the undivided step")
    del grads1, grads2
    # the device's busy share in the trainer's own step (optimizer included)
    trainer16.grad_accum_steps = 1
    train16_busy = device_busy(lambda: trainer16._train_step(batch))
    log("bf16 train", f"trainer step on batch ({TRAIN_BATCH}, {T_TRAIN}, {PATCH}, {PATCH}, 1): wall "
                      f"{train16_busy[0]:.2f} ms (median of 3, untraced), kernels "
                      f"{train16_busy[1]:.2f} ms ({train16_busy[2]} on the device, traced), device "
                      f"busy {train16_busy[1] / train16_busy[0]:.1%}; launches by name in the trace: "
                      f"{train16_busy[3]}")
    print(json.dumps({"train_bf16_remat_step": {
        "kernels_vs_plain_loss_rel": step16_loss_rel, "kernels_vs_plain_grad_rel": step16_grad_rel,
        "step_wall_ms": train16_busy[0], "step_kernel_ms": train16_busy[1],
        "step_kernels": train16_busy[2], "step_kernels_by_name": train16_busy[3],
        "card": card_line}}), flush=True)
    del trainer16
    dist.destroy_process_group()

    # --------------------------------------------------------- 12 tiled serving
    tile_tree = write_acdc_tree(tmp / "dsb15", {"test": (1, TILE_SLICES)}, cycle=CYCLE,
                                hr=TILE_HR, scale=SCALE, seed=1)
    cfg = eval_config(tile_tree, ckpt, tmp / "tiled")
    cfg["dataset"]["name"] = "Dsb15VSRRefineNetDataset"
    cfg["predictor"]["kwargs"].update(tile=TILE, tile_overlap=TILE_OVERLAP, compute_dtype="bfloat16",
                                      aot_cache=str(tmp / "aot_cache"))
    want_tiled, shapes_seen, plans = 0, set(), []
    for s in range(TILE_SLICES):  # seam_stats "first": probes for the first clip of each (H, W)
        h, w = (v // SCALE for v in TILE_HR[s % len(TILE_HR)])
        plan_h, plan_w = (tiling.plan_1d(n, TILE, TILE_OVERLAP) for n in (h, w))
        probes = ([] if (h, w) in shapes_seen else
                  tiling.seam_probe_plan(plan_h, plan_w, (TILE, TILE), TILE_OVERLAP, h, w))
        shapes_seen.add((h, w))
        plans.append(f"LR {h}x{w}: {len(plan_h)}x{len(plan_w)} windows + {len(probes)} probes")
        want_tiled += (len(plan_h) * len(plan_w) + len(probes)) * LAUNCHES_PER_CLIP
    reset_launches(lstm_gates)
    t0 = time.perf_counter()
    pred_t = port_main.test_from_config(Cfg(cfg))
    wall_t = time.perf_counter() - t0
    tiled_launches = launches(lstm_gates)
    n_tiled = tiled_launches[2]
    log("tiled", f"plan per clip: {'; '.join(plans)}")
    log("tiled", f"bf16 lstm_gates launches {n_tiled} (expected {want_tiled}: the windows and "
                 f"probes x {LAUNCHES_PER_CLIP}); all launches {tiled_launches}")
    if tiled_launches != (want_tiled, 0, want_tiled, 0):
        raise AssertionError(f"the tiled path launched (forward, backward, bf16 forward, bf16 "
                             f"backward) {tiled_launches}")
    log("tiled", f"Test log: {pred_t.log}")
    log("tiled", f"seam stats (run max, gray levels): {pred_t.seam_summary}")
    if (pred_t.throughput["frames"] != CYCLE * TILE_SLICES or pred_t.seam_summary.get("items") != 2
            or not all(math.isfinite(v) for v in [*pred_t.log.values(),
                                                   pred_t.seam_summary["max_rms"],
                                                   pred_t.seam_summary["max_abs"]])):
        raise AssertionError(f"tiled serving: {pred_t.throughput}, {pred_t.seam_summary}, {pred_t.log}")
    log("tiled", f"frames/s {pred_t.throughput['frames_per_sec']:.2f}; per-clip latency "
                 f"{', '.join(f'{x * 1e3:.1f}' for x in pred_t.item_seconds)} ms; "
                 f"test_from_config wall {wall_t:.2f} s")
    item = pred_t.test_dataloader.dataset[0]
    lr_t = torch.from_numpy(item["lr_imgs"][None]).to(dev)
    pos_t = torch.from_numpy(item["pos_code"][None]).to(dev)
    with torch.inference_mode():
        whole = common.denorm_uint8(pred_t._forward(lr_t, pos_t), pred_t.mean, pred_t.std)
        tiled = common.denorm_uint8(
            tiling.tiled_apply(pred_t._forward, [lr_t, pos_t], (TILE, TILE), TILE_OVERLAP),
            pred_t.mean, pred_t.std)
        diff = (tiled - whole).abs()
        tile_gap = {"max": diff.max().item(), "mean": diff.mean().item(),
                    "share_over_1": (diff > 1).float().mean().item()}
    log("tiled", f"clip 1 (LR {tuple(lr_t.shape[2:4])}), tiled vs untiled output in gray levels: "
                 f"max {tile_gap['max']:.0f}, mean {tile_gap['mean']:.4f}, share of pixels more "
                 f"than 1 apart {tile_gap['share_over_1']:.4%}")
    if tuple(whole.shape) != (1, CYCLE, *TILE_HR[0], 1) or not math.isfinite(tile_gap["mean"]):
        raise AssertionError(f"tiled output {tuple(tiled.shape)} vs untiled {tuple(whole.shape)}")
    print(json.dumps({"eval_tiled": {"frames_per_sec": pred_t.throughput["frames_per_sec"],
                                     "clip_ms": [x * 1e3 for x in pred_t.item_seconds],
                                     "seam": pred_t.seam_summary, "tiled_vs_untiled": tile_gap,
                                     "log": pred_t.log, "card": card_line}}), flush=True)
    del pred_t

    # --------------------------------------------- 13-14 the single-image family
    sisr_serving(port_main, Cfg, lstm_gates, tree, tmp, dev, rates, card_line)
    sisr_training(port_main, Cfg, lstm_gates, tree, tmp, dev, rates, card_line)

    # ---------------------------------------------- 15-16 the multi-frame family
    misr_serving(port_main, Cfg, lstm_gates, tree, tmp, dev, rates, card_line)
    misr_training(port_main, Cfg, lstm_gates, tree, tmp, dev, rates, card_line, bf16_peak)

    # ------------------------------------------ 17-18 the plain video family
    vsr_serving(port_main, Cfg, lstm_gates, tree, tmp, dev, rates, card_line)
    vsr_training(port_main, Cfg, lstm_gates, tree, tmp, dev, rates, card_line)

    # --------------------------------------------- 19-21 EDVR and its DCN kernels
    dcn_res = dcn_kernels(deform_conv, dev, rates, card_line, bf16_peak)
    edvr_eval = edvr_serving(port_main, Cfg, lstm_gates, deform_conv, tree, tmp, dev, rates,
                             card_line)
    edvr_train = edvr_training(port_main, Cfg, lstm_gates, deform_conv, tree, tmp, dev, rates,
                               card_line, bf16_peak)

    # ----------------------------------------------- 22-25 the serving daemon
    net.to(dev).eval()
    served = serve_refine(lstm_gates, tmp, dev, net, card_line)
    served_edvr = serve_edvr(deform_conv, tree, tmp, dev, card_line)
    ab = eval_loop_ab(port_main, Cfg, lstm_gates, deform_conv, tree, tmp, card_line)
    profiled = profiled_training(port_main, Cfg, tree, tmp)
    print(json.dumps({"serving_daemon": {"native_reader": native_reads, "profiled_train": profiled,
                                         "card": card_line}}), flush=True)

    # ------------------------------ 26-30 parallel runs and the remainders
    ddp = ddp_phases(port_main, Cfg, lstm_gates, tree, tmp, dev, card_line)
    world1_reference = ddp.pop("world1_reference")  # phase 34 steps against it too
    skipped = skip_nonfinite_card(lstm_gates, dev)
    resumed = resume_backends(port_main, Cfg, lstm_gates, tree, tmp, dev)
    batch = batch_infer_card(port_main, Cfg, lstm_gates, tree, tmp, ckpt, dev, eval_fps, card_line)
    print(json.dumps({"parallel": {**ddp, "skip_nonfinite": skipped, "resume": resumed,
                                   "batch_infer": batch}}), flush=True)

    # ------------------ 31-33 the offline pipeline, convergence, DSB15 eval
    pipeline = offline_pipeline(tmp, card_line)
    converged = flagship_convergence(lstm_gates, tmp / "convergence", dev, card_line)
    dsb15 = dsb15_eval(port_main, lstm_gates, pipeline["dsb15_tree"], tmp, dev, card_line)

    # ------------------------------------------------ 34 the spatial axis, pad_h
    spatial = spatial_axis_card(port_main, Cfg, lstm_gates, recurrence_format, tree, tmp, ckpt,
                                fp32_log, fused_k, clip, pos, world1_reference, dev, card_line)
    print(json.dumps({"spatial_axis": spatial}), flush=True)

    # -------------------------------------------- 35 the spatial axis of the zoo
    zoo = spatial_zoo_card(port_main, Cfg, lstm_gates, deform_conv, tmp, dev, card_line)
    print(json.dumps({"spatial_zoo": zoo}), flush=True)

    # --------------- 36 the spatial axis of the warping and deformable nets
    video = spatial_video_card(port_main, Cfg, lstm_gates, deform_conv, tmp, dev, card_line)
    print(json.dumps({"spatial_video": video}), flush=True)
    tmp_dir.cleanup()
    log("done", f"phases 1-36 in {time.perf_counter() - started:.1f} s, the kernels' builds "
                f"included ({card_line})")
    # the gate and DCN kernels' launches on phase 35's paths, rank 0 (none)
    zoo_gates = [sum(r["launches"][i] for part in ("eval", "train") for r in zoo[part].values())
                 for i in range(4)]
    zoo_dcn = [sum(r["dcn_launches"][i] for part in ("eval", "train") for r in zoo[part].values())
               for i in range(len(deform_conv.KERNELS))]
    # and on phase 36's (EDVR's DCN packs; no gate kernel)
    video_gates = [sum(r["launches"][i] for part in ("eval", "train")
                       for r in video[part].values()) for i in range(4)]
    video_dcn = [sum(r["dcn_launches"][i] for part in ("eval", "train")
                     for r in video[part].values()) for i in range(len(deform_conv.KERNELS))]

    replaces = "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu/ops/pallas/lstm_gates.py"
    # the single-image, multi-frame and plain video paths (phases 13-18)
    # launch neither kernel: held there
    fwd_paths = {"eval": n_eval, "train": train_fwd, "eval_bf16": n_eval16,
                 "train_bf16_remat": train16_launches[2], "eval_tiled": n_tiled,
                 "sisr_eval": 0, "sisr_train": 0, "misr_eval": 0, "misr_train": 0,
                 "vsr_eval": 0, "vsr_train": 0, "edvr_eval": 0, "edvr_train": 0,
                 "serve": served["launches"], "serve_bf16": served["bf16_launches"],
                 "eval_loop_ab_refine_bf16": ab["counts"]["refine_bf16"][0][0],
                 "serve_edvr": 0, "eval_loop_ab_edvr": ab["counts"]["edvr"][0][0],
                 "train_unwrapped": ddp["unwrapped_launches"][0],
                 "train_ddp_world1": ddp["world1_launches"][0],
                 "train_ddp_two_ranks_rank0": ddp["two_ranks_launches"][0],
                 "train_skip_nonfinite": skipped["launches"][0],
                 "train_resume_backends": resumed["launches"][0],
                 "batch_infer": batch["launches"][0], "offline_pipeline": 0,
                 "convergence": converged["launches"][0],
                 "dsb15_eval": sum(v["launches"][0] for v in dsb15.values()),
                 "spatial_eval_rank0": spatial["eval_launches"][0],
                 "spatial_train_rank0": spatial["train_launches"][0],
                 "spatial_remat_step_rank0": spatial["remat_launches"][0],
                 "spatial_pad_h_rank0": spatial["pad_h_launches"][0],
                 "spatial_batch_infer_rank0": spatial["batch_infer_launches"][0],
                 "spatial_zoo_rank0": zoo_gates[0], "spatial_video_rank0": video_gates[0]}
    bwd_paths = {"eval": 0, "train": train_bwd, "eval_bf16": 0,
                 "train_bf16_remat": train16_launches[3], "eval_tiled": 0,
                 "sisr_eval": 0, "sisr_train": 0, "misr_eval": 0, "misr_train": 0,
                 "vsr_eval": 0, "vsr_train": 0, "edvr_eval": 0, "edvr_train": 0,
                 "serve": 0, "serve_bf16": 0, "eval_loop_ab_refine_bf16": 0, "serve_edvr": 0,
                 "eval_loop_ab_edvr": 0, "train_unwrapped": ddp["unwrapped_launches"][1],
                 "train_ddp_world1": ddp["world1_launches"][1],
                 "train_ddp_two_ranks_rank0": ddp["two_ranks_launches"][1],
                 "train_skip_nonfinite": skipped["launches"][1],
                 "train_resume_backends": resumed["launches"][1], "batch_infer": 0,
                 "offline_pipeline": 0, "convergence": converged["launches"][1], "dsb15_eval": 0,
                 "spatial_eval_rank0": 0, "spatial_train_rank0": spatial["train_launches"][1],
                 "spatial_remat_step_rank0": spatial["remat_launches"][1],
                 "spatial_pad_h_rank0": 0, "spatial_batch_infer_rank0": 0,
                 "spatial_zoo_rank0": zoo_gates[1], "spatial_video_rank0": video_gates[1]}
    f32, b16 = torch.float32, torch.bfloat16
    record = {"kernels": [{
        "name": "lstm_gates",
        "route": "cuda",
        "source": f"{PKG}/csrc/lstm_gates.cu",
        "replaces": f"{replaces}:31",
        "launches": sum(fwd_paths.values()),
        "launches_by_path": fwd_paths,
        "max_abs_err": errors[str(f32)],
        "max_abs_err_bf16": errors[str(b16)],
        "ms": fwd_eval[f32]["ms"],
        "plain_ms": fwd_eval[f32]["plain_ms"],
        "bound_ms": fwd_eval[f32]["bound_ms"],
        "bound_by": fwd_eval[f32]["bound_by"],
        "library_ms": fwd_eval[f32]["library_ms"],
        "library": "aten::_thnn_fused_lstm_cell",
        "library_error": fwd_eval[f32]["library_error"],
        "copy_ms": fwd_eval[f32]["copy_ms"],
        "copy_ms_bf16": fwd_eval[b16]["copy_ms"],
        "shape": list(shape_g),
        "dtype": "float32",
        "layout": fwd_eval[f32]["layout"],
        "layout_bf16": fwd_eval[b16]["layout"],
        "max_abs_err_train_shape": fwd_train_errors[str(f32)],
        "max_abs_err_spatial_shards": {k: v for k, v in spatial["kernels"].items()
                                       if k.startswith("fwd")},
        "max_abs_err_bf16_train_shape": fwd_train_errors[str(b16)],
        "ms_train_shape": fwd_train[f32]["ms"],
        "plain_ms_train_shape": fwd_train[f32]["plain_ms"],
        "bound_ms_train_shape": fwd_train[f32]["bound_ms"],
        "library_ms_train_shape": fwd_train[f32]["library_ms"],
        "ms_bf16": fwd_eval[b16]["ms"],
        "plain_ms_bf16": fwd_eval[b16]["plain_ms"],
        "bound_ms_bf16": fwd_eval[b16]["bound_ms"],
        "library_ms_bf16": fwd_eval[b16]["library_ms"],
        "library_error_bf16": fwd_eval[b16]["library_error"],
        "ms_bf16_train_shape": fwd_train[b16]["ms"],
        "plain_ms_bf16_train_shape": fwd_train[b16]["plain_ms"],
        "bound_ms_bf16_train_shape": fwd_train[b16]["bound_ms"],
        "library_ms_bf16_train_shape": fwd_train[b16]["library_ms"],
    }, {
        "name": "lstm_gates_bwd",
        "route": "cuda",
        "source": f"{PKG}/csrc/lstm_gates.cu",
        "replaces": f"{replaces}:103",
        "launches": sum(bwd_paths.values()),
        "launches_by_path": bwd_paths,
        "max_abs_err": bwd_errors[str(f32)],
        "max_abs_err_bf16": bwd_errors[str(b16)],
        "max_abs_err_spatial_shards": {k: v for k, v in spatial["kernels"].items()
                                       if k.startswith("bwd")},
        "ms": bwd_train[f32]["ms"],
        "plain_ms": bwd_train[f32]["plain_ms"],
        "bound_ms": bwd_train[f32]["bound_ms"],
        "bound_by": bwd_train[f32]["bound_by"],
        "library_ms": bwd_train[f32]["library_ms"],
        "library": "aten::_thnn_fused_lstm_cell_backward_impl",
        "library_error": bwd_train[f32]["library_error"],
        "shape": list(shape_tg),
        "dtype": "float32",
        "layout": bwd_train[f32]["layout"],
        "layout_bf16": bwd_train[b16]["layout"],
        "ms_bf16": bwd_train[b16]["ms"],
        "plain_ms_bf16": bwd_train[b16]["plain_ms"],
        "bound_ms_bf16": bwd_train[b16]["bound_ms"],
        "library_ms_bf16": bwd_train[b16]["library_ms"],
        "library_error_bf16": bwd_train[b16]["library_error"],
    }]}
    # the DCN kernels replace XLA code of the JAX package, not a Pallas kernel
    # (its __init__.py:14 names a Pallas DCN that does not exist)
    jax_dcn = "efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu/ops/deform_conv.py"
    replaces = {"deform_im2col": f"{jax_dcn}:28, :62, :141 (XLA gathers; no Pallas kernel)",
                "deform_col2im": f"{jax_dcn}:62, :141 (XLA autodiff of the gathers; no Pallas "
                                 f"kernel)",
                "deform_col2im_coord": f"{jax_dcn}:28, :141 (XLA autodiff of the bilinear "
                                       f"weights; no Pallas kernel)"}
    index = {k: i for i, k in enumerate(deform_conv.KERNELS)}
    for k in deform_conv.KERNELS:
        paths = {"edvr_eval": edvr_eval["EDVRNet"]["dcn_launches"][index[k]],
                 "edvr_eval_bf16": edvr_eval["EDVRNet_tpu"]["dcn_launches"][index[k]],
                 "edvr_train": edvr_train["EDVRNet"]["dcn_launches"][index[k]],
                 "edvr_train_bf16": edvr_train["EDVRNet_tpu"]["dcn_launches"][index[k]],
                 "serve_edvr": served_edvr["launches"] if k == "deform_im2col" else 0,
                 "eval_loop_ab_edvr": ab["counts"]["edvr"][1][index[k]],
                 "spatial_zoo_rank0": zoo_dcn[index[k]],
                 "spatial_video_rank0": video_dcn[index[k]]}
        serve32, serve16 = (dcn_res["times"][f"serving {d}"] for d in (f32, b16))
        train32, train16 = (dcn_res["times"][f"training {d}"] for d in (f32, b16))
        record["kernels"].append({
            "name": k,
            "route": "cuda",
            "source": f"{PKG}/csrc/deform_conv.cu",
            "replaces": replaces[k],
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": dcn_res["errors"][k][str(f32)],
            "max_abs_err_bf16": dcn_res["errors"][k][str(b16)],
            "max_abs_err_row_origin": video["kernels"]["errors"][k],
            "ms": serve32[k]["ms"],
            "plain_ms": serve32[k]["plain_ms"],
            "bound_ms": serve32[k]["bound_ms"],
            "bound_by": serve32[k]["bound_by"],
            "library_ms": None,
            "library": "none: no PyTorch call computes a deformable im2col or its backward",
            "shape": list(DCN_SHAPES["serving"]),
            "dtype": "float32",
            "dense_conv_ms": serve32["dcn"]["dense_conv_ms"],
            "dcn_forward_ms": serve32["dcn"]["ms"],
            "ms_bf16": serve16[k]["ms"],
            "plain_ms_bf16": serve16[k]["plain_ms"],
            "bound_ms_bf16": serve16[k]["bound_ms"],
            "ms_train_shape": train32[k]["ms"],
            "plain_ms_train_shape": train32[k]["plain_ms"],
            "bound_ms_train_shape": train32[k]["bound_ms"],
            "dense_conv_ms_train_shape": train32["dcn"]["dense_conv_ms"],
            "dcn_forward_ms_train_shape": train32["dcn"]["ms"],
            "ms_bf16_train_shape": train16[k]["ms"],
            "plain_ms_bf16_train_shape": train16[k]["plain_ms"],
            "bound_ms_bf16_train_shape": train16[k]["bound_ms"],
            "ms_gather_only": {f"{shape} {dtype}": dcn_res["times"][f"{shape} {dtype}"][k]
                               .get("ms_gather_only")
                               for shape in DCN_SHAPES for dtype in (f32, b16)},
        })
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
