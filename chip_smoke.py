#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on a mismatch, so any failure exits non-zero):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from fsr_tpu_torch/csrc (timed);
  3. K4 edge_pad bit-equal to edge_pad_reference on the card, for every
     dtype pair it takes, output rows of every length modulo its 16-byte
     vector, 1, 3 and 4 planes, a 1x1 source under larger pads and a row
     strip's pads; same-type pads also bit-equal to F.pad(mode="replicate")
     for each dtype F.pad takes on CUDA;
  4. K1 upscale_fused against upscale_fused_reference on the card (f32
     within 6e-5; bf16 by median/p99 and max <= 2**-8), including the
     hazard cases (isolated bright pixel, DRS offset, all-black frame); the
     quad path (2x) bit-equal to the generic staged path on the same frames,
     and K1 on the K4-padded frame (upscale_padded) bit-equal to K1 on the
     image;
  5. fsr_tpu_torch.upscale(preset="performance") against the port's numpy
     oracle at 540p -> 1080p f32 (max-abs <= 2e-5);
  6. the Performance path: upscale(x, preset="performance") on a (4, 3,
     1080, 1920) CUDA tensor in f32 and bf16, held against
     upscale_fused_reference (the phase-4 limits), with launch counts (one
     K1, no K4) and CUDA-event times of each kernel beside its plain
     version (K4 timed on its own at this shape);
  7. K2 easu_gather against easu_gather_reference (the phase-4 limits) at
     every preset ratio, native 1x, a ragged ratio, 2x with an odd width, a
     DRS offset, bf16, EASU-only, denoise, batch 2 and the hazard cases;
  8. K3 rcas_fused against rcas_fused_reference (the same limits; uint8
     bit-equal): clamp and zero borders, denoise, bf16, an isolated pixel, a
     ragged image; then every storage type at widths of every residue of
     its 16-byte vector and from an unaligned row start;
  9. upscale(preset="quality") at 720p -> 1080p and sharpen at 1080p, f32,
     against the numpy oracle (max-abs <= 2e-5);
 10. the Quality path: upscale(x, preset="quality") on a (4, 3, 1440, 2560)
     CUDA tensor (-> 4K) and sharpen(y) on a (4, 3, 2160, 3840) one, in f32
     and bf16, held against their plain versions, with launch counts (K2 on
     the Quality path and K1 not; K3 on sharpen) and CUDA-event times;
 11. with --trace only: a torch.profiler trace of the Performance path, the
     Quality path and sharpen (device time per kernel, busy time and idle
     share of the window);
 12. K1 and K2 with each Epilogue variant (kernels/epilogue.py) and the SRTM
     prologue, float32 and bfloat16 storage, uint8 in and uint8/uint16 out,
     against their plain versions: float outputs by the phase-4 limits
     (SRTM^-1 outputs after the forward tonemap), codes and dithered outputs
     identical or at most 1e-4 of the values off by one code or dither
     step; K3 and K4 on uint8 bit-equal;
 13. the README's pipeline paths on batches of 4 (launch counts exactly one
     per kernel, held against the kernels' plain versions by the phase-12
     limits and against the plain-torch pipeline, CUDA-event times beside
     the same upscale without the epilogue and the plain versions): (a) the
     HDR frame tail UpscalePipeline((2160, 3840), hdr_srtm=True,
     grain_amount=0.3, dither_bits=10) on float32 1080p frames (K1),
     (b) the display path (grain, 8-bit dither, uint8 out, bf16 storage) on
     uint8 1440p frames (K2), (c) the byte video path upscale(frame_u8,
     scale=2.0, out_dtype=uint8) (K1 on bytes), and sharpen on uint8 4K
     frames (K3);
 14. with --trace only: traces of (a) and (b), which must show only their
     kernels;
 15. K1 and K2 on RGBA (f32 and bf16 storage, uint8 in with uint8/uint16
     out, RCAS off/on/denoise, the SRTM prologue, the HDR-tail and display
     epilogues; K2 also at a DRS offset and a ragged ratio) against their
     plain versions: alpha bit-equal, RGB bit-equal to the 3-channel call of
     the same kernel and within the phase-12 limits of the plain version;
 16. the RGBA paths on batches of 4: (d) upscale(rgba, preset="performance")
     on (4, 4, 1080, 1920) float32 and uint8 (-> uint8), exactly one K1
     each, (e) upscale(rgba, preset="quality") on (4, 4, 1440, 2560)
     bfloat16, exactly one K2; the same checks, and CUDA-event times of each
     kernel and the same call on the RGB slice, taken in turn (with --trace,
     traces of both, which must show only those kernels);
 17. float16: upscale(x.half(), preset="performance", compute_dtype=float16)
     at 540p -> 1080p through K6 (one launch each), "mixed" against the
     float32 oracle and ops.easu "strict" against the float16 oracle by the
     docs/FIDELITY.md f16 rows; sharpen on (4, 3, 2160, 3840) float16
     through K3 (one launch), within one half step of its plain version;
     then K6 (kernels/easu_h.py) at batch 4 through upscale(compute_dtype=
     float16): Performance 1080p -> 4K, Quality 1440p -> 4K, RGBA
     Performance, RCAS off, denoise and a float32 source, each exactly one
     K6 launch and no K1, K2 or K3, bit-equal to easu_h_reference (or at
     most F16_SHARE of the values one float16 step off), alpha bit-equal;
     at (2, C, 90, 160) every source type (float16, float32, bfloat16,
     uint8) x RGB/RGBA x RCAS off/on/denoise, a DRS viewport and the 1.7x
     preset, and three odd output widths with partial last tiles (RGB
     float16, RGBA uint8 with denoise, bfloat16 with RCAS off), each one K6
     launch and held the same way; K6's reciprocal over all 65,536 float16
     bit patterns against torch's 1.0 / x on the card (none may differ);
     K6's static SASS, whole-frame and strip-source forms (its half
     arithmetic by lanes, packing, MUFU, no CALL: no float32 division's
     slow path) beside its parent's, listed by a process started after the
     build so that cuobjdump overlaps phases 3-16; one call under
     autograd (one K6 forward, none backward, the gradient bit-equal to
     impl="torch"'s); K6 (10 queued), its plain version (the torch path)
     and K2 bf16 timed in turn; K6's ptxas lines; then K6 with the frame
     tail (_k6_tail: the SRTM prologue, the K5 epilogue and the uint8 /
     UNORM10 stores in the launch): at 90x160 each tail of _f16_tails x
     every source type x RGB/RGBA, two RCAS modes, odd output widths and a
     DRS viewport, one K6 launch each, against easu_h_reference (the
     torch chain on the card: float16 as above, codes at most CODE_SHARE
     one code off, the share printed); the frame as a 0-d int32 tensor on
     the card over three frames and a captured replay, bit-equal to a host
     int; at batch 4 (a16) the HDR tail, (b16) the display path, (c16) the
     byte video path, (d16) RGBA display and (u16) gamma2 + 10-bit TEPD
     into uint16, each one K6 launch and no other device operation in a
     traced call, against the torch chain, timed in turn (the call, K6
     with the tail alone, the bare K6 on the same frames, the torch chain);
     then float16 images under
     float32 and bfloat16 math at batch 4 (Performance, Quality, RGBA):
     one K1 or K2 launch and no K6 each, bit-equal to the call on the image
     widened to float32 and within phase 4's limits of the plain versions,
     K1/K2 on the float16 and the float32 source timed in turn;
 18. row-sharded execution (fsr_tpu_torch.parallel) on meshes of the card
     repeated: at small sizes K1 with row_offset/global_rows (2x, 4x,
     2x rows by 1x columns; 2, 4 and 8 strips) and K2 with per-strip row
     plans (1.5x, 1.3x, ~1.7x, a DRS offset; 2, 3 and 4 strips), and each
     storage type, code, epilogue and RGBA option on 4 strips, each
     bit-equal to the unsharded kernel output and within phase 12's limits
     of the same sharded call on the plain versions; at full width, batch 4,
     (i) Performance f32 and (ii) Quality bf16 on 4 strips, (iii) the HDR
     tail (a) and (iv) the display path (b) with a dither page through
     UpscalePipeline(mesh=), (v) Performance f32 on dp=2 x sp=2, each with
     exactly 4 launches of each of its kernels, returning a Sharded whose
     shards lie on the mesh's devices and whose gather is bit-equal to the
     unsharded call; CUDA-event times of each, in turn: sharded, sharded
     then .gather(), unsharded; of the strips' kernels beside the unsharded
     kernel, taken in turn; with several cards, (i) and (ii) across them
     too, from a tensor and from a Sharded input, the peak memory of a call
     on the first card below one output's bytes, each card's busy time from
     a trace, and the pipeline's (iii) and (iv) chains across them and the
     batch over them with the frame as a tensor on the first card, from a
     tensor and from a Sharded input, each gather bit-equal to the
     unsharded calls with a host int, and 16 Performance f32 frames
     batch-sharded over the cards in turn with one card; with --trace, the
     device operations of one sharded call of each full-width run, which
     must be the strips' K1/K2 launches, in their strip-source form, and
     the operations of the input's put, the halo rows' copies between cards
     (and each strip's rows of the grain) and nothing else (no output
     gather, no strip cat; (i) on the card: its 4 launches and nothing
     else), and a trace of each run; then K1 and K2 with a strip source
     (kernels/halo.py:StripSource, H1 folded into their staging loads:
     a strip's rows read in place from the strip above's, its own and the
     strip below's) bit-equal to the same kernels on the torch.cat'd
     halo'd strip for uint8/bfloat16/float32, RGB and RGBA, K1's quad and
     generic paths and K2, halos 4 and 8, own rows as views of a larger
     tensor and as buffers, the neighbours whole or their edge rows only, a
     batch and dp x sp frame groups, on the card and with several cards
     the neighbours on other cards (peer access); then (i)-(v) captured once per
     device (parallel.spatial.CapturedSpatial and
     CapturedSpatial.from_pipeline: one CUDA graph of the four strips on the
     card, each strip's kernel reading its neighbours' static buffers),
     each with warm-up + 1 launches of K1 or K2 per strip at construction
     and none at a replay, 8 replays on fresh seeded inputs with the frame as a 0-d int32
     tensor on the card (0, 7, 2**31 - 1, -1) each bit-equal shard by shard
     to the eager call on the same inputs, a replay after the K2 table and
     strip-plan caches are emptied and overwritten still bit-equal; 10 calls
     queued with no host sync from a Sharded input and from a tensor, each
     call's shards cloned on their cards right after it, all bit-equal to
     the eager calls, and the copies one call issues from the host (none
     card to card from a Sharded input); the same 8 synced and 10 queued
     calls from the graphs' own inputs (cap.inputs), filled by put and
     written in place by a producer (after CapturedSpatial.writable()),
     each bit-equal, and no copy into cap.inputs from such a call; across
     cards a producer's write delayed on the last card and a replay delayed
     on the first, each call bit-equal; eager against replay (from an input
     and from cap.inputs) against the staging alone in turn, device and
     wall ms per call, one call and 10 queued, and the host's issue time
     split by step; with --trace one replayed call's device operations held to the
     strips' K1/K2 launches in their strip-source form, no H1 launch, and
     the staging's copies and fill (own rows, grain strips, the page, the
     frame; across cards from a Sharded input no copy between cards but
     the frame's); the
     strips' K1 read in place timed in turn with K1 on the halo'd strips
     and their plain version (the torch.cat); with several cards, (i) and
     (ii), the pipeline's (iii) and (iv) with the frame on every card, and
     16 frames through parallel.sharding.CapturedBatch across them, the
     same checks and each card's busy time and the idle share, eager
     against replay, the eager call's copies between cards no larger than a
     strip's halo rows, and the strips' K1 with their neighbours on other
     cards beside K1 with them on one; and a two-card probe of what an
     event wait captured into a graph binds to (the record at capture, the
     latest at launch, or the latest when the node runs) and what a host
     wait after a launch binds to; then float16 (_f16_strips): fault 21,
     upscale(impl="auto") on a float32 and a float16 downscale, no launch
     and bit-equal to impl="torch" (impl="kernel" raises); at small sizes
     every seam phase in float16 math, each source type x RGB/RGBA x RCAS
     off/on/denoise and the options around K6, n launches of K6's strip
     form each, and a float16 image under float32/bfloat16 math, n
     launches of K1's or K2's, each bit-equal to the unsharded kernel call
     (bare K6 strips also to the torch ops' strips); at full width (vi)
     Performance and (vii) Quality in float16 math, (viii) Performance and
     (ix) Quality (bfloat16) from float16 frames on 4 strips, 4 launches
     each, bit-equal to the unsharded call, a traced call holding its 4
     strip-source launches and nothing else, timed in turn with the strips'
     kernels, the unsharded kernel and the torch ops' strips (K6) or the
     strips of the widened frames (K1, K2); each frame tail of phase 17 x
     source type x RGB/RGBA on 4 strips (n launches of the strip tail form,
     bit-equal to the unsharded call, held to easu_h_reference); (vi-b16)
     the display path through UpscalePipeline(mesh=) on 4 strips, 4 strip
     tail launches and nothing else in a traced call (the strips' rows and
     grain rows read in place), bit-equal to the unsharded call, timed in
     turn with the bare strips, the unsharded call and the torch chain's
     strips; (vi) captured, replays
     bit-equal to the eager call, a traced replay only K6's strip form and
     the frame's fill; across the cards where there are several;
 19. the probes (fsr_tpu_torch/kernels/probes.py, through tools_torch/
     ablation): P1 opmix_replay (RCAS on and off) and P2 opmix_replay_shared
     on the K4-padded one-tile frame, on small grids and then on K1's
     headline grid (120, 135, 4), one launch each, against
     upscale_padded_reference (within 6e-5) and against K1 on the same
     frame; P3 fma_rate (float32 and half2, 4 and 8 chains) against its plain
     recurrence; P4 fp16_probe's three modes (0 and 2 bit-equal, 1 within a
     float16 step per FMA); then every probe, K1 float32 and K1 bfloat16
     timed in turn, with nvidia-smi's clocks, power and temperature before
     and after: K1 - P1 (its global tap loads against shared-memory
     ones), P1 - P2 (its recompute), whether P2 <= P1 <= K1, P2 against its
     op floor, the achieved FMA rates, K1's utilization;
 20. autodiff on the card, batch 1: (i) upscale(preset="performance") f32
     1080p -> 4K, (ii) preset="quality" f32 1440p -> 4K, (iii) sharpen f32
     at 4K, (iv) performance bf16; each forward launches exactly one K1, K2
     or K3 (no K4) and its backward none (the torch twin,
     fsr_tpu_torch/autodiff.py); the gradient under sum(out) bit-equal to
     impl="torch"'s, under sum(out**2) within tests/test_torch_grad.py's
     limits; forward and backward ms (CUDA events) and the peak memory per
     call; at 540p -> 1080p the card's gradient within 1e-5 * max|g| of the
     port's CPU gradient; then examples_torch/train_through_fsr.py's inverse
     problem, 3 Adam steps at 1080p -> 4K, one K1 launch each, the
     displayed MSE lower after them than at the box-downsample baseline;
     with --trace, a trace of each case's forward and backward; then the
     trainer's steps captured as one CUDA graph each (capture.CapturedStep:
     forward K1, the twin's backward, Adam, the clamp), against the eager
     step function from the same start: (v) the inverse problem and (vi)
     the prefilter at the example's --size 96, 20 replays bit-equal to 20
     eager steps, loss and parameters step by step (the prefilter with
     cuDNN deterministic; if its eager step is not repeatable, its
     parameters within PREFILTER_REL), (warm-up + 1) K1 launches at
     capture, none and no aten operation dispatched at a replay; ms per
     step eager against replay in turn, and a trace of each (busy, idle
     share, device operations, K1 once); (vii) the inverse problem at
     1080p -> 4K, 3 replays bit-equal to 3 eager steps, ms per step in
     turn, the eager step's peak memory and what the graph holds.
 21. the application layer on the card, from seeded numpy data in a
     temporary directory: (i) fsr_tpu_torch.cli --preset performance on a
     1080p PNG -> 4K with --benchmark 5 --results (one K1 per run, no K4;
     the PNG's codes equal to upscale(x, preset="performance")'s; the
     CLI's device ms beside the library call's), (ii) --preset quality
     --dtype bfloat16 from 1440p (one K2), (iii) --hdr --grain 0.2 and
     --gamma2-out --grain 0.2 --dither-bits 10, --frame 3 (one K1 each),
     against the same CLI call on the plain kernels by phase 12's limits,
     and --hdr --dither-bits 10 refused as the reference refuses it;
     (iv) examples_torch/sample_app.py at 3840x2160, Quality: a 5-frame
     flythrough with CSV and two screenshots (one K2 per frame), a frame
     and the HDR chain against the plain kernels, the frame's traced
     kernel table and K2's share of it (the app replays its frame captured
     as a CUDA graph when it is built: its launches are counted at capture,
     none at a replay; phase 23 reads a replay's from a trace); (v)
     video_upscale, 16 frames 1080p -> 4K in batches of 8 (one K1 per
     batch); (vi) dataset_preprocessing, u8 batches of 4 per card on
     make_mesh() (one K1 per card, captured, replayed per batch; each
     batch's output a Sharded on the cards); (vii) frame_graph at
     1080p -> 4K (one K1) and its kernel table; (viii) tools_torch/
     quality_study.py on the card within 0.01 dB of its CPU run; (ix) the
     native host layer built with cc, bit-equal to the numpy constants.
 22. the measurement tools of tools_torch on the card: headline_probe
     (K1, 1080p -> 4K bf16, batch 1) and preset_bench (1.3x, 1.5x, 1.7x to
     4K in bf16: one K2 and no K1 per call, maxdev_f32 within 2e-5) on the
     production library; u8_writeback_ab's byte-output routes (the
     bf16+encode codes at most one code from direct_u8's); one K1 knockout
     (FSR_ABL_K1_POLY) and one K2 knockout (FSR_ABL_K2_NOG) built in
     parallel, each library's fsr_ablation_mask() exactly its macro and its
     output different from production's (wrong by design).  Phase 2 holds
     the production library's mask to 0 (no knockout).
 23. captured frames (fsr_tpu_torch/utils/capture.py, the counterpart of
     jax.jit over a frame): K1 and K2 with the 8- and 10-bit hash dither,
     their plain versions, upscale, tonemap_pass, tepd_dither,
     texture_dither, and UpscalePipeline with a blue-noise page (fused into
     K1, and K2's bf16 after-pass) and with the hash after-pass, each with
     the frame as a 0-d int32 tensor on the card bit-equal to the same call
     with a host int, frames 0, 7, 2**31 - 1 and -1; the sample app at
     3840x2160 in every mode (Quality K2 and Performance K1, bilinear,
     native; HDR on and off), each captured when built (its counted
     launches the warm-up's and the capture's) and each of 8 replays, with 8 cameras
     and frame indices, bit-equal to the eager frame on the same inputs
     (no launch counted at a replay); a traced replay with exactly one K2
     (Performance: one K1) and no K4; eager against replay in turn, device
     ms per frame (CUDA events, 10 queued) and wall ms per frame (host
     clock, synchronised), with each one's device operations per frame and
     traced idle share; frame_graph's tail and dataset_preprocessing's
     graphs replayed against the eager calls over 4 frames or batches with
     distinct frame indices (the dataset's shard by shard); upscale(preset="performance") at batch 1,
     captured against eager: one-call latency and 10 calls queued; last,
     the forms that make a frame capturable (constants filled on the card
     in core/tonemap, core/transfer, core/easu_math and
     ops/extras.tepd_quantize; the tap tables of ops/easu and K2 from
     caches) each captured, its replay bit-equal to the eager call in
     float32 and bfloat16, and still bit-equal after the table caches are
     emptied and their freed memory overwritten (a graph keeps the tables
     it was captured with).
The card's name and power limit, a JSON object describing the kernels
(times per call, and bound_ms: the larger of the bytes over 3.35 TB/s and
the float32 operations the function needs, counted (EASU_OPS, RCAS_OPS),
over 67 TFLOP/s; operations on halves over 134: half2's, and K6's float16
share, EASU_H_OPS and RCAS_H_OPS) and the JSON result line
are the last three lines.  Exits non-zero with no result when CUDA is
unavailable.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import contextlib
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_TOL = 6e-5
# The kernels' readings (K* and the library call) bracket this many calls
# queued back to back per CUDA-event sample (profiling.cuda_time_ms): each
# call's host work overlaps the kernels before it, so they read device time
# per call.  The "call" readings stay one call each (latency, host included).
KQ = dict(queue=10)
BF16_MAX = 2.0 ** -8
BF16_MEDIAN = 1.0 / 1250.0
BF16_P99 = 1.25 / 255.0
ORACLE_TOL = 2e-5
CODE_SHARE = 1e-4
TORCH_SHARE = 1e-3
MAIN_SHAPE = (4, 3, 1080, 1920)
QUALITY_SHAPE = (4, 3, 1440, 2560)
SHARPEN_SHAPE = (4, 3, 2160, 3840)
# K1's, K2's and K6's __global__ functions, as a device trace names them
# (their strip-source forms too), the strip-source forms alone, and H1's
# before it was folded into them (a trace must hold none).
KERNEL_NAMES = {"K1": "fused_kernel", "K2": "staged_gather_kernel", "K6": "easu_h_kernel", "H1": "halo_kernel"}
STRIP_NAMES = {"K1": "fused_kernel_strip", "K2": "staged_gather_kernel_strip", "K6": "easu_h_kernel_strip"}
# docs/FIDELITY.md f16 rows: mixed against the float32 oracle, strict
# against the float16 oracle.
F16_MIXED = dict(median=1.0 / 2040.0, p99=5.0 / 255.0, share=0.04)
F16_STRICT = dict(median=1e-3, p999=5e-3, share=0.002)
F16_ULP = 2.0 ** -11  # one float16 step in [0.5, 1)
# K6 against its plain version (phase 17): bit-equal, or at most this share
# of the values off, each by one float16 step.
F16_SHARE = 1e-4
# K6's static SASS (opmix_floor.sass_counts, HALF_SASS_OPS; "other": every
# other instruction) and its half arithmetic by lanes (two, one) in its
# first design, one pixel a thread with scalar halves and float32
# divisions, from tools_torch/ablation/kernel_ab.py's build of that commit
# (nvcc 12.9, sm_90a); phase 17 prints them beside this tree's.
K6_SASS_PARENT = dict(HADD2=109, HMUL2=103, HMNMX2=38, HFMA2=55, HSETP2=0, PRMT=168, F2FP=12, MUFU=11, FADD=56,
                      FMUL=48, FFMA=47, FMNMX=17, LDS=43, STS=25, STG=3, BAR=2, CALL=7, other=936)
K6_LANES_PARENT = (127, 163)
# P3 against its plain recurrence (phase 19), relative: float32 (64 FMAs
# against a mul and an add each); half2 two float16 steps.
P3_F32_REL = 1e-5
P3_HALF2_REL = 2.0 ** -9
# Phase 20's gradient limits, those of tests/test_torch_grad.py: the kernel
# path against the torch path under a squared loss (float32; bfloat16 by p99
# and median relative to max|g|), the card against the CPU (float32).
GRAD_SQ_RTOL, GRAD_SQ_ATOL = 5e-3, 5e-4
GRAD_BF16_SQ_P99, GRAD_BF16_SQ_MEDIAN = 3e-2, 2e-3
GRAD_REL = 1e-5
# Phase 20 (vi): the prefilter's parameters after 20 replays against 20
# eager steps, relative to their largest, where cuDNN's conv backward is
# not repeatable eager against eager (else bit-equal).
PREFILTER_REL = 1e-6

# The least time the card could take (the kernels line's bound_ms): the
# larger of the bytes a kernel must move over the HBM3 rate and its
# float32 operations over the float32 rate outside the tensor cores (H100
# SXM data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
HALF2_OPS_PER_S = 134e12  # float16 pairs (__hfma2), twice the float32 rate
# float32 operations the function needs (FMA = 2), per output pixel: EASU
# and RCAS counted from the kernels' torch twins, convention 2 of
# tools_torch/ablation/fused_roofline.py (each aten op weighted by its output
# elements; a bit trick at its CUDA cost, 1 or 2 integer ops; the texel
# response and luma per source texel, a quarter per pixel at 2x);
# tests/test_torch_probes.py holds these to the count.  The
# TEPD dither, LFGA grain and RGBA's bilinear alpha per output pixel, and
# the SRTM prologue per source texel, are estimated from the sources
# (PERF.md section 3).  The kernels do more than this (K1 recomputes EASU
# on a one-pixel ring around each 30x30 tile, 1.138x; K2 around each 32x32
# tile, 1.129x; both run the prologue once per staged texel, and a block's
# window re-reads the texels of its neighbours' windows): that recompute is
# the kernels' cost, not the function's, so the bound leaves it out.
EASU_OPS = 392.75
RCAS_OPS = 96
EASU_RCAS_OPS = EASU_OPS + RCAS_OPS
# K6's function, the float16 torch path (ops.easu "mixed" in its non-fast
# forms, then FsrRcasH), per output pixel by the same convention, as
# (float32, float16) operations: the halves' over HALF2_OPS_PER_S, the
# direction estimate's float32 and the bit tricks' integer operations over
# F32_OPS_PER_S (fused_roofline.easu_rcas_h_ops; tests/test_torch_probes.py
# holds these to the count).
EASU_H_OPS = (73.75, 413)
RCAS_H_OPS = (1, 128)
SRTM_OPS_PER_TEXEL = 10
TEPD_OPS = 60
LFGA_OPS = 12
ALPHA_OPS = 8


def _card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _compare(got: torch.Tensor, want: torch.Tensor, what: str, bf16_max=None) -> float:
    """Phase 4's limits: float32 by max-abs; bfloat16 (or float32 values
    held to bf16 limits with a max of `bf16_max`) by median, p99 and max."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    d = (got.float() - want.float()).abs()
    mx = d.max().item()
    f32_limits = got.dtype == torch.float32 and bf16_max is None
    bf16_max = BF16_MAX if bf16_max is None else bf16_max
    if f32_limits:
        ok = mx <= F32_TOL
        print(f"  {what}: max-abs {mx:.3e} (limit {F32_TOL:g})")
    else:
        flat = d.flatten()
        if flat.numel() > 1 << 24:
            flat = flat[:: flat.numel() // (1 << 24) + 1]
        med = flat.median().item()
        p99 = torch.quantile(flat, 0.99).item()
        ok = mx <= bf16_max and med <= BF16_MEDIAN and p99 <= BF16_P99
        print(f"  {what}: max-abs {mx:.3e} median {med:.3e} p99 {p99:.3e} "
              f"(limits {bf16_max:g}, {BF16_MEDIAN:g}, {BF16_P99:g})")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return mx


def _compare_steps(got: torch.Tensor, want: torch.Tensor, bits, what: str) -> float:
    """Codes and dithered outputs: identical, or at most CODE_SHARE of the
    values off, each by one code (one dither step: a whole 8-bit step in
    10-bit codes).  Returns the largest difference in output units."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    if got.dtype in (torch.uint8, torch.uint16):
        max_code = 255 if got.dtype == torch.uint8 else 1023
        limit = 1.0 if bits is None else float(-(-max_code // (2 ** bits - 1)))
        d = (got.to(torch.int32) - want.to(torch.int32)).abs().double()
        scale = 1.0 / max_code
    else:
        # one step; in bf16 storage plus the bf16 step of the rounded code
        limit = 1.01 / (2 ** bits - 1) + (BF16_MAX if got.dtype == torch.bfloat16 else 0.0)
        g, w = got.double(), want.double()
        d = torch.where(torch.isnan(g) & torch.isnan(w), 0.0, (g - w).abs()).nan_to_num(nan=float("inf"))
        scale = 1.0
    off = int((d > 0).sum())
    mx = d.max().item()
    share = off / d.numel()
    print(f"  {what}: {off} of {d.numel()} values off (share {share:.2e}, limit {CODE_SHARE:g}), "
          f"max {mx:g} (limit {limit:g})")
    if share > CODE_SHARE or mx > limit:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return mx * scale


def _compare_epilogue(got: torch.Tensor, want: torch.Tensor, epi, what: str) -> float:
    """Phase 12's limits.  Float outputs as phase 4; an SRTM^-1 output after
    the forward tonemap (the inverse multiplies a difference by (1 + y)^2 at
    output y; the tonemap maps both back to the domain the kernel computed
    in; in bf16 storage a value and its max3 each round before the tonemap,
    so the max limit is two bf16 steps); codes and dithered outputs by
    ``_compare_steps``."""
    from fsr_tpu_torch.ops.extras import srtm

    bits = epi.dither_bits if epi is not None else None
    if got.dtype in (torch.uint8, torch.uint16) or bits is not None:
        return _compare_steps(got, want, bits, what)
    if epi is not None and epi.transform == "srtm_inv":
        bf16_out = got.dtype == torch.bfloat16
        got, want = (srtm(t.float()) for t in (got, want))
        return _compare(got, want, what + " (after the forward tonemap)",
                        2 * BF16_MAX + F32_TOL if bf16_out else None)
    return _compare(got, want, what)


def _compare_torch_path(got: torch.Tensor, want: torch.Tensor, what: str, step=None) -> None:
    """A fused path against the plain-torch pipeline, whose forms are not the
    kernels' fast ones: at most TORCH_SHARE of the values at another code or
    dither step, each by at most `step`.  step=None: bf16 arithmetic on the
    torch side, so its codes are held by the bf16 contract of
    docs/FIDELITY.md (median 1/510, p99 5/255) plus one dither step: median
    <= 1 code and p99 <= 6 codes."""
    d = (got.double() - want.double()).abs()
    if step is None:
        flat = d.flatten()[:: d.numel() // (1 << 24) + 1]
        med, p99 = flat.median().item(), torch.quantile(flat, 0.99).item()
        print(f"  {what} vs the plain-torch pipeline: code differences median {med:g} p99 {p99:g} "
              f"max {d.max().item():g} (limits 1, 6)")
        if med > 1 or p99 > 6:
            raise AssertionError(f"{what}: disagrees with the plain-torch pipeline")
        return
    share = (d > 1e-6).double().mean().item()
    print(f"  {what} vs the plain-torch pipeline: share {share:.2e} at another code or step "
          f"(limit {TORCH_SHARE:g}), max {d.max().item():g} (limit {step:g})")
    if share > TORCH_SHARE or d.max().item() > step:
        raise AssertionError(f"{what}: disagrees with the plain-torch pipeline")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S, half_ops: float = 0):
    """(bound_ms, bound_by): the byte floor or the operation floor (``ops``
    at ``ops_per_s``, ``half_ops`` at the half rate), whichever is
    larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = (ops / ops_per_s + half_ops / HALF2_OPS_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _kernel_entry(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops, library_ms=None,
                  ops_per_s=F32_OPS_PER_S, half_ops=0):
    """One entry of the kernels line; the bound from this run's shapes."""
    bound_ms, bound_by = _bound(nbytes, ops, ops_per_s, half_ops)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def _f16_stats(got: torch.Tensor, want: np.ndarray, what: str, row: dict) -> None:
    """A float16 output held by a docs/FIDELITY.md f16 row."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    d = np.abs(got.float().cpu().numpy() - want.astype(np.float32))
    stats = {"median": float(np.median(d)), "p99": float(np.percentile(d, 99)),
             "p999": float(np.percentile(d, 99.9)), "share": float((d > 1.0 / 255.0).mean())}
    print(f"  {what}: median {stats['median']:.3e} p99 {stats['p99']:.3e} p99.9 {stats['p999']:.3e} "
          f"share over 1/255 {stats['share']:.4f} max {d.max():.3e} (limits {row})")
    if any(stats[k] > v for k, v in row.items()):
        raise AssertionError(f"{what}: outside the docs/FIDELITY.md f16 row")


def _back_to_back_ms(fn, n: int = 10) -> float:
    """Device time per call of n calls queued back to back (host launch
    overhead hidden behind the queue), from one CUDA-event pair."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# The kernels whose launches the checks count, as their ``fsr.launch``
# spans name them (``fsr_tpu_torch/utils/profiling.py``).
KERNELS = ("K4", "K1", "K2", "K3", "K6", "P1", "P2", "P3", "P4")


def _launches(rec, kernels=KERNELS) -> dict:
    """{kernel: its launches} among the spans ``rec`` recorded."""
    n = rec.launches()
    return {k: n[k] for k in kernels}


def _drive(fn, need):
    """Run fn with its spans recorded; fail unless each kernel in `need`
    launched exactly once (a dict: exactly need[k] times) and no other
    kernel launched.  Returns fn's result and the counts."""
    from fsr_tpu_torch.utils import profiling

    want = need if isinstance(need, dict) else {k: 1 for k in need}
    with profiling.recording() as rec:
        out = fn()
    torch.cuda.synchronize()
    got = _launches(rec)
    if got != {k: want.get(k, 0) for k in KERNELS}:
        raise AssertionError(f"launch counts {got}: the path must launch exactly {want}")
    return out, got


@contextlib.contextmanager
def _plain_kernels():
    """K1's (both entry points), K2's, K4's and K6's plain versions in place
    of their wrappers, so that a path runs on the card with the same inputs
    and no kernel."""
    from fsr_tpu_torch.kernels import easu_gather, easu_h, fused, pad

    saved = pad.edge_pad, fused.upscale_padded, fused.upscale_fused, easu_gather.easu_gather, easu_h.easu_h
    pad.edge_pad = pad.edge_pad_reference
    fused.upscale_padded = fused.upscale_padded_reference
    fused.upscale_fused = fused.upscale_fused_reference
    easu_gather.easu_gather = easu_gather.easu_gather_reference
    easu_h.easu_h = easu_h.easu_h_reference
    try:
        yield
    finally:
        pad.edge_pad, fused.upscale_padded, fused.upscale_fused, easu_gather.easu_gather, easu_h.easu_h = saved


def _check_sharded(got, want, plain, epi, what) -> float:
    """A sharded output: bit-equal to the unsharded kernel output `want`,
    and within phase 12's limits of the plain versions' `plain` (RGBA's
    alpha bit-equal)."""
    if got.shape != want.shape or got.dtype != want.dtype or got.device != want.device:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} {got.device} vs "
                             f"{tuple(want.shape)} {want.dtype} {want.device}")
    if not torch.equal(got, want):
        off = int((got != want).sum())
        raise AssertionError(f"{what}: {off} values differ from the unsharded kernel output")
    if got.shape[-3] == 4:
        if not torch.equal(got[..., 3, :, :], plain[..., 3, :, :]):
            raise AssertionError(f"{what}: alpha not bit-equal to the plain version")
        got, plain = got[..., :3, :, :], plain[..., :3, :, :]
    return _compare_epilogue(got, plain, epi, what + " vs the plain versions")


def _on_mesh(out, what) -> None:
    """``out`` is a ``Sharded`` whose shards lie on their mesh devices."""
    from fsr_tpu_torch.parallel import sharding

    if not isinstance(out, sharding.Sharded):
        raise AssertionError(f"{what}: returned a {type(out).__name__}, not a Sharded")
    where = [s.device for s in out.shards]
    if where != sharding._shard_devices(out.mesh, out.spec):
        raise AssertionError(f"{what}: shards on {where}, the mesh places them on "
                             f"{sharding._shard_devices(out.mesh, out.spec)}")


def _row_sharded(dev, card: str, gen, trace: bool) -> list:
    """Phase 18: row-sharded (and dp x sp) execution through
    ``fsr_tpu_torch.parallel`` on meshes of the card repeated, and across
    cards where there are several; with ``trace``, a profiler trace of each
    full-width run.  Returns its entries of the kernels line."""
    import fsr_tpu_torch as ft
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels import easu_gather, fused, halo
    from fsr_tpu_torch.kernels.epilogue import Epilogue
    from fsr_tpu_torch.parallel import sharding, spatial
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, cuda_times_in_turn, device_trace

    f32, bf16, u8, u16 = torch.float32, torch.bfloat16, torch.uint8, torch.uint16
    cards = torch.cuda.device_count()
    print(f"phase 18: row-sharded execution (fsr_tpu_torch.parallel) on meshes of {dev} repeated; "
          + (f"across {cards} cards too" if cards > 1 else "one card: no run across cards"))

    def mesh(n, names=("sp",), shape=None):
        return sharding.make_mesh(n, names, shape, devices=[dev] * n)

    def src(kind, in_hw):
        x = torch.rand((2, 4 if kind.startswith("rgba") else 3, *in_hw), generator=gen, device=dev)
        return {"hdr": lambda: x * 16, "u8": lambda: (x * 255).to(u8),
                "rgba u8": lambda: (x * 255).to(u8)}.get(kind, lambda: x)()

    # Small sizes: every seam phase (2x, 4x, 1x columns; 1.3x/1.5x/1.7x
    # and a DRS offset on K2), the storage types, codes, the epilogue and
    # RGBA, each held bit-equal to the unsharded kernel output and within
    # phase 12's limits of the same sharded path on the plain versions.
    drs = dict(input_viewport=(92, 138), input_offset=(2, 3))
    options = [
        ("bf16", "float", dict(compute_dtype=bf16)),
        ("u8 ->u8", "u8", dict(out_dtype=u8)),
        ("f32 ->u16", "float", dict(out_dtype=u16)),
        ("RGBA", "rgba", {}),
        ("RGBA u8 ->u8", "rgba u8", dict(out_dtype=u8)),
        ("SRTM + srtm_inv", "hdr", dict(prologue="srtm", epilogue=Epilogue(transform="srtm_inv"))),
        ("gamma2 + grain + hash dither10", "float",
         dict(epilogue=Epilogue(transform="gamma2", grain_amount=0.3, dither_bits=10), frame=5)),
        ("grain + page dither8, u8 ->u8, bf16", "u8",
         dict(epilogue=Epilogue(grain_amount=0.25, dither_bits=8, dither_texture=True), out_dtype=u8,
              compute_dtype=bf16)),
        ("denoise", "float", dict(denoise=True, sharpness=0.5)),
        ("EASU only", "float", dict(apply_rcas=False)),
    ]
    k1_2x, k1_4x, k2_15 = ((96, 160), (192, 320)), ((48, 80), (192, 320)), ((144, 240), (216, 360))
    small = ([("K1 2x", *k1_2x, n, "float", {}) for n in (2, 4, 8)]
             + [("K1 4x", *k1_4x, n, "float", {}) for n in (2, 4, 8)]
             + [("K1 2x rows, 1x columns", (64, 128), (128, 128), 4, "float", {})]
             + [(f"K1 2x {name}", *k1_2x, 4, kind, kw) for name, kind, kw in options]
             + [("K2 1.5x", *k2_15, n, "float", {}) for n in (2, 3, 4)]
             + [("K2 1.3x", (120, 130), (156, 169), n, "float", {}) for n in (2, 3, 4)]
             + [("K2 ~1.7x", (84, 130), (144, 221), n, "float", {}) for n in (2, 3, 4)]
             + [("K2 DRS offset", (96, 144), (132, 192), n, "float", drs) for n in (2, 3, 4)]
             + [(f"K2 1.5x {name}", *k2_15, 4, kind, kw) for name, kind, kw in options])
    small_err = {"K1": 0.0, "K2": 0.0}
    for what, in_hw, out_hw, n, kind, kw in small:
        x = src(kind, in_hw)
        kw = dict(kw, grain=torch.rand((3, *out_hw), generator=gen, device=dev) - 0.5,
                  dither_page=torch.rand((24, 40), generator=gen, device=dev))
        kname = what[:2]
        need = {kname: n}
        got, _ = _drive(lambda: spatial.upscale_spatial_sharded(x, out_hw, mesh(n), **kw), need)
        want = ft.upscale(x, out_size=out_hw, impl="kernel", **kw)
        with _plain_kernels():
            plain = spatial.upscale_spatial_sharded(x, out_hw, mesh(n), **kw).gather()
        torch.cuda.synchronize()
        label = f"{what}, sp={n}"
        _on_mesh(got, label)
        got = got.gather()
        err = _check_sharded(got, want, plain, kw.get("epilogue"), label)
        print(f"  {label}: launches {need}, bit-equal to the unsharded kernel output")
        if got.dtype == f32 and kw.get("epilogue") is None:
            small_err[kname] = max(small_err[kname], err)

    # Full width, batch 4, at the slice's sizes: 1080p (Performance 2x)
    # and 1440p (Quality 1.5x) to 4K.
    out4k = (2 * MAIN_SHAPE[2], 2 * MAIN_SHAPE[3])
    nframes = MAIN_SHAPE[0]
    frames = torch.rand(MAIN_SHAPE, generator=gen, device=dev)
    qframes = torch.rand(QUALITY_SHAPE, generator=gen, device=dev).to(bf16)
    hdr = frames * 16
    q8 = (qframes.float() * 255).to(u8)
    grain4k = torch.rand((3, *out4k), generator=gen, device=dev) - 0.5
    tex = torch.rand((2, 64, 64), generator=gen, device=dev)
    tail = dict(hdr_srtm=True, grain_amount=0.3, dither_bits=10, impl="kernel")
    disp = dict(grain_amount=0.25, dither_bits=8, out_dtype=u8, compute_dtype=bf16, dither_texture=tex,
                impl="kernel")
    pipe_a, pipe_b = ft.UpscalePipeline(out4k, **tail), ft.UpscalePipeline(out4k, **disp)
    pipes_a = ft.UpscalePipeline(out4k, mesh=mesh(4), **tail)
    pipes_b = ft.UpscalePipeline(out4k, mesh=mesh(4), **disp)
    dpsp = mesh(4, ("dp", "sp"), (2, 2))
    rows, dp_rows = (None, None, "sp", None), ("dp", None, "sp", None)

    def staged(x, m, spec, halo, grain=None):
        """What a sharded call runs before its kernels: the input put on the
        mesh, each strip's source (the neighbours' edge rows copied where
        they lie on another device; on one card nothing) and, with a grain,
        each strip's rows of it made contiguous for the kernel."""
        xs = sharding.Sharded.put(x, m, spec)
        n = m.shape["sp"]
        parts = [p for i in range(0, len(xs.shards), n) for p in spatial._sources(xs.shards[i:i + n], halo)]
        if grain is not None:
            hl = grain.shape[-2] // n
            parts += [grain[:, k * hl:(k + 1) * hl].contiguous() for k in range(n)]
        return parts

    runs = [
        # name, sharded call, unsharded call, launches, what the sharded call
        # stages before its kernels, (input, call on a mesh) for the run
        # across cards (None: no run across cards)
        ("(i) performance f32, sp=4", lambda: spatial.upscale_spatial_sharded(frames, out4k, mesh(4)),
         lambda: ft.upscale(frames, preset="performance", impl="kernel"), {"K1": 4},
         lambda: staged(frames, mesh(4), rows, spatial._HALO),
         (frames, lambda x, m: spatial.upscale_spatial_sharded(x, out4k, m))),
        ("(ii) quality bf16, sp=4",
         lambda: spatial.upscale_spatial_sharded(qframes, out4k, mesh(4), compute_dtype=bf16),
         lambda: ft.upscale(qframes, preset="quality", compute_dtype=bf16, impl="kernel"), {"K2": 4},
         lambda: staged(qframes, mesh(4), rows, spatial._GHALO),
         (qframes, lambda x, m: spatial.upscale_spatial_sharded(x, out4k, m, compute_dtype=bf16))),
        ("(iii) HDR tail (a), sp=4", lambda: pipes_a(hdr, grain=grain4k, frame=7),
         lambda: pipe_a(hdr, grain=grain4k, frame=7), {"K1": 4},
         lambda: staged(hdr, mesh(4), rows, spatial._HALO, grain4k), None),
        ("(iv) display (b) with a dither page, u8 ->u8, sp=4", lambda: pipes_b(q8, grain=grain4k, frame=7),
         lambda: pipe_b(q8, grain=grain4k, frame=7), {"K2": 4},
         lambda: staged(q8, mesh(4), rows, spatial._GHALO, grain4k), None),
        ("(v) performance f32, dp=2 x sp=2",
         lambda: spatial.upscale_spatial_sharded(frames, out4k, dpsp, axis="sp", batch_axis="dp"),
         lambda: ft.upscale(frames, preset="performance", impl="kernel"), {"K1": 4},
         lambda: staged(frames, dpsp, dp_rows, spatial._HALO), None),
    ]
    full = {}
    print(f"  full width, batch {nframes}, on {card}; mesh [{dev}] * 4:")
    for name, call, unsharded, need, _, _ in runs:
        out, got_n = _drive(call, need)
        want = unsharded()
        torch.cuda.synchronize()
        _on_mesh(out, name)
        got = out.gather()
        if got.shape != want.shape or got.dtype != want.dtype or got.device != want.device:
            raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
        off = int((got != want).sum())
        if off:
            raise AssertionError(f"{name}: {off} values differ from the unsharded call")
        print(f"  {name}: a Sharded {out.shape} {out.dtype}, {len(out.shards)} shards laid out as {out.spec} on "
              f"the mesh's devices; launches {got_n}; its gather bit-equal to the unsharded call (0 of "
              f"{got.numel()} values off)")
        full[name] = dict(launches=got_n, nbytes=_nbytes(*out.shards))
        del out, got, want
    # (i) and (ii) held against the same sharded call on the plain versions.
    for (name, call, *_), key in zip(runs[:2], ("K1", "K2")):
        out = call().gather()
        with _plain_kernels():
            plain = call().gather()
        torch.cuda.synchronize()
        err = _compare(out, plain, f"{name} vs the plain versions")
        if out.dtype == f32:
            small_err[key] = max(small_err[key], err)
        del out, plain

    def beyond(call, stage, kernel):
        """One call's device operations (a trace), and those beyond its
        staging's and its launches of ``kernel``."""
        ops = device_trace(call, 1)["launches"]
        try:
            base = device_trace(stage, 1)["launches"]
        except RuntimeError as e:  # a staging of views only: no device operation to trace
            if "no device operation" not in str(e):
                raise
            base = {}
        extra = {k: round(c - base.get(k, 0.0)) for k, c in ops.items() if kernel not in k}
        return ops, {k: c for k, c in extra.items() if c > 0}

    # Times per 4K frame, in turn: the sharded call, the same call then its
    # gather onto the card (the result before sharded results stayed
    # sharded), the unsharded call; one call (latency, host work included)
    # and 10 queued (the device's time).
    for name, call, unsharded, need, stage, _ in runs:
        fns = {"sharded": call, "sharded + gather": lambda: call().gather(), "unsharded": unsharded}
        for what, kw in (("one call", {}), ("10 queued", KQ)):
            t = cuda_times_in_turn(fns, **kw)
            print(f"    {name}, {what}: sharded {t['sharded'] / nframes:.4f} ms/frame, sharded then .gather() "
                  f"{t['sharded + gather'] / nframes:.4f}, unsharded {t['unsharded'] / nframes:.4f} (sharded "
                  f"{t['sharded'] / t['unsharded'] - 1:+.1%}, its gather "
                  f"{(t['sharded + gather'] - t['sharded']) / nframes:+.4f} ms/frame)")
        if trace:
            (kid, n_k), = need.items()
            kernel = KERNEL_NAMES[kid]
            ops, extra = beyond(call, stage, kernel)
            launched = round(sum(c for k, c in ops.items() if kernel in k))
            in_place = round(sum(c for k, c in ops.items() if STRIP_NAMES[kid] in k))
            print(f"      one sharded call, traced: {launched} launches of {kernel}, {in_place} in its strip-source "
                  "form; with them " + "; ".join(f"{c:g} x {k[:90]}" for k, c in ops.items() if kernel not in k))
            if extra or launched != n_k or in_place != n_k:
                raise AssertionError(f"{name}: operations beyond the strips' {n_k} strip-source launches, the input "
                                     f"and the halo rows' copies: {extra}")
            if name.startswith("(i) ") and set(ops) - {k for k in ops if STRIP_NAMES[kid] in k}:
                raise AssertionError(f"{name}: on one card a traced call holds more than its {n_k} launches: {ops}")
            _, gathered = beyond(lambda: call().gather(), stage, kernel)
            if not gathered:
                raise AssertionError(f"{name}: a traced call then .gather() shows no gather: the check above "
                                     "cannot see one")
            print("      nothing beyond the strips' launches, the input's put and the halo rows' copies (no strip "
                  "cat); the gather would add " + "; ".join(f"{c:g} x {k[:90]}" for k, c in gathered.items()))
            tr = device_trace(call, 5)
            print(f"      traced, 5 sharded calls back to back: device busy {tr['busy_ms']:.4f} ms of a "
                  f"{tr['window_ms']:.4f} ms window, idle share {tr['idle_share']:.4f}")
            for kname, ms in sorted(tr["kernels"].items(), key=lambda kv: -kv[1]):
                print(f"      {ms:.4f} ms/call ({ms / nframes:.4f} ms/frame) {kname[:100]}")

    # The same runs captured once per device (CapturedSpatial), each replay
    # against the eager call on the same inputs.
    def fresh(kind):
        def make():
            x = torch.rand(QUALITY_SHAPE if kind in ("bf16", "u8") else MAIN_SHAPE, generator=gen, device=dev)
            return {"hdr": lambda: x * 16, "bf16": lambda: x.to(bf16), "u8": lambda: (x * 255).to(u8)}.get(
                kind, lambda: x)()
        return make

    captured = [
        # name, the capture, the eager call on (input, frame, grain), its
        # launches per call, fresh inputs, whether it takes grain
        (runs[0][0], lambda: spatial.CapturedSpatial(frames, out4k, mesh(4)),
         lambda x, f, g: spatial.upscale_spatial_sharded(x, out4k, mesh(4), frame=f), {"K1": 4},
         fresh("f32"), False),
        (runs[1][0], lambda: spatial.CapturedSpatial(qframes, out4k, mesh(4), compute_dtype=bf16),
         lambda x, f, g: spatial.upscale_spatial_sharded(x, out4k, mesh(4), compute_dtype=bf16, frame=f),
         {"K2": 4}, fresh("bf16"), False),
        (runs[2][0], lambda: spatial.CapturedSpatial.from_pipeline(pipes_a, hdr, grain=grain4k),
         lambda x, f, g: pipes_a(x, grain=g, frame=f), {"K1": 4}, fresh("hdr"), True),
        (runs[3][0], lambda: spatial.CapturedSpatial.from_pipeline(pipes_b, q8, grain=grain4k),
         lambda x, f, g: pipes_b(x, grain=g, frame=f), {"K2": 4}, fresh("u8"), True),
        (runs[4][0], lambda: spatial.CapturedSpatial(frames, out4k, dpsp, batch_axis="dp"),
         lambda x, f, g: spatial.upscale_spatial_sharded(x, out4k, dpsp, axis="sp", batch_axis="dp", frame=f),
         {"K1": 4}, fresh("f32"), False),
    ]
    strip_err = _strip_source_checks(dev, gen, cards)
    print(f"  captured (CapturedSpatial, one graph per device: one graph of four strips on {dev}):")
    built = _captured_sharded(dev, card, gen, trace, captured, out4k, _sync_all)

    # The strips' kernels alone, in turn with the unsharded kernel: read in
    # place (strip sources over views of the frames, as the eager call on
    # the card passes them), and on the halo'd strips (the torch.cat that
    # the kernels read before H1 was folded into them).
    (ph, pw), (qh, qw) = MAIN_SHAPE[2:], QUALITY_SHAPE[2:]
    pcon = EasuConstants.create((pw, ph), None, out4k[::-1])
    qcon = EasuConstants.create((qw, qh), None, out4k[::-1])
    rcon = RcasConstants(0.25)
    n, hl = 4, out4k[0] // 4
    own = [frames[..., k * ph // n:(k + 1) * ph // n, :] for k in range(n)]
    qown = [qframes[..., k * qh // n:(k + 1) * qh // n, :] for k in range(n)]
    srcs, qsrcs = spatial._sources(own, spatial._HALO), spatial._sources(qown, spatial._GHALO)
    strips, qstrips = spatial._exchange_halo(own, spatial._HALO), spatial._exchange_halo(qown, spatial._GHALO)
    lcon = spatial._local_constants(pcon, spatial._HALO)
    gplans = [easu_gather.shard_plan((qh, qw), out4k, qcon, n, k, spatial._GHALO) for k in range(n)]

    def k1_strips(fn=fused.upscale_fused, of=srcs):
        return [fn(s, (hl, out4k[1]), lcon, rcon, row_offset=k * hl, global_rows=out4k[0])
                for k, s in enumerate(of)]

    def k2_strips(fn=easu_gather.easu_gather, of=qsrcs):
        return [fn(s, (hl, out4k[1]), qcon, rcon, True, False, bf16, row_plan=gplans[k], row_offset=k * hl)
                for k, s in enumerate(of)]

    tk = cuda_times_in_turn({
        "K1 x4 strips": k1_strips, "K1 x4 halo'd strips": lambda: k1_strips(of=strips),
        "K1 unsharded": lambda: fused.upscale_fused(frames, out4k, pcon, rcon),
        "K2 x4 strips": k2_strips, "K2 x4 halo'd strips": lambda: k2_strips(of=qstrips),
        "K2 unsharded": lambda: easu_gather.easu_gather(qframes, out4k, qcon, rcon, True, False, bf16)}, **KQ)
    # The halo rows' plain version (the strips' torch.cat), its device time
    # from a trace; the strips' kernels traced read in place and on the
    # halo'd strips.
    tk["halo'd strips, plain (cat), traced"] = sum(
        device_trace(lambda: spatial._exchange_halo(own, spatial._HALO), 5)["kernels"].values())
    for kid, run, of_in_place, of_cat in (("K1", k1_strips, srcs, strips), ("K2", k2_strips, qsrcs, qstrips)):
        for what, of in ((f"{kid} x4 strips, traced", of_in_place), (f"{kid} x4 halo'd strips, traced", of_cat)):
            tk[what] = sum(ms for k, ms in device_trace(lambda run=run, of=of: run(of=of), 5)["kernels"].items()
                           if KERNEL_NAMES[kid] in k)
    tk["K1 x4 strips, plain"] = cuda_time_ms(lambda: k1_strips(fused.upscale_fused_reference), warmup=1, iters=3)
    tk["K2 x4 strips, plain"] = cuda_time_ms(lambda: k2_strips(easu_gather.easu_gather_reference),
                                             warmup=1, iters=3)
    for k, v in tk.items():
        print(f"    {k:>36}: {v / nframes:.4f} ms/frame ({v:.4f} ms/call)")
    print("  sharded: one call on the mesh (n launches of each kernel, each strip read in place; the output stays "
          "in its strips); + gather: the strips then gathered on the card (Sharded.gather); K* x4 strips: the "
          "strips' kernels alone, read in place, in turn with the same kernels on the halo'd strips and the "
          f"unsharded kernel (3 rounds, median; {card}); traced: device time; plain (cat): the halo'd strips "
          "built by the plain row rule")
    if cards > 1:
        nc = 4 if cards >= 4 else 2
        real = sharding.make_mesh(nc, ("sp",))
        cards_of = list(real.devices.flat)
        print(f"  across {nc} cards ({', '.join(str(d) for d in cards_of)}):")
        # The strips' K1 with strip k on card k mod nc, its neighbours read by
        # peer access, against the four with their neighbours on one card.
        halo.enable_peers((a, b) for a in cards_of for b in cards_of)
        xown = [o.to(d) for o, d in zip(own, itertools.cycle(cards_of))]
        bown = [o.clone() for o in own]
        xsrcs = [halo.StripSource(xown[k - 1] if k else None, xown[k], xown[k + 1] if k + 1 < n else None,
                                  spatial._HALO) for k in range(n)]
        bsrcs = [halo.StripSource(bown[k - 1] if k else None, bown[k], bown[k + 1] if k + 1 < n else None,
                                  spatial._HALO) for k in range(n)]
        _sync_all()
        for k, (a, b) in enumerate(zip(k1_strips(of=xsrcs), k1_strips(of=bsrcs))):
            _sync_all()
            if not torch.equal(a.to(dev), b):
                raise AssertionError(f"K1 on strip {k} with its neighbours on other cards differs from one card")
        th = cuda_times_in_turn({"K1 x4 strips across the cards": _joined(lambda: k1_strips(of=xsrcs), cards_of),
                                 "K1 x4 strips on one card": lambda: k1_strips(of=bsrcs)}, **KQ)
        for where, of in (("across the cards", xsrcs), ("on one card", bsrcs)):
            traced = device_trace(lambda of=of: k1_strips(of=of), 5)
            th[f"K1 x4 strips {where}, traced device ms"] = sum(
                ms for k, ms in traced["kernels"].items() if KERNEL_NAMES["K1"] in k)
            print(f"    K1 x4 strips {where}, traced over 5 calls: per card busy "
                  + ", ".join(f"{i}: {ms / 5:.4f}" for i, ms in traced["busy_ms_by_device"].items()))
        print("    bit-equal; " + ", ".join(f"{k} {v:.4f} ms per call" for k, v in th.items())
              + f" (10 queued; {card})")
        del xown, bown, xsrcs, bsrcs
        for name, _, unsharded, need, _, across in runs:
            if across is None:
                continue
            src, on = across
            xs = sharding.Sharded.put(src, real, rows)
            want = unsharded()
            want_n = {k: nc for k in need}
            for label, x in (("a tensor input", src), ("a Sharded input", xs)):
                out, got_n = _drive(lambda: on(x, real), want_n)
                _sync_all()
                _on_mesh(out, f"{name} across {nc} cards, {label}")
                if not torch.equal(out.gather(dev), want):
                    raise AssertionError(f"{name} across {nc} cards, {label}: differs from the unsharded call")
                del out
            # The eager call from a Sharded moves only halo rows between
            # cards: no copy larger than one strip's edge rows.
            halo_n = spatial._HALO if "K1" in need else spatial._GHALO
            edge = _nbytes(xs.shards[0]) // xs.shards[0].shape[-2] * halo_n
            with _HostCopies() as host:
                on(xs, real)
            _sync_all()
            big = {k: b for k, b in host.largest.items() if k[1] != k[2] and b > edge}
            if big or not host.across_cards():
                raise AssertionError(f"{name} across {nc} cards: copies between cards {dict(host.counts)}, larger "
                                     f"than a strip's {edge} bytes of halo rows: {big}")
            peak = _peak_bytes(lambda: on(xs, real), dev)
            if peak >= _nbytes(want):
                raise AssertionError(f"{name} across {nc} cards: {peak} bytes at the peak on {dev}, not below one "
                                     f"output's {_nbytes(want)}")
            t = cuda_times_in_turn({"across cards, Sharded input": _joined(lambda: on(xs, real), cards_of),
                                    "across cards, tensor input": _joined(lambda: on(src, real), cards_of),
                                    "across cards + gather": lambda: on(xs, real).gather(dev),
                                    "one card, sp=4": lambda: on(src, mesh(4)), "unsharded": unsharded})
            tr = device_trace(lambda: on(xs, real), 5)
            print(f"    {name.replace('sp=4', f'sp={nc}')}: launches {got_n}, shards on their cards, gather "
                  f"bit-equal to the unsharded call, from a tensor and from a Sharded input; from a Sharded input "
                  f"{host.across_cards()} copies between cards, none over a strip's {edge} bytes of halo rows "
                  f"(largest {max(b for k, b in host.largest.items() if k[1] != k[2])}); peak on {dev} "
                  f"{peak / 2**20:.1f} MiB (one output {_nbytes(want) / 2**20:.1f}); "
                  + ", ".join(f"{k} {v / nframes:.4f} ms/frame" for k, v in t.items())
                  + f"; traced over 5 calls (Sharded input): busy {tr['busy_ms']:.4f} of {tr['window_ms']:.4f} "
                  "ms, per card " + ", ".join(f"{i}: {ms:.4f}" for i, ms in tr["busy_ms_by_device"].items()))
            for kname, ms in sorted(tr["kernels"].items(), key=lambda kv: -kv[1])[:8]:
                print(f"      {ms:.4f} ms/call, all cards: {kname[:100]}")
            del xs, want
        _frames_across_cards(dev, gen, nc)
        # Captured across the cards: (i), (ii), the pipeline's (iii) (its
        # hash dither reads the frame on every card) and (iv), and 16 frames
        # batch-sharded, each fresh input a Sharded on the cards.
        bmesh = sharding.make_mesh(nc)
        x16 = torch.rand((16, *MAIN_SHAPE[1:]), generator=gen, device=dev)
        xpipe_a = ft.UpscalePipeline(out4k, mesh=real, **tail)
        xpipe_b = ft.UpscalePipeline(out4k, mesh=real, **disp)

        def on_cards(make, m, spec):
            return lambda: sharding.Sharded.put(make(), m, spec)

        def across(run):
            return runs[run][0].replace("sp=4", f"sp={nc}") + f" across {nc} cards"

        across_cards = [
            (across(0), lambda: spatial.CapturedSpatial(frames, out4k, real),
             lambda x, f, g: spatial.upscale_spatial_sharded(x, out4k, real, frame=f), {"K1": nc},
             on_cards(fresh("f32"), real, rows), False),
            (across(1), lambda: spatial.CapturedSpatial(qframes, out4k, real, compute_dtype=bf16),
             lambda x, f, g: spatial.upscale_spatial_sharded(x, out4k, real, compute_dtype=bf16, frame=f),
             {"K2": nc}, on_cards(fresh("bf16"), real, rows), False),
            (across(2), lambda: spatial.CapturedSpatial.from_pipeline(xpipe_a, hdr, grain=grain4k),
             lambda x, f, g: xpipe_a(x, grain=g, frame=f), {"K1": nc}, on_cards(fresh("hdr"), real, rows), True),
            (across(3), lambda: spatial.CapturedSpatial.from_pipeline(xpipe_b, q8, grain=grain4k),
             lambda x, f, g: xpipe_b(x, grain=g, frame=f), {"K2": nc}, on_cards(fresh("u8"), real, rows), True),
            (f"16 frames 1080p -> 4K f32 batch-sharded over {nc} cards",
             lambda: sharding.CapturedBatch(x16, bmesh, preset="performance"),
             lambda x, f, g: sharding.upscale_batch_sharded(x, bmesh, preset="performance", frame=f), {"K1": nc},
             on_cards(lambda: torch.rand(x16.shape, generator=gen, device=dev), bmesh, ("batch", None, None, None)),
             False),
        ]
        _external_wait_probe(cards_of[:2])
        print(f"  captured across {nc} cards (one graph per card), each input a Sharded on the cards:")
        _captured_sharded(dev, card, gen, trace, across_cards, out4k, _sync_all, cards=cards_of)
        del x16

    npix = nframes * out4k[0] * out4k[1]
    k1_full, k2_full = full[runs[0][0]], full[runs[1][0]]
    # H1's bytes: each strip's halo rows written once, and what they are read
    # from once (a neighbour's rows, or one edge row repeated).
    row_bytes = _nbytes(strips[0]) // strips[0].shape[-2]
    h1_bytes = sum(row_bytes * (2 * spatial._HALO + (spatial._HALO if 0 < k else 1)
                                + (spatial._HALO if k + 1 < n else 1)) for k in range(n))
    # The strips' K1 launches are close to their wrappers' host work, so the
    # in-place read's cost is read from their traced device times.
    in_place, on_cat = tk["K1 x4 strips, traced"], tk["K1 x4 halo'd strips, traced"]
    queued = tk["K1 x4 strips"], tk["K1 x4 halo'd strips"]
    f16_entries = _f16_strips(dev, card, gen, cards)
    print(f"  H1 folded into K1/K2: 0 launches; (i)'s 4 strips read in place {in_place:.4f} device ms per call "
          f"against {on_cat:.4f} on the halo'd strips (traced; in turn, 10 queued: {queued[0]:.4f} and "
          f"{queued[1]:.4f}); the halo rows' byte bound {_bound(h1_bytes, 0)[0]:.4f} ms")
    return [
        _kernel_entry("halo rows (H1), folded into K1/K2's strip-source loads (0 launches): (i)'s 4 strips, ms = "
                      "K1 read in place less K1 on the halo'd strips, traced device time; plain: the strips' "
                      "torch.cat, traced",
                      "fsr_tpu_torch/csrc/fused.cu", "fsr_tpu/parallel/spatial.py:104", 0, strip_err,
                      in_place - on_cat, tk["halo'd strips, plain (cat), traced"], h1_bytes, 0),
        _kernel_entry("upscale_fused (K1), row-sharded, strips read in place: performance f32, sp=4",
                      "fsr_tpu_torch/csrc/fused.cu", "fsr_tpu/kernels/fused.py:403", k1_full["launches"]["K1"],
                      max(small_err["K1"], strip_err), tk["K1 x4 strips"], tk["K1 x4 strips, plain"],
                      _nbytes(*strips) + k1_full["nbytes"], EASU_RCAS_OPS * npix),
        _kernel_entry("easu_gather (K2), row-sharded, strips read in place: quality bf16, sp=4",
                      "fsr_tpu_torch/csrc/easu_gather.cu", "fsr_tpu/kernels/easu_gather.py:350",
                      k2_full["launches"]["K2"], max(small_err["K2"], strip_err), tk["K2 x4 strips"],
                      tk["K2 x4 strips, plain"], _nbytes(*qstrips) + k2_full["nbytes"], EASU_RCAS_OPS * npix),
    ] + f16_entries


def _f16_strips(dev, card: str, gen, cards: int) -> list:
    """Phase 18's float16 row strips, and fault 21 on the card.  First
    ``upscale(impl="auto")`` on a downscale (float32 and float16 math): no
    launch, bit-equal to ``impl="torch"``; ``impl="kernel"`` raises.  Then
    at small sizes, on ``[dev] * n``, every seam phase (2x, 4x, 1.5x, 1.3x,
    ~1.7x, a DRS offset; 2, 3, 4 and 8 strips) in float16 math, each source
    type x RGB/RGBA x RCAS off/on/denoise on 4 strips, the prologue, an
    epilogue and a byte output, and each frame tail of phase 17 x source
    type x RGB/RGBA in K6: n launches of K6's strip form (its tail form
    with an option), bit-equal to the unsharded K6 call (the bare calls
    also to the torch ops on the same strips, the frame tails held to
    ``easu_h_reference``); a float16 image under float32 and bfloat16
    math: n launches of K1's or K2's strip form, bit-equal to the unsharded
    call.  At full width, batch 4, on 4 strips: (vi) Performance and (vii)
    Quality in float16 math (K6), (viii) Performance and (ix) Quality
    (bfloat16 storage) from float16 frames (K1, K2), each 4 launches,
    bit-equal to the unsharded call ((vi)/(vii) also to the torch ops'
    strips), a traced call holding the 4 strip-source launches and no other
    device operation; in turn: the sharded call, the strips' kernels read
    in place, the unsharded kernel, and the torch ops' strips (K6) or the
    strips of the frames widened to float32 (K1, K2).  (vi) captured
    (``CapturedSpatial``): (warm-up + 1) x 4 K6 launches at construction,
    none at a replay, replays on fresh inputs bit-equal to the eager call,
    a traced replay only K6's strip form and the frame's fill; (vi-b16),
    ``_display_strips``.  Across the
    cards where there are several, (vi) and (viii) from a tensor and a
    ``Sharded`` input, and (vi) captured.  Returns the kernels line's
    entries."""
    import fsr_tpu_torch as ft
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels import easu_gather, easu_h, fused
    from fsr_tpu_torch.kernels.epilogue import Epilogue
    from fsr_tpu_torch.parallel import sharding, spatial
    from fsr_tpu_torch.utils import capture
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, cuda_times_in_turn, device_trace

    f16, f32, bf16, u8 = torch.float16, torch.float32, torch.bfloat16, torch.uint8
    print("  fault 21: upscale(impl='auto') on a downscale on the card")
    x = torch.rand((2, 3, 27, 48), generator=gen, device=dev)
    for dt in (f32, f16):
        xs = x.to(dt)
        out, n = _drive(lambda: ft.upscale(xs, out_size=(20, 40), compute_dtype=dt), ())
        same = torch.equal(out, ft.upscale(xs, out_size=(20, 40), compute_dtype=dt, impl="torch"))
        try:
            ft.upscale(xs, out_size=(20, 40), compute_dtype=dt, impl="kernel")
            raised = False
        except NotImplementedError:
            raised = True
        print(f"    {str(dt)[6:]} 27x48 -> 20x40, auto: {tuple(out.shape)} {out.dtype}, launches {n}, bit-equal to "
              f"impl='torch': {same}; impl='kernel' raises NotImplementedError: {raised}")
        if not same or not raised or out.shape[-2:] != (20, 40):
            raise AssertionError(f"fault 21 on the card ({dt}): impl='auto' must return the torch path's image")

    def mesh(n):
        return sharding.make_mesh(n, ("sp",), None, devices=[dev] * n)

    def same16(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.view(torch.int16) if a.dtype == f16 else a, b.view(torch.int16) if b.dtype == f16 else b)

    small = torch.rand((2, 4, 144, 240), generator=gen, device=dev)

    def source(kind, nc, hw):
        x = small[:, :nc, :hw[0], :hw[1]].contiguous()
        return (x * 255).to(u8) if kind == "uint8" else x.to(getattr(torch, kind))

    drs = dict(input_viewport=(92, 138), input_offset=(2, 3))
    geoms = [("2x", (96, 160), (192, 320), (2, 4, 8), {}), ("4x", (48, 80), (192, 320), (2, 4), {}),
             ("1.5x", (96, 160), (144, 240), (2, 3, 4), {}), ("1.3x", (120, 130), (156, 169), (2, 3, 4), {}),
             ("~1.7x", (84, 130), (144, 221), (2, 3, 4), {}), ("DRS offset", (96, 144), (132, 192), (2, 3, 4), drs)]
    cases = [(f"K6 {g}, float16 RGB", "float16", 3, in_hw, out_hw, n, dict(kw, compute_dtype=f16), "K6")
             for g, in_hw, out_hw, ns, kw in geoms for n in ns]
    cases += [(f"K6 {g}, {kind} {('RGB', 'RGBA')[nc - 3]}, {mode}", kind, nc, in_hw, out_hw, 4,
               dict(compute_dtype=f16, apply_rcas=rc, denoise=dn), "K6")
              for g, in_hw, out_hw, _, _ in geoms[::2] for kind in ("float16", "float32", "bfloat16", "uint8")
              for nc in (3, 4) for mode, rc, dn in (("RCAS off", False, False), ("RCAS on", True, False),
                                                   ("denoise", True, True))]
    opts = [("SRTM + srtm_inv", dict(prologue="srtm", epilogue=Epilogue(transform="srtm_inv"))),
            ("gamma2 + grain + hash dither10", dict(epilogue=Epilogue(transform="gamma2", grain_amount=0.3,
                                                                      dither_bits=10), frame=5)),
            ("grain + page dither8, ->u8", dict(epilogue=Epilogue(grain_amount=0.25, dither_bits=8,
                                                                  dither_texture=True), out_dtype=u8))]
    cases += [(f"K6 {g}, float16 RGBA, {name}", "float16", 4, in_hw, out_hw, 4, dict(kw, compute_dtype=f16), "K6")
              for g, in_hw, out_hw, _, _ in geoms[:3:2] for name, kw in opts]
    # Each frame tail of phase 17 (_f16_tails) x source type x RGB/RGBA on 4
    # strips at 2x: n launches of the strip tail form, bit-equal to the
    # unsharded call and held to easu_h_reference on the card.
    cases += [(f"K6 2x, {kind} {('RGB', 'RGBA')[nc - 3]}, {tail}", kind, nc, (96, 160), (192, 320), 4,
               dict(compute_dtype=f16, tail=tail), "K6")
              for tail in _f16_tails(None, None) for kind in ("float16", "float32", "bfloat16", "uint8")
              for nc in (3, 4)]
    cases += [(f"{kid} {g}, float16 {('RGB', 'RGBA')[nc - 3]} under {str(dt)[6:]} math", "float16", nc, in_hw,
               out_hw, n, dict(kw, compute_dtype=dt), kid)
              for (g, in_hw, out_hw, ns, kw), kid in zip(geoms, ("K1", "K1", "K2", "K2", "K2", "K2"))
              for n in ns[-2:] for nc in (3, 4) for dt in (f32, bf16)]
    for what, kind, nc, in_hw, out_hw, n, kw, kid in cases:
        x = source(kind, nc, in_hw)
        tail = kw.get("tail")
        kw = dict({k: v for k, v in kw.items() if k != "tail"},
                  grain=torch.rand((3, *out_hw), generator=gen, device=dev) - 0.5,
                  dither_page=torch.rand((24, 40), generator=gen, device=dev))
        if tail is not None:
            kw.update(_f16_tails(kw["grain"], kw["dither_page"])[tail])
        got, _ = _drive(lambda: spatial.upscale_spatial_sharded(x, out_hw, mesh(n), **kw), {kid: n})
        _on_mesh(got, what)
        got = got.gather()
        if not same16(got, ft.upscale(x, out_size=out_hw, impl="kernel", **kw)):
            raise AssertionError(f"{what}, sp={n}: differs from the unsharded kernel call")
        if tail is not None:
            con = EasuConstants.create(in_hw[::-1], None, out_hw[::-1])
            _compare_tail(got, easu_h.easu_h_reference(x, out_hw, con, RcasConstants(0.25), **{
                k: v for k, v in kw.items() if k != "compute_dtype"}), f"{what}, sp={n}: vs easu_h_reference")
        if kid == "K6" and "epilogue" not in kw and "prologue" not in kw:
            if not same16(got, spatial.upscale_spatial_sharded(x, out_hw, mesh(n), impl="torch", **kw).gather()):
                raise AssertionError(f"{what}, sp={n}: differs from the torch ops on the same strips")
    print(f"  float16 strips at small sizes: {len(cases)} cases, each n launches of K6's strip form (float16 math) or "
          "of K1's / K2's (a float16 image under float32 / bfloat16 math) and bit-equal to the unsharded kernel call; "
          "the bare K6 cases also to the torch ops' strips, the frame tails held to easu_h_reference")

    # Full width, batch 4, 4 strips.
    out4k = (2 * MAIN_SHAPE[2], 2 * MAIN_SHAPE[3])
    nframes = MAIN_SHAPE[0]
    p16 = torch.rand(MAIN_SHAPE, generator=gen, device=dev).half()
    q16 = torch.rand(QUALITY_SHAPE, generator=gen, device=dev).half()
    rcon = RcasConstants(0.25)
    runs = [("(vi) performance f16, sp=4", p16, dict(preset="performance", compute_dtype=f16), "K6"),
            ("(vii) quality f16, sp=4", q16, dict(preset="quality", compute_dtype=f16), "K6"),
            ("(viii) performance, float16 frames under float32 math, sp=4", p16, dict(preset="performance"), "K1"),
            ("(ix) quality, float16 frames under bfloat16 math, sp=4", q16,
             dict(preset="quality", compute_dtype=bf16), "K2")]
    full, entries = {}, []
    print(f"  float16 strips at full width, batch {nframes}, mesh [{dev}] * 4, on {card}:")
    for name, x, kw, kid in runs:
        skw = {k: v for k, v in kw.items() if k != "preset"}
        layout = spatial._layout(tuple(x.shape[-2:]), out4k, 4, None, (0, 0))

        def call(x=x, skw=skw):
            return spatial.upscale_spatial_sharded(x, out4k, mesh(4), **skw)

        out, got_n = _drive(call, {kid: 4})
        _on_mesh(out, name)
        got = out.gather()
        want = ft.upscale(x, impl="kernel", **kw)
        if not same16(got, want):
            raise AssertionError(f"{name}: {int((got != want).sum())} values differ from the unsharded call")
        err = 0.0
        if kid == "K6":
            torch_strips = spatial.upscale_spatial_sharded(x, out4k, mesh(4), impl="torch", **skw).gather()
            err = _compare_f16(got, torch_strips, f"{name} vs the torch ops on the same strips")
            del torch_strips
        else:
            with _plain_kernels():
                plain = call().gather()
            err = _compare(got, plain, f"{name} vs the plain versions")
            del plain
        ops = device_trace(call, 1, short=lambda tr, kid=kid: sum(
            c for k, c in tr["launches"].items() if STRIP_NAMES[kid] in k) < 4)["launches"]
        in_place = round(sum(c for k, c in ops.items() if STRIP_NAMES[kid] in k))
        other = {k: c for k, c in ops.items() if STRIP_NAMES[kid] not in k}
        print(f"  {name}: a Sharded {out.shape} {out.dtype} on the mesh's devices, launches {got_n}, its gather "
              f"bit-equal to the unsharded call; a traced call: {in_place} launches of {STRIP_NAMES[kid]}, other "
              f"device operations {other or 'none'}")
        if in_place != 4 or other:
            raise AssertionError(f"{name}: a traced call must hold its 4 strip-source launches and nothing else")
        del out, got, want
        # In turn: the sharded call, the strips' kernels read in place, the
        # unsharded kernel; K6 beside the torch ops' strips, K1/K2 beside the
        # same strips of the frames widened to float32.
        h = x.shape[-2] // 4
        sources = spatial._sources([x[..., k * h:(k + 1) * h, :] for k in range(4)], layout.halo)
        wide = spatial._sources([x.float()[..., k * h:(k + 1) * h, :] for k in range(4)], layout.halo)
        dt = skw.get("compute_dtype", f32)

        def strips(of=sources, kid=kid, layout=layout, dt=dt):
            if kid == "K6":
                return [easu_h.easu_h(s, layout.out_hw, layout.con, rcon, row_plan=st.rows)
                        for s, st in zip(of, layout.strips)]
            if kid == "K1":
                return [fused.upscale_fused(s, layout.out_hw, st.local_con, rcon, row_offset=st.row0,
                                            global_rows=out4k[0]) for s, st in zip(of, layout.strips)]
            return [easu_gather.easu_gather(s, layout.out_hw, layout.con, rcon, True, False, dt, row_plan=st.rows,
                                            row_offset=st.row0) for s, st in zip(of, layout.strips)]

        whole = {"K6": lambda x=x: easu_h.easu_h(x, out4k, layout.con, rcon),
                 "K1": lambda x=x: fused.upscale_fused(x, out4k, layout.con, rcon),
                 "K2": lambda x=x: easu_gather.easu_gather(x, out4k, layout.con, rcon, True, False, bf16)}[kid]
        fns = {"sharded call": call, f"{kid} x4 strips": strips, f"{kid} unsharded": whole}
        if kid != "K6":
            fns[f"{kid} x4 strips, float32 frames"] = lambda wide=wide, strips=strips: strips(of=wide)
        t = cuda_times_in_turn(fns, **KQ)
        t[f"{kid} x4 strips, traced"] = sum(ms for k, ms in device_trace(strips, 5)["kernels"].items()
                                            if STRIP_NAMES[kid] in k)
        t[f"{kid} unsharded, traced"] = sum(ms for k, ms in device_trace(whole, 5)["kernels"].items()
                                            if KERNEL_NAMES[kid] in k)
        if kid == "K6":
            t["torch ops' strips"] = cuda_time_ms(lambda: spatial.upscale_spatial_sharded(
                x, out4k, mesh(4), impl="torch", **skw), warmup=1, iters=3)
        else:
            with _plain_kernels():
                t["plain versions' strips"] = cuda_time_ms(call, warmup=1, iters=3)
        print("    in turn, 10 queued (traced: device time of 5 calls): "
              + ", ".join(f"{k} {v / nframes:.4f}" for k, v in t.items()) + f" ms/frame ({card})")
        full[name] = dict(launches=got_n[kid], err=err, t=t, nbytes=_nbytes(*spatial._exchange_halo(
            [x[..., k * h:(k + 1) * h, :] for k in range(4)], layout.halo)) + nframes * out4k[0] * out4k[1]
            * x.shape[1] * (2 if kid == "K6" else torch.empty((), dtype=dt).element_size()))
        del sources, wide

    entries.append(_display_strips(dev, card, gen, mesh))

    # (vi) captured: one graph of four K6 strips.
    name = runs[0][0]
    cap, built = _drive(lambda: spatial.CapturedSpatial(p16, out4k, mesh(4), compute_dtype=f16),
                        {"K6": (capture.WARMUP + 1) * 4})
    for f in (0, 7):
        y = torch.rand(MAIN_SHAPE, generator=gen, device=dev).half()
        got, n = _drive(lambda: cap(y, frame=torch.tensor(f, dtype=torch.int32, device=dev)), ())
        _same_sharded(got, spatial.upscale_spatial_sharded(y, out4k, mesh(4), compute_dtype=f16, frame=f),
                      f"{name} captured, frame {f}")
    cap.put(y)
    ops = _replay_ops(lambda: cap(cap.inputs, frame=0), "K6", 4, f"{name} captured")
    t = cuda_times_in_turn({"eager": lambda: spatial.upscale_spatial_sharded(y, out4k, mesh(4), compute_dtype=f16),
                            "replay from cap.inputs": lambda: cap(cap.inputs, frame=0)}, **KQ)
    print(f"  {name} captured (CapturedSpatial): launches at construction {built}, none at 2 replays on fresh inputs, "
          f"each bit-equal shard by shard to the eager call; a traced replay: "
          + "; ".join(f"{c:g} x {k[:80]}" for k, c in ops.items())
          + "; 10 queued: " + ", ".join(f"{k} {v / nframes:.4f}" for k, v in t.items()) + " ms/frame")
    del cap

    if cards > 1:
        nc = 4 if cards >= 4 else 2
        real = sharding.make_mesh(nc, ("sp",))
        cards_of = list(real.devices.flat)
        for name, x, kw, kid in (runs[0], runs[2]):
            skw = {k: v for k, v in kw.items() if k != "preset"}
            want = ft.upscale(x, impl="kernel", **kw)
            xs = sharding.Sharded.put(x, real, (None, None, "sp", None))
            for label, src in (("a tensor input", x), ("a Sharded input", xs)):
                out, n = _drive(lambda: spatial.upscale_spatial_sharded(src, out4k, real, **skw), {kid: nc})
                _sync_all()
                _on_mesh(out, f"{name} across {nc} cards, {label}")
                if not same16(out.gather(dev), want):
                    raise AssertionError(f"{name} across {nc} cards, {label}: differs from the unsharded call")
            t = cuda_times_in_turn({f"across {nc} cards": _joined(
                lambda: spatial.upscale_spatial_sharded(xs, out4k, real, **skw), cards_of),
                "one card, sp=4": lambda: spatial.upscale_spatial_sharded(x, out4k, mesh(4), **skw)}, **KQ)
            print(f"  {name.replace('sp=4', f'sp={nc}')} across {nc} cards: launches {n}, gather bit-equal to the "
                  "unsharded call from a tensor and a Sharded input; 10 queued: "
                  + ", ".join(f"{k} {v / nframes:.4f}" for k, v in t.items()) + " ms/frame")
            del xs, want
        cap, built = _drive(lambda: spatial.CapturedSpatial(p16, out4k, real, compute_dtype=f16),
                            {"K6": (capture.WARMUP + 1) * nc})
        y = sharding.Sharded.put(torch.rand(MAIN_SHAPE, generator=gen, device=dev).half(), real,
                                 (None, None, "sp", None))
        got, _ = _drive(lambda: cap(y, frame=0), ())
        _sync_all()
        _same_sharded(got, spatial.upscale_spatial_sharded(y, out4k, real, compute_dtype=f16),
                      f"{runs[0][0]} captured across {nc} cards")
        print(f"  {runs[0][0]} captured across {nc} cards: launches at construction {built}, a replay bit-equal "
              "shard by shard to the eager call")
        del cap, y

    npix = nframes * out4k[0] * out4k[1]
    f32_ops, half_ops = (e + r for e, r in zip(EASU_H_OPS, RCAS_H_OPS))
    for name, _, _, kid in runs:
        r = full[name]
        kname = {"K6": "easu_h (K6)", "K1": "upscale_fused (K1)", "K2": "easu_gather (K2)"}[kid]
        src = {"K6": "fsr_tpu_torch/csrc/easu_h.cu", "K1": "fsr_tpu_torch/csrc/fused.cu",
               "K2": "fsr_tpu_torch/csrc/easu_gather.cu"}[kid]
        rep = {"K6": "fsr_tpu/ops/easu.py:47 + fsr_tpu/ops/rcas.py:42 (jax.jit, float16; no pallas_call)",
               "K1": "fsr_tpu/kernels/fused.py:403", "K2": "fsr_tpu/kernels/easu_gather.py:350"}[kid]
        plain = r["t"].get("torch ops' strips", r["t"].get("plain versions' strips"))
        if kid == "K6":
            entries.append(_kernel_entry(f"{kname}, row-sharded, strips read in place: {name[name.index(' ') + 1:]}; "
                                         "plain: the torch ops' strips", src, rep, r["launches"], r["err"],
                                         r["t"]["K6 x4 strips"], plain, r["nbytes"], f32_ops * npix,
                                         half_ops=half_ops * npix))
        else:
            entries.append(_kernel_entry(f"{kname}, row-sharded, strips read in place, float16 source: "
                                         f"{name[name.index(' ') + 1:]}", src, rep, r["launches"], r["err"],
                                         r["t"][f"{kid} x4 strips"], plain, r["nbytes"], EASU_RCAS_OPS * npix))
    return entries



def _display_strips(dev, card: str, gen, mesh) -> dict:
    """Phase 18's (vi-b16): the display path (uint8 1440p frames, grain
    0.25, 8-bit TEPD, uint8 out, float16 math) through
    ``UpscalePipeline(mesh=)`` on 4 strips of ``mesh(4)``: 4 launches of
    K6's strip tail form, each strip read in place and its grain rows read
    in place, no other device operation in a traced call; its gather
    bit-equal to the unsharded call, held to the plain versions' strips (the
    torch chain); in turn the sharded call, the bare sharded call, the
    unsharded call and the plain strips.  Returns its kernels line entry."""
    import fsr_tpu_torch as ft
    from fsr_tpu_torch.parallel import spatial
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, device_trace

    f16, u8 = torch.float16, torch.uint8
    nf = QUALITY_SHAPE[0]
    out4k = (2 * MAIN_SHAPE[2], 2 * MAIN_SHAPE[3])
    q8 = (torch.rand(QUALITY_SHAPE, generator=gen, device=dev) * 255).to(u8)
    grain = torch.rand((3, *out4k), generator=gen, device=dev) - 0.5
    opts = dict(grain_amount=0.25, dither_bits=8, out_dtype=u8, compute_dtype=f16)
    pipe, whole = ft.UpscalePipeline(out4k, mesh=mesh(4), **opts), ft.UpscalePipeline(out4k, **opts)
    name = "(vi-b16) display, u8 1440p -> u8, sp=4"

    def call():
        return pipe(q8, grain=grain, frame=3)

    out, n = _drive(call, {"K6": 4})
    _on_mesh(out, name)
    got = out.gather()
    if not _same(got, whole(q8, grain=grain, frame=3)):
        raise AssertionError(f"{name}: differs from the unsharded call")

    def plain():
        with _plain_kernels():
            return call()

    err = _compare_tail(got, plain().gather(), f"{name}: launches {n}; vs the plain versions' strips")
    ops = device_trace(call, 1, short=lambda tr: sum(
        c for k, c in tr["launches"].items() if K6_TAIL_NAMES[1] in k) < 4)["launches"]
    k6 = sum(c for k, c in ops.items() if K6_TAIL_NAMES[1] in k)
    other = {k[:60]: c for k, c in ops.items() if K6_TAIL_NAMES[1] not in k}
    print(f"    a traced call: {k6:g} launches of {K6_TAIL_NAMES[1]}, other device operations {other or 'none'}")
    if round(k6) != 4 or other:
        raise AssertionError(f"{name}: a traced call must hold its 4 strip tail launches and nothing else")
    fns = {"sharded call": call,
           "bare sharded call": lambda: spatial.upscale_spatial_sharded(q8, out4k, mesh(4), compute_dtype=f16),
           "unsharded call": lambda: whole(q8, grain=grain, frame=3), "plain strips": plain}
    samples = {k: [] for k in fns}
    for _ in range(3):  # in turn
        for k, fn in fns.items():
            samples[k].append(cuda_time_ms(fn, warmup=1, iters=3) if k == "plain strips" else cuda_time_ms(fn, **KQ))
    t = {k: statistics.median(v) for k, v in samples.items()}
    busy = device_trace(call, 5, short=lambda tr: sum(
        c for k, c in tr["launches"].items() if K6_TAIL_NAMES[1] in k) < 4)["busy_ms"] / 5
    print("    in turn (10 queued; plain strips: one call): " + ", ".join(f"{k} {v / nf:.4f}" for k, v in t.items())
          + f" ms/frame; traced busy {busy / nf:.4f} ms/frame ({card})")
    npix = nf * out4k[0] * out4k[1]
    f32_ops, half_ops = _tail_ops(pipe._options(True)[0], 0.0, False)
    return _kernel_entry(f"easu_h (K6) with the frame tail, row-sharded, strips and grain rows read in place: {name}; "
                         "plain: the torch chain's strips", "fsr_tpu_torch/csrc/easu_h.cu",
                         "fsr_tpu/api.py:280-309 + fsr_tpu/parallel/spatial.py:304-307 (jax.jit float16 chain in "
                         "shard_map; no pallas_call)", n["K6"], err, t["sharded call"], t["plain strips"],
                         _nbytes(q8, got, grain), f32_ops * npix, half_ops=half_ops * npix)


FRAMES_ON_CARD = (0, 7, 2**31 - 1, -1)


def _same_sharded(got, want, what) -> None:
    """Two ``Sharded`` results: the same layout, each shard bit-equal."""
    _on_mesh(got, what)
    if got.spec != want.spec or got.shape != want.shape or len(got.shards) != len(want.shards):
        raise AssertionError(f"{what}: {got.spec} {got.shape} vs {want.spec} {want.shape}")
    for j, (a, b) in enumerate(zip(got.shards, want.shards)):
        if a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b):
            off = int((a != b).sum()) if a.shape == b.shape and a.device == b.device else a.numel()
            raise AssertionError(f"{what}, shard {j}: {off} of {a.numel()} values differ from the eager call")


# Device operations a captured sharded call may run besides its kernels (K1
# or K2 on each strip): the staging's own-row copies, grain strips and page,
# and the frame's fill or copy.
STAGING_OPS = re.compile(r"copy|memcpy|fill|memset", re.IGNORECASE)
# A device trace's name of a copy between cards.
PEER_COPY = re.compile(r"PtoP", re.IGNORECASE)


def _replay_ops(call, kid: str, n_k: int, what: str, peer_copies: bool = True, strips: bool = True) -> dict:
    """One traced call of a captured sharded call: its launches of kernel
    ``kid`` must be ``n_k`` (with ``strips``, all in the strip-source form:
    each strip's rows read in place), with no H1 launch, and every other
    device operation a staging copy or fill (``STAGING_OPS``); with
    ``peer_copies`` False none of them a copy between cards (``PEER_COPY``).
    Returns the operations per call."""
    from fsr_tpu_torch.utils.profiling import device_trace

    kernel, h1 = KERNEL_NAMES[kid], KERNEL_NAMES["H1"]
    ops = device_trace(call, 1, short=lambda tr: sum(c for k, c in tr["launches"].items() if kernel in k) < n_k
                       )["launches"]
    launched = round(sum(c for k, c in ops.items() if kernel in k))
    in_place = round(sum(c for k, c in ops.items() if STRIP_NAMES[kid] in k)) if strips else n_k
    halos = round(sum(c for k, c in ops.items() if h1 in k))
    other = {k: c for k, c in ops.items() if kernel not in k
             and (not STAGING_OPS.search(k) or (not peer_copies and PEER_COPY.search(k)))}
    if launched != n_k or in_place != n_k or halos or other:
        raise AssertionError(f"{what}: a traced replay ran {launched} launches of {kernel} (want {n_k}), {in_place} "
                             f"of them in the strip-source form, {halos} of {h1} (want 0) and operations beyond "
                             f"the staging's copies: {other}")
    return ops


class _HostCopies:
    """Counts the copies and fills a call issues from the host (aten
    ``copy_``, ``_to_copy``, ``fill_``), by (operation, source device,
    destination device), and the most bytes one of them moved: a replayed
    graph's own work is no aten call.  ``watch``: tensors (a captured call's
    own-row or share statics) whose writes by ``copy_`` are counted apart
    (``into_watched``)."""

    def __init__(self, watch=()):
        from torch.utils._python_dispatch import TorchDispatchMode

        counts = self.counts = collections.Counter()
        largest = self.largest = collections.Counter()  # the most bytes one copy moved, by key
        watched = {t.untyped_storage().data_ptr() for t in watch}
        self.into_watched = 0
        this = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = func.overloadpacket.__name__
                if name in ("copy_", "_to_copy", "fill_"):
                    dst = torch.device(kwargs.get("device") or args[0].device) if name == "_to_copy" else args[0].device
                    src = args[1].device if name == "copy_" else args[0].device
                    key = (name, str(src), str(dst))
                    counts[key] += 1
                    largest[key] = max(largest[key], _nbytes(args[1] if name == "copy_" else args[0]))
                    if name == "copy_" and args[0].untyped_storage().data_ptr() in watched:
                        this.into_watched += 1
                return func(*args, **kwargs)

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def across_cards(self, min_bytes: int = 0) -> int:
        """The copies between cards, of those moving more than ``min_bytes``
        (by the most one copy of their kind moved)."""
        return sum(c for (op, a, b), c in self.counts.items()
                   if a != b and "cuda" in a and "cuda" in b and self.largest[(op, a, b)] > min_bytes)


def _captured_sharded(dev, card: str, gen, trace: bool, cases, out4k, sync, cards=None) -> dict:
    """Phase 18, captured: each full-width run as one captured program per
    device (``CapturedSpatial``, each strip's kernel reading its neighbours'
    static buffers in place; ``CapturedBatch``).  Its launches are counted at construction only (the
    warm-up's and the capture's, per strip or share); 8 replays on fresh
    seeded inputs and grain, with the frame as a 0-d int32 tensor on the
    card (``FRAMES_ON_CARD``), are each bit-equal shard by shard to the
    eager call on the same inputs and count no launch; the tables a K2 graph
    read stay valid when their caches are emptied and their memory
    overwritten (``capture.keep``).  Then 8 calls from the graphs' own
    inputs (``cap.inputs``) each way: filled by ``put`` (its grain given to
    ``put``), and written in place by a producer (seeded ``uniform_`` or
    ``random_`` on each shard's card, after ``CapturedSpatial.writable()``), each bit-equal
    to the eager call.  Then 10 calls queued with no host sync, from a
    ``Sharded`` input, from a tensor, by ``put`` and written in place, each
    call's shards cloned on their cards' streams right after it, all
    bit-equal to the eager calls; the copies and fills one call issues from
    the host (``_HostCopies``: from a ``Sharded`` input none card to card
    but a 0-d frame's, for a case without grain; from ``cap.inputs`` none
    into an own-row buffer or share, which a call from a tensor makes);
    across ``cards``, a producer's write on the last card delayed on its
    stream, and a reader's replay delayed before the next call's writes,
    each call still bit-equal (the events' two hazards).  Then eager
    against replay (from the input, and from ``cap.inputs``) in turn:
    device ms (CUDA events on the first card; with ``cards``, after every
    card's stream) and wall ms per call (host clock, synchronised), one
    call and 10 queued, the host's issue time and its split by step
    (``_host_split``); with ``trace`` (or across ``cards``) each one's
    traced operations per call, busy time per card and idle share, and with
    ``trace`` a replay's device operations held to its launches and its
    staging's copies (``_replay_ops``).  Returns each case's launch counts
    at construction."""
    from fsr_tpu_torch.kernels import easu_gather
    from fsr_tpu_torch.parallel import sharding, spatial
    from fsr_tpu_torch.utils import capture
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn, device_trace

    counts = {}
    for name, build, eager, need, fresh, with_grain in cases:
        cap, built = _drive(build, {k: (capture.WARMUP + 1) * v for k, v in need.items()})
        counts[name] = built
        grains = [torch.rand((3, *out4k), generator=gen, device=dev) - 0.5 if with_grain else None for _ in range(2)]
        rows = isinstance(cap, spatial.CapturedSpatial)
        gens = {d: torch.Generator(device=d).manual_seed(1800 + i)
                for i, d in enumerate(dict.fromkeys(s.device for s in cap.inputs.shards))}

        def replay(x, f, g):
            return cap(x, frame=f, grain=g) if with_grain else cap(x, frame=f)

        def staging(x, f, g):
            return cap._stage(x, f, g) if with_grain else cap._stage(x, f)

        def put(x, g):
            return cap.put(x, grain=g) if with_grain else cap.put(x)

        def from_inputs(f, g=None):
            return cap(cap.inputs, frame=f, grain=g) if g is not None else cap(cap.inputs, frame=f)

        def produce(delay=None):
            """A producer writing seeded frames into ``cap.inputs`` where they
            lie, on each card's current stream after ``writable()`` (with
            ``delay``, (card, cycles), that card's writes held back by a
            spin first); returns a copy of what it wrote, for the eager
            call."""
            ins = cap.writable() if rows else cap.inputs  # the batch's cards read only their own shares
            if delay is not None:
                with torch.cuda.device(delay[0]):
                    torch.cuda._sleep(delay[1])
            for sh in ins.shards:
                if sh.dtype == torch.uint8:
                    sh.random_(0, 256, generator=gens[sh.device])
                else:
                    sh.uniform_(generator=gens[sh.device])
            return sharding.Sharded(ins.mesh, ins.spec, tuple(sh.clone() for sh in ins.shards), ins.shape, ins.dtype)

        last = None
        for r in range(8):
            x, f, g = fresh(), torch.tensor(FRAMES_ON_CARD[r % 4], dtype=torch.int32, device=dev), grains[r % 2]
            rep, _ = _drive(lambda: replay(x, f, g), {})
            _same_sharded(rep, eager(x, f, g), f"{name}, captured: replay {r}")
            if last is not None and torch.equal(last, rep.shards[-1]):
                raise AssertionError(f"{name}, captured: replays {r - 1} and {r} on other inputs gave one output")
            last = rep.shards[-1].clone()
        # What the graphs keep from caches (the static inputs they read of
        # other devices aside).
        static = {id(t) for ins in cap.programs.shard_inputs + list(cap.programs.device_inputs.values())
                  for t in ins}
        kept = [t for frame in cap.programs.captured.values() for tables in frame.kept for item in tables
                for t in (item.values() if isinstance(item, dict) else [item]) if id(t) not in static]
        if "K2" in need and not kept:
            raise AssertionError(f"{name}, captured: the graphs kept no table of K2's strip plans")
        easu_gather._device_tables.cache_clear()
        easu_gather.shard_plan.cache_clear()
        spatial._layout.cache_clear()
        garbage = [torch.full_like(t, -7) for t in kept for _ in range(4)]
        _same_sharded(replay(x, f, g), eager(x, f, g), f"{name}, captured: a replay after the caches went")
        del garbage
        # From the graphs' own inputs: filled by put (its grain given there,
        # the call without one), and written in place by a producer (the
        # grain given to the call).
        for mode in ("put", "written in place"):
            for r in range(8):
                f, g = torch.tensor(FRAMES_ON_CARD[r % 4], dtype=torch.int32, device=dev), grains[r % 2]
                if mode == "put":
                    x = fresh()
                    rep, _ = _drive(lambda: (put(x, g), from_inputs(f))[1], {})
                else:
                    x = produce()
                    rep, _ = _drive(lambda: from_inputs(f, g), {})
                _same_sharded(rep, eager(x, f, g), f"{name}, captured: replay {r} from cap.inputs, {mode}")
        print(f"    {name}, captured: built with launches {built} (warm-up and capture), "
              f"{len(cap.programs.captured)} graph(s); 8 replays with frames {FRAMES_ON_CARD} on the card, each "
              f"bit-equal shard by shard to the eager call, none counted; {len(kept)} K2 tables kept, a replay "
              f"after the table and plan caches were emptied and overwritten still bit-equal; 8 replays from "
              f"cap.inputs filled by put and 8 written in place by a producer, each bit-equal")
        # 10 calls queued with no host sync, each call's shards cloned on
        # their cards' streams right after it, then held against the eager
        # calls: a wrong order across cards shows as a stale or early halo.
        for kind in ("a Sharded input", "a tensor input", "cap.inputs by put", "cap.inputs written in place"):
            xs = []
            for r in range(10):
                x = None if kind == "cap.inputs written in place" else fresh()
                if kind == "a Sharded input" and not isinstance(x, sharding.Sharded):
                    x = sharding.Sharded.put(x, cap.mesh, cap.spec)
                elif kind == "a tensor input" and isinstance(x, sharding.Sharded):
                    x = x.gather(dev)
                xs.append((x, torch.tensor(13 * r - 40, dtype=torch.int32, device=dev), grains[r % 2]))
            sync()
            outs = []
            for r, (x, f, g) in enumerate(xs):
                if kind == "cap.inputs by put":
                    put(x, g)
                    out = from_inputs(f)
                elif kind == "cap.inputs written in place":
                    x = produce()
                    xs[r] = (x, f, g)
                    out = from_inputs(f, g)
                else:
                    out = replay(x, f, g)
                outs.append([sh.clone() for sh in out.shards])
            sync()
            for r, (args, got) in enumerate(zip(xs, outs)):
                want = eager(*args)
                _same_sharded(sharding.Sharded(want.mesh, want.spec, tuple(got), want.shape, want.dtype), want,
                              f"{name}, captured: queued call {r} of 10 from {kind}")
            if rows and kind in ("a Sharded input", "a tensor input"):
                with _HostCopies() as host:
                    replay(*xs[0])
                sync()
                crossed = host.across_cards()
                # From a Sharded input no rows cross cards: only a 0-d frame
                # (4 bytes) may, on cards whose graphs read it; a case with
                # grain also moves the caller's grain and page (not checked).
                if kind == "a Sharded input" and not with_grain and host.across_cards(min_bytes=4):
                    raise AssertionError(f"{name}, captured: a call from {kind} issued {crossed} copies between "
                                         f"cards from the host: {dict(host.counts)}")
                print(f"    {name}, captured, from {kind}: 10 calls queued with no host sync, each bit-equal shard "
                      f"by shard to the eager call; one call's host-issued copies and fills "
                      + ", ".join(f"{c} x {op} {a} -> {b}" for (op, a, b), c in sorted(host.counts.items()))
                      + f" ({crossed} between cards)")
            else:
                print(f"    {name}, captured, from {kind}: 10 calls queued with no host sync, each bit-equal shard "
                      f"by shard to the eager call")
            del xs, outs
        # A call from cap.inputs copies nothing into them; one from a tensor
        # copies each strip's rows or share (the check can see them).
        x, f, g = fresh(), torch.tensor(7, dtype=torch.int32, device=dev), grains[0]
        put(x, g)
        with _HostCopies(watch=cap.inputs.shards) as own:
            from_inputs(f, g)
        with _HostCopies(watch=cap.inputs.shards) as other:
            replay(x, f, g)
        sync()
        if own.into_watched or other.into_watched != len(cap.inputs.shards):
            raise AssertionError(f"{name}, captured: {own.into_watched} copies into cap.inputs from a call from "
                                 f"cap.inputs (want 0), {other.into_watched} from a call from a tensor (want "
                                 f"{len(cap.inputs.shards)})")
        print(f"    {name}, captured: a call from cap.inputs issues no copy into its {len(cap.inputs.shards)} "
              f"{'own-row buffers' if rows else 'shares'} (from a tensor: {other.into_watched}); its host-issued "
              "copies and fills " + ", ".join(f"{c} x {op} {a} -> {b}" for (op, a, b), c in sorted(own.counts.items())))
        if cards and rows:
            # The two hazards on the cards, made likely: the last card's write
            # held back ~20 ms (every reader's replay must wait for it), then
            # the first card's replay held back before the next call's writes
            # (its neighbour's write must wait for it).
            spin = 40_000_000
            sync()
            x1 = produce(delay=(cards[-1], spin))
            out1 = [sh.clone() for sh in from_inputs(f, g).shards]
            with torch.cuda.device(cards[0]):
                torch.cuda._sleep(spin)
            out2 = [sh.clone() for sh in from_inputs(f, g).shards]
            x3 = produce()
            out3 = [sh.clone() for sh in from_inputs(f, g).shards]
            sync()
            for what, x, got in (("a write delayed on the last card", x1, out1),
                                 ("a replay delayed on the first card", x1, out2),
                                 ("the call after the delayed replay", x3, out3)):
                want = eager(x, f, g)
                _same_sharded(sharding.Sharded(want.mesh, want.spec, tuple(got), want.shape, want.dtype), want,
                              f"{name}, captured: {what}")
            print(f"    {name}, captured: a producer's write delayed on {cards[-1]}, and a replay delayed on "
                  f"{cards[0]} before the next call's writes: each call bit-equal to the eager call")
        fns = {"eager": lambda: eager(x, f, g), "replay": lambda: replay(x, f, g),
               "replay from cap.inputs": lambda: from_inputs(f, g), "its staging alone": lambda: staging(x, f, g),
               "its staging alone, from cap.inputs": lambda: staging(cap.inputs, f, g)}
        if cards:
            fns = {k: _joined(fn, cards) for k, fn in fns.items()}
        one = cuda_times_in_turn(fns)
        queued = cuda_times_in_turn(fns, iters=10, **KQ)
        wall = _wall_ms_in_turn(fns, n=10, sync=sync)
        wall_q = _wall_ms_in_turn(fns, n=3, queue=10, sync=sync)
        issue = _host_issue_ms(fns, sync)
        nf = rep.shape[0]  # the staging alone: the call's host work and copies, with no replay
        for k in fns:
            print(f"    {name}, {k}: one call {one[k]:.4f} device ms ({one[k] / nf:.4f} per frame), {wall[k]:.4f} "
                  f"wall ms ({wall[k] / nf:.4f}); 10 queued {queued[k]:.4f} device ms ({queued[k] / nf:.4f}), "
                  f"{wall_q[k]:.4f} wall ms ({wall_q[k] / nf:.4f}) per call (CUDA events on {dev}; host clock, "
                  f"synchronised); the host returns after {issue[k]:.4f} ms; {card}")
        for k, fn in (("replay", lambda: replay(x, f, g)), ("replay from cap.inputs", lambda: from_inputs(f, g))):
            print(f"      {k}, the host's issue by step, ms (count) per call, instrumented, median of 20: "
                  + _split_line(_host_split(fn, cap.inputs.shards, sync)))
        if trace or cards:
            for k in ("eager", "replay", "replay from cap.inputs"):
                tr = device_trace(fns[k], 5)
                print(f"      {k}, traced over 5 calls: {tr['ops_per_call']:g} device operations per call, busy "
                      f"{tr['busy_ms'] / 5:.4f} ms per call of a {tr['window_ms'] / 5:.4f} ms window, idle share "
                      f"{tr['idle_share']:.4f}; per card " + ", ".join(
                          f"{i}: {ms / 5:.4f}" for i, ms in tr["busy_ms_by_device"].items()))
        if trace:
            (kid, n_k), = need.items()
            # (a case with grain stages the caller's grain and page, which lie
            # on the first card, into every card's graph)
            for k, call in (("a traced replay", lambda: replay(x, 7, g)),
                            ("a traced replay from cap.inputs", lambda: from_inputs(7, g))):
                ops = _replay_ops(call, kid, n_k, f"{name}, {k}", strips=rows, peer_copies=with_grain or (
                    "cap.inputs" not in k and not isinstance(x, sharding.Sharded)))
                print(f"      {k} (a host int frame): {n_k} launches of "
                      f"{(STRIP_NAMES if rows else KERNEL_NAMES)[kid]}, none of {KERNEL_NAMES['H1']}; with them "
                      + "; ".join(f"{c:g} x {k2[:90]}" for k2, c in ops.items() if KERNEL_NAMES[kid] not in k2))
        del cap, rep, last, x, fns
    return counts


def _external_wait_probe(cards) -> dict:
    """Phase 18, two cards: what an event wait captured into a CUDA graph
    binds to (``torch.cuda.Event(external=True)``: an external wait node),
    and what a host wait on an event recorded inside a graph binds to.  A
    graph on ``cards[1]`` waits for an event of ``cards[0]``, then adds one
    to a counter.  (a) The event's record at capture is complete; after
    the capture a record is enqueued on ``cards[0]`` behind a ~40 ms spin,
    then the graph is launched: it runs at once if its wait binds to the
    record at capture, ~40 ms later if to the record standing at launch or
    later.  (b) ``cards[1]``'s stream spins ~10 ms, then the graph is
    launched; only after the launch a record is enqueued on ``cards[0]``
    behind a ~40 ms spin: ~10 ms if the wait binds at launch (to the
    complete record before it), ~40 ms if to the latest record when the
    node runs.  (c) A graph on ``cards[1]`` spins ~40 ms, then records an
    event (an external record node); the host enqueues a wait for it on
    ``cards[0]`` right after the launch: ~40 ms if the wait binds to the
    graph's record, at once if to the record standing before the launch.
    Times are CUDA events on the waiting card."""
    import inspect

    if "external" not in inspect.signature(torch.cuda.Event.__new__).parameters:
        print(f"    captured event waits: torch {torch.__version__} has no torch.cuda.Event(external=True)")
        return {}
    a, b = cards
    sa, sb = torch.cuda.current_stream(a), torch.cuda.current_stream(b)
    ev = torch.cuda.Event(external=True)
    ev.record(sa)  # the record at capture, complete before it
    rec = torch.cuda.Event(external=True)
    rec.record(sb)
    _sync_all()

    def bracket(stream, work):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        _sync_all()
        t0.record(stream)
        work()
        t1.record(stream)
        _sync_all()
        return t0.elapsed_time(t1)

    def spin_on(dev, cycles):
        with torch.cuda.device(dev):
            torch.cuda._sleep(cycles)

    # ~40 ms and ~10 ms spins, from the cycles a 10**7-cycle spin takes.
    cycles_per_ms = 10**7 / bracket(sa, lambda: spin_on(a, 10**7))
    long_spin, mid_spin = int(40 * cycles_per_ms), int(10 * cycles_per_ms)

    count = torch.zeros((), device=b)
    waits, records = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.device(b):
        side = torch.cuda.Stream()
        with torch.cuda.graph(waits, stream=side):
            torch.cuda.current_stream().wait_event(ev)
            count.add_(1)
        with torch.cuda.graph(records, stream=side):
            torch.cuda._sleep(long_spin)
            rec.record(torch.cuda.current_stream())

    def late_record():
        spin_on(a, long_spin)
        ev.record(sa)

    def launch(graph, spin=0):
        if spin:
            spin_on(b, spin)
        with torch.cuda.device(b):
            graph.replay()

    out = {"spin ms": bracket(sa, lambda: spin_on(a, long_spin))}
    out["(a) launched after a late record"] = bracket(sb, lambda: (late_record(), launch(waits)))
    ev.record(sa)
    out["(b) a late record after the launch"] = bracket(sb, lambda: (launch(waits, mid_spin), late_record()))

    def host_wait():
        launch(records)
        sa.wait_event(rec)
    out["(c) a host wait after a graph's record"] = bracket(sa, host_wait)
    if int(count.item()) != 2:
        raise AssertionError(f"the probe's graph ran {int(count.item())} times, want 2")
    half = out["spin ms"] / 2
    wait = ("to the record at capture" if out["(a) launched after a late record"] < half
            else "to the latest record at launch" if out["(b) a late record after the launch"] < 3 * half / 2
            else "to the latest record when the node runs")
    host = ("to the graph's record" if out["(c) a host wait after a graph's record"] > half
            else "to the record before the launch")
    print(f"    captured event waits ({b}'s graph waits for an event of {a}'s stream; {a} waits for an event "
          f"that {b}'s graph records): " + ", ".join(f"{k} {v:.3f} ms" for k, v in out.items())
          + f"; a captured wait binds {wait}; a host wait enqueued after a graph's launch binds {host}")
    return {**out, "captured wait": wait, "host wait": host}


def _strip_source_checks(dev, gen, cards: int) -> float:
    """Phase 18: K1 and K2 with a strip source (``kernels.halo.StripSource``:
    each strip's rows read in place from the strip above's, its own and the
    strip below's) bit-equal to the same kernels on the ``torch.cat``'d
    halo'd strips (``spatial._exchange_halo``), for uint8, bfloat16 and
    float32, RGB and RGBA, K1's quad and generic paths at 2x and its
    generic path at 4x (a halo of 4 rows) and K2 at 1.5x (8 rows), own rows
    as views of a larger tensor and as buffers of their own, the neighbours
    whole or their edge rows only, a batch and dp x sp frame groups; on
    ``dev`` and, with several cards, strip j on card j mod 4 (its
    neighbours read by peer access).  Returns the largest difference
    (0.0)."""
    from fsr_tpu_torch.core.constants import RcasConstants
    from fsr_tpu_torch.kernels import easu_gather, fused, halo
    from fsr_tpu_torch.parallel import spatial

    rcon = RcasConstants(0.25)
    places = [(f"[{dev}] * n", lambda j: dev)]
    if cards > 1:
        nc = min(cards, 4)
        on = [torch.device("cuda", i) for i in range(nc)]
        halo.enable_peers((a, b) for a in on for b in on)
        places.append((f"strip j on cuda:(j mod {nc})", lambda j: on[j % nc]))
    configs = [("K1 2x quad", (96, 160), (192, 320), 4, "auto"), ("K1 2x generic", (96, 160), (192, 320), 4, "generic"),
               ("K1 4x", (48, 80), (192, 320), 4, "auto"), ("K2 1.5x", (144, 240), (216, 360), 3, None)]
    cases = 0
    for where, card_of in places:
        for (what, in_hw, out_hw, n, path), dtype, channels, groups in itertools.product(
                configs, (torch.float32, torch.bfloat16, torch.uint8), (3, 4), (1, 2)):
            lay = spatial._layout(in_hw, out_hw, n, None, (0, 0))
            x = torch.rand((2 * groups, channels, *in_hw), generator=gen, device=dev)
            x = (x * 255).to(torch.uint8) if dtype == torch.uint8 else x.to(dtype)
            store = torch.float32 if dtype == torch.uint8 else dtype
            kw = dict(out_dtype=torch.uint8) if dtype == torch.uint8 else {}
            for g, frames in enumerate(x.chunk(groups, 0)):
                on_cards = {card_of(j): frames.to(card_of(j)) for j in range(n)}
                views = [on_cards[card_of(j)][..., j * (in_hw[0] // n):(j + 1) * (in_hw[0] // n), :] for j in range(n)]
                for own_form, neighbours in itertools.product(("views", "buffers"), ("whole", "edge rows")):
                    rows = views if own_form == "views" else [v.clone() for v in views]
                    for k in range(n):
                        up = rows[k - 1] if k else None
                        down = rows[k + 1] if k + 1 < n else None
                        if neighbours == "edge rows":
                            up = None if up is None else up[..., -lay.halo:, :]
                            down = None if down is None else down[..., :lay.halo, :]
                        src = halo.StripSource(up, rows[k], down, lay.halo)
                        cat = halo.halo_rows_reference(src)
                        st = lay.strips[k]
                        if st.local_con is not None:
                            args = (lay.out_hw, st.local_con, rcon, True, False, store)
                            kk = dict(kw, row_offset=st.row0, global_rows=st.global_rows, path=path)
                            got, want = fused.upscale_fused(src, *args, **kk), fused.upscale_fused(cat, *args, **kk)
                        else:
                            args = (lay.out_hw, lay.con, rcon, True, False, store)
                            kk = dict(kw, row_plan=st.rows, row_offset=st.row0)
                            got = easu_gather.easu_gather(src, *args, **kk)
                            want = easu_gather.easu_gather(cat, *args, **kk)
                        _sync_all()
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"strip source {where}: {what} {dtype} {channels} channels, group {g} of {groups}, "
                                f"own rows as {own_form}, neighbours {neighbours}: strip {k} has "
                                f"{int((got != want).sum())} values unlike the kernel on the halo'd strip")
            cases += 1
    print(f"  K1 and K2 with a strip source (rows read in place) bit-equal to the same kernels on the halo'd strips "
          f"in {cases} cases ({'; '.join(w for w, _ in places)}): K1 2x quad and generic, K1 4x, K2 1.5x; "
          "float32/bfloat16/uint8, RGB/RGBA, a batch and dp x sp; own rows as views and as buffers, the "
          "neighbours whole and their edge rows only")
    return 0.0


def _host_issue_ms(fns: dict, sync, n: int = 20) -> dict:
    """The host's time to issue one call of each function of ``fns`` (host
    clock from the call to its return, the devices idle before it: ``sync``),
    the median of ``n``, in turn."""
    times = {k: [] for k in fns}
    for _ in range(n):
        for k, fn in fns.items():
            sync()
            t0 = time.perf_counter()
            fn()
            times[k].append((time.perf_counter() - t0) * 1e3)
    sync()
    return {k: statistics.median(v) for k, v in times.items()}


SPLIT = ("own rows / shares", "frame", "grain, page", "waits", "records", "graph launches")


def _host_split(fn, statics, sync, n: int = 20) -> dict:
    """The host's issue time of one call of ``fn`` by step (``SPLIT``): its
    copies into ``statics`` (a captured call's own-row buffers or shares),
    the frame's fills and copies (0-d), the other copies (grain rows, the
    page), the event waits and records, the graph launches
    (``CUDAGraph.replay``), each timed around its call, and the rest (the
    Python between them, device contexts); medians of ``n`` calls, the
    devices idle before each (``sync``), with the count of each step per
    call.  The timers add their own cost to the total and the rest."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ptrs = {t.untyped_storage().data_ptr() for t in statics}
    acc, cnt = collections.Counter(), collections.Counter()

    def timed(key, f):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                acc[key] += time.perf_counter() - t0
                cnt[key] += 1
        return run

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name not in ("copy_", "fill_", "_to_copy"):
                return func(*args, **(kwargs or {}))
            key = ("own rows / shares" if name == "copy_" and args[0].untyped_storage().data_ptr() in ptrs
                   else "frame" if args[0].dim() == 0 else "grain, page")
            return timed(key, func)(*args, **(kwargs or {}))

    patches = [(torch.cuda.Event, "wait", "waits"), (torch.cuda.Event, "record", "records"),
               (torch.cuda.CUDAGraph, "replay", "graph launches")]
    saved = [(cls, name, cls.__dict__.get(name)) for cls, name, _ in patches]
    runs = collections.defaultdict(list)
    try:
        for cls, name, key in patches:
            setattr(cls, name, timed(key, getattr(cls, name)))
        for _ in range(n):
            sync()
            acc.clear()
            cnt.clear()
            t0 = time.perf_counter()
            with Mode():
                fn()
            total = time.perf_counter() - t0
            for key in SPLIT:
                runs[key].append((acc[key] * 1e3, cnt[key]))
            runs["the rest"].append(((total - sum(acc.values())) * 1e3, 0))
            runs["total"].append((total * 1e3, 0))
    finally:
        for cls, name, orig in saved:
            if orig is None:
                delattr(cls, name)
            else:
                setattr(cls, name, orig)
        sync()
    return {k: (statistics.median(ms for ms, _ in v), statistics.median(c for _, c in v)) for k, v in runs.items()}


def _split_line(split: dict) -> str:
    return ", ".join(f"{k} {ms:.4f}" + (f" ({c:g})" if c else "") for k, (ms, c) in split.items())


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _joined(fn, cards):
    """``fn`` followed by a wait of the first card's current stream for
    every other card's (no device operation), so that CUDA events on the
    first card bracket a call whose result stays sharded across the cards."""
    def run():
        out = fn()
        first = torch.cuda.current_stream(cards[0])
        for d in cards[1:]:
            first.wait_stream(torch.cuda.current_stream(d))
        return out
    return run


def _peak_bytes(fn, dev) -> int:
    """The most memory ``fn()`` held on ``dev`` at once, above what was
    allocated there before it (its result included)."""
    _sync_all()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn()
    _sync_all()
    peak = torch.cuda.max_memory_allocated(dev) - base
    del out
    return peak


def _frames_across_cards(dev, gen, nc: int) -> None:
    """Phase 18, with several cards: the frame index as a 0-d int32 tensor on
    ``dev`` through the pipeline's two chains row-sharded across ``nc``
    cards, and through the batch sharded over them, each strip or share
    taking it on its own card (``sharding.shard_frame``), from a tensor and
    from a ``Sharded`` input: each result's shards on their cards and its
    gather bit-equal to the unsharded call with the frame as a host int.
    Then 16 Performance f32 frames batch-sharded over the cards, in turn
    with one card, and the peak memory on ``dev`` of the sharded call."""
    import fsr_tpu_torch as ft
    from fsr_tpu_torch.kernels.epilogue import Epilogue
    from fsr_tpu_torch.parallel import sharding
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn, device_trace

    out4k = (2 * MAIN_SHAPE[2], 2 * MAIN_SHAPE[3])
    x = torch.rand(MAIN_SHAPE, generator=gen, device=dev)
    q8 = (torch.rand(QUALITY_SHAPE, generator=gen, device=dev) * 255).to(torch.uint8)
    grain = torch.rand((3, *out4k), generator=gen, device=dev) - 0.5
    tex = torch.rand((2, 64, 64), generator=gen, device=dev)
    chains = {"HDR tail": (x * 16, dict(hdr_srtm=True, grain_amount=0.3, dither_bits=10)),
              "display with a dither page, u8": (q8, dict(grain_amount=0.25, dither_bits=8, out_dtype=torch.uint8,
                                                          compute_dtype=torch.bfloat16, dither_texture=tex))}
    mesh = sharding.make_mesh(nc, ("sp",))
    on_card = torch.tensor(7, dtype=torch.int32, device=dev)

    def check(got, want, what):
        _sync_all()
        _on_mesh(got, what)
        if not torch.equal(got.gather(dev), want):
            raise AssertionError(f"{what} with the frame on {dev}: differs from the unsharded call")

    for name, (src, kw) in chains.items():
        pipe = ft.UpscalePipeline(out4k, mesh=mesh, impl="kernel", **kw)
        want = ft.UpscalePipeline(out4k, impl="kernel", **kw)(src, grain=grain, frame=7)
        for label, s in (("a tensor", src), ("a Sharded", sharding.Sharded.put(src, mesh, (None, None, "sp", None)))):
            check(pipe(s, grain=grain, frame=on_card), want, f"{name} across {nc} cards from {label} input")
    epi = Epilogue(dither_bits=10)
    bmesh = sharding.make_mesh(nc)
    want = ft.upscale(x, preset="performance", impl="kernel", epilogue=epi, frame=7)
    for label, s in (("a tensor", x), ("a Sharded", sharding.shard_batch(x, bmesh))):
        got = sharding.upscale_batch_sharded(s, bmesh, preset="performance", impl="kernel", epilogue=epi,
                                             frame=on_card)
        check(got, want, f"the batch over {nc} cards from {label} input")
    print(f"    the frame as a tensor on {dev}: the pipeline's HDR tail and display chains across {nc} cards, and "
          f"the batch over them, from a tensor and from a Sharded input: shards on their cards, each gather "
          f"bit-equal to the unsharded calls with a host int")
    del want, got

    # 16 Performance f32 frames, batch-sharded over the cards, against one card.
    x16 = torch.rand((16, *MAIN_SHAPE[1:]), generator=gen, device=dev)
    xs16 = sharding.shard_batch(x16, bmesh)
    cards_of = list(bmesh.devices.flat)

    def over(s):
        return sharding.upscale_batch_sharded(s, bmesh, preset="performance")

    out, got_n = _drive(lambda: over(xs16), {"K1": nc})
    want = ft.upscale(x16, preset="performance")
    check(out, want, f"16 frames over {nc} cards")
    del out
    peak = _peak_bytes(lambda: over(xs16), dev)
    if peak >= _nbytes(want):
        raise AssertionError(f"16 frames over {nc} cards: {peak} bytes at the peak on {dev}, not below one "
                             f"output's {_nbytes(want)}")
    t = cuda_times_in_turn({"over the cards, Sharded input": _joined(lambda: over(xs16), cards_of),
                            "over the cards, tensor input": _joined(lambda: over(x16), cards_of),
                            "over the cards + gather": lambda: over(xs16).gather(dev),
                            "one card": lambda: ft.upscale(x16, preset="performance")})
    tr = device_trace(lambda: over(xs16), 5)
    print(f"    16 frames 1080p -> 4K f32 batch-sharded over {nc} cards: launches {got_n}, gather bit-equal to "
          f"one card's; peak on {dev} {peak / 2**20:.1f} MiB (one output {_nbytes(want) / 2**20:.1f}); ms per call "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + f"; traced over 5 calls: busy {tr['busy_ms']:.4f} of {tr['window_ms']:.4f} ms, per card "
          + ", ".join(f"{i}: {ms:.4f}" for i, ms in tr["busy_ms_by_device"].items()))
    del x16, xs16, want


def _clocks() -> str:
    """The card's SM clock and its maximum, power draw and temperature."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _probes(dev, card: str) -> list:
    """Phase 19: the probes P1-P4 (kernels/probes.py) through their tools
    (tools_torch/ablation), held against their plain versions, then timed in
    turn with K1.  Returns their entries of the kernels line."""
    from fsr_tpu_torch.kernels import fused, probes
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, cuda_times_in_turn
    from tools_torch.ablation import fp16_probe, fused_roofline, opmix_floor

    f32, f16 = torch.float32, torch.float16
    print(f"phase 19: the probes P1-P4 on {card}")
    sharp = opmix_floor.SHARP
    image = opmix_floor.tiny_frame(dev)
    padded, fplan = opmix_floor.operand(image)
    tile = probes.TILE
    plain = {rcas: fused.upscale_padded_reference(padded, fplan, tile, sharp, rcas) for rcas in (True, False)}
    k1 = {rcas: fused.upscale_padded(padded, fplan, tile, sharp, rcas) for rcas in (True, False)}
    replays = [
        # name, wrapper key, RCAS, the tool's keywords
        ("P1", "P1", True, {}),
        ("P1 EASU only", "P1", False, {"rcas": False}),
        ("P2", "P2", True, {"shared": True}),
    ]
    err = {}

    def held(name, got, rcas, what):
        e = _compare(got, plain[rcas], f"{name} {what} vs upscale_padded_reference")
        d = (got - k1[rcas]).abs().max().item()
        print(f"  {name} {what} vs K1 on the same padded frame: max-abs {d:.3e} (limit {F32_TOL:g})"
              + (", bit-equal" if d == 0 else ""))
        if not d <= F32_TOL:
            raise AssertionError(f"{name} {what}: disagrees with K1")
        err[name] = max(err.get(name, 0.0), e)

    # Small grids, then the headline grid through the tool's path (K4 pads
    # the frame, one launch of the replay).
    for grid in ((1, 1, 1), (3, 2, 2)):
        for name, key, rcas, kw in replays:
            if key == "P2":
                fn = lambda: probes.opmix_replay_shared(padded, fplan, sharp, grid)
            else:
                fn = lambda: probes.opmix_replay(padded, fplan, sharp, rcas, grid)
            got, _ = _drive(fn, {key: 1})
            held(name, got, rcas, f"grid {grid}")
    runs = {}
    for name, key, rcas, kw in replays:
        got, n = _drive(lambda: opmix_floor.replay(image, **kw), {"K4": 1, key: 1})
        held(name, got, rcas, f"grid {probes.HEADLINE_GRID}, launches {n}")
        runs[name] = dict(launches=n[key], out=got)
    d = (runs["P2"]["out"] - runs["P1"]["out"]).abs().max().item()
    print(f"  P2 vs P1: max-abs {d:.3e}" + (", bit-equal" if d == 0 else ""))

    # P3: both types and chain counts at the reading size, against the plain
    # recurrence: float32 within P3_F32_REL relative (the kernel's FMAs round
    # once, the plain version's mul and add twice); half2 within P3_HALF2_REL
    # (two float16 steps: the plain version rounds each step once from
    # float32, which holds this block's products and sums, so bit-equality is
    # expected).
    x = fused_roofline.fma_input(dev)
    fma = {}
    for dt in (f32, f16):
        for chains in (4, 8):
            got, n = _drive(lambda: fused_roofline.fma_run(x, dt, chains), {"P3": 1})
            want = probes.fma_rate_reference(x, dt, chains)
            rel = ((got.float() - want.float()).abs() / want.float().abs()).max().item()
            limit = P3_F32_REL if dt == f32 else P3_HALF2_REL
            off = int((got != want).sum())
            print(f"  P3 {dt} x{chains} chains, {fused_roofline.fma_reps(dt, chains)} repeats: launches {n}; "
                  f"vs the plain recurrence max relative {rel:.3e} (limit {limit:g}), {off} of {got.numel()} differ")
            if not (torch.isfinite(got.float()).all() and rel <= limit):
                raise AssertionError(f"P3 {dt} x{chains}: disagrees with its plain version")
            fma[(dt, chains)] = dict(launches=n["P3"], err=rel)

    # P4: the three float16 modes, one launch each.
    h = fp16_probe.probe_input(dev)
    outs, n4 = _drive(lambda: [probes.fp16_probe(h, m) for m in range(3)], {"P4": 3})
    p4_err = 0.0
    for mode, got in enumerate(outs):
        a = fp16_probe.agreement(mode, got, probes.fp16_probe_reference(h, mode))
        print(f"  P4 mode {mode} ({probes.FP16_MODES[mode]}): {'runs and agrees' if a['ok'] else 'DISAGREES'}, "
              f"max-abs {a['max_abs']:.3e} (limit {a['limit']:.3e}), {a['off']} of {got.numel()} values differ")
        if not a["ok"]:
            raise AssertionError(f"P4 mode {mode}: disagrees with its plain version")
        p4_err = max(p4_err, a["max_abs"])

    # The readings, in turn with K1, with the card's clocks before and after.
    fns = opmix_floor.reading_fns(dev)
    for (dt, chains) in fma:
        fns[f"P3 {'f32' if dt == f32 else 'half2'} x{chains}"] = (
            lambda dt=dt, chains=chains: fused_roofline.fma_run(x, dt, chains))
    for mode in range(3):
        fns[f"P4 mode {mode}"] = lambda mode=mode: probes.fp16_probe(h, mode)
    before = _clocks()
    ms = cuda_times_in_turn(fns, 5)
    after = _clocks()
    print(f"  readings in turn (5 rounds, CUDA-event medians, ms per call); clocks.sm, clocks.max.sm, power.draw, "
          f"temperature before: {before}; after: {after}")
    for k, v in ms.items():
        print(f"    {k:>16}: {v:.4f} ms")
    for line in opmix_floor.report(ms):
        print("  " + line)
    best = {}
    for (dt, chains), r in fma.items():
        name = f"P3 {'f32' if dt == f32 else 'half2'} x{chains}"
        r["flops"] = fused_roofline.fma_flops(x, dt, chains)
        tf = r["flops"] / (ms[name] * 1e-3) / 1e12
        peak = fused_roofline.PEAK_TFLOPS[dt]
        print(f"  {name}: {tf:.2f} TFLOP/s ({tf / 2:.2f} T el-ops/s, FMA = 1), {tf / peak:.1%} of the data "
              f"sheet's {peak:g}")
        if dt not in best or tf > best[dt][1]:
            best[dt] = (chains, tf)

    ops = fused_roofline.ops_per_pixel()
    npix = opmix_floor.headline_pixels()
    for conv, c in ops.items():
        print(f"  ops per pixel, {conv}: " + ", ".join(f"{k} {v:g}" for k, v in c.items()))
    rate = best[f32][1] * 1e12
    for dt in ("f32", "bf16"):
        t = ms[f"K1 {dt}"] * 1e-3
        u2 = ops["convention 2"]["per_px"] * npix / rate / t
        u1 = ops["convention 1"]["per_px"] * npix / (rate / 2) / t
        print(f"  K1 {dt}: utilization at the achieved float32 rate {u2:.1%} (convention 2), "
              f"{u1:.1%} (convention 1, FMA = 1)")

    # Plain versions' times, and the kernels line's entries.
    plain_ms = {rcas: cuda_time_ms(lambda: fused.upscale_padded_reference(padded, fplan, tile, sharp, rcas),
                                   warmup=1, iters=5) for rcas in (True, False)}
    src, nb = "fsr_tpu_torch/csrc/probes.cu", _nbytes(padded) + _nbytes(plain[True])
    entries = [
        _kernel_entry("opmix_replay (P1): K1's math stream, no global tap loads", src,
                      "tools/ablation/opmix_floor.py:73", runs["P1"]["launches"], err["P1"], ms["P1"],
                      plain_ms[True], nb, opmix_floor.stream_ops("replay") * npix),
        _kernel_entry("opmix_replay (P1), EASU only", src, "tools/ablation/opmix_floor.py:73",
                      runs["P1 EASU only"]["launches"], err["P1 EASU only"], ms["P1 EASU only"], plain_ms[False], nb,
                      opmix_floor.stream_ops("replay easu_only") * npix),
        _kernel_entry("opmix_replay_shared (P2): the shared-dataflow floor", src,
                      "tools/ablation/opmix_floor.py:179", runs["P2"]["launches"], err["P2"], ms["P2"],
                      plain_ms[True], nb, opmix_floor.stream_ops("shared") * npix),
    ]
    for dt, what, rate in ((f32, "f32", F32_OPS_PER_S), (f16, "half2", HALF2_OPS_PER_S)):
        chains = best[dt][0]
        r = fma[(dt, chains)]
        entries.append(_kernel_entry(
            f"fma_rate (P3), {what}, {chains} chains", src, "tools/ablation/fused_roofline.py:108", r["launches"],
            r["err"], ms[f"P3 {what} x{chains}"],
            cuda_time_ms(lambda: probes.fma_rate_reference(x, dt, chains), warmup=1, iters=3),
            _nbytes(x) + x.numel() * (4 if dt == f32 else 2), r["flops"], ops_per_s=rate))
    p4_plain = sum(cuda_time_ms(lambda: probes.fp16_probe_reference(h, m)) for m in range(3))
    entries.append(_kernel_entry(
        "fp16_probe (P4): f16 load, f16 FMA chain, f16 store", src, "tools/ablation/fp16_probe.py:41",
        n4["P4"], p4_err, sum(ms[f"P4 mode {m}"] for m in range(3)), p4_plain,
        3 * _nbytes(h) + _nbytes(*outs), 0))
    return entries


def _compare_f16(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """K6 against its plain version: bit-equal, or at most F16_SHARE of the
    values off, each by one float16 step (adjacent bit patterns of one
    sign).  Prints both counts; returns the largest difference."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    gb, wb = got.view(torch.int16).int(), want.view(torch.int16).int()
    bits = int((gb != wb).sum())
    differ = got != want
    off = int(differ.sum())
    step = (gb - wb).abs()[differ].max().item() if off else 0
    same_sign = bool(((gb < 0) == (wb < 0))[differ].all()) if off else True
    mx = (got.float() - want.float()).abs().max().item()
    print(f"  {what}: {bits} of {got.numel()} bit patterns differ, {off} values "
          f"(share {off / got.numel():.2e}, limit {F16_SHARE:g}), largest {step} float16 step(s), max-abs {mx:.3e}")
    if off / got.numel() > F16_SHARE or step > 1 or not same_sign:
        raise AssertionError(f"{what}: K6 disagrees with its plain version")
    return mx


def _k6_reciprocal(dev) -> None:
    """K6's half reciprocal (fsr_half.cuh:rcp, through the test entry
    fsr_easu_h_rcp_check) of every float16 bit pattern against torch's
    ``1.0 / x`` in float16 on the card; fails if any pattern's result
    differs (a NaN against a NaN of another payload counted apart)."""
    from fsr_tpu_torch.kernels import _build

    v = torch.arange(65536, dtype=torch.int32, device=dev)
    x = ((v + 32768) % 65536 - 32768).to(torch.int16).view(torch.float16)
    want = 1.0 / x
    got = torch.empty_like(x)
    err = _build.library().fsr_easu_h_rcp_check(got.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize(dev)
    if err != 0:
        raise RuntimeError(f"fsr_easu_h_rcp_check: cudaError {err}")
    bits = got.view(torch.int16) != want.view(torch.int16)
    nans = torch.isnan(got) & torch.isnan(want)
    differ, payload = int((bits & ~nans).sum()), int((bits & nans).sum())
    print(f"  K6 reciprocal over all 65,536 float16 patterns vs torch's 1.0 / x on the card: {differ} patterns "
          f"differ ({payload} NaN results of another payload)")
    if differ:
        raise AssertionError(f"K6's reciprocal differs from torch's 1.0 / x on {differ} float16 patterns")


# K6's kernels read from the library's SASS: the whole-frame form and its
# strip-source form, float16 RGB with RCAS.
K6_SASS = (("K6 f16", "easu_h_kernelI6__halfLb1ELb0ELb0E"),
           ("K6 f16, strip", "easu_h_kernel_stripI6__halfLb1ELb0ELb0E"))


def _start_k6_sass() -> subprocess.Popen:
    """K6's static SASS (``opmix_floor.sass_tables`` of ``K6_SASS``) in a
    process of its own, started after the build: ``cuobjdump`` lists the
    whole library, tens of seconds that overlap the phases before 17, which
    reads the result (``_k6_sass``).  Killed at exit if still running."""
    from fsr_tpu_torch.kernels import _build

    code = ("import json, sys; from tools_torch.ablation import opmix_floor; "
            "print(json.dumps(opmix_floor.sass_tables(sys.argv[1], json.loads(sys.argv[2]))))")
    proc = subprocess.Popen([sys.executable, "-c", code, str(_build.library_path()), json.dumps(K6_SASS)],
                            stdout=subprocess.PIPE, text=True, cwd=ROOT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def _k6_sass(listing: subprocess.Popen) -> None:
    """K6's static SASS (``_start_k6_sass``'s result) beside its first
    design's (K6_SASS_PARENT): the half arithmetic by lanes, the packing,
    MUFU, and no CALL (no float32 division's slow path), in the whole-frame
    and the strip-source form."""
    from tools_torch.ablation import opmix_floor

    out, _ = listing.communicate()
    if listing.returncode != 0:
        raise RuntimeError(f"K6's SASS listing exited with {listing.returncode}")
    counts, lanes = ({k: collections.Counter(v) for k, v in table.items()} for table in json.loads(out))
    rows = {**counts, "K6 f16 scalar": collections.Counter(K6_SASS_PARENT)}
    for line in opmix_floor.sass_lines(rows, opmix_floor.HALF_SASS_OPS):
        print("  " + line)
    for label, _ in K6_SASS:
        print(f"  {label} half arithmetic ({'/'.join(opmix_floor.HALF_ARITH)}): {lanes[label]['two lanes']} on two "
              f"lanes, {lanes[label]['one lane']} on one")
        if counts[label]["CALL"]:
            raise AssertionError(f"{label} calls a subroutine {counts[label]['CALL']} time(s): a division's slow path")
    print(f"  (scalar design: {K6_LANES_PARENT[0]} on two lanes, {K6_LANES_PARENT[1]} on one); a thread's loop body is "
          "two pixels here, one there")


def _k6(dev, card: str, frames, qframes, rgba_frames, listing: subprocess.Popen) -> list:
    """Phase 17's K6 part: the float16 upscale at batch 4 through the entry
    point, one K6 launch and no K1, K2 or K3 per call, each bit-equal to
    ``easu_h_reference`` on the same inputs (alpha bit-equal); one call
    under autograd; K6 (10 queued), the torch path and K2 bf16 timed in
    turn; K6's ptxas lines, its SASS and its reciprocal over every half.
    Returns K6's entries of the kernels line."""
    import fsr_tpu_torch as ft
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels import _build, easu_gather, easu_h
    from fsr_tpu_torch.utils.profiling import cuda_time_ms

    f16, bf16 = torch.float16, torch.bfloat16
    # The Performance frames' 2x and the Quality frames' 1.5x: 4K from the
    # main shapes.
    (ph, pw), (qh, qw) = frames.shape[-2:], qframes.shape[-2:]
    out4k = (2 * ph, 2 * pw)
    if (round(1.5 * qh), round(1.5 * qw)) != out4k:
        raise ValueError("the Quality frames must upscale by 1.5x to the Performance frames' output")
    pcon = EasuConstants.create((pw, ph), None, out4k[::-1])
    qcon = EasuConstants.create((qw, qh), None, out4k[::-1])
    rcon = RcasConstants(0.25)
    entry = None
    for line in (_build.build_dir() / "build.log").read_text().splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif entry is not None and "easu_h_kernel" in entry and ("Used" in line or "spill" in line):
            print(f"  ptxas K6 {entry.split('easu_h_kernel', 1)[1][:24]}: {line.split('info    :')[-1].strip()}")
    _k6_sass(listing)
    _k6_reciprocal(dev)
    p16, q16, r16 = frames.half(), qframes.half(), rgba_frames.half()
    paths = [
        # name, image, upscale kwargs, constants, K6's (apply_rcas, denoise)
        ("performance f16", p16, dict(preset="performance"), pcon, (True, False)),
        ("quality f16", q16, dict(preset="quality"), qcon, (True, False)),
        ("RGBA performance f16", r16, dict(preset="performance"), pcon, (True, False)),
        ("performance f16, RCAS off", p16, dict(preset="performance", apply_rcas=False), pcon, (False, False)),
        ("performance f16, denoise", p16, dict(preset="performance", denoise=True), pcon, (True, True)),
        ("performance, f32 source", frames, dict(preset="performance"), pcon, (True, False)),
    ]
    runs = {}
    for name, x, kw, con, (rc, dn) in paths:
        out, n = _drive(lambda: ft.upscale(x, compute_dtype=f16, **kw), ("K6",))
        if tuple(out.shape) != tuple(x.shape[:2]) + out4k or out.dtype != f16 or out.device != x.device:
            raise AssertionError(f"{name}: got {tuple(out.shape)} {out.dtype} {out.device}")
        want = easu_h.easu_h_reference(x, out4k, con, rcon, rc, dn)
        if x.shape[1] == 4 and not torch.equal(out[:, 3].view(torch.int16), want[:, 3].view(torch.int16)):
            raise AssertionError(f"{name}: alpha not bit-equal to the plain version")
        err = _compare_f16(out, want, f"{name}: launches {n}; vs easu_h_reference")
        runs[name] = dict(launches=n["K6"], err=err, nbytes=_nbytes(x, out))
        del out, want

    # Every source type, RGB and RGBA, RCAS off, on and denoise, at a small
    # size; then a DRS viewport and the 1.7x preset: one K6 launch each,
    # bit-equal to its plain version (alpha bit-equal).
    small = torch.from_numpy(np.random.default_rng(19).uniform(0, 1, (2, 4, 90, 160)).astype(np.float32)).to(dev)

    def source(kind, nc):
        x = small[:, :nc].contiguous()
        return (x * 255).to(torch.uint8) if kind == "uint8" else x.to(getattr(torch, kind))

    sweep = [(f"{kind} {('RGB', 'RGBA')[nc - 3]}, {mode}", source(kind, nc),
              dict(preset="performance", apply_rcas=rc, denoise=dn))
             for kind in ("float16", "float32", "bfloat16", "uint8") for nc in (3, 4)
             for mode, rc, dn in (("RCAS off", False, False), ("RCAS on", True, False), ("denoise", True, True))]
    sweep += [("float16 RGBA, DRS 1.5x", source("float16", 4),
               dict(scale=1.5, input_viewport=(80, 144), input_offset=(4, 8))),
              ("bfloat16 RGB, 1.7x", source("bfloat16", 3), dict(preset="balanced")),
              ("uint8 RGBA, 1.7x denoise", source("uint8", 4), dict(preset="balanced", denoise=True)),
              ("float16 RGB, odd width, partial tiles", source("float16", 3), dict(out_size=(157, 293))),
              ("uint8 RGBA denoise, odd width, partial tiles", source("uint8", 4),
               dict(out_size=(179, 321), denoise=True)),
              ("bfloat16 RGB RCAS off, odd width, partial tiles", source("bfloat16", 3),
               dict(out_size=(97, 161), apply_rcas=False))]
    for name, x, kw in sweep:
        out, n = _drive(lambda: ft.upscale(x, compute_dtype=f16, **kw), ("K6",))
        (hin, win), (hout, wout) = x.shape[-2:], out.shape[-2:]
        vh, vw = kw.get("input_viewport", (hin, win))
        oy, ox = kw.get("input_offset", (0, 0))
        con = EasuConstants.create((vw, vh), (win, hin), (wout, hout), (ox, oy))
        want = easu_h.easu_h_reference(x, (hout, wout), con, rcon, kw.get("apply_rcas", True), kw.get("denoise", False))
        if x.shape[1] == 4 and not torch.equal(out[:, 3].view(torch.int16), want[:, 3].view(torch.int16)):
            raise AssertionError(f"{name}: alpha not bit-equal to the plain version")
        _compare_f16(out, want, f"{name}, {hin}x{win} -> {hout}x{wout}: launches {n['K6']}; vs easu_h_reference")
    del small, sweep, out, want

    # One call under autograd: the K6 forward, the torch twin's backward.
    x = torch.rand((1, 3, ph // 2, pw // 2), generator=torch.Generator(device=dev).manual_seed(17), device=dev)
    xg = x.clone().requires_grad_()
    out, n = _drive(lambda: ft.upscale(xg, preset="performance", compute_dtype=f16), ("K6",))
    (g,), nb = _drive(lambda: torch.autograd.grad(out.float().sum(), xg), ())
    xt = x.clone().requires_grad_()
    (gt,) = torch.autograd.grad(ft.upscale(xt, preset="performance", compute_dtype=f16, impl="torch").float().sum(),
                                xt)
    print(f"  autograd {ph // 2}x{pw // 2} -> {ph}x{pw}, f32 source under float16 math: forward launches {n}, "
          f"backward {nb}; "
          f"gradient bit-equal to impl='torch': {torch.equal(g, gt)}")
    if not torch.equal(g, gt) or not torch.isfinite(g).all():
        raise AssertionError("the float16 kernel path's gradient differs from the torch path's")
    del x, xg, xt, out, g, gt

    qb = qframes.to(bf16)
    timed = {
        "K6 performance": lambda: easu_h.easu_h(p16, out4k, pcon, rcon),
        "torch path performance": lambda: easu_h.easu_h_reference(p16, out4k, pcon, rcon),
        "K2 bf16 quality": lambda: easu_gather.easu_gather(qb, out4k, qcon, rcon, True, False, bf16),
        "K6 quality": lambda: easu_h.easu_h(q16, out4k, qcon, rcon),
        "torch path quality": lambda: easu_h.easu_h_reference(q16, out4k, qcon, rcon),
        "K6 RGBA performance": lambda: easu_h.easu_h(r16, out4k, pcon, rcon),
        "torch path RGBA performance": lambda: easu_h.easu_h_reference(r16, out4k, pcon, rcon),
    }
    samples = {k: [] for k in timed}
    for _ in range(3):  # in turn, so that every reading sees the same clocks and card state
        for k, fn in timed.items():
            kw = dict(warmup=1, iters=3) if k.startswith("torch") else KQ
            samples[k].append(cuda_time_ms(fn, **kw))
    t = {k: statistics.median(v) for k, v in samples.items()}
    t["call performance"] = cuda_time_ms(lambda: ft.upscale(p16, preset="performance", compute_dtype=f16))
    nf = frames.shape[0]
    print(f"  times on {card}, batch {nf}, medians of 3 rounds in turn:")
    for k, v in t.items():
        print(f"    {k:>28}: {v / nf:.4f} ms/frame ({v:.3f} ms/call)")
    print("  K6*, K2: the kernel alone, 10 calls queued per sample; torch path: K6's plain version "
          "(easu_h_reference, the float16 torch ops); call: one upscale call, host work included")

    src = "fsr_tpu_torch/csrc/easu_h.cu"
    rep = "fsr_tpu/ops/easu.py:47 + fsr_tpu/ops/rcas.py:42 (jax.jit, float16; no pallas_call)"
    npix = nf * out4k[0] * out4k[1]
    f32_ops, half_ops = (e + r for e, r in zip(EASU_H_OPS, RCAS_H_OPS))
    return [
        _kernel_entry(f"easu_h (K6), float16: {name} path", src, rep, runs[run]["launches"], runs[run]["err"],
                      t["K6 " + key], t["torch path " + key], runs[run]["nbytes"], (f32_ops + alpha) * npix,
                      half_ops=half_ops * npix)
        for name, run, key, alpha in (("performance", "performance f16", "performance", 0),
                                      ("quality", "quality f16", "quality", 0),
                                      ("RGBA performance", "RGBA performance f16", "RGBA performance", ALPHA_OPS))
    ]


# K6's tail forms as a device trace names them (the strip tail form's name
# holds STRIP_NAMES["K6"]).
K6_TAIL_NAMES = ("easu_h_kernel_tail", "easu_h_kernel_strip_tail")


def _f16_tails(grain, page, frame=5) -> dict:
    """The float16 frame tails of phases 17 and 18 as ``upscale`` keyword
    arguments: (a16) the HDR tail, (b16) the display path (on RGBA (d16)),
    (c16) bytes out, (u16) gamma2 and 10-bit TEPD into UNORM10, and the SRTM
    prologue with a dither page into float16."""
    from fsr_tpu_torch.kernels.epilogue import Epilogue

    u8, u16 = torch.uint8, torch.uint16
    return {
        "HDR tail": dict(prologue="srtm", epilogue=Epilogue(transform="srtm_inv", grain_amount=0.25), grain=grain),
        "display": dict(epilogue=Epilogue(grain_amount=0.25, dither_bits=8), grain=grain, frame=frame, out_dtype=u8),
        "bytes": dict(out_dtype=u8),
        "gamma2 + TEPD10": dict(epilogue=Epilogue(transform="gamma2", dither_bits=10), frame=frame, out_dtype=u16),
        "SRTM, grain + page dither8": dict(prologue="srtm", grain=grain, dither_page=page,
                                           epilogue=Epilogue(grain_amount=0.25, dither_bits=8, dither_texture=True)),
    }


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal (float16 by its bit patterns)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def _compare_tail(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """K6 with a frame tail against its plain version (the torch chain on
    the card): float16 by ``_compare_f16``; codes identical or at most
    CODE_SHARE of them one code off (``_compare_steps``, which prints the
    share); RGBA's alpha bit-equal."""
    if got.shape[-3] == 4 and not _same(got[..., 3, :, :], want[..., 3, :, :]):
        raise AssertionError(f"{what}: alpha not bit-equal to the plain version")
    if got.dtype == torch.float16:
        return _compare_f16(got, want, what)
    return _compare_steps(got, want, None, what)


def _tail_ops(kw: dict, texels_per_pixel: float, rgba: bool):
    """(float32, float16) operations per output pixel of K6 with the tail
    of upscale keyword arguments ``kw``: K6's function (EASU_H_OPS +
    RCAS_H_OPS), alpha's bilinear, the SRTM prologue per source texel, and
    the epilogue as K1's (a) row counts it (LFGA_OPS, TEPD_OPS; SRTM^-1 as
    SRTM_OPS_PER_TEXEL, gamma2 3)."""
    f32 = EASU_H_OPS[0] + RCAS_H_OPS[0] + (ALPHA_OPS if rgba else 0)
    epi = kw.get("epilogue")
    if kw.get("prologue") == "srtm":
        f32 += SRTM_OPS_PER_TEXEL * texels_per_pixel
    if epi is not None:
        f32 += {"srtm_inv": SRTM_OPS_PER_TEXEL, "gamma2": 3}.get(epi.transform, 0)
        f32 += (LFGA_OPS if epi.needs_grain else 0) + (TEPD_OPS if epi.dither_bits else 0)
    return f32, EASU_H_OPS[1] + RCAS_H_OPS[1]


def _k6_tail(dev, card: str, frames, qframes) -> list:
    """Phase 17's K6 with the frame tail (ROADMAP item 23): at 90x160 each
    tail of ``_f16_tails`` x every source type x RGB/RGBA, two RCAS modes
    and odd output widths with partial tiles, one K6 launch each and
    bit-equal to ``easu_h_reference`` (codes at most CODE_SHARE one code
    off, printed); the frame as a 0-d int32 tensor on the card over three
    frames and a captured replay (``capture.CapturedFrame``), each bit-equal
    to the eager call with a host int; then at batch 4 the configurations
    (a16) HDR tail, (b16) display, (c16) byte video, (d16) RGBA display and
    (u16) gamma2 + 10-bit TEPD through ``UpscalePipeline`` / ``upscale``:
    one K6 launch and no other device operation in a traced call, against
    the plain version (the torch chain on the card), and in turn the call,
    K6 with the tail alone, the bare K6 on the same frames and the plain
    version.  Returns the kernels line's entries."""
    import fsr_tpu_torch as ft
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels import easu_h
    from fsr_tpu_torch.utils import capture
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, device_trace

    f16, u8, u16 = torch.float16, torch.uint8, torch.uint16
    rcon = RcasConstants(0.25)
    gen = torch.Generator(device=dev).manual_seed(22)
    small = torch.rand((2, 4, 90, 160), generator=gen, device=dev)

    def source(kind, nc):
        x = small[:, :nc].contiguous()
        return (x * 255).to(u8) if kind == "uint8" else x.to(getattr(torch, kind))

    def operands(out_hw):
        return (torch.rand((3, *out_hw), generator=gen, device=dev) - 0.5,
                torch.rand((24, 40), generator=gen, device=dev))

    names = list(_f16_tails(None, None))
    sweep = [(tail, kind, nc, dict(preset="performance")) for tail in names
             for kind in ("float16", "float32", "bfloat16", "uint8") for nc in (3, 4)]
    sweep += [("display", "uint8", 4, dict(preset="performance", apply_rcas=False)),
              ("HDR tail", "float16", 3, dict(preset="performance", denoise=True)),
              ("display", "uint8", 4, dict(out_size=(179, 321))),
              ("gamma2 + TEPD10", "float16", 3, dict(out_size=(157, 293), denoise=True)),
              ("HDR tail", "bfloat16", 4, dict(out_size=(97, 161), apply_rcas=False)),
              ("SRTM, grain + page dither8", "float32", 4, dict(scale=1.5, input_viewport=(80, 144),
                                                                 input_offset=(4, 8)))]
    worst = {}
    for tail, kind, nc, geom in sweep:
        x = source(kind, nc)
        (hin, win) = x.shape[-2:]
        vh, vw = geom.get("input_viewport", (hin, win))
        oy, ox = geom.get("input_offset", (0, 0))
        out_hw = geom.get("out_size") or ((2 * vh, 2 * vw) if "preset" in geom else (round(1.5 * vh), round(1.5 * vw)))
        kw = _f16_tails(*operands(out_hw))[tail]
        out, n = _drive(lambda: ft.upscale(x, compute_dtype=f16, **geom, **kw), ("K6",))
        con = EasuConstants.create((vw, vh), (win, hin), out_hw[::-1], (ox, oy))
        want = easu_h.easu_h_reference(x, out_hw, con, rcon, geom.get("apply_rcas", True), geom.get("denoise", False),
                                       **kw)
        what = f"K6 + {tail}, {kind} {('RGB', 'RGBA')[nc - 3]}, {hin}x{win} -> {out_hw[0]}x{out_hw[1]}"
        err = _compare_tail(out, want, f"{what}: launches {n['K6']}; vs easu_h_reference")
        worst[tail] = max(worst.get(tail, 0.0), err)
    print(f"  K6 with the frame tail at small sizes: {len(sweep)} cases, one K6 launch each, against its plain version")

    # The frame index on the card, eager and captured.
    x = source("uint8", 4)
    grain, page = operands((180, 320))
    kw = {k: v for k, v in _f16_tails(grain, page)["display"].items() if k != "frame"}

    def call(a, frame):
        return ft.upscale(a, preset="performance", compute_dtype=f16, frame=frame, **kw)

    ftensor = torch.zeros((), dtype=torch.int32, device=dev)
    cap, built = _drive(lambda: capture.CapturedFrame(call, x, ftensor), {"K6": capture.WARMUP + 1})
    for f in (0, 7, 2**31 - 1):
        want = call(x, f)
        got, n = _drive(lambda: call(x, torch.tensor(f, dtype=torch.int32, device=dev)), ("K6",))
        rep, nr = _drive(lambda: cap(x, torch.tensor(f, dtype=torch.int32, device=dev)), ())
        if not (_same(got, want) and _same(rep, want)):
            raise AssertionError(f"K6 + display, frame {f}: a frame tensor or the replay differs from the host int")
    print(f"  K6 + display, u8 RGBA: the frame as a 0-d int32 tensor on the card (frames 0, 7, 2**31 - 1), one launch "
          f"each, and replayed (capture.CapturedFrame: {built['K6']} launches at capture, none at a replay): bit-equal "
          "to the eager call with a host int")
    del cap, small, x

    # Full width, batch 4: the configurations of the float16 frame tail.
    nf = frames.shape[0]
    (ph, pw), (qh, qw) = frames.shape[-2:], qframes.shape[-2:]
    out4k = (2 * ph, 2 * pw)
    pcon = EasuConstants.create((pw, ph), None, out4k[::-1])
    qcon = EasuConstants.create((qw, qh), None, out4k[::-1])
    p16, p8, q8 = frames.half(), (frames * 255).to(u8), (qframes.float() * 255).to(u8)
    r8 = (torch.rand((nf, 4, qh, qw), generator=gen, device=dev) * 255).to(u8)
    grain4k = torch.rand((3, *out4k), generator=gen, device=dev) - 0.5
    tails = _f16_tails(grain4k, None, 3)
    hdr = ft.UpscalePipeline(out4k, hdr_srtm=True, hdr_out=True, grain_amount=0.25, compute_dtype=f16)
    disp = ft.UpscalePipeline(out4k, grain_amount=0.25, dither_bits=8, out_dtype=u8, compute_dtype=f16)
    u10 = ft.UpscalePipeline(out4k, gamma2_out=True, dither_bits=10, out_dtype=u16, compute_dtype=f16)
    configs = [
        # name, frames, call, constants, the tail K6 takes
        ("(a16) HDR tail, f16 1080p", p16, lambda: hdr(p16, grain=grain4k, frame=3), pcon, "HDR tail"),
        ("(b16) display, u8 1440p -> u8", q8, lambda: disp(q8, grain=grain4k, frame=3), qcon, "display"),
        ("(c16) byte video, u8 1080p -> u8", p8, lambda: ft.upscale(p8, scale=2.0, out_dtype=u8, compute_dtype=f16),
         pcon, "bytes"),
        ("(d16) RGBA display, u8 1440p -> u8", r8, lambda: disp(r8, grain=grain4k, frame=3), qcon, "display"),
        ("(u16) gamma2 + TEPD10, f16 1080p -> u16", p16, lambda: u10(p16, frame=3), pcon, "gamma2 + TEPD10"),
    ]
    print(f"  K6 with the frame tail at batch {nf} -> 4K on {card}:")
    entries = []
    for name, x, call, con, tail in configs:
        out, n = _drive(call, ("K6",))
        alone = lambda x=x, con=con, tail=tail: easu_h.easu_h(x, out4k, con, rcon, **tails[tail])
        if not _same(alone(), out):
            raise AssertionError(f"{name}: K6 called alone differs from the call")

        def plain(call=call):
            with _plain_kernels():
                return call()

        err = _compare_tail(out, plain(), f"{name}: launches {n}; vs its plain version (the torch chain)")
        ops = device_trace(call, 1)["launches"]
        k6 = sum(c for k, c in ops.items() if K6_TAIL_NAMES[0] in k)
        other = {k[:60]: c for k, c in ops.items() if K6_TAIL_NAMES[0] not in k}
        print(f"    a traced call: {k6:g} launch(es) of {K6_TAIL_NAMES[0]}, other device operations {other or 'none'}")
        if round(k6) != 1 or other:
            raise AssertionError(f"{name}: a traced call must hold one K6 launch and nothing else")
        bare = lambda x=x: ft.upscale(x, out_size=out4k, compute_dtype=f16)
        fns = {"call": call, "K6 with the tail": alone, "bare K6": bare, "plain": plain}
        samples = {k: [] for k in fns}
        for _ in range(3):  # in turn
            for k, fn in fns.items():
                samples[k].append(cuda_time_ms(fn, warmup=1, iters=3) if k == "plain" else cuda_time_ms(fn, **KQ))
        t = {k: statistics.median(v) for k, v in samples.items()}
        # Busy ms per call over 5 traced calls, retaken when CUPTI missed a K6 launch.
        busy = {k: device_trace(fns[k], 5, short=lambda tr: sum(
            c for kn, c in tr["launches"].items() if KERNEL_NAMES["K6"] in kn) < 1)["busy_ms"] / 5
            for k in ("call", "bare K6")}
        print("    in turn (call, K6 alone, bare K6: 10 queued; plain: one call): "
              + ", ".join(f"{k} {v / nf:.4f}" for k, v in t.items())
              + " ms/frame; traced busy " + ", ".join(f"{k} {v / nf:.4f}" for k, v in busy.items()) + " ms/frame")
        f32_ops, half_ops = _tail_ops(tails[tail], x.shape[-2] * x.shape[-1] / (out4k[0] * out4k[1]), x.shape[1] == 4)
        npix = nf * out4k[0] * out4k[1]
        grain_bytes = _nbytes(grain4k) if tails[tail].get("grain") is not None else 0
        entries.append(_kernel_entry(
            f"easu_h (K6) with the frame tail: {name}; plain: the torch chain", "fsr_tpu_torch/csrc/easu_h.cu",
            "fsr_tpu/api.py:280-309 (jax.jit float16 chain: decode, SRTM, easu + rcas, the epilogue "
            "fsr_tpu/api.py:56-86, the store; no pallas_call)", n["K6"], err, t["K6 with the tail"], t["plain"],
            _nbytes(x, out) + grain_bytes, f32_ops * npix, half_ops=half_ops * npix))
        del out
    return entries

def _f16_sources(card: str, frames, qframes, rgba_frames) -> list:
    """Phase 17's float16 images under float32 or bfloat16 math, at batch 4:
    one K1 or K2 launch per call and no K6, bit-equal to the same call on
    the image widened to float32 (a float16 source widens exactly at the
    kernels' loads, or rounds there to bfloat16 storage), and within phase
    4's limits of the kernels' plain versions; float32 math timed against
    the float32 source, in turn.  Returns the kernels line's entries."""
    import fsr_tpu_torch as ft
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels import easu_gather, fused
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, cuda_times_in_turn

    f32, bf16 = torch.float32, torch.bfloat16
    (ph, pw), (qh, qw) = frames.shape[-2:], qframes.shape[-2:]
    out4k = (2 * ph, 2 * pw)
    rcon = RcasConstants(0.25)
    cases = [("performance", frames.half(), dict(preset="performance"), "K1",
              EasuConstants.create((pw, ph), None, out4k[::-1])),
             ("quality", qframes.half(), dict(preset="quality"), "K2",
              EasuConstants.create((qw, qh), None, out4k[::-1])),
             ("RGBA performance", rgba_frames.half(), dict(preset="performance"), "K1",
              EasuConstants.create((pw, ph), None, out4k[::-1]))]
    entries = []
    for name, x, kw, k, con in cases:
        for dt in (f32, bf16):
            what = f"{name}, float16 image under {str(dt)[6:]} math"
            out, n = _drive(lambda: ft.upscale(x, compute_dtype=dt, **kw), (k,))
            want, _ = _drive(lambda: ft.upscale(x.float(), compute_dtype=dt, **kw), (k,))
            print(f"  {what}: launches {n}; bit-equal to the call on the widened image: {torch.equal(out, want)}")
            if out.dtype != dt or not torch.equal(out, want):
                raise AssertionError(f"{what}: differs from the call on the widened image")
            del want
            with _plain_kernels():
                plain = ft.upscale(x, compute_dtype=dt, impl="kernel", **kw)
            err = _compare(out, plain, what + " vs the plain versions")
            del out, plain
            if dt != f32:
                continue
            xf = x.float()
            if k == "K1":
                fns = {"float16 source": lambda: fused.upscale_fused(x, out4k, con, rcon),
                       "float32 source": lambda: fused.upscale_fused(xf, out4k, con, rcon)}
            else:
                fns = {"float16 source": lambda: easu_gather.easu_gather(x, out4k, con, rcon, True),
                       "float32 source": lambda: easu_gather.easu_gather(xf, out4k, con, rcon, True)}
            t = cuda_times_in_turn(fns, **KQ)
            with _plain_kernels():
                plain_ms = cuda_time_ms(lambda: ft.upscale(x, impl="kernel", **kw), warmup=1, iters=3)
            nf = x.shape[0]
            print(f"    {k} on {card}, 10 queued: float16 source {t['float16 source'] / nf:.4f} ms/frame, "
                  f"float32 source {t['float32 source'] / nf:.4f}, in turn; plain {plain_ms / nf:.4f}")
            npix = nf * out4k[0] * out4k[1]
            ops = (EASU_RCAS_OPS + (ALPHA_OPS if x.shape[1] == 4 else 0)) * npix
            src = "fsr_tpu_torch/csrc/fused.cu" if k == "K1" else "fsr_tpu_torch/csrc/easu_gather.cu"
            rep = "fsr_tpu/kernels/fused.py:403" if k == "K1" else "fsr_tpu/kernels/easu_gather.py:350"
            kname = "upscale_fused (K1)" if k == "K1" else "easu_gather (K2)"
            entries.append(_kernel_entry(f"{kname}, float16 source, float32 math: {name} path", src, rep, n[k], err,
                                         t["float16 source"], plain_ms, _nbytes(x) + npix * x.shape[1] * 4, ops))
            del xf
    return entries


def _autodiff(dev, card: str, trace: bool) -> None:
    """Phase 20: gradients on the card.  Each case runs its kernel forward
    (exactly one launch) and the torch twin's backward (no launch); the
    gradient is held against the torch path's (bit-equal under a linear
    loss, within the CPU tests' limits under a squared one) and, at 540p ->
    1080p, against the port's CPU gradient; then the training example's
    inverse problem takes 3 Adam steps at 1080p -> 4K, and its steps run
    captured against eager (``_captured_training``).  With ``trace``, a
    profiler trace of one forward and backward of each case: the device's
    busy time, idle share and its largest kernels."""
    import fsr_tpu_torch as ft
    from examples_torch import train_through_fsr as trainer
    from fsr_tpu_torch.utils import profiling
    from fsr_tpu_torch.utils.profiling import device_trace

    f32, bf16 = torch.float32, torch.bfloat16
    wrappers = ("K1", "K2", "K3", "K4")
    counting = contextlib.ExitStack()
    rec = None

    def reset():  # the launches from here on, recorded until counts()
        nonlocal rec
        counting.close()
        rec = counting.enter_context(profiling.recording())

    def counts():
        torch.cuda.synchronize()
        counting.close()
        return _launches(rec, wrappers)

    def grad(fn, x0, square, impl):
        x = x0.clone().requires_grad_()
        out = fn(x, impl).float()
        (out * out if square else out).sum().backward()
        return x.grad

    print(f"phase 20: autodiff on the card ({card}): kernel forward, torch twin backward, batch 1")
    gen = torch.Generator(device=dev).manual_seed(20)
    cases = [
        # name, input shape, dtype, the call, its kernel
        ("(i) performance f32 1080p->4K", (1, 3, 1080, 1920), f32,
         lambda x, impl: ft.upscale(x, preset="performance", impl=impl), "K1"),
        ("(ii) quality f32 1440p->4K", (1, 3, 1440, 2560), f32,
         lambda x, impl: ft.upscale(x, preset="quality", impl=impl), "K2"),
        ("(iii) sharpen f32 4K", (1, 3, 2160, 3840), f32, lambda x, impl: ft.sharpen(x, impl=impl), "K3"),
        ("(iv) performance bf16 1080p->4K", (1, 3, 1080, 1920), bf16,
         lambda x, impl: ft.upscale(x, preset="performance", compute_dtype=bf16, impl=impl), "K1"),
    ]
    for what, shape, dt, fn, kernel in cases:
        x0 = torch.rand(shape, generator=gen, device=dev).to(dt)
        grad(fn, x0, False, "kernel")  # warm-up
        torch.cuda.synchronize()
        fwd, bwd = [], []
        for _ in range(3):
            x = x0.clone().requires_grad_()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            reset()
            ev[0].record()
            loss = fn(x, "kernel").float().sum()
            ev[1].record()
            n_fwd = counts()
            reset()
            ev[2].record()
            loss.backward()
            ev[3].record()
            n_bwd = counts()
            fwd.append(ev[0].elapsed_time(ev[1]))
            bwd.append(ev[2].elapsed_time(ev[3]))
            want = {k: int(k == kernel) for k in wrappers}
            if n_fwd != want or any(n_bwd.values()):
                raise AssertionError(f"{what}: forward launches {n_fwd} (want {want}), backward {n_bwd} (want none)")
        peak = torch.cuda.max_memory_allocated()
        g_k = x.grad
        del x, loss
        g_t = grad(fn, x0, False, "torch")
        if not torch.isfinite(g_k).all() or not torch.equal(g_k, g_t):
            raise AssertionError(f"{what}: the kernel path's gradient is not the torch path's, bit for bit "
                                 f"({int((g_k != g_t).sum())} values differ)")
        del g_t
        gq_k, gq_t = grad(fn, x0, True, "kernel"), grad(fn, x0, True, "torch")
        scale = gq_t.abs().max().item()
        if dt == f32:
            ok = torch.allclose(gq_k, gq_t, rtol=GRAD_SQ_RTOL, atol=GRAD_SQ_ATOL)
            limits = f"rtol {GRAD_SQ_RTOL:g}, atol {GRAD_SQ_ATOL:g}"
            stats = f"max {(gq_k - gq_t).abs().max().item():.3e}"
        else:
            d = ((gq_k - gq_t).abs() / scale).flatten().float()
            d = d[:: d.numel() // (1 << 24) + 1]
            p99, med = torch.quantile(d, 0.99).item(), d.median().item()
            ok = p99 <= GRAD_BF16_SQ_P99 and med <= GRAD_BF16_SQ_MEDIAN
            limits = f"p99 {GRAD_BF16_SQ_P99:g}, median {GRAD_BF16_SQ_MEDIAN:g} of max|g|"
            stats = f"p99 {p99:.3e} median {med:.3e} of max|g|"
        print(f"  {what}: forward {statistics.median(fwd):.3f} ms ({kernel} x1), backward "
              f"{statistics.median(bwd):.3f} ms (no kernel), peak {peak / 2**30:.2f} GiB "
              f"({(peak - before) / 2**30:.2f} GiB above the {before / 2**30:.2f} GiB held before the call); "
              f"linear-loss gradient bit-equal to impl='torch'; squared loss {stats} (limits {limits}), "
              f"max|g| {scale:.3e}; {card}")
        if not ok or not torch.isfinite(gq_k).all():
            raise AssertionError(f"{what}: squared-loss gradient outside the CPU tests' limits")
        del gq_k, gq_t
        if trace:
            tr = device_trace(lambda: grad(fn, x0, False, "kernel"), 1)
            top = sorted(tr["kernels"].items(), key=lambda kv: -kv[1])[:8]
            print(f"    traced forward + backward: busy {tr['busy_ms']:.3f} ms of {tr['window_ms']:.3f}, "
                  f"idle share {tr['idle_share']:.3f}; largest kernels (ms):")
            for name, ms in top:
                print(f"      {ms:9.3f}  {name[:110]}")
        del x0

    # The card's kernel-path gradient against the port's CPU gradient.
    img = np.random.default_rng(20).uniform(0, 1, (1, 3, 540, 960)).astype(np.float32)
    g_card = grad(lambda x, impl: ft.upscale(x, preset="performance", impl=impl), torch.from_numpy(img).to(dev),
                  False, "kernel").cpu()
    g_cpu = grad(lambda x, impl: ft.upscale(x, preset="performance", impl=impl), torch.from_numpy(img), False,
                 "torch")
    d, scale = (g_card - g_cpu).abs().max().item(), g_cpu.abs().max().item()
    print(f"  540p->1080p performance f32: card (K1 + twin) vs CPU (torch path) gradient max-abs {d:.3e}, "
          f"{d / scale:.3e} of max|g| {scale:.3e} (limit {GRAD_REL:g})")
    if not torch.isfinite(g_card).all() or d > GRAD_REL * scale:
        raise AssertionError("the card's gradient disagrees with the CPU's")

    # examples_torch/train_through_fsr.py's inverse problem at 1080p -> 4K.
    hi = torch.from_numpy(trainer.make_scene(np.random.default_rng(0), (2160, 3840))).to(dev)
    prob = trainer.Inverse(hi, lr=3e-3)
    mse = [prob.loss()]
    for step in range(3):
        reset()
        t0 = time.perf_counter()
        loss = prob.step()  # a 0-d tensor on the card: the step does not wait for it
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = counts()
        # The step's own forward is the same K1 call on the same render.
        if loss.item() != mse[-1] or n != {k: int(k == "K1") for k in wrappers}:
            raise AssertionError(f"training step {step}: MSE {loss.item()} (before it {mse[-1]}), launches {n}")
        mse.append(prob.loss())
        print(f"  training step {step}: displayed MSE {loss.item():.6e} -> {mse[-1]:.6e}, {ms:.1f} ms "
              f"(host clock, one K1 launch), {card}")
    print(f"  displayed MSE after 3 steps: {mse[-1] / mse[0]:.4f} of the box-downsample baseline's")
    if not mse[-1] < mse[0]:
        raise AssertionError(f"the displayed MSE did not fall over the 3 steps: {mse}")
    del prob, hi
    _captured_training(dev, card)


class _OpCount:
    """Counts the aten operations dispatched from the host while it is
    entered (a TorchDispatchMode); a graph's replay dispatches none."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self
        self.n = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                outer.n += 1
                return func(*args, **(kwargs or {}))

        self.mode = Mode

    def __enter__(self):
        self._active = self.mode()
        self._active.__enter__()
        return self

    def __exit__(self, *exc):
        return self._active.__exit__(*exc)


def _steps(prob, step, n: int, ops: _OpCount) -> list:
    """``n`` calls of ``step`` (``ops`` entered around each): each step's
    loss and, after it, clones of ``prob``'s parameters."""
    out = []
    for _ in range(n):
        with ops:
            loss = step()
        out.append((loss.clone(), [p.detach().clone() for p in prob.params]))
    torch.cuda.synchronize()
    return out


def _differ(a: list, b: list) -> list:
    """The steps (index, what) at which two runs of ``_steps`` differ in a
    bit of the loss or a parameter."""
    return [(i, "loss" if not torch.equal(la, lb) else "parameters") for i, ((la, pa), (lb, pb)) in
            enumerate(zip(a, b)) if not (torch.equal(la, lb) and all(map(torch.equal, pa, pb)))]


def _captured_training(dev, card: str) -> None:
    """Phase 20 (v)-(vii): examples_torch/train_through_fsr.py's steps,
    each captured as one CUDA graph (``capture.CapturedStep``: forward K1,
    the twin's backward, Adam, the inverse problem's clamp) against the
    eager step function from the same start: (v) the inverse problem and
    (vi) the prefilter at the example's default --size 96, 20 steps each,
    ms per step in turn (wall, 50 steps per sample after a sync), a trace
    of one eager step and one replay, and a non-capturable Adam's
    parameters beside the capturable one's (the update of the eager
    trainer before the capture); (vii) the inverse problem at
    1080p -> 4K, 3 replays against 3 eager steps, ms per step in turn and
    the memory each holds."""
    from examples_torch import train_through_fsr as trainer
    from fsr_tpu_torch.utils import capture
    from fsr_tpu_torch.utils.profiling import device_trace

    def problems(make):
        """An eager problem, a second one, and a captured one, all from the
        same start; the capture's launches (warm-up and capture)."""
        eager, again, cap = make(), make(), make()
        step, built = _drive(lambda: capture.CapturedStep(cap.step, cap.params, cap.opt),
                             {"K1": capture.WARMUP + 1})
        return eager, again, cap, step, built

    def k1(tr):
        return round(sum(n for name, n in tr["launches"].items() if "fused_kernel" in name), 6)

    size, n = 96, 20
    rng = np.random.default_rng(0)
    hi = torch.from_numpy(trainer.make_scene(rng, (2 * size, 4 * size))).to(dev)
    lo_p, hi_p = (torch.from_numpy(a).to(dev) for a in trainer.prefilter_scenes(np.random.default_rng(0), size))
    cases = [("(v) inverse", lambda: trainer.Inverse(hi, 3e-3)),
             ("(vi) prefilter", lambda: trainer.Prefilter(lo_p, hi_p, 1e-3))]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the prefilter's conv backward
    try:
        for what, make in cases:
            eager, again, cap, step, built = problems(make)
            ops_e, ops_a, ops_c = _OpCount(), _OpCount(), _OpCount()
            runs = {}
            for key, prob, fn, ops, need in (("eager", eager, eager.step, ops_e, {"K1": n}),
                                             ("again", again, again.step, ops_a, {"K1": n}),
                                             ("replay", cap, step, ops_c, {})):
                runs[key], _ = _drive(lambda: _steps(prob, fn, n, ops), need)
            repeatable = not _differ(runs["eager"], runs["again"])
            off = _differ(runs["eager"], runs["replay"])
            if off and (repeatable or "inverse" in what):
                raise AssertionError(f"{what}: the replays differ from the eager steps at {off[:4]} (the eager "
                                     f"step {'is' if repeatable else 'is not'} repeatable)")
            if off:
                # cuDNN's conv backward is not repeatable here: the
                # parameters after the 20 steps within PREFILTER_REL.
                rel = max(((pc - pe).abs().max() / pe.abs().max()).item()
                          for pe, pc in zip(runs["eager"][-1][1], runs["replay"][-1][1]))
                if not rel <= PREFILTER_REL:
                    raise AssertionError(f"{what}: parameters {rel:.3e} apart after {n} steps "
                                         f"(limit {PREFILTER_REL:g})")
                held = f"within {rel:.3e} of the eager parameters (limit {PREFILTER_REL:g}; eager not repeatable)"
            else:
                held = "bit-equal to the eager steps, losses and parameters step by step"
            if ops_c.n:
                raise AssertionError(f"{what}: {ops_c.n} aten operations dispatched by {n} replays")
            # What capturable Adam changes: the same steps with the update of
            # a non-capturable Adam (bias corrections in host doubles), the
            # parent commit's eager trainer's.
            host = make()
            for g in host.opt.param_groups:
                g["capturable"] = False
            ran = _steps(host, host.step, n, _OpCount())
            drift = [max(((ph - pe).abs().max() / pe.abs().max()).item()
                         for ph, pe in zip(ran[i][1], runs["eager"][i][1])) for i in (0, n - 1)]
            wall = _wall_ms_in_turn({"eager": eager.step, "replay": step}, n=1, rounds=3, queue=50)
            # (a trace short of K1 is taken again: CUPTI once delivered a
            # replay's other operations but not its K1)
            tr_e = device_trace(eager.step, 1, short=lambda tr: k1(tr) < 1)
            tr_c = device_trace(step, 1, short=lambda tr: k1(tr) < 1)
            if k1(tr_e) != 1 or k1(tr_c) != 1:
                raise AssertionError(f"{what}: K1 {k1(tr_e)} times in a traced eager step ({tr_e['ops_per_call']:g} "
                                     f"device operations, {tr_e['attempts']} trace(s)), {k1(tr_c)} in a replay "
                                     f"({tr_c['ops_per_call']:g} device operations, {tr_c['attempts']} trace(s))")
            print(f"  {what} at --size {size}: captured with launches {built} (warm-up and capture); {n} replays "
                  f"{held}; the first replay's loss {runs['replay'][0][0].item():.6e} (eager "
                  f"{runs['eager'][0][0].item():.6e}); eager step repeatable: {repeatable}; aten operations "
                  f"dispatched per step: eager {ops_e.n / n:g}, replay {ops_c.n / n:g}; a non-capturable Adam's "
                  f"parameters from the capturable one's after step 1 {drift[0]:.3e}, after step {n} {drift[1]:.3e} "
                  f"(of their largest); {card}")
            print(f"    ms per step in turn (wall, 50 steps per sample after a sync): eager {wall['eager']:.4f}, "
                  f"replay {wall['replay']:.4f} ({wall['eager'] / wall['replay']:.2f}x); traced eager step: "
                  f"busy {tr_e['busy_ms']:.4f} ms of {tr_e['window_ms']:.4f}, idle share {tr_e['idle_share']:.4f}, "
                  f"{tr_e['ops_per_call']:g} device operations, K1 x{k1(tr_e):g} ({tr_e['attempts']} trace(s)); "
                  f"traced replay: busy {tr_c['busy_ms']:.4f} ms of {tr_c['window_ms']:.4f}, idle share "
                  f"{tr_c['idle_share']:.4f}, {tr_c['ops_per_call']:g} device operations, K1 x{k1(tr_c):g} "
                  f"({tr_c['attempts']} trace(s)); {card}")
            del eager, again, cap, step, runs
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # (vii) The inverse problem at 1080p -> 4K: 3 replays against 3 eager
    # steps, then each in turn; the eager step's peak, and what the graph
    # holds between replays (its pool, the Adam state).
    hi = torch.from_numpy(trainer.make_scene(np.random.default_rng(0), (2160, 3840))).to(dev)
    eager = trainer.Inverse(hi, 3e-3)
    ops = _OpCount()
    peak = _peak_bytes(lambda: _steps(eager, eager.step, 1, ops), dev)
    eager = trainer.Inverse(hi, 3e-3)
    cap = trainer.Inverse(hi, 3e-3)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(dev)
    step, built = _drive(lambda: capture.CapturedStep(cap.step, cap.params, cap.opt), {"K1": capture.WARMUP + 1})
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(dev) - before
    runs = {"eager": _drive(lambda: _steps(eager, eager.step, 3, ops), {"K1": 3})[0],
            "replay": _drive(lambda: _steps(cap, step, 3, ops), {})[0]}
    off = _differ(runs["eager"], runs["replay"])
    if off:
        raise AssertionError(f"(vii) the 4K replays differ from the eager steps at {off}")
    wall = _wall_ms_in_turn({"eager": eager.step, "replay": step}, n=2, rounds=2)
    print(f"  (vii) inverse 1080p -> 4K: captured with launches {built}; 3 replays bit-equal to 3 eager steps "
          f"(losses {[f'{l.item():.6e}' for l, _ in runs['replay']]}); ms per step in turn (wall, one step per "
          f"sample after a sync): eager {wall['eager']:.3f}, replay {wall['replay']:.3f} "
          f"({wall['replay'] / wall['eager'] - 1:+.2%}); the eager step's peak {peak / 2**30:.2f} GiB above what "
          f"it held before; the captured step holds {held / 2**30:.2f} GiB between replays (reserved: its pool "
          f"and Adam state); {card}")


def _app_layer(dev, card: str) -> None:
    """Phase 21: the application layer on the card, from seeded numpy data
    written to a temporary directory: the CLI (Performance with its
    benchmark, Quality bf16, the pipeline flags), the sample app's
    flythrough and HDR chain at 4K, the video, dataset and frame-graph
    examples, the quality study against its CPU run, and the native host
    layer against the numpy constants.  Each path's launches are counted
    (exactly its K1 or K2 launches, no K4) and its output held against the
    same call on the kernels' plain versions or the library call."""
    import io
    import os
    import tempfile

    import fsr_tpu_torch as ft
    from examples_torch import dataset_preprocessing, frame_graph, sample_app, video_upscale
    from fsr_tpu_torch import cli
    from fsr_tpu_torch.core import native
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels.epilogue import Epilogue
    from fsr_tpu_torch.parallel import sharding
    from fsr_tpu_torch.utils import capture
    from fsr_tpu_torch.utils import image as im
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, device_trace
    from tools_torch import quality_study

    print(f"phase 21: the application layer on the card ({card})")
    rng = np.random.default_rng(21)
    out4k = (2160, 3840)
    parts = []  # (part, start time): the seconds each part takes

    def part(name):
        parts.append((name, time.perf_counter()))

    def run_cli(argv, need):
        """cli.main under _drive, its stderr echoed; returns the stderr."""
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf):
            rc, got = _drive(lambda: cli.main(argv), need)
        text = buf.getvalue()
        for line in text.splitlines():
            print(f"    cli: {line}")
        if rc != 0:
            raise AssertionError(f"cli.main({argv}) returned {rc}")
        print(f"    launches {got}")
        return text

    def table(kernels, what):
        print(f"  {what}: device ms per call by kernel ({card}):")
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {ms:9.4f}  {name[:100]}")
        print(f"    {sum(kernels.values()):9.4f}  total, {len(kernels)} kernels")
        return sum(kernels.values())

    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        im.save_image(path("in1080.png"), rng.uniform(0, 1, (3, 1080, 1920)).astype(np.float32))
        im.save_image(path("in1440.png"), rng.uniform(0, 1, (3, 1440, 2560)).astype(np.float32))

        def cli_input(name):
            return torch.from_numpy(np.ascontiguousarray(im.load_image(path(name)))).to(dev)

        def png_codes(name):
            return im.to_uint8(im.load_image(path(name)))

        part("(i)")
        # (i) Performance, with the CLI's benchmark: one K1 per run() (the
        # output, the device reading's warm-up and queued calls, the wall
        # clock's calls), no K4.
        n = 5
        runs = 1 + cli.BENCH_WARMUP + n * cli.BENCH_QUEUE + n
        text = run_cli([path("in1080.png"), path("perf.png"), "--preset", "performance", "--benchmark", str(n),
                        "--results", path("perf.csv")], {"K1": runs})
        cli_ms = float(re.search(r"device ([0-9.]+) ms/frame", text).group(1))
        rows = open(path("perf.csv")).read().split()
        if rows[0] != "frame,ms" or len(rows) != n + 1:
            raise AssertionError(f"(i) the benchmark CSV: {rows}")
        x = cli_input("in1080.png")
        lib = ft.upscale(x, preset="performance")
        want = im.to_uint8(lib.cpu().numpy())
        got = png_codes("perf.png")
        print(f"  (i) cli --preset performance 1080p -> 4K f32: {runs} runs, {runs} K1 launches, no K4; PNG codes "
              f"{'equal' if np.array_equal(got, want) else 'DIFFER'} to upscale(x, preset='performance')'s")
        if got.shape != (3, *out4k) or not np.array_equal(got, want):
            raise AssertionError("(i) the CLI's output is not the library call's")
        lib_ms = cuda_time_ms(lambda: ft.upscale(x, preset="performance"), **KQ)
        print(f"  (i) device ms per frame: the CLI's {cli_ms:.4f}, the library call's {lib_ms:.4f} "
              f"(10 calls queued per sample), {card}")
        del x, lib

        part("(ii)")
        # (ii) Quality, bfloat16 storage: one K2.
        run_cli([path("in1440.png"), path("quality.png"), "--preset", "quality", "--dtype", "bfloat16"], {"K2": 1})
        x = cli_input("in1440.png")
        want = im.to_uint8(ft.upscale(x, preset="quality", compute_dtype=torch.bfloat16).float().cpu().numpy())
        got = png_codes("quality.png")
        print(f"  (ii) cli --preset quality --dtype bfloat16 1440p -> 4K: PNG codes "
              f"{'equal' if np.array_equal(got, want) else 'DIFFER'} to the library call's")
        if got.shape != (3, *out4k) or not np.array_equal(got, want):
            raise AssertionError("(ii) the CLI's output is not the library call's")
        del x

        part("(iii)")
        # (iii) The pipeline flags, against the same CLI call on the plain
        # kernels by phase 12's limits.  The reference's pipeline refuses
        # TEPD on HDR output (--hdr --dither-bits), and so does the port's:
        # the HDR tail and the dithered output are two calls.
        cases = [("hdr", ["--hdr", "--grain", "0.2"], Epilogue(transform="srtm_inv", grain_amount=0.2)),
                 ("dither10", ["--gamma2-out", "--grain", "0.2", "--dither-bits", "10"],
                  Epilogue(transform="gamma2", grain_amount=0.2, dither_bits=10))]
        for name, flags, epi in cases:
            argv = ["--preset", "performance", *flags, "--frame", "3"]
            run_cli([path("in1080.png"), path(f"{name}.npy"), *argv], {"K1": 1})
            with _plain_kernels():
                run_cli([path("in1080.png"), path(f"{name}_plain.npy"), *argv], {})
            got, want = (torch.from_numpy(np.load(path(f))) for f in (f"{name}.npy", f"{name}_plain.npy"))
            _compare_epilogue(got, want, epi, f"(iii) cli {' '.join(flags)} --frame 3 vs the plain kernels")
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                cli.main([path("in1080.png"), path("bad.npy"), "--hdr", "--dither-bits", "10"])
        except ValueError as e:
            print(f"  (iii) --hdr --dither-bits 10 refused, as by the reference: {e}")
        else:
            raise AssertionError("(iii) --hdr --dither-bits 10 ran; the reference refuses it")

        part("(iv)")
        # (iv) The sample app at 4K, Quality (render 2560x1440, K2): a
        # 5-frame flythrough with its CSV and two screenshots, one K2 per
        # frame; a frame against the plain kernels and its kernel table; the
        # HDR chain against the plain kernels.
        over = {"globals": {"width": out4k[1], "height": out4k[0], "preset": "quality"},
                "scenes": [{"BenchmarkSettings": {"fps": 2, "warmUpFrames": 1, "resultsFilename": path("bench.csv"),
                                                  "screenShotName": path("shot")}}]}
        cfg = sample_app.merge_config(sample_app.DEFAULT_CONFIG, over)
        bench = cfg["scenes"][0]["BenchmarkSettings"]
        # Built on the card, the app captures its frame: the warm-up's and
        # the capture's launches are counted, a replay's are not.
        app, got = _drive(lambda: sample_app.SampleApp(cfg), {"K2": capture.WARMUP + 1})
        if app.render_hw != (1440, 2560) or app.device.type != "cuda":
            raise AssertionError(f"(iv) render {app.render_hw} on {app.device}")
        print(f"  (iv) sample app built, its frame captured: launches {got}")
        rows, got = _drive(lambda: sample_app.run_benchmark(app, bench), {})
        shots = [r["screenshot"] for r in rows if "screenshot" in r]
        if len(rows) != 5 or shots != ["shot_0.png", "shot_1.png"] or not all(
                os.path.exists(path(s)) for s in shots) or len(open(path("bench.csv")).read().split()) != 6:
            raise AssertionError(f"(iv) the flythrough: {rows}")
        print(f"  (iv) sample app, quality 2560x1440 -> 3840x2160: {len(rows)} frames + 1 warm-up, replays, "
              f"launches counted {got}; "
              f"wall ms per frame (host clock, synchronised) {[r['ms'] for r in rows]}, median "
              f"{statistics.median(r['ms'] for r in rows):.3f}, {card}")
        cam = sample_app.camera_at(bench["keyFrames"], 1.0)
        for hdr in (False, True):
            if hdr:
                app = sample_app.SampleApp(sample_app.merge_config(cfg, {"globals": {"hdr": True}}))
            out, _ = _drive(lambda: app.render_frame(cam, 1.0, 3), {})
            with _plain_kernels():
                want = app.frame_tail(*(x.to(dev) for x in app.frame_inputs(cam, 3)))
            what = "HDR chain (TEPD10 tonemap, gamma2 out)" if hdr else "frame"
            _compare(out, want, f"(iv) sample app {what} vs the plain kernels")
            if out.shape != (3, *out4k) or (hdr and not 0.0 <= out.min().item() <= out.max().item() <= 1.0):
                raise AssertionError(f"(iv) {what}: {tuple(out.shape)}, range {out.min().item()}..{out.max().item()}")
            if not hdr:
                # app.profile's trace, read in full: its kernel table, the
                # device operations per frame and the device's idle share.
                tr = device_trace(lambda: app.render_frame(cam, 0.0, 3))
                kernels = tr["kernels"]
                if set(app.profile(cam, 3)) != set(kernels):
                    raise AssertionError("(iv) app.profile's kernels are not the trace's")
                total = table(kernels, f"(iv) sample app {what}, traced (5 frames)")
                k2 = sum(ms for name, ms in kernels.items() if "gather_kernel" in name)
                print(f"  (iv) K2 {k2:.4f} of the frame's {total:.4f} device ms ({k2 / total:.1%}); the scene "
                      f"stand-in and the tonemap (torch ops) the rest")
                print(f"  (iv) traced frame: {tr['ops_per_call']:g} device operations per frame, window "
                      f"{tr['window_ms'] / 5:.4f} ms per frame (host clock), busy {tr['busy_ms'] / 5:.4f}, "
                      f"idle share {tr['idle_share']:.4f}, {card}")
        del app, out, want

        part("(v)")
        # (v) Video: 16 frames 1080p -> 4K in batches of 8, one K1 per batch.
        clip = video_upscale.synthetic_clip(16, (1080, 1920))
        up = video_upscale.VideoUpscaler(out4k, dev)
        up.run(clip[:8], 8)  # warm-up at the timed batch, the copy back included
        t0 = time.perf_counter()
        video, got = _drive(lambda: up.run(clip, 8), {"K1": 2})
        dt = time.perf_counter() - t0
        with _plain_kernels():
            want = up.process(torch.from_numpy(clip[:8]).to(dev), 0)
        _compare_steps(torch.from_numpy(video[:8]).to(dev), want, 8,
                       "(v) video's first batch (8 frames) vs the plain kernels")
        if video.shape != (16, 3, *out4k) or not np.isfinite(video).all():
            raise AssertionError(f"(v) video {video.shape}")
        print(f"  (v) video 16 frames 1080p -> 4K, batches of 8: launches {got}, {dt:.3f} s, {16 / dt:.1f} frames/s "
              f"(host clock, the clip's copies both ways included), {card}")
        del clip, video, want

        part("(vi)")
        # (vi) Dataset: batches of 4 u8 frames per card, 1080p -> 4K u8 with
        # TEPD, on make_mesh(): one K1 per card per batch.
        n_cards = torch.cuda.device_count()
        dataset_preprocessing.run(1, 4, (1080, 1920), out4k)  # warm-up at the timed batch
        # Each run captures one graph per card before its clock starts (the
        # counted launches) and replays it per batch (none counted).
        (outs, dt, n_dev), got = _drive(lambda: dataset_preprocessing.run(4, 4, (1080, 1920), out4k),
                                        {"K1": (capture.WARMUP + 1) * n_cards})
        mesh = sharding.make_mesh()
        batch0 = torch.from_numpy(next(dataset_preprocessing.synthetic_corpus(1, 4 * n_dev, (1080, 1920))))
        with _plain_kernels():
            want = dataset_preprocessing.preprocess(batch0, 0, out4k, mesh)
        _on_mesh(outs[0], "(vi) dataset batch 0")
        _compare_steps(outs[0].gather(), want.gather(), 8, "(vi) dataset batch 0 vs the plain kernels")
        total = sum(o.shape[0] for o in outs)
        print(f"  (vi) dataset {total} u8 frames 1080p -> 4K u8 on {n_dev} card(s), each batch's output sharded on "
              f"the cards: launches {got}, {dt:.3f} s, {total / dt:.1f} frames/s (host clock, the transfer to "
              f"the cards and the corpus's generation included), {card}")
        del outs, want, batch0

        part("(vii)")
        # (vii) The frame graph at 1080p -> 4K: one K1; its kernel table.
        scene = torch.from_numpy(frame_graph.render_scene((1080, 1920), 7)).to(dev)
        out, got = _drive(lambda: frame_graph.frame_tail(scene, out4k), {"K1": 1})
        with _plain_kernels():
            want = frame_graph.frame_tail(scene, out4k)
        _compare(out, want, "(vii) frame graph tail vs the plain kernels")
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = frame_graph.main(["--render", "1080", "1920", "--display", *map(str, out4k), "--out-dir", tmp])
        print("\n".join(f"    frame_graph: {line}" for line in buf.getvalue().splitlines()))
        if rc != 0 or not os.path.exists(path("frame_graph_display.png")):
            raise AssertionError(f"(vii) frame_graph.main returned {rc}")
        del scene, out, want

        part("(viii)")
        # (viii) The quality study: on the card (2x at 512x512: K1) within
        # 0.01 dB of the same study on the CPU.
        card_rows, got = _drive(lambda: quality_study.study(dev), {"K1": 6})
        cpu_rows = quality_study.study(torch.device("cpu"))
        worst = max(abs(a - b) for r, c in zip(card_rows, cpu_rows) for a, b in zip(r[1:], c[1:]))
        for r, c in zip(card_rows, cpu_rows):
            print(f"  (viii) {r[0]:10s} bilinear / EASU / EASU+RCAS dB: card {r[1]:.4f} / {r[2]:.4f} / {r[3]:.4f}, "
                  f"CPU {c[1]:.4f} / {c[2]:.4f} / {c[3]:.4f}")
        print(f"  (viii) launches {got}; largest difference {worst:.2e} dB (limit 0.01)")
        if worst > 0.01:
            raise AssertionError("(viii) the card's quality study disagrees with the CPU's")

    part("(ix)")
    # (ix) The native host layer, built with cc, bit-equal to the numpy
    # constants (tests/test_native.py's configurations).
    if native.load() is None:
        raise AssertionError("(ix) the native host layer did not build: no cc")
    configs = [(960, 540, 960, 540, 1920, 1080), (1920, 1080, 1920, 1080, 3840, 2160),
               (2954, 1662, 2954, 1662, 3840, 2160), (1280, 720, 1920, 1080, 2560, 1440)]
    for vw, vh, iw, ih, ow, oh in configs:
        if not np.array_equal(native.easu_con((vw, vh), (iw, ih), (ow, oh)),
                              EasuConstants.create((vw, vh), (iw, ih), (ow, oh)).as_uint4()):
            raise AssertionError(f"(ix) native easu_con differs at {(vw, vh, iw, ih, ow, oh)}")
    if not np.array_equal(native.easu_con((1280, 720), (1920, 1080), (2560, 1440), (64.0, 32.0)),
                          EasuConstants.create((1280, 720), (1920, 1080), (2560, 1440), (64, 32)).as_uint4()):
        raise AssertionError("(ix) native easu_con with an offset differs")
    for s in (0.0, 0.125, 0.25, 0.5, 1.0, 2.0):
        if not np.array_equal(native.rcas_con(s), RcasConstants(s).as_uint4()):
            raise AssertionError(f"(ix) native rcas_con differs at {s}")
    print(f"  (ix) native host layer {native.library_path().parent.name}: the {len(configs)} configurations, "
          "the offset and 6 sharpness values bit-equal to the numpy constants")
    part("end")
    print("  phase 21 seconds per part: " + ", ".join(
        f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(parts, parts[1:])))


def _tools(dev, card: str) -> None:
    """Phase 22: the measurement tools of tools_torch on the card (their
    full sweeps run from the tools themselves): the headline probe and the
    preset bench on the production library, the byte-output routes, and
    one K1 and one K2 knockout built in parallel, each checked by its mask
    and held different from production's output."""
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels import _build, easu_gather, fused
    from tools_torch import preset_bench
    from tools_torch.ablation import fused_stage_ablation, gather_ablation, headline_probe, kernel_ab
    from tools_torch.ablation import u8_writeback_ab

    print(f"phase 22: the measurement tools on the card ({card})")
    print("  headline_probe: " + headline_probe.line(headline_probe.headline_ms(dev)) + f", {card}")
    for name, ms, mpix, d in preset_bench.bench(dev):
        print(f"  preset_bench: {name} {ms:.4f} ms per 4K frame, {mpix:.0f} Mpix/s, one K2 and no K1, "
              f"maxdev_f32 {d:.3e} (limit {preset_bench.MAXDEV_F32:g}), {card}")
        if not d <= preset_bench.MAXDEV_F32:
            raise AssertionError(f"preset_bench {name}: the f32 kernel path {d:.3e} from the torch path")
    times, codes = u8_writeback_ab.measure(dev)
    print(f"  u8_writeback_ab, ms per 4K frame (byte floor), in turn, {card}: "
          + ", ".join(f"{k} {ms:.4f} ({floor:.4f})" for k, (ms, floor) in times.items()))
    print(f"  u8_writeback_ab: bf16+encode vs direct_u8 max code dev {codes} (limit 1)")
    if codes > 1:
        raise AssertionError(f"bf16_out+encode is {codes} codes from direct_u8")

    # Knockouts: wrong output by design; the production library holds none.
    macros = ("FSR_ABL_K1_POLY", "FSR_ABL_K2_NOG")
    libs, secs = fused_stage_ablation.build(macros)
    rcon = RcasConstants(0.25)
    x1 = torch.from_numpy(np.random.default_rng(22).uniform(0, 1, (3, 1080, 1920)).astype(np.float32)).to(dev)
    con1 = EasuConstants.create((1920, 1080), None, (3840, 2160))
    x2 = gather_ablation.frames("1.7", dev, 1)
    con2 = EasuConstants.create(gather_ablation.SIZES["1.7"], None, (3840, 2160))
    calls = {"FSR_ABL_K1_POLY": lambda: fused.upscale_fused(x1, (2160, 3840), con1, rcon, True, False, torch.bfloat16),
             "FSR_ABL_K2_NOG": lambda: easu_gather.easu_gather(x2, (2160, 3840), con2, rcon, True, False,
                                                                torch.bfloat16)}
    for m in macros:
        want = calls[m]()
        got = kernel_ab.on(libs[m], calls[m])()
        d = (got.float() - want.float()).abs().max().item()
        print(f"  knockout {m}: built in {secs[m]:.1f} s (in parallel with the other), fsr_ablation_mask() "
              f"{sorted(_build.ablation_mask(libs[m]))}, output max-abs {d:.3e} from production's")
        if not d > 0.0:
            raise AssertionError(f"the knockout {m} left the output as it was")


def _wall_ms_in_turn(fns: dict, n: int = 20, rounds: int = 3, queue: int = 1, sync=None) -> dict:
    """Wall-clock ms per call of each function of ``fns`` (host clock around
    ``queue`` calls and a synchronise, ``sync`` or the current card's,
    divided by ``queue``), ``n`` samples per turn, the functions taken in
    turn ``rounds`` times; the median per function."""
    sync = sync or torch.cuda.synchronize
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    sync()
    for _ in range(rounds):
        for k, fn in fns.items():
            for _ in range(n):
                t0 = time.perf_counter()
                for _ in range(queue):
                    fn()
                sync()
                times[k].append((time.perf_counter() - t0) * 1e3 / queue)
    return {k: statistics.median(v) for k, v in times.items()}


def _captured_frames(dev, card: str) -> None:
    """Phase 23: the frame index as a device operand, and frames captured as
    CUDA graphs (fsr_tpu_torch/utils/capture.py), each replay held bit-equal
    to the eager call on the same inputs; a replay's launches from a trace;
    eager against replay in turn."""
    import fsr_tpu_torch as ft
    from examples_torch import dataset_preprocessing, frame_graph, sample_app
    from fsr_tpu_torch.core import tonemap as tm
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels import easu_gather, fused
    from fsr_tpu_torch.kernels.epilogue import Epilogue
    from fsr_tpu_torch.ops import extras
    from fsr_tpu_torch.parallel import sharding
    from fsr_tpu_torch.utils import capture, noise
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn, device_trace

    print(f"phase 23: captured frames ({card})")
    out4k = (2160, 3840)
    frames = (0, 7, 2**31 - 1, -1)

    def same(got, want, what):
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or got.device != want.device:
            raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} {got.device} vs "
                                 f"{tuple(want.shape)} {want.dtype} {want.device}")
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: {int((got != want).sum())} of {got.numel()} values differ")

    def on_card(f):
        return torch.tensor(f, dtype=torch.int32, device=dev)

    # (i) The frame as a device operand against the host int.
    gen = torch.Generator(device=dev).manual_seed(23)
    x1 = torch.rand((2, 3, 540, 960), generator=gen, device=dev)
    x2 = torch.rand((2, 3, 720, 1280), generator=gen, device=dev)
    out_hw = (1080, 1920)
    rcon = RcasConstants(0.25)
    calls = {"K1": (fused.upscale_fused, fused.upscale_fused_reference, x1),
             "K2": (easu_gather.easu_gather, easu_gather.easu_gather_reference, x2)}
    checked = 0
    for name, (kernel, plain, x) in calls.items():
        con = EasuConstants.create((x.shape[-1], x.shape[-2]), None, (out_hw[1], out_hw[0]))
        for bits, out_dt in ((8, torch.uint8), (10, torch.float32)):
            kw = dict(epilogue=Epilogue(dither_bits=bits), out_dtype=out_dt)
            for f in frames:
                for which, fn in (("kernel", kernel), ("plain version", plain)):
                    got = fn(x, out_hw, con, rcon, True, False, torch.float32, frame=on_card(f), **kw)
                    same(got, fn(x, out_hw, con, rcon, True, False, torch.float32, frame=f, **kw),
                         f"(i) {name} {which} dither{bits} frame {f}")
                    checked += 1
    tex = torch.from_numpy(noise.temporal_blue_noise(4, (32, 32), seed=0)).to(dev)
    pipes = {"K1 fused page, u8": (ft.UpscalePipeline(out_hw, dither_bits=8, dither_texture=tex,
                                                       out_dtype=torch.uint8), x1),
             "K2 bf16, page after-pass": (ft.UpscalePipeline(out_hw, dither_bits=10, dither_texture=tex,
                                                              compute_dtype=torch.bfloat16), x2)}
    pipes["K2 bf16, hash after-pass"] = (ft.UpscalePipeline(out_hw, dither_bits=10, compute_dtype=torch.bfloat16),
                                         x2)
    hdr = x2[0] * 8
    others = {"upscale (K1, 10-bit hash)": lambda f: ft.upscale(x1, out_size=out_hw, frame=f,
                                                                epilogue=Epilogue(dither_bits=10)),
              "tonemap_pass": lambda f: tm.tonemap_pass(hdr, 0.85, "amd", hdr10_dither_frame=f),
              "tepd_dither": lambda f: extras.tepd_dither(out_hw, f, origin=(5, 0), device=dev),
              "texture_dither": lambda f: extras.texture_dither(out_hw, f, tex, origin=(5, 0))}
    for name, (pipe, x) in pipes.items():
        others[f"pipeline {name}"] = lambda f, pipe=pipe, x=x: pipe(x, frame=f)
    for name, fn in others.items():
        for f in frames:
            same(fn(on_card(f)), fn(f), f"(i) {name} frame {f}")
            checked += 1
    print(f"  (i) {checked} calls with the frame on the card bit-equal to the same call with a host int: K1 and "
          f"K2 (kernel and plain version, 8- and 10-bit hash dither), upscale, tonemap_pass, tepd_dither, "
          f"texture_dither, the pipeline with a blue-noise page (fused into K1; K2's bf16 after-pass) and with "
          f"the hash after-pass; frames {frames}")
    del x1, x2

    # (ii)-(iv) The sample app at 4K in every mode: built (captured), then 8
    # replays with 8 cameras and frame indices, each bit-equal to the eager
    # frame on the same inputs.
    base = {"globals": {"width": out4k[1], "height": out4k[0], "preset": "quality"}}
    modes = [("fsr quality", {}, {"K2": 1}), ("fsr quality hdr", {"hdr": True}, {"K2": 1}),
             ("fsr performance", {"preset": "performance"}, {"K1": 1}),
             ("bilinear", {"mode": "bilinear"}, {}), ("bilinear hdr", {"mode": "bilinear", "hdr": True}, {}),
             ("native", {"mode": "native"}, {}), ("native hdr", {"mode": "native", "hdr": True}, {})]
    kfs = sample_app.DEFAULT_CONFIG["scenes"][0]["BenchmarkSettings"]["keyFrames"]
    shots = [(sample_app.camera_at(kfs, 2.0 * k / 7), f) for k, f in enumerate((3, 11, 0, 7, 42, 1000, 2**31 - 1, -1))]
    kinds = {"K1": "fused_kernel", "K2": "gather_kernel", "K4": "edge_pad_kernel"}
    timed = {}
    for name, over, need in modes:
        cfg = sample_app.merge_config(sample_app.DEFAULT_CONFIG, sample_app.merge_config(base, {"globals": over}))
        app, got = _drive(lambda: sample_app.SampleApp(cfg), {k: capture.WARMUP + 1 for k in need})
        outs = []
        for cam, f in shots:
            rep, counted = _drive(lambda: app.render_frame(cam, 0.0, f).clone(), {})
            eager = app.frame_tail(*(t.to(dev) for t in app.frame_inputs(cam, f)))
            same(rep, eager, f"(ii) sample app {name}: the replay at frame {f}")
            outs.append(rep)
        if any(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"(ii) sample app {name}: two replays with other inputs gave one frame")
        cam, f = shots[3]
        tr = device_trace(lambda: app.render_frame(cam, 0.0, f), 1)
        counts = {k: round(sum(n for kname, n in tr["launches"].items() if kind in kname), 6)
                  for k, kind in kinds.items()}
        if counts != {k: need.get(k, 0) for k in kinds}:
            raise AssertionError(f"(iii) sample app {name}: a traced replay launched {counts}, not {need}")
        print(f"  (ii) sample app {name} {app.render_hw} -> {out4k}: built with launches {got} (warm-up and "
              f"capture); 8 replays bit-equal to the eager frame on their inputs, none counted; (iii) a traced "
              f"replay: {counts} ({tr['ops_per_call']:g} device operations); {card}")
        if name in ("fsr quality", "fsr performance"):
            timed[name] = app
        del app, outs, rep, eager

    # (iv) Eager against replay, in turn: device ms (10 frames queued) and
    # wall ms per frame (host clock, synchronised); each one's traced device
    # operations per frame and idle share.
    cam, f = shots[3]
    for name, app in timed.items():
        fns = {"eager": lambda: app.frame_tail(*(t.to(dev) for t in app.frame_inputs(cam, f))),
               "replay": lambda: app.render_frame(cam, 0.0, f)}
        dev_ms = cuda_times_in_turn(fns, **KQ)
        wall = _wall_ms_in_turn(fns)
        traces = {k: device_trace(fn, 5) for k, fn in fns.items()}
        for k in fns:
            tr = traces[k]
            print(f"  (iv) sample app {name}, {k}: {dev_ms[k]:.4f} device ms per frame (10 queued), "
                  f"{wall[k]:.4f} wall ms per frame (host clock, synchronised); traced {tr['ops_per_call']:g} "
                  f"device operations per frame, busy {tr['busy_ms'] / 5:.4f} ms, idle share "
                  f"{tr['idle_share']:.4f}; {card}")
    del timed

    # (v) frame_graph's tail and dataset_preprocessing's graphs against the
    # eager calls, over 4 frames or batches with distinct frame indices.
    scenes = [torch.from_numpy(frame_graph.render_scene((1080, 1920), k)).to(dev) for k in (0, 7, 12, 30)]
    run = capture.CapturedFrame(lambda hdr: frame_graph.frame_tail(hdr, out4k), scenes[0])
    for k, scene in enumerate(scenes):
        same(run(scene).clone(), frame_graph.frame_tail(scene, out4k), f"(v) frame_graph scene {k}")
    mesh = sharding.make_mesh()
    step = dataset_preprocessing.CapturedPreprocess(mesh, 4, (1080, 1920), out4k)
    corpus = dataset_preprocessing.synthetic_corpus(4, 4 * mesh.size, (1080, 1920))
    for f, batch in zip(frames, corpus):
        b = sharding.shard_batch(torch.from_numpy(batch), mesh)
        got, want = step(b, f), dataset_preprocessing.preprocess(b, f, out4k, mesh)
        _on_mesh(got, f"(v) dataset batch, frame {f}")
        for k, (g, w) in enumerate(zip(got.shards, want.shards)):
            same(g, w, f"(v) dataset batch, frame {f}, shard {k}")
    print(f"  (v) frame_graph 1080p -> 4K: 4 scenes, replays bit-equal to the eager tail; dataset_preprocessing "
          f"u8 1080p -> 4K on {mesh.size} card(s): 4 batches with frames {frames}, the replays' shards bit-equal "
          "to preprocess's, shard by shard")
    del run, scenes, step

    # (vi) upscale(preset="performance") at batch 1: one-call latency and 10
    # calls queued, eager against the captured call (its input copied in,
    # and on its static input).
    x = torch.rand((1, 3, 1080, 1920), generator=gen, device=dev)
    graph = capture.CapturedFrame(lambda a: ft.upscale(a, preset="performance"), x)
    same(graph(x).clone(), ft.upscale(x, preset="performance"), "(vi) the captured upscale")
    fns = {"eager": lambda: ft.upscale(x, preset="performance"), "replay": lambda: graph(x),
           "replay on its input": lambda: graph(graph.inputs[0])}
    one = cuda_times_in_turn(fns)
    queued = cuda_times_in_turn(fns, **KQ)
    wall = _wall_ms_in_turn(fns)
    for k in fns:
        print(f"  (vi) upscale(preset='performance') 1080p -> 4K f32, batch 1, {k}: one call {one[k]:.4f} ms, "
              f"10 queued {queued[k]:.4f} ms per call (CUDA events), wall {wall[k]:.4f} ms (host clock, "
              f"synchronised); {card}")
    del x, graph
    _captured_forms(dev, gen)


def _captured_forms(dev, gen) -> None:
    """Phase 23 (vii): the forms that make a frame capturable (constants
    filled on the card; the tap tables of the torch path and K2 from caches)
    each captured, its replay bit-equal to the eager call in float32 and
    bfloat16; then the table caches emptied, blocks of the tables' sizes
    allocated and filled with garbage (where the allocator would hand out
    the tables' memory had the graphs not kept it, ``capture.keep``), and
    every replay still bit-equal."""
    from fsr_tpu_torch.core import tonemap, transfer
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels import easu_gather
    from fsr_tpu_torch.ops import easu as easu_ops
    from fsr_tpu_torch.ops import extras
    from fsr_tpu_torch.utils import capture

    con = EasuConstants.create((480, 270), None, (720, 405))
    rcon = RcasConstants(0.25)
    dither = extras.tepd_dither((270, 480), 5, device=dev)
    cases = {
        "core/tonemap": (8.0, lambda a: torch.stack([tonemap.tonemap(a, 0.85, k) for k in range(5)])),
        "core/transfer": (1.0, lambda a: torch.stack([
            transfer.to_srgb(a), transfer.from_709(a), transfer.to_pq(a), transfer.from_pq(a),
            transfer.prx_med_linear_to_pq(a.float()).to(a.dtype)])),
        "core/easu_math (ops.easu)": (1.0, lambda a: easu_ops.easu(a, (405, 720), con, compute_dtype=a.dtype)),
        "ops/extras.tepd_quantize": (1.0, lambda a: extras.tepd_quantize(a.float(), dither, bits=10)),
        "ops/easu.bilinear": (1.0, lambda a: easu_ops.bilinear(a, (405, 720), con)),
        "K2 easu_gather": (1.0, lambda a: easu_gather.easu_gather(a, (405, 720), con, rcon, True, False, a.dtype)),
    }

    def bits(t):  # bit patterns, so that a NaN equals a NaN with the same bits
        return t.view(torch.int32 if t.element_size() == 4 else torch.int16)

    runs = []
    for name, (scale, fn) in cases.items():
        for dt in (torch.float32, torch.bfloat16):
            a = (torch.rand((3, 270, 480), generator=gen, device=dev) * scale).to(dt)
            run = capture.CapturedFrame(fn, a)
            runs.append((name, dt, run, a, bits(fn(a)).clone()))
    torch.cuda.synchronize()
    # What the graphs keep: tuples of tables, tensors or dicts of them.
    kept = [t for _, _, run, _, _ in runs for tables in run.kept for item in tables
            for t in (item.values() if isinstance(item, dict) else [item])]
    if not kept:
        raise AssertionError("(vii) no capture kept a cached table")
    easu_ops._tables.cache_clear()
    easu_gather._device_tables.cache_clear()
    garbage = [torch.full_like(t, -7) for t in kept for _ in range(4)]
    for name, dt, run, a, want in runs:
        got = run(a)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(bits(got), want):
            raise AssertionError(f"(vii) {name} {dt}: a replay differs from the eager call")
    del garbage
    print(f"  (vii) {', '.join(cases)}: each captured in float32 and bfloat16, its replay bit-equal to the eager "
          f"call; after the table caches were emptied and {len(kept)} tables' sizes overwritten, still bit-equal")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", action="store_true",
                        help="add phases 11 and 14 and phase 16's, 18's and 20's traces: torch.profiler "
                             "traces of the main paths")
    args = parser.parse_args()
    trace = args.trace
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    import fsr_tpu_torch as ft
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels import _build, easu_gather, fused, pad
    from fsr_tpu_torch.kernels import rcas as rcas_k
    from fsr_tpu_torch.reference import scalar as ref
    from fsr_tpu_torch.utils import profiling
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, cuda_times_in_turn, device_trace

    dev = torch.device("cuda:0")
    laps = []  # (phase, start time): the seconds each phase takes

    def lap(phase):
        laps.append((phase, time.perf_counter()))

    # --- 1. the card -------------------------------------------------------
    lap("1")
    card = _card()
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # --- 2. build ------------------------------------------------------------
    lap("2")
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2: built {_build.build_dir().name} in {time.perf_counter() - t0:.1f} s")
    k6_listing = _start_k6_sass()
    knocked = _build.ablation_mask(_build.library())
    if knocked:
        raise AssertionError(f"the production library was built with the knockouts {sorted(knocked)}")
    print("  fsr_ablation_mask() 0: no stage knockout in the production library")
    entries, spills, entry = 0, [], None
    for line in (_build.build_dir() / "build.log").read_text().splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
        if "Compiling entry" in line:
            entry, entries = line.split("'")[1], entries + 1
        elif "spill stores" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill stores"):
            spills.append(f"{entry}: {line.strip()}")
    print(f"  ptxas: {entries} kernel instantiations, {len(spills)} with a stack frame or spills; nvcc seconds per "
          f"source, one nvcc each, all at once: {_build.source_seconds(_build.build_dir()) or 'not recorded'}")
    for line in spills:
        print("    " + line)

    rng = np.random.default_rng(0)

    def rand(shape):
        return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)

    # --- 3. K4 -------------------------------------------------------------
    lap("3")
    print("phase 3: K4 edge_pad vs edge_pad_reference (bit-equal) and vs F.pad(mode='replicate')")
    k4_err = 0.0
    f32, bf16, u8 = torch.float32, torch.bfloat16, torch.uint8
    main_con = EasuConstants.create((1920, 1080), None, (3840, 2160))
    main_plan = fused.plan(MAIN_SHAPE[-2:], (2160, 3840), main_con)
    # A K1 row strip's pads (phase 18's 4 strips of the Performance frame).
    from fsr_tpu_torch.parallel import spatial
    strip_pads = fused.plan((MAIN_SHAPE[2] // 4 + 2 * spatial._HALO, MAIN_SHAPE[3]), (540, 3840),
                            spatial._local_constants(main_con, spatial._HALO)).pads
    pairs = ((f32, f32), (f32, bf16), (bf16, f32), (bf16, bf16), (u8, u8))
    k4_cases = [((2, 3, 67, 131), (3, 5, 2, 7)), ((1, 3, 1, 1), (5, 7, 9, 20)), ((3, 1, 1), (2, 0, 0, 40)),
                ((2, 4, 9, 23), (1, 2, 3, 4)), ((1, 4, 270 + 2 * spatial._HALO, 480), strip_pads)]
    # Output rows of every length modulo each vector (4 float32, 8 bfloat16,
    # 16 uint8 elements), so that row starts take every 16-byte residue and
    # the source shift every value; 3 and 4 planes.
    k4_cases += [((2, 3 + r % 2, 5, 32 + r - r % 5 - r % 3), (1, 2, r % 5, r % 3)) for r in range(16)]
    checks = 0
    counting = contextlib.ExitStack()  # K4's launches in the kernels line: this phase's
    rec = counting.enter_context(profiling.recording())
    for shape, pads in [(MAIN_SHAPE, main_plan.pads)] + k4_cases:
        x32 = rand(shape)
        srcs = {f32: x32, bf16: x32.to(bf16), u8: (x32 * 255).to(u8)}
        for sdt, dt in pairs:
            src = srcs[sdt]
            got = pad.edge_pad(src, pads, dt)
            want = pad.edge_pad_reference(src, pads, dt)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K4 {shape} {sdt}->{dt} pads {pads}: not bit-equal")
            if sdt == dt:  # F.pad pads without converting
                pt, pb, pl, pr = pads
                fp = torch.nn.functional.pad(src.unsqueeze(0) if src.dim() == 3 else src, (pl, pr, pt, pb),
                                             mode="replicate")
                if not torch.equal(fp.reshape(got.shape), got):
                    raise AssertionError(f"K4 {shape} {dt} pads {pads}: differs from F.pad")
            k4_err = max(k4_err, (got.float() - want.float()).abs().max().item())
            checks += 1
        print(f"  {tuple(shape)} pads {pads}: bit-equal")
    counting.close()
    k4_launches = _launches(rec, ("K4",))["K4"]
    print(f"  {checks} pads ({len(k4_cases) + 1} shapes x {', '.join(f'{a}->{b}' for a, b in pairs)}) bit-equal "
          f"to the plain version; the same-type pads also to F.pad; {k4_launches} K4 launches")

    # --- 4. K1 -------------------------------------------------------------
    lap("4")
    print("phase 4: K1 upscale_fused vs upscale_fused_reference")

    def con_for(in_hw, out_hw):
        return EasuConstants.create((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))

    k1_err = 0.0
    cases = [
        ("2x ragged", (1, 3, 67, 131), (134, 262), torch.float32, True, False, 0.25),
        ("2x 540p", (1, 3, 540, 960), (1080, 1920), torch.float32, True, False, 0.25),
        ("2x 540p bf16", (1, 3, 540, 960), (1080, 1920), torch.bfloat16, True, False, 0.25),
        ("2x 540p easu-only", (1, 3, 540, 960), (1080, 1920), torch.float32, False, False, 0.25),
        ("2x 540p denoise", (1, 3, 540, 960), (1080, 1920), torch.float32, True, True, 0.5),
        ("2x 540p bf16 denoise", (1, 3, 540, 960), (1080, 1920), torch.bfloat16, True, True, 0.5),
        ("2x batch 2", (2, 3, 270, 480), (540, 960), torch.float32, True, False, 0.25),
        ("4x", (1, 3, 135, 240), (540, 960), torch.float32, True, False, 0.25),
        ("2x rows 1x cols", (1, 3, 64, 128), (128, 128), torch.float32, True, False, 0.25),
    ]
    quads = 0

    def paths_agree(x, out_hw, con, rcon, rcas, denoise, dt, got, what):
        """The generic staged path bit-equal to ``got`` (the quad path where
        the plan takes it), and K1 on the K4-padded frame bit-equal too."""
        nonlocal quads
        fplan = fused.plan(tuple(x.shape[-2:]), out_hw, con)
        gen_ = fused.upscale_fused(x, out_hw, con, rcon, rcas, denoise, dt, path="generic")
        padded = pad.edge_pad(x, fplan.pads, dt)
        sharp_ = float(rcon.sharpness)
        on_padded = fused.upscale_padded(padded, fplan, out_hw, sharp_, rcas, denoise)
        torch.cuda.synchronize()
        quad = fused.quad_ok(fused.source_plan(fplan))
        if not torch.equal(gen_, got):
            raise AssertionError(f"{what}: the generic staged path differs from the "
                                 f"{'quad' if quad else 'generic'} path in {int((gen_ != got).sum())} values")
        if not torch.equal(on_padded, got):
            raise AssertionError(f"{what}: K1 on the K4-padded frame differs from K1 on the image")
        quads += quad
        print(f"  {what}: {'quad path bit-equal to the generic staged path' if quad else 'generic path'}; "
              "bit-equal to K1 on the K4-padded frame")

    for what, shape, out_hw, dt, rcas, denoise, stops in cases:
        x = rand(shape)
        con, rcon = con_for(shape[-2:], out_hw), RcasConstants(stops)
        got = fused.upscale_fused(x, out_hw, con, rcon, rcas, denoise, dt)
        want = fused.upscale_fused_reference(x, out_hw, con, rcon, rcas, denoise, dt)
        torch.cuda.synchronize()
        err = _compare(got, want, what)
        paths_agree(x.to(dt), out_hw, con, rcon, rcas, denoise, dt, got, what)
        if dt == torch.float32:
            k1_err = max(k1_err, err)

    # Hazard cases: isolated bright pixel (RCAS NaN-drop branch), DRS offset
    # constant, all-black frame (direction zero-protect).
    bright = torch.zeros((3, 32, 130), device=dev)
    bright[:, 16, 60] = 0.5
    black = torch.zeros((3, 64, 128), device=dev)
    drs = rand((3, 67, 131))
    hazards = [
        ("isolated bright pixel", bright, (64, 260), con_for((32, 130), (64, 260)), 0.0),
        ("all-black frame", black, (128, 256), con_for((64, 128), (128, 256)), 0.25),
        ("DRS input_offset", drs, (120, 256),
         EasuConstants.create((128, 60), (131, 67), (256, 120), (2, 3)), 0.25),
    ]
    for what, x, out_hw, con, stops in hazards:
        rcon = RcasConstants(stops)
        got = fused.upscale_fused(x, out_hw, con, rcon, True, False, torch.float32)
        want = fused.upscale_fused_reference(x, out_hw, con, rcon, True, False, torch.float32)
        torch.cuda.synchronize()
        k1_err = max(k1_err, _compare(got, want, what))
        paths_agree(x, out_hw, con, rcon, True, False, torch.float32, got, what)
    if quads < 8:
        raise AssertionError(f"only {quads} phase-4 cases took the quad path")

    # --- 5. oracle ---------------------------------------------------------
    lap("5")
    img = rng.uniform(0, 1, (3, 540, 960)).astype(np.float32)
    con = con_for((540, 960), (1080, 1920))
    oracle = ref.rcas_ref(ref.easu_ref(img, (1080, 1920), con), RcasConstants(0.25))
    x = torch.from_numpy(img).to(dev)
    out = ft.upscale(x, preset="performance")
    dev_oracle = np.abs(out.cpu().numpy() - oracle).max()
    print(f"phase 5: upscale(preset='performance') vs numpy oracle, 540p->1080p f32: "
          f"max-abs {dev_oracle:.3e} (limit {ORACLE_TOL:g})")
    if not dev_oracle <= ORACLE_TOL:
        raise AssertionError("port disagrees with the oracle")
    outb = ft.upscale(x.to(torch.bfloat16), preset="performance", compute_dtype=torch.bfloat16)
    db = np.abs(outb.float().cpu().numpy() - oracle)
    print(f"  bf16 storage vs oracle: median {np.median(db):.3e} p99 {np.percentile(db, 99):.3e} "
          f"max {db.max():.3e}")

    # --- 6. main path --------------------------------------------------------
    lap("6")
    drive = _drive
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.rand(MAIN_SHAPE, generator=gen, device=dev)
    nframes = MAIN_SHAPE[0]
    out_shape = MAIN_SHAPE[:-2] + (2160, 3840)
    launches = {"K1": 0, "K2": 0, "K3": 0}
    con = EasuConstants.create((1920, 1080), None, (3840, 2160))
    rcon = RcasConstants(0.25)
    print(f"phase 6: main path upscale(x, preset='performance') on {MAIN_SHAPE}")
    for dt in (torch.float32, torch.bfloat16):
        x = frames.to(dt)
        out, n = drive(lambda: ft.upscale(x, preset="performance", compute_dtype=dt), ("K1",))
        if tuple(out.shape) != out_shape or out.dtype != dt or out.device != x.device:
            raise AssertionError(f"main path {dt}: got {tuple(out.shape)} {out.dtype} {out.device}")
        launches["K1"] += n["K1"]
        print(f"  {dt}: out {tuple(out.shape)}; launches {n}")
        # The batch and the 4K tile grid held against the plain version.
        want = fused.upscale_fused_reference(x, (2160, 3840), con, rcon, True, False, dt)
        err = _compare(out, want, f"main path {dt} vs upscale_fused_reference")
        if dt == torch.float32:
            k1_err = max(k1_err, err)
        del want

    timings = {}
    for dt in (torch.float32, torch.bfloat16):
        x = frames.to(dt)
        t = {
            "call": cuda_time_ms(lambda: ft.upscale(x, preset="performance", compute_dtype=dt)),
            "call_b2b": _back_to_back_ms(lambda: ft.upscale(x, preset="performance", compute_dtype=dt)),
            "call_plain": cuda_time_ms(
                lambda: fused.upscale_fused_reference(x, (2160, 3840), con, rcon, True, False, dt),
                warmup=1, iters=5),
            "K4": cuda_time_ms(lambda: pad.edge_pad(x, main_plan.pads, dt), **KQ),
            "K4_plain": cuda_time_ms(lambda: pad.edge_pad_reference(x, main_plan.pads, dt)),
            "K1": cuda_time_ms(lambda: fused.upscale_fused(x, (2160, 3840), con, rcon, True, False, dt), **KQ),
            "K1 generic path": cuda_time_ms(
                lambda: fused.upscale_fused(x, (2160, 3840), con, rcon, True, False, dt, path="generic"), **KQ),
        }
        if dt == torch.float32:
            # The one PyTorch call that computes K4's function (timed, never
            # called by the port): F.pad takes (left, right, top, bottom).
            pt, pb, pl, pr = main_plan.pads
            t["K4_library"] = cuda_time_ms(
                lambda: torch.nn.functional.pad(x, (pl, pr, pt, pb), mode="replicate"), **KQ)
            padded = pad.edge_pad(x, main_plan.pads, dt)
            if not torch.equal(torch.nn.functional.pad(x, (pl, pr, pt, pb), mode="replicate"), padded):
                raise AssertionError("F.pad(mode='replicate') does not compute K4's function")
            main_bytes = {"K4": _nbytes(x, padded), "K1": _nbytes(x) * 5}
            del padded
        timings[dt] = t
        print(f"  times {dt}, median CUDA-event ms per 4K frame (batch {nframes}) on {card}:")
        for k, v in t.items():
            print(f"    {k:>10}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")
    t32 = timings[torch.float32]
    print("  call: median latency of one call (host work included); call_b2b: per call with "
          "10 calls queued back to back; call_plain: K1's plain version (K4's and K1's); K1: the "
          "kernel alone (the quad path), 10 calls queued per sample, K1 generic path: the same on its "
          "generic staged path; K4: "
          "the pad alone, not on this path; *_plain: plain torch versions on the card")
    print(f"  f32 output rate: {nframes * 2160 * 3840 / (t32['call'] * 1e-3) / 1e6:.1f} Mpix/s; "
          f"bf16: {nframes * 2160 * 3840 / (timings[torch.bfloat16]['call'] * 1e-3) / 1e6:.1f} Mpix/s")

    # --- 7. K2 ------------------------------------------------------------
    lap("7")
    print("phase 7: K2 easu_gather vs easu_gather_reference")
    k2_err = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    gather_cases = [
        # what, input shape, out_hw, storage, rcas, denoise, stops, (viewport, offset)
        ("ultra_quality 1.3x", (1, 3, 831, 1477), (1080, 1920), f32, True, False, 0.25, None),
        ("quality 1.5x", (1, 3, 720, 1280), (1080, 1920), f32, True, False, 0.25, None),
        ("balanced 1.7x", (1, 3, 635, 1129), (1080, 1920), f32, True, False, 0.25, None),
        ("native 1x", (1, 3, 540, 960), (540, 960), f32, True, False, 0.25, None),
        ("ragged ~1.7x", (1, 3, 64, 114), (108, 192), f32, True, False, 0.25, None),
        ("2x odd width", (1, 3, 270, 480), (540, 961), f32, True, False, 0.25, None),
        ("DRS 1.5x offset", (1, 3, 400, 700), (540, 960), f32, True, False, 0.25, ((360, 640), (8, 16))),
        ("quality bf16", (1, 3, 720, 1280), (1080, 1920), bf16, True, False, 0.25, None),
        ("quality easu-only", (1, 3, 720, 1280), (1080, 1920), f32, False, False, 0.25, None),
        ("quality denoise", (1, 3, 720, 1280), (1080, 1920), f32, True, True, 0.5, None),
        ("quality bf16 denoise", (1, 3, 720, 1280), (1080, 1920), bf16, True, True, 0.5, None),
        ("batch 2", (2, 3, 360, 640), (540, 960), f32, True, False, 0.25, None),
    ]
    for what, shape, out_hw, dt, rcas_on, denoise, stops, drs in gather_cases:
        x = rand(shape)
        if drs is None:
            con = con_for(shape[-2:], out_hw)
        else:
            (vh, vw), (oy, ox) = drs
            con = EasuConstants.create((vw, vh), (shape[-1], shape[-2]), (out_hw[1], out_hw[0]), (ox, oy))
        rcon = RcasConstants(stops)
        got = easu_gather.easu_gather(x, out_hw, con, rcon, rcas_on, denoise, dt)
        want = easu_gather.easu_gather_reference(x, out_hw, con, rcon, rcas_on, denoise, dt)
        torch.cuda.synchronize()
        err = _compare(got, want, what)
        if dt == torch.float32:
            k2_err = max(k2_err, err)
    gbright = torch.zeros((3, 32, 130), device=dev)
    gbright[:, 16, 60] = 0.5
    for what, x, out_hw, stops in (
        ("isolated bright pixel", gbright, (48, 195), 0.0),
        ("all-black frame", torch.zeros((3, 64, 128), device=dev), (96, 192), 0.25),
    ):
        con, rcon = con_for(x.shape[-2:], out_hw), RcasConstants(stops)
        got = easu_gather.easu_gather(x, out_hw, con, rcon, True)
        want = easu_gather.easu_gather_reference(x, out_hw, con, rcon, True)
        torch.cuda.synchronize()
        k2_err = max(k2_err, _compare(got, want, what))

    # --- 8. K3 ------------------------------------------------------------
    lap("8")
    print("phase 8: K3 rcas_fused vs rcas_fused_reference")
    k3_err = 0.0
    rbright = torch.zeros((3, 40, 130), device=dev)
    rbright[:, 20, 60] = 0.5
    rcas_cases = [
        # what, image, storage, border, denoise, stops
        ("clamp 1080p", rand((1, 3, 1080, 1920)), f32, "clamp", False, 0.25),
        ("zero 1080p", rand((1, 3, 1080, 1920)), f32, "zero", False, 0.25),
        ("denoise 1080p", rand((1, 3, 1080, 1920)), f32, "clamp", True, 0.5),
        ("zero denoise ragged", rand((2, 3, 67, 131)), f32, "zero", True, 0.5),
        ("bf16 1080p", rand((1, 3, 1080, 1920)), bf16, "clamp", False, 0.25),
        ("bf16 zero denoise", rand((1, 3, 1080, 1920)).to(bf16), bf16, "zero", True, 0.5),
        ("isolated pixel", rbright, f32, "clamp", False, 0.0),
        ("ragged 67x131", rand((3, 67, 131)), f32, "clamp", False, 0.25),
    ]
    for what, x, dt, border, denoise, stops in rcas_cases:
        rcon = RcasConstants(stops)
        got = rcas_k.rcas_fused(x, rcon, denoise, dt, border)
        want = rcas_k.rcas_fused_reference(x, rcon, denoise, dt, border)
        torch.cuda.synchronize()
        err = _compare(got, want, what)
        if dt == torch.float32:
            k3_err = max(k3_err, err)
    # K3 stages and stores 16-byte vectors: every storage type at widths of
    # every residue of its vector (ragged rows, two tiles wide, two tiles
    # high), and from a row start one element past an aligned address.
    f16 = torch.float16
    ragged = 0
    for tname, sdt, dt in (("f32", f32, f32), ("bf16", bf16, bf16), ("f16", f16, f16), ("u8", u8, None),
                           ("f32 under bf16", f32, bf16), ("bf16 under f16", bf16, f16)):
        vec = 16 // torch.empty((), dtype=dt or sdt).element_size()
        shapes = [((1, 3, 20, 129 + r), r) for r in range(vec)] + [((2, 3, 20, 256), None)]
        for shape, r in shapes:
            x = rand(shape)
            x = (x * 255).to(u8) if sdt == u8 else x.to(sdt)
            if r is None:  # the same values one element into their storage
                buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
                buf[1:] = x.flatten()
                x = buf[1:].view(shape)
                if x.data_ptr() % 16 == 0:
                    raise AssertionError("the shifted view is aligned")
            border, denoise = ("zero", True) if (r or 0) % 2 else ("clamp", False)
            rcon = RcasConstants(0.25)
            got = rcas_k.rcas_fused(x, rcon, denoise, dt, border)
            want = rcas_k.rcas_fused_reference(x, rcon, denoise, dt, border)
            torch.cuda.synchronize()
            what = f"K3 {tname} {tuple(shape)} {border} denoise={denoise}" + (", unaligned start" if r is None else "")
            if sdt == u8:
                if not torch.equal(got, want):
                    raise AssertionError(f"{what}: not bit-equal")
            else:
                err = _compare(got, want, what)
                if got.dtype == f32:
                    k3_err = max(k3_err, err)
            ragged += 1
    print(f"  {ragged} ragged and unaligned K3 calls within their limits (uint8 bit-equal)")

    # --- 9. oracle: Quality and sharpen ---------------------------------------
    lap("9")
    img = rng.uniform(0, 1, (3, 720, 1280)).astype(np.float32)
    oracle = ref.rcas_ref(ref.easu_ref(img, (1080, 1920), con_for((720, 1280), (1080, 1920))),
                          RcasConstants(0.25))
    out = ft.upscale(torch.from_numpy(img).to(dev), preset="quality")
    dq = np.abs(out.cpu().numpy() - oracle).max()
    print(f"phase 9: upscale(preset='quality') vs numpy oracle, 720p->1080p f32: "
          f"max-abs {dq:.3e} (limit {ORACLE_TOL:g})")
    img = rng.uniform(0, 1, (3, 1080, 1920)).astype(np.float32)
    oracle = ref.rcas_ref(img, RcasConstants(0.25))
    out = ft.sharpen(torch.from_numpy(img).to(dev))
    ds = np.abs(out.cpu().numpy() - oracle).max()
    print(f"  sharpen vs numpy oracle, 1080p f32: max-abs {ds:.3e} (limit {ORACLE_TOL:g})")
    if not (dq <= ORACLE_TOL and ds <= ORACLE_TOL):
        raise AssertionError("port disagrees with the oracle")
    del oracle, img

    # --- 10. the Quality path and sharpen -------------------------------------
    lap("10")
    qframes = torch.rand(QUALITY_SHAPE, generator=gen, device=dev)
    sframes = torch.rand(SHARPEN_SHAPE, generator=gen, device=dev)
    qcon = EasuConstants.create((2560, 1440), None, (3840, 2160))
    rcon = RcasConstants(0.25)  # upscale's and sharpen's default sharpness
    print(f"phase 10: Quality path upscale(x, preset='quality') on {QUALITY_SHAPE}, "
          f"sharpen(y) on {SHARPEN_SHAPE}")
    for dt in (torch.float32, torch.bfloat16):
        x = qframes.to(dt)
        out, n = drive(lambda: ft.upscale(x, preset="quality", compute_dtype=dt), ("K2",))
        if tuple(out.shape) != QUALITY_SHAPE[:-2] + (2160, 3840) or out.dtype != dt:
            raise AssertionError(f"quality path {dt}: got {tuple(out.shape)} {out.dtype}")
        launches["K2"] += n["K2"]
        print(f"  quality {dt}: out {tuple(out.shape)}; launches {n}")
        want = easu_gather.easu_gather_reference(x, (2160, 3840), qcon, rcon, True, False, dt)
        err = _compare(out, want, f"quality path {dt} vs easu_gather_reference")
        if dt == torch.float32:
            k2_err = max(k2_err, err)
        del want
        y = sframes.to(dt)
        out, n = drive(lambda: ft.sharpen(y), ("K3",))
        if tuple(out.shape) != SHARPEN_SHAPE or out.dtype != dt:
            raise AssertionError(f"sharpen {dt}: got {tuple(out.shape)} {out.dtype}")
        launches["K3"] += n["K3"]
        print(f"  sharpen {dt}: out {tuple(out.shape)}; launches {n}")
        want = rcas_k.rcas_fused_reference(y, rcon)
        err = _compare(out, want, f"sharpen {dt} vs rcas_fused_reference")
        if dt == torch.float32:
            k3_err = max(k3_err, err)
        del want

    qtimings = {}
    for dt in (torch.float32, torch.bfloat16):
        x = qframes.to(dt)
        y = sframes.to(dt)
        t = {
            "call": cuda_time_ms(lambda: ft.upscale(x, preset="quality", compute_dtype=dt)),
            "call_b2b": _back_to_back_ms(lambda: ft.upscale(x, preset="quality", compute_dtype=dt)),
            "K2": cuda_time_ms(lambda: easu_gather.easu_gather(x, (2160, 3840), qcon, rcon, True, False, dt), **KQ),
            "K2_plain": cuda_time_ms(
                lambda: easu_gather.easu_gather_reference(x, (2160, 3840), qcon, rcon, True, False, dt),
                warmup=1, iters=5),
            "sharpen_call": cuda_time_ms(lambda: ft.sharpen(y)),
            "sharpen_b2b": _back_to_back_ms(lambda: ft.sharpen(y)),
            "K3": cuda_time_ms(lambda: rcas_k.rcas_fused(y, rcon), **KQ),
            "K3_plain": cuda_time_ms(lambda: rcas_k.rcas_fused_reference(y, rcon), warmup=1, iters=5),
        }
        qtimings[dt] = t
        print(f"  times {dt}, median CUDA-event ms per 4K frame (batch {nframes}) on {card}:")
        for k, v in t.items():
            print(f"    {k:>12}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")
    print("  call: one upscale(preset='quality') call (host work included); call_b2b: per call "
          "with 10 calls queued back to back; sharpen_*: the same for sharpen; K2, K3: the "
          "kernels alone, 10 calls queued per sample; *_plain: their plain torch versions on the card")

    # --- 11. trace (--trace only) ---------------------------------------------
    lap("11")
    if trace:
        print(f"phase 11: torch.profiler traces on {card}")
        paths = (
            ("performance", frames, lambda x, dt: ft.upscale(x, preset="performance", compute_dtype=dt)),
            ("quality", qframes, lambda x, dt: ft.upscale(x, preset="quality", compute_dtype=dt)),
            ("sharpen", sframes, lambda x, dt: ft.sharpen(x)),
        )
        for name, src, fn in paths:
            for dt in (torch.float32, torch.bfloat16):
                x = src.to(dt)
                for calls in (1, 5):
                    tr = device_trace(lambda: fn(x, dt), calls)
                    print(f"  {name} {dt}, {calls} call(s) back to back: device busy "
                          f"{tr['busy_ms']:.4f} ms of a {tr['window_ms']:.4f} ms window, "
                          f"idle share {tr['idle_share']:.4f}")
                    for kname, ms in sorted(tr["kernels"].items(), key=lambda kv: -kv[1]):
                        print(f"    {ms:.4f} ms/call ({ms / nframes:.4f} ms/frame) {kname}")

    # --- 12. the prologue, the epilogue and byte I/O ---------------------------
    lap("12")
    from fsr_tpu_torch.kernels import epilogue as epilogue_mod
    from fsr_tpu_torch.kernels.epilogue import Epilogue

    u8, u16 = torch.uint8, torch.uint16
    rcon = RcasConstants(0.25)
    print("phase 12: K1 and K2 with the SRTM prologue, the K5 epilogue and byte I/O vs their plain versions")
    epilogues = [
        ("no epilogue", None),
        ("gamma2", Epilogue(transform="gamma2")),
        ("srtm_inv", Epilogue(transform="srtm_inv")),
        ("grain", Epilogue(grain_amount=0.3)),
        ("dither10", Epilogue(dither_bits=10)),
        ("gamma2+grain+dither8", Epilogue(transform="gamma2", grain_amount=0.25, dither_bits=8)),
        ("page dither8", Epilogue(dither_bits=8, dither_texture=True)),
    ]
    io_cases = [
        # what, source, storage, out dtype, prologue
        ("f32", "float", f32, None, "none"),
        ("HDR srtm f32", "hdr", f32, None, "srtm"),
        ("bf16", "float", bf16, None, "none"),
        ("u8 bf16 ->u8", "u8", bf16, u8, "none"),
        ("u8 f32 ->u16", "u8", f32, u16, "none"),
        ("HDR srtm bf16 ->u16", "hdr", bf16, u16, "srtm"),
    ]
    page = torch.rand((96, 160), generator=gen, device=dev)  # any page shape tiles the output
    epi_err = {"K1": 0.0, "K2": 0.0}
    for kname, fn, ref_fn, in_hw in (("K1", fused.upscale_fused, fused.upscale_fused_reference, (540, 960)),
                                     ("K2", easu_gather.easu_gather, easu_gather.easu_gather_reference,
                                      (720, 1280))):
        out_hw = (1080, 1920)
        con = con_for(in_hw, out_hw)
        x = rand((1, 3, *in_hw))
        srcs = {"float": x, "hdr": x * 16, "u8": (x * 255).to(u8)}
        grain = rand((3, *out_hw)) - 0.5
        for ename, epi in epilogues:
            for iname, src, dt, od, pro in io_cases:
                if epi is not None and epi.dither_bits == 10 and od == u8:
                    continue  # uint8 cannot hold 10-bit codes
                kw = dict(epilogue=epi, frame=7, grain=grain, dither_page=page, prologue=pro, out_dtype=od)
                got = fn(srcs[src], out_hw, con, rcon, True, False, dt, **kw)
                want = ref_fn(srcs[src], out_hw, con, rcon, True, False, dt, **kw)
                torch.cuda.synchronize()
                err = _compare_epilogue(got, want, epi, f"{kname} {ename}, {iname}")
                if got.dtype == f32 and (epi is None or epi.dither_bits is None):
                    epi_err[kname] = max(epi_err[kname], err)
    y8 = (rand((2, 3, 1080, 1920)) * 255).to(u8)
    for border in ("clamp", "zero"):
        for denoise in (False, True):
            got = rcas_k.rcas_fused(y8, rcon, denoise, None, border)
            want = rcas_k.rcas_fused_reference(y8, rcon, denoise, None, border)
            torch.cuda.synchronize()
            if got.dtype != u8 or not torch.equal(got, want):
                raise AssertionError(f"K3 uint8 {border} denoise={denoise}: not bit-equal")
            print(f"  K3 uint8 {border} denoise={denoise}: bit-equal")
    for pads in (main_plan.pads, (3, 5, 2, 7)):
        got, want = pad.edge_pad(y8, pads, u8), pad.edge_pad_reference(y8, pads, u8)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K4 uint8 pads {pads}: not bit-equal")
        print(f"  K4 uint8 pads {pads}: bit-equal")

    # --- 13. the README's pipeline paths -------------------------------------
    lap("13")
    out4k = (2160, 3840)
    pcon = EasuConstants.create((1920, 1080), None, (3840, 2160))
    hdr = torch.rand(MAIN_SHAPE, generator=gen, device=dev) * 16
    grain4k = torch.rand((3, *out4k), generator=gen, device=dev) - 0.5
    q8 = (qframes * 255).to(u8)
    m8 = (frames * 255).to(u8)
    s8 = (sframes * 255).to(u8)
    epi_a = Epilogue(grain_amount=0.3, dither_bits=10)
    epi_b = Epilogue(grain_amount=0.25, dither_bits=8)
    pipe_a = ft.UpscalePipeline(out4k, hdr_srtm=True, grain_amount=0.3, dither_bits=10)
    pipe_b = ft.UpscalePipeline(out4k, grain_amount=0.25, dither_bits=8, out_dtype=u8, compute_dtype=bf16)
    torch_a = ft.UpscalePipeline(out4k, hdr_srtm=True, grain_amount=0.3, dither_bits=10, impl="torch")
    torch_b = ft.UpscalePipeline(out4k, grain_amount=0.25, dither_bits=8, out_dtype=u8,
                                 compute_dtype=bf16, impl="torch")
    paths = [
        # name, call, kernels it launches, plain version, plain-torch pipeline, torch-path step,
        # epilogue, {timed kernel and its plain version}, {the same upscale without the epilogue}
        ("(a) HDR frame tail, f32 1080p -> 4K", lambda: pipe_a(hdr, grain=grain4k, frame=7), ("K1",),
         lambda: fused.upscale_fused_reference(hdr, out4k, pcon, rcon, epilogue=epi_a, frame=7, grain=grain4k,
                                               prologue="srtm"),
         lambda: torch_a(hdr, grain=grain4k, frame=7), 1.01 / 1023.0, epi_a,
         {"K1": lambda: fused.upscale_fused(hdr, out4k, pcon, rcon, epilogue=epi_a, frame=7, grain=grain4k,
                                            prologue="srtm"),
          "K1_plain": lambda: fused.upscale_fused_reference(hdr, out4k, pcon, rcon, epilogue=epi_a, frame=7,
                                                            grain=grain4k, prologue="srtm"),
          "K1 SRTM prologue only": lambda: fused.upscale_fused(hdr, out4k, pcon, rcon, prologue="srtm"),
          "K1 grain + TEPD epilogue only": lambda: fused.upscale_fused(hdr, out4k, pcon, rcon, epilogue=epi_a,
                                                                       frame=7, grain=grain4k),
          "K1 neither": lambda: fused.upscale_fused(hdr, out4k, pcon, rcon)},
         {"upscale, no prologue or epilogue": lambda: ft.upscale(hdr, out_size=out4k)}),
        ("(b) display, u8 1440p -> 4K u8, bf16", lambda: pipe_b(q8, grain=grain4k, frame=7), ("K2",),
         lambda: easu_gather.easu_gather_reference(q8, out4k, qcon, rcon, True, False, bf16, epilogue=epi_b,
                                                   frame=7, grain=grain4k, out_dtype=u8),
         lambda: torch_b(q8, grain=grain4k, frame=7), None, epi_b,
         {"K2": lambda: easu_gather.easu_gather(q8, out4k, qcon, rcon, True, False, bf16, epilogue=epi_b,
                                                frame=7, grain=grain4k, out_dtype=u8)},
         {"upscale u8 -> bf16, no epilogue": lambda: ft.upscale(q8, out_size=out4k, compute_dtype=bf16),
          "upscale bf16 -> bf16 (phase 10's path)": lambda: ft.upscale(qframes.to(bf16), out_size=out4k,
                                                                         compute_dtype=bf16)}),
        ("(c) byte video, u8 1080p -> 4K u8", lambda: ft.upscale(m8, scale=2.0, out_dtype=u8), ("K1",),
         lambda: fused.upscale_fused_reference(m8, out4k, pcon, rcon, out_dtype=u8),
         lambda: ft.upscale(m8, scale=2.0, out_dtype=u8, impl="torch"), 1.0, None,
         {"K1": lambda: fused.upscale_fused(m8, out4k, pcon, rcon, out_dtype=u8),
          "K1_plain": lambda: fused.upscale_fused_reference(m8, out4k, pcon, rcon, out_dtype=u8)},
         {"upscale f32 -> f32 (phase 6's path)": lambda: ft.upscale(frames, out_size=out4k)}),
        ("sharpen u8 4K", lambda: ft.sharpen(s8), ("K3",), lambda: rcas_k.rcas_fused_reference(s8, rcon),
         lambda: ft.sharpen(s8, impl="torch"), 1.0, None,
         {"K3": lambda: rcas_k.rcas_fused(s8, rcon),
          "K3_plain": lambda: rcas_k.rcas_fused_reference(s8, rcon)},
         {"sharpen f32 (phase 10's path)": lambda: ft.sharpen(sframes)}),
    ]
    print(f"phase 13: the README pipeline paths on batches of {nframes}, on {card}")
    path_runs = {}
    for name, call, need, plain, plain_torch, step, epi, kernel_fns, bare_fns in paths:
        out, n = drive(call, need)
        print(f"  {name}: out {tuple(out.shape)} {out.dtype}; launches {n}")
        err = _compare_epilogue(out, plain(), epi, f"{name} vs the kernels' plain versions")
        _compare_torch_path(out, plain_torch(), name, step)
        t = {"call": cuda_time_ms(call), "call_b2b": _back_to_back_ms(call)}
        for k, f_ in kernel_fns.items():
            t[k] = cuda_time_ms(f_, warmup=1, iters=5) if k.endswith("_plain") else cuda_time_ms(f_, **KQ)
        t["plain"] = cuda_time_ms(plain, warmup=1, iters=3)
        t["plain-torch pipeline"] = cuda_time_ms(plain_torch, warmup=1, iters=3)
        for k, f_ in bare_fns.items():
            t[k] = cuda_time_ms(f_)
        path_runs[name] = dict(launches=n, err=err, t=t)
        for k, v in t.items():
            print(f"    {k:>40}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")
        del out
    print("  call: median latency of one call (host work included); call_b2b: per call with 10 calls "
          "queued back to back; K*: the kernel alone, 10 calls queued per sample; plain: the kernels' "
          "plain versions; the rest: "
          "the same upscale without the prologue and epilogue, for the epilogue's cost")

    # --- 14. trace of the pipeline paths (--trace only) -------------------------
    lap("14")
    if trace:
        print(f"phase 14: torch.profiler traces of the pipeline paths on {card}")
        for name, call, kinds in ((paths[0][0], paths[0][1], ("fused_kernel",)),
                                  (paths[1][0], paths[1][1], ("gather_kernel",))):
            for calls in (1, 5):
                tr = device_trace(call, calls)
                print(f"  {name}, {calls} call(s) back to back: device busy {tr['busy_ms']:.4f} ms of a "
                      f"{tr['window_ms']:.4f} ms window, idle share {tr['idle_share']:.4f}")
                for kname, ms in sorted(tr["kernels"].items(), key=lambda kv: -kv[1]):
                    print(f"    {ms:.4f} ms/call ({ms / nframes:.4f} ms/frame) {kname}")
                extra = [k for k in tr["kernels"] if not any(kind in k for kind in kinds)]
                if extra:
                    raise AssertionError(f"{name}: the trace shows more than {kinds}: {extra}")

    # --- 15. RGBA on K1 and K2 -----------------------------------------------
    lap("15")
    print("phase 15: K1 and K2 on RGBA vs their plain versions and the 3-channel call of the same kernel")
    epi_tail = Epilogue(grain_amount=0.3, dither_bits=10)
    epi_disp = Epilogue(grain_amount=0.25, dither_bits=8)
    rgba_cases = [
        # what, source kind, storage, out dtype, rcas, denoise, prologue, epilogue
        ("f32", "float", f32, None, True, False, "none", None),
        ("f32 EASU only", "float", f32, None, False, False, "none", None),
        ("f32 denoise", "float", f32, None, True, True, "none", None),
        ("bf16", "float", bf16, None, True, False, "none", None),
        ("u8 ->u8", "u8", f32, u8, True, False, "none", None),
        ("u8 ->u16", "u8", f32, u16, True, False, "none", None),
        ("HDR srtm f32", "hdr", f32, None, True, False, "srtm", None),
        ("HDR tail: srtm, grain, dither10", "hdr", f32, None, True, False, "srtm", epi_tail),
        ("display: u8, grain, dither8, bf16 ->u8", "u8", bf16, u8, True, False, "none", epi_disp),
    ]
    k1_fns = (fused.upscale_fused, fused.upscale_fused_reference)
    k2_fns = (easu_gather.easu_gather, easu_gather.easu_gather_reference)
    rgba_geoms = [
        # kernel, (wrapper, plain version), input (h, w), output (h, w), constants, cases
        ("K1", k1_fns, (270, 480), (540, 960), con_for((270, 480), (540, 960)), rgba_cases),
        ("K2", k2_fns, (360, 640), (540, 960), con_for((360, 640), (540, 960)), rgba_cases),
        ("K2 DRS offset", k2_fns, (400, 700), (540, 960),
         EasuConstants.create((640, 360), (700, 400), (960, 540), (16, 8)), rgba_cases[:1]),
        ("K2 ragged ~1.7x", k2_fns, (64, 114), (108, 192), con_for((64, 114), (108, 192)), rgba_cases[:1]),
    ]
    rgba_err = {"K1": 0.0, "K2": 0.0}
    for kname, (fn, ref_fn), in_hw, out_hw, con, cases in rgba_geoms:
        x = rand((1, 3, *in_hw))
        a = rand((1, 1, *in_hw))
        srcs = {"float": torch.cat([x, a], 1), "hdr": torch.cat([x * 16, a], 1),
                "u8": (torch.cat([x, a], 1) * 255).to(u8)}
        grain = rand((3, *out_hw)) - 0.5
        for what, src, dt, od, rcas_on, denoise, pro, epi in cases:
            x4 = srcs[src]
            kw = dict(epilogue=epi, frame=7, grain=grain, prologue=pro, out_dtype=od)
            got = fn(x4, out_hw, con, rcon, rcas_on, denoise, dt, **kw)
            got3 = fn(x4[:, :3].contiguous(), out_hw, con, rcon, rcas_on, denoise, dt, **kw)
            want = ref_fn(x4, out_hw, con, rcon, rcas_on, denoise, dt, **kw)
            torch.cuda.synchronize()
            label = f"{kname} RGBA {what}"
            if got.shape != want.shape or got.shape[1] != 4:
                raise AssertionError(f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
            if not torch.equal(got[:, :3], got3):
                raise AssertionError(f"{label}: RGB differs from the 3-channel call")
            if not torch.equal(got[:, 3], want[:, 3]):
                raise AssertionError(f"{label}: alpha not bit-equal to the plain version")
            err = _compare_epilogue(got[:, :3], want[:, :3], epi, f"{label}, RGB")
            print(f"  {label}: RGB bit-equal to the 3-channel call, alpha bit-equal to the plain version")
            if got.dtype == f32 and epi is None:
                rgba_err[kname[:2]] = max(rgba_err[kname[:2]], err)

    # --- 16. the RGBA paths at full width -------------------------------------
    lap("16")
    rgba_frames = torch.cat([frames, torch.rand(MAIN_SHAPE[:1] + (1,) + MAIN_SHAPE[2:], generator=gen,
                                                device=dev)], 1)
    rgba_q = torch.cat([qframes, torch.rand(QUALITY_SHAPE[:1] + (1,) + QUALITY_SHAPE[2:], generator=gen,
                                            device=dev)], 1).to(bf16)
    rgba8 = (rgba_frames * 255).to(u8)
    print(f"phase 16: the RGBA paths on batches of {nframes}, on {card}")
    rgba_paths = [
        # name, image, upscale kwargs, kernels, plain version, constants
        ("(d) performance f32", rgba_frames, dict(preset="performance"), ("K1",),
         lambda x: fused.upscale_fused_reference(x, out4k, pcon, rcon)),
        ("(d) performance u8 ->u8", rgba8, dict(preset="performance", out_dtype=u8), ("K1",),
         lambda x: fused.upscale_fused_reference(x, out4k, pcon, rcon, out_dtype=u8)),
        ("(e) quality bf16", rgba_q, dict(preset="quality", compute_dtype=bf16), ("K2",),
         lambda x: easu_gather.easu_gather_reference(x, out4k, qcon, rcon, True, False, bf16)),
    ]
    rgba_runs = {}
    for name, x4, kw, need, plain in rgba_paths:
        out, n = drive(lambda: ft.upscale(x4, **kw), need)
        if tuple(out.shape) != (nframes, 4) + out4k or out.dtype != kw.get("out_dtype", x4.dtype):
            raise AssertionError(f"{name}: got {tuple(out.shape)} {out.dtype}")
        print(f"  {name}: out {tuple(out.shape)} {out.dtype}; launches {n}")
        out_bytes = _nbytes(out)
        want = plain(x4)
        if not torch.equal(out[:, 3], want[:, 3]):
            raise AssertionError(f"{name}: alpha not bit-equal to the plain version")
        if out.dtype == u8:
            err = _compare_steps(out[:, :3], want[:, :3], None, f"{name} vs the plain version, RGB")
        else:
            err = _compare(out[:, :3], want[:, :3], f"{name} vs the plain version, RGB")
        del want
        x3 = x4[:, :3].contiguous()
        if not torch.equal(out[:, :3], ft.upscale(x3, **kw)):
            raise AssertionError(f"{name}: RGB differs from the same call on the RGB slice")
        print(f"  {name}: alpha bit-equal to the plain version, RGB bit-equal to the call on the RGB slice")
        del out
        # Each RGBA time is taken in turn with its RGB-slice twin, so that
        # alpha's cost is read under the same clocks and card state.
        t = cuda_times_in_turn({"call": lambda: ft.upscale(x4, **kw),
                             "call on the RGB slice": lambda: ft.upscale(x3, **kw)})
        od = kw.get("out_dtype")
        if "K1" in need:
            t.update(cuda_times_in_turn({
                "K1": lambda: fused.upscale_fused(x4, out4k, pcon, rcon, out_dtype=od),
                "K1 RGB": lambda: fused.upscale_fused(x3, out4k, pcon, rcon, out_dtype=od)}, **KQ))
            t["K1_plain"] = cuda_time_ms(lambda: plain(x4), warmup=1, iters=3)
            nbytes = _nbytes(x4) + out_bytes
        else:
            q16 = qframes.to(bf16)  # phase 10's frames, beside the RGB slice of the RGBA frames
            t.update(cuda_times_in_turn({
                "K2": lambda: easu_gather.easu_gather(x4, out4k, qcon, rcon, True, False, bf16),
                "K2 RGB": lambda: easu_gather.easu_gather(x3, out4k, qcon, rcon, True, False, bf16),
                "K2 phase 10": lambda: easu_gather.easu_gather(q16, out4k, qcon, rcon, True, False, bf16)}, **KQ))
            del q16
            t["K2_plain"] = cuda_time_ms(lambda: plain(x4), warmup=1, iters=3)
            nbytes = _nbytes(x4) + out_bytes
        rgba_runs[name] = dict(launches=n, err=err, t=t, nbytes=nbytes)
        for k, v in t.items():
            print(f"    {k:>22}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")
        print("    alpha's cost: " + ", ".join(
            f"{k} {t[k] / t[k + ' RGB'] - 1:+.1%}" for k in ("K4", "K1", "K2") if k in t))
    print("  call: median latency of one upscale call; K*: the kernel alone on the RGBA frames, 10 calls "
          "queued per sample; "
          "* RGB: the same on the RGB slice, for alpha's cost (the two taken in turn, 3 rounds, "
          "median); K*_plain: the plain version")
    if trace:
        kinds_of = {"K1": "fused_kernel", "K2": "gather_kernel"}
        for name, x4, kw, need, _ in rgba_paths:
            kinds = tuple(kinds_of[k] for k in need)
            for what, x in (("RGBA", x4), ("the RGB slice", x4[:, :3].contiguous())):
                tr = device_trace(lambda: ft.upscale(x, **kw), 5)
                print(f"  trace {name} on {what}, 5 calls back to back: device busy {tr['busy_ms']:.4f} ms "
                      f"of a {tr['window_ms']:.4f} ms window, idle share {tr['idle_share']:.4f}")
                for kname, ms in sorted(tr["kernels"].items(), key=lambda kv: -kv[1]):
                    print(f"    {ms:.4f} ms/call ({ms / nframes:.4f} ms/frame) {kname}")
                extra = [k for k in tr["kernels"] if not any(kind in k for kind in kinds)]
                if extra:
                    raise AssertionError(f"{name}: the trace shows more than {kinds}: {extra}")

    # --- 17. float16 ------------------------------------------------------------
    lap("17")
    from fsr_tpu_torch.ops import easu as easu_ops
    from fsr_tpu_torch.ops import rcas as rcas_ops

    f16 = torch.float16
    print("phase 17: float16 (K6 for upscale, K3 for sharpen; K1 and K2 on float16 images)")
    img = rng.uniform(0, 1, (3, 540, 960)).astype(np.float32)
    con = con_for((540, 960), (1080, 1920))
    x16 = torch.from_numpy(img).to(dev).half()
    oracle32 = ref.easu_ref(img, (1080, 1920), con)
    out, _ = drive(lambda: ft.upscale(x16, preset="performance", compute_dtype=f16, apply_rcas=False), ("K6",))
    if out.dtype != f16 or tuple(out.shape) != (3, 1080, 1920):
        raise AssertionError(f"float16 upscale: got {tuple(out.shape)} {out.dtype}")
    _f16_stats(out, oracle32, "upscale f16 mixed EASU 540p->1080p (K6) vs the f32 oracle", F16_MIXED)
    out, _ = drive(lambda: ft.upscale(x16, preset="performance", compute_dtype=f16), ("K6",))
    full32 = ref.rcas_ref(oracle32, RcasConstants(0.25))
    _f16_stats(out, full32, "upscale f16 mixed EASU+RCAS (K6) vs the f32 oracle",
               {k: v for k, v in F16_MIXED.items() if k != "median"})
    e16 = easu_ops.easu(x16, (1080, 1920), con, compute_dtype=f16, precision="strict")
    strict = rcas_ops.rcas(e16, RcasConstants(0.25))
    oracle16 = ref.easu_ref_f16(img, (1080, 1920), con)
    _f16_stats(e16, oracle16, "ops.easu f16 strict 540p->1080p vs the f16 oracle", F16_STRICT)
    _f16_stats(strict, ref.rcas_ref(oracle16, RcasConstants(0.25), dtype=np.float16),
               "ops.easu strict + ops.rcas f16 vs the f16 oracle", F16_STRICT)
    del oracle32, full32, oracle16, e16, strict, img

    y16 = sframes.half()
    out, n = drive(lambda: ft.sharpen(y16), ("K3",))
    if out.dtype != f16 or tuple(out.shape) != SHARPEN_SHAPE:
        raise AssertionError(f"sharpen f16: got {tuple(out.shape)} {out.dtype}")
    want = rcas_k.rcas_fused_reference(y16, rcon)
    d = (out.float() - want.float()).abs()
    k3_f16 = dict(launches=n["K3"], err=d.max().item(), off=int((d > 0).sum()))
    print(f"  sharpen f16 4K: launches {n}; vs rcas_fused_reference max-abs {k3_f16['err']:.3e} "
          f"(limit one half step, {F16_ULP:g}), {k3_f16['off']} of {d.numel()} values differ")
    if not torch.isfinite(out).all() or k3_f16["err"] > F16_ULP:
        raise AssertionError("sharpen f16: K3 disagrees with its plain version")
    del out, want, d
    y_bf16 = sframes.to(bf16)
    k3_f16["t"] = {
        "sharpen_call": cuda_time_ms(lambda: ft.sharpen(y16)),
        "K3": cuda_time_ms(lambda: rcas_k.rcas_fused(y16, rcon), **KQ),
        "K3 bf16": cuda_time_ms(lambda: rcas_k.rcas_fused(y_bf16, rcon), **KQ),
        "K3_plain": cuda_time_ms(lambda: rcas_k.rcas_fused_reference(y16, rcon), warmup=1, iters=5),
    }
    print(f"  times on {card}, batch {nframes}:")
    for k, v in k3_f16["t"].items():
        print(f"    {k:>26}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")
    del y_bf16
    k6_kernels = (_k6(dev, card, frames, qframes, rgba_frames, k6_listing) + _k6_tail(dev, card, frames, qframes)
                  + _f16_sources(card, frames, qframes, rgba_frames))

    t32, q32 = timings[torch.float32], qtimings[torch.float32]
    ta, tb, tc, ts = (path_runs[p[0]] for p in paths)
    td, td8, te = (rgba_runs[p[0]] for p in rgba_paths)
    npix = nframes * out4k[0] * out4k[1]
    out4k_f32 = npix * 3 * 4
    src = {"K4": "fsr_tpu_torch/csrc/edge_pad.cu", "K1": "fsr_tpu_torch/csrc/fused.cu",
           "K2": "fsr_tpu_torch/csrc/easu_gather.cu", "K3": "fsr_tpu_torch/csrc/rcas.cu"}
    rep = {"K4": "fsr_tpu/kernels/pad.py:50", "K1": "fsr_tpu/kernels/fused.py:403",
           "K2": "fsr_tpu/kernels/easu_gather.py:350", "K3": "fsr_tpu/kernels/rcas_pallas.py:42"}
    kernels = [
        _kernel_entry("edge_pad (K4), phase 3's pads; timed at the Performance shape, off the K1 paths",
                      src["K4"], rep["K4"], k4_launches, k4_err, t32["K4"], t32["K4_plain"], main_bytes["K4"], 0,
                      t32["K4_library"]),
        _kernel_entry("upscale_fused (K1)", src["K1"], rep["K1"], launches["K1"], k1_err, t32["K1"],
                      t32["call_plain"], main_bytes["K1"], EASU_RCAS_OPS * npix),
        _kernel_entry("easu_gather (K2)", src["K2"], rep["K2"], launches["K2"], k2_err, q32["K2"],
                      q32["K2_plain"], _nbytes(qframes) + out4k_f32, EASU_RCAS_OPS * npix),
        _kernel_entry("rcas_fused (K3)", src["K3"], rep["K3"], launches["K3"], k3_err, q32["K3"],
                      q32["K3_plain"], 2 * _nbytes(sframes), RCAS_OPS * npix),
        _kernel_entry("upscale_fused (K1) + SRTM prologue + K5 epilogue: HDR frame tail (a)", src["K1"],
                      rep["K1"], ta["launches"]["K1"], max(epi_err["K1"], ta["err"]), ta["t"]["K1"],
                      ta["t"]["K1_plain"], _nbytes(hdr, grain4k) + out4k_f32,
                      (EASU_RCAS_OPS + LFGA_OPS + TEPD_OPS) * npix + SRTM_OPS_PER_TEXEL * hdr.numel() // 3),
        _kernel_entry("easu_gather (K2) + K5 epilogue, uint8 in and out: display path (b)", src["K2"],
                      rep["K2"], tb["launches"]["K2"], max(epi_err["K2"], tb["err"]), tb["t"]["K2"],
                      tb["t"]["plain"], _nbytes(q8, grain4k) + npix * 3,
                      (EASU_RCAS_OPS + LFGA_OPS + TEPD_OPS) * npix),
        _kernel_entry("upscale_fused (K1), uint8 in and out: byte video path (c)", src["K1"], rep["K1"],
                      tc["launches"]["K1"], tc["err"], tc["t"]["K1"], tc["t"]["K1_plain"],
                      _nbytes(m8) + npix * 3, EASU_RCAS_OPS * npix),
        _kernel_entry("rcas_fused (K3), uint8: sharpen on bytes", src["K3"], rep["K3"],
                      ts["launches"]["K3"], ts["err"], ts["t"]["K3"], ts["t"]["K3_plain"],
                      2 * _nbytes(s8), RCAS_OPS * npix),
        _kernel_entry("upscale_fused (K1), RGBA: performance path (d)", src["K1"], rep["K1"],
                      td["launches"]["K1"], max(rgba_err["K1"], td["err"]), td["t"]["K1"], td["t"]["K1_plain"],
                      td["nbytes"], (EASU_RCAS_OPS + ALPHA_OPS) * npix),
        _kernel_entry("upscale_fused (K1), RGBA, uint8 in and out: performance path (d)", src["K1"], rep["K1"],
                      td8["launches"]["K1"], td8["err"], td8["t"]["K1"], td8["t"]["K1_plain"], td8["nbytes"],
                      (EASU_RCAS_OPS + ALPHA_OPS) * npix),
        _kernel_entry("easu_gather (K2), RGBA, bf16: quality path (e)", src["K2"], rep["K2"],
                      te["launches"]["K2"], max(rgba_err["K2"], te["err"]), te["t"]["K2"], te["t"]["K2_plain"],
                      te["nbytes"], (EASU_RCAS_OPS + ALPHA_OPS) * npix),
        _kernel_entry("rcas_fused (K3), float16: sharpen on halves", src["K3"], rep["K3"], k3_f16["launches"],
                      k3_f16["err"], k3_f16["t"]["K3"], k3_f16["t"]["K3_plain"], 2 * _nbytes(y16),
                      RCAS_OPS * npix),
    ] + k6_kernels

    # --- 18. row-sharded and batch-sharded execution ---------------------------
    lap("18")
    kernels += _row_sharded(dev, card, gen, trace)

    # --- 19. the probes P1-P4 ----------------------------------------------------
    lap("19")
    kernels += _probes(dev, card)

    # --- 20. autodiff ----------------------------------------------------------------
    lap("20")
    _autodiff(dev, card, trace)

    # --- 21. the application layer ----------------------------------------------------
    lap("21")
    _app_layer(dev, card)

    # --- 22. the measurement tools ----------------------------------------------------
    lap("22")
    _tools(dev, card)

    # --- 23. captured frames ----------------------------------------------------------
    lap("23")
    _captured_frames(dev, card)
    laps.append(("end", time.perf_counter()))
    print("seconds per phase: " + ", ".join(f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(laps, laps[1:]))
          + f"; {laps[-1][1] - laps[0][1]:.1f} in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
