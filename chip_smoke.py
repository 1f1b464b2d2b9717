#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one line each:
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build: compile the kernels from `tbraymarcherplugin_tpu_torch/csrc`
     (one nvcc per source, all at once);
  3. kernels: each of K1-K4 against its plain PyTorch version on the card,
     at the shapes of the main path (max abs error against a stated limit,
     CUDA-event times of both; K2 exactly, on both warp passes of the
     frame), K3's occluder source (the volume sampled, the cube test, the
     clip weight and the alpha in one launch) on one face at 256^3 and at
     CHEST_DIMS, one device operation a call, and K2's row lerp as one
     `grid_sample` call, K2's yardstick (`library_ms`), checked against the plain version
     and timed the same ways;
  4. slice: the full lit frame (256^3 CT phantom, bone TF, window
     (0.5, 0.8), one light, 1920x1080, 150 planes, jitter on) through
     `Renderer`: one illumination rebuild, four orbit frames, one light
     move; every forward kernel's launch counter must rise; frames are
     checked for finiteness, coverage and distinct checksums, against the
     port's all-plain path on the card, and, on a small scene, against the
     CPU; K4 (one cooperative launch per face) as one device operation per
     call and exactly its plain version on the rebuild's faces, on
     K7_FACES and on a 2048^2 face (K4_LARGE);
  5. fwd+bwd: the differentiable frame of the same scene (bf16 planes, no
     jitter) through `models.pipeline.render_lit_scene`: three
     `loss.backward()` steps of the L2 loss against the frame at window
     (0.5, 0.8), at window centers 0.55, 0.56, 0.57; every leaf's gradient
     must be finite and nonzero, (loss, sum |dTF|) must differ from step to
     step and all eight kernels' counters must rise, with the third step's
     peak device memory; then each backward
     kernel K5-K8 against its plain version on the inputs the path gave it
     (and against itself: two launches must give the same bits), how K8's
     histogram adds cluster on the first face (the plain version's
     `stats=`: hit share, add rounds per warp of 32 elements, runs of
     equal texels) and K8 as one device operation per call, K6's
     yardstick `grid_sampler_2d_backward` (the input gradient of K2's
     `grid_sample` call) at both warp passes, how K5's
     histogram adds cluster there (the plain version's `stats=`: hit
     share, add rounds per warp of 32 pixels and plane, runs of equal
     texels), K7 as one device kernel per face and exactly its plain version
     on five more faces (K7_FACES) and on three faces too large for its
     registers (K7_LARGE, the 2048^2 one timed with its bound), the
     gradients against the all-plain path on the card, and
     a 24^3 fwd+bwd on the card against the CPU;
  6. march: the occupancy grid's build (timed), then four fly-through
     frames with the camera inside the volume (same scene, jitter on),
     where shear-warp has no plan and `Renderer` marches through K9: K9's
     counter must rise and K1's must not; frames are checked for
     finiteness, coverage and distinct checksums; K9 against its plain
     version on the path's inputs, and on the bench camera forced to march
     (`march_impl="pallas"`), both timed, with the work of its warps (the
     plain version's `stats=`: lane slots per step, the share that shades,
     the steps fetched, in empty cells, cut, of alpha 0); a frame without
     empty-space skipping against one with it (the same bits); the frame
     against the all-plain path; a 24^3 frame inside the volume on the card
     against the CPU; one frame back outside takes K1 again; and a small
     `render_lit_scene(march_impl="blocked")` fwd+bwd on the card against
     the CPU;
  7. dense fwd+bwd: three `loss.backward()` steps of the same scene and
     loss as phase 5 through the dense composite
     (`render_lit_scene(march_impl="shearwarp", shearwarp_tf_unit=
     "pallas")`, float32 planes): the illumination kernels' and K10a's and
     K10b's counters must rise, every leaf's gradient must be finite and
     nonzero; K10a and K10b against their plain versions (and against
     themselves) on the first block's inputs and on the block with the
     most histogram adds, with how K10b's adds cluster there (the plain
     version's `stats=`: hit share, add rounds per warp of 32 elements,
     runs of equal texels), the image and gradients
     against the "xla" TF unit on the card (and a control with bfloat16
     planes, which must fail those limits), and a 24^3 dense fwd+bwd on
     the card against the CPU;
  8. fit: `models.fitting.fit` through the dense composite from window
     center 0.6 toward the frame at 0.5, with a checkpoint after each
     step: finite, descending losses, and the newest checkpoint restored
     on the card equals the fitted leaves;
  9. the gather probe (`tools/micro.py`, K11): its tool's run, then the
     kernel against `tab[idx]` (exactly), with the times of the kernel,
     the plain version and `torch.index_select`;
 10. modes: the bench scene through `Renderer` in intensity mode (four
     orbit frames), in octree mode (four, mip 0), and one lit frame behind
     an opaque plane (`scene_depth_from_plane`): K1's intensity, unlit and
     λ-ceiling variants' launch counts must rise; frames are checked for
     finiteness, coverage and distinct checksums, against the all-plain
     path on the card, and the depth frame for less alpha than the same
     frame without depth; each variant against its plain version on the
     path's own inputs, timed, with its bound from the work the plain
     version counts (`composite_ops`); one march-fallback frame per mode
     (camera inside the volume), timed; a 24^3 frame per mode on the card
     against the CPU;
 11. from disk: the bench phantom as int16 HU written as a series of 256
     single-slice DICOM files (`io/minidicom.py`, 0.7 x 0.7 x 1 mm, file
     names in the reverse of slice order) and as a zlib MHD of uint16,
     both loaded by `io.load_volume` (seconds each, and whether the native
     library ran) and held to (raw - lo) / (hi - lo) in float32 exactly;
     `tools/render_cli.py` on the DICOM folder: four 1920x1080 lit orbit
     frames, an intensity, an octree and a clipped frame with the
     half-resolution light, K1's variants, K2, K3 and K4 counted per run;
     the PNGs decoded (`tools/png.py`) for size, coverage and distinct
     orbit checksums, frame 0 equal to `Renderer.render` at its camera
     (same quantization); ms per CLI frame with and without the PNG; the
     viewer's state (`tools/viewer.py`, no socket) after three window
     drags and a TF change, each 1024^2 frame different from the last; the
     SDF demo (`ops/sdf_march.py`) at 512^2 on the card and at 64^2 on the
     card against the CPU; one CLI frame under `utils.profiling.
     device_trace`, whose trace file must appear;
 12. parallel: the `parallel` package on a world-1 NCCL group
     (`parallel.distributed.initialize_multihost` with a file store,
     `make_mesh`): `shearwarp_lit_sharded_diff` on the bench scene (bf16
     planes, window center 0.55 against the frame at 0.5), its frame, loss
     and (dvolume, dtf, dwindow) the same bits as the single-device fused
     path, K1, K5, K2 and K6 counted, timed with its peak device memory;
     `shearwarp_lit_sharded` the same bits as `shearwarp_lit`; a 4-way
     column split's ranks in turn (float32 planes): each slab's K1 and K5
     calls against their plain versions, the slabs against the full
     intermediate (rtol 1e-5, atol 1e-6) and their summed gradients
     against the full-width ones (rtol 5e-3, atol 1e-5 of the largest);
     `make_sharded_train_step` on 480x270 rays, 64 steps per unit: one
     Adam step bulk, one bulk again and one overlapped, the loss the bits
     of `render_lit_scene`'s, the gradients of the two modes against
     each other beside the spread of two bulk steps (float atomics in the
     march's backward), K3, K4, K7 and K8 counted; the slab paths on the
     same rays (the ring against `march_lit`, the segment march against
     `march_lit` without the snap, rtol 1e-4, atol 1e-5) and the
     slab-local illumination against `compute_illumination` (rtol 1e-5,
     atol 1e-6), K3's occluder source and K4 counted;
 13. slab: the kernels the slab-sharded `Renderer` gives new arguments, at
     the Richtmyer-Meshkov cell's shapes (`rmbench/configs/
     richtmyer_meshkov.json`: 2048x2048x1920 as four Z slabs of 480, the
     stand-in volume, the cell's light, window and camera) on one card,
     the ranks in turn: K3's occluder source on a held slab and halo with
     a Z window, each face's light planes (the X face's with its light
     halo), against its plain version on windows at either end (LIMITS)
     and against itself on those windows (the same bits); K4 on the X
     face's band in chunks of the sharded rebuild's slices chained by
     carries, and on the Z face as two ranks' chunks of 480 slices chained
     by the carry, each against one scan of the whole (the same bits) and
     against its plain version with the carry (the same bits); K1 on each
     rank's column band of the four slabs' summed partial planes against
     its plain version (LIMITS) and against the one-card composite's band
     of the same planes (atol 1e-6); the launches of K3's occluder
     source, K4 and K1 counted from zero, with each launch's time;
 14. preshear: K12 at the chest clip drag cell's frame (512x512x384,
     bfloat16 planes, both streams, the jitter's padding plane) and at the
     fit's planes (256^3, float32), each against its plain version (the
     same bits; the same bits on a second launch; one launch a stream),
     timed with its bound and the parent's composition (`_volume_planes`,
     the light slices' lerp and the tent matrices' two `bmm`:
     `library_ms`); its adjoint on the fit's light stream against the
     plain adjoint (1e-5 of the largest value), the same bits twice, timed
     with its bound and autograd through the parent's composition.

``python3 chip_smoke.py --phases 12,13,14`` runs phases 1, 2 and the named
ones of 12, 13 and 14 alone, on phase 3's scene.
Every kernel is timed two ways: ``ms``, CUDA events around back-to-back
calls of its Python wrapper (host time included where the host is slower
than the card), and ``device_ms``, the device work alone (`device_ms`:
torch.profiler's CUDA trace, the kernels, copies and fills of a call, each
at its mean duration over the calls); each library call too. Then a JSON line of the
kernels (each with its bound, from the inputs it was timed on; K1's
variants as rows of their own), the card line, and the result line.

There is no CPU path: without a CUDA device the script exits with an error.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import subprocess
import sys
import time
from unittest import mock

DIMS = (256, 256, 256)
# Phase 3: K3's occluder source also at the chest CT's shape (LUNA16,
# full-resolution light), one face
CHEST_DIMS = (512, 512, 384)
# Phase 14: the chest CT's frame as rmbench/configs/luna16_chest.json sets
# it: voxels of 0.7 x 0.7 x 0.8 mm, the camera at azimuth 30 and
# elevation 15 degrees, 2.2 times the largest world extent from the
# center, field of view 40 degrees
CHEST_SPACING_MM = (0.7, 0.7, 0.8)
CHEST_CAMERA = (30.0, 15.0, 2.2, 40.0)
# The kernels of the shear-warp fwd+bwd, forward (K12, K1, K2, K3's
# occluder source, K4) then backward (K5-K8; K12's adjoint is counted
# apart: it is no wrapper of the kernel table)
FWD_BWD = ("preshear", "composite", "row_lerp", "occluder", "light_scan",
           "composite_bwd", "row_lerp_bwd", "light_scan_bwd", "tf_alpha_bwd")
WIDTH, HEIGHT, STEPS = 1920, 1080, 150
WINDOW = (0.5, 0.8)
FWD_BWD_CENTERS = (0.55, 0.56, 0.57)
LIGHT_DIR = (0.3, 0.1, -0.95)
CAM_POS = (0.1, -2.3, 0.4)
FOV = 40.0

# Max abs error of a kernel against its plain version on the same inputs.
# The kernels round every operation as their plain versions do (see
# csrc/common.cuh). On an H100 (CUDA 12.8, torch 2.11) expf and logf give
# PyTorch's exp and log bit for bit, and K1 agrees with its plain version
# exactly on the bench frame; the limits leave room for another toolkit's
# ulps. K2 and K4 have no transcendentals and agree exactly.
LIMITS = {"composite": 2e-5, "row_lerp": 1e-5, "tf_alpha": 1e-6,
          "occluder": 1e-6, "light_scan": 1e-5, "march": 2e-5}
# `grid_sample` as K2's yardstick against K2's plain version: it maps its
# normalized coordinate back to texels in float32, ((x + 1) / 2) * (N - 1),
# which moves a tap by up to ~1e-4 texel at N ~ 1900 (2.3e-5 on the bench
# frame's rows, NVIDIA H100 80GB HBM3, 700 W); K2 reads idx as it is.
LIBRARY_LERP_LIMIT = 1e-4
# `grid_sampler_2d_backward` as K6's yardstick against K6's plain version,
# as the largest error over the largest plain value: the same tap moves
# move each weight by up to 1e-4 (1.9e-4 and 1.4e-4 of the largest value
# at the two passes, NVIDIA H100 80GB HBM3, 700 W); on indices its float32
# mapping keeps exact, the two agree within 1e-5
# (tests/test_torch_warp.py).
LIBRARY_LERP_BWD_LIMIT = 1e-3
# Backward kernels against their plain versions on the same inputs, as the
# largest error over the largest plain value of each output (K5: dW, dL, dTF,
# d window; K6: d rows; K7: d opacity, sum m, m_0; K8: d values, dTF,
# d window). The sums run in another order than the plain versions' (K5,
# K6, K8), and K5/K8 meet expf/logf ulps; K5's dW and dL are bf16 on this
# path, where an ulp of float32 can round to the next bf16 value: one bf16
# ulp at the largest value is 2^-8. K7 does the plain version's operations
# in its order and agrees exactly.
BWD_LIMITS = {"composite_bwd": 2.0 ** -8, "row_lerp_bwd": 1e-5,
              "light_scan_bwd": 0.0, "tf_alpha_bwd": 1e-4}
# K10a and K10b, replayed the same way on the dense path's inputs: K10a's
# RGB lerps round as the plain version's and its alpha meets expf/logf
# ulps; K10b sums in another order and meets the same ulps (K8's limit).
REPLAY_LIMITS = dict(BWD_LIMITS, tf_rgba=1e-6, tf_rgba_bwd=1e-4)
# Kernel frame vs all-plain frame, RGBA: the same bits on an H100 (CUDA
# 12.8, torch 2.11); the limit leaves room for another toolkit's exp/log
# ulps, which reach the frame through the light volume.
FRAME_VS_PLAIN_LIMIT = 1e-4
# Gradients of the kernel path vs the all-plain path on the card (bf16
# planes in both) and vs the CPU at 24^3 (float32 planes in both), each as
# |got - want|_2 / |want|_2: an ulp of float32 between the two (expf/logf,
# sum order) can round a bf16 plane cotangent to the next value (2^-8
# relative) or flip one pixel's 0.95 snap, which moves that pixel's whole
# contribution.
GRAD_VS_PLAIN_LIMIT = 1e-2
# Phase 5: K7 on faces beyond the path's, (K, H, W) and offsets, each held
# to its plain version exactly: a half-resolution face, a non-square face
# whose rows shift past many 1-row bands in both directions, and the faces
# of a 512^3 and a 1024^3 volume (all on K7's register route); then faces
# too large for the registers (a 2048-row face needs 16 rows of 2048
# pixels a block on 132 SMs, above 1024 threads of 8), which walk their
# bands: a 2048^2 face of 16 slices (timed, with its bound) and a 1536-row
# one, whose sums fit shared memory, and a 3000x4000 face, whose sums do not.
K7_FACES = (((64, 128, 128), (0.37, -1.6)),
            ((64, 96, 200), (-10.4, 3.3)),
            ((64, 96, 200), (7.6, -12.2)),
            ((32, 512, 512), (3.4, -9.6)),
            ((8, 1024, 1024), (-2.2, 1.7)))
K7_LARGE = (((16, 2048, 2048), (-3.2, 8.9)),
            ((3, 1536, 2048), (10.4, -2.6)),
            ((2, 3000, 4000), (-0.7, 1.3)))
# Phase 4: K4 on a face of 2048^2 (16 rows a block on 132 SMs, its band and
# halo staged in 221 KB of shared memory), rows shifting up by 10.4 px.
K4_LARGE = ((3, 2048, 2048), (-10.4, 3.3))
# Phase 6: the fly-through camera, inside the 256^3 volume's dominant slab
# (no shear-warp plan), looking at the center through the phantom's bone
# shell; every ray of its frame hits bone (alpha coverage 1.0 on the CPU at
# 24^3 and 64^3), far above the 5% coverage check. Successive frames step
# the camera along FLY_STEP.
FLY_POS, FLY_STEP, FLY_FOV = (0.1, -0.3, 0.05), (0.01, 0.005, 0.0), 60.0
# A march frame on the card (float32 throughout) against the CPU at 24^3:
# the light volume meets K3's exp/log ulps, as in phase 4's frame limit.
SMALL_MARCH_LIMIT = 1e-4
# bf16 plane storage (card) vs float32 (CPU), the JAX package's own bounds
# for bf16 against f32 (tests/test_shearwarp_pallas.py::test_fused_bf16_close)
SMALL_MEAN_LIMIT, SMALL_MAX_LIMIT = 2e-3, 0.06

# Limits of phase 7. The dense composite's TF unit on the card, K10
# against the "xla" unit's plain operations, and the card against the CPU
# at 24^3 (float32 planes in all), as |got - want|_2 / |want|_2. Both read
# 1e-6 to 1e-5 on the H100 (PERF.md): float32 ulps in other sum orders
# (the "xla" unit's backward adds with atomics, in another order on every
# run). bfloat16 planes on the dense path, the control that phase 7 also
# runs, must fail them.
DENSE_IMAGE_LIMIT = DENSE_GRAD_LIMIT = 1e-4
FIT_STEPS = 5
FIT_START_CENTER = 0.6

# The least time the card could take for a call (`bound_ms`): the larger of
# the bytes the call must move (each input read once, each output written
# once) over the H100 SXM's 3.35 TB/s, and its float32 operations over the
# 67 TFLOP/s outside the tensor cores (NVIDIA's H100 SXM data sheet).
# Operations per element of each kernel's work, counted from its
# source (a transcendental counts as one operation): per output element of
# the row lerp, per element of its first operand otherwise. The march and
# the composite count what their threads do on the inputs they were timed
# on (`march_bound`, `composite_ops`).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K3's occluder source, per light voxel: the trilinear sample (7 lerps of
# 3: 21), the UVW along x (3) and its cube test (2), the clip weight
# (distance 4, voxel offset 6, norm 4, sign 2, weight 5), keep (1), the
# windowed alpha (26) and the product (1): 75.
OPS_PER_ELEMENT = {
    "row_lerp": 6, "tf_alpha": 26, "occluder": 75, "light_scan": 20,
    "composite_bwd": 120, "row_lerp_bwd": 8, "light_scan_bwd": 40,
    "tf_alpha_bwd": 45, "tf_rgba": 35, "tf_rgba_bwd": 75, "gather_probe": 1,
}
# K9's float operations (csrc/march.cu, each round-to-nearest intrinsic,
# min/max, floor, compare, log and exp one; integer index arithmetic and
# loads not counted). Every step a thread takes: the sample position
# (3 mul, 3 add) and the clip test (3 sub, 3 mul, 2 add, 1 compare): 15.
# A sample that is neither clipped nor cut adds: the volume's trilinear
# fetch (per axis mul, sub, floor, sub, max, min: 18; 3 weights; 7 lerps
# of 3: 21), the window and cut (sub, add, div, 2 compares: 5), the TF
# taps (mul, sub, floor, sub, 2 x max/min, add: 9), the alpha lerp and
# its step correction (3 + 8): 67. Such a sample whose alpha is above 0
# adds the light's fetch at the clamped position (6 + 42), the RGB lerps
# and light products (12) and the composite with the termination test
# (13): 73; a sample of alpha 0 adds exactly nothing, so the function
# needs none of that for it. The first designs' bound charged all 140 to
# every sample that is neither clipped nor cut; it is printed beside the
# bound (`old_bound_ms`).
MARCH_STEP_OPS, MARCH_SAMPLE_OPS, MARCH_SHADE_OPS = 15, 67, 73
# K1's float operations (csrc/composite.cu, counted as K9's). A (pixel,
# plane) visit: the coordinates (2 mul, 2 add), with jitter the next
# plane's (4) and three lerps (9), and the mask (4 compares, mul, add,
# compare): 24, one more with a λ ceiling. A sample that passes the mask:
# the value's lerp (3), the window and the cut or, in intensity mode, the
# clamp (5): 8. A sample shaded through the TF (lit and unlit, not cut):
# the taps (9), four lerps (12), the alpha correction (8), the weight (2),
# the RGB products and sums (9), alpha and the termination test (3): 43,
# and the light's lerp (3) in lit mode. The plain version counts the
# three kinds of work (`composite_plain(..., stats=)`). The bound counts a
# visit's operations for the samples that pass the mask only: a visit
# that geometry excludes is work a design with per-tile plane intervals
# does not do. The first design's bound charged every visit of an
# occupied chunk up to termination (`steps`); it is printed beside the
# bound (`old_bound_ms`).
COMPOSITE_STEP_OPS, COMPOSITE_SAMPLE_OPS = 24, 8
COMPOSITE_SHADE_OPS = {"lit": 46, "unlit": 43, "intensity": 0}
# Phase 10: the opaque plane behind which the lit depth frame's samples are
# masked (world space, facing the camera, 0.2 in front of the volume's
# center: it hides about half of the frame's alpha at 64^3 on the CPU).
DEPTH_PLANE = ((0.0, -0.2, 0.0), (0.1, -0.95, 0.3))

# Phase 14: K12 (the pre-shear) at the chest CT's frame (bfloat16 planes,
# both streams, the jitter's padding plane) and at the fit's (float32,
# 256^3, no jitter), and its adjoint at the fit's. The kernel does the
# plain version's operations in its order: float32 the same bits, and so
# bfloat16 too (one rounding of the same value); the adjoint sums in
# another order than the plain scatter-adds, as the largest error over the
# largest plain value. Operations per plane sample: the principal lerp (3)
# and the row lerp (3) of its line's texels, over the samples a line
# serves, at most 1; the column taps (mul, add, max, min, floor, sub, sub)
# and lerp (3): 10 + 6 = 16. The adjoint: per cotangent value two taps'
# weights and adds (2 x (7 + 2)) and per source texel the rows' (same): 18.
PRESHEAR_LIMIT = 0.0
PRESHEAR_ADJOINT_LIMIT = 1e-5
PRESHEAR_OPS, PRESHEAR_ADJOINT_OPS = 16, 18

REPLACES = {
    "composite": "tbraymarcherplugin_tpu/ops/shearwarp_pallas.py:146",
    "composite_intensity": "tbraymarcherplugin_tpu/ops/shearwarp_pallas.py:146",
    "composite_unlit": "tbraymarcherplugin_tpu/ops/shearwarp_pallas.py:146",
    "composite_depth": "tbraymarcherplugin_tpu/ops/shearwarp_pallas.py:146",
    "row_lerp": "tbraymarcherplugin_tpu/ops/pallas_warp.py:34",
    "tf_alpha": "tbraymarcherplugin_tpu/ops/pallas_tf.py:29",
    "occluder": "tbraymarcherplugin_tpu/ops/lighting.py:199",
    "light_scan": "tbraymarcherplugin_tpu/ops/pallas_lighting.py:57",
    "composite_bwd": "tbraymarcherplugin_tpu/ops/shearwarp_grad.py:109",
    "row_lerp_bwd": "tbraymarcherplugin_tpu/ops/pallas_warp.py:93",
    "light_scan_bwd": "tbraymarcherplugin_tpu/ops/pallas_lighting.py:184",
    "tf_alpha_bwd": "tbraymarcherplugin_tpu/ops/pallas_tf.py:291",
    "march": "tbraymarcherplugin_tpu/ops/pallas_march.py:359",
    "tf_rgba": "tbraymarcherplugin_tpu/ops/pallas_tf.py:131",
    "tf_rgba_bwd": "tbraymarcherplugin_tpu/ops/pallas_tf.py:170",
    "gather_probe": "benchmarks/micro.py:155",
    "preshear": "none: tbraymarcherplugin_tpu/ops/shearwarp.py "
                "_resample_block, XLA einsums",
    "preshear_adjoint": "none: the einsums' transposes under jax.vjp",
}
SOURCES = {
    "composite": "tbraymarcherplugin_tpu_torch/csrc/composite.cu",
    "composite_intensity": "tbraymarcherplugin_tpu_torch/csrc/composite.cu",
    "composite_unlit": "tbraymarcherplugin_tpu_torch/csrc/composite.cu",
    "composite_depth": "tbraymarcherplugin_tpu_torch/csrc/composite.cu",
    "row_lerp": "tbraymarcherplugin_tpu_torch/csrc/row_lerp.cu",
    "tf_alpha": "tbraymarcherplugin_tpu_torch/csrc/tf_alpha.cu",
    "occluder": "tbraymarcherplugin_tpu_torch/csrc/tf_alpha.cu",
    "light_scan": "tbraymarcherplugin_tpu_torch/csrc/light_scan.cu",
    "composite_bwd": "tbraymarcherplugin_tpu_torch/csrc/composite_bwd.cu",
    "row_lerp_bwd": "tbraymarcherplugin_tpu_torch/csrc/row_lerp_bwd.cu",
    "light_scan_bwd": "tbraymarcherplugin_tpu_torch/csrc/light_scan_bwd.cu",
    "tf_alpha_bwd": "tbraymarcherplugin_tpu_torch/csrc/tf_alpha_bwd.cu",
    "march": "tbraymarcherplugin_tpu_torch/csrc/march.cu",
    "tf_rgba": "tbraymarcherplugin_tpu_torch/csrc/tf_rgba.cu",
    "tf_rgba_bwd": "tbraymarcherplugin_tpu_torch/csrc/tf_rgba_bwd.cu",
    "gather_probe": "tbraymarcherplugin_tpu_torch/csrc/gather_probe.cu",
    "preshear": "tbraymarcherplugin_tpu_torch/csrc/preshear.cu",
    "preshear_adjoint": "tbraymarcherplugin_tpu_torch/csrc/preshear.cu",
}


# Phase 11: the bench phantom as a CT series on disk, int16 HU = round(v *
# 4000 - 1000), 0.7 x 0.7 mm pixels, 1 mm slices; the CLI's and the
# viewer's controls; the SDF demo's sizes and its limits between the card
# and the CPU: the Mandelbulb's distance estimate is chaotic near the
# surface, where an ulp of atan2/pow between the two moves a ray's hit by
# a step (under 1% of the 64x64 rays on the CPU against the JAX package's
# XLA build, tests/test_torch_sdf_march.py)
# Phase 12: the ray-tile train step's and the slab marches' rays (fewer
# than the frame's: the blocked march keeps a block's samples for all its
# rays) and the train step's steps per unit (the JAX package's default).
TRAIN_RAYS, TRAIN_STEPS = (480, 270), 64
# Bulk against overlapped all-reduce gradients at world 1, as |a - b|_2 /
# |b|_2 per leaf: the same sums in the same order (tests/test_torch_
# parallel.py: the same bits on the CPU), but on the card the blocked
# march's backward and the TF rows' histogram add with float atomics, so
# two bulk steps differ too (the spread is printed beside it); the JAX
# test's rtol (tests/test_sharding.py::test_overlapped_allreduce_grads_match).
TRAIN_GRAD_LIMIT = 1e-5
DICOM_SPACING = (0.7, 0.7, 1.0)
CLI_ARGS = ["--size", f"{WIDTH}x{HEIGHT}", "--steps", str(STEPS), "--tf",
            "ct_bone", "--window-center", "0.5", "--window-width", "0.8"]
CLI_CLIP = "0.5,0.5,0.5,0.3,-0.8,0.52"  # cuts the far half away
VIEWER_SIZE = 1024
VIEWER_CENTERS = (0.45, 0.55, 0.6)
VIEWER_TF = "ct_soft_tissue"
SDF_SIZE, SDF_SMALL = 512, 64
SDF_HIT_SHARE_LIMIT, SDF_SHADE_LIMIT = 0.02, 0.02


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


def cuda_ms(torch, fn, reps):
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events), after
    one warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROFILE_TRIES = 6
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


def device_ms(torch, fn, reps):
    """Device time of one ``fn()`` call, the device work alone, from
    torch.profiler's CUDA trace of ``reps`` calls after one warm-up call:
    per distinct kernel, copy or fill, its mean duration times its count per
    call (its events over ``reps``, rounded), summed. Gaps in which the card
    waits for the host are not counted. The trace has been seen to drop an
    event now and then, and every event of a session, once three sessions
    in a row: a dropped event moves neither the mean nor the rounded count,
    and a session without events is run again after a pause, up to
    PROFILE_TRIES times, each such session reported on stderr. A short spin
    kernel before and
    after the calls, left out, keeps the trace's ends off them. Returns (ms,
    device operations per call)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        durs = collections.defaultdict(list)
        for ev in events:
            if (ev.get("cat") in DEVICE_CATS and "dur" in ev
                    and MARKER not in ev.get("name", "")):
                durs[ev.get("name", "")].append(float(ev["dur"]))
        per_call = {k: round(len(v) / reps) for k, v in durs.items()}
        if sum(per_call.values()) > 0:
            us = sum(sum(v) / len(v) * per_call[k] for k, v in durs.items())
            return us / 1e3, sum(per_call.values())
        cats = collections.Counter(ev.get("cat") for ev in events)
        print(f"[profiler] session {attempt + 1} of {PROFILE_TRIES}: no "
              f"device operation of the calls in the trace "
              f"({dict(cats)})", file=sys.stderr, flush=True)
    raise AssertionError(f"the profiler's trace of {reps} calls holds no "
                         f"device operation")


def host_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def _elements(torch, name, args, kw, out):
    """The units of work of one call that OPS_PER_ELEMENT counts."""
    if name == "row_lerp":
        return out.numel()
    if name == "gather_probe":
        return args[1].numel()
    return next(a for a in args if isinstance(a, torch.Tensor)).numel()


LERP_KW = dict(mode="bilinear", padding_mode="border", align_corners=True)


def row_lerp_library_args(torch, rows, idx, groups):
    """(input, grid) of ``grid_sample(input, grid, **LERP_KW)``, which
    computes K2's row lerp with clamp-to-edge in one call: the ``groups``
    blocks of ``rows`` as a batch of one-channel (Rq, N) images, sampled at
    x = 2 * idx / (N - 1) - 1 and y on each row exactly."""
    R, n = rows.shape
    Rq, Q = idx.shape
    x = (idx.double() * (2.0 / (n - 1)) - 1.0).float()
    y = (torch.arange(Rq, dtype=torch.float64, device=idx.device)
         * (2.0 / (Rq - 1)) - 1.0).float()
    grid = torch.stack([x, y[:, None].expand(Rq, Q)], dim=-1)
    return (rows.view(groups, 1, Rq, n),
            grid[None].expand(groups, Rq, Q, 2).contiguous())


def march_bound(torch, args, kw, out, stats):
    """``bound_ms``/``bound_by`` of one K9 call whose plain run filled
    ``stats`` (`fused_march.march_lit_fused_plain`), and ``old_bound_ms``,
    the first designs' (see MARCH_STEP_OPS)."""
    steps = stats["steps"] * MARCH_STEP_OPS
    ops = (steps + stats["samples"] * MARCH_SAMPLE_OPS
           + stats["shaded"] * MARCH_SHADE_OPS)
    old = steps + stats["samples"] * (MARCH_SAMPLE_OPS + MARCH_SHADE_OPS)
    return dict(bound(torch, "march", [(args, kw, out)], ops=ops),
                old_bound_ms=bound(torch, "march", [(args, kw, out)],
                                   ops=old)["bound_ms"])


def _bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def bound(torch, name, calls, ops=None):
    """``bound_ms`` and ``bound_by`` of the calls ``[(args, kw, out)]`` of
    kernel ``name`` (see HBM_BYTES_PER_S); ``ops`` counts their operations
    where OPS_PER_ELEMENT does not."""
    nbytes = 0
    count = ops is None
    ops = ops or 0
    for args, kw, out in calls:
        ins = [t for t in (*args, *kw.values()) if isinstance(t, torch.Tensor)]
        outs = [t for t in as_tuple(out) if isinstance(t, torch.Tensor)]
        if count:
            ops += _elements(torch, name, args, kw, out) * OPS_PER_ELEMENT[name]
        nbytes += sum(t.numel() * t.element_size() for t in ins + outs)
    return _bound(nbytes, ops)


def composite_ops(kw, stats, visits="samples"):
    """K1's float operations on the call ``kw`` whose plain run filled
    ``stats`` (see COMPOSITE_STEP_OPS): a visit's for each of ``stats``'s
    ``visits``, the samples that pass the mask (``"steps"``: the first
    design's count, every visit of an occupied chunk)."""
    step = COMPOSITE_STEP_OPS + (kw.get("depth_lam") is not None)
    return (stats[visits] * step + stats["samples"] * COMPOSITE_SAMPLE_OPS
            + stats["shaded"] * COMPOSITE_SHADE_OPS[kw.get("mode", "lit")])


def composite_bound(torch, kw, out, stats):
    """``bound_ms``/``bound_by`` of one K1 call, and ``old_bound_ms``, the
    first design's: each plane value a thread reads (the samples that pass
    the mask; the light's only where they are shaded, lit mode), each
    per-pixel field and small operand once, the output once; operations
    from ``composite_ops``."""
    planes = ("W", "L")
    nbytes = stats["samples"] * kw["W"].element_size()
    if kw.get("mode", "lit") == "lit":
        nbytes += stats["shaded"] * kw["L"].element_size()
    nbytes += sum(t.numel() * t.element_size() for k, t in kw.items()
                  if isinstance(t, torch.Tensor) and k not in planes)
    nbytes += out.numel() * out.element_size() + kw["pa"].nbytes
    old = _bound(nbytes, composite_ops(kw, stats, "steps"))
    return dict(_bound(nbytes, composite_ops(kw, stats)),
                old_bound_ms=old["bound_ms"])


def kernel_table():
    """(name, module, wrapper name) of each kernel, K1-K12 (K3 twice: on
    values and with its occluder source; K12's adjoint, a wrapper of
    other arguments than its plain version's, is not swapped: where K12
    runs plain, autograd differentiates its plain version)."""
    from tbraymarcherplugin_tpu_torch.ops import composite, fused_march
    from tbraymarcherplugin_tpu_torch.ops import light_scan, lighting
    from tbraymarcherplugin_tpu_torch.ops import preshear, shearwarp_grad
    from tbraymarcherplugin_tpu_torch.ops import tf_alpha, tf_rgba, warp
    from tbraymarcherplugin_tpu_torch.tools import micro

    return (("composite", composite, "composite"),
            ("row_lerp", warp, "row_lerp"),
            ("tf_alpha", tf_alpha, "windowed_tf_alpha"),
            ("occluder", lighting, "occluder_opacity"),
            ("light_scan", light_scan, "propagate_face_scan"),
            ("composite_bwd", shearwarp_grad, "composite_bwd"),
            ("row_lerp_bwd", warp, "row_lerp_bwd"),
            ("light_scan_bwd", light_scan, "propagate_face_scan_bwd"),
            ("tf_alpha_bwd", tf_alpha, "windowed_tf_alpha_bwd"),
            ("march", fused_march, "march_lit_fused"),
            ("tf_rgba", tf_rgba, "windowed_tf_rgba"),
            ("tf_rgba_bwd", tf_rgba, "windowed_tf_rgba_bwd"),
            ("gather_probe", micro, "gather_probe"),
            ("preshear", preshear, "preshear"))


@contextlib.contextmanager
def all_plain():
    """Swap each kernel wrapper for its plain PyTorch version in the module
    that defines it (every caller looks it up there at call time), so the
    whole path runs plain on the card."""
    with contextlib.ExitStack() as stack:
        for _, mod, fn in kernel_table():
            stack.enter_context(
                mock.patch.object(mod, fn, getattr(mod, fn + "_plain")))
        yield


@contextlib.contextmanager
def capture_calls(calls: dict, names):
    """Record the arguments of every call of the named kernels' wrappers
    (the wrapper still runs), for replaying them against the plain
    versions."""
    with contextlib.ExitStack() as stack:
        for name, mod, fn in kernel_table():
            if name not in names:
                continue
            real = getattr(mod, fn)

            def spy(*args, _real=real, _name=name, **kw):
                calls.setdefault(_name, []).append((args, kw))
                return _real(*args, **kw)

            # the wrapper counts on the name it is bound to
            spy.launches = 0
            spy.variant_launches = collections.Counter()
            stack.enter_context(mock.patch.object(mod, fn, spy))
        yield


def replay(torch, name, real, plain, used, card, results):
    """Hold kernel ``name`` against its plain version, and against itself,
    on the recorded calls ``used``; time both and bound them."""
    rel, abs_err, outs = 0.0, 0.0, []
    for args, kw in used:
        got_all, again, want_all = (
            as_tuple(f(*args, **kw)) for f in (real, real, plain))
        outs.append((args, kw, got_all))
        check(all(a is b is None or torch.equal(a, b)
                  for a, b in zip(got_all, again)),
              f"{name}: two launches on the same inputs differ")
        for got, want in zip(got_all, want_all):
            if got is None and want is None:  # an output not asked for
                continue
            d = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            check(math.isfinite(d), f"{name}: non-finite output")
            abs_err = max(abs_err, d)
            rel = max(rel, d / scale if scale > 0 else d)
    ms = sum(cuda_ms(torch, lambda a=a, k=k: real(*a, **k), 5)
             for a, k in used)
    dev = [sum(x) for x in zip(*(
        device_ms(torch, lambda a=a, k=k: real(*a, **k), 5)
        for a, k in used))]
    plain_ms = sum(cuda_ms(torch, lambda a=a, k=k: plain(*a, **k), 1)
                   for a, k in used)
    results[name] = dict(max_abs_err=abs_err, ms=ms, device_ms=dev[0],
                         device_ops_per_call=dev[1] / len(used),
                         plain_ms=plain_ms, library_ms=None,
                         **bound(torch, name, outs))
    del outs
    print(f"[kernel] {name}: max_abs_err {abs_err:.3e}, relative to the "
          f"plain output's max {rel:.3e} (limit {REPLAY_LIMITS[name]:.1e}) | "
          f"kernel {ms:.4f} ms back to back, {dev[0]:.4f} ms on the device "
          f"({dev[1]:g} device ops per call) | plain {plain_ms:.3f} ms | "
          f"bound {results[name]['bound_ms']:.4f} ms "
          f"({results[name]['bound_by']}) | {card}", flush=True)
    check(rel <= REPLAY_LIMITS[name],
          f"{name} disagrees with its plain version")


FIELDS = ("volume", "tf_table", "window_center", "window_width",
          "light_intensities")


def make_fwd_bwd_step(torch, vol, cam, transform, clip, width, height,
                      render_kw, **plan_kw):
    """An L2 fwd+bwd step of the lit frame of ``vol`` (one light, window
    width 0.8) through `render_lit_scene(**render_kw)` against its frame at
    window (0.5, 0.8): center -> (loss, gradient of each leaf, frame)."""
    from tbraymarcherplugin_tpu_torch.models import pipeline as PP
    from tbraymarcherplugin_tpu_torch.ops import shearwarp as SW
    from tbraymarcherplugin_tpu_torch.ops import transfer as T
    from tbraymarcherplugin_tpu_torch.ops.rays import setup_rays

    dims = tuple(vol.shape)
    dev = vol.device
    plan = SW.plan_shearwarp(cam, transform, dims, dims, width, height,
                             **plan_kw)
    rays = setup_rays(cam, transform, width, height)
    plans = (PP.LightPlan.create(LIGHT_DIR, dims),)

    def params(center):
        return PP.RenderParams(
            vol.detach(), T.tf_ct_bone(device=dev),
            torch.tensor(center, device=dev),
            torch.tensor(WINDOW[1], device=dev),
            torch.tensor([1.0], device=dev))

    def render(p):
        return PP.render_lit_scene(p, rays, clip.center, clip.direction,
                                   plans, dims, shearwarp_plan=plan,
                                   **render_kw)

    with torch.no_grad():
        target = render(params(WINDOW[0]))

    def step(center):
        p = params(center)
        for f in FIELDS:
            getattr(p, f).requires_grad_()
        img = render(p)
        loss = ((img - target) ** 2).mean()
        loss.backward()
        return (loss.detach(), [getattr(p, f).grad for f in FIELDS],
                img.detach())

    return step


def fwd_bwd_phase(torch, volume, cam, transform, clip, card, results):
    """Phase 5 (see the module docstring); adds K5-K8 to ``results``."""
    from tbraymarcherplugin_tpu_torch.ops import preshear as K12
    from tbraymarcherplugin_tpu_torch.ops import (shearwarp_grad, synthetic,
                                                  tf_alpha)

    def make_step(vol, width, height, dtype=None, **plan_kw):
        """An L2 fwd+bwd step of the lit frame of ``vol`` through the fused
        composite, planes stored as ``dtype`` (default: bf16 on the card);
        see `make_fwd_bwd_step`."""
        return make_fwd_bwd_step(
            torch, vol, cam, transform, clip, width, height,
            dict(march_impl="shearwarp", shearwarp_tf_unit="fused",
                 shearwarp_dtype=dtype), **plan_kw)

    table = [t for t in kernel_table() if t[0] in FWD_BWD]
    step = make_step(volume, WIDTH, HEIGHT, max_planes=STEPS)
    for _, mod, fn in table:
        getattr(mod, fn).launches = 0
    K12.preshear_adjoint.launches = 0
    outs, step_ms = [], []
    for c in FWD_BWD_CENTERS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # the last step's peak is kept
        before = torch.cuda.memory_allocated()
        out, ms = host_ms(torch, lambda c=c: step(c))
        outs.append(out)
        step_ms.append(ms)
    peak = (torch.cuda.max_memory_allocated() / 2**20, before / 2**20)
    launches = {name: getattr(mod, fn).launches for name, mod, fn in table}
    launches["preshear_adjoint"] = K12.preshear_adjoint.launches
    print(f"[fwd+bwd] launches {launches} | ms per step (host clock) "
          f"{', '.join(f'{m:.2f}' for m in step_ms)} | peak device memory "
          f"of the third step {peak[0]:.1f} MiB ({peak[1]:.1f} MiB "
          f"allocated before it) | {card}", flush=True)
    for name in launches:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the fwd+bwd path")
    # each step pre-shears the volume and the light, both leaves here
    for name in ("preshear", "preshear_adjoint"):
        results.setdefault(name, {})["fwd_bwd_launches"] = launches[name]
    keys = []
    for loss, grads, _ in outs:
        for f, g in zip(FIELDS, grads):
            check(g is not None and bool(torch.isfinite(g).all())
                  and bool((g != 0).any()), f"gradient of {f}: {g}")
        keys.append((float(loss), float(grads[1].abs().sum())))
    print(f"[fwd+bwd] (loss, sum |dTF|) per step: {keys}", flush=True)
    check(len(set(keys)) == len(keys), f"steps repeat: {keys}")

    # K5-K8 on the inputs the path gave them.
    calls = {}
    bwd = [t for t in table if t[0].endswith("_bwd")]
    with capture_calls(calls, [name for name, _, _ in bwd]):
        step(FWD_BWD_CENTERS[0])
    # the captured inputs are autograd intermediates: without no_grad the
    # plain versions would record a graph of every plane's temporaries
    with torch.no_grad():
        for name, mod, fn in bwd:
            # K6 runs once per warp pass (both are timed, as K2's); K7 and
            # K8 once per light face (the first face is timed, as K4's)
            used = calls[name] if name == "row_lerp_bwd" else calls[name][:1]
            replay(torch, name, getattr(mod, fn),
                       getattr(mod, fn + "_plain"), used, card, results)
            results[name]["launches"] = launches[name]
        # how K8's histogram adds cluster on the first face
        args, kw = calls["tf_alpha_bwd"][0]
        sums = {}
        tf_alpha.windowed_tf_alpha_bwd_plain(*args, **kw, stats=sums)
        results["tf_alpha_bwd"].update(histogram=sums)
        print(f"[kernel] tf_alpha_bwd adds on the first face: hit share "
              f"{sums['hit']:.4f} of {args[0].numel()} elements, rounds per "
              f"warp of 32 elements mean {sums['rounds_mean']:.2f}, max "
              f"{sums['rounds_max']}, mean run of equal texels along the "
              f"elements {sums['run_mean']:.2f}", flush=True)
        ops = results["tf_alpha_bwd"]["device_ops_per_call"]
        check(ops == 1, f"K8 took {ops:g} device operations for one call")
        row_lerp_bwd_library(torch, calls["row_lerp_bwd"], card, results)
        # how K5's histogram adds cluster on these inputs
        args, kw = calls["composite_bwd"][0]
        sums = {}
        shearwarp_grad.composite_bwd_plain(*args, **kw, stats=sums)
        st = shearwarp_grad.clustering_summary(sums)
        results["composite_bwd"].update(histogram=st,
                                        fused_step_peak_mib=peak[0])
        print(f"[kernel] composite_bwd adds: hit share {st['hit']:.4f} of "
              f"{sums['pixels']} (pixel, plane) pairs, rounds per warp of 32 "
              f"pixels and plane with a hit mean {st['rounds_mean']:.2f} "
              f"({sums['warps_hit']} such), max {st['rounds_max']}, mean run "
              f"of equal texels along a row {st['run_mean']:.2f}", flush=True)
        light_scan_bwd_faces(torch, calls["light_scan_bwd"][0], card,
                             results)
    del calls, args, kw

    # The gradients against the all-plain path on the card.
    with all_plain():
        _, want, _ = step(FWD_BWD_CENTERS[0])
    errs = {f: float((a - b).norm() / b.norm())
            for f, a, b in zip(FIELDS, outs[0][1], want)}
    print(f"[fwd+bwd] gradients vs all-plain path on the card, |d|_2 / "
          f"|plain|_2: {errs} (limit {GRAD_VS_PLAIN_LIMIT:.0e})", flush=True)
    check(max(errs.values()) <= GRAD_VS_PLAIN_LIMIT,
          "kernel gradients != plain gradients")
    del outs, want

    # Small scene, the card against the CPU: the image of the fwd+bwd path
    # with bf16 planes within phase 4's bounds; the gradients with float32
    # planes on both (bf16 values move by up to half a TF texel, which moves
    # a gradient by as much as the gradient itself).
    small = torch.from_numpy(synthetic.ct_like_phantom((24, 24, 24), seed=0))
    cpu = torch.device("cpu")
    card_bf16 = make_step(small.to(volume.device), 64, 48, max_planes=20)
    card_f32 = make_step(small.to(volume.device), 64, 48,
                         dtype=torch.float32, max_planes=20)
    on_cpu = make_step(small, 64, 48, max_planes=20)
    c0 = FWD_BWD_CENTERS[0]
    (_, _, img), (_, grads, _) = card_bf16(c0), card_f32(c0)
    _, want, want_img = on_cpu(c0)
    diff = (img.cpu() - want_img).abs()
    errs = {f: float((a.cpu() - b).norm() / b.norm())
            for f, a, b in zip(FIELDS, grads, want)}
    print(f"[small] fwd+bwd, card vs CPU at 24^3, 64x48: image (bf16 planes) "
          f"mean {float(diff.mean()):.2e} (limit {SMALL_MEAN_LIMIT:.0e}), max "
          f"{float(diff.max()):.2e} (limit {SMALL_MAX_LIMIT:.0e}); gradients "
          f"(float32 planes), |d|_2 / |CPU|_2: {errs} (limit "
          f"{GRAD_VS_PLAIN_LIMIT:.0e})", flush=True)
    check(float(diff.mean()) < SMALL_MEAN_LIMIT
          and float(diff.max()) < SMALL_MAX_LIMIT, "card != CPU on 24^3")
    check(max(errs.values()) <= GRAD_VS_PLAIN_LIMIT,
          "card gradients != CPU gradients on 24^3")


def light_scan_faces(torch, path_calls, card):
    """K4 as one device operation per call and exactly its plain version on
    the rebuild's faces (``path_calls``), on K7_FACES and on K4_LARGE;
    returns the device operations per call on the rebuild's faces."""
    from tbraymarcherplugin_tpu_torch.ops import light_scan as K4

    gen = torch.Generator(device="cuda").manual_seed(4)
    alpha = torch.tensor(0.7, device="cuda")
    faces = [(args, kw, "the rebuild's") for args, kw in path_calls]
    for shape, off in K7_FACES + (K4_LARGE,):
        op = torch.rand(shape, generator=gen, device="cuda") * 0.4
        faces.append(((op, *off, alpha), {}, "a"))
    path_ops = []
    for args, kw, whose in faces:
        got = K4.propagate_face_scan(*args, **kw)
        want = K4.propagate_face_scan_plain(*args, **kw)
        ms, n_ops = device_ms(
            torch, lambda: K4.propagate_face_scan(*args, **kw), 3)
        op = args[0]
        plan = K4.scan_plan(*op.shape, args[1], *K4.device_limits(op.device))
        print(f"[kernel] light_scan on {whose} {tuple(op.shape)} face, "
              f"offsets ({float(args[1]):.4f}, {float(args[2]):.4f}): exact "
              f"{torch.equal(got, want)} (limit 0) | {n_ops} device "
              f"operation per call, {ms:.4f} ms on the device | T "
              f"{plan.slices}, {plan.rows} rows a block, staged "
              f"{plan.staged}, {plan.threads} threads | {card}", flush=True)
        check(torch.equal(got, want),
              f"K4 != its plain version on a {tuple(op.shape)} face")
        check(n_ops == 1, f"K4 took {n_ops} device operations for one face")
        if whose != "a":
            path_ops.append(n_ops)
    return path_ops


def row_lerp_bwd_library(torch, used, card, results):
    """K6's yardstick `library_ms`: `grid_sampler_2d_backward`, the input
    gradient of K2's `grid_sample` call (`row_lerp_library_args`), on the
    warp passes' cotangents ``used``, against K6's plain version, timed."""
    from tbraymarcherplugin_tpu_torch.ops import warp

    fns, err = [], 0.0
    for args, kw in used:
        g, idx, n, groups = (*args, *kw.values())
        g = g.contiguous()
        rq, q = idx.shape
        inp, grid = row_lerp_library_args(
            torch, torch.empty((groups * rq, n), device=g.device), idx,
            groups)

        def lib(go=g.view(groups, 1, rq, q), inp=inp, grid=grid):
            return torch.ops.aten.grid_sampler_2d_backward(
                go, inp, grid, 0, 1, True, [True, False])[0]

        want = warp.row_lerp_bwd_plain(g, idx, n, groups)
        d = float((lib().reshape(want.shape) - want).abs().max())
        err = max(err, d / float(want.abs().max()))
        fns.append(lib)
    ms = sum(cuda_ms(torch, f, 5) for f in fns)
    dev = sum(device_ms(torch, f, 5)[0] for f in fns)
    results["row_lerp_bwd"].update(library_ms=ms, library_device_ms=dev)
    print(f"[kernel] row_lerp_bwd as grid_sampler_2d_backward (the input "
          f"gradient of K2's grid_sample): error against the plain version "
          f"over its largest value {err:.3e} (limit "
          f"{LIBRARY_LERP_BWD_LIMIT:.0e}) | {ms:.4f} ms back to back, "
          f"{dev:.4f} ms on the device, both passes | {card}", flush=True)
    check(err <= LIBRARY_LERP_BWD_LIMIT,
          "grid_sampler_2d_backward != the row lerp's adjoint")


def light_scan_bwd_faces(torch, path_call, card, results):
    """K7 as one device kernel per call on the path's face, exactly its
    plain version on K7_FACES and K7_LARGE, with its time and bound on
    K7_LARGE's first face."""
    from tbraymarcherplugin_tpu_torch.ops import light_scan as K4

    args, kw = path_call
    _, n_path = device_ms(torch, lambda: K4.propagate_face_scan_bwd(*args,
                                                                    **kw), 3)
    # the wrapper makes a strided cotangent contiguous first (a copy)
    args = tuple(a.contiguous() if isinstance(a, torch.Tensor) else a
                 for a in args)
    _, n_ops = device_ms(torch, lambda: K4.propagate_face_scan_bwd(*args,
                                                                   **kw), 3)
    print(f"[kernel] light_scan_bwd: {n_ops} device operation per call on "
          f"the path's {tuple(args[1].shape)} face, contiguous ({n_path} with "
          f"the path's own cotangent)", flush=True)
    check(n_ops == 1, f"K7 took {n_ops} device operations for one face")
    gen = torch.Generator(device="cuda").manual_seed(8)
    alpha = torch.tensor(0.7, device="cuda")
    for shape, off in K7_FACES + K7_LARGE:
        op = torch.rand(shape, generator=gen, device="cuda") * 0.4
        g = torch.randn(shape, generator=gen, device="cuda")
        y = K4.propagate_face_scan(op, *off, alpha)
        got = K4.propagate_face_scan_bwd(g, op, y, *off, alpha)
        want = K4.propagate_face_scan_bwd_plain(g, op, y, *off, alpha)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        call = (lambda: K4.propagate_face_scan_bwd(g, op, y, *off, alpha))
        ms, n_ops = device_ms(torch, call, 3)
        route = K4.scan_bwd_route(*shape[1:], op.device)
        timed = ""
        if (shape, off) == K7_LARGE[0]:
            big = dict(shape=list(shape), device_ms=ms,
                       ms=cuda_ms(torch, call, 3),
                       plain_ms=cuda_ms(torch, lambda: K4.
                                        propagate_face_scan_bwd_plain(
                                            g, op, y, *off, alpha), 1),
                       route=route,
                       **bound(torch, "light_scan_bwd",
                               [((g, op, y, alpha), {}, got)]))
            results["light_scan_bwd"]["large_face"] = big
            timed = (f" | kernel {big['ms']:.4f} ms back to back | plain "
                     f"{big['plain_ms']:.3f} ms | bound "
                     f"{big['bound_ms']:.4f} ms ({big['bound_by']})")
        print(f"[kernel] light_scan_bwd on a {shape} face, offsets {off}, "
              f"route {route}: max_abs_err {err:.3e} (limit 0) | {ms:.4f} ms "
              f"on the device, {n_ops} device operations per call{timed} | "
              f"{card}", flush=True)
        check(err == 0.0, f"K7 != its plain version on a {shape} face")
        check(n_ops == 1, f"K7 took {n_ops} device operations for one face")
        del op, g, y, got, want


def march_phase(torch, volume, tf, windowing, light, cam, transform, card,
                results):
    """Phase 6 (see the module docstring); adds K9 to ``results``."""
    from tbraymarcherplugin_tpu_torch.models import pipeline as PP
    from tbraymarcherplugin_tpu_torch.ops import composite as K1
    from tbraymarcherplugin_tpu_torch import renderer as R
    from tbraymarcherplugin_tpu_torch.ops import fused_march as K9
    from tbraymarcherplugin_tpu_torch.ops import octree as O
    from tbraymarcherplugin_tpu_torch.ops import synthetic
    from tbraymarcherplugin_tpu_torch.ops import transfer as T
    from tbraymarcherplugin_tpu_torch.ops.rays import setup_rays
    from tbraymarcherplugin_tpu_torch.renderer import Renderer, RendererConfig
    from tbraymarcherplugin_tpu_torch.scene import Camera, ClipPlane

    dev = volume.device

    def make_renderer(vol=volume, table=tf, steps=STEPS, **cfg):
        r = Renderer(vol, tf_table=table, windowing=windowing,
                     transform=transform,
                     config=RendererConfig(step_count=steps, jitter=True,
                                           **cfg),
                     device=vol.device)
        r.add_light("sun", light)
        return r

    cams = [Camera.look_at(tuple(p + i * d for p, d in zip(FLY_POS, FLY_STEP)),
                           (0.0, 0.0, 0.0), fov_degrees=FLY_FOV)
            for i in range(4)]
    r = make_renderer()
    r.ensure_lighting()
    # the occupancy grid K9 skips empty space by, built once per volume,
    # window and TF (the second fly-through frame would build it)
    occ, grid_ms = host_ms(torch, r.occupancy)
    win = windowing.as_vec4(dev)
    # a new volume builds the octree and the grid; a new window or TF the
    # grid alone
    octree_dev, _ = device_ms(
        torch, lambda: O.build_octree(volume, max_value=1.0), 3)
    grid_dev, _ = device_ms(torch, lambda: O.occupancy_grid(
        r.octree, win, tf, mip=R.OCCUPANCY_MIP), 3)
    K1.composite.launches = 0
    K9.march_lit_fused.launches = 0
    frames, frame_ms = [], []
    for c in cams:
        img, ms = host_ms(torch, lambda c=c: r.render(c, WIDTH, HEIGHT))
        frames.append(img)
        frame_ms.append(ms)
    launches = {"march": K9.march_lit_fused.launches,
                "composite": K1.composite.launches}
    print(f"[march] fly-through launches {launches} | frames "
          f"{', '.join(f'{m:.2f}' for m in frame_ms)} ms (host clock) | "
          f"occupancy grid {tuple(occ.grid.shape)} "
          f"({float(occ.grid.float().mean()):.3f} occupied) built in "
          f"{grid_ms:.2f} ms (host clock); on the device the octree "
          f"{octree_dev:.4f} ms, the grid from it {grid_dev:.4f} ms | "
          f"{card}", flush=True)
    check(r._sw_plan is None, "the fly-through camera has a shear-warp plan")
    check(launches["march"] > 0, "kernel march was not launched by the march "
          "path")
    check(launches["composite"] == 0, "the march path launched K1")
    results["march"] = dict(launches=launches["march"])
    sums, covers = [], []
    for f in frames:
        check(tuple(f.shape) == (HEIGHT, WIDTH, 4), f"frame shape {f.shape}")
        check(bool(torch.isfinite(f).all()), "non-finite frame")
        covers.append(float((f[..., 3] > 0.01).float().mean()))
        check(covers[-1] > 0.05, f"alpha coverage {covers[-1]:.3f} too small")
        sums.append(float(f.double().sum()))
    check(len(set(sums)) == len(sums), f"frame checksums repeat: {sums}")
    del frames

    # K9 against its plain version on the path's inputs, at the fly-through
    # camera and at the bench camera forced to march
    timed = {}
    for label, rend, c in (("fly-through", r, cams[0]),
                           ("bench camera", make_renderer(
                               march_impl="pallas"), cam)):
        calls = {}
        rend.occupancy()  # as from its second frame on
        with capture_calls(calls, ["march"]):
            rend.render(c, WIDTH, HEIGHT)
        (args, kw), = calls["march"]
        got = K9.march_lit_fused(*args, **kw)
        stats = {}  # the steps and samples the kernel's rays take
        want = K9.march_lit_fused_plain(*args, **kw, stats=stats)
        d = (got - want).abs()
        err = float(d.max())
        check(math.isfinite(err), "march: non-finite output")
        flips = int((d[..., 3] > 0.5).sum())  # early-termination flips
        ms = cuda_ms(torch, lambda: K9.march_lit_fused(*args, **kw), 5)
        dev_ms, _ = device_ms(torch, lambda: K9.march_lit_fused(*args, **kw),
                              5)
        plain_ms = cuda_ms(torch, lambda: K9.march_lit_fused_plain(*args,
                                                                    **kw), 1)
        timed[label] = (err, ms, plain_ms,
                        march_bound(torch, args, kw, got, stats), dev_ms)
        print(f"[kernel] march ({label}): max_abs_err {err:.3e} (limit "
              f"{LIMITS['march']:.0e}), pixels whose snap flipped {flips} | "
              f"kernel {ms:.3f} ms back to back, {dev_ms:.3f} ms on the "
              f"device | plain {plain_ms:.3f} ms | bound "
              f"{timed[label][3]['bound_ms']:.4f} ms "
              f"({timed[label][3]['bound_by']}; {stats['steps']} steps, "
              f"{stats['samples']} samples neither clipped nor cut, "
              f"{stats['shaded']} of them of alpha above 0, over "
              f"{got[..., 0].numel()} rays; the first designs' bound "
              f"{timed[label][3]['old_bound_ms']:.4f} ms) | coverage "
              f"{float((want[..., 3] > 0.01).float().mean()):.3f} | {card}",
              flush=True)
        print(f"[kernel] march ({label}) warps of 8x4 rays: "
              f"{stats['warp_steps'] / stats['steps']:.3f} lane slots per "
              f"step (the longest ray of each warp), "
              f"{stats['samples'] / stats['warp_steps']:.3f} of them shade; "
              f"steps fetched {stats['fetches'] / stats['steps']:.3f} "
              f"({stats['warp_fetches'] / stats['steps']:.3f} in lane "
              f"slots), in empty cells "
              f"{stats.get('empty', 0) / stats['steps']:.3f}, cut "
              f"{stats['cut'] / stats['steps']:.3f}, alpha 0 "
              f"{stats['zero_alpha'] / stats['steps']:.3f}", flush=True)
        results["march"].setdefault("work", {})[label] = stats
        check(err <= LIMITS["march"], "march disagrees with its plain version")
        del calls, args, kw, got, want, d
    err, ms, plain_ms, bnd, dev_ms = timed["fly-through"]
    results["march"].update(max_abs_err=max(t[0] for t in timed.values()),
                            ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                            library_ms=None, **bnd)

    # empty-space skipping changes no bit of the frame (frame index 0)
    bare = make_renderer(empty_space_skipping=False).render(cams[0], WIDTH,
                                                            HEIGHT)
    skip = make_renderer()
    skip.occupancy()
    skip = skip.render(cams[0], WIDTH, HEIGHT)
    same = torch.equal(bare, skip)
    print(f"[march] fly-through frame with empty-space skipping against one "
          f"without: same bits {same}", flush=True)
    check(same, "empty-space skipping changed the fly-through frame")
    del bare, skip

    # the frame against the all-plain path (frame index 0 in both)
    rp = make_renderer()
    with all_plain():
        ref = rp.render(cams[0], WIDTH, HEIGHT)
    got = make_renderer().render(cams[0], WIDTH, HEIGHT)
    frame_err = float((got - ref).abs().max())
    print(f"[march] fly-through frame vs all-plain path on the card: "
          f"max_abs_err {frame_err:.3e} (limit {FRAME_VS_PLAIN_LIMIT:.0e}) | "
          f"coverage {', '.join(f'{x:.3f}' for x in covers)} | checksums "
          f"{', '.join(f'{x:.1f}' for x in sums)}", flush=True)
    check(frame_err <= FRAME_VS_PLAIN_LIMIT, "kernel frame != plain frame")
    del rp, ref, got

    # back outside: the shear-warp plan and K1 again, no K9
    K1.composite.launches = 0
    K9.march_lit_fused.launches = 0
    r.render(cam, WIDTH, HEIGHT)
    check(r._sw_plan is not None and K1.composite.launches > 0
          and K9.march_lit_fused.launches == 0,
          "the frame back outside did not take shear-warp (K1)")
    del r

    # 24^3 inside the volume: a march frame on the card against the CPU
    small = torch.from_numpy(synthetic.ct_like_phantom((24, 24, 24), seed=0))
    imgs = [make_renderer(small.to(d), T.tf_ct_bone(device=d), 20)
            .render(cams[0], 64, 48).cpu() for d in (dev, torch.device("cpu"))]
    small_err = float((imgs[0] - imgs[1]).abs().max())

    # ... and a small fwd+bwd through the blocked march
    dims = (24, 24, 24)
    rays = {d: setup_rays(cams[0], transform, 64, 48, device=d)
            for d in (dev, torch.device("cpu"))}
    clip = transform.local_clip_plane(ClipPlane.disabled())
    plans = (PP.LightPlan.create(LIGHT_DIR, dims),)
    grads = []
    for d in (dev, torch.device("cpu")):
        p = PP.RenderParams(small.to(d), T.tf_ct_bone(device=d),
                            torch.tensor(0.55, device=d),
                            torch.tensor(WINDOW[1], device=d),
                            torch.tensor([1.0], device=d))
        for f in FIELDS:
            getattr(p, f).requires_grad_()
        img = PP.render_lit_scene(p, rays[d], clip.center, clip.direction,
                                  plans, dims, step_count=20,
                                  march_impl="blocked")
        (img ** 2).mean().backward()
        grads.append([getattr(p, f).grad.cpu() for f in FIELDS])
    errs = {f: float((a - b).norm() / b.norm())
            for f, a, b in zip(FIELDS, *grads)}
    print(f"[small] march at 24^3, 64x48, inside: frame card vs CPU max "
          f"{small_err:.2e} (limit {SMALL_MARCH_LIMIT:.0e}); blocked-march "
          f"fwd+bwd gradients, |d|_2 / |CPU|_2: {errs} (limit "
          f"{GRAD_VS_PLAIN_LIMIT:.0e})", flush=True)
    check(small_err <= SMALL_MARCH_LIMIT, "march frame: card != CPU on 24^3")
    check(all(g.abs().max() > 0 for g in grads[1]), "a zero CPU gradient")
    check(max(errs.values()) <= GRAD_VS_PLAIN_LIMIT,
          "blocked-march gradients: card != CPU on 24^3")


def dense_phase(torch, volume, cam, transform, clip, card, results):
    """Phase 7 (see the module docstring); adds K10a and K10b to
    ``results``."""
    from tbraymarcherplugin_tpu_torch.ops import synthetic
    from tbraymarcherplugin_tpu_torch.ops import tf_rgba as K10

    def dense_step(vol, width, height, tf_unit="pallas",
                   dtype=torch.float32, **plan_kw):
        return make_fwd_bwd_step(
            torch, vol, cam, transform, clip, width, height,
            dict(march_impl="shearwarp", shearwarp_tf_unit=tf_unit,
                 shearwarp_dtype=dtype), **plan_kw)

    # every kernel of the dense fwd+bwd: the illumination's K3/K4 and their
    # backward K7/K8, and the TF unit's K10a/K10b
    path = ("occluder", "light_scan", "light_scan_bwd", "tf_alpha_bwd",
            "tf_rgba", "tf_rgba_bwd")
    table = [t for t in kernel_table() if t[0] in path]
    step = dense_step(volume, WIDTH, HEIGHT, max_planes=STEPS)
    for _, mod, fn in kernel_table():
        getattr(mod, fn).launches = 0
    torch.cuda.reset_peak_memory_stats()
    outs, step_ms = [], []
    for c in FWD_BWD_CENTERS:
        out, ms = host_ms(torch, lambda c=c: step(c))
        outs.append(out)
        step_ms.append(ms)
    launches = {name: getattr(mod, fn).launches for name, mod, fn in table}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[dense] launches {launches} | ms per step (host clock) "
          f"{', '.join(f'{m:.2f}' for m in step_ms)} | peak memory of the "
          f"three steps {peak:.2f} GiB (the volume and earlier phases' "
          f"live tensors included) | {card}", flush=True)
    for name in path:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the dense fwd+bwd path")
    keys = []
    for loss, grads, _ in outs:
        for f, g in zip(FIELDS, grads):
            check(g is not None and bool(torch.isfinite(g).all())
                  and bool((g != 0).any()), f"gradient of {f}: {g}")
        keys.append((float(loss), float(grads[1].abs().sum())))
    print(f"[dense] (loss, sum |dTF|) per step: {keys}", flush=True)
    check(len(set(keys)) == len(keys), f"steps repeat: {keys}")

    # K10a and K10b on the inputs the path gave them (the first block)
    calls = {}
    with capture_calls(calls, ["tf_rgba", "tf_rgba_bwd"]):
        step(FWD_BWD_CENTERS[0])
    with torch.no_grad():
        for name in ("tf_rgba", "tf_rgba_bwd"):
            _, mod, fn = next(t for t in table if t[0] == name)
            replay(torch, name, getattr(mod, fn),
                   getattr(mod, fn + "_plain"), calls[name][:1], card,
                   results)
            results[name]["launches"] = launches[name]
        # how K10b's histogram adds cluster on each block's inputs; the
        # first block (timed above) is all outside the volume's footprint,
        # so the block with the most hits is timed and checked as well
        blocks = []
        for args, kw in calls["tf_rgba_bwd"]:  # one step's blocks
            stats = {}
            K10.windowed_tf_rgba_bwd_plain(*args, **kw, stats=stats)
            blocks.append(stats)
        busy = max(range(len(blocks)), key=lambda b: blocks[b]["hit"])
        row = results["tf_rgba_bwd"]
        row["histogram"] = dict(first=blocks[0], busiest=blocks[busy],
                                busiest_index=busy)
        for label, b in (("first", 0), ("busiest", busy)):
            st = blocks[b]
            print(f"[kernel] tf_rgba_bwd, {label} block ({b} of "
                  f"{len(blocks)}): hit share {st['hit']:.4f}, rounds per "
                  f"warp of 32 elements mean {st['rounds_mean']:.2f}, max "
                  f"{st['rounds_max']}, mean run of equal texels "
                  f"{st['run_mean']:.2f}", flush=True)
        busiest = {}
        replay(torch, "tf_rgba_bwd", K10.windowed_tf_rgba_bwd,
               K10.windowed_tf_rgba_bwd_plain,
               calls["tf_rgba_bwd"][busy:busy + 1], card, busiest)
        row["histogram"].update(
            {k: busiest["tf_rgba_bwd"][k]
             for k in ("ms", "device_ms", "max_abs_err")})
    del calls

    # the "pallas" unit against the "xla" unit (plain PyTorch) on the card,
    # and, as a control the limits must see, the "pallas" unit on bfloat16
    # planes against the same
    _, want, want_img = dense_step(volume, WIDTH, HEIGHT, "xla",
                                   max_planes=STEPS)(FWD_BWD_CENTERS[0])
    _, bf_grads, bf_img = dense_step(volume, WIDTH, HEIGHT,
                                     dtype=torch.bfloat16,
                                     max_planes=STEPS)(FWD_BWD_CENTERS[0])
    read = {}
    for label, img, grads in (("pallas", outs[0][2], outs[0][1]),
                              ("bf16 control", bf_img, bf_grads)):
        read[label] = (
            float((img - want_img).norm() / want_img.norm()),
            {f: float((a - b).norm() / b.norm())
             for f, a, b in zip(FIELDS, grads, want)})
        print(f"[dense] {label} vs \"xla\" TF unit on the card, |d|_2 / "
              f"|xla|_2: image {read[label][0]:.2e} (limit "
              f"{DENSE_IMAGE_LIMIT:.0e}), gradients {read[label][1]} (limit "
              f"{DENSE_GRAD_LIMIT:.0e})", flush=True)
    img_err, errs = read["pallas"]
    check(img_err <= DENSE_IMAGE_LIMIT, "dense image: pallas != xla unit")
    check(max(errs.values()) <= DENSE_GRAD_LIMIT,
          "dense gradients: pallas != xla unit")
    img_err, errs = read["bf16 control"]
    check(img_err > DENSE_IMAGE_LIMIT and max(errs.values()) > DENSE_GRAD_LIMIT,
          "the dense limits do not tell bfloat16 planes from float32")
    del outs, want, want_img, bf_grads, bf_img

    # small scene, the card against the CPU (float32 planes on both)
    small = torch.from_numpy(synthetic.ct_like_phantom((24, 24, 24), seed=0))
    c0 = FWD_BWD_CENTERS[0]
    _, grads, img = dense_step(small.to(volume.device), 64, 48,
                               max_planes=20)(c0)
    _, want, want_img = dense_step(small, 64, 48, max_planes=20)(c0)
    img_err = float((img.cpu() - want_img).norm() / want_img.norm())
    errs = {f: float((a.cpu() - b).norm() / b.norm())
            for f, a, b in zip(FIELDS, grads, want)}
    print(f"[small] dense fwd+bwd, card vs CPU at 24^3, 64x48, |d|_2 / "
          f"|CPU|_2: image {img_err:.2e} (limit {DENSE_IMAGE_LIMIT:.0e}), "
          f"gradients {errs} (limit {DENSE_GRAD_LIMIT:.0e})", flush=True)
    check(img_err <= DENSE_IMAGE_LIMIT, "dense image: card != CPU on 24^3")
    check(max(errs.values()) <= DENSE_GRAD_LIMIT,
          "dense gradients: card != CPU on 24^3")


def fit_phase(torch, volume, cam, transform, clip, card):
    """Phase 8 (see the module docstring)."""
    import tempfile

    from tbraymarcherplugin_tpu_torch.models import pipeline as PP
    from tbraymarcherplugin_tpu_torch.models.fitting import FitConfig, fit
    from tbraymarcherplugin_tpu_torch.ops import shearwarp as SW
    from tbraymarcherplugin_tpu_torch.ops import transfer as T
    from tbraymarcherplugin_tpu_torch.ops.rays import setup_rays
    from tbraymarcherplugin_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    dev = volume.device
    plan = SW.plan_shearwarp(cam, transform, DIMS, DIMS, WIDTH, HEIGHT,
                             max_planes=STEPS)
    rays = setup_rays(cam, transform, WIDTH, HEIGHT)
    plans = (PP.LightPlan.create(LIGHT_DIR, DIMS),)

    def params(center):
        return PP.RenderParams(volume, T.tf_ct_bone(device=dev),
                               torch.tensor(center, device=dev),
                               torch.tensor(WINDOW[1], device=dev),
                               torch.tensor([1.0], device=dev))

    cfg = FitConfig(steps=FIT_STEPS, march_impl="shearwarp",
                    shearwarp_plan=plan)
    with torch.no_grad():  # the fit's own forward: its optimum is exact
        target = PP.render_lit_scene(params(WINDOW[0]), rays, clip.center,
                                     clip.direction, plans, DIMS,
                                     march_impl="shearwarp",
                                     shearwarp_plan=plan)
    path = ("occluder", "light_scan", "light_scan_bwd", "tf_alpha_bwd")
    table = [t for t in kernel_table() if t[0] in path]
    with tempfile.TemporaryDirectory() as ckpt:
        for _, mod, fn in kernel_table():
            getattr(mod, fn).launches = 0
        fitted, losses, metrics = fit(
            params(FIT_START_CENTER), rays, target, clip.center,
            clip.direction, plans, DIMS, cfg, return_metrics=True,
            checkpoint_dir=ckpt)
        launches = {name: getattr(mod, fn).launches for name, mod, fn in table}
        mgr = CheckpointManager(ckpt)
        (saved, _), meta = mgr.restore((params(0.0), None))
        steps = mgr.all_steps()
    step_ms = ", ".join(f"{m['ms_per_step']:.2f}" for m in metrics)
    print(f"[fit] {FIT_STEPS} steps from window center {FIT_START_CENTER} "
          f"(dense composite, \"xla\" TF unit): losses {losses} | window "
          f"center {float(fitted.window_center.detach()):.4f} | ms per step (host "
          f"clock) {step_ms} | "
          f"launches {launches} | checkpoints {steps} | {card}", flush=True)
    check(all(math.isfinite(x) for x in losses), f"fit losses {losses}")
    check(losses[-1] < losses[0], f"the fit did not descend: {losses}")
    for name in path:
        check(launches[name] > 0, f"kernel {name} was not launched by fit")
    check(meta["step"] == FIT_STEPS - 1 and steps[-1] == FIT_STEPS - 1,
          f"checkpoints {steps}")
    for f in FIELDS:
        got, want = getattr(saved, f), getattr(fitted, f)
        check(got.device == want.device and torch.equal(got, want.detach()),
              f"restored {f} differs from the fitted leaf")


def gather_phase(torch, card, results):
    """Phase 9 (see the module docstring); adds K11 to ``results``."""
    from tbraymarcherplugin_tpu_torch.tools import micro

    micro.gather_probe.launches = 0
    check(micro.main() == 0, "the gather probe tool failed")
    launches = micro.gather_probe.launches
    check(launches > 0, "kernel gather_probe was not launched by the tool")
    tab, idx = micro.probe_inputs(torch.device("cuda", 0))
    got = micro.gather_probe(tab, idx)
    want = micro.gather_probe_plain(tab, idx)
    check(torch.equal(got, want), "gather_probe != tab[idx]")
    flat = idx.view(-1)
    ms = cuda_ms(torch, lambda: micro.gather_probe(tab, idx), 50)
    dev_ms, _ = device_ms(torch, lambda: micro.gather_probe(tab, idx), 50)
    plain_ms = cuda_ms(torch, lambda: micro.gather_probe_plain(tab, idx), 50)
    library_ms = cuda_ms(torch, lambda: torch.index_select(tab, 0, flat), 50)
    lib_dev_ms, _ = device_ms(torch, lambda: torch.index_select(tab, 0, flat),
                              50)
    results["gather_probe"] = dict(
        launches=launches, max_abs_err=float((got - want).abs().max()), ms=ms,
        device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
        library_device_ms=lib_dev_ms,
        **bound(torch, "gather_probe", [((tab, idx), {}, got)]))
    n = idx.numel()
    print(f"[gather] launches {launches} | exact | kernel {ms:.4f} ms back to "
          f"back ({n / ms / 1e6:.2f} G gathers/s), {dev_ms:.4f} ms on the "
          f"device | tab[idx.long()] {plain_ms:.4f} ms | index_select "
          f"{library_ms:.4f} ms back to back, {lib_dev_ms:.4f} ms on the "
          f"device | bound {results['gather_probe']['bound_ms']:.4f} ms | "
          f"{card}", flush=True)


def modes_phase(torch, volume, tf, windowing, light, cam, transform, card,
                results):
    """Phase 10 (see the module docstring); adds K1's intensity, unlit and
    λ-ceiling variants to ``results``."""
    from tbraymarcherplugin_tpu_torch.ops import composite as K1
    from tbraymarcherplugin_tpu_torch.ops import synthetic
    from tbraymarcherplugin_tpu_torch.ops import transfer as T
    from tbraymarcherplugin_tpu_torch.ops import warp as K2
    from tbraymarcherplugin_tpu_torch.ops.rays import scene_depth_from_plane
    from tbraymarcherplugin_tpu_torch.renderer import Renderer, RendererConfig
    from tbraymarcherplugin_tpu_torch.scene import Camera, orbit_camera

    dev = volume.device

    def make_renderer(mode, vol=volume, table=tf, steps=STEPS):
        r = Renderer(vol, tf_table=table, windowing=windowing,
                     transform=transform,
                     config=RendererConfig(step_count=steps, jitter=True,
                                           render_mode=mode),
                     device=vol.device)
        r.add_light("sun", light)
        return r

    def depth_map(c, width, height, d):
        return scene_depth_from_plane(c, transform, width, height,
                                      *DEPTH_PLANE, device=d)

    radius = math.hypot(CAM_POS[0], CAM_POS[1])
    angle0 = math.atan2(CAM_POS[1], CAM_POS[0])
    cams = [orbit_camera(angle0 + 0.2 * i, radius, CAM_POS[2],
                         fov_degrees=FOV) for i in range(4)]
    depth = depth_map(cams[0], WIDTH, HEIGHT, dev)
    rends = {mode: make_renderer(mode) for mode in ("intensity", "octree")}
    rends["lit"] = make_renderer("lit")
    rends["lit"].ensure_lighting()  # the illumination is not this phase's
    variants = ("composite_intensity", "composite_unlit", "composite_depth")
    K1.composite.launches = 0
    K1.composite.variant_launches.clear()
    K2.row_lerp.launches = 0
    frames, frame_ms = {}, {}
    for mode in ("intensity", "octree"):
        for c in cams:
            img, ms = host_ms(torch, lambda c=c: rends[mode].render(
                c, WIDTH, HEIGHT))
            frames.setdefault(mode, []).append(img)
            frame_ms.setdefault(mode, []).append(ms)
    img, ms = host_ms(torch, lambda: rends["lit"].render(
        cams[0], WIDTH, HEIGHT, scene_depth=depth))
    frames["lit, depth"], frame_ms["lit, depth"] = [img], [ms]
    launches = dict(K1.composite.variant_launches)
    launches["row_lerp"] = K2.row_lerp.launches
    times = " | ".join(f"{m}: {', '.join(f'{x:.2f}' for x in v)}"
                       for m, v in frame_ms.items())
    print(f"[modes] launches {launches} | ms per frame (host clock) {times} "
          f"| {card}", flush=True)
    for name in variants + ("row_lerp",):
        check(launches.get(name, 0) > 0,
              f"kernel {name} was not launched by the modes path")
    check(launches.get("composite", 0) == 0, "the modes path launched K1 "
          "in lit mode without its depth ceiling")
    for name in variants:
        results[name] = dict(launches=launches[name])
    sums, covers = [], {}
    for mode, fs in frames.items():
        for f in fs:
            check(tuple(f.shape) == (HEIGHT, WIDTH, 4),
                  f"{mode} frame shape {f.shape}")
            check(bool(torch.isfinite(f).all()), f"non-finite {mode} frame")
            cover = float((f[..., 3] > 0.01).float().mean())
            check(cover > 0.05, f"{mode}: alpha coverage {cover:.3f}")
            covers.setdefault(mode, []).append(cover)
            sums.append(float(f.double().sum()))
    check(len(set(sums)) == len(sums), f"frame checksums repeat: {sums}")
    check(rends["octree"].octree is not None
          and rends["intensity"].octree is None, "octree pyramid use")

    # the depth frame against the same frame (jitter of frame 0) without
    # the plane
    no_depth = make_renderer("lit").render(cams[0], WIDTH, HEIGHT)
    a_depth = float(frames["lit, depth"][0][..., 3].sum())
    a_full = float(no_depth[..., 3].sum())
    print(f"[modes] alpha sum with the depth plane {a_depth:.1f}, without "
          f"{a_full:.1f} | coverage {covers} | checksums "
          f"{', '.join(f'{x:.1f}' for x in sums)}", flush=True)
    check(a_depth < 0.95 * a_full, "the depth plane removed no alpha")
    del frames, no_depth

    # each variant against its plain version on the path's own inputs
    for mode, name, kw in (("intensity", "composite_intensity", {}),
                           ("octree", "composite_unlit", {}),
                           ("lit", "composite_depth",
                            dict(scene_depth=depth))):
        calls = {}
        with capture_calls(calls, ["composite"]):
            make_renderer(mode).render(cams[0], WIDTH, HEIGHT, **kw)
        (args, ckw), = calls["composite"]
        check(K1.variant(ckw.get("mode", "lit"), ckw.get("depth_lam"))
              == name, f"{name}: the path called another variant")
        got = K1.composite(*args, **ckw)
        stats = {}  # the work the kernel's threads do on these inputs
        want = K1.composite_plain(*args, **ckw, stats=stats)
        err = float((got - want).abs().max())
        check(math.isfinite(err), f"{name}: non-finite output")
        ms = cuda_ms(torch, lambda: K1.composite(*args, **ckw), 10)
        dev_ms, _ = device_ms(torch, lambda: K1.composite(*args, **ckw), 10)
        plain_ms = cuda_ms(torch, lambda: K1.composite_plain(*args, **ckw),
                           1)
        bnd = composite_bound(torch, ckw, got, stats)
        results[name].update(max_abs_err=err, ms=ms, device_ms=dev_ms,
                             plain_ms=plain_ms, library_ms=None, **bnd)
        print(f"[kernel] {name}: max_abs_err {err:.3e} (limit "
              f"{LIMITS['composite']:.0e}) | kernel {ms:.4f} ms back to "
              f"back, {dev_ms:.4f} ms on the device | plain "
              f"{plain_ms:.3f} ms | bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}; the first design's "
              f"{bnd['old_bound_ms']:.4f} ms; {stats} over "
              f"{got[0].numel()} pixels, "
              f"K={ckw['k_real']}) | {card}", flush=True)
        check(err <= LIMITS["composite"],
              f"{name} disagrees with its plain version")
        del calls, args, ckw, got, want

    # the frames against the all-plain path on the card (frame index 0)
    errs = {}
    for mode, kw in (("intensity", {}), ("octree", {}),
                     ("lit", dict(scene_depth=depth))):
        with all_plain():
            ref = make_renderer(mode).render(cams[0], WIDTH, HEIGHT, **kw)
        got = make_renderer(mode).render(cams[0], WIDTH, HEIGHT, **kw)
        errs[mode] = float((got - ref).abs().max())
    print(f"[modes] frames vs all-plain path on the card: max_abs_err "
          f"{errs} (limit {FRAME_VS_PLAIN_LIMIT:.0e})", flush=True)
    check(max(errs.values()) <= FRAME_VS_PLAIN_LIMIT,
          "kernel frames != plain frames")

    # the camera inside the volume: no plan, each mode's march, timed
    fly = Camera.look_at(FLY_POS, (0.0, 0.0, 0.0), fov_degrees=FLY_FOV)
    K1.composite.launches = 0
    march = {}
    for mode in ("intensity", "octree"):
        r = make_renderer(mode)
        img, ms = host_ms(torch, lambda r=r: r.render(fly, WIDTH, HEIGHT))
        check(r._sw_plan is None and bool(torch.isfinite(img).all()),
              f"{mode}: the fly-through frame did not march")
        march[mode] = (ms, float((img[..., 3] > 0.01).float().mean()))
    check(K1.composite.launches == 0, "a march frame launched K1")
    print(f"[modes] march fallback (camera inside), ms (host clock) and "
          f"coverage: {march} | {card}", flush=True)

    # 24^3, the card (bf16 planes) against the CPU (float32)
    small = synthetic.ct_like_phantom((24, 24, 24), seed=0)
    diffs = {}
    for mode in ("intensity", "octree", "lit"):
        imgs = []
        for d in (dev, torch.device("cpu")):
            r = make_renderer(mode, torch.from_numpy(small).to(d),
                              T.tf_ct_bone(device=d), 20)
            kw = {} if mode != "lit" else dict(
                scene_depth=depth_map(cam, 64, 48, d))
            imgs.append(r.render(cam, 64, 48, **kw).cpu())
        diff = (imgs[0] - imgs[1]).abs()
        diffs[mode] = (float(diff.mean()), float(diff.max()))
    print(f"[small] modes, card vs CPU at 24^3, 64x48, (mean, max): {diffs} "
          f"(limits {SMALL_MEAN_LIMIT:.0e}, {SMALL_MAX_LIMIT:.0e})",
          flush=True)
    check(all(m < SMALL_MEAN_LIMIT and x < SMALL_MAX_LIMIT
              for m, x in diffs.values()), "mode frames: card != CPU on 24^3")


def sdf_rays(torch, n, dev):
    """(n, n) rays of the SDF demo: UVW entries on the volume's top face
    (y = 1), marching straight down."""
    u = torch.linspace(0.0, 1.0, n, device=dev)
    uu, ww = torch.meshgrid(u, u, indexing="ij")
    entry = torch.stack([uu, torch.ones_like(uu), ww], dim=-1)
    direction = torch.tensor([0.0, -1.0, 0.0], device=dev).expand_as(entry)
    return entry, direction


def write_series(np, hu, folder):
    """``hu`` (X, Y, Z) int16 as one DICOM file a slice: slice k (rows Y,
    columns X) with InstanceNumber k + 1 in the file whose name sorts
    255 - k, so the loader's sort by InstanceNumber undoes the file order."""
    import os

    from tbraymarcherplugin_tpu_torch.io import minidicom

    n = hu.shape[2]
    for k in range(n):
        minidicom.write_dicom(os.path.join(folder, f"{n - 1 - k:04d}.dcm"), {
            "SOPInstanceUID": f"1.2.826.0.1.11.{k}",
            "SeriesInstanceUID": "1.2.826.0.1.11",
            "Modality": "CT",
            "InstanceNumber": k + 1,
            "ImagePositionPatient": [0.0, 0.0, k * DICOM_SPACING[2]],
            "PixelSpacing": [DICOM_SPACING[1], DICOM_SPACING[0]],
            "SliceThickness": DICOM_SPACING[2],
        }, pixel_data=np.ascontiguousarray(hu[:, :, k].T))


def write_mhd(np, data, folder):
    """``data`` (X, Y, Z) uint16 as an MHD header and a zlib raw."""
    import os
    import zlib

    blob = zlib.compress(np.ascontiguousarray(data.transpose(2, 1, 0))
                         .tobytes())
    with open(os.path.join(folder, "vol.zraw"), "wb") as f:
        f.write(blob)
    path = os.path.join(folder, "vol.mhd")
    with open(path, "w") as f:
        f.write("ObjectType = Image\nNDims = 3\n"
                f"DimSize = {' '.join(str(d) for d in data.shape)}\n"
                f"ElementSpacing = {' '.join(str(v) for v in DICOM_SPACING)}\n"
                "ElementType = MET_USHORT\nCompressedData = True\n"
                f"CompressedDataSize = {len(blob)}\n"
                "ElementDataFile = vol.zraw\n")
    return path


def from_disk_phase(torch, card):
    """Phase 11 (see the module docstring): the port's entry points from a
    CT series on disk to PNGs, timed with `PhaseTracer`."""
    import os
    import tempfile

    import numpy as np

    from tbraymarcherplugin_tpu_torch.io import load_volume
    from tbraymarcherplugin_tpu_torch.ops import composite as K1
    from tbraymarcherplugin_tpu_torch.ops import light_scan as K4
    from tbraymarcherplugin_tpu_torch.ops import lighting as Lt
    from tbraymarcherplugin_tpu_torch.ops import sdf_march, synthetic
    from tbraymarcherplugin_tpu_torch.ops import warp as K2
    from tbraymarcherplugin_tpu_torch.renderer import Renderer, RendererConfig
    from tbraymarcherplugin_tpu_torch.scene import DirLight
    from tbraymarcherplugin_tpu_torch.tools import png, render_cli, viewer
    from tbraymarcherplugin_tpu_torch.utils import native
    from tbraymarcherplugin_tpu_torch.utils.profiling import (
        PhaseTracer, device_trace,
    )

    tracer = PhaseTracer()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        dcm_dir, mhd_dir, out = (os.path.join(tmp, d)
                                 for d in ("dicom", "mhd", "out"))
        for d in (dcm_dir, mhd_dir, out):
            os.makedirs(d)
        hu = np.round(synthetic.ct_like_phantom(DIMS, seed=0) * 4000.0
                      - 1000.0).astype(np.int16)
        u16 = (hu.astype(np.int32) + 1000).astype(np.uint16)
        with tracer.phase("write"):
            write_series(np, hu, dcm_dir)
            mhd = write_mhd(np, u16, mhd_dir)

        # the native data path builds at first use: its own phase, so the
        # loads below time the loading alone
        with tracer.phase("native build"):
            native.native_available()
        # load both through `load_volume`: exactly the numpy formula
        loads = {}
        for label, path, raw in (("dicom", os.path.join(dcm_dir, "0000.dcm"),
                                  hu), ("mhd", mhd, u16)):
            with tracer.phase(f"load {label}"):
                loads[label] = load_volume(path)
            lo, hi = float(raw.min()), float(raw.max())
            want = (raw.astype(np.float32) - lo) / (hi - lo)
            got = loads[label]
            check(got.data.shape == DIMS and got.data.dtype == np.float32,
                  f"{label}: {got.data.shape} {got.data.dtype}")
            check(np.array_equal(got.data, want),
                  f"{label}: the loaded volume != (raw - lo) / (hi - lo)")
            check((got.info.min_value, got.info.max_value) == (lo, hi),
                  f"{label}: min/max {got.info.min_value, got.info.max_value}")
        info = loads["dicom"].info
        check(tuple(info.spacing) == DICOM_SPACING
              and (info.min_slice_number, info.max_slice_number)
              == (1, DIMS[2]), f"DICOM info {info}")
        secs = {p["name"]: round(p["seconds"], 3) for p in tracer.phases}
        print(f"[disk] {DIMS[2]} DICOM files and a zlib MHD of {DIMS}: "
              f"seconds {secs} | both equal (raw - lo) / (hi - lo) exactly | "
              f"spacing {info.spacing} | native library "
              f"{'ran' if native.native_available() else 'absent: numpy'}",
              flush=True)

        # the render CLI on the folder: four orbit frames, then one frame in
        # each other mode and a clipped one with the half-resolution light
        # (the intensity frame's first samples are air, windowed to 0: it
        # shows black on a white background)
        runs = (("orbit", ["--frames", "4"], ("composite",), True),
                ("intensity", ["--mode", "intensity", "--background",
                               "1,1,1"], ("composite_intensity",), False),
                ("octree", ["--mode", "octree"], ("composite_unlit",), False),
                ("clip", ["--clip", CLI_CLIP, "--half-res-light"],
                 ("composite",), True))
        cli_ms = {}
        for label, extra, variants, lit in runs:
            K1.composite.variant_launches.clear()
            for k in (K1.composite, K2.row_lerp, Lt.occluder_opacity,
                      K4.propagate_face_scan):
                k.launches = 0
            run = PhaseTracer()
            check(render_cli.main([dcm_dir, os.path.join(out, f"{label}.png")]
                                  + CLI_ARGS + extra, tracer=run) == 0,
                  f"render_cli {label}")
            launches = dict(K1.composite.variant_launches,
                            row_lerp=K2.row_lerp.launches,
                            occluder=Lt.occluder_opacity.launches,
                            light_scan=K4.propagate_face_scan.launches)
            for name in variants + ("row_lerp",) + (
                    ("occluder", "light_scan") if lit else ()):
                check(launches.get(name, 0) > 0,
                      f"render_cli {label}: kernel {name} not launched")
            ms = {n: [round(p["ms_per_frame"], 2) for p in run.phases
                      if p["name"] == n] for n in ("render", "png")}
            cli_ms[label] = ms
            print(f"[cli] {label}: launches {launches} | ms per frame, "
                  f"render {ms['render']}, PNG {ms['png']}, both "
                  f"{[round(a + b, 2) for a, b in zip(ms['render'], ms['png'])]}"
                  f" | load {run.phases[0]['seconds']:.2f} s | {card}",
                  flush=True)
        sums = []
        for path in ([os.path.join(out, f"orbit{i:03d}.png") for i in range(4)]
                     + [os.path.join(out, f"{n}.png")
                        for n in ("intensity", "octree", "clip")]):
            img = png.read(path)
            check(img.shape == (HEIGHT, WIDTH, 4) and bool((img[..., 3]
                                                            == 255).all()),
                  f"{path}: {img.shape}")
            bg = 255 if path.endswith("intensity.png") else 0
            cover = float((img[..., :3] != bg).any(-1).mean())
            # the bone TF shows the shell only: 3-13% of a frame at 32^3
            check(cover > 0.02, f"{path}: coverage {cover:.3f}")
            sums.append(int(img.astype(np.int64).sum()))
        check(len(set(sums[:4])) == 4, f"orbit frames repeat: {sums[:4]}")

        # frame 0 against `Renderer.render` at the same camera and jitter
        r = Renderer(loads["dicom"].data, info=info,
                     tf_table=render_cli.resolve_tf("ct_bone"),
                     config=RendererConfig(step_count=STEPS))
        r.set_window_center(0.5)
        r.set_window_width(0.8)
        r.add_light("main", DirLight.create((0.3, 0.2, -0.93), 1.0))
        cam = render_cli.orbit_camera(0.0, 10.0,
                                      2.2 * render_cli.world_size(r), 40.0)
        want = png.to_rgba8(r.render(cam, WIDTH, HEIGHT))
        got = png.read(os.path.join(out, "orbit000.png"))
        check(np.array_equal(got, want), "CLI frame 0 != Renderer.render")
        print(f"[cli] frame 0 equals Renderer.render at its camera exactly | "
              f"pixel sums {sums}", flush=True)
        del r

        # the viewer, no server socket: three drags of the window center
        # and a TF change, a frame after each
        st = viewer.ViewerState(os.path.join(dcm_dir, "0000.dcm"),
                                image_size=VIEWER_SIZE)
        frames, view_ms = [st.frame_rgba8(30.0, 15.0, 2.2)], []
        for delta in ([{"window_center": c} for c in VIEWER_CENTERS]
                      + [{"tf": VIEWER_TF}]):
            st.update(delta)
            with tracer.phase("viewer frame"):
                frames.append(png.decode(st.frame_png(30.0, 15.0, 2.2)))
                tracer.frame()
            view_ms.append(round(tracer.phases[-1]["ms_per_frame"], 2))
            check(frames[-1].shape == (VIEWER_SIZE, VIEWER_SIZE, 4)
                  and not np.array_equal(frames[-1], frames[-2]),
                  f"viewer frame after {delta} did not change")
        print(f"[viewer] {VIEWER_SIZE}^2 frames after centers "
              f"{VIEWER_CENTERS} and TF {VIEWER_TF!r}: ms per frame (host "
              f"clock, PNG included) {view_ms} | {card}", flush=True)
        del st, frames

        # the SDF demo on the card, and at 64^2 against the CPU
        entry, direction = sdf_rays(torch, SDF_SIZE, torch.device("cuda"))
        with tracer.phase("sdf"):
            big = sdf_march.march_mandelbulb_distance(entry, direction)
            torch.cuda.synchronize()
        sdf_s = tracer.phases[-1]["seconds"]
        check(tuple(big.shape) == (SDF_SIZE, SDF_SIZE, 2)
              and bool(torch.isfinite(big).all())
              and 0.05 < float(big[..., 1].mean()) < 0.95,
              f"SDF demo: hit share {float(big[..., 1].mean()):.3f}")
        small = [sdf_march.march_mandelbulb_distance(
            *sdf_rays(torch, SDF_SMALL, torch.device(d))).cpu()
            for d in ("cuda", "cpu")]
        hit_diff = float((small[0][..., 1] != small[1][..., 1]).float().mean())
        both = (small[0][..., 1] > 0) & (small[1][..., 1] > 0)
        shade = float((small[0][..., 0] - small[1][..., 0]).abs()[both]
                      .mean()) if bool(both.any()) else 0.0
        print(f"[sdf] {SDF_SIZE}^2 march {sdf_s * 1e3:.1f} ms (host clock), "
              f"hit share {float(big[..., 1].mean()):.3f} | {SDF_SMALL}^2 "
              f"card vs CPU: hit masks differ on {hit_diff:.4f} of the rays "
              f"(limit {SDF_HIT_SHARE_LIMIT}), mean shade difference where "
              f"both hit {shade:.2e} (limit {SDF_SHADE_LIMIT}) | {card}",
              flush=True)
        check(hit_diff <= SDF_HIT_SHARE_LIMIT and shade <= SDF_SHADE_LIMIT,
              "SDF demo: card != CPU")

        # one CLI frame under a device trace
        trace_dir = os.path.join(tmp, "trace")
        with device_trace(log_dir=trace_dir, name="render_cli"):
            check(render_cli.main([dcm_dir, os.path.join(out, "traced.png")]
                                  + CLI_ARGS) == 0, "traced render_cli")
        traces = os.listdir(trace_dir)
        check(any(t.endswith(".json") and os.path.getsize(
            os.path.join(trace_dir, t)) > 0 for t in traces),
            f"no trace file in {traces}")
        print(f"[trace] one CLI frame traced: {traces} | phases "
              f"{json.dumps(tracer.summary())}", flush=True)
    return cli_ms


def _rel_err(torch, got, want):
    """(max abs error, that over the largest |want|) of two tensors."""
    d = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    check(math.isfinite(d), "non-finite output")
    return d, d / scale if scale > 0 else d


def _hold_to_plain(torch, calls, card, label):
    """K1's and K5's recorded calls against their plain versions, at
    LIMITS["composite"] (max abs) and BWD_LIMITS["composite_bwd"] (over
    the largest plain value): the worst of each."""
    from tbraymarcherplugin_tpu_torch.ops import composite, shearwarp_grad

    worst = {}
    with torch.no_grad():
        for name, real, plain, limit, rel in (
                ("composite", composite.composite, composite.composite_plain,
                 LIMITS["composite"], False),
                ("composite_bwd", shearwarp_grad.composite_bwd,
                 shearwarp_grad.composite_bwd_plain,
                 BWD_LIMITS["composite_bwd"], True)):
            for args, kw in calls[name]:
                for got, want in zip(as_tuple(real(*args, **kw)),
                                     as_tuple(plain(*args, **kw))):
                    err = _rel_err(torch, got, want)[1 if rel else 0]
                    worst[name] = max(worst.get(name, 0.0), err)
                    check(err <= limit, f"{label}: {name} disagrees with its "
                          f"plain version ({err:.3e} > {limit:.1e})")
    return worst


def parallel_phase(torch, volume, tf, light_volume, plan, cam, transform,
                   clip, card, results):
    """Phase 12 (see the module docstring): the `parallel` package on a
    world-1 NCCL group; adds each of K1-K8's launches on the sharded paths
    to ``results`` (``sharded_launches``)."""
    import tempfile

    import torch.distributed as dist

    from tbraymarcherplugin_tpu_torch import parallel as P
    from tbraymarcherplugin_tpu_torch.parallel import distributed as D

    # (a) a world-1 NCCL group on the card, and its meshes
    store = tempfile.TemporaryDirectory()
    D.initialize_multihost("file://" + store.name + "/store", 1, 0)
    try:
        backend = dist.get_backend()
        check(backend == "nccl", f"backend {backend}, not NCCL")
        rays_mesh = P.make_mesh({"rays": 1})
        slab_mesh = P.make_mesh({"slab": 1})
        print(f"[parallel] (a) group: backend {backend}, world "
              f"{dist.get_world_size()}, meshes {rays_mesh} and {slab_mesh} "
              f"| {card}", flush=True)
        _sharded_paths(torch, P, volume, tf, light_volume, plan, cam,
                       transform, clip, card, rays_mesh, slab_mesh, results)
    finally:
        dist.destroy_process_group()
        store.cleanup()


def _sharded_paths(torch, P, volume, tf, light_volume, plan, cam, transform,
                   clip, card, rays_mesh, slab_mesh, results):
    """Phase 12 (b)-(f) on the meshes of (a)."""
    from tbraymarcherplugin_tpu_torch.models import pipeline as PP
    from tbraymarcherplugin_tpu_torch.ops import march as M
    from tbraymarcherplugin_tpu_torch.ops import shearwarp as SW
    from tbraymarcherplugin_tpu_torch.ops.rays import setup_rays
    from tbraymarcherplugin_tpu_torch.ops.shearwarp_grad import (
        shearwarp_intermediate_fused_diff as fused_diff,
    )
    from tbraymarcherplugin_tpu_torch.ops.warp import (
        warp_to_screen_fused as warp_fused,
    )
    from tbraymarcherplugin_tpu_torch.parallel.shearwarp_sharding import (
        shearwarp_slab,
    )

    dev = volume.device
    cc, cd = clip.center, clip.direction
    lv = light_volume
    bf16 = torch.bfloat16
    table = {name: (mod, fn) for name, mod, fn in kernel_table()}

    def zero(names):
        for n in names:
            mod, fn = table[n]
            getattr(mod, fn).launches = 0

    def counts(names):
        out = {}
        for n in names:
            mod, fn = table[n]
            out[n] = getattr(mod, fn).launches
            check(out[n] > 0, f"kernel {n} was not launched by the sharded "
                  f"path")
            results[n]["sharded_launches"] = (
                results[n].get("sharded_launches", 0) + out[n])
        return out

    def win(center):
        return torch.tensor([center, WINDOW[1], 1.0, 1.0], device=dev)

    def same(a, b):
        """Tensors, or sequences of them, with the same bits."""
        a, b = (tuple(x) if isinstance(x, (tuple, list)) else (x,)
                for x in (a, b))
        return len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))

    # (b) the differentiable sharded shear-warp at full width, bf16 planes
    swd = ("composite", "composite_bwd", "row_lerp", "row_lerp_bwd")
    args = (volume, tf, lv, plan, win(FWD_BWD_CENTERS[0]), cc, cd, WIDTH,
            HEIGHT)
    with torch.no_grad():
        target = P.shearwarp_lit_sharded_diff(
            rays_mesh, volume, tf, lv, plan, win(WINDOW[0]), cc, cd, WIDTH,
            HEIGHT, compute_dtype=bf16)
    zero(swd)
    img = P.shearwarp_lit_sharded_diff(rays_mesh, *args, compute_dtype=bf16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    (loss, grads), ms = host_ms(torch, lambda: P.shearwarp_lit_sharded_diff(
        rays_mesh, *args, target=target, compute_dtype=bf16))
    peak = torch.cuda.max_memory_allocated()
    launches = counts(swd)
    leaves = [x.detach().clone().requires_grad_()
              for x in (volume, tf, win(FWD_BWD_CENTERS[0]))]
    img1 = warp_fused(fused_diff(leaves[0], leaves[1], lv, plan, leaves[2],
                                 cc, cd, compute_dtype=bf16),
                      plan, WIDTH, HEIGHT)
    loss1 = ((img1 - target) ** 2).sum()
    loss1.backward()
    exact = (same(img, img1.detach()), same(loss, loss1.detach()),
             same(grads, tuple(x.grad for x in leaves)))
    print(f"[parallel] (b) shearwarp_lit_sharded_diff, world 1, "
          f"{WIDTH}x{HEIGHT}, {DIMS[0]}^3, {plan.k} bf16 planes, window "
          f"center {FWD_BWD_CENTERS[0]} against the frame at {WINDOW[0]}: "
          f"loss {float(loss):.6f}, fwd+bwd {ms:.2f} ms (host clock), peak "
          f"device memory {peak / 2**20:.1f} MiB ({before / 2**20:.1f} MiB "
          f"before) | the same bits as the single-device fused path (image, "
          f"loss, gradients): {exact} | launches {launches} | {card}",
          flush=True)
    check(all(exact), "the world-1 sharded diff shear-warp is not the "
          "single-device fused path bit for bit")
    check(all(bool(torch.isfinite(g).all()) and bool((g != 0).any())
              for g in grads[:2]), "sharded gradients non-finite or zero")
    del img, img1, loss1, leaves, grads

    # (c) the forward sharded shear-warp (dense composite)
    wf = win(WINDOW[0])
    got, ms = host_ms(torch, lambda: P.shearwarp_lit_sharded(
        rays_mesh, volume, tf, lv, plan, wf, cc, cd, WIDTH, HEIGHT))
    want = SW.shearwarp_lit(volume, tf, lv, plan, wf, cc, cd, WIDTH, HEIGHT,
                            block_size=16)
    print(f"[parallel] (c) shearwarp_lit_sharded, world 1 (dense composite, "
          f"blocks of 16 planes, float32): {ms:.2f} ms (host clock) | the "
          f"same bits as shearwarp_lit: {torch.equal(got, want)} | {card}",
          flush=True)
    check(torch.equal(got, want), "the world-1 sharded forward shear-warp "
          "is not shearwarp_lit bit for bit")
    del got, want

    # (d) a 4-way split's ranks in turn, float32 planes
    world = 4
    n2l = plan.n2 // world
    leaves = [x.detach().clone().requires_grad_()
              for x in (volume, tf, win(FWD_BWD_CENTERS[0]))]
    inter = fused_diff(leaves[0], leaves[1], lv, plan, leaves[2], cc, cd,
                       compute_dtype=torch.float32)
    loss_full = ((warp_fused(inter, plan, WIDTH, HEIGHT) - target) ** 2).sum()
    g_inter, *full = torch.autograd.grad(loss_full, [inter, *leaves])
    slabs, sums, worst = [], [torch.zeros_like(x) for x in leaves], {}
    for rank in range(world):
        calls = {}
        with capture_calls(calls, ["composite", "composite_bwd"]):
            slab = shearwarp_slab(leaves[0], leaves[1], lv, plan, rank,
                                  world, leaves[2], cc, cd,
                                  compute_dtype=torch.float32)
            part = torch.autograd.grad(
                slab, leaves, g_inter[..., rank * n2l:(rank + 1) * n2l])
        slabs.append(slab.detach())
        sums = [s + p for s, p in zip(sums, part)]
        for k, v in _hold_to_plain(torch, calls, card,
                                   f"slab {rank}").items():
            worst[k] = max(worst.get(k, 0.0), v)
        del calls, slab, part
    cat = torch.cat(slabs, dim=2)
    inter_err = float(((cat - inter.detach()).abs()
                       - 1e-5 * inter.detach().abs()).max())
    inter_same = torch.equal(cat, inter.detach())
    grad_errs = []
    for name, s, f in zip(("dvolume", "dtf", "dwindow"), sums, full):
        tol = 1e-5 * max(float(f.abs().max()), 1.0)
        grad_errs.append(float(((s - f).abs() - 5e-3 * f.abs()).max() / tol))
    print(f"[parallel] (d) 4-way split of n2={plan.n2} rank by rank "
          f"(n2_local {n2l}, float32 planes): K1 vs plain max abs "
          f"{worst['composite']:.3e} (limit {LIMITS['composite']:.0e}), K5 "
          f"vs plain over the largest plain value "
          f"{worst['composite_bwd']:.3e} (limit "
          f"{BWD_LIMITS['composite_bwd']:.1e}) | concatenated slabs vs the "
          f"full intermediate: max(|d| - 1e-5 |x|) {inter_err:.3e} (limit "
          f"1e-6), the same bits: {inter_same} | summed slab gradients vs full width (dvolume, dtf, "
          f"dwindow): max(|d| - 5e-3 |x|) over 1e-5 max(|x|, 1) "
          f"{', '.join(f'{e:.3f}' for e in grad_errs)} (limit 1) | {card}",
          flush=True)
    check(inter_err <= 1e-6, "slabs != the full intermediate")
    check(all(e <= 1.0 for e in grad_errs), "summed slab gradients != the "
          "full-width gradients")
    del leaves, inter, g_inter, full, slabs, sums, cat

    # (e) the ray-tile train step, bulk and overlapped, 480x270 rays
    rays = setup_rays(cam, transform, *TRAIN_RAYS, device=dev)
    flat, _ = P.pad_rays_for_mesh(rays, 1)
    plans = (PP.LightPlan.create(LIGHT_DIR, DIMS),)

    def params(center):
        return PP.RenderParams(
            volume.detach().clone(), tf.detach().clone(),
            torch.tensor(center, device=dev),
            torch.tensor(WINDOW[1], device=dev),
            torch.tensor([1.0], device=dev))

    def l2(img, tgt):
        return ((img - tgt) ** 2).sum()

    with torch.no_grad():
        tgt = PP.render_lit_scene(params(WINDOW[0]), flat, cc, cd, plans,
                                  DIMS, step_count=TRAIN_STEPS)
        loss_single = l2(PP.render_lit_scene(
            params(FWD_BWD_CENTERS[0]), flat, cc, cd, plans, DIMS,
            step_count=TRAIN_STEPS), tgt)
    train = ("occluder", "light_scan", "light_scan_bwd", "tf_alpha_bwd")
    zero(train)
    runs, step_ms = [], []
    for overlap in (False, False, True):  # bulk twice: the atomics' spread
        step, make_opt = P.make_sharded_train_step(
            rays_mesh, l2, cc, cd, plans, DIMS, step_count=TRAIN_STEPS,
            overlap_allreduce=overlap)
        p = params(FWD_BWD_CENTERS[0])
        leaves = [x.requires_grad_() for x in vars(p).values()]
        opt = make_opt(leaves)
        loss, ms = host_ms(torch, lambda: step(p, opt, flat, tgt))
        runs.append((loss, [x.grad for x in leaves],
                     [x.detach() for x in leaves]))
        step_ms.append(ms)
    launches = counts(train)

    def grad_rel(a, b):
        return max(float(torch.linalg.vector_norm(x - y))
                   / max(float(torch.linalg.vector_norm(y)), 1e-30)
                   for x, y in zip(a[1], b[1]))

    spread, diff = grad_rel(runs[1], runs[0]), grad_rel(runs[2], runs[0])
    same_loss = same(runs[0][0], loss_single) and same(runs[2][0],
                                                       loss_single)
    print(f"[parallel] (e) make_sharded_train_step, world 1, "
          f"{TRAIN_RAYS[0]}x{TRAIN_RAYS[1]} rays (fewer than the slice's "
          f"1920x1080 frame), {TRAIN_STEPS} steps per unit, one Adam step "
          f"bulk, bulk again, overlapped: "
          f"{', '.join(f'{m:.2f}' for m in step_ms)} ms (host clock) | loss "
          f"{float(runs[0][0]):.6f}, the single-process render_lit_scene "
          f"loss's bits in both modes: {same_loss} | gradients, largest "
          f"|a - b|_2 / |b|_2 over the leaves: overlap vs bulk {diff:.3e} "
          f"(limit {TRAIN_GRAD_LIMIT:.0e}), bulk vs bulk {spread:.3e} | "
          f"Adam-stepped leaves the same bits, overlap vs bulk "
          f"{same(runs[2][2], runs[0][2])}, bulk vs bulk "
          f"{same(runs[1][2], runs[0][2])} | launches {launches} | {card}",
          flush=True)
    check(same_loss, "the train step's loss != the single-process loss")
    check(diff <= TRAIN_GRAD_LIMIT, "bulk and overlapped all-reduce "
          "gradients differ")
    check(not torch.equal(runs[0][2][1], tf), "the Adam step did not move "
          "the TF")
    del runs

    # (f) the slab paths, 480x270 rays
    wf = win(WINDOW[0])
    margs = (volume, tf, lv, rays, wf, cc, cd)
    checks = []
    for name, fn, ref in (
            ("march_lit_slab_ring", lambda: P.march_lit_slab_ring(
                slab_mesh, *margs, step_count=STEPS),
             lambda: M.march_lit(*margs, step_count=STEPS)),
            ("march_lit_slab_sharded", lambda: P.march_lit_slab_sharded(
                slab_mesh, *margs, step_count=STEPS),
             lambda: M.march_lit(*margs, step_count=STEPS,
                                 early_termination=2.0))):
        with torch.no_grad():
            got, ms = host_ms(torch, fn)
            want = ref()
        err = float(((got - want).abs() - 1e-4 * want.abs()).max())
        checks.append((name, err, 1e-5, ms, torch.equal(got, want)))
    p = params(WINDOW[0])
    with torch.no_grad():
        want = PP.compute_illumination(p, plans, cc, cd, DIMS)
        zero(("occluder", "light_scan"))
        got, ms = host_ms(torch, lambda: P.compute_illumination_sharded_v2(
            slab_mesh, p, plans, cc, cd, DIMS))
        v2_launches = counts(("occluder", "light_scan"))
        err = float(((got - want).abs() - 1e-5 * want.abs()).max())
        checks.append(("compute_illumination_sharded_v2", err, 1e-6, ms,
                       torch.equal(got, want)))
    for name, err, limit, ms, equal in checks:
        print(f"[parallel] (f) {name}, world 1, {DIMS[0]}^3"
              f"{'' if 'illum' in name else ', %dx%d rays' % TRAIN_RAYS}: "
              f"max(|d| - rtol |x|) {err:.3e} (limit {limit:.0e}), the same "
              f"bits: {equal} | {ms:.2f} ms (host clock) | {card}",
              flush=True)
        check(err <= limit, f"{name} disagrees with its single-device path")
    sharded = {n: results[n]["sharded_launches"] for n in table
               if "sharded_launches" in results.get(n, {})}
    print(f"[parallel] (f) launches of one compute_illumination_sharded_v2 "
          f"call {v2_launches} | the sharded launches of phase 12 "
          f"{sharded}", flush=True)


# Phase 13: the Richtmyer-Meshkov cell's configuration, its stand-in's
# seed, the ranks, and the rank whose slab (with its neighbours') holds
# the mixing layer; the clip plane dragged through it; the Z windows at
# either end of a face's planes that K3's plain version is held on
RM_CONFIG = "rmbench/configs/richtmyer_meshkov.json"
RM_SEED, RM_RANKS, RM_RANK = 2**31 + 13, 4, 1
RM_CLIP = ((0.45, 0.5, 0.5), (1.0, 0.0, 0.0))
RM_PLAIN_PLANES = 16


def slab_phase(torch, card, results):
    """Phase 13 (see the module docstring): the kernels the slab-sharded
    `Renderer` gives new arguments, at the Richtmyer-Meshkov cell's
    shapes, rank by rank on one card; adds each kernel's launches to
    ``results`` (``slab_launches``)."""
    from pathlib import Path

    import numpy as np

    from rmbench import generator
    from rmbench.volumes import rm_mixing
    from tbraymarcherplugin_tpu_torch.models.pipeline import LightPlan
    from tbraymarcherplugin_tpu_torch.ops import composite as K1
    from tbraymarcherplugin_tpu_torch.ops import light_scan as K4
    from tbraymarcherplugin_tpu_torch.ops import lighting as Lt
    from tbraymarcherplugin_tpu_torch.ops import shearwarp as SW
    from tbraymarcherplugin_tpu_torch.ops import transfer as T
    from tbraymarcherplugin_tpu_torch.ops.rays import jitter_values
    from tbraymarcherplugin_tpu_torch.parallel import slab_sharding as SS
    from tbraymarcherplugin_tpu_torch.parallel.shearwarp_sharding import (
        _local_plan,
    )
    from tbraymarcherplugin_tpu_torch.scene import (
        Camera, ClipPlane, DirLight, VolumeTransform,
    )

    config = json.loads((Path(__file__).resolve().parent
                         / RM_CONFIG).read_text())
    dims = tuple(int(d) for d in config["dims"])
    n, zc = RM_RANKS, dims[2] // RM_RANKS
    dev = torch.device("cuda", 0)
    tf = T.tf_ct_soft_tissue(device=dev)
    win = [*config["window"], 1.0, 1.0]
    clip = ClipPlane.create(*RM_CLIP)
    cc, cd = clip.center, clip.direction
    transform = VolumeTransform.create(
        scale=tuple(generator.world_scale(config)))
    (li,) = config["lights"]
    lplan = LightPlan.create(transform.local_light_direction(
        DirLight.create(li["direction"], li["intensity"])), dims)
    depth = SS.held_depth((lplan,), dims, dims, n)
    kernels = {"occluder": (Lt, "occluder_opacity"),
               "light_scan": (K4, "propagate_face_scan"),
               "composite": (K1, "composite")}
    for mod, fn in kernels.values():
        getattr(mod, fn).launches = 0

    def held(rank):
        z0, z1 = rank * zc, (rank + 1) * zc
        h0, h1 = max(z0 - depth, 0), min(z1 + depth, dims[2])
        return rm_mixing.make(dims, RM_SEED, dev, z=(h0, h1)), h0

    def occluder(vol, h0, fp, a, b):
        """K3 on light planes [a, b), held to its plain version on the
        first and last planes and to itself on those windows."""
        args = (vol, tf, win, dims, fp.uvw_offset, fp.step_size, cc, cd)
        got = Lt.occluder_opacity(*args, window=Lt.ZWindow(dims, h0, a, b))
        ms = cuda_ms(torch, lambda: Lt.occluder_opacity(
            *args, window=Lt.ZWindow(dims, h0, a, b)), 2)
        err, same = 0.0, True
        for w0, w1 in ((a, a + RM_PLAIN_PLANES), (b - RM_PLAIN_PLANES, b)):
            part = got[:, :, w0 - a:w1 - a]
            win_w = Lt.ZWindow(dims, h0, w0, w1)
            want = Lt.occluder_opacity_plain(*args, window=win_w)
            err = max(err, float((part - want).abs().max()))
            same &= torch.equal(Lt.occluder_opacity(*args, window=win_w),
                                part)
            del want
        check(math.isfinite(err) and err <= LIMITS["occluder"],
              f"occluder on a Z window disagrees with its plain version "
              f"({err:.3e})")
        check(same, "occluder on a sub-window != its window's planes")
        check(bool((got > 0).any()), "occluder: an empty field")
        print(f"[slab] occluder, face {fp.face}, light planes {a}..{b - 1} "
              f"of {dims} from the held planes {h0}..{h0 + vol.shape[2] - 1}:"
              f" {ms:.3f} ms | vs plain on planes {a}..{a + RM_PLAIN_PLANES - 1}"
              f" and {b - RM_PLAIN_PLANES}..{b - 1} max abs {err:.3e} (limit "
              f"{LIMITS['occluder']:.0e}), the sub-windows the same bits: "
              f"{same} | {card}", flush=True)
        return got

    def chained(scan, offs, alpha, h, carry=None, plain=2):
        """K4 on ``scan`` in chunks of ``h`` slices chained by carries
        against one scan of the whole, and its first ``plain`` chunks
        after the first against the plain version with the carry."""
        whole = K4.propagate_face_scan(scan, *offs, alpha, carry)
        ms = cuda_ms(torch, lambda: K4.propagate_face_scan(
            scan, *offs, alpha, carry), 2)
        same, same_plain, c = True, True, carry
        for i, k0 in enumerate(range(0, scan.shape[0], h)):
            part = K4.propagate_face_scan(scan[k0:k0 + h], *offs, alpha, c)
            same &= torch.equal(part, whole[k0:k0 + h])
            if 0 < i <= plain:
                same_plain &= torch.equal(part, K4.propagate_face_scan_plain(
                    scan[k0:k0 + h], *offs, alpha, c))
            c = part[-1].clone()
            del part
        check(same, "K4's chunks chained by carries != one scan")
        check(same_plain, "K4 with a carry != its plain version")
        return whole, ms, same, same_plain

    # K3 and K4 of each face on rank RM_RANK's slab and its neighbour's
    vol, h0 = held(RM_RANK)
    z0, z1 = RM_RANK * zc, (RM_RANK + 1) * zc
    zface = None
    for fp in lplan.face_plans:
        alpha = float(np.float32(li["intensity"])
                      * np.float32(fp.light_alpha))
        ax = Lt.transposed_axes(fp.face)
        uv = np.asarray(fp.uv_offset, np.float32)
        offs = (uv[0] * np.float32(dims[ax[0]]),
                uv[1] * np.float32(dims[ax[1]]))
        if Lt.face_axis(fp.face) == 2:
            zface = (fp, alpha, offs, occluder(vol, h0, fp, z0, z1))
            continue
        h, cols, above = SS._xy_face_halo(fp, dims, zc)
        a, b = (z0, min(z1 + cols, dims[2])) if above else (
            max(z0 - cols, 0), z1)
        opac = occluder(vol, h0, fp, a, b)
        scan = opac if Lt.face_axis(fp.face) == 0 else opac.permute(1, 0, 2)
        if Lt.face_direction(fp.face) == -1:
            scan = scan.flip(0)
        scan = scan.contiguous()
        del opac
        _, ms, same, same_plain = chained(scan, offs, alpha, h)
        print(f"[slab] K4, face {fp.face}, the band of light planes "
              f"{a}..{b - 1} ({tuple(scan.shape)} in scan order) in chunks "
              f"of {h} slices chained by carries: the same bits as one scan "
              f"{same}, as the plain version with the carry {same_plain} | "
              f"one scan {ms:.3f} ms | {card}", flush=True)
        del scan
    del vol
    torch.cuda.empty_cache()
    check(zface is not None, "the cell's light has no Z face")
    fp, alpha, offs, mine = zface
    vol, h0 = held(RM_RANK + 1)
    other = occluder(vol, h0, fp, z1, z1 + zc)
    del vol
    op = torch.cat([mine, other], dim=2)
    del mine, other
    if Lt.face_direction(fp.face) == -1:
        op = op.flip(2)
    scan = op.movedim(2, 0).contiguous()
    del op
    torch.cuda.empty_cache()
    _, ms, same, same_plain = chained(scan, offs, alpha, zc, plain=1)
    print(f"[slab] K4, face {fp.face}, ranks {RM_RANK} and {RM_RANK + 1}'s "
          f"chunks ({zc}, {dims[0]}, {dims[1]}) chained by the carry: the "
          f"same bits as one scan of {tuple(scan.shape)} {same}, the second "
          f"chunk as the plain version with the carry {same_plain} | one "
          f"scan {ms:.3f} ms | {card}", flush=True)
    del scan
    torch.cuda.empty_cache()

    # K1 on each rank's column band of the four slabs' summed partial planes
    pos, target, fov = generator.base_camera(config)
    cam = Camera.look_at(np.asarray(pos), np.asarray(target),
                         fov_degrees=fov)
    plan = SW.plan_shearwarp(cam, transform, dims, dims, config["width"],
                             config["height"],
                             max_planes=config["step_count"])
    check(plan is not None and plan.n2 % n == 0, "no plan for the cell")
    nb = plan.n2 // n
    sums, mn, mx = None, None, None
    for rank in range(n):
        slab = rm_mixing.make(dims, RM_SEED, dev,
                              z=(rank * zc, (rank + 1) * zc))
        light = torch.rand(slab.shape, device=dev,
                           generator=torch.Generator(dev).manual_seed(rank))
        W, L, (lo, hi) = K1.preshear_slab(slab, light, plan, dims, dims,
                                          rank * zc, rank * zc, n, True)
        del slab, light
        sums = (W, L) if sums is None else (sums[0] + W, sums[1] + L)
        mn = lo if mn is None else torch.minimum(mn, lo)
        mx = hi if mx is None else torch.maximum(mx, hi)
        del W, L
    torch.cuda.empty_cache()
    dtype = SW.plane_dtype(None, dev)
    Wp, Lp = (x.to(dtype) for x in sums)
    del sums
    jitter = jitter_values(plan.n2, plan.n1, 0, device=dev)
    et = config["renderer"]["early_termination"]
    d12 = (dims[plan.axes12[0]], dims[plan.axes12[1]])

    def whole(x):
        return x.permute(1, 2, 0, 3).reshape(x.shape[1], plan.n1, -1)

    full = K1.composite(**K1.composite_args(
        plan, whole(Wp), whole(Lp), tf, win, (mn, mx), cc, cd, et, jitter,
        None, "lit", *d12))
    err_plain, err_full, band_ms = 0.0, 0.0, []
    for rank in range(n):
        cols = slice(rank * nb, (rank + 1) * nb)
        ops = K1.composite_args(_local_plan(plan, rank, nb), Wp[rank],
                                Lp[rank], tf, win, (mn, mx), cc, cd, et,
                                jitter[:, cols], None, "lit", *d12)
        band = K1.composite(**ops)
        band_ms.append(cuda_ms(torch, lambda: K1.composite(**ops), 3))
        err_plain = max(err_plain, float(
            (band - K1.composite_plain(**ops)).abs().max()))
        err_full = max(err_full, float((band - full[:, :, cols]).abs().max()))
        del band, ops
    print(f"[slab] K1 on the column bands ({Wp.shape[1]} {dtype} planes, "
          f"{plan.n1}x{nb} each) of the four slabs' summed partial planes: "
          f"vs plain max abs {err_plain:.3e} (limit {LIMITS['composite']:.0e})"
          f", vs the one-card composite's band {err_full:.3e} (limit 1e-6) |"
          f" {', '.join(f'{m:.3f}' for m in band_ms)} ms a band | {card}",
          flush=True)
    check(math.isfinite(err_plain) and err_plain <= LIMITS["composite"],
          "K1 on a band disagrees with its plain version")
    check(err_full <= 1e-6, "K1 on a band != the one-card composite's band")
    check(bool((full[3] > 0.5).any()), "K1: nothing is drawn")
    launches = {}
    for name, (mod, fn) in kernels.items():
        launches[name] = getattr(mod, fn).launches
        check(launches[name] > 0, f"kernel {name} was not launched by "
              f"phase 13")
        results[name]["slab_launches"] = launches[name]
    print(f"[slab] launches of phase 13, counted from zero: {launches} | "
          f"{card}", flush=True)


T0 = time.perf_counter()


def chest_plan(SW, PS):
    """The chest clip drag cell's plan: the proxy cube of CHEST_DIMS at
    CHEST_SPACING_MM, its extent in cm, and the camera CHEST_CAMERA looking
    at its center, 1920x1080, 150 planes."""
    import numpy as np

    scale = np.asarray(CHEST_DIMS, np.float64) * np.asarray(
        CHEST_SPACING_MM) / 10.0
    az, el, dist, fov = CHEST_CAMERA
    d = dist * float(scale.max())
    az, el = math.radians(az), math.radians(el)
    pos = (d * math.cos(el) * math.sin(az), -d * math.cos(el) * math.cos(az),
           d * math.sin(el))
    return SW.plan_shearwarp(
        PS.Camera.look_at(pos, (0.0, 0.0, 0.0), fov_degrees=fov),
        PS.VolumeTransform.create(scale=tuple(float(x) for x in scale)),
        CHEST_DIMS, CHEST_DIMS, WIDTH, HEIGHT, max_planes=STEPS)


def preshear_phase(torch, card, results):
    """Phase 14: K12, the pre-shear, against its plain version and the
    parent's composition (`_volume_planes`, the light slices' lerp and the
    tent matrices' two `bmm`, `shearwarp._resample_block`: `library_ms`)
    at the chest CT's frame (bfloat16) and the fit's planes (float32); its
    adjoint at the fit's against the plain adjoint and autograd through
    the `bmm` composition's light stream. A frame's pre-shear is both
    streams; the bound counts the planes written once and each slice the
    planes read, read once."""
    import numpy as np

    from tbraymarcherplugin_tpu_torch import scene as PS
    from tbraymarcherplugin_tpu_torch.ops import composite as K1
    from tbraymarcherplugin_tpu_torch.ops import preshear as K12
    from tbraymarcherplugin_tpu_torch.ops import shearwarp as SW

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)

    def parent(plan, kbuf, dtype, vol, light, f32_out=False):
        """The parent's two streams: slices, lerp, pad, tent-matrix bmm."""
        ax = (plan.axis,) + tuple(plan.axes12)

        def coeff(n):
            return SW._pad_to(SW._t(getattr(plan, n), dev), kbuf)

        W = SW._resample_block(SW._pad_to(SW._volume_planes(
            vol.permute(ax), plan), kbuf), *(coeff(n) for n in (
                "a1", "b1", "a2", "b2")), plan.n1, plan.n2, dtype)
        lt = light.permute(ax)
        lm0 = SW._t(plan.lm0, dev)
        lmt = SW._t(plan.lmt, dev)[:, None, None]
        lp = lt[lm0] * (1.0 - lmt) + lt[(lm0 + 1).clamp(
            max=lt.shape[0] - 1)] * lmt
        return W, SW._resample_block(
            SW._pad_to(lp, kbuf), *(coeff(n) for n in (
                "la1", "lb1", "la2", "lb2")), plan.n1, plan.n2, dtype)

    def nbytes(st, planes):
        used = set(st.m0.tolist()) | (set(st.m1.tolist()) if st.lerp else
                                      set())
        return (len(used) * st.dims[1] * st.dims[2] * 4
                + planes.numel() * planes.element_size())

    def forward_row(label, dims, plan, kbuf, dtype):
        vol = torch.rand(dims, generator=gen, device=dev)
        light = torch.rand(dims, generator=gen, device=dev)
        vs, ls = K12.plan_streams(plan, kbuf, dims, dims, False, dev)

        def frame():
            return (K12.preshear(vol, vs, dtype),
                    K12.preshear(light, ls, dtype))

        before = K12.preshear.launches
        got = frame()
        check(K12.preshear.launches == before + 2,
              "preshear: not one launch a stream")
        again = frame()
        err = 0.0
        for g, a, src, st in zip(got, again, (vol, light), (vs, ls)):
            want = K12.preshear_plain(src, st, dtype)
            check(torch.equal(g, a), "preshear: other bits on a second run")
            err = max(err, float((g.float() - want.float()).abs().max()))
            del want
        check(err <= PRESHEAR_LIMIT, f"preshear {label}: {err:.3e} from "
              f"the plain version")
        ms = cuda_ms(torch, frame, 10)
        dms = device_ms(torch, frame, 10)
        check(dms[1] == 2, f"preshear took {dms[1]:g} device operations a "
              f"frame")
        plain_ms = cuda_ms(torch, lambda: (
            K12.preshear_plain(vol, vs, dtype),
            K12.preshear_plain(light, ls, dtype)), 2)
        lib = parent(plan, kbuf, dtype, vol, light)
        lib_err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(lib, got))
        del lib
        lib_ms = cuda_ms(torch, lambda: parent(plan, kbuf, dtype, vol,
                                               light), 5)
        lib_dms = device_ms(torch, lambda: parent(plan, kbuf, dtype, vol,
                                                  light), 5)
        samples = sum(p.numel() for p in got)
        row = dict(max_abs_err=err, ms=ms, device_ms=dms[0],
                   device_ops_per_call=dms[1], plain_ms=plain_ms,
                   library_ms=lib_ms, library_device_ms=lib_dms[0],
                   library_device_ops=lib_dms[1], library_max_abs_err=lib_err,
                   dims=list(dims), planes=[kbuf, plan.n1, plan.n2],
                   dtype=str(dtype).replace("torch.", ""),
                   **_bound(nbytes(vs, got[0]) + nbytes(ls, got[1]),
                            samples * PRESHEAR_OPS))
        print(f"[kernel] preshear {label}: {dims}, planes {kbuf} x "
              f"{plan.n1} x {plan.n2} {row['dtype']}, axis {plan.axis}, "
              f"both streams | max_abs_err {err:.3e} (limit "
              f"{PRESHEAR_LIMIT:.0e}), the same bits twice | kernel {ms:.4f} "
              f"ms back to back, {dms[0]:.4f} ms on the device ({dms[1]:g} "
              f"device ops) | bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}) | plain {plain_ms:.3f} ms | the parent's "
              f"bmm composition {lib_ms:.4f} ms, {lib_dms[0]:.4f} ms on the "
              f"device ({lib_dms[1]:g} device ops), {lib_err:.3e} from K12 "
              f"| {card}", flush=True)
        return row, (vol, light, vs, ls)

    chest, _ = forward_row("chest", CHEST_DIMS, chest_plan(SW, PS),
                           -(-STEPS // K1.KB) * K1.KB + 1, torch.bfloat16)
    plan = SW.plan_shearwarp(PS.Camera.look_at(CAM_POS, 0.0,
                                               fov_degrees=FOV),
                             PS.VolumeTransform.create(), DIMS, DIMS, WIDTH,
                             HEIGHT, max_planes=STEPS)
    kbuf = -(-plan.k // K1.KB) * K1.KB
    fit, (_, light, _, ls) = forward_row("fit", DIMS, plan, kbuf,
                                         torch.float32)
    results.setdefault("preshear", {}).update(chest, fit=fit)

    # the adjoint of the fit's light stream
    g = torch.randn((kbuf, plan.n1, plan.n2), generator=gen, device=dev)
    got = K12.preshear_adjoint(g, ls, DIMS)
    again = K12.preshear_adjoint(g, ls, DIMS)
    check(torch.equal(got, again), "preshear_adjoint: other bits on a "
          "second run")
    want = K12.preshear_adjoint_plain(g, ls).permute(K12._inverse(ls.ax))
    err = float((got - want).abs().max()) / float(want.abs().max())
    check(err <= PRESHEAR_ADJOINT_LIMIT, f"preshear_adjoint: {err:.3e} of "
          f"the largest plain value")
    del want
    ms = cuda_ms(torch, lambda: K12.preshear_adjoint(g, ls, DIMS), 10)
    dms = device_ms(torch, lambda: K12.preshear_adjoint(g, ls, DIMS), 10)
    plain_ms = cuda_ms(torch, lambda: K12.preshear_adjoint_plain(g, ls), 2)
    leaf = light.clone().requires_grad_()
    _, lib_out = parent(plan, kbuf, torch.float32, leaf, leaf)
    lib_grad = torch.autograd.grad(lib_out, leaf, g, retain_graph=True)[0]
    lib_err = float((lib_grad - got).abs().max()) / float(got.abs().max())

    def lib():
        return torch.autograd.grad(lib_out, leaf, g, retain_graph=True)

    lib_ms = cuda_ms(torch, lib, 5)
    lib_dms = device_ms(torch, lib, 5)
    row = dict(max_rel_err=err, ms=ms, device_ms=dms[0],
               device_ops_per_call=dms[1], plain_ms=plain_ms,
               library_ms=lib_ms, library_device_ms=lib_dms[0],
               library_rel_err=lib_err,
               **_bound(g.numel() * 4 + got.numel() * 4,
                        (g.numel() + got.numel()) * PRESHEAR_ADJOINT_OPS))
    results.setdefault("preshear_adjoint", {}).update(row)
    print(f"[kernel] preshear_adjoint fit: the light stream's (float32) | "
          f"{err:.3e} of the largest plain value (limit "
          f"{PRESHEAR_ADJOINT_LIMIT:.0e}), the same bits twice | kernel "
          f"{ms:.4f} ms back to back, {dms[0]:.4f} ms on the device "
          f"({dms[1]:g} device ops) | bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}) | plain {plain_ms:.3f} ms | autograd through "
          f"the parent's bmm composition {lib_ms:.4f} ms, {lib_dms[0]:.4f} ms "
          f"on the device, {lib_err:.3e} from K12 | {card}", flush=True)


def _phases(argv) -> set | None:
    """The phases of 12, 13 and 14 that ``--phases a,b`` names; None:
    all."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: chip_smoke.py [--phases 12,13,14]")
    phases = {int(p) for p in argv[1].split(",")}
    if not phases or not phases <= {12, 13, 14}:
        raise SystemExit("--phases takes 12, 13 and 14 alone")
    return phases


def some_phases(torch, phases, volume, tf, win, light, cam, transform, clip,
                card) -> int:
    """Phases 12, 13 and 14 alone (``--phases``), 12 on phase 3's scene
    and its light volume and plan; then the launches they counted, phase
    14's kernel rows and the result line."""
    from tbraymarcherplugin_tpu_torch.ops import lighting as Lt
    from tbraymarcherplugin_tpu_torch.ops import shearwarp as SW

    results = collections.defaultdict(dict)
    if 12 in phases:
        t12 = time.perf_counter()
        light_volume = Lt.reset_all_lights(
            volume, tf, win, clip.center, clip.direction,
            [(transform.local_light_direction(light), 1.0)], DIMS)
        plan = SW.plan_shearwarp(cam, transform, DIMS, DIMS, WIDTH, HEIGHT,
                                 max_planes=STEPS)
        parallel_phase(torch, volume, tf, light_volume, plan, cam,
                       transform, clip, card, results)
        del light_volume
        torch.cuda.synchronize()
        print(f"[time] phase 12 {time.perf_counter() - t12:.1f} s | {card}",
              flush=True)
    if 13 in phases:
        del volume
        torch.cuda.empty_cache()
        t13 = time.perf_counter()
        slab_phase(torch, card, results)
        torch.cuda.synchronize()
        print(f"[time] phase 13 {time.perf_counter() - t13:.1f} s, peak "
              f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"GB | {card}", flush=True)
    if 14 in phases:
        t14 = time.perf_counter()
        preshear_phase(torch, card, results)
        torch.cuda.synchronize()
        print(f"[time] phase 14 {time.perf_counter() - t14:.1f} s | {card}",
              flush=True)
    print(json.dumps({"launches": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    phases = _phases(sys.argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2

    import numpy as np

    from tbraymarcherplugin_tpu_torch.ops import _kernels
    from tbraymarcherplugin_tpu_torch.ops import composite as K1
    from tbraymarcherplugin_tpu_torch.ops import light_scan as K4
    from tbraymarcherplugin_tpu_torch.ops import lighting as Lt
    from tbraymarcherplugin_tpu_torch.ops import preshear as K12
    from tbraymarcherplugin_tpu_torch.ops import shearwarp as SW
    from tbraymarcherplugin_tpu_torch.ops import synthetic
    from tbraymarcherplugin_tpu_torch.ops import tf_alpha as K3
    from tbraymarcherplugin_tpu_torch.ops import transfer as T
    from tbraymarcherplugin_tpu_torch.ops import warp as K2
    from tbraymarcherplugin_tpu_torch.ops.rays import jitter_values
    from tbraymarcherplugin_tpu_torch.renderer import Renderer, RendererConfig
    from tbraymarcherplugin_tpu_torch.scene import (
        Camera, ClipPlane, DirLight, VolumeTransform, orbit_camera,
    )
    from tbraymarcherplugin_tpu_torch.utils.volume_info import (
        WindowingParameters,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # --- 1. environment ----------------------------------------------------
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    nvcc = _run([_kernels._nvcc(), "--version"]).splitlines()[-1]
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"nvcc: {nvcc} | device: {torch.cuda.get_device_name(0)} | "
          f"card: {card}", flush=True)

    # --- 2. build ----------------------------------------------------------
    path, build_s = _kernels.build()
    _kernels.load()
    print(f"[build] {path.name} in {build_s:.1f} s", flush=True)

    # --- 3. kernels at the main path's shapes --------------------------------
    volume = torch.from_numpy(synthetic.ct_like_phantom(DIMS, seed=0)).to(dev)
    tf = T.tf_ct_bone(device=dev)
    windowing = WindowingParameters(*WINDOW)
    win = windowing.as_vec4(dev)
    transform = VolumeTransform.create()
    clip = transform.local_clip_plane(ClipPlane.disabled())
    light = DirLight.create(LIGHT_DIR, 1.0)
    cam = Camera.look_at(CAM_POS, 0.0, fov_degrees=FOV)
    if phases is not None:
        return some_phases(torch, phases, volume, tf, win, light, cam,
                           transform, clip, card)
    results = {}

    def record(name, got, want, ms, plain_ms, dev, calls=None, bnd=None):
        err = float((got.float() - want.float()).abs().max())
        check(math.isfinite(err), f"{name}: non-finite output")
        results[name] = dict(max_abs_err=err, ms=ms, device_ms=dev[0],
                             plain_ms=plain_ms, library_ms=None,
                             **(bnd or bound(torch, name, calls)))
        print(f"[kernel] {name}: max_abs_err {err:.3e} (limit "
              f"{LIMITS[name]:.0e}) | kernel {ms:.4f} ms back to back, "
              f"{dev[0]:.4f} ms on the device ({dev[1]:g} device ops per "
              f"call) | plain {plain_ms:.3f} ms | bound "
              f"{results[name]['bound_ms']:.4f} ms "
              f"({results[name]['bound_by']}) | {card}", flush=True)
        check(err <= LIMITS[name], f"{name} disagrees with its plain version")

    # K3 and K4 on the primary face of the light at 256^3.
    local_dir = transform.local_light_direction(light)
    axes = Lt.local_light_major_axes(local_dir)
    face = axes.faces[0]
    fp = Lt.plan_face_propagation(face, -np.asarray(local_dir, np.float64),
                                  DIMS, axes.weights[0])
    values = Lt._const_shift_trilinear(volume, DIMS, fp.uvw_offset).contiguous()
    step = float(np.float32(fp.step_size) * np.float32(100.0))
    got = K3.windowed_tf_alpha(values, tf, win, step)
    want = K3.windowed_tf_alpha_plain(values, tf, win, step)
    alpha_args = (values, tf, win, step)
    record("tf_alpha", got, want,
           cuda_ms(torch, lambda: K3.windowed_tf_alpha(*alpha_args), 20),
           cuda_ms(torch, lambda: K3.windowed_tf_alpha_plain(*alpha_args), 3),
           device_ms(torch, lambda: K3.windowed_tf_alpha(*alpha_args), 20),
           [(alpha_args, {}, got)])

    # K3's occluder source on the same face, then on the chest CT's shape
    # (a seeded uniform volume: the kernel's work does not hang on the data)
    chest = None
    for dims in (CHEST_DIMS, DIMS):
        vol = volume if dims == DIMS else torch.rand(
            dims, generator=torch.Generator(dev).manual_seed(0), device=dev)
        fpd = Lt.plan_face_propagation(
            face, -np.asarray(local_dir, np.float64), dims, axes.weights[0])
        occ_args = (vol, tf, win, dims, fpd.uvw_offset, fpd.step_size,
                    clip.center, clip.direction)
        before = Lt.occluder_opacity.launches
        got = Lt.occluder_opacity(*occ_args)
        check(Lt.occluder_opacity.launches == before + 1,
              "occluder: no launch of K3's occluder source")
        want = Lt.occluder_opacity_plain(*occ_args)
        print(f"[kernel] occluder at {dims} (light {dims}), face {face}",
              flush=True)
        dev_ms = device_ms(torch, lambda: Lt.occluder_opacity(*occ_args), 10)
        check(dev_ms[1] == 1, f"occluder took {dev_ms[1]:g} device operations "
              f"for one call")
        record("occluder", got, want,
               cuda_ms(torch, lambda: Lt.occluder_opacity(*occ_args), 10),
               cuda_ms(torch, lambda: Lt.occluder_opacity_plain(*occ_args), 2),
               dev_ms, [(occ_args, {}, got)])
        results["occluder"]["device_ops_per_call"] = dev_ms[1]
        if dims == CHEST_DIMS:
            chest = dict(results.pop("occluder"), dims=list(dims))
        del vol, got, want, occ_args
    results["occluder"]["chest"] = chest

    opacity = Lt.occluder_opacity_volume(volume, tf, win, DIMS, fp.uvw_offset,
                                         fp.step_size, clip.center,
                                         clip.direction)
    ax = Lt.transposed_axes(face)
    op_t = opacity.permute(ax)
    if Lt.face_direction(face) == -1:
        op_t = op_t.flip(2)
    op_scan = op_t.movedim(2, 0).contiguous()
    uv = np.asarray(fp.uv_offset, np.float32)
    offs = (uv[0] * np.float32(DIMS[ax[0]]), uv[1] * np.float32(DIMS[ax[1]]))
    alpha = np.float32(1.0) * np.float32(axes.weights[0])
    got = K4.propagate_face_scan(op_scan, *offs, alpha)
    want = K4.propagate_face_scan_plain(op_scan, *offs, alpha)
    scan_args = (op_scan, *offs, alpha)
    record("light_scan", got, want,
           cuda_ms(torch, lambda: K4.propagate_face_scan(*scan_args), 5),
           cuda_ms(torch, lambda: K4.propagate_face_scan_plain(*scan_args), 2),
           device_ms(torch, lambda: K4.propagate_face_scan(*scan_args), 5),
           [(scan_args, {}, got)])

    # K1 on the full frame's plan, bf16 streams, jitter on.
    light_volume = Lt.reset_all_lights(volume, tf, win, clip.center,
                                       clip.direction, [(local_dir, 1.0)],
                                       DIMS)
    plan = SW.plan_shearwarp(cam, transform, DIMS, DIMS, WIDTH, HEIGHT,
                             max_planes=STEPS)
    check(plan is not None, "no shear-warp plan for the bench camera")
    jit = jitter_values(plan.n2, plan.n1, 0, device=dev)
    ops = K1.prepare_composite(volume, tf, light_volume, plan, win,
                               clip.center, clip.direction, jitter=jit)
    check(ops["W"].dtype == torch.bfloat16, "planes are not bf16 on the card")
    inter = K1.composite(**ops)
    stats = {}  # the work the kernel's threads do on these inputs
    want = K1.composite_plain(**ops, stats=stats)
    record("composite", inter, want,
           cuda_ms(torch, lambda: K1.composite(**ops), 10),
           cuda_ms(torch, lambda: K1.composite_plain(**ops), 2),
           device_ms(torch, lambda: K1.composite(**ops), 10),
           bnd=composite_bound(torch, ops, inter, stats))
    tiles = K1.tile_plane_bounds(ops["pa"], plan.n1, plan.n2, ops["d1"],
                                 ops["d2"], plan.k, jitter=True)
    pairs = int(np.maximum(tiles[..., 1] - tiles[..., 0], 0).sum()
                * K1.TILE[0] * K1.TILE[1])
    print(f"[kernel] composite plan: n1={plan.n1} n2={plan.n2} K={plan.k} "
          f"axis={plan.axis} swap_warp={plan.swap_warp} | work {stats} | "
          f"(pixel, plane) pairs in the tiles' intervals {pairs} of "
          f"{plan.n1 * plan.n2 * plan.k} | bound "
          f"{results['composite']['bound_ms']:.4f} ms, the first design's "
          f"{results['composite']['old_bound_ms']:.4f} ms", flush=True)

    # K2: both warp passes of the frame.
    p1r, p2r, pdr, Wd, Hd = SW.warp_rows(plan, WIDTH, HEIGHT)
    idx1 = K2.pass1_index(plan, Wd, p1r, p2r, pdr, dev)
    rows1 = inter.transpose(1, 2).reshape(4 * plan.n2, plan.n1)
    M = K2.row_lerp(rows1, idx1, 4)
    idx2, _ = SW.screen_fields(plan, Wd, Hd, p1r, p2r, pdr, dev)
    rows2 = M.view(4, plan.n2, Wd).transpose(1, 2).reshape(4 * Wd, plan.n2)
    passes = ((rows1, idx1), (rows2, idx2))
    err_in = [(K2.row_lerp(r, i, 4), K2.row_lerp_plain(r, i, 4)) for r, i in passes]
    record("row_lerp", torch.cat([a.flatten() for a, _ in err_in]),
           torch.cat([b.flatten() for _, b in err_in]),
           sum(cuda_ms(torch, lambda r=r, i=i: K2.row_lerp(r, i, 4), 20)
               for r, i in passes),
           sum(cuda_ms(torch, lambda r=r, i=i: K2.row_lerp_plain(r, i, 4), 3)
               for r, i in passes),
           [sum(x) for x in zip(*(
               device_ms(torch, lambda r=r, i=i: K2.row_lerp(r, i, 4), 20)
               for r, i in passes))],
           [((r, i, 4), {}, a) for (r, i), (a, _) in zip(passes, err_in)])
    # the same lerps as one PyTorch call each: the yardstick `library_ms`
    lib = [row_lerp_library_args(torch, r, i, 4) for r, i in passes]
    lib_err = max(float((torch.nn.functional.grid_sample(*a, **LERP_KW)
                         .reshape(b.shape) - b).abs().max())
                  for a, (_, b) in zip(lib, err_in))
    lib_ms = sum(cuda_ms(torch, lambda a=a: torch.nn.functional.grid_sample(
        *a, **LERP_KW), 20) for a in lib)
    lib_dev = sum(device_ms(torch, lambda a=a: torch.nn.functional.grid_sample(
        *a, **LERP_KW), 20)[0] for a in lib)
    results["row_lerp"].update(library_ms=lib_ms, library_device_ms=lib_dev)
    print(f"[kernel] row_lerp as grid_sample (border, align_corners): "
          f"max_abs_err against the plain version {lib_err:.3e} (limit "
          f"{LIBRARY_LERP_LIMIT:.0e}) | {lib_ms:.4f} ms back to back, "
          f"{lib_dev:.4f} ms on the device, both passes | {card}", flush=True)
    check(lib_err <= LIBRARY_LERP_LIMIT, "grid_sample != the row lerp")
    check(results["row_lerp"]["max_abs_err"] == 0.0,
          "K2 is not exactly its plain version on the warp passes")
    del lib
    spread = float((idx1.amax(1) - idx1.amin(1)).max())
    print(f"[kernel] row_lerp pass-1 index spread per row: {spread:.1f} "
          f"texels (exact at any spread)", flush=True)
    del ops, inter, want, got, opacity, op_scan, values, M, err_in

    # --- 4. the slice ------------------------------------------------------
    def make_renderer():
        r = Renderer(volume, tf_table=tf, windowing=windowing,
                     transform=transform,
                     config=RendererConfig(step_count=STEPS, jitter=True),
                     device=dev)
        r.add_light("sun", light)
        return r

    radius = math.hypot(CAM_POS[0], CAM_POS[1])
    angle0 = math.atan2(CAM_POS[1], CAM_POS[0])
    cams = [orbit_camera(angle0 + 0.2 * i, radius, CAM_POS[2],
                         fov_degrees=FOV) for i in range(4)]
    kernels = (K1.composite, K2.row_lerp, Lt.occluder_opacity,
               K4.propagate_face_scan, K12.preshear)
    names = ("composite", "row_lerp", "occluder", "light_scan", "preshear")
    rk = make_renderer()
    for k in kernels:
        k.launches = 0
    _, rebuild_ms = host_ms(torch, rk.ensure_lighting)
    frames, frame_ms = [], []
    for c in cams:
        img, ms = host_ms(torch, lambda c=c: rk.render(c, WIDTH, HEIGHT))
        frames.append(img)
        frame_ms.append(ms)
    rk.update_light("sun", DirLight.create((0.1, 0.4, -0.9), 1.0))
    img, move_ms = host_ms(torch, lambda: rk.render(cams[0], WIDTH, HEIGHT))
    frames.append(img)
    launches = {n: k.launches for n, k in zip(names, kernels)}
    print(f"[slice] launches {launches} | rebuild {rebuild_ms:.2f} ms | "
          f"frames {', '.join(f'{m:.2f}' for m in frame_ms)} ms | light move "
          f"+ frame {move_ms:.2f} ms | {card}", flush=True)
    for n in names:
        check(launches[n] > 0, f"kernel {n} was not launched by the main path")
        results.setdefault(n, {})["launches"] = launches[n]
    check(launches["preshear"] == 2 * launches["composite"],
          "preshear: not one launch a stream and frame on the main path")
    calls = {}
    with capture_calls(calls, ["light_scan"]), torch.no_grad():
        make_renderer().ensure_lighting()
    with torch.no_grad():
        n_ops = light_scan_faces(torch, calls["light_scan"], card)
    results["light_scan"]["device_ops_per_call"] = max(n_ops)
    del calls

    sums = []
    for f in frames:
        check(tuple(f.shape) == (HEIGHT, WIDTH, 4), f"frame shape {f.shape}")
        check(bool(torch.isfinite(f).all()), "non-finite frame")
        cover = float((f[..., 3] > 0.01).float().mean())
        check(cover > 0.05, f"alpha coverage {cover:.3f} too small")
        sums.append(float(f.double().sum()))
    check(len(set(sums)) == len(sums), f"frame checksums repeat: {sums}")

    rp = make_renderer()
    with all_plain():
        ref = rp.render(cams[0], WIDTH, HEIGHT)
    rk2 = make_renderer()
    got = rk2.render(cams[0], WIDTH, HEIGHT)
    frame_err = float((got - ref).abs().max())
    print(f"[slice] frame vs all-plain path on the card: max_abs_err "
          f"{frame_err:.3e} (limit {FRAME_VS_PLAIN_LIMIT:.0e}) | checksums "
          f"{', '.join(f'{s:.1f}' for s in sums)}", flush=True)
    check(frame_err <= FRAME_VS_PLAIN_LIMIT, "kernel frame != plain frame")
    del rp, rk2, ref, got, frames

    # Small scene: the card (bf16 planes) against the CPU path (float32).
    small = synthetic.ct_like_phantom((24, 24, 24), seed=0)
    imgs = []
    for d in (dev, torch.device("cpu")):
        r = Renderer(small, tf_table=T.tf_ct_bone(device=d),
                     windowing=windowing,
                     config=RendererConfig(step_count=20, jitter=True),
                     device=d)
        r.add_light("sun", light)
        imgs.append(r.render(cam, 64, 48).cpu())
    diff = (imgs[0] - imgs[1]).abs()
    print(f"[small] card vs CPU at 24^3, 64x48: mean {float(diff.mean()):.2e} "
          f"(limit {SMALL_MEAN_LIMIT:.0e}), max {float(diff.max()):.2e} "
          f"(limit {SMALL_MAX_LIMIT:.0e})", flush=True)
    check(float(diff.mean()) < SMALL_MEAN_LIMIT
          and float(diff.max()) < SMALL_MAX_LIMIT, "card != CPU on 24^3")
    torch.cuda.synchronize()

    # --- 5. fwd+bwd --------------------------------------------------------
    fwd_bwd_phase(torch, volume, cam, transform, clip, card, results)
    torch.cuda.synchronize()

    # --- 6. march ----------------------------------------------------------
    march_phase(torch, volume, tf, windowing, light, cam, transform, card,
                results)
    torch.cuda.synchronize()

    # --- 7. the dense fwd+bwd ----------------------------------------------
    dense_phase(torch, volume, cam, transform, clip, card, results)
    torch.cuda.synchronize()

    # --- 8. fit ------------------------------------------------------------
    fit_phase(torch, volume, cam, transform, clip, card)
    torch.cuda.synchronize()

    # --- 9. the gather probe (K11) -----------------------------------------
    gather_phase(torch, card, results)
    torch.cuda.synchronize()

    # --- 10. the intensity and octree modes, the depth ceiling ---------------
    modes_phase(torch, volume, tf, windowing, light, cam, transform, card,
                results)
    torch.cuda.synchronize()

    # --- 11. from disk: a CT series to PNGs through the CLI and viewer ------
    t11 = time.perf_counter()
    from_disk_phase(torch, card)
    torch.cuda.synchronize()
    now = time.perf_counter()
    print(f"[time] phase 11 {now - t11:.1f} s | the script up to here "
          f"{now - T0:.1f} s (host clock) | {card}", flush=True)

    # --- 12. parallel: the sharded paths on a world-1 NCCL group ----------
    t12 = time.perf_counter()
    parallel_phase(torch, volume, tf, light_volume, plan, cam, transform,
                   clip, card, results)
    torch.cuda.synchronize()
    now = time.perf_counter()
    print(f"[time] phase 12 {now - t12:.1f} s | the script up to here "
          f"{now - T0:.1f} s (host clock) | {card}", flush=True)

    # --- 13. slab: the sharded Renderer's kernels at the RM cell's shapes -
    del volume, light_volume, plan
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    slab_phase(torch, card, results)
    torch.cuda.synchronize()
    now = time.perf_counter()
    print(f"[time] phase 13 {now - t13:.1f} s | the script up to here "
          f"{now - T0:.1f} s (host clock) | {card}", flush=True)

    # --- 14. the pre-shear (K12) and its adjoint ---------------------------
    t14 = time.perf_counter()
    preshear_phase(torch, card, results)
    torch.cuda.synchronize()
    now = time.perf_counter()
    print(f"[time] phase 14 {now - t14:.1f} s | the script up to here "
          f"{now - T0:.1f} s (host clock) | {card}", flush=True)

    names = [n for n, _, _ in kernel_table()]
    names[1:1] = ["composite_intensity", "composite_unlit", "composite_depth"]
    names += ["preshear_adjoint"]
    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=SOURCES[n], replaces=REPLACES[n],
             **results[n]) for n in names
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
