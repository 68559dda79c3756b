#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tracking_sdf_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a CUDA GPU

Phases, each of which fails the run (non-zero exit) on a fault:
  1. header: GPU name and power limit, torch / CUDA / nvcc versions;
  2. build: compile the CUDA kernels from csrc/ (timed);
  3. kernels: each hand-written kernel form against its plain PyTorch version
     on the card at the main paths' shapes, with errors and times: the
     kernel's time, CUDA events around 100 back-to-back launches on inputs
     prepared outside the window, over the count (bound by the host where a
     launch takes longer to issue than to run); its device time, the
     kernel's own time per call from torch.profiler over 100 calls; the
     wrapper's time, the median CUDA-event time per call, validation and
     allocation included:
       K1 gn_reduce (the slab form's kernel over the whole grid), dense
         form, at 34,240, 8,560 and 2,160 queries (strides 3, 6, 12) on a
         256^3 grid fused from the first frame (flat layout);
       K1 gn_reduce, brick-major form, at the same queries on the bf16 D rows
         of a 256^3 and a 512^3 brick grid fused from the first frame (tum256,
         tum512); its 29 sums bitwise the plain per-query terms summed in
         launch order (gn_reduce.sums_in_launch_order);
       K1 gn_step, dense and brick-major bf16 forms (tum256, tum512), at
         34,240, 8,560 and 2,160 queries (strides 3, 6, 12 read in place
         from the point image): one step from the same state against the
         plain step (relative twist error, equal done flags and valid
         counts) and bitwise against gn_finish of the plain terms summed in
         launch order, then a whole level of max_iterations steps (equal step
         counts, pose within 1e-5 m); timed as full steps, beside the reduce
         half alone (gn_reduce), and as launches on a done state;
       tracking with no host sync: one frame's track_frame_pyramid on the
         tum256 view under torch.cuda.set_sync_debug_mode("error"), with the
         preset's levels (2, 1) and with (4, 2, 1), read after;
       K2 brick_merge, dense form, at cap 6144 / cap_act 24,576, geometry and
         color, max_weight 128 with voxels at the clamp: bitwise against
         the plain version (every stored value compared), the share
         of the bound and the rate over the bytes it must move printed, and
         beside them the first version's device time (before its redesign);
       K2 brick_merge_rows, row form, at cap 6144 / cap_free 2048 on bf16 rows
         and the packed color leaf, geometry and color, voxels at the clamp
         (bitwise on every stored non-NaN value, equal NaN masks); off the
         presets' path, which brick_fuse_rows took over;
       K2 brick_fuse_rows, the fused FULL-update + merge form, on the real
         FULL / FREE lists of the second frame against the grid fused from
         the first, at tum256 and tum512 (the presets' caps, bf16 rows),
         geometry and color: bitwise as above; beside its times, the bound
         from these inputs (D, W and C rows read and written once, the
         distinct group-centre pixel rows, the lists) and the device time of
         the unfused chain it replaces (_full_brick_updates, the stack and
         brick_merge_rows) on the same inputs, from the profiler;
  4. small parity: the port's frame loop on the card against the same loop on
     the CPU (plain versions) on a 48^3 grid, flat and brick-major;
  5. main paths, each with every kernel launch count set to 0 just before it
     and read just after, over bench.py's scene and trajectory rendered on
     the card at 640x480 (frame 0 bootstraps, the rest are tracked):
       the flat bricked slice (tum256 with fusion mode "bricked",
         brick_merge "pallas"), 4 tracked frames;
       the tum256 preset as it is, 10 tracked frames;
       the tum512 preset as it is, 5 tracked frames; then, as a measurement,
         the same frames with brick_cap_free = NB (no FREE brick dropped)
         beside it.
     The kernels of each path must have launched (K1 gn_step and K2
     brick_merge on the slice; gn_step_brick and brick_fuse_rows, once per
     fused frame, on the presets, which must launch brick_merge_rows 0
     times), no frame may be rejected, and the final |t err| must stay under 46.9 mm (2
     voxels at 256^3); for the presets also within 0.5 voxel of the JAX
     package's own final |t err| on the same scene and frames. The presets'
     bf16 leaves must be free of NaN wherever W > 0, with weights in [0, 128].
  6. chunked main paths: the TUM uint16 depth decode on the card against the
     host decode (bitwise); then tum256 and tum512 through
     Reconstruction.process_chunk over the same frames (frame 0 by
     process_frame, the tracked frames in the chunks of CHUNKS: multiples of
     color_every, and chunks that start off the cadence), counts set to 0
     just before each and read just after, with a failed phase calibration
     an error. Every frame is a CUDA-graph replay, and process_chunk runs the
     replays under set_sync_debug_mode("error"), so a host sync between them
     fails the run. Held to the per-frame run: GN iterations, rejection
     flags, valid counts, mean residuals, FuseStats, the pose after each
     chunk, the trajectory file and the final rows, all bitwise where the
     per-frame run dropped no FULL brick; launches counted per replay
     (gn_step_brick 30 / 40 per tracked frame, brick_fuse_rows once per
     fused frame, brick_merge_rows never) and by torch.profiler over the
     profiled chunk. Printed: wall ms/frame over the timed chunk (its
     replays and its one read) beside the per-frame run's, device ms, ops
     and busy share per frame under replay (the profiled chunk), capture ms
     per variant, calibration ms and peak device memory. Then tum256central,
     the reference node's tracker (one level of 20 launches of K1's central
     form at pixel stride 3, no pyramid): K1's central form on its bf16 D
     and W rows (256^3) fused from the first frame, queried with the second
     at 34,240 queries from the first frame's pose, the second's and the
     second's lowered 1.2 m (queries below the grid's low face dropped, and
     some inside it): over a level from each, every launch's state bitwise
     central_step_reference's, timed four ways as K1 gn_step beside its
     bound (the points, 13 x 8 corners of D and W a valid query counted as
     reads, the state; or K1C_FLOP_PER_QUERY operations a valid query); then
     the preset per frame over phase 5's tum256 frames and through
     process_chunk in tum256's chunks, checked as above, with gn_step_central
     20 launches a tracked frame (per replay, and the profiled chunk's
     gn_central_step_kernel as often), gn_step_brick and gn_finish never,
     and no dense grid built from the rows; its final |t err| (~70 mm on
     this scene, over T_ERR_MAX, the tracker's own) within half a voxel of
     the same frames' run on the CPU (the plain versions). The kernels'
     line gains gn_central_step.
  7. dataset path, all through tracking_sdf_tpu_torch.cli.main on files under
     a temporary directory in build/: one probe for zlib.h (without it the
     phase prints "native loader: zlib.h absent on this machine" and feeds
     the CLI from the plain PNG decoder instead of --native-loader); the
     native loader built from native/loader.cpp (timed) and its one-shot
     decoders and raw stream held bitwise against the plain decoder on the
     first frames; the 120-frame tabletop sequence generated at 640x480 on
     the card (seed 0, default noise and dropout; seconds and
     min_valid_frac printed); the loader alone over the 120 frames (ms a
     frame) and the host-side staging of one chunk of raw frames (stack,
     pin, copies to the card); then, with the launch counts set to 0 just
     before each and read just after, ``--preset tum256 --dataset D
     --native-loader --chunk 8 --eval --json`` and the same with tum512:
     frames 120, ate_pairs 120, no rejected frame, ATE under 46.9 mm and within half a voxel (11.72 /
     5.86 mm) of JAX_ATE_MM, gn_step_brick 30 / 40 launches per tracked
     frame, brick_fuse_rows once per fused frame, brick_merge_rows never;
     tum256 per frame (its ATE beside the chunked one); tum256 --realtime 30
     (yielded + dropped == 120, both printed); tum256 stopped at frame 60
     with a checkpoint and resumed from it (final rows and trajectory
     bitwise equal to the uninterrupted chunked run); tum512 with
     --brick-cap-free 262144 (no FREE brick dropped) beside the preset's
     8,192: ATE, final |t err|, dropped bricks and ms a frame of both.
     Printed for every run: frames per second end to end (the wall clock
     around run(), decode, staging and first uses included) and the steady
     ms a frame on the same clock: the median time between the ends of two
     chunks over the chunk's frames (or between two frames, per frame),
     loading, stacking, staging, the replays and the read included.
  8. rendering and meshing (plain PyTorch on the card; no hand-written
     kernel): the raycaster (cold, warm, stride 2, color) and marching
     tetrahedra (trilinear colors; Shepard colors with uint16 vertices) on
     the card against the CPU on a 64^3 sphere + box grid_from_scene grid,
     and d(mean hit depth)/d(t_y) on both (rtol 1e-3); then on the final
     rows of phase 5's tum256 and tum512 runs: the dense view (ms, median
     of 5 CUDA-event timings), 640x480 renders from the final tracked pose
     (cold at strides 1, 2, 4 and warm from the stride-1 range: ms, hit
     share, dropped, median steps), the stride-1 depth against the
     analytic scene's at the true final pose (the frame fused last) over
     the pixels whose exact hit lies inside the grid's box or that miss
     (hit agreement >= 0.97, median |err| < 5 mm, 95th percentile < 20 mm),
     and the mesh with and without color (one shot at 256^3, 4 i-slabs at
     512^3) split into active cells, triangulation, compaction, colors,
     host copy and PLY write, with triangles, dropped cells, the median
     |sdf| of the vertices (under half a voxel) and the peak memory; then
     phase 7's tum256 chunked CLI run again with --mesh, --render and
     --mesh-async (publisher and CUDA-graph captures in one process): the
     PLY parses, the PNG decodes, the publisher exported with no error, the
     ATE equals phase 7's to the digit, and the launches are counted as in
     phase 7. Its numbers also go out as one JSON line, {"phase8": ...}.
  9. the reference-exact path and the remaining single-device modes:
       K2 brick_fuse_rows with the sat_skip bitset against its plain version
         on the second frame's real lists at tum256 and tum512, over rows
         whose FREE bricks sit at max_weight 3 (the first frame fused four
         times): rows and bitset bitwise, saturated bricks counted; its
         device time beside the same launch without the bitset;
       the JAX README's first command through cli.main (--preset synthetic64
         --synthetic --frames 20 --mesh P --eval): the PLY parses, the ATE
         lies within half a voxel of JAX_SYNTHETIC64_ATE_MM, K1's dense
         gn_step launched 20 times a tracked frame, brick_fuse_rows never;
         K1's dense reduction and step against their plain versions on that
         run's final 64^3 grid at the preset's stride (as phase 2 does);
       tum128 as it is per frame on phase 5's scene (|t err| within half a
         voxel of JAX_T_ERR_MM; preprocess, track and fuse ms), and through
         cli.main over phase 7's 120 frames (--native-loader when zlib.h is
         there; ATE within half a voxel of JAX_ATE_MM); K1 against its
         plain versions on the per-frame run's final 128^3 grid;
       --preset tum256 --fusion-mode dense over the same 120 frames (the
         reference's own 256^3 dense configuration): ATE beside the JAX
         CLI's, ms a frame, peak memory;
       jacobian="central" at tum128 on phase 5's scene: gn_finish launched
         once a GN iteration (its normal equations packed on the card) and
         advance_state never; |t err| within half a voxel of the JAX
         package's, track ms a frame; the
         same run on the CPU over the same depth images, with a float32 and
         with a float64 solve, |t err| beside the card's;
       the flat slice with brick_merge "xla", "rows" and "pallas", tracked
         (|t err| of each; K2's dense form only on "pallas"), and the three
         tails fusing the same five frames at their true poses: every leaf
         within 1e-5 of the pallas tail's;
       sat_skip at tum256 and tum512 with max_weight 4, per frame and
         chunked: with brick_cap_free = NB the rows bitwise equal to the run
         without the skip and n_sat > 0, brick_fuse_rows' sat form launched
         once per fused frame; at the presets' cap_free n_free,
         overflow_active and n_sat with the skip and without;
       renders of phase 5's final rows with empty_skip and with
         far_field="chamfer" against the plain march (hit masks differ on
         at most 1% of the pixels, depth within 1e-4 m on >= 98% of common
         hits: the bars of tests/test_torch_raycast_skip.py on a fused
         field; hits lost and gained and the largest depth difference
         printed), median steps and ms of each; and the band leap's
         soundness: every leap taken before a ray first enters a surface-band
         brick lands at least one voxel cell's diagonal before it.
     Its numbers also go out as one JSON line, {"phase9": ...}.
 10. multi-device (tracking_sdf_tpu_torch.parallel), with the card's name,
     power limit and compute mode (two processes on one card need
     "Default"):
       a one-rank NCCL group (a local store) in this process, for what
         follows;
       K1's slab form (slab_stepper's reduce, the pose read from its GN
         state buffer) on tum256's real bf16 rows fused from the first frame
         and on tum128's dense 128^3 masked view, split into two slabs with
         their halos, at the second frame's stride-3 queries: each slab
         against its plain version (rtol 1e-5 / atol 1e-4, equal valid
         counts); the slabs' sums against the whole grid's (valid counts
         adding up exactly; 1e-4 of max |A| / |b|, the elementwise
         rtol / atol outcome printed); on the same whole views, the gate:
         a level of one-rank iterations (the slab reduce, the group's
         all_reduce, gn_finish) bit for bit a level of gn_step launches
         after every iteration; gn_finish against advance_state (one step
         from the same sums: twist within REL_TOL_STEP, equal counts and
         flags; a level: equal steps, pose within POSE_TOL_LEVEL); its
         device time beside advance_state's host time, device time and
         device ops, and torch.linalg.solve_ex's time (the solve alone);
       K2's slab form (brick_fuse_rows with i_offset and nbi) on each slab's
         real lists of the second frame at tum256 and tum512, caps per rank
         max(256, cap // 2): bitwise against its plain version; with caps
         that bind nowhere the two slabs' rows bitwise equal to the whole
         grid's kernel at the same pose;
       the one-rank group: tum256 through Reconstruction(mesh=...) per
         frame (10 tracked frames) and chunked (4, 3, 3; CUDA graphs with
         the collectives captured), the launch counts set to 0 just before
         each and read just after (K1's slab form and gn_finish 20 each a
         tracked frame, K2's once a fused frame, no single-device form;
         printed a tracked frame by counter), chunked equal to per frame bit
         for bit, |t err| within half a voxel of the JAX package's sharded
         figure; ms a frame, collectives a frame and their host time, device
         ops, device time and NCCL kernels' device time in a profiled frame
         and in a replayed chunk;
       a two-rank Gloo group of processes sharing the card
         (tracking_sdf_tpu_torch.parallel.worker): tum256 (10 tracked
         frames) and tum512 (5): both ranks' poses and trajectories
         identical, |t err| within half a voxel of the JAX package's sharded
         figures, tum256's gathered rows against the one-rank run (pose
         1e-4, W 1e-3, D 1e-2 on observed voxels: tests/test_parallel.py's
         bars); on its final grid the sharded 640x480 render (bitwise the
         single-device render of the gathered grid), the sharded mesh (the
         ranks' triangles equal marching_cubes of the gathered grid) and a
         checkpoint restored bitwise into the group, into one device and
         into the one-rank mesh;
       the CLI as a two-rank group on phase 7's 120 frames (--multihost
         --coordinator localhost:PORT --num-processes 2 --process-id r
         --distributed --preset tum256 --dataset D --native-loader --chunk 8
         --eval --json): byte-identical trajectories, ATE within half a
         voxel of the JAX package's sharded figure, each rank's steady ms a
         frame; then with --realtime 30: identical trajectories and drops.
     Its numbers also go out as one JSON line, {"phase10": ...}, and the
     kernels' line gains the slab forms (gn_reduce_slab_brick, gn_finish,
     brick_fuse_rows_slab; launches from the one-rank mesh's runs, and
     gn_finish's from phase 9's central tracker too).
 11. packed, --debug-nans and the library surface:
       K1 gn_step on float32 brick rows (what fusion.mode="packed" runs) at
         the tum256 preset's queries against its plain step, as in phase 3;
         K2 brick_fuse_rows on float32 rows at tum256 and tum512 (packed's
         flat classification, the presets' caps), geometry and color,
         bitwise on the second frame's real lists, with its times and bound;
       tum256 and tum512 through cli.main --fusion-mode packed --dataset D
         --native-loader --eval per frame on phase 7's 120 frames: float32
         rows, flat classification, gn_step_brick 30 / 40 launches a
         tracked frame and brick_fuse_rows once a fused frame (these runs'
         launches are the float32 forms'), tum256's ATE within
         PACKED_ATE_TOL_MM of the JAX package's packed figure; ms a frame
         and peak memory;
       --debug-nans: tum256 through the CLI per frame and --chunk 8, each
         trajectory byte for byte phase 7's run without the flag; the
         check's device ms a frame (the rows a frame listed, beside the
         whole grid) at tum256 and tum512; a NaN written by device ops into
         a listed row where W > 0 at frame 3 raises FloatingPointError
         naming frame 3, per frame and chunked, on one device and on a
         one-rank NCCL group;
       the JAX README's library example with the port's name and no
         device=: Reconstruction(tum_fr1_camera(), preset("tum256")) on the
         card, 3 frames of phase 7's sequence, a render and a mesh.
     Its numbers go out as {"phase11": ...}; the kernels' line gains
     gn_step_brick_f32 and brick_fuse_rows_f32 (launches from the packed
     runs).
 12. depth preprocessing (csrc/preprocess.cu): K3's separable kernel (the
     separable filter in one launch, and each one-axis mode), K3's 2-D form
     and K4 (backprojection and normals from depth, and normals from a point
     image) against their plain versions at 640x480 on the scene's second
     frame and on a copy with NaN speckle, zero and negative depth and an
     all-NaN row: max abs error of depth, points and normals, NaN-mask
     mismatches and values that differ bit for bit, both of which must be 0;
     each kernel timed four ways (device from the profiler, events over 100
     launches, the wrapper, the plain version with its device ops) beside
     its bound from this run's data (bytes read and written once; the
     filters' operations over their finite taps), K3's separable launch
     with its one-axis modes' device times and the floor its precise expf
     sets (one MUFU ex2 a finite tap, 16 a clock an SM at the card's
     maximum SM clock), and both beside their device times before this
     design; the whole preprocess_frame, separable and full, kernels against
     plain, in device ms, device ops and host ms a call. Then the layouts
     the card paths take: preprocess_frame and both filters on a cropped, a
     transposed and a float64 copy of the frame, and both filters at
     radius 17 (the runtime-radius code), bitwise the plain version on the
     float32 frame;
     Reconstruction.process_frame over three frames at tum128 (the 2-D
     filter) and tum256 (separable) fed cropped, transposed and float64
     depth, poses and grid bitwise the contiguous run's. Every main path
     above also checks, from its counters (counted per replay in a chunk,
     per rank in the two-rank group), that K4 ran once per processed frame
     and K3 once (either filter) or never (no filter), and the profiled
     chunks that their kernels ran as often. Its numbers go out as
     {"phase12":
     ...}; the kernels' line gains bilateral_pass, bilateral_2d and normals
     (launches per processed frame of the paths that ran them; library_ms
     null: no single PyTorch call computes either function).
 13. brick classification, compaction and the pixel table
     (csrc/brick_classify.cu): on the scene's second frame, preprocessed
     as each preset does, from the pose the per-frame run fused it at, at
     tum256 (flat) and tum512 (hierarchical): K5 frame_tables (the zeta /
     eta mip and the color pixel table in one launch, and the geometry
     table alone), K6 classify_bricks in its flat form (every brick), its
     super form with and without phase 9's sat_skip bitset (and "all
     children saturated") and its children form (the children of the first
     cap_mixed mixed supers, classes and global ids), each on the plain
     mip; then
     classify_compact_rows (K5, K6, K7) against
     classify_compact_rows_reference at the preset's caps (tum512's FREE cap
     overflows), with the caps cut to a quarter, with the sat bitset and on
     the slab of the second half of the brick layers (i_offset m / 2): every
     class byte, id, count, mip cell and table value bit for bit, and 3 / 5
     launches a call; K5 also on copies of its inputs 4 bytes off a 16-byte
     boundary (its scalar loads). Each kernel form timed four ways (events over 100
     launches, device from the profiler, the wrapper, the plain version)
     beside its bound from this run's data (K5: points, normals and rgb
     read, table and mip written; K6: its class bytes and the mip, or
     K6_FLOP_PER_BRICK operations a brick; K7: its flags read, its lists
     written); classify_compact_rows with the pixel table, kernels against
     plain, in device ms, ops and host ms a call. Every main path above also
     checks, from its counters (per replay in a chunk, per rank in the
     two-rank group), that a fused frame ran K5 once and K6 and K7 once
     (flat) or twice (hierarchical), K5 and K6 once on the flat bricked
     layout, none on the dense path, and the profiled chunks that their
     kernels ran as often. Its numbers go out as {"phase13": ...}; the
     kernels' line gains frame_tables, classify_bricks and compact_lists
     (launches per fused frame of the paths that ran them; library_ms null:
     no single PyTorch call classifies bricks or builds the mip).
The last two lines are the kernels' JSON record (bound_ms from this run's
inputs: bytes each read or written once at 3.35 TB/s, or float32 operations
at 67 TFLOP/s, whichever is longer) and {"ok": true, "device": {...}}.
Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

K_FRAMES = 10  # tracked frames of the trajectory after the bootstrap frame
TRACKED = {"slice": 4, "tum256": 10, "tum512": 5}  # tracked frames per main path
REL_TOL_GN = 1e-4  # K1: max |A - A_ref| / max |A_ref| (and b); sums differ in order
# K1 step: max |twist - twist_ref| / max |twist_ref| after one step (sums in
# another order, the solve in float64 against float32)
REL_TOL_STEP = 1e-4
POSE_TOL_LEVEL = 1e-5  # m and rad entries: a whole level, kernel vs plain steps
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
K1_FLOP_PER_QUERY = 280  # a valid query: pose, 8 corners, gradient, J, JᵀJ
# a valid query of K1's central form: the world point and its voxel
# coordinates, the 12 probes' coordinates, 13 Shepard-L1 blends of 8 corners,
# J, JᵀJ and J r (derived in perfbench/metrics/gn_central_step_roofline.py)
K1C_FLOP_PER_QUERY = 1033
TIMED_LAUNCHES = 100
# The chunked presets: the per-frame run's tracked frames in chunks (size,
# role). tum256 (color every 2nd frame): absolute frames 2-3, 4-7, 8 and
# 9-11, the last starting off the cadence; tum512 (every 3rd): 2-4, off the
# cadence, then 5 and 6. The timed and profiled chunks replay graphs that
# earlier chunks captured.
CHUNKS = {"tum256": ((2, "calibrated"), (4, "timed"), (1, "calibrated"), (3, "profiled")),
          "tum512": ((3, "calibrated"), (1, "timed"), (1, "profiled"))}
COARSE_ITERATIONS = 10  # GN launches of a coarse pyramid level (track_frame_pyramid)
# the reference node's tracker (K1's central form), per frame and in
# tum256's chunks over the same tracked frames as tum256
CENTRAL = "tum256central"
KERNEL_NAMES = ("gn_step_kernel", "gn_central_step_kernel", "brick_fuse_rows_kernel",
                "brick_merge_rows_kernel", "bilateral_pass_kernel", "bilateral_2d_kernel", "normals_kernel",
                "frame_tables_kernel", "classify_bricks_kernel", "compact_lists_kernel",
                "compact_lists_hier_kernel")
ABS_TOL_MERGE = 1e-5  # K2 dense form: same float32 formula per voxel
# K2's dense form before its redesign (one voxel a thread, one block a
# brick): device ms on kernel_merge's inputs with color (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md's kernel table)
MERGE_DEVICE_MS_FIRST = 0.45458
T_ERR_MAX = 0.0469  # m: the absolute |t err| bound, 2 voxels at 256^3
# Final |t err| (mm) of the JAX package on the same scene, trajectory and
# frames (tum256: 11 frames, tum512: 6), unmodified presets at full size, run
# with JAX on the CPU (jax 0.9.0). A preset on the card must land within half
# a voxel of it.
JAX_T_ERR_MM = {"tum256": 35.7974, "tum512": 21.4949}
# ATE RMSE (mm) of the JAX package's CLI (--native-loader, per frame, JAX on the
# CPU, jax 0.9.0, unmodified presets at full size) over the 120 frames that
# tracking_sdf_tpu_torch.data.make_sequence writes with its defaults (tabletop,
# seed 0, 640x480), rendered on the CPU. A preset on the card must land within
# half a voxel of it.
JAX_ATE_MM = {"tum256": 9.8514, "tum512": 5.8813}
# tools/jax_reference_figures.py (JAX 0.9.0 on the CPU, unmodified presets):
# tum128 per frame on the scene above (11 frames), with the analytic and with
# the central Jacobian; the CLI over the 120 generated frames (per frame,
# --native-loader) at tum128 and at tum256 with --fusion-mode dense; and the
# JAX README's first command (--preset synthetic64 --synthetic --frames 20
# --mesh P --eval --json), whose synthetic frames both CLIs generate alike.
JAX_T_ERR_MM.update({"tum128": 20.1332, "tum128_central": 17.0512})
JAX_ATE_MM.update({"tum128": 15.2673, "tum256_dense": 6.6254})
JAX_SYNTHETIC64_ATE_MM = 6.1332
DATASET_FRAMES = 120
DATASET_CHUNK = 8


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def events_ms(fn, n: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    """CUDA-event time of ``n`` back-to-back calls, over ``n``."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def all_device_ms(fn, n: int = 20):
    """(device ms, device ops) per call of ``fn``: every device operation's
    self time from torch.profiler over ``n`` calls, summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in ev) / 1e3 / n,
            sum(e.count for e in ev) / n)


def kernel_device_ms(fn, keys, n: int = TIMED_LAUNCHES, tries: int = 2):
    """Device time per call of ``fn`` in the kernels whose names hold one of
    ``keys`` (each launched once a call), from torch.profiler over ``n``
    calls: each kernel's mean over the launches the profiler saw, summed.
    A profile that saw none of them is taken again, up to ``tries`` in all;
    None when none saw any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and any(k in e.key for k in keys)]
        seen = sum(e.count for e in ev)
        if seen < n * len(ev) or not ev:
            print(f"  the profiler saw {seen} launches of {keys} over {n} calls")
        if ev:
            return sum(e.self_device_time_total / e.count for e in ev) / 1e3
    return None


def bound(nbytes: float, flops: float = 0.0):
    """(bound_ms, bound_by): the longer of the bytes over the memory rate
    and the float32 operations over the float32 rate."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def k1_bound(n: int, nvalid: int, elem_bytes: int, out_bytes: int):
    """K1 at n queries: the points (12 B each), the 8 corners of each valid
    query, the output; K1_FLOP_PER_QUERY for each valid query."""
    return bound(n * 12 + nvalid * 8 * elem_bytes + out_bytes,
                 nvalid * K1_FLOP_PER_QUERY)


def union(*parts):
    """A scene whose ray hits are the nearest hit of any part, whose signed
    distance is the least of the parts' and whose color is the nearest
    part's."""
    class Scene:
        def intersect(self, o, d):
            t = parts[0].intersect(o, d)
            for s in parts[1:]:
                tb = s.intersect(o, d)
                t = torch.where(torch.isnan(t), tb,
                                torch.where(torch.isnan(tb), t, torch.minimum(t, tb)))
            return t

        def sdf(self, x):
            return torch.stack([s.sdf(x) for s in parts]).amin(dim=0)

        def color(self, x):
            near = torch.stack([s.sdf(x) for s in parts]).argmin(dim=0)
            cols = torch.stack([s.color(x) for s in parts])
            return torch.gather(cols, 0, near[None, ..., None].expand(1, *near.shape, 3))[0]

    return Scene()


def make_scene():
    """bench.py's scene: sphere + box + a back wall filling the view."""
    from tracking_sdf_tpu_torch.data.synthetic import CuboidScene, SphereScene

    return union(SphereScene(center=(0.3, 1.2, 0.9), radius=0.45),
                 CuboidScene(min_corner=(-1.0, 1.0, 0.2), max_corner=(-0.3, 1.9, 0.9)),
                 CuboidScene(min_corner=(-8.0, 2.6, -8.0), max_corner=(8.0, 3.0, 8.0)))


def make_poses(device):
    """bench.py's trajectory: ~13 mm + ~0.9 deg per frame, ±30% jitter."""
    from tracking_sdf_tpu_torch.core.lie import pose_compose, se3_exp
    from tracking_sdf_tpu_torch.data.synthetic import look_at

    poses = [look_at((0.0, -0.8, 0.8), (0.0, 1.2, 0.7), device=device)]
    xi_base = torch.tensor([0.008, -0.004, 0.007, 0.007, -0.005, 0.006], device=device)
    for k in range(1, K_FRAMES + 1):
        xi_k = xi_base * (1.0 + 0.3 * (1.0 if k % 2 == 0 else -1.0))
        poses.append(pose_compose(poses[-1], se3_exp(xi_k)))
    return poses


def path_config(name, trajectory_path):
    """The presets as they are, or the flat slice (tum256 with the flat
    bricked layout); only the trajectory path changes."""
    from tracking_sdf_tpu_torch.config import preset

    cfg = dataclasses.replace(preset("tum256" if name == "slice" else name),
                              trajectory_path=trajectory_path)
    if name == "slice":
        cfg = dataclasses.replace(
            cfg, fusion=cfg.fusion._replace(mode="bricked", brick_merge="pallas"))
    return cfg


def counters():
    from tracking_sdf_tpu_torch.fusion import brick_classify as k567
    from tracking_sdf_tpu_torch.fusion import brick_fuse as k2f
    from tracking_sdf_tpu_torch.fusion import brick_merge as k2
    from tracking_sdf_tpu_torch.tracking import gn_reduce as k1
    from tracking_sdf_tpu_torch.tracking import preprocess as k34

    return {"gn_reduce": k1.launches, "gn_reduce_brick": k1.launches_brick,
            "gn_reduce_slab": k1.launches_slab,
            "gn_reduce_slab_brick": k1.launches_slab_brick,
            "gn_step": k1.launches_step, "gn_step_brick": k1.launches_step_brick,
            "gn_finish": k1.launches_finish, "gn_step_central": k1.launches_step_central,
            "brick_merge": k2.launches, "brick_merge_rows": k2.launches_rows,
            "brick_fuse_rows": k2f.launches, "brick_fuse_rows_sat": k2f.launches_sat,
            "brick_fuse_rows_slab": k2f.launches_slab,
            "bilateral_pass": k34.launches_pass, "bilateral_2d": k34.launches_2d,
            "normals": k34.launches_normals,
            "frame_tables": k567.launches_tables,
            "classify_bricks": k567.launches_classify, "compact_lists": k567.launches_compact}


def reset_counters():
    from tracking_sdf_tpu_torch.fusion import brick_classify as k567
    from tracking_sdf_tpu_torch.fusion import brick_fuse as k2f
    from tracking_sdf_tpu_torch.fusion import brick_merge as k2
    from tracking_sdf_tpu_torch.tracking import gn_reduce as k1
    from tracking_sdf_tpu_torch.tracking import preprocess as k34

    k1.launches = k1.launches_brick = k1.launches_step = k1.launches_step_brick = 0
    k1.launches_slab = k1.launches_slab_brick = k1.launches_finish = 0
    k1.launches_step_central = 0
    k2.launches = k2.launches_rows = k2f.launches = k2f.launches_sat = 0
    k2f.launches_slab = 0
    k34.launches_pass = k34.launches_2d = k34.launches_normals = 0
    k567.launches_tables = k567.launches_classify = k567.launches_compact = 0


PREPROCESS_COUNTERS = ("bilateral_pass", "bilateral_2d", "normals")


def filter_mode(cfg):
    """The bilateral filter a configuration runs: "separable", "full" or None."""
    return cfg.bilateral_mode if cfg.bilateral_filter else None


def check_preprocess(label, launches, frames: int, mode) -> None:
    """Every one of ``frames`` processed frames went through K4 once and K3
    as the filter ``mode`` says: its separable kernel once (separable), its
    2-D form once (full) or neither."""
    want = {"bilateral_pass": frames if mode == "separable" else 0,
            "bilateral_2d": frames if mode == "full" else 0, "normals": frames}
    got = {k: launches[k] for k in want}
    check(got == want, f"{label}: preprocessing launched {got} over {frames} frames, "
          f"expected {want}")


CLASSIFY_COUNTERS = ("frame_tables", "classify_bricks", "compact_lists")
# K5, K6 and K7 launches a fused frame, by the classification a
# configuration runs (classify_form)
CLASSIFY_PER_FRAME = {None: (0, 0, 0), "bricked": (1, 1, 0), "flat": (1, 1, 1),
                      "hier": (1, 2, 2)}


def classify_form(cfg):
    """How a configuration classifies a fused frame: "flat" (K5, K6, K7),
    "hier" (K5, K6 super and children, K7 flat over the supers and
    hierarchical), "bricked" (the flat bricked layout: K5, K6, and the list
    read on the host) or None (dense fusion)."""
    f = cfg.fusion
    if f.mode == "dense":
        return None
    if f.mode == "bricked":
        return "bricked"
    return "hier" if f.mode == "brickmajor" and f.hier_classify > 1 else "flat"


def check_classify(label, launches, cfg, fused=None) -> None:
    """Every fused frame went through K5-K7 as ``cfg`` classifies it
    (CLASSIFY_PER_FRAME); ``fused`` defaults to K2's row-form launches, one
    a fused brick-major frame (the flat bricked layout needs it given)."""
    form = classify_form(cfg)
    if fused is None:
        check(form != "bricked", f"{label}: the fused frames of a bricked run are needed")
        fused = sum(launches[k] for k in ("brick_fuse_rows", "brick_fuse_rows_sat",
                                          "brick_fuse_rows_slab"))
    want = {k: n * fused for k, n in zip(CLASSIFY_COUNTERS, CLASSIFY_PER_FRAME[form])}
    got = {k: launches[k] for k in want}
    check(got == want and (form is None or fused > 0),
          f"{label}: classification launched {got} over {fused} fused frames ({form}), "
          f"expected {want}")


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """The float32 elements of ``a`` and ``b`` whose bits differ."""
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def launch_order_sums(Dm, pose, q, p):
    """The plain version's per-query terms summed in K1's launch order."""
    from tracking_sdf_tpu_torch.tracking import gn_reduce as k1

    return k1.sums_in_launch_order(k1.query_terms_reference(Dm, pose, q.reshape(-1, 3), p))


def gn_compare(label, Dm, pose, pts1, p, strides=(3, 6, 12)):
    """K1 on the card against its plain version at ``strides`` of the point
    image, and its 29 sums bitwise against the plain per-query terms summed
    in launch order. Returns the first stride's record."""
    from tracking_sdf_tpu_torch.tracking.gn_reduce import (
        gn_reduce, gn_reduce_reference, gn_reducer)

    rec = {}
    for stride in strides:
        q = pts1[::stride, ::stride].reshape(-1, 3)
        out_k = gn_reduce(Dm, pose, q, p)
        out_r = gn_reduce_reference(Dm, pose, q, p)
        torch.cuda.synchronize()
        errs = {}
        for part, sl in (("A", slice(0, 21)), ("b", slice(21, 27))):
            diff = (out_k[sl] - out_r[sl]).abs().max().item()
            errs[part] = diff / max(out_r[sl].abs().max().item(), 1e-30)
        nv_k, nv_r = int(out_k[27].item()), int(out_r[27].item())
        max_abs = (out_k[:27] - out_r[:27]).abs().max().item()
        order_differ = bits_differ(out_k, launch_order_sums(Dm, pose, q, p))
        ms = events_ms(gn_reducer(Dm, pose, q, p))
        device_ms = kernel_device_ms(gn_reducer(Dm, pose, q, p),
                                     ("gn_reduce_slab_kernel",))
        wrapper_ms = cuda_time_ms(lambda: gn_reduce(Dm, pose, q, p))
        plain_ms = cuda_time_ms(lambda: gn_reduce_reference(Dm, pose, q, p))
        bms, by = k1_bound(q.shape[0], nv_k, Dm.dtype.itemsize, 29 * 4)
        print(f"{label} N={q.shape[0]}: rel err A {errs['A']:.3e} b {errs['b']:.3e}, "
              f"max abs err {max_abs:.3e}, num_valid {nv_k} (plain {nv_r}), tol rel "
              f"{REL_TOL_GN:g}; sums differing in bits from the plain terms in launch "
              f"order {order_differ}; kernel {ms:.4f} ms ({TIMED_LAUNCHES} back-to-back), "
              f"device {device_ms} ms, wrapper {wrapper_ms:.4f} ms per call, plain "
              f"{plain_ms:.4f} ms, bound {bms:.6f} ms ({by})")
        check(nv_k == nv_r and nv_k > 1000, f"{label} num_valid {nv_k} != {nv_r}")
        check(errs["A"] <= REL_TOL_GN and errs["b"] <= REL_TOL_GN,
              f"{label} disagrees with its plain version at N={q.shape[0]}: {errs}")
        check(order_differ == 0, f"{label}: {order_differ} of the 29 sums differ from the "
              f"plain terms in launch order at N={q.shape[0]}")
        rec[stride] = dict(max_abs_err=max_abs, ms=ms, device_ms=device_ms,
                           wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bms,
                           bound_by=by)
    return rec[strides[0]]


def step_compare(label, Dm, pose, pts1, p, tcfg, strides=(3, 6, 12)):
    """K1's step on the card against the plain step, at ``strides`` of the
    point image (read in place): one step from one state, which must also be
    gn_finish of the plain per-query terms summed in launch order bit for
    bit, then a whole level of ``tcfg.max_iterations`` steps. Times full
    steps (a cfg that never converges) beside the reduce half alone (the
    slab form over the whole grid, ``gn_reduce``), and launches on a done
    state. Returns the first stride's record."""
    from tracking_sdf_tpu_torch.tracking import gn_reduce as k1

    rec = {}
    for stride in strides:
        img = pts1[::stride, ::stride]
        n = img.shape[0] * img.shape[1]
        sk = k1.init_state(pose, tcfg.damping)
        sr = sk.clone()
        k1.gn_stepper(Dm, sk, img, p, tcfg)()
        k1.gn_step_reference(Dm, sr, img, p, tcfg)
        torch.cuda.synchronize()
        tk, tr = sk[k1.S_TWIST:k1.S_TWIST + 6], sr[k1.S_TWIST:k1.S_TWIST + 6]
        err = ((tk - tr).abs().max() / tr.abs().max().clamp(min=1e-30)).item()
        max_abs = (sk[:k1.S_COUNT] - sr[:k1.S_COUNT]).abs().max().item()
        ik, ir = sk.view(torch.int32), sr.view(torch.int32)
        nv_k, nv_r = int(sk[k1.S_NVALID].item()), int(sr[k1.S_NVALID].item())
        done = (int(ik[k1.S_DONE]), int(ir[k1.S_DONE]))
        # the step is the finish of the launch-order sums of the plain terms
        so = k1.init_state(pose, tcfg.damping)
        k1.finisher(so, tcfg)(launch_order_sums(Dm, pose, img, p))
        order_differ = bits_differ(sk, so)
        # a whole level
        lk = k1.init_state(pose, tcfg.damping)
        lr = lk.clone()
        step = k1.gn_stepper(Dm, lk, img, p, tcfg)
        for _ in range(tcfg.max_iterations):
            step()
            k1.gn_step_reference(Dm, lr, img, p, tcfg)
        torch.cuda.synchronize()
        iters = (int(lk.view(torch.int32)[k1.S_COUNT]), int(lr.view(torch.int32)[k1.S_COUNT]))
        dpose = (lk[:k1.S_LAM] - lr[:k1.S_LAM]).abs().max().item()
        # times: full steps, done launches, the wrapper, the plain step
        never = tcfg._replace(max_iterations=1 << 30, min_iterations=0,
                              max_twist_diff=-1.0)
        full = k1.gn_stepper(Dm, k1.init_state(pose, tcfg.damping), img, p, never)
        ms = events_ms(full)
        device_ms = kernel_device_ms(full, ("gn_step_kernel",))
        reduce_ms = kernel_device_ms(k1.gn_reducer(Dm, pose, img, p), ("gn_reduce_slab_kernel",))
        done_state = lk.clone()
        done_state.view(torch.int32)[k1.S_DONE] = 1
        frozen = k1.gn_stepper(Dm, done_state, img, p, tcfg)
        ms_done = events_ms(frozen)
        device_ms_done = kernel_device_ms(frozen, ("gn_step_kernel",))
        sw, sp = k1.init_state(pose, tcfg.damping), k1.init_state(pose, tcfg.damping)
        wrapper_ms = cuda_time_ms(lambda: k1.gn_step(Dm, sw, img, p, never))
        plain_ms = cuda_time_ms(lambda: k1.gn_step_reference(Dm, sp, img, p, never))
        bms, by = k1_bound(n, nv_k, Dm.dtype.itemsize, 2 * k1.N_STATE * 4)
        print(f"{label} N={n}: one step rel twist err {err:.3e} (tol {REL_TOL_STEP:g}), "
              f"max abs state err {max_abs:.3e}, done {done[0]} (plain {done[1]}), "
              f"num_valid {nv_k} (plain {nv_r}); level of {tcfg.max_iterations} "
              f"launches: {iters[0]} steps (plain {iters[1]}), max |pose diff| "
              f"{dpose:.3e} (tol {POSE_TOL_LEVEL:g}); state bits differing from gn_finish "
              f"of the plain terms in launch order {order_differ}; full step {ms:.4f} ms, "
              f"done launch {ms_done:.4f} ms ({TIMED_LAUNCHES} back-to-back), device "
              f"{device_ms} ms (full; its reduce half alone, gn_reduce, {reduce_ms} ms) and "
              f"{device_ms_done} ms (done), wrapper "
              f"{wrapper_ms:.4f} ms per call, plain {plain_ms:.4f} ms, bound "
              f"{bms:.6f} ms ({by})")
        check(nv_k == nv_r and nv_k > 100, f"{label} num_valid {nv_k} != {nv_r}")
        check(err <= REL_TOL_STEP and done[0] == done[1],
              f"{label} step disagrees with the plain step at N={n}: {err}, {done}")
        check(iters[0] == iters[1] and dpose <= POSE_TOL_LEVEL,
              f"{label} level disagrees with plain steps at N={n}: {iters}, {dpose}")
        check(order_differ == 0, f"{label}: the step's state differs in {order_differ} "
              f"slots from gn_finish of the plain terms in launch order at N={n}")
        rec[stride] = dict(max_abs_err=max_abs, ms=ms, ms_done=ms_done,
                           device_ms=device_ms, reduce_device_ms=reduce_ms,
                           device_ms_done=device_ms_done,
                           wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bms,
                           bound_by=by)
    return rec[strides[0]]


def tracking_without_host_sync(Dm, pose, pts1, p, tcfg, levels):
    """One frame's pyramid tracking on the card under
    set_sync_debug_mode("error"): any host sync inside it raises."""
    from tracking_sdf_tpu_torch.tracking.pyramid import track_frame_pyramid

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res, per_level = track_frame_pyramid(None, pose, pts1, params=p, cfg=tcfg,
                                             levels=levels, Dm=Dm)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    st = [r.read() for r in per_level]
    print(f"tracking levels {tuple(levels)} under set_sync_debug_mode('error'): no host "
          f"sync; steps per level {[s.iterations for s in st]}, num_valid "
          f"{st[-1].num_valid}")
    check(all(s.iterations > 0 for s in st) and st[-1].num_valid > 1000,
          f"tracking levels {tuple(levels)} ran no step")


def kernel_gn(cam, scene, poses, rgb, dev):
    """K1's dense form on the flat grid and its brick-major form on the bf16
    D rows, each fused from the first frame and queried with the second:
    the reduction, the step, and one frame's tracking with no host sync."""
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.fusion.brick import fuse_frame_bricked
    from tracking_sdf_tpu_torch.fusion.brickmajor import (
        empty_brick_grid, fuse_frame_brickmajor)
    from tracking_sdf_tpu_torch.grid.grid import empty_grid
    from tracking_sdf_tpu_torch.grid.interp import masked_view
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    flat, tum = path_config("slice", None), path_config("tum256", None)
    p = flat.grid
    pts0, nrm0 = preprocess_frame(render_scene_depth(scene, cam, poses[0]), cam=cam,
                                  bilateral_mode=flat.bilateral_mode)
    pts1, _ = preprocess_frame(render_scene_depth(scene, cam, poses[1]), cam=cam,
                               bilateral_mode=flat.bilateral_mode)
    grid = empty_grid(p, device=dev)
    fuse_frame_bricked(grid, poses[0], pts0, nrm0, rgb, params=p, cam=cam,
                       cfg=flat.fusion, bs=flat.fusion.brick_shape,
                       cap=flat.fusion.brick_cap)
    Dm = masked_view(grid.D, grid.W)
    dense = gn_compare("K1 gn_reduce (dense)", Dm, poses[0], pts1, p)
    dense_step = step_compare("K1 gn_step (dense)", Dm, poses[0], pts1, p, flat.tracking)
    del grid, Dm
    f = tum.fusion
    bg = empty_brick_grid(tum.grid, f.brick_shape, device=dev,
                          value_dtype=torch.bfloat16, weight_dtype=torch.bfloat16)
    _, view, _ = fuse_frame_brickmajor(bg, poses[0], pts0, nrm0, rgb, params=tum.grid,
                                       cam=cam, cfg=f, bs=f.brick_shape, cap=f.brick_cap,
                                       cap_free=f.brick_cap_free)
    check(view.rows.dtype == torch.bfloat16, "the tum256 view is not bf16")
    brick = gn_compare("K1 gn_reduce (brick-major bf16)", view, poses[0], pts1, tum.grid)
    brick_step = step_compare("K1 gn_step (brick-major bf16)", view, poses[0], pts1,
                              tum.grid, tum.tracking)
    for levels in (tum.pyramid_levels, (4, 2, 1)):
        tracking_without_host_sync(view, poses[0], pts1, tum.grid, tum.tracking, levels)
    del bg, view
    # tum512's bf16 rows: the same checks at the other preset
    big = path_config("tum512", None)
    f = big.fusion
    bg = empty_brick_grid(big.grid, f.brick_shape, device=dev, value_dtype=torch.bfloat16,
                          weight_dtype=torch.bfloat16)
    _, view, _ = fuse_frame_brickmajor(bg, poses[0], pts0, nrm0, rgb, params=big.grid,
                                       cam=cam, cfg=f, bs=f.brick_shape, cap=f.brick_cap,
                                       cap_free=f.brick_cap_free)
    check(view.rows.dtype == torch.bfloat16, "the tum512 view is not bf16")
    brick["tum512"] = gn_compare("K1 gn_reduce (brick-major bf16, tum512)", view, poses[0],
                                 pts1, big.grid)
    brick_step["tum512"] = step_compare("K1 gn_step (brick-major bf16, tum512)", view,
                                        poses[0], pts1, big.grid, big.tracking)
    del bg, view
    torch.cuda.empty_cache()
    return dense, brick, dense_step, brick_step


def k1c_bound(n: int, nvalid: int, d_bytes: int, w_bytes: int):
    """K1's central form at n queries: the points (12 B each), the 8
    corners of D and of W of each of a valid query's 13 probes, and the
    state read and written; K1C_FLOP_PER_QUERY for each valid query. The
    corners are counted as reads: the probes of one query and of its
    neighbours share voxels, so the distinct bytes are fewer."""
    from tracking_sdf_tpu_torch.tracking import gn_reduce as k1

    return bound(n * 12 + nvalid * 13 * 8 * (d_bytes + w_bytes) + 2 * k1.N_STATE * 4,
                 nvalid * K1C_FLOP_PER_QUERY)


def kernel_gn_central(cam, scene, poses, rgb, dev):
    """K1's central form on tum256central's bf16 D and W rows (256^3) fused
    from the first frame, queried with the second at pixel_stride: from
    three poses (the first frame's, the second's, and the second's lowered
    1.2 m, so that queries drop below the grid's low face and some of those
    inside lose a probe there) a level of max_iterations launches, each
    launch's state bitwise central_step_reference's on the same rows, points
    and state. Timed as full steps, as launches on a done state, the wrapper
    (a stepper built and launched a call) and the plain step, beside its
    bound. Returns the record."""
    from tracking_sdf_tpu_torch.core.lie import Pose
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.fusion.brickmajor import (
        brick_rows_view, empty_brick_grid, fuse_frame_brickmajor)
    from tracking_sdf_tpu_torch.grid.grid import world_to_voxel
    from tracking_sdf_tpu_torch.tracking import gn_reduce as k1
    from tracking_sdf_tpu_torch.tracking.gauss_newton import pixel_residuals_central
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    cfg = path_config(CENTRAL, None)
    f, p, tc = cfg.fusion, cfg.grid, cfg.tracking
    pts0, nrm0 = preprocess_frame(render_scene_depth(scene, cam, poses[0]), cam=cam,
                                  bilateral_mode=cfg.bilateral_mode)
    pts1, _ = preprocess_frame(render_scene_depth(scene, cam, poses[1]), cam=cam,
                               bilateral_mode=cfg.bilateral_mode)
    bg = empty_brick_grid(p, f.brick_shape, device=dev, value_dtype=torch.bfloat16,
                          weight_dtype=torch.bfloat16)
    fuse_frame_brickmajor(bg, poses[0], pts0, nrm0, rgb, params=p, cam=cam, cfg=f,
                          bs=f.brick_shape, cap=f.brick_cap, cap_free=f.brick_cap_free)
    rows = brick_rows_view(bg, p, f.brick_shape)
    img = pts1[::tc.pixel_stride, ::tc.pixel_stride]
    n = img.shape[0] * img.shape[1]
    flat = img.reshape(-1, 3)
    lowered = Pose(poses[1].R, poses[1].t + torch.tensor([0.0, 0.0, -1.2], device=dev))
    rec, last = {}, None
    for label, pose in (("first", poses[0]), ("second", poses[1]), ("lowered", lowered)):
        _, _, mask = pixel_residuals_central(rows, pose, flat, params=p, v_h=tc.v_h,
                                             w_h=tc.w_h)
        uvw = world_to_voxel(p, flat @ pose.R.T + pose.t)
        inside = ((uvw >= 0) & (uvw < p.m)).all(-1)
        finite = torch.isfinite(flat).all(-1)
        outside, lost = int((finite & ~inside).sum()), int((finite & inside & ~mask).sum())
        sk = k1.init_state(pose, tc.damping)
        sr = sk.clone()
        step = k1.central_stepper(rows, sk, img, p, tc)
        before = k1.launches_step_central
        differ, max_abs, nv0 = [], 0.0, None
        for _ in range(tc.max_iterations):
            k1.central_step_reference(rows, sr, img, p, tc)
            step()
            torch.cuda.synchronize()
            differ.append(bits_differ(sk, sr))
            max_abs = max(max_abs, (sk[:k1.S_COUNT] - sr[:k1.S_COUNT]).abs().max().item())
            nv0 = int(sk[k1.S_NVALID].item()) if nv0 is None else nv0
        steps = int(sk.view(torch.int32)[k1.S_COUNT])
        launched = k1.launches_step_central - before
        print(f"K1 gn_central_step (brick-major bf16 D and W, {CENTRAL}) N={n}, start "
              f"{label}: valid {nv0} at the first step, {outside} finite queries outside the "
              f"grid, {lost} inside it dropped (a probe or all corners lost); "
              f"{launched} launches, {steps} steps; state bits differing from "
              f"central_step_reference per launch {differ}, max |state diff| {max_abs:.3e}")
        check(launched == tc.max_iterations, f"{CENTRAL}: {launched} central launches "
              f"counted over a level of {tc.max_iterations}")
        check(sum(differ) == 0, f"{CENTRAL} start {label}: K1's central form differs from "
              f"central_step_reference in bits {differ}")
        check(nv0 > 100 and steps >= 1, f"{CENTRAL} start {label}: valid {nv0}, steps {steps}")
        if label == "lowered":
            check(outside > 1000 and lost > 0, f"{CENTRAL}: the lowered pose dropped "
                  f"{outside} queries outside the grid and {lost} inside it")
        rec[label] = dict(num_valid=nv0, steps=steps, outside=outside, lost=lost,
                          bits_differ=sum(differ), max_abs_err=max_abs)
        if label == "first":
            last = sk
    # times: full steps, done launches, the wrapper, the plain step
    never = tc._replace(max_iterations=1 << 30, min_iterations=0, max_twist_diff=-1.0)
    full = k1.central_stepper(rows, k1.init_state(poses[0], tc.damping), img, p, never)
    ms = events_ms(full)
    device_ms = kernel_device_ms(full, ("gn_central_step_kernel",))
    done_state = last.clone()
    done_state.view(torch.int32)[k1.S_DONE] = 1
    frozen = k1.central_stepper(rows, done_state, img, p, tc)
    ms_done = events_ms(frozen)
    device_ms_done = kernel_device_ms(frozen, ("gn_central_step_kernel",))
    sw, sp = k1.init_state(poses[0], tc.damping), k1.init_state(poses[0], tc.damping)
    wrapper_ms = cuda_time_ms(lambda: k1.central_stepper(rows, sw, img, p, never)())
    plain_ms = cuda_time_ms(lambda: k1.central_step_reference(rows, sp, img, p, never))
    nv = rec["first"]["num_valid"]
    bms, by = k1c_bound(n, nv, bg.D.element_size(), bg.W.element_size())
    print(f"K1 gn_central_step N={n}, {nv} valid: full step {ms:.4f} ms, done launch "
          f"{ms_done:.4f} ms ({TIMED_LAUNCHES} back-to-back), device {device_ms} ms (full) "
          f"and {device_ms_done} ms (done), wrapper {wrapper_ms:.4f} ms per call, plain "
          f"{plain_ms:.4f} ms, bound {bms:.6f} ms ({by}; corners counted as reads)")
    out = dict(rec["first"], queries=n, starts=rec,
               max_abs_err=max(r["max_abs_err"] for r in rec.values()), ms=ms,
               ms_done=ms_done, device_ms=device_ms, device_ms_done=device_ms_done,
               wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    del bg, rows, full, frozen
    torch.cuda.empty_cache()
    return out


def central_phase(cam, scene, depths, poses, rgb, dev, repo):
    """The reference node's tracker (tum256central): K1's central form
    against its plain version (kernel_gn_central), then the preset per frame
    over tum256's tracked frames and through process_chunk in tum256's
    chunks, held to the per-frame run as the other presets are, with no
    dense grid built from the rows, and the per-frame run's final |t err|
    to the same frames' run on the CPU within half a voxel. Returns (the
    kernel's record, the two paths' records)."""
    from tracking_sdf_tpu_torch.core.lie import Pose
    from tracking_sdf_tpu_torch.pipeline import runner
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    k1c = kernel_gn_central(cam, scene, poses, rgb, dev)
    traj = os.path.join(repo, "build", f"chip_smoke_{CENTRAL}.txt")
    # dense_from_brick_grid: a dense float32 grid built from the brick-major rows
    with counting(runner, "dense_from_brick_grid") as dense:
        rec, ref = run_path(CENTRAL, cam, depths, poses, rgb, dev, traj,
                            n_tracked=TRACKED["tum256"])
        chunk = run_chunk_path(CENTRAL, cam, depths, poses, rgb, dev,
                               os.path.join(repo, "build", f"chip_smoke_{CENTRAL}_chunk.txt"),
                               ref, chunks=CHUNKS["tum256"])
    print(f"{CENTRAL}: dense grids built from the rows over both runs {dense[0]} (must be 0)")
    check(dense[0] == 0, f"{CENTRAL}: the tracked path built {dense[0]} dense grids")
    # the same frames through the plain versions on the CPU (central_step_reference,
    # advance_state's float32 solve): the card's final |t err| within half a voxel
    n = TRACKED["tum256"]
    t0 = time.perf_counter()
    cpu = Reconstruction(cam, path_config(CENTRAL, None),
                         initial_pose=Pose(poses[0].R.cpu(), poses[0].t.cpu()), device="cpu")
    for k in range(n + 1):
        cpu.process_frame(depths[k].cpu(), rgb=rgb.cpu(), timestamp=float(k))
    cpu_mm = (cpu.pose.t - poses[n].t.cpu()).norm().item() * 1e3
    print(f"  {CENTRAL} on the CPU ({torch.get_num_threads()} threads, "
          f"{time.perf_counter() - t0:.1f} s): final |t err| {cpu_mm:.4f} mm, GN iterations "
          f"{[st.gn_iterations for st in cpu.stats]}; the card's {rec['t_err_mm']:.4f} mm, "
          f"{[st.gn_iterations for st in ref['stats']]}")
    bar = 0.5 * cpu.config.grid.width / cpu.config.grid.m * 1e3
    check(abs(rec["t_err_mm"] - cpu_mm) <= bar and not any(st.rejected for st in cpu.stats),
          f"{CENTRAL}: the card's final |t err| {rec['t_err_mm']:.4f} mm is not within half a "
          f"voxel ({bar:.2f} mm) of the CPU run's {cpu_mm:.4f} mm")
    rec["t_err_cpu_mm"] = cpu_mm
    del ref, cpu
    torch.cuda.empty_cache()
    return k1c, {CENTRAL: rec, f"{CENTRAL}_chunk": chunk}


def kernel_merge(dev):
    from tracking_sdf_tpu_torch.fusion.brick_merge import brick_merge, brick_merge_reference
    from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid

    m, bs, cap, cap_act, nb = 256, (8, 8, 8), 6144, 24576, 32 ** 3
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    base = {k: rand(m, m, m) for k in FIELDS}
    base["D"] = rand(m, m, m, lo=-0.3, hi=0.3)
    base["W"] = rand(m, m, m, lo=0.0, hi=140.0).clamp(max=128.0)  # ~9% at the clamp
    base["Wc"] = rand(m, m, m, lo=0.0, hi=140.0).clamp(max=128.0)
    bid = torch.randperm(nb, generator=gen, device=dev)[:cap_act].sort().values
    cls = torch.where(rand(cap_act) < 0.3, 2, 1).to(torch.int32)
    full_pos = torch.nonzero(cls == 2).reshape(-1)
    slot = torch.full((cap_act,), cap, dtype=torch.int32, device=dev)
    slot[full_pos[:cap]] = torch.arange(min(cap, full_pos.numel()), dtype=torch.int32,
                                        device=dev)
    check(full_pos.numel() > cap, "K2 inputs must hold FULL bricks past the cap")
    rec = {}
    for C in (2, 6):
        upd = rand(cap + 1, *bs, C, lo=0.0, hi=2.0)
        upd[..., 0][rand(cap + 1, *bs) < 0.2] = 0.0
        upd[cap] = 0.0
        args = (upd, bid.to(torch.int32), cls, slot)
        kw = dict(bs=bs, delta=0.3, max_weight=128.0)
        gk = TSDFGrid(**{k: v.clone() for k, v in base.items()})
        gr = TSDFGrid(**{k: v.clone() for k, v in base.items()})
        brick_merge(gk, *args, **kw)
        brick_merge_reference(gr, *args, **kw)
        torch.cuda.synchronize()
        err = max((getattr(gk, k) - getattr(gr, k)).abs().max().item() for k in FIELDS)
        differ = sum(int((getattr(gk, k).view(torch.int32)
                          != getattr(gr, k).view(torch.int32)).sum()) for k in FIELDS)
        at_clamp = int((gk.W == 128.0).sum().item())
        ms = events_ms(lambda: brick_merge(gk, *args, **kw))
        device_ms = kernel_device_ms(lambda: brick_merge(gk, *args, **kw),
                                     ("brick_merge_kernel",))
        wrapper_ms = cuda_time_ms(lambda: brick_merge(gk, *args, **kw))
        plain_ms = cuda_time_ms(lambda: brick_merge_reference(gr, *args, **kw))
        # per voxel: a FULL brick in the cap reads C update channels and reads
        # and writes D, W (and R, G, B, Wc); a FREE brick reads and writes D, W
        n_full, n_free = min(cap, full_pos.numel()), int((cls == 1).sum())
        nbytes = 512 * (n_full * (4 * C + 8 * (2 if C == 2 else 6)) + n_free * 16)
        bms, by = bound(nbytes)
        share = bms / device_ms if device_ms else float("nan")
        rate = nbytes / (device_ms * 1e-3) / 1e12 if device_ms else float("nan")
        print(f"K2 brick_merge (dense) C={C} cap={cap} cap_act={cap_act}: max abs err "
              f"{err:.3e} (tol {ABS_TOL_MERGE:g}), {differ} stored values differ from the "
              f"plain version bit for bit, {at_clamp} voxels at max_weight; kernel "
              f"{ms:.4f} ms ({TIMED_LAUNCHES} back-to-back), device {device_ms} ms, "
              f"wrapper {wrapper_ms:.4f} ms per call, plain {plain_ms:.4f} ms, bound "
              f"{bms:.6f} ms ({by}; {n_full} FULL, {n_free} FREE bricks): {share:.1%} of "
              f"the bound, {rate:.3f} TB/s of the {nbytes / 1e6:.1f} MB it must move"
              + (f"; before the redesign {MERGE_DEVICE_MS_FIRST} ms device"
                 if C == 6 else ""))
        check(err <= ABS_TOL_MERGE, f"K2 disagrees with its plain version (C={C}): {err}")
        # the __f*_rn arithmetic makes the dense merge the plain version bit for bit
        check(differ == 0, f"K2 is not bitwise its plain version (C={C}): {differ} values")
        check(at_clamp > 0, "K2 inputs reached no clamp")
        rec[C] = dict(max_abs_err=err, differ=differ, ms=ms, device_ms=device_ms,
                      wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                      bound_share=share, tb_per_s=rate)
    return dict(rec[6], geometry=rec[2])


def kernel_merge_rows(dev):
    """K2's row form on bf16 rows of a 256^3 brick grid: FULL slots (some
    padding) then FREE ids (some padding), W up to the 128 clamp, some voxels
    unobserved (W = 0, D = NaN). Stored values must agree bit for bit."""
    from tracking_sdf_tpu_torch.fusion.brick_merge import (
        brick_merge_rows, brick_merge_rows_reference)
    from tracking_sdf_tpu_torch.fusion.brickmajor import pack_color

    nb, bv, cap, cap_free = 32 ** 3, 512, 6144, 2048
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    W = rand(nb, bv, lo=-20.0, hi=140.0).clamp(0.0, 128.0).to(bf)
    D = torch.where(W > 0, rand(nb, bv, lo=-0.3, hi=0.3), float("nan")).to(bf)
    C = pack_color(*(rand(nb, bv).to(bf) for _ in range(3)),
                   rand(nb, bv, lo=0.0, hi=140.0).clamp(max=128.0).to(bf))
    ids = torch.randperm(nb, generator=gen, device=dev)[:cap + cap_free].to(torch.int32)
    ids[5500:cap] = nb  # padded FULL slots
    ids[cap + 1800:] = nb  # padded FREE slots
    rec = {}
    for channels in (2, 6):
        upd = rand(channels, cap, bv, lo=0.0, hi=2.0)
        upd[0][rand(cap, bv) < 0.2] = 0.0
        kw = dict(cap=cap, delta=0.3, max_weight=128.0)
        lk = [D.clone(), W.clone(), C.clone()]
        lr = [x.clone() for x in lk]
        brick_merge_rows(*lk, upd, ids, **kw)
        brick_merge_rows_reference(*lr, upd, ids, **kw)
        torch.cuda.synchronize()
        nan_ok = all(torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(lk[:2], lr[:2]))
        differ = sum(int((a[~torch.isnan(b)].view(torch.int16)
                          != b[~torch.isnan(b)].view(torch.int16)).sum())
                     for a, b in zip(lk[:2], lr[:2]))
        differ += int((lk[2] != lr[2]).sum())
        err = max(float(torch.nan_to_num(a.float() - b.float()).abs().max())
                  for a, b in zip(lk[:2], lr[:2]))
        at_clamp = int((lk[1] == 128.0).sum())
        touched = int((lk[2] != C).any(dim=1).sum())
        ms = events_ms(lambda: brick_merge_rows(*lk, upd, ids, **kw))
        device_ms = kernel_device_ms(lambda: brick_merge_rows(*lk, upd, ids, **kw),
                                     ("brick_merge_rows_kernel",))
        wrapper_ms = cuda_time_ms(lambda: brick_merge_rows(*lk, upd, ids, **kw))
        plain_ms = cuda_time_ms(lambda: brick_merge_rows_reference(*lr, upd, ids, **kw))
        # per voxel of a listed brick: FULL reads its update channels (4 B
        # each) and reads and writes bf16 D, W (8 B) and with color the four
        # color lanes (16 B); FREE reads and writes D, W (8 B)
        n_full, n_free = int((ids[:cap] < nb).sum()), int((ids[cap:] < nb).sum())
        bms, by = bound(bv * (n_full * (4 * channels + 8 + (16 if channels == 6 else 0))
                              + n_free * 8))
        print(f"K2 brick_merge_rows (bf16 rows) channels={channels} cap={cap} "
              f"cap_free={cap_free}: {differ} stored values differ (tol 0), NaN masks "
              f"equal {nan_ok}, max abs err {err:.3e}, {at_clamp} voxels at max_weight, "
              f"{touched} color rows updated; kernel {ms:.4f} ms ({TIMED_LAUNCHES} "
              f"back-to-back), device {device_ms} ms, wrapper {wrapper_ms:.4f} ms per "
              f"call, plain "
              f"{plain_ms:.4f} ms, bound {bms:.6f} ms ({by}; {n_full} FULL, {n_free} "
              f"FREE bricks)")
        check(differ == 0 and nan_ok, f"K2 row form disagrees with its plain version "
              f"(channels={channels}): {differ} values, NaN masks equal {nan_ok}")
        check(at_clamp > 0, "K2 row inputs reached no clamp")
        check((touched > 0) == (channels == 6), "color rows updated on the wrong path")
        rec[channels] = dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                             wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by)
    return rec[6]


def fuse_rows_compare(name, cam, scene, poses, rgb, dev, cfg=None):
    """K2's fused form on one preset's real lists: the second frame's FULL
    and FREE bricks against the rows fused from the first frame, at the
    preset's caps, geometry and color. ``cfg``: another configuration of the
    preset (packed's float32 rows and flat classification) in place of the
    preset's bf16 one; the unfused chain is timed for the preset's own only.
    Returns {color: record}."""
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.fusion.brick import _full_brick_updates, _pixel_table
    from tracking_sdf_tpu_torch.fusion.brick_fuse import (
        brick_fuse_rows, brick_fuse_rows_reference, group_centre_pixels)
    from tracking_sdf_tpu_torch.fusion.brick_merge import brick_merge_rows
    from tracking_sdf_tpu_torch.fusion.brickmajor import (
        classify_compact_rows, empty_brick_grid, fuse_frame_brickmajor, storage_dtype)
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    own = cfg is None
    cfg = path_config(name, None) if own else cfg
    f, p = cfg.fusion, cfg.grid
    bs, cap, cap_free = f.brick_shape, f.brick_cap, f.brick_cap_free
    frames = [preprocess_frame(render_scene_depth(scene, cam, poses[k]), cam=cam,
                               bilateral=cfg.bilateral_filter,
                               bilateral_mode=cfg.bilateral_mode) for k in (0, 1)]
    bg = empty_brick_grid(p, bs, device=dev, value_dtype=storage_dtype(f.storage_dtype),
                          weight_dtype=storage_dtype(f.weight_dtype))
    fuse_frame_brickmajor(bg, poses[0], *frames[0], rgb, params=p, cam=cam, cfg=f, bs=bs,
                          cap=cap, cap_free=cap_free)
    pts, nrm = frames[1]
    pose = poses[1]
    hw = tuple(pts.shape[:2])
    ids, counts = classify_compact_rows(p, pose, pts, nrm, cam=cam, cfg=f, bs=bs, cap=cap,
                                        cap_free=cap_free)
    NB, BV = bg.D.shape
    n_full, n_free = int((ids[:cap] < NB).sum()), int((ids[cap:] < NB).sum())
    full_rows = ids[:cap][ids[:cap] < NB]
    n_pix = int(torch.unique(group_centre_pixels(full_rows, pose, params=p, cam=cam, cfg=f,
                                                 bs=bs, hw=hw)).numel())
    rec = {}
    for color in (False, True):
        pix = _pixel_table(pts, nrm, rgb if color else None, color, f.distance)
        kw = dict(cap=cap, hw=hw, params=p, cam=cam, cfg=f, bs=bs)
        lk = [x.clone() for x in (bg.D, bg.W, bg.C)]
        lr = [x.clone() for x in lk]
        brick_fuse_rows(*lk, ids, pix, pose, **kw)
        brick_fuse_rows_reference(*lr, ids, pix, pose, **kw)
        torch.cuda.synchronize()
        nan_ok = all(torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(lk[:2], lr[:2]))
        differ = sum(int((a[~torch.isnan(b)].view(torch.int16)
                          != b[~torch.isnan(b)].view(torch.int16)).sum())
                     for a, b in zip(lk[:2], lr[:2]))
        differ += int((lk[2] != lr[2]).sum())
        err = max(float(torch.nan_to_num(a.float() - b.float()).abs().max())
                  for a, b in zip(lk[:2], lr[:2]))
        touched = int((lk[2] != bg.C).any(dim=1).sum())
        fused = int((lk[1] != bg.W).any(dim=1).sum())

        def kernel():
            brick_fuse_rows(*lk, ids, pix, pose, **kw)

        def chain():
            upd = torch.stack(_full_brick_updates(ids[:cap], pix, pose, p, cam, f, bs, hw,
                                                  color), dim=0)
            brick_merge_rows(*lr, upd.reshape(upd.shape[0], cap, -1), ids, cap=cap,
                             delta=p.delta, max_weight=f.max_weight)

        ms = events_ms(kernel)
        device_ms = kernel_device_ms(kernel, ("brick_fuse_rows_kernel",))
        wrapper_ms = cuda_time_ms(kernel)
        plain_ms = cuda_time_ms(lambda: brick_fuse_rows_reference(*lr, ids, pix, pose, **kw))
        chain_ms, chain_ops = all_device_ms(chain) if own else (None, None)
        chain_events_ms = cuda_time_ms(chain) if own else None
        # bytes: the D and W rows read and written (bf16: 4 B a voxel each
        # way, float32: 8 B), with color the C row read and written (bf16:
        # 16 B a voxel, float32: 32 B), the distinct group-centre pixel rows,
        # the lists and the pose
        row = BV * 2 * (bg.D.element_size() + bg.W.element_size())
        crow = bg.C.shape[1] * bg.C.element_size() * 2
        bms, by = bound(n_full * (row + (crow if color else 0)) + n_free * row
                        + n_pix * pix.shape[1] * 4 + ids.numel() * 4 + 48)
        form = "" if own else " " + str(bg.D.dtype).split(".")[-1]
        label = f"K2 brick_fuse_rows ({name}{form}, {'color' if color else 'geometry'})"
        chain_note = (f"; the unfused chain it replaces: device {chain_ms:.4f} ms in "
                      f"{chain_ops:.0f} device ops, {chain_events_ms:.4f} ms per call"
                      if own else "")
        print(f"{label} cap={cap} cap_free={cap_free}: {differ} stored values differ "
              f"(tol 0), NaN masks equal {nan_ok}, max abs err {err:.3e}, {fused} rows "
              f"fused, {touched} color rows updated; kernel {ms:.4f} ms "
              f"({TIMED_LAUNCHES} back-to-back), device {device_ms} ms, wrapper "
              f"{wrapper_ms:.4f} ms per call, plain {plain_ms:.4f} ms, bound {bms:.6f} ms "
              f"({by}; {n_full} FULL, {n_free} FREE bricks, {n_pix} centre pixels)"
              f"{chain_note}")
        check(differ == 0 and nan_ok, f"{label} disagrees with its plain version: "
              f"{differ} values, NaN masks equal {nan_ok}")
        check(fused > 1000 and (touched > 0) == color, f"{label}: {fused} rows fused, "
              f"{touched} color rows updated")
        rec[color] = dict(max_abs_err=err, ms=ms, device_ms=device_ms, wrapper_ms=wrapper_ms,
                          plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                          chain_device_ms=chain_ms, chain_device_ops=chain_ops,
                          chain_ms=chain_events_ms, n_full=n_full, n_free=n_free,
                          centre_pixels=n_pix)
        del lk, lr
    del bg
    torch.cuda.empty_cache()
    return rec


def small_parity(dev):
    """The port's loop on the card vs on the CPU (plain versions), 48^3: the
    flat bricked slice, and the tum256 preset's brick-major path with its caps
    at NB. Brick-major stores bf16: the update sums come from different float
    kernels on the two devices, so D may differ by a bf16 rounding (~1e-3).
    The scene is a sphere and a box: a lone sphere leaves rotations about its
    centre unobservable, so its tracked pose would be set by float rounding,
    which differs between hosts (the CPU's BLAS code path)."""
    from tracking_sdf_tpu_torch.config import GridParams
    from tracking_sdf_tpu_torch.core.camera import PinholeCamera
    from tracking_sdf_tpu_torch.data.synthetic import (
        CuboidScene, SphereScene, look_at, render_scene_depth)
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    params = GridParams(m=48, width=2.0, height=2.0, depth=2.0, origin=(-1.0, -1.0, -1.0),
                        delta=0.15, epsilon=0.02)
    cam = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
    scene = union(SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
                  CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)))
    eyes = [(0.0, -1.5, 0.2), (0.02, -1.5, 0.21), (0.04, -1.49, 0.22)]
    for name, fusion, tol_D in (("slice", dict(brick_cap=256), 1e-4),
                                ("tum256", dict(brick_cap=216, brick_cap_free=216), 2e-3)):
        cfg = path_config(name, None)
        cfg = dataclasses.replace(cfg, grid=params,
                                  fusion=cfg.fusion._replace(**fusion))
        runs = {}
        for d in ("cpu", dev):
            r = Reconstruction(cam, cfg, device=d,
                               initial_pose=look_at(eyes[0], (0, 0, 0), device=d))
            rgb = torch.full((72, 96, 3), 0.5, device=d)
            for i, e in enumerate(eyes):
                depth = render_scene_depth(scene, cam, look_at(e, (0, 0, 0), device="cpu"))
                r.process_frame(depth.to(d), rgb=rgb, timestamp=i)
            runs[d] = r
        a, b = runs["cpu"], runs[dev]
        ga, gb = a.grid, b.grid
        dt = (a.pose.t - b.pose.t.cpu()).abs().max().item()
        seen = ga.W > 0
        dD = (ga.D[seen] - gb.D.cpu()[seen]).abs().max().item()
        dW = ((ga.W - gb.W.cpu()).abs() / ga.W.clamp(min=1.0)).max().item()
        iters = ([s.gn_iterations for s in a.stats], [s.gn_iterations for s in b.stats])
        print(f"small parity {name} (48^3, card vs CPU): |dt| {dt:.3e} m, max |dD| "
              f"{dD:.3e} (tol {tol_D:g}), max |dW|/max(W, 1) {dW:.3e}, GN iterations "
              f"{iters[1]} (CPU {iters[0]})")
        check(dt < 1e-4 and dD < tol_D and dW < 2 ** -7 and iters[0] == iters[1]
              and torch.equal(seen, gb.W.cpu() > 0),
              f"the port on the card disagrees with the port on the CPU ({name})")


def k1_form(cfg):
    """(K1's counter, K1's kernel) on a brick-major configuration's tracked
    path: the central form with the central Jacobian, else gn_step's
    brick-major form."""
    if cfg.tracking.jacobian == "central":
        return "gn_step_central", "gn_central_step_kernel"
    return "gn_step_brick", "gn_step_kernel"


def run_path(name, cam, depths, poses, rgb, dev, traj_path, n_tracked=None):
    """Drive one main path through Reconstruction.process_frame over
    ``n_tracked`` tracked frames (default TRACKED[name]) with the launch
    counts set to 0 just before; returns its record."""
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    cfg = path_config(name, traj_path)
    n = (n_tracked or TRACKED[name]) + 1
    recon = Reconstruction(cam, cfg, initial_pose=poses[0], device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counters()
    wall, poses_out, fuse = [], [], []
    for k in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = recon.process_frame(depths[k], rgb=rgb, timestamp=float(k))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        fs = recon.last_fuse_stats
        poses_out.append((recon.pose.R.clone(), recon.pose.t.clone()))
        fuse.append(None if st.rejected else fs)
        print(f"{name} frame {k:2d}: {wall[-1]:8.2f} ms (preprocess {st.preprocess_ms:6.2f}, "
              f"track {st.track_ms:7.2f}, fuse {st.fuse_ms:7.2f}), GN {st.gn_iterations:2d}, "
              f"valid {st.num_valid}, n_full {fs.n_full}, n_free {fs.n_free}, overflow "
              f"{fs.overflow}, overflow_active {fs.overflow_active}, overflow_mixed "
              f"{fs.overflow_mixed}, rejected {st.rejected}")
    launches = counters()
    recon.close()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    tracked = recon.stats[1:]
    t_err = (recon.pose.t - poses[n - 1].t).norm().item()
    voxel = cfg.grid.width / cfg.grid.m
    med = {k: statistics.median(getattr(s, k) for s in tracked)
           for k in ("preprocess_ms", "track_ms", "fuse_ms")}
    rec = dict(ms_per_frame=statistics.median(wall[1:]), t_err_mm=t_err * 1e3,
               gn_iterations=sum(s.gn_iterations for s in tracked), launches=launches,
               tracked=len(tracked), fused=sum(not s.rejected for s in recon.stats),
               processed=n, peak_gib=peak_gb, overflow_drops=recon.overflow_drops, **med)
    # what the chunk phase is held against: per frame, and the final rows
    per_frame = dict(stats=recon.stats, poses=poses_out, fuse=fuse, traj_path=traj_path,
                     ms_per_frame=rec["ms_per_frame"])
    if recon.brick_grid is not None:
        per_frame["rows"] = [x.clone() for x in (recon.brick_grid.D, recon.brick_grid.W,
                                                 recon.brick_grid.C)]
    print(f"main path {name} ({cfg.grid.m}^3, {cam.width}x{cam.height}, {len(tracked)} "
          f"tracked frames): median {rec['ms_per_frame']:.2f} ms/frame wall, preprocess "
          f"{med['preprocess_ms']:.2f} ms, track {med['track_ms']:.2f} ms, fuse "
          f"{med['fuse_ms']:.2f} ms; GN iterations {rec['gn_iterations']}; final |t err| "
          f"{rec['t_err_mm']:.2f} mm; peak device memory of the path {peak_gb:.2f} GiB; "
          f"launches {launches}")
    kernels = (("gn_step", "brick_merge") if name == "slice"
               else (k1_form(cfg)[0], "brick_fuse_rows"))
    check(all(launches[k] > 0 for k in kernels), f"{name}: a kernel never ran: {launches}")
    if cfg.tracking.jacobian == "central":
        want = cfg.tracking.max_iterations * len(tracked)
        check(launches["gn_step_central"] == want and launches["gn_step_brick"] == 0
              and launches["gn_finish"] == 0,
              f"{name}: expected gn_step_central {want} ({cfg.tracking.max_iterations} a "
              f"tracked frame), gn_step_brick and gn_finish never: {launches}")
    check_preprocess(name, launches, n, filter_mode(cfg))
    check_classify(name, launches, cfg, rec["fused"])
    check(not any(s.rejected for s in recon.stats), f"{name}: a frame was rejected")
    if name != "slice":
        check(launches["brick_fuse_rows"] == rec["fused"]
              and launches["brick_merge_rows"] == 0,
              f"{name}: brick_fuse_rows must launch once per fused frame and "
              f"brick_merge_rows never: {launches}")
    # the reference node's tracker lands ~70 mm off on this scene (one level at
    # stride 3, no pyramid); central_phase holds it to its plain run on the CPU
    check(t_err < T_ERR_MAX or cfg.tracking.jacobian == "central",
          f"{name}: |t err| {t_err:.4f} m >= {T_ERR_MAX} m")
    if name in JAX_T_ERR_MM:
        ref = JAX_T_ERR_MM[name]
        print(f"  |t err| {rec['t_err_mm']:.2f} mm vs the JAX package's {ref} mm: "
              f"bound +-{0.5 * voxel * 1e3:.2f} mm (half a voxel)")
        check(abs(rec["t_err_mm"] - ref) <= 0.5 * voxel * 1e3,
              f"{name}: |t err| {rec['t_err_mm']:.2f} mm is not within half a voxel of "
              f"the JAX package's {ref} mm")
    if name != "slice":
        bg = recon.brick_grid
        from tracking_sdf_tpu_torch.fusion.brickmajor import unpack_color_grid

        R, G, B, Wc = unpack_color_grid(bg)
        mw = cfg.fusion.max_weight
        check(bg.D.dtype == torch.bfloat16 and bg.W.dtype == torch.bfloat16,
              f"{name}: leaves are not bf16")
        check(not bool(torch.isnan(bg.D[bg.W > 0]).any()), f"{name}: NaN where W > 0")
        check(float(bg.W.min()) >= 0.0 and float(bg.W.max()) <= mw
              and float(Wc.min()) >= 0.0 and float(Wc.max()) <= mw,
              f"{name}: weights outside [0, {mw}]")
        check(all(bool(torch.isfinite(x).all()) for x in (R, G, B)),
              f"{name}: non-finite color")
        print(f"  leaves: {int((bg.W > 0).sum())} observed voxels, no NaN where W > 0, "
              f"W max {float(bg.W.max())}, Wc max {float(Wc.max())}")
    else:
        g = recon.grid
        check(bool(torch.isfinite(g.D).all()) and bool(torch.isfinite(g.W).all()),
              "non-finite grid values")
        check(float(g.W.max()) <= cfg.fusion.max_weight and float(g.W.min()) >= 0.0,
              "weights outside [0, max_weight]")
    with open(traj_path) as f:
        n_lines = sum(1 for _ in f)
    check(n_lines == n, f"{name}: trajectory has {n_lines} lines, not {n}")
    del recon
    torch.cuda.empty_cache()
    return rec, per_frame


def free_cap_cost(cam, depths, poses, rgb, dev, ref):
    """A measurement, no check beyond the common bound: tum512 over the
    same frames with brick_cap_free = NB (no FREE brick dropped) beside the
    preset's run ``ref``, which drops FREE bricks on every frame of this
    scene: final |t err|, bricks dropped and ms a frame of both."""
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    cfg = path_config("tum512", None)
    nb = (cfg.grid.m // 8) ** 3
    cfg = dataclasses.replace(cfg, fusion=cfg.fusion._replace(brick_cap_free=nb))
    n = TRACKED["tum512"] + 1
    recon = Reconstruction(cam, cfg, initial_pose=poses[0], device=dev)
    wall = []
    for k in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recon.process_frame(depths[k], rgb=rgb, timestamp=float(k))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    t_err = (recon.pose.t - poses[n - 1].t).norm().item()
    print(f"tum512 with brick_cap_free {nb} (no FREE drop) beside the preset's "
          f"{path_config('tum512', None).fusion.brick_cap_free}, {n - 1} tracked frames: final "
          f"|t err| {t_err * 1e3:.3f} vs {ref['t_err_mm']:.3f} mm, bricks dropped "
          f"{recon.overflow_drops} vs {ref['overflow_drops']}, GN iterations "
          f"{sum(s.gn_iterations for s in recon.stats)} vs {ref['gn_iterations']}, median "
          f"{statistics.median(wall[1:]):.2f} vs {ref['ms_per_frame']:.2f} ms/frame")
    check(t_err < T_ERR_MAX and not any(s.rejected for s in recon.stats),
          f"tum512 with every FREE brick: |t err| {t_err:.4f} m")
    del recon
    torch.cuda.empty_cache()


def profiled_kernels(fn):
    """Run ``fn`` under torch.profiler: (its result, device ms, device ops,
    launches per kernel name of KERNEL_NAMES) over the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    seen = {k: sum(e.count for e in ev if k in e.key) for k in KERNEL_NAMES}
    return (out, sum(e.self_device_time_total for e in ev) / 1e3,
            sum(e.count for e in ev), seen)


def tum_decode_on_card(depth, dev):
    """The chunk's device decode of TUM uint16 depth against numpy's host
    decode of the per-frame path, bit for bit, on one rendered frame."""
    import numpy as np

    from tracking_sdf_tpu_torch.pipeline.chunk import decode_tum_depth

    d = depth.cpu().numpy()
    raw = np.where(np.isfinite(d), np.round(d * 5000.0), 0).astype(np.uint16)
    host = raw.astype(np.float32) / 5000.0
    host[raw == 0] = np.nan
    card = decode_tum_depth(torch.from_numpy(raw.view(np.int16)).to(dev),
                            torch.full((), 5000.0, device=dev)).cpu().numpy()
    differ = int((card.view(np.int32) != host.view(np.int32)).sum())
    print(f"TUM uint16 decode on the card vs the host decode: {differ} of {host.size} "
          f"values differ (tol 0)")
    check(differ == 0, "the card's uint16 depth decode differs from the host's")


def run_chunk_path(name, cam, depths, poses, rgb, dev, traj_path, ref, chunks=None):
    """Drive one preset through Reconstruction.process_chunk over the
    per-frame run's frames (frame 0 by process_frame, then the chunks of
    ``chunks``, default CHUNKS[name]), with the launch counts set to 0 just before and read just
    after, and hold it to the per-frame run ``ref``. Chunk roles: a
    "calibrated" chunk measures the phase calibration, the "timed" one runs
    without it (its track_ms is then the wall time of its replays and its
    one read, over its frames) and the "profiled" one runs under
    torch.profiler (its kernels counted there); the graphs of both are
    captured by then. A failed calibration is an error here."""
    import warnings

    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    cfg = path_config(name, traj_path)
    chunks = chunks or CHUNKS[name]
    sizes = [size for size, _ in chunks]
    n = len(ref["stats"])
    check(sum(sizes) == n - 1, f"{name}: chunks {sizes} do not cover {n - 1} frames")
    per_step = ((len(cfg.pyramid_levels or (1,)) - 1) * COARSE_ITERATIONS
                + cfg.tracking.max_iterations)
    k1_counter, k1_kernel = k1_form(cfg)
    recon = Reconstruction(cam, cfg, initial_pose=poses[0], device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counters()
    recon.process_frame(depths[0], rgb=rgb, timestamp=0.0)
    k, stats, fuse, prof, timed = 1, [], [], None, None
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="chunk phase calibration failed",
                                category=RuntimeWarning)
        for ci, (size, role) in enumerate(chunks):
            recon.chunk_phase_metrics = role == "calibrated"
            args = (torch.stack(depths[k:k + size]), rgb[None].expand(size, -1, -1, -1))
            kw = dict(timestamps=[float(j) for j in range(k, k + size)])
            t0 = time.perf_counter()
            if role == "profiled":
                st, dev_ms, dev_ops, seen = profiled_kernels(
                    lambda: recon.process_chunk(*args, **kw))
                prof = dict(frames=size, device_ms=dev_ms / size, device_ops=dev_ops / size,
                            kernels=seen)
            else:
                st = recon.process_chunk(*args, **kw)
            call_ms = (time.perf_counter() - t0) * 1e3
            if role == "timed":
                timed = dict(frames=size, ms_per_frame=st[0].track_ms)
            stats += st
            fuse += recon.chunk_fuse_stats
            same_pose = (torch.equal(recon.pose.R, ref["poses"][k + size - 1][0])
                         and torch.equal(recon.pose.t, ref["poses"][k + size - 1][1]))
            print(f"{name} chunk {ci} (frames {k}-{k + size - 1}, colors "
                  f"{[(recon.frame_num - size + 1 + j) % cfg.fusion.color_every == 0 for j in range(size)]}, "
                  f"phase metrics {recon.chunk_phase_metrics}): process_chunk {call_ms:.2f} ms; "
                  f"GN {[s.gn_iterations for s in st]}, rejected {[s.rejected for s in st]}, "
                  f"track/fuse/preprocess ms {[(round(s.track_ms, 3), round(s.fuse_ms, 3), round(s.preprocess_ms, 3)) for s in st]}; "
                  f"pose bitwise equal to the per-frame run's {same_pose}")
            ref_fuse_ok = not any(f is not None and f.overflow for f in ref["fuse"][:k + size])
            check(same_pose or not ref_fuse_ok,
                  f"{name}: pose after chunk {ci} differs from the per-frame run")
            k += size
    launches = counters()
    recon.close()
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    steps = recon._chunk_steps
    capture = {f"color={key[3]}": round(ms, 1) for key, ms in steps.capture_ms.items()}

    # parity with the per-frame run
    full_drop = any(f is not None and f.overflow for f in ref["fuse"])
    ref_stats = ref["stats"][1:]
    check([(s.gn_iterations, s.rejected) for s in stats]
          == [(s.gn_iterations, s.rejected) for s in ref_stats],
          f"{name}: GN iterations or rejection flags differ from the per-frame run")
    check([(s.num_valid, s.mean_abs_residual) for s in stats]
          == [(s.num_valid, s.mean_abs_residual) for s in ref_stats] or full_drop,
          f"{name}: valid counts or mean residuals differ from the per-frame run")
    check(fuse == ref["fuse"][1:] or full_drop,
          f"{name}: FuseStats differ from the per-frame run: {fuse} vs {ref['fuse'][1:]}")
    bg = recon.brick_grid
    rows_differ = sum(int((a.view(torch.int16) != b.view(torch.int16)).sum())
                      for a, b in zip((bg.D, bg.W, bg.C), ref["rows"]))
    check(rows_differ == 0 or full_drop, f"{name}: {rows_differ} row values differ from "
          "the per-frame run, which dropped no FULL brick")
    with open(traj_path) as f, open(ref["traj_path"]) as g:
        same_traj = f.read() == g.read()
    check(same_traj or full_drop, f"{name}: the trajectory differs from the per-frame run")
    # launches: counted per replay, and by the profiler over one chunk
    tracked = n - 1
    fused = 1 + sum(not s.rejected for s in stats)
    k1_other = sum(launches[k] for k in ("gn_step_brick", "gn_step_central", "gn_finish")
                   if k != k1_counter)
    check(launches[k1_counter] == per_step * tracked and k1_other == 0
          and launches["brick_fuse_rows"] == fused and launches["brick_merge_rows"] == 0,
          f"{name} chunked: expected {k1_counter} {per_step} per tracked frame and no other "
          f"K1 step, brick_fuse_rows once per fused frame and brick_merge_rows never: "
          f"{launches}")
    check_preprocess(f"{name} chunked", launches, n, filter_mode(cfg))
    check_classify(f"{name} chunked", launches, cfg, fused)
    seen = prof["kernels"]
    k5, k6, k7 = CLASSIFY_PER_FRAME[classify_form(cfg)]
    check(seen[k1_kernel] == per_step * prof["frames"]
          and seen["gn_step_kernel"] + seen["gn_central_step_kernel"] - seen[k1_kernel] == 0
          and seen["brick_fuse_rows_kernel"] == prof["frames"]
          and seen["brick_merge_rows_kernel"] == 0
          and seen["normals_kernel"] == prof["frames"]
          and seen["bilateral_pass_kernel"] == prof["frames"]
          and seen["frame_tables_kernel"] == k5 * prof["frames"]
          and seen["classify_bricks_kernel"] == k6 * prof["frames"]
          and seen["compact_lists_kernel"] + seen["compact_lists_hier_kernel"]
          == k7 * prof["frames"],
          f"{name}: the profiler counted {seen} over a chunk of {prof['frames']} frames")
    t_err = (recon.pose.t - poses[n - 1].t).norm().item()
    check(t_err < T_ERR_MAX or cfg.tracking.jacobian == "central",
          f"{name} chunked: |t err| {t_err:.4f} m >= {T_ERR_MAX} m")
    busy = prof["device_ms"] / timed["ms_per_frame"]
    rec = dict(ms_per_frame=timed["ms_per_frame"], timed_frames=timed["frames"],
               per_frame_ms=ref["ms_per_frame"], device_ms=prof["device_ms"],
               device_ops=prof["device_ops"], busy=busy, profiled_frames=prof["frames"],
               profiler_kernels=seen, capture_ms=capture,
               calibration_ms=[round(x, 1) for x in steps.calibration_ms],
               peak_gib=peak_gib, launches=launches, tracked=tracked, fused=fused,
               processed=n, t_err_mm=t_err * 1e3, rows_differ=rows_differ,
               full_drop=full_drop)
    print(f"main path {name} chunked (chunks {sizes}): {rec['ms_per_frame']:.3f} ms/frame "
          f"wall over a chunk of {timed['frames']} (replays and the one read) against "
          f"{ref['ms_per_frame']:.2f} ms/frame per frame; under replay device "
          f"{prof['device_ms']:.3f} ms/frame in {prof['device_ops']:.0f} ops, busy "
          f"{busy:.1%}; no host sync between replays (set_sync_debug_mode('error')); "
          f"capture ms per variant {capture}; calibration ms {rec['calibration_ms']}; peak "
          f"device memory of the path {peak_gib:.2f} GiB; profiler kernels over {prof['frames']} "
          f"frames {seen}; launches {launches}; final |t err| {t_err * 1e3:.2f} mm; rows "
          f"differing from the per-frame run {rows_differ} (FULL drops in it: {full_drop}); "
          f"trajectory equal {same_traj}")
    del recon, steps, bg
    torch.cuda.empty_cache()
    return rec


# --- phase 7: the dataset path ------------------------------------------------

def zlib_header_present() -> bool:
    """One probe: does the C++ compiler find zlib.h?"""
    try:
        return subprocess.run(["g++", "-E", "-x", "c++", "-"], input="#include <zlib.h>\n",
                              capture_output=True, text=True).returncode == 0
    except OSError:
        return False


def native_loader_check(root, n=4):
    """Build the native loader (forced: a library from another machine may
    sit beside the source) and hold its one-shot decoders and its raw stream
    bitwise against the plain decoder on the first ``n`` frames."""
    import numpy as np

    from tracking_sdf_tpu_torch.data import native, tum

    t0 = time.perf_counter()
    native.load_library(force_build=True)
    print(f"native loader: built from native/loader.cpp in {time.perf_counter() - t0:.1f} s")
    ds = tum.TUMDataset(root)
    raw = list(ds.stream(raw=True, indices=range(n)))
    check(len(raw) == n, f"native loader: the raw stream gave {len(raw)} of {n} frames")
    differ = 0
    for i, fr in enumerate(raw):
        dpath, cpath = ds.frame_paths(i)
        d16, c8 = tum.decode_depth_png(dpath), tum.decode_rgb_png(cpath)
        want_d = d16.astype(np.float32) / 5000.0
        want_d[d16 == 0] = np.nan
        want_c = c8.astype(np.float32) / 255.0
        differ += int((native.decode_depth(dpath).view(np.int32) != want_d.view(np.int32)).sum())
        differ += int((native.decode_rgb(cpath) != want_c).sum())
        differ += int((fr.depth != d16).sum()) + int((fr.rgb != c8).sum())
        check(fr.depth.dtype == np.uint16 and fr.rgb.dtype == np.uint8,
              "native loader: the raw stream is not uint16 / uint8")
    print(f"native loader vs the plain decoder on {n} frames (decode_depth, decode_rgb, "
          f"raw stream): {differ} values differ (tol 0)")
    check(differ == 0, "the native loader disagrees with the plain decoder")


def loader_ms_per_frame(root, native_ok):
    """The loader alone over the sequence: ms a frame with nothing consuming."""
    from tracking_sdf_tpu_torch.data.tum import TUMDataset

    ds = TUMDataset(root)
    t0 = time.perf_counter()
    n = sum(1 for _ in (ds.stream(raw=True) if native_ok else ds))
    ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"loader alone ({'native raw stream' if native_ok else 'plain decoder'}): "
          f"{ms:.3f} ms/frame over {n} frames")
    return ms


def staging_ms_per_chunk(root, dev):
    """Host-side staging of one chunk of DATASET_CHUNK raw frames, as run()
    and process_chunk do it: stacking the frames, pinning the stacks, and
    the copies of the frames to the card (ms per chunk, medians of 5)."""
    from tracking_sdf_tpu_torch.core.camera import tum_fr1_camera
    from tracking_sdf_tpu_torch.data.tum import TUMDataset
    from tracking_sdf_tpu_torch.pipeline import runner

    frames = list(TUMDataset(root).stream(raw=True, indices=range(DATASET_CHUNK)))
    recon = runner.Reconstruction(tum_fr1_camera(), path_config("tum256", None), device=dev)
    on_card = (torch.empty((480, 640), dtype=torch.int16, device=dev),
               torch.empty((480, 640, 3), dtype=torch.uint8, device=dev))
    stack, pin, copy = [], [], []
    for _ in range(5):
        t0 = time.perf_counter()
        d, c = runner._stack([f.depth for f in frames]), runner._stack([f.rgb for f in frames])
        t1 = time.perf_counter()
        d, c = recon._stage(d, rgb=False), recon._stage(c, rgb=True)
        t2 = time.perf_counter()
        for k in range(DATASET_CHUNK):
            on_card[0].copy_(d[k], non_blocking=True)
            on_card[1].copy_(c[k], non_blocking=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        stack.append((t1 - t0) * 1e3)
        pin.append((t2 - t1) * 1e3)
        copy.append((t3 - t2) * 1e3)
    rec = {k: statistics.median(v) for k, v in (("stack", stack), ("pin", pin), ("copy", copy))}
    print(f"staging a chunk of {DATASET_CHUNK} raw frames (uint16 depth, uint8 color, "
          f"{(d.numel() * 2 + c.numel()) / 2 ** 20:.1f} MiB): stack {rec['stack']:.3f} ms, pin "
          f"{rec['pin']:.3f} ms, copies to the card {rec['copy']:.3f} ms per chunk")
    return rec


def final_t_err_mm(trajectory, groundtruth):
    """|t| distance (mm) of the last trajectory line from the groundtruth
    line of the same stamp (no alignment)."""
    import numpy as np

    est, gt = np.loadtxt(trajectory, ndmin=2), np.loadtxt(groundtruth, ndmin=2)
    k = int(np.argmin(np.abs(gt[:, 0] - est[-1, 0])))
    return float(np.linalg.norm(est[-1, 1:4] - gt[k, 1:4]) * 1e3)


def steady_ms_per_frame(emit_times, chunk):
    """Median host-clock ms a frame between the ends of consecutive chunks
    (``chunk`` frames each, after frame 0), or between frames when
    ``chunk`` is 0. run() stamps every frame's stats as it emits them; a
    chunk's frames are emitted together when it ends."""
    step = max(chunk, 1)
    ends = emit_times[step::step] if chunk else emit_times
    gaps = [(b - a) * 1e3 / step for a, b in zip(ends, ends[1:])]
    return statistics.median(gaps) if gaps else float("nan")


def cli_run(label, argv, work, chunk=0):
    """One call of the port's CLI: (summary, its Reconstruction, launches,
    rejected frames). The launch counts are set to 0 just before the call
    and read just after. ``chunk``: the --chunk it was given, for the
    steady ms a frame added to the summary."""
    import contextlib
    import io
    import warnings

    from tracking_sdf_tpu_torch import cli
    from tracking_sdf_tpu_torch.pipeline import runner

    made = []
    base = runner.Reconstruction

    class Recording(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
            self.publisher = None

        def start_mesh_publisher(self, *a, **k):
            self.publisher = super().start_mesh_publisher(*a, **k)
            return self.publisher

    log = os.path.join(work, f"{label}.jsonl")
    if os.path.exists(log):
        os.remove(log)
    out = io.StringIO()
    runner.Reconstruction = Recording
    try:
        with warnings.catch_warnings():
            # tum512 reports its FREE-cap drops per chunk; they are counted below
            warnings.filterwarnings("ignore", message="process_chunk: .* overflow drops",
                                    category=RuntimeWarning)
            reset_counters()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv + ["--json", "--eval", "--metrics-log", log])
            torch.cuda.synchronize()
            launches = counters()
    finally:
        runner.Reconstruction = base
    check(rc == 0, f"{label}: the CLI exited with {rc}")
    recon = made[-1]
    check_preprocess(f"cli {label}", launches, len(recon.stats), filter_mode(recon.config))
    check_classify(f"cli {label}", launches, recon.config)
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    summary["processed"] = len(recon.stats)
    with open(log) as f:
        rows = [json.loads(x) for x in f]
    rejected = sum(r["rejected"] for r in rows)
    summary["steady_ms"] = steady_ms_per_frame(made[-1].emit_times, chunk)
    fps = summary["run_frames"] / summary["run_s"]
    ate = summary.get("ate_rmse_m")
    print(f"cli {label}: frames {summary['frames']:.0f}, ate_pairs "
          f"{summary.get('ate_pairs', 0):.0f}, rejected {rejected}, ATE "
          f"{'n/a' if ate is None else format(ate * 1e3, '.4f')} mm, RPE "
          f"{summary.get('rpe_trans_m', 0) * 1e3:.4f} mm / "
          f"{summary.get('rpe_rot_rad', 0):.6f} rad, dropped bricks "
          f"{summary['overflow_drops']:.0f}; end to end {fps:.1f} frames/s over "
          f"{summary['run_s']:.2f} s (first uses included), steady "
          f"{summary['steady_ms']:.3f} ms/frame; launches {launches}")
    return summary, made[-1], launches, rejected


def dataset_phase(dev, work, chunk_ms):
    """Phase 7, in the directory ``work``. ``chunk_ms``: this run's phase-6
    ms/frame per preset, printed beside the CLI's. Returns the two chunked
    runs' records for the kernels' line and phase 8."""
    from tracking_sdf_tpu_torch.config import preset
    from tracking_sdf_tpu_torch.data.make_sequence import generate

    root = os.path.join(work, "seq")
    t0 = time.perf_counter()
    stats = generate(root, n_frames=DATASET_FRAMES, device=dev)
    print(f"dataset: {DATASET_FRAMES} tabletop frames at 640x480 generated on the card "
          f"in {time.perf_counter() - t0:.1f} s, min_valid_frac "
          f"{stats['min_valid_frac']:.4f}")
    check(stats["min_valid_frac"] > 0.9, "dataset: frames with little valid depth")
    native_ok = zlib_header_present()
    if native_ok:
        native_loader_check(root)
    else:
        print("native loader: zlib.h absent on this machine")
    loader_ms = loader_ms_per_frame(root, native_ok)
    if native_ok:
        staging_ms_per_chunk(root, dev)
    loader = ["--native-loader"] if native_ok else []
    gt_file = os.path.join(root, "groundtruth.txt")

    def argv(name, traj, *extra):
        return ["--preset", name, "--dataset", root, "--trajectory",
                os.path.join(work, traj)] + list(extra)

    chunked = loader + ["--chunk", str(DATASET_CHUNK)]
    records, rows256 = {}, None
    for name in ("tum256", "tum512"):
        cfg = preset(name)
        s, recon, launches, rejected = cli_run(
            f"{name} chunked", argv(name, f"{name}.txt", *chunked), work, DATASET_CHUNK)
        per_step = ((len(cfg.pyramid_levels) - 1) * COARSE_ITERATIONS
                    + cfg.tracking.max_iterations)
        voxel_mm = cfg.grid.width / cfg.grid.m * 1e3
        ate_mm = s["ate_rmse_m"] * 1e3
        t_err = final_t_err_mm(os.path.join(work, f"{name}.txt"), gt_file)
        tracked, fused = DATASET_FRAMES - 1, DATASET_FRAMES - rejected
        print(f"  {name}: ATE {ate_mm:.4f} mm vs the JAX package's {JAX_ATE_MM[name]} mm "
              f"(bound +-{0.5 * voxel_mm:.2f} mm, half a voxel), final |t err| "
              f"{t_err:.2f} mm; steady {s['steady_ms']:.3f} ms/frame from disk "
              f"(loader alone {loader_ms:.3f}) against {chunk_ms[name]:.3f} ms/frame of "
              f"phase 6's timed chunk on frames already on the card")
        check(s["frames"] == DATASET_FRAMES and s["ate_pairs"] == DATASET_FRAMES
              and rejected == 0, f"{name} dataset: frames {s['frames']}, ate_pairs "
              f"{s['ate_pairs']}, rejected {rejected}")
        check(s["ate_rmse_m"] < T_ERR_MAX, f"{name} dataset: ATE {ate_mm:.2f} mm")
        check(abs(ate_mm - JAX_ATE_MM[name]) <= 0.5 * voxel_mm,
              f"{name} dataset: ATE {ate_mm:.2f} mm is not within half a voxel of the "
              f"JAX package's {JAX_ATE_MM[name]} mm")
        check(launches["gn_step_brick"] == per_step * tracked
              and launches["brick_fuse_rows"] == fused
              and launches["brick_merge_rows"] == 0,
              f"{name} dataset: expected gn_step_brick {per_step} per tracked frame, "
              f"brick_fuse_rows once per fused frame, brick_merge_rows never: {launches}")
        records[f"{name}_dataset"] = dict(
            launches=launches, tracked=tracked, fused=fused, processed=s["processed"],
            ate_mm=ate_mm,
            ate_rmse_m=s["ate_rmse_m"], run_s=s["run_s"],
            t_err_mm=t_err, fps=s["run_frames"] / s["run_s"],
            steady_ms=s["steady_ms"],
            overflow_drops=s["overflow_drops"])
        if name == "tum256":
            bg = recon.brick_grid
            rows256 = [x.clone() for x in (bg.D, bg.W, bg.C)]
        del recon
        torch.cuda.empty_cache()

    # tum256 per frame, and paced at the sensor's 30 Hz
    s, recon, _, rejected = cli_run("tum256 per frame", argv("tum256", "pf.txt", *loader),
                                    work)
    print(f"  tum256 per frame: ATE {s['ate_rmse_m'] * 1e3:.4f} mm beside the chunked "
          f"{records['tum256_dataset']['ate_mm']:.4f} mm")
    check(s["frames"] == DATASET_FRAMES and rejected == 0 and s["ate_rmse_m"] < T_ERR_MAX,
          f"tum256 per frame over the dataset: {s}")
    del recon
    s, recon, _, _ = cli_run("tum256 --realtime 30",
                             argv("tum256", "rt.txt", "--realtime", "30"), work)
    print(f"  tum256 --realtime 30: realtime_yielded {s['realtime_yielded']:.0f}, "
          f"realtime_dropped {s['realtime_dropped']:.0f}")
    check(s["realtime_yielded"] + s["realtime_dropped"] == DATASET_FRAMES,
          f"realtime: yielded + dropped != {DATASET_FRAMES}: {s}")
    del recon

    # stop at frame 60 with a checkpoint, resume, compare with the whole run
    ck = ["--checkpoint", os.path.join(work, "ck"), "--checkpoint-every", "60"]
    t0 = time.perf_counter()
    s, recon, _, _ = cli_run("tum256 to frame 60",
                             argv("tum256", "ck.txt", *chunked, *ck, "--frames", "60"), work,
                             DATASET_CHUNK)
    check(s["frames"] == 60, f"checkpoint: the first part ran {s['frames']} frames")
    del recon
    s, recon, _, _ = cli_run("tum256 resumed", argv("tum256", "ck.txt", *chunked, *ck), work,
                             DATASET_CHUNK)
    bg = recon.brick_grid
    rows_differ = sum(int((a.view(torch.int16) != b.view(torch.int16)).sum())
                      for a, b in zip((bg.D, bg.W, bg.C), rows256))
    with open(os.path.join(work, "ck.txt")) as f, open(os.path.join(work, "tum256.txt")) as g:
        same_traj = f.read() == g.read()
    size = os.path.getsize(os.path.join(work, "ck", "state.npz")) / 2 ** 20
    print(f"  tum256 checkpoint at frame 60 ({size:.0f} MiB) and resume: {s['frames']:.0f} "
          f"frames after it, rows differing from the uninterrupted run {rows_differ}, "
          f"trajectory equal {same_traj}; both parts {time.perf_counter() - t0:.1f} s")
    check(s["frames"] == 60 and s["ate_pairs"] == DATASET_FRAMES and rows_differ == 0
          and same_traj, "checkpoint: the resumed run differs from the uninterrupted one")
    del recon, bg, rows256
    torch.cuda.empty_cache()

    # what tum512's FREE-cap drops cost: every brick (no drop) beside the preset's cap
    nb = (preset("tum512").grid.m // 8) ** 3
    s, recon, _, rejected = cli_run(
        "tum512 --brick-cap-free NB",
        argv("tum512", "free.txt", *chunked, "--brick-cap-free", str(nb)), work,
        DATASET_CHUNK)
    ref = records["tum512_dataset"]
    t_err = final_t_err_mm(os.path.join(work, "free.txt"), gt_file)
    print(f"  tum512 FREE cap {nb} (no FREE drop) vs the preset's "
          f"{preset('tum512').fusion.brick_cap_free}: ATE {s['ate_rmse_m'] * 1e3:.4f} vs "
          f"{ref['ate_mm']:.4f} mm, final |t err| {t_err:.2f} vs {ref['t_err_mm']:.2f} mm, "
          f"dropped bricks {s['overflow_drops']:.0f} vs {ref['overflow_drops']:.0f}, "
          f"steady {s['steady_ms']:.3f} vs {ref['steady_ms']:.3f} ms/frame")
    check(s["frames"] == DATASET_FRAMES and rejected == 0 and s["ate_rmse_m"] < T_ERR_MAX,
          f"tum512 with every FREE brick: {s}")
    del recon
    torch.cuda.empty_cache()
    return records



# --- phase 8: rendering and meshing -------------------------------------------

RENDER_HIT_AGREE = 0.999  # card vs CPU: hit masks equal on this share of pixels
RENDER_VALUE_SHARE = 0.995  # ... and on common hits this share within the tolerances
RENDER_TOL = {"depth": 1e-4, "range_t": 1e-4, "normal_world": 1e-4, "rgb": 1e-5}
RENDER_TOL_ALL = {"depth": 2e-3, "range_t": 2e-3, "normal_world": 1e-2, "rgb": 1e-2}
MESH_TOL_VERT = 1e-6  # card vs CPU, m (a triangle may come back reversed, see below)
MESH_TOL_COLOR = 1.0 / 255.0 + 1e-6
GRAD_RTOL = 1e-3
# the analytic comparison of tests/test_render.py
ANALYTIC_HIT_AGREE, ANALYTIC_MEDIAN_M, ANALYTIC_P95_M = 0.97, 0.005, 0.02
RENDER_REPS = 5


def render_parity(label, a, b):
    """Hold render ``b`` (card) to ``a`` (CPU); returns the largest errors."""
    ha, hb = a.hit, b.hit.cpu()
    agree = (ha == hb).float().mean().item()
    both = ha & hb
    errs = {}
    for name, tol in RENDER_TOL.items():
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            continue
        e = (x - y.cpu()).abs()[both]
        e = e.reshape(e.shape[0], -1).amax(-1)
        share = (e <= tol).float().mean().item()
        errs[name] = e.max().item()
        check(share >= RENDER_VALUE_SHARE and errs[name] <= RENDER_TOL_ALL[name],
              f"{label}: {name} within {tol} on {share:.4f} of common hits, max {errs[name]}")
    steps = (a.steps == b.steps.cpu()).float().mean().item()
    print(f"  {label}: hit agreement {agree:.5f} over {ha.numel()} pixels ({int(both.sum())} "
          f"common hits), max errors {errs}, steps equal on {steps:.4f}, dropped "
          f"{int(b.dropped)} (CPU {int(a.dropped)})")
    check(agree >= RENDER_HIT_AGREE and steps >= 0.99 and int(a.dropped) == int(b.dropped),
          f"{label}: the card's render disagrees with the CPU's")
    return errs


def mesh_parity(label, a, b):
    """Hold mesh ``b`` (card) to ``a`` (CPU): equal counts, vertices within
    MESH_TOL_VERT in order or, for a triangle whose winding test sat on zero,
    reversed (at most 0.1% of them), colors within one uint8 step."""
    import numpy as np

    check(a.num_triangles == b.num_triangles > 0 and a.dropped_cells == b.dropped_cells,
          f"{label}: {b.num_triangles} triangles ({b.dropped_cells} dropped cells) on the "
          f"card, {a.num_triangles} ({a.dropped_cells}) on the CPU")
    same = np.abs(a.vertices - b.vertices).reshape(-1, 9).max(-1)
    rev = np.abs(a.vertices - b.vertices[:, ::-1]).reshape(-1, 9).max(-1)
    reversed_ = (same > MESH_TOL_VERT) & (rev <= MESH_TOL_VERT)
    err = np.minimum(same, rev).max()
    cerr = 0.0 if a.colors is None else float(np.abs(a.colors - b.colors).max())
    print(f"  {label}: {b.num_triangles} triangles, dropped cells {b.dropped_cells}, max vertex "
          f"err {err:.3e} (tol {MESH_TOL_VERT:g}), {int(reversed_.sum())} reversed, max color "
          f"err {cerr:.4f} (tol 1/255)")
    check(err <= MESH_TOL_VERT and reversed_.mean() <= 1e-3 and cerr <= MESH_TOL_COLOR,
          f"{label}: the card's mesh disagrees with the CPU's")


def render_mesh_parity(dev):
    """Phase 8, part 1: raycast and marching_cubes on the card against the
    CPU on a 64^3 grid_from_scene sphere + box grid, and the pose gradient."""
    from tracking_sdf_tpu_torch.config import GridParams, RaycastConfig
    from tracking_sdf_tpu_torch.core.camera import PinholeCamera
    from tracking_sdf_tpu_torch.core.lie import Pose
    from tracking_sdf_tpu_torch.data.synthetic import (
        CuboidScene, SphereScene, grid_from_scene, look_at)
    from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid
    from tracking_sdf_tpu_torch.render.marching_cubes import marching_cubes
    from tracking_sdf_tpu_torch.render.raycast import raycast

    params = GridParams(m=64, width=2.0, height=2.0, depth=2.0, origin=(-1.0, -1.0, -1.0),
                        delta=0.1, epsilon=0.01)
    cam = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
    scene = union(SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
                  CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)))
    cpu = grid_from_scene(params, scene, device="cpu")
    card = TSDFGrid(*(getattr(cpu, k).to(dev) for k in FIELDS))
    pose = look_at((0.0, -1.6, 0.2), (0.0, 0.0, 0.0), device="cpu")
    cfg = RaycastConfig(t_near=0.05, t_far=4.0)
    print(f"phase 8: rendering and meshing on {gpu_line()}")
    for label, kw in (("raycast cold", {}), ("raycast stride 2", dict(stride=2))):
        a = raycast(cpu, pose, params=params, cam=cam, cfg=cfg, with_color=True, **kw)
        b = raycast(card, pose.to(dev), params=params, cam=cam, cfg=cfg, with_color=True, **kw)
        render_parity(f"{label} (64^3, card vs CPU)", a, b)
        if label == "raycast cold":
            a = raycast(cpu, pose, params=params, cam=cam, cfg=cfg, with_color=True,
                        t_init=a.range_t)
            b = raycast(card, pose.to(dev), params=params, cam=cam, cfg=cfg, with_color=True,
                        t_init=b.range_t)
            render_parity("raycast warm (64^3, card vs CPU)", a, b)
    for label, kw in (("marching_cubes trilinear", dict(with_colors=True)),
                      ("marching_cubes shepard, vertex_quant",
                       dict(with_colors=True, color_mode="shepard", vertex_quant=True))):
        mesh_parity(f"{label} (64^3, card vs CPU)", marching_cubes(cpu, params=params, **kw),
                    marching_cubes(card, params=params, **kw))
    grads = []
    for grid, d in ((cpu, "cpu"), (card, dev)):
        ty = torch.zeros((), device=d, requires_grad=True)
        p = pose.to(d)
        r = raycast(grid, Pose(p.R, p.t + ty * torch.tensor([0.0, 1.0, 0.0], device=d)),
                    params=params, cam=cam, stride=4)
        (torch.where(r.hit, r.depth, 0.0).sum() / r.hit.sum()).backward()
        grads.append(ty.grad.item())
    rel = abs(grads[1] - grads[0]) / abs(grads[0])
    print(f"  d(mean hit depth)/d(t_y), stride 4: card {grads[1]:.6f}, CPU {grads[0]:.6f}, "
          f"rel err {rel:.2e} (tol {GRAD_RTOL:g})")
    check(rel <= GRAD_RTOL and -1.7 < grads[1] < -0.6, "the pose gradient on the card")


def memory_mark() -> int:
    """Bytes allocated on the card now, with the peak counter reset to it;
    collected first (a Reconstruction whose captured graphs close a cycle
    is freed only by the collector, at a moment of its own)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_gib_above(mark: int) -> float:
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - mark) / 2 ** 30


def mesh_stages(grid, params, with_colors, n_chunks, path):
    """marching_cubes in its stages over ``n_chunks`` i-slabs (1: one shot),
    each stage timed on the host clock after a device sync: active cells
    (mask, count and indices), triangulation, compaction, colors, the host
    copy (uint16 quantization on the card, the copies, dequantization) and
    the PLY write. Returns (ms per stage, the mesh)."""
    import numpy as np

    from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid
    mc = importlib.import_module("tracking_sdf_tpu_torch.render.marching_cubes")

    ms = dict(active=0.0, triangulate=0.0, compact=0.0, colors=0.0, host=0.0, ply=0.0)

    def lap(key, t0):
        torch.cuda.synchronize()
        ms[key] += (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    m = params.m
    step = -(-m // n_chunks)
    verts, cols = [], []
    for i0 in range(0, m, step):
        sub = TSDFGrid(*(getattr(grid, k)[i0:min(i0 + step + 1, m)] for k in FIELDS))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        active = mc._active_cells(sub)
        n_act = int(active.sum())
        cells = mc._active_cell_indices(active, n_act)
        del active
        t0 = lap("active", t0)
        v, valid = mc._triangulate_cells(sub, cells, params=params, i_offset=i0)
        t0 = lap("triangulate", t0)
        tri = mc._compact_triangles(v, valid)
        del v, valid
        t0 = lap("compact", t0)
        if with_colors:
            rgb8 = mc._vertex_colors(sub, tri, params=params, color_mode="trilinear",
                                     i_offset=i0)
            t0 = lap("colors", t0)
            cols.append(rgb8.cpu().numpy().astype(np.float32) / 255.0)
        verts.append(mc._dequantize(mc._quantize_tris(tri, params).cpu().numpy(), params))
        lap("host", t0)
    mesh = mc.Mesh(np.concatenate(verts), np.concatenate(cols) if with_colors else None)
    t0 = time.perf_counter()
    mc.export_ply(mesh, path)
    ms["ply"] = (time.perf_counter() - t0) * 1e3
    return ms, mesh


def render_mesh_full(name, rows, pose, true_pose, cam, scene, dev, work):
    """Phase 8, part 2, on one preset's final grid from phase 5: the dense
    view, renders at 640x480 (cold at strides 1, 2 and 4, warm from the
    stride-1 range), the depth against the analytic scene, and the mesh in
    its stages with and without color. Returns the record."""
    import numpy as np

    from tracking_sdf_tpu_torch.fusion.brickmajor import BrickGrid, dense_from_brick_grid
    mc = importlib.import_module("tracking_sdf_tpu_torch.render.marching_cubes")
    from tracking_sdf_tpu_torch.render.raycast import raycast

    cfg = path_config(name, None)
    p, bs = cfg.grid, cfg.fusion.brick_shape
    voxel = p.width / p.m
    bg = BrickGrid(*rows)
    base = memory_mark()
    grid = dense_from_brick_grid(bg, p, bs)
    torch.cuda.synchronize()
    rec = dict(dense_view_peak_gib=peak_gib_above(base),
               dense_view_gib=(torch.cuda.memory_allocated() - base) / 2 ** 30)
    rec["dense_view_ms"] = cuda_time_ms(lambda: dense_from_brick_grid(bg, p, bs),
                                        reps=RENDER_REPS, warmup=1)
    print(f"{name} ({p.m}^3) dense view from the brick rows: {rec['dense_view_ms']:.3f} ms "
          f"(median of {RENDER_REPS}, CUDA events), {rec['dense_view_gib']:.2f} GiB, peak "
          f"{rec['dense_view_peak_gib']:.2f} GiB above the rows while it is made")

    def render(stride, t_init=None):
        return raycast(grid, pose, params=p, cam=cam, cfg=cfg.raycast, stride=stride,
                       with_color=True, t_init=t_init)

    renders = {}
    base = memory_mark()  # the rows and the dense view
    for label, stride, warm in (("cold s1", 1, False), ("cold s2", 2, False),
                                ("cold s4", 4, False), ("warm s1", 1, True)):
        t_init = renders["cold s1"][1].range_t if warm else None
        r = render(stride, t_init)
        ms = cuda_time_ms(lambda: render(stride, t_init), reps=RENDER_REPS, warmup=0)
        hit = r.hit
        steps_hit = float(r.steps[hit].float().median()) if hit.any() else float("nan")
        renders[label] = (dict(ms=ms, hit_share=hit.float().mean().item(),
                               dropped=int(r.dropped),
                               median_steps=float(r.steps.float().median()),
                               median_steps_hit=steps_hit), r)
        rr = renders[label][0]
        print(f"  render {label} ({r.hit.shape[1]}x{r.hit.shape[0]}, color): {ms:.3f} ms (median "
              f"of {RENDER_REPS}), hit share {rr['hit_share']:.4f}, dropped {rr['dropped']}, "
              f"median steps {rr['median_steps']:.0f} (over hits {steps_hit:.0f})")
    rec["render_peak_gib"] = peak_gib_above(base)
    rec["renders"] = {k: v[0] for k, v in renders.items()}
    dev_ms, dev_ops = all_device_ms(lambda: render(1), n=3)
    wall = rec["renders"]["cold s1"]["ms"]
    rec.update(render_device_ms=dev_ms, render_device_ops=dev_ops, render_busy=dev_ms / wall)
    print(f"  render cold s1 under torch.profiler: device {dev_ms:.3f} ms in {dev_ops:.0f} device "
          f"ops per render, busy {dev_ms / wall:.1%} of its {wall:.3f} ms; peak "
          f"{rec['render_peak_gib']:.2f} GiB above the rows and the dense view")

    # depth against the analytic scene: the input frame at the final pose,
    # over the pixels whose exact hit lies inside the grid's box
    r = renders["cold s1"][1]
    from tracking_sdf_tpu_torch.core.camera import pixel_rays
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth

    exact = render_scene_depth(scene, cam, true_pose)
    dirs, _ = pixel_rays(cam, device=dev)
    pts = true_pose.t + exact[..., None] * torch.sum(true_pose.R * dirs[..., None, :], -1)
    lo = torch.tensor(p.origin, device=dev) + voxel
    hi = lo + torch.tensor(p.extent, device=dev) - 2 * voxel
    inside = torch.isfinite(exact) & ((pts >= lo) & (pts <= hi)).all(-1)
    judged = inside | ~torch.isfinite(exact)
    exact_hit = torch.isfinite(exact)
    agree = (r.hit == exact_hit)[judged].float().mean().item()
    both = r.hit & exact_hit & inside
    err = (r.depth - exact).abs()[both]
    med, p95 = err.median().item(), torch.quantile(err.float(), 0.95).item()
    rec.update(analytic_hit_agree=agree, analytic_median_m=med, analytic_p95_m=p95,
               analytic_pixels=int(judged.sum()))
    print(f"  depth vs the analytic scene at the final pose (rendered at the tracked pose; "
          f"{int(judged.sum())} pixels whose exact hit is inside the box or that miss): hit "
          f"agreement {agree:.4f} (>= {ANALYTIC_HIT_AGREE}), median |err| {med * 1e3:.3f} mm "
          f"(< {ANALYTIC_MEDIAN_M * 1e3:g}), 95th percentile {p95 * 1e3:.3f} mm "
          f"(< {ANALYTIC_P95_M * 1e3:g})")
    check(agree >= ANALYTIC_HIT_AGREE and med < ANALYTIC_MEDIAN_M and p95 < ANALYTIC_P95_M,
          f"{name}: the render disagrees with the analytic scene")
    del renders, r, exact, dirs, pts

    # meshes: one shot below 512^3, four i-slabs at 512^3, as the runner does
    n_chunks = 4 if p.m >= 512 else 1
    rec["mesh"] = {}
    for color in (False, True):
        base = memory_mark()  # the rows and the dense view
        t0 = time.perf_counter()
        whole = (mc.marching_cubes_chunked if n_chunks > 1 else mc.marching_cubes)(
            grid, params=p, with_colors=color, vertex_quant=True)
        whole_ms = (time.perf_counter() - t0) * 1e3
        peak = peak_gib_above(base)
        stages, mesh = mesh_stages(grid, p, color, n_chunks,
                                   os.path.join(work, f"{name}_{int(color)}.ply"))
        check(np.array_equal(mesh.vertices, whole.vertices)
              and (not color or np.array_equal(mesh.colors, whole.colors)),
              f"{name}: the staged mesh differs from marching_cubes'")
        dist = scene.sdf(torch.from_numpy(mesh.vertices.reshape(-1, 3)).to(dev)).abs()
        med_d = dist.median().item()
        label = "color" if color else "geometry"
        rec["mesh"][label] = dict(ms=whole_ms, stages_ms=stages, triangles=mesh.num_triangles,
                                  dropped_cells=whole.dropped_cells, median_dist_m=med_d,
                                  peak_gib=peak, slabs=n_chunks)
        print(f"  mesh {label} ({'4 i-slabs' if n_chunks > 1 else 'one shot'}, vertex_quant): "
              f"{whole_ms:.1f} ms in marching_cubes{'_chunked' if n_chunks > 1 else ''}; stages "
              f"{ {k: round(v, 3) for k, v in stages.items()} } ms; {mesh.num_triangles} "
              f"triangles, dropped cells {whole.dropped_cells}, median |sdf| of the vertices "
              f"{med_d * 1e3:.3f} mm (< half a voxel, {0.5 * voxel * 1e3:.2f} mm); peak "
              f"{peak:.2f} GiB above the rows and the dense view")
        check(mesh.num_triangles > 10000 and whole.dropped_cells == 0
              and med_d < 0.5 * voxel, f"{name}: mesh {label}")
        del whole, mesh
    del grid
    torch.cuda.empty_cache()
    return rec


def cli_render_phase(work, ref):
    """Phase 8, part 3: phase 7's tum256 chunked CLI run again with --mesh,
    --render and --mesh-async; the ATE must equal phase 7's to the digit."""
    import numpy as np

    from tracking_sdf_tpu_torch.config import preset
    from tracking_sdf_tpu_torch.data.tum import decode_png

    root = os.path.join(work, "seq")
    ply, png, live = (os.path.join(work, f) for f in ("final.ply", "final.png", "live.ply"))
    base = ["--preset", "tum256", "--dataset", root, "--chunk", str(DATASET_CHUNK)]
    if zlib_header_present():
        base.append("--native-loader")
    plain = base + ["--trajectory", os.path.join(work, "plain.txt")]
    argv = base + ["--trajectory", os.path.join(work, "flags.txt"), "--mesh", ply, "--render",
                   png, "--mesh-async", live]
    t0 = time.perf_counter()
    s0, recon, _, _ = cli_run("tum256 --chunk 8 (again, without the flags)", plain, work,
                              DATASET_CHUNK)
    plain_wall_s = time.perf_counter() - t0
    del recon
    t0 = time.perf_counter()
    s, recon, launches, rejected = cli_run("tum256 --chunk 8 --mesh --render --mesh-async",
                                           argv, work, DATASET_CHUNK)
    wall_s = time.perf_counter() - t0
    pub = recon.publisher
    with open(ply, "rb") as f:
        head = f.read(512).partition(b"end_header\n")[0].decode()
    n_faces = int(head.split("element face ")[1].split()[0])
    size_ok = os.path.getsize(ply) == len(head) + 11 + n_faces * (3 * 15 + 13)
    img, channels, _ = decode_png(png)
    cfg = preset("tum256")
    per_step = ((len(cfg.pyramid_levels) - 1) * COARSE_ITERATIONS + cfg.tracking.max_iterations)
    rec = dict(launches=launches, tracked=DATASET_FRAMES - 1, fused=DATASET_FRAMES - rejected,
               processed=s["processed"],
               ate_rmse_m=s["ate_rmse_m"], run_s=s["run_s"], wall_s=wall_s,
               plain_run_s=s0["run_s"], plain_wall_s=plain_wall_s,
               steady_ms=s["steady_ms"], plain_steady_ms=s0["steady_ms"],
               published=pub.published, errors=pub.errors, degraded_cycles=pub.degraded_cycles,
               effective_interval_s=pub.effective_interval, faces=n_faces)
    print(f"  PLY {ply}: {n_faces} faces, header parses, size matches {size_ok}; PNG "
          f"{img.shape} decodes; publisher published {pub.published}, errors {pub.errors} "
          f"(last {pub.last_error!r}), degraded cycles {pub.degraded_cycles}, effective "
          f"interval {pub.effective_interval:.3f} s; ATE {s['ate_rmse_m'] * 1e3:.4f} mm vs "
          f"phase 7's {ref['ate_rmse_m'] * 1e3:.4f} mm and {s0['ate_rmse_m'] * 1e3:.4f} mm "
          f"without the flags just before; run() {s['run_s']:.3f} s vs {s0['run_s']:.3f} s "
          f"without the flags (+{s['run_s'] - s0['run_s']:.3f} s: the publisher), steady "
          f"{s['steady_ms']:.3f} vs {s0['steady_ms']:.3f} ms/frame; the whole call "
          f"{wall_s:.3f} s vs {plain_wall_s:.3f} s (+{wall_s - plain_wall_s:.3f} s: the "
          f"publisher, the final mesh and render, the publisher's last export)")
    check(size_ok and n_faces > 10000 and img.shape == (480, 3 * 640, 3) and channels == 3,
          "phase 8 CLI: the PLY or the PNG is malformed")
    check(pub.published >= 1 and pub.errors == 0, f"phase 8 CLI: publisher {pub.published} "
          f"published, {pub.errors} errors ({pub.last_error!r})")
    check(s["ate_rmse_m"] == ref["ate_rmse_m"] == s0["ate_rmse_m"] and rejected == 0
          and s["frames"] == DATASET_FRAMES,
          "phase 8 CLI: the ATE differs from phase 7's run without the flags")
    check(launches["gn_step_brick"] == per_step * rec["tracked"]
          and launches["brick_fuse_rows"] == rec["fused"] and launches["brick_merge_rows"] == 0,
          f"phase 8 CLI: launches {launches}")
    del recon
    torch.cuda.empty_cache()
    return rec


# --- phase 9: the reference-exact path and the remaining single-device modes -

SAT_MAX_WEIGHT = 4.0  # below the runs' frame counts, so that FREE bricks saturate
SAT_BITS = {}  # sat_runs' bitset after its per-frame run with every FREE brick kept
SKIP_DIFFER_MAX, SKIP_DEPTH_SHARE = 0.01, 0.98  # tests/test_torch_raycast_skip.py
TAIL_TOL = 1e-5


def fuse_rows_sat_compare(name, cam, scene, poses, rgb, dev):
    """K2 with the sat_skip bitset on one preset's real lists: the second
    frame's FULL and FREE bricks against rows fused from the first frame four
    times at max_weight 3 (its FREE bricks at their fixed point). Rows and
    bitset bitwise against the plain version; the sat form's times beside the
    same launch without the bitset. Returns the record."""
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.fusion.brick import _pixel_table
    from tracking_sdf_tpu_torch.fusion.brick_fuse import (
        brick_fuse_rows, brick_fuse_rows_reference, group_centre_pixels)
    from tracking_sdf_tpu_torch.fusion.brickmajor import (
        classify_compact_rows, empty_brick_grid, fuse_frame_brickmajor)
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    cfg = path_config(name, None)
    f, p = cfg.fusion._replace(max_weight=3.0), cfg.grid
    bs, cap, cap_free = f.brick_shape, f.brick_cap, f.brick_cap_free
    frames = [preprocess_frame(render_scene_depth(scene, cam, poses[k]), cam=cam,
                               bilateral=cfg.bilateral_filter,
                               bilateral_mode=cfg.bilateral_mode) for k in (0, 1)]
    bg = empty_brick_grid(p, bs, device=dev, value_dtype=torch.bfloat16,
                          weight_dtype=torch.bfloat16)
    for _ in range(4):
        fuse_frame_brickmajor(bg, poses[0], *frames[0], rgb, params=p, cam=cam, cfg=f,
                              bs=bs, cap=cap, cap_free=cap_free)
    pts, nrm = frames[1]
    pose, hw = poses[1], tuple(frames[1][0].shape[:2])
    ids, _ = classify_compact_rows(p, pose, pts, nrm, cam=cam, cfg=f, bs=bs, cap=cap,
                                   cap_free=cap_free)
    NB, BV = bg.D.shape
    n_full, n_free = int((ids[:cap] < NB).sum()), int((ids[cap:] < NB).sum())
    n_pix = int(torch.unique(group_centre_pixels(ids[:cap][ids[:cap] < NB], pose, params=p,
                                                 cam=cam, cfg=f, bs=bs, hw=hw)).numel())
    pix = _pixel_table(pts, nrm, rgb, True, f.distance)
    kw = dict(cap=cap, hw=hw, params=p, cam=cam, cfg=f, bs=bs)
    lk = [x.clone() for x in (bg.D, bg.W, bg.C)]
    lr = [x.clone() for x in lk]
    sk = torch.zeros(NB, dtype=torch.bool, device=dev)
    sr = sk.clone()
    brick_fuse_rows(*lk, ids, pix, pose, sat=sk, **kw)
    brick_fuse_rows_reference(*lr, ids, pix, pose, sat=sr, **kw)
    torch.cuda.synchronize()
    nan_ok = all(torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(lk[:2], lr[:2]))
    differ = sum(int((a[~torch.isnan(b)].view(torch.int16)
                      != b[~torch.isnan(b)].view(torch.int16)).sum())
                 for a, b in zip(lk[:2], lr[:2])) + int((lk[2] != lr[2]).sum())
    differ_sat = int((sk != sr).sum())
    n_sat = int(sk.sum())
    err = max(float(torch.nan_to_num(a.float() - b.float()).abs().max())
              for a, b in zip(lk[:2], lr[:2]))
    scratch = sk.clone()

    def with_sat():
        brick_fuse_rows(*lk, ids, pix, pose, sat=scratch, **kw)

    def without():
        brick_fuse_rows(*lk, ids, pix, pose, **kw)

    rec = dict(max_abs_err=err, n_sat=n_sat, n_full=n_full, n_free=n_free,
               ms=events_ms(with_sat), ms_without=events_ms(without),
               device_ms=kernel_device_ms(with_sat, ("brick_fuse_rows_kernel",)),
               device_ms_without=kernel_device_ms(without, ("brick_fuse_rows_kernel",)),
               wrapper_ms=cuda_time_ms(with_sat),
               plain_ms=cuda_time_ms(lambda: brick_fuse_rows_reference(
                   *lr, ids, pix, pose, sat=sr, **kw)))
    # bytes: as the form without the bitset, plus one byte written per listed brick
    rec["bound_ms"], rec["bound_by"] = bound(n_full * BV * 24 + n_free * BV * 8
                                             + n_pix * pix.shape[1] * 4 + ids.numel() * 4
                                             + 48 + n_full + n_free)
    label = f"K2 brick_fuse_rows with sat ({name}, color, max_weight 3)"
    print(f"{label} cap={cap} cap_free={cap_free}: {differ} stored values and {differ_sat} "
          f"bits differ (tol 0), NaN masks equal {nan_ok}, {n_sat} bricks set of {n_free} "
          f"FREE; sat form {rec['ms']:.4f} ms ({TIMED_LAUNCHES} back-to-back), device "
          f"{rec['device_ms']} ms, without the bitset {rec['ms_without']:.4f} ms, device "
          f"{rec['device_ms_without']} ms; wrapper {rec['wrapper_ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    check(differ == 0 and differ_sat == 0 and nan_ok,
          f"{label} disagrees with its plain version: {differ} values, {differ_sat} bits")
    check(n_sat > 100, f"{label}: only {n_sat} bricks saturated")
    del lk, lr, bg
    torch.cuda.empty_cache()
    return rec


def bench_path(label, cfg, cam, depths, poses, rgb, dev, n_tracked):
    """One configuration per frame over phase 5's scene, the launch counts
    set to 0 just before and read just after: its record and final rows (or
    grid)."""
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    recon = Reconstruction(cam, cfg, initial_pose=poses[0], device=dev)
    mark = memory_mark()
    reset_counters()
    wall = []
    for k in range(n_tracked + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recon.process_frame(depths[k], rgb=rgb, timestamp=float(k))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    launches = counters()
    tracked = recon.stats[1:]
    t_err = (recon.pose.t - poses[n_tracked].t).norm().item()
    med = {k: statistics.median(getattr(s, k) for s in tracked)
           for k in ("preprocess_ms", "track_ms", "fuse_ms")}
    check_preprocess(label, launches, n_tracked + 1, filter_mode(cfg))
    check_classify(label, launches, recon.config, sum(not s.rejected for s in recon.stats))
    rec = dict(ms_per_frame=statistics.median(wall[1:]), t_err_mm=t_err * 1e3,
               launches=launches, tracked=len(tracked), processed=n_tracked + 1,
               fused=sum(not s.rejected for s in recon.stats),
               gn_iterations=sum(s.gn_iterations for s in tracked),
               peak_gib=peak_gib_above(mark), **med)
    print(f"{label} ({cfg.grid.m}^3, {n_tracked} tracked frames): median "
          f"{rec['ms_per_frame']:.2f} ms/frame, preprocess {med['preprocess_ms']:.2f}, track "
          f"{med['track_ms']:.2f}, fuse {med['fuse_ms']:.2f} ms; GN iterations "
          f"{rec['gn_iterations']}; final |t err| {rec['t_err_mm']:.2f} mm; peak "
          f"{rec['peak_gib']:.2f} GiB; launches {launches}")
    check(not any(s.rejected for s in recon.stats), f"{label}: a frame was rejected")
    check(t_err < T_ERR_MAX, f"{label}: |t err| {t_err:.4f} m")
    return rec, recon


def within_half_voxel(label, got_mm, ref_mm, grid):
    bar = 0.5 * grid.width / grid.m * 1e3
    print(f"  {label}: {got_mm:.4f} mm vs the JAX package's {ref_mm} mm (bound +-{bar:.2f} "
          f"mm, half a voxel)")
    check(abs(got_mm - ref_mm) <= bar, f"{label}: {got_mm:.4f} mm is not within half a voxel "
          f"of the JAX package's {ref_mm} mm")


def ply_faces(path):
    """The face count of a PLY that export_ply wrote; checks its size."""
    with open(path, "rb") as f:
        head = f.read(512).partition(b"end_header\n")[0].decode()
    n_faces = int(head.split("element face ")[1].split()[0])
    check(os.path.getsize(path) == len(head) + 11 + n_faces * (3 * 15 + 13),
          f"{path}: the PLY's size does not match its header")
    return n_faces


def k1_at_path(name, grid, pose, pts, cfg):
    """K1's dense reduction and step against their plain versions on one
    dense path's final grid, at the preset's stride: the shapes that path
    launches them at."""
    from tracking_sdf_tpu_torch.grid.interp import masked_view

    Dm = masked_view(grid.D, grid.W)
    stride = (cfg.tracking.pixel_stride,)
    return dict(gn_reduce=gn_compare(f"K1 gn_reduce (dense, {name})", Dm, pose, pts, cfg.grid,
                                     stride),
                gn_step=step_compare(f"K1 gn_step (dense, {name})", Dm, pose, pts, cfg.grid,
                                     cfg.tracking, stride))


@contextlib.contextmanager
def counting(module, name):
    """Counts calls of ``module.name`` while the block runs: [calls]."""
    calls, real = [0], getattr(module, name)

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def float64_solve():
    """torch.linalg.solve_ex in float64 while the block runs (the solution
    rounded back to its input's dtype): advance_state then solves as the
    card's finish does, from the same float32 damped system."""
    real = torch.linalg.solve_ex

    def solve(A, b, **kw):
        x, info = real(A.double(), b.double(), **kw)
        return x.to(A.dtype), info

    torch.linalg.solve_ex = solve
    try:
        yield
    finally:
        torch.linalg.solve_ex = real


def central_on_cpu(cfg, cam, depths, poses, rgb, n, pose_card):
    """The central tracker's run on the CPU over the card's own inputs (the
    same depth images, copied), with advance_state's float32 solve and
    again with a float64 one: which side a gap to the JAX figure comes
    from, and whether the card's float64 solve accounts for it."""
    from tracking_sdf_tpu_torch.core.lie import Pose
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    rec = {}
    for solve, key in (("float32", ""), ("float64", "_f64")):
        t0 = time.perf_counter()
        cpu = Pose(poses[0].R.cpu(), poses[0].t.cpu())
        recon = Reconstruction(cam, cfg, initial_pose=cpu, device="cpu")
        with float64_solve() if key else contextlib.nullcontext():
            for k in range(n + 1):
                recon.process_frame(depths[k].cpu(), rgb=rgb.cpu(), timestamp=float(k))
        t_err = (recon.pose.t - poses[n].t.cpu()).norm().item() * 1e3
        gap = (recon.pose.t - pose_card.t.cpu()).norm().item() * 1e3
        print(f"  tum128_central on the CPU, {solve} solve ({torch.get_num_threads()} "
              f"threads, {time.perf_counter() - t0:.1f} s): final |t err| {t_err:.4f} mm; "
              f"|t| card - CPU {gap:.4f} mm")
        rec.update({f"t_err_cpu{key}_mm": t_err, f"card_vs_cpu{key}_mm": gap})
    return rec


def dense_paths(cam, depths, poses, rgb, dev, work):
    """The dense presets: synthetic64 through the CLI, tum128 per frame (analytic and central) and over phase 7's frames, and
    tum256 --fusion-mode dense over them. Returns their records."""
    from tracking_sdf_tpu_torch import cli
    from tracking_sdf_tpu_torch.config import preset
    from tracking_sdf_tpu_torch.tracking import gn_reduce as k1
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    recs = {}
    ply = os.path.join(work, "synthetic64.ply")
    s, recon, launches, rejected = cli_run("synthetic64 (the JAX README's first command)", [
        "--preset", "synthetic64", "--synthetic", "--frames", "20", "--mesh", ply,
        "--trajectory", os.path.join(work, "synthetic64.txt")], work)
    faces = ply_faces(ply)
    cfg = preset("synthetic64")
    within_half_voxel("synthetic64 ATE", s["ate_rmse_m"] * 1e3, JAX_SYNTHETIC64_ATE_MM, cfg.grid)
    check(s["frames"] == 20 and rejected == 0 and faces > 1000
          and launches["gn_step"] == 19 * cfg.tracking.max_iterations
          and launches["brick_fuse_rows"] == 0, f"synthetic64: {s}, launches {launches}")
    recs["synthetic64"] = dict(launches=launches, tracked=19, fused=20, processed=20,
                               faces=faces,
                               ate_mm=s["ate_rmse_m"] * 1e3, steady_ms=s["steady_ms"])
    # K1's dense form at this path's shapes: the final 64^3 grid, queried
    # from the last tracked pose with the frame before's points (a step with
    # motion to solve), at the preset's stride
    frames, cam_s, _ = cli._synthetic_dataset(cfg, 20, dev)
    pts, _ = preprocess_frame(torch.as_tensor(frames[18].depth, device=dev), cam=cam_s,
                              bilateral_mode=cfg.bilateral_mode)
    recs["k1"] = {"synthetic64": k1_at_path("synthetic64", recon.grid, recon.pose, pts, cfg)}
    del recon, frames

    n = TRACKED["tum256"]
    for label, jacobian in (("tum128", "analytic"), ("tum128_central", "central")):
        c = preset("tum128")
        c = dataclasses.replace(c, trajectory_path=None,
                                tracking=c.tracking._replace(jacobian=jacobian))
        # advance_state: the CPU finish every tracker reaches through gn_reduce
        with counting(k1, "advance_state") as advances:
            rec, recon = bench_path(f"{label} per frame", c, cam, depths, poses, rgb, dev, n)
        within_half_voxel(f"{label} final |t err|", rec["t_err_mm"], JAX_T_ERR_MM[label],
                          c.grid)
        iters = n * c.tracking.max_iterations
        want = (iters, 0) if jacobian == "analytic" else (0, iters)
        check((rec["launches"]["gn_step"], rec["launches"]["gn_finish"]) == want
              and rec["launches"]["brick_fuse_rows"] == 0 and advances[0] == 0,
              f"{label}: launches {rec['launches']}, advance_state calls {advances[0]}")
        if jacobian == "central":
            print(f"  {label}: gn_finish {rec['launches']['gn_finish']} launches (one a GN "
                  f"iteration), advance_state {advances[0]} calls; track {rec['track_ms']:.2f} "
                  f"ms a frame (median; target under 60 ms); final "
                  f"|t err| {rec['t_err_mm']:.4f} mm (JAX {JAX_T_ERR_MM[label]} mm)")
        recs[label] = rec
        if jacobian == "analytic":
            # K1 at this path's shapes: the final 128^3 grid, the last
            # frame's points from the pose before it
            pts, _ = preprocess_frame(depths[n], cam=cam, bilateral_mode=c.bilateral_mode)
            recs["k1"]["tum128"] = k1_at_path("tum128", recon.grid, poses[n - 1], pts, c)
        else:
            recs[label].update(central_on_cpu(c, cam, depths, poses, rgb, n, recon.pose))
        del recon

    root = os.path.join(work, "seq")
    loader = ["--native-loader"] if zlib_header_present() else []
    for label, name, ref, extra in (
            ("tum128_dataset", "tum128", "tum128", []),
            ("tum256_dense", "tum256", "tum256_dense", ["--fusion-mode", "dense"])):
        cfg = preset(name)
        mark = memory_mark()
        s, recon, launches, rejected = cli_run(
            f"{label} over the {DATASET_FRAMES} frames",
            ["--preset", name, "--dataset", root, "--trajectory",
             os.path.join(work, f"{label}.txt")] + loader + extra, work)
        peak = peak_gib_above(mark)
        per = ((len(cfg.pyramid_levels) - 1) * COARSE_ITERATIONS if cfg.pyramid_levels
               else 0) + cfg.tracking.max_iterations
        print(f"  {label}: steady {s['steady_ms']:.3f} ms/frame, track {s['track_ms_mean']:.3f} "
              f"and fuse {s['fuse_ms_mean']:.3f} ms a frame (means), peak {peak:.2f} GiB "
              f"above what was allocated before")
        within_half_voxel(f"{label} ATE", s["ate_rmse_m"] * 1e3, JAX_ATE_MM[ref], cfg.grid)
        check(s["frames"] == DATASET_FRAMES and rejected == 0
              and launches["gn_step"] == per * (DATASET_FRAMES - 1)
              and launches["gn_step_brick"] == launches["brick_fuse_rows"] == 0,
              f"{label}: {s}, launches {launches}")
        recs[label] = dict(launches=launches, tracked=DATASET_FRAMES - 1,
                           fused=DATASET_FRAMES, processed=DATASET_FRAMES,
                           ate_mm=s["ate_rmse_m"] * 1e3,
                           steady_ms=s["steady_ms"], track_ms=s["track_ms_mean"],
                           fuse_ms=s["fuse_ms_mean"], peak_gib=peak, run_s=s["run_s"])
        del recon
        torch.cuda.empty_cache()
    return recs


def flat_tails(cam, scene, depths, poses, rgb, dev):
    """The flat slice with each merge tail, tracked; then the three tails
    fusing the same five frames at their true poses."""
    from tracking_sdf_tpu_torch.fusion.brick import fuse_frame_bricked
    from tracking_sdf_tpu_torch.grid.grid import FIELDS, empty_grid
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    recs = {}
    for merge in ("xla", "rows", "pallas"):
        c = path_config("slice", None)
        c = dataclasses.replace(c, fusion=c.fusion._replace(brick_merge=merge))
        rec, recon = bench_path(f"slice, brick_merge {merge}", c, cam, depths, poses, rgb,
                                dev, TRACKED["slice"])
        k2 = rec["launches"]["brick_merge"]
        check(k2 == (rec["fused"] if merge == "pallas" else 0)
              and rec["launches"]["gn_step"] > 0, f"slice {merge}: launches {rec['launches']}")
        recs[f"slice_{merge}"] = rec
        del recon
    c = path_config("slice", None)
    grids = {}
    for merge in ("xla", "rows", "pallas"):
        g = empty_grid(c.grid, device=dev)
        for k in range(TRACKED["slice"] + 1):
            pts, nrm = preprocess_frame(depths[k], cam=cam, bilateral_mode=c.bilateral_mode)
            fuse_frame_bricked(g, poses[k], pts, nrm, rgb, params=c.grid, cam=cam,
                               cfg=c.fusion, bs=c.fusion.brick_shape, cap=c.fusion.brick_cap,
                               merge=merge)
        grids[merge] = g
    errs = {m: max(float((getattr(grids[m], k) - getattr(grids["pallas"], k)).abs().max())
                   for k in FIELDS) for m in ("xla", "rows")}
    t_err = {m: round(recs[f"slice_{m}"]["t_err_mm"], 3) for m in ("xla", "rows", "pallas")}
    print(f"flat tails at the true poses ({TRACKED['slice'] + 1} frames, 256^3): max |leaf - "
          f"pallas tail's| {errs} (tol {TAIL_TOL:g}); tracked |t err| {t_err} mm")
    check(all(e <= TAIL_TOL for e in errs.values()), f"the flat tails disagree: {errs}")
    recs["tails_max_err"] = errs
    del grids
    torch.cuda.empty_cache()
    return recs


def sat_runs(name, cam, depths, poses, rgb, dev):
    """sat_skip at max_weight 4, per frame and chunked, against the run
    without it: bitwise with every FREE brick kept (cap_free = NB), and the
    FREE counts at the preset's own cap_free. Returns the records."""
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    base = path_config(name, None)
    nb = (base.grid.m // 8) ** 3
    n = TRACKED[name] + 1
    half = (n - 1) // 2
    recs = {}

    def run(skip, cap_free, chunked):
        f = base.fusion._replace(max_weight=SAT_MAX_WEIGHT, sat_skip=skip,
                                 brick_cap_free=cap_free)
        recon = Reconstruction(cam, dataclasses.replace(base, fusion=f), initial_pose=poses[0],
                               device=dev)
        recon.chunk_phase_metrics = False
        reset_counters()
        recon.process_frame(depths[0], rgb=rgb, timestamp=0.0)
        fuse = [recon.last_fuse_stats]
        if chunked:
            for k, size in ((1, half), (1 + half, n - 1 - half)):
                recon.process_chunk(torch.stack(depths[k:k + size]),
                                    rgb[None].expand(size, -1, -1, -1))
                fuse += recon.chunk_fuse_stats
        else:
            for k in range(1, n):
                recon.process_frame(depths[k], rgb=rgb, timestamp=float(k))
                fuse.append(recon.last_fuse_stats)
        torch.cuda.synchronize()
        return recon, fuse, counters()

    def same_rows(a, b):
        return all(torch.equal(x.view(torch.int16), y.view(torch.int16))
                   for x, y in zip((a.D, a.W, a.C), (b.D, b.W, b.C)))

    for cap_free, tag in ((nb, "NB"), (base.fusion.brick_cap_free, "preset")):
        off, f_off, _ = run(False, cap_free, False)
        on, f_on, l_on = run(True, cap_free, False)
        if tag == "NB":  # phase 13 classifies with these bits
            SAT_BITS[name] = on._sat.clone()
        onc, f_onc, l_onc = run(True, cap_free, True)
        equal = same_rows(off.brick_grid, on.brick_grid)
        equal_c = same_rows(on.brick_grid, onc.brick_grid)
        print(f"{name} sat_skip, max_weight {SAT_MAX_WEIGHT:g}, cap_free {cap_free} ({tag}): "
              f"per frame n_free / overflow_active / n_sat with the skip "
              f"{[(s.n_free, s.overflow_active, s.n_sat) for s in f_on]}, without "
              f"{[(s.n_free, s.overflow_active, s.n_sat) for s in f_off]}; chunked "
              f"{[(s.n_free, s.overflow_active, s.n_sat) for s in f_onc]}; rows equal to the "
              f"run without the skip {equal}, chunked equal to per frame {equal_c}; launches "
              f"{l_on} per frame, {l_onc} chunked")
        check(l_on["brick_fuse_rows_sat"] == n and l_on["brick_fuse_rows"] == 0
              and l_onc["brick_fuse_rows_sat"] == n,
              f"{name} sat_skip: the sat form must launch once per fused frame: {l_on}, {l_onc}")
        check_preprocess(f"{name} sat_skip per frame", l_on, n, filter_mode(base))
        check_preprocess(f"{name} sat_skip chunked", l_onc, n, filter_mode(base))
        check_classify(f"{name} sat_skip per frame", l_on, base)
        check_classify(f"{name} sat_skip chunked", l_onc, base)
        # the per-frame loop adapts its FULL cap, the chunk holds the maximum:
        # equal unless the per-frame run dropped FULL bricks
        full_drop = any(s.overflow for s in f_on)
        check((equal_c and f_onc == f_on) or full_drop,
              f"{name} sat_skip: chunked differs from per frame")
        if tag == "NB":
            check(equal and f_on[-1].n_sat > 0,
                  f"{name} sat_skip with every FREE brick kept: rows equal {equal}, n_sat "
                  f"{f_on[-1].n_sat}")
        recs[tag] = dict(n_free_on=[s.n_free for s in f_on], n_free_off=[s.n_free for s in f_off],
                         overflow_on=[s.overflow_active for s in f_on],
                         overflow_off=[s.overflow_active for s in f_off],
                         n_sat=[s.n_sat for s in f_on], rows_equal=equal)
        recs[f"launches_{tag}"] = l_on
        del off, on, onc
        torch.cuda.empty_cache()
    return dict(recs, launches={k: recs["launches_NB"][k] + recs["launches_preset"][k]
                                for k in recs["launches_NB"]},
                fused=2 * n, tracked=2 * (n - 1), processed=2 * n)


def band_leap_margin(grid, pose, p, cam, rcfg):
    """far_field="chamfer"'s soundness on one render, as
    tests/test_torch_raycast_skip.py holds it at m=64: every band leap taken
    before a ray first enters a surface-band brick lands at least one voxel
    cell's diagonal before that entry (sampled every 1/20 voxel). A step
    longer than the nearest voxel's ordinary step is a leap. Returns (leaps
    checked, least margin in m; >= 0 is sound)."""
    from tracking_sdf_tpu_torch.core.camera import pixel_rays
    from tracking_sdf_tpu_torch.grid.grid import world_to_voxel
    from tracking_sdf_tpu_torch.grid.interp import masked_view
    rc = importlib.import_module("tracking_sdf_tpu_torch.render.raycast")

    samples, real = [], rc._leap  # each nearest step's sample points
    rc._leap = lambda mip, uvw, ext: samples.append(uvw) or real(mip, uvw, ext)
    try:
        rc.raycast(grid, pose, params=p, cam=cam, cfg=rcfg._replace(far_field="chamfer"))
    finally:
        rc._leap = real
    dev = grid.D.device
    d = rc._rotate(pose.R, pixel_rays(cam, 1, device=dev)[0]).reshape(-1, 3)
    u = d / d.norm(dim=-1, keepdim=True)
    Dm = masked_view(grid.D, grid.W)
    band = rc._band_skip_mip(Dm, p, rcfg.far_band)
    nb, m = band.shape[0], p.m
    entry = torch.full((u.shape[0],), float("inf"), device=dev)
    for c in torch.split(torch.arange(rcfg.t_near, rcfg.t_far, min(p.voxel_size) / 20,
                                      device=dev), 64):
        uvw = world_to_voxel(p, pose.t + c[None, :, None] * u[:, None, :])
        b = (uvw / 8).to(torch.int64).clamp(0, nb - 1)
        inb = ((uvw >= 0) & (uvw < m)).all(-1) & (band[b[..., 0], b[..., 1], b[..., 2]] == 0)
        entry = torch.minimum(entry, torch.where(inb.any(1), c[inb.to(torch.int8).argmax(1)],
                                                 float("inf")))
        del uvw, b, inb
    scale = torch.tensor([m / e for e in p.extent], device=dev)
    origin = torch.tensor(p.origin, device=dev)
    h_max = max(p.extent) / m
    delta = p.delta
    miss = rcfg.miss_step if rcfg.miss_step > 0 else delta / 2
    diag = math.sqrt(sum(v * v for v in p.voxel_size))
    n_taken, margin = 0, float("inf")
    t_prev = None
    for uvw in samples:
        t = (((uvw + 0.5) / scale + origin - pose.t) * u).sum(-1)
        if t_prev is not None:
            n = torch.round(uvw_prev).clamp(0, m - 1).to(torch.int64)
            phi = Dm[n[:, 0], n[:, 1], n[:, 2]].float()
            ordinary = torch.where(torch.isfinite(phi), (phi - rc._LIPSCHITZ_MARGIN * h_max)
                                   .clamp(min=0.0) * rcfg.step_scale, miss).clamp(max=delta)
            taken = (t_prev < entry) & (t - t_prev > ordinary + 1e-5)
            n_taken += int(taken.sum())
            if bool(taken.any()):
                margin = min(margin, float((entry - diag - t)[taken].min()))
        t_prev, uvw_prev = t, uvw
    return n_taken, margin


def skip_renders(name, rows, pose, cam):
    """Renders of one preset's final rows from phase 5 with empty_skip and
    with far_field="chamfer" against the plain march (stride 1, 640x480),
    and the band leap's soundness on the chamfer render."""
    from tracking_sdf_tpu_torch.fusion.brickmajor import BrickGrid, dense_from_brick_grid
    from tracking_sdf_tpu_torch.render.raycast import raycast

    cfg = path_config(name, None)
    p = cfg.grid
    grid = dense_from_brick_grid(BrickGrid(*rows), p, cfg.fusion.brick_shape)

    def render(**kw):
        return raycast(grid, pose, params=p, cam=cam, cfg=cfg.raycast._replace(**kw))

    out = {}
    plain = render()
    for label, kw in (("plain", {}), ("empty_skip", dict(empty_skip=True)),
                      ("chamfer", dict(far_field="chamfer"))):
        r = render(**kw)
        ms = cuda_time_ms(lambda: render(**kw), reps=RENDER_REPS, warmup=0)
        differ = (r.hit != plain.hit).float().mean().item()
        both = r.hit & plain.hit
        err = (r.depth - plain.depth).abs()[both]
        share = (err <= 1e-4).float().mean().item()
        out[label] = dict(ms=ms, median_steps=float(r.steps.float().median()),
                          mean_steps=r.steps.float().mean().item(), hit_differ=differ,
                          lost=int((plain.hit & ~r.hit).sum()),
                          gained=int((r.hit & ~plain.hit).sum()),
                          max_depth_err=float(err.max()), depth_share=share,
                          dropped=int(r.dropped))
        print(f"  {name} render {label}: {ms:.3f} ms (median of {RENDER_REPS}), median steps "
              f"{out[label]['median_steps']:.0f}, mean {out[label]['mean_steps']:.2f}, "
              f"dropped {int(r.dropped)}; hit masks differ from the plain march on "
              f"{differ:.5f} of the pixels ({out[label]['lost']} hits lost, "
              f"{out[label]['gained']} gained), depth within 1e-4 m on {share:.5f} of common "
              f"hits, largest difference {out[label]['max_depth_err']:.4g} m")
        check(differ <= SKIP_DIFFER_MAX and share >= SKIP_DEPTH_SHARE
              and out[label]["mean_steps"] <= out["plain"]["mean_steps"],
              f"{name}: the {label} render departs from the plain march")
    n_taken, margin = band_leap_margin(grid, pose, p, cam, cfg.raycast)
    print(f"  {name} band leaps: {n_taken} taken before a ray's first band brick; the "
          f"closest landed {margin:.4f} m before the point one cell diagonal short of its "
          f"entry (>= 0: sound)")
    check(n_taken > 1000 and margin >= -1e-5,
          f"{name}: a band leap lands within a cell diagonal of the band ({margin})")
    out["chamfer"].update(leaps_checked=n_taken, leap_margin_m=margin)
    del grid
    torch.cuda.empty_cache()
    return out



# --- phase 10: multi-device ---------------------------------------------------

# tools/jax_reference_figures.py (JAX 0.9.0 on the CPU, 2 virtual devices,
# unmodified presets on the JAX package's sharded path, which runs no
# pyramid): |t err| on the scene above after 10 / 5 tracked frames, and the
# CLI's ATE with --distributed over the 120 generated frames (per frame,
# --native-loader).
JAX_SHARDED_T_ERR_MM = {"tum256": 39.6660, "tum512": 29.9349}
JAX_SHARDED_ATE_MM = {"tum256": 12.6821}
SHARDED_TRACKED = {"tum256": 10, "tum512": 5}
SLAB_RTOL, SLAB_ATOL = 1e-5, 1e-4  # K1's slab form: tests/test_pallas_gn.py's bars
RANK_POSE_TOL, RANK_W_TOL, RANK_D_TOL = 1e-4, 1e-3, 1e-2  # tests/test_parallel.py:352-363
# W may differ by a whole observation on this share of the voxels at most: the
# ranks' float32 sums in another order move the pose by ~1e-7, and a voxel
# whose projection or brick class lies on a boundary then fuses once more or
# less (17 of 256^3 voxels on the H100)
RANK_W_SHARE = 1e-5
GROUP_TIMEOUT_S = 600


def compute_mode() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def slab_views(whole, n, p):
    """Rank r's view of an n-way i-split of a masked view: its slab and the
    next rank's first plane (dense) or brick layer, NaN past the last."""
    from tracking_sdf_tpu_torch.grid.interp import BrickMaskedView

    m, s = p.m, p.m // n
    if not isinstance(whole, BrickMaskedView):
        nan = torch.full((1, m, m), float("nan"), device=whole.device)
        return [torch.cat([whole[r * s:(r + 1) * s],
                           whole[(r + 1) * s:(r + 1) * s + 1] if r < n - 1 else nan])
                for r in range(n)]
    rows, bs = whole.rows, whole.bs
    per, layer = rows.shape[0] // n, (m // bs[1]) * (m // bs[2])
    nan = torch.full((layer, rows.shape[1]), float("nan"), device=rows.device,
                     dtype=rows.dtype)
    return [BrickMaskedView(torch.cat([rows[r * per:(r + 1) * per],
                                       rows[(r + 1) * per:(r + 1) * per + layer]
                                       if r < n - 1 else nan]), m, bs, mi=s + bs[0])
            for r in range(n)]


def k1_slab_compare(label, whole, pose, q, p, tcfg, n=2):
    """K1's slab form (slab_stepper's reduce, the pose read from its GN
    state buffer) on each of n slabs against its plain version, and the
    slabs' sums against the whole-grid kernel's. Returns the first slab's
    record (times, bound) with the largest error."""
    from tracking_sdf_tpu_torch.tracking import gn_reduce as k1

    s = p.m // n
    state = k1.init_state(pose, 0.0)
    views = slab_views(whole, n, p)
    outs, err, nvalid = [], 0.0, []
    for r, v in enumerate(views):
        out = k1.slab_stepper(v, state, q, p, tcfg, i0=r * s, slab=s)[0]().clone()
        ref = k1.gn_reduce_slab_reference(v, state, q, p, tcfg, i0=r * s, slab=s)
        torch.cuda.synchronize()
        close = bool(torch.allclose(out[:27], ref[:27], rtol=SLAB_RTOL, atol=SLAB_ATOL))
        err = max(err, (out[:27] - ref[:27]).abs().max().item())
        nvalid.append(int(out[27].item()))
        check(close and out[27].item() == ref[27].item(),
              f"{label} slab {r}: the kernel disagrees with its plain version (rtol "
              f"{SLAB_RTOL}, atol {SLAB_ATOL}): valid {out[27].item()} vs {ref[27].item()}, "
              f"max abs err {(out[:27] - ref[:27]).abs().max().item():.3e}")
        outs.append(out)
    total = torch.stack(outs).sum(0)
    one = k1.gn_reduce(whole, pose, q, p)
    sum_err = (total[:27] - one[:27]).abs().max().item()
    # elementwise at the slabs' bar, and relative to the largest |A| and |b|
    # as K1 is held to everywhere else: the slabs' float32 sums are taken in
    # another order, and an entry that cancels (small beside its terms)
    # keeps their rounding
    past = (total[:27] - one[:27]).abs() > SLAB_ATOL + SLAB_RTOL * one[:27].abs()
    rel = max((total[sl] - one[sl]).abs().max().item()
              / max(one[sl].abs().max().item(), 1e-30) for sl in (slice(0, 21), slice(21, 27)))
    print(f"{label}: the slabs' sums against the whole grid's: {int(past.sum())} of 27 "
          f"entries past rtol {SLAB_RTOL} / atol {SLAB_ATOL} (the largest |difference| "
          f"{sum_err:.3e}), relative {rel:.3e} of max |A| / |b| (tol {REL_TOL_GN:g})")
    check(int(total[27].item()) == int(one[27].item()) and rel <= REL_TOL_GN,
          f"{label}: the slabs' sums ({int(total[27].item())} valid) do not add up to the "
          f"whole grid's ({int(one[27].item())} valid, relative error {rel:.3e})")
    v0 = views[0]
    launch = k1.slab_stepper(v0, state, q, p, tcfg, i0=0, slab=s)[0]
    ms = events_ms(launch)
    device_ms = kernel_device_ms(launch, ("gn_reduce_slab_kernel",))
    wrapper_ms = cuda_time_ms(lambda: k1.slab_stepper(v0, state, q, p, tcfg, i0=0,
                                                      slab=s)[0]())
    plain_ms = cuda_time_ms(lambda: k1.gn_reduce_slab_reference(v0, state, q, p, tcfg,
                                                                i0=0, slab=s))
    bms, by = k1_bound(q.shape[0], nvalid[0], whole.dtype.itemsize, 29 * 4)
    print(f"{label} slab form, {n} slabs, N={q.shape[0]}: valid {nvalid} (whole "
          f"{int(one[27].item())}), max abs err vs plain {err:.3e}, slabs' sum vs whole "
          f"{sum_err:.3e} (rtol {SLAB_RTOL}, atol {SLAB_ATOL}); slab 0: kernel {ms:.4f} ms "
          f"({TIMED_LAUNCHES} back-to-back), device {device_ms} ms, wrapper "
          f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.6f} ms ({by})")
    return dict(max_abs_err=err, sum_max_abs_err=sum_err, sum_rel_err=rel,
                sum_entries_past_rtol=int(past.sum()), ms=ms, device_ms=device_ms,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                n=q.shape[0], valid=nvalid)


def host_ms(fn, n: int = 50) -> float:
    """Host time a call of ``fn`` over ``n`` calls, ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def slab_gate_and_finish(label, whole, pose, q, p, tcfg, mesh):
    """On one rank holding the whole grid (i0 0, slab m): a level of slab
    iterations (reduce, the mesh's all_reduce, gn_finish) against a level
    of gn_step launches, bit for bit after every iteration; gn_finish
    against advance_state (one step from the same sums: relative twist
    error, equal counts and flags; a level, each on its own sums: equal
    step counts, pose within POSE_TOL_LEVEL); gn_finish's device time beside
    advance_state's host time, device time and ops, and solve_ex's time."""
    from tracking_sdf_tpu_torch.tracking import gn_reduce as k1

    sa, sb = k1.init_state(pose, tcfg.damping), k1.init_state(pose, tcfg.damping)
    reduce, finish = k1.slab_stepper(whole, sa, q, p, tcfg, i0=0, slab=p.m)
    step = k1.gn_stepper(whole, sb, q, p, tcfg)
    first_differ = None
    for it in range(tcfg.max_iterations):
        finish(mesh.all_reduce_(reduce()))
        step()
        if first_differ is None and not torch.equal(sa.view(torch.int32),
                                                    sb.view(torch.int32)):
            first_differ = it
    steps = int(sa.view(torch.int32)[k1.S_COUNT])
    # gn_finish against advance_state
    s0 = k1.init_state(pose, tcfg.damping)
    sums = k1.slab_stepper(whole, s0, q, p, tcfg)[0]().clone()
    sk, sr = s0.clone(), s0.clone()
    k1.slab_stepper(whole, sk, q, p, tcfg)[1](sums)
    k1.advance_state(sr, *k1.unpack(sums), tcfg)
    torch.cuda.synchronize()
    tk, tr = sk[k1.S_TWIST:k1.S_TWIST + 6], sr[k1.S_TWIST:k1.S_TWIST + 6]
    err = ((tk - tr).abs().max() / tr.abs().max().clamp(min=1e-30)).item()
    max_abs = (sk[:k1.S_COUNT] - sr[:k1.S_COUNT]).abs().max().item()
    ints_same = torch.equal(sk.view(torch.int32)[k1.S_COUNT:],
                            sr.view(torch.int32)[k1.S_COUNT:])
    lk, lr = k1.init_state(pose, tcfg.damping), k1.init_state(pose, tcfg.damping)
    rk, fk = k1.slab_stepper(whole, lk, q, p, tcfg)
    for _ in range(tcfg.max_iterations):
        fk(rk())
        k1.advance_state(lr, *k1.unpack(k1.gn_reduce_slab_reference(whole, lr, q, p, tcfg)),
                         tcfg)
    torch.cuda.synchronize()
    iters = (int(lk.view(torch.int32)[k1.S_COUNT]), int(lr.view(torch.int32)[k1.S_COUNT]))
    dpose = (lk[:k1.S_LAM] - lr[:k1.S_LAM]).abs().max().item()
    # times on a level that never converges
    never = tcfg._replace(max_iterations=1 << 30, min_iterations=0, max_twist_diff=-1.0)
    sn = k1.init_state(pose, tcfg.damping)
    fin = k1.slab_stepper(whole, sn, q, p, never)[1]
    ms = events_ms(lambda: fin(sums))
    device_ms = kernel_device_ms(lambda: fin(sums), ("gn_finish_kernel",))
    wrapper_ms = cuda_time_ms(lambda: fin(sums))
    sp = k1.init_state(pose, tcfg.damping)
    adv = k1.unpack(sums)
    plain_host_ms = host_ms(lambda: k1.advance_state(sp, *adv, never))
    plain_ms = cuda_time_ms(lambda: k1.advance_state(sp, *adv, never))
    plain_dev_ms, plain_ops = all_device_ms(lambda: k1.advance_state(sp, *adv, never))
    A = adv[0] + tcfg.damping * torch.diag(torch.diag(adv[0])) + 1e-12 * torch.eye(
        6, device=sums.device)
    solve_ms = cuda_time_ms(lambda: torch.linalg.solve_ex(A, adv[1]))
    bms, by = bound(29 * 4 + 2 * k1.N_STATE * 4)
    print(f"{label}: one rank, whole grid: {tcfg.max_iterations} slab iterations (reduce, "
          f"the {mesh.backend} all_reduce, gn_finish) against as many gn_step launches: "
          f"bitwise after every iteration {first_differ is None} (first difference at "
          f"iteration {first_differ}), {steps} steps run; gn_finish vs advance_state: one "
          f"step rel twist err {err:.3e} (tol {REL_TOL_STEP:g}), max abs state err "
          f"{max_abs:.3e}, counts and flags equal {ints_same}; a level {iters[0]} steps "
          f"(plain {iters[1]}), max |pose diff| {dpose:.3e} (tol {POSE_TOL_LEVEL:g}); "
          f"gn_finish {ms:.4f} ms ({TIMED_LAUNCHES} back-to-back), device {device_ms} ms, "
          f"wrapper {wrapper_ms:.4f} ms; advance_state host {plain_host_ms:.4f} ms a call, "
          f"events {plain_ms:.4f} ms, device {plain_dev_ms:.4f} ms in {plain_ops:.0f} ops; "
          f"solve_ex {solve_ms:.4f} ms; bound {bms:.8f} ms ({by}; latency in practice)")
    check(first_differ is None,
          f"{label}: the one-rank slab iteration differs from gn_step at iteration "
          f"{first_differ}")
    check(err <= REL_TOL_STEP and ints_same,
          f"{label}: gn_finish disagrees with advance_state: {err}, {ints_same}")
    check(iters[0] == iters[1] and dpose <= POSE_TOL_LEVEL,
          f"{label}: a gn_finish level disagrees with advance_state: {iters}, {dpose}")
    return dict(bitwise_gn_step=True, steps=steps, max_abs_err=max_abs, twist_rel_err=err,
                level_pose_err=dpose, ms=ms, device_ms=device_ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, plain_host_ms=plain_host_ms, plain_device_ms=plain_dev_ms,
                plain_device_ops=plain_ops, library_ms=solve_ms,
                library_call="torch.linalg.solve_ex (the solve only)", bound_ms=bms,
                bound_by=by)


def k1_slab_phase(cam, scene, poses, rgb, dev, mesh):
    """K1's slab form on tum256's real bf16 rows (fused from the first
    frame) and on tum128's dense 128^3 masked view, at the second frame's
    stride-3 queries; on the same views the one-rank gate against gn_step
    and gn_finish against advance_state (``mesh``: the one-rank group).
    Returns ({name: slab record}, {name: finish record})."""
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.fusion.brickmajor import (
        brick_masked_view, empty_brick_grid, fuse_frame_brickmajor)
    from tracking_sdf_tpu_torch.fusion.fuse import fuse_frame
    from tracking_sdf_tpu_torch.grid.grid import empty_grid
    from tracking_sdf_tpu_torch.grid.interp import masked_view
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    out, fin = {}, {}
    for name in ("tum256", "tum128"):
        cfg = path_config(name, None)
        f, p = cfg.fusion, cfg.grid
        frames = [preprocess_frame(render_scene_depth(scene, cam, poses[k]), cam=cam,
                                   bilateral=cfg.bilateral_filter,
                                   bilateral_mode=cfg.bilateral_mode) for k in (0, 1)]
        if f.mode == "brickmajor":
            bg = empty_brick_grid(p, f.brick_shape, device=dev, value_dtype=torch.bfloat16,
                                  weight_dtype=torch.bfloat16)
            fuse_frame_brickmajor(bg, poses[0], *frames[0], rgb, params=p, cam=cam, cfg=f,
                                  bs=f.brick_shape, cap=f.brick_cap,
                                  cap_free=f.brick_cap_free)
            whole = brick_masked_view(bg, p, f.brick_shape)
        else:
            g = fuse_frame(empty_grid(p, device=dev), poses[0], *frames[0], rgb, params=p,
                           cam=cam, cfg=f)
            whole = masked_view(g.D, g.W).contiguous()
        q = frames[1][0][::3, ::3].reshape(-1, 3).contiguous()
        label = (f"K1 gn_reduce_slab ({name}, "
                 f"{'brick bf16' if f.mode == 'brickmajor' else 'dense'})")
        out[name] = k1_slab_compare(label, whole, poses[1], q, p, cfg.tracking)
        fin[name] = slab_gate_and_finish(label.replace("gn_reduce_slab", "gn_finish"),
                                         whole, poses[0], q, p, cfg.tracking, mesh)
        del whole
    torch.cuda.empty_cache()
    return out, fin


def k2_slab_compare(name, cam, scene, poses, rgb, dev, n=2):
    """K2's slab form on each of n slabs' real lists of the second frame
    (rows fused from the first), at the caps per rank: bitwise against its
    plain version; with caps that bind nowhere, the slabs' rows concatenated
    bitwise equal to the whole-grid kernel's at the same pose. Times and the
    bound of slab 0 at the caps per rank."""
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.fusion.brick import _pixel_table
    from tracking_sdf_tpu_torch.fusion.brick_fuse import (
        brick_fuse_rows, brick_fuse_rows_reference, group_centre_pixels)
    from tracking_sdf_tpu_torch.fusion.brickmajor import (
        classify_compact_rows, empty_brick_grid, fuse_frame_brickmajor)
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    cfg = path_config(name, None)
    f, p = cfg.fusion, cfg.grid
    bs = f.brick_shape
    frames = [preprocess_frame(render_scene_depth(scene, cam, poses[k]), cam=cam,
                               bilateral=cfg.bilateral_filter,
                               bilateral_mode=cfg.bilateral_mode) for k in (0, 1)]
    bg = empty_brick_grid(p, bs, device=dev, value_dtype=torch.bfloat16,
                          weight_dtype=torch.bfloat16)
    fuse_frame_brickmajor(bg, poses[0], *frames[0], rgb, params=p, cam=cam, cfg=f, bs=bs,
                          cap=f.brick_cap, cap_free=f.brick_cap_free)
    pts, nrm = frames[1]
    pose, hw = poses[1], tuple(pts.shape[:2])
    pix = _pixel_table(pts, nrm, rgb, True, f.distance)
    NB, BV = bg.D.shape
    s, per = p.m // n, NB // n
    cap, cap_free = max(256, f.brick_cap // n), max(256, f.brick_cap_free // n)
    kw = dict(hw=hw, params=p, cam=cam, cfg=f, bs=bs)
    differ, nan_ok, err, union = 0, True, 0.0, []
    rec = None
    for r in range(n):
        sl = slice(r * per, (r + 1) * per)
        slab_kw = dict(i_offset=r * s, **kw)
        ids, _ = classify_compact_rows(p, pose, pts, nrm, cam=cam, cfg=f, bs=bs, cap=cap,
                                       cap_free=cap_free, nbi=s // bs[0], i_offset=r * s)
        lk = [x[sl].clone() for x in (bg.D, bg.W, bg.C)]
        lr = [x.clone() for x in lk]
        brick_fuse_rows(*lk, ids, pix, pose, cap=cap, nbi=s // bs[0], **slab_kw)
        brick_fuse_rows_reference(*lr, ids, pix, pose, cap=cap, **slab_kw)
        torch.cuda.synchronize()
        nan_ok = nan_ok and all(torch.equal(torch.isnan(a), torch.isnan(b))
                                for a, b in zip(lk[:2], lr[:2]))
        differ += sum(int((a[~torch.isnan(b)].view(torch.int16)
                           != b[~torch.isnan(b)].view(torch.int16)).sum())
                      for a, b in zip(lk[:2], lr[:2])) + int((lk[2] != lr[2]).sum())
        err = max([err] + [float(torch.nan_to_num(a.float() - b.float()).abs().max())
                           for a, b in zip(lk[:2], lr[:2])])
        if r == 0:
            n_full, n_free = int((ids[:cap] < per).sum()), int((ids[cap:] < per).sum())
            full_rows = ids[:cap][ids[:cap] < per]
            n_pix = int(torch.unique(group_centre_pixels(full_rows, pose, params=p, cam=cam,
                                                         cfg=f, bs=bs, hw=hw,
                                                         i_offset=0)).numel())

            def kernel():
                brick_fuse_rows(*lk, ids, pix, pose, cap=cap, nbi=s // bs[0], **slab_kw)

            ms = events_ms(kernel)
            device_ms = kernel_device_ms(kernel, ("brick_fuse_rows_kernel",))
            wrapper_ms = cuda_time_ms(kernel)
            plain_ms = cuda_time_ms(lambda: brick_fuse_rows_reference(
                *lr, ids, pix, pose, cap=cap, **slab_kw))
            row = BV * 8
            bms, by = bound(n_full * (row + BV * 16) + n_free * row
                            + n_pix * pix.shape[1] * 4 + ids.numel() * 4 + 48)
            rec = dict(ms=ms, device_ms=device_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by, n_full=n_full, n_free=n_free,
                       centre_pixels=n_pix, cap=cap, cap_free=cap_free)
        # the union with caps that bind nowhere
        ids_all, _ = classify_compact_rows(p, pose, pts, nrm, cam=cam, cfg=f, bs=bs,
                                           cap=per, cap_free=per, nbi=s // bs[0],
                                           i_offset=r * s)
        part = [x[sl].clone() for x in (bg.D, bg.W, bg.C)]
        brick_fuse_rows(*part, ids_all, pix, pose, cap=per, nbi=s // bs[0], **slab_kw)
        union.append(part)
        del lk, lr
    ids_one, _ = classify_compact_rows(p, pose, pts, nrm, cam=cam, cfg=f, bs=bs, cap=NB,
                                       cap_free=NB)
    one = [x.clone() for x in (bg.D, bg.W, bg.C)]
    brick_fuse_rows(*one, ids_one, pix, pose, cap=NB, **kw)
    torch.cuda.synchronize()
    union_differ = sum(int((torch.cat([u[c] for u in union]).view(torch.int16)
                            != one[c].view(torch.int16)).sum()) for c in range(3))
    label = f"K2 brick_fuse_rows slab form ({name}, {n} slabs, color)"
    print(f"{label}: caps per rank {cap} / {cap_free}; {differ} stored values differ from "
          f"the plain version (tol 0), NaN masks equal {nan_ok}, max abs err {err:.3e}; "
          f"slabs' rows vs the whole-grid kernel with no cap binding: {union_differ} "
          f"16-bit lanes differ; slab 0: kernel {rec['ms']:.4f} ms ({TIMED_LAUNCHES} "
          f"back-to-back), device {rec['device_ms']} ms, wrapper {rec['wrapper_ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms "
          f"({rec['bound_by']}; {rec['n_full']} FULL, {rec['n_free']} FREE)")
    check(differ == 0 and nan_ok, f"{label} disagrees with its plain version")
    check(union_differ == 0, f"{label}: the slabs' rows differ from the whole grid's")
    del bg, one, union
    torch.cuda.empty_cache()
    return dict(rec, max_abs_err=err)


def nccl_device_ms(fn):
    """(device ms of the NCCL kernels, of all device ops, the device ops) of
    one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    nccl = sum(e.self_device_time_total for e in ev if "nccl" in e.key.lower())
    return (nccl / 1e3, sum(e.self_device_time_total for e in ev) / 1e3,
            sum(e.count for e in ev))


def one_rank_mesh(cam, depths, poses, rgb, dev, work, mesh):
    """The one-rank NCCL group ``mesh`` on the card: tum256 per frame and
    chunked through Reconstruction(mesh=...), the launch counts set to 0
    just before and read just after; chunked equal to per frame bit for
    bit."""
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    name = "tum256"
    n = SHARDED_TRACKED[name] + 1
    cfg = path_config(name, os.path.join(work, "mesh1.txt"))
    recon = Reconstruction(cam, cfg, initial_pose=poses[0], mesh=mesh)
    torch.cuda.synchronize()
    reset_counters()
    c0, s0 = mesh.collectives, mesh.collective_s
    wall, per_frame = [], []
    for k in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = recon.process_frame(depths[k], rgb=rgb, timestamp=float(k))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        per_frame.append((recon.pose.R.clone(), recon.pose.t.clone()))
        check(not st.rejected, f"one-rank mesh: frame {k} rejected")
    launches = counters()
    collectives = (mesh.collectives - c0) / n
    coll_ms = (mesh.collective_s - s0) * 1e3 / n
    rows = [x.clone() for x in (recon.brick_grid.D, recon.brick_grid.W, recon.brick_grid.C)]
    recon.close()
    with open(os.path.join(work, "mesh1.txt")) as f:
        traj = f.read()
    # one more frame, profiled (not part of the run compared below)
    nccl_ms, dev_ms, dev_ops = nccl_device_ms(lambda: recon.process_frame(
        depths[n - 1], rgb=rgb, timestamp=float(n)))
    t_err = (per_frame[-1][1] - poses[n - 1].t).norm().item() * 1e3
    del recon

    chunks = (4, 3, 3)
    ch = Reconstruction(cam, dataclasses.replace(cfg, trajectory_path=os.path.join(
        work, "mesh1_chunk.txt")), initial_pose=poses[0], mesh=mesh)
    ch.process_frame(depths[0], rgb=rgb, timestamp=0.0)
    torch.cuda.synchronize()
    reset_counters()
    k, chunk_ms, same = 1, [], True
    stack = torch.stack(depths[1:n])
    rgbs = rgb.expand(n - 1, *rgb.shape)
    for size in chunks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ch.process_chunk(stack[k - 1:k - 1 + size], rgbs[k - 1:k - 1 + size],
                         timestamps=[float(i) for i in range(k, k + size)])
        chunk_ms.append((time.perf_counter() - t0) * 1e3 / size)
        R, t = per_frame[k + size - 1]
        same = same and torch.equal(ch.pose.R, R) and torch.equal(ch.pose.t, t)
        k += size
    chunk_launches = counters()
    same = same and all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                        for a, b in zip((ch.brick_grid.D, ch.brick_grid.W, ch.brick_grid.C),
                                        rows))
    ch.close()
    with open(os.path.join(work, "mesh1_chunk.txt")) as f:
        same = same and f.read() == traj
    # two more chunks of 3 whose shapes and color phases the chunks above
    # calibrated already: one timed (replays and the read), one profiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ch.process_chunk(stack[:3], rgbs[:3], timestamps=[100.0, 101.0, 102.0])
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3 / 3
    replay_nccl_ms, replay_dev_ms, replay_ops = nccl_device_ms(lambda: ch.process_chunk(
        stack[:3], rgbs[:3], timestamps=[103.0, 104.0, 105.0]))
    del ch
    voxel_mm = cfg.grid.width / cfg.grid.m * 1e3
    ref = JAX_SHARDED_T_ERR_MM[name]
    tracked = n - 1
    per_tracked = {k: v / tracked for k, v in launches.items() if v}
    print(f"one-rank NCCL mesh ({name}): launches a tracked frame by counter "
          f"{per_tracked} (K2 over {n} fused frames); a profiled frame {dev_ops} device ops "
          f"for {dev_ms:.4f} device ms; a replayed chunk {replay_ops / 3:.1f} device ops "
          f"and {replay_dev_ms / 3:.4f} device ms a frame")
    print(f"one-rank NCCL mesh ({name}, {tracked} tracked frames): per frame median "
          f"{statistics.median(wall[1:]):.2f} ms/frame, chunked {chunk_ms} ms/frame "
          f"(chunks {chunks}, each with its phase calibration), a calibrated chunk of 3 "
          f"{replay_ms:.2f} ms/frame; chunked == per frame bit for bit {same}; |t err| "
          f"{t_err:.2f} mm vs the JAX package's sharded {ref} mm (+-{0.5 * voxel_mm:.2f}); "
          f"collectives {collectives:.1f} a frame, host {coll_ms:.3f} ms a frame; NCCL "
          f"kernels {nccl_ms:.4f} of {dev_ms:.4f} device ms in a frame, "
          f"{replay_nccl_ms:.4f} of {replay_dev_ms:.4f} in a replayed chunk of 3; "
          f"launches per frame {launches}, chunked {chunk_launches}")
    per_step = cfg.tracking.max_iterations
    check(same, "one-rank mesh: the chunked run differs from the per-frame run")
    check(abs(t_err - ref) <= 0.5 * voxel_mm,
          f"one-rank mesh: |t err| {t_err:.2f} mm not within half a voxel of {ref} mm")
    for got in (launches, chunk_launches):
        check(got["gn_reduce_slab_brick"] == per_step * tracked
              and got["gn_finish"] == per_step * tracked
              and got["brick_fuse_rows_slab"] == tracked + (got is launches)
              and got["gn_step_brick"] == 0 and got["brick_fuse_rows"] == 0,
              f"one-rank mesh: expected the slab forms ({per_step} K1 slab reduces and "
              f"gn_finish launches a tracked frame, K2 once a fused frame) and no "
              f"single-device form: {got}")
    check_preprocess("one-rank mesh per frame", launches, n, filter_mode(cfg))
    check_preprocess("one-rank mesh chunked", chunk_launches, tracked, filter_mode(cfg))
    check_classify("one-rank mesh per frame", launches, cfg)
    check_classify("one-rank mesh chunked", chunk_launches, cfg)
    return dict(final_pose=per_frame[-1],
                ms_per_frame=statistics.median(wall[1:]), chunk_ms=chunk_ms,
                replay_ms_per_frame=replay_ms,
                t_err_mm=t_err, collectives_per_frame=collectives,
                collective_host_ms=coll_ms, nccl_device_ms=nccl_ms,
                frame_device_ms=dev_ms, frame_device_ops=dev_ops,
                replay_nccl_ms=replay_nccl_ms, replay_device_ms=replay_dev_ms,
                replay_device_ops_per_frame=replay_ops / 3,
                launches_per_tracked_frame=per_tracked, tracked=tracked, fused=tracked + 1,
                launches={k: launches[k] + chunk_launches[k] for k in launches},
                rows=rows)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _group(argvs, label):
    """Start one process per argv (the ranks), wait for all; their stdout."""
    env = dict(os.environ, OMP_NUM_THREADS="4")
    procs = [subprocess.Popen(a, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for a in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GROUP_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{label}: rank {r} exited with {p.returncode}:\n"
              f"{err[-3000:]}")
    return [out for out, _ in outs]


def two_rank_group(cam, depths, poses, rgb, dev, work, one_rank):
    """Two processes sharing the card in a Gloo group (the worker module):
    tum256 (10 tracked frames, then a 640x480 render, the mesh and a
    checkpoint) and tum512 (5 tracked frames)."""
    import numpy as np

    from tracking_sdf_tpu_torch.fusion.brickmajor import (
        BrickGrid, dense_from_brick_grid, storage_dtype)
    from tracking_sdf_tpu_torch.render.marching_cubes import marching_cubes

    n = SHARDED_TRACKED["tum256"] + 1
    inputs = os.path.join(work, "group_in.npz")
    np.savez(inputs, depths=torch.stack(depths[:n]).cpu().numpy(),
             rgbs=rgb.expand(n, *rgb.shape).cpu().numpy(),
             poses_R=torch.stack([p.R for p in poses[:n]]).cpu().numpy(),
             poses_t=torch.stack([p.t for p in poses[:n]]).cpu().numpy())
    runs = [dict(name="tum256", config=dict(preset="tum256"), frames=n,
                 render=dict(stride=1, with_color=True), mesh=True, checkpoint=True),
            dict(name="tum512", config=dict(preset="tum512"),
                 frames=SHARDED_TRACKED["tum512"] + 1)]
    spec = dict(coordinator=f"localhost:{_free_port()}", ranks=2, device="cuda", out=work,
                inputs=inputs, cam=cam._asdict(), runs=runs, threads=4)
    path = os.path.join(work, "group.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    _group([[sys.executable, "-m", "tracking_sdf_tpu_torch.parallel.worker", path, str(r)]
            for r in range(2)], "two-rank group")
    wall_s = time.perf_counter() - t0
    out = {}
    for name in ("tum256", "tum512"):
        a, b = (np.load(os.path.join(work, f"{name}_{r}.npz")) for r in range(2))
        with open(os.path.join(work, f"{name}_traj_0.txt")) as f0, open(
                os.path.join(work, f"{name}_traj_1.txt")) as f1:
            same_traj = f0.read() == f1.read()
        same = same_traj and all(np.array_equal(a[k], b[k])
                                 for k in ("pose_R", "pose_t", "num_valid", "iterations"))
        p = path_config(name, None).grid
        voxel_mm = p.width / p.m * 1e3
        tr = SHARDED_TRACKED[name]
        t_err = float(np.linalg.norm(a["pose_t"] - poses[tr].t.cpu().numpy())) * 1e3
        ref = JAX_SHARDED_T_ERR_MM[name]
        rec = dict(ms_per_frame=[float(np.median(x["ms_per_frame"][1:])) for x in (a, b)],
                   t_err_mm=t_err, collectives_per_frame=int(a["collectives"]) / (tr + 1),
                   collective_host_ms=float(a["collective_s"]) * 1e3 / (tr + 1),
                   overflow=int(a["overflow"]))
        print(f"two-rank Gloo group ({name}, {tr} tracked frames, both ranks on the card): "
              f"ranks' poses and trajectories identical {same}; median ms/frame per rank "
              f"{rec['ms_per_frame']}; |t err| {t_err:.2f} mm vs the JAX package's sharded "
              f"{ref} mm (+-{0.5 * voxel_mm:.2f}); collectives "
              f"{rec['collectives_per_frame']:.1f} a frame, host {rec['collective_host_ms']:.3f} "
              f"ms a frame; bricks dropped {rec['overflow']}")
        check(same, f"two-rank group ({name}): the ranks disagree")
        check(not a["rejected"].any(), f"two-rank group ({name}): a frame was rejected")
        for r, x in enumerate((a, b)):
            check_preprocess(f"two-rank group ({name}) rank {r}",
                             dict(zip(PREPROCESS_COUNTERS, x["preprocess_launches"].tolist())),
                             tr + 1, filter_mode(path_config(name, None)))
            check_classify(f"two-rank group ({name}) rank {r}",
                           dict(zip(CLASSIFY_COUNTERS, x["classify_launches"].tolist())),
                           path_config(name, None), tr + 1)
        check(abs(t_err - ref) <= 0.5 * voxel_mm,
              f"two-rank group ({name}): |t err| {t_err:.2f} mm not within half a voxel of "
              f"{ref} mm")
        if name == "tum256":
            R1, t1 = (x.cpu().numpy() for x in one_rank["final_pose"])
            dpose = max(float(np.abs(a["pose_t"] - t1).max()),
                        float(np.abs(a["pose_R"] - R1).max()))
            f = path_config(name, None).fusion
            rows = BrickGrid(  # the worker wrote D and W as float32, exactly
                D=torch.from_numpy(a["D"]).to(dev, storage_dtype(f.storage_dtype)),
                W=torch.from_numpy(a["W"]).to(dev, storage_dtype(f.weight_dtype)),
                C=torch.from_numpy(a["C"].view(np.int16)).to(dev))
            D1, W1 = (x.float() for x in one_rank["rows"][:2])
            eW = (rows.W.float() - W1).abs()
            obs = (W1 > 0) & (rows.W.float() > 0)
            eD = (rows.D.float() - D1)[obs].abs()
            dW, dD = float(eW.max()), float(eD.max())
            print(f"  against the one-rank run: pose {dpose:.3e} (tol {RANK_POSE_TOL}), W "
                  f"{dW:.3e} (tol {RANK_W_TOL}; {int((eW > RANK_W_TOL).sum())} of "
                  f"{eW.numel()} voxels past it), D on observed voxels {dD:.3e} (tol "
                  f"{RANK_D_TOL}; {int((eD > RANK_D_TOL).sum())} of {eD.numel()} past it)")
            w_past = int((eW > RANK_W_TOL).sum())
            check(dpose <= RANK_POSE_TOL and w_past <= RANK_W_SHARE * eW.numel()
                  and dD <= RANK_D_TOL,
                  "two-rank group: the gathered rows or the pose differ from the one-rank run")
            grid = dense_from_brick_grid(rows, p, f.brick_shape)
            ref_mesh = marching_cubes(grid, params=p, with_colors=True)
            tris = np.concatenate([a["tris"], b["tris"]])
            cols = np.concatenate([a["cols"], b["cols"]])
            mesh_same = (tris.shape == ref_mesh.vertices.shape
                         and np.array_equal(tris, ref_mesh.vertices)
                         and np.array_equal(cols, ref_mesh.colors))
            print(f"  render 640x480 (sharded over the ranks, color): "
                  f"{[float(x['render_ms']) for x in (a, b)]} ms, bitwise the single-device "
                  f"render of the gathered grid {[bool(x['render_equal']) for x in (a, b)]}, "
                  f"hits {int(a['render_hits'])}, dropped {int(a['render_dropped'])}; mesh "
                  f"{[float(x['mesh_ms']) for x in (a, b)]} ms, {tris.shape[0]} triangles "
                  f"(rank 0 {a['tris'].shape[0]}), equal to marching_cubes of the gathered "
                  f"grid {mesh_same}; checkpoint restored bitwise into the group "
                  f"{[bool(x['restore_equal']) for x in (a, b)]} and into one device "
                  f"{bool(a['restore_single_equal'])}")
            check(bool(a["render_equal"]) and bool(b["render_equal"]),
                  "two-rank group: the sharded render differs from the single-device one")
            check(mesh_same, "two-rank group: the sharded mesh differs")
            check(bool(a["restore_equal"]) and bool(b["restore_equal"])
                  and bool(a["restore_single_equal"]), "two-rank group: checkpoint restore")
            rec.update(render_ms=[float(x["render_ms"]) for x in (a, b)],
                       mesh_ms=[float(x["mesh_ms"]) for x in (a, b)],
                       triangles=int(tris.shape[0]), pose_diff=dpose, W_diff=dW, D_diff=dD,
                       W_voxels_past=w_past)
            out["rows256"] = rows
            del grid
        out[name] = rec
    out["wall_s"] = wall_s
    torch.cuda.empty_cache()
    return out


def checkpoint_into_one_rank(cam, poses, mesh, work, rows):
    """The group's checkpoint restored into a one-rank mesh: its rows equal
    the group's gathered rows bit for bit (every NaN alike)."""
    from tracking_sdf_tpu_torch.parallel.worker import same_bits
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    r = Reconstruction(cam, path_config("tum256", None), initial_pose=poses[0], mesh=mesh)
    r.restore_checkpoint(os.path.join(work, "tum256_ckpt"))
    same = all(same_bits(getattr(r.brick_grid, k), getattr(rows, k)) for k in "DWC")
    print(f"  the group's checkpoint restored into the one-rank mesh: rows equal {same}")
    check(same, "the group's checkpoint does not restore into a one-rank mesh bitwise")
    del r


def cli_group(work):
    """The CLI as a two-rank group on phase 7's 120 frames, chunked, then
    --realtime 30: identical trajectories (and drops) on both ranks."""
    root = os.path.join(work, "seq")
    loader = ["--native-loader"] if zlib_header_present() else []
    out = {}
    for label, extra in (("chunked", ["--chunk", str(DATASET_CHUNK)]),
                         ("realtime", ["--realtime", "30"])):
        port = _free_port()
        trajs = [os.path.join(work, f"cli_{label}_{r}.txt") for r in range(2)]
        argvs = [[sys.executable, "-m", "tracking_sdf_tpu_torch.cli", "--multihost",
                  "--coordinator", f"localhost:{port}", "--num-processes", "2",
                  "--process-id", str(r), "--distributed", "--preset", "tum256",
                  "--dataset", root, *loader, *extra, "--eval", "--json",
                  "--trajectory", trajs[r]] for r in range(2)]
        summaries = [json.loads(o.strip().splitlines()[-1])
                     for o in _group(argvs, f"cli group {label}")]
        with open(trajs[0]) as a, open(trajs[1]) as b:
            same = a.read() == b.read()
        s0, s1 = summaries
        ate = s0["ate_rmse_m"] * 1e3
        rec = dict(ate_mm=ate, steady_ms=[s["steady_ms"] for s in summaries],
                   run_s=[s["run_s"] for s in summaries], frames=s0["frames"],
                   collectives_per_frame=s0["collectives"] / s0["frames"],
                   collective_host_ms=s0["collective_s"] * 1e3 / s0["frames"])
        if label == "realtime":
            rec.update(dropped=[s["realtime_dropped"] for s in summaries],
                       yielded=[s["realtime_yielded"] for s in summaries])
        print(f"cli two-rank group {label} (tum256, {s0['frames']:.0f} frames): "
              f"trajectories byte-identical {same}, ATE {ate:.4f} mm (rank 1 "
              f"{s1['ate_rmse_m'] * 1e3:.4f}), steady ms/frame per rank {rec['steady_ms']}, "
              f"run s {rec['run_s']}, collectives {rec['collectives_per_frame']:.1f} a frame, "
              f"host {rec['collective_host_ms']:.3f} ms a frame"
              + (f", dropped {rec['dropped']}, yielded {rec['yielded']}"
                 if label == "realtime" else ""))
        check(same, f"cli group {label}: the ranks' trajectories differ")
        if label == "chunked":
            p = path_config("tum256", None).grid
            voxel_mm = p.width / p.m * 1e3
            ref = JAX_SHARDED_ATE_MM["tum256"]
            check(s0["frames"] == DATASET_FRAMES and s0["ate_pairs"] == DATASET_FRAMES,
                  f"cli group: {s0}")
            if ref is not None:
                print(f"  ATE vs the JAX package's sharded {ref} mm (+-{0.5 * voxel_mm:.2f})")
                check(abs(ate - ref) <= 0.5 * voxel_mm,
                      f"cli group: ATE {ate:.2f} mm not within half a voxel of {ref} mm")
        else:
            check(s0["realtime_dropped"] == s1["realtime_dropped"]
                  and s0["realtime_yielded"] == s1["realtime_yielded"]
                  and s0["realtime_yielded"] + s0["realtime_dropped"] == DATASET_FRAMES,
                  f"cli group realtime: the ranks' drops differ: {summaries}")
        out[label] = rec
    return out


def multi_device_phase(cam, scene, depths, poses, rgb, dev, work):
    """Phase 10; returns (its record, the slab forms' kernel records, the
    one-rank mesh's main path record: launches, tracked and fused frames
    of its per-frame and chunked runs)."""
    import torch.distributed as dist

    from tracking_sdf_tpu_torch.parallel.mesh import init_group, make_mesh

    mode = compute_mode()
    print(f"phase 10: multi-device on {gpu_line()}, compute mode {mode}")
    mesh = make_mesh(device=init_group(device=dev))
    try:
        k1, finish = k1_slab_phase(cam, scene, poses, rgb, dev, mesh)
        k2 = {name: k2_slab_compare(name, cam, scene, poses, rgb, dev)
              for name in ("tum256", "tum512")}
        if mode != "Default":
            print(f"  two ranks on one card need compute mode Default; this card's is {mode}")
        one = one_rank_mesh(cam, depths, poses, rgb, dev, work, mesh)
        ref = dict(rows=one.pop("rows"), final_pose=one.pop("final_pose"))
        group = two_rank_group(cam, depths, poses, rgb, dev, work, ref)
        del ref
        checkpoint_into_one_rank(cam, poses, mesh, work, group.pop("rows256"))
        cli = cli_group(work)
    finally:
        dist.destroy_process_group()
    launches = one.pop("launches")
    path = dict(launches=launches, tracked=2 * one["tracked"], fused=2 * one["tracked"] + 1,
                processed=2 * one["tracked"] + 1)
    record = dict(compute_mode=mode, one_rank=one, group=group, cli=cli)
    return record, dict(k1=k1, k2=k2, finish=finish), path


# --- phase 11: packed, --debug-nans and the library surface --------------------

# tools/jax_reference_figures.py tum256_packed (JAX 0.9.0 on the CPU): --preset
# tum256 --fusion-mode packed per frame over the 120 generated frames. Its
# tum512 figure holds a 3.2 GB float32 grid and XLA's copies of it, and was
# not run on a CPU.
JAX_PACKED_ATE_MM = {"tum256": 9.9156}
PACKED_ATE_TOL_MM = 0.03
INJECT_FRAME = 3  # the frame (as FrameStats.index counts) that the injected NaN lands in


def packed_config(name, trajectory_path=None):
    """The preset with fusion.mode="packed", as the runner maps it on one
    device (float32 rows, flat classification)."""
    from tracking_sdf_tpu_torch.pipeline.runner import packed_fusion_config

    cfg = path_config(name, trajectory_path)
    return packed_fusion_config(dataclasses.replace(
        cfg, fusion=cfg.fusion._replace(mode="packed")))


def kernel_gn_f32(cam, scene, poses, rgb, dev):
    """K1's step on float32 brick rows (packed's), fused from the first
    frame and queried with the second, as phase 3 holds the bf16 form."""
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.fusion.brickmajor import empty_brick_grid, fuse_frame_brickmajor
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    cfg = packed_config("tum256")
    f = cfg.fusion
    pts0, nrm0 = preprocess_frame(render_scene_depth(scene, cam, poses[0]), cam=cam,
                                  bilateral_mode=cfg.bilateral_mode)
    pts1, _ = preprocess_frame(render_scene_depth(scene, cam, poses[1]), cam=cam,
                               bilateral_mode=cfg.bilateral_mode)
    bg = empty_brick_grid(cfg.grid, f.brick_shape, device=dev)
    _, view, _ = fuse_frame_brickmajor(bg, poses[0], pts0, nrm0, rgb, params=cfg.grid,
                                       cam=cam, cfg=f, bs=f.brick_shape, cap=f.brick_cap,
                                       cap_free=f.brick_cap_free)
    check(view.rows.dtype == torch.float32, "the packed view is not float32")
    rec = step_compare("K1 gn_step (brick-major float32, packed)", view, poses[0], pts1,
                       cfg.grid, cfg.tracking)
    del bg, view
    torch.cuda.empty_cache()
    return rec


def packed_phase(work):
    """tum256 and tum512 with --fusion-mode packed through the CLI per frame
    over phase 7's frames; returns their records for the kernels' line."""
    from tracking_sdf_tpu_torch.config import preset

    root = os.path.join(work, "seq")
    loader = ["--native-loader"] if zlib_header_present() else []
    records = {}
    for name in ("tum256", "tum512"):
        cfg = preset(name)
        mark = memory_mark()
        s, recon, launches, rejected = cli_run(
            f"{name} --fusion-mode packed",
            ["--preset", name, "--dataset", root, "--fusion-mode", "packed", "--trajectory",
             os.path.join(work, f"{name}_packed.txt")] + loader, work)
        peak = peak_gib_above(mark)
        bg = recon.brick_grid
        rows_gb = sum(x.numel() * x.element_size() for x in (bg.D, bg.W, bg.C)) / 1e9
        f = recon.config.fusion
        check(recon.packed and bg.D.dtype == bg.W.dtype == torch.float32
              and f.hier_classify == 0 and recon._sat is None,
              f"{name} packed: rows {bg.D.dtype} / {bg.W.dtype}, hier {f.hier_classify}")
        per_step = ((len(cfg.pyramid_levels) - 1) * COARSE_ITERATIONS
                    + cfg.tracking.max_iterations)
        tracked, fused = DATASET_FRAMES - 1, DATASET_FRAMES - rejected
        ate_mm = s["ate_rmse_m"] * 1e3
        ref = JAX_PACKED_ATE_MM.get(name)
        print(f"  {name} packed: ATE {ate_mm:.4f} mm (JAX package's packed "
              f"{'not computed' if ref is None else format(ref, '.4f') + ' mm'}, bound "
              f"+-{PACKED_ATE_TOL_MM} mm; its bf16 brick-major {JAX_ATE_MM[name]} mm), "
              f"steady {s['steady_ms']:.3f} ms/frame per frame, rows {rows_gb:.3f} GB, "
              f"peak {peak:.3f} GiB above the run's start, dropped bricks "
              f"{s['overflow_drops']:.0f}")
        check(s["frames"] == DATASET_FRAMES and rejected == 0 and s["ate_rmse_m"] < T_ERR_MAX,
              f"{name} packed: {s}")
        check(ref is None or abs(ate_mm - ref) <= PACKED_ATE_TOL_MM,
              f"{name} packed: ATE {ate_mm:.4f} mm is not within {PACKED_ATE_TOL_MM} mm of "
              f"the JAX package's {ref} mm")
        check(launches["gn_step_brick"] == per_step * tracked
              and launches["brick_fuse_rows"] == fused
              and sum(v for k, v in launches.items()
                      if k not in PREPROCESS_COUNTERS + CLASSIFY_COUNTERS)
              == per_step * tracked + fused,
              f"{name} packed: expected gn_step_brick {per_step} per tracked frame, "
              f"brick_fuse_rows once per fused frame and beside preprocessing and "
              f"classification nothing else: {launches}")
        records[f"{name}_packed"] = dict(
            launches=launches, tracked=tracked, fused=fused, processed=s["processed"],
            ate_mm=ate_mm,
            jax_ate_mm=ref, steady_ms=s["steady_ms"], peak_gib=peak, rows_gb=rows_gb)
        del recon, bg
        torch.cuda.empty_cache()
    return records


def debug_nans_cli(work):
    """tum256 through the CLI with --debug-nans, per frame and --chunk 8:
    each trajectory byte for byte phase 7's run without the flag."""
    root = os.path.join(work, "seq")
    loader = ["--native-loader"] if zlib_header_present() else []
    out = {}
    for label, chunk, ref in (("per frame", 0, "pf.txt"),
                              (f"--chunk {DATASET_CHUNK}", DATASET_CHUNK, "tum256.txt")):
        traj = os.path.join(work, f"dn_{chunk}.txt")
        argv = (["--preset", "tum256", "--dataset", root, "--debug-nans", "--trajectory", traj]
                + loader + (["--chunk", str(chunk)] if chunk else []))
        s, recon, _, rejected = cli_run(f"tum256 --debug-nans {label}", argv, work, chunk)
        with open(traj) as a, open(os.path.join(work, ref)) as b:
            same = a.read() == b.read()
        print(f"  tum256 --debug-nans {label}: trajectory byte for byte phase 7's {ref} "
              f"{same}, steady {s['steady_ms']:.3f} ms/frame")
        check(same and rejected == 0, f"--debug-nans {label} changed the run")
        out[label] = dict(same_trajectory=same, steady_ms=s["steady_ms"])
        del recon
    return out


def debug_check_cost(name, cam, scene, poses, rgb, dev):
    """The --debug-nans check of one frame on the preset's rows and the
    second frame's real lists (brickmajor.row_faults and the fault code),
    beside the same check over the whole grid: ms a call (CUDA events) and
    device ms and ops (profiler)."""
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.fusion.brickmajor import (
        classify_compact_rows, empty_brick_grid, fuse_frame_brickmajor, row_faults,
        unpack_color_grid)
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame
    from tracking_sdf_tpu_torch.utils import debug_nans

    cfg = path_config(name, None)
    f, p = cfg.fusion, cfg.grid
    frames = [preprocess_frame(render_scene_depth(scene, cam, poses[k]), cam=cam,
                               bilateral=cfg.bilateral_filter,
                               bilateral_mode=cfg.bilateral_mode) for k in (0, 1)]
    bg = empty_brick_grid(p, f.brick_shape, device=dev, value_dtype=torch.bfloat16,
                          weight_dtype=torch.bfloat16)
    fuse_frame_brickmajor(bg, poses[0], *frames[0], rgb, params=p, cam=cam, cfg=f,
                          bs=f.brick_shape, cap=f.brick_cap, cap_free=f.brick_cap_free)
    ids, _ = classify_compact_rows(p, poses[1], *frames[1], cam=cam, cfg=f, bs=f.brick_shape,
                                   cap=f.brick_cap, cap_free=f.brick_cap_free)

    def rows():
        return debug_nans.fault_code(row_faults(bg, ids, poses[1]))

    def whole():
        return debug_nans.fault_code(torch.cat([
            debug_nans.leaf_faults(bg.D, bg.W, *unpack_color_grid(bg)),
            debug_nans.pose_faults(poses[1])]))

    rec = {}
    for label, fn in (("rows", rows), ("whole grid", whole)):
        check(int(fn()) == 0, f"{name}: the clean rows break an invariant")
        ms = cuda_time_ms(fn)
        dms, ops = all_device_ms(fn)
        rec[label] = dict(ms=ms, device_ms=dms, device_ops=ops)
    n_rows = int((ids < bg.D.shape[0]).sum())
    print(f"--debug-nans check ({name}, {n_rows} listed rows of {bg.D.shape[0]}): rows "
          f"{rec['rows']['ms']:.4f} ms a call, device {rec['rows']['device_ms']:.4f} ms in "
          f"{rec['rows']['device_ops']:.0f} ops; whole grid {rec['whole grid']['ms']:.4f} ms, "
          f"device {rec['whole grid']['device_ms']:.4f} ms in "
          f"{rec['whole grid']['device_ops']:.0f} ops")
    del bg
    torch.cuda.empty_cache()
    return dict(rec, listed_rows=n_rows)


def nan_injector(dev, at):
    """A K2 wrapper for fusion.brickmajor that, on its ``at``-th call since
    ``tick`` was last zeroed, writes NaN into D at the first voxel with
    W > 0 of the rows the frame listed, by device ops only (it runs inside
    captures and replays). Returns (wrapper, tick)."""
    from tracking_sdf_tpu_torch.fusion import brickmajor as tbm

    real = tbm.brick_fuse_rows
    tick = torch.zeros((), dtype=torch.int64, device=dev)

    def poisoned(D, W, C, ids, pix, pose, **kw):
        real(D, W, C, ids, pix, pose, **kw)
        tick.add_(1)
        NB, BV = D.shape
        rows = ids.clamp(max=NB - 1).long()  # a frame that lists nothing pads with NB
        w = (W[rows] * (ids < NB)[:, None]).reshape(-1)
        j = torch.argmax((w > 0).to(torch.int32)).reshape(1)  # no host read
        flat = rows.gather(0, j // BV) * BV + j % BV
        old = D.view(-1).gather(0, flat)
        # only into a voxel with W > 0: a warm-up's frame lists no row
        hit = (tick == at) & (w.gather(0, j) > 0)
        D.view(-1).scatter_(0, flat, torch.where(hit, torch.full_like(old, float("nan")),
                                                 old))

    return poisoned, tick


def debug_injection(cam, depths, poses, rgb, dev, mesh=None):
    """A NaN written into a listed row where W > 0 at frame INJECT_FRAME:
    per frame and chunked (frame 0, then one chunk of 4), tum256 on one
    device or on ``mesh``; each must raise FloatingPointError naming it."""
    from tracking_sdf_tpu_torch.fusion import brickmajor as tbm
    from tracking_sdf_tpu_torch.pipeline import chunk as chunked
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
    from tracking_sdf_tpu_torch.utils import debug_nans

    where = "a one-rank NCCL group" if mesh is not None else "one device"
    cfg = path_config("tum256", None)
    real_fuse, real_replay = tbm.brick_fuse_rows, chunked.ChunkSteps.replay
    out = {}
    for mode in ("per frame", "chunked"):
        poisoned, tick = nan_injector(dev, INJECT_FRAME if mode == "per frame"
                                      else INJECT_FRAME - 1)

        def replay(self, *a, **k):
            tick.zero_()  # the warm-up and the capture ran the step too
            return real_replay(self, *a, **k)

        kw = dict(mesh=mesh) if mesh is not None else dict(device=dev)
        recon = Reconstruction(cam, cfg, initial_pose=poses[0], **kw)
        recon.chunk_phase_metrics = False
        tbm.brick_fuse_rows, chunked.ChunkSteps.replay = poisoned, replay
        msg = None
        try:
            with debug_nans.switch():
                recon.process_frame(depths[0], rgb=rgb, timestamp=0.0)
                if mode == "per frame":
                    for k in range(1, 5):
                        recon.process_frame(depths[k], rgb=rgb, timestamp=float(k))
                else:
                    recon.process_chunk(torch.stack(depths[1:5]),
                                        rgb.expand(4, *rgb.shape))
        except FloatingPointError as e:
            msg = str(e)
        finally:
            tbm.brick_fuse_rows, chunked.ChunkSteps.replay = real_fuse, real_replay
        print(f"--debug-nans, a NaN injected at frame {INJECT_FRAME} ({mode}, {where}): "
              f"{msg}")
        check(msg is not None and f"frame {INJECT_FRAME}" in msg and "NaN in D" in msg,
              f"--debug-nans ({mode}, {where}): the injected NaN raised {msg!r}")
        out[mode] = msg
        del recon
    return out


def library_example(work):
    """The JAX README's library example with the port's package name and no
    device=, on 3 frames of phase 7's sequence, in ``work`` (the preset
    writes trajectory.txt into the working directory)."""
    import itertools

    from tracking_sdf_tpu_torch.config import preset
    from tracking_sdf_tpu_torch.core.camera import tum_fr1_camera
    from tracking_sdf_tpu_torch.data.tum import TUMDataset
    from tracking_sdf_tpu_torch.pipeline import Reconstruction

    dataset = itertools.islice(TUMDataset(os.path.join(work, "seq")), 3)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        recon = Reconstruction(tum_fr1_camera(), preset("tum256"))
        for frame in dataset:
            recon.process_frame(frame.depth, frame.rgb, timestamp=frame.timestamp)
        render = recon.render()
        n_tri = recon.export_mesh("scene.ply")
        recon.close()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    hit = float(render.hit.float().mean())
    print(f"library example on {recon.device}: {recon.frame_num} frames, render "
          f"{tuple(render.depth.shape)} with {hit:.3f} hits, mesh {n_tri} triangles, "
          f"{wall_s:.2f} s")
    check(recon.device.type == "cuda" and recon.frame_num == 3
          and not any(s.rejected for s in recon.stats) and hit > 0.1 and n_tri > 1000,
          "the library example did not run on the card")
    return dict(device=str(recon.device), frames=recon.frame_num, hit_share=hit,
                triangles=n_tri, wall_s=wall_s)


def surface_phase(cam, scene, depths, poses, rgb, dev, work):
    """Phase 11; returns (its record, the float32 kernels' records, the
    packed runs' records for the kernels' line)."""
    import torch.distributed as dist

    from tracking_sdf_tpu_torch.parallel.mesh import init_group, make_mesh

    print(f"phase 11: packed, --debug-nans and the library surface on {gpu_line()}")
    k1 = kernel_gn_f32(cam, scene, poses, rgb, dev)
    k2 = {name: fuse_rows_compare(name, cam, scene, poses, rgb, dev, cfg=packed_config(name))
          for name in ("tum256", "tum512")}
    paths = packed_phase(work)
    record = {"packed": {k: {x: v for x, v in r.items() if x != "launches"}
                         for k, r in paths.items()}}
    record["debug_nans"] = dict(
        cli=debug_nans_cli(work),
        check={name: debug_check_cost(name, cam, scene, poses, rgb, dev)
               for name in ("tum256", "tum512")},
        injected=debug_injection(cam, depths, poses, rgb, dev))
    mesh = make_mesh(device=init_group(device=dev))
    try:
        record["debug_nans"]["injected_one_rank_nccl"] = debug_injection(
            cam, depths, poses, rgb, dev, mesh=mesh)
    finally:
        dist.destroy_process_group()
    record["library_example"] = library_example(work)
    return record, dict(k1=k1, k2=k2), paths


# --- phase 12: depth preprocessing (K3, K4) -----------------------------------

# K3's and K4's tolerance: every value equals its plain version's bit for bit
# (the kernels round as the plain ops do); the largest error is printed beside
# float operations: a K3 tap with a finite neighbour (difference, square,
# scale, expf counted as one, spatial weight, w*d, two sums); a K4 pixel
# (backprojection 6, two tangents and their tests 19, the box over 8
# channels in two passes of 9 adds 144, means 6, cross 9, norm 6,
# normalisation 3, orientation 5)
K3_FLOP_PER_TAP = 8
K4_FLOP_PER_PIXEL = 198
MUFU_EX2_PER_CLOCK_SM = 16  # H100: the special-function units' rate, per SM
PREPROCESS_TPU = {  # the JAX functions each kernel replaces (no Pallas original)
    "bilateral_pass": "tracking_sdf_tpu/tracking/preprocess.py:82",
    "bilateral_2d": "tracking_sdf_tpu/tracking/preprocess.py:37",
    "normals": "tracking_sdf_tpu/tracking/preprocess.py:124"}
# K3's separable filter (two launches of a one-pixel-a-thread pass) and K4
# before their redesign: device ms at 640x480 on the scene's second frame
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md's kernel table), printed beside
# this run's, never put in a record
PREPROCESS_DEVICE_MS_FIRST = {"bilateral_pass": 2 * 0.00819, "normals": 0.02145}


def speckled(depth, seed):
    """``depth`` with NaN speckle, zero and negative depth and an all-NaN row."""
    gen = torch.Generator(device=depth.device).manual_seed(seed)
    d = depth + 0.004 * torch.randn(depth.shape, generator=gen, device=depth.device)
    u = torch.rand(depth.shape, generator=gen, device=depth.device)
    d = torch.where(u < 0.05, float("nan"), d)
    d = torch.where((u >= 0.05) & (u < 0.06), 0.0, d)
    d = torch.where((u >= 0.06) & (u < 0.07), -1.0, d)
    d[200] = float("nan")
    return d.contiguous()


def image_compare(got, want):
    """(max abs err where both are finite, pixels whose NaN mask differs,
    finite values that differ bit for bit)."""
    ng, nw = torch.isnan(got), torch.isnan(want)
    both = ~ng & ~nw
    err = float((got - want)[both].abs().max()) if bool(both.any()) else 0.0
    bits = int((got[both].view(torch.int32) != want[both].view(torch.int32)).sum())
    if got.dim() == 3:
        ng, nw = ng.any(-1), nw.any(-1)
    return err, int((ng != nw).sum()), bits


def finite_taps(img, radius, axes):
    """Taps with a finite centre and a finite neighbour inside the image, for
    a 1-D pass along ``axes[0]`` or the 2-D window (``axes`` (0, 1))."""
    from tracking_sdf_tpu_torch.tracking.preprocess import _shifted

    fin = torch.isfinite(img)
    offs = range(-radius, radius + 1)
    shifts = ([(d, 0) if axes[0] == 0 else (0, d) for d in offs] if len(axes) == 1
              else [(dy, dx) for dy in offs for dx in offs])
    return sum(int((fin & _shifted(fin, dy, dx, False)).sum()) for dy, dx in shifts)


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    top, now = (float(x) for x in out.split(","))
    print(f"  SM clock now {now:g} MHz, maximum {top:g} MHz")
    return top * 1e6


def preprocess_phase(cam, depths):
    """Phase 12: K3 (the separable kernel: the filter in one launch and each
    one-axis mode; the 2-D form) and K4 (from depth and from points) against
    their plain versions at 640x480 on the scene's second frame and on a
    speckled copy, with errors, NaN-mask mismatches and bitwise differences
    (both must be 0); each kernel timed four ways (device from the profiler,
    events over 100 launches, the wrapper, the plain version) beside its
    bound from this run's data, K3's separable launch also beside its one-axis
    modes and its ex2 floor; the whole preprocess_frame, kernels against
    plain, in device ms and ops. Returns {kernel: record} and the whole
    frame's record."""
    from tracking_sdf_tpu_torch.core.camera import backproject
    from tracking_sdf_tpu_torch.tracking import preprocess as pre

    print(f"phase 12: depth preprocessing (K3 bilateral, K4 normals) on {gpu_line()}")
    clean = depths[1].contiguous()
    h, w = clean.shape
    recs = {}
    for label, d in (("scene", clean), ("speckled", speckled(clean, 12))):
        p1_ref = pre.bilateral_pass_reference(d, 0)
        pts, nrm = pre.preprocess_frame(d, cam=cam, bilateral=False)
        pts_ref = backproject(cam, d)
        outs = {
            "bilateral_pass": [("separable", pre.bilateral_filter_separable(d),
                                pre.bilateral_filter_separable_reference(d)),
                               ("axis 0", pre.bilateral_pass(d, 0), p1_ref),
                               ("axis 1", pre.bilateral_pass(p1_ref, 1),
                                pre.bilateral_pass_reference(p1_ref, 1))],
            "bilateral_2d": [("2-D", pre.bilateral_filter(d), pre.bilateral_filter_reference(d))],
            "normals": [("points", pts, pts_ref),
                        ("normals", nrm, pre.estimate_normals_reference(pts_ref)),
                        ("normals from points", pre.estimate_normals(pts_ref),
                         pre.estimate_normals_reference(pts_ref))]}
        torch.cuda.synchronize()
        for name, cases in outs.items():
            rec = recs.setdefault(name, dict(max_abs_err=0.0, nan_mask_mismatch=0,
                                             bits_differ=0))
            for what, got, want in cases:
                err, mism, bits = image_compare(got, want)
                print(f"  {name} {what} ({label}, {w}x{h}): max abs err {err:.3e}, NaN-mask "
                      f"mismatches {mism}, finite values differing bit for bit {bits} "
                      f"(tolerance: none), finite {int(torch.isfinite(got).sum())}")
                check(mism == 0 and bits == 0,
                      f"{name} {what} ({label}) differs from its plain version: {err}, "
                      f"{mism} NaN-mask mismatches, {bits} values differing bit for bit")
                rec.update(max_abs_err=max(rec["max_abs_err"], err),
                           nan_mask_mismatch=rec["nan_mask_mismatch"] + mism,
                           bits_differ=rec["bits_differ"] + bits)

    # times at the main path's shapes: the scene's frame
    d = clean
    p1_ref = pre.bilateral_pass_reference(d, 0)
    pts_ref = backproject(cam, d)
    calls = {
        "bilateral_pass": (lambda: pre.bilateral_filter_separable(d),
                           lambda: pre.bilateral_filter_separable_reference(d),
                           "bilateral_pass_kernel"),
        "bilateral_2d": (lambda: pre.bilateral_filter(d),
                         lambda: pre.bilateral_filter_reference(d), "bilateral_2d_kernel"),
        "normals": (lambda: pre.preprocess_frame(d, cam=cam, bilateral=False),
                    lambda: pre.estimate_normals_reference(backproject(cam, d)),
                    "normals_kernel")}
    taps = {"bilateral_pass": finite_taps(d, 5, (0,)) + finite_taps(p1_ref, 5, (1,)),
            "bilateral_2d": finite_taps(d, 5, (0, 1))}
    px = h * w
    work = {"bilateral_pass": (8 * px, K3_FLOP_PER_TAP * taps["bilateral_pass"]),
            "bilateral_2d": (8 * px, K3_FLOP_PER_TAP * taps["bilateral_2d"]),
            "normals": (px * (4 + 12 + 12), K4_FLOP_PER_PIXEL * px)}
    for name, (kernel, plain, key) in calls.items():
        ms = events_ms(kernel)
        device_ms = kernel_device_ms(kernel, (key,))
        wrapper_ms = cuda_time_ms(kernel)
        plain_ms = cuda_time_ms(plain)
        plain_device_ms, plain_ops = all_device_ms(plain)
        nbytes, flops = work[name]
        bms, by = bound(nbytes, flops)
        share = bms / device_ms if device_ms else float("nan")
        first = PREPROCESS_DEVICE_MS_FIRST.get(name)
        print(f"{name}: kernel {ms:.4f} ms ({TIMED_LAUNCHES} back-to-back), device "
              f"{device_ms} ms" + (f" (before the redesign: {first:.5f})" if first else "")
              + f", wrapper {wrapper_ms:.4f} ms per call, plain {plain_ms:.4f} ms "
              f"({plain_ops:.0f} device ops, {plain_device_ms:.4f} device ms); bound "
              f"{bms:.6f} ms ({by}: {nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP"
              + (f" over {taps[name]} finite taps" if name in taps else "")
              + f"), {share:.1%} of it")
        recs[name].update(ms=ms, device_ms=device_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                          plain_device_ms=plain_device_ms, plain_device_ops=plain_ops,
                          bound_ms=bms, bound_by=by, bound_share=share)
    # K3's one-axis modes beside the separable launch, and the floor its
    # precise expf sets: one MUFU ex2 a finite tap
    k3 = recs["bilateral_pass"]
    k3.update(axis0_device_ms=kernel_device_ms(lambda: pre.bilateral_pass(d, 0),
                                               ("bilateral_pass_kernel",)),
              axis1_device_ms=kernel_device_ms(lambda: pre.bilateral_pass(p1_ref, 1),
                                               ("bilateral_pass_kernel",)))
    clock = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # printed only: an estimate from an assumed rate, not a measurement
    ex2_floor_ms = taps["bilateral_pass"] / (MUFU_EX2_PER_CLOCK_SM * sms * clock) * 1e3
    print(f"bilateral_pass: one-axis modes {k3['axis0_device_ms']} / {k3['axis1_device_ms']} "
          f"device ms (axis 0 / 1); ex2 floor {ex2_floor_ms:.6f} ms ("
          f"{taps['bilateral_pass']} finite taps at {MUFU_EX2_PER_CLOCK_SM} a clock on each of "
          f"{sms} SMs, {clock / 1e9:.3f} GHz) beside the bound {k3['bound_ms']:.6f} ms")
    recs["normals"]["from_points_device_ms"] = kernel_device_ms(
        lambda: pre.estimate_normals(pts_ref), ("normals_kernel",))
    print(f"normals: from points {recs['normals']['from_points_device_ms']} device ms")

    # the whole preprocess_frame: the kernels against the plain versions
    frame = {}
    for mode, plain_filter in (("separable", pre.bilateral_filter_separable_reference),
                               ("full", pre.bilateral_filter_reference)):
        def kernels():
            return pre.preprocess_frame(d, cam=cam, bilateral_mode=mode)

        def plain():
            p = backproject(cam, plain_filter(d))
            return p, pre.estimate_normals_reference(p)

        reset_counters()
        kernels()
        launches = counters()
        k_ms, k_ops = all_device_ms(kernels)
        p_ms, p_ops = all_device_ms(plain)
        k_host, p_host = host_ms(kernels), host_ms(plain)
        print(f"preprocess_frame ({mode}, {w}x{h}): kernels {k_ms:.4f} device ms in "
              f"{k_ops:.1f} device ops (the profiler may miss launches), {k_host:.3f} ms on "
              f"the host clock a call; plain {p_ms:.4f} device ms in {p_ops:.0f} ops, "
              f"{p_host:.3f} ms")
        check_preprocess(f"preprocess_frame ({mode})", launches, 1, mode)
        frame[mode] = dict(device_ms=k_ms, device_ops=k_ops, host_ms=k_host,
                           plain_device_ms=p_ms, plain_device_ops=p_ops, plain_host_ms=p_host)
    torch.cuda.empty_cache()
    return recs, frame


# the depth layouts a card path takes as the CPU path does: each view has
# the values of the contiguous float32 frame
LAYOUTS = {
    "cropped": lambda d: torch.nn.functional.pad(d, (3, 2, 1, 4), value=7.0)[1:-4, 3:-2],
    "transposed": lambda d: d.t().contiguous().t(),
    "float64": lambda d: d.double(),
}
LAYOUT_FRAMES = 3  # process_frame calls a layout run (frame 0 bootstraps)


def layout_phase(cam, depths, poses, rgb, dev):
    """Phase 12, the layouts: the preprocess entry points on a cropped, a
    transposed and a float64 copy of the scene's second frame bitwise the
    plain version on the contiguous float32 frame (one launch a call), and
    both filters at radius 17 (a launch each, the runtime-radius code);
    then Reconstruction.process_frame over LAYOUT_FRAMES frames at tum128
    (the 2-D filter, dense) and tum256 (separable, brick-major) fed each
    layout: poses and grid bitwise the contiguous run's, one K3 and one K4
    launch a frame. Returns the record."""
    from tracking_sdf_tpu_torch.config import preset
    from tracking_sdf_tpu_torch.core.camera import backproject
    from tracking_sdf_tpu_torch.grid.grid import FIELDS
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
    from tracking_sdf_tpu_torch.tracking import preprocess as pre

    print(f"phase 12: the depth layouts the card paths take, on {gpu_line()}")
    d = depths[1].contiguous()
    pts_ref = backproject(cam, d)
    want = {"bilateral_filter": pre.bilateral_filter_reference(d),
            "bilateral_filter_separable": pre.bilateral_filter_separable_reference(d),
            "points": pts_ref, "normals": pre.estimate_normals_reference(pts_ref)}
    rec = {}
    for view, make in LAYOUTS.items():
        x = make(d)
        check(not (x.is_contiguous() and x.dtype == torch.float32), f"{view}: not a new layout")
        reset_counters()
        pts, nrm = pre.preprocess_frame(x, cam=cam, bilateral=False)
        got = {"bilateral_filter": pre.bilateral_filter(x),
               "bilateral_filter_separable": pre.bilateral_filter_separable(x),
               "points": pts, "normals": nrm}
        launches = counters()
        for k, g in got.items():
            _, mism, bits = image_compare(g, want[k])
            check(mism == 0 and bits == 0, f"{k} ({view}) differs from the plain version on "
                  f"the float32 frame: {mism} NaN-mask mismatches, {bits} values")
        check((launches["bilateral_pass"], launches["bilateral_2d"], launches["normals"])
              == (1, 1, 1), f"{view}: launched {launches}")
        rec[view] = "bitwise"
    reset_counters()
    r17 = {"bilateral_filter": (pre.bilateral_filter(d, radius=17),
                                pre.bilateral_filter_reference(d, 17)),
           "bilateral_filter_separable": (pre.bilateral_filter_separable(d, radius=17),
                                          pre.bilateral_filter_separable_reference(d, 17))}
    launches = counters()
    for k, (g, w_) in r17.items():
        _, mism, bits = image_compare(g, w_)
        check(mism == 0 and bits == 0, f"{k} at radius 17 differs: {mism}, {bits}")
    check((launches["bilateral_2d"], launches["bilateral_pass"]) == (1, 1),
          f"radius 17: {launches}")
    rec["radius 17"] = "2-D and separable launched, bitwise"
    print(f"  preprocess_frame, bilateral_filter, bilateral_filter_separable on "
          f"{', '.join(LAYOUTS)} depth: bitwise the plain version on the float32 frame; "
          f"radius 17: {rec['radius 17']}")
    del r17, want
    for name in ("tum128", "tum256"):
        cfg = dataclasses.replace(preset(name), trajectory_path=None)
        runs = {}
        for view in ("contiguous", *LAYOUTS):
            recon = Reconstruction(cam, cfg, initial_pose=poses[0], device=dev)
            reset_counters()
            for k in range(LAYOUT_FRAMES):
                dk = depths[k] if view == "contiguous" else LAYOUTS[view](depths[k])
                recon.process_frame(dk, rgb=rgb, timestamp=float(k))
            check_preprocess(f"{name} {view}", counters(), LAYOUT_FRAMES, filter_mode(cfg))
            grid = recon.grid
            runs[view] = ((recon.pose.R.clone(), recon.pose.t.clone()),
                          [getattr(grid, k).clone() for k in FIELDS])
            recon.close()
            del recon, grid
            torch.cuda.empty_cache()
        (R0, t0), g0 = runs.pop("contiguous")
        for view, ((R, t), g) in runs.items():
            differ = sum(_diff(a, b)[0] for a, b in zip(g, g0))
            check(torch.equal(R, R0) and torch.equal(t, t0) and differ == 0,
                  f"{name} process_frame on {view} depth differs from the contiguous run: "
                  f"{differ} grid values")
        rec[f"{name} process_frame"] = "bitwise"
        print(f"  {name}: process_frame over {LAYOUT_FRAMES} frames on {', '.join(runs)} "
              f"depth: pose and {len(g0)} grid fields bitwise the contiguous run's")
        del runs
        torch.cuda.empty_cache()
    return rec


# --- phase 13: brick classification, compaction and the pixel table (K5-K7) ---

CLASSIFY_TPU = {  # the JAX functions each kernel replaces (no Pallas original)
    "frame_tables": "tracking_sdf_tpu/fusion/brick.py:187",  # _zeta_mip; _pixel_table :625
    "classify_bricks": "tracking_sdf_tpu/fusion/brick.py:587",  # classify_bricks; :377 descent
    "compact_lists": "tracking_sdf_tpu/fusion/brick.py:123"}  # _compact_vals; :377 lists
# the form whose times head each kernel's record: tum256's main-path launch
CLASSIFY_HEADLINE = {"frame_tables": "tum256 mip and color table",
                     "classify_bricks": "tum256 flat", "compact_lists": "tum256 flat"}
# float operations a pixel of K5 (validity, table row and color 12, the ray,
# footprint and both bounds 24) and a brick of K6 (the axis ends 21, their
# products 18, each of 8 corners 9 adds, u and v 8 and 6 min / max, the
# window query 42)
K5_FLOP_PER_PIXEL = 36
K6_FLOP_PER_BRICK = 265
# K5's and K7's device ms before their redesign (one thread a pixel, the last
# block's upper levels through L2; one block of 1024 threads) on these forms
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md's kernel table): printed beside
# this run's, never put in a record
CLASSIFY_DEVICE_MS_FIRST = {"frame_tables mip and color table": 0.03034,
                            "compact_lists flat": 0.01219,
                            "compact_lists flat over the supers": 0.00271,
                            "compact_lists hierarchical": 0.06728}


def unaligned(x):
    """A contiguous copy of x that starts 4 bytes past a 16-byte boundary
    (K5's scalar loads)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    check(y.is_contiguous() and y.data_ptr() % 16 == 4, "unaligned copy")
    return y


def _diff(a, b):
    """(values that differ bit for bit, max abs difference) of two tensors
    of one dtype and shape (NaN payloads compared as NaN)."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"shapes / dtypes {tuple(a.shape)} {a.dtype}, {tuple(b.shape)} {b.dtype}")
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        differ = int(((a.view(torch.int32) != b.view(torch.int32)) | (na != nb)).sum())
        fin = torch.isfinite(a) & torch.isfinite(b)
        err = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
        return differ, err
    differ = int((a != b).sum())
    return differ, float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def classify_phase(cam, depths, poses, rgb, dev, tracked_pose):
    """Phase 13: K5, K6 (flat, super, children) and K7 (flat, hierarchical)
    against their plain versions at full width on the scene's second frame
    from the per-frame run's tracked pose, bit for bit: tum256 (flat) and
    tum512 (hierarchical, its FREE cap overflowing), each at the preset's
    caps, with the caps tightened once more, with sat_runs' bitset, and in
    the slab form at half the layers; each kernel form timed four ways beside
    its bound from this run's data; classify_compact_rows with the pixel
    table, kernels against plain, in device ms, ops and host ms a call.
    Returns {kernel: record} and the stage's records."""
    from tracking_sdf_tpu_torch.fusion import brick
    from tracking_sdf_tpu_torch.fusion import brick_classify as k567
    from tracking_sdf_tpu_torch.fusion.brickmajor import (
        classify_compact_rows, classify_compact_rows_reference)
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    print(f"phase 13: brick classification, compaction and the pixel table (K5, K6, K7) on "
          f"{gpu_line()}")
    recs = {k: dict(max_abs_err=0.0, values_differ=0) for k in CLASSIFY_COUNTERS}
    stage = {}

    def agree(kernel, what, pairs):
        for got, want in pairs:
            differ, err = _diff(got, want)
            print(f"  {kernel} {what}: {differ} values differ (tol 0), max abs err {err:.3e}")
            check(differ == 0, f"{kernel} {what} disagrees with its plain version: {differ} "
                  "values")
            r = recs[kernel]
            r.update(max_abs_err=max(r["max_abs_err"], err),
                     values_differ=r["values_differ"] + differ)

    for name in CHUNKS:
        cfg = path_config(name, None)
        f, p = cfg.fusion, cfg.grid
        bs, cap, cap_free, fac = f.brick_shape, f.brick_cap, f.brick_cap_free, f.hier_classify
        pts, nrm = preprocess_frame(depths[1], cam=cam, bilateral=cfg.bilateral_filter,
                                    bilateral_mode=cfg.bilateral_mode)
        pose = tracked_pose[name]
        share = brick.share_classify_margin(p, f)
        hw = tuple(pts.shape[:2])
        nb3 = tuple(p.m // b for b in bs)
        NB = nb3[0] * nb3[1] * nb3[2]

        # K5: the mip and the table (color) in one launch, and each alone
        mip_ref = brick._zeta_mip_reference(pts, nrm, cam, p.delta, f.distance, share)
        pix_ref = brick._pixel_table_reference(pts, nrm, rgb, True, f.distance)
        mip, pix = brick.frame_tables(pts, nrm, rgb, True, cam, p.delta, f.distance, share)
        names = ("zeta", "zeta_down", "eta", "eta_down")
        agree("frame_tables", f"({name}, mip and table)",
              [(getattr(mip, k), getattr(mip_ref, k)) for k in names] + [(pix, pix_ref)])
        agree("frame_tables", f"({name}, geometry table alone)",
              [(brick._pixel_table(pts, nrm, None, False, f.distance),
                brick._pixel_table_reference(pts, nrm, None, False, f.distance))])
        off = [unaligned(x) for x in (pts, nrm, rgb)]
        mip_u, pix_u = brick.frame_tables(*off, True, cam, p.delta, f.distance, share)
        agree("frame_tables", f"({name}, mip and table, inputs 4 bytes off 16: scalar loads)",
              [(getattr(mip_u, k), getattr(mip_ref, k)) for k in names] + [(pix_u, pix_ref)])

        # K6's forms on the plain mip
        R, base = brick._card_pose(pose)
        geo = dict(params=p, cam=cam, hw=hw)
        flat_ref = brick.classify_bricks_reference(p, pose, pts, nrm, cam, bs, f.distance,
                                                   mip=mip_ref).reshape(-1)
        flat, _ = k567.classify_bricks(mip_ref, R, base, bs=bs, grid=nb3, **geo)
        agree("classify_bricks", f"({name}, flat, {NB} bricks)", [(flat.int(), flat_ref)])
        if fac > 1:
            ns3 = tuple(n // fac for n in nb3)
            sbs = tuple(b * fac for b in bs)
            sref = brick.classify_bricks_reference(p, pose, pts, nrm, cam, sbs, f.distance,
                                                   mip=mip_ref).reshape(-1)
            sat = SAT_BITS[name]
            scls, sat_super = k567.classify_bricks(mip_ref, R, base, bs=sbs, grid=ns3,
                                                   sat=sat, factor=fac, **geo)
            sat_ref = (sat.view(ns3[0], fac, ns3[1], fac, ns3[2], fac).permute(0, 2, 4, 1, 3, 5)
                       .reshape(-1, fac ** 3).all(1))
            agree("classify_bricks", f"({name}, super, {sref.numel()} supers, sat)",
                  [(scls.int(), sref), (sat_super, sat_ref)])
            scls, none = k567.classify_bricks(mip_ref, R, base, bs=sbs, grid=ns3, factor=fac,
                                              **geo)
            check(none is None, "the super form without sat wrote sat_super")
            agree("classify_bricks", f"({name}, super, {sref.numel()} supers, no sat)",
                  [(scls.int(), sref)])
            mixed = brick._compact_ids(sref == 2, f.cap_mixed, sref.numel()).int()
            fcls, gid = k567.classify_children(mip_ref, R, base, mixed, bs=bs, grid=nb3,
                                               factor=fac, **geo)
            # each listed super's children's global ids, NB on a padding slot
            listed = mixed < sref.numel()
            sid = mixed.long().clamp(max=sref.numel() - 1)[:, None]
            c = torch.arange(fac ** 3, device=dev)
            gid_ref = ((((sid // (ns3[1] * ns3[2])) * fac + c // (fac * fac)) * nb3[1]
                        + ((sid // ns3[2]) % ns3[1]) * fac + (c // fac) % fac) * nb3[2]
                       + (sid % ns3[2]) * fac + c % fac)
            gid_ref = torch.where(listed[:, None], gid_ref, NB).reshape(-1)
            ok = gid_ref < NB
            agree("classify_bricks", f"({name}, children of {int(listed.sum())} mixed supers "
                  f"and {int((~listed).sum())} padding slots: classes, global ids)",
                  [(fcls[ok].int(), flat_ref[gid_ref[ok]]),
                   (fcls[~ok].int(), torch.zeros_like(fcls[~ok].int())),
                   (gid.long(), gid_ref)])

        # the whole stage (K7 inside) at the preset's caps, tightened, with
        # sat, and on the slab of the second half of the brick layers
        cases = [("preset caps", f, cap, cap_free, None, None, 0),
                 ("caps / 4", f._replace(cap_mixed=f.cap_mixed // 4), cap // 4,
                  cap_free // 4, None, None, 0),
                 ("sat", f, cap, cap_free, SAT_BITS[name], None, 0),
                 ("slab", f, cap // 2, cap_free // 2, None, nb3[0] // 2, p.m // 2)]
        for what, fc, c, cf, sat, nbi, i0 in cases:
            kw = dict(cam=cam, cfg=fc, bs=bs, cap=c, cap_free=cf, sat=sat, nbi=nbi,
                      i_offset=i0)
            reset_counters()
            got = classify_compact_rows(p, pose, pts, nrm, **kw)
            launches = counters()
            want = classify_compact_rows_reference(p, pose, pts, nrm, **kw)
            n_k = 2 if fac > 1 else 1
            check(tuple(launches[k] for k in CLASSIFY_COUNTERS) == (1, n_k, n_k),
                  f"classify_compact_rows ({name}, {what}) launched {launches}")
            counts = want[1].tolist()
            agree("compact_lists", f"({name}, {what}: cap {c}, cap_free {cf}; n_full, n_free, "
                  f"FREE dropped, mixed dropped {counts})", list(zip(got, want)))
            stage.setdefault(name, {})[what] = counts
            if what == "preset caps":
                check(name != "tum512" or counts[2] > 0, "tum512: the FREE cap did not overflow")

        # times at the main path's shapes: the preset's caps, no sat
        ms3 = tuple(n // fac for n in nb3) if fac > 1 else None
        cap_sfree = max(cap_free // fac ** 3, 1) if fac > 1 else 0
        if fac > 1:
            scls, _ = k567.classify_bricks(mip, R, base, bs=tuple(b * fac for b in bs),
                                           grid=ms3, factor=fac, **geo)
            sup, sup_counts = k567.compact_lists(scls, None, f.cap_mixed, cap_sfree,
                                                 scls.numel())
            fcls, gid = k567.classify_children(mip, R, base, sup[:f.cap_mixed], bs=bs,
                                               grid=nb3, factor=fac, **geo)
        n_pix = hw[0] * hw[1]
        total = mip.zeta.numel()
        mip_bytes = 4 * 4 * total
        forms = {
            ("frame_tables", "mip and color table"): (
                lambda: brick.frame_tables(pts, nrm, rgb, True, cam, p.delta, f.distance, share),
                lambda: (brick._zeta_mip_reference(pts, nrm, cam, p.delta, f.distance, share),
                         brick._pixel_table_reference(pts, nrm, rgb, True, f.distance)),
                ("frame_tables_kernel",), n_pix * (36 + 32) + mip_bytes,
                K5_FLOP_PER_PIXEL * n_pix),
            ("frame_tables", "mip and color table, unaligned"): (
                lambda: brick.frame_tables(*off, True, cam, p.delta, f.distance, share),
                None, ("frame_tables_kernel",), n_pix * (36 + 32) + mip_bytes,
                K5_FLOP_PER_PIXEL * n_pix)}
        if fac > 1:
            n_child = f.cap_mixed * fac ** 3
            forms.update({
                ("classify_bricks", "super"): (
                    lambda: k567.classify_bricks(mip, R, base, bs=tuple(b * fac for b in bs),
                                                 grid=ms3, factor=fac, **geo),
                    lambda: brick.classify_bricks_reference(
                        p, pose, pts, nrm, cam, tuple(b * fac for b in bs), f.distance,
                        mip=mip),
                    ("classify_bricks_kernel",), scls.numel() + mip_bytes + 48,
                    K6_FLOP_PER_BRICK * scls.numel()),
                ("compact_lists", "flat over the supers"): (
                    lambda: k567.compact_lists(scls, None, f.cap_mixed, cap_sfree, scls.numel()),
                    lambda: (brick._compact_ids(scls == 2, f.cap_mixed, scls.numel()),
                             brick._compact_ids(scls == 1, cap_sfree, scls.numel())),
                    ("compact_lists_kernel",),
                    scls.numel() + 4 * (f.cap_mixed + cap_sfree) + 32, 0),
                ("classify_bricks", "children"): (
                    lambda: k567.classify_children(mip, R, base, sup[:f.cap_mixed], bs=bs,
                                                   grid=nb3, factor=fac, **geo),
                    None, ("classify_bricks_kernel",),
                    4 * f.cap_mixed + 5 * n_child + mip_bytes + 48,
                    K6_FLOP_PER_BRICK * int((sup[:f.cap_mixed] < scls.numel()).sum())
                    * fac ** 3),
                ("compact_lists", "hierarchical"): (
                    lambda: k567.compact_lists_hier(fcls, gid, None, sup[f.cap_mixed:],
                                                    sup_counts, cap=cap, cap_free=cap_free,
                                                    cap_mixed=f.cap_mixed, grid=nb3,
                                                    factor=fac),
                    None, ("compact_lists_hier_kernel",),
                    5 * n_child + 4 * cap_sfree + 32 + 4 * (cap + cap_free) + 32, 0),
                # the same lists with sat_runs' bitset: the sat reads of the
                # FREE children and of the kept FREE supers' children
                ("compact_lists", "hierarchical, sat"): (
                    lambda: k567.compact_lists_hier(fcls, gid, SAT_BITS[name], sup[f.cap_mixed:],
                                                    sup_counts, cap=cap, cap_free=cap_free,
                                                    cap_mixed=f.cap_mixed, grid=nb3,
                                                    factor=fac),
                    None, ("compact_lists_hier_kernel",),
                    5 * n_child + 4 * cap_sfree + 32 + 4 * (cap + cap_free) + 32 + NB, 0)})
        else:
            forms.update({
                ("classify_bricks", "flat"): (
                    lambda: k567.classify_bricks(mip, R, base, bs=bs, grid=nb3, **geo),
                    lambda: brick.classify_bricks_reference(p, pose, pts, nrm, cam, bs,
                                                            f.distance, mip=mip),
                    ("classify_bricks_kernel",), NB + mip_bytes + 48, K6_FLOP_PER_BRICK * NB),
                ("compact_lists", "flat"): (
                    lambda: k567.compact_lists(flat, None, cap, cap_free, NB),
                    lambda: (brick._compact_ids(flat == 2, cap, NB),
                             brick._compact_ids(flat == 1, cap_free, NB)),
                    ("compact_lists_kernel",), NB + 4 * (cap + cap_free) + 32, 0)})
        for (kernel, form), (fn, plain, keys, nbytes, flops) in forms.items():
            ms = events_ms(fn)
            # the profiler has missed every launch of a session: ask twice
            device_ms = kernel_device_ms(fn, keys) or kernel_device_ms(fn, keys)
            wrapper_ms = cuda_time_ms(fn)
            plain_ms = cuda_time_ms(plain) if plain else None
            bms, by = bound(nbytes, flops)
            share_b = bms / device_ms if device_ms else float("nan")
            first = CLASSIFY_DEVICE_MS_FIRST.get(f"{kernel} {form}")
            was = f" (before the redesign {first} ms)" if first else ""
            print(f"{kernel} ({name}, {form}): kernel {ms:.4f} ms ({TIMED_LAUNCHES} "
                  f"back-to-back), device {device_ms} ms{was}, wrapper {wrapper_ms:.4f} ms per "
                  f"call, plain {plain_ms} ms; bound {bms:.6f} ms ({by}: {nbytes / 1e6:.3f} "
                  f"MB, {flops / 1e6:.2f} MFLOP), {share_b:.1%} of it")
            recs[kernel][f"{name} {form}"] = dict(
                ms=ms, device_ms=device_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, bound_share=share_b)

        # the stage: classify_compact_rows and the pixel table, kernels
        # against plain
        kw = dict(cam=cam, cfg=f, bs=bs, cap=cap, cap_free=cap_free)

        def kernels():
            m_, x = brick.frame_tables(pts, nrm, rgb, True, cam, p.delta, f.distance, share)
            return classify_compact_rows(p, pose, pts, nrm, mip=m_, **kw), x

        def plain():
            return (classify_compact_rows_reference(p, pose, pts, nrm, **kw),
                    brick._pixel_table_reference(pts, nrm, rgb, True, f.distance))

        k_ms, k_ops = all_device_ms(kernels)
        p_ms, p_ops = all_device_ms(plain)
        k_host, p_host = host_ms(kernels), host_ms(plain)
        print(f"classify_compact_rows + pixel table ({name}): kernels {k_ms:.4f} device ms in "
              f"{k_ops:.1f} device ops (the profiler may miss launches), {k_host:.3f} ms on the "
              f"host clock a call; plain {p_ms:.4f} device ms in {p_ops:.0f} ops, "
              f"{p_host:.3f} ms")
        stage.setdefault(name, {}).update(device_ms=k_ms, device_ops=k_ops, host_ms=k_host,
                                          plain_device_ms=p_ms, plain_device_ops=p_ops,
                                          plain_host_ms=p_host)
    torch.cuda.empty_cache()
    return recs, stage


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke runs "
              "only on a CUDA GPU", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    try:
        from tracking_sdf_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    from tracking_sdf_tpu_torch.core.camera import ros_default_camera
    from tracking_sdf_tpu_torch.core.lie import Pose
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth

    gpu = gpu_line()
    dev = "cuda"
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc[-1] if nvcc else 'unknown'}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(_build.library_path(), repo)}")
    for line in _build.build_log().splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print("  " + line.strip())

    cam = ros_default_camera()
    scene = make_scene()
    poses = make_poses(dev)
    rgb = torch.full((cam.height, cam.width, 3), 0.5, device=dev)

    k1_dense, k1_brick, k1_step_dense, k1_step_brick = kernel_gn(cam, scene, poses, rgb,
                                                                 dev)
    k2_dense = kernel_merge(dev)
    k2_rows = kernel_merge_rows(dev)
    k2_fuse = {name: fuse_rows_compare(name, cam, scene, poses, rgb, dev)
               for name in ("tum256", "tum512")}
    print(f"phase 9: K2 with the sat_skip bitset on {gpu_line()}")
    k2_sat = {name: fuse_rows_sat_compare(name, cam, scene, poses, rgb, dev)
              for name in ("tum256", "tum512")}
    small_parity(dev)

    depths = [render_scene_depth(scene, cam, p) for p in poses]
    torch.cuda.synchronize()
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    runs = {name: run_path(name, cam, depths, poses, rgb, dev,
                           os.path.join(repo, "build", f"chip_smoke_{name}.txt"))
            for name in TRACKED}
    paths = {name: rec for name, (rec, _) in runs.items()}
    free_cap_cost(cam, depths, poses, rgb, dev, paths["tum512"])
    tum_decode_on_card(depths[1], dev)
    finals = {}  # the presets' final rows and tracked pose, for phase 8
    # the pose each preset's per-frame run fused the second frame at, for phase 13
    tracked_pose = {name: Pose(*runs[name][1]["poses"][1]) for name in CHUNKS}
    for name in CHUNKS:
        paths[f"{name}_chunk"] = run_chunk_path(
            name, cam, depths, poses, rgb, dev,
            os.path.join(repo, "build", f"chip_smoke_{name}_chunk.txt"), runs[name][1])
        R, t = runs[name][1]["poses"][-1]
        finals[name] = (runs[name][1]["rows"], Pose(R, t))
        del runs[name]
    k1_central, central_paths = central_phase(cam, scene, depths, poses, rgb, dev, repo)
    paths.update(central_paths)
    work = tempfile.mkdtemp(prefix="chip_smoke_dataset_", dir=os.path.join(repo, "build"))
    try:
        paths.update(dataset_phase(dev, work, {name: paths[f"{name}_chunk"]["ms_per_frame"]
                                               for name in CHUNKS}))
        render_mesh_parity(dev)
        phase8 = {}
        for name in CHUNKS:
            rows, pose = finals[name]
            phase8[name] = render_mesh_full(name, rows, pose, poses[TRACKED[name]], cam, scene,
                                            dev, work)
            del rows
            torch.cuda.empty_cache()
        paths["tum256_render"] = cli_render_phase(work, paths["tum256_dataset"])
        phase8["cli"] = {k: v for k, v in paths["tum256_render"].items() if k != "launches"}

        print(f"phase 9: the reference-exact path and the remaining modes on {gpu_line()}")
        phase9 = {"k2_sat": k2_sat}
        dense = dense_paths(cam, depths, poses, rgb, dev, work)
        tails = flat_tails(cam, scene, depths, poses, rgb, dev)
        sat = {name: sat_runs(name, cam, depths, poses, rgb, dev) for name in CHUNKS}
        paths.update({k: v for k, v in {**dense, **tails}.items() if "launches" in v})
        paths.update({f"{name}_sat": v for name, v in sat.items()})
        phase9.update(dense=dense, tails=tails, sat=sat, renders={})
        for name in CHUNKS:
            rows, pose = finals.pop(name)
            phase9["renders"][name] = skip_renders(name, rows, pose, cam)
            del rows
        torch.cuda.empty_cache()

        phase10, slab, paths["tum256_mesh"] = multi_device_phase(cam, scene, depths, poses,
                                                                 rgb, dev, work)
        phase11, f32, packed_paths = surface_phase(cam, scene, depths, poses, rgb, dev, work)
        paths.update(packed_paths)
        k34, frame12 = preprocess_phase(cam, depths)
        layouts12 = layout_phase(cam, depths, poses, rgb, dev)
        k567, stage13 = classify_phase(cam, depths, poses, rgb, dev, tracked_pose)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def src(f):
        return f"tracking_sdf_tpu_torch/csrc/{f}"

    def entry(name, source, replaces, path_names, per, rec, counter=None):
        """One kernel's record; launches (its wrapper's ``counter``, default
        ``name``) from the named main paths, per tracked (K1) or fused (K2)
        frame of those paths."""
        n = sum(paths[p]["launches"][counter or name] for p in path_names)
        frames = sum(paths[p][per] for p in path_names)
        return {**dict(name=name, route="cuda", source=src(source), replaces=replaces,
                       launches=n, launches_per_frame=n / frames, library_ms=None), **rec}

    gn_tpu = "tracking_sdf_tpu/tracking/pallas_gn.py:82"
    central_tpu = "tracking_sdf_tpu/tracking/gauss_newton.py:106"
    merge_tpu = "tracking_sdf_tpu/fusion/pallas_merge.py:94"
    presets = ("tum256", "tum512", "tum256_chunk", "tum512_chunk", "tum256_dataset",
               "tum512_dataset", "tum256_render", "tum256_sat", "tum512_sat")
    dense_paths_ = ("slice", "slice_xla", "slice_rows", "slice_pallas", "synthetic64",
                    "tum128", "tum128_dataset", "tum256_dense")
    def at_paths(form, rec):
        """The slice's record with the dense presets' own, and the largest
        error of them all."""
        more = {name: r[form] for name, r in phase9["dense"]["k1"].items()}
        return dict(rec, max_abs_err=max([rec["max_abs_err"]]
                                          + [r["max_abs_err"] for r in more.values()]),
                    **more)

    def preprocess_entry(name):
        """K3's or K4's record; launches over every main path that ran it,
        per processed frame of those paths."""
        ran = [r for r in paths.values() if r["launches"][name]]
        n = sum(r["launches"][name] for r in ran)
        return {**dict(name=name, route="cuda", source=src("preprocess.cu"),
                       replaces=PREPROCESS_TPU[name], launches=n,
                       launches_per_frame=n / sum(r["processed"] for r in ran),
                       library_ms=None), **k34[name]}

    def classify_entry(name):
        """K5's, K6's or K7's record; launches over every main path that ran
        it, per fused frame of those paths (K6 and K7 run twice a
        hierarchical frame, K7 never on the flat bricked layout)."""
        ran = [r for r in paths.values() if r["launches"][name]]
        n = sum(r["launches"][name] for r in ran)
        return {**dict(name=name, route="cuda", source=src("brick_classify.cu"),
                       replaces=CLASSIFY_TPU[name], launches=n,
                       launches_per_frame=n / sum(r["fused"] for r in ran),
                       library_ms=None), **k567[name], **k567[name][CLASSIFY_HEADLINE[name]]}

    kernels = [
        entry("gn_reduce", "gn_reduce.cu", gn_tpu, dense_paths_, "tracked",
              at_paths("gn_reduce", k1_dense)),
        entry("gn_reduce_brick", "gn_reduce.cu", gn_tpu, presets, "tracked", k1_brick),
        entry("gn_step", "gn_reduce.cu", gn_tpu, dense_paths_, "tracked",
              at_paths("gn_step", k1_step_dense)),
        entry("gn_step_brick", "gn_reduce.cu", gn_tpu, presets, "tracked", k1_step_brick),
        # the JAX package computes the 13 probes and the normal equations in XLA ops
        entry("gn_central_step", "gn_reduce.cu", central_tpu, tuple(central_paths), "tracked",
              k1_central, counter="gn_step_central"),
        entry("brick_merge", "brick_merge.cu", merge_tpu, ("slice", "slice_pallas"), "fused",
              k2_dense),
        entry("brick_merge_rows", "brick_merge.cu", merge_tpu, presets, "fused", k2_rows),
        entry("brick_fuse_rows", "brick_fuse.cu", merge_tpu, presets, "fused",
              dict(k2_fuse["tum256"][True], tum256_geometry=k2_fuse["tum256"][False],
                   tum512_color=k2_fuse["tum512"][True],
                   tum512_geometry=k2_fuse["tum512"][False])),
        entry("brick_fuse_rows_sat", "brick_fuse.cu", merge_tpu, presets, "fused",
              dict(k2_sat["tum256"], tum512=k2_sat["tum512"])),
        entry("gn_reduce_slab_brick", "gn_reduce.cu", gn_tpu, ("tum256_mesh",), "tracked",
              dict(slab["k1"]["tum256"], tum128_dense=slab["k1"]["tum128"],
                   max_abs_err=max(r["max_abs_err"] for r in slab["k1"].values()))),
        entry("gn_finish", "gn_reduce.cu", gn_tpu, ("tum256_mesh", "tum128_central"),
              "tracked",
              dict(slab["finish"]["tum256"], tum128_dense=slab["finish"]["tum128"],
                   max_abs_err=max(r["max_abs_err"] for r in slab["finish"].values()))),
        entry("brick_fuse_rows_slab", "brick_fuse.cu", merge_tpu, ("tum256_mesh",), "fused",
              dict(slab["k2"]["tum256"], tum512=slab["k2"]["tum512"],
                   max_abs_err=max(r["max_abs_err"] for r in slab["k2"].values()))),
        # the packed runs' rows are float32: every launch of theirs is this form
        entry("gn_step_brick_f32", "gn_reduce.cu", gn_tpu, tuple(packed_paths), "tracked",
              f32["k1"], counter="gn_step_brick"),
        entry("brick_fuse_rows_f32", "brick_fuse.cu", merge_tpu, tuple(packed_paths), "fused",
              dict(f32["k2"]["tum256"][True], tum256_geometry=f32["k2"]["tum256"][False],
                   tum512_color=f32["k2"]["tum512"][True],
                   tum512_geometry=f32["k2"]["tum512"][False],
                   max_abs_err=max(r["max_abs_err"] for k in f32["k2"].values()
                                   for r in k.values())),
              counter="brick_fuse_rows"),
        # no single PyTorch call computes a bilateral filter or organized normals
        *(preprocess_entry(name) for name in PREPROCESS_COUNTERS),
        # no single PyTorch call classifies bricks or builds the mip
        *(classify_entry(name) for name in CLASSIFY_COUNTERS),
    ]
    print(json.dumps({"phase8": phase8}))
    print(json.dumps({"phase9": phase9}))
    print(json.dumps({"phase10": phase10}))
    print(json.dumps({"phase11": phase11}))
    print(json.dumps({"phase12": {"kernels": k34, "preprocess_frame": frame12,
                                  "layouts": layouts12}}))
    print(json.dumps({"phase13": {"kernels": k567, "stage": stage13}}))
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
