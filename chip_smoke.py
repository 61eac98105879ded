"""On-device smoke run of the PyTorch / CUDA port (stereo_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a) and nvcc; raises at once without a GPU.  It

  1. builds every CUDA kernel of the package from csrc/ (one nvcc per source,
     started together) and prints the card's name and power limit;
  2. holds each kernel against its plain PyTorch version on the card, bit for
     bit: the two phase kernels for kernel in {1, 2}, K in {2, 8, 15, 79},
     37x53 and 375x450 (odd H, ragged edges, border pixels with valid =
     alpha = 0), and at 37x53 K in {3, 17, 41, 97, 202} (beyond one pass
     of a block's targets), alpha < 0 on a third of the pixels, and tol in
     {1e-3, 1e6}, all of it again with bfloat16 message storage (at
     375x450 K = 79 only) and with float16 at 37x53, K = 79 and 202; the
     column send for K in {2, 8, 15, 79, 300} x kernel x L
     in {53, 1536} x batch in {1, 2}, and K = 1000 (L = 53 and L = 64,000,
     more tiles than resident blocks), and gathered in one launch as a
     solver step gives it (six problems of a banded step at teddy's
     L = 1536, K = 79 and 202; two of a wavefront step at L = 375, K = 79;
     both at L = 53 for K in {3, 17, 41, 97, 202, 1000}), each with a < 0
     on a third of the lanes and with tol in {1e-3, 1e6}; the
     fused banded sweep on twelve problems up to teddy K = 79 and K = 202
     with 128 x 128 blocks and K in {97, 202, 300, 1000}, one sweep from
     zero messages and one from the warm state, each at every phase-B job
     width (32, 16 and 8 lanes forced, and chosen a step) against one plain
     sweep, four problems (teddy K = 79 among them) with a < 0 on a third
     of the pixels (messages and seam arrays bit for bit, the lower bound
     to rtol 1e-5); the min-plus pair for K in {2,
     8, 15, 79, 300} x kernel x {37x53, 375x450} and K = 1000 on 37x53 and
     200x320 (border pixels with alpha = 0), and at 37x53 for K in {17, 79}
     with a < 0 on a third of the pixels and with tol in {1e-3, 1e6}; the fused raster-wavefront
     sweep on fourteen problems up to teddy K = 79 and K = 202 and K in
     {97, 128, 202, 300, 1000}, the same two sweeps at every width, four
     problems with a < 0;
  3. drives the main path at full width: DispMapNCC on data/teddy (375x450,
     51 disparities), 72 RANSAC + 6 fronto-parallel proposals, binary fusion
     sweep over all 78, restart, simultaneous fusion over K = 79 labels with
     checkerboard TRW-S through the compact phase kernel; then repeats the
     first sweeps through the plain version and compares labels and energy;
     every fusion move's K = 2 blocks go through the block kernel
     (csrc/k2_block.cu), one launch a block;
 3a. the K = 2 block kernel on a teddy fusion move (the model's labelling
     against its middle proposal): 10 blocks of 5 phase pairs in a row
     against binary._k2_block (messages and labelling bit for bit, bound and
     energy to rtol 1e-5), then the ms a block of both in turns, the card's
     ms a launch and the plain version's device operations a block
     (``k2_block``);
  4. drives trws.solve(compact=False) through the full-grid phase kernel and
     compares with the plain version;
  5. drives the main path again under the banded schedule (what
     examples/run_ncc_torch.py runs by default): the same model and
     proposals, 128 x 128 blocks, one launch of the fused sweep kernel per
     sweep; then repeats the first sweeps through the plain version;
  6. drives solve_banded(sweep="steps") at the same size through the column
     send kernel, one launch per step (2 T a sweep), and compares with the
     plain version and the fused sweep;
  7. drives the min-plus pair kernel on its path: one full-grid TRW-S phase
     at teddy K = 79 per colour, assembled per direction from minplus_pair
     as the JAX solver's plain branch assembles it, against the full-grid
     phase kernel on the same inputs, bit for bit;
  8. drives the main path a third time under the raster-wavefront schedule
     (examples/run_ncc_torch.py --schedule wavefront): the same model and
     proposals, 16 sweeps with a decode every 8, one launch of the fused
     wavefront sweep kernel per sweep; then repeats the first sweeps through
     the plain version;
  9. drives solve_wavefront(sweep="steps") at the same size through the
     column send kernel, one launch per step, and compares with the fused
     sweep;
 10. drives DispMapNCC simultaneous fusion at teddy's --grid-step 30
     proposals (K = 202, beyond one pass of a block's targets) on the banded
     and the wavefront schedules, 8 sweeps and one decode each, through
     kernels 5 and 6, and checks lb <= E; then repeats the first two sweeps
     through the plain version and compares labels and energy;
 11. runs each fused sweep (banded and wavefront) twice from one warm state
     at teddy K = 79 and checks that both runs give the same bits (a race
     between the ready flags and the reads they guard would differ);
 12. drives examples/run_global_torch.py at full size: DispMapGlobalStereo
     on data/teddy (375x450, 237 disparities; segmentation weights from the
     mean-shift filter on the card), 14 SegPln proposals, one binary fusion
     each; checks that the energy never rises; then times each of SegPln's
     14 segmentations alone and counts its segments;
 13. drives examples/run_simultaneous_torch.py at full size, cut in depth:
     DispMapGlobalStereo on data/baby2 (370x413, 256 disparities), 14
     SegPln proposals fused to convergence, a restart, then simultaneous
     fusion at K = 15 on the banded schedule (64 sweeps, a decode every 16,
     one launch of kernel 5 a sweep), lb <= E; then the first 2 banded
     sweeps, and 8 sweeps each on the checkerboard (kernel 1) and wavefront
     (kernel 6) schedules, through the kernels and their plain versions;
 13a. (run at the end of 13., on its K = 15 problem from a restart) the
     schedule race of tools/measure_race_torch.py and
     tools/measure_wavefront_torch.py at small depth: run_device on the
     checkerboard (kernel 1), banded (kernel 5), wavefront (kernel 6) and
     scanline (kernel 4) schedules, two chunks each, and once more with the
     first chunk's energy as the target (it must stop there); the
     hierarchy race (two coarsenings solved through kernel 1 at 185 x 206
     and 92 x 103, upsampled, then two checkerboard chunks);
     wavefront_warm_start with levels=3 through kernel 6 at the coarse
     shapes; both warm starts again through the plain versions, messages
     bit for bit; lb <= E at every curve point and no bound falls between
     chunks (rtol 1e-6); run_host a few iterations in raster and in banded
     order (``race_path``);
 14. drives the main path a fourth time under the scanline schedule
     (examples/run_ncc_torch.py --schedule scanline): the same model and
     proposals, 4 sweeps with a decode every 2, every row phase's sends in
     one launch of the column send kernel (4 x 375 launches a sweep); then
     2 sweeps through the kernel and through its plain version, and on
     baby2's K = 15 problem (13.) 8 sweeps of each (4 x 370 a sweep);
 15. the host (QPBO) fusion backend: the first 8 teddy NCC proposals fused
     one at a time with fusion_backend="host" and, from the same start, on
     the device (energy after each move, seconds a move; the energy never
     rises, QPBO's bound lies below it); 4 host moves of the baby2 global
     model with ``improve`` set (QPBO-I where nodes stay unlabelled); 3
     sweeps of the serial TRW-S (solvers/trws_host.py) on baby2's K = 15
     problem in raster order (lb <= E, the bound never falls; seconds a
     sweep); printed as one ``host_path`` line;
 16. (run before 15's baby2 part, on the main path's model) utils/checkpoint
     on the main path's K = 79 problem through the compact phase kernel: 8
     sweeps straight against 4, an async checkpoint of the messages, a load
     and 4 more from the loaded messages; labels, energy, bound and
     messages bit for bit, 32 launches counted (``checkpoint_path``);
 16b. (run after 16, and again in 13. on baby2's K = 15 problem) narrow
     message storage: trws.solve and TRWSRun.run with bfloat16 messages,
     16 sweeps and one decode each, through kernel 1, and 4 sweeps of
     solve(compact=False) through kernel 2, each against its plain version
     on the card (messages bit for bit, labels equal, E and lb within
     1e-6), lb <= E, lb within 3% of float32 storage's (E too on teddy;
     on baby2 printed: its bf16 decodes stay far above float32's); the ms
     a sweep of both storage types in turns (``message_dtype_path``);
 16a. (run after 16, on the main path's model after a restart) the
     distribution layer (parallel/*, solvers/banded_dist.py): the K = 79
     problem's sharded_solve over 2 and 3 column shards of the card, 8
     sweeps through kernel 1 (2 launches a sweep a shard) and 2 over 2
     shards through kernel 2, labels and messages bit for bit against
     trws.solve; one fusion move over 3 shards, the take mask and planes
     bit for bit against binary_fuse (sorted verdicts); sharded_banded_run
     over 3 stripes of 128 x 128 blocks, 4 sweeps with a decode every 2,
     one launch of kernel 4 a step a stripe, labels and messages bit for
     bit against BandedRun(sweep="steps"); examples/run_batch_torch.py's
     pool with 3 teddy pairs in its 2 slots (no pair failed, each energy
     within rel 1e-4 of its own solve); entry.dryrun_multichip(4); and two
     processes on the card joined over gloo (parallel/multihost.py) solving
     a K = 15 problem at teddy's shape, bit for bit against one process
     (``parallel_*`` lines);
 17. examples/run_second_order_torch.py's default configuration at its size
     (teddy crop 120 x 180, max-disp 14, connect 4, visibility on): 8
     fusions with visibility and 4 without (the host QPBO with the cubic
     reduction; info["error"] checked, the energy never rises, each move
     taken only below its keep energy), ojw_stereo's SameUni -> SegPln ->
     Smooth* at 3 fusions a stage, and the first 4 fusions again on the
     CPU through the port (printed, not checked) (``second_order_path``);
 18. examples/run_render_torch.py's default configuration at its size
     (teddy crop 120 x 160, 9 levels): the edge-modes renderer (lb <= E,
     image finite, depth finite where the pixel has a colour mode) and the
     occlusion renderer (energies finite) (``render_path``); no kernel of
     the package lies on 17 and 18;
 19. times every kernel at the teddy K = 79 shape (CUDA events) beside its
     plain version and its byte / operation bounds (the fused sweeps also at
     K = 15 and K = 202, beside their plain versions, in their rows'
     ``at_k15`` and ``at_k202``, with the grid of blocks; the column send also
     as the one launch of a banded and of a wavefront step and of the two
     phases of a scanline row, and a whole scanline sweep at K = 79 and
     K = 15; the phase kernels also with bfloat16 and float16 message
     storage, and at baby2's K = 15 shape, ``phase_k15``; the banded
     decode kernel at teddy K = 79 and at baby2's K = 15 shape, 128 x 128
     blocks, after 8 fused sweeps: device ms a decode, the plain version's
     ms, the bytes bound, labels bit for bit and the energy to rtol 1e-6
     against the plain version, ``decode``), and prints the
     ``{"kernels": [...]}`` line, whose ``decode_banded`` row counts the
     decode kernel's launches on the banded main path (one a check) and
     carries the errors the ``decode`` phase measured, and whose
     ``k2_block`` row (3a.'s) counts the block kernel's launches in the
     main path's fusion sweep.

Every phase prints one JSON line; any failed check raises, so the exit code
is non-zero and the last line is never printed.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False — "
                     "this script runs on an NVIDIA GPU only")

try:
    from stereo_tpu_torch import convert, testing
    from stereo_tpu_torch.config import CVPR08Options
    from stereo_tpu_torch.models.global_stereo import DispMapGlobalStereo
    from stereo_tpu_torch.models.ncc import DispMapNCC, grid_proposals
    from stereo_tpu_torch.models.second_order import (SecondOrderStereo,
                                                      ojw_stereo)
    from stereo_tpu_torch.ops import (
        _build, banded_decode, banded_kernel, k2_block, minplus, phase_kernel,
        wavefront_kernel)
    from stereo_tpu_torch.proposals import segmentation
    from stereo_tpu_torch.proposals import segpln as segpln_mod
    from stereo_tpu_torch.render import OcclRenderOptions, render_occl
    from stereo_tpu_torch.render.edgemodes import render_edgemodes
    from stereo_tpu_torch import entry, energy as energy_mod
    from stereo_tpu_torch.parallel import batch as batch_mod
    from stereo_tpu_torch.parallel import fusion_dist, mesh as mesh_mod
    from stereo_tpu_torch.solvers import (banded, banded_dist, binary,
                                          hierarchy, qpbo_host, scanline,
                                          trws, trws_host, wavefront)
    from stereo_tpu_torch.utils import io
    from stereo_tpu_torch.utils.checkpoint import Checkpointer
    from stereo_tpu_torch.utils.metrics import EnergyTrace
    from examples.run_render_torch import middle_view_P
    from examples import run_batch_torch
    from tools import measure_race_torch as race
except ModuleNotFoundError as exc:
    raise SystemExit(f"chip_smoke.py: {exc}; run it from the root of a "
                     "checkout of the repository, beside stereo_tpu_torch/")

DEV = torch.device("cuda")

# main-path budget: sweeps of simultaneous fusion, decode/test stride, and how
# many leading sweeps are repeated through the plain version
MAXITER = 40
CHECK_EVERY = 8
PLAIN_SWEEPS = 8
# the banded path's plain version makes ~50,000 small launches per sweep at
# full width, so fewer of its sweeps are repeated
PLAIN_SWEEPS_BANDED = 2
BAND = 128
# the decode kernel's timings start from the state of this many sweeps
DECODE_SWEEPS = 8
# the K = 2 block kernel: blocks in a row held against the plain version,
# and phase pairs a block (binary_fuse's check_every)
K2_BLOCKS, K2_CHECK_EVERY = 10, 5
# the wavefront path: a sweep is 2 x 824 thin steps at teddy, so fewer of them
MAXITER_WAVEFRONT = 16
PLAIN_SWEEPS_WAVEFRONT = 2
PAIR, MAX_DISP, GRID_STEP = "teddy", 50, 50
EXPECT = dict(size=(375, 450), proposals=78)  # what that configuration gives
FULL = (79, *EXPECT["size"])  # (K, H, W) of the main path's TRW-S problem

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, float32
# FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
OPS_PER_STEP = 6  # sub, abs|mul, min, mul, add, min per (i, j) label pair
# the pair kernel uses every term twice: + add, min for the second output
OPS_PER_PAIR_STEP = 8

COMPACT_ARGS, FULL_ARGS = testing.COMPACT_ARGS, testing.FULL_ARGS
KERNELS = {
    "phase_messages_compact": dict(
        wrapper=phase_kernel.phase_messages_compact,
        route="cuda", source="stereo_tpu_torch/csrc/phase_kernel.cu",
        replaces="stereo_tpu/ops/phase_kernel.py:77"),
    "phase_messages": dict(
        wrapper=phase_kernel.phase_messages,
        route="cuda", source="stereo_tpu_torch/csrc/phase_kernel.cu",
        replaces="stereo_tpu/ops/phase_kernel.py:28"),
    "minplus_send": dict(
        wrapper=minplus.minplus_send,
        route="cuda", source="stereo_tpu_torch/csrc/minplus_send.cu",
        replaces="stereo_tpu/ops/minplus.py:143"),
    "sweep_banded": dict(
        wrapper=banded_kernel.sweep_banded,
        route="cuda", source="stereo_tpu_torch/csrc/banded_kernel.cu",
        replaces="stereo_tpu/ops/banded_kernel.py:192"),
    "minplus_pair": dict(
        wrapper=minplus.minplus_pair,
        route="cuda", source="stereo_tpu_torch/csrc/minplus_pair.cu",
        replaces="stereo_tpu/ops/minplus.py:66"),
    "sweep_wavefront": dict(
        wrapper=wavefront_kernel.sweep_wavefront,
        route="cuda", source="stereo_tpu_torch/csrc/wavefront_kernel.cu",
        replaces="stereo_tpu/ops/wavefront_kernel.py:179"),
    "decode_banded": dict(
        wrapper=banded_decode.decode_banded,
        route="cuda", source="stereo_tpu_torch/csrc/banded_decode.cu",
        replaces="no TPU kernel: the lax.scan of "
                 "stereo_tpu/solvers/banded.py::_decode_state"),
    "k2_block": dict(
        wrapper=k2_block.k2_block,
        route="cuda", source="stereo_tpu_torch/csrc/k2_block.cu",
        replaces="no TPU kernel: the plain jnp K = 2 block of "
                 "stereo_tpu/solvers/binary.py::binary_fuse"),
}
# (K, H, W, Bh, Bw) of the fused sweep's comparisons: ragged rows and
# columns, Bh != Bw both ways (Lp > L), up to the main path's own shape; K
# beyond one pass of targets (97, 202, 300; 202 also at teddy's shape, as the
# K = 202 phase runs it) and beyond shared memory's staging (1000, staged in
# global scratch)
BANDED_CASES = ((3, 8, 10, 4, 5), (4, 9, 8, 4, 4), (3, 10, 11, 5, 4),
                (8, 48, 40, 8, 8), (15, 40, 47, 8, 16), (15, 96, 128, 32, 32),
                (79, 375, 450, BAND, BAND), (97, 48, 40, 8, 8),
                (202, 10, 11, 5, 4), (202, 375, 450, BAND, BAND),
                (300, 40, 47, 8, 16), (1000, 8, 10, 4, 5))
# (K, H, W) of the wavefront sweep's comparisons: the two shapes of the JAX
# package's own kernel test, H > W and W > H beyond one tile of lanes, two
# rows, two columns, K = 15, the main path's shape, and K beyond one pass of
# targets (97, 128, 202, 300; 202 also at teddy's shape) and beyond shared
# memory's staging (1000)
WAVEFRONT_CASES = ((3, 6, 9), (4, 7, 6), (3, 40, 9), (3, 9, 40), (3, 2, 9),
                   (3, 9, 2), (15, 40, 47), FULL, (97, 7, 9), (128, 7, 9),
                   (202, 9, 40), (202, 375, 450), (300, 40, 9), (1000, 7, 9))
# every fused-sweep case runs at each phase-B job width, forced, and chosen
# a step (0), against one plain sweep; teddy's banded steps run from 4 to
# 196 jobs of 32 lanes (thin and busy steps on 132 blocks), and a forced
# narrow width gives several rounds.  The cases with weights a < 0 on a
# third of the pixels (their lanes walk the plain term, the rest the
# hoisted one), by their index in the lists above:
SWEEP_WIDTHS = (0, 32, 16, 8)
BANDED_NEGATIVE = (3, 4, 6, 8)
WAVEFRONT_NEGATIVE = (2, 6, 7, 9)
# the send and pair kernels' comparisons: K in one pass, in several, and
# staged in global scratch, there with more jobs (tiles of 32 lanes or
# pixels) than blocks resident at once (at most 5 blocks of 384 threads on
# each of 132 multiprocessors), so that a block walks several of them
SEND_PAIR_K = (2, 8, 15, 79, 300)
# the phase kernels' further comparisons at 37x53: K not a multiple of a
# thread's 20 targets or of a staged chunk of 32 sources, and K beyond one
# pass of a block's 8 x 20 targets; tol with almost every term truncated,
# and with none
PHASE_K = (3, 17, 41, 97, 202)
PHASE_TOL = (1e-3, 1e6)
# the gathered send's comparisons at a small L: K below one thread's 20 (or,
# split over a cluster, 5) targets, not a multiple of them, beyond one pass
# of a block's targets, and far beyond
SEND_MANY_K = (3, 17, 41, 97, 202, 1000)
GLOBAL_STAGE_K = 1000
GLOBAL_STAGE_JOBS = 2000
# teddy at --grid-step 30: 196 RANSAC + 6 fronto-parallel proposals
GRID_STEP_WIDE, K_WIDE = 30, 202
WIDE_SWEEPS = 8
PLAIN_SWEEPS_WIDE = 2
# example_global: teddy, 14 SegPln proposals, one binary fusion each
GLOBAL_PAIR, GLOBAL_SIZE = "teddy", (375, 450)
# example_simultaneous: baby2, fusion to convergence, then K = 15 on the
# banded schedule, cut from run_simultaneous_torch.py's 3000 sweeps to 64
# with a decode every 16; the first 2 sweeps again through kernel 5's plain
# version, and 8 sweeps each on the checkerboard and wavefront schedules
SIM_PAIR, SIM_SIZE, SIM_K = "baby2", (370, 413), 15
SIM_SWEEPS, SIM_CHECK_EVERY, SIM_MAX_RELGAP = 64, 16, 1e-5
SIM_PLAIN_SWEEPS, SIM_OTHER_SWEEPS = 2, 8
# the schedule race on that problem: sweeps a chunk of each schedule (two
# chunks each), the banded schedule's decodes a chunk, the coarse sweeps of
# the hierarchy race (a check every RACE_CHECK_EVERY) and of the wavefront
# warm start, the host's iterations in each order; curves hold lb <= E and
# never-falling bounds to RACE_RTOL
RACE_CHUNK = dict(checkerboard=16, banded=16, wavefront=4, scanline=1)
RACE_DECODE_EVERY, RACE_COARSE_SWEEPS, RACE_CHECK_EVERY = 8, 32, 16
RACE_WF_COARSE_SWEEPS, RACE_HOST_ITERS, RACE_RTOL = 4, 3, 1e-6
# the scanline schedule on the main path's problem (teddy, K = 79): 4 sweeps
# with a decode every 2, through kernel 4 (4 launches a row: 4 H a sweep);
# then 2 sweeps from the same restart through the plain version
SCAN_SWEEPS, SCAN_CHECK_EVERY, SCAN_PLAIN_SWEEPS = 4, 2, 2
# the host (QPBO) fusion backend: moves of the first teddy NCC proposals on
# both backends from one start; moves of the baby2 global model (improve
# set); sweeps of the serial TRW-S on baby2's K = 15 problem, raster order
HOST_NCC_MOVES, HOST_GLOBAL_MOVES, HOST_TRWS_SWEEPS = 8, 4, 3
# run_second_order.py's default: teddy crop [120:240, 100:280], --max-disp
# 14, connect 4, kernel 1, visibility on, its schedule; SO_FUSIONS fusions
# with visibility (average_over = SO_FUSIONS, so a run of moves that do not
# lower the energy does not stop the loop early), SO_NOVIS_FUSIONS without,
# ojw_stereo's SameUni -> SegPln -> Smooth* at SO_STAGE_FUSIONS a stage,
# and the first SO_CPU_FUSIONS again on the CPU through the port
SO_PAIR, SO_CROP, SO_MAX_DISP = "teddy", (120, 240, 100, 280), 14
SO_SCHEDULE = ("sweep_ftb", "smooth", "fronto", "random")
SO_FUSIONS, SO_NOVIS_FUSIONS, SO_STAGE_FUSIONS, SO_CPU_FUSIONS = 8, 4, 3, 4
# run_render.py's default: teddy crop [120:240, 120:280], 9 levels
RENDER_PAIR, RENDER_CROP, RENDER_LEVELS = "teddy", (120, 240, 120, 280), 9
# utils/checkpoint on the main path's K = 79 checkerboard problem (kernel
# 1): CKPT_SWEEPS straight against half, a checkpoint, a load and half
CKPT_SWEEPS, CKPT_CHECK_EVERY = 8, 4
# narrow (bfloat16) message storage on the main path's K = 79 problem and on
# baby2's K = 15: MD_SWEEPS sweeps of solve and of TRWSRun.run through
# kernel 1, MD_FULL_SWEEPS of solve(compact=False) through kernel 2; lb (and
# on teddy E) within MD_DRIFT of float32 storage (the JAX package's own
# bound), the kernels within MD_RTOL of the plain versions; MD_ROUNDS
# rounds of a sweep of each storage type in turns
MD_SWEEPS, MD_FULL_SWEEPS, MD_ROUNDS = 16, 4, 3
MD_DRIFT, MD_RTOL = 0.03, 1e-6
# the distribution layer on the main path's K = 79 problem: the sharded
# checkerboard solve over PAR_SHARDS column shards of the one card (kernel
# 1), PAR_FULL_SWEEPS of it on the full grid (kernel 2), one fusion move over
# PAR_FUSION_SHARDS shards, the banded stripes (ceil(375 / 128) = 3, one
# block-row each; kernel 4) for PAR_BANDED_SWEEPS with a decode every
# PAR_BANDED_DECODE; run_batch_torch.py's pool with POOL_PAIRS in its 2
# slots; dryrun_multichip(DRYRUN_SHARDS); the two-process solve of a
# synthetic K = 15 problem at teddy's shape over gloo
PAR_SWEEPS, PAR_SHARDS, PAR_FULL_SWEEPS = 8, (2, 3), 2
PAR_FUSION_SHARDS, PAR_FUSION_ITERS = 3, 20
PAR_BANDED_SWEEPS, PAR_BANDED_DECODE = 4, 2
POOL_PAIRS = ("teddy", "teddy", "teddy")
DRYRUN_SHARDS = 4
MULTIHOST_K, MULTIHOST_SWEEPS, MULTIHOST_TIMEOUT = 15, 8, 300


def check(ok, what: str):
    """A failed check ends the run (plain ``assert`` vanishes under -O)."""
    if not ok:
        raise AssertionError(what)


def energy_agrees(schedule: str, ek: float, ep: float) -> bool:
    """A decode's energy through the kernels against the plain versions':
    the banded decode kernel sums it per lane in double, so it agrees with
    the plain decode's float32 sums to rtol 1e-6 (teddy K = 79 reads about
    3e-7); every other schedule decodes in plain PyTorch on both sides, to
    the bit."""
    if schedule == "banded":
        return abs(ek - ep) <= 1e-6 * abs(ep)
    return ek == ep


def say(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def reset_counts():
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def read_counts() -> dict:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def on_card(inp: dict, names) -> list:
    return [torch.as_tensor(inp[k], device=DEV) for k in names]


# ------------------------------------------------------------ 1. build
nvidia_smi = race.nvidia_smi


def ptxas_by_function(log: str) -> dict:
    """ptxas -v output -> {function: its register and spill lines}."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            fn = m.group(1)
        elif fn and ("registers" in ln or "spill" in ln):
            out.setdefault(fn, []).append(ln.split(" : ")[-1].strip())
    return out


def phase_device_and_build():
    smi = nvidia_smi()
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    check(sorted(libs) == ["banded_decode", "banded_kernel", "k2_block",
                           "minplus_pair", "minplus_send", "phase_kernel",
                           "wavefront_kernel"],
          f"built {sorted(libs)}")
    say("device+build", card=smi, torch=torch.__version__,
        cuda=torch.version.cuda, built=sorted(libs), build_seconds=secs,
        ptxas={name: ptxas_by_function(log["ptxas"])
               for name, log in sorted(_build.build_log.items())})
    return smi


# ------------------------------------------- 2. kernels vs plain versions
def phase_kernels_vs_plain() -> dict:
    # the decode kernel is compared in the ``decode`` phase and the K = 2
    # block kernel in the ``k2_block`` phase, which carry their own errors
    # into the ``kernels`` line
    err = {name: 0.0 for name in KERNELS
           if name not in ("decode_banded", "k2_block")}
    cases = phase_vs_plain(err) + send_vs_plain(err)
    cases += banded_sweep_vs_plain(err) + pair_vs_plain(err)
    cases += wavefront_sweep_vs_plain(err)
    say("kernels_vs_plain", cases=cases,
        tolerance="bitwise (float32; the phase kernels also with bfloat16 "
                  "and float16 message storage); the fused sweeps' lower "
                  "bounds rtol 1e-5", max_abs_err=err)
    return err


def narrow(args: list, names, m_dtype) -> list:
    """Phase arguments (in the order of ``names``) with the messages stored
    in ``m_dtype``."""
    return [a.to(m_dtype) if n.startswith("M") else a
            for n, a in zip(names, args)]


def phase_case(err: dict, K: int, H: int, W: int, kernel: int, tol: float,
               seed: int, full_seed: int | None = None,
               negative: bool = False, m_dtype=torch.float32) -> int:
    """Both phase kernels against their plain versions on one problem, bit
    for bit: the compact one on the half-grid of H x W (inputs from
    ``seed``), the full-grid one on H x W with either colour as the source
    (from ``full_seed`` + colour; ``full_seed`` defaults to ``seed``).
    ``negative``: a < 0 on a random third of the pixels; ``m_dtype``: the
    messages' storage."""
    what = (f"K={K}, {H}x{W}, kernel={kernel}, tol={tol}, negative="
            f"{negative}, storage={m_dtype}")
    inp = testing.phase_inputs(seed, K, -(-H // 2), W)
    if negative:
        inp = testing.negate_alphas(inp, seed)
    args = narrow(on_card(inp, COMPACT_ARGS), COMPACT_ARGS, m_dtype)
    got = phase_kernel.phase_messages_compact(*args, tol, kernel)
    torch.cuda.synchronize()
    ref = phase_kernel.phase_messages_compact_ref(*args, tol, kernel)
    for g, r, name in zip(got, ref, ("newM_s", "newM_o", "vmin_s", "vmin_o")):
        err["phase_messages_compact"] = max(err["phase_messages_compact"],
                                            float((g - r).abs().max()))
        check(torch.equal(g, r),
              f"compact kernel != plain version ({name}, {what})")
    full_seed = seed if full_seed is None else full_seed
    for color in (0, 1):
        inp = testing.phase_inputs_full(full_seed + color, K, H, W, color)
        if negative:
            inp = testing.negate_alphas(inp, full_seed + color)
        args = narrow(on_card(inp, FULL_ARGS), FULL_ARGS, m_dtype)
        got = phase_kernel.phase_messages(*args, tol, kernel)
        torch.cuda.synchronize()
        ref = phase_kernel.phase_messages_ref(*args, tol, kernel)
        for g, r, name in zip(got, ref, ("newM", "vmins")):
            err["phase_messages"] = max(err["phase_messages"],
                                        float((g - r).abs().max()))
            check(torch.equal(g, r), f"full-grid kernel != plain version "
                                     f"({name}, {what}, color={color})")
    return 3


def phase_vs_plain(err: dict) -> int:
    """The two phase kernels against their plain versions, bit for bit: K in
    {2, 8, 15, 79} at 37x53 and 375x450 (odd H, ragged edges, border pixels
    with valid = alpha = 0); K in PHASE_K (K not a multiple of a register
    block or of a staged chunk, and K beyond one pass of a block's targets),
    a < 0 on a third of the pixels (the plain term's branch) and tol in
    PHASE_TOL (almost every term truncated, none) at 37x53; and a random,
    non-checkerboard mask for the full-grid kernel (divergent warps).  Then
    the same with bfloat16 message storage (K in {2, 8, 15, 79} at 37x53,
    K = 79 at 375x450, PHASE_K, a < 0, PHASE_TOL) and with float16 at
    37x53, K = 79 and 202."""
    cases = phase_vs_plain_storage(err, torch.float32)
    cases += phase_vs_plain_storage(err, torch.bfloat16)
    for kernel in (1, 2):
        for K in (79, 202):
            cases += phase_case(err, K, 37, 53, kernel,
                                1.1 if kernel == 1 else 0.9, K + 3,
                                m_dtype=torch.float16)
    torch.cuda.empty_cache()
    # a non-checkerboard mask (divergent warps) must still be right
    inp = testing.phase_inputs_full(5, 15, 37, 53)
    inp["src_is_head"] = (np.random.default_rng(0).uniform(
        size=inp["src_is_head"].shape) > 0.5).astype(np.float32)
    args = on_card(inp, FULL_ARGS)
    got = phase_kernel.phase_messages(*args, 1.1, 1)
    ref = phase_kernel.phase_messages_ref(*args, 1.1, 1)
    check(all(torch.equal(g, r) for g, r in zip(got, ref)),
          "full-grid kernel != plain version (random mask)")
    return cases + 1


def phase_vs_plain_storage(err: dict, m_dtype) -> int:
    """``phase_vs_plain``'s problems with the messages stored in
    ``m_dtype``: K in {2, 8, 15, 79} at 37x53 and 375x450 (float32; narrow
    storage K = 79 only there), PHASE_K, a < 0 and PHASE_TOL at 37x53."""
    cases = 0
    for (H, W) in ((37, 53), (375, 450)):
        for K in (2, 8, 15, 79):
            if (H, W) != (37, 53) and K != 79 and m_dtype != torch.float32:
                continue
            for kernel in (1, 2):
                cases += phase_case(err, K, H, W, kernel,
                                    1.1 if kernel == 1 else 0.9, K + H,
                                    full_seed=K + W, m_dtype=m_dtype)
        torch.cuda.empty_cache()
    for kernel in (1, 2):
        tol = 1.1 if kernel == 1 else 0.9
        for K in PHASE_K:
            cases += phase_case(err, K, 37, 53, kernel, tol, K + kernel,
                                m_dtype=m_dtype)
        for K in (17, 79):
            cases += phase_case(err, K, 37, 53, kernel, tol, K + 7,
                                negative=True, m_dtype=m_dtype)
            for t in PHASE_TOL:
                cases += phase_case(err, K, 37, 53, kernel, t, K + 11,
                                    m_dtype=m_dtype)
    torch.cuda.empty_cache()
    return cases


def pair_vs_plain(err: dict) -> int:
    """The min-plus pair kernel against minplus_pair_ref, bit for bit; at
    37x53 also with a < 0 on a third of the pixels (the plain-term branch)
    and with tol in PHASE_TOL."""
    cases = 0
    shapes = [((37, 53), K, None, False) for K in SEND_PAIR_K
              + (GLOBAL_STAGE_K,)]
    shapes += [((375, 450), K, None, False) for K in SEND_PAIR_K]
    shapes += [((200, GLOBAL_STAGE_JOBS * 32 // 200), GLOBAL_STAGE_K, None,
                False)]
    shapes += [((37, 53), K, tol, negative) for K in (17, 79)
               for tol, negative in ((None, True), (PHASE_TOL[0], False),
                                     (PHASE_TOL[1], False))]
    for (H, W), K, tol_case, negative in shapes:
        for kernel in (1, 2):
            inp = list(testing.pair_inputs(K + H + kernel, K, H, W))
            if negative:
                flip = np.random.default_rng(K).uniform(size=(H, W)) < 1 / 3
                inp[4] = np.where(flip, -inp[4], inp[4]).astype(np.float32)
            args = [torch.as_tensor(a, device=DEV) for a in inp]
            tol = (tol_case if tol_case is not None
                   else 1.1 if kernel == 1 else 0.9)
            got = minplus.minplus_pair(*args, tol, kernel)
            torch.cuda.synchronize()
            ref = minplus.minplus_pair_ref(*args, tol, kernel)
            for g, r, what in zip(got, ref, ("msgA", "msgB")):
                err["minplus_pair"] = max(err["minplus_pair"],
                                          float((g - r).abs().max()))
                check(torch.equal(g, r),
                      f"pair kernel != plain version ({what}, K={K}, "
                      f"{H}x{W}, kernel={kernel}, tol={tol}, "
                      f"negative={negative})")
                check(bool(torch.isfinite(g).all()),
                      f"pair kernel: non-finite {what}")
            cases += 1
            del args, got, ref
        torch.cuda.empty_cache()
    return cases


def sweep_problem(seed: int, K: int, H: int, W: int, negative: bool):
    """A fused sweep's random problem on the card; ``negative``: the
    weights of a third of the pixels (in every direction) negated."""
    prob = list(testing.trws_problem(seed, K, H, W, np.float32))
    if negative:
        rng = np.random.default_rng(seed)
        flip = rng.uniform(0, 1, (H, W)) < 1 / 3
        prob[3] = np.where(flip[None], -prob[3], prob[3]).astype(np.float32)
    return [torch.as_tensor(a, device=DEV) for a in prob]


def wavefront_sweep_vs_plain(err: dict) -> int:
    """The fused wavefront sweep kernel against
    wavefront._sweep_steps(use_kernel=False): one sweep from zero messages,
    one from the warm state, at every job width (SWEEP_WIDTHS), each from
    the same state as the plain sweep."""
    cases = 0
    for i, (K, H, W) in enumerate(WAVEFRONT_CASES):
        negative = i in WAVEFRONT_NEGATIVE
        for kernel in (1, 2):
            sk = wavefront._Skewed(
                *sweep_problem(K + H + kernel, K, H, W, negative), kernel,
                1.0)
            M = wavefront.messages_to_groups(
                torch.zeros((4, K, H, W), device=DEV), W)
            for start in ("zero", "warm"):
                ref, lb_ref = wavefront._sweep_steps(
                    sk, (M[0].clone(), M[1].clone()), use_kernel=False)
                for width in SWEEP_WIDTHS:
                    out, lb = wavefront_kernel.sweep_wavefront(
                        sk, (M[0].clone(), M[1].clone()), width)
                    torch.cuda.synchronize()
                    what = (f"K={K}, {H}x{W}, kernel={kernel}, {start}, "
                            f"width={width}, negative={negative}")
                    for name, g, r in zip(("MA", "MB"), out, ref):
                        err["sweep_wavefront"] = max(
                            err["sweep_wavefront"], float((g - r).abs().max()))
                        check(torch.equal(g, r), f"wavefront sweep != plain "
                              f"version ({name}; {what})")
                    rel = abs(float(lb) - float(lb_ref)) / abs(float(lb_ref))
                    check(rel <= 1e-5, f"wavefront sweep's bound {float(lb)} "
                          f"vs {float(lb_ref)} ({what})")
                    cases += 1
                M = out
            del sk, M, ref, out
        torch.cuda.empty_cache()
    return cases


def send_vs_plain(err: dict) -> int:
    """The column send kernel against minplus_send_ref, bit for bit."""
    cases = 0
    shapes = [(K, L, B) for K in SEND_PAIR_K for L in (53, 1536)
              for B in (1, 2)] + [(GLOBAL_STAGE_K, 53, 1),
                                  (GLOBAL_STAGE_K, GLOBAL_STAGE_JOBS * 32, 1)]
    for K, L, B in shapes:
        for kernel in (1, 2):
            args = [torch.as_tensor(a, device=DEV) for a in
                    testing.send_inputs(K + L + B, B, K, L)]
            tol = 1.1 if kernel == 1 else 0.9
            got = minplus.minplus_send(*args, tol, kernel)
            torch.cuda.synchronize()
            ref = send_ref_by_lanes(*args, tol, kernel)
            for g, r, what in zip(got, ref, ("msg", "vmin")):
                err["minplus_send"] = max(err["minplus_send"],
                                          float((g - r).abs().max()))
                check(torch.equal(g, r),
                      f"send kernel != plain version ({what}, K={K}, "
                      f"L={L}, B={B}, kernel={kernel})")
            cases += 1
            del args, got, ref
        torch.cuda.empty_cache()
    # head- and tail-send operand order with broadcast leading axes, as
    # solvers/banded.py calls it
    hs, p, r, alpha = [torch.as_tensor(a, device=DEV)
                       for a in testing.send_inputs(7, 2, 15, 96)]
    for a in ((hs, p, r[:1], alpha), (hs, r[:1], p, alpha)):
        got = minplus.minplus_send(*a, 1.1, 1)
        ref = minplus.minplus_send_ref(*a, 1.1, 1)
        check(all(torch.equal(g, r_) for g, r_ in zip(got, ref)),
              "send kernel != plain version (broadcast batch)")
    return cases + 2 + send_many_vs_plain(err)


def step_problems(seed: int, K: int, schedule: str, L: int | None = None,
                  negative: float = 0.0):
    """The sends of one solver step on the card (testing.send_step_problems):
    by default at teddy's shape, L = 1536 (banded, 128 x 128 blocks) or
    L = 375 (wavefront)."""
    if L is None:
        L = (banded.BandedSpec(*FULL[1:], BAND, BAND).L
             if schedule == "banded" else FULL[1])
    return testing.send_step_problems(
        seed, K, L, schedule, Lp=L if L > 100 else 96, negative=negative,
        to=lambda a: torch.as_tensor(a, device=DEV))


def send_many_vs_plain(err: dict) -> int:
    """The send kernel's gathered launch against minplus_send_many_ref, bit
    for bit: the problems of a banded step at teddy's L (K = 79, 202; one
    tile a block) and of a wavefront step (K = 79; its 48 tiles split over
    clusters), both at L = 53 for K in SEND_MANY_K (clusters; passes); each
    with a < 0 on a third of the lanes and with tol in PHASE_TOL."""
    cases = 0
    shapes = [("banded", 79, None), ("banded", K_WIDE, None),
              ("wavefront", 79, None)]
    shapes += [(sched, K, 53) for K in SEND_MANY_K
               for sched in ("banded", "wavefront")]
    for sched, K, L in shapes:
        for kernel in (1, 2):
            base = 1.1 if kernel == 1 else 0.9
            for tol, negative in ((base, 0.0), (base, 1 / 3),
                                  (PHASE_TOL[0], 0.0), (PHASE_TOL[1], 0.0)):
                problems = step_problems(K + kernel, K, sched, L, negative)
                before = minplus.minplus_send.launches
                got = minplus.minplus_send_many(problems, tol, kernel)
                torch.cuda.synchronize()
                check(minplus.minplus_send.launches == before + 1,
                      "gathered send: not one launch")
                ref = minplus.minplus_send_many_ref(problems, tol, kernel)
                what = (f"{sched} step, K={K}, L={L}, kernel={kernel}, "
                        f"tol={tol}, negative={negative}")
                for q, (g, r) in enumerate(zip(got, ref)):
                    for a, b, name in zip(g, r, ("msg", "vmin")):
                        err["minplus_send"] = max(
                            err["minplus_send"], float((a - b).abs().max()))
                        check(torch.equal(a, b), f"gathered send != plain "
                              f"version ({name} of problem {q}; {what})")
                cases += 1
                del problems, got, ref
        torch.cuda.empty_cache()
    return cases


def send_ref_by_lanes(hs, p, r, alpha, tol, kernel, lanes: int = 256):
    """minplus_send_ref over slices of the lanes (each lane's send is its
    own): the plain version's dense [B, K, K, L] tensor of one call would
    not fit the card at K = 1000 and many lanes."""
    parts = [minplus.minplus_send_ref(hs[..., i:i + lanes],
                                      p[..., i:i + lanes],
                                      r[..., i:i + lanes],
                                      alpha[..., i:i + lanes], tol, kernel)
             for i in range(0, hs.shape[-1], lanes)]
    return tuple(torch.cat(t, dim=-1) for t in zip(*parts))


def clone_state(state):
    MA, MB, S = state
    return MA.clone(), MB.clone(), tuple(s.clone() for s in S)


def state_tensors(state):
    MA, MB, S = state
    return dict(MA=MA, MB=MB, SxL=S[0], SxR=S[1], SyU=S[2], SyD=S[3])


def banded_sweep_vs_plain(err: dict) -> int:
    """The fused sweep kernel against banded._sweep_steps(use_kernel=False):
    one sweep from zero messages, one from the warm state, at every job
    width (SWEEP_WIDTHS), each from the same state as the plain sweep."""
    cases = 0
    for i, (K, H, W, Bh, Bw) in enumerate(BANDED_CASES):
        negative = i in BANDED_NEGATIVE
        for kernel in (1, 2):
            spec = banded.BandedSpec(H, W, Bh, Bw)
            bp = banded._BandedProblem(
                *sweep_problem(K + H + kernel, K, H, W, negative), spec,
                kernel, 1.0)
            state = banded.messages_to_state(
                torch.zeros((4, K, H, W), device=DEV), bp)
            for start in ("zero", "warm"):
                ref, lb_ref = banded._sweep_steps(bp, clone_state(state),
                                                  use_kernel=False)
                for width in SWEEP_WIDTHS:
                    out, lb = banded_kernel.sweep_banded(
                        bp, clone_state(state), width)
                    torch.cuda.synchronize()
                    what = (f"K={K}, {H}x{W}, {Bh}x{Bw}, kernel={kernel}, "
                            f"{start}, width={width}, negative={negative}")
                    for (name, g), r in zip(state_tensors(out).items(),
                                            state_tensors(ref).values()):
                        err["sweep_banded"] = max(err["sweep_banded"],
                                                  float((g - r).abs().max()))
                        check(torch.equal(g, r), f"fused sweep != plain "
                              f"version ({name}; {what})")
                    rel = abs(float(lb) - float(lb_ref)) / abs(float(lb_ref))
                    check(rel <= 1e-5, f"fused sweep's bound {float(lb)} vs "
                          f"{float(lb_ref)} ({what})")
                    cases += 1
                state = out
            del bp, state, ref, out
        torch.cuda.empty_cache()
    return cases


# --------------------------------------------------------- 3. main path
def make_model():
    pair = io.load_pair(PAIR, dtype=np.float32)
    disparities = np.arange(0, MAX_DISP + 1)
    dm = DispMapNCC(pair.images, disparities, kernel=1, unary_weight=40.0,
                    tol=8.0 * (disparities[1] - disparities[0]),
                    maxiter=MAXITER, check_every=CHECK_EVERY, device=DEV)
    dm.solver_chunk = CHECK_EVERY  # one stopping-rule check per chunk
    return dm


def assert_on_card(dm):
    for name, t in vars(dm).items():
        for u in (t if isinstance(t, (list, tuple)) else [t]):
            if isinstance(u, torch.Tensor) and not u.is_cuda:
                raise AssertionError(f"model tensor {name} is not on the card")


def phase_main_path():
    t0 = time.perf_counter()
    dm = make_model()
    H, W = dm.sz
    e_init = dm.energy()
    proposals = grid_proposals(dm, GRID_STEP, MAX_DISP)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    n_prop = len(proposals)
    check((H, W) == EXPECT["size"] and n_prop == EXPECT["proposals"],
          f"unexpected problem size {(H, W)}, {n_prop} proposals")
    check(tuple(dm.ncc.shape) == (MAX_DISP + 1, H, W), "NCC volume shape")

    t0 = time.perf_counter()
    energies = dm.binary_fusion_sweep(proposals, chunk=len(proposals))
    t_fuse = time.perf_counter() - t0
    check(len(energies) == n_prop and np.isfinite(energies).all(),
          "binary fusion trace is not finite")
    check(all(b <= a for a, b in zip([e_init] + energies, energies)),
          "binary fusion trace increased")
    e_iter = dm.energy()

    dm.restart()
    trace = EnergyTrace()
    t0 = time.perf_counter()
    e, lb, iters = dm.simultaneous_fusion(proposals, trace=trace)
    t_sim = time.perf_counter() - t0
    counts = read_counts()

    assert_on_card(dm)
    check(tuple(dm.assignment.shape) == (4, H, W), "assignment shape")
    check(bool(torch.isfinite(dm.assignment).all())
          and bool(torch.isfinite(dm.current_dispmap()).all()),
          "assignment / disparity map not finite")
    check(np.isfinite([e, lb]).all() and lb <= e, f"lb {lb} > E {e}")
    lbs = [s["lower_bound"] for s in trace.samples]
    # float32 sums of ~1e5 terms: allow their rounding when comparing bounds
    slack = 1e-5 * abs(lbs[-1])
    if any(b < a - slack for a, b in zip(lbs, lbs[1:])):
        raise AssertionError(f"lower bound decreased between chunks: {lbs}")
    if any(s["lower_bound"] > s["energy"] for s in trace.samples):
        raise AssertionError("lb > E at a check")
    # every fusion move runs at least one K = 2 block, one launch each
    check(counts["k2_block"] >= n_prop,
          f"{counts['k2_block']} K = 2 block launches for {n_prop} moves")
    if counts["phase_messages_compact"] != 2 * iters or iters == 0:
        raise AssertionError(
            f"compact kernel launches {counts['phase_messages_compact']} != "
            f"2 per sweep x {iters} sweeps")
    # the stored energy is the energy of the stored assignment
    e_stored = dm.energy()
    dm.assignment = dm.assignment
    if abs(dm.energy() - e_stored) > 1e-4 * abs(e_stored):
        raise AssertionError("energy of the decoded assignment disagrees")
    say("main_path", size=[H, W], disparities=MAX_DISP + 1, K=n_prop + 1,
        setup_seconds=t_setup, initial_energy=e_init,
        iterative_energy=e_iter, fusion_moves=n_prop, fusion_seconds=t_fuse,
        simultaneous_energy=e, lower_bound=lb, sweeps=iters,
        simultaneous_seconds=t_sim, lb_trace=lbs,
        energy_trace=trace.energies, launches=counts)

    # the same first sweeps through the plain version, on the card
    out = {}
    for use_kernel in (True, False):
        dm.restart()
        dm.use_kernel = use_kernel
        dm.maxiter = PLAIN_SWEEPS
        t0 = time.perf_counter()
        e8, lb8, it8 = dm.simultaneous_fusion(proposals)
        out[use_kernel] = (e8, lb8, it8, dm.assignment.clone(),
                           time.perf_counter() - t0)
    (ek, lbk, _, ak, tk), (ep, lbp, _, ap, tp) = out[True], out[False]
    if not torch.equal(ak, ap) or ek != ep or lbk != lbp:
        raise AssertionError(
            f"kernel vs plain version after {PLAIN_SWEEPS} sweeps: E {ek} vs "
            f"{ep}, lb {lbk} vs {lbp}, labels equal {torch.equal(ak, ap)}")
    say("main_path_vs_plain", sweeps=PLAIN_SWEEPS, energy=ek, lower_bound=lbk,
        labels_equal=True, kernel_seconds=tk, plain_seconds=tp)
    same_depth = dict(sweeps=iters, energy=e, lower_bound=lb,
                      samples=trace.samples)
    return counts, dm, proposals, same_depth


# ------------------------------------------- 3a. the K = 2 block kernel
def k2_inputs(dm, proposals) -> list:
    """(theta0, theta1, M, V, gamma, valid, cb) of a teddy fusion move, the
    model's labelling against its middle proposal, as binary_fuse builds
    them, with zero messages."""
    H, W = dm.sz
    cur, prop = dm.assignment, dm._tensor(proposals[len(proposals) // 2])
    D0, Q = binary.fusion_problem(cur, prop, dm.normalize)
    return [dm.unary_map(cur).contiguous(), dm.unary_map(prop).contiguous(),
            torch.zeros((4, H, W), device=DEV),
            binary._tables(D0, Q, dm.smooth_weights, dm.smoothness_kernel,
                           dm.tol),
            trws.node_gamma(H, W, torch.float32, device=DEV),
            energy_mod.default_weights(H, W, torch.float32, device=DEV),
            trws.checkerboard(H, W, device=DEV)]


def device_ops(fn) -> int:
    """The device operations (kernels, copies, sets) one call of ``fn``
    makes (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_k2_block(dm, proposals, smi) -> dict:
    """The ``k2_block`` line: the K = 2 block kernel on a teddy fusion move
    (``k2_inputs``), K2_BLOCKS blocks of K2_CHECK_EVERY phase pairs in a row
    against binary._k2_block (messages and labelling bit for bit, bound and
    energy to rtol 1e-5, one launch a block); then the ms a block of the
    kernel and of the plain version in turns (plain, kernel, kernel, plain;
    CUDA events), the card's ms a launch (torch.profiler), the plain
    version's device operations a block, and the bytes bound
    (ops/k2_block.py::block_bytes); returns the ``kernels`` row."""
    H, W = dm.sz
    inp = k2_inputs(dm, proposals)
    before = k2_block.k2_block.launches
    lb_err = e_err = 0.0
    for _ in range(K2_BLOCKS):
        M, lb, z, e = k2_block.k2_block(*inp, K2_CHECK_EVERY)
        rM, rlb, rz, re_ = binary._k2_block(*inp, K2_CHECK_EVERY)
        check(torch.equal(M, rM) and torch.equal(z, rz),
              "K = 2 block kernel: messages or labelling differ from the "
              "plain version")
        lb_err = max(lb_err, abs(float(lb) - float(rlb)) / abs(float(rlb)))
        e_err = max(e_err, abs(float(e) - float(re_)) / abs(float(re_)))
        inp[2] = rM
    check(lb_err <= 1e-5 and e_err <= 1e-5,
          f"K = 2 block kernel: bound off by {lb_err}, energy by {e_err}")
    check(k2_block.k2_block.launches - before == K2_BLOCKS,
          "K = 2 block kernel: not one launch a block")

    def kernel_call():
        k2_block.k2_block(*inp, K2_CHECK_EVERY)

    def plain_call():
        binary._k2_block(*inp, K2_CHECK_EVERY)

    turns = {"plain": [], "kernel": []}
    for _ in range(2):
        for name in ("plain", "kernel", "kernel", "plain"):
            turns[name].append(time_ms(kernel_call, 20) if name == "kernel"
                               else time_ms(plain_call, 3, warmup=1))
    on_device = device_ms(kernel_call, 20, "k2_block_kernel")
    bytes_ms = k2_block.block_bytes(H, W) / PEAK_BYTES * 1e3
    row = dict(ms=statistics.median(turns["kernel"]), device_ms=on_device,
               plain_ms=statistics.median(turns["plain"]), in_turns=turns,
               bound_ms=bytes_ms, bound_by="bytes", bytes_ms=bytes_ms,
               us_per_phase=on_device * 1e3 / (2 * K2_CHECK_EVERY),
               plain_device_ops=device_ops(plain_call),
               kernel_device_ops=device_ops(kernel_call),
               grid=k2_block.k2_block.grid, max_abs_err=e_err,
               lb_rel_err=lb_err, energy_rel_err=e_err,
               shape=dict(H=H, W=W, check_every=K2_CHECK_EVERY),
               blocks_compared=K2_BLOCKS)
    say("k2_block", card=smi, **row)
    del inp
    torch.cuda.empty_cache()
    return row


# -------------------------------------------- 5. main path, banded schedule
def phase_banded_path(dm, proposals, checkerboard: dict) -> dict:
    """The model's default schedule: simultaneous fusion through the fused
    banded sweep kernel, 128 x 128 blocks, same depth as the checkerboard
    run."""
    H, W = dm.sz
    dm.restart()
    dm.schedule, dm.band = "banded", BAND
    dm.use_kernel, dm.maxiter = True, MAXITER
    dm.solver_chunk_banded = CHECK_EVERY  # one stopping-rule check per chunk
    spec = banded.BandedSpec(H, W, min(BAND, H), min(BAND, W))
    trace = EnergyTrace()
    t0 = time.perf_counter()
    e, lb, iters = dm.simultaneous_fusion(proposals, trace=trace)
    t_sim = time.perf_counter() - t0
    counts = read_counts()

    assert_on_card(dm)
    check(tuple(dm.assignment.shape) == (4, H, W), "assignment shape")
    check(bool(torch.isfinite(dm.assignment).all())
          and bool(torch.isfinite(dm.current_dispmap()).all()),
          "assignment / disparity map not finite")
    check(np.isfinite([e, lb]).all() and lb <= e, f"lb {lb} > E {e}")
    lbs = [s["lower_bound"] for s in trace.samples]
    slack = 1e-5 * abs(lbs[-1])
    check(all(b >= a - slack for a, b in zip(lbs, lbs[1:])),
          f"lower bound decreased between chunks: {lbs}")
    check(all(s["lower_bound"] <= s["energy"] for s in trace.samples),
          "lb > E at a check")
    check(iters > 0 and counts["sweep_banded"] == iters,
          f"fused sweep launches {counts['sweep_banded']} != 1 per sweep x "
          f"{iters} sweeps")
    check(counts["decode_banded"] == -(-iters // CHECK_EVERY),
          f"decode launches {counts['decode_banded']} != 1 per check of "
          f"{CHECK_EVERY} sweeps x {iters} sweeps")
    e_stored = dm.energy()
    dm.assignment = dm.assignment
    check(abs(dm.energy() - e_stored) <= 1e-4 * abs(e_stored),
          "energy of the decoded assignment disagrees")
    say("banded_path", size=[H, W], K=len(proposals) + 1,
        blocks=[spec.Bh, spec.Bw], grid=[spec.Gy, spec.Gx], steps=spec.T,
        lanes=spec.L, simultaneous_energy=e, lower_bound=lb, sweeps=iters,
        simultaneous_seconds=t_sim, lb_trace=lbs,
        energy_trace=trace.energies, launches=counts)
    # an observation, not a check: the two schedules at the same depth
    say("schedules_at_same_depth", sweeps=iters,
        checkerboard=dict(energy=checkerboard["energy"],
                          lower_bound=checkerboard["lower_bound"]),
        banded=dict(energy=e, lower_bound=lb))
    check(checkerboard["sweeps"] == iters, "the two runs differ in depth")
    at_depth = dict(sweeps=iters, energy=e, lower_bound=lb,
                    samples=trace.samples)

    # the same first sweeps through the plain version, on the card
    out = {}
    dm.maxiter = dm.check_every = PLAIN_SWEEPS_BANDED
    for use_kernel in (True, False):
        dm.restart()
        dm.use_kernel = use_kernel
        t0 = time.perf_counter()
        e2, lb2, it2 = dm.simultaneous_fusion(proposals)
        out[use_kernel] = (e2, lb2, it2, dm.assignment.clone(),
                           time.perf_counter() - t0)
    dm.use_kernel, dm.check_every = True, CHECK_EVERY
    (ek, lbk, itk, ak, tk), (ep, lbp, _, ap, tp) = out[True], out[False]
    check(itk == PLAIN_SWEEPS_BANDED and torch.equal(ak, ap)
          and energy_agrees("banded", ek, ep)
          and abs(lbk - lbp) <= 1e-5 * abs(lbp),
          f"banded kernel vs plain version after {PLAIN_SWEEPS_BANDED} "
          f"sweeps: E {ek} vs {ep}, lb {lbk} vs {lbp}, labels equal "
          f"{torch.equal(ak, ap)}")
    say("banded_path_vs_plain", sweeps=PLAIN_SWEEPS_BANDED, energy=ek,
        lower_bound=lbk, plain_lower_bound=lbp, labels_equal=True,
        kernel_seconds=tk, plain_seconds=tp)
    return counts, at_depth


# ------------------------------------------ 6. the per-step banded sweep
def phase_steps_path() -> dict:
    """solve_banded(sweep="steps") at teddy K = 79: every send through the
    column send kernel; against its plain version and the fused sweep."""
    K, H, W, sweeps = 79, 375, 450, 1
    spec = banded.BandedSpec(H, W, BAND, BAND)
    prob = [torch.as_tensor(a, device=DEV)
            for a in testing.synthetic_problem(K, H, W)]
    kw = dict(kernel=1, tol=0.02, Bh=BAND, Bw=BAND, maxiter=sweeps,
              max_relgap=0.0)
    t0 = time.perf_counter()
    got = banded.solve_banded(*prob, **kw, sweep="steps")
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    counts = read_counts()
    # per step one launch for its batched interior head-send, its batched
    # interior tail-send and its four seam sends; T forward and T backward
    # steps
    expect = 2 * spec.T * sweeps
    check(expect == banded.sends_per_sweep(spec) * sweeps
          and counts["minplus_send"] == expect,
          f"send kernel launches {counts['minplus_send']} != 1 per step x "
          f"{2 * spec.T} steps x {sweeps} sweeps = {expect}")
    plain = banded.solve_banded(*prob, **kw, sweep="steps", use_kernel=False)
    fused = banded.solve_banded(*prob, **kw, sweep="fused")
    for name, other in (("plain version", plain), ("fused sweep", fused)):
        # the fused sweep's solve decodes through the same kernel
        same_energy = (float(got.energy) == float(other.energy)
                       if other is fused else
                       energy_agrees("banded", float(got.energy),
                                     float(other.energy)))
        check(torch.equal(got.messages, other.messages)
              and torch.equal(got.labels, other.labels) and same_energy,
              f"steps path != {name}")
        rel = (abs(float(got.lower_bound) - float(other.lower_bound))
               / abs(float(other.lower_bound)))
        check(rel <= 1e-5, f"steps path's bound vs {name}: {rel}")
    e, lb = float(got.energy), float(got.lower_bound)
    check(np.isfinite([e, lb]).all() and lb <= e, f"lb {lb} > E {e}")
    say("steps_path", K=K, size=[H, W], blocks=[BAND, BAND], sweeps=sweeps,
        steps=2 * spec.T, sends_per_step=6, launches_per_step=1,
        launches=counts,
        predicted_send_launches=expect, energy=e, lower_bound=lb,
        seconds=t_steps, state_equal="bitwise vs plain and vs fused")
    return counts


# ------------------------------------- 7. the min-plus pair kernel on a path
def phase_from_pairs(gD, gD_shifted, M, Q, D0, alphas, src_is_head, valid,
                     tol, kernel):
    """One full-grid TRW-S phase assembled per direction from minplus_pair,
    as the plain branch of the JAX solver's phase assembles it: the two
    source heights, the pair, select by colour, subtract the minimum, mask
    by ``valid``.  Same contract as phase_kernel.phase_messages."""
    newM, vmins = [], []
    head = src_is_head > 0
    for d in range(4):
        H_A = gD_shifted[d] - M[d]
        H_B = gD - M[d]
        msgA, msgB = minplus.minplus_pair(H_A, H_B, Q[d], D0, alphas[d], tol,
                                          kernel)
        msg = torch.where(head[None], msgB, msgA)
        vmin = torch.min(msg, dim=0).values
        newM.append((msg - vmin[None]) * valid[d][None])
        vmins.append(vmin)
    return torch.stack(newM, 0), torch.stack(vmins, 0)


def phase_pair_path() -> dict:
    """The pair kernel's path at teddy K = 79: a phase per colour through
    four launches of it, against the full-grid phase kernel."""
    (K, H, W), tol, kernel = FULL, 8.0, 1
    inputs = [on_card(testing.phase_inputs_full(7 + color, K, H, W, color),
                      FULL_ARGS) for color in (0, 1)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = [phase_from_pairs(*args, tol, kernel) for args in inputs]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    check(counts["minplus_pair"] == 8,
          f"pair kernel launches {counts['minplus_pair']} != 4 directions x "
          "2 colours")
    for color, (args, (newM, vmins)) in enumerate(zip(inputs, got)):
        refM, refv = phase_kernel.phase_messages(*args, tol, kernel)
        check(torch.equal(newM, refM) and torch.equal(vmins, refv),
              f"phase assembled from pairs != full-grid phase kernel "
              f"(colour {color})")
        check(bool(torch.isfinite(newM).all()), "non-finite messages")
    say("pair_path", K=K, size=[H, W], colours=2, launches=counts,
        seconds=secs, equal="bitwise vs phase_messages (messages and minima)")
    return counts


# --------------------------------------- 8. main path, wavefront schedule
def sample_at(samples, sweeps: int):
    """The (E, lb) a run recorded at its check after ``sweeps`` sweeps."""
    hit = [s for s in samples if s.get("iterations") == sweeps]
    check(len(hit) == 1, f"no check after {sweeps} sweeps in the trace")
    return dict(energy=hit[0]["energy"], lower_bound=hit[0]["lower_bound"])


def phase_wavefront_path(dm, proposals, checkerboard: dict,
                         banded_run: dict) -> dict:
    """Simultaneous fusion through the fused raster-wavefront sweep kernel:
    the same model and proposals, 16 sweeps, a decode every 8."""
    H, W = dm.sz
    dm.restart()
    dm.schedule = "wavefront"
    dm.use_kernel, dm.maxiter = True, MAXITER_WAVEFRONT
    dm.check_every = CHECK_EVERY
    dm.solver_chunk_wavefront = CHECK_EVERY  # one check per chunk
    trace = EnergyTrace()
    reset_counts()
    t0 = time.perf_counter()
    e, lb, iters = dm.simultaneous_fusion(proposals, trace=trace)
    t_sim = time.perf_counter() - t0
    counts = read_counts()

    assert_on_card(dm)
    check(tuple(dm.assignment.shape) == (4, H, W), "assignment shape")
    check(bool(torch.isfinite(dm.assignment).all())
          and bool(torch.isfinite(dm.current_dispmap()).all()),
          "assignment / disparity map not finite")
    check(np.isfinite([e, lb]).all() and lb <= e, f"lb {lb} > E {e}")
    lbs = [s["lower_bound"] for s in trace.samples]
    slack = 1e-5 * abs(lbs[-1])
    check(all(b >= a - slack for a, b in zip(lbs, lbs[1:])),
          f"lower bound decreased between chunks: {lbs}")
    check(all(s["lower_bound"] <= s["energy"] for s in trace.samples),
          "lb > E at a check")
    check(iters == MAXITER_WAVEFRONT
          and counts["sweep_wavefront"] == MAXITER_WAVEFRONT,
          f"wavefront sweep launches {counts['sweep_wavefront']} != 1 per "
          f"sweep x {MAXITER_WAVEFRONT} sweeps (ran {iters})")
    e_stored = dm.energy()
    dm.assignment = dm.assignment
    check(abs(dm.energy() - e_stored) <= 1e-4 * abs(e_stored),
          "energy of the decoded assignment disagrees")
    say("wavefront_path", size=[H, W], K=len(proposals) + 1,
        steps=2 * (H + W - 1), simultaneous_energy=e, lower_bound=lb,
        sweeps=iters, simultaneous_seconds=t_sim, lb_trace=lbs,
        energy_trace=trace.energies, launches=counts)
    # an observation, not a check: the three schedules after as many sweeps
    say("schedules_at_wavefront_depth", sweeps=iters,
        checkerboard=sample_at(checkerboard["samples"], iters),
        banded=sample_at(banded_run["samples"], iters),
        wavefront=sample_at(trace.samples, iters))

    # the same first sweeps through the plain version, on the card
    out = {}
    dm.maxiter = dm.check_every = PLAIN_SWEEPS_WAVEFRONT
    for use_kernel in (True, False):
        dm.restart()
        dm.use_kernel = use_kernel
        t0 = time.perf_counter()
        e2, lb2, it2 = dm.simultaneous_fusion(proposals)
        out[use_kernel] = (e2, lb2, it2, dm.assignment.clone(),
                           time.perf_counter() - t0)
    dm.use_kernel, dm.check_every = True, CHECK_EVERY
    (ek, lbk, itk, ak, tk), (ep, lbp, _, ap, tp) = out[True], out[False]
    check(itk == PLAIN_SWEEPS_WAVEFRONT and torch.equal(ak, ap) and ek == ep
          and abs(lbk - lbp) <= 1e-5 * abs(lbp),
          f"wavefront kernel vs plain version after {PLAIN_SWEEPS_WAVEFRONT} "
          f"sweeps: E {ek} vs {ep}, lb {lbk} vs {lbp}, labels equal "
          f"{torch.equal(ak, ap)}")
    say("wavefront_path_vs_plain", sweeps=PLAIN_SWEEPS_WAVEFRONT, energy=ek,
        lower_bound=lbk, plain_lower_bound=lbp, labels_equal=True,
        kernel_seconds=tk, plain_seconds=tp)
    return counts


# ------------------------------------------ 15. the scanline schedule
def phase_scanline_path(dm, proposals) -> dict:
    """Simultaneous fusion under the scanline schedule on the main path's
    problem: SCAN_SWEEPS sweeps, a decode every SCAN_CHECK_EVERY, every row
    phase's sends in one launch of the column send kernel (4 H a sweep);
    then SCAN_PLAIN_SWEEPS sweeps from the same restart through the kernel
    and through the plain version: labels and energy equal, bounds within
    1e-5.  Returns the launch counts of the first run."""
    H, W = dm.sz
    dm.restart()
    dm.schedule = "scanline"
    dm.use_kernel, dm.maxiter = True, SCAN_SWEEPS
    dm.check_every = dm.solver_chunk_scanline = SCAN_CHECK_EVERY
    trace = EnergyTrace()
    reset_counts()
    t0 = time.perf_counter()
    e, lb, iters = dm.simultaneous_fusion(proposals, trace=trace)
    torch.cuda.synchronize()
    t_sim = time.perf_counter() - t0
    counts = read_counts()

    assert_on_card(dm)
    check(tuple(dm.assignment.shape) == (4, H, W)
          and bool(torch.isfinite(dm.assignment).all()),
          "assignment not a finite [4, H, W]")
    check(np.isfinite([e, lb]).all() and lb <= e, f"lb {lb} > E {e}")
    lbs = [s["lower_bound"] for s in trace.samples]
    check(all(b >= a - 1e-5 * abs(lbs[-1]) for a, b in zip(lbs, lbs[1:])),
          f"lower bound decreased between chunks: {lbs}")
    check(all(s["lower_bound"] <= s["energy"] for s in trace.samples),
          "lb > E at a check")
    check(iters == SCAN_SWEEPS
          and counts["minplus_send"] == 4 * H * SCAN_SWEEPS,
          f"scanline: {counts['minplus_send']} launches of minplus_send in "
          f"{iters} sweeps, expected 4 x {H} a sweep")
    e_stored = dm.energy()
    dm.assignment = dm.assignment
    check(abs(dm.energy() - e_stored) <= 1e-4 * abs(e_stored),
          "energy of the decoded assignment disagrees")
    say("scanline_path", size=[H, W], K=len(proposals) + 1,
        simultaneous_energy=e, lower_bound=lb, sweeps=iters,
        check_every=SCAN_CHECK_EVERY, simultaneous_seconds=t_sim,
        lb_trace=lbs, energy_trace=trace.energies, launches=counts)

    out = {}
    dm.maxiter = dm.check_every = SCAN_PLAIN_SWEEPS
    dm.solver_chunk_scanline = SCAN_PLAIN_SWEEPS
    for use_kernel in (True, False):
        dm.restart()
        dm.use_kernel = use_kernel
        t0 = time.perf_counter()
        e2, lb2, it2 = dm.simultaneous_fusion(proposals)
        torch.cuda.synchronize()
        out[use_kernel] = (e2, lb2, it2, dm.assignment.clone(),
                           time.perf_counter() - t0)
    dm.use_kernel, dm.check_every = True, CHECK_EVERY
    (ek, lbk, itk, ak, tk), (ep, lbp, _, ap, tp) = out[True], out[False]
    check(itk == SCAN_PLAIN_SWEEPS and torch.equal(ak, ap) and ek == ep
          and abs(lbk - lbp) <= 1e-5 * abs(lbp),
          f"scanline kernel vs plain version after {SCAN_PLAIN_SWEEPS} "
          f"sweeps: E {ek} vs {ep}, lb {lbk} vs {lbp}, labels equal "
          f"{torch.equal(ak, ap)}")
    say("scanline_path_vs_plain", sweeps=SCAN_PLAIN_SWEEPS, energy=ek,
        lower_bound=lbk, plain_lower_bound=lbp, labels_equal=True,
        kernel_seconds=tk, plain_seconds=tp)
    return counts


# ---------------------------------------- 16. the host fusion backend
class QPBOCalls:
    """Within the block, records each host QPBO solve's unlabelled count
    and each QPBO-I call (the model reaches both through qpbo_host)."""

    def __enter__(self):
        self.unlabelled, self.improve = [], 0
        self._solve, self._improve = qpbo_host.solve, qpbo_host.improve

        def solve(*a, **kw):
            out = self._solve(*a, **kw)
            self.unlabelled.append(out[3])
            return out

        def improve(*a, **kw):
            self.improve += 1
            return self._improve(*a, **kw)

        qpbo_host.solve, qpbo_host.improve = solve, improve
        return self

    def __exit__(self, *exc):
        qpbo_host.solve, qpbo_host.improve = self._solve, self._improve


def host_moves(dm, proposals, backend: str) -> dict:
    """One binary fusion per proposal on ``backend``: the energy after each
    move (float32 sums of ~1e5 terms on the card, so a move may raise it
    by their rounding), the returned bounds, the seconds of each move."""
    dm.fusion_backend = backend
    energies, bounds, secs, unlabelled = [dm.energy()], [], [], []
    with QPBOCalls() as calls:
        for p in proposals:
            n0 = len(calls.unlabelled)
            t0 = time.perf_counter()
            e, lb = dm.binary_fusion(p)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            energies.append(e)
            bounds.append(lb)
            # the move's own solve comes first, QPBO-I's after it
            unlabelled += calls.unlabelled[n0:n0 + 1]
    dm.fusion_backend = "device"
    check(np.isfinite(energies).all() and np.isfinite(bounds).all(),
          f"{backend} moves: energy or bound not finite")
    check(all(b <= a + 1e-6 * abs(a) for a, b in zip(energies,
                                                      energies[1:])),
          f"{backend} moves raised the energy: {energies}")
    check(all(lb <= e + 1e-6 * abs(e) for lb, e in zip(bounds,
                                                        energies[1:])),
          f"{backend} moves: a bound above its energy: {bounds} {energies}")
    check(len(unlabelled) == (len(proposals) if backend == "host" else 0),
          f"{backend} moves made {len(calls.unlabelled)} QPBO solves")
    return dict(energies=energies, lower_bounds=bounds, seconds=secs,
                seconds_per_move=sum(secs) / len(secs),
                unlabelled=unlabelled, improve_calls=calls.improve)


def host_ncc_moves(dm, proposals) -> dict:
    """The first HOST_NCC_MOVES teddy NCC proposals fused one at a time
    with fusion_backend="host" and, from the same start, on the device."""
    dm.restart()
    start = dm.assignment.clone()
    props = proposals[:HOST_NCC_MOVES]
    host = host_moves(dm, props, "host")
    dm.assignment = start
    device = host_moves(dm, props, "device")
    assert_on_card(dm)
    return dict(moves=len(props), host=host, device=device)


def host_global_moves(dm, props) -> dict:
    """HOST_GLOBAL_MOVES host moves of the global model (improve set: QPBO-I
    runs where QPBO leaves nodes unlabelled) from a restart."""
    check(dm.improve, "the global model's improve is not set")
    dm.restart()
    out = host_moves(dm, props[:HOST_GLOBAL_MOVES], "host")
    assert_on_card(dm)
    return out


def serial_trws_sweeps(dm, props) -> dict:
    """trws_host.solve on the model's K-label simultaneous-fusion problem
    (the proposals and the incumbent), raster order, HOST_TRWS_SWEEPS
    sweeps: lb <= E and the bound never falls."""
    t0 = time.perf_counter()
    unary, D0, Q, alphas = race.build_problem(dm, props)
    edges = trws_host.grid_to_edges(unary, D0, Q, alphas)
    t_edges = time.perf_counter() - t0
    H, W = dm.sz
    t0 = time.perf_counter()
    # every sweep runs (max_relgap -inf: no gap test stops it early)
    labels, e, lb, iters, tr = trws_host.solve(
        dm.smoothness_kernel, *edges, dm.tol, trws_host.raster_order(H, W),
        maxiter=HOST_TRWS_SWEEPS, max_relgap=-math.inf, trace=True)
    t_solve = time.perf_counter() - t0
    lbs, es = tr["lower_bound"].tolist(), tr["energy"].tolist()
    check(iters == HOST_TRWS_SWEEPS and np.isfinite(es + lbs).all(),
          f"serial TRW-S: {iters} sweeps, energies {es}, bounds {lbs}")
    check(all(b <= a + 1e-9 * abs(a) for a, b in zip(es, lbs)),
          f"serial TRW-S lb > E: {lbs} {es}")
    check(all(b >= a - 1e-9 * abs(a) for a, b in zip(lbs, lbs[1:])),
          f"serial TRW-S bound fell: {lbs}")
    secs = tr["seconds"].tolist()
    return dict(K=len(unary), nodes=H * W, edges=len(edges[1]),
                sweeps=iters, energies=es, lower_bounds=lbs,
                cumulative_seconds=secs,
                seconds_per_sweep=(secs[-1] - secs[0]) / (iters - 1),
                first_sweep_seconds=secs[0], solve_seconds=t_solve,
                problem_seconds=t_edges)


# --------------------------------------- 9. the per-step wavefront sweep
def phase_wavefront_steps_path() -> dict:
    """solve_wavefront(sweep="steps") at teddy K = 79, one sweep: every send
    through the column send kernel; against the fused sweep."""
    (K, H, W), sweeps = FULL, 1
    T = H + W - 1
    prob = [torch.as_tensor(a, device=DEV)
            for a in testing.synthetic_problem(K, H, W)]
    kw = dict(kernel=1, tol=0.02, maxiter=sweeps, max_relgap=0.0)
    reset_counts()
    t0 = time.perf_counter()
    got = wavefront.solve_wavefront(*prob, **kw, sweep="steps")
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    counts = read_counts()
    # per step one launch for its batched head-send and its batched
    # tail-send (a direction pair each); T forward and T backward steps
    expect = 2 * T * sweeps
    check(expect == wavefront.sends_per_sweep(T) * sweeps
          and counts["minplus_send"] == expect,
          f"send kernel launches {counts['minplus_send']} != 1 per step x "
          f"{2 * T} steps x {sweeps} sweeps = {expect}")
    fused = wavefront.solve_wavefront(*prob, **kw, sweep="fused")
    check(torch.equal(got.messages, fused.messages)
          and torch.equal(got.labels, fused.labels)
          and float(got.energy) == float(fused.energy),
          "steps path != fused sweep")
    rel = (abs(float(got.lower_bound) - float(fused.lower_bound))
           / abs(float(fused.lower_bound)))
    check(rel <= 1e-5, f"steps path's bound vs fused sweep: {rel}")
    e, lb = float(got.energy), float(got.lower_bound)
    # the raster order all but closes the gap of this easy problem in one
    # sweep, so the two float32 sums of ~1e5 terms may cross by their rounding
    check(np.isfinite([e, lb]).all() and lb <= e + 1e-5 * abs(e),
          f"lb {lb} > E {e}")
    say("wavefront_steps_path", K=K, size=[H, W], sweeps=sweeps,
        steps=2 * T, sends_per_step=2, launches_per_step=1,
        launches=counts,
        predicted_send_launches=expect, energy=e, lower_bound=lb,
        seconds=t_steps, state_equal="bitwise vs fused")
    return counts


# ------------------------------ 10. teddy at K = 202 on both fused schedules
def phase_wide_k():
    """DispMapNCC simultaneous fusion over teddy's --grid-step 30 proposals
    (K = 202, beyond one pass of targets) on the banded and the wavefront
    schedule: 8 sweeps and one decode each, through kernels 5 and 6; then
    the first sweeps again through the kernels and through the plain
    version, which must give the same labels and energy."""
    pair = io.load_pair(PAIR, dtype=np.float32)
    disparities = np.arange(0, MAX_DISP + 1)
    dm = DispMapNCC(pair.images, disparities, kernel=1, unary_weight=40.0,
                    tol=8.0 * (disparities[1] - disparities[0]),
                    maxiter=WIDE_SWEEPS, check_every=WIDE_SWEEPS, device=DEV)
    proposals = grid_proposals(dm, GRID_STEP_WIDE, MAX_DISP)
    check(len(proposals) + 1 == K_WIDE,
          f"--grid-step {GRID_STEP_WIDE} gave K = {len(proposals) + 1}")
    runs = {}
    for schedule, name in (("banded", "sweep_banded"),
                           ("wavefront", "sweep_wavefront")):
        dm.restart()
        dm.schedule, dm.band = schedule, BAND
        dm.solver_chunk_banded = dm.solver_chunk_wavefront = WIDE_SWEEPS
        reset_counts()
        t0 = time.perf_counter()
        e, lb, iters = dm.simultaneous_fusion(proposals)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counts()[name]
        check(np.isfinite([e, lb]).all() and lb <= e,
              f"{schedule} at K = {K_WIDE}: lb {lb} > E {e}")
        check(iters == WIDE_SWEEPS and launches == WIDE_SWEEPS,
              f"{schedule} at K = {K_WIDE}: {launches} launches of {name} "
              f"in {iters} sweeps")
        runs[schedule] = dict(energy=e, lower_bound=lb, sweeps=iters,
                              seconds=secs, launches=launches)
        # the first sweeps (one from zero messages, one warm) through the
        # kernel and through its plain version, on the card
        out = {}
        dm.maxiter = dm.check_every = PLAIN_SWEEPS_WIDE
        for use_kernel in (True, False):
            dm.restart()
            dm.use_kernel = use_kernel
            t0 = time.perf_counter()
            e2, lb2, it2 = dm.simultaneous_fusion(proposals)
            out[use_kernel] = (e2, lb2, it2, dm.assignment.clone(),
                               time.perf_counter() - t0)
        dm.use_kernel, dm.maxiter = True, WIDE_SWEEPS
        dm.check_every = WIDE_SWEEPS
        (ek, lbk, itk, ak, tk), (ep, lbp, _, ap, tp) = out[True], out[False]
        check(itk == PLAIN_SWEEPS_WIDE and torch.equal(ak, ap)
              and energy_agrees(schedule, ek, ep)
              and abs(lbk - lbp) <= 1e-5 * abs(lbp),
              f"{schedule} at K = {K_WIDE}, kernel vs plain version after "
              f"{PLAIN_SWEEPS_WIDE} sweeps: E {ek} vs {ep}, lb {lbk} vs "
              f"{lbp}, labels equal {torch.equal(ak, ap)}")
        runs[schedule]["vs_plain"] = dict(
            sweeps=PLAIN_SWEEPS_WIDE, energy=ek, lower_bound=lbk,
            plain_lower_bound=lbp, labels_equal=True, kernel_seconds=tk,
            plain_seconds=tp)
        del out, ak, ap
    say("wide_k", K=K_WIDE, grid_step=GRID_STEP_WIDE, size=list(dm.sz),
        **runs)
    del dm, proposals
    torch.cuda.empty_cache()


# ------------------------------------------- 4. full-grid kernel on a path
def phase_full_grid_path() -> dict:
    results = []
    for (K, H, W, tol, sweeps) in ((8, 96, 128, 0.02, 3),
                                   (79, 375, 450, 0.02, 2)):
        prob = [torch.as_tensor(a, device=DEV)
                for a in testing.synthetic_problem(K, H, W)]
        kw = dict(kernel=1, tol=tol, maxiter=sweeps, max_relgap=0.0,
                  compact=False)
        before = phase_kernel.phase_messages.launches
        got = trws.solve(*prob, **kw)
        launched = phase_kernel.phase_messages.launches - before
        ref = trws.solve(*prob, **kw, use_kernel=False)
        if launched != 2 * sweeps:
            raise AssertionError(f"full-grid kernel launches {launched}")
        if not (torch.equal(got.labels, ref.labels)
                and torch.equal(got.messages, ref.messages)
                and float(got.energy) == float(ref.energy)):
            raise AssertionError(
                f"solve(compact=False) kernel vs plain differ at K={K}")
        e, lb = float(got.energy), float(got.lower_bound)
        check(np.isfinite([e, lb]).all() and lb <= e, f"lb {lb} > E {e}")
        results.append(dict(K=K, size=[H, W], sweeps=sweeps, energy=e,
                            lower_bound=lb, labels_equal=True))
        del prob, got, ref
        torch.cuda.empty_cache()
    counts = read_counts()
    # a small problem against the CPU's plain solve (float32 on both)
    prob_np = testing.synthetic_problem(8, 37, 53, seed=3)
    kw = dict(kernel=1, tol=0.02, maxiter=3, max_relgap=0.0)
    cpu = trws.solve(*[torch.as_tensor(a) for a in prob_np], **kw)
    for compact in (True, False):
        gpu = trws.solve(*[torch.as_tensor(a, device=DEV) for a in prob_np],
                         **kw, compact=compact)
        same = float((gpu.labels.cpu() == cpu.labels).float().mean())
        rel = abs(float(gpu.energy) - float(cpu.energy)) / float(cpu.energy)
        if same < 0.999 or rel > 1e-5:
            raise AssertionError(
                f"card vs CPU solve: labels equal {same}, energy rel {rel}")
    say("full_grid_path", runs=results, launches=counts,
        cpu_reference="labels >= 99.9% equal, energy rtol 1e-5")
    return counts


# ------------------------------- 13. example_global: SegPln on teddy
def segmentation_census(im_ref) -> list:
    """Each of SegPln's 14 segmentations of ``im_ref`` alone: its seconds
    (the mean-shift filter on the card, the merge or the graph-based
    segmentation on the host) and its number of segments."""
    rows = []
    for b, mult in enumerate(segpln_mod.MULTS):
        sp = segpln_mod.SEGMENT_PARAMS * mult
        t0 = time.perf_counter()
        if b < segpln_mod.N_MEAN_SHIFT:
            labels = segmentation.mean_shift(im_ref, int(sp[0]), float(sp[1]),
                                             int(sp[2]), device=DEV)
            kind = dict(method="mean_shift", h_s=int(sp[0]),
                        h_r=float(sp[1]), min_region=int(sp[2]),
                        window_offsets=len(
                            segmentation.window_offsets(int(sp[0]))))
        else:
            labels = segmentation.felzenszwalb(im_ref, 0.0, float(sp[3]),
                                               int(sp[2]))
            kind = dict(method="felzenszwalb", k=float(sp[3]),
                        min_size=int(sp[2]))
        secs = time.perf_counter() - t0
        check(labels.shape == im_ref.shape[:2] and labels.min() >= 1,
              f"segmentation {b}: labels {labels.shape}, min {labels.min()}")
        rows.append(dict(b=b, mult=int(mult), **kind,
                         segments=int(len(np.unique(labels))),
                         seconds=secs))
    return rows


def make_global_model(pair_name: str):
    """DispMapGlobalStereo on a bundled pair, CVPR08 defaults, seed 0, and
    the seconds it took."""
    pair = io.load_pair(pair_name, dtype=np.float32)
    t0 = time.perf_counter()
    dm = DispMapGlobalStereo(pair.images, pair.P, pair.disp_range,
                             pair.disparity_factor, CVPR08Options(), seed=0,
                             device=DEV)
    torch.cuda.synchronize()
    return dm, time.perf_counter() - t0


def check_proposals(dm, props):
    H, W = dm.sz
    check(len(props) == len(segpln_mod.MULTS),
          f"{len(props)} SegPln proposals, expected {len(segpln_mod.MULTS)}")
    for p in props:
        check(tuple(p.shape) == (4, H, W) and p.is_cuda
              and bool(torch.isfinite(p).all()),
              "a SegPln proposal is not a finite [4, H, W] tensor on the card")


def phase_global_path():
    """examples/run_global_torch.py at full size: DispMapGlobalStereo on
    teddy, 14 SegPln proposals, one binary fusion each; the energy never
    rises."""
    dm, t_setup = make_global_model(GLOBAL_PAIR)
    H, W = dm.sz
    check((H, W) == GLOBAL_SIZE, f"teddy is {(H, W)}")
    e_init = dm.energy()
    weight_segments = int(len(np.unique(dm.segments)))
    t0 = time.perf_counter()
    props = dm.segpln(seed=0)
    torch.cuda.synchronize()
    t_segpln = time.perf_counter() - t0
    check_proposals(dm, props)
    energies, t0 = [], time.perf_counter()
    for p in props:
        e, lb = dm.binary_fusion(p)
        energies.append(e)
    torch.cuda.synchronize()
    t_fuse = time.perf_counter() - t0
    check(np.isfinite(energies).all(), "binary fusion energy not finite")
    # the returned energies are float32 sums of ~1.7e5 terms, taken by two
    # routes (keep vs fuse), so a step is allowed their rounding
    trace = [e_init] + energies
    check(all(b <= a + 1e-6 * abs(a) for a, b in zip(trace, trace[1:])),
          f"binary fusion energy rose: {trace}")
    check(energies[-1] < e_init, "SegPln fusion did not lower the energy")
    assert_on_card(dm)
    e_stored = dm.energy()
    dm.assignment = dm.assignment
    check(abs(dm.energy() - e_stored) <= 1e-4 * abs(e_stored),
          "energy of the fused assignment disagrees")
    im_ref = dm.images[0].cpu().numpy()
    census = segmentation_census(im_ref)
    say("global_path", pair=GLOBAL_PAIR, size=[H, W],
        disparities=len(dm.disps), setup_seconds=t_setup,
        segpln_seconds=t_segpln, fusion_seconds=t_fuse,
        fusion_moves=len(props), initial_energy=e_init,
        final_energy=energies[-1], energy_trace=energies,
        weight_segments=weight_segments, segmentations=census)
    del dm, props
    torch.cuda.empty_cache()


# ------------------------- 14. example_simultaneous: baby2 at K = 15
def schedule_vs_plain(dm, props, schedule: str, sweeps: int,
                      kernel_name: str, launches_per_sweep: int) -> dict:
    """``sweeps`` sweeps of simultaneous fusion from a restart under
    ``schedule``, through the kernels and through their plain versions on the
    card: labels equal, energy equal (banded: within 1e-5, energy_agrees),
    bounds within 1e-5; the kernel launches of the first run are
    counted."""
    dm.schedule = schedule
    dm.maxiter = dm.check_every = sweeps
    dm.solver_chunk = dm.solver_chunk_banded = sweeps
    dm.solver_chunk_wavefront = dm.solver_chunk_scanline = sweeps
    out = {}
    for use_kernel in (True, False):
        dm.restart()
        dm.use_kernel = use_kernel
        reset_counts()
        t0 = time.perf_counter()
        e, lb, it = dm.simultaneous_fusion(props)
        torch.cuda.synchronize()
        out[use_kernel] = (e, lb, it, dm.assignment.clone(),
                           time.perf_counter() - t0, read_counts())
    dm.use_kernel = True
    (ek, lbk, itk, ak, tk, ck), (ep, lbp, _, ap, tp, _) = out[True], out[False]
    check(itk == sweeps and ck[kernel_name] == launches_per_sweep * sweeps,
          f"{schedule} at K = {SIM_K}: {ck[kernel_name]} launches of "
          f"{kernel_name} in {itk} sweeps")
    check(torch.equal(ak, ap) and energy_agrees(schedule, ek, ep)
          and abs(lbk - lbp) <= 1e-5 * abs(lbp),
          f"{schedule} at K = {SIM_K}, kernel vs plain version after "
          f"{sweeps} sweeps: E {ek} vs {ep}, lb {lbk} vs {lbp}, labels equal "
          f"{torch.equal(ak, ap)}")
    check(np.isfinite([ek, lbk]).all() and lbk <= ek,
          f"{schedule} at K = {SIM_K}: lb {lbk} > E {ek}")
    return dict(sweeps=sweeps, energy=ek, lower_bound=lbk,
                plain_lower_bound=lbp, labels_equal=True,
                launches={kernel_name: ck[kernel_name]}, kernel_seconds=tk,
                plain_seconds=tp)


def phase_simultaneous_path(smi: str) -> tuple:
    """examples/run_simultaneous_torch.py at full size, cut in depth:
    DispMapGlobalStereo on baby2, 14 SegPln proposals fused to convergence,
    a restart, then simultaneous fusion at K = 15 on the banded schedule
    (SIM_SWEEPS sweeps, a decode every SIM_CHECK_EVERY); the first sweeps
    again through kernel 5's plain version, and a few sweeps on the
    checkerboard (kernel 1) and wavefront (kernel 6) schedules against
    theirs; then narrow message storage on the K = 15 problem
    (``phase_message_dtype_path``).  Returns the launches of kernels 1, 5
    and 6 on this path, the host solvers' lines and the launches of the
    narrow-storage runs."""
    dm, t_setup = make_global_model(SIM_PAIR)
    H, W = dm.sz
    check((H, W) == SIM_SIZE, f"baby2 is {(H, W)}")
    e_init = dm.energy()
    t0 = time.perf_counter()
    props = dm.segpln(seed=0)
    torch.cuda.synchronize()
    t_segpln = time.perf_counter() - t0
    check_proposals(dm, props)

    t0 = time.perf_counter()
    moves = dm.binary_fuse_until_convergence(props, seed=0)
    torch.cuda.synchronize()
    t_iter = time.perf_counter() - t0
    e_iter = dm.energy()
    check(np.isfinite(e_iter) and e_iter < e_init,
          f"fusion to convergence: E {e_iter} from {e_init}")

    dm.restart()
    dm.schedule, dm.band = "banded", BAND
    dm.maxiter, dm.check_every = SIM_SWEEPS, SIM_CHECK_EVERY
    dm.max_relgap = SIM_MAX_RELGAP
    dm.solver_chunk_banded = SIM_CHECK_EVERY  # one stopping-rule check each
    trace = EnergyTrace()
    reset_counts()
    t0 = time.perf_counter()
    e, lb, iters = dm.simultaneous_fusion(props, trace=trace)
    torch.cuda.synchronize()
    t_sim = time.perf_counter() - t0
    counts = read_counts()
    assert_on_card(dm)
    check(tuple(dm.assignment.shape) == (4, H, W)
          and bool(torch.isfinite(dm.assignment).all()),
          "assignment not a finite [4, H, W]")
    check(np.isfinite([e, lb]).all() and lb <= e, f"lb {lb} > E {e}")
    check(all(s["lower_bound"] <= s["energy"] for s in trace.samples),
          "lb > E at a check")
    lbs = [s["lower_bound"] for s in trace.samples]
    check(all(b >= a - 1e-5 * abs(lbs[-1]) for a, b in zip(lbs, lbs[1:])),
          f"lower bound decreased between checks: {lbs}")
    check(iters > 0 and counts["sweep_banded"] == iters,
          f"fused banded sweep launches {counts['sweep_banded']} != 1 per "
          f"sweep x {iters} sweeps")
    e_stored = dm.energy()
    dm.assignment = dm.assignment
    check(abs(dm.energy() - e_stored) <= 1e-4 * abs(e_stored),
          "energy of the decoded assignment disagrees")
    spec = banded.BandedSpec(H, W, min(BAND, H), min(BAND, W))
    say("simultaneous_path", pair=SIM_PAIR, size=[H, W],
        disparities=len(dm.disps), K=len(props) + 1, setup_seconds=t_setup,
        segpln_seconds=t_segpln, initial_energy=e_init,
        iterative_moves=moves - 1, iterative_energy=e_iter,
        iterative_seconds=t_iter, blocks=[spec.Bh, spec.Bw], steps=spec.T,
        simultaneous_energy=e, lower_bound=lb, sweeps=iters,
        check_every=SIM_CHECK_EVERY, max_relgap=SIM_MAX_RELGAP,
        simultaneous_seconds=t_sim, ratio=e / e_iter, lb_trace=lbs,
        energy_trace=trace.energies, launches=counts)

    runs = {"banded": schedule_vs_plain(dm, props, "banded", SIM_PLAIN_SWEEPS,
                                        "sweep_banded", 1)}
    runs["checkerboard"] = schedule_vs_plain(
        dm, props, "checkerboard", SIM_OTHER_SWEEPS,
        "phase_messages_compact", 2)
    runs["wavefront"] = schedule_vs_plain(
        dm, props, "wavefront", SIM_OTHER_SWEEPS, "sweep_wavefront", 1)
    runs["scanline"] = schedule_vs_plain(
        dm, props, "scanline", SIM_OTHER_SWEEPS, "minplus_send", 4 * H)
    say("simultaneous_path_vs_plain", K=len(props) + 1, **runs)
    narrow_counts = phase_message_dtype_path(dm, props, SIM_PAIR, smi,
                                             gate_energy=False)
    host = dict(global_moves=host_global_moves(dm, props),
                trws_host=serial_trws_sweeps(dm, props))
    race_counts = phase_race_path(dm, props, smi)
    del dm, props
    torch.cuda.empty_cache()
    launches = {
        "sweep_banded": counts["sweep_banded"],
        "phase_messages_compact":
            runs["checkerboard"]["launches"]["phase_messages_compact"],
        "sweep_wavefront": runs["wavefront"]["launches"]["sweep_wavefront"],
        "minplus_send": runs["scanline"]["launches"]["minplus_send"]}
    return launches, host, narrow_counts, race_counts


def check_curve(name: str, curve: list, chunks: int):
    """A race curve: ``chunks`` points, each finite with lb <= E, and a
    bound that never falls from one chunk to the next (RACE_RTOL)."""
    check(len(curve) == chunks, f"race {name}: {len(curve)} chunks, "
          f"expected {chunks}")
    for p in curve:
        check(np.isfinite([p["e"], p["lb"]]).all()
              and p["lb"] <= p["e"] + RACE_RTOL * abs(p["e"]),
              f"race {name}: lb > E at {p}")
    for a, b in zip(curve, curve[1:]):
        check(b["lb"] >= a["lb"] - RACE_RTOL * abs(a["lb"]),
              f"race {name}: the bound fell from {a} to {b}")


def phase_race_path(dm, props, smi) -> dict:
    """tools/measure_race_torch.py and tools/measure_wavefront_torch.py at
    small depth on the K = 15 problem of ``dm`` restarted (13a. in the
    module's docstring).  Returns the launches of the kernels on the race's
    path; the plain versions' runs are not counted."""
    t_phase = time.perf_counter()
    dm.restart()
    unary, D0, Q, alphas = race.build_problem(dm, props)
    kernel, tol = dm.smoothness_kernel, dm.tol
    prob = (kernel, tol, unary, D0, Q, alphas)
    H, W = unary.shape[1:]
    curves = {}
    reset_counts()
    for sched, chunk in RACE_CHUNK.items():
        kw = (dict(band=BAND, decode_every=RACE_DECODE_EVERY)
              if sched == "banded" else {})
        curves[sched], _ = race.run_device(*prob, sched, chunk, 2 * chunk,
                                           None, **kw)
        check_curve(sched, curves[sched], 2)
    # the same first chunk again, with its energy as the target: the race
    # stops there, not at its cap of four chunks
    chunk, first = RACE_CHUNK["checkerboard"], curves["checkerboard"][0]
    stopped, _ = race.run_device(*prob, "checkerboard", chunk, 4 * chunk,
                                 first["e"] * (1 + RACE_RTOL))
    check(len(stopped) == 1, f"race: {len(stopped)} chunks to a target "
          "the first chunk reaches")
    # the hierarchy race: its coarse levels through kernel 1 at the
    # pyramid's shapes, then the checkerboard from the upsampled messages
    warm_kw = dict(coarse_sweeps=RACE_COARSE_SWEEPS,
                   check_every=RACE_CHECK_EVERY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = race.hierarchy_warm_start(*prob, **warm_kw)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    curves["hierarchy"], _ = race.run_device(*prob, "checkerboard", chunk,
                                             2 * chunk, None, warm, t_warm)
    check_curve("hierarchy", curves["hierarchy"], 2)
    wf_kw = dict(kernel=kernel, tol=tol, levels=3,
                 coarse_sweeps=RACE_WF_COARSE_SWEEPS)
    t0 = time.perf_counter()
    wf_warm = hierarchy.wavefront_warm_start(unary, D0, Q, alphas, **wf_kw)
    torch.cuda.synchronize()
    t_wf_warm = time.perf_counter() - t0
    counts = read_counts()
    for name in ("phase_messages_compact", "minplus_send", "sweep_banded",
                 "sweep_wavefront"):
        check(counts[name] > 0, f"race: no launch of {name}")
    # both warm starts through the plain versions: kernels 1 and 6 equal
    # them bit for bit, at the coarse shapes too
    warm_plain = race.hierarchy_warm_start(*prob, use_kernel=False,
                                           **warm_kw)
    wf_plain = hierarchy.wavefront_warm_start(unary, D0, Q, alphas,
                                              use_kernel=False, **wf_kw)
    for name, a, b in (("hierarchy", warm, warm_plain),
                       ("wavefront", wf_warm, wf_plain)):
        check(a.shape == (4, *unary.shape) and torch.equal(a, b),
              f"{name} warm start: kernels vs plain versions differ by "
              f"{float((a - b).abs().max())}")
    host = {}
    for order in ("raster", "banded"):
        h = race.run_host(*prob, RACE_HOST_ITERS, -math.inf, order=order,
                          band=BAND)
        es, lbs = h["trace_e"], h["trace_lb"]
        check(h["iters"] == RACE_HOST_ITERS and np.isfinite(es + lbs).all()
              and all(b <= a + 1e-9 * abs(a) for a, b in zip(es, lbs))
              and all(b >= a - 1e-9 * abs(a) for a, b in zip(lbs, lbs[1:])),
              f"host {order}: {h['iters']} iterations, E {es}, lb {lbs}")
        host[order] = dict(energies=es, lower_bounds=lbs,
                           seconds=h["seconds"])
    say("race_path", card=smi, K=len(unary), size=[H, W],
        chunks=RACE_CHUNK, band=BAND, decode_every=RACE_DECODE_EVERY,
        curves=curves, stopped_at=stopped, hierarchy_warm_seconds=t_warm,
        hierarchy_coarse_sweeps=RACE_COARSE_SWEEPS,
        wavefront_warm_seconds=t_wf_warm,
        wavefront_coarse_sweeps=RACE_WF_COARSE_SWEEPS,
        warm_starts_bit_for_bit=True, host=host, launches=counts,
        seconds=time.perf_counter() - t_phase)
    return counts


def model_problem(dm, proposals):
    """The TRW-S problem a model's simultaneous fusion solves over
    ``proposals`` (the incumbent joins as the last label): the positional
    arguments of trws.solve, and its kernel and tol."""
    return (race.build_problem(dm, proposals),
            dict(kernel=dm.smoothness_kernel, tol=dm.tol))


# ----------------------- 17. utils/checkpoint: resume through kernel 1
def phase_checkpoint_path(dm, proposals) -> dict:
    """The main path's K = 79 problem on the checkerboard schedule (the
    compact phase kernel): CKPT_SWEEPS sweeps straight, against half of
    them, an async checkpoint of the messages, a load and the other half
    from the loaded messages (max_relgap 0).  Labels, energy, bound and
    messages must be equal bit for bit.  Returns the launch counts."""
    args, kw = model_problem(dm, proposals)
    kw.update(max_relgap=0.0, check_every=CKPT_CHECK_EVERY)
    half = CKPT_SWEEPS // 2
    reset_counts()
    t0 = time.perf_counter()
    full = trws.solve(*args, maxiter=CKPT_SWEEPS, **kw)
    first = trws.solve(*args, maxiter=half, **kw)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, name="trws", async_save=True)
        t0 = time.perf_counter()
        ck.save(half, {"messages": first.messages, "labels": first.labels,
                       "energy": first.energy,
                       "lower_bound": first.lower_bound})
        ck.wait()
        step, flat = ck.load()
        t_ckpt = time.perf_counter() - t0
        nbytes = sum(a.nbytes for a in flat.values())
    resumed = trws.solve(*args, maxiter=half, **kw,
                         messages=torch.as_tensor(flat["['messages']"],
                                                  device=DEV))
    torch.cuda.synchronize()
    counts = read_counts()
    check(step == half and torch.equal(
        torch.as_tensor(flat["['labels']"], device=DEV), first.labels),
          "the checkpoint did not read back what was saved")
    check(resumed.messages.is_cuda and torch.equal(resumed.labels,
                                                   full.labels)
          and float(resumed.energy) == float(full.energy)
          and float(resumed.lower_bound) == float(full.lower_bound)
          and torch.equal(resumed.messages, full.messages),
          f"resume from the checkpoint differs from the straight run: E "
          f"{float(resumed.energy)} vs {float(full.energy)}, lb "
          f"{float(resumed.lower_bound)} vs {float(full.lower_bound)}")
    expect = 2 * (CKPT_SWEEPS + 2 * half)
    check(counts["phase_messages_compact"] == expect,
          f"{counts['phase_messages_compact']} launches of the compact phase "
          f"kernel, expected {expect}")
    say("checkpoint_path", K=args[0].shape[0], size=list(dm.sz),
        sweeps=CKPT_SWEEPS, resumed_at=half, energy=float(full.energy),
        lower_bound=float(full.lower_bound), bit_for_bit=True,
        checkpoint_bytes=nbytes, save_load_seconds=t_ckpt,
        solve_seconds=t_solve, launches=counts)
    return counts


# ------------------ 16b. narrow message storage (message_dtype)
def sweep_ms_in_turns(args, kw, rounds: int, sweeps: int) -> dict:
    """ms a checkerboard sweep (compact, kernel 1) with float32 and with
    bfloat16 message storage on one problem, in turns: ``rounds`` rounds of
    ``sweeps`` sweeps between two CUDA events each, the order reversed
    every other round; the median of each."""
    runs = {dt: trws.TRWSRun(*args, **kw, message_dtype=dt)
            for dt in (torch.float32, torch.bfloat16)}
    states = {dt: r.init_state() for dt, r in runs.items()}
    times = {dt: [] for dt in runs}
    for r in range(rounds):
        for dt in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            p, M = runs[dt]._p, states[dt]
            p.sweep(M)  # warm: the allocator's blocks for this storage
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(sweeps):
                M, _ = p.sweep(M)
            b.record()
            torch.cuda.synchronize()
            states[dt] = M
            times[dt].append(a.elapsed_time(b) / sweeps)
    return {str(dt).removeprefix("torch."): statistics.median(ms)
            for dt, ms in times.items()}


def phase_message_dtype_path(dm, proposals, pair: str, smi: str,
                             gate_energy: bool = True) -> dict:
    """Narrow message storage on a model's TRW-S problem over its
    proposals: trws.solve and TRWSRun.run with bfloat16 messages, MD_SWEEPS
    sweeps and one decode each, through kernel 1, and MD_FULL_SWEEPS on the
    full grid through kernel 2; each against its plain version on the card
    (messages bit for bit, labels equal, E and lb within MD_RTOL), lb <= E,
    and lb within MD_DRIFT of the same solve with float32 storage, E too
    where ``gate_energy``; then the ms a sweep of both storage types in
    turns.  Returns the launches of the bfloat16 runs.

    ``gate_energy=False`` is for baby2's K = 15 problem, where bfloat16
    storage's decodes stay far above float32's while its bound stays
    within 1% (E 83,482 against 40,209 after 1,024 sweeps,
    tools/measure_message_dtype.py): a property of the storage type, whose
    arithmetic is the JAX package's bit for bit, not of the kernels; its
    drift is printed."""
    args, kw = model_problem(dm, proposals)
    K = args[0].shape[0]
    bf16 = torch.bfloat16
    kw_solve = dict(kw, max_relgap=0.0, maxiter=MD_SWEEPS,
                    check_every=MD_SWEEPS)
    kw_full = dict(kw_solve, maxiter=MD_FULL_SWEEPS,
                   check_every=MD_FULL_SWEEPS, compact=False)
    f32 = trws.solve(*args, **kw_solve)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = trws.solve(*args, **kw_solve, message_dtype=bf16)
    run = trws.TRWSRun(*args, **kw, message_dtype=bf16)
    state, e_run, lb_run, labels_run = run.run(run.init_state(), MD_SWEEPS)
    full = trws.solve(*args, **kw_full, message_dtype=bf16)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    counts = read_counts()
    plain = trws.solve(*args, **kw_solve, message_dtype=bf16,
                       use_kernel=False)
    plain_full = trws.solve(*args, **kw_full, message_dtype=bf16,
                            use_kernel=False)
    torch.cuda.synchronize()

    def close(a, b, rtol) -> bool:
        a, b = float(a), float(b)
        return abs(a - b) <= rtol * abs(b)

    what = f"{pair} K = {K}, bfloat16 storage"
    for name, k, p in (("solve", got, plain), ("solve(compact=False)", full,
                                               plain_full)):
        check(k.messages.dtype == bf16 and p.messages.dtype == bf16,
              f"{what}: {name} messages are {k.messages.dtype}")
        check(torch.equal(k.messages, p.messages)
              and torch.equal(k.labels, p.labels)
              and close(k.energy, p.energy, MD_RTOL)
              and close(k.lower_bound, p.lower_bound, MD_RTOL),
              f"{what}: {name} through the kernel != its plain version: E "
              f"{float(k.energy)} vs {float(p.energy)}, lb "
              f"{float(k.lower_bound)} vs {float(p.lower_bound)}")
        check(float(k.lower_bound) <= float(k.energy),
              f"{what}: {name} lb {float(k.lower_bound)} > E "
              f"{float(k.energy)}")
    check(torch.equal(run.messages(state), got.messages)
          and torch.equal(labels_run, got.labels)
          and close(e_run, got.energy, MD_RTOL)
          and close(lb_run, got.lower_bound, MD_RTOL),
          f"{what}: TRWSRun.run differs from solve")
    drift = {k: abs(float(a) - float(b)) / abs(float(b)) for k, a, b in (
        ("energy", got.energy, f32.energy),
        ("lower_bound", got.lower_bound, f32.lower_bound))}
    check(drift["lower_bound"] <= MD_DRIFT
          and (drift["energy"] <= MD_DRIFT or not gate_energy),
          f"{what}: E {float(got.energy)}, lb {float(got.lower_bound)} "
          f"drift {drift} from float32 storage's {float(f32.energy)}, "
          f"{float(f32.lower_bound)} (bound {MD_DRIFT}, E gated: "
          f"{gate_energy})")
    expect = {"phase_messages_compact": 4 * MD_SWEEPS,
              "phase_messages": 2 * MD_FULL_SWEEPS}
    check(all(counts[n] == c for n, c in expect.items()),
          f"{what}: launches {counts}, expected {expect}")
    ms = sweep_ms_in_turns(args, kw, MD_ROUNDS, MD_SWEEPS)
    say("message_dtype_path", pair=pair, K=K, size=list(dm.sz), card=smi,
        sweeps=MD_SWEEPS, full_grid_sweeps=MD_FULL_SWEEPS,
        energy=float(got.energy), lower_bound=float(got.lower_bound),
        energy_f32=float(f32.energy), lower_bound_f32=float(f32.lower_bound),
        drift=drift, energy_drift_gated=gate_energy,
        energy_full_grid=float(full.energy),
        lower_bound_full_grid=float(full.lower_bound),
        bit_for_bit="messages and labels, kernel vs plain, solve vs "
                    "TRWSRun.run", kernel_seconds=t_kernel,
        ms_per_sweep_in_turns=ms, launches=counts)
    del f32, got, run, state, full, plain, plain_full, args
    torch.cuda.empty_cache()
    return counts


# -------------------------- 17a. the distribution layer (parallel/*)
def on_shards(n: int):
    """n shards of the one card."""
    return [DEV] * n


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def parallel_solve(args, kw, smi) -> dict:
    """sharded_solve over 2 and 3 column shards against trws.solve, bit for
    bit, through kernel 1 (2 launches a sweep a shard); then 2 sweeps on the
    full grid over 2 shards through kernel 2."""
    ref, t_ref = timed(lambda: trws.solve(*args, **kw))
    out = {"one_device_seconds": t_ref}
    launches = {"phase_messages_compact": 0, "phase_messages": 0}
    for n in PAR_SHARDS:
        mesh = mesh_mod.make_mesh(n, devices=on_shards(n))
        reset_counts()
        res, secs = timed(lambda: mesh_mod.sharded_solve(mesh, *args, **kw))
        counts = read_counts()
        check(torch.equal(res.labels, ref.labels)
              and torch.equal(res.messages, ref.messages),
              f"{n} shards: labels or messages differ from one device")
        rel = abs(float(res.energy) - float(ref.energy)) / float(ref.energy)
        check(rel <= 1e-5, f"{n} shards: energy off by {rel}")
        expect = 2 * PAR_SWEEPS * n
        check(counts["phase_messages_compact"] == expect,
              f"{n} shards: {counts['phase_messages_compact']} launches of "
              f"kernel 1, expected {expect}")
        launches["phase_messages_compact"] += expect
        out[f"shards{n}"] = dict(
            seconds=secs, launches=counts, energy=float(res.energy),
            lower_bound=float(res.lower_bound), energy_rel_diff=rel,
            labels_messages="bit for bit")
    fkw = dict(kw, maxiter=PAR_FULL_SWEEPS, check_every=PAR_FULL_SWEEPS,
               compact=False)
    ref = trws.solve(*args, **fkw)
    mesh = mesh_mod.make_mesh(2, devices=on_shards(2))
    reset_counts()
    res, secs = timed(lambda: mesh_mod.sharded_solve(mesh, *args, **fkw))
    counts = read_counts()
    check(torch.equal(res.labels, ref.labels)
          and torch.equal(res.messages, ref.messages),
          "full grid, 2 shards: labels or messages differ from one device")
    check(counts["phase_messages"] == 2 * PAR_FULL_SWEEPS * 2
          and counts["phase_messages_compact"] == 0,
          f"full grid, 2 shards: launches {counts}")
    launches["phase_messages"] = counts["phase_messages"]
    out["full_grid_shards2"] = dict(seconds=secs, sweeps=PAR_FULL_SWEEPS,
                                    launches=counts,
                                    labels_messages="bit for bit")
    say("parallel_solve", card=smi, K=int(args[0].shape[0]),
        size=list(args[0].shape[1:]), sweeps=PAR_SWEEPS, **out)
    return launches


def parallel_fusion(dm, proposals, smi):
    """One fusion move over 3 column shards against binary_fuse (sorted
    verdicts): the take mask and the fused planes bit for bit."""
    cur = dm.assignment
    prop = dm._tensor(proposals[len(proposals) // 2])
    U0, U1 = dm.unary_map(cur), dm.unary_map(prop)
    kw = dict(kernel=dm.smoothness_kernel, tol=dm.tol,
              maxiter=PAR_FUSION_ITERS, max_relgap=0.0)
    D0, Q = binary.fusion_problem(cur, prop, dm.normalize)
    ref, t_ref = timed(lambda: binary.binary_fuse(
        U0, U1, D0, Q, dm.smooth_weights, **kw, accept_method="sort"))
    mesh = mesh_mod.make_mesh(PAR_FUSION_SHARDS,
                              devices=on_shards(PAR_FUSION_SHARDS))
    (fused, take, e, lb), secs = timed(lambda: fusion_dist.sharded_fusion_step(
        mesh, cur, prop, U0, U1, dm.smooth_weights, normalize=dm.normalize,
        **kw))
    check(torch.equal(take, ref.take)
          and torch.equal(fused, energy_mod.fuse_labelling(cur, prop,
                                                           ref.take)),
          "sharded fusion move: take mask or planes differ from one device")
    rel = abs(float(e) - float(ref.energy)) / float(ref.energy)
    check(rel <= 1e-5, f"sharded fusion move: energy off by {rel}")
    say("parallel_fusion", card=smi, shards=PAR_FUSION_SHARDS,
        sweeps=PAR_FUSION_ITERS, taken=int(take.sum()), energy=float(e),
        lower_bound=float(lb), energy_rel_diff=rel, seconds=secs,
        one_device_seconds=t_ref, take_mask="bit for bit")


def parallel_banded(args, kernel, tol, smi) -> int:
    """sharded_banded_run over the gy stripes of 128 x 128 blocks against
    BandedRun(sweep="steps"): labels and messages bit for bit; one launch
    of kernel 4 a step a stripe."""
    K, H, W = args[0].shape
    stripes = -(-H // BAND)
    kw = dict(kernel=kernel, tol=tol, Bh=BAND, Bw=BAND)
    run = banded.BandedRun(*args, **kw, sweep="steps")
    (st, e_ref, _, l_ref), t_ref = timed(lambda: run.run(
        run.init_state(), PAR_BANDED_SWEEPS, PAR_BANDED_DECODE))
    m_ref = run.messages(st)
    del st, run
    mesh = banded_dist.make_y_mesh(stripes, devices=on_shards(stripes))
    reset_counts()
    res, secs = timed(lambda: banded_dist.sharded_banded_run(
        mesh, *args, **kw, sweeps=PAR_BANDED_SWEEPS,
        decode_every=PAR_BANDED_DECODE))
    counts = read_counts()
    T = banded.BandedSpec(H // stripes, W, BAND, BAND).T
    expect = 2 * T * PAR_BANDED_SWEEPS * stripes
    check(torch.equal(res.labels, l_ref),
          "banded stripes: labels differ from one device")
    same_msgs = torch.equal(res.messages, m_ref)
    check(same_msgs, "banded stripes: messages differ from one device")
    check(counts["minplus_send"] == expect,
          f"banded stripes: {counts['minplus_send']} launches of kernel 4, "
          f"expected {expect}")
    rel = abs(float(res.energy) - float(e_ref)) / float(e_ref)
    check(rel <= 1e-5, f"banded stripes: energy off by {rel}")
    say("parallel_banded", card=smi, K=K, size=[H, W], blocks=[BAND, BAND],
        stripes=stripes, steps=2 * T, sweeps=PAR_BANDED_SWEEPS,
        decode_every=PAR_BANDED_DECODE, launches=counts,
        energy=float(res.energy), lower_bound=float(res.lower_bound),
        energy_rel_diff=rel, seconds=secs, one_device_seconds=t_ref,
        labels_messages="bit for bit")
    return expect


def parallel_pool(smi) -> int:
    """run_batch_torch.py's pool (max-disp 30, a fronto-parallel ladder
    every 6, 200 sweeps, a check every 25) with 3 pairs in its 2 slots:
    no pair fails, each within rel 1e-4 of its own solve."""
    a = run_batch_torch.parse(["--pairs", *POOL_PAIRS])
    (mesh, models, props), t_build = timed(lambda: run_batch_torch.build(a))
    singles = []
    for dm_, pr in zip(models, props):
        u, d0, q, al, _ = batch_mod.model_problem(dm_, pr)
        singles.append(float(trws.solve(
            u, d0, q, al, kernel=1, tol=dm_.tol, maxiter=a.maxiter,
            max_relgap=1e-4, check_every=a.check_every).energy))
    reset_counts()
    out, secs = run_batch_torch.run(a, mesh, models, props)
    counts = read_counts()
    for r, e1 in zip(out, singles):
        check(r["status"] in ("converged", "maxiter"), f"pool pair {r}")
        check(abs(r["energy"] - e1) <= 1e-4 * abs(e1),
              f"pool pair {r} against its own solve's E {e1}")
    sweeps = sum(r["iterations"] for r in out)
    check(counts["phase_messages_compact"] == 2 * sweeps,
          f"pool: {counts['phase_messages_compact']} launches of kernel 1 "
          f"for {sweeps} sweeps")
    say("parallel_pool", card=smi, pairs=len(out), slots=a.batch,
        K=len(props[0]) + 1, results=out, own_solve_energies=singles,
        seconds=secs, build_seconds=t_build, launches=counts)
    return counts["phase_messages_compact"]


def parallel_dryrun(smi):
    reset_counts()
    out, secs = timed(lambda: entry.dryrun_multichip(DRYRUN_SHARDS))
    counts = read_counts()
    for name in ("phase_messages_compact", "phase_messages", "minplus_send"):
        check(counts[name] > 0, f"dryrun_multichip launched no {name}")
    say("parallel_dryrun", card=smi, shards=DRYRUN_SHARDS, mesh=out["mesh"],
        seconds=secs, launches=counts)


def parallel_multihost(smi):
    """Two processes on the one card joined over gloo (NCCL refuses two
    ranks on one GPU): the sharded solve of a synthetic problem at teddy's
    shape equals this process's one-device solve."""
    H, W = EXPECT["size"]
    prob = testing.synthetic_problem(MULTIHOST_K, H, W, seed=3)
    kw = dict(kernel=1, tol=0.5, maxiter=MULTIHOST_SWEEPS, max_relgap=0.0,
              check_every=MULTIHOST_SWEEPS)
    ref = trws.solve(*(torch.as_tensor(a, device=DEV) for a in prob), **kw)
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sk.getsockname()[1]}"
    with tempfile.TemporaryDirectory() as d:
        inp, res_path = f"{d}/in.npz", f"{d}/out.npz"
        np.savez(inp, **dict(zip(("theta", "D0", "Q", "alphas"), prob)))
        cmd = [sys.executable, "-m", "stereo_tpu_torch.parallel.multihost",
               "RANK", "2", coord, "--inputs", inp, "--out", res_path,
               "--device", "cuda:0", "--backend", "gloo",
               "--kernel", "1", "--tol", "0.5",
               "--maxiter", str(MULTIHOST_SWEEPS), "--check-every",
               str(MULTIHOST_SWEEPS), "--timeout", str(MULTIHOST_TIMEOUT)]
        root = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        procs = [subprocess.Popen([c if c != "RANK" else str(r)
                                   for c in cmd], cwd=root,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in (1, 0)]
        try:
            outs = [p.communicate(timeout=MULTIHOST_TIMEOUT) for p in procs]
        finally:
            for p in procs:  # only the processes started here
                if p.poll() is None:
                    p.kill()
                    p.wait()
        secs = time.perf_counter() - t0
        for p, (o, e) in zip(procs, outs):
            check(p.returncode == 0,
                  f"multihost worker exit {p.returncode}: {e[-3000:]}")
        got = np.load(res_path)
        info = json.loads(outs[1][0].strip().splitlines()[-1])
        check(np.array_equal(got["solve_labels"], ref.labels.cpu().numpy())
              and np.array_equal(got["solve_messages"],
                                 ref.messages.cpu().numpy()),
              "two processes: labels or messages differ from one process")
    rel = abs(info["solve_energy"] - float(ref.energy)) / float(ref.energy)
    check(rel <= 1e-5, f"two processes: energy off by {rel}")
    launches = json.loads(info["launches"])
    check(launches["phase_messages_compact"] == 2 * MULTIHOST_SWEEPS,
          f"process 0 launched kernel 1 {launches} times")
    say("parallel_multihost", card=smi, processes=2,
        transport=info["transport"], K=MULTIHOST_K, size=[H, W],
        sweeps=MULTIHOST_SWEEPS, energy=info["solve_energy"],
        energy_rel_diff=rel, solve_seconds=info["solve_seconds"],
        seconds_with_start=secs, launches_process0=launches,
        labels_messages="bit for bit")


def phase_parallel_path(dm, proposals, smi) -> dict:
    """The distribution layer on the card: column shards, a sharded fusion
    move, banded stripes, the pool, the dry run and two processes.  Returns
    the launches of kernels 1, 2 and 4 on the sharded runs."""
    dm.restart()
    t0 = time.perf_counter()
    unary, D0, Q, alphas, _ = batch_mod.model_problem(dm, proposals)
    args = (unary, D0, Q, alphas)
    kw = dict(kernel=dm.smoothness_kernel, tol=dm.tol, maxiter=PAR_SWEEPS,
              max_relgap=0.0, check_every=PAR_SWEEPS)
    launches = parallel_solve(args, kw, smi)
    parallel_fusion(dm, proposals, smi)
    launches["minplus_send"] = parallel_banded(args, dm.smoothness_kernel,
                                               dm.tol, smi)
    del unary, D0, Q, alphas, args
    torch.cuda.empty_cache()
    launches["phase_messages_compact_pool"] = parallel_pool(smi)
    parallel_dryrun(smi)
    parallel_multihost(smi)
    say("parallel_path", card=smi, seconds=time.perf_counter() - t0,
        launches=launches)
    return launches


# ------------------- 18. the second-order chain (run_second_order.py)
def second_order_inputs():
    pair = io.load_pair(SO_PAIR)
    y0, y1, x0, x1 = SO_CROP
    images = [im[y0:y1, x0:x1] for im in pair.images]
    P = pair.P.copy()
    P[1, 0, 3] = -0.25  # as run_second_order.py sets it
    return images, P


def check_trace(name: str, energies, moves) -> list:
    """Finite energies; returns the moves where the trace rose by more
    than 1e-6 relative (the fusion guard holds each move against its own
    keep energy, checked here too: a move is taken only when its energy is
    no higher)."""
    check(np.isfinite(energies).all(), f"{name}: energy not finite")
    for fi in moves:
        check(fi["updated"] == 0 or fi["e_move"] <= fi["e_keep"],
              f"{name}: a move was taken above its keep energy: {fi}")
    return [i for i, (a, b) in enumerate(zip(energies, energies[1:]))
            if b > a + 1e-6 * abs(a)]


def recorder(model):
    """A save_progress sink keeping each fusion's stats and field (the
    model calls it after every fusion; what it raises is swallowed, so it
    raises nothing)."""
    moves, fields = [], []

    def sink(it, disp):
        moves.append({k: v for k, v in model.last_fuse_info.items()})
        fields.append(disp)
    return moves, fields, sink


def optimize_checked(name: str, model, iters: int) -> dict:
    reset_counts()
    moves, fields, sink = recorder(model)
    info = {}
    t0 = time.perf_counter()
    energies = model.optimize(schedule=SO_SCHEDULE, max_iters=iters,
                              average_over=iters, info=info,
                              save_progress=sink)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    if info["error"] is not None:
        raise RuntimeError(f"{name}: a fusion failed") from info["error"]
    check(len(energies) == iters + 1 and len(moves) == iters,
          f"{name}: {len(energies) - 1} fusions, expected {iters}")
    rises = check_trace(name, energies, moves)
    check(not rises, f"{name}: the energy rose at moves {rises}: "
          f"{energies}")
    assert_on_card(model)
    check(model.disp.is_cuda and tuple(model.disp.shape) == model.sz
          and bool(torch.isfinite(model.disp).all()),
          f"{name}: the field is not a finite [H, W] tensor on the card")
    return dict(fusions=iters, seconds=secs, seconds_a_fusion=secs / iters,
                t_terms=info["timings"][:, 0].tolist(),
                t_solve=info["timings"][:, 1].tolist(),
                energy_trace=energies,
                updated=info["numbers"][:, 0].tolist(),
                unlabelled=info["numbers"][:, 1].tolist(),
                regions=info["numbers"][:, 2].tolist(), launches=counts,
                fields=fields)


def phase_second_order_path() -> dict:
    """examples/run_second_order_torch.py's default configuration at its
    size: SO_FUSIONS fusions with visibility, SO_NOVIS_FUSIONS without,
    then ojw_stereo's (1, 2, 3) stages (SegPln through
    segpln_scalar_proposals), and the first SO_CPU_FUSIONS fusions again
    on the CPU through the port (printed, not checked).  No kernel of the
    package is on this path: the QPBO runs on the host."""
    images, P = second_order_inputs()
    opts = CVPR08Options(connect=4, smoothness_kernel=1, visibility=True,
                         max_iters=SO_FUSIONS, average_over=SO_FUSIONS,
                         converge=0.0)
    t0 = time.perf_counter()
    dm = SecondOrderStereo(images, P, (0, SO_MAX_DISP), 1, opts, seed=0,
                           device=DEV)
    e_init = dm.energy()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    H, W = dm.sz
    check((H, W) == (SO_CROP[1] - SO_CROP[0], SO_CROP[3] - SO_CROP[2]),
          f"second-order crop is {(H, W)}")
    start = dm._start.copy()
    vis = optimize_checked("second_order visibility", dm, SO_FUSIONS)
    card_fields = vis.pop("fields")

    dm.options = dataclasses.replace(opts, visibility=False)
    dm.restart()
    novis = optimize_checked("second_order no visibility", dm,
                             SO_NOVIS_FUSIONS)
    novis.pop("fields")

    # ojw_stereo: SameUni -> SegPln -> Smooth*, each a fresh optimize
    stage_opts = dataclasses.replace(
        opts, proposal_method=(1, 2, 3), max_iters=SO_STAGE_FUSIONS,
        average_over=SO_STAGE_FUSIONS)
    reset_counts()
    t0 = time.perf_counter()
    model, info = ojw_stereo(images, P, (0, SO_MAX_DISP), 1, stage_opts,
                             seed=0, device=DEV)
    torch.cuda.synchronize()
    t_ojw = time.perf_counter() - t0
    stages = {}
    for name, st in info["stages"].items():
        if st["error"] is not None:
            raise RuntimeError(f"ojw_stereo stage {name}: a fusion failed"
                               ) from st["error"]
        es = st["energy"]
        check(len(es) == SO_STAGE_FUSIONS + 1,
              f"ojw_stereo stage {name}: {len(es) - 1} fusions")
        rises = check_trace(f"ojw_stereo {name}", es, [])
        check(not rises, f"ojw_stereo stage {name}: the energy rose at "
              f"moves {rises}: {es}")
        stages[name] = dict(energy_trace=es,
                            t_terms=st["timings"][:, 0].tolist(),
                            t_solve=st["timings"][:, 1].tolist(),
                            unlabelled=st["numbers"][:, 1].tolist())
    check(list(stages) == ["sameuni", "segpln", "smooth_star"]
          and info["segpln_gen"] == len(segpln_mod.MULTS),
          f"ojw_stereo stages {list(stages)}, "
          f"{info.get('segpln_gen')} SegPln proposals")
    assert_on_card(model)
    ojw_counts = read_counts()

    # the first fusions again on the CPU, from the card model's state
    cpu = convert.second_order_from_numpy(
        images, P, (0, SO_MAX_DISP), 1, opts, segments=dm.seg, start=start,
        device="cpu")
    t0 = time.perf_counter()
    cpu_info = {}
    cpu_es = cpu.optimize(schedule=SO_SCHEDULE, max_iters=SO_CPU_FUSIONS,
                          average_over=SO_CPU_FUSIONS, info=cpu_info)
    t_cpu = time.perf_counter() - t0
    if cpu_info["error"] is not None:
        raise RuntimeError("second_order CPU rerun: a fusion failed"
                           ) from cpu_info["error"]
    card_es = vis["energy_trace"][:SO_CPU_FUSIONS + 1]
    rel = [abs(a - b) / abs(b) for a, b in zip(cpu_es, card_es)]
    same = float(np.mean(cpu.disp.numpy() == card_fields[SO_CPU_FUSIONS - 1]))
    say("second_order_path", pair=SO_PAIR, crop=list(SO_CROP), size=[H, W],
        max_disp=SO_MAX_DISP, connect=4, kernel=1, schedule=SO_SCHEDULE,
        setup_seconds=t_setup, initial_energy=e_init, visibility=vis,
        no_visibility=novis, ojw_stereo=dict(
            proposal_method=[1, 2, 3], fusions_a_stage=SO_STAGE_FUSIONS,
            seconds=t_ojw, segpln_proposals=info["segpln_gen"],
            stages=stages, launches=ojw_counts),
        cpu_rerun=dict(fusions=SO_CPU_FUSIONS, seconds=t_cpu,
                       energy_trace=cpu_es, relative_difference=rel,
                       equal_pixel_share=same))
    del dm, model
    torch.cuda.empty_cache()
    return vis["launches"]


# -------------------------- 19. the renderers (run_render.py)
def phase_render_path() -> dict:
    """examples/run_render_torch.py's default configuration at its size:
    the edge-modes renderer (lb <= E, the image finite, the depth finite
    wherever the pixel has a colour mode — the reference leaves it NaN
    where none exists) and the occlusion renderer (energies finite)."""
    pair = io.load_pair(RENDER_PAIR, dtype=np.float32)
    y0, y1, x0, x1 = RENDER_CROP
    views = [im[y0:y1, x0:x1] for im in pair.images]
    sz = views[0].shape[:2]
    d_max = float(pair.disp_range[1] * pair.disparity_factor)
    P = middle_view_P(abs(pair.P[1, 0, 3]))
    disps = np.linspace(d_max, 0.0, RENDER_LEVELS)

    reset_counts()
    t0 = time.perf_counter()
    res = render_edgemodes(views, P, disps, sz, lam=20.0, thresh=30.0,
                           max_modes=6, maxiter=60, device=DEV)
    torch.cuda.synchronize()
    t_edge = time.perf_counter() - t0
    edge_counts = read_counts()
    check(res.image.is_cuda and tuple(res.image.shape) == (*sz, 3)
          and bool(torch.isfinite(res.image).all()),
          "edgemodes: the image is not a finite [H, W, 3] tensor on the card")
    no_mode = torch.isnan(res.depth)
    check(bool(torch.isfinite(res.depth[~no_mode]).all()),
          "edgemodes: a depth is infinite")
    check(np.isfinite([res.energy, res.lower_bound]).all()
          and res.lower_bound <= res.energy * (1 + 1e-6),
          f"edgemodes: lb {res.lower_bound} > E {res.energy}")

    reset_counts()
    t0 = time.perf_counter()
    occ = render_occl(views, P, disps, sz,
                      OcclRenderOptions(col_thresh=30.0, lambda_=0.02,
                                        num_loops=1, visibility=True),
                      device=DEV)
    torch.cuda.synchronize()
    t_occl = time.perf_counter() - t0
    occl_counts = read_counts()
    check(len(occ.energies) == RENDER_LEVELS - 1
          and np.isfinite(occ.energies).all()
          and np.isfinite(occ.image).all(),
          f"occl: energies {occ.energies}")
    say("render_path", pair=RENDER_PAIR, crop=list(RENDER_CROP),
        size=list(sz), levels=RENDER_LEVELS, edgemodes=dict(
            seconds=t_edge, energy=res.energy, lower_bound=res.lower_bound,
            pixels_without_mode=int(no_mode.sum()), launches=edge_counts),
        occl=dict(seconds=t_occl, energies=occ.energies,
                  unlabelled=occ.unlabelled,
                  visible_share=float(occ.visibility.mean()),
                  launches=occl_counts))
    return dict(edgemodes=edge_counts, occl=occl_counts)


# ------------------------------------------------------------ 5. timings
def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int, kernel_name: str) -> float:
    """Mean time the card spends in one launch of the kernel whose name
    holds ``kernel_name`` (torch.profiler's device-side records): what is
    left of ``time_ms`` when the host's cost of a launch is taken out."""
    from torch.profiler import ProfilerActivity, profile, schedule

    # the calls of the first step go unrecorded, and a trace that still
    # misses launches is taken again (at most three times): a trace's
    # records can lack launches that ran
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        hits = [e for e in prof.key_averages() if kernel_name in e.key
                and e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(e.count for e in hits) == reps:
            break
    check(sum(e.count for e in hits) == reps,
          f"profiler saw {sum(e.count for e in hits)} launches of "
          f"{kernel_name}, expected {reps}")
    return sum(e.self_device_time_total for e in hits) / reps * 1e-3


def bound_of(n_bytes: float, n_ops: float) -> dict:
    """Least time (ms) for work that moves ``n_bytes`` once and does
    ``n_ops`` float32 instructions: the larger of the two at the card's
    published peaks, and which of them it is."""
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    ops_ms = n_ops / PEAK_F32 * 1e3
    return dict(bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def send_bounds(B: int, K: int, L: int) -> dict:
    """Least time of one column send: (4 K + 2) rows of B x L float32 moved
    once against K^2 min-plus steps per lane."""
    return bound_of((4 * K + 2) * B * L * 4, K * K * B * L * OPS_PER_STEP)


def step_bounds(problems, K: int) -> dict:
    """Least time of one gathered send call: each operand read once (one
    read also for an operand that several problems share or that a batch
    broadcasts), msg and vmin written once, against K^2 min-plus steps per
    lane and batch entry."""
    seen, n_bytes, n_ops = set(), 0, 0
    for g, m, xt, ys, alpha in problems:
        lead = torch.broadcast_shapes(g.shape[:-2], m.shape[:-2],
                                      xt.shape[:-2], ys.shape[:-2],
                                      alpha.shape[:-1])
        B, L = math.prod(lead), xt.shape[-1]
        for t in (g, m, xt, ys, alpha):
            if (t.data_ptr(), t.numel()) not in seen:
                seen.add((t.data_ptr(), t.numel()))
                n_bytes += 4 * t.numel()
        n_bytes += 4 * B * (K + 1) * L
        n_ops += B * L * K * K * OPS_PER_STEP
    return bound_of(n_bytes, n_ops)


def sweep_bounds(K: int, pixels: int) -> dict:
    """Least time of one banded sweep.  Bytes, per real pixel: theta, D0
    (K floats each), QA, QB (2 K each) and ten scalars read, MA and MB (2 K
    each) read and written, each counted once (a sweep's two passes read
    them twice; the padding lanes of the skewed columns need not be moved).
    Operations: 8 sends x K^2 min-plus steps per real pixel."""
    return bound_of(pixels * (14 * K + 10) * 4,
                    8 * pixels * K * K * OPS_PER_STEP)


def pair_bounds(K: int, pixels: int) -> dict:
    """Least time of one min-plus pair: (4 K + 1) planes read and 2 K
    written against K^2 label pairs of eight float32 instructions (each
    term is used for both outputs) per pixel."""
    return bound_of((6 * K + 1) * pixels * 4,
                    K * K * pixels * OPS_PER_PAIR_STEP)


def time_wavefront_sweep(K: int, H: int, W: int, reps: int,
                         plain: bool = True, width: int = 0) -> dict:
    """ms per sweep of the fused wavefront kernel (phase-B job width
    ``width``, 0: chosen a step) and (``plain``) of its plain version on a
    synthetic problem of the given shape; the sweeps follow one another on
    one state (a sweep's work does not depend on the data).  The work is a
    banded sweep's (8 sends per pixel, the same arrays), hence its
    bounds."""
    prob = [torch.as_tensor(a, device=DEV)
            for a in testing.synthetic_problem(K, H, W)]
    sk = wavefront._Skewed(*prob, 1, 8.0)
    del prob
    state = [wavefront.messages_to_groups(
        torch.zeros((4, K, H, W), device=DEV), W)]

    def kernel_sweep():
        state[0], _ = wavefront_kernel.sweep_wavefront(sk, state[0], width)

    def plain_sweep():
        state[0], _ = wavefront._sweep_steps(sk, state[0], use_kernel=False)

    ms = time_ms(kernel_sweep, reps)
    plain_ms = time_ms(plain_sweep, 2, warmup=0) if plain else None
    T = H + W - 1
    row = dict(ms=ms, plain_ms=plain_ms, us_per_step=ms * 1e3 / (2 * T),
               shape=dict(K=K, H=H, W=W, T=T, steps=2 * T), width=width,
               grid=wavefront_kernel.sweep_wavefront.grid,
               **sweep_bounds(K, H * W))
    del sk, state
    torch.cuda.empty_cache()
    return row


def time_banded_sweep(K: int, H: int, W: int, reps: int,
                      plain: bool = True, width: int = 0) -> dict:
    """ms per sweep of the fused kernel (phase-B job width ``width``, 0:
    chosen a step) and (``plain``) of its plain version on a synthetic
    problem of the given shape, 128 x 128 blocks; the sweeps follow one
    another on one state (a sweep's work does not depend on the data)."""
    prob = [torch.as_tensor(a, device=DEV)
            for a in testing.synthetic_problem(K, H, W)]
    spec = banded.BandedSpec(H, W, min(BAND, H), min(BAND, W))
    bp = banded._BandedProblem(*prob, spec, 1, 8.0)
    del prob
    state = [banded.messages_to_state(
        torch.zeros((4, K, H, W), device=DEV), bp)]

    def kernel_sweep():
        state[0], _ = banded_kernel.sweep_banded(bp, state[0], width)

    def plain_sweep():
        state[0], _ = banded._sweep_steps(bp, state[0], use_kernel=False)

    ms = time_ms(kernel_sweep, reps)
    plain_ms = time_ms(plain_sweep, 2, warmup=0) if plain else None
    row = dict(ms=ms, plain_ms=plain_ms, us_per_step=ms * 1e3 / (2 * spec.T),
               shape=dict(K=K, H=H, W=W, Bh=spec.Bh, Bw=spec.Bw, T=spec.T,
                          L=spec.L), width=width,
               grid=banded_kernel.sweep_banded.grid,
               **sweep_bounds(K, H * W))
    del bp, state
    torch.cuda.empty_cache()
    return row


def time_decode(K: int, H: int, W: int, reps: int,
                sweeps: int = DECODE_SWEEPS) -> dict:
    """The banded decode kernel on a synthetic problem of the given shape,
    128 x 128 blocks, after ``sweeps`` fused sweeps from zero messages:
    labels bit for bit and the energy to rtol 1e-6 against the plain
    version, both errors kept in the row; the card's ms a launch (torch.profiler), the host clock's
    (CUDA events, the wrapper included), the plain version's, and the bytes
    bound (ops/banded_decode.py::decode_bytes)."""
    prob = [torch.as_tensor(a, device=DEV)
            for a in testing.synthetic_problem(K, H, W)]
    spec = banded.BandedSpec(H, W, min(BAND, H), min(BAND, W))
    bp = banded._BandedProblem(*prob, spec, 1, 8.0)
    del prob
    state = banded.messages_to_state(torch.zeros((4, K, H, W), device=DEV),
                                     bp)
    for _ in range(sweeps):
        state, _ = banded_kernel.sweep_banded(bp, state)
    got, e = banded_decode.decode_banded(bp, state)
    ref, e_ref = banded._decode_state(bp, state)
    e, e_ref = float(e), float(e_ref)
    label_err = int((got.long() - ref.long()).abs().max())
    check(label_err == 0,
          f"decode kernel at K={K} {H}x{W}: {int((got != ref).sum())} "
          "labels differ from the plain version")
    check(energy_agrees("banded", e, e_ref),
          f"decode kernel at K={K} {H}x{W}: energy {e} vs plain {e_ref}")

    def call():
        banded_decode.decode_banded(bp, state)

    ms = time_ms(call, reps)
    on_device = device_ms(call, reps, "banded_decode_kernel")
    plain_ms = time_ms(lambda: banded._decode_state(bp, state), 2, warmup=1)
    bytes_ms = banded_decode.decode_bytes(K, H * W) / PEAK_BYTES * 1e3
    row = dict(ms=ms, device_ms=on_device, plain_ms=plain_ms,
               bound_ms=bytes_ms, bound_by="bytes", bytes_ms=bytes_ms,
               us_per_step=on_device * 1e3 / spec.T,
               grid=banded_decode.decode_banded.grid,
               max_abs_err=abs(e - e_ref), label_max_abs_err=label_err,
               energy_rel_err=abs(e - e_ref) / abs(e_ref),
               energy=e, plain_energy=e_ref,
               shape=dict(K=K, H=H, W=W, Bh=spec.Bh, Bw=spec.Bw, T=spec.T,
                          L=spec.L), sweeps_before=sweeps)
    del bp, state
    torch.cuda.empty_cache()
    return row


def phase_decode(smi: str) -> dict:
    """The ``decode`` line: the decode kernel at the main path's shape
    (teddy, K = 79) and at baby2's K = 15 shape (370 x 413, synthetic
    data); returns the teddy row."""
    teddy = time_decode(*FULL, 20)
    baby2 = time_decode(SIM_K, *SIM_SIZE, 20)
    say("decode", card=smi, teddy_k79=teddy, baby2_k15=baby2)
    return dict(teddy, at_k15=baby2,
                max_abs_err=max(teddy["max_abs_err"], baby2["max_abs_err"]))


def banded_sweep_repeatable(K: int = 79, H: int = 375, W: int = 450):
    """Two fused sweeps at teddy's shape from one warm state give the same
    bits (state and bound): a race between the ready flags and the reads
    they guard would show as a difference."""
    prob = [torch.as_tensor(a, device=DEV)
            for a in testing.synthetic_problem(K, H, W)]
    spec = banded.BandedSpec(H, W, BAND, BAND)
    bp = banded._BandedProblem(*prob, spec, 1, 8.0)
    del prob
    state, _ = banded_kernel.sweep_banded(bp, banded.messages_to_state(
        torch.zeros((4, K, H, W), device=DEV), bp))
    runs = []
    for _ in range(2):
        out, lb = banded_kernel.sweep_banded(bp, clone_state(state))
        torch.cuda.synchronize()
        runs.append((state_tensors(out), float(lb)))
    (a, lb_a), (b, lb_b) = runs
    for name in a:
        check(torch.equal(a[name], b[name]),
              f"two fused sweeps from one state differ ({name})")
    check(lb_a == lb_b, f"two fused sweeps' bounds differ: {lb_a} {lb_b}")
    say("banded_repeatable", K=K, size=[H, W], runs=2, lower_bound=lb_a,
        equal="bitwise (state and bound)")
    del bp, state, runs, a, b
    torch.cuda.empty_cache()


def wavefront_sweep_repeatable(K: int = 79, H: int = 375, W: int = 450):
    """Two fused wavefront sweeps at teddy's shape from one warm state give
    the same bits (state and bound): a race between the ready flags and the
    reads they guard would show as a difference."""
    prob = [torch.as_tensor(a, device=DEV)
            for a in testing.synthetic_problem(K, H, W)]
    sk = wavefront._Skewed(*prob, 1, 8.0)
    del prob
    M, _ = wavefront_kernel.sweep_wavefront(sk, wavefront.messages_to_groups(
        torch.zeros((4, K, H, W), device=DEV), W))
    runs = []
    for _ in range(2):
        out, lb = wavefront_kernel.sweep_wavefront(
            sk, tuple(m.clone() for m in M))
        torch.cuda.synchronize()
        runs.append((out, float(lb)))
    (a, lb_a), (b, lb_b) = runs
    for name, x, y in zip(("MA", "MB"), a, b):
        check(torch.equal(x, y),
              f"two fused wavefront sweeps from one state differ ({name})")
    check(lb_a == lb_b,
          f"two fused wavefront sweeps' bounds differ: {lb_a} {lb_b}")
    say("wavefront_repeatable", K=K, size=[H, W], runs=2, lower_bound=lb_a,
        equal="bitwise (state and bound)")
    del sk, M, runs, a, b
    torch.cuda.empty_cache()


def phase_problems(K: int, H: int, W: int):
    """(name, arguments on the card, their names, shape, bytes moved a pixel
    with float32 and with 2-byte message storage, pixels, sends) of the two
    phase kernels at K labels on an H x W image: the compact one on its
    half-grid (8 sends over ceil(H / 2) x W pixels; (31 K + 24) float32
    planes, of which the 16 K message planes read and written halve in
    2-byte storage), the full-grid one on H x W (one send per direction and
    pixel; (18 K + 13) planes, 8 K of them messages)."""
    Hc = -(-H // 2)
    yield ("phase_messages_compact",
           on_card(testing.phase_inputs(1, K, Hc, W), COMPACT_ARGS),
           COMPACT_ARGS, dict(K=K, Hc=Hc, W=W), 4 * (31 * K + 24),
           92 * K + 96, Hc * W, 8 * Hc * W)
    yield ("phase_messages",
           on_card(testing.phase_inputs_full(1, K, H, W), FULL_ARGS),
           FULL_ARGS, dict(K=K, H=H, W=W), 4 * (18 * K + 13), 56 * K + 52,
           H * W, 4 * H * W)
    torch.cuda.empty_cache()


def time_phase(K: int, H: int, W: int, reps: int = 20,
               plain: bool = True) -> list:
    """Rows of the two phase kernels (``phase_problems``): median ms of
    ``reps`` launches with float32 message storage, the plain versions'
    (``plain``) and the bounds; then the same launches with bfloat16 and
    float16 storage (``ms_bf16``, ``ms_f16``) beside their bounds (the
    bytes fall, the operations do not)."""
    rows = []
    for (name, args, names, shape, px_bytes, px_bytes_narrow, pixels,
         sends) in phase_problems(K, H, W):
        fn = getattr(phase_kernel, name)
        ref = getattr(phase_kernel, name + "_ref")
        ms = time_ms(lambda: fn(*args, 8.0, 1), reps)
        plain_ms = (time_ms(lambda: ref(*args, 8.0, 1), 3, warmup=1)
                    if plain else None)
        n_ops = K * K * sends * OPS_PER_STEP
        row = dict(name=name, ms=ms, plain_ms=plain_ms, shape=shape,
                   **bound_of(px_bytes * pixels, n_ops))
        for m_dtype, key in ((torch.bfloat16, "bf16"),
                             (torch.float16, "f16")):
            nargs = narrow(args, names, m_dtype)
            row["ms_" + key] = time_ms(lambda: fn(*nargs, 8.0, 1), reps)
            del nargs
        nb = bound_of(px_bytes_narrow * pixels, n_ops)
        row.update(bytes_ms_bf16=nb["bytes_ms"], bound_ms_bf16=nb["bound_ms"],
                   bound_by_bf16=nb["bound_by"])
        rows.append(row)
        del args
    return rows


def scanline_phase_problems(K: int, H: int, W: int, seed: int = 1):
    """The sends of a scanline row's two forward phases (6 and 2 problems),
    as solvers/scanline.py gives them to the column send: new belief rows
    [K, W], and message, position and weight rows of padded [.., H+2, W]
    buffers, read through their strides (synthetic data)."""
    g = torch.Generator(device=DEV).manual_seed(seed)

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g, device=DEV) * (hi - lo) + lo

    r = H // 2
    D0 = rand(K, H + 2, W, lo=-3, hi=3)
    Q = rand(4, K, H + 2, W, lo=-3, hi=3)
    M = rand(4, K, H + 2, W)
    a = rand(4, H + 2, W, lo=0.5, hi=2.0)
    gD, gDl, gDr = (rand(K, W, hi=5.0) for _ in range(3))
    LT, RT, UP, DN = 0, 1, 2, 3
    even = [(gD, M[LT, :, r], Q[LT, :, r], D0[:, r], a[LT, r]),
            (gDl, M[LT, :, r], D0[:, r], Q[LT, :, r], a[LT, r]),
            (gD, M[RT, :, r], Q[RT, :, r], D0[:, r], a[RT, r]),
            (gDr, M[RT, :, r], D0[:, r], Q[RT, :, r], a[RT, r]),
            (gD, M[DN, :, r], Q[DN, :, r], D0[:, r], a[DN, r]),
            (gD, M[UP, :, r + 1], D0[:, r + 1], Q[UP, :, r + 1],
             a[UP, r + 1])]
    return even, even[4:]


def time_scanline_sweep(K: int, H: int, W: int, reps: int) -> dict:
    """ms of one scanline sweep (2 H rows, 4 H send launches) through the
    kernel (median of ``reps`` after one) and through the plain version
    (one), on a synthetic problem of the given shape; the sweeps follow one
    another on one state.  The work's bounds are a banded sweep's (8 sends
    per pixel)."""
    prob = [torch.as_tensor(a, device=DEV)
            for a in testing.synthetic_problem(K, H, W)]
    out = {}
    for use_kernel in (True, False):
        rows = scanline._Rows(*prob, 1, 8.0, use_kernel)
        M = [torch.zeros((K, H + 2, W), device=DEV) for _ in range(4)]
        out[use_kernel] = time_ms(lambda: rows.sweep(M),
                                  reps if use_kernel else 1,
                                  warmup=1 if use_kernel else 0)
        del rows, M
    del prob
    torch.cuda.empty_cache()
    return dict(ms=out[True], plain_ms=out[False],
                shape=dict(K=K, H=H, W=W, launches=4 * H),
                **sweep_bounds(K, H * W))


def sweep_rows(name: str, time_sweep, reps15: int, reps202: int) -> dict:
    """A fused sweep at K = 15 on 370 x 413 (the shape of the baby2 pair;
    synthetic data), where a step's fixed cost shows, and at teddy's
    K = 202 (--grid-step 30), each printed as its own line and returned as
    the ``kernels`` row's ``at_k15`` and ``at_k202`` (time, plain version's
    time, bounds)."""
    out = {}
    for key, K, H, W, reps in (("at_k15", SIM_K, *SIM_SIZE, reps15),
                               ("at_k202", K_WIDE, *EXPECT["size"], reps202)):
        row = time_sweep(K, H, W, reps)
        say(f"{name}_k{K}", **row)
        out[key] = {k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "bytes_ms", "ops_ms",
                                        "us_per_step", "grid", "shape")}
    return out


def phase_timings(launches: dict, err: dict, smi: str, k2_row: dict) -> list:
    K, H, W = FULL
    rows = time_phase(K, H, W)
    # the phase kernels at baby2's K = 15 (synthetic data), where the bytes
    # bound them, with each storage type
    say("phase_k15", card=smi, rows=time_phase(SIM_K, *SIM_SIZE,
                                               plain=False))
    # the column send at the shape a banded step gives it: the direction pair
    # of one group, K labels, all L lanes
    B, L = 2, banded.BandedSpec(H, W, BAND, BAND).L
    args = [torch.as_tensor(a, device=DEV)
            for a in testing.send_inputs(1, B, K, L)]
    ms = time_ms(lambda: minplus.minplus_send(*args, 8.0, 1), 50, warmup=5)
    plain = time_ms(lambda: minplus.minplus_send_ref(*args, 8.0, 1), 10)
    # a launch's host cost (wrapper, ctypes, CUDA runtime) exceeds the kernel's
    # time at this size, so the card's own time is reported beside ``ms``
    on_device = device_ms(lambda: minplus.minplus_send(*args, 8.0, 1), 50,
                          "minplus_send_kernel")
    # the one launch of a solver step's sends (synthetic data shaped as the
    # steps give it): host-clock ms, device ms and the bound of the summed
    # work, per schedule
    step = {}
    for sched in ("banded", "wavefront"):
        problems = step_problems(1, K, sched)

        def call():
            minplus.minplus_send_many(problems, 8.0, 1)

        step[sched] = dict(ms=time_ms(call, 50, warmup=5),
                           device_ms=device_ms(call, 50,
                                               "minplus_send_kernel"),
                           bound_ms=step_bounds(problems, K)["bound_ms"])
        del problems
    # the one launch of a scanline row phase at teddy's row (L = W = 450):
    # the forward even phase's 6 problems and the odd phase's 2
    for name, problems in zip(("scanline6", "scanline2"),
                              scanline_phase_problems(K, H, W)):

        def call():
            minplus.minplus_send_many(problems, 8.0, 1)

        step[name] = dict(ms=time_ms(call, 50, warmup=5),
                          device_ms=device_ms(call, 50,
                                              "minplus_send_kernel"),
                          bound_ms=step_bounds(problems, K)["bound_ms"])
    del problems
    torch.cuda.empty_cache()
    say("scanline_phase", card=smi, K=K, lanes=W, **step["scanline6"],
        odd_phase=step["scanline2"])
    rows.append(dict(name="minplus_send", ms=ms, device_ms=on_device,
                     plain_ms=plain, shape=dict(B=B, K=K, L=L),
                     **send_bounds(B, K, L),
                     step_ms={k: v["ms"] for k, v in step.items()},
                     step_device_ms={k: v["device_ms"]
                                     for k, v in step.items()},
                     step_bound_ms={k: v["bound_ms"]
                                    for k, v in step.items()}))
    del args
    # one scanline sweep at the main path's shape and at baby2's K = 15
    say("sweep_scanline_k79", card=smi, **time_scanline_sweep(K, H, W, 2))
    say("sweep_scanline_k15", card=smi,
        **time_scanline_sweep(SIM_K, *SIM_SIZE, 2))
    # the fused sweep at the main path's shape, and at K = 15 on 370 x 413
    # (the shape of the baby2 pair; synthetic data) for the record, and at
    # teddy's K = 202 (--grid-step 30)
    rows.append(dict(name="sweep_banded", **time_banded_sweep(K, H, W, 12),
                     **sweep_rows("sweep_banded", time_banded_sweep, 12, 4)))
    # the pair at the shape one direction of a full-grid phase gives it
    args = [torch.as_tensor(a, device=DEV)
            for a in testing.pair_inputs(1, K, H, W)]
    ms = time_ms(lambda: minplus.minplus_pair(*args, 8.0, 1), 20)
    plain = time_ms(lambda: minplus.minplus_pair_ref(*args, 8.0, 1), 3,
                    warmup=1)
    rows.append(dict(name="minplus_pair", ms=ms, plain_ms=plain,
                     shape=dict(K=K, H=H, W=W), **pair_bounds(K, H * W)))
    del args
    torch.cuda.empty_cache()
    # the fused wavefront sweep at the main path's shape, and at K = 15 on
    # 370 x 413, which separates the per-step fixed cost from the arithmetic
    rows.append(dict(name="sweep_wavefront",
                     **time_wavefront_sweep(K, H, W, 6),
                     **sweep_rows("sweep_wavefront", time_wavefront_sweep, 6,
                                  2)))
    rows.append(dict(name="decode_banded", **phase_decode(smi)))
    rows.append(dict(name="k2_block", **k2_row))
    for r in rows:
        meta = KERNELS[r["name"]]
        r.update(route=meta["route"], source=meta["source"],
                 replaces=meta["replaces"], launches=launches[r["name"]],
                 # no single PyTorch call computes a min-plus phase, a pair,
                 # a column send, a sweep, a decode or a K = 2 block
                 library_ms=None)
        if "max_abs_err" not in r:  # the decode and K = 2 rows keep theirs
            r["max_abs_err"] = err[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} was never launched on "
                                 "its path")
    return rows


def main():
    smi = phase_device_and_build()
    err = phase_kernels_vs_plain()

    reset_counts()
    main_counts, dm, proposals, same_depth = phase_main_path()
    k2_row = phase_k2_block(dm, proposals, smi)
    reset_counts()
    full_counts = phase_full_grid_path()
    reset_counts()
    banded_counts, banded_run = phase_banded_path(dm, proposals, same_depth)
    wavefront_counts = phase_wavefront_path(dm, proposals, same_depth,
                                            banded_run)
    scanline_counts = phase_scanline_path(dm, proposals)
    host_ncc = host_ncc_moves(dm, proposals)
    checkpoint_counts = phase_checkpoint_path(dm, proposals)
    narrow_teddy = phase_message_dtype_path(dm, proposals, PAIR, smi)
    parallel_counts = phase_parallel_path(dm, proposals, smi)
    del dm, proposals
    torch.cuda.empty_cache()
    reset_counts()
    steps_counts = phase_steps_path()
    wavefront_steps_counts = phase_wavefront_steps_path()
    pair_counts = phase_pair_path()
    phase_wide_k()
    banded_sweep_repeatable()
    wavefront_sweep_repeatable()
    phase_global_path()
    baby2_counts, host_baby2, narrow_baby2, race_counts = (
        phase_simultaneous_path(smi))
    say("host_path", card=smi, teddy_ncc=host_ncc, **host_baby2)
    phase_second_order_path()
    phase_render_path()
    launches = {
        "phase_messages_compact": main_counts["phase_messages_compact"],
        "phase_messages": full_counts["phase_messages"],
        "sweep_banded": banded_counts["sweep_banded"],
        # on the two per-step paths together
        "minplus_send": (steps_counts["minplus_send"]
                         + wavefront_steps_counts["minplus_send"]),
        "minplus_pair": pair_counts["minplus_pair"],
        "sweep_wavefront": wavefront_counts["sweep_wavefront"],
        "decode_banded": banded_counts["decode_banded"],
        # the main path's binary fusion sweep, one a block
        "k2_block": main_counts["k2_block"]}

    rows = phase_timings(launches, err, smi, k2_row)
    for r in rows:
        if r["name"] in baby2_counts:
            r["launches_baby2_k15"] = baby2_counts[r["name"]]
            # the schedule race on the same problem (13a.)
            r["launches_race"] = race_counts[r["name"]]
        if r["name"] == "minplus_send":
            r["launches_scanline"] = scanline_counts["minplus_send"]
        if r["name"] == "phase_messages_compact":
            r["launches_checkpoint"] = checkpoint_counts[r["name"]]
            r["launches_pool"] = parallel_counts[
                "phase_messages_compact_pool"]
        if r["name"] in ("phase_messages_compact", "phase_messages",
                         "minplus_send"):
            r["launches_sharded"] = parallel_counts[r["name"]]
        if r["name"] in ("phase_messages_compact", "phase_messages"):
            # bfloat16 storage on teddy K = 79 and on baby2 K = 15
            r["launches_message_dtype"] = (narrow_teddy[r["name"]]
                                           + narrow_baby2[r["name"]])
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
