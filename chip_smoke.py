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
     {1e-3, 1e6}; the column send for K in {2, 8, 15, 79, 300} x kernel x L
     in {53, 1536} x batch in {1, 2}, and K = 1000 (staged in global
     scratch; L = 53 and L = 64,000, more tiles than resident blocks); the
     fused banded sweep on twelve problems up to teddy K = 79 and K = 202
     with 128 x 128 blocks and K in {97, 202, 300, 1000}, one sweep from
     zero messages and one from the warm state (messages and seam arrays bit
     for bit, the lower bound to rtol 1e-5); the min-plus pair for K in {2,
     8, 15, 79, 300} x kernel x {37x53, 375x450} and K = 1000 on 37x53 and
     200x320 (border pixels with alpha = 0); the fused raster-wavefront
     sweep on fourteen problems up to teddy K = 79 and K = 202 and K in
     {97, 128, 202, 300, 1000}, the same two sweeps;
  3. drives the main path at full width: DispMapNCC on data/teddy (375x450,
     51 disparities), 72 RANSAC + 6 fronto-parallel proposals, binary fusion
     sweep over all 78, restart, simultaneous fusion over K = 79 labels with
     checkerboard TRW-S through the compact phase kernel; then repeats the
     first sweeps through the plain version and compares labels and energy;
  4. drives trws.solve(compact=False) through the full-grid phase kernel and
     compares with the plain version;
  5. drives the main path again under the banded schedule (what
     examples/run_ncc_torch.py runs by default): the same model and
     proposals, 128 x 128 blocks, one launch of the fused sweep kernel per
     sweep; then repeats the first sweeps through the plain version;
  6. drives solve_banded(sweep="steps") at the same size through the column
     send kernel and compares with the plain version and the fused sweep;
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
     column send kernel and compares with the fused sweep;
 10. drives DispMapNCC simultaneous fusion at teddy's --grid-step 30
     proposals (K = 202, beyond one pass of a block's targets) on the banded
     and the wavefront schedules, 8 sweeps and one decode each, through
     kernels 5 and 6, and checks lb <= E; then repeats the first two sweeps
     through the plain version and compares labels and energy;
 11. runs each fused sweep (banded and wavefront) twice from one warm state
     at teddy K = 79 and checks that both runs give the same bits (a race
     between the ready flags and the reads they guard would differ);
 12. times every kernel at the teddy K = 79 shape (CUDA events) beside its
     plain version and its byte / operation bounds (the fused sweeps also at
     K = 15 and K = 202, beside their plain versions), and prints the
     ``{"kernels": [...]}`` line.

Every phase prints one JSON line; any failed check raises, so the exit code
is non-zero and the last line is never printed.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False — "
                     "this script runs on an NVIDIA GPU only")

from stereo_tpu_torch import testing  # noqa: E402
from stereo_tpu_torch.models.ncc import (  # noqa: E402
    DispMapNCC, grid_proposals)
from stereo_tpu_torch.ops import (  # noqa: E402
    _build, banded_kernel, minplus, phase_kernel, wavefront_kernel)
from stereo_tpu_torch.solvers import banded, trws, wavefront  # noqa: E402
from stereo_tpu_torch.utils import io  # noqa: E402
from stereo_tpu_torch.utils.metrics import EnergyTrace  # noqa: E402

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
GLOBAL_STAGE_K = 1000
GLOBAL_STAGE_JOBS = 2000
# teddy at --grid-step 30: 196 RANSAC + 6 fronto-parallel proposals
GRID_STEP_WIDE, K_WIDE = 30, 202
WIDE_SWEEPS = 8
PLAIN_SWEEPS_WIDE = 2


def check(ok, what: str):
    """A failed check ends the run (plain ``assert`` vanishes under -O)."""
    if not ok:
        raise AssertionError(what)


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
def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
    check(sorted(libs) == ["banded_kernel", "minplus_pair", "minplus_send",
                           "phase_kernel", "wavefront_kernel"],
          f"built {sorted(libs)}")
    say("device+build", card=smi, torch=torch.__version__,
        cuda=torch.version.cuda, built=sorted(libs), build_seconds=secs,
        ptxas={name: ptxas_by_function(log["ptxas"])
               for name, log in sorted(_build.build_log.items())})
    return smi


# ------------------------------------------- 2. kernels vs plain versions
def phase_kernels_vs_plain() -> dict:
    err = {name: 0.0 for name in KERNELS}
    cases = phase_vs_plain(err) + send_vs_plain(err)
    cases += banded_sweep_vs_plain(err) + pair_vs_plain(err)
    cases += wavefront_sweep_vs_plain(err)
    say("kernels_vs_plain", cases=cases,
        tolerance="bitwise (float32); the fused sweeps' lower bounds rtol "
                  "1e-5", max_abs_err=err)
    return err


def phase_case(err: dict, K: int, H: int, W: int, kernel: int, tol: float,
               seed: int, full_seed: int | None = None,
               negative: bool = False) -> int:
    """Both phase kernels against their plain versions on one problem, bit
    for bit: the compact one on the half-grid of H x W (inputs from
    ``seed``), the full-grid one on H x W with either colour as the source
    (from ``full_seed`` + colour; ``full_seed`` defaults to ``seed``).
    ``negative``: a < 0 on a random third of the pixels."""
    what = f"K={K}, {H}x{W}, kernel={kernel}, tol={tol}, negative={negative}"
    inp = testing.phase_inputs(seed, K, -(-H // 2), W)
    if negative:
        inp = testing.negate_alphas(inp, seed)
    args = on_card(inp, COMPACT_ARGS)
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
        args = on_card(inp, FULL_ARGS)
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
    non-checkerboard mask for the full-grid kernel (divergent warps)."""
    cases = 0
    for (H, W) in ((37, 53), (375, 450)):
        for K in (2, 8, 15, 79):
            for kernel in (1, 2):
                cases += phase_case(err, K, H, W, kernel,
                                    1.1 if kernel == 1 else 0.9, K + H,
                                    full_seed=K + W)
        torch.cuda.empty_cache()
    for kernel in (1, 2):
        tol = 1.1 if kernel == 1 else 0.9
        for K in PHASE_K:
            cases += phase_case(err, K, 37, 53, kernel, tol, K + kernel)
        for K in (17, 79):
            cases += phase_case(err, K, 37, 53, kernel, tol, K + 7,
                                negative=True)
            for t in PHASE_TOL:
                cases += phase_case(err, K, 37, 53, kernel, t, K + 11)
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


def pair_vs_plain(err: dict) -> int:
    """The min-plus pair kernel against minplus_pair_ref, bit for bit."""
    cases = 0
    shapes = [((37, 53), K) for K in SEND_PAIR_K + (GLOBAL_STAGE_K,)]
    shapes += [((375, 450), K) for K in SEND_PAIR_K]
    shapes += [((200, GLOBAL_STAGE_JOBS * 32 // 200), GLOBAL_STAGE_K)]
    for (H, W), K in shapes:
        for kernel in (1, 2):
            args = [torch.as_tensor(a, device=DEV)
                    for a in testing.pair_inputs(K + H + kernel, K, H, W)]
            tol = 1.1 if kernel == 1 else 0.9
            got = minplus.minplus_pair(*args, tol, kernel)
            torch.cuda.synchronize()
            ref = minplus.minplus_pair_ref(*args, tol, kernel)
            for g, r, what in zip(got, ref, ("msgA", "msgB")):
                err["minplus_pair"] = max(err["minplus_pair"],
                                          float((g - r).abs().max()))
                check(torch.equal(g, r),
                      f"pair kernel != plain version ({what}, K={K}, "
                      f"{H}x{W}, kernel={kernel})")
                check(bool(torch.isfinite(g).all()),
                      f"pair kernel: non-finite {what}")
            cases += 1
            del args, got, ref
        torch.cuda.empty_cache()
    return cases


def wavefront_sweep_vs_plain(err: dict) -> int:
    """The fused wavefront sweep kernel against
    wavefront._sweep_steps(use_kernel=False): one sweep from zero messages,
    one from the warm state."""
    cases = 0
    for (K, H, W) in WAVEFRONT_CASES:
        for kernel in (1, 2):
            prob = [torch.as_tensor(a, device=DEV) for a in
                    testing.trws_problem(K + H + kernel, K, H, W, np.float32)]
            sk = wavefront._Skewed(*prob, kernel, 1.0)
            M = wavefront.messages_to_groups(
                torch.zeros((4, K, H, W), device=DEV), W)
            for start in ("zero", "warm"):
                ref, lb_ref = wavefront._sweep_steps(
                    sk, (M[0].clone(), M[1].clone()), use_kernel=False)
                M, lb = wavefront_kernel.sweep_wavefront(sk, M)
                torch.cuda.synchronize()
                what = f"K={K}, {H}x{W}, kernel={kernel}, {start}"
                for name, g, r in zip(("MA", "MB"), M, ref):
                    err["sweep_wavefront"] = max(err["sweep_wavefront"],
                                                 float((g - r).abs().max()))
                    check(torch.equal(g, r),
                          f"wavefront sweep != plain version ({name}; {what})")
                rel = abs(float(lb) - float(lb_ref)) / abs(float(lb_ref))
                check(rel <= 1e-5, f"wavefront sweep's bound {float(lb)} vs "
                      f"{float(lb_ref)} ({what})")
                cases += 1
            del prob, sk, M, ref
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
    return cases + 2


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
    one sweep from zero messages, one from the warm state."""
    cases = 0
    for (K, H, W, Bh, Bw) in BANDED_CASES:
        for kernel in (1, 2):
            prob = [torch.as_tensor(a, device=DEV) for a in
                    testing.trws_problem(K + H + kernel, K, H, W, np.float32)]
            spec = banded.BandedSpec(H, W, Bh, Bw)
            bp = banded._BandedProblem(*prob, spec, kernel, 1.0)
            state = banded.messages_to_state(
                torch.zeros((4, K, H, W), device=DEV), bp)
            for start in ("zero", "warm"):
                ref, lb_ref = banded._sweep_steps(bp, clone_state(state),
                                                  use_kernel=False)
                state, lb = banded_kernel.sweep_banded(bp, state)
                torch.cuda.synchronize()
                what = f"K={K}, {H}x{W}, {Bh}x{Bw}, kernel={kernel}, {start}"
                for (name, g), r in zip(state_tensors(state).items(),
                                        state_tensors(ref).values()):
                    err["sweep_banded"] = max(err["sweep_banded"],
                                              float((g - r).abs().max()))
                    check(torch.equal(g, r),
                          f"fused sweep != plain version ({name}; {what})")
                rel = abs(float(lb) - float(lb_ref)) / abs(float(lb_ref))
                check(rel <= 1e-5, f"fused sweep's bound {float(lb)} vs "
                      f"{float(lb_ref)} ({what})")
                cases += 1
            del prob, bp, state, ref
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
        energy_trace=trace.energies, launches=counts,
        timings=dm.timings.seconds)

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
    check(itk == PLAIN_SWEEPS_BANDED and torch.equal(ak, ap) and ek == ep
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
    # per step one batched interior head-send, one batched interior
    # tail-send and four seam sends; T forward and T backward steps
    expect = 6 * 2 * spec.T * sweeps
    check(expect == banded.sends_per_sweep(spec) * sweeps
          and counts["minplus_send"] == expect,
          f"send kernel launches {counts['minplus_send']} != 6 per step x "
          f"{2 * spec.T} steps x {sweeps} sweeps = {expect}")
    plain = banded.solve_banded(*prob, **kw, sweep="steps", use_kernel=False)
    fused = banded.solve_banded(*prob, **kw, sweep="fused")
    for name, other in (("plain version", plain), ("fused sweep", fused)):
        check(torch.equal(got.messages, other.messages)
              and torch.equal(got.labels, other.labels)
              and float(got.energy) == float(other.energy),
              f"steps path != {name}")
        rel = (abs(float(got.lower_bound) - float(other.lower_bound))
               / abs(float(other.lower_bound)))
        check(rel <= 1e-5, f"steps path's bound vs {name}: {rel}")
    e, lb = float(got.energy), float(got.lower_bound)
    check(np.isfinite([e, lb]).all() and lb <= e, f"lb {lb} > E {e}")
    say("steps_path", K=K, size=[H, W], blocks=[BAND, BAND], sweeps=sweeps,
        steps=2 * spec.T, sends_per_step=6, launches=counts,
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
    # per step one batched head-send and one batched tail-send (a direction
    # pair each); T forward and T backward steps
    expect = 2 * 2 * T * sweeps
    check(expect == wavefront.sends_per_sweep(T) * sweeps
          and counts["minplus_send"] == expect,
          f"send kernel launches {counts['minplus_send']} != 2 per step x "
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
        steps=2 * T, sends_per_step=2, launches=counts,
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
        check(itk == PLAIN_SWEEPS_WIDE and torch.equal(ak, ap) and ek == ep
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
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel_name in e.key
            and e.device_type == torch.autograd.DeviceType.CUDA]
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


def bounds(planes: int, pixels: int, K: int, sends_px: int) -> dict:
    """Least time for the work: bytes moved once at the memory rate vs
    K^2 min-plus steps per send and pixel at the float32 rate."""
    return bound_of(planes * pixels * 4, K * K * sends_px * OPS_PER_STEP)


def send_bounds(B: int, K: int, L: int) -> dict:
    """Least time of one column send: (4 K + 2) rows of B x L float32 moved
    once against K^2 min-plus steps per lane."""
    return bound_of((4 * K + 2) * B * L * 4, K * K * B * L * OPS_PER_STEP)


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
                         plain: bool = True) -> dict:
    """ms per sweep of the fused wavefront kernel and (``plain``) of its
    plain version on a synthetic problem of the given shape; the sweeps
    follow one another on one state (a sweep's work does not depend on the
    data).  The work is a banded sweep's (8 sends per pixel, the same
    arrays), hence its bounds."""
    prob = [torch.as_tensor(a, device=DEV)
            for a in testing.synthetic_problem(K, H, W)]
    sk = wavefront._Skewed(*prob, 1, 8.0)
    del prob
    state = [wavefront.messages_to_groups(
        torch.zeros((4, K, H, W), device=DEV), W)]

    def kernel_sweep():
        state[0], _ = wavefront_kernel.sweep_wavefront(sk, state[0])

    def plain_sweep():
        state[0], _ = wavefront._sweep_steps(sk, state[0], use_kernel=False)

    ms = time_ms(kernel_sweep, reps)
    plain_ms = time_ms(plain_sweep, 2, warmup=0) if plain else None
    T = H + W - 1
    row = dict(ms=ms, plain_ms=plain_ms, us_per_step=ms * 1e3 / (2 * T),
               shape=dict(K=K, H=H, W=W, T=T, steps=2 * T),
               **sweep_bounds(K, H * W))
    del sk, state
    torch.cuda.empty_cache()
    return row


def time_banded_sweep(K: int, H: int, W: int, reps: int,
                      plain: bool = True) -> dict:
    """ms per sweep of the fused kernel and (``plain``) of its plain version
    on a synthetic problem of the given shape, 128 x 128 blocks; the sweeps
    follow one another on one state (a sweep's work does not depend on the
    data)."""
    prob = [torch.as_tensor(a, device=DEV)
            for a in testing.synthetic_problem(K, H, W)]
    spec = banded.BandedSpec(H, W, min(BAND, H), min(BAND, W))
    bp = banded._BandedProblem(*prob, spec, 1, 8.0)
    del prob
    state = [banded.messages_to_state(
        torch.zeros((4, K, H, W), device=DEV), bp)]

    def kernel_sweep():
        state[0], _ = banded_kernel.sweep_banded(bp, state[0])

    def plain_sweep():
        state[0], _ = banded._sweep_steps(bp, state[0], use_kernel=False)

    ms = time_ms(kernel_sweep, reps)
    plain_ms = time_ms(plain_sweep, 2, warmup=0) if plain else None
    row = dict(ms=ms, plain_ms=plain_ms, us_per_step=ms * 1e3 / (2 * spec.T),
               shape=dict(K=K, H=H, W=W, Bh=spec.Bh, Bw=spec.Bw, T=spec.T,
                          L=spec.L),
               **sweep_bounds(K, H * W))
    del bp, state
    torch.cuda.empty_cache()
    return row


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
    """(name, arguments on the card, shape, planes moved, pixels, sends) of
    the two phase kernels at K labels on an H x W image: the compact one on
    its half-grid (8 sends over ceil(H / 2) x W pixels), the full-grid one on
    H x W (one send per direction and pixel)."""
    Hc = -(-H // 2)
    yield ("phase_messages_compact",
           on_card(testing.phase_inputs(1, K, Hc, W), COMPACT_ARGS),
           dict(K=K, Hc=Hc, W=W), 31 * K + 24, Hc * W, 8 * Hc * W)
    yield ("phase_messages",
           on_card(testing.phase_inputs_full(1, K, H, W), FULL_ARGS),
           dict(K=K, H=H, W=W), 18 * K + 13, H * W, 4 * H * W)
    torch.cuda.empty_cache()


def time_phase(K: int, H: int, W: int, reps: int = 20,
               plain: bool = True) -> list:
    """Rows of the two phase kernels (``phase_problems``): median ms of
    ``reps`` launches, the plain versions' (``plain``) and the bounds."""
    rows = []
    for name, args, shape, planes, pixels, sends in phase_problems(K, H, W):
        fn = getattr(phase_kernel, name)
        ref = getattr(phase_kernel, name + "_ref")
        ms = time_ms(lambda: fn(*args, 8.0, 1), reps)
        plain_ms = (time_ms(lambda: ref(*args, 8.0, 1), 3, warmup=1)
                    if plain else None)
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms, shape=shape,
                         **bounds(planes, pixels, K, sends)))
        del args
    return rows


def phase_timings(launches: dict, err: dict) -> list:
    K, H, W = FULL
    rows = time_phase(K, H, W)
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
    rows.append(dict(name="minplus_send", ms=ms, device_ms=on_device,
                     plain_ms=plain, shape=dict(B=B, K=K, L=L),
                     **send_bounds(B, K, L)))
    del args
    # the fused sweep at the main path's shape, and at K = 15 on 370 x 413
    # (the shape of the baby2 pair; synthetic data) for the record, and at
    # teddy's K = 202 (--grid-step 30)
    rows.append(dict(name="sweep_banded", **time_banded_sweep(K, H, W, 12)))
    say("sweep_banded_k15", **time_banded_sweep(15, 370, 413, 12))
    say("sweep_banded_k202", **time_banded_sweep(K_WIDE, H, W, 4))
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
                     **time_wavefront_sweep(K, H, W, 6)))
    say("sweep_wavefront_k15", **time_wavefront_sweep(15, 370, 413, 6))
    say("sweep_wavefront_k202", **time_wavefront_sweep(K_WIDE, H, W, 2))
    for r in rows:
        meta = KERNELS[r["name"]]
        r.update(route=meta["route"], source=meta["source"],
                 replaces=meta["replaces"], launches=launches[r["name"]],
                 max_abs_err=err[r["name"]],
                 # no single PyTorch call computes a min-plus phase, a pair,
                 # a column send or a sweep
                 library_ms=None)
        if r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} was never launched on "
                                 "its path")
    return rows


def main():
    smi = phase_device_and_build()
    err = phase_kernels_vs_plain()

    reset_counts()
    main_counts, dm, proposals, same_depth = phase_main_path()
    reset_counts()
    full_counts = phase_full_grid_path()
    reset_counts()
    banded_counts, banded_run = phase_banded_path(dm, proposals, same_depth)
    wavefront_counts = phase_wavefront_path(dm, proposals, same_depth,
                                            banded_run)
    del dm, proposals
    torch.cuda.empty_cache()
    reset_counts()
    steps_counts = phase_steps_path()
    wavefront_steps_counts = phase_wavefront_steps_path()
    pair_counts = phase_pair_path()
    phase_wide_k()
    banded_sweep_repeatable()
    wavefront_sweep_repeatable()
    launches = {
        "phase_messages_compact": main_counts["phase_messages_compact"],
        "phase_messages": full_counts["phase_messages"],
        "sweep_banded": banded_counts["sweep_banded"],
        # on the two per-step paths together
        "minplus_send": (steps_counts["minplus_send"]
                         + wavefront_steps_counts["minplus_send"]),
        "minplus_pair": pair_counts["minplus_pair"],
        "sweep_wavefront": wavefront_counts["sweep_wavefront"]}

    rows = phase_timings(launches, err)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
