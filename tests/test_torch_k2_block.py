"""The K = 2 block's wrapper (ops/k2_block.py) and binary_fuse's call of it,
on the CPU: a CPU problem takes the plain version (``binary._k2_block``), bit
for bit, and counts no launch; the plain version is the loop binary_fuse ran
inline before it.  The kernel itself (csrc/k2_block.cu) is held to the plain
version on the card in tests/test_torch_cuda.py.  No JAX call: the plain
version is held to the JAX package in tests/test_torch_binary.py."""

import os
import re

import numpy as np
import pytest
import torch

from stereo_tpu_torch import testing
from stereo_tpu_torch.energy import default_weights
from stereo_tpu_torch.ops import k2_block as t_k2
from stereo_tpu_torch.solvers import binary as t_binary
from stereo_tpu_torch.solvers import trws as t_trws

torch.set_num_threads(1)


def _inputs(seed, H, W, dtype=torch.float32, kernel=1, tol=0.9):
    """(theta0, theta1, M, V, gamma, valid, cb) of a random fusion move,
    as binary_fuse builds them, with zero messages."""
    mv = {k: torch.as_tensor(v, dtype=dtype)
          for k, v in testing.fusion_move(seed, H, W, np.float64).items()}
    D0, Q = t_binary.fusion_problem(mv["cur"], mv["prop"])
    V = t_binary._tables(D0, Q, mv["w"], kernel, tol)
    return (mv["U0"], mv["U1"], torch.zeros((4, H, W), dtype=dtype), V,
            t_trws.node_gamma(H, W, dtype, device="cpu"),
            default_weights(H, W, dtype, device="cpu"),
            t_trws.checkerboard(H, W, device="cpu"))


def _inline_block(theta0, theta1, M, V, gamma, valid, cb, check_every):
    """The block as binary_fuse ran it inline: black and white masks made
    once, the phase pairs, the bound, the decode and the energy."""
    black, white = cb == 0, cb == 1
    for _ in range(check_every):
        M, _ = t_binary._k2_phase(theta0, theta1, M, V, gamma, valid, black,
                                  accumulate_lb=False)
        M, lb_sweep = t_binary._k2_phase(theta0, theta1, M, V, gamma, valid,
                                         white, accumulate_lb=True)
    D0b, D1b = t_binary._beliefs(theta0, theta1, M)
    lb = lb_sweep + t_trws._masked_sum(black, torch.minimum(D0b, D1b))
    z = t_binary._k2_decode(theta0, theta1, M, V, cb)
    return M, lb, z, t_binary._k2_energy(z, theta0, theta1, V)


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("H,W,check_every,kernel", [
    (2, 5, 1, 1), (7, 9, 5, 2), (13, 6, 3, 1)])
def test_plain_block_is_the_inline_loop(H, W, check_every, kernel, dtype):
    """binary._k2_block is the loop binary_fuse ran inline, to the bit,
    over three blocks in a row, each from the last one's messages."""
    inp = list(_inputs(H * W, H, W, dtype, kernel))
    for _ in range(3):
        got = t_binary._k2_block(*inp, check_every)
        _equal(got, _inline_block(*inp, check_every))
        inp[2] = got[0]
    assert got[0].abs().max() > 0  # the messages moved


@pytest.mark.parametrize("H,W", [(2, 5), (7, 9), (40, 66)])
def test_cpu_problem_takes_the_plain_block(H, W):
    """k2_block on a CPU problem is binary._k2_block (a delegation, float32
    and float64 alike); the input messages stay as they were and no kernel
    launch is counted."""
    before = t_k2.k2_block.launches
    for dtype in (torch.float32, torch.float64):
        inp = _inputs(H + W, H, W, dtype)
        M0 = inp[2].clone()
        got = t_k2.k2_block(*inp, 5)
        _equal(got, t_binary._k2_block(*inp, 5))
        assert torch.equal(inp[2], M0)
        assert got[2].dtype == torch.bool and got[2].shape == (H, W)
    assert t_k2.k2_block.launches == before


@pytest.mark.parametrize("maxiter,check_every", [(20, 5), (12, 5), (6, 2)])
def test_binary_fuse_runs_its_blocks_through_the_wrapper(
        monkeypatch, maxiter, check_every):
    """binary_fuse calls k2_block once a block (the iteration cap fixes
    their number: no gap is below -inf) and reports the last block's
    bound."""
    H, W = 9, 11
    mv = {k: torch.as_tensor(v)
          for k, v in testing.fusion_move(5, H, W).items()}
    D0, Q = t_binary.fusion_problem(mv["cur"], mv["prop"])
    calls, wrapped = [], t_binary.k2_block

    def spy(*args):
        out = wrapped(*args)
        calls.append(out[1])
        return out
    monkeypatch.setattr(t_binary, "k2_block", spy)
    res = t_binary.binary_fuse(mv["U0"], mv["U1"], D0, Q, mv["w"], kernel=1,
                               tol=0.9, maxiter=maxiter,
                               max_relgap=float("-inf"),
                               check_every=check_every, accept_method="sort")
    blocks = -(-maxiter // check_every)
    assert len(calls) == blocks and res.iterations == blocks * check_every
    assert torch.equal(res.lower_bound, calls[-1])


def test_pointer_order_matches_the_kernel_source():
    """The wrapper hands the kernel its pointers in the order of
    csrc/k2_block.cu's ``enum Ptr``."""
    src = os.path.join(os.path.dirname(t_k2.__file__), os.pardir, "csrc",
                       "k2_block.cu")
    with open(src) as f:
        body = re.search(r"enum Ptr \{(.*?)\};", f.read(), re.S).group(1)
    enum = [n.strip() for n in body.replace("\n", " ").split(",")]
    assert enum[-1] == "P_COUNT"
    assert enum[:-1] == ["P_" + n.upper() for n in t_k2.POINTERS]


def test_block_bytes():
    """The bytes bound counts 28 input words, 4 output words and the
    labelling's byte a pixel."""
    assert t_k2.block_bytes(375, 450) == 375 * 450 * 129
