"""stereo_tpu_torch.parallel.multihost: two processes joined by
torch.distributed (gloo, 127.0.0.1) solve one problem, a column shard or a
gy-stripe each, and must equal the one-process solve: labels and messages
exactly, scalars rel 1e-5 (float32 sums of per-process partials).

Each test binds port 0 for a free port (pytest-xdist runs files in
parallel), puts a timeout on the process group and on the processes, and
kills only the processes it started."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracles
from stereo_tpu_torch.solvers import banded as t_banded
from stereo_tpu_torch.solvers import trws as t_trws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs():
    rng = np.random.default_rng(0)
    return [a.astype(np.float32)
            for a in oracles.grid_trws_inputs(rng, 16, 32, 5)]


def _two_processes(tmp_path, *args):
    """Run the multihost worker as processes 0 and 1; process 0's .npz."""
    inp = tmp_path / "in.npz"
    theta, D0, Q, alphas = _inputs()
    np.savez(inp, theta=theta, D0=D0, Q=Q, alphas=alphas)
    out = tmp_path / "out.npz"
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}

    def cmd(rank):
        return [sys.executable, "-m", "stereo_tpu_torch.parallel.multihost",
                str(rank), "2", coord, "--inputs", str(inp), "--out",
                str(out), "--device", "cpu", "--timeout", "90", *args]

    p1 = subprocess.Popen(cmd(1), cwd=REPO, env=env,
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        run = subprocess.run(cmd(0), cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=180)
    finally:
        try:
            p1.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p1.kill()  # this exact process only
            p1.wait()
    assert run.returncode == 0, run.stderr[-2000:]
    return np.load(out)


def test_two_process_solve_matches_single(tmp_path):
    got = _two_processes(tmp_path, "--maxiter", "8", "--check-every", "2")
    assert str(got["transport"]) == "gloo"
    ref = t_trws.solve(*(torch.as_tensor(a) for a in _inputs()), kernel=1,
                       tol=1.0, maxiter=8, max_relgap=0.0, check_every=2)
    np.testing.assert_array_equal(got["solve_labels"], ref.labels.numpy())
    np.testing.assert_array_equal(got["solve_messages"],
                                  ref.messages.numpy())
    assert int(got["solve_iters"]) == 8
    assert float(got["solve_energy"]) == pytest.approx(float(ref.energy),
                                                       rel=1e-5)
    assert float(got["solve_lb"]) == pytest.approx(float(ref.lower_bound),
                                                   rel=1e-5)


def test_two_process_banded_matches_single(tmp_path):
    """gy stripes across the process boundary: the per-step seam rows and
    gD slabs travel between the processes."""
    got = _two_processes(tmp_path, "--banded", "2", "4", "4", "2")
    run = t_banded.BandedRun(*(torch.as_tensor(a) for a in _inputs()),
                             kernel=1, tol=1.0, Bh=2, Bw=4, sweep="steps")
    _, e, lb, labels = run.run(run.init_state(), 4, 2)
    np.testing.assert_array_equal(got["banded_labels"], labels.numpy())
    assert float(got["banded_energy"]) == pytest.approx(float(e), rel=1e-5)
    assert float(got["banded_lb"]) == pytest.approx(float(lb), rel=1e-5)


def test_make_global_blocks():
    """make_global gives each process its block; in a one-process group the
    block is the whole value."""
    import torch.distributed as dist

    from stereo_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, "gloo", 30)
    try:
        m = multihost.global_mesh(device="cpu")
        assert m.shape == {"batch": 1, "x": 1}
        v = np.arange(24.0).reshape(2, 3, 4)
        assert torch.equal(multihost.make_global(m, "x", v),
                           torch.as_tensor(v))
        assert torch.equal(multihost.make_global(m, "y", v),
                           torch.as_tensor(v))
        with pytest.raises(ValueError, match="one row"):
            multihost.global_mesh(batch=2, device="cpu")
    finally:
        dist.destroy_process_group()
