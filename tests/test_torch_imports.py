"""The port stands alone: no file under stereo_tpu_torch/, nor chip_smoke.py,
the port's examples or its tools, imports jax, anything of stereo_tpu,
ml_dtypes or PIL (an AST scan — the interpreter may have jax loaded already, so
sys.modules cannot tell).  And with no card present, an entry point called with its default
device raises instead of computing on the CPU."""

import ast
import glob
import os

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
FORBIDDEN = ("jax", "jaxlib", "stereo_tpu", "ml_dtypes", "PIL")

FILES = sorted(
    glob.glob(os.path.join(ROOT, "stereo_tpu_torch", "**", "*.py"),
              recursive=True)
    + [os.path.join(ROOT, "chip_smoke.py"),
       os.path.join(ROOT, "examples", "run_ncc_torch.py"),
       os.path.join(ROOT, "examples", "run_global_torch.py"),
       os.path.join(ROOT, "examples", "run_simultaneous_torch.py"),
       os.path.join(ROOT, "examples", "run_second_order_torch.py"),
       os.path.join(ROOT, "examples", "run_render_torch.py"),
       os.path.join(ROOT, "examples", "run_full_sweep_torch.py"),
       os.path.join(ROOT, "examples", "run_batch_torch.py"),
       os.path.join(ROOT, "tools", "time_banded_kernel.py"),
       os.path.join(ROOT, "tools", "profile_segpln.py"),
       os.path.join(ROOT, "tools", "check_multicard.py"),
       os.path.join(ROOT, "tools", "check_determinism.py"),
       os.path.join(ROOT, "tools", "measure_message_dtype.py"),
       os.path.join(ROOT, "tools", "measure_race_torch.py"),
       os.path.join(ROOT, "tools", "measure_wavefront_torch.py")])


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_files_found():
    names = {os.path.relpath(f, ROOT) for f in FILES}
    for must in ("stereo_tpu_torch/solvers/trws.py",
                 "stereo_tpu_torch/solvers/banded.py",
                 "stereo_tpu_torch/solvers/wavefront.py",
                 "stereo_tpu_torch/solvers/hierarchy.py",
                 "stereo_tpu_torch/ops/banded_kernel.py",
                 "stereo_tpu_torch/ops/wavefront_kernel.py",
                 "stereo_tpu_torch/ops/minplus.py",
                 "stereo_tpu_torch/ops/phase_kernel.py",
                 "stereo_tpu_torch/models/ncc.py",
                 "stereo_tpu_torch/config.py",
                 "stereo_tpu_torch/native/__init__.py",
                 "stereo_tpu_torch/proposals/segmentation.py",
                 "stereo_tpu_torch/proposals/segpln.py",
                 "stereo_tpu_torch/ops/photo.py",
                 "stereo_tpu_torch/models/global_stereo.py",
                 "stereo_tpu_torch/solvers/scanline.py",
                 "stereo_tpu_torch/solvers/trws_tables.py",
                 "stereo_tpu_torch/solvers/qpbo_host.py",
                 "stereo_tpu_torch/solvers/trws_host.py",
                 "stereo_tpu_torch/utils/checkpoint.py",
                 "stereo_tpu_torch/utils/viz.py",
                 "stereo_tpu_torch/ops/interactions.py",
                 "stereo_tpu_torch/models/visibility.py",
                 "stereo_tpu_torch/models/second_order.py",
                 "stereo_tpu_torch/render/__init__.py",
                 "stereo_tpu_torch/render/genview.py",
                 "stereo_tpu_torch/render/edges.py",
                 "stereo_tpu_torch/render/modes.py",
                 "stereo_tpu_torch/render/edgemodes.py",
                 "stereo_tpu_torch/render/occlrender.py",
                 "examples/run_global_torch.py",
                 "examples/run_simultaneous_torch.py",
                 "examples/run_second_order_torch.py",
                 "examples/run_render_torch.py",
                 "examples/run_full_sweep_torch.py", "chip_smoke.py",
                 "stereo_tpu_torch/parallel/mesh.py",
                 "stereo_tpu_torch/parallel/batch.py",
                 "stereo_tpu_torch/parallel/fusion_dist.py",
                 "stereo_tpu_torch/parallel/multihost.py",
                 "stereo_tpu_torch/solvers/banded_dist.py",
                 "stereo_tpu_torch/entry.py",
                 "examples/run_batch_torch.py",
                 "tools/check_multicard.py"):
        assert must in names
    assert all(os.path.exists(f) for f in FILES)


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(f, ROOT) for f in FILES])
def test_no_forbidden_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_no_torch_compile_in_port():
    for path in FILES:
        with open(path) as f:
            assert "torch.compile" not in f.read(), path


def _skip_if_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_default_device_raises_without_card():
    _skip_if_card()
    from stereo_tpu_torch import convert, energy, geometry, testing
    from stereo_tpu_torch.models.ncc import DispMapNCC
    from stereo_tpu_torch.solvers import banded, trws, wavefront

    with pytest.raises(RuntimeError, match="cuda"):
        geometry.fronto_parallel(4, 5, 1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        banded.banded_gamma(banded.BandedSpec(4, 5, 2, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        geometry.grid_points(4, 5)
    with pytest.raises(RuntimeError, match="cuda"):
        energy.default_weights(4, 5)
    with pytest.raises(RuntimeError, match="cuda"):
        trws.checkerboard(4, 5)
    im0, im1 = testing.textured_pair(0, 12, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        DispMapNCC([im0, im1], np.arange(4), kernel=1, unary_weight=40.0,
                   tol=8.0)
    with pytest.raises(RuntimeError, match="cuda"):
        DispMapNCC([im0, im1], np.arange(4), kernel=1, unary_weight=40.0,
                   tol=8.0, schedule="banded")
    theta, D0, Q, alphas = testing.trws_problem(0, 3, 4, 5)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.problem_from_numpy(theta, D0, Q, alphas)
    state = (np.zeros((5, 2, 3, 4)), np.zeros((5, 2, 3, 4)),
             (np.zeros((3, 4)),) * 4)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.banded_state_from_numpy(state)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.wavefront_groups_from_numpy(state[:2])
    with pytest.raises(RuntimeError, match="cuda"):
        wavefront.raster_gamma(4, 5)
    from stereo_tpu_torch.solvers import scanline, trws_tables
    with pytest.raises(RuntimeError, match="cuda"):
        scanline.scanline_gamma(4, 5)
    with pytest.raises(RuntimeError, match="cuda"):
        trws_tables.potts_table(3, 1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        DispMapNCC([im0, im1], np.arange(4), kernel=1, unary_weight=40.0,
                   tol=8.0, schedule="wavefront")
    from stereo_tpu_torch.proposals import segmentation, segpln
    from stereo_tpu_torch.models.global_stereo import DispMapGlobalStereo

    P = np.zeros((2, 3, 4))
    P[:, :, :3] = np.eye(3)
    P[1, 0, 3] = -1.0
    with pytest.raises(RuntimeError, match="cuda"):
        DispMapGlobalStereo([im0, im1], P, (0, 3), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        segmentation.mean_shift(im0, 4, 5.0, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        segpln.segpln([im0, im1], list(P), np.arange(3, -1, -1), 30.0)
    from stereo_tpu_torch.models.second_order import (SecondOrderStereo,
                                                      ojw_stereo)
    from stereo_tpu_torch.render import render_occl
    from stereo_tpu_torch.render.edgemodes import render_edgemodes

    with pytest.raises(RuntimeError, match="cuda"):
        SecondOrderStereo([im0, im1], P, (0, 3), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        ojw_stereo([im0, im1], P, (0, 3), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        render_edgemodes([im0, im1], P, np.arange(3.0, -1, -1), (12, 16))
    with pytest.raises(RuntimeError, match="cuda"):
        render_occl([im0, im1], P, np.arange(3.0, -1, -1), (12, 16))
    from stereo_tpu_torch import entry
    from stereo_tpu_torch.parallel import mesh as mesh_mod
    from stereo_tpu_torch.solvers import banded_dist

    with pytest.raises(RuntimeError, match="cuda"):
        mesh_mod.make_mesh(2)
    with pytest.raises(RuntimeError, match="cuda"):
        banded_dist.make_y_mesh(2)
    with pytest.raises(RuntimeError, match="cuda"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="cuda"):
        entry.entry()
    # asked for explicitly, the CPU is fine
    assert geometry.fronto_parallel(4, 5, 1.0, device="cpu").shape == (4, 4, 5)


@pytest.mark.parametrize("name,args", [
    ("run_global_torch", ["--pair", "synth"]),
    ("run_simultaneous_torch", ["--pair", "synth"]),
    ("run_second_order_torch", ["--pair", "synth", "--crop", "0", "8", "0",
                                "8"]),
    ("run_render_torch", ["--pair", "synth", "--crop", "0", "8", "0", "8"]),
    ("run_full_sweep_torch", ["--pairs", "synth"]),
    ("run_batch_torch", ["--pairs", "synth", "synth"])])
def test_examples_raise_without_card(name, args, monkeypatch):
    """The examples run on the card by default and raise without one; they
    never carry on on the CPU unless asked."""
    _skip_if_card()
    import runpy
    import sys

    monkeypatch.setattr(sys, "argv", [name, *args])
    with pytest.raises(RuntimeError, match="cuda"):
        runpy.run_path(os.path.join(ROOT, "examples", name + ".py"),
                       run_name="__main__")


def test_unported_options_raise():
    """No option of the JAX package is refused any more; unknown names
    raise.  The scanline schedule and the host (QPBO) fusion backend
    construct and solve on the CPU, and so does narrow message storage
    (``message_dtype``)."""
    from stereo_tpu_torch import geometry, testing
    from stereo_tpu_torch.models.ncc import DispMapNCC
    from stereo_tpu_torch.solvers import trws

    im0, im1 = testing.textured_pair(0, 12, 16)
    kw = dict(kernel=1, unary_weight=40.0, tol=8.0, device="cpu")
    with pytest.raises(ValueError):
        DispMapNCC([im0, im1], np.arange(4), schedule="zigzag", **kw)
    with pytest.raises(ValueError):
        DispMapNCC([im0, im1], np.arange(4), fusion_backend="quantum", **kw)
    dm = DispMapNCC([im0, im1], np.arange(4), **kw)
    dm.schedule = "zigzag"
    with pytest.raises(ValueError):
        dm.simultaneous_fusion([dm.assignment])
    # the wavefront and scanline schedules construct and solve
    for schedule, chunk in (("wavefront", 150), ("scanline", 50)):
        dm = DispMapNCC([im0, im1], np.arange(4), schedule=schedule,
                        maxiter=2, **kw)
        assert dm.schedule == schedule
        assert getattr(dm, f"solver_chunk_{schedule}") == chunk
        e, lb, iters = dm.simultaneous_fusion([dm.assignment])
        assert iters > 0 and np.isfinite([e, lb]).all() and lb <= e + 1e-9
    # the host fusion backend constructs and fuses, never raising the energy
    dm = DispMapNCC([im0, im1], np.arange(4), fusion_backend="host", **kw)
    assert dm.fusion_backend == "host"
    e0 = dm.energy()
    e, lb = dm.binary_fusion(geometry.fronto_parallel(12, 16, 2.0,
                                                      dm.dtype, "cpu"))
    assert np.isfinite([e, lb]).all() and lb <= e + 1e-9 and e <= e0
    t = [torch.as_tensor(a) for a in testing.trws_problem(0, 3, 4, 5)]
    res = trws.solve(*t, kernel=1, tol=1.0, message_dtype=torch.bfloat16)
    assert res.messages.dtype == torch.bfloat16
    assert float(res.lower_bound) <= float(res.energy) + 1e-9


def test_kernel_wrapper_refuses_wrong_cuda_input():
    """On a CUDA tensor the wrapper launches or raises; here the check is on
    the argument validation, which runs before any launch."""
    from stereo_tpu_torch.ops import phase_kernel

    t = torch.zeros((2, 3, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        phase_kernel._check("gD", t, (2, 3, 4), t.device)
    with pytest.raises(ValueError, match="shape"):
        phase_kernel._check("gD", t.float(), (2, 3, 5), t.device)
    with pytest.raises(ValueError, match="contiguous"):
        phase_kernel._check("gD", t.float().transpose(1, 2), (2, 4, 3),
                            t.device)
    with pytest.raises(ValueError, match="expected"):
        phase_kernel._check("gD", t.float(), (2, 3, 4),
                            torch.device("cuda", 0))


def test_banded_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks that run before any launch, on CPU stand-ins: the fused
    sweep's masks are bool, its state float32 of the spec's shapes; a
    thread block has at most 12 warps of 8 targets, and more labels take
    more passes, not a refusal."""
    from stereo_tpu_torch.ops import _launch, banded_kernel, minplus
    from stereo_tpu_torch.solvers import banded

    mask = torch.zeros(6, dtype=torch.bool)
    _launch.check_tensor("vSxL", mask, (6,), mask.device, torch.bool)
    with pytest.raises(ValueError, match="bool"):
        _launch.check_tensor("vSxL", mask.float(), (6,), mask.device,
                             torch.bool)
    with pytest.raises(TypeError):
        _launch.check_tensor("MA", None, (6,), mask.device)
    with pytest.raises(RuntimeError, match="refused"):
        _launch.launch_failed("sweep_banded", 720)
    spec = banded.BandedSpec(7, 9, 3, 4)
    shapes = banded_kernel.problem_shapes(spec, 5)
    assert shapes["MA"] == (spec.T + 2, 2, 5, spec.L)
    assert shapes["SyU"] == shapes["PyD_q"] == (5, spec.Lp)
    assert shapes["vSyD"] == shapes["PyU_a"] == (spec.Lp,)
    assert minplus.MAX_TB == 12 and minplus.KT == 8
    assert [minplus.target_blocks(K) for K in (1, 8, 79, 96)] == [1, 1, 10, 12]
    # beyond one pass: the fewest passes, their target blocks spread evenly
    assert [minplus.target_blocks(K) for K in (97, 128, 202, 300, 1000)] == [
        7, 8, 9, 10, 12]
    assert not hasattr(banded_kernel, "MAX_K") and not hasattr(minplus,
                                                               "MAX_K")
    # the staging hand-shake: the kernel's entry point decides; one call
    # when shared memory holds the sources, a second with the scratch it
    # asked for otherwise, a refusal raises
    def entry(ask, code=0):
        calls = []

        def call(scratch, floats, need):
            calls.append((scratch is not None, floats))
            need._obj.value = ask
            return code
        return calls, call

    calls, call = entry(0)
    _launch.launch_staged("minplus_send", call, "cpu")
    assert calls == [(False, 0)]
    calls, call = entry(640)
    _launch.launch_staged("minplus_send", call, "cpu")
    assert calls == [(False, 0), (True, 640)]
    with pytest.raises(RuntimeError, match="refused"):
        _launch.launch_staged("minplus_send", entry(640, code=1)[1], "cpu")
    assert banded_kernel.LB_SLOTS == 9
    with pytest.raises(RuntimeError, match="refused"):
        _launch.launch_failed("sweep_wavefront", 720)


def test_build_digest_covers_shared_headers(tmp_path):
    """A changed csrc/*.cuh must give every source a new library name (so it
    is rebuilt), and so must a changed source or other flags; no nvcc
    needed."""
    from stereo_tpu_torch.ops import _build

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "phase_kernel.cu").write_text("// a\n")
    (csrc / "other.cu").write_text("// a\n")
    (csrc / "shared.cuh").write_text("// h1\n")
    target = lambda name: _build._target(name, str(csrc), str(build))
    src, out1, flags = target("phase_kernel")
    assert src == str(csrc / "phase_kernel.cu") and "-fmad=false" in flags
    assert out1.startswith(str(build)) and out1 == target("phase_kernel")[1]
    other1 = target("other")[1]
    (csrc / "shared.cuh").write_text("// h2\n")
    out2, other2 = target("phase_kernel")[1], target("other")[1]
    assert out2 != out1 and other2 != other1
    (csrc / "phase_kernel.cu").write_text("// b\n")
    assert target("phase_kernel")[1] != out2
    assert target("other")[1] == other2  # another source's bytes do not count
    (csrc / "second.cuh").write_text("")
    assert target("other")[1] != other2
    # the package's own seven sources are all built without FMA contraction
    assert _build.sources() == ["banded_decode", "banded_kernel", "k2_block",
                                "minplus_pair", "minplus_send",
                                "phase_kernel", "wavefront_kernel"]
    for name in _build.sources():
        assert "-fmad=false" in _build._target(name)[2]
