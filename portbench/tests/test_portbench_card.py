"""The benchmark on the card: one short run of each cell through run.py,
and the control at the faults test's small size.  Marked ``cuda``; each
test skips where there is no GPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_one_job_on_the_card(cell):
    _need_card()
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", cell, "--seed", "2876543210", "--seconds", "0",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert "setup_s" in out["metrics"]


@pytest.mark.cuda
def test_control_on_the_card():
    _need_card()
    from test_portbench_faults import SMALL

    from portbench import check
    cfg = dict(harness.config("ncc_teddy"), **SMALL)
    ref = check.Reference(cfg, harness.images(cfg), "cuda")
    ctrl = ref.vol.to(torch.bfloat16).to(torch.float32)
    spec = harness.load_spec()
    entry = harness.find(spec["workloads"], "ncc_teddy.fusion", "workload")
    cfg["proposals"] = dict(cfg["proposals"], grid_step=16)
    out = harness.run_cell(entry, cfg, harness.traffic(entry["traffic"]),
                           harness.limits("ncc_teddy.fusion"), seed=7,
                           seconds=0.0, trace=False, device="cuda",
                           ncc_override=ctrl)
    assert not out["correct"], out["checks"]
