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
    from test_portbench_faults import small_config

    entry, cfg = small_config("ncc_teddy.fusion")
    model = harness.model_kind(cfg["model"])
    ref = model.Reference(cfg, harness.images(cfg), "cuda")
    out = harness.run_cell(entry, cfg, harness.traffic(entry["traffic"]),
                           harness.limits("ncc_teddy.fusion"), seed=7,
                           seconds=0.0, trace=False, device="cuda",
                           control=model.control(ref))
    assert not out["correct"], out["checks"]
