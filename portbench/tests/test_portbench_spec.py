"""BENCHMARK.json against the benchmark's contract, and every entry against
the files it names."""

import ast
import json
import os
import re

import pytest

from portbench import check, harness

ROOT = harness.ROOT
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "stereo_tpu"}


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            yield group, e["name"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("group,name", list(_names()))
def test_names(group, name):
    assert NAME.match(name), name


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    e2e = metric in SPEC["end_to_end"]
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        # the reader exists and reads
        assert callable(harness.metric_reader(metric["name"]))
        moved = next(m for m in SPEC["end_to_end"]
                     if m["name"] == metric["moves"])
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", cells)


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_configs_resolve(cfg):
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    data = harness.config(cfg["name"])
    assert cfg["source"].startswith("https://")
    assert data["source"] == cfg["source"]
    assert sorted(data.get("reduced", [])) == sorted(cfg["reduced"])
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in data
    for p in data["images"]:
        assert os.path.exists(os.path.join(harness.BENCH_DIR, p))
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])
    assert 1 <= len(cfg["why"]) <= 200


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cells_resolve(cell):
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    mix = harness.traffic(cell["traffic"])
    kind = harness.job_kind(mix["job"])
    model = harness.model_kind(harness.config(cell["config"])["model"])
    lims = harness.limits(cell["name"])
    assert set(check.COMMON + tuple(model.NUMBERS)
               + tuple(kind.NUMBERS)) <= set(lims)
    # each cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m["workloads"] for m in SPEC["per_layer"])


def test_gap_limit_is_the_stopping_rule():
    for cell in SPEC["workloads"]:
        lims = harness.limits(cell["name"])
        if "gap" in lims:
            assert lims["gap"] == harness.config(cell["config"])["max_relgap"]


SOLVE_CELLS = [w for w in SPEC["workloads"]
               if harness.traffic(w["traffic"])["job"] == "simultaneous"]


@pytest.mark.parametrize("cell", SOLVE_CELLS, ids=lambda w: w["name"])
def test_budget_gap_limit_is_never_below_the_stopping_rule(cell):
    # a solve that used up its sweeps is held no tighter than one that met
    # the rule: a budget limit under the relgap would fail a solve that
    # closes its gap on its last allowed sweep
    lims = harness.limits(cell["name"])
    assert "budget_gap" in lims
    assert lims["budget_gap"] >= harness.config(cell["config"])["max_relgap"]


def _files(sub):
    return sorted(f[:-3] for f in os.listdir(os.path.join(
        harness.BENCH_DIR, sub)) if f.endswith(".py") and f[0] != "_")


def test_job_kinds_hold_their_interface():
    kinds = _files("jobs")
    assert kinds
    for name in kinds:
        kind = harness.job_kind(name)
        assert set(kind.NUMBERS).isdisjoint(check.COMMON)
        assert callable(kind.judge)
        for method in ("set_seed", "warm_up", "run", "end_to_end", "view"):
            assert callable(getattr(kind.Job, method)), (name, method)
    used = {harness.traffic(w["traffic"])["job"] for w in SPEC["workloads"]}
    assert used <= set(kinds)
    with pytest.raises(SystemExit):
        harness.job_kind("no_such_kind")


def test_models_hold_their_interface():
    models = _files("models")
    assert models
    numbers = [check.COMMON] + [harness.job_kind(k).NUMBERS
                                for k in _files("jobs")]
    for name in models:
        model = harness.model_kind(name)
        assert all(set(model.NUMBERS).isdisjoint(n) for n in numbers)
        for fn in ("build", "view", "judge", "readings", "control"):
            assert callable(getattr(model, fn)), (name, fn)
        for method in ("energy", "candidates", "unary", "edge_weights",
                       "label_problem", "field"):
            assert callable(getattr(model.Reference, method)), (name, method)
    used = {harness.config(c["name"])["model"] for c in SPEC["configs"]}
    assert used <= set(models)
    with pytest.raises(SystemExit):
        harness.model_kind("no_such_model")


def test_config_without_a_model_is_refused(monkeypatch):
    cfg = harness._json(os.path.join(harness.BENCH_DIR, "configs",
                                     SPEC["configs"][0]["name"] + ".json"))
    del cfg["model"]
    monkeypatch.setattr(harness, "_json", lambda path: dict(cfg))
    with pytest.raises(SystemExit):
        harness.config(SPEC["configs"][0]["name"])


def test_pairs_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_check_fits_the_driver_budget():
    # 2 + 14 runs a cell at up to 24 cells, each run_seconds + 60 s, 2 x 90 s
    # of compiling a cell and 1200 s spare within 43200 s
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _py_files(sub):
    base = os.path.join(harness.BENCH_DIR, sub)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", list(_py_files("")),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", list(_py_files("reference")),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & (FORBIDDEN | {"stereo_tpu_torch"})


# the files that every model shares: none may lean on one model
GENERIC = ["harness.py", "check.py", "calibrate.py", "run.py",
           "reference/trws.py", "reference/fusion.py", "reference/planes.py"]


def _names_in(path):
    """Every module an import names, and every identifier, attribute,
    argument and string (docstrings too) of the file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            yield node.name
        elif isinstance(node, ast.arg):
            yield node.arg
        elif isinstance(node, ast.keyword) and node.arg:
            yield node.arg
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value


@pytest.mark.parametrize(
    "rel", GENERIC + [os.path.join("jobs", f + ".py") for f in _files("jobs")]
    + ["jobs/__init__.py"])
def test_generic_files_name_no_model(rel):
    # neither stereo_tpu_torch.models.ncc nor reference.ncc, nor a word of
    # the NCC model: that lives in models/ncc.py and reference/ncc.py
    named = [n for n in _names_in(os.path.join(harness.BENCH_DIR, rel))
             if "ncc" in n.lower()]
    assert not named, (rel, named)


def test_forbidden_names_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "stereo_tpu_torchish",
                        types.ModuleType("stereo_tpu_torchish"))
    assert "stereo_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]

