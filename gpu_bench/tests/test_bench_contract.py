"""BENCHMARK.json against the benchmark's contract, the configurations
against the program's presets, the roofline counts against the bounds
PERF.md quotes, and the imports: nothing under gpu_bench/ loads JAX or the
JAX package, and the reference loads nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from gpu_bench import readers, roofline, server
from gpu_bench.tests.conftest import REPO

BENCH = REPO / "gpu_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


def test_top_level_keys(bench_json):
    assert set(bench_json) == {"command", "paths", "run_seconds", "configs",
                               "workloads", "end_to_end", "per_layer"}
    assert bench_json["command"] == ["python3", "gpu_bench/run.py"]
    assert bench_json["paths"] == ["gpu_bench"]
    rs = bench_json["run_seconds"]
    assert 1 <= rs <= 51
    # a full check of 24 cells (2 + 14 runs a cell) fits in 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_configs_cells_and_files(bench_json):
    configs = {c["name"]: c for c in bench_json["configs"]}
    for c in bench_json["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["reduced"] == []
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == [] and len(c["source"]) <= 200
    used = set()
    for w in bench_json["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["config"] in configs and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
    assert used == set(configs)


def test_metrics(bench_json):
    cells = {w["name"] for w in bench_json["workloads"]}
    e2e = {m["name"]: m for m in bench_json["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    reported = {c: set() for c in cells}
    for m in bench_json["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        for c in m.get("workloads", cells):
            reported[c].add(m["name"])
    layers = {}
    for m in bench_json["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert m["moves"] in reported[c], (m["name"], c)
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for c in cells:
        assert "setup_s" in reported[c] and len(reported[c]) >= 2


@pytest.mark.parametrize("name", ["gate_default", "cb_active"])
def test_config_file_is_the_programs_preset(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    build = {"gate": server.gate_params,
             "circuit": server.circuit_params}[cfg["kind"]]
    build(cfg)                       # raises unless equal to cfg["preset"]
    changed = dict(cfg, **{"n" if cfg["kind"] == "gate" else "n_lvl0": 7})
    with pytest.raises(ValueError):
        build(changed)


def test_roofline_matches_perf_md_bounds():
    gate = json.loads((BENCH / "configs/gate_default.json").read_text())
    cb = json.loads((BENCH / "configs/cb_active.json").read_text())
    step = roofline.cmux_step_work
    # GATE_DEFAULT B=8192: 0.4167 ms a step, by operations
    g = step(8192, 1024, 1, 3, 7, 32)
    assert roofline.bound_s(*g, H100) * 1e3 == pytest.approx(0.4167, abs=1e-4)
    assert roofline.gate_bootstrap_s(gate, 8192, H100) == pytest.approx(
        630 * 0.41675e-3, rel=1e-3)
    # CB_ACTIVE lvl2 B=256: 0.2778 ms (ck_dot64p's bound in PERF.md)
    c = step(256, 2048, 1, 4, 9, 64)
    assert roofline.bound_s(*c, H100) * 1e3 == pytest.approx(0.2778, abs=1e-4)
    assert roofline.circuit_bootstrap_s(cb, 256, H100) == pytest.approx(
        2 * 500 * 0.27783e-3, rel=1e-3)
    # B=4 (one query): 0.00434 ms by operations; the raw key's bytes, read
    # once, bound it at 0.00016 ms (PERF.md's 0.0049 was CB_MXU's
    # pre-shifted wmt read at B=1-3, a layout this count does not charge)
    q = step(4, 2048, 1, 4, 9, 64)
    assert roofline.bound_s(*q, H100) * 1e3 == pytest.approx(0.00434,
                                                             abs=1e-5)
    assert q[1] / H100["bytes_per_s"] * 1e3 == pytest.approx(0.000157,
                                                             abs=1e-6)
    assert [roofline.digit_planes(b) for b in (7, 8, 9)] == [1, 1, 2]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "tfhe_tpu"}, path


def reference_imports_of_program(bench: Path) -> list:
    """(file, module) of each import under ``reference/``, judge files
    included, of the program or of gpu_bench outside gpu_bench.reference."""
    found = []
    for path in sorted((bench / "reference").rglob("*.py")):
        for name in sorted(_imports(path)):
            top = name.split(".")[0]
            if top in ("tfhe_tpu_torch", "tfhe_tpu") or (
                    top == "gpu_bench"
                    and not name.startswith("gpu_bench.reference")):
                found.append((path, name))
    return found


def test_reference_imports_nothing_of_the_program():
    assert reference_imports_of_program(BENCH) == []


def test_readers():
    class Run:
        units = [{"latency_s": x / 1000, "bootstraps": 4} for x in
                 range(1, 101)]
        window_s = 2.0
        trace = {"busy_s": 0.5, "window_s": 1.0, "units": 2}
        counters = {"bootstrap.launches": 64,
                    "bootstrap.ciphertexts": 40192}
    assert readers.bootstraps_per_s(Run) == 200.0
    assert readers.latency_ms(Run, 50) == pytest.approx(50.5)
    assert readers.latency_ms(Run, 90) == pytest.approx(90.1)
    assert readers.device_idle(Run) == 50.0
    assert readers.rows_per_launch(Run) == 628.0
    Run.units[0]["bound_s"] = Run.units[1]["bound_s"] = 0.1
    assert readers.br_roofline(Run) == pytest.approx(40.0)


def _run_py(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "gpu_bench/run.py", "--workload",
         "gate_default.wide_b8192", "--seed", "2147483659", "--seconds",
         "1", "--trace", "0"], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_run_py_refuses_without_a_card():
    out = _run_py(REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_py_fails_with_the_benchmark_alone(tmp_path):
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
