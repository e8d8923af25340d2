"""The benchmark cell ``cb_paper.b256`` on the CPU at a toy of its shape.

``gpu_bench/configs/cb_paper.json`` runs the port's CB_PAPER block (four
output levels, lvl2 Bg = 2^9 / l = 6, preKS t = 15 and privKS t = 32 at
base 2) under the ``b256`` traffic mix.  Here the same mix runs end to end
through ``gpu_bench.harness.run_cell`` at CB_PAPER_TOY (CB_PAPER's gadgets
and key switches at toy widths) with the port's plain kernel versions: the
reference agrees with the program, and the control (a key cut to
``control_key_limbs``) and the planted faults of the benchmark's own tests
come out not correct.  The configuration file itself must build exactly
the program's CB_PAPER, and the roofline count must read CB_PAPER's four
rotations of 500 steps at 0.4167 ms.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from gpu_bench import harness, roofline, server
from gpu_bench.tests.test_bench_runs import (_answer_altered, _half_batch,
                                             _step_unchanged)
from gpu_bench.tests.toy_configs import CB_TOY

REPO = Path(__file__).resolve().parents[1]
SEED = 2**31 + 20021
CELL = "cb_paper_toy.b256"
H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]

CB_PAPER_TOY = dict(
    CB_TOY, name="cb_paper_toy", preset="CB_PAPER_TOY",
    source="tfhe_tpu_torch/params.py CB_PAPER_TOY", ell_lvl1=4, ell_lvl2=6,
    ks_len_10=15, ks_basebit_10=1, ks_len_21=32, ks_basebit_21=1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy_bench(tmp_path_factory):
    """(root, bench): a checkout-like copy of the benchmark with the toy
    configuration and its ``b256`` cell added as files."""
    root = tmp_path_factory.mktemp("cb_paper_checkout")
    shutil.copytree(REPO / "gpu_bench", root / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    rel = "gpu_bench/configs/cb_paper_toy.json"
    (root / rel).write_text(json.dumps(CB_PAPER_TOY))
    bench["configs"].append({"name": "cb_paper_toy", "file": rel,
                             "source": CB_PAPER_TOY["source"],
                             "reduced": [], "why": "toy size"})
    bench["workloads"].append({"name": CELL, "config": "cb_paper_toy",
                               "traffic": "b256", "chips": 1,
                               "why": "toy size"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


def _run(toy_bench, control=False):
    root, bench = toy_bench
    return harness.run_cell(root, bench, CELL, SEED, 0.01, False, "cpu",
                            time.perf_counter(), control=control)


def test_cell_runs_and_agrees(toy_bench, monkeypatch):
    """The run reads correct, and a launch runs CB_PAPER's programs: one
    preKS (A), four rotations (B) and eight privKS products (C)."""
    from tfhe_tpu_torch import graphs
    sites = []
    run_program = graphs.run

    def counted(site, *args, **kw):
        sites.append(site)
        return run_program(site, *args, **kw)
    monkeypatch.setattr(graphs, "run", counted)
    result, checks, run = _run(toy_bench)
    assert result["correct"] and result["failed"] == 0
    assert checks == {"wrong_answers": {"value": 0, "limit": 0}}
    assert run.sampled == 16 and result["attempted"] >= 256
    assert "setup_s" in result["metrics"]
    launches = run.counters["bootstrap.circuit_launches"] + 1  # + warm-up
    assert {s: sites.count(s) for s in set(sites)
            if s.startswith("circuit.")} == {
        "circuit.a": launches, "circuit.b": 4 * launches,
        "circuit.c": 8 * launches}


def test_control_is_wrong(toy_bench):
    """The program on a key cut to 6 of its 8 lvl2 limbs reads every sampled
    TRGSW wrong."""
    result, checks, run = _run(toy_bench, control=True)
    assert not result["correct"]
    assert checks["wrong_answers"]["value"] == run.sampled


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch,
                                   _answer_altered])
def test_planted_fault_is_caught(toy_bench, monkeypatch, fault):
    fault(monkeypatch)
    result, checks, _ = _run(toy_bench)
    assert not result["correct"]
    assert checks["wrong_answers"]["value"] > 0


def _cb_paper_file() -> dict:
    return json.loads((REPO / "gpu_bench/configs/cb_paper.json").read_text())


def test_config_file_is_cb_paper():
    from tfhe_tpu_torch import params as P
    cfg = _cb_paper_file()
    assert cfg["preset"] == "CB_PAPER" and cfg["reduced"] == []
    assert cfg["assumed"] == ["input_stdev_log2"]
    assert server.circuit_params(cfg) == P.CB_PAPER
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["cb_paper"]
    assert entry["file"] == "gpu_bench/configs/cb_paper.json"
    assert entry["source"] == cfg["source"] and entry["reduced"] == []


@pytest.mark.parametrize("key,value", [
    ("n_lvl0", 630), ("ell_lvl1", 2), ("ell_lvl2", 4), ("bgbit_lvl2", 8),
    ("bk_stdev_log2", -44), ("ks_len_10", 6), ("ks_basebit_21", 2),
    ("bk_limbs", 6)])
def test_config_file_with_a_changed_number_is_refused(key, value):
    with pytest.raises(ValueError):
        server.circuit_params(dict(_cb_paper_file(), **{key: value}))


def test_roofline_reads_four_rotations_of_500_steps():
    cfg = _cb_paper_file()
    step = roofline.cmux_step_work(256, 2048, 1, 6, 9, 64)
    assert roofline.bound_s(*step, H100) * 1e3 == pytest.approx(0.4167,
                                                                abs=1e-4)
    assert roofline.circuit_bootstrap_s(cfg, 256, H100) == pytest.approx(
        4 * 500 * 0.41675e-3, rel=1e-3)
