"""Fixtures of the benchmark's own tests: a copy of the benchmark with the
toy configurations and toy cells added as files (the way a later change
adds a configuration, a mix or a cell), and a card check made inside a
fixture, never at import."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from gpu_bench.tests.toy_configs import CB_TOY, GATE_TOY

REPO = Path(__file__).resolve().parents[2]
MIXES = {"gate_toy": ("wide_b8192", "adder32_i256"),
         "cb_toy": ("b256", "query4")}


@pytest.fixture(scope="session", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def bench_json():
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.fixture(scope="session")
def toy_bench(tmp_path_factory, bench_json):
    """(root, bench): a checkout-like copy holding BENCHMARK.json with the
    toy configurations and one toy cell per traffic mix added."""
    root = tmp_path_factory.mktemp("toy_checkout")
    shutil.copytree(REPO / "gpu_bench", root / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(bench_json))
    for cfg in (GATE_TOY, CB_TOY):
        rel = f"gpu_bench/configs/{cfg['name']}.json"
        (root / rel).write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                                 "file": rel, "reduced": [],
                                 "why": "toy size for the CPU tests"})
        for mix in MIXES[cfg["name"]]:
            bench["workloads"].append({
                "name": f"{cfg['name']}.{mix}", "config": cfg["name"],
                "traffic": mix, "chips": 1, "why": "toy size"})
    # key_prep_s lists the cells it is read in: the toy cells join them
    keys = next(m for m in bench["per_layer"] if m["name"] == "key_prep_s")
    keys["workloads"] += [w["name"] for w in bench["workloads"]
                          if w["config"] in MIXES]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
