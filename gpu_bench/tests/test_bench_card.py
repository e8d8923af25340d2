"""On the card: one short run of a real cell through run.py.  Skips without
a card (decided in the ``card`` fixture).  Run on the chip with
``python -m pytest -m cuda gpu_bench/tests/test_bench_card.py``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from gpu_bench.tests.conftest import REPO


@pytest.mark.cuda
def test_gate_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "gpu_bench/run.py", "--workload",
         "gate_default.wide_b8192", "--seed", "2147483777", "--seconds",
         "2", "--trace", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert 0 < result["metrics"]["br_roofline.gate"]["value"] <= 100
