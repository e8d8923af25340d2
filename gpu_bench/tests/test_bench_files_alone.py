"""A cell whose traffic loop and judge are not built in, added to a copy of
the benchmark with new files alone: a loop file (``traffic/<loop>.py``), a
judge file (``reference/judges/<judge>.py``), a mix naming the loop, and a
cell on the toy circuit-bootstrapping configuration.  Its loop answers with
lvl1 TRLWEs, the output of two-bit look-up tables selected by
circuit-bootstrapped TRGSWs (``tfhe_tpu_torch.models.lut``), which no
built-in loop or judge knows; the judge file works them out again with the
reference's circuit bootstrap and a plain CMux tree."""

from __future__ import annotations

import filecmp
import json
import re
import shutil
import time

import pytest

from gpu_bench import harness, loops
from gpu_bench.reference import judge
from gpu_bench.tests.conftest import REPO
from gpu_bench.tests.test_bench_contract import reference_imports_of_program
from gpu_bench.tests.test_bench_runs import _answer_altered
from gpu_bench.tests.toy_configs import CB_TOY

SEED = 2**31 + 24024

LOOP = '''"""Two-bit look-up tables over circuit-bootstrapped selectors: a
launch circuit-bootstraps the bits of ``instances`` tables and selects
each one's row by its CMux tree; closed loop, one launch at a time."""

import torch

from gpu_bench import loops


def run(ctx):
    from tfhe_tpu_torch.models import lut
    mix, cfg = ctx.mix, ctx.cfg
    k, inst = mix["lut_bits"], mix["instances"]
    fn = ctx.server.bootstrap_fn()
    table = ctx.client.uniform((1 << k,), 32)
    bits = ctx.client.bits((mix["pool_batches"], inst * k))
    pool = loops._bits_lwe(ctx, bits, -(1 << 31), 0,
                           ctx.secret["ring_lvl1"][0],
                           cfg["input_stdev_log2"]).to(torch.int32)

    def launch(x):
        gsw = fn(x)
        return lut.eval_lut_batch(gsw.reshape(inst, k, *gsw.shape[1:]),
                                  table, ctx.server.params.tgsw_lvl1,
                                  backend=mix["backend"])

    ctx.warm(lambda: launch(pool[0]))
    outs = []
    w = ctx.window
    w.open()
    while True:
        outs.append(launch(pool[len(outs) % len(pool)]))
        w.unit(inst, inst * k)
        if w.elapsed() >= ctx.seconds:
            break
    w.close()
    picks = [divmod(i, inst) for i in
             loops._pick(ctx.sample_gen, len(outs) * inst, mix["sample"])]
    return loops.Sample(
        mix["judge"],
        torch.stack([pool[j % len(pool)].reshape(inst, k, -1)[i]
                     for j, i in picks]).to(torch.int64),
        torch.stack([outs[j][i] for j, i in picks]), {"table": table})
'''

JUDGE = '''"""Two-bit look-up tables: each table's selector bits
circuit-bootstrapped by the reference, then its CMux tree folded with
plain external products (d0 + TRGSW x (d1 - d0), level by level, least
significant bit first)."""

import torch

from gpu_bench.reference import tfhe as R


def judge(inputs, key, cfg, extra):
    S, k, m = inputs.shape
    gsw = R.circuit_bootstrap(inputs.reshape(S * k, m), key, cfg)
    kp1, l, N = gsw.shape[1], gsw.shape[2], gsw.shape[-1]
    gsw = gsw.reshape(S, k, kp1 * l, kp1, N)
    table = extra["table"].to(inputs.device)
    leaves = torch.zeros((table.shape[0], kp1, N), dtype=torch.int64,
                         device=inputs.device)
    leaves[:, -1, 0] = table
    out = []
    for s in range(S):
        acc = leaves
        for j in range(k):
            diff = R.wrap32(acc[1::2] - acc[0::2])
            digits = R.decompose(diff, l, cfg["bgbit_lvl1"], 32)
            prod = R.external_product(digits.reshape(-1, kp1 * l, N),
                                      R.trgsw_spectrum(gsw[s, j], 32), 32)
            acc = R.wrap32(acc[0::2] + prod)
        out.append(acc[0])
    return torch.stack(out)
'''

BASE_MIX = {"loop": "lut_toy", "judge": "lut_toy", "lut_bits": 2,
            "instances": 8, "pool_batches": 2, "backend": "matmul",
            "sample": 8, "trace_units": 1}
MIXES = {"lut2_i8": BASE_MIX,
         "lut2_unjudged": dict(BASE_MIX, judge="no_such_judge"),
         "nowhere": dict(BASE_MIX, loop="no_such_loop")}


@pytest.fixture(scope="module")
def files_bench(tmp_path_factory):
    """(root, bench): a checkout-like copy of the benchmark to which the toy
    configuration, the loop and judge files, the mixes and their cells are
    added as new files (and entries of BENCHMARK.json)."""
    root = tmp_path_factory.mktemp("files_alone_checkout")
    shutil.copytree(REPO / "gpu_bench", root / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    folder = root / "gpu_bench"
    new = {"configs/cb_toy.json": json.dumps(CB_TOY),
           "traffic/lut_toy.py": LOOP,
           "reference/judges/lut_toy.py": JUDGE,
           **{f"traffic/{m}.json": json.dumps(mix)
              for m, mix in MIXES.items()}}
    for rel, text in new.items():
        assert not (folder / rel).exists(), rel
        (folder / rel).parent.mkdir(parents=True, exist_ok=True)
        (folder / rel).write_text(text)
    bench["configs"].append({"name": "cb_toy", "reduced": [],
                             "file": "gpu_bench/configs/cb_toy.json",
                             "source": CB_TOY["source"], "why": "toy size"})
    for m in MIXES:
        bench["workloads"].append({"name": f"cb_toy.{m}", "config": "cb_toy",
                                   "traffic": m, "chips": 1,
                                   "why": "toy size"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


def _run(files_bench, cell, control=False):
    root, bench = files_bench
    return harness.run_cell(root, bench, cell, SEED, 0.01, False, "cpu",
                            time.perf_counter(), control=control)


def _unchanged_files(root):
    """Every file the benchmark has is in the copy, byte for byte."""
    for path in (REPO / "gpu_bench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            copy = root / path.relative_to(REPO)
            assert filecmp.cmp(path, copy, shallow=False), copy


@pytest.mark.parametrize("case,correct", [("sound", True),
                                          ("control", False),
                                          ("answer_altered", False)])
def test_file_cell_is_judged_by_its_judge_file(files_bench, monkeypatch,
                                               case, correct):
    """The sound run reads correct; the control (a key cut to
    control_key_limbs) and the TRGSWs altered where they are produced read
    every sampled table wrong."""
    if case == "answer_altered":
        _answer_altered(monkeypatch)
    result, checks, run = _run(files_bench, "cb_toy.lut2_i8",
                               control=case == "control")
    _unchanged_files(files_bench[0])
    assert result["correct"] is correct
    assert run.sampled == 8 and result["attempted"] >= 8
    assert checks["wrong_answers"] == {
        "value": 0 if correct else run.sampled, "limit": 0}
    assert "setup_s" in result["metrics"]


def test_missing_loop_file_stops_before_a_key_is_made(files_bench,
                                                      monkeypatch):
    made = []
    monkeypatch.setattr(harness, "Client", lambda *a: made.append(a))
    path = files_bench[0] / "gpu_bench/traffic/no_such_loop.py"
    with pytest.raises(SystemExit, match=re.escape(str(path))) as err:
        _run(files_bench, "cb_toy.nowhere")
    assert "'nowhere'" in str(err.value) and made == []


def test_missing_judge_file_names_its_path(files_bench):
    path = files_bench[0] / "gpu_bench/reference/judges/no_such_judge.py"
    with pytest.raises(SystemExit, match=re.escape(str(path))):
        _run(files_bench, "cb_toy.lut2_unjudged")


@pytest.mark.parametrize("name", sorted(loops.LOOPS))
def test_builtin_loop_resolves_to_its_function(tmp_path, name):
    found = harness.find_loop(tmp_path, "mix", {"loop": name})
    assert found is getattr(loops, name)


@pytest.mark.parametrize("name,fn", [("gate_bootstrap", judge._gate),
                                     ("circuit_bootstrap",
                                      judge._circuit_bootstrap)])
def test_builtin_judge_resolves_to_its_function(tmp_path, name, fn):
    assert judge.find_judge(name, tmp_path) is fn


def test_netlist_judge_resolves_when_asked_for(tmp_path):
    found = judge.find_judge("circuit:ripple_carry_adder", tmp_path)
    assert found.func is judge._netlist
    assert found.args == ("ripple_carry_adder",)
    assert not any(n.startswith("circuit:") for n in judge.JUDGES)


def test_reference_contract_covers_judge_files(files_bench, tmp_path):
    """The import check of reference/ walks judge files: the toy judge
    passes it, a judge file that imports the program does not."""
    folder = tmp_path / "gpu_bench"
    shutil.copytree(files_bench[0] / "gpu_bench/reference",
                    folder / "reference")
    assert reference_imports_of_program(folder) == []
    leaky = folder / "reference/judges/leaky.py"
    leaky.write_text("from tfhe_tpu_torch.models import lut\n")
    assert reference_imports_of_program(folder) == [
        (leaky, "tfhe_tpu_torch.models")]
