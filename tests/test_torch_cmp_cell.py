"""The benchmark cell ``gate_default_cmp32.cmp32_i256`` on the CPU at a toy of
its configuration.

The cell runs the mix ``gpu_bench/traffic/cmp32_i256.json`` (32-bit
comparisons for 256 instances an evaluation) through its own loop file,
``traffic/mux_circuit.py`` (``runtime.scheduler.comparator`` evaluated by
``scheduler.evaluate``), judged by its own judge file,
``reference/judges/comparator.py`` (its own netlist, evaluated level by
level with the reference's gate bootstrap, a MUX as the program's three
bootstraps).  Here the same loop and judge run end to end through
``gpu_bench.harness.run_cell`` at GATE_TOY and ``comparator(4)`` over 3
instances, with the port's plain kernel versions: the reference agrees
with the program; the judge's answers decrypt to lt, eq and gt; the
control and two planted MUX faults read every sampled answer wrong; the
loop's bootstrap count is the program's, and ``bootstrap.launches`` splits
into binary launches and two a MUX launch.  The evaluation's roofline and
the cell's entries and readers are held to their formulas.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from gpu_bench import harness, roofline
from gpu_bench.client import Client
from gpu_bench.roofline import circuit as circ_roof
from gpu_bench.tests.test_bench_contract import reference_imports_of_program
from gpu_bench.tests.toy_configs import GATE_TOY

REPO = Path(__file__).resolve().parents[1]
SEED = 2**31 + 27127
CELL = "gate_toy_cmp4.cmp4_i3"
REAL_CELL = "gate_default_cmp32.cmp32_i256"
CMP_CONFIG = "gpu_bench/configs/gate_default_cmp32.json"
JUDGE = REPO / "gpu_bench/reference/judges/comparator.py"
H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
TOY = dict(GATE_TOY, name="gate_toy_cmp4", circuit="comparator", bits=4)
TOY_MIX = {"loop": "mux_circuit", "circuit": "comparator", "bits": 4,
           "instances": 3, "pool": 2, "sample": 3, "trace_units": 1}
# comparator(4): 12 binary gates and 3 MUXes (21 bootstraps an instance);
# at 3 instances 4 binary launches and 2 MUX launches an evaluation
PER_INSTANCE, BINARY_LAUNCHES, MUX_LAUNCHES = 21, 4, 2


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


judge = _load(JUDGE, "judge_comparator")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy_bench(tmp_path_factory):
    """(root, bench): a checkout-like copy of the benchmark with the toy
    configuration, its mix and its cell added as files."""
    root = tmp_path_factory.mktemp("cmp_cell_checkout")
    shutil.copytree(REPO / "gpu_bench", root / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    rel = "gpu_bench/configs/gate_toy_cmp4.json"
    (root / rel).write_text(json.dumps(TOY))
    (root / "gpu_bench/traffic/cmp4_i3.json").write_text(json.dumps(TOY_MIX))
    bench["configs"].append({"name": TOY["name"], "file": rel,
                             "source": TOY["source"], "reduced": [],
                             "why": "toy size"})
    bench["workloads"].append({"name": CELL, "config": TOY["name"],
                               "traffic": "cmp4_i3", "chips": 1,
                               "why": "toy size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL_CELL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


def _run(toy_bench, control=False):
    root, bench = toy_bench
    return harness.run_cell(root, bench, CELL, SEED, 0.01, False, "cpu",
                            time.perf_counter(), control=control)


def test_cell_runs_and_agrees(toy_bench):
    """Correct over 3 sampled instances; a unit is one evaluation of 3
    answers and 21 bootstraps an instance, as many as the program counts;
    bootstrap.launches = binary launches + 2 x circuit.mux_launches."""
    result, checks, run = _run(toy_bench)
    assert result["correct"] and result["failed"] == 0
    assert checks == {"wrong_answers": {"value": 0, "limit": 0}}
    assert run.sampled == 3
    assert {(u["answers"], u["bootstraps"], u["bound_s"])
            for u in run.units} == {(3, 3 * PER_INSTANCE, None)}
    assert {"setup_s", "circuit_gbs_per_s"} <= set(result["metrics"])
    c, evals = run.counters, len(run.units)
    assert c["bootstrap.ciphertexts"] == sum(u["bootstraps"]
                                             for u in run.units)
    assert (c["circuit.mux_gates"], c["circuit.mux_launches"]) == \
        (9 * evals, MUX_LAUNCHES * evals)
    assert c["bootstrap.launches"] == \
        BINARY_LAUNCHES * evals + 2 * c["circuit.mux_launches"]


def test_launches_at_32_bits_by_256():
    """The cell's evaluation: 8 binary and 6 MUX launches, 20 bootstrap
    launches, 48,384 rows (189 an instance, the judge's count)."""
    from tfhe_tpu_torch.runtime import scheduler
    from tfhe_tpu_torch.utils import observability as obs
    obs.reset()
    launches = scheduler.launch_list(scheduler.comparator(32)[0], 256)
    kinds = [k for k, _ in launches]
    assert (kinds.count("binary"), kinds.count("mux")) == (8, 6)
    c = obs.report()["counters"]
    assert (c["circuit.mux_launches"], c["circuit.mux_gates"]) == \
        (6, 31 * 256)
    rows = sum((3 if k == "mux" else 1) * len(g) * 256 for k, g in launches)
    net = judge.comparator(32)
    per = sum(3 if kind == "mux" else 1 for kind, *_ in net[1])
    assert rows == per * 256 == 48384
    assert kinds.count("binary") + 2 * kinds.count("mux") == 20
    obs.reset()


@pytest.mark.parametrize("x,y", [(0, 0), (5, 9), (9, 5), (15, 15), (0, 15),
                                 (8, 7)])
def test_judge_decrypts_to_lt_eq_gt(x, y):
    client = Client(SEED + 16 * x + y, "cpu")
    secret, raw = client.gate_key(GATE_TOY)
    bits = torch.tensor([(v >> i) & 1 for v in (x, y) for i in range(4)])
    msgs = torch.where(bits == 1, 1 << 29, -(1 << 29))
    inputs = client.lwe(secret["lwe_key"], msgs,
                        2.0 ** GATE_TOY["lwe_stdev_log2"])
    out = judge.judge(inputs[None], raw, GATE_TOY, {"bits": 4})[0]
    phase = out[:, -1] - (out[:, :-1] * secret["lwe_key"]).sum(-1)
    got = ((phase + (1 << 31)) % (1 << 32) - (1 << 31) > 0).tolist()
    assert got == [x < y, x == y, x > y]


def _mux_returns_y(monkeypatch):
    """A MUX with its data inputs swapped: y where c asks for x."""
    from tfhe_tpu_torch.boot import gate
    mux = gate.gate_mux
    monkeypatch.setattr(gate, "gate_mux",
                        lambda ck, c, x, y, *a, **kw: mux(ck, c, y, x, *a,
                                                          **kw))


def _mux_skips_second_bootstrap(monkeypatch):
    """A MUX that returns u0 + u1 + 1/8 unbootstrapped."""
    from tfhe_tpu_torch.boot import gate

    def planted(ck_data, c, x, y, params, backend="matmul"):
        n = params.lwe.n
        lo = gate._trivial(-gate.MU_BOOL, n, c.device)
        tt = torch.stack([lo + c + x, lo - c + y])
        u = gate.bootstrap(tt.reshape(-1, n + 1), ck_data, params,
                           gate.MU_BOOL, backend).reshape(tt.shape)
        return u[0] + u[1] + gate._trivial(gate.MU_BOOL, n, c.device)
    monkeypatch.setattr(gate, "gate_mux", planted)


@pytest.mark.parametrize("case", ["control", "mux_returns_y",
                                  "mux_skips_second_bootstrap"])
def test_control_and_planted_faults_read_every_answer_wrong(
        toy_bench, monkeypatch, case):
    if case == "mux_returns_y":
        _mux_returns_y(monkeypatch)
    elif case == "mux_skips_second_bootstrap":
        _mux_skips_second_bootstrap(monkeypatch)
    result, checks, run = _run(toy_bench, control=case == "control")
    assert not result["correct"]
    assert checks["wrong_answers"]["value"] == run.sampled == 3


def test_loop_refuses_a_mix_of_another_width():
    loop = _load(REPO / "gpu_bench/traffic/mux_circuit.py",
                 "loop_mux_circuit")
    ctx = SimpleNamespace(mix={"circuit": "comparator", "bits": 16,
                               "instances": 2},
                          cfg={"circuit": "comparator", "bits": 32},
                          server=None)
    with pytest.raises(SystemExit, match=r"comparator\(16\) .* "
                                         r"comparator\(32\)"):
        loop.run(ctx)


def _bound_by_hand(cfg, rows):
    """n steps of ``rows`` accumulators: int8 MACs (k+1)l (k+1) 4 N^2 a
    row, bytes the raw key and the accumulators in and out, torus32."""
    N, n = cfg["N"], cfg["n"]
    macs = rows * 2 * cfg["l"] * 2 * 4 * N * N
    nbytes = (2 * cfg["l"] * 2 * N + 2 * rows * 2 * N) * 4
    return n * max(2 * macs / H100["int8_ops_per_s"],
                   nbytes / H100["bytes_per_s"])


def test_evaluation_roofline_by_hand_at_the_toy():
    """comparator(4): level 1 is 8 binary gates, levels 2 and 3 two and one
    AND beside as many MUXes (two rows each, then one), level 4 the NOR."""
    batches = judge.batches(judge.comparator(4))
    assert batches == [8, 6, 2, 3, 1, 1]
    want = sum(_bound_by_hand(GATE_TOY, 3 * b) for b in batches)
    assert circ_roof.evaluation_s(GATE_TOY, batches, 3, H100) == \
        pytest.approx(want, rel=1e-12)


def test_evaluation_roofline_at_gate_default():
    """32 bits x 256: 48,384 rows, 630 steps at 50.9 ns a row-step (by
    operations): ~1.55 s an evaluation."""
    cfg = json.loads((REPO / CMP_CONFIG).read_text())
    batches = judge.batches(judge.comparator(32))
    assert batches == [64, 48, 16, 24, 8, 12, 4, 6, 2, 3, 1, 1] and \
        sum(batches) == 189
    assert circ_roof.evaluation_s(cfg, batches, 256, H100) == \
        pytest.approx(48384 * 630 * 50.86e-9, rel=1e-3)


def test_cell_entries():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[REAL_CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("gate_default_cmp32", "cmp32_i256", 1)
    assert len(cell["why"]) <= 200
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    # appended after the cells before it; later cells follow it
    assert metrics["circuit_gbs_per_s"]["workloads"].index(REAL_CELL) == 1
    assert metrics["key_prep_s"]["workloads"].index(REAL_CELL) == 6
    layers = {"mux_ms.cmp": "boot/gate.py gate_mux and runtime/scheduler.py",
              "binary_ms.cmp": "boot/gate.py gate_mux and runtime/scheduler.py",
              "br_roofline.cmp": metrics["br_roofline.gate"]["layer"],
              "device_idle.cmp": metrics["device_idle.circuit"]["layer"],
              "sched.gap_ms.cmp": metrics["sched.gap_ms"]["layer"]}
    names = [m["name"] for m in bench["per_layer"]]
    start = names.index("mux_ms.cmp")
    assert names[start:start + 5] == list(layers)
    for name, layer in layers.items():
        m = metrics[name]
        assert (m["workloads"], m["moves"], m["layer"]) == \
            ([REAL_CELL], "circuit_gbs_per_s", layer)
    mix = json.loads((REPO / "gpu_bench/traffic/cmp32_i256.json").read_text())
    assert mix == {"loop": "mux_circuit", "circuit": "comparator", "bits": 32,
                   "instances": 256, "pool": 2, "sample": 16,
                   "trace_units": 1}


def test_configuration_is_gate_default_with_its_circuit():
    """Every number of ``gate_default.json`` (nothing cut), plus the
    netlist and its width, which are the mix's; its own source."""
    from gpu_bench import server
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {c["name"]: c for c in bench["configs"]}
    entry, base = entries["gate_default_cmp32"], entries["gate_default"]
    assert entry["file"] == CMP_CONFIG and entry["reduced"] == []
    assert len(entry["why"]) <= 200
    assert entry["source"] != base["source"] and len(entry["source"]) <= 200
    cfg = json.loads((REPO / CMP_CONFIG).read_text())
    old = json.loads((REPO / base["file"]).read_text())
    assert (cfg["name"], cfg["source"]) == ("gate_default_cmp32",
                                            entry["source"])
    assert (cfg["circuit"], cfg["bits"], cfg["assumed"], cfg["reduced"]) == \
        ("comparator", 32, ["circuit"], [])
    own = {"name", "source", "deployment", "circuit", "bits", "assumed"}
    assert {k: v for k, v in cfg.items() if k not in own} == \
        {k: v for k, v in old.items() if k not in own}
    server.gate_params(cfg)           # raises unless GATE_DEFAULT's numbers


def test_judge_imports_only_torch_and_the_reference():
    assert reference_imports_of_program(REPO / "gpu_bench") == []
    from gpu_bench.tests.test_bench_contract import _imports
    assert _imports(JUDGE) == {"torch", "gpu_bench.reference"}


def _records():
    """One traced evaluation: a binary launch (stream 0-10 ms), a MUX launch
    (10-30) and a binary one (31-35), each with its operands span."""
    recs = [{"name": "circuit.evaluate", "id": 1, "parent": None,
             "request": 1}]
    for i, (kind, t0, t1) in enumerate((("binary", 0.0, 10.0),
                                        ("mux", 10.0, 30.0),
                                        ("binary", 31.0, 35.0))):
        top = 10 * (i + 1)
        recs += [{"name": f"circuit.wave.{kind}", "id": top, "parent": 1,
                  "request": 1},
                 {"name": "sched.operands", "id": top + 1, "parent": top,
                  "request": 1},
                 {"name": "graph.wave", "id": top + 2, "parent": top,
                  "request": 1, "stream_start_ms": t0, "stream_end_ms": t1}]
    return recs


def test_metric_readers(toy_bench, monkeypatch):
    """The MUX and binary programs' stream ms, the idle ms a program, the
    roofline over busy and the idle share, on one traced evaluation; None
    without span records."""
    from gpu_bench import spans
    root, bench = toy_bench
    run = harness.Run({}, {}, {}, 1.0, 1.0, 1.0,
                      [{"bound_s": 0.0102, "bootstraps": 63},
                       {"bound_s": 0.0102, "bootstraps": 63}], {},
                      {"busy_s": 0.032, "window_s": 0.04, "units": 1})
    read = lambda name: harness.read_metric(root, bench, name, run)  # noqa
    monkeypatch.setattr(spans, "records", lambda: [])
    for name in ("mux_ms.cmp", "binary_ms.cmp", "sched.gap_ms.cmp"):
        assert read(name) is None
    monkeypatch.setattr(spans, "records", _records)
    assert read("mux_ms.cmp") == pytest.approx(20.0)
    assert read("binary_ms.cmp") == pytest.approx(14.0)
    assert read("sched.gap_ms.cmp") == pytest.approx((35.0 - 32.0) / 3)
    assert read("br_roofline.cmp") == pytest.approx(100 * 0.0102 / 0.032)
    assert read("device_idle.cmp") == pytest.approx(20.0)
    run.trace = None                                    # an untraced run
    for name in ("br_roofline.cmp", "device_idle.cmp", "sched.gap_ms.cmp"):
        assert read(name) is None
