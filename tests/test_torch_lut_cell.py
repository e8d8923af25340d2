"""The benchmark cell ``cb_active.lut4_b256`` on the CPU at a toy of its
configuration.

The cell runs the mix ``gpu_bench/traffic/lut4_b256.json`` (64 four-bit
LUT queries a launch) through its own loop file, ``traffic/lut_stream.py``
(``models.lut.make_lut_staged``), judged by its own judge file,
``reference/judges/lut_tree.py`` (the reference's circuit bootstrap and a
plain CMux tree).  Here the same mix, loop and judge run end to end through
``gpu_bench.harness.run_cell`` at CB_TOY with the port's plain kernel
versions: the reference agrees with the program; the control (a key cut
to ``control_key_limbs``) and the planted faults (every LUT answer
altered, every selector altered where it is produced) read every sampled
LUT wrong; a program without the staged LUT entry stops the run before a
key is made.  The tree's roofline counts and the cell's metric readers
are held to their formulas.

Beside them, the tests of ``gpu_bench/tests/test_bench_files_alone.py`` (a
toy cell with its own loop and judge files, added to a copy of the
benchmark as new files) run here too.
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
from gpu_bench.roofline import lut as lut_roof
from gpu_bench.tests.test_bench_files_alone import (  # noqa: F401
    files_bench, test_builtin_judge_resolves_to_its_function,
    test_builtin_loop_resolves_to_its_function,
    test_file_cell_is_judged_by_its_judge_file,
    test_missing_judge_file_names_its_path,
    test_missing_loop_file_stops_before_a_key_is_made,
    test_netlist_judge_resolves_when_asked_for,
    test_reference_contract_covers_judge_files)
from gpu_bench.tests.test_bench_runs import _answer_altered
from gpu_bench.tests.toy_configs import CB_TOY

REPO = Path(__file__).resolve().parents[1]
SEED = 2**31 + 25125
CELL = "cb_toy.lut4_b256"
REAL_CELL = "cb_active.lut4_b256"
LUT_CONFIG = "gpu_bench/configs/cb_active_lut4.json"
H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy_bench(tmp_path_factory):
    """(root, bench): a checkout-like copy of the benchmark with the toy
    configuration and its ``lut4_b256`` cell added as files."""
    root = tmp_path_factory.mktemp("lut_cell_checkout")
    shutil.copytree(REPO / "gpu_bench", root / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    rel = "gpu_bench/configs/cb_toy.json"
    (root / rel).write_text(json.dumps(CB_TOY))
    bench["configs"].append({"name": "cb_toy", "file": rel,
                             "source": CB_TOY["source"], "reduced": [],
                             "why": "toy size"})
    bench["workloads"].append({"name": CELL, "config": "cb_toy",
                               "traffic": "lut4_b256", "chips": 1,
                               "why": "toy size"})
    # the metrics that list their cells list the toy cell beside the real one
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL_CELL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


def _run(toy_bench, control=False):
    root, bench = toy_bench
    return harness.run_cell(root, bench, CELL, SEED, 0.01, False, "cpu",
                            time.perf_counter(), control=control)


def _lut_answers_altered(monkeypatch):
    """The benchmark's planted "answer altered" fault (every answer's last
    coefficient + 1), on the LUT entry's answers."""
    from tfhe_tpu_torch.models import lut
    make = lut.make_lut_staged

    def planted(*args, **kw):
        fn = make(*args, **kw)

        def altered(samples, key_data, leaves):
            out = fn(samples, key_data, leaves).clone()
            out[..., -1] += 1
            return out
        return altered
    monkeypatch.setattr(lut, "make_lut_staged", planted)
    _answer_altered(monkeypatch)


def _selectors_altered(monkeypatch):
    """The same fault on the TRGSWs, where the LUT entry takes them from
    the staged circuit bootstrap."""
    from tfhe_tpu_torch.boot import circuit
    make = circuit.make_circuit_bootstrap_staged

    def planted(*args, **kw):
        fn = make(*args, **kw)

        def altered(samples, key_data):
            out = fn(samples, key_data).clone()
            out[..., -1] += 1
            return out
        return altered
    monkeypatch.setattr(circuit, "make_circuit_bootstrap_staged", planted)


def test_cell_runs_and_agrees(toy_bench, monkeypatch):
    """The run reads correct over 4 sampled LUTs, a unit is one launch of 64
    answers and 256 selector bits, and every launch runs the circuit
    bootstrap's programs and one tree program."""
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
    assert run.sampled == 4
    assert {(u["answers"], u["bootstraps"]) for u in run.units} == {(64, 256)}
    assert "setup_s" in result["metrics"] and "cb_per_s" in result["metrics"]
    c = run.counters
    launches = len(run.units)
    assert (c["lut.launches"], c["lut.instances"], c["lut.cmux_rows"]) == \
        (launches, 64 * launches, 960 * launches)
    assert sites.count("lut.tree") == launches + 1          # + warm-up
    assert sites.count("circuit.a") == launches + 1


@pytest.mark.parametrize("case", ["control", "answers_altered",
                                  "selectors_altered"])
def test_control_and_planted_faults_read_every_lut_wrong(toy_bench,
                                                         monkeypatch, case):
    if case == "answers_altered":
        _lut_answers_altered(monkeypatch)
    elif case == "selectors_altered":
        _selectors_altered(monkeypatch)
    result, checks, run = _run(toy_bench, control=case == "control")
    assert not result["correct"]
    assert checks["wrong_answers"]["value"] == run.sampled == 4


def test_program_without_the_staged_entry_stops_before_a_key(toy_bench,
                                                             monkeypatch):
    """A program that lacks make_lut_staged (as the package did before the
    entry existed): the loop file's import fails, before the client makes
    a key."""
    from tfhe_tpu_torch.models import lut
    made = []
    monkeypatch.delattr(lut, "make_lut_staged")
    monkeypatch.setattr(harness, "Client", lambda *a: made.append(a))
    with pytest.raises(ImportError, match="make_lut_staged"):
        _run(toy_bench)
    assert made == []


def test_cell_entries():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[REAL_CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("cb_active_lut4", "lut4_b256", 1)
    assert len(cell["why"]) <= 200
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    assert metrics["cb_per_s"]["workloads"][-1] == REAL_CELL
    # appended after the five cells before it; later cells follow it
    assert metrics["key_prep_s"]["workloads"].index(REAL_CELL) == 5
    for name in ("lut_tree_ms.cb_lut", "lut_roofline.cb_lut",
                 "device_idle.cb_lut", "rotation_ms.cb_lut",
                 "privks_ms.cb_lut", "preks_ms.cb_lut",
                 "br_roofline.cb_lut"):
        assert metrics[name]["workloads"] == [REAL_CELL]
        assert metrics[name]["moves"] == "cb_per_s"


def test_lut_configuration_is_cb_active_with_its_table():
    """The cell's configuration: CB_ACTIVE's numbers, every one as in
    ``cb_active.json`` (nothing cut), plus the table's width, which is the
    mix's; its own source and file, apart from ``cb_active``'s."""
    from gpu_bench import server
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {c["name"]: c for c in bench["configs"]}
    entry, base = entries["cb_active_lut4"], entries["cb_active"]
    assert entry["file"] == LUT_CONFIG and entry["reduced"] == []
    assert entry["source"] != base["source"] and len(entry["source"]) <= 200
    cfg = json.loads((REPO / LUT_CONFIG).read_text())
    old = json.loads((REPO / base["file"]).read_text())
    assert (cfg["name"], cfg["source"]) == ("cb_active_lut4", entry["source"])
    own = {"name", "source", "deployment", "lut_bits"}
    assert {k: v for k, v in cfg.items() if k not in own} == \
        {k: v for k, v in old.items() if k not in own}
    mix = json.loads((REPO / "gpu_bench/traffic/lut4_b256.json").read_text())
    assert cfg["lut_bits"] == mix["lut_bits"] == 4
    server.circuit_params(cfg)        # raises unless CB_ACTIVE's numbers


def test_loop_refuses_a_mix_of_another_width():
    spec = importlib.util.spec_from_file_location(
        "loop_lut_stream", REPO / "gpu_bench/traffic/lut_stream.py")
    loop = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loop)
    ctx = SimpleNamespace(mix={"lut_bits": 3, "instances": 2},
                          cfg={"lut_bits": 4}, server=None)
    with pytest.raises(SystemExit, match="3-bit LUTs .* 4-bit"):
        loop.run(ctx)


def test_tree_roofline_counts_at_cb_toy():
    """MACs instances (2^k - 1) (k+1) l1 N1 (k+1) N1 4; bytes the
    selectors, the leaves, the rows written (2^k - 1 a tree) and read
    (2^k - 2: every level but the first reads the last one's rows)."""
    inst, k, N, l = 3, 4, CB_TOY["n_lvl1"], CB_TOY["ell_lvl1"]
    row = 2 * N * 4
    macs, nbytes = lut_roof.tree_work(CB_TOY, inst, k)
    assert macs == inst * 15 * (2 * l * N) * (2 * N) * 4
    assert nbytes == (inst * k * 2 * l * row + 16 * row + inst * 15 * row
                      + inst * 14 * row)


def test_tree_bound_at_cb_active():
    """64 four-bit LUTs at CB_ACTIVE: 32.2 G int8 MACs, 0.0326 ms by
    operations; its 23.7 MB take 0.0071 ms."""
    cfg = json.loads((REPO / LUT_CONFIG).read_text())
    macs, nbytes = lut_roof.tree_work(cfg, 64, 4)
    assert macs == 64 * 15 * 4096 * 2048 * 4
    assert nbytes / H100["bytes_per_s"] * 1e3 == pytest.approx(0.0071,
                                                               abs=1e-4)
    assert lut_roof.tree_bound_s(cfg, 64, 4, H100) * 1e3 == pytest.approx(
        0.03255, abs=1e-4)


def _records():
    """Two traced launches: programs A, B (two replays) and C under the
    circuit bootstrap, then the tree, stream ms 0.4 and 0.2."""
    recs = []
    for i, ms in enumerate((0.4, 0.2)):
        top = 10 * i + 1
        recs += [{"name": "lut.eval", "id": top, "parent": None,
                  "request": top},
                 {"name": "circuit.bootstrap", "id": top + 1, "parent": top,
                  "request": top}]
        for j, (stage, t0, t1) in enumerate((("a", 0.0, 4.0),
                                             ("b", 4.0, 254.0),
                                             ("b", 254.0, 504.0),
                                             ("c", 504.0, 508.0))):
            recs.append({"name": f"graph.circuit.{stage}", "id": top + 2 + j,
                         "parent": top + 1, "request": top,
                         "stream_start_ms": t0, "stream_end_ms": t1})
        recs.append({"name": "graph.lut.tree", "id": top + 6, "parent": top,
                     "request": top, "stream_start_ms": 508.0,
                     "stream_end_ms": 508.0 + ms})
    return recs


def test_metric_readers(toy_bench, monkeypatch):
    """Every reader of the cell on two traced launches: the tree's stream
    ms, its roofline over the loop's tree_busy_s, the circuit bootstrap's
    programs, the blind rotations' roofline and the idle share."""
    from gpu_bench import spans
    root, bench = toy_bench
    cfg = json.loads((REPO / LUT_CONFIG).read_text())
    units = [{"bound_s": 0.1, "tree_busy_s": 0.3e-3},
             {"bound_s": 0.1, "tree_busy_s": 0.1e-3}, {"bound_s": 0.1}]
    run = harness.Run({}, cfg, {"instances": 64, "lut_bits": 4}, 1.0, 1.0,
                      1.0, units, {},
                      {"busy_s": 0.75, "window_s": 1.0, "units": 2})
    read = lambda name: harness.read_metric(root, bench, name, run)  # noqa
    monkeypatch.setattr(spans, "records", lambda: [])
    for name in ("lut_tree_ms.cb_lut", "rotation_ms.cb_lut",
                 "privks_ms.cb_lut", "preks_ms.cb_lut"):
        assert read(name) is None
    monkeypatch.setattr(spans, "records", _records)
    assert read("lut_tree_ms.cb_lut") == pytest.approx(0.3)
    assert read("preks_ms.cb_lut") == pytest.approx(4.0)
    assert read("rotation_ms.cb_lut") == pytest.approx(500.0)
    assert read("privks_ms.cb_lut") == pytest.approx(4.0)
    assert read("device_idle.cb_lut") == pytest.approx(25.0)
    assert read("br_roofline.cb_lut") == pytest.approx(100 * 0.2 / 0.75)
    assert read("lut_roofline.cb_lut") is None          # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    want = 100 * lut_roof.tree_bound_s(cfg, 64, 4, H100) / 0.2e-3
    assert read("lut_roofline.cb_lut") == pytest.approx(want)
    run.units = [{"bound_s": 0.1}]                      # an untraced run
    assert read("lut_roofline.cb_lut") is None


def _event(name, start, end, device):
    kind = torch.autograd.DeviceType.CUDA if device \
        else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=start, end=end))


def test_tree_busy_groups_the_lut_kernels_by_launch():
    """The loop's tree_busy_s: the card's lut_cmux kernels in start order,
    k a traced unit; the host's launch calls, other kernels and a last
    incomplete tree give nothing; an untraced run annotates no unit."""
    spec = importlib.util.spec_from_file_location(
        "loop_lut_stream", REPO / "gpu_bench/traffic/lut_stream.py")
    loop = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loop)
    events = [_event("void lut_cmux_kernel<4>(Args)", 300, 340, True),
              _event("void lut_cmux_kernel<4>(Args)", 100, 110, True),
              _event("void ck_dot64p_kernel(Args)", 110, 290, True),
              _event("tfhe_lut_cmux", 0, 500, False),
              _event("void lut_cmux_kernel<4>(Args)", 120, 150, True),
              _event("void lut_cmux_kernel<4>(Args)", 400, 405, True),
              _event("void lut_cmux_kernel<4>(Args)", 350, 370, True)]
    prof = SimpleNamespace(events=lambda: events)
    units = [{}, {}, {}]
    loop._tree_busy(prof, units, 2)
    assert units[0]["tree_busy_s"] == pytest.approx(40e-6)
    assert units[1]["tree_busy_s"] == pytest.approx(60e-6)
    assert "tree_busy_s" not in units[2]
    untraced = [{}]
    loop._tree_busy(None, untraced, 2)
    assert untraced == [{}]
