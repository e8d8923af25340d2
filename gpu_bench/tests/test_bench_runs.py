"""Every traffic mix run end to end through the harness at the toy sizes on
the CPU (the program's plain kernel versions), the reference agreeing with
the program, and the control and the planted faults found wrong."""

from __future__ import annotations

import time

import pytest

from gpu_bench import harness, server
from gpu_bench.tests.conftest import MIXES

CELLS = [f"{c}.{m}" for c, mixes in MIXES.items() for m in mixes]
SEED = 2**31 + 12345
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def run(toy_bench, cell, trace=False, control=False, seed=SEED):
    root, bench = toy_bench
    return harness.run_cell(root, bench, cell, seed, 0.01, trace, "cpu",
                            time.perf_counter(), control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_agrees(toy_bench, cell):
    result, checks, r = run(toy_bench, cell)
    assert KEYS <= set(result)
    assert result["correct"] and result["failed"] == 0
    assert checks == {"wrong_answers": {"value": 0, "limit": 0}}
    assert r.sampled > 0 and result["attempted"] > 0
    assert "setup_s" in result["metrics"]


def test_traced_run_gives_breakdown(toy_bench):
    result, _, r = run(toy_bench, "gate_toy.wide_b8192", trace=True)
    assert result["correct"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0
    # no card: no device time, so no device metric is read
    assert result["device"]["busy_s"] is None
    assert set(result["metrics"]) == {"key_prep_s"}


def test_new_seed_new_keys_same_seed_same_answers(toy_bench):
    a = run(toy_bench, "gate_toy.wide_b8192", seed=7)[2]
    b = run(toy_bench, "gate_toy.wide_b8192", seed=7)[2]
    assert a.units == b.units


@pytest.mark.parametrize("cell", ["gate_toy.wide_b8192", "cb_toy.b256",
                                  "gate_toy.adder32_i256"])
def test_control_is_wrong(toy_bench, cell):
    """The program on a key cut to control_key_limbs (the lower-precision
    path it has) must come out not correct."""
    result, checks, r = run(toy_bench, cell, control=True)
    assert not result["correct"]
    assert checks["wrong_answers"]["value"] == r.sampled


def _step_unchanged(monkeypatch):
    from tfhe_tpu_torch.boot import blind_rotate
    monkeypatch.setattr(blind_rotate, "cmux_step",
                        lambda eng, a, acc, prep, p: acc)


def _wrap_answers(monkeypatch, change):
    for cls in (server.GateServer, server.CircuitServer):
        make = cls.bootstrap_fn

        def bootstrap_fn(self, make=make):
            fn = make(self)
            return lambda samples: change(samples, fn(samples))
        monkeypatch.setattr(cls, "bootstrap_fn", bootstrap_fn)
    evaluate = server.GateServer.evaluate

    def evaluate_planted(self, circ, inputs, outputs):
        # (wires, instances, n+1): the batch is the instance axis
        out = evaluate(self, circ, inputs, outputs).transpose(0, 1)
        ins = inputs[:len(outputs)].transpose(0, 1)
        return change(ins, out).transpose(0, 1)
    monkeypatch.setattr(server.GateServer, "evaluate", evaluate_planted)


def _half_batch(monkeypatch):
    """Half of every batch left out: its rows come back as they went in
    (zeros where the answer has another shape)."""
    def change(samples, out):
        out = out.clone()
        h = out.shape[0] // 2
        if samples.shape == out.shape:
            out[h:] = samples[h:]
        else:
            out[h:] = 0
        return out
    _wrap_answers(monkeypatch, change)


def _answer_altered(monkeypatch):
    def change(samples, out):
        out = out.clone()
        out[..., -1] += 1
        return out
    _wrap_answers(monkeypatch, change)


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch,
                                   _answer_altered])
@pytest.mark.parametrize("cell", ["gate_toy.wide_b8192", "cb_toy.b256",
                                  "gate_toy.adder32_i256"])
def test_planted_fault_is_caught(toy_bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    result, checks, r = run(toy_bench, cell)
    assert not result["correct"]
    assert checks["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("warm_s,seconds,least", [(0.2, 5.0, 0.2),
                                                  (5.0, 0.05, 0.05),
                                                  (None, 5.0, 0.0)])
def test_warm_runs_the_unit_for_the_mix_warm_seconds(warm_s, seconds, least):
    """A mix's warm_seconds (at most the window's length) repeat the
    warm-up unit before the window; without it the unit runs once."""
    mix = {} if warm_s is None else {"warm_seconds": warm_s}
    ctx = harness.Context({}, mix, "cpu", seconds, None, {}, None, None,
                          None, None)
    calls = []
    t0 = time.perf_counter()
    ctx.warm(lambda: calls.append(1))
    took = time.perf_counter() - t0
    assert took >= least and took < least + 1.0
    assert len(calls) > 1 if least else len(calls) == 1


def test_run_reads_each_metric_by_its_file(toy_bench):
    """A per-layer metric added as a file alone is read in a traced run."""
    root, bench = toy_bench
    path = root / "gpu_bench/metrics/toy_units.py"
    path.write_text("def read(run):\n    return len(run.units)\n")
    extended = dict(bench, per_layer=bench["per_layer"] + [
        {"name": "toy_units", "unit": "launches", "better": "higher",
         "source": "host_clock", "layer": "toy", "moves": "setup_s",
         "workloads": ["gate_toy.wide_b8192"]}])
    try:
        result, _, r = harness.run_cell(root, extended, "gate_toy.wide_b8192",
                                        SEED, 0.01, True, "cpu",
                                        time.perf_counter())
    finally:
        path.unlink()
    assert result["metrics"]["toy_units"]["value"] == len(r.units)
