"""The port's tracer (tfhe_tpu_torch.utils.observability) on the CPU:

  * under torch.profiler the staged circuit bootstrap at CB_TOY records
    ``circuit.bootstrap`` with the children A, B (one a rotation) and C
    (one a TRGSW row block) under one request id, and
    ``scheduler.evaluate`` at GATE_TOY (TFHE_WAVE_CHAIN 1 and 2) records
    ``circuit.evaluate`` -> ``circuit.wave.*`` / ``circuit.chain`` ->
    ``sched.operands`` then ``graph.wave`` / ``graph.chain``;
  * the profiler's own events hold each span, nested in time as the
    records are;
  * with the profiler off no record is kept, and the counters and span
    counts are those of a traced run; ``reset()`` clears the records;
    spans inside ``muted()`` keep none.

Stream times need the card (tests/test_torch_cuda.py).
"""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tfhe_tpu_torch import graphs, lwe
from tfhe_tpu_torch.boot import circuit, gate
from tfhe_tpu_torch.params import CB_TOY, GATE_TOY
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.runtime import scheduler
from tfhe_tpu_torch.utils import observability as obs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _circuit_keys():
    rng = TfheRng(31)
    sk = circuit.CircuitSecretKey.generate(CB_TOY, rng)
    ck = circuit.CircuitCloudKey.generate(sk, rng, backend="chunked",
                                          device="cpu")
    msgs = np.where(np.array([1, 0, 1]).astype(bool), -(1 << 31), 0)
    ct = lwe.encrypt(sk.lwe_lvl1, msgs.astype(np.int32), rng, 2.0**-20,
                     device="cpu")
    return ck, ct


@functools.lru_cache(maxsize=None)
def _gate_keys():
    rng = TfheRng(17)
    sk = gate.SecretKey.generate(GATE_TOY, rng)
    ck = gate.CloudKey.generate(sk, rng, backend="onthefly", device="cpu")
    bits = np.random.default_rng(5).integers(0, 2, (4, 2))
    cts = torch.stack([gate.encrypt_bool(sk, b, rng, device="cpu")
                       for b in bits])
    return ck, cts


def _staged(shared):
    """The staged bootstrap of three bits, to be called (keys made now)."""
    ck, ct = _circuit_keys()
    fn = circuit.make_circuit_bootstrap_staged(CB_TOY,
                                               shared_rotation=shared)
    return lambda: fn(ct, ck.data)


def _evaluate(monkeypatch, chain):
    """A 2-bit adder over two instances, to be called (keys made now)."""
    monkeypatch.setenv("TFHE_WAVE_CHAIN", str(chain))
    ck, cts = _gate_keys()
    circ, outs = scheduler.ripple_carry_adder(2)
    return lambda: scheduler.evaluate(circ, cts, ck.data, GATE_TOY, outs,
                                      backend="onthefly")


def _traced(fn):
    """(records, the profiler's events) of fn() run under torch.profiler,
    from a fresh registry."""
    graphs.clear()
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return obs.spans(), prof.events()


def _children(recs, parent):
    return [r["name"] for r in recs if r["parent"] == parent["id"]]


@pytest.mark.parametrize("shared", [False, True])
def test_staged_circuit_bootstrap_spans(shared):
    recs, _ = _traced(_staged(shared))
    (top,) = [r for r in recs if r["parent"] is None]
    assert top["name"] == "circuit.bootstrap" and top["request"] == top["id"]
    assert {r["request"] for r in recs} == {top["id"]}
    ell1, kp1 = CB_TOY.tgsw_lvl1.l, CB_TOY.lvl1.k + 1
    levels = 1 if shared else ell1
    assert _children(recs, top) == (["graph.circuit.a"]
                                    + ["graph.circuit.b"] * levels
                                    + ["graph.circuit.c"] * (ell1 * kp1))
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
        assert "stream_start_ms" not in r           # no card, no stream time


@pytest.mark.parametrize("chain", [1, 2])
def test_evaluate_spans(monkeypatch, chain):
    recs, _ = _traced(_evaluate(monkeypatch, chain))
    (top,) = [r for r in recs if r["parent"] is None]
    assert top["name"] == "circuit.evaluate"
    assert {r["request"] for r in recs} == {top["id"]}
    launches = [r for r in recs if r["parent"] == top["id"]]
    names = {r["name"] for r in launches}
    want = "circuit.chain" if chain > 1 else "circuit.wave.binary"
    assert names == {want}
    prog = "graph.chain" if chain > 1 else "graph.wave"
    for launch in launches:
        assert _children(recs, launch) == ["sched.operands", prog]
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"]


@pytest.mark.parametrize("case", ["circuit_bootstrap", "evaluate"])
def test_profiler_events_nest_as_the_records(monkeypatch, case):
    """Each span is one of the profiler's events, inside its parent's."""
    fn = (_staged(False) if case == "circuit_bootstrap"
          else _evaluate(monkeypatch, 2))
    recs, events = _traced(fn)
    names = {r["name"] for r in recs}
    by_name: dict = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.name in names:
            by_name.setdefault(e.name, []).append(e.time_range)
    seen: dict = {}
    ranges = {}
    for r in recs:                                   # opened in order
        i = seen[r["name"]] = seen.get(r["name"], -1) + 1
        ranges[r["id"]] = by_name[r["name"]][i]
    for name in names:
        assert len(by_name[name]) == seen[name] + 1, name
    for r in recs:
        if r["parent"] is not None:
            inner, outer = ranges[r["id"]], ranges[r["parent"]]
            assert outer.start <= inner.start and inner.end <= outer.end


def test_off_keeps_no_records_and_counts_the_same(monkeypatch):
    """Without a profiler nothing is recorded, and the counters and span
    counts equal those of the same run traced."""
    evaluate, staged = _evaluate(monkeypatch, 1), _staged(False)
    graphs.clear()
    obs.reset()
    evaluate()
    staged()
    off = obs.report()
    assert obs.spans() == []
    recs, _ = _traced(lambda: (evaluate(), staged()))
    on = obs.report()
    assert recs and on["counters"] == off["counters"]
    assert {k: v["count"] for k, v in on["spans"].items()} == \
        {k: v["count"] for k, v in off["spans"].items()}
    assert off["observations"].keys() == on["observations"].keys()
    assert not any("stream_ms_total" in v for v in on["spans"].values())
    obs.reset()
    assert obs.spans() == [] and obs.report()["spans"] == {}


def test_muted_and_nesting():
    """Spans inside muted() keep their host aggregate and no record; a
    span opened in another request starts a new request id."""
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("outer"):
            with obs.muted():
                with obs.span("quiet"):
                    pass
            with obs.span("inner", stream=torch.device("cpu")):
                pass
        with obs.span("second"):
            pass
    recs = obs.spans()
    assert [r["name"] for r in recs] == ["outer", "inner", "second"]
    outer, inner, second = recs
    assert inner["parent"] == outer["id"] == inner["request"]
    assert second["parent"] is None and second["request"] == second["id"]
    assert obs.report()["spans"]["quiet"]["count"] == 1
    obs.reset()
