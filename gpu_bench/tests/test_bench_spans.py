"""The span readers (``gpu_bench/spans.py``) on records made by hand, and on
the program's own records where it keeps none (untraced, or a program
without the tracer's records)."""

from __future__ import annotations

import types

import pytest

from gpu_bench import spans


def _rec(name, rid, parent, request, host=(0, 0), stream=None):
    r = {"name": name, "id": rid, "parent": parent, "request": request,
         "start_ns": host[0] * 10**6, "end_ns": host[1] * 10**6}
    if stream is not None:
        r["stream_start_ms"], r["stream_end_ms"] = stream
    return r


def _query(rid, t0):
    """A circuit bootstrap at stream ms t0: A 2 ms, B 2 x 100, C 4 x 20."""
    recs = [_rec("circuit.bootstrap", rid, None, rid, (t0, t0 + 300))]
    t, host = t0, t0
    for i, (stage, ms) in enumerate([("a", 2)] + [("b", 100)] * 2
                                    + [("c", 20)] * 4):
        recs.append(_rec(f"graph.circuit.{stage}", rid + 1 + i, rid, rid,
                         (host, host + 3), (t, t + ms)))
        t, host = t + ms, host + 3
    return recs


def _evaluation(rid, t0, gaps):
    """An evaluation whose launches run 10 stream ms each, ``gaps`` apart,
    each launch's replay span 2 host ms."""
    recs = [_rec("circuit.evaluate", rid, None, rid)]
    t = t0
    for i, gap in enumerate([0] + gaps):
        t += gap
        wave = rid + 1 + 3 * i
        recs += [_rec("circuit.wave.binary", wave, rid, rid),
                 _rec("sched.operands", wave + 1, wave, rid),
                 _rec("graph.wave", wave + 2, wave, rid, (0, 2),
                      (t, t + 10))]
        t += 10
    return recs


def _run(busy_ms):
    return types.SimpleNamespace(trace={"busy_s": busy_ms / 1e3})


def test_stage_and_replay_readers(monkeypatch):
    recs = _query(1, 0.0) + _query(100, 400.0)
    recs.append(_rec("graph.capture", 200, 100, 100, (0, 50)))
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert spans.stage_ms("a") == pytest.approx(2)
    assert spans.stage_ms("b") == pytest.approx(200)
    assert spans.stage_ms("c") == pytest.approx(80)
    # two queries of 282 stream ms each, the card busy 500 of them
    assert spans.idle_ms(_run(500), "circuit.bootstrap", False) \
        == pytest.approx(32)


def test_scheduler_readers(monkeypatch):
    recs = _evaluation(1, 0.0, [1.0, 3.0]) + _evaluation(50, 100.0, [2.0])
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert spans.launch_host_ms() == pytest.approx(2)
    # five programs of 10 busy ms, 6 ms of gaps between them
    assert spans.idle_ms(_run(50), "circuit.evaluate", True) \
        == pytest.approx(6 / 5)
    assert spans.idle_ms(_run(0), "circuit.evaluate", True) is None
    assert spans.idle_ms(types.SimpleNamespace(trace=None),
                         "circuit.evaluate", True) is None


@pytest.mark.parametrize("recs", [[], _query(1, 0.0)])
def test_nothing_to_read_without_stream_times(monkeypatch, recs):
    for r in recs:
        r.pop("stream_start_ms", None)
        r.pop("stream_end_ms", None)
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert spans.stage_ms("b") is None and spans.launch_host_ms() is None
    assert spans.idle_ms(_run(1), "circuit.bootstrap", False) is None


def test_records_of_a_program_without_them(monkeypatch):
    from tfhe_tpu_torch.utils import observability as obs
    obs.reset()
    with obs.span("untraced"):
        pass
    assert spans.records() == []
    monkeypatch.delattr(obs, "spans")
    assert spans.records() == []
    obs.reset()
