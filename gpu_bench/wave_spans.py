"""The scheduler's programs of one launch kind in a ``--trace 1`` run: the
``graph.wave`` replays whose parent is a ``circuit.wave.<kind>`` span
(``runtime/scheduler.py``: ``binary`` or ``mux``), read as ``spans.py``
reads the program's records."""

from __future__ import annotations

from gpu_bench import spans


def wave_ms(kind: str):
    """Stream ms an evaluation (span ``circuit.evaluate``) of its ``kind``
    programs, summed over the evaluation and averaged over the traced ones;
    None where no span has stream times."""
    recs = spans.records()
    if not spans._timed(recs):
        return None
    evals = {r["id"]: 0.0 for r in recs if r["name"] == "circuit.evaluate"}
    launches = {r["id"] for r in recs if r["name"] == f"circuit.wave.{kind}"}
    for r in recs:
        if r["name"] == "graph.wave" and r["parent"] in launches \
                and r["request"] in evals and "stream_start_ms" in r:
            evals[r["request"]] += spans._stream_ms(r)
    return spans._mean(list(evals.values()))
