"""The program's spans in a ``--trace 1`` run, read after the window from
``tfhe_tpu_torch.utils.observability.spans()``.

The window's reset (``loops.Window.open``) empties the program's records,
and its tracer keeps them only while the profiler records, so they cover
the traced units alone.  A span's stream times (``stream_start_ms``,
``stream_end_ms``) are when the card's stream reached its entry and its
exit: where the card was idle when the span's program was enqueued, they
include the wait for its launch.  Each function returns None where no span
with stream times was recorded: an untraced run, a run without a card, or
a program whose tracer keeps no records.
"""

from __future__ import annotations

PROGRAMS = ("graph.wave", "graph.chain")     # the scheduler's launches


def records() -> list:
    """The program's span records of the run just made (none where the
    program's tracer keeps no records)."""
    from tfhe_tpu_torch.utils import observability as obs
    read = getattr(obs, "spans", None)
    return read() if read is not None else []


def _timed(recs) -> bool:
    return any("stream_start_ms" in r for r in recs)


def _stream_ms(r) -> float:
    return r["stream_end_ms"] - r["stream_start_ms"]


def _host_ms(r) -> float:
    return (r["end_ns"] - r["start_ns"]) / 1e6


def _mean(values):
    return sum(values) / len(values) if values else None


def per_request(request: str, child, value):
    """The mean over the spans named ``request`` of the sum of ``value``
    over their direct children that ``child(name)`` accepts."""
    recs = records()
    if not _timed(recs):
        return None
    tops = {r["id"]: 0.0 for r in recs if r["name"] == request}
    for r in recs:
        if r["parent"] in tops and child(r["name"]):
            tops[r["parent"]] += value(r)
    return _mean(list(tops.values()))


def stage_ms(stage: str):
    """Stream ms a circuit bootstrap of its stage's program (``a``, ``b``
    or ``c``), summed over the stage's replays."""
    return per_request("circuit.bootstrap",
                       lambda name: name == f"graph.circuit.{stage}",
                       _stream_ms)


def launch_host_ms():
    """Host ms a scheduler launch of its program's replay span."""
    recs = records()
    if not _timed(recs):
        return None
    return _mean([_host_ms(r) for r in recs if r["name"] in PROGRAMS])


def idle_ms(run, request: str, per_program: bool):
    """The card's idle ms a ``request`` span (or a program, with
    ``per_program``) between its first program's stream entry and its last
    program's exit: the sum of those extents over the traced requests less
    the card's busy time in the traced window (the profiler's,
    ``run.trace["busy_s"]``).  It holds the wait for each program's launch,
    which a stream span's own times cannot tell from the program, and the
    host's path between programs.  Device work outside the extents (the
    first operands, the outputs' copy) counts as busy: it reads low by
    that, microseconds a request."""
    t = run.trace
    recs = records()
    if not t or not t["busy_s"] or not _timed(recs):
        return None
    tops = {r["id"] for r in recs if r["name"] == request}
    progs: dict = {}
    for r in recs:
        if r["request"] in tops and r["name"].startswith("graph.") \
                and "stream_start_ms" in r:
            progs.setdefault(r["request"], []).append(r)
    if not progs:
        return None
    extent = sum(max(r["stream_end_ms"] for r in rs)
                 - min(r["stream_start_ms"] for r in rs)
                 for rs in progs.values())
    count = sum(map(len, progs.values())) if per_program else len(progs)
    return (extent - 1e3 * t["busy_s"]) / count
