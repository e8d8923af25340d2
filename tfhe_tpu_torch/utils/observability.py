"""The port's tracer: spans, counters and a metrics registry (the port's
copy of ``tfhe_tpu.utils.observability``, which stays as it is).

Process-local metrics recorded at the library's operation boundaries, which
embedders can scrape or reset:

  with span("circuit.evaluate"):   # a timed region, nestable
      ...
  count("gates", 128)              # monotonic counters
  observe("wave_width", 64)        # value distributions (min/max/mean)
  report() -> {"spans": {...}, "counters": {...}, "observations": {...}}
  spans()  -> [one record per span closed while a profiler recorded]

Every span adds its host wall time to a per-name aggregate (count, total,
max).  Work on the card is asynchronous, so a span around a launch times
the enqueue.

The tracer is on exactly while a ``torch.profiler`` session records (its
profiler-enabled flag; no other setting).  Then a span also

  * opens a host range ``name`` in the profiler (a ``cpu_op``, not
    ``record_function``'s ``user_annotation``, which the profiler mirrors
    onto the card's timeline as a ``gpu_user_annotation`` over the kernels
    launched inside it, and which a reader of device time would count as
    busy time), so the program's spans stand in the profiler's timeline on
    the kernels' clock;
  * keeps a record (``spans()``): name, span id, parent id, request id (the
    outermost span's id, shared by every span of one request) and host
    start and end in ``time.perf_counter_ns``; at most ``MAX_RECORDS``;
  * with ``stream=<device>`` on a CUDA device that is not capturing,
    records a timing ``torch.cuda.Event`` on that device's current stream
    at entry and at exit.

It synchronises nothing.  ``report()`` and ``spans()`` synchronise once
where events wait and resolve each against one base event of its device:
each stream span gets ``stream_start_ms`` and ``stream_end_ms`` on one
stream clock, the time at which the stream reached its entry and exit
(a program enqueued on an idle card starts at once, so a span's stream
time includes the wait for its own launch), and ``report()["spans"]`` adds
``stream_ms_total`` a name.  Spans inside ``muted()`` (a CUDA graph's
warm-up and capture) keep only their host aggregate.

An operator runs the server under ``torch.profiler.profile`` to read the
program's spans in the profiler's timeline (``export_chrome_trace``) and,
with stream times, from ``report()`` and ``spans()``.  The records and
spans each program keeps, and the metrics that read them, are listed in
PERF.md ("Spans and counters").
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 17

_lock = threading.Lock()
_spans: dict[str, dict] = {}
_counters: dict[str, int] = {}
_obs: dict[str, dict] = {}
_records: list[dict] = []
_base: dict = {}                     # device -> the event stream ms count from
_ids = itertools.count(1)
_local = threading.local()           # .stack of (span id, request id), .muted


@contextlib.contextmanager
def muted():
    """Spans inside keep only their host aggregate (nestable)."""
    _local.muted = getattr(_local, "muted", 0) + 1
    try:
        yield
    finally:
        _local.muted -= 1


def _aggregate(name: str, dt: float):
    with _lock:
        s = _spans.setdefault(name, {"count": 0, "total_s": 0.0,
                                     "max_s": 0.0})
        s["count"] += 1
        s["total_s"] += dt
        s["max_s"] = max(s["max_s"], dt)


def _event(device):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


@contextlib.contextmanager
def span(name: str, stream=None):
    """Time the enclosed region as ``name``.  ``stream`` is the
    ``torch.device`` whose current stream the span also times while traced
    (ignored unless it is a CUDA device)."""
    if not (_profiler._is_profiler_enabled
            and not getattr(_local, "muted", 0)):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _aggregate(name, time.perf_counter() - t0)
        return
    stack = _local.__dict__.setdefault("stack", [])
    sid = next(_ids)
    parent, request = stack[-1] if stack else (None, sid)
    rec = {"name": name, "id": sid, "parent": parent, "request": request,
           "start_ns": time.perf_counter_ns(), "end_ns": None}
    timed = (stream is not None and stream.type == "cuda"
             and not torch.cuda.is_current_stream_capturing())
    start = _event(stream) if timed else None
    with _lock:
        if len(_records) < MAX_RECORDS:
            _records.append(rec)
    stack.append((sid, request))
    t0 = time.perf_counter()
    try:
        with _RecordFunctionFast(name):
            yield
    finally:
        if timed:
            rec["_events"] = (stream, start, _event(stream))
        rec["end_ns"] = time.perf_counter_ns()
        stack.pop()
        _aggregate(name, time.perf_counter() - t0)


def _resolve():
    """Give every record whose events wait its stream times (caller holds
    the lock).  One synchronise a device, one base event a device."""
    waiting = [r for r in _records if "_events" in r]
    if not waiting:
        return
    devices = {r["_events"][0] for r in waiting}
    for dev in devices:
        torch.cuda.synchronize(dev)
    for r in waiting:
        dev, start, end = r.pop("_events")
        base = _base.setdefault(dev, start)
        r["stream_start_ms"] = base.elapsed_time(start)
        r["stream_end_ms"] = base.elapsed_time(end)


def count(name: str, n: int = 1):
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def observe(name: str, value: float):
    v = float(value)
    with _lock:
        o = _obs.setdefault(name, {"count": 0, "sum": 0.0,
                                   "min": v, "max": v})
        o["count"] += 1
        o["sum"] += v
        o["min"] = min(o["min"], v)
        o["max"] = max(o["max"], v)


def report() -> dict:
    with _lock:
        _resolve()
        spans = {k: dict(v, mean_s=v["total_s"] / max(1, v["count"]))
                 for k, v in _spans.items()}
        for r in _records:
            if "stream_start_ms" in r and r["name"] in spans:
                s = spans[r["name"]]
                s["stream_ms_total"] = s.get("stream_ms_total", 0.0) + (
                    r["stream_end_ms"] - r["stream_start_ms"])
        obs = {k: dict(v, mean=v["sum"] / max(1, v["count"]))
               for k, v in _obs.items()}
        return {"spans": spans, "counters": dict(_counters),
                "observations": obs}


def spans() -> list:
    """The traced spans' records, in the order they opened (a span still
    open has ``end_ns`` None)."""
    with _lock:
        _resolve()
        return [dict(r) for r in _records]


def reset():
    with _lock:
        _spans.clear()
        _counters.clear()
        _obs.clear()
        _records.clear()
        _base.clear()
