"""Library-level observability: spans, counters and a metrics registry
(the port's copy of ``tfhe_tpu.utils.observability``).

Process-local metrics recorded at the library's operation boundaries — key
generation (``keygen.gate`` / ``keygen.circuit`` spans and counters),
bootstrap launches (``bootstrap.launches`` / ``bootstrap.ciphertexts``
counters) and circuit waves (``circuit.*`` in ``runtime/scheduler.py``) —
that embedders can scrape or reset.  Spans measure host wall time; GPU work is
asynchronous, so a span around a launch measures the enqueue unless the
caller synchronises inside it.

  with span("bootstrap"):          # wall-clock timer, nestable
      ...
  count("gates", 128)              # monotonic counters
  observe("wave_width", 64)        # value distributions (min/max/mean)
  report() -> {"spans": {...}, "counters": {...}, "observations": {...}}

Set TFHE_TPU_LOG=1 to also print one line per closed span.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

_lock = threading.Lock()
_spans: dict[str, dict] = {}
_counters: dict[str, int] = {}
_obs: dict[str, dict] = {}
_LOG = os.environ.get("TFHE_TPU_LOG", "") not in ("", "0")


@contextlib.contextmanager
def span(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            s = _spans.setdefault(name, {"count": 0, "total_s": 0.0,
                                         "max_s": 0.0})
            s["count"] += 1
            s["total_s"] += dt
            s["max_s"] = max(s["max_s"], dt)
        if _LOG:
            print(f"[tfhe_tpu_torch] {name}: {dt*1e3:.1f} ms", flush=True)


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
        spans = {k: dict(v, mean_s=v["total_s"] / max(1, v["count"]))
                 for k, v in _spans.items()}
        obs = {k: dict(v, mean=v["sum"] / max(1, v["count"]))
               for k, v in _obs.items()}
        return {"spans": spans, "counters": dict(_counters),
                "observations": obs}


def reset():
    with _lock:
        _spans.clear()
        _counters.clear()
        _obs.clear()

