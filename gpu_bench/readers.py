"""Shared arithmetic of the metric readers (``metrics/<name>.py``).  A
reader takes a ``harness.Run`` and returns a number, or None where the run
has nothing for it to read (the harness then leaves the metric out)."""

from __future__ import annotations

import statistics


def bootstraps_per_s(run):
    """Every bootstrap completed in the window over the window's time (from
    its start to the synchronised end of the last unit)."""
    done = sum(u["bootstraps"] for u in run.units)
    return done / run.window_s if done else None


def latency_ms(run, q: int):
    """The q-th percentile of the window's unit latencies, ms."""
    lat = [u["latency_s"] for u in run.units if u["latency_s"] is not None]
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[q - 1]


def device_idle(run):
    """Share of the traced window in which no operation ran on the card."""
    t = run.trace
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def br_roofline(run):
    """The roofline bound of the traced units' blind-rotation steps over the
    card's busy time in the traced window."""
    t = run.trace
    if not t or not t["busy_s"]:
        return None
    bounds = [u["bound_s"] for u in run.units[:t["units"]]]
    if not bounds or None in bounds:
        return None
    return 100.0 * sum(bounds) / t["busy_s"]


def rows_per_launch(run):
    c = run.counters
    if not c.get("bootstrap.launches"):
        return None
    return c["bootstrap.ciphertexts"] / c["bootstrap.launches"]
