"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over the
first units of the window, reduced to the card's busy time, the device
operations that took most time and the longest idle gaps named by what the
host was doing (the arithmetic of ``chip_smoke.busy_ms``, with overlapping
device intervals merged so that nothing counts twice)."""

from __future__ import annotations

import time

import torch


class Tracer:
    """Profiles from ``begin`` until ``units`` units of work have been
    issued and the card has finished them (``after_unit``), or until the
    window ends (``finish``)."""

    def __init__(self, on: bool, units: int, device):
        self.on = on
        self.units = max(1, int(units))
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.window_s = None
        self.traced_units = 0

    def begin(self):
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.window_s is None

    def after_unit(self, issued: int, sync):
        if self.active and issued >= self.units:
            self.finish(issued, sync)

    def finish(self, issued: int, sync):
        if not self.active:
            return
        sync()
        self.window_s = time.perf_counter() - self._t0
        self.traced_units = issued
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict | None:
        """{"window_s", "busy_s", "units", "device_ops", "idle_gaps"};
        busy_s is None where the profiler recorded no device time."""
        if self.prof is None:
            return None
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in self.prof.events():
            span = (e.time_range.start, e.time_range.end, e.name)
            (dev if e.device_type == cuda else host).append(span)
        merged = []
        for s, t, _ in sorted(dev):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy_us = sum(t - s for s, t in merged)
        by_name: dict = {}
        for s, t, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = [(merged[i][1], merged[i + 1][0])
                for i in range(len(merged) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        host.sort()
        return {"window_s": self.window_s,
                "busy_s": busy_us / 1e6 if busy_us > 0 else None,
                "units": self.traced_units,
                "device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[_host_activity(host, s, t), (t - s) / 1e6]
                              for s, t in gaps]}


def _host_activity(host, s, t) -> str:
    """The host event that overlaps the idle gap (s, t) most (the shortest
    of equals: the innermost)."""
    best = None
    for hs, ht, name in host:
        if hs >= t:
            break
        cover = min(ht, t) - max(hs, s)
        if cover > 0 and (best is None or (cover, hs - ht) > best[:2]):
            best = (cover, hs - ht, name)
    return best[2] if best else "host (no recorded activity)"
