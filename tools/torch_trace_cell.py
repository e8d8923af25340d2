"""Run one cell of the port's benchmark traced, on the card, and account for
its idle time by the program's spans.

    python3 tools/torch_trace_cell.py --workload gate_default.adder32_i256 \
        --seed 2400001001 --seconds 45 --out trace_out

Runs ``gpu_bench/run.py``'s cell with ``--trace 1`` in this process, writes
the profiler's Chrome trace of the traced units (``<out>/<cell>.json.gz``)
and prints one JSON line: the result line's metrics and traced window; the
five longest idle gaps of the card, each with the breakdown's name for it,
the program span (``utils.observability``) and the runtime call that cover
most of it; the host ms a launch of each scheduler span; the sums the
span metrics are held to (the stages' stream ms against the traced wall a
unit, the scheduler's programs and the gaps between them against the
evaluation's stream extent and the traced wall); the profiler's own
reading of the idle that ``sched.gap_ms`` and ``graph.launch_ms.cb_query``
take from the spans; and the latencies of the traced units and of as many
untraced units after them.
"""

from __future__ import annotations

import argparse
import gzip
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _cover(events, s, t):
    """(name, ms covered) of the event covering most of (s, t), the
    shortest of equals; None if none covers it."""
    best = None
    for hs, ht, name in events:
        cover = min(ht, t) - max(hs, s)
        if cover > 0 and (best is None or (cover, hs - ht) > best[:2]):
            best = (cover, hs - ht, name)
    return None if best is None else [best[2], best[0] / 1e3]


def _gaps(prof, span_names, top=5):
    """The longest idle gaps between the card's merged busy intervals."""
    import torch
    from gpu_bench import tracing
    cuda = torch.autograd.DeviceType.CUDA
    dev, spans, calls = [], [], []
    for e in prof.events():
        iv = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == cuda:
            dev.append(iv)
        else:
            (spans if e.name in span_names else calls).append(iv)
    merged = []
    for s, t, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    gaps = sorted(((merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)),
                  key=lambda g: g[0] - g[1])[:top]
    host = sorted(spans + calls)
    return [{"ms": (t - s) / 1e3,
             "breakdown": tracing._host_activity(host, s, t),
             "program_span": _cover(spans, s, t),
             "runtime_call": _cover(calls, s, t)} for s, t in gaps]


_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def _exact_idle(events, request, per_program):
    """``gpu_bench/spans.idle_ms`` read from the Chrome trace alone: for
    each ``request`` span, the card's idle from its first program span's
    start to the end of the last device operation its programs'
    ``cudaGraphLaunch`` calls launched, a request (or a program)."""
    ops = [e for e in events if e.get("ph") == "X"]
    merged = []
    for s, t in sorted((e["ts"], e["ts"] + e["dur"]) for e in ops
                       if e.get("cat") in _DEVICE):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    ends: dict = {}
    for e in ops:
        if e.get("cat") in _DEVICE:
            c = e["args"].get("correlation")
            ends[c] = max(ends.get(c, 0.0), e["ts"] + e["dur"])
    launches = [e for e in ops if e["name"] == "cudaGraphLaunch"]
    progs = [e for e in ops if e.get("cat") == "cpu_op"
             and e["name"].startswith("graph.")
             and e["name"] != "graph.capture"]
    idle = count = 0
    for r in ops:
        if r.get("cat") != "cpu_op" or r["name"] != request:
            continue
        inside = [p for p in progs
                  if r["ts"] <= p["ts"] <= r["ts"] + r["dur"]]
        last = [ends.get(g["args"]["correlation"], 0.0) for g in launches
                if any(p["ts"] <= g["ts"] <= p["ts"] + p["dur"]
                       for p in inside)]
        if not last:
            continue
        s, t = min(p["ts"] for p in inside), max(last)
        busy = sum(max(0.0, min(b, t) - max(a, s)) for a, b in merged)
        idle += t - s - busy
        count += len(inside) if per_program else 1
    return idle / count / 1e3 if count else None


def _accounts(recs, window_ms, units):
    """Span sums against the traced wall."""
    def stream(r):
        return r["stream_end_ms"] - r["stream_start_ms"]

    def host(r):
        return (r["end_ns"] - r["start_ns"]) / 1e6

    out = {"traced_wall_ms_a_unit": window_ms / units}
    boots = [r for r in recs if r["name"] == "circuit.bootstrap"]
    if boots:
        ids = {r["id"] for r in boots}
        stages = {s: 0.0 for s in "abc"}
        for r in recs:
            if r["parent"] in ids and r["name"].startswith("graph.circuit."):
                stages[r["name"][-1]] += stream(r)
        out["stage_stream_ms_a_bootstrap"] = {
            k: v / len(boots) for k, v in stages.items()}
        out["stages_sum_ms"] = sum(stages.values()) / len(boots)
    evals = [r for r in recs if r["name"] == "circuit.evaluate"]
    if evals:
        progs = sorted((r for r in recs if r["name"] in
                        ("graph.wave", "graph.chain")),
                       key=lambda r: r["stream_start_ms"])
        launches = [r for r in recs if r["name"].startswith("circuit.wave.")
                    or r["name"] == "circuit.chain"]
        busy = sum(stream(r) for r in progs)
        extent = progs[-1]["stream_end_ms"] - progs[0]["stream_start_ms"]
        out["scheduler"] = {
            "launches": len(progs), "programs_stream_ms": busy,
            "gaps_ms": extent - busy, "programs_plus_gaps_ms": extent,
            "evaluate_host_ms": sum(host(r) for r in evals),
            "host_ms_a_launch": {
                name: sum(host(r) for r in recs if r["name"] == name)
                / len(launches)
                for name in ("sched.operands", "graph.wave", "graph.chain")},
            "launch_host_ms_a_launch": sum(host(r) for r in launches)
            / len(launches)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--out", required=True,
                    help="directory for the Chrome trace")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from gpu_bench import harness, tracing
    from tfhe_tpu_torch.utils import observability as obs
    if not torch.cuda.is_available():
        print("torch_trace_cell.py: needs a CUDA card", file=sys.stderr)
        return 2
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    kept = {}

    class Exporting(tracing.Tracer):
        def finish(self, issued, sync):
            was = self.active
            super().finish(issued, sync)
            if was:
                kept["prof"] = self.prof
                kept["records"] = obs.spans()

    harness.Tracer = Exporting
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    result, checks, run = harness.run_cell(
        ROOT, bench, args.workload, args.seed, args.seconds, True, "cuda",
        time.perf_counter())
    prof, recs = kept["prof"], kept["records"]
    raw = out / f"{args.workload}.json"
    prof.export_chrome_trace(str(raw))
    with open(raw, "rb") as f, gzip.open(f"{raw}.gz", "wb") as g:
        shutil.copyfileobj(f, g)
    events = json.loads(raw.read_text())["traceEvents"]
    raw.unlink()
    units = run.trace["units"]
    lat = [None if u["latency_s"] is None else 1e3 * u["latency_s"]
           for u in run.units[:2 * units]]
    window_ms = run.trace["window_s"] * 1e3
    line = {"workload": args.workload, "seed": args.seed,
            "card": torch.cuda.get_device_name(0),
            "correct": result["correct"], "metrics": result["metrics"],
            "traced_units": run.trace["units"],
            "traced_window_ms": window_ms, "busy_s": run.trace["busy_s"],
            "records": len(recs),
            "idle_gaps": _gaps(prof, {r["name"] for r in recs}),
            "accounts": _accounts(recs, window_ms, units),
            "profiler_idle_ms": {
                "a_launch_in_evaluations": _exact_idle(
                    events, "circuit.evaluate", True),
                "a_query_in_bootstraps": _exact_idle(
                    events, "circuit.bootstrap", False)},
            "unit_latency_ms": {"traced": lat[:units],
                                "untraced_next": lat[units:]},
            "trace": f"{raw}.gz"}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
