"""One run of one cell: the client makes the keys and inputs from the seed,
the program prepares its key and warms up, the traffic's loop measures the
window, the reference judges a sample of the answers, and the metrics named
in ``BENCHMARK.json`` are read, each by its own reader.

Everything that belongs to one cell is found by name: the configuration's
file (``BENCHMARK.json``'s ``configs[].file``), ``traffic/<mix>.json`` and
``metrics/<metric>.py`` under the benchmark's folder.  A mix's loop is one
of ``loops.LOOPS`` or, by its name, ``traffic/<loop>.py``; a sample's judge
is one of ``reference.judge``'s or ``reference/judges/<judge>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import time
from pathlib import Path

import torch

from gpu_bench import loops, roofline, server as S
from gpu_bench.client import Client
from gpu_bench.reference import judge
from gpu_bench.tracing import Tracer

@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers see it."""
    cell: dict
    config: dict
    mix: dict
    setup_s: float
    key_prep_s: float
    window_s: float
    units: list                 # loops.Window.units
    counters: dict              # the program's counters over the window
    trace: dict | None          # tracing.Tracer.summary()
    sampled: int = 0            # answers the reference judged
    reference_s: float = 0.0    # the reference's time (after the window)


@dataclasses.dataclass
class Context:
    """What a traffic loop is given."""
    cfg: dict
    mix: dict
    device: torch.device
    seconds: float
    client: Client
    secret: dict
    server: object
    tracer: Tracer
    sample_gen: torch.Generator
    peaks: dict | None
    folder: Path | None = None  # the benchmark's: a loop file's siblings
    window: loops.Window = None

    def sync(self):
        S.sync(self.device)

    def reset_counters(self):
        S.reset_counters()

    def warm(self, fn):
        """Run ``fn`` once, then again until the mix's ``warm_seconds``
        (at most the window's own length) have passed, the card
        synchronised after each call: part of set-up."""
        fn()
        self.sync()
        until = time.perf_counter() + min(self.mix.get("warm_seconds", 0),
                                          self.seconds)
        while time.perf_counter() < until:
            fn()
            self.sync()

    def bound(self, batch: int):
        if self.peaks is None:
            return None
        return roofline.BOUNDS[self.cfg["kind"]](self.cfg, batch, self.peaks)


def load(root: Path, bench: dict, cell_name: str):
    """(cell, configuration, mix, loop) of a cell, from the files named.  The
    loop is found here, before any key is made."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    folder = root / bench["paths"][0]
    mix = json.loads((folder / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    return cell, cfg, mix, find_loop(folder, cell["traffic"], mix)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_loop(folder: Path, mix_name: str, mix: dict):
    """The mix's loop: a built-in one of ``loops.LOOPS``, else ``run(ctx) ->
    loops.Sample`` of ``traffic/<loop>.py`` under the benchmark's folder."""
    name = mix["loop"]
    if name in loops.LOOPS:
        return loops.LOOPS[name]
    path = folder / "traffic" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"traffic mix {mix_name!r}: loop {name!r} is not "
                         f"built in and there is no file {path}")
    return _module(path, f"loop_{name}").run


def metric_entries(bench: dict, cell_name: str, trace: bool) -> list:
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]


def read_metric(root: Path, bench: dict, name: str, run: Run):
    path = root / bench["paths"][0] / "metrics" / f"{name}.py"
    return _module(path, f"metric_{name}").read(run)


def run_cell(root: Path, bench: dict, cell_name: str, seed: int,
             seconds: float, trace: bool, device, t0: float,
             control: bool = False) -> tuple:
    """One run.  Returns (the result line without "checks", the checks,
    the Run the metrics were read from).  ``control`` runs the program on the configuration's lower-precision
    key (``control_key_limbs``), which the judge must find wrong."""
    device = torch.device(device)
    folder = root / bench["paths"][0]
    cell, cfg, mix, loop = load(root, bench, cell_name)
    kind = device.type
    peaks = roofline.PEAKS.get(torch.cuda.get_device_name(device)) \
        if kind == "cuda" else None
    client = Client(seed, device)
    make_key = {"gate": client.gate_key, "circuit": client.circuit_key}
    secret, raw = make_key[cfg["kind"]](cfg)
    server = S.SERVERS[cfg["kind"]].build(
        cfg, raw, device, cfg["control_key_limbs"] if control else None)
    sample_gen = torch.Generator().manual_seed(int(seed) % (1 << 63) ^ 0x5A5A)
    ctx = Context(cfg, mix, device, seconds, client, secret, server,
                  Tracer(trace, mix["trace_units"], device), sample_gen,
                  peaks, folder)
    ctx.window = loops.Window(ctx)
    sample = loop(ctx)
    counters = S.counters()
    w = ctx.window
    peak = torch.cuda.max_memory_allocated(device) if kind == "cuda" else 0
    summary = ctx.tracer.summary()
    run = Run(cell, cfg, mix, w.start - t0, server.key_prep_s,
              w.end - w.start, w.units, counters, summary)
    del ctx, server, secret
    S.release()
    if kind == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    wrong = judge.wrong_answers(sample, raw, cfg, folder)
    run.reference_s = time.perf_counter() - t_ref
    run.sampled = int(sample.outputs.shape[0])
    metrics = {}
    for m in metric_entries(bench, cell_name, trace):
        value = read_metric(root, bench, m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if kind == "cuda" else kind,
           "kind": torch.cuda.get_device_name(device) if kind == "cuda"
           else kind, "count": 1, "memory_peak_bytes": peak}
    result = {"correct": wrong == 0,
              "attempted": sum(u["answers"] for u in w.units),
              "failed": wrong, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    checks = {"wrong_answers": {"value": wrong, "limit": 0}}
    return result, checks, run
