"""A 4-bit query's latency over a process's first seconds, on the card.

    python tools/cb_query_startup.py [--root TREE] [--seconds 60] [--seed 1]

Builds the benchmark's `cb_active.query4` cell as `gpu_bench/run.py` does
(the client's keys and inputs from the seed, the server's prepared key),
then runs the staged circuit bootstrap on B=4 fresh bits a query, each
synchronised, back to back from the first call (the one that captures the
programs) for ``--seconds``, with no warm-up.  Prints one JSON line a second
of that loop: the queries that started in it, their median and largest ms.
A process whose first seconds read slower than its last is in the start-up
slow state (PERF.md §7).  ``--root`` runs another checkout's program and
benchmark (for example a ``git archive`` of the parent in a git-ignored
directory), so two trees compare on one card.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv[1:])
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from gpu_bench import harness, server as S
    from gpu_bench.client import Client

    bench = json.loads((root / "BENCHMARK.json").read_text())
    _, cfg, mix, _ = harness.load(root, bench, "cb_active.query4")
    dev = torch.device("cuda")
    client = Client(args.seed, dev)
    secret, raw = client.circuit_key(cfg)
    fn = S.SERVERS[cfg["kind"]].build(cfg, raw, dev).bootstrap_fn()
    msgs = torch.where(client.bits((mix["pool_batches"], mix["batch"])) == 1,
                       -(1 << 31), 0)
    pool = client.lwe(secret["ring_lvl1"][0], msgs,
                      2.0 ** cfg["input_stdev_log2"]).to(torch.int32)
    torch.cuda.synchronize()
    start, lat = time.perf_counter(), []
    while time.perf_counter() - start < args.seconds:
        t0 = time.perf_counter()
        fn(pool[len(lat) % len(pool)])
        torch.cuda.synchronize()
        lat.append((t0 - start, (time.perf_counter() - t0) * 1e3))
    card = torch.cuda.get_device_name(dev)
    for sec in range(int(args.seconds) + 1):
        ms = [v for t, v in lat if int(t) == sec]
        if ms:
            print(json.dumps({"root": root.name, "s": sec, "queries": len(ms),
                              "median_ms": statistics.median(ms),
                              "max_ms": max(ms), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
