"""Read the numbers a cell compares, for the program or for its control,
over several seeds in one process, on the card at the cell's own size:

    python3 gpu_bench/readings.py --workload <cell> --seeds 11,12,13 \
        --seconds 5 [--control 1]

The control is the program on a key cut to the configuration's
``control_key_limbs`` limbs (the lower-precision path the program has): the
limits in PERF.md are set between the program's readings and the
control's.  One JSON line per seed, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from gpu_bench import harness
    if not torch.cuda.is_available():
        print("readings.py: needs a CUDA card", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    values = []
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        result, checks, run = harness.run_cell(
            ROOT, bench, args.workload, seed, args.seconds, False, "cuda",
            time.perf_counter(), control=bool(args.control))
        values.append(checks["wrong_answers"]["value"])
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": result["correct"],
                          "sampled": run.sampled, "units": len(run.units),
                          "checks": checks, "metrics": result["metrics"]}),
              flush=True)
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "wrong_answers": values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
