"""Run one cell of the port's benchmark once and print its result line.

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared beside its limit); the checks are also the last lines
of standard error.  Exits non-zero, printing no result, without a CUDA
card, and if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tfhe_tpu"}


def loaded_forbidden() -> list:
    """Modules whose top-level name is JAX's or the JAX package's, compared
    whole (the port's name, tfhe_tpu_torch, begins with tfhe_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    # the program's kernel builds and host libraries stay in the checkout
    # (tfhe_tpu_torch/ops/build); nothing of the run goes to a fixed /tmp
    import torch
    from gpu_bench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {c["name"]: c["chips"] for c in bench["workloads"]}.get(
        args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks, run = harness.run_cell(
        ROOT, bench, args.workload, args.seed, args.seconds,
        bool(args.trace), "cuda", T0)
    bad = loaded_forbidden()
    if bad:
        print(f"run.py: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    lat = [u["latency_s"] for u in run.units if u["latency_s"] is not None]
    print(json.dumps({"card": power_line(), "units": len(run.units),
                      "window_s": run.window_s, "latency_samples": len(lat),
                      "sampled": run.sampled,
                      "reference_s": run.reference_s,
                      "setup_s": run.setup_s, "key_prep_s": run.key_prep_s,
                      "counters": run.counters}), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
