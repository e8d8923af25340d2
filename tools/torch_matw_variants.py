"""Variants of the materialize_w kernel (both entries), built side by side,
held bit for bit against the plain version and timed by device time on one
card.

    python tools/torch_matw_variants.py [--threads 256,512] [--rounds 2] \\
        [NAME[:OLD=>NEW[@@OLD=>NEW...]] ...]

Each argument names a variant of ``tfhe_tpu_torch/ops/csrc/materialize_w.cu``:
the source with every OLD text replaced by NEW (``\\n`` stands for a line
break); a bare NAME is the source as it is.  For example

    python tools/torch_matw_variants.py tree \\
        "unroll1:constexpr int UNROLL = 4;=>constexpr int UNROLL = 1;"

times the kernel against a copy that keeps one load in flight a thread.
At the keys of tools/torch_matw_ab.py (materialize_w at GATE_DEFAULT's and
GATE_FAST2's, materialize_wt at GATE_FAST2's and GATE_MXU's), each
variant's entry runs at the chosen plan and at 32 and 64 rows a block, with
each of ``--threads`` (a plan a variant's entry refuses is left out); every
launch is first checked against the plain version in an output filled with
-1 bytes.  Each round then times every plan alone, and at the three keys a
path runs, the path's step at the chosen plan (the launch followed by the
kernel that reads its output, beside that reader alone), all by
chip_smoke.device_ms over raw ctypes launches.  Prints ptxas's register and
spill lines of each variant and the card's name and power limit.
"""
import argparse
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke as c  # noqa: E402
from tfhe_tpu_torch.ops import _build  # noqa: E402
from torch_matw_ab import mat_cases  # noqa: E402

SOURCE = "materialize_w.cu"
OUT = _build.BUILD_DIR / "matw_variants"


def parse(arg: str):
    name, _, subs = arg.partition(":")
    text = (_build.CSRC / SOURCE).read_text()
    for sub in filter(None, subs.split("@@")):
        old, new = (x.replace("\\n", "\n") for x in sub.split("=>"))
        if old not in text:
            raise SystemExit(f"{name}: no {old!r} in the kernel source")
        text = text.replace(old, new)
    return name, text


def build(variants) -> dict:
    """{(name, entry): ctypes function}: each variant's source, written
    with the headers into a directory of the build tree, all built by one
    parallel nvcc batch."""
    OUT.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, OUT)
    paths = {}
    for name, text in variants:
        paths[name] = OUT / f"materialize_w_{name}.cu"
        paths[name].write_text(text)
    with _build._lock:
        _build._compile([(p, ()) for p in paths.values()])
    fns = {}
    for name, path in paths.items():
        for entry in ("materialize_w", "materialize_wt"):
            fns[name, entry] = _build.variants(entry, [()], path)[0]
        log = _build._lib_path(path).with_suffix(".ptxas.txt")
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return fns


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=["tree"])
    ap.add_argument("--threads", default="256")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = c.nvidia_smi_line()
    t0 = time.perf_counter()
    variants = [parse(a) for a in args.variants]
    fns = build(variants)
    print(f"built {len(variants)} variants in {time.perf_counter() - t0:.1f}"
          f" s [{smi}]", flush=True)
    threads = [int(t) for t in args.threads.split(",")]
    cases = mat_cases(np.random.default_rng(0))

    runs = {}                              # (name, case index) -> plans
    bad = []
    for i, case in enumerate(cases):
        want = case.want()
        rows, cols, _ = case.chosen()
        plans = list(dict.fromkeys(
            [case.chosen()] + [(r, cols, t) for r in (rows, 32, 64)
                               for t in threads]))
        for name, _ in variants:
            fn = fns[name, case.name]
            runs[name, i] = []
            for plan in plans:
                case.out.fill_(-1)
                torch.cuda.synchronize()
                args_ = (case.v.data_ptr(), case.out.data_ptr(),
                         *case.shape, *plan,
                         torch.cuda.current_stream().cuda_stream)
                rc = fn(*args_)
                if rc != 0:                    # a plan this variant refuses
                    print(f"  {name} {case.tag()} {plan}: cudaError {rc}, "
                          f"left out")
                    continue
                torch.cuda.synchronize()
                if not torch.equal(case.out, want):
                    bad.append(f"{name} {case.tag()} {plan}")
                runs[name, i].append(plan)
        del want
    if bad:
        print(f"FAIL: differ from the plain version: {bad}")
        return 1
    print("every variant and plan equals the plain version", flush=True)

    for _ in range(args.rounds):
        for name, _ in variants:
            for i, case in enumerate(cases):
                fn = fns[name, case.name]
                res = [f"{plan} {c.device_ms(case.new_runner(fn, plan)):.4f}"
                       for plan in runs[name, i]]
                if case.reader is not None:
                    run = case.new_runner(fn, case.chosen())

                    def step(run=run, case=case):
                        run()
                        case.reader()
                    res.append(f"step with {case.reader_tag} "
                               f"{c.device_ms(step):.4f} (reader alone "
                               f"{c.device_ms(case.reader):.4f})")
                print(f"VAR {name} {case.tag()} (device ms): "
                      + ", ".join(res), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
