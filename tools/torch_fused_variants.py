"""Variants of the port's fused CMux step kernel, built side by side, held
bit for bit against the plain version and timed on one card.

    python tools/torch_fused_variants.py [NAME[:OLD=>NEW[@@OLD=>NEW...]] ...]

Each argument names a variant of ``tfhe_tpu_torch/ops/csrc/fused_cmux_step.cu``:
the source with every OLD text replaced by NEW (``\\n`` stands for a line
break); a bare NAME is the source as it is.  For example

    python tools/torch_fused_variants.py tree \\
        "rows1:constexpr int ROWS = 2;=>constexpr int ROWS = 1;" \\
        "rows4:constexpr int ROWS = 2;=>constexpr int ROWS = 4;"

times the kernel against copies that keep one or four rows' loads in
flight.  Every variant is built four times (FCS_PART=0..3: the whole step,
then only its key loads, its digit build or its wgmmas) into a git-ignored
directory, checked against the plain version at the main shapes, both plans
(``tile_cols`` 64 and 128) and a few ragged batches, three times at B=8192,
then timed in two rounds (CUDA events, raw ctypes launches).  Prints the
card's name and power limit.
"""
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as c  # noqa: E402
from tfhe_tpu_torch import torus as T  # noqa: E402
from tfhe_tpu_torch.ops import _build, kernels as K  # noqa: E402
from tfhe_tpu_torch.params import GATE_FAST2, GATE_MXU  # noqa: E402

CSRC = _build.CSRC
OUT = _build.BUILD_DIR / "variants"
KEY_SHIFT = 8


def parse(arg: str):
    name, _, subs = arg.partition(":")
    text = (CSRC / "fused_cmux_step.cu").read_text()
    for sub in filter(None, subs.split("@@")):
        old, new = (x.replace("\\n", "\n") for x in sub.split("=>"))
        if old not in text:
            raise SystemExit(f"{name}: no {old!r} in the kernel source")
        text = text.replace(old, new)
    return name, text


def build(variants):
    """{(name, part): ctypes function}: each variant's source, written with
    the kernel's headers into a directory of the build tree, built by
    _build.variants once per FCS_PART."""
    OUT.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, OUT)
    fns = {}
    for name, text in variants:
        src = OUT / f"{name}.cu"
        src.write_text(text)
        built = _build.variants("fused_cmux_step",
                                [(f"FCS_PART={p}",) for p in range(4)], src)
        fns.update({(name, p): fn for p, fn in enumerate(built)})
        log = _build._lib_path(src, ("FCS_PART=0",)).with_suffix(".ptxas.txt")
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line or "wgmma" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    smi = c.nvidia_smi_line()
    t0 = time.perf_counter()
    variants = [parse(a) for a in (sys.argv[1:] or ["tree"])]
    fns = build(variants)
    print(f"built {len(fns)} libraries in {time.perf_counter() - t0:.1f} s "
          f"[{smi}]", flush=True)
    rng = np.random.default_rng(0)
    F2, MX = GATE_FAST2.tgsw, GATE_MXU.tgsw
    shapes = {"GATE_FAST2 B=8192": (F2, 3, 512, 8192, 3),
              "GATE_FAST2 B=1024": (F2, 3, 512, 1024, 3),
              "GATE_MXU B=8192": (MX, 2, 1024, 8192, 3),
              "GATE_FAST2 B=1": (F2, 3, 512, 1, 3),
              "GATE_FAST2 B=100": (F2, 3, 512, 100, 3),
              "GATE_FAST2 B=8191": (F2, 3, 512, 8191, 3),
              "GATE_FAST2 L=1 B=300": (F2, 3, 512, 300, 1),
              "GATE_MXU L=2 B=777": (MX, 2, 1024, 777, 2)}
    data = {}
    for label, (p, kp1, N, B, L) in shapes.items():
        acc = torch.from_numpy(rng.integers(-2**31, 2**31, (B, kp1, N))
                               .astype(np.int32)).cuda()
        a = torch.from_numpy(rng.integers(0, 2 * N, (B,)).astype(np.int32)
                             ).cuda()
        a[0] = N
        wt = torch.from_numpy(rng.integers(
            -128, 128, (L, kp1 * N, kp1 * p.l * N)).astype(np.int8)).cuda()
        want = K.fused_cmux_step_v2_plain(a, acc, wt, l=p.l, bgbit=p.bgbit,
                                          offset=p.offset,
                                          key_shift=KEY_SHIFT)
        data[label] = (p, kp1, N, B, L, a, acc, wt, want,
                       torch.empty_like(acc))
    stream = torch.cuda.current_stream().cuda_stream

    def runner(fn, label, cols):
        p, kp1, N, B, L, a, acc, wt, _, out = data[label]
        args = (a.data_ptr(), acc.data_ptr(), wt.data_ptr(), out.data_ptr(),
                B, kp1, N, p.l, L, p.bgbit, p.offset & T.MASK32, KEY_SHIFT,
                cols, stream)

        def run():
            rc = fn(*args)
            if rc != 0:
                raise RuntimeError(f"cudaError {rc}")
        return run

    ok = True
    for name, _ in variants:
        bad = []
        for label in data:
            for cols in K.FUSED_COLS:
                for _ in range(3 if label.endswith("8192") else 1):
                    runner(fns[name, 0], label, cols)()
                    torch.cuda.synchronize()
                    if not torch.equal(data[label][9], data[label][8]):
                        bad.append(f"{label} tile_cols={cols}")
        ok &= not bad
        print(f"CHECK {name}: " + ("every shape equals the plain version"
                                  if not bad else f"WRONG at {bad}"),
              flush=True)
    timed = [("GATE_FAST2 B=8192", cols) for cols in K.FUSED_COLS] + [
        ("GATE_FAST2 B=1024", 128), ("GATE_MXU B=8192", 128),
        ("GATE_FAST2 B=100", 128)]
    for _ in range(2):
        for name, _ in variants:
            line = []
            for label, cols in timed:
                parts = range(4) if label == "GATE_FAST2 B=8192" else (0,)
                ms = [c.cuda_ms(runner(fns[name, part], label, cols), 10)
                      for part in parts]
                line.append(f"{label} tile_cols={cols}: " + " / ".join(
                    f"{m:.4f}" for m in ms))
            print(f"TIME {name} (ms; at B=8192 whole / keys / digits / "
                  f"mmas): " + ", ".join(line), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s [{smi}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
