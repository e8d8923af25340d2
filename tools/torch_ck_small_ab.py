"""ck_dot64p's two plans at small batches, on the card.

    python tools/torch_ck_small_ab.py [--reps 100] [--parts] [--batches 1,2]

At the circuit bootstrap's lvl2 contraction (N=2048, m=64, 16 limb rows,
two digit planes) at CB_ACTIVE's depth (J*m = 512) and CB_PAPER's (768),
for B = 1, 2, 3, 4, 8, 16, 64 (or ``--batches``), both plans of
``csrc/ck_dot64p.cu`` through its raw entry:

  * ``os``: the output-stationary plan at the rows its wrapper gives B;
  * ``kst``: the key-stationary plan, its blocks' rows reduced into the
    output by TMA (the output zeroed first on the same stream), 64 stacked
    rows a block where C*B fits 64, else 128.

Each is first held bit for bit against the plain version (run on the card).
Then device ms a launch (chip_smoke.device_ms: the host's enqueue hidden),
``cold``: the launches rotate over enough distinct keys that together hold
more bytes than the 50 MB L2, so each launch reads its key from HBM, as each
step of a blind rotation does; ``hot``: one key, which stays in L2.  Two
rounds, the plans in turns (os, kst, kst, os).  Each line
gives the key's read rate (its bytes once over the cold ms) and the share of
the bytes floor (key + digits + output once at 3.35 TB/s) that the cold
time reaches, and the plan ``kernels.ck_dot64p_plan`` chooses.  With
``--parts``, the key-stationary kernel built again with CK_PART=1, 2, 3
(loads alone, wgmmas alone, epilogue alone) at B=4, cold.

Needs one card and nvcc; prints the card's name and power limit, then one
JSON line a case.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from tfhe_tpu_torch.ops import _build  # noqa: E402
from tfhe_tpu_torch.ops import kernels as K  # noqa: E402

N, M, UL, P = 2048, 64, 16, 2
C = N // M
BATCHES = (1, 2, 3, 4, 8, 16, 64)
L2_BYTES = 50 * 2**20


def launcher(entry, x, wmt, *, rows, kst):
    """A raw launch of ``entry`` (the ck_dot64p C function) at a forced
    plan into a fixed output; returns the output."""
    B, Jm = x.shape[0], wmt.shape[-1]
    out = torch.empty((UL, B, N), dtype=torch.int32, device=x.device)

    def run(key=wmt):
        rc = entry(x.data_ptr(), key.data_ptr(), out.data_ptr(), B, N, M, Jm,
                   UL, P, K.ck_width(Jm), rows, int(kst),
                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ck_dot64p: cudaError {rc}")
        return out
    return run


def rotating(run, keys):
    """fn() for device_ms: each call the next key."""
    state = {"i": 0}

    def fn():
        state["i"] = (state["i"] + 1) % len(keys)
        return run(keys[state["i"]])
    return fn


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    args = ap.parse_args(argv[1:])
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    entry = _build.entry("ck_dot64p")
    g = torch.Generator(device=dev).manual_seed(21)
    for Jm in (512, 768):
        key_bytes = UL * (N + M) * Jm
        keys = [torch.randint(-128, 128, (UL, N + M, Jm), generator=g,
                              device=dev, dtype=torch.int8)
                for _ in range(-(-3 * L2_BYTES // key_bytes))]
        for B in map(int, args.batches.split(",")):
            x = torch.randint(-64, 65, (B, C * P * K.ck_width(Jm)),
                              generator=g, device=dev, dtype=torch.int8)
            want = K.ck_dot64p_plain(x, keys[0], N=N, m=M, planes=P)
            plans = {"os": dict(rows=128 if B > 64 else 64, kst=False),
                     "kst": dict(rows=128, kst=True)}
            runs = {name: launcher(entry, x, keys[0], **pl)
                    for name, pl in plans.items()}
            for name, run in runs.items():
                out = run()
                torch.cuda.synchronize()
                cs.check(torch.equal(out, want), f"J*m={Jm} B={B}: {name}")
            floor, _ = cs.bound_ms(key_bytes + x.numel() + 4 * want.numel())
            row = {"Jm": Jm, "B": B, "keys": len(keys),
                   "chosen": K.ck_dot64p_plan(B, N, M, Jm, P),
                   "bytes_floor_ms": floor, "card": smi}
            order = list(runs) + list(runs)[::-1]
            for name in order:
                cold = cs.device_ms(rotating(runs[name], keys), args.reps)
                hot = cs.device_ms(runs[name], args.reps)
                row.setdefault(name, []).append(
                    {"cold_ms": cold, "hot_ms": hot,
                     "key_GBps": key_bytes / cold / 1e6,
                     "floor_share": floor / cold})
            print(json.dumps(row), flush=True)
            del x, want, runs
        if args.parts:
            x = torch.randint(-64, 65, (4, C * P * K.ck_width(Jm)),
                              generator=g, device=dev, dtype=torch.int8)
            fns = _build.variants("ck_dot64p", [(f"CK_PART={i}",)
                                                for i in (1, 2, 3)])
            parts = {}
            for name, fn in zip(("loads", "wgmmas", "epilogue"), fns):
                run = launcher(fn, x, keys[0], rows=128, kst=True)
                parts[name] = cs.device_ms(rotating(run, keys), args.reps)
            print(json.dumps({"Jm": Jm, "B": 4, "kst_parts_ms": parts,
                              "card": smi}), flush=True)
        del keys
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
