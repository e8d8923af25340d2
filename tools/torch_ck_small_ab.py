"""ck_dot64p's and ck_dot64p_sacc's two plans at small batches, on the card.

    python tools/torch_ck_small_ab.py [--reps 100] [--parts] [--batches 1,2]

At the circuit bootstrap's lvl2 contraction (N=2048, m=64, 16 limb rows of
two polynomials, two digit planes) at CB_ACTIVE's depth (J*m = 512) and
CB_PAPER's (768), for B = 1, 2, 3, 4, 8, 16, 40, 48, 56, 64 (or
``--batches``), both plans of ``csrc/ck_dot64p.cu`` and of
``csrc/ck_dot64p_sacc.cu`` (the default 64-bit step's contraction) through
their raw entries, and the pair the sacc kernel replaces:

  * ``os``: ck_dot64p's output-stationary plan at the rows its wrapper
    gives B;
  * ``kst``: ck_dot64p's key-stationary plan, 128 stacked rows a block,
    its blocks' rows reduced into the output by TMA (the output zeroed
    first on the same stream);
  * ``sacc_os``, ``sacc_kst``: ck_dot64p_sacc's two plans, the limb
    recombination and the accumulator add in the epilogue (acc copied
    into the output first);
  * ``dot+epi``: the wrapper ck_dot64p at its chosen plan, then the int64
    epilogue in torch (acc + kernels.recombine), the default step's
    contraction before ck_dot64p_sacc took it.

Each is first held bit for bit against the plain version (run on the card).
Then device ms a launch (``graph_ms``: ``--reps`` calls captured in one
CUDA graph, as a blind rotation's steps run, and its replay timed by CUDA
events, so the host's enqueue is not timed), ``cold``: the launches rotate over enough distinct keys that together hold
more bytes than the 50 MB L2, so each launch reads its key from HBM, as each
step of a blind rotation does; ``hot``: one key, which stays in L2.  Two
rounds, the plans in turns (os, ..., dot+epi, dot+epi, ..., os).  Each line
gives the key's read rate (its bytes once over the cold ms) and the share of
the bytes floor (key + digits + output once at 3.35 TB/s) that the cold
time reaches, and the plan ``kernels.ck_dot64p_plan`` chooses for both
kernels (one rule and KST_ROWS).  With
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
KP1, KEY_SHIFT = 2, 0                          # 8 limbs of each polynomial
C = N // M
BATCHES = (1, 2, 3, 4, 8, 16, 40, 48, 56, 64)
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


def sacc_launcher(entry, x, wmt, acc, *, rows, kst):
    """A raw launch of the ck_dot64p_sacc C function at a forced plan into
    a fixed output; returns the output."""
    B, Jm = x.shape[0], wmt.shape[-1]
    out = torch.empty_like(acc)

    def run(key=wmt):
        rc = entry(x.data_ptr(), key.data_ptr(), acc.data_ptr(),
                   out.data_ptr(), B, N, M, Jm, KP1, UL // KP1, P,
                   K.ck_width(Jm), KEY_SHIFT, rows, int(kst),
                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ck_dot64p_sacc: cudaError {rc}")
        return out
    return run


def dot_epilogue(x, wmt, acc):
    """ck_dot64p at its chosen plan, then the int64 epilogue in torch."""
    def run(key=wmt):
        y = K.ck_dot64p(x, key, N=N, m=M, planes=P)
        return acc + K.recombine(y, KP1, KEY_SHIFT).reshape(acc.shape)
    return run


def graph_ms(fn, reps: int) -> float:
    """Device ms a call of fn(): reps calls captured in one CUDA graph,
    replayed once to warm, then once between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rotating(run, keys):
    """fn() for graph_ms: each call the next key."""
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
    sacc = _build.entry("ck_dot64p_sacc")
    g = torch.Generator(device=dev).manual_seed(21)
    for Jm in (512, 768):
        key_bytes = UL * (N + M) * Jm
        keys = [torch.randint(-128, 128, (UL, N + M, Jm), generator=g,
                              device=dev, dtype=torch.int8)
                for _ in range(-(-3 * L2_BYTES // key_bytes))]
        for B in map(int, args.batches.split(",")):
            x = torch.randint(-64, 65, (B, C * P * K.ck_width(Jm)),
                              generator=g, device=dev, dtype=torch.int8)
            acc = torch.randint(-2**63, 2**63 - 1, (B, KP1 * N),
                                generator=g, device=dev, dtype=torch.int64)
            want = K.ck_dot64p_plain(x, keys[0], N=N, m=M, planes=P)
            want_acc = K.ck_dot64p_acc_plain(x, keys[0], acc, N=N, m=M,
                                             key_shift=KEY_SHIFT, planes=P,
                                             kp1=KP1)
            plans = {"os": dict(rows=128 if B > 64 else 64, kst=False),
                     "kst": dict(rows=128, kst=True)}
            runs = {name: launcher(entry, x, keys[0], **pl)
                    for name, pl in plans.items()}
            runs.update({f"sacc_{name}": sacc_launcher(sacc, x, keys[0], acc,
                                                       **pl)
                         for name, pl in plans.items()})
            runs["dot+epi"] = dot_epilogue(x, keys[0], acc)
            for name, run in runs.items():
                out = run()
                torch.cuda.synchronize()
                cs.check(torch.equal(out, want if name in plans
                                     else want_acc), f"J*m={Jm} B={B}: {name}")
            floor, _ = cs.bound_ms(key_bytes + x.numel() + 4 * want.numel())
            row = {"Jm": Jm, "B": B, "keys": len(keys),
                   "chosen": K.ck_dot64p_plan(B, N, M, Jm, P),
                   "bytes_floor_ms": floor, "card": smi}
            order = list(runs) + list(runs)[::-1]
            for name in order:
                cold = graph_ms(rotating(runs[name], keys), args.reps)
                hot = graph_ms(runs[name], args.reps)
                row.setdefault(name, []).append(
                    {"cold_ms": cold, "hot_ms": hot,
                     "key_GBps": key_bytes / cold / 1e6,
                     "floor_share": floor / cold})
            print(json.dumps(row), flush=True)
            del x, acc, want, want_acc, runs
        if args.parts:
            x = torch.randint(-64, 65, (4, C * P * K.ck_width(Jm)),
                              generator=g, device=dev, dtype=torch.int8)
            fns = _build.variants("ck_dot64p", [(f"CK_PART={i}",)
                                                for i in (1, 2, 3)])
            parts = {}
            for name, fn in zip(("loads", "wgmmas", "epilogue"), fns):
                run = launcher(fn, x, keys[0], rows=128, kst=True)
                parts[name] = graph_ms(rotating(run, keys), args.reps)
            print(json.dumps({"Jm": Jm, "B": 4, "kst_parts_ms": parts,
                              "card": smi}), flush=True)
        del keys
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
