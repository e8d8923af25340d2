"""The port's 64-bit chunked contractions against an earlier tree's, on one
card, in turns.

    python tools/torch_ck64_ab.py PARENT_DIR [--rounds 1]

PARENT_DIR is a checkout of an earlier commit of this repository (for
example a ``git archive`` unpacked into a git-ignored directory).  Its
``tfhe_tpu_torch/ops/csrc/ck_dot64p.cu`` and ``ck_dot64p_acc.cu`` (the
``mma.sync`` kernels that stage the key wm (UL, J*m, N+m) by hand) are built
by ``_build.variants`` beside this tree's (int8 wgmma on the K-packed key
wmt (UL, N+m, J*m), loaded by TMA).  Every kernel is first held bit for bit
against the plain version (run on the card) at every case; then each round
times the parent, this tree, this tree, the parent (CUDA events over raw
ctypes launches, so no wrapper time is counted):

  * ck_dot64p at CB_MXU (one plane, 12 limb groups, J*m = 640) and
    CB_ACTIVE (two planes, 16 groups, J*m = 512) B=256, and at CB_MXU tail
    batches; ck_dot64p_acc at CB_MXU and CB_ACTIVE B=256.  This tree's
    kernels at the chosen plan and at every plan their raw entries take
    (PLANS: ck_dot64p's 64 or 128 rows a block, ck_dot64p_acc's rows and
    1 or 2 limbs a pass).

Then, once: this tree's kernels built three more times with CK_PART=1, 2,
3 (csrc/ck_wgmma.cuh), keeping only the TMA loads, only the wgmmas, or only
the epilogue, at the B=256 cases and the chosen plans; the one-call library
yardstick (torch._int_mm of the same int8 product); the host's time per
launch (raw ctypes call of each kernel, this tree's encoding its two tensor
maps; and this tree's Python wrapper) at B=1, where the card is not the
limit; and the transpose copy that a caller holding only wm pays per call.

Needs one card, nvcc and the port's build flags; prints one line per
measurement and the card's name and power limit.
"""
import argparse
import ctypes
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as c  # noqa: E402
from tfhe_tpu_torch.ops import _build, kernels as K  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
# the parent's C signatures: (x, wm, out, B, N, m, Jm, UL, P, ckp, stream)
# and (x, wm, acc, out, B, N, m, Jm, kp1, L, P, ckp, key_shift, stream)
PARENT_ARGTYPES = {"ck_dot64p": [_P, _P, _P] + [_I] * 7 + [_P],
                   "ck_dot64p_acc": [_P] * 4 + [_I] * 9 + [_P]}
PARTS = ("loads", "mmas", "epilogue")
# the plan arguments of this tree's raw entries: (rows,) of ck_dot64p,
# (rows, limbs) of ck_dot64p_acc
PLANS = {"dot": ((64,), (128,)),
         "acc": ((64, 1), (64, 2), (128, 1), (128, 2))}
N, M, KP1 = 2048, 64, 2


def build_parent(parent: Path) -> dict:
    """ctypes functions of the parent's two kernels, compiled from its
    sources and headers in a directory of the build tree."""
    csrc = parent / "tfhe_tpu_torch" / "ops" / "csrc"
    out = _build.BUILD_DIR / "parent_ck64"
    out.mkdir(parents=True, exist_ok=True)
    for f in [*csrc.glob("*.cuh"), *(csrc / f"{n}.cu"
                                      for n in PARENT_ARGTYPES)]:
        shutil.copy(f, out)
    fns = {}
    for name, argtypes in PARENT_ARGTYPES.items():
        fn = _build.variants(name, [()], out / f"{name}.cu")[0]
        fn.argtypes = argtypes
        fns[name] = fn
    return fns


class Case:
    """One contraction's inputs, its plain answer and raw launchers."""

    def __init__(self, rng, label, kind, B, l, L, P):
        self.label, self.kind, self.B, self.P = label, kind, B, P
        self.L, self.UL, self.Jm = L, KP1 * L, KP1 * l * M
        self.ckp = K.ck_width(self.Jm)
        lo, hi = (-128, 128) if P == 1 else (-64, 65)
        C = N // M

        def dev(a):
            return torch.from_numpy(a).cuda()
        self.x = dev(rng.integers(lo, hi, (B, C * P * self.ckp))
                     .astype(np.int8))
        self.wm = dev(rng.integers(-128, 128, (self.UL, self.Jm, N + M))
                      .astype(np.int8))
        self.wmt = K.ck_wmt(self.wm)
        self.acc = dev(rng.integers(-2**63, 2**63, (B, KP1 * N),
                                    dtype=np.int64))
        self.key_shift = 64 - 8 * L
        if kind == "dot":
            self.out = torch.empty((self.UL, B, N), dtype=torch.int32,
                                   device="cuda")
        else:
            self.out = torch.empty_like(self.acc)
        # the essential MACs: every folded output sums J*N terms per plane
        self.macs = P * B * self.UL * N * (self.Jm // M) * N

    @property
    def name(self):
        return "ck_dot64p" if self.kind == "dot" else "ck_dot64p_acc"

    def want(self):
        if self.kind == "dot":
            return K.ck_dot64p_plain(self.x, self.wm, N=N, m=M,
                                     planes=self.P)
        return K.ck_dot64p_acc_plain(self.x, self.wm, self.acc, N=N, m=M,
                                     key_shift=self.key_shift,
                                     planes=self.P, kp1=KP1)

    def chosen(self):
        if self.kind == "dot":
            return (K.ck_dot64p_plan(self.B, N, M, self.Jm, self.P),)
        return K.ck_dot64p_acc_plan(self.B, N, M, self.Jm, self.L, self.P)

    def plans(self):
        return PLANS[self.kind]

    def new_runner(self, fn, plan):
        stream = torch.cuda.current_stream().cuda_stream
        if self.kind == "dot":
            args = (self.x.data_ptr(), self.wmt.data_ptr(),
                    self.out.data_ptr(), self.B, N, M, self.Jm, self.UL,
                    self.P, self.ckp, *plan, stream)
        else:
            args = (self.x.data_ptr(), self.wmt.data_ptr(),
                    self.acc.data_ptr(), self.out.data_ptr(), self.B, N, M,
                    self.Jm, KP1, self.L, self.P, self.ckp, self.key_shift,
                    *plan, stream)
        return lambda: _ok(fn(*args))

    def parent_runner(self, fn):
        stream = torch.cuda.current_stream().cuda_stream
        if self.kind == "dot":
            args = (self.x.data_ptr(), self.wm.data_ptr(),
                    self.out.data_ptr(), self.B, N, M, self.Jm, self.UL,
                    self.P, self.ckp, stream)
        else:
            args = (self.x.data_ptr(), self.wm.data_ptr(),
                    self.acc.data_ptr(), self.out.data_ptr(), self.B, N, M,
                    self.Jm, KP1, self.L, self.P, self.ckp, self.key_shift,
                    stream)
        return lambda: _ok(fn(*args))

    def wrapper(self):
        if self.kind == "dot":
            return lambda: K.ck_dot64p(self.x, self.wm, N=N, m=M,
                                       planes=self.P, wmt=self.wmt)
        return lambda: K.ck_dot64p_acc(self.x, self.wm, self.acc, N=N, m=M,
                                       key_shift=self.key_shift,
                                       planes=self.P, kp1=KP1, wmt=self.wmt)


def _ok(rc):
    if rc != 0:
        raise RuntimeError(f"launch failed with cudaError {rc}")


def host_us(fn, n=200):
    """Host microseconds per call of fn, the card's queue never full."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = c.nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build_all()
    parent = build_parent(args.parent)
    new = {"ck_dot64p": _build.entry("ck_dot64p"),
           "ck_dot64p_acc": _build.entry("ck_dot64p_acc")}
    parts = {name: _build.variants(name, [(f"CK_PART={p}",)
                                          for p in (1, 2, 3)])
             for name in new}
    print(f"built in {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)

    rng = np.random.default_rng(0)
    cases = [Case(rng, "CB_MXU", "dot", 256, 5, 6, 1),
             Case(rng, "CB_ACTIVE", "dot", 256, 4, 8, 2),
             Case(rng, "CB_MXU", "acc", 256, 5, 6, 1),
             Case(rng, "CB_ACTIVE", "acc", 256, 4, 8, 2)] + [
        Case(rng, "CB_MXU", "dot", B, 5, 6, 1) for B in (1, 3, 100, 512)]

    for case in cases:                    # bit for bit, every plan
        want = case.want()
        runs = [("parent", case.parent_runner(parent[case.name]))] + [
            (f"new {plan}", case.new_runner(new[case.name], plan))
            for plan in case.plans()]
        for who, run in runs:
            run()
            torch.cuda.synchronize()
            if not torch.equal(case.out, want):
                print(f"FAIL {who} {case.name} {case.label} B={case.B}: "
                      f"differs from the plain version")
                return 1
        del want
    print("every kernel and plan equals the plain version", flush=True)

    def one_round(who):
        for case in cases:
            bnd, by = c.bound_ms(c._nbytes(case.x, case.wm, case.out)
                                 + (c._nbytes(case.acc)
                                    if case.kind == "acc" else 0),
                                 case.macs)
            if who == "PARENT":
                ms = c.cuda_ms(case.parent_runner(parent[case.name]), 10)
                print(f"PARENT {case.name} {case.label} B={case.B}: "
                      f"{ms:.4f} ms (bound {bnd:.4f} by {by})", flush=True)
                continue
            chosen = case.chosen()
            res = [f"chosen {chosen} {c.cuda_ms(case.new_runner(new[case.name], chosen), 10):.4f}"]
            for plan in case.plans():
                if plan != chosen:
                    ms = c.cuda_ms(case.new_runner(new[case.name], plan), 10)
                    res.append(f"{plan} {ms:.4f}")
            print(f"NEW {case.name} {case.label} B={case.B} (ms; bound "
                  f"{bnd:.4f} by {by}): " + ", ".join(res), flush=True)

    for _ in range(args.rounds):
        for who in ("PARENT", "NEW", "NEW", "PARENT"):
            one_round(who)

    for case in cases[:4]:                # parts, library, at B=256
        chosen = case.chosen()
        res = {"whole": c.cuda_ms(case.new_runner(new[case.name], chosen),
                                  10)}
        for part, fn in zip(PARTS, parts[case.name]):
            res[part] = c.cuda_ms(case.new_runner(fn, chosen), 10)
        x2 = case.x.reshape(-1, case.Jm) if case.ckp == case.Jm else None
        if x2 is not None:
            wcat = case.wm.permute(1, 0, 2).reshape(case.Jm, -1)
            res["library _int_mm"] = c.cuda_ms(
                lambda: torch._int_mm(x2, wcat), 10)
            del wcat
        print(f"NEW parts {case.name} {case.label} B={case.B} {chosen} "
              f"(ms): " + ", ".join(f"{k} {v:.4f}" for k, v in res.items()),
              flush=True)

    for case in cases[4:5] + cases[2:3]:  # host per launch, B=1 and acc
        parent_us = host_us(case.parent_runner(parent[case.name]))
        raw_us = host_us(case.new_runner(new[case.name], case.chosen()))
        wrap_us = host_us(case.wrapper())
        print(f"host {case.name} {case.label} B={case.B} (us per launch): "
              f"parent raw {parent_us:.1f}, new raw (two tensor-map "
              f"encodes) {raw_us:.1f}, new wrapper {wrap_us:.1f}",
              flush=True)
    ms = c.cuda_ms(lambda: K.ck_wmt(cases[0].wm), 10)
    print(f"wm -> wmt transpose of one CB_MXU step {tuple(cases[0].wm.shape)}"
          f" (the per-call cost without the prepared key): {ms:.4f} ms")
    print(f"total {time.perf_counter() - t0:.1f} s [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
