"""The port's two 64-bit limb-sum kernels against an earlier tree's, on one
card, in turns.

    python tools/torch_ck64_ab.py PARENT_DIR [--rounds 1]

PARENT_DIR is a checkout of an earlier commit of this repository (for
example a ``git archive`` unpacked into a git-ignored directory).  Its
``tfhe_tpu_torch/ops/csrc/ck_dot64p_sacc.cu`` and ``ck_cmux_step64.cu`` (the
``mma.sync`` kernels that stage the key wm (UL, J*m, N+m) by hand) are built
by ``_build.variants`` beside this tree's (int8 wgmma on the K-packed key
wmt (UL, N+m, J*m), loaded by TMA; ck_cmux_step64 building its digits in
shared memory).  Every kernel is first held bit for bit against the plain
version (run on the card) at every case and plan; then each round times
the parent, this tree, this tree, the parent (CUDA events over raw ctypes
launches, so no wrapper time is counted):

  * ck_dot64p_sacc at CB_MXU (one plane, 6 limbs, J*m = 640) and CB_ACTIVE
    (two planes, 8 limbs, J*m = 512) B=256 and at CB_MXU tail batches B=1,
    3, 100: this tree's (rows, kst) plans, 64 and 128 rows a block and the
    key-stationary plan;
  * ck_cmux_step64 at the same shapes: this tree's (rows, split) plans, the
    chosen one first; the parent at the row tile its wrapper chose.

Then, once: this tree's kernels built again with CK_PART=1, 2, 3 (and 4 for
ck_cmux_step64: the digit builds alone), each keeping one part, at the
B=256 cases and the chosen plans; the two-kernel steps ck_cmux_step64
replaces (the default step rotate_decompose64_ck + ck_dot64p_sacc, and
the acc step rotate_decompose64_ck_flat + ck_dot64p_acc,
through the wrappers); the one-call library yardstick (torch._int_mm of the
same int8 product); and the host's time per launch of each wrapper at B=1.

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
from tfhe_tpu_torch.params import CB_ACTIVE, CB_MXU  # noqa: E402

_P, _I, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
# the parent's C signatures: (x, wm, acc, out, B, N, m, Jm, kp1, L, P, ckp,
# key_shift, stream) and (a, acc, wm, out, B, kp1, N, m, l, L, P, bgbit,
# offset, key_shift, tile_rows, stream)
PARENT_ARGTYPES = {"ck_dot64p_sacc": [_P] * 4 + [_I] * 9 + [_P],
                   "ck_cmux_step64": [_P] * 4 + [_I] * 8 + [_U64, _I, _I,
                                                            _P]}
PARTS = {"ck_dot64p_sacc": ("loads", "mmas", "epilogue"),
         "ck_cmux_step64": ("loads", "mmas", "epilogue", "builds")}
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


def parent_tile(B: int) -> int:
    """The row tile the parent's ck_cmux_step64 wrapper chose: 64 where its
    128-column tiles fill every SM, else 32 (both fit its shared memory at
    these shapes)."""
    sms = K.sm_count(torch.device("cuda"))
    return 64 if (N // 128) * -(-B // 64) * KP1 >= sms else 32


class Case:
    """One kernel's inputs at one shape, its plain answer and raw
    launchers."""

    def __init__(self, rng, label, name, B, p, L):
        self.label, self.name, self.B, self.L = label, name, B, L
        self.P = 1 if p.bgbit <= 8 else 2
        self.l, self.bgbit, self.offset = p.l, p.bgbit, p.offset
        self.UL, self.Jm = KP1 * L, KP1 * p.l * M
        self.ckp = K.ck_width(self.Jm)
        lo, hi = (-128, 128) if self.P == 1 else (-64, 65)
        C = N // M

        def dev(a):
            return torch.from_numpy(a).cuda()
        self.x = dev(rng.integers(lo, hi, (B, C * self.P * self.ckp))
                     .astype(np.int8))
        self.a = dev(rng.integers(0, 2 * N, (B,)).astype(np.int32))
        self.wm = dev(rng.integers(-128, 128, (self.UL, self.Jm, N + M))
                      .astype(np.int8))
        self.wmt = K.ck_wmt(self.wm)
        self.acc = dev(rng.integers(-2**63, 2**63, (B, KP1 * N),
                                    dtype=np.int64))
        self.key_shift = 64 - 8 * L
        self.out = torch.empty_like(self.acc)
        # the essential MACs: every folded output sums J*N terms per plane
        self.macs = self.P * B * self.UL * N * (self.Jm // M) * N
        self.step = self.name == "ck_cmux_step64"
        self.kw = (dict(l=p.l, bgbit=p.bgbit, offset=p.offset, m=M,
                        planes=self.P, kp1=KP1, key_shift=self.key_shift)
                   if self.step else
                   dict(N=N, m=M, planes=self.P, kp1=KP1,
                        key_shift=self.key_shift))
        self.args = (self.a, self.acc, self.wmt) if self.step else \
            (self.x, self.wmt, self.acc)

    def want(self):
        if self.step:
            return K.ck_cmux_step64_plain(*self.args, **self.kw)
        return K.ck_dot64p_acc_plain(*self.args, **self.kw)

    def bound(self):
        return c.bound_ms(c._nbytes(*self.args, self.out), self.macs)

    def chosen(self):
        if self.step:
            return K.ck_cmux_step64_plan(self.B, KP1, N, M, self.Jm, self.L,
                                         self.P, self.acc.device)
        rows, kst = K.ck_dot64p_plan(self.B, N, M, self.Jm, self.P,
                                     entry="ck_dot64p_sacc")
        return rows, int(kst)

    def plans(self):
        if not self.step:
            return [(64, 0), (128, 0), (128, 1)]
        rows = (64, 128) if self.B > 64 else (64,)
        return [(r, s) for r in rows for s in (1, 2, 3, 4)]

    def new_runner(self, fn, plan):
        stream = torch.cuda.current_stream().cuda_stream
        if self.step:
            args = (self.a.data_ptr(), self.acc.data_ptr(),
                    self.wmt.data_ptr(), self.out.data_ptr(), self.B, KP1, N,
                    M, self.l, self.L, self.P, self.bgbit, self.offset,
                    self.key_shift, *plan, stream)
        else:
            args = (self.x.data_ptr(), self.wmt.data_ptr(),
                    self.acc.data_ptr(), self.out.data_ptr(), self.B, N, M,
                    self.Jm, KP1, self.L, self.P, self.ckp, self.key_shift,
                    *plan, stream)
        return lambda: _ok(fn(*args))

    def parent_runner(self, fn):
        stream = torch.cuda.current_stream().cuda_stream
        if self.step:
            args = (self.a.data_ptr(), self.acc.data_ptr(),
                    self.wm.data_ptr(), self.out.data_ptr(), self.B, KP1, N,
                    M, self.l, self.L, self.P, self.bgbit, self.offset,
                    self.key_shift, parent_tile(self.B), stream)
        else:
            args = (self.x.data_ptr(), self.wm.data_ptr(),
                    self.acc.data_ptr(), self.out.data_ptr(), self.B, N, M,
                    self.Jm, KP1, self.L, self.P, self.ckp, self.key_shift,
                    stream)
        return lambda: _ok(fn(*args))

    def wrapper(self):
        fn = K.ck_cmux_step64 if self.step else K.ck_dot64p_sacc
        return lambda: fn(*self.args, **self.kw)


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
    new = {name: _build.entry(name) for name in PARENT_ARGTYPES}
    parts = {name: _build.variants(name, [(f"CK_PART={i + 1}",)
                                          for i in range(len(PARTS[name]))])
             for name in new}
    print(f"built in {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)

    rng = np.random.default_rng(0)
    mxu, active = CB_MXU.tgsw_lvl2, CB_ACTIVE.tgsw_lvl2
    cases = [Case(rng, label, name, B, p, L)
             for name in PARENT_ARGTYPES
             for label, p, L, B in (("CB_MXU", mxu, 6, 256),
                                    ("CB_ACTIVE", active, 8, 256),
                                    ("CB_MXU", mxu, 6, 1),
                                    ("CB_MXU", mxu, 6, 3),
                                    ("CB_MXU", mxu, 6, 100))]

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
            bnd, by = case.bound()
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

    for case in cases:                    # parts, yardsticks, at B=256
        if case.B != 256:
            continue
        chosen = case.chosen()
        res = {"whole": c.cuda_ms(case.new_runner(new[case.name], chosen),
                                  10)}
        for part, fn in zip(PARTS[case.name], parts[case.name]):
            res[part] = c.cuda_ms(case.new_runner(fn, chosen), 10)
        if case.step:
            res["default step"] = c.cuda_ms(
                lambda: c._default_step64(*case.args, **case.kw), 10)
            res["acc step"] = c.cuda_ms(
                lambda: c._acc_step64(*case.args, **case.kw), 10)
        if case.ckp == case.Jm:
            x2 = case.x.reshape(-1, case.Jm)
            wcat = c._wcat(case.wmt)
            res["library _int_mm"] = c.cuda_ms(
                lambda: torch._int_mm(x2, wcat), 10)
            del wcat
        print(f"NEW parts {case.name} {case.label} B={case.B} {chosen} "
              f"(ms): " + ", ".join(f"{k} {v:.4f}" for k, v in res.items()),
              flush=True)

    for case in cases:                    # host per launch at B=1
        if case.B == 1:
            print(f"host {case.name} {case.label} B=1 (us per launch): "
                  f"wrapper {host_us(case.wrapper()):.1f}, raw "
                  f"{host_us(case.new_runner(new[case.name], case.chosen())):.1f}",
                  flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
