"""The port's two rotate-decompose digit emitters against an earlier tree's,
on one card, in turns, timed by device time.

    python tools/torch_rotdec_ab.py PARENT_DIR [--rounds 1] [--e2e]

PARENT_DIR is a checkout of an earlier commit of this repository (for
example a ``git archive`` unpacked into a git-ignored directory).  Its
``tfhe_tpu_torch/ops/csrc/rotate_decompose.cu`` and
``rotate_decompose64_ck.cu`` (before this design: one block per (row,
polynomial), one byte store per digit) are built by ``_build.variants``
beside this tree's (csrc/rotdec.cuh: staged rows, 16-coefficient work
items, 16-byte digit stores, the plan of kernels.rotdec_plan).

At the shapes of chip_smoke.py's phase 2 (rotate_decompose at GATE_DEFAULT
B=256; rotate_decompose64_ck at CB_MXU and CB_ACTIVE B=256 and CB_MXU B=1,
3, 100; the test-only plain layout, rotate_decompose64, at CB_MXU and
CB_ACTIVE B=256), every kernel and plan is first held bit for bit against
the plain version; then each round times the parent, this tree, this tree,
the parent, by chip_smoke.device_ms over raw ctypes launches into
preallocated outputs (no wrapper time).  This tree's rounds also time
forced plans (rows, split, threads) beside the chosen one.
Then, in turns as well, the default and acc steps around each emitter (raw
launches into one x, then ck_dot64p + the int64 epilogue, or
ck_dot64p_acc); once, the launch floor, the wrappers' device time (the
flat entry's too), the host's time per wrapper call and what the plan's
lookup adds to it.  With --e2e, the paths the emitters run on, end to
end, each tree's own chip_smoke.py in a subprocess, in turns (parent, this
tree, this tree, parent, ``--rounds`` times): phase 5 (CB_MXU B=256, 1,000
rotate_decompose64_ck a launch) first, so that no other phase's work comes
before it in the process, then phase 5b (TFHE_CK64_PATH=acc, 1,000
rotate_decompose64_ck_flat) and phase 4 (GATE_DEFAULT onthefly B=256, 630
rotate_decompose), then the host's time a call of each tree's two emitter
wrappers.

Needs one card and nvcc; prints one line per measurement and the card's
name and power limit.
"""
import argparse
import ctypes
import functools
import shutil
import subprocess
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
from tfhe_tpu_torch.params import (CB_ACTIVE, CB_MXU,  # noqa: E402
                                   GATE_DEFAULT)

_P, _I, _U, _U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                    ctypes.c_uint64)
# the parent's C signatures: (a, acc, out, B, kp1, N, l, bgbit, offset,
# stream), (a, acc, out, B, kp1, N, l, bgbit, offset, m, P, ckp, stream)
# and (a, acc, out, B, kp1, N, l, bgbit, offset, P, stream)
PARENT_ARGTYPES = {"rotate_decompose": [_P] * 3 + [_I] * 5 + [_U, _P],
                   "rotate_decompose64_ck": [_P] * 3 + [_I] * 5
                   + [_U64, _I, _I, _I, _P],
                   "rotate_decompose64": [_P] * 3 + [_I] * 5
                   + [_U64, _I, _P]}
# the source each entry lives in (rotate_decompose64: the chunk layout's)
SOURCES = {"rotate_decompose": "rotate_decompose",
           "rotate_decompose64_ck": "rotate_decompose64_ck",
           "rotate_decompose64": "rotate_decompose64_ck"}
M = 64


def build_parent(parent: Path) -> dict:
    """ctypes functions of the parent's two emitters, compiled from its
    sources and headers in a directory of the build tree."""
    csrc = parent / "tfhe_tpu_torch" / "ops" / "csrc"
    out = _build.BUILD_DIR / "parent_rotdec"
    out.mkdir(parents=True, exist_ok=True)
    for f in [*csrc.glob("*.cuh"), *(csrc / f"{n}.cu"
                                      for n in set(SOURCES.values()))]:
        shutil.copy(f, out)
    fns = {}
    for name, argtypes in PARENT_ARGTYPES.items():
        fn = _build.variants(name, [()], out / f"{SOURCES[name]}.cu")[0]
        fn.argtypes = argtypes
        fns[name] = fn
    return fns


def _ok(rc):
    if rc != 0:
        raise RuntimeError(f"launch failed with cudaError {rc}")


class Case:
    """One emitter's inputs at one shape, its plain answer and raw
    launchers."""

    def __init__(self, rng, label, name, B, p):
        self.label, self.name, self.B = label, name, B
        self.l, self.bgbit = p.l, p.bgbit
        self.kp1, self.N = p.tlwe.k + 1, p.tlwe.N
        self.wide = name != "rotate_decompose"
        self.chunked = name == "rotate_decompose64_ck"
        kp1, N = self.kp1, self.N
        self.a = torch.from_numpy(rng.integers(0, 2 * N, (B,))
                                  .astype(np.int32)).cuda()
        if self.wide:
            self.P = 1 if p.bgbit <= 8 else 2
            self.offset = p.offset & ((1 << 64) - 1)
            self.acc = torch.from_numpy(rng.integers(
                -2**63, 2**63, (B, kp1, N), dtype=np.int64)).cuda()
            self.kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset,
                           planes=self.P)
        if self.chunked:
            self.ckp = K.ck_width(kp1 * p.l * M)
            self.out = torch.empty((B, (N // M) * self.P * self.ckp),
                                   dtype=torch.int8, device="cuda")
            self.kw["m"] = M
            self.plain = K.rotate_decompose64_ck_plain
        elif self.wide:
            self.out = torch.empty((B * kp1, p.l * self.P, N),
                                   dtype=torch.int8, device="cuda")
            self.plain = K.rotate_decompose64_plain
        else:
            self.offset = p.offset & T.MASK32
            self.acc = torch.from_numpy(rng.integers(
                -2**31, 2**31, (B, kp1, N)).astype(np.int32)).cuda()
            self.out = torch.empty((B, kp1 * p.l, N), dtype=torch.int8,
                                   device="cuda")
            self.kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset)
            self.plain = K.rotate_decompose_plain
        self.word = self.acc.element_size()

    def want(self):
        return self.plain(self.a, self.acc, **self.kw)

    def bound(self):
        return c.bound_ms(c._nbytes(self.a, self.acc, self.out))

    def chosen(self):
        return K.rotdec_plan(self.B, self.kp1, self.N, self.word,
                             K.sm_count(self.acc.device))

    def plans(self):
        """Forced (rows, split, threads) beside the chosen plan: one row a
        block at splits 1, 2, 4, 8, and two and four rows a block where they
        fit in 512 threads."""
        threads = self.chosen()[2]
        out = [(1, s, threads) for s in (1, 2, 4, 8)]
        out += [(r, 1, threads) for r in (2, 4) if r * threads <= 512]
        return out

    def _head(self):
        return (self.a.data_ptr(), self.acc.data_ptr(), self.out.data_ptr(),
                self.B, self.kp1, self.N, self.l, self.bgbit, self.offset)

    def _mid(self):
        if self.chunked:
            return M, self.P, self.ckp
        return (self.P,) if self.wide else ()

    def new_runner(self, fn, plan):
        stream = torch.cuda.current_stream().cuda_stream
        args = (*self._head(), *self._mid(), *plan, stream)
        return lambda: _ok(fn(*args))

    def parent_runner(self, fn):
        stream = torch.cuda.current_stream().cuda_stream
        args = (*self._head(), *self._mid(), stream)
        return lambda: _ok(fn(*args))

    def wrapper(self):
        fn = getattr(K, self.name)
        return lambda: fn(self.a, self.acc, **self.kw)

    def tag(self):
        return f"{self.name} {self.label} B={self.B}"


# one tree's end-to-end run of the emitters' paths (its own chip_smoke.py),
# then the host's microseconds a call of its two emitter wrappers
E2E = """
import time, torch, chip_smoke as c
from tfhe_tpu_torch.ops import _build, kernels as K
smi = c.nvidia_smi_line()
_build.build_all()
st = c.phase_circuit(smi)[1]
c.phase_circuit_step(smi, st, *c.CK64_STEPS[0])
del st
torch.cuda.empty_cache()
c.phase_generic(smi)
a = torch.zeros(256, dtype=torch.int32, device="cuda")
for name, fn, acc, kw in (
        ("rotate_decompose GATE_DEFAULT", K.rotate_decompose,
         torch.zeros((256, 2, 1024), dtype=torch.int32, device="cuda"),
         dict(l=3, bgbit=7, offset=0)),
        ("rotate_decompose64_ck CB_MXU", K.rotate_decompose64_ck,
         torch.zeros((256, 2, 2048), dtype=torch.int64, device="cuda"),
         dict(l=5, bgbit=8, offset=0, m=64))):
    fn(a, acc, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(400):
        fn(a, acc, **kw)
    us = (time.perf_counter() - t0) / 400 * 1e6
    torch.cuda.synchronize()
    print(f"host {name} B=256: {us:.1f} us a wrapper call")
"""
E2E_LINES = ("phase 4 GATE_DEFAULT", "phase 5 CB_MXU", "phase 5b", "host ")


def e2e(tree: Path) -> list:
    """The launch lines of phases 4, 5 and 5b from ``tree``'s chip_smoke.py,
    run in a subprocess from that tree."""
    run = subprocess.run([sys.executable, "-c", E2E], cwd=tree,
                         capture_output=True, text=True, timeout=1200)
    if run.returncode != 0:
        raise RuntimeError(f"{tree}: exit {run.returncode}\n"
                           f"{run.stderr[-3000:]}")
    return [line for line in run.stdout.splitlines()
            if line.startswith(E2E_LINES)]


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
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = c.nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build_all()
    parent = build_parent(args.parent)
    new = {name: _build.entry(name) for name in PARENT_ARGTYPES}
    print(f"built in {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)

    rng = np.random.default_rng(0)
    mxu, active = CB_MXU.tgsw_lvl2, CB_ACTIVE.tgsw_lvl2
    cases = [Case(rng, "GATE_DEFAULT", "rotate_decompose", 256,
                  GATE_DEFAULT.tgsw)]
    cases += [Case(rng, label, "rotate_decompose64_ck", B, p)
              for label, p, B in (("CB_MXU", mxu, 256),
                                  ("CB_ACTIVE", active, 256),
                                  ("CB_MXU", mxu, 1), ("CB_MXU", mxu, 3),
                                  ("CB_MXU", mxu, 100))]
    cases += [Case(rng, label, "rotate_decompose64", 256, p)
              for label, p in (("CB_MXU", mxu), ("CB_ACTIVE", active))]

    for case in cases:                    # bit for bit, every plan
        want = case.want()
        runs = [("parent", case.parent_runner(parent[case.name]))]
        runs += [(f"new {plan}", case.new_runner(new[case.name], plan))
                 for plan in [case.chosen(), *case.plans()]]
        for who, run in runs:
            case.out.fill_(-1)
            run()
            torch.cuda.synchronize()
            if not torch.equal(case.out, want):
                print(f"FAIL {who} {case.tag()}: differs from the plain "
                      f"version")
                return 1
        del want
    print("every kernel and plan equals the plain version", flush=True)

    def one_round(who):
        for case in cases:
            bnd, by = case.bound()
            if who == "PARENT":
                ms = c.device_ms(case.parent_runner(parent[case.name]))
                print(f"PARENT {case.tag()}: device {ms:.4f} ms (bound "
                      f"{bnd:.4f} by {by})", flush=True)
                continue
            chosen = case.chosen()
            ms = c.device_ms(case.new_runner(new[case.name], chosen))
            res = [f"chosen {chosen} {ms:.4f}"]
            for plan in case.plans():
                if plan != chosen:
                    pm = c.device_ms(case.new_runner(new[case.name], plan))
                    res.append(f"{plan} {pm:.4f}")
            print(f"NEW {case.tag()} (device ms; bound {bnd:.4f} by {by}, "
                  f"{bnd / ms:.1%} of it): " + ", ".join(res), flush=True)

    for _ in range(args.rounds):
        for who in ("PARENT", "NEW", "NEW", "PARENT"):
            one_round(who)

    print(f"launch floor: {c.launch_floor_ms():.4f} ms of device time",
          flush=True)
    for case in cases:                    # the wrappers, device and host
        line = (f"wrapper {case.tag()}: device "
                f"{c.device_ms(case.wrapper()):.4f} ms, call "
                f"{c.cuda_ms(case.wrapper(), 20):.4f} ms, host "
                f"{host_us(case.wrapper()):.1f} us a call")
        if case.chunked and case.B == 256:
            flat = functools.partial(K.rotate_decompose64_ck_flat, case.a,
                                     case.acc.reshape(case.B, -1),
                                     N=case.N, **case.kw)
            line += (f"; flat entry device {c.device_ms(flat):.4f} ms, host "
                     f"{host_us(flat):.1f} us")
        print(line, flush=True)
    # the steps around the 64-bit emitter at CB_MXU B=256, each emitter by
    # its raw entry into the same x: the default step (+ ck_dot64p + the
    # int64 epilogue) and the acc step (+ ck_dot64p_acc), in turns
    case = cases[1]
    L, m, kp1 = 6, M, case.kp1
    wmt = torch.from_numpy(rng.integers(-128, 128, (kp1 * L, case.N + m,
                                                    kp1 * case.l * m))
                           .astype(np.int8)).cuda()
    accf = case.acc.reshape(case.B, -1)
    dot = dict(N=case.N, m=m, planes=case.P)

    def default_step(emit):
        emit()
        y = K.ck_dot64p(case.out, wmt, **dot)
        return case.acc + K.recombine(y, kp1, 64 - 8 * L)

    def acc_step(emit):
        emit()
        return K.ck_dot64p_acc(case.out, wmt, accf, kp1=kp1,
                               key_shift=64 - 8 * L, **dot)

    emitters = {"PARENT": case.parent_runner(parent[case.name]),
                "NEW": case.new_runner(new[case.name], case.chosen())}
    for _ in range(args.rounds):
        for who in ("PARENT", "NEW", "NEW", "PARENT"):
            for label, step in (("default", default_step),
                                ("acc", acc_step)):
                run = functools.partial(step, emitters[who])
                print(f"STEP {who} {label} CB_MXU B=256: device "
                      f"{c.device_ms(run, 10):.4f} ms, call "
                      f"{c.cuda_ms(run, 10):.4f} ms", flush=True)
    del wmt

    case = cases[0]                       # what the plan adds to a call

    def lookup():
        K.rotdec_ok(case.N, 16)
        K.rotdec_plan(case.B, case.kp1, case.N, 4,
                      K.sm_count(case.acc.device))
    print(f"host plan lookup (rotdec_ok + sm_count + rotdec_plan): "
          f"{host_us(lookup):.2f} us a call", flush=True)
    if args.e2e:
        for _ in range(args.rounds):
            for who, tree in (("PARENT", args.parent), ("NEW", ROOT),
                              ("NEW", ROOT), ("PARENT", args.parent)):
                for line in e2e(tree):
                    print(f"E2E {who} {line[:400]}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
