"""materialize_w (both entries) and the v1 fused step against an earlier
tree's, on one card, in turns, timed by device time.

    python tools/torch_matw_ab.py PARENT_DIR [--rounds 1] [--e2e]

PARENT_DIR is a checkout of an earlier commit of this repository (for
example a ``git archive`` unpacked into a git-ignored directory).  Its
``tfhe_tpu_torch/ops/csrc/materialize_w.cu`` and ``fused_cmux_step_v1.cu``
(with the headers beside them) are built by ``_build.variants`` beside this
tree's.

At the shapes of chip_smoke.py's phase 2 (materialize_w at GATE_DEFAULT's
key (4,6,2,2048), the one a path runs, and GATE_FAST2's (3,9,3,1024);
materialize_wt at GATE_FAST2's and GATE_MXU's (3,6,2,2048); v1 at GATE_FAST2
and GATE_MXU B=8192), every kernel, plan and build variant is first held
bit for bit against the plain version (outputs first filled with -1 bytes);
then each round times the parent, this tree, this tree, the parent, by
chip_smoke.device_ms over raw ctypes launches into preallocated outputs (no
wrapper time).  This tree's rounds also time forced plans beside the chosen
one (materialize: 16 .. N rows a block; v1: every digit-build size that
fits), the library yardstick (chip_smoke.flip_w / flip_wt) and, beside v1,
its parts (FCS_PART=1..4 builds: key loads and transpose, digit build,
wgmmas, key loads alone) and v2's kernel on the same key K-packed (what the
in-kernel transpose costs).  At the three keys a path runs, this tree's
rounds also time the path's step: the materialize launch followed by the
kernel that reads its output (GATE_DEFAULT: mm_recombine_acc_wt at B=256;
GATE_FAST2 and GATE_MXU: fused_cmux_step_v2 at B=8192), for the chosen plan
and for 32 and 64 rows, beside that reader alone, so that what a plan costs
the reader shows.  Then, once, the launch floor.  With
--e2e, the paths the kernels run on, end to end, each tree's own
chip_smoke.py in a subprocess, in turns (parent, this tree, this tree,
parent, ``--rounds`` times): phase 3 (GATE_FAST2 onthefly B=8192, 500
materialize_wt a launch) and phase 4 (GATE_DEFAULT onthefly B=256, 630
materialize_wt); materialize_w and v1 run on no path.

Needs one card and nvcc; prints one line per measurement and the card's
name and power limit.
"""
import argparse
import ctypes
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
from tfhe_tpu_torch.params import (GATE_DEFAULT, GATE_FAST2,  # noqa: E402
                                    GATE_MXU)

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
# the parent's C signatures: (v, w, L, J, U, N, stream) and (a, acc, w,
# out, B, kp1, N, l, bgbit, offset, key_shift, stream)
PARENT_ARGTYPES = {"materialize_w": [_P, _P] + [_I] * 4 + [_P],
                   "materialize_wt": [_P, _P] + [_I] * 4 + [_P],
                   "fused_cmux_step_v1": [_P] * 4 + [_I] * 5 + [_U, _I, _P]}
# v1's parts: its source built with FCS_PART=i keeps one part
PARTS = {1: "part keys+transpose", 2: "part digits", 3: "part wgmmas",
         4: "part key loads"}
SOURCES = {"materialize_w": "materialize_w",
           "materialize_wt": "materialize_w",
           "fused_cmux_step_v1": "fused_cmux_step_v1"}


def build_parent(parent: Path) -> dict:
    """ctypes functions of the parent's kernels, compiled from its sources
    and headers in a directory of the build tree."""
    csrc = parent / "tfhe_tpu_torch" / "ops" / "csrc"
    out = _build.BUILD_DIR / "parent_matw"
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


def _stream():
    return torch.cuda.current_stream().cuda_stream


class MatCase:
    """One materialize entry's key at one shape: inputs, output, plain
    answer, raw launchers."""

    def __init__(self, rng, label, name, shape):
        self.label, self.name, self.shape = label, name, shape
        L, J, U, N = shape
        self.v = torch.from_numpy(rng.integers(-128, 128, (L, J, U, 2 * N))
                                  .astype(np.int8)).cuda()
        self.wt = name == "materialize_wt"
        self.plain = K.materialize_wt_plain if self.wt \
            else K.materialize_w_plain
        self.flip = c.flip_wt if self.wt else c.flip_w
        self.out = torch.empty((L, U * N, J * N) if self.wt
                               else (L, J * N, U * N), dtype=torch.int8,
                               device="cuda")
        self.reader = None

    def want(self):
        return self.plain(self.v)

    def bound(self):
        return c.bound_ms(c._nbytes(self.v, self.out))

    def chosen(self):
        return K.materialize_w_plan(*self.shape, K.sm_count(self.v.device))

    def plans(self):
        """Forced (rows, whole rows, 256 threads) plans: 16 rows up to every
        row of the vector."""
        N = self.shape[3]
        cols = self.chosen()[1]
        return [(r, cols, 256) for r in (16, 32, 64, 128, 256, 512, 1024)
                if r <= N]

    def step_plans(self):
        """The chosen plan first, then 32 and 64 rows."""
        cols = self.chosen()[1]
        plans = [self.chosen()] + [(r, cols, 256) for r in (32, 64)]
        return list(dict.fromkeys(plans))

    def with_reader(self, rng, p, B):
        """The kernel the path runs on this output (materialize_wt's):
        fused_cmux_step_v2 at B, or mm_recombine_acc_wt on digits of B rows
        where the key has 4 limbs; p is the parameter set."""
        L, J, U, N = self.shape
        if L <= 3:
            a = torch.from_numpy(rng.integers(0, 2 * N, (B,))
                                 .astype(np.int32)).cuda()
            acc = torch.from_numpy(rng.integers(-2**31, 2**31, (B, U, N))
                                   .astype(np.int32)).cuda()
            kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset, key_shift=8)
            self.reader = lambda: K.fused_cmux_step_v2(a, acc, self.out, **kw)
        else:
            x = torch.from_numpy(rng.integers(-64, 64, (B, J * N))
                                 .astype(np.int8)).cuda()
            acc = torch.zeros((B, U, N), dtype=torch.int32, device="cuda")
            self.reader = lambda: K.mm_recombine_acc_wt(x, self.out, acc)
        name = "fused_cmux_step_v2" if L <= 3 else "mm_recombine_acc_wt"
        self.reader_tag = f"{name} B={B}"
        return self

    def new_runner(self, fn, plan):
        args = (self.v.data_ptr(), self.out.data_ptr(), *self.shape, *plan,
                _stream())
        return lambda: _ok(fn(*args))

    def parent_runner(self, fn):
        args = (self.v.data_ptr(), self.out.data_ptr(), *self.shape,
                _stream())
        return lambda: _ok(fn(*args))

    def library(self):
        return lambda: self.flip(self.v)

    def tag(self):
        return f"{self.name} {self.label} v {tuple(self.v.shape)}"


def mat_cases(rng) -> list:
    """materialize_w at GATE_DEFAULT's key and GATE_FAST2's; materialize_wt
    at GATE_DEFAULT's, GATE_FAST2's and GATE_MXU's (with their paths'
    readers)."""
    return [MatCase(rng, "GATE_DEFAULT", "materialize_w", (4, 6, 2, 1024)),
            MatCase(rng, "GATE_DEFAULT", "materialize_wt", (4, 6, 2, 1024))
            .with_reader(rng, GATE_DEFAULT.tgsw, 256),
            MatCase(rng, "GATE_FAST2", "materialize_w", (3, 9, 3, 512)),
            MatCase(rng, "GATE_FAST2", "materialize_wt", (3, 9, 3, 512))
            .with_reader(rng, GATE_FAST2.tgsw, 8192),
            MatCase(rng, "GATE_MXU", "materialize_wt", (3, 6, 2, 1024))
            .with_reader(rng, GATE_MXU.tgsw, 8192)]


class V1Case:
    """v1 at one parameter set and B: inputs (the key in materialize_w's
    layout), output, plain answer, raw launchers."""

    name = "fused_cmux_step_v1"

    def __init__(self, rng, label, p, B):
        self.label, self.B = label, B
        self.kp1, self.N, self.l = p.tlwe.k + 1, p.tlwe.N, p.l
        kp1, N, l = self.kp1, self.N, self.l
        self.bgbit, self.offset = p.bgbit, p.offset & T.MASK32
        self.kw = dict(l=l, bgbit=p.bgbit, offset=p.offset, key_shift=8)
        self.a = torch.from_numpy(rng.integers(0, 2 * N, (B,))
                                  .astype(np.int32)).cuda()
        self.acc = torch.from_numpy(rng.integers(-2**31, 2**31, (B, kp1, N))
                                    .astype(np.int32)).cuda()
        self.w = torch.from_numpy(rng.integers(
            -128, 128, (3, kp1 * l * N, kp1 * N)).astype(np.int8)).cuda()
        self.out = torch.empty_like(self.acc)

    def want(self):
        return K.fused_cmux_step_plain(self.a, self.acc, self.w, **self.kw)

    def bound(self):
        macs = self.B * self.kp1 ** 2 * self.l * self.N ** 2 * 3
        return c.bound_ms(c._nbytes(self.a, self.acc, self.w, self.out), macs)

    def chosen(self):
        return (K.fused_cmux_step_v1_plan(self.N, self.l),)

    def plans(self):
        return [(lb,) for lb in (1, 2, 3) if lb <= self.l]

    def _head(self):
        return (self.a.data_ptr(), self.acc.data_ptr(), self.w.data_ptr(),
                self.out.data_ptr(), self.B, self.kp1, self.N, self.l,
                self.bgbit, self.offset, 8)

    def new_runner(self, fn, plan):
        args = (*self._head(), *plan, _stream())
        return lambda: _ok(fn(*args))

    def parent_runner(self, fn):
        args = (*self._head(), _stream())
        return lambda: _ok(fn(*args))

    def library(self):
        """v2's kernel on the same key, K-packed (its wrapper: the chosen
        plan)."""
        wt = self.w.transpose(1, 2).contiguous()
        return lambda: K.fused_cmux_step_v2(self.a, self.acc, wt, **self.kw)

    def tag(self):
        return f"{self.name} {self.label} B={self.B}"


# one tree's end-to-end run of the kernels' paths (its own chip_smoke.py)
E2E = """
import torch, chip_smoke as c
from tfhe_tpu_torch.ops import _build
smi = c.nvidia_smi_line()
_build.build_all()
c.phase_main(smi)
torch.cuda.empty_cache()
c.phase_generic(smi)
"""
E2E_LINES = ("phase 3 GATE_FAST2", "phase 3 breakdown",
             "phase 4 GATE_DEFAULT", "phase 4 breakdown")


def e2e(tree: Path) -> list:
    """The launch and breakdown lines of phases 3 and 4 from ``tree``'s
    chip_smoke.py, run in a subprocess from that tree."""
    run = subprocess.run([sys.executable, "-c", E2E], cwd=tree,
                         capture_output=True, text=True, timeout=1200)
    if run.returncode != 0:
        raise RuntimeError(f"{tree}: exit {run.returncode}\n"
                           f"{run.stderr[-3000:]}")
    return [line for line in run.stdout.splitlines()
            if line.startswith(E2E_LINES)]


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
    parts = _build.variants("fused_cmux_step_v1",
                            [(f"FCS_PART={i}",) for i in PARTS])
    print(f"built in {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)

    rng = np.random.default_rng(0)
    cases = mat_cases(rng) + [
        V1Case(rng, "GATE_FAST2", GATE_FAST2.tgsw, 8192),
        V1Case(rng, "GATE_MXU", GATE_MXU.tgsw, 8192)]

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
        if not torch.equal(case.library()(), want):
            print(f"FAIL library {case.tag()}: differs from the plain "
                  f"version")
            return 1
        del want
    print("every kernel, plan and variant equals the plain version",
          flush=True)

    def one_round(who):
        for case in cases:
            bnd, by = case.bound()
            if who == "PARENT":
                ms = c.device_ms(case.parent_runner(parent[case.name]))
                print(f"PARENT {case.tag()}: device {ms:.4f} ms (bound "
                      f"{bnd:.4f} by {by}, {bnd / ms:.1%} of it)",
                      flush=True)
                continue
            chosen = case.chosen()
            ms = c.device_ms(case.new_runner(new[case.name], chosen))
            res = [f"chosen {chosen} {ms:.4f}"]
            for plan in case.plans():
                if plan != chosen:
                    pm = c.device_ms(case.new_runner(new[case.name], plan))
                    res.append(f"{plan} {pm:.4f}")
            if isinstance(case, V1Case):
                res += [f"{what} "
                        f"{c.device_ms(case.new_runner(fn, chosen)):.4f}"
                        for what, fn in zip(PARTS.values(), parts)]
            lib = "v2 on wt" if isinstance(case, V1Case) else "flip"
            res.append(f"{lib} {c.device_ms(case.library()):.4f}")
            print(f"NEW {case.tag()} (device ms; bound {bnd:.4f} by {by}, "
                  f"{bnd / ms:.1%} of it): " + ", ".join(res), flush=True)
            if isinstance(case, MatCase) and case.reader is not None:
                step_round(case)

    def step_round(case):
        """The path's step: the reader alone, then each plan's launch
        followed by the reader, then the reader alone again."""
        fn = new[case.name]
        alone = [c.device_ms(case.reader)]
        res = []
        for plan in case.step_plans():
            run = case.new_runner(fn, plan)

            def step(run=run):
                run()
                case.reader()
            res.append(f"{plan} {c.device_ms(step):.4f}")
        alone.append(c.device_ms(case.reader))
        print(f"STEP {case.tag()} + {case.reader_tag} (device ms; reader "
              f"alone {alone[0]:.4f} / {alone[1]:.4f}): " + ", ".join(res),
              flush=True)

    for _ in range(args.rounds):
        for who in ("PARENT", "NEW", "NEW", "PARENT"):
            one_round(who)
    print(f"launch floor: {c.launch_floor_ms():.4f} ms of device time",
          flush=True)
    del cases
    torch.cuda.empty_cache()
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
