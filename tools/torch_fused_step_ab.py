"""The port's fused CMux step against an earlier tree's, on one card, in turns.

    python tools/torch_fused_step_ab.py PARENT_DIR [--rounds 1]

PARENT_DIR is a checkout of an earlier commit of this repository (for
example a ``git archive`` unpacked into a git-ignored directory).  Its
``tfhe_tpu_torch/ops/csrc/fused_cmux_step.cu`` (the ``mma.sync`` kernel on
materialize_w's layout W (L, (k+1)*l*N, (k+1)*N)) and ``materialize_w.cu``
are built by ``_build.variants`` beside this tree's kernels (the wgmma + TMA step on the
K-packed key Wt (L, (k+1)*N, (k+1)*l*N) and materialize_wt).  Both steps
are first held bit for bit against the plain version on the same inputs;
then each round times the parent, this tree, this tree, the parent (CUDA
events, raw ctypes launches for both, so no wrapper time is counted):

  * materialize_w (parent) and materialize_wt (this tree) at GATE_FAST2's
    and GATE_MXU's key shapes, and the one PyTorch copy with which
    MatmulEngine transposes a dense W (GATE_FAST2);
  * the step at GATE_FAST2 B=8192 and 1024 and GATE_MXU B=8192, and over a
    sweep of GATE_FAST2 batches, at every plan each kernel offers (the
    parent's 64- and 128-row batch tiles, this tree's 64- and 128-column
    blocks) and as chosen;
  * the parts of one step at GATE_FAST2 B=8192: each kernel built three
    more times with FCS_PART=1, 2, 3, keeping only its key staging (parent:
    the threads' loads and transposition of W into shared memory; this
    tree: the TMA loads), its digit build, or its MMAs.  This tree's kernel
    has the flag; the parent's source gets it here by the text edits in
    PARENT_PARTS.

Needs one card, nvcc and the port's build flags; prints one line per
measurement and the card's name and power limit.
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
import chip_smoke as c  # noqa: E402
from tfhe_tpu_torch import torus as T  # noqa: E402
from tfhe_tpu_torch.ops import _build, kernels as K  # noqa: E402
from tfhe_tpu_torch.params import GATE_FAST2, GATE_MXU  # noqa: E402

# The parent's mma.sync kernel, stripped by -DFCS_PART as this tree's is:
# 1 keeps the W staging, 2 the digit build, 3 the A-fragment loads and MMAs.
PARENT_PARTS = [
    ("using namespace tfhe;\n",
     "using namespace tfhe;\n#ifndef FCS_PART\n#define FCS_PART 0\n#endif\n"
     "constexpr bool KEYS = FCS_PART == 0 || FCS_PART == 1;\n"
     "constexpr bool DIGITS = FCS_PART == 0 || FCS_PART == 2;\n"
     "constexpr bool MMAS = FCS_PART == 0 || FCS_PART == 3;\n"),
    ("for (int rr = 0; rr < ROWS; ++rr) {",
     "for (int rr = 0; DIGITS && rr < ROWS; ++rr) {"),
    ("        load_w_tiles<L, BK>(", "        if (KEYS) load_w_tiles<L, BK>("),
    ("for (int ks = 0; ks < BK / 32; ++ks) {",
     "for (int ks = 0; MMAS && ks < BK / 32; ++ks) {"),
]
PARTS = ("whole", "keys", "digits", "mmas")
KEY_SHIFT = 8


def build_parent(parent: Path):
    """ctypes functions of the parent's kernels: {"materialize_w": fn,
    "step": [whole, keys, digits, mmas]}.  Its sources, the step with the
    PARENT_PARTS edits, go with its headers into a directory of the build
    tree, from which _build.variants compiles them."""
    csrc = parent / "tfhe_tpu_torch" / "ops" / "csrc"
    out = _build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    for f in [*csrc.glob("*.cuh"), csrc / "materialize_w.cu"]:
        shutil.copy(f, out)
    text = (csrc / "fused_cmux_step.cu").read_text()
    for old, new in PARENT_PARTS:
        if old not in text:
            raise SystemExit(f"parent kernel: no {old!r} to edit")
        text = text.replace(old, new)
    (out / "fused_cmux_step.cu").write_text(text)
    return {"materialize_w": _build.variants(
                "materialize_w", [()], out / "materialize_w.cu")[0],
            "step": _build.variants(
                "fused_cmux_step", [(f"FCS_PART={p}",) for p in range(4)],
                out / "fused_cmux_step.cu")}


class Case:
    """One step shape: inputs, both key layouts, the plain answer."""

    def __init__(self, rng, label, p, kp1, N, B, L=3):
        self.label, self.p, self.kp1, self.N, self.B, self.L = (
            label, p, kp1, N, B, L)
        l = p.l
        self.acc = torch.from_numpy(rng.integers(
            -2**31, 2**31, (B, kp1, N)).astype(np.int32)).cuda()
        self.a = torch.from_numpy(rng.integers(0, 2 * N, (B,))
                                  .astype(np.int32)).cuda()
        self.wt = torch.from_numpy(rng.integers(
            -128, 128, (L, kp1 * N, kp1 * l * N)).astype(np.int8)).cuda()
        self.w = self.wt.transpose(1, 2).contiguous()
        self.out = torch.empty_like(self.acc)

    def want(self):
        p = self.p
        return K.fused_cmux_step_plain(self.a, self.acc, self.w, l=p.l,
                                       bgbit=p.bgbit, offset=p.offset,
                                       key_shift=KEY_SHIFT)

    def runner(self, fn, key, tile):
        p, stream = self.p, torch.cuda.current_stream().cuda_stream
        args = (self.a.data_ptr(), self.acc.data_ptr(), key.data_ptr(),
                self.out.data_ptr(), self.B, self.kp1, self.N, p.l, self.L,
                p.bgbit, p.offset & T.MASK32, KEY_SHIFT, tile, stream)

        def run():
            rc = fn(*args)
            if rc != 0:
                raise RuntimeError(f"cudaError {rc}")
        return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    smi = c.nvidia_smi_line()
    t0 = time.perf_counter()
    parent = build_parent(args.parent.resolve())
    new_step = [_build.entry("fused_cmux_step")] + _build.variants(
        "fused_cmux_step", [(f"FCS_PART={p}",) for p in (1, 2, 3)])
    print(f"built in {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    rng = np.random.default_rng(0)
    F2, MX = GATE_FAST2.tgsw, GATE_MXU.tgsw
    main_cases = [Case(rng, "GATE_FAST2", F2, 3, 512, 8192),
                  Case(rng, "GATE_FAST2", F2, 3, 512, 1024),
                  Case(rng, "GATE_MXU", MX, 2, 1024, 8192)]
    sweep = [Case(rng, "GATE_FAST2", F2, 3, 512, B)
             for B in (1, 3, 64, 65, 100, 256, 512, 704, 768, 2816, 8191)]
    keys = [torch.from_numpy(rng.integers(-128, 128, s).astype(np.int8))
            .cuda() for s in ((3, 9, 3, 1024), (3, 6, 2, 2048))]

    # both steps bit for bit against the plain version, every plan
    for case in main_cases + sweep:
        want = case.want()
        for who, fn, key in (("parent", parent["step"][0], case.w),
                             ("new", new_step[0], case.wt)):
            for tile in (64, 128):
                try:
                    case.runner(fn, key, tile)()
                except RuntimeError as e:
                    print(f"{who} {case.label} B={case.B} tile {tile}: {e}")
                    continue
                torch.cuda.synchronize()
                if not torch.equal(case.out, want):
                    print(f"FAIL {who} {case.label} B={case.B} tile {tile}: "
                          f"differs from the plain version")
                    return 1
        del want
    for v in keys:
        L, J, U, twoN = v.shape
        N = twoN // 2
        w = torch.empty((L, J * N, U * N), dtype=torch.int8, device="cuda")
        parent["materialize_w"](v.data_ptr(), w.data_ptr(), L, J, U, N,
                                torch.cuda.current_stream().cuda_stream)
        if not torch.equal(K.materialize_wt(v), w.transpose(1, 2)):
            print(f"FAIL materialize_wt {tuple(v.shape)}")
            return 1
    print("every step and key equals the plain version / the parent's",
          flush=True)

    def one_round(who):
        fns = parent["step"] if who == "PARENT" else new_step
        for v in keys:
            L, J, U, twoN = v.shape
            N = twoN // 2
            out = torch.empty((L, J * N, U * N), dtype=torch.int8,
                              device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            name = "materialize_w" if who == "PARENT" else "materialize_wt"
            # this tree's entry takes its plan (rows, cols, threads)
            plan = () if who == "PARENT" else K.materialize_w_plan(
                L, J, U, N, K.sm_count(v.device))
            fn = (parent["materialize_w"] if who == "PARENT"
                  else _build.entry("materialize_wt"))
            ms = c.cuda_ms(lambda: fn(v.data_ptr(), out.data_ptr(), L, J, U,
                                      N, *plan, stream), 50)
            print(f"{who} {name} v {tuple(v.shape)}: {ms:.4f} ms")
        if who == "NEW":                      # MatmulEngine's per-call copy
            w = main_cases[0].w
            ms = c.cuda_ms(lambda: w.transpose(1, 2).contiguous(), 20)
            print(f"NEW dense W {tuple(w.shape)} transposed (MatmulEngine."
                  f"_wt, one torch copy): {ms:.4f} ms")
        # the parent's plans are its batch tiles (tile_rows, 0 chooses inside
        # the kernel), this tree's its column plans (tile_cols)
        plan = "tile_rows" if who == "PARENT" else "tile_cols"
        for case in main_cases + sweep:
            key = case.w if who == "PARENT" else case.wt
            chosen = 0 if who == "PARENT" else K.fused_cmux_step_v2_plan(
                case.N, case.p.l, case.L)
            res = []
            for tile, arg in (("chosen", chosen), (64, 64), (128, 128)):
                try:
                    ms = c.cuda_ms(case.runner(fns[0], key, arg), 10)
                    res.append(f"{tile} {ms:.4f}")
                except RuntimeError:
                    res.append(f"{tile} n/a")
            print(f"{who} step {case.label} B={case.B} ({plan}, ms): "
                  + ", ".join(res), flush=True)
        case = main_cases[0]
        key = case.w if who == "PARENT" else case.wt
        for tile in (128, 64):
            ms = [c.cuda_ms(case.runner(fn, key, tile), 10) for fn in fns]
            print(f"{who} parts {case.label} B={case.B} {plan} {tile} (ms): "
                  + ", ".join(f"{n} {m:.4f}" for n, m in zip(PARTS, ms)),
                  flush=True)

    for _ in range(args.rounds):
        for who in ("PARENT", "NEW", "NEW", "PARENT"):
            one_round(who)
    print(f"total {time.perf_counter() - t0:.1f} s [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
