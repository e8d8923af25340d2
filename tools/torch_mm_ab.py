"""mm_recombine_acc against an earlier tree's kernel, on the card.

    python tools/torch_mm_ab.py PARENT [--splits]

PARENT is an earlier tree unpacked into a git-ignored directory of the repo
(``git archive <commit> | tar -x -C archive_check/parent``).  Its
``tfhe_tpu_torch/ops/csrc/mm_recombine_acc.cu`` (the mma.sync kernel on
materialize_w's MN-major W, entry ``tfhe_mm_recombine_acc(x, w, acc, out, B,
K, UN, L, shift, split, stream)``) is built with the headers beside it and
run at the split its wrapper chose (choose_split over its 64-row tiles);
this tree's kernel runs through ``kernels.mm_recombine_acc_wt`` on the
K-packed key.  At GATE_DEFAULT's step (K = 6,144, U*N = 2,048, 4 limbs) for
the wide cell's B = 8,192 and the adder's launch widths, and at an ep = 3
slice of GATE_FAST2 (K = U*N = 1,536, 3 limbs):

  * both kernels bit for bit against the plain version (run on the card);
  * device ms (chip_smoke.device_ms), parent / new / new / parent, with the
    bound (max(bytes / 3.35 TB/s, 2 MACs / 1,979 TOP/s));
  * the step's key and product as a path runs them: materialize_w + the
    parent's kernel against materialize_wt + this tree's;
  * with ``--splits``, this tree's kernel at every forced split of its plan
    at the narrow widths (the plan's cost model against the card).

Prints the ptxas report of this tree's kernel and one JSON line a case.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from tfhe_tpu_torch.ops import _build  # noqa: E402
from tfhe_tpu_torch.ops import kernels as K  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
# (label, B, K, UN, L, J, U, N): J, U, N give the step's key vector
CASES = [("GATE_DEFAULT", B, 6144, 2048, 4, 6, 2, 1024)
         for B in (8192, 768, 628, 512, 256, 3)] + [
    ("GATE_FAST2 ep=3", B, 1536, 1536, 3, 3, 3, 512) for B in (1024, 3)]


def build_parent(parent: Path):
    """The parent's kernel entry and its occupancy query, compiled from its
    sources in a directory of the build tree."""
    csrc = parent / "tfhe_tpu_torch" / "ops" / "csrc"
    out = _build.BUILD_DIR / "parent_mm"
    out.mkdir(parents=True, exist_ok=True)
    for f in [*csrc.glob("*.cuh"), csrc / "mm_recombine_acc.cu"]:
        shutil.copy(f, out)
    src = out / "mm_recombine_acc.cu"
    fn = _build.variants("mm_recombine_acc", [()], src)[0]
    fn.argtypes = PARENT_ARGTYPES
    lib = ctypes.CDLL(str(_build._lib_path(src)))
    occ = lib.tfhe_mm_recombine_acc_occupancy
    occ.argtypes, occ.restype = [_I], _I
    return fn, occ


def ptxas_report() -> str:
    log = _build._lib_path(_build.CSRC / "mm_recombine_acc.cu").with_suffix(
        ".ptxas.txt")
    lines = log.read_text().splitlines() if log.exists() else []
    keep = [ln for ln in lines if "mm_recombine" in ln or "Used" in ln
            or "spill" in ln or "warning" in ln.lower()]
    return "\n".join(keep)


def main(argv) -> int:
    parent, splits = Path(argv[1]), "--splits" in argv
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    K.mm_recombine_acc_wt(torch.zeros((1, 16), dtype=torch.int8, device=dev),
                          torch.zeros((1, 64, 16), dtype=torch.int8,
                                      device=dev),
                          torch.zeros((1, 64), dtype=torch.int32, device=dev))
    print(ptxas_report(), flush=True)
    pfn, pocc = build_parent(parent)
    sms = K.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(19)
    for label, B, Kd, UN, L, J, U, N in CASES:
        x = torch.randint(-64, 65, (B, Kd), generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-128, 128, (L, J, U, 2 * N), generator=g,
                          device=dev, dtype=torch.int8)
        acc = torch.randint(-2**31, 2**31, (B, UN), generator=g, device=dev,
                            dtype=torch.int32)
        w, wt = K.materialize_w(v), K.materialize_wt(v)
        pS = K.choose_split(lambda t: (UN // 128) * -(-B // t),
                            lambda t: pocc(L), sms, Kd // 32, tiles=(64,),
                            overhead=16)[1]
        pout = torch.empty_like(acc)

        def run_parent():
            rc = pfn(x.data_ptr(), w.data_ptr(), acc.data_ptr(),
                     pout.data_ptr(), B, Kd, UN, L, 0, pS,
                     torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"parent kernel: cudaError {rc}")
            return pout

        def run_new():
            return K.mm_recombine_acc_wt(x, wt, acc)

        want = K.mm_recombine_acc_wt_plain(x, wt, acc)
        cs.check(torch.equal(run_parent(), want), f"{label} B={B}: parent")
        cs.check(torch.equal(run_new(), want), f"{label} B={B}: new")
        reps = 10 if B >= 4096 else 50
        t = [cs.device_ms(f, reps) for f in (run_parent, run_new, run_new,
                                             run_parent)]
        steps = [cs.device_ms(f, reps) for f in (
            lambda: (K.materialize_w(v), run_parent()),
            lambda: (K.materialize_wt(v), run_new()),
            lambda: (K.materialize_wt(v), run_new()),
            lambda: (K.materialize_w(v), run_parent()))]
        bound, by = cs.bound_ms(x.numel() + wt.numel() + 8 * acc.numel(),
                                B * Kd * UN * L)
        row = {"case": label, "B": B, "K": Kd, "UN": UN, "L": L,
               "parent_split": pS, "plan": K.mm_recombine_acc_plan(
                   B, Kd, UN, sms),
               "parent_ms": [t[0], t[3]], "new_ms": [t[1], t[2]],
               "step_parent_ms": [steps[0], steps[3]],
               "step_new_ms": [steps[1], steps[2]],
               "bound_ms": bound, "bound_by": by, "card": smi}
        if splits and B < 4096:
            sweep = {}
            steps_k = -(-Kd // K.MM_BK)
            for S in sorted({K.split_plan(steps_k, s)[1]
                             for s in range(1, min(steps_k, 16) + 1)}):
                f = (lambda S=S: K.mm_recombine_acc_wt(x, wt, acc, split=S))
                cs.check(torch.equal(f(), want), f"B={B} split={S}")
                sweep[S] = cs.device_ms(f, reps)
            row["split_ms"] = sweep
        print(json.dumps(row), flush=True)
        del x, v, acc, w, wt, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
