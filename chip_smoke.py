#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tfhe_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

  1. device: the card's name and power limit (nvidia-smi), then the kernels'
     nvcc build (all sources in parallel) and its seconds;
  2. kernels: every CUDA kernel of the gate-bootstrap path on seeded inputs
     at the main path's shapes, required bit-identical (torch.equal) to its
     plain PyTorch version run on a CPU copy; its time (CUDA events), the
     plain version's time on the card, a one-call library yardstick where
     one exists, and its bound on an H100 SXM (the fused step at the main
     path's B=8192 and at B=1024); then the fused step's 64- and 128-row
     batch tiles, forced and as chosen, checked and timed over a sweep of
     batch sizes;
  3. main path: GATE_FAST2 (n=500, k=2, N=512) at B=8192 on the onthefly
     engine through CloudKey.generate / encrypt_bool / make_bootstrap_fn /
     decrypt_bool, one untimed launch, then a timed dependent chain of 2
     launches; every bit must decrypt, every CMux step must go through
     materialize_w + fused_cmux_step_v2 (500 of each per launch);
     gate_nand and gate_mux truth tables on a small batch;
  4. generic step: GATE_DEFAULT (N=1024, 4 key limbs, so the fused step is
     ineligible) at B=256: rotate_decompose + materialize_w +
     mm_recombine_acc, 630 of each per launch, decrypt-correct.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Exits non-zero, with no result,
when no CUDA device is present.  Imports nothing of JAX or of ``tfhe_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (dense): int8 tensor-core ops/s, HBM bytes/s
PEAK_INT8_OPS = 1.979e15
PEAK_BYTES = 3.35e12
PALLAS = "tfhe_tpu/ops/pallas_kernels.py"


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int, int8_macs: int = 0):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 2 * int8_macs / PEAK_INT8_OPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device():
    from tfhe_tpu_torch.ops import _build
    smi = nvidia_smi_line()
    print(smi)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    _build.build_all()
    print(f"phase 1 build: {len(_build.SIGNATURES)} kernels in "
          f"{_build.build_seconds:.1f} s")
    for path in sorted(_build.BUILD_DIR.glob("*.ptxas.txt")):
        for line in path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {path.name.split('-')[0]}: {line.strip()}")
    return smi


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _compare(name, got, want):
    got, want = got.cpu(), want.cpu()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: got {tuple(got.shape)} {got.dtype}, "
          f"want {tuple(want.shape)} {want.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(torch.equal(got, want), f"{name}: differs from its plain version "
          f"(max abs err {err})")
    return err


def _kernel_cases(seed: int = 0):
    """(name, shape, source, replaces, wrapper, plain, args, kwargs, bound,
    library-call); a kernel's first case is at the shape its path gives it."""
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import GATE_DEFAULT, GATE_FAST2
    r = np.random.default_rng(seed)
    cases = []

    def i8(shape, lo=-128, hi=128):
        return torch.from_numpy(r.integers(lo, hi, shape).astype(np.int8))

    def i32(shape):
        return torch.from_numpy(
            r.integers(-2**31, 2**31, shape).astype(np.int32))

    def expo(B, N):
        return torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))

    # materialize_w: GATE_FAST2's step key (L=3, J=9, U=3, 2N=1024)
    v = i8((3, 9, 3, 1024))
    N = 512
    out_bytes = 3 * 9 * N * 3 * N
    cases.append(("materialize_w", "v (3,9,3,1024)", "csrc/materialize_w.cu",
                  f"{PALLAS}:77", K.materialize_w, K.materialize_w_plain,
                  (v,), {}, bound_ms(v.numel() + out_bytes), None))

    # fused_cmux_step_v2: GATE_FAST2 (k=2, l=3, L=3, key_shift=8) at the
    # main path's B=8192, then at B=1024
    p = GATE_FAST2.tgsw
    kp1, l, L = 3, 3, 3
    for B in (8192, 1024):
        acc = i32((B, kp1, N))
        a = expo(B, N)
        w = i8((L, kp1 * l * N, kp1 * N))
        kw = dict(l=l, bgbit=p.bgbit, offset=p.offset, key_shift=8)
        macs = B * kp1 * l * N * kp1 * N * L
        wcat = w.permute(1, 0, 2).reshape(kp1 * l * N, L * kp1 * N)
        digits = i8((B, kp1 * l * N), -64, 64)
        cases.append(("fused_cmux_step_v2", f"GATE_FAST2 B={B}",
                      "csrc/fused_cmux_step.cu", f"{PALLAS}:503",
                      K.fused_cmux_step_v2, K.fused_cmux_step_v2_plain,
                      (a, acc, w), kw,
                      bound_ms(_nbytes(a, acc, w, acc), macs),
                      ("_int_mm", (digits, wcat))))

    # rotate_decompose + mm_recombine_acc: GATE_DEFAULT (N=1024, k=1, l=3,
    # L=4) at B=256
    p = GATE_DEFAULT.tgsw
    B, kp1, l, N, L = 256, 2, 3, 1024, 4
    acc = i32((B, kp1, N))
    a = expo(B, N)
    kw = dict(l=l, bgbit=p.bgbit, offset=p.offset)
    out_bytes = B * kp1 * l * N
    cases.append(("rotate_decompose", "GATE_DEFAULT B=256",
                  "csrc/rotate_decompose.cu",
                  f"{PALLAS}:163", K.rotate_decompose,
                  K.rotate_decompose_plain, (a, acc), kw,
                  bound_ms(_nbytes(a, acc) + out_bytes), None))
    x = i8((B, kp1 * l * N), -64, 64)
    w = i8((L, kp1 * l * N, kp1 * N))
    macs = B * kp1 * l * N * kp1 * N * L
    wcat = w.permute(1, 0, 2).reshape(kp1 * l * N, L * kp1 * N)
    cases.append(("mm_recombine_acc", "GATE_DEFAULT B=256",
                  "csrc/mm_recombine_acc.cu",
                  f"{PALLAS}:1535", K.mm_recombine_acc,
                  K.mm_recombine_acc_plain, (x, w, acc), {"shift_base": 0},
                  bound_ms(_nbytes(x, w, acc, acc), macs),
                  ("_int_mm", (x, wcat))))
    return cases


def phase_kernels(reps: int = 20):
    """One JSON entry per kernel, from its first case; the numbers of its
    other cases go under the entry's "other_shapes"."""
    results = {}
    for (name, shape, src, replaces, wrapper, plain, args, kw, (bnd, by),
         lib) in _kernel_cases():
        dev_args = tuple(t.cuda() for t in args)
        got = wrapper(*dev_args, **kw)
        torch.cuda.synchronize()
        want = plain(*args, **kw)
        err = _compare(name, got, want)
        if name == "fused_cmux_step_v2":      # the flat (B, (k+1)N) layout
            a, acc, w = dev_args
            flat = wrapper(a, acc.reshape(acc.shape[0], -1), w, kp1=acc.shape[1],
                           **kw)
            _compare(name + " (flat)", flat, want.reshape(flat.shape))
        ms = cuda_ms(lambda: wrapper(*dev_args, **kw), reps)
        plain_ms = cuda_ms(lambda: plain(*dev_args, **kw), 3, warmup=1)
        library_ms = None
        if lib is not None:
            x, wcat = (t.cuda().contiguous() for t in lib[1])
            library_ms = cuda_ms(lambda: torch._int_mm(x, wcat), reps)
        numbers = {"shape": shape, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                   "library_ms": library_ms}
        if name in results:
            results[name].setdefault("other_shapes", []).append(numbers)
        else:
            results[name] = {"name": name, "route": "cuda",
                             "source": f"tfhe_tpu_torch/ops/{src}",
                             "replaces": replaces, **numbers}
        lib_txt = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"phase 2 kernel {name} at {shape}: bit-identical to plain, "
              f"{ms:.4f} ms (bound {bnd:.4f} ms by {by}, "
              f"{bnd / ms:.1%} of it), plain {plain_ms:.4f} ms, "
              f"library {lib_txt}")
    return results


def phase_tiles(entry, batches=(100, 256, 512, 704, 768, 1024, 8192),
                reps: int = 10):
    """The fused step's two batch tiles, each forced and as chosen, at
    GATE_FAST2 shapes: each held bit-identical to the plain version (run on
    the card; its float64 sums are exact) and timed.  Adds "tiles" to the
    fused kernel's entry."""
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import GATE_FAST2
    p = GATE_FAST2.tgsw
    kp1, N, L = 3, 512, 3
    r = np.random.default_rng(3)
    w = torch.from_numpy(r.integers(-128, 128, (L, kp1 * p.l * N, kp1 * N))
                         .astype(np.int8)).cuda()
    kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset, key_shift=8)
    rows = []
    for B in batches:
        acc = torch.from_numpy(r.integers(-2**31, 2**31, (B, kp1, N))
                               .astype(np.int32)).cuda()
        a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32)).cuda()
        want = K.fused_cmux_step_v2_plain(a, acc, w, **kw)
        row = {"B": B}
        for tile, key in ((64, "ms_64"), (128, "ms_128"), (0, "ms_chosen")):
            def step():
                return K.fused_cmux_step_v2(a, acc, w, tile_rows=tile, **kw)
            _compare(f"fused_cmux_step_v2 B={B} tile_rows={tile}", step(), want)
            row[key] = cuda_ms(step, reps)
        rows.append(row)
        print(f"phase 2 tiles fused_cmux_step_v2 B={B}: 64-row "
              f"{row['ms_64']:.4f} ms, 128-row {row['ms_128']:.4f} ms, "
              f"chosen {row['ms_chosen']:.4f} ms, all bit-identical to plain")
    entry["tiles"] = rows


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------

def _keys(params, backend, seed=0):
    from tfhe_tpu_torch.boot import gate
    from tfhe_tpu_torch.rng import TfheRng
    rng = TfheRng(seed)
    sk = gate.SecretKey.generate(params, rng)
    t0 = time.perf_counter()
    ck = gate.CloudKey.generate(sk, rng, backend=backend)
    return rng, sk, ck, time.perf_counter() - t0


def _launch_counts():
    from tfhe_tpu_torch.ops import kernels as K
    return {k.__name__: k.launches for k in K.KERNELS}


def phase_main(smi: str, batch: int = 8192, chain: int = 2):
    from tfhe_tpu_torch.boot import gate
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import GATE_FAST2
    P, n = GATE_FAST2, GATE_FAST2.lwe.n
    rng, sk, ck, keygen_s = _keys(P, "onthefly")
    bits = np.random.default_rng(1).integers(0, 2, batch)
    ct = gate.encrypt_bool(sk, bits, rng)
    boot = gate.make_bootstrap_fn(P, backend="onthefly")
    boot(ck.data, ct)                   # untimed: first-use set-up
    torch.cuda.synchronize()

    K.reset_launches()
    t0 = time.perf_counter()
    out = ct
    for _ in range(chain):              # dependent launches, one sync
        out = boot(ck.data, out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    ok = gate.decrypt_bool(sk, out) == bits.astype(bool)
    check(ok.all(), f"GATE_FAST2: {int((~ok).sum())} of {batch} bits wrong")
    for name in ("materialize_w", "fused_cmux_step_v2"):
        check(counts[name] == n * chain,
              f"GATE_FAST2: {name} launched {counts[name]} times, "
              f"want {n * chain}")
    for name in ("rotate_decompose", "mm_recombine_acc"):
        check(counts[name] == 0, f"GATE_FAST2: {name} launched on the "
              f"fused path")
    rate = batch * chain / wall
    print(f"phase 3 GATE_FAST2 onthefly B={batch}: {rate:.1f} ct/s "
          f"({wall:.3f} s for {chain} dependent launches), all "
          f"{batch} bits decrypt, launches {counts}, keygen {keygen_s:.1f} s "
          f"[{smi}]")

    # where one launch's time goes, from CUDA events at this batch
    from tfhe_tpu_torch import lwe, torus as T
    v0 = ck.data["bk"]["v"][0]
    w0 = K.materialize_w(v0)
    acc = torch.zeros((batch, 3, 512), dtype=torch.int32, device="cuda")
    acc.random_(-2**31, 2**31 - 1)
    a0 = T.mod_switch_from_torus32(ct[:, 0].contiguous(), 1024)
    p = P.tgsw
    step_ms = cuda_ms(lambda: K.fused_cmux_step_v2(
        a0, acc, w0, l=p.l, bgbit=p.bgbit, offset=p.offset, key_shift=8), 5)
    mat_ms = cuda_ms(lambda: K.materialize_w(v0), 20)
    u = torch.zeros((batch, 2 * 512 + 1), dtype=torch.int32, device="cuda")
    ksk = lwe.KeySwitchKey(P.ks, 1024, n, ck.data["ksw"])
    ks_ms = cuda_ms(lambda: lwe.keyswitch(u, ksk), 3)
    print(f"phase 3 breakdown B={batch}: fused step {step_ms:.3f} ms x {n}, "
          f"materialize_w {mat_ms:.4f} ms x {n}, keyswitch {ks_ms:.3f} ms; "
          f"sum {(step_ms + mat_ms) * n + ks_ms:.1f} ms vs "
          f"{wall / chain * 1e3:.1f} ms per launch")

    # gate truth tables on a small batch
    xs = np.array([0, 0, 1, 1, 0, 0, 1, 1])
    ys = np.array([0, 1, 0, 1, 0, 1, 0, 1])
    cs = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    cx, cy, cc = (gate.encrypt_bool(sk, b, rng) for b in (xs, ys, cs))
    nand = gate.decrypt_bool(sk, gate.gate_nand(ck.data, cx, cy, P,
                                                "onthefly"))
    check((nand == ~(xs & ys).astype(bool)).all(), "gate_nand truth table")
    mux = gate.decrypt_bool(sk, gate.gate_mux(ck.data, cc, cx, cy, P,
                                              "onthefly"))
    check((mux == np.where(cs, xs, ys).astype(bool)).all(),
          "gate_mux truth table")
    print("phase 3 gates: gate_nand and gate_mux truth tables decrypt "
          "correctly")
    return counts, {"ct_per_s": rate, "step_ms": step_ms}


def phase_generic(smi: str, batch: int = 256):
    from tfhe_tpu_torch.boot import gate
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import GATE_DEFAULT
    P, n = GATE_DEFAULT, GATE_DEFAULT.lwe.n
    rng, sk, ck, keygen_s = _keys(P, "onthefly")
    bits = np.random.default_rng(2).integers(0, 2, batch)
    ct = gate.encrypt_bool(sk, bits, rng)
    boot = gate.make_bootstrap_fn(P, backend="onthefly")
    boot(ck.data, ct)                   # untimed: first-use set-up
    torch.cuda.synchronize()

    K.reset_launches()
    t0 = time.perf_counter()
    out = boot(ck.data, ct)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    ok = gate.decrypt_bool(sk, out) == bits.astype(bool)
    check(ok.all(), f"GATE_DEFAULT: {int((~ok).sum())} of {batch} bits wrong")
    for name in ("rotate_decompose", "materialize_w", "mm_recombine_acc"):
        check(counts[name] == n, f"GATE_DEFAULT: {name} launched "
              f"{counts[name]} times, want {n}")
    check(counts["fused_cmux_step_v2"] == 0,
          "GATE_DEFAULT: the fused step ran with 4 key limbs")
    print(f"phase 4 GATE_DEFAULT onthefly B={batch}: "
          f"{batch / wall:.1f} ct/s ({wall:.3f} s for one launch), all "
          f"{batch} bits decrypt, launches {counts}, keygen {keygen_s:.1f} s "
          f"[{smi}]")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_device()
    results = phase_kernels()
    phase_tiles(results["fused_cmux_step_v2"])
    main_counts, _ = phase_main(smi)
    generic_counts = phase_generic(smi)
    for name, entry in results.items():
        entry["launches"] = main_counts[name] + generic_counts[name]
        entry["launches_by_path"] = {"gate_fast2": main_counts[name],
                                     "gate_default": generic_counts[name]}
        check(entry["launches"] > 0, f"{name} never launched on a path")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
