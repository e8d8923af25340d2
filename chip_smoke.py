#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tfhe_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

  1. device: the card's name and power limit (nvidia-smi), then the kernels'
     nvcc build (all sources in parallel) and its seconds;
  2. kernels: the launch floor (an empty kernel back to back, in device
     time), then every CUDA kernel on seeded inputs at the shapes its paths
     give it, required bit-identical (torch.equal) to its plain PyTorch
     version run on a CPU copy (or on the card, where the host would take
     too long); its device time (device_ms: the host's enqueue hidden
     behind a stalled stream; for the digit emitters also torch.profiler's
     kernel time) beside its call time (CUDA events around back-to-back
     wrapper calls, which time the host for kernels faster than the
     wrapper), the plain version's time on the card, the device time of a
     library yardstick where one exists (torch._int_mm of the same int8
     product; for materialize_w and materialize_wt torch.flip of the
     vector's windows, flip_w and flip_wt), and its bound on an H100 SXM:
     materialize_w (GATE_DEFAULT's key, the one a path runs, and
     GATE_FAST2's) and its K-packed entry materialize_wt (GATE_FAST2's,
     GATE_MXU's and CB_MXU lvl2's, the conv circuit path's keys), the
     fused step (wgmma + TMA on the K-packed key) at GATE_FAST2 B=8192 and
     B=1024 and GATE_MXU B=8192, the v1 fused step at GATE_FAST2 and
     GATE_MXU B=8192 (also equal to v2's kernel), the 64-bit kernels (and
     the fused-epilogue pair, the limb-grid contraction and the plain-layout
     digits, which re-laid out must equal the chunk-layout kernel's) at
     CB_MXU and CB_ACTIVE B=256, the four 64-bit contractions on the
     K-packed key wmt with their chosen plans, ck_dot64p and ck_dot64p_sacc
     also at CB_MXU tails B=1, 3, 100,
     rotate_decompose64_ck also at CB_MXU B=1, 3, 100,
     the one-kernel 64-bit step there and at CB_MXU tails B=1, 3, 100
     (beside the two-kernel default and acc steps it replaces),
     ck_cmux_step32 at GATE_MXU B=8192, GATE_DEFAULT B=256, GATE_MXU
     B=256 and 512 (the adder's narrow launches) and tail batches B=1, 3,
     100, with the flat carry; the two kernels whose reduction is split over
     blocks (mm_recombine_acc, ck_cmux_step32) also with split=1 forced,
     equal to the chosen (tile_rows, S) plan; then the fused step's 64-
     and 128-column plans, forced and as chosen, over a sweep of batches,
     the parts of one fused step (key loads, digit build, wgmmas: stripped
     builds of its kernel) at GATE_FAST2 B=8192, and the split kernels
     over forced (tile_rows, S) plans;
  3. main path: GATE_FAST2 (n=500, k=2, N=512) at B=8192 on the onthefly
     engine through CloudKey.generate / encrypt_bool / make_bootstrap_fn /
     decrypt_bool, one untimed launch, then a timed dependent chain of 2
     launches; every bit must decrypt, every CMux step must go through
     materialize_wt + fused_cmux_step_v2 (500 of each per launch) and no
     other CMux kernel;
     gate_nand and gate_mux truth tables on a small batch;
  4. generic step: GATE_DEFAULT (N=1024, 4 key limbs, so the fused step is
     ineligible) at B=256: rotate_decompose + materialize_w +
     mm_recombine_acc, 630 of each per launch, decrypt-correct; each
     kernel's device time and share of a step and of the launch;
  5. circuit bootstrap: CB_MXU (n0=500, N1=1024, N2=2048 Torus64, lvl2
     Bg=2^8/l=5, 6-limb bk) at B=256 on the chunked engine through
     CircuitCloudKey.generate (seconds per keygen.circuit.* span) /
     make_circuit_bootstrap_staged, one untimed launch, then a timed one;
     every step must go through rotate_decompose64_ck + ck_dot64p (1,000 of
     each per launch: two 500-step rotations) on the prepared K-packed key
     wmt (the key holds no wm, and no call transposes one) and no 32-bit
     kernel; every
     TRGSW row phase, a CMux driven by each TRGSW and a 4-bit LUT over 64
     instances (lut.eval_lut_batch) must be right; then where one launch's
     time goes (CUDA events; the digit emitters' and steps' device time and
     the emitter's share of a step) and the peak device memory, read two
     ways:
     from before keygen to after the launches (the whole run, keygen's
     transients included) and of the two launches alone, beside the
     resident keys;
  5b. the same launch with TFHE_CK64_PATH=acc on phase 5's keys: TRGSWs
     bit-identical to phase 5's, 1,000 rotate_decompose64_ck_flat + 1,000
     ck_dot64p_acc launches and no other CMux kernel, the key still wmt
     alone;
  5c. the same with TFHE_CK64_PATH=sacc: 1,000 rotate_decompose64_ck_flat +
     1,000 ck_dot64p_sacc launches and no other CMux kernel;
  5d. the same with TFHE_CK64_FUSED=1: 1,000 ck_cmux_step64 launches and no
     other CMux kernel;
  6. the N=1024 gate path: GATE_MXU (n=630, k=1, N=1024, 3 key limbs) at
     B=8192 on the chunked engine (630 ck_cmux_step32 per launch and no
     other CMux kernel) and, from the same seed, on the onthefly engine
     (materialize_wt + fused_cmux_step_v2), each one untimed launch and a
     timed chain of 2, every bit decrypted and the two chains' ciphertexts
     equal bit for bit; then GATE_DEFAULT chunked at B=256, equal to phase
     4's onthefly ciphertexts; ct/s, per-step breakdown, keygen seconds and
     peak memory of each;
  7. circuits: a 32-bit ripple-carry adder and a 32-bit comparator, each
     over 256 instances, through runtime.scheduler.evaluate on the GATE_MXU
     chunked keys; every sum and comparison must decode right;
  8. engines: conv, conv_bf16, nussbaumer, fft_f64 and fft_dd at
     GATE_DEFAULT's engine config (N=1024, 32 bits, J=6, U=2, 4 limbs) and
     conv and nussbaumer at CB_MXU lvl2's (N=2048, Torus64, J=10, U=2, 6
     limbs), B=256, from one seed: the exact ones bit for bit against
     onthefly (32 bits) and chunked (64 bits), nussbaumer on keys it is
     exact on, fft_f64 within 2^4 and fft_dd within 2^8; each one
     accumulate's device ms (call ms for nussbaumer and fft_dd, whose
     hundreds of kernels a call overflow the launch queue) and launches of
     materialize_w, materialize_wt and mm_recombine_acc;
  9. engine paths: GATE_DEFAULT B=256 from phase 4's seed on conv (every
     ciphertext equal to phase 4's onthefly ones; 630 rotate_decompose,
     materialize_w and mm_recombine_acc a launch), on nussbaumer and on
     fft_f64 (every bit decrypts, the gate_nand truth table holds); the
     CB_MXU circuit bootstrap B=256 on conv, JAX's default backend, its key
     prepared from phase 5's raw TRGSWs (every TRGSW equal to phase 5's
     chunked ones; 1,000 materialize_wt a launch); ct/s and ms per
     ciphertext.

The line before the last is a JSON object with one entry per kernel (the
two test-only kernels, fused_cmux_step v1 and rotate_decompose64, run on no
path, as in the JAX package, and count 0 launches); the last line is {"ok": true, "device": {...}}.  Exits non-zero, with no result,
when no CUDA device is present.  Imports nothing of JAX or of ``tfhe_tpu``.
"""

from __future__ import annotations

import functools
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
CB_M = 64                  # the chunk width of the 64-bit path (ChunkedEngine)


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


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms() -> float:
    """Cycles of torch.cuda._sleep per millisecond on this card, from CUDA
    events around one long sleep (measured once)."""
    cycles = 20_000_000
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def device_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over ``reps`` back-to-back calls,
    with the host's enqueue hidden: the stream is first stalled by
    torch.cuda._sleep for longer than the host takes to enqueue all reps
    calls (sized from a host clock of one enqueue), so that the start event
    fires after the calls are queued and the events time the card's work
    alone.  A stall the enqueue outlasted is lengthened and the run
    repeated."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    one = time.perf_counter() - t0
    torch.cuda.synchronize()
    stall_ms = 2 * reps * one * 1e3 + 0.2
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(stall_ms * _sleep_cycles_per_ms()))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if enqueue_ms < 0.8 * stall_ms:
            return start.elapsed_time(end) / reps
        stall_ms = 4 * enqueue_ms + 0.2
    raise SmokeFailure(f"device_ms: the host's enqueue ({enqueue_ms:.3f} ms) "
                       f"outlasted every stall")


@functools.lru_cache(maxsize=None)
def launch_floor_ms(reps: int = 50) -> float:
    """Device milliseconds of one empty kernel (torch.cuda._sleep(0), one
    thread) launched back to back, timed by device_ms (measured once): no
    standalone kernel takes less on this card."""
    return device_ms(lambda: torch.cuda._sleep(0), reps)


def profiler_ms(fn, name_part: str, reps: int = 20):
    """Mean device milliseconds of the kernels whose name contains
    ``name_part`` over ``reps`` calls of fn(), from torch.profiler; None
    where the profiler records no device time for them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if name_part in ev.key:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            total_us += us
            count += ev.count
    return total_us / count / 1e3 if count and total_us > 0 else None


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
    print(f"phase 1 build: {len(_build.SOURCES)} sources in "
          f"{_build.build_seconds:.1f} s")
    for path in sorted(_build.BUILD_DIR.glob("*.ptxas.txt")):
        for line in path.read_text().splitlines():
            # registers and spills of every kernel, and any wgmma that
            # ptxas serialized (C7510)
            if "Used" in line or "spill" in line or "wgmma" in line:
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
    library-call, plain-on-card); a kernel's first case is at the shape its
    path gives it.  The plain version runs on a CPU copy of the inputs, or
    on the card where plain-on-card is set (its float64 sums are exact
    there too; the 64-bit contractions and the B=8192 chunked step are too
    slow on the host)."""
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import (CB_ACTIVE, CB_MXU, GATE_DEFAULT,
                                       GATE_FAST2, GATE_MXU)
    r = np.random.default_rng(seed)
    cases = []

    def i8(shape, lo=-128, hi=128):
        return torch.from_numpy(r.integers(lo, hi, shape).astype(np.int8))

    def i32(shape):
        return torch.from_numpy(
            r.integers(-2**31, 2**31, shape).astype(np.int32))

    def expo(B, N):
        return torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))

    # materialize_w: GATE_DEFAULT's step key (L=4, J=6, U=2, 2N=2048), the
    # one a path runs (GATE_DEFAULT onthefly and conv), then GATE_FAST2's
    # (L=3, J=9, U=3, 2N=1024); materialize_wt, the K-packed entry:
    # GATE_FAST2's key, then GATE_MXU's (L=3, J=6, U=2, 2N=2048) and CB_MXU
    # lvl2's (L=6, J=10, U=2, 2N=4096: the conv circuit path).  Library:
    # torch.flip of the rotated vector's windows (flip_w, flip_wt)
    v_fast2 = i8((3, 9, 3, 1024))
    for name, wrapper, plain, lib, keys in (
            ("materialize_w", K.materialize_w, K.materialize_w_plain,
             "flip_w", (i8((4, 6, 2, 2048)), v_fast2)),
            ("materialize_wt", K.materialize_wt, K.materialize_wt_plain,
             "flip_wt", (v_fast2, i8((3, 6, 2, 2048)),
                         i8((6, 10, 2, 4096))))):
        for v in keys:
            L, J, U, twoN = v.shape
            out_bytes = L * J * U * (twoN // 2) ** 2
            cases.append((name, f"v {tuple(v.shape)}", "csrc/materialize_w.cu",
                          f"{PALLAS}:77", wrapper, plain, (v,), {},
                          bound_ms(v.numel() + out_bytes), (lib, (v,)),
                          False))

    # fused_cmux_step_v2 on the K-packed key: GATE_FAST2 (k=2, l=3, L=3,
    # key_shift=8) at the main path's B=8192, then at B=1024, then GATE_MXU
    # (k=1, N=1024) at the onthefly N=1024 path's B=8192
    for label, p, kp1, N, B in (("GATE_FAST2", GATE_FAST2.tgsw, 3, 512, 8192),
                                ("GATE_FAST2", GATE_FAST2.tgsw, 3, 512, 1024),
                                ("GATE_MXU", GATE_MXU.tgsw, 2, 1024, 8192)):
        l, L = 3, 3
        acc = i32((B, kp1, N))
        a = expo(B, N)
        wt = i8((L, kp1 * N, kp1 * l * N))
        kw = dict(l=l, bgbit=p.bgbit, offset=p.offset, key_shift=8)
        macs = B * kp1 * l * N * kp1 * N * L
        wcat = wt.permute(2, 0, 1).reshape(kp1 * l * N, L * kp1 * N)
        digits = i8((B, kp1 * l * N), -64, 64)
        cases.append(("fused_cmux_step_v2", f"{label} B={B}",
                      "csrc/fused_cmux_step.cu", f"{PALLAS}:503",
                      K.fused_cmux_step_v2, K.fused_cmux_step_v2_plain,
                      (a, acc, wt), kw,
                      bound_ms(_nbytes(a, acc, wt, acc), macs),
                      ("_int_mm", (digits, wcat)), N == 1024))

    # fused_cmux_step (v1): v2's function with the v1 schedule, at
    # GATE_FAST2 (k=2, N=512) and GATE_MXU (k=1, N=1024), B=8192
    for label, p, kp1, N in (("GATE_FAST2", GATE_FAST2.tgsw, 3, 512),
                             ("GATE_MXU", GATE_MXU.tgsw, 2, 1024)):
        B, l, L = 8192, 3, 3
        acc = i32((B, kp1, N))
        a = expo(B, N)
        w = i8((L, kp1 * l * N, kp1 * N))
        kw = dict(l=l, bgbit=p.bgbit, offset=p.offset, key_shift=8)
        macs = B * kp1 * l * N * kp1 * N * L
        wcat = w.permute(1, 0, 2).reshape(kp1 * l * N, L * kp1 * N)
        digits = i8((B, kp1 * l * N), -64, 64)
        cases.append(("fused_cmux_step", f"{label} B={B}",
                      "csrc/fused_cmux_step_v1.cu", f"{PALLAS}:338",
                      K.fused_cmux_step, K.fused_cmux_step_plain,
                      (a, acc, w), kw,
                      bound_ms(_nbytes(a, acc, w, acc), macs),
                      ("_int_mm", (digits, wcat)), True))

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
                  bound_ms(_nbytes(a, acc) + out_bytes), None, False))
    x = i8((B, kp1 * l * N), -64, 64)
    w = i8((L, kp1 * l * N, kp1 * N))
    macs = B * kp1 * l * N * kp1 * N * L
    wcat = w.permute(1, 0, 2).reshape(kp1 * l * N, L * kp1 * N)
    cases.append(("mm_recombine_acc", "GATE_DEFAULT B=256",
                  "csrc/mm_recombine_acc.cu",
                  f"{PALLAS}:1535", K.mm_recombine_acc,
                  K.mm_recombine_acc_plain, (x, w, acc), {"shift_base": 0},
                  bound_ms(_nbytes(x, w, acc, acc), macs),
                  ("_int_mm", (x, wcat)), False))

    # rotate_decompose64_ck + ck_dot64p: the circuit bootstrap's lvl2 step at
    # B=256, CB_MXU (l=5, Bg=2^8: one plane, 6 key limbs) then a
    # CB_ACTIVE-shaped case (l=4, Bg=2^9: two planes, 8 key limbs); the 64-bit
    # contractions read the K-packed key wmt (UL, N+m, J*m), as
    # ChunkedEngine.prepare builds it
    B, kp1, N, m = 256, 2, 2048, CB_M
    C = N // m
    for label, p, L in (("CB_MXU", CB_MXU.tgsw_lvl2, 6),
                        ("CB_ACTIVE", CB_ACTIVE.tgsw_lvl2, 8)):
        P = 1 if p.bgbit <= 8 else 2
        Jm = kp1 * p.l * m
        acc = torch.from_numpy(r.integers(-2**63, 2**63, (B, kp1, N),
                                          dtype=np.int64))
        a = expo(B, N)
        kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset, planes=P)
        cases.append(("rotate_decompose64", f"{label} B={B}",
                      "csrc/rotate_decompose64_ck.cu", f"{PALLAS}:644",
                      K.rotate_decompose64, K.rotate_decompose64_plain,
                      (a, acc), kw,
                      bound_ms(_nbytes(a, acc) + B * kp1 * p.l * P * N),
                      None, False))
        kw = dict(kw, m=m)
        out_bytes = B * C * P * K.ck_width(Jm)
        cases.append(("rotate_decompose64_ck", f"{label} B={B}",
                      "csrc/rotate_decompose64_ck.cu", f"{PALLAS}:740",
                      K.rotate_decompose64_ck, K.rotate_decompose64_ck_plain,
                      (a, acc), kw, bound_ms(_nbytes(a, acc) + out_bytes),
                      None, False))
        lo, hi = (-128, 128) if P == 1 else (-64, 65)
        x = i8((B, C * P * K.ck_width(Jm)), lo, hi)
        wmt = i8((kp1 * L, N + m, Jm))
        UL = kp1 * L
        # the product's essential MACs: every folded output sums J*N terms
        macs = P * B * UL * N * (Jm // m) * N
        out_bytes = UL * B * N * 4
        wcat = _wcat(wmt)
        cases.append(("ck_dot64p", f"{label} B={B}", "csrc/ck_dot64p.cu",
                      f"{PALLAS}:835", K.ck_dot64p, K.ck_dot64p_plain,
                      (x, wmt), dict(N=N, m=m, planes=P),
                      bound_ms(_nbytes(x, wmt) + out_bytes, macs),
                      ("_int_mm", (x.reshape(B * C * P, Jm), wcat)), True))
        # the fused-epilogue step's two kernels on the same shapes
        acc_flat = acc.reshape(B, kp1 * N)
        cases.append(("rotate_decompose64_ck_flat", f"{label} B={B}",
                      "csrc/rotate_decompose64_ck.cu", f"{PALLAS}:782",
                      K.rotate_decompose64_ck_flat,
                      K.rotate_decompose64_ck_flat_plain, (a, acc_flat),
                      dict(kw, N=N), bound_ms(_nbytes(a, acc) + B * C * P
                                              * K.ck_width(Jm)),
                      None, False))
        for name, wrapper, line in (
                ("ck_dot64p_acc", K.ck_dot64p_acc, 1006),
                ("ck_dot64p_sacc", K.ck_dot64p_sacc, 966)):
            cases.append((name, f"{label} B={B}", f"csrc/{name}.cu",
                          f"{PALLAS}:{line}", wrapper, K.ck_dot64p_acc_plain,
                          (x, wmt, acc_flat),
                          dict(N=N, m=m, planes=P, kp1=kp1,
                               key_shift=64 - 8 * L),
                          bound_ms(_nbytes(x, wmt, acc, acc), macs),
                          ("_int_mm", (x.reshape(B * C * P, Jm), wcat)),
                          True))

    # ck_dot64p and ck_dot64p_sacc at CB_MXU tail batches (the default and
    # sacc steps' narrow launches)
    p, L = CB_MXU.tgsw_lvl2, 6
    Jm, UL = kp1 * p.l * m, kp1 * L
    wmt = i8((UL, N + m, Jm))
    for B in (1, 3, 100):
        acc = torch.from_numpy(r.integers(-2**63, 2**63, (B, kp1, N),
                                          dtype=np.int64))
        a = expo(B, N)
        cases.append(("rotate_decompose64_ck", f"CB_MXU B={B}",
                      "csrc/rotate_decompose64_ck.cu", f"{PALLAS}:740",
                      K.rotate_decompose64_ck, K.rotate_decompose64_ck_plain,
                      (a, acc), dict(l=p.l, bgbit=p.bgbit, offset=p.offset,
                                     planes=1, m=m),
                      bound_ms(_nbytes(a, acc) + B * C * K.ck_width(Jm)),
                      None, False))
        x = i8((B, C * K.ck_width(Jm)))
        acc_flat = torch.from_numpy(r.integers(-2**63, 2**63, (B, kp1 * N),
                                               dtype=np.int64))
        macs = B * UL * N * (Jm // m) * N
        lib = (("_int_mm", (x.reshape(B * C, Jm), _wcat(wmt)))
               if B * C > 16 else None)
        cases.append(("ck_dot64p", f"CB_MXU B={B}", "csrc/ck_dot64p.cu",
                      f"{PALLAS}:835", K.ck_dot64p, K.ck_dot64p_plain,
                      (x, wmt), dict(N=N, m=m, planes=1),
                      bound_ms(_nbytes(x, wmt) + UL * B * N * 4, macs), lib,
                      True))
        cases.append(("ck_dot64p_sacc", f"CB_MXU B={B}",
                      "csrc/ck_dot64p_sacc.cu", f"{PALLAS}:966",
                      K.ck_dot64p_sacc, K.ck_dot64p_acc_plain,
                      (x, wmt, acc_flat),
                      dict(N=N, m=m, planes=1, kp1=kp1, key_shift=64 - 8 * L),
                      bound_ms(_nbytes(x, wmt, acc_flat, acc_flat), macs),
                      lib, True))

    # ck_cmux_step64: the whole 64-bit step on the flat accumulator at
    # CB_MXU and CB_ACTIVE B=256, then CB_MXU tail batches
    for label, p, L, B in (("CB_MXU", CB_MXU.tgsw_lvl2, 6, 256),
                           ("CB_ACTIVE", CB_ACTIVE.tgsw_lvl2, 8, 256),
                           ("CB_MXU", CB_MXU.tgsw_lvl2, 6, 1),
                           ("CB_MXU", CB_MXU.tgsw_lvl2, 6, 3),
                           ("CB_MXU", CB_MXU.tgsw_lvl2, 6, 100)):
        P = 1 if p.bgbit <= 8 else 2
        Jm = kp1 * p.l * m
        acc_flat = torch.from_numpy(r.integers(-2**63, 2**63, (B, kp1 * N),
                                               dtype=np.int64))
        a = expo(B, N)
        wmt = i8((kp1 * L, N + m, Jm))
        kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset, m=m, planes=P,
                  kp1=kp1, key_shift=64 - 8 * L)
        macs = P * B * kp1 * L * N * (Jm // m) * N
        lo, hi = (-128, 128) if P == 1 else (-64, 65)
        digits = i8((B * C * P, Jm), lo, hi)
        cases.append(("ck_cmux_step64", f"{label} B={B}",
                      "csrc/ck_cmux_step64.cu", f"{PALLAS}:1450",
                      K.ck_cmux_step64, K.ck_cmux_step64_plain,
                      (a, acc_flat, wmt), kw,
                      bound_ms(_nbytes(a, acc_flat, wmt, acc_flat), macs),
                      ("_int_mm", (digits, _wcat(wmt))), True))

    # ck_cmux_step32: GATE_MXU (k=1, N=1024, l=3, 3 key limbs, m=128) at the
    # N=1024 path's B=8192, GATE_DEFAULT (4 key limbs) at B=256, the
    # adder's narrow launches (GATE_MXU B=256 and 512), then tail batches
    # that fill no row tile
    kp1, l, N, m = 2, 3, 1024, 128
    C, Jm = N // m, kp1 * l * m
    for label, p, L, B in (("GATE_MXU", GATE_MXU.tgsw, 3, 8192),
                           ("GATE_DEFAULT", GATE_DEFAULT.tgsw, 4, 256),
                           ("GATE_MXU", GATE_MXU.tgsw, 3, 256),
                           ("GATE_MXU", GATE_MXU.tgsw, 3, 512),
                           ("GATE_MXU", GATE_MXU.tgsw, 3, 1),
                           ("GATE_MXU", GATE_MXU.tgsw, 3, 3),
                           ("GATE_MXU", GATE_MXU.tgsw, 3, 100)):
        acc = i32((B, kp1, N))
        a = expo(B, N)
        wm = i8((kp1 * L, Jm, N + m))
        kw = dict(l=l, bgbit=p.bgbit, offset=p.offset, m=m,
                  key_shift=32 - 8 * L)
        macs = B * kp1 * N * (Jm // m) * N * L
        digits = i8((B * C, Jm), -64, 64)
        wcat = wm.permute(1, 0, 2).reshape(Jm, kp1 * L * (N + m))
        cases.append(("ck_cmux_step32", f"{label} B={B}",
                      "csrc/ck_cmux_step32.cu", f"{PALLAS}:1186",
                      K.ck_cmux_step32, K.ck_cmux_step32_plain,
                      (a, acc, wm), kw,
                      bound_ms(_nbytes(a, acc, wm, acc), macs),
                      ("_int_mm", (digits, wcat)) if B * C > 16 else None,
                      B == 8192))
    return cases


def flip_w(v):
    """materialize_w's function as library calls (the yardstick of its row
    in the kernel table; no path calls it): row (l, j, t) of block u is the
    window x[N - t .. 2N - t) of x = v rolled by N, so the windows of x,
    flipped over t, are W."""
    L, J, U, twoN = v.shape
    N = twoN // 2
    h = torch.roll(v, N, -1).unfold(-1, N, 1)[..., 1:, :]   # (L,J,U,N,N)
    return torch.flip(h.permute(0, 1, 3, 2, 4), [2]).reshape(L, J * N, U * N)


def flip_wt(v):
    """materialize_wt's function as library calls: flip_w's windows laid
    out K-packed, flipped over t."""
    L, J, U, twoN = v.shape
    N = twoN // 2
    h = torch.roll(v, N, -1).unfold(-1, N, 1)[..., 1:, :]
    return torch.flip(h.permute(0, 2, 4, 1, 3), [-1]).reshape(L, U * N, J * N)


# the library yardsticks of phase 2's cases, by name
LIBRARY = {"_int_mm": torch._int_mm, "flip_w": flip_w, "flip_wt": flip_wt}


def _wcat(wmt):
    """The K-packed chunked key as one (J*m, U*L*(N+m)) int8 matrix: the
    library yardstick's operand (one torch._int_mm of every chunk's digits
    against every limb's shifted copies)."""
    UL, Npm, Jm = wmt.shape
    return wmt.permute(2, 0, 1).reshape(Jm, UL * Npm)


def phase_kernels(reps: int = 20):
    """One JSON entry per kernel, from its first case; the numbers of its
    other cases go under the entry's "other_shapes"."""
    from tfhe_tpu_torch.ops import kernels as K
    results = {}
    print(f"phase 2 launch floor: an empty kernel back to back takes "
          f"{launch_floor_ms():.4f} ms of device time")
    for (name, shape, src, replaces, wrapper, plain, args, kw, (bnd, by),
         lib, plain_on_card) in _kernel_cases():
        dev_args = tuple(t.cuda() for t in args)
        got = wrapper(*dev_args, **kw)
        torch.cuda.synchronize()
        want = plain(*(dev_args if plain_on_card else args), **kw)
        err = _compare(name, got, want)
        if name in ("fused_cmux_step_v2", "ck_cmux_step32"):
            a, acc, w = dev_args               # the flat (B, (k+1)N) layout
            flat = wrapper(a, acc.reshape(acc.shape[0], -1), w, kp1=acc.shape[1],
                           **kw)
            _compare(name + " (flat)", flat, want.reshape(flat.shape))
        if name == "fused_cmux_step":          # v1 against v2's kernel
            a, acc, w = dev_args
            _compare(name + " (against fused_cmux_step_v2)", got,
                     K.fused_cmux_step_v2(a, acc, w.transpose(1, 2)
                                          .contiguous(), **kw))
        if name == "rotate_decompose64":       # re-laid out: the chunk layout
            a, acc = dev_args
            B, kp1, N = acc.shape
            P, l = kw["planes"], kw["l"]
            planes = got.reshape(B, kp1, l, P, N).permute(3, 0, 1, 2, 4)
            _compare(name + " (re-laid out, against rotate_decompose64_ck)",
                     K.ck_layout(planes.reshape(P, B, kp1 * l, N), CB_M),
                     K.rotate_decompose64_ck(a, acc, m=CB_M, **kw))
        split_txt = ""
        if name in SPLIT_KERNELS:              # the chosen plan against S = 1
            plan = _plan(name, dev_args, kw)
            forced = dict(kw, split=1)
            if name == "ck_cmux_step32":
                forced["tile_rows"] = plan[0]
            _compare(f"{name} split=1", wrapper(*dev_args, **forced), got)
            split1_ms = cuda_ms(lambda: wrapper(*dev_args, **forced), reps)
        ms = cuda_ms(lambda: wrapper(*dev_args, **kw), reps)
        dev_ms = device_ms(lambda: wrapper(*dev_args, **kw), reps)
        plain_ms = cuda_ms(lambda: plain(*dev_args, **kw), 3, warmup=1)
        if name in SPLIT_KERNELS:
            split_txt = (f", chosen (tile_rows, S) = {plan}; S = 1 "
                         f"{split1_ms:.4f} ms, bit-identical")
        library_ms = None
        if lib is not None:                    # one library call, on the card
            fn, lib_args = LIBRARY[lib[0]], [t.cuda().contiguous()
                                             for t in lib[1]]
            library_ms = device_ms(lambda: fn(*lib_args), reps)
            del lib_args
        numbers = {"shape": shape, "max_abs_err": err, "ms": ms,
                   "device_ms": dev_ms, "plain_ms": plain_ms,
                   "bound_ms": bnd, "bound_by": by, "library_ms": library_ms}
        if name in EMITTERS and "profiler_ms" not in results.get(name, {}):
            numbers["profiler_ms"] = profiler_ms(
                lambda: wrapper(*dev_args, **kw), EMITTERS[name])
        if name in SPLIT_KERNELS:
            numbers.update(tile_rows=plan[0], split=plan[1],
                           split1_ms=split1_ms)
        if name in K64_PLANS:
            numbers["plan"] = _k64_plan(name, dev_args, kw)
            split_txt = (f", plan ({K64_PLANS[name]}) = "
                         f"{numbers['plan']}")
        if name in ("ck_dot64p_acc", "ck_dot64p_sacc"):
            x, wmt, acc = dev_args             # the two-kernel step's dot
            numbers["two_kernel_ms"] = cuda_ms(lambda: acc + K.recombine(
                K.ck_dot64p(x, wmt, N=kw["N"], m=kw["m"],
                            planes=kw["planes"]), kw["kp1"],
                kw["key_shift"]).reshape(acc.shape), reps)
        if name == "ck_cmux_step64":           # the steps it replaces
            numbers["default_step_ms"] = cuda_ms(
                lambda: _default_step64(*dev_args, **kw), reps)
            numbers["acc_step_ms"] = cuda_ms(
                lambda: _acc_step64(*dev_args, **kw), reps)
        del dev_args, got, want
        if name in results:
            results[name].setdefault("other_shapes", []).append(numbers)
        else:
            results[name] = {"name": name, "route": "cuda",
                             "source": f"tfhe_tpu_torch/ops/{src}",
                             "replaces": replaces, **numbers}
        lib_txt = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
        two = numbers.get("two_kernel_ms")
        two_txt = "" if two is None else \
            f", ck_dot64p + torch epilogue {two:.4f} ms"
        if "default_step_ms" in numbers:
            two_txt = (f", default two-kernel step "
                       f"{numbers['default_step_ms']:.4f} ms, acc step "
                       f"{numbers['acc_step_ms']:.4f} ms")
        prof = numbers.get("profiler_ms", "")
        if name in EMITTERS and prof != "":
            prof = (", torch.profiler: no device time" if prof is None else
                    f", torch.profiler {prof:.4f} ms")
        print(f"phase 2 kernel {name} at {shape}: bit-identical to plain, "
              f"device {dev_ms:.4f} ms (bound {bnd:.4f} ms by {by}, "
              f"{bnd / dev_ms:.1%} of it), call {ms:.4f} ms{prof}, plain "
              f"{plain_ms:.4f} ms, library {lib_txt}{two_txt}{split_txt}")
    torch.cuda.empty_cache()
    return results


# the digit emitters (their device time is cross-checked against
# torch.profiler's, by a part of the kernel's name)
EMITTERS = {"rotate_decompose": "rotate_decompose_kernel",
            "rotate_decompose64_ck": "rotate_decompose64_kernel",
            "rotate_decompose64_ck_flat": "rotate_decompose64_kernel"}
# the kernels whose reduction is split over blocks (K slices, chunk windows)
SPLIT_KERNELS = ("mm_recombine_acc", "ck_cmux_step32")
# the 64-bit contractions on the K-packed key wmt, and what their plans hold
K64_PLANS = {"ck_dot64p": "rows", "ck_dot64p_sacc": "rows",
             "ck_dot64p_acc": "rows, limbs", "ck_cmux_step64": "rows, split"}


def _k64_plan(name, dev_args, kw):
    """The plan the wrapper of ``name`` chooses for these inputs: the rows
    of a ck_dot64p or ck_dot64p_sacc block, (rows, limbs) of a
    ck_dot64p_acc block, (rows, split) of a ck_cmux_step64 launch."""
    from tfhe_tpu_torch.ops import kernels as K
    if name == "ck_cmux_step64":
        a, acc, wmt = dev_args
        UL, Npm, Jm = wmt.shape
        return K.ck_cmux_step64_plan(acc.shape[0], kw["kp1"], Npm - kw["m"],
                                     kw["m"], Jm, UL // kw["kp1"],
                                     kw["planes"], acc.device)
    x, wmt = dev_args[:2]
    UL, _, Jm = wmt.shape
    if name in ("ck_dot64p", "ck_dot64p_sacc"):
        return K.ck_dot64p_plan(x.shape[0], kw["N"], kw["m"], Jm,
                                kw["planes"])
    return K.ck_dot64p_acc_plan(x.shape[0], kw["N"], kw["m"], Jm,
                                UL // kw["kp1"], kw["planes"])


def _plan(name, dev_args, kw):
    """(tile_rows, S) the wrapper of ``name`` chooses for these inputs."""
    from tfhe_tpu_torch.ops import kernels as K
    if name == "mm_recombine_acc":
        x, w, _ = dev_args
        L, Kd, UN = w.shape
        return 64, K.mm_recombine_acc_split(x.shape[0], Kd, UN, L, x.device)
    a, acc, wm = dev_args
    B, kp1, N = acc.shape
    return K.ck_cmux_step32_plan(B, kp1, N, kw["m"], wm.shape[1],
                                 wm.shape[0] // kp1, acc.device)


def phase_splits(results, reps: int = 10):
    """The two split kernels over forced plans at their path shapes: every
    (tile_rows, S) bit-identical to the plain version (run on the card) and
    timed.  Adds "splits" to each kernel's entry."""
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import GATE_DEFAULT, GATE_MXU
    r = np.random.default_rng(4)

    def i8(shape, lo=-128, hi=128):
        return torch.from_numpy(
            r.integers(lo, hi, shape).astype(np.int8)).cuda()

    def i32(shape):
        return torch.from_numpy(
            r.integers(-2**31, 2**31, shape).astype(np.int32)).cuda()

    rows = []
    B, K_, UN, L = 256, 6144, 2048, 4          # GATE_DEFAULT's generic step
    x, w, acc = i8((B, K_), -64, 64), i8((L, K_, UN)), i32((B, UN))
    want = K.mm_recombine_acc_plain(x, w, acc)
    row = {"shape": f"GATE_DEFAULT B={B}", "ms": {}}
    for S in (1, 2, 3, 4, 6, 8, 12):
        def run():
            return K.mm_recombine_acc(x, w, acc, split=S)
        _compare(f"mm_recombine_acc split={S}", run(), want)
        row["ms"][f"64x{S}"] = cuda_ms(run, reps)
    rows.append(row)
    print(f"phase 2 splits mm_recombine_acc {row['shape']} (64-row tile x "
          f"S: ms): {row['ms']}")
    results["mm_recombine_acc"]["splits"] = rows
    del x, w, acc, want

    rows = []
    kp1, l, N, m = 2, 3, 1024, 128
    for label, p, L, B in (("GATE_DEFAULT", GATE_DEFAULT.tgsw, 4, 256),
                           ("GATE_MXU", GATE_MXU.tgsw, 3, 256),
                           ("GATE_MXU", GATE_MXU.tgsw, 3, 512),
                           ("GATE_MXU", GATE_MXU.tgsw, 3, 1),
                           ("GATE_MXU", GATE_MXU.tgsw, 3, 100),
                           ("GATE_MXU", GATE_MXU.tgsw, 3, 8192)):
        acc = i32((B, kp1, N))
        a = torch.randint(0, 2 * N, (B,), dtype=torch.int32, device="cuda")
        wm = i8((kp1 * L, kp1 * l * m, N + m))
        kw = dict(l=l, bgbit=p.bgbit, offset=p.offset, m=m,
                  key_shift=32 - 8 * L)
        want = K.ck_cmux_step32_plain(a, acc, wm, **kw)
        row = {"shape": f"{label} B={B}", "chosen": _plan(
            "ck_cmux_step32", (a, acc, wm), kw), "ms": {}}
        splits = (1, 2) if B == 8192 else (1, 2, 3, 4, 5, 8, 9)
        for t in (64, 32):
            for S in splits:
                def run():
                    return K.ck_cmux_step32(a, acc, wm, tile_rows=t, split=S,
                                            **kw)
                _compare(f"ck_cmux_step32 {label} B={B} {t}x{S}", run(), want)
                row["ms"][f"{t}x{S}"] = cuda_ms(run, 3 if B == 8192 else reps)
        rows.append(row)
        print(f"phase 2 splits ck_cmux_step32 {row['shape']} chosen "
              f"{row['chosen']} (tile_rows x S: ms): {row['ms']}")
        del acc, a, wm, want
    results["ck_cmux_step32"]["splits"] = rows
    torch.cuda.empty_cache()


def _default_step64(a, acc, wmt, *, l, bgbit, offset, m, planes, kp1,
                    key_shift):
    """The default 64-bit step (rotate_decompose64_ck + ck_dot64p + the
    int64 epilogue) on the flat accumulator: what ck_cmux_step64 replaces."""
    from tfhe_tpu_torch.ops import kernels as K
    B, N = acc.shape[0], acc.shape[1] // kp1
    x = K.rotate_decompose64_ck(a, acc.view(B, kp1, N), l=l, bgbit=bgbit,
                                offset=offset, m=m, planes=planes)
    y = K.ck_dot64p(x, wmt, N=N, m=m, planes=planes)
    return acc + K.recombine(y, kp1, key_shift).reshape(acc.shape)


def _acc_step64(a, acc, wmt, *, l, bgbit, offset, m, planes, kp1,
                key_shift):
    """The two-kernel acc step (rotate_decompose64_ck_flat + ck_dot64p_acc)
    on the same inputs: the yardstick of ck_cmux_step64."""
    from tfhe_tpu_torch.ops import kernels as K
    N = acc.shape[1] // kp1
    x = K.rotate_decompose64_ck_flat(a, acc, N=N, l=l, bgbit=bgbit,
                                     offset=offset, m=m, planes=planes)
    return K.ck_dot64p_acc(x, wmt, acc, N=N, m=m, key_shift=key_shift,
                           planes=planes, kp1=kp1)


def phase_tiles(entry, batches=(1, 3, 64, 65, 100, 256, 512, 704, 768, 1024,
                                2816, 8191, 8192), reps: int = 10):
    """The fused step's plans (kernels.FUSED_COLS: 64 or 128 output columns
    a block), each forced and as chosen (kernels.fused_cmux_step_v2_plan),
    at GATE_FAST2 shapes: each held bit-identical to the plain version (run
    on the card; its float64 sums are exact) and timed.  Adds "tiles" to
    the fused kernel's entry."""
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import GATE_FAST2
    p = GATE_FAST2.tgsw
    kp1, N, L = 3, 512, 3
    r = np.random.default_rng(3)
    w = torch.from_numpy(r.integers(-128, 128, (L, kp1 * N, kp1 * p.l * N))
                         .astype(np.int8)).cuda()
    kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset, key_shift=8)
    rows = []
    for B in batches:
        acc = torch.from_numpy(r.integers(-2**31, 2**31, (B, kp1, N))
                               .astype(np.int32)).cuda()
        a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32)).cuda()
        want = K.fused_cmux_step_v2_plain(a, acc, w, **kw)
        row = {"B": B}
        for tile in (*K.FUSED_COLS, 0):
            def step():
                return K.fused_cmux_step_v2(a, acc, w, tile_cols=tile, **kw)
            _compare(f"fused_cmux_step_v2 B={B} tile_cols={tile}", step(), want)
            row[f"ms_{tile or 'chosen'}"] = cuda_ms(step, reps)
        rows.append(row)
        print(f"phase 2 tiles fused_cmux_step_v2 B={B} (ms): " + ", ".join(
            f"{k[3:]} {v:.4f}" for k, v in row.items() if k != "B")
            + ", all bit-identical to plain")
    entry["tiles"] = rows


PARTS = (("keys", "FCS_PART=1"), ("digits", "FCS_PART=2"),
         ("mmas", "FCS_PART=3"))


def phase_parts(entry, batch: int = 8192, reps: int = 10):
    """Where one fused step's time goes at GATE_FAST2 B=8192: the kernel
    built three more times with FCS_PART (csrc/fused_cmux_step.cu), each
    variant keeping one part of the step (the key tiles' TMA loads, the
    digit build, the wgmmas), timed beside the whole step on the same
    inputs.  The variants' outputs are not compared.  Adds "parts" to the
    fused kernel's entry."""
    from tfhe_tpu_torch import torus as T
    from tfhe_tpu_torch.ops import _build
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import GATE_FAST2
    p = GATE_FAST2.tgsw
    kp1, N, L, B = 3, 512, 3, batch
    r = np.random.default_rng(8)
    wt = torch.from_numpy(r.integers(-128, 128, (L, kp1 * N, kp1 * p.l * N))
                          .astype(np.int8)).cuda()
    acc = torch.from_numpy(r.integers(-2**31, 2**31, (B, kp1, N))
                           .astype(np.int32)).cuda()
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32)).cuda()
    out = torch.empty_like(acc)
    tile = K.fused_cmux_step_v2_plan(N, p.l, L)
    fns = _build.variants("fused_cmux_step", [(d,) for _, d in PARTS])
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn):
        rc = fn(a.data_ptr(), acc.data_ptr(), wt.data_ptr(), out.data_ptr(), B,
                kp1, N, p.l, L, p.bgbit, p.offset & T.MASK32, 8, tile, stream)
        check(rc == 0, f"fused_cmux_step part variant: cudaError {rc}")

    parts = {"whole": cuda_ms(lambda: K.fused_cmux_step_v2(
        a, acc, wt, l=p.l, bgbit=p.bgbit, offset=p.offset, key_shift=8), reps)}
    for (part, _), fn in zip(PARTS, fns):
        parts[part] = cuda_ms(lambda: run(fn), reps)
    entry["parts"] = dict(parts, shape=f"GATE_FAST2 B={B}", tile_cols=tile)
    print(f"phase 2 parts fused_cmux_step_v2 GATE_FAST2 B={B} (tile_cols "
          f"{tile}, ms): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                       parts.items()))


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
    _only(counts, {"materialize_wt": n * chain,
                   "fused_cmux_step_v2": n * chain}, "GATE_FAST2")
    rate = batch * chain / wall
    print(f"phase 3 GATE_FAST2 onthefly B={batch}: {rate:.1f} ct/s "
          f"({wall:.3f} s for {chain} dependent launches), all "
          f"{batch} bits decrypt, launches {counts}, keygen {keygen_s:.1f} s "
          f"[{smi}]")

    # where one launch's time goes, from CUDA events at this batch
    from tfhe_tpu_torch import lwe, torus as T
    v0 = ck.data["bk"]["v"][0]
    w0 = K.materialize_wt(v0)
    acc = torch.zeros((batch, 3, 512), dtype=torch.int32, device="cuda")
    acc.random_(-2**31, 2**31 - 1)
    a0 = T.mod_switch_from_torus32(ct[:, 0].contiguous(), 1024)
    p = P.tgsw
    step_ms = cuda_ms(lambda: K.fused_cmux_step_v2(
        a0, acc, w0, l=p.l, bgbit=p.bgbit, offset=p.offset, key_shift=8), 5)
    mat_ms = cuda_ms(lambda: K.materialize_wt(v0), 20)
    u = torch.zeros((batch, 2 * 512 + 1), dtype=torch.int32, device="cuda")
    ksk = lwe.KeySwitchKey(P.ks, 1024, n, ck.data["ksw"])
    ks_ms = cuda_ms(lambda: lwe.keyswitch(u, ksk), 3)
    print(f"phase 3 breakdown B={batch}: fused step {step_ms:.3f} ms x {n}, "
          f"materialize_wt {mat_ms:.4f} ms x {n}, keyswitch {ks_ms:.3f} ms; "
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
    return counts, {"ct_per_s": rate, "step_ms": step_ms, "mat_ms": mat_ms,
                    "ks_ms": ks_ms, "launch_ms": wall / chain * 1e3}


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
    for name in ("fused_cmux_step_v2", "materialize_wt"):
        check(counts[name] == 0,
              f"GATE_DEFAULT: {name} ran with 4 key limbs")
    print(f"phase 4 GATE_DEFAULT onthefly B={batch}: "
          f"{batch / wall:.1f} ct/s ({wall:.3f} s for one launch), all "
          f"{batch} bits decrypt, launches {counts}, keygen {keygen_s:.1f} s "
          f"[{smi}]")

    # where one launch's time goes, in device time at this batch
    from tfhe_tpu_torch import tgsw
    from tfhe_tpu_torch.boot import blind_rotate
    from tfhe_tpu_torch.ops.engine import make_engine
    p = P.tgsw
    kp1, N = p.tlwe.k + 1, p.tlwe.N
    eng = make_engine(tgsw.engine_config(p), "onthefly")
    prep0 = {"v": ck.data["bk"]["v"][0]}
    acc = torch.zeros((batch, kp1, N), dtype=torch.int32, device="cuda")
    acc.random_(-2**31, 2**31 - 1)
    a0 = torch.randint(0, 2 * N, (batch,), dtype=torch.int32, device="cuda")
    kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset)
    x = K.rotate_decompose(a0, acc, **kw).reshape(batch, -1)
    w = K.materialize_w(prep0["v"])
    parts = {
        "rotate_decompose": device_ms(lambda: K.rotate_decompose(a0, acc,
                                                                 **kw)),
        "materialize_w": device_ms(lambda: K.materialize_w(prep0["v"])),
        "mm_recombine_acc": device_ms(lambda: K.mm_recombine_acc(
            x, w, acc.reshape(batch, -1), shift_base=eng.cfg.key_shift))}
    step = device_ms(lambda: blind_rotate.cmux_step(eng, a0, acc, prep0, p))
    launch_ms = wall * 1e3
    print(f"phase 4 breakdown B={batch} (device time): " + ", ".join(
        f"{k} {v:.4f} ms x {n} ({v / step:.1%} of a step, "
        f"{v * n / launch_ms:.1%} of the launch)" for k, v in parts.items())
        + f"; whole step {step:.4f} ms x {n} = {step * n:.1f} ms vs "
        f"{launch_ms:.1f} ms per launch; launch floor "
        f"{launch_floor_ms():.4f} ms")
    return counts, out


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

def _torus_dist(x, want):
    """|x - want| on the 32-bit torus, as int64."""
    d = (x.to(torch.int64) - want) % 2**32
    return torch.minimum(d, 2**32 - d)


def check_trgsw_rows(gsw, bits, sk, P) -> list:
    """Every TRGSW row (z=1, w) of the batch: coefficient 0 within h_w/4 of
    bit * h_w, h_w = 2^(32-(w+1)*bg1), and the other coefficients within
    h_w/4 of 0 (tests/test_circuit_bootstrap.py).  h_w/4 is below h_w/2, so
    a row that encodes the wrong bit fails.  Returns the worst error of
    each level."""
    from tfhe_tpu_torch import tgsw
    ph = tgsw.tgsw_phase(gsw, sk.ring_lvl1)          # (B, k+1, ell1, N1)
    bit_t = torch.from_numpy(bits).to(gsw.device)
    worst = []
    for w in range(P.tgsw_lvl1.l):
        h = 1 << (32 - (w + 1) * P.tgsw_lvl1.bgbit)
        row = ph[:, 1, w]
        worst.append(max(int(_torus_dist(row[:, 0], bit_t * h).max()),
                         int(_torus_dist(row[:, 1:], 0).max())))
        check(worst[-1] < h // 4, f"a TRGSW row phase of level {w} is off "
              f"by {worst[-1]} >= h_{w}/4 = {h // 4}")
    return worst


def check_cmux(gsw, bits, sk, P) -> tuple:
    """A CMux driven by each TRGSW selects d1 for bit 1 and d0 for bit 0.
    d1 - d0 has the digit Bg/4 on the last level at coefficient 0, so a row
    of that level that encodes the wrong bit moves the output by
    (Bg/4) * h_last; the limit is half that.  Returns (worst error,
    limit)."""
    from tfhe_tpu_torch import tgsw, tlwe
    p1, k = P.tgsw_lvl1, P.lvl1.k
    h_last = 1 << (32 - p1.l * p1.bgbit)
    limit = (1 << (p1.bgbit - 2)) * h_last // 2
    m = torch.zeros((2, P.n_lvl1), dtype=torch.int32, device=gsw.device)
    m[0, 0] = 1 << 29
    m[1, 0] = -(1 << 29) + (1 << (p1.bgbit - 2)) * h_last
    d0, d1 = (tlwe.noiseless_trivial_poly(m[i:i + 1], k) for i in (0, 1))
    worst = 0
    for i in range(gsw.shape[0]):
        _, prep = tgsw.prepare(gsw[i], p1, "onthefly")
        sel = tgsw.cmux(prep, d1, d0, p1, "onthefly")
        err = _torus_dist(tlwe.tlwe_phase(sel, sk.ring_lvl1)[0],
                          m[int(bits[i])].to(torch.int64))
        worst = max(worst, int(err.max()))
    check(worst < limit, f"a CMux selection is off by {worst} >= {limit}")
    return worst, limit


def phase_circuit(smi: str):
    """CB_MXU circuit bootstrap of the 4 bits of each of 64 random LUT
    indices, then the LUTs they select.  Returns the launch counts of the
    timed launch and its numbers."""
    from tfhe_tpu_torch import device, lwe, noise, tgsw, tlwe
    from tfhe_tpu_torch import torus as T
    from tfhe_tpu_torch.boot import circuit
    from tfhe_tpu_torch.models import lut
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.ops.engine import make_engine
    from tfhe_tpu_torch.params import CB_MXU
    from tfhe_tpu_torch.rng import TfheRng
    from tfhe_tpu_torch.utils import observability as obs
    P, instances, lut_bits = CB_MXU, 64, 4
    dev = device.resolve(None)
    batch = instances * lut_bits
    k, ell1 = P.lvl1.k, P.tgsw_lvl1.l
    shared = (noise.shared_rotation_penalty(P)
              <= noise.SHARED_ROTATION_MAX_PENALTY)
    steps = P.n_lvl0 * (1 if shared else ell1)

    rng = TfheRng(0)
    sk = circuit.CircuitSecretKey.generate(P, rng)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ck = circuit.CircuitCloudKey.generate(sk, rng, backend="chunked",
                                          keep_raw_bk=True)
    keygen_s = time.perf_counter() - t0
    keygen_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    keys_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    spans = obs.report()["spans"]
    parts = ", ".join(f"{name.split('.')[-1]} {v['total_s']:.2f} s"
                      for name, v in spans.items()
                      if name.startswith("keygen.circuit."))
    print(f"phase 5 keygen CB_MXU chunked: {keygen_s:.2f} s ({parts})")

    # instance i selects table[idx_i]; its bits, LSB first, are ciphertexts
    # i*lut_bits .. i*lut_bits + lut_bits - 1 (bit = 1 encodes as 1/2)
    r = np.random.default_rng(5)
    idx = r.integers(0, 1 << lut_bits, instances)
    bits = ((idx[:, None] >> np.arange(lut_bits)) & 1).reshape(-1)
    msgs = np.where(bits == 1, -(1 << 31), 0).astype(np.int32)
    ct = lwe.encrypt(sk.lwe_lvl1, msgs, rng, 2.0**-20)
    cb = circuit.make_circuit_bootstrap_staged(P, backend="chunked")
    cb(ct, ck.data)                     # untimed: first-use set-up
    torch.cuda.synchronize()

    K.reset_launches()
    t0 = time.perf_counter()
    gsw = cb(ct, ck.data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {kern.__name__: kern.launches for kern in K.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name in ("rotate_decompose64_ck", "ck_dot64p"):
        check(counts[name] == steps, f"CB_MXU: {name} launched "
              f"{counts[name]} times, want {steps}")
    _wmt_only("CB_MXU", ck)
    for name in ("materialize_w", "materialize_wt", "rotate_decompose",
                 "mm_recombine_acc", "fused_cmux_step_v2"):
        check(counts[name] == 0, f"CB_MXU: 32-bit kernel {name} launched "
              f"inside the circuit bootstrap")
    check(tuple(gsw.shape) == (batch, k + 1, ell1, k + 1, P.n_lvl1),
          f"CB_MXU: TRGSW batch of shape {tuple(gsw.shape)}")
    print(f"phase 5 CB_MXU chunked B={batch}: {wall * 1e3 / batch:.3f} ms "
          f"per ciphertext, {batch / wall:.2f} ct/s ({wall:.3f} s for one "
          f"launch, {'one shared rotation' if shared else f'{ell1} rotations'}"
          f" of {P.n_lvl0} steps), launches {counts} [{smi}]")

    worst = check_trgsw_rows(gsw, bits, sk, P)
    print(f"phase 5 TRGSW rows: all {batch * ell1} (z=1) rows within h_w/4 "
          f"of bit * h_w; worst error per level {worst}")
    worst, limit = check_cmux(gsw, bits, sk, P)
    print(f"phase 5 CMux: all {batch} TRGSWs select the right message "
          f"(worst phase error {worst} < {limit})")

    # a lut_bits-bit LUT per instance: table[v] = perm[v] / 2^lut_bits
    p1 = P.tgsw_lvl1
    perm = r.permutation(1 << lut_bits)
    table = T.wrap32(torch.from_numpy(perm.astype(np.int64)
                                      << (32 - lut_bits)))
    sel = gsw.reshape(instances, lut_bits, *gsw.shape[1:])
    out = lut.eval_lut_batch(sel, table, p1, backend="onthefly")
    dec = T.mod_switch_from_torus32(
        tlwe.tlwe_phase(out, sk.ring_lvl1)[:, 0], 1 << lut_bits)
    ok = dec.cpu().numpy() == perm[idx]
    check(ok.all(), f"CB_MXU: {int((~ok).sum())} of {instances} LUT "
          f"outputs wrong")
    print(f"phase 5 LUT: all {instances} {lut_bits}-bit LUTs decode "
          f"table[index]")

    # where one launch's time goes, from CUDA events at the path's shapes
    p2 = P.tgsw_lvl2
    eng = make_engine(tgsw.engine_config(p2), "chunked")
    wmt0 = ck.data["bk"]["wmt"][0]
    prep0 = {"wmt": wmt0}
    acc = torch.randint(-2**63, 2**63 - 1, (batch, k + 1, P.n_lvl2),
                        dtype=torch.int64, device=dev)
    a0 = torch.randint(0, 2 * P.n_lvl2, (batch,), dtype=torch.int32,
                       device=dev)
    kw = dict(l=p2.l, bgbit=p2.bgbit, offset=p2.offset, m=eng.m,
              planes=eng.cfg.plane_split[1])
    x = K.rotate_decompose64_ck(a0, acc, **kw)
    y = K.ck_dot64p(x, wmt0, N=P.n_lvl2, m=eng.m, planes=kw["planes"])
    rot_ms = cuda_ms(lambda: K.rotate_decompose64_ck(a0, acc, **kw), 20)
    dot_ms = cuda_ms(lambda: K.ck_dot64p(x, wmt0, N=P.n_lvl2, m=eng.m,
                                         planes=kw["planes"]), 10)
    accf = acc.reshape(batch, -1)
    dev_ms = {"rotate_decompose64_ck": device_ms(
                  lambda: K.rotate_decompose64_ck(a0, acc, **kw)),
              "rotate_decompose64_ck_flat": device_ms(
                  lambda: K.rotate_decompose64_ck_flat(a0, accf, N=P.n_lvl2,
                                                       **kw)),
              "ck_dot64p": device_ms(lambda: K.ck_dot64p(
                  x, wmt0, N=P.n_lvl2, m=eng.m, planes=kw["planes"]), 10),
              "step": device_ms(lambda: eng.cmux_step(
                  a0, acc, prep0, l=p2.l, bgbit=p2.bgbit, offset=p2.offset),
                  10)}
    epi_ms = cuda_ms(lambda: acc + K.recombine(y, k + 1,
                                               eng.cfg.key_shift), 20)
    step_ms = cuda_ms(lambda: eng.cmux_step(a0, acc, prep0, l=p2.l,
                                            bgbit=p2.bgbit,
                                            offset=p2.offset), 10)
    opt_step_ms = {name: device_ms(lambda: getattr(eng, method)(
        a0, accf, prep0, kp1=k + 1, l=p2.l, bgbit=p2.bgbit,
        offset=p2.offset), 10)
        for name, method in (("acc", "cmux_step_acc"),
                             ("sacc", "cmux_step_sacc"),
                             ("fused", "cmux_step_flat"))}
    dot_plan = K.ck_dot64p_plan(batch, P.n_lvl2, eng.m, wmt0.shape[-1],
                                kw["planes"])
    preks = lwe.KeySwitchKey(P.ks10, P.n_lvl1, P.n_lvl0, ck.data["preks"])
    pre_ms = cuda_ms(lambda: lwe.keyswitch(ct, preks), 5)
    ext = torch.randint(-2**63, 2**63 - 1, (batch, P.n_lvl2 + 1),
                        dtype=torch.int64, device=dev)
    priv_ms = cuda_ms(lambda: circuit.priv_keyswitch(ext, ck.privks, 0), 5)
    n_priv = ell1 * (k + 1)
    total = (rot_ms + dot_ms + epi_ms) * steps + pre_ms + priv_ms * n_priv
    print(f"phase 5 breakdown B={batch}: rotate_decompose64_ck "
          f"{rot_ms:.4f} ms x {steps}, ck_dot64p {dot_ms:.4f} ms x {steps} "
          f"({dot_plan} rows a block), "
          f"int64 epilogue {epi_ms:.4f} ms x {steps} (whole step "
          f"{step_ms:.4f} ms), preKS {pre_ms:.3f} ms x 1, privKS "
          f"{priv_ms:.3f} ms x {n_priv}; sum {total:.1f} ms vs "
          f"{wall * 1e3:.1f} ms per launch; peak device memory from before "
          f"keygen {max(keygen_peak_gb, peak_gb):.2f} GB, of the two "
          f"launches {peak_gb:.2f} GB (the keys {keys_gb:.2f} GB resident, "
          f"their K-packed wmt {_nbytes(ck.data['bk']['wmt']) / 1e9:.2f} GB, "
          f"no wm; keygen's peak {keygen_peak_gb:.2f} GB)")
    rot, one = dev_ms["rotate_decompose64_ck"], dev_ms["step"]
    print(f"phase 5 device time B={batch}: rotate_decompose64_ck {rot:.4f} "
          f"ms x {steps} ({rot / one:.1%} of a default step of {one:.4f} "
          f"ms, {rot * steps / (wall * 1e3):.1%} of the launch), ck_dot64p "
          f"{dev_ms['ck_dot64p']:.4f} ms, rotate_decompose64_ck_flat "
          f"{dev_ms['rotate_decompose64_ck_flat']:.4f} ms; launch floor "
          f"{launch_floor_ms():.4f} ms")
    state = {"ck": ck, "ct": ct, "gsw": gsw, "wall": wall,
             "step_ms": one, "opt_step_ms": opt_step_ms, "steps": steps,
             "flat_rot_ms": dev_ms["rotate_decompose64_ck_flat"]}
    return counts, state


# phases 5b-5d: (phase, step, variable, value, its kernels)
CK64_STEPS = (
    ("5b", "acc", "TFHE_CK64_PATH", "acc",
     ("rotate_decompose64_ck_flat", "ck_dot64p_acc")),
    ("5c", "sacc", "TFHE_CK64_PATH", "sacc",
     ("rotate_decompose64_ck_flat", "ck_dot64p_sacc")),
    ("5d", "fused", "TFHE_CK64_FUSED", "1", ("ck_cmux_step64",)))


def phase_circuit_step(smi: str, state: dict, phase: str, step: str,
                       var: str, value: str, kernels: tuple):
    """Phase 5 again on its keys and inputs with ``var=value``: the TRGSWs
    must equal phase 5's bit for bit, every step must go through
    ``kernels`` and no other CMux kernel."""
    import os
    from tfhe_tpu_torch.boot import circuit
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import CB_MXU
    ck, ct, steps = state["ck"], state["ct"], state["steps"]
    batch = ct.shape[0]
    cb = circuit.make_circuit_bootstrap_staged(CB_MXU, backend="chunked")
    os.environ[var] = value
    try:
        cb(ct, ck.data)                 # untimed: first-use set-up
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        gsw = cb(ct, ck.data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del os.environ[var]
    counts = _launch_counts()
    _wmt_only(f"CB_MXU {step}", ck)
    check(torch.equal(gsw, state["gsw"]),
          f"CB_MXU {step}: the TRGSWs differ from the default step's")
    _only(counts, {name: steps for name in kernels}, f"CB_MXU {step}")
    one = state["opt_step_ms"][step]
    share = ""
    if "rotate_decompose64_ck_flat" in kernels:
        rot = state["flat_rot_ms"]
        share = (f"; rotate_decompose64_ck_flat {rot:.4f} ms x {steps} "
                 f"({rot / one:.1%} of a step, "
                 f"{rot * steps / (wall * 1e3):.1%} of the launch)")
    print(f"phase {phase} CB_MXU chunked {var}={value} B={batch}: "
          f"{wall * 1e3 / batch:.3f} ms per ciphertext ({wall:.3f} s for one "
          f"launch) against phase 5's {state['wall'] * 1e3 / batch:.3f}; "
          f"TRGSWs bit-identical to phase 5's; one step {one:.4f} ms of "
          f"device time against the default {state['step_ms']:.4f} "
          f"ms{share}; launches {counts} [{smi}]")
    return counts


# ---------------------------------------------------------------------------
# phases 6 and 7
# ---------------------------------------------------------------------------

# kernels that run on no path of the port (only its tests and phase 2 call
# them, as only the JAX package's tests call their Pallas kernels)
TEST_ONLY = ("fused_cmux_step", "rotate_decompose64")


def _gate_run(P, backend, bits, chain, seed=0):
    """Keys from ``seed``, ``bits`` encrypted, one untimed launch, then a
    timed dependent chain of ``chain`` launches.  Returns the keys, the
    chain's output, its wall seconds, the launch counts, keygen seconds and
    peak device memory."""
    from tfhe_tpu_torch.boot import gate
    from tfhe_tpu_torch.ops import kernels as K
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rng, sk, ck, keygen_s = _keys(P, backend, seed)
    ct = gate.encrypt_bool(sk, bits, rng)
    boot = gate.make_bootstrap_fn(P, backend=backend)
    boot(ck.data, ct)                   # untimed: first-use set-up
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    out = ct
    for _ in range(chain):
        out = boot(ck.data, out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ok = gate.decrypt_bool(sk, out) == bits.astype(bool)
    check(ok.all(), f"{backend}: {int((~ok).sum())} of {len(bits)} bits "
          f"wrong")
    return sk, ck, out, wall, _launch_counts(), keygen_s, peak_gb


def _wmt_only(what: str, ck):
    """The 64-bit prepared key is the K-packed wmt alone (no wm), and the
    timed launch transposed no key."""
    from tfhe_tpu_torch.ops import kernels as K
    check(set(ck.data["bk"]) == {"wmt"}, f"{what}: the 64-bit prepared key "
          f"holds {sorted(ck.data['bk'])}, want wmt alone")
    check(K.ck_dot64p.transposes == 0, f"{what}: {K.ck_dot64p.transposes} "
          f"per-call key transposes inside the loop")


def _only(counts, allowed: dict, what: str):
    """Exactly ``allowed[name]`` launches of each CMux kernel named there,
    none of the others."""
    from tfhe_tpu_torch.ops import kernels as K
    for name in (k.__name__ for k in K.KERNELS):
        want = allowed.get(name, 0)
        check(counts[name] == want, f"{what}: {name} launched {counts[name]} "
              f"times, want {want}")


def phase_n1024(smi: str, default_out, batch: int = 8192, chain: int = 2,
                default_batch: int = 256):
    """GATE_MXU at B=8192 on the chunked engine (ck_cmux_step32, 630 per
    launch) and, from the same seed, on the onthefly engine (materialize_wt
    + fused_cmux_step_v2 at N=1024): every bit decrypts and the two chains
    give the same ciphertexts bit for bit.  Then GATE_DEFAULT chunked at
    B=256, which must give phase 4's onthefly ciphertexts.  Returns the
    launch counts by path and the GATE_MXU chunked keys."""
    from tfhe_tpu_torch import lwe
    from tfhe_tpu_torch import torus as T
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import GATE_DEFAULT, GATE_MXU
    P, n = GATE_MXU, GATE_MXU.lwe.n
    p = P.tgsw
    bits = np.random.default_rng(6).integers(0, 2, batch)
    by_path, outs = {}, {}
    for backend, kernels in (
            ("chunked", {"ck_cmux_step32": n * chain}),
            ("onthefly", {"materialize_wt": n * chain,
                          "fused_cmux_step_v2": n * chain})):
        sk, ck, out, wall, counts, keygen_s, peak_gb = _gate_run(
            P, backend, bits, chain)
        _only(counts, kernels, f"GATE_MXU {backend}")
        outs[backend] = out
        by_path[f"gate_mxu_{backend}"] = counts
        rate = batch * chain / wall

        # where one launch's time goes, from CUDA events at this batch
        acc = torch.zeros((batch, 2, 1024), dtype=torch.int32, device="cuda")
        acc.random_(-2**31, 2**31 - 1)
        a0 = torch.randint(0, 2048, (batch,), dtype=torch.int32,
                           device="cuda")
        kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset, key_shift=8)
        if backend == "chunked":
            wm0 = ck.data["bk"]["wm"][0]
            step_ms = cuda_ms(lambda: K.ck_cmux_step32(a0, acc, wm0, m=128,
                                                       **kw), 5)
            parts = f"ck_cmux_step32 {step_ms:.3f} ms x {n}"
        else:
            v0 = ck.data["bk"]["v"][0]
            w0 = K.materialize_wt(v0)
            step_ms = cuda_ms(lambda: K.fused_cmux_step_v2(a0, acc, w0, **kw),
                              5)
            mat_ms = cuda_ms(lambda: K.materialize_wt(v0), 20)
            parts = (f"fused_cmux_step_v2 {step_ms:.3f} ms x {n}, "
                     f"materialize_wt {mat_ms:.4f} ms x {n}")
            step_ms += mat_ms
            del w0
        u = torch.zeros((batch, 1024 + 1), dtype=torch.int32, device="cuda")
        ksk = lwe.KeySwitchKey(P.ks, 1024, n, ck.data["ksw"])
        ks_ms = cuda_ms(lambda: lwe.keyswitch(u, ksk), 3)
        del acc, a0, u
        print(f"phase 6 GATE_MXU {backend} B={batch}: {rate:.1f} ct/s "
              f"({wall:.3f} s for {chain} dependent launches), all {batch} "
              f"bits decrypt, launches {counts}, keygen {keygen_s:.1f} s, "
              f"peak device memory {peak_gb:.2f} GB [{smi}]")
        print(f"phase 6 breakdown GATE_MXU {backend} B={batch}: {parts}, "
              f"keyswitch {ks_ms:.3f} ms; sum {step_ms * n + ks_ms:.1f} ms "
              f"vs {wall / chain * 1e3:.1f} ms per launch")
        if backend == "chunked":
            keys = (sk, ck)
        else:
            del ck
    check(torch.equal(outs["chunked"], outs["onthefly"]),
          "GATE_MXU: the chunked and onthefly ciphertexts differ")
    print(f"phase 6 GATE_MXU: chunked and onthefly give the same "
          f"{batch} ciphertexts bit for bit")

    # GATE_DEFAULT chunked against phase 4's onthefly ciphertexts
    P, n, batch = GATE_DEFAULT, GATE_DEFAULT.lwe.n, default_batch
    bits = np.random.default_rng(2).integers(0, 2, batch)
    _, ck, out, wall, counts, keygen_s, peak_gb = _gate_run(P, "chunked",
                                                            bits, 1)
    del ck
    _only(counts, {"ck_cmux_step32": n}, "GATE_DEFAULT chunked")
    check(torch.equal(out, default_out),
          "GATE_DEFAULT: the chunked ciphertexts differ from phase 4's")
    by_path["gate_default_chunked"] = counts
    print(f"phase 6 GATE_DEFAULT chunked B={batch}: {batch / wall:.1f} ct/s "
          f"({wall:.3f} s for one launch), all {batch} bits decrypt and "
          f"equal phase 4's onthefly ciphertexts bit for bit, launches "
          f"{counts}, keygen {keygen_s:.1f} s, peak device memory "
          f"{peak_gb:.2f} GB [{smi}]")
    torch.cuda.empty_cache()
    return by_path, keys


def _encrypt_words(sk, words, nbits, rng):
    """(nbits, instances, n+1): bit i of every instance's word."""
    from tfhe_tpu_torch.boot import gate
    bits = (words[None, :] >> np.arange(nbits, dtype=np.uint64)[:, None]) & 1
    return torch.stack([gate.encrypt_bool(sk, b, rng) for b in bits])


def _decode_words(sk, cts):
    from tfhe_tpu_torch.boot import gate
    bits = np.stack([gate.decrypt_bool(sk, c) for c in cts]).astype(np.uint64)
    return (bits << np.arange(len(cts), dtype=np.uint64)[:, None]).sum(0)


def phase_circuits(smi: str, keys, instances: int = 256):
    """A 32-bit ripple-carry adder and a 32-bit comparator over
    ``instances`` instances each, through runtime.scheduler.evaluate on the
    GATE_MXU chunked keys: every output decodes to the plain sum or
    comparison.  Returns the launch counts by path."""
    from tfhe_tpu_torch.boot import gate
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import GATE_MXU
    from tfhe_tpu_torch.rng import TfheRng
    from tfhe_tpu_torch.runtime import scheduler
    from tfhe_tpu_torch.utils import observability as obs
    sk, ck = keys
    n = GATE_MXU.lwe.n
    rng = TfheRng(7)
    r = np.random.default_rng(7)
    x = r.integers(0, 2**32, instances, dtype=np.uint64)
    y = r.integers(0, 2**32, instances, dtype=np.uint64)
    y[:8] = x[:8]                       # some equal pairs for the comparator
    cts = torch.cat([_encrypt_words(sk, x, 32, rng),
                     _encrypt_words(sk, y, 32, rng)])
    by_path = {}
    for name, build in (("adder", scheduler.ripple_carry_adder),
                        ("comparator", scheduler.comparator)):
        circ, outs = build(32)
        torch.cuda.synchronize()
        obs.reset()
        K.reset_launches()
        t0 = time.perf_counter()
        res = scheduler.evaluate(circ, cts, ck.data, GATE_MXU, outs,
                                 backend="chunked")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        rep = obs.report()["counters"]
        if name == "adder":
            got = _decode_words(sk, res)
            check((got == x + y).all(), f"adder: {int((got != x + y).sum())} "
                  f"of {instances} sums wrong")
        else:
            dec = np.stack([gate.decrypt_bool(sk, res[i]) for i in range(3)])
            want = np.stack([x < y, x == y, x > y])
            check((dec == want).all(), f"comparator: "
                  f"{int((dec != want).any(0).sum())} of {instances} "
                  f"comparisons wrong")
        _only(counts, {"ck_cmux_step32": n * rep["bootstrap.launches"]},
              f"circuit {name}")
        boots = rep["bootstrap.ciphertexts"]
        by_path[f"circuit_{name}"] = counts
        print(f"phase 7 {name}32 GATE_MXU chunked x{instances}: "
              f"{rep['circuit.gates']} gates, {rep['circuit.waves']} waves, "
              f"{rep['bootstrap.launches']} launches, {boots} gate "
              f"bootstraps ({boots // instances} per circuit) in "
              f"{wall:.3f} s: {boots / wall:.1f} gate bootstraps/s; every "
              f"output decodes right [{smi}]")
    return by_path



# ---------------------------------------------------------------------------
# phases 8 and 9
# ---------------------------------------------------------------------------

# phase 8's backends at each torus width
ENGINE_CHECKS = {32: ("conv", "conv_bf16", "nussbaumer", "fft_f64", "fft_dd"),
                 64: ("conv", "nussbaumer")}
FFT_BOUND = {"fft_f64": 2**4, "fft_dd": 2**8}   # tests/test_fft_engine.py
CALL_TIMED = ("nussbaumer", "fft_dd")


def phase_engines(smi: str, batch: int = 256, seed: int = 8):
    """The conv, Nussbaumer and FFT engines on the card at the engine
    configs the paths use: GATE_DEFAULT's (N=1024, 32 bits, l=3, Bg=2^7,
    4 key limbs: J=6, U=2) and CB_MXU's lvl2 (N=2048, Torus64, l=5, Bg=2^8,
    6 limbs: J=10, U=2), B=256, from one numpy seed.  The exact yardstick
    is onthefly at 32 bits and chunked at 64: conv must equal it bit for
    bit at both, conv_bf16 at 32, nussbaumer on a key it is exact on at
    both; fft_f64 within 2^4 and fft_dd within 2^8 of it at 32.  Prints
    each backend's device ms of one accumulate (call ms for the engines of
    CALL_TIMED) and its launches of materialize_w, materialize_wt and
    mm_recombine_acc."""
    from tfhe_tpu_torch import tgsw
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.ops.engine import make_engine
    from tfhe_tpu_torch.ops.nussbaumer import split_mr
    from tfhe_tpu_torch.params import CB_MXU, GATE_DEFAULT
    r = np.random.default_rng(seed)
    for bits, p in ((32, GATE_DEFAULT.tgsw), (64, CB_MXU.tgsw_lvl2)):
        cfg = tgsw.engine_config(p)
        J, U, N = (p.tlwe.k + 1) * p.l, p.tlwe.k + 1, p.tlwe.N
        half = 1 << (p.bgbit - 1)               # gadget digits: [-Bg/2, Bg/2)
        x = torch.from_numpy(r.integers(-half, half, (batch, J, N))
                             .astype(np.int32)).cuda()
        if bits == 32:
            key = torch.from_numpy(r.integers(-2**31, 2**31, (J, U, N))
                                   .astype(np.int32)).cuda()
        else:
            key = torch.from_numpy(r.integers(-2**63, 2**63, (J, U, N),
                                              dtype=np.int64)).cuda()
        if bits == 32:
            s = (2 * split_mr(N)[0]).bit_length() - 1
            key2m = (key >> s) << s                # divisible by 2m
        else:
            # the Nussbaumer engine splits its transformed key into the
            # config's 6 limbs without the key_limbs rounding (as the JAX
            # package's does), so at lvl2 it is exact on keys of the 2^16
            # lattice below 2^40: divisible by 2m, their transform in 48 bits
            key2m = torch.from_numpy(r.integers(-2**23, 2**23, (J, U, N))
                                     .astype(np.int64) << 16).cuda()
        exact = make_engine(cfg, "onthefly" if bits == 32 else "chunked")
        prep_exact = exact.prepare(key)
        want = {"key": exact.accumulate(x, prep_exact),
                "key2m": exact.accumulate(x, exact.prepare(key2m))}
        line = []
        for backend in ENGINE_CHECKS[bits]:
            eng = make_engine(cfg, backend)
            k = key2m if backend == "nussbaumer" else key
            prep = eng.prepare(k)
            torch.cuda.synchronize()
            K.reset_launches()
            got = eng.accumulate(x, prep)
            torch.cuda.synchronize()
            counts = {n: getattr(K, n).launches
                      for n in ("materialize_w", "materialize_wt",
                                "mm_recombine_acc")}
            ref = want["key2m" if backend == "nussbaumer" else "key"]
            check(got.device == x.device and got.dtype == ref.dtype
                  and got.shape == ref.shape,
                  f"engine {backend} {bits}-bit: {got.dtype} "
                  f"{tuple(got.shape)} on {got.device}")
            if backend in FFT_BOUND:
                d = (got.to(torch.int64) - ref.to(torch.int64)).to(
                    torch.int32).abs().max()
                err = int(d)
                check(err <= FFT_BOUND[backend], f"engine {backend}: max "
                      f"error {err} > {FFT_BOUND[backend]}")
                what = f"max error {err} <= {FFT_BOUND[backend]}"
            else:
                check(torch.equal(got, ref), f"engine {backend} {bits}-bit: "
                      f"differs from the exact yardstick")
                what = "bit-exact"
            if backend.startswith("conv"):
                launched = ({"materialize_w": 1, "materialize_wt": 0,
                             "mm_recombine_acc": cfg.plane_split[1]}
                            if bits == 32 else {"materialize_w": 0,
                                                "materialize_wt": 1,
                                                "mm_recombine_acc": 0})
                check(counts == launched,
                      f"engine {backend} {bits}-bit: launches {counts}")
            else:
                check(not any(counts.values()),
                      f"engine {backend} {bits}-bit: launches {counts}")
            if backend in CALL_TIMED:
                # hundreds (nussbaumer) to thousands (fft_dd) of kernels a
                # call: more than the launch queue holds while device_ms
                # stalls the stream, so the host waits and the stall cannot
                # hide it; CUDA events around back-to-back calls instead
                ms, how = cuda_ms(lambda: eng.accumulate(x, prep), 3), "call"
            else:
                ms, how = device_ms(lambda: eng.accumulate(x, prep), 10), ""
            line.append(f"{backend} {ms:.4f} {how + ' ' if how else ''}ms "
                        f"({what}; {counts})")
            del prep, got
        ms = device_ms(lambda: exact.accumulate(x, prep_exact), 10)
        print(f"phase 8 engines {bits}-bit (N={N}, J={J}, U={U}, "
              f"L={cfg.num_limbs}) B={batch}, device ms of one accumulate: "
              + "; ".join(line) + f"; yardstick "
              f"{'onthefly' if bits == 32 else 'chunked'} {ms:.4f} ms "
              f"[{smi}]")
        del x, key, key2m, want, prep_exact
        torch.cuda.empty_cache()


def phase_engine_paths(smi: str, default_out, cb_state: dict):
    """The engines on the paths at full width: GATE_DEFAULT B=256 from phase
    4's seed on conv (every ciphertext equal to phase 4's onthefly ones),
    on nussbaumer and on fft_f64 (every bit decrypts, the gate_nand truth
    table holds); then the CB_MXU circuit bootstrap B=256 on conv with the
    key prepared from phase 5's raw TRGSWs (every TRGSW equal to phase 5's
    chunked ones).  Returns the launch counts by path."""
    from tfhe_tpu_torch import device
    from tfhe_tpu_torch.boot import circuit, gate
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import CB_MXU, GATE_DEFAULT
    from tfhe_tpu_torch.rng import TfheRng
    P, n, batch = GATE_DEFAULT, GATE_DEFAULT.lwe.n, default_out.shape[0]
    bits = np.random.default_rng(2).integers(0, 2, batch)
    by_path = {}
    for backend, kernels in (
            ("conv", {"rotate_decompose": n, "materialize_w": n,
                      "mm_recombine_acc": n}),
            ("nussbaumer", {"rotate_decompose": n}),
            ("fft_f64", {"rotate_decompose": n})):
        sk, ck, out, wall, counts, keygen_s, peak_gb = _gate_run(
            P, backend, bits, 1)
        _only(counts, kernels, f"GATE_DEFAULT {backend}")
        if backend == "conv":
            check(torch.equal(out, default_out), "GATE_DEFAULT conv: the "
                  "ciphertexts differ from phase 4's onthefly ones")
            same = "equal phase 4's onthefly ciphertexts bit for bit"
        else:
            xs = np.array([0, 0, 1, 1, 0, 0, 1, 1])
            ys = np.array([0, 1, 0, 1, 0, 1, 0, 1])
            rng = TfheRng(9)
            cx, cy = (gate.encrypt_bool(sk, b, rng) for b in (xs, ys))
            nand = gate.decrypt_bool(sk, gate.gate_nand(ck.data, cx, cy, P,
                                                        backend))
            check((nand == ~(xs & ys).astype(bool)).all(),
                  f"GATE_DEFAULT {backend}: gate_nand truth table")
            same = "gate_nand truth table right"
        del ck
        by_path[f"gate_default_{backend}"] = counts
        print(f"phase 9 GATE_DEFAULT {backend} B={batch}: "
              f"{batch / wall:.1f} ct/s, {wall * 1e3 / batch:.3f} ms per "
              f"ciphertext ({wall:.3f} s for one launch), all {batch} bits "
              f"decrypt, {same}; launches {counts}, keygen {keygen_s:.1f} s, "
              f"peak device memory {peak_gb:.2f} GB [{smi}]")
        torch.cuda.empty_cache()

    # the CB_MXU circuit bootstrap on conv, the JAX package's default
    P, dev = CB_MXU, device.resolve(None)
    ct, steps = cb_state["ct"], cb_state["steps"]
    batch = ct.shape[0]
    t0 = time.perf_counter()
    bk = circuit.prepare_circuit_bk(cb_state["bk_raw"].to(dev), P, "conv")
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    data = {"preks": cb_state["preks"], "bk": bk,
            "privks": cb_state["privks"]}
    cb = circuit.make_circuit_bootstrap_staged(P, backend="conv")
    torch.cuda.reset_peak_memory_stats()
    cb(ct, data)                        # untimed: first-use set-up
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    gsw = cb(ct, data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = _launch_counts()
    check(torch.equal(gsw, cb_state["gsw"]), "CB_MXU conv: the TRGSWs "
          "differ from phase 5's chunked ones")
    _only(counts, {"materialize_wt": steps}, "CB_MXU conv")
    by_path["circuit_bootstrap_conv"] = counts
    print(f"phase 9 CB_MXU conv B={batch}: {wall * 1e3 / batch:.3f} ms per "
          f"ciphertext, {batch / wall:.2f} ct/s ({wall:.3f} s for one launch, "
          f"{steps} steps: {wall * 1e3 / steps:.3f} ms a step), TRGSWs "
          f"bit-identical to phase 5's chunked ones; key prepared from the "
          f"raw bk in {prep_s:.2f} s ({_nbytes(bk['k']) / 1e6:.0f} MB), peak "
          f"device memory {peak_gb:.2f} GB; launches {counts} [{smi}]")
    return by_path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_device()
    results = phase_kernels()
    phase_tiles(results["fused_cmux_step_v2"])
    phase_parts(results["fused_cmux_step_v2"])
    phase_splits(results)
    by_path = {}
    by_path["gate_fast2"], _ = phase_main(smi)
    by_path["gate_default"], default_out = phase_generic(smi)
    by_path["circuit_bootstrap"], state = phase_circuit(smi)
    for phase, step, *run in CK64_STEPS:
        by_path[f"circuit_bootstrap_{step}"] = phase_circuit_step(
            smi, state, phase, step, *run)
    ck = state.pop("ck")                # phase 9 keeps the raw bk alone
    state.update(preks=ck.data["preks"], privks=ck.data["privks"],
                 bk_raw=ck.bk_raw)
    del ck
    torch.cuda.empty_cache()
    paths, keys = phase_n1024(smi, default_out)
    by_path.update(paths)
    by_path.update(phase_circuits(smi, keys))
    del keys
    torch.cuda.empty_cache()
    phase_engines(smi)
    by_path.update(phase_engine_paths(smi, default_out, state))
    from tfhe_tpu_torch.ops import kernels as K
    check(len(results) == len(K.KERNELS), f"phase 2 checked "
          f"{len(results)} of {len(K.KERNELS)} kernels")
    for name, entry in results.items():
        entry["launches_by_path"] = {path: counts[name]
                                     for path, counts in by_path.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        check(entry["launches"] > 0 or name in TEST_ONLY,
              f"{name} never launched on a path")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [results[k.__name__] for k in K.KERNELS]}))
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
