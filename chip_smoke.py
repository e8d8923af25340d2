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
     materialize_w (GATE_DEFAULT's and GATE_FAST2's keys; on no path) and
     its K-packed entry materialize_wt (GATE_DEFAULT's, GATE_FAST2's, an
     ep=3 slice of it, GATE_MXU's and CB_MXU lvl2's, the conv circuit
     path's keys), the
     fused step (wgmma + TMA on the K-packed key) at GATE_FAST2 B=8192 and
     B=1024 and GATE_MXU B=8192, the v1 fused step at GATE_FAST2 and
     GATE_MXU B=8192 (also equal to v2's kernel), the 64-bit kernels (and
     the fused-epilogue pair, the limb-grid contraction and the plain-layout
     digits, which re-laid out must equal the chunk-layout kernel's) at
     CB_MXU, CB_ACTIVE and CB_PAPER B=256, the four 64-bit contractions on the
     K-packed key wmt with their chosen plans, ck_dot64p and ck_dot64p_sacc
     also at CB_MXU tails B=1, 3, 100 and at a 4-bit query's B=4 at
     CB_ACTIVE and CB_PAPER (their key-stationary plans; ck_dot64p_sacc
     beside ck_dot64p + the torch epilogue it replaces),
     rotate_decompose64_ck also at CB_MXU B=1, 3, 100,
     the one-kernel 64-bit step there (CB_PAPER's J*m = 768 on the
     64-row plan) and at CB_MXU tails B=1, 3, 100
     (beside the two-kernel default and acc steps it replaces),
     ck_cmux_step32 at GATE_MXU B=8192, GATE_DEFAULT B=256, GATE_MXU
     B=256 and 512 (the adder's narrow launches) and tail batches B=1, 3,
     100, with the flat carry; mm_recombine_acc_wt (wgmma + TMA on the
     K-packed key) at GATE_DEFAULT B=8192, 628 and 256; priv_keyswitch
     (program C's kernel on the packed privKS table) at CB_ACTIVE and
     CB_PAPER B=4 and 256, its library yardsticks the old product (four
     torch._int_mm on the row-major table) and one torch._int_mm on the
     K-packed table (library_kpacked_ms); lut_cmux (a level of the LUT's
     CMux tree, a selector per group) at CB_ACTIVE's lvl1 with 64 groups
     of 8 and 1 rows and one of 8, its library yardstick one
     torch._int_mm of the same MACs on one materialized key; the two kernels
     whose reduction is split over blocks (mm_recombine_acc_wt,
     ck_cmux_step32) also with split=1 forced, equal to the chosen
     (tile_rows, S) plan; then the fused step's 64-
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
     ineligible) at B=256: rotate_decompose + materialize_wt +
     mm_recombine_acc_wt, 630 of each per launch, decrypt-correct; each
     kernel's device time and share of a step and of the launch;
  5. circuit bootstrap: CB_MXU (n0=500, N1=1024, N2=2048 Torus64, lvl2
     Bg=2^8/l=5, 6-limb bk) at B=256 on the chunked engine through
     CircuitCloudKey.generate (seconds per keygen.circuit.* span) /
     make_circuit_bootstrap_staged, one untimed launch, then a timed one;
     every step must go through rotate_decompose64_ck + ck_dot64p_sacc
     (1,000 of each per launch: two 500-step rotations) on the prepared K-packed key
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
     chunked keys, at TFHE_WAVE_CHAIN=1 and 4 (a first run capturing the
     programs, then a timed one); every sum and comparison must decode
     right;
  8. engines: conv, conv_bf16, nussbaumer, fft_f64 and fft_dd at
     GATE_DEFAULT's engine config (N=1024, 32 bits, J=6, U=2, 4 limbs) and
     conv and nussbaumer at CB_MXU lvl2's (N=2048, Torus64, J=10, U=2, 6
     limbs), B=256, from one seed: the exact ones bit for bit against
     onthefly (32 bits) and chunked (64 bits), nussbaumer on keys it is
     exact on, fft_f64 within 2^4 and fft_dd within 2^8; each one
     accumulate's device ms (call ms for nussbaumer and fft_dd, whose
     hundreds of kernels a call overflow the launch queue) and launches of
     materialize_w, materialize_wt and mm_recombine_acc_wt;
  9. engine paths: GATE_DEFAULT B=256 from phase 4's seed on conv (every
     ciphertext equal to phase 4's onthefly ones; 630 rotate_decompose,
     materialize_wt and mm_recombine_acc_wt a launch), on nussbaumer and on
     fft_f64 (every bit decrypts, the gate_nand truth table holds); the
     CB_MXU circuit bootstrap B=256 on conv, JAX's default backend, its key
     prepared from phase 5's raw TRGSWs (every TRGSW equal to phase 5's
     chunked ones; 1,000 materialize_wt a launch); ct/s and ms per
     ciphertext;
  10. graphs: the launches of phases 3-9 run as captured CUDA graphs
     (tfhe_tpu_torch.graphs; every launch count above counts replays), each
     cell's first call capturing its programs; here every cell (GATE_FAST2
     B=8192; GATE_DEFAULT B=256 onthefly, chunked, conv, nussbaumer and
     fft_f64;
     GATE_MXU B=8192 chunked and onthefly; CB_MXU B=256 on the default,
     acc, sacc and FUSED steps; the adder and comparator at
     TFHE_WAVE_CHAIN=1 and 4), run again under graphs.disable(), must give
     the graphed output bit for bit; printed: both walls, the card's busy
     time of a graphed run (torch.profiler) and the idle share of each wall,
     the first run's seconds, captures, capture and instantiation ms, graph
     nodes, pool bytes and replays; then one step's product of nussbaumer
     and fft_dd captured for its node count (graphs.EAGER_BACKENDS), and
     ops.hpfft.hp_negacyclic_mul at N=1024, limbs 6 and 8, on the card
     against the CPU bit for bit, with its time;
  11. several ranks (tfhe_tpu_torch.parallel), each a process of this
     script (``chip_smoke.py --rank JOB DIR``, started by
     parallel.multihost.launch) sharing this one card over gloo (NCCL
     refuses two ranks on one device): 11a the dp x ep gate bootstrap
     (shard) at GATE_FAST2 on the onthefly engine, (dp, ep) = (1, 3) at
     B=1024 and (2, 1) at B=2048; 11b the dp x tp formulation (mesh) at
     (1, 2), B=1024; 11c the CB_MXU circuit bootstrap at (1, 2), B=256, on
     the chunked engine, each rank building its half of wmt from the raw
     TRGSW rows; 11d one rank on the default backend (NCCL), GATE_FAST2
     B=8192.  Every rank's rows must equal phase 3's (the gate paths) or
     phase 5's (the circuit) one-process outputs bit for bit and decrypt;
     each rank must launch, a launch, 500 each of rotate_decompose,
     materialize_wt (at J=3 under ep=3) and mm_recombine_acc_wt on the shard
     gate path, 500 materialize_wt and fused_cmux_step_v2 on the tp path,
     1,000 rotate_decompose64 and ck_dot64p (J*m = 320) on the circuit
     path, and no other CMux kernel; printed: each rank's wall a launch,
     the all-reduce's share of it and its key slice's bytes (ranks share
     one card: not a scaling figure).  Phase 2 holds the kernels at these
     shapes too (materialize_wt J=3, rotate_decompose and mm_recombine_acc_wt
     at GATE_FAST2 B=1024, K=1536, ck_dot64p at J*m = 320);
  12. the reference's parameter blocks: CB_PAPER (l1=4; lvl2 Bg=2^9/l2=6,
     J*m = 768; base-2 key switches) and CB_ACTIVE (l1=2; Bg=2^9/l2=4),
     each with its whole 8-limb lvl2 key (two digit planes), after the
     CB_MXU state is freed: keys generated on the card (seconds, peak),
     the default step's graphed launch at B=256 (64 four-bit LUT instances;
     one untimed, one timed; 2,000 rotate_decompose64_ck + ck_dot64p_sacc at
     CB_PAPER, 1,000 at CB_ACTIVE, and no other CMux kernel), every row
     within 2^-8 of the torus of its expected phase (the JAX package's
     probe rule, boot.probe), the (z=1) rows within h_w/4 at the levels
     where that clears 6 sigma of the noise worksheet (cleared_levels), a
     CMux with its digit on the last of those levels, all 64 LUTs decoded
     through models.lut.make_lut_staged (the launch's programs and the
     tree's: k lut_cmux launches more, the answers equal to the tree on
     the launch's TRGSWs; the tree's device time alone beside its bound);
     then the acc, sacc and FUSED steps on the same keys and inputs, each
     TRGSW-identical to the default and launching exactly its kernels;
     ms per ciphertext, the keygen and launch peaks, the programs' pools.

The line before the last is a JSON object with one entry per kernel (the
test-only fused_cmux_step v1 runs on no path, as in the JAX package, and
counts 0 launches, as does materialize_w, whose layout no product of the
port reads; rotate_decompose64 runs on phase 11's sharded circuit path); the last line is {"ok": true, "device": {...}}.  Exits non-zero, with no result,
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
# graphed against eager (phase 10's cells, recorded by phases 3-9)
# ---------------------------------------------------------------------------

GRAPH_CELLS = []          # one dict per cell, printed by phase 10


def busy_ms(fn):
    """Milliseconds the card is busy during one call of fn(): the sum of
    the kernel, copy and fill durations torch.profiler records (graph
    replays included); None where it records none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == cuda)
    return us / 1e3 if us > 0 else None


def cell_start():
    """Drop every cached program (its pool and key references with it), so
    that the cell's first calls capture its programs alone."""
    from tfhe_tpu_torch import graphs
    graphs.clear()
    torch.cuda.empty_cache()


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_same, a, b))
    return torch.equal(a, b)


def graph_cell(cell: str, fn, graphed_out, graphed_wall: float,
               first_wall: float):
    """Record a cell for phase 10.  fn() runs the cell's timed work (a
    launch, a chain of launches or a circuit) and returns its output; its
    graphed run gave ``graphed_out`` in ``graphed_wall`` s, after a first
    run of ``first_wall`` s that captured the cell's programs (cell_start
    cleared the cache before it).  Runs fn() under graphs.disable(), timed,
    and requires the same output bit for bit; takes the card's busy time
    of one graphed run (busy_ms); reads the cached programs' captures,
    replays, nodes and pool bytes."""
    from tfhe_tpu_torch import graphs
    programs = graphs.stats()
    torch.cuda.synchronize()
    with graphs.disable():
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        eager_wall = time.perf_counter() - t0
    check(_same(out, graphed_out), f"{cell}: the graphed and eager outputs "
          f"differ")
    del out
    busy = busy_ms(fn)
    nodes = [p["nodes"] for p in programs]
    GRAPH_CELLS.append({
        "cell": cell, "graphed_s": graphed_wall, "eager_s": eager_wall,
        "first_s": first_wall, "busy_ms": busy, "captures": len(programs),
        "replays": sum(p["replays"] for p in programs),
        "nodes": None if None in nodes else sum(nodes),
        "capture_ms": sum(p["capture_ms"] for p in programs),
        "instantiate_ms": sum(p["instantiate_ms"] for p in programs),
        "pool_bytes": sum(p["pool_bytes"] for p in programs)})


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
    from tfhe_tpu_torch.params import (CB_ACTIVE, CB_MXU, CB_PAPER,
                                       GATE_DEFAULT, GATE_FAST2, GATE_MXU)
    r = np.random.default_rng(seed)
    cases = []

    def i8(shape, lo=-128, hi=128):
        return torch.from_numpy(r.integers(lo, hi, shape).astype(np.int8))

    def i32(shape):
        return torch.from_numpy(
            r.integers(-2**31, 2**31, shape).astype(np.int32))

    def expo(B, N):
        return torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))

    # materialize_w (on no path; the JAX package's layout): GATE_DEFAULT's
    # step key (L=4, J=6, U=2, 2N=2048) and GATE_FAST2's (L=3, J=9, U=3,
    # 2N=1024); materialize_wt, the K-packed entry: GATE_DEFAULT's key (its
    # onthefly and conv paths), GATE_FAST2's, an ep=3 rank's J=3 slice of it
    # (phase 11's shard path), GATE_MXU's (L=3, J=6, U=2, 2N=2048) and
    # CB_MXU lvl2's (L=6, J=10, U=2, 2N=4096: the conv circuit path).
    # Library: torch.flip of the rotated vector's windows (flip_w, flip_wt)
    v_default, v_fast2 = i8((4, 6, 2, 2048)), i8((3, 9, 3, 1024))
    for name, wrapper, plain, lib, keys in (
            ("materialize_w", K.materialize_w, K.materialize_w_plain,
             "flip_w", (v_default, v_fast2)),
            ("materialize_wt", K.materialize_wt, K.materialize_wt_plain,
             "flip_wt", (v_default, v_fast2, i8((3, 3, 3, 1024)),
                         i8((3, 6, 2, 2048)), i8((6, 10, 2, 4096))))):
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

    # rotate_decompose + mm_recombine_acc_wt: GATE_DEFAULT (N=1024, k=1,
    # l=3, L=4) at B=256; the product also at the wide cell's B=8192 (its
    # path's shape, first) and the adder's mean launch, 628 rows; the
    # K-packed key wt (L, U*N, K), as materialize_wt builds it
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
    wt = i8((L, kp1 * N, kp1 * l * N))
    wcat = wt.permute(2, 0, 1).reshape(kp1 * l * N, L * kp1 * N)
    for B in (8192, 628, 256):
        x = i8((B, kp1 * l * N), -64, 64)
        acc = i32((B, kp1 * N))
        macs = B * kp1 * l * N * kp1 * N * L
        cases.append(("mm_recombine_acc_wt", f"GATE_DEFAULT B={B}",
                      "csrc/mm_recombine_acc.cu",
                      f"{PALLAS}:1535", K.mm_recombine_acc_wt,
                      K.mm_recombine_acc_wt_plain, (x, wt, acc),
                      {"shift_base": 0},
                      bound_ms(_nbytes(x, wt, acc, acc), macs),
                      ("_int_mm", (x, wcat)), True))

    # phase 11's shard path at GATE_FAST2 (k=2, l=3, N=512, L=3), B=1024:
    # the whole accumulator's digits, then an ep=3 rank's J=3 slice
    # (K = 3*512) against its key slice
    p = GATE_FAST2.tgsw
    B, kp1, l, N, L, J = 1024, 3, 3, 512, 3, 3
    acc = i32((B, kp1, N))
    a = expo(B, N)
    kw = dict(l=l, bgbit=p.bgbit, offset=p.offset)
    cases.append(("rotate_decompose", f"GATE_FAST2 B={B}",
                  "csrc/rotate_decompose.cu", f"{PALLAS}:163",
                  K.rotate_decompose, K.rotate_decompose_plain, (a, acc), kw,
                  bound_ms(_nbytes(a, acc) + B * kp1 * l * N), None, False))
    x = i8((B, J * N), -64, 64)
    wt = i8((L, kp1 * N, J * N))
    wcat = wt.permute(2, 0, 1).reshape(J * N, L * kp1 * N)
    cases.append(("mm_recombine_acc_wt", f"GATE_FAST2 ep=3 B={B}",
                  "csrc/mm_recombine_acc.cu", f"{PALLAS}:1535",
                  K.mm_recombine_acc_wt, K.mm_recombine_acc_wt_plain,
                  (x, wt, acc), {"shift_base": 8},
                  bound_ms(_nbytes(x, wt, acc, acc), B * J * N * kp1 * N * L),
                  ("_int_mm", (x, wcat)), False))

    # rotate_decompose64_ck + ck_dot64p: the circuit bootstrap's lvl2 step at
    # B=256, CB_MXU (l=5, Bg=2^8: one plane, 6 key limbs), then the
    # reference's blocks of phase 12 (two planes, 8 key limbs): CB_ACTIVE
    # (l=4, Bg=2^9, J*m = 512) and CB_PAPER (l=6, Bg=2^9, J*m = 768); the
    # 64-bit contractions read the K-packed key wmt (UL, N+m, J*m), as
    # ChunkedEngine.prepare builds it
    B, kp1, N, m = 256, 2, 2048, CB_M
    C = N // m
    for label, p, L in (("CB_MXU", CB_MXU.tgsw_lvl2, 6),
                        ("CB_ACTIVE", CB_ACTIVE.tgsw_lvl2, 8),
                        ("CB_PAPER", CB_PAPER.tgsw_lvl2, 8)):
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

    # ck_dot64p at phase 11's shard path: an ep=2 rank's J*m = 5*64 = 320
    # columns of CB_MXU's wmt, B=256 (one plane, 6 limbs)
    p, L, B = CB_MXU.tgsw_lvl2, 6, 256
    Jm, UL = kp1 * p.l * m // 2, kp1 * L
    x = i8((B, C * K.ck_width(Jm)))
    wmt = i8((UL, N + m, Jm))
    cases.append(("ck_dot64p", f"CB_MXU ep=2 B={B}", "csrc/ck_dot64p.cu",
                  f"{PALLAS}:835", K.ck_dot64p, K.ck_dot64p_plain, (x, wmt),
                  dict(N=N, m=m, planes=1),
                  bound_ms(_nbytes(x, wmt) + UL * B * N * 4,
                           B * UL * N * (Jm // m) * N),
                  ("_int_mm", (x.reshape(B * C, K.ck_width(Jm))[:, :Jm]
                               .contiguous(), _wcat(wmt))), True))

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

    # ck_dot64p and ck_dot64p_sacc (the default step's contraction) at a
    # 4-bit query's B=4 (C*B = 128 stacked rows: the key-stationary plans) at
    # CB_ACTIVE (two planes, J*m = 512, 16 limb rows) and CB_PAPER (J*m =
    # 768)
    B = 4
    for label, p, L in (("CB_ACTIVE", CB_ACTIVE.tgsw_lvl2, 8),
                        ("CB_PAPER", CB_PAPER.tgsw_lvl2, 8)):
        Jm, UL = kp1 * p.l * m, kp1 * L
        x = i8((B, C * 2 * K.ck_width(Jm)), -64, 65)
        wmt = i8((UL, N + m, Jm))
        macs = 2 * B * UL * N * (Jm // m) * N
        lib = ("_int_mm", (x.reshape(B * C * 2, Jm), _wcat(wmt)))
        cases.append(("ck_dot64p", f"{label} B={B}", "csrc/ck_dot64p.cu",
                      f"{PALLAS}:835", K.ck_dot64p, K.ck_dot64p_plain,
                      (x, wmt), dict(N=N, m=m, planes=2),
                      bound_ms(_nbytes(x, wmt) + UL * B * N * 4, macs), lib,
                      True))
        acc_flat = torch.from_numpy(r.integers(-2**63, 2**63, (B, kp1 * N),
                                               dtype=np.int64))
        cases.append(("ck_dot64p_sacc", f"{label} B={B}",
                      "csrc/ck_dot64p_sacc.cu", f"{PALLAS}:966",
                      K.ck_dot64p_sacc, K.ck_dot64p_acc_plain,
                      (x, wmt, acc_flat),
                      dict(N=N, m=m, planes=2, kp1=kp1, key_shift=64 - 8 * L),
                      bound_ms(_nbytes(x, wmt, acc_flat, acc_flat), macs),
                      lib, True))

    # ck_cmux_step64: the whole 64-bit step on the flat accumulator at
    # CB_MXU, CB_ACTIVE and CB_PAPER B=256, then CB_MXU tail batches
    for label, p, L, B in (("CB_MXU", CB_MXU.tgsw_lvl2, 6, 256),
                           ("CB_ACTIVE", CB_ACTIVE.tgsw_lvl2, 8, 256),
                           ("CB_PAPER", CB_PAPER.tgsw_lvl2, 8, 256),
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

    # priv_keyswitch (program C, one product a (w, z)): CB_ACTIVE (t=10,
    # base 8) and CB_PAPER (t=32, base 2) at the query's B=4 and the
    # launches' B=256, on a random packed table of one z made on the card
    # (1.175 and 0.537 GB); bound by the table's bytes.  Library: the
    # product program C ran before, four torch._int_mm on a row-major
    # (4, (n+1) t base, 2048) table; and one torch._int_mm on the K-packed
    # table (ROADMAP K2's lever 1), "library_kpacked_ms"
    g = torch.Generator(device="cuda").manual_seed(seed)
    for label, P in (("CB_ACTIVE", CB_ACTIVE), ("CB_PAPER", CB_PAPER)):
        ks, n1, UN = P.ks21, P.n_lvl2 + 1, 2 * P.n_lvl1
        kq = K.privks_depth(n1, ks.t, ks.basebit)
        table = torch.zeros((4, UN, -(-kq // 16) * 16), dtype=torch.int8,
                            device="cuda")
        table[..., :kq] = torch.randint(-128, 128, (4, UN, kq),
                                        dtype=torch.int8, device="cuda",
                                        generator=g)
        rowmajor = torch.randint(-128, 128, (4, n1 * ks.t * ks.base, UN),
                                 dtype=torch.int8, device="cuda", generator=g)
        for B in (4, 256):
            x = torch.from_numpy(r.integers(-2**63, 2**63, (B, n1),
                                            dtype=np.int64))
            onehot = torch.zeros((max(B, 32), n1 * ks.t * ks.base),
                                 dtype=torch.int8)
            cases.append(("priv_keyswitch", f"{label} B={B}",
                          "csrc/priv_keyswitch.cu", "none (XLA)",
                          K.priv_keyswitch, K.priv_keyswitch_plain,
                          (x, table), dict(t=ks.t, basebit=ks.basebit),
                          bound_ms(_nbytes(x, table[..., :kq]) + B * UN * 4,
                                   B * kq * UN * 4),
                          ("privks_int_mm", (onehot, rowmajor)), True))

    # lut_cmux (a level of the LUT's CMux tree, a selector per group):
    # CB_ACTIVE's lvl1 (k=1, l=2, Bg=2^8, N=1024) at the cell's 64 four-bit
    # LUTs, level 0 (8 rows a group, the 16 leaves shared) and level 3 (one
    # row), then one LUT.  Library: one torch._int_mm of every row's digits
    # against one selector's materialized 4-limb key (the same MACs, with
    # one key for all groups: no key a group)
    p1 = CB_ACTIVE.tgsw_lvl1
    N, J = p1.tlwe.N, 2 * p1.l
    for G, S in ((64, 8), (64, 1), (1, 8)):
        acc = i32((2 * S, 2, N)).expand(G, 2 * S, 2, N) if S == 8 \
            else i32((G, 2 * S, 2, N))
        sel = i32((G, 2, p1.l, 2, N))
        wcat = torch.from_numpy(r.integers(-128, 128, (J * N, 4 * 2 * N))
                                .astype(np.int8))
        cases.append(("lut_cmux", f"CB_ACTIVE lvl1 G={G} S={S}",
                      "csrc/lut_cmux.cu", "none (vmapped tgsw.cmux)",
                      K.lut_cmux, K.lut_cmux_plain, (acc, sel),
                      dict(l=p1.l, bgbit=p1.bgbit, offset=p1.offset),
                      bound_ms(_nbytes(acc[0] if S == 8 else acc, sel)
                               + G * S * 2 * N * 4,
                               G * S * J * N * 2 * N * 4),
                      ("_int_mm", (i8((max(G * S, 32), J * N)), wcat)),
                      True))
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


def privks_int_mm(onehot, w):
    """The product program C ran before PR 23 (lwe._int8_matmul on each
    limb of the row-major privKS table)."""
    return [torch._int_mm(onehot, w[lm]) for lm in range(w.shape[0])]


def privks_kpacked_onehot(x, table, *, t, basebit):
    """The digit-0-free one-hot of x, its rows padded to 32 and its columns
    to the packed table's stride: the left operand of
    privks_int_mm_kpacked."""
    from tfhe_tpu_torch.ops import kernels as K
    onehot = K.privks_onehot(x, t=t, basebit=basebit)
    a = torch.zeros((max(x.shape[0], 32), table.shape[-1]), dtype=torch.int8,
                    device=x.device)
    a[:x.shape[0], :onehot.shape[1]] = onehot
    return a


def privks_int_mm_kpacked(a, table):
    """One torch._int_mm of the padded one-hot ``a`` against the packed
    table's 4 limbs stacked, K-major (ROADMAP K2's lever 1: the layout
    cuBLAS takes fastest; the port never calls it)."""
    return torch._int_mm(a, table.reshape(-1, table.shape[-1]).t())


# the library yardsticks of phase 2's cases, by name
LIBRARY = {"_int_mm": torch._int_mm, "flip_w": flip_w, "flip_wt": flip_wt,
           "privks_int_mm": privks_int_mm}


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
        if name == "priv_keyswitch":           # ROADMAP K2's lever 1
            x, table = dev_args
            a = privks_kpacked_onehot(x, table, **kw)
            numbers["library_kpacked_ms"] = device_ms(
                lambda: privks_int_mm_kpacked(a, table), reps)
            kq = K.privks_depth(x.shape[1], kw["t"], kw["basebit"])
            numbers["plan"] = K.priv_keyswitch_plan(
                x.shape[0], kq, table.shape[1], K.sm_count(x.device))
            split_txt = (f", plan (rows, split, blocks) = {numbers['plan']}"
                         f", one _int_mm on the K-packed table "
                         f"{numbers['library_kpacked_ms']:.4f} ms")
            del a
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
            two_txt = (f", default step "
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
SPLIT_KERNELS = ("mm_recombine_acc_wt", "ck_cmux_step32")
# the 64-bit contractions on the K-packed key wmt, and what their plans hold
K64_PLANS = {"ck_dot64p": "rows, kst", "ck_dot64p_sacc": "rows, kst",
             "ck_dot64p_acc": "rows, limbs", "ck_cmux_step64": "rows, split"}


def _k64_plan(name, dev_args, kw):
    """The plan the wrapper of ``name`` chooses for these inputs: (rows,
    key-stationary) of a ck_dot64p or ck_dot64p_sacc block, (rows, limbs) of a ck_dot64p_acc block, (rows, split) of a
    ck_cmux_step64 launch."""
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
                                kw["planes"], entry=name)
    return K.ck_dot64p_acc_plan(x.shape[0], kw["N"], kw["m"], Jm,
                                UL // kw["kp1"], kw["planes"])


def _plan(name, dev_args, kw):
    """(tile_rows, S) the wrapper of ``name`` chooses for these inputs."""
    from tfhe_tpu_torch.ops import kernels as K
    if name == "mm_recombine_acc_wt":
        x, wt, _ = dev_args
        L, UN, Kd = wt.shape
        return K.mm_recombine_acc_plan(x.shape[0], Kd, UN,
                                       K.sm_count(x.device))[:2]
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
    K_, UN, L = 6144, 2048, 4                  # GATE_DEFAULT's generic step
    wt = i8((L, UN, K_))
    for B in (256, 628, 768):
        x, acc = i8((B, K_), -64, 64), i32((B, UN))
        want = K.mm_recombine_acc_wt_plain(x, wt, acc)
        row = {"shape": f"GATE_DEFAULT B={B}", "chosen": _plan(
            "mm_recombine_acc_wt", (x, wt, acc), {}), "ms": {}}
        for S in (1, 2, 3, 4, 6, 8, 12):
            def run():
                return K.mm_recombine_acc_wt(x, wt, acc, split=S)
            _compare(f"mm_recombine_acc_wt B={B} split={S}", run(), want)
            row["ms"][f"{row['chosen'][0]}x{S}"] = device_ms(run, reps)
        rows.append(row)
        print(f"phase 2 splits mm_recombine_acc_wt {row['shape']} chosen "
              f"{row['chosen']} (rows x S: device ms): {row['ms']}")
        del x, acc, want
    results["mm_recombine_acc_wt"]["splits"] = rows
    del wt

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
    """The default 64-bit step (rotate_decompose64_ck + ck_dot64p_sacc) on
    the flat accumulator: what ck_cmux_step64 replaces."""
    from tfhe_tpu_torch.ops import kernels as K
    B, N = acc.shape[0], acc.shape[1] // kp1
    x = K.rotate_decompose64_ck(a, acc.view(B, kp1, N), l=l, bgbit=bgbit,
                                offset=offset, m=m, planes=planes)
    return K.ck_dot64p_sacc(x, wmt, acc, N=N, m=m, key_shift=key_shift,
                            planes=planes, kp1=kp1)


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


# the kernel wrappers, in the order of pallas_kernels.py (PERF.md's kernel
# table); each counts its launches as ``kernel.<name>`` in
# utils.observability
KERNELS = ("materialize_w", "materialize_wt", "rotate_decompose",
           "fused_cmux_step", "fused_cmux_step_v2", "rotate_decompose64",
           "rotate_decompose64_ck", "rotate_decompose64_ck_flat", "ck_dot64p",
           "ck_dot64p_sacc", "ck_dot64p_acc", "ck_cmux_step32",
           "ck_cmux_step64", "mm_recombine_acc_wt", "priv_keyswitch",
           "lut_cmux")


def _kernel_counters() -> dict:
    """The kernel wrappers' ``kernel.*`` observability counters so far."""
    from tfhe_tpu_torch.utils import observability as obs
    return {k: v for k, v in obs.report()["counters"].items()
            if k.startswith("kernel.")}


def _launch_counts(before: dict) -> dict:
    """Each kernel's launches since the snapshot ``before`` of
    ``_kernel_counters()``, zeros included, and the 32-bit contraction's
    per-call key transposes (``ck_dot64p.transposes``, ck_dot64p_wm)."""
    now = _kernel_counters()
    return {n: now.get(f"kernel.{n}", 0) - before.get(f"kernel.{n}", 0)
            for n in KERNELS + ("ck_dot64p.transposes",)}


def phase_main(smi: str, batch: int = 8192, chain: int = 2):
    from tfhe_tpu_torch.boot import gate
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import GATE_FAST2
    P, n = GATE_FAST2, GATE_FAST2.lwe.n
    rng, sk, ck, keygen_s = _keys(P, "onthefly")
    bits = np.random.default_rng(1).integers(0, 2, batch)
    ct = gate.encrypt_bool(sk, bits, rng)
    boot = gate.make_bootstrap_fn(P, backend="onthefly")
    cell_start()
    t0 = time.perf_counter()
    boot(ck.data, ct)                   # untimed: first-use set-up, capture
    torch.cuda.synchronize()
    first = time.perf_counter() - t0

    def run():
        out = ct
        for _ in range(chain):          # dependent launches, one sync
            out = boot(ck.data, out)
        return out

    before = _kernel_counters()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts(before)
    ok = gate.decrypt_bool(sk, out) == bits.astype(bool)
    check(ok.all(), f"GATE_FAST2: {int((~ok).sum())} of {batch} bits wrong")
    one = boot(ck.data, ct)             # one launch: phase 11's reference
    _only(counts, {"materialize_wt": n * chain,
                   "fused_cmux_step_v2": n * chain}, "GATE_FAST2")
    graph_cell(f"GATE_FAST2 onthefly B={batch} ({chain} launches)", run, out,
               wall, first)
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
                    "ks_ms": ks_ms, "launch_ms": wall / chain * 1e3,
                    "ct": ct.cpu(), "out": one.cpu()}


def phase_generic(smi: str, batch: int = 256):
    from tfhe_tpu_torch.boot import gate
    from tfhe_tpu_torch.ops import kernels as K
    from tfhe_tpu_torch.params import GATE_DEFAULT
    P, n = GATE_DEFAULT, GATE_DEFAULT.lwe.n
    rng, sk, ck, keygen_s = _keys(P, "onthefly")
    bits = np.random.default_rng(2).integers(0, 2, batch)
    ct = gate.encrypt_bool(sk, bits, rng)
    boot = gate.make_bootstrap_fn(P, backend="onthefly")
    cell_start()
    t0 = time.perf_counter()
    boot(ck.data, ct)                   # untimed: first-use set-up, capture
    torch.cuda.synchronize()
    first = time.perf_counter() - t0

    before = _kernel_counters()
    t0 = time.perf_counter()
    out = boot(ck.data, ct)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts(before)
    ok = gate.decrypt_bool(sk, out) == bits.astype(bool)
    check(ok.all(), f"GATE_DEFAULT: {int((~ok).sum())} of {batch} bits wrong")
    for name in ("rotate_decompose", "materialize_wt", "mm_recombine_acc_wt"):
        check(counts[name] == n, f"GATE_DEFAULT: {name} launched "
              f"{counts[name]} times, want {n}")
    for name in ("fused_cmux_step_v2", "materialize_w"):
        check(counts[name] == 0,
              f"GATE_DEFAULT: {name} ran with 4 key limbs")
    graph_cell(f"GATE_DEFAULT onthefly B={batch}", lambda: boot(ck.data, ct),
               out, wall, first)
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
    wt = K.materialize_wt(prep0["v"])
    parts = {
        "rotate_decompose": device_ms(lambda: K.rotate_decompose(a0, acc,
                                                                 **kw)),
        "materialize_wt": device_ms(lambda: K.materialize_wt(prep0["v"])),
        "mm_recombine_acc_wt": device_ms(lambda: K.mm_recombine_acc_wt(
            x, wt, acc.reshape(batch, -1), shift_base=eng.cfg.key_shift))}
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


def check_trgsw_rows(gsw, bits, sk, P, levels=None) -> list:
    """Every TRGSW row (z=1, w) of the batch at each level w of ``levels``
    (None: every level, phase 5's rule at CB_MXU): coefficient 0 within
    h_w/4 of bit * h_w, h_w = 2^(32-(w+1)*bg1), and the other coefficients
    within h_w/4 of 0 (tests/test_circuit_bootstrap.py).  h_w/4 is below
    h_w/2, so a row that encodes the wrong bit fails.  Returns the worst
    error of each level checked."""
    from tfhe_tpu_torch import tgsw
    ph = tgsw.tgsw_phase(gsw, sk.ring_lvl1)          # (B, k+1, ell1, N1)
    bit_t = torch.from_numpy(bits).to(gsw.device)
    worst = []
    for w in range(P.tgsw_lvl1.l) if levels is None else levels:
        h = 1 << (32 - (w + 1) * P.tgsw_lvl1.bgbit)
        row = ph[:, 1, w]
        worst.append(max(int(_torus_dist(row[:, 0], bit_t * h).max()),
                         int(_torus_dist(row[:, 1:], 0).max())))
        check(worst[-1] < h // 4, f"a TRGSW row phase of level {w} is off "
              f"by {worst[-1]} >= h_{w}/4 = {h // 4}")
    return worst


def cleared_levels(P) -> list:
    """The lvl1 levels w where h_w/4 clears 6 sigma of a TRGSW row's noise
    (noise.circuit_bootstrap_variances' final variance, in torus32 units):
    the levels whose rows carry their bit.  CB_MXU, CB_ACTIVE: both; CB_PAPER
    (l1 = 4): 0 and 1 (h_2/4 = 64 and h_3/4 = 0 lie under its sigma of ~512)."""
    from tfhe_tpu_torch import noise
    sigma = noise.circuit_bootstrap_variances(P).final_variance ** 0.5 * 2**32
    p1 = P.tgsw_lvl1
    return [w for w in range(p1.l)
            if (1 << (32 - (w + 1) * p1.bgbit)) // 4 > 6 * sigma]


PROBE_LIMIT = 1 << 24                 # 2^-8 of the torus, in torus32 units


def check_trgsw_probe(gsw, bits, sk, P) -> int:
    """The JAX package's hardware rule (tools/cb_tpu_bench.py: every row
    decrypt-probed by boot.probe.probe_tgsw_rows, within 2^-8 of the torus),
    on every coefficient of every row: row (z, w) has phase K_z * bit * h_w
    with K = [-s1, 1].  Returns the worst distance in torus32 units."""
    from tfhe_tpu_torch.boot import probe
    p1 = P.tgsw_lvl1
    ph, _ = probe.probe_tgsw_rows(gsw, sk.ring_lvl1, p1)
    ph = torch.from_numpy(ph).to(torch.int64)          # (B, k+1, l1, N1)
    s1 = torch.from_numpy(np.asarray(sk.ring_lvl1.key)).to(torch.int64)
    k = s1.shape[0]
    worst = 0
    for w in range(p1.l):
        h = torch.from_numpy(bits).to(torch.int64)[:, None] * p1.h[w]
        for z in range(k + 1):
            if z < k:                                  # -s1[z] * bit * h_w
                want = -h * s1[z][None, :]
            else:                                      # bit * h_w
                want = torch.zeros_like(ph[:, z, w])
                want[:, 0] = h[:, 0]
            worst = max(worst, int(_torus_dist(ph[:, z, w], want).max()))
    check(worst < PROBE_LIMIT, f"a TRGSW row phase is off by {worst} >= "
          f"2^-8 of the torus ({PROBE_LIMIT})")
    return worst


def check_cmux(gsw, bits, sk, P, level=None) -> tuple:
    """A CMux driven by each TRGSW selects d1 for bit 1 and d0 for bit 0.
    d1 - d0 has the digit Bg/4 on level ``level`` (None: the last) at
    coefficient 0, so a row of that level that encodes the wrong bit moves
    the output by (Bg/4) * h_level; the limit is half that.  Returns (worst
    error, limit)."""
    from tfhe_tpu_torch import tgsw, tlwe
    p1, k = P.tgsw_lvl1, P.lvl1.k
    level = p1.l - 1 if level is None else level
    h_last = 1 << (32 - (level + 1) * p1.bgbit)
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


def _lut_inputs(sk, rng, instances: int = 64, lut_bits: int = 4):
    """The 4-bit LUT indices of ``instances`` instances and their bits as
    LWE ciphertexts: instance i's bits, LSB first, are ciphertexts
    i*lut_bits .. i*lut_bits + lut_bits - 1 (bit = 1 encodes as 1/2).
    Returns (the numpy generator, which later draws the tables, indices,
    bits, ciphertexts)."""
    from tfhe_tpu_torch import lwe
    r = np.random.default_rng(5)
    idx = r.integers(0, 1 << lut_bits, instances)
    bits = ((idx[:, None] >> np.arange(lut_bits)) & 1).reshape(-1)
    msgs = np.where(bits == 1, -(1 << 31), 0).astype(np.int32)
    return r, idx, bits, lwe.encrypt(sk.lwe_lvl1, msgs, rng, 2.0**-20)


def lut_table(perm):
    """The table of check_luts: table[v] = perm[v] / 2^lut_bits, torus32."""
    from tfhe_tpu_torch import torus as T
    lut_bits = len(perm).bit_length() - 1
    return T.wrap32(torch.from_numpy(perm.astype(np.int64)
                                     << (32 - lut_bits)))


def check_luts(out, idx, perm, sk, what: str):
    """The outputs (instances, k+1, N1) of a lut_bits-bit LUT per instance,
    table = lut_table(perm), selected by the instance's TRGSWs: every
    output decodes table[idx] exactly."""
    from tfhe_tpu_torch import tlwe
    from tfhe_tpu_torch import torus as T
    instances, lut_bits = len(idx), len(perm).bit_length() - 1
    dec = T.mod_switch_from_torus32(
        tlwe.tlwe_phase(out, sk.ring_lvl1)[:, 0], 1 << lut_bits)
    ok = dec.cpu().numpy() == perm[idx]
    check(ok.all(), f"{what}: {int((~ok).sum())} of {instances} LUT "
          f"outputs wrong")


def _cb_launch(cb, ct, ck):
    """One untimed launch (its captures: cell_start cleared the cache),
    then a timed one with every launch count from 0.  Returns the TRGSWs,
    the first and timed walls and the timed launch's counts."""
    cell_start()
    t0 = time.perf_counter()
    cb(ct, ck.data)                     # untimed: first-use set-up, capture
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    before = _kernel_counters()
    t0 = time.perf_counter()
    gsw = cb(ct, ck.data)
    torch.cuda.synchronize()
    return gsw, first, time.perf_counter() - t0, _launch_counts(before)


def _keyswitch_ms(P, ck, ct) -> tuple:
    """CUDA-event ms of a circuit bootstrap launch's preKS on ``ct`` and of
    one privKS product (program C's kernel on the packed table) on a random
    lvl2 extract batch of its rows."""
    from tfhe_tpu_torch import lwe
    from tfhe_tpu_torch.ops import kernels as K
    preks = lwe.KeySwitchKey(P.ks10, P.n_lvl1, P.n_lvl0, ck.data["preks"])
    ext = torch.randint(-2**63, 2**63 - 1, (ct.shape[0], P.n_lvl2 + 1),
                        dtype=torch.int64, device=ct.device)
    table = ck.data["privks_packed"][0]
    return (cuda_ms(lambda: lwe.keyswitch(ct, preks), 5),
            cuda_ms(lambda: K.priv_keyswitch(ext, table, t=P.ks21.t,
                                             basebit=P.ks21.basebit), 5))


def phase_circuit(smi: str):
    """CB_MXU circuit bootstrap of the 4 bits of each of 64 random LUT
    indices, then the LUTs they select.  Returns the launch counts of the
    timed launch and its numbers."""
    from tfhe_tpu_torch import device, noise, tgsw
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

    r, idx, bits, ct = _lut_inputs(sk, rng, instances, lut_bits)
    cb = circuit.make_circuit_bootstrap_staged(P, backend="chunked")
    gsw, first, wall, counts = _cb_launch(cb, ct, ck)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, want in (("rotate_decompose64_ck", steps),
                       ("ck_dot64p_sacc", steps), ("ck_dot64p", 0),
                       ("priv_keyswitch", ell1 * (k + 1))):
        check(counts[name] == want, f"CB_MXU: {name} launched "
              f"{counts[name]} times, want {want}")
    _wmt_only("CB_MXU", ck, counts)
    for name in ("materialize_w", "materialize_wt", "rotate_decompose",
                 "mm_recombine_acc_wt", "fused_cmux_step_v2"):
        check(counts[name] == 0, f"CB_MXU: 32-bit kernel {name} launched "
              f"inside the circuit bootstrap")
    check(tuple(gsw.shape) == (batch, k + 1, ell1, k + 1, P.n_lvl1),
          f"CB_MXU: TRGSW batch of shape {tuple(gsw.shape)}")
    graph_cell(f"CB_MXU chunked default step B={batch}",
               lambda: cb(ct, ck.data), gsw, wall, first)
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

    perm = r.permutation(1 << lut_bits)
    check_luts(lut.eval_lut_batch(
        gsw.reshape(instances, lut_bits, *gsw.shape[1:]), lut_table(perm),
        P.tgsw_lvl1), idx, perm, sk, "CB_MXU")
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
    accf = acc.reshape(batch, -1)
    sacc_kw = dict(N=P.n_lvl2, m=eng.m, planes=kw["planes"], kp1=k + 1,
                   key_shift=eng.cfg.key_shift)
    rot_ms = cuda_ms(lambda: K.rotate_decompose64_ck(a0, acc, **kw), 20)
    dot_ms = cuda_ms(lambda: K.ck_dot64p_sacc(x, wmt0, accf, **sacc_kw), 10)
    dev_ms = {"rotate_decompose64_ck": device_ms(
                  lambda: K.rotate_decompose64_ck(a0, acc, **kw)),
              "rotate_decompose64_ck_flat": device_ms(
                  lambda: K.rotate_decompose64_ck_flat(a0, accf, N=P.n_lvl2,
                                                       **kw)),
              "ck_dot64p_sacc": device_ms(
                  lambda: K.ck_dot64p_sacc(x, wmt0, accf, **sacc_kw), 10),
              # the pair the default step ran before: ck_dot64p and the
              # int64 epilogue in torch
              "ck_dot64p + epilogue": device_ms(lambda: acc + K.recombine(
                  K.ck_dot64p(x, wmt0, N=P.n_lvl2, m=eng.m,
                              planes=kw["planes"]), k + 1,
                  eng.cfg.key_shift), 10),
              "step": device_ms(lambda: eng.cmux_step(
                  a0, acc, prep0, l=p2.l, bgbit=p2.bgbit, offset=p2.offset),
                  10)}
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
                                kw["planes"], entry="ck_dot64p_sacc")
    pre_ms, priv_ms = _keyswitch_ms(P, ck, ct)
    n_priv = ell1 * (k + 1)
    total = (rot_ms + dot_ms) * steps + pre_ms + priv_ms * n_priv
    print(f"phase 5 breakdown B={batch}: rotate_decompose64_ck "
          f"{rot_ms:.4f} ms x {steps}, ck_dot64p_sacc {dot_ms:.4f} ms x "
          f"{steps} (plan (rows, kst) {dot_plan}; whole step "
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
          f"ms, {rot * steps / (wall * 1e3):.1%} of the launch), "
          f"ck_dot64p_sacc {dev_ms['ck_dot64p_sacc']:.4f} ms (ck_dot64p + "
          f"the torch epilogue it replaces "
          f"{dev_ms['ck_dot64p + epilogue']:.4f} ms), "
          f"rotate_decompose64_ck_flat "
          f"{dev_ms['rotate_decompose64_ck_flat']:.4f} ms; launch floor "
          f"{launch_floor_ms():.4f} ms")
    state = {"ck": ck, "ct": ct, "gsw": gsw, "wall": wall,
             "step_ms": one, "opt_step_ms": opt_step_ms, "steps": steps,
             "n_priv": n_priv,
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
    from tfhe_tpu_torch.params import CB_MXU
    ck, ct, steps = state["ck"], state["ct"], state["steps"]
    batch = ct.shape[0]
    cb = circuit.make_circuit_bootstrap_staged(CB_MXU, backend="chunked")
    os.environ[var] = value
    try:
        gsw, first, wall, counts = _cb_launch(cb, ct, ck)
        graph_cell(f"CB_MXU chunked {step} step B={batch}",
                   lambda: cb(ct, ck.data), gsw, wall, first)
    finally:
        del os.environ[var]
    _wmt_only(f"CB_MXU {step}", ck, counts)
    check(torch.equal(gsw, state["gsw"]),
          f"CB_MXU {step}: the TRGSWs differ from the default step's")
    _only(counts, {**{name: steps for name in kernels},
                   "priv_keyswitch": state["n_priv"]}, f"CB_MXU {step}")
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
# them): fused_cmux_step (v1), as only the JAX package's tests call its
# Pallas kernel, and materialize_w, whose layout no product of the port
# reads (they take materialize_wt's K-packed key)
TEST_ONLY = ("fused_cmux_step", "materialize_w")


def _gate_run(P, backend, bits, chain, seed=0, cell=None):
    """Keys from ``seed``, ``bits`` encrypted, one untimed launch (its
    captures), then a timed dependent chain of ``chain`` launches; a
    ``cell`` is then recorded for phase 10 (graph_cell).  Returns the keys,
    the chain's output, its wall seconds, the launch counts, keygen seconds
    and peak device memory."""
    from tfhe_tpu_torch.boot import gate
    cell_start()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rng, sk, ck, keygen_s = _keys(P, backend, seed)
    ct = gate.encrypt_bool(sk, bits, rng)
    boot = gate.make_bootstrap_fn(P, backend=backend)
    t0 = time.perf_counter()
    boot(ck.data, ct)                   # untimed: first-use set-up, capture
    torch.cuda.synchronize()
    first = time.perf_counter() - t0

    def run():
        out = ct
        for _ in range(chain):
            out = boot(ck.data, out)
        return out

    before = _kernel_counters()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = _launch_counts(before)
    ok = gate.decrypt_bool(sk, out) == bits.astype(bool)
    check(ok.all(), f"{backend}: {int((~ok).sum())} of {len(bits)} bits "
          f"wrong")
    if cell:
        graph_cell(cell, run, out, wall, first)
    return sk, ck, out, wall, counts, keygen_s, peak_gb


def _wmt_only(what: str, ck, counts):
    """The 64-bit prepared key is the K-packed wmt alone (no wm), and the
    timed launch (its ``counts``) transposed no key."""
    check(set(ck.data["bk"]) == {"wmt"}, f"{what}: the 64-bit prepared key "
          f"holds {sorted(ck.data['bk'])}, want wmt alone")
    n = counts["ck_dot64p.transposes"]
    check(n == 0, f"{what}: {n} per-call key transposes inside the loop")


def _only(counts, allowed: dict, what: str):
    """Exactly ``allowed[name]`` launches of each CMux kernel named there,
    none of the others."""
    for name in KERNELS:
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
            P, backend, bits, chain,
            cell=f"GATE_MXU {backend} B={batch} ({chain} launches)")
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
    _, ck, out, wall, counts, keygen_s, peak_gb = _gate_run(
        P, "chunked", bits, 1, cell=f"GATE_DEFAULT chunked B={batch}")
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


def phase_circuits(smi: str, keys, instances: int = 256, chains=(1, 4)):
    """A 32-bit ripple-carry adder and a 32-bit comparator over
    ``instances`` instances each, through runtime.scheduler.evaluate on the
    GATE_MXU chunked keys, at each TFHE_WAVE_CHAIN of ``chains`` (each one
    first run capturing its programs, then a timed graphed run, recorded
    for phase 10): every output decodes to the plain sum or comparison.
    Returns the launch counts by path."""
    import os
    from tfhe_tpu_torch.boot import gate
    from tfhe_tpu_torch.params import GATE_MXU
    from tfhe_tpu_torch.rng import TfheRng
    from tfhe_tpu_torch.runtime import scheduler
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
        for chain in chains:
            os.environ["TFHE_WAVE_CHAIN"] = str(chain)
            try:
                res, wall, counts, rep, first = _circuit_run(
                    circ, cts, ck, outs, name, chain)
            finally:
                del os.environ["TFHE_WAVE_CHAIN"]
            if name == "adder":
                got = _decode_words(sk, res)
                check((got == x + y).all(), f"adder: "
                      f"{int((got != x + y).sum())} of {instances} sums "
                      f"wrong")
            else:
                dec = np.stack([gate.decrypt_bool(sk, res[i])
                                for i in range(3)])
                want = np.stack([x < y, x == y, x > y])
                check((dec == want).all(), f"comparator: "
                      f"{int((dec != want).any(0).sum())} of {instances} "
                      f"comparisons wrong")
            _only(counts, {"ck_cmux_step32": n * rep["bootstrap.launches"]},
                  f"circuit {name} chain {chain}")
            boots = rep["bootstrap.ciphertexts"]
            by_path[f"circuit_{name}_chain{chain}"] = counts
            compiles = rep.get("circuit.wave_compiles" if chain == 1
                               else "circuit.chain_compiles", 0)
            print(f"phase 7 {name}32 GATE_MXU chunked x{instances} "
                  f"TFHE_WAVE_CHAIN={chain}: {rep['circuit.gates']} gates, "
                  f"{rep['circuit.waves']} waves, "
                  f"{rep['bootstrap.launches']} launches, {boots} gate "
                  f"bootstraps ({boots // instances} per circuit) in "
                  f"{wall:.3f} s: {boots / wall:.1f} gate bootstraps/s "
                  f"(first run {first:.3f} s, {compiles} programs); every "
                  f"output decodes right [{smi}]")
    return by_path


def _circuit_run(circ, cts, ck, outs, name, chain):
    """One untimed evaluate (its captures), then a timed one, graphed;
    records the cell for phase 10.  Returns the output, the timed wall
    seconds, its launch counts, its observability counters and the first
    run's seconds."""
    from tfhe_tpu_torch.params import GATE_MXU
    from tfhe_tpu_torch.runtime import scheduler
    from tfhe_tpu_torch.utils import observability as obs

    def run():
        return scheduler.evaluate(circ, cts, ck.data, GATE_MXU, outs,
                                  backend="chunked")

    cell_start()
    torch.cuda.synchronize()
    obs.reset()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    rep = obs.report()["counters"]
    obs.reset()
    before = _kernel_counters()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts(before)
    rep = dict(obs.report()["counters"], **{
        k: v for k, v in rep.items() if k.endswith("_compiles")})
    graph_cell(f"{name}32 x{cts.shape[1]} TFHE_WAVE_CHAIN={chain}", run, res,
               wall, first)
    return res, wall, counts, rep, first



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
    mm_recombine_acc_wt."""
    from tfhe_tpu_torch import tgsw
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
            before = _kernel_counters()
            got = eng.accumulate(x, prep)
            torch.cuda.synchronize()
            launched = _launch_counts(before)
            counts = {n: launched[n]
                      for n in ("materialize_w", "materialize_wt",
                                "mm_recombine_acc_wt")}
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
                launched = {"materialize_w": 0, "materialize_wt": 1,
                            "mm_recombine_acc_wt": (cfg.plane_split[1]
                                                    if bits == 32 else 0)}
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
    from tfhe_tpu_torch import device, graphs
    from tfhe_tpu_torch.boot import circuit, gate
    from tfhe_tpu_torch.params import CB_MXU, GATE_DEFAULT
    from tfhe_tpu_torch.rng import TfheRng
    P, n, batch = GATE_DEFAULT, GATE_DEFAULT.lwe.n, default_out.shape[0]
    bits = np.random.default_rng(2).integers(0, 2, batch)
    by_path = {}
    for backend, kernels in (
            ("conv", {"rotate_decompose": n, "materialize_wt": n,
                      "mm_recombine_acc_wt": n}),
            ("nussbaumer", {"rotate_decompose": n}),
            ("fft_f64", {"rotate_decompose": n})):
        sk, ck, out, wall, counts, keygen_s, peak_gb = _gate_run(
            P, backend, bits, 1, cell=None if backend in graphs.EAGER_BACKENDS
            else f"GATE_DEFAULT {backend} B={batch}")
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
            "privks": cb_state["privks"],
            "privks_packed": cb_state["privks_packed"]}
    cb = circuit.make_circuit_bootstrap_staged(P, backend="conv")
    cell_start()
    torch.cuda.reset_peak_memory_stats()
    cb(ct, data)                        # untimed: first-use set-up, capture
    torch.cuda.synchronize()
    before = _kernel_counters()
    t0 = time.perf_counter()
    gsw = cb(ct, data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = _launch_counts(before)
    check(torch.equal(gsw, cb_state["gsw"]), "CB_MXU conv: the TRGSWs "
          "differ from phase 5's chunked ones")
    _only(counts, {"materialize_wt": steps,
                   "priv_keyswitch": cb_state["n_priv"]}, "CB_MXU conv")
    by_path["circuit_bootstrap_conv"] = counts
    print(f"phase 9 CB_MXU conv B={batch}: {wall * 1e3 / batch:.3f} ms per "
          f"ciphertext, {batch / wall:.2f} ct/s ({wall:.3f} s for one launch, "
          f"{steps} steps: {wall * 1e3 / steps:.3f} ms a step), TRGSWs "
          f"bit-identical to phase 5's chunked ones; key prepared from the "
          f"raw bk in {prep_s:.2f} s ({_nbytes(bk['k']) / 1e6:.0f} MB), peak "
          f"device memory {peak_gb:.2f} GB; launches {counts} [{smi}]")
    return by_path


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

def _step_nodes(backend: str, batch: int = 256, seed: int = 10):
    """Nodes of one captured generic step's product (accumulate_into) of
    ``backend`` at GATE_DEFAULT's engine config and B=256 (a rotation is
    630 of them): the count that decides graphs.EAGER_BACKENDS."""
    from tfhe_tpu_torch import graphs, tgsw
    from tfhe_tpu_torch.ops.engine import make_engine
    from tfhe_tpu_torch.params import GATE_DEFAULT
    p = GATE_DEFAULT.tgsw
    cfg = tgsw.engine_config(p)
    J, U, N = (p.tlwe.k + 1) * p.l, p.tlwe.k + 1, p.tlwe.N
    r = np.random.default_rng(seed)
    half = 1 << (p.bgbit - 1)
    x = torch.from_numpy(r.integers(-half, half, (batch, J, N))
                         .astype(np.int32)).cuda()
    key = torch.from_numpy(r.integers(-2**31, 2**31, (J, U, N))
                           .astype(np.int32)).cuda()
    if backend == "nussbaumer":
        key = (key >> 8) << 8
    acc = torch.from_numpy(r.integers(-2**31, 2**31, (batch, U, N))
                           .astype(np.int32)).cuda()
    eng = make_engine(cfg, backend)
    prep = eng.prepare(key)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = eng.accumulate_into(acc, x, prep)        # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    g, kept = graphs.new_graph()
    t0 = time.perf_counter()
    with torch.cuda.graph(g, stream=stream):
        out = eng.accumulate_into(acc, x, prep)
    capture_ms = (time.perf_counter() - t0) * 1e3
    g.replay()
    torch.cuda.synchronize()
    check(torch.equal(out, want), f"{backend}: a replayed step differs")
    nodes = graphs.nodes(g) if kept else None
    del g, out
    torch.cuda.empty_cache()
    return nodes, capture_ms


def print_cell(c: dict, smi: str, phase: str):
    """One line for a cell graph_cell recorded."""
    busy = c["busy_ms"]
    idle = ("not measured" if busy is None else
            f"{1 - busy / (c['graphed_s'] * 1e3):.1%} graphed, "
            f"{1 - busy / (c['eager_s'] * 1e3):.1%} eager")
    nodes = "not measured" if c["nodes"] is None else c["nodes"]
    print(f"phase {phase} graphs {c['cell']}: bit-identical graphed and "
          f"eager; wall {c['graphed_s']:.4f} s graphed, "
          f"{c['eager_s']:.4f} s eager ({c['eager_s'] / c['graphed_s']:.2f}x);"
          f" device busy {busy if busy is None else f'{busy:.1f}'} ms, "
          f"idle share {idle}; first run {c['first_s']:.3f} s: "
          f"{c['captures']} captures ({c['capture_ms']:.1f} ms capture, "
          f"{c['instantiate_ms']:.1f} ms instantiate), {nodes} nodes, "
          f"pool {c['pool_bytes'] / 1e6:.1f} MB; {c['replays']} replays "
          f"[{smi}]")


def phase_graphs(smi: str):
    """Phase 10: every cell of phases 3-9 graphed against eager (recorded by
    graph_cell), the eager backends' step node counts, and the HP FFT
    product on the card against the CPU."""
    from tfhe_tpu_torch import graphs
    from tfhe_tpu_torch.ops import hpfft
    for c in GRAPH_CELLS:
        print_cell(c, smi, "10")
    for backend in ("nussbaumer", "fft_dd"):
        nodes, ms = _step_nodes(backend)
        rule = ("stays eager" if backend in graphs.EAGER_BACKENDS
                else "captured")
        print(f"phase 10 backend {backend}: one GATE_DEFAULT B=256 step's "
              f"product captured as {nodes} nodes in {ms:.1f} ms, "
              f"{'not measured' if nodes is None else nodes * 630} for a "
              f"630-step rotation; {rule} (graphs.EAGER_BACKENDS)")
    r = np.random.default_rng(11)
    N = 1024
    a = torch.from_numpy(r.integers(-128, 128, (4, N)).astype(np.int64))
    b = torch.from_numpy(r.integers(-2**63, 2**63, (4, N), dtype=np.int64))
    for limbs in (6, 8):
        want = hpfft.hp_negacyclic_mul(a, b, limbs)
        da, db = a.cuda(), b.cuda()
        got = hpfft.hp_negacyclic_mul(da, db, limbs)
        torch.cuda.synchronize()
        check(got.device.type == "cuda" and torch.equal(got.cpu(), want),
              f"hp_negacyclic_mul limbs={limbs}: the card differs from the "
              f"CPU")
        ms = cuda_ms(lambda: hpfft.hp_negacyclic_mul(da, db, limbs), 3)
        t0 = time.perf_counter()
        hpfft.hp_negacyclic_mul(a, b, limbs)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        print(f"phase 10 hpfft hp_negacyclic_mul N={N} x4 limbs={limbs}: "
              f"bit-identical on the card and the CPU; {ms:.2f} ms a call on "
              f"the card (CUDA events), {cpu_ms:.1f} ms on the host [{smi}]")


# ---------------------------------------------------------------------------
# phase 11: the multi-device layer (tfhe_tpu_torch.parallel), rank processes
# ---------------------------------------------------------------------------

# (job, ranks, backend): 11a the ep gate path on three gloo ranks; 11b-c the
# dp-only gate path, the tp formulation and the CB_MXU ep circuit path on
# two; 11d the default backend, one NCCL rank.  gloo ranks share cuda:0
# (NCCL refuses two ranks on one device).
RANK_JOBS = (("gate_ep3", 3, "gloo"), ("pair", 2, "gloo"), ("nccl", 1, None))
SHARE_NOTE = "ranks share one card; not a scaling figure"


def _rank_drive(out, rank, results, case, fn, args, warm=True):
    """One untimed launch (``warm``), then a timed one with every launch
    count and the all-reduce's host time from 0; saves the rows."""
    from tfhe_tpu_torch.utils import observability as obs
    if warm:
        fn(*args)
        torch.cuda.synchronize()
    obs.reset()
    before = _kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    red = obs.report()["spans"].get("parallel.all_reduce", {})
    results[case] = {"counts": _launch_counts(before), "wall_s": wall,
                     "reduce_s": red.get("total_s", 0.0),
                     "reduce_calls": red.get("count", 0),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    np.save(out / f"{case}-r{rank}.npy", rows.cpu().numpy())
    return rows


def rank_main(job: str, out) -> int:
    """A rank of phase 11 (``chip_smoke.py --rank JOB DIR``, started by
    ``multihost.launch``): drives its job's paths on the card and writes
    its rows and numbers to DIR."""
    from pathlib import Path
    import torch.distributed as dist
    from tfhe_tpu_torch.boot import circuit, gate
    from tfhe_tpu_torch.params import CB_MXU, GATE_FAST2
    from tfhe_tpu_torch.parallel import mesh as gmesh, multihost, shard
    from tfhe_tpu_torch.rng import TfheRng
    out = Path(out)
    if job == "nccl":
        multihost.initialize()              # the default: NCCL, cuda:LOCAL_RANK
    else:
        multihost.initialize(backend="gloo", device="cuda:0")
    gmesh.SYNC_BEFORE_REDUCE = True         # the all-reduce's span: itself
    rank, world = dist.get_rank(), dist.get_world_size()
    results = {"backend": dist.get_backend()}
    P = GATE_FAST2
    _, sk, ck, _ = _keys(P, "onthefly")     # phase 3's seed and keys
    ct = torch.from_numpy(np.load(out / "gate_ct.npy")).cuda()
    bits = np.random.default_rng(1).integers(0, 2, ct.shape[0]).astype(bool)

    def gate_case(case, mesh, mod, B):
        fn, place = mod.make_sharded_bootstrap_fn(P, mesh, "onthefly")
        kd, rows = place(ck.data, ct[:B])
        got = _rank_drive(out, rank, results, case, fn, (kd, rows))
        lo = mesh.index("dp") * (B // mesh.shape["dp"])
        ok = gate.decrypt_bool(sk, got) == bits[lo:lo + got.shape[0]]
        check(ok.all(), f"{case} rank {rank}: {int((~ok).sum())} bits wrong")
        results[case]["key_bytes"] = _nbytes(*(kd["bk"][n] for n in kd["bk"]),
                                             kd["ksw"])

    if job == "gate_ep3":
        gate_case("shard_ep3", shard.make_mesh(3, dp=1, ep=3), shard, 1024)
    elif job == "nccl":
        gate_case("shard_nccl", shard.make_mesh(1, dp=1, ep=1), shard, 8192)
        t = torch.tensor([-2**63, 2**63 - 1, 5], dtype=torch.int64,
                         device="cuda")
        got = gmesh.all_reduce_exact(t, dist.group.WORLD)
        check(torch.equal(got, t), "NCCL all_reduce_exact of one rank")
    else:
        gate_case("shard_dp2", shard.make_mesh(2, dp=2, ep=1), shard, 2048)
        gate_case("mesh_tp2", gmesh.make_mesh(2, dp=1, tp=2), gmesh, 1024)
        del ck
        cp = CB_MXU
        rng = TfheRng(0)                    # phase 5's seed, keys and inputs
        csk = circuit.CircuitSecretKey.generate(cp, rng)
        torch.cuda.reset_peak_memory_stats()    # not the gate cases' peak
        cck = circuit.CircuitCloudKey.generate(csk, rng, backend="chunked",
                                               prepare_bk=False)
        cct = torch.from_numpy(np.load(out / "cb_ct.npy")).cuda()
        mesh = shard.make_mesh(2, dp=1, ep=2)
        fn, place = shard.make_sharded_circuit_bootstrap_fn(cp, mesh,
                                                            "chunked")
        kd, rows = place(cck.data, cct, bk_raw=cck.bk_raw)
        del cck
        torch.cuda.empty_cache()
        keygen_gb = torch.cuda.max_memory_allocated() / 1e9
        _rank_drive(out, rank, results, "shard_cb_ep2", fn, (kd, rows),
                    warm=False)
        results["shard_cb_ep2"].update(
            wmt_shape=list(kd["bk"]["wmt"].shape), keygen_peak_gb=keygen_gb,
            key_bytes=_nbytes(kd["bk"]["wmt"], kd["preks"], kd["privks"]))
    import json
    (out / f"{job}-r{rank}.json").write_text(json.dumps(results))
    print(f"rank {rank}/{world} {job}: done", flush=True)
    dist.destroy_process_group()
    return 0


def _rank_rows(out, case, ranks):
    return [torch.from_numpy(np.load(out / f"{case}-r{r}.npy"))
            for r in range(ranks)]


def phase_sharded(smi: str, gate_ref: dict, cb_ref: dict):
    """Phase 11: the sharded paths in rank processes on this card, each
    rank's rows held bit for bit against the one-process outputs of phases
    3 and 5 and its launches against the path's kernels.  Returns the
    launch counts (summed over ranks) by path."""
    import json
    import tempfile
    from pathlib import Path
    from tfhe_tpu_torch import noise
    from tfhe_tpu_torch.params import CB_MXU, GATE_FAST2
    from tfhe_tpu_torch.parallel import multihost
    n = GATE_FAST2.lwe.n
    shared = (noise.shared_rotation_penalty(CB_MXU)
              <= noise.SHARED_ROTATION_MAX_PENALTY)
    cb_steps = CB_MXU.n_lvl0 * (1 if shared else CB_MXU.tgsw_lvl1.l)
    torch.cuda.empty_cache()
    want_gate, want_cb = gate_ref["out"], cb_ref["gsw"]
    by_path = {}
    generic = {"rotate_decompose": n, "materialize_wt": n,
               "mm_recombine_acc_wt": n}
    expect = {"shard_ep3": (3, 1024, generic),
              "shard_dp2": (2, 2048, generic),
              "mesh_tp2": (2, 1024, {"materialize_wt": n,
                                     "fused_cmux_step_v2": n}),
              "shard_cb_ep2": (2, 256, {"rotate_decompose64": cb_steps,
                                        "ck_dot64p": cb_steps}),
              "shard_nccl": (1, 8192, generic)}
    label = {"shard_ep3": "11a shard GATE_FAST2 onthefly (dp=1, ep=3)",
             "shard_dp2": "11a shard GATE_FAST2 onthefly (dp=2, ep=1)",
             "mesh_tp2": "11b mesh GATE_FAST2 onthefly (dp=1, tp=2)",
             "shard_cb_ep2": "11c shard CB_MXU chunked (dp=1, ep=2)",
             "shard_nccl": "11d shard GATE_FAST2 onthefly (dp=1, ep=1)"}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        np.save(out / "gate_ct.npy", gate_ref["ct"].numpy())
        np.save(out / "cb_ct.npy", cb_ref["ct"].cpu().numpy())
        for job, ranks, backend in RANK_JOBS:
            t0 = time.perf_counter()
            multihost.launch(
                [sys.executable, str(Path(__file__).resolve()), "--rank", job,
                 str(out)], ranks, coordinator_address=f"file://{out}/{job}",
                timeout=600)
            job_s = time.perf_counter() - t0
            res = [json.loads((out / f"{job}-r{r}.json").read_text())
                   for r in range(ranks)]
            for case in (c for c in expect if c in res[0]):
                world, B, kernels = expect[case]
                dp = 2 if case == "shard_dp2" else 1
                rows = _rank_rows(out, case, world)
                want = want_cb if case == "shard_cb_ep2" else want_gate[:B]
                for r, got in enumerate(rows):
                    lo = (r if dp > 1 else 0) * (B // dp)
                    check(torch.equal(got, want[lo:lo + B // dp]),
                          f"{label[case]}: rank {r}'s rows differ from the "
                          f"one-process output")
                    _only(res[r][case]["counts"], kernels,
                          f"{label[case]} rank {r}")
                by_path[case] = {k: sum(x[case]["counts"][k] for x in res)
                                 for k in res[0][case]["counts"]}
                per_rank = "; ".join(
                    f"rank {r}: {x[case]['wall_s']:.3f} s a launch, "
                    f"all-reduce {x[case]['reduce_s']:.3f} s "
                    f"({x[case]['reduce_s'] / x[case]['wall_s']:.1%}) over "
                    f"{x[case]['reduce_calls']} calls, key slice "
                    f"{x[case]['key_bytes'] / 1e9:.3f} GB, launch peak "
                    f"{x[case]['peak_gb']:.2f} GB"
                    for r, x in enumerate(res))
                extra = ""
                if case == "shard_cb_ep2":
                    x = res[0][case]
                    extra = (f"; wmt slice {tuple(x['wmt_shape'])} "
                             f"(J*m = {x['wmt_shape'][-1]}), keygen's peak "
                             f"{x['keygen_peak_gb']:.2f} GB a rank (the whole"
                             f" privKS is drawn, then sliced)")
                print(f"phase {label[case]} B={B}, {world} {res[0]['backend']}"
                      f" rank(s) on cuda:0 ({SHARE_NOTE}): every rank's rows "
                      f"equal the one-process output bit for bit; "
                      f"{per_rank}; launches a rank {kernels}{extra} "
                      f"[{smi}]")
            print(f"phase 11 job {job}: {ranks} rank(s), {job_s:.1f} s with "
                  f"start-up and keygen")
    return by_path


# ---------------------------------------------------------------------------
# phase 12: the reference's own parameter blocks
# ---------------------------------------------------------------------------

# poc_CircuitBootstrapping.cpp:18-34 (the PoC's proposed block) and :70-85
# (its active one), as params.py defines them: both decompose lvl2 at
# Bg = 2^9 (two digit planes) and keep the whole 8-limb key (bk_limbs = 0)
REF_BLOCKS = ("CB_PAPER", "CB_ACTIVE")


def _programs_txt() -> str:
    from tfhe_tpu_torch import graphs
    progs = graphs.stats()
    return (f"{len(progs)} programs, pools "
            f"{sum(p['pool_bytes'] for p in progs) / 1e9:.3f} GB")


def phase_ref_block(smi: str, name: str) -> dict:
    """Phase 12 for one block: keys on the card, the default step's graphed
    launch at B=256 (one untimed, one timed), the TRGSW checks (PERF.md
    §6: every row within 2^-8 of the torus, h_w/4 at the levels
    cleared_levels names, a CMux at the last of them, all 64 LUTs), then
    the acc, sacc and FUSED steps on the same inputs, each TRGSW-identical
    to the default.  Returns the launch counts by path."""
    import os
    from tfhe_tpu_torch import noise, params, tgsw
    from tfhe_tpu_torch.boot import circuit
    from tfhe_tpu_torch.ops.engine import make_engine
    from tfhe_tpu_torch.rng import TfheRng
    from tfhe_tpu_torch.utils import observability as obs
    P = getattr(params, name)
    tag = name.lower()
    k, ell1, p2 = P.lvl1.k, P.tgsw_lvl1.l, P.tgsw_lvl2
    check(p2.key_limbs == 0 and p2.bgbit == 9, f"{name}: want the whole "
          f"8-limb lvl2 key at Bg = 2^9")
    penalty = noise.shared_rotation_penalty(P)
    check(penalty > noise.SHARED_ROTATION_MAX_PENALTY, f"{name}: the shared "
          f"rotation should be refused")
    steps = P.n_lvl0 * ell1

    cell_start()
    rng = TfheRng(0)
    sk = circuit.CircuitSecretKey.generate(P, rng)
    spans0 = {n: v["total_s"] for n, v in obs.report()["spans"].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ck = circuit.CircuitCloudKey.generate(sk, rng, backend="chunked")
    keygen_s = time.perf_counter() - t0
    keygen_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    keys_gb = torch.cuda.memory_allocated() / 1e9
    wmt = ck.data["bk"]["wmt"]
    Jm = (k + 1) * p2.l * CB_M
    check(tuple(wmt.shape) == (P.n_lvl0, (k + 1) * 8, P.n_lvl2 + CB_M, Jm),
          f"{name}: wmt of shape {tuple(wmt.shape)}")
    parts = ", ".join(
        f"{n.split('.')[-1]} {v['total_s'] - spans0.get(n, 0.0):.2f} s"
        for n, v in obs.report()["spans"].items()
        if n.startswith("keygen.circuit."))
    print(f"phase 12 {name} keygen on the card: {keygen_s:.2f} s ({parts}); "
          f"peak {keygen_peak_gb:.2f} GB, resident {keys_gb:.2f} GB: wmt "
          f"{tuple(wmt.shape)} {_nbytes(wmt) / 1e9:.2f} GB (J*m = {Jm}, "
          f"8 limbs, 2 planes), privKS {tuple(ck.data['privks'].shape)} "
          f"{_nbytes(ck.data['privks']) / 1e9:.2f} GB, preKS "
          f"{tuple(ck.data['preks'].shape)}; shared rotation refused "
          f"(penalty {penalty:.3g}) [{smi}]")

    r, idx, bits, ct = _lut_inputs(sk, rng)
    batch = ct.shape[0]
    cb = circuit.make_circuit_bootstrap_staged(P, backend="chunked")
    torch.cuda.reset_peak_memory_stats()
    gsw, first, wall, counts = _cb_launch(cb, ct, ck)
    launch_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _wmt_only(name, ck, counts)
    n_priv = ell1 * (k + 1)
    _only(counts, {"rotate_decompose64_ck": steps, "ck_dot64p_sacc": steps,
                   "priv_keyswitch": n_priv}, f"{name} default step")
    check(tuple(gsw.shape) == (batch, k + 1, ell1, k + 1, P.n_lvl1),
          f"{name}: TRGSW batch of shape {tuple(gsw.shape)}")
    graph_cell(f"{name} chunked default step B={batch}",
               lambda: cb(ct, ck.data), gsw, wall, first)
    print_cell(GRAPH_CELLS.pop(), smi, "12")
    print(f"phase 12 {name} chunked default step B={batch}: "
          f"{wall * 1e3 / batch:.3f} ms per ciphertext, {batch / wall:.2f} "
          f"ct/s ({wall:.3f} s for one launch of {ell1} rotations x "
          f"{P.n_lvl0} steps and {ell1 * (k + 1)} privKS products; first "
          f"launch {first:.3f} s with its captures, {_programs_txt()}); peak "
          f"of the two launches {launch_peak_gb:.2f} GB; launches "
          f"{ {n: c for n, c in counts.items() if c} } [{smi}]")
    by_path = {tag: counts}

    # where the launch's time goes: one default step's device time (its two
    # kernels and the int64 epilogue), the key switches' call times
    eng = make_engine(tgsw.engine_config(p2), "chunked")
    acc = torch.randint(-2**63, 2**63 - 1, (batch, k + 1, P.n_lvl2),
                        dtype=torch.int64, device=wmt.device)
    a0 = torch.randint(0, 2 * P.n_lvl2, (batch,), dtype=torch.int32,
                       device=wmt.device)
    step_ms = device_ms(lambda: eng.cmux_step(
        a0, acc, {"wmt": wmt[0]}, l=p2.l, bgbit=p2.bgbit, offset=p2.offset),
        10)
    pre_ms, priv_ms = _keyswitch_ms(P, ck, ct)
    total = step_ms * steps + pre_ms + priv_ms * n_priv
    print(f"phase 12 {name} breakdown B={batch}: default step {step_ms:.4f} "
          f"ms of device time x {steps} ({step_ms * steps / (wall * 1e3):.1%}"
          f" of the launch), preKS {pre_ms:.3f} ms x 1, privKS "
          f"{priv_ms:.3f} ms x {n_priv} ({priv_ms * n_priv / (wall * 1e3):.1%}"
          f"); sum {total:.1f} ms vs {wall * 1e3:.1f} ms per launch")
    del acc, a0

    levels = cleared_levels(P)
    check(levels == [0, 1], f"{name}: the worksheet clears h_w/4 at levels "
          f"{levels}, not at [0, 1] as PERF.md states")
    worst = check_trgsw_probe(gsw, bits, sk, P)
    print(f"phase 12 {name} TRGSW rows: all {batch * (k + 1) * ell1} rows "
          f"within 2^-8 of the torus of K_z * bit * h_w (worst {worst} < "
          f"{PROBE_LIMIT})")
    worst = check_trgsw_rows(gsw, bits, sk, P, levels)
    print(f"phase 12 {name} TRGSW rows: the (z=1) rows of levels {levels} "
          f"(h_w/4 clears 6 sigma of the worksheet's noise there) within "
          f"h_w/4; worst error per level {worst}")
    worst, limit = check_cmux(gsw, bits, sk, P, level=levels[-1])
    print(f"phase 12 {name} CMux: all {batch} TRGSWs select the right "
          f"message with the digit on level {levels[-1]} (worst phase error "
          f"{worst} < {limit})")
    lut_counts, lut_txt = phase_lut_staged(P, ck, ct, gsw, idx,
                                           r.permutation(16), sk, name,
                                           steps, n_priv)
    by_path[f"{tag}_lut"] = lut_counts
    print(f"phase 12 {name} LUT through models.lut.make_lut_staged: all "
          f"{len(idx)} 4-bit LUTs decode table[index]; {lut_txt} [{smi}]")

    for _, step, var, value, kernels in CK64_STEPS:
        os.environ[var] = value
        try:
            got, first, wall_s, counts = _cb_launch(cb, ct, ck)
            programs = _programs_txt()
        finally:
            del os.environ[var]
        check(torch.equal(got, gsw), f"{name} {step}: the TRGSWs differ "
              f"from the default step's")
        _only(counts, {**{n: steps for n in kernels},
                       "priv_keyswitch": n_priv}, f"{name} {step}")
        by_path[f"{tag}_{step}"] = counts
        print(f"phase 12 {name} chunked {var}={value} B={batch}: "
              f"{wall_s * 1e3 / batch:.3f} ms per ciphertext ({wall_s:.3f}"
              f" s for one launch, first {first:.3f} s, {programs}) against "
              f"the default's {wall * 1e3 / batch:.3f}; TRGSWs bit-identical "
              f"to the default step's; launches "
              f"{ {n: c for n, c in counts.items() if c} } [{smi}]")
    del ck, cb, gsw
    cell_start()
    return by_path


def phase_lut_staged(P, ck, ct, gsw, idx, perm, sk, name, steps, n_priv):
    """The 4-bit LUTs of phase 12's launch through the staged LUT entry
    (programs A, B, C and the tree's): its answers decode (check_luts) and
    equal the tree folded over the launch's TRGSWs; one timed launch, its
    kernel launches, and the tree's device time alone (its four lut_cmux
    launches) beside its bound.  Returns (the launch counts, a summary)."""
    from tfhe_tpu_torch.models import lut
    k, N = len(perm).bit_length() - 1, P.n_lvl1
    inst = len(idx)
    leaves = lut.pack_table(lut_table(perm), N, device=ct.device)
    fn = lut.make_lut_staged(P, "chunked", k)
    fn(ct, ck.data, leaves)                 # captures the tree's program
    torch.cuda.synchronize()
    before = _kernel_counters()
    t0 = time.perf_counter()
    out = fn(ct, ck.data, leaves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts(before)
    _only(counts, {"rotate_decompose64_ck": steps, "ck_dot64p_sacc": steps,
                   "priv_keyswitch": n_priv, "lut_cmux": k},
          f"{name} LUT launch")
    check_luts(out, idx, perm, sk, name)
    sel = gsw.reshape(inst, k, *gsw.shape[1:])
    check(torch.equal(out, lut.lut_tree(sel, leaves, P.tgsw_lvl1)),
          f"{name}: the staged LUT differs from the tree on its TRGSWs")
    tree_ms = device_ms(lambda: lut.lut_tree(sel, leaves, P.tgsw_lvl1), 10)
    kp1, l = P.lvl1.k + 1, P.tgsw_lvl1.l
    rows = inst * ((1 << k) - 1)
    bnd, by = bound_ms(_nbytes(sel, leaves) + (2 * rows - inst) * kp1 * N * 4,
                       rows * kp1 * l * N * kp1 * N * 4)
    return counts, (f"launch {wall:.3f} s; the tree alone {tree_ms:.4f} ms "
                    f"of device time ({k} lut_cmux launches; bound "
                    f"{bnd:.4f} ms by {by}, {bnd / tree_ms:.1%} of it)")


def phase_ref_blocks(smi: str) -> dict:
    """Phase 12: every block of REF_BLOCKS, one after the other."""
    by_path = {}
    for name in REF_BLOCKS:
        t0 = time.perf_counter()
        by_path.update(phase_ref_block(smi, name))
        print(f"phase 12 {name}: {time.perf_counter() - t0:.1f} s in all")
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
    by_path["gate_fast2"], gate_ref = phase_main(smi)
    by_path["gate_default"], default_out = phase_generic(smi)
    by_path["circuit_bootstrap"], state = phase_circuit(smi)
    for phase, step, *run in CK64_STEPS:
        by_path[f"circuit_bootstrap_{step}"] = phase_circuit_step(
            smi, state, phase, step, *run)
    ck = state.pop("ck")                # phase 9 keeps the raw bk alone
    state.update(preks=ck.data["preks"], privks=ck.data["privks"],
                 privks_packed=ck.data["privks_packed"], bk_raw=ck.bk_raw)
    del ck
    torch.cuda.empty_cache()
    paths, keys = phase_n1024(smi, default_out)
    by_path.update(paths)
    by_path.update(phase_circuits(smi, keys))
    del keys
    cell_start()                        # the programs held the keys
    phase_engines(smi)
    by_path.update(phase_engine_paths(smi, default_out, state))
    cell_start()
    phase_graphs(smi)
    cb_ref = {"ct": state.pop("ct"), "gsw": state.pop("gsw").cpu()}
    del state
    by_path.update(phase_sharded(smi, gate_ref, cb_ref))
    del cb_ref
    by_path.update(phase_ref_blocks(smi))
    check(len(results) == len(KERNELS), f"phase 2 checked "
          f"{len(results)} of {len(KERNELS)} kernels")
    for name, entry in results.items():
        entry["launches_by_path"] = {path: counts[name]
                                     for path, counts in by_path.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        check(entry["launches"] > 0 or name in TEST_ONLY,
              f"{name} never launched on a path")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [results[k] for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--rank"]:
            sys.exit(rank_main(sys.argv[2], sys.argv[3]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
