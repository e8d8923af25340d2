"""Frozen work counts of a blind-rotation step, and the card's peaks.

The work is counted from the configuration's parameters, not from the
kernels that run, so a change that fuses or splits the step's kernels reads
the same work:

* MACs: the external product as int8 multiply-accumulates, every digit
  plane of every gadget digit row against every key limb of every output
  polynomial, N^2 per negacyclic product:
  planes * B * (k+1)l * (k+1) * limbs * N^2;
* bytes: the raw TRGSW key of the step read once and the accumulator read
  and written once, at the torus width.

A step's bound is max(2 * MACs / int8 peak, bytes / bandwidth).  Key
switches (the gate's, preKS, privKS) are not counted: a launch's bound is
its blind-rotation steps alone, a lower bound on the launch.
"""

from __future__ import annotations

# NVIDIA's published dense peaks of the H100 SXM part at 700 W (the data
# sheet): int8 tensor-core operations and HBM3 bandwidth.
PEAKS = {"NVIDIA H100 80GB HBM3": {"int8_ops_per_s": 1979e12,
                                   "bytes_per_s": 3.35e12}}


def digit_planes(bgbit: int) -> int:
    """int8 planes a signed digit of bgbit bits needs: one up to 8 bits,
    else balanced base-2^7 planes."""
    if bgbit <= 8:
        return 1
    m, planes = 1 << (bgbit - 1), 0
    while m:
        m = (m + 64) >> 7
        planes += 1
    return planes


def cmux_step_work(B: int, N: int, k: int, l: int, bgbit: int, bits: int,
                   key_limbs: int = 0) -> tuple:
    """(int8 MACs, bytes) of one CMux step over B accumulators."""
    limbs = key_limbs or bits // 8
    kp1 = k + 1
    macs = digit_planes(bgbit) * B * kp1 * l * kp1 * limbs * N * N
    nbytes = (kp1 * l * kp1 * N + 2 * B * kp1 * N) * bits // 8
    return macs, nbytes


def bound_s(macs: int, nbytes: int, peaks: dict) -> float:
    return max(2 * macs / peaks["int8_ops_per_s"],
               nbytes / peaks["bytes_per_s"])


def gate_bootstrap_s(cfg: dict, B: int, peaks: dict) -> float:
    """The n 32-bit steps of a gate-bootstrap launch of B rows."""
    step = cmux_step_work(B, cfg["N"], cfg["k"], cfg["l"], cfg["bgbit"], 32,
                          cfg["key_limbs"])
    return cfg["n"] * bound_s(*step, peaks)


def circuit_bootstrap_s(cfg: dict, B: int, peaks: dict) -> float:
    """The lvl2 64-bit steps of a circuit-bootstrap launch of B rows: n0
    steps a rotation, one rotation per output level (one in all where the
    rotation is shared)."""
    step = cmux_step_work(B, cfg["n_lvl2"], 1, cfg["ell_lvl2"],
                          cfg["bgbit_lvl2"], 64, cfg["bk_limbs"])
    rotations = 1 if cfg["shared_rotation"] else cfg["ell_lvl1"]
    return rotations * cfg["n_lvl0"] * bound_s(*step, peaks)


BOUNDS = {"gate": gate_bootstrap_s, "circuit": circuit_bootstrap_s}
