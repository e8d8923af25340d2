"""Parameter sets for the TPU-native TFHE library.

The reference keeps all parameters as compile-time constants selected by
``#if`` blocks (poc_CircuitBootstrapping.cpp:18-85) plus implicit constants in
the library-reference files (lwe_functions.cpp / tgsw_functions.cpp).  Here
they are first-class frozen dataclasses, hashable so they can be passed as
static arguments through ``jax.jit``.

Level naming follows the reference (poc_types.h:267-312):
  lvl0 — small LWE (n_lvl0), the blind-rotation exponent domain
  lvl1 — TRLWE ring N_lvl1 / extracted LWE n_lvl1, Torus32
  lvl2 — TRLWE ring N_lvl2 / extracted LWE n_lvl2, Torus64
"""

from __future__ import annotations

import dataclasses
import math


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


@dataclasses.dataclass(frozen=True)
class LweParams:
    """LWE dimension + fresh-encryption noise (lwe_functions.cpp:17)."""

    n: int
    stdev: float = 0.0


@dataclasses.dataclass(frozen=True)
class TLweParams:
    """TRLWE (ring LWE over Z[X]/(X^N+1)) parameters (tlwe_functions.cpp:14).

    ``bits`` selects the torus width: 32 (Torus32/int32) or 64 (Torus64/int64).
    """

    N: int
    k: int = 1
    stdev: float = 0.0
    bits: int = 32

    def __post_init__(self):
        assert _is_pow2(self.N), "ring dimension must be a power of two"
        assert self.bits in (32, 64)

    @property
    def extracted_n(self) -> int:
        """Dimension of the LWE sample extracted from a TRLWE (tlwe_functions.cpp:351)."""
        return self.k * self.N


@dataclasses.dataclass(frozen=True)
class TGswParams:
    """TRGSW gadget parameters (tgsw_functions.cpp:15-39).

    ``l`` decomposition length, ``bgbit`` log2 of the gadget base Bg.
    The decomposition offset is the reference's precomputed rounding constant:
      32-bit: offset = halfBg * sum_{i=1..l} 2^(32-i*bgbit)   (tgsw_functions.cpp:30-37)
      64-bit: offset = sum_{i=0..l} 2^(63-i*bgbit)            (poc_CircuitBootstrapping.cpp:349-350)
    """

    l: int
    bgbit: int
    tlwe: TLweParams
    # Engine knob with a noise budget: keep only this many 8-bit key limbs
    # in the MXU contraction (0 = exact).  key_limbs=3 on a 32-bit torus
    # rounds key coefficients to their top 24 bits — equivalent extra key
    # noise of stdev 2^-25.6 (noise.py:key_truncation_variance), cutting the
    # external-product MAC count by 25%.
    key_limbs: int = 0

    @property
    def bg(self) -> int:
        return 1 << self.bgbit

    @property
    def half_bg(self) -> int:
        return self.bg // 2

    @property
    def mask_mod(self) -> int:
        return self.bg - 1

    @property
    def kpl(self) -> int:
        return (self.tlwe.k + 1) * self.l

    @property
    def offset(self) -> int:
        if self.tlwe.bits == 32:
            return (sum(1 << (32 - (i + 1) * self.bgbit) for i in range(self.l))
                    * self.half_bg) & 0xFFFFFFFF
        return sum(1 << (63 - i * self.bgbit) for i in range(self.l + 1)) & (2**64 - 1)

    @property
    def h(self) -> tuple:
        """Gadget vector h_i = 2^(bits-(i+1)*bgbit) (tgsw_functions.cpp:25-28)."""
        return tuple(1 << (self.tlwe.bits - (i + 1) * self.bgbit) for i in range(self.l))

    @property
    def digit_bound(self) -> int:
        """Digits produced by decomposition lie in [-half_bg, half_bg)."""
        return self.half_bg


@dataclasses.dataclass(frozen=True)
class KeySwitchParams:
    """Digit-decomposition key switch (lwe_functions.cpp:139-160).

    ``t`` digits of ``basebit`` bits each, per input coefficient.
    """

    t: int
    basebit: int
    stdev: float

    @property
    def base(self) -> int:
        return 1 << self.basebit


@dataclasses.dataclass(frozen=True)
class GateParams:
    """Everything needed for a gate bootstrap (lwe_functions.cpp:328-446):
    in/out LWE at ``lwe``, accumulator ring ``tgsw.tlwe``, key switch back
    from the extracted LWE to ``lwe``.
    """

    lwe: LweParams
    tgsw: TGswParams
    ks: KeySwitchParams

    @property
    def N(self) -> int:
        return self.tgsw.tlwe.N


@dataclasses.dataclass(frozen=True)
class CircuitParams:
    """Circuit-bootstrapping parameter environment (poc_types.h:267-312).

    Mirrors ``Globals``: three levels, preKS (lvl1 LWE -> lvl0 LWE), bk
    (lvl0 bits encrypted as TRGSW over lvl2), privKS (lvl2 LWE -> lvl1 TRLWE).
    """

    n_lvl0: int
    lvl1: TLweParams           # Torus32 ring, N_lvl1
    lvl2: TLweParams           # Torus64 ring, N_lvl2
    tgsw_lvl1: TGswParams      # output TRGSW gadget (bgbit_lvl1, ell_lvl1)
    tgsw_lvl2: TGswParams      # bootstrapping key gadget (bgbit_lvl2, ell_lvl2)
    bk_stdev: float
    ks10: KeySwitchParams      # preKS: lvl1 -> lvl0
    ks21: KeySwitchParams      # privKS: lvl2 -> lvl1

    @property
    def n_lvl1(self) -> int:
        return self.lvl1.N

    @property
    def n_lvl2(self) -> int:
        return self.lvl2.N


def make_circuit_params(n_lvl0, n_lvl1, n_lvl2, bgbit_lvl1, ell_lvl1, bgbit_lvl2,
                        ell_lvl2, bk_stdev, ks_stdev_10, ks_len_10, ks_basebit_10,
                        ks_stdev_21, ks_len_21, ks_basebit_21,
                        bk_limbs=0) -> CircuitParams:
    lvl1 = TLweParams(N=n_lvl1, k=1, stdev=ks_stdev_21, bits=32)
    lvl2 = TLweParams(N=n_lvl2, k=1, stdev=bk_stdev, bits=64)
    return CircuitParams(
        n_lvl0=n_lvl0,
        lvl1=lvl1,
        lvl2=lvl2,
        tgsw_lvl1=TGswParams(l=ell_lvl1, bgbit=bgbit_lvl1, tlwe=lvl1),
        tgsw_lvl2=TGswParams(l=ell_lvl2, bgbit=bgbit_lvl2, tlwe=lvl2,
                             key_limbs=bk_limbs),
        bk_stdev=bk_stdev,
        ks10=KeySwitchParams(t=ks_len_10, basebit=ks_basebit_10, stdev=ks_stdev_10),
        ks21=KeySwitchParams(t=ks_len_21, basebit=ks_basebit_21, stdev=ks_stdev_21),
    )


# ---------------------------------------------------------------------------
# Named parameter presets
# ---------------------------------------------------------------------------

# The active circuit-bootstrapping block ("144 to ???ms",
# poc_CircuitBootstrapping.cpp:70-85).
CB_ACTIVE = make_circuit_params(
    n_lvl0=500, n_lvl1=1024, n_lvl2=2048,
    bgbit_lvl1=8, ell_lvl1=2, bgbit_lvl2=9, ell_lvl2=4,
    bk_stdev=2.0**-44,
    ks_stdev_10=2.0**-14, ks_len_10=6, ks_basebit_10=2,
    ks_stdev_21=2.0**-31, ks_len_21=10, ks_basebit_21=3,
)

# MXU-shaped circuit-bootstrapping block.  Two TPU-first changes vs
# CB_ACTIVE, both STRICT noise improvements (noise.circuit_bootstrap_
# variances: final variance 2^-47.4 vs 2^-47.1, lvl1 depth 2196 vs 1834):
#
#   * lvl2 gadget Bg=2^9/l=4 -> Bg=2^8/l=5.  The reference picked l=4 to
#     save one iFFT per decomposition on a CPU where doubles hold 9-bit
#     digits natively (poc_CircuitBootstrapping.cpp:70-85).  On the int8
#     MXU a 9-bit digit needs TWO signed planes (engine.plane_split) while
#     an 8-bit digit needs one, so l=5/Bg=2^8 runs 10 digit planes instead
#     of 16 — 1.6x fewer MACs — with a 4x smaller beta^2 amplification and
#     a 2^-41 decomposition tail (vs 2^-37).
#   * bootstrapping key truncated to 6 int8 limbs (top 48 of 64 bits).
#     Truncation noise 2^15/(sqrt(3)*2^64) = 2^-49.8 per coefficient vs
#     the 2^-44 fresh bk noise: effective stdev 2^-44.00 (unchanged to 2
#     decimals) for 25% fewer MACs than the full 8-limb key.
CB_MXU = make_circuit_params(
    n_lvl0=500, n_lvl1=1024, n_lvl2=2048,
    bgbit_lvl1=8, ell_lvl1=2, bgbit_lvl2=8, ell_lvl2=5,
    bk_stdev=2.0**-44,
    ks_stdev_10=2.0**-14, ks_len_10=6, ks_basebit_10=2,
    ks_stdev_21=2.0**-31, ks_len_21=10, ks_basebit_21=3,
    bk_limbs=6,
)

# Alternative blocks kept for parity with the reference's #if chain.
CB_PAPER = make_circuit_params(          # poc_CircuitBootstrapping.cpp:18-34
    n_lvl0=500, n_lvl1=1024, n_lvl2=2048,
    bgbit_lvl1=8, ell_lvl1=4, bgbit_lvl2=9, ell_lvl2=6,
    bk_stdev=2.0**-50,
    ks_stdev_10=2.0**-15, ks_len_10=15, ks_basebit_10=1,
    ks_stdev_21=2.0**-31, ks_len_21=32, ks_basebit_21=1,
)

CB_ALT_180MS = make_circuit_params(      # poc_CircuitBootstrapping.cpp:36-51
    n_lvl0=500, n_lvl1=1024, n_lvl2=2048,
    bgbit_lvl1=8, ell_lvl1=2, bgbit_lvl2=9, ell_lvl2=6,
    bk_stdev=2.0**-45,
    ks_stdev_10=2.0**-14, ks_len_10=11, ks_basebit_10=1,
    ks_stdev_21=2.0**-31, ks_len_21=16, ks_basebit_21=2,
)

CB_ALT_155MS = make_circuit_params(      # poc_CircuitBootstrapping.cpp:53-68
    n_lvl0=500, n_lvl1=1024, n_lvl2=2048,
    bgbit_lvl1=8, ell_lvl1=2, bgbit_lvl2=9, ell_lvl2=4,
    bk_stdev=2.0**-45,
    ks_stdev_10=2.0**-14, ks_len_10=6, ks_basebit_10=2,
    ks_stdev_21=2.0**-31, ks_len_21=16, ks_basebit_21=2,
)

# Gate-bootstrapping sets.  The reference's library files define the API but
# not numeric values; these are the standard published TFHE gate sets.
# GATE_DEFAULT matches the upstream TFHE library's default gate-bootstrapping
# parameters (n=630, N=1024, k=1, l=3, Bgbit=7, ks t=8/basebit=2).
GATE_DEFAULT = GateParams(
    lwe=LweParams(n=630, stdev=2.0**-15),
    tgsw=TGswParams(l=3, bgbit=7, tlwe=TLweParams(N=1024, k=1, stdev=2.0**-25, bits=32)),
    ks=KeySwitchParams(t=8, basebit=2, stdev=2.0**-15),
)

# Faster variant: the upstream-TFHE 2017-era set (n=500, lvl0 stdev 2^-14,
# same N=1024/l=3/Bg=2^7 ring) — 500 instead of 630 CMux steps.
#
# NOTE an l=2/Bg=2^8 set (l*bgbit=16) was tried and REJECTED empirically:
# the decomposition-tail error accumulates super-sqrt(n) through the blind
# rotation (measured ~2^-6 rms output noise with ZERO key noise, ~40x the
# independent-tail model), leaving no gate margin at a 1/16 amplitude.
# Keep l*bgbit >= 21 for torus32 accumulators.
#
# Round-2 re-test WITH real key noise (tools/gadget_ab.py, v5e hardware,
# B=4096): still rejected — output rms 0.038 vs the worksheet's 0.009
# (4.1x), 4/4096 gate failures at n=500 and at n=630.  The tail error is
# feedback, not fresh noise: the test-vector part of the accumulator has
# zero low bits, so each step's rounding error is exactly -(low bits of
# the accumulated noise), correlated across all n steps.  Key noise
# (2^-25) sits at the same magnitude as the 2^-17-per-step tail only
# after hundreds of steps, too late to decorrelate the early trajectory.
GATE_FAST = GateParams(
    lwe=LweParams(n=500, stdev=2.0**-14),
    tgsw=TGswParams(l=3, bgbit=7, tlwe=TLweParams(N=1024, k=1, stdev=2.0**-25, bits=32)),
    ks=KeySwitchParams(t=8, basebit=2, stdev=2.0**-14),
)

# GATE_DEFAULT with the MXU key-truncation knob: bootstrapping-key
# coefficients rounded to their top 24 bits (3 int8 limbs).  Equivalent key
# noise stdev 2^-25.6 — under the 2^-25 fresh bk noise itself — for 25%
# fewer external-product MACs (see TGswParams.key_limbs).
GATE_MXU = GateParams(
    lwe=LweParams(n=630, stdev=2.0**-15),
    tgsw=TGswParams(l=3, bgbit=7, key_limbs=3,
                    tlwe=TLweParams(N=1024, k=1, stdev=2.0**-25, bits=32)),
    ks=KeySwitchParams(t=8, basebit=2, stdev=2.0**-15),
)

# MXU-shaped set exploiting the matmul engine's (k+1)^2*N^2 cost scaling at
# fixed security dimension k*N: k=2/N=512 has the same total dimension
# (kN=1024) and key noise as GATE_MXU's k=1/N=1024, but 1.78x fewer
# external-product MACs ((1024+512)^2 vs (1024+1024)^2).
#
# Security argument (not just "same kN"): the accumulator key is a rank-2
# module-LWE instance over Z[X]/(X^512+1) with binary secret, noise rate
# 2^-25 at q=2^32.  Concrete lattice estimates (primal/dual attacks as in
# the lattice-estimator and the MATZOV analyses) depend on the TOTAL LWE
# dimension kN and the noise rate — the module rank does not open known
# attacks beyond those on the corresponding dimension-1024 LWE problem;
# conversely every attack on rank-2 module-LWE yields one on rank-1
# ring-LWE of the same kN (module-LWE is at least as hard as RLWE at equal
# total dimension, Langlois-Stehle).  So this set is NOT weaker than the
# standard N=1024/k=1 gate set it mirrors; both sit on the same
# maxLog2Alpha curve point (misc/params.html:9-14: n=1024 -> alpha 2^-31
# minimum, ours is 2^-25).  The key_limbs=3 truncation is generated ON the
# coarse lattice (tlwe.encrypt_zero coarse_bits): security is that of LWE
# at modulus 2^24 with relative noise 2^-17, still 7 bits above that curve.
# The price is mod-switch granularity 2N=1024: tmodswitch rises to 2^-14.3,
# still inside the gate budget (noise.gate_bootstrap_variances: worst-case
# gate error < 2^-80).  Gadget stays l=3/Bg=2^7 (see the GATE_FAST note:
# l*bgbit >= 21 is required empirically on torus32).
GATE_MXU2 = GateParams(
    lwe=LweParams(n=630, stdev=2.0**-15),
    tgsw=TGswParams(l=3, bgbit=7, key_limbs=3,
                    tlwe=TLweParams(N=512, k=2, stdev=2.0**-25, bits=32)),
    ks=KeySwitchParams(t=8, basebit=2, stdev=2.0**-15),
)

# GATE_MXU2 with the reference's own level-0 dimension: the circuit-
# bootstrapping PoC's active block uses n_lvl0=500 at ks stdev 2^-14
# (poc_CircuitBootstrapping.cpp:72-76), i.e. the same LWE-500/2^-14 lattice
# point as upstream TFHE's 2017-era gate set.  500 instead of 630 CMux
# steps: the throughput set for v5e-class chips.
GATE_FAST2 = GateParams(
    lwe=LweParams(n=500, stdev=2.0**-14),
    tgsw=TGswParams(l=3, bgbit=7, key_limbs=3,
                    tlwe=TLweParams(N=512, k=2, stdev=2.0**-25, bits=32)),
    ks=KeySwitchParams(t=8, basebit=2, stdev=2.0**-14),
)

# Tiny sets for CPU unit tests: cryptographically meaningless, numerically
# well-conditioned (noise-free or near noise-free) so decryption is exact.
GATE_TOY = GateParams(
    lwe=LweParams(n=16, stdev=2.0**-20),
    tgsw=TGswParams(l=3, bgbit=7, tlwe=TLweParams(N=64, k=1, stdev=2.0**-25, bits=32)),
    ks=KeySwitchParams(t=8, basebit=2, stdev=2.0**-20),
)

CB_TOY = make_circuit_params(
    n_lvl0=12, n_lvl1=64, n_lvl2=128,
    bgbit_lvl1=8, ell_lvl1=2, bgbit_lvl2=9, ell_lvl2=4,
    bk_stdev=2.0**-50,
    ks_stdev_10=2.0**-25, ks_len_10=6, ks_basebit_10=2,
    ks_stdev_21=2.0**-31, ks_len_21=10, ks_basebit_21=3,
)

# CB_PAPER's gadgets and key switches at CB_TOY's widths: l1 = 4, lvl2 Bg =
# 2^9 / l2 = 6 (two digit planes, J*m = 768), the whole 8-limb key, preKS
# t = 15 and privKS t = 32 at base 2.
CB_PAPER_TOY = make_circuit_params(
    n_lvl0=12, n_lvl1=64, n_lvl2=128,
    bgbit_lvl1=8, ell_lvl1=4, bgbit_lvl2=9, ell_lvl2=6,
    bk_stdev=2.0**-50,
    ks_stdev_10=2.0**-25, ks_len_10=15, ks_basebit_10=1,
    ks_stdev_21=2.0**-31, ks_len_21=32, ks_basebit_21=1,
)
