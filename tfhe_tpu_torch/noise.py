"""Noise-budget calculators, the port's own copy of ``tfhe_tpu.noise``: the
Python form of the reference's offline HTML/JS worksheets
(misc/params.html:8-137 for circuit bootstrapping, misc/params-gb.html:9-133
for gate bootstrapping).  Pure float math.

All variances are in torus units (fractions of 1).  Naming follows the JS:
  tpreks1/tpreks2 — key-switch noise / decomposition-tail of preKS
  tmodswitch      — mod-switch rounding before blind rotation
  tbk1/tbk2       — bootstrapping-key noise / gadget tail of the rotation
  tks1/tks2       — (private) key-switch noise / decomposition tail
"""

from __future__ import annotations

import dataclasses
import math

from tfhe_tpu_torch.params import CircuitParams, GateParams


def max_log2_alpha(n: int) -> float:
    """Maximal -log2(alpha) for ~128-bit security on the reference's
    "asiacrypt rainbow curve" (params.html:9-14)."""
    if n < 256:
        return 0.0
    return 7 + (n - 256) / 32


def erf(x: float) -> float:
    return math.erf(x)


def log2_error_probability(amplitude: float, variance: float) -> float:
    """log2 P(|gaussian(variance)| > amplitude) (params-gb.html:106-110)."""
    if variance <= 0:
        return -math.inf
    z = amplitude / math.sqrt(2 * variance)
    p = 1 - math.erf(z)
    return math.log2(p) if p > 0 else -1074.0


@dataclasses.dataclass
class CircuitNoise:
    tpreks1: float
    tpreks2: float
    tmodswitch: float
    critical_total: float
    max_bootstrappable_variance: float
    tbk1: float
    tbk2: float
    tks1: float
    tks2: float
    final_variance: float          # variance of each TRGSW row after CB
    tgsw_overhead: float           # per-CMux variance added when the output
    max_lvl1_depth: float          # TRGSW drives level-1 CMuxes


def circuit_bootstrap_variances(p: CircuitParams) -> CircuitNoise:
    """Port of computeAll in misc/params.html:47-127."""
    n0, n1, n2 = p.n_lvl0, p.n_lvl1, p.n_lvl2
    ks10, ks21 = p.ks10, p.ks21
    ks10_var = ks10.stdev**2
    ks21_var = ks21.stdev**2
    bk_var = p.bk_stdev**2

    tpreks1 = n1 * ks10.t * ks10_var
    tpreks2 = n1 * 2.0 ** (-2 * (ks10.t * ks10.basebit + 1))
    tmodswitch = (n0 + 1) / (16.0 * n2 * n2)
    critical_total = tpreks1 + tpreks2 + tmodswitch
    max_bootstrappable = 2.0**-10 - critical_total

    l2, bg2 = p.tgsw_lvl2.l, p.tgsw_lvl2.bgbit
    beta2 = 2.0 ** (bg2 - 1)
    eps2 = 2.0 ** (-(l2 * bg2 + 1))
    tbk1 = n0 * 2 * l2 * n2 * beta2 * beta2 * bk_var
    tbk2 = n0 * (1 + n2) * eps2 * eps2
    tks1 = n2 * ks21.t * ks21_var
    tks2 = n2 * 2.0 ** (-2 * (ks21.t * ks21.basebit + 1))
    finalvar = tbk1 + tbk2 + tks1 + tks2

    l1, bg1 = p.tgsw_lvl1.l, p.tgsw_lvl1.bgbit
    beta1 = 2.0 ** (bg1 - 1)
    eps1 = 2.0 ** (-(l1 * bg1 + 1))
    tgsw1 = 2 * l1 * n1 * beta1 * beta1 * finalvar
    tgsw2 = (1 + n1) * eps1 * eps1
    overhead = tgsw1 + tgsw2
    return CircuitNoise(
        tpreks1=tpreks1, tpreks2=tpreks2, tmodswitch=tmodswitch,
        critical_total=critical_total,
        max_bootstrappable_variance=max_bootstrappable,
        tbk1=tbk1, tbk2=tbk2, tks1=tks1, tks2=tks2,
        final_variance=finalvar, tgsw_overhead=overhead,
        max_lvl1_depth=max_bootstrappable / overhead,
    )


@dataclasses.dataclass
class GateNoise:
    tmodswitch: float
    max_bootstrappable_variance: float
    tbk1: float
    tbk2: float
    tks1: float
    tks2: float
    final_variance: float
    log2_err_single: float         # fresh bootstrap vs 1/16 amplitude
    log2_err_gate: float           # worst-case gate (sum of 2) vs 1/8
    bootstrappable: bool


def gate_bootstrap_variances(p: GateParams) -> GateNoise:
    """Port of computeAll in misc/params-gb.html:49-113, generalized from the
    worksheet's hard-coded k=1 to any ring rank k: the (k+1) factor in tbk1,
    (1+kN) in tbk2, and the extracted dimension kN in tks1/tks2."""
    n0, n1 = p.lwe.n, p.N
    k = p.tgsw.tlwe.k
    n_ext = p.tgsw.tlwe.extracted_n          # k*N, dimension after extract
    critical_variance = 2.0**-11.4
    tmodswitch = (n0 + 1) / (3.0 * 16 * n1 * n1)
    max_bootstrappable = critical_variance - tmodswitch

    l1, bg1 = p.tgsw.l, p.tgsw.bgbit
    beta = 2.0 ** (bg1 - 1)
    eps = 2.0 ** (-(l1 * bg1 + 1))
    bk_var = p.tgsw.tlwe.stdev**2
    ks_var = p.ks.stdev**2
    tbk1 = n0 * (k + 1) * l1 * n1 * beta * beta * bk_var
    tbk2 = n0 * (1 + k * n1) * eps * eps
    tks2 = n_ext * 2.0 ** (-2 * (p.ks.t * p.ks.basebit + 1))
    tks1 = n_ext * p.ks.t * ks_var
    finalvar = tbk1 + tbk2 + tks1 + tks2
    return GateNoise(
        tmodswitch=tmodswitch,
        max_bootstrappable_variance=max_bootstrappable,
        tbk1=tbk1, tbk2=tbk2, tks1=tks1, tks2=tks2,
        final_variance=finalvar,
        log2_err_single=log2_error_probability(1 / 16, finalvar),
        log2_err_gate=log2_error_probability(1 / 8, 4 * finalvar + tmodswitch),
        bootstrappable=(4 * finalvar) < max_bootstrappable,
    )


def key_truncation_variance(p: GateParams) -> float:
    """Extra per-bootstrap output variance from TGswParams.key_limbs — the
    bootstrapping key mod-switched AT KEYGEN to the 2^(bits-8*key_limbs)
    lattice (tlwe.encrypt_zero coarse_bits).

    Rounding b onto the coarse lattice adds uniform +-2^(coarse-1) phase
    noise per sample, which propagates exactly like bootstrapping-key noise:
      var = n0 * (k+1) * l * N * beta^2 * Var(round)      (tbk1 structure,
                                                           params-gb.html:72)

    NOTE truncating an already-generated key instead puts the rounding
    error on the mask, where the phase convolves it with the ring key —
    a (1+kN)x amplification that measured 2^-5.2 rms through a full blind
    rotation (vs 2^-9.7 for the keygen-lattice scheme's decomp tail).
    engine.py therefore relies on keys being lattice-generated; its limb
    rounding is then exact."""
    t = p.tgsw
    bits = t.tlwe.bits
    full = -(-bits // 8)
    limbs = t.key_limbs or full
    coarse = max(0, bits - 8 * limbs)
    if coarse == 0:
        return 0.0
    var_round = (2.0 ** (coarse - bits)) ** 2 / 12.0
    beta2 = 2.0 ** (2 * (t.bgbit - 1))
    return p.lwe.n * (t.tlwe.k + 1) * t.l * t.tlwe.N * beta2 * var_round


def split_mr(N: int) -> tuple[int, int]:
    """N = m * r with m = 2^floor(log4 N) <= r, the Nussbaumer engine's
    split (``tfhe_tpu.ops.nussbaumer.split_mr``)."""
    k = N.bit_length() - 1
    m = 1 << (k // 2)
    return m, N // m


def nussbaumer_fold_variance(p: GateParams) -> float:
    """Extra per-bootstrap output variance from the Nussbaumer engine's
    1/2m scale fold: key coefficients are pre-divided by 2m with rounding,
    eps = k - 2m*round(k/2m) uniform in +-m absolute."""
    t = p.tgsw
    m, _ = split_mr(t.tlwe.N)
    var_eps = ((2 * m) ** 2 / 12.0) * (2.0 ** -t.tlwe.bits) ** 2
    var_digit = (2.0 ** t.bgbit) ** 2 / 12.0
    return p.lwe.n * (t.tlwe.k + 1) * t.l * t.tlwe.N * var_digit * var_eps


def shared_rotation_penalty(p: CircuitParams) -> float:
    """TRGSW-row variance growth from reusing ONE blind rotation for all
    ell1 levels (boot.circuit): the w=0 sample is the w=ell1-1
    sample shifted left by bgbit1*(ell1-1), which multiplies the rotation
    noise variance (tbk1+tbk2) by 2^(2*bgbit1*(ell1-1)).

    Returns finalvar_shared / finalvar_separate for the worst row; the
    bootstrapper's auto mode shares only when this is <= 4 (at most a 2x
    stdev growth).  For CB_ACTIVE the ratio is ~10^4: the decomposition
    tail tbk2 amplified by 2^16 dwarfs the privKS noise, so the reference's
    per-level rotations are kept there."""
    l1, bg1 = p.tgsw_lvl1.l, p.tgsw_lvl1.bgbit
    amp = 2.0 ** (2 * bg1 * (l1 - 1))
    r = circuit_bootstrap_variances(p)
    rot_var = r.tbk1 + r.tbk2
    ks_var = r.tks1 + r.tks2
    return (amp * rot_var + ks_var) / (rot_var + ks_var)


SHARED_ROTATION_MAX_PENALTY = 4.0
