"""Decrypt-probe debugging (the reference's PARANO mode), as in
``tfhe_tpu.boot.probe``.

The reference, compiled without NDEBUG, decrypts the blind-rotation
accumulator after every CMux step and prints the sign/offset of each slot's
phase (poc_CircuitBootstrapping.cpp:539-541, 601-640), plus the phase of
every intermediate LWE and TRGSW row at the top level (:837-866): testing by
decryption with the secret key as the oracle.  Here the step loop is the
production one (``blind_rotate.rotate_steps``, the same engine dispatch and
kernels), with every probed intermediate pulled to the host.  Debug
tooling: each probe synchronises with the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tfhe_tpu_torch import lwe, tlwe
from tfhe_tpu_torch.boot import blind_rotate as br
from tfhe_tpu_torch.params import TGswParams


@dataclasses.dataclass
class StepProbe:
    """Per-step accumulator state (phases are exact decryptions)."""
    step: int
    exponent: np.ndarray          # (B,) rotation exponents used
    phase: np.ndarray             # (B, N) accumulator phase (torus)
    sign: np.ndarray              # (B, N) sign of the phase (+-1)
    rms_noise: float              # rms distance of every slot from the
                                  # nearest test-vector level


def _tensor(x):
    """A tensor as it is; an array (JAX's, or read-only) copied into one."""
    return x if torch.is_tensor(x) else torch.tensor(np.asarray(x))


def _phase_stats(step, a_i, acc, ring_key, mu):
    ph = tlwe.tlwe_phase(acc, ring_key).cpu().numpy()
    sign = np.where(ph >= 0, 1, -1).astype(np.int8)
    # distance to the nearest of {+-mu}: the blind-rotation invariant is
    # that every slot sits near a test-vector level (poc:601-606 prints
    # exactly this sign/offset information)
    dist = np.minimum(np.abs(ph.astype(np.int64) - int(mu)),
                      np.abs(ph.astype(np.int64) + int(mu)))
    bits = 32 if ph.dtype == np.int32 else 64
    rms = float(np.sqrt(np.mean((dist / 2.0**bits) ** 2)))
    return StepProbe(step, a_i.cpu().numpy(), ph, sign, rms)


def blind_rotate_probed(acc, bk_prepared, abar, p: TGswParams,
                        ring_key: tlwe.TLweKey, mu: int,
                        backend: str = "matmul", verbose: bool = False,
                        every: int = 1):
    """Blind rotation with a decrypt probe after every ``every`` steps and
    after the last.  Returns (acc, [StepProbe, ...]).  ``ring_key`` is the
    secret accumulator ring key: a debug oracle, like the reference's
    PARANO mode."""
    n = abar.shape[-1]
    probes = []
    for i, a_i, acc in br.rotate_steps(acc, bk_prepared, abar, p, backend):
        if i % every == 0 or i == n - 1:
            pr = _phase_stats(i, a_i, acc, ring_key, mu)
            probes.append(pr)
            if verbose:
                print(f"[probe] step {i:4d} rms_noise 2^"
                      f"{np.log2(max(pr.rms_noise, 1e-30)):.1f} "
                      f"sign[0,:8]={pr.sign[0, :8].tolist()}")
    return acc, probes


def probe_lwe_phase(samples, key: lwe.LweKey, label: str = "",
                    verbose: bool = False):
    """Phase probe of an LWE batch (the reference's intermediate prints at
    poc:837-842).  Returns the phase array."""
    ph = lwe.phase(_tensor(samples), key).cpu().numpy()
    if verbose:
        print(f"[probe] {label} phase[:8]={ph.reshape(-1)[:8].tolist()}")
    return ph


def probe_tgsw_rows(gsw, ring_key: tlwe.TLweKey, p: TGswParams,
                    message=None, verbose: bool = False):
    """Decrypt-probe every TLWE row of a TRGSW batch (poc:848-866): row
    (bloc u, level w) must have phase ~= m * K_u * h_w with K = [-s, .., 1].

    Returns (B, k+1, l, N) phase arrays; if ``message`` is given, also the
    max absolute deviation of the b-bloc rows' coefficient 0 from m * h_w
    (as a fraction of the torus)."""
    gsw = _tensor(gsw)
    k, l = p.tlwe.k, p.l
    phases = np.stack([
        np.stack([tlwe.tlwe_phase(gsw[..., u, w, :, :], ring_key).cpu()
                  .numpy() for w in range(l)], axis=-2)
        for u in range(k + 1)], axis=-3)          # (B, k+1, l, N)
    if message is None:
        return phases, None
    bits = p.tlwe.bits
    dt64 = phases.astype(np.int64)
    m = np.asarray(message).astype(np.int64)
    devs = []
    for w in range(l):
        exp0 = (m * p.h[w]) % (1 << bits)
        got = dt64[..., k, w, 0] % (1 << bits)
        d = np.minimum((got - exp0) % (1 << bits),
                       (exp0 - got) % (1 << bits))
        devs.append(d)
    max_dev = float(np.max(devs) / 2.0**bits)
    if verbose:
        print(f"[probe] tgsw b-bloc max dev {max_dev:.3e} of torus")
    return phases, max_dev
