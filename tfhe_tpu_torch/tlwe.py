"""Batched TRLWE (TLWE over the ring), as in ``tfhe_tpu.tlwe``
(tlwe_functions.cpp:14-379).

Layout: a TRLWE batch is one int32 tensor (..., k+1, N), b = [..., k, :].
Encryption runs on the host in numpy, where a binary key's products are an
exact float64 FFT convolution (``_host_key_times_fft``), and moves to
``device`` once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tfhe_tpu_torch import device as _device
from tfhe_tpu_torch.params import TLweParams
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.ops.engine import EngineConfig, make_engine
from tfhe_tpu_torch.ops import poly


def _host_key_times_fft(key, x, bits):
    """Exact sum_i s_i (*) x[..., i, :] on the host via numpy real FFTs.

    With a BINARY key the true integer convolution coefficients are bounded
    by k*N * 2^32 <= 2^44, far inside float64's 2^53 exact-integer range, and
    the FFT's rounding error stays below the 0.5 threshold, so rint()
    recovers the exact product."""
    try:                                 # scipy: multithreaded pocketfft
        import scipy.fft as _fft
        _kw = {"workers": -1}
    except ImportError:                  # pragma: no cover
        _fft, _kw = np.fft, {}
    if bits != 32:
        raise NotImplementedError(
            "64-bit TRLWE comes with the circuit-bootstrap slice")
    key = np.asarray(key)
    k, N = key.shape
    assert k * N <= 4096, "FFT fast path exactness bound needs k*N <= 4096"
    sf = _fft.rfft(key.astype(np.float64), 2 * N, axis=-1, **_kw)  # (k, N+1)
    xf = _fft.rfft(x.astype(np.int32).astype(np.float64), 2 * N, axis=-1,
                   **_kw)
    c = _fft.irfft(np.einsum("...kn,kn->...n", xf, sf), 2 * N, axis=-1, **_kw)
    c = np.rint(c[..., :N] - c[..., N:]).astype(np.int64)   # negacyclic
    return c.astype(np.int32)


@dataclasses.dataclass
class TLweKey:
    params: TLweParams
    key: np.ndarray                 # (k, N) int32 bits

    @staticmethod
    def generate(params: TLweParams, rng: TfheRng) -> "TLweKey":
        return TLweKey(params, np.asarray(rng.bit((params.k, params.N)), np.int32))

    @staticmethod
    def from_bits(params: TLweParams, bits) -> "TLweKey":
        return TLweKey(params, np.asarray(bits, np.int32).reshape(params.k, params.N))

    def key_times(self, x):
        """sum_i s_i (*) x[..., i, :] for x (..., k, N) int32 (numpy array
        or tensor; the result has the same kind and device).

        Binary keys within the FFT exactness bound take the host FFT path;
        any other key runs the exact limb-matmul engine."""
        key = np.asarray(self.key)
        is_tensor = isinstance(x, torch.Tensor)
        if (key.min() >= 0 and key.max() <= 1
                and key.shape[0] * key.shape[1] <= 4096):
            host = x.cpu().numpy() if is_tensor else np.asarray(x)
            out = _host_key_times_fft(key, host, self.params.bits)
            return torch.from_numpy(out).to(x.device) if is_tensor else out
        xt = x if is_tensor else torch.from_numpy(np.asarray(x, np.int32))
        cfg = EngineConfig(N=self.params.N, out_bits=self.params.bits,
                           digit_bits=self.params.bits, key_bits=8)
        eng = make_engine(cfg, "matmul")
        kp = torch.from_numpy(key).to(xt.device)[:, None, :]      # (k, 1, N)
        out = eng.accumulate(xt, eng.prepare(kp))[..., 0, :]
        return out if is_tensor else out.numpy()


def _encrypt_zero_host(key: TLweKey, rng: TfheRng, batch_shape, stdev,
                       coarse_bits):
    p = key.params
    if p.bits != 32:
        raise NotImplementedError(
            "64-bit TRLWE comes with the circuit-bootstrap slice")
    a = rng.uniform32(batch_shape + (p.k, p.N))
    e = rng.gaussian32(np.int32(0), stdev, batch_shape + (p.N,))
    if coarse_bits:
        a = ((a.astype(np.uint32) >> coarse_bits) << coarse_bits).astype(np.int32)
        b = e + key.key_times(a)
        half = np.uint32(1 << (coarse_bits - 1))
        b = (((b.astype(np.uint32) + half) >> coarse_bits)
             << coarse_bits).astype(np.int32)
    else:
        b = e + key.key_times(a)
    return np.concatenate([a, b[..., None, :]], axis=-2)


def encrypt_zero(key: TLweKey, rng: TfheRng, batch_shape=(), stdev=None,
                 coarse_bits: int = 0, device=None):
    """TLWE(0): b = e + sum s_i (*) a_i (tLweSymEncryptZero,
    tlwe_functions.cpp:60-73).  Returns (..., k+1, N) int32 on ``device``.

    coarse_bits > 0 draws the mask from the 2^(32-coarse_bits) lattice and
    rounds b onto it, so every coefficient is a multiple of 2^coarse_bits
    (the sound way to shrink key material to fewer int8 limbs; see
    ``tfhe_tpu.tlwe.encrypt_zero``)."""
    stdev = key.params.stdev if stdev is None else stdev
    dev = _device.resolve(device)
    c = _encrypt_zero_host(key, rng, tuple(batch_shape), stdev, coarse_bits)
    return torch.from_numpy(c).to(dev)


def noiseless_trivial_poly(mu, k: int):
    """(0, mu) (tLweNoiselessTrivial, tlwe_functions.cpp:146-152)."""
    a = torch.zeros(mu.shape[:-1] + (k, mu.shape[-1]), dtype=mu.dtype,
                    device=mu.device)
    return torch.cat([a, mu[..., None, :]], dim=-2)


def mul_by_xai_minus_one(power, samples):
    """(X^power - 1) * sample across all k+1 polynomials
    (tLweMulByXaiMinusOne, tlwe_functions.cpp:209-213)."""
    return poly.mul_by_xai_minus_one(power, samples)


def extract_lwe(samples, index: int = 0):
    """TRLWE -> LWE at coefficient ``index`` (tlwe_functions.cpp:351-362)."""
    return poly.sample_extract(samples, index)
