"""Batched TRLWE (TLWE over the ring), as in ``tfhe_tpu.tlwe``
(tlwe_functions.cpp:14-379).

Layout: a TRLWE batch is one tensor (..., k+1, N), int32 (Torus32) or int64
(Torus64), b = [..., k, :].  Encryption draws its randomness on the host
(``TfheRng``, in the JAX package's order) and computes on ``device``, where a
binary key's products are an exact float64 FFT convolution
(``_key_times_fft``): the keygen of a circuit bootstrap runs 327,840 such
products at N=1024, so they run on the card in chunks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tfhe_tpu_torch import device as _device
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.params import TLweParams
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.ops.engine import EngineConfig, make_engine
from tfhe_tpu_torch.ops import poly

# complex128 elements per spectrum chunk of _key_times_fft (256 MiB)
_FFT_CHUNK = 1 << 24


def _key_times_fft(key, x, bits: int):
    """Exact sum_i s_i (*) x[..., i, :] for a BINARY key by float64 real
    FFTs, on x's device.

    The true convolution coefficients of one 32-bit limb are bounded by
    k*N * 2^32 <= 2^44, far inside float64's 2^53 exact-integer range, and
    the length-2N FFT's rounding error (~2^44 * 12 * 2^-52) stays below the
    0.5 rounding threshold, so rint() recovers the exact product.  A 64-bit
    operand is split into two 32-bit limbs (as ``tfhe_tpu.tlwe`` does) and
    recombined mod 2^64.  Rows are processed in chunks of bounded spectrum
    size; the result does not depend on the chunking."""
    k, N = key.shape
    assert k * N <= 4096, "FFT exactness bound needs k*N <= 4096"
    dev = x.device
    sf = torch.fft.rfft(torch.as_tensor(np.asarray(key), dtype=torch.float64,
                                        device=dev), 2 * N)      # (k, N+1)

    def conv(limb):                      # (rows, k, N) -> (rows, N) int64
        cf = (torch.fft.rfft(limb.to(torch.float64), 2 * N) * sf).sum(-2)
        c = torch.fft.irfft(cf, 2 * N)
        return torch.round(c[..., :N] - c[..., N:]).to(torch.int64)

    lead = x.shape[:-2]
    xf = x.reshape(-1, k, N)
    out = torch.empty((xf.shape[0], N), dtype=x.dtype, device=dev)
    rows = max(1, _FFT_CHUNK // (k * (N + 1)))
    for r0 in range(0, xf.shape[0], rows):
        blk = xf[r0:r0 + rows]
        if bits == 32:
            out[r0:r0 + rows] = T.wrap32(conv(blk))
        else:                            # unsigned 32-bit limbs, mod 2^64
            out[r0:r0 + rows] = (conv(blk & T.MASK32)
                                 + (conv(T.srl64(blk, 32)) << 32))
    return out.reshape(*lead, N)


@dataclasses.dataclass
class TLweKey:
    params: TLweParams
    key: np.ndarray                 # (k, N) int32 bits
    _engines: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    @staticmethod
    def generate(params: TLweParams, rng: TfheRng) -> "TLweKey":
        return TLweKey(params, np.asarray(rng.bit((params.k, params.N)), np.int32))

    @staticmethod
    def from_bits(params: TLweParams, bits) -> "TLweKey":
        return TLweKey(params, np.asarray(bits, np.int32).reshape(params.k, params.N))

    def engine(self, backend: str | None = None, device=None):
        """(engine, prepared key) computing sum_i s_i (*) x_i for this key,
        prepared once per backend and device (``device.resolve``: the card
        by default).  ``None`` takes the exact engine ``key_times`` uses:
        matmul at 32 bits, as the JAX package's default, and naive at 64
        (the port's matmul engine takes a 32-bit torus only)."""
        bits = self.params.bits
        backend = backend or ("matmul" if bits == 32 else "naive")
        dev = _device.resolve(device)
        if (backend, dev) not in self._engines:
            cfg = EngineConfig(N=self.params.N, out_bits=bits,
                               digit_bits=bits, key_bits=8)
            eng = make_engine(cfg, backend)
            kp = torch.from_numpy(np.asarray(self.key)).to(dev)[:, None, :]
            if bits == 64:
                kp = kp.to(torch.int64)
            self._engines[backend, dev] = (eng, eng.prepare(kp))
        return self._engines[backend, dev]

    def key_times(self, x):
        """sum_i s_i (*) x[..., i, :] for x (..., k, N) torus (numpy array
        or tensor; the result has the same kind and device).

        Binary keys within the FFT exactness bound take the FFT path; any
        other key runs an exact engine (matmul at 32 bits, the naive oracle
        at 64)."""
        key = np.asarray(self.key)
        is_tensor = isinstance(x, torch.Tensor)
        xt = x if is_tensor else torch.from_numpy(np.asarray(x))
        bits = self.params.bits
        if (key.min() >= 0 and key.max() <= 1
                and key.shape[0] * key.shape[1] <= 4096):
            out = _key_times_fft(key, xt, bits)
        else:
            eng, prep = self.engine(device=xt.device)
            out = eng.accumulate(xt, prep)[..., 0, :]
        return out if is_tensor else out.cpu().numpy()


def encrypt_zero(key: TLweKey, rng: TfheRng, batch_shape=(), stdev=None,
                 coarse_bits: int = 0, device=None):
    """TLWE(0): b = e + sum s_i (*) a_i (tLweSymEncryptZero,
    tlwe_functions.cpp:60-73).  Returns (..., k+1, N), int32 or int64 by the
    key's torus width, on ``device``.

    The mask a and the noise e are drawn on the host in the JAX package's
    order (same seed, same ciphertexts); the product and the rounding run on
    ``device``.  coarse_bits > 0 draws the mask from the
    2^(bits-coarse_bits) lattice and rounds b onto it, so every coefficient
    is a multiple of 2^coarse_bits (the sound way to shrink key material to
    fewer int8 limbs; see ``tfhe_tpu.tlwe.encrypt_zero``)."""
    p = key.params
    stdev = p.stdev if stdev is None else stdev
    dev = _device.resolve(device)
    shape = tuple(batch_shape)
    if p.bits == 32:
        a = rng.uniform32(shape + (p.k, p.N))
        e = rng.gaussian32(np.int32(0), stdev, shape + (p.N,))
    else:
        a = rng.uniform64(shape + (p.k, p.N))
        e = rng.gaussian64(np.int64(0), stdev, shape + (p.N,))
    a = torch.from_numpy(a).to(dev)
    e = torch.from_numpy(e).to(dev)
    if coarse_bits:
        a = a & -(1 << coarse_bits)                 # clear the low bits
        b = T.add(e, key.key_times(a))
        b = T.add(b, 1 << (coarse_bits - 1)) & -(1 << coarse_bits)
    else:
        b = T.add(e, key.key_times(a))
    return torch.cat([a, b[..., None, :]], dim=-2)


def encrypt_poly(key: TLweKey, messages, rng: TfheRng, stdev=None,
                 device=None):
    """TRLWE of torus polynomials (..., N) (tLweSymEncrypt,
    tlwe_functions.cpp:75-82): encrypt_zero plus the messages on b, on
    ``device``."""
    messages = torch.as_tensor(messages)
    c = encrypt_zero(key, rng, tuple(messages.shape[:-1]), stdev,
                     device=device)
    k = key.params.k
    c[..., k, :] = T.add(c[..., k, :], messages.to(c.device))
    return c


def encrypt_scalar(key: TLweKey, mu, rng: TfheRng, batch_shape=(),
                   stdev=None, device=None):
    """TRLWE with the constant-coefficient message mu (tLweSymEncryptT,
    tlwe_functions.cpp:84-88), on ``device``."""
    c = encrypt_zero(key, rng, batch_shape, stdev, device=device)
    k = key.params.k
    c[..., k, 0] = T.add(c[..., k, 0], int(mu))
    return c


def tlwe_phase(samples, key: TLweKey):
    """phi = b - sum s_i (*) a_i (tLwePhase, tlwe_functions.cpp:92-99)."""
    k = key.params.k
    a, b = samples[..., :k, :], samples[..., k, :]
    return T.sub(b, key.key_times(a))


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
