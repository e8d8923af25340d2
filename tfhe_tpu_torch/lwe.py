"""Batched LWE samples, encryption, phase and key switching
(lwe_functions.cpp:17-241), as in ``tfhe_tpu.lwe``.

Layout: an LWE batch is one int32 tensor (..., n+1), body b at index n.
Encryption runs on the host in numpy (it consumes the ``TfheRng`` stream in
the JAX package's order) and the result moves to ``device`` once.

Key switching is a one-hot int8 GEMM: the digits of every mask coefficient
become a one-hot vector and the translation is (B, n*t*base) @ (n*t*base,
n_out+1) per int8 limb of the key table.  On the GPU this is
``torch._int_mm`` (the JAX package leaves the same matmul to XLA); its
column count must be a multiple of 8, so the limb matrices keep their
columns padded (``KeySwitchKey.w_limbs``) and results are sliced.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tfhe_tpu_torch import device as _device
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.params import LweParams, KeySwitchParams
from tfhe_tpu_torch.rng import TfheRng


@dataclasses.dataclass
class LweKey:
    params: LweParams
    key: np.ndarray                # (n,) int32 bits

    @staticmethod
    def generate(params: LweParams, rng: TfheRng) -> "LweKey":
        return LweKey(params, np.asarray(rng.bit((params.n,)), np.int32))


def _encrypt_host(key: LweKey, messages, rng: TfheRng, stdev: float):
    messages = np.asarray(messages, np.int32)
    a = rng.uniform32(messages.shape + (key.params.n,))
    b = rng.gaussian32(messages, stdev, messages.shape)
    b = (b.astype(np.int64)
         + a.astype(np.int64) @ key.key.astype(np.int64)).astype(np.int32)
    return np.concatenate([a, b[..., None]], axis=-1)


def encrypt(key: LweKey, messages, rng: TfheRng, stdev: float | None = None,
            device=None):
    """b = gaussian(m, stdev) + sum a_i s_i (lweSymEncrypt,
    lwe_functions.cpp:42-52).  messages: (...,) int32 torus values.
    Returns (..., n+1) int32 on ``device``."""
    stdev = key.params.stdev if stdev is None else stdev
    dev = _device.resolve(device)
    return torch.from_numpy(_encrypt_host(key, messages, rng, stdev)).to(dev)


def noiseless_trivial(mu, n: int):
    """(0, mu) (lweNoiselessTrivial, lwe_functions.cpp:75-81)."""
    mu = torch.as_tensor(mu).to(torch.int32)
    a = torch.zeros(mu.shape + (n,), dtype=torch.int32, device=mu.device)
    return torch.cat([a, mu[..., None]], dim=-1)


def phase(samples, key: LweKey):
    """phi = b - sum a_i s_i (lwePhase, lwe_functions.cpp:55-65)."""
    s = torch.as_tensor(key.key, device=samples.device).to(torch.int64)
    a, b = samples[..., :-1], samples[..., -1]
    return T.wrap32(b.to(torch.int64) - (a.to(torch.int64) * s).sum(-1))


def decrypt(samples, key: LweKey, msize: int):
    """approxPhase(phase) (lweSymDecrypt, lwe_functions.cpp:68-73)."""
    return T.approx_phase32(phase(samples, key), msize)


# ---------------------------------------------------------------------------
# Key switching
# ---------------------------------------------------------------------------

def _pad8(n: int) -> int:
    return -(-n // 8) * 8


@dataclasses.dataclass
class KeySwitchKey:
    """ks[i][j][v] = Enc_out(in_key[i] * v * 2^(32-(j+1)basebit))
    (lweCreateKeySwitchKey_fromArray, lwe_functions.cpp:117-131), stored as
    int8 limb matrices (4, n_in*t*base, pad8(n_out+1)): columns past n_out
    are zero."""

    ks: KeySwitchParams
    n_in: int
    n_out: int
    w_limbs: torch.Tensor
    raw: np.ndarray | None = None  # (n_in, t, base, n_out+1) int32

    @staticmethod
    def generate(in_key: LweKey, out_key: LweKey, ks: KeySwitchParams,
                 rng: TfheRng, keep_raw: bool = True,
                 device=None) -> "KeySwitchKey":
        n_in = in_key.params.n
        shifts = np.array([32 - (j + 1) * ks.basebit for j in range(ks.t)])
        m = (in_key.key[:, None, None].astype(np.int64)
             << shifts[None, :, None]) * np.arange(ks.base)[None, None, :]
        m = m.astype(np.uint64).astype(np.uint32).astype(np.int32)
        table = _encrypt_host(out_key, m, rng, ks.stdev)  # (n_in,t,base,n_out+1)
        return KeySwitchKey.from_raw(table, ks, keep_raw, device)

    @staticmethod
    def from_raw(table, ks: KeySwitchParams, keep_raw: bool = True,
                 device=None) -> "KeySwitchKey":
        """Build the limb-matmul form from a raw (n_in, t, base, n_out+1)
        int32 sample table."""
        table = np.asarray(table, np.int32)
        n_in, t, base, np1 = table.shape
        assert t == ks.t and base == ks.base
        w = table.copy()
        w[:, :, 0, :] = 0          # digit 0 contributes nothing
        w = torch.from_numpy(w.reshape(n_in * t * base, np1))
        return KeySwitchKey.from_limbs(T.balanced_limbs(w, 4, 8), ks, n_in,
                                       np1 - 1, device,
                                       raw=table if keep_raw else None)

    @staticmethod
    def from_limbs(w_limbs, ks: KeySwitchParams, n_in: int, n_out: int,
                   device=None, raw=None) -> "KeySwitchKey":
        """Wrap (4, n_in*t*base, n_out+1 or more) int8 limb matrices, padding
        the columns to a multiple of 8 and moving them to ``device``."""
        w_limbs = torch.as_tensor(w_limbs).to(torch.int8)
        pad = _pad8(n_out + 1) - w_limbs.shape[-1]
        if pad > 0:
            w_limbs = torch.nn.functional.pad(w_limbs, (0, pad))
        return KeySwitchKey(ks, n_in, n_out,
                            w_limbs.contiguous().to(_device.resolve(device)),
                            raw)


def keyswitch_digits(samples_a, ks: KeySwitchParams):
    """Unsigned rounding digit decomposition of LWE mask coefficients
    (lwe_functions.cpp:139-151).  Returns (..., n, t) int32."""
    prec_offset = 1 << (32 - (1 + ks.basebit * ks.t))
    aibar = (T.u32(samples_a) + prec_offset) & T.MASK32
    digs = [(aibar >> (32 - (j + 1) * ks.basebit)) & (ks.base - 1)
            for j in range(ks.t)]
    return torch.stack(digs, dim=-1).to(torch.int32)


def _int8_matmul(x, w):
    """x (M, K) int8 @ w (K, N) int8 -> (M, N) int32, exact.  cuBLAS's int8
    GEMM on the GPU needs more than 16 rows, so short batches are padded."""
    M = x.shape[0]
    if x.device.type == "cuda":
        if M <= 16:
            x = torch.nn.functional.pad(x, (0, 0, 0, 32 - M))
        return torch._int_mm(x, w)[:M]
    return torch._int_mm(x, w)


def keyswitch(samples, ksk: KeySwitchKey):
    """result = (0, b) - sum_{i,j} ks[i][j][digit_ij]  (lweKeySwitch,
    lwe_functions.cpp:163-172) as a one-hot int8 GEMM."""
    a, b = samples[..., :-1], samples[..., -1]
    lead = samples.shape[:-1]
    digs = keyswitch_digits(a, ksk.ks)                       # (..., n, t)
    base = torch.arange(ksk.ks.base, device=samples.device, dtype=torch.int32)
    onehot = (digs[..., None] == base).to(torch.int8)
    onehot = onehot.reshape(-1, a.shape[-1] * ksk.ks.t * ksk.ks.base)
    acc = torch.zeros((onehot.shape[0], ksk.w_limbs.shape[-1]),
                      dtype=torch.int64, device=samples.device)
    for lm in range(ksk.w_limbs.shape[0]):
        acc = acc + (_int8_matmul(onehot, ksk.w_limbs[lm]).to(torch.int64)
                     << (8 * lm))
    acc = acc[:, :ksk.n_out + 1].reshape(*lead, ksk.n_out + 1)
    triv = noiseless_trivial(b, ksk.n_out).to(torch.int64)
    return T.wrap32(triv - acc)
