"""Gate bootstrapping (lwe_functions.cpp:399-446) and the homomorphic boolean
gate set built on it, as in ``tfhe_tpu.boot.gate``.

Booleans use the standard TFHE encoding: False = -1/8, True = +1/8 on the
torus.  Each binary gate is one affine combination of input LWE samples
followed by one bootstrap with test vector [1/8, ..., 1/8].

Key material is a plain dict of tensors (``CloudKey.data``: ``bk`` holds the
engine-prepared bootstrapping key stacked over the n steps, ``ksw`` the key
switch limb matrices).  Keys are generated on the host with numpy and moved
to the device once; the chunked engine's pre-shifted key is built on the
device from the raw TRGSW.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tfhe_tpu_torch import device as _device
from tfhe_tpu_torch import graphs, lwe, tlwe, tgsw
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.boot import blind_rotate as br
from tfhe_tpu_torch.ops.engine import make_engine, prepare_stacked
from tfhe_tpu_torch.params import GateParams, LweParams
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.utils import observability as obs

MU_BOOL = 1 << 29            # 1/8 as Torus32


@dataclasses.dataclass
class SecretKey:
    params: GateParams
    lwe_key: lwe.LweKey          # small key (level 0 analog)
    ring_key: tlwe.TLweKey       # accumulator ring key
    extracted_key: lwe.LweKey    # ring key reinterpreted as LWE(k*N)

    @staticmethod
    def generate(params: GateParams, rng: TfheRng) -> "SecretKey":
        lk = lwe.LweKey.generate(params.lwe, rng)
        rk = tlwe.TLweKey.generate(params.tgsw.tlwe, rng)
        return SecretKey.from_keys(params, lk, rk)

    @staticmethod
    def from_keys(params: GateParams, lk: lwe.LweKey,
                  rk: tlwe.TLweKey) -> "SecretKey":
        ek = lwe.LweKey(LweParams(n=rk.params.extracted_n),
                        rk.key.reshape(-1))
        return SecretKey(params, lk, rk, ek)


@dataclasses.dataclass
class CloudKey:
    """Bootstrapping key (TRGSW of every small-key bit, engine-prepared and
    stacked over steps) + key switch back to the small key
    (LweBootstrappingKeyFFT, lwe_functions.cpp:265-309)."""

    params: GateParams
    backend: str
    bk_prepared: dict              # tensors with leading axis n
    ksk: lwe.KeySwitchKey

    @staticmethod
    def generate(sk: SecretKey, rng: TfheRng, backend: str = "matmul",
                 keep_raw_ks: bool = False, device=None) -> "CloudKey":
        """Consumes ``rng`` in the JAX package's order (bootstrapping key
        first, then the key switch), so one seed gives identical keys."""
        dev = _device.resolve(device)
        p = sk.params
        with obs.span("keygen.gate"):
            gsw = tgsw.encrypt(sk.ring_key, sk.lwe_key.key, p.tgsw, rng,
                               stdev=p.tgsw.tlwe.stdev, device="cpu")
            eng = make_engine(tgsw.engine_config(p.tgsw), backend)
            prep = prepare_stacked(eng, tgsw.rows(gsw), dev)
            ksk = lwe.KeySwitchKey.generate(sk.extracted_key, sk.lwe_key,
                                            p.ks, rng, keep_raw=keep_raw_ks,
                                            device=dev)
        return CloudKey(p, backend, prep, ksk)

    @property
    def data(self):
        return {"bk": self.bk_prepared, "ksw": self.ksk.w_limbs}


def bootstrap_woks(samples, bk_prepared, params: GateParams, mu: int = MU_BOOL,
                   backend: str = "matmul"):
    """Mod-switch + blind-rotate + extract (tfhe_bootstrap_woKS_FFT,
    lwe_functions.cpp:399-428): output is LWE(k*N) of +-mu by sign(phase)."""
    N = params.N
    a, b = samples[..., :-1], samples[..., -1]
    barb = T.mod_switch_from_torus32(b, 2 * N)
    bara = T.mod_switch_from_torus32(a, 2 * N)
    testvect = torch.full((N,), mu, dtype=torch.int32, device=samples.device)
    return br.rotate_and_extract(testvect, bk_prepared, barb, bara,
                                 params.tgsw, backend)


def _bootstrap(samples, key_data, params, mu, backend):
    u = bootstrap_woks(samples, key_data["bk"], params, mu, backend)
    ksk = lwe.KeySwitchKey(params.ks, params.tgsw.tlwe.extracted_n,
                           params.lwe.n, key_data["ksw"])
    return lwe.keyswitch(u, ksk)


def _count_launch(samples):
    obs.count("bootstrap.launches")
    obs.count("bootstrap.ciphertexts",
              int(np.prod(tuple(samples.shape[:-1]))) or 1)


def bootstrap(samples, key_data, params: GateParams, mu: int = MU_BOOL,
              backend: str = "matmul"):
    """Full gate bootstrap: woKS + key switch (tfhe_bootstrap_FFT,
    lwe_functions.cpp:434-446).  samples: (B, n+1) int32."""
    _count_launch(samples)
    return _bootstrap(samples, key_data, params, mu, backend)


def make_bootstrap_fn(params: GateParams, mu: int = MU_BOOL,
                      backend: str = "matmul"):
    """(key_data, samples) -> bootstrapped samples, the JAX package's jitted
    bootstrap.  On the card the whole bootstrap (mod switch, test vector,
    rotation, extract, key switch) is one captured CUDA graph per samples
    shape and key (``graphs.run``), replayed on later calls; the
    ``bootstrap.*`` counters count outside it, once per call, as the JAX
    package counts outside its jit; a call is the span ``graph.bootstrap``
    (``graphs.run``)."""
    def fn(key_data, samples):
        _count_launch(samples)
        return graphs.run(
            "bootstrap", (params, mu, backend),
            lambda s: _bootstrap(s, key_data, params, mu, backend),
            (samples,), graphs.leaves(key_data), backend=backend)
    return fn


# ---------------------------------------------------------------------------
# Homomorphic gates (upstream TFHE boolean API)
# ---------------------------------------------------------------------------

def _trivial(mu, n, device):
    # a fill on the device, no host-to-device copy: a graph captures it
    return lwe.noiseless_trivial(
        torch.full((), mu, dtype=torch.int32, device=device), n)


def encrypt_bool(sk: SecretKey, bits, rng: TfheRng, device=None):
    msgs = np.where(np.asarray(bits).astype(bool), MU_BOOL, -MU_BOOL).astype(np.int32)
    return lwe.encrypt(sk.lwe_key, msgs, rng, sk.params.lwe.stdev,
                       device=device)


def decrypt_bool(sk: SecretKey, samples):
    return lwe.phase(samples, sk.lwe_key).cpu().numpy() > 0


def gate_nand(ck_data, x, y, params, backend="matmul"):
    t = _trivial(MU_BOOL, params.lwe.n, x.device) - x - y
    return bootstrap(t, ck_data, params, MU_BOOL, backend)


def gate_and(ck_data, x, y, params, backend="matmul"):
    t = _trivial(-MU_BOOL, params.lwe.n, x.device) + x + y
    return bootstrap(t, ck_data, params, MU_BOOL, backend)


def gate_or(ck_data, x, y, params, backend="matmul"):
    t = _trivial(MU_BOOL, params.lwe.n, x.device) + x + y
    return bootstrap(t, ck_data, params, MU_BOOL, backend)


def gate_nor(ck_data, x, y, params, backend="matmul"):
    t = _trivial(-MU_BOOL, params.lwe.n, x.device) - x - y
    return bootstrap(t, ck_data, params, MU_BOOL, backend)


def gate_xor(ck_data, x, y, params, backend="matmul"):
    t = _trivial(1 << 30, params.lwe.n, x.device) + 2 * (x + y)
    return bootstrap(t, ck_data, params, MU_BOOL, backend)


def gate_xnor(ck_data, x, y, params, backend="matmul"):
    t = _trivial(-(1 << 30), params.lwe.n, x.device) - 2 * (x + y)
    return bootstrap(t, ck_data, params, MU_BOOL, backend)


def gate_not(x):
    """NOT is free: negate the sample (no bootstrap needed)."""
    return -x


def gate_constant(value, n: int, device=None):
    """Noiseless trivial sample of a known bit (upstream bootsCONSTANT)."""
    return _trivial(MU_BOOL if value else -MU_BOOL, n,
                    _device.resolve(device))


def gate_copy(x):
    """Upstream bootsCOPY (no bootstrap)."""
    return x.clone()


def gate_andny(ck_data, x, y, params, backend="matmul"):
    """(NOT x) AND y (upstream bootsANDNY)."""
    t = _trivial(-MU_BOOL, params.lwe.n, x.device) - x + y
    return bootstrap(t, ck_data, params, MU_BOOL, backend)


def gate_andyn(ck_data, x, y, params, backend="matmul"):
    """x AND (NOT y) (upstream bootsANDYN)."""
    t = _trivial(-MU_BOOL, params.lwe.n, x.device) + x - y
    return bootstrap(t, ck_data, params, MU_BOOL, backend)


def gate_orny(ck_data, x, y, params, backend="matmul"):
    """(NOT x) OR y (upstream bootsORNY)."""
    t = _trivial(MU_BOOL, params.lwe.n, x.device) - x + y
    return bootstrap(t, ck_data, params, MU_BOOL, backend)


def gate_oryn(ck_data, x, y, params, backend="matmul"):
    """x OR (NOT y) (upstream bootsORYN)."""
    t = _trivial(MU_BOOL, params.lwe.n, x.device) + x - y
    return bootstrap(t, ck_data, params, MU_BOOL, backend)


def gate_mux(ck_data, c, x, y, params, backend="matmul"):
    """MUX(c, x, y) = c ? x : y as three full gate bootstraps (key switch
    included), as the JAX package computes it: u = bootstrap([c + x - 1/8,
    -c + y - 1/8]) as ONE double-width launch, then bootstrap(u0 + u1 +
    1/8), so a mux costs 2 launches.

    Upstream bootsMUX (tfhe_gate_bootstrapping.cpp) differs: its two
    first-stage bootstraps stop before the key switch (two blind rotations,
    tfhe_bootstrap_woKS_FFT), u0 + u1 + 1/8 is formed on the extracted
    N-dimensional samples, and one key switch ends it: two rotations and
    one key switch against three of each here.  The arithmetic stays the
    JAX package's, the bit-for-bit reference."""
    n = params.lwe.n
    t1 = _trivial(-MU_BOOL, n, c.device) + c + x
    t2 = _trivial(-MU_BOOL, n, c.device) - c + y
    tt = torch.stack([t1, t2])
    u = bootstrap(tt.reshape(-1, tt.shape[-1]), ck_data, params, MU_BOOL,
                  backend).reshape(tt.shape)
    t = u[0] + u[1] + _trivial(MU_BOOL, n, c.device)
    return bootstrap(t, ck_data, params, MU_BOOL, backend)
