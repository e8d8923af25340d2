"""Carry keys made by the JAX package (``tfhe_tpu``) into this port.

Both functions take plain numpy arrays (convert a JAX array with
``np.asarray`` first), so the port never sees a JAX object:

  * the secret key: the ``lwe_key.key`` and ``ring_key.key`` bits;
  * the cloud key: ``key_data = {"bk": {...}, "ksw": ...}`` as in
    ``tfhe_tpu.boot.gate.CloudKey.data`` — ``bk`` is the engine-prepared
    bootstrapping key, ``{"v": (n, L, J, U, 2N) int8}`` for ``onthefly``,
    ``{"w": (n, L, J*N, U*N) int8}`` for ``matmul``, ``{"wm": (n, U*L, J*m,
    N+m) int8}`` for ``chunked`` (m = 128, or N below that),
    ``{"k": (n, J*U*L, 1, 2N-1)}`` int8 (bfloat16) for ``conv``
    (``conv_bf16``), ``{"w": (n, 2m, J*r, U*L*r) int8}`` for
    ``nussbaumer``, ``{"hat": (n, J, U, N/2) complex128}`` for ``fft`` and
    ``fft_f64``, ``{"hat": (4 parts (n, J, U, N/2) float32)}`` for
    ``fft_dd``, ``{"mat": ...}`` for ``naive``; ``ksw`` is (4,
    n_in*t*base, n_out+1) int8;
  * the circuit-bootstrap keys: the three secret keys' bits, and
    ``key_data = {"preks", "bk", "privks"}`` as in
    ``tfhe_tpu.boot.circuit.CircuitCloudKey.data`` — ``preks`` (4,
    n1*t*base, n0+1) int8 limbs, ``bk`` ``{"wm": (n0, U*L, J*m, N2+m)
    int8}`` for ``chunked`` (any other backend's prepared key as above),
    ``privks`` (k+1, 4, (n2+1)*t*base, (k+1)*N1) int8 limbs.  A chunked
    ``bk`` is converted to the port's 64-bit prepared key, the K-packed
    ``{"wmt": (n0, U*L, N2+m, J*m) int8}`` that ``ChunkedEngine.prepare``
    builds (each step's ``wm`` transposed on the device in turn, so the two
    stacks never share the card).

Both packages then compute the same function on the same keys.
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_tpu_torch import device as _device
from tfhe_tpu_torch import lwe, tlwe
from tfhe_tpu_torch.boot import circuit
from tfhe_tpu_torch.boot.gate import CloudKey, SecretKey
from tfhe_tpu_torch.ops import kernels
from tfhe_tpu_torch.ops.engine import map_prepared
from tfhe_tpu_torch.params import CircuitParams, GateParams, LweParams
from tfhe_tpu_torch.utils.serialization import tensor_from_numpy

_BK_LEAF = {"onthefly": "v", "matmul": "w", "naive": "mat", "chunked": "wm",
            "conv": "k", "conv_bf16": "k", "nussbaumer": "w", "fft": "hat",
            "fft_f64": "hat", "fft_dd": "hat"}


def _bk(key_data, backend, dev):
    if backend not in _BK_LEAF:
        raise ValueError(f"no conversion for backend {backend!r}")
    if set(key_data["bk"]) != {_BK_LEAF[backend]}:
        raise ValueError(f"backend {backend!r} expects bk key "
                         f"{_BK_LEAF[backend]!r}, got {sorted(key_data['bk'])}")
    # a tuple leaf (fft_dd's four f32 parts) converts part by part
    return map_prepared(lambda v: tensor_from_numpy(v).to(dev),
                        {name: tuple(v) if isinstance(v, (tuple, list)) else v
                         for name, v in key_data["bk"].items()})


def _k_packed_bk(key_data, dev):
    """The JAX package's 64-bit chunked bk {"wm": (n0, U*L, J*m, N+m)} ->
    {"wmt": (n0, U*L, N+m, J*m)} on ``dev``, one step's wm moved and
    transposed at a time."""
    if set(key_data["bk"]) != {"wm"}:
        raise ValueError(f"backend 'chunked' expects bk key 'wm', got "
                         f"{sorted(key_data['bk'])}")
    wm = np.asarray(key_data["bk"]["wm"])
    n, UL, Jm, Npm = wm.shape
    wmt = torch.empty((n, UL, Npm, Jm), dtype=torch.int8, device=dev)
    for i in range(n):
        wmt[i] = kernels.ck_wmt(torch.from_numpy(
            np.ascontiguousarray(wm[i])).to(dev))
    return {"wmt": wmt}


def secret_key_from_numpy(params: GateParams, lwe_key_bits,
                          ring_key_bits) -> SecretKey:
    lk = lwe.LweKey(params.lwe, np.asarray(lwe_key_bits, np.int32))
    rk = tlwe.TLweKey.from_bits(params.tgsw.tlwe, ring_key_bits)
    return SecretKey.from_keys(params, lk, rk)


def cloud_key_from_numpy(key_data, params: GateParams, backend: str,
                         device=None) -> CloudKey:
    dev = _device.resolve(device)
    bk = _bk(key_data, backend, dev)
    ksk = lwe.KeySwitchKey.from_limbs(np.array(key_data["ksw"], np.int8),
                                      params.ks, params.tgsw.tlwe.extracted_n,
                                      params.lwe.n, device=dev)
    return CloudKey(params, backend, bk, ksk)


def circuit_secret_key_from_numpy(params: CircuitParams, key_lvl0_bits,
                                  ring_lvl1_bits, ring_lvl2_bits
                                  ) -> circuit.CircuitSecretKey:
    k0 = lwe.LweKey(LweParams(params.n_lvl0),
                    np.asarray(key_lvl0_bits, np.int32))
    r1 = tlwe.TLweKey.from_bits(params.lvl1, ring_lvl1_bits)
    r2 = tlwe.TLweKey.from_bits(params.lvl2, ring_lvl2_bits)
    return circuit.CircuitSecretKey.from_keys(params, k0, r1, r2)


def circuit_cloud_key_from_numpy(key_data, params: CircuitParams,
                                 backend: str = "chunked",
                                 device=None) -> circuit.CircuitCloudKey:
    dev = _device.resolve(device)
    bk = (_k_packed_bk(key_data, dev) if backend == "chunked"
          else _bk(key_data, backend, dev))
    preks = lwe.KeySwitchKey.from_limbs(np.array(key_data["preks"], np.int8),
                                        params.ks10, params.n_lvl1,
                                        params.n_lvl0, device=dev)
    privks = circuit.PrivKeySwitchKey(
        params.ks21, params.n_lvl2, params.lvl1.k, params.n_lvl1,
        torch.tensor(np.asarray(key_data["privks"], np.int8)).to(dev))
    return circuit.CircuitCloudKey(params, backend, preks, bk, privks)
