"""Carry keys made by the JAX package (``tfhe_tpu``) into this port.

Both functions take plain numpy arrays (convert a JAX array with
``np.asarray`` first), so the port never sees a JAX object:

  * the secret key: the ``lwe_key.key`` and ``ring_key.key`` bits;
  * the cloud key: ``key_data = {"bk": {...}, "ksw": ...}`` as in
    ``tfhe_tpu.boot.gate.CloudKey.data`` — ``bk`` is the engine-prepared
    bootstrapping key, ``{"v": (n, L, J, U, 2N) int8}`` for ``onthefly``,
    ``{"w": (n, L, J*N, U*N) int8}`` for ``matmul``, ``{"mat": ...}`` for
    ``naive``; ``ksw`` is (4, n_in*t*base, n_out+1) int8.

Both packages then compute the same function on the same keys.
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_tpu_torch import device as _device
from tfhe_tpu_torch import lwe, tlwe
from tfhe_tpu_torch.boot.gate import CloudKey, SecretKey
from tfhe_tpu_torch.params import GateParams

_BK_LEAF = {"onthefly": "v", "matmul": "w", "naive": "mat"}


def secret_key_from_numpy(params: GateParams, lwe_key_bits,
                          ring_key_bits) -> SecretKey:
    lk = lwe.LweKey(params.lwe, np.asarray(lwe_key_bits, np.int32))
    rk = tlwe.TLweKey.from_bits(params.tgsw.tlwe, ring_key_bits)
    return SecretKey.from_keys(params, lk, rk)


def cloud_key_from_numpy(key_data, params: GateParams, backend: str,
                         device=None) -> CloudKey:
    dev = _device.resolve(device)
    if backend not in _BK_LEAF:
        raise ValueError(f"no conversion for backend {backend!r}")
    if set(key_data["bk"]) != {_BK_LEAF[backend]}:
        raise ValueError(f"backend {backend!r} expects bk key "
                         f"{_BK_LEAF[backend]!r}, got {sorted(key_data['bk'])}")
    bk = {name: torch.tensor(np.asarray(v)).to(dev)
          for name, v in key_data["bk"].items()}
    ksk = lwe.KeySwitchKey.from_limbs(np.array(key_data["ksw"], np.int8),
                                      params.ks, params.tgsw.tlwe.extracted_n,
                                      params.lwe.n, device=dev)
    return CloudKey(params, backend, bk, ksk)
