"""Key-material serialization (the counterpart of
``tfhe_tpu.utils.serialization``): one ``.npz`` holding every array leaf
plus a JSON header describing the nesting (dicts / lists / tuples with leaf
references) and the parameter dataclasses.  No pickling anywhere.

The format is the JAX package's, so a file written by either package loads
in the other: ``load_keydata`` rebuilds the header's parameters as this
port's dataclasses and the leaves as tensors on ``device``.  The port keeps
its key-switch limb tables with their columns padded to a multiple of 8 (the
card's int8 GEMM needs it, ``lwe.KeySwitchKey``); ``save_cloud_key`` and
``save_circuit_key`` write them at the JAX package's width, and the loaders
pad them again.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from tfhe_tpu_torch import device as _device
from tfhe_tpu_torch import lwe, params as P
from tfhe_tpu_torch.ops.engine import map_prepared
from tfhe_tpu_torch.utils import observability as obs


def _params_to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {"__dc__": type(obj).__name__,
                **{f.name: _params_to_dict(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    return obj


def _params_from_dict(d):
    if isinstance(d, dict) and "__dc__" in d:
        cls = getattr(P, d["__dc__"])
        kw = {k: _params_from_dict(v) for k, v in d.items() if k != "__dc__"}
        return cls(**kw)
    return d


def tensor_from_numpy(a) -> torch.Tensor:
    """A numpy array as a tensor; bfloat16 (the ml_dtypes arrays the JAX
    package hands out, or their raw 2-byte records in an .npz) becomes a
    bfloat16 tensor through its float32 bits."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        bits = a.view(np.uint16).astype(np.uint32) << 16
        return torch.from_numpy(bits.view(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a) if a.flags.writeable else torch.tensor(a)


def _to_numpy(t):
    """A leaf as numpy; a bfloat16 tensor as 2-byte records, the JAX
    package's .npz form."""
    if torch.is_tensor(t) and t.dtype == torch.bfloat16:
        return t.detach().cpu().view(torch.int16).numpy().view("V2")
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _encode(tree, arrays: dict):
    if isinstance(tree, dict):
        return {"__t__": "dict",
                "items": {k: _encode(v, arrays) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"__t__": "list" if isinstance(tree, list) else "tuple",
                "items": [_encode(v, arrays) for v in tree]}
    key = f"leaf_{len(arrays)}"
    arrays[key] = _to_numpy(tree)
    return {"__t__": "leaf", "key": key}


def _decode(skel, z, device):
    t = skel["__t__"]
    if t == "dict":
        return {k: _decode(v, z, device) for k, v in skel["items"].items()}
    if t in ("list", "tuple"):
        items = [_decode(v, z, device) for v in skel["items"]]
        return items if t == "list" else tuple(items)
    return tensor_from_numpy(z[skel["key"]]).to(device)


def save_keydata(path: str, key_data, params=None, meta: dict | None = None,
                 compress: bool = True):
    """Serialize a key tree (nested dict/list/tuple of tensors or arrays)
    with its parameter dataclasses.  compress=False skips zlib: key material
    is uniformly random, so compression buys nothing and costs minutes at
    circuit-key size."""
    arrays: dict[str, np.ndarray] = {}
    skel = _encode(key_data, arrays)
    header = {
        "skeleton": skel,
        "params": _params_to_dict(params) if params is not None else None,
        "meta": meta or {},
        "version": 1,
    }
    savez = np.savez_compressed if compress else np.savez
    savez(path, __header__=np.frombuffer(json.dumps(header).encode(),
                                         np.uint8), **arrays)
    return path


def load_keydata(path: str, device=None):
    """-> (key tree of tensors on ``device``, params, meta)."""
    dev = _device.resolve(device)
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        tree = _decode(header["skeleton"], z, dev)
    return tree, _params_from_dict(header["params"]), header["meta"]


def _ks_limbs(ksk: lwe.KeySwitchKey):
    """A key switch's limb table at the JAX package's width (n_out+1)."""
    return ksk.w_limbs[..., :ksk.n_out + 1]


def save_cloud_key(path: str, ck):
    """Serialize a gate CloudKey as {"bk": {...}, "ksw": limbs}: the JAX
    package's ``CloudKey.data`` tree, which its gate functions take as it
    loads."""
    return save_keydata(path, {"bk": ck.bk_prepared, "ksw": _ks_limbs(ck.ksk)},
                        params=ck.params,
                        meta={"backend": ck.backend, "format": "cloud_key",
                              "version": 1})


def load_cloud_key(path: str, backend: str | None = None, device=None):
    """-> CloudKey from a file of save_cloud_key, or of the JAX package's
    ``save_keydata(path, ck.data, params)`` (then name ``backend`` unless
    the file's meta does)."""
    from tfhe_tpu_torch import convert
    tree, params, meta = load_keydata(path, device="cpu")
    backend = backend or meta.get("backend")
    if backend is None:
        raise ValueError(f"{path}: the file names no backend; pass one")
    return convert.cloud_key_from_numpy(
        {"bk": map_prepared(_to_numpy, tree["bk"]),
         "ksw": tree["ksw"].numpy()}, params, backend, device=device)


def save_circuit_key(path: str, ck):
    """Serialize a CircuitCloudKey at raw-bk scale: {preks limbs, privks
    limbs, raw TRGSW64 bk}.  The chunked engine's prepared wmt is ~m/2 times
    the raw bk (8.1 GB at CB_MXU), so the prepared form is rebuilt on the
    device at load, as keygen does.  Needs
    CircuitCloudKey.generate(keep_raw_bk=True)."""
    if ck.bk_raw is None:
        raise ValueError("CircuitCloudKey was generated without "
                         "keep_raw_bk=True: no raw bk to serialize")
    return save_keydata(path, {
        "preks": _ks_limbs(ck.preks),
        "privks": ck.privks.w_limbs,
        "bk_raw": ck.bk_raw,
    }, params=ck.params, meta={"backend": ck.backend,
                               "format": "circuit_raw_bk", "version": 1},
        compress=False)


def load_circuit_key(path: str, backend: str | None = None, device=None):
    """-> (key_data dict for circuit_bootstrap, CircuitParams).

    Rebuilds the engine-prepared bk on ``device`` from the stored raw
    TRGSW64; preKS and privKS load as they are (preKS padded to the port's
    width).  ``backend`` overrides the stored one (the raw bk serves any
    engine)."""
    from tfhe_tpu_torch.boot import circuit as _circuit
    dev = _device.resolve(device)
    tree, params, meta = load_keydata(path, device="cpu")
    if meta.get("format") != "circuit_raw_bk":
        raise ValueError(f"not a circuit key file: {meta}")
    backend = backend or meta["backend"]
    with obs.span("keyload.circuit.bk_prepare"):
        prep = _circuit.prepare_circuit_bk(tree["bk_raw"].to(dev), params,
                                           backend)
    preks = lwe.KeySwitchKey.from_limbs(tree["preks"].numpy(), params.ks10,
                                        params.n_lvl1, params.n_lvl0,
                                        device=dev)
    return {"preks": preks.w_limbs, "bk": prep,
            "privks": tree["privks"].to(dev)}, params
