"""Key files cross-load between tfhe_tpu and the port
(tfhe_tpu_torch.utils.serialization), on the CPU:

  * a JAX-written .npz of GATE_TOY chunked keys loads in the port (its
    parameters rebuilt as the port's dataclasses) and computes JAX's gate
    outputs; a port-written file loads in JAX and computes the port's;
  * a CB_TOY circuit key with keep_raw_bk=True, written by either package,
    loads in the other with the prepared bk rebuilt from the raw TRGSW64
    byte for byte, and the port's circuit bootstrap on the loaded keys
    equals its bootstrap on its own.

Tolerance 0.
"""

import functools

import numpy as np
import pytest
import torch

from tfhe_tpu.boot import circuit as jcircuit, gate as jgate
from tfhe_tpu.params import CB_TOY, GATE_TOY
from tfhe_tpu.rng import TfheRng as JRng
from tfhe_tpu.utils import serialization as jser
from tfhe_tpu_torch import lwe
from tfhe_tpu_torch.boot import circuit, gate
from tfhe_tpu_torch.ops import kernels as K
from tfhe_tpu_torch.params import CB_TOY as T_CB_TOY, GATE_TOY as T_TOY
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.utils import serialization as ser


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These toy shapes are far too small for torch's thread pool, which
    only adds waiting on a machine shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _gate_keys(seed=5):
    jrng = JRng(seed)
    jsk = jgate.SecretKey.generate(GATE_TOY, jrng)
    jck = jgate.CloudKey.generate(jsk, jrng, backend="chunked")
    bits = np.array([[0, 1, 1, 0, 1], [1, 1, 0, 0, 1]])
    cts = [np.asarray(jgate.encrypt_bool(jsk, b, jrng)) for b in bits]
    want = np.asarray(jgate.gate_nand(jck.data, *cts, GATE_TOY, "chunked"))
    return jsk, jck, bits, cts, want


def test_jax_gate_key_file_loads_in_the_port(tmp_path):
    jsk, jck, bits, cts, want = _gate_keys()
    path = str(tmp_path / "gate.npz")
    jser.save_keydata(path, jck.data, params=GATE_TOY,
                      meta={"backend": "chunked"})
    tree, params, meta = ser.load_keydata(path, device="cpu")
    assert params == T_TOY and meta == {"backend": "chunked"}
    np.testing.assert_array_equal(tree["bk"]["wm"].numpy(),
                                  np.asarray(jck.data["bk"]["wm"]))
    ck = ser.load_cloud_key(path, device="cpu")
    got = gate.gate_nand(ck.data, *(torch.tensor(c) for c in cts), T_TOY,
                         "chunked")
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_gate_key_file_loads_in_jax(tmp_path):
    jsk, jck, bits, cts, want = _gate_keys()
    rng = TfheRng(5)
    sk = gate.SecretKey.generate(T_TOY, rng)
    ck = gate.CloudKey.generate(sk, rng, backend="chunked", device="cpu")
    path = str(tmp_path / "gate.npz")
    ser.save_cloud_key(path, ck)
    tree, params, meta = jser.load_keydata(path)
    assert params == GATE_TOY and meta["backend"] == "chunked"
    got = np.asarray(jgate.gate_nand(tree, *cts, params, "chunked"))
    np.testing.assert_array_equal(got, want)
    back = ser.load_cloud_key(path, device="cpu")       # and back again
    for a, b in ((back.data["bk"]["wm"], ck.data["bk"]["wm"]),
                 (back.data["ksw"], ck.data["ksw"])):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _circuit_keys(seed=9):
    jrng = JRng(seed)
    jsk = jcircuit.CircuitSecretKey.generate(CB_TOY, jrng)
    jck = jcircuit.CircuitCloudKey.generate(jsk, jrng, backend="chunked",
                                            keep_raw_bk=True)
    rng = TfheRng(seed)
    sk = circuit.CircuitSecretKey.generate(T_CB_TOY, rng)
    ck = circuit.CircuitCloudKey.generate(sk, rng, backend="chunked",
                                          keep_raw_bk=True, device="cpu")
    msgs = np.where(np.array([0, 1, 1]) == 1, -(1 << 31), 0).astype(np.int32)
    ct = lwe.encrypt(sk.lwe_lvl1, msgs, rng, 2.0**-20, device="cpu")
    return jck, ck, ct


def _same_circuit_data(data, ref):
    """The same keys; the bk as each package prepares it (the port's K-packed
    wmt, the JAX package's wm)."""
    for name in ("preks", "privks"):
        np.testing.assert_array_equal(np.asarray(data[name]),
                                      np.asarray(ref[name]), err_msg=name)
    assert set(data["bk"]) == set(ref["bk"])
    for name in data["bk"]:
        np.testing.assert_array_equal(np.asarray(data["bk"][name]),
                                      np.asarray(ref["bk"][name]))


def test_circuit_key_files_cross_load(tmp_path):
    jck, ck, ct = _circuit_keys()
    np.testing.assert_array_equal(ck.bk_raw.numpy(), jck.bk_raw)
    want = circuit.circuit_bootstrap(ct, ck.data, T_CB_TOY)
    # JAX -> port
    jpath = str(tmp_path / "jax_cb.npz")
    jser.save_circuit_key(jpath, jck)
    data, params = ser.load_circuit_key(jpath, device="cpu")
    assert params == T_CB_TOY
    _same_circuit_data(data, ck.data)
    # the reloaded key is the K-packed key of the 64-bit steps alone, ck_wmt
    # of the JAX package's wm
    assert set(data["bk"]) == {"wmt"}
    assert torch.equal(data["bk"]["wmt"], K.ck_wmt(torch.from_numpy(
        np.asarray(jck.data["bk"]["wm"]))))
    assert torch.equal(circuit.circuit_bootstrap(ct, data, params), want)
    # port -> JAX
    tpath = str(tmp_path / "port_cb.npz")
    ser.save_circuit_key(tpath, ck)
    jdata, jparams = jser.load_circuit_key(tpath)
    assert jparams == CB_TOY
    _same_circuit_data(
        {"preks": np.asarray(jdata["preks"]),
         "privks": np.asarray(jdata["privks"]), "bk": jdata["bk"]},
        {"preks": np.asarray(jck.data["preks"]),
         "privks": np.asarray(jck.data["privks"]), "bk": jck.data["bk"]})


def test_save_circuit_key_needs_the_raw_bk(tmp_path):
    _, ck, _ = _circuit_keys()
    bare = circuit.CircuitCloudKey(ck.params, ck.backend, ck.preks,
                                   ck.bk_prepared, ck.privks)
    with pytest.raises(ValueError, match="keep_raw_bk"):
        ser.save_circuit_key(str(tmp_path / "x.npz"), bare)
