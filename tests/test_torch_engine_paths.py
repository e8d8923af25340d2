"""The conv, Nussbaumer and FFT engines on the port's paths, against
tfhe_tpu on the CPU:

  * a GATE_TOY gate bootstrap on ``conv`` (keys from one seed in both
    packages) gives the JAX package's ``conv`` ciphertexts bit for bit, and
    so does one on ``nussbaumer`` (deterministic integer arithmetic); one on
    ``fft_f64`` decrypts right;
  * a CB_TOY circuit bootstrap on ``conv`` gives the JAX package's ``conv``
    TRGSWs bit for bit (tests/test_circuit_bootstrap.py's keys), and the
    port's ``chunked`` ones;
  * JAX ``conv``, ``conv_bf16``, ``nussbaumer`` and ``fft_dd`` gate keys
    (the dd key a tuple leaf), carried across by ``convert``, give JAX's
    outputs (``fft_dd``: the same decryptions), and so does a JAX conv key
    written to a key file; a JAX raw-bk circuit key file loads with
    ``backend="conv"`` (tests/test_noise_models_serialization.py:188-195),
    and a JAX ``conv`` circuit key converts.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import lwe as jlwe
from tfhe_tpu.boot import circuit as jcircuit, gate as jgate
from tfhe_tpu.params import CB_TOY, GATE_TOY
from tfhe_tpu.rng import TfheRng as JRng
from tfhe_tpu.utils import serialization as jser
from tfhe_tpu_torch import convert
from tfhe_tpu_torch.boot import circuit, gate
from tfhe_tpu_torch.params import CB_TOY as T_CB_TOY, GATE_TOY as T_TOY
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.utils import serialization as ser

BITS = np.array([0, 1, 1, 0, 1, 0, 0, 1])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_gate(backend, seed=11):
    jrng = JRng(seed)
    jsk = jgate.SecretKey.generate(GATE_TOY, jrng)
    jck = jgate.CloudKey.generate(jsk, jrng, backend=backend)
    ct = np.array(jgate.encrypt_bool(jsk, BITS, jrng))
    ct2 = np.array(jgate.encrypt_bool(jsk, BITS[::-1].copy(), jrng))
    return jsk, jck, ct, ct2


def _jax_bk(jck):
    """JAX's prepared bk as numpy, a tuple leaf part by part."""
    return {name: tuple(np.asarray(p) for p in v) if isinstance(v, tuple)
            else np.asarray(v) for name, v in jck.data["bk"].items()}


@pytest.mark.parametrize("backend", ["conv", "nussbaumer"])
def test_gate_bootstrap_same_seed_bit_exact(backend):
    jsk, jck, ct, _ = _jax_gate(backend)
    want = np.asarray(jgate.bootstrap(ct, jck.data, GATE_TOY,
                                      backend=backend))
    rng = TfheRng(11)
    sk = gate.SecretKey.generate(T_TOY, rng)
    ck = gate.CloudKey.generate(sk, rng, backend=backend, device="cpu")
    (name, leaf), = ck.data["bk"].items()
    np.testing.assert_array_equal(leaf.numpy(), _jax_bk(jck)[name])
    got = gate.bootstrap(torch.from_numpy(ct), ck.data, T_TOY,
                         backend=backend)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (gate.decrypt_bool(sk, got) == BITS.astype(bool)).all()


def test_gate_bootstrap_fft_f64_decrypts():
    rng = TfheRng(13)
    sk = gate.SecretKey.generate(T_TOY, rng)
    ck = gate.CloudKey.generate(sk, rng, backend="fft_f64", device="cpu")
    assert ck.data["bk"]["hat"].dtype == torch.complex128
    ct = gate.encrypt_bool(sk, BITS, rng, device="cpu")
    out = gate.bootstrap(ct, ck.data, T_TOY, backend="fft_f64")
    assert (gate.decrypt_bool(sk, out) == BITS.astype(bool)).all()
    y = gate.encrypt_bool(sk, BITS[::-1].copy(), rng, device="cpu")
    nand = gate.decrypt_bool(sk, gate.gate_nand(ck.data, ct, y, T_TOY,
                                                "fft_f64"))
    np.testing.assert_array_equal(nand, ~(BITS & BITS[::-1]).astype(bool))


@pytest.mark.parametrize("backend", ["conv", "conv_bf16", "nussbaumer",
                                     "fft_dd"])
def test_converted_gate_key_gives_jax_outputs(backend):
    jsk, jck, ct, ct2 = _jax_gate(backend)
    want = np.asarray(jgate.gate_nand(jck.data, ct, ct2, GATE_TOY, backend))
    sk = convert.secret_key_from_numpy(T_TOY, np.asarray(jsk.lwe_key.key),
                                       np.asarray(jsk.ring_key.key))
    ck = convert.cloud_key_from_numpy(
        {"bk": _jax_bk(jck), "ksw": np.asarray(jck.data["ksw"])}, T_TOY,
        backend, device="cpu")
    if backend == "fft_dd":
        assert isinstance(ck.data["bk"]["hat"], tuple)
        assert ck.data["bk"]["hat"][0].shape[0] == GATE_TOY.lwe.n
    got = gate.gate_nand(ck.data, torch.from_numpy(ct),
                         torch.from_numpy(ct2), T_TOY, backend)
    dec = gate.decrypt_bool(sk, got)
    np.testing.assert_array_equal(dec, ~(BITS & BITS[::-1]).astype(bool))
    if backend == "fft_dd":
        # approximate: the same decryptions, phases within the envelope
        np.testing.assert_array_equal(dec, jgate.decrypt_bool(jsk, want))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_jax_conv_gate_key_file_loads(tmp_path):
    jsk, jck, ct, ct2 = _jax_gate("conv")
    want = np.asarray(jgate.gate_nand(jck.data, ct, ct2, GATE_TOY, "conv"))
    path = str(tmp_path / "gate_conv.npz")
    jser.save_keydata(path, jck.data, params=GATE_TOY,
                      meta={"backend": "conv"})
    ck = ser.load_cloud_key(path, device="cpu")
    assert ck.backend == "conv" and set(ck.data["bk"]) == {"k"}
    got = gate.gate_nand(ck.data, torch.from_numpy(ct),
                         torch.from_numpy(ct2), T_TOY, "conv")
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_key_file_keeps_tuple_and_bf16_leaves(tmp_path):
    """A port-written fft_dd key file (a tuple leaf) and conv_bf16 one
    (bfloat16 leaves, stored as the JAX package's 2-byte records) load back
    leaf for leaf."""
    rng = TfheRng(17)
    sk = gate.SecretKey.generate(T_TOY, rng)
    for backend in ("fft_dd", "conv_bf16"):
        ck = gate.CloudKey.generate(sk, rng, backend=backend, device="cpu")
        path = str(tmp_path / f"{backend}.npz")
        ser.save_cloud_key(path, ck)
        back = ser.load_cloud_key(path, device="cpu")
        leaf, got = ck.data["bk"], back.data["bk"]
        assert set(got) == set(leaf)
        for name in leaf:
            parts = leaf[name] if isinstance(leaf[name], tuple) \
                else (leaf[name],)
            got_parts = got[name] if isinstance(got[name], tuple) \
                else (got[name],)
            assert len(parts) == len(got_parts)
            for a, b in zip(parts, got_parts):
                assert a.dtype == b.dtype and torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _circuit(seed=42):
    """tests/test_circuit_bootstrap.py's keys: CB_TOY from TfheRng(42),
    conv backend, in both packages."""
    jrng = JRng(seed)
    jsk = jcircuit.CircuitSecretKey.generate(CB_TOY, jrng)
    jck = jcircuit.CircuitCloudKey.generate(jsk, jrng, backend="conv",
                                            keep_raw_bk=True)
    rng = TfheRng(seed)
    sk = circuit.CircuitSecretKey.generate(T_CB_TOY, rng)
    ck = circuit.CircuitCloudKey.generate(sk, rng, backend="conv",
                                          device="cpu")
    msgs = np.where(np.array([0, 1, 1, 0]) == 1, -(1 << 31), 0)
    ct = np.array(jlwe.encrypt(jsk.lwe_lvl1, msgs.astype(np.int32), JRng(5),
                               2.0**-20))
    want = np.asarray(jcircuit.circuit_bootstrap(jnp.asarray(ct), jck.data,
                                                 CB_TOY, backend="conv"))
    return jck, ck, sk, ct, want


def test_circuit_bootstrap_conv_bit_exact():
    jck, ck, sk, ct, want = _circuit()
    assert set(ck.data["bk"]) == {"k"}
    np.testing.assert_array_equal(ck.data["bk"]["k"].numpy(),
                                  np.asarray(jck.data["bk"]["k"]))
    fn = circuit.make_circuit_bootstrap_staged(T_CB_TOY, backend="conv")
    got = fn(torch.from_numpy(ct), ck.data)
    np.testing.assert_array_equal(got.numpy(), want)
    # the exact engines agree: the chunked engine on the same keys
    rng = TfheRng(42)
    sk2 = circuit.CircuitSecretKey.generate(T_CB_TOY, rng)
    ck2 = circuit.CircuitCloudKey.generate(sk2, rng, backend="chunked",
                                           device="cpu")
    assert torch.equal(circuit.circuit_bootstrap(torch.from_numpy(ct),
                                                 ck2.data, T_CB_TOY), got)


def test_jax_circuit_key_file_loads_with_conv(tmp_path):
    jck, _, _, ct, want = _circuit()
    path = str(tmp_path / "cb.npz")
    jser.save_circuit_key(path, jck)
    data, params = ser.load_circuit_key(path, backend="conv", device="cpu")
    assert params == T_CB_TOY and set(data["bk"]) == {"k"}
    got = circuit.circuit_bootstrap(torch.from_numpy(ct), data, params,
                                    backend="conv")
    np.testing.assert_array_equal(got.numpy(), want)


def test_jax_conv_circuit_key_converts():
    jck, _, _, ct, want = _circuit()
    ck = convert.circuit_cloud_key_from_numpy(
        {"preks": np.asarray(jck.data["preks"]), "bk": _jax_bk(jck),
         "privks": np.asarray(jck.data["privks"])}, T_CB_TOY, "conv",
        device="cpu")
    got = circuit.make_circuit_bootstrap_fn(T_CB_TOY, backend="conv",
                                            shared_rotation=None)(
        torch.from_numpy(ct), ck.data)
    np.testing.assert_array_equal(got.numpy(), want)
