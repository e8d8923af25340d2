"""The port's circuit runtime (tfhe_tpu_torch.runtime.scheduler) and decrypt
probes (tfhe_tpu_torch.boot.probe) against tfhe_tpu's, on the CPU:

  * schedule() gives the JAX package's wave lists (adder, comparator, and
    the NOT/constant folding case of tests/test_runtime_scheduler.py);
  * evaluate() on GATE_TOY gives JAX's ciphertexts, bit for bit, for a
    3-bit adder, a 4-bit comparator and a MUX chain over batched instances,
    per launch, with TFHE_WAVE_CHAIN=2 and with a TFHE_MAX_WAVE_ROWS that
    splits waves; its counters equal JAX's;
  * the per-step probe statistics of a GATE_TOY blind rotation, and the
    LWE and TRGSW-row probes, equal JAX's.

Keys: the same TfheRng seed in both packages (byte-identical keys,
tests/test_torch_gate.py).  Tolerance 0.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import tgsw as jtgsw, tlwe as jtlwe, torus as jT
from tfhe_tpu.boot import gate as jgate, probe as jprobe
from tfhe_tpu.ops import poly as jpoly
from tfhe_tpu.params import CB_TOY, GATE_TOY
from tfhe_tpu.rng import TfheRng as JRng
from tfhe_tpu.runtime import scheduler as jsched
from tfhe_tpu.utils import observability as jobs
from tfhe_tpu_torch import tlwe
from tfhe_tpu_torch.boot import gate, probe
from tfhe_tpu_torch.params import CB_TOY as T_CB_TOY, GATE_TOY as T_TOY
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.runtime import scheduler
from tfhe_tpu_torch.utils import observability as obs

COUNTERS = ("circuit.gates", "circuit.waves", "bootstrap.launches",
            "bootstrap.ciphertexts")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These toy shapes are far too small for torch's thread pool, which
    only adds waiting on a machine shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _folding(mod):
    """tests/test_runtime_scheduler.py:23-45's circuit: a NOT and a
    constant folded into references, merged binary levels, a MUX."""
    circ = mod.Circuit(4)
    n0 = circ.not_(0)
    k1 = circ.const(True)
    g1 = circ.and_(n0, 1)
    g2 = circ.xor(2, 3)
    g3 = circ.nand(g1, g2)
    m = circ.mux(g3, g1, k1)
    return circ, [g1, g2, g3, m]


def _mux_chain(mod):
    circ = mod.Circuit(3)
    m = circ.mux(0, 1, 2)                  # sel ? w1 : w2
    n = circ.not_(m)
    m2 = circ.mux(n, 2, circ.const(False))
    return circ, [m, n, m2]


BUILDERS = {"adder3": lambda mod: mod.ripple_carry_adder(3),
            "comparator4": lambda mod: mod.comparator(4),
            "folding": _folding, "mux_chain": _mux_chain}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_schedule_matches_jax(name):
    jcirc, jouts = BUILDERS[name](jsched)
    tcirc, touts = BUILDERS[name](scheduler)
    assert touts == jouts
    assert tcirc.schedule() == jcirc.schedule()
    assert [tcirc.resolve(w) for w in touts] == \
        [jcirc.resolve(w) for w in jouts]


@functools.lru_cache(maxsize=None)
def _keys(seed=11):
    """JAX onthefly GATE_TOY keys and the port's from the same seed."""
    jrng = JRng(seed)
    jsk = jgate.SecretKey.generate(GATE_TOY, jrng)
    jck = jgate.CloudKey.generate(jsk, jrng, backend="onthefly")
    rng = TfheRng(seed)
    sk = gate.SecretKey.generate(T_TOY, rng)
    ck = gate.CloudKey.generate(sk, rng, backend="onthefly", device="cpu")
    return jrng, jsk, jck, sk, ck


def _inputs(name, jsk, jrng):
    """Encrypted inputs (n_inputs, B, n+1) and the plain bits."""
    n_in = {"adder3": 6, "comparator4": 8, "folding": 4, "mux_chain": 3}[name]
    bits = np.random.default_rng(len(name)).integers(0, 2, (n_in, 3))
    cts = np.stack([np.asarray(jgate.encrypt_bool(jsk, b, jrng))
                    for b in bits])
    return bits.astype(bool), cts


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    jrng, jsk, jck, sk, ck = _keys()
    bits, cts = _inputs(name, jsk, jrng)
    jcirc, jouts = BUILDERS[name](jsched)
    jobs.reset()
    want = np.asarray(jsched.evaluate(jcirc, cts, jck.data, GATE_TOY, jouts,
                                      backend="onthefly"))
    rep = jobs.report()
    return bits, cts, want, rep


def _plain(name, bits):
    if name == "adder3":
        x = sum(bits[i].astype(int) << i for i in range(3))
        y = sum(bits[3 + i].astype(int) << i for i in range(3))
        s = x + y
        return np.stack([(s >> i) & 1 for i in range(4)]).astype(bool)
    if name == "comparator4":
        x = sum(bits[i].astype(int) << i for i in range(4))
        y = sum(bits[4 + i].astype(int) << i for i in range(4))
        return np.stack([x < y, x == y, x > y])
    if name == "mux_chain":
        m = np.where(bits[0], bits[1], bits[2])
        return np.stack([m, ~m, np.where(~m, bits[2], False)])
    g1 = ~bits[0] & bits[1]
    g2 = bits[2] ^ bits[3]
    g3 = ~(g1 & g2)
    return np.stack([g1, g2, g3, np.where(g3, g1, True)])


@pytest.mark.parametrize("env", [{}, {"TFHE_WAVE_CHAIN": "2"},
                                 {"TFHE_MAX_WAVE_ROWS": "4"},
                                 {"TFHE_WAVE_SPLIT": "1"}])
@pytest.mark.parametrize("name", ["adder3", "comparator4", "mux_chain"])
def test_evaluate_matches_jax(monkeypatch, name, env):
    """Ciphertext for ciphertext against JAX's evaluate (run per launch:
    its chained, capped and split runs are bit-identical to that,
    tests/test_runtime_scheduler.py), decoding to the plain circuit."""
    bits, cts, want, jrep = _jax_run(name)
    _, _, _, sk, ck = _keys()
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    tcirc, touts = BUILDERS[name](scheduler)
    obs.reset()
    got = scheduler.evaluate(tcirc, torch.from_numpy(cts), ck.data, T_TOY,
                             touts, backend="onthefly")
    np.testing.assert_array_equal(got.numpy(), want)
    dec = np.stack([gate.decrypt_bool(sk, got[i]) for i in range(len(touts))])
    np.testing.assert_array_equal(dec, _plain(name, bits))
    rep = obs.report()
    span = "circuit.chain" if env.get("TFHE_WAVE_CHAIN") else "circuit.wave."
    assert any(k.startswith(span) for k in rep["spans"])
    if not env:                            # the same launches as JAX's
        for c in COUNTERS:
            assert rep["counters"][c] == jrep["counters"][c], c
        assert rep["observations"]["circuit.wave_width"] == \
            jrep["observations"]["circuit.wave_width"]


def test_capped_counters_match_jax(monkeypatch):
    """With TFHE_MAX_WAVE_ROWS small enough to split every wave, the
    launch and ciphertext counts still equal JAX's."""
    monkeypatch.setenv("TFHE_MAX_WAVE_ROWS", "6")
    jrng, jsk, jck, sk, ck = _keys()
    bits, cts = _inputs("comparator4", jsk, jrng)
    jcirc, jouts = jsched.comparator(4)
    jobs.reset()
    want = np.asarray(jsched.evaluate(jcirc, cts, jck.data, GATE_TOY, jouts,
                                      backend="onthefly"))
    tcirc, touts = scheduler.comparator(4)
    obs.reset()
    got = scheduler.evaluate(tcirc, torch.from_numpy(cts), ck.data, T_TOY,
                             touts, backend="onthefly")
    np.testing.assert_array_equal(got.numpy(), want)
    jrep, rep = jobs.report(), obs.report()
    for c in COUNTERS:
        assert rep["counters"][c] == jrep["counters"][c], c
    assert rep["counters"]["bootstrap.launches"] > \
        rep["counters"]["circuit.waves"]            # the cap split waves


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

def test_blind_rotate_probed_matches_jax():
    jrng, jsk, jck, sk, ck = _keys()
    ct = np.asarray(jgate.encrypt_bool(jsk, np.array([1, 0, 1, 1]), jrng))
    N = GATE_TOY.N
    barb = jT.mod_switch_from_torus32(jnp.asarray(ct[:, -1]), 2 * N)
    bara = jT.mod_switch_from_torus32(jnp.asarray(ct[:, :-1]), 2 * N)
    tv = jpoly.mul_by_xai((2 * N - barb) % (2 * N),
                          jnp.full((4, N), np.int32(gate.MU_BOOL), jnp.int32))
    acc0 = jtlwe.noiseless_trivial_poly(tv, 1)
    want, jprobes = jprobe.blind_rotate_probed(
        acc0, jck.bk_prepared, bara, GATE_TOY.tgsw, jsk.ring_key,
        gate.MU_BOOL, backend="onthefly", every=4)
    got, probes = probe.blind_rotate_probed(
        torch.from_numpy(np.array(acc0)), ck.bk_prepared,
        torch.from_numpy(np.array(bara)), T_TOY.tgsw, sk.ring_key,
        gate.MU_BOOL, backend="onthefly", every=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [p.step for p in probes] == [p.step for p in jprobes]
    for p, jp in zip(probes, jprobes):
        np.testing.assert_array_equal(p.exponent, jp.exponent)
        np.testing.assert_array_equal(p.phase, jp.phase)
        np.testing.assert_array_equal(p.sign, jp.sign)
        assert p.rms_noise == jp.rms_noise
        assert p.rms_noise < 2.0**-10


def test_probe_lwe_and_tgsw_rows_match_jax():
    jrng, jsk, jck, sk, ck = _keys()
    ct = np.asarray(jgate.encrypt_bool(jsk, np.array([1, 0, 1]), jrng))
    np.testing.assert_array_equal(probe.probe_lwe_phase(ct, sk.lwe_key),
                                  jprobe.probe_lwe_phase(ct, jsk.lwe_key))
    p, tp = CB_TOY.tgsw_lvl1, T_CB_TOY.tgsw_lvl1
    jkey = jtlwe.TLweKey.generate(p.tlwe, JRng(7))
    key = tlwe.TLweKey.generate(tp.tlwe, TfheRng(7))
    msgs = np.array([0, 1, 1])
    gsw = np.asarray(jtgsw.encrypt(jkey, msgs, p, JRng(8), stdev=2.0**-30))
    want, jdev = jprobe.probe_tgsw_rows(gsw, jkey, p, message=msgs)
    got, dev = probe.probe_tgsw_rows(torch.tensor(gsw), key, tp,
                                     message=msgs)
    np.testing.assert_array_equal(got, want)
    assert dev == jdev and dev < 2.0**-20
