"""The private key switch on the packed table (kernels.priv_keyswitch,
circuit.prepare_privks), on the CPU.

  * the plain version of the packed product equals circuit.priv_keyswitch
    (four one-hot int8 products on the row-major limbs, then the negation)
    bit for bit: at base 8 (t=10) and base 2 (t=32), at CB_TOY's n (n2 =
    128) and at CB_ACTIVE's whole depth (n2 = 2,048: K' = 143,430 and
    65,568), at B = 1, 4, 33, for both z;
  * digit extremes: all digits 0 give 0; all digits base-1 select one row a
    digit, and a table of -128 or 127 there reaches the int32 sum's bound;
  * the packing keeps exactly the digit-0-free rows, K-major, with the
    negation folded in (the limbs recombine to wrap32(-c));
  * the plan fills 132 SMs at B = 1, 4, 256 at both shapes and never cuts
    K' below one 128-deep stage;
  * a model of csrc/priv_keyswitch.cu's one-hot build (a thread's
    16-position chunk, its window advanced a tile at a time, the magic
    divisions, the bit-to-byte spread) equals the one-hot;
  * CircuitCloudKey.data holds prepare_privks of its limbs, and a CPU key
    of the row-major limbs alone (packed at the call) gives the same
    TRGSWs, eager and staged.

Tolerance 0: exact integer arithmetic.  Imports nothing of JAX.
"""

import functools

import numpy as np
import pytest
import torch

from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.boot import circuit
from tfhe_tpu_torch.ops import kernels as K
from tfhe_tpu_torch.params import (CB_ACTIVE, CB_PAPER, CB_PAPER_TOY, CB_TOY,
                                   KeySwitchParams)
from tfhe_tpu_torch.rng import TfheRng


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Toy shapes run faster on one thread than on a shared pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (t, basebit, n2): base 8 and base 2 at CB_TOY's n and at the CB blocks'
# whole n2 = 2,048; N1 = 64, k = 1 (128 output columns) keeps the tables
# small
SHAPES = {"base8_toy": (10, 3, 128), "base2_toy": (32, 1, 128),
          "base8_cb_active": (10, 3, 2048), "base2_cb_paper": (32, 1, 2048)}
N1 = 64


@functools.lru_cache(maxsize=None)
def _table(name: str):
    """A seeded random row-major table (2, 4, (n2+1) t base, 2 N1) with its
    digit-0 rows zeroed (as PrivKeySwitchKey.generate leaves it), the pksk
    over it and its packed form."""
    t, bb, n2 = SHAPES[name]
    ks = KeySwitchParams(t=t, basebit=bb, stdev=2.0**-31)
    g = torch.Generator().manual_seed(n2 + t)
    w = torch.randint(-128, 128, (2, 4, (n2 + 1) * t * ks.base, 2 * N1),
                      dtype=torch.int8, generator=g)
    w.view(2, 4, n2 + 1, t, ks.base, -1)[:, :, :, :, 0] = 0
    pksk = circuit.PrivKeySwitchKey(ks, n2, 1, N1, w)
    return ks, pksk, circuit.prepare_privks(w, ks)


def _samples(B: int, n1: int, seed: int):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(-2**63, 2**63, (B, n1), dtype=np.int64))


@pytest.mark.parametrize("B", [1, 4, 33])
@pytest.mark.parametrize("name", list(SHAPES))
def test_packed_product_matches_priv_keyswitch(name, B):
    ks, pksk, packed = _table(name)
    x = _samples(B, pksk.n_in + 1, B)
    for z in (0, 1):
        want = circuit.priv_keyswitch(x, pksk, z)
        got = K.priv_keyswitch(x, packed[z], t=ks.t, basebit=ks.basebit)
        assert got.dtype == torch.int32 and got.shape == (B, 2 * N1)
        assert torch.equal(got, want.reshape(B, -1))


@pytest.mark.parametrize("name", ["base8_cb_active", "base2_cb_paper"])
def test_digit_extremes(name):
    """aibar = 0 (x = -offset): every digit 0, an empty one-hot, out 0.
    aibar = 2^64 - 1: every digit base-1, one row a digit; with every limb
    -128 or 127 there a limb's sum is n1 t (-128 or 127), the int32 bound
    the kernel's accumulators hold."""
    ks, pksk, packed = _table(name)
    n1 = pksk.n_in + 1
    off = 1 << (63 - ks.basebit * ks.t)
    zero = torch.full((3, n1), -off, dtype=torch.int64)
    for z in (0, 1):
        assert not K.priv_keyswitch(zero, packed[z], t=ks.t,
                                    basebit=ks.basebit).any()
        assert not circuit.priv_keyswitch(zero, pksk, z).any()
    top = torch.full((3, n1), -1 - off, dtype=torch.int64)
    assert K.privks_onehot(top, t=ks.t, basebit=ks.basebit).sum(1).eq(
        n1 * ks.t).all()
    for v in (-128, 127):
        table = torch.full_like(packed[0], v)
        got = K.priv_keyswitch(top, table, t=ks.t, basebit=ks.basebit)
        s = n1 * ks.t * v
        assert abs(s) < 2**31
        want = T.wrap32(torch.tensor(sum(s << (8 * lm) for lm in range(4))))
        assert got.eq(want).all()


@pytest.mark.parametrize("name", ["base8_toy", "base2_toy"])
def test_packing_keeps_digit0_free_rows_negated(name):
    ks, pksk, packed = _table(name)
    t, base, n1 = ks.t, ks.base, pksk.n_in + 1
    kq = K.privks_depth(n1, t, ks.basebit)
    kp1, L, UN, kstride = packed.shape
    assert (kp1, L, UN) == (2, 4, 2 * N1)
    assert kq == n1 * t * (base - 1) and kstride == -(-kq // 16) * 16
    assert not packed[..., kq:].any()
    w = pksk.w_limbs.to(torch.int64)
    c = T.wrap32(sum(w[:, lm] << (8 * lm) for lm in range(4)))
    c = c.reshape(kp1, n1, t, base, UN)
    assert not c[:, :, :, 0].any()                 # the rows left out
    kept = c[:, :, :, 1:].reshape(kp1, kq, UN)     # (i, j, v-1) order
    p = packed[..., :kq].to(torch.int64)
    rec = T.wrap32(sum(p[:, lm] << (8 * lm) for lm in range(4)))
    assert torch.equal(rec, T.wrap32(-kept.transpose(1, 2).to(torch.int64)))
    assert packed.min() >= -128 and packed.max() <= 127


@pytest.mark.parametrize("B", [1, 4, 256])
@pytest.mark.parametrize("P", [CB_ACTIVE, CB_PAPER], ids=["active", "paper"])
def test_plan_fills_the_card(P, B):
    ks = P.ks21
    kq = K.privks_depth(P.n_lvl2 + 1, ks.t, ks.basebit)
    UN = (P.lvl1.k + 1) * P.n_lvl1
    steps = -(-kq // K.PK_BK)
    rows, S, units = K.priv_keyswitch_plan(B, kq, UN, 132)
    assert rows == (64 if B <= 64 else 128)
    assert units == -(-B // rows) * (UN // K.PK_COLS) * S >= 132
    n, slices = K.split_plan(steps, S)
    assert slices == S and 1 <= n and (S - 1) * n < steps <= S * n
    assert K.priv_keyswitch_plan(B, kq, UN, 132, 5)[1] == 5


# --- a model of csrc/priv_keyswitch.cu's one-hot build ---------------------

_M64 = (1 << 64) - 1


def _magic40(d):
    return ((1 << 40) + d - 1) // d


def _group_bits(hi, j, at8, lim, bb, bm1):
    """group_bits: the one-hot bits at window positions [0, 16), as bits 8
    .. 23, of a coefficient whose digits are the top bits of ``hi`` (its
    rounded top 32 bits), from digit group j while at8 = j bm1 - lo + 8 <
    lim."""
    b8, sh = 0, 32 - (j + 1) * bb
    while at8 < lim:
        b8 |= (((1 << ((hi >> sh) & bm1)) >> 1) << at8) & 0xFFFFFFFF
        sh, at8 = sh - bb, at8 + bm1
    return b8


def _brev32(v):
    return int(format(v, "032b")[::-1], 2)


def _build_model(x, t, bb):
    """build: a thread's chunk c16 of each row, its window (coefficient i,
    offset lo) found once by magic division and advanced 128 positions a
    tile; the top 32 bits of the window's one or two rounded coefficients
    (span >= 16), their one-hot bits (at base 2 the digit field
    bit-reversed), spread to bytes by the multiply."""
    B, n1 = x.shape
    bm1 = (1 << bb) - 1
    span, off = t * bm1, 1 << (63 - bb * t)
    kq = n1 * span
    ktiles = -(-kq // 128)
    mask = (1 << t) - 1
    out = np.zeros((B, ktiles * 128), np.uint8)
    for c16 in range(8):
        p0 = 16 * c16
        i = (p0 * _magic40(span)) >> 40
        lo = p0 - i * span
        for kt in range(ktiles):
            in0 = i < n1
            in1 = lo + 16 > span and i + 1 < n1
            for b in range(B):
                hi = ((int(x[b, i]) + off) & _M64) >> 32 if in0 else 0
                hj = ((int(x[b, i + 1]) + off) & _M64) >> 32 if in1 else 0
                bits = 0
                if bm1 == 1:
                    if in0:
                        bits = (_brev32(hi) & mask) >> lo
                    if in1:
                        bits |= (_brev32(hj) & mask) << (span - lo)
                else:
                    b8 = 0
                    if in0:
                        j0 = (lo * _magic40(bm1)) >> 40
                        b8 = _group_bits(hi, j0, j0 * bm1 - lo + 8,
                                         min(24, span - lo + 8), bb, bm1)
                    if in1:
                        b8 |= _group_bits(hj, 0, span - lo + 8, 24, bb, bm1)
                    bits = b8 >> 8
                bits &= 0xFFFF
                col = kt * 128 + p0
                for w in range(4):
                    word = (((bits >> 4 * w) & 0xF) * 0x00204081) & 0x01010101
                    out[b, col + 4 * w:col + 4 * w + 4] = [
                        (word >> 8 * e) & 0xFF for e in range(4)]
            lo += 128
            while lo >= span:
                lo, i = lo - span, i + 1
    return out[:, :kq]


@pytest.mark.parametrize("n1, t, bb", [(129, 10, 3), (129, 32, 1),
                                       (40, 16, 2), (30, 17, 1), (20, 6, 3),
                                       (7, 8, 2), (9, 16, 1)])
def test_build_model_is_the_onehot(n1, t, bb):
    r = np.random.default_rng(n1 * t)
    x = r.integers(-2**63, 2**63, (3, n1), dtype=np.int64)
    off = 1 << (63 - bb * t)
    x[0, :4] = [-off, -1 - off, 0, 2**63 - 1]      # every digit 0, base-1
    want = K.privks_onehot(torch.from_numpy(x), t=t, basebit=bb).numpy()
    assert np.array_equal(_build_model(x, t, bb), want)


# --- the circuit bootstrap's program C on the packed table ----------------

@functools.lru_cache(maxsize=None)
def _cloud(P):
    sk = circuit.CircuitSecretKey.generate(P, TfheRng(5))
    ck = circuit.CircuitCloudKey.generate(sk, TfheRng(6), device="cpu")
    r = np.random.default_rng(7)
    ct = torch.from_numpy(r.integers(-2**31, 2**31, (3, P.n_lvl1 + 1),
                                     dtype=np.int64).astype(np.int32))
    return ck, ct


@pytest.mark.parametrize("P", [CB_TOY, CB_PAPER_TOY], ids=["toy", "paper"])
def test_circuit_bootstrap_on_the_packed_table(P):
    ck, ct = _cloud(P)
    data = ck.data
    assert torch.equal(data["privks_packed"],
                       circuit.prepare_privks(ck.privks.w_limbs, P.ks21))
    row_major = {k: v for k, v in data.items() if k != "privks_packed"}
    want = circuit.circuit_bootstrap(ct, row_major, P)
    assert torch.equal(circuit.circuit_bootstrap(ct, data, P), want)
    staged = circuit.make_circuit_bootstrap_staged(P)
    assert torch.equal(staged(ct, data), want)
