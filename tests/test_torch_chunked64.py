"""The port's 64-bit layers (torus, poly, decomposition, TRLWE, TRGSW, the
chunked engine, the two lvl2 kernels' plain versions, the CMux step and the
blind rotation) against tfhe_tpu's, bit for bit, on the same numpy inputs
(CPU), plus the committed reference anchors of the lvl2 ring
(tests/fixtures/ref_exact, as in tests/test_reference_vectors.py).

Tolerance 0 everywhere: every path is exact integer arithmetic mod 2^64 (or
2^32).  The Pallas kernels run in interpret mode, at the cases of
tests/test_chunked64.py.
"""

import pathlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import tlwe as jtlwe, tgsw as jtgsw
from tfhe_tpu import torus as jT
from tfhe_tpu.boot import blind_rotate as jbr
from tfhe_tpu.ops import decomp as jdecomp, engine as jeng, i64pair
from tfhe_tpu.ops import pallas_kernels as pk, poly as jpoly
from tfhe_tpu.params import (CB_ACTIVE, CB_MXU, CB_TOY, TGswParams,
                             TLweParams)
from tfhe_tpu.rng import TfheRng as JRng
from tfhe_tpu_torch import tgsw, tlwe
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.boot import blind_rotate as br
from tfhe_tpu_torch.ops import decomp, engine, kernels as K, poly
from tfhe_tpu_torch.params import (CB_ACTIVE as T_ACTIVE, CB_MXU as T_MXU,
                                   CB_TOY as T_TOY, TGswParams as TGsw,
                                   TLweParams as TTlwe)
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.utils import observability as obs

EXACT = pathlib.Path(__file__).parent / "fixtures" / "ref_exact"
I64_EDGES = np.array([-2**63, 2**63 - 1, 0, -1, 1, 2**62, -2**62 - 1],
                     np.int64)


def _i64(r, shape):
    x = r.integers(-2**63, 2**63, shape, dtype=np.int64)
    flat = x.reshape(-1)
    flat[:len(I64_EDGES)] = I64_EDGES[:flat.size]
    return x


def _same(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _tgsw_pair(l, bgbit, N, k, key_limbs=0):
    """The same 64-bit gadget in both packages."""
    return (TGswParams(l=l, bgbit=bgbit, key_limbs=key_limbs,
                       tlwe=TLweParams(N=N, k=k, stdev=0.0, bits=64)),
            TGsw(l=l, bgbit=bgbit, key_limbs=key_limbs,
                 tlwe=TTlwe(N=N, k=k, stdev=0.0, bits=64)))


# ---------------------------------------------------------------------------
# torus, poly, decomposition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_limbs", [8, 6, 3])
def test_balanced_limbs64_and_recombine(num_limbs):
    x = _i64(np.random.default_rng(1), (64, 9))
    limbs = T.balanced_limbs(torch.from_numpy(x), num_limbs)
    _same(limbs, jT.balanced_limbs(jnp.asarray(x), num_limbs))
    parts = np.random.default_rng(2).integers(-2**30, 2**30, (num_limbs, 33)
                                              ).astype(np.int32)
    _same(T.recombine_limbs(torch.from_numpy(parts), 8, 64),
          jT.recombine_limbs(jnp.asarray(parts), 8, jnp.int64))
    if num_limbs == 8:                   # eight limbs are the value itself
        _same(T.recombine_limbs(limbs.to(torch.int32), 8, 64), x)


@pytest.mark.parametrize("s", [0, 1, 7, 32, 56, 63])
def test_srl64_and_signed_planes(s):
    x = _i64(np.random.default_rng(3), (200,))
    _same(T.srl64(torch.from_numpy(x), s),
          (x.astype(np.uint64) >> np.uint64(s)).astype(np.int64))
    d = np.random.default_rng(4).integers(-256, 256, (100,)).astype(np.int64)
    _same(T.signed_planes(torch.from_numpy(d), 7, 2),
          jT.signed_planes(jnp.asarray(d), 7, 2))


@pytest.mark.parametrize("index", [0, 5, 127])
def test_poly64(index):
    r = np.random.default_rng(5)
    N, B = 128, 9
    x = _i64(r, (B, 2, N))
    p = r.integers(0, 2 * N, (B,)).astype(np.int32)
    p[:4] = [0, N, 2 * N - 1, N - 1]
    _same(poly.mul_by_xai(torch.from_numpy(p), torch.from_numpy(x)),
          jpoly.mul_by_xai(jnp.asarray(p), jnp.asarray(x)))
    _same(poly.mul_by_xai_minus_one(torch.from_numpy(p), torch.from_numpy(x)),
          jpoly.mul_by_xai_minus_one(jnp.asarray(p), jnp.asarray(x)))
    _same(poly.sample_extract(torch.from_numpy(x), index),
          jpoly.sample_extract(jnp.asarray(x), index))
    _same(poly.negacyclic_shift(torch.from_numpy(x), index + N // 2),
          jpoly.negacyclic_shift(jnp.asarray(x), index + N // 2))


@pytest.mark.parametrize("name", ["CB_ACTIVE", "CB_MXU", "CB_TOY"])
def test_decompose64(name):
    jp = {"CB_ACTIVE": CB_ACTIVE, "CB_MXU": CB_MXU, "CB_TOY": CB_TOY}[name]
    tp = {"CB_ACTIVE": T_ACTIVE, "CB_MXU": T_MXU, "CB_TOY": T_TOY}[name]
    x = _i64(np.random.default_rng(6), (3, 2, tp.n_lvl2))
    _same(decomp.decompose_torus_poly(torch.from_numpy(x), tp.tgsw_lvl2),
          jdecomp.decompose_torus_poly(jnp.asarray(x), jp.tgsw_lvl2))
    _same(decomp.decompose_tlwe(torch.from_numpy(x), tp.tgsw_lvl2),
          jdecomp.decompose_tlwe(jnp.asarray(x), jp.tgsw_lvl2))


# ---------------------------------------------------------------------------
# TRLWE and TRGSW at 64 bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,coarse", [(64, 0), (64, 16), (32, 0),
                                         (32, 8)])
def test_encrypt_zero_and_phase(bits, coarse):
    """Same seed -> the same ciphertexts, including the coarse lattice."""
    jparams = TLweParams(N=128, k=1, stdev=2.0**-40, bits=bits)
    tparams = TTlwe(N=128, k=1, stdev=2.0**-40, bits=bits)
    jkey = jtlwe.TLweKey.generate(jparams, JRng(3))
    key = tlwe.TLweKey.generate(tparams, TfheRng(3))
    np.testing.assert_array_equal(key.key, jkey.key)
    want = jtlwe.encrypt_zero(jkey, JRng(4), (5, 2), coarse_bits=coarse)
    got = tlwe.encrypt_zero(key, TfheRng(4), (5, 2), coarse_bits=coarse,
                            device="cpu")
    _same(got, want)
    if coarse:
        assert not (got & ((1 << coarse) - 1)).any()
    _same(tlwe.tlwe_phase(got, key), jtlwe.tlwe_phase(want, jkey))


def test_tgsw_encrypt64_coarse():
    """tgsw.encrypt at the CB_MXU-gadget toy: bk_limbs=6 puts the rows on
    the 2^16 lattice; same seed -> same TRGSWs."""
    jp = TGswParams(l=5, bgbit=8, key_limbs=6,
                    tlwe=TLweParams(N=128, k=1, stdev=2.0**-44, bits=64))
    tp = TGsw(l=5, bgbit=8, key_limbs=6,
              tlwe=TTlwe(N=128, k=1, stdev=2.0**-44, bits=64))
    jkey = jtlwe.TLweKey.generate(jp.tlwe, JRng(8))
    key = tlwe.TLweKey.generate(tp.tlwe, TfheRng(8))
    msgs = np.array([1, 0, 1])
    want = jtgsw.encrypt(jkey, msgs, jp, JRng(9))
    got = tgsw.encrypt(key, msgs, tp, TfheRng(9), device="cpu")
    _same(got, want)
    _same(tgsw.tgsw_phase(got, key), jtgsw.tgsw_phase(want, jkey))


# ---------------------------------------------------------------------------
# the committed reference anchors (FALSE_RANDOM, CB_ACTIVE lvl2)
# ---------------------------------------------------------------------------

def _pat64(i):
    return ((np.asarray(i, np.uint64) + np.uint64(1))
            * np.uint64(0x9E3779B97F4A7C15)).astype(np.int64)


def _bk0():
    p = T_ACTIVE
    ring2 = tlwe.TLweKey(p.lvl2, np.ones((1, p.n_lvl2), np.int32))
    gsw = tgsw.encrypt(ring2, np.array([1]), p.tgsw_lvl2,
                       TfheRng(false_random=True), stdev=p.bk_stdev,
                       device="cpu")
    return tgsw.rows(gsw[0])                           # (2*l2, 2, N2)


@pytest.mark.parametrize("anchor", ["decomp64_out", "cmux_decomp", "bk0",
                                    "cmux_extprod"])
def test_reference_anchor(anchor):
    p = T_ACTIVE.tgsw_lvl2
    N2, l2 = T_ACTIVE.n_lvl2, p.l
    acc = torch.from_numpy(_pat64(np.arange(2 * N2)).reshape(2, N2))
    if anchor == "decomp64_out":
        ref = np.fromfile(EXACT / "decomp64_out.i32", np.int32)
        q2 = torch.from_numpy(_pat64(np.arange(N2)))
        _same(decomp.decompose_torus_poly(q2, p), ref.reshape(l2, N2))
    elif anchor == "cmux_decomp":
        ref = np.fromfile(EXACT / "cmux_decomp.i32", np.int32)
        _same(decomp.decompose_tlwe(acc, p), ref.reshape(2 * l2, N2))
    elif anchor == "bk0":
        ref = np.fromfile(EXACT / "bk0.i64", np.int64)
        _same(_bk0(), ref.reshape(2 * l2, 2, N2))
    else:
        # the CMux inner body (poc:608-632) through the port's chunked
        # engine: decompose -> product with the bk0 rows
        eng = engine.make_engine(tgsw.engine_config(p), "chunked")
        got = eng.accumulate(decomp.decompose_tlwe(acc, p)[None],
                             eng.prepare(_bk0()))[0]
        ref = np.fromfile(EXACT / "cmux_extprod.i64", np.int64)
        _same(got, ref.reshape(2, N2))


# ---------------------------------------------------------------------------
# the chunked engine and the two kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,J,U,dbits,klimbs,m", [
    (128, 4, 2, 8, 0, 32), (128, 8, 2, 9, 6, 64), (128, 4, 2, 8, 6, 64)])
def test_chunked_engine_matches_jax(N, J, U, dbits, klimbs, m):
    r = np.random.default_rng(0)
    cfg = dict(N=N, out_bits=64, digit_bits=dbits, key_limbs=klimbs)
    key = _i64(r, (J, U, N))
    half = 1 << (dbits - 1)
    x = r.integers(-half, half, (3, J, N)).astype(np.int32)
    x[0, :, :2] = [-half, half - 1]
    je = jeng.ChunkedEngine(jeng.EngineConfig(**cfg), m=m)
    te = engine.ChunkedEngine(engine.EngineConfig(**cfg), m=m)
    jprep = jax.jit(je.prepare)(jnp.asarray(key))
    tprep = te.prepare(torch.from_numpy(key))
    # the 64-bit key is K-packed alone: JAX's wm transposed on the numpy side
    assert set(tprep) == {"wmt"}
    _same(tprep["wmt"], np.swapaxes(np.asarray(jprep["wm"]), -1, -2))
    _same(te.accumulate(torch.from_numpy(x), tprep),
          jax.jit(je.accumulate)(jnp.asarray(x), jprep))
    # a stack of keys prepares in one pass to the per-key layouts
    stacked = te.prepare(torch.from_numpy(np.stack([key, key[::-1].copy()])))
    _same(stacked["wmt"][0], tprep["wmt"])
    _same(stacked["wmt"][1], te.prepare(torch.from_numpy(
        key[::-1].copy()))["wmt"])


@pytest.mark.parametrize("bits", [64, 32])
def test_prepare_k_packed_key(bits):
    """At 64 bits prepare returns wmt alone, built directly and equal to
    ck_wmt of JAX's wm for every leading step (contiguous); at 32 bits wm
    alone, JAX's."""
    r = np.random.default_rng(11)
    cfg = dict(N=128, out_bits=bits, digit_bits=8)
    te = engine.ChunkedEngine(engine.EngineConfig(**cfg), m=32)
    je = jeng.ChunkedEngine(jeng.EngineConfig(**cfg), m=32)
    key = r.integers(-2**31, 2**31, (3, 2, 2, 128)).astype(
        np.int64 if bits == 64 else np.int32)
    prep = te.prepare(torch.from_numpy(key))
    jwm = [torch.from_numpy(np.array(je.prepare(jnp.asarray(key[i]))["wm"]))
           for i in range(3)]
    if bits == 32:
        assert set(prep) == {"wm"}
        assert all(torch.equal(prep["wm"][i], jwm[i]) for i in range(3))
        return
    assert set(prep) == {"wmt"} and prep["wmt"].is_contiguous()
    assert tuple(prep["wmt"].shape) == (3, 2 * 8, 128 + 32, 2 * 32)
    assert all(torch.equal(prep["wmt"][i], K.ck_wmt(jwm[i]))
               for i in range(3))


def test_chunked_naive64_and_the_32_bit_rule():
    cfg = engine.EngineConfig(N=64, out_bits=64, digit_bits=8)
    assert isinstance(engine.make_engine(cfg, "chunked"),
                      engine.ChunkedEngine)
    r = np.random.default_rng(1)
    key = _i64(r, (2, 2, 64))
    x = r.integers(-128, 128, (3, 2, 64)).astype(np.int32)
    jn = jeng.NaiveEngine(jeng.EngineConfig(N=64, out_bits=64, digit_bits=8))
    tn = engine.make_engine(cfg, "naive")
    _same(tn.accumulate(torch.from_numpy(x), tn.prepare(torch.from_numpy(key))),
          jn.accumulate(jnp.asarray(x), jn.prepare(jnp.asarray(key))))
    # at 32 bits the chunked engine takes m = min(128, N), the JAX default
    eng32 = engine.make_engine(engine.EngineConfig(N=64, out_bits=32,
                                                   digit_bits=7), "chunked")
    assert isinstance(eng32, engine.ChunkedEngine) and eng32.m == 64


@pytest.mark.parametrize("N,k,l,bgbit,m", [(128, 1, 5, 8, 32),
                                           (128, 1, 4, 9, 64),
                                           (128, 1, 6, 9, 64),
                                           (256, 2, 4, 9, 64)])
def test_rotate_decompose64_ck_plain(N, k, l, bgbit, m):
    """Against the Pallas kernel (interpret) on the data columns; the pad
    columns of each (chunk, plane) block, which ck_dot64p never reads, are
    zero here and left unwritten by the Pallas kernel.  l = 6 at Bg = 2^9
    is CB_PAPER's lvl2 gadget (two planes, J*m = 768)."""
    r = np.random.default_rng(5)
    p, _ = _tgsw_pair(l, bgbit, N, k)
    B = 4
    acc = _i64(r, (B, k + 1, N))
    a = r.integers(0, 2 * N, (B,)).astype(np.int32)
    a[:2] = [0, N]
    P = 2 if bgbit > 8 else 1
    lo, hi = i64pair.from_i64(jnp.moveaxis(jnp.asarray(acc), -2, 0))
    want = np.asarray(pk.rotate_decompose64_ck(
        jnp.asarray(a), lo, hi, l=l, bgbit=bgbit, offset=p.offset, m=m,
        planes=P, tb=B, interpret=True))
    kw = dict(l=l, bgbit=bgbit, offset=p.offset, m=m, planes=P)
    got = K.rotate_decompose64_ck(torch.from_numpy(a), torch.from_numpy(acc),
                                  **kw)
    # the flat entry (the acc and sacc steps' emitter) gives the same
    flat = K.rotate_decompose64_ck_flat(
        torch.from_numpy(a), torch.from_numpy(acc.reshape(B, -1)), N=N, **kw)
    assert torch.equal(flat, got)
    got = got.numpy()
    jm = (k + 1) * l * m
    ckp = K.ck_width(jm)
    got, want = got.reshape(B, -1, ckp), want.reshape(B, -1, ckp)
    np.testing.assert_array_equal(got[..., :jm], want[..., :jm])
    assert not got[..., jm:].any()
    assert not got[0].any()                  # (X^0 - 1) * acc = 0 digits
    # the layout is decompose_tlwe's digits, chunked (plain emitter check)
    digs = jax.jit(lambda a_, x_: jdecomp.decompose_tlwe(
        jpoly.mul_by_xai_minus_one(a_, x_), p))(jnp.asarray(a),
                                                jnp.asarray(acc))
    planes = T.signed_planes(torch.from_numpy(np.array(digs)), 7, P) \
        if P == 2 else torch.from_numpy(np.array(digs)).to(torch.int8)[None]
    np.testing.assert_array_equal(K.ck_layout(planes, m).numpy(),
                                  got.reshape(B, -1))


@pytest.mark.parametrize("N,kp1,l,U,L,m,P,lgsize", [
    (128, 2, 2, 2, 3, 32, 1, 2), (128, 2, 2, 2, 4, 64, 2, 2),
    (128, 2, 6, 2, 8, 64, 2, 2), (256, 3, 2, 3, 2, 64, 1, 3)])
def test_ck_dot64p_plain(N, kp1, l, U, L, m, P, lgsize):
    r = np.random.default_rng(2)
    C, Jm = N // m, kp1 * l * m
    B = 8
    x = r.integers(-64, 64, (B, C * P * K.ck_width(Jm))).astype(np.int8)
    wm = r.integers(-128, 128, (U * L, Jm, N + m)).astype(np.int8)
    want = pk.ck_dot64p(jnp.asarray(x), jnp.asarray(wm), N=N, m=m, planes=P,
                        tm=8, lgsize=lgsize, interpret=True)
    tx, twm = torch.from_numpy(x), torch.from_numpy(wm)
    # the K-packed key the kernel reads: the plain version contracts it
    got = K.ck_dot64p(tx, K.ck_wmt(twm), N=N, m=m, planes=P,
                      digit_bits=8 if P == 1 else 13)
    _same(got, want)
    # the 32-bit generic contraction's entry transposes wm per call
    def transposes():
        return obs.report()["counters"].get("kernel.ck_dot64p.transposes", 0)
    before = transposes()
    _same(K.ck_dot64p_wm(tx, twm, N=N, m=m, planes=P,
                         digit_bits=8 if P == 1 else 13), want)
    assert transposes() == before + 1
    with pytest.raises(ValueError, match="wmt must be"):
        K.ck_dot64p(tx, twm, N=N, m=m, planes=P, digit_bits=13)


@pytest.mark.parametrize("N,kp1,l,L,m,P", [
    (128, 2, 2, 3, 32, 1), (128, 2, 2, 4, 64, 2), (128, 2, 6, 8, 64, 2),
    (256, 3, 2, 2, 64, 1)])
def test_ck_dot64p_acc_plain_with_wmt(N, kp1, l, L, m, P):
    """ck_dot64p_acc on the K-packed key (its plain version contracts wmt)
    against the Pallas kernel (interpret) at test_ck_dot64p_plain's
    shapes."""
    r = np.random.default_rng(12)
    C, Jm, B = N // m, kp1 * l * m, 8
    x = r.integers(-64, 64, (B, C * P * K.ck_width(Jm))).astype(np.int8)
    wm = r.integers(-128, 128, (kp1 * L, Jm, N + m)).astype(np.int8)
    acc = _i64(r, (B, kp1 * N))
    key_shift = max(0, 64 - 8 * L)
    lo, hi = i64pair.from_i64(jnp.asarray(acc))
    olo, ohi = pk.ck_dot64p_acc(jnp.asarray(x), jnp.asarray(wm), lo, hi, N=N,
                                m=m, key_shift=key_shift, planes=P, tm=8,
                                kp1=kp1, interpret=True)
    want = i64pair.to_i64(olo, ohi)
    tx, twm, tacc = (torch.from_numpy(v) for v in (x, wm, acc))
    kw = dict(N=N, m=m, key_shift=key_shift, planes=P, kp1=kp1,
              digit_bits=8 if P == 1 else 13)
    _same(K.ck_dot64p_acc(tx, K.ck_wmt(twm), tacc, **kw), want)
    _same(K.ck_dot64p_sacc(tx, K.ck_wmt(twm), tacc, **kw), want)
    with pytest.raises(ValueError, match="wmt must be"):    # wm, not wmt
        K.ck_dot64p_acc(tx, twm, tacc, **kw)


@pytest.mark.parametrize("N,m,Jm,P,ok", [
    (2048, 64, 640, 1, True), (2048, 64, 512, 2, True),
    (2048, 64, 768, 2, True), (64, 32, 96, 1, True),
    (32, 16, 64, 1, False), (128, 32, 200, 1, False), (128, 64, 256, 3, False),
    (64, 2, 16, 1, True)])
def test_ck64_kernel_domain_and_plans(N, m, Jm, P, ok):
    """The 64-bit contractions' domain is one predicate (ck_cmux_step64's
    adds m % 4 == 0 for its four-coefficient digit builds): the plan
    functions raise outside it, and inside it choose the rows from B (two
    warpgroups above 64 rows), ck_dot64p's and ck_dot64p_sacc's
    key-stationary plan where C*B is at most KST_ROWS (m a multiple of 64,
    J*m at most 768), and ck_dot64p_acc's limbs a pass from L's parity."""
    assert K.ck64_kernel_ok(N, m, Jm, P) == ok
    assert K.ck_cmux_step64_ok(N, m, Jm, P) == (ok and m % 4 == 0)
    for B in (1, 64, 65, 256):
        rows = 128 if B > 64 else 64
        if not ok:
            for entry in ("ck_dot64p", "ck_dot64p_sacc"):
                with pytest.raises(ValueError,
                                   match=f"^{entry}: the kernel needs"):
                    K.ck_dot64p_plan(B, N, m, Jm, P, entry=entry)
            with pytest.raises(ValueError, match="kernel needs"):
                K.ck_dot64p_acc_plan(B, N, m, Jm, 6, P)
            continue
        stacked = (N // m) * B
        kst = stacked <= 1280 and m % 64 == 0 and Jm <= 768
        assert K.ck_dot64p_plan(B, N, m, Jm, P) == (
            (128, True) if kst else (rows, False))
        assert K.ck_dot64p_acc_plan(B, N, m, Jm, 6, P) == (rows, 2)
        assert K.ck_dot64p_acc_plan(B, N, m, Jm, 5, P) == (rows, 1)


@pytest.mark.parametrize("B,N,m,Jm,P,plan", [
    (1, 2048, 64, 512, 2, (128, True)), (2, 2048, 64, 512, 2, (128, True)),
    (3, 2048, 64, 512, 2, (128, True)), (4, 2048, 64, 512, 2, (128, True)),
    (5, 2048, 64, 512, 2, (128, True)), (40, 2048, 64, 512, 2, (128, True)),
    (41, 2048, 64, 512, 2, (64, False)), (64, 2048, 64, 512, 2, (64, False)),
    (256, 2048, 64, 512, 2, (128, False)),
    (4, 2048, 64, 768, 2, (128, True)), (40, 2048, 64, 768, 2, (128, True)),
    (256, 2048, 64, 768, 2, (128, False)),
    (4, 2048, 64, 896, 2, (64, False)), (3, 2048, 64, 640, 1, (128, True)),
    (1, 2048, 32, 512, 2, (64, False)), (80, 2048, 128, 512, 1, (128, True)),
    (81, 2048, 128, 512, 1, (128, False)),
    (16, 256, 64, 256, 1, (128, True)), (320, 256, 64, 256, 1, (128, True)),
    (321, 256, 64, 256, 1, (128, False))])
def test_ck_dot64p_plan_kst(B, N, m, Jm, P, plan):
    """The key-stationary plan exactly where the C*B stacked rows are at
    most KST_ROWS (1,280, the measured crossover: B = 40 at C = 32; 128
    stacked rows a block at every B), m is a multiple of the 64-row key
    tile and the key's 64 rows of 4 limb groups fit in 6 K tiles (J*m <=
    768): a CB_ACTIVE or CB_PAPER query's B = 4, CB_MXU's B = 3; every
    wider batch keeps the output-stationary rows (B = 256: 128).
    ck_dot64p_sacc, the default 64-bit step's contraction, takes the same
    plan by the same rule and constant."""
    assert K.KST_ROWS == 1280
    assert K.ck_dot64p_plan(B, N, m, Jm, P) == plan
    assert K.ck_dot64p_plan(B, N, m, Jm, P, entry="ck_dot64p_sacc") == plan


def test_kst_ktiles_mirrors_the_kernel():
    """The key-stationary mainloop owns the limit on its resident key
    (KST_MAX_KTILES, held against its shared memory by a static_assert);
    the plan's KST_KTILES is that number, so neither wrapper ever picks a
    launch its kernel refuses."""
    src = (pathlib.Path(K.__file__).parent / "csrc" / "ck_kst.cuh"
           ).read_text()
    found = re.findall(r"constexpr int KST_MAX_KTILES = (\d+);", src)
    assert found == [str(K.KST_KTILES)]
    assert K.ck_kst_ok(2048, 64, 128 * K.KST_KTILES)
    assert not K.ck_kst_ok(2048, 64, 128 * K.KST_KTILES + 64)


def _kst_model(x, wmt, *, N, m, planes, rows):
    """The key-stationary plan's decomposition in torch, in the kernel's
    layout: block (z, gz, t) multiplies key rows [64t, 64t + 64) of limb
    groups [4gz, 4gz + 4) (zero past N+m and UL, as TMA fills them) with
    stacked rows rr = b*C + c in [rows*z, rows*(z + 1)) (row rr of x seen as
    (B*C, P*ckp)), planes highest first with Horner's shift by 7, and
    stages each product row at [z, gz, t, rr % rows, limb*64 + q % 64],
    negated where its ring position c*m + q lies at or above N; out[g, b,
    i] is the sum, over every chunk c and both halves, of the staged row
    b*C + c of the tile holding key row i (+ N) - c*m (the kernel adds each
    staged row into out by a TMA reduction).  Returns the folded (UL, B, N)
    int32 and whether every staged row kept one sign."""
    UL, Npm, Jm = wmt.shape
    B, C = x.shape[0], N // m
    NT, GZ, S = -(-Npm // 64), -(-UL // 4), -(-B * C // rows)
    ckp = K.ck_width(Jm)
    a = torch.zeros((S * rows, planes, Jm), dtype=torch.float64)
    a[:B * C] = x.reshape(B * C, planes, ckp)[..., :Jm].double()
    key = torch.zeros((GZ * 4, NT * 64, Jm), dtype=torch.float64)
    key[:UL, :Npm] = wmt.double()
    part = torch.zeros((S, GZ, NT, rows, 256), dtype=torch.int64)
    rr = torch.arange(S * rows).reshape(S, rows)
    q = torch.arange(256) % 64
    one_sign = True
    for z in range(S):
        for gz in range(GZ):
            for t in range(NT):
                w = key[4 * gz:4 * gz + 4, 64 * t:64 * t + 64].reshape(256,
                                                                        Jm)
                acc = torch.zeros((rows, 256), dtype=torch.int64)
                for p in reversed(range(planes)):
                    acc = (acc << 7) + (a[rr[z], p] @ w.T).long()
                r = (rr[z] % C)[:, None] * m + 64 * t + q[None, :]
                upper = r >= N
                one_sign &= bool((upper == upper[:, :1]).all())
                part[z, gz, t] = T.wrap32(torch.where(upper, -acc, acc))
    out = torch.zeros((UL, B, N), dtype=torch.int64)
    i = torch.arange(N)
    g = torch.arange(UL)
    for b in range(B):
        for c in range(C):
            z, rl = divmod(b * C + c, rows)
            for half in (0, 1):
                kq = i + half * N - c * m
                ok = (kq >= 0) & (kq < Npm)
                kq = kq[ok]
                out[:, b, ok] += part[z, (g // 4)[:, None], (kq // 64)[None],
                                      rl, ((g % 4) * 64)[:, None]
                                      + (kq % 64)[None]]
    return T.wrap32(out), one_sign


@pytest.mark.parametrize("N", [256, 2048])
@pytest.mark.parametrize("m", [32, 64])
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("B", [1, 4])
def test_ck_dot64p_kst_model(N, m, P, B):
    """The key-stationary decomposition (key tiles times chunk-stacked
    digits, folded through the ring tile of c*m + 64t with the X^N sign)
    equals ck_dot64p_plain, in the kernel's 128-row tiles (several slices
    of stacked rows where C*B exceeds one), with a ragged last limb group; a
    stored row keeps one sign exactly where m is a multiple of 64, the
    condition under which the kernel negates whole rows."""
    r = np.random.default_rng(40 + N + m + P + B)
    J, UL = 4, 6
    Jm = J * m
    lo, hi = (-128, 128) if P == 1 else (-64, 65)
    x = torch.from_numpy(r.integers(lo, hi, (B, (N // m) * P * K.ck_width(
        Jm))).astype(np.int8))
    wmt = torch.from_numpy(r.integers(-128, 128, (UL, N + m, Jm)).astype(
        np.int8))
    want = K.ck_dot64p_plain(x, wmt, N=N, m=m, planes=P)
    got, one_sign = _kst_model(x, wmt, N=N, m=m, planes=P, rows=128)
    assert torch.equal(got, want.long())
    assert one_sign == (m % 64 == 0)


def _kst_sacc_model(x, wmt, acc, *, N, m, planes, kp1, key_shift,
                    rows=128):
    """ck_dot64p_sacc's key-stationary plan in torch, in the kernel's
    layout: block (z, gz, t) folds key rows [64t, 64t + 64) of limb groups
    [4gz, 4gz + 4) (zero past N+m and UL) against stacked rows rr = b*C + c
    in [rows*z, rows*(z + 1)) into int32, planes highest first; for each
    polynomial u the block's limb rows g belong to, it sums each row's
    limbs, widened and shifted by 8 (g - u*L) + key_shift (64 or more:
    gone), negates the sum where c*m + 64t lies at or above N and adds the
    staged 64 int64 into out[b, u*N + (c*m + 64t) mod N ..] (a TMA
    reduction), rows past C*B dropped; out starts as acc.  Returns out and
    how many staged rows each block sent per stacked row, at most."""
    UL, Npm, Jm = wmt.shape
    L, B, C = UL // kp1, x.shape[0], N // m
    NT, GZ, S = -(-Npm // 64), -(-UL // 4), -(-B * C // rows)
    ckp = K.ck_width(Jm)
    a = torch.zeros((S * rows, planes, Jm), dtype=torch.float64)
    a[:B * C] = x.reshape(B * C, planes, ckp)[..., :Jm].double()
    key = torch.zeros((GZ * 4, NT * 64, Jm), dtype=torch.float64)
    key[:UL, :Npm] = wmt.double()
    out = acc.clone().reshape(-1)
    most = 0
    for z in range(S):
        rr = torch.arange(rows * z, rows * (z + 1))
        live = rr < B * C
        b, c = rr // C, rr % C
        for gz in range(GZ):
            last = min(4 * gz + 4, UL) - 1
            for t in range(NT):
                w = key[4 * gz:4 * gz + 4, 64 * t:64 * t + 64]
                fold = torch.zeros((rows, 4, 64), dtype=torch.int64)
                for p in reversed(range(planes)):
                    fold = T.wrap32((fold << 7) + torch.einsum(
                        "rk,gqk->rgq", a[rr, p], w).long()).long()
                r = c * m + 64 * t
                upper = r >= N
                col = torch.where(upper, r - N, r)
                us = range(4 * gz // L, last // L + 1)
                most = max(most, len(us))
                for u in us:
                    staged = torch.zeros((rows, 64), dtype=torch.int64)
                    for lg in range(4):
                        gi = 4 * gz + lg
                        s = 8 * (gi - u * L) + key_shift
                        if gi <= last and gi // L == u and s < 64:
                            staged += fold[:, lg] << s
                    staged = torch.where(upper[:, None], -staged, staged)
                    idx = ((b * kp1 * N + u * N + col)[:, None]
                           + torch.arange(64)[None])
                    out.index_add_(0, idx[live].reshape(-1),
                                   staged[live].reshape(-1))
    return out.reshape(acc.shape), most


@pytest.mark.parametrize("N,m,kp1,L,l,P,B,key_shift,extreme,most", [
    (256, 64, 2, 8, 2, 2, 4, 0, False, 1),   # CB_ACTIVE's limbs and planes
    (256, 64, 2, 8, 2, 2, 3, 16, True, 1),   # limbs 6, 7 shifted out
    (256, 64, 2, 6, 3, 1, 33, 24, False, 2),  # straddling groups, 2 slices
    (512, 64, 2, 6, 2, 1, 5, 24, True, 2),
    (512, 128, 3, 3, 1, 1, 2, 40, False, 2),  # k = 2, a ragged limb group
    (256, 64, 4, 1, 1, 2, 3, 56, True, 4)])  # one-limb keys: two passes
def test_ck_dot64p_sacc_kst_model(N, m, kp1, L, l, P, B, key_shift,
                                   extreme, most):
    """The key-stationary epilogue of ck_dot64p_sacc (limbs widened,
    shifted and summed per polynomial, one staged int64 row per polynomial
    and stacked row, negated above N, reduced into an acc-filled output)
    equals ck_dot64p_acc_plain bit for bit: L = 8 (one polynomial a limb
    group), L = 6 and 3 (a group straddling two) and L = 1 (four, which
    the kernel stages two a pass), shifts of 64 or more vanishing, stacked
    rows past C*B, and the contract's extreme digits (P = 1: -128 and 127;
    P = 2: -256 and 255 as (high, low) planes (-2, 0) and (2, -1)) against
    key limbs of -128."""
    r = np.random.default_rng(41 + N + L + B)
    C, Jm = N // m, kp1 * l * m
    UL = kp1 * L
    width = C * P * K.ck_width(Jm)
    if extreme:
        x = np.zeros((B, C, P, width // (C * P)), np.int8)
        # each plane's value in the even and in the odd batch rows
        even, odd = ((-128,), (127,)) if P == 1 else ((0, -2), (-1, 2))
        for p in range(P):
            x[0::2, :, p], x[1::2, :, p] = even[p], odd[p]
        x = x.reshape(B, width)
        wmt = np.full((UL, N + m, Jm), -128, np.int8)
    else:
        lo, hi = (-128, 128) if P == 1 else (-64, 65)
        x = r.integers(lo, hi, (B, width)).astype(np.int8)
        wmt = r.integers(-128, 128, (UL, N + m, Jm)).astype(np.int8)
    x, wmt = torch.from_numpy(x), torch.from_numpy(wmt)
    acc = torch.from_numpy(_i64(r, (B, kp1 * N)))
    kw = dict(N=N, m=m, planes=P, kp1=kp1, key_shift=key_shift)
    assert K.ck_dot64p_exact(Jm // m, N, m, 8 if P == 1 else 9)
    got, polys = _kst_sacc_model(x, wmt, acc, **kw)
    assert torch.equal(got, K.ck_dot64p_acc_plain(x, wmt, acc, **kw))
    assert polys == most


@pytest.mark.parametrize("gadget", ["cb_toy", "mxu"])
def test_chunked_cmux_step64_ends_in_its_contraction(monkeypatch, gadget):
    """The chunked engine's default 64-bit step is rotate_decompose64_ck
    then ck_dot64p_sacc on acc's flat view, and nothing after it: its
    result equals acc + recombine(ck_dot64p_plain(digits)), ck_dot64p is
    not called, and the (B, k+1, N) result views the contraction's output
    (no epilogue of torch ops follows; on the CPU the contraction's plain
    version recombines inside)."""
    p = T_TOY.tgsw_lvl2
    if gadget == "mxu":                       # one plane, six key limbs
        _, p = _tgsw_pair(5, 8, 128, 1, 6)
    r = np.random.default_rng(15)
    B, N, k = 5, p.tlwe.N, p.tlwe.k
    te = engine.make_engine(tgsw.engine_config(p), "chunked")
    P = te.cfg.plane_split[1]
    prep = te.prepare(torch.from_numpy(
        r.integers(-2**50, 2**50, (p.kpl, k + 1, N)).astype(np.int64)))
    acc = torch.from_numpy(_i64(r, (B, k + 1, N)))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset)
    x = K.rotate_decompose64_ck(a, acc, m=te.m, planes=P, **kw)
    want = acc + K.recombine(K.ck_dot64p_plain(x, prep["wmt"], N=N, m=te.m,
                                               planes=P), k + 1,
                             te.cfg.key_shift)
    seen, outs = [], []

    def spy(name, real):
        def call(*args, **kwargs):
            seen.append(name)
            out = real(*args, **kwargs)
            outs.append(out)
            return out
        return call

    for name in ("ck_dot64p_sacc", "ck_dot64p"):
        monkeypatch.setattr(K, name, spy(name, getattr(K, name)))
    got = te.cmux_step(a, acc, prep, **kw)
    assert seen == ["ck_dot64p_sacc"]
    assert got.shape == (B, k + 1, N)
    assert got.data_ptr() == outs[0].data_ptr()
    _same(got, want.numpy())


def test_ck_dot64p_asserts_the_int32_bound():
    x = torch.zeros((2, 2 * 4 * 128), dtype=torch.int8)
    wmt = torch.zeros((2, 128 + 64, 4 * 64), dtype=torch.int8)
    K.ck_dot64p(x, wmt, N=128, m=64, planes=2)         # 9-bit digits fit
    with pytest.raises(ValueError, match="int32 accumulation bound"):
        K.ck_dot64p(x, wmt, N=128, m=64, planes=2, digit_bits=20)
    # prepare holds the key to the same bound: J=32 rows of 9-bit digits
    # at N=2048 exceed it, J=16 (CB_ACTIVE's (k+1)*l2 = 8, doubled) and
    # J=12 (CB_PAPER's (k+1)*l2) do not
    te = engine.ChunkedEngine(engine.EngineConfig(N=2048, out_bits=64,
                                                  digit_bits=9))
    assert K.ck_dot64p_exact(16, 2048, 64, 9)
    assert K.ck_dot64p_exact(12, 2048, 64, 9)
    with pytest.raises(ValueError, match="int32 accumulation bound"):
        te.prepare(torch.zeros((32, 1, 2048), dtype=torch.int64))


def test_converted_circuit_key_carries_wmt():
    """A chunked circuit key carried over from the JAX package's arrays
    holds the K-packed key alone, ck_wmt of JAX's wm, as prepare gives
    it."""
    from tfhe_tpu_torch import convert
    r = np.random.default_rng(13)
    p = T_TOY
    te = engine.make_engine(tgsw.engine_config(p.tgsw_lvl2), "chunked")
    UL, Jm = (p.lvl2.k + 1) * te.cfg.num_limbs, p.tgsw_lvl2.kpl * te.m
    wm = r.integers(-128, 128, (p.n_lvl0, UL, Jm, p.n_lvl2 + te.m)).astype(
        np.int8)
    ks10, ks21 = p.ks10, p.ks21
    data = {"preks": r.integers(-128, 128, (4, p.n_lvl1 * ks10.t * ks10.base,
                                            p.n_lvl0 + 1)).astype(np.int8),
            "bk": {"wm": wm},
            "privks": r.integers(-128, 128, (
                p.lvl1.k + 1, 4, (p.n_lvl2 + 1) * ks21.t * ks21.base,
                (p.lvl1.k + 1) * p.n_lvl1)).astype(np.int8)}
    ck = convert.circuit_cloud_key_from_numpy(data, p, "chunked",
                                              device="cpu")
    assert set(ck.data["bk"]) == {"wmt"}
    assert ck.data["bk"]["wmt"].is_contiguous()
    _same(ck.data["bk"]["wmt"], K.ck_wmt(torch.from_numpy(wm)))


@pytest.mark.parametrize("var,value,name,arg", [
    ("", "", "ck_dot64p_sacc", 1),
    ("TFHE_CK64_PATH", "acc", "ck_dot64p_acc", 1),
    ("TFHE_CK64_PATH", "sacc", "ck_dot64p_sacc", 1),
    ("TFHE_CK64_FUSED", "1", "ck_cmux_step64", 2)])
def test_64_bit_steps_read_the_prepared_k_packed_key(monkeypatch, var,
                                                      value, name, arg):
    """Every 64-bit step hands prepared["wmt"], the only key the 64-bit
    prepare makes, to its contraction through rotate_steps, step by step,
    and gives the default step's bits."""
    p = T_TOY.tgsw_lvl2
    r = np.random.default_rng(14)
    n, B, N, k = 3, 2, p.tlwe.N, p.tlwe.k
    te = engine.make_engine(tgsw.engine_config(p), "chunked")
    key = r.integers(-2**50, 2**50, (n, p.kpl, k + 1, N)).astype(np.int64)
    prep = te.prepare(torch.from_numpy(key))
    assert set(prep) == {"wmt"}
    acc = torch.from_numpy(_i64(r, (B, k + 1, N)))
    abar = torch.from_numpy(r.integers(0, 2 * N, (B, n)).astype(np.int32))
    default = br.blind_rotate(acc, prep, abar, p, "chunked")
    real, seen = getattr(K, name), []

    def spy(*args, **kw):
        seen.append(args[arg])
        return real(*args, **kw)

    if var:
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(K, name, spy)
    got = br.blind_rotate(acc, prep, abar, p, "chunked")
    assert len(seen) == n
    assert all(w.data_ptr() == prep["wmt"][i].data_ptr()
               for i, w in enumerate(seen))
    assert torch.equal(got, default)


# ---------------------------------------------------------------------------
# the CMux step and the blind rotation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l,bgbit,klimbs", [(4, 9, 0), (5, 8, 6)])
def test_cmux_step64_matches_jax(l, bgbit, klimbs):
    """The chunked engine's step (plain kernels on the CPU) equals the JAX
    package's generic step acc + accumulate(decompose((X^a - 1) acc)), with
    the JAX naive oracle on the rounded key as the product."""
    N, k, B = 128, 1, 5
    jp, tp = _tgsw_pair(l, bgbit, N, k, klimbs)
    r = np.random.default_rng(3)
    key = _i64(r, (jp.kpl, k + 1, N))
    acc = _i64(r, (B, k + 1, N))
    a = r.integers(0, 2 * N, (B,)).astype(np.int32)
    cfg = jtgsw.engine_config(jp)
    kr = jnp.asarray(np.asarray(jeng._key_rounded(cfg, jnp.asarray(key)))
                     << cfg.key_shift)
    je = jeng.NaiveEngine(cfg)

    @jax.jit
    def step(a_, acc_, kr_):
        digits = jdecomp.decompose_tlwe(jpoly.mul_by_xai_minus_one(a_, acc_),
                                        jp)
        return acc_ + je.accumulate(digits, je.prepare(kr_))

    want = step(jnp.asarray(a), jnp.asarray(acc), kr)
    te = engine.make_engine(tgsw.engine_config(tp), "chunked")
    got = te.cmux_step(torch.from_numpy(a), torch.from_numpy(acc),
                       te.prepare(torch.from_numpy(key)), l=l, bgbit=bgbit,
                       offset=tp.offset)
    _same(got, want)


@pytest.mark.parametrize("backend", ["chunked", "naive"])
def test_blind_rotate64_matches_jax(backend):
    """A 6-step lvl2 blind rotation at CB_TOY's gadget (two digit planes,
    eight key limbs)."""
    p, tp = CB_TOY.tgsw_lvl2, T_TOY.tgsw_lvl2
    r = np.random.default_rng(4)
    n, B, N, k = 6, 3, p.tlwe.N, p.tlwe.k
    key = r.integers(-2**50, 2**50, (n, p.kpl, k + 1, N)).astype(np.int64)
    acc = _i64(r, (B, k + 1, N))
    abar = r.integers(0, 2 * N, (B, n)).astype(np.int32)
    jprepare = jax.jit(jtgsw.make_engine(jtgsw.engine_config(p),
                                         "chunked").prepare)
    jprep = {"wm": jnp.stack([jprepare(jnp.asarray(key[i]))["wm"]
                              for i in range(n)])}
    want = jbr.blind_rotate(jnp.asarray(acc), jprep, jnp.asarray(abar), p,
                            "chunked")
    teng = engine.make_engine(tgsw.engine_config(tp), backend)
    preps = [teng.prepare(torch.from_numpy(key[i])) for i in range(n)]
    tprep = {name: torch.stack([q[name] for q in preps]) for name in preps[0]}
    got = br.blind_rotate(torch.from_numpy(acc), tprep, torch.from_numpy(abar),
                          tp, backend)
    _same(got, want)
