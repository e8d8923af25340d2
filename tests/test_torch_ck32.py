"""The port's N=1024 gate path pieces against tfhe_tpu's, bit for bit, on the
CPU: the 32-bit chunked engine (prepare, accumulate, the step on the 3-D and
the flat carry), the plain versions of ck_cmux_step32, ck_dot64p_acc and
rotate_decompose64_ck_flat against the Pallas kernels in interpret mode (at
the cases of tests/test_chunked64.py), the fused-epilogue 64-bit blind
rotation (TFHE_CK64_PATH=acc and sacc), and the gate bootstrap on
backend="chunked": same seed -> same keys, and the same ciphertexts as JAX's chunked gates, the
port's onthefly gates and the port on converted JAX keys.

Tolerance 0: every path is exact integer arithmetic mod 2^32 or 2^64.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import tgsw as jtgsw
from tfhe_tpu.boot import blind_rotate as jbr, gate as jgate
from tfhe_tpu.ops import engine as jeng, i64pair
from tfhe_tpu.ops import pallas_kernels as pk
from tfhe_tpu.params import (CB_TOY, GATE_FAST2, GATE_TOY, GateParams,
                             LweParams, TGswParams, TLweParams)
from tfhe_tpu.rng import TfheRng as JRng
from tfhe_tpu_torch import convert, tgsw, torus as T
from tfhe_tpu_torch.boot import blind_rotate as br, gate
from tfhe_tpu_torch.ops import engine, kernels as K
from tfhe_tpu_torch.params import (CB_TOY as T_CB_TOY,
                                   GATE_FAST2 as T_FAST2, GATE_TOY as T_TOY,
                                   GateParams as TGate, LweParams as TLwe,
                                   TGswParams as TGsw, TLweParams as TTlwe)
from tfhe_tpu_torch.rng import TfheRng

SHALLOW = GateParams(lwe=LweParams(n=8, stdev=2.0**-14), tgsw=GATE_FAST2.tgsw,
                     ks=GATE_FAST2.ks)
T_SHALLOW = TGate(lwe=TLwe(n=8, stdev=2.0**-14), tgsw=T_FAST2.tgsw,
                  ks=T_FAST2.ks)
CASES = {"toy": (GATE_TOY, T_TOY), "fast2_shallow": (SHALLOW, T_SHALLOW)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These toy shapes are far too small for torch's thread pool, which
    only adds waiting on a machine shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _i32(r, shape):
    return r.integers(-2**31, 2**31, shape).astype(np.int32)


def _i64(r, shape):
    return r.integers(-2**63, 2**63, shape, dtype=np.int64)


def _tgsw_pair(l, bgbit, N, k, key_limbs=0, bits=32):
    return (TGswParams(l=l, bgbit=bgbit, key_limbs=key_limbs,
                       tlwe=TLweParams(N=N, k=k, stdev=0.0, bits=bits)),
            TGsw(l=l, bgbit=bgbit, key_limbs=key_limbs,
                 tlwe=TTlwe(N=N, k=k, stdev=0.0, bits=bits)))


# ---------------------------------------------------------------------------
# the 32-bit chunked engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,J,U,dbits,klimbs,m", [
    (256, 6, 3, 7, 3, 64),          # tests/test_chunked64.py:62's 32-bit case
    (128, 6, 2, 8, 0, None),        # the default m (min(128, N))
    (128, 4, 2, 9, 0, 32)])         # two digit planes
def test_chunked32_engine_matches_jax(N, J, U, dbits, klimbs, m):
    r = np.random.default_rng(0)
    cfg = dict(N=N, out_bits=32, digit_bits=dbits, key_limbs=klimbs)
    key = _i32(r, (J, U, N))
    key.reshape(-1)[:2] = [-2**31, 2**31 - 1]
    half = 1 << (dbits - 1)
    x = r.integers(-half, half, (3, J, N)).astype(np.int32)
    x[0, :, :2] = [-half, half - 1]
    je = jeng.ChunkedEngine(jeng.EngineConfig(**cfg), m=m)
    te = engine.ChunkedEngine(engine.EngineConfig(**cfg), m=m)
    assert te.m == je.m
    jprep = jax.jit(je.prepare)(jnp.asarray(key))
    tprep = te.prepare(torch.from_numpy(key))
    _same(tprep["wm"], jprep["wm"])
    _same(te.accumulate(torch.from_numpy(x), tprep),
          jax.jit(je.accumulate)(jnp.asarray(x), jprep))
    acc = _i32(r, (3, U, N))
    _same(te.accumulate_into(torch.from_numpy(acc), torch.from_numpy(x),
                             tprep),
          jax.jit(je.accumulate_into)(jnp.asarray(acc), jnp.asarray(x),
                                      jprep))


def test_chunked32_prepare_keeps_the_jax_bound():
    """JAX's prepare asserts J*(N+m)*max_digit*128 < 2^31; the port raises
    on the same shapes and passes the others."""
    for J, N, dbits in ((6, 256, 8), (12, 512, 9), (120, 1024, 8)):
        cfg = dict(N=N, out_bits=32, digit_bits=dbits)
        key = np.zeros((J, 1, N), np.int32)
        je = jeng.ChunkedEngine(jeng.EngineConfig(**cfg))
        te = engine.ChunkedEngine(engine.EngineConfig(**cfg))
        try:
            jax.jit(je.prepare)(jnp.asarray(key))
            jax_ok = True
        except AssertionError:
            jax_ok = False
        if jax_ok:
            te.prepare(torch.from_numpy(key))
        else:
            with pytest.raises(ValueError, match="int32 accumulation bound"):
                te.prepare(torch.from_numpy(key))
    assert not jax_ok                           # the last case is over it


# ---------------------------------------------------------------------------
# ck_cmux_step32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,k,l,bgbit,klimbs,m,tm", [
    (128, 1, 3, 7, 3, 32, 4), (256, 1, 3, 7, 0, 64, 8),
    (128, 2, 2, 8, 3, 64, 8)])
def test_ck_cmux_step32_plain_matches_pallas(N, k, l, bgbit, klimbs, m, tm):
    """The plain version, the engine's step and its flat form against the
    Pallas kernel (interpret) at tests/test_chunked64.py:225-227's shapes,
    on the 3-D and the flat carry."""
    r = np.random.default_rng(6)
    p, tp = _tgsw_pair(l, bgbit, N, k, klimbs)
    cfg = jtgsw.engine_config(p)
    B = 8
    key = _i32(r, (p.kpl, k + 1, N))
    acc = _i32(r, (B, k + 1, N))
    a = r.integers(0, 2 * N, (B,)).astype(np.int32)
    a[:3] = [0, N, 2 * N - 1]
    wm = jeng.ChunkedEngine(cfg, m=m).prepare(jnp.asarray(key))["wm"]
    kw = dict(l=l, bgbit=bgbit, offset=p.offset, key_shift=cfg.key_shift,
              m=m)
    want = np.asarray(pk.ck_cmux_step32(jnp.asarray(a), jnp.asarray(acc), wm,
                                        tm=tm, interpret=True, **kw))
    if k == 1 and m == 32:               # the Pallas kernel's flat carry once
        want_flat = np.asarray(pk.ck_cmux_step32(
            jnp.asarray(a), jnp.asarray(acc).reshape(B, -1), wm, tm=tm,
            kp1=k + 1, interpret=True, **kw))
        np.testing.assert_array_equal(want_flat.reshape(want.shape), want)
    want_flat = want.reshape(B, -1)
    ta, tacc = torch.from_numpy(a), torch.from_numpy(acc)
    twm = torch.from_numpy(np.array(wm))
    _same(K.ck_cmux_step32(ta, tacc, twm, **kw), want)
    _same(K.ck_cmux_step32(ta, tacc.reshape(B, -1), twm, kp1=k + 1, **kw),
          want_flat)
    te = engine.ChunkedEngine(tgsw.engine_config(tp), m=m)
    step = dict(l=l, bgbit=bgbit, offset=tp.offset)
    _same(te.cmux_step(ta, tacc, {"wm": twm}, **step), want)
    _same(te.cmux_step_flat(ta, tacc.reshape(B, -1), {"wm": twm}, kp1=k + 1,
                            **step), want_flat)


def test_ck_cmux_step32_wrapper_rules():
    """The step goes to ck_cmux_step32 only under JAX's predicate (one
    digit plane, bgbit <= 8, a 32-bit key); the wrapper rejects what the
    kernel cannot take."""
    big = engine.ChunkedEngine(engine.EngineConfig(N=64, out_bits=32,
                                                   digit_bits=9))
    acc = torch.zeros((2, 2, 64), dtype=torch.int32)
    a = torch.zeros(2, dtype=torch.int32)
    assert big.cmux_step(a, acc, {}, l=3, bgbit=9, offset=0) is None
    wm = torch.zeros((8, 2 * 3 * 64, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="tile_rows"):
        K.ck_cmux_step32(a, acc, wm, l=3, bgbit=7, offset=0, m=64,
                         tile_rows=16)
    with pytest.raises(ValueError, match="fit int8"):
        K.ck_cmux_step32(a, acc, wm, l=3, bgbit=9, offset=0, m=64)
    with pytest.raises(ValueError, match="flat acc"):
        K.ck_cmux_step32(a, acc.reshape(2, -1), wm, l=3, bgbit=7, offset=0,
                         m=64)
    for bad in (-1, K.ck_work(64, 64) + 1):      # a tile has 2 windows here
        with pytest.raises(ValueError, match="split"):
            K.ck_cmux_step32(a, acc, wm, l=3, bgbit=7, offset=0, m=64,
                             split=bad)


def _slice_partial(digits, wm, acc, *, i0, windows, N, m, kp1, key_shift):
    """A Python mirror of one ck_cmux_step32 block's slice: for the output
    tile of folded columns [i0, i0+128) of every polynomial, the signed sum
    of its ``windows`` (chunk, sign) key products, limbs recombined mod
    2^32; acc where ``acc`` is given (the one-slice epilogue).  Key columns
    outside [0, N+m) read as zero."""
    B = digits.shape[0]
    L = wm.shape[0] // kp1
    x = K.ck_layout(digits[None], m).reshape(B, N // m, -1).to(torch.float64)
    wpad = torch.nn.functional.pad(wm.to(torch.float64), (N, N))
    cols = torch.arange(i0, min(i0 + 128, N))
    out = torch.zeros((B, kp1, len(cols)), dtype=torch.int64)
    for u in range(kp1):
        for lm in range(L):
            y = torch.zeros((B, len(cols)), dtype=torch.int64)
            for c, sign in windows:
                q = (0 if sign > 0 else N) + cols - c * m
                y += sign * (x[:, c, :wm.shape[1]]
                             @ wpad[u * L + lm][:, q + N]).to(torch.int64)
            sh = 8 * lm + key_shift
            if sh < 32:
                out[:, u] += y << sh
    if acc is not None:
        out += acc[:, :, cols].to(torch.int64)
    return out


@pytest.mark.parametrize("N,m,L,split", [
    (256, 128, 3, 1), (256, 128, 3, 2), (256, 128, 4, 3), (256, 64, 2, 4),
    (256, 64, 3, 6), (128, 32, 1, 8), (128, 32, 2, 5)])
def test_ck_cmux_step32_window_partition(N, m, L, split):
    """The kernel's window split (ck_windows, window_slice): every window of
    every column tile falls in exactly one slice, and
    the slices' partial sums, added mod 2^32 onto acc as the atomics do,
    give ck_cmux_step32_plain bit for bit."""
    r = np.random.default_rng(11)
    B, kp1, l, bgbit = 5, 2, 3, 7
    acc = torch.from_numpy(_i32(r, (B, kp1, N)))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    a[0] = N
    wm = torch.from_numpy(r.integers(-128, 128, (kp1 * L, kp1 * l * m, N + m))
                          .astype(np.int8))
    offset = 0x81020400
    key_shift = max(0, 32 - 8 * L)
    digits = K.rotate_decompose_plain(a, acc, l=l, bgbit=bgbit, offset=offset)
    want = K.ck_cmux_step32_plain(a, acc, wm, l=l, bgbit=bgbit, offset=offset,
                                  m=m, key_shift=key_shift)
    got = torch.zeros((B, kp1, N), dtype=torch.int64)
    for i0 in range(0, N, 128):
        wins = K.ck_windows(i0, N, m)
        assert len(wins) <= K.ck_work(N, m)
        seen = []
        for s in range(split):
            part = [wins[w] for w in K.window_slice(len(wins), split, s)]
            seen += part
            got[:, :, i0:i0 + 128] += _slice_partial(
                digits, wm, acc if split == 1 else None, i0=i0, windows=part,
                N=N, m=m, kp1=kp1, key_shift=key_shift)
        assert seen == wins                     # each window exactly once
        if split > 1:                           # the copy of acc
            got[:, :, i0:i0 + 128] += acc[:, :, i0:i0 + 128].to(torch.int64)
    np.testing.assert_array_equal(T.wrap32(got).numpy(), want.numpy())


@pytest.mark.parametrize("resident,plans", [
    # ck_cmux_step32 at L=4: one 64-row or two 32-row blocks per SM, a tie
    # in warps, so the larger tile
    ({64: 1, 32: 2}, {1: (64, 5), 3: (64, 5), 100: (64, 3), 256: (64, 2),
                      512: (64, 1), 8192: (64, 1)}),
    # at L=3 three 32-row blocks (12 warps) beat one 64-row block (8)
    ({64: 1, 32: 3}, {1: (32, 9), 3: (32, 9), 100: (32, 5), 256: (32, 3),
                      512: (32, 3), 8192: (32, 1)})])
def test_choose_split(resident, plans):
    """The wrapper's plan on 132 SMs for GATE's N=1024, k=1 (9 windows a
    tile): S = 1 at B=8192, whose grid fills the card many times; narrow
    batches cut until their blocks fill the resident slots, within one
    round at B <= 256."""
    def blocks(B):
        return lambda t: 8 * -(-B // t) * 2

    for B, want in plans.items():
        t, S = K.choose_split(blocks(B), resident.get, 132, 9)
        assert (t, S) == want, B
        if B <= 256:
            assert S > 1 and blocks(B)(t) * S <= 132 * resident[t]
    assert K.choose_split(blocks(256), lambda t: 0, 132, 9) == (None, 0)
    # one tile size and a large fixed cost: 64 tiles of 192 steps
    assert K.choose_split(lambda t: 64, lambda t: 1, 132, 192, tiles=(64,),
                          overhead=16) == (64, 2)


# ---------------------------------------------------------------------------
# the fused-epilogue 64-bit step (TFHE_CK64_PATH=acc)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,k,l,bgbit,klimbs,m,tm", [
    (128, 1, 5, 8, 6, 32, 2),        # CB_MXU-shaped (P=1)
    (128, 1, 4, 9, 0, 32, 4)])       # CB_ACTIVE-shaped (P=2)
def test_acc_kernels_plain_match_pallas(N, k, l, bgbit, klimbs, m, tm):
    """rotate_decompose64_ck_flat and ck_dot64p_acc's plain versions, and
    the engine's acc step, against the Pallas kernels (interpret) at
    tests/test_chunked64.py:284-287's shapes."""
    r = np.random.default_rng(9)
    p, tp = _tgsw_pair(l, bgbit, N, k, klimbs, bits=64)
    cfg = jtgsw.engine_config(p)
    B, kp1 = 4, k + 1
    key = r.integers(-2**40, 2**40, (p.kpl, kp1, N)).astype(np.int64)
    acc = _i64(r, (B, kp1 * N))
    a = r.integers(0, 2 * N, (B,)).astype(np.int32)
    wm = jeng.ChunkedEngine(cfg, m=m).prepare(jnp.asarray(key))["wm"]
    pb, P = cfg.plane_split
    lo, hi = i64pair.from_i64(jnp.asarray(acc))
    rot = dict(l=l, bgbit=bgbit, offset=p.offset, m=m, planes=P)
    x = pk.rotate_decompose64_ck_flat(jnp.asarray(a), lo, hi, N=N,
                                      interpret=True, **rot)
    olo, ohi = pk.ck_dot64p_acc(x, wm, lo, hi, N=N, m=m,
                                key_shift=cfg.key_shift, planes=P, tm=tm,
                                kp1=kp1, interpret=True)
    want = i64pair.to_i64(olo, ohi)
    ta, tacc = torch.from_numpy(a), torch.from_numpy(acc)
    tx = K.rotate_decompose64_ck_flat(ta, tacc, N=N, **rot)
    jm = kp1 * l * m
    ckp = K.ck_width(jm)
    np.testing.assert_array_equal(                 # the data columns
        tx.numpy().reshape(B, -1, ckp)[..., :jm],
        np.asarray(x).reshape(B, -1, ckp)[..., :jm])
    twmt = K.ck_wmt(torch.from_numpy(np.array(wm)))
    _same(K.ck_dot64p_acc(tx, twmt, tacc, N=N, m=m, key_shift=cfg.key_shift,
                          planes=P, kp1=kp1, digit_bits=bgbit), want)
    te = engine.ChunkedEngine(tgsw.engine_config(tp), m=m)
    _same(te.cmux_step_acc(ta, tacc, {"wmt": twmt}, kp1=kp1, l=l,
                           bgbit=bgbit, offset=tp.offset), want)
    # the default step computes the same function
    _same(te.cmux_step(ta, tacc.reshape(B, kp1, N), {"wmt": twmt}, l=l,
                       bgbit=bgbit, offset=tp.offset).reshape(B, -1), want)


def test_acc_path_blind_rotation(monkeypatch):
    """A 6-step lvl2 rotation at CB_TOY's gadget: TFHE_CK64_PATH=acc and
    sacc equal the default step and JAX's rotation; acc on a backend
    without the step raises."""
    p, tp = CB_TOY.tgsw_lvl2, T_CB_TOY.tgsw_lvl2
    r = np.random.default_rng(4)
    n, B, N, k = 6, 3, p.tlwe.N, p.tlwe.k
    key = r.integers(-2**50, 2**50, (n, p.kpl, k + 1, N)).astype(np.int64)
    acc = _i64(r, (B, k + 1, N))
    abar = r.integers(0, 2 * N, (B, n)).astype(np.int32)
    jprep = jax.jit(jax.vmap(jtgsw.make_engine(jtgsw.engine_config(p),
                                               "chunked").prepare))
    want = jbr.blind_rotate(jnp.asarray(acc), jprep(jnp.asarray(key)),
                            jnp.asarray(abar), p, "chunked")
    teng = engine.make_engine(tgsw.engine_config(tp), "chunked")
    tprep = teng.prepare(torch.from_numpy(key))
    args = (torch.from_numpy(acc), tprep, torch.from_numpy(abar), tp,
            "chunked")
    default = br.blind_rotate(*args)
    monkeypatch.setenv("TFHE_CK64_PATH", "acc")
    _same(br.blind_rotate(*args), want)
    _same(default, want)
    with pytest.raises(ValueError, match="chunked"):
        br.blind_rotate(torch.from_numpy(acc),
                        {"mat": torch.zeros((n, 1))}, torch.from_numpy(abar),
                        tp, "naive")
    monkeypatch.setenv("TFHE_CK64_PATH", "sacc")
    _same(br.blind_rotate(*args), want)


# ---------------------------------------------------------------------------
# the gate bootstrap on backend="chunked"
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_chunked(case, seed=3):
    """JAX chunked keys from ``seed``, the next draws of its stream after
    keygen, and two encrypted bit vectors."""
    jparams, _ = CASES[case]
    rng = JRng(seed)
    sk = jgate.SecretKey.generate(jparams, rng)
    ck = jgate.CloudKey.generate(sk, rng, backend="chunked")
    after = rng.uniform32((4,))
    bits = np.random.default_rng(seed).integers(0, 2, (2, 8))
    cts = [np.asarray(jgate.encrypt_bool(sk, b, rng)) for b in bits]
    return ck, after, bits, cts


def _port_keys(tparams, backend, seed=3):
    rng = TfheRng(seed)
    sk = gate.SecretKey.generate(tparams, rng)
    ck = gate.CloudKey.generate(sk, rng, backend=backend, device="cpu")
    return sk, ck, rng


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_gate_matches_jax(case):
    """Same seed -> the same keys (wm byte for byte) and stream position;
    a NAND on the port's chunked keys, on converted JAX keys and on the
    port's onthefly keys from the same seed equals JAX's chunked NAND."""
    jparams, tparams = CASES[case]
    jck, after, bits, cts = _jax_chunked(case)
    sk, ck, rng = _port_keys(tparams, "chunked")
    _same(ck.data["bk"]["wm"], jck.data["bk"]["wm"])
    np.testing.assert_array_equal(rng.uniform32((4,)), after)
    jksw = np.asarray(jck.data["ksw"])
    np.testing.assert_array_equal(ck.data["ksw"].numpy()[..., :jksw.shape[-1]],
                                  jksw)
    want = np.asarray(jgate.gate_nand(jck.data, cts[0], cts[1], jparams,
                                      "chunked"))
    x, y = (torch.tensor(c) for c in cts)
    _same(gate.gate_nand(ck.data, x, y, tparams, "chunked"), want)
    conv = convert.cloud_key_from_numpy(
        {"bk": {"wm": np.asarray(jck.data["bk"]["wm"])}, "ksw": jksw},
        tparams, "chunked", device="cpu")
    _same(gate.gate_nand(conv.data, x, y, tparams, "chunked"), want)
    _, otf, _ = _port_keys(tparams, "onthefly")
    _same(gate.gate_nand(otf.data, x, y, tparams, "onthefly"), want)
    assert (gate.decrypt_bool(sk, torch.from_numpy(want))
            == ~(bits[0] & bits[1]).astype(bool)).all()
