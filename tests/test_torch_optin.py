"""The port's opt-in 64-bit steps and the last two test-only kernels against
tfhe_tpu's, bit for bit, on the CPU:

  * the plain versions (what each wrapper runs on CPU tensors) of
    fused_cmux_step (v1), rotate_decompose64, ck_cmux_step64 and
    ck_dot64p_sacc against the Pallas kernels in interpret mode, at the
    cases of tests/test_pallas_kernels.py and tests/test_chunked64.py (the
    JAX side on (lo, hi) int32 pairs through tfhe_tpu.ops.i64pair);
  * the chunked engine's sacc and fused 64-bit steps;
  * a 6-step lvl2 rotation at CB_TOY's gadget under TFHE_CK64_PATH=sacc and
    TFHE_CK64_FUSED=1 against JAX's rotation and the port's default step,
    and the precedence of the two variables (a spy on the engine's steps,
    since plain versions count no launches);
  * a CB_TOY circuit bootstrap under each new step against JAX's TRGSWs
    from the same seed;
  * the wrappers' rejection of what the kernels do not take.

Tolerance 0: every path is exact integer arithmetic mod 2^32 or 2^64.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import lwe as jlwe, tgsw as jtgsw
from tfhe_tpu.boot import blind_rotate as jbr, circuit as jcircuit
from tfhe_tpu.ops import engine as jeng, i64pair
from tfhe_tpu.ops import pallas_kernels as pk
from tfhe_tpu.params import CB_TOY, TGswParams, TLweParams
from tfhe_tpu.rng import TfheRng as JRng
from tfhe_tpu_torch import tgsw
from tfhe_tpu_torch.boot import blind_rotate as br, circuit
from tfhe_tpu_torch.ops import engine, kernels as K
from tfhe_tpu_torch.params import (CB_TOY as T_CB_TOY, TGswParams as TGsw,
                                   TLweParams as TTlwe)
from tfhe_tpu_torch.rng import TfheRng


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These toy shapes are far too small for torch's thread pool, which
    only adds waiting on a machine shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_step_env(monkeypatch):
    for name in ("TFHE_CK64_PATH", "TFHE_CK64_FUSED"):
        monkeypatch.delenv(name, raising=False)


def _same(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _i32(r, shape):
    return r.integers(-2**31, 2**31, shape).astype(np.int32)


def _i64(r, shape):
    return r.integers(-2**63, 2**63, shape, dtype=np.int64)


def _tgsw_pair(l, bgbit, N, k, key_limbs=0, bits=64):
    return (TGswParams(l=l, bgbit=bgbit, key_limbs=key_limbs,
                       tlwe=TLweParams(N=N, k=k, stdev=0.0, bits=bits)),
            TGsw(l=l, bgbit=bgbit, key_limbs=key_limbs,
                 tlwe=TTlwe(N=N, k=k, stdev=0.0, bits=bits)))


# ---------------------------------------------------------------------------
# fused_cmux_step (v1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,k,l,L", [(128, 1, 3, 3), (128, 2, 3, 3)])
def test_fused_cmux_step_v1_matches_pallas(N, k, l, L):
    """tests/test_pallas_kernels.py:110's v1 cases: the port's v1 equals the
    Pallas v1 (interpret) and the port's v2 on the same inputs."""
    p, _ = _tgsw_pair(l, 7, N, k, bits=32)
    key_shift = 32 - 8 * L
    r = np.random.default_rng(3)
    B, J = 8, (k + 1) * l
    acc = _i32(r, (B, k + 1, N))
    a = r.integers(0, 2 * N, (B,)).astype(np.int32)
    a[:3] = [0, N, 2 * N - 1]
    w = r.integers(-128, 128, (L, J * N, (k + 1) * N)).astype(np.int8)
    kw = dict(l=l, bgbit=p.bgbit, offset=p.offset, key_shift=key_shift)
    want = pk.fused_cmux_step(jnp.asarray(a), jnp.asarray(acc), jnp.asarray(w),
                              tm=B, interpret=True, **kw)
    ta, tacc, tw = (torch.from_numpy(v) for v in (a, acc, w))
    _same(K.fused_cmux_step(ta, tacc, tw, **kw), want)
    _same(K.fused_cmux_step_v2(ta, tacc, tw.transpose(1, 2).contiguous(),
                               **kw), want)


# ---------------------------------------------------------------------------
# rotate_decompose64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,k,l,bgbit", [(128, 1, 4, 9), (128, 1, 5, 8),
                                         (256, 2, 4, 9)])
def test_rotate_decompose64_matches_pallas(N, k, l, bgbit):
    """tests/test_chunked64.py:81's cases; re-laid out with ck_layout, the
    digits are rotate_decompose64_ck's (m = 64)."""
    p, tp = _tgsw_pair(l, bgbit, N, k)
    r = np.random.default_rng(1)
    B, m = 4, 64
    acc = _i64(r, (B, k + 1, N))
    acc.reshape(-1)[:3] = [-2**63, 2**63 - 1, 0]
    a = r.integers(0, 2 * N, (B,)).astype(np.int32)
    a[0] = N
    P = 2 if bgbit > 8 else 1
    lo, hi = i64pair.from_i64(jnp.asarray(acc))
    want = pk.rotate_decompose64(jnp.asarray(a), lo, hi, l=l, bgbit=bgbit,
                                 offset=p.offset, planes=P, tb=B * (k + 1),
                                 interpret=True)
    ta, tacc = torch.from_numpy(a), torch.from_numpy(acc)
    got = K.rotate_decompose64(ta, tacc, l=l, bgbit=bgbit, offset=tp.offset,
                               planes=P)
    _same(got, want)
    planes = got.reshape(B, k + 1, l, P, N).permute(3, 0, 1, 2, 4)
    assert torch.equal(
        K.ck_layout(planes.reshape(P, B, (k + 1) * l, N), m),
        K.rotate_decompose64_ck(ta, tacc, l=l, bgbit=bgbit, offset=tp.offset,
                                m=m, planes=P))


# ---------------------------------------------------------------------------
# ck_cmux_step64 and ck_dot64p_sacc
# ---------------------------------------------------------------------------

def _step64_inputs(N, k, l, bgbit, klimbs, m, seed):
    p, tp = _tgsw_pair(l, bgbit, N, k, klimbs)
    cfg = jtgsw.engine_config(p)
    r = np.random.default_rng(seed)
    B = 4
    key = r.integers(-2**40, 2**40, (p.kpl, k + 1, N)).astype(np.int64)
    acc = _i64(r, (B, (k + 1) * N))
    a = r.integers(0, 2 * N, (B,)).astype(np.int32)
    a[:2] = [N, 2 * N - 1]
    wm = jeng.ChunkedEngine(cfg, m=m).prepare(jnp.asarray(key))["wm"]
    return p, tp, cfg, acc, a, wm


@pytest.mark.parametrize("N,k,l,bgbit,klimbs,m,tm", [
    (128, 1, 2, 9, 3, 64, 2),      # plane-split digits (P=2)
    (128, 1, 3, 8, 0, 64, 2),      # single plane, 8 limbs
    (256, 1, 2, 8, 6, 64, 4)])     # CB_MXU-like 6-limb key
def test_ck_cmux_step64_matches_pallas(N, k, l, bgbit, klimbs, m, tm):
    """tests/test_chunked64.py:251's cases: the wrapper (its plain version)
    and the chunked engine's flat 64-bit step against the Pallas kernel
    (interpret) on the flat pair carry."""
    p, tp, cfg, acc, a, wm = _step64_inputs(N, k, l, bgbit, klimbs, m, 8)
    pb, P = cfg.plane_split
    lo, hi = i64pair.from_i64(jnp.asarray(acc))
    olo, ohi = pk.ck_cmux_step64(jnp.asarray(a), lo, hi, wm, l=l,
                                 bgbit=bgbit, offset=p.offset,
                                 key_shift=cfg.key_shift, m=m, planes=P,
                                 tm=tm, kp1=k + 1, interpret=True)
    want = i64pair.to_i64(olo, ohi)
    ta, tacc = torch.from_numpy(a), torch.from_numpy(acc)
    twmt = K.ck_wmt(torch.from_numpy(np.array(wm)))
    _same(K.ck_cmux_step64(ta, tacc, twmt, l=l, bgbit=bgbit,
                           offset=tp.offset, m=m, key_shift=cfg.key_shift,
                           planes=P, kp1=k + 1), want)
    te = engine.ChunkedEngine(tgsw.engine_config(tp), m=m)
    _same(te.cmux_step_flat(ta, tacc, {"wmt": twmt}, kp1=k + 1, l=l,
                            bgbit=bgbit, offset=tp.offset), want)


@pytest.mark.parametrize("N,k,l,bgbit,klimbs,m,tm", [
    (128, 1, 5, 8, 6, 32, 2),        # CB_MXU-shaped (P=1)
    (128, 1, 4, 9, 0, 32, 4)])       # CB_ACTIVE-shaped (P=2)
def test_ck_dot64p_sacc_matches_pallas(N, k, l, bgbit, klimbs, m, tm):
    """tests/test_chunked64.py:284's cases: ck_dot64p_sacc (its plain
    version) and the engine's sacc step against the Pallas kernel
    (interpret) on the Pallas flat rotate's digits."""
    p, tp, cfg, acc, a, wm = _step64_inputs(N, k, l, bgbit, klimbs, m, 9)
    pb, P = cfg.plane_split
    lo, hi = i64pair.from_i64(jnp.asarray(acc))
    x = pk.rotate_decompose64_ck_flat(jnp.asarray(a), lo, hi, N=N, l=l,
                                      bgbit=bgbit, offset=p.offset, m=m,
                                      planes=P, interpret=True)
    slo, shi = pk.ck_dot64p_sacc(x, wm, lo, hi, N=N, m=m,
                                 key_shift=cfg.key_shift, planes=P, tm=tm,
                                 kp1=k + 1, interpret=True)
    want = i64pair.to_i64(slo, shi)
    ta, tacc = torch.from_numpy(a), torch.from_numpy(acc)
    twmt = K.ck_wmt(torch.from_numpy(np.array(wm)))
    tx = K.rotate_decompose64_ck_flat(ta, tacc, N=N, l=l, bgbit=bgbit,
                                      offset=tp.offset, m=m, planes=P)
    _same(K.ck_dot64p_sacc(tx, twmt, tacc, N=N, m=m, key_shift=cfg.key_shift,
                           planes=P, kp1=k + 1, digit_bits=bgbit), want)
    te = engine.ChunkedEngine(tgsw.engine_config(tp), m=m)
    _same(te.cmux_step_sacc(ta, tacc, {"wmt": twmt}, kp1=k + 1, l=l,
                            bgbit=bgbit, offset=tp.offset), want)


def _step64_slice(x, wmt, *, i0, windows, N, m, P, kp1, key_shift):
    """A Python mirror of one ck_cmux_step64 block's slice over every limb:
    for the folded columns [i0, i0+64), each limb row g's signed sum of its
    ``windows`` (chunk, sign) products over every plane (<< 7p), widened
    and shifted by 8 (g mod L) + key_shift into polynomial g div L (mod
    2^64); and the largest |fold| of a limb row.  Key rows outside [0,
    N+m) read as zero."""
    B = x.shape[0]
    UL, Npm, Jm = wmt.shape
    L = UL // kp1
    xr = x.reshape(B, N // m, P, -1)[..., :Jm].to(torch.float64)
    wpad = torch.nn.functional.pad(wmt.transpose(1, 2).to(torch.float64),
                                   (N, N))
    cols = torch.arange(i0, i0 + 64)
    out = torch.zeros((B, kp1, 64), dtype=torch.int64)
    worst = 0
    for g in range(UL):
        fold = torch.zeros((B, 64), dtype=torch.int64)
        for p in range(P):
            for c, sign in windows:
                q = (0 if sign > 0 else N) + cols - c * m
                fold += sign * ((xr[:, c, p] @ wpad[g][:, q + N])
                                .to(torch.int64) << (7 * p))
        worst = max(worst, int(fold.abs().max()))
        u, lm = divmod(g, L)
        if 8 * lm + key_shift < 64:
            out[:, u] += fold << (8 * lm + key_shift)
    return out, worst


@pytest.mark.parametrize("N,m,L,P,split", [
    (128, 64, 6, 1, 1), (128, 64, 6, 1, 2), (128, 64, 3, 2, 3),
    (128, 32, 5, 1, 4), (128, 32, 4, 2, 6)])
def test_ck_cmux_step64_window_partition(N, m, L, P, split):
    """The kernel's window split (ck_windows over 64-column tiles,
    window_slice, every slice running its windows for every plane): each
    window of each tile falls in exactly one slice, each slice's limb folds
    stay inside int32 (so they widen exactly), and the slices' sums added
    onto acc mod 2^64, as the atomics do, give ck_cmux_step64_plain bit for
    bit."""
    r = np.random.default_rng(21)
    B, kp1, l = 3, 2, 2
    bgbit = 8 if P == 1 else 9
    acc = torch.from_numpy(_i64(r, (B, kp1 * N)))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    a[0] = N
    wmt = torch.from_numpy(r.integers(-128, 128, (kp1 * L, N + m, kp1 * l * m))
                           .astype(np.int8))
    kw = dict(l=l, bgbit=bgbit, offset=0x8040201008040201, m=m, planes=P)
    key_shift = max(0, 64 - 8 * L)
    x = K.rotate_decompose64_ck_flat_plain(a, acc, N=N, **kw)
    want = K.ck_cmux_step64_plain(a, acc, wmt, key_shift=key_shift, kp1=kp1,
                                  **kw)
    got = acc.reshape(B, kp1, N).clone()
    for i0 in range(0, N, 64):
        wins = K.ck_windows(i0, N, m, 64)
        assert len(wins) <= K.ck_work(N, m, 64)
        seen = []
        for s in range(split):
            part = [wins[w] for w in K.window_slice(len(wins), split, s)]
            seen += part
            y, worst = _step64_slice(x, wmt, i0=i0, windows=part, N=N, m=m,
                                     P=P, kp1=kp1, key_shift=key_shift)
            assert worst < 2**31
            got[:, :, i0:i0 + 64] += y
        assert seen == wins                     # each window exactly once
    assert torch.equal(got.reshape(B, -1), want)


# ---------------------------------------------------------------------------
# the lvl2 rotation and the precedence of the two variables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rotation_case():
    """A 6-step lvl2 rotation at CB_TOY's gadget: JAX's result, the port's
    arguments and the port's default result."""
    p, tp = CB_TOY.tgsw_lvl2, T_CB_TOY.tgsw_lvl2
    r = np.random.default_rng(4)
    n, B, N, k = 6, 3, p.tlwe.N, p.tlwe.k
    key = r.integers(-2**50, 2**50, (n, p.kpl, k + 1, N)).astype(np.int64)
    acc = _i64(r, (B, k + 1, N))
    abar = r.integers(0, 2 * N, (B, n)).astype(np.int32)
    jprep = jax.jit(jax.vmap(jtgsw.make_engine(jtgsw.engine_config(p),
                                               "chunked").prepare))
    want = np.asarray(jbr.blind_rotate(jnp.asarray(acc),
                                       jprep(jnp.asarray(key)),
                                       jnp.asarray(abar), p, "chunked"))
    teng = engine.make_engine(tgsw.engine_config(tp), "chunked")
    args = (torch.from_numpy(acc), teng.prepare(torch.from_numpy(key)),
            torch.from_numpy(abar), tp, "chunked")
    return want, args, br.blind_rotate(*args)


@pytest.mark.parametrize("var,value", [("TFHE_CK64_PATH", "sacc"),
                                       ("TFHE_CK64_FUSED", "1")])
def test_opt_in_rotation_matches_jax(monkeypatch, var, value):
    want, args, default = _rotation_case()
    _same(default, want)
    monkeypatch.setenv(var, value)
    _same(br.blind_rotate(*args), want)


def _spy(monkeypatch):
    """Count the calls of the chunked engine's four 64-bit steps."""
    calls = {}
    for name in ("cmux_step", "cmux_step_acc", "cmux_step_sacc",
                 "cmux_step_flat"):
        real = getattr(engine.ChunkedEngine, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(self, *a, **kw)
        monkeypatch.setattr(engine.ChunkedEngine, name, spy)
    return calls


@pytest.mark.parametrize("path,fused,taken", [
    ("", "", "cmux_step"), ("", "0", "cmux_step"),
    ("", "1", "cmux_step_flat"), ("acc", "1", "cmux_step_acc"),
    ("sacc", "1", "cmux_step_sacc"), ("sacc", "", "cmux_step_sacc")])
def test_step_precedence(monkeypatch, path, fused, taken):
    """TFHE_CK64_PATH before TFHE_CK64_FUSED before the default step, as in
    tfhe_tpu/boot/blind_rotate.py: exactly one step method runs, once per
    step, and the result is JAX's."""
    want, args, _ = _rotation_case()
    calls = _spy(monkeypatch)
    monkeypatch.setenv("TFHE_CK64_PATH", path)
    monkeypatch.setenv("TFHE_CK64_FUSED", fused)
    _same(br.blind_rotate(*args), want)
    assert calls == {taken: args[2].shape[1]}


def test_selected_step_never_falls_back(monkeypatch):
    """A selected step that does not apply raises; so does one selected on
    a backend without it, or an unknown TFHE_CK64_PATH."""
    _, args, _ = _rotation_case()
    acc, prep, abar, tp, _ = args
    monkeypatch.setenv("TFHE_CK64_FUSED", "1")
    with pytest.raises(ValueError, match="TFHE_CK64_FUSED.*chunked"):
        br.blind_rotate(acc, {"mat": torch.zeros((abar.shape[1], 1))}, abar,
                        tp, "naive")
    monkeypatch.setattr(engine.ChunkedEngine, "cmux_step_flat",
                        lambda self, *a, **kw: None)
    with pytest.raises(ValueError, match="fused step does not apply"):
        br.blind_rotate(*args)
    monkeypatch.setenv("TFHE_CK64_PATH", "sacc")
    monkeypatch.setattr(engine.ChunkedEngine, "cmux_step_sacc",
                        lambda self, *a, **kw: None)
    with pytest.raises(ValueError, match="sacc step does not apply"):
        br.blind_rotate(*args)
    monkeypatch.setenv("TFHE_CK64_PATH", "fused")
    with pytest.raises(ValueError, match="unknown TFHE_CK64_PATH"):
        br.blind_rotate(*args)


# ---------------------------------------------------------------------------
# the CB_TOY circuit bootstrap on each new step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cb_toy(seed=42):
    """JAX's CB_TOY TRGSWs of four bits and the port's keys and input from
    the same seed."""
    jrng, rng = JRng(seed), TfheRng(seed)
    jsk = jcircuit.CircuitSecretKey.generate(CB_TOY, jrng)
    jck = jcircuit.CircuitCloudKey.generate(jsk, jrng, backend="chunked")
    sk = circuit.CircuitSecretKey.generate(T_CB_TOY, rng)
    ck = circuit.CircuitCloudKey.generate(sk, rng, backend="chunked",
                                          device="cpu")
    msgs = np.where(np.array([0, 1, 1, 0], bool), -(1 << 31), 0)
    ct = np.array(jlwe.encrypt(jsk.lwe_lvl1, msgs.astype(np.int32), JRng(5),
                               2.0**-20))
    want = np.asarray(jcircuit.circuit_bootstrap(jnp.asarray(ct), jck.data,
                                                 CB_TOY, backend="chunked"))
    return want, ck, torch.from_numpy(ct)


@pytest.mark.parametrize("var,value", [("TFHE_CK64_PATH", "sacc"),
                                       ("TFHE_CK64_FUSED", "1")])
def test_cb_toy_circuit_bootstrap_matches_jax(monkeypatch, var, value):
    want, ck, ct = _cb_toy()
    calls = _spy(monkeypatch)
    monkeypatch.setenv(var, value)
    _same(circuit.circuit_bootstrap(ct, ck.data, T_CB_TOY), want)
    taken = "cmux_step_sacc" if var == "TFHE_CK64_PATH" else "cmux_step_flat"
    assert set(calls) == {taken} and calls[taken] > 0


# ---------------------------------------------------------------------------
# what the wrappers reject
# ---------------------------------------------------------------------------

def test_wrappers_reject_what_the_kernels_do_not_take():
    N, kp1, l, m = 128, 2, 2, 64
    a = torch.zeros(2, dtype=torch.int32)
    acc32 = torch.zeros((2, kp1, N), dtype=torch.int32)
    w = torch.zeros((3, kp1 * l * N, kp1 * N), dtype=torch.int8)
    v1 = dict(l=l, bgbit=7, offset=0)
    with pytest.raises(ValueError, match="exactly 3 key limbs"):
        K.fused_cmux_step(a, acc32, w[:2], **v1)
    with pytest.raises(ValueError, match="int32"):
        K.fused_cmux_step(a, acc32.to(torch.int64), w, **v1)
    with pytest.raises(ValueError, match="3-D"):
        K.fused_cmux_step(a, acc32.reshape(2, -1), w, **v1)
    with pytest.raises(ValueError, match="w must be"):
        K.fused_cmux_step(a, acc32, w[:, :-1].contiguous(), **v1)

    acc64 = torch.zeros((2, kp1, N), dtype=torch.int64)
    for planes in (0, 3):
        with pytest.raises(ValueError, match="planes 1 or 2"):
            K.rotate_decompose64(a, acc64, l=4, bgbit=9, offset=0,
                                 planes=planes)
    with pytest.raises(ValueError, match="int64"):
        K.rotate_decompose64(a, acc64.to(torch.int32), l=4, bgbit=9,
                             offset=0, planes=2)
    with pytest.raises(ValueError, match="digits must fit"):
        K.rotate_decompose64(a, acc64, l=4, bgbit=9, offset=0, planes=1)

    L = 3
    wmt = torch.zeros((kp1 * L, N + m, kp1 * l * m), dtype=torch.int8)
    flat = acc64.reshape(2, -1)
    step = dict(l=l, bgbit=8, offset=0, m=m, key_shift=40, kp1=kp1)
    for planes in (0, 3):
        with pytest.raises(ValueError, match="planes 1 or 2"):
            K.ck_cmux_step64(a, flat, wmt, planes=planes, **step)
    with pytest.raises(ValueError, match="2-D"):
        K.ck_cmux_step64(a, acc64, wmt, planes=1, **step)
    with pytest.raises(ValueError, match="acc must be"):
        K.ck_cmux_step64(a, flat[:, :-N].contiguous(), wmt, planes=1, **step)
    with pytest.raises(ValueError, match="acc must be"):    # wm, not wmt
        K.ck_cmux_step64(a, flat, wmt.transpose(1, 2).contiguous(), planes=1,
                         **step)

    x = torch.zeros((2, (N // m) * K.ck_width(kp1 * l * m)), dtype=torch.int8)
    dot = dict(N=N, m=m, key_shift=40, kp1=kp1)
    for planes in (0, 3):
        with pytest.raises(ValueError, match="planes must be 1 or 2"):
            K.ck_dot64p_sacc(x, wmt, flat, planes=planes, **dot)
    with pytest.raises(ValueError, match="x must be"):
        K.ck_dot64p_sacc(x[:, :-1].contiguous(), wmt, flat, **dot)
    with pytest.raises(ValueError, match="int64"):
        K.ck_dot64p_sacc(x, wmt, flat.to(torch.int32), **dot)
    with pytest.raises(ValueError, match="int32 accumulation bound"):
        K.ck_dot64p_sacc(x, wmt, flat, digit_bits=30, **dot)
    with pytest.raises(ValueError, match="wmt must be"):    # wm, not wmt
        K.ck_dot64p_sacc(x, wmt.transpose(1, 2).contiguous(), flat, **dot)
