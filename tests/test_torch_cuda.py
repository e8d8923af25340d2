"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where no GPU is present.  On a machine with one:

    python -m pytest -m cuda tests/test_torch_cuda.py

Small and ragged shapes (batches that do not fill a 64-row tile, every limb
count, both key shifts, one and two digit planes), plus GATE_TOY
bootstraps (on the onthefly, matmul, conv, conv_bf16 and nussbaumer
engines) and CB_TOY circuit bootstraps (on each of the four 64-bit steps,
and on conv) that must give the same ciphertexts on the card as on the
CPU; the conv, Nussbaumer and FFT engines at gate and lvl2 shapes; and the
two CB_ACTIVE reference rotations (tests/test_torch_reference.py).
Imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch import lwe
from tfhe_tpu_torch.boot import circuit, gate
from tfhe_tpu_torch.ops import kernels as K
from tfhe_tpu_torch.params import CB_TOY, GATE_TOY
from tfhe_tpu_torch.rng import TfheRng

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _i32(r, shape):
    return torch.from_numpy(r.integers(-2**31, 2**31, shape).astype(np.int32))


def _i8(r, shape, lo=-128, hi=128):
    return torch.from_numpy(r.integers(lo, hi, shape).astype(np.int8))


def _same_on_card(fn, plain, args, kw, cuda):
    got = fn(*(t.to(cuda) for t in args), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), plain(*args, **kw))


# every path's key (GATE_FAST2, GATE_MXU, GATE_DEFAULT) and small ones: N =
# 16 (a run is one 16-byte word), 32, 64; one column block (U = 1) and one
# digit row (J = 1)
_MATW_SHAPES = [(3, 9, 3, 512), (3, 6, 2, 1024), (4, 6, 2, 1024),
                (1, 2, 1, 16), (2, 3, 2, 32), (2, 1, 3, 64), (3, 4, 1, 64),
                (1, 1, 1, 128)]


def _poisoned(shape, cuda):
    """The address of a caching-allocator block of ``shape`` int8 just
    filled with -1 bytes and freed: the next torch.empty of that size
    returns it, so a byte the kernel leaves unwritten stays -1."""
    poison = torch.full(shape, -1, dtype=torch.int8, device=cuda)
    ptr = poison.data_ptr()
    torch.cuda.synchronize()
    del poison
    return ptr


def _materialize_case(cuda, wrapper, plain, shape, seed):
    L, J, U, N = shape
    v = _i8(np.random.default_rng(seed), (L, J, U, 2 * N))
    want, dv = plain(v), v.to(cuda)
    ptr = _poisoned(want.shape, cuda)
    got = wrapper(dv)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr               # the poisoned block
    assert torch.equal(got.cpu(), want)
    return v


@pytest.mark.parametrize("L,J,U,N", _MATW_SHAPES)
def test_materialize_w(cuda, L, J, U, N):
    """W at every path's key and small ones, into a poisoned output."""
    _materialize_case(cuda, K.materialize_w, K.materialize_w_plain,
                      (L, J, U, N), 0)


@pytest.mark.parametrize("L,J,U,N", _MATW_SHAPES + [(6, 10, 2, 2048)])
def test_materialize_wt(cuda, L, J, U, N):
    """The K-packed key at every path's key (CB_MXU's lvl2 key too, which
    the conv engine materializes) and small ones, into a poisoned output;
    equal to materialize_w's kernel transposed."""
    v = _materialize_case(cuda, K.materialize_wt, K.materialize_wt_plain,
                          (L, J, U, N), 14)
    dv = v.to(cuda)
    assert torch.equal(K.materialize_wt(dv),
                       K.materialize_w(dv).transpose(1, 2).contiguous())


@pytest.mark.parametrize("name", ["materialize_w", "materialize_wt"])
@pytest.mark.parametrize("L,J,U,N,rows,cols,threads", [
    (3, 9, 3, 512, 512, 512, 256), (3, 9, 3, 512, 16, 512, 256),
    (3, 9, 3, 512, 64, 128, 96), (4, 6, 2, 1024, 256, 256, 32),
    (2, 3, 2, 64, 16, 16, 32), (1, 2, 1, 16, 16, 16, 64),
    (2, 1, 1, 2048, 32, 64, 128)])
def test_materialize_forced_plans(cuda, name, L, J, U, N, rows, cols,
                                  threads):
    """Forced (rows, cols, threads) plans through the raw entry: whole
    vectors, 16-row bands, column bands (cols < N, the plan of N > 4096),
    fewer threads than a block's words and more; every byte written."""
    v = _i8(np.random.default_rng(16), (L, J, U, 2 * N))
    wt = name == "materialize_wt"
    want = (K.materialize_wt_plain if wt else K.materialize_w_plain)(v)
    dv = v.to(cuda)
    ptr = _poisoned(want.shape, cuda)
    got = torch.empty(want.shape, dtype=torch.int8, device=cuda)
    assert got.data_ptr() == ptr
    K._launch(name, dv.data_ptr(), got.data_ptr(), L, J, U, N, rows, cols,
              threads)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _rotate_decompose_plan(a, acc, *, l, bgbit, offset, plan):
    """rotate_decompose's kernel at a forced (rows, split, threads) plan,
    through its raw entry."""
    B, kp1, N = acc.shape
    out = torch.empty((B, kp1 * l, N), dtype=torch.int8, device=acc.device)
    K._launch("rotate_decompose", a.data_ptr(), acc.data_ptr(),
              out.data_ptr(), B, kp1, N, l, bgbit, offset & 0xFFFFFFFF, *plan)
    return out


def _forced_rotdec_plans(chosen):
    """Forced emitter plans beside the chosen one: one row at splits 1, 2
    and 7 (a ragged slice), and two and four rows a block (a ragged last
    block where B is odd)."""
    threads = chosen[2]
    return [(1, 1, threads), (1, 2, threads), (1, 7, threads),
            (2, 1, threads), (4, 1, min(threads, 128)), (1, 3, 32)]


@pytest.mark.parametrize("B,k,N,l,bgbit", [
    (1, 1, 1024, 3, 7), (3, 1, 1024, 3, 7), (100, 1, 1024, 3, 7),
    (256, 1, 1024, 3, 7), (5, 1, 64, 3, 7), (33, 2, 512, 3, 7),
    (16, 1, 1024, 2, 8), (300, 1, 64, 3, 7)])
def test_rotate_decompose(cuda, B, k, N, l, bgbit):
    """GATE_DEFAULT's shape at B = 1, 3, 100, 256, GATE_TOY's N = 64 and
    GATE_FAST2-shaped k = 2; the chosen plan and forced ones, bit for
    bit."""
    r = np.random.default_rng(1)
    acc = _i32(r, (B, k + 1, N))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    a[0] = N
    kw = dict(l=l, bgbit=bgbit, offset=0x81020400)
    _same_on_card(K.rotate_decompose, K.rotate_decompose_plain, (a, acc), kw,
                  cuda)
    want = K.rotate_decompose_plain(a, acc, **kw)
    da, dacc = a.to(cuda), acc.to(cuda)
    chosen = K.rotdec_plan(B, k + 1, N, 4, K.sm_count(cuda))
    for plan in _forced_rotdec_plans(chosen):
        got = _rotate_decompose_plan(da, dacc, plan=plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), plan


_PLAIN: dict = {}


def _plain_once(key, plain, args, kw):
    """The plain version's output for one parametrised case, computed once
    for all its forced splits."""
    if key not in _PLAIN:
        _PLAIN[key] = plain(*args, **kw)
    return _PLAIN[key]


@pytest.mark.parametrize("split", [1, 2, 3, 0])
@pytest.mark.parametrize("B", [1, 3, 70, 100, 256, 512])
@pytest.mark.parametrize("L,shift", [(1, 24), (2, 16), (3, 8), (4, 0)])
def test_mm_recombine_acc(cuda, B, L, shift, split):
    """Every forced K split and the chosen one; K = 25 steps of 32, so
    slices of 13 and 12 (S = 2) and 9, 9, 7 (S = 3) are ragged."""
    r = np.random.default_rng(2)
    K_, UN = 25 * 32, 2 * 128
    args = (_i8(r, (B, K_), -64, 65), _i8(r, (L, K_, UN)), _i32(r, (B, UN)))
    kw = {"shift_base": shift}
    want = _plain_once(("mm", B, L, shift), K.mm_recombine_acc_plain, args,
                       kw)
    got = K.mm_recombine_acc(*(t.to(cuda) for t in args), split=split, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("B", [1, 3, 64, 65, 100, 8191, 8192])
@pytest.mark.parametrize("L,key_shift", [(1, 0), (1, 8), (2, 0), (2, 8),
                                         (3, 0), (3, 8)])
@pytest.mark.parametrize("k,N", [(2, 512), (1, 1024)])
def test_fused_cmux_step_v2(cuda, B, k, N, L, key_shift):
    """GATE_FAST2's and GATE_MXU's rings, every limb count, both key
    shifts, batches that fill no tile, one row tile and two, a ragged one
    and the main path's; every forced plan and the chosen one, the 3-D and
    the flat carry.  The plain version runs on the card (its float64 sums
    are exact there)."""
    r = np.random.default_rng(3)
    l = 3
    acc = _i32(r, (B, k + 1, N)).to(cuda)
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32)).to(cuda)
    a[0] = N                                   # a pure sign flip
    wt = _i8(r, (L, (k + 1) * N, (k + 1) * l * N)).to(cuda)
    kw = dict(l=l, bgbit=7, offset=0x81020400, key_shift=key_shift)
    want = K.fused_cmux_step_v2_plain(a, acc, wt, **kw)
    for tile in (0, *K.FUSED_COLS):
        got = K.fused_cmux_step_v2(a, acc, wt, tile_cols=tile, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile
    flat = K.fused_cmux_step_v2(a, acc.reshape(B, -1), wt, kp1=k + 1, **kw)
    torch.cuda.synchronize()
    assert torch.equal(flat, want.reshape(B, -1))


@pytest.mark.parametrize("tile_cols", K.FUSED_COLS)
@pytest.mark.parametrize("B", [3, 100, 130, 800])
def test_fused_cmux_step_v2_each_tile(cuda, B, tile_cols):
    """Small rings (k=1, N=128 and 256; l=2 and 3) on each tile, against
    the plain version on the CPU."""
    r = np.random.default_rng(4)
    for k, N, l, L in ((1, 128, 3, 3), (1, 256, 2, 2)):
        acc = _i32(r, (B, k + 1, N))
        a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
        wt = _i8(r, (L, (k + 1) * N, (k + 1) * l * N))
        kw = dict(l=l, bgbit=7, offset=0x81020400, key_shift=8)
        got = K.fused_cmux_step_v2(a.to(cuda), acc.to(cuda), wt.to(cuda),
                                   tile_cols=tile_cols, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(),
                           K.fused_cmux_step_v2_plain(a, acc, wt, **kw))


@pytest.mark.parametrize("k,N", [(2, 512), (1, 1024)])
def test_fused_step_on_materialize_wt(cuda, k, N):
    """The main path's step as a whole on the card: materialize_wt's key
    into fused_cmux_step_v2, against materialize_w + the plain step."""
    r = np.random.default_rng(15)
    B, l, L = 300, 3, 3
    v = _i8(r, (L, (k + 1) * l, k + 1, 2 * N)).to(cuda)
    acc = _i32(r, (B, k + 1, N)).to(cuda)
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32)).to(cuda)
    kw = dict(l=l, bgbit=7, offset=0x81020400, key_shift=8)
    got = K.fused_cmux_step_v2(a, acc, K.materialize_wt(v), **kw)
    want = K.fused_cmux_step_plain(a, acc, K.materialize_w(v), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("B", [3, 300])
@pytest.mark.parametrize("L", [2, 3])
@pytest.mark.parametrize("k,N", [(2, 512), (1, 1024)])
def test_fused_cmux_step_v2_four_levels(cuda, B, k, N, L):
    """l = 4: at L = 3 the 128-column ring holds no group, so the chosen
    plan is 64 columns and a forced 128 raises; at L = 2 both run."""
    r = np.random.default_rng(16)
    l = 4
    acc = _i32(r, (B, k + 1, N)).to(cuda)
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32)).to(cuda)
    wt = _i8(r, (L, (k + 1) * N, (k + 1) * l * N)).to(cuda)
    kw = dict(l=l, bgbit=7, offset=0x81020408, key_shift=8)
    want = K.fused_cmux_step_v2_plain(a, acc, wt, **kw)
    for tile in (0, *K.FUSED_COLS):
        if K.fused_cmux_step_v2_plan(N, l, L, tile) == 0:
            assert (L, tile) == (3, 128)
            with pytest.raises(ValueError, match="plan"):
                K.fused_cmux_step_v2(a, acc, wt, tile_cols=tile, **kw)
            continue
        got = K.fused_cmux_step_v2(a, acc, wt, tile_cols=tile, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile


@pytest.mark.parametrize("N,l,fused", [(512, 4, True), (64, 3, False)])
def test_engine_routes_by_the_fused_kernels_domain(cuda, N, l, fused):
    """On the card the onthefly engine takes the fused step only where its
    kernel runs (l = 4 at N = 512 on the 64-column plan); at N = 64 it
    returns None for the generic step instead of raising."""
    from tfhe_tpu_torch.ops import engine
    r = np.random.default_rng(17)
    te = engine.make_engine(engine.EngineConfig(N=N, out_bits=32,
                                                digit_bits=7, key_limbs=3),
                            "onthefly")
    prep = te.prepare(_i32(r, (3 * l, 3, N)).to(cuda))
    acc = _i32(r, (100, 3, N)).to(cuda)
    a = torch.from_numpy(r.integers(0, 2 * N, (100,)).astype(np.int32)).to(
        cuda)
    kw = dict(l=l, bgbit=7, offset=0x81020408)
    before = K.fused_cmux_step_v2.launches
    got = te.cmux_step(a, acc, prep, **kw)
    assert (got is not None) is fused
    assert K.fused_cmux_step_v2.launches == before + fused
    if fused:
        cpu = {name: t.cpu() for name, t in prep.items()}
        want = te.cmux_step(a.cpu(), acc.cpu(), cpu, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


def test_fused_cmux_step_v2_unsupported_shape_raises(cuda):
    """N = 64 is below the kernel's 128-byte K slice: the wrapper raises
    instead of running the plain version on the card."""
    a = torch.zeros(2, dtype=torch.int32, device=cuda)
    acc = torch.zeros((2, 2, 64), dtype=torch.int32, device=cuda)
    wt = torch.zeros((3, 2 * 64, 2 * 3 * 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="kernel"):
        K.fused_cmux_step_v2(a, acc, wt, l=3, bgbit=7, offset=0)


def test_unsupported_shape_raises_instead_of_falling_back(cuda):
    x = torch.zeros((8, 64), dtype=torch.int8, device=cuda)
    w = torch.zeros((1, 64, 64), dtype=torch.int8, device=cuda)
    acc = torch.zeros((8, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="kernel"):
        K.mm_recombine_acc(x, w, acc)
    with pytest.raises(ValueError, match="kernel"):
        K.mm_recombine_acc(x, w, acc, split=2)
    with pytest.raises(ValueError, match="split"):
        K.mm_recombine_acc(x, w, acc, split=-1)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        K.mm_recombine_acc(x.cpu(), w, acc)


@pytest.mark.parametrize("backend", ["onthefly", "matmul", "conv",
                                     "conv_bf16", "nussbaumer"])
def test_toy_bootstrap_same_on_card_and_cpu(cuda, backend):
    outs = {}
    for dev in ("cpu", cuda):
        rng = TfheRng(5)
        sk = gate.SecretKey.generate(GATE_TOY, rng)
        ck = gate.CloudKey.generate(sk, rng, backend=backend, device=dev)
        ct = gate.encrypt_bool(sk, [0, 1, 1, 0, 1], rng, device=dev)
        outs[str(dev)] = gate.gate_nand(ck.data, ct, ct, GATE_TOY,
                                        backend).cpu()
    assert torch.equal(outs["cpu"], outs["cuda"])
    assert (gate.decrypt_bool(sk, outs["cpu"])
            == ~np.array([0, 1, 1, 0, 1], bool)).all()


def _i64(r, shape):
    return torch.from_numpy(r.integers(-2**63, 2**63, shape, dtype=np.int64))


def _rotate_decompose64_ck_plan(a, acc, *, l, bgbit, offset, m, planes,
                                plan):
    """rotate_decompose64_ck's kernel at a forced (rows, split, threads)
    plan, through its raw entry."""
    B, kp1, N = acc.shape
    ckp = K.ck_width(kp1 * l * m)
    out = torch.empty((B, (N // m) * planes * ckp), dtype=torch.int8,
                      device=acc.device)
    K._launch("rotate_decompose64_ck", a.data_ptr(), acc.data_ptr(),
              out.data_ptr(), B, kp1, N, l, bgbit, offset & ((1 << 64) - 1),
              m, planes, ckp, *plan)
    return out


def _cb_offset(l, bgbit):
    return sum(1 << (63 - i * bgbit) for i in range(l + 1)) % 2**64


# the 64-bit emitter's cases (B, k, N, l, bgbit, m): CB_MXU at the steps'
# batches (256, and the narrow 1, 3, 100), CB_ACTIVE (two planes), k = 2,
# m = 16, 32 and 64, and pad shapes (J*m = 96, 160, 320: not a multiple of
# 128)
RD64_CASES = [(B, 1, 2048, 5, 8, 64) for B in (1, 3, 100, 256)] + [
    (256, 1, 2048, 4, 9, 64), (3, 1, 2048, 4, 9, 64), (7, 2, 256, 4, 9, 64),
    (5, 1, 128, 5, 8, 32), (100, 1, 256, 5, 8, 16), (9, 2, 128, 2, 9, 16),
    (3, 1, 128, 3, 8, 16), (33, 1, 512, 5, 8, 16), (70, 1, 256, 5, 8, 32)]


@pytest.mark.parametrize("B,k,N,l,bgbit,m", RD64_CASES)
def test_rotate_decompose64_ck(cuda, B, k, N, l, bgbit, m):
    """The chosen plan (through the wrapper) and forced plans, bit for bit,
    pad columns included."""
    r = np.random.default_rng(5)
    acc = _i64(r, (B, k + 1, N))
    acc.view(-1)[:3] = torch.tensor([-2**63, 2**63 - 1, 0])
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    a[0] = N                                   # a pure sign flip
    kw = dict(l=l, bgbit=bgbit, offset=_cb_offset(l, bgbit), m=m,
              planes=1 if bgbit <= 8 else 2)
    _same_on_card(K.rotate_decompose64_ck, K.rotate_decompose64_ck_plain,
                  (a, acc), kw, cuda)
    want = K.rotate_decompose64_ck_plain(a, acc, **kw)
    da, dacc = a.to(cuda), acc.to(cuda)
    chosen = K.rotdec_plan(B, k + 1, N, 8, K.sm_count(cuda))
    for plan in _forced_rotdec_plans(chosen):
        got = _rotate_decompose64_ck_plan(da, dacc, plan=plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), plan


@pytest.mark.parametrize("B,k,N,l,bgbit,m", [(5, 1, 128, 3, 8, 16),
                                             (3, 1, 256, 5, 9, 16),
                                             (100, 2, 128, 3, 8, 32)])
def test_rotate_decompose64_ck_writes_its_pad_columns(cuda, B, k, N, l,
                                                      bgbit, m):
    """J*m % 128 != 0: the wrapper allocates with torch.empty from a caching
    allocator whose block was just filled with -1 bytes, and the kernel
    writes the pad columns' zeros itself."""
    r = np.random.default_rng(15)
    acc = _i64(r, (B, k + 1, N))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    P = 1 if bgbit <= 8 else 2
    kw = dict(l=l, bgbit=bgbit, offset=_cb_offset(l, bgbit), m=m, planes=P)
    jm = (k + 1) * l * m
    assert jm % 128 != 0
    want = K.rotate_decompose64_ck_plain(a, acc, **kw)
    da, dacc = a.to(cuda), acc.to(cuda)
    poison = torch.full(want.shape, -1, dtype=torch.int8, device=cuda)
    ptr = poison.data_ptr()
    torch.cuda.synchronize()
    del poison
    got = K.rotate_decompose64_ck(da, dacc, **kw)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr               # the poisoned block
    assert torch.equal(got.cpu(), want)
    ckp = K.ck_width(jm)
    assert not got.reshape(B, -1, ckp)[..., jm:].any()


# the wgmma contractions' cases: CB_MXU's shape (J = 10, 12 limb groups, one
# plane) at every batch, CB_ACTIVE's (J = 8, 16 groups, two planes), m = 32
# and 64, N from the 64-column tile up, limb counts that leave a ragged
# last group, B = 300 (three 128-row tiles, the last one ragged).  Every tile's first added windows start below key row 0 and
# its last subtracted ones end past N + m: TMA's zero fill is the mask.
CK64_CASES = [(B, 2048, 10, 12, 64, 1) for B in (1, 3, 64, 65, 100, 256)] + [
    (256, 2048, 8, 16, 64, 2), (37, 2048, 8, 16, 64, 2),
    (65, 512, 8, 16, 64, 2), (300, 1024, 10, 12, 64, 1),
    (70, 256, 6, 3, 32, 1), (100, 256, 4, 5, 32, 2),
    (64, 128, 6, 4, 32, 1), (9, 128, 4, 5, 64, 2), (5, 64, 4, 3, 32, 1)]


def _ck64_inputs(r, B, N, J, UL, m, P, extreme=False):
    """x (B, C*P*ckp) and the K-packed key wmt (UL, N+m, J*m) (ck_wmt of a
    random wm (UL, J*m, N+m)); ``extreme``: key limbs all -128 and digit
    rows at the planes' extremes (P = 1: -128 and 127; P = 2: -64 and 64),
    the largest partial sums the in-place negation and the plane shift
    see."""
    ckp = K.ck_width(J * m)
    lo, hi = (-128, 128) if P == 1 else (-64, 65)
    x = _i8(r, (B, (N // m) * P * ckp), lo, hi)
    wm = _i8(r, (UL, J * m, N + m))
    if extreme:
        wm.fill_(-128)
        x[0::2] = lo
        x[1::2] = hi - 1
    return x, K.ck_wmt(wm)


def _on_card_vs_plain(fn, plain, args, kw, cuda, **launch):
    """fn on the card against the plain version on the card (its float64
    sums are exact there too; the host would take seconds a case)."""
    dev = tuple(t.to(cuda) for t in args)
    got = fn(*dev, **kw, **launch)
    want = plain(*dev, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _ck_dot64p_rows(x, wmt, *, N, m, planes, rows):
    """ck_dot64p's kernel at a forced row tile, through its raw entry (the
    wrapper chooses the rows from B)."""
    UL, _, Jm = wmt.shape
    out = torch.empty((UL, x.shape[0], N), dtype=torch.int32,
                      device=x.device)
    K._launch("ck_dot64p", x.data_ptr(), wmt.data_ptr(), out.data_ptr(),
              x.shape[0], N, m, Jm, UL, planes, K.ck_width(Jm), rows)
    return out


def _ck_dot64p_acc_plan(x, wmt, acc, *, N, m, planes, kp1, key_shift,
                        plan):
    """ck_dot64p_acc's kernel at a forced (rows, limbs) plan, through its
    raw entry."""
    rows, limbs = plan
    UL, _, Jm = wmt.shape
    out = torch.empty_like(acc)
    K._launch("ck_dot64p_acc", x.data_ptr(), wmt.data_ptr(), acc.data_ptr(),
              out.data_ptr(), x.shape[0], N, m, Jm, kp1, UL // kp1, planes,
              K.ck_width(Jm), key_shift, rows, limbs)
    return out


@pytest.mark.parametrize("B,N,J,UL,m,P", CK64_CASES)
def test_ck_dot64p(cuda, B, N, J, UL, m, P):
    """The chosen plan on wmt as the engine prepares it, and through the
    32-bit generic contraction's entry from wm (one transpose a call,
    counted)."""
    x, wmt = _ck64_inputs(np.random.default_rng(6), B, N, J, UL, m, P)
    kw = dict(N=N, m=m, planes=P)
    _on_card_vs_plain(K.ck_dot64p, K.ck_dot64p_plain, (x, wmt), kw, cuda)
    before = K.ck_dot64p.transposes
    dx, dwmt = x.to(cuda), wmt.to(cuda)
    got = K.ck_dot64p_wm(dx, dwmt.transpose(1, 2).contiguous(), **kw)
    assert K.ck_dot64p.transposes == before + 1
    assert torch.equal(got, K.ck_dot64p_plain(dx, dwmt, **kw))


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("B,N,J,UL,m,P", [(65, 1024, 10, 12, 64, 1),
                                          (100, 256, 4, 5, 32, 2),
                                          (300, 512, 8, 16, 64, 2)])
def test_ck_dot64p_every_plan(cuda, B, N, J, UL, m, P, rows):
    """Both row tiles at the same batches, the one the wrapper would not
    choose included."""
    x, wmt = _ck64_inputs(np.random.default_rng(16), B, N, J, UL, m, P)
    _on_card_vs_plain(_ck_dot64p_rows, K.ck_dot64p_plain, (x, wmt),
                      dict(N=N, m=m, planes=P), cuda, rows=rows)


@pytest.mark.parametrize("B,N,J,UL,m,P", [(256, 2048, 10, 12, 64, 1),
                                          (100, 2048, 8, 16, 64, 2),
                                          (65, 256, 6, 3, 32, 1)])
def test_ck_dot64p_extreme_digits(cuda, B, N, J, UL, m, P):
    """Digits at the planes' extremes against key limbs of -128: the
    partial sums between the in-place negations and plane shifts reach
    their largest magnitudes (wrapping mod 2^32 where P = 2), and the
    folded result is still bit-exact."""
    x, wmt = _ck64_inputs(np.random.default_rng(17), B, N, J, UL, m, P,
                          extreme=True)
    kw = dict(N=N, m=m, planes=P)
    _on_card_vs_plain(K.ck_dot64p, K.ck_dot64p_plain, (x, wmt), kw, cuda)
    for rows in (64, 128):
        _on_card_vs_plain(_ck_dot64p_rows, K.ck_dot64p_plain, (x, wmt), kw,
                          cuda, rows=rows)


def test_ck_dot64p_unsupported_shape_raises(cuda):
    """N = 32 is below the kernels' 64-column tile and J*m = 24 is not a
    multiple of 16 (TMA's row stride): the four 64-bit wrappers raise
    instead of running the plain version on the card.  m = 2 is not a
    multiple of 4, which only ck_cmux_step64's digit builds need: it
    raises there, and the contractions run.  m = 8 and 2 are not multiples
    of 16, which the digit emitter's 16-coefficient runs need: it raises
    there."""
    for N, m, J in ((32, 16, 4), (128, 8, 3), (64, 2, 8)):
        ckp = K.ck_width(J * m)
        x = torch.zeros((4, (N // m) * ckp), dtype=torch.int8, device=cuda)
        wmt = torch.zeros((2, N + m, J * m), dtype=torch.int8, device=cuda)
        acc = torch.zeros((4, 2 * N), dtype=torch.int64, device=cuda)
        a = torch.zeros(4, dtype=torch.int32, device=cuda)
        if m % 4 == 0:
            with pytest.raises(ValueError, match="kernel"):
                K.ck_dot64p(x, wmt, N=N, m=m)
            for fn in (K.ck_dot64p_acc, K.ck_dot64p_sacc):
                with pytest.raises(ValueError, match="kernel"):
                    fn(x, wmt, acc, N=N, m=m, key_shift=0, kp1=2)
        else:
            kw = dict(N=N, m=m, key_shift=0, kp1=2)
            assert torch.equal(K.ck_dot64p(x, wmt, N=N, m=m),
                               K.ck_dot64p_plain(x, wmt, N=N, m=m))
            for fn in (K.ck_dot64p_acc, K.ck_dot64p_sacc):
                assert torch.equal(fn(x, wmt, acc, **kw),
                                   K.ck_dot64p_acc_plain(x, wmt, acc, **kw))
        if m % 16:
            with pytest.raises(ValueError, match="kernel"):
                K.rotate_decompose64_ck_flat(a, acc, N=N, l=J // 2, bgbit=4,
                                             offset=0, m=m)
        if J % 2 == 0:                         # J = kp1 * l with kp1 = 2
            with pytest.raises(ValueError, match="kernel"):
                K.ck_cmux_step64(a, acc, wmt, l=J // 2, bgbit=4, offset=0,
                                 m=m, key_shift=0, planes=1, kp1=2)


@pytest.mark.parametrize("split", [1, 2, 3, 0])
@pytest.mark.parametrize("B,k,N,l,bgbit,L,m,tile", [
    (1, 1, 1024, 3, 7, 3, 128, 0), (3, 1, 1024, 3, 7, 4, 128, 0),
    (100, 1, 1024, 3, 7, 3, 128, 64), (100, 1, 1024, 3, 7, 3, 128, 32),
    (256, 1, 1024, 3, 7, 4, 128, 0), (512, 1, 1024, 3, 7, 3, 128, 0),
    (70, 2, 512, 3, 7, 3, 128, 0), (65, 1, 256, 2, 8, 2, 64, 64),
    (33, 1, 128, 3, 7, 1, 32, 32), (9, 2, 256, 3, 7, 2, 32, 0)])
def test_ck_cmux_step32(cuda, B, k, N, l, bgbit, L, m, tile, split):
    """Batches that are not a multiple of the row tile (tail rows), both
    tiles, m below the 128-column tile (C + 2 windows, some slices without
    a subtracted or an added window), every limb count, every forced window
    split and the chosen one, 64-deep steps and (J*m = 288 at k=2, l=3,
    m=32) 32-deep ones; the 3-D and the flat carry."""
    r = np.random.default_rng(7)
    acc = _i32(r, (B, k + 1, N))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    a[0] = N                                   # a pure sign flip
    wm = _i8(r, ((k + 1) * L, (k + 1) * l * m, N + m))
    kw = dict(l=l, bgbit=bgbit, offset=0x81020400, m=m,
              key_shift=max(0, 32 - 8 * L))
    want = _plain_once(("ck32", B, k, N, l, bgbit, L, m),
                       K.ck_cmux_step32_plain, (a, acc, wm), kw)
    da, dacc, dwm = a.to(cuda), acc.to(cuda), wm.to(cuda)
    got = K.ck_cmux_step32(da, dacc, dwm, tile_rows=tile, split=split, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    flat = K.ck_cmux_step32(da, dacc.reshape(B, -1), dwm, kp1=k + 1,
                            tile_rows=tile, split=split, **kw)
    torch.cuda.synchronize()
    assert torch.equal(flat.cpu(), want.reshape(B, -1))


def test_ck_cmux_step32_unsupported_shape_raises(cuda):
    """N = 64 is below the kernel's 128-column tile: the wrapper raises
    instead of running the plain version on the card."""
    acc = torch.zeros((2, 2, 64), dtype=torch.int32, device=cuda)
    a = torch.zeros(2, dtype=torch.int32, device=cuda)
    wm = torch.zeros((6, 2 * 3 * 64, 128), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="kernel"):
        K.ck_cmux_step32(a, acc, wm, l=3, bgbit=7, offset=0, m=64)
    with pytest.raises(ValueError, match="kernel"):
        K.ck_cmux_step32(a, acc, wm, l=3, bgbit=7, offset=0, m=64, split=1)


# ck_dot64p_acc's cases: (B, N, l, kp1, L, m, P)
CK64_ACC_CASES = [(B, 2048, 5, 2, 6, 64, 1) for B in (1, 3, 64, 65, 100, 256)
                  ] + [(256, 2048, 4, 2, 8, 64, 2), (37, 2048, 4, 2, 8, 64, 2),
                       (1, 256, 2, 3, 3, 64, 1), (70, 128, 4, 2, 5, 32, 2),
                       (100, 256, 3, 2, 4, 32, 1), (5, 64, 2, 2, 3, 32, 1)]


@pytest.mark.parametrize("B,N,l,kp1,L,m,P", CK64_ACC_CASES)
def test_ck_dot64p_acc(cuda, B, N, l, kp1, L, m, P):
    """The chosen plan on wmt; ck_dot64p_sacc, the same function with the
    limbs in the grid, gives the same bits."""
    r = np.random.default_rng(8)
    x, wmt = _ck64_inputs(r, B, N, kp1 * l, kp1 * L, m, P)
    acc = _i64(r, (B, kp1 * N))
    kw = dict(N=N, m=m, planes=P, kp1=kp1, key_shift=max(0, 64 - 8 * L))
    _on_card_vs_plain(K.ck_dot64p_acc, K.ck_dot64p_acc_plain, (x, wmt, acc),
                      kw, cuda)
    _on_card_vs_plain(K.ck_dot64p_sacc, K.ck_dot64p_acc_plain, (x, wmt, acc),
                      kw, cuda)


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("plan", [(64, 1), (64, 2), (128, 1), (128, 2)])
@pytest.mark.parametrize("B,N,l,kp1,L,m,P", [(65, 2048, 5, 2, 6, 64, 1),
                                             (100, 512, 4, 2, 8, 64, 2),
                                             (9, 256, 3, 2, 5, 32, 2),
                                             (300, 256, 4, 2, 6, 64, 1)])
def test_ck_dot64p_acc_every_plan(cuda, B, N, l, kp1, L, m, P, plan,
                                  extreme):
    """Every (rows, limbs) plan at the same batches, an odd L under two
    limbs a pass (the second limb of a pass belongs to the next polynomial),
    and the extreme digits of test_ck_dot64p_extreme_digits."""
    r = np.random.default_rng(18)
    x, wmt = _ck64_inputs(r, B, N, kp1 * l, kp1 * L, m, P, extreme)
    acc = _i64(r, (B, kp1 * N))
    _on_card_vs_plain(_ck_dot64p_acc_plan, K.ck_dot64p_acc_plain,
                      (x, wmt, acc), dict(N=N, m=m, planes=P, kp1=kp1,
                                         key_shift=max(0, 64 - 8 * L)),
                      cuda, plan=plan)


@pytest.mark.parametrize("B,k,N,l,bgbit,m", [(256, 1, 2048, 5, 8, 64),
                                             (1, 1, 2048, 5, 8, 64),
                                             (100, 1, 2048, 5, 8, 64),
                                             (256, 1, 2048, 4, 9, 64),
                                             (3, 1, 2048, 4, 9, 64),
                                             (9, 1, 128, 3, 8, 16)])
def test_rotate_decompose64_ck_flat(cuda, B, k, N, l, bgbit, m):
    r = np.random.default_rng(9)
    acc = _i64(r, (B, (k + 1) * N))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    kw = dict(N=N, l=l, bgbit=bgbit, offset=_cb_offset(l, bgbit), m=m,
              planes=1 if bgbit <= 8 else 2)
    before = K.rotate_decompose64_ck.launches
    _same_on_card(K.rotate_decompose64_ck_flat,
                  K.rotate_decompose64_ck_flat_plain, (a, acc), kw, cuda)
    assert K.rotate_decompose64_ck.launches == before


def _cb_toy(dev):
    rng = TfheRng(7)
    sk = circuit.CircuitSecretKey.generate(CB_TOY, rng)
    ck = circuit.CircuitCloudKey.generate(sk, rng, device=dev)
    bits = np.array([0, 1, 1, 0, 1])
    msgs = np.where(bits.astype(bool), -(1 << 31), 0).astype(np.int32)
    ct = lwe.encrypt(sk.lwe_lvl1, msgs, rng, 2.0**-20, device=dev)
    return ck, ct


def test_cb_toy_same_on_card_and_cpu(cuda):
    outs = {}
    for dev in ("cpu", cuda):
        ck, ct = _cb_toy(dev)
        outs[str(dev)] = circuit.circuit_bootstrap(ct, ck.data, CB_TOY).cpu()
    assert torch.equal(outs["cpu"], outs["cuda"])


@pytest.mark.parametrize("env,kernels", [
    ({}, ("rotate_decompose64_ck", "ck_dot64p")),
    ({"TFHE_CK64_PATH": "acc"}, ("rotate_decompose64_ck_flat",
                                 "ck_dot64p_acc")),
    ({"TFHE_CK64_PATH": "sacc"}, ("rotate_decompose64_ck_flat",
                                  "ck_dot64p_sacc")),
    ({"TFHE_CK64_FUSED": "1"}, ("ck_cmux_step64",))])
def test_cb_toy_each_64_bit_step(cuda, monkeypatch, env, kernels):
    """A CB_TOY circuit bootstrap on the card through each 64-bit step
    equals the CPU's default step bit for bit, and launches that step's
    kernels and no other 64-bit kernel."""
    ck, ct = _cb_toy("cpu")
    want = circuit.circuit_bootstrap(ct, ck.data, CB_TOY)
    ck, ct = _cb_toy(cuda)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    K.reset_launches()
    got = circuit.circuit_bootstrap(ct, ck.data, CB_TOY).cpu()
    assert torch.equal(got, want)
    steps = {k.__name__: k.launches for k in K.KERNELS
             if k.__name__ in ("rotate_decompose64_ck", "ck_dot64p",
                               "rotate_decompose64_ck_flat", "ck_dot64p_acc",
                               "ck_dot64p_sacc", "ck_cmux_step64")}
    assert {k for k, v in steps.items() if v} == set(kernels)
    assert len({steps[k] for k in kernels}) == 1


def _v1_case(cuda, B, k, N, l, bgbit, key_shift, seed):
    """v1 on the card against its plain version (run on the card: float64
    sums are exact there too) and against v2's kernel on the transposed
    key, where v2 takes the shape."""
    r = np.random.default_rng(seed)
    acc = _i32(r, (B, k + 1, N)).to(cuda)
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    a[0] = N
    a = a.to(cuda)
    w = _i8(r, (3, (k + 1) * l * N, (k + 1) * N)).to(cuda)
    offset = sum(1 << (32 - (i + 1) * bgbit + bgbit - 1)
                 for i in range(l)) % 2**32
    kw = dict(l=l, bgbit=bgbit, offset=offset, key_shift=key_shift)
    got = K.fused_cmux_step(a, acc, w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, K.fused_cmux_step_plain(a, acc, w, **kw))
    if K.fused_cmux_step_v2_plan(N, l, 3):
        assert torch.equal(got, K.fused_cmux_step_v2(
            a, acc, w.transpose(1, 2).contiguous(), **kw))


@pytest.mark.parametrize("B", [1, 3, 100, 130, 1024])
@pytest.mark.parametrize("k,N", [(1, 128), (1, 512), (1, 1024), (2, 128),
                                 (2, 512), (2, 1024)])
def test_fused_cmux_step_v1(cuda, B, k, N):
    """The v1 kernel at l = 3 (one 3-level digit build a group) for tail
    and full batches, k = 1 and 2, N = 128, 512 and 1024, against its plain
    version and against v2's kernel."""
    _v1_case(cuda, B, k, N, 3, 7, 8, 10)


@pytest.mark.parametrize("B,k,N,l,bgbit,key_shift", [
    (65, 1, 128, 1, 8, 8), (100, 1, 256, 2, 8, 0), (3, 2, 128, 4, 8, 8),
    (130, 1, 128, 5, 6, 0), (64, 1, 256, 7, 4, 8), (5, 1, 128, 32, 1, 8)])
def test_fused_cmux_step_v1_levels(cuda, B, k, N, l, bgbit, key_shift):
    """Level blocks of every size: l = 1 and 2 (one build a group, lb = l,
    more raw stages), 4 (two builds of 2), 5 (3 + 2), 7 (3 + 3 + 1: a
    one-level build after a longer one) and 32 at bgbit = 1 (ten builds of
    3, then one of 2); both key shifts."""
    _v1_case(cuda, B, k, N, l, bgbit, key_shift, 17)


@pytest.mark.parametrize("B,k,N,l,bgbit", [(256, 1, 2048, 5, 8),
                                           (1, 1, 2048, 5, 8),
                                           (100, 1, 2048, 5, 8),
                                           (3, 1, 2048, 4, 9),
                                           (7, 2, 256, 4, 9),
                                           (5, 1, 128, 5, 8)])
def test_rotate_decompose64(cuda, B, k, N, l, bgbit):
    """The plain-layout emitter (rotate_decompose64_ck's kernel writing
    the other layout) against its plain version, at the chosen plan and
    forced ones; re-laid out, it is rotate_decompose64_ck's output."""
    r = np.random.default_rng(11)
    acc = _i64(r, (B, k + 1, N))
    acc.view(-1)[:3] = torch.tensor([-2**63, 2**63 - 1, 0])
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    a[0] = N
    offset = sum(1 << (63 - i * bgbit) for i in range(l + 1)) % 2**64
    P = 1 if bgbit <= 8 else 2
    kw = dict(l=l, bgbit=bgbit, offset=offset, planes=P)
    _same_on_card(K.rotate_decompose64, K.rotate_decompose64_plain, (a, acc),
                  kw, cuda)
    da, dacc = a.to(cuda), acc.to(cuda)
    planes = K.rotate_decompose64(da, dacc, **kw).reshape(
        B, k + 1, l, P, N).permute(3, 0, 1, 2, 4).reshape(P, B, -1, N)
    assert torch.equal(K.ck_layout(planes, 64),
                       K.rotate_decompose64_ck(da, dacc, m=64, **kw))
    want = K.rotate_decompose64_plain(a, acc, **kw)
    chosen = K.rotdec_plan(B, k + 1, N, 8, K.sm_count(cuda))
    for plan in _forced_rotdec_plans(chosen):
        got = torch.empty_like(want, device=cuda)
        K._launch("rotate_decompose64", da.data_ptr(), dacc.data_ptr(),
                  got.data_ptr(), B, k + 1, N, l, bgbit, offset, P, *plan)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), plan


def _ck_dot64p_sacc_rows(x, wmt, acc, *, N, m, planes, kp1, key_shift,
                         rows):
    """ck_dot64p_sacc's kernel at a forced row tile, through its raw
    entry."""
    UL, _, Jm = wmt.shape
    out = torch.empty_like(acc)
    K._launch("ck_dot64p_sacc", x.data_ptr(), wmt.data_ptr(), acc.data_ptr(),
              out.data_ptr(), x.shape[0], N, m, Jm, kp1, UL // kp1, planes,
              K.ck_width(Jm), key_shift, rows)
    return out


# ck_dot64p_sacc's and ck_cmux_step64's cases: (B, N, l, kp1, L, m, P):
# CB_MXU at the paths' batch and the tails, CB_ACTIVE-shaped (P = 2, 8
# limbs), k = 2, odd limb counts (a 4-row limb group straddles polynomials),
# m below the 64-column tile, a ragged K tail (J*m = 96, 160 or 352: not a
# multiple of 128)
CK64_ATOMIC_CASES = [(B, 2048, 5, 2, 6, 64, 1) for B in (1, 3, 37, 100, 256)
                     ] + [(256, 2048, 4, 2, 8, 64, 2),
                          (37, 2048, 4, 2, 8, 64, 2),
                          (1, 256, 2, 3, 3, 64, 1), (70, 128, 4, 2, 5, 32, 2),
                          (65, 256, 3, 3, 4, 32, 1), (9, 128, 3, 2, 5, 16, 2),
                          (130, 256, 11, 2, 3, 16, 1)]


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("B,N,l,kp1,L,m,P", CK64_ATOMIC_CASES)
def test_ck_dot64p_sacc(cuda, B, N, l, kp1, L, m, P, extreme):
    """The chosen plan and both row tiles forced, on wmt, with random and
    extreme digits (test_ck_dot64p_extreme_digits's)."""
    r = np.random.default_rng(12)
    x, wmt = _ck64_inputs(r, B, N, kp1 * l, kp1 * L, m, P, extreme)
    acc = _i64(r, (B, kp1 * N))
    kw = dict(N=N, m=m, planes=P, kp1=kp1, key_shift=max(0, 64 - 8 * L))
    _on_card_vs_plain(K.ck_dot64p_sacc, K.ck_dot64p_acc_plain, (x, wmt, acc),
                      kw, cuda)
    for rows in (64, 128):
        _on_card_vs_plain(_ck_dot64p_sacc_rows, K.ck_dot64p_acc_plain,
                          (x, wmt, acc), kw, cuda, rows=rows)


def _ck_cmux_step64_plan(a, acc, wmt, *, l, bgbit, offset, m, kp1,
                         key_shift, planes, plan):
    """ck_cmux_step64's kernel at a forced (rows, split) plan, through its
    raw entry: 64 or 128 rows, 1 .. the windows of a tile slices."""
    rows, split = plan
    UL, Npm, Jm = wmt.shape
    N = Npm - m
    assert rows in (64, 128) and 1 <= split <= K.ck_work(N, m, 64)
    out = torch.empty_like(acc)
    K._launch("ck_cmux_step64", a.data_ptr(), acc.data_ptr(), wmt.data_ptr(),
              out.data_ptr(), acc.shape[0], kp1, N, m, l, UL // kp1, planes,
              bgbit, offset & ((1 << 64) - 1), key_shift, rows, split)
    return out


def _step64_case(r, B, N, l, kp1, L, m, P, extreme):
    """(a, acc, wmt) and the step's keywords: random exponents (a[0] = N, a
    pure sign flip) and accumulators, or ``extreme``: every exponent 0 (so
    the digits are the offset's: all -half or all half - 1, row by row) and
    key limbs all -128."""
    bgbit = 8 if P == 1 else 9
    while l * bgbit > 64:
        bgbit -= 1
    acc = _i64(r, (B, kp1 * N))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    a[0] = N
    wm = _i8(r, (kp1 * L, kp1 * l * m, N + m))
    offset = sum(1 << (63 - i * bgbit) for i in range(l + 1)) % 2**64
    if extreme:
        a.zero_()
        wm.fill_(-128)
        offset = 0
    kw = dict(l=l, bgbit=bgbit, offset=offset, m=m, kp1=kp1,
              key_shift=max(0, 64 - 8 * L), planes=P)
    return a, acc, K.ck_wmt(wm), kw


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("B,N,l,kp1,L,m,P", CK64_ATOMIC_CASES)
def test_ck_cmux_step64(cuda, B, N, l, kp1, L, m, P, extreme):
    """The chosen plan, both row tiles and forced window splits (one, two,
    every window its own slice), against the plain version on the card;
    extreme digits from the offsets that make every digit -half, every
    digit half - 1, and at P = 2 every digit 64 (planes -64 and 1)."""
    r = np.random.default_rng(13)
    a, acc, wmt, kw = _step64_case(r, B, N, l, kp1, L, m, P, extreme)
    nw = K.ck_work(N, m, 64)
    bg = kw["bgbit"]
    offsets = (kw["offset"],)
    if extreme:
        offsets = (0, 2**64 - 1) + ((sum(((1 << (bg - 1)) + 64)
                                         << (64 - (lv + 1) * bg)
                                         for lv in range(l)) % 2**64,)
                                    if P == 2 else ())
    for offset in offsets:
        kw["offset"] = offset
        da, dacc, dwmt = a.to(cuda), acc.to(cuda), wmt.to(cuda)
        want = K.ck_cmux_step64_plain(da, dacc, dwmt, **kw)
        assert torch.equal(K.ck_cmux_step64(da, dacc, dwmt, **kw), want)
        chosen = K.ck_cmux_step64_plan(B, kp1, N, m, kp1 * l * m, L, P, cuda)
        for plan in ((64, 1), (128, 1), (64, 2), (128, 2), (128, nw),
                     (64, chosen[1])):
            got = _ck_cmux_step64_plan(da, dacc, dwmt, plan=plan, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), plan


def test_ck_cmux_step64_plan(cuda):
    """The plan: 128 rows above B = 64 where the ring holds two 32 KB key
    stages beside the two digit buffers, else 64; the C query of the ring's
    stages; a narrow batch splits its tiles' windows, and m = 2 (not a
    multiple of 4) has no plan."""
    assert K._occupancy("ck_cmux_step64_stages", 128, 640) == 2
    assert K._occupancy("ck_cmux_step64_stages", 64, 640) == 4
    assert K._occupancy("ck_cmux_step64_stages", 128, 1280) == 0
    assert K._occupancy("ck_cmux_step64_stages", 64, 1280) == 2
    plan = K.ck_cmux_step64_plan
    assert plan(256, 2, 2048, 64, 640, 6, 1, cuda)[0] == 128
    assert plan(64, 2, 2048, 64, 640, 6, 1, cuda)[0] == 64
    assert plan(256, 2, 2048, 64, 1280, 6, 1, cuda)[0] == 64
    assert 1 <= plan(256, 2, 2048, 64, 640, 6, 1, cuda)[1] <= 33
    assert plan(1, 2, 2048, 64, 640, 6, 1, cuda)[1] > 1
    with pytest.raises(ValueError, match="m % 4 == 0"):
        plan(1, 2, 64, 2, 16, 6, 1, cuda)


# ---------------------------------------------------------------------------
# the conv, Nussbaumer and FFT engines on the card
# ---------------------------------------------------------------------------

def _engine_case(r, bits, digit_bits, B, J, U, N):
    half = 1 << (digit_bits - 1)                # digits in [-Bg/2, Bg/2)
    x = torch.from_numpy(r.integers(-half, half, (B, J, N))
                         .astype(np.int32))
    if bits == 32:
        key = _i32(r, (J, U, N))
    else:
        key = torch.from_numpy(r.integers(-2**63, 2**63, (J, U, N),
                                          dtype=np.int64))
    return x, key


@pytest.mark.parametrize("backend,bits,digit_bits,key_limbs,B,J,U,N", [
    ("conv", 32, 7, 0, 20, 6, 2, 1024),      # GATE_DEFAULT's engine shape
    ("conv", 32, 7, 3, 3, 6, 2, 1024),
    ("conv", 64, 8, 6, 20, 4, 2, 512),       # the lvl2 gadget, Bg = 2^8
    ("conv", 64, 9, 0, 17, 4, 2, 256),       # two digit planes
    ("conv_bf16", 32, 7, 0, 20, 6, 2, 1024),
    ("nussbaumer", 32, 7, 0, 20, 6, 2, 1024),
    ("nussbaumer", 64, 8, 6, 20, 4, 2, 512)])
def test_exact_engines_same_on_card_and_cpu(cuda, backend, bits, digit_bits,
                                            key_limbs, B, J, U, N):
    """conv, conv_bf16 and nussbaumer on the card equal their CPU results
    bit for bit; conv also equals the exact onthefly (32 bits) or chunked
    (64 bits) engine, and launches materialize_w and mm_recombine_acc once a
    digit plane at 32 bits, materialize_wt once at 64."""
    from tfhe_tpu_torch.ops import engine
    cfg = engine.EngineConfig(N=N, out_bits=bits, digit_bits=digit_bits,
                              key_limbs=key_limbs)
    x, key = _engine_case(np.random.default_rng(B + N), bits, digit_bits, B,
                          J, U, N)
    eng = engine.make_engine(cfg, backend)
    want = eng.accumulate(x, eng.prepare(key))
    prep = eng.prepare(key.to(cuda))
    K.reset_launches()
    got = eng.accumulate(x.to(cuda), prep)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if backend.startswith("conv"):
        assert (K.materialize_w.launches, K.materialize_wt.launches) == (
            (1, 0) if bits == 32 else (0, 1))
        assert K.mm_recombine_acc.launches == (cfg.plane_split[1]
                                               if bits == 32 else 0)
        exact = engine.make_engine(cfg, "onthefly" if bits == 32
                                   else "chunked")
        assert torch.equal(got, exact.accumulate(x.to(cuda),
                                                 exact.prepare(key.to(cuda))))


@pytest.mark.parametrize("backend,bound", [("fft_f64", 2**4),
                                           ("fft_dd", 2**8)])
def test_fft_engines_on_card(cuda, backend, bound):
    """The FFT engines on the card (cuFFT / eager f32) stay within their
    envelopes of the exact product at GATE_DEFAULT's engine shape."""
    from tfhe_tpu_torch.ops import engine
    cfg = engine.EngineConfig(N=1024, out_bits=32, digit_bits=7)
    x, key = _engine_case(np.random.default_rng(0), 32, 7, 20, 6, 2, 1024)
    exact = engine.make_engine(cfg, "onthefly")
    want = exact.accumulate(x.to(cuda), exact.prepare(key.to(cuda)))
    eng = engine.make_engine(cfg, backend)
    got = eng.accumulate(x.to(cuda), eng.prepare(key.to(cuda)))
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.int32
    d = (got.to(torch.int64) - want.to(torch.int64)).to(torch.int32)
    assert int(d.abs().max()) <= bound


def test_toy_bootstrap_fft_f64_on_card(cuda):
    rng = TfheRng(5)
    sk = gate.SecretKey.generate(GATE_TOY, rng)
    ck = gate.CloudKey.generate(sk, rng, backend="fft_f64", device=cuda)
    bits = np.array([0, 1, 1, 0, 1])
    ct = gate.encrypt_bool(sk, bits, rng, device=cuda)
    out = gate.gate_nand(ck.data, ct, ct, GATE_TOY, "fft_f64")
    assert out.device.type == "cuda"
    assert (gate.decrypt_bool(sk, out) == ~bits.astype(bool)).all()


def test_cb_toy_conv_same_on_card_and_cpu(cuda):
    """CB_TOY on conv (the JAX package's default circuit backend) on the
    card equals the CPU's chunked TRGSWs bit for bit."""
    ck, ct = _cb_toy("cpu")
    want = circuit.circuit_bootstrap(ct, ck.data, CB_TOY)
    rng = TfheRng(7)
    sk = circuit.CircuitSecretKey.generate(CB_TOY, rng)
    ck = circuit.CircuitCloudKey.generate(sk, rng, backend="conv",
                                          device=cuda)
    K.reset_launches()
    got = circuit.circuit_bootstrap(ct.to(cuda), ck.data, CB_TOY,
                                    backend="conv")
    assert torch.equal(got.cpu(), want)
    assert K.materialize_wt.launches > 0


def test_reference_e2e_rotations(cuda):
    """The two 500-step CB_ACTIVE rotations of the patched PoC on the card,
    bit for bit against tests/fixtures/ref_e2e_exact and within the phase
    envelope of ref_e2e_fft (tests/test_torch_reference.py)."""
    from test_torch_reference import e2e_rotations_check
    e2e_rotations_check(cuda)
