"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where no GPU is present.  On a machine with one:

    python -m pytest -m cuda tests/test_torch_cuda.py

Small and ragged shapes (batches that do not fill a 64-row tile, every limb
count, both key shifts, one and two digit planes), the device guard, every
captured program (tfhe_tpu_torch.graphs: the blind rotation, the bootstrap
function, the staged circuit bootstrap, the scheduler's launches and
chains) against graphs.disable(), the tracer's stream spans of the
staged circuit bootstrap under torch.profiler, plus GATE_TOY
bootstraps (on the onthefly, matmul, conv, conv_bf16 and nussbaumer
engines) and CB_TOY circuit bootstraps (on each of the four 64-bit steps,
and on conv) that must give the same ciphertexts on the card as on the
CPU; the conv, Nussbaumer and FFT engines at gate and lvl2 shapes; and the
two CB_ACTIVE reference rotations (tests/test_torch_reference.py); and the
sharded bootstraps of tfhe_tpu_torch.parallel on two gloo ranks sharing
the card.  Imports nothing of JAX.
"""

import functools

import numpy as np
import pytest
import torch

from tfhe_tpu_torch import lwe
from tfhe_tpu_torch.boot import circuit, gate
from tfhe_tpu_torch.ops import kernels as K
from tfhe_tpu_torch.params import CB_PAPER_TOY, CB_TOY, GATE_TOY
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.utils import observability as obs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _launches() -> dict:
    """Every kernel wrapper's launch count so far, by wrapper name (the
    ``kernel.<wrapper>`` counters; ``ck_dot64p.transposes`` among them)."""
    return {k[len("kernel."):]: v for k, v in obs.report()["counters"].items()
            if k.startswith("kernel.")}


def _launched(before: dict) -> dict:
    """What the wrappers launched since the snapshot ``before``, non-zero
    counts only."""
    return {k: v - before.get(k, 0) for k, v in _launches().items()
            if v != before.get(k, 0)}


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
    K._launch(name, dv.device,
              dv.data_ptr(), got.data_ptr(), L, J, U, N, rows, cols,
              threads)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _rotate_decompose_plan(a, acc, *, l, bgbit, offset, plan):
    """rotate_decompose's kernel at a forced (rows, split, threads) plan,
    through its raw entry."""
    B, kp1, N = acc.shape
    out = torch.empty((B, kp1 * l, N), dtype=torch.int8, device=acc.device)
    K._launch("rotate_decompose", a.device, a.data_ptr(), acc.data_ptr(),
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


# the K-packed entry at the paths' K: GATE_DEFAULT (K = 6,144, U*N =
# 2,048), GATE_FAST2 (4,608, 1,536) and an ep=3 slice of it (1,536, 1,536)
_MM_KUN = [(6144, 2048), (4608, 1536), (1536, 1536)]


def _mm_case(B, K_, UN, L, cuda, seed=2):
    """x, wt, acc of one case, drawn on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed + B + K_ + L)
    x = torch.randint(-64, 65, (B, K_), generator=g, device=cuda,
                      dtype=torch.int8)
    wt = torch.randint(-128, 128, (L, UN, K_), generator=g, device=cuda,
                       dtype=torch.int8)
    acc = torch.randint(-2**31, 2**31, (B, UN), generator=g, device=cuda,
                        dtype=torch.int32)
    return x, wt, acc


@pytest.mark.parametrize("B", [1, 3, 64, 200, 256, 628, 768, 8192])
@pytest.mark.parametrize("K_,UN", _MM_KUN)
@pytest.mark.parametrize("L,shift", [(1, 24), (2, 16), (3, 8), (4, 0)])
def test_mm_recombine_acc_wt(cuda, B, K_, UN, L, shift):
    """The K-packed entry at its chosen plan against its plain version on
    the card: batches in one 64-row tile, ragged 128-row tiles (200, 628)
    and the gate paths' widths, every limb count and key shift."""
    x, wt, acc = _mm_case(B, K_, UN, L, cuda)
    want = K.mm_recombine_acc_wt_plain(x, wt, acc, shift_base=shift)
    got = K.mm_recombine_acc_wt(x, wt, acc, shift_base=shift)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,rows,split,ctas", [
    (200, 64, 1, 7),          # many units a block: the ring's phases wrap
    (2200, 128, 1, 132),      # 18 row tiles: a group of 16, then one of 2
    (2200, 128, 3, 5),
    (628, 64, 2, 132),
    (8192, 128, 2, 132),
    (3, 128, 5, 1)])          # one block walks every unit
def test_mm_recombine_acc_forced_plans(cuda, B, rows, split, ctas):
    """Plans the shape would not choose, through the raw entry, at
    GATE_DEFAULT's K and width and a nonzero shift."""
    K_, UN, L, shift = 6144, 2048, 4, 8
    x, wt, acc = _mm_case(B, K_, UN, L, cuda, seed=7)
    want = K.mm_recombine_acc_wt_plain(x, wt, acc, shift_base=shift)
    out = torch.empty_like(acc)        # the entry copies acc there if S > 1
    K._launch("mm_recombine_acc", x.device, x.data_ptr(), wt.data_ptr(),
              acc.data_ptr(), out.data_ptr(), B, K_, UN, L, shift, rows,
              split, ctas)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_mm_recombine_acc_plan_counter(cuda):
    """Each launch counts its plan: B=8192 takes whole-K 128-row units,
    256 rows a K split."""
    seen = {}
    for B in (8192, 256):
        x, wt, acc = _mm_case(B, 6144, 2048, 4, cuda)
        before = obs.report()["counters"]
        K.mm_recombine_acc_wt(x, wt, acc)
        after = obs.report()["counters"]
        rows, S, _ = K.mm_recombine_acc_plan(B, 6144, 2048, K.sm_count(cuda))
        name = f"mm_recombine.plan.{rows}x64.s{S}"
        assert {k: v - before.get(k, 0) for k, v in after.items()
                if k.startswith("mm_recombine.plan.")
                and v != before.get(k, 0)} == {name: 1}
        seen[B] = (rows, S)
    assert seen[8192] == (128, 1) and seen[256][0] == 128
    assert seen[256][1] > 1


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
    before = _launches()
    got = te.cmux_step(a, acc, prep, **kw)
    assert (got is not None) is fused
    assert _launched(before).get("fused_cmux_step_v2", 0) == fused
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
    w = torch.zeros((1, 64, 32), dtype=torch.int8, device=cuda)
    acc = torch.zeros((8, 32), dtype=torch.int32, device=cuda)
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
    K._launch("rotate_decompose64_ck", a.device, a.data_ptr(), acc.data_ptr(),
              out.data_ptr(), B, kp1, N, l, bgbit, offset & ((1 << 64) - 1),
              m, planes, ckp, *plan)
    return out


def _cb_offset(l, bgbit):
    return sum(1 << (63 - i * bgbit) for i in range(l + 1)) % 2**64


# the 64-bit emitter's cases (B, k, N, l, bgbit, m): CB_MXU at the steps'
# batches (256, and the narrow 1, 3, 100), CB_ACTIVE and CB_PAPER (two
# planes; CB_PAPER's J*m = 768), k = 2,
# m = 16, 32 and 64, and pad shapes (J*m = 96, 160, 320: not a multiple of
# 128)
RD64_CASES = [(B, 1, 2048, 5, 8, 64) for B in (1, 3, 100, 256)] + [
    (256, 1, 2048, 4, 9, 64), (3, 1, 2048, 4, 9, 64), (7, 2, 256, 4, 9, 64),
    (256, 1, 2048, 6, 9, 64), (5, 1, 128, 5, 8, 32), (100, 1, 256, 5, 8, 16), (9, 2, 128, 2, 9, 16),
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
# plane) at every batch, CB_ACTIVE's (J = 8, 16 groups, two planes) and
# CB_PAPER's (J = 12, 16 groups, two planes), m = 32
# and 64, N from the 64-column tile up, limb counts that leave a ragged
# last group, B = 300 (three 128-row tiles, the last one ragged).  Every tile's first added windows start below key row 0 and
# its last subtracted ones end past N + m: TMA's zero fill is the mask.
CK64_CASES = [(B, 2048, 10, 12, 64, 1) for B in (1, 3, 64, 65, 100, 256)] + [
    (256, 2048, 8, 16, 64, 2), (37, 2048, 8, 16, 64, 2),
    (256, 2048, 12, 16, 64, 2), (65, 512, 8, 16, 64, 2),
    (300, 1024, 10, 12, 64, 1),
    (70, 256, 6, 3, 32, 1), (100, 256, 4, 5, 32, 2),
    (64, 128, 6, 4, 32, 1), (9, 128, 4, 5, 64, 2), (5, 64, 4, 3, 32, 1)]
# the key-stationary plan's: a query's batches at CB_ACTIVE's lvl2 shape
# (J*m = 512) and CB_PAPER's (768), one and two planes
KST_CASES = [(B, 2048, J, 16, 64, P) for B in (1, 2, 3, 4) for J in (8, 12)
             for P in (1, 2)]


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


def _ck_dot64p_rows(x, wmt, *, N, m, planes, rows, kst=False):
    """ck_dot64p's kernel at a forced plan, through its raw entry (the
    wrapper chooses the plan from C*B): the output-stationary plan's row
    tile, or the key-stationary plan's (``kst``)."""
    UL, _, Jm = wmt.shape
    out = torch.empty((UL, x.shape[0], N), dtype=torch.int32,
                      device=x.device)
    K._launch("ck_dot64p", x.device,
              x.data_ptr(), wmt.data_ptr(), out.data_ptr(),
              x.shape[0], N, m, Jm, UL, planes, K.ck_width(Jm), rows,
              int(kst))
    return out


def _ck_dot64p_acc_plan(x, wmt, acc, *, N, m, planes, kp1, key_shift,
                        plan):
    """ck_dot64p_acc's kernel at a forced (rows, limbs) plan, through its
    raw entry."""
    rows, limbs = plan
    UL, _, Jm = wmt.shape
    out = torch.empty_like(acc)
    K._launch("ck_dot64p_acc", x.device,
              x.data_ptr(), wmt.data_ptr(), acc.data_ptr(),
              out.data_ptr(), x.shape[0], N, m, Jm, kp1, UL // kp1, planes,
              K.ck_width(Jm), key_shift, rows, limbs)
    return out


@pytest.mark.parametrize("B,N,J,UL,m,P", CK64_CASES + KST_CASES)
def test_ck_dot64p(cuda, B, N, J, UL, m, P):
    """The chosen plan on wmt as the engine prepares it (the key-stationary
    one where C*B <= KST_ROWS and m % 64 == 0: KST_CASES, CB_MXU's B = 1, 3
    and others), and through the 32-bit generic contraction's entry from wm
    (one transpose a call, counted)."""
    x, wmt = _ck64_inputs(np.random.default_rng(6), B, N, J, UL, m, P)
    kw = dict(N=N, m=m, planes=P)
    _on_card_vs_plain(K.ck_dot64p, K.ck_dot64p_plain, (x, wmt), kw, cuda)
    before = _launches()
    dx, dwmt = x.to(cuda), wmt.to(cuda)
    got = K.ck_dot64p_wm(dx, dwmt.transpose(1, 2).contiguous(), **kw)
    assert _launched(before)["ck_dot64p.transposes"] == 1
    assert torch.equal(got, K.ck_dot64p_plain(dx, dwmt, **kw))


@pytest.mark.parametrize("B,J,name", [
    (256, 12, "ck_dot64p.plan.128x64.jm768.p2"),
    (256, 8, "ck_dot64p.plan.128x64.jm512.p2"),
    (4, 8, "ck_dot64p.plan.kst128x64.jm512.p2")])
def test_ck_dot64p_plan_counter(cuda, B, J, name):
    """A launch at CB_PAPER's lvl2 shape (B=256, J*m = 768, two planes), at
    CB_ACTIVE's (J*m = 512) and at a CB_ACTIVE query's B=4 (the
    key-stationary plan) each count their own plan once, eagerly and under
    a graph replay (graphs.py adds a replay's counter delta); two replays
    give the plain version's bits (the key-stationary plan's cross-block
    sum lands in a different order each time)."""
    from tfhe_tpu_torch import graphs
    x, wmt = _ck64_inputs(np.random.default_rng(18), B, 2048, J, 16, 64, 2)
    x, wmt = x.to(cuda), wmt.to(cuda)
    kw = dict(N=2048, m=64, planes=2)
    want = K.ck_dot64p_plain(x, wmt, **kw)

    def plans(call):
        before = obs.report()["counters"]
        out = call()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        after = obs.report()["counters"]
        return {k: v - before.get(k, 0) for k, v in after.items()
                if k.startswith("ck_dot64p") and v != before.get(k, 0)}

    assert plans(lambda: K.ck_dot64p(x, wmt, **kw)) == {name: 1}
    graphs.clear()
    fn = functools.partial(K.ck_dot64p, wmt=wmt, **kw)

    def graphed():
        return graphs.run("test.ck_dot64p", ("ck_dot64p", B, J), fn, (x,),
                          (wmt,)).clone()

    assert plans(graphed) == {name: 1}         # the capture's warm-up call
    assert plans(graphed) == {name: 1}         # a replay
    assert plans(graphed) == {name: 1}         # and another
    assert graphs.stats()[0]["replays"] == 2
    graphs.clear()


# (B, N, J, UL, m, P, rows, kst): both row tiles of the output-stationary
# plan at the same batches, the one the wrapper would not choose included;
# the key-stationary plan (128 stacked rows) where the wrapper would not
# take it, C*B over KST_ROWS (several slices, each reading the key; a
# ragged limb group)
_EVERY_PLAN_SHAPES = [(65, 1024, 10, 12, 64, 1), (100, 256, 4, 5, 32, 2),
                      (300, 512, 8, 16, 64, 2), (64, 2048, 8, 16, 64, 2),
                      (3, 2048, 12, 16, 64, 2)]
_EVERY_PLAN = [(*shape, rows, False) for shape in _EVERY_PLAN_SHAPES
               for rows in (64, 128)] + [
    (*shape, 128, True) for shape in _EVERY_PLAN_SHAPES
    if K.ck_kst_ok(shape[1], shape[4], shape[2] * shape[4])]


@pytest.mark.parametrize("B,N,J,UL,m,P,rows,kst", _EVERY_PLAN)
def test_ck_dot64p_every_plan(cuda, B, N, J, UL, m, P, rows, kst):
    """Every plan at the same batches, those the wrapper would not choose
    included."""
    x, wmt = _ck64_inputs(np.random.default_rng(16), B, N, J, UL, m, P)
    _on_card_vs_plain(_ck_dot64p_rows, K.ck_dot64p_plain, (x, wmt),
                      dict(N=N, m=m, planes=P), cuda, rows=rows, kst=kst)


@pytest.mark.parametrize("B,N,J,UL,m,P", [(256, 2048, 10, 12, 64, 1),
                                          (100, 2048, 8, 16, 64, 2),
                                          (256, 2048, 12, 16, 64, 2),
                                          (65, 256, 6, 3, 32, 1),
                                          (4, 2048, 8, 16, 64, 2),
                                          (1, 2048, 12, 16, 64, 2),
                                          (3, 2048, 10, 12, 64, 1)])
def test_ck_dot64p_extreme_digits(cuda, B, N, J, UL, m, P):
    """Digits at the planes' extremes against key limbs of -128: the
    partial sums between the in-place negations and plane shifts reach
    their largest magnitudes (wrapping mod 2^32 where P = 2), and the
    folded result is still bit-exact, in every plan that takes the
    shape."""
    x, wmt = _ck64_inputs(np.random.default_rng(17), B, N, J, UL, m, P,
                          extreme=True)
    kw = dict(N=N, m=m, planes=P)
    _on_card_vs_plain(K.ck_dot64p, K.ck_dot64p_plain, (x, wmt), kw, cuda)
    for rows in (64, 128):
        _on_card_vs_plain(_ck_dot64p_rows, K.ck_dot64p_plain, (x, wmt), kw,
                          cuda, rows=rows)
    if K.ck_kst_ok(N, m, J * m):
        _on_card_vs_plain(_ck_dot64p_rows, K.ck_dot64p_plain, (x, wmt), kw,
                          cuda, rows=128, kst=True)


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
                       (256, 2048, 6, 2, 8, 64, 2),
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
                                             (256, 1, 2048, 6, 9, 64),
                                             (9, 1, 128, 3, 8, 16)])
def test_rotate_decompose64_ck_flat(cuda, B, k, N, l, bgbit, m):
    r = np.random.default_rng(9)
    acc = _i64(r, (B, (k + 1) * N))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    kw = dict(N=N, l=l, bgbit=bgbit, offset=_cb_offset(l, bgbit), m=m,
              planes=1 if bgbit <= 8 else 2)
    before = _launches()
    _same_on_card(K.rotate_decompose64_ck_flat,
                  K.rotate_decompose64_ck_flat_plain, (a, acc), kw, cuda)
    assert "rotate_decompose64_ck" not in _launched(before)


def _cb_toy(dev, P=CB_TOY):
    rng = TfheRng(7)
    sk = circuit.CircuitSecretKey.generate(P, rng)
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
    ({}, ("rotate_decompose64_ck", "ck_dot64p_sacc")),
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
    before = _launches()
    got = circuit.circuit_bootstrap(ct, ck.data, CB_TOY).cpu()
    assert torch.equal(got, want)
    steps = {k: v for k, v in _launched(before).items()
             if k in ("rotate_decompose64_ck", "ck_dot64p",
                      "rotate_decompose64_ck_flat", "ck_dot64p_acc",
                      "ck_dot64p_sacc", "ck_cmux_step64")}
    assert set(steps) == set(kernels)
    assert len({steps[k] for k in kernels}) == 1


@pytest.mark.parametrize("env", [{}, {"TFHE_CK64_PATH": "acc"},
                                 {"TFHE_CK64_PATH": "sacc"},
                                 {"TFHE_CK64_FUSED": "1"}])
def test_cb_paper_toy_same_on_card_and_cpu(cuda, monkeypatch, env):
    """The CB_PAPER-gadget toy's circuit bootstrap (one rotation per level)
    on the card, through each 64-bit step and graphed
    (make_circuit_bootstrap_staged), equals the CPU's bit for bit."""
    ck, ct = _cb_toy("cpu", CB_PAPER_TOY)
    want = circuit.circuit_bootstrap(ct, ck.data, CB_PAPER_TOY,
                                     shared_rotation=False)
    ck, ct = _cb_toy(cuda, CB_PAPER_TOY)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cb = circuit.make_circuit_bootstrap_staged(CB_PAPER_TOY,
                                               shared_rotation=False)
    for _ in range(2):                         # the capture, then a replay
        assert torch.equal(cb(ct, ck.data).cpu(), want)


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
        K._launch("rotate_decompose64", da.device,
                  da.data_ptr(), dacc.data_ptr(),
                  got.data_ptr(), B, k + 1, N, l, bgbit, offset, P, *plan)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), plan


def _ck_dot64p_sacc_rows(x, wmt, acc, *, N, m, planes, kp1, key_shift,
                         rows, kst=False):
    """ck_dot64p_sacc's kernel at a forced plan, through its raw entry: the
    output-stationary plan's row tile, or the key-stationary plan's
    (``kst``)."""
    UL, _, Jm = wmt.shape
    out = torch.empty_like(acc)
    K._launch("ck_dot64p_sacc", x.device,
              x.data_ptr(), wmt.data_ptr(), acc.data_ptr(),
              out.data_ptr(), x.shape[0], N, m, Jm, kp1, UL // kp1, planes,
              K.ck_width(Jm), key_shift, rows, int(kst))
    return out


# ck_dot64p_sacc's and ck_cmux_step64's cases: (B, N, l, kp1, L, m, P):
# CB_MXU at the paths' batch and the tails, CB_ACTIVE- and CB_PAPER-shaped
# (P = 2, 8 limbs; J*m = 512 and 768), k = 2, odd limb counts (a 4-row
# limb group straddles polynomials), m below the 64-column tile, a ragged K
# tail (J*m = 96, 160 or 352: not a multiple of 128)
CK64_ATOMIC_CASES = [(B, 2048, 5, 2, 6, 64, 1) for B in (1, 3, 37, 100, 256)
                     ] + [(256, 2048, 4, 2, 8, 64, 2),
                          (37, 2048, 4, 2, 8, 64, 2),
                          (256, 2048, 6, 2, 8, 64, 2),
                          (1, 256, 2, 3, 3, 64, 1), (70, 128, 4, 2, 5, 32, 2),
                          (65, 256, 3, 3, 4, 32, 1), (9, 128, 3, 2, 5, 16, 2),
                          (130, 256, 11, 2, 3, 16, 1)]


# ck_dot64p_sacc's key-stationary plan at a query's batches and around
# KST_ROWS (B = 40: 1,280 stacked rows, ten 128-row slices): CB_ACTIVE's
# lvl2 shape (J*m = 512, 8 limbs, two planes), CB_PAPER's (768) and CB_MXU's
# (640, 6 limbs: limb groups straddling the two polynomials, one plane);
# one-limb keys (four polynomials a limb group: two passes, the second of
# one or two polynomials)
KST_SACC_CASES = [(B, 2048, l, 2, L, 64, P) for B in (1, 3, 4, 40)
                  for l, L, P in ((4, 8, 2), (6, 8, 2), (5, 6, 1))] + [
    (4, 1024, 2, 4, 1, 64, 1), (3, 1024, 2, 3, 1, 64, 2)]


def _contract_extremes(x, P, ckp):
    """x with every digit at the wrappers' contract's extremes, rows
    alternating (P = 1: -128 and 127, as _ck64_inputs gives them; P = 2,
    9-bit digits: -256 = (-2, 0) and 255 = (2, -1) as (high, low) planes):
    the largest folds a key-stationary block's int32 partials must hold
    exactly, since its epilogue widens each before the blocks' sums
    meet."""
    if P == 1:
        return x
    x = x.clone()
    v = x.view(x.shape[0], -1, 2, ckp)
    v[0::2, :, 0], v[0::2, :, 1] = 0, -2
    v[1::2, :, 0], v[1::2, :, 1] = -1, 2
    return x


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("B,N,l,kp1,L,m,P",
                         CK64_ATOMIC_CASES + KST_SACC_CASES)
def test_ck_dot64p_sacc(cuda, B, N, l, kp1, L, m, P, extreme):
    """The chosen plan, both row tiles forced and the key-stationary plan
    forced where its domain takes the shape (ck_kst_ok), on wmt, with
    random and extreme digits: for the output-stationary plans, chosen or
    forced, test_ck_dot64p_extreme_digits's (at P = 2 both planes at +-64,
    past the 9-bit digits' contract: the int32 folds wrap, as plain's
    wrap32 does), for the key-stationary plan, chosen or forced, the
    contract's (_contract_extremes: a key-stationary block widens its
    tile's partial fold, which equals plain's only where the fold is
    exact)."""
    r = np.random.default_rng(12)
    x, wmt = _ck64_inputs(r, B, N, kp1 * l, kp1 * L, m, P, extreme)
    acc = _i64(r, (B, kp1 * N))
    kw = dict(N=N, m=m, planes=P, kp1=kp1, key_shift=max(0, 64 - 8 * L))
    Jm = kp1 * l * m
    xk = _contract_extremes(x, P, K.ck_width(Jm)) if extreme else x
    for rows in (64, 128):
        _on_card_vs_plain(_ck_dot64p_sacc_rows, K.ck_dot64p_acc_plain,
                          (x, wmt, acc), kw, cuda, rows=rows)
    _, kst = K.ck_dot64p_plan(B, N, m, Jm, P)
    _on_card_vs_plain(K.ck_dot64p_sacc, K.ck_dot64p_acc_plain,
                      (xk if kst else x, wmt, acc), kw, cuda)
    if K.ck_kst_ok(N, m, Jm):
        _on_card_vs_plain(_ck_dot64p_sacc_rows, K.ck_dot64p_acc_plain,
                          (xk, wmt, acc), kw, cuda, rows=128, kst=True)


@pytest.mark.parametrize("B,l,name", [
    (4, 4, "ck_dot64p_sacc.plan.kst128x64.jm512.p2"),
    (256, 4, "ck_dot64p_sacc.plan.128x64.jm512.p2"),
    (256, 6, "ck_dot64p_sacc.plan.128x64.jm768.p2")])
def test_ck_dot64p_sacc_plan_counter(cuda, B, l, name):
    """ck_dot64p_sacc at a CB_ACTIVE query's B=4 (the key-stationary plan)
    and at CB_ACTIVE's and CB_PAPER's B=256 counts its own plan once,
    eagerly and under each of two graph replays, with the plain version's
    bits every time (the blocks' reductions land in a different order each
    launch)."""
    from tfhe_tpu_torch import graphs
    r = np.random.default_rng(19)
    x, wmt = _ck64_inputs(r, B, 2048, 2 * l, 16, 64, 2)
    x, wmt = x.to(cuda), wmt.to(cuda)
    acc = _i64(r, (B, 2 * 2048)).to(cuda)
    kw = dict(N=2048, m=64, planes=2, kp1=2, key_shift=0)
    want = K.ck_dot64p_acc_plain(x, wmt, acc, **kw)

    def plans(call):
        before = obs.report()["counters"]
        out = call()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        after = obs.report()["counters"]
        return {k: v - before.get(k, 0) for k, v in after.items()
                if k.startswith("ck_dot64p") and v != before.get(k, 0)}

    assert plans(lambda: K.ck_dot64p_sacc(x, wmt, acc, **kw)) == {name: 1}
    graphs.clear()

    def fn(x, acc):
        return K.ck_dot64p_sacc(x, wmt, acc, **kw)

    def graphed():
        return graphs.run("test.ck_dot64p_sacc", ("ck_dot64p_sacc", B, l),
                          fn, (x, acc), (wmt,)).clone()

    assert plans(graphed) == {name: 1}         # the capture's warm-up call
    assert plans(graphed) == {name: 1}         # a replay
    assert plans(graphed) == {name: 1}         # and another
    assert graphs.stats()[0]["replays"] == 2
    graphs.clear()


@pytest.mark.parametrize("B", [4, 256])
def test_graphed_default_step64(cuda, B):
    """The chunked engine's default 64-bit step at CB_ACTIVE's lvl2 shape
    (rotate_decompose64_ck + ck_dot64p_sacc, the epilogue in the
    contraction), graphed against eager on three inputs, equal to the
    former step's bits (ck_dot64p + the torch epilogue); its counters
    show ck_dot64p_sacc's plan (the key-stationary one at B=4) and no
    ck_dot64p launch."""
    from tfhe_tpu_torch import graphs, tgsw
    from tfhe_tpu_torch.ops.engine import make_engine
    from tfhe_tpu_torch.params import CB_ACTIVE
    p = CB_ACTIVE.tgsw_lvl2
    eng = make_engine(tgsw.engine_config(p), "chunked")
    r = np.random.default_rng(20)
    N, kp1 = p.tlwe.N, p.tlwe.k + 1
    UL, Jm = kp1 * eng.cfg.num_limbs, p.kpl * eng.m
    prep = {"wmt": _i8(r, (UL, N + eng.m, Jm)).to(cuda)}
    kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset)
    inputs = [(torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
               .to(cuda), _i64(r, (B, kp1, N)).to(cuda)) for _ in range(3)]

    def step(a, acc):
        return graphs.run("test.default_step64", ("step64", B),
                          lambda a_, acc_: eng.cmux_step(a_, acc_, prep,
                                                         **kw),
                          (a, acc), (prep["wmt"],))

    before = obs.report()["counters"]
    captures, replays, _ = _graphed_against_eager(step, inputs)
    after = obs.report()["counters"]
    assert (captures, replays) == (1, 2)
    counted = {k for k, v in after.items() if v != before.get(k, 0)}
    plan = "kst128x64" if B == 4 else "128x64"
    assert f"ck_dot64p_sacc.plan.{plan}.jm{Jm}.p{eng.cfg.plane_split[1]}" \
        in counted
    assert not any(k.startswith("ck_dot64p.plan.") for k in counted)
    assert "kernel.ck_dot64p" not in counted
    P = eng.cfg.plane_split[1]
    for a, acc in inputs:
        x = K.rotate_decompose64_ck(a, acc, m=eng.m, planes=P, **kw)
        y = K.ck_dot64p(x, prep["wmt"], N=N, m=eng.m, planes=P)
        want = acc + K.recombine(y, kp1, eng.cfg.key_shift)
        assert torch.equal(eng.cmux_step(a, acc, prep, **kw), want)
    graphs.clear()


def _ck_cmux_step64_plan(a, acc, wmt, *, l, bgbit, offset, m, kp1,
                         key_shift, planes, plan):
    """ck_cmux_step64's kernel at a forced (rows, split) plan, through its
    raw entry: 64 or 128 rows, 1 .. the windows of a tile slices."""
    rows, split = plan
    UL, Npm, Jm = wmt.shape
    N = Npm - m
    assert rows in (64, 128) and 1 <= split <= K.ck_work(N, m, 64)
    out = torch.empty_like(acc)
    K._launch("ck_cmux_step64", a.device,
              a.data_ptr(), acc.data_ptr(), wmt.data_ptr(),
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
    """The chosen plan, both row tiles where their key ring fits (at J*m =
    768 only the 64-row one does) and forced window splits (one, two,
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
            if kp1 * l * m > 640 and plan[0] == 128:
                assert not K._occupancy("ck_cmux_step64_stages", 128,
                                        kp1 * l * m)
                continue
            got = _ck_cmux_step64_plan(da, dacc, dwmt, plan=plan, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), plan


def test_ck_cmux_step64_plan(cuda):
    """The plan: 128 rows above B = 64 where the ring holds two 32 KB key
    stages beside the two digit buffers, else 64 (CB_PAPER's J*m = 768
    leaves one stage at 128 rows); the C query of the ring's
    stages; a narrow batch splits its tiles' windows, and m = 2 (not a
    multiple of 4) has no plan."""
    assert K._occupancy("ck_cmux_step64_stages", 128, 640) == 2
    assert K._occupancy("ck_cmux_step64_stages", 64, 640) == 4
    assert K._occupancy("ck_cmux_step64_stages", 128, 1280) == 0
    assert K._occupancy("ck_cmux_step64_stages", 64, 1280) == 2
    assert K._occupancy("ck_cmux_step64_stages", 128, 768) == 0
    assert K._occupancy("ck_cmux_step64_stages", 64, 768) == 4
    plan = K.ck_cmux_step64_plan
    assert plan(256, 2, 2048, 64, 640, 6, 1, cuda)[0] == 128
    assert plan(256, 2, 2048, 64, 768, 8, 2, cuda)[0] == 64   # CB_PAPER
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
    (64 bits) engine, and launches materialize_wt once, and
    mm_recombine_acc_wt once a digit plane at 32 bits."""
    from tfhe_tpu_torch.ops import engine
    cfg = engine.EngineConfig(N=N, out_bits=bits, digit_bits=digit_bits,
                              key_limbs=key_limbs)
    x, key = _engine_case(np.random.default_rng(B + N), bits, digit_bits, B,
                          J, U, N)
    eng = engine.make_engine(cfg, backend)
    want = eng.accumulate(x, eng.prepare(key))
    prep = eng.prepare(key.to(cuda))
    before = _launches()
    got = eng.accumulate(x.to(cuda), prep)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if backend.startswith("conv"):
        n = _launched(before)
        assert (n.get("materialize_w", 0),
                n.get("materialize_wt", 0)) == (0, 1)
        assert n.get("mm_recombine_acc_wt", 0) == (cfg.plane_split[1]
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
    before = _launches()
    got = circuit.circuit_bootstrap(ct.to(cuda), ck.data, CB_TOY,
                                    backend="conv")
    assert torch.equal(got.cpu(), want)
    assert _launched(before)["materialize_wt"] > 0


def test_reference_e2e_rotations(cuda):
    """The two 500-step CB_ACTIVE rotations of the patched PoC on the card,
    bit for bit against tests/fixtures/ref_e2e_exact and within the phase
    envelope of ref_e2e_fft (tests/test_torch_reference.py)."""
    from test_torch_reference import e2e_rotations_check
    e2e_rotations_check(cuda)


# ---------------------------------------------------------------------------
# the device guard, and the captured programs (tfhe_tpu_torch.graphs)
# ---------------------------------------------------------------------------

def test_launch_sets_the_tensors_device_and_takes_its_stream(cuda):
    """A wrapper launches with its tensors' device current and on that
    device's current stream: with the device set explicitly, and on a side
    stream the caller made current.  (The wrong-card case needs two cards.)"""
    v = _i8(np.random.default_rng(1), (3, 6, 2, 2048))
    want = K.materialize_w_plain(v)
    dv = v.to("cuda:0")
    with torch.cuda.device(0):
        got = K.materialize_w(dv)
    side = torch.cuda.Stream(device=0)
    side.wait_stream(torch.cuda.current_stream(0))
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)       # the side stream is busy
        on_side = K.materialize_w(dv)
        done = torch.cuda.Event()
        done.record(side)
    assert not done.query()                 # queued behind the sleep
    side.synchronize()
    assert torch.equal(got.cpu(), want) and torch.equal(on_side.cpu(), want)


def _graph_counters():
    c = obs.report()["counters"]
    return c.get("graph.captures", 0), c.get("graph.replays", 0)


def _graphed_against_eager(fn, inputs):
    """fn on each input tuple, graphed (the first call captures, the rest
    replay) and under graphs.disable(): equal results bit for bit; a
    replay launches (counts) what an eager call launches; no result is
    another's storage or changes after a later call."""
    from tfhe_tpu_torch import graphs
    graphs.clear()
    captures, replays = _graph_counters()
    outs, kept = [], []
    for i, args in enumerate(inputs):
        before = _launches()
        out = fn(*args)
        torch.cuda.synchronize()
        graphed = _launched(before)
        before = _launches()
        with graphs.disable():
            want = fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, want), i
        assert graphed == _launched(before), i
        assert sum(graphed.values()) > 0
        outs.append(out)
        kept.append(out.clone())
    assert len({o.data_ptr() for o in outs}) == len(outs)
    for o, k in zip(outs, kept):
        assert torch.equal(o, k)
    c, r = _graph_counters()
    return c - captures, r - replays, graphs.stats()


def _toy_gate(cuda, backend, seed=5):
    rng = TfheRng(seed)
    sk = gate.SecretKey.generate(GATE_TOY, rng)
    ck = gate.CloudKey.generate(sk, rng, backend=backend, device=cuda)
    return rng, sk, ck


@pytest.mark.parametrize("backend", ["onthefly", "matmul", "conv", "fft_f64",
                                     "nussbaumer", "fft_dd"])
def test_graphed_blind_rotation(cuda, backend):
    """blind_rotate runs its whole loop as one graph per shape and key
    (fft_dd stays eager: graphs.EAGER_BACKENDS)."""
    from tfhe_tpu_torch import graphs
    from tfhe_tpu_torch.boot import blind_rotate as br
    _, _, ck = _toy_gate(cuda, backend)
    p = GATE_TOY.tgsw
    r = np.random.default_rng(3)
    inputs = [(_i32(r, (7, 2, 64)).to(cuda),
               torch.from_numpy(r.integers(0, 128, (7, GATE_TOY.lwe.n))
                                .astype(np.int32)).to(cuda))
              for _ in range(3)]
    captures, replays, stats = _graphed_against_eager(
        lambda acc, abar: br.blind_rotate(acc, ck.data["bk"], abar, p,
                                          backend), inputs)
    if backend in graphs.EAGER_BACKENDS:
        assert (captures, replays, stats) == (0, 0, [])
    else:
        assert (captures, replays) == (1, 2)
        assert stats[0]["site"] == "blind_rotate"
        assert stats[0]["nodes"] is None or stats[0]["nodes"] > 0


def test_graphed_bootstrap_fn(cuda):
    """make_bootstrap_fn is one graph; bootstrap.launches counts each
    call once, outside it."""
    rng, sk, ck = _toy_gate(cuda, "onthefly")
    boot = gate.make_bootstrap_fn(GATE_TOY, backend="onthefly")
    bits = [np.random.default_rng(i).integers(0, 2, 9) for i in range(3)]
    cts = [gate.encrypt_bool(sk, b, rng, device=cuda) for b in bits]
    before = obs.report()["counters"].get("bootstrap.launches", 0)
    captures, replays, stats = _graphed_against_eager(
        lambda ct: boot(ck.data, ct), [(ct,) for ct in cts])
    assert (captures, replays) == (1, 2) and stats[0]["site"] == "bootstrap"
    assert obs.report()["counters"]["bootstrap.launches"] - before == 6
    for b, ct in zip(bits, cts):
        assert (gate.decrypt_bool(sk, boot(ck.data, ct))
                == b.astype(bool)).all()


@pytest.mark.parametrize("env", [{}, {"TFHE_CK64_PATH": "acc"},
                                 {"TFHE_CK64_PATH": "sacc"},
                                 {"TFHE_CK64_FUSED": "1"}])
def test_graphed_circuit_bootstrap_staged(cuda, monkeypatch, env):
    """The staged circuit bootstrap: programs A, B (one for every level)
    and C (one per z, on its key slice), equal to the eager run and to the
    CPU's TRGSWs."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ck, ct = _cb_toy(cuda)
    cpu_ck, cpu_ct = _cb_toy("cpu")
    cb = circuit.make_circuit_bootstrap_staged(CB_TOY)
    other = torch.flip(ct, dims=(0,)).contiguous()
    captures, replays, stats = _graphed_against_eager(
        lambda x: cb(x, ck.data), [(ct,), (other,), (ct,)])
    assert sorted(s["site"] for s in stats) == \
        ["circuit.a", "circuit.b", "circuit.c", "circuit.c"]
    assert captures == 4
    assert torch.equal(cb(ct, ck.data).cpu(),
                       circuit.circuit_bootstrap(cpu_ct, cpu_ck.data, CB_TOY))


def test_traced_circuit_bootstrap_stream_spans(cuda):
    """Under torch.profiler the graphed staged circuit bootstrap's program
    spans (A, B a level, C a row block) all carry stream times, which sum
    within 5% of the call's synchronised wall (CB_TOY with 400 lvl0 steps,
    so that the card's work outweighs the host's between programs).  A
    capture while the profiler records succeeds and holds the nodes of a
    capture without it: no event was recorded into the graph.  No span
    appears on the card's timeline (a user annotation would: the device
    time readers would count it as busy)."""
    import dataclasses
    import time
    from torch.profiler import ProfilerActivity, profile
    from tfhe_tpu_torch import graphs
    P = dataclasses.replace(CB_TOY, n_lvl0=400)
    ck, ct = _cb_toy(cuda, P)
    cb = circuit.make_circuit_bootstrap_staged(P, shared_rotation=False)
    graphs.clear()
    want = cb(ct, ck.data)
    nodes = sorted((s["site"], s["nodes"]) for s in graphs.stats())
    before = _launches()
    cb(ct, ck.data)
    torch.cuda.synchronize()
    launches = _launched(before)
    graphs.clear()
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        first = cb(ct, ck.data)                      # captures
        torch.cuda.synchronize()
        before = _launches()
        t0 = time.perf_counter()
        got = cb(ct, ck.data)                        # replays
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        traced_launches = _launched(before)
    assert torch.equal(first, want) and torch.equal(got, want)
    assert sorted((s["site"], s["nodes"]) for s in graphs.stats()) == nodes
    assert traced_launches == launches
    recs = obs.spans()
    last = [r for r in recs if r["name"] == "circuit.bootstrap"][-1]
    progs = [r for r in recs if r["parent"] == last["id"]]
    assert [r["name"] for r in progs] == (
        ["graph.circuit.a"] + ["graph.circuit.b"] * 2
        + ["graph.circuit.c"] * 4)
    stream_ms = sum(r["stream_end_ms"] - r["stream_start_ms"] for r in progs)
    assert stream_ms == pytest.approx(wall_ms, rel=0.05)
    assert "stream_ms_total" in obs.report()["spans"]["graph.circuit.b"]
    names = {r["name"] for r in recs}
    on_card = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert on_card and not names & set(on_card)
    graphs.clear()
    obs.reset()


@pytest.mark.parametrize("chain", ["1", "4"])
def test_graphed_circuit_evaluate(cuda, monkeypatch, chain):
    """evaluate's launches (TFHE_WAVE_CHAIN=1) and chains (=4) as graphs:
    equal to eager and to the CPU's ciphertexts, compiles counted as on
    the CPU."""
    from tfhe_tpu_torch import graphs
    from tfhe_tpu_torch.runtime import scheduler
    monkeypatch.setenv("TFHE_WAVE_CHAIN", chain)
    name = "circuit.wave_compiles" if chain == "1" else \
        "circuit.chain_compiles"
    circ, outs = scheduler.ripple_carry_adder(4)
    rng, sk, ck = _toy_gate(cuda, "onthefly", seed=9)
    bits = np.random.default_rng(4).integers(0, 2, (8, 3))
    cts = torch.stack([gate.encrypt_bool(sk, b, rng, device=cuda)
                       for b in bits])
    compiles = {}
    cpu_data = _toy_gate("cpu", "onthefly", seed=9)[2].data
    for dev, data in (("cpu", cpu_data), ("cuda", ck.data)):
        graphs.clear()
        obs.reset()
        got = scheduler.evaluate(circ, cts.to(dev), data, GATE_TOY, outs,
                                 backend="onthefly")
        compiles[dev] = obs.report()["counters"][name]
        if dev == "cpu":
            want = got
    assert compiles["cpu"] == compiles["cuda"] > 0
    assert torch.equal(got.cpu(), want)
    captures, replays, _ = _graphed_against_eager(
        lambda x: scheduler.evaluate(circ, x, ck.data, GATE_TOY, outs,
                                     backend="onthefly"), [(cts,), (cts,)])
    assert captures == compiles["cuda"] and replays >= captures


def test_graphed_comparator32_default(cuda):
    """comparator(32) at GATE_DEFAULT over 16 instances (the benchmark
    cell's netlist and key at a sixteenth of its instances): graphed
    against eager bit for bit, decrypting to lt, eq and gt; an evaluation
    counts 5 MUX launches (one a MUX wave), 31 x 16 MUX gates, and 7
    binary + 2 x 5 bootstrap launches."""
    from tfhe_tpu_torch.params import GATE_DEFAULT
    from tfhe_tpu_torch.runtime import scheduler
    circ, outs = scheduler.comparator(32)
    rng = TfheRng(27)
    sk = gate.SecretKey.generate(GATE_DEFAULT, rng)
    ck = gate.CloudKey.generate(sk, rng, backend="onthefly", device=cuda)
    r = np.random.default_rng(27)
    inputs, plain = [], []
    for _ in range(2):
        x, y = r.integers(0, 1 << 32, (2, 16), dtype=np.uint64)
        y[:4] = x[:4]                                   # four equal pairs
        bits = np.stack([(v >> np.uint64(i)) & np.uint64(1)
                         for v in (x, y) for i in range(32)])  # (64, 16)
        inputs.append((torch.stack([gate.encrypt_bool(sk, b, rng,
                                                      device=cuda)
                                    for b in bits]),))
        plain.append(np.stack([x < y, x == y, x > y]))
    obs.reset()
    captures, replays, _ = _graphed_against_eager(
        lambda x: scheduler.evaluate(circ, x, ck.data, GATE_DEFAULT, outs,
                                     backend="onthefly"), inputs)
    assert captures > 0 and replays > 0
    c = obs.report()["counters"]
    assert (c["circuit.mux_launches"], c["circuit.mux_gates"]) == \
        (4 * 5, 4 * 31 * 16)
    assert c["bootstrap.launches"] == 4 * (7 + 2 * 5)
    assert c["bootstrap.ciphertexts"] == 4 * 189 * 16
    for (cts,), want in zip(inputs, plain):
        got = scheduler.evaluate(circ, cts, ck.data, GATE_DEFAULT, outs,
                                 backend="onthefly")
        dec = np.stack([gate.decrypt_bool(sk, got[i]) for i in range(3)])
        np.testing.assert_array_equal(dec, want)
    obs.reset()


def test_graphed_rotation_inside_an_outer_capture(cuda):
    """Inside a capture the caller began, blind_rotate records its loop
    into that graph (no program of its own)."""
    from tfhe_tpu_torch import graphs
    from tfhe_tpu_torch.boot import blind_rotate as br
    _, _, ck = _toy_gate(cuda, "onthefly")
    p = GATE_TOY.tgsw
    r = np.random.default_rng(6)
    acc = _i32(r, (5, 2, 64)).to(cuda)
    abar = torch.from_numpy(r.integers(0, 128, (5, GATE_TOY.lwe.n))
                            .astype(np.int32)).to(cuda)
    with graphs.disable():
        want = br.blind_rotate(acc, ck.data["bk"], abar, p, "onthefly")
    graphs.clear()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with graphs.disable():
            br.blind_rotate(acc, ck.data["bk"], abar, p, "onthefly")
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        out = br.blind_rotate(acc, ck.data["bk"], abar, p, "onthefly")
    assert graphs.stats() == []
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_a_failed_capture_raises(cuda):
    """A program that cannot be captured (it synchronizes the host) raises
    (a RuntimeError; torch.AcceleratorError in recent PyTorch) instead of
    running eagerly; in a process of its own, so the failed capture cannot
    touch this one."""
    import subprocess
    import sys
    code = (
        "import torch\n"
        "from tfhe_tpu_torch import graphs\n"
        "x = torch.ones(4, device='cuda')\n"
        "def fn(x):\n"
        "    y = x + 1\n"
        "    torch.cuda.synchronize()\n"
        "    return y\n"
        "try:\n"
        "    graphs.run('test', (), fn, (x,))\n"
        "except RuntimeError as e:\n"
        "    print('raised', type(e).__name__)\n"
        "else:\n"
        "    print('ran')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.stdout.startswith("raised "), proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# the multi-device layer (tfhe_tpu_torch.parallel): two gloo ranks on cuda:0
# ---------------------------------------------------------------------------

_EXTREMES = {torch.int32: [-2**31, 2**31 - 1, -2**31, 2**31 - 1, 7],
             torch.int64: [-2**63, 2**63 - 1, -2**63, 2**63 - 1, 7 << 40]}


def _card_rank(out: str):
    """One rank of test_sharded_on_card (gloo on cuda:0): GATE_TOY at (dp,
    ep) = (1, 2) and (2, 1) and (dp, tp) = (1, 2); CB_TOY chunked and conv
    at (1, 2), each rank's bk slice built from the raw rows; the exact
    all-reduce at the extremes on CUDA tensors.  Rows and launch counts go
    to ``out``."""
    import json
    from pathlib import Path
    from tfhe_tpu_torch.parallel import mesh as gmesh, multihost, shard
    out = Path(out)
    multihost.initialize(backend="gloo", device="cuda:0")
    rank = torch.distributed.get_rank()
    rng = TfheRng(3)
    sk = gate.SecretKey.generate(GATE_TOY, rng)
    ck = gate.CloudKey.generate(sk, rng, backend="onthefly")
    ct = torch.from_numpy(np.load(out / "ct.npy"))
    counts = {}
    for name, (make, dp, other) in {"ep-1x2": (shard.make_mesh, 1, 2),
                                    "ep-2x1": (shard.make_mesh, 2, 1),
                                    "tp-1x2": (gmesh.make_mesh, 1, 2)}.items():
        m = make(2, dp, other)
        mod = shard if make is shard.make_mesh else gmesh
        fn, place = mod.make_sharded_bootstrap_fn(GATE_TOY, m, "onthefly")
        before = _launches()
        rows = fn(*place(ck.data, ct))
        torch.cuda.synchronize()
        counts[name] = _launched(before)
        np.save(out / f"{name}-r{rank}.npy", rows.cpu().numpy())
    cct = torch.from_numpy(np.load(out / "cct.npy"))
    m = shard.make_mesh(2, dp=1, ep=2)
    for backend in ("chunked", "conv"):
        crng = TfheRng(42)
        csk = circuit.CircuitSecretKey.generate(CB_TOY, crng)
        cck = circuit.CircuitCloudKey.generate(csk, crng, backend=backend,
                                               prepare_bk=False)
        fn, place = shard.make_sharded_circuit_bootstrap_fn(CB_TOY, m,
                                                            backend)
        kd, rows = place(cck.data, cct, bk_raw=cck.bk_raw)
        before = _launches()
        gsw = fn(kd, rows)
        torch.cuda.synchronize()
        counts[backend] = _launched(before)
        np.save(out / f"cb-{backend}-r{rank}.npy", gsw.cpu().numpy())
    for dtype, vals in _EXTREMES.items():
        t = torch.tensor(vals, dtype=dtype, device="cuda:0")
        got = m.all_reduce(t if rank == 0 else t.flip(0), "ep")
        np.save(out / f"reduce-{str(dtype)[6:]}-r{rank}.npy", got.cpu().numpy())
    (out / f"counts-r{rank}.json").write_text(json.dumps(counts))
    torch.distributed.destroy_process_group()


def test_sharded_on_card(cuda, tmp_path):
    """Two gloo ranks sharing cuda:0 give the one-process rows bit for bit
    on every mesh, through the card's kernels (the generic step's three a
    rotation step on every rank), and the exact all-reduce gives the
    wrapped sums of CUDA tensors."""
    import json
    import sys
    from pathlib import Path
    from tfhe_tpu_torch import lwe
    from tfhe_tpu_torch.parallel import multihost
    rng = TfheRng(3)
    sk = gate.SecretKey.generate(GATE_TOY, rng)
    ck = gate.CloudKey.generate(sk, rng, backend="onthefly", device=cuda)
    bits = np.random.default_rng(5).integers(0, 2, 24)
    ct = gate.encrypt_bool(sk, bits, TfheRng(7), device=cuda)
    want = gate.bootstrap(ct, ck.data, GATE_TOY, backend="onthefly").cpu()
    np.save(tmp_path / "ct.npy", ct.cpu().numpy())
    crng = TfheRng(42)
    csk = circuit.CircuitSecretKey.generate(CB_TOY, crng)
    msgs = np.where(np.random.default_rng(6).integers(0, 2, 20) == 1,
                    -(1 << 31), 0).astype(np.int32)
    cwant = {}
    for backend in ("chunked", "conv"):
        rng2 = TfheRng(42)
        circuit.CircuitSecretKey.generate(CB_TOY, rng2)
        cck = circuit.CircuitCloudKey.generate(csk, rng2, backend=backend,
                                               device=cuda)
        cct = lwe.encrypt(csk.lwe_lvl1, msgs, TfheRng(8), 2.0**-20,
                          device=cuda)
        cwant[backend] = circuit.circuit_bootstrap(cct, cck.data, CB_TOY,
                                                   backend=backend).cpu()
        del cck
    np.save(tmp_path / "cct.npy", cct.cpu().numpy())
    repo = Path(__file__).resolve().parent.parent
    multihost.launch(
        [sys.executable, "-c", "import sys; sys.path.insert(0, 'tests'); "
         f"import test_torch_cuda as t; t._card_rank({str(tmp_path)!r})"],
        2, coordinator_address=f"file://{tmp_path}/store",
        env={"PYTHONPATH": str(repo)}, timeout=600)
    for rank in range(2):
        def rows(name):
            return torch.from_numpy(np.load(tmp_path / f"{name}-r{rank}.npy"))
        assert torch.equal(rows("ep-1x2"), want)
        assert torch.equal(rows("tp-1x2"), want)
        assert torch.equal(rows("ep-2x1"), want[rank * 12:(rank + 1) * 12])
        for backend in ("chunked", "conv"):
            assert torch.equal(rows(f"cb-{backend}"), cwant[backend]), backend
        counts = json.loads((tmp_path / f"counts-r{rank}.json").read_text())
        from tfhe_tpu_torch import noise
        shared = (noise.shared_rotation_penalty(CB_TOY)
                  <= noise.SHARED_ROTATION_MAX_PENALTY)
        n = GATE_TOY.lwe.n
        n0 = CB_TOY.n_lvl0 * (1 if shared else CB_TOY.tgsw_lvl1.l)
        for name in ("ep-1x2", "ep-2x1"):
            for k in ("rotate_decompose", "materialize_wt",
                      "mm_recombine_acc_wt"):
                assert counts[name][k] == n, (name, k)
        # GATE_TOY's N=64 is outside the fused kernel's domain: the tp
        # rank's whole-key rotation takes the generic step too
        assert counts["tp-1x2"]["mm_recombine_acc_wt"] == n
        assert counts["chunked"]["rotate_decompose64"] == n0
        assert counts["chunked"]["ck_dot64p"] == n0
        assert counts["conv"]["materialize_wt"] == n0
        for dtype, vals in _EXTREMES.items():
            bits = 64 if dtype == torch.int64 else 32
            total = [a + b for a, b in zip(vals, vals[::-1])]
            wrapped = [((t + (1 << (bits - 1))) % (1 << bits))
                       - (1 << (bits - 1)) for t in total]
            got = np.load(tmp_path / f"reduce-{str(dtype)[6:]}-r{rank}.npy")
            assert got.tolist() == wrapped, dtype


# ---------------------------------------------------------------------------
# priv_keyswitch: program C's kernel on the packed privKS table
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _privks_table(name: str):
    """A seeded random packed table of one z on the card at CB_ACTIVE's or
    CB_PAPER's shape: (4, 2048, kstride) int8, K' = privks_depth columns,
    the pad zero."""
    from tfhe_tpu_torch.params import CB_ACTIVE, CB_PAPER
    P = {"active": CB_ACTIVE, "paper": CB_PAPER}[name]
    ks, n1 = P.ks21, P.n_lvl2 + 1
    kq = K.privks_depth(n1, ks.t, ks.basebit)
    g = torch.Generator(device="cuda").manual_seed(len(name))
    table = torch.zeros((4, 2 * P.n_lvl1, -(-kq // 16) * 16),
                        dtype=torch.int8, device="cuda")
    table[..., :kq] = torch.randint(-128, 128, (4, 2 * P.n_lvl1, kq),
                                    dtype=torch.int8, device="cuda",
                                    generator=g)
    return ks, n1, table


def _lwe64(seed, B, n1, dev):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(-2**63, 2**63, (B, n1),
                                       dtype=np.int64)).to(dev)


@pytest.mark.parametrize("B", [1, 4, 64, 256])
@pytest.mark.parametrize("name", ["active", "paper"])
def test_priv_keyswitch(cuda, name, B):
    """At CB_ACTIVE's (t=10, base 8, K' = 143,430) and CB_PAPER's (t=32,
    base 2, K' = 65,568) shapes: the kernel equals its plain version (run on
    the card), eager and as a captured graph's replay."""
    ks, n1, table = _privks_table(name)
    x = _lwe64(B, B, n1, cuda)
    kw = dict(t=ks.t, basebit=ks.basebit)
    want = K.priv_keyswitch_plain(x, table, **kw)
    assert torch.equal(K.priv_keyswitch(x, table, **kw), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.priv_keyswitch(x, table, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.priv_keyswitch(x, table, **kw)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("B, split", [(4, 1), (4, 2), (4, 7), (4, 1121),
                                      (256, 1), (256, 3), (100, 33)])
def test_priv_keyswitch_forced_splits(cuda, B, split):
    """Forced K splits at CB_ACTIVE's shape, from one slice to one stage a
    slice (1,121), and 128-row blocks of a ragged batch (100)."""
    ks, n1, table = _privks_table("active")
    x = _lwe64(split, B, n1, cuda)
    kw = dict(t=ks.t, basebit=ks.basebit)
    assert torch.equal(K.priv_keyswitch(x, table, split=split, **kw),
                       K.priv_keyswitch_plain(x, table, **kw))


@pytest.mark.parametrize("name", ["active", "paper"])
def test_priv_keyswitch_extremes(cuda, name):
    """Every digit 0 gives 0; every digit base-1 against a table of -128 or
    127 drives each limb's int32 sum to n1 t (-128 or 127), its bound."""
    ks, n1, table = _privks_table(name)
    kw = dict(t=ks.t, basebit=ks.basebit)
    off = 1 << (63 - ks.basebit * ks.t)
    zero = torch.full((5, n1), -off, dtype=torch.int64, device=cuda)
    assert not K.priv_keyswitch(zero, table, **kw).any()
    top = torch.full((70, n1), -1 - off, dtype=torch.int64, device=cuda)
    for v in (-128, 127):
        full = torch.full_like(table, v)
        assert torch.equal(K.priv_keyswitch(top, full, **kw),
                           K.priv_keyswitch_plain(top, full, **kw))
        del full


@pytest.mark.parametrize("P", [CB_TOY, CB_PAPER_TOY], ids=["toy", "paper"])
def test_program_c_runs_the_kernel(cuda, monkeypatch, P):
    """Program C is the kernel: the packed table built on the card equals
    the CPU's; a replayed staged launch counts kernel.priv_keyswitch and
    one plan counter l1 (k+1) times (4 at CB_TOY, 8 at CB_PAPER_TOY) and
    equals the CPU's TRGSWs; an eager launch calls torch._int_mm for preKS's
    4 limbs alone."""
    from tfhe_tpu_torch import graphs
    ck, ct = _cb_toy(cuda, P)
    cpu_ck, cpu_ct = _cb_toy("cpu", P)
    want = circuit.circuit_bootstrap(cpu_ct, cpu_ck.data, P)
    assert torch.equal(ck.data["privks_packed"].cpu(),
                       cpu_ck.data["privks_packed"])
    cb = circuit.make_circuit_bootstrap_staged(P)
    cb(ct, ck.data)                                  # captures
    before = dict(obs.report()["counters"])
    got = cb(ct, ck.data)                            # replays
    torch.cuda.synchronize()
    delta = {k: v - before.get(k, 0)
             for k, v in obs.report()["counters"].items()
             if k.startswith("priv_keyswitch.plan.")
             or k == "kernel.priv_keyswitch"}
    n = P.tgsw_lvl1.l * (P.lvl1.k + 1)
    plans = {k: v for k, v in delta.items() if v and k.startswith("priv")}
    assert delta["kernel.priv_keyswitch"] == n
    assert list(plans.values()) == [n]
    assert torch.equal(got.cpu(), want)
    calls = []
    real = torch._int_mm
    monkeypatch.setattr(torch, "_int_mm",
                        lambda *a: calls.append(a) or real(*a))
    with graphs.disable():
        assert torch.equal(cb(ct, ck.data).cpu(), want)
    assert len(calls) == 4


def test_program_c_needs_the_packed_table(cuda):
    ck, ct = _cb_toy(cuda)
    data = {k: v for k, v in ck.data.items() if k != "privks_packed"}
    with pytest.raises(ValueError, match="privks_packed"):
        circuit.circuit_bootstrap(ct, data, CB_TOY)


# --- lut_cmux: a level of the batched LUT tree (models/lut.py) ---

def _lut_level(seed, G, S, shared, extreme=False, l=2):
    """A tree level at the CB blocks' lvl1 shapes: acc (G, 2S, 2, 1024) (an
    expand of one group's rows where ``shared``: the leaves) and G
    selectors (G, 2, l, 2, 1024), on the card."""
    r = np.random.default_rng(seed)
    N = 1024
    if extreme:                      # every value at the torus' ends
        pick = lambda shape: torch.from_numpy(r.choice(  # noqa: E731
            np.array([-2**31, 2**31 - 1, -1, 0, 1], np.int32), shape))
    else:
        pick = lambda shape: _i32(r, shape)  # noqa: E731
    acc = pick((2 * S, 2, N)).expand(G, 2 * S, 2, N) if shared \
        else pick((G, 2 * S, 2, N))
    return acc.cuda(), pick((G, 2, l, 2, N)).cuda()


@pytest.mark.parametrize("block,G,S,shared", [
    ("CB_ACTIVE", 1, 8, True), ("CB_ACTIVE", 4, 8, True),
    ("CB_ACTIVE", 64, 8, True), ("CB_ACTIVE", 64, 4, False),
    ("CB_ACTIVE", 64, 1, False), ("CB_ACTIVE", 256, 8, True),
    ("CB_ACTIVE", 3, 12, False), ("CB_PAPER", 64, 8, True),
    ("CB_PAPER", 5, 3, False)])
def test_lut_cmux(cuda, block, G, S, shared):
    """The kernel against its plain version (run on the card: its float64
    sums are exact there too) at the CB blocks' lvl1 shapes (CB_ACTIVE l =
    2; CB_PAPER l = 4: 8 digit polynomials), 1 to 256 groups; the chosen
    plan is counted."""
    from tfhe_tpu_torch import params
    p = getattr(params, block).tgsw_lvl1
    acc, sel = _lut_level(G * 10 + S, G, S, shared, l=p.l)
    kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset)
    before = dict(obs.report()["counters"])
    got = K.lut_cmux(acc, sel, **kw)
    torch.cuda.synchronize()
    plan = f"lut_cmux.plan.r8.t{K.lut_cmux_plan(1024)}"
    assert obs.report()["counters"][plan] - before.get(plan, 0) == 1
    assert torch.equal(got, K.lut_cmux_plain(acc, sel, **kw))


@pytest.mark.parametrize("tiles", [1, 4])
@pytest.mark.parametrize("extreme", [False, True])
def test_lut_cmux_forced_plans(cuda, tiles, extreme):
    """Every plan through the raw entry, on random and extreme values."""
    from tfhe_tpu_torch.params import CB_ACTIVE
    p = CB_ACTIVE.tgsw_lvl1
    G, S = 5, 6
    acc, sel = _lut_level(tiles, G, S, False, extreme)
    out = torch.empty((G, S, 2, 1024), dtype=torch.int32, device=cuda)
    K._launch("lut_cmux", acc.device, acc.data_ptr(), acc.stride(0),
              sel.data_ptr(), sel.stride(0), out.data_ptr(), G, S, 2, p.l,
              1024, p.bgbit, p.offset, tiles)
    torch.cuda.synchronize()
    assert torch.equal(out, K.lut_cmux_plain(acc, sel, l=p.l, bgbit=p.bgbit,
                                             offset=p.offset))


def test_graphed_lut_tree(cuda):
    """make_lut_staged on the card at CB_TOY: programs A, B, C and the tree
    (one graph, k lut_cmux launches a replay), equal to the eager run and
    to the CPU's answers."""
    from tfhe_tpu_torch.models import lut
    answers = {}
    for dev in ("cpu", cuda):
        rng = TfheRng(9)
        sk = circuit.CircuitSecretKey.generate(CB_TOY, rng)
        ck = circuit.CircuitCloudKey.generate(sk, rng, device=dev)
        bits = np.random.default_rng(2).integers(0, 2, 12)
        msgs = np.where(bits.astype(bool), -(1 << 31), 0).astype(np.int32)
        ct = lwe.encrypt(sk.lwe_lvl1, msgs, rng, 2.0**-20, device=dev)
        table = torch.from_numpy(np.random.default_rng(3).integers(
            -2**31, 2**31, (16, 64)).astype(np.int32)).to(dev)
        leaves = lut.pack_table(table, 64)
        fn = lut.make_lut_staged(CB_TOY, "chunked", 4)
        if dev == "cpu":
            answers[dev] = fn(ct, ck.data, leaves)
            continue
        other = torch.flip(ct, dims=(0,)).contiguous()
        captures, replays, stats = _graphed_against_eager(
            lambda x: fn(x, ck.data, leaves), [(ct,), (other,), (ct,)])
        assert "lut.tree" in {s["site"] for s in stats}
        before = _launches()
        answers[dev] = fn(ct, ck.data, leaves).cpu()
        torch.cuda.synchronize()
        assert _launched(before)["lut_cmux"] == 4
    assert torch.equal(answers["cpu"], answers[cuda])
