"""The rotate-decompose digit emitters (kernels.rotate_decompose and
kernels.rotate_decompose64_ck with its flat entry): their plain versions
against the Pallas kernels (interpret mode) at the paths' full widths, and
the launch plan and domain the CUDA kernels (csrc/rotdec.cuh) share.

On the CPU the wrappers run their plain versions; the kernels themselves
are held against them on the card by tests/test_torch_cuda.py and
chip_smoke.py.  The plan's coverage is checked on a model of the kernels'
index arithmetic (every output byte written once, by a 16-byte aligned
run, with the byte the chunk layout puts there).  Tolerance 0 everywhere:
the digits are exact integer functions.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu.ops import i64pair, pallas_kernels as pk
from tfhe_tpu.params import (CB_ACTIVE, CB_MXU, GATE_DEFAULT, GATE_FAST2)
from tfhe_tpu_torch import params as tparams
from tfhe_tpu_torch import tgsw
from tfhe_tpu_torch.ops import engine, kernels as K

SMS = 132                               # the H100 SXM's SMs


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exponents(N, half):
    """The edge exponents, three at a time: identity, one step, the last
    step before X^N; then the pure sign flip, one past it, the last
    exponent."""
    return np.array([0, 1, N - 1] if half == 0 else [N, N + 1, 2 * N - 1],
                    np.int32)


def _acc64(r, shape):
    acc = r.integers(-2**63, 2**63, shape, dtype=np.int64)
    acc.reshape(-1)[:3] = [-2**63, 2**63 - 1, 0]
    return acc


# ---------------------------------------------------------------------------
# the plain versions at the paths' full widths, against interpret-mode Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("half", [0, 1])
@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("params", ["CB_MXU", "CB_ACTIVE"])
def test_rotate_decompose64_ck_full_width(params, flat, half):
    """CB_MXU's lvl2 shape (N=2048, k=1, l=5, Bg=2^8, one plane) and
    CB_ACTIVE's (l=4, Bg=2^9, two planes), m = 64, B = 3, through the
    U-major and the flat entry, with the edge exponents and the extreme
    accumulator words."""
    p = {"CB_MXU": CB_MXU, "CB_ACTIVE": CB_ACTIVE}[params].tgsw_lvl2
    N, kp1, B, m = p.tlwe.N, p.tlwe.k + 1, 3, 64
    P = 1 if p.bgbit <= 8 else 2
    r = np.random.default_rng(20 + half)
    acc = _acc64(r, (B, kp1, N))
    a = _exponents(N, half)
    kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset, m=m, planes=P)
    if flat:
        lo, hi = i64pair.from_i64(jnp.asarray(acc.reshape(B, -1)))
        want = pk.rotate_decompose64_ck_flat(jnp.asarray(a), lo, hi, N=N,
                                             interpret=True, **kw)
        got = K.rotate_decompose64_ck_flat(
            torch.from_numpy(a), torch.from_numpy(acc.reshape(B, -1)), N=N,
            **kw)
    else:
        lo, hi = i64pair.from_i64(jnp.moveaxis(jnp.asarray(acc), -2, 0))
        want = pk.rotate_decompose64_ck(jnp.asarray(a), lo, hi, tb=B,
                                        interpret=True, **kw)
        got = K.rotate_decompose64_ck(torch.from_numpy(a),
                                      torch.from_numpy(acc), **kw)
    jm = kp1 * p.l * m
    assert K.ck_width(jm) == jm              # no pad columns at these shapes
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if half == 0:
        assert not got[0].any()              # (X^0 - 1) * acc = 0 digits


@pytest.mark.parametrize("half", [0, 1])
@pytest.mark.parametrize("params", ["GATE_DEFAULT", "GATE_FAST2"])
def test_rotate_decompose_full_width(params, half):
    """GATE_DEFAULT's generic step (N=1024, k=1, l=3, Bg=2^7) and
    GATE_FAST2's shape (N=512, k=2), B = 3, the edge exponents and the
    extreme 32-bit words."""
    p = {"GATE_DEFAULT": GATE_DEFAULT, "GATE_FAST2": GATE_FAST2}[params].tgsw
    N, kp1, B = p.tlwe.N, p.tlwe.k + 1, 3
    r = np.random.default_rng(30 + half)
    acc = r.integers(-2**31, 2**31, (B, kp1, N)).astype(np.int32)
    acc.reshape(-1)[:3] = [-2**31, 2**31 - 1, 0]
    a = _exponents(N, half)
    kw = dict(l=p.l, bgbit=p.bgbit, offset=p.offset)
    want = pk.rotate_decompose(jnp.asarray(a), jnp.asarray(acc),
                               tb=B * kp1, interpret=True, **kw)
    got = K.rotate_decompose(torch.from_numpy(a), torch.from_numpy(acc),
                             **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the plan and the kernels' index arithmetic
# ---------------------------------------------------------------------------

def _blocks(B, kp1, N, plan):
    """(b, lo, hi, s, S) for every (block, row) of a launch: the work items
    [lo, hi) of batch row b that block (x, s) takes (csrc/rotdec.cuh)."""
    rows, split, threads = plan
    items = kp1 * N // 16
    for x in range(-(-B // rows)):
        for s in range(split):
            for y in range(rows):
                b = x * rows + y
                if b < B:
                    yield (b, s * items // split, (s + 1) * items // split,
                           s, split)


def _model64(B, kp1, N, l, m, P, plan):
    """The bytes rotate_decompose64_kernel writes for the chunk layout, by
    the kernel's own shifts and masks: (ids, writes) over the (B, C*P*ckp)
    output, each digit byte tagged with the id of its (b, j, n, p)."""
    ckp = K.ck_width(kp1 * l * m)
    jm, C = kp1 * l * m, N // m
    row = C * P * ckp
    logN, logm = N.bit_length() - 1, m.bit_length() - 1
    logI = logN - 4
    ids = np.zeros(B * row, np.int64)
    writes = np.zeros(B * row, np.int64)
    e = np.arange(16)
    for b, lo, hi, s, S in _blocks(B, kp1, N, plan):
        i = np.arange(lo, hi)
        u = i >> logI
        n0 = (i & ((1 << logI) - 1)) << 4
        for lv in range(l):
            for p in range(P):
                start = (b * row + ((n0 >> logm) * P + p) * ckp
                         + u * l * m + lv * m + (n0 & (m - 1)))
                assert (start % 16 == 0).all()
                addr = (start[:, None] + e).reshape(-1)
                j = np.repeat(u * l + lv, 16)
                n = (n0[:, None] + e).reshape(-1)
                np.add.at(writes, addr, 1)
                ids[addr] = 1 + ((b * kp1 * l + j) * N + n) * P + p
        for cp in range(s, C * P, S):
            for w in range((ckp - jm) >> 4):
                addr = b * row + cp * ckp + jm + 16 * w + e
                np.add.at(writes, addr, 1)
    return ids, writes


def _layout_ids64(B, kp1, N, l, m, P):
    """The same ids placed by kernels.ck_layout (the plain version's layout
    code): what each byte of the chunk layout must hold."""
    b, j, n, p = np.meshgrid(np.arange(B), np.arange(kp1 * l), np.arange(N),
                             np.arange(P), indexing="ij")
    ids = 1 + ((b * kp1 * l + j) * N + n) * P + p          # (B, J, N, P)
    planes = torch.from_numpy(np.moveaxis(ids, -1, 0).copy())
    return K.ck_layout(planes, m).numpy().reshape(-1)


def _model64_plain(B, kp1, N, l, P, plan):
    """The bytes the same kernel writes for rotate_decompose64's plain
    layout: (ids, writes) over the (B*(k+1), l*P, N) output, tagged as in
    _model64."""
    row = kp1 * l * P * N
    logN = N.bit_length() - 1
    logI = logN - 4
    ids = np.zeros(B * row, np.int64)
    writes = np.zeros_like(ids)
    e = np.arange(16)
    for b, lo, hi, s, S in _blocks(B, kp1, N, plan):
        i = np.arange(lo, hi)
        u = i >> logI
        n0 = (i & ((1 << logI) - 1)) << 4
        for lv in range(l):
            for p in range(P):
                start = (b * row + ((u * l * P) << logN) + n0
                         + lv * P * N + p * N)
                assert (start % 16 == 0).all()
                addr = (start[:, None] + e).reshape(-1)
                j = np.repeat(u * l + lv, 16)
                n = (n0[:, None] + e).reshape(-1)
                np.add.at(writes, addr, 1)
                ids[addr] = 1 + ((b * kp1 * l + j) * N + n) * P + p
    return ids, writes


def _model32(B, kp1, N, l, plan):
    """The bytes rotate_decompose_kernel writes: (ids, writes) over the
    (B, (k+1)*l, N) output, tagged with the id of (b, j, n)."""
    logN = N.bit_length() - 1
    logI = logN - 4
    ids = np.zeros(B * kp1 * l * N, np.int64)
    writes = np.zeros_like(ids)
    e = np.arange(16)
    for b, lo, hi, s, S in _blocks(B, kp1, N, plan):
        i = np.arange(lo, hi)
        u = i >> logI
        n0 = (i & ((1 << logI) - 1)) << 4
        for lv in range(l):
            start = b * l * kp1 * N + ((u * l + lv) << logN) + n0
            assert (start % 16 == 0).all()
            addr = (start[:, None] + e).reshape(-1)
            np.add.at(writes, addr, 1)
            ids[addr] = 1 + (b * kp1 * l + np.repeat(u * l + lv, 16)) * N \
                + (n0[:, None] + e).reshape(-1)
    return ids, writes


def _plans(B, kp1, N, word):
    chosen = K.rotdec_plan(B, kp1, N, word, SMS)
    t = chosen[2]
    return [chosen, (1, 1, t), (1, 3, t), (1, 7, 32), (2, 1, t), (4, 1, 32)]


@pytest.mark.parametrize("B,kp1,N,l,m,P", [
    (3, 2, 2048, 5, 64, 1), (2, 2, 2048, 4, 64, 2), (5, 3, 256, 4, 64, 2),
    (3, 2, 128, 3, 16, 1), (4, 2, 256, 5, 16, 2), (7, 2, 128, 5, 32, 1),
    (1, 2, 64, 3, 16, 1)])
def test_rotdec_plan_covers_the_chunk_layout_once(B, kp1, N, l, m, P):
    """Every byte of rotate_decompose64_ck's output, digit and pad column,
    is written exactly once, by a 16-byte aligned run, with the digit the
    chunk layout puts there, under the chosen plan and forced ones
    (ragged slices, several rows a block, a ragged last block); the pad
    shapes (J*m = 96, 160, 320) have their zeros written."""
    want = _layout_ids64(B, kp1, N, l, m, P)
    for plan in _plans(B, kp1, N, 8):
        ids, writes = _model64(B, kp1, N, l, m, P, plan)
        assert (writes == 1).all(), plan
        np.testing.assert_array_equal(ids, want)


@pytest.mark.parametrize("B,kp1,N,l,P", [
    (3, 2, 2048, 5, 1), (2, 2, 2048, 4, 2), (5, 3, 256, 4, 2),
    (1, 2, 64, 3, 1)])
def test_rotdec_plan_covers_the_plain_64bit_layout_once(B, kp1, N, l, P):
    """The same for rotate_decompose64's (B*(k+1), l*P, N) output, which
    rotate_decompose64_ck's kernel writes at the same plans."""
    b, j, n, p = np.meshgrid(np.arange(B), np.arange(kp1 * l), np.arange(N),
                             np.arange(P), indexing="ij")
    ids = 1 + ((b * kp1 * l + j) * N + n) * P + p          # (B, J, N, P)
    want = np.moveaxis(ids.reshape(B, kp1, l, N, P), -1, 3).reshape(-1)
    for plan in _plans(B, kp1, N, 8):
        ids, writes = _model64_plain(B, kp1, N, l, P, plan)
        assert (writes == 1).all(), plan
        np.testing.assert_array_equal(ids, want)


@pytest.mark.parametrize("B,kp1,N,l", [(3, 2, 1024, 3), (5, 3, 512, 3),
                                       (9, 2, 64, 3), (2, 2, 256, 4)])
def test_rotdec_plan_covers_the_32bit_layout_once(B, kp1, N, l):
    """The same for rotate_decompose's (B, (k+1)*l, N) output."""
    b, j, n = np.meshgrid(np.arange(B), np.arange(kp1 * l), np.arange(N),
                          indexing="ij")
    want = (1 + (b * kp1 * l + j) * N + n).reshape(-1)
    for plan in _plans(B, kp1, N, 4):
        ids, writes = _model32(B, kp1, N, l, plan)
        assert (writes == 1).all(), plan
        np.testing.assert_array_equal(ids, want)


@pytest.mark.parametrize("word", [4, 8])
@pytest.mark.parametrize("kp1", [2, 3])
def test_rotdec_plan_fits_the_card(kp1, word):
    """For N from 16 to 4096 and batches from 1 to 8192: a launchable block
    (whole warps, at most the kernels' 512 threads), its staged rows within
    MAX_SMEM, half the SMs given a block where the batch allows, no slice
    under a warp of work items, and rows sharing a block only where half
    the SMs still get one."""
    for logN in range(4, 13):
        N = 1 << logN
        items = kp1 * N // 16
        for B in (1, 3, 64, 100, 131, 132, 256, 1000, 8192):
            rows, split, threads = K.rotdec_plan(B, kp1, N, word, SMS)
            assert threads % 32 == 0 and 32 <= threads <= K.ROTDEC_THREADS
            assert rows * threads <= 512
            assert K.rotdec_smem(rows, kp1, N, word) <= K.MAX_SMEM
            assert split == 1 or 32 * split <= items
            blocks = -(-B // rows) * split
            target = -(-SMS // 2)
            assert blocks >= min(target, B * max(1, items // 32))
            assert rows == 1 or -(-B // rows) >= target


def test_rotdec_plans_at_the_paths_shapes():
    """The plans the paths' launches take on an H100 (132 SMs): CB_MXU B=256
    one row a block of 256 threads, B=100 too, B=1 and 3 eight slices a
    row; GATE_DEFAULT B=256 and GATE_FAST2 B=8192 two rows a block."""
    assert K.rotdec_plan(256, 2, 2048, 8, SMS) == (1, 1, 256)
    assert K.rotdec_plan(100, 2, 2048, 8, SMS) == (1, 1, 256)
    assert K.rotdec_plan(1, 2, 2048, 8, SMS) == (1, 8, 256)
    assert K.rotdec_plan(3, 2, 2048, 8, SMS) == (1, 8, 256)
    assert K.rotdec_plan(256, 2, 1024, 4, SMS) == (2, 1, 128)
    assert K.rotdec_plan(8192, 3, 512, 4, SMS) == (2, 1, 96)
    with pytest.raises(ValueError, match="shared memory"):
        K.rotdec_plan(1, 3, 16384, 8, SMS)


def test_every_shape_the_port_runs_is_in_the_domain():
    """The 64-bit steps' domains (the contractions' ck64_kernel_ok and the
    emitter's rotdec_ok) take CB_MXU, CB_ACTIVE and CB_TOY as the chunked
    engine prepares them, and the card tests' m = 32 at N = 128; the 32-bit
    emitter's takes every gate set's N, GATE_TOY's 64 included.  m = 8 and
    N = 8 are outside the emitter's: on a card the engine's two-kernel
    steps then refuse m = 8, which the contractions and the one-kernel
    step (ck_cmux_step64_ok) still take."""
    for P in (tparams.CB_MXU, tparams.CB_ACTIVE, tparams.CB_TOY):
        p = P.tgsw_lvl2
        cfg = tgsw.engine_config(p)
        eng = engine.ChunkedEngine(cfg)
        planes = cfg.plane_split[1]
        Jm = (p.tlwe.k + 1) * p.l * eng.m
        assert K.ck64_kernel_ok(p.tlwe.N, eng.m, Jm, planes)
        assert K.rotdec_ok(p.tlwe.N, eng.m)
    assert K.ck64_kernel_ok(128, 32, 2 * 5 * 32, 1)
    for G in (tparams.GATE_DEFAULT, tparams.GATE_FAST2, tparams.GATE_MXU,
              tparams.GATE_TOY):
        assert K.rotdec_ok(G.tgsw.tlwe.N, 16)
    assert not K.rotdec_ok(128, 8) and not K.rotdec_ok(8, 16)
    assert K.ck64_kernel_ok(128, 8, 2 * 5 * 8, 1)
    p = tparams.CB_TOY.tgsw_lvl2
    eng = engine.ChunkedEngine(tgsw.engine_config(p), m=8)
    Jm = (p.tlwe.k + 1) * p.l * 8
    card = torch.empty(0, device="meta")        # any device but the CPU
    assert not eng._ck64_ok(card, Jm, 2)
    assert eng._ck64_ok(card, Jm, 2, fused=True)
    assert eng._ck64_ok(torch.empty(0), Jm, 2)


def test_wrappers_take_the_plain_version_on_the_cpu_outside_the_domain():
    """m = 8 is outside the kernel's domain, but a CPU tensor still runs the
    plain version (the card raises: tests/test_torch_cuda.py)."""
    r = np.random.default_rng(3)
    acc = torch.from_numpy(r.integers(-2**63, 2**63, (2, 2, 64),
                                      dtype=np.int64))
    a = torch.tensor([5, 70], dtype=torch.int32)
    got = K.rotate_decompose64_ck(a, acc, l=4, bgbit=8, offset=0, m=8)
    assert torch.equal(got, K.rotate_decompose64_ck_plain(
        a, acc, l=4, bgbit=8, offset=0, m=8))
