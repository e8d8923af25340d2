"""materialize_w (both entries) and the v1 fused step: the launch plans
their CUDA kernels take, models of the kernels' index arithmetic, and the
library yardstick chip_smoke.py times beside materialize_w.

On the CPU the wrappers run their plain versions; the kernels themselves are
held against those on the card by tests/test_torch_cuda.py and
chip_smoke.py.  The models replay what each thread of a kernel reads and
writes (csrc/materialize_w.cu: the 16 byte-shifted staged copies and the
aligned runs; csrc/fused_cmux_step_v1.cu: the in-kernel transpose of a TMA
box into wgmma's K-major tile, its shared-memory banks, and the walk over
groups of levels), with __byte_perm's semantics, and must give the plain
version's bytes.  Tolerance 0 everywhere: these are exact byte functions.
"""

import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu.ops import pallas_kernels as pk
from tfhe_tpu_torch.ops import kernels as K

REPO = Path(__file__).resolve().parents[1]
SMS = 132                               # the H100 SXM's SMs


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _v(shape, seed=0):
    L, J, U, N = shape
    return np.random.default_rng(seed).integers(
        -128, 128, (L, J, U, 2 * N)).astype(np.int8)


def byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte k of the result is byte
    (sel >> 4k) & 7 of the eight bytes y:x (x the low four)."""
    xy = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x,
                                                               np.uint64)
    sel = np.asarray(sel, np.uint64)
    out = np.zeros(np.broadcast(xy, sel).shape, np.uint64)
    for k in range(4):
        idx = (sel >> np.uint64(4 * k)) & np.uint64(7)
        out |= ((xy >> (np.uint64(8) * idx)) & np.uint64(0xFF)) \
            << np.uint64(8 * k)
    return out.astype(np.uint32)


def _words(chunk):
    """A 16-byte chunk as its four little-endian uint32 words."""
    return np.frombuffer(np.ascontiguousarray(chunk).tobytes(), np.uint32)


def _chunk(words):
    return np.frombuffer(np.asarray(words, np.uint32).tobytes(), np.int8)


# ---------------------------------------------------------------------------
# materialize_w: the plan
# ---------------------------------------------------------------------------

def test_materialize_w_plan_at_the_paths_shapes():
    """GATE_FAST2's key (81 vectors of N=512), GATE_DEFAULT's (48 of
    N=1024) and GATE_MXU's (36 of N=1024): 128-row blocks, whole rows, two
    or more blocks per SM of an H100."""
    plan = K.materialize_w_plan
    assert plan(3, 9, 3, 512, SMS) == (128, 512, 256)      # 324 blocks
    assert plan(4, 6, 2, 1024, SMS) == (128, 1024, 256)    # 384
    assert plan(3, 6, 2, 1024, SMS) == (128, 1024, 256)    # 288


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("L,J,U", [(1, 1, 1), (3, 9, 3), (4, 6, 2),
                                   (2, 3, 5)])
def test_materialize_w_plan_fits_every_shape(L, J, U, sms):
    """Every N the wrappers take (a power of two >= 16), up to 2^14: rows
    and cols powers of two from 16 dividing N, cols the whole row up to
    MATW_COLS, the staged copies within a block's shared memory, whole
    warps up to MATW_THREADS and no more than a block's 16-byte words need
    (rounded up to a warp); rows is the largest that gives two blocks per
    SM, or 16."""
    for N in (2 ** e for e in range(4, 15)):
        rows, cols, threads = K.materialize_w_plan(L, J, U, N, sms)
        for x in (rows, cols):
            assert x >= 16 and x & (x - 1) == 0 and N % x == 0
        assert cols == min(N, K.MATW_COLS)
        assert 16 * (rows + cols) <= K.MAX_SMEM       # the staged copies
        assert threads % 32 == 0 and 32 <= threads <= K.MATW_THREADS
        assert threads == min(K.MATW_THREADS,
                              -(-rows * cols // 512) * 32)
        blocks = L * J * U * (N // rows) * (N // cols)
        assert blocks >= 2 * sms or rows == 16
        assert rows == min(N, K.MATW_COLS) or blocks // 2 < 2 * sms


# ---------------------------------------------------------------------------
# materialize_w: a model of the kernel
# ---------------------------------------------------------------------------

def _b_chunk(vrow, a, kpacked):
    """b's 16-byte chunk a as the kernel builds it (b_chunk): v's chunk
    (a + N/16) mod 2N/16 for W; for Wt, chunks c and c + 1 of v, c = N/16 -
    a - 1, reversed by __byte_perm(., ., 0x1234)."""
    nch = vrow.size // 16
    chunks = vrow.reshape(nch, 16)
    if not kpacked:
        return chunks[(a + nch // 2) % nch].copy()
    c = (nch // 2 - a - 1) % nch
    x, y = _words(chunks[c]), _words(chunks[(c + 1) % nch])
    return _chunk([byte_perm(x[3], y[0], 0x1234),
                   byte_perm(x[2], x[3], 0x1234),
                   byte_perm(x[1], x[2], 0x1234),
                   byte_perm(x[0], x[1], 0x1234)])


def _model(v, kpacked, rows, cols):
    """Every block of the kernel at plan (rows, cols): stage the 16 copies
    (copy s chunk c = bytes s .. s + 15 of b chunks c_lo + c, c_lo + c + 1,
    by __byte_perm with selector 0x3210 + 0x1111 (s & 3) on words s >> 2
    ..), then copy each row's run from copy (N - r + q0) & 15, chunk
    ((N - r + q0) >> 4) - c_lo, asserting it stays inside the staging."""
    L, J, U, twoN = v.shape
    N = twoN // 2
    out = np.full((L, U * N, J * N) if kpacked else (L, J * N, U * N), -1,
                  np.int8)
    nck = (rows + cols) // 16
    for l, j, u in np.ndindex(L, J, U):
        vrow = v[l, j, u]
        for r0 in range(0, N, rows):
            for q0 in range(0, N, cols):
                c_lo = (N - r0 - rows + q0) >> 4
                sc = np.zeros((16, nck, 16), np.int8)
                for c in range(nck):
                    w = np.concatenate([_words(_b_chunk(vrow, c_lo + c,
                                                        kpacked)),
                                        _words(_b_chunk(vrow, c_lo + c + 1,
                                                        kpacked))])
                    for s in range(16):
                        sel, q = 0x3210 + 0x1111 * (s & 3), s >> 2
                        sc[s, c] = _chunk([byte_perm(w[q + e], w[q + e + 1],
                                                     sel) for e in range(4)])
                for r in range(r0, r0 + rows):
                    start = N - r + q0
                    k0 = (start >> 4) - c_lo
                    assert 0 <= k0 and k0 + cols // 16 <= nck
                    run = sc[start & 15, k0:k0 + cols // 16].reshape(-1)
                    if kpacked:
                        out[l, u * N + r, j * N + q0:j * N + q0 + cols] = run
                    else:
                        out[l, j * N + r, u * N + q0:u * N + q0 + cols] = run
    return out


@pytest.mark.parametrize("kpacked", [False, True])
@pytest.mark.parametrize("L,J,U,N,rows,cols", [
    (1, 2, 1, 16, 16, 16), (2, 2, 3, 32, 16, 32), (1, 3, 2, 64, 64, 64),
    (2, 1, 2, 64, 16, 16), (1, 2, 2, 128, 32, 64), (1, 1, 2, 256, 128, 128)])
def test_materialize_kernel_model(kpacked, L, J, U, N, rows, cols):
    """The kernel's staging and runs, at whole rows and column bands,
    give the plain version's every byte (the output starts as -1)."""
    v = _v((L, J, U, N), 3)
    plain = K.materialize_wt_plain if kpacked else K.materialize_w_plain
    np.testing.assert_array_equal(_model(v, kpacked, rows, cols),
                                  plain(torch.from_numpy(v)).numpy())


def test_materialize_wt_chosen_plan_model():
    """The plan chosen for a small key on an H100, through the model."""
    v = _v((2, 3, 2, 64), 4)
    rows, cols, _ = K.materialize_w_plan(2, 3, 2, 64, SMS)
    assert (rows, cols) == (16, 64)
    np.testing.assert_array_equal(
        _model(v, True, rows, cols),
        K.materialize_wt_plain(torch.from_numpy(v)).numpy())


# ---------------------------------------------------------------------------
# materialize_w: the library yardstick
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,J,U,N", [(2, 2, 2, 64), (1, 3, 1, 16),
                                     (3, 1, 2, 32)])
def test_flip_yardstick_is_materialize_w(L, J, U, N):
    """chip_smoke.flip_w / flip_wt (torch.roll, unfold and one torch.flip)
    equal the plain versions and the Pallas kernel (interpret mode)."""
    cs = _chip_smoke()
    v = _v((L, J, U, N), 5)
    tv = torch.from_numpy(v)
    want = np.asarray(pk.materialize_w(jnp.asarray(v), rows=min(N, 64),
                                       interpret=True))
    np.testing.assert_array_equal(cs.flip_w(tv).numpy(), want)
    np.testing.assert_array_equal(K.materialize_w_plain(tv).numpy(), want)
    np.testing.assert_array_equal(cs.flip_wt(tv).numpy(),
                                  want.transpose(0, 2, 1))
    np.testing.assert_array_equal(K.materialize_wt_plain(tv).numpy(),
                                  want.transpose(0, 2, 1))


# ---------------------------------------------------------------------------
# fused_cmux_step (v1): the plan, the walk over groups, the transpose
# ---------------------------------------------------------------------------

def test_fused_cmux_step_v1_plan():
    """lb: the paths' l = 3 is one build of 3 levels; l = 4 two builds of
    2; N not a multiple of 128 has no plan."""
    assert K.fused_cmux_step_v1_plan(512, 3) == 3
    assert K.fused_cmux_step_v1_plan(1024, 3) == 3
    assert K.fused_cmux_step_v1_plan(1024, 4) == 2
    assert K.fused_cmux_step_v1_plan(128, 1) == 1
    assert K.fused_cmux_step_v1_plan(64, 3) == 0
    assert K.fused_cmux_step_v1_plan(1000, 3) == 0


@pytest.mark.parametrize("l", list(range(1, 33)))
def test_fused_cmux_step_v1_plan_every_level_count(l):
    """Every l a wrapper takes (l * bgbit <= 32): ceil(l / 3) builds of at
    most 3 levels, as even as they come."""
    lb = K.fused_cmux_step_v1_plan(1024, l)
    builds = -(-l // lb)
    assert 1 <= lb <= 3 and builds == -(-l // 3)
    assert lb * (builds - 1) < l


def _groups(kp1, N, l, lb):
    """The kernel's group(): g -> (u, t0, lv0, nl)."""
    nlb = -(-l // lb)
    per_u = (N // 128) * nlb
    out = []
    for g in range(kp1 * per_u):
        rem = g % per_u
        lv0 = (rem % nlb) * lb
        out.append((g // per_u, (rem // nlb) * 128, lv0, min(lb, l - lv0)))
    return out


@pytest.mark.parametrize("kp1,N,l", [(3, 512, 3), (2, 1024, 3), (2, 128, 5),
                                     (2, 256, 7), (2, 128, 32), (3, 128, 1)])
def test_fused_cmux_step_v1_groups_cover_k_once(kp1, N, l):
    """The producer's TMA rows (u l + lv) N + t0 of every group's levels
    cover the key's K = (k+1) l N rows once, in 128-row slices; every
    group's levels share one (u, t0), so one rotation feeds its build."""
    lb = K.fused_cmux_step_v1_plan(N, l)
    rows = []
    for u, t0, lv0, nl in _groups(kp1, N, l, lb):
        assert 1 <= nl <= lb and lv0 + nl <= l
        rows += [(u * l + lv) * N + t0 for lv in range(lv0, lv0 + nl)]
    assert sorted(rows) == list(range(0, kp1 * l * N, 128))


def _swz(r, c):
    """Byte offset of column byte c of row r in a 128-byte-swizzled tile
    of 128-byte rows."""
    return r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15))


def test_fused_cmux_step_v1_transpose():
    """load_raw + store_tile, every thread of the transposer warpgroup for
    both consumer warpgroups' halves: a TMA box (128 K rows x 128 columns,
    128-byte swizzle) becomes each consumer warpgroup's K-major tile (row n
    = its column 64 cw + n, 128 K bytes, swizzled) with every byte in
    place; every 4-byte load instruction of a warp touches 32 distinct
    banks, and every 16-byte store a quarter-warp issues touches 8 distinct
    16-byte bank groups."""
    rng = np.random.default_rng(9)
    box = rng.integers(-128, 128, (128, 128)).astype(np.int8)   # [k][col]
    raw = np.zeros(128 * 128, np.int8)
    for r in range(128):
        for c in range(128):
            raw[_swz(r, c)] = box[r, c]
    raw_words = np.frombuffer(raw.tobytes(), np.uint32)
    tiles = np.full((2, 64 * 128), -1, np.int8)
    for cw, wl in np.ndindex(2, 4):            # (half, transposer warp)
        warp = 4 * cw + wl
        x = np.zeros((32, 16), np.uint32)
        for i in range(16):
            banks = []
            for lane in range(32):
                h, cq = lane >> 4, lane & 15
                kc, c = 2 * wl + h, 64 * cw + 4 * cq
                r = 16 * kc + ((i + 4 * h) & 15)
                off = r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15))
                x[lane, i] = raw_words[off // 4]
                banks.append((off // 4) % 32)
            assert len(set(banks)) == 32, (warp, i)
        for e in range(4):
            groups = {}
            for lane in range(32):
                h, cq = lane >> 4, lane & 15
                kc = 2 * wl + h
                c = (e + (cq >> 1)) & 3
                sel = c | (c + 4) << 4
                xl = x[lane]
                t = [byte_perm(byte_perm(xl[4 * q], xl[4 * q + 1], sel),
                               byte_perm(xl[4 * q + 2], xl[4 * q + 3], sel),
                               0x5410) for q in range(4)]
                words = [t[3], t[0], t[1], t[2]] if h else t
                n = 4 * cq + c
                off = n * 128 + ((kc ^ (n & 7)) << 4)
                tiles[cw, off:off + 16] = _chunk(words)
                groups.setdefault(lane // 8, []).append((off // 16) % 8)
            for quarter, g in groups.items():
                assert len(set(g)) == 8, (warp, e, quarter)
    for cw in range(2):
        for n in range(64):
            for k in range(128):
                assert tiles[cw, _swz(n, k)] == box[k, 64 * cw + n]
