"""The port's kernel wrappers (tfhe_tpu_torch.ops.kernels) against the
Pallas kernels they replace, bit for bit.

On the CPU every wrapper runs its plain PyTorch version; the Pallas kernels
run in interpret mode, at the shapes of tests/test_pallas_kernels.py.  The
CUDA kernels themselves are held against the same plain versions on the
card by chip_smoke.py and tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu.params import TGswParams, TLweParams
from tfhe_tpu.ops import pallas_kernels as pk
from tfhe_tpu.ops.engine import EngineConfig, OnTheFlyMatmulEngine
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.ops import kernels as K
from tfhe_tpu_torch.utils import observability as obs


def _offset(N, k, l, bgbit):
    return TGswParams(l=l, bgbit=bgbit, key_limbs=3,
                      tlwe=TLweParams(N=N, k=k, stdev=2.0**-25)).offset


def _i32(r, shape):
    return r.integers(-2**31, 2**31, shape).astype(np.int32)


def _same(got, want):
    assert got.shape == tuple(np.shape(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("N,J,U,L", [(128, 4, 2, 3), (256, 6, 3, 2),
                                     (128, 2, 1, 1)])
def test_materialize_w(N, J, U, L):
    v = np.random.default_rng(0).integers(-128, 128, (L, J, U, 2 * N)
                                          ).astype(np.int8)
    if J * U * L * N <= 4096:
        want = pk.materialize_w(jnp.asarray(v), rows=64, interpret=True)
    else:
        # interpreting the Pallas kernel costs ~4 ms per output row; the
        # widest shape is held against the JAX package's XLA
        # materialization instead (equal to the kernel by
        # tests/test_pallas_kernels.py)
        eng = OnTheFlyMatmulEngine(EngineConfig(N=N, out_bits=32,
                                                digit_bits=7))
        m = np.asarray(eng._materialize(jnp.asarray(v)))    # (L,J,U,t,i)
        want = m.transpose(0, 1, 3, 2, 4).reshape(L, J * N, U * N)
    _same(K.materialize_w(torch.from_numpy(v)), want)


@pytest.mark.parametrize("N,J,U,L", [(128, 4, 2, 3), (128, 2, 1, 1)])
def test_materialize_wt(N, J, U, L):
    """The K-packed key is the Pallas kernel's W transposed."""
    v = np.random.default_rng(0).integers(-128, 128, (L, J, U, 2 * N)
                                          ).astype(np.int8)
    want = np.asarray(pk.materialize_w(jnp.asarray(v), rows=64,
                                       interpret=True)).transpose(0, 2, 1)
    _same(K.materialize_wt(torch.from_numpy(v)), want)


def test_materialize_wt_reversed_runs():
    """The kernel's addressing: row (l, u, i) of Wt over t, for fixed j, is
    the run b[N - i .. 2N - i) of b[m] = v[(N - m) mod 2N]; it is read
    from the staged copy s = (N - i) & 15 (copy s holds b shifted by s
    bytes) as 16-byte chunks (N - i) >> 4 .. + N/16 - 1, all aligned."""
    N, J, U, L = 64, 3, 2, 2
    v = np.random.default_rng(6).integers(-128, 128, (L, J, U, 2 * N)
                                          ).astype(np.int8)
    wt = K.materialize_wt(torch.from_numpy(v)).numpy()
    m = np.arange(2 * N + 16)
    for l, j, u in np.ndindex(L, J, U):
        b = v[l, j, u, (N - m) % (2 * N)]
        copies = [b[s:s + 2 * N].reshape(-1, 16) for s in range(16)]
        for i in (0, 1, 17, N - 1):
            s, k0 = (N - i) & 15, (N - i) >> 4
            run = copies[s][k0:k0 + N // 16].reshape(-1)
            np.testing.assert_array_equal(wt[l, u * N + i, j * N:j * N + N],
                                          run)


@pytest.mark.parametrize("bgbit,l", [(7, 3), (8, 3), (8, 4), (6, 5),
                                     (1, 32)])
def test_fused_digit_fields(bgbit, l):
    """The kernel's digit extraction: digit lv of d, ((d >> s) & mask) -
    half with s = 32 - (lv+1) bgbit, is the bgbit-bit field at s of
    d ^ sum_lv (half << s), sign-extended: (int32)(that << lv bgbit) >>
    (32 - bgbit); packed four coefficients to a word, low byte first."""
    r = np.random.default_rng(7)
    d = r.integers(0, 2**32, 4096, dtype=np.uint64)
    d[:4] = [0, 2**32 - 1, 2**31, 2**31 - 1]
    half, mask = 1 << (bgbit - 1), (1 << bgbit) - 1
    xmask = sum(half << (32 - (lv + 1) * bgbit) for lv in range(l))
    for lv in range(l):
        s = 32 - (lv + 1) * bgbit
        want = ((d >> s) & mask).astype(np.int64) - half
        wide = ((d ^ xmask) << (lv * bgbit)) & 0xFFFFFFFF
        got = wide.astype(np.uint32).view(np.int32).astype(np.int64) \
            >> (32 - bgbit)
        np.testing.assert_array_equal(got, want)
        packed = (got & 0xFF).reshape(-1, 4) << np.array([0, 8, 16, 24])
        np.testing.assert_array_equal(
            packed.sum(1).astype(np.uint32).view(np.uint8).view(np.int8),
            want.astype(np.int8))


@pytest.mark.parametrize("N,k,l,bgbit", [(128, 1, 3, 7), (128, 2, 3, 7),
                                         (256, 1, 2, 8)])
def test_rotate_decompose(N, k, l, bgbit):
    r = np.random.default_rng(1)
    B = 8
    acc = _i32(r, (B, k + 1, N))
    a = r.integers(0, 2 * N, (B,)).astype(np.int32)
    a[:3] = [0, N, 2 * N - 1]              # identity, pure sign flip, edge
    off = _offset(N, k, l, bgbit)
    want = pk.rotate_decompose(jnp.asarray(a), jnp.asarray(acc), l=l,
                               bgbit=bgbit, offset=off, tb=B * (k + 1),
                               interpret=True)
    got = K.rotate_decompose(torch.from_numpy(a), torch.from_numpy(acc),
                             l=l, bgbit=bgbit, offset=off)
    _same(got, want)
    assert not got[0].any()                # (X^0 - 1) * acc = 0


@pytest.mark.parametrize("L,shift", [(3, 8), (2, 0), (4, 0)])
@pytest.mark.parametrize("flat_acc", [False, True])
@pytest.mark.parametrize("entry", ["w", "wt"])
def test_mm_recombine_acc(L, shift, flat_acc, entry):
    """The JAX package's signature (w in materialize_w's layout) and the
    K-packed entry (wt = w transposed, materialize_wt's layout)."""
    r = np.random.default_rng(2)
    B, N, J, U = 8, 128, 4, 2
    x = r.integers(-64, 64, (B, J * N)).astype(np.int8)
    w = r.integers(-128, 128, (L, J * N, U * N)).astype(np.int8)
    acc = _i32(r, (B, U * N) if flat_acc else (B, U, N))
    want = pk.mm_recombine_acc(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(acc), shift_base=shift, tm=B,
                               tn=N, tk=N, interpret=True)
    if entry == "w":
        got = K.mm_recombine_acc(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(acc), shift_base=shift)
    else:
        wt = torch.from_numpy(w.transpose(0, 2, 1).copy())
        got = K.mm_recombine_acc_wt(torch.from_numpy(x), wt,
                                    torch.from_numpy(acc), shift_base=shift)
    _same(got, want)


@pytest.mark.parametrize("steps,split,plan", [
    (48, 1, (48, 1)), (48, 2, (24, 2)), (48, 4, (12, 4)), (48, 5, (10, 5)),
    (12, 5, (3, 4)), (7, 3, (3, 3)), (5, 4, (2, 3)), (3, 9, (1, 3))])
def test_mm_recombine_acc_k_slices(steps, split, plan):
    """mm_recombine_acc_wt's K split (split_plan): slices of ceil(steps / S)
    128-deep stages cover K exactly once, the last one ragged and none
    empty; their recombined partial products, added mod 2^32 onto acc_in as
    the kernel's atomics do, give the plain version bit for bit."""
    assert K.split_plan(steps, split) == plan
    n, slices = plan
    bounds = [(s * n, min(steps, (s + 1) * n)) for s in range(slices)]
    assert bounds[-1][1] == steps and all(lo < hi for lo, hi in bounds)
    if steps > 8:
        return                               # the plan alone at path sizes
    r = np.random.default_rng(5)
    B, UN, L, shift, D = 5, 64, 4, 0, K.MM_BK
    x = torch.from_numpy(r.integers(-64, 64, (B, D * steps)).astype(np.int8))
    w = torch.from_numpy(r.integers(-128, 128, (L, D * steps, UN))
                         .astype(np.int8))
    acc = torch.from_numpy(_i32(r, (B, UN)))
    got = acc.to(torch.int64)
    for lo, hi in bounds:
        ks = slice(D * lo, D * hi)
        zero = torch.zeros_like(acc)
        got = got + K.mm_recombine_acc_plain(x[:, ks], w[:, ks], zero,
                                             shift_base=shift)
    want = pk.mm_recombine_acc(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                               jnp.asarray(acc.numpy()), shift_base=shift,
                               tm=B, tn=UN, tk=D, interpret=True)
    _same(K.mm_recombine_acc(x, w, acc, shift_base=shift), want)
    _same(T.wrap32(got), want)


@pytest.mark.parametrize("B,K_,UN,plan", [
    (8192, 6144, 2048, (128, 1, 132)),   # GATE_DEFAULT wide: 2,048 units
    (628, 6144, 2048, (128, 2, 132)),    # the adder's mean launch
    (256, 6144, 2048, (128, 2, 128)),
    (768, 6144, 2048, (128, 2, 132)),
    (1, 6144, 2048, (64, 4, 128)),
    (3, 1536, 1536, (64, 4, 96)),        # an ep=3 slice of GATE_FAST2
    (100, 800, 256, (128, 7, 28))])      # a ragged K tail (7 stages)
def test_mm_recombine_acc_plan(B, K_, UN, plan):
    """The plan by shape on 132 SMs: 128-row units above 64 rows; no split
    where the units fill the card many times, else the split that fills
    every SM with the fewest rounds; one block an SM at most."""
    assert K.mm_recombine_acc_plan(B, K_, UN, 132) == plan
    assert K.mm_recombine_acc_plan(B, K_, UN, 132, 2)[1] == 2


def test_mm_recombine_acc_rejects_a_bad_split():
    x = torch.zeros((8, 256), dtype=torch.int8)
    w = torch.zeros((3, 256, 128), dtype=torch.int8)
    acc = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="split"):
        K.mm_recombine_acc(x, w, acc, split=-1)


@pytest.mark.parametrize("N,k,l,L,key_shift", [(128, 1, 3, 3, 8),
                                               (128, 2, 3, 3, 8),
                                               (128, 2, 3, 3, 0),
                                               (256, 1, 2, 2, 16)])
def test_fused_cmux_step_v2(N, k, l, L, key_shift):
    r = np.random.default_rng(3)
    B, J = 8, (k + 1) * l
    acc = _i32(r, (B, k + 1, N))
    a = r.integers(0, 2 * N, (B,)).astype(np.int32)
    w = r.integers(-128, 128, (L, J * N, (k + 1) * N)).astype(np.int8)
    kw = dict(l=l, bgbit=7, offset=_offset(N, k, l, 7), key_shift=key_shift)
    want = pk.fused_cmux_step_v2(jnp.asarray(a), jnp.asarray(acc),
                                 jnp.asarray(w), tm=B, interpret=True, **kw)
    wt = torch.from_numpy(w.transpose(0, 2, 1).copy())      # K-packed
    got = K.fused_cmux_step_v2(torch.from_numpy(a), torch.from_numpy(acc),
                               wt, **kw)
    _same(got, want)


def test_fused_cmux_step_v2_flat_multi_tile():
    """Several batch tiles and the flat (B, (k+1)N) carry layout."""
    N, k, l, L = 128, 1, 3, 3
    r = np.random.default_rng(4)
    B, J = 32, (k + 1) * l
    acc = _i32(r, (B, (k + 1) * N))
    a = r.integers(0, 2 * N, (B,)).astype(np.int32)
    w = r.integers(-128, 128, (L, J * N, (k + 1) * N)).astype(np.int8)
    kw = dict(l=l, bgbit=7, offset=_offset(N, k, l, 7), key_shift=8,
              kp1=k + 1)
    want = pk.fused_cmux_step_v2(jnp.asarray(a), jnp.asarray(acc),
                                 jnp.asarray(w), tm=8, interpret=True, **kw)
    wt = torch.from_numpy(w.transpose(0, 2, 1).copy())      # K-packed
    got = K.fused_cmux_step_v2(torch.from_numpy(a), torch.from_numpy(acc),
                               wt, **kw)
    _same(got, want)


@pytest.mark.parametrize("N,k,L", [(128, 1, 3), (128, 2, 2)])
def test_fused_cmux_step_v2_on_materialize_wt(N, k, L):
    """The main path's step as a whole: materialize_wt's key into
    fused_cmux_step_v2, against the Pallas pair materialize_w +
    fused_cmux_step_v2."""
    r = np.random.default_rng(8)
    B, l = 8, 3
    v = r.integers(-128, 128, (L, (k + 1) * l, k + 1, 2 * N)).astype(np.int8)
    acc = _i32(r, (B, k + 1, N))
    a = r.integers(0, 2 * N, (B,)).astype(np.int32)
    a[:2] = [0, N]
    kw = dict(l=l, bgbit=7, offset=_offset(N, k, l, 7), key_shift=8)
    w = pk.materialize_w(jnp.asarray(v), rows=64, interpret=True)
    want = pk.fused_cmux_step_v2(jnp.asarray(a), jnp.asarray(acc), w, tm=B,
                                 interpret=True, **kw)
    wt = K.materialize_wt(torch.from_numpy(v))
    _same(K.fused_cmux_step_v2(torch.from_numpy(a), torch.from_numpy(acc),
                               wt, **kw), want)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    obs.reset()
    v = torch.zeros((1, 2, 1, 32), dtype=torch.int8)
    assert torch.equal(K.materialize_w(v), K.materialize_w_plain(v))
    assert torch.equal(K.materialize_wt(v), K.materialize_wt_plain(v))
    assert not [c for c in obs.report()["counters"]
                if c.startswith("kernel.")]


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_wrapper_rejects_bad_input(bad):
    x = torch.zeros((8, 256), dtype=torch.int8)
    w = torch.zeros((3, 256, 128), dtype=torch.int8)
    acc = torch.zeros((8, 128), dtype=torch.int32)
    if bad == "dtype":
        x = x.to(torch.int32)
    elif bad == "shape":
        w = w[:, :128].contiguous()
    else:
        x = torch.zeros((256, 8), dtype=torch.int8).t()
    with pytest.raises(ValueError):
        K.mm_recombine_acc(x, w, acc)


@pytest.mark.parametrize("tile_cols", [32, 192, 256])
def test_fused_rejects_an_unknown_tile(tile_cols):
    """The kernel's plans are 64 and 128 output columns a block (one or two
    consumer warpgroups), or 0 to choose."""
    a = torch.zeros((4,), dtype=torch.int32)
    acc = torch.zeros((4, 2, 128), dtype=torch.int32)
    wt = torch.zeros((1, 2 * 128, 2 * 3 * 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="tile_cols"):
        K.fused_cmux_step_v2(a, acc, wt, l=3, bgbit=7, offset=0,
                             tile_cols=tile_cols)


@pytest.mark.parametrize("L,cols,l,stages", [(3, 128, 3, 3), (3, 128, 4, 0),
                                             (3, 64, 3, 7), (3, 64, 4, 6),
                                             (2, 128, 4, 5), (1, 128, 3, 8)])
def test_fused_ring_stages(L, cols, l, stages):
    """The ring the kernel's shared memory holds (csrc ring_stages): 0
    where fewer than one group's l stages fit."""
    assert K.fused_ring_stages(L, cols, l) == stages


@pytest.mark.parametrize("N,l,L,tile_cols,cols", [
    (512, 3, 3, 0, 128),            # the main path
    (1024, 3, 3, 0, 128),           # GATE_MXU onthefly
    (512, 4, 3, 0, 64),             # the 128-column ring holds no group
    (512, 4, 3, 128, 0),
    (512, 4, 3, 64, 64),
    (512, 4, 2, 0, 128),
    (512, 3, 3, 64, 64),            # a forced plan is kept
    (64, 3, 3, 0, 0),               # below the 128-deep K slice
    (512, 5, 3, 0, 0),
    (512, 3, 4, 0, 0)])
def test_fused_plan(N, l, L, tile_cols, cols):
    assert K.fused_cmux_step_v2_plan(N, l, L, tile_cols) == cols


@pytest.mark.parametrize("N,l,fused", [(512, 3, True), (512, 4, True),
                                       (64, 3, False), (512, 5, False)])
def test_engine_takes_the_fused_step_only_in_its_kernel_domain(N, l, fused):
    """Off the CPU the engine hands a step to fused_cmux_step_v2 only where
    a plan of its kernel takes it (else the caller takes the generic step);
    on the CPU the plain version takes any."""
    from tfhe_tpu_torch.ops import engine
    te = engine.make_engine(engine.EngineConfig(N=N, out_bits=32,
                                                digit_bits=7, key_limbs=3),
                            "onthefly")
    card = torch.empty((8, 3, N), dtype=torch.int32, device="meta")
    assert te._fused_ok(card, l, 7) is fused
    assert te._fused_ok(torch.empty((8, 3, N), dtype=torch.int32), l, 7)


def test_fused_rejects_the_jax_layout_key():
    """The wrapper takes the K-packed key; materialize_w's layout (L, K,
    U*N) is refused rather than read transposed."""
    a = torch.zeros((4,), dtype=torch.int32)
    acc = torch.zeros((4, 2, 128), dtype=torch.int32)
    w = torch.zeros((1, 2 * 3 * 128, 2 * 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="wt must be"):
        K.fused_cmux_step_v2(a, acc, w, l=3, bgbit=7, offset=0)
