"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where no GPU is present.  On a machine with one:

    python -m pytest -m cuda tests/test_torch_cuda.py

Small and ragged shapes (batches that do not fill a 64-row tile, every limb
count, both key shifts, one and two digit planes), plus one GATE_TOY
bootstrap and CB_TOY circuit bootstraps (on each of the four 64-bit steps)
that must give the same ciphertexts on the card as on the CPU.  Imports
nothing of JAX.
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


@pytest.mark.parametrize("L,J,U,N", [(3, 9, 3, 512), (1, 2, 1, 16),
                                     (4, 6, 2, 1024)])
def test_materialize_w(cuda, L, J, U, N):
    v = _i8(np.random.default_rng(0), (L, J, U, 2 * N))
    _same_on_card(K.materialize_w, K.materialize_w_plain, (v,), {}, cuda)


@pytest.mark.parametrize("B,k,N,l,bgbit", [(5, 1, 64, 3, 7),
                                           (33, 2, 512, 3, 7),
                                           (16, 1, 1024, 2, 8)])
def test_rotate_decompose(cuda, B, k, N, l, bgbit):
    r = np.random.default_rng(1)
    acc = _i32(r, (B, k + 1, N))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    kw = dict(l=l, bgbit=bgbit, offset=0x81020400)
    _same_on_card(K.rotate_decompose, K.rotate_decompose_plain, (a, acc), kw,
                  cuda)


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


@pytest.mark.parametrize("B,k,N,L,key_shift", [(3, 2, 512, 3, 8),
                                               (130, 2, 512, 3, 0),
                                               (64, 1, 64, 2, 16),
                                               (8, 1, 1024, 1, 24)])
def test_fused_cmux_step_v2(cuda, B, k, N, L, key_shift):
    r = np.random.default_rng(3)
    l = 3
    acc = _i32(r, (B, k + 1, N))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    w = _i8(r, (L, (k + 1) * l * N, (k + 1) * N))
    kw = dict(l=l, bgbit=7, offset=0x81020400, key_shift=key_shift)
    _same_on_card(K.fused_cmux_step_v2, K.fused_cmux_step_v2_plain,
                  (a, acc, w), kw, cuda)
    flat = dict(kw, kp1=k + 1)
    _same_on_card(K.fused_cmux_step_v2, K.fused_cmux_step_v2_plain,
                  (a, acc.reshape(B, -1), w), flat, cuda)


@pytest.mark.parametrize("tile_rows", [64, 128])
@pytest.mark.parametrize("B", [3, 100, 130, 800])
def test_fused_cmux_step_v2_each_tile(cuda, B, tile_rows):
    r = np.random.default_rng(4)
    k, N, l, L = 2, 512, 3, 3
    acc = _i32(r, (B, k + 1, N))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    w = _i8(r, (L, (k + 1) * l * N, (k + 1) * N))
    kw = dict(l=l, bgbit=7, offset=0x81020400, key_shift=8)
    got = K.fused_cmux_step_v2(a.to(cuda), acc.to(cuda), w.to(cuda),
                               tile_rows=tile_rows, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), K.fused_cmux_step_v2_plain(a, acc, w, **kw))


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


@pytest.mark.parametrize("backend", ["onthefly", "matmul"])
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


@pytest.mark.parametrize("B,k,N,l,bgbit,m", [(256, 1, 2048, 5, 8, 64),
                                             (3, 1, 2048, 4, 9, 64),
                                             (7, 2, 256, 4, 9, 64),
                                             (5, 1, 128, 5, 8, 32)])
def test_rotate_decompose64_ck(cuda, B, k, N, l, bgbit, m):
    r = np.random.default_rng(5)
    acc = _i64(r, (B, k + 1, N))
    acc.view(-1)[:3] = torch.tensor([-2**63, 2**63 - 1, 0])
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    a[0] = N                                   # a pure sign flip
    offset = sum(1 << (63 - i * bgbit) for i in range(l + 1)) % 2**64
    kw = dict(l=l, bgbit=bgbit, offset=offset, m=m,
              planes=1 if bgbit <= 8 else 2)
    _same_on_card(K.rotate_decompose64_ck, K.rotate_decompose64_ck_plain,
                  (a, acc), kw, cuda)


@pytest.mark.parametrize("B,N,J,UL,m,P", [(256, 2048, 10, 12, 64, 1),
                                          (37, 2048, 8, 16, 64, 2),
                                          (70, 256, 6, 3, 32, 1),
                                          (9, 128, 4, 5, 64, 2)])
def test_ck_dot64p(cuda, B, N, J, UL, m, P):
    r = np.random.default_rng(6)
    ckp = K.ck_width(J * m)
    lo, hi = (-128, 128) if P == 1 else (-64, 65)
    x = _i8(r, (B, (N // m) * P * ckp), lo, hi)
    wm = _i8(r, (UL, J * m, N + m))
    _same_on_card(K.ck_dot64p, K.ck_dot64p_plain, (x, wm),
                  dict(N=N, m=m, planes=P), cuda)


def test_ck_dot64p_unsupported_shape_raises(cuda):
    """N = 64 is below the kernel's 128-column tile: the wrapper raises
    instead of running the plain version on the card."""
    x = torch.zeros((4, 2 * 128), dtype=torch.int8, device=cuda)
    wm = torch.zeros((2, 2 * 32, 64 + 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="kernel"):
        K.ck_dot64p(x, wm, N=64, m=32)


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


@pytest.mark.parametrize("B,N,l,kp1,L,m,P", [(256, 2048, 5, 2, 6, 64, 1),
                                             (37, 2048, 4, 2, 8, 64, 2),
                                             (1, 256, 2, 3, 3, 64, 1),
                                             (70, 128, 4, 2, 5, 32, 2)])
def test_ck_dot64p_acc(cuda, B, N, l, kp1, L, m, P):
    r = np.random.default_rng(8)
    ckp = K.ck_width(kp1 * l * m)
    lo, hi = (-128, 128) if P == 1 else (-64, 65)
    x = _i8(r, (B, (N // m) * P * ckp), lo, hi)
    wm = _i8(r, (kp1 * L, kp1 * l * m, N + m))
    acc = _i64(r, (B, kp1 * N))
    _same_on_card(K.ck_dot64p_acc, K.ck_dot64p_acc_plain, (x, wm, acc),
                  dict(N=N, m=m, planes=P, kp1=kp1,
                       key_shift=max(0, 64 - 8 * L)), cuda)


@pytest.mark.parametrize("B,k,N,l,bgbit,m", [(256, 1, 2048, 5, 8, 64),
                                             (3, 1, 2048, 4, 9, 64)])
def test_rotate_decompose64_ck_flat(cuda, B, k, N, l, bgbit, m):
    r = np.random.default_rng(9)
    acc = _i64(r, (B, (k + 1) * N))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    offset = sum(1 << (63 - i * bgbit) for i in range(l + 1)) % 2**64
    kw = dict(N=N, l=l, bgbit=bgbit, offset=offset, m=m,
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


@pytest.mark.parametrize("B,k,N,L,key_shift", [(3, 2, 512, 3, 8),
                                               (130, 1, 1024, 3, 8),
                                               (64, 1, 128, 3, 0)])
def test_fused_cmux_step_v1(cuda, B, k, N, L, key_shift):
    """The v1 kernel against its plain version and against v2's kernel."""
    r = np.random.default_rng(10)
    l = 3
    acc = _i32(r, (B, k + 1, N))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    a[0] = N
    w = _i8(r, (L, (k + 1) * l * N, (k + 1) * N))
    kw = dict(l=l, bgbit=7, offset=0x81020400, key_shift=key_shift)
    _same_on_card(K.fused_cmux_step, K.fused_cmux_step_v2_plain, (a, acc, w),
                  kw, cuda)
    dev = [t.to(cuda) for t in (a, acc, w)]
    assert torch.equal(K.fused_cmux_step(*dev, **kw),
                       K.fused_cmux_step_v2(*dev, **kw))


@pytest.mark.parametrize("B,k,N,l,bgbit", [(256, 1, 2048, 5, 8),
                                           (3, 1, 2048, 4, 9),
                                           (7, 2, 256, 4, 9),
                                           (5, 1, 128, 5, 8)])
def test_rotate_decompose64(cuda, B, k, N, l, bgbit):
    """The plain-layout emitter against its plain version; re-laid out, it
    is rotate_decompose64_ck's kernel output."""
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


@pytest.mark.parametrize("B,N,l,kp1,L,m,P", [(256, 2048, 5, 2, 6, 64, 1),
                                             (37, 2048, 4, 2, 8, 64, 2),
                                             (1, 256, 2, 3, 3, 64, 1),
                                             (70, 128, 4, 2, 5, 32, 2)])
def test_ck_dot64p_sacc(cuda, B, N, l, kp1, L, m, P):
    r = np.random.default_rng(12)
    ckp = K.ck_width(kp1 * l * m)
    lo, hi = (-128, 128) if P == 1 else (-64, 65)
    x = _i8(r, (B, (N // m) * P * ckp), lo, hi)
    wm = _i8(r, (kp1 * L, kp1 * l * m, N + m))
    acc = _i64(r, (B, kp1 * N))
    _same_on_card(K.ck_dot64p_sacc, K.ck_dot64p_acc_plain, (x, wm, acc),
                  dict(N=N, m=m, planes=P, kp1=kp1,
                       key_shift=max(0, 64 - 8 * L)), cuda)


@pytest.mark.parametrize("B,kp1,N,l,bgbit,L,m,tile", [
    (256, 2, 2048, 5, 8, 6, 64, 0), (37, 2, 2048, 4, 9, 8, 64, 0),
    (1, 2, 256, 2, 8, 3, 64, 0), (3, 2, 128, 3, 8, 8, 32, 0),
    (100, 2, 256, 2, 9, 3, 64, 64), (100, 2, 256, 2, 9, 3, 64, 32),
    (70, 3, 256, 3, 8, 4, 64, 32)])
def test_ck_cmux_step64(cuda, B, kp1, N, l, bgbit, L, m, tile):
    """Tail rows, both tiles, odd and even limb counts, one and two digit
    planes, k = 1 and 2."""
    r = np.random.default_rng(13)
    acc = _i64(r, (B, kp1 * N))
    a = torch.from_numpy(r.integers(0, 2 * N, (B,)).astype(np.int32))
    a[0] = N                                   # a pure sign flip
    wm = _i8(r, (kp1 * L, kp1 * l * m, N + m))
    offset = sum(1 << (63 - i * bgbit) for i in range(l + 1)) % 2**64
    kw = dict(l=l, bgbit=bgbit, offset=offset, m=m, kp1=kp1,
              key_shift=max(0, 64 - 8 * L), planes=1 if bgbit <= 8 else 2)
    got = K.ck_cmux_step64(a.to(cuda), acc.to(cuda), wm.to(cuda),
                           tile_rows=tile, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), K.ck_cmux_step64_plain(a, acc, wm, **kw))
