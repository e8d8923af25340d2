"""The batched LUT tree of tfhe_tpu_torch.models.lut on the CPU.

  * kernels.lut_cmux (its plain version) against tgsw.cmux group by group,
    any grouping, and a numpy model of csrc/lut_cmux.cu's index arithmetic
    (the digits' swizzled slots, the permuted K, the key runs a thread
    keeps, the epilogue's rows) against the plain version;
  * lut.make_lut_staged at CB_TOY, 4-bit LUTs of 1, 3 and 8 instances with
    scalar and (2^k, N) tables, against gpu_bench's reference (its circuit
    bootstrap and a plain CMux tree: the judge file of the benchmark's LUT
    cell) on keys made from a seed; a planted fault (two instances'
    selectors swapped) is caught; the counters count what they should;
  * the domain the tree refuses.

Tolerance 0: every path is exact integer arithmetic.  Imports nothing of
JAX.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_bench import loops, server
from gpu_bench.client import Client
from gpu_bench.tests.toy_configs import CB_TOY as CB_TOY_CFG
from tfhe_tpu_torch import tgsw
from tfhe_tpu_torch.models import lut
from tfhe_tpu_torch.ops import kernels as K
from tfhe_tpu_torch.params import CB_TOY
from tfhe_tpu_torch.utils import observability as obs

REPO = Path(__file__).resolve().parents[1]
P1 = CB_TOY.tgsw_lvl1
SEED = 2**31 + 25025


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i32(r, shape):
    return torch.from_numpy(r.integers(-2**31, 2**31, shape).astype(np.int32))


def _gadget(l, bgbit):
    from tfhe_tpu_torch.params import TGswParams, TLweParams
    return TGswParams(l=l, bgbit=bgbit, tlwe=TLweParams(N=P1.tlwe.N, k=1))


@pytest.mark.parametrize("G,S,shared", [(1, 1, False), (3, 4, False),
                                        (2, 8, True), (2, 12, False)])
def test_lut_cmux_plain_is_cmux_per_group(G, S, shared):
    """Each group's rows against its own selector: tgsw.cmux on the matmul
    engine, bit for bit; shared leaves read through an expand."""
    r = np.random.default_rng(G * 100 + S)
    N = P1.tlwe.N
    acc = _i32(r, (2 * S, 2, N)).expand(G, 2 * S, 2, N) if shared \
        else _i32(r, (G, 2 * S, 2, N))
    sel = _i32(r, (G, 2, P1.l, 2, N))
    got = K.lut_cmux(acc, sel, l=P1.l, bgbit=P1.bgbit, offset=P1.offset)
    assert got.shape == (G, S, 2, N) and got.dtype == torch.int32
    for g in range(G):
        _, prep = tgsw.prepare(sel[g], P1, "matmul")
        want = tgsw.cmux(prep, acc[g, 1::2], acc[g, 0::2], P1, "matmul")
        assert torch.equal(got[g], want), g


def _kernel_model(acc, sel, l, bgbit, offset, tiles):
    """csrc/lut_cmux.cu's data flow with its own indices, in numpy: every
    block stages the digits at digit_off and the reversed limb vectors,
    each thread keeps its runs in the kernel's ring of registers, the wgmma's
    operands are put together from the threads' registers (A) and the
    swizzled buffer (B), and the epilogue writes the rows it owns."""
    acc, sel = acc.numpy().astype(np.int64), sel.numpy().astype(np.int64)
    G, S2, kp1, N = acc.shape
    S, J, ROWS, VB = S2 // 2, kp1 * l, K.LUT_ROWS, 2 * N + 16
    chunks, ntiles, steps = -(-S // ROWS), N // (64 * tiles), N // 32
    M32 = (1 << 32) - 1
    xmask = sum((1 << (bgbit - 1)) << (32 - (w + 1) * bgbit)
                for w in range(l))

    def digit_off(r, kk):
        step, w = kk >> 5, kk & 31
        byte = ((step & 3) << 5) | ((w & 4) << 2) | ((w >> 3) << 2)
        return ((step >> 2) << 10) | (r << 7) | ((((byte >> 4) ^ r) & 7)
                                                  << 4) | (byte & 15)

    def limbs(x):
        out = []
        for _ in range(4):
            limb = (((x & 255) + 128) & 255) - 128
            out.append(limb)
            x = ((x - limb) & M32) >> 8
        return out

    out = np.zeros((G, S, kp1, N), np.int64)
    for g in range(G):
        for chunk in range(chunks):
            s0 = chunk * ROWS
            nr = min(ROWS, S - s0)
            dig = np.zeros(ROWS * J * N, np.int64)
            for r in range(nr):
                d = ((acc[g, 2 * (s0 + r) + 1] - acc[g, 2 * (s0 + r)]
                      + offset) & M32) ^ xmask
                for p in range(kp1):
                    for w in range(l):
                        f = ((d[p] << (w * bgbit)) & M32) >> (32 - bgbit)
                        f = np.where(f >= 1 << (bgbit - 1), f - (1 << bgbit),
                                     f)
                        for t in range(0, N, 4):
                            o = digit_off(r, (p * l + w) * N + t)
                            dig[o:o + 4] = f[t:t + 4]
            for u in range(kp1):
                keyv = np.zeros(4 * J * VB, np.int64)
                for j in range(J):
                    kp = sel[g].reshape(J, kp1, N)[j, u] & M32
                    for m in range(2 * N):
                        x = ((-kp[0]) & M32 if m == 0 else kp[N - m]
                             if m <= N else (-kp[2 * N - m]) & M32)
                        for lm, v in enumerate(limbs(int(x))):
                            keyv[(lm * J + j) * VB + m] = v
                for tile in range(ntiles):
                    D = np.zeros((tiles, 4, 64, ROWS), np.int64)
                    for j in range(J):
                        # ring[warp, lane, lm][x mod 2T]: the run of the
                        # thread's lowest row at step x, the kernel's
                        # registers (prefilled with steps -2T+1 .. -1)
                        ring, W = {}, 2 * tiles
                        for wp in range(4):
                            for lane in range(32):
                                c = tile * 64 * tiles + 8 * wp + lane // 4
                                o0 = N - c + 8 * (lane % 4)
                                for lm in range(4):
                                    base = (lm * J + j) * VB
                                    ring[wp, lane, lm] = [None] * W
                                    for m in range(1, W):
                                        ring[wp, lane, lm][W - m] = \
                                            keyv[base + o0 - 32 * m:][:8]
                        for s in range(steps):
                            ks, i = j * steps + s, s % W
                            B = np.zeros((ROWS, 32), np.int64)
                            for n in range(ROWS):
                                for kb in range(32):
                                    byte = (ks & 3) * 32 + kb
                                    B[n, kb] = dig[(ks >> 2) * 1024 + n * 128
                                                   + (((byte >> 4) ^ n) & 7)
                                                   * 16 + (byte & 15)]
                            A = np.zeros((tiles, 4, 64, 32), np.int64)
                            for wp in range(4):
                                for lane in range(32):
                                    g8, q = lane // 4, lane % 4
                                    c = tile * 64 * tiles + 8 * wp + g8
                                    o0 = N - c + 8 * q
                                    for lm in range(4):
                                        base = (lm * J + j) * VB
                                        rr = ring[wp, lane, lm]
                                        rr[i] = keyv[base + o0 + 32 * s:][:8]
                                        for tau in range(tiles):
                                            hi = rr[(i + 2 * W - 2 * tau - 1)
                                                    % W]
                                            lo = rr[(i + 2 * W - 2 * tau) % W]
                                            row = 16 * wp + g8
                                            A[tau, lm, row, 4 * q:4 * q + 4] \
                                                = hi[:4]
                                            A[tau, lm, row + 8,
                                              4 * q:4 * q + 4] = lo[:4]
                                            A[tau, lm, row,
                                              16 + 4 * q:20 + 4 * q] = hi[4:]
                                            A[tau, lm, row + 8,
                                              16 + 4 * q:20 + 4 * q] = lo[4:]
                            D += A @ B.T
                    for wp in range(4):
                        for lane in range(32):
                            g8, q = lane // 4, lane % 4
                            c = tile * 64 * tiles + 8 * wp + g8
                            for e in range(4):
                                r = 2 * q + (e & 1)
                                if r >= nr:
                                    continue
                                for tau in range(tiles):
                                    i = c + 64 * tau + (0 if e >> 1 else 32)
                                    row = 16 * wp + g8 + 8 * (e >> 1)
                                    v = acc[g, 2 * (s0 + r), u, i] + sum(
                                        int(D[tau, lm, row, r]) << (8 * lm)
                                        for lm in range(4))
                                    out[g, s0 + r, u, i] = v
    return torch.from_numpy((((out + (1 << 31)) & M32) - (1 << 31))
                            .astype(np.int32))


@pytest.mark.parametrize("N,tiles,S,l,bgbit", [(64, 1, 3, 2, 8),
                                               (512, 4, 9, 3, 6),
                                               (128, 1, 1, 2, 8),
                                               (256, 4, 2, 2, 8)])
def test_kernel_index_model_matches_plain(N, tiles, S, l, bgbit):
    """The kernel's layouts, modelled: equal to the plain version (a fault
    in a slot, a run offset or an epilogue row changes the bits)."""
    r = np.random.default_rng(N + S)
    p = _gadget(l, bgbit)
    acc = _i32(r, (2, 2 * S, 2, N))
    sel = _i32(r, (2, 2, l, 2, N))
    want = K.lut_cmux_plain(acc, sel, l=l, bgbit=bgbit, offset=p.offset)
    assert torch.equal(_kernel_model(acc, sel, l, bgbit, p.offset, tiles),
                       want)


@pytest.mark.parametrize("N,tiles", [(64, 1), (128, 1), (192, 1),
                                     (256, 4), (1024, 4), (2048, 4)])
def test_lut_cmux_plan(N, tiles):
    assert K.lut_cmux_plan(N) == tiles


# --- the staged LUT query at CB_TOY against the benchmark's reference ---

def _judge():
    path = REPO / "gpu_bench/reference/judges/lut_tree.py"
    spec = importlib.util.spec_from_file_location("judge_lut_tree", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.judge


@pytest.fixture(scope="module")
def toy():
    """The client's raw key and secrets at CB_TOY from a seed, and the
    program's key built from it (gpu_bench.server)."""
    client = Client(SEED, "cpu")
    secret, raw = client.circuit_key(CB_TOY_CFG)
    srv = server.CircuitServer.build(CB_TOY_CFG, raw, "cpu")
    return client, secret, raw, srv


def _queries(toy, inst, k=4, seed=0):
    client, secret, _, _ = toy

    class Ctx:
        pass
    ctx = Ctx()
    ctx.client = client
    bits = client.bits((inst * k,))
    return loops._bits_lwe(ctx, bits, -(1 << 31), 0, secret["ring_lvl1"][0],
                           CB_TOY_CFG["input_stdev_log2"]).to(torch.int32)


def _table(toy, rows: bool, k=4):
    client = toy[0]
    return client.uniform((1 << k, P1.tlwe.N) if rows else (1 << k,), 32)


@pytest.mark.parametrize("rows", [False, True], ids=["scalar", "rows"])
@pytest.mark.parametrize("inst", [1, 3, 8])
def test_lut_staged_matches_reference(toy, inst, rows):
    _, _, raw, srv = toy
    k = 4
    x = _queries(toy, inst)
    table = _table(toy, rows)
    fn = lut.make_lut_staged(CB_TOY, "chunked", k)
    got = fn(x, srv.key_data, lut.pack_table(table, P1.tlwe.N))
    assert got.shape == (inst, 2, P1.tlwe.N) and got.dtype == torch.int32
    want = _judge()(x.reshape(inst, k, -1).to(torch.int64), raw, CB_TOY_CFG,
                    {"table": table})
    assert torch.equal(got.to(torch.int64), want)


def test_swapped_selectors_are_caught(toy):
    """A tree that reads another instance's selectors gives other bits:
    instances 0 and 1 swapped, both answers differ from the reference."""
    _, _, raw, srv = toy
    k, inst = 4, 3
    x = _queries(toy, inst)
    table = _table(toy, True)
    want = _judge()(x.reshape(inst, k, -1).to(torch.int64), raw, CB_TOY_CFG,
                    {"table": table})
    from tfhe_tpu_torch.boot import circuit
    gsw = circuit.circuit_bootstrap(x, srv.key_data, CB_TOY)
    gsw = gsw.reshape(inst, k, *gsw.shape[1:])
    leaves = lut.pack_table(table, P1.tlwe.N)
    assert torch.equal(lut.lut_tree(gsw, leaves, P1).to(torch.int64), want)
    swapped = gsw[[1, 0, 2]]
    got = lut.lut_tree(swapped, leaves, P1).to(torch.int64)
    assert not torch.equal(got[0], want[0])
    assert not torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])


def test_lut_counters(toy):
    """A call counts one launch, its instances and instances * (2^k - 1)
    CMux rows, outside the programs; the plain kernel versions count no
    launches."""
    _, _, _, srv = toy
    fn = lut.make_lut_staged(CB_TOY, "chunked", 4)
    leaves = lut.pack_table(_table(toy, False), P1.tlwe.N)
    x = _queries(toy, 3)
    obs.reset()
    fn(x, srv.key_data, leaves)
    fn(x, srv.key_data, leaves)
    c = obs.report()["counters"]
    assert (c["lut.launches"], c["lut.instances"], c["lut.cmux_rows"]) == \
        (2, 6, 90)
    assert c["bootstrap.circuit_launches"] == 2
    assert "kernel.lut_cmux" not in c
    spans = obs.report()["spans"]
    assert spans["lut.eval"]["count"] == 2
    assert spans["graph.lut.tree"]["count"] == 2


def test_pack_table_forms():
    N = P1.tlwe.N
    vals = torch.arange(4, dtype=torch.int32)
    leaves = lut.pack_table(vals, N)
    assert leaves.shape == (4, 2, N)
    assert torch.equal(leaves[:, 1, 0], vals)
    assert not leaves[:, 0].any() and not leaves[:, 1, 1:].any()
    rows = torch.arange(4 * N, dtype=torch.int32).reshape(4, N)
    assert torch.equal(lut.pack_table(rows, N)[:, 1], rows)
    with pytest.raises(ValueError, match="expected N"):
        lut.pack_table(rows[:, :N // 2], N)


def test_the_domain_the_tree_refuses(toy):
    r = np.random.default_rng(1)
    sel = _i32(r, (2, 4, 2, 2, 2, 64))
    leaves = lut.pack_table(torch.arange(16), 64)
    with pytest.raises(ValueError, match="4-limb key"):
        lut.lut_tree(sel, leaves, dataclasses.replace(P1, key_limbs=3))
    with pytest.raises(ValueError, match="leaves"):
        lut.lut_tree(_i32(r, (2, 3, 2, 2, 2, 64)), leaves, P1)
    with pytest.raises(ValueError, match="8 bits"):
        K.lut_cmux(_i32(r, (1, 2, 2, 64)), _i32(r, (1, 2, 2, 2, 64)), l=2,
                   bgbit=9, offset=0)
    with pytest.raises(ValueError, match="lut_cmux sel"):
        K.lut_cmux(_i32(r, (1, 2, 2, 64)), _i32(r, (1, 2, 3, 2, 64)), l=2,
                   bgbit=8, offset=0)
    fn = lut.make_lut_staged(CB_TOY, "chunked", 4)
    with pytest.raises(ValueError, match="4-bit LUTs"):
        fn(_queries(toy, 1)[:3], toy[3].key_data, leaves)


def test_mix_file_holds_the_cells_numbers():
    mix = json.loads((REPO / "gpu_bench/traffic/lut4_b256.json").read_text())
    assert mix == {"loop": "lut_stream", "lut_bits": 4, "instances": 64,
                   "pool_batches": 16, "sample": 4, "trace_units": 10}
