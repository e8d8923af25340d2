"""Explicit dp x ep scale-out of the gate and circuit bootstraps (the
counterpart of ``tfhe_tpu.parallel.shard``).

The JAX package writes each device's work and every collective out with
``shard_map`` + ``lax.psum``; here each rank runs that per-device body
(``local_fn``) on its own slice, and each psum is one
``mesh.all_reduce_exact`` over the rank's ep group.

Axes:
  dp  ciphertext batch, no collectives: each rank takes B/dp rows.
  ep  the external product's digit-row axis J = (k+1)*l: each rank holds
      the J/ep slice of every step's prepared TRGSW and contracts its slice
      of the digits; the partial (B/dp, k+1, N) products add with ONE
      all-reduce a blind-rotation step.  The key switches' one-hot rows
      split the same way, one all-reduce a switch.

The accumulator is replicated over ep: every rank rotates and decomposes
the whole accumulator (``kernels.rotate_decompose`` at 32 bits,
``kernels.rotate_decompose64`` at 64, whose plain layout makes a rank's J
slice a contiguous row range) and contracts its J/ep digit rows through
the engine's generic product, ``eng.accumulate``: on the onthefly engine
``materialize_wt`` + ``mm_recombine_acc_wt`` at K = (J/ep)*N, on the chunked
engine ``ck_layout`` + ``ck_dot64p`` at J*m = (J/ep)*m, on conv
``materialize_wt`` + int8 GEMMs.  No fused step takes a digit slice, and
neither does the JAX package's (its sharded step is the generic one), so
the loop runs eagerly, one collective a step (gloo collectives cannot be
captured in a CUDA graph).  ep is a key-MEMORY axis, not a throughput
axis: the rotation work repeats on every ep rank and only the contraction
divides; dp is the throughput axis.

Key slices: onthefly ``v`` (n, L, J, U, 2N) on axis 2, matmul ``w`` (n, L,
J*N, U*N) on its J*N rows, the chunked 64-bit ``wmt`` (n, U*L, N+m, J*m) on
its LAST axis (J*m columns, j-major: the JAX ``wm`` (n, U*L, J*m, N+m)
splits its axis 2 instead), conv ``k`` (n, J*U*L, 1, 2N-1) on axis 1;
the gate key switch ``ksw`` (4, rows, cols), preKS (4, rows, cols) and
privKS (k+1, 4, rows, (k+1)*N) on their one-hot rows.  ``local_circuit_bk``
builds a rank's bk slice straight from the raw TRGSW rows, so no process
ever holds the whole prepared key (8.1 GB of ``wmt`` at CB_MXU).

Every sum is exact (int32/int64 wrap addition is associative and the
all-reduce is exact), so each rank's rows equal the single-device
``gate.bootstrap`` / ``circuit.circuit_bootstrap`` rows bit for bit.
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch import lwe, noise, tgsw, tlwe
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.boot.blind_rotate import generic_digits
from tfhe_tpu_torch.ops import kernels, poly
from tfhe_tpu_torch.ops.engine import make_engine, prepare_stacked, \
    step_prepared
from tfhe_tpu_torch.parallel.mesh import (Mesh, _grid_mesh,
                                          place_batch_rows, place_tree)


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              ep: int | None = None, *, device=None) -> Mesh:
    """(dp, ep) mesh over the first ``n_devices`` ranks (default: the
    world); ep defaults to 2 on an even world larger than 1, as JAX's.
    Every rank of the world must call it (it makes process groups)."""
    return _grid_mesh(n_devices, dp, ep, ("dp", "ep"), 2, device)


def _bk_ep_spec(backend: str) -> tuple:
    """Spec of a stacked prepared-bk leaf, J axis split over ep: onthefly
    (n, L, J, U, 2N) on axis 2; matmul (n, L, J*N, U*N) on its (j, t) rows,
    a contiguous J*N split dividing J."""
    if backend == "onthefly":
        return (None, None, "ep", None, None)
    if backend == "matmul":
        return (None, None, "ep", None)
    raise ValueError(f"ep sharding not defined for backend {backend!r}")


def _ksw_granules(ks) -> dict:
    """Split unit of a gate key switch's rows: one input coefficient's
    t*base rows.  Where ep does not divide the rows (the JAX package's
    shard_map refuses those), ranks take whole coefficients, so every
    block stays a multiple of 8 rows for the card's int8 GEMM."""
    return {1: ks.t * ks.base}


def key_shardings(mesh: Mesh, key_data, backend: str = "onthefly"):
    """Placement specs of a gate CloudKey.data under dp x ep."""
    bk = _bk_ep_spec(backend)
    return {"bk": {name: bk for name in key_data["bk"]},
            "ksw": (None, "ep", None)}


def _gate_key_local(key_data, mesh: Mesh, backend: str, ks=None):
    """This rank's slices of a gate key (the key-switch rows in whole input
    coefficients of ``ks`` where ep does not divide them)."""
    return place_tree(key_data, key_shardings(mesh, key_data, backend), mesh,
                      {"ksw": _ksw_granules(ks)} if ks else None)


def _digits(a, acc, p):
    """Gadget digits (B, kpl, N) of (X^a - 1) * acc, row-major (polynomial,
    level): at 64 bits with one or two planes ``rotate_decompose64`` (two
    planes recombined into one int32 digit), else the generic step's
    (``blind_rotate.generic_digits``)."""
    if p.tlwe.bits != 64 or p.bgbit > 14:
        return generic_digits(a, acc, p)
    B, _, N = acc.shape
    P = 1 if p.bgbit <= 8 else 2
    d = kernels.rotate_decompose64(a, acc, l=p.l, bgbit=p.bgbit,
                                   offset=p.offset, planes=P)
    d = d.view(B, p.kpl, P, N)
    if P == 1:
        return d[:, :, 0]
    return d[:, :, 0].to(torch.int32) + 128 * d[:, :, 1].to(torch.int32)


def _local_blind_rotate(acc, bk_local, abar, p, eng, mesh: Mesh,
                        axis: str = "ep"):
    """Per-rank body: the whole rotation, this rank's digit-slice
    contraction, one all-reduce of the partial product a step; acc
    replicated over ``axis``."""
    J = p.kpl // mesh.shape[axis]
    jlo = mesh.index(axis) * J
    steps = abar.t().contiguous()                     # (n, B): rows contiguous
    for i in range(steps.shape[0]):
        digits = _digits(steps[i], acc, p)[:, jlo:jlo + J]
        part = eng.accumulate(digits, step_prepared(bk_local, i))
        acc = T.add(acc, mesh.all_reduce(part, axis))
    return acc


def _onehot(digs, base: int):
    """(..., n, t) digits -> (M, n*t*base) int8 one-hot rows."""
    ar = torch.arange(base, dtype=torch.int32, device=digs.device)
    onehot = (digs[..., None] == ar).to(torch.int8)
    return onehot.reshape(-1, digs.shape[-2] * digs.shape[-1] * base)


def _partial_product(onehot, w_limbs, lo: int):
    """sum_l (onehot[:, lo:lo+rows] @ w_limbs[l]) << 8l, mod 2^32 (int32):
    this rank's block of a one-hot key switch."""
    rows = w_limbs.shape[-2]
    x = onehot[:, lo:lo + rows].contiguous()
    acc = 0
    for lm in range(w_limbs.shape[0]):
        acc = acc + (lwe._int8_matmul(x, w_limbs[lm]).to(torch.int64)
                     << (8 * lm))
    return T.wrap32(acc)


def _local_keyswitch(samples, w_limbs_local, ks, n_out, mesh: Mesh,
                     axis: str = "ep", granules: dict | None = None):
    """One-hot key switch with the contracted rows split over ``axis``:
    each rank multiplies its row block (the rows ``Mesh.span`` gives it),
    one all-reduce adds the sums (lweKeySwitch, lwe_functions.cpp:163-172).
    samples (B, n_in+1) -> (B, n_out+1) int32."""
    a, b = samples[..., :-1], samples[..., -1]
    lead = samples.shape[:-1]
    onehot = _onehot(lwe.keyswitch_digits(a, ks), ks.base)
    lo, _ = mesh.span(axis, onehot.shape[-1],
                      (granules or _ksw_granules(ks))[1])
    acc = mesh.all_reduce(_partial_product(onehot, w_limbs_local, lo), axis)
    acc = acc[:, :n_out + 1].reshape(*lead, n_out + 1)
    triv = lwe.noiseless_trivial(b, n_out).to(torch.int64)
    return T.wrap32(triv - acc)


def _rotate_and_extract(tv, bk_local, barb, bara, p, eng, mesh: Mesh):
    """testvector * X^{2N - barb}, the sharded rotation by bara, coefficient
    0 extracted (boot.blind_rotate.rotate_and_extract)."""
    N = p.tlwe.N
    tv = poly.mul_by_xai((2 * N - barb) % (2 * N),
                         tv.expand(barb.shape[0], N))
    acc = tlwe.noiseless_trivial_poly(tv, p.tlwe.k)
    acc = _local_blind_rotate(acc, bk_local, bara, p, eng, mesh)
    return tlwe.extract_lwe(acc, 0)


def make_sharded_bootstrap_fn(params, mesh: Mesh, backend: str = "onthefly",
                              mu: int | None = None):
    """Explicit-collective gate bootstrap over a (dp, ep) mesh.

    Returns (fn(local_key, local_rows) -> this rank's output rows,
    place(key_data, samples) -> (local_key, local_rows)): ``place`` takes
    this rank's J/ep slice of every bk leaf, its block of the key-switch
    rows and its B/dp rows (made contiguous, on the mesh's device; dp must
    divide B, see ``pad_batch``).  Bit-identical to ``gate.bootstrap``."""
    from tfhe_tpu_torch.boot import gate

    p = params.tgsw
    mu = gate.MU_BOOL if mu is None else mu
    ep = mesh.shape["ep"]
    _bk_ep_spec(backend)                  # raises on other backends
    if p.kpl % ep:
        raise ValueError(
            f"ep={ep} does not divide the digit-row count kpl={p.kpl} "
            f"((k+1)*l for this parameter set): pick ep from its divisors "
            f"or add a dp-only mesh (the bk cannot be row-padded without "
            f"changing the gadget)")
    eng = make_engine(tgsw.engine_config(p), backend)
    N = p.tlwe.N

    def local_fn(key_data, samples):
        a, b = samples[..., :-1], samples[..., -1]
        barb = T.mod_switch_from_torus32(b, 2 * N)
        bara = T.mod_switch_from_torus32(a, 2 * N)
        tv = torch.full((N,), mu, dtype=torch.int32, device=samples.device)
        u = _rotate_and_extract(tv, key_data["bk"], barb, bara, p, eng, mesh)
        return _local_keyswitch(u, key_data["ksw"], params.ks, params.lwe.n,
                                mesh)

    def place(key_data, samples):
        return (_gate_key_local(key_data, mesh, backend, params.ks),
                place_batch_rows(samples, mesh))

    return local_fn, place


# ---------------------------------------------------------------------------
# Circuit bootstrapping
# ---------------------------------------------------------------------------

def _cb_bk_ep_spec(backend: str) -> tuple:
    """Spec of a stacked prepared lvl2-bk leaf, digit-row axis split over
    ep: chunked ``wmt`` (n, U*L, N+m, J*m) on its last axis ((j, s)-major
    columns, so a contiguous split divides J); conv ``k`` (n, J*U*L, 1,
    2N-1) on its j-major rows."""
    if backend == "chunked":
        return (None, None, None, "ep")
    if backend == "conv":
        return (None, "ep", None, None)
    raise ValueError(
        f"circuit-bootstrap ep sharding not defined for backend {backend!r}")


def circuit_key_shardings(mesh: Mesh, key_data, backend: str = "chunked"):
    """Placement specs of a CircuitCloudKey.data under dp x ep (the
    key-placement policy of the JAX package's ``circuit_key_shardings``):
    the lvl2 bk's digit rows, the preKS and the privKS one-hot rows split
    over ep; the (B/dp, k+1, N2) Torus64 accumulator replicated over ep."""
    bk = _cb_bk_ep_spec(backend)
    return {"bk": {name: bk for name in key_data["bk"]},
            "preks": (None, "ep", None),
            "privks": (None, None, "ep", None)}


def local_circuit_bk(bk_raw, p, mesh: Mesh, backend: str = "chunked"):
    """This rank's prepared lvl2 bk, built from its J/ep slice of the raw
    TRGSW64 rows (``CircuitCloudKey.bk_raw``, (n0, k+1, l2, k+1, N2)) on
    the mesh's device: the same bytes as its slice of the whole prepared
    key, without the whole key (``boot.circuit.prepare_circuit_bk``)."""
    _cb_bk_ep_spec(backend)               # raises on other backends
    pl = p.tgsw_lvl2
    jlo, jhi = mesh.span("ep", pl.kpl)
    rows = tgsw.rows(torch.as_tensor(bk_raw))[:, jlo:jhi]
    rows = rows.contiguous().to(mesh.device)
    eng = make_engine(tgsw.engine_config(pl), backend)
    return prepare_stacked(eng, rows)


def _circuit_key_local(key_data, mesh: Mesh, backend: str, p, bk_raw):
    """This rank's slices of a circuit key; where ``key_data["bk"]`` is
    None, its bk slice built from the raw rows ``bk_raw``.  The packed
    privKS table (``privks_packed``) is left out: the sharded key switch
    splits the row-major one-hot rows."""
    raw = key_data.get("bk") is None
    data = {k: v for k, v in key_data.items() if k != "privks_packed"}
    data["bk"] = {} if raw else key_data["bk"]
    key = place_tree(data, circuit_key_shardings(mesh, data, backend), mesh)
    if raw:
        key["bk"] = local_circuit_bk(bk_raw, p, mesh, backend)
    return key


def _local_priv_keyswitch(x64, w_local, ks, z: int, k: int, N: int,
                          mesh: Mesh, axis: str = "ep"):
    """Private functional key switch with the one-hot rows split over ep
    (circuitPrivKS, poc_CircuitBootstrapping.cpp:667-698): each rank
    multiplies its row block of privKS[z], one all-reduce adds the sums."""
    from tfhe_tpu_torch.boot.circuit import priv_keyswitch_digits
    digs = priv_keyswitch_digits(x64, ks)                # (..., n+1, t)
    onehot = _onehot(digs, ks.base)
    lo, _ = mesh.span(axis, onehot.shape[-1])
    acc = mesh.all_reduce(_partial_product(onehot, w_local[z], lo), axis)
    return T.wrap32(-acc.to(torch.int64)).reshape(*digs.shape[:-2], k + 1,
                                                   N)


def make_sharded_circuit_bootstrap_fn(p, mesh: Mesh, backend: str = "chunked",
                                      shared_rotation: bool | None = None):
    """Explicit-collective circuit bootstrap over a (dp, ep) mesh
    (tfhe_CircuitBootstrapFFT, poc_CircuitBootstrapping.cpp:823-873, in
    ``boot.circuit``'s corrected composition).

    The batch splits over dp; ep splits every contraction's rows (preKS,
    the lvl2 digit rows J = (k+1)*l2, privKS) with one all-reduce a
    blind-rotation step and a key switch.  Its purpose is KEY MEMORY: ep=2
    halves the 8.1 GB chunked ``wmt`` and the 2.7 GB privKS a rank holds at
    CB_MXU.

    Returns (fn(local_key, local_rows) -> this rank's TRGSW rows
    (B/dp, k+1, ell1, k+1, N1), place(key_data, samples, bk_raw=None) ->
    (local_key, local_rows)).  ``place`` slices a whole prepared key, or,
    with ``key_data["bk"]`` None, builds the rank's bk slice from the raw
    rows ``bk_raw`` (``local_circuit_bk``).  Bit-identical to
    ``circuit.circuit_bootstrap`` on the same backend."""
    N2 = p.n_lvl2
    k = p.lvl1.k
    ell1, bgbit1 = p.tgsw_lvl1.l, p.tgsw_lvl1.bgbit
    ep = mesh.shape["ep"]
    if shared_rotation is None:
        shared_rotation = (noise.shared_rotation_penalty(p)
                           <= noise.SHARED_ROTATION_MAX_PENALTY)
    kpl2 = p.tgsw_lvl2.kpl
    if kpl2 % ep:
        raise ValueError(
            f"ep={ep} does not divide the lvl2 digit-row count kpl={kpl2}: "
            f"pick ep from its divisors")
    preks_rows = p.n_lvl1 * p.ks10.t * p.ks10.base
    privks_rows = (p.n_lvl2 + 1) * p.ks21.t * p.ks21.base
    for name, rows in (("preKS", preks_rows), ("privKS", privks_rows)):
        if rows % ep:
            raise ValueError(f"ep={ep} does not divide the {name} "
                             f"contraction rows ({rows})")
    _cb_bk_ep_spec(backend)               # raises on other backends
    eng2 = make_engine(tgsw.engine_config(p.tgsw_lvl2), backend)

    def local_fn(key_data, samples):
        # 1. preKS lvl1 -> lvl0, rows over ep (poc:832)
        x0 = _local_keyswitch(samples, key_data["preks"], p.ks10, p.n_lvl0,
                              mesh, granules={1: 1})
        # 2. mod switch to Z_{2*N2} (poc:836)
        abar = T.mod_switch_from_torus32(x0[..., :-1], 2 * N2)
        bbar = T.mod_switch_from_torus32(x0[..., -1], 2 * N2)

        # 3. blind rotation(s) at lvl2, digit rows over ep
        def rotate_for(mu2: int):
            sign = torch.ones(N2, dtype=torch.int64, device=abar.device)
            sign[:N2 // 2] = -1
            ext = _rotate_and_extract(sign * mu2, key_data["bk"], bbar, abar,
                                      p.tgsw_lvl2, eng2, mesh)
            ext[..., -1] += mu2      # recentre: the message is {0, mu_w}
            return ext

        if shared_rotation:
            base = rotate_for(1 << (63 - ell1 * bgbit1))
            exts = [base << (bgbit1 * (ell1 - 1 - w)) for w in range(ell1)]
        else:
            exts = [rotate_for(1 << (63 - (w + 1) * bgbit1))
                    for w in range(ell1)]

        # 4. private functional key switches, rows over ep (poc:845-855)
        rows = [_local_priv_keyswitch(ext, key_data["privks"], p.ks21, z, k,
                                      p.n_lvl1, mesh)
                for ext in exts for z in range(k + 1)]
        out = torch.stack(rows, dim=-3)        # (B, ell1*(k+1), k+1, N1)
        out = out.reshape(*out.shape[:-3], ell1, k + 1, k + 1, p.n_lvl1)
        return out.transpose(-4, -3).contiguous()   # (B, k+1, ell1, k+1, N1)

    def place(key_data, samples, bk_raw=None):
        return (_circuit_key_local(key_data, mesh, backend, p, bk_raw),
                place_batch_rows(samples, mesh))

    return local_fn, place


def pad_batch(samples, mesh: Mesh):
    """Round a ragged batch up to a multiple of dp with zero rows (they
    bootstrap to valid encryptions of False and are sliced off by the
    caller).  Returns (padded, original_length)."""
    dp = mesh.shape["dp"]
    samples = torch.as_tensor(samples)
    B = samples.shape[0]
    pad = (-B) % dp
    if pad:
        samples = torch.cat([samples, samples.new_zeros(
            (pad,) + tuple(samples.shape[1:]))], dim=0)
    return samples, B
