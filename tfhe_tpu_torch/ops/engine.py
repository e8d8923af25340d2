"""Negacyclic product engines (the counterpart of ``tfhe_tpu.ops.engine``).

The product (int poly) x (torus poly) mod X^N+1 is an EXACT integer
computation: the fixed operand (a key) is split into balanced signed int8
limbs at preparation time, the varying operand (gadget digits) is int8 (or
split into base-2^7 planes when wider), every limb x plane product is an
int8 x int8 -> int32 contraction, and the partial results are recombined
with shifts mod 2^32 (or 2^64 for the Torus64 ring of the circuit
bootstrap).  On the GPU the contractions run in the int8 tensor cores
through the kernels of ``ops.kernels``; on the CPU the same wrappers take
their plain versions, so both devices take the same dispatch.

Contract shared by the engines:

  prepare(key_polys (J, U, N) torus)  -> prepared dict of tensors
  accumulate(x (..., J, N) digits, prepared) -> (..., U, N) torus

  result[..., u, :] = sum_j negacyclic(x[..., j, :], key[j, u, :])

Backends (every name of the JAX package's ``make_engine``): ``naive``
(exact einsum oracle, CPU; 32 and 64 bits), ``matmul`` (dense negacyclic
limb matrices) and ``onthefly`` (O(N) doubled-limb vectors, the matrices
materialized per call) at 32 bits, ``chunked`` (pre-shifted chunked keys)
at 32 and 64 bits, ``conv`` and ``conv_bf16`` (the JAX package's
convolution kernels as the key, evaluated on onthefly's route) at 32 and
64 bits, ``nussbaumer`` (``ops.nussbaumer``) and ``fft``, ``fft_f64`` and
``fft_dd`` (``ops.fft``, approximate).

A prepared key is a dict whose leaves are tensors, or tuples of tensors
(the dd FFT key); ``stack_prepared`` and ``step_prepared`` stack per-step
keys and take one step's back without renaming or reshaping a leaf, and
``prepare_stacked`` prepares a whole bootstrapping key, every step's TRGSW
rows, into such a stacked key.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tfhe_tpu_torch import lwe
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.ops import kernels, poly


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    N: int
    out_bits: int          # torus width of the result (32 or 64)
    digit_bits: int        # log2 bound on the varying operand's magnitude
    key_bits: int = 0      # width of the fixed operand (0 -> out_bits)
    limb_bits: int = 8     # key limb width
    key_limbs: int = 0     # 0 = exact; else truncate the key to this many
                           # limbs (round-to-nearest on the dropped low bits)

    @property
    def kbits(self) -> int:
        return self.key_bits or self.out_bits

    @property
    def num_limbs(self) -> int:
        full = -(-self.kbits // self.limb_bits)
        if self.key_limbs:
            assert 0 < self.key_limbs <= full
            return self.key_limbs
        return full

    @property
    def key_shift(self) -> int:
        """Bits dropped (with rounding) from the key before limb splitting."""
        return max(0, self.kbits - self.num_limbs * self.limb_bits)

    @property
    def plane_split(self):
        """(plane_bits, num_planes) for the varying operand: digits of at
        most 8 bits pass as one int8 plane, wider ones split into balanced
        base-2^7 planes."""
        if self.digit_bits <= 8:
            return (self.digit_bits, 1)
        m, planes = 1 << (self.digit_bits - 1), 0
        while m:
            m = (m + 64) >> 7
            planes += 1
        return (7, planes)


def _require_32(cfg: EngineConfig):
    if cfg.out_bits != 32:
        raise ValueError("the matmul and onthefly engines take a 32-bit "
                         "torus; the 64-bit ring runs on 'chunked' or "
                         "'naive'")


def _digit_planes(cfg: EngineConfig, x):
    """Split the varying operand (..., J, N) into int8 planes (P, ..., J, N)."""
    pb, np_ = cfg.plane_split
    if np_ == 1:
        return torch.as_tensor(x).to(torch.int8)[None]
    return T.signed_planes(x, pb, np_)


def _key_rounded(cfg: EngineConfig, key_polys):
    """Round the key to its top num_limbs*limb_bits bits (key_limbs
    truncation); identity when key_shift == 0."""
    s = cfg.key_shift
    if not s:
        return key_polys
    # clamp the two extreme values (+-2^(kbits-s-1)) that would need an
    # L+1-th balanced limb
    # (at 64 bits the add wraps, as the JAX package's int64 add does)
    wide = key_polys.to(torch.int64) + (1 << (s - 1))
    lim = (1 << (cfg.kbits - s - 1)) - 1
    return torch.clamp(wide >> s, -lim, lim).to(
        torch.int32 if cfg.kbits <= 32 else torch.int64)


def _limbs_doubled(cfg: EngineConfig, key_polys):
    """Balanced limbs of [key, -key]: (L, ..., 2N) int8, at 32 or 64 bits.
    Negation happens in the torus domain before limb splitting; rounding
    happens first so the wrap half is exactly the negated rounded key."""
    key_polys = _key_rounded(cfg, key_polys)
    doubled = torch.cat([key_polys, -key_polys], dim=-1)
    return T.balanced_limbs(doubled, cfg.num_limbs, cfg.limb_bits)


def _key_limbs_doubled(cfg: EngineConfig, key_polys):
    """_limbs_doubled for the 32-bit matmul and onthefly engines."""
    _require_32(cfg)
    return _limbs_doubled(cfg, key_polys)


def _fold_planes(cfg: EngineConfig, x, wt, acc):
    """acc + sum_p (plane_p(x) @ w limbs) << (pb*p + key_shift): the whole
    product, one mm_recombine_acc_wt per digit plane.  x: (..., J, N);
    wt: (L, U*N, J*N), the K-packed key; acc: (M, U, N) with M the
    flattened lead of x."""
    pb, _ = cfg.plane_split
    planes = _digit_planes(cfg, x)
    for p in range(planes.shape[0]):
        flat = planes[p].reshape(acc.shape[0], wt.shape[2])
        acc = kernels.mm_recombine_acc_wt(flat.contiguous(), wt, acc,
                                          shift_base=cfg.key_shift + pb * p)
    return acc


def _recombine(cfg: EngineConfig, acc_planes):
    """acc_planes: P tensors (L, ..., U*N) of int32 limb partials -> their
    sum of (limb << 8l) << (pb*p + key_shift) mod 2^out_bits, int32 or int64
    (``tfhe_tpu.ops.engine._recombine``)."""
    pb, _ = cfg.plane_split
    out = None
    for p, limbed in enumerate(acc_planes):
        v = T.recombine_limbs(limbed, cfg.limb_bits, 64)
        sh = pb * p + cfg.key_shift
        v = v << sh if sh else v
        out = v if out is None else out + v
    return out if cfg.out_bits == 64 else T.wrap32(out)


def stack_prepared(preps, device=None) -> dict:
    """Per-step prepared keys -> one dict whose leaves lead with the step
    axis (a tuple leaf stacks part by part), on ``device``."""
    def stack(parts):
        return torch.stack(parts).to(device) if device else torch.stack(parts)
    return {name: (tuple(stack([q[name][i] for q in preps])
                         for i in range(len(leaf)))
                   if isinstance(leaf, tuple)
                   else stack([q[name] for q in preps]))
            for name, leaf in preps[0].items()}


def prepare_stacked(eng, rows, device=None) -> dict:
    """Every step's TRGSW rows (n, kpl, k+1, N) -> the engine-prepared key
    stacked over the n steps, on ``device`` (None: the rows' device).  The
    chunked engine prepares all steps in one pass on ``device``, so only the
    raw rows cross (its pre-shifted key is ~m/2 times their size: 3.34 GB
    at GATE_MXU); the others prepare step by step where the rows lie."""
    if isinstance(eng, ChunkedEngine):
        return eng.prepare(rows if device is None else rows.to(device))
    return stack_prepared([eng.prepare(rows[i])
                           for i in range(rows.shape[0])], device)


def step_prepared(prepared: dict, i: int) -> dict:
    """Step i of a stacked prepared key."""
    return {name: tuple(t[i] for t in leaf) if isinstance(leaf, tuple)
            else leaf[i] for name, leaf in prepared.items()}


def map_prepared(fn, prepared: dict) -> dict:
    """fn applied to every tensor of a prepared key (each part of a tuple
    leaf)."""
    return {name: tuple(fn(t) for t in leaf) if isinstance(leaf, tuple)
            else fn(leaf) for name, leaf in prepared.items()}


class _EngineBase:
    """Shared contract; accumulate_into defaults to acc + accumulate."""

    def accumulate_into(self, acc, x, prepared):
        return acc + self.accumulate(x, prepared)

    def cmux_step(self, a, acc, prepared, *, l: int, bgbit: int, offset: int):
        """acc + recombine(decompose((X^a - 1) * acc) @ key) in one fused
        kernel when eligible, else None (the caller takes the generic
        step)."""
        return None

    def _fused_ok(self, acc, l, bgbit) -> bool:
        """Whether fused_cmux_step_v2 takes this step: on a card, only
        shapes in its kernel's domain (fused_cmux_step_v2_plan); on the CPU
        its plain version takes any."""
        cfg = self.cfg
        return (cfg.out_bits == 32 and cfg.kbits == 32
                and cfg.plane_split[1] == 1 and bgbit <= 8
                and cfg.num_limbs <= 3 and acc.ndim == 3
                and (acc.device.type == "cpu"
                     or kernels.fused_cmux_step_v2_plan(
                         cfg.N, l, cfg.num_limbs) > 0))


class NaiveEngine(_EngineBase):
    """Exact O(N^2) einsum oracle (CPU)."""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg

    def prepare(self, key_polys):
        assert key_polys.shape[-1] == self.cfg.N
        return {"mat": poly.negacyclic_matrix(key_polys)}   # (J, U, N, N)

    def accumulate(self, x, prepared):
        # int64 products wrap mod 2^64, which is the 64-bit torus and keeps
        # the result mod 2^32
        y = torch.einsum("...jt,juti->...ui", torch.as_tensor(x).to(torch.int64),
                         prepared["mat"].to(torch.int64))
        return y if self.cfg.out_bits == 64 else T.wrap32(y)


class MatmulEngine(_EngineBase):
    """Dense negacyclic limb matrices; one int8 GEMM per digit plane."""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg

    def prepare(self, key_polys):
        cfg = self.cfg
        J, U, N = key_polys.shape
        assert N == cfg.N
        limbs = _key_limbs_doubled(cfg, key_polys)          # (L,J,U,2N)
        ar = torch.arange(N, device=key_polys.device)
        idx = (ar[None, :] - ar[:, None]) % (2 * N)
        mat = limbs[..., idx]                               # (L,J,U,t,i)
        w = mat.permute(0, 1, 3, 2, 4)                      # (L,J,t,U,i)
        return {"w": w.reshape(cfg.num_limbs, J * N, U * N).contiguous()}

    def _wt(self, prepared):
        """The K-packed key of the fused step and of mm_recombine_acc_wt:
        the dense W transposed per call (a copy of L*J*U*N^2 bytes, 21.2 MB
        at GATE_FAST2)."""
        return prepared["w"].transpose(1, 2).contiguous()

    def accumulate(self, x, prepared):
        wt = self._wt(prepared)
        L, UN, JN = wt.shape
        N = self.cfg.N
        lead = x.shape[:-2]
        M = x[..., 0, 0].numel()
        acc = torch.zeros((M, UN // N, N), dtype=torch.int32, device=wt.device)
        return _fold_planes(self.cfg, x, wt, acc).reshape(*lead, UN // N, N)

    def accumulate_into(self, acc, x, prepared):
        if acc.ndim != 3 or x.ndim != 3:
            return acc + self.accumulate(x, prepared)
        return _fold_planes(self.cfg, x, self._wt(prepared), acc)

    def cmux_step(self, a, acc, prepared, *, l, bgbit, offset):
        if not self._fused_ok(acc, l, bgbit):
            return None
        return kernels.fused_cmux_step_v2(a, acc, self._wt(prepared), l=l,
                                          bgbit=bgbit, offset=offset,
                                          key_shift=self.cfg.key_shift)


class OnTheFlyMatmulEngine(MatmulEngine):
    """Keys stored as O(N) doubled-limb vectors (L, J, U, 2N) int8; every
    call materializes the negacyclic limb matrices K-packed
    (kernels.materialize_wt) and runs the same int8 GEMM or fused step as
    MatmulEngine.  The dense matrices would cost N times the key memory
    (n * 21 MB at GATE_FAST2)."""

    def prepare(self, key_polys):
        J, U, N = key_polys.shape
        assert N == self.cfg.N
        return {"v": _key_limbs_doubled(self.cfg, key_polys).contiguous()}

    def _wt(self, prepared):
        return kernels.materialize_wt(prepared["v"])


class ChunkedEngine(_EngineBase):
    """Pre-shifted chunked keys: the negacyclic product as C = N/m int8
    products against a static key operand (``tfhe_tpu.ops.engine.
    ChunkedEngine``): the N=1024 gate path at 32 bits, the lvl2
    circuit-bootstrap loop at 64 bits (poc_CircuitBootstrapping.cpp:580-642).

    Every key limb is stored as m acyclically shifted copies of width N+m,
        wm[(u,l), (j,s), q] = limb[l, j, u, q - s]   (0 <= q-s < N, else 0),
    so chunk c of the digits (coefficients c*m .. c*m+m-1 of every row j)
    times wm lands at ring offset c*m; the 2N ring folds once with X^N = -1
    (``kernels.ck_dot64p``).  m = 128 at 32 bits and 64 at 64 bits are the
    JAX package's defaults, so its keys carry over byte for byte (3.34 GB
    of wm at GATE_MXU).

    The prepared key is {"wm"} at 32 bits, the layout ``ck_cmux_step32``
    reads.  At 64 bits it is {"wmt"} alone, the same copies K-packed,
        wmt[(u,l), q, (j,s)] = wm[(u,l), (j,s), q],
    the operand that every 64-bit step's contraction reads by TMA
    (``kernels.ck_dot64p``, ``ck_dot64p_acc``, ``ck_dot64p_sacc``,
    ``ck_cmux_step64``): 8.1 GB at CB_MXU, built on the key's device and
    never written to a key file (key files hold the raw TRGSW bk)."""

    def __init__(self, cfg: EngineConfig, m: int | None = None):
        self.cfg = cfg
        self.m = m or min(128 if cfg.out_bits == 32 else 64, cfg.N)
        assert cfg.N % self.m == 0

    def _exact(self, J: int) -> bool:
        """The JAX package's int32 bound on one limb's folded sums (a ring
        position adds J*(N+m) products); at 64 bits ck_dot64p's, where the
        digit planes combine before the fold."""
        cfg = self.cfg
        if cfg.out_bits == 64:
            return kernels.ck_dot64p_exact(J, cfg.N, self.m, cfg.digit_bits)
        max_digit = (1 << (cfg.digit_bits - 1)) if cfg.plane_split[1] == 1 \
            else 64
        return (J * (cfg.N + self.m) * max_digit * (1 << (cfg.limb_bits - 1))
                < 2**31)

    def prepare(self, key_polys):
        """key_polys (..., J, U, N) -> {"wm": (..., U*L, J*m, N+m) int8} at
        32 bits, {"wmt": (..., U*L, N+m, J*m) int8} at 64 bits, built
        directly (wmt[..., g, s + q, (j, s)] = limb[g, j, q]: wm is never
        made); leading axes (the steps of a bootstrapping key) are prepared
        in one pass."""
        cfg = self.cfg
        *lead, J, U, N = key_polys.shape
        assert N == cfg.N
        m, L = self.m, cfg.num_limbs
        if not self._exact(J):
            raise ValueError("int32 accumulation bound exceeded for this "
                             "shape")
        limbs = T.balanced_limbs(_key_rounded(cfg, key_polys), L,
                                 cfg.limb_bits)            # (L, ..., J, U, N)
        n = len(lead)
        lj = limbs.permute(*range(1, n + 1), n + 2, 0, n + 1, n + 3)
        # lj: (..., U, L, J, N)
        if cfg.out_bits == 64:
            # wmt[..., u, l, s + q, j, s] = lj[..., u, l, j, q]
            ljt = lj.transpose(-1, -2)
            wmt = torch.zeros((*lead, U, L, N + m, J, m), dtype=torch.int8,
                              device=key_polys.device)
            for s in range(m):
                wmt[..., s:s + N, :, s] = ljt
            return {"wmt": wmt.reshape(*lead, U * L, N + m, J * m)}
        # wm[..., u, l, j, s, q] = lj[..., q - s]
        wm = torch.zeros((*lead, U, L, J, m, N + m), dtype=torch.int8,
                         device=key_polys.device)
        for s in range(m):
            wm[..., s, s:s + N] = lj
        return {"wm": wm.reshape(*lead, U * L, J * m, N + m)}

    def _ck64_ok(self, acc, Jm: int, P: int, fused: bool = False) -> bool:
        """Whether the 64-bit steps apply: on a card only shapes in their
        kernels' domain (kernels.ck64_kernel_ok and the digit emitter's
        kernels.rotdec_ok; ck_cmux_step64_ok for the ``fused`` one-kernel
        step); the CPU's plain versions take any."""
        if acc.device.type == "cpu":
            return True
        N, m = self.cfg.N, self.m
        if fused:
            return kernels.ck_cmux_step64_ok(N, m, Jm, P)
        return kernels.ck64_kernel_ok(N, m, Jm, P) and kernels.rotdec_ok(N, m)

    def accumulate(self, x, prepared):
        cfg = self.cfg
        pb, P = cfg.plane_split
        if cfg.out_bits == 64:
            wmt = prepared["wmt"]
            UL, _, Jm = wmt.shape
        else:
            wm = prepared["wm"]
            UL, Jm, _ = wm.shape
        U = UL // cfg.num_limbs
        planes = _digit_planes(cfg, x)                      # (P, ..., J, N)
        lead = planes.shape[1:-2]
        flat = planes.reshape(P, -1, Jm // self.m, cfg.N)
        if cfg.out_bits == 64:
            xc = kernels.ck_layout(flat, self.m)
            y = kernels.ck_dot64p(xc, wmt, N=cfg.N, m=self.m, planes=P,
                                  digit_bits=cfg.digit_bits)
            return kernels.recombine(y, U, cfg.key_shift).reshape(
                *lead, U, cfg.N)
        # 32 bits: one contraction per digit plane (balanced 7-bit planes
        # above 8-bit digits), recombined with the plane shift mod 2^32; the
        # key is transposed per call (the 32-bit steps read wm)
        out = 0
        for p in range(P):
            y = kernels.ck_dot64p_wm(kernels.ck_layout(flat[p:p + 1], self.m),
                                     wm, N=cfg.N, m=self.m,
                                     digit_bits=cfg.digit_bits if P == 1
                                     else 7)
            out = out + kernels.recombine(y, U, cfg.key_shift + pb * p)
        return T.wrap32(out).reshape(*lead, U, cfg.N)

    def accumulate_into(self, acc, x, prepared):
        return T.add(acc, self.accumulate(x, prepared))

    def _ck32(self, bgbit: int) -> bool:
        """The JAX package's ck_cmux_step32 predicate: a 32-bit result and
        key, one digit plane, bgbit <= 8."""
        cfg = self.cfg
        return (cfg.out_bits == 32 and cfg.kbits == 32
                and cfg.plane_split[1] == 1 and bgbit <= 8)

    def cmux_step(self, a, acc, prepared, *, l, bgbit, offset):
        """One blind-rotation step on the (B, k+1, N) accumulator, or None
        when ineligible (the caller takes the generic step).

        32 bits: one ck_cmux_step32 kernel.  64 bits, on the native int64
        accumulator: rotate_decompose64_ck (digits straight into the chunk
        layout) -> ck_dot64p on prepared["wmt"] -> limb recombination +
        accumulator add in int64 torch ops (the JAX package's XLA
        epilogue); None on a card outside its kernel's domain."""
        cfg = self.cfg
        if acc.ndim != 3:
            return None
        if cfg.out_bits == 32:
            if not self._ck32(bgbit):
                return None
            return kernels.ck_cmux_step32(a, acc, prepared["wm"], l=l,
                                          bgbit=bgbit, offset=offset,
                                          m=self.m, key_shift=cfg.key_shift)
        pb, P = cfg.plane_split
        wmt = prepared["wmt"]
        if P > 2 or not self._ck64_ok(acc, wmt.shape[-1], P):
            return None
        B, kp1, N = acc.shape
        x = kernels.rotate_decompose64_ck(a, acc, l=l, bgbit=bgbit,
                                          offset=offset, m=self.m, planes=P)
        y = kernels.ck_dot64p(x, wmt, N=N, m=self.m, planes=P,
                              digit_bits=cfg.digit_bits)
        return acc + kernels.recombine(y, kp1, cfg.key_shift)

    def _flat64_planes(self, acc_flat, prepared, fused: bool = False):
        """The digit planes of the 64-bit steps on the flat accumulator (the
        JAX package's predicate: a 64-bit result, P in (1, 2); on a card
        also the kernels' domain), or None."""
        pb, P = self.cfg.plane_split
        if (self.cfg.out_bits != 64 or acc_flat.ndim != 2 or P > 2
                or not self._ck64_ok(acc_flat, prepared["wmt"].shape[-1], P,
                                     fused)):
            return None
        return P

    def cmux_step_flat(self, a, acc_flat, prepared, *, kp1, l, bgbit,
                       offset):
        """One step in one kernel on the flat (B, (k+1)*N) layout, or None
        when ineligible: at 32 bits ck_cmux_step32 (the same kernel as
        cmux_step), at 64 bits ck_cmux_step64 on the int64 accumulator (the
        JAX package's TFHE_CK64_FUSED step, cmux_pair_step_flat), which
        reads prepared["wmt"]."""
        cfg = self.cfg
        if cfg.out_bits == 64:
            P = self._flat64_planes(acc_flat, prepared, fused=True)
            if P is None:
                return None
            return kernels.ck_cmux_step64(a, acc_flat, prepared["wmt"], l=l,
                                          bgbit=bgbit, offset=offset,
                                          m=self.m, key_shift=cfg.key_shift,
                                          planes=P, kp1=kp1)
        if acc_flat.ndim != 2 or not self._ck32(bgbit):
            return None
        return kernels.ck_cmux_step32(a, acc_flat, prepared["wm"], l=l,
                                      bgbit=bgbit, offset=offset, m=self.m,
                                      key_shift=cfg.key_shift, kp1=kp1)

    def _two_kernel_step(self, dot, a, acc_flat, prepared, *, kp1, l, bgbit,
                         offset):
        P = self._flat64_planes(acc_flat, prepared)
        if P is None:
            return None
        cfg = self.cfg
        x = kernels.rotate_decompose64_ck_flat(a, acc_flat, N=cfg.N, l=l,
                                               bgbit=bgbit, offset=offset,
                                               m=self.m, planes=P)
        return dot(x, prepared["wmt"], acc_flat, N=cfg.N, m=self.m,
                   key_shift=cfg.key_shift, planes=P, kp1=kp1,
                   digit_bits=cfg.digit_bits)

    def cmux_step_acc(self, a, acc_flat, prepared, *, kp1, l, bgbit, offset):
        """The 64-bit step with the epilogue fused into the contraction, on
        the flat (B, (k+1)*N) int64 accumulator: rotate_decompose64_ck_flat
        -> ck_dot64p_acc (the JAX package's TFHE_CK64_PATH=acc step) on
        prepared["wmt"].  None when ineligible, on a card also outside its
        kernel's domain."""
        return self._two_kernel_step(kernels.ck_dot64p_acc, a, acc_flat,
                                     prepared, kp1=kp1, l=l, bgbit=bgbit,
                                     offset=offset)

    def cmux_step_sacc(self, a, acc_flat, prepared, *, kp1, l, bgbit,
                       offset):
        """cmux_step_acc with the limb axis in the contraction's grid:
        rotate_decompose64_ck_flat -> ck_dot64p_sacc (the JAX package's
        TFHE_CK64_PATH=sacc step).  None when ineligible."""
        return self._two_kernel_step(kernels.ck_dot64p_sacc, a, acc_flat,
                                     prepared, kp1=kp1, l=l, bgbit=bgbit,
                                     offset=offset)


@functools.lru_cache(maxsize=None)
def _conv_gather(J: int, U: int, L: int, N: int, device) -> torch.Tensor:
    """Flat indices into a conv key (J*U*L, 1, 2N-1) giving the doubled-limb
    vector v (L, J, U, 2N): v[l, j, u, m] = k[(j, u, l), 0, (N-1-m) mod 2N].
    Every m but N has its tap; m = N points at tap 0 and is zeroed after the
    gather (ConvEngine._v)."""
    m = torch.arange(2 * N, device=device)
    tau = torch.remainder(N - 1 - m, 2 * N)
    tau = torch.where(m == N, torch.zeros_like(tau), tau)
    rows = ((torch.arange(J, device=device)[:, None, None] * U
             + torch.arange(U, device=device)[None, :, None]) * L
            + torch.arange(L, device=device)[None, None, :])     # (J, U, L)
    idx = rows.permute(2, 0, 1)[..., None] * (2 * N - 1) + tau   # (L,J,U,2N)
    return idx.contiguous()


class ConvEngine(_EngineBase):
    """The JAX package's convolution backend (``conv``, and ``conv_bf16``
    with the key stored in bfloat16): the prepared key keeps its layout,
        {"k": (J*U*L, 1, 2N-1)} int8 (bfloat16 for conv_bf16),
        k[(j, u, l), 0, tau] = v[l, j, u, (N-1-tau) mod 2N],
    with v onthefly's doubled-limb vector, so ``convert`` and key files
    carry JAX conv keys as they are.

    The product takes onthefly's route instead of a convolution: each call
    gathers v back from k (one gather; v[..., N] is the one entry k lacks,
    and no Toeplitz entry reads it: they are v[(i-t) mod 2N] with |i-t| < N,
    so it is written 0), then ``kernels.materialize_wt`` and at 32 bits
    one ``kernels.mm_recombine_acc_wt`` per digit plane (the onthefly
    product); at 64 bits one int8 GEMM (``lwe._int8_matmul``) per limb and
    digit plane on its transposed view, the limbs recombined in int64.
    cuBLAS reads that column-major operand about 8 times faster than the row-major W
    (tools/torch_conv64_ab.py, CB_MXU lvl2 B=256, NVIDIA H100 80GB HBM3 at
    700 W: 0.55 against 4.48-4.51 ms for the six GEMMs).  No convolution
    library runs: PyTorch has no int8 convolution on CUDA, cuDNN's float32
    one runs in TF32 by default and may choose inexact FFT or Winograd
    algorithms.

    Sums are exact: a GEMM sums J*N products of at most 2^14 (3.4e8 < 2^31
    at the 64-bit lvl2 shape, checked per call at 64 bits; at 32 bits a
    wrap mod 2^32 is the torus's own).  So ``conv`` equals the JAX
    package's bit for bit.  ``conv_bf16`` computes the same integers from
    the int8 value of its key (bfloat16 holds every int8 exactly); the JAX
    package's bf16 convolution (f32 sums, then a round) is exact only while
    its per-j sums stay under 2^24 (digit planes of at most 64, or N <=
    1024: every 32-bit gate set), and there the two agree bit for bit;
    outside that domain this one stays exact.

    ``cmux_step`` returns None, as the JAX package's does: the blind
    rotation takes the generic step."""

    def __init__(self, cfg: EngineConfig, use_int8: bool = True):
        self.cfg = cfg
        self.use_int8 = use_int8

    def prepare(self, key_polys):
        cfg = self.cfg
        J, U, N = key_polys.shape
        assert N == cfg.N
        limbs = _limbs_doubled(cfg, key_polys)               # (L,J,U,2N)
        tau = torch.remainder(torch.arange(N - 1, -N, -1,
                                           device=key_polys.device), 2 * N)
        ker = limbs[..., tau].permute(1, 2, 0, 3)            # (J,U,L,2N-1)
        ker = ker.reshape(J * U * cfg.num_limbs, 1, 2 * N - 1)
        if not self.use_int8:
            ker = ker.to(torch.bfloat16)
        return {"k": ker.contiguous()}

    def _v(self, k, J: int):
        """The doubled-limb vectors (L, J, U, 2N) int8 of a conv key."""
        N, L = self.cfg.N, self.cfg.num_limbs
        U = k.shape[0] // (J * L)
        if k.dtype != torch.int8:
            k = k.to(torch.int8)                 # bf16 holds int8 exactly
        v = torch.take(k, _conv_gather(J, U, L, N, k.device))
        v[..., N].zero_()            # a view's fill: no host scalar copied
        return v

    def accumulate(self, x, prepared):
        cfg = self.cfg
        x = torch.as_tensor(x)
        J, N = x.shape[-2], cfg.N
        lead = x.shape[:-2]
        v = self._v(prepared["k"], J)                        # (L,J,U,2N)
        L, _, U, _ = v.shape
        M = x[..., 0, 0].numel()
        if cfg.out_bits == 32:
            acc = torch.zeros((M, U, N), dtype=torch.int32, device=v.device)
            return _fold_planes(cfg, x, kernels.materialize_wt(v),
                                acc).reshape(*lead, U, N)
        pb, P = cfg.plane_split
        max_plane = (1 << (cfg.digit_bits - 1)) if P == 1 else 64
        if J * N * max_plane * (1 << (cfg.limb_bits - 1)) >= 2**31:
            raise ValueError("conv: an int32 limb sum could overflow at this "
                             "shape")
        wt = kernels.materialize_wt(v)                       # (L,U*N,J*N)
        planes = _digit_planes(cfg, x).reshape(P, M, J * N)
        parts = [torch.stack([lwe._int8_matmul(planes[p].contiguous(),
                                               wt[lm].t())
                              for lm in range(L)]) for p in range(P)]
        return _recombine(cfg, parts).reshape(*lead, U, N)

    def accumulate_into(self, acc, x, prepared):
        if self.cfg.out_bits != 32 or acc.ndim != 3 or x.ndim != 3:
            return T.add(acc, self.accumulate(x, prepared))
        wt = kernels.materialize_wt(self._v(prepared["k"], x.shape[-2]))
        return _fold_planes(self.cfg, x, wt, acc)


def make_engine(cfg: EngineConfig, backend: str = "matmul"):
    if backend == "nussbaumer":
        from tfhe_tpu_torch.ops.nussbaumer import NussbaumerEngine
        return NussbaumerEngine(cfg)
    if backend in ("fft", "fft_dd", "fft_f64"):
        from tfhe_tpu_torch.ops.fft import FFTEngine
        prec = {"fft": "auto", "fft_dd": "dd", "fft_f64": "f64"}[backend]
        return FFTEngine(cfg, precision=prec)
    if backend == "matmul":
        return MatmulEngine(cfg)
    if backend == "onthefly":
        return OnTheFlyMatmulEngine(cfg)
    if backend == "chunked":
        return ChunkedEngine(cfg)
    if backend == "conv":
        return ConvEngine(cfg)
    if backend == "conv_bf16":
        return ConvEngine(cfg, use_int8=False)
    if backend == "naive":
        return NaiveEngine(cfg)
    raise ValueError(f"unknown backend {backend!r}")
