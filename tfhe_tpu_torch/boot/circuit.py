"""Circuit bootstrapping: TLWE -> TRGSW via blind rotation + private
functional key switch (poc_CircuitBootstrapping.cpp:437-873), as in
``tfhe_tpu.boot.circuit``.

Pipeline (batched over ciphertexts):

  LWE32(lvl1, bit/2) --preKS--> LWE32(lvl0) --modswitch--> Z_{2N2}
     --blind rotation over the lvl2 Torus64 ring--> LWE64(lvl2, bit*mu_w)
     --private functional KS (z in {0,1})--> TLWE32 rows of a TRGSW(bit)

The composition is the JAX package's (the standard CGGI17 one, which
corrects the PoC's rotation exponent; PARITY.md): test vector * X^{2N-barb},
then +abar steps.  One blind rotation may serve all ell1 output levels
(``shared_rotation``), which is sound only while
``noise.shared_rotation_penalty`` stays under
``noise.SHARED_ROTATION_MAX_PENALTY``; ``None`` decides by it (CB_TOY
shares, CB_MXU and CB_ACTIVE rotate once per level).

On the card the blind rotation runs the chunked engine's 64-bit step
(``rotate_decompose64_ck`` + ``ck_dot64p_sacc``), the port's default backend
here; ``backend="conv"`` (the JAX package's default) gives the same TRGSWs
bit for bit through the generic step (``materialize_wt`` + int8 GEMMs, no
step kernel of its own); the pre-key-switch is a one-hot int8 product
(``torch._int_mm``), as the JAX package leaves it to XLA; the private key
switch runs the port's own kernel (``kernels.priv_keyswitch``) on the
packed table (``prepare_privks``: K-major, digit-0 rows left out, the
negation folded in), which ``CircuitCloudKey.data`` holds beside the
row-major limbs.  Keys are generated with the host's
``TfheRng`` in the JAX package's host order (same seed, same keys); the
ring products, limb splits and the chunked key preparation run on
``device``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tfhe_tpu_torch import device as _device
from tfhe_tpu_torch import graphs, lwe, noise, tgsw, tlwe
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.boot import blind_rotate as br
from tfhe_tpu_torch.ops import kernels
from tfhe_tpu_torch.ops.engine import make_engine, prepare_stacked
from tfhe_tpu_torch.params import CircuitParams, KeySwitchParams, LweParams
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.utils import observability as obs


@dataclasses.dataclass
class CircuitSecretKey:
    params: CircuitParams
    key_lvl0: lwe.LweKey
    ring_lvl1: tlwe.TLweKey
    ring_lvl2: tlwe.TLweKey
    lwe_lvl1: lwe.LweKey          # ring_lvl1 as LWE(N1) (input side)

    @staticmethod
    def generate(p: CircuitParams, rng: TfheRng) -> "CircuitSecretKey":
        k0 = lwe.LweKey.generate(LweParams(p.n_lvl0), rng)
        r1 = tlwe.TLweKey.generate(p.lvl1, rng)
        r2 = tlwe.TLweKey.generate(p.lvl2, rng)
        return CircuitSecretKey.from_keys(p, k0, r1, r2)

    @staticmethod
    def from_keys(p: CircuitParams, k0: lwe.LweKey, r1: tlwe.TLweKey,
                  r2: tlwe.TLweKey) -> "CircuitSecretKey":
        l1 = lwe.LweKey(LweParams(p.n_lvl1), r1.key.reshape(-1))
        return CircuitSecretKey(p, k0, r1, r2, l1)


def _privks_message_table(sk: CircuitSecretKey) -> np.ndarray:
    """mess[i, j, v] = (key2ext[i] << shift_j) * v on the torus32, where
    key2ext = [s2, -1] (the -1 extension makes the body row a plain digit
    loop entry, poc:367) and shift_j = 32-(j+1)*basebit (poc:405-419)."""
    ks = sk.params.ks21
    key2ext = np.concatenate([sk.ring_lvl2.key.reshape(-1),
                              np.array([-1], np.int32)])      # (n2+1,)
    shifts = np.array([32 - (j + 1) * ks.basebit for j in range(ks.t)])
    mess = (key2ext[:, None, None].astype(np.int64)
            << shifts[None, :, None]) * np.arange(ks.base)[None, None, :]
    return mess.astype(np.uint64).astype(np.uint32).astype(np.int32)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class PrivKeySwitchKey:
    """privKS[z][i][j][v] = TLWE32_{lvl1}(K_z * key2ext[i] * v *
    2^(32-(j+1)bb)) with K_0 = -s1 (mask bloc), K_1 = 1 (poc:367, 405-419),
    stored as int8 limb matrices; digit-0 rows zeroed (the `aij != 0`
    skip)."""

    ks: KeySwitchParams
    n_in: int                       # n_lvl2 (+1 handled internally)
    k: int
    N: int
    w_limbs: torch.Tensor           # (k+1, 4, (n_in+1)*t*base, (k+1)*N) int8
    _packed: torch.Tensor | None = dataclasses.field(default=None,
                                                     repr=False)

    @property
    def packed(self) -> torch.Tensor:
        """``prepare_privks`` of the limbs, built once on their device."""
        if self._packed is None:
            self._packed = prepare_privks(self.w_limbs, self.ks)
        return self._packed

    @staticmethod
    def generate(sk: CircuitSecretKey, rng: TfheRng,
                 device=None) -> "PrivKeySwitchKey":
        """Draws in ``tfhe_tpu``'s host order (per z-bloc: every mask, then
        every noise term), so one seed gives the JAX host path's table; the
        ring products and the limb split run on ``device``."""
        p = sk.params
        ks = p.ks21
        n2, N1, k = p.n_lvl2, p.n_lvl1, p.lvl1.k
        dev = _device.resolve(device)
        mess = torch.from_numpy(_privks_message_table(sk)).to(dev)
        rows = (n2 + 1) * ks.t * ks.base
        w = torch.empty((k + 1, 4, rows, (k + 1) * N1), dtype=torch.int8,
                        device=dev)
        for z in range(k + 1):
            c = tlwe.encrypt_zero(sk.ring_lvl1, rng, tuple(mess.shape),
                                  ks.stdev, device=dev)  # (n2+1,t,base,k+1,N1)
            c[..., z, 0] = T.wrap32(c[..., z, 0].to(torch.int64) + mess)
            c[:, :, 0] = 0                                # digit-0 rows
            w[z] = T.balanced_limbs(c.reshape(rows, (k + 1) * N1), 4, 8)
            del c
        return PrivKeySwitchKey(ks, n2, k, N1, w)


# K' columns of the limbs prepare_privks converts at a time (a transient of
# ~0.1 GB of int64 at CB_ACTIVE's 2,048 columns)
_PACK_ROWS = 4096


def prepare_privks(w_limbs, ks: KeySwitchParams) -> torch.Tensor:
    """The row-major privKS limbs (k+1, 4, (n+1)*t*base, UN) int8 ->
    the packed table of ``kernels.priv_keyswitch``, (k+1, 4, UN, kstride)
    int8 on the limbs' device: K-major (row c of limb l holds column c's
    K' entries contiguously), only the digit-0-free rows (i, j, v-1), K' =
    (n+1)*t*(base-1) (``kernels.privks_depth``), and the balanced limbs of
    -c for each key sample c, so the product needs no negation.  The
    stride kstride rounds K' up to 16 bytes (TMA's row alignment); the pad
    is zero.  Set-up work, never inside a captured program."""
    kp1, L, rows, UN = w_limbs.shape
    span = ks.t * (ks.base - 1)
    n1 = rows // (ks.t * ks.base)
    kq = n1 * span
    out = torch.zeros((kp1, L, UN, -(-kq // 16) * 16), dtype=torch.int8,
                      device=w_limbs.device)
    step = max(1, _PACK_ROWS // span)               # coefficients a block
    for z in range(kp1):
        w = w_limbs[z].view(L, n1, ks.t, ks.base, UN)
        for i0 in range(0, n1, step):
            i1 = min(n1, i0 + step)
            part = w[:, i0:i1, :, 1:].to(torch.int64)    # (L, ., t, base-1, UN)
            c = sum(part[lm] << (8 * lm) for lm in range(L))
            neg = T.balanced_limbs(T.wrap32(-c), L, 8).reshape(L, -1, UN)
            out[z, :, :, i0 * span:i1 * span] = neg.transpose(1, 2)
    return out


def priv_keyswitch_digits(x64, ks: KeySwitchParams):
    """64-bit unsigned rounding digits, top-down (circuitPrivKS,
    poc:674-688): aibar = x + 2^(64-(1+bb*t)); digit_j =
    (aibar >> (64-(j+1)bb)) & mask.  x64: (..., n+1) int64 -> (..., n+1, t)
    int32.  Every digit's bits lie below bit 64, so the arithmetic shift
    and the mask give the unsigned digit."""
    aibar = x64 + (1 << (64 - (1 + ks.basebit * ks.t)))
    digs = [(aibar >> (64 - (j + 1) * ks.basebit)) & (ks.base - 1)
            for j in range(ks.t)]
    return torch.stack(digs, dim=-1).to(torch.int32)


def priv_keyswitch(x64, pksk: PrivKeySwitchKey, z: int):
    """LWE64(n2) -> TLWE32(lvl1) of K_z * t64tot32(phase(x)): the digit
    scatter loop of the reference (poc:667-698) as a one-hot int8 product,
    one per limb of the table."""
    digs = priv_keyswitch_digits(x64, pksk.ks)               # (..., n+1, t)
    lead = digs.shape[:-2]
    base = torch.arange(pksk.ks.base, dtype=torch.int32, device=x64.device)
    onehot = (digs[..., None] == base).to(torch.int8).reshape(
        -1, digs.shape[-2] * digs.shape[-1] * pksk.ks.base)
    acc = None
    for lm in range(pksk.w_limbs.shape[1]):
        part = lwe._int8_matmul(onehot, pksk.w_limbs[z, lm]).to(torch.int64)
        part = part << (8 * lm)
        acc = part if acc is None else acc + part
    return T.wrap32(-acc).reshape(*lead, pksk.k + 1, pksk.N)


def prepare_circuit_bk(gsw, p: CircuitParams, backend: str = "chunked"):
    """Raw TRGSW64 bk (n0, k+1, l2, k+1, N2) -> the engine-prepared key
    stacked over the n0 steps, on gsw's device (for the chunked backend the
    pre-shifted K-packed wmt is ~m/2 times the raw bk: 8.1 GB at CB_MXU)."""
    eng = make_engine(tgsw.engine_config(p.tgsw_lvl2), backend)
    return prepare_stacked(eng, tgsw.rows(gsw))


@dataclasses.dataclass
class CircuitCloudKey:
    params: CircuitParams
    backend: str
    preks: lwe.KeySwitchKey          # lvl1 -> lvl0 (torus32)
    bk_prepared: dict | None         # stacked prepared TRGSW64 of key_lvl0
    privks: PrivKeySwitchKey
    bk_raw: torch.Tensor | None = None   # host copy of the raw TRGSW64 bk
                                         # (for serialization: 164 MB at
                                         # CB_MXU against 8.1 GB of wmt)

    @staticmethod
    def generate(sk: CircuitSecretKey, rng: TfheRng,
                 backend: str = "chunked", keep_raw_bk: bool = False,
                 device=None, prepare_bk: bool = True) -> "CircuitCloudKey":
        """Consumes ``rng`` in the JAX package's order (preKS, bk, privKS).
        Per-stage spans keygen.circuit.{preks,bk_encrypt,privks,bk_prepare}
        (each synchronised on the card) attribute the cost; read them from
        ``observability.report()["spans"]``.  ``keep_raw_bk`` keeps a host
        copy of the raw TRGSW64 bootstrapping key, which
        ``utils.serialization.save_circuit_key`` writes.  With
        ``prepare_bk=False`` the key keeps only that raw copy
        (``bk_prepared`` is None): a rank of a sharded circuit bootstrap
        prepares its own slice from it (``parallel.shard``)."""
        dev = _device.resolve(device)
        p = sk.params
        with obs.span("keygen.circuit"):
            with obs.span("keygen.circuit.preks"):
                preks = lwe.KeySwitchKey.generate(sk.lwe_lvl1, sk.key_lvl0,
                                                  p.ks10, rng,
                                                  keep_raw=False,
                                                  device=dev)
                _sync(dev)
            with obs.span("keygen.circuit.bk_encrypt"):
                gsw = tgsw.encrypt(sk.ring_lvl2, sk.key_lvl0.key,
                                   p.tgsw_lvl2, rng, stdev=p.bk_stdev,
                                   device=dev)   # (n0, k+1, l2, k+1, N2)
                _sync(dev)
            with obs.span("keygen.circuit.privks"):
                privks = PrivKeySwitchKey.generate(sk, rng, device=dev)
                _sync(dev)
            raw = gsw.cpu() if keep_raw_bk or not prepare_bk else None
            prep = None
            if prepare_bk:
                with obs.span("keygen.circuit.bk_prepare"):
                    prep = prepare_circuit_bk(gsw, p, backend)
                    _sync(dev)
            del gsw
        return CircuitCloudKey(p, backend, preks, prep, privks, bk_raw=raw)

    @property
    def data(self):
        """The key as the circuit bootstrap reads it: the row-major privKS
        limbs (the JAX package's form, which serialization saves) and,
        under ``privks_packed``, the packed table program C runs on (built
        at the first call)."""
        return {"preks": self.preks.w_limbs, "bk": self.bk_prepared,
                "privks": self.privks.w_limbs,
                "privks_packed": self.privks.packed}


def _eager(site, structure, fn, inputs, keys=(), *, backend=None):
    """``graphs.run``'s signature, run directly."""
    return fn(*inputs)


def _circuit_bootstrap(samples, key_data, p: CircuitParams, backend: str,
                       shared_rotation: bool | None, run):
    """The circuit bootstrap in the JAX package's three stages, each stage
    run through ``run`` (``graphs.run`` for the staged programs, ``_eager``
    for ``circuit_bootstrap``):

      A. preKS + mod switch            (samples -> abar, bbar)
      B. blind rotation + extract      (the test-vector amplitude mu2 an
                                        input: one program serves every
                                        level)
      C. private functional key switch (one program per z, on its slice of
                                        the packed privKS table,
                                        ``key_data["privks_packed"]``, read
                                        in place)"""
    N2 = p.n_lvl2
    k = p.lvl1.k
    ell1, bgbit1 = p.tgsw_lvl1.l, p.tgsw_lvl1.bgbit
    if shared_rotation is None:
        shared_rotation = (noise.shared_rotation_penalty(p)
                           <= noise.SHARED_ROTATION_MAX_PENALTY)
    # program C's table: a CPU key of the row-major limbs alone is packed
    # here, outside the programs
    packed = key_data.get("privks_packed")
    if packed is None:
        if key_data["privks"].device.type != "cpu":
            raise ValueError("key_data lacks 'privks_packed' (CircuitCloudKey"
                             ".data, or circuit.prepare_privks of 'privks')")
        packed = prepare_privks(key_data["privks"], p.ks21)

    # 1. pre key switch lvl1 -> lvl0 (poc:832); 2. mod switch to Z_{2*N2}
    #    (poc:836 / preModSwitch :472)
    def stage_a(samples):
        preks = lwe.KeySwitchKey(p.ks10, p.n_lvl1, p.n_lvl0,
                                 key_data["preks"])
        x0 = lwe.keyswitch(samples, preks)                    # (B, n0+1)
        return (T.mod_switch_from_torus32(x0[..., :-1], 2 * N2),
                T.mod_switch_from_torus32(x0[..., -1], 2 * N2))

    abar, bbar = run("circuit.a", (p,), stage_a, (samples,),
                     (key_data["preks"],))

    # 3. blind rotation(s) at lvl2.  Test vector (poc:552-562):
    #    [-mu2]*N/2 ++ [mu2]*N/2; after X^{-phibar} rotation, coefficient 0
    #    is +mu2 iff phibar in [N/2, 3N/2) iff phase in [1/4, 3/4).
    def stage_b(abar, bbar, mu2):
        sign = torch.ones(N2, dtype=torch.int64, device=abar.device)
        sign[:N2 // 2] = -1
        ext = br.rotate_and_extract(sign * mu2, key_data["bk"], bbar, abar,
                                    p.tgsw_lvl2, backend)
        ext[..., -1] += mu2      # recentre: the message is {0, mu_w}
        return ext

    def rotate_for(w):
        mu2 = torch.full((), 1 << (63 - (w + 1) * bgbit1),    # mu_w / 2
                         dtype=torch.int64, device=abar.device)
        return run("circuit.b", (p, backend), stage_b, (abar, bbar, mu2),
                   graphs.leaves(key_data["bk"]), backend=backend)

    if shared_rotation:
        base_ext = rotate_for(ell1 - 1)
        exts = [base_ext << (bgbit1 * (ell1 - 1 - w)) for w in range(ell1)]
    else:
        exts = [rotate_for(w) for w in range(ell1)]

    # 4. private functional key switches fill the TRGSW rows (poc:845-855),
    #    on the packed table
    def stage_c(table):
        return lambda ext: kernels.priv_keyswitch(
            ext.reshape(-1, ext.shape[-1]), table, t=p.ks21.t,
            basebit=p.ks21.basebit).reshape(*ext.shape[:-1], k + 1, p.n_lvl1)

    rows = [run("circuit.c", (p,), stage_c(packed[z]), (ext,), (packed[z],))
            for ext in exts for z in range(k + 1)]
    # rows ordered (w, z); the TRGSW layout is (bloc z, level w, k+1, N)
    out = torch.stack(rows, dim=-3)               # (B, ell1*(k+1), k+1, N)
    out = out.reshape(*out.shape[:-3], ell1, k + 1, k + 1, p.n_lvl1)
    return out.transpose(-4, -3).contiguous()     # (B, k+1, ell1, k+1, N1)


def circuit_bootstrap(samples, key_data, p: CircuitParams,
                      backend: str = "chunked",
                      shared_rotation: bool | None = None):
    """LWE32(lvl1, bit/2) batch (B, n1+1) -> TRGSW32 batch
    (B, k+1, ell1, k+1, N1) encrypting bit = [phase in (1/4, 3/4)]
    (tfhe_CircuitBootstrapFFT, poc:823-873, corrected composition).  Runs
    eagerly but for its blind rotations (``blind_rotate``'s programs)."""
    return _circuit_bootstrap(samples, key_data, p, backend, shared_rotation,
                              _eager)


def make_circuit_bootstrap_fn(p: CircuitParams, backend: str = "chunked",
                              shared_rotation: bool = True):
    """``circuit_bootstrap`` with its parameters bound (the JAX package jits
    it whole; here its rotations are programs)."""
    return functools.partial(circuit_bootstrap, p=p, backend=backend,
                             shared_rotation=shared_rotation)


def make_circuit_bootstrap_staged(p: CircuitParams, backend: str = "chunked",
                                  shared_rotation: bool | None = None):
    """fn(samples, key_data) -> TRGSW batch, the same function as
    ``circuit_bootstrap``, as the JAX package's three staged programs (A, B
    and C of ``_circuit_bootstrap``): on the card each stage is one captured
    CUDA graph (``graphs.run``), replayed on later calls.  Counts
    ``bootstrap.circuit_launches`` once a call, outside the programs; a
    call is the span ``circuit.bootstrap``, whose children are the stages'
    ``graph.circuit.a``, ``.b`` (one a rotation) and ``.c`` (one a TRGSW
    row block)."""
    def fn(samples, key_data):
        obs.count("bootstrap.circuit_launches")
        with obs.span("circuit.bootstrap"):
            return _circuit_bootstrap(samples, key_data, p, backend,
                                      shared_rotation, graphs.run)
    return fn
