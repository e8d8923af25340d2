"""The hand-written CUDA kernels of the CMux step, their wrappers and their
plain PyTorch versions (the counterpart of ``tfhe_tpu/ops/pallas_kernels.py``
for the 32-bit gate-bootstrap paths and the 64-bit circuit-bootstrap path).

Every wrapper takes its plain version when its tensors lie on the CPU and
launches its kernel (``csrc/<name>.cu``, built by ``_build``) when they lie on
a CUDA device; there is no fallback from one to the other.  A wrapper checks
dtype, shape, device and contiguity, allocates its output with
``torch.empty`` on its tensors' device, launches with that device current
and on its current stream (``_launch``: the device guard; under a graph
capture that stream is the capturing one), raises if the launch reports an
error, and counts each launch as ``kernel.<wrapper>`` in
``utils.observability`` (the plain versions count nothing).

The plain versions are the same exact integer functions: int8 products are
contracted in float64 (every dot is an integer below 2^53, so the BLAS sum is
exact) and the mod-2^32 recombination runs in int64.

  kernel                      replaces (pallas_kernels.py)  bound on the H100
  materialize_w               materialize_w                 bytes written (L*J*U*N*N)
  materialize_wt              materialize_w (K-packed)      bytes written (L*J*U*N*N)
  rotate_decompose            rotate_decompose              bytes moved (4 + l per coeff)
  mm_recombine_acc_wt         mm_recombine_acc              int8 MACs (wt bytes at small B)
  fused_cmux_step             fused_cmux_step (v1)          int8 MACs
  fused_cmux_step_v2          fused_cmux_step_v2            int8 MACs
  rotate_decompose64          rotate_decompose64            bytes moved (8 + l*P per coeff)
  rotate_decompose64_ck       rotate_decompose64_ck         bytes moved (8 + l*P per coeff)
  rotate_decompose64_ck_flat  rotate_decompose64_ck_flat    the same kernel, flat acc
  ck_dot64p                   ck_dot64p                     int8 MACs (reads wmt)
  ck_dot64p_sacc              ck_dot64p_sacc                int8 MACs (reads wmt)
  ck_dot64p_acc               ck_dot64p_acc                 int8 MACs (reads wmt)
  ck_cmux_step32              ck_cmux_step32                int8 MACs (reads wm)
  ck_cmux_step64              ck_cmux_step64                int8 MACs (reads wmt)
  priv_keyswitch              none (XLA's one-hot products) bytes read (the table once)

fused_cmux_step (v1) runs on no path of the port, as in the JAX package,
where only its tests call it; rotate_decompose64, test-only there too,
gives the sharded circuit bootstrap its digits (``parallel.shard``: the
plain layout makes an ep rank's J slice a contiguous row range).  The four
64-bit
contractions (ck_dot64p, ck_dot64p_sacc, ck_dot64p_acc, ck_cmux_step64)
take the chunked key K-packed, wmt (ck_wmt), the only layout the chunked
engine prepares at 64 bits; their plain versions contract
wmt.transpose(-1, -2).  The 32-bit ck_cmux_step32 reads wm, and the 32-bit
generic contraction transposes it per call (ck_dot64p_wm).  priv_keyswitch,
the circuit bootstrap's private key switch (program C), has no Pallas
counterpart: the JAX package leaves it to XLA; it reads the packed table of
circuit.prepare_privks.
"""

from __future__ import annotations

import functools

import torch

from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.ops import _build, poly
from tfhe_tpu_torch.utils import observability as obs

# dynamic shared memory a block may use on sm_90 (bytes)
MAX_SMEM = 232448
_BN, _BK = 128, 32             # ck_cmux_step32's mma.sync tile (csrc/common.cuh)


def _on_cpu(*tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all lie on the CPU or on one CUDA device, "
                     f"got {sorted(str(t.device) for t in tensors)}")


def _require(cond: bool, what: str):
    if not cond:
        raise ValueError(what)


def _check(t, name, dtype, ndim):
    _require(t.dtype == dtype, f"{name}: expected {dtype}, got {t.dtype}")
    _require(t.ndim == ndim, f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    _require(t.is_contiguous(), f"{name}: must be contiguous")


def _launch(name: str, device, *args):
    """Launch entry point ``name`` with ``device`` (its tensors' card) set
    as the current device, on that device's current stream (under a graph
    capture, the capturing stream)."""
    with torch.cuda.device(device):
        rc = _build.entry(name)(*args,
                                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def _is_pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


# ---------------------------------------------------------------------------
# materialize_w
# ---------------------------------------------------------------------------

def materialize_w_plain(v):
    L, J, U, twoN = v.shape
    N = twoN // 2
    ar = torch.arange(N, device=v.device)
    idx = (ar[None, :] - ar[:, None]) % twoN                 # (t, i)
    m = v[..., idx]                                          # (L,J,U,t,i)
    return m.permute(0, 1, 3, 2, 4).reshape(L, J * N, U * N)


# the plan of both entries' kernel (csrc/materialize_w.cu)
MATW_THREADS = 256         # threads of a block, at most
MATW_COLS = 4096           # bytes of a row a block writes, at most


@functools.lru_cache(maxsize=None)
def materialize_w_plan(L: int, J: int, U: int, N: int, sms: int) -> tuple:
    """(rows, cols, threads) of a materialize_w or materialize_wt launch
    (csrc/materialize_w.cu): a block stages one (l, j, u) vector and
    writes ``cols`` bytes of each of ``rows`` output rows (one run of the
    vector each); the grid is (N / rows * N / cols, L*J*U).

    cols is the whole row (N) up to MATW_COLS, so that the staging (16
    copies, shifted by 0 .. 15 bytes, of the rows + cols bytes of the
    vector the block's runs read) fits in shared memory at any N.  rows
    starts at every row of the vector and halves, down to 16, until the
    grid holds at least two blocks per SM of ``sms``: the staging's load
    latency of one block then hides behind another's stores, and the
    blocks stay long (128 rows at every path's key; PERF.md gives the
    other plans' device times, alone and in each path's step, from
    tools/torch_matw_ab.py).  Threads: a
    block's 16-byte words, rounded up to a warp, at most MATW_THREADS.
    Pure and memoized: the steps of a rotation ask with the same shapes."""
    cols = rows = min(N, MATW_COLS)
    while rows > 16 and L * J * U * (N // rows) * (N // cols) < 2 * sms:
        rows //= 2
    threads = min(MATW_THREADS, -(-rows * cols // 16 // 32) * 32)
    return rows, cols, threads


def _materialize(name, plain, v, kpacked: bool):
    """The checks and the launch of both entries."""
    _check(v, f"{name} v", torch.int8, 4)
    L, J, U, twoN = v.shape
    N = twoN // 2
    _require(_is_pow2(twoN), f"{name}: 2N must be a power of two")
    if _on_cpu(v):
        return plain(v)
    _require(N >= 16, f"{name}: the kernel needs N >= 16")
    shape = (L, U * N, J * N) if kpacked else (L, J * N, U * N)
    out = torch.empty(shape, dtype=torch.int8, device=v.device)
    obs.count(f"kernel.{name}")
    _launch(name, v.device, v.data_ptr(), out.data_ptr(), L, J, U, N,
            *materialize_w_plan(L, J, U, N, sm_count(v.device)))
    return out


def materialize_w(v):
    """v: (L, J, U, 2N) int8 doubled limb vectors ->
    W: (L, J*N, U*N) int8 with W[l, (j,t), (u,i)] = v[l,j,u,(i-t) mod 2N].

    Kernel: csrc/materialize_w.cu (replaces pallas_kernels.materialize_w).
    Bound by the L*J*U*N^2 bytes it writes.  Each output run (row (l, j, t)
    of column block u) is a contiguous run of the vector rotated by N;
    a block stages 16 byte-shifted copies of its vector's runs in shared
    memory, so that every run leaves as aligned 16-byte words, stored
    evict-first (a reader of W streams it once); the grid from
    materialize_w_plan.  The port's paths take the K-packed entry,
    materialize_wt."""
    return _materialize("materialize_w", materialize_w_plain, v, False)


def materialize_wt_plain(v):
    return materialize_w_plain(v).transpose(1, 2).contiguous()


def materialize_wt(v):
    """v: (L, J, U, 2N) int8 doubled limb vectors -> the K-packed key
    Wt: (L, U*N, J*N) int8 with Wt[l, (u,i), (j,t)] = v[l,j,u,(i-t) mod 2N],
    materialize_w's W transposed (K contiguous for each output column, as
    the wgmmas of fused_cmux_step_v2 and mm_recombine_acc_wt read it).

    Kernel: csrc/materialize_w.cu, its second entry (the K-packed layout of
    pallas_kernels.materialize_w): materialize_w's kernel on the vector
    reversed, b[m] = v[(N - m) mod 2N], whose run b[N - i ..] is row
    (l, u, i) of column block j."""
    return _materialize("materialize_wt", materialize_wt_plain, v, True)


# ---------------------------------------------------------------------------
# the rotate-decompose digit emitters' domain and plan (csrc/rotdec.cuh)
# ---------------------------------------------------------------------------

ROTDEC_THREADS = 256       # threads a block gives its staged rows, at most


def rotdec_ok(N: int, m: int) -> bool:
    """The domain of the two digit emitters' kernels (rotate_decompose, and
    rotate_decompose64_ck with its flat entry and rotate_decompose64): N a
    power of two, m (the chunk width; 16 for the plain layouts) a multiple
    of 16 dividing N, so a 16-coefficient work item lies in one chunk and
    every digit run is one aligned 16-byte store."""
    return _is_pow2(N) and m % 16 == 0 and N % m == 0


def rotdec_smem(rows: int, kp1: int, N: int, word_bytes: int) -> int:
    """Shared memory of one emitter block: ``rows`` staged rows of
    (k+1)*N words, one padding word after every 16 (csrc/rotdec.cuh)."""
    words = kp1 * N
    return rows * (words + words // 16) * word_bytes


@functools.lru_cache(maxsize=None)
def rotdec_plan(B: int, kp1: int, N: int, word_bytes: int,
                sms: int) -> tuple:
    """(rows, split, threads) of an emitter launch (csrc/rotdec.cuh): a
    block of (threads, rows) threads stages ``rows`` batch rows and works
    on one of ``split`` slices of each row's (k+1)*N/16 work items; the
    grid is (ceil(B / rows), split).

    A row with fewer work items than ROTDEC_THREADS shares its block with
    more rows (powers of two) as long as the grid still covers half of the
    ``sms`` SMs; a batch too narrow for that splits each row's items over
    more blocks (each stages the whole row), at least one warp of items a
    slice.  (On an H100 80GB HBM3 at 700 W, CB_MXU B=100 ran 0.0049 ms of
    device time unsplit against 0.0050-0.0051 split in two, and B=1 and 3
    ran 0.0043-0.0044 at four and eight slices against 0.0046-0.0047
    unsplit: tools/torch_rotdec_ab.py.)  Threads are a row's items rounded
    up to a warp, at most ROTDEC_THREADS, whatever the split: they all
    stage the row.  Pure and memoized: the steps of a rotation ask with the
    same shapes.  Raises where one row does not fit in shared memory."""
    _require(rotdec_smem(1, kp1, N, word_bytes) <= MAX_SMEM,
             f"rotdec_plan: a row of {kp1} x {N} words needs more than "
             f"{MAX_SMEM} bytes of shared memory")
    items = kp1 * N // 16
    target = -(-sms // 2)
    threads = min(ROTDEC_THREADS, -(-items // 32) * 32)
    rows = 1
    while (2 * rows * threads <= ROTDEC_THREADS
           and rotdec_smem(2 * rows, kp1, N, word_bytes) <= MAX_SMEM
           and -(-B // (2 * rows)) >= target):
        rows *= 2
    split = 1
    if rows == 1 and B < target:
        split = max(1, min(-(-target // B), items // 32))
    return rows, split, threads


# ---------------------------------------------------------------------------
# rotate_decompose
# ---------------------------------------------------------------------------

def rotate_decompose_plain(a, acc, *, l: int, bgbit: int, offset: int):
    B, kp1, N = acc.shape
    buf = (T.u32(poly.mul_by_xai_minus_one(a, acc)) + offset) & T.MASK32
    digs = [((buf >> (32 - (i + 1) * bgbit)) & ((1 << bgbit) - 1))
            - (1 << (bgbit - 1)) for i in range(l)]
    return torch.stack(digs, dim=-2).reshape(B, kp1 * l, N).to(torch.int8)


def rotate_decompose(a, acc, *, l: int, bgbit: int, offset: int):
    """Gadget digits of (X^a - 1) * acc for a 32-bit TRLWE batch.

    a: (B,) int32 exponents (taken mod 2N); acc: (B, k+1, N) int32.
    Returns (B, (k+1)*l, N) int8 digits, row-major (polynomial, level) —
    decompose_tlwe(mul_by_xai_minus_one(a, acc)).

    Kernel: csrc/rotate_decompose.cu (replaces
    pallas_kernels.rotate_decompose).  Bound by bytes (4 read + l written
    per coefficient); rows staged in shared memory, a thread per 16
    coefficients writing each digit run with one 16-byte store, the grid
    from rotdec_plan.  The card takes N a multiple of 16 (rotdec_ok)."""
    _check(a, "rotate_decompose a", torch.int32, 1)
    _check(acc, "rotate_decompose acc", torch.int32, 3)
    B, kp1, N = acc.shape
    _require(a.shape[0] == B, "rotate_decompose: a must have one entry per row")
    _require(_is_pow2(N), "rotate_decompose: N must be a power of two")
    _require(1 <= bgbit <= 8 and l * bgbit <= 32,
             "rotate_decompose: digits must fit int8 (bgbit <= 8, l*bgbit <= 32)")
    if _on_cpu(a, acc):
        return rotate_decompose_plain(a, acc, l=l, bgbit=bgbit, offset=offset)
    _require(rotdec_ok(N, 16), f"rotate_decompose: the kernel needs N % 16 "
             f"== 0, got N={N}")
    out = torch.empty((B, kp1 * l, N), dtype=torch.int8, device=acc.device)
    obs.count("kernel.rotate_decompose")
    _launch("rotate_decompose", a.device,
            a.data_ptr(), acc.data_ptr(), out.data_ptr(),
            B, kp1, N, l, bgbit, offset & T.MASK32,
            *rotdec_plan(B, kp1, N, 4, sm_count(acc.device)))
    return out


# ---------------------------------------------------------------------------
# mm_recombine_acc
# ---------------------------------------------------------------------------

def mm_recombine_acc_plain(x, w, acc_in, *, shift_base: int = 0):
    B = x.shape[0]
    L, K, UN = w.shape
    xf = x.to(torch.float64)
    out = acc_in.reshape(B, UN).to(torch.int64)
    for lm in range(L):
        sh = 8 * lm + shift_base
        if sh < 32:
            y = (xf @ w[lm].to(torch.float64)).to(torch.int64)
            out = out + (y << sh)
    return T.wrap32(out).reshape(acc_in.shape)


def mm_recombine_acc(x, w, acc_in, *, shift_base: int = 0, split: int = 0):
    """acc_in + sum_l (x @ w[l]) << (8l + shift_base), mod 2^32.

    x: (B, K) int8; w: (L, K, U*N) int8 (materialize_w layout); acc_in:
    (B, U, N) or (B, U*N) int32.  Returns int32 in acc_in's shape.

    The JAX package's signature.  On the CPU its plain version; on a card
    mm_recombine_acc_wt's kernel on w transposed (a copy of L*K*U*N bytes
    a call; the port's paths hold the K-packed key and call
    mm_recombine_acc_wt directly).  ``split`` as there."""
    _check(w, "mm_recombine_acc w", torch.int8, 3)
    if _on_cpu(x, w, acc_in):
        _mm_checks(x, w.shape[0], w.shape[1], w.shape[2], acc_in, split)
        return mm_recombine_acc_plain(x, w, acc_in, shift_base=shift_base)
    return mm_recombine_acc_wt(x, w.transpose(1, 2).contiguous(), acc_in,
                               shift_base=shift_base, split=split)


def mm_recombine_acc_wt_plain(x, wt, acc_in, *, shift_base: int = 0):
    return mm_recombine_acc_plain(x, wt.transpose(1, 2), acc_in,
                                  shift_base=shift_base)


def _mm_checks(x, L, K, UN, acc_in, split):
    _check(x, "mm_recombine_acc x", torch.int8, 2)
    _require(acc_in.dtype == torch.int32 and acc_in.ndim in (2, 3)
             and acc_in.is_contiguous(),
             "mm_recombine_acc acc_in: contiguous (B, U, N) or (B, U*N) int32")
    _require(split >= 0, "mm_recombine_acc: split must be >= 0 (0 chooses)")
    B = x.shape[0]
    _require(x.shape[1] == K, "mm_recombine_acc: x and the key disagree on K")
    _require(acc_in.shape[0] == B and acc_in[0].numel() == UN,
             "mm_recombine_acc: acc_in must be (B, U*N)")


# mm_recombine_acc_wt's kernel (csrc/mm_recombine_acc.cu): a work unit is
# ``rows`` batch rows x MM_COLS output columns of every limb over one K
# slice of whole MM_BK-deep stages
MM_COLS, MM_BK = 64, 128
MM_OVERHEAD = 8            # a unit's fixed cost (fill, epilogue), in stages


def mm_recombine_acc_wt(x, wt, acc_in, *, shift_base: int = 0,
                        split: int = 0):
    """acc_in + sum_l (x @ wt[l]^T) << (8l + shift_base), mod 2^32.

    x: (B, K) int8; wt: (L, U*N, K) int8, the K-packed key of
    materialize_wt (wt[l, c, k] = w[l, k, c]); acc_in: (B, U, N) or
    (B, U*N) int32.  Returns int32 in acc_in's shape.

    Kernel: csrc/mm_recombine_acc.cu (replaces
    pallas_kernels.mm_recombine_acc).  Bound by int8 tensor-core MACs at
    large B and by the key stream at small B; on the card by the operand
    tiles' L2 traffic.  Both operands reach shared memory by TMA, K-major;
    int8 wgmma multiplies 64-row tiles by the L limbs' 64-column key boxes
    stacked along N, so every limb's accumulator of an output sits in one
    thread and the recombination is one epilogue.  A persistent grid walks
    (row tile, column tile, K slice) units in an L2-friendly order.  The
    plan (mm_recombine_acc_plan: 64 or 128 rows, the K split) follows the
    shape and the SM count; ``split`` > 0 forces the split (the slices are
    added into the output with 32-bit atomics after acc_in is copied
    there).  Each launch counts ``mm_recombine.plan.<rows>x64.s<split>``
    (utils.observability).  The kernel takes K % 16 == 0, U*N % 64 == 0,
    1 to 4 limbs."""
    _check(wt, "mm_recombine_acc wt", torch.int8, 3)
    L, UN, K = wt.shape
    _mm_checks(x, L, K, UN, acc_in, split)
    if _on_cpu(x, wt, acc_in):
        return mm_recombine_acc_wt_plain(x, wt, acc_in, shift_base=shift_base)
    _require(1 <= L <= 4, "mm_recombine_acc: the kernel takes 1 to 4 limbs")
    _require(K % 16 == 0 and UN % MM_COLS == 0,
             f"mm_recombine_acc: the kernel needs K % 16 == 0 and U*N % "
             f"{MM_COLS} == 0")
    _require(shift_base >= 0, "mm_recombine_acc: shift_base must be >= 0")
    _require(x.data_ptr() % 16 == 0 and wt.data_ptr() % 16 == 0,
             "mm_recombine_acc: the kernel needs 16-byte aligned x and wt")
    B = x.shape[0]
    rows, S, ctas = mm_recombine_acc_plan(B, K, UN, sm_count(x.device),
                                          split)
    out = torch.empty_like(acc_in)
    obs.count("kernel.mm_recombine_acc_wt")
    obs.count(f"mm_recombine.plan.{rows}x{MM_COLS}.s{S}")
    _launch("mm_recombine_acc", x.device,
            x.data_ptr(), wt.data_ptr(), acc_in.data_ptr(), out.data_ptr(),
            B, K, UN, L, shift_base, rows, S, ctas)
    return out


@functools.lru_cache(maxsize=None)
def mm_recombine_acc_plan(B: int, K: int, UN: int, sms: int,
                          split: int = 0) -> tuple:
    """(rows, split, blocks) of an mm_recombine_acc_wt launch on a card of
    ``sms`` SMs (csrc/mm_recombine_acc.cu): units of ``rows`` batch rows
    (128, two consumer warpgroups; 64 where B <= 64) x MM_COLS columns of
    every limb over one of ``split`` K slices (split_plan over the
    MM_BK-deep stages), walked by ``blocks`` = min(units, sms) persistent
    blocks, one an SM.

    The split, where not forced: the smallest S that minimizes
    ceil(units / sms) x (stages a slice + MM_OVERHEAD), the rounds of
    equal units times a unit's cost.  A batch whose tiles fill the card
    many times keeps S = 1 (GATE_DEFAULT B=8192: 2,048 units); a narrow
    one is cut while the cut pays (B=628: S = 2, 320 units).  MM_OVERHEAD
    is fitted to the kernel's device time over forced splits at B = 256 to
    1,024 (PERF.md §6); the limb count did not move the best split,
    so it is not an input."""
    rows = 64 if B <= 64 else 128
    steps = -(-K // MM_BK)
    tiles = -(-B // rows) * (UN // MM_COLS)

    def cost(S):
        n, slices = split_plan(steps, S)
        return -(-tiles * slices // sms) * (n + MM_OVERHEAD)
    S = split or min(range(1, steps + 1), key=lambda S: (cost(S), S))
    S = split_plan(steps, S)[1]
    return rows, S, min(tiles * S, sms)


# ---------------------------------------------------------------------------
# fused_cmux_step_v2
# ---------------------------------------------------------------------------

def fused_cmux_step_plain(a, acc, w, *, l: int, bgbit: int, offset: int,
                          key_shift: int = 0, kp1: int | None = None):
    """The step on materialize_w's layout w (L, (k+1)*l*N, (k+1)*N): the
    plain version of fused_cmux_step (v1), and of fused_cmux_step_v2 once
    its key is transposed back."""
    B = acc.shape[0]
    kp1 = kp1 if acc.ndim == 2 else acc.shape[1]
    acc3 = acc.reshape(B, kp1, -1)
    digits = rotate_decompose_plain(a, acc3, l=l, bgbit=bgbit, offset=offset)
    return mm_recombine_acc_plain(digits.reshape(B, -1), w, acc,
                                  shift_base=key_shift)


def fused_cmux_step_v2_plain(a, acc, wt, *, l: int, bgbit: int, offset: int,
                             key_shift: int = 0, kp1: int | None = None):
    return fused_cmux_step_plain(a, acc, wt.transpose(1, 2), l=l, bgbit=bgbit,
                                 offset=offset, key_shift=key_shift, kp1=kp1)


# fused_cmux_step_v2's plans: the output columns of a block, one consumer
# warpgroup per 64, every block owning 64 batch rows.
FUSED_COLS = (64, 128)
_FUSED_TILE = 64 * 128                 # one 64-row x 128-byte operand tile


def fused_ring_stages(L: int, cols: int, l: int) -> int:
    """Key-ring stages of a fused_cmux_step_v2 block of ``cols`` columns
    (csrc/fused_cmux_step.cu, ring_stages): as many stages of L limbs'
    key tiles as fit beside the two l-level digit buffers, at most 8; 0
    where fewer than one group's l slices fit."""
    room = MAX_SMEM - (1024 + 2 * l * _FUSED_TILE + 64 * 4)
    s = min(room // ((cols // 64) * L * _FUSED_TILE + 16), 8)
    return s if s >= l else 0


def fused_cmux_step_v2_plan(N: int, l: int, L: int,
                            tile_cols: int = 0) -> int:
    """The output columns of a fused_cmux_step_v2 block for these shapes,
    or 0 where its kernel cannot run them: N not a multiple of the 128-deep
    K slice, l outside 1..4, L outside 1..3, or a forced ``tile_cols``
    whose ring cannot hold one group.  Chosen (``tile_cols`` 0): 128, whose
    two warpgroups share one digit build, rebuilt half as often (the faster
    plan from B=64 up, and within 3 microseconds at B=1 and 3: PERF.md
    §6); 64 where the 128-column ring cannot hold a group (l=4 at L=3)."""
    if N % 128 or not 1 <= l <= 4 or not 1 <= L <= 3:
        return 0
    for cols in ((tile_cols,) if tile_cols else (128, 64)):
        if fused_ring_stages(L, cols, l):
            return cols
    return 0


def fused_cmux_step_v2(a, acc, wt, *, l: int, bgbit: int, offset: int,
                       key_shift: int = 0, kp1: int | None = None,
                       tile_cols: int = 0):
    """One blind-rotation step, fully fused:

        out = acc + recombine(decompose((X^a - 1) * acc) @ wt^T)

    a: (B,) int32; acc: (B, k+1, N) int32, or the flat (B, (k+1)*N) layout
    with kp1 given (the same bytes); wt: (L <= 3, (k+1)*N, (k+1)*l*N) int8,
    the K-packed key of materialize_wt.  Returns acc's layout.

    Kernel: csrc/fused_cmux_step.cu (replaces
    pallas_kernels.fused_cmux_step_v2).  Bound by int8 tensor-core MACs.
    A block owns 64 batch rows and 64 or 128 output columns of every limb
    (one consumer warpgroup per 64); a producer warp loads the key tiles by
    TMA into a ring of shared-memory stages, and the consumer warps build
    the block's digits one 128-coefficient group (all l levels) at a time
    while wgmma runs on the group before.  ``tile_cols`` 64 or 128 forces
    the plan, 0 lets fused_cmux_step_v2_plan choose.  Any B >= 1; the
    kernel's domain is fused_cmux_step_v2_plan's (N a multiple of 128,
    l <= 4)."""
    _require(tile_cols in (0, *FUSED_COLS),
             "fused_cmux_step_v2: tile_cols must be 0, 64 or 128")
    _check(a, "fused_cmux_step_v2 a", torch.int32, 1)
    _require(acc.dtype == torch.int32 and acc.is_contiguous(),
             "fused_cmux_step_v2 acc: contiguous int32")
    _check(wt, "fused_cmux_step_v2 wt", torch.int8, 3)
    if acc.ndim == 2:
        _require(kp1 is not None, "fused_cmux_step_v2: flat acc needs kp1")
        B, N = acc.shape[0], acc.shape[1] // kp1
    else:
        _require(acc.ndim == 3, "fused_cmux_step_v2 acc: (B, k+1, N)")
        B, kp1, N = acc.shape
    L, UN, K = wt.shape
    _require(a.shape[0] == B, "fused_cmux_step_v2: a must have B entries")
    _require(K == kp1 * l * N and UN == kp1 * N,
             "fused_cmux_step_v2: wt must be (L, (k+1)*N, (k+1)*l*N)")
    _require(1 <= L <= 3, "fused_cmux_step_v2 takes 1 to 3 key limbs")
    _require(_is_pow2(N), "fused_cmux_step_v2: N must be a power of two")
    _require(1 <= bgbit <= 8 and l * bgbit <= 32,
             "fused_cmux_step_v2: digits must fit int8")
    if _on_cpu(a, acc, wt):
        return fused_cmux_step_v2_plain(a, acc, wt, l=l, bgbit=bgbit,
                                        offset=offset, key_shift=key_shift,
                                        kp1=kp1)
    cols = fused_cmux_step_v2_plan(N, l, L, tile_cols)
    _require(cols > 0, f"fused_cmux_step_v2: no plan of the kernel takes "
             f"N={N}, l={l}, L={L}, tile_cols={tile_cols} (it needs N % 128 "
             f"== 0, l <= 4, and a key ring of at least l stages)")
    out = torch.empty_like(acc)
    obs.count("kernel.fused_cmux_step_v2")
    _launch("fused_cmux_step", a.device,
            a.data_ptr(), acc.data_ptr(), wt.data_ptr(),
            out.data_ptr(), B, kp1, N, l, L, bgbit, offset & T.MASK32,
            key_shift, cols)
    return out


# fused_cmux_step (v1)'s plan: a block of 64 rows x 128 columns on the key
# in materialize_w's layout (csrc/fused_cmux_step_v1.cu)
FUSED_V1_LEVELS = 3    # levels of one digit build, at most


def fused_cmux_step_v1_plan(N: int, l: int) -> int:
    """lb, the levels of one digit build of a fused_cmux_step (v1) launch:
    the l levels of each 128-coefficient group take ceil(l / 3) builds of
    at most lb = ceil(l / ceil(l / 3)) levels each (3 at GATE_FAST2 and
    GATE_MXU, 2 at l = 4); 0 where the kernel cannot run: N not a multiple
    of 128.  The kernel sizes its raw key ring from lb itself."""
    if N % 128 or l < 1:
        return 0
    builds = -(-l // FUSED_V1_LEVELS)
    return -(-l // builds)


def fused_cmux_step(a, acc, w, *, l: int, bgbit: int, offset: int,
                    key_shift: int = 0):
    """fused_cmux_step_v2's function on materialize_w's key layout:
    acc + recombine(decompose((X^a - 1) * acc) @ w), mod 2^32.

    a: (B,) int32; acc: (B, k+1, N) int32; w: (3, (k+1)*l*N, (k+1)*N) int8
    (materialize_w's layout; three key limbs, as the JAX kernel is
    specialized).  Returns (B, k+1, N) int32.  Its plain version is
    fused_cmux_step_plain.

    Kernel: csrc/fused_cmux_step_v1.cu (replaces
    pallas_kernels.fused_cmux_step).  Bound by int8 tensor-core MACs.
    fused_cmux_step_v2's block (64 batch rows x 128 columns, digits built a
    group ahead by the two consumer warpgroups, int8 wgmma) with the key
    transposed inside the kernel by a third warpgroup: TMA loads the
    MN-major boxes of w into a raw ring, and that warpgroup rewrites each
    as the K-major tiles the wgmmas read, one slice ahead of them.  No copy
    of w is made.  The plan is fused_cmux_step_v1_plan's; the kernel takes
    N a multiple of 128."""
    _check(a, "fused_cmux_step a", torch.int32, 1)
    _check(acc, "fused_cmux_step acc", torch.int32, 3)
    _check(w, "fused_cmux_step w", torch.int8, 3)
    B, kp1, N = acc.shape
    L, K, UN = w.shape
    _require(a.shape[0] == B, "fused_cmux_step: a must have B entries")
    _require(K == kp1 * l * N and UN == kp1 * N,
             "fused_cmux_step: w must be (L, (k+1)*l*N, (k+1)*N)")
    _require(L == 3, "fused_cmux_step (v1) takes exactly 3 key limbs, as the "
             "JAX kernel is specialized")
    _require(_is_pow2(N), "fused_cmux_step: N must be a power of two")
    _require(1 <= bgbit <= 8 and l * bgbit <= 32,
             "fused_cmux_step: digits must fit int8")
    if _on_cpu(a, acc, w):
        return fused_cmux_step_plain(a, acc, w, l=l, bgbit=bgbit,
                                     offset=offset, key_shift=key_shift)
    lb = fused_cmux_step_v1_plan(N, l)
    _require(lb > 0, f"fused_cmux_step: the kernel needs N % 128 == 0, got "
             f"N={N}")
    out = torch.empty_like(acc)
    obs.count("kernel.fused_cmux_step")
    _launch("fused_cmux_step_v1", a.device,
            a.data_ptr(), acc.data_ptr(), w.data_ptr(),
            out.data_ptr(), B, kp1, N, l, bgbit, offset & T.MASK32, key_shift,
            lb)
    return out


# ---------------------------------------------------------------------------
# rotate_decompose64_ck
# ---------------------------------------------------------------------------

def ck_width(jm: int) -> int:
    """Columns of one (chunk, plane) block of the chunk layout: J*m rounded
    up to 128 (the JAX package's lane rule, kept so both layouts agree byte
    for byte; J*m is already a multiple of 128 at CB_MXU and CB_ACTIVE)."""
    return -(-jm // 128) * 128


def ck_layout(planes, m: int):
    """Digit planes (P, M, J, N) int8 -> the chunk layout (M, C*P*ckp) int8:
    byte (b, (c*P + p)*ckp + j*m + s) holds plane p of digit (j, c*m + s);
    columns past J*m in each block are zero."""
    P, M, J, N = planes.shape
    C = N // m
    x = planes.reshape(P, M, J, C, m).permute(1, 3, 0, 2, 4)   # (M,C,P,J,m)
    x = x.reshape(M, C, P, J * m)
    pad = ck_width(J * m) - J * m
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(M, -1).contiguous()


def _digit_planes64(a, acc, *, l: int, bgbit: int, offset: int,
                    planes: int):
    """The gadget digits of (X^a - 1) * acc, acc (B, k+1, N) int64, as
    (P, B, (k+1)*l, N) int8 planes (balanced base-2^7 where P = 2)."""
    rot = poly.mul_by_xai_minus_one(a, acc) + T.signed64(offset)
    B, kp1, N = acc.shape
    digs = torch.stack([((rot >> (64 - (i + 1) * bgbit)) & ((1 << bgbit) - 1))
                        - (1 << (bgbit - 1)) for i in range(l)], dim=-2)
    digs = digs.reshape(B, kp1 * l, N)
    if planes == 1:
        return digs.to(torch.int8)[None]
    return T.signed_planes(digs, 7, planes)


def rotate_decompose64_ck_plain(a, acc, *, l: int, bgbit: int, offset: int,
                                m: int, planes: int = 1):
    return ck_layout(_digit_planes64(a, acc, l=l, bgbit=bgbit, offset=offset,
                                     planes=planes), m)


def _check_digits64(name, planes, bgbit, l):
    _require(planes in (1, 2) and 1 <= bgbit <= (8 if planes == 1 else 14)
             and l * bgbit <= 64,
             f"{name}: digits must fit their planes (planes 1 or 2; bgbit <= "
             f"8 for planes=1, <= 14 for planes=2) and l*bgbit <= 64")


def _rotate_decompose64_ck(name, a, acc, *, l, bgbit, offset, m, planes):
    """Checks, then the plain version on the CPU or one launch of
    csrc/rotate_decompose64_ck.cu counted as ``kernel.<name>``; acc (B, k+1,
    N)."""
    _check(a, f"{name} a", torch.int32, 1)
    _require(acc.dtype == torch.int64 and acc.is_contiguous(),
             f"{name} acc: contiguous int64")
    B, kp1, N = acc.shape
    _require(a.shape[0] == B, f"{name}: a must have one entry per row")
    _require(_is_pow2(N) and N % m == 0,
             f"{name}: N must be a power of two and a multiple of m")
    _check_digits64(name, planes, bgbit, l)
    if _on_cpu(a, acc):
        return rotate_decompose64_ck_plain(a, acc, l=l, bgbit=bgbit,
                                           offset=offset, m=m, planes=planes)
    _require(rotdec_ok(N, m), f"{name}: the kernel needs m a multiple of "
             f"16, got m={m}")
    ckp = ck_width(kp1 * l * m)
    out = torch.empty((B, (N // m) * planes * ckp), dtype=torch.int8,
                      device=acc.device)
    obs.count(f"kernel.{name}")
    _launch("rotate_decompose64_ck", a.device, a.data_ptr(), acc.data_ptr(),
            out.data_ptr(), B, kp1, N, l, bgbit, offset & ((1 << 64) - 1), m,
            planes, ckp, *rotdec_plan(B, kp1, N, 8, sm_count(acc.device)))
    return out


def rotate_decompose64_ck(a, acc, *, l: int, bgbit: int, offset: int, m: int,
                          planes: int = 1):
    """Gadget digits of (X^a - 1) * acc for a 64-bit TRLWE batch, written in
    ck_dot64p's chunk layout.

    a: (B,) int32 exponents (taken mod 2N); acc: (B, k+1, N) int64; offset:
    the 64-bit gadget offset (unsigned).  Digit j = u*l + lv of coefficient
    n = c*m + s goes to byte (b, (c*P + p)*ckp + j*m + s) for its balanced
    base-2^7 plane p (planes=2 splits 9-bit digits: d = p0 + 128 p1).
    Returns (B, C*P*ckp) int8 with ckp = ck_width((k+1)*l*m).

    Kernel: csrc/rotate_decompose64_ck.cu (replaces
    pallas_kernels.rotate_decompose64_ck).  Bound by bytes (8 read and l*P
    written per coefficient); rows staged in shared memory, a thread per 16
    coefficients of one chunk writing each digit run with one 16-byte
    store and the pad columns zeroed by the kernel, the grid from
    rotdec_plan.  The card takes m a multiple of 16 (rotdec_ok)."""
    _require(acc.ndim == 3, "rotate_decompose64_ck acc: (B, k+1, N)")
    return _rotate_decompose64_ck("rotate_decompose64_ck", a, acc, l=l,
                                  bgbit=bgbit, offset=offset, m=m,
                                  planes=planes)


def rotate_decompose64_ck_flat_plain(a, acc, *, N: int, l: int, bgbit: int,
                                     offset: int, m: int, planes: int = 1):
    return rotate_decompose64_ck_plain(a, acc.reshape(acc.shape[0], -1, N),
                                       l=l, bgbit=bgbit, offset=offset, m=m,
                                       planes=planes)


def rotate_decompose64_ck_flat(a, acc, *, N: int, l: int, bgbit: int,
                               offset: int, m: int, planes: int = 1):
    """rotate_decompose64_ck on the flat (B, (k+1)*N) int64 accumulator of
    the fused-epilogue step; the same digits.

    The JAX package needs a second Pallas kernel here because its Torus64
    is an (lo, hi) int32 pair whose flat and U-major layouts differ; the
    port's native int64 (B, k+1, N) tensor already is the flat layout byte
    for byte, so this wrapper launches the same kernel,
    csrc/rotate_decompose64_ck.cu (replaces
    pallas_kernels.rotate_decompose64_ck_flat), and counts its launches as
    ``kernel.rotate_decompose64_ck_flat``."""
    _require(acc.ndim == 2 and acc.shape[1] % N == 0,
             "rotate_decompose64_ck_flat acc: (B, (k+1)*N)")
    return _rotate_decompose64_ck("rotate_decompose64_ck_flat", a,
                                  acc.view(acc.shape[0], -1, N), l=l,
                                  bgbit=bgbit, offset=offset, m=m,
                                  planes=planes)


def rotate_decompose64_plain(a, acc, *, l: int, bgbit: int, offset: int,
                             planes: int = 1):
    B, kp1, N = acc.shape
    pl = _digit_planes64(a, acc, l=l, bgbit=bgbit, offset=offset,
                         planes=planes).reshape(planes, B, kp1, l, N)
    return pl.permute(1, 2, 3, 0, 4).reshape(B * kp1, l * planes, N)


def rotate_decompose64(a, acc, *, l: int, bgbit: int, offset: int,
                       planes: int = 1):
    """Gadget digits of (X^a - 1) * acc for a 64-bit TRLWE batch in the
    plain layout: a (B,) int32 exponents (taken mod 2N); acc (B, k+1, N)
    int64; offset the 64-bit gadget offset (unsigned).  Returns
    (B*(k+1), l*P, N) int8, row b*(k+1) + u, level-major then plane
    (planes=2 splits each digit into balanced base-2^7 planes, d = p0 +
    128 p1).  kernels.ck_layout of the same planes is rotate_decompose64_ck's
    chunk layout.

    Kernel: csrc/rotate_decompose64_ck.cu, its second entry point (replaces
    pallas_kernels.rotate_decompose64).  Bound by bytes (8 read and l*P
    written per coefficient); rotate_decompose64_ck's kernel, writing each
    16-coefficient digit run to the plain layout instead, at the plan from
    rotdec_plan.  The card takes N a multiple of 16 (rotdec_ok)."""
    _check(a, "rotate_decompose64 a", torch.int32, 1)
    _check(acc, "rotate_decompose64 acc", torch.int64, 3)
    B, kp1, N = acc.shape
    _require(a.shape[0] == B, "rotate_decompose64: a must have one entry per "
             "row")
    _require(_is_pow2(N), "rotate_decompose64: N must be a power of two")
    _check_digits64("rotate_decompose64", planes, bgbit, l)
    if _on_cpu(a, acc):
        return rotate_decompose64_plain(a, acc, l=l, bgbit=bgbit,
                                        offset=offset, planes=planes)
    _require(rotdec_ok(N, 16), f"rotate_decompose64: the kernel needs N % "
             f"16 == 0, got N={N}")
    out = torch.empty((B * kp1, l * planes, N), dtype=torch.int8,
                      device=acc.device)
    obs.count("kernel.rotate_decompose64")
    _launch("rotate_decompose64", a.device, a.data_ptr(), acc.data_ptr(),
            out.data_ptr(), B, kp1, N, l, bgbit, offset & ((1 << 64) - 1),
            planes, *rotdec_plan(B, kp1, N, 8, sm_count(acc.device)))
    return out


# ---------------------------------------------------------------------------
# ck_dot64p
# ---------------------------------------------------------------------------

def ck_dot64p_plain(x, wmt, *, N: int, m: int, planes: int = 1):
    wm = wmt.transpose(-1, -2)
    UL, Jm, Npm = wm.shape
    B = x.shape[0]
    C = N // m
    xr = x.reshape(B, C, planes, -1)[..., :Jm].to(torch.float64)
    wf = wm.to(torch.float64)
    ring = torch.zeros((UL, B, 2 * N), dtype=torch.int64, device=x.device)
    for p in range(planes):
        # (B, C, Jm) @ (UL, Jm, Npm): every dot is an integer below 2^53
        y = torch.einsum("bck,gkq->gbcq", xr[:, :, p], wf).to(torch.int64)
        y = y << (7 * p)
        for c in range(C):
            ring[..., c * m:c * m + Npm] += y[:, :, c]
    return T.wrap32(ring[..., :N] - ring[..., N:])


def ck_dot64p_exact(J: int, N: int, m: int, digit_bits: int) -> bool:
    """Whether ck_dot64p's int32 sums are exact: a ring position adds
    J*(N+m) products of a digit (|d| <= 2^(digit_bits-1), the planes
    combined) and an int8 key limb (|w| <= 128)."""
    return J * (N + m) * (1 << (digit_bits - 1)) * 128 < 2**31


def _ck_exact_check(name, Jm, N, m, digit_bits):
    _require(ck_dot64p_exact(Jm // m, N, m, digit_bits),
             f"{name}: int32 accumulation bound J*(N+m)*2^(digit_bits-1)"
             f"*128 < 2^31 exceeded")


def ck_wmt(wm):
    """The K-packed chunked key: wm (..., U*L, J*m, N+m) -> wmt (..., U*L,
    N+m, J*m) int8, wmt[..., g, q, k] = wm[..., g, k, q] (one transpose
    copy), the layout the 64-bit contractions' TMA loads read.  The chunked
    engine builds wmt directly at 64 bits; this serves the 32-bit generic
    contraction, the conversion of the JAX package's keys and the tests."""
    return wm.transpose(-1, -2).contiguous()


def ck64_kernel_ok(N: int, m: int, Jm: int, planes: int) -> bool:
    """The domain of the four 64-bit contractions on wmt, shared by their
    wrappers and the chunked engine's 64-bit steps: N a multiple of m and
    of the 64-column tile, J*m a multiple of 16 (the K-packed key's row
    stride, which TMA needs in 16-byte units), one or two digit planes.
    Any B >= 1 and any limb count.  ck_cmux_step64 also needs m % 4 == 0
    (ck_cmux_step64_ok)."""
    return (N % m == 0 and N % 64 == 0 and Jm > 0 and Jm % 16 == 0
            and planes in (1, 2))


def ck_cmux_step64_ok(N: int, m: int, Jm: int, planes: int) -> bool:
    """ck_cmux_step64's domain: ck64_kernel_ok's, and m a multiple of 4
    (its digit builds take four coefficients at a time)."""
    return ck64_kernel_ok(N, m, Jm, planes) and m % 4 == 0


def _ck64_require(name, N, m, Jm, planes, ok=ck64_kernel_ok):
    _require(ok(N, m, Jm, planes),
             f"{name}: the kernel needs N % 64 == 0, J*m % 16 == 0 and 1 or 2 "
             f"planes{', m % 4 == 0' if ok is ck_cmux_step64_ok else ''}, "
             f"got N={N}, m={m}, J*m={Jm}, planes={planes}")


# The plans of the wgmma contractions (csrc/ck_dot64p.cu, ck_dot64p_sacc.cu,
# ck_dot64p_acc.cu): a block owns 64 folded columns for 64 or 128 batch rows
# (one or two consumer warpgroups sharing each key tile), the rows chosen
# from B.  ck_dot64p alone also has a key-stationary plan for small batches:
# a block owns 64 key rows and multiplies them, read once, with 128 of the
# C*B (chunk, batch) rows stacked along M.
# Memoized: the 1,000 steps of a circuit bootstrap ask with the same shapes.
# ck_dot64p and ck_dot64p_sacc count their plan and contraction depth a
# launch in utils.observability, ``<entry>.plan.<rows>x64.jm<J*m>.p<planes>``
# (``kst<rows>`` for the key-stationary plan); graph replays add the count
# again (graphs.py), so a step pays no host cost.

# the stacked rows (C*B) up to which ck_dot64p takes the key-stationary plan:
# one 128-row slice reads the key once, each further slice reads it again;
# the crossover against the output-stationary plan, measured at CB_ACTIVE's
# and CB_PAPER's lvl2 shapes (C = 32, 16 limb rows, two planes, J*m = 512
# and 768) with a cold key each launch, lies between B = 48 and 56 at J*m =
# 512 and past 56 at 768 (tools/torch_ck_small_ab.py, PERF.md §6): B = 40
# here, 23% faster at 512
KST_ROWS = 1280
# the key-stationary block's resident key: 64 rows x 4 limb groups x J*m
# bytes in K tiles of 128, at most 6 (192 KB) beside its digit ring; the
# kernel owns the limit (KST_MAX_KTILES in csrc/ck_dot64p.cu, held there
# against its shared memory by a static_assert), this mirrors it
KST_KTILES = 6


def _ck_rows(B: int) -> int:
    return 128 if B > 64 else 64


def ck_kst_ok(N: int, m: int, Jm: int) -> bool:
    """The key-stationary plan's domain inside ck64_kernel_ok's: m a
    multiple of the 64-row key tile (a tile's ring positions then share one
    sign) and a resident key of at most KST_KTILES K tiles."""
    return m % 64 == 0 and -(-Jm // 128) <= KST_KTILES


@functools.lru_cache(maxsize=None)
def ck_dot64p_plan(B: int, N: int, m: int, Jm: int, planes: int) -> tuple:
    """(rows, kst) of a ck_dot64p launch: the key-stationary plan (kst
    True; rows 128, a block's slice of the C*B stacked rows) where C*B <=
    KST_ROWS inside ck_kst_ok, else the output-stationary plan's batch rows
    (its 64 columns of 4 limb rows are fixed).  Raises outside
    ck64_kernel_ok."""
    _ck64_require("ck_dot64p", N, m, Jm, planes)
    stacked = (N // m) * B
    if stacked <= KST_ROWS and ck_kst_ok(N, m, Jm):
        return 128, True
    return _ck_rows(B), False


@functools.lru_cache(maxsize=None)
def ck_dot64p_sacc_plan(B: int, N: int, m: int, Jm: int, planes: int) -> int:
    """The batch rows of a ck_dot64p_sacc block (ck_dot64p's
    output-stationary rows).  Raises outside ck64_kernel_ok."""
    _ck64_require("ck_dot64p_sacc", N, m, Jm, planes)
    return _ck_rows(B)


@functools.lru_cache(maxsize=None)
def ck_dot64p_acc_plan(B: int, N: int, m: int, Jm: int, L: int,
                       planes: int) -> tuple:
    """(rows, limbs) of a ck_dot64p_acc block: the rows as ck_dot64p_sacc's,
    two limbs a pass where L is even, else one.  Raises outside
    ck64_kernel_ok."""
    _ck64_require("ck_dot64p_acc", N, m, Jm, planes)
    return _ck_rows(B), 2 if L % 2 == 0 else 1


def _ck_key_shape(name, wmt, N, m):
    """(UL, Jm) of the K-packed key wmt (UL, N+m, J*m) int8, checked."""
    _check(wmt, f"{name} wmt", torch.int8, 3)
    UL, Npm, Jm = wmt.shape
    _require(_is_pow2(N) and N % m == 0 and Npm == N + m,
             f"{name}: wmt must be (U*L, N+m, J*m) with N a power of two and "
             f"a multiple of m")
    return UL, Jm


def ck_dot64p(x, wmt, *, N: int, m: int, planes: int = 1,
              digit_bits: int | None = None):
    """Chunked-key negacyclic contraction with per-limb int32 outputs:

        ring[g, b, c*m + q] += sum_p (x[b, (c*P+p)*ckp : +J*m] . wmt[g, q, :]) << 7p
        out[g, b, i] = ring[g, b, i] - ring[g, b, N + i]

    x: (B, C*P*ckp) int8 (rotate_decompose64_ck's layout); wmt: (U*L, N+m,
    J*m) int8, the K-packed chunked key (ChunkedEngine.prepare at 64 bits,
    ck_wmt).  Returns (U*L, B, N) int32.  The sums are exact in int32 when
    J*(N+m) * 2^(digit_bits-1) * 128 < 2^31 (digit_bits: the width of the
    digits the planes encode; 8 for one plane, 9 for two), which the
    wrapper asserts.

    Kernel: csrc/ck_dot64p.cu (replaces pallas_kernels.ck_dot64p).  It
    reads wmt by TMA and runs int8 wgmma, in one of two plans
    (ck_dot64p_plan).  Output-stationary, bound by int8 tensor-core MACs: a
    block owns 64 folded columns of 4 limb rows for 64 or 128 batch rows,
    and runs, per plane, the chunk windows that reach its columns (added)
    or their X^N wrap (subtracted): C + 1 or C + 2 chunk products of depth
    J*m, key rows outside [0, N+m) read as zero.  The 2N ring never reaches
    memory.  Key-stationary, where C*B <= KST_ROWS (B <= 40 at C=32: a
    4-bit query's B=4), bound by the key's bytes: a block holds 64 key rows
    of 4 limb rows, read once, against a slice of 128 of the C*B
    (chunk, batch) rows stacked along M, and adds each product row into
    its ring tile's outputs (negated above N) with a TMA reduction into
    out, zeroed first.  Each launch counts
    ``ck_dot64p.plan.<rows>x64.jm<J*m>.p<planes>`` (``kst<rows>`` for the
    key-stationary plan; utils.observability)."""
    _check(x, "ck_dot64p x", torch.int8, 2)
    UL, Jm = _ck_key_shape("ck_dot64p", wmt, N, m)
    B = x.shape[0]
    _require(planes in (1, 2), "ck_dot64p: planes must be 1 or 2")
    ckp = ck_width(Jm)
    _require(x.shape[1] == (N // m) * planes * ckp,
             "ck_dot64p: x must be (B, C*P*ckp)")
    _ck_exact_check("ck_dot64p", Jm, N, m,
                    digit_bits or (8 if planes == 1 else 9))
    if _on_cpu(x, wmt):
        return ck_dot64p_plain(x, wmt, N=N, m=m, planes=planes)
    rows, kst = ck_dot64p_plan(B, N, m, Jm, planes)
    out = torch.empty((UL, B, N), dtype=torch.int32, device=x.device)
    obs.count("kernel.ck_dot64p")
    obs.count(f"ck_dot64p.plan.{'kst' if kst else ''}{rows}x64.jm{Jm}"
              f".p{planes}")
    _launch("ck_dot64p", x.device,
            x.data_ptr(), wmt.data_ptr(), out.data_ptr(), B, N, m, Jm, UL,
            planes, ckp, rows, int(kst))
    return out


def ck_dot64p_wm(x, wm, **kw):
    """ck_dot64p on the chunked key as the engine prepares it at 32 bits
    (wm (U*L, J*m, N+m), N contiguous): one transpose copy a call (ck_wmt),
    counted as ``kernel.ck_dot64p.transposes`` on either device.  The 32-bit
    generic contraction (ChunkedEngine.accumulate), off the gate paths' own
    step."""
    obs.count("kernel.ck_dot64p.transposes")
    return ck_dot64p(x, ck_wmt(wm), **kw)


# ---------------------------------------------------------------------------
# ck_dot64p_acc
# ---------------------------------------------------------------------------

def recombine(y, kp1: int, shift_base: int = 0):
    """Per-limb folded products (kp1*L, B, N) int32 -> (B, kp1, N) int64:
    sum_l y[u*L + l] << (8l + shift_base), wrapping mod 2^64 (so mod 2^32
    too): ck_dot64p's outputs recombined."""
    UL, B, N = y.shape
    y = y.reshape(kp1, UL // kp1, B, N)
    out = 0
    for lm in range(UL // kp1):
        out = out + (y[:, lm].to(torch.int64) << (8 * lm + shift_base))
    return out.permute(1, 0, 2)


def ck_dot64p_acc_plain(x, wmt, acc, *, N: int, m: int, key_shift: int,
                        planes: int = 1, kp1: int):
    y = ck_dot64p_plain(x, wmt, N=N, m=m, planes=planes)
    return acc + recombine(y, kp1, key_shift).reshape(acc.shape)


def _ck_acc_checks(name, x, wmt, acc, *, N, m, planes, kp1, digit_bits):
    """The checks ck_dot64p_acc and ck_dot64p_sacc share; returns (UL, Jm,
    ckp)."""
    _check(x, f"{name} x", torch.int8, 2)
    _check(acc, f"{name} acc", torch.int64, 2)
    UL, Jm = _ck_key_shape(name, wmt, N, m)
    B = x.shape[0]
    _require(planes in (1, 2), f"{name}: planes must be 1 or 2")
    _require(UL % kp1 == 0 and acc.shape == (B, kp1 * N),
             f"{name}: acc must be (B, kp1*N) and wmt (kp1*L, ...)")
    ckp = ck_width(Jm)
    _require(x.shape[1] == (N // m) * planes * ckp,
             f"{name}: x must be (B, C*P*ckp)")
    _ck_exact_check(name, Jm, N, m, digit_bits or (8 if planes == 1 else 9))
    return UL, Jm, ckp


def ck_dot64p_acc(x, wmt, acc, *, N: int, m: int, key_shift: int,
                  planes: int = 1, kp1: int, digit_bits: int | None = None):
    """ck_dot64p with the 64-bit limb recombination and the accumulator add
    inside:

        out = acc + sum_l ck_dot64p(x, wmt)[u*L + l] << (8l + key_shift)

    mod 2^64.  x: (B, C*P*ckp) int8 (rotate_decompose64_ck's layout); wmt:
    (kp1*L, N+m, J*m) int8, the K-packed chunked key; acc: (B, kp1*N)
    int64, the flat accumulator.  Returns acc's shape.  The same int32
    bound as ck_dot64p is asserted.

    Kernel: csrc/ck_dot64p_acc.cu (replaces pallas_kernels.ck_dot64p_acc).
    Bound by int8 tensor-core MACs, as ck_dot64p, on its mainloop (TMA
    loads of wmt and the digits, int8 wgmma).  A block owns 64 folded
    columns of one polynomial for 64 or 128 rows, loops over its L limbs
    one or two at a time (ck_dot64p_acc_plan) and keeps the 64-bit sums in
    registers, so the (U*L, B, N) int32 products never reach device
    memory."""
    UL, Jm, ckp = _ck_acc_checks("ck_dot64p_acc", x, wmt, acc, N=N, m=m,
                                 planes=planes, kp1=kp1,
                                 digit_bits=digit_bits)
    if _on_cpu(x, wmt, acc):
        return ck_dot64p_acc_plain(x, wmt, acc, N=N, m=m,
                                   key_shift=key_shift, planes=planes,
                                   kp1=kp1)
    B, L = x.shape[0], UL // kp1
    rows, limbs = ck_dot64p_acc_plan(B, N, m, Jm, L, planes)
    out = torch.empty_like(acc)
    obs.count("kernel.ck_dot64p_acc")
    _launch("ck_dot64p_acc", x.device,
            x.data_ptr(), wmt.data_ptr(), acc.data_ptr(),
            out.data_ptr(), B, N, m, Jm, kp1, L, planes, ckp, key_shift, rows,
            limbs)
    return out


def ck_dot64p_sacc(x, wmt, acc, *, N: int, m: int, key_shift: int,
                   planes: int = 1, kp1: int, digit_bits: int | None = None):
    """ck_dot64p_acc's function and contract (its plain version is
    ck_dot64p_acc_plain) with the limb axis in the grid, on the K-packed
    key wmt.

    Kernel: csrc/ck_dot64p_sacc.cu (replaces pallas_kernels.ck_dot64p_sacc).
    Bound by int8 tensor-core MACs, on ck_dot64p's output-stationary
    mainloop and grid (64 folded columns of 4 limb rows for 64 or 128 batch
    rows, ck_dot64p_sacc_plan).  A block widens and shifts its limbs'
    folded products, sums those of one polynomial (a group of 4 limb rows
    may straddle two) and adds the sum into the output with 64-bit
    atomicAdd, after acc is copied there on the same stream; the additions
    commute mod 2^64, so the result is the same bits whatever the order."""
    UL, Jm, ckp = _ck_acc_checks("ck_dot64p_sacc", x, wmt, acc, N=N, m=m,
                                 planes=planes, kp1=kp1,
                                 digit_bits=digit_bits)
    if _on_cpu(x, wmt, acc):
        return ck_dot64p_acc_plain(x, wmt, acc, N=N, m=m,
                                   key_shift=key_shift, planes=planes,
                                   kp1=kp1)
    rows = ck_dot64p_sacc_plan(x.shape[0], N, m, Jm, planes)
    out = torch.empty_like(acc)
    obs.count("kernel.ck_dot64p_sacc")
    obs.count(f"ck_dot64p_sacc.plan.{rows}x64.jm{Jm}.p{planes}")
    _launch("ck_dot64p_sacc", x.device,
            x.data_ptr(), wmt.data_ptr(), acc.data_ptr(),
            out.data_ptr(), x.shape[0], N, m, Jm, kp1, UL // kp1, planes, ckp,
            key_shift, rows)
    return out


# ---------------------------------------------------------------------------
# launch configuration (the role of tfhe_tpu/ops/tiles.py for these kernels)
# ---------------------------------------------------------------------------

_SM_COUNT: dict = {}


def _device_index(device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def sm_count(device) -> int:
    """Streaming multiprocessors of the card ``device`` (a torch.device or
    its index) lies on."""
    idx = device if isinstance(device, int) else _device_index(device)
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def split_plan(steps: int, split: int) -> tuple:
    """(slice length, slices) of a reduction of ``steps`` steps cut
    ``split`` ways, as mm_recombine_acc_wt's kernel cuts its K walk of
    MM_BK-deep stages (csrc/mm_recombine_acc.cu): slices of ceil(steps /
    split) steps, the last one ragged; a split that would leave a slice
    empty takes fewer slices."""
    split = max(1, min(split, steps))
    n = -(-steps // split)
    return n, -(-steps // n)


def ck_windows(i0: int, N: int, m: int, tile: int = _BN) -> list:
    """The chunk windows of an output tile of folded columns [i0, i0 +
    tile) (128 in ck_cmux_step32, 64 in ck_cmux_step64), in the kernels'
    order: (chunk, +1) for the chunks whose key columns reach the tile, then
    (chunk, -1) for those whose X^N wrap reaches it; C + 1 of them when m
    is a multiple of the tile."""
    C = N // m
    add_end = min((i0 + tile - 1) // m + 1, C)
    return ([(c, 1) for c in range(add_end)]
            + [(c, -1) for c in range(i0 // m, C)])


@functools.lru_cache(maxsize=None)
def ck_work(N: int, m: int, tile: int = _BN) -> int:
    """The most windows any output tile of ``tile`` columns has
    (ck_windows)."""
    return max(len(ck_windows(i0, N, m, tile)) for i0 in range(0, N, tile))


def window_slice(nw: int, split: int, s: int) -> range:
    """The windows of slice ``s`` of ``split``: [s*nw/S, (s+1)*nw/S), as
    ck_cmux_step32's kernel cuts a tile's ``nw`` windows (empty where S >
    nw)."""
    return range(s * nw // split, (s + 1) * nw // split)


def choose_split(blocks, resident, sms: int, work: int, tiles=(64, 32),
                 overhead: float = 0.5):
    """(tile_rows, S) of a kernel whose output tiles own ``tile_rows`` batch
    rows (tile_rows / 8 warps a block) and whose reduction (``work``
    windows or steps per tile) may be cut into S slices, one block each:
    ``blocks(t)`` tiles, ``resident(t)`` blocks resident per SM (from the
    kernel's registers and shared memory; 0 where the tile does not fit) on
    ``sms`` SMs.

    The tile is the one that keeps the most warps resident on an SM (the
    steps are latency-bound, so warps in flight set the rate), the larger
    on a tie (each key tile then serves more rows).  A block walks
    ceil(work / S) of the reduction plus a fixed ``overhead`` (prologue,
    epilogue and atomics, in the same units), and the card runs
    ceil(blocks * S / (sms * resident)) rounds of resident blocks; S is the
    smallest that minimizes rounds x (walk + overhead).  So a grid that
    already fills the card many times (GATE_MXU B=8192) keeps S = 1, and a
    narrow one is cut until its blocks fill the resident slots once.
    Returns (None, 0) where no tile fits."""
    fit = [(resident(t) * t, t) for t in tiles]
    fit = [(warps, t) for warps, t in fit if warps > 0]
    if not fit:
        return None, 0
    t = max(fit)[1]
    slots, n = sms * resident(t), blocks(t)
    return t, min(range(1, work + 1),
                  key=lambda S: (-(-n * S // slots) * (-(-work // S)
                                                       + overhead), S))


@functools.lru_cache(maxsize=None)
def _occupancy(entry: str, *args) -> int:
    """A kernel's C launch-configuration query, memoized per arguments:
    blocks resident per SM (the *_occupancy entries), or the key ring's
    stages (ck_cmux_step64_stages)."""
    n = _build.entry(entry)(*args)
    if n < 0:
        raise RuntimeError(f"{entry}: occupancy query failed with "
                           f"cudaError {-n}")
    return n


# ---------------------------------------------------------------------------
# ck_cmux_step32
# ---------------------------------------------------------------------------

def ck_cmux_step32_smem(tile_rows: int, Jm: int, L: int) -> int:
    """Shared memory of one ck_cmux_step32 block: one chunk window's digits
    (tile_rows x (J*m + 16) bytes) and two buffers of one step's L key
    tiles (64 deep where J*m % 64 == 0, else 32)."""
    depth = 64 if Jm % 64 == 0 else 32
    return tile_rows * (Jm + 16) + 2 * L * _BN * depth


def ck_cmux_step32_plain(a, acc, wm, *, l: int, bgbit: int, offset: int,
                         m: int, key_shift: int = 0, kp1: int | None = None):
    B = acc.shape[0]
    kp1 = kp1 if acc.ndim == 2 else acc.shape[1]
    N = wm.shape[2] - m
    acc3 = acc.reshape(B, kp1, N)
    digits = rotate_decompose_plain(a, acc3, l=l, bgbit=bgbit, offset=offset)
    y = ck_dot64p_plain(ck_layout(digits[None], m), wm.transpose(1, 2), N=N,
                        m=m)
    return T.wrap32(acc3.to(torch.int64)
                    + recombine(y, kp1, key_shift)).reshape(acc.shape)


def ck_cmux_step32(a, acc, wm, *, l: int, bgbit: int, offset: int, m: int,
                   key_shift: int = 0, kp1: int | None = None,
                   tile_rows: int = 0, split: int = 0):
    """One 32-bit blind-rotation step on chunked pre-shifted keys:

        out = acc + recombine(decompose((X^a - 1) * acc) @ wm)   mod 2^32

    with the product folded as in ck_dot64p and limb l shifted by
    8l + key_shift.  a: (B,) int32 exponents (taken mod 2N); acc: (B, k+1,
    N) int32, or the flat (B, (k+1)*N) layout with kp1 given (the same
    bytes); wm: ((k+1)*L, (k+1)*l*m, N+m) int8 (ChunkedEngine.prepare).
    Returns acc's layout.

    Kernel: csrc/ck_cmux_step32.cu (replaces pallas_kernels.ck_cmux_step32).
    Bound by int8 tensor-core MACs.  An output tile is 128 columns of one
    output polynomial for 64 or 32 batch rows; its C + 1 chunk windows
    (ck_windows) are cut into ``split`` contiguous slices (window_slice),
    one block each, added into the output with 32-bit atomics after acc is
    copied there (one slice: the epilogue adds acc and stores).  A block
    builds the digits of its own chunks in shared memory straight from acc,
    pipelines the key tiles (the next 64-deep step's key words load into
    registers while this one's MMAs run; 32-deep where J*m % 64 != 0) and
    recombines its L limbs in registers.  ``tile_rows`` (64 or 32) and
    ``split`` (1 .. windows) force a plan; 0 lets choose_split pick from
    the SM count and the kernel's occupancy.  Any B >= 1."""
    _require(tile_rows in (0, 32, 64),
             "ck_cmux_step32: tile_rows must be 0, 32 or 64")
    _check(a, "ck_cmux_step32 a", torch.int32, 1)
    _require(acc.dtype == torch.int32 and acc.is_contiguous(),
             "ck_cmux_step32 acc: contiguous int32")
    _check(wm, "ck_cmux_step32 wm", torch.int8, 3)
    UL, Jm, Npm = wm.shape
    N = Npm - m
    if acc.ndim == 2:
        _require(kp1 is not None and acc.shape[1] == kp1 * N,
                 "ck_cmux_step32: flat acc needs kp1, (B, kp1*N)")
    else:
        _require(acc.ndim == 3 and acc.shape[2] == N,
                 "ck_cmux_step32 acc: (B, k+1, N)")
        kp1 = acc.shape[1]
    B = acc.shape[0]
    _require(a.shape[0] == B, "ck_cmux_step32: a must have B entries")
    _require(_is_pow2(N) and N % m == 0 and Jm == kp1 * l * m
             and UL % kp1 == 0,
             "ck_cmux_step32: wm must be ((k+1)*L, (k+1)*l*m, N+m) with N a "
             "power of two and a multiple of m")
    _require(1 <= bgbit <= 8 and l * bgbit <= 32,
             "ck_cmux_step32: digits must fit int8 (bgbit <= 8, l*bgbit <= 32)")
    L = UL // kp1
    _require(0 <= split <= ck_work(N, m), f"ck_cmux_step32: split must be "
             f"0 .. the {ck_work(N, m)} windows of a tile")
    if _on_cpu(a, acc, wm):
        return ck_cmux_step32_plain(a, acc, wm, l=l, bgbit=bgbit,
                                    offset=offset, m=m, key_shift=key_shift,
                                    kp1=kp1)
    _require(1 <= L <= 4 and N % _BN == 0 and m % 4 == 0 and Jm % _BK == 0,
             f"ck_cmux_step32: the kernel needs 1 to 4 key limbs, "
             f"N % {_BN} == 0, m % 4 == 0 and J*m % {_BK} == 0")
    tile_rows, split = ck_cmux_step32_plan(B, kp1, N, m, Jm, L, acc.device,
                                           tile_rows, split)
    out = torch.empty_like(acc)
    obs.count("kernel.ck_cmux_step32")
    _launch("ck_cmux_step32", a.device,
            a.data_ptr(), acc.data_ptr(), wm.data_ptr(),
            out.data_ptr(), B, kp1, N, m, l, L, bgbit, offset & T.MASK32,
            key_shift, tile_rows, split)
    return out


def ck_cmux_step32_plan(B: int, kp1: int, N: int, m: int, Jm: int, L: int,
                        device, tile_rows: int = 0, split: int = 0) -> tuple:
    """(tile_rows, split) of ck_cmux_step32's kernel for these shapes on the
    card ``device`` lies on: a forced value is kept (and checked), a 0 is
    chosen by choose_split (a tile's chunk window is the unit of work, a
    block's fixed cost about half of one).  Memoized: the 630 steps of a
    rotation ask again with the same shapes, and at narrow batches the
    host's time per launch is comparable to the kernel's."""
    return _ck32_plan(B, kp1, N, m, Jm, L, _device_index(device), tile_rows,
                      split)


@functools.lru_cache(maxsize=None)
def _ck32_plan(B, kp1, N, m, Jm, L, dev, tile_rows, split):
    fits = [t for t in ((tile_rows,) if tile_rows else (64, 32))
            if ck_cmux_step32_smem(t, Jm, L) <= MAX_SMEM]
    _require(bool(fits), f"ck_cmux_step32: the kernel's digit window needs "
             f"{ck_cmux_step32_smem(tile_rows or 32, Jm, L)} bytes "
             f"of shared memory or more, above {MAX_SMEM}")
    if tile_rows and split:
        return tile_rows, split
    t, S = choose_split(
        lambda t: (N // _BN) * -(-B // t) * kp1,
        lambda t: _occupancy("ck_cmux_step32_occupancy", L, t, Jm),
        sm_count(dev), ck_work(N, m), tiles=fits)
    _require(t is not None, "ck_cmux_step32: no row tile fits the card")
    return tile_rows or t, split or S


# ---------------------------------------------------------------------------
# ck_cmux_step64
# ---------------------------------------------------------------------------

def ck_cmux_step64_plain(a, acc, wmt, *, l: int, bgbit: int, offset: int,
                         m: int, key_shift: int, planes: int, kp1: int):
    B = acc.shape[0]
    N = wmt.shape[1] - m
    x = rotate_decompose64_ck_flat_plain(a, acc, N=N, l=l, bgbit=bgbit,
                                         offset=offset, m=m, planes=planes)
    return ck_dot64p_acc_plain(x, wmt, acc.reshape(B, kp1 * N), N=N, m=m,
                               key_shift=key_shift, planes=planes, kp1=kp1)


def ck_cmux_step64(a, acc, wmt, *, l: int, bgbit: int, offset: int, m: int,
                   key_shift: int, planes: int, kp1: int):
    """One 64-bit blind-rotation step on chunked pre-shifted keys:

        out = acc + recombine64(decompose64((X^a - 1) * acc) @ wmt^T)  mod 2^64

    a: (B,) int32 exponents (taken mod 2N); acc: (B, kp1*N) int64, the flat
    accumulator; offset the 64-bit gadget offset (unsigned); wmt: (kp1*L,
    N+m, kp1*l*m) int8, the K-packed chunked key (ChunkedEngine.prepare);
    digits split into ``planes`` balanced base-2^7 planes where planes=2.
    Returns acc's shape: the function of rotate_decompose64_ck_flat then
    ck_dot64p_acc, whose plain versions are its plain version.  The int32
    bound of ck_dot64p is asserted for bgbit-bit digits.

    Kernel: csrc/ck_cmux_step64.cu (replaces pallas_kernels.ck_cmux_step64),
    one launch a step.  Bound by int8 tensor-core MACs.  ck_dot64p_sacc's
    grid and epilogue (64 folded columns of 4 limb rows for 64 or 128 batch
    rows, 64-bit atomic adds into an acc-filled output), with the digits
    built by the block itself in shared memory from acc, one chunk window
    at a time, beside TMA loads of wmt and int8 wgmma; the rows of a block
    and the slices of each tile's windows (one block each) from
    ck_cmux_step64_plan.  Any B >= 1."""
    _check(a, "ck_cmux_step64 a", torch.int32, 1)
    _check(acc, "ck_cmux_step64 acc", torch.int64, 2)
    _check(wmt, "ck_cmux_step64 wmt", torch.int8, 3)
    UL, Npm, Jm = wmt.shape
    N = Npm - m
    B = acc.shape[0]
    _require(a.shape[0] == B, "ck_cmux_step64: a must have B entries")
    _require(N > 0 and _is_pow2(N) and N % m == 0 and acc.shape[1] == kp1 * N
             and Jm == kp1 * l * m and UL % kp1 == 0,
             "ck_cmux_step64: acc must be (B, kp1*N) and wmt (kp1*L, N+m, "
             "kp1*l*m) with N a power of two and a multiple of m")
    _check_digits64("ck_cmux_step64", planes, bgbit, l)
    _ck_exact_check("ck_cmux_step64", Jm, N, m, bgbit)
    L = UL // kp1
    if _on_cpu(a, acc, wmt):
        return ck_cmux_step64_plain(a, acc, wmt, l=l, bgbit=bgbit,
                                    offset=offset, m=m, key_shift=key_shift,
                                    planes=planes, kp1=kp1)
    rows, split = ck_cmux_step64_plan(B, kp1, N, m, Jm, L, planes,
                                      acc.device)
    out = torch.empty_like(acc)
    obs.count("kernel.ck_cmux_step64")
    _launch("ck_cmux_step64", a.device,
            a.data_ptr(), acc.data_ptr(), wmt.data_ptr(),
            out.data_ptr(), B, kp1, N, m, l, L, planes, bgbit,
            offset & ((1 << 64) - 1), key_shift, rows, split)
    return out


def ck_cmux_step64_plan(B: int, kp1: int, N: int, m: int, Jm: int, L: int,
                        planes: int, device) -> tuple:
    """(rows, split) of ck_cmux_step64's kernel for these shapes on the card
    ``device`` lies on.  Rows as ck_dot64p's (128 above B = 64, else 64)
    where the 128-row plan's key ring holds two stages beside its two digit
    buffers (the C query ck_cmux_step64_stages), else 64; the split by
    choose_split from one block an SM (each block takes nearly all shared
    memory), a tile's chunk window as the unit of work and a block's fixed
    cost (its first digit build, the atomic epilogue) about one window.
    Memoized: the
    1,000 steps of a circuit bootstrap ask with the same shapes.  Raises
    outside ck_cmux_step64_ok or where no plan fits."""
    return _ck64_plan(B, kp1, N, m, Jm, L, planes, _device_index(device))


@functools.lru_cache(maxsize=None)
def _ck64_plan(B, kp1, N, m, Jm, L, planes, dev):
    _ck64_require("ck_cmux_step64", N, m, Jm, planes, ck_cmux_step64_ok)
    fits = [t for t in ((128, 64) if B > 64 else (64,))
            if _occupancy("ck_cmux_step64_stages", t, Jm)]
    _require(bool(fits), f"ck_cmux_step64: J*m = {Jm} leaves no room for a "
             f"two-stage key ring beside the digit buffers")
    t = fits[0]
    _, S = choose_split(
        lambda t: (N // 64) * -(-B // t) * -(-kp1 * L // 4),
        lambda t: 1, sm_count(dev), ck_work(N, m, 64), tiles=(t,),
        overhead=1.0)
    return t, S



# ---------------------------------------------------------------------------
# priv_keyswitch (the circuit bootstrap's private functional key switch)
# ---------------------------------------------------------------------------

# the kernel's unit (csrc/priv_keyswitch.cu): ``rows`` batch rows x PK_COLS
# output columns of the 4 limbs over one K slice of PK_BK-deep stages
PK_COLS, PK_BK = 64, 128
PK_OVERHEAD = 4            # a block's fixed cost (fill, epilogue), in stages
_PK_CHUNK = 8192           # K' columns of the plain version's float64 blocks


def privks_depth(n1: int, t: int, basebit: int) -> int:
    """K' = n1 * t * (2^basebit - 1): the packed table's depth, the
    digit-0-free one-hot positions (i, j, v - 1) of n1 coefficients."""
    return n1 * t * ((1 << basebit) - 1)


def privks_onehot(x64, *, t: int, basebit: int):
    """The digit-0-free one-hot of x64 (B, n1) int64: (B, K') int8 with
    position (i, j, v - 1) set where digit j of coefficient i is v (the
    rounding digits of circuit.priv_keyswitch_digits)."""
    base = 1 << basebit
    aibar = x64 + (1 << (63 - basebit * t))
    digs = torch.stack([(aibar >> (64 - (j + 1) * basebit)) & (base - 1)
                        for j in range(t)], dim=-1)          # (B, n1, t)
    v = torch.arange(1, base, dtype=digs.dtype, device=x64.device)
    return (digs[..., None] == v).to(torch.int8).reshape(x64.shape[0], -1)


def priv_keyswitch_plain(x64, table, *, t: int, basebit: int):
    B, n1 = x64.shape
    kq = privks_depth(n1, t, basebit)
    onehot = privks_onehot(x64, t=t, basebit=basebit).to(torch.float64)
    out = torch.zeros((B, table.shape[1]), dtype=torch.int64,
                      device=x64.device)
    for lm in range(table.shape[0]):
        y = torch.zeros((B, table.shape[1]), dtype=torch.float64,
                        device=x64.device)
        for k0 in range(0, kq, _PK_CHUNK):
            k1 = min(kq, k0 + _PK_CHUNK)
            y += onehot[:, k0:k1] @ table[lm, :, k0:k1].T.to(torch.float64)
        out += y.to(torch.int64) << (8 * lm)
    return T.wrap32(out)


def priv_keyswitch(x64, table, *, t: int, basebit: int, split: int = 0):
    """The private functional key switch's product on the packed table of
    one z: out[b, c] = sum_{i,j} table[., c, (i, j, d_ij - 1)] recombined
    over the 4 limbs (<< 8 l), mod 2^32, for the rounding digits d_ij != 0
    of x64's coefficients (circuit.priv_keyswitch_digits: t digits of
    ``basebit`` bits, top-down).

    x64: (B, n1) int64 (the extracted LWE64 samples, n1 = n + 1); table:
    (4, UN, kstride) int8, circuit.prepare_privks's table of one z (K' =
    privks_depth(n1, t, basebit) columns, the limbs of the negated key
    samples).  Returns (B, UN) int32: circuit.priv_keyswitch's output, bit
    for bit.

    Kernel: csrc/priv_keyswitch.cu (no Pallas counterpart: the JAX package
    leaves the key switch to XLA).  Bound by the table's bytes, read once;
    TMA feeds int8 wgmma with the 4 limbs stacked along N, the block builds
    the one-hot A tiles in shared memory from x64, and the K' walk is split
    over the card (priv_keyswitch_plan; ``split`` > 0 forces the slices),
    each block adding its rows into the zeroed output with a TMA reduction.
    Each launch counts ``priv_keyswitch.plan.<rows>x64.s<split>``
    (utils.observability)."""
    _check(x64, "priv_keyswitch x64", torch.int64, 2)
    _check(table, "priv_keyswitch table", torch.int8, 3)
    B, n1 = x64.shape
    L, UN, kstride = table.shape
    kq = privks_depth(n1, t, basebit)
    _require(L == 4 and kstride >= kq,
             f"priv_keyswitch: table must be (4, UN, >= {kq})")
    _require(1 <= basebit and basebit * t <= 63,
             "priv_keyswitch: the t digits must fit below bit 63")
    _require(n1 * t * 128 < 2**31,
             "priv_keyswitch: a limb's sum would leave int32")
    _require(split >= 0, "priv_keyswitch: split must be >= 0 (0 chooses)")
    if _on_cpu(x64, table):
        return priv_keyswitch_plain(x64, table, t=t, basebit=basebit)
    _require(UN % PK_COLS == 0 and kstride % 16 == 0 and kq < 2**20
             and t * ((1 << basebit) - 1) >= 16 and basebit <= 3
             and basebit * t <= 32,
             f"priv_keyswitch: the kernel needs UN % {PK_COLS} == 0, a "
             f"row stride % 16 == 0, K' < 2^20, t (base - 1) >= 16, "
             f"basebit <= 3 and basebit * t <= 32")
    _require(table.data_ptr() % 16 == 0,
             "priv_keyswitch: the kernel needs a 16-byte aligned table")
    rows, S, _ = priv_keyswitch_plan(B, kq, UN, sm_count(x64.device), split)
    out = torch.empty((B, UN), dtype=torch.int32, device=x64.device)
    obs.count("kernel.priv_keyswitch")
    obs.count(f"priv_keyswitch.plan.{rows}x{PK_COLS}.s{S}")
    _launch("priv_keyswitch", x64.device, x64.data_ptr(), table.data_ptr(),
            out.data_ptr(), B, n1, t, basebit, UN, kstride, rows, S)
    return out


@functools.lru_cache(maxsize=None)
def priv_keyswitch_plan(B: int, kq: int, UN: int, sms: int,
                        split: int = 0) -> tuple:
    """(rows, split, blocks) of a priv_keyswitch launch on a card of ``sms``
    SMs (csrc/priv_keyswitch.cu): blocks of ``rows`` batch rows (128, two
    consumer warpgroups; 64 where B <= 64) x PK_COLS columns of the 4 limbs
    over one of ``split`` slices of the ceil(K' / PK_BK) stages
    (split_plan), one block a unit.

    The split, where not forced: among the splits whose units fill the card
    (at least ``sms``; output tiles alone are UN / 64 = 32 at the CB
    blocks), the smallest S that minimizes ceil(units / sms) x (stages a
    slice + PK_OVERHEAD), the waves of blocks times a block's cost; a slice
    is at least one stage.  Pure and memoized."""
    rows = 64 if B <= 64 else 128
    steps = -(-kq // PK_BK)
    tiles = -(-B // rows) * (UN // PK_COLS)

    def cost(S):
        n, slices = split_plan(steps, S)
        return -(-tiles * slices // sms) * (n + PK_OVERHEAD)
    if not split:
        fill = [S for S in range(1, steps + 1)
                if tiles * split_plan(steps, S)[1] >= sms]
        split = min(fill or [steps], key=lambda S: (cost(S), S))
    S = split_plan(steps, split)[1]
    return rows, S, tiles * S
