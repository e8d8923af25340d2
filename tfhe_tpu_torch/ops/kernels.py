"""The hand-written CUDA kernels of the CMux step, their wrappers and their
plain PyTorch versions (the counterpart of ``tfhe_tpu/ops/pallas_kernels.py``
for the 32-bit gate-bootstrap path).

Every wrapper takes its plain version when its tensors lie on the CPU and
launches its kernel (``csrc/<name>.cu``, built by ``_build``) when they lie on
a CUDA device; there is no fallback from one to the other.  A wrapper checks
dtype, shape, device and contiguity, allocates its output with
``torch.empty``, launches on the current stream, raises if the launch
reports an error, and adds one to its ``launches`` counter per launch.

The plain versions are the same exact integer functions: int8 products are
contracted in float64 (every dot is an integer below 2^53, so the BLAS sum is
exact) and the mod-2^32 recombination runs in int64.

  kernel               replaces (pallas_kernels.py)  bound on the H100
  materialize_w        materialize_w                 bytes written (L*J*U*N*N)
  rotate_decompose     rotate_decompose              bytes moved (4 + l per coeff)
  mm_recombine_acc     mm_recombine_acc              int8 MACs (W bytes at small B)
  fused_cmux_step_v2   fused_cmux_step_v2            int8 MACs
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.ops import _build, poly

# dynamic shared memory a block may use on sm_90 (bytes)
MAX_SMEM = 232448
_BM, _BN, _BK, _SB_WORDS = 64, 128, 32, 9        # the 64-row tile (csrc/)


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


def _launch(name: str, *args):
    rc = _build.entry(name)(*args, torch.cuda.current_stream().cuda_stream)
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


def materialize_w(v):
    """v: (L, J, U, 2N) int8 doubled limb vectors ->
    W: (L, J*N, U*N) int8 with W[l, (j,t), (u,i)] = v[l,j,u,(i-t) mod 2N].

    Kernel: csrc/materialize_w.cu (replaces pallas_kernels.materialize_w).
    Bound by the L*J*U*N^2 bytes it writes; one 16-byte store per thread
    from a shared-memory copy of the vector."""
    _check(v, "materialize_w v", torch.int8, 4)
    L, J, U, twoN = v.shape
    N = twoN // 2
    _require(_is_pow2(twoN), "materialize_w: 2N must be a power of two")
    if _on_cpu(v):
        return materialize_w_plain(v)
    _require(N >= 16, "materialize_w: the kernel needs N >= 16")
    out = torch.empty((L, J * N, U * N), dtype=torch.int8, device=v.device)
    materialize_w.launches += 1
    _launch("materialize_w", v.data_ptr(), out.data_ptr(), L, J, U, N)
    return out


materialize_w.launches = 0


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
    per coefficient); one block per polynomial row, rotation computed per
    coefficient from a shared-memory copy of the row."""
    _check(a, "rotate_decompose a", torch.int32, 1)
    _check(acc, "rotate_decompose acc", torch.int32, 3)
    B, kp1, N = acc.shape
    _require(a.shape[0] == B, "rotate_decompose: a must have one entry per row")
    _require(_is_pow2(N), "rotate_decompose: N must be a power of two")
    _require(1 <= bgbit <= 8 and l * bgbit <= 32,
             "rotate_decompose: digits must fit int8 (bgbit <= 8, l*bgbit <= 32)")
    if _on_cpu(a, acc):
        return rotate_decompose_plain(a, acc, l=l, bgbit=bgbit, offset=offset)
    out = torch.empty((B, kp1 * l, N), dtype=torch.int8, device=acc.device)
    rotate_decompose.launches += 1
    _launch("rotate_decompose", a.data_ptr(), acc.data_ptr(), out.data_ptr(),
            B, kp1, N, l, bgbit, offset & T.MASK32)
    return out


rotate_decompose.launches = 0


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


def mm_recombine_acc(x, w, acc_in, *, shift_base: int = 0):
    """acc_in + sum_l (x @ w[l]) << (8l + shift_base), mod 2^32.

    x: (B, K) int8; w: (L, K, U*N) int8 (materialize_w layout); acc_in:
    (B, U, N) or (B, U*N) int32.  Returns int32 in acc_in's shape.

    Kernel: csrc/mm_recombine_acc.cu (replaces
    pallas_kernels.mm_recombine_acc).  Bound by int8 tensor-core MACs at
    large B and by the W stream at small B; mma.sync tiles keep every limb's
    accumulator in registers, so recombination and the add are one
    epilogue."""
    _check(x, "mm_recombine_acc x", torch.int8, 2)
    _check(w, "mm_recombine_acc w", torch.int8, 3)
    _require(acc_in.dtype == torch.int32 and acc_in.ndim in (2, 3)
             and acc_in.is_contiguous(),
             "mm_recombine_acc acc_in: contiguous (B, U, N) or (B, U*N) int32")
    B, K = x.shape
    L, Kw, UN = w.shape
    _require(K == Kw, "mm_recombine_acc: x and w disagree on K")
    _require(acc_in.shape[0] == B and acc_in[0].numel() == UN,
             "mm_recombine_acc: acc_in must be (B, U*N)")
    if _on_cpu(x, w, acc_in):
        return mm_recombine_acc_plain(x, w, acc_in, shift_base=shift_base)
    _require(1 <= L <= 4, "mm_recombine_acc: the kernel takes 1 to 4 limbs")
    _require(K % _BK == 0 and UN % _BN == 0,
             f"mm_recombine_acc: the kernel needs K % {_BK} == 0 and "
             f"U*N % {_BN} == 0")
    out = torch.empty_like(acc_in)
    mm_recombine_acc.launches += 1
    _launch("mm_recombine_acc", x.data_ptr(), w.data_ptr(), acc_in.data_ptr(),
            out.data_ptr(), B, K, UN, L, shift_base)
    return out


mm_recombine_acc.launches = 0


# ---------------------------------------------------------------------------
# fused_cmux_step_v2
# ---------------------------------------------------------------------------

def fused_cmux_step_v2_plain(a, acc, w, *, l: int, bgbit: int, offset: int,
                             key_shift: int = 0, kp1: int | None = None):
    B = acc.shape[0]
    kp1 = kp1 if acc.ndim == 2 else acc.shape[1]
    acc3 = acc.reshape(B, kp1, -1)
    digits = rotate_decompose_plain(a, acc3, l=l, bgbit=bgbit, offset=offset)
    return mm_recombine_acc_plain(digits.reshape(B, -1), w, acc,
                                  shift_base=key_shift)


def fused_cmux_step_v2(a, acc, w, *, l: int, bgbit: int, offset: int,
                       key_shift: int = 0, kp1: int | None = None,
                       tile_rows: int = 0):
    """One blind-rotation step, fully fused:

        out = acc + recombine(decompose((X^a - 1) * acc) @ w)

    a: (B,) int32; acc: (B, k+1, N) int32, or the flat (B, (k+1)*N) layout
    with kp1 given (the same bytes); w: (L <= 3, (k+1)*l*N, (k+1)*N) int8.
    Returns acc's layout.

    Kernel: csrc/fused_cmux_step.cu (replaces
    pallas_kernels.fused_cmux_step_v2).  Bound by int8 tensor-core MACs;
    the digits are built per tile in shared memory and never written to
    device memory (rebuilt once per 128-column output tile, in swizzled
    planes).  The batch tile is 128 rows once 64-row tiles would need more
    blocks than the card has SMs (and the 128-row tile fits shared memory),
    else 64; ``tile_rows`` 64 or 128 forces one, to time both (0 chooses)."""
    _require(tile_rows in (0, 64, 128),
             "fused_cmux_step_v2: tile_rows must be 0, 64 or 128")
    _check(a, "fused_cmux_step_v2 a", torch.int32, 1)
    _require(acc.dtype == torch.int32 and acc.is_contiguous(),
             "fused_cmux_step_v2 acc: contiguous int32")
    _check(w, "fused_cmux_step_v2 w", torch.int8, 3)
    if acc.ndim == 2:
        _require(kp1 is not None, "fused_cmux_step_v2: flat acc needs kp1")
        B, N = acc.shape[0], acc.shape[1] // kp1
    else:
        _require(acc.ndim == 3, "fused_cmux_step_v2 acc: (B, k+1, N)")
        B, kp1, N = acc.shape
    L, K, UN = w.shape
    _require(a.shape[0] == B, "fused_cmux_step_v2: a must have B entries")
    _require(K == kp1 * l * N and UN == kp1 * N,
             "fused_cmux_step_v2: w must be (L, (k+1)*l*N, (k+1)*N)")
    _require(1 <= L <= 3, "fused_cmux_step_v2 takes 1 to 3 key limbs")
    _require(_is_pow2(N), "fused_cmux_step_v2: N must be a power of two")
    _require(1 <= bgbit <= 8 and l * bgbit <= 32,
             "fused_cmux_step_v2: digits must fit int8")
    if _on_cpu(a, acc, w):
        return fused_cmux_step_v2_plain(a, acc, w, l=l, bgbit=bgbit,
                                        offset=offset, key_shift=key_shift,
                                        kp1=kp1)
    smem = l * _BM * N + L * _BN * _SB_WORDS * 4      # the 64-row tile
    _require(N % _BK == 0 and UN % _BN == 0 and smem <= MAX_SMEM,
             f"fused_cmux_step_v2: the kernel needs N % {_BK} == 0, "
             f"(k+1)*N % {_BN} == 0 and {smem} <= {MAX_SMEM} bytes of "
             f"shared memory")
    out = torch.empty_like(acc)
    fused_cmux_step_v2.launches += 1
    _launch("fused_cmux_step", a.data_ptr(), acc.data_ptr(), w.data_ptr(),
            out.data_ptr(), B, kp1, N, l, L, bgbit, offset & T.MASK32,
            key_shift, tile_rows)
    return out


fused_cmux_step_v2.launches = 0

KERNELS = (materialize_w, rotate_decompose, mm_recombine_acc,
           fused_cmux_step_v2)


def reset_launches():
    for k in KERNELS:
        k.launches = 0
