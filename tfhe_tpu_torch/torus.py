"""Torus scalar arithmetic on torch integer tensors.

Torus32 values are int32 tensors: x stands for x / 2^32 mod 1.  PyTorch has
no usable uint32 arithmetic on every device (the CPU lacks uint32 shifts), so
every unsigned step is carried in int64 holding the value in [0, 2^32) and
wrapped back to int32 with ``wrap32``.

Torus64 values are int64 tensors.  Torch has no general uint64 arithmetic,
but int64 addition, subtraction, negation and left shifts wrap mod 2^64, so
they are the unsigned operations already; only the right shift differs
(``>>`` is arithmetic), which ``srl64`` masks.  Results are bit-identical to
the uint32/uint64 formulations of ``tfhe_tpu.torus``.

Also hosts the limb-splitting utilities that map torus operands onto exact
int8 operands for the tensor-core engines.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def u32(x) -> torch.Tensor:
    """int32 torus tensor -> int64 tensor of its unsigned value."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def wrap32(x) -> torch.Tensor:
    """int64 tensor -> int32 tensor, reduced mod 2^32 (two's complement)."""
    return (((x + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)


def add(x, y) -> torch.Tensor:
    """x + y on the torus of x's dtype (int32 through int64, int64 wraps)."""
    if x.dtype == torch.int32:
        return wrap32(x.to(torch.int64) + y)
    return x + y


def sub(x, y) -> torch.Tensor:
    """x - y on the torus of x's dtype."""
    if x.dtype == torch.int32:
        return wrap32(x.to(torch.int64) - y)
    return x - y


def srl64(x, s: int) -> torch.Tensor:
    """Logical right shift of int64 torus values by 0 <= s < 64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def signed64(v: int) -> int:
    """An unsigned 64-bit constant as the int64 value with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def dtot32(d) -> torch.Tensor:
    """double -> Torus32 (numeric_functions.cpp:36-38): frac(d) * 2^32,
    truncated toward zero and wrapped."""
    d = torch.as_tensor(d, dtype=torch.float64)
    return wrap32(((d - torch.trunc(d)) * 2.0**32).to(torch.int64))


def t32tod(x) -> torch.Tensor:
    """Torus32 -> double in [-1/2, 1/2) (numeric_functions.cpp:40-42)."""
    return torch.as_tensor(x).to(torch.float64) / 2.0**32


def t64tod(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float64) / 2.0**64


def t64tot32(x) -> torch.Tensor:
    """Torus64 -> Torus32: the top 32 bits (poc_types.h:17-19)."""
    return (torch.as_tensor(x).to(torch.int64) >> 32).to(torch.int32)


def t32tot64(x) -> torch.Tensor:
    """Torus32 -> Torus64 (poc_types.h:20-22)."""
    return torch.as_tensor(x).to(torch.int64) << 32


def double_to_t32(d: float) -> int:
    """Python-scalar double -> Torus32 int (for parameter constants)."""
    frac = d - int(d)
    return int((frac * 2**32)) & MASK32


def _host_uint64(x):
    return (x.detach().cpu().numpy().astype(np.int64)
            & MASK32).astype(np.uint64)


def approx_phase32(phase, msize: int):
    """Round a Torus32 phase to the nearest multiple of 1/msize
    (numeric_functions.cpp:45-53)."""
    assert msize > 0
    phase = torch.as_tensor(phase)
    if msize & (msize - 1) == 0:
        # 2^64/msize = 2^(32+s): round the top bits of x * 2^32 (mod 2^64)
        s = 32 - msize.bit_length() + 1
        v = (u32(phase) + (1 << (s - 1))) & MASK32
        return wrap32((v >> s) << s)
    interv = np.uint64(((1 << 63) // msize) * 2)
    p64 = (_host_uint64(phase) << np.uint64(32)) + interv // np.uint64(2)
    p64 = p64 - p64 % interv
    out = (p64 >> np.uint64(32)).astype(np.uint32).astype(np.int32)
    return torch.from_numpy(out).to(phase.device)


def mod_switch_from_torus32(phase, msize: int):
    """Torus32 -> integer mod msize with centred rounding
    (numeric_functions.cpp:55-61).  For power-of-two msize this is a shift
    chain on the device; the result lies in [0, msize)."""
    phase = torch.as_tensor(phase)
    if msize & (msize - 1) == 0:
        s = 32 - (msize.bit_length() - 1)     # interv = 2^(32 + s)
        assert s >= 1
        return (((u32(phase) + (1 << (s - 1))) >> s)
                & (msize - 1)).to(torch.int32)
    interv = np.uint64(((1 << 63) // msize) * 2)
    p64 = (_host_uint64(phase) << np.uint64(32)) + interv // np.uint64(2)
    out = (p64 // interv).astype(np.int32)
    return torch.from_numpy(out).to(phase.device)


def mod_switch_to_torus32(mu, msize: int) -> torch.Tensor:
    """Integer mod msize -> Torus32 (numeric_functions.cpp:63-67): the top
    32 bits of mu * interv mod 2^64, interv = 2^64 / msize rounded down to
    even."""
    interv = signed64(((1 << 63) // msize) * 2)
    return wrap32((torch.as_tensor(mu).to(torch.int64) * interv) >> 32)


# ---------------------------------------------------------------------------
# Limb splitting: torus integers -> exact int8 operands
# ---------------------------------------------------------------------------

def balanced_limbs(x, num_limbs: int, limb_bits: int = 8):
    """Split int32 or int64 torus values into balanced signed limbs: x ===
    sum_i l_i * 2^(limb_bits*i) (mod 2^(limb_bits*num_limbs)), every l_i in
    [-2^(b-1), 2^(b-1)).  Returned stacked on a new leading axis, int8."""
    assert limb_bits <= 8
    x = torch.as_tensor(x)
    if x.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"balanced_limbs takes int32 or int64, got {x.dtype}")
    base = 1 << limb_bits
    half = base >> 1
    wide = x.dtype == torch.int64
    u = x if wide else u32(x)
    out = []
    for _ in range(num_limbs):
        limb = (((u & (base - 1)) + half) & (base - 1)) - half
        out.append(limb.to(torch.int8))
        # u - limb is a multiple of 2^limb_bits; at 64 bits it wraps mod
        # 2^64 and the unsigned shift needs the mask
        u = srl64(u - limb, limb_bits) if wide else (u - limb) >> limb_bits
    return torch.stack(out, dim=0)


def recombine_limbs(parts, limb_bits: int, out_bits: int = 32):
    """Inverse of balanced_limbs on accumulated int32 results: parts has a
    leading limb axis; returns sum_i parts[i] << (limb_bits*i) mod
    2^out_bits, int32 or int64."""
    acc = torch.zeros(parts.shape[1:], dtype=torch.int64, device=parts.device)
    for i in range(parts.shape[0]):
        acc = acc + (parts[i].to(torch.int64) << (limb_bits * i))
    return acc if out_bits == 64 else wrap32(acc)


def signed_planes(d, plane_bits: int, num_planes: int):
    """Split small signed digits into balanced sub-planes (for gadget digits
    wider than 8 bits).  Exact: d == sum_i p_i 2^(b*i)."""
    base = 1 << plane_bits
    half = base >> 1
    u = torch.as_tensor(d)
    if u.dtype not in (torch.int32, torch.int64):
        u = u.to(torch.int32)
    out = []
    for _ in range(num_planes):
        r = ((u + half) & (base - 1)) - half
        out.append(r.to(torch.int8))
        u = (u - r) >> plane_bits
    return torch.stack(out, dim=0)
