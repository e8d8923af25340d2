"""Plain TFHE arithmetic in PyTorch: the benchmark's reference and the
client's key making share it.

Nothing here comes from the program under test.  Torus32 values are carried
as int64 and reduced with ``wrap32``; Torus64 values are int64, whose +, -
and << wrap mod 2^64.  Every product is exact:

* a binary key times uniform torus polynomials (``key_times``): the
  polynomials split into unsigned 16-bit limbs, each limb a float64 row
  times the key's negacyclic matrix, sums below 2^27;
* gadget digits times a TRGSW (``external_product``): the key rows split
  into 16-bit limbs, negacyclic products by float64 FFTs of length 2N whose
  sums stay below 2^38 (well inside float64's 53 bits, with the FFT's
  rounding error far under 1/2), rounded back to integers.

Conventions (upstream TFHE, poc_CircuitBootstrapping.cpp): an LWE sample is
(a, b) with b = <a, s> + e + m; a TRLWE sample is (a_1..a_k, b) with
b = sum a_i * s_i + e + m; a TRGSW row (bloc u, level j) adds m * h_j to
coefficient 0 of polynomial u; the phase is b - <a, s>.
"""

from __future__ import annotations

import torch

MASK32 = (1 << 32) - 1


def wrap32(x):
    """int64 -> int64 in [-2^31, 2^31), reduced mod 2^32."""
    return ((x + (1 << 31)) & MASK32) - (1 << 31)


def signed64(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def limbs16(x, count: int):
    """int64 torus values -> (count, ...) float64 unsigned 16-bit limbs,
    x = sum limb_i * 2^(16 i) mod 2^(16 count)."""
    return torch.stack([((x >> (16 * i)) & 0xFFFF).to(torch.float64)
                        for i in range(count)])


def from_limbs(parts, bits: int):
    """(count, ...) exact integer float64 sums of 16-bit limb products ->
    int64 mod 2^bits.  Two limbs recombine exactly in float64 (|sums| <
    2^37, so limb 1's share stays under 2^53)."""
    parts = torch.round(parts)
    if bits == 32:
        return wrap32((parts[0] + parts[1] * 65536.0).to(torch.int64))
    out = parts[0].to(torch.int64)
    for i in range(1, parts.shape[0]):
        out = out + (parts[i].to(torch.int64) << (16 * i))
    return out


def negacyclic_matrix(s):
    """(N,) -> (N, N) float64 M with (x @ M) = x * s mod X^N + 1."""
    N = s.shape[-1]
    t = torch.arange(N, device=s.device)
    d = t[None, :] - t[:, None]                     # column - row
    vals = s.to(torch.float64)[d % N]
    return torch.where(d >= 0, vals, -vals)


def key_times(a, key, bits: int, rows_per_block: int = 1 << 15):
    """sum_i a[..., i, :] * key[i] (negacyclic), mod 2^bits.
    a: (..., k, N) int64; key: (k, N) binary."""
    k, N = key.shape
    lead = a.shape[:-2]
    flat = a.reshape(-1, k, N)
    mats = [negacyclic_matrix(key[i]) for i in range(k)]
    count = bits // 16
    out = torch.empty((flat.shape[0], N), dtype=torch.int64, device=a.device)
    for r0 in range(0, flat.shape[0], rows_per_block):
        blk = flat[r0:r0 + rows_per_block]
        acc = None
        for i in range(k):
            part = limbs16(blk[:, i], count) @ mats[i]     # (count, rows, N)
            acc = part if acc is None else acc + part
        out[r0:r0 + rows_per_block] = from_limbs(acc, bits)
    return out.reshape(*lead, N)


def mod_switch(x, msize: int):
    """Torus32 -> Z_msize with centred rounding (msize a power of two)."""
    s = 32 - (msize.bit_length() - 1)
    return (((x & MASK32) + (1 << (s - 1))) >> s) & (msize - 1)


def rotation_tables(N: int, device):
    """For every exponent p in [0, 2N): the source index and sign of each
    coefficient of X^p * x (X^N = -1)."""
    t = (torch.arange(N, device=device)[None, :]
         - torch.arange(2 * N, device=device)[:, None]) % (2 * N)
    return t % N, torch.where(t >= N, -1, 1)


def mul_by_xai(p, x, tables=None):
    """X^p * x per row: x (B, ..., N), p (B,) in [0, 2N)."""
    idx, sgn = tables or rotation_tables(x.shape[-1], x.device)
    shape = (p.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return torch.gather(x, -1, idx[p].reshape(shape).expand(x.shape)) \
        * sgn[p].reshape(shape)


def decompose(x, l: int, bgbit: int, bits: int):
    """Signed gadget digits of torus polynomials (..., N) -> (..., l, N),
    in [-Bg/2, Bg/2) (tGswTorus32PolynomialDecompH and its 64-bit twin)."""
    half = 1 << (bgbit - 1)
    if bits == 32:
        offset = (half * sum(1 << (32 - (i + 1) * bgbit) for i in range(l))
                  ) & MASK32
        buf = ((x & MASK32) + offset) & MASK32
    else:
        offset = signed64(sum(1 << (63 - i * bgbit) for i in range(l + 1)))
        buf = x + offset
    shifts = torch.tensor([bits - (i + 1) * bgbit for i in range(l)],
                          device=x.device)[:, None]
    return ((buf[..., None, :] >> shifts) & ((1 << bgbit) - 1)) - half


def trgsw_spectrum(rows, bits: int):
    """TRGSW rows (J, U, N) int64 -> (J, U, L, N+1) complex128: the rfft of
    length 2N of each 16-bit limb."""
    J, U, N = rows.shape
    lim = limbs16(rows, bits // 16)                         # (L, J, U, N)
    return torch.fft.rfft(lim.permute(1, 2, 0, 3), 2 * N)


def external_product(digits, spectrum, bits: int):
    """sum_j digits[:, j] * rows[j, u] for every u, mod 2^bits.
    digits: (B, J, N) int64 small; spectrum: trgsw_spectrum(rows)."""
    N = digits.shape[-1]
    df = torch.fft.rfft(digits.to(torch.float64), 2 * N)    # (B, J, N+1)
    prod = torch.einsum("bjf,julf->lbuf", df, spectrum)
    c = torch.fft.irfft(prod, 2 * N)                        # (L, B, U, 2N)
    return from_limbs(c[..., :N] - c[..., N:], bits)


class BlindRotation:
    """acc <- acc + bk_i (x) (X^abar_i - 1) acc over the n steps of a raw
    TRGSW bootstrapping key bk (n, k+1, l, k+1, N) of the key bits, with
    the key's spectra and the rotation tables made once."""

    def __init__(self, bk, l: int, bgbit: int, bits: int):
        n, kp1, _, _, N = bk.shape
        self.l, self.bgbit, self.bits = l, bgbit, bits
        self.spectra = [trgsw_spectrum(bk[i].reshape(kp1 * l, kp1, N), bits)
                        for i in range(n)]
        self.tables = rotation_tables(N, bk.device)

    def __call__(self, acc, abar):
        B, kp1, N = acc.shape
        red = wrap32 if self.bits == 32 else (lambda v: v)
        for i, spec in enumerate(self.spectra):
            x = red(mul_by_xai(abar[:, i], acc, self.tables) - acc)
            d = decompose(x, self.l, self.bgbit, self.bits)
            acc = red(acc + external_product(d.reshape(B, kp1 * self.l, N),
                                             spec, self.bits))
        return acc


def extract(acc, bits: int):
    """TRLWE (B, k+1, N) -> LWE (B, k*N + 1) of coefficient 0."""
    B, kp1, N = acc.shape
    a = acc[:, :-1]
    out = torch.empty_like(a)
    out[..., 0] = a[..., 0]
    out[..., 1:] = -torch.flip(a[..., 1:], dims=(-1,))
    out = out.reshape(B, -1)
    res = torch.cat([out, acc[:, -1, :1]], dim=-1)
    return wrap32(res) if bits == 32 else res


def keyswitch(samples, table, t: int, basebit: int, rows_per_block: int = 16):
    """LWE key switch (lweKeySwitch): (0, b) - sum_ij table[i, j, digit_ij],
    digit 0 skipped.  samples (B, n_in+1) int64 torus32; table (n_in, t,
    base, n_out+1) int32 or int64."""
    n_in = table.shape[0]
    base = 1 << basebit
    a = samples[:, :-1] & MASK32
    prec = 1 << (32 - (1 + basebit * t))
    aibar = (a + prec) & MASK32
    digs = torch.stack([(aibar >> (32 - (j + 1) * basebit)) & (base - 1)
                        for j in range(t)], dim=-1)          # (B, n_in, t)
    flat = table.reshape(n_in * t * base, -1)
    idx = ((torch.arange(n_in, device=a.device)[:, None] * t
            + torch.arange(t, device=a.device)) * base)       # (n_in, t)
    out = torch.empty((samples.shape[0], flat.shape[1]), dtype=torch.int64,
                      device=samples.device)
    for r0 in range(0, samples.shape[0], rows_per_block):
        d = digs[r0:r0 + rows_per_block]
        rows = flat[(idx + d).reshape(d.shape[0], -1)]        # (b, n_in*t, m)
        rows = rows * (d != 0).reshape(d.shape[0], -1, 1).to(rows.dtype)
        out[r0:r0 + rows_per_block] = rows.sum(1, dtype=torch.int64)
    out = -out
    out[:, -1] += samples[:, -1]
    return wrap32(out)


def gate_bootstrap(samples, key, rotation: BlindRotation, ks_t: int,
                   ks_basebit: int, mu: int = 1 << 29):
    """Gate bootstrap (tfhe_bootstrap_FFT): mod switch, blind rotation of the
    test vector [mu]*N, extract, key switch.  samples (B, n+1) int64
    torus32; key {"bk": (n, k+1, l, k+1, N), "ksk": (kN, t, base, n+1)};
    rotation: BlindRotation(key["bk"], ...)."""
    bk = key["bk"]
    kp1, N = bk.shape[1], bk.shape[-1]
    B = samples.shape[0]
    bara = mod_switch(samples[:, :-1], 2 * N)
    barb = mod_switch(samples[:, -1], 2 * N)
    acc = torch.zeros((B, kp1, N), dtype=torch.int64, device=samples.device)
    tv = torch.full((B, 1, N), mu, dtype=torch.int64, device=samples.device)
    acc[:, -1:] = mul_by_xai((2 * N - barb) % (2 * N), tv)
    acc = rotation(acc, bara)
    return keyswitch(extract(acc, 32), key["ksk"], ks_t, ks_basebit)


def priv_keyswitch(ext, table, t: int, basebit: int):
    """Private functional key switch of LWE64 samples (circuitPrivKS):
    -sum_ij table[i, j, digit_ij] mod 2^32, digit 0 skipped.
    ext (B, n2+1) int64; table (n2+1, t, base, k+1, N1) int32.  Returns
    (B, k+1, N1)."""
    n_in, _, base, kp1, N1 = table.shape
    flat = table.reshape(n_in * t * base, kp1 * N1)
    aibar = ext + (1 << (64 - (1 + basebit * t)))
    digs = torch.stack([(aibar >> (64 - (j + 1) * basebit)) & (base - 1)
                        for j in range(t)], dim=-1)          # (B, n_in, t)
    idx = ((torch.arange(n_in, device=ext.device)[:, None] * t
            + torch.arange(t, device=ext.device)) * base)
    out = torch.empty((ext.shape[0], kp1 * N1), dtype=torch.int64,
                      device=ext.device)
    for b in range(ext.shape[0]):
        d = digs[b]
        keep = (d != 0).reshape(-1)
        out[b] = flat[(idx + d).reshape(-1)[keep]].sum(0, dtype=torch.int64)
    return wrap32(-out).reshape(-1, kp1, N1)


def circuit_bootstrap(samples, key, p: dict):
    """Circuit bootstrap (CGGI17, the composition of the program's package:
    test vector * X^(2N2 - bbar), then the +abar steps): LWE32 lvl1 (B,
    n1+1) -> TRGSW32 (B, k+1, ell1, k+1, N1) of bit = [phase in (1/4,
    3/4)].  key {"preks", "bk", "privks"} raw tables; p the configuration's
    numbers."""
    N2 = p["n_lvl2"]
    ell1, bgbit1 = p["ell_lvl1"], p["bgbit_lvl1"]
    x0 = keyswitch(samples, key["preks"], p["ks_len_10"], p["ks_basebit_10"])
    abar = mod_switch(x0[:, :-1], 2 * N2)
    bbar = mod_switch(x0[:, -1], 2 * N2)
    B = samples.shape[0]
    sign = torch.ones(N2, dtype=torch.int64, device=samples.device)
    sign[:N2 // 2] = -1
    rotation = BlindRotation(key["bk"], p["ell_lvl2"], p["bgbit_lvl2"], 64)

    def rotate(w):
        mu2 = 1 << (63 - (w + 1) * bgbit1)
        acc = torch.zeros((B, 2, N2), dtype=torch.int64, device=samples.device)
        acc[:, -1:] = mul_by_xai((2 * N2 - bbar) % (2 * N2),
                                 (sign * mu2).expand(B, 1, N2))
        acc = rotation(acc, abar)
        ext = extract(acc, 64)
        ext[:, -1] += mu2
        return ext

    if p["shared_rotation"]:
        base_ext = rotate(ell1 - 1)
        exts = [base_ext << (bgbit1 * (ell1 - 1 - w)) for w in range(ell1)]
    else:
        exts = [rotate(w) for w in range(ell1)]
    privks = key["privks"]
    kp1 = privks.shape[0]
    out = torch.stack([torch.stack([
        priv_keyswitch(ext, privks[z], p["ks_len_21"], p["ks_basebit_21"])
        for w, ext in enumerate(exts)], dim=1) for z in range(kp1)], dim=1)
    return out                                     # (B, k+1, ell1, k+1, N1)
