// What the two fused 32-bit steps share: fused_cmux_step.cu (v2, on the
// K-packed key) and fused_cmux_step_v1.cu (on materialize_w's layout) run
// the same function,
//   out = acc + sum_l (decompose((X^a - 1) * acc) @ W_l) << (8 l + key_shift)
// mod 2^32, with int8 wgmma on the digits of a block of 64 batch rows.  Both
// build those digits in shared memory by build_digits, one group of 128
// coefficients of one input polynomial at a time (a range of its levels),
// in the 128-byte-swizzled K-major layout the wgmma descriptors read, and
// store the accumulators by store_out.
#pragma once

#include "wgmma.cuh"

namespace tfhe {
namespace fused {

constexpr int BN = 64;                  // output columns of a warpgroup
constexpr int BK = 128;                 // K bytes of a slice: one swizzled row
constexpr int TILE = 64 * BK;           // one 64-row operand tile, 8 KB
constexpr int MAX_LEVELS = 4;           // levels of one digit build
constexpr int ROWS = 2;                 // rows whose loads are in flight

struct Args {
  const int32_t* expo;
  const int32_t* acc;
  int32_t* out;
  int B, kp1, N, logN, l, bgbit, key_shift, stages, lb;
  uint32_t offset;
};

// The digits of levels lv0 .. lv0 + nl - 1 (nl <= MAX_LEVELS) of group
// (u, t0) for rows [rlo, rhi) of the block: nl swizzled 64 x 128-byte tiles
// at dst, lane covering coefficients n0 = t0 + 4 lane .. + 3.  rot holds the
// rows' exponents mod 2N; xmask the offset's sign bits of every level (see
// below).  ROWS rows at a time, every load first: a row past B reads row
// B - 1 and stores zeros; acc[n0 ..] and the two aligned vectors that hold
// acc[(n0 - r) mod N ..] (a vector never wraps: N is a multiple of 4), from
// which a select network by q = (n0 - r) & 3, the same for the whole warp,
// takes the four rotated coefficients.  Two rows in flight measured faster
// than one, four or eight (PERF.md §6).
__device__ __forceinline__ void build_digits(uint8_t* dst, const Args p,
                                             const int* rot, int b0, int u,
                                             int t0, int lv0, int nl,
                                             int lane, uint32_t xmask,
                                             int rlo, int rhi) {
  const int N = p.N, UN = p.kp1 * N, n0 = t0 + 4 * lane;
  const uint32_t* accu = reinterpret_cast<const uint32_t*>(p.acc) + u * N;
  const int chunk = lane >> 2, within = (lane & 3) * 4;
#pragma unroll 1
  for (int r0 = rlo; r0 < rhi; r0 += ROWS) {
    uint4 xv[ROWS], v0[ROWS], v1[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = r0 + i, b = b0 + row;
      const uint32_t* x = accu + (size_t)(b < p.B ? b : p.B - 1) * UN;
      const int s0 = (n0 - rot[row]) & (N - 1);
      xv[i] = __ldg(reinterpret_cast<const uint4*>(x + n0));
      v0[i] = __ldg(reinterpret_cast<const uint4*>(x + (s0 & ~3)));
      v1[i] = __ldg(reinterpret_cast<const uint4*>(
          x + ((s0 + 4) & (N - 1) & ~3)));
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = r0 + i;
      const bool live = b0 + row < p.B;
      const int av = rot[row], r = av & (N - 1);
      const bool flip = (av >> p.logN) & 1;     // X^N = -1
      const int q = (n0 - r) & 3;
      const uint32_t e[8] = {v0[i].x, v0[i].y, v0[i].z, v0[i].w,
                             v1[i].x, v1[i].y, v1[i].z, v1[i].w};
      uint32_t f[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) f[k] = (q & 1) ? e[k + 1] : e[k];
      const uint32_t xs[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
      uint32_t dv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t y = (q & 2) ? f[k + 2] : f[k];  // acc[(n0+k-r) mod N]
        const bool neg = (n0 + k < r) != flip;  // wrapped once: negate
        // digit lv is ((d >> s) & mask) - half, s = 32 - (lv+1) bgbit: the
        // bgbit-bit field of d ^ (half << s), sign-extended
        dv[k] = ((neg ? 0u - y : y) - xs[k] + p.offset) ^ xmask;
      }
      const int off = row * BK + ((chunk ^ (row & 7)) << 4) + within;
#pragma unroll
      for (int m = 0; m < MAX_LEVELS; ++m) {
        if (m < nl) {
          const int lv = lv0 + m;
          uint32_t w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            w[k] = (uint32_t)((int32_t)(dv[k] << (lv * p.bgbit))
                              >> (32 - p.bgbit));
          const uint32_t word = __byte_perm(
              __byte_perm(w[0], w[1], 0x0040),
              __byte_perm(w[2], w[3], 0x0040), 0x5410);
          *reinterpret_cast<uint32_t*>(dst + m * TILE + off) =
              live ? word : 0u;
        }
      }
    }
  }
}

// The offset's sign bits of every level: half << (32 - (lv + 1) bgbit).
__device__ __forceinline__ uint32_t level_xmask(int l, int bgbit) {
  uint32_t xmask = 0;
  for (int lv = 0; lv < l; ++lv)
    xmask |= (1u << (bgbit - 1)) << (32 - (lv + 1) * bgbit);
  return xmask;
}

// out = acc + sum_lm C_lm << (8 lm + key_shift) mod 2^32 for the 64 x 64
// tile of warp wl's warpgroup at columns cols .. + 63 (rows b0 + 16 wl ..,
// accumulator 4j + e of limb lm at d[32 lm + 4j + e], wgmma's layout).
template <int L>
__device__ __forceinline__ void store_out(const uint32_t (&d)[32 * L],
                                          const Args& p, int b0, int wl,
                                          int lane, int cols) {
  const int UN = p.kp1 * p.N, g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = b0 + 16 * wl + g4 + 8 * h;
    if (b >= p.B) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const size_t off = (size_t)b * UN + cols + 8 * j + 2 * t4;
      const int2 in = *reinterpret_cast<const int2*>(p.acc + off);
      uint32_t s0 = (uint32_t)in.x, s1 = (uint32_t)in.y;
#pragma unroll
      for (int lm = 0; lm < L; ++lm) {
        const int sh = 8 * lm + p.key_shift;
        if (sh < 32) {
          s0 += d[(lm * 8 + j) * 4 + 2 * h] << sh;
          s1 += d[(lm * 8 + j) * 4 + 2 * h + 1] << sh;
        }
      }
      *reinterpret_cast<int2*>(p.out + off) = make_int2((int)s0, (int)s1);
    }
  }
}

}  // namespace fused
}  // namespace tfhe
