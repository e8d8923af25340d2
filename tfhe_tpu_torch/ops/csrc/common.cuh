// Shared pieces of the int8 mma.sync GEMM used by mm_recombine_acc.cu,
// ck_cmux_step32.cu (both through pipeline.cuh) and fused_cmux_step_v1.cu.
//
// Block tile: BM rows x BN=128 output columns, K consumed BK at a time, with
// THREADS = 8*BK threads = BM/32 x 4 warps; each warp owns a 32x32 output
// tile = 2 x 4 mma.sync.m16n8k32 tiles per key limb.  The kernels use
// (BM, BK, THREADS) = (64, 32, 256) or (128, 64, 512).
//
// The key operand W arrives row-major (K, U*N): K-contiguous columns are
// what mma's B operand needs, so each BKx128 W tile is transposed on its way
// into shared memory: every thread reads one 4x4 byte block (four 32-bit
// loads, one per K row) and transposes it in registers with __byte_perm.
//
// All sums are exact: one limb's int32 dot is bounded by K * 64 * 128 <
// 2^31 for K <= 2^18, and the limb recombination runs in uint32, where
// wrap-around is the torus arithmetic (signed overflow would be undefined).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tfhe {

constexpr int BN = 128;

// sB row stride in 32-bit words (9 or 17, odd) keeps both the transposed
// stores and the fragment loads spread over the shared-memory banks.
template <int BK>
constexpr int SB_WORDS = BK / 4 + 1;

__device__ __forceinline__ void mma_s8(int32_t c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// W[lm][krow:krow+BK, c0:c0+128] for every limb -> sB[lm][col][k] (words
// of four consecutive k), one 4x4 byte block per thread of 8*BK threads.
// w is (L, K, UN) int8 row-major.
template <int L, int BK>
__device__ __forceinline__ void load_w_tiles(uint32_t* sB, const int8_t* w,
                                             int K, int UN, int krow, int c0,
                                             int tid) {
  if (tid >= 8 * BK) return;
  const int lane = tid & 31, warp = tid >> 5;
  const int nb = (warp & 3) * 8 + (lane & 7);   // columns c0 + 4nb .. +3
  const int kb = (warp >> 2) * 4 + (lane >> 3); // rows krow + 4kb .. +3
#pragma unroll
  for (int lm = 0; lm < L; ++lm) {
    const int8_t* p = w + (size_t)lm * K * UN + (size_t)(krow + 4 * kb) * UN
                      + c0 + 4 * nb;
    const uint32_t r0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t r1 = *reinterpret_cast<const uint32_t*>(p + UN);
    const uint32_t r2 = *reinterpret_cast<const uint32_t*>(p + 2 * UN);
    const uint32_t r3 = *reinterpret_cast<const uint32_t*>(p + 3 * UN);
    const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
    const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
    const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
    const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
    constexpr int S = SB_WORDS<BK>;
    uint32_t* s = sB + (lm * BN + 4 * nb) * S + kb;
    s[0 * S] = __byte_perm(lo01, lo23, 0x5410);
    s[1 * S] = __byte_perm(lo01, lo23, 0x7632);
    s[2 * S] = __byte_perm(hi01, hi23, 0x5410);
    s[3 * S] = __byte_perm(hi01, hi23, 0x7632);
  }
}

// One K=32 step at K word kw of the sB tile: C[lm] += A x sB[lm] for this
// warp's 32x32 sub-tile.  a holds the warp's A fragments (rows
// warp_m*32 + mi*16 + g and + 8, K words t and t + 4 of the step); each
// kernel loads them from its own layout.
template <int L, int BK>
__device__ __forceinline__ void mma_chunk(int32_t (&C)[L][2][4][4],
                                          const uint32_t (&a)[2][4],
                                          const uint32_t* sB, int kw,
                                          int warp_n, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int lm = 0; lm < L; ++lm) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const uint32_t* s =
          sB + (lm * BN + warp_n * 32 + nj * 8 + g) * SB_WORDS<BK> + kw;
      const uint32_t b[2] = {s[t], s[4 + t]};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_s8(C[lm][mi][nj], a[mi], b);
    }
  }
}

// out = acc + sum_lm C[lm] << (8 lm + shift), mod 2^32, for this warp's
// sub-tile.  acc and out are (B, UN) int32 row-major.
template <int L>
__device__ __forceinline__ void epilogue(int32_t (&C)[L][2][4][4],
                                         const int32_t* acc, int32_t* out,
                                         int B, int UN, int m0, int c0,
                                         int shift, int warp_m, int warp_n,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp_m * 32 + mi * 16 + g + 8 * h;
      if (row >= B) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = c0 + warp_n * 32 + nj * 8 + 2 * t;
        const size_t off = (size_t)row * UN + col;
        const int2 in = *reinterpret_cast<const int2*>(acc + off);
        uint32_t s0 = (uint32_t)in.x, s1 = (uint32_t)in.y;
#pragma unroll
        for (int lm = 0; lm < L; ++lm) {
          const int sh = 8 * lm + shift;
          if (sh < 32) {
            s0 += (uint32_t)C[lm][mi][nj][2 * h] << sh;
            s1 += (uint32_t)C[lm][mi][nj][2 * h + 1] << sh;
          }
        }
        *reinterpret_cast<int2*>(out + off) = make_int2((int)s0, (int)s1);
      }
    }
  }
}

template <int L>
__device__ __forceinline__ void zero(int32_t (&C)[L][2][4][4]) {
#pragma unroll
  for (int lm = 0; lm < L; ++lm)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) C[lm][mi][nj][e] = 0;
}

}  // namespace tfhe
