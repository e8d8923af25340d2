// Pieces of the int8 mma.sync GEMM of ck_cmux_step32.cu (with
// pipeline.cuh).
//
// Block tile: BM rows x BN=128 output columns, K consumed BK at a time, with
// THREADS = 8*BK threads = BM/32 x 4 warps; each warp owns a 32x32 output
// tile = 2 x 4 mma.sync.m16n8k32 tiles per key limb.  The kernels use
// (BM, BK, THREADS) = (64, 32, 256) or (128, 64, 512).  The key operand W
// arrives row-major (K, U*N) and is transposed on its way into shared
// memory (pipeline.cuh), since mma's B operand wants K-contiguous columns.
//
// All sums are exact: one limb's int32 dot is bounded by K * 64 * 128 <
// 2^31 for K <= 2^18, and the limb recombination runs in uint32, where
// wrap-around is the torus arithmetic (signed overflow would be undefined).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tfhe {

constexpr int BN = 128;

__device__ __forceinline__ void mma_s8(int32_t c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
