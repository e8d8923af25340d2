// Pipelined key staging and the split-reduction epilogue of the mma.sync
// 32-bit kernel ck_cmux_step32.cu.
//
// The key tile of one 32-deep step sits in shared memory transposed (words
// of four consecutive k per column, as mma's B operand wants them) in an
// XOR-swizzled layout without padding (swz), double-buffered so that one
// barrier per step suffices: the buffer a thread writes at step g was last
// read at step g-2, before the barrier of step g-1.  The kernel fills it
// from registers prefetched a step ahead while the MMAs of the step before
// run (faster there than a cp.async ring, PERF.md).
//
// Split reduction: a block that owns only a slice of an output's sum adds
// its recombined uint32 result into the output with red.global.add.u32;
// the launcher first copies acc there on the same stream.  Addition mod
// 2^32 commutes, so every run gives the same bits.
#pragma once

#include "common.cuh"

namespace tfhe {

constexpr int CK_BK = 32;                 // K bytes of one mma.sync step

// The key tile in shared memory: sB[lg][col][k-word], 8 words (32 k) a
// column with no padding, word kw of column n stored at n*8 + (kw ^ swz(n)).
// The XOR swizzle keeps both access patterns free of bank conflicts: a warp
// storing one k-word of 128 columns (each lane 4 columns, visited in an
// order rotated by lane & 3) and the mma B-fragment loads (8 columns x 4
// k-words).
__device__ __forceinline__ int swz(int n) {
  return ((n >> 4) & 7) ^ (((n >> 2) & 1) << 2);
}
template <int LG>
constexpr int SB_TILE = LG * BN * 8;                // words of one key buffer

// The key words of one 32 x 128 tile (per limb group) that a thread of
// virtual id vtid in [0, 256) moves: rows krow + 4kb .. +3, columns
// col .. col + 3, col = c0 + 4nb; a warp's 32 lanes cover one row's 128
// contiguous bytes per load.
struct TileSlot {
  int nb, kb;
  __device__ __forceinline__ explicit TileSlot(int vtid)
      : nb(vtid & 31), kb(vtid >> 5) {}
};

// The fetched blocks, transposed, into the swizzled sB: the word of column
// 4nb + c holds byte c of rows 4kb .. 4kb+3; the four columns are stored
// in the order c = (i + nb) & 3.
template <int LG>
__device__ __forceinline__ void store_block(uint32_t* sB,
                                            const uint32_t (&r)[LG][4],
                                            TileSlot sl) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = (i + sl.nb) & 3, n = 4 * sl.nb + c;
    const uint32_t sel = (uint32_t)c | ((uint32_t)(c + 4) << 4);
    uint32_t* s = sB + n * 8 + (sl.kb ^ swz(n));
#pragma unroll
    for (int lg = 0; lg < LG; ++lg)
      s[lg * BN * 8] = __byte_perm(__byte_perm(r[lg][0], r[lg][1], sel),
                                   __byte_perm(r[lg][2], r[lg][3], sel),
                                   0x5410);
  }
}

// One 32-deep step on the swizzled sB: C[lm] += A x sB[lm] for this warp's
// 32x32 sub-tile.
template <int L>
__device__ __forceinline__ void mma_step(int32_t (&C)[L][2][4][4],
                                         const uint32_t (&a)[2][4],
                                         const uint32_t* sB, int warp_n,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int n = warp_n * 32 + nj * 8 + g, h = swz(n);
    const uint32_t* s = sB + n * 8;
#pragma unroll
    for (int lm = 0; lm < L; ++lm) {
      const uint32_t b[2] = {s[lm * BN * 8 + (t ^ h)],
                             s[lm * BN * 8 + ((t + 4) ^ h)]};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_s8(C[lm][mi][nj], a[mi], b);
    }
  }
}

// A fragments of one 32-deep step from a row-major byte tile (row stride
// stride bytes, k offset k0) for this warp's 32 rows.
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const uint8_t* s,
                                       int stride, int k0, int warp_m,
                                       int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const uint8_t* r0 =
        s + (warp_m * 32 + mi * 16 + (lane >> 2)) * stride + k0 + 4 * (lane & 3);
    const uint8_t* r8 = r0 + 8 * stride;
    a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
    a[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
    a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
    a[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
  }
}

// out += sum_lm C[lm] << (8 lm + shift), mod 2^32, for this warp's
// sub-tile, with one red.global.add.u32 per output word.
template <int L>
__device__ __forceinline__ void epilogue_add(int32_t (&C)[L][2][4][4],
                                             int32_t* out, int B, int UN,
                                             int m0, int c0, int shift,
                                             int warp_m, int warp_n,
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
        uint32_t s0 = 0, s1 = 0;
#pragma unroll
        for (int lm = 0; lm < L; ++lm) {
          const int sh = 8 * lm + shift;
          if (sh < 32) {
            s0 += (uint32_t)C[lm][mi][nj][2 * h] << sh;
            s1 += (uint32_t)C[lm][mi][nj][2 * h + 1] << sh;
          }
        }
        unsigned int* o =
            reinterpret_cast<unsigned int*>(out + (size_t)row * UN + col);
        atomicAdd(o, s0);
        atomicAdd(o + 1, s1);
      }
    }
  }
}

}  // namespace tfhe
