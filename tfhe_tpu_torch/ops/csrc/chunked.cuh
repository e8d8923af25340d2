// Shared pieces of the mma.sync chunked-key kernels on wm (ck_dot64p_sacc.cu,
// ck_cmux_step64.cu; pipeline.cuh takes its tile constants): the key-window
// tile loader and the window pass over digits in ck_dot64p's chunk layout.
// ck_dot64p.cu and ck_dot64p_acc.cu run the same windows on the K-packed key
// with wgmma (ck_wgmma.cuh).
//
// A block owns a tile of FOLDED output columns [i0, i0 + 128) of one
// polynomial.  Chunk c of the digits adds key columns q = i - c*m (needed
// for c*m <= i) and subtracts q = N + i - c*m (needed for c*m + m > i,
// X^N = -1); key columns outside [0, N+m) load as zero, which masks the
// partial windows at the edges exactly.  A tile so runs C + 1 chunk
// products of depth J*m when m is a multiple of 128 (C + 2 otherwise), and
// the TPU kernels' 2N ring never exists.
#pragma once

#include "common.cuh"

namespace tfhe {

constexpr int CK_BM = 64, CK_BK = 32;
constexpr int CK_SA_STRIDE = CK_BK + 16;  // bytes; 12 words keeps A loads conflict-free

// wm rows [krow, krow+32) x columns [q0, q0+128) of LG consecutive limb
// groups -> sB[lg][col][k] (words of four consecutive k); a 4-column group
// outside [0, npm) reads as zero (q0, npm and the groups are multiples of 4).
// One 4x4 byte block per virtual thread vtid in [0, 256): a block of fewer
// threads calls it again with vtid + blockDim.x.
template <int LG>
__device__ __forceinline__ void load_wm_tiles(uint32_t* sB, const int8_t* w,
                                              size_t gstride, int npm,
                                              int krow, int q0, int vtid) {
  const int lane = vtid & 31, warp = vtid >> 5;
  const int nb = (warp & 3) * 8 + (lane & 7);   // columns q0 + 4nb .. +3
  const int kb = (warp >> 2) * 4 + (lane >> 3); // rows krow + 4kb .. +3
  const int col = q0 + 4 * nb;
  const bool inside = col >= 0 && col < npm;
  constexpr int S = SB_WORDS<CK_BK>;
#pragma unroll
  for (int lg = 0; lg < LG; ++lg) {
    uint32_t r0 = 0, r1 = 0, r2 = 0, r3 = 0;
    if (inside) {
      const int8_t* p = w + lg * gstride + (size_t)(krow + 4 * kb) * npm + col;
      r0 = *reinterpret_cast<const uint32_t*>(p);
      r1 = *reinterpret_cast<const uint32_t*>(p + npm);
      r2 = *reinterpret_cast<const uint32_t*>(p + 2 * npm);
      r3 = *reinterpret_cast<const uint32_t*>(p + 3 * npm);
    }
    const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
    const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
    const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
    const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
    uint32_t* s = sB + (lg * BN + 4 * nb) * S + kb;
    s[0 * S] = __byte_perm(lo01, lo23, 0x5410);
    s[1 * S] = __byte_perm(lo01, lo23, 0x7632);
    s[2 * S] = __byte_perm(hi01, hi23, 0x5410);
    s[3 * S] = __byte_perm(hi01, hi23, 0x7632);
  }
}

// acc[lg] += sum over chunks c in [c_begin, c_end) of
//   x[b, (c*P + p)*ckp : +Jm] . w[lg][:, qbase - c*m + (0 .. 128)]
// for the block's 64 x 128 tile (rows m0..), 256 threads: the digits of
// plane p stream from device memory 32 deep at a time beside the key tile.
// Ends with a barrier, so the caller may reuse sA and sB.
template <int LG>
__device__ __forceinline__ void ck_window_pass(
    int32_t (&acc)[LG][2][4][4], uint8_t* sA, uint32_t* sB, const int8_t* x,
    size_t xrow, const int8_t* w, size_t gstride, int npm, int B, int m0,
    int Jm, int m, int P, int p, int ckp, int c_begin, int c_end, int qbase,
    int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  for (int c = c_begin; c < c_end; ++c) {
    const int q0 = qbase - c * m;
    const int8_t* xc = x + (size_t)(c * P + p) * ckp;
    for (int k0 = 0; k0 < Jm; k0 += CK_BK) {
      if (tid < 2 * CK_BM) {
        const int row = tid >> 1, part = tid & 1;
        const int b = m0 + row;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (b < B)
          val = *reinterpret_cast<const uint4*>(xc + b * xrow + k0 +
                                                16 * part);
        *reinterpret_cast<uint4*>(sA + row * CK_SA_STRIDE + 16 * part) = val;
      }
      load_wm_tiles<LG>(sB, w, gstride, npm, k0, q0, tid);
      __syncthreads();
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* r0 = sA + (warp_m * 32 + mi * 16 + (lane >> 2)) *
                                     CK_SA_STRIDE + 4 * (lane & 3);
        const uint8_t* r8 = r0 + 8 * CK_SA_STRIDE;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
      }
      mma_chunk<LG, CK_BK>(acc, a, sB, 0, warp_n, lane);
      __syncthreads();
    }
  }
}

}  // namespace tfhe
