// mm_recombine_acc: out = acc_in + sum_l (x @ w[l]) << (8 l + shift_base),
// mod 2^32.  x (B, K) int8, w (L, K, UN) int8, acc_in / out (B, UN) int32.
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:mm_recombine_acc.  Bound by the
// int8 tensor-core rate at large B, by the W stream (L*K*UN bytes) at small
// B.  A plain tiled mma.sync GEMM (common.cuh): every 64x128 output tile
// keeps all L limb accumulators in registers while K streams through
// shared memory, so the limb recombination and the accumulator add happen
// once, in the epilogue, and no (B, L, UN) int32 partial reaches memory.
// No cp.async / TMA pipelining and no wgmma yet.
#include "common.cuh"

namespace {

using namespace tfhe;

constexpr int BM = 64, BK = 32, THREADS = 8 * BK;
constexpr int SA_STRIDE = BK + 16;   // bytes; 12 words keeps A loads conflict-free

template <int L>
__global__ void __launch_bounds__(THREADS)
mm_recombine_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const int32_t* __restrict__ acc, int32_t* __restrict__ out,
                    int B, int K, int UN, int shift) {
  __shared__ __align__(16) uint8_t sA[BM * SA_STRIDE];
  __shared__ uint32_t sB[L * BN * SB_WORDS<BK>];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int m0 = blockIdx.y * BM, c0 = blockIdx.x * BN;

  int32_t C[L][2][4][4];
  zero<L>(C);
  for (int k0 = 0; k0 < K; k0 += BK) {
    if (tid < 2 * BM) {
      const int row = tid >> 1, part = tid & 1;
      const int b = m0 + row;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (b < B)
        val = *reinterpret_cast<const uint4*>(x + (size_t)b * K + k0 + 16 * part);
      *reinterpret_cast<uint4*>(sA + row * SA_STRIDE + 16 * part) = val;
    }
    load_w_tiles<L, BK>(sB, w, K, UN, k0, c0, tid);
    __syncthreads();
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint8_t* r0 =
          sA + (warp_m * 32 + mi * 16 + (lane >> 2)) * SA_STRIDE + 4 * (lane & 3);
      const uint8_t* r8 = r0 + 8 * SA_STRIDE;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
    }
    mma_chunk<L, BK>(C, a, sB, 0, warp_n, lane);
    __syncthreads();
  }
  epilogue<L>(C, acc, out, B, UN, m0, c0, shift, warp_m, warp_n, lane);
}

template <int L>
int launch(const void* x, const void* w, const void* acc, void* out, int B,
           int K, int UN, int shift, cudaStream_t stream) {
  const dim3 grid(UN / BN, (B + BM - 1) / BM);
  mm_recombine_kernel<L><<<grid, THREADS, 0, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const int32_t*)acc, (int32_t*)out,
      B, K, UN, shift);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_mm_recombine_acc(const void* x, const void* w,
                                     const void* acc, void* out, int B, int K,
                                     int UN, int L, int shift, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 1: return launch<1>(x, w, acc, out, B, K, UN, shift, s);
    case 2: return launch<2>(x, w, acc, out, B, K, UN, shift, s);
    case 3: return launch<3>(x, w, acc, out, B, K, UN, shift, s);
    case 4: return launch<4>(x, w, acc, out, B, K, UN, shift, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
