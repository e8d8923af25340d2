// fused_cmux_step (v1): one whole 32-bit blind-rotation step,
//   out = acc + sum_l (decompose((X^a - 1) * acc) @ w[l]) << (8 l + key_shift)
// mod 2^32.  a (B,) int32, acc / out (B, k+1, N) int32, w (L = 3,
// (k+1)*l*N, (k+1)*N) int8 (materialize_w's layout).  The same function as
// fused_cmux_step.cu (v2); a different schedule.
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:fused_cmux_step.  Bound by int8
// tensor-core MACs: B * (k+1)^2 * l * N^2 * L multiply-adds per step.  The
// TPU kernel's grid is (batch tile, digit row j = (u', lv), output poly u):
// each cell dots one digit row against one (L, N, N) W block, with the next
// poly's rotation pipelined into ping-pong VMEM digit buffers.  The CUDA
// version keeps that structure: a block owns (128-column tile of output
// poly u, tile of 64 batch rows) and loops over the J = (k+1)*l digit rows;
// for each it builds ONLY row j's digits in shared memory (64 rows x N
// bytes, 64 KB at N=1024; v2 holds all l levels of a poly, l x 64 x N),
// then runs common.cuh's mma.sync GEMM of depth N against the W block
// [j*N .. j*N+N) x [u*N + i0 .. +128) of every limb.  Digits are built four
// coefficients per thread and item straight from acc (X^a * acc read at
// (n - a) mod N with one sign flip per wrap, offset added in uint32); the
// row stride N + 16 bytes keeps the A-fragment loads free of bank
// conflicts.  Each digit row is built once per block, so the rotation is
// recomputed l times per polynomial (once per level) and once per output
// column tile.  No cp.async / TMA pipelining and no wgmma yet.
#include "common.cuh"

namespace {

using namespace tfhe;

constexpr int L = 3, BM = 64, BK = 32, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
fused_cmux_v1_kernel(const int32_t* __restrict__ expo,
                     const int32_t* __restrict__ acc,
                     const int8_t* __restrict__ w, int32_t* __restrict__ out,
                     int B, int kp1, int N, int logN, int l, int bgbit,
                     uint32_t offset, int key_shift) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int sds = N + 16;                       // digit row stride (bytes)
  uint8_t* sD = smem;                           // [BM][sds]: one digit row
  uint32_t* sB = reinterpret_cast<uint32_t*>(smem + (size_t)BM * sds);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * BN, m0 = blockIdx.y * BM, u = blockIdx.z;
  const int UN = kp1 * N, K = kp1 * l * N, c0 = u * N + i0, q4 = N >> 2;
  const uint32_t mask = (1u << bgbit) - 1;
  const int half = 1 << (bgbit - 1);

  int32_t Cr[L][2][4][4];
  zero<L>(Cr);
  for (int j = 0; j < kp1 * l; ++j) {
    const int up = j / l, lv = j - up * l;
    const int sh = 32 - (lv + 1) * bgbit;
    // digits of row j: item = (row, group of 4 coefficients); the previous
    // row's GEMM ended with a barrier, so sD is free
    for (int it = tid; it < BM * q4; it += THREADS) {
      const int q = it % q4, row = it / q4;
      const int b = m0 + row;
      if (b >= B) continue;
      const int av = expo[b] & (2 * N - 1);
      const int r = av & (N - 1);
      const bool flip = (av >> logN) & 1;       // X^N = -1
      const uint32_t* xr =
          reinterpret_cast<const uint32_t*>(acc) + (size_t)b * UN + up * N;
      const int n0 = 4 * q;
      const uint4 o = *reinterpret_cast<const uint4*>(xr + n0);
      const uint32_t ov[4] = {o.x, o.y, o.z, o.w};
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + e;
        const uint32_t v = __ldg(xr + ((n - r) & (N - 1)));
        const bool neg = (n < r) != flip;       // wrapped once: negate
        const uint32_t d = (neg ? 0u - v : v) - ov[e] + offset;
        word |= ((uint32_t)((int)((d >> sh) & mask) - half) & 0xFFu)
                << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(sD + row * sds + n0) = word;
    }
    for (int k0 = 0; k0 < N; k0 += BK) {
      load_w_tiles<L, BK>(sB, w, K, UN, j * N + k0, c0, tid);
      __syncthreads();
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* r0 = sD + (warp_m * 32 + mi * 16 + g) * sds + k0 + 4 * t;
        const uint8_t* r8 = r0 + 8 * sds;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
      }
      mma_chunk<L, BK>(Cr, a, sB, 0, warp_n, lane);
      __syncthreads();
    }
  }
  epilogue<L>(Cr, acc, out, B, UN, m0, c0, key_shift, warp_m, warp_n, lane);
}

}  // namespace

extern "C" int tfhe_fused_cmux_step_v1(const void* a, const void* acc,
                                       const void* w, void* out, int B,
                                       int kp1, int N, int l, int bgbit,
                                       unsigned int offset, int key_shift,
                                       void* stream) {
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  const size_t smem = (size_t)BM * (N + 16)
                      + (size_t)L * BN * SB_WORDS<BK> * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      fused_cmux_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / BN, (B + BM - 1) / BM, kp1);
  fused_cmux_v1_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)acc, (const int8_t*)w, (int32_t*)out,
      B, kp1, N, logN, l, bgbit, offset, key_shift);
  return (int)cudaGetLastError();
}
