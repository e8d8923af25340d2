// rotate_decompose: gadget digits of (X^a - 1) * acc for a 32-bit TRLWE
// batch.  a (B,) int32, acc (B, k+1, N) int32 -> out (B, (k+1)*l, N) int8,
// row-major over (polynomial, level), i.e. decompose_tlwe of
// mul_by_xai_minus_one.
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:rotate_decompose.  Bound by
// bytes: it reads 4 bytes and writes l bytes per coefficient (GATE_DEFAULT
// B=256: 2.10 MB read, 1.57 MB written, 0.0011 ms at 3.35 TB/s, below the
// card's launch floor).  The design is rotdec.cuh's, shared with the 64-bit
// chunk-layout emitter: R rows a block staged in shared memory by 16-byte
// loads (R > 1 where a row's (k+1)*N/16 work items are fewer than a block
// of threads and the grid still covers half the SMs), a thread per 16
// consecutive coefficients of one polynomial writing each of its l digit
// runs with one 16-byte store (a warp's stores cover contiguous 512 bytes
// of a level's row), the rotation read from shared memory as a contiguous
// run with one sign flip at the wrap, N entering as a shift.  The torus
// subtract and offset add run in uint32 (wrap-around is defined).
#include <cstdint>
#include <cuda_runtime.h>

#include "rotdec.cuh"

namespace {

using namespace tfhe;

__global__ void __launch_bounds__(RD_MAX_THREADS)
rotate_decompose_kernel(const int32_t* __restrict__ a,
                        const uint32_t* __restrict__ acc,
                        int8_t* __restrict__ out, int B, int kp1, int logN,
                        int l, int bgbit, uint32_t offset) {
  extern __shared__ __align__(16) uint32_t sx[];
  const int N = 1 << logN;
  const int words = kp1 << logN;
  const int b0 = blockIdx.x * blockDim.y;
  rd_stage(sx, acc, b0, B, words);
  const int b = b0 + threadIdx.y;
  if (b >= B) return;
  const uint32_t* s = sx + (size_t)threadIdx.y * rd_row_words(words);
  const RdRot rot = rd_rot(a, b, N, logN);
  int8_t* o = out + (size_t)b * l * words;

  const int items = words >> 4, logI = logN - 4;
  const int lo = (int)((long long)blockIdx.y * items / gridDim.y);
  const int hi = (int)((long long)(blockIdx.y + 1) * items / gridDim.y);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int u = i >> logI;
    const int n0 = (i & ((1 << logI) - 1)) << 4;
    uint32_t d[16];
    rd_diffs(d, s, rd_idx(u << logN), n0, rot, N, offset);
    int8_t* dst = o + ((size_t)(u * l) << logN) + n0;
    for (int lv = 0; lv < l; ++lv, dst += N) {
      int g[16];
      rd_digits(g, d, lv, bgbit);
      *reinterpret_cast<uint4*>(dst) = rd_pack(g);
    }
  }
}

}  // namespace

// rows, split, threads: the plan (kernels.rotdec_plan).
extern "C" int tfhe_rotate_decompose(const void* a, const void* acc, void* out,
                                     int B, int kp1, int N, int l, int bgbit,
                                     unsigned int offset, int rows, int split,
                                     int threads, void* stream) {
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  dim3 grid, block;
  size_t smem;
  if ((1 << logN) != N || N % 16 != 0 ||
      !rd_launch_shape(B, kp1 * N, sizeof(uint32_t), rows, split, threads,
                       &grid, &block, &smem))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rotate_decompose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rotate_decompose_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const uint32_t*)acc, (int8_t*)out, B, kp1, logN, l,
      bgbit, (uint32_t)offset);
  return (int)cudaGetLastError();
}
