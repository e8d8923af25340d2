// rotate_decompose: gadget digits of (X^a - 1) * acc for a 32-bit TRLWE
// batch.  a (B,) int32, acc (B, k+1, N) int32 -> out (B, (k+1)*l, N) int8,
// row-major over (polynomial, level), i.e. decompose_tlwe of
// mul_by_xai_minus_one.
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:rotate_decompose.  Bound by
// bytes: it reads 4 bytes and writes l bytes per coefficient.  One block
// per polynomial row; the row is read into shared memory once and every
// coefficient of X^a * x is computed directly (a' = a mod N, sign flipped
// once per wrap) instead of the TPU's chain of log2(2N) bit-gated rolls.
// The torus subtract and offset add run in uint32 (wrap-around is defined).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void rotate_decompose_kernel(const int32_t* __restrict__ a,
                                        const int32_t* __restrict__ acc,
                                        int8_t* __restrict__ out, int kp1,
                                        int N, int logN, int l, int bgbit,
                                        uint32_t offset) {
  extern __shared__ uint32_t sx[];               // N words
  const int row = blockIdx.x;                    // b * (k+1) + u
  const uint32_t* x = reinterpret_cast<const uint32_t*>(acc) + (size_t)row * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) sx[n] = x[n];
  __syncthreads();

  const int av = a[row / kp1] & (2 * N - 1);
  const int r = av & (N - 1);
  const bool neg = (av >> logN) & 1;             // X^N = -1
  const uint32_t mask = (1u << bgbit) - 1;
  const int half = 1 << (bgbit - 1);
  int8_t* o = out + (size_t)row * l * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int src = n - r;
    uint32_t v = src >= 0 ? sx[src] : 0u - sx[src + N];
    if (neg) v = 0u - v;
    const uint32_t d = v - sx[n] + offset;
    for (int lv = 0; lv < l; ++lv)
      o[lv * N + n] =
          (int8_t)((int)((d >> (32 - (lv + 1) * bgbit)) & mask) - half);
  }
}

}  // namespace

extern "C" int tfhe_rotate_decompose(const void* a, const void* acc, void* out,
                                     int B, int kp1, int N, int l, int bgbit,
                                     unsigned int offset, void* stream) {
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  const int threads = N < 256 ? N : 256;
  rotate_decompose_kernel<<<B * kp1, threads, N * sizeof(uint32_t),
                            (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)acc, (int8_t*)out, kp1, N, logN, l,
      bgbit, (uint32_t)offset);
  return (int)cudaGetLastError();
}
