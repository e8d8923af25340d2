// rotate_decompose64_ck: gadget digits of (X^a - 1) * acc for a 64-bit TRLWE
// batch, written straight into ck_dot64p's chunk layout.
// a (B,) int32, acc (B, k+1, N) int64 -> out (B, C*P*ckp) int8 where digit
// j = u*l + lv of coefficient n = c*m + s, plane p, sits at byte
// (c*P + p)*ckp + j*m + s of its batch row.  P = 2 splits each digit into
// balanced base-2^7 planes p0 = ((d + 64) & 127) - 64, p1 = (d - p0) / 128.
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:rotate_decompose64_ck.  Bound by
// bytes: 8 read and l*P written per coefficient.  One block per (batch row,
// polynomial u); the row sits in shared memory and every coefficient of
// X^a * x is read directly at (n - a) mod N with one sign flip per wrap,
// instead of the TPU's log2(2N) bit-gated rolls on an (lo, hi) int32 pair.
// All torus arithmetic is native uint64_t, where wrap-around is defined.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void rotate_decompose64_ck_kernel(
    const int32_t* __restrict__ a, const uint64_t* __restrict__ acc,
    int8_t* __restrict__ out, int kp1, int N, int logN, int l, int bgbit,
    uint64_t offset, int m, int P, int ckp, size_t row_bytes) {
  extern __shared__ uint64_t sx[];               // N words
  const int row = blockIdx.x;                    // b * (k+1) + u
  const int b = row / kp1, u = row - b * kp1;
  const uint64_t* x = acc + (size_t)row * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) sx[n] = x[n];
  __syncthreads();

  const int av = a[b] & (2 * N - 1);
  const int r = av & (N - 1);
  const bool neg = (av >> logN) & 1;            // X^N = -1
  const uint64_t mask = (1ull << bgbit) - 1;
  const int half = 1 << (bgbit - 1);
  int8_t* o = out + (size_t)b * row_bytes;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int src = n - r;
    uint64_t v = src >= 0 ? sx[src] : 0ull - sx[src + N];
    if (neg) v = 0ull - v;
    const uint64_t d = v - sx[n] + offset;
    const int c = n / m, s = n - c * m;
    for (int lv = 0; lv < l; ++lv) {
      const int dig = (int)((d >> (64 - (lv + 1) * bgbit)) & mask) - half;
      const int col = (u * l + lv) * m + s;
      if (P == 1) {
        o[(size_t)c * ckp + col] = (int8_t)dig;
      } else {
        const int p0 = ((dig + 64) & 127) - 64;
        o[(size_t)(2 * c) * ckp + col] = (int8_t)p0;
        o[(size_t)(2 * c + 1) * ckp + col] = (int8_t)((dig - p0) / 128);
      }
    }
  }
}

}  // namespace

extern "C" int tfhe_rotate_decompose64_ck(const void* a, const void* acc,
                                          void* out, int B, int kp1, int N,
                                          int l, int bgbit,
                                          unsigned long long offset, int m,
                                          int P, int ckp, void* stream) {
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  const int threads = N < 256 ? N : 256;
  const size_t row_bytes = (size_t)(N / m) * P * ckp;
  rotate_decompose64_ck_kernel<<<B * kp1, threads, N * sizeof(uint64_t),
                                 (cudaStream_t)stream>>>(
      (const int32_t*)a, (const uint64_t*)acc, (int8_t*)out, kp1, N, logN, l,
      bgbit, (uint64_t)offset, m, P, ckp, row_bytes);
  return (int)cudaGetLastError();
}
