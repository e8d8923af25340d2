// The 64-bit digit emitters: gadget digits of (X^a - 1) * acc for a 64-bit
// TRLWE batch, a (B,) int32, acc (B, k+1, N) int64, in two layouts.
//
// rotate_decompose64_ck writes ck_dot64p's chunk layout: out (B, C*P*ckp)
// int8 where digit j = u*l + lv of coefficient n = c*m + s, plane p, sits at
// byte (c*P + p)*ckp + j*m + s of its batch row.  Replaces
// tfhe_tpu/ops/pallas_kernels.py:rotate_decompose64_ck.
//
// rotate_decompose64 writes the plain layout: out (B*(k+1), l*P, N) int8,
// level-major then plane, out[b*(k+1) + u, lv*P + p, n].  Replaces
// tfhe_tpu/ops/pallas_kernels.py:rotate_decompose64 (a test-only layout in
// the JAX package, the reference for the chunk layout).
//
// P = 2 splits each digit into balanced base-2^7 planes
// p0 = ((d + 64) & 127) - 64, p1 = (d - p0) / 128.
//
// Both are bound by bytes: 8 read and l*P written per coefficient.  One block
// per (batch row, polynomial u); the row sits in shared memory (load_row) and
// every coefficient of X^a * x is read directly at (n - a) mod N with one sign
// flip per wrap (rotated_diff), instead of the TPU's log2(2N) bit-gated rolls
// on an (lo, hi) int32 pair.  All torus arithmetic is native uint64_t, where
// wrap-around is defined.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Rot {
  int r;        // a mod N
  bool neg;     // a >= N: X^N = -1
};

// Row b*(k+1) + u of acc into shared memory; the block's rotation.
__device__ __forceinline__ Rot load_row(uint64_t* sx, const int32_t* a,
                                        const uint64_t* acc, int row, int kp1,
                                        int N, int logN) {
  const uint64_t* x = acc + (size_t)row * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) sx[n] = x[n];
  __syncthreads();
  const int av = a[row / kp1] & (2 * N - 1);
  return {av & (N - 1), ((av >> logN) & 1) != 0};
}

// (X^a * x)[n] - x[n] + offset, mod 2^64.
__device__ __forceinline__ uint64_t rotated_diff(const uint64_t* sx, int n,
                                                 Rot rot, int N,
                                                 uint64_t offset) {
  const int src = n - rot.r;
  uint64_t v = src >= 0 ? sx[src] : 0ull - sx[src + N];
  if (rot.neg) v = 0ull - v;
  return v - sx[n] + offset;
}

__device__ __forceinline__ int digit(uint64_t d, int lv, int bgbit) {
  const uint64_t mask = (1ull << bgbit) - 1;
  return (int)((d >> (64 - (lv + 1) * bgbit)) & mask) - (1 << (bgbit - 1));
}

__device__ __forceinline__ int low_plane(int dig) {
  return ((dig + 64) & 127) - 64;
}

__global__ void rotate_decompose64_ck_kernel(
    const int32_t* __restrict__ a, const uint64_t* __restrict__ acc,
    int8_t* __restrict__ out, int kp1, int N, int logN, int l, int bgbit,
    uint64_t offset, int m, int P, int ckp, size_t row_bytes) {
  extern __shared__ uint64_t sx[];               // N words
  const int row = blockIdx.x;                    // b * (k+1) + u
  const int b = row / kp1, u = row - b * kp1;
  const Rot rot = load_row(sx, a, acc, row, kp1, N, logN);
  int8_t* o = out + (size_t)b * row_bytes;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const uint64_t d = rotated_diff(sx, n, rot, N, offset);
    const int c = n / m, s = n - c * m;
    for (int lv = 0; lv < l; ++lv) {
      const int dig = digit(d, lv, bgbit);
      const int col = (u * l + lv) * m + s;
      if (P == 1) {
        o[(size_t)c * ckp + col] = (int8_t)dig;
      } else {
        const int p0 = low_plane(dig);
        o[(size_t)(2 * c) * ckp + col] = (int8_t)p0;
        o[(size_t)(2 * c + 1) * ckp + col] = (int8_t)((dig - p0) / 128);
      }
    }
  }
}

// Four coefficients per thread and item, so every (level, plane) row gets
// one 32-bit store of four digit bytes (N is a multiple of 4).
__global__ void rotate_decompose64_kernel(
    const int32_t* __restrict__ a, const uint64_t* __restrict__ acc,
    int8_t* __restrict__ out, int kp1, int N, int logN, int l, int bgbit,
    uint64_t offset, int P) {
  extern __shared__ uint64_t sx[];               // N words
  const int row = blockIdx.x;                    // b * (k+1) + u
  const Rot rot = load_row(sx, a, acc, row, kp1, N, logN);
  int8_t* o = out + (size_t)row * l * P * N;
  for (int n0 = 4 * threadIdx.x; n0 < N; n0 += 4 * blockDim.x) {
    uint64_t d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = rotated_diff(sx, n0 + e, rot, N, offset);
    for (int lv = 0; lv < l; ++lv) {
      uint32_t w0 = 0, w1 = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dig = digit(d[e], lv, bgbit);
        const int p0 = P == 1 ? dig : low_plane(dig);
        w0 |= ((uint32_t)p0 & 0xFFu) << (8 * e);
        w1 |= ((uint32_t)((dig - p0) / 128) & 0xFFu) << (8 * e);
      }
      int8_t* dst = o + (size_t)lv * P * N + n0;
      *reinterpret_cast<uint32_t*>(dst) = w0;
      if (P == 2) *reinterpret_cast<uint32_t*>(dst + N) = w1;
    }
  }
}

int log2i(int N) {
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  return logN;
}

}  // namespace

extern "C" int tfhe_rotate_decompose64_ck(const void* a, const void* acc,
                                          void* out, int B, int kp1, int N,
                                          int l, int bgbit,
                                          unsigned long long offset, int m,
                                          int P, int ckp, void* stream) {
  const int threads = N < 256 ? N : 256;
  const size_t row_bytes = (size_t)(N / m) * P * ckp;
  rotate_decompose64_ck_kernel<<<B * kp1, threads, N * sizeof(uint64_t),
                                 (cudaStream_t)stream>>>(
      (const int32_t*)a, (const uint64_t*)acc, (int8_t*)out, kp1, N,
      log2i(N), l, bgbit, (uint64_t)offset, m, P, ckp, row_bytes);
  return (int)cudaGetLastError();
}

extern "C" int tfhe_rotate_decompose64(const void* a, const void* acc,
                                       void* out, int B, int kp1, int N,
                                       int l, int bgbit,
                                       unsigned long long offset, int P,
                                       void* stream) {
  const int threads = N / 4 < 256 ? N / 4 : 256;
  rotate_decompose64_kernel<<<B * kp1, threads, N * sizeof(uint64_t),
                              (cudaStream_t)stream>>>(
      (const int32_t*)a, (const uint64_t*)acc, (int8_t*)out, kp1, N,
      log2i(N), l, bgbit, (uint64_t)offset, P);
  return (int)cudaGetLastError();
}
