// materialize_w: the int8 negacyclic Toeplitz key of one CMux step,
//   W[l, j*N + t, u*N + i] = v[l, j, u, (i - t) mod 2N],
// from the O(N) doubled-limb vectors v (L, J, U, 2N); and its second entry,
// materialize_wt, the same key K-packed (transposed) for fused_cmux_step.cu,
//   Wt[l, u*N + i, j*N + t] = v[l, j, u, (i - t) mod 2N].
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:materialize_w.  Pure store
// bandwidth: it reads L*J*U*2N bytes and writes L*J*U*N*N.  One block per
// (l, j, u) vector and 64-row band of t: the vector sits in shared memory,
// rotated by N so that the 16 output bytes of a thread are the contiguous
// run sv[i0 - t + N .. +15]; each thread packs them and issues one 16-byte
// store, and neighbouring threads write neighbouring 16-byte chunks of a row.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void materialize_w_kernel(const int8_t* __restrict__ v,
                                     int8_t* __restrict__ w, int J, int U,
                                     int N, int rows) {
  extern __shared__ __align__(16) int8_t sv[];   // 2N bytes
  const int y = blockIdx.y;                      // (l, j, u) flat
  const int u = y % U, j = (y / U) % J, l = y / (U * J);
  const int8_t* vrow = v + (size_t)y * 2 * N;
  for (int m = threadIdx.x; m < 2 * N; m += blockDim.x)
    sv[m] = vrow[(m + N) & (2 * N - 1)];         // sv[m] = v[(m - N) mod 2N]
  __syncthreads();

  const int vecs = N / 16;
  const int t0 = blockIdx.x * rows;
  const size_t UN = (size_t)U * N;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += blockDim.x) {
    const int t = t0 + idx / vecs;
    const int i0 = (idx % vecs) * 16;
    const int8_t* p = sv + i0 - t + N;           // in [1, 2N - 16]
    uint32_t wd[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wd[q] = (uint32_t)(uint8_t)p[4 * q]
              | (uint32_t)(uint8_t)p[4 * q + 1] << 8
              | (uint32_t)(uint8_t)p[4 * q + 2] << 16
              | (uint32_t)(uint8_t)p[4 * q + 3] << 24;
    int8_t* dst = w + ((size_t)l * J * N + (size_t)j * N + t) * UN
                  + (size_t)u * N + i0;
    *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

// Wt: a row (l, u, i) over t, for fixed j, is a reversed run of v.  The
// block keeps sr[m] = v[(N - m) mod 2N] (plus 16 zero bytes), so that bytes
// t0 .. t0 + 15 of row i are sr[t0 - i + N ..], and builds each 16-byte
// store from five aligned words with byte_perm.
__global__ void materialize_wt_kernel(const int8_t* __restrict__ v,
                                      int8_t* __restrict__ wt, int J, int U,
                                      int N, int rows) {
  extern __shared__ __align__(16) uint8_t sr[];  // 2N + 16 bytes
  const int y = blockIdx.y;                      // (l, j, u) flat
  const int u = y % U, j = (y / U) % J, l = y / (U * J);
  const int8_t* vrow = v + (size_t)y * 2 * N;
  for (int m = threadIdx.x; m < 2 * N + 16; m += blockDim.x)
    sr[m] = m < 2 * N ? (uint8_t)vrow[(N - m) & (2 * N - 1)] : 0;
  __syncthreads();

  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sr);
  const int vecs = N / 16;
  const int i0 = blockIdx.x * rows;
  const size_t JN = (size_t)J * N;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += blockDim.x) {
    const int i = i0 + idx / vecs;
    const int t0 = (idx % vecs) * 16;
    const int off = t0 - i + N;                  // in [1, 2N - 16]
    const int w0 = off >> 2;
    const uint32_t sel = 0x3210 + 0x1111 * (off & 3);
    uint32_t a[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) a[q] = sw[w0 + q];
    int8_t* dst = wt + ((size_t)(l * U + u) * N + i) * JN + (size_t)j * N + t0;
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        __byte_perm(a[0], a[1], sel), __byte_perm(a[1], a[2], sel),
        __byte_perm(a[2], a[3], sel), __byte_perm(a[3], a[4], sel));
  }
}

}  // namespace

extern "C" int tfhe_materialize_w(const void* v, void* w, int L, int J, int U,
                                  int N, void* stream) {
  const int rows = N < 64 ? N : 64;
  const dim3 grid(N / rows, L * J * U);
  materialize_w_kernel<<<grid, 256, 2 * N, (cudaStream_t)stream>>>(
      (const int8_t*)v, (int8_t*)w, J, U, N, rows);
  return (int)cudaGetLastError();
}

extern "C" int tfhe_materialize_wt(const void* v, void* wt, int L, int J,
                                   int U, int N, void* stream) {
  const int rows = N < 64 ? N : 64;
  const dim3 grid(N / rows, L * J * U);
  materialize_wt_kernel<<<grid, 256, 2 * N + 16, (cudaStream_t)stream>>>(
      (const int8_t*)v, (int8_t*)wt, J, U, N, rows);
  return (int)cudaGetLastError();
}
