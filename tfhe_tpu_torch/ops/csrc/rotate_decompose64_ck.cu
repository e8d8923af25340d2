// The 64-bit digit emitters: gadget digits of (X^a - 1) * acc for a 64-bit
// TRLWE batch, a (B,) int32, acc (B, k+1, N) int64, in two layouts.
//
// rotate_decompose64_ck writes ck_dot64p's chunk layout: out (B, C*P*ckp)
// int8 where digit j = u*l + lv of coefficient n = c*m + s, plane p, sits at
// byte (c*P + p)*ckp + j*m + s of its batch row, and the pad columns
// [J*m, ckp) of every (chunk, plane) block are zero.  Replaces
// tfhe_tpu/ops/pallas_kernels.py:rotate_decompose64_ck (and, through the
// flat wrapper, :rotate_decompose64_ck_flat: the port's int64 accumulator
// is already the flat layout byte for byte).
//
// rotate_decompose64 writes the plain layout: out (B*(k+1), l*P, N) int8,
// level-major then plane, out[b*(k+1) + u, lv*P + p, n].  Replaces
// tfhe_tpu/ops/pallas_kernels.py:rotate_decompose64 (a test-only layout in
// the JAX package, the reference for the chunk layout).
//
// P = 2 splits each digit into balanced base-2^7 planes
// p0 = ((d + 64) & 127) - 64, p1 = (d - p0) / 128.
//
// Both are bound by bytes: 8 read and l*P written per coefficient (CB_MXU
// B=256: 8.39 MB read, 5.24 MB written, 0.0041 ms at 3.35 TB/s).  One
// kernel serves both layouts, on rotdec.cuh's design: R rows a block staged
// in shared memory by 16-byte loads, a thread per 16 consecutive
// coefficients of one polynomial, which for m a multiple of 16 lie in one
// chunk, so each of its l*P digit runs is one aligned 16-byte store (in
// either layout); the rotation is read from shared memory as a contiguous
// run with one sign flip at the wrap; m and N enter as shifts; the kernel
// zeroes the chunk layout's pad columns itself, so the wrapper never
// clears the output.  The layouts differ only in where a run goes.  All
// torus arithmetic is native uint64_t, where wrap-around is defined.
#include <cstdint>
#include <cuda_runtime.h>

#include "rotdec.cuh"

namespace {

using namespace tfhe;

// CK: the chunk layout (row_bytes = C*P*ckp a batch row); else the plain
// layout (row_bytes = (k+1)*l*P*N, and logm, ckp and Jm unused).
template <int P, bool CK>
__global__ void __launch_bounds__(RD_MAX_THREADS)
rotate_decompose64_kernel(
    const int32_t* __restrict__ a, const uint64_t* __restrict__ acc,
    int8_t* __restrict__ out, int B, int kp1, int logN, int l, int bgbit,
    uint64_t offset, int logm, int ckp, int Jm, size_t row_bytes) {
  extern __shared__ __align__(16) uint64_t sx[];
  const int N = 1 << logN, m = 1 << logm;
  const int words = kp1 << logN;
  const int b0 = blockIdx.x * blockDim.y;
  rd_stage(sx, acc, b0, B, words);
  const int b = b0 + threadIdx.y;
  if (b >= B) return;
  const uint64_t* s = sx + (size_t)threadIdx.y * rd_row_words(words);
  const RdRot rot = rd_rot(a, b, N, logN);
  int8_t* o = out + (size_t)b * row_bytes;
  // the strides from one level's run to the next, and from plane 0 to 1
  const size_t level = CK ? m : (size_t)P * N, plane = CK ? ckp : N;

  // this block's slice of the row's work items (16 coefficients each)
  const int items = words >> 4, logI = logN - 4;
  const int lo = (int)((long long)blockIdx.y * items / gridDim.y);
  const int hi = (int)((long long)(blockIdx.y + 1) * items / gridDim.y);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int u = i >> logI;
    const int n0 = (i & ((1 << logI) - 1)) << 4;
    uint64_t d[16];
    rd_diffs(d, s, rd_idx(u << logN), n0, rot, N, offset);
    int8_t* dst = CK ? o + (size_t)((n0 >> logm) * P) * ckp + u * l * m +
                           (n0 & (m - 1))
                     : o + (((size_t)u * l * P) << logN) + n0;
    for (int lv = 0; lv < l; ++lv, dst += level) {
      int g[16];
      rd_digits(g, d, lv, bgbit);
      if (P == 1) {
        *reinterpret_cast<uint4*>(dst) = rd_pack(g);
      } else {
        int h[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int p0 = ((g[e] + 64) & 127) - 64;
          h[e] = (g[e] - p0) >> 7;
          g[e] = p0;
        }
        *reinterpret_cast<uint4*>(dst) = rd_pack(g);
        *reinterpret_cast<uint4*>(dst + plane) = rd_pack(h);
      }
    }
  }

  // the pad columns [J*m, ckp) of each (chunk, plane) block, split over
  // the row's blocks by block
  if (!CK) return;
  const int pads = (ckp - Jm) >> 4;
  for (int cp = blockIdx.y; pads && cp < (N >> logm) * P; cp += gridDim.y)
    for (int w = threadIdx.x; w < pads; w += blockDim.x)
      *reinterpret_cast<uint4*>(o + (size_t)cp * ckp + Jm + 16 * w) =
          make_uint4(0, 0, 0, 0);
}

int log2i(int N) {
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  return logN;
}

// Launch the kernel of one layout; row_bytes as the kernel takes it.
template <bool CK>
int launch(const void* a, const void* acc, void* out, int B, int kp1, int N,
           int l, int bgbit, unsigned long long offset, int m, int P,
           int ckp, int rows, int split, int threads, size_t row_bytes,
           void* stream) {
  const int logN = log2i(N), logm = log2i(m);
  dim3 grid, block;
  size_t smem;
  if ((1 << logN) != N || (1 << logm) != m || m % 16 != 0 || N % m != 0 ||
      (P != 1 && P != 2) ||
      !rd_launch_shape(B, kp1 * N, sizeof(uint64_t), rows, split, threads,
                       &grid, &block, &smem))
    return (int)cudaErrorInvalidValue;
  auto kernel = P == 1 ? rotate_decompose64_kernel<1, CK>
                       : rotate_decompose64_kernel<2, CK>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const uint64_t*)acc, (int8_t*)out, B, kp1, logN, l,
      bgbit, (uint64_t)offset, logm, ckp, kp1 * l * m, row_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// rows, split, threads: the plan (kernels.rotdec_plan), R batch rows a
// block, S blocks a row, threads a row in a block.
extern "C" int tfhe_rotate_decompose64_ck(const void* a, const void* acc,
                                          void* out, int B, int kp1, int N,
                                          int l, int bgbit,
                                          unsigned long long offset, int m,
                                          int P, int ckp, int rows, int split,
                                          int threads, void* stream) {
  if (ckp % 16 != 0 || ckp < kp1 * l * m)
    return (int)cudaErrorInvalidValue;
  return launch<true>(a, acc, out, B, kp1, N, l, bgbit, offset, m, P, ckp,
                      rows, split, threads, (size_t)(N / m) * P * ckp,
                      stream);
}

// The plain layout, at the same plan; m = 16 only passes the domain check.
extern "C" int tfhe_rotate_decompose64(const void* a, const void* acc,
                                       void* out, int B, int kp1, int N,
                                       int l, int bgbit,
                                       unsigned long long offset, int P,
                                       int rows, int split, int threads,
                                       void* stream) {
  return launch<false>(a, acc, out, B, kp1, N, l, bgbit, offset, 16, P, 0,
                       rows, split, threads, (size_t)kp1 * l * P * N, stream);
}
