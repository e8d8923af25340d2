// ck_dot64p_sacc: ck_dot64p_acc's function with the limb axis in the grid.
// x (B, C*P*ckp) int8 (rotate_decompose64_ck's chunk layout), wm (kp1*L, Jm,
// N+m) int8 (ChunkedEngine.prepare), acc / out (B, kp1*N) int64 (the native
// (B, k+1, N) Torus64 accumulator, the same bytes):
//
//   out[b, u*N + i] = acc[b, u*N + i]
//                     + sum_l fold(x . wm[u*L + l])[b, i] << (8 l + key_shift)
//
// mod 2^64, fold as in ck_dot64p.cu (planes combined with << 7p).
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:ck_dot64p_sacc.  Bound by int8
// tensor-core MACs, as ck_dot64p.  On the TPU the limb axis is an
// "arbitrary" grid dimension and the 64-bit sum is carried in VMEM scratch
// from one limb cell to the next; blocks on the GPU carry nothing between
// them.  Here one block owns one (row tile, 128-column tile, polynomial u,
// limb l) cell, runs ck_dot64p.cu's chunk windows for that limb alone
// (chunked.cuh, one key tile per K step), keeps its (plane, sign) passes as
// (int64) pass << (8 l + key_shift + 7 p) in uint64 registers, and adds the
// result into out with 64-bit atomicAdd.  The entry point first copies acc
// into out on the same stream.  Integer addition mod 2^64 commutes, so the
// result is bit-identical whatever order the L blocks of an output land in
// (a cluster of the L limb blocks reducing through distributed shared
// memory would also be deterministic, but needs L <= 8 blocks co-scheduled
// and a second code path; the atomics need neither).  The grid is L times
// ck_dot64p_acc's: 768 blocks at CB_MXU B=256 against 128, with one limb's
// pass sums (32 registers) beside the 64 of the uint64 outputs.  Exact:
// each pass's int32 sum is bounded by J*(N+m)*|digit|*128 < 2^31, which the
// wrapper asserts.
#include "chunked.cuh"

namespace {

using namespace tfhe;

constexpr int BM = CK_BM, THREADS = 8 * CK_BK;

template <int P>
__global__ void __launch_bounds__(THREADS)
ck_dot64p_sacc_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ wm,
                      int64_t* __restrict__ out, int B, int N, int m, int Jm,
                      int kp1, int L, int ckp, int key_shift) {
  __shared__ __align__(16) uint8_t sA[BM * CK_SA_STRIDE];
  __shared__ uint32_t sB[BN * SB_WORDS<CK_BK>];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int gr = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int u = blockIdx.z / L, lm = blockIdx.z - u * L;
  const int npm = N + m, C = N / m;
  const size_t xrow = (size_t)C * P * ckp;
  const size_t gstride = (size_t)Jm * npm;
  const int add_end = min((i0 + BN - 1) / m + 1, C);  // added: [0, add_end)
  const int sub_begin = i0 / m;                       // subtracted: [.., C)
  const int8_t* w = wm + (size_t)blockIdx.z * gstride;

  uint64_t z[2][4][4];                 // this thread's 32 outputs
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[mi][nj][e] = 0;

  int32_t acc[1][2][4][4];
  for (int p = 0; p < P; ++p) {
    const int s = 8 * lm + key_shift + 7 * p;
    if (s >= 64) continue;             // vanishes mod 2^64
    for (int sub = 0; sub < 2; ++sub) {
      zero<1>(acc);
      ck_window_pass<1>(acc, sA, sB, x, xrow, w, gstride, npm, B, m0, Jm, m,
                        P, p, ckp, sub ? sub_begin : 0, sub ? C : add_end,
                        (sub ? N : 0) + i0, tid);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint64_t v = (uint64_t)(int64_t)acc[0][mi][nj][e] << s;
            z[mi][nj][e] = sub ? z[mi][nj][e] - v : z[mi][nj][e] + v;
          }
    }
  }

  const int UN = kp1 * N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp_m * 32 + mi * 16 + gr + 8 * h;
      if (row >= B) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = u * N + i0 + warp_n * 32 + nj * 8 + 2 * t;
        unsigned long long* o =
            reinterpret_cast<unsigned long long*>(out + (size_t)row * UN + col);
        atomicAdd(o, (unsigned long long)z[mi][nj][2 * h]);
        atomicAdd(o + 1, (unsigned long long)z[mi][nj][2 * h + 1]);
      }
    }
}

template <int P>
int launch(const void* x, const void* wm, const void* acc, void* out, int B,
           int N, int m, int Jm, int kp1, int L, int ckp, int key_shift,
           cudaStream_t stream) {
  cudaError_t e = cudaMemcpyAsync(out, acc, (size_t)B * kp1 * N * 8,
                                  cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / BN, (B + BM - 1) / BM, kp1 * L);
  ck_dot64p_sacc_kernel<P><<<grid, THREADS, 0, stream>>>(
      (const int8_t*)x, (const int8_t*)wm, (int64_t*)out, B, N, m, Jm, kp1,
      L, ckp, key_shift);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_ck_dot64p_sacc(const void* x, const void* wm,
                                   const void* acc, void* out, int B, int N,
                                   int m, int Jm, int kp1, int L, int P,
                                   int ckp, int key_shift, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (P == 1)
    return launch<1>(x, wm, acc, out, B, N, m, Jm, kp1, L, ckp, key_shift, s);
  if (P == 2)
    return launch<2>(x, wm, acc, out, B, N, m, Jm, kp1, L, ckp, key_shift, s);
  return (int)cudaErrorInvalidValue;
}
