// ck_dot64p_acc: the chunked-key contraction with the 64-bit limb
// recombination and the accumulator add inside.  x (B, C*P*ckp) int8
// (rotate_decompose64_ck's chunk layout), wm (kp1*L, Jm, N+m) int8
// (ChunkedEngine.prepare), acc / out (B, kp1*N) int64 (the native
// (B, k+1, N) Torus64 accumulator, the same bytes):
//
//   out[b, u*N + i] = acc[b, u*N + i]
//                     + sum_l fold(x . wm[u*L + l])[b, i] << (8 l + key_shift)
//
// mod 2^64, fold as in ck_dot64p.cu (planes combined with << 7p).
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:ck_dot64p_acc.  Bound by int8
// tensor-core MACs, as ck_dot64p.  The design is ck_dot64p.cu's (a block
// owns a 64 x 128 tile of folded output columns and runs the chunk windows
// that reach it, chunked.cuh) with the epilogue moved inside: the block
// owns one polynomial u and loops over its L limb groups (two at a time
// where L is even, sharing each x tile), and every (limb, plane, sign) pass
// is added to a uint64 accumulator held in registers as
// (int64) pass << (8 l + key_shift + 7 p).  The per-limb int32 products of
// ck_dot64p, (U*L, B, N) int32 in device memory, never exist.  Registers:
// 32 uint64 outputs (64 words) plus LG x 32 int32 pass sums per thread.
// Exact: each pass's int32 sum is bounded by J*(N+m)*|digit|*128 < 2^31,
// which the wrapper asserts; the uint64 sums wrap as the torus does.
#include "chunked.cuh"

namespace {

using namespace tfhe;

constexpr int BM = CK_BM, THREADS = 8 * CK_BK;

template <int P, int LG>
__global__ void __launch_bounds__(THREADS)
ck_dot64p_acc_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ wm,
                     const int64_t* __restrict__ acc_in,
                     int64_t* __restrict__ out, int B, int N, int m, int Jm,
                     int kp1, int L, int ckp, int key_shift) {
  __shared__ __align__(16) uint8_t sA[BM * CK_SA_STRIDE];
  __shared__ uint32_t sB[LG * BN * SB_WORDS<CK_BK>];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int gr = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * BN, m0 = blockIdx.y * BM, u = blockIdx.z;
  const int npm = N + m, C = N / m;
  const size_t xrow = (size_t)C * P * ckp;
  const size_t gstride = (size_t)Jm * npm;
  const int add_end = min((i0 + BN - 1) / m + 1, C);  // added: [0, add_end)
  const int sub_begin = i0 / m;                       // subtracted: [.., C)

  uint64_t z[2][4][4];                 // this thread's 32 outputs
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[mi][nj][e] = 0;

  int32_t acc[LG][2][4][4];
  for (int l0 = 0; l0 < L; l0 += LG) {
    const int8_t* w = wm + (size_t)(u * L + l0) * gstride;
    for (int p = 0; p < P; ++p) {
      for (int sub = 0; sub < 2; ++sub) {
        zero<LG>(acc);
        ck_window_pass<LG>(acc, sA, sB, x, xrow, w, gstride, npm, B, m0, Jm,
                           m, P, p, ckp, sub ? sub_begin : 0,
                           sub ? C : add_end, (sub ? N : 0) + i0, tid);
#pragma unroll
        for (int lg = 0; lg < LG; ++lg) {
          const int s = 8 * (l0 + lg) + key_shift + 7 * p;
          if (s >= 64) continue;        // vanishes mod 2^64
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int nj = 0; nj < 4; ++nj)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const uint64_t v = (uint64_t)(int64_t)acc[lg][mi][nj][e] << s;
                z[mi][nj][e] = sub ? z[mi][nj][e] - v : z[mi][nj][e] + v;
              }
        }
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
        const size_t off = (size_t)row * UN + col;
        const longlong2 in = *reinterpret_cast<const longlong2*>(acc_in + off);
        const uint64_t s0 = (uint64_t)in.x + z[mi][nj][2 * h];
        const uint64_t s1 = (uint64_t)in.y + z[mi][nj][2 * h + 1];
        *reinterpret_cast<longlong2*>(out + off) =
            make_longlong2((long long)s0, (long long)s1);
      }
    }
}

template <int P, int LG>
int launch(const void* x, const void* wm, const void* acc, void* out, int B,
           int N, int m, int Jm, int kp1, int L, int ckp, int key_shift,
           cudaStream_t stream) {
  const dim3 grid(N / BN, (B + BM - 1) / BM, kp1);
  ck_dot64p_acc_kernel<P, LG><<<grid, THREADS, 0, stream>>>(
      (const int8_t*)x, (const int8_t*)wm, (const int64_t*)acc,
      (int64_t*)out, B, N, m, Jm, kp1, L, ckp, key_shift);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_ck_dot64p_acc(const void* x, const void* wm,
                                  const void* acc, void* out, int B, int N,
                                  int m, int Jm, int kp1, int L, int P,
                                  int ckp, int key_shift, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool pair = L % 2 == 0;         // two limb groups share each x tile
  if (P == 1)
    return pair ? launch<1, 2>(x, wm, acc, out, B, N, m, Jm, kp1, L, ckp,
                               key_shift, s)
                : launch<1, 1>(x, wm, acc, out, B, N, m, Jm, kp1, L, ckp,
                               key_shift, s);
  if (P == 2)
    return pair ? launch<2, 2>(x, wm, acc, out, B, N, m, Jm, kp1, L, ckp,
                               key_shift, s)
                : launch<2, 1>(x, wm, acc, out, B, N, m, Jm, kp1, L, ckp,
                               key_shift, s);
  return (int)cudaErrorInvalidValue;
}
