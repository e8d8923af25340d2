// ck_dot64p: the chunked-key negacyclic contraction with per-limb int32
// outputs.  x (B, C*P*ckp) int8 (rotate_decompose64_ck's chunk layout),
// wm (UL, Jm, N+m) int8 (ChunkedEngine.prepare: wm[g, (j,s), q] =
// limb[q - s]), out (UL, B, N) int32:
//
//   ring[g, b, c*m + q] += sum_p (x[b, (c*P+p)*ckp : +Jm] . wm[g, :, q]) << 7p
//   out[g, b, i]         = ring[g, b, i] - ring[g, b, N + i]      (X^N = -1)
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:ck_dot64p.  Bound by int8
// tensor-core MACs.  The TPU kernel multiplies each chunk against the whole
// (N+m)-wide key and adds the result into a 2N ring in VMEM.  Here a block
// owns a 64 x 128 tile of the FOLDED outputs of LG limb groups, and for each
// plane runs two passes over the chunks whose key window reaches its
// columns: chunk c adds key columns q = i - c*m (needed for c*m <= i) and
// subtracts q = N + i - c*m (needed for c*m + m > i).  Key columns outside
// [0, N+m) load as zero, which masks the partial chunks at the window edges
// exactly, so a tile does C + 2 chunk products of depth Jm and the 2N ring
// never exists.  Each pass's sum is folded into out in uint32 (shifted by
// 7p, negated for the subtracting pass); the block's threads own the same
// elements in every pass, so the read-modify-write needs no barrier.  The
// window pass and the masked key loader are chunked.cuh's (shared with
// ck_dot64p_acc.cu and ck_cmux_step32.cu) around common.cuh's mma.sync
// m16n8k32 tile (B tiles transposed on load, like mm_recombine_acc).
// Exact: every int32 sum is bounded by J*(N+m)*|digit|*128 < 2^31, which
// the wrapper asserts.  No cp.async / TMA pipelining and no wgmma yet.
#include "chunked.cuh"

namespace {

using namespace tfhe;

constexpr int BM = CK_BM, THREADS = 8 * CK_BK;

template <int P, int LG>
__global__ void __launch_bounds__(THREADS)
ck_dot64p_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wm,
                 int32_t* __restrict__ out, int B, int N, int m, int Jm,
                 int ckp) {
  __shared__ __align__(16) uint8_t sA[BM * CK_SA_STRIDE];
  __shared__ uint32_t sB[LG * BN * SB_WORDS<CK_BK>];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int i0 = blockIdx.x * BN, m0 = blockIdx.y * BM, g0 = blockIdx.z * LG;
  const int npm = N + m, C = N / m;
  const size_t xrow = (size_t)C * P * ckp;
  const size_t gstride = (size_t)Jm * npm;
  const int8_t* w = wm + g0 * gstride;
  const int add_end = min((i0 + BN - 1) / m + 1, C);  // added: [0, add_end)
  const int sub_begin = i0 / m;                       // subtracted: [.., C)

  int32_t acc[LG][2][4][4];
  for (int p = 0; p < P; ++p) {
    for (int sub = 0; sub < 2; ++sub) {
      zero<LG>(acc);
      ck_window_pass<LG>(acc, sA, sB, x, xrow, w, gstride, npm, B, m0, Jm, m,
                         P, p, ckp, sub ? sub_begin : 0, sub ? C : add_end,
                         (sub ? N : 0) + i0, tid);
      // fold this pass into out: += (or -=) acc << 7p, mod 2^32
      const bool first = p == 0 && sub == 0;
      const int gr = lane >> 2, t = lane & 3;
#pragma unroll
      for (int lg = 0; lg < LG; ++lg)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + warp_m * 32 + mi * 16 + gr + 8 * h;
            if (row >= B) continue;
#pragma unroll
            for (int nj = 0; nj < 4; ++nj) {
              const int col = i0 + warp_n * 32 + nj * 8 + 2 * t;
              const size_t off = ((size_t)(g0 + lg) * B + row) * N + col;
              uint32_t v0 = (uint32_t)acc[lg][mi][nj][2 * h] << (7 * p);
              uint32_t v1 = (uint32_t)acc[lg][mi][nj][2 * h + 1] << (7 * p);
              if (sub) {
                v0 = 0u - v0;
                v1 = 0u - v1;
              }
              if (!first) {
                const int2 in = *reinterpret_cast<const int2*>(out + off);
                v0 += (uint32_t)in.x;
                v1 += (uint32_t)in.y;
              }
              *reinterpret_cast<int2*>(out + off) =
                  make_int2((int)v0, (int)v1);
            }
          }
    }
  }
}

template <int P, int LG>
int launch(const void* x, const void* wm, void* out, int B, int N, int m,
           int Jm, int UL, int ckp, cudaStream_t stream) {
  const dim3 grid(N / BN, (B + BM - 1) / BM, UL / LG);
  ck_dot64p_kernel<P, LG><<<grid, THREADS, 0, stream>>>(
      (const int8_t*)x, (const int8_t*)wm, (int32_t*)out, B, N, m, Jm, ckp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_ck_dot64p(const void* x, const void* wm, void* out, int B,
                              int N, int m, int Jm, int UL, int P, int ckp,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool pair = UL % 2 == 0;        // two limb groups share each x tile
  if (P == 1)
    return pair ? launch<1, 2>(x, wm, out, B, N, m, Jm, UL, ckp, s)
                : launch<1, 1>(x, wm, out, B, N, m, Jm, UL, ckp, s);
  if (P == 2)
    return pair ? launch<2, 2>(x, wm, out, B, N, m, Jm, UL, ckp, s)
                : launch<2, 1>(x, wm, out, B, N, m, Jm, UL, ckp, s);
  return (int)cudaErrorInvalidValue;
}
