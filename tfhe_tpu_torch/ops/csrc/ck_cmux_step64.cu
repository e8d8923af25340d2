// ck_cmux_step64: one whole 64-bit blind-rotation step on chunked keys,
//
//   out[b, u*N + i] = acc[b, u*N + i]
//                     + sum_l fold(x . wm[u*L + l])[b, i] << (8 l + key_shift)
//
// mod 2^64, where x_c[b, j*m + s] is digit j = (u', lv) of coefficient
// c*m + s of (X^a[b] - 1) * acc[b, u'] (gadget offset added in uint64, split
// into P balanced base-2^7 planes when P = 2) and fold is ck_dot64p.cu's
// X^N = -1 fold of the chunk products.  a (B,) int32, acc / out (B, kp1*N)
// int64 (the flat Torus64 accumulator; the (B, k+1, N) layout is the same
// bytes), wm (kp1*L, Jm, N+m) int8 with Jm = kp1*l*m (ChunkedEngine.prepare).
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:ck_cmux_step64.  Bound by int8
// tensor-core MACs: B*(k+1)N outputs x J*N terms x L limbs x P planes per
// step.  The TPU kernel keeps the whole (L, Jm, N+m) key block of one output
// polynomial resident in VMEM (~8 MB at CB_MXU), builds the next batch
// tile's digits under the current tile's dots and recombines the limbs in
// (lo, hi) int32 pairs.  No SM holds 8 MB.  Here a block owns a 128-column
// tile of the folded outputs of one polynomial u for a tile of 64 (or 32)
// batch rows, as ck_cmux_step32.cu does, and walks the chunks once: chunk c
// is built in shared memory straight from acc (4 coefficients per thread and
// item, X^a * acc read at (n - a) mod N with one sign flip per wrap, native
// uint64 subtract and offset add, l digits per coefficient, each split into
// its planes), then added if its key columns reach the tile (c*m <= i) and
// subtracted if its X^N wrap does (c*m + m > i).  Every chunk's digits serve
// both signs and all L limbs, so each is built exactly once.  For each
// (chunk, sign, limb group) the block runs the K loop over Jm once; each K
// step's key tile serves every plane (LG limbs x P planes = 2 int32 pass
// tiles of 32 registers), and the pass sums are folded into the uint64
// outputs as (int64) pass << (8 l + key_shift + 7 p), added or subtracted,
// before the next group: 64 registers of uint64 outputs plus 64 of int32
// passes, where all L limbs at once (6 at CB_MXU, 8 at CB_ACTIVE) would not
// fit.  Each pass's int32 sum is bounded by J*(N+m)*|digit|*128 < 2^31
// (asserted by the wrapper), so every fold is exact and the uint64 sums
// wrap as the torus does.
//
// Shared memory: the chunk window, rows x (P*Jm + 16) bytes (plane p at
// byte p*Jm of a row; the 16-byte pad keeps the A-fragment loads free of
// bank conflicts): 42 KB for 64 rows at CB_MXU, 66.5 KB at CB_ACTIVE; plus
// LG key tiles.  The batch tile comes from the wrapper
// (kernels.choose_tile_rows).  Rows past B are computed from stale digits
// and never stored.  No cp.async / TMA pipelining and no wgmma yet.
#include "chunked.cuh"

namespace {

using namespace tfhe;

template <int P, int LG, int BM>
__global__ void __launch_bounds__(BM * 4)
ck_cmux64_kernel(const int32_t* __restrict__ expo,
                 const int64_t* __restrict__ acc,
                 const int8_t* __restrict__ wm, int64_t* __restrict__ out,
                 int B, int kp1, int N, int logN, int m, int l, int L,
                 int bgbit, uint64_t offset, int key_shift) {
  constexpr int THREADS = BM * 4;
  extern __shared__ __align__(16) uint8_t smem[];
  const int Jm = kp1 * l * m;
  const int sds = P * Jm + 16;                  // digit row stride (bytes)
  uint8_t* sD = smem;                           // [BM][sds]: one chunk
  uint32_t* sB = reinterpret_cast<uint32_t*>(smem + (size_t)BM * sds);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * BN, m0 = blockIdx.y * BM, u = blockIdx.z;
  const int UN = kp1 * N, npm = N + m, C = N / m, q4 = m >> 2;
  const size_t gstride = (size_t)Jm * npm;
  const uint64_t mask = (1ull << bgbit) - 1;
  const int half = 1 << (bgbit - 1);
  const int add_end = min((i0 + BN - 1) / m + 1, C);  // added: [0, add_end)
  const int sub_begin = i0 / m;                       // subtracted: [.., C)

  uint64_t z[2][4][4];                 // this thread's 32 outputs
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[mi][nj][e] = 0;

  int32_t Cr[P][LG][2][4][4];
  for (int c = 0; c < C; ++c) {
    const bool add = c < add_end, sub = c >= sub_begin;
    if (!add && !sub) continue;
    // digits of chunk c: item = (row, u', group of 4 coefficients); the
    // previous chunk's K loop ended with a barrier, so sD is free
    const int items = BM * kp1 * q4;
#pragma unroll 2
    for (int it = tid; it < items; it += THREADS) {
      const int q = it % q4, rest = it / q4;
      const int up = rest % kp1, row = rest / kp1;
      const int b = m0 + row;
      if (b >= B) continue;
      const int av = expo[b] & (2 * N - 1);
      const int r = av & (N - 1);
      const bool flip = (av >> logN) & 1;      // X^N = -1
      const uint64_t* xr =
          reinterpret_cast<const uint64_t*>(acc) + (size_t)b * UN + up * N;
      const int n0 = c * m + 4 * q;
      const ulonglong2 o01 = *reinterpret_cast<const ulonglong2*>(xr + n0);
      const ulonglong2 o23 = *reinterpret_cast<const ulonglong2*>(xr + n0 + 2);
      const uint64_t ov[4] = {o01.x, o01.y, o23.x, o23.y};
      uint64_t d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + e;
        const uint64_t v = __ldg(xr + ((n - r) & (N - 1)));
        const bool neg = (n < r) != flip;      // wrapped once: negate
        d[e] = (neg ? 0ull - v : v) - ov[e] + offset;
      }
      uint8_t* dst = sD + row * sds + up * l * m + 4 * q;
      for (int lv = 0; lv < l; ++lv) {
        const int sh = 64 - (lv + 1) * bgbit;
        uint32_t w0 = 0, w1 = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dig = (int)((d[e] >> sh) & mask) - half;
          const int p0 = P == 1 ? dig : ((dig + 64) & 127) - 64;
          w0 |= ((uint32_t)p0 & 0xFFu) << (8 * e);
          w1 |= ((uint32_t)((dig - p0) / 128) & 0xFFu) << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(dst + lv * m) = w0;
        if (P == 2) *reinterpret_cast<uint32_t*>(dst + Jm + lv * m) = w1;
      }
    }
    // (no barrier here: the first K step's barrier follows the key load)
    for (int sg = 0; sg < 2; ++sg) {
      if (!(sg ? sub : add)) continue;
      const int q0 = (sg ? N : 0) + i0 - c * m;
      for (int l0 = 0; l0 < L; l0 += LG) {
        const int8_t* w = wm + (size_t)(u * L + l0) * gstride;
#pragma unroll
        for (int p = 0; p < P; ++p) zero<LG>(Cr[p]);
        for (int k0 = 0; k0 < Jm; k0 += CK_BK) {
          for (int v = tid; v < 8 * CK_BK; v += THREADS)
            load_wm_tiles<LG>(sB, w, gstride, npm, k0, q0, v);
          __syncthreads();
#pragma unroll
          for (int p = 0; p < P; ++p) {
            uint32_t a[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const uint8_t* r0 = sD + (warp_m * 32 + mi * 16 + g) * sds +
                                  p * Jm + k0 + 4 * t;
              const uint8_t* r8 = r0 + 8 * sds;
              a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
              a[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
              a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
              a[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
            }
            mma_chunk<LG, CK_BK>(Cr[p], a, sB, 0, warp_n, lane);
          }
          __syncthreads();
        }
        // fold the (limb, plane) passes of this sign into the outputs
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int lg = 0; lg < LG; ++lg) {
            const int s = 8 * (l0 + lg) + key_shift + 7 * p;
            if (s >= 64) continue;             // vanishes mod 2^64
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int nj = 0; nj < 4; ++nj)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const uint64_t v = (uint64_t)(int64_t)Cr[p][lg][mi][nj][e]
                                     << s;
                  z[mi][nj][e] = sg ? z[mi][nj][e] - v : z[mi][nj][e] + v;
                }
          }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp_m * 32 + mi * 16 + g + 8 * h;
      if (row >= B) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = u * N + i0 + warp_n * 32 + nj * 8 + 2 * t;
        const size_t off = (size_t)row * UN + col;
        const longlong2 in = *reinterpret_cast<const longlong2*>(acc + off);
        const uint64_t s0 = (uint64_t)in.x + z[mi][nj][2 * h];
        const uint64_t s1 = (uint64_t)in.y + z[mi][nj][2 * h + 1];
        *reinterpret_cast<longlong2*>(out + off) =
            make_longlong2((long long)s0, (long long)s1);
      }
    }
}

size_t smem_bytes(int BM, int P, int LG, int Jm) {
  return (size_t)BM * (P * Jm + 16) + (size_t)LG * BN * SB_WORDS<CK_BK> * 4;
}

template <int P, int LG, int BM>
int launch(const void* a, const void* acc, const void* wm, void* out, int B,
           int kp1, int N, int m, int l, int L, int bgbit, uint64_t offset,
           int key_shift, cudaStream_t stream) {
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  const size_t smem = smem_bytes(BM, P, LG, kp1 * l * m);
  cudaError_t e = cudaFuncSetAttribute(
      ck_cmux64_kernel<P, LG, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / BN, (B + BM - 1) / BM, kp1);
  ck_cmux64_kernel<P, LG, BM><<<grid, BM * 4, smem, stream>>>(
      (const int32_t*)a, (const int64_t*)acc, (const int8_t*)wm,
      (int64_t*)out, B, kp1, N, logN, m, l, L, bgbit, offset, key_shift);
  return (int)cudaGetLastError();
}

template <int P, int LG>
int launch_tile(const void* a, const void* acc, const void* wm, void* out,
                int B, int kp1, int N, int m, int l, int L, int bgbit,
                uint64_t offset, int key_shift, int tile_rows,
                cudaStream_t stream) {
  if (tile_rows == 64)
    return launch<P, LG, 64>(a, acc, wm, out, B, kp1, N, m, l, L, bgbit,
                             offset, key_shift, stream);
  if (tile_rows == 32)
    return launch<P, LG, 32>(a, acc, wm, out, B, kp1, N, m, l, L, bgbit,
                             offset, key_shift, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tfhe_ck_cmux_step64(const void* a, const void* acc,
                                   const void* wm, void* out, int B, int kp1,
                                   int N, int m, int l, int L, int P,
                                   int bgbit, unsigned long long offset,
                                   int key_shift, int tile_rows,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // two int32 pass tiles per K step where L allows: two limbs of one
  // plane, or one limb of two planes
  if (P == 1 && L % 2 == 0)
    return launch_tile<1, 2>(a, acc, wm, out, B, kp1, N, m, l, L, bgbit,
                             (uint64_t)offset, key_shift, tile_rows, s);
  if (P == 1)
    return launch_tile<1, 1>(a, acc, wm, out, B, kp1, N, m, l, L, bgbit,
                             (uint64_t)offset, key_shift, tile_rows, s);
  if (P == 2)
    return launch_tile<2, 1>(a, acc, wm, out, B, kp1, N, m, l, L, bgbit,
                             (uint64_t)offset, key_shift, tile_rows, s);
  return (int)cudaErrorInvalidValue;
}
