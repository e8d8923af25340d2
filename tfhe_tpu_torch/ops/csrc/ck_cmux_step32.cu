// ck_cmux_step32: one whole 32-bit blind-rotation step on chunked keys,
//
//   out[b, u*N + i] = acc[b, u*N + i]
//                     + sum_l fold(x . wm[u*L + l])[b, i] << (8 l + key_shift)
//
// mod 2^32, where x_c[b, j*m + s] is digit j = (u', lv) of coefficient
// c*m + s of (X^a[b] - 1) * acc[b, u'] (gadget offset added in uint32) and
// fold is ck_dot64p.cu's X^N = -1 fold of the chunk products.  a (B,) int32,
// acc / out (B, kp1*N) int32 (the (B, k+1, N) layout is the same bytes),
// wm (kp1*L, Jm, N+m) int8 with Jm = kp1*l*m (ChunkedEngine.prepare).
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:ck_cmux_step32.  Bound by int8
// tensor-core MACs: B*(k+1)N outputs x J*N terms x L limbs per step.  The TPU
// kernel builds a whole batch tile's digits by log2(N) rolls into ping-pong
// VMEM buffers and adds C full-width chunk products into a 2N ring.  Here a
// block owns a 128-column tile of the folded outputs of one polynomial u
// for a tile of 64 (or 32) batch rows, and runs chunked.cuh's windows: the
// chunks whose key columns reach the tile, added, then those whose X^N
// wrap reaches it, subtracted.  Its L limbs share the digits and are
// recombined in the same registers at the end (the wrap mod 2^32 is the
// torus arithmetic, so no int32 bound is needed beyond the per-limb one
// that prepare asserts).
//
// Shared memory: a row tile's full digit set is rows x J*N bytes (384 KB
// for 64 rows at N=1024, l=3, k=1), past the 227 KB a block may use, so
// the block builds ONE chunk window's digits at a time, rows x J*m bytes
// (48 KB at m=128), straight from acc: 4 coefficients per thread and
// item, X^a * acc read at (n - a) mod N with one sign flip per wrap (no
// rolls), the l digit bytes of each coefficient packed into one word per
// level.  The row stride J*m + 16 bytes keeps the mma A-fragment loads free
// of bank conflicts.  Each chunk is built once: the add pass runs chunks
// 0 .. add_end-1, the accumulators are negated, the subtract pass runs
// sub_begin .. C-1 (reusing the last built chunk when m >= 128, where the
// two passes share exactly one chunk) and the accumulators are negated
// again, which leaves add - sub with no negated int8 operand (-128 has none).
// Every partial sum stays inside the per-limb bound, so nothing overflows.
// The batch tile is chosen by the wrapper (kernels.choose_tile_rows): 64
// rows and 256 threads where that grid gives every SM a block, else 32 rows
// and 128 threads.  Rows past B are computed from stale digits and never
// stored.  No cp.async / TMA pipelining and no wgmma yet.
#include "chunked.cuh"

namespace {

using namespace tfhe;

template <int L>
__device__ __forceinline__ void negate(int32_t (&C)[L][2][4][4]) {
#pragma unroll
  for (int lm = 0; lm < L; ++lm)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          C[lm][mi][nj][e] = (int32_t)(0u - (uint32_t)C[lm][mi][nj][e]);
}

template <int L, int BM>
__global__ void __launch_bounds__(BM * 4)
ck_cmux32_kernel(const int32_t* __restrict__ expo,
                 const int32_t* __restrict__ acc,
                 const int8_t* __restrict__ wm, int32_t* __restrict__ out,
                 int B, int kp1, int N, int logN, int m, int l, int bgbit,
                 uint32_t offset, int key_shift) {
  constexpr int THREADS = BM * 4;
  extern __shared__ __align__(16) uint8_t smem[];
  const int Jm = kp1 * l * m;
  const int sds = Jm + 16;                      // digit row stride (bytes)
  uint8_t* sD = smem;                           // [BM][sds]: one chunk
  uint32_t* sB = reinterpret_cast<uint32_t*>(smem + (size_t)BM * sds);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * BN, m0 = blockIdx.y * BM, u = blockIdx.z;
  const int UN = kp1 * N, npm = N + m, C = N / m, q4 = m >> 2;
  const size_t gstride = (size_t)Jm * npm;
  const int8_t* w = wm + (size_t)u * L * gstride;
  const uint32_t mask = (1u << bgbit) - 1;
  const int half = 1 << (bgbit - 1);
  const int add_end = min((i0 + BN - 1) / m + 1, C);  // added: [0, add_end)
  const int sub_begin = i0 / m;                       // subtracted: [.., C)

  int32_t Cr[L][2][4][4];
  zero<L>(Cr);
  int built = -1;
  for (int pass = 0; pass < 2; ++pass) {
    const int c_begin = pass ? sub_begin : 0, c_end = pass ? C : add_end;
    for (int c = c_begin; c < c_end; ++c) {
      if (c != built) {
        // digits of chunk c: item = (row, u', group of 4 coefficients);
        // the previous window ended with a barrier, so sD is free
        const int items = BM * kp1 * q4;
#pragma unroll 4
        for (int it = tid; it < items; it += THREADS) {
          const int q = it % q4, rest = it / q4;
          const int up = rest % kp1, row = rest / kp1;
          const int b = m0 + row;
          if (b >= B) continue;
          const int av = expo[b] & (2 * N - 1);
          const int r = av & (N - 1);
          const bool flip = (av >> logN) & 1;   // X^N = -1
          const uint32_t* xr =
              reinterpret_cast<const uint32_t*>(acc) + (size_t)b * UN + up * N;
          const int n0 = c * m + 4 * q;
          const uint4 o = *reinterpret_cast<const uint4*>(xr + n0);
          const uint32_t ov[4] = {o.x, o.y, o.z, o.w};
          uint32_t d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = n0 + e;
            const uint32_t v = __ldg(xr + ((n - r) & (N - 1)));
            const bool neg = (n < r) != flip;   // wrapped once: negate
            d[e] = (neg ? 0u - v : v) - ov[e] + offset;
          }
          uint8_t* dst = sD + row * sds + up * l * m + 4 * q;
          for (int lv = 0; lv < l; ++lv) {
            const int sh = 32 - (lv + 1) * bgbit;
            uint32_t word = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              word |= ((uint32_t)((int)((d[e] >> sh) & mask) - half) & 0xFFu)
                      << (8 * e);
            *reinterpret_cast<uint32_t*>(dst + lv * m) = word;
          }
        }
        built = c;
      }
      const int q0 = (pass ? N : 0) + i0 - c * m;
      for (int k0 = 0; k0 < Jm; k0 += CK_BK) {
        for (int v = tid; v < 8 * CK_BK; v += THREADS)
          load_wm_tiles<L>(sB, w, gstride, npm, k0, q0, v);
        __syncthreads();
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const uint8_t* r0 =
              sD + (warp_m * 32 + mi * 16 + g) * sds + k0 + 4 * t;
          const uint8_t* r8 = r0 + 8 * sds;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
        }
        mma_chunk<L, CK_BK>(Cr, a, sB, 0, warp_n, lane);
        __syncthreads();
      }
    }
    negate<L>(Cr);
  }
  epilogue<L>(Cr, acc, out, B, UN, m0, u * N + i0, key_shift, warp_m, warp_n,
              lane);
}

size_t smem_bytes(int BM, int L, int Jm) {
  return (size_t)BM * (Jm + 16) + (size_t)L * BN * SB_WORDS<CK_BK> * 4;
}

template <int L, int BM>
int launch(const void* a, const void* acc, const void* wm, void* out, int B,
           int kp1, int N, int m, int l, int bgbit, uint32_t offset,
           int key_shift, cudaStream_t stream) {
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  const size_t smem = smem_bytes(BM, L, kp1 * l * m);
  cudaError_t e = cudaFuncSetAttribute(
      ck_cmux32_kernel<L, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / BN, (B + BM - 1) / BM, kp1);
  ck_cmux32_kernel<L, BM><<<grid, BM * 4, smem, stream>>>(
      (const int32_t*)a, (const int32_t*)acc, (const int8_t*)wm,
      (int32_t*)out, B, kp1, N, logN, m, l, bgbit, offset, key_shift);
  return (int)cudaGetLastError();
}

template <int L>
int launch_tile(const void* a, const void* acc, const void* wm, void* out,
                int B, int kp1, int N, int m, int l, int bgbit,
                uint32_t offset, int key_shift, int tile_rows,
                cudaStream_t stream) {
  if (tile_rows == 64)
    return launch<L, 64>(a, acc, wm, out, B, kp1, N, m, l, bgbit, offset,
                         key_shift, stream);
  if (tile_rows == 32)
    return launch<L, 32>(a, acc, wm, out, B, kp1, N, m, l, bgbit, offset,
                         key_shift, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tfhe_ck_cmux_step32(const void* a, const void* acc,
                                   const void* wm, void* out, int B, int kp1,
                                   int N, int m, int l, int L, int bgbit,
                                   unsigned int offset, int key_shift,
                                   int tile_rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 1: return launch_tile<1>(a, acc, wm, out, B, kp1, N, m, l, bgbit, offset, key_shift, tile_rows, s);
    case 2: return launch_tile<2>(a, acc, wm, out, B, kp1, N, m, l, bgbit, offset, key_shift, tile_rows, s);
    case 3: return launch_tile<3>(a, acc, wm, out, B, kp1, N, m, l, bgbit, offset, key_shift, tile_rows, s);
    case 4: return launch_tile<4>(a, acc, wm, out, B, kp1, N, m, l, bgbit, offset, key_shift, tile_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
