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
// VMEM buffers and adds C full-width chunk products into a 2N ring.  Here an
// output tile is 128 folded columns of one polynomial u for 64 (or 32) batch
// rows, and its sum is the chunk windows: the chunks whose key columns
// reach the tile, added (windows 0 .. add_end-1, chunk w), then those whose
// X^N wrap reaches it, subtracted (windows add_end .., chunks sub_begin ..
// C-1): C + 1 windows of depth J*m when m is a multiple of 128.  The L limbs
// share the digits and are recombined in the same registers at the end (the
// wrap mod 2^32 is the torus arithmetic).
//
// Split: the windows of a tile are cut into S contiguous slices (slice s
// takes windows [s*nw/S, (s+1)*nw/S)), one block each, on the third grid
// axis beside u.  A narrow batch so still fills the card (GATE_DEFAULT
// B=256: 128 tiles of 32 rows, each 9 windows of 24 steps).  With S = 1 a
// block adds acc in its epilogue and stores; with S > 1 the entry point
// copies acc into out first and every block adds its slice with
// red.global.add.u32 (exact: addition mod 2^32 commutes).  A block with no
// window exits at once.
//
// Shared memory: a row tile's full digit set is rows x J*N bytes (384 KB
// for 64 rows at N=1024, l=3, k=1), past the 227 KB a block may use, so
// the block builds ONE chunk window's digits at a time, rows x J*m bytes
// (48 KB at m=128), straight from acc: 4 coefficients per thread and
// item, X^a * acc read at (n - a) mod N with one sign flip per wrap (no
// rolls), the l digit bytes of each coefficient packed into one word per
// level.  The row stride J*m + 16 bytes keeps the mma A-fragment loads free
// of bank conflicts.  A block builds only the chunks of its own windows,
// each once (consecutive windows of one chunk, the last added and the
// first subtracted when m >= 128, share it).  Its add windows come first;
// before its first subtracted window the accumulators are negated, and
// again at the end, which leaves add - sub with no negated int8 operand
// (-128 has none).  Every partial sum stays inside the per-limb bound, so
// nothing overflows.  The key tiles are pipelined (pipeline.cuh), one
// barrier per step (one more per chunk build): the next step's key words
// are fetched into registers while this step's mma.sync run and stored
// transposed into the other half of a double buffer.  A step is 64 deep
// where J*m % 64 == 0 (all the gate parameter sets), which halves the
// barriers, else 32 (this beat a cp.async ring of raw key rows three steps
// ahead, PERF.md).  The batch tile and S are chosen by the wrapper
// (kernels.choose_split).  Rows past B are
// computed from stale digits and never stored.  No wgmma or TMA yet
// (ROADMAP §2).
#include "pipeline.cuh"

namespace {

using namespace tfhe;

// r[lg] <- the 4x4 block of limb group lg at p + lg*lstride (row stride
// rstride bytes), or zeros where !inside.  Issues the loads, waits for
// nothing.
template <int LG>
__device__ __forceinline__ void fetch_block(uint32_t (&r)[LG][4],
                                            const int8_t* p, size_t lstride,
                                            int rstride, bool inside) {
#pragma unroll
  for (int lg = 0; lg < LG; ++lg) {
    if (inside) {
      const int8_t* q = p + lg * lstride;
      r[lg][0] = __ldg(reinterpret_cast<const uint32_t*>(q));
      r[lg][1] = __ldg(reinterpret_cast<const uint32_t*>(q + rstride));
      r[lg][2] = __ldg(reinterpret_cast<const uint32_t*>(q + 2 * rstride));
      r[lg][3] = __ldg(reinterpret_cast<const uint32_t*>(q + 3 * rstride));
    } else {
      r[lg][0] = r[lg][1] = r[lg][2] = r[lg][3] = 0;
    }
  }
}

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

// The block's tile and its windows.  Window wi is chunk wi (added) or
// sub_begin + wi - add_end (subtracted), whose key columns start at
// q0 = (0 or N) + i0 - chunk*m.
struct Tile {
  int i0, m0, u, add_end, sub_begin, w_lo, w_hi;
  __device__ __forceinline__ Tile(int BM, int N, int m, int split) {
    i0 = blockIdx.x * BN;
    m0 = blockIdx.y * BM;
    u = blockIdx.z / split;
    const int slice = blockIdx.z - u * split, C = N / m;
    add_end = min((i0 + BN - 1) / m + 1, C);          // added: [0, add_end)
    sub_begin = i0 / m;                               // subtracted: [.., C)
    const int nw = add_end + C - sub_begin;
    w_lo = slice * nw / split;
    w_hi = (slice + 1) * nw / split;
  }
  __device__ __forceinline__ int chunk(int wi) const {
    return wi < add_end ? wi : sub_begin + wi - add_end;
  }
  __device__ __forceinline__ int q0(int wi, int N, int m) const {
    return (wi < add_end ? 0 : N) + i0 - chunk(wi) * m;
  }
};

// The digits of chunk c for the block's BM rows into sD: item = (row, u',
// group of 4 coefficients); X^a * acc read at (n - a) mod N with one sign
// flip per wrap, the l digit bytes of each coefficient packed into one
// word per level.
template <int BM>
__device__ __forceinline__ void build_digits(
    uint8_t* sD, int sds, const int32_t* __restrict__ expo,
    const int32_t* __restrict__ acc, int c, int m0, int B, int kp1, int N,
    int logN, int m, int l, int bgbit, uint32_t offset, int tid) {
  constexpr int THREADS = BM * 4;
  const int UN = kp1 * N, q4 = m >> 2;
  const uint32_t mask = (1u << bgbit) - 1;
  const int half = 1 << (bgbit - 1);
  const int items = BM * kp1 * q4;
  // item it = (row*kp1 + up)*q4 + q, its indices stepped by THREADS without
  // a division per item
  const int dq = THREADS % q4, drest = THREADS / q4;
  int q = tid % q4, rest = tid / q4;
  int up = rest % kp1, row = rest / kp1;
  const int dup = drest % kp1, drow = drest / kp1;
#pragma unroll 4
  for (int it = tid; it < items; it += THREADS) {
    const int iq = q, iup = up, b = m0 + row;
    q += dq;
    up += dup;
    row += drow;
    if (q >= q4) { q -= q4; ++up; }
    if (up >= kp1) { up -= kp1; ++row; }
    if (b >= B) continue;
    const int av = expo[b] & (2 * N - 1);
    const int r = av & (N - 1);
    const bool flip = (av >> logN) & 1;   // X^N = -1
    const uint32_t* xr =
        reinterpret_cast<const uint32_t*>(acc) + (size_t)b * UN + iup * N;
    const int n0 = c * m + 4 * iq;
    const uint4 o = *reinterpret_cast<const uint4*>(xr + n0);
    const uint32_t ov[4] = {o.x, o.y, o.z, o.w};
    uint32_t d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + e;
      const uint32_t val = __ldg(xr + ((n - r) & (N - 1)));
      const bool neg = (n < r) != flip;   // wrapped once: negate
      d[e] = (neg ? 0u - val : val) - ov[e] + offset;
    }
    uint8_t* dst = sD + (b - m0) * sds + iup * l * m + 4 * iq;
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
}

// KH 32-deep halves a step (a 64-deep step, KH = 2, needs J*m % 64 == 0).
template <int L, int BM, int KH>
__global__ void __launch_bounds__(BM * 4)
ck_cmux32_kernel(const int32_t* __restrict__ expo,
                 const int32_t* __restrict__ acc,
                 const int8_t* __restrict__ wm, int32_t* __restrict__ out,
                 int B, int kp1, int N, int logN, int m, int l, int bgbit,
                 uint32_t offset, int key_shift, int split) {
  constexpr int THREADS = BM * 4, NV = 256 / THREADS, DEPTH = KH * CK_BK;
  extern __shared__ __align__(16) uint8_t smem[];
  const int Jm = kp1 * l * m;
  const int sds = Jm + 16;                      // digit row stride (bytes)
  uint8_t* sD = smem;                           // [BM][sds]: one chunk
  uint32_t* sB = reinterpret_cast<uint32_t*>(smem + (size_t)BM * sds);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const Tile tl(BM, N, m, split);
  if (tl.w_lo >= tl.w_hi) return;               // no window: adds nothing
  const int npm = N + m, UN = kp1 * N;
  const size_t gstride = (size_t)Jm * npm;
  const int8_t* w = wm + (size_t)tl.u * L * gstride;
  const int steps = (tl.w_hi - tl.w_lo) * (Jm / DEPTH);

  uint32_t kr[KH][NV][L][4];
  auto fetch = [&](int wi, int k0) {
    const int q0 = tl.q0(wi, N, m);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const TileSlot sl(tid + v * THREADS);
      const int col = q0 + 4 * sl.nb;
#pragma unroll
      for (int h = 0; h < KH; ++h)
        fetch_block<L>(kr[h][v],
                       w + (size_t)(k0 + CK_BK * h + 4 * sl.kb) * npm + col,
                       gstride, npm, col >= 0 && col < npm);
    }
  };

  int32_t Cr[L][2][4][4];
  zero<L>(Cr);
  int built = -1, wi = tl.w_lo, k0 = 0;
  fetch(wi, 0);
  for (int g = 0; g < steps; ++g) {
    uint32_t* sBg = sB + (g & 1) * KH * SB_TILE<L>;
#pragma unroll
    for (int h = 0; h < KH; ++h)
#pragma unroll
      for (int v = 0; v < NV; ++v)
        store_block<L>(sBg + h * SB_TILE<L>, kr[h][v],
                       TileSlot(tid + v * THREADS));
    const int c = tl.chunk(wi);
    if (k0 == 0 && c != built) {
      __syncthreads();                          // the last window is done with sD
      build_digits<BM>(sD, sds, expo, acc, c, tl.m0, B, kp1, N, logN, m, l,
                       bgbit, offset, tid);
      built = c;
    }
    __syncthreads();
    if (k0 == 0 && wi == tl.add_end) negate<L>(Cr);   // first subtracted window
    int k1 = k0 + DEPTH, w1 = wi;
    if (k1 == Jm) { k1 = 0; ++w1; }
    if (g + 1 < steps) fetch(w1, k1);             // in flight during the mma
#pragma unroll
    for (int h = 0; h < KH; ++h) {
      uint32_t a[2][4];
      load_a(a, sD, sds, k0 + CK_BK * h, warp_m, lane);
      mma_step<L>(Cr, a, sBg + h * SB_TILE<L>, warp_n, lane);
    }
    wi = w1;
    k0 = k1;
  }
  if (tl.w_hi > tl.add_end) negate<L>(Cr);
  const int c0 = tl.u * N + tl.i0;
  if (split == 1)
    epilogue<L>(Cr, acc, out, B, UN, tl.m0, c0, key_shift, warp_m, warp_n,
                lane);
  else
    epilogue_add<L>(Cr, out, B, UN, tl.m0, c0, key_shift, warp_m, warp_n,
                    lane);
}

// A step is 64 deep where J*m allows (half the barriers), else 32.
inline int halves(int Jm) { return Jm % 64 == 0 ? 2 : 1; }

template <int L>
size_t smem_bytes(int BM, int Jm) {
  return (size_t)BM * (Jm + 16) + 2 * (size_t)halves(Jm) * SB_TILE<L> * 4;
}

template <int L, int BM>
auto kernel_of(int Jm) {
  return halves(Jm) == 2 ? ck_cmux32_kernel<L, BM, 2>
                         : ck_cmux32_kernel<L, BM, 1>;
}

template <int L, int BM>
int set_smem(int Jm) {
  return (int)cudaFuncSetAttribute(kernel_of<L, BM>(Jm),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes<L>(BM, Jm));
}

template <int L, int BM>
int launch(const void* a, const void* acc, const void* wm, void* out, int B,
           int kp1, int N, int m, int l, int bgbit, uint32_t offset,
           int key_shift, int split, cudaStream_t stream) {
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  const int Jm = kp1 * l * m;
  int e = set_smem<L, BM>(Jm);
  if (e != 0) return e;
  if (split < 1) return (int)cudaErrorInvalidValue;
  if (split > 1) {
    cudaError_t ce = cudaMemcpyAsync(out, acc, (size_t)B * kp1 * N * 4,
                                     cudaMemcpyDeviceToDevice, stream);
    if (ce != cudaSuccess) return (int)ce;
  }
  const dim3 grid(N / BN, (B + BM - 1) / BM, kp1 * split);
  kernel_of<L, BM>(Jm)<<<grid, BM * 4, smem_bytes<L>(BM, Jm), stream>>>(
      (const int32_t*)a, (const int32_t*)acc, (const int8_t*)wm,
      (int32_t*)out, B, kp1, N, logN, m, l, bgbit, offset, key_shift, split);
  return (int)cudaGetLastError();
}

template <int L, int BM>
int occupancy(int Jm) {
  int e = set_smem<L, BM>(Jm);
  if (e != 0) return -e;
  int n = 0;
  cudaError_t ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel_of<L, BM>(Jm), BM * 4, smem_bytes<L>(BM, Jm));
  return ce == cudaSuccess ? n : -(int)ce;
}

template <int L>
int launch_tile(const void* a, const void* acc, const void* wm, void* out,
                int B, int kp1, int N, int m, int l, int bgbit,
                uint32_t offset, int key_shift, int tile_rows, int split,
                cudaStream_t stream) {
  if (tile_rows == 64)
    return launch<L, 64>(a, acc, wm, out, B, kp1, N, m, l, bgbit, offset,
                         key_shift, split, stream);
  if (tile_rows == 32)
    return launch<L, 32>(a, acc, wm, out, B, kp1, N, m, l, bgbit, offset,
                         key_shift, split, stream);
  return (int)cudaErrorInvalidValue;
}

template <int L>
int occupancy_tile(int tile_rows, int Jm) {
  if (tile_rows == 64) return occupancy<L, 64>(Jm);
  if (tile_rows == 32) return occupancy<L, 32>(Jm);
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tfhe_ck_cmux_step32(const void* a, const void* acc,
                                   const void* wm, void* out, int B, int kp1,
                                   int N, int m, int l, int L, int bgbit,
                                   unsigned int offset, int key_shift,
                                   int tile_rows, int split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 1: return launch_tile<1>(a, acc, wm, out, B, kp1, N, m, l, bgbit, offset, key_shift, tile_rows, split, s);
    case 2: return launch_tile<2>(a, acc, wm, out, B, kp1, N, m, l, bgbit, offset, key_shift, tile_rows, split, s);
    case 3: return launch_tile<3>(a, acc, wm, out, B, kp1, N, m, l, bgbit, offset, key_shift, tile_rows, split, s);
    case 4: return launch_tile<4>(a, acc, wm, out, B, kp1, N, m, l, bgbit, offset, key_shift, tile_rows, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the kernel for (L, tile_rows, J*m) resident on one SM (from its
// registers and shared memory), or -cudaError.
extern "C" int tfhe_ck_cmux_step32_occupancy(int L, int tile_rows, int Jm) {
  switch (L) {
    case 1: return occupancy_tile<1>(tile_rows, Jm);
    case 2: return occupancy_tile<2>(tile_rows, Jm);
    case 3: return occupancy_tile<3>(tile_rows, Jm);
    case 4: return occupancy_tile<4>(tile_rows, Jm);
    default: return -(int)cudaErrorInvalidValue;
  }
}
