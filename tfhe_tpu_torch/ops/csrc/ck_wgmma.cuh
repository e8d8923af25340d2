// The mainloop of the chunked-key contractions on Hopper (ck_dot64p.cu,
// ck_dot64p_acc.cu, ck_dot64p_sacc.cu; ck_cmux_step64.cu takes its key side
// and its epilogue; mm_recombine_acc.cu its plan, ring and launch): int8
// wgmma on operands that TMA loads into an mbarrier ring, over the K-packed
// chunked key wmt (UL, N+m, J*m) int8, wmt[g, q, (j,s)] = limb[q - s]
// (ChunkedEngine.prepare).
//
// A block owns a tile of FOLDED output columns [i0, i0 + TN) of LG
// consecutive limb groups g0 .. g0 + LG - 1 for 64 WG batch rows (WG
// consumer warpgroups of 64 rows each).  Chunk c of the digits adds key
// rows q = i - c*m (needed for c*m <= i) and subtracts q = N + i - c*m
// (needed for c*m + m > i, X^N = -1), so per digit plane the tile runs two
// window sets: added c in [0, add_end), subtracted c in [sub_begin, C).
//   * Both operands by TMA, 128-byte swizzle, 128 K-bytes a stage: the
//     digits' box is rows b0 .. + 64 WG of x (B, C*P*ckp) at column
//     (c*P + p)*ckp + k0, the key's box rows q0 .. q0 + TN of limbs g0 ..
//     g0 + LG of wmt at K column k0.  TMA fills box elements outside the
//     tensor with zeros, negative rows included: exactly the window mask
//     (key rows outside [0, N+m)), the K tail (key columns past J*m, so x's
//     pad columns never count), the batch tail and the limb tail.
//   * One producer warp keeps the ring full; the LG limbs' key rows are
//     stacked along the instruction's N (NN = TN * LG <= 256), so each k32
//     step of a stage is one m64nNNk32 per consumer warpgroup, and the WG
//     warpgroups of a block share each key tile.
//   * One register set for every pass: wgmma only adds, so the planes run
//     highest first and the accumulators are transformed in place between
//     window sets, mod 2^32: negated before a subtracted set and again
//     after it, shifted left by 7 before the next plane (Horner).  Every
//     partial sum wraps mod 2^32 (no .satfinite) and the folded value is
//     exact because it is below 2^31 (the wrappers assert it).
//   * Each stage's wgmma group is waited for before the next is issued (the
//     TMA loads still run ahead): with one group left in flight across
//     stages, ptxas could not tell the in-place transforms from the
//     pipeline and serialized every wgmma (C7515), 6% slower (PERF.md §6).
//
// CK_PART (a build flag, default 0) strips the kernels to one part for
// timing: 1 keeps the TMA loads (consumers wait and release), 2 the wgmmas
// (on whatever the ring holds; no loads, no barriers), 3 the epilogue
// alone.  Their outputs are meaningless.
#pragma once

#include "wgmma.cuh"

#ifndef CK_PART
#define CK_PART 0
#endif

namespace tfhe {

constexpr bool CK_LOADS = CK_PART == 0 || CK_PART == 1;
constexpr bool CK_MMAS = CK_PART == 0 || CK_PART == 2;
constexpr bool CK_MAIN = CK_PART != 3;

constexpr int CKW_BK = 128;               // K bytes of a stage: one swizzled row
constexpr int CKW_MAX_STAGES = 8;
constexpr size_t CKW_MAX_SMEM = 232448;

// The shapes both kernels share; ktiles = ceil(J*m / 128).
struct CkShape {
  int B, N, m, C, P, ckp, ktiles, UL;
};

template <int WG_, int TN_, int NN_>
struct CkPlan {
  static constexpr int WG = WG_, TN = TN_, NN = NN_, LG = NN / TN;
  static constexpr int R = NN / 2;          // int32 accumulators a thread
  static constexpr int ROWS = 64 * WG;
  static constexpr int A_BYTES = ROWS * CKW_BK, B_BYTES = NN * CKW_BK;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int THREADS = 128 * WG + 32;
  // as many stages as fit beside 1 KB of alignment slack, at most 8
  static constexpr int STAGES =
      (int)((CKW_MAX_SMEM - 1024) / (STAGE + 2 * sizeof(uint64_t)))
          < CKW_MAX_STAGES
      ? (int)((CKW_MAX_SMEM - 1024) / (STAGE + 2 * sizeof(uint64_t)))
      : CKW_MAX_STAGES;
  static constexpr size_t SMEM =
      1024 + (size_t)STAGES * (STAGE + 2 * sizeof(uint64_t));
  static_assert(NN % TN == 0 && NN <= 256 && NN % 64 == 0, "wgmma width");
  static_assert(STAGES >= 2, "a ring of two stages at least");
};

// The block's shared memory: the ring (1,024-byte aligned stages) and its
// full / empty barriers.
template <class Pl>
struct CkRing {
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ explicit CkRing(uint8_t* raw) {
    ring = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
    full = reinterpret_cast<uint64_t*>(ring + (size_t)Pl::STAGES * Pl::STAGE);
    empty = full + Pl::STAGES;
  }

  // Thread 0 initialises the barriers, then the block syncs.
  __device__ __forceinline__ void init(int tid) const {
    if (tid == 0) {
      for (int s = 0; s < Pl::STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 4 * Pl::WG);   // lane 0 of each consumer warp
      }
      mbar_fence_init();
    }
    __syncthreads();
  }
};

// A position in the ring, advanced by producer and consumers in step.
struct CkCursor {
  int s = 0;
  uint32_t ph = 0;

  template <class Pl>
  __device__ __forceinline__ void next() {
    if (++s == Pl::STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
};

// The chunk windows of tile [i0, i0 + TN): added [0, add_end), subtracted
// [sub_begin, C).
template <int TN>
__device__ __forceinline__ int ck_add_end(int i0, const CkShape& g) {
  return min((i0 + TN - 1) / g.m + 1, g.C);
}

__device__ __forceinline__ int ck_sub_begin(int i0, const CkShape& g) {
  return i0 / g.m;
}

// The producer's lane 0: every stage of one pass set (limb groups g0 ..),
// planes highest first, added then subtracted windows, K tiles in order:
// the consumers' order.
template <class Pl>
__device__ __forceinline__ void ck_produce(const CkRing<Pl>& r, CkCursor& cur,
                                           const CUtensorMap* xmap,
                                           const CUtensorMap* wmap,
                                           const CkShape& g, int i0, int b0,
                                           int g0) {
  const int add_end = ck_add_end<Pl::TN>(i0, g);
  const int sub_begin = ck_sub_begin(i0, g);
  for (int p = g.P - 1; p >= 0; --p)
    for (int sub = 0; sub < 2; ++sub)
      for (int c = sub ? sub_begin : 0; c < (sub ? g.C : add_end); ++c) {
        const int q0 = (sub ? g.N : 0) + i0 - c * g.m;
        const int xc = (c * g.P + p) * g.ckp;
        for (int kt = 0; kt < g.ktiles; ++kt) {
          mbar_wait(&r.empty[cur.s], cur.ph ^ 1);
          uint8_t* st = r.ring + (size_t)cur.s * Pl::STAGE;
          mbar_arrive_tx(&r.full[cur.s], Pl::STAGE);
          tma_load_2d(st, xmap, &r.full[cur.s], xc + kt * CKW_BK, b0);
          tma_load_3d(st + Pl::A_BYTES, wmap, &r.full[cur.s], kt * CKW_BK,
                      q0, g0);
          cur.next<Pl>();
        }
      }
}

template <int R>
__device__ __forceinline__ void ck_negate(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0u - d[i];
}

// Consumer warpgroup ``wg`` (rows 64 wg ..): d = the folded product of one
// pass set, sum_p (added - subtracted windows of plane p) << 7p, mod 2^32,
// added onto what d holds (the callers zero it first).
template <class Pl>
__device__ __forceinline__ void ck_consume(uint32_t (&d)[Pl::R],
                                           const CkRing<Pl>& r, CkCursor& cur,
                                           const CkShape& g, int i0, int wg,
                                           int lane) {
  const int add_end = ck_add_end<Pl::TN>(i0, g);
  const int sub_begin = ck_sub_begin(i0, g);
  for (int p = g.P - 1; p >= 0; --p) {
    if (p != g.P - 1) {
#pragma unroll
      for (int i = 0; i < Pl::R; ++i) d[i] <<= 7;
    }
    for (int sub = 0; sub < 2; ++sub) {
      if (sub) ck_negate(d);
      for (int c = sub ? sub_begin : 0; c < (sub ? g.C : add_end); ++c)
        for (int kt = 0; kt < g.ktiles; ++kt) {
          const uint8_t* st = r.ring + (size_t)cur.s * Pl::STAGE;
          if (CK_LOADS) mbar_wait(&r.full[cur.s], cur.ph);
          if (CK_MMAS) {
            const uint64_t da = sw128_desc(smem_addr(st + wg * 64 * CKW_BK));
            const uint64_t db = sw128_desc(smem_addr(st + Pl::A_BYTES));
            fence_regs(d);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < CKW_BK / 32; ++k)
              wgmma(d, da + 2 * k, db + 2 * k);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(d);
          }
          if (CK_LOADS) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&r.empty[cur.s]);
          }
          cur.next<Pl>();
        }
      if (sub) ck_negate(d);
    }
  }
}

// The tensor maps of one launch: x (B, C*P*ckp) in boxes of 128 K-bytes x
// 64 WG rows, wmt (UL, N+m, Jm) in boxes of 128 K-bytes x TN rows x LG
// limbs.  Encoded per launch (x is new every step); false where libcuda
// refuses them.
template <class Pl>
inline bool ck_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                    const void* wmt, const CkShape& g, int Jm) {
  const cuuint64_t xw = (cuuint64_t)g.C * g.P * g.ckp;
  const cuuint64_t xd[2] = {xw, (cuuint64_t)g.B};
  const cuuint64_t xs[1] = {xw};
  const cuuint32_t xb[2] = {CKW_BK, (cuuint32_t)Pl::ROWS};
  const cuuint64_t rows = (cuuint64_t)g.N + g.m;
  const cuuint64_t wd[3] = {(cuuint64_t)Jm, rows, (cuuint64_t)g.UL};
  const cuuint64_t ws[2] = {(cuuint64_t)Jm, rows * Jm};
  const cuuint32_t wb[3] = {CKW_BK, (cuuint32_t)Pl::TN, (cuuint32_t)Pl::LG};
  return encode_i8_map(xmap, x, 2, xd, xs, xb)
         && encode_i8_map(wmap, wmt, 3, wd, ws, wb);
}

// The epilogue of the kernels that add their folded products into an
// acc-filled output with 64-bit atomics (ck_dot64p_sacc.cu,
// ck_cmux_step64.cu; the launcher first copies acc into out on the same
// stream).  A block's LG stacked limb rows g0 .. g0 + LG - 1 of wmt are
// limbs g % L of polynomials u = g / L, and a group may straddle two (at
// L = 6, rows 4-7 are limbs 4, 5 of u = 0 and 0, 1 of u = 1): each limb's
// folded int32 is widened to int64 and shifted by 8 (g % L) + key_shift
// (shifts of 64 or more vanish), the limbs of one polynomial are summed in
// registers, and each sum lands with one atomicAdd per output.  Addition
// mod 2^64 commutes, so the bits do not depend on the order in which
// blocks land.  Rows past B are not stored.
struct CkAtomicOut {
  int64_t* out;
  int kp1, L, key_shift;
};

template <class Pl>
__device__ __forceinline__ void ck_add_atomic(const uint32_t (&d)[Pl::R],
                                              const CkShape& g,
                                              const CkAtomicOut& o, int i0,
                                              int b0, int g0, int wg, int wl,
                                              int lane) {
  // register 4j + e: row 16 wl + g4 + 8 (e >> 1), stacked column
  // n = 8j + 2 t4 + (e & 1), limb row n / TN, folded column n % TN
  constexpr int JT = Pl::TN / 8;
  const int g4 = lane >> 2, t4 = lane & 3;
  const size_t UN = (size_t)o.kp1 * g.N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = b0 + 64 * wg + 16 * wl + g4 + 8 * h;
    if (b >= g.B) continue;
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) {
      unsigned long long* row = reinterpret_cast<unsigned long long*>(
          o.out + (size_t)b * UN + i0 + 8 * jj + 2 * t4);
      uint64_t z0 = 0, z1 = 0;
      int cur = -1;
#pragma unroll
      for (int lg = 0; lg < Pl::LG; ++lg) {
        const int gi = g0 + lg;
        if (gi >= g.UL) break;
        const int u = gi / o.L, s = 8 * (gi - u * o.L) + o.key_shift;
        if (u != cur) {
          if (cur >= 0) {
            atomicAdd(row + (size_t)cur * g.N, (unsigned long long)z0);
            atomicAdd(row + (size_t)cur * g.N + 1, (unsigned long long)z1);
          }
          z0 = z1 = 0;
          cur = u;
        }
        if (s < 64) {
          z0 += (uint64_t)(int64_t)(int32_t)d[4 * (lg * JT + jj) + 2 * h] << s;
          z1 += (uint64_t)(int64_t)(int32_t)d[4 * (lg * JT + jj) + 2 * h + 1]
                << s;
        }
      }
      if (cur >= 0) {
        atomicAdd(row + (size_t)cur * g.N, (unsigned long long)z0);
        atomicAdd(row + (size_t)cur * g.N + 1, (unsigned long long)z1);
      }
    }
  }
}

// Copies acc into out on ``stream``: the first term of the atomic
// epilogue's sum, ordered before the kernel that adds the rest.
inline int ck_copy_acc(void* out, const void* acc, size_t bytes,
                       cudaStream_t stream) {
  return (int)cudaMemcpyAsync(out, acc, bytes, cudaMemcpyDeviceToDevice,
                              stream);
}

// Launches ``kernel`` on ``grid`` with the plan's threads and shared
// memory; returns the launch's cudaError_t.
template <class Pl, class... Params, class... Args>
inline int ck_launch(void (*kernel)(Params...), dim3 grid,
                     cudaStream_t stream, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Pl::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, Pl::THREADS, Pl::SMEM, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace tfhe
