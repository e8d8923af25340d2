// The key-stationary plan of the chunked-key contractions on Hopper: its
// producer and mainloop, shared by ck_dot64p.cu (per-limb int32 folds) and
// ck_dot64p_sacc.cu (the limbs recombined into the int64 accumulator), each
// of which brings its epilogue.
//
// A block owns one 64-row tile t of key rows, q in [64t, 64t + 64), of 4
// limb groups, loads it once into shared memory (J*m <= 768: at most 192 KB)
// and multiplies it with a slice of 128 of the digit rows stacked along M
// (two consumer warpgroups; TMA fills rows past C*B with zeros): stacked row
// rr = b*C + c of plane p is x[b, (c*P + p)*ckp : + J*m], row rr of x seen
// as (B*C, P*ckp), so one 2-D map loads a slice's rows a stage through a
// small ring (each further slice reads the key again).  The planes run
// highest first, Horner's shift by 7 in registers.  Accumulator (rr; g, q)
// belongs at ring position c*m + q; m a multiple of 64 puts a row's 64
// positions in one aligned ring tile, all below N (added) or all at or above
// it (negated, at c*m + 64t - N).  Once every wgmma has read the key, the
// epilogue stages its rows where the key was and adds each into the output
// with a TMA reduction, so each output receives about C + 1 contributions,
// one from each key tile that reaches it; the additions commute, so the bits
// do not depend on the order in which blocks land.
//
// Grid (key tiles (N+m)/64, limb groups ceil(UL/4), ceil(C*B/128) slices),
// 288 threads a block.  Exact: every int32 sum is bounded by
// J*(N+m)*|digit|*128 < 2^31, which the wrappers assert; partial sums wrap
// mod 2^32 and a tile's folded value is exact.
#pragma once

#include "ck_wgmma.cuh"

namespace tfhe {

constexpr int KST_TN = 64;                    // key rows of a block
constexpr int KST_LG = 4;                     // limb groups of a block
constexpr int KST_NN = KST_TN * KST_LG;       // the wgmma's N
constexpr int KST_KT_BYTES = KST_NN * CKW_BK; // a resident key K tile, 32 KB
constexpr int KST_STAGED_BYTES = 1024;        // the epilogues' staging a row
// the resident key's K tiles at most (J*m <= 768); kernels.KST_KTILES
// mirrors it (a test reads it here)
constexpr int KST_MAX_KTILES = 6;

struct KstPlan {
  static constexpr int WG = 2;                // consumer warpgroups
  static constexpr int ROWS = 64 * WG;        // stacked (chunk, batch) rows
  static constexpr int THREADS = 128 * WG + 32;
  static constexpr int A_BYTES = ROWS * CKW_BK;
  static constexpr int R = KST_NN / 2;        // int32 accumulators a thread

  // the resident key tiles, later the staged rows
  __host__ __device__ static constexpr size_t region(int ktiles) {
    return (size_t)ktiles * KST_KT_BYTES > (size_t)ROWS * KST_STAGED_BYTES
               ? (size_t)ktiles * KST_KT_BYTES
               : (size_t)ROWS * KST_STAGED_BYTES;
  }
  // digit stages beside the region and 1 KB of alignment slack, at most 8
  static constexpr int stages(int ktiles) {
    const long left = (long)CKW_MAX_SMEM - 1024 - (long)region(ktiles)
                      - 8L * ktiles;
    const long s = left / (A_BYTES + 2 * (long)sizeof(uint64_t));
    return s < CKW_MAX_STAGES ? (int)s : CKW_MAX_STAGES;
  }
  static size_t smem(int ktiles, int stages) {
    return 1024 + region(ktiles) + 8 * (size_t)ktiles
           + (size_t)stages * (A_BYTES + 2 * sizeof(uint64_t));
  }
};
static_assert(KstPlan::stages(KST_MAX_KTILES) >= 2
                  && KstPlan::stages(KST_MAX_KTILES + 1) < 2,
              "KST_MAX_KTILES is the most K tiles that leave a digit ring");

// What an epilogue is handed: the consumer thread's accumulators (register
// 4j + e: stacked row 16 wl + g4 + 8 (e >> 1) of warpgroup wg, column
// n = 8j + 2 t4 + (e & 1): limb group n / 64, key row 64 t + n % 64), the
// region it may stage in (at least ROWS * KST_STAGED_BYTES) and the block's
// place: key tile t, limb groups g0 .., stacked rows r0 ...  Its consumer
// threads (tid < 128 WG) sync on named barrier 1.
struct KstBlock {
  uint8_t* stage;
  int t, g0, r0, tid;

  // whether stacked row rl of the slice lies at or above N in the ring
  __device__ __forceinline__ bool upper(int rl, const CkShape& g) const {
    return ((r0 + rl) % g.C) * g.m + KST_TN * t >= g.N;
  }
  // (b, folded column) where stacked row r0 + rl's tile lands in out
  __device__ __forceinline__ int2 target(int rl, const CkShape& g) const {
    const int b = (r0 + rl) / g.C, c = (r0 + rl) - b * g.C;
    const int r = c * g.m + KST_TN * t;
    return make_int2(b, r >= g.N ? r - g.N : r);
  }
};

template <class Epi>
__global__ void __launch_bounds__(KstPlan::THREADS, 1)
ck_kst_kernel(__grid_constant__ const CUtensorMap xmap,
              __grid_constant__ const CUtensorMap wmap,
              __grid_constant__ const CUtensorMap omap, const CkShape g,
              int stages, const Epi epi) {
  using Pl = KstPlan;
  constexpr int WG = Pl::WG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* key = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = key + Pl::region(g.ktiles);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(ring
                                                + (size_t)stages * Pl::A_BYTES);
  uint64_t* full = kfull + g.ktiles;
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = blockIdx.x, g0 = blockIdx.y * KST_LG;
  const int r0 = blockIdx.z * Pl::ROWS;
  if (tid == 0) {
    for (int k = 0; k < g.ktiles; ++k) mbar_init(&kfull[k], 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * WG) {                       // the producer warp
    if (CK_MAIN && CK_LOADS && lane == 0) {
      prefetch_map(&xmap);
      prefetch_map(&wmap);
      int s = 0;
      uint32_t ph = 0;
      for (int p = g.P - 1; p >= 0; --p)
        for (int kt = 0; kt < g.ktiles; ++kt) {
          if (p == g.P - 1) {                 // each key tile once, in order
            mbar_arrive_tx(&kfull[kt], KST_KT_BYTES);
            tma_load_3d(key + (size_t)kt * KST_KT_BYTES, &wmap, &kfull[kt],
                        kt * CKW_BK, KST_TN * t, g0);
          }
          mbar_wait(&empty[s], ph ^ 1);
          mbar_arrive_tx(&full[s], Pl::A_BYTES);
          tma_load_2d(ring + (size_t)s * Pl::A_BYTES, &xmap, &full[s],
                      p * g.ckp + kt * CKW_BK, r0);
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
    }
    return;
  }

  const int wg = warp >> 2;
  uint32_t d[Pl::R];
#pragma unroll
  for (int i = 0; i < Pl::R; ++i) d[i] = 0;
  if (CK_MAIN) {
    int s = 0;
    uint32_t ph = 0;
    for (int p = g.P - 1; p >= 0; --p) {
      if (p != g.P - 1) {
#pragma unroll
        for (int i = 0; i < Pl::R; ++i) d[i] <<= 7;
      }
      for (int kt = 0; kt < g.ktiles; ++kt) {
        const uint8_t* st = ring + (size_t)s * Pl::A_BYTES;
        if (CK_LOADS) {
          if (p == g.P - 1) mbar_wait(&kfull[kt], 0);
          mbar_wait(&full[s], ph);
        }
        if (CK_MMAS) {
          const uint64_t da = sw128_desc(smem_addr(st + wg * 64 * CKW_BK));
          const uint64_t db =
              sw128_desc(smem_addr(key + (size_t)kt * KST_KT_BYTES));
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
          if (lane == 0) mbar_arrive(&empty[s]);
        }
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  }
  named_sync(1, 128 * WG);                    // every wgmma has read the key
  epi(d, KstBlock{key, t, g0, r0, tid}, &omap, g);
}

// The key-stationary plan's domain (kernels.ck_kst_ok): 0 or a cudaError_t.
inline int ck_kst_check(const CkShape& g) {
  if (g.m % KST_TN != 0 || g.N % KST_TN != 0 || g.ktiles > KST_MAX_KTILES)
    return (int)cudaErrorInvalidValue;
  return tensor_map_encoder() == nullptr ? (int)cudaErrorNotSupported : 0;
}

// The operands' maps: x seen as (B*C, P*ckp) in boxes of 128 K-bytes x 128
// stacked rows, wmt (UL, N+m, Jm) in boxes of 128 K-bytes x 64 rows x 4
// limb groups.
inline bool ck_kst_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                        const void* wmt, const CkShape& g, int Jm) {
  const cuuint64_t xw = (cuuint64_t)g.P * g.ckp;
  const cuuint64_t xd[2] = {xw, (cuuint64_t)g.B * g.C};
  const cuuint64_t xs[1] = {xw};
  const cuuint32_t xb[2] = {CKW_BK, (cuuint32_t)KstPlan::ROWS};
  const cuuint64_t wd[3] = {(cuuint64_t)Jm, (cuuint64_t)g.N + g.m,
                            (cuuint64_t)g.UL};
  const cuuint64_t ws[2] = {(cuuint64_t)Jm, ((cuuint64_t)g.N + g.m) * Jm};
  const cuuint32_t wb[3] = {CKW_BK, KST_TN, KST_LG};
  return encode_i8_map(xmap, x, 2, xd, xs, xb)
         && encode_i8_map(wmap, wmt, 3, wd, ws, wb);
}

// Launches the key-stationary kernel with epilogue ``epi`` on ``stream``,
// after the caller has checked the shape (ck_kst_check), encoded the maps
// and prepared the output on the same stream; returns the cudaError_t.
template <class Epi>
inline int ck_kst_launch(const CUtensorMap& xmap, const CUtensorMap& wmap,
                         const CUtensorMap& omap, const CkShape& g,
                         const Epi& epi, cudaStream_t stream) {
  using Pl = KstPlan;
  const int stages = Pl::stages(g.ktiles);
  const size_t smem = Pl::smem(g.ktiles, stages);
  auto kernel = ck_kst_kernel<Epi>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((g.N + g.m) / KST_TN, (g.UL + KST_LG - 1) / KST_LG,
                  (g.B * g.C + Pl::ROWS - 1) / Pl::ROWS);
  kernel<<<grid, Pl::THREADS, smem, stream>>>(xmap, wmap, omap, g, stages,
                                              epi);
  return (int)cudaGetLastError();
}

}  // namespace tfhe
