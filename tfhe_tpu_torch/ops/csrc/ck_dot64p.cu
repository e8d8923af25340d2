// ck_dot64p: the chunked-key negacyclic contraction with per-limb int32
// outputs, on Hopper.  x (B, C*P*ckp) int8 (rotate_decompose64_ck's chunk
// layout), wmt (UL, N+m, Jm) int8, the K-packed chunked key
// (ChunkedEngine.prepare: wmt[g, q, (j,s)] = wm[g, (j,s), q] = limb[q - s]),
// out (UL, B, N) int32:
//
//   ring[g, b, c*m + q] += sum_p (x[b, (c*P+p)*ckp : +Jm] . wmt[g, q, :]) << 7p
//   out[g, b, i]         = ring[g, b, i] - ring[g, b, N + i]      (X^N = -1)
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:ck_dot64p.  Bound by int8
// tensor-core MACs on paper at large batches, by the key's bytes at small
// ones.  The TPU kernel multiplies each chunk against the whole (N+m)-wide
// key and adds the result into a 2N ring in VMEM.  Two plans here
// (kernels.ck_dot64p_plan chooses from C*B):
//
// Output-stationary (64 or 128 batch rows): a block owns 64 folded output
// columns of 4 limb groups (stacked along the wgmma's N, so each k32 step is
// one m64n256k32) for 64 WG batch rows and runs, per plane, the C + 1
// (m >= 64) or more chunk windows that reach them: ck_wgmma.cuh's mainloop
// (TMA into an mbarrier ring, the window mask done by TMA's zero fill,
// every pass in one register set).  The epilogue writes each folded int32
// once; the 2N ring never exists.  Above 64 rows two warpgroups of a
// 128-row block share each key tile, which halves the key traffic and the
// blocks.  Every window reloads its key tile from L2: at CB_MXU B=256 (128
// rows) 192 blocks of 288 threads move 1.52 GB of tiles, 0.23 ms, about
// what its TMA loads alone take (PERF.md §6); that traffic does not shrink
// with B, so below 64 rows most of it feeds zero rows.
//
// Key-stationary (up to kernels.KST_ROWS stacked rows C*B, m a multiple
// of 64): a block owns one 64-row tile t of key rows, q in [64t, 64t + 64),
// of 4 limb groups, loads it once into shared memory (J*m <= 768: at most
// 192 KB) and multiplies it with a slice of 128 of the digit rows
// stacked along M (two consumer warpgroups; TMA fills rows past C*B with
// zeros): stacked row rr = b*C + c of plane p is x[b, (c*P + p)*ckp
// : + J*m], row rr of x seen as (B*C, P*ckp), so one 2-D map loads a slice's
// rows a stage through a small ring (each further slice reads the key
// again).  The planes run highest first, Horner's shift by 7 in
// registers.  Accumulator (rr; g, q) belongs at ring position c*m + q; m a
// multiple of 64 puts a row's 64 positions in one aligned ring tile, all
// below N (added) or all at or above it (negated, at c*m + 64t - N).  The
// block stages its rows in shared memory (the key's place, once every
// wgmma has read it) and adds each into out with one TMA reduction (out
// zeroed first on the same stream): each output receives about C + 1
// contributions, one from each key tile that reaches it, and the int32
// additions commute mod 2^32, so the bits do not depend on the order in
// which blocks land (a second pass that folds stored rows ran 1.5x slower,
// PERF.md §6).  At CB_ACTIVE B=4 the grid is 33 x 4 = 132 blocks of 288
// threads, one an SM, and the key is read once (17.3 MB), against ~1.08 GB
// of tiles from L2 in the output-stationary plan.
// Exact: every int32 sum is bounded by J*(N+m)*|digit|*128 < 2^31, which
// the wrapper asserts; partial sums wrap mod 2^32.
// Registers (-Xptxas -v, sm_90a): 154 (128 accumulators a consumer
// thread) in the output-stationary kernel, 168 in the key-stationary one;
// no spills.
#include "ck_wgmma.cuh"

namespace {

using namespace tfhe;

// A consumer warp: its warpgroup's share of the mainloop, then its folded
// int32 outputs.
template <class Pl>
__device__ __forceinline__ void ck_dot64p_consumer(const CkRing<Pl>& r,
                                                   CkCursor& cur,
                                                   const CkShape& g,
                                                   int32_t* __restrict__ out,
                                                   int i0, int b0, int g0,
                                                   int warp, int lane) {
  const int wg = warp >> 2, wl = warp & 3;
  uint32_t d[Pl::R];
#pragma unroll
  for (int i = 0; i < Pl::R; ++i) d[i] = 0;
  if (CK_MAIN) ck_consume(d, r, cur, g, i0, wg, lane);

  // register 4j + e: row 16 wl + g4 + 8 (e >> 1), stacked column
  // n = 8j + 2 t4 + (e & 1), limb n / TN, folded column n % TN
  const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = b0 + 64 * wg + 16 * wl + g4 + 8 * h;
    if (b >= g.B) continue;
#pragma unroll
    for (int j = 0; j < Pl::NN / 8; ++j) {
      const int lg = 8 * j / Pl::TN, col = 8 * j % Pl::TN + 2 * t4;
      if (g0 + lg >= g.UL) continue;
      const size_t off = ((size_t)(g0 + lg) * g.B + b) * g.N + i0 + col;
      *reinterpret_cast<int2*>(out + off) =
          make_int2((int)d[4 * j + 2 * h], (int)d[4 * j + 2 * h + 1]);
    }
  }
}

template <class Pl>
__global__ void __launch_bounds__(Pl::THREADS, 1)
ck_dot64p_kernel(__grid_constant__ const CUtensorMap xmap,
                 __grid_constant__ const CUtensorMap wmap, const CkShape g,
                 int32_t* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  const CkRing<Pl> r(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = blockIdx.x * Pl::TN, b0 = blockIdx.y * Pl::ROWS;
  const int g0 = blockIdx.z * Pl::LG;
  r.init(tid);
  CkCursor cur;

  if (warp == 4 * Pl::WG) {                   // the producer warp
    if (CK_MAIN && CK_LOADS && lane == 0) {
      prefetch_map(&xmap);
      prefetch_map(&wmap);
      ck_produce(r, cur, &xmap, &wmap, g, i0, b0, g0);
    }
  } else {
    ck_dot64p_consumer<Pl>(r, cur, g, out, i0, b0, g0, warp, lane);
  }
}

template <int WG>
int launch(const void* x, const void* wmt, void* out, const CkShape& g,
           int Jm, cudaStream_t stream) {
  using Pl = CkPlan<WG, 64, 256>;
  if (g.N % Pl::TN != 0) return (int)cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xmap, wmap;
  if (!ck_maps<Pl>(&xmap, &wmap, x, wmt, g, Jm))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(g.N / Pl::TN, (g.B + Pl::ROWS - 1) / Pl::ROWS,
                  (g.UL + Pl::LG - 1) / Pl::LG);
  return ck_launch<Pl>(ck_dot64p_kernel<Pl>, grid, stream, xmap, wmap, g,
                       (int32_t*)out);
}

// ---- the key-stationary plan ----

constexpr int KST_TN = 64;                    // key rows of a block
constexpr int KST_LG = 4;                     // limb groups of a block
constexpr int KST_NN = KST_TN * KST_LG;       // the wgmma's N
constexpr int KST_KT_BYTES = KST_NN * CKW_BK; // a resident key K tile, 32 KB
constexpr int KST_ROW_BYTES = KST_NN * 4;     // a staged int32 row, 1 KB
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
    return (size_t)ktiles * KST_KT_BYTES > (size_t)ROWS * KST_ROW_BYTES
               ? (size_t)ktiles * KST_KT_BYTES
               : (size_t)ROWS * KST_ROW_BYTES;
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

// A block: key tile blockIdx.x (rows 64 t ..) of limb groups 4 blockIdx.y ..
// against stacked rows ROWS blockIdx.z ..; its rows reduced into out.
__global__ void __launch_bounds__(KstPlan::THREADS, 1)
ck_dot64p_kst_kernel(__grid_constant__ const CUtensorMap xmap,
                     __grid_constant__ const CUtensorMap wmap,
                     __grid_constant__ const CUtensorMap omap,
                     const CkShape g, int stages) {
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

  const int wg = warp >> 2, wl = warp & 3;
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

  // The epilogue.  Register 4j + e: stacked row 16 wl + g4 + 8 (e >> 1) of
  // the warpgroup, column n = 8j + 2 t4 + (e & 1): limb group n / 64, key
  // row 64 t + n % 64.  A staged row is [limb group][64] int32, the box of
  // one TMA reduction, negated where its ring tile lies at or above N.
  named_sync(1, 128 * WG);                    // every wgmma has read the key
  int32_t* stage = reinterpret_cast<int32_t*>(key);
  const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = 64 * wg + 16 * wl + g4 + 8 * h;
    const int c = (r0 + rl) % g.C;
    const uint32_t neg = c * g.m + KST_TN * t >= g.N ? ~0u : 0u;
    int2* row = reinterpret_cast<int2*>(stage + (size_t)rl * KST_NN);
#pragma unroll
    for (int j = 0; j < KST_NN / 8; ++j)
      row[4 * j + t4] = make_int2((int)((d[4 * j + 2 * h] ^ neg) - neg),
                                  (int)((d[4 * j + 2 * h + 1] ^ neg) - neg));
  }
  fence_async_smem();
  named_sync(1, 128 * WG);
  if (tid < Pl::ROWS && r0 + tid < g.B * g.C) {  // a thread a stacked row
    const int b = (r0 + tid) / g.C, c = (r0 + tid) - b * g.C;
    const int r = c * g.m + KST_TN * t;
    tma_reduce_add_3d(&omap, stage + (size_t)tid * KST_NN,
                      r >= g.N ? r - g.N : r, b, g0);
    bulk_commit_wait_read();
  }
}

int launch_kst(const void* x, const void* wmt, void* out, const CkShape& g,
               int Jm, cudaStream_t stream) {
  using Pl = KstPlan;
  if (g.m % KST_TN != 0 || g.N % KST_TN != 0)
    return (int)cudaErrorInvalidValue;
  if (g.ktiles > KST_MAX_KTILES) return (int)cudaErrorInvalidValue;
  const int stages = Pl::stages(g.ktiles);
  if (tensor_map_encoder() == nullptr) return (int)cudaErrorNotSupported;
  const int T = (g.N + g.m) / KST_TN, GZ = (g.UL + KST_LG - 1) / KST_LG;
  const int rows = g.B * g.C;
  CUtensorMap xmap, wmap, omap;
  const cuuint64_t xw = (cuuint64_t)g.P * g.ckp;
  const cuuint64_t xd[2] = {xw, (cuuint64_t)rows};
  const cuuint64_t xs[1] = {xw};
  const cuuint32_t xb[2] = {CKW_BK, (cuuint32_t)Pl::ROWS};
  const cuuint64_t wd[3] = {(cuuint64_t)Jm, (cuuint64_t)g.N + g.m,
                            (cuuint64_t)g.UL};
  const cuuint64_t ws[2] = {(cuuint64_t)Jm, ((cuuint64_t)g.N + g.m) * Jm};
  const cuuint32_t wb[3] = {CKW_BK, KST_TN, KST_LG};
  const cuuint64_t od[3] = {(cuuint64_t)g.N, (cuuint64_t)g.B,
                            (cuuint64_t)g.UL};
  const cuuint64_t os[2] = {(cuuint64_t)g.N * 4, (cuuint64_t)g.B * g.N * 4};
  const cuuint32_t ob[3] = {KST_TN, 1, KST_LG};
  if (!encode_i8_map(&xmap, x, 2, xd, xs, xb)
      || !encode_i8_map(&wmap, wmt, 3, wd, ws, wb)
      || !encode_i32_map(&omap, out, 3, od, os, ob))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)g.UL * g.B * g.N * 4,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  auto kernel = ck_dot64p_kst_kernel;
  const size_t smem = Pl::smem(g.ktiles, stages);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(T, GZ, (rows + Pl::ROWS - 1) / Pl::ROWS);
  kernel<<<grid, Pl::THREADS, smem, stream>>>(xmap, wmap, omap, g, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// ``kst`` 0 for the output-stationary plan (64 folded columns of 4 limb
// groups a block, ``rows`` 64 or 128: one or two consumer warpgroups), 1
// for the key-stationary one (64 key rows of 4 limb groups a block, ``rows``
// 128 of the C*B stacked rows; m a multiple of 64, J*m at most 768).
// kernels.ck_dot64p_plan chooses.  N a multiple of 64, Jm a multiple of 16
// (the key's row stride for TMA), P 1 or 2.
extern "C" int tfhe_ck_dot64p(const void* x, const void* wmt, void* out,
                              int B, int N, int m, int Jm, int UL, int P,
                              int ckp, int rows, int kst, void* stream) {
  if (Jm % 16 != 0 || (P != 1 && P != 2) || N % m != 0)
    return (int)cudaErrorInvalidValue;
  const CkShape g{B, N, m, N / m, P, ckp, (Jm + CKW_BK - 1) / CKW_BK, UL};
  cudaStream_t s = (cudaStream_t)stream;
  if (kst) {
    if (rows != KstPlan::ROWS) return (int)cudaErrorInvalidValue;
    return launch_kst(x, wmt, out, g, Jm, s);
  }
  if (rows == 64) return launch<1>(x, wmt, out, g, Jm, s);
  if (rows == 128) return launch<2>(x, wmt, out, g, Jm, s);
  return (int)cudaErrorInvalidValue;
}
