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
// of 64): ck_kst.cuh's producer and mainloop (a block holds 64 key rows of
// 4 limb groups, read once, against a slice of 128 of the C*B (chunk,
// batch) rows stacked along M), with this file's epilogue: the block stages
// its rows as int32 in shared memory (the key's place, once every wgmma has
// read it) and adds each into out with one TMA reduction (out zeroed first
// on the same stream); the int32 additions commute mod 2^32 (a second pass
// that folds stored rows ran 1.5x slower, PERF.md §6).  At CB_ACTIVE B=4
// the grid is 33 x 4 = 132 blocks of 288 threads, one an SM, and the key is
// read once (17.3 MB), against ~1.08 GB of tiles from L2 in the
// output-stationary plan.
// Exact: every int32 sum is bounded by J*(N+m)*|digit|*128 < 2^31, which
// the wrapper asserts; partial sums wrap mod 2^32.
// Registers (-Xptxas -v, sm_90a): 154 (128 accumulators a consumer
// thread) in the output-stationary kernel, 168 in the key-stationary one;
// no spills.
#include "ck_kst.cuh"

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

}  // namespace

// ---- the key-stationary plan (ck_kst.cuh) ----

namespace tfhe {

// Its epilogue here: a staged row is [limb group][64] int32, the box of one
// TMA reduction, negated where its ring tile lies at or above N.
struct KstFoldOut {
  __device__ __forceinline__ void operator()(const uint32_t (&d)[KstPlan::R],
                                             const KstBlock& k,
                                             const CUtensorMap* omap,
                                             const CkShape& g) const {
    constexpr int WG = KstPlan::WG;
    const int warp = k.tid >> 5, lane = k.tid & 31;
    const int wg = warp >> 2, wl = warp & 3, g4 = lane >> 2, t4 = lane & 3;
    int32_t* stage = reinterpret_cast<int32_t*>(k.stage);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = 64 * wg + 16 * wl + g4 + 8 * h;
      const uint32_t neg = k.upper(rl, g) ? ~0u : 0u;
      int2* row = reinterpret_cast<int2*>(stage + (size_t)rl * KST_NN);
#pragma unroll
      for (int j = 0; j < KST_NN / 8; ++j)
        row[4 * j + t4] = make_int2((int)((d[4 * j + 2 * h] ^ neg) - neg),
                                    (int)((d[4 * j + 2 * h + 1] ^ neg) - neg));
    }
    fence_async_smem();
    named_sync(1, 128 * WG);
    if (k.tid < KstPlan::ROWS && k.r0 + k.tid < g.B * g.C) {  // a row each
      const int2 bc = k.target(k.tid, g);
      tma_reduce_add_3d(omap, stage + (size_t)k.tid * KST_NN, bc.y, bc.x,
                        k.g0);
      bulk_commit_wait_read();
    }
  }
};
static_assert(KST_NN * 4 == KST_STAGED_BYTES, "a staged row of int32 folds");

}  // namespace tfhe

namespace {

using namespace tfhe;

int launch_kst(const void* x, const void* wmt, void* out, const CkShape& g,
               int Jm, cudaStream_t stream) {
  int e = ck_kst_check(g);
  if (e != 0) return e;
  CUtensorMap xmap, wmap, omap;
  const cuuint64_t od[3] = {(cuuint64_t)g.N, (cuuint64_t)g.B,
                            (cuuint64_t)g.UL};
  const cuuint64_t os[2] = {(cuuint64_t)g.N * 4, (cuuint64_t)g.B * g.N * 4};
  const cuuint32_t ob[3] = {KST_TN, 1, KST_LG};
  if (!ck_kst_maps(&xmap, &wmap, x, wmt, g, Jm)
      || !encode_i32_map(&omap, out, 3, od, os, ob))
    return (int)cudaErrorInvalidValue;
  e = (int)cudaMemsetAsync(out, 0, (size_t)g.UL * g.B * g.N * 4, stream);
  if (e != 0) return e;
  return ck_kst_launch(xmap, wmap, omap, g, KstFoldOut{}, stream);
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
