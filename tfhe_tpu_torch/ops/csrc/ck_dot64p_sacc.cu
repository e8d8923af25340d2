// ck_dot64p_sacc: ck_dot64p_acc's function with the limb axis in the grid,
// on Hopper.  x (B, C*P*ckp) int8 (rotate_decompose64_ck's chunk layout),
// wmt (kp1*L, N+m, Jm) int8 (the K-packed chunked key of
// ChunkedEngine.prepare), acc / out (B, kp1*N) int64 (the native
// (B, k+1, N) Torus64 accumulator, the same bytes):
//
//   out[b, u*N + i] = acc[b, u*N + i]
//                     + sum_l fold(x . wmt[u*L + l])[b, i] << (8 l + key_shift)
//
// mod 2^64, fold as in ck_dot64p.cu (planes combined with << 7p).
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:ck_dot64p_sacc.  On the TPU the
// limb axis is an "arbitrary" grid dimension and the 64-bit sum is carried
// in VMEM scratch from one limb cell to the next; blocks on the GPU carry
// nothing between them.  Two plans here, ck_dot64p's
// (kernels.ck_dot64p_plan chooses from C*B, by the rule ck_dot64p takes),
// each with the limb recombination and the accumulator add in its
// epilogue, after the launcher has copied acc into out on the same stream:
//
// Output-stationary (64 or 128 batch rows), bound by int8 tensor-core MACs
// on paper, on the card by the L2 -> shared-memory traffic of the operand
// tiles: a block owns 64 folded columns of a group of LG = 4 consecutive
// limb rows of wmt (stacked along the wgmma's N: one m64n256k32 a k32 step)
// for 64 WG batch rows, on ck_wgmma.cuh's mainloop.  Its epilogue
// (ck_add_atomic) widens each limb's folded int32, shifts it by
// 8 (g mod L) + key_shift into polynomial g div L (a group may straddle
// two), sums the limbs of one polynomial in registers and adds the sum into
// out with one 64-bit atomicAdd.  At CB_MXU B=256 (128 rows) that is
// 32 x 2 x 3 = 192 blocks and two atomic adds per output (limbs 0-3, 4-5 of
// u = 0; 0-1, 2-5 of u = 1).
//
// Key-stationary (up to kernels.KST_ROWS stacked rows C*B, m a multiple of
// 64, J*m <= 768), bound by the key's bytes: ck_kst.cuh's producer and
// mainloop (a block holds 64 key rows of 4 limb groups, read once, against
// a slice of 128 stacked (chunk, batch) rows).  Its epilogue widens and
// shifts the 4 limbs of a stacked row as above, sums those of one
// polynomial, negates the sum where the row's ring tile lies at or above N,
// stages it as 64 int64 in shared memory (one staged row per polynomial: a
// group straddles two at L = 6) and adds each staged row into out with one
// TMA reduction over a uint64 map (addition mod 2^64).  Each output thus
// takes 2 int64 contributions a key tile at L = 8, where ck_dot64p's kst
// plan adds 8 int32 limb rows' worth, and the int32 products never reach
// device memory.
//
// Exact: each limb's int32 fold is bounded by J*(N+m)*|digit|*128 < 2^31,
// which the wrapper asserts, so a tile's partial fold is its true value
// and the widened partials sum to the widened fold; the 64-bit sums wrap as
// the torus does, and they commute, so the bits do not depend on the order
// in which blocks land.
// Registers (-Xptxas -v, sm_90a): 162 and 163 in the output-stationary
// kernels, 159 in the key-stationary one (no spills; the two-pass epilogue
// of L = 1 spills 176 bytes).
#include "ck_kst.cuh"

namespace {

using namespace tfhe;

template <class Pl>
__global__ void __launch_bounds__(Pl::THREADS, 1)
ck_dot64p_sacc_kernel(__grid_constant__ const CUtensorMap xmap,
                      __grid_constant__ const CUtensorMap wmap,
                      const CkShape g, const CkAtomicOut o) {
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
    return;
  }
  uint32_t d[Pl::R];
#pragma unroll
  for (int i = 0; i < Pl::R; ++i) d[i] = 0;
  if (CK_MAIN) ck_consume(d, r, cur, g, i0, warp >> 2, lane);
  ck_add_atomic<Pl>(d, g, o, i0, b0, g0, warp >> 2, warp & 3, lane);
}

template <int WG>
int launch(const void* x, const void* wmt, const void* acc,
           const CkAtomicOut& o, const CkShape& g, int Jm,
           cudaStream_t stream) {
  using Pl = CkPlan<WG, 64, 256>;
  if (g.N % Pl::TN != 0) return (int)cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xmap, wmap;
  if (!ck_maps<Pl>(&xmap, &wmap, x, wmt, g, Jm))
    return (int)cudaErrorInvalidValue;
  const int e = ck_copy_acc(o.out, acc, (size_t)g.B * o.kp1 * g.N * 8,
                            stream);
  if (e != 0) return e;
  const dim3 grid(g.N / Pl::TN, (g.B + Pl::ROWS - 1) / Pl::ROWS,
                  (g.UL + Pl::LG - 1) / Pl::LG);
  return ck_launch<Pl>(ck_dot64p_sacc_kernel<Pl>, grid, stream, xmap, wmap,
                       g, o);
}

}  // namespace

// ---- the key-stationary plan (ck_kst.cuh) ----

namespace tfhe {

// Its epilogue here: out (B, kp1*N) int64 through a uint64 map in boxes of
// one 64-column row.  The block's limb rows g0 .. g0 + 3 belong to one or
// two polynomials where L >= 2: a thread sums each of its stacked rows'
// limbs by polynomial in registers, consuming each accumulator once, and
// stages the sums in two slots of ROWS x 64 int64, one TMA reduction a
// staged row.  At L = 1 (four polynomials a block) PASSES = 2 takes two
// polynomials a pass, the slots reused after a barrier (the accumulators
// then stay live across the passes, and spill).
template <int PASSES>
struct KstAccOut {
  int L, key_shift;

  __device__ __forceinline__ void operator()(const uint32_t (&d)[KstPlan::R],
                                             const KstBlock& k,
                                             const CUtensorMap* omap,
                                             const CkShape& g) const {
    constexpr int WG = KstPlan::WG, ROWS = KstPlan::ROWS;
    const int warp = k.tid >> 5, lane = k.tid & 31;
    const int wg = warp >> 2, wl = warp & 3, g4 = lane >> 2, t4 = lane & 3;
    const int last = min(k.g0 + KST_LG, g.UL) - 1;
    const int ua = k.g0 / L, ub = last / L;
    uint64_t* stage = reinterpret_cast<uint64_t*>(k.stage);
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int u0 = ua + 2 * pass;           // slot 0's polynomial
      if (u0 > ub) break;
      if (pass > 0) named_sync(1, 128 * WG);  // the last pass's reads done
      // limb row g0 + lg's slot (-1: another pass's polynomial, past UL,
      // or shifted out of the 64 bits) and shift
      int sl[KST_LG], sh[KST_LG];
#pragma unroll
      for (int lg = 0; lg < KST_LG; ++lg) {
        const int gi = k.g0 + lg, u = gi / L;
        sh[lg] = 8 * (gi - u * L) + key_shift;
        sl[lg] = gi <= last && sh[lg] < 64 && u >= u0 && u < u0 + 2
                     ? u - u0 : -1;
        if (sl[lg] < 0) sh[lg] = 0;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 64 * wg + 16 * wl + g4 + 8 * h;
        const uint64_t neg = k.upper(rl, g) ? ~0ull : 0ull;
        ulonglong2* row0 = reinterpret_cast<ulonglong2*>(
            stage + (size_t)rl * KST_TN + 2 * t4);
        ulonglong2* row1 = row0 + (size_t)ROWS * KST_TN / 2;
#pragma unroll
        for (int jj = 0; jj < KST_TN / 8; ++jj) {
          uint64_t a0 = 0, a1 = 0, b0 = 0, b1 = 0;
#pragma unroll
          for (int lg = 0; lg < KST_LG; ++lg) {
            const int i = 4 * (8 * lg + jj) + 2 * h;
            const uint64_t v0 = (uint64_t)(int64_t)(int32_t)d[i] << sh[lg];
            const uint64_t v1 = (uint64_t)(int64_t)(int32_t)d[i + 1]
                                << sh[lg];
            if (sl[lg] == 0) {
              a0 += v0;
              a1 += v1;
            } else if (sl[lg] == 1) {
              b0 += v0;
              b1 += v1;
            }
          }
          row0[4 * jj] = make_ulonglong2((a0 ^ neg) - neg, (a1 ^ neg) - neg);
          row1[4 * jj] = make_ulonglong2((b0 ^ neg) - neg, (b1 ^ neg) - neg);
        }
      }
      fence_async_smem();
      named_sync(1, 128 * WG);
      if (k.tid < ROWS && k.r0 + k.tid < g.B * g.C) {  // a row each
        const int2 bc = k.target(k.tid, g);
        tma_reduce_add_2d(omap, stage + (size_t)k.tid * KST_TN,
                          u0 * g.N + bc.y, bc.x);
        if (u0 < ub)
          tma_reduce_add_2d(omap, stage + (size_t)(ROWS + k.tid) * KST_TN,
                            (u0 + 1) * g.N + bc.y, bc.x);
        bulk_commit_wait_read();
      }
    }
  }
};
static_assert(2 * KST_TN * 8 <= KST_STAGED_BYTES,
              "two slots of 64 int64 a row");

}  // namespace tfhe

namespace {

using namespace tfhe;

int launch_kst(const void* x, const void* wmt, const void* acc,
               const CkAtomicOut& o, const CkShape& g, int Jm,
               cudaStream_t stream) {
  int e = ck_kst_check(g);
  if (e != 0) return e;
  CUtensorMap xmap, wmap, omap;
  const cuuint64_t UN = (cuuint64_t)o.kp1 * g.N;
  const cuuint64_t od[2] = {UN, (cuuint64_t)g.B};
  const cuuint64_t os[1] = {UN * 8};
  const cuuint32_t ob[2] = {KST_TN, 1};
  if (!ck_kst_maps(&xmap, &wmap, x, wmt, g, Jm)
      || !encode_u64_map(&omap, o.out, 2, od, os, ob))
    return (int)cudaErrorInvalidValue;
  e = ck_copy_acc(o.out, acc, (size_t)g.B * UN * 8, stream);
  if (e != 0) return e;
  if (o.L >= 2)                               // one or two polynomials
    return ck_kst_launch(xmap, wmap, omap, g, KstAccOut<1>{o.L, o.key_shift},
                         stream);
  return ck_kst_launch(xmap, wmap, omap, g, KstAccOut<2>{o.L, o.key_shift},
                       stream);
}

}  // namespace

// ``kst`` 0 for the output-stationary plan (64 folded columns of 4 limb
// rows a block, ``rows`` 64 or 128: one or two consumer warpgroups), 1 for
// the key-stationary one (64 key rows of 4 limb rows a block, ``rows`` 128
// of the C*B stacked rows; m a multiple of 64, J*m at most 768), as
// tfhe_ck_dot64p's; kernels.ck_dot64p_plan chooses.  N a multiple of
// 64, Jm a multiple of 16, P 1 or 2.
extern "C" int tfhe_ck_dot64p_sacc(const void* x, const void* wmt,
                                   const void* acc, void* out, int B, int N,
                                   int m, int Jm, int kp1, int L, int P,
                                   int ckp, int key_shift, int rows,
                                   int kst, void* stream) {
  if (Jm % 16 != 0 || (P != 1 && P != 2) || N % m != 0)
    return (int)cudaErrorInvalidValue;
  const CkShape g{B, N, m, N / m, P, ckp, (Jm + CKW_BK - 1) / CKW_BK,
                  kp1 * L};
  const CkAtomicOut o{(int64_t*)out, kp1, L, key_shift};
  cudaStream_t s = (cudaStream_t)stream;
  if (kst) {
    if (rows != KstPlan::ROWS) return (int)cudaErrorInvalidValue;
    return launch_kst(x, wmt, acc, o, g, Jm, s);
  }
  if (rows == 64) return launch<1>(x, wmt, acc, o, g, Jm, s);
  if (rows == 128) return launch<2>(x, wmt, acc, o, g, Jm, s);
  return (int)cudaErrorInvalidValue;
}
