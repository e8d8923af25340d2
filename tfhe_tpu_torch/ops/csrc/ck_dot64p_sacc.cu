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
// Replaces tfhe_tpu/ops/pallas_kernels.py:ck_dot64p_sacc.  Bound by int8
// tensor-core MACs on paper, on the card by the L2 -> shared-memory traffic
// of the operand tiles, as ck_dot64p.  On the TPU the limb axis is an
// "arbitrary" grid dimension and the 64-bit sum is carried in VMEM scratch
// from one limb cell to the next; blocks on the GPU carry nothing between
// them.  Here the grid is ck_dot64p's: a block owns 64 folded columns of a
// group of LG = 4 consecutive limb rows of wmt (stacked along the wgmma's
// N: one m64n256k32 a k32 step) for 64 WG batch rows, on ck_wgmma.cuh's
// mainloop (TMA of x and wmt into an mbarrier ring, the window mask done by
// TMA's zero fill, every pass in one register set).  Its epilogue
// (ck_add_atomic) widens each limb's folded int32, shifts it by
// 8 (g mod L) + key_shift into polynomial g div L (a group may straddle
// two), sums the limbs of one polynomial in registers and adds the sum into
// out with one 64-bit atomicAdd, after the launcher has copied acc there on
// the same stream.  At CB_MXU B=256 (128 rows) that is 32 x 2 x 3 = 192
// blocks and two atomic adds per output (limbs 0-3, 4-5 of u = 0; 0-1,
// 2-5 of u = 1).  Exact: each limb's int32 fold is bounded by
// J*(N+m)*|digit|*128 < 2^31, which the wrapper asserts; the 64-bit sums
// wrap as the torus does.
// Registers: -Xptxas -v (sm_90a), PERF.md §6.
#include "ck_wgmma.cuh"

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

// ``rows`` 64 or 128 (one or two consumer warpgroups;
// kernels.ck_dot64p_sacc_plan chooses, as for ck_dot64p's output-stationary
// plan), 64 folded columns of 4 limb rows a block.
// N a multiple of 64, Jm a multiple of 16, P 1 or 2.
extern "C" int tfhe_ck_dot64p_sacc(const void* x, const void* wmt,
                                   const void* acc, void* out, int B, int N,
                                   int m, int Jm, int kp1, int L, int P,
                                   int ckp, int key_shift, int rows,
                                   void* stream) {
  if (Jm % 16 != 0 || (P != 1 && P != 2) || N % m != 0)
    return (int)cudaErrorInvalidValue;
  const CkShape g{B, N, m, N / m, P, ckp, (Jm + CKW_BK - 1) / CKW_BK,
                  kp1 * L};
  const CkAtomicOut o{(int64_t*)out, kp1, L, key_shift};
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == 64) return launch<1>(x, wmt, acc, o, g, Jm, s);
  if (rows == 128) return launch<2>(x, wmt, acc, o, g, Jm, s);
  return (int)cudaErrorInvalidValue;
}
