// ck_dot64p_acc: the chunked-key contraction with the 64-bit limb
// recombination and the accumulator add inside, on Hopper.  x (B, C*P*ckp)
// int8 (rotate_decompose64_ck's chunk layout), wmt (kp1*L, N+m, Jm) int8
// (the K-packed chunked key of ChunkedEngine.prepare), acc / out
// (B, kp1*N) int64 (the native (B, k+1, N) Torus64 accumulator, the same
// bytes):
//
//   out[b, u*N + i] = acc[b, u*N + i]
//                     + sum_l fold(x . wmt[u*L + l])[b, i] << (8 l + key_shift)
//
// mod 2^64, fold as in ck_dot64p.cu (planes combined with << 7p).
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:ck_dot64p_acc.  Bound as
// ck_dot64p (int8 MACs on paper, the operand tiles' L2 traffic on the
// card), on the same mainloop (ck_wgmma.cuh: TMA into an mbarrier ring, int8
// wgmma with LG limbs stacked along N, TMA's zero fill as the window mask,
// one register set for every pass).  A block owns 64 folded columns of one
// polynomial u for 64 WG batch rows and loops over u's L limbs, LG at a
// time: each group's folded int32 lands in the one register set, is widened
// and added to a uint64 sum held in registers as
// (int64) fold << (8 l + key_shift), and the set is zeroed for the next
// group.  The epilogue adds acc and writes (B, kp1*N) int64 once; the
// per-limb int32 products of ck_dot64p, (U*L, B, N) in device memory, never
// exist.  Registers: 32 LG int32 accumulators and 32 uint64 sums (64 words)
// a consumer thread; -Xptxas -v (sm_90a): 168 at 128 rows and 2 limbs, 179
// at 64 rows and 2 limbs, 149 at 1 limb; no spills.  Limbs of a ragged last
// group that belong to the next polynomial are computed and not added.
// At CB_MXU B=256 the chosen plan (128 rows, 2 limbs) runs kp1 x N/64 x 2
// = 128 blocks of 288 threads, one wave on 132 SMs (one block an SM: a
// 7-stage ring of 32 KB stages), each walking 3 limb pairs x 33 windows x 5
// K tiles: 0.23 ms, about what its TMA loads alone take (PERF.md §6).
// Exact: each limb's int32 fold is bounded by J*(N+m)*|digit|*128 < 2^31,
// which the wrapper asserts; the uint64 sums wrap as the torus does.
#include "ck_wgmma.cuh"

namespace {

using namespace tfhe;

constexpr int TN = 64;                      // folded columns of a block

struct AccArgs {
  const int64_t* acc;
  int64_t* out;
  int kp1, L, key_shift;
};

// A consumer warp: its warpgroup's share of the mainloop for every limb
// group of polynomial u, folded into 64-bit sums, then acc + the sums.
template <class Pl>
__device__ __forceinline__ void ck_acc_consumer(const CkRing<Pl>& r,
                                                CkCursor& cur,
                                                const CkShape& g,
                                                const AccArgs& a, int i0,
                                                int b0, int u, int warp,
                                                int lane) {
  // z[4 jj + e] is row 16 wl + g4 + 8 (e >> 1), column 8 jj + 2 t4 + (e & 1)
  // of the block: limb 0's accumulator registers
  constexpr int Z = TN / 2;
  const int wg = warp >> 2, wl = warp & 3;
  uint64_t z[Z];
#pragma unroll
  for (int i = 0; i < Z; ++i) z[i] = 0;
  uint32_t d[Pl::R];
  for (int l0 = 0; l0 < a.L; l0 += Pl::LG) {
#pragma unroll
    for (int i = 0; i < Pl::R; ++i) d[i] = 0;
    if (CK_MAIN) ck_consume(d, r, cur, g, i0, wg, lane);
#pragma unroll
    for (int lg = 0; lg < Pl::LG; ++lg) {
      const int s = 8 * (l0 + lg) + a.key_shift;
      if (l0 + lg >= a.L || s >= 64) continue;   // next poly / vanishes
#pragma unroll
      for (int i = 0; i < Z; ++i)
        z[i] += (uint64_t)(int64_t)(int32_t)d[lg * Z + i] << s;
    }
  }

  const int g4 = lane >> 2, t4 = lane & 3;
  const size_t UN = (size_t)a.kp1 * g.N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = b0 + 64 * wg + 16 * wl + g4 + 8 * h;
    if (b >= g.B) continue;
#pragma unroll
    for (int jj = 0; jj < TN / 8; ++jj) {
      const size_t off = (size_t)b * UN + (size_t)u * g.N + i0 + 8 * jj
                         + 2 * t4;
      const longlong2 in = *reinterpret_cast<const longlong2*>(a.acc + off);
      const uint64_t s0 = (uint64_t)in.x + z[4 * jj + 2 * h];
      const uint64_t s1 = (uint64_t)in.y + z[4 * jj + 2 * h + 1];
      *reinterpret_cast<longlong2*>(a.out + off) =
          make_longlong2((long long)s0, (long long)s1);
    }
  }
}

template <class Pl>
__global__ void __launch_bounds__(Pl::THREADS, 1)
ck_dot64p_acc_kernel(__grid_constant__ const CUtensorMap xmap,
                     __grid_constant__ const CUtensorMap wmap,
                     const CkShape g, const AccArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const CkRing<Pl> r(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = blockIdx.x * TN, b0 = blockIdx.y * Pl::ROWS;
  const int u = blockIdx.z;
  r.init(tid);
  CkCursor cur;

  if (warp == 4 * Pl::WG) {                   // the producer warp
    if (CK_MAIN && CK_LOADS && lane == 0) {
      prefetch_map(&xmap);
      prefetch_map(&wmap);
      for (int l0 = 0; l0 < a.L; l0 += Pl::LG)
        ck_produce(r, cur, &xmap, &wmap, g, i0, b0, u * a.L + l0);
    }
  } else {
    ck_acc_consumer<Pl>(r, cur, g, a, i0, b0, u, warp, lane);
  }
}

template <int WG, int NN>
int launch(const void* x, const void* wmt, const AccArgs& a, const CkShape& g,
           int Jm, cudaStream_t stream) {
  using Pl = CkPlan<WG, TN, NN>;
  if (g.N % TN != 0) return (int)cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xmap, wmap;
  if (!ck_maps<Pl>(&xmap, &wmap, x, wmt, g, Jm))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(g.N / TN, (g.B + Pl::ROWS - 1) / Pl::ROWS, a.kp1);
  return ck_launch<Pl>(ck_dot64p_acc_kernel<Pl>, grid, stream, xmap, wmap, g,
                       a);
}

}  // namespace

// The plan: ``rows`` 64 or 128 (one or two consumer warpgroups) and
// ``limbs`` 1 or 2 limbs a pass set (kernels.ck_dot64p_acc_plan chooses);
// 64 folded columns a block.  N a multiple of 64, Jm a multiple of 16, P 1
// or 2.
extern "C" int tfhe_ck_dot64p_acc(const void* x, const void* wmt,
                                  const void* acc, void* out, int B, int N,
                                  int m, int Jm, int kp1, int L, int P,
                                  int ckp, int key_shift, int rows, int limbs,
                                  void* stream) {
  if (Jm % 16 != 0 || (P != 1 && P != 2) || N % m != 0)
    return (int)cudaErrorInvalidValue;
  const CkShape g{B, N, m, N / m, P, ckp, (Jm + CKW_BK - 1) / CKW_BK,
                  kp1 * L};
  const AccArgs a{(const int64_t*)acc, (int64_t*)out, kp1, L, key_shift};
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == 64 && limbs == 1) return launch<1, 64>(x, wmt, a, g, Jm, s);
  if (rows == 64 && limbs == 2) return launch<1, 128>(x, wmt, a, g, Jm, s);
  if (rows == 128 && limbs == 1) return launch<2, 64>(x, wmt, a, g, Jm, s);
  if (rows == 128 && limbs == 2) return launch<2, 128>(x, wmt, a, g, Jm, s);
  return (int)cudaErrorInvalidValue;
}
