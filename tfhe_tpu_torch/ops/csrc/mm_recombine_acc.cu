// mm_recombine_acc: out = acc + sum_l (x @ W_l) << (8 l + shift_base),
// mod 2^32, on the K-packed key wt (L, UN, K) int8, wt[l, c, k] = W[l, k, c]
// (materialize_w.cu's second entry, materialize_wt).  x (B, K) int8, acc /
// out (B, UN) int32.
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:mm_recombine_acc.  Bound on paper
// by int8 tensor-core MACs (B*K*UN*L) at large B and by the key stream
// (L*K*UN bytes) at small B; on the card by the L2 -> shared-memory traffic
// of the operand tiles, which an output tile of R rows x C columns x L limbs
// reloads for every K slice: R*K + C*L*K bytes for R*C*L*K MACs.  So:
//   * Both operands K-major, loaded by TMA with the 128-byte swizzle into
//     ck_wgmma.cuh's mbarrier ring of 128-deep K stages (CkPlan, CkRing): a
//     box of 64 WG rows x 128 bytes of x and one of L limbs x 64 columns x
//     128 bytes of wt.  One producer warp; no thread touches an operand
//     byte, and nothing is transposed.
//   * The L limbs' 64-column boxes stacked along the instruction's N: one
//     m64n(64L)k32 per k32 step and consumer warpgroup (128 int32
//     accumulators a thread at L = 4), so each thread holds every limb of
//     the same outputs, and acc + sum_l C_l << (8 l + shift) is one
//     register epilogue.
//   * WG = 2 consumer warpgroups a block (128 rows x 64 columns x L limbs,
//     ~87 MACs a byte at L = 4, against the 64 x 128 mma.sync tile's 58);
//     WG = 1 at 64 rows or fewer, where a second warpgroup would multiply
//     zeros.
//   * Persistent: one block an SM walks the work units (row tile, column
//     tile, K slice) in a grouped order, GROUP row tiles at a time with the
//     row tile fastest: the units in flight share a few key strips (1.5 MB
//     each at GATE_DEFAULT) and the group's x rows (12.6 MB), so both stay
//     in L2 and each key strip leaves device memory once a group, where
//     the column-fastest grid reread the whole key for every row strip
//     (groups of 8 to 64 row tiles measured within 3%, PERF.md §6).  The
//     producer runs into the next unit's stages while the consumers store
//     the last one.
//   * One wgmma group in flight: a stage's group is issued, the one before
//     it waited for, and that stage released.
//   * K split (the plan's S, from the shape and the SM count:
//     kernels.mm_recombine_acc_plan): S slices of ceil(ktiles / S) stages
//     (split_plan), so narrow batches still fill the card.  With S > 1 the
//     entry copies acc into out first and every unit adds its recombined
//     slice with red.global.add.u32 (exact: addition mod 2^32 commutes).
// TMA fills box elements outside the tensors with zeros: the batch tail,
// and the K tail where K is not a multiple of 128.
// On the card (PERF.md §6): 0.565 ms at GATE_DEFAULT B=8192 (74% of the
// operation bound), between its TMA loads alone (0.61) and its wgmmas alone
// (0.53); a 2-CTA cluster multicasting the key measured slower (1.00).
// Registers (-Xptxas -v, sm_90a): 157 at L = 4 and 128 rows; no spills.
// Exact: one limb's int32 dot is bounded by K * 128 * 128 < 2^31 for K <
// 2^17; the recombination runs in uint32, where wrap-around is the torus's.
#include "ck_wgmma.cuh"

namespace {

using namespace tfhe;

constexpr int COLS = 64;                  // output columns of a unit, a limb
constexpr int GROUP = 16;                 // row tiles of a group

struct MmShape {
  const int32_t* acc;
  int32_t* out;
  int B, UN, shift, ktiles, slice, S, RT, CT, units;
};

// (slice length, slices) of a K walk of ``steps`` stages cut ``split`` ways:
// slices of ceil(steps / split) stages, the last one ragged; a split that
// would leave a slice empty takes fewer slices (kernels.split_plan).
void split_plan(int steps, int split, int* len, int* slices) {
  if (split > steps) split = steps;
  if (split < 1) split = 1;
  *len = (steps + split - 1) / split;
  *slices = (steps + *len - 1) / *len;
}

// Work unit u: its row tile, column tile and K stages [k0, k1).
struct Unit {
  int rt, ct, k0, k1;
  __device__ __forceinline__ Unit(int u, const MmShape& g) {
    const int per_group = GROUP * g.CT * g.S;
    const int grp = u / per_group, w = u - grp * per_group;
    const int gm = min(GROUP, g.RT - grp * GROUP);
    rt = grp * GROUP + w % gm;
    const int cs = w / gm, sl = cs % g.S;
    ct = cs / g.S;
    k0 = sl * g.slice;
    k1 = min(g.ktiles, k0 + g.slice);
  }
};

template <class Pl>
__device__ __forceinline__ void produce(const CkRing<Pl>& r,
                                        const CUtensorMap* xmap,
                                        const CUtensorMap* wmap,
                                        const MmShape& g) {
  CkCursor cur;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit t(u, g);
    for (int kt = t.k0; kt < t.k1; ++kt) {
      mbar_wait(&r.empty[cur.s], cur.ph ^ 1);
      uint8_t* st = r.ring + (size_t)cur.s * Pl::STAGE;
      mbar_arrive_tx(&r.full[cur.s], Pl::STAGE);
      tma_load_2d(st, xmap, &r.full[cur.s], kt * CKW_BK, t.rt * Pl::ROWS);
      tma_load_3d(st + Pl::A_BYTES, wmap, &r.full[cur.s], kt * CKW_BK,
                  t.ct * COLS, 0);
      cur.next<Pl>();
    }
  }
}

// acc + sum_lm C_lm << (8 lm + shift) for this thread's outputs (S = 1), or
// the sum alone added into out with red.global.add.u32 (S > 1).  Register
// 4j + e: row 16 wl + g4 + 8 (e >> 1) of the warpgroup's 64, stacked column
// 8j + 2 t4 + (e & 1), i.e. limb j / 8 at column 8 (j % 8) + 2 t4 + (e & 1).
template <class Pl>
__device__ __forceinline__ void store(const uint32_t (&d)[Pl::R],
                                      const MmShape& g, const Unit& t, int wg,
                                      int wl, int lane) {
  constexpr int JT = COLS / 8;
  const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = t.rt * Pl::ROWS + 64 * wg + 16 * wl + g4 + 8 * h;
    if (b >= g.B) continue;
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) {
      const size_t off = (size_t)b * g.UN + t.ct * COLS + 8 * jj + 2 * t4;
      uint32_t s0 = 0, s1 = 0;
      if (g.S == 1) {
        const int2 in = *reinterpret_cast<const int2*>(g.acc + off);
        s0 = (uint32_t)in.x;
        s1 = (uint32_t)in.y;
      }
#pragma unroll
      for (int lm = 0; lm < Pl::LG; ++lm) {
        const int sh = 8 * lm + g.shift;
        if (sh < 32) {
          s0 += d[4 * (lm * JT + jj) + 2 * h] << sh;
          s1 += d[4 * (lm * JT + jj) + 2 * h + 1] << sh;
        }
      }
      if (g.S == 1) {
        *reinterpret_cast<int2*>(g.out + off) = make_int2((int)s0, (int)s1);
      } else {
        unsigned int* o = reinterpret_cast<unsigned int*>(g.out + off);
        atomicAdd(o, s0);
        atomicAdd(o + 1, s1);
      }
    }
  }
}

// Consumer warpgroup wg (rows 64 wg .. of each unit's tile).
template <class Pl>
__device__ __forceinline__ void consume(const CkRing<Pl>& r, const MmShape& g,
                                        int wg, int wl, int lane) {
  CkCursor cur;
  uint32_t d[Pl::R];
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit t(u, g);
#pragma unroll
    for (int i = 0; i < Pl::R; ++i) d[i] = 0;
    int held = -1;                            // the stage of the group in flight
    for (int kt = t.k0; kt < t.k1; ++kt) {
      const uint8_t* st = r.ring + (size_t)cur.s * Pl::STAGE;
      mbar_wait(&r.full[cur.s], cur.ph);
      const uint64_t da = sw128_desc(smem_addr(st + wg * 64 * CKW_BK));
      const uint64_t db = sw128_desc(smem_addr(st + Pl::A_BYTES));
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < CKW_BK / 32; ++k) wgmma(d, da + 2 * k, db + 2 * k);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(d);
      if (held >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&r.empty[held]);
      }
      held = cur.s;
      cur.next<Pl>();
    }
    wgmma_wait<0>();
    fence_regs(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(&r.empty[held]);
    store<Pl>(d, g, t, wg, wl, lane);
  }
}

template <class Pl>
__global__ void __launch_bounds__(Pl::THREADS, 1)
mm_recombine_kernel(__grid_constant__ const CUtensorMap xmap,
                    __grid_constant__ const CUtensorMap wmap,
                    const MmShape g) {
  extern __shared__ uint8_t smem_raw[];
  const CkRing<Pl> r(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  r.init(tid);
  if (warp == 4 * Pl::WG) {                   // the producer warp
    if (lane == 0) {
      prefetch_map(&xmap);
      prefetch_map(&wmap);
      produce(r, &xmap, &wmap, g);
    }
  } else {
    consume(r, g, warp >> 2, warp & 3, lane);
  }
}

template <int L, int WG>
int launch(const void* x, const void* wt, const void* acc, void* out, int B,
           int K, int UN, int shift, int split, int ctas,
           cudaStream_t stream) {
  using Pl = CkPlan<WG, COLS, COLS * L>;
  if (tensor_map_encoder() == nullptr) return (int)cudaErrorNotSupported;
  MmShape g{(const int32_t*)acc, (int32_t*)out, B, UN, shift,
            (K + CKW_BK - 1) / CKW_BK, 0, 0, (B + Pl::ROWS - 1) / Pl::ROWS,
            UN / COLS, 0};
  split_plan(g.ktiles, split, &g.slice, &g.S);
  g.units = g.RT * g.CT * g.S;
  // x (B, K) in boxes of 128 K-bytes x ROWS rows; wt (L, UN, K) in boxes of
  // 128 K-bytes x 64 columns x L limbs
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)B};
  const cuuint64_t xs[1] = {(cuuint64_t)K};
  const cuuint32_t xb[2] = {CKW_BK, (cuuint32_t)Pl::ROWS};
  const cuuint64_t wd[3] = {(cuuint64_t)K, (cuuint64_t)UN, (cuuint64_t)L};
  const cuuint64_t ws[2] = {(cuuint64_t)K, (cuuint64_t)UN * K};
  const cuuint32_t wb[3] = {CKW_BK, COLS, (cuuint32_t)L};
  CUtensorMap xmap, wmap;
  if (!encode_i8_map(&xmap, x, 2, xd, xs, xb)
      || !encode_i8_map(&wmap, wt, 3, wd, ws, wb))
    return (int)cudaErrorInvalidValue;
  if (g.S > 1) {
    const cudaError_t e = cudaMemcpyAsync(out, acc, (size_t)B * UN * 4,
                                          cudaMemcpyDeviceToDevice, stream);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(g.units < ctas ? g.units : ctas);
  return ck_launch<Pl>(mm_recombine_kernel<Pl>, grid, stream, xmap, wmap, g);
}

template <int L>
int launch_rows(const void* x, const void* wt, const void* acc, void* out,
                int B, int K, int UN, int shift, int rows, int split, int ctas,
                cudaStream_t stream) {
  if (rows == 64)
    return launch<L, 1>(x, wt, acc, out, B, K, UN, shift, split, ctas, stream);
  if (rows == 128)
    return launch<L, 2>(x, wt, acc, out, B, K, UN, shift, split, ctas, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The plan (rows 64 or 128, the K split, the persistent grid's blocks) is
// kernels.mm_recombine_acc_plan's.  K a multiple of 16 (x's and wt's row
// stride for TMA), UN a multiple of 64, 1 <= L <= 4.
extern "C" int tfhe_mm_recombine_acc(const void* x, const void* wt,
                                     const void* acc, void* out, int B, int K,
                                     int UN, int L, int shift, int rows,
                                     int split, int ctas, void* stream) {
  if (B < 1 || K < 16 || K % 16 != 0 || UN < COLS || UN % COLS != 0
      || shift < 0 || split < 1 || ctas < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 1: return launch_rows<1>(x, wt, acc, out, B, K, UN, shift, rows,
                                  split, ctas, s);
    case 2: return launch_rows<2>(x, wt, acc, out, B, K, UN, shift, rows,
                                  split, ctas, s);
    case 3: return launch_rows<3>(x, wt, acc, out, B, K, UN, shift, rows,
                                  split, ctas, s);
    case 4: return launch_rows<4>(x, wt, acc, out, B, K, UN, shift, rows,
                                  split, ctas, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
