// fused_cmux_step_v2: one whole blind-rotation step,
//   out = acc + sum_l (decompose((X^a - 1) * acc) @ W_l) << (8 l + key_shift)
// mod 2^32, on the K-packed key wt (L <= 3, (k+1)*N, (k+1)*l*N) int8,
// wt[l, (u,i), (j,t)] = W[l, (j,t), (u,i)] (materialize_w.cu's second entry).
// a (B,) int32, acc / out (B, (k+1)*N) int32 (the (B, k+1, N) layout is the
// same bytes).
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:fused_cmux_step_v2.  Bound by the
// int8 tensor-core rate: B * (k+1)^2 * l * N^2 * L multiply-adds per step.
// A block owns 64 batch rows and CW * 64 output columns of every limb (CW = 1
// or 2 consumer warpgroups, one per 64 columns: the tile_cols plan), and
// walks K in groups (u, t0): 128 coefficients of input polynomial u at every
// level, i.e. the l 128-deep K slices j = u*l + lv.
//   * Key tiles by TMA: one producer warp loads each slice's CW boxes of
//     L x 64 x 128 bytes of wt (a 3-D tensor map, 128-byte swizzle,
//     wgmma.cuh's encode_i8_map) into a ring of S stages (full/empty
//     mbarriers).  No thread touches a key byte.
//   * Tensor cores by wgmma: the L limbs' 64-column boxes are stacked along
//     the instruction's N, so one m64n(64L)k32 per k32 step covers every limb
//     (32 L int32 accumulators a thread, 96 at L = 3, which is why a
//     warpgroup owns 64 columns, not 128).  Both operands are K-major, as
//     int8 wgmma requires.
//   * Digits one group at a time, shared: the block's 4 CW consumer warps
//     build the next group's l digit tiles (64 x 128 bytes each, in the
//     swizzled layout the wgmma descriptors read) straight from acc while
//     the current group's wgmmas run, each warp 16 / CW rows; every
//     warpgroup of the block multiplies the same tiles.  Per lane and row one
//     16-byte load of acc[t..] and two of acc[(t - r) mod N] give all l
//     levels' digits of four coefficients.  fence.proxy.async, then a block
//     barrier of the consumers, hands them to the async proxy.  Digit rows
//     past B are zero, and their outputs are not stored.
//   * Epilogue: acc + sum_l C_l << (8 l + key_shift) in uint32.
// Traffic per step at GATE_FAST2 B = 8192 (UN = 1,536, K = 4,608): key tiles
// ceil(B / 64) * L * UN * K bytes from L2 (2.72 GB); the digits are rebuilt
// UN / (64 CW) times (12 at CW = 2, 24 at CW = 1), reading acc about twice
// each time (1.2 GB at CW = 2).  CW = 2 halves the rebuilds at the cost of
// twice the key traffic of a 128-row block, and was the faster on the card
// (PERF.md §6); the wrapper takes CW = 1 only where CW = 2's ring cannot
// hold a group (l = 4 at L = 3).
// At GATE_FAST2 the CW = 2 ring holds 3 stages, exactly one group: the
// next group's key tiles load only once this group's wgmmas are done.
//
// FCS_PART (a build flag, default 0) strips the kernel to one part for
// timing the parts of a step (chip_smoke.py's phase_parts): 1 keeps the key
// loads (consumers only wait and release), 2 the digit build, 3 the wgmmas
// (on whatever the buffers hold).  Their outputs are meaningless.
#include "fused_step.cuh"

#ifndef FCS_PART
#define FCS_PART 0
#endif

namespace {

using namespace tfhe;
using namespace tfhe::fused;

constexpr bool KEYS = FCS_PART == 0 || FCS_PART == 1;
constexpr bool DIGITS = FCS_PART == 0 || FCS_PART == 2;
constexpr bool MMAS = FCS_PART == 0 || FCS_PART == 3;

constexpr int MAX_STAGES = 8;
constexpr size_t MAX_SMEM = 232448;

// Dynamic shared memory of a block: 1 KB of alignment slack, the key ring,
// the two digit buffers, the barriers and the rows' exponents.
constexpr size_t smem_bytes(int L, int CW, int l, int S) {
  return 1024 + (size_t)S * CW * L * TILE + (size_t)2 * l * TILE
         + (size_t)2 * S * sizeof(uint64_t) + 64 * sizeof(int);
}

// The ring's stages: as many as fit, at most MAX_STAGES; 0 where fewer than
// one group's l slices fit (the consumers hold a group's stages together).
constexpr int ring_stages(int L, int CW, int l) {
  const size_t room = MAX_SMEM - smem_bytes(L, CW, l, 0);
  const size_t per = (size_t)CW * L * TILE + 2 * sizeof(uint64_t);
  const int S = room / per < MAX_STAGES ? (int)(room / per) : MAX_STAGES;
  return S >= l ? S : 0;
}

template <int L, int CW>
__global__ void __launch_bounds__(CW * 128 + 32, 1)
fused_cmux_kernel(__grid_constant__ const CUtensorMap wmap, const Args p) {
  constexpr int R = 32 * L, STAGE = CW * L * TILE, MY_ROWS = 16 / CW;
  static_assert(MY_ROWS % ROWS == 0, "a warp's rows, ROWS at a time");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int S = p.stages, l = p.l;
  uint8_t* digits = ring + (size_t)S * STAGE;               // [buffer][level]
  uint64_t* full = reinterpret_cast<uint64_t*>(digits + (size_t)2 * l * TILE);
  uint64_t* empty = full + S;
  int* rot = reinterpret_cast<int*>(empty + S);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * BN * CW, b0 = blockIdx.y * 64;
  const int N = p.N, slices = N / BK, G = p.kp1 * slices;

  for (int i = tid; i < 64; i += blockDim.x) {
    const int b = b0 + i;
    rot[i] = b < p.B ? p.expo[b] & (2 * N - 1) : 0;
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CW);           // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * CW) {                       // the producer warp
    if (KEYS && lane == 0) {
      prefetch_map(&wmap);
      int s = 0;
      uint32_t ph = 0;
      for (int g = 0; g < G; ++g) {
        const int u = g / slices, t0 = (g % slices) * BK;
        for (int lv = 0; lv < l; ++lv) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_arrive_tx(&full[s], STAGE);
          for (int c = 0; c < CW; ++c)
            tma_load_3d(ring + (size_t)s * STAGE + c * L * TILE, &wmap,
                        &full[s], (u * l + lv) * N + t0, c0 + c * BN, 0);
          if (++s == S) { s = 0; ph ^= 1; }
        }
      }
    }
    return;
  }

  // consumer warpgroup cw: columns c0 + 64 cw .. + 63 of every limb; its
  // warp wl builds rows (4 cw + wl) * MY_ROWS .. + MY_ROWS - 1 of the digits
  const int cw = warp >> 2, wl = warp & 3, cols = c0 + BN * cw;
  const int rlo = (4 * cw + wl) * MY_ROWS, rhi = rlo + MY_ROWS;
  const uint32_t xmask = level_xmask(l, p.bgbit);
  uint32_t d[R];
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0;

  if (DIGITS)
    build_digits(digits, p, rot, b0, 0, 0, 0, l, lane, xmask, rlo, rhi);
  fence_async_smem();
  named_sync(1, 128 * CW);
  int s = 0;
  uint32_t ph = 0;
  for (int g = 0; g < G; ++g) {
    const uint8_t* dg = digits + (size_t)(g & 1) * l * TILE;
    const int first = s;
    if (MMAS) {
      fence_regs(d);
      wgmma_fence();
    }
    for (int lv = 0; lv < l; ++lv) {
      if (KEYS) mbar_wait(&full[s], ph);
      if (MMAS) {
        const uint64_t da = sw128_desc(smem_addr(dg + lv * TILE));
        const uint64_t db = sw128_desc(
            smem_addr(ring + (size_t)s * STAGE + cw * L * TILE));
#pragma unroll
        for (int k = 0; k < BK / 32; ++k) wgmma(d, da + 2 * k, db + 2 * k);
      }
      if (++s == S) { s = 0; ph ^= 1; }
    }
    if (MMAS) wgmma_commit();
    const int gn = g + 1;                     // overlaps the wgmmas in flight
    if (DIGITS && gn < G)
      build_digits(digits + (size_t)(gn & 1) * l * TILE, p, rot, b0,
                   gn / slices, (gn % slices) * BK, 0, l, lane, xmask, rlo,
                   rhi);
    if (MMAS) {
      wgmma_wait<0>();
      fence_regs(d);
    }
    if (KEYS) {                               // this group's key stages
      __syncwarp();
      if (lane == 0) {
        int r = first;
        for (int lv = 0; lv < l; ++lv) {
          mbar_arrive(&empty[r]);
          if (++r == S) r = 0;
        }
      }
    }
    fence_async_smem();
    named_sync(1, 128 * CW);
  }

  store_out<L>(d, p, b0, wl, lane, cols);
}

template <int L, int CW>
int launch(const void* wt, Args p, cudaStream_t stream) {
  p.stages = ring_stages(L, CW, p.l);
  if (p.stages == 0) return (int)cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return (int)cudaErrorNotSupported;
  // wt as (L, UN, K) bytes, innermost first; one box per K slice and
  // 64 columns
  const int UN = p.kp1 * p.N, K = UN * p.l;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)UN, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)K, (cuuint64_t)UN * K};
  const cuuint32_t box[3] = {BK, BN, (cuuint32_t)L};
  CUtensorMap map;
  if (!encode_i8_map(&map, wt, 3, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(L, CW, p.l, p.stages);
  const cudaError_t e = cudaFuncSetAttribute(
      fused_cmux_kernel<L, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(UN / (BN * CW), (p.B + 63) / 64);
  fused_cmux_kernel<L, CW><<<grid, CW * 128 + 32, smem, stream>>>(map, p);
  return (int)cudaGetLastError();
}

template <int L>
int launch_plan(const void* wt, const Args& p, int tile_cols,
                cudaStream_t stream) {
  if (tile_cols == 128) return launch<L, 2>(wt, p, stream);
  if (tile_cols == 64) return launch<L, 1>(wt, p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// tile_cols 64 or 128: the output columns of a block, one consumer
// warpgroup per 64 (the wrapper chooses: kernels.fused_cmux_step_v2_plan,
// which mirrors smem_bytes and ring_stages).  N must be a multiple of 128,
// l at most 4, and the plan's ring must hold l stages.
extern "C" int tfhe_fused_cmux_step(const void* a, const void* acc,
                                    const void* wt, void* out, int B, int kp1,
                                    int N, int l, int L, int bgbit,
                                    unsigned int offset, int key_shift,
                                    int tile_cols, void* stream) {
  if (N % BK != 0 || l < 1 || l > MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  const Args p{(const int32_t*)a, (const int32_t*)acc, (int32_t*)out, B, kp1,
               N, logN, l, bgbit, key_shift, 0, 0, offset};
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 1: return launch_plan<1>(wt, p, tile_cols, s);
    case 2: return launch_plan<2>(wt, p, tile_cols, s);
    case 3: return launch_plan<3>(wt, p, tile_cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
