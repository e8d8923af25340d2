// fused_cmux_step (v1): one whole 32-bit blind-rotation step,
//   out = acc + sum_l (decompose((X^a - 1) * acc) @ w[l]) << (8 l + key_shift)
// mod 2^32.  a (B,) int32, acc / out (B, k+1, N) int32, w (L = 3,
// (k+1)*l*N, (k+1)*N) int8: materialize_w's layout, the contraction index
// K = (j, t) on the rows and the output columns contiguous (MN-major).  The
// same function as fused_cmux_step.cu (v2), whose key is K-packed.
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:fused_cmux_step.  Bound by int8
// tensor-core MACs: B * (k+1)^2 * l * N^2 * L multiply-adds per step.  It
// runs v2's mainloop (fused_step.cuh): a block owns 64 batch rows and 128
// output columns of every limb, two consumer warpgroups of 64 columns each;
// the digits are built by the consumer warps one group (128 coefficients of
// one input polynomial, up to LB levels) ahead while the wgmmas run, and
// the epilogue adds in uint32.  int8 wgmma reads only K-major operands from
// shared memory, so the key is transposed in the kernel, by a third
// warpgroup, off the tensor cores' and the digit build's path:
//   * its first thread loads each K slice (128 rows of one level) of each
//     limb as one MN-major TMA box (128 K rows x 128 columns, 16 KB,
//     128-byte swizzle) into a ring of S raw stages, refilling a stage as
//     soon as the warpgroup has read it (a named barrier);
//   * its warps rewrite each box into the 128-byte-swizzled K-major tiles
//     the consumers' wgmmas read: a thread takes 16 K rows x 4 columns of
//     each warpgroup's half (16 conflict-free 4-byte loads: the two
//     half-warps read rows 16 apart, visited 4 apart, so the swizzle puts
//     them in different banks), transposes them 4 x 4 with __byte_perm and
//     writes four 16-byte chunks (the columns visited in an order rotated
//     by lane, so a quarter-warp's eight chunks lie in eight rows of
//     distinct row & 7: no bank conflict);
//   * a slice's K-major tiles (3 limbs x 128 columns, 48 KB) go to one of
//     two slots, handed over by full/empty mbarriers: the consumers release
//     a slot once the wgmmas that read it are done (wgmma_wait<1> after the
//     next slice's issue), so the transpose of slice q + 1 runs beside the
//     wgmmas of slice q.
// Each key byte crosses shared memory three times more than in v2 (TMA
// write, transpose read and write, wgmma read).  At GATE_FAST2 the two
// slots, the two 24 KB digit buffers (LB = 3 levels) and 5 raw stages fill
// the 227 KB a block may have; the 384 threads leave 168 registers each,
// as many as v2's consumers (157) need.
//
// FCS_PART (a build flag, default 0) strips the kernel to one part, as in
// fused_cmux_step.cu (tools/torch_matw_ab.py times them): 1 keeps the key
// loads and the transpose (the consumers only wait and release), 2 the
// digit build, 3 the wgmmas (on whatever the buffers hold), 4 the key
// loads alone.  Their outputs are meaningless.
#include "fused_step.cuh"

#ifndef FCS_PART
#define FCS_PART 0
#endif

namespace {

using namespace tfhe;
using namespace tfhe::fused;

constexpr bool KEYS = FCS_PART == 0 || FCS_PART == 1 || FCS_PART == 4;
constexpr bool TRANSPOSE = FCS_PART == 0 || FCS_PART == 1;
constexpr bool DIGITS = FCS_PART == 0 || FCS_PART == 2;
constexpr bool MMAS = FCS_PART == 0 || FCS_PART == 3;

constexpr int L = 3, CW = 2;            // key limbs; consumer warpgroups
constexpr int COLS = CW * BN;           // output columns of a block
constexpr int RAW = BK * COLS;          // one raw stage: 128 K rows x COLS
constexpr int SLICE = CW * L * TILE;    // one slice's K-major tiles
constexpr int SLOTS = 2;                // slices of K-major tiles
constexpr int MAX_LB = 3;               // levels of a digit build
constexpr int MAX_STAGES = 8;
constexpr int THREADS = (CW + 1) * 128; // consumers, then the transposers
constexpr size_t MAX_SMEM = 232448;

// Dynamic shared memory of a block: 1 KB of alignment slack, the K-major
// slots, the two digit buffers of LB levels, S raw stages, the barriers
// and the rows' exponents.
constexpr size_t smem_bytes(int lb, int S) {
  return 1024 + (size_t)SLOTS * SLICE + (size_t)2 * lb * TILE
         + (size_t)S * RAW + (size_t)(S + 2 * SLOTS) * sizeof(uint64_t)
         + 64 * sizeof(int);
}

// Raw stages: as many as fit beside LB-level digit buffers, at most
// MAX_STAGES.
constexpr int raw_stages(int lb) {
  const size_t room = MAX_SMEM - smem_bytes(lb, 0);
  const size_t per = RAW + sizeof(uint64_t);
  return room / per < MAX_STAGES ? (int)(room / per) : MAX_STAGES;
}

// Group g: input polynomial u, coefficients t0 .. t0 + 127, levels
// lv0 .. lv0 + nl - 1 (the level blocks of one (u, t0) in a row).
struct Group {
  int u, t0, lv0, nl;
};

__device__ __forceinline__ Group group(const Args& p, int g) {
  const int nlb = (p.l + p.lb - 1) / p.lb, per_u = (p.N / BK) * nlb;
  const int rem = g % per_u, lv0 = (rem % nlb) * p.lb;
  return {g / per_u, (rem / nlb) * BK, lv0, min(p.lb, p.l - lv0)};
}

// Thread (kc, cq, h) of the transposer warpgroup, for consumer warpgroup
// cw's half of a raw stage (128 K rows x 128 columns, TMA's 128-byte
// swizzle: chunk c of row r at chunk c ^ (r & 7)): K rows 16 kc .. + 15,
// columns 64 cw + 4 cq .. + 3; x[i] holds row 16 kc + ((i + 4 h) & 15).
__device__ __forceinline__ void load_raw(uint32_t (&x)[16],
                                         const uint8_t* raw, int cw, int kc,
                                         int cq, int h) {
  const int c = BN * cw + 4 * cq;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * kc + ((i + 4 * h) & 15);
    x[i] = *reinterpret_cast<const uint32_t*>(
        raw + r * COLS + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15)));
  }
}

// Consumer warpgroup cw's K-major tile (row n = its column n, 128 K bytes,
// 128-byte swizzle), chunk kc of rows 4 cq .. + 3: for each, the four
// words of K quads 0 .. 3, each the byte of one column from four K rows.
// x's block of rows Q' holds K quad (Q' + h) & 3.
__device__ __forceinline__ void store_tile(uint8_t* kt,
                                           const uint32_t (&x)[16], int kc,
                                           int cq, int h) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = (e + (cq >> 1)) & 3;
    const uint32_t sel = c | (c + 4) << 4;
    uint32_t t[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      t[q] = __byte_perm(__byte_perm(x[4 * q], x[4 * q + 1], sel),
                         __byte_perm(x[4 * q + 2], x[4 * q + 3], sel),
                         0x5410);
    const int n = 4 * cq + c;
    *reinterpret_cast<uint4*>(kt + n * BK + ((kc ^ (n & 7)) << 4)) =
        h ? make_uint4(t[3], t[0], t[1], t[2])
          : make_uint4(t[0], t[1], t[2], t[3]);
  }
}

// The TMA load of raw stage r (slice r / L, limb r % L) into its ring slot:
// slice q is level q % l of 128-coefficient group q / l, in the consumers'
// order (every group's level blocks in a row).
__device__ __forceinline__ void load_stage(uint8_t* raw,
                                           const CUtensorMap* map,
                                           uint64_t* full, const Args& p,
                                           int r, int c0) {
  const int q = r / L, lm = r - q * L, per_u = p.N / BK;
  const int ut = q / p.l, lv = q - ut * p.l;
  const int u = ut / per_u, t0 = (ut - u * per_u) * BK;
  const int s = r % p.stages;
  mbar_arrive_tx(&full[s], RAW);
  tma_load_3d(raw + (size_t)s * RAW, map, &full[s], c0,
              (u * p.l + lv) * p.N + t0, lm);
}

__global__ void __launch_bounds__(THREADS, 1)
fused_v1_kernel(__grid_constant__ const CUtensorMap wmap, const Args p) {
  constexpr int R = 32 * L, MY_ROWS = 16 / CW;
  static_assert(MY_ROWS % ROWS == 0, "a warp's rows, ROWS at a time");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* slots = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int S = p.stages, lb = p.lb, l = p.l;
  uint8_t* digits = slots + (size_t)SLOTS * SLICE;       // [buffer][level]
  uint8_t* raw = digits + (size_t)2 * lb * TILE;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(raw + (size_t)S * RAW);
  uint64_t* kt_full = raw_full + S;
  uint64_t* kt_empty = kt_full + SLOTS;
  int* rot = reinterpret_cast<int*>(kt_empty + SLOTS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * COLS, b0 = blockIdx.y * 64, N = p.N;
  const int Q = p.kp1 * (N / BK) * l;         // slices
  const int G = p.kp1 * (N / BK) * ((l + lb - 1) / lb);

  for (int i = tid; i < 64; i += blockDim.x) {
    const int b = b0 + i;
    rot[i] = b < p.B ? p.expo[b] & (2 * N - 1) : 0;
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&raw_full[s], 1);
    for (int k = 0; k < SLOTS; ++k) {
      mbar_init(&kt_full[k], 4);              // lane 0 of each transposer
      mbar_init(&kt_empty[k], 4 * CW);        // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * CW) {                       // the transposer warpgroup
    if (!KEYS) return;
    const int wl = warp - 4 * CW, h = lane >> 4, cq = lane & 15;
    const int kc = 2 * wl + h, nr = Q * L;
    const bool first = tid == 4 * CW * 32;
    if (first) {
      prefetch_map(&wmap);
      for (int r = 0; r < S && r < nr; ++r)
        load_stage(raw, &wmap, raw_full, p, r, c0);
    }
    for (int q = 0, r = 0; q < Q; ++q) {
      const int slot = q % SLOTS;
      uint8_t* kt = slots + (size_t)slot * SLICE;
      for (int lm = 0; lm < L; ++lm, ++r) {
        const uint8_t* st = raw + (size_t)(r % S) * RAW;
        mbar_wait(&raw_full[r % S], (r / S) & 1);
        uint32_t x0[16], x1[16];
        if (TRANSPOSE) {
          load_raw(x0, st, 0, kc, cq, h);
          load_raw(x1, st, 1, kc, cq, h);
        }
        named_sync(2, 128);                   // the stage is read
        if (first && r + S < nr)
          load_stage(raw, &wmap, raw_full, p, r + S, c0);
        if (lm == 0) mbar_wait(&kt_empty[slot], ((q / SLOTS) & 1) ^ 1);
        if (TRANSPOSE) {
          store_tile(kt + lm * TILE, x0, kc, cq, h);
          store_tile(kt + (L + lm) * TILE, x1, kc, cq, h);
        }
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(&kt_full[slot]);
    }
    return;
  }

  // consumer warpgroup cw: columns c0 + 64 cw .. + 63 of every limb; its
  // warp wl builds rows (4 cw + wl) * MY_ROWS .. + MY_ROWS - 1 of the digits
  const int cw = warp >> 2, wl = warp & 3;
  const int rlo = (4 * cw + wl) * MY_ROWS, rhi = rlo + MY_ROWS;
  const uint32_t xmask = level_xmask(l, p.bgbit);
  uint32_t d[R];
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0;

  Group gr = group(p, 0);
  if (DIGITS)
    build_digits(digits, p, rot, b0, gr.u, gr.t0, gr.lv0, gr.nl, lane, xmask,
                 rlo, rhi);
  fence_async_smem();
  named_sync(1, 128 * CW);
  fence_regs(d);
  int q = 0;
  for (int g = 0; g < G; ++g) {
    const uint8_t* dg = digits + (size_t)(g & 1) * lb * TILE;
    for (int i = 0; i < gr.nl; ++i, ++q) {
      const int slot = q % SLOTS;
      if (KEYS) mbar_wait(&kt_full[slot], (q / SLOTS) & 1);
      wgmma_fence();
      const uint64_t da = sw128_desc(smem_addr(dg + i * TILE));
      const uint64_t db = sw128_desc(
          smem_addr(slots + (size_t)slot * SLICE + cw * L * TILE));
      if (MMAS) {
#pragma unroll
        for (int k = 0; k < BK / 32; ++k) wgmma(d, da + 2 * k, db + 2 * k);
      }
      wgmma_commit();
      wgmma_wait<1>();                        // slice q - 1 is done
      if (q > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&kt_empty[(q - 1) % SLOTS]);
      }
    }
    if (g + 1 < G) {                          // overlaps the wgmmas in flight
      named_sync(1, 128 * CW);                // group g - 1 is done
      gr = group(p, g + 1);
      if (DIGITS)
        build_digits(digits + (size_t)((g + 1) & 1) * lb * TILE, p, rot, b0,
                     gr.u, gr.t0, gr.lv0, gr.nl, lane, xmask, rlo, rhi);
      fence_async_smem();
      named_sync(1, 128 * CW);
    }
  }
  wgmma_wait<0>();
  fence_regs(d);
  store_out<L>(d, p, b0, wl, lane, c0 + BN * cw);
}

}  // namespace

// lb: the levels of one digit build, 1 .. 3 (kernels.fused_cmux_step_v1_plan
// chooses).  N must be a multiple of 128, l * bgbit at most 32.
extern "C" int tfhe_fused_cmux_step_v1(const void* a, const void* acc,
                                       const void* w, void* out, int B,
                                       int kp1, int N, int l, int bgbit,
                                       unsigned int offset, int key_shift,
                                       int lb, void* stream) {
  if (N % BK != 0 || l < 1 || lb < 1 || lb > MAX_LB || lb > l)
    return (int)cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return (int)cudaErrorNotSupported;
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  const Args p{(const int32_t*)a, (const int32_t*)acc, (int32_t*)out, B, kp1,
               N, logN, l, bgbit, key_shift, raw_stages(lb), lb, offset};
  // w as (L, K, UN) bytes, innermost first; one box per K slice, 128
  // columns and limb
  const int UN = kp1 * N, K = UN * l;
  const cuuint64_t dims[3] = {(cuuint64_t)UN, (cuuint64_t)K, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)UN, (cuuint64_t)UN * K};
  const cuuint32_t box[3] = {COLS, BK, 1};
  CUtensorMap map;
  if (!encode_i8_map(&map, w, 3, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(lb, p.stages);
  const cudaError_t e = cudaFuncSetAttribute(
      fused_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(UN / COLS, (B + 63) / 64);
  fused_v1_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(map, p);
  return (int)cudaGetLastError();
}
