// priv_keyswitch: the private functional key switch of the circuit
// bootstrap (program C, boot/circuit.py) on Hopper,
//
//   out[b, c] = sum_{i, j} table[c, (i, j, d_ij - 1)]  mod 2^32   (d_ij != 0)
//
// where d_ij is digit j (top-down, basebit bits) of the rounded coefficient
// x[b, i] + 2^(63 - basebit*t) (circuit.priv_keyswitch_digits) and table is
// the packed privKS key of one z (circuit.prepare_privks): (4, UN, kstride)
// int8, K-major, whose K' = (n+1)*t*(base-1) columns are the digit-0-free
// rows (i, j, v-1) and whose 4 limbs recombine to -c, the negated key
// sample (the final negation folded in).  x (B, n+1) int64, out (B, UN)
// int32.
//
// Replaces no Pallas kernel: the JAX package leaves the key switch to XLA
// (one-hot int8 products).  Bound by the table's bytes, read once: 4 * K' *
// UN (1.175 GB at CB_ACTIVE, 0.537 at CB_PAPER, 0.351 and 0.160 ms at 3.35
// TB/s), above the int8 MACs at every batch the circuit cells run (B <=
// 256; 0.304 and 0.139 ms at B = 256).  The design answers that:
//   * The table by TMA, 128-byte swizzle, in boxes of 128 K-bytes x 64
//     columns x 4 limbs (a 32 KB stage) through a ring of up to 8 stages;
//     a block's warpgroups split the box's limbs, two each (one m64n128k32
//     a k32 step), so a thread recombines its two limbs in registers.
//   * No one-hot in device memory: the block builds the 0/1 A tile of each
//     K tile in shared memory, in the layout TMA would write, from x's
//     coefficients (a 16-byte chunk of a row a work item: the one-hot bits
//     of its 16 positions, from the one or two coefficients they touch,
//     spread to bytes by a multiply; the coefficients loaded a tile
//     ahead).  Three A buffers and one wgmma group in flight across tiles:
//     tile k+1 is built while tile k's wgmmas run.  Rows past B stay zero.
//   * Split K over the card: output tiles alone are few (UN / 64 = 32 at
//     the CB blocks), so a block is a unit (row group, column unit, K
//     slice), the row group fastest: at B = 256 the two 128-row blocks of
//     one key slice run side by side and the second reads it from L2.
//     kernels.priv_keyswitch_plan chooses the rows (64 or 128) and the
//     slices so that the grid fills the card.
//   * Exact reduction: a limb's sum is exact in int32 (at most (n+1)*t
//     nonzero one-hot entries a row, times 128), the recombination
//     sum_l acc_l << 8l runs in uint32 (the torus), and each warpgroup adds
//     its rows into the zeroed output with one TMA reduction: addition mod
//     2^32 commutes, so the bits do not depend on the order in which blocks
//     land.
// A block owns its ring without a producer warp: thread 0 refills the
// stage of tile k-1 once the block's barrier after tile k's build has
// passed (every wgmma that read it has completed).
// On the card (PERF.md section 6): 85-89% of the byte bound at B <= 4,
// 79% at B = 64; 41% at B = 256, where the A builds (128 rows a tile) and
// the wgmmas take turns on the SM instead of overlapping (their parts
// alone add up to the whole), above the L2 floor of two row groups reading
// the table.
// PK_PART (a build flag, default 0) strips the kernel to parts for timing:
// 1 keeps the key loads and the wgmmas (on zero A tiles), 2 the key loads
// and the A builds, 3 the key loads alone.  Their outputs are meaningless.
#include "ck_wgmma.cuh"

#ifndef PK_PART
#define PK_PART 0
#endif

namespace {

using namespace tfhe;

constexpr int COLS = 64;                      // output columns of a unit
constexpr int LIMBS = 4;
constexpr int STAGE = COLS * LIMBS * CKW_BK;  // one key tile, 32 KB
constexpr int WN = 2 * COLS;                  // a warpgroup's wgmma N: 2 limbs
constexpr int R = WN / 2;                     // int32 accumulators a thread
constexpr int ITEMS = 2;                      // A chunks a thread a tile
constexpr int ABUFS = 3;                      // A tiles: running, done, built
constexpr bool BUILDS = PK_PART == 0 || PK_PART == 2;
constexpr bool MMAS = PK_PART == 0 || PK_PART == 1;

struct Args {
  const uint64_t* x;                          // (B, n1) samples
  uint64_t offset;                            // 2^(63 - bb*t)
  uint64_t span_magic, bm1_magic;             // ceil(2^40 / d): n / d exact
  int B, n1, t, bb, bm1, span, kq;            // span = t*bm1, kq = n1*span
  int ktiles, slice, R, CU, stages;
};

// A block's shape: ROWS / 32 consumer warpgroups, warpgroup w on rows 64
// (w / 2) .. + 63 and limbs 2 (w % 2), + 1 (a wgmma N of 128, 64
// accumulators a thread), so ROWS * 8 / T = 2 chunks of every A tile a
// thread: 8 warps build a 64-row tile, 16 a 128-row one.
template <int ROWS>
struct Pk {
  static constexpr int T = 4 * ROWS;          // threads
  static constexpr int A_BYTES = ROWS * CKW_BK;
  static_assert(ROWS * 8 == ITEMS * T, "two chunks a thread");
};

__host__ __device__ constexpr size_t smem_bytes(int rows, int stages) {
  return 1024 + ABUFS * (size_t)rows * CKW_BK
         + (size_t)stages * (STAGE + sizeof(uint64_t));
}

constexpr int ring_stages(int rows) {
  const size_t n = (CKW_MAX_SMEM - smem_bytes(rows, 0))
                   / (STAGE + sizeof(uint64_t));
  return n < CKW_MAX_STAGES ? (int)n : CKW_MAX_STAGES;
}
static_assert(ring_stages(128) >= 2, "a ring of two stages at least");

__device__ __forceinline__ int div_magic(int n, uint64_t magic) {
  return (int)(((uint64_t)(uint32_t)n * magic) >> 40);
}

// A thread's items: chunk c16 = tid % 8 of rows tid / 8 + T / 8 s (s <
// ITEMS) of every A tile, i.e. the K' window [128 kt + 16 c16, + 16) of
// each row.  The window starts at offset lo of coefficient i (span = t
// (base - 1) >= 16 positions a coefficient, so it touches i and at most
// i + 1), advanced a tile at a time without a division.
struct Window {
  int i, lo;

  __device__ __forceinline__ Window(int kt, int c16, const Args& a) {
    const int p0 = kt * CKW_BK + 16 * c16;
    i = div_magic(p0, a.span_magic);
    lo = p0 - i * a.span;
  }
  __device__ __forceinline__ void next(const Args& a) {
    lo += CKW_BK;
    while (lo >= a.span) {
      lo -= a.span;
      ++i;
    }
  }
};

// The window's coefficients i and i + 1 of each item's row (xr: the row,
// nullptr past B; 0 past its end), loaded a tile before their build.
__device__ __forceinline__ void fetch(uint64_t (&c)[ITEMS][2],
                                      const Window& w, const Args& a,
                                      const uint64_t* const (&xr)[ITEMS]) {
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    c[s][0] = xr[s] && w.i < a.n1 ? __ldg(xr[s] + w.i) : 0;
    c[s][1] = xr[s] && w.i + 1 < a.n1 ? __ldg(xr[s] + w.i + 1) : 0;
  }
}

// The one-hot bits of a coefficient (rounded; its digits the top t*bb <=
// 32 bits: digit j = (hi >> (32 - (j+1) bb)) & bm1) at window positions
// [0, 16), as bits 8 .. 23 of b8: group j's bytes start at window position
// j bm1 - lo (negative where the group began before the window), byte v -
// 1 set for digit v != 0, i.e. bit at8 + v - 1 with at8 = j bm1 - lo + 8
// >= 2 (bm1 <= 7), and (1 << v) >> 1 is that byte's bit or nothing.  From
// group j while at8 < lim; the items' rows share the window, so each
// group's shifts are computed once.
__device__ __forceinline__ void group_bits(uint32_t (&b8)[ITEMS],
                                           const uint32_t (&hi)[ITEMS],
                                           int j, int at8, int lim,
                                           const Args& a) {
  for (int sh = 32 - (j + 1) * a.bb; at8 < lim; sh -= a.bb, at8 += a.bm1) {
#pragma unroll
    for (int s = 0; s < ITEMS; ++s)
      b8[s] |= ((1u << ((hi[s] >> sh) & a.bm1)) >> 1) << at8;
  }
}

// The thread's chunks of the A tile of window w into ``buf`` (ROWS rows x
// 128 bytes, 128-byte swizzle, the layout TMA would write): the bits of
// the window's one or two coefficients (at base 2 a digit is its own
// one-hot: the digit field bit-reversed), spread to bytes by a multiply.
// Rows past ``live`` are left as they are (zero).
template <int RS>
__device__ __forceinline__ void build(uint8_t* buf,
                                      const uint64_t (&c)[ITEMS][2],
                                      const Window& w, const Args& a,
                                      int live, int tid) {
  uint32_t bits[ITEMS], hi[ITEMS], hj[ITEMS];
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    hi[s] = (uint32_t)((c[s][0] + a.offset) >> 32);
    hj[s] = (uint32_t)((c[s][1] + a.offset) >> 32);
    bits[s] = 0;
  }
  const bool in0 = w.i < a.n1;
  const bool in1 = w.lo + 16 > a.span && w.i + 1 < a.n1;
  if (a.bm1 == 1) {
    const uint32_t mask = a.t == 32 ? ~0u : (1u << a.t) - 1;
#pragma unroll
    for (int s = 0; s < ITEMS; ++s) {
      if (in0) bits[s] = (__brev(hi[s]) & mask) >> w.lo;
      if (in1) bits[s] |= (__brev(hj[s]) & mask) << (a.span - w.lo);
    }
  } else {
    uint32_t b8[ITEMS];
#pragma unroll
    for (int s = 0; s < ITEMS; ++s) b8[s] = 0;
    if (in0) {
      const int j0 = div_magic(w.lo, a.bm1_magic);
      group_bits(b8, hi, j0, j0 * a.bm1 - w.lo + 8,
                 min(24, a.span - w.lo + 8), a);
    }
    if (in1) group_bits(b8, hj, 0, a.span - w.lo + 8, 24, a);
#pragma unroll
    for (int s = 0; s < ITEMS; ++s) bits[s] = b8[s] >> 8;
  }
  const int c16 = tid & 7;
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    const int row = (tid >> 3) + RS * s;
    if (row >= live) continue;
    // bit e -> byte e: a nibble times 0x00204081 puts its bits 0-3 at bits
    // 0, 8, 16, 24 with no carries
    const uint32_t b = bits[s];
    uint4 q;
    q.x = ((b & 0xFu) * 0x00204081u) & 0x01010101u;
    q.y = (((b >> 4) & 0xFu) * 0x00204081u) & 0x01010101u;
    q.z = (((b >> 8) & 0xFu) * 0x00204081u) & 0x01010101u;
    q.w = (((b >> 12) & 0xFu) * 0x00204081u) & 0x01010101u;
    *reinterpret_cast<uint4*>(buf + row * CKW_BK
                              + ((c16 ^ (row & 7)) << 4)) = q;
  }
}

// Thread 0: K tile ``kt`` of column unit c0 (every limb) into stage s.
__device__ __forceinline__ void load(uint8_t* ring, uint64_t* full,
                                     const CUtensorMap* wmap, int kt, int c0,
                                     int s) {
  mbar_arrive_tx(&full[s], STAGE);
  tma_load_3d(ring + (size_t)s * STAGE, wmap, &full[s], kt * CKW_BK, c0, 0);
}

template <int ROWS>
__global__ void __launch_bounds__(Pk<ROWS>::T, 1)
privks_kernel(__grid_constant__ const CUtensorMap wmap,
              __grid_constant__ const CUtensorMap omap, const Args a) {
  constexpr int T = Pk<ROWS>::T, A_BYTES = Pk<ROWS>::A_BYTES, RS = T / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* abuf = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = abuf + ABUFS * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring
                                               + (size_t)a.stages * STAGE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  int u = blockIdx.x;                         // (slice, column unit, rows)
  const int rg = u % a.R;
  u /= a.R;
  const int cu = u % a.CU, k0 = (u / a.CU) * a.slice;
  const int n = min(a.ktiles, k0 + a.slice) - k0;
  const int b0 = rg * ROWS, c0 = cu * COLS;
  // this warpgroup's A rows and key rows (its two limbs) in a stage
  const int a_off = (wg >> 1) * 64 * CKW_BK;
  const int b_off = (wg & 1) * WN * CKW_BK;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    prefetch_map(&wmap);
    for (int q = 0; q < a.stages && q < n; ++q)
      load(ring, full, &wmap, k0 + q, c0, q);
  }
  for (int i = tid; i < ABUFS * A_BYTES / 16; i += T)
    reinterpret_cast<uint4*>(abuf)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int live = min(ROWS, a.B - b0);       // rows whose A rows are built
  // the window of the tile being built and the next one's, whose
  // coefficients are loaded a tile ahead (their L2 latency hides behind a
  // tile's wgmmas)
  Window w(k0, tid & 7, a), wn = w;
  const uint64_t* xr[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int row = (tid >> 3) + RS * q;
    xr[q] = row < live ? a.x + (size_t)(b0 + row) * a.n1 : nullptr;
  }
  uint64_t cur[ITEMS][2], nxt[ITEMS][2];
  fetch(cur, w, a, xr);
  if (n > 1) {
    wn.next(a);
    fetch(nxt, wn, a, xr);
  }
  if (BUILDS) build<RS>(abuf, cur, w, a, live, tid);
  fence_async_smem();
  named_sync(1, T);

  uint32_t d[R];
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0;
  // One wgmma group stays in flight across tiles: the tensor cores run
  // tile i while the warps build tile i + 1 into the third A buffer (tile
  // i - 2's, whose group completed before the last barrier); the barrier
  // after each build also frees the key stage of tile i - 1, which thread
  // 0 then refills.
  int s = 0;
  uint32_t ph = 0;
  for (int i = 0; i < n; ++i) {
    mbar_wait(&full[s], ph);
    if (MMAS) {
      const uint64_t da = sw128_desc(smem_addr(abuf + (i % ABUFS) * A_BYTES
                                               + a_off));
      const uint64_t db = sw128_desc(smem_addr(ring + (size_t)s * STAGE
                                               + b_off));
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < CKW_BK / 32; ++k) wgmma(d, da + 2 * k, db + 2 * k);
      wgmma_commit();
      wgmma_wait<1>();                        // tile i - 1's group is done
      fence_regs(d);
    }
    if (BUILDS && i + 1 < n) {
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        cur[q][0] = nxt[q][0];
        cur[q][1] = nxt[q][1];
      }
      w = wn;
      if (i + 2 < n) {
        wn.next(a);
        fetch(nxt, wn, a, xr);
      }
      build<RS>(abuf + ((i + 1) % ABUFS) * A_BYTES, cur, w, a, live, tid);
    }
    fence_async_smem();
    named_sync(1, T);
    if (tid == 0 && i > 0 && i - 1 + a.stages < n)  // the stage tile i-1 left
      load(ring, full, &wmap, k0 + i - 1 + a.stages, c0,
           s == 0 ? a.stages - 1 : s - 1);
    if (++s == a.stages) {
      s = 0;
      ph ^= 1;
    }
  }
  if (MMAS) {
    wgmma_wait<0>();
    fence_regs(d);
  }
  named_sync(1, T);                           // no wgmma reads the ring now

  // The epilogue.  Register 4j + e: row 16 wl + g4 + 8 (e >> 1) of the
  // warpgroup's rows, column 8j + 2 t4 + (e & 1) of its N, i.e. its limb
  // j / 8 at column 8 (j % 8) + 2 t4 + (e & 1).  Each warpgroup stages its
  // 64 rows x 64 columns, its two limbs recombined in int32, in the idle
  // ring and adds them into out with one TMA reduction (rows past B
  // dropped; the two limb pairs of a row land separately, and commute).
  constexpr int LW = WN / COLS, JT = COLS / 8;
  const int l0 = 2 * (wg & 1);                // the warpgroup's first limb
  const int r0 = b0 + 64 * (wg >> 1);
  int32_t* st = reinterpret_cast<int32_t*>(ring) + wg * 64 * COLS;
  const int wl = warp & 3, g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = 16 * wl + g4 + 8 * h;
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) {
      uint32_t s0 = 0, s1 = 0;
#pragma unroll
      for (int lm = 0; lm < LW; ++lm) {
        s0 += d[4 * (lm * JT + jj) + 2 * h] << (8 * (l0 + lm));
        s1 += d[4 * (lm * JT + jj) + 2 * h + 1] << (8 * (l0 + lm));
      }
      *reinterpret_cast<int2*>(st + rl * COLS + 8 * jj + 2 * t4) =
          make_int2((int)s0, (int)s1);
    }
  }
  fence_async_smem();
  named_sync(2 + wg, 128);
  if ((tid & 127) == 0 && r0 < a.B) {
    tma_reduce_add_2d(&omap, st, c0, r0);
    bulk_commit_wait_read();
  }
}

// (slice length, slices) of ``steps`` K tiles cut ``split`` ways, as
// kernels.split_plan.
void split_plan(int steps, int split, int* len, int* slices) {
  if (split > steps) split = steps;
  if (split < 1) split = 1;
  *len = (steps + split - 1) / split;
  *slices = (steps + *len - 1) / *len;
}

template <int ROWS>
int launch(const void* table, void* out, Args a, int UN, int kstride,
           int split, cudaStream_t stream) {
  a.stages = ring_stages(ROWS);
  if (tensor_map_encoder() == nullptr) return (int)cudaErrorNotSupported;
  int S = 0;
  split_plan(a.ktiles, split, &a.slice, &S);
  a.R = (a.B + ROWS - 1) / ROWS;
  a.CU = UN / COLS;
  // table (4, UN, kstride) in boxes of 128 K-bytes x 64 columns x 4 limbs
  // (K' columns: TMA fills the K tail with zeros); out (B, UN) int32 in
  // boxes of 64 columns x 64 rows
  const cuuint64_t wd[3] = {(cuuint64_t)a.kq, (cuuint64_t)UN, LIMBS};
  const cuuint64_t ws[2] = {(cuuint64_t)kstride, (cuuint64_t)UN * kstride};
  const cuuint32_t wb[3] = {CKW_BK, COLS, LIMBS};
  const cuuint64_t od[2] = {(cuuint64_t)UN, (cuuint64_t)a.B};
  const cuuint64_t os[1] = {(cuuint64_t)UN * 4};
  const cuuint32_t ob[2] = {COLS, 64};
  CUtensorMap wmap, omap;
  if (!encode_i8_map(&wmap, table, 3, wd, ws, wb)
      || !encode_i32_map(&omap, out, 2, od, os, ob))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)a.B * UN * 4, stream);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes(ROWS, a.stages);
  e = cudaFuncSetAttribute(privks_kernel<ROWS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.R * a.CU * S);
  privks_kernel<ROWS><<<grid, Pk<ROWS>::T, smem, stream>>>(wmap, omap, a);
  return (int)cudaGetLastError();
}

uint64_t magic40(int d) { return ((1ull << 40) + d - 1) / d; }

}  // namespace

// ``rows`` 64 or 128 (one or two consumer warpgroups) and ``split`` K
// slices (kernels.priv_keyswitch_plan chooses both).  n1 = n+1
// coefficients of t digits of bb <= 3 bits (bb*t <= 32: the digits lie in
// the top 32 bits; t*(2^bb - 1) >= 16: a 16-position chunk touches two
// coefficients at most); K' =
// n1*t*(2^bb - 1) below 2^20 and n1*t below 2^24 (the int32 sums); UN a
// multiple of 64;
// kstride >= K', a multiple of 16 (the table's row stride for TMA).
extern "C" int tfhe_priv_keyswitch(const void* x, const void* table,
                                   void* out, int B, int n1, int t, int bb,
                                   int UN, int kstride, int rows, int split,
                                   void* stream) {
  if (B < 1 || n1 < 1 || t < 1 || bb < 1 || bb > 3 || bb * t > 32
      || UN < COLS
      || UN % COLS != 0 || split < 1)
    return (int)cudaErrorInvalidValue;
  const int bm1 = (1 << bb) - 1;
  const long long kq = (long long)n1 * t * bm1;
  if (kq >= (1 << 20) || (long long)n1 * t >= (1 << 24) || kstride < kq
      || kstride % 16 != 0 || t * bm1 < 16)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = (const uint64_t*)x;
  a.offset = 1ull << (63 - bb * t);
  a.span_magic = magic40(t * bm1);
  a.bm1_magic = magic40(bm1);
  a.B = B;
  a.n1 = n1;
  a.t = t;
  a.bb = bb;
  a.bm1 = bm1;
  a.span = t * bm1;
  a.kq = (int)kq;
  a.ktiles = (int)((kq + CKW_BK - 1) / CKW_BK);
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == 64) return launch<64>(table, out, a, UN, kstride, split, s);
  if (rows == 128) return launch<128>(table, out, a, UN, kstride, split, s);
  return (int)cudaErrorInvalidValue;
}
