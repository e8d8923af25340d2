// lut_cmux: one level of the batched CMux tree of models/lut.py, every group
// of rows against its own TRGSW selector,
//
//   out[g, s] = d0 + sel[g] (x) (d1 - d0)  mod 2^32,
//   d0 = acc[g, 2s],  d1 = acc[g, 2s + 1]
//
// (tgsw.cmux of each group's rows with the group's own selector; the tree
// runs one launch a level, a launch's LUT instances as the groups).  acc
// (G, 2S, k+1, N) int32, its groups any multiple of 4 elements apart (0:
// the leaves, which every group shares); sel (G, k+1, l, k+1, N) int32, the
// rows of each group's selector, likewise; out (G, S, k+1, N) int32.  The
// product is the engines' exact one: l balanced digits of bgbit <= 8 bits
// (int8) of each polynomial of d1 - d0, times the selector's four balanced
// int8 limbs, int32 sums (below J * N * 2^14 < 2^31), recombined mod 2^32.
//
// Replaces no Pallas kernel: the JAX package vmaps tgsw.cmux over the
// instances, each on its own dense negacyclic key.  Bound by its int8 MACs,
// G * S * (k+1) l N * (k+1) N * 4 a level (32.2 G over the tree of 64
// four-bit LUTs at CB_ACTIVE, 0.033 ms at 1,979 T int8 op/s; its bytes,
// the selectors once and the tree's rows, take 7 us).  A group has at most
// 2^(k-1) rows, so no plan runs near that bound; what the design does:
//   * No key in device memory.  A block stages its selector's doubled,
//     reversed limb vectors b[m] = limb(v[(N - m) mod 2N]), v = [key, -key]
//     (4 * J * 2N bytes, 32 KB at CB_ACTIVE), from the int32 rows, so that
//     row i of the negacyclic key over the columns t .. t + 7 is the run
//     b[N - i + t .. + 8).
//   * The key is wgmma's A operand, from registers: 64 output coefficients
//     of a tile x 32 K-bytes.  The digits of at most ROWS = 8 rows are B
//     (m64n8k32), one copy in shared memory, 128-byte swizzled.  K is
//     permuted inside each 32-byte step (slots 4q .. 4q+3 and 16+4q ..
//     16+4q+3 hold positions 8q .. 8q+7), so that a thread's 8 bytes of a
//     row are one run; a thread's two rows of a tile lie 32 coefficients
//     apart (rows 16w + g and 16w + g + 8 are coefficients c + 32 and c,
//     c = 8w + g, tile tau adding 64 tau), so the run a row needs at step s
//     is the one the row 32 above it used at step s - 1.  A thread keeps
//     2T runs a limb in a ring of registers and loads one new run a limb a
//     step (3 words, 2 funnel shifts) for T tiles of 64 coefficients.
//   * A block is (group, chunk of ROWS rows, output polynomial u, 64 T
//     coefficients), every limb; the blocks of one (group, u) are adjacent
//     in the grid (they stage the same vectors).  kernels.lut_cmux_plan
//     picks T = 4, or 1 where N is not a multiple of 256.
//   * d1 - d0 and its digits are formed while staging; d0 is added in the
//     epilogue.  One wgmma group in flight, a step's T * 4 m64n8k32
//     wgmmas; each step waits for the last (its new runs replace what the
//     last one read), so the wgmmas' latency, not their rate, sets the
//     time (PERF.md section 6).
#include "wgmma.cuh"

namespace {

using namespace tfhe;

constexpr int ROWS = 8;          // rows of a block: the wgmma's N
constexpr int LIMBS = 4;
constexpr int THREADS = 128;     // one warpgroup
constexpr int PAD = 16;          // bytes after each vector (a run's last word)

struct Args {
  const int32_t* acc;
  const int32_t* sel;
  int32_t* out;
  long long acc_g, sel_g;        // group strides, elements
  int S, chunks, kp1, l, J, N, bgbit, tiles;   // tiles: blocks along N
  uint32_t offset, xmask;
};

inline size_t smem_bytes(int J, int N) {
  return 1024 + (size_t)ROWS * J * N + (size_t)LIMBS * J * (2 * N + PAD);
}

// D (64 x 8, s32) += A (64 x 32, s8, registers) * B (8 x 32, s8, shared)^T:
// register i of a thread (warp w, lane 4g + q) holds A's row 16w + g
// (i = 0, 2) or 16w + g + 8 (i = 1, 3) at columns 4q + 16 (i >> 1) .. + 3;
// accumulator e holds row 16w + g + 8 (e >> 1), column 2q + (e & 1).
__device__ __forceinline__ void wgmma_rs(uint32_t (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_run(uint2& r) {
  asm volatile("" : "+r"(r.x), "+r"(r.y) :: "memory");
}

// The 8 bytes of a vector at byte offset o (>= 0): three aligned words.
__device__ __forceinline__ uint2 run8(const uint8_t* v, int o) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(v) + (o >> 2);
  const uint32_t sh = (o & 3) * 8, w0 = w[0], w1 = w[1], w2 = w[2];
  return make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
}

// Byte offset in the digit buffer of K position kk (= j N + t, t % 4 == 0)
// of row r: step kk / 32 in 1 KB atoms of 4 steps (8 rows x 128 bytes),
// slot 4q (position 8q) or 16 + 4q (position 8q + 4), swizzled chunk.
__device__ __forceinline__ int digit_off(int r, int kk) {
  const int step = kk >> 5, w = kk & 31;
  const int byte = ((step & 3) << 5) | ((w & 4) << 2) | ((w >> 3) << 2);
  return ((step >> 2) << 10) | (r << 7) | ((((byte >> 4) ^ r) & 7) << 4)
         | (byte & 15);
}

template <int T>
__global__ void __launch_bounds__(THREADS)
lut_cmux_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* dig = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int N = a.N, J = a.J, VB = 2 * N + PAD;
  uint8_t* keyv = dig + (size_t)ROWS * J * N;  // (limb, j) vectors
  int b = blockIdx.x;                           // ((g, chunk), u, tile)
  const int tile = b % a.tiles;
  b /= a.tiles;
  const int u = b % a.kp1;
  b /= a.kp1;
  const int chunk = b % a.chunks, g = b / a.chunks;
  const int s0 = chunk * ROWS, nr = min(ROWS, a.S - s0);
  const int rowlen = a.kp1 * N;
  const int32_t* acc = a.acc + g * a.acc_g;
  const int32_t* sel = a.sel + g * a.sel_g;

  // the digits of d1 - d0 of the block's rows (rows past S: zeros)
  const int quads = N >> 2, per_row = a.kp1 * quads;
  for (int it = threadIdx.x; it < ROWS * per_row; it += THREADS) {
    const int r = it / per_row, rem = it - r * per_row;
    const int p = rem / quads, t = (rem - p * quads) << 2;
    const bool live = r < nr;
    uint32_t dv[4] = {0u, 0u, 0u, 0u};
    if (live) {
      const int32_t* x0 = acc + (size_t)(2 * (s0 + r)) * rowlen + p * N + t;
      const uint4 v0 = __ldg(reinterpret_cast<const uint4*>(x0));
      const uint4 v1 = __ldg(reinterpret_cast<const uint4*>(x0 + rowlen));
      // digit w is ((d + offset) >> (32 - (w+1) bgbit) & mask) - half:
      // the bgbit-bit field of (d + offset) ^ xmask, sign-extended
      dv[0] = (v1.x - v0.x + a.offset) ^ a.xmask;
      dv[1] = (v1.y - v0.y + a.offset) ^ a.xmask;
      dv[2] = (v1.z - v0.z + a.offset) ^ a.xmask;
      dv[3] = (v1.w - v0.w + a.offset) ^ a.xmask;
    }
    for (int w = 0; w < a.l; ++w) {
      uint32_t f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        f[k] = (uint32_t)((int32_t)(dv[k] << (w * a.bgbit))
                          >> (32 - a.bgbit));
      const uint32_t word = __byte_perm(__byte_perm(f[0], f[1], 0x0040),
                                        __byte_perm(f[2], f[3], 0x0040),
                                        0x5410);
      *reinterpret_cast<uint32_t*>(dig + digit_off(r, (p * a.l + w) * N + t))
          = live ? word : 0u;
    }
  }

  // the selector's vectors of output polynomial u, every limb: byte m of
  // vector (limb, j) is the limb of v[(N - m) mod 2N], v = [key, -key]
  const int words = (2 * N) >> 2;
  for (int it = threadIdx.x; it < J * words; it += THREADS) {
    const int j = it / words, m0 = (it - j * words) << 2;
    const uint32_t* kp = reinterpret_cast<const uint32_t*>(sel)
                         + ((size_t)j * a.kp1 + u) * N;
    uint32_t lw[LIMBS] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + i;
      uint32_t x = m == 0 ? 0u - kp[0]
                   : m <= N ? kp[N - m] : 0u - kp[2 * N - m];
#pragma unroll
      for (int lm = 0; lm < LIMBS; ++lm) {
        const uint32_t limb = (((x & 255u) + 128u) & 255u) - 128u;
        lw[lm] |= (limb & 255u) << (8 * i);
        x = (x - limb) >> 8;
      }
    }
#pragma unroll
    for (int lm = 0; lm < LIMBS; ++lm)
      *reinterpret_cast<uint32_t*>(keyv + (size_t)(lm * J + j) * VB + m0)
          = lw[lm];
  }
  fence_async_smem();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, q = lane & 3;
  const int c = tile * 64 * T + 8 * warp + g8;  // the thread's lowest row
  const int o0 = N - c + 8 * q;                 // run offset at step 0
  const uint32_t dbase = smem_addr(dig);
  const int steps = N >> 5;
  uint32_t d[T][LIMBS][4];
#pragma unroll
  for (int tau = 0; tau < T; ++tau)
#pragma unroll
    for (int lm = 0; lm < LIMBS; ++lm)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[tau][lm][e] = 0u;

  for (int j = 0; j < J; ++j) {
    const uint8_t* kv = keyv + (size_t)j * VB;
    // run[lm][x mod 2T] holds the run of the thread's lowest row at step x
    // (for limb lm), which is also the run of the row 32 m above it at
    // step x + m: step s reads steps s - 2T + 1 .. s.  The step loop is
    // unrolled by 2T, so the ring's slots are registers and nothing moves
    // between them; step s writes its slot only after the wait for step
    // s - 1's wgmmas, the last readers of the run it replaces (a run
    // written while a wgmma that reads its register is in flight makes
    // ptxas serialize every wgmma, C7513: 1.6 times slower).
    uint2 run[LIMBS][2 * T];
#pragma unroll
    for (int lm = 0; lm < LIMBS; ++lm)
#pragma unroll
      for (int m = 1; m < 2 * T; ++m)
        run[lm][2 * T - m] = run8(kv + (size_t)lm * J * VB, o0 - 32 * m);
    for (int sb = 0; sb < steps; sb += 2 * T) {
#pragma unroll
      for (int i = 0; i < 2 * T; ++i) {
        const int s = sb + i;
        wgmma_wait<0>();
#pragma unroll
        for (int lm = 0; lm < LIMBS; ++lm) {
          run[lm][i] = run8(kv + (size_t)lm * J * VB, o0 + 32 * s);
#pragma unroll
          for (int m = 0; m < 2 * T; ++m) fence_run(run[lm][m]);
        }
#pragma unroll
        for (int tau = 0; tau < T; ++tau)
#pragma unroll
          for (int lm = 0; lm < LIMBS; ++lm) fence_regs(d[tau][lm]);
        wgmma_fence();
        const int ks = j * steps + s;
        const uint64_t db = sw128_desc(dbase + ((ks >> 2) << 10)
                                       + ((ks & 3) << 5));
#pragma unroll
        for (int tau = 0; tau < T; ++tau) {
          // rows 16w + g (coefficient c + 64 tau + 32) and 16w + g + 8
          // (c + 64 tau): the runs of steps s - 2 tau - 1 and s - 2 tau
          const int hi = (i + 4 * T - 2 * tau - 1) % (2 * T);
          const int lo = (i + 4 * T - 2 * tau) % (2 * T);
#pragma unroll
          for (int lm = 0; lm < LIMBS; ++lm)
            wgmma_rs(d[tau][lm], run[lm][hi].x, run[lm][lo].x,
                     run[lm][hi].y, run[lm][lo].y, db);
        }
        wgmma_commit();
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int tau = 0; tau < T; ++tau)
#pragma unroll
    for (int lm = 0; lm < LIMBS; ++lm) fence_regs(d[tau][lm]);

  // out = d0 + sum_lm D_lm << 8 lm, mod 2^32: accumulator e of tile tau is
  // coefficient c + 64 tau + 32 (1 - (e >> 1)), row 2q + (e & 1)
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 2 * q + (e & 1);
    if (r >= nr) continue;
    const size_t row = (size_t)(s0 + r);
    const int32_t* d0 = acc + 2 * row * rowlen + u * N;
    int32_t* o = a.out + ((size_t)g * a.S + row) * rowlen + u * N;
#pragma unroll
    for (int tau = 0; tau < T; ++tau) {
      const int i = c + 64 * tau + ((e >> 1) ? 0 : 32);
      uint32_t v = (uint32_t)d0[i];
#pragma unroll
      for (int lm = 0; lm < LIMBS; ++lm) v += d[tau][lm][e] << (8 * lm);
      o[i] = (int32_t)v;
    }
  }
}

template <int T>
int launch(const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.J, a.N);
  cudaError_t e = cudaFuncSetAttribute(
      lut_cmux_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  lut_cmux_kernel<T><<<blocks, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ``T``: 64 T output coefficients a block, 1 or 4
// (kernels.lut_cmux_plan).  N a multiple of 64 T; bgbit <= 8 with l *
// bgbit <= 32; acc, sel and out 16-byte aligned, group strides multiples of
// 4 elements (acc_g may be 0); the shared memory of J = (k+1) l digit
// polynomials must fit a block (kernels.lut_cmux_smem).
extern "C" int tfhe_lut_cmux(const void* acc, long long acc_g,
                             const void* sel, long long sel_g, void* out,
                             int G, int S, int kp1, int l, int N, int bgbit,
                             unsigned offset, int T, void* stream) {
  if (G < 1 || S < 1 || kp1 < 1 || l < 1 || bgbit < 1 || bgbit > 8
      || l * bgbit > 32 || N < 64 || N % (64 * T) != 0 || acc_g < 0
      || acc_g % 4 != 0 || sel_g < 0 || sel_g % 4 != 0
      || smem_bytes(kp1 * l, N) > 232448)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.acc = (const int32_t*)acc;
  a.sel = (const int32_t*)sel;
  a.out = (int32_t*)out;
  a.acc_g = acc_g;
  a.sel_g = sel_g;
  a.S = S;
  a.chunks = (S + ROWS - 1) / ROWS;
  a.kp1 = kp1;
  a.l = l;
  a.J = kp1 * l;
  a.N = N;
  a.bgbit = bgbit;
  a.tiles = N / (64 * T);
  a.offset = offset;
  a.xmask = 0;
  for (int w = 0; w < l; ++w)
    a.xmask |= (1u << (bgbit - 1)) << (32 - (w + 1) * bgbit);
  const long long blocks = (long long)G * a.chunks * kp1 * a.tiles;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (T == 1) return launch<1>(a, (int)blocks, s);
  if (T == 4) return launch<4>(a, (int)blocks, s);
  return (int)cudaErrorInvalidValue;
}
