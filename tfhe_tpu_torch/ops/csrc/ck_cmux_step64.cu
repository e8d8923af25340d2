// ck_cmux_step64: one whole 64-bit blind-rotation step on chunked keys, on
// Hopper,
//
//   out[b, u*N + i] = acc[b, u*N + i]
//                     + sum_l fold(x . wmt[u*L + l])[b, i] << (8 l + key_shift)
//
// mod 2^64, where x_c[b, j*m + s] is digit j = (u', lv) of coefficient
// c*m + s of (X^a[b] - 1) * acc[b, u'] (gadget offset added in uint64, split
// into P balanced base-2^7 planes when P = 2) and fold is ck_dot64p.cu's
// X^N = -1 fold of the chunk products.  a (B,) int32, acc / out (B, kp1*N)
// int64 (the flat Torus64 accumulator; the (B, k+1, N) layout is the same
// bytes), wmt (kp1*L, N+m, Jm) int8 with Jm = kp1*l*m, the K-packed chunked
// key of ChunkedEngine.prepare.
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:ck_cmux_step64.  Bound by int8
// tensor-core MACs on paper (B*(k+1)N outputs x J*N terms x L limbs x P
// planes); on the card by the L2 traffic of the key tiles and of acc, which
// every block reads again to build its digits.  The TPU kernel keeps the
// whole key block of one output polynomial in VMEM (~8 MB at CB_MXU); no SM
// holds that.  Here the grid is ck_dot64p_sacc's: a block owns 64 folded
// columns of LG = 4 consecutive limb rows of wmt (stacked along the wgmma's
// N: one m64n256k32 a k32 step) for 64 WG batch rows, and its epilogue is
// ck_add_atomic's (64-bit atomicAdd into an output the launcher filled with
// acc).  What differs is the A operand: no x in device memory, the block
// builds it.
//   * Items: per plane (highest first) the tile's chunk windows, added
//     chunks [0, add_end) then subtracted ones [sub_begin, C), as
//     ck_wgmma.cuh's ck_consume walks them; an item is chunk c's digit rows
//     of plane p, J*m bytes a row in ktiles swizzled 128-byte K tiles (the
//     layout TMA would write; chunk c of row r at c ^ (r & 7)).  The
//     overlapping chunk (c = i0 / m at m = 64) is built twice, once a sign,
//     which keeps the in-place negations: C + 1 builds per plane.
//   * Key tiles by TMA: thread 0 streams the item's ktiles boxes of 128
//     K-bytes x 64 rows x LG limb rows of wmt into an mbarrier ring,
//     refilling a stage as soon as every warp has released it; TMA
//     zero-fills key rows outside [0, N+m), the window mask, and K columns
//     past J*m.  No producer warp: a block of 256 threads may hold 255
//     registers a thread, where ptxas held a 288-thread block to 168 and
//     spilled (PERF.md §6).
//   * Digits by the block's warps, double-buffered: the 128 WG threads
//     build item i+1 in part kt of ktiles while the wgmmas of item i's K
//     tile kt run (commit, build, wait), straight from acc: X^a * acc read
//     at (n - a) mod N with one sign flip per wrap, a uint64 subtract and
//     offset add, then d ^ xmask (each field's top bit flipped), whose
//     bgbit-bit fields read as signed integers are the l digits (bytes at
//     bgbit = 8; one plane of each at P = 2: p0 = ((d+64)&127)-64, p1 =
//     (d-p0)/128), four coefficients packed a word, one work item a thread
//     at a time (loads of several items in flight measured slower,
//     PERF.md §6).  fence.proxy.async
//     and a named barrier of the block hand a built item to the async
//     proxy.  Rows past B are neither built nor stored (a row of A reaches
//     only its own row of the product); the K tail past J*m is zeroed once.
//   * One register set for every item: d is negated before the subtracted
//     windows of a plane and after them, shifted by 7 between planes
//     (mod 2^32), with each stage's wgmma group waited for (ck_wgmma.cuh:
//     C7515).
//   * Split: a tile's windows may be cut into S contiguous slices, one block
//     each, every slice running its windows for every plane (the plan,
//     kernels.ck_cmux_step64_plan).  A slice's partial fold sums a subset of
//     the whole fold's terms, so it stays inside the int32 bound that the
//     wrapper asserts for the whole (J*(N+m)*|digit|*128 < 2^31) and widens
//     exactly; the slices' atomic adds commute mod 2^64.
// Shared memory: two item buffers of ktiles x 64 WG x 128 bytes (160 KB at
// CB_MXU and 128 rows) and a ring of as many 32 KB key stages as fit, at
// least 2 (ring_stages; the plan asks tfhe_ck_cmux_step64_stages).  Each
// block rebuilds its rows' digits for every column tile and limb group it
// owns: at CB_MXU B=256 (128 rows, S = 1) 192 blocks x 33 items read ~8.4
// MB of acc from L2 each, about as much L2 traffic as the key tiles, and
// the builds set the kernel's time.  Two other designs were tried and
// measured no faster at CB_MXU (PERF.md §6): one build shared among a
// tile's limb groups (a thread-block cluster writing through distributed
// shared memory), and a third warpgroup that only builds.
// Registers (-Xptxas -v, sm_90a): PERF.md §6; no spills.
// CK_PART strips it as ck_wgmma.cuh says (1: key loads, 2: wgmmas, 3: the
// epilogue), and 4 keeps the digit builds alone.
#include "ck_wgmma.cuh"

namespace {

using namespace tfhe;

constexpr bool BUILDS = CK_PART == 0 || CK_PART == 4;
constexpr bool LOADS = CK_PART == 0 || CK_PART == 1;
constexpr bool MMAS = CK_PART == 0 || CK_PART == 2;
constexpr int TN = 64, NN = 256;             // folded columns, stacked rows
constexpr int STAGE = NN * CKW_BK;           // one key tile, 32 KB

struct Args {
  const int32_t* expo;
  const int64_t* acc;
  uint64_t offset, xmask;
  int kp1, logN, l, bgbit, split, stages;
  int groups;            // limb groups of 4 rows of wmt
  int qshift;            // log2(m / 4)
  uint32_t kp1_magic;    // ceil(2^32 / kp1), kp1 > 1: rest / kp1 = umulhi
};

__host__ __device__ constexpr size_t buffer_bytes(int rows, int ktiles) {
  return (size_t)ktiles * rows * CKW_BK;
}

// Dynamic shared memory of a block: 1 KB of alignment slack, two item
// buffers, the key ring, its barriers and the rows' exponents.
constexpr size_t smem_bytes(int rows, int ktiles, int stages) {
  return 1024 + 2 * buffer_bytes(rows, ktiles)
         + (size_t)stages * (STAGE + 2 * sizeof(uint64_t))
         + rows * sizeof(int);
}

// The ring's stages: as many as fit, at most CKW_MAX_STAGES; 0 where fewer
// than two do.
constexpr int ring_stages(int rows, int ktiles) {
  const size_t base = smem_bytes(rows, ktiles, 0);
  if (base >= CKW_MAX_SMEM) return 0;
  const size_t n = (CKW_MAX_SMEM - base) / (STAGE + 2 * sizeof(uint64_t));
  const int S = n < CKW_MAX_STAGES ? (int)n : CKW_MAX_STAGES;
  return S >= 2 ? S : 0;
}

// The windows of a block's slice: [w_lo, w_hi) of the tile's add_end +
// C - sub_begin windows (added chunks first), and item i's plane and chunk.
struct Slice {
  int add_end, sub_begin, w_lo, ns;

  __device__ __forceinline__ Slice(int i0, const CkShape& g, int S, int s) {
    add_end = ck_add_end<TN>(i0, g);
    sub_begin = ck_sub_begin(i0, g);
    const int nw = add_end + g.C - sub_begin;
    w_lo = s * nw / S;
    ns = (s + 1) * nw / S - w_lo;
  }
  __device__ __forceinline__ int items(const CkShape& g) const {
    return g.P * ns;
  }
  __device__ __forceinline__ int plane(int i, const CkShape& g) const {
    return g.P - 1 - i / ns;
  }
  __device__ __forceinline__ bool sub(int i) const {
    return w_lo + i % ns >= add_end;
  }
  __device__ __forceinline__ int chunk(int i) const {
    const int w = w_lo + i % ns;
    return w < add_end ? w : sub_begin + w - add_end;
  }
};

// y[j] = byte j of x[0], x[1], x[2], x[3] (a 4 x 4 byte transpose).
__device__ __forceinline__ void transpose4(const uint32_t (&x)[4],
                                           uint32_t* y) {
  const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140);
  const uint32_t t1 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t t3 = __byte_perm(x[2], x[3], 0x7362);
  y[0] = __byte_perm(t0, t2, 0x5410);
  y[1] = __byte_perm(t0, t2, 0x7632);
  y[2] = __byte_perm(t1, t3, 0x5410);
  y[3] = __byte_perm(t1, t3, 0x7632);
}

// Work items [lo, hi) of one item's build: item t = (row, u', quad q) is
// coefficients c*m + 4q .. + 3 of polynomial u' of row b0 + row, each
// giving its l digits (plane p) as l words at K bytes (u'*l + lv)*m + 4q of
// the buffer at ``buf``.
template <int P, int ROWS, int T>
__device__ __forceinline__ void build(uint8_t* buf, const Args& a,
                                      const CkShape& g, const int* rot,
                                      int b0, int p, int c, int lo, int hi,
                                      int ctid) {
  const int N = g.N, m = g.m, kp1 = a.kp1;
  const size_t UN = (size_t)kp1 * N;
#pragma unroll 1
  for (int t = lo + ctid; t < hi; t += T) {
    const int q = t & ((m >> 2) - 1), rest = t >> a.qshift;
    const int row = kp1 == 1 ? rest : (int)__umulhi(rest, a.kp1_magic);
    const int up = rest - row * kp1;
    const int av = rot[row];                  // before this call's stores
    const uint64_t* xr = reinterpret_cast<const uint64_t*>(a.acc)
                         + (size_t)(b0 + row) * UN + (size_t)up * N;
    const int n0 = c * m + 4 * q, r = av & (N - 1);
    const ulonglong2 o01 = *reinterpret_cast<const ulonglong2*>(xr + n0);
    const ulonglong2 o23 = *reinterpret_cast<const ulonglong2*>(xr + n0 + 2);
    const uint64_t ov[4] = {o01.x, o01.y, o23.x, o23.y};
    uint64_t rv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) rv[e] = __ldg(xr + ((n0 + e - r) & (N - 1)));
    const bool flip = (av >> a.logN) & 1;     // X^N = -1
    // digit lv of d is its bgbit-bit field lv minus half: the field of
    // d ^ xmask (each field's top bit flipped) read as a signed integer
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool neg = (n0 + e < r) != flip;  // wrapped once: negate
      const uint64_t d = ((neg ? 0ull - rv[e] : rv[e]) - ov[e] + a.offset)
                         ^ a.xmask;
      hi[e] = (uint32_t)(d >> 32);
      lo[e] = (uint32_t)d;
    }
    uint8_t* dst = buf + (size_t)row * CKW_BK;
    const int swz = row & 7, kbase = up * a.l * m + 4 * q;
    // level lv's word (the four coefficients' digits, a byte each) into K
    // bytes kbase + lv*m .. + 3 of the row
    auto put = [&](int lv, uint32_t w) {
      const int k = kbase + lv * m, kb = k & (CKW_BK - 1);
      *reinterpret_cast<uint32_t*>(
          dst + (k >> 7) * ROWS * CKW_BK
          + ((((kb >> 4) ^ swz) << 4) | (kb & 15))) = w;
    };
    // the generic level: the field's top bit shifted to bit 63, then an
    // arithmetic shift down
    auto level = [&](int lv) {
      const int sh = lv * a.bgbit;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t top = sh < 32 ? __funnelshift_l(lo[e], hi[e], sh)
                                     : lo[e] << (sh - 32);
        const int dig = (int)top >> (32 - a.bgbit);
        int pv = dig;
        if (P == 2) {
          const int p0 = ((dig + 64) & 127) - 64;
          pv = p ? (dig - p0) >> 7 : p0;
        }
        v[e] = (uint32_t)pv;
      }
      put(lv, __byte_perm(__byte_perm(v[0], v[1], 0x0040),
                          __byte_perm(v[2], v[3], 0x0040), 0x5410));
    };
    if (P == 1 && a.bgbit == 8) {
      // digit lv is byte 7 - lv of d ^ xmask: levels 0-3 are the 4 x 4 byte
      // transpose of hi[0..3], levels 4-7 that of lo[0..3]
      uint32_t y[8];
      transpose4(hi, y + 4);
      transpose4(lo, y);
#pragma unroll
      for (int lv = 0; lv < 8; ++lv)
        if (lv < a.l) put(lv, y[7 - lv]);
    } else {
      for (int lv = 0; lv < a.l; ++lv) level(lv);
    }
  }
}

// Thread 0's TMA load of K tile ``q`` (item q / ktiles) of the block's
// walk into stage ``s``.
__device__ __forceinline__ void load_key(uint8_t* ring, uint64_t* full,
                                         const CUtensorMap* wmap,
                                         const CkShape& g, const Slice& sl,
                                         int i0, int g0, int q, int s) {
  const int i = q / g.ktiles, kt = q - i * g.ktiles;
  mbar_arrive_tx(&full[s], STAGE);
  tma_load_3d(ring + (size_t)s * STAGE, wmap, &full[s], kt * CKW_BK,
              (sl.sub(i) ? g.N : 0) + i0 - sl.chunk(i) * g.m, g0);
}

template <int P, int WG>
__global__ void __launch_bounds__(128 * WG, 1)
ck_cmux64_kernel(__grid_constant__ const CUtensorMap wmap, const CkShape g,
                 const Args a, const CkAtomicOut o) {
  constexpr int ROWS = 64 * WG, R = NN / 2, LG = NN / TN;
  constexpr int T = 128 * WG;                 // threads, all of them build
  using Pl = CkPlan<WG, TN, NN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const size_t bufsz = buffer_bytes(ROWS, g.ktiles);
  uint8_t* ring = base + 2 * bufsz;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + (size_t)a.stages * STAGE);
  uint64_t* empty = full + a.stages;
  int* rot = reinterpret_cast<int*>(empty + a.stages);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = blockIdx.x * TN, b0 = blockIdx.y * ROWS;
  const int g0 = (blockIdx.z % a.groups) * LG;
  const Slice sl(i0, g, a.split, blockIdx.z / a.groups);
  const int n = sl.items(g);

  const int total = n * g.ktiles;             // K tiles of the walk
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG);           // lane 0 of each warp
    }
    mbar_fence_init();
    if (LOADS) {                              // the ring's first fill
      prefetch_map(&wmap);
      for (int q = 0; q < a.stages && q < total; ++q)
        load_key(ring, full, &wmap, g, sl, i0, g0, q, q);
    }
  }
  for (int i = tid; i < ROWS; i += blockDim.x) {
    const int b = b0 + i;
    rot[i] = b < g.B ? a.expo[b] & (2 * g.N - 1) : 0;
  }
  __syncthreads();

  const int wg = warp >> 2, ctid = tid;
  const int live = min(ROWS, g.B - b0);       // rows whose digits are built
  const int work = live * a.kp1 * (g.m >> 2);
  // the K tail of both buffers (whole 16-byte chunks past J*m of the last
  // tile: J*m is a multiple of 16), which no build writes
  const int tail_from = (a.kp1 * a.l * g.m - (g.ktiles - 1) * CKW_BK) >> 4;
  for (int i = ctid; i < 2 * ROWS * 8; i += T) {
    const int row = (i >> 3) % ROWS, c16 = i & 7;
    if (c16 >= tail_from)
      *reinterpret_cast<uint4*>(
          base + (size_t)((i >> 3) / ROWS) * bufsz
          + (size_t)(g.ktiles - 1) * ROWS * CKW_BK + row * CKW_BK
          + ((c16 ^ (row & 7)) << 4)) = make_uint4(0, 0, 0, 0);
  }
  if (BUILDS && n > 0)
    build<P, ROWS, T>(base, a, g, rot, b0, sl.plane(0, g), sl.chunk(0), 0,
                      work, ctid);
  fence_async_smem();
  named_sync(1, T);

  uint32_t d[R];
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0;
  bool neg = false;
  int s = 0;
  uint32_t ph = 0;
  for (int i = 0; i < n; ++i) {
    if (i > 0 && i % sl.ns == 0) {            // the next plane: Horner
      if (neg) ck_negate(d);
      neg = false;
#pragma unroll
      for (int j = 0; j < R; ++j) d[j] <<= 7;
    }
    if (sl.sub(i) && !neg) {
      ck_negate(d);
      neg = true;
    }
    const uint8_t* buf = base + (size_t)(i & 1) * bufsz;
    uint8_t* next = base + (size_t)((i + 1) & 1) * bufsz;
    const int pn = i + 1 < n ? sl.plane(i + 1, g) : 0;
    const int cn = i + 1 < n ? sl.chunk(i + 1) : 0;
    for (int kt = 0; kt < g.ktiles; ++kt) {
      if (LOADS && tid == 0) {
        // refill the stage the previous K tile released (by now every
        // warp has, or nearly): K tile q - 1 + stages
        const int q = i * g.ktiles + kt - 1 + a.stages;
        if (q >= a.stages && q < total) {
          const int sp = s == 0 ? a.stages - 1 : s - 1;
          mbar_wait(&empty[sp], s == 0 ? ph ^ 1 : ph);
          load_key(ring, full, &wmap, g, sl, i0, g0, q, sp);
        }
      }
      __syncwarp();
      if (LOADS) mbar_wait(&full[s], ph);
      if (MMAS) {
        const uint64_t da = sw128_desc(smem_addr(
            buf + (size_t)kt * ROWS * CKW_BK + wg * 64 * CKW_BK));
        const uint64_t db = sw128_desc(smem_addr(ring + (size_t)s * STAGE));
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < CKW_BK / 32; ++k)
          wgmma(d, da + 2 * k, db + 2 * k);
        wgmma_commit();
      }
      if (BUILDS && i + 1 < n)                // overlaps the wgmmas in flight
        build<P, ROWS, T>(next, a, g, rot, b0, pn, cn, kt * work / g.ktiles,
                          (kt + 1) * work / g.ktiles, ctid);
      if (MMAS) {
        wgmma_wait<0>();
        fence_regs(d);
      }
      if (LOADS) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      if (++s == a.stages) { s = 0; ph ^= 1; }
    }
    fence_async_smem();
    named_sync(1, T);
  }
  if (neg) ck_negate(d);
  ck_add_atomic<Pl>(d, g, o, i0, b0, g0, wg, warp & 3, lane);
}

template <int P, int WG>
int launch(const void* wmt, const void* acc, const CkShape& g, Args a,
           const CkAtomicOut& o, int Jm, cudaStream_t stream) {
  constexpr int ROWS = 64 * WG;
  a.stages = ring_stages(ROWS, g.ktiles);
  if (a.stages == 0) return (int)cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return (int)cudaErrorNotSupported;
  // wmt (UL, N+m, Jm) in boxes of 128 K-bytes x 64 rows x 4 limb rows
  const cuuint64_t rows = (cuuint64_t)g.N + g.m;
  const cuuint64_t wd[3] = {(cuuint64_t)Jm, rows, (cuuint64_t)g.UL};
  const cuuint64_t ws[2] = {(cuuint64_t)Jm, rows * Jm};
  const cuuint32_t wb[3] = {CKW_BK, TN, NN / TN};
  CUtensorMap wmap;
  if (!encode_i8_map(&wmap, wmt, 3, wd, ws, wb))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(ROWS, g.ktiles, a.stages);
  cudaError_t e = cudaFuncSetAttribute(
      ck_cmux64_kernel<P, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ce = ck_copy_acc(o.out, acc, (size_t)g.B * a.kp1 * g.N * 8,
                             stream);
  if (ce != 0) return ce;
  // grid z = (slice, limb group), the limb group fastest
  a.groups = (g.UL + NN / TN - 1) / (NN / TN);
  const dim3 grid(g.N / TN, (g.B + ROWS - 1) / ROWS, a.groups * a.split);
  ck_cmux64_kernel<P, WG><<<grid, 128 * WG, smem, stream>>>(wmap, g, a, o);
  return (int)cudaGetLastError();
}

}  // namespace

// The ring's key stages for a plan (0: the plan does not fit), which
// kernels.ck_cmux_step64_stages mirrors.
extern "C" int tfhe_ck_cmux_step64_stages(int rows, int Jm) {
  return ring_stages(rows, (Jm + CKW_BK - 1) / CKW_BK);
}

// The plan: ``rows`` 64 or 128 (one or two consumer warpgroups) and
// ``split`` slices of each tile's windows (kernels.ck_cmux_step64_plan
// chooses both).  N a multiple of 64 and of m, m a multiple of 4, Jm =
// kp1*l*m a multiple of 16, P 1 or 2, and the plan's ring at least two
// stages.
extern "C" int tfhe_ck_cmux_step64(const void* a, const void* acc,
                                   const void* wmt, void* out, int B, int kp1,
                                   int N, int m, int l, int L, int P,
                                   int bgbit, unsigned long long offset,
                                   int key_shift, int rows, int split,
                                   void* stream) {
  const int Jm = kp1 * l * m;
  if (Jm % 16 != 0 || (P != 1 && P != 2) || N % m != 0 || m % 4 != 0
      || (m & (m - 1)) != 0 || N % TN != 0 || split < 1)
    return (int)cudaErrorInvalidValue;
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  const CkShape g{B, N, m, N / m, P, 0, (Jm + CKW_BK - 1) / CKW_BK, kp1 * L};
  uint64_t xmask = 0;                         // each field's top bit
  for (int lv = 0; lv < l; ++lv)
    xmask |= 1ull << (63 - lv * bgbit);
  int qshift = 0;
  while ((4 << qshift) < m) ++qshift;
  const Args args{(const int32_t*)a, (const int64_t*)acc, (uint64_t)offset,
                  xmask, kp1, logN, l, bgbit, split, 0, 0, qshift,
                  (uint32_t)((0xFFFFFFFFull + kp1) / kp1)};
  const CkAtomicOut o{(int64_t*)out, kp1, L, key_shift};
  cudaStream_t s = (cudaStream_t)stream;
  if (P == 1 && rows == 64) return launch<1, 1>(wmt, acc, g, args, o, Jm, s);
  if (P == 1 && rows == 128) return launch<1, 2>(wmt, acc, g, args, o, Jm, s);
  if (P == 2 && rows == 64) return launch<2, 1>(wmt, acc, g, args, o, Jm, s);
  if (P == 2 && rows == 128) return launch<2, 2>(wmt, acc, g, args, o, Jm, s);
  return (int)cudaErrorInvalidValue;
}
