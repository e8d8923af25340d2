// Shared pieces of the two rotate-decompose digit emitters
// (rotate_decompose.cu, 32-bit; rotate_decompose64_ck.cu, 64-bit): gadget
// digits of (X^a - 1) * acc, one 16-coefficient run a work item.
//
// Both are bound by bytes (a word read and l*P digit bytes written per
// coefficient), so the design keeps every global access 16 bytes wide:
//
//   * a block stages R batch rows (all k+1 polynomials of each) in shared
//     memory with 16-byte vector loads, one padding word after every 16
//     (word i at i + i/16), so that the 16 threads of a half-warp, each
//     reading word n0 - a + e of its own run n0 = 16 j, hit 16 different
//     banks (64-bit words) and the 32 threads of a warp 32 (32-bit words);
//   * a thread owns 16 consecutive coefficients of one polynomial of one
//     row (a work item), forms their 16 differences (X^a x - x + offset,
//     mod 2^W) from shared memory (the rotated source of 16 consecutive n
//     is a contiguous run, with one sign flip at the X^N wrap) and writes
//     each of its l*P digit runs with one 16-byte store; neighbouring
//     threads own neighbouring runs, so a warp's stores cover contiguous
//     512-byte spans (32-bit layout) or whole 16-byte-aligned runs of the
//     chunk layout;
//   * the grid is (ceil(B / R), S): R rows a block where a row has too few
//     work items for a block, S slices of a row's work items (each block
//     stages the whole row) where the batch is too narrow to give half the
//     SMs a block.  kernels.rotdec_plan chooses (R, S, threads).
//
// Two other stagings were measured and lost at CB_MXU B=256 on an H100:
// one bulk TMA copy a row into an unpadded buffer (its rotated reads
// conflict on the banks) and no staging at all (PERF.md, Findings).
//
// N is a power of two and a multiple of 16; every index below is a shift
// or a mask of one, so the inner loop has no runtime division.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tfhe {

// Shared-memory index of word i of a staged row.
__device__ __forceinline__ int rd_idx(int i) { return i + (i >> 4); }

// Words of shared memory one staged row of ``words`` words takes.
__host__ __device__ __forceinline__ int rd_row_words(int words) {
  return words + words / 16;
}

// Stage row b0 + threadIdx.y (kp1*N = ``words`` words of acc) for every y
// of the block into s, then __syncthreads.  Rows past B are left unstaged.
template <typename W>
__device__ __forceinline__ void rd_stage(W* s, const W* __restrict__ acc,
                                         int b0, int B, int words) {
  constexpr int PER = 16 / sizeof(W);            // words per 16-byte load
  if ((int)threadIdx.y < min((int)blockDim.y, B - b0)) {
    const uint4* src = reinterpret_cast<const uint4*>(
        acc + (size_t)(b0 + threadIdx.y) * words);
    W* dst = s + (size_t)threadIdx.y * rd_row_words(words);
    const int vecs = words / PER;
#pragma unroll 4
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      const uint4 q = __ldg(src + v);
      const W* w = reinterpret_cast<const W*>(&q);
      W* d = dst + rd_idx(v * PER);             // PER words of one group
#pragma unroll
      for (int e = 0; e < PER; ++e) d[e] = w[e];
    }
  }
  __syncthreads();
}

// The rotation of one batch row: r = a mod N, neg = the X^N sign.
struct RdRot {
  int r;
  bool neg;
};

__device__ __forceinline__ RdRot rd_rot(const int32_t* a, int b, int N,
                                        int logN) {
  const int av = a[b] & (2 * N - 1);
  return {av & (N - 1), ((av >> logN) & 1) != 0};
}

// d[e] = (X^a x)[n0 + e] - x[n0 + e] + offset mod 2^W, e < 16, for the
// polynomial whose staged words start at shared index p0 (= rd_idx(u*N)).
template <typename W>
__device__ __forceinline__ void rd_diffs(W (&d)[16], const W* s, int p0,
                                         int n0, RdRot rot, int N,
                                         W offset) {
  const int t0 = n0 - rot.r;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int t = t0 + e;                        // in (-N, N)
    W v = s[p0 + rd_idx(t & (N - 1))];
    if ((t < 0) != rot.neg) v = W(0) - v;
    d[e] = v - s[p0 + rd_idx(n0 + e)] + offset;
  }
}

// Digit lv of each of 16 words, ((d >> (Wbits - (lv+1) bgbit)) & mask) -
// half, as ints.
template <typename W>
__device__ __forceinline__ void rd_digits(int (&g)[16], const W (&d)[16],
                                          int lv, int bgbit) {
  const int sh = 8 * (int)sizeof(W) - (lv + 1) * bgbit;
  const W mask = (W(1) << bgbit) - 1;
  const int half = 1 << (bgbit - 1);
#pragma unroll
  for (int e = 0; e < 16; ++e) g[e] = (int)((d[e] >> sh) & mask) - half;
}

// The low bytes of 16 ints, in order, as one 16-byte word.
__device__ __forceinline__ uint4 rd_pack(const int (&g)[16]) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = __byte_perm(__byte_perm(g[4 * q], g[4 * q + 1], 0x0040),
                       __byte_perm(g[4 * q + 2], g[4 * q + 3], 0x0040),
                       0x5410);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Threads a block at most: the kernels' __launch_bounds__, which leave
// them 128 registers a thread.
constexpr int RD_MAX_THREADS = 512;

// The launch shape of a plan: (ceil(B / rows), split) blocks of (threads,
// rows) threads, R rows of ``words`` words staged.  Returns false where the
// plan cannot launch.
inline bool rd_launch_shape(int B, int words, size_t word_bytes, int rows,
                            int split, int threads, dim3* grid, dim3* block,
                            size_t* smem) {
  if (rows < 1 || split < 1 || threads < 32 || threads % 32 != 0 ||
      rows * threads > RD_MAX_THREADS)
    return false;
  *grid = dim3((B + rows - 1) / rows, split);
  *block = dim3(threads, rows);
  *smem = (size_t)rows * rd_row_words(words) * word_bytes;
  return *smem <= 232448;
}

}  // namespace tfhe
