// materialize_w: the int8 negacyclic Toeplitz key of one CMux step,
//   W[l, j*N + t, u*N + i] = v[l, j, u, (i - t) mod 2N],
// from the O(N) doubled-limb vectors v (L, J, U, 2N); and its second entry,
// materialize_wt, the same key K-packed (transposed) for fused_cmux_step.cu,
//   Wt[l, u*N + i, j*N + t] = v[l, j, u, (i - t) mod 2N].
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:materialize_w.  Pure store
// bandwidth: it reads L*J*U*2N bytes and writes L*J*U*N*N.  Both entries
// run one kernel, because every output run is a contiguous run of one
// staged array b of the (l, j, u) vector:
//   * materialize_w: row (l, j, t), column block u is b[N - t .. 2N - t)
//     with b[m] = v[(m - N) mod 2N] (v rotated by N: 16-byte chunks of v);
//   * materialize_wt: row (l, u, i), column block j is b[N - i .. 2N - i)
//     with b[m] = v[(N - m) mod 2N] (v reversed, by __byte_perm).
// A run starts (N - r) mod 16 bytes past a 16-byte boundary, so a block
// stages 16 copies of the part of b its rows read, copy s shifted by s
// bytes (built from two aligned 16-byte chunks of b by __byte_perm): every
// run then starts 16-byte aligned in copy (N - r) & 15, and leaves as
// aligned 16-byte words with no register touching a single byte.
// A block owns ``rows`` rows of one vector and ``cols`` bytes of each row
// (cols = N but for N > 4096, where the 16 copies would not fit); the grid
// is (N / rows * N / cols, L*J*U), its plan kernels.materialize_w_plan,
// chosen from the SM count.  The copies take 16 * (rows + cols) bytes.
// Each staged run leaves by LDS.128 -> STG.128, a warp moving 512
// contiguous bytes of a row.  materialize_w's stores are st.global.cs
// (evict-first in the L2: a reader of W streams it once); materialize_wt's
// are plain, as fused_cmux_step_v2 and mm_recombine_acc reread Wt from the
// L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;

// b's 16-byte chunk a (indices taken mod 2N / 16 = nch) from v's row.
template <bool KPACKED>
__device__ __forceinline__ uint4 b_chunk(const uint4* vrow, int a, int nch) {
  if (!KPACKED) return __ldg(vrow + ((a + nch / 2) & (nch - 1)));
  // b[16a + e] = v[(N - 16a - e) mod 2N] = v[16c + 16 - e], c = N/16 - a - 1:
  // byte 0 of chunk c + 1, then bytes 15 .. 1 of chunk c
  const int c = (nch / 2 - a - 1) & (nch - 1);
  const uint4 x = __ldg(vrow + c), y = __ldg(vrow + ((c + 1) & (nch - 1)));
  return make_uint4(__byte_perm(x.w, y.x, 0x1234),
                    __byte_perm(x.z, x.w, 0x1234),
                    __byte_perm(x.y, x.z, 0x1234),
                    __byte_perm(x.x, x.y, 0x1234));
}

template <bool KPACKED>
__global__ void __launch_bounds__(MAX_THREADS)
matw_kernel(const int8_t* __restrict__ v, int8_t* __restrict__ out, int J,
            int U, int N, int rows, int cols) {
  extern __shared__ __align__(16) uint4 sc[];    // [16][nck] chunks
  const int y = blockIdx.y;                      // (l, j, u) flat
  const int u = y % U, j = (y / U) % J, l = y / (U * J);
  const int bands = N / cols;
  const int r0 = (blockIdx.x / bands) * rows, q0 = (blockIdx.x % bands) * cols;
  // the rows' runs b[N - r + q0 .. + cols), r in [r0, r0 + rows), lie in
  // chunks [c_lo, c_lo + nck) of b
  const int c_lo = (N - r0 - rows + q0) >> 4, nck = (rows + cols) >> 4;
  const int nch = N >> 3;                        // chunks of the 2N bytes
  const uint4* vrow = reinterpret_cast<const uint4*>(v + (size_t)y * 2 * N);
  for (int c = threadIdx.x; c < nck; c += blockDim.x) {
    const uint4 x = b_chunk<KPACKED>(vrow, c_lo + c, nch);
    const uint4 z = b_chunk<KPACKED>(vrow, c_lo + c + 1, nch);
    const uint32_t w[8] = {x.x, x.y, x.z, x.w, z.x, z.y, z.z, z.w};
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const uint32_t sel = 0x3210 + 0x1111 * (s & 3);
      const int q = s >> 2;
      sc[s * nck + c] = make_uint4(
          __byte_perm(w[q], w[q + 1], sel),
          __byte_perm(w[q + 1], w[q + 2], sel),
          __byte_perm(w[q + 2], w[q + 3], sel),
          __byte_perm(w[q + 3], w[q + 4], sel));
    }
  }
  // row r's run: out_row(r) + q0, of cols bytes
  const size_t row_stride = (size_t)(KPACKED ? J : U) * N;
  int8_t* base = out + q0 + (KPACKED
      ? ((size_t)(l * U + u) * N) * row_stride + (size_t)j * N
      : ((size_t)(l * J + j) * N) * row_stride + (size_t)u * N);
  __syncthreads();
  const int vsh = __ffs(cols) - 5;               // a run is 1 << vsh words
  const int items = rows << vsh, vmask = (1 << vsh) - 1;
  constexpr int UNROLL = 4;                      // loads in flight a thread
  for (int i0 = threadIdx.x; i0 < items; i0 += UNROLL * blockDim.x) {
    uint4 x[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int idx = i0 + k * blockDim.x;
      if (idx < items) {
        const int start = N - (r0 + (idx >> vsh)) + q0;
        x[k] = sc[(start & 15) * nck + (start >> 4) - c_lo + (idx & vmask)];
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int idx = i0 + k * blockDim.x;
      if (idx < items) {
        uint4* dst = reinterpret_cast<uint4*>(
            base + (size_t)(r0 + (idx >> vsh)) * row_stride) + (idx & vmask);
        if (KPACKED) *dst = x[k];
        else __stcs(dst, x[k]);
      }
    }
  }
}

template <bool KPACKED>
int launch(const void* v, void* out, int L, int J, int U, int N, int rows,
           int cols, int threads, void* stream) {
  if (N < 16 || (N & (N - 1)) || rows < 16 || cols < 16 || N % rows
      || N % cols || (rows & 15) || (cols & 15) || threads < 32
      || threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  const int smem = 16 * (rows + cols);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      matw_kernel<KPACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N / rows) * (N / cols), L * J * U);
  matw_kernel<KPACKED><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)v, (int8_t*)out, J, U, N, rows, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// (rows, cols, threads): kernels.materialize_w_plan.  N a power of two,
// N >= 16; rows and cols multiples of 16 dividing N.
extern "C" int tfhe_materialize_w(const void* v, void* w, int L, int J, int U,
                                  int N, int rows, int cols, int threads,
                                  void* stream) {
  return launch<false>(v, w, L, J, U, N, rows, cols, threads, stream);
}

extern "C" int tfhe_materialize_wt(const void* v, void* wt, int L, int J,
                                   int U, int N, int rows, int cols,
                                   int threads, void* stream) {
  return launch<true>(v, wt, L, J, U, N, rows, cols, threads, stream);
}
