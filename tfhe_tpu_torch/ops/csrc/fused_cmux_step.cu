// fused_cmux_step_v2: one whole blind-rotation step,
//   out = acc + sum_l (decompose((X^a - 1) * acc) @ w[l]) << (8 l + key_shift)
// mod 2^32.  a (B,) int32, acc / out (B, (k+1)*N) int32 (the (B, k+1, N)
// layout is the same bytes), w (L <= 3, (k+1)*l*N, (k+1)*N) int8.
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:fused_cmux_step_v2.  Bound by the
// int8 tensor-core rate: B * (k+1)^2 * l * N^2 * L multiply-adds per step
// against (L*K*UN + 8*B*UN) bytes.  One block per (batch tile, 128-column
// output tile).  For each accumulator polynomial u the block
// builds the tile's l digit planes of (X^a - 1) * acc[:, u] in shared memory
// (read straight from acc, rotated per row, offset-added in uint32), then
// runs the mma.sync GEMM of common.cuh over them against the L limb
// matrices.  The digits never reach device memory.  They are rebuilt once
// per output column tile (UN/128 times), which makes the digit build a
// large share of the step.  What keeps the step affordable:
//   * each warp builds whole rows with eight independent loads in flight
//     per lane (a loop with one dependent load per coefficient left the
//     block stalled on memory latency);
//   * the digit planes are stored unpadded with an XOR swizzle of the
//     32-bit word index by (row & 7), which keeps the A-fragment loads free
//     of bank conflicts in l*BM*N bytes;
//   * a large batch takes the largest block tile that fits shared memory:
//     128 rows, 512 threads, W staged 64 K-rows per barrier pair
//     (l*128*N + 26 KB, 218 KB at N=512), which halves the W stream and the
//     barriers per multiply-add against 64 rows / 256 threads / 32 K-rows.
//     Small batches, and larger rings (N=1024), take the latter, at two
//     blocks per SM (see launch_tile).
#include "common.cuh"

namespace {

using namespace tfhe;

// Byte offset of digit (row, n) within one digit plane of BM rows x N.
__device__ __forceinline__ int swz(int row, int n, int N) {
  const int word = (n >> 2) ^ (((row & 7) << 2) & ((N >> 2) - 1));
  return row * N + (word << 2) + (n & 3);
}

template <int L, int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS == 256 ? 2 : 1)
fused_cmux_kernel(const int32_t* __restrict__ expo,
                  const int32_t* __restrict__ acc,
                  const int8_t* __restrict__ w, int32_t* __restrict__ out,
                  int B, int kp1, int N, int logN, int l, int bgbit,
                  uint32_t offset, int key_shift) {
  constexpr int BM = THREADS / 4, BK = THREADS / 8;
  constexpr int ROWS = BM / (THREADS / 32);     // rows built per warp
  constexpr int UNROLL = 8;                     // loads in flight per lane
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sD = smem;                           // [l][BM x N], swizzled
  uint32_t* sB = reinterpret_cast<uint32_t*>(smem + (size_t)l * BM * N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int UN = kp1 * N, K = kp1 * l * N;
  const uint32_t mask = (1u << bgbit) - 1;
  const int half = 1 << (bgbit - 1);
  const int gsw = ((g << 2) & ((N >> 2) - 1));  // this lane's A-row swizzle

  int32_t C[L][2][4][4];
  zero<L>(C);
  for (int u = 0; u < kp1; ++u) {
    // digits of (X^a - 1) * acc[b, u] for the tile's rows (rows past B are
    // left as they are: their outputs are never stored)
    for (int rr = 0; rr < ROWS; ++rr) {
      const int row = warp * ROWS + rr;
      const int b = m0 + row;
      if (b >= B) continue;
      const uint32_t* x =
          reinterpret_cast<const uint32_t*>(acc) + (size_t)b * UN + u * N;
      const int av = expo[b] & (2 * N - 1);
      const int r = av & (N - 1);
      const bool flip = (av >> logN) & 1;       // X^N = -1
      for (int n0 = lane; n0 < N; n0 += 32 * UNROLL) {
        uint32_t xv[UNROLL], yv[UNROLL];
#pragma unroll
        for (int q = 0; q < UNROLL; ++q) {
          const int n = n0 + 32 * q;
          if (n < N) {
            xv[q] = x[n];
            yv[q] = x[(n - r) & (N - 1)];
          }
        }
#pragma unroll
        for (int q = 0; q < UNROLL; ++q) {
          const int n = n0 + 32 * q;
          if (n < N) {
            const bool neg = (n < r) != flip;  // wrapped once: negate
            const uint32_t d = (neg ? 0u - yv[q] : yv[q]) - xv[q] + offset;
            const int off = swz(row, n, N);
            for (int lv = 0; lv < l; ++lv)
              sD[lv * BM * N + off] = (uint8_t)(int8_t)(
                  (int)((d >> (32 - (lv + 1) * bgbit)) & mask) - half);
          }
        }
      }
    }
    __syncthreads();
    for (int lv = 0; lv < l; ++lv) {
      const uint8_t* plane = sD + lv * BM * N;
      for (int n0 = 0; n0 < N; n0 += BK) {
        load_w_tiles<L, BK>(sB, w, K, UN, (u * l + lv) * N + n0, c0, tid);
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks) {  // 32-deep mma steps
          const int wb = (n0 >> 2) + 8 * ks;
          const int w0 = (wb + t) ^ gsw, w1 = (wb + 4 + t) ^ gsw;
          uint32_t a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const uint8_t* r0 = plane + (warp_m * 32 + mi * 16 + g) * N;
            const uint8_t* r8 = r0 + 8 * N;
            a[mi][0] = *reinterpret_cast<const uint32_t*>(r0 + 4 * w0);
            a[mi][1] = *reinterpret_cast<const uint32_t*>(r8 + 4 * w0);
            a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 4 * w1);
            a[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 4 * w1);
          }
          mma_chunk<L, BK>(C, a, sB, 8 * ks, warp_n, lane);
        }
        __syncthreads();
      }
    }
  }
  epilogue<L>(C, acc, out, B, UN, m0, c0, key_shift, warp_m, warp_n, lane);
}

constexpr size_t smem_bytes(int THREADS, int L, int l, int N) {
  return (size_t)l * (THREADS / 4) * N
         + (size_t)L * BN * (THREADS / 32 + 1) * sizeof(uint32_t);
}

template <int L, int THREADS>
int launch(const void* a, const void* acc, const void* w, void* out, int B,
           int kp1, int N, int l, int bgbit, uint32_t offset, int key_shift,
           cudaStream_t stream) {
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  const size_t smem = smem_bytes(THREADS, L, l, N);
  cudaError_t e = cudaFuncSetAttribute(
      fused_cmux_kernel<L, THREADS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(kp1 * N / BN, (B + THREADS / 4 - 1) / (THREADS / 4));
  fused_cmux_kernel<L, THREADS><<<grid, THREADS, smem, stream>>>(
      (const int32_t*)a, (const int32_t*)acc, (const int8_t*)w, (int32_t*)out,
      B, kp1, N, logN, l, bgbit, offset, key_shift);
  return (int)cudaGetLastError();
}

// tile_rows 64 or 128 forces a tile; 0 chooses.  The 128-row tile does more
// multiply-adds per byte staged and per barrier, but runs one block per SM
// on half as many blocks, so it loses while the batch is small enough for
// the 64-row grid to leave SMs idle.  It is chosen where the 64-row grid
// has more blocks than the card has SMs, the 128-row tile fits the 227 KB
// of shared memory a block may use and N is a multiple of its 64-deep K
// stage.
template <int L>
int launch_tile(const void* a, const void* acc, const void* w, void* out,
                int B, int kp1, int N, int l, int bgbit, uint32_t offset,
                int key_shift, int tile_rows, cudaStream_t stream) {
  const bool fits128 = N % 64 == 0 && smem_bytes(512, L, l, N) <= 232448;
  if (tile_rows == 0) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const long blocks64 = (long)(kp1 * N / BN) * ((B + 63) / 64);
    tile_rows = fits128 && blocks64 > sms ? 128 : 64;
  }
  if (tile_rows == 128 && fits128)
    return launch<L, 512>(a, acc, w, out, B, kp1, N, l, bgbit, offset,
                          key_shift, stream);
  if (tile_rows == 64)
    return launch<L, 256>(a, acc, w, out, B, kp1, N, l, bgbit, offset,
                          key_shift, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tfhe_fused_cmux_step(const void* a, const void* acc,
                                    const void* w, void* out, int B, int kp1,
                                    int N, int l, int L, int bgbit,
                                    unsigned int offset, int key_shift,
                                    int tile_rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 1: return launch_tile<1>(a, acc, w, out, B, kp1, N, l, bgbit, offset, key_shift, tile_rows, s);
    case 2: return launch_tile<2>(a, acc, w, out, B, kp1, N, l, bgbit, offset, key_shift, tile_rows, s);
    case 3: return launch_tile<3>(a, acc, w, out, B, kp1, N, l, bgbit, offset, key_shift, tile_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
