// mm_recombine_acc: out = acc_in + sum_l (x @ w[l]) << (8 l + shift_base),
// mod 2^32.  x (B, K) int8, w (L, K, UN) int8, acc_in / out (B, UN) int32.
//
// Replaces tfhe_tpu/ops/pallas_kernels.py:mm_recombine_acc.  Bound by the
// int8 tensor-core rate at large B, by the W stream (L*K*UN bytes) at small
// B.  A tiled mma.sync GEMM (common.cuh): every 64x128 output tile keeps
// all L limb accumulators in registers while K streams through shared
// memory, so the limb recombination happens once, in the epilogue, and no
// (B, L, UN) int32 partial reaches memory.
//
// The Pallas kernel carries the K sum in scratch along a sequential grid
// axis; here the K walk is cut into S slices on a third grid axis
// (split_plan: slices of ceil(K/32 / S) steps, the last one ragged), so a
// narrow batch still puts enough blocks on every SM (GATE_DEFAULT B=256:
// 64 tiles).  With S = 1 a block adds acc in its epilogue and stores; with
// S > 1 the entry point copies acc into out first and every block adds its
// recombined slice with red.global.add.u32 (exact: addition mod 2^32
// commutes).  Each 32-deep step is pipelined (pipeline.cuh), one barrier a
// step: cp.async copies the raw x and W rows three steps ahead into a
// 4-stage ring and the next step's W stage is transposed into the other
// half of a double-buffered sB during this step's MMAs (this beat a
// register prefetch of the next step, PERF.md).  No wgmma or TMA yet
// (ROADMAP §2).
#include "pipeline.cuh"

namespace {

using namespace tfhe;

constexpr int BM = 64, BK = 32, THREADS = 8 * BK;
constexpr int SA_STRIDE = BK + 16;   // bytes; 12 words keeps A loads conflict-free

// (slice length, slices) of a K walk of `steps` steps cut `split` ways:
// slices of ceil(steps / split) steps, the last one ragged; a split that
// would leave a slice empty takes fewer slices (kernels.split_plan).
void split_plan(int steps, int split, int* len, int* slices) {
  if (split > steps) split = steps;
  if (split < 1) split = 1;
  *len = (steps + split - 1) / split;
  *slices = (steps + *len - 1) / *len;
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The ring: NS stages, each the raw W rows of one step, [limb][32 rows][128
// bytes] (a warp's transposing read takes one whole row), then its x rows
// [64][SA_STRIDE].  The stage of step s is filled NS-1 steps ahead.
constexpr int NS = 4;
template <int L>
constexpr int W_STAGE = L * BK * BN;                           // bytes
template <int L>
constexpr int RING_STAGE = W_STAGE<L> + BM * SA_STRIDE;

template <int L>
constexpr size_t smem_bytes() {
  return (size_t)NS * RING_STAGE<L> + 2 * (size_t)SB_TILE<L> * 4;
}

// A stage's raw W rows -> the swizzled sB (store_block), one 4x4 byte
// block per thread and limb.
template <int L>
__device__ __forceinline__ void transpose_w(uint32_t* sB, const uint8_t* stage,
                                            int tid) {
  const TileSlot sl(tid);
  uint32_t r[L][4];
#pragma unroll
  for (int lm = 0; lm < L; ++lm) {
    const uint8_t* p = stage + (lm * BK + 4 * sl.kb) * BN + 4 * sl.nb;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[lm][e] = *reinterpret_cast<const uint32_t*>(p + e * BN);
  }
  store_block<L>(sB, r, sl);
}

template <int L>
__global__ void __launch_bounds__(THREADS)
mm_recombine_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const int32_t* __restrict__ acc, int32_t* __restrict__ out,
                    int B, int K, int UN, int shift, int slice_steps) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* sB = reinterpret_cast<uint32_t*>(smem + NS * RING_STAGE<L>);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int m0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * slice_steps * BK;
  const int steps = min(slice_steps, (K - k_begin) / BK);
  const int arow = tid >> 1, apart = tid & 1;

  // step s of the slice into stage s % NS (an empty group past the end):
  // 16 bytes of W per thread and limb, 16 of x for threads below 2*BM
  // (zero-filled for rows past B)
  auto issue = [&](int s) {
    if (s < steps) {
      uint8_t* st = smem + (s % NS) * RING_STAGE<L>;
      const int krow = k_begin + s * BK;
      const int ch = tid & 7, r = tid >> 3;
#pragma unroll
      for (int lm = 0; lm < L; ++lm)
        cp_async16(st + (lm * BK + r) * BN + 16 * ch,
                   w + lm * (size_t)K * UN + (size_t)(krow + r) * UN + c0
                       + 16 * ch, 16);
      if (tid < 2 * BM) {
        const bool ok = m0 + arow < B;
        const int8_t* src =
            ok ? x + (size_t)(m0 + arow) * K + krow + 16 * apart : x;
        cp_async16(st + W_STAGE<L> + arow * SA_STRIDE + 16 * apart, src,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < NS - 1; ++s) issue(s);
  cp_async_wait<NS - 2>();                      // step 0 has landed
  __syncthreads();
  transpose_w<L>(sB, smem, tid);

  int32_t C[L][2][4][4];
  zero<L>(C);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<NS - 3>();                    // step s+1 has landed
    __syncthreads();
    // refills the stage of step s-1: its W was transposed at step s-2 and
    // its x read by step s-1's MMAs, both before this barrier
    issue(s + NS - 1);
    if (s + 1 < steps)
      transpose_w<L>(sB + ((s + 1) & 1) * SB_TILE<L>,
                     smem + ((s + 1) % NS) * RING_STAGE<L>, tid);
    uint32_t a[2][4];
    load_a(a, smem + (s % NS) * RING_STAGE<L> + W_STAGE<L>, SA_STRIDE, 0,
           warp_m, lane);
    mma_step<L>(C, a, sB + (s & 1) * SB_TILE<L>, warp_n, lane);
  }
  if (gridDim.z == 1)
    epilogue<L>(C, acc, out, B, UN, m0, c0, shift, warp_m, warp_n, lane);
  else
    epilogue_add<L>(C, out, B, UN, m0, c0, shift, warp_m, warp_n, lane);
}

template <int L>
int set_smem() {
  return (int)cudaFuncSetAttribute(mm_recombine_kernel<L>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes<L>());
}

template <int L>
int launch(const void* x, const void* w, const void* acc, void* out, int B,
           int K, int UN, int shift, int split, cudaStream_t stream) {
  int len, slices;
  split_plan(K / BK, split, &len, &slices);
  int e = set_smem<L>();
  if (e != 0) return e;
  if (slices > 1) {
    cudaError_t ce = cudaMemcpyAsync(out, acc, (size_t)B * UN * 4,
                                     cudaMemcpyDeviceToDevice, stream);
    if (ce != cudaSuccess) return (int)ce;
  }
  const dim3 grid(UN / BN, (B + BM - 1) / BM, slices);
  mm_recombine_kernel<L><<<grid, THREADS, smem_bytes<L>(), stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const int32_t*)acc, (int32_t*)out,
      B, K, UN, shift, len);
  return (int)cudaGetLastError();
}

template <int L>
int occupancy() {
  int e = set_smem<L>();
  if (e != 0) return -e;
  int n = 0;
  cudaError_t ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, mm_recombine_kernel<L>, THREADS, smem_bytes<L>());
  return ce == cudaSuccess ? n : -(int)ce;
}

}  // namespace

extern "C" int tfhe_mm_recombine_acc(const void* x, const void* w,
                                     const void* acc, void* out, int B, int K,
                                     int UN, int L, int shift, int split,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 1: return launch<1>(x, w, acc, out, B, K, UN, shift, split, s);
    case 2: return launch<2>(x, w, acc, out, B, K, UN, shift, split, s);
    case 3: return launch<3>(x, w, acc, out, B, K, UN, shift, split, s);
    case 4: return launch<4>(x, w, acc, out, B, K, UN, shift, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the kernel for L limbs resident on one SM (from its registers
// and shared memory), or -cudaError.
extern "C" int tfhe_mm_recombine_acc_occupancy(int L) {
  switch (L) {
    case 1: return occupancy<1>();
    case 2: return occupancy<2>();
    case 3: return occupancy<3>();
    case 4: return occupancy<4>();
    default: return -(int)cudaErrorInvalidValue;
  }
}
