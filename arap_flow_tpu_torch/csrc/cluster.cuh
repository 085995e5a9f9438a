// Device helpers shared by the thread-block-cluster kernels (pcg.cu,
// fused_solver.cu): fixed-order sums within a CTA and across a cluster's
// mailbox slots, and st.async pushes into another CTA's shared memory that
// complete bytes on its mbarrier.
//
// Both kernels run 512-thread CTAs in clusters of up to 16 (one problem a
// cluster). A mailbox is a small array in every CTA's shared memory with one
// slot per rank: each CTA writes its partial into slot `rank` of every CTA
// with st_async, and each CTA waits on its own mbarrier and sums the slots
// in rank order, so every CTA gets the same total with no atomics.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kSmemPerBlock = 232448;  // what one block of an H100 can use
// An entry's return code when no cluster of the plan fits the card
constexpr int kNoClusterFits = -1;
// A wait on a mailbox that outlasts this many clock cycles (seconds at any
// clock) traps instead of hanging the card.
constexpr long long kWaitLimit = 20000000000LL;

// Fixed-order warp sum; lane 0 holds the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// This CTA's total of v, in warp 0 (every lane); ends with every thread
// past a CTA barrier.
__device__ float cta_total(float v, float* warp_part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (warp == 0) {
    t = warp_sum(lane < kWarps ? warp_part[lane] : 0.f);
    t = __shfl_sync(0xffffffffu, t, 0);
  }
  return t;
}

// Σ of the `nrank` slots of a mailbox, in rank order; every thread returns
// the same total in every CTA.
__device__ __forceinline__ float mailbox_total(const float* box, int nrank) {
  const int lane = threadIdx.x & 31;
  const float t = warp_sum(lane < nrank ? box[lane] : 0.f);
  return __shfl_sync(0xffffffffu, t, 0);
}

// ---- distributed shared memory: st.async into another CTA's mailbox,
// completing bytes on its mbarrier ------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory location in CTA `rank`.
__device__ __forceinline__ unsigned at_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

// The CTA's one arrival of a phase, announcing the bytes it will receive.
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of `parity` of the mbarrier has completed.
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitLimit) __trap();
  }
}

// ---- host side -------------------------------------------------------------

// The launch configuration of a plan: grid (cluster, B), kThreads threads,
// cluster dims (cluster, 1, 1), `smem` bytes of dynamic shared memory; sets
// the kernel's attributes for them.
template <typename Args>
cudaError_t configure(void (*kern)(Args), int B, int cluster, size_t smem,
                      cudaStream_t st, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, B, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Active clusters of the configured plan on the current device (≥ 0), or
// −(error).
template <typename Args>
int occupancy(void (*kern)(Args), const cudaLaunchConfig_t& cfg) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(kern), &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace
