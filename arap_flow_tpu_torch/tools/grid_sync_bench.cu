// What one card-wide sum of one float a CTA costs on a Hopper card, in the
// forms the PCG kernel's spread plan (csrc/pcg.cu, pcg_cluster_spread)
// could use between its phases. One CTA of 512 threads an SM (200 KB of
// dynamic shared memory each, as the spread plan takes), one cooperative
// launch:
//   0. each CTA's total into its slot, (epoch << 32) | bits, one relaxed
//      64-bit store; warp 0 of every CTA reads all slots at once, again
//      until each holds the epoch, and sums them in a fixed order (the
//      spread plan's Σ p·Ap phase);
//   1. as 0, with a release fence before the store and an acquire fence
//      after the reads (its Σ r·z phase, which carries the edges of z);
//   2. as 1, written as a release store and acquire loads, one slot after
//      another;
//   3. each CTA's total into a plain slot, cooperative_groups' grid.sync(),
//      then every CTA reads the slots;
//   4. the CTA's own total only (the cost of the CTA-wide sum alone).
// Prints microseconds a sum (CUDA events over 3 launches of 20,000 sums)
// at 132, 66 and 33 CTAs, and checks each form's last total. Standalone;
// build and run on the machine with the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o grid_sync_bench grid_sync_bench.cu && ./grid_sync_bench
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace cgg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMax = 256;
constexpr int kPoll = kMax / 32;
constexpr int kSmem = 200000;

__device__ unsigned long long g_sync[1 + 2 * kMax];
__device__ float g_slots[kMax];

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// This CTA's total of v in warp 0; every thread past a CTA barrier.
__device__ float cta_total(float v, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (warp == 0) {
    t = warp_sum(lane < kWarps ? part[lane] : 0.f);
    t = __shfl_sync(0xffffffffu, t, 0);
  }
  return t;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* q,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(q), "l"(v)
               : "memory");
}
__device__ __forceinline__ void st_release(unsigned long long* q,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(q), "l"(v)
               : "memory");
}
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* q) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(q) : "memory");
  return v;
}
__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* q) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(q) : "memory");
  return v;
}
__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

template <int kForm>
__device__ float grid_total(float v, float* part, float* total, unsigned e,
                            int rank, int n) {
  v = cta_total(v, part);
  if constexpr (kForm == 3) {
    if (threadIdx.x == 0) g_slots[rank] = v;
    cgg::this_grid().sync();
    if (threadIdx.x < 32) {
      float acc = 0.f;
      for (int k = threadIdx.x; k < n; k += 32) acc += __ldcg(g_slots + k);
      acc = warp_sum(acc);
      if (threadIdx.x == 0) *total = acc;
    }
  } else if constexpr (kForm == 4) {
    if (threadIdx.x == 0) *total = v;
  } else if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned long long* slots = g_sync + 1 + (e & 1) * kMax;
    const unsigned long long word =
        (static_cast<unsigned long long>(e) << 32) | __float_as_uint(v);
    if (lane == 0) {
      if constexpr (kForm == 1) fence_gpu();
      if constexpr (kForm == 2) st_release(slots + rank, word);
      else st_relaxed(slots + rank, word);
    }
    float acc = 0.f;
    if constexpr (kForm == 2) {
      for (int k = lane; k < n; k += 32) {
        unsigned long long got;
        do got = ld_acquire(slots + k);
        while (static_cast<unsigned>(got >> 32) != e);
        acc += __uint_as_float(static_cast<unsigned>(got));
      }
    } else {
      unsigned long long got[kPoll];
      unsigned have = 0, want = 0;
#pragma unroll
      for (int i = 0; i < kPoll; ++i)
        if (lane + 32 * i < n) want |= 1u << i;
      for (;;) {
#pragma unroll
        for (int i = 0; i < kPoll; ++i)
          if ((want & ~have) >> i & 1u)
            got[i] = ld_relaxed(slots + lane + 32 * i);
#pragma unroll
        for (int i = 0; i < kPoll; ++i)
          if (((want & ~have) >> i & 1u) &&
              static_cast<unsigned>(got[i] >> 32) == e)
            have |= 1u << i;
        if (__all_sync(0xffffffffu, have == want)) break;
      }
      if constexpr (kForm == 1) fence_gpu();
#pragma unroll
      for (int i = 0; i < kPoll; ++i)
        if (want >> i & 1u)
          acc += __uint_as_float(static_cast<unsigned>(got[i]));
    }
    acc = warp_sum(acc);
    if (lane == 0) *total = acc;
  }
  __syncthreads();
  return *total;
}

template <int kForm>
__global__ void __launch_bounds__(kThreads, 1) bench(int sums, float* out) {
  __shared__ float part[kWarps];
  __shared__ float total;
  unsigned e = static_cast<unsigned>(ld_relaxed(g_sync));
  float t = 0.f;
  for (int i = 0; i < sums; ++i)
    t = grid_total<kForm>(1.f, part, &total, ++e, blockIdx.x, gridDim.x);
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    g_sync[0] = e;
    out[0] = t;
  }
}

// Microseconds a sum of form kForm over `ctas` CTAs; −1 on an error.
template <int kForm>
float run(int ctas, int sums, float* out) {
  void (*k)(int, float*) = bench<kForm>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  void* args[] = {&sums, &out};
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaLaunchCooperativeKernel((void*)k, ctas, kThreads, args, kSmem, 0);
  cudaEventRecord(a);
  for (int r = 0; r < 3; ++r)
    cudaLaunchCooperativeKernel((void*)k, ctas, kThreads, args, kSmem, 0);
  cudaEventRecord(b);
  const cudaError_t err = cudaEventSynchronize(b);
  float ms = 0.f, t = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaMemcpy(&t, out, sizeof(float), cudaMemcpyDeviceToHost);
  if (err != cudaSuccess || cudaGetLastError() != cudaSuccess) {
    printf("form %d: %s\n", kForm, cudaGetErrorString(err));
    return -1.f;
  }
  const float want = kForm == 4 ? kThreads : static_cast<float>(ctas) * kThreads;
  if (t != want) printf("form %d: total %g, want %g\n", kForm, t, want);
  return 1e3f * ms / (3.f * sums);
}

int main() {
  float* out;
  cudaMalloc(&out, sizeof(float));
  for (int ctas : {132, 66, 33})
    printf("%d CTAs: form 0 %.3f us, 1 %.3f, 2 %.3f, 3 %.3f, 4 %.3f\n", ctas,
           run<0>(ctas, 20000, out), run<1>(ctas, 20000, out),
           run<2>(ctas, 20000, out), run<3>(ctas, 20000, out),
           run<4>(ctas, 20000, out));
  return 0;
}
