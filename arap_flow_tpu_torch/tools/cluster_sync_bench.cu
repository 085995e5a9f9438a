// What one cluster-wide synchronisation of 16 CTAs costs on a Hopper card,
// in the forms the PCG kernel (csrc/pcg.cu) could use between its phases:
//   0. cooperative_groups' cluster.sync() (a release/acquire barrier);
//   1. barrier.cluster.arrive.relaxed + wait (no memory ordering);
//   2. barrier.cluster.arrive.release + wait.acquire, written out;
//   3. as 0, after each thread stores one float to device memory;
//   4. an all-to-all of one float a CTA through distributed shared memory:
//      st.async into every CTA's slot, completing on its mbarrier, then a
//      wait on the local mbarrier (what pcg.cu does for its reductions).
// Prints nanoseconds a synchronisation (CUDA events over 20,000 in one
// launch) at 1 and 4 clusters, and checks that form 4 delivered every
// value. Standalone; build and run on the machine with the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o cluster_sync_bench cluster_sync_bench.cu && ./cluster_sync_bench
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace cg = cooperative_groups;

constexpr int kCluster = 16;
constexpr int kThreads = 512;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    bench(int iters, float* out, float* scratch) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ float slot[2][kCluster];
  __shared__ alignas(8) unsigned long long bar;
  const int rank = static_cast<int>(cl.block_rank());
  float acc = 0.f;
  if (kMode == 4) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_addr(&bar)));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cl.sync();
  }
  for (int it = 0; it < iters; ++it) {
    if (kMode == 0) cl.sync();
    if (kMode == 1) {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    }
    if (kMode == 2) {
      asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    }
    if (kMode == 3) {
      scratch[(blockIdx.y * kCluster + rank) * kThreads + threadIdx.x] = acc;
      cl.sync();
    }
    if (kMode == 4) {
      // slots alternate by parity: a CTA sends round it + 1 only after it
      // has every value of round it, so no slot is overwritten unread
      float* box = slot[it & 1];
      if (threadIdx.x == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                smem_addr(&bar)),
            "r"(4 * kCluster)
            : "memory");
      if (threadIdx.x < kCluster) {
        unsigned dst, dbar;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(dst) : "r"(smem_addr(&box[rank])),
                       "r"(threadIdx.x));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(dbar) : "r"(smem_addr(&bar)), "r"(threadIdx.x));
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
            "[%0], %1, [%2];" ::"r"(dst),
            "r"(__float_as_uint(acc + 1.f)), "r"(dbar)
            : "memory");
      }
      unsigned done = 0;
      while (!done)
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(smem_addr(&bar)), "r"(it & 1) : "memory");
      float t = 0.f;
      for (int k = 0; k < kCluster; ++k) t += box[k];
      acc = t / kCluster;  // every CTA sent acc + 1: acc counts the rounds
      __syncthreads();  // every thread has read the slots and the phase
    }
  }
  if (kMode == 4) cl.sync();
  if (threadIdx.x == 0) out[blockIdx.y * kCluster + rank] = acc;
}

template <int kMode>
float ns_per_sync(int B, int iters, float* out, float* scratch) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaFuncSetAttribute(bench<kMode>,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchKernelEx(&cfg, bench<kMode>, iters, out, scratch);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  cudaLaunchKernelEx(&cfg, bench<kMode>, iters, out, scratch);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) printf("error: %s\n", cudaGetErrorString(err));
  return ms * 1e6f / iters;
}

int main() {
  float *out, *scratch;
  cudaMalloc(&out, 4 * kCluster * sizeof(float));
  cudaMalloc(&scratch, 4 * kCluster * kThreads * sizeof(float));
  const int iters = 20000;
  for (int B : {1, 4}) {
    const float t0 = ns_per_sync<0>(B, iters, out, scratch);
    const float t1 = ns_per_sync<1>(B, iters, out, scratch);
    const float t2 = ns_per_sync<2>(B, iters, out, scratch);
    const float t3 = ns_per_sync<3>(B, iters, out, scratch);
    const float t4 = ns_per_sync<4>(B, iters, out, scratch);
    float h[4 * kCluster];
    cudaMemcpy(h, out, B * kCluster * sizeof(float), cudaMemcpyDeviceToHost);
    bool ok = true;
    for (int k = 0; k < B * kCluster; ++k) ok = ok && h[k] == float(iters);
    printf("%d cluster(s) of %d CTAs, ns a synchronisation: cluster.sync %.1f;"
           " relaxed arrive + wait %.1f; release arrive + acquire wait %.1f;"
           " cluster.sync after a device-memory store %.1f; st.async "
           "all-to-all + mbarrier wait %.1f (every value delivered: %s)\n",
           B, kCluster, t0, t1, t2, t3, t4, ok ? "yes" : "NO");
    if (!ok) return 1;
  }
  return 0;
}
