// Fused z-score + exhaustive ZNCC offset search + per-pixel argmax.
//
// Replaces arap_flow_tpu/ops/pallas_match.py::zncc_search (kernel
// _zncc_kernel): the same function as ops/matching._search(_zscore(p1),
// _zscore(p2), r, 12) of the JAX package, on raw float32 planes:
//
//   z = (p − μ) · rsqrt(max(σ², 1e-4)), μ and σ² over the zero-padded 12×12
//       box [i−6, i+5] of each pixel (z = 0 outside the plane);
//   for every offset (dy, dx) ∈ [−r, r]², dy-major from −r:
//       corr = (1/144) Σ_box z1 · z2[y+dy, x+dx]   (zeros beyond the plane);
//   per pixel the first maximum under a strict '>' from −inf, returned as
//   (du, dv, score) = (dx, dy, corr) float32 planes.
//
// The planes come in batches: p1 holds N1 reference planes, p2 holds N2 =
// N1·G search planes, and p2's plane b is searched against p1's plane b / G
// (the matcher's coarse level searches G affine hypotheses of one lane
// against the same reference, so the reference is z-scored once).
//
// What bounds it on this card: operations at the coarse level (729 offsets
// over small planes), memory at the refine levels (25 offsets over
// full-size planes). The least work per offset and pixel is one product and
// a running 12×12 box sum; the data is a few MB. What the design does:
//   * zscore_kernel: one block per 32×32 tile, the tile and its 11-pixel
//     halo in shared memory, direct 144-term sums per pixel taken relative
//     to the pixel itself (σ² is shift-invariant), so flat and smooth
//     regions keep their precision where E[p²] − μ² of raw 0..255 values
//     would cancel;
//   * search_kernel: one block per 32×32 output tile of one search plane.
//     z1's tile with its halo stays in shared memory for the whole sweep;
//     for each dy the matching (43 × (43 + 2r)) band of z2 is loaded, and
//     for each dx the block forms the separable box sum of the product in
//     shared memory (12-term row sums, then 12-term column sums) and keeps
//     the running best, du and dv of its pixels in registers. The (offset,
//     H, W) correlation stack is never written to device memory.
//   * the whole batch of planes is one launch per pass (batch on grid.z).
// Running (sliding-window) sums, register tiling and a warp-level offset
// split are later work.
//
// No atomics and a fixed summation order: a run is bitwise repeatable. The
// sums are taken in another order than the plain version's cumulative-sum
// differences, so the two agree to a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPatch = 12;
constexpr int kLo = kPatch / 2;            // window [i − 6, i + 5]
constexpr int kTile = 32;                  // output tile side
constexpr int kHalo = kTile + kPatch - 1;  // 43: tile + window support
constexpr int kThreads = 256;
constexpr int kPerThread = kTile * kTile / kThreads;  // 4 outputs a thread
constexpr float kEps = 1e-4f;
constexpr float kInvN = 1.0f / (kPatch * kPatch);

__global__ void zscore_kernel(const float* __restrict__ p,
                              float* __restrict__ z, int H, int W) {
  __shared__ float tile[kHalo][kHalo];
  const size_t plane = (size_t)blockIdx.z * H * W;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kHalo * kHalo; i += kThreads) {
    const int r = i / kHalo, c = i % kHalo;
    const int y = y0 - kLo + r, x = x0 - kLo + c;
    tile[r][c] = (y >= 0 && y < H && x >= 0 && x < W)
                     ? p[plane + (size_t)y * W + x]
                     : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    const int y = y0 + r, x = x0 + c;
    if (y >= H || x >= W) continue;
    const float ctr = tile[r + kLo][c + kLo];
    float s1 = 0.0f, s2 = 0.0f;
    for (int a = 0; a < kPatch; ++a) {
#pragma unroll
      for (int b = 0; b < kPatch; ++b) {
        const float d = tile[r + a][c + b] - ctr;
        s1 += d;
        s2 = fmaf(d, d, s2);
      }
    }
    const float m = s1 * kInvN;  // μ − p
    const float var = s2 * kInvN - m * m;
    z[plane + (size_t)y * W + x] = -m * rsqrtf(fmaxf(var, kEps));
  }
}

__global__ void search_kernel(const float* __restrict__ z1,
                              const float* __restrict__ z2,
                              float* __restrict__ du, float* __restrict__ dv,
                              float* __restrict__ sc, int H, int W,
                              int radius, int group) {
  extern __shared__ float smem[];
  const int bw = kHalo + 2 * radius;  // z2 band width
  float* s1 = smem;                   // kHalo × kHalo
  float* band = s1 + kHalo * kHalo;   // kHalo × bw
  float* hs = band + kHalo * bw;      // kHalo × kTile row sums
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const size_t plane1 = (size_t)(b / group) * H * W;
  const size_t plane2 = (size_t)b * H * W;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;

  for (int i = tid; i < kHalo * kHalo; i += kThreads) {
    const int r = i / kHalo, c = i % kHalo;
    const int y = y0 - kLo + r, x = x0 - kLo + c;
    s1[i] = (y >= 0 && y < H && x >= 0 && x < W)
                ? z1[plane1 + (size_t)y * W + x]
                : 0.0f;
  }

  float best[kPerThread], bu[kPerThread], bv[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    best[k] = -INFINITY;
    bu[k] = 0.0f;
    bv[k] = 0.0f;
  }

  for (int dy = -radius; dy <= radius; ++dy) {
    // the previous band's readers finished at the last sweep's barrier
    for (int i = tid; i < kHalo * bw; i += kThreads) {
      const int r = i / bw, c = i % bw;
      const int y = y0 - kLo + dy + r, x = x0 - kLo - radius + c;
      band[i] = (y >= 0 && y < H && x >= 0 && x < W)
                    ? z2[plane2 + (size_t)y * W + x]
                    : 0.0f;
    }
    __syncthreads();
    for (int dx = -radius; dx <= radius; ++dx) {
      for (int i = tid; i < kHalo * kTile; i += kThreads) {
        const int r = i / kTile, c = i % kTile;
        const float* a = s1 + r * kHalo + c;
        const float* q = band + r * bw + c + dx + radius;
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kPatch; ++k) acc = fmaf(a[k], q[k], acc);
        hs[i] = acc;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int i = tid + k * kThreads;
        const int r = i / kTile, c = i % kTile;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kPatch; ++j) acc += hs[(r + j) * kTile + c];
        const float corr = acc * kInvN;
        if (corr > best[k]) {
          best[k] = corr;
          bu[k] = (float)dx;
          bv[k] = (float)dy;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = tid + k * kThreads;
    const int y = y0 + i / kTile, x = x0 + i % kTile;
    if (y < H && x < W) {
      const size_t o = plane2 + (size_t)y * W + x;
      du[o] = bu[k];
      dv[o] = bv[k];
      sc[o] = best[k];
    }
  }
}

size_t search_smem_bytes(int radius) {
  return sizeof(float) * (size_t)kHalo * (kHalo + (kHalo + 2 * radius) + kTile);
}

}  // namespace

extern "C" {

const char* zncc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Fused z-score + ZNCC search. p1 (N1,H,W), p2 (N2,H,W) raw planes with
// N2 = N1·group; z1 (N1,H,W), z2 (N2,H,W) scratch; du, dv, sc (N2,H,W)
// outputs. All float32, contiguous, on the stream's device. Enqueues three
// kernels on `stream` without synchronising; returns the cudaError_t of the
// launches (0 = success; cudaErrorInvalidValue for a radius whose z2 band
// exceeds the block's shared memory).
int zncc_search_f32(const float* p1, const float* p2, float* z1, float* z2,
                    float* du, float* dv, float* sc, int N1, int N2, int H,
                    int W, int radius, void* stream) {
  if (N1 <= 0 || N2 <= 0 || H <= 0 || W <= 0) return 0;
  if (radius < 0 || N2 % N1 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = search_smem_bytes(radius);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > (size_t)optin) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(search_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int gx = (W + kTile - 1) / kTile, gy = (H + kTile - 1) / kTile;
  zscore_kernel<<<dim3(gx, gy, N1), kThreads, 0, st>>>(p1, z1, H, W);
  zscore_kernel<<<dim3(gx, gy, N2), kThreads, 0, st>>>(p2, z2, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  search_kernel<<<dim3(gx, gy, N2), kThreads, smem, st>>>(
      z1, z2, du, dv, sc, H, W, radius, N2 / N1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
