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
// What bounds it on this card. Not device memory (a matcher call moves a
// few MB) and not FLOPs (6 operations an offset and pixel): shared-memory
// traffic and instruction issue. The first form of this kernel formed, for
// each offset of a 32×32 output tile, 43×32 row sums of 12 products and
// 1,024 column sums of 12 terms, all through shared memory, with 2 block
// barriers an offset: about 44 shared-memory accesses an output and offset,
// ≈ 1,400 clocks an offset a block at 32 words a clock, so ≈ 1.4 ms for the
// coarse r = 13 search of 40 planes of 60×106 (729 offsets) and ≈ 0.5 ms for
// a full-frame r = 2 refine; measured 1.909 and 0.748 ms on an H100.
//
// What the design does about it:
//   * search_kernel: a warp owns a 21×32 output tile of one search plane
//     (its 12×12 windows span 32×43 pixels). Each lane keeps one row of the
//     tile's z1 (43 values) in registers for the whole sweep. For each
//     offset the warp works in two stages on data only it touches:
//       1. lane i takes row i: it forms each product z1·z2 once (one
//          shared-memory load of z2) and slides a 12-wide sum along the row
//          (add the entering product, subtract the leaving one, both in
//          registers), storing the 32 row sums to the warp's own buffer;
//       2. after __syncwarp, lane x takes column x: it slides a 12-tall sum
//          down the 32 row sums (one load each) and keeps the running best
//          score and offset index of its 21 pixels in registers.
//     That is 43 + 32 + 32 shared-memory accesses a lane an offset for 21
//     outputs: ≈ 5 an output and offset instead of ≈ 44, with no block
//     barrier in the offset loop. Rows and buffer pitches are odd, so no
//     access has a bank conflict.
//   * the z2 window that a block's dy range needs (its halo rows plus the dy
//     range, its halo columns plus 2r) and z1's halo tile are copied from
//     device memory once, before the sweep, with cp.async (zero-filled
//     outside the plane, all copies in flight at once), behind one barrier;
//     warps of other blocks on the SM overlap the copies with their sweeps.
//   * the card is filled by splitting the dy range across blocks when the
//     output tiles alone give fewer than two waves of warps (the coarse
//     level's 60×106 planes give 480 warps; they are split 14 ways). Each
//     split writes its first maximum (score and offset index) to scratch,
//     and reduce_kernel takes, per pixel, the largest score of the splits
//     in dy order under a strict '>': the same first maximum, independent
//     of block order, without atomics.
//   * zscore_kernel: one block per 32×32 tile, the tile and its 11-pixel
//     halo in shared memory; 12-wide sliding sums of p and p² along the
//     rows, then down the columns, in float64, so raw 0..255 planes keep
//     the precision of E[p²] − μ² at full frame size (the first form took
//     direct 144-term sums relative to the centre pixel for that); the
//     normalisation is float32.
//
// Any radius whose window fits a block's shared memory is taken (r ≤ 262
// at 4 warps a block; the matcher asks for at most 60); a larger one
// returns cudaErrorInvalidValue.
//
// No atomics and a fixed summation order: a run is bitwise repeatable. The
// sums are taken in another order than the plain version's cumulative-sum
// differences, so the two agree to a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPatch = 12;
constexpr int kLo = kPatch / 2;                 // window [i − 6, i + 5]
constexpr int kLanes = 32;
constexpr int kWarpRows = kLanes - kPatch + 1;  // 21 output rows a warp
constexpr int kCols = kLanes;                   // 32 output columns a warp
constexpr int kHaloCols = kCols + kPatch - 1;   // 43
constexpr int kMaxWarps = 4;                    // warps a block, stacked
constexpr int kBufPitch = kCols + 1;            // a warp's row-sum buffer
constexpr int kBufFloats = kLanes * kBufPitch;
// Warps the card holds at once (132 SMs × 16). A search of fewer than two
// such waves is split by dy toward four, so that the last wave's
// quantisation costs little.
constexpr int kWaveWarps = 132 * 16;
constexpr double kEps = 1e-4;  // the variance floor
constexpr float kInvN = 1.0f / (kPatch * kPatch);

// z-score tile
constexpr int kZTile = 32;
constexpr int kZHalo = kZTile + kPatch - 1;  // 43
constexpr int kZThreads = 128;

// Asynchronous 4-byte copy from device into shared memory (cp.async),
// zero-filled where !valid: then nothing is read from `src`, which must
// still be a valid address.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Enqueue the copy of rows × cols of the H×W plane at `src` from (ylo, xlo)
// into dst (row pitch `pitch`), zero outside the plane: a warp a row, a
// lane a column. Complete after cp_async_wait_all and a barrier.
__device__ void load_tile(float* dst, int pitch, const float* src, int H,
                          int W, int ylo, int xlo, int rows, int cols) {
  const int lane = threadIdx.x & (kLanes - 1), warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int rr = warp; rr < rows; rr += nwarps) {
    const int y = ylo + rr;
    const bool yok = y >= 0 && y < H;
    const float* srow = src + (size_t)(yok ? y : 0) * W;
    for (int cc = lane; cc < cols; cc += kLanes) {
      const int x = xlo + cc;
      const bool ok = yok && x >= 0 && x < W;
      cp_async_f32(dst + rr * pitch + cc, ok ? srow + x : src, ok);
    }
  }
}

__global__ void __launch_bounds__(kZThreads)
zscore_kernel(const float* __restrict__ p1, float* __restrict__ z1, int N1,
              const float* __restrict__ p2, float* __restrict__ z2, int H,
              int W) {
  __shared__ float tile[kZHalo * kZHalo];
  __shared__ double r1[kZHalo][kZTile + 1], r2[kZHalo][kZTile + 1];
  // planes 0 .. N1 − 1 of the grid are p1's, the rest p2's
  const bool first = (int)blockIdx.z < N1;
  const size_t off = (size_t)(first ? blockIdx.z : blockIdx.z - N1) * H * W;
  const float* plane = (first ? p1 : p2) + off;
  float* z = (first ? z1 : z2) + off;
  const int y0 = blockIdx.y * kZTile, x0 = blockIdx.x * kZTile;
  const int tid = threadIdx.x;
  load_tile(tile, kZHalo, plane, H, W, y0 - kLo, x0 - kLo, kZHalo, kZHalo);
  cp_async_wait_all();
  __syncthreads();
  // stage A: a thread slides along half a halo row (16 outputs)
  if (tid < 2 * kZHalo) {
    const int row = tid % kZHalo, x1 = (tid / kZHalo) * (kZTile / 2);
    const float* t = tile + row * kZHalo + x1;
    double s1 = 0.0, s2 = 0.0;
#pragma unroll
    for (int j = 0; j < kPatch; ++j) {
      const double v = t[j];
      s1 += v;
      s2 += v * v;
    }
    r1[row][x1] = s1;
    r2[row][x1] = s2;
#pragma unroll
    for (int x = 1; x < kZTile / 2; ++x) {
      const double a = t[x + kPatch - 1], b = t[x - 1];
      s1 = (s1 + a) - b;
      s2 = (s2 + a * a) - b * b;
      r1[row][x1 + x] = s1;
      r2[row][x1 + x] = s2;
    }
  }
  __syncthreads();
  // stage B: a thread slides down a quarter of an output column (8 rows)
  const int col = tid % kZTile, y1 = (tid / kZTile) * (kZTile / 4);
  const int x = x0 + col;
  double s1 = 0.0, s2 = 0.0;
#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
    s1 += r1[y1 + i][col];
    s2 += r2[y1 + i][col];
  }
#pragma unroll
  for (int y = y1; y < y1 + kZTile / 4; ++y) {
    if (y > y1) {
      s1 = (s1 + r1[y + kPatch - 1][col]) - r1[y - 1][col];
      s2 = (s2 + r2[y + kPatch - 1][col]) - r2[y - 1][col];
    }
    const int yy = y0 + y;
    if (yy < H && x < W) {
      const double m = s1 * (1.0 / (kPatch * kPatch));
      const double var = s2 * (1.0 / (kPatch * kPatch)) - m * m;
      const double d = (double)tile[(y + kLo) * kZHalo + col + kLo] - m;
      z[(size_t)yy * W + x] =
          (float)d * rsqrtf((float)fmax(var, kEps));
    }
  }
}

struct SearchArgs {
  const float* z1;
  const float* z2;
  float* du;        // outputs, written here when splits == 1
  float* dv;
  float* sc;
  float* part_sc;   // (splits, N2, H, W) scratch when splits > 1
  int* part_idx;
  int N2, H, W, radius, group, gy, cdy, splits;
};

__global__ void __launch_bounds__(kMaxWarps * kLanes)
search_kernel(SearchArgs a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & (kLanes - 1), warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int r = a.radius, side = 2 * r + 1;
  const int b = blockIdx.z;
  const int split = blockIdx.y / a.gy;
  const int y0 = (blockIdx.y % a.gy) * nwarps * kWarpRows;
  const int x0 = blockIdx.x * kCols;
  const int dy_lo = -r + split * a.cdy;
  const int dy_hi = min(r, dy_lo + a.cdy - 1);
  const int brows = nwarps * kWarpRows + kPatch - 1;  // the block's halo rows
  const int pitch = kHaloCols + 2 * r;                // odd
  const int H = a.H, W = a.W;
  const size_t plane1 = (size_t)(b / a.group) * H * W;
  const size_t plane2 = (size_t)b * H * W;
  float* win = smem;  // z2's window: (brows + cdy − 1) × pitch
  // z1's halo tile (pitch 43, odd), then the warps' row-sum buffers
  float* stage = smem + (size_t)(brows + a.cdy - 1) * pitch;

  // the window covers rows y0 − 6 + dy_lo .. and columns x0 − 6 − r ..
  load_tile(stage, kHaloCols, a.z1 + plane1, H, W, y0 - kLo, x0 - kLo, brows,
            kHaloCols);
  load_tile(win, pitch, a.z2 + plane2, H, W, y0 - kLo + dy_lo, x0 - kLo - r,
            brows + dy_hi - dy_lo, pitch);
  cp_async_wait_all();
  __syncthreads();
  // lane i of warp w keeps the block's halo row 21w + i of z1 in registers
  float zr[kHaloCols];
  {
    const float* src = stage + (warp * kWarpRows + lane) * kHaloCols;
#pragma unroll
    for (int j = 0; j < kHaloCols; ++j) zr[j] = src[j];
  }
  __syncthreads();  // the buffers overwrite z1's tile
  float* buf = stage + warp * kBufFloats;

  float best[kWarpRows];
  int bidx[kWarpRows];
#pragma unroll
  for (int y = 0; y < kWarpRows; ++y) {
    best[y] = -INFINITY;
    bidx[y] = r * side + r;  // (0, 0) where no score beats −inf
  }
  const float* wrow = win + (warp * kWarpRows + lane) * pitch;
  float* brow = buf + lane * kBufPitch;  // stage 1 writes row `lane`
  const float* bcol = buf + lane;        // stage 2 reads column `lane`
  for (int dy = dy_lo; dy <= dy_hi; ++dy) {
    const float* rowp = wrow + (dy - dy_lo) * pitch;
    int k = (dy + r) * side;
    for (int dx = -r; dx <= r; ++dx, ++k) {
      // stage 1: 12-wide sliding sums of z1·z2 along this lane's row
      const float* q = rowp + dx + r;
      float pr[kHaloCols];
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < kPatch; ++j) {
        pr[j] = zr[j] * q[j];
        s += pr[j];
      }
      brow[0] = s;
#pragma unroll
      for (int x = 1; x < kCols; ++x) {
        pr[x + kPatch - 1] = zr[x + kPatch - 1] * q[x + kPatch - 1];
        s = (s + pr[x + kPatch - 1]) - pr[x - 1];
        brow[x] = s;
      }
      __syncwarp();
      // stage 2: 12-tall sliding sums down this lane's column
      float h[kLanes];
      float v = 0.0f;
#pragma unroll
      for (int i = 0; i < kPatch; ++i) {
        h[i] = bcol[i * kBufPitch];
        v += h[i];
      }
#pragma unroll
      for (int y = 0; y < kWarpRows; ++y) {
        if (y > 0) {
          h[y + kPatch - 1] = bcol[(y + kPatch - 1) * kBufPitch];
          v = (v + h[y + kPatch - 1]) - h[y - 1];
        }
        if (v > best[y]) {
          best[y] = v;
          bidx[y] = k;
        }
      }
      __syncwarp();  // the buffer is rewritten by the next offset
    }
  }

  const int x = x0 + lane;
#pragma unroll
  for (int y = 0; y < kWarpRows; ++y) {
    const int yy = y0 + warp * kWarpRows + y;
    if (yy < H && x < W) {
      const size_t o = plane2 + (size_t)yy * W + x;
      if (a.splits == 1) {
        a.du[o] = (float)(bidx[y] % side - r);
        a.dv[o] = (float)(bidx[y] / side - r);
        a.sc[o] = best[y] * kInvN;
      } else {
        const size_t po = (size_t)split * a.N2 * H * W + o;
        a.part_sc[po] = best[y];
        a.part_idx[po] = bidx[y];
      }
    }
  }
}

// Per pixel, the first maximum over the splits (in dy order, strict '>').
__global__ void reduce_kernel(const float* __restrict__ part_sc,
                              const int* __restrict__ part_idx,
                              float* __restrict__ du, float* __restrict__ dv,
                              float* __restrict__ sc, size_t n, int splits,
                              int radius) {
  const int side = 2 * radius + 1;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float best = part_sc[i];
    int k = part_idx[i];
    for (int s = 1; s < splits; ++s) {
      const float v = part_sc[(size_t)s * n + i];
      if (v > best) {
        best = v;
        k = part_idx[(size_t)s * n + i];
      }
    }
    du[i] = (float)(k % side - radius);
    dv[i] = (float)(k / side - radius);
    sc[i] = best * kInvN;
  }
}

int warps_for(int H) {
  const int need = (H + kWarpRows - 1) / kWarpRows;
  return need < kMaxWarps ? need : kMaxWarps;
}

// Shared-memory bytes of a search block: the z2 window, then z1's halo
// tile, whose space the row-sum buffers (one a warp) take over.
size_t search_smem_bytes(int nwarps, int radius, int cdy) {
  const size_t brows = (size_t)nwarps * kWarpRows + kPatch - 1;
  const size_t tile = brows * kHaloCols, bufs = (size_t)nwarps * kBufFloats;
  const size_t window = (brows + cdy - 1) * (kHaloCols + 2 * (size_t)radius);
  return sizeof(float) * (window + (tile > bufs ? tile : bufs));
}

int optin_smem(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

// The number of dy splits (≥ 1) for a search, given a block's shared
// memory; 0 where not even one dy row's window fits.
int splits_for(int N2, int H, int W, int radius, int smem_limit) {
  const int side = 2 * radius + 1;
  const int nwarps = warps_for(H);
  const long warps = (long)((W + kCols - 1) / kCols) *
                     ((H + nwarps * kWarpRows - 1) / (nwarps * kWarpRows)) *
                     N2 * nwarps;
  long want =
      warps >= 2 * kWaveWarps ? 1 : (4 * kWaveWarps + warps - 1) / warps;
  if (want > side) want = side;
  if (want < 1) want = 1;
  int cdy = (int)((side + want - 1) / want);
  while (cdy >= 1 &&
         search_smem_bytes(nwarps, radius, cdy) > (size_t)smem_limit)
    --cdy;
  if (cdy < 1) return 0;
  return (side + cdy - 1) / cdy;
}

}  // namespace

extern "C" {

const char* zncc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The dy splits of a search of N2 planes of H×W at `radius`: the wrapper
// gives zncc_search_f32 2·splits·N2·H·W floats of scratch when it is > 1.
// Returns −(cudaError_t) on failure, and −cudaErrorInvalidValue for a
// radius whose window does not fit a block's shared memory.
int zncc_search_splits(int N2, int H, int W, int radius) {
  if (N2 <= 0 || H <= 0 || W <= 0 || radius < 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  const int err = optin_smem(&optin);
  if (err != 0) return -err;
  const int s = splits_for(N2, H, W, radius, optin);
  return s > 0 ? s : -static_cast<int>(cudaErrorInvalidValue);
}

// Fused z-score + ZNCC search. p1 (N1,H,W), p2 (N2,H,W) raw planes with
// N2 = N1·group; z1 (N1,H,W), z2 (N2,H,W) scratch; du, dv, sc (N2,H,W)
// outputs; part 2·splits·N2·H·W floats of scratch when `splits` (which must
// be zncc_search_splits's) is > 1, else may be null. All float32,
// contiguous, on the stream's device. Enqueues two kernels (three when
// split) on `stream` without synchronising; returns the cudaError_t of the
// launches (0 = success; cudaErrorInvalidValue for a radius whose window
// exceeds the block's shared memory or a wrong `splits`).
int zncc_search_f32(const float* p1, const float* p2, float* z1, float* z2,
                    float* du, float* dv, float* sc, float* part, int N1,
                    int N2, int H, int W, int radius, int splits,
                    void* stream) {
  if (N1 <= 0 || N2 <= 0 || H <= 0 || W <= 0) return 0;
  if (radius < 0 || N2 % N1 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  cudaError_t err = static_cast<cudaError_t>(optin_smem(&optin));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits < 1 || splits != splits_for(N2, H, W, radius, optin) ||
      (splits > 1 && !part))
    return static_cast<int>(cudaErrorInvalidValue);
  const int side = 2 * radius + 1;
  const int cdy = (side + splits - 1) / splits;
  const int nwarps = warps_for(H);
  const size_t smem = search_smem_bytes(nwarps, radius, cdy);
  if (smem > 48 * 1024) {  // above the default a block may use
    err = cudaFuncSetAttribute(search_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const int zx = (W + kZTile - 1) / kZTile, zy = (H + kZTile - 1) / kZTile;
  zscore_kernel<<<dim3(zx, zy, N1 + N2), kZThreads, 0, st>>>(p1, z1, N1, p2,
                                                             z2, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t n = (size_t)N2 * H * W;
  SearchArgs a{z1, z2, du, dv, sc, part,
               reinterpret_cast<int*>(part ? part + (size_t)splits * n
                                           : nullptr),
               N2, H, W, radius, N2 / N1,
               (H + nwarps * kWarpRows - 1) / (nwarps * kWarpRows), cdy,
               splits};
  const dim3 grid((W + kCols - 1) / kCols, a.gy * splits, N2);
  search_kernel<<<grid, nwarps * kLanes, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  reduce_kernel<<<blocks, threads, 0, st>>>(part, a.part_idx, du, dv, sc, n,
                                            splits, radius);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
