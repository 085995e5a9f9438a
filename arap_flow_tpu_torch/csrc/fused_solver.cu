// The whole annealed ARAP schedule (num_anneal constraint steps × gn_iters
// Gauss-Newton linearisations × pcg_iters Jacobi-PCG iterations) in ONE
// persistent cooperative kernel.
//
// Replaces arap_flow_tpu/ops/pallas_solver.py::_solve_call (kernel
// _solve_kernel :32, entry anneal_solve_fused :199): the same function, in
// its grouping, batched over B problems with their own weights (wf2, wr2):
//     x = (grid, 0);  pre_o = 1/(1+√(2·wr2·deg + wf2·fit))²,
//                     pre_a = 1/(1+√(wr2·deg))²
//     for i < num_anneal:  α = (i+1)/num_anneal;  cimg = (1−α)·csrc + α·ctgt
//       for g < gn_iters:  s, c = sin, cos(x_a);  r = −JtF(x, cimg);
//                          p = pre·r;  δ = 0;  rz = Σ r·p
//         for k < pcg_iters:  Ap = JtJ·p (the UNFACTORED form of :112-146)
//                             α = rz/Σ p·Ap (0 if ≤ 0);  δ += αp;  r −= α·Ap
//                             z = pre·r;  rz' = Σ z·r;  β = rz'/rz (0 if
//                             rz ≤ 0);  p = z + βp
//         x += δ
//
// Design. One cooperative launch (cudaLaunchCooperativeKernel) per call; the
// grid is the most blocks that can be resident at once (occupancy × SMs),
// and never more than there are tasks. A task is (problem, chunk): chunk c
// of problem b owns the pixels c·256 + t + k·nchunk·256 of that problem, so
// a pixel always belongs to the same thread and needs no barrier between
// two phases that touch only that pixel. Blocks walk their tasks with a
// grid-stride loop. cooperative_groups::this_grid().sync() separates the
// phases that read a neighbour's or another block's values:
//   setup [x, pre, δ = 0] | per GN step: [x += δ; s, c] | [JtF; r, p, δ = 0;
//   Σ r·z partials] | per PCG iteration: [Ap; Σ p·Ap partials] | [α; δ, r;
//   Σ z·r partials] | [β; p] | and x += δ at the end.
// State (x, s/c, pre, δ, r, p, Ap: 19 planes a problem) lives in device
// memory that the wrapper allocates; at 192×384 that is 5.6 MB a problem,
// so a chunk of problems runs out of the 50 MB L2.
//
// Reductions as in pcg.cu: one partial per task in a fixed slot, and every
// block that needs a problem's sum adds that problem's nchunk partials in
// the same fixed order. No atomics: α and β agree in every block, and two
// runs are bitwise equal. The rz partials are double-buffered by iteration
// parity.
//
// Borders: every neighbour load is guarded and reads 0 outside the image
// (the TPU kernel's rolls wrap, and the zero direction masks kill the
// wrapped values; here the row past the image is not the problem's memory).
// sin/cos are the precise sinf/cosf (no fast math).
//
// What bounds it on this card. Arithmetic: the schedule needs ~95 float32
// operations a pixel and PCG iteration (the factored JtJ of pcg.cu, its
// loop-constant planes once a GN step), so a 19×8×400 solve of a 192×384
// problem is ~4.3·10^11 operations, ~6.4 ms at the 67 TFLOP/s float32 peak;
// this kernel does ~132 (the unfactored JtJ keeps no loop-constant planes).
// Its bytes (14 planes in and out once) are negligible. What bounds it in
// practice is the grid barrier: 3 syncs a
// PCG iteration × 60,800 iterations, each a round trip of every block
// through a counter in device memory (a few µs), against an operations
// bound in the tens of ms. A later design would give each problem a
// thread-block cluster that syncs with cluster.sync() and keeps p in
// distributed shared memory, so that only the scalar reductions cross
// blocks; double-buffering p would cut the syncs to 2 an iteration.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// Chunks per problem: one pixel a thread at 192×384 (264 chunks of 256
// pixels cover 67,584 of its 73,728 pixels) while keeping the per-problem
// partial sums short.
constexpr int kMaxChunks = 264;

struct Args {
  // inputs, read-only for the kernel's lifetime
  const float* vm;    // (B, 4, H, W) direction masks
  const float* fit;   // (B, H, W) fit mask
  const float* csrc;  // (B, 2, H, W) constraint source positions
  const float* ctgt;  // (B, 2, H, W) constraint target positions
  const float* grid;  // (B, 2, H, W) rest positions
  const float* w;     // (B, 2) = (wf2, wr2)
  // output and state, written inside the kernel: plain loads only, never
  // the read-only cache path
  float* x;      // (B, 3, H, W)
  float* sc;     // (B, 2, H, W) sin, cos of the linearisation angle
  float* pre;    // (B, 2, H, W) pre_o (x and y), pre_a
  float* delta;  // (B, 3, H, W)
  float* r;      // (B, 3, H, W)
  float* p;      // (B, 3, H, W)
  float* ap;     // (B, 3, H, W)
  float* part;   // (3, B, nchunk): Σ p·Ap, Σ r·z (two parities)
  int B, H, W, nchunk, num_anneal, gn_iters, pcg_iters;
};

// Fixed-order block sum; every thread returns the total.
__device__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  float total = sh[0];
  __syncthreads();
  return total;
}

// Sum of one problem's `n` task partials, in a fixed order.
__device__ float sum_partials(const float* part, int n, float* sh) {
  float v = 0.f;
  for (int k = threadIdx.x; k < n; k += kThreads) v += part[k];
  return block_sum(v, sh);
}

__device__ __forceinline__ float at(const float* a, int y, int x, int H,
                                    int W) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? a[y * W + x] : 0.f;
}

// DIRS = ((0, 1), (0, -1), (1, 0), (-1, 0)) as (dy, dx); constant after
// unrolling
__device__ __forceinline__ int dir_dy(int k) {
  return k == 2 ? 1 : k == 3 ? -1 : 0;
}
__device__ __forceinline__ int dir_dx(int k) {
  return k == 0 ? 1 : k == 1 ? -1 : 0;
}

// t_dir sign-folded for a unit direction: (tx, ty) per DIRS entry
// (−s, c), (s, −c), (−c, −s), (c, s)
__device__ __forceinline__ void t_fold(int k, float s, float c, float& tx,
                                       float& ty) {
  tx = k == 0 ? -s : k == 1 ? s : k == 2 ? -c : c;
  ty = k == 0 ? c : k == 1 ? -c : k == 2 ? -s : s;
}

// The rest-offset rotation terms of a direction: (dx·c − dy·s, dx·s + dy·c)
// per DIRS entry (c, s), (−c, −s), (−s, c), (s, −c)
__device__ __forceinline__ void rot_fold(int k, float s, float c, float& ex,
                                         float& ey) {
  ex = k == 0 ? c : k == 1 ? -c : k == 2 ? -s : s;
  ey = k == 0 ? s : k == 1 ? -s : k == 2 ? c : -c;
}

// Walks the tasks of this block: for each (problem b, chunk ch) it calls
// begin(b), then f(b, i) on the thread's pixels i of the chunk, then
// end(b, ch, Σ f). The task loop is the same for every thread of the block,
// so begin and end may hold block-level reductions.
template <typename Begin, typename PixelFn, typename End>
__device__ void for_tasks(const Args& a, Begin begin, PixelFn f, End end) {
  const int HW = a.H * a.W;
  const int tasks = a.B * a.nchunk;
  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
    const int b = t / a.nchunk;
    const int ch = t - b * a.nchunk;
    begin(b);
    float acc = 0.f;
    for (int i = ch * kThreads + threadIdx.x; i < HW;
         i += a.nchunk * kThreads)
      acc += f(b, i);
    end(b, ch, acc);
  }
}

__global__ void __launch_bounds__(kThreads, 2) fused_solve(Args a) {
  __shared__ float sh[kThreads];
  cg::grid_group grid = cg::this_grid();
  const int H = a.H, W = a.W, HW = H * W;
  const int nchunk = a.nchunk;
  float* pap_part = a.part;
  float* rz_part0 = a.part + (size_t)a.B * nchunk;
  float* rz_part1 = a.part + (size_t)2 * a.B * nchunk;
  float* shp = sh;
  auto no_begin = [](int) {};
  auto no_sum = [](int, int, float) {};
  // end of a task: its partial into slot (b, ch) of `slots`
  auto write_to = [=](float* slots) {
    return [=](int b, int ch, float acc) {
      const float total = block_sum(acc, shp);
      if (threadIdx.x == 0) slots[b * nchunk + ch] = total;
    };
  };

  // setup: x = (grid, 0), the preconditioner, δ = 0
  for_tasks(a, no_begin, [&](int b, int i) {
    const float* vm = a.vm + (size_t)b * 4 * HW;
    const float wf2 = a.w[2 * b], wr2 = a.w[2 * b + 1];
    float* x = a.x + (size_t)b * 3 * HW;
    float* d = a.delta + (size_t)b * 3 * HW;
    const float* g = a.grid + (size_t)b * 2 * HW;
    x[i] = g[i];
    x[HW + i] = g[HW + i];
    x[2 * HW + i] = 0.f;
    d[i] = 0.f;
    d[HW + i] = 0.f;
    d[2 * HW + i] = 0.f;
    const float deg = ((vm[i] + vm[HW + i]) + vm[2 * HW + i]) + vm[3 * HW + i];
    const float diag_o = 2.f * wr2 * deg + wf2 * a.fit[(size_t)b * HW + i];
    const float to = 1.f + sqrtf(diag_o);
    const float ta = 1.f + sqrtf(wr2 * deg);
    a.pre[(size_t)b * 2 * HW + i] = 1.f / (to * to);
    a.pre[(size_t)b * 2 * HW + HW + i] = 1.f / (ta * ta);
    return 0.f;
  }, no_sum);
  grid.sync();

  for (int ia = 0; ia < a.num_anneal; ++ia) {
    const float al = (float)(ia + 1) / (float)a.num_anneal;
    const float om = 1.f - al;
    for (int g = 0; g < a.gn_iters; ++g) {
      // x += δ of the previous GN step (0 at the first); s, c of the angle
      for_tasks(a, no_begin, [&](int b, int i) {
        float* x = a.x + (size_t)b * 3 * HW;
        const float* d = a.delta + (size_t)b * 3 * HW;
        x[i] = x[i] + d[i];
        x[HW + i] = x[HW + i] + d[HW + i];
        const float ang = x[2 * HW + i] + d[2 * HW + i];
        x[2 * HW + i] = ang;
        a.sc[(size_t)b * 2 * HW + i] = sinf(ang);
        a.sc[(size_t)b * 2 * HW + HW + i] = cosf(ang);
        return 0.f;
      }, no_sum);
      grid.sync();

      // JtF at x (the evalJTF analogue of :83-102); r = −JtF, p = pre·r,
      // δ = 0; partials of Σ r·z
      for_tasks(a, no_begin, [&](int b, int i) {
        const int y = i / W, xx = i - (i / W) * W;
        const float* ox = a.x + (size_t)b * 3 * HW;
        const float* oy = ox + HW;
        const float* sb = a.sc + (size_t)b * 2 * HW;
        const float* cb = sb + HW;
        const float* vm = a.vm + (size_t)b * 4 * HW;
        const float wf2 = a.w[2 * b], wr2 = a.w[2 * b + 1];
        const float* cs = a.csrc + (size_t)b * 2 * HW;
        const float* ct = a.ctgt + (size_t)b * 2 * HW;
        const float oxi = ox[i], oyi = oy[i], s = sb[i], c = cb[i];
        const float cix = om * cs[i] + al * ct[i];
        const float ciy = om * cs[HW + i] + al * ct[HW + i];
        const float wfit = wf2 * a.fit[(size_t)b * HW + i];
        float gx = wfit * (oxi - cix);
        float gy = wfit * (oyi - ciy);
        float ga = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int yy = y + dir_dy(k), xj = xx + dir_dx(k);
          const float oxj = at(ox, yy, xj, H, W), oyj = at(oy, yy, xj, H, W);
          const float sj = at(sb, yy, xj, H, W), cj = at(cb, yy, xj, H, W);
          float rx, ry, rxj, ryj, tx, ty;
          rot_fold(k, s, c, rx, ry);
          rot_fold(k, sj, cj, rxj, ryj);
          t_fold(k, s, c, tx, ty);
          const float ex = (oxi - oxj) + rx;
          const float ey = (oyi - oyj) + ry;
          const float exn = (oxj - oxi) - rxj;
          const float eyn = (oyj - oyi) - ryj;
          const float wv = wr2 * vm[(size_t)k * HW + i];
          gx = gx + wv * (ex - exn);
          gy = gy + wv * (ey - eyn);
          ga = ga + wv * (tx * ex + ty * ey);
        }
        const float* pre = a.pre + (size_t)b * 2 * HW;
        const size_t o = (size_t)b * 3 * HW + i;
        const float r0 = -gx, r1 = -gy, r2 = -ga;
        const float z0 = pre[i] * r0, z1 = pre[i] * r1, z2 = pre[HW + i] * r2;
        a.r[o] = r0;
        a.r[o + HW] = r1;
        a.r[o + 2 * HW] = r2;
        a.p[o] = z0;
        a.p[o + HW] = z1;
        a.p[o + 2 * HW] = z2;
        a.delta[o] = 0.f;
        a.delta[o + HW] = 0.f;
        a.delta[o + 2 * HW] = 0.f;
        return r0 * z0 + r1 * z1 + r2 * z2;
      }, write_to(rz_part1));
      grid.sync();

      for (int it = 0; it < a.pcg_iters; ++it) {
        float* rz_new = (it & 1) ? rz_part1 : rz_part0;
        const float* rz_old = (it & 1) ? rz_part0 : rz_part1;

        // Ap = JtJ·p, unfactored (:112-146); partials of Σ p·Ap
        for_tasks(a, no_begin, [&](int b, int i) {
          const int y = i / W, xx = i - (i / W) * W;
          const float* px = a.p + (size_t)b * 3 * HW;
          const float* py = px + HW;
          const float* pa = py + HW;
          const float* sb = a.sc + (size_t)b * 2 * HW;
          const float* cb = sb + HW;
          const float* vm = a.vm + (size_t)b * 4 * HW;
          const float wf2 = a.w[2 * b], wr2 = a.w[2 * b + 1];
          const float pxi = px[i], pyi = py[i], pai = pa[i];
          const float s = sb[i], c = cb[i];
          const float wfit = wf2 * a.fit[(size_t)b * HW + i];
          const float ax = wfit * pxi;
          const float ay = wfit * pyi;
          float aa = 0.f, accx = 0.f, accy = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int yy = y + dir_dy(k), xj = xx + dir_dx(k);
            const float v = vm[(size_t)k * HW + i];
            const float poxj = at(px, yy, xj, H, W);
            const float poyj = at(py, yy, xj, H, W);
            const float paj = at(pa, yy, xj, H, W);
            const float sj = at(sb, yy, xj, H, W), cj = at(cb, yy, xj, H, W);
            float tx, ty, txj, tyj;
            t_fold(k, s, c, tx, ty);
            t_fold(k, sj, cj, txj, tyj);
            const float dox = pxi - poxj;
            const float doy = pyi - poyj;
            accx = accx + v * ((2.f * dox + pai * tx) + paj * txj);
            accy = accy + v * ((2.f * doy + pai * ty) + paj * tyj);
            aa = aa + (wr2 * v) * ((tx * dox + ty * doy) + pai);
          }
          const float apx = ax + wr2 * accx;
          const float apy = ay + wr2 * accy;
          float* o = a.ap + (size_t)b * 3 * HW;
          o[i] = apx;
          o[HW + i] = apy;
          o[2 * HW + i] = aa;
          return pxi * apx + pyi * apy + pai * aa;
        }, write_to(pap_part));
        grid.sync();

        // α; δ += αp, r −= α·Ap; partials of Σ z·r with z = pre·r
        {
          int cur = -1;
          float alpha = 0.f;
          auto set_alpha = [&](int b) {
            if (b != cur) {
              const float pap = sum_partials(pap_part + b * nchunk, nchunk, sh);
              const float rz = sum_partials(rz_old + b * nchunk, nchunk, sh);
              alpha = pap > 0.f ? rz / pap : 0.f;
              cur = b;
            }
          };
          for_tasks(a, set_alpha, [&](int b, int i) {
            const size_t o = (size_t)b * 3 * HW + i;
            const float* pre = a.pre + (size_t)b * 2 * HW;
            float t = 0.f;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              const size_t k = o + (size_t)ch * HW;
              a.delta[k] = a.delta[k] + alpha * a.p[k];
              const float rv = a.r[k] - alpha * a.ap[k];
              a.r[k] = rv;
              const float z = (ch < 2 ? pre[i] : pre[HW + i]) * rv;
              t += z * rv;
            }
            return t;
          }, write_to(rz_new));
        }
        grid.sync();

        // β; p = pre·r + βp
        {
          int cur = -1;
          float beta = 0.f;
          auto set_beta = [&](int b) {
            if (b != cur) {
              const float rz_o = sum_partials(rz_old + b * nchunk, nchunk, sh);
              const float rz_n = sum_partials(rz_new + b * nchunk, nchunk, sh);
              beta = rz_o > 0.f ? rz_n / rz_o : 0.f;
              cur = b;
            }
          };
          for_tasks(a, set_beta, [&](int b, int i) {
            const size_t o = (size_t)b * 3 * HW + i;
            const float* pre = a.pre + (size_t)b * 2 * HW;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              const size_t k = o + (size_t)ch * HW;
              const float z = (ch < 2 ? pre[i] : pre[HW + i]) * a.r[k];
              a.p[k] = z + beta * a.p[k];
            }
            return 0.f;
          }, no_sum);
        }
        grid.sync();
      }
    }
  }

  // x += δ of the last GN step
  for_tasks(a, no_begin, [&](int b, int i) {
    const size_t o = (size_t)b * 3 * HW + i;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      a.x[o + (size_t)ch * HW] = a.x[o + (size_t)ch * HW] +
                                 a.delta[o + (size_t)ch * HW];
    return 0.f;
  }, no_sum);
}

int chunks(int H, int W) {
  const int need = (H * W + kThreads - 1) / kThreads;
  return need < kMaxChunks ? need : kMaxChunks;
}

}  // namespace

extern "C" {

const char* fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Task partials per problem; the partial-sum scratch holds
// 3·B·fused_solve_nchunk(H, W) floats.
int fused_solve_nchunk(int H, int W) { return chunks(H, W); }

// Blocks of the cooperative launch for B problems of H×W on the current
// device: resident blocks a SM × SMs, at most one per task. Returns the
// count, or −cudaError_t when the occupancy query fails or gives 0.
int fused_solve_blocks(int B, int H, int W) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_solve,
                                                        kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm <= 0) return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long resident = (long)per_sm * sms;
  const long tasks = (long)B * chunks(H, W);
  return static_cast<int>(resident < tasks ? resident : tasks);
}

// x (B,3,H,W) after the whole schedule. vm (B,4,H,W); fit (B,H,W); csrc,
// ctgt, grid (B,2,H,W); w (B,2) = (wf2, wr2); sc, pre (B,2,H,W), delta, r,
// p, ap (B,3,H,W) and part (3,B,nchunk) are scratch. All float32,
// contiguous, on the current device. One cooperative launch on `stream`,
// not synchronised; returns the cudaError_t of the launch (0 = success), so
// a launch the card refuses (too many blocks to be co-resident) is an error.
int fused_solve_f32(const float* vm, const float* fit, const float* csrc,
                    const float* ctgt, const float* grid, const float* w,
                    float* x, float* sc, float* pre, float* delta, float* r,
                    float* p, float* ap, float* part, int B, int H, int W,
                    int num_anneal, int gn_iters, int pcg_iters,
                    void* stream) {
  if (B <= 0) return 0;
  const int blocks = fused_solve_blocks(B, H, W);
  if (blocks < 0) return -blocks;
  Args a{vm, fit, csrc, ctgt, grid, w, x, sc, pre, delta, r, p, ap, part,
         B, H, W, chunks(H, W), num_anneal, gn_iters, pcg_iters};
  void* kargs[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_solve), dim3(blocks), dim3(kThreads),
      kargs, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
