// Fixed-count Jacobi-PCG for the ARAP Gauss-Newton system JtJ·δ = b.
//
// Replaces three TPU kernels of arap_flow_tpu/ops/pallas_pcg.py with one
// function, δ after `iters` iterations of
//     r = b, z = pre·r, p = z, δ = 0, rz = Σ r·z
//     Ap = JtJ·p;  α = rz/Σ p·Ap (0 if Σ p·Ap ≤ 0);  δ += αp;  r −= α·Ap
//     z = pre·r;  rz' = Σ z·r;  β = rz'/rz (0 if rz ≤ 0);  p = z + βp
// with the factored 4-neighbour JtJ apply of _jtj_factored, batched over B
// independent problems with their own weights (wf2, wr2):
//   * pcg_pallas (kernel _pcg_kernel), one problem: B = 1;
//   * pcg_pallas_batched (_pcg_kernel_batched), B problems sharing one
//     weight pair: the per-problem weights here are a superset;
//   * pcg_pallas_tall / pcg_pallas_batched_tall (the ARAP_TALL_KERNEL
//     layout): `tall` selects pcg_jtj<true>, described below.
//
// What bounds it: device-memory bandwidth. An iteration does ~100 flops per
// pixel and streams every state plane: the JtJ pass reads p (3 planes) and
// the linearisation planes s, c, fit, vm[4] (7) and writes Ap (3); the update
// pass reads Ap, p, δ, r, pre (15) and writes δ, r (6); the direction pass
// reads r, pre, p (9) and writes p (3). About 46 plane transfers per problem
// and iteration. What the design does about it:
//   * the loop-constant planes of the TPU kernel (gx/gy[4], fitw, TxW, TyW,
//     degw: 12 planes) are recomputed per pixel from s, c, vm, fit instead of
//     being stored and re-read, so the JtJ pass moves 13 planes, not 24;
//   * one thread per pixel on flat row-major planes: every load is coalesced
//     and the ±1 / ±W neighbours come from L1/L2, so each plane is read from
//     DRAM about once per pass;
//   * a chunk of problems whose 25 state planes fit the L2 (50 MB on the
//     H100 data sheet; a plane is H·W·4 bytes) runs its iteration out of
//     L2 rather than DRAM.
// Fusing the three passes, a persistent cooperative kernel and CUDA graphs
// are later work (csrc/fused_solver.cu is the persistent form of the whole
// schedule).
//
// The tall layout. On the TPU the state of a problem was one stacked (3H, W)
// plane, so a JtJ apply took 4 rolls of the stack instead of 12 rolls of its
// planes; rows that a roll carried across the px/py/pa boundaries landed
// only where the direction mask is 0. A contiguous (B, 3, H, W) tensor
// already is (B, 3H, W) in memory, so here the layout is an addressing
// choice: pcg_jtj<true> reads each neighbour of p at its row in the stack
// and guards only the stack's outer rows (0 and 3H − 1) and the image's
// columns; a read across a sub-plane boundary gets the next plane's value,
// which the zero direction mask multiplies away, as on the TPU. The s, c,
// vm and fit planes stay (H, W) and keep the full guard. Same arithmetic,
// same result as pcg_jtj<false> (up to the sign of a zero).
//
// Scalars never leave the device and nothing uses atomics. Each pass writes
// one partial sum per block to a fixed slot; the next pass reduces those
// partials in a fixed order (every block computes the same value), so α and
// β are identical in every block and a run is bitwise repeatable. The rz
// partials are double-buffered by iteration parity so that a pass can read
// the previous iteration's rz while writing the new one.
//
// Borders: the TPU kernel reads neighbours through wrap-around rolls whose
// garbage the direction masks zero out. Here every neighbour load is guarded
// and reads 0 outside the image (stencil.shift's zero pad): at y = H−1 the
// row y+1 is not the problem's memory, and NaN·0 would be NaN.
//
// Numerics: the neighbour differences are taken first, v·(px − pxj), as in
// _jtj_factored; regrouping them as deg·px − Σ v·pxj cancels large products.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Blocks per problem: enough to fill the card at B = 1 (132 SMs, 2 blocks
// each) while keeping the partial-sum reduction short.
constexpr int kMaxBlocks = 264;

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

// Sum of one problem's `nblk` block partials, in a fixed order.
__device__ float sum_partials(const float* part, int nblk, float* sh) {
  float v = 0.f;
  for (int k = threadIdx.x; k < nblk; k += kThreads) v += part[k];
  return block_sum(v, sh);
}

__device__ __forceinline__ float load_or_zero(const float* a, int y, int x,
                                              int H, int W) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? a[y * W + x] : 0.f;
}

// r = b, p = z = pre·b, δ = 0; per-block partials of Σ r·z.
__global__ void __launch_bounds__(kThreads)
pcg_init(const float* __restrict__ b, const float* __restrict__ pre,
         float* __restrict__ delta, float* __restrict__ r,
         float* __restrict__ p, float* __restrict__ rz_part, int HW,
         int nblk) {
  __shared__ float sh[kThreads];
  const size_t base = (size_t)blockIdx.y * 3 * HW;
  float acc = 0.f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < HW;
       i += nblk * kThreads) {
    float t = 0.f;
    for (int ch = 0; ch < 3; ++ch) {
      const size_t k = base + (size_t)ch * HW + i;
      const float rv = b[k];
      const float z = pre[k] * rv;
      r[k] = rv;
      p[k] = z;
      delta[k] = 0.f;
      t += rv * z;
    }
    acc += t;
  }
  const float total = block_sum(acc, sh);
  if (threadIdx.x == 0) rz_part[blockIdx.y * nblk + blockIdx.x] = total;
}

// Ap = JtJ·p (factored form); per-block partials of Σ p·Ap. kTall reads
// the neighbours of p in the stacked (3H, W) plane (see the note above).
template <bool kTall>
__global__ void __launch_bounds__(kThreads)
pcg_jtj(const float* __restrict__ p, const float* __restrict__ s,
        const float* __restrict__ c, const float* __restrict__ vm,
        const float* __restrict__ fit, const float* __restrict__ w,
        float* __restrict__ ap, float* __restrict__ pap_part, int H, int W,
        int nblk) {
  __shared__ float sh[kThreads];
  const int HW = H * W;
  const int bi = blockIdx.y;
  const float* px = p + (size_t)bi * 3 * HW;
  const float* py = px + HW;
  const float* pa = py + HW;
  const float* sb = s + (size_t)bi * HW;
  const float* cb = c + (size_t)bi * HW;
  const float* fb = fit + (size_t)bi * HW;
  const float* vb = vm + (size_t)bi * 4 * HW;
  float* apx_out = ap + (size_t)bi * 3 * HW;
  const float wf2 = w[2 * bi];
  const float wr2 = w[2 * bi + 1];
  // DIRS = ((0, 1), (0, -1), (1, 0), (-1, 0)) as (dy, dx)
  const int DY[4] = {0, 0, 1, -1};
  const int DX[4] = {1, -1, 0, 0};
  // neighbour (yy, xx) of plane `ch` of p
  auto p_at = [&](int ch, int yy, int xx) -> float {
    if (kTall) {
      const int row = ch * H + yy;  // row of the stacked (3H, W) plane
      return (row >= 0 && row < 3 * H && xx >= 0 && xx < W)
                 ? px[(size_t)row * W + xx] : 0.f;
    }
    return load_or_zero(px + (size_t)ch * HW, yy, xx, H, W);
  };

  float acc = 0.f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < HW;
       i += nblk * kThreads) {
    const int y = i / W;
    const int x = i - y * W;
    const float pxi = px[i], pyi = py[i], pai = pa[i];
    const float si = sb[i], ci = cb[i];
    float v[4], d[4], e[4], paj[4], gx[4], gy[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int yy = y + DY[k], xx = x + DX[k];
      v[k] = vb[(size_t)k * HW + i];
      d[k] = v[k] * (pxi - p_at(0, yy, xx));
      e[k] = v[k] * (pyi - p_at(1, yy, xx));
      paj[k] = p_at(2, yy, xx);
      const float sj = load_or_zero(sb, yy, xx, H, W);
      const float cj = load_or_zero(cb, yy, xx, H, W);
      // t(a_j) for a unit direction, sign-folded: (txj, tyj) per DIRS entry
      // (−s, c), (s, −c), (−c, −s), (c, s)
      const float txj = k == 0 ? -sj : k == 1 ? sj : k == 2 ? -cj : cj;
      const float tyj = k == 0 ? cj : k == 1 ? -cj : k == 2 ? -sj : sj;
      gx[k] = wr2 * v[k] * txj;
      gy[k] = wr2 * v[k] * tyj;
    }
    const float fitw = wf2 * fb[i];
    const float TxW = wr2 * (si * (v[1] - v[0]) + ci * (v[3] - v[2]));
    const float TyW = wr2 * (ci * (v[0] - v[1]) + si * (v[3] - v[2]));
    const float degw = wr2 * ((v[0] + v[1]) + (v[2] + v[3]));
    const float Lx = (d[0] + d[1]) + (d[2] + d[3]);
    const float Ly = (e[0] + e[1]) + (e[2] + e[3]);
    const float Ax = si * (d[1] - d[0]) + ci * (d[3] - d[2]);
    const float Ay = ci * (e[0] - e[1]) + si * (e[3] - e[2]);
    const float Gx = (gx[0] * paj[0] + gx[1] * paj[1]) +
                     (gx[2] * paj[2] + gx[3] * paj[3]);
    const float Gy = (gy[0] * paj[0] + gy[1] * paj[1]) +
                     (gy[2] * paj[2] + gy[3] * paj[3]);
    const float apx = fitw * pxi + (2.f * wr2) * Lx + TxW * pai + Gx;
    const float apy = fitw * pyi + (2.f * wr2) * Ly + TyW * pai + Gy;
    const float apa = wr2 * (Ax + Ay) + degw * pai;
    apx_out[i] = apx;
    apx_out[HW + i] = apy;
    apx_out[2 * HW + i] = apa;
    acc += pxi * apx + pyi * apy + pai * apa;
  }
  const float total = block_sum(acc, sh);
  if (threadIdx.x == 0) pap_part[bi * nblk + blockIdx.x] = total;
}

// α from the Σ p·Ap and previous Σ r·z partials; δ += αp, r −= α·Ap;
// per-block partials of the new Σ z·r with z = pre·r.
__global__ void __launch_bounds__(kThreads)
pcg_update(const float* __restrict__ ap, const float* __restrict__ p,
           const float* __restrict__ pre, float* __restrict__ delta,
           float* __restrict__ r, const float* __restrict__ pap_part,
           const float* __restrict__ rz_old_part,
           float* __restrict__ rz_new_part, int HW, int nblk) {
  __shared__ float sh[kThreads];
  const int bi = blockIdx.y;
  const float pap = sum_partials(pap_part + bi * nblk, nblk, sh);
  const float rz = sum_partials(rz_old_part + bi * nblk, nblk, sh);
  const float alpha = pap > 0.f ? rz / pap : 0.f;
  const size_t base = (size_t)bi * 3 * HW;
  float acc = 0.f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < HW;
       i += nblk * kThreads) {
    float t = 0.f;
    for (int ch = 0; ch < 3; ++ch) {
      const size_t k = base + (size_t)ch * HW + i;
      delta[k] = delta[k] + alpha * p[k];
      const float rv = r[k] - alpha * ap[k];
      r[k] = rv;
      const float z = pre[k] * rv;
      t += z * rv;
    }
    acc += t;
  }
  const float total = block_sum(acc, sh);
  if (threadIdx.x == 0) rz_new_part[bi * nblk + blockIdx.x] = total;
}

// β from the new and previous Σ r·z partials; p = pre·r + βp.
__global__ void __launch_bounds__(kThreads)
pcg_direction(const float* __restrict__ r, const float* __restrict__ pre,
              float* __restrict__ p, const float* __restrict__ rz_old_part,
              const float* __restrict__ rz_new_part, int HW, int nblk) {
  __shared__ float sh[kThreads];
  const int bi = blockIdx.y;
  const float rz_old = sum_partials(rz_old_part + bi * nblk, nblk, sh);
  const float rz_new = sum_partials(rz_new_part + bi * nblk, nblk, sh);
  const float beta = rz_old > 0.f ? rz_new / rz_old : 0.f;
  const size_t base = (size_t)bi * 3 * HW;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < HW;
       i += nblk * kThreads) {
    for (int ch = 0; ch < 3; ++ch) {
      const size_t k = base + (size_t)ch * HW + i;
      const float z = pre[k] * r[k];
      p[k] = z + beta * p[k];
    }
  }
}

}  // namespace

extern "C" {

// Blocks per problem for an H×W problem; the partial-sum scratch holds
// 3·B·pcg_fixed_nblk(H, W) floats.
int pcg_fixed_nblk(int H, int W) {
  const int need = (H * W + kThreads - 1) / kThreads;
  return need < kMaxBlocks ? need : kMaxBlocks;
}

const char* pcg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// δ (B,3,H,W) after `iters` PCG iterations. b, pre (B,3,H,W); s, c, fit
// (B,H,W); vm (B,4,H,W); w (B,2) = (wf2, wr2); r, p, ap (B,3,H,W) and part
// (3,B,nblk) are scratch. All float32, contiguous, on the stream's device.
// `tall` != 0 runs the JtJ pass in the stacked (3H, W) layout. Enqueues
// 1 + 3·iters kernels on `stream` without synchronising; returns the
// cudaError_t of the launches (0 = success).
int pcg_fixed_f32(const float* b, const float* pre, const float* s,
                  const float* c, const float* vm, const float* fit,
                  const float* w, float* delta, float* r, float* p, float* ap,
                  float* part, int B, int H, int W, int iters, int tall,
                  void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const int nblk = pcg_fixed_nblk(H, W);
  const dim3 grid(nblk, B);
  float* pap_part = part;
  float* rz_part[2] = {part + (size_t)B * nblk, part + (size_t)2 * B * nblk};

  // the init partials stand in for "iteration −1", slot 1
  pcg_init<<<grid, kThreads, 0, st>>>(b, pre, delta, r, p, rz_part[1], HW,
                                      nblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int it = 0; it < iters; ++it) {
    float* rz_new = rz_part[it & 1];
    const float* rz_old = rz_part[(it + 1) & 1];
    if (tall)
      pcg_jtj<true><<<grid, kThreads, 0, st>>>(p, s, c, vm, fit, w, ap,
                                               pap_part, H, W, nblk);
    else
      pcg_jtj<false><<<grid, kThreads, 0, st>>>(p, s, c, vm, fit, w, ap,
                                                pap_part, H, W, nblk);
    pcg_update<<<grid, kThreads, 0, st>>>(ap, p, pre, delta, r, pap_part,
                                          rz_old, rz_new, HW, nblk);
    pcg_direction<<<grid, kThreads, 0, st>>>(r, pre, p, rz_old, rz_new, HW,
                                             nblk);
    if (it == 0) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
