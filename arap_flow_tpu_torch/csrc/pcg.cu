// Fixed-count Jacobi-PCG for the ARAP Gauss-Newton system JtJ·δ = b, as one
// thread-block-cluster launch per call.
//
// Replaces four TPU kernels of arap_flow_tpu/ops/pallas_pcg.py: _pcg_kernel
// (:169, pcg_pallas, one problem), _pcg_kernel_batched (:431,
// pcg_pallas_batched, B problems sharing one weight pair: the per-problem
// weights here are a superset), and the stacked-plane layouts
// pcg_pallas_tall (:377) and pcg_pallas_batched_tall (:651). It computes δ
// after `iters` iterations of
//     r = b, z = pre·r, p = z, δ = 0, rz = Σ r·z
//     Ap = JtJ·p;  α = rz/Σ p·Ap (0 if Σ p·Ap ≤ 0);  δ += αp;  r −= α·Ap
//     z = pre·r;  rz' = Σ z·r;  β = rz'/rz (0 if rz ≤ 0);  p = z + βp
// with the factored 4-neighbour JtJ apply of _jtj_factored, over B
// independent problems with their own weights (wf2, wr2).
//
// Layout. The grid is (cluster, B) with cluster dims (cluster, 1, 1): one
// cluster of up to 16 CTAs per problem, all `iters` iterations inside one
// launch. CTA `rank` owns the rows [rank·rows, (rank + 1)·rows) of its
// problem, and thread t the band's pixels t, t + 512, ... for the whole
// call, so a pixel's own r, δ and Ap are only ever touched by one thread.
// Where W is even (every crop bucket and the 854-wide frame) a thread takes
// pixel pairs instead, 2t, 2t + 1024, ... and their right neighbours: each
// plane's pair is one 8-byte load, and the pair shares its inner
// neighbours, which cuts the loads and address arithmetic a pixel.
// Problems are independent: clusters never wait for each other, and a batch
// larger than the card runs in waves. The host picks the plan
// (ops/pcg.py::pcg_plan); the entry checks it against the card with
// cudaOccupancyMaxActiveClusters and refuses a plan of which no cluster fits.
//
// Memory plans. Only p is read across threads (its 4 neighbours); every
// other mutable plane is private to its pixel's thread. Each CTA keeps p's
// row above and below its band (its halo rows) in shared memory, pushed by
// the CTAs that own them.
//   * resident: the CTA's rows of p (3 planes) live in shared memory, each
//     plane's band between its two halo rows, so a neighbour load is one
//     shared-memory load at a fixed offset. Then, in this order and as far
//     as the 227 KB a block can use allows, the CTA's rows of s and c with
//     one halo row on each side (read once from device memory), r, Ap and
//     δ. What does not fit stays in device memory, as do the loop-invariant
//     pre, vm, fit and b, which stay L2-resident across the call. Which
//     planes are in shared memory is a template parameter, so that every
//     access has its own address space.
//   * streamed, for shapes whose p does not fit 16 CTAs (480×854, 512×896):
//     p, r, Ap and δ in device memory, each read and written only by the
//     CTA that owns the pixel (a CTA barrier orders them), and only the
//     halo rows in shared memory.
//
// Synchronisation without cluster barriers. A cluster barrier with the
// release/acquire that shared data needs costs a GPU-scope fence and an L1
// invalidate, ~0.75 µs for 16 CTAs on an H100 (tools/cluster_sync_bench.cu),
// three times an iteration. Instead a CTA pushes what others read into
// their shared memory with st.async, which completes bytes on the
// receiver's mbarrier, and waits only on its own mbarriers:
//   * its partial sums of p·Ap and r·z (the CTA's pixels summed in a fixed
//     order: warp shuffles, then the warps' sums) into slot `rank` of every
//     CTA's mailbox, the r·z mailbox double-buffered by iteration parity;
//     every CTA then sums the `cluster` slots in rank order, so α and β are
//     identical everywhere, nothing uses atomics, and a run is bitwise
//     repeatable;
//   * its new edge rows of p, after the p update, into the neighbours'
//     halo rows.
// One mbarrier a mailbox suffices: a phase's bytes can only arrive after
// the receiver has finished the phase before, because every push needs a
// value that the receiver sends after it (a CTA pushes the p·Ap partial of
// iteration i + 1 only after it has every CTA's r·z partial of iteration
// i, which each CTA sends after reading its p·Ap mailbox of iteration i).
// Cluster barriers remain only at the start (every mbarrier set up before
// anyone pushes) and at the end (no CTA leaves while another may address
// it).
//
// What bounds it: per-SM instruction issue and, in the streamed plan and
// wherever planes stay in device memory, L2 latency, on at most 16 of the
// 132 SMs a problem; a small batch leaves most of the card idle, and a
// large single problem runs slower than a kernel that spreads it over the
// card. Device-memory bandwidth does not: within a call the state moves
// between the SMs and L2 only.
//
// The tall layout (kTall). On the TPU the state of a problem was one stacked
// (3H, W) plane, so a JtJ apply took 4 rolls of the stack instead of 12;
// rows that a roll carried across the px/py/pa boundaries landed only where
// the direction mask is 0. Here a neighbour of p is addressed at its row in
// the stack and guarded only at the stack's rows 0 and 3H − 1 and the
// image's columns: the halo row above plane ch's row 0 is plane ch − 1's
// row H − 1, pushed by the last CTA, and the one below plane ch's row H − 1
// is plane ch + 1's row 0, pushed by the first; the zero direction mask
// multiplies them away. s, c, vm and fit stay (H, W) with the full guard.
// Same arithmetic, same δ as the standard layout (up to the sign of a
// zero).
//
// Borders: every other neighbour load reads 0 outside the image
// (stencil.shift's zero pad; NaN·0 would be NaN): a guard on the columns,
// s and c, and halo rows that no CTA pushes stay 0.
//
// Numerics: the neighbour differences are taken first, v·(px − pxj), as in
// _jtj_factored (regrouping them as deg·px − Σ v·pxj cancels large products),
// and the 12 loop-constant planes of the TPU kernel (gx/gy[4], fitw, TxW,
// TyW, degw) are recomputed per pixel from s, c, vm and fit.
//
// The earlier three-pass form (pcg_init, pcg_jtj, pcg_update,
// pcg_direction: 1 + 3·iters launches a call) stays below as a yardstick,
// entry pcg_three_pass_f32; no solver route reaches it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kSmemPerBlock = 232448;  // what one block of an H100 can use
// pcg_fixed_f32's code when no cluster of the plan fits the card
constexpr int kNoClusterFits = -1;
// A wait on a mailbox that outlasts this many clock cycles (seconds at any
// clock) traps instead of hanging the card.
constexpr long long kWaitLimit = 20000000000LL;

struct PcgArgs {
  const float* b;
  const float* pre;
  const float* s;
  const float* c;
  const float* vm;
  const float* fit;
  const float* w;
  float* delta;
  float* r;   // scratch when r is not in shared memory
  float* p;   // scratch in the streamed plan
  float* ap;  // scratch when Ap is not in shared memory
  int H, W, rows, iters;
};

// Dynamic shared-memory floats of a plan: the p halo rows above and below
// the band (3 planes each), p (resident only), then the groups in order: s
// and c with halo rows, r, Ap, δ.
size_t plan_floats(int rows, int W, int resident, int groups) {
  const size_t band = (size_t)rows * W;
  size_t n = 6 * (size_t)W + (resident ? 3 * band : 0);
  if (groups >= 1) n += 2 * (band + 2 * (size_t)W);
  for (int g = 2; g <= groups; ++g) n += 3 * band;
  return n;
}

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

// Ap of one pixel, the factored form of _jtj_factored: its p (pc), the p of
// its neighbours in DIRS order ((0, 1), (0, −1), (1, 0), (−1, 0); pj[ch][k],
// 0 outside the image), its s and c and its neighbours' (sj, cj, 0
// outside), its direction masks v and its fit mask.
__device__ __forceinline__ void jtj_pixel(
    const float (&pc)[3], const float (&pj)[3][4], float si, float ci,
    const float (&sj)[4], const float (&cj)[4], const float (&v)[4],
    float fit, float wf2, float wr2, float (&ap)[3]) {
  float d[4], e[4], gx[4], gy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d[k] = v[k] * (pc[0] - pj[0][k]);
    e[k] = v[k] * (pc[1] - pj[1][k]);
    // t(a_j) for a unit direction, sign-folded: (txj, tyj) per DIRS entry
    // (−s, c), (s, −c), (−c, −s), (c, s)
    const float txj = k == 0 ? -sj[k] : k == 1 ? sj[k] : k == 2 ? -cj[k]
                                                                : cj[k];
    const float tyj = k == 0 ? cj[k] : k == 1 ? -cj[k] : k == 2 ? -sj[k]
                                                                : sj[k];
    gx[k] = wr2 * v[k] * txj;
    gy[k] = wr2 * v[k] * tyj;
  }
  const float fitw = wf2 * fit;
  const float TxW = wr2 * (si * (v[1] - v[0]) + ci * (v[3] - v[2]));
  const float TyW = wr2 * (ci * (v[0] - v[1]) + si * (v[3] - v[2]));
  const float degw = wr2 * ((v[0] + v[1]) + (v[2] + v[3]));
  const float Lx = (d[0] + d[1]) + (d[2] + d[3]);
  const float Ly = (e[0] + e[1]) + (e[2] + e[3]);
  const float Ax = si * (d[1] - d[0]) + ci * (d[3] - d[2]);
  const float Ay = ci * (e[0] - e[1]) + si * (e[3] - e[2]);
  const float Gx = (gx[0] * pj[2][0] + gx[1] * pj[2][1]) +
                   (gx[2] * pj[2][2] + gx[3] * pj[2][3]);
  const float Gy = (gy[0] * pj[2][0] + gy[1] * pj[2][1]) +
                   (gy[2] * pj[2][2] + gy[3] * pj[2][3]);
  ap[0] = fitw * pc[0] + (2.f * wr2) * Lx + TxW * pc[2] + Gx;
  ap[1] = fitw * pc[1] + (2.f * wr2) * Ly + TyW * pc[2] + Gy;
  ap[2] = wr2 * (Ax + Ay) + degw * pc[2];
}

// Two neighbouring floats (8-byte aligned), through the read-only path for
// the loop-invariant inputs.
__device__ __forceinline__ float2 ld2(const float* q) {
  return *reinterpret_cast<const float2*>(q);
}
__device__ __forceinline__ float2 ldg2(const float* q) {
  return __ldg(reinterpret_cast<const float2*>(q));
}
__device__ __forceinline__ void st2(float* q, float x, float y) {
  *reinterpret_cast<float2*>(q) = make_float2(x, y);
}

// The JtJ pass's loop-invariant values of band pixel li (nothing past n):
// the direction masks (planes vk[k]), the fit mask, s and c.
__device__ __forceinline__ void load_invariants(
    const float* const (&vk)[4], const float* fb, const float* sp,
    const float* cp, int li, int n, float (&v)[4], float& fit, float& s,
    float& c) {
  if (li >= n) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = __ldg(vk[k] + li);
  fit = __ldg(fb + li);
  s = sp[li];
  c = cp[li];
}

// The update pass's pre (planes pk[ch]) and δ of band pixel li (nothing
// past n).
__device__ __forceinline__ void load_update(const float* const (&pk)[3],
                                            const float* dp, int ds, int li,
                                            int n, float (&pre)[3],
                                            float (&d)[3]) {
  if (li >= n) return;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    pre[ch] = __ldg(pk[ch] + li);
    d[ch] = dp[ch * ds + li];
  }
}

// kGroups of (s and c, r, Ap, δ) live in shared memory and the rest in
// device memory, fixed at compile time so that every access has its own
// address space; the streamed plan (kResident false) has kGroups 0. With
// kPair (W even) a thread takes two neighbouring pixels of a row at a time:
// it loads each plane's pair, and the rows above and below, as one 8-byte
// access, and the pair shares its inner neighbours.
template <bool kTall, int kGroups, bool kResident, bool kPair>
__global__ void __launch_bounds__(kThreads, 1) pcg_cluster(PcgArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ float warp_part[kWarps];
  __shared__ float rz0_slot;            // Σ r·z of the start, read by DSMEM
  __shared__ float pap_box[kMaxCluster];     // Σ p·Ap of each rank
  __shared__ float rz_box[2][kMaxCluster];   // Σ r·z of each rank, by parity
  __shared__ alignas(8) unsigned long long bars[3];  // halo, p·Ap, r·z
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int nrank = static_cast<int>(cl.num_blocks());
  const int H = a.H, W = a.W, R = a.rows, HW = H * W;
  const int bi = blockIdx.y;
  const int y0 = rank * R;
  const int nrows = min(H, y0 + R) - y0;
  const int n = nrows * W;
  const size_t pb3 = (size_t)bi * 3 * HW;
  const size_t band = (size_t)y0 * W;
  // loop-invariant inputs at the band's first pixel, planes HW apart
  const float* bb = a.b + pb3 + band;
  const float* preb = a.pre + pb3 + band;
  const float* vb = a.vm + (size_t)bi * 4 * HW + band;
  const float* fb = a.fit + (size_t)bi * HW + band;
  const float wf2 = a.w[2 * bi];
  const float wr2 = a.w[2 * bi + 1];
  const unsigned bar_halo = smem_addr(&bars[0]);
  const unsigned bar_pap = smem_addr(&bars[1]);
  const unsigned bar_rz = smem_addr(&bars[2]);
  if (threadIdx.x == 0) {
    bar_init(bar_halo);
    bar_init(bar_pap);
    bar_init(bar_rz);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // Each state plane at the band's first pixel, with its plane stride.
  float* sm = reinterpret_cast<float*>(smem4);
  const int RW = R * W;
  // p's halo rows: plane ch's row above the band at top[ch·hs] and row
  // below it at bot[ch·hs], as their owners pushed them; rows with no owner
  // (outside the image) stay 0. Resident: each plane's band sits between
  // its two halo rows, (R + 2)·W floats a plane. Streamed: the band is in
  // device memory and the halo rows are two (3, W) arrays.
  for (int k = threadIdx.x; k < 6 * W + (kResident ? 3 * RW : 0);
       k += kThreads)
    sm[k] = 0.f;
  float* pp;
  int ps, hs;
  float *top, *bot;
  if constexpr (kResident) {
    pp = sm + W; ps = hs = RW + 2 * W; sm += 3 * ps;
    top = pp - W;
    bot = pp + nrows * W;
  } else {
    pp = a.p + pb3 + band; ps = HW; hs = W;
    top = sm; bot = sm + 3 * W; sm += 6 * W;
  }
  const float *sp, *cp;  // s, c at band row ly ∈ [−1, R]: sp[ly·W + x]
  if constexpr (kGroups >= 1) {
    float* s_sm = sm + W;
    float* c_sm = s_sm + RW + 2 * W;
    for (int k = threadIdx.x; k < RW + 2 * W; k += kThreads) {
      const int ly = k / W - 1, x = k - (ly + 1) * W, yy = y0 + ly;
      const bool in = yy >= 0 && yy < H;
      const size_t g = (size_t)bi * HW + (size_t)yy * W + x;
      s_sm[ly * W + x] = in ? a.s[g] : 0.f;
      c_sm[ly * W + x] = in ? a.c[g] : 0.f;
    }
    sp = s_sm; cp = c_sm; sm += 2 * (RW + 2 * W);
  } else {
    sp = a.s + (size_t)bi * HW + band;
    cp = a.c + (size_t)bi * HW + band;
  }
  float* rp;
  int rs;
  if constexpr (kGroups >= 2) {
    rp = sm; rs = RW; sm += 3 * RW;
  } else {
    rp = a.r + pb3 + band; rs = HW;
  }
  float* app;
  int as;
  if constexpr (kGroups >= 3) {
    app = sm; as = RW; sm += 3 * RW;
  } else {
    app = a.ap + pb3 + band; as = HW;
  }
  float* dp;
  int ds;
  if constexpr (kGroups >= 4) {
    dp = sm; ds = RW;
  } else {
    dp = a.delta + pb3 + band; ds = HW;
  }

  // Who pushes this CTA's halo rows, and where this CTA pushes its edge
  // rows. Standard layout: rank ± 1, all 3 planes. Tall layout, in the
  // stacked (3H, W) plane: the row above plane ch's row 0 is plane ch − 1's
  // row H − 1 (the last rank's), the row below plane ch's row H − 1 is
  // plane ch + 1's row 0 (rank 0's).
  const int last = nrank - 1;
  const unsigned top_bytes = 4u * W * (rank > 0 ? 3 : kTall ? 2 : 0);
  const unsigned bot_bytes = 4u * W * (rank < last ? 3 : kTall ? 2 : 0);
  const unsigned halo_bytes = top_bytes + bot_bytes;
  const unsigned box_bytes = 4u * nrank;
  // the receivers' halo rows and mbarriers: the same layout in every CTA,
  // but the last band may be shorter, which moves its bottom halo rows
  const int up_rank = rank > 0 ? rank - 1 : last;
  const int dn_rank = rank < last ? rank + 1 : 0;
  const int up_rows = up_rank == last ? H - last * R : R;
  const unsigned up_bot = at_rank(
      smem_addr(kResident ? pp + up_rows * W : bot), up_rank);
  const unsigned up_bar = at_rank(bar_halo, up_rank);
  const unsigned dn_top = at_rank(smem_addr(top), dn_rank);
  const unsigned dn_bar = at_rank(bar_halo, dn_rank);
  // Push the band's new edge rows of p (pixel li, its 3 values) to the
  // CTAs that read them as halo.
  auto push_edges = [&](int li, const float (&pv)[3]) {
    if (li < W) {  // first row: the bottom halo of the CTA above
      const int x = li;
      if (rank > 0) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          st_async(up_bot + 4u * (ch * hs + x), pv[ch], up_bar);
      } else if (kTall) {  // planes 1, 2 → the last rank's planes 0, 1
#pragma unroll
        for (int ch = 1; ch < 3; ++ch)
          st_async(up_bot + 4u * ((ch - 1) * hs + x), pv[ch], up_bar);
      }
    }
    if (li >= n - W) {  // last row: the top halo of the CTA below
      const int x = li - (n - W);
      if (rank < last) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          st_async(dn_top + 4u * (ch * hs + x), pv[ch], dn_bar);
      } else if (kTall) {  // planes 0, 1 → rank 0's planes 1, 2
#pragma unroll
        for (int ch = 0; ch < 2; ++ch)
          st_async(dn_top + 4u * ((ch + 1) * hs + x), pv[ch], dn_bar);
      }
    }
  };
  // Send this CTA's partial (in warp 0) to slot `rank` of every CTA's box.
  auto send_partial = [&](float t, const float* box, unsigned bar) {
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 32 && lane < nrank)
      st_async(at_rank(smem_addr(box + rank), lane), t, at_rank(bar, lane));
  };

  // a thread's pixels: li = tid + k·kThreads (pairs: li = 2·tid +
  // k·2·kThreads) at band row ly, column x, stepped without a division
  const int row_step = kThreads / W, col_step = kThreads - row_step * W;
  const int row_step2 = 2 * kThreads / W;
  const int col_step2 = 2 * kThreads - row_step2 * W;
  // the loop-invariant planes at the band's first pixel
  const float* const vk[4] = {vb, vb + HW, vb + 2 * HW, vb + 3 * HW};
  const float* const prek[3] = {preb, preb + HW, preb + 2 * HW};

  // r = b, p = z = pre·b, δ = 0 and Σ r·z
  float acc = 0.f;
  for (int li = threadIdx.x; li < n; li += kThreads) {
    float t = 0.f;
    for (int ch = 0; ch < 3; ++ch) {
      const float rv = __ldg(bb + (size_t)ch * HW + li);
      const float z = __ldg(preb + (size_t)ch * HW + li) * rv;
      rp[ch * rs + li] = rv;
      pp[ch * ps + li] = z;
      dp[ch * ds + li] = 0.f;
      t += rv * z;
    }
    acc += t;
  }
  acc = cta_total(acc, warp_part);
  if (threadIdx.x == 0) rz0_slot = acc;
  // every CTA has started, zeroed its halo rows and set up its mbarriers
  // before anyone pushes to it or reads its shared memory
  cl.sync();
  float rz;
  {
    const int lane = threadIdx.x & 31;
    const float t = warp_sum(
        lane < nrank ? *cl.map_shared_rank(&rz0_slot, lane) : 0.f);
    rz = __shfl_sync(0xffffffffu, t, 0);
  }
  if (a.iters > 0) {
    if (threadIdx.x == 0) {
      bar_expect(bar_halo, halo_bytes);
      bar_expect(bar_pap, box_bytes);
      bar_expect(bar_rz, box_bytes);
    }
    for (int li = threadIdx.x; li < n; li += kThreads) {
      if (li < W || li >= n - W) {
        const float pv[3] = {pp[li], pp[ps + li], pp[2 * ps + li]};
        push_edges(li, pv);
      }
    }
  }

  for (int it = 0; it < a.iters; ++it) {
    const unsigned parity = it & 1;
    const bool more = it + 1 < a.iters;
    // the band's p (written by other threads of this CTA) and its halo
    // rows (pushed by the neighbours) for this iteration
    __syncthreads();
    if (threadIdx.x == 0 && it > 0) bar_expect(bar_rz, box_bytes);
    bar_wait(bar_halo, parity);

    // Ap = JtJ·p (factored form) and Σ p·Ap. The pixel's loop-invariant
    // values (v[4], fit, s, c) are loaded one pixel ahead, so their latency
    // hides behind the current pixel's work.
    acc = 0.f;
    if constexpr (kPair) {
      int ly = 2 * threadIdx.x / W, x = 2 * threadIdx.x - ly * W;
      for (int li = 2 * threadIdx.x; li < n; li += 2 * kThreads) {
        // pixels (x, x + 1): their outer neighbours x − 1 and x + 2 are
        // guarded, the inner ones are each other
        const bool okr = x + 2 < W, okl = x > 0;
        const bool okd = y0 + ly + 1 < H, oku = y0 + ly > 0;
        const float *dn, *up;
        int dns, ups;
        if constexpr (kResident) {
          dn = pp + li + W; up = pp + li - W; dns = ups = ps;
        } else {
          const bool in_dn = ly + 1 < nrows, in_up = ly > 0;
          dn = in_dn ? pp + li + W : bot + x;
          up = in_up ? pp + li - W : top + x;
          dns = in_dn ? ps : hs;
          ups = in_up ? ps : hs;
        }
        float pc[2][3], pj[2][3][4];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float* const qc = pp + ch * ps + li;
          const float2 c2 = ld2(qc), d2 = ld2(dn + ch * dns),
                       u2 = ld2(up + ch * ups);
          const float l = okl ? qc[-1] : 0.f, r = okr ? qc[2] : 0.f;
          pc[0][ch] = c2.x;
          pc[1][ch] = c2.y;
          pj[0][ch][0] = c2.y; pj[0][ch][1] = l;
          pj[0][ch][2] = d2.x; pj[0][ch][3] = u2.x;
          pj[1][ch][0] = r; pj[1][ch][1] = c2.x;
          pj[1][ch][2] = d2.y; pj[1][ch][3] = u2.y;
        }
        float si[2], ci[2], sj[2][4], cj[2][4];
        const float* const scq[2] = {sp + li, cp + li};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* const q = scq[m];
          const float2 c2 = ld2(q);
          const float2 d2 = okd ? ld2(q + W) : make_float2(0.f, 0.f);
          const float2 u2 = oku ? ld2(q - W) : make_float2(0.f, 0.f);
          const float l = okl ? q[-1] : 0.f, r = okr ? q[2] : 0.f;
          float(&cen)[2] = m == 0 ? si : ci;
          float(&nb)[2][4] = m == 0 ? sj : cj;
          cen[0] = c2.x; cen[1] = c2.y;
          nb[0][0] = c2.y; nb[0][1] = l; nb[0][2] = d2.x; nb[0][3] = u2.x;
          nb[1][0] = r; nb[1][1] = c2.x; nb[1][2] = d2.y; nb[1][3] = u2.y;
        }
        float2 v2[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v2[k] = ldg2(vk[k] + li);
        const float2 fit2 = ldg2(fb + li);
        float ap[2][3];
        const float v0[4] = {v2[0].x, v2[1].x, v2[2].x, v2[3].x};
        const float v1[4] = {v2[0].y, v2[1].y, v2[2].y, v2[3].y};
        jtj_pixel(pc[0], pj[0], si[0], ci[0], sj[0], cj[0], v0, fit2.x, wf2,
                  wr2, ap[0]);
        jtj_pixel(pc[1], pj[1], si[1], ci[1], sj[1], cj[1], v1, fit2.y, wf2,
                  wr2, ap[1]);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          st2(app + ch * as + li, ap[0][ch], ap[1][ch]);
        acc += pc[0][0] * ap[0][0] + pc[0][1] * ap[0][1] + pc[0][2] * ap[0][2];
        acc += pc[1][0] * ap[1][0] + pc[1][1] * ap[1][1] + pc[1][2] * ap[1][2];
        x += col_step2;
        ly += row_step2;
        if (x >= W) {
          x -= W;
          ++ly;
        }
      }
    } else {
    float nv[4] = {0.f, 0.f, 0.f, 0.f}, nfit = 0.f, ns = 0.f, nc = 0.f;
    load_invariants(vk, fb, sp, cp, threadIdx.x, n, nv, nfit, ns, nc);
    int ly = threadIdx.x / W, x = threadIdx.x - ly * W;
    for (int li = threadIdx.x; li < n; li += kThreads) {
      const float v[4] = {nv[0], nv[1], nv[2], nv[3]};
      const float fiti = nfit, si = ns, ci = nc;
      load_invariants(vk, fb, sp, cp, li + kThreads, n, nv, nfit, ns, nc);
      // the pixel in each plane of p, and in s and c
      const float* const q[3] = {pp + li, pp + ps + li, pp + 2 * ps + li};
      const float* const sq = sp + li;
      const float* const cq = cp + li;
      const float pc[3] = {q[0][0], q[1][0], q[2][0]};
      // the neighbours in DIRS order ((0, 1), (0, −1), (1, 0), (−1, 0)):
      // p of the rows above and below from the halo rows at the band's
      // edges, s and c 0 outside the image
      const bool ok[4] = {x + 1 < W, x > 0, y0 + ly + 1 < H, y0 + ly > 0};
      const float *dn, *up;
      int dns, ups;
      if constexpr (kResident) {
        dn = q[0] + W; up = q[0] - W; dns = ups = ps;
      } else {
        const bool in_dn = ly + 1 < nrows, in_up = ly > 0;
        dn = in_dn ? pp + li + W : bot + x;
        up = in_up ? pp + li - W : top + x;
        dns = in_dn ? ps : hs;
        ups = in_up ? ps : hs;
      }
      float pj[3][4];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        pj[ch][0] = ok[0] ? q[ch][1] : 0.f;
        pj[ch][1] = ok[1] ? q[ch][-1] : 0.f;
        pj[ch][2] = dn[ch * dns];
        pj[ch][3] = up[ch * ups];
      }
      const int off[4] = {1, -1, W, -W};
      float sj[4], cj[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sj[k] = ok[k] ? sq[off[k]] : 0.f;
        cj[k] = ok[k] ? cq[off[k]] : 0.f;
      }
      float ap[3];
      jtj_pixel(pc, pj, si, ci, sj, cj, v, fiti, wf2, wr2, ap);
      float* const aq = app + li;
      aq[0] = ap[0];
      aq[as] = ap[1];
      aq[2 * as] = ap[2];
      acc += pc[0] * ap[0] + pc[1] * ap[1] + pc[2] * ap[2];
      x += col_step;
      ly += row_step;
      if (x >= W) {
        x -= W;
        ++ly;
      }
    }
    }
    acc = cta_total(acc, warp_part);
    // every thread is past this iteration's halo wait
    if (threadIdx.x == 0 && more) bar_expect(bar_halo, halo_bytes);
    send_partial(acc, pap_box, bar_pap);
    bar_wait(bar_pap, parity);
    const float pap = mailbox_total(pap_box, nrank);

    // δ += αp, r −= α·Ap, and Σ z·r with z = pre·r. z takes Ap's place,
    // which is not read again this iteration. pre and δ are loaded one
    // pixel ahead.
    const float alpha = pap > 0.f ? rz / pap : 0.f;
    acc = 0.f;
    if constexpr (kPair) {
      for (int li = 2 * threadIdx.x; li < n; li += 2 * kThreads) {
        float t0 = 0.f, t1 = 0.f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float* const dq = dp + ch * ds + li;
          float* const rq = rp + ch * rs + li;
          float* const aq = app + ch * as + li;
          const float2 pre2 = ldg2(prek[ch] + li), p2 = ld2(pp + ch * ps + li);
          const float2 d2 = ld2(dq), r2 = ld2(rq), a2 = ld2(aq);
          st2(dq, d2.x + alpha * p2.x, d2.y + alpha * p2.y);
          const float r0 = r2.x - alpha * a2.x, r1 = r2.y - alpha * a2.y;
          st2(rq, r0, r1);
          const float z0 = pre2.x * r0, z1 = pre2.y * r1;
          st2(aq, z0, z1);
          t0 += z0 * r0;
          t1 += z1 * r1;
        }
        acc += t0;
        acc += t1;
      }
    } else {
    float npre[3] = {0.f, 0.f, 0.f}, nd[3] = {0.f, 0.f, 0.f};
    load_update(prek, dp, ds, threadIdx.x, n, npre, nd);
    for (int li = threadIdx.x; li < n; li += kThreads) {
      const float prei[3] = {npre[0], npre[1], npre[2]};
      const float di[3] = {nd[0], nd[1], nd[2]};
      load_update(prek, dp, ds, li + kThreads, n, npre, nd);
      float *const dq = dp + li, *const rq = rp + li, *const aq = app + li;
      const float* const pq = pp + li;
      float t = 0.f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        dq[ch * ds] = di[ch] + alpha * pq[ch * ps];
        const float rv = rq[ch * rs] - alpha * aq[ch * as];
        rq[ch * rs] = rv;
        const float z = prei[ch] * rv;
        aq[ch * as] = z;
        t += z * rv;
      }
      acc += t;
    }
    }
    acc = cta_total(acc, warp_part);
    // every thread is past this iteration's p·Ap wait
    if (threadIdx.x == 0 && more) bar_expect(bar_pap, box_bytes);
    send_partial(acc, rz_box[parity], bar_rz);
    bar_wait(bar_rz, parity);
    const float rz_new = mailbox_total(rz_box[parity], nrank);

    // p = z + βp; the new edge rows go to the neighbours
    const float beta = rz > 0.f ? rz_new / rz : 0.f;
    if constexpr (kPair) {
      for (int li = 2 * threadIdx.x; li < n; li += 2 * kThreads) {
        float pv0[3], pv1[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float* const pq = pp + ch * ps + li;
          const float2 z2 = ld2(app + ch * as + li), p2 = ld2(pq);
          pv0[ch] = z2.x + beta * p2.x;
          pv1[ch] = z2.y + beta * p2.y;
          st2(pq, pv0[ch], pv1[ch]);
        }
        if (more && (li < W || li >= n - W)) {
          push_edges(li, pv0);
          push_edges(li + 1, pv1);
        }
      }
    } else {
    for (int li = threadIdx.x; li < n; li += kThreads) {
      float* const pq = pp + li;
      const float* const aq = app + li;
      float pv[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        pv[ch] = aq[ch * as] + beta * pq[ch * ps];
        pq[ch * ps] = pv[ch];
      }
      if (more && (li < W || li >= n - W)) push_edges(li, pv);
    }
    }
    rz = rz_new;
  }

  if constexpr (kGroups >= 4) {
    __syncthreads();
    float* out = a.delta + pb3 + band;
    for (int li = threadIdx.x; li < n; li += kThreads)
      for (int ch = 0; ch < 3; ++ch)
        out[(size_t)ch * HW + li] = dp[ch * ds + li];
  }
  cl.sync();  // no CTA leaves while another may still address it
}

using Kernel = void (*)(PcgArgs);

template <bool kTall, bool kPair>
Kernel pick(int resident, int groups) {
  if (!resident) return pcg_cluster<kTall, 0, false, kPair>;
  switch (groups) {
    case 0: return pcg_cluster<kTall, 0, true, kPair>;
    case 1: return pcg_cluster<kTall, 1, true, kPair>;
    case 2: return pcg_cluster<kTall, 2, true, kPair>;
    case 3: return pcg_cluster<kTall, 3, true, kPair>;
    default: return pcg_cluster<kTall, 4, true, kPair>;
  }
}

// The kernel of a plan; pixel pairs where the rows have an even width.
Kernel pick_kernel(int tall, int resident, int groups, int W) {
  if (W % 2 == 0)
    return tall ? pick<true, true>(resident, groups)
                : pick<false, true>(resident, groups);
  return tall ? pick<true, false>(resident, groups)
              : pick<false, false>(resident, groups);
}

// The launch configuration of a plan; sets the kernel's attributes.
cudaError_t configure(Kernel kern, int B, int cluster, size_t smem,
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
int occupancy(Kernel kern, const cudaLaunchConfig_t& cfg) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(kern), &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

bool plan_ok(int H, int W, int cluster, int rows, int resident, int groups,
             int smem) {
  return H > 0 && W > 0 && cluster >= 1 && cluster <= kMaxCluster &&
         rows >= 1 && (long)(cluster - 1) * rows < H &&
         (long)cluster * rows >= H && groups >= 0 && groups <= 4 &&
         (resident || groups == 0) &&
         smem >= 0 && smem <= kSmemPerBlock &&
         plan_floats(rows, W, resident, groups) * sizeof(float) <=
             static_cast<size_t>(smem);
}

// ---- the three-pass yardstick: 1 + 3·iters launches a call --------------

constexpr int kPassThreads = 256;
// Blocks per problem: enough to fill the card at B = 1 (132 SMs, 2 blocks
// each) while keeping the partial-sum reduction short.
constexpr int kPassMaxBlocks = 264;

// Fixed-order block sum; every thread returns the total.
__device__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kPassThreads / 2; s > 0; s >>= 1) {
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
  for (int k = threadIdx.x; k < nblk; k += kPassThreads) v += part[k];
  return block_sum(v, sh);
}

__device__ __forceinline__ float load_or_zero(const float* a, int y, int x,
                                              int H, int W) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? a[y * W + x] : 0.f;
}

// r = b, p = z = pre·b, δ = 0; per-block partials of Σ r·z.
__global__ void __launch_bounds__(kPassThreads)
pcg_init(const float* __restrict__ b, const float* __restrict__ pre,
         float* __restrict__ delta, float* __restrict__ r,
         float* __restrict__ p, float* __restrict__ rz_part, int HW,
         int nblk) {
  __shared__ float sh[kPassThreads];
  const size_t base = (size_t)blockIdx.y * 3 * HW;
  float acc = 0.f;
  for (int i = blockIdx.x * kPassThreads + threadIdx.x; i < HW;
       i += nblk * kPassThreads) {
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

// Ap = JtJ·p (factored form); per-block partials of Σ p·Ap.
__global__ void __launch_bounds__(kPassThreads)
pcg_jtj(const float* __restrict__ p, const float* __restrict__ s,
        const float* __restrict__ c, const float* __restrict__ vm,
        const float* __restrict__ fit, const float* __restrict__ w,
        float* __restrict__ ap, float* __restrict__ pap_part, int H, int W,
        int nblk) {
  __shared__ float sh[kPassThreads];
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

  float acc = 0.f;
  for (int i = blockIdx.x * kPassThreads + threadIdx.x; i < HW;
       i += nblk * kPassThreads) {
    const int y = i / W;
    const int x = i - y * W;
    const float pc[3] = {px[i], py[i], pa[i]};
    float v[4], pj[3][4], sj[4], cj[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int yy = y + DY[k], xx = x + DX[k];
      v[k] = vb[(size_t)k * HW + i];
      pj[0][k] = load_or_zero(px, yy, xx, H, W);
      pj[1][k] = load_or_zero(py, yy, xx, H, W);
      pj[2][k] = load_or_zero(pa, yy, xx, H, W);
      sj[k] = load_or_zero(sb, yy, xx, H, W);
      cj[k] = load_or_zero(cb, yy, xx, H, W);
    }
    float api[3];
    jtj_pixel(pc, pj, sb[i], cb[i], sj, cj, v, fb[i], wf2, wr2, api);
    apx_out[i] = api[0];
    apx_out[HW + i] = api[1];
    apx_out[2 * HW + i] = api[2];
    acc += pc[0] * api[0] + pc[1] * api[1] + pc[2] * api[2];
  }
  const float total = block_sum(acc, sh);
  if (threadIdx.x == 0) pap_part[bi * nblk + blockIdx.x] = total;
}

// α from the Σ p·Ap and previous Σ r·z partials; δ += αp, r −= α·Ap;
// per-block partials of the new Σ z·r with z = pre·r.
__global__ void __launch_bounds__(kPassThreads)
pcg_update(const float* __restrict__ ap, const float* __restrict__ p,
           const float* __restrict__ pre, float* __restrict__ delta,
           float* __restrict__ r, const float* __restrict__ pap_part,
           const float* __restrict__ rz_old_part,
           float* __restrict__ rz_new_part, int HW, int nblk) {
  __shared__ float sh[kPassThreads];
  const int bi = blockIdx.y;
  const float pap = sum_partials(pap_part + bi * nblk, nblk, sh);
  const float rz = sum_partials(rz_old_part + bi * nblk, nblk, sh);
  const float alpha = pap > 0.f ? rz / pap : 0.f;
  const size_t base = (size_t)bi * 3 * HW;
  float acc = 0.f;
  for (int i = blockIdx.x * kPassThreads + threadIdx.x; i < HW;
       i += nblk * kPassThreads) {
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
__global__ void __launch_bounds__(kPassThreads)
pcg_direction(const float* __restrict__ r, const float* __restrict__ pre,
              float* __restrict__ p, const float* __restrict__ rz_old_part,
              const float* __restrict__ rz_new_part, int HW, int nblk) {
  __shared__ float sh[kPassThreads];
  const int bi = blockIdx.y;
  const float rz_old = sum_partials(rz_old_part + bi * nblk, nblk, sh);
  const float rz_new = sum_partials(rz_new_part + bi * nblk, nblk, sh);
  const float beta = rz_old > 0.f ? rz_new / rz_old : 0.f;
  const size_t base = (size_t)bi * 3 * HW;
  for (int i = blockIdx.x * kPassThreads + threadIdx.x; i < HW;
       i += nblk * kPassThreads) {
    for (int ch = 0; ch < 3; ++ch) {
      const size_t k = base + (size_t)ch * HW + i;
      const float z = pre[k] * r[k];
      p[k] = z + beta * p[k];
    }
  }
}

}  // namespace

extern "C" {

const char* pcg_error_string(int err) {
  if (err == kNoClusterFits)
    return "no cluster of this plan fits the device "
           "(cudaOccupancyMaxActiveClusters is 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Clusters of the plan that the current device holds at once (≥ 0), or
// −(cudaError_t).
int pcg_active_clusters(int B, int W, int cluster, int resident, int groups,
                        int smem_bytes, int tall, void* stream) {
  const Kernel kern = pick_kernel(tall, resident, groups, W);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err =
      configure(kern, B, cluster, static_cast<size_t>(smem_bytes),
                static_cast<cudaStream_t>(stream), &cfg, &attr);
  return err == cudaSuccess ? occupancy(kern, cfg) : -static_cast<int>(err);
}

// δ (B,3,H,W) after `iters` PCG iterations, one cluster launch. b, pre
// (B,3,H,W); s, c, fit (B,H,W); vm (B,4,H,W); w (B,2) = (wf2, wr2). r, p, ap
// (B,3,H,W) are scratch, needed only where the plan keeps that plane in
// device memory (r when groups < 2, ap when groups < 3, p when not
// resident; otherwise may be null). All float32, contiguous, on the
// stream's device. The plan (cluster, rows, resident, groups, smem_bytes)
// is ops/pcg.py::pcg_plan's; `tall` != 0 reads p in the stacked (3H, W)
// layout. Enqueues one launch on `stream` without synchronising; returns
// the cudaError_t of the launch (0 = success), cudaErrorInvalidValue for a
// plan that does not cover the problem, or kNoClusterFits.
int pcg_fixed_f32(const float* b, const float* pre, const float* s,
                  const float* c, const float* vm, const float* fit,
                  const float* w, float* delta, float* r, float* p, float* ap,
                  int B, int H, int W, int iters, int tall, int cluster,
                  int rows, int resident, int groups, int smem_bytes,
                  void* stream) {
  if (B <= 0) return 0;
  if (!plan_ok(H, W, cluster, rows, resident, groups, smem_bytes) ||
      iters < 0 || (groups < 2 && !r) || (groups < 3 && !ap) ||
      (!resident && !p))
    return static_cast<int>(cudaErrorInvalidValue);
  const PcgArgs a{b, pre, s, c, vm, fit, w, delta, r, p, ap,
                  H, W, rows, iters};
  const Kernel kern = pick_kernel(tall, resident, groups, W);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kern, B, cluster, static_cast<size_t>(smem_bytes),
                              static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int active = occupancy(kern, cfg);
  if (active < 0) return -active;
  if (active == 0) return kNoClusterFits;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks per problem of the three-pass form; its partial-sum scratch holds
// 3·B·pcg_three_pass_nblk(H, W) floats.
int pcg_three_pass_nblk(int H, int W) {
  const int need = (H * W + kPassThreads - 1) / kPassThreads;
  return need < kPassMaxBlocks ? need : kPassMaxBlocks;
}

// The three-pass yardstick (standard layout): the arguments of
// pcg_fixed_f32 with r, p, ap required and part (3,B,nblk) as scratch.
// Enqueues 1 + 3·iters kernels on `stream`.
int pcg_three_pass_f32(const float* b, const float* pre, const float* s,
                       const float* c, const float* vm, const float* fit,
                       const float* w, float* delta, float* r, float* p,
                       float* ap, float* part, int B, int H, int W, int iters,
                       void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const int nblk = pcg_three_pass_nblk(H, W);
  const dim3 grid(nblk, B);
  float* pap_part = part;
  float* rz_part[2] = {part + (size_t)B * nblk, part + (size_t)2 * B * nblk};

  // the init partials stand in for "iteration −1", slot 1
  pcg_init<<<grid, kPassThreads, 0, st>>>(b, pre, delta, r, p, rz_part[1],
                                          HW, nblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int it = 0; it < iters; ++it) {
    float* rz_new = rz_part[it & 1];
    const float* rz_old = rz_part[(it + 1) & 1];
    pcg_jtj<<<grid, kPassThreads, 0, st>>>(p, s, c, vm, fit, w, ap, pap_part,
                                           H, W, nblk);
    pcg_update<<<grid, kPassThreads, 0, st>>>(ap, p, pre, delta, r, pap_part,
                                              rz_old, rz_new, HW, nblk);
    pcg_direction<<<grid, kPassThreads, 0, st>>>(r, pre, p, rz_old, rz_new,
                                                 HW, nblk);
    if (it == 0) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
