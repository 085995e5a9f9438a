// Fixed-count Jacobi-PCG for the ARAP Gauss-Newton system JtJ·δ = b, as one
// launch per call: a thread-block cluster a problem, or the whole card a
// problem (the spread plan).
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
// Layout of the cluster plans (pcg_cluster). The grid is (cluster, B) with
// cluster dims (cluster, 1, 1): one cluster of up to 16 CTAs per problem,
// all `iters` iterations inside one launch. CTA `rank` owns the rows
// [rank·rows, (rank + 1)·rows) of its problem, and thread t the band's
// pixels t, t + 512, ... for the whole call, so a pixel's own r, δ and Ap
// are only ever touched by one thread. Where W is even (every crop bucket
// and the 854-wide frame) a thread takes pixel pairs instead, 2t,
// 2t + 1024, ... and their right neighbours: each plane's pair is one
// 8-byte load, and the pair shares its inner neighbours, which cuts the
// loads and address arithmetic a pixel. Problems are independent:
// clusters never wait for each other, and a batch larger than the card
// runs in waves. The host picks the plan (ops/pcg.py::kernel_plan: the
// largest cluster of which the card holds the whole batch at once, by
// pcg_active_clusters, else the fewest waves); the entry checks it against
// the card with cudaOccupancyMaxActiveClusters and refuses a plan of which
// no cluster fits.
//
// Memory plans. Only p is read across threads (its 4 neighbours); every
// other mutable plane is private to its pixel's thread.
//   * resident (pcg_cluster, where p fits 16 CTAs: every crop bucket): the
//     CTA's rows of p (3 planes) live in shared memory, each plane's band
//     between its two halo rows, pushed by the CTAs that own them, so a
//     neighbour load is one shared-memory load at a fixed offset. Then, in
//     this order and as far as the 227 KB a block can use allows, the CTA's
//     rows of s and c with one halo row on each side (read once from device
//     memory), r, Ap and δ. What does not fit stays in device memory, as do
//     the loop-invariant pre, vm, fit and b, which stay L2-resident across
//     the call. Which planes are in shared memory is a template parameter,
//     so that every access has its own address space.
//   * spread (pcg_cluster_spread, where p does not fit 16 CTAs but a
//     problem's state fits the card's shared memory: the 480×854 and
//     436×1024 frames, the 512×896 bucket): one cooperative launch of one
//     CTA an SM, each owning a band of every problem's pixels; the problems
//     run one after another, and all of a problem's mutable state stays on
//     chip. See the kernel.
//   * streamed (pcg_cluster with kResident false, what is larger still): p,
//     r, Ap and δ in device memory, each read and written only by the CTA
//     that owns the pixel (a CTA barrier orders them), and only the halo
//     rows in shared memory.
//
// Synchronisation of a cluster without cluster barriers. A cluster barrier
// with the release/acquire that shared data needs costs a GPU-scope fence
// and an L1 invalidate, ~0.75 µs for 16 CTAs on an H100
// (tools/cluster_sync_bench.cu), three times an iteration. Instead a CTA
// pushes what others read into their shared memory with st.async, which
// completes bytes on the receiver's mbarrier, and waits only on its own
// mbarriers:
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
// What bounds it. The resident plans: per-SM instruction issue, and L2
// latency wherever planes stay in device memory, on at most 16 of the 132
// SMs a problem; a small batch leaves most of the card idle. The spread
// plan: per iteration two handshakes across the card (≈ 1.5 µs each,
// 2.4 µs with the fences that the edges of z need), and each SM's shared
// memory bandwidth (≈ 424 B a pixel pair an iteration). The streamed plan:
// device-memory bandwidth, as each iteration moves a wave's p, r, Ap and δ
// (≈ 136 B a pixel) through HBM once the wave's state outgrows the 50 MB
// L2.
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

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

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

// ---- the spread plan: one problem over the whole card ----------------------

constexpr int kMaxSpread = 256;  // CTAs of a spread launch at most
// An entry's return code when the card cannot hold a spread launch's CTAs
// at once
constexpr int kSpreadTooLarge = -2;

struct SpreadArgs {
  const float* b;
  const float* pre;
  const float* s;
  const float* c;
  const float* vm;
  const float* fit;
  const float* w;
  float* delta;
  float* edge;  // (2, CTAs, 2, 3, W): each CTA's z at its first and last W
                // pixels, two buffers used in turn
  int B, H, W, px, iters;
};

// The device's handshake words of spread launches: [0] the epoch of the
// latest launch's last phase, then two arrays of one slot a CTA, by the
// parity of the phase's epoch. A slot holds (epoch << 32) | the bits of the
// CTA's partial sum, written at once, so a reader that sees the epoch sees
// the value. A launch reads the base epoch its predecessor left, so nothing
// is reset between calls and a captured launch replays as it ran; hence two
// spread launches on one device must never overlap (one stream, or streams
// ordered by events: ops/pcg.py says so to its callers).
__device__ unsigned long long g_spread_sync[1 + 2 * kMaxSpread];

__device__ __forceinline__ void st_relaxed(unsigned long long* q,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(q), "l"(v)
               : "memory");
}
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* q) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(q) : "memory");
  return v;
}
__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

constexpr int kPoll = kMaxSpread / 32;  // slots a lane of warp 0 reads

// Σ over the launch's CTAs of each CTA's total of v, for the phase of
// epoch `e`. The CTA's total goes to its slot; warp 0 then reads every slot
// of the phase, each lane its slots all at once and again until each holds
// epoch e, and sums them in a fixed order (lane l: slots l, l + 32, ...,
// then the warp's tree), so every CTA gets the same total with no atomics.
// With `publish`, what this CTA's threads wrote to device memory before
// the call (the edges of z) is visible to every CTA once it returns: a
// release fence before the slot, an acquire fence after the reads. Ends
// with every thread past a CTA barrier.
__device__ float grid_total(float v, float* warp_part, float* total,
                            unsigned e, int rank, int nctas, bool publish) {
  v = cta_total(v, warp_part);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned long long* slots = g_spread_sync + 1 + (e & 1) * kMaxSpread;
    if (lane == 0) {
      if (publish) fence_gpu();
      st_relaxed(slots + rank, (static_cast<unsigned long long>(e) << 32) |
                                   __float_as_uint(v));
    }
    unsigned long long got[kPoll];
    unsigned have = 0;  // bit i: slot lane + 32i read at epoch e
    unsigned want = 0;
#pragma unroll
    for (int i = 0; i < kPoll; ++i)
      if (lane + 32 * i < nctas) want |= 1u << i;
    const long long t0 = clock64();
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
      if (clock64() - t0 > kWaitLimit) __trap();
    }
    if (publish) fence_gpu();
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kPoll; ++i)
      if (want >> i & 1u) acc += __uint_as_float(static_cast<unsigned>(got[i]));
    acc = warp_sum(acc);
    if (lane == 0) *total = acc;
  }
  __syncthreads();
  return *total;
}

// The spread plan: the launch's CTAs split one problem's H·W pixels into
// bands of `px` (the last may be shorter, never under W), and run the B
// problems of the call one after another. A band's state stays in its
// CTA's shared memory, each plane at its pixels' linear index: p (3 planes)
// and s, c, each between W pixels before and W after the band (the halos:
// the neighbours in the rows above and below, and in the same row at the
// band's ends), then r, Ap (z after the update) and δ. Thread t owns the
// band's pixels t, t + 512, ... (pixel pairs 2t, 2t + 1024, ... with
// kPair), so only p and s, c are read across threads. Where a band's
// direction and fit masks are all exactly 0 or 1, as the energy makes
// them, its threads keep them as bits in a register, 5 a pixel (a band
// that fits the shared memory has under 4200 pixels: at most 50 bits a
// thread); else they are read from L2 every iteration, as pre is. Nothing
// mutable goes to device memory but δ at the end of a problem and the
// edges of z, below.
//
// Two phases an iteration (grid_total): Σ p·Ap, and Σ r·z. Before the
// second, each CTA also writes z at its first and last W pixels to `edge`;
// after it, each CTA updates its halos of p itself, p = z + β·p with the
// neighbour's z, in the same fused multiply-add the owner uses, so the
// halos stay bitwise the owner's p. A phase's slots alternate by parity:
// a CTA writes the phase after next only after every CTA has written the
// next, which each does after reading this one. The edges alternate
// between two buffers, so that a CTA overwrites the ones its neighbours
// read only after their next Σ r·z phase, whose release fence follows
// the reads. The last iteration skips the second phase.
template <bool kTall, bool kPair>
__global__ void __launch_bounds__(kThreads, 1)
    pcg_cluster_spread(SpreadArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ float warp_part[kWarps];
  __shared__ float total;
  constexpr int kPx = kPair ? 2 : 1;  // pixels a step of a thread
  constexpr int kStep = kPx * kThreads;
  const int rank = blockIdx.x, nctas = gridDim.x, last = nctas - 1;
  const int H = a.H, W = a.W, HW = H * W, P = a.px;
  const int g0 = rank * P;             // the band's first pixel
  const int n = min(HW, g0 + P) - g0;  // its pixels
  const int tid = threadIdx.x;
  const int li0 = kPx * tid;           // a thread's first pixel
  const int x0 = (g0 + li0) % W;       // its column
  const int col_step = kStep % W;      // a step's move along the row

  // shared memory: p's 3 planes, s and c, each P + 2W floats with the band
  // at offset W; then r, Ap and δ, 3 planes of P each
  float* const sm = reinterpret_cast<float*>(smem4);
  const int ps = P + 2 * W;
  float* const pp = sm + W;
  float* const sp = pp + 3 * ps;
  float* const cp = sp + ps;
  float* const rp = sm + 5 * ps;
  float* const app = rp + 3 * P;
  float* const dp = app + 3 * P;

  // z at this CTA's first and last W pixels, and where its halos come from:
  // the CTA before (its last W pixels) and after (its first W). Tall layout
  // (the stacked (3H, W) plane): above plane ch's row 0 is plane ch − 1's
  // row H − 1 (the last CTA's tail), below plane ch's row H − 1 is plane
  // ch + 1's row 0 (CTA 0's head); the sources are offset by a plane so
  // that plane ch reads ch ∓ 1. Offsets into a buffer; the two buffers lie
  // `ebuf` floats apart.
  const size_t e3 = 3 * static_cast<size_t>(W);
  const size_t ebuf = 2 * static_cast<size_t>(nctas) * e3;
  const size_t head = 2 * rank * e3, tail = head + e3;
  const size_t from_up =
      rank > 0 ? (2 * rank - 1) * e3 : (2 * last + 1) * e3 - W;
  const size_t from_dn = rank < last ? 2 * (rank + 1) * e3 : W;
  int ephase = 0;  // the launch's phases with edges so far

  unsigned e = static_cast<unsigned>(ld_relaxed(g_spread_sync));

  for (int bi = 0; bi < a.B; ++bi) {
    const size_t o1 = static_cast<size_t>(bi) * HW, o3 = 3 * o1;
    const float* const bb = a.b + o3 + g0;
    const float* const preg = a.pre + o3 + g0;
    const float* const vb = a.vm + 4 * o1 + g0;
    const float* const fb = a.fit + o1 + g0;
    float* const out = a.delta + o3 + g0;
    const float wf2 = a.w[2 * bi];
    const float wr2 = a.w[2 * bi + 1];
    if (a.iters == 0) {
      for (int ch = 0; ch < 3; ++ch)
        for (int k = tid; k < n; k += kThreads) out[ch * HW + k] = 0.f;
      continue;
    }
    __syncthreads();  // the last problem's reads of shared memory are done

    // s and c over the band and its halos, 0 outside the image
    for (int k = tid; k < n + 2 * W; k += kThreads) {
      const int g = g0 - W + k;
      const bool in = g >= 0 && g < HW;
      sp[k - W] = in ? __ldg(a.s + o1 + g) : 0.f;
      cp[k - W] = in ? __ldg(a.c + o1 + g) : 0.f;
    }
    // the masks of the thread's pixels as bits, step by step (vm0..vm3,
    // fit), where the whole band's are 0.0f or 1.0f
    unsigned long long mbits = 0;
    bool binary = true;
    for (int li = li0, sh = 0; li < n; li += kStep, sh += 5 * kPx)
#pragma unroll
      for (int m = 0; m < kPx; ++m)
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const float f = __ldg(k < 4 ? vb + k * HW + li + m : fb + li + m);
          binary = binary && (__float_as_uint(f) == 0u ||
                              __float_as_uint(f) == 0x3f800000u);
          mbits |= static_cast<unsigned long long>(f != 0.f)
                   << (sh + 5 * m + k);
        }
    binary = __syncthreads_and(binary);
    // p's halos: z = pre·b of the pixels they hold (0 outside the image;
    // the other planes' rows in the tall layout)
    for (int side = 0; side < 2; ++side)
      for (int ch = 0; ch < 3; ++ch)
        for (int x = tid; x < W; x += kThreads) {
          int g = side == 0 ? g0 - W + x : g0 + n + x, sc = ch;
          if (g < 0) {
            sc = kTall ? ch - 1 : -1;
            g += HW;
          } else if (g >= HW) {
            sc = kTall && ch < 2 ? ch + 1 : -1;
            g -= HW;
          }
          float v = 0.f;
          if (sc >= 0) {
            const size_t q = o3 + static_cast<size_t>(sc) * HW + g;
            v = __ldg(a.pre + q) * __ldg(a.b + q);
          }
          pp[ch * ps + (side == 0 ? x - W : n + x)] = v;
        }
    // r = b, p = z = pre·b, δ = 0 and Σ r·z over the band
    float acc = 0.f;
    for (int li = li0; li < n; li += kStep) {
      float t[kPx] = {};
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
#pragma unroll
        for (int m = 0; m < kPx; ++m) {
          const float rv = __ldg(bb + ch * HW + li + m);
          const float z = __ldg(preg + ch * HW + li + m) * rv;
          rp[ch * P + li + m] = rv;
          pp[ch * ps + li + m] = z;
          dp[ch * P + li + m] = 0.f;
          t[m] += rv * z;
        }
#pragma unroll
      for (int m = 0; m < kPx; ++m) acc += t[m];
    }
    float rz = grid_total(acc, warp_part, &total, ++e, rank, nctas, false);

    for (int it = 0; it < a.iters; ++it) {
      const bool more = it + 1 < a.iters;
      __syncthreads();  // the band's p and its halos of this iteration

      // Ap = JtJ·p (factored form) and Σ p·Ap
      acc = 0.f;
      int x = x0;
      unsigned long long mb = mbits;
#pragma unroll 1
      for (int li = li0; li < n; li += kStep) {
        float v[kPx][4], fit[kPx];
#pragma unroll
        for (int m = 0; m < kPx; ++m) {
          if (binary) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              v[m][k] = (mb >> (5 * m + k)) & 1ull ? 1.f : 0.f;
            fit[m] = (mb >> (5 * m + 4)) & 1ull ? 1.f : 0.f;
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) v[m][k] = __ldg(vb + k * HW + li + m);
            fit[m] = __ldg(fb + li + m);
          }
        }
        mb >>= 5 * kPx;
        const bool okl = x > 0, okr = x + kPx < W;
        float ap[kPx][3];
        if constexpr (kPair) {
          // pixels (x, x + 1): the outer neighbours x − 1 and x + 2 are
          // guarded, the inner ones are each other
          float pc[2][3], pj[2][3][4];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float* const q = pp + ch * ps + li;
            const float2 c2 = ld2(q), d2 = ld2(q + W), u2 = ld2(q - W);
            const float l = okl ? q[-1] : 0.f, r = okr ? q[2] : 0.f;
            pc[0][ch] = c2.x;
            pc[1][ch] = c2.y;
            pj[0][ch][0] = c2.y; pj[0][ch][1] = l;
            pj[0][ch][2] = d2.x; pj[0][ch][3] = u2.x;
            pj[1][ch][0] = r; pj[1][ch][1] = c2.x;
            pj[1][ch][2] = d2.y; pj[1][ch][3] = u2.y;
          }
          float si[2], ci[2], sj[2][4], cj[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float* const q = (m == 0 ? sp : cp) + li;
            const float2 c2 = ld2(q), d2 = ld2(q + W), u2 = ld2(q - W);
            const float l = okl ? q[-1] : 0.f, r = okr ? q[2] : 0.f;
            float(&cen)[2] = m == 0 ? si : ci;
            float(&nb)[2][4] = m == 0 ? sj : cj;
            cen[0] = c2.x; cen[1] = c2.y;
            nb[0][0] = c2.y; nb[0][1] = l; nb[0][2] = d2.x; nb[0][3] = u2.x;
            nb[1][0] = r; nb[1][1] = c2.x; nb[1][2] = d2.y; nb[1][3] = u2.y;
          }
          jtj_pixel(pc[0], pj[0], si[0], ci[0], sj[0], cj[0], v[0], fit[0],
                    wf2, wr2, ap[0]);
          jtj_pixel(pc[1], pj[1], si[1], ci[1], sj[1], cj[1], v[kPx - 1],
                    fit[kPx - 1], wf2, wr2, ap[kPx - 1]);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            st2(app + ch * P + li, ap[0][ch], ap[kPx - 1][ch]);
          acc += pc[0][0] * ap[0][0] + pc[0][1] * ap[0][1] +
                 pc[0][2] * ap[0][2];
          acc += pc[1][0] * ap[kPx - 1][0] + pc[1][1] * ap[kPx - 1][1] +
                 pc[1][2] * ap[kPx - 1][2];
        } else {
          float pc[3], pj[3][4];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float* const q = pp + ch * ps + li;
            pc[ch] = q[0];
            pj[ch][0] = okr ? q[1] : 0.f;
            pj[ch][1] = okl ? q[-1] : 0.f;
            pj[ch][2] = q[W];
            pj[ch][3] = q[-W];
          }
          const float* const sq = sp + li;
          const float* const cq = cp + li;
          const float sj[4] = {okr ? sq[1] : 0.f, okl ? sq[-1] : 0.f, sq[W],
                               sq[-W]};
          const float cj[4] = {okr ? cq[1] : 0.f, okl ? cq[-1] : 0.f, cq[W],
                               cq[-W]};
          jtj_pixel(pc, pj, sq[0], cq[0], sj, cj, v[0], fit[0], wf2, wr2,
                    ap[0]);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) app[ch * P + li] = ap[0][ch];
          acc += pc[0] * ap[0][0] + pc[1] * ap[0][1] + pc[2] * ap[0][2];
        }
        x += col_step;
        if (x >= W) x -= W;
      }
      const float pap =
          grid_total(acc, warp_part, &total, ++e, rank, nctas, false);

      // δ += αp (into `out` on the last iteration), r −= α·Ap, z = pre·r
      // in Ap's place, Σ z·r; z at the band's first and last W pixels to
      // `edge`. pre is loaded one step ahead.
      const float alpha = pap > 0.f ? rz / pap : 0.f;
      acc = 0.f;
      float npre[3][kPx] = {};
      auto load_pre = [&](int li) {
        if (li >= n) return;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          if constexpr (kPair) {
            const float2 p2 = ldg2(preg + ch * HW + li);
            npre[ch][0] = p2.x;
            npre[ch][kPx - 1] = p2.y;
          } else {
            npre[ch][0] = __ldg(preg + ch * HW + li);
          }
        }
      };
      load_pre(li0);
#pragma unroll 1
      for (int li = li0; li < n; li += kStep) {
        float prv[3][kPx];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
#pragma unroll
          for (int m = 0; m < kPx; ++m) prv[ch][m] = npre[ch][m];
        load_pre(li + kStep);
        float t[kPx] = {};
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float pv[kPx], dv[kPx], rv[kPx], av[kPx];
          if constexpr (kPair) {
            const float2 p2 = ld2(pp + ch * ps + li);
            const float2 d2 = ld2(dp + ch * P + li);
            const float2 r2 = ld2(rp + ch * P + li);
            const float2 a2 = ld2(app + ch * P + li);
            pv[0] = p2.x; pv[kPx - 1] = p2.y;
            dv[0] = d2.x; dv[kPx - 1] = d2.y;
            rv[0] = r2.x; rv[kPx - 1] = r2.y;
            av[0] = a2.x; av[kPx - 1] = a2.y;
          } else {
            pv[0] = pp[ch * ps + li];
            dv[0] = dp[ch * P + li];
            rv[0] = rp[ch * P + li];
            av[0] = app[ch * P + li];
          }
          float zv[kPx];
#pragma unroll
          for (int m = 0; m < kPx; ++m) {
            dv[m] = dv[m] + alpha * pv[m];
            rv[m] = rv[m] - alpha * av[m];
            zv[m] = prv[ch][m] * rv[m];
            t[m] += zv[m] * rv[m];
          }
          if constexpr (kPair) {
            st2(more ? dp + ch * P + li : out + ch * HW + li, dv[0],
                dv[kPx - 1]);
            st2(rp + ch * P + li, rv[0], rv[kPx - 1]);
            st2(app + ch * P + li, zv[0], zv[kPx - 1]);
          } else {
            (more ? dp[ch * P + li] : out[ch * HW + li]) = dv[0];
            rp[ch * P + li] = rv[0];
            app[ch * P + li] = zv[0];
          }
          if (more) {
            float* const eb = a.edge + (ephase & 1) * ebuf + ch * W;
#pragma unroll
            for (int m = 0; m < kPx; ++m) {
              if (li < W) __stcg(eb + head + li + m, zv[m]);
              if (li >= n - W) __stcg(eb + tail + li + m - (n - W), zv[m]);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < kPx; ++m) acc += t[m];
      }
      if (!more) break;
      const float rz_new =
          grid_total(acc, warp_part, &total, ++e, rank, nctas, true);

      // p = z + βp over the band, and over the halos from the neighbours'
      // z. The halos' loads of a round are issued together, the first
      // round's before the band, so that they wait on L2 behind its work.
      const float beta = rz > 0.f ? rz_new / rz : 0.f;
      float zu[3][2], zd[3][2];
      const float* const eb = a.edge + (ephase++ & 1) * ebuf;
      auto load_halo = [&](int xb) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int x = xb + m * kThreads;
            const bool up = rank > 0 || (kTall && ch > 0);
            const bool dn = rank < last || (kTall && ch < 2);
            zu[ch][m] = up && x < W ? __ldcg(eb + from_up + ch * W + x) : 0.f;
            zd[ch][m] = dn && x < W ? __ldcg(eb + from_dn + ch * W + x) : 0.f;
          }
      };
      load_halo(tid);
#pragma unroll 1
      for (int li = li0; li < n; li += kStep) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float* const q = pp + ch * ps + li;
          const float* const z = app + ch * P + li;
          if constexpr (kPair) {
            const float2 p2 = ld2(q), z2 = ld2(z);
            st2(q, __fmaf_rn(beta, p2.x, z2.x), __fmaf_rn(beta, p2.y, z2.y));
          } else {
            q[0] = __fmaf_rn(beta, q[0], z[0]);
          }
        }
      }
      for (int xb = tid; xb < W; xb += 2 * kThreads) {
        if (xb != tid) load_halo(xb);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int x = xb + m * kThreads;
            const bool up = rank > 0 || (kTall && ch > 0);
            const bool dn = rank < last || (kTall && ch < 2);
            float* const qu = pp + ch * ps - W + x;
            float* const qd = pp + ch * ps + n + x;
            if (up && x < W) *qu = __fmaf_rn(beta, *qu, zu[ch][m]);
            if (dn && x < W) *qd = __fmaf_rn(beta, *qd, zd[ch][m]);
          }
      }
      rz = rz_new;
    }
  }

  // Every slot of this launch's phases holds an epoch ≤ e. The slots of CTAs
  // it did not run get e too, so that no slot is older than one launch.
  if (tid == 0) {
    for (int k = rank + nctas; k < kMaxSpread; k += nctas) {
      g_spread_sync[1 + k] = static_cast<unsigned long long>(e) << 32;
      g_spread_sync[1 + kMaxSpread + k] =
          static_cast<unsigned long long>(e) << 32;
    }
    if (rank == 0) g_spread_sync[0] = e;
  }
}

using Kernel = void (*)(PcgArgs);
using SpreadKernel = void (*)(SpreadArgs);

// The spread kernel of a plan: pixel pairs where the rows have an even
// width.
SpreadKernel pick_spread_kernel(int tall, int W) {
  if (W % 2 == 0)
    return tall ? pcg_cluster_spread<true, true>
                : pcg_cluster_spread<false, true>;
  return tall ? pcg_cluster_spread<true, false>
              : pcg_cluster_spread<false, false>;
}

// Dynamic shared-memory floats of a spread plan: p, s and c with W-pixel
// halos, r, Ap and δ.
size_t spread_floats(int px, int W) {
  return 5 * ((size_t)px + 2 * (size_t)W) + 9 * (size_t)px;
}

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

}  // namespace

extern "C" {

const char* pcg_error_string(int err) {
  if (err == kNoClusterFits)
    return "no cluster of this plan fits the device "
           "(cudaOccupancyMaxActiveClusters is 0)";
  if (err == kSpreadTooLarge)
    return "the device cannot hold every CTA of this spread plan at once";
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

// CTAs of the spread kernel (width W, `smem_bytes` of dynamic shared
// memory) that the current device holds at once (≥ 0), or −(cudaError_t):
// the occupancy API's blocks an SM times the SMs.
int pcg_spread_ctas(int W, int smem_bytes, int tall) {
  const SpreadKernel kern = pick_spread_kernel(tall, W);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(kern), kThreads,
      static_cast<size_t>(smem_bytes));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// δ (B,3,H,W) after `iters` PCG iterations in the spread plan: one
// cooperative launch of `ctas` CTAs, each owning `px` pixels of every
// problem (ops/pcg.py::spread_plan), the problems one after another. The
// operands are pcg_fixed_f32's; `edge` (2, ctas, 2, 3, W) float32 is
// scratch.
// Launches on one device must be stream-ordered (they share the device's
// handshake words). Returns the cudaError_t of the launch (0 = success),
// cudaErrorInvalidValue for a plan that does not cover the problem, or
// kSpreadTooLarge.
int pcg_spread_f32(const float* b, const float* pre, const float* s,
                   const float* c, const float* vm, const float* fit,
                   const float* w, float* delta, float* edge, int B, int H,
                   int W, int iters, int tall, int ctas, int px,
                   int smem_bytes, void* stream) {
  if (B <= 0) return 0;
  const long HW = (long)H * W;
  const bool ok =
      H > 0 && W > 0 && px >= W && (W % 2 != 0 || px % 2 == 0) &&
      ctas >= 1 && ctas <= kMaxSpread && (long)(ctas - 1) * px < HW &&
      (long)ctas * px >= HW && HW - (long)(ctas - 1) * px >= W &&
      smem_bytes >= 0 && smem_bytes <= kSmemPerBlock &&
      spread_floats(px, W) * sizeof(float) <=
          static_cast<size_t>(smem_bytes) &&
      iters >= 0 && 2L * B * iters < (1L << 30) && edge != nullptr;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int fits = pcg_spread_ctas(W, smem_bytes, tall);
  if (fits < 0) return -fits;
  if (fits < ctas) return kSpreadTooLarge;
  const SpreadArgs a{b, pre, s, c, vm, fit, w, delta, edge,
                     B, H, W, px, iters};
  const SpreadKernel kern = pick_spread_kernel(tall, W);
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;  // every CTA resident at once
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
