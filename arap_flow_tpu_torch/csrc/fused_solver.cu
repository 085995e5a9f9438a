// The whole annealed ARAP schedule (num_anneal constraint steps × gn_iters
// Gauss-Newton linearisations × pcg_iters Jacobi-PCG iterations) as ONE
// thread-block-cluster launch per call.
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
// Layout (pcg.cu's). The grid is (cluster, B) with cluster dims (cluster, 1,
// 1): one cluster of up to 16 CTAs per problem runs the whole schedule.
// CTA `rank` owns the rows [rank·rows, (rank + 1)·rows) of its problem, and
// thread t the band's pixels t, t + 512, ... for the whole solve. Problems
// are independent: no cluster waits for another, and a batch larger than
// the card runs in waves. The host picks the plan (ops/fused_solver.py::
// fused_plan: pcg_plan's rule over this kernel's own shared-memory groups,
// with the active clusters from fused_active_clusters); the entry checks it
// against the card and refuses a plan of which no cluster fits.
//
// Memory plans. Each CTA keeps p's row above and below its band (its halo
// rows) in shared memory, pushed by the CTAs that own them.
//   * resident: p's band lives in shared memory between its halo rows; then,
//     in this order and as far as the 227 KB a block can use allows, s and c
//     with halo rows, r, Ap, δ, and x with halo rows. What does not fit
//     stays in device memory, as does everything loop-invariant (vm, fit,
//     csrc, ctgt, grid, and pre, computed once at the start into 2 device
//     planes). Which planes are in shared memory is a template parameter.
//   * streamed, for shapes whose p does not fit 16 CTAs (480×854, 512×896):
//     every state plane in device memory, only p's halo rows in shared
//     memory.
//
// Synchronisation. Inside a GN step's PCG loop, pcg.cu's scheme as it is:
// the p·Ap and r·z partials go by st.async into every CTA's mailbox slot
// `rank` (the r·z mailbox double-buffered by parity), each CTA sums the
// slots in rank order (no atomics, bitwise repeatable), and p's new edge
// rows are pushed into the neighbours' halo rows; no cluster barrier. Each
// of the three mbarriers completes one phase per PCG iteration, so one
// counter of the iterations run so far in the whole solve gives every wait
// its parity. At the GN-step boundary two plain cluster barriers:
//   1. x += δ, s and c on the thread's own pixels;
//   2. cl.sync();
//   3. the neighbours' edge rows of s, c, x and y copied from their shared
//      memory into this CTA's halo rows (where those planes are in shared
//      memory); JtF; r, p = pre·r, δ = 0 and the rz partial;
//   4. cl.sync(); the rz sum from every CTA's slot, in rank order; the
//      mbarriers' expects and the first push of p's edge rows.
// The last PCG iteration of a GN step pushes nothing and expects nothing,
// as in pcg.cu, and step 4 starts the next step's phases afresh, so the
// expects and pushes match across GN steps.
//
// Borders: every neighbour load reads 0 outside the image (the TPU kernel's
// rolls wrap, and the zero direction masks kill the wrapped values): a
// guard on the image, and p's halo rows that no CTA pushes stay 0.
// sin/cos are the precise sinf/cosf (no fast math).
//
// What bounds it on this card. Arithmetic: the schedule needs ~95 float32
// operations a pixel and PCG iteration (the factored JtJ of pcg.cu, its
// loop-constant planes once a GN step), so a 19×8×400 solve of a 192×384
// problem is ~4.3·10^11 operations, ~6.4 ms at the 67 TFLOP/s float32 peak
// of the whole card; this kernel does ~132 (the unfactored JtJ keeps no
// loop-constant planes and reads the neighbours' s and c) on at most 16 of
// the 132 SMs a problem. Its bytes (14 planes in and out once) are
// negligible. In practice per-SM instruction issue and, where planes stay
// in device memory, L2 latency bound it, as they bound pcg.cu.

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxGroups = 5;  // s and c, r, Ap, δ, x

struct FusedArgs {
  // inputs, read-only for the kernel's lifetime
  const float* vm;    // (B, 4, H, W) direction masks
  const float* fit;   // (B, H, W) fit mask
  const float* csrc;  // (B, 2, H, W) constraint source positions
  const float* ctgt;  // (B, 2, H, W) constraint target positions
  const float* grid;  // (B, 2, H, W) rest positions
  const float* w;     // (B, 2) = (wf2, wr2)
  // written inside the kernel: plain loads only, never the read-only path
  float* x;      // (B, 3, H, W) the result; the state where x is not in
                 // shared memory
  float* pre;    // (B, 2, H, W) pre_o, pre_a
  float* sc;     // (B, 2, H, W) s, c when not in shared memory
  float* r;      // (B, 3, H, W) when r is not in shared memory
  float* p;      // (B, 3, H, W) in the streamed plan
  float* ap;     // (B, 3, H, W) when Ap is not in shared memory
  float* delta;  // (B, 3, H, W) when δ is not in shared memory
  int H, W, rows, num_anneal, gn_iters, pcg_iters;
};

// Dynamic shared-memory floats of a plan: p's halo rows above and below the
// band (3 planes each), p's band (resident only), then the groups in order:
// s and c with halo rows, r, Ap, δ, x with halo rows.
size_t plan_floats(int rows, int W, int resident, int groups) {
  const size_t band = (size_t)rows * W, halo = band + 2 * (size_t)W;
  size_t n = 6 * (size_t)W + (resident ? 3 * band : 0);
  if (groups >= 1) n += 2 * halo;
  for (int g = 2; g <= groups && g <= 4; ++g) n += 3 * band;
  if (groups >= 5) n += 3 * halo;
  return n;
}

// t_dir sign-folded for a unit direction: (tx, ty) per DIRS entry
// ((0, 1), (0, −1), (1, 0), (−1, 0) as (dy, dx)): (−s, c), (s, −c),
// (−c, −s), (c, s)
__device__ __forceinline__ void t_fold(int k, float s, float c, float& tx,
                                       float& ty) {
  tx = k == 0 ? -s : k == 1 ? s : k == 2 ? -c : c;
  ty = k == 0 ? c : k == 1 ? -c : k == 2 ? -s : s;
}

// DIRS as offsets in a plane of width W; constant after unrolling
__device__ __forceinline__ int dir_off(int k, int W) {
  return k == 0 ? 1 : k == 1 ? -1 : k == 2 ? W : -W;
}

// The rest-offset rotation terms of a direction: (dx·c − dy·s, dx·s + dy·c)
// per DIRS entry (c, s), (−c, −s), (−s, c), (s, −c)
__device__ __forceinline__ void rot_fold(int k, float s, float c, float& ex,
                                         float& ey) {
  ex = k == 0 ? c : k == 1 ? -c : k == 2 ? -s : s;
  ey = k == 0 ? s : k == 1 ? -s : k == 2 ? c : -c;
}

// kGroups of (s and c, r, Ap, δ, x) live in shared memory and the rest in
// device memory, fixed at compile time so that every access has its own
// address space; the streamed plan (kResident false) has kGroups 0.
template <int kGroups, bool kResident>
__global__ void __launch_bounds__(kThreads, 1) fused_cluster(FusedArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ float warp_part[kWarps];
  __shared__ float rz0_slot;                 // Σ r·z of a GN step's start
  __shared__ float pap_box[kMaxCluster];     // Σ p·Ap of each rank
  __shared__ float rz_box[2][kMaxCluster];   // Σ r·z of each rank, by parity
  __shared__ alignas(8) unsigned long long bars[3];  // halo, p·Ap, r·z
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int nrank = static_cast<int>(cl.num_blocks());
  const int last = nrank - 1;
  const int H = a.H, W = a.W, R = a.rows, HW = H * W;
  const int bi = blockIdx.y;
  const int y0 = rank * R;
  const int nrows = min(H, y0 + R) - y0;
  const int n = nrows * W;
  const size_t pb2 = (size_t)bi * 2 * HW, pb3 = (size_t)bi * 3 * HW;
  const size_t band = (size_t)y0 * W;
  // the inputs and pre at the band's first pixel, planes HW apart
  const float* const vb = a.vm + (size_t)bi * 4 * HW + band;
  const float* const fb = a.fit + (size_t)bi * HW + band;
  const float* const csb = a.csrc + pb2 + band;
  const float* const ctb = a.ctgt + pb2 + band;
  const float* const gb = a.grid + pb2 + band;
  float* const preb = a.pre + pb2 + band;
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

  // Each state plane at the band's first pixel, with its plane stride. A
  // plane with halo rows holds rows −1 .. R, so its row ±1 is at ±W in
  // shared and in device memory alike.
  float* sm = reinterpret_cast<float*>(smem4);
  const int RW = R * W, HS = RW + 2 * W;
  // p's halo rows, zero until a neighbour pushes them (never, outside the
  // image)
  for (int k = threadIdx.x; k < 6 * W + (kResident ? 3 * RW : 0);
       k += kThreads)
    sm[k] = 0.f;
  float* pp;
  int ps, hs;
  float *top, *bot;
  if constexpr (kResident) {
    pp = sm + W; ps = hs = HS; sm += 3 * ps;
    top = pp - W;
    bot = pp + nrows * W;
  } else {
    pp = a.p + pb3 + band; ps = HW; hs = W;
    top = sm; bot = sm + 3 * W; sm += 6 * W;
  }
  float *sp, *cp;
  if constexpr (kGroups >= 1) {
    sp = sm + W; cp = sp + HS; sm += 2 * HS;
  } else {
    sp = a.sc + pb2 + band; cp = sp + HW;
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
    dp = sm; ds = RW; sm += 3 * RW;
  } else {
    dp = a.delta + pb3 + band; ds = HW;
  }
  float* xp;
  int xs;
  if constexpr (kGroups >= 5) {
    xp = sm + W; xs = HS;
  } else {
    xp = a.x + pb3 + band; xs = HW;
  }

  // The neighbours' halo rows of p and mbarriers. The layout is the same in
  // every CTA, and a CTA with a neighbour below has all R rows.
  const unsigned halo_bytes =
      4u * W * ((rank > 0 ? 3 : 0) + (rank < last ? 3 : 0));
  const unsigned box_bytes = 4u * nrank;
  const int up_rank = rank > 0 ? rank - 1 : last;
  const int dn_rank = rank < last ? rank + 1 : 0;
  const unsigned up_bot =
      at_rank(smem_addr(kResident ? pp + R * W : bot), up_rank);
  const unsigned up_bar = at_rank(bar_halo, up_rank);
  const unsigned dn_top = at_rank(smem_addr(top), dn_rank);
  const unsigned dn_bar = at_rank(bar_halo, dn_rank);
  // Push the band's new edge rows of p (pixel li, its 3 values) to the
  // CTAs that read them as halo.
  auto push_edges = [&](int li, const float (&pv)[3]) {
    if (li < W && rank > 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        st_async(up_bot + 4u * (ch * hs + li), pv[ch], up_bar);
    }
    if (li >= n - W && rank < last) {
      const int x = li - (n - W);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        st_async(dn_top + 4u * (ch * hs + x), pv[ch], dn_bar);
    }
  };
  // Send this CTA's partial (in warp 0) to slot `rank` of every CTA's box.
  auto send_partial = [&](float t, const float* box, unsigned bar) {
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 32 && lane < nrank)
      st_async(at_rank(smem_addr(box + rank), lane), t, at_rank(bar, lane));
  };
  // Copy the neighbours' edge rows of `np` planes with halo rows (band at
  // q, planes HS apart) from their shared memory into this CTA's halo rows.
  auto fill_halo = [&](float* q, int np) {
    for (int k = threadIdx.x; k < 2 * np * W; k += kThreads) {
      const int pl = k / (2 * W), m = k - pl * 2 * W;
      float* const plane = q + pl * HS;
      if (m < W) {
        if (rank > 0)
          plane[m - W] = *cl.map_shared_rank(plane + (R - 1) * W + m,
                                             rank - 1);
      } else if (rank < last) {
        plane[nrows * W + m - W] = *cl.map_shared_rank(plane + m - W,
                                                       rank + 1);
      }
    }
  };
  // a thread's pixels li = tid + k·kThreads at band row ly, column x,
  // stepped without a division
  const int row_step = kThreads / W, col_step = kThreads - row_step * W;

  // x = (grid, 0), δ = 0 and the preconditioner
  for (int li = threadIdx.x; li < n; li += kThreads) {
    xp[li] = __ldg(gb + li);
    xp[xs + li] = __ldg(gb + HW + li);
    xp[2 * xs + li] = 0.f;
    dp[li] = 0.f;
    dp[ds + li] = 0.f;
    dp[2 * ds + li] = 0.f;
    const float deg = ((__ldg(vb + li) + __ldg(vb + HW + li)) +
                       __ldg(vb + 2 * HW + li)) + __ldg(vb + 3 * HW + li);
    const float diag_o = 2.f * wr2 * deg + wf2 * __ldg(fb + li);
    const float to = 1.f + sqrtf(diag_o);
    const float ta = 1.f + sqrtf(wr2 * deg);
    preb[li] = 1.f / (to * to);
    preb[HW + li] = 1.f / (ta * ta);
  }

  unsigned ph = 0;  // PCG iterations run so far in this solve
  float acc;
  for (int ia = 0; ia < a.num_anneal; ++ia) {
    const float al = (float)(ia + 1) / (float)a.num_anneal;
    const float om = 1.f - al;
    for (int g = 0; g < a.gn_iters; ++g) {
      // 1. x += δ of the previous GN step (0 at the first); s, c of the angle
      for (int li = threadIdx.x; li < n; li += kThreads) {
        xp[li] = xp[li] + dp[li];
        xp[xs + li] = xp[xs + li] + dp[ds + li];
        const float ang = xp[2 * xs + li] + dp[2 * ds + li];
        xp[2 * xs + li] = ang;
        sp[li] = sinf(ang);
        cp[li] = cosf(ang);
      }
      // 2. every CTA's x, s and c of this step are written (and, at the
      // first step, every CTA has started and set up its mbarriers)
      cl.sync();
      // 3. the halo rows of the planes in shared memory, then JtF at x (the
      // evalJTF analogue of :83-102); r = −JtF, p = pre·r, δ = 0, Σ r·z
      if constexpr (kGroups >= 1) fill_halo(sp, 2);
      if constexpr (kGroups >= 5) fill_halo(xp, 2);
      if constexpr (kGroups >= 1) __syncthreads();
      acc = 0.f;
      {
        int ly = threadIdx.x / W, x = threadIdx.x - ly * W;
        for (int li = threadIdx.x; li < n;
             li += kThreads, x += col_step, ly += row_step) {
          if (x >= W) {  // the column wrapped into the next row
            x -= W;
            ++ly;
          }
          const bool ok[4] = {x + 1 < W, x > 0, y0 + ly + 1 < H, y0 + ly > 0};
          const float oxi = xp[li], oyi = xp[xs + li];
          const float s = sp[li], c = cp[li];
          const float cix = om * __ldg(csb + li) + al * __ldg(ctb + li);
          const float ciy =
              om * __ldg(csb + HW + li) + al * __ldg(ctb + HW + li);
          const float wfit = wf2 * __ldg(fb + li);
          float gx = wfit * (oxi - cix);
          float gy = wfit * (oyi - ciy);
          float ga = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = li + dir_off(k, W);
            const float oxj = ok[k] ? xp[j] : 0.f;
            const float oyj = ok[k] ? xp[xs + j] : 0.f;
            const float sj = ok[k] ? sp[j] : 0.f, cj = ok[k] ? cp[j] : 0.f;
            float rx, ry, rxj, ryj, tx, ty;
            rot_fold(k, s, c, rx, ry);
            rot_fold(k, sj, cj, rxj, ryj);
            t_fold(k, s, c, tx, ty);
            const float ex = (oxi - oxj) + rx;
            const float ey = (oyi - oyj) + ry;
            const float exn = (oxj - oxi) - rxj;
            const float eyn = (oyj - oyi) - ryj;
            const float wv = wr2 * __ldg(vb + k * HW + li);
            gx = gx + wv * (ex - exn);
            gy = gy + wv * (ey - eyn);
            ga = ga + wv * (tx * ex + ty * ey);
          }
          const float pre_o = preb[li], pre_a = preb[HW + li];
          const float r0 = -gx, r1 = -gy, r2 = -ga;
          const float z0 = pre_o * r0, z1 = pre_o * r1, z2 = pre_a * r2;
          rp[li] = r0;
          rp[rs + li] = r1;
          rp[2 * rs + li] = r2;
          pp[li] = z0;
          pp[ps + li] = z1;
          pp[2 * ps + li] = z2;
          dp[li] = 0.f;
          dp[ds + li] = 0.f;
          dp[2 * ds + li] = 0.f;
          acc += r0 * z0 + r1 * z1 + r2 * z2;
        }
      }
      acc = cta_total(acc, warp_part);
      if (threadIdx.x == 0) rz0_slot = acc;
      // 4. every CTA's rz partial is in its slot, and every CTA is past the
      // last GN step's waits and DSMEM reads
      cl.sync();
      float rz;
      {
        const int lane = threadIdx.x & 31;
        const float t = warp_sum(
            lane < nrank ? *cl.map_shared_rank(&rz0_slot, lane) : 0.f);
        rz = __shfl_sync(0xffffffffu, t, 0);
      }
      if (a.pcg_iters > 0) {
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

      for (int it = 0; it < a.pcg_iters; ++it, ++ph) {
        const unsigned parity = ph & 1;
        const bool more = it + 1 < a.pcg_iters;
        // the band's p (written by other threads of this CTA) and its halo
        // rows (pushed by the neighbours) for this iteration
        __syncthreads();
        if (threadIdx.x == 0 && it > 0) bar_expect(bar_rz, box_bytes);
        bar_wait(bar_halo, parity);

        // Ap = JtJ·p, unfactored (:112-146), and Σ p·Ap
        acc = 0.f;
        {
          int ly = threadIdx.x / W, x = threadIdx.x - ly * W;
          for (int li = threadIdx.x; li < n;
               li += kThreads, x += col_step, ly += row_step) {
            if (x >= W) {  // the column wrapped into the next row
              x -= W;
              ++ly;
            }
            const bool ok[4] = {x + 1 < W, x > 0, y0 + ly + 1 < H,
                                y0 + ly > 0};
            // p of the rows above and below from the halo rows at the band's
            // edges
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
            float pc[3], pj[3][4];
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              const float* const q = pp + ch * ps + li;
              pc[ch] = q[0];
              pj[ch][0] = ok[0] ? q[1] : 0.f;
              pj[ch][1] = ok[1] ? q[-1] : 0.f;
              pj[ch][2] = dn[ch * dns];
              pj[ch][3] = up[ch * ups];
            }
            const float s = sp[li], c = cp[li];
            const float wfit = wf2 * __ldg(fb + li);
            const float ax = wfit * pc[0];
            const float ay = wfit * pc[1];
            float aa = 0.f, accx = 0.f, accy = 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float v = __ldg(vb + k * HW + li);
              const int j = li + dir_off(k, W);
              const float sj = ok[k] ? sp[j] : 0.f;
              const float cj = ok[k] ? cp[j] : 0.f;
              float tx, ty, txj, tyj;
              t_fold(k, s, c, tx, ty);
              t_fold(k, sj, cj, txj, tyj);
              const float dox = pc[0] - pj[0][k];
              const float doy = pc[1] - pj[1][k];
              accx = accx + v * ((2.f * dox + pc[2] * tx) + pj[2][k] * txj);
              accy = accy + v * ((2.f * doy + pc[2] * ty) + pj[2][k] * tyj);
              aa = aa + (wr2 * v) * ((tx * dox + ty * doy) + pc[2]);
            }
            const float apx = ax + wr2 * accx;
            const float apy = ay + wr2 * accy;
            app[li] = apx;
            app[as + li] = apy;
            app[2 * as + li] = aa;
            acc += pc[0] * apx + pc[1] * apy + pc[2] * aa;
          }
        }
        acc = cta_total(acc, warp_part);
        // every thread is past this iteration's halo wait
        if (threadIdx.x == 0 && more) bar_expect(bar_halo, halo_bytes);
        send_partial(acc, pap_box, bar_pap);
        bar_wait(bar_pap, parity);
        const float pap = mailbox_total(pap_box, nrank);

        // δ += αp, r −= α·Ap, and Σ z·r with z = pre·r. z takes Ap's place,
        // which is not read again this iteration.
        const float alpha = pap > 0.f ? rz / pap : 0.f;
        acc = 0.f;
        for (int li = threadIdx.x; li < n; li += kThreads) {
          const float pre[3] = {preb[li], preb[li], preb[HW + li]};
          float t = 0.f;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            float* const dq = dp + ch * ds + li;
            float* const rq = rp + ch * rs + li;
            float* const aq = app + ch * as + li;
            *dq = *dq + alpha * pp[ch * ps + li];
            const float rv = *rq - alpha * *aq;
            *rq = rv;
            const float z = pre[ch] * rv;
            *aq = z;
            t += z * rv;
          }
          acc += t;
        }
        acc = cta_total(acc, warp_part);
        // every thread is past this iteration's p·Ap wait
        if (threadIdx.x == 0 && more) bar_expect(bar_pap, box_bytes);
        send_partial(acc, rz_box[parity], bar_rz);
        bar_wait(bar_rz, parity);
        const float rz_new = mailbox_total(rz_box[parity], nrank);

        // p = z + βp; the new edge rows go to the neighbours
        const float beta = rz > 0.f ? rz_new / rz : 0.f;
        for (int li = threadIdx.x; li < n; li += kThreads) {
          float pv[3];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            float* const pq = pp + ch * ps + li;
            pv[ch] = app[ch * as + li] + beta * *pq;
            *pq = pv[ch];
          }
          if (more && (li < W || li >= n - W)) push_edges(li, pv);
        }
        rz = rz_new;
      }
    }
  }

  // x += δ of the last GN step, into the output
  float* const xo = a.x + pb3 + band;
  for (int li = threadIdx.x; li < n; li += kThreads) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      xo[(size_t)ch * HW + li] = xp[ch * xs + li] + dp[ch * ds + li];
  }
  cl.sync();  // no CTA leaves while another may still address it
}

using Kernel = void (*)(FusedArgs);

Kernel pick_kernel(int resident, int groups) {
  if (!resident) return fused_cluster<0, false>;
  switch (groups) {
    case 0: return fused_cluster<0, true>;
    case 1: return fused_cluster<1, true>;
    case 2: return fused_cluster<2, true>;
    case 3: return fused_cluster<3, true>;
    case 4: return fused_cluster<4, true>;
    default: return fused_cluster<5, true>;
  }
}

bool plan_ok(int H, int W, int cluster, int rows, int resident, int groups,
             int smem) {
  return H > 0 && W > 0 && cluster >= 1 && cluster <= kMaxCluster &&
         rows >= 1 && (long)(cluster - 1) * rows < H &&
         (long)cluster * rows >= H && groups >= 0 && groups <= kMaxGroups &&
         (resident || groups == 0) &&
         smem >= 0 && smem <= kSmemPerBlock &&
         plan_floats(rows, W, resident, groups) * sizeof(float) <=
             static_cast<size_t>(smem);
}

}  // namespace

extern "C" {

const char* fused_error_string(int err) {
  if (err == kNoClusterFits)
    return "no cluster of this plan fits the device "
           "(cudaOccupancyMaxActiveClusters is 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Clusters of the plan that the current device holds at once (≥ 0), or
// −(cudaError_t).
int fused_active_clusters(int B, int cluster, int resident, int groups,
                          int smem_bytes, void* stream) {
  const Kernel kern = pick_kernel(resident, groups);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err =
      configure(kern, B, cluster, static_cast<size_t>(smem_bytes),
                static_cast<cudaStream_t>(stream), &cfg, &attr);
  return err == cudaSuccess ? occupancy(kern, cfg) : -static_cast<int>(err);
}

// x (B,3,H,W) after the whole schedule, one cluster launch. vm (B,4,H,W);
// fit (B,H,W); csrc, ctgt, grid (B,2,H,W); w (B,2) = (wf2, wr2). pre
// (B,2,H,W) is scratch; sc (B,2,H,W) and r, p, ap, delta (B,3,H,W) are
// scratch needed only where the plan keeps that plane in device memory (sc
// when groups < 1, r when < 2, ap when < 3, delta when < 4, p when not
// resident; otherwise may be null). All float32, contiguous, on the
// stream's device. The plan (cluster, rows, resident, groups, smem_bytes) is
// ops/fused_solver.py::fused_plan's. Enqueues one launch on `stream`
// without synchronising; returns the cudaError_t of the launch (0 =
// success), cudaErrorInvalidValue for a plan that does not cover the
// problem, or kNoClusterFits.
int fused_solve_f32(const float* vm, const float* fit, const float* csrc,
                    const float* ctgt, const float* grid, const float* w,
                    float* x, float* pre, float* sc, float* r, float* p,
                    float* ap, float* delta, int B, int H, int W,
                    int num_anneal, int gn_iters, int pcg_iters, int cluster,
                    int rows, int resident, int groups, int smem_bytes,
                    void* stream) {
  if (B <= 0) return 0;
  if (!plan_ok(H, W, cluster, rows, resident, groups, smem_bytes) ||
      num_anneal < 0 || gn_iters < 0 || pcg_iters < 0 || !x || !pre ||
      (groups < 1 && !sc) || (groups < 2 && !r) || (groups < 3 && !ap) ||
      (groups < 4 && !delta) || (!resident && !p))
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedArgs a{vm, fit, csrc, ctgt, grid, w, x, pre, sc, r, p, ap,
                    delta, H, W, rows, num_anneal, gn_iters, pcg_iters};
  const Kernel kern = pick_kernel(resident, groups);
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

}  // extern "C"
